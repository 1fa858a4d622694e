"""The port's YAML reader (`gsasr_torch/utils/yaml_subset.py`) against
`yaml.safe_load`: every file in `configs/`, `--force_yml` values and YAML
1.1's resolution of plain scalars give the same Python values and types;
what lies outside the subset raises."""

import math
from pathlib import Path

import pytest
import yaml

from gsasr_torch.utils.yaml_subset import load

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yml"))


def _same(a, b):
    """Equal values of equal types, nested; NaN equals NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_all_configs_are_read():
    assert len(CONFIGS) == 12


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_equals_safe_load(path):
    text = path.read_text()
    assert _same(load(text), yaml.safe_load(text))


# --force_yml values and YAML 1.1's plain scalars: ints in every base and
# base 60, floats (a dot is needed: 2e-4 stays a string), booleans, nulls,
# quoted strings and their escapes, flow lists, comments, keys resolved
# like values, a repeated key, a leading ---
VALUES = [
    "1000", "-3", "+1", "0", "017", "0x1F", "0b101", "1_000", "1:30", "0o17",
    "2.0e-4", "2e-4", "1e+5", "1.", ".5", "+.5", "1.5e+3", "-.inf", ".Inf",
    ".NaN", "1:30.5",
    "true", "True", "FALSE", "yes", "No", "on", "OFF", "y", "n",
    "~", "null", "Null", "NULL", "", "none",
    "configs/train_edsr_paper.yml", "a b", "x#y", "a # comment", "'abc'",
    "'it''s'", '"a\\tb\\u00e9\\x41"', '"quoted: colon"', "'[1, 2]'",
    "[1, 2]", "[0.9, 0.99]", "[]", "[a, b, ]", "[datasets/SA1B]",
    "['a', \"b c\", 3]", "[true, ~, 1.5, 2e-4]",
    "a: 1\nb:\n  c: [1, 2]  # note\n  d: \"q\"\ne:",
    "--- \na: 1", "on: 1\n1: x\n2.5: y\nnull: z", "a: 1\na: 2",
    "# only a comment\n",
]


@pytest.mark.parametrize("text", VALUES)
def test_value_equals_safe_load(text):
    assert _same(load(text), yaml.safe_load(text)), (load(text),
                                                     yaml.safe_load(text))


OUTSIDE = ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x",
           "- 1\n- 2", "a:\n  - 1", "a: {b: 1}", "{a: 1}", "a: [[1]]",
           "a: 1\n---\nb: 2", "2026-01-01", "a: 2026-01-01", "<<: 1",
           "a: b\n  c", '"abc', "a: 'x", "a:\tb: 1\n\tc: 2", "? a\n: 1",
           "%YAML 1.1\n---\na: 1", "a: 1\n...\n", "a: -", "a: b: c"]


@pytest.mark.parametrize("text", OUTSIDE)
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError, match="outside the YAML subset"):
        load(text)


def test_options_need_no_pyyaml(tmp_path):
    """load_options and apply_overrides read with PyYAML blocked (the card's
    machine has none), and give what they gave with it."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "from gsasr_torch.config import apply_overrides, load_options\n"
        "opt = apply_overrides(load_options(sys.argv[1]),\n"
        "                      ['train:total_iter=7', 'datasets.train.x=[1]'])\n"
        "assert opt['train']['total_iter'] == 7\n"
        "assert opt['datasets']['train']['x'] == [1]\n"
        "assert opt['train']['optim_g']['lr'] == 2e-4\n"
        "assert opt['model_dtype'] == 'bfloat16'\n")
    res = subprocess.run(
        [sys.executable, "-c", code,
         str(ROOT / "configs" / "train_edsr_paper_bf16_r3.yml")],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
