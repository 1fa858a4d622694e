"""The port's training-state format (`gsasr_torch/utils/checkpoint.py`) on
the CPU: save and restore bit for bit, mid-accumulation too, and the next
step from a restored trainer the same bits as from the one that saved;
pruning that keeps the `best` step; `load_pretrained_params` and
`load_eval_params` on a step directory; the net files read by the JAX
package's `load_torch_checkpoint`, after which JAX's sr_forward matches the
port's; `cli.convert` and `cli.infer --ckpt_dir`."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_torch.models import EDSRNOUP, Fea2GS
from gsasr_torch.models.init import init_weights
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils import checkpoint as ck

ENC_KW = dict(num_feat=8, num_block=1)
DEC_KW = dict(inchannel=8, channel=12, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=1, num_selfattn_blocks=1,
              num_selfattn_layers=1, num_gs_seed=16, window_size=4)
CFG = dict(canvas_hw=(32, 32), warmup_iter=2, milestones=(100,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # bit-for-bit comparisons of whole steps; and torch's thread pool spins
    # against the other test workers' (tests/test_torch_infer.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets(seed):
    g = torch.Generator().manual_seed(seed)
    return (init_weights(EDSRNOUP(**ENC_KW), g),
            init_weights(Fea2GS(**DEC_KW), g))


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    scales = (2.0 + 2.0 * rng.random(b)).astype(np.float32)
    gt = np.round(scales * 8).astype(np.int32)
    return {"lq": rng.random((b, 8, 8, 3), dtype=np.float32),
            "gt": rng.random((b, 32, 32, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _same(a, b, path="state"):
    """Nested state dicts with the same keys and the same bits."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, path
        assert a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)
        ), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("acc", [1, 3], ids=["plain", "mid_accumulation"])
def test_save_restore_bit_for_bit(tmp_path, acc):
    """Two steps (with accumulation 3, the second leaves a running mean of
    two gradients), save, restore into a trainer of other weights: the
    restored state equals the saved one bit for bit, and the next two steps
    from it (finishing the accumulation, then one more) give the bits of
    the trainer that saved."""
    cfg = TrainConfig(**CFG, accumulation_steps=acc)
    a = Trainer(*_nets(0), cfg, device="cpu")
    for s in (1, 2):
        a.step(_batch(s))
    assert a._mini_step == (2 if acc == 3 else 0)
    path = ck.save_checkpoint(tmp_path, 2, a)
    assert sorted(os.listdir(path)) == ["net_fea2gs.pth", "net_g.pth",
                                        "train_state.pth"]
    assert ck.latest_step(tmp_path) == 2
    b = Trainer(*_nets(9), cfg, device="cpu")
    ck.restore_checkpoint(tmp_path, 2, b)
    _same(b.state_dict(), a.state_dict())
    assert (b.step_count, b.update_count) == (2, 2 if acc == 1 else 0)
    for s in (3, 4):
        ma, mb = a.step(_batch(s)), b.step(_batch(s))
        assert torch.equal(ma["loss"], mb["loss"])
    _same(b.state_dict(), a.state_dict())
    assert a.update_count == (4 if acc == 1 else 1)


def test_prune_keeps_best(tmp_path):
    """keep=5 keeps the five newest steps and the one `best` points at;
    saving a step again replaces it."""
    tr = Trainer(*_nets(1), TrainConfig(**CFG), device="cpu")
    ck.save_checkpoint(tmp_path, 1, tr)
    ck.mark_best(tmp_path, 1)
    for s in range(2, 9):
        ck.save_checkpoint(tmp_path, s, tr)
    steps = sorted(int(p) for p in os.listdir(tmp_path) if p.isdigit())
    assert steps == [1, 4, 5, 6, 7, 8]
    assert os.readlink(tmp_path / "best") == "1"
    tr.step(_batch(0))
    ck.save_checkpoint(tmp_path, 8, tr)
    assert ck.load_step(tmp_path, 8)["train_state"]["step_count"] == 1
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".")]


def test_step_directory_loaders(tmp_path):
    """load_eval_params reads the two nets' params_ema (or params) from a
    step directory; load_pretrained_params picks the network by its kind
    or by `net`; both equal the saved modules bit for bit."""
    tr = Trainer(*_nets(2), TrainConfig(**CFG, ema_decay=0.5), device="cpu")
    tr.step(_batch(5))
    path = ck.save_checkpoint(tmp_path, 1, tr)
    enc, dec = ck.load_eval_params(path)
    _same(enc, tr.ema_g.state_dict())
    _same(dec, tr.ema_d.state_dict())
    enc, dec = ck.load_eval_params(path, "params")
    _same(dec, tr.dec.state_dict())
    _same(ck.load_pretrained_params(str(path), "edsr"), tr.enc.state_dict())
    _same(ck.load_pretrained_params(str(path), "fea2gs", "params_ema"),
          tr.ema_d.state_dict())
    _same(ck.load_pretrained_params(str(path), "swinir", net="fea2gs"),
          tr.dec.state_dict())


def test_jax_reads_the_net_files(tmp_path):
    """JAX's load_torch_checkpoint reads the port's net files (they are
    reference checkpoints), and JAX's sr_forward on those trees matches the
    port's sr_forward on the restored EMA weights."""
    from gsasr_tpu.model import sr_forward as jsr_forward
    from gsasr_tpu.models import EDSRNOUP as JEDSR
    from gsasr_tpu.models import Fea2GS as JFea2GS
    from gsasr_tpu.utils.checkpoint import load_torch_checkpoint as jload
    from gsasr_torch.model import sr_forward
    from gsasr_torch.utils.convert import load_params

    tr = Trainer(*_nets(3), TrainConfig(**CFG, ema_decay=0.5), device="cpu")
    tr.step(_batch(6))
    path = ck.save_checkpoint(tmp_path, 1, tr)
    ep = jload(path / "net_g.pth", "edsr")
    dp = jload(path / "net_fea2gs.pth", "fea2gs", num_gs_seed=16,
               window_size=4, num_heads=6)
    enc, dec = (load_params(m, sd).eval() for m, sd in zip(
        _nets(4), ck.load_eval_params(path)))
    lq = np.random.default_rng(7).random((1, 8, 12, 3), dtype=np.float32)
    ref = np.asarray(jsr_forward(JEDSR(**ENC_KW), JFea2GS(**DEC_KW),
                                 jax.tree_util.tree_map(jnp.asarray, ep),
                                 jax.tree_util.tree_map(jnp.asarray, dp),
                                 jnp.asarray(lq), 2.0, denominator=4,
                                 dmax=0.5))
    out = sr_forward(enc, dec, lq, 2.0, denominator=4, dmax=0.5,
                     device="cpu").numpy()
    assert out.shape == ref.shape == (1, 16, 24, 3)
    # tests/test_torch_model.py's sr_forward tolerance
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_convert_cli_and_infer_ckpt_dir(tmp_path):
    """cli.convert turns a reference pair ({"params", "params_ema"} with
    different weights) into a step directory whose params and params_ema
    are the pair's, bit for bit (a file with params only gets them twice),
    and converting again replaces the step;
    cli.infer --ckpt_dir on it writes the PNG that --enc_ckpt/--dec_ckpt
    write, at full width (make_models' paper EDSR + Fea2GS)."""
    from gsasr_torch.cli import convert, infer
    from gsasr_torch.model import make_models
    from gsasr_torch.utils.png import read_png, write_png

    pairs = [make_models("edsr", "paper", device="cpu",
                         generator=torch.Generator().manual_seed(s))
             for s in (5, 6)]
    files = {}
    for i, name in enumerate(("net_g", "net_fea2gs")):
        files[name] = tmp_path / f"{name}.pth"
        blob = {"params": pairs[0][i].state_dict()}
        if i == 1:
            blob["params_ema"] = pairs[1][i].state_dict()
        torch.save(blob, files[name])
    step = convert.main(["--enc_ckpt", str(files["net_g"]), "--dec_ckpt",
                         str(files["net_fea2gs"]), "--out",
                         str(tmp_path / "conv"), "--step", "3"])
    assert step == str(tmp_path / "conv" / "3")
    enc, dec = ck.load_eval_params(step)
    _same(enc, pairs[0][0].state_dict())
    _same(dec, pairs[1][1].state_dict())
    _same(ck.load_eval_params(step, "params")[1], pairs[0][1].state_dict())
    # converting again replaces the step, as JAX's convert does
    torch.save({"params": pairs[1][0].state_dict()}, files["net_g"])
    convert.main(["--enc_ckpt", str(files["net_g"]), "--dec_ckpt",
                  str(files["net_fea2gs"]), "--out", str(tmp_path / "conv"),
                  "--step", "3"])
    _same(ck.load_eval_params(step)[0], pairs[1][0].state_dict())
    torch.save({"params": pairs[0][0].state_dict()}, files["net_g"])
    convert.main(["--enc_ckpt", str(files["net_g"]), "--dec_ckpt",
                  str(files["net_fea2gs"]), "--out", str(tmp_path / "conv"),
                  "--step", "3"])

    img = (np.random.default_rng(8).random((24, 24, 3)) * 255).astype(
        np.uint8)
    write_png(tmp_path / "lr.png", img)
    base = ["--input_img_path", str(tmp_path / "lr.png"), "--device", "cpu",
            "--scale", "2"]
    a = read_png(infer.main(base + ["--ckpt_dir", step, "--save_sr_path",
                                    str(tmp_path / "a")]))
    # the same weights as reference files that hold params_ema
    ema = {}
    for name, mod in (("net_g", pairs[0][0]), ("net_fea2gs", pairs[1][1])):
        ema[name] = tmp_path / f"{name}_ema.pth"
        torch.save({"params_ema": mod.state_dict()}, ema[name])
    b = read_png(infer.main(base + ["--enc_ckpt", str(ema["net_g"]),
                                    "--dec_ckpt", str(ema["net_fea2gs"]),
                                    "--save_sr_path", str(tmp_path / "b")]))
    assert a.shape == (48, 48, 3) and np.array_equal(a, b)
    # --bf16 with the paper version runs (a bf16 encoder, the paper
    # decoder's fused trunk in fp32): a PNG of the same shape
    c = read_png(infer.main(base + ["--ckpt_dir", step, "--bf16",
                                    "--save_sr_path", str(tmp_path / "c")]))
    assert c.shape == a.shape


def test_trainer_state_dict_is_a_copy():
    """state_dict() holds CPU copies: stepping on does not change it."""
    tr = Trainer(*_nets(5), TrainConfig(**CFG), device="cpu")
    tr.step(_batch(1))
    sd = tr.state_dict()
    before = copy.deepcopy(sd)
    tr.step(_batch(2))
    _same(sd, before)
    assert sd["train_state"]["optimizer"]["state"]
