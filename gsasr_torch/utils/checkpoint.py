"""Checkpoints in the reference's layout (counterpart of
`gsasr_tpu/utils/checkpoint.py`).

The reference saves each network as `{'params': sd, 'params_ema': sd}`
(`basicsr/models/base_model.py:208-253`) and the optimizer and counters in
a separate state file (`:318-366`), resumes from `params` and evaluates
from `params_ema`. The port's training state is that layout in torch
files, in place of the JAX package's orbax directories:

  <dir>/<step>/net_g.pth          {'params': sd, 'params_ema': sd}
  <dir>/<step>/net_fea2gs.pth     {'params': sd, 'params_ema': sd}
  <dir>/<step>/train_state.pth    Adam's state, step and update counts,
                                  the accumulation's running mean

(`Trainer.state_dict()`). A step is written to a temporary directory and
renamed into place, so a reader never sees half a step. The net files are
reference checkpoints: JAX's `load_torch_checkpoint` reads them, and so
does `load_torch_checkpoint` here. The port cannot read an orbax
directory, and JAX cannot read `train_state.pth`.

Reference `.pth` files load into the port's modules without conversion:
the modules take the reference's `state_dict` keys. `load_torch_checkpoint`
drops the buffers that the reference encoders register and that no
converter of the JAX package reads (`gsasr_tpu/utils/torch_convert.py`):
Swin's `attn_mask`, SwinIR's and HAT's `relative_position_index`, HAT's
`relative_position_index_SA` and `_OCA`, which the port's modules rebuild.
`utils.convert.load_params` then loads the rest strictly: a missing or
unexpected key raises. A loaded `relative_position_index` of the paper
decoder (which the reference builds in set order) replaces the module's
and rebuilds its inverse (`ops/bias_table.py`), where JAX permutes the
table rows instead (`torch_convert.remap_bias_table`): the same bias.
"""

from __future__ import annotations

import os
import shutil
import time
from pathlib import Path
from typing import Dict, Optional

import torch

# The last part of the keys of the buffers that the reference encoder of
# each kind registers and that its converter does not read.
_UNREAD = {
    "edsr": (), "rdn": (), "fea2gs": (), "fea2gs_rope": (),
    "swinir": ("attn_mask", "relative_position_index"),
    "hat": ("attn_mask", "relative_position_index_SA",
            "relative_position_index_OCA"),
    "hat_paper": ("attn_mask", "relative_position_index",
                  "relative_position_index_SA",
                  "relative_position_index_OCA"),
}

# yaml network type -> .pth converter kind (see load_torch_checkpoint)
CONVERTER_KINDS = {
    "EDSRNOUP": "edsr", "EDSR": "edsr",
    "RDNNOUP": "rdn", "RDN": "rdn",
    "SwinIRNOUP": "swinir", "SWINNOUP": "swinir",
    "HATNOUP_ROPE_AMP": "hat", "HATNOUP": "hat_paper",
    "Fea2GS": "fea2gs",
    "Fea2GS_ROPE_AMP": "fea2gs_rope", "Fea2GSRopeAMP": "fea2gs_rope",
}


def load_torch_checkpoint(path, kind: str, param_key: str = "params_ema"
                          ) -> Dict[str, torch.Tensor]:
    """A reference `.pth` network file -> the state_dict that
    `utils.convert.load_params` loads into the port's module of `kind`
    ('edsr', 'rdn', 'swinir', 'fea2gs', 'fea2gs_rope', 'hat' for HAT-L,
    'hat_paper'). Reads `blob[param_key]`, or the file itself when it is a
    bare state_dict, on the CPU."""
    if kind not in _UNREAD:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get(param_key, blob) if isinstance(blob, dict) else blob
    return {k: v for k, v in sd.items()
            if k.rpartition(".")[2] not in _UNREAD[kind]}


# the two net files of a step, encoder first
NETS = ("net_g", "net_fea2gs")


def write_step(directory, step: int, files) -> Path:
    """Write `<directory>/<step>/<name>.pth` for each (name, object) of
    `files` into a temporary directory, then rename it into place,
    replacing an earlier save of the same step. Returns the step's path."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / str(step)
    tmp = directory / f".{step}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    for name, blob in files.items():
        torch.save(blob, tmp / f"{name}.pth")
    if final.exists():
        old = directory / f".{step}.old-{os.getpid()}"
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)
    return final


def save_checkpoint(directory, step: int, trainer, *, keep: int = 5,
                    retries: int = 3) -> Path:
    """Save `trainer`'s whole state (`Trainer.state_dict()`) as
    `<directory>/<step>/`, retrying transient IO failures as the
    reference's save loop does (`base_model.py:238-253`), then prune to the
    newest `keep` steps (never the `best` one). Returns the step's path."""
    directory = Path(directory).absolute()
    state = trainer.state_dict()
    for attempt in range(retries):
        try:
            path = write_step(directory, step, state)
            break
        except OSError:
            if attempt == retries - 1:
                raise
            time.sleep(1.0)
    _prune(directory, keep)
    return path


def _prune(directory: Path, keep: int):
    # Never prune the step the `best` symlink points at (best-metric
    # checkpoint tracking, reference `base_model.py:50-73`).
    best = None
    link = directory / "best"
    if link.is_symlink():
        tgt = os.readlink(link)
        if os.path.basename(tgt).isdigit():
            best = int(os.path.basename(tgt))
    steps = sorted(int(p.name) for p in directory.iterdir()
                   if p.is_dir() and p.name.isdigit())
    for s in steps[:-keep]:
        if s != best:
            shutil.rmtree(directory / str(s), ignore_errors=True)


def mark_best(directory, step: int):
    """Point `<directory>/best` at the given saved step (atomic refresh)."""
    directory = Path(directory).absolute()
    link = directory / "best"
    tmp = directory / ".best.tmp"
    if tmp.is_symlink() or tmp.exists():
        tmp.unlink()
    os.symlink(str(step), tmp)
    os.replace(tmp, link)


def latest_step(directory) -> Optional[int]:
    """`--auto_resume` support (`train.py:68-95`): the newest saved step."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name) for p in directory.iterdir()
             if p.is_dir() and p.name.isdigit()]
    return max(steps) if steps else None


def load_step(directory, step: int):
    """The state that `save_checkpoint` wrote for `step`, on the CPU: what
    `Trainer.load_state_dict` takes."""
    path = Path(directory) / str(step)
    state = {name: torch.load(path / f"{name}.pth", map_location="cpu",
                              weights_only=True) for name in NETS}
    state["train_state"] = torch.load(path / "train_state.pth",
                                      map_location="cpu", weights_only=True)
    return state


def restore_checkpoint(directory, step: int, trainer):
    """Restore `trainer` in place from `<directory>/<step>/`, bit for bit;
    returns the trainer."""
    trainer.load_state_dict(load_step(directory, step))
    return trainer


def load_eval_params(spec, key: str = "params_ema"):
    """(encoder state_dict, decoder state_dict) under `key` from a step
    directory, reading the two net files only (not the optimizer's)."""
    return tuple(torch.load(os.path.join(spec, f"{name}.pth"),
                            map_location="cpu", weights_only=True)[key]
                 for name in NETS)


def load_pretrained_params(spec, kind: str, key: str = "params", *,
                           net: Optional[str] = None):
    """One network's state_dict for `pretrain_network_*` initialization
    (the reference's `train.py:132-142`) from a reference `.pth` file or a
    step directory that `save_checkpoint` wrote; None for an empty spec.
    net: which network of a step directory, 'g' or 'fea2gs', by default
    from kind (the decoder kinds start with 'fea2gs')."""
    if not spec:
        return None
    if net is None:
        net = "fea2gs" if kind.startswith("fea2gs") else "g"
    if os.path.isdir(spec):
        enc, dec = load_eval_params(spec, key)
        return dec if net == "fea2gs" else enc
    return load_torch_checkpoint(spec, kind, param_key=key)
