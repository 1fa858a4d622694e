"""Reference `.pth` checkpoints into the port's modules (counterpart of
`gsasr_tpu/utils/checkpoint.py`'s `load_torch_checkpoint`,
`load_pretrained_params` and `CONVERTER_KINDS`).

The reference saves each network as `{'params': sd, 'params_ema': sd}`
and evaluates from `params_ema`. The port's modules take the reference's
`state_dict` keys, so a checkpoint needs no conversion: the loader drops
the buffers that the reference encoders register and that no converter of
the JAX package reads (`gsasr_tpu/utils/torch_convert.py`): Swin's
`attn_mask`, SwinIR's and HAT's `relative_position_index`, HAT's
`relative_position_index_SA` and `_OCA`, which the port's modules rebuild.
`utils.convert.load_params` then loads the rest strictly: a missing or
unexpected key raises. A loaded `relative_position_index` of the paper
decoder (which the reference builds in set order) replaces the module's
and rebuilds its inverse (`ops/bias_table.py`), where JAX permutes the
table rows instead (`torch_convert.remap_bias_table`): the same bias.

The port has no training-state format yet, so an orbax step directory is
refused.
"""

from __future__ import annotations

import os
from typing import Dict

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


def load_pretrained_params(spec, kind: str, key: str = "params"):
    """One network's state_dict for `pretrain_network_*` initialization
    from a reference `.pth` file (the reference's `train.py:132-142`);
    None for an empty spec."""
    if not spec:
        return None
    if os.path.isdir(spec):
        raise NotImplementedError(
            f"{spec} is a directory: the JAX package's orbax training-state "
            "checkpoints have no counterpart in gsasr_torch yet (ROADMAP "
            "Queue 1, item 4); give a reference .pth file")
    return load_torch_checkpoint(spec, kind, param_key=key)
