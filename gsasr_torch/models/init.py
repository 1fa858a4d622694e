"""Seeded initialization with the reference's PyTorch initializers
(counterpart of `gsasr_tpu/models/init.py` for EDSR, RDN, SwinIR, the
paper Fea2GS and the Enhanced Fea2GSRopeAMP).

- nn.Linear / nn.Conv2d: weight and bias ~ U(+-1/sqrt(fan_in));
- SwinIR's `_init_weights` (`utils/swinir.py:940-947`): its nn.Linear
  weights ~ trunc_normal(std 0.02), biases 0; convs keep the default;
- ScaleInject (the reference's nn.MultiheadAttention): in_proj_weight ~
  xavier_uniform over the stacked (3E, E) matrix = U(+-sqrt(1.5/E)),
  in_proj_bias and out_proj.bias 0, out_proj.weight the Linear default;
- relative position bias tables ~ trunc_normal(std 0.02);
- RoPE frequencies as `rope_freqs_init` draws them (one angle per head);
- gs/pos embeddings ~ N(0, 1); LayerNorm 1 / 0.

Every draw comes from the given generator, in `named_modules` order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gsasr_torch.models.fea2gs import Fea2GS, ScaleInject, _WindowAttnParams
from gsasr_torch.models.fea2gs_rope import (Fea2GSRopeAMP, _RopeAttn,
                                            rope_freqs_init)
from gsasr_torch.models.swinir import SwinIRNOUP, WindowAttention


def _uniform_(t, bound, g):
    nn.init.uniform_(t, -bound, bound, generator=g)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of `model` in place; returns `model`."""
    g = generator
    swinlike = isinstance(model, SwinIRNOUP)
    for mod in model.modules():
        if swinlike and isinstance(mod, nn.Linear):
            nn.init.trunc_normal_(mod.weight, std=0.02, generator=g)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            _uniform_(mod.weight, 1.0 / math.sqrt(fan_in), g)
            if mod.bias is not None:
                _uniform_(mod.bias, 1.0 / math.sqrt(fan_in), g)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
        elif isinstance(mod, ScaleInject):
            dim = mod.in_proj_weight.shape[1]
            _uniform_(mod.in_proj_weight, math.sqrt(1.5 / dim), g)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (_WindowAttnParams, WindowAttention)):
            nn.init.trunc_normal_(mod.relative_position_bias_table, std=0.02,
                                  generator=g)
        elif isinstance(mod, _RopeAttn):
            nh, hdh = mod.rope_freqs.shape[1:]
            mod.rope_freqs.copy_(rope_freqs_init(2 * hdh, nh, mod.rope_theta,
                                                 generator=g))
        elif isinstance(mod, (Fea2GS, Fea2GSRopeAMP)):
            nn.init.normal_(mod.gs_embedding, generator=g)
            nn.init.normal_(mod.pos_embedding, generator=g)
    for mod in model.modules():
        if isinstance(mod, ScaleInject):
            mod.out_proj.bias.zero_()
    return model
