"""make_models("hat", "ultra") on the CPU: seeded and shaped (moved here
from tests/test_torch_hat.py, whose helpers it uses, so that the test runs
spread over more files).
"""

import math

import pytest
import torch

from gsasr_torch.models import hat
from gsasr_torch.models.init import init_weights
from test_torch_hat import TINY_HAT


@pytest.fixture(autouse=True)
def _jax_reference_attention(monkeypatch):
    monkeypatch.setenv("GSASR_ATTN", "reference")


def test_make_models_hat_ultra_seeded_and_shaped():
    """make_models("hat", "ultra") at HAT-L's published widths and the Ultra
    decoder's settings, with HAT's _init_weights (trunc_normal 0.02 Linear
    weights, zero Linear biases, LayerNorm 1/0, default convs, RoPE
    frequencies from the generator); "enhanced" builds the same model; the
    same generator seed gives the same weights."""
    from gsasr_torch.model import DENOMINATORS, make_models

    enc, dec = make_models("hat", "ultra", device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert DENOMINATORS["hat"] == 16 and not enc.training
    assert len(enc.layers) == 12 and enc.window_size == 16
    rg = enc.layers[5].residual_group
    assert len(rg["blocks"]) == 6
    blk = rg["blocks"][1]
    assert blk.shift_size == 8 and blk.conv_scale == 0.01
    assert blk.attn.qkv.weight.shape == (576, 192)
    assert blk.attn.rope_freqs.shape == (2, 6, 16)
    assert blk.conv_block.cab[0].weight.shape == (64, 192, 3, 3)
    assert blk.conv_block.cab[3].attention[1].weight.shape == (6, 192, 1, 1)
    assert blk.mlp.fc1.weight.shape == (384, 192)
    assert rg["overlap_attn"].overlap_win_size == 24
    assert enc.conv_before_upsample[0].weight.shape == (64, 192, 3, 3)
    assert dec.channel == 192 and dec.window_size == 16
    assert dec.gs_embedding.shape == (256, 192)
    assert len(dec.window_crossattn_blocks) == 4
    assert len(dec.window_crossattn_blocks[0].blocks) == 4
    assert len(dec.gs_selfattn_blocks) == 8
    assert len(dec.gs_selfattn_blocks[0].blocks) == 6
    linears = [mod for mod in enc.modules() if isinstance(mod,
                                                          torch.nn.Linear)]
    w = torch.cat([mod.weight.flatten() for mod in linears]).detach()
    # truncated at +-2 absolute, as the reference's trunc_normal_
    assert abs(float(w.std()) - 0.02) < 2e-4 and float(w.abs().max()) <= 2.0
    assert all(torch.all(mod.bias == 0) for mod in linears)
    for mod in enc.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            assert torch.all(mod.weight == 1) and torch.all(mod.bias == 0)
    conv = enc.conv_after_body.weight
    bound = 1 / math.sqrt(192 * 9)
    assert conv.abs().max() <= bound and conv.abs().max() > 0.9 * bound
    # |freqs| per pair: 1 / 10^(4 i / 32), one random angle per head
    for attn in (blk.attn, rg["overlap_attn"]):
        mag = torch.hypot(attn.rope_freqs[0], attn.rope_freqs[1])
        want = 1 / 10 ** (torch.arange(0, 32, 4) / 32.0)
        torch.testing.assert_close(mag, want.repeat(2).expand(6, 16),
                                   rtol=1e-5, atol=1e-6)
    assert not torch.equal(blk.attn.rope_freqs,
                           rg["blocks"][0].attn.rope_freqs)
    small = [init_weights(hat.HATNOUP(**TINY_HAT),
                          torch.Generator().manual_seed(3)).state_dict()
             for _ in range(2)]
    for k, v in small[0].items():
        assert torch.equal(v, small[1][k]), k
