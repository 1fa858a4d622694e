"""gsasr_torch's HAT-L encoder against gsasr_tpu on the CPU: each module
(CAB, the RoPE window attention, HAB unshifted and shifted, OCAB and its
overlapping windows, a tiny HATNOUP, a full-width RHAG), the state_dict
round trip through the reference converter, the seeded initializers
(make_models' HAT-L: tests/test_torch_hat_make_models.py), what stays unported raising, and the backward through
a 256-token window on the CPU.

Weights come from a JAX init (every leaf moved by seeded noise, so biases
and LayerNorm affines are not trivially 0 or 1) and are loaded into port
modules with the `hat_*` converters of `gsasr_torch.utils.convert`. The
JAX side's window attentions take the JAX package's plain reference
(GSASR_ATTN=reference): K11 itself is held against the port at T = 256
and 256 x 576 in interpret mode by tests/test_torch_attention.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import hat as jhat
from gsasr_tpu.utils.torch_convert import convert_hat
from gsasr_torch.models import hat
from gsasr_torch.models.init import init_weights
from gsasr_torch.ops.attention import window_attention_packed
from gsasr_torch.utils import convert as cv
from gsasr_torch.utils.convert import load_params

ROOT = Path(__file__).resolve().parents[1]
# tests/test_model_parity.py's tiny HAT (window 4: an 8x12 map has shifted
# windows and 6 overlapping windows), with 8 output features
TINY_HAT = dict(embed_dim=24, depths=(2, 2), num_heads=(6, 6), window_size=4,
                squeeze_factor=4, mlp_ratio=2, num_feat=8)


@pytest.fixture(autouse=True)
def _jax_reference_attention(monkeypatch):
    monkeypatch.setenv("GSASR_ATTN", "reference")


def _noisy_init(jmod, x, seed):
    """A JAX init of `jmod` on x, every leaf moved by 0.05 x N(0, 1)."""
    p = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32)), p)


def _pair(jmod, tmod, conv, x, seed=0):
    """JAX params of jmod and the port module loaded with them through the
    converter `conv` (one of convert.hat_*)."""
    p = _noisy_init(jmod, x, seed)
    sd = {}
    conv(sd, "m", p)
    load_params(tmod, {k[2:]: v for k, v in sd.items()})
    return p, tmod.eval()


def _check(jmod, p, tmod, x, *targs, tol=1e-5):
    ref = np.asarray(jax.jit(lambda pp, xx: jmod.apply({"params": pp}, xx))(
        p, jnp.asarray(x)))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x), *targs).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_cab_matches_jax():
    """Convs, exact GELU and the channel attention's 1x1 convs taken as
    linears on the mean; 1e-5: float32 sums of depth 216."""
    x = _x(1, 2, 8, 12, 24)
    jm = jhat.CAB(24, compress_ratio=3, squeeze_factor=4)
    p, m = _pair(jm, hat.CAB(24, 3, 4), cv.hat_cab, x)
    _check(jm, p, m, x)


def test_window_attention_matches_jax():
    """qkv split in thirds, RoPE on the 4x4 window lattice, no mask or bias,
    proj."""
    x = _x(2, 6, 16, 24)
    jm = jhat.HATWindowAttention(24, window_size=4, num_heads=6)
    p, m = _pair(jm, hat.HATWindowAttention(24, 6), cv.hat_window_attn, x)
    _check(jm, p, m, x, 4)


@pytest.mark.parametrize("shift", [0, 2])
def test_hab_matches_jax(shift):
    """HAB unshifted and shifted by ws // 2 (rolled, attended unmasked,
    rolled back), the CAB branch at conv_scale 0.5 so it shows."""
    x = _x(3 + shift, 2, 8, 12, 24)
    kw = dict(dim=24, num_heads=6, window_size=4, shift_size=shift,
              compress_ratio=3, squeeze_factor=4, conv_scale=0.5,
              mlp_ratio=2.0, rope_theta=10.0)
    jm = jhat.HAB(**kw)
    p, m = _pair(jm, hat.HAB(**kw), cv.hat_hab, x)
    _check(jm, p, m, x)


def _jax_unfold(t, ws, ows):
    """The JAX OCAB's loop over patch offsets (`gsasr_tpu/models/hat.py`),
    on numpy."""
    b, h, w, c = t.shape
    pad = (ows - ws) // 2
    tp = np.pad(t, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    patches = [tp[:, dy:dy + h + 2 * pad - ows + 1:ws,
                  dx:dx + w + 2 * pad - ows + 1:ws, :]
               for dy in range(ows) for dx in range(ows)]
    return np.stack(patches, axis=3).reshape(-1, ows * ows, c)


@pytest.mark.parametrize("hw,ws,ows", [((8, 12), 4, 6), ((32, 16), 16, 24)])
def test_overlap_windows_match_the_jax_loop(hw, ws, ows):
    """OCAB's keys: the row-major patch interior of the JAX loop, bit for
    bit (nn.Unfold's channel-major order would differ)."""
    t = _x(5, 2, *hw, 3)
    out = hat.overlap_windows(torch.from_numpy(t), ws, ows)
    np.testing.assert_array_equal(out.numpy(), _jax_unfold(t, ws, ows))


def test_ocab_matches_jax():
    """Window queries against the 6x6 overlapping patches, RoPE on the 6x6
    lattice (q its first 16 positions)."""
    x = _x(6, 2, 8, 12, 24)
    kw = dict(dim=24, window_size=4, overlap_ratio=0.5, num_heads=6,
              mlp_ratio=2.0, rope_theta=10.0)
    jm = jhat.OCAB(**kw)
    p, m = _pair(jm, hat.OCAB(**kw), cv.hat_ocab, x)
    _check(jm, p, m, x)


def test_rhag_full_width_matches_jax():
    """One RHAG at HAT-L's widths (192 channels, 6 heads of 32, window 16:
    256-token windows and OCAB's 256 x 576) of depth 2 on a 32x32 map; 1e-4:
    float32 sums of depth 192 to 1728 through three blocks."""
    x = _x(7, 1, 32, 32, 192)
    kw = dict(dim=192, depth=2, num_heads=6, window_size=16,
              compress_ratio=3, squeeze_factor=32, conv_scale=0.01,
              overlap_ratio=0.5, mlp_ratio=2.0, rope_theta=10.0)
    jm = jhat.RHAG(**kw)
    p, m = _pair(jm, hat.RHAG(**kw, drop_path=(0.0, 0.0)), cv.hat_rhag, x)
    _check(jm, p, m, x, tol=1e-4)


@pytest.mark.parametrize("hw", [(8, 12), (4, 8)], ids=["8x12", "4x8"])
def test_hatnoup_tiny_matches_jax(hw):
    """The whole encoder through params_from_jax (the HAT tree told apart by
    its overlap_attn); at 4x8, min(h, w) <= window: no block shifts."""
    x = np.random.default_rng(8).random((2, *hw, 3), dtype=np.float32)
    jm = jhat.HATNOUP(**TINY_HAT)
    p = _noisy_init(jm, x, 8)
    sd, _ = cv.params_from_jax(p, _tiny_rope_decoder_tree())
    m = load_params(hat.HATNOUP(**TINY_HAT), sd).eval()
    _check(jm, p, m, x, tol=1e-4)


def _tiny_rope_decoder_tree():
    """A tiny Enhanced decoder's JAX tree: params_from_jax converts an
    encoder tree beside a decoder tree."""
    from gsasr_torch.models import Fea2GSRopeAMP
    from gsasr_tpu.utils.torch_convert import convert_fea2gs_rope

    dec = Fea2GSRopeAMP(inchannel=8, channel=8, num_heads=2,
                        num_crossattn_layers=1, num_selfattn_blocks=1,
                        num_selfattn_layers=1, num_gs_seed=16, window_size=4)
    return convert_fea2gs_rope(
        init_weights(dec, torch.Generator().manual_seed(0)).state_dict())


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def test_state_dict_roundtrip_through_reference_converter():
    """convert_hat reads the port's state_dict into a tree of the flax
    module's own structure, and params_from_jax turns it back into the same
    state_dict: the port's keys are the reference's (`hatropeamp.py`)."""
    m = init_weights(hat.HATNOUP(**TINY_HAT),
                     torch.Generator().manual_seed(9))
    tree = convert_hat(m.state_dict())
    abstract = jax.eval_shape(lambda: jhat.HATNOUP(**TINY_HAT).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))["params"]
    _assert_tree_equal(jax.tree_util.tree_map(np.shape, tree),
                       jax.tree_util.tree_map(lambda a: a.shape, abstract))
    sd, _ = cv.params_from_jax(tree, _tiny_rope_decoder_tree())
    params = dict(m.named_parameters())
    assert set(sd) == set(params) == set(m.state_dict())
    for k, v in sd.items():
        assert torch.equal(v, params[k].detach()), k


def test_unported_hat_training_raises():
    """The paper HAT (HATNOUP: relative-position bias and SW-MSA masks at
    window 16) now builds through build_networks, at the Ultra recipe's
    bf16 as the paper HAT's own test file trains it
    (tests/test_torch_hat_paper.py); a masked window attention of 256
    tokens runs on the CPU (WM-long's plain version), and what still raises
    raises: a mask whose period does not divide the window count, and an
    unknown encoder type."""
    from gsasr_torch.config import build_networks, load_options
    from gsasr_torch.models import HATNOUPPaper

    opt = load_options(ROOT / "configs" / "train_hatl_ultra.yml")
    opt["network_g"] = {"type": "HATNOUP", "embed_dim": 24, "depths": [2],
                        "num_heads": [6], "squeeze_factor": 4,
                        "num_feat": 64}
    enc, _ = build_networks(opt)
    assert isinstance(enc, HATNOUPPaper) and enc.dtype == torch.bfloat16
    m = init_weights(hat.HATWindowAttention(24, 6),
                     torch.Generator().manual_seed(4))
    x = torch.from_numpy(_x(10, 2, 256, 24))
    q, k, v = m.qkv(x).chunk(3, dim=-1)
    out = window_attention_packed(q, k, v, num_heads=6,
                                  window_mask=torch.zeros(2, 256, 256))
    assert torch.equal(out, window_attention_packed(q, k, v, num_heads=6))
    with pytest.raises(ValueError, match="multiple"):
        window_attention_packed(q, k, v, num_heads=6,
                                window_mask=torch.zeros(3, 256, 256))
    opt["network_g"] = {"type": "HATNOUP_PAPER"}
    with pytest.raises(NotImplementedError):
        build_networks(opt)


def test_hat_window_attention_backward_on_cpu():
    """The backward through a HAT window attention of 256 tokens, once a
    raise, runs WB-long's plain version on CPU tensors: every parameter's
    and the input's gradient equals autograd through the plain forward
    (float32, the same products in another order: 1e-5 of each tensor's
    largest entry), and no kernel launch is counted."""
    from gsasr_torch.ops import attention as ta

    m = init_weights(hat.HATWindowAttention(24, 6),
                     torch.Generator().manual_seed(4))
    x = torch.from_numpy(_x(10, 2, 256, 24)).requires_grad_()
    cot = torch.from_numpy(_x(11, 2, 256, 24))
    n = ta.window_attention_packed_long_bwd.launches
    y = m(x, 16)
    got = torch.autograd.grad((y * cot).sum(), [x, *m.parameters()])
    assert ta.window_attention_packed_long_bwd.launches == n

    def plain(q, k, v, bias, num_heads):
        return ta.window_attention_packed_plain(q, k, v, bias,
                                                (24 // 6) ** -0.5, num_heads)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hat, "window_attention_packed", plain)
        ref = torch.autograd.grad((m(x, 16) * cot).sum(),
                                  [x, *m.parameters()])
    for a, r in zip(got, ref):
        tol = 1e-5 * float(r.abs().max())
        torch.testing.assert_close(a, r, rtol=1e-5, atol=tol)
