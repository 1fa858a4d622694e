"""gsasr_torch's RoPE pieces against gsasr_tpu on the CPU: the rotation
helpers, the new forms of the fused layers (kernel M with zero_base and in
bfloat16, kernel A with RoPE and in bfloat16; plain versions here, the
Pallas kernels in interpret mode on the JAX side) and the Enhanced
decoder's module path against `Fea2GSRopeAMP.apply`.

float32 cases hold the algorithm (1e-5 for one layer); bfloat16 cases hold
the rounding points on the same bf16 inputs, within 1e-2 of the output's
largest entry: both sides round at the same places, but sum their f32
products in another order, which can move a rounded intermediate by one
bf16 step (the worst seen: 5.0e-3 of max|ref|, one step of the output, in
A at 192 channels; the narrow cases agree to the bit). Inputs are made
with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import fea2gs_rope as jrope
from gsasr_tpu.models.fea2gs_rope_fast import _rope_tables as jrope_tables
from gsasr_tpu.ops import fused_layers as jf
from gsasr_torch.models import fea2gs_rope as trope
from gsasr_torch.models.fea2gs_rope_fast import rope_tables
from gsasr_torch.ops import fused_layers as tf

# (windows, query tokens, key tokens, channels, heads): narrow, with more
# keys than queries, and the Enhanced widths (192 channels, 6 heads of 32)
SHAPES = [(5, 16, 36, 24, 4), (3, 144, 144, 192, 6)]
# bf16 bound: a fraction of the output's largest entry
BF16_TOL = 1e-2


def _lin(rng, n_out, n_in):
    bound = 1 / np.sqrt(n_in)
    return (rng.uniform(-bound, bound, (n_out, n_in)).astype(np.float32),
            rng.uniform(-bound, bound, n_out).astype(np.float32))


def _ln_params(rng, c):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _freqs(rng, nh, hd):
    return (0.5 * rng.standard_normal((2, nh, hd // 2))).astype(np.float32)


def _act(a, dtype):
    """An activation as (torch tensor, jax array) of the same values, in
    `dtype` ("f32" or "bf16"): bf16 values are rounded once, by torch, and
    handed to JAX exactly."""
    if a is None:
        return None, None
    t = torch.from_numpy(a)
    if dtype == "f32":
        return t, jnp.asarray(a)
    t = t.to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _compare(out, ref, dtype):
    """out: torch tensor; ref: jax array; both in `dtype`. Returns the
    largest |out - ref| and max|ref|."""
    assert out.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert ref.dtype == (jnp.float32 if dtype == "f32" else jnp.bfloat16)
    o = out.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    err, scale = float(np.abs(o - r).max()), float(np.abs(r).max())
    if dtype == "f32":
        # two float32 products of depth C and T summed in another order
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
    else:
        assert err <= BF16_TOL * scale, (err, scale)
    return err, scale


@pytest.mark.parametrize("end", [4, 12])
def test_rope_helpers_match_jax(end):
    rng = np.random.default_rng(end)
    nh, hd = 4, 8
    freqs = _freqs(rng, nh, hd)
    tx, ty = trope.rope_t_xy(end, end)
    jtx, jty = jrope.rope_t_xy(end, end)
    np.testing.assert_array_equal(tx.numpy(), jtx)
    np.testing.assert_array_equal(ty.numpy(), jty)
    ph = trope.rope_phases(torch.from_numpy(freqs), tx, ty)
    jph = jrope.rope_phases(jnp.asarray(freqs), jnp.asarray(jtx),
                            jnp.asarray(jty))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), rtol=1e-6,
                               atol=1e-6)
    n = end * end - 3  # fewer tokens than the lattice: the phases are cut
    x = rng.standard_normal((2, n, nh * hd)).astype(np.float32)
    out = trope.apply_rope_packed(torch.from_numpy(x), ph, nh)
    ref = jrope.apply_rope_packed(jnp.asarray(x), jph, nh)
    # cos and sin of angles up to about 20 rad in two libraries
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    x4 = x.reshape(2, n, nh, hd).transpose(0, 2, 1, 3)
    out4 = trope.apply_rope(torch.from_numpy(np.ascontiguousarray(x4)), ph)
    np.testing.assert_allclose(
        out4.numpy(), np.asarray(jrope.apply_rope(jnp.asarray(x4), jph)),
        rtol=1e-5, atol=1e-5)
    # the packed form is the 4D oracle in another layout
    np.testing.assert_allclose(out4.numpy().transpose(0, 2, 1, 3).reshape(
        x.shape), out.numpy(), rtol=1e-6, atol=1e-6)
    cos, sin = rope_tables(torch.from_numpy(freqs), end, n)
    jcos, jsin = jrope_tables(jnp.asarray(freqs), end, n, nh)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-5,
                               atol=1e-5)
    # the tables' rotation is apply_rope_packed's
    np.testing.assert_allclose(
        tf.rope_rotate(torch.from_numpy(x), cos, sin).numpy(), out.numpy(),
        rtol=1e-5, atol=1e-5)


# M's forms: the Enhanced block tail (zero_base, no LN) in both types; the
# Enhanced inject and FFN chains and the paper tail (resi) in bf16
MLP_CASES = [("zero_base", "f32"), ("zero_base", "bf16"), ("ln_inj", "bf16"),
             ("ln", "bf16"), ("resi", "bf16")]


@pytest.mark.parametrize("shape", SHAPES, ids=["narrow", "full_width"])
@pytest.mark.parametrize("opts,dtype", MLP_CASES,
                         ids=[f"{o}-{d}" for o, d in MLP_CASES])
def test_ln_mlp_new_forms_match_jax(shape, opts, dtype):
    b, t, _, c, _ = shape
    rng = np.random.default_rng(len(opts) + b)
    x, jx = _act(rng.standard_normal((b, t, c)).astype(np.float32), dtype)
    w1, b1 = _lin(rng, c, c)
    w2, b2 = _lin(rng, c, c)
    ln_w, ln_b = (_ln_params(rng, c) if opts in ("ln_inj", "ln")
                  else (None, None))
    inj, jinj = _act(rng.standard_normal((b, c)).astype(np.float32)
                     if opts == "ln_inj" else None, dtype)
    resi, jresi = _act(rng.standard_normal((b, t, c)).astype(np.float32)
                       if opts == "resi" else None, dtype)
    zero = opts == "zero_base"
    ref = jf.ln_mlp_residual(
        jx, w1=jnp.asarray(w1.T), b1=jnp.asarray(b1), w2=jnp.asarray(w2.T),
        b2=jnp.asarray(b2), ln_w=None if ln_w is None else jnp.asarray(ln_w),
        ln_b=None if ln_b is None else jnp.asarray(ln_b), inj=jinj,
        resi=jresi, zero_base=zero)
    t_ = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = tf.ln_mlp_residual(x, w1=t_(w1), b1=t_(b1), w2=t_(w2), b2=t_(b2),
                             ln_w=t_(ln_w), ln_b=t_(ln_b), inj=inj, resi=resi,
                             zero_base=zero)
    _compare(out, ref, dtype)


# A's forms: RoPE cross (pos, kv) and self in both types; the paper forms
# (bias table) in bf16
ATTN_CASES = [("rope_cross", "f32"), ("rope_self", "f32"),
              ("rope_cross", "bf16"), ("rope_self", "bf16"),
              ("bias_cross", "bf16"), ("bias_self", "bf16")]


@pytest.mark.parametrize("shape", SHAPES, ids=["narrow", "full_width"])
@pytest.mark.parametrize("opts,dtype", ATTN_CASES,
                         ids=[f"{o}-{d}" for o, d in ATTN_CASES])
def test_ln_attn_new_forms_match_jax(shape, opts, dtype):
    _ln_attn_case(shape, opts, dtype)


# the window-16 decoders' A (A-long on the card): 256 seeds against 256
# keys, narrow
WINDOW16_ATTN_CASES = ATTN_CASES[:4]


@pytest.mark.parametrize("opts,dtype", WINDOW16_ATTN_CASES,
                         ids=[f"{o}-{d}" for o, d in WINDOW16_ATTN_CASES])
def test_ln_attn_window16_matches_jax(opts, dtype):
    """A's RoPE forms at T = 256 (C 16, 2 heads): the plain version the
    CPU takes for A-long against K8 in interpret mode."""
    _ln_attn_case((2, 256, 256, 16, 2), opts, dtype)


def _ln_attn_case(shape, opts, dtype):
    b, tq, tk, c, nh = shape
    cross = opts.endswith("cross")
    if not cross:
        tk = tq
    rng = np.random.default_rng(len(opts) + b)
    x, jx = _act(rng.standard_normal((b, tq, c)).astype(np.float32), dtype)
    ws = {}
    for n in ("q", "k", "v", "o"):
        ws[f"w{n}"], ws[f"b{n}"] = _lin(rng, c, c)
    ln_w, ln_b = _ln_params(rng, c)
    kw, jkw = {}, {}
    if cross:
        pos = rng.standard_normal((tq, c)).astype(np.float32)
        kw["pos"], jkw["pos"] = torch.from_numpy(pos), jnp.asarray(pos)
        kw["kv"], jkw["kv"] = _act(
            rng.standard_normal((b, tk, c)).astype(np.float32), dtype)
    if opts.startswith("rope"):
        freqs = torch.from_numpy(_freqs(rng, nh, c // nh))
        cos, sin = rope_tables(freqs, int(np.ceil(np.sqrt(max(tq, tk)))),
                               max(tq, tk))
        for name, tab, n in (("rope_cos_q", cos, tq), ("rope_sin_q", sin, tq),
                             ("rope_cos_k", cos, tk), ("rope_sin_k", sin, tk)):
            kw[name] = tab[:n].contiguous()
            jkw[name] = jnp.asarray(tab[:n].numpy())
    else:
        bias = (0.5 * rng.standard_normal((nh, tq, tk))).astype(np.float32)
        kw["bias"], jkw["bias"] = torch.from_numpy(bias), jnp.asarray(bias)
    ref = jf.ln_attn_proj(
        jx, **{k: jnp.asarray(v.T if k[0] == "w" else v)
               for k, v in ws.items()},
        ln_w=jnp.asarray(ln_w), ln_b=jnp.asarray(ln_b), num_heads=nh, **jkw)
    out = tf.ln_attn_proj(
        x, **{k: torch.from_numpy(v) for k, v in ws.items()},
        ln_w=torch.from_numpy(ln_w), ln_b=torch.from_numpy(ln_b),
        num_heads=nh, **kw)
    _compare(out, ref, dtype)


def test_wrappers_check_new_forms_before_launch():
    """On CUDA tensors (meta tensors stand in) the wrappers refuse a RoPE
    table set that is incomplete or misshaped and a float64 activation
    before any launch."""
    meta = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
        *s, device="meta", dtype=dt)
    b, t, c = 2, 16, 24
    attn = {k: meta(c, c) if k[0] == "w" else meta(c)
            for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    attn.update(ln_w=meta(c), ln_b=meta(c), num_heads=4)
    x = meta(b, t, c, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="inconsistent"):
        tf.ln_attn_proj(x, rope_cos_q=meta(t, c), **attn)
    with pytest.raises(ValueError, match="inconsistent"):
        tf.ln_attn_proj(x, rope_cos_q=meta(t, c), rope_sin_q=meta(t, c),
                        rope_cos_k=meta(t, c), rope_sin_k=meta(t - 1, c),
                        **attn)
    with pytest.raises(ValueError, match="CUDA"):
        tf.ln_attn_proj(x, rope_cos_q=meta(t, c), rope_sin_q=meta(t, c),
                        rope_cos_k=meta(t, c), rope_sin_k=meta(t, c), **attn)
    with pytest.raises(TypeError):
        tf.ln_attn_proj(meta(b, t, c, dt=torch.float64), **attn)
    mlp = dict(w1=meta(c, c), b1=meta(c), w2=meta(c, c), b2=meta(c))
    with pytest.raises(TypeError):
        tf.ln_mlp_residual(meta(b, t, c, dt=torch.float16), **mlp)
    with pytest.raises(ValueError, match="CUDA"):
        tf.ln_mlp_residual(x, zero_base=True, **mlp)


# the JAX package's tiny Enhanced configuration (tests/test_fea2gs_rope_fast.py)
TINY = dict(inchannel=8, channel=32, num_heads=4, num_crossattn_blocks=1,
            num_crossattn_layers=2, num_selfattn_blocks=2,
            num_selfattn_layers=2, num_gs_seed=16, window_size=4)


def test_module_decoder_matches_jax():
    """Fea2GSRopeAMP.forward (the float32 module path, attention through
    window_attention_packed) against the JAX module's apply on the same
    weights, on two images of 2x3 windows: shifted and unshifted layers,
    the RoPE rotations, the block convs, conv_final with its long residual,
    UPNet and the heads."""
    from gsasr_tpu.utils.torch_convert import convert_edsr, convert_fea2gs_rope
    from gsasr_torch.models import EDSRNOUP
    from gsasr_torch.models.init import init_weights
    from gsasr_torch.utils.convert import load_params, params_from_jax

    b, hw = 2, (8, 12)
    g = torch.Generator().manual_seed(b)
    ep = convert_edsr(init_weights(EDSRNOUP(num_feat=8, num_block=1),
                                   g).state_dict())
    dp = convert_fea2gs_rope(
        init_weights(trope.Fea2GSRopeAMP(**TINY), g).state_dict())
    dec = load_params(trope.Fea2GSRopeAMP(**TINY),
                      params_from_jax(ep, dp)[1]).eval()
    rng = np.random.default_rng(b)
    srcs = rng.random((b, *hw, 8), dtype=np.float32)
    scale = rng.uniform(1.5, 4.0, (b,)).astype(np.float32)
    ref = jax.jit(lambda p, x, s: jrope.Fea2GSRopeAMP(**TINY).apply(
        {"params": p}, x, s))(dp, jnp.asarray(srcs), jnp.asarray(scale))
    with torch.no_grad():
        out = dec(torch.from_numpy(srcs), torch.from_numpy(scale)).numpy()
    assert out.shape == ref.shape
    # 2e-4, as the JAX package's fused-vs-module test: float32 sums in
    # another order through 21 residual sub-layers and 4 convolutions
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-4, atol=2e-4)
