"""gsasr_torch fused decoder layers against gsasr_tpu on the CPU: each
paper option set of ln_mlp_residual (kernel M) and ln_attn_proj (kernel A),
plain versions against the Pallas kernels in interpret mode. Window counts
include odd ones, which the JAX side pads to its window block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import fused_layers as jf
from gsasr_torch.ops import fused_layers as tf

# (windows, tokens, channels, heads): narrow, and the production widths
SHAPES = [(5, 16, 24, 4), (3, 144, 180, 6)]


def _lin(rng, n_out, n_in):
    """nn.Linear-style weight (out, in) and bias."""
    bound = 1 / np.sqrt(n_in)
    return (rng.uniform(-bound, bound, (n_out, n_in)).astype(np.float32),
            rng.uniform(-bound, bound, n_out).astype(np.float32))


def _ln_params(rng, c):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("shape", SHAPES, ids=["narrow", "full_width"])
@pytest.mark.parametrize("opts", ["ln_inj", "ln", "resi"])
def test_ln_mlp_residual_matches_jax(shape, opts):
    b, t, c, _ = shape
    rng = np.random.default_rng(len(opts) + b)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w1, b1 = _lin(rng, c, c)
    w2, b2 = _lin(rng, c, c)
    ln_w, ln_b = _ln_params(rng, c) if opts != "resi" else (None, None)
    inj = (rng.standard_normal((b, c)).astype(np.float32)
           if opts == "ln_inj" else None)
    resi = (rng.standard_normal((b, t, c)).astype(np.float32)
            if opts == "resi" else None)
    ref = np.asarray(jf.ln_mlp_residual(
        jnp.asarray(x), w1=jnp.asarray(w1.T), b1=jnp.asarray(b1),
        w2=jnp.asarray(w2.T), b2=jnp.asarray(b2), ln_w=_j(ln_w),
        ln_b=_j(ln_b), inj=_j(inj), resi=_j(resi)))
    out = tf.ln_mlp_residual(
        torch.from_numpy(x), w1=_t(w1), b1=_t(b1), w2=_t(w2), b2=_t(b2),
        ln_w=_t(ln_w), ln_b=_t(ln_b), inj=_t(inj), resi=_t(resi)).numpy()
    # 1e-5: two float32 products of depth C summed in another order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=["narrow", "full_width"])
@pytest.mark.parametrize("opts", ["cross_pos_kv_bias", "self_bias"])
def test_ln_attn_proj_matches_jax(shape, opts):
    b, t, c, nh = shape
    rng = np.random.default_rng(len(opts) + b)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    ws = {}
    for n in ("q", "k", "v", "o"):
        ws[f"w{n}"], ws[f"b{n}"] = _lin(rng, c, c)
    ln_w, ln_b = _ln_params(rng, c)
    bias = (0.02 * rng.standard_normal((nh, t, t))).astype(np.float32)
    cross = opts.startswith("cross")
    pos = rng.standard_normal((t, c)).astype(np.float32) if cross else None
    kv = rng.standard_normal((b, t, c)).astype(np.float32) if cross else None
    jw = {k: jnp.asarray(v.T if k.startswith("w") else v)
          for k, v in ws.items()}
    ref = np.asarray(jf.ln_attn_proj(
        jnp.asarray(x), **jw, ln_w=jnp.asarray(ln_w), ln_b=jnp.asarray(ln_b),
        num_heads=nh, bias=jnp.asarray(bias), pos=_j(pos), kv=_j(kv)))
    out = tf.ln_attn_proj(
        torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in ws.items()},
        ln_w=_t(ln_w), ln_b=_t(ln_b), num_heads=nh, bias=_t(bias),
        pos=_t(pos), kv=_t(kv)).numpy()
    # 1e-5: products of depth C and T and an f32 softmax, summed in
    # another order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_unported_options_raise():
    """zero_base, RoPE and bf16 activations (the Enhanced family)
    differentiate, the RoPE tables included, with finite gradients; the
    backward of windows of more than 160 tokens (AB-long's, ported) runs,
    and its gradients equal autograd through the plain forward."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x = r(2, 4, 8).requires_grad_()
    mlp = dict(w1=r(8, 8), b1=r(8), w2=r(8, 8), b2=r(8))
    attn = {k: r(8, 8) if k[0] == "w" else r(8)
            for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    attn.update(ln_w=r(8), ln_b=r(8), num_heads=2)
    rope = {k: r(4, 8).requires_grad_() for k in (
        "rope_cos_q", "rope_sin_q", "rope_cos_k", "rope_sin_k")}
    for y, wrt in ((tf.ln_mlp_residual(x, zero_base=True, **mlp), [x]),
                   (tf.ln_mlp_residual(x.bfloat16(), **mlp), [x]),
                   (tf.ln_attn_proj(x, **attn, **rope),
                    [x, *rope.values()]),
                   (tf.ln_attn_proj(x.bfloat16(), **attn), [x])):
        assert y.shape == x.shape and y.grad_fn is not None
        grads = torch.autograd.grad(y.float().sum(), wrt)
        assert all(bool(torch.isfinite(d).all()) for d in grads)
    long = r(1, 161, 8).requires_grad_()
    weights = {k: v.clone().requires_grad_() for k, v in attn.items()
               if k != "num_heads"}
    g_out = r(1, 161, 8)
    y = tf.ln_attn_proj(long, num_heads=2, **weights)
    assert y.shape == long.shape
    got = torch.autograd.grad(y, [long, *weights.values()], g_out)
    ref = tf.ln_attn_proj_plain(long, num_heads=2, **weights)
    want = dict(zip(["x", *weights], torch.autograd.grad(
        ref, [long, *weights.values()], g_out)))
    for name, a in zip(want, got):
        # 1e-5 of the tensor's largest entry (float32 sums in another
        # order); the k bias's true gradient is 0, held to the k weight's
        scale = want["wk" if name == "bk" else name].abs().max()
        torch.testing.assert_close(a, want[name], rtol=0,
                                   atol=1e-5 * float(scale), msg=name)
