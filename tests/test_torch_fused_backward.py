"""gsasr_torch fused-layer gradients against gsasr_tpu on the CPU.

ln_mlp_residual and ln_attn_proj through their autograd Functions (the
plain versions of kernels MB and AB here) against jax.vjp of the JAX
package's fused layers, whose custom VJPs run the Pallas kernels K9 and K10
in interpret mode; the ordered bias-table gradient against autograd of the
plain gather; and the whole fused decoder's gradients against jax.grad
through the JAX fused decoder and against the port's module path. Inputs
are made with numpy from a seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import fused_layers as jf
from gsasr_tpu.utils.torch_convert import convert_edsr, convert_fea2gs
from gsasr_torch.models import EDSRNOUP, Fea2GS
from gsasr_torch.models.fea2gs import (cross_attn_rel_pos_index,
                                       self_attn_rel_pos_index)
from gsasr_torch.models.init import init_weights
from gsasr_torch.ops import bias_table
from gsasr_torch.ops import fused_layers as tf
from gsasr_torch.utils.convert import load_params, params_from_jax

# (windows, tokens, channels, heads): an even window count, and a prime one
# above the JAX window block of 8, which the JAX side pads to 16
SHAPES = [(4, 16, 24, 4), (11, 16, 24, 4)]
# weights whose JAX layout is the transpose of nn.Linear's
_TRANSPOSED = {"w1", "w2", "wq", "wk", "wv", "wo"}


def _assert_close(got, ref, tol, name, scale=None):
    """|got - ref| <= tol * (the column's largest |ref|, or `scale`) +
    tol * |ref|: sums over rows and windows cancel, so an entry's error
    follows its column's scale. Vectors take their largest entry."""
    r = ref.reshape(-1, ref.shape[-1]) if ref.ndim >= 2 else ref.reshape(1, -1)
    if scale is None:
        scale = np.abs(r).max(axis=0) if ref.ndim >= 2 else np.abs(r).max()
    err = np.abs(np.asarray(got).reshape(r.shape) - r)
    bad = err > tol * scale + tol * np.abs(r)
    assert not bad.any(), (name, float(err.max()), float(np.abs(r).max()))


def _lin(rng, n_out, n_in):
    bound = 1 / np.sqrt(n_in)
    return (rng.uniform(-bound, bound, (n_out, n_in)).astype(np.float32),
            rng.uniform(-bound, bound, n_out).astype(np.float32))


def _ln_params(rng, c):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _vjp_both(jax_fn, torch_fn, args, g):
    """(port gradients, JAX gradients) of the named numpy args at cotangent
    g; JAX takes the transposed weights and its gradients come back in the
    port's layout."""
    names = list(args)

    def jf_(*vals):
        return jax_fn(**dict(zip(names, vals)))

    jvals = [jnp.asarray(args[n].T if n in _TRANSPOSED else args[n])
             for n in names]
    _, vjp = jax.vjp(jf_, *jvals)
    jgrads = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    jgrads = {n: (d.T if n in _TRANSPOSED else d)
              for n, d in zip(names, jgrads)}
    ts = {n: torch.from_numpy(v).requires_grad_() for n, v in args.items()}
    out = torch_fn(**ts)
    tgrads = torch.autograd.grad(out, list(ts.values()), torch.from_numpy(g))
    return {n: d.numpy() for n, d in zip(names, tgrads)}, jgrads


@pytest.mark.parametrize("shape", SHAPES, ids=["even", "prime"])
@pytest.mark.parametrize("opts", ["ln_inj", "ln", "resi"])
def test_ln_mlp_residual_vjp_matches_jax(shape, opts):
    """The decoder's three option sets of K9: (LN, inj, base x+inj), (LN,
    base x), (no LN, resi)."""
    b, t, c, _ = shape
    rng = np.random.default_rng(len(opts) + b)
    args = {"x": rng.standard_normal((b, t, c)).astype(np.float32)}
    args["w1"], args["b1"] = _lin(rng, c, c)
    args["w2"], args["b2"] = _lin(rng, c, c)
    if opts != "resi":
        args["ln_w"], args["ln_b"] = _ln_params(rng, c)
    if opts == "ln_inj":
        args["inj"] = rng.standard_normal((b, c)).astype(np.float32)
    if opts == "resi":
        args["resi"] = rng.standard_normal((b, t, c)).astype(np.float32)
    g = rng.standard_normal((b, t, c)).astype(np.float32)
    got, want = _vjp_both(lambda x, **kw: jf.ln_mlp_residual(x, **kw),
                          lambda x, **kw: tf.ln_mlp_residual(x, **kw),
                          args, g)
    for n in args:
        # 1e-5 of the column's scale: products of depth C and sums over
        # b * t rows, in another order
        _assert_close(got[n], want[n], 1e-5, n)


@pytest.mark.parametrize("shape", SHAPES, ids=["even", "prime"])
@pytest.mark.parametrize("opts", ["cross_pos_kv_bias", "self_bias"])
def test_ln_attn_proj_vjp_matches_jax(shape, opts):
    """The decoder's two option sets of K10: cross-attention (pos, kv,
    bias) and self-attention (bias)."""
    b, t, c, nh = shape
    rng = np.random.default_rng(len(opts) + b)
    args = {"x": rng.standard_normal((b, t, c)).astype(np.float32)}
    for n in ("q", "k", "v", "o"):
        args[f"w{n}"], args[f"b{n}"] = _lin(rng, c, c)
    args["ln_w"], args["ln_b"] = _ln_params(rng, c)
    args["bias"] = (0.5 * rng.standard_normal((nh, t, t))).astype(np.float32)
    if opts.startswith("cross"):
        args["pos"] = rng.standard_normal((t, c)).astype(np.float32)
        args["kv"] = rng.standard_normal((b, t, c)).astype(np.float32)
    g = rng.standard_normal((b, t, c)).astype(np.float32)
    got, want = _vjp_both(
        lambda x, **kw: jf.ln_attn_proj(x, num_heads=nh, **kw),
        lambda x, **kw: tf.ln_attn_proj(x, num_heads=nh, **kw), args, g)
    for n in args:
        # 1e-5 of the column's scale: products of depth C and T, an f32
        # softmax and sums over windows, in another order. The k bias's
        # true gradient is 0 (softmax ignores a per-query constant), so
        # both sides are float32 noise, held to the k weight's scale.
        scale = np.abs(want["wk"]).max() if n == "bk" else None
        _assert_close(got[n], want[n], 1e-5, n, scale)


@pytest.mark.parametrize("kind", ["cross", "self"])
def test_bias_table_grad_matches_gather_autograd(kind):
    """The ordered table gradient equals autograd's accumulating gradient
    of the plain gather, on the paper decoder's index (144 seeds, window
    12), and the bias itself is the gather."""
    index = (cross_attn_rel_pos_index(12, 12) if kind == "cross"
             else self_attn_rel_pos_index(12))
    rows = int(index.max()) + 3  # the table has rows no position reads
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((rows, 6)).astype(
        np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((6, *index.shape)).astype(
        np.float32))
    idx = torch.from_numpy(index.astype(np.int64))
    inv = torch.from_numpy(bias_table.inverse_index(index, rows))
    out = bias_table.relative_position_bias(table, idx, inv)
    ref = table[idx.reshape(-1)].reshape(*index.shape, 6).permute(2, 0, 1)
    assert torch.equal(out, ref)
    (got,) = torch.autograd.grad(out, table, g)
    (want,) = torch.autograd.grad(ref, table, g)
    # 1e-5 of the largest entry: up to 144 entries a row, summed in
    # another order
    _assert_close(got.numpy(), want.numpy(), 1e-5, kind,
                  float(want.abs().max()))
    assert torch.all(got[int(index.max()) + 1:] == 0)


# tests/test_fused_backward.py::test_fused_decoder_full_grad_parity's
# configuration
DEC_KW = dict(inchannel=8, channel=24, num_heads=4, num_crossattn_blocks=1,
              num_crossattn_layers=2, num_selfattn_blocks=1,
              num_selfattn_layers=2, num_gs_seed=16, window_size=4)


def _decoder_case(seed=0):
    """A port Fea2GS with seeded reference initializers, its JAX parameter
    tree (read by the JAX package's reference converter), and a loss input:
    srcs (1, 8, 8, 8), scale 2, weights w (1, 1024, 9)."""
    g = torch.Generator().manual_seed(seed)
    enc = init_weights(EDSRNOUP(num_feat=8, num_block=1), g)
    dec = init_weights(Fea2GS(**DEC_KW), g)
    ep = convert_edsr(enc.state_dict())
    dp = convert_fea2gs(dec.state_dict(), num_gs_seed=16, window_size=4,
                        num_heads=4)
    dec = load_params(Fea2GS(**DEC_KW), params_from_jax(ep, dp)[1])
    rng = np.random.default_rng(2)
    srcs = rng.random((1, 8, 8, 8), dtype=np.float32)
    w = rng.random((1, 1024, 9), dtype=np.float32)
    return ep, dp, dec, srcs, np.full((1,), 2.0, np.float32), w


def _port_grads(dec, fn, srcs, scale, w):
    dec.zero_grad(set_to_none=True)
    out = fn(torch.from_numpy(srcs), torch.from_numpy(scale))
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    return loss.item(), {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p)).numpy()
                         for n, p in dec.named_parameters()}


def test_fused_decoder_grads_match_jax():
    """Gradients of sum(w * fea2gs_apply_fused(...)) against jax.grad
    through the JAX fused decoder (K7-K10 in interpret mode), every
    parameter, dead LayerNorms and ScaleInject's q/k thirds included."""
    from gsasr_tpu.models import Fea2GS as JFea2GS
    from gsasr_tpu.models.fea2gs_fast import fea2gs_apply_fused as jfused
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused

    ep, dp, dec, srcs, scale, w = _decoder_case()
    jdec = JFea2GS(**DEC_KW)

    def jloss(p):
        return jnp.sum(jnp.asarray(w) * jfused(jdec, {"params": p},
                                               jnp.asarray(srcs),
                                               jnp.asarray(scale)))

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(dp)
    loss, got = _port_grads(
        dec, lambda s, sc: fea2gs_apply_fused(dec, s, sc), srcs, scale, w)
    # 1e-5 relative: a sum of 9,216 outputs through 13 fused sub-layers
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    want = params_from_jax(ep, jgrad)[1]
    for name, g in got.items():
        ref = want[name].numpy()
        # 1e-4 of the tensor's largest entry, as the module decoder's test
        # against JAX: sums over windows and heads in another order
        np.testing.assert_allclose(g, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max() + 1e-7,
                                   err_msg=name)


def test_fused_decoder_grads_match_module_path():
    """The port's fused path and its module path (Fea2GS.forward, kernels
    W and WB on the card) give the same loss and parameter gradients."""
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused

    _, _, dec, srcs, scale, w = _decoder_case(seed=1)
    l_mod, g_mod = _port_grads(dec, dec, srcs, scale, w)
    l_fused, g_fused = _port_grads(
        dec, lambda s, sc: fea2gs_apply_fused(dec, s, sc), srcs, scale, w)
    np.testing.assert_allclose(l_fused, l_mod, rtol=1e-5)
    for name, ref in g_mod.items():
        # 1e-4 of the tensor's largest entry: the same float32 sub-layers
        # composed in another order
        np.testing.assert_allclose(g_fused[name], ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max() + 1e-7,
                                   err_msg=name)
    assert math.isfinite(l_fused)
