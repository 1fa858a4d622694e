"""gsasr_torch packed window attention against gsasr_tpu on the CPU: the
forward (Pallas K11, or K13 with a window mask, in interpret mode) and
jax.grad through its custom VJP (K12 or K13b in interpret mode) against the
port's autograd Function, which runs the plain versions of kernels W and
WB (WM and WMB with a mask) on CPU tensors; and the plain backward against
torch.autograd of the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops.attention import window_attention_packed as jattn
from gsasr_torch.ops import attention as ta

# (windows, Tq, Tk, C, heads, bias): a prime window count, Tq != Tk both
# ways, no bias
CASES = [(7, 16, 16, 12, 3, True), (5, 16, 9, 12, 3, True),
         (3, 9, 25, 8, 2, True), (11, 16, 16, 12, 6, False)]


def _inputs(b, tq, tk, c, nh, bias, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (r(b, tq, c), r(b, tk, c), r(b, tk, c),
            0.5 * r(nh, tq, tk) if bias else None, r(b, tq, c))


@pytest.mark.parametrize("b,tq,tk,c,nh,bias", CASES)
def test_matches_jax_forward_and_grad(b, tq, tk, c, nh, bias):
    q, k, v, bs, g = _inputs(b, tq, tk, c, nh, bias)
    args = [q, k, v] + ([bs] if bias else [])

    def jloss(*a):
        out = jattn(*a[:3], a[3] if bias else None, num_heads=nh)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))), has_aux=True)(
            *map(jnp.asarray, args))
    tens = [torch.from_numpy(a).requires_grad_() for a in args]
    out = ta.window_attention_packed(*tens[:3], tens[3] if bias else None,
                                     num_heads=nh)
    out.backward(torch.from_numpy(g))
    # 1e-5: float32 products of depth hd and Tk summed in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for t, jg in zip(tens, jgrads):
        # 1e-4: dbias sums up to 11 windows of ds, each a product chain
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bias", [True, False])
def test_plain_backward_matches_autograd(bias):
    """The explicit backward formulas (dv = p^T g, ds = p (dp - rowsum(dp
    p)), ...) equal autograd of the plain forward, in float64."""
    b, tq, tk, c, nh = 5, 16, 9, 12, 3
    arrs = _inputs(b, tq, tk, c, nh, bias, seed=1)
    q, k, v, bs, g = (None if a is None else torch.from_numpy(a).double()
                      for a in arrs)
    leaves = [t.requires_grad_() for t in (q, k, v, bs) if t is not None]
    out = ta.window_attention_packed_plain(q, k, v, bs, 0.3, nh)
    ref = torch.autograd.grad(out, leaves, g)
    got = ta.window_attention_packed_bwd_plain(
        q.detach(), k.detach(), v.detach(),
        None if bs is None else bs.detach(), g, 0.3, nh)
    assert (got[3] is None) == (not bias)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12)


# (windows, mask period nW, Tq, Tk, C, heads, bias): r = windows / nW > 1;
# a prime nW above 8 (JAX pads the period, `_pad_period`); nW = 1; no bias;
# Tq != Tk
MASKED_CASES = [(10, 5, 16, 16, 12, 3, True), (22, 11, 16, 16, 12, 6, True),
                (6, 1, 9, 25, 8, 2, True), (9, 3, 16, 9, 12, 3, False)]


def _mask(nw, tq, tk, seed):
    """A Swin-like additive mask: 0 or -100 per entry, and random values."""
    rng = np.random.default_rng(seed)
    m = np.where(rng.random((nw, tq, tk)) < 0.3, -100.0, 0.0)
    return (m + 0.3 * rng.standard_normal((nw, tq, tk))).astype(np.float32)


@pytest.mark.parametrize("b,nw,tq,tk,c,nh,bias", MASKED_CASES)
def test_masked_matches_jax_forward_and_grad(b, nw, tq, tk, c, nh, bias):
    q, k, v, bs, g = _inputs(b, tq, tk, c, nh, bias, seed=3)
    mask = _mask(nw, tq, tk, seed=4)
    args = [q, k, v] + ([bs] if bias else [])

    def jloss(*a):
        out = jattn(*a[:3], a[3] if bias else None, num_heads=nh,
                    window_mask=jnp.asarray(mask))
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(args))), has_aux=True)(
            *map(jnp.asarray, args))
    tens = [torch.from_numpy(a).requires_grad_() for a in args]
    out = ta.window_attention_packed(*tens[:3], tens[3] if bias else None,
                                     num_heads=nh,
                                     window_mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    # the tolerances of the unmasked cases: 1e-5 for float32 products
    # summed in another order, 1e-4 for dbias's sum over windows
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for t, jg in zip(tens, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bias", [True, False])
def test_plain_masked_backward_matches_autograd(bias):
    """The masked backward formulas equal autograd of the masked plain
    forward, in float64; window w takes mask[w % nW]."""
    b, nw, tq, tk, c, nh = 6, 3, 16, 9, 12, 3
    arrs = _inputs(b, tq, tk, c, nh, bias, seed=5)
    q, k, v, bs, g = (None if a is None else torch.from_numpy(a).double()
                      for a in arrs)
    mask = torch.from_numpy(_mask(nw, tq, tk, seed=6)).double()
    leaves = [t.requires_grad_() for t in (q, k, v, bs) if t is not None]
    out = ta.window_attention_packed_plain(q, k, v, bs, 0.3, nh, mask)
    ref = torch.autograd.grad(out, leaves, g)
    got = ta.window_attention_packed_bwd_plain(
        q.detach(), k.detach(), v.detach(),
        None if bs is None else bs.detach(), g, 0.3, nh, mask)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-12)
    # window 4 takes class 1: the same as attending window 4 alone
    one = ta.window_attention_packed_plain(q[4:5], k[4:5], v[4:5], bs, 0.3,
                                           nh, mask[1:2])
    assert torch.equal(one, out[4:5])


def test_window_mask_raises():
    """A mask whose period does not divide the window count, or whose rows
    are not (Tq, Tk), raises, on the CPU as on the card (meta tensors stand
    in for CUDA ones, so the check precedes any launch)."""
    x = torch.zeros(6, 4, 6)
    for mask in (torch.zeros(4, 4, 4), torch.zeros(3, 4, 5)):
        with pytest.raises(ValueError):
            ta.window_attention_packed(x, x, x, num_heads=2, window_mask=mask)
        with pytest.raises(ValueError):
            ta.window_attention_packed_masked_fwd(x, x, x, None, mask, 0.5, 2)
    meta = torch.empty(6, 4, 6, device="meta")
    with pytest.raises(ValueError, match="multiple"):
        ta.window_attention_packed_masked_bwd(
            meta, meta, meta, None, torch.empty(4, 4, 4, device="meta"),
            meta, 0.5, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ta.window_attention_packed_masked_fwd(
            meta, meta, meta, None, torch.empty(3, 4, 4, device="meta"), 0.5,
            2)


def test_default_scale_and_launch_count_on_cpu():
    """scale defaults to hd^-0.5; CPU tensors never count kernel launches."""
    q, k, v, bs, _ = _inputs(3, 9, 9, 8, 2, True, seed=2)
    q, k, v, bs = map(torch.from_numpy, (q, k, v, bs))
    n = ta.window_attention_packed_fwd.launches
    out = ta.window_attention_packed(q, k, v, bs, num_heads=2)
    ref = ta.window_attention_packed_plain(q, k, v, bs, 4 ** -0.5, 2)
    assert torch.equal(out, ref)
    assert ta.window_attention_packed_fwd.launches == n
    m = ta.window_attention_packed_masked_fwd.launches
    mask = torch.zeros(3, 9, 9)
    out = ta.window_attention_packed(q, k, v, bs, num_heads=2,
                                     window_mask=mask)
    assert torch.equal(out, ref)
    assert ta.window_attention_packed_masked_fwd.launches == m
