"""gsasr_torch packed window attention against gsasr_tpu on the CPU: the
forward (Pallas K11 in interpret mode) and jax.grad through its custom VJP
(K12 in interpret mode) against the port's autograd Function, which runs
the plain versions of kernels W and WB on CPU tensors; and the plain
backward against torch.autograd of the plain forward."""

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


def test_window_mask_raises():
    x = torch.zeros(2, 4, 6)
    with pytest.raises(NotImplementedError):
        ta.window_attention_packed(x, x, x, num_heads=2,
                                   window_mask=torch.zeros(1, 4, 4))


def test_default_scale_and_launch_count_on_cpu():
    """scale defaults to hd^-0.5; CPU tensors never count kernel launches."""
    q, k, v, bs, _ = _inputs(3, 9, 9, 8, 2, True, seed=2)
    q, k, v, bs = map(torch.from_numpy, (q, k, v, bs))
    n = ta.window_attention_packed_fwd.launches
    out = ta.window_attention_packed(q, k, v, bs, num_heads=2)
    ref = ta.window_attention_packed_plain(q, k, v, bs, 4 ** -0.5, 2)
    assert torch.equal(out, ref)
    assert ta.window_attention_packed_fwd.launches == n
