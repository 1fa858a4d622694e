"""gsasr_torch's window attention on the 4D layout against gsasr_tpu on the
CPU: `window_attention` and its VJP against JAX's `window_attention` and
jax.vjp of `fused_window_attention` (K14 and K14b in interpret mode) in
fp32 (tests/test_attention.py's shapes, prime window counts, no bias, a
custom scale, window 16) and bf16; the masked composition and its period
check; the plain backward against autograd; and the launch arguments of
each 4D entry point against its C signature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import attention as ja
from gsasr_torch.ops import attention as ta


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread (the tier-1 run's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, nh, tq, tk, hd, bias, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (r(b, nh, tq, hd), r(b, nh, tk, hd), r(b, nh, tk, hd),
            0.5 * r(nh, tq, tk) if bias else None, r(b, nh, tq, hd))


def _within_a_bf16_step(a, ref, floor=0.0):
    """|a - ref| <= one bf16 step of ref + 2^-16 max|ref| (the floor for
    entries whose f32 sum cancels far below the tensor's scale) + floor."""
    a, ref = a.float(), ref.float()
    _, e = torch.frexp(ref)
    step = torch.ldexp(torch.ones_like(ref), e - 8)
    return bool(((a - ref).abs()
                 <= step + 2.0 ** -16 * ref.abs().max() + floor).all())


def _vjp_pair(b, nh, tq, tk, hd, bias, seed, dt="f32", scale=None):
    """(out, dq, dk, dv, dbias) of JAX (jax.vjp of window_attention, whose
    VJP is fused_window_attention's: K14 forward, K14b backward) and of the
    port's window_attention through autograd, on the same numpy inputs, as
    torch tensors in the outputs' types."""
    q, k, v, bs, g = _inputs(b, nh, tq, tk, hd, bias, seed)
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    jq, jk, jv, jg = (jnp.asarray(x).astype(jdt) for x in (q, k, v, g))
    jb = None if bs is None else jnp.asarray(bs)
    jout, vjp = jax.vjp(
        lambda *a: ja.window_attention(*a[:3], a[3] if bias else None,
                                       scale=scale),
        jq, jk, jv, *([jb] if bias else []))
    jgrads = list(vjp(jg)) + ([] if bias else [None])

    def t(x):
        return None if x is None else torch.from_numpy(
            np.asarray(x.astype(jnp.float32))).to(
                tdt if x.dtype == jdt and dt == "bf16" else torch.float32)

    tens = [t(x).requires_grad_() for x in (jq, jk, jv)]
    tb = None if bs is None else torch.from_numpy(bs).requires_grad_()
    out = ta.window_attention(*tens, tb, scale=scale)
    out.backward(t(jg))
    port = [out.detach(), *(x.grad for x in tens),
            None if tb is None else tb.grad]
    return port, [t(jout), *(t(x) for x in jgrads)]


def _assert_pair(port, ref, dt, out_floor=0.0):
    """fp32: 1e-5 (products of depth hd and Tk keys summed in another
    order); bf16: out, dq, dk, dv within one bf16 step, out also within
    `out_floor`, dbias f32 (1e-5)."""
    for name, a, r in zip(("out", "dq", "dk", "dv", "dbias"), port, ref):
        if r is None:
            assert a is None, name
            continue
        if dt == "bf16" and name != "dbias":
            assert a.dtype == torch.bfloat16, name
            floor = out_floor if name == "out" else 0.0
            assert _within_a_bf16_step(a, r, floor), name
        else:
            assert a.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


# (windows, heads, Tq, Tk, hd, bias, scale): tests/test_attention.py's
# SHAPES (tiny, the Fea2GS decoder's window at 6 heads of 30, rectangular
# with an odd window count and a custom scale), a prime window count above
# the JAX kernel's block of 16 (padded there) without a bias, and HAT's
# window of 16 (256 tokens)
CASES = [(6, 2, 16, 16, 8, True, None), (9, 6, 144, 144, 30, True, None),
         (5, 3, 12, 20, 10, True, 0.37), (17, 2, 9, 25, 8, False, None),
         (2, 2, 256, 256, 16, True, None)]


@pytest.mark.parametrize("b,nh,tq,tk,hd,bias,scale", CASES)
def test_matches_jax_forward_and_vjp(b, nh, tq, tk, hd, bias, scale):
    _assert_pair(*_vjp_pair(b, nh, tq, tk, hd, bias, seed=1, scale=scale),
                 "f32")


# bf16 operands with an f32 bias: the decoder's window, no bias, and
# window 16
BF16_CASES = [(4, 6, 144, 144, 32, True), (7, 2, 16, 16, 8, False),
              (2, 2, 256, 256, 16, True)]


@pytest.mark.parametrize("b,nh,tq,tk,hd,bias", BF16_CASES)
def test_bf16_matches_jax_forward_and_vjp(b, nh, tq, tk, hd, bias):
    """K14 and K14b with bf16 operands round where the port's plain
    versions round (scores, softmax and the backward's products in f32, p
    rounded to bf16 before the PV product, out, dq, dk and dv rounded once
    from f32 sums taken in another order): each bf16 output within one bf16
    step, dbias f32. Both round each p to bf16 from f32 values that differ
    in their last bits, so a p may round to the neighbouring bf16 value
    (one step, 2^-7 p): out moves by at most 2^-7 sum_j p_j |v_j|, which
    exceeds a step of out where the sum cancels."""
    q, k, v, bs, _ = (None if x is None else torch.from_numpy(x).double()
                      for x in _inputs(b, nh, tq, tk, hd, bias, seed=3))
    q, k, v = (x.to(torch.bfloat16).double() for x in (q, k, v))
    terms = ta._probs4(q, k, bs, hd ** -0.5) @ v.abs()
    _assert_pair(*_vjp_pair(b, nh, tq, tk, hd, bias, seed=3, dt="bf16"),
                 "bf16", out_floor=2.0 ** -7 * terms.float())


def test_masked_composition_matches_jax_and_period_raises():
    """With a window mask both packages run the plain composition (the JAX
    einsum composition in float32), the mask of window w taking class w %
    nW; a period that does not divide the window count raises."""
    b, nw, nh, t, hd = 6, 3, 2, 16, 8
    q, k, v, bs, g = _inputs(b, nh, t, t, hd, True, seed=4)
    mask = np.where(np.random.default_rng(5).random((nw, t, t)) < 0.3,
                    -100.0, 0.0).astype(np.float32)
    jout, vjp = jax.vjp(lambda *a: ja.window_attention(
        *a[:4], window_mask=jnp.asarray(mask)),
        *(jnp.asarray(x) for x in (q, k, v, bs)))
    tens = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bs)]
    out = ta.window_attention(*tens, window_mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for tg, jg in zip(tens, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="mask period"):
        ja.window_attention(*(jnp.asarray(x) for x in (q, k, v)),
                            window_mask=jnp.zeros((4, t, t)))
    with pytest.raises(ValueError, match="mask period"):
        ta.window_attention(*tens[:3], window_mask=torch.zeros(4, t, t))


@pytest.mark.parametrize("bias", [True, False])
def test_plain_backward_matches_autograd(bias):
    """The plain backward equals autograd through the plain forward
    (float64, where p's rounding to v's type is the identity)."""
    q, k, v, bs, g = (None if x is None else torch.from_numpy(x).double()
                      for x in _inputs(3, 2, 9, 13, 8, bias, seed=6))
    tens = [x.requires_grad_() for x in (q, k, v)]
    tb = None if bs is None else bs.requires_grad_()
    ta.window_attention_plain(*tens, tb, 0.4).backward(g)
    got = ta.window_attention_bwd_plain(q, k, v, bs, g, 0.4)
    for a, t in zip(got, (*tens, tb)):
        if t is None:
            assert a is None
            continue
        torch.testing.assert_close(a, t.grad, rtol=1e-10, atol=1e-12)


def test_cpu_counts_no_launch_and_bias_keeps_its_type():
    """CPU tensors take the plain versions and count no launch; a float64
    bias is taken in float32 and its gradient returned in float64."""
    q, k, v, bs, g = (None if x is None else torch.from_numpy(x)
                      for x in _inputs(3, 2, 9, 9, 8, True, seed=7))
    counts = lambda: [f.launches for pair in ta._FORMS4.values()  # noqa
                      for f in pair]
    n = counts()
    tb = bs.double().requires_grad_()
    out = ta.window_attention(q, k, v, tb)
    out.backward(g)
    assert torch.equal(out, ta.window_attention_plain(q, k, v, bs, 8 ** -0.5))
    assert tb.grad.dtype == torch.float64
    assert counts() == n


@pytest.mark.parametrize("bf16,long", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_each_4d_form_launches_its_entry_point(monkeypatch, bf16, long):
    """W4 and WB4 (and their bf16 forms, up to 160 tokens and beyond) pass
    their entry point the arguments its C signature declares: the sizes (B,
    Tq, Tk, C = nh hd, nh), the bias, and the backward's scratch (each
    row's statistics only beyond 160 tokens, ds always up to 160 and beyond
    only for dbias); ctypes stands in for the library and CPU tensors for
    CUDA ones (no card here)."""
    from gsasr_torch.ops import _build

    calls = []
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "_libs", {
        n: (lambda *a, _n=n: calls.append((_n, a)) or 0)
        for n in _build.SIGNATURES})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    dt = torch.bfloat16 if bf16 else torch.float32
    b, nh, t, hd = 3, 2, 200 if long else 16, 8
    q = torch.zeros(b, nh, t, hd, dtype=dt)
    for bias in (torch.zeros(nh, t, t), None):
        calls.clear()
        ta._fwd4(q, q, q, bias, 0.5, dt)
        ta._bwd4(q, q, q, bias, q, 0.5, dt)
        assert [n for n, _ in calls] == [ta._FWD4[dt], ta._BWD4[dt]]
        for name, args in calls:
            sig = _build.SIGNATURES[name]
            assert [a for a, k in zip(args, sig) if k == "i"] == \
                [b, t, t, nh * hd, nh], name
            assert args[3] == (None if bias is None else bias.data_ptr())
        _, bargs = calls[1]
        stats, ds, dbias = bargs[8:11]
        assert (stats is not None) == long
        assert (ds is not None) == (not long or bias is not None)
        assert (dbias is not None) == (bias is not None)


def test_4d_kernels_refuse_what_they_do_not_take(monkeypatch):
    """Before any launch: a head width beyond 32, a bias of another shape,
    k and v of other shapes, and g unlike q."""
    from gsasr_torch.ops import _build

    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    q = torch.zeros(2, 2, 16, 8)
    for args in ((torch.zeros(2, 2, 16, 40),) * 3 + (None,),
                 (q, q, q, torch.zeros(2, 16, 15)),
                 (q, torch.zeros(2, 2, 12, 8), q, None)):
        with pytest.raises(ValueError):
            ta._fwd4(*args, 0.5, torch.float32)
    with pytest.raises(ValueError, match="must match"):
        ta._bwd4(q, q, q, None, torch.zeros(2, 2, 15, 8), 0.5,
                 torch.float32)
