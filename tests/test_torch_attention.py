"""gsasr_torch packed window attention against gsasr_tpu on the CPU: the
forward (Pallas K11, or K13 with a window mask, in interpret mode) and
jax.grad through its custom VJP (K12 or K13b in interpret mode) against the
port's autograd Function, which runs the plain versions of kernels W and
WB (WM and WMB with a mask; W-bf16 and WB-bf16 with bfloat16 operands) on
CPU tensors; and the plain backward against torch.autograd of the plain
forward."""

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


# bfloat16 operands (the Enhanced decoder's bf16 module path): a bias and
# Tq != Tk both ways, and no bias (the RoPE attentions)
BF16_CASES = [(7, 16, 16, 12, 3, True), (5, 16, 9, 12, 3, True),
              (3, 9, 25, 8, 2, True), (11, 16, 16, 12, 6, False)]


def _within_a_bf16_step(a, ref):
    """|a - ref| <= one bf16 step of ref + 2^-16 max|ref|. The floor is for
    entries where an f32 sum cancels far below the tensor's scale: its f32
    rounding in another order (2^-24 of the terms) then spans more than one
    step of the small result."""
    a, ref = a.float(), ref.float()
    _, e = torch.frexp(ref)
    step = torch.ldexp(torch.ones_like(ref), e - 8)
    return bool(((a - ref).abs()
                 <= step + 2.0 ** -16 * ref.abs().max()).all())


@pytest.mark.parametrize("b,tq,tk,c,nh,bias", BF16_CASES)
def test_bf16_matches_jax_forward_and_grad(b, tq, tk, c, nh, bias):
    """W-bf16 and WB-bf16's plain versions against K11 and K12 with bf16
    operands in interpret mode, forward and VJP through
    window_attention_packed, with bf16 q, k, v and g and an f32 bias. Both
    round p to bf16 once before the PV product and round out, dq, dk and dv
    once from f32 sums taken in another order, so each bf16 output is equal
    or one bf16 step apart (`_within_a_bf16_step`; all but a few of ~30,000
    here are bit-equal); dbias is f32, summed over the windows in another
    order (1e-5)."""
    q, k, v, bs, g = _inputs(b, tq, tk, c, nh, bias, seed=7)
    jbf = jnp.bfloat16
    args = [jnp.asarray(x).astype(jbf) for x in (q, k, v)]
    args += [jnp.asarray(bs)] if bias else []
    gj = jnp.asarray(g).astype(jbf)

    def jfwd(*a):
        return jattn(*a[:3], a[3] if bias else None, num_heads=nh)

    jout, vjp = jax.vjp(jfwd, *args)
    jgrads = vjp(gj)
    tens = [torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_() for x in args[:3]]
    tens += [torch.from_numpy(bs).requires_grad_()] if bias else []
    out = ta.window_attention_packed(*tens[:3], tens[3] if bias else None,
                                     num_heads=nh)
    out.backward(torch.from_numpy(np.asarray(gj.astype(jnp.float32))).to(
        torch.bfloat16))
    assert out.dtype == torch.bfloat16

    def tbf(x):
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16)

    assert _within_a_bf16_step(out.detach(), tbf(jout))
    for t, jg, name in zip(tens, jgrads, "qkv"):
        assert t.grad.dtype == torch.bfloat16
        assert _within_a_bf16_step(t.grad, tbf(jg)), name
    if bias:
        assert tens[3].grad.dtype == torch.float32
        np.testing.assert_allclose(tens[3].grad.numpy(),
                                   np.asarray(jgrads[3]), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_plain_rounds_where_the_pallas_bodies_round():
    """The plain bf16 forward rounds p to bf16 once and then out (the same
    function in float32 from the same bf16 values, with p rounded by hand,
    is the same bits); the backward does not round p, and only its outputs
    are bf16 (float64 from the same values, rounded once, within a step)."""
    b, tq, tk, c, nh = 5, 16, 9, 12, 3
    q, k, v, bs, g = (None if a is None else torch.from_numpy(a)
                      for a in _inputs(b, tq, tk, c, nh, True, seed=8))
    qb, kb, vb, gb = (x.to(torch.bfloat16) for x in (q, k, v, g))
    out = ta.window_attention_packed_plain(qb, kb, vb, bs, 0.3, nh)
    p = ta._probs(qb.float(), kb.float(), bs, 0.3, nh)
    want = ta._merge(p.to(torch.bfloat16).float()
                     @ ta._heads(vb.float(), nh)).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)
    got = ta.window_attention_packed_bwd_plain(qb, kb, vb, bs, gb, 0.3, nh)
    ref = ta.window_attention_packed_bwd_plain(
        qb.double(), kb.double(), vb.double(), bs.double(), gb.double(), 0.3,
        nh)
    for a, r in zip(got[:3], ref[:3]):
        assert a.dtype == torch.bfloat16
        assert _within_a_bf16_step(a, r.to(torch.bfloat16))
    assert got[3].dtype == torch.float32
    np.testing.assert_allclose(got[3].numpy(), ref[3].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_bf16_forms_raise_where_not_ported():
    """A masked bf16 call no longer raises (WM-bf16 and WMB-bf16 are
    ported): on the CPU it takes the plain version and counts no launch;
    the float32 entry points refuse bf16 operands and the bf16 ones float32
    (the masked ones too), before any launch (meta tensors stand in for
    CUDA ones); CPU tensors never count a launch."""
    x = torch.zeros(6, 4, 6, dtype=torch.bfloat16)
    mask = torch.zeros(3, 4, 4)
    nm = ta.window_attention_packed_masked_bf16_fwd.launches
    out = ta.window_attention_packed(x, x, x, num_heads=2, window_mask=mask)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ta.window_attention_packed(x, x, x, num_heads=2))
    assert ta.window_attention_packed_masked_bf16_fwd.launches == nm
    for dt, fn in ((torch.bfloat16, ta.window_attention_packed_fwd),
                   (torch.float32, ta.window_attention_packed_bf16_fwd)):
        meta = torch.empty(6, 4, 6, device="meta", dtype=dt)
        with pytest.raises(TypeError):
            fn(meta, meta, meta, None, 0.5, 2)
    for dt, fn in ((torch.bfloat16, ta.window_attention_packed_masked_fwd),
                   (torch.float32,
                    ta.window_attention_packed_masked_bf16_fwd)):
        meta = torch.empty(6, 4, 6, device="meta", dtype=dt)
        with pytest.raises(TypeError):
            fn(meta, meta, meta, None, torch.empty(3, 4, 4, device="meta"),
               0.5, 2)
    n = ta.window_attention_packed_bf16_fwd.launches
    m = ta.window_attention_packed_bf16_bwd.launches
    y = ta.window_attention_packed(x.requires_grad_(), x, x, num_heads=2)
    y.sum().backward()
    assert ta.window_attention_packed_bf16_fwd.launches == n
    assert ta.window_attention_packed_bf16_bwd.launches == m


# (masked, bf16, window-16) of each form; the launch arguments of each are
# checked against its entry point's C signature
FORMS = sorted(ta._FORMS)


@pytest.mark.parametrize("masked,bf16,long", FORMS)
def test_each_form_launches_its_entry_point(monkeypatch, masked, bf16, long):
    """Each of the eight forms (W, WM, their bf16 and window-16 forms; WB,
    WMB alike) passes its entry point the arguments its C signature
    declares, the mask right after the bias and its period before the
    scale, with the scratch the entry point takes: ctypes stands in for the
    library and CPU tensors for CUDA ones (no card here)."""
    from gsasr_torch.ops import _build

    calls = []

    def fake(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "_libs", {n: fake(n) for n in
                                          _build.SIGNATURES})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    dt = torch.bfloat16 if bf16 else torch.float32
    t = 200 if long else 16
    b, c, nh, nw = 4, 12, 3, 2
    q = torch.zeros(b, t, c, dtype=dt)
    bias = torch.zeros(nh, t, t)
    mask = torch.zeros(nw, t, t) if masked else None
    ta._fwd(q, q, q, bias, mask, 0.5, nh, dt, long)
    ta._bwd(q, q, q, bias, mask, q, 0.5, nh, dt, long)
    fwd, bwd = (n[dt] for n in (ta._FWD[masked, long], ta._BWD[masked, long]))
    assert [n for n, _ in calls] == [fwd, bwd]
    for name, args in calls:
        sig = _build.SIGNATURES[name]
        ints = [a for a, k in zip(args, sig) if k == "i"]
        assert ints[:5] == [b, t, t, c, nh] and ints[5:] == (
            [nw] if masked else []), name
        assert args[3] == bias.data_ptr(), name
        if masked:
            assert args[4] == mask.data_ptr(), name
    # the backward's scratch after dv: ds (WB's), or each row's statistics
    # and ds (the window-16 forms, ds for dbias's sum)
    _, bargs = calls[1]
    scratch = bargs[8 + masked:9 + masked + long]
    assert all(isinstance(a, int) and a for a in scratch)


# (windows, Tq, Tk, C, heads): HAT's window of 16 (256 tokens) and OCAB's
# 256 queries against 576 keys, narrow, and the bf16 operands of the
# window-16 form at 256 x 256
WINDOW16_CASES = [(2, 256, 256, 16, 2, "f32"), (2, 256, 576, 16, 2, "f32"),
                  (2, 256, 256, 16, 2, "bf16")]


def _window16_vjp(b, tq, tk, c, nh, dt, bias, seed, nw=0):
    """Forward and VJP of window attention beyond W's 160 keys through the
    port (W-long and WB-long's plain versions, or their bf16 forms; with a
    mask of period nw, WM-long and WMB-long's) and through JAX (K11 and K12,
    or K13 and K13b, in interpret mode), from the same inputs: a list of
    (name, port, JAX) pairs of out, dq, dk, dv (in the operand type) and
    dbias (f32) where a bias is given."""
    q, k, v, bs, g = _inputs(b, tq, tk, c, nh, bias, seed=seed)
    mask = _mask(nw, tq, tk, seed=seed + 1) if nw else None
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    ops = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    jops = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ops]
    gt = torch.from_numpy(g).to(tdt)
    if bias:
        ops.append(torch.from_numpy(bs))
        jops.append(jnp.asarray(bs))

    def jfwd(*a):
        return jattn(*a[:3], a[3] if bias else None, num_heads=nh,
                     window_mask=None if mask is None else jnp.asarray(mask))

    jout, vjp = jax.vjp(jfwd, *jops)
    jgrads = vjp(jnp.asarray(gt.float().numpy()).astype(jdt))
    tens = [t.requires_grad_() for t in ops]
    out = ta.window_attention_packed(
        *tens[:3], tens[3] if bias else None, num_heads=nh,
        window_mask=None if mask is None else torch.from_numpy(mask))
    out.backward(gt)
    tj = [torch.from_numpy(np.array(x.astype(jnp.float32))) for x in
          (jout, *jgrads)]
    names = ["out", "dq", "dk", "dv", "dbias"][:len(tj)]
    return [(n, t, r if n == "dbias" else r.to(tdt)) for n, t, r in
            zip(names, [out.detach()] + [x.grad for x in tens], tj)]


def _assert_window16(pairs, dt):
    """float32: 1e-5 (products of depth hd and up to 576 keys summed in
    another order); bf16: each of out, dq, dk, dv rounded once from f32
    sums taken in another order, so equal or one bf16 step apart
    (`_within_a_bf16_step`), and dbias f32 (1e-5)."""
    for name, t, r in pairs:
        if dt == "bf16" and name != "dbias":
            assert t.dtype == torch.bfloat16, name
            assert _within_a_bf16_step(t, r), name
        else:
            assert t.dtype == torch.float32, name
            np.testing.assert_allclose(t.numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,tq,tk,c,nh,dt", WINDOW16_CASES)
def test_window16_matches_jax_and_backward_raises(b, tq, tk, c, nh, dt):
    """Windows beyond W's 160 keys, the window-16 forms of W and WB (W-long
    and WB-long, W-long-bf16 and WB-long-bf16): K11 and K12 in interpret
    mode against the port's plain versions through the autograd Function,
    forward and VJP. The backward no longer raises (WB's window-16 form is
    ported), nor does a masked window of this length
    (`test_window16_mask_raises`)."""
    _assert_window16(_window16_vjp(b, tq, tk, c, nh, dt, False, seed=7), dt)


# (windows, Tq, Tk, C, heads, dtype, bias, mask period): HAT-L's 256 x 256
# and OCAB's 256 x 576 at a narrow C of 6 heads, with and without a bias,
# fp32 and bf16 operands; and the paper HAT's shifted windows, 256 x 256
# with a bias and a mask of period 1 and 2 (WM-long and WMB-long, fp32 and
# bf16)
WINDOW16_VJP_CASES = [(2, 256, 256, 24, 6, "f32", True, 0),
                      (2, 256, 576, 24, 6, "f32", True, 0),
                      (2, 256, 256, 24, 6, "bf16", True, 0),
                      (2, 256, 576, 24, 6, "bf16", True, 0),
                      (2, 256, 576, 24, 6, "bf16", False, 0),
                      (2, 256, 256, 24, 6, "f32", True, 1),
                      (2, 256, 256, 24, 6, "f32", True, 2),
                      (2, 256, 256, 24, 6, "bf16", True, 1),
                      (2, 256, 256, 24, 6, "bf16", True, 2)]


@pytest.mark.parametrize("b,tq,tk,c,nh,dt,bias,nw", WINDOW16_VJP_CASES)
def test_window16_vjp_matches_jax(b, tq, tk, c, nh, dt, bias, nw):
    """WB-long's plain twin (WMB-long's with a mask) against jax.vjp of
    window_attention_packed (K12, or K13b with the mask, in interpret mode)
    at 6 heads, with a bias (dbias f32, summed over the windows) and
    without, in fp32 and bf16."""
    _assert_window16(_window16_vjp(b, tq, tk, c, nh, dt, bias, seed=9,
                                   nw=nw), dt)


def test_window16_mask_raises():
    """A masked window beyond 160 tokens no longer raises (WM-long and
    WMB-long are ported): what still raises does, on the CPU as on the
    card, before any launch: a mask whose period does not divide the window
    count, a mask whose rows are not (Tq, Tk), and (meta tensors standing
    in for CUDA ones) a mask off the card."""
    x = torch.zeros(4, 256, 8)
    n = ta.window_attention_packed_long_masked_fwd.launches
    out = ta.window_attention_packed(x, x, x, num_heads=2,
                                     window_mask=torch.zeros(2, 256, 256))
    assert out.shape == x.shape
    assert ta.window_attention_packed_long_masked_fwd.launches == n
    for mask in (torch.zeros(3, 256, 256), torch.zeros(2, 256, 255)):
        with pytest.raises(ValueError):
            ta.window_attention_packed(x, x, x, num_heads=2,
                                       window_mask=mask)
        with pytest.raises(ValueError):
            ta.window_attention_packed_long_masked_bwd(x, x, x, None, mask,
                                                       x, 0.5, 2)
    meta = torch.empty(4, 256, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ta.window_attention_packed_long_masked_fwd(
            meta, meta, meta, None, torch.empty(2, 256, 256, device="meta"),
            0.5, 2)


# (windows, Tq, Tk, C, heads, bias, mask period) for the order of
# operations of the bf16 tensor-core body up to 160 tokens: ragged 16-row
# and 16-key tiles with a bias, a mask, and no bias with Tk > Tq
SHORT_CASES = [(3, 40, 27, 24, 3, True, 0), (4, 33, 33, 16, 2, True, 2),
               (2, 20, 50, 24, 3, False, 0)]


def _short_forward_tiles(q, k, v, bias, scale, nh, mask=None):
    """W-bf16's tensor-core body (csrc/window_attn_short_mma.cuh) emulated
    in torch, in its order of operations: q, k, v bf16 (exact in f32), rows
    padded with zeros to multiples of 16; each 16-row query tile's scores
    formed per 8-key tile in f32, times the scale, plus the bias, plus the
    mask, -inf past Tk; the whole row's max and sum of exponentials in one
    pass (one exponential per score), p normalized and rounded to bf16
    once, then p v summed over 16-key chunks in f32 and rounded once."""
    b, tq, c = q.shape
    tk = k.shape[1]
    t16 = [-(-t // 16) * 16 for t in (tq, tk)]
    qh, kh, vh = (torch.nn.functional.pad(
        ta._heads(x.float(), nh), (0, 0, 0, t - x.shape[1]))
        for x, t in ((q, t16[0]), (k, t16[1]), (v, t16[1])))
    add = torch.zeros(b, nh, t16[0], t16[1])
    add[..., tk:] = -torch.inf
    if bias is not None:
        add[:, :, :tq, :tk] += bias
    if mask is not None:
        add[:, :, :tq, :tk] += mask.repeat(b // mask.shape[0], 1, 1)[:, None]
    out = torch.zeros(b, nh, t16[0], qh.shape[-1])
    for r0 in range(0, t16[0], 16):
        rows = slice(r0, r0 + 16)
        s = torch.cat([(qh[:, :, rows] @ kh[:, :, j0:j0 + 8].transpose(-1, -2))
                       * scale + add[:, :, rows, j0:j0 + 8]
                       for j0 in range(0, t16[1], 8)], dim=-1)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (e * (1.0 / e.sum(dim=-1, keepdim=True))).to(torch.bfloat16)
        for c0 in range(0, t16[1], 16):
            out[:, :, rows] += p[..., c0:c0 + 16].float() @ vh[:, :, c0:c0 + 16]
    return ta._merge(out[:, :, :tq]).to(torch.bfloat16)


@pytest.mark.parametrize("b,tq,tk,c,nh,bias,nw", SHORT_CASES)
def test_bf16_short_forward_tile_order(b, tq, tk, c, nh, bias, nw):
    """The tensor-core forward's order of operations (16-row and 8-key
    tiles, a one-pass softmax, p rounded once) against the plain version
    and K11 (K13 with a mask) with bf16 operands in interpret mode, within
    the kernels' bf16 tolerance 2^-7 |ref| + 2^-8 max|ref|: the design is
    held to both before it runs on the card."""
    q, k, v, bs, _ = _inputs(b, tq, tk, c, nh, bias, seed=21)
    mask = _mask(nw, tq, tk, seed=22) if nw else None
    scale = (c // nh) ** -0.5
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    bt = None if bs is None else torch.from_numpy(bs)
    mt = None if mask is None else torch.from_numpy(mask)
    emu = _short_forward_tiles(qb, kb, vb, bt, scale, nh, mt).float()
    jout = jattn(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                 None if bs is None else jnp.asarray(bs), num_heads=nh,
                 scale=scale,
                 window_mask=None if mask is None else jnp.asarray(mask))
    for ref in (ta.window_attention_packed_plain(qb, kb, vb, bt, scale, nh,
                                                 mt),
                torch.from_numpy(np.array(jout.astype(jnp.float32)))):
        ref = ref.float()
        tol = 2 ** -7 * ref.abs() + 2 ** -8 * float(ref.abs().max())
        assert bool(((emu - ref).abs() <= tol).all())


# (windows, Tq, Tk, C, heads) for the operand treatment of the bf16
# window-16 backward on the tensor cores: the Ultra step's OCAB 256 x 576 at
# a head width of 32, and the paper HAT's 256 x 256 at 30
HILO_CASES = [(4, 256, 576, 192, 6), (4, 256, 256, 180, 6)]


def _hilo(x):
    """An f32 operand as WB-long-bf16's body feeds it to bf16 products:
    hi = bf16(x), lo = bf16(x - hi), both products summed in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


@pytest.mark.parametrize("b,tq,tk,c,nh", HILO_CASES)
def test_bf16_window16_backward_operand_pairs(b, tq, tk, c, nh):
    """WB-long-bf16's precision design emulated in torch: bf16 q, k, v and g
    (exact in f32), p and ds f32, each fed to the products dv = p^T g, dq =
    ds k, dk = ds^T q as a hi + lo pair of bf16, f32 sums. Before the final
    rounding it stays within 1e-4 of max|ref| of the plain backward in f32
    (one bf16 rounding of p and ds instead does not); rounded to bf16 it is
    within the kernels' bf16 tolerance of the plain bf16 backward."""
    rng = np.random.default_rng(13)
    q, g, k, v = (torch.from_numpy(rng.standard_normal((b, t, c)).astype(
        np.float32)).to(torch.bfloat16) for t in (tq, tq, tk, tk))
    scale = (c // nh) ** -0.5
    qh, kh, vh, gh = (ta._heads(x.float(), nh) for x in (q, k, v, g))
    p = ta._probs4(qh, kh, None, scale)
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))

    def grads(split):
        (ph, pl), (dh, dl) = split(p), split(ds)
        dv = ph.transpose(-1, -2) @ gh + pl.transpose(-1, -2) @ gh
        dq = (dh @ kh + dl @ kh) * scale
        dk = (dh.transpose(-1, -2) @ qh + dl.transpose(-1, -2) @ qh) * scale
        return [ta._merge(x) for x in (dq, dk, dv)]

    wide = ta.window_attention_packed_bwd_plain(
        q.float(), k.float(), v.float(), None, g.float(), scale, nh)
    once = grads(lambda x: (x.to(torch.bfloat16).float(), torch.zeros_like(x)))
    rounded = ta.window_attention_packed_bwd_plain(q, k, v, None, g, scale,
                                                   nh)
    for name, pair, one, w, r in zip(("dq", "dk", "dv"), grads(_hilo), once,
                                     wide, rounded):
        top = float(w.abs().max())
        assert float((pair - w).abs().max()) <= 1e-4 * top, name
        assert float((one - w).abs().max()) > 1e-4 * top, name
        o, r = pair.to(torch.bfloat16).float(), r.float()
        tol = 2 ** -7 * r.abs() + 2 ** -8 * float(r.abs().max())
        assert bool(((o - r).abs() <= tol).all()), name


# (windows, Tq, Tk, C, heads, bias, mask period) for the arithmetic of the
# fp32 window-16 backward on the tensor cores (3xTF32): the fp32 Ultra
# step's 256 x 256 and OCAB's 256 x 576 at a head width of 32, and the
# paper HAT's 256 x 256 at 30 with a bias and a mask of period 2
TF32_CASES = [(2, 256, 256, 192, 6, False, 0), (2, 256, 576, 192, 6, False, 0),
              (2, 256, 256, 180, 6, True, 2)]
# The kernel's contraction slots: k-step j of the scores (and dp) takes
# head columns 8t + 2j in slot t and 8t + 2j + 1 in slot t + 4; an 8-key
# (or 8-query) step takes key 2t in slot t and 2t + 1 in slot t + 4; and
# column n of output tile jn is head column 4n + jn.
_SLOT_COLS = [8 * t + 2 * j + h for j in range(4) for h in (0, 1)
              for t in range(4)]
_SLOT_KEYS = [0, 2, 4, 6, 1, 3, 5, 7]
_OUT_COLS = [4 * n + jn for jn in range(4) for n in range(8)]


def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 rounds it (a 10-bit mantissa,
    to the nearest, ties away from zero), by bit operations on the f32
    word."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _mma_steps(acc, a, b, three):
    """acc + a @ b as the kernel's mma.sync m16n8k8 steps form it: the
    contraction in k-steps of 8 in order, each operand as its pair big =
    tf32(x), small = tf32(x - big), three products a step (small_a big_b,
    big_a small_b, big_a big_b; 3xTF32) into f32 sums; without `three`,
    one product of the rounded operands (1xTF32)."""
    for j in range(0, a.shape[-1], 8):
        x, y = a[..., j:j + 8], b[..., j:j + 8, :]
        xb, yb = _tf32(x), _tf32(y)
        if three:
            acc = acc + _tf32(x - xb) @ yb
            acc = acc + xb @ _tf32(y - yb)
        acc = acc + xb @ yb
    return acc


def _slots(x, dim):
    """x with each group of 8 along `dim` in the kernel's key slot order."""
    idx = torch.tensor([8 * (i // 8) + _SLOT_KEYS[i % 8]
                        for i in range(x.shape[dim])])
    return x.index_select(dim, idx)


def _tf32_window16_bwd(q, k, v, bias, g, scale, nh, mask, three=True):
    """WB-long's (WMB-long's with a mask) arithmetic emulated in torch on
    the packed layout: head columns padded to 32 with zeros; the scores
    and dp in the column slots; launch 1's online sweep over 16-key chunks
    in order, each lane t of a quad holding keys 8n + 2t, + 1 of a chunk
    (the running max, the sum of exponentials and D rescaled when it
    grows, joined across the quad in a butterfly); ds = p (dp - D) and dq
    over 8-key steps in key slot order; launch 2's p^T and ds^T from the
    transposed scores and dp with the stored statistics, dv and dk over
    8-query steps in order; dbias the sum over the windows in order."""
    b, tq, c = q.shape
    tk = k.shape[1]
    hd = c // nh
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        ta._heads(x, nh), (0, 32 - hd))
    qh, kh, vh, gh = (pad(x) for x in (q, k, v, g))
    col = torch.tensor(_SLOT_COLS)
    qs, ks, vs, gs = (x[..., col] for x in (qh, kh, vh, gh))
    zero = torch.zeros(b, nh, tq, tk)

    def fix(s):
        s = s * scale
        if bias is not None:
            s = s + bias
        if mask is not None:
            nw = mask.shape[0]
            s = (s.reshape(-1, nw, nh, tq, tk) + mask[None, :, None]
                 ).reshape(s.shape)
        return s

    # launch 1: the scores and dp, then each lane's online sweep
    s = fix(_mma_steps(zero, qs, ks.transpose(-1, -2), three))
    dp = _mma_steps(zero, gs, vs.transpose(-1, -2), three)
    def lane(x):
        """(..., chunk, lane t, value n e) of 16-key chunks."""
        return x.reshape(b, nh, tq, tk // 16, 2, 4, 2).permute(
            0, 1, 2, 3, 5, 4, 6).reshape(b, nh, tq, tk // 16, 4, 4)

    sl, dl = lane(s), lane(dp)
    mx = torch.full((b, nh, tq, 4), -torch.inf)
    sm, dd = torch.zeros_like(mx), torch.zeros_like(mx)
    for ch in range(tk // 16):
        m = torch.maximum(mx, sl[..., ch, :, :].amax(-1))
        base = torch.where(m == -torch.inf, 0.0, m)
        f = torch.exp(mx - base)
        sm, dd = sm * f, dd * f
        for i in range(4):
            p = torch.exp(sl[..., ch, :, i] - base)
            sm, dd = sm + p, dd + p * dl[..., ch, :, i]
        mx = m
    m = mx.amax(-1, keepdim=True)
    f = torch.where(mx == -torch.inf, 0.0, torch.exp(mx - m))
    ls, ds_ = sm * f, dd * f
    l_ = (ls[..., 0] + ls[..., 1]) + (ls[..., 2] + ls[..., 3])
    inv = 1.0 / l_
    d_ = ((ds_[..., 0] + ds_[..., 1]) + (ds_[..., 2] + ds_[..., 3])) * inv
    m = m[..., 0]
    p = torch.exp(s - m[..., None]) * inv[..., None]
    ds = p * (dp - d_[..., None])
    out = torch.tensor(_OUT_COLS)
    back = torch.argsort(out)
    dq = _mma_steps(torch.zeros(b, nh, tq, 32), _slots(ds, -1),
                    _slots(kh, -2)[..., out], three)[..., back] * scale
    # launch 2: the transposed scores and dp with the stored statistics
    zt = zero.transpose(-1, -2)
    st = fix(_mma_steps(zt, ks, qs.transpose(-1, -2), three).transpose(
        -1, -2)).transpose(-1, -2)
    pt = torch.exp(st - m[..., None, :]) * (1.0 / l_)[..., None, :]
    dpt = _mma_steps(zt, vs, gs.transpose(-1, -2), three)
    dst = pt * (dpt - d_[..., None, :])
    zk = torch.zeros(b, nh, tk, 32)
    dv = _mma_steps(zk, _slots(pt, -1), _slots(gh, -2)[..., out],
                    three)[..., back]
    dk = _mma_steps(zk, _slots(dst, -1), _slots(qh, -2)[..., out],
                    three)[..., back] * scale
    dbias = None
    if bias is not None:
        dbias = ds[0]
        for w in range(1, b):
            dbias = dbias + ds[w]
    return (*(ta._merge(x[..., :hd]) for x in (dq, dk, dv)), dbias)


@pytest.mark.parametrize("b,tq,tk,c,nh,bias,nw", TF32_CASES)
def test_fp32_window16_backward_tf32_arithmetic(b, tq, tk, c, nh, bias, nw):
    """WB-long's and WMB-long's precision design emulated in torch (the
    3xTF32 products in their slot orders, launch 1's online sweep and
    launch 2's transposed recompute): dq, dk, dv and dbias within 1e-4 of
    each tensor's max|ref| of jax.vjp of window_attention_packed (K12, K13b
    with the mask, in interpret mode) and of the plain backward, the card
    tests' budget. Prints each one's distance from a float64 reference,
    and 1xTF32's (each operand rounded once), which is not asserted."""
    q, k, v, bs, g = (None if x is None else torch.from_numpy(x)
                      for x in _inputs(b, tq, tk, c, nh, bias, seed=17))
    mask = torch.from_numpy(_mask(nw, tq, tk, seed=18)) if nw else None
    scale = (c // nh) ** -0.5
    emu = _tf32_window16_bwd(q, k, v, bs, g, scale, nh, mask)
    plain = ta.window_attention_packed_bwd_plain(q, k, v, bs, g, scale, nh,
                                                 mask)
    jops = [jnp.asarray(x.numpy()) for x in (q, k, v)] + (
        [jnp.asarray(bs.numpy())] if bias else [])
    _, vjp = jax.vjp(lambda *a: jattn(
        *a[:3], a[3] if bias else None, num_heads=nh,
        window_mask=None if mask is None else jnp.asarray(mask.numpy())),
        *jops)
    jgrads = [torch.from_numpy(np.array(x)) for x in vjp(
        jnp.asarray(g.numpy()))]
    wide = ta.window_attention_packed_bwd_plain(
        *(x.double() for x in (q, k, v)), None if bs is None else bs.double(),
        g.double(), scale, nh, None if mask is None else mask.double())
    one = _tf32_window16_bwd(q, k, v, bs, g, scale, nh, mask, three=False)
    for i, name in enumerate(("dq", "dk", "dv", "dbias")[:3 + bias]):
        for ref in (jgrads[i], plain[i]):
            top = float(ref.abs().max())
            assert float((emu[i] - ref).abs().max()) <= 1e-4 * top, name
        dist = [float((x[i] - wide[i]).abs().max() / wide[i].abs().max())
                for x in (emu, one, plain)]
        print(f"{name}: 3xTF32 {dist[0]:.2e}, 1xTF32 {dist[1]:.2e}, plain "
              f"fp32 {dist[2]:.2e} of max|float64 ref|")
