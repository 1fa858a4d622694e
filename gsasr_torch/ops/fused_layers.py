"""Fused decoder-layer kernels (counterpart of `gsasr_tpu/ops/fused_layers.py`),
forward and backward.

- `ln_mlp_residual`: out = (0 | resi | x+inj) + fc2(relu(fc1(LN?(x + inj?))))
  -> kernel M (`csrc/ln_mlp.cu`) forward, kernel MB (`csrc/ln_mlp_bwd.cu`)
  backward.
- `ln_attn_proj`: out = proj(MHA(rope?(LN(x) (+pos) -> q; kv | LN(x) -> k,
  v); + bias[h])) -> kernel A (`csrc/ln_attn.cu`) forward, kernel AB
  (`csrc/ln_attn_bwd.cu`) backward; windows of more than 160 tokens (the
  decoders' windows of 16) take A-long and AB-long, the window-16 forms of
  A and AB.

Activations (x, inj, resi, pos, kv and the output) are float32 or
bfloat16; weights, biases, the bias table and the RoPE tables float32. In
bfloat16 the functions round where the Pallas kernels round: the LN output
(+pos), the weights as they are used, the ReLU output, q, k (after the f32
RoPE) and v, the probabilities, the attention output and the result. Every
product takes rounded operands and sums in f32; LN statistics, the softmax
and RoPE are f32; eps is 1e-5.

Every form is differentiable in every tensor argument, the RoPE tables
included: an autograd Function saves only the inputs, and the backward
kernel recomputes the forward, as the JAX package's custom VJPs do. The
backward rounds where the Pallas backward bodies round; weight, bias, LN,
bias-table and RoPE-table gradients come back in float32, dx, dinj, dpos
and dkv in the activation type. Weights are in nn.Linear layout, (out,
in). CPU tensors take the plain PyTorch version beside each wrapper; CUDA
tensors launch the kernel.
"""

from __future__ import annotations

import torch

from gsasr_torch.ops import _build
from gsasr_torch.ops.attention import _heads, _merge

_EPS = 1e-5
# Kernel A's limits: kMaxT and kMaxHd of csrc/window_attn.cuh (longer
# windows take A-long and AB-long; the attention bodies hold head widths up
# to 32) and kMaxN = 32 kLnPer of csrc/tile_gemm.cuh (the width of the row
# tile products and LN rows).
_A_MAX_T = 160
_A_MAX_HD = 32
_A_MAX_C = 192
# kMaxGroups of csrc/tile_mma_bwd.cuh: the weight-gradient row groups
_MAX_GROUPS = 128
# kRopeGroups of csrc/ln_attn_bwd.cu: the RoPE-table gradient's groups of
# windows
_ROPE_GROUPS = 32
# row tile of csrc/tile_mma.cuh (kTRows)
_ROW_TILE = 128


def _ln_stats(t):
    """LN forward pieces for the recompute: (y, inv_sigma)."""
    mu = t.mean(dim=-1, keepdim=True)
    var = (t - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + _EPS)
    return (t - mu) * inv, inv


def _ln(x, w, b):
    y, _ = _ln_stats(x)
    return y * w + b


def _ln_bwd(dh, y, inv, gamma):
    """d(LN input) from d(LN output): (dt, d gamma, d beta), the gamma and
    beta gradients summed over all rows."""
    dyh = dh * gamma
    dt = inv * (dyh - dyh.mean(dim=-1, keepdim=True)
                - y * (dyh * y).mean(dim=-1, keepdim=True))
    return dt, (dh * y).flatten(0, -2).sum(0), dh.flatten(0, -2).sum(0)


def _wgrad(d, x):
    """(out, in) weight gradient d^T x over all rows."""
    return d.flatten(0, -2).t() @ x.flatten(0, -2)


def _piece(n: int, size: int = 4) -> int:
    """Floats of a scratch piece of n values of `size` bytes: the kernels
    carve their scratch in 16-byte pieces (Carve, csrc/tile_mma_bwd.cuh)."""
    return -(-n * size // 16) * 4


def _work(floats: int, like: torch.Tensor) -> torch.Tensor:
    if floats >= 2 ** 31:
        raise ValueError(f"{floats} floats of scratch exceed the kernels' "
                         "int sizes")
    return torch.empty(floats, dtype=torch.float32, device=like.device)


def _rnd(t, dtype):
    """t (f32) rounded to the activation type and held in f32: the cast a
    Pallas kernel makes before a product or a store."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def rope_shuffle(x):
    """(even, odd) -> (-odd, even) over each lane pair of the last axis."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def rope_rotate(x, cos, sin):
    """Pair rotation of packed (..., T, C) operands by pair-duplicated (T, C)
    tables, in f32."""
    return x * cos + rope_shuffle(x) * sin


def ln_mlp_residual_plain(x, *, w1, b1, w2, b2, ln_w=None, ln_b=None,
                          inj=None, resi=None, zero_base: bool = False):
    """Plain PyTorch version of kernel M."""
    dt = x.dtype
    t = x.float()
    if inj is not None:
        t = t + inj.float()[:, None, :]
    h = _rnd(_ln(t, ln_w, ln_b) if ln_w is not None else t, dt)
    z = _rnd(torch.relu(h @ _rnd(w1, dt).t() + b1), dt)
    z = z @ _rnd(w2, dt).t() + b2
    if zero_base:
        return z.to(dt)
    return ((resi.float() if resi is not None else t) + z).to(dt)


def ln_mlp_residual_bwd_plain(x, g, *, w1, b1, w2, b2, ln_w=None,
                              ln_b=None, inj=None, resi=None,
                              zero_base: bool = False):
    """Plain PyTorch version of kernel MB: the VJP of ln_mlp_residual at
    cotangent g, forward recomputed. Returns what `_ln_mlp_core_bwd`
    returns, (dx, dresi, dinj, dln_w, dln_b, dw1, db1, dw2, db2), with None
    for an option not given. In bfloat16 it rounds where `_k_ln_mlp_bwd`
    rounds: h, the ReLU output, g and dz1 as product operands, the weights
    as they are used, and dx and dinj as they are stored; the bias sums
    take the unrounded g and dz1."""
    dt = x.dtype
    t = x.float()
    if inj is not None:
        t = t + inj.float()[:, None, :]
    if ln_w is not None:
        y, inv = _ln_stats(t)
        h = y * ln_w + ln_b
    else:
        h = t
    h = _rnd(h, dt)
    w1r, w2r = _rnd(w1, dt), _rnd(w2, dt)
    z1p = h @ w1r.t() + b1
    z1 = _rnd(torch.relu(z1p), dt)
    gf = g.float()
    dw2, db2 = _wgrad(gf, z1), gf.flatten(0, -2).sum(0)
    dz1 = (gf @ w2r) * (z1p > 0)
    dz1d = _rnd(dz1, dt)
    dw1, db1 = _wgrad(dz1d, h), dz1.flatten(0, -2).sum(0)
    dh = dz1d @ w1r
    dlnw = dlnb = None
    if ln_w is not None:
        dh, dlnw, dlnb = _ln_bwd(dh, y, inv, ln_w)
    if resi is None and not zero_base:
        dh = dh + gf
    return (dh.to(dt), g if resi is not None and not zero_base else None,
            dh.sum(dim=1).to(dt) if inj is not None else None, dlnw, dlnb,
            dw1, db1, dw2, db2)


def _check_mlp(x, w1, w2, ln_w, ln_b, inj, resi):
    b, t, c = x.shape
    hid = w1.shape[0]
    if (w1.shape != (hid, c) or w2.shape != (c, hid)
            or (inj is not None and inj.shape != (b, c))
            or (resi is not None and resi.shape != x.shape)
            or (ln_w is None) != (ln_b is None)):
        raise ValueError("ln_mlp_residual: inconsistent shapes or options")


# activation types the kernels store; weights, biases and tables are f32
_ACT_TYPES = (torch.float32, torch.bfloat16)


def _contig(act=(), **kw):
    """The tensors given, checked for the kernels and made contiguous: those
    named in `act` in the activation type of x (kw["x"]), the rest f32."""
    dt = kw["x"].dtype
    if dt not in _ACT_TYPES:
        raise TypeError(f"x: expected one of {_ACT_TYPES}, got {dt}")
    for name, t in kw.items():
        if t is not None:
            _build.check_tensor(t, name,
                                dt if name == "x" or name in act
                                else torch.float32)
    return {k: (v.contiguous() if v is not None else None)
            for k, v in kw.items()}


def _ln_mlp_fwd(x, *, w1, b1, w2, b2, ln_w, ln_b, inj, resi, zero_base):
    """Kernel M on CUDA tensors, its plain version on CPU tensors."""
    kw = dict(w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
              resi=resi)
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, zero_base=zero_base, **kw)
    _check_mlp(x, w1, w2, ln_w, ln_b, inj, resi)
    # the kernel reads inj in f32: a bf16 inj converts exactly, and an f32
    # one next to bf16 rows stays unrounded, as in the Pallas kernel
    if inj is not None:
        kw["inj"] = inj.float()
    a = _contig(act=("resi",), x=x, **kw)
    b, t, c = x.shape
    out = torch.empty_like(a["x"])
    _build.launch("ln_mlp", a["x"], a["inj"], a["resi"], a["ln_w"],
                  a["ln_b"], a["w1"], a["b1"], a["w2"], a["b2"], out, b * t, t,
                  c, w1.shape[0], int(zero_base),
                  int(x.dtype == torch.bfloat16))
    ln_mlp_residual.launches += 1
    return out


def ln_mlp_residual_bwd(x, g, *, w1, b1, w2, b2, ln_w=None, ln_b=None,
                        inj=None, resi=None, zero_base: bool = False):
    """Kernel MB on CUDA tensors, its plain version on CPU tensors: the VJP
    of ln_mlp_residual at cotangent g (B, T, C, x's type), returned as
    `ln_mlp_residual_bwd_plain` returns it."""
    kw = dict(w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
              resi=resi)
    if x.device.type == "cpu":
        return ln_mlp_residual_bwd_plain(x, g, zero_base=zero_base, **kw)
    _check_mlp(x, w1, w2, ln_w, ln_b, inj, resi)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    a = _contig(act=("g",), x=x, g=g, w1=w1, b1=b1, w2=w2, ln_w=ln_w,
                ln_b=ln_b, inj=inj.float() if inj is not None else None)
    b, t, c = x.shape
    hid = w1.shape[0]
    m = b * t
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(a["x"])
    dinj = (torch.empty((b, c), dtype=x.dtype, device=x.device)
            if inj is not None else None)
    dln = torch.empty((2, c), **f32) if ln_w is not None else None
    dw1, db1 = torch.empty((hid, c), **f32), torch.empty(hid, **f32)
    dw2, db2 = torch.empty((c, hid), **f32), torch.empty(c, **f32)
    # the transposed w1 and w2; h and z1 (x's type), dz1 (f32); the two
    # weight gradients' partials; the LN partials; with inj the partial
    # window sums of each row tile; the norms of w1's rows; the signs of
    # z1p, 1024 words a row tile (ln_mlp_bwd_impl)
    act = x.element_size()
    tiles = -(-m // _ROW_TILE)
    slots = (_ROW_TILE - 1 + t - 1) // t + 1
    floats = (2 * _piece(c * hid) + _piece(m * c, act) + _piece(m * hid, act)
              + _piece(m * hid) + _piece(_MAX_GROUPS * hid * (c + 1))
              + _piece(_MAX_GROUPS * c * (hid + 1)) + _piece(tiles * 2 * c)
              + (_piece(tiles * slots * c) if inj is not None else 0)
              + _piece(hid) + _piece(tiles * 1024))
    work = _work(floats, x)
    _build.launch("ln_mlp_bwd_bf16" if bf16 else "ln_mlp_bwd", a["x"],
                  a["inj"], a["ln_w"], a["ln_b"], a["w1"], a["b1"], a["w2"],
                  a["g"], dx, dinj, dln, dw1, db1, dw2, db2, work, floats, m,
                  t, c, hid, int(resi is None and not zero_base))
    ln_mlp_residual_bwd.launches += 1
    return (dx, g if resi is not None and not zero_base else None, dinj,
            dln[0] if dln is not None else None,
            dln[1] if dln is not None else None, dw1, db1, dw2, db2)


ln_mlp_residual_bwd.launches = 0


class _LnMlp(torch.autograd.Function):
    """Forward M, backward MB (the custom VJP `_ln_mlp_core` of the JAX
    package): saves the inputs only."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_w, ln_b, inj, resi, zero_base):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_w, ln_b, inj, resi)
        ctx.zero_base = zero_base
        return _ln_mlp_fwd(x, w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w,
                           ln_b=ln_b, inj=inj, resi=resi, zero_base=zero_base)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, ln_w, ln_b, inj, resi = ctx.saved_tensors
        dx, dresi, dinj, dlnw, dlnb, dw1, db1, dw2, db2 = ln_mlp_residual_bwd(
            x, g, w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
            resi=resi, zero_base=ctx.zero_base)
        return dx, dw1, db1, dw2, db2, dlnw, dlnb, dinj, dresi, None


def ln_mlp_residual(x, *, w1, b1, w2, b2, ln_w=None, ln_b=None, inj=None,
                    resi=None, zero_base: bool = False):
    """out = (0 | resi | x+inj) + fc2(relu(fc1(LN?(x + inj?)))).

    x, resi: (B, T, C) float32 or bfloat16, resi in x's type; inj: (B, C)
    broadcast over T, either type (summed in f32, unrounded); w1 (hid, C),
    w2 (C, hid) float32. zero_base=True returns the bare MLP output (the
    Enhanced block tails). Differentiable in every tensor argument (kernel
    MB on the card)."""
    return _LnMlp.apply(x, w1, b1, w2, b2, ln_w, ln_b, inj, resi, zero_base)


ln_mlp_residual.launches = 0


def ln_attn_proj_plain(x, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                       num_heads: int, bias=None, pos=None, kv=None,
                       scale=None, rope_cos_q=None, rope_sin_q=None,
                       rope_cos_k=None, rope_sin_k=None):
    """Plain PyTorch version of kernel A."""
    dt = x.dtype
    b, tq, c = x.shape
    hd = c // num_heads
    if scale is None:
        scale = hd ** -0.5
    xq = _ln(x.float(), ln_w, ln_b)
    if pos is not None:
        xq = xq + _rnd(pos.float(), dt)
    xq = _rnd(xq, dt)
    src = kv.float() if kv is not None else xq
    tk = src.shape[1]
    q = xq @ _rnd(wq, dt).t() + bq
    k = src @ _rnd(wk, dt).t() + bk
    v = src @ _rnd(wv, dt).t() + bv
    if rope_cos_q is not None:
        q = rope_rotate(q, rope_cos_q, rope_sin_q)
        k = rope_rotate(k, rope_cos_k, rope_sin_k)
    q, k, v = (_rnd(t, dt).reshape(b, -1, num_heads, hd).transpose(1, 2)
               for t in (q, k, v))
    s = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = _rnd(e / e.sum(dim=-1, keepdim=True), dt)
    att = _rnd((p @ v).transpose(1, 2).reshape(b, tq, c), dt)
    return (att @ _rnd(wo, dt).t() + bo).to(dt)


def ln_attn_proj_bwd_plain(x, g, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w,
                           ln_b, num_heads: int, bias=None, pos=None, kv=None,
                           scale=None, rope_cos_q=None, rope_sin_q=None,
                           rope_cos_k=None, rope_sin_k=None):
    """Plain PyTorch version of kernel AB: the VJP of ln_attn_proj at
    cotangent g, forward recomputed. Returns what `_ln_attn_core_bwd`
    returns, (dx, dpos, dkv, dln_w, dln_b, dwq, dbq, dwk, dbk, dwv, dbv,
    dwo, dbo, dbias, drope_cos_q, drope_sin_q, drope_cos_k, drope_sin_k),
    with None for an option not given. With RoPE, dq and dk are rotated
    back by (cos, -sin) (the pair-duplicated tables make the rotation's
    transpose a rotation) and the table gradients are sum_windows dq q0 and
    dq shuffle(q0) (and for k), from the f32 dq and the unrounded q0. In
    bfloat16 it rounds where `_k_ln_attn_bwd` rounds: xq, q, k, v, the
    probabilities and the attention output as in the forward, g, the
    per-head slices of g wo^T, ds, the back-rotated dq, dk and dv as
    product operands, the weights as they are used, and dx, dpos and dkv as
    they are stored; the bias sums take the unrounded values."""
    dt = x.dtype
    c = x.shape[-1]
    nh = num_heads
    if scale is None:
        scale = (c // nh) ** -0.5
    wq_, wk_, wv_, wo_ = (_rnd(w, dt) for w in (wq, wk, wv, wo))
    y, inv = _ln_stats(x.float())
    xq = y * ln_w + ln_b
    if pos is not None:
        xq = xq + _rnd(pos.float(), dt)
    xq = _rnd(xq, dt)
    src = kv.float() if kv is not None else xq
    q0, k0, v = xq @ wq_.t() + bq, src @ wk_.t() + bk, src @ wv_.t() + bv
    rope = rope_cos_q is not None
    if rope:
        q, k = (rope_rotate(q0, rope_cos_q, rope_sin_q),
                rope_rotate(k0, rope_cos_k, rope_sin_k))
    else:
        q, k = q0, k0
    qd, kd, vd = (_heads(_rnd(t, dt), nh) for t in (q, k, v))
    s = (qd @ kd.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    pd = _rnd(p, dt)
    att = _rnd(_merge(pd @ vd), dt)
    gf = g.float()
    dwo, dbo = _wgrad(gf, att), gf.flatten(0, -2).sum(0)
    gh = _heads(_rnd(gf @ wo_, dt), nh)
    dv = _merge(pd.transpose(-1, -2) @ gh)
    dp = gh @ vd.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsd = _rnd(ds, dt)
    dq = _merge(dsd @ kd) * scale
    dk = _merge(dsd.transpose(-1, -2) @ qd) * scale
    tables = (None,) * 4
    if rope:
        tables = ((dq * q0).sum(0), (dq * rope_shuffle(q0)).sum(0),
                  (dk * k0).sum(0), (dk * rope_shuffle(k0)).sum(0))
        dq = rope_rotate(dq, rope_cos_q, -rope_sin_q)
        dk = rope_rotate(dk, rope_cos_k, -rope_sin_k)
    dqd, dkd, dvd = _rnd(dq, dt), _rnd(dk, dt), _rnd(dv, dt)
    dxq = dqd @ wq_
    dsrc = dkd @ wk_ + dvd @ wv_
    if kv is None:
        dxq = dxq + dsrc
    dx, dlnw, dlnb = _ln_bwd(dxq, y, inv, ln_w)
    return (dx.to(dt), dxq.sum(dim=0).to(dt) if pos is not None else None,
            dsrc.to(dt) if kv is not None else None, dlnw, dlnb,
            _wgrad(dqd, xq), dq.flatten(0, -2).sum(0),
            _wgrad(dkd, src), dk.flatten(0, -2).sum(0),
            _wgrad(dvd, src), dv.flatten(0, -2).sum(0), dwo, dbo,
            ds.sum(dim=0) if bias is not None else None, *tables)


_ROPE = ("rope_cos_q", "rope_sin_q", "rope_cos_k", "rope_sin_k")


def _check_attn(x, num_heads, ws, bias, pos, kv, rope=(None,) * 4):
    b, tq, c = x.shape
    tk = kv.shape[1] if kv is not None else tq
    if (any(w.shape != (c, c) for w in ws)
            or (kv is not None and kv.shape != (b, tk, c))
            or (pos is not None and pos.shape != (tq, c))
            or (bias is not None and bias.shape != (num_heads, tq, tk))
            or len({r is None for r in rope}) != 1
            or (rope[0] is not None
                and [r.shape for r in rope] != [(tq, c)] * 2 + [(tk, c)] * 2)):
        raise ValueError("ln_attn_proj: inconsistent shapes")
    return b, tq, tk, c


def _a_long(x, kv) -> bool:
    """Windows too long for A and AB: A-long's and AB-long's."""
    return max(x.shape[1], kv.shape[1] if kv is not None else 0) > _A_MAX_T


def _check_attn_kernel(x, num_heads, rope: bool):
    """Raise on what kernels A and A-long refuse: head widths above 32 or
    channels above 192, and an odd head width with RoPE or bfloat16 (a
    rotated pair must not straddle two heads)."""
    c = x.shape[-1]
    hd = c // num_heads
    if (c % num_heads or hd > _A_MAX_HD or c > _A_MAX_C
            or ((rope or x.dtype == torch.bfloat16) and hd % 2)):
        raise ValueError(
            f"ln_attn_proj: {c} channels in {num_heads} heads; kernel A "
            f"takes C <= {_A_MAX_C}, head width <= {_A_MAX_HD}, and an even "
            "head width with RoPE or bfloat16")


def _ln_attn_args(x, num_heads, kw):
    """Checked, contiguous kernel arguments of A, A-long and AB: (b, tq, tk,
    c, the tensors by name)."""
    b, tq, tk, c = _check_attn(x, num_heads, (kw["wq"], kw["wk"], kw["wv"],
                                              kw["wo"]),
                               kw["bias"], kw["pos"], kw["kv"],
                               [kw[r] for r in _ROPE])
    _check_attn_kernel(x, num_heads, kw["rope_cos_q"] is not None)
    # pos is rounded to the activation type, as the Pallas wrapper casts it
    if kw["pos"] is not None:
        kw = dict(kw, pos=kw["pos"].to(x.dtype))
    return b, tq, tk, c, _contig(act=("pos", "kv", "g"), x=x, **kw)


def _ln_attn_launch(name, x, num_heads, scale, kw):
    """A's or A-long's launch on CUDA tensors, with its scratch: q, k, v
    after RoPE and the heads' output att, in the activation type."""
    b, tq, tk, c, a = _ln_attn_args(x, num_heads, kw)
    qs = torch.empty_like(a["x"])
    ks = torch.empty((b, tk, c), dtype=x.dtype, device=x.device)
    vs = torch.empty_like(ks)
    att = torch.empty_like(qs)
    out = torch.empty_like(qs)
    _build.launch(name, a["x"], a["pos"], a["kv"], a["ln_w"], a["ln_b"],
                  a["wq"], a["bq"], a["wk"], a["bk"], a["wv"], a["bv"],
                  a["wo"], a["bo"], a["bias"], *(a[r] for r in _ROPE), qs,
                  ks, vs, att, out, b, tq, tk, c, num_heads,
                  int(x.dtype == torch.bfloat16), float(scale))
    return out


def ln_attn_proj_long(x, *, num_heads, scale=None, **kw):
    """The forward of `ln_attn_proj` for windows of any length: kernel
    A-long on CUDA tensors, the plain version on CPU tensors. `kw`: the
    tensor arguments of `ln_attn_proj` by name."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    kw = {**dict.fromkeys(("bias", "pos", "kv") + _ROPE), **kw}
    if x.device.type == "cpu":
        return ln_attn_proj_plain(x, num_heads=num_heads, scale=scale, **kw)
    out = _ln_attn_launch("ln_attn_long", x, num_heads, scale, kw)
    ln_attn_proj_long.launches += 1
    return out


ln_attn_proj_long.launches = 0


def _ln_attn_fwd(x, *, num_heads, scale, **kw):
    """Kernel A (A-long for windows of more than 160 tokens) on CUDA
    tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ln_attn_proj_plain(x, num_heads=num_heads, scale=scale, **kw)
    if _a_long(x, kw["kv"]):
        return ln_attn_proj_long(x, num_heads=num_heads, scale=scale, **kw)
    out = _ln_attn_launch("ln_attn", x, num_heads, scale, kw)
    ln_attn_proj.launches += 1
    return out


def ln_attn_proj_bwd(x, g, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                     num_heads: int, bias=None, pos=None, kv=None,
                     scale=None, rope_cos_q=None, rope_sin_q=None,
                     rope_cos_k=None, rope_sin_k=None):
    """Kernel AB (AB-long for windows of more than 160 tokens) on CUDA
    tensors, its plain version on CPU tensors: the VJP of ln_attn_proj at
    cotangent g (B, Tq, C, x's type), returned as `ln_attn_proj_bwd_plain`
    returns it."""
    kw = dict(wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv, wo=wo, bo=bo,
              ln_w=ln_w, ln_b=ln_b, bias=bias, pos=pos, kv=kv,
              rope_cos_q=rope_cos_q, rope_sin_q=rope_sin_q,
              rope_cos_k=rope_cos_k, rope_sin_k=rope_sin_k)
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    if x.device.type == "cpu":
        return ln_attn_proj_bwd_plain(x, g, num_heads=num_heads, scale=scale,
                                      **kw)
    if _a_long(x, kv):
        return ln_attn_proj_bwd_long(x, g, num_heads=num_heads, scale=scale,
                                     **kw)
    out = _ln_attn_bwd_launch(x, g, num_heads, scale, kw, long=False)
    ln_attn_proj_bwd.launches += 1
    return out


ln_attn_proj_bwd.launches = 0


def ln_attn_proj_bwd_long(x, g, *, num_heads, scale=None, **kw):
    """The backward of `ln_attn_proj` for windows of any length: kernel
    AB-long on CUDA tensors, the plain version on CPU tensors, returned as
    `ln_attn_proj_bwd_plain` returns it. `kw`: the tensor arguments of
    `ln_attn_proj` by name."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    kw = {**dict.fromkeys(("bias", "pos", "kv") + _ROPE), **kw}
    if x.device.type == "cpu":
        return ln_attn_proj_bwd_plain(x, g, num_heads=num_heads, scale=scale,
                                      **kw)
    out = _ln_attn_bwd_launch(x, g, num_heads, scale, kw, long=True)
    ln_attn_proj_bwd_long.launches += 1
    return out


ln_attn_proj_bwd_long.launches = 0


def _ln_attn_bwd_launch(x, g, num_heads, scale, kw, long: bool):
    """AB's or AB-long's launch on CUDA tensors, with its outputs and
    scratch."""
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    b, tq, tk, c, a = _ln_attn_args(x, num_heads, dict(kw, g=g))
    bf16 = x.dtype == torch.bfloat16
    rope = kw["rope_cos_q"] is not None
    has_bias = kw["bias"] is not None
    f32 = dict(dtype=torch.float32, device=x.device)
    act = dict(dtype=x.dtype, device=x.device)
    dx = torch.empty((b, tq, c), **act)
    dkv = torch.empty((b, tk, c), **act) if kw["kv"] is not None else None
    dpos = torch.empty((tq, c), **act) if kw["pos"] is not None else None
    dln = torch.empty((2, c), **f32)
    dws = [torch.empty(s, **f32) for _ in range(4) for s in ((c, c), (c,))]
    dbias = torch.empty((num_heads, tq, tk), **f32) if has_bias else None
    drope = ([torch.empty((n, c), **f32) for n in (tq, tq, tk, tk)] if rope
             else [None] * 4)
    mq, mk = b * tq, b * tk
    act = x.element_size()
    # the four transposed weights; q, xq, att, datt, k, v (x's type); dq, dk,
    # dv (f32); with RoPE q0 and k0 (dq0 and dk0 in place); the rows'
    # softmax statistics; with a bias the per-window ds; the four weight
    # gradients' partials; the LN partials; with RoPE the table partials of
    # up to 32 groups of windows; with pos dxq (ln_attn_bwd_impl)
    floats = (4 * _piece(c * c) + 4 * _piece(mq * c, act)
              + 2 * _piece(mk * c, act) + _piece(mq * c) + 2 * _piece(mk * c)
              + (_piece(mq * c) + _piece(mk * c)) * rope
              + _piece(b * num_heads * tq * 3)
              + _piece(b * num_heads * tq * tk) * has_bias
              + _piece(4 * _MAX_GROUPS * c * (c + 1))
              + _piece(-(-mq // _ROW_TILE) * 2 * c)
              + _piece(2 * _ROPE_GROUPS * (tq + tk) * c) * rope
              + _piece(mq * c) * (kw["pos"] is not None))
    work = _work(floats, x)
    name = "ln_attn_bwd" + "_long" * long + "_bf16" * bf16
    _build.launch(name, a["x"], a["pos"], a["kv"], a["ln_w"], a["ln_b"],
                  a["wq"], a["bq"], a["wk"], a["bk"], a["wv"], a["bv"],
                  a["wo"], a["bias"], *(a[r] for r in _ROPE), a["g"], dx,
                  dkv, dpos, dln, *dws, dbias, *drope, work, floats, b, tq,
                  tk, c, num_heads, float(scale))
    return (dx, dpos, dkv, dln[0], dln[1], *dws, dbias, *drope)


class _LnAttn(torch.autograd.Function):
    """Forward A, backward AB (A-long and AB-long for windows of more than
    160 tokens; the custom VJP `_ln_attn_core` of the JAX package): saves
    the inputs only."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias,
                pos, kv, cos_q, sin_q, cos_k, sin_k, num_heads, scale):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                              bias, pos, kv, cos_q, sin_q, cos_k, sin_k)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _ln_attn_fwd(x, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
                            wo=wo, bo=bo, ln_w=ln_w, ln_b=ln_b, bias=bias,
                            pos=pos, kv=kv, rope_cos_q=cos_q,
                            rope_sin_q=sin_q, rope_cos_k=cos_k,
                            rope_sin_k=sin_k, num_heads=num_heads,
                            scale=scale)

    @staticmethod
    def backward(ctx, g):
        (x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias, pos, kv, cos_q,
         sin_q, cos_k, sin_k) = ctx.saved_tensors
        (dx, dpos, dkv, dlnw, dlnb, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo,
         dbias, dcq, dsq, dck, dsk) = ln_attn_proj_bwd(
            x, g, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv, wo=wo, bo=bo,
            ln_w=ln_w, ln_b=ln_b, num_heads=ctx.num_heads, bias=bias,
            pos=pos, kv=kv, scale=ctx.scale, rope_cos_q=cos_q,
            rope_sin_q=sin_q, rope_cos_k=cos_k, rope_sin_k=sin_k)
        return (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dlnw, dlnb, dbias,
                dpos, dkv, dcq, dsq, dck, dsk, None, None)


def ln_attn_proj(x, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                 num_heads: int, bias=None, pos=None, kv=None, scale=None,
                 rope_cos_q=None, rope_sin_q=None, rope_cos_k=None,
                 rope_sin_k=None):
    """out = proj(MHA(rope?(LN(x) (+pos)), kv | self, +bias)); residual
    outside.

    x: (B, Tq, C) float32 or bfloat16; kv: (B, Tk, C) un-normed
    cross-attention source in x's type, or None for self-attention; pos:
    (Tq, C) added after the LN, rounded to x's type; bias: (num_heads, Tq,
    Tk) float32; rope_{cos,sin}_q (Tq, C) and rope_{cos,sin}_k (Tk, C):
    pair-duplicated float32 rotation tables applied to the projected q and k
    in f32 (the Enhanced family), all four or none. Differentiable in every
    tensor argument, the tables included (kernel AB on the card, AB-long
    for windows of more than 160 tokens)."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    return _LnAttn.apply(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias,
                         pos, kv, rope_cos_q, rope_sin_q, rope_cos_k,
                         rope_sin_k, num_heads, float(scale))


ln_attn_proj.launches = 0
