"""Fused decoder-layer kernels (counterpart of `gsasr_tpu/ops/fused_layers.py`),
forward and backward.

- `ln_mlp_residual`: out = (0 | resi | x+inj) + fc2(relu(fc1(LN?(x + inj?))))
  -> kernel M (`csrc/ln_mlp.cu`) forward, kernel MB (`csrc/ln_mlp_bwd.cu`)
  backward.
- `ln_attn_proj`: out = proj(MHA(rope?(LN(x) (+pos) -> q; kv | LN(x) -> k,
  v); + bias[h])) -> kernel A (`csrc/ln_attn.cu`) forward, kernel AB
  (`csrc/ln_attn_bwd.cu`) backward; windows of more than 160 tokens (the
  decoders' windows of 16) take A-long, the window-16 form of A, forward
  only.

Activations (x, inj, resi, pos, kv and the output) are float32 or
bfloat16; weights, biases, the bias table and the RoPE tables float32. In
bfloat16 the functions round where the Pallas kernels round: the LN output
(+pos), the weights as they are used, the ReLU output, q, k (after the f32
RoPE) and v, the probabilities, the attention output and the result. Every
product takes rounded operands and sums in f32; LN statistics, the softmax
and RoPE are f32; eps is 1e-5.

The float32 forms without RoPE or zero_base are differentiable in every
tensor argument: an autograd Function saves only the inputs, and the
backward kernel recomputes the forward, as the JAX package's custom VJPs
do. The backward of the bfloat16, RoPE and zero_base forms is not ported
and raises. Weights are in nn.Linear layout, (out, in). CPU tensors take
the plain PyTorch version beside each wrapper; CUDA tensors launch the
kernel.
"""

from __future__ import annotations

import torch

from gsasr_torch.ops import _build
from gsasr_torch.ops.attention import (_heads, _merge, _probs,
                                       window_attention_packed_bwd_plain)

_EPS = 1e-5
# Kernel A's limits: kMaxT and kMaxHd of csrc/ln_attn.cu (longer windows
# take A-long; a lane holds one head column) and kMaxN = 32 kLnPer of
# csrc/tile_gemm.cuh (the width of the row tile products and LN rows).
_A_MAX_T = 160
_A_MAX_HD = 32
_A_MAX_C = 192
# kMaxGroups of csrc/fused_bwd.cuh: the weight-gradient row groups
_MAX_GROUPS = 128
# row tile of csrc/tile_gemm.cuh (kBM)
_ROW_TILE = 64


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
                              ln_b=None, inj=None, resi=None):
    """Plain PyTorch version of kernel MB: the VJP of ln_mlp_residual at
    cotangent g, forward recomputed. Returns what `_ln_mlp_core_bwd`
    returns, (dx, dresi, dinj, dln_w, dln_b, dw1, db1, dw2, db2), with None
    for an option not given."""
    t = x + inj[:, None, :] if inj is not None else x
    if ln_w is not None:
        y, inv = _ln_stats(t)
        h = y * ln_w + ln_b
    else:
        h = t
    z1p = h @ w1.t() + b1
    z1 = torch.relu(z1p)
    dw2, db2 = _wgrad(g, z1), g.flatten(0, -2).sum(0)
    dz1 = (g @ w2) * (z1p > 0)
    dw1, db1 = _wgrad(dz1, h), dz1.flatten(0, -2).sum(0)
    dt = dz1 @ w1
    dlnw = dlnb = None
    if ln_w is not None:
        dt, dlnw, dlnb = _ln_bwd(dt, y, inv, ln_w)
    if resi is None:
        dt = dt + g
    return (dt, g if resi is not None else None,
            dt.sum(dim=1) if inj is not None else None, dlnw, dlnb, dw1, db1,
            dw2, db2)


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
                        inj=None, resi=None):
    """Kernel MB on CUDA tensors, its plain version on CPU tensors: the VJP
    of ln_mlp_residual at cotangent g (B, T, C), returned as
    `ln_mlp_residual_bwd_plain` returns it."""
    kw = dict(w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
              resi=resi)
    if x.device.type == "cpu":
        return ln_mlp_residual_bwd_plain(x, g, **kw)
    _check_mlp(x, w1, w2, ln_w, ln_b, inj, resi)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    _backward_f32(x)
    a = _contig(x=x, g=g, w1=w1, b1=b1, w2=w2, ln_w=ln_w, ln_b=ln_b, inj=inj)
    b, t, c = x.shape
    hid = w1.shape[0]
    m = b * t
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, t, c), **f32)
    dinj = torch.empty((b, c), **f32) if inj is not None else None
    dln = torch.empty((2, c), **f32) if ln_w is not None else None
    dw1, db1 = torch.empty((hid, c), **f32), torch.empty(hid, **f32)
    dw2, db2 = torch.empty((c, hid), **f32), torch.empty(c, **f32)
    # h, z1, dz1, dh; the weight-gradient partials; the LN partials
    floats = (2 * m * (c + hid)
              + _MAX_GROUPS * max(hid * (c + 1), c * (hid + 1))
              + -(-m // _ROW_TILE) * 2 * c)
    work = _work(floats, x)
    _build.launch("ln_mlp_bwd", a["x"], a["inj"], a["ln_w"], a["ln_b"],
                  a["w1"], a["b1"], a["w2"], a["g"], dx, dinj, dln, dw1, db1,
                  dw2, db2, work, floats, m, t, c, hid, int(resi is None))
    ln_mlp_residual_bwd.launches += 1
    return (dx, g if resi is not None else None, dinj,
            dln[0] if dln is not None else None,
            dln[1] if dln is not None else None, dw1, db1, dw2, db2)


ln_mlp_residual_bwd.launches = 0


def _backward_f32(x):
    if x.dtype != torch.float32:
        raise NotImplementedError(
            "the backward of the bfloat16 forms is not ported")


class _LnMlp(torch.autograd.Function):
    """Forward M, backward MB (the custom VJP `_ln_mlp_core` of the JAX
    package): saves the inputs only. The backward of the zero_base and
    bfloat16 forms raises."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_w, ln_b, inj, resi, zero_base):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_w, ln_b, inj, resi)
        ctx.zero_base = zero_base
        return _ln_mlp_fwd(x, w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w,
                           ln_b=ln_b, inj=inj, resi=resi, zero_base=zero_base)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, ln_w, ln_b, inj, resi = ctx.saved_tensors
        if ctx.zero_base:
            raise NotImplementedError(
                "the backward of zero_base is not ported")
        _backward_f32(x)
        dx, dresi, dinj, dlnw, dlnb, dw1, db1, dw2, db2 = ln_mlp_residual_bwd(
            x, g, w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
            resi=resi)
        return dx, dw1, db1, dw2, db2, dlnw, dlnb, dinj, dresi, None


def ln_mlp_residual(x, *, w1, b1, w2, b2, ln_w=None, ln_b=None, inj=None,
                    resi=None, zero_base: bool = False):
    """out = (0 | resi | x+inj) + fc2(relu(fc1(LN?(x + inj?)))).

    x, resi: (B, T, C) float32 or bfloat16, resi in x's type; inj: (B, C)
    broadcast over T, either type (summed in f32, unrounded); w1 (hid, C),
    w2 (C, hid) float32. zero_base=True returns the bare MLP output (the
    Enhanced block tails). The float32 forms without zero_base are
    differentiable in every tensor argument (kernel MB on the card)."""
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
                           scale=None):
    """Plain PyTorch version of kernel AB: the VJP of ln_attn_proj at
    cotangent g, forward recomputed. Returns what `_ln_attn_core_bwd`
    returns without the RoPE table gradients, (dx, dpos, dkv, dln_w, dln_b,
    dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dbias), with None for an option
    not given."""
    c = x.shape[-1]
    if scale is None:
        scale = (c // num_heads) ** -0.5
    y, inv = _ln_stats(x)
    xq = y * ln_w + ln_b
    if pos is not None:
        xq = xq + pos
    src = kv if kv is not None else xq
    q, k, v = xq @ wq.t() + bq, src @ wk.t() + bk, src @ wv.t() + bv
    att = _merge(_probs(q, k, bias, scale, num_heads)
                 @ _heads(v, num_heads))
    dwo, dbo = _wgrad(g, att), g.flatten(0, -2).sum(0)
    dq, dk, dv, dbias = window_attention_packed_bwd_plain(
        q, k, v, bias, g @ wo, scale, num_heads)
    dxq = dq @ wq
    dsrc = dk @ wk + dv @ wv
    if kv is None:
        dxq = dxq + dsrc
    dx, dlnw, dlnb = _ln_bwd(dxq, y, inv, ln_w)
    return (dx, dxq.sum(dim=0) if pos is not None else None,
            dsrc if kv is not None else None, dlnw, dlnb,
            _wgrad(dq, xq), dq.flatten(0, -2).sum(0),
            _wgrad(dk, src), dk.flatten(0, -2).sum(0),
            _wgrad(dv, src), dv.flatten(0, -2).sum(0), dwo, dbo, dbias)


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
    """Windows too long for A: A-long's."""
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
    """Checked, contiguous kernel arguments of A and A-long: (b, tq, tk, c,
    the tensors by name)."""
    b, tq, tk, c = _check_attn(x, num_heads, (kw["wq"], kw["wk"], kw["wv"],
                                              kw["wo"]),
                               kw["bias"], kw["pos"], kw["kv"],
                               [kw[r] for r in _ROPE])
    _check_attn_kernel(x, num_heads, kw["rope_cos_q"] is not None)
    # pos is rounded to the activation type, as the Pallas wrapper casts it
    if kw["pos"] is not None:
        kw = dict(kw, pos=kw["pos"].to(x.dtype))
    return b, tq, tk, c, _contig(act=("pos", "kv"), x=x, **kw)


def ln_attn_proj_long(x, *, num_heads, scale=None, **kw):
    """The forward of `ln_attn_proj` for windows of any length: kernel
    A-long on CUDA tensors, the plain version on CPU tensors. `kw`: the
    tensor arguments of `ln_attn_proj` by name."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    kw = {**dict.fromkeys(("bias", "pos", "kv") + _ROPE), **kw}
    if x.device.type == "cpu":
        return ln_attn_proj_plain(x, num_heads=num_heads, scale=scale, **kw)
    b, tq, tk, c, a = _ln_attn_args(x, num_heads, kw)
    # q, k, v after RoPE and att, in the activation type
    qs = torch.empty_like(a["x"])
    ks = torch.empty((b, tk, c), dtype=x.dtype, device=x.device)
    vs = torch.empty_like(ks)
    att = torch.empty_like(qs)
    out = torch.empty_like(qs)
    _build.launch("ln_attn_long", a["x"], a["pos"], a["kv"], a["ln_w"],
                  a["ln_b"], a["wq"], a["bq"], a["wk"], a["bk"], a["wv"],
                  a["bv"], a["wo"], a["bo"], a["bias"],
                  *(a[r] for r in _ROPE), qs, ks, vs, att, out, b, tq, tk, c,
                  num_heads, int(x.dtype == torch.bfloat16), float(scale))
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
    b, tq, tk, c, a = _ln_attn_args(x, num_heads, kw)
    # the heads' output, rounded to the activation type but held in f32
    att = torch.empty(a["x"].shape, dtype=torch.float32, device=x.device)
    out = torch.empty_like(a["x"])
    _build.launch("ln_attn", a["x"], a["pos"], a["kv"], a["ln_w"],
                  a["ln_b"], a["wq"], a["bq"], a["wk"], a["bk"], a["wv"],
                  a["bv"], a["wo"], a["bo"], a["bias"],
                  *(a[r] for r in _ROPE), att, out, b, tq, tk, c, num_heads,
                  int(x.dtype == torch.bfloat16), float(scale))
    ln_attn_proj.launches += 1
    return out


def ln_attn_proj_bwd(x, g, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                     num_heads: int, bias=None, pos=None, kv=None,
                     scale=None):
    """Kernel AB on CUDA tensors, its plain version on CPU tensors: the VJP
    of ln_attn_proj at cotangent g (B, Tq, C), returned as
    `ln_attn_proj_bwd_plain` returns it."""
    kw = dict(wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv, wo=wo, bo=bo,
              ln_w=ln_w, ln_b=ln_b, bias=bias, pos=pos, kv=kv)
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    if x.device.type == "cpu":
        return ln_attn_proj_bwd_plain(x, g, num_heads=num_heads, scale=scale,
                                      **kw)
    b, tq, tk, c = _check_attn(x, num_heads, (wq, wk, wv, wo), bias, pos, kv)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must match x {tuple(x.shape)}")
    _backward_f32(x)
    a = _contig(x=x, g=g, **kw)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((b, tq, c), **f32)
    dkv = torch.empty((b, tk, c), **f32) if kv is not None else None
    dpos = torch.empty((tq, c), **f32) if pos is not None else None
    dln = torch.empty((2, c), **f32)
    dws = [torch.empty(s, **f32) for _ in range(4) for s in ((c, c), (c,))]
    dbias = (torch.empty((num_heads, tq, tk), **f32) if bias is not None
             else None)
    mq, mk = b * tq, b * tk
    # xq, q, datt, att, dq, dxq, k, v, dk, dv; ds per window; the
    # weight-gradient partials; the LN partials
    floats = ((6 * mq + 4 * mk) * c + b * num_heads * tq * tk
              + _MAX_GROUPS * c * (c + 1) + -(-mq // _ROW_TILE) * 2 * c)
    work = _work(floats, x)
    _build.launch("ln_attn_bwd", a["x"], a["pos"], a["kv"], a["ln_w"],
                  a["ln_b"], a["wq"], a["bq"], a["wk"], a["bk"], a["wv"],
                  a["bv"], a["wo"], a["bias"], a["g"], dx, dkv, dpos, dln,
                  *dws, dbias, work, floats, b, tq, tk, c, num_heads,
                  float(scale))
    ln_attn_proj_bwd.launches += 1
    return (dx, dpos, dkv, dln[0], dln[1], *dws, dbias)


ln_attn_proj_bwd.launches = 0


class _LnAttn(torch.autograd.Function):
    """Forward A, backward AB (the custom VJP `_ln_attn_core` of the JAX
    package): saves the inputs only. The backward of the RoPE and bfloat16
    forms raises: AB has no RoPE-table gradients yet."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias,
                pos, kv, cos_q, sin_q, cos_k, sin_k, num_heads, scale):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                              bias, pos, kv)
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.rope = cos_q is not None
        return _ln_attn_fwd(x, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
                            wo=wo, bo=bo, ln_w=ln_w, ln_b=ln_b, bias=bias,
                            pos=pos, kv=kv, rope_cos_q=cos_q,
                            rope_sin_q=sin_q, rope_cos_k=cos_k,
                            rope_sin_k=sin_k, num_heads=num_heads,
                            scale=scale)

    @staticmethod
    def backward(ctx, g):
        (x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias, pos,
         kv) = ctx.saved_tensors
        if _a_long(x, kv):
            raise NotImplementedError(
                f"the backward of A at windows of more than {_A_MAX_T} "
                "tokens needs AB's window-16 form, which is not ported")
        if ctx.rope:
            raise NotImplementedError(
                "the backward of the RoPE form (K10's table gradients) is "
                "not ported")
        _backward_f32(x)
        (dx, dpos, dkv, dlnw, dlnb, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo,
         dbias) = ln_attn_proj_bwd(
            x, g, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv, wo=wo, bo=bo,
            ln_w=ln_w, ln_b=ln_b, num_heads=ctx.num_heads, bias=bias,
            pos=pos, kv=kv, scale=ctx.scale)
        return (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dlnw, dlnb, dbias,
                dpos, dkv, None, None, None, None, None, None)


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
    in f32 (the Enhanced family), all four or none. The float32 form
    without RoPE is differentiable in every tensor argument (kernel AB on
    the card)."""
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    return _LnAttn.apply(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias,
                         pos, kv, rope_cos_q, rope_sin_q, rope_cos_k,
                         rope_sin_k, num_heads, float(scale))


ln_attn_proj.launches = 0
