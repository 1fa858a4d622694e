"""Fused decoder-layer kernels (counterpart of `gsasr_tpu/ops/fused_layers.py`,
paper options), forward and backward.

- `ln_mlp_residual`: out = (resi | x+inj) + fc2(relu(fc1(LN?(x + inj?))))
  -> kernel M (`csrc/ln_mlp.cu`) forward, kernel MB (`csrc/ln_mlp_bwd.cu`)
  backward.
- `ln_attn_proj`: out = proj(MHA(LN(x) (+pos) -> q; kv | LN(x) -> k, v;
  + bias[h])) -> kernel A (`csrc/ln_attn.cu`) forward, kernel AB
  (`csrc/ln_attn_bwd.cu`) backward.

Both are differentiable in every tensor argument: an autograd Function
saves only the inputs, and the backward kernel recomputes the forward, as
the JAX package's custom VJPs do. Weights are in nn.Linear layout, (out,
in). CPU tensors take the plain PyTorch version beside each wrapper; CUDA
tensors launch the kernel. LN statistics and the softmax are f32; eps is
1e-5.
"""

from __future__ import annotations

import torch

from gsasr_torch.ops import _build
from gsasr_torch.ops.attention import (_heads, _merge, _probs,
                                       window_attention_packed_bwd_plain)

_EPS = 1e-5
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


def ln_mlp_residual_plain(x, *, w1, b1, w2, b2, ln_w=None, ln_b=None,
                          inj=None, resi=None):
    """Plain PyTorch version of kernel M."""
    t = x + inj[:, None, :] if inj is not None else x
    h = _ln(t, ln_w, ln_b) if ln_w is not None else t
    z = torch.relu(h @ w1.t() + b1)
    z = z @ w2.t() + b2
    return (resi if resi is not None else t) + z


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


def _contig(**kw):
    """The tensors given, checked for the kernels and made contiguous."""
    for name, t in kw.items():
        if t is not None:
            _build.check_tensor(t, name)
    return {k: (v.contiguous() if v is not None else None)
            for k, v in kw.items()}


def _ln_mlp_fwd(x, *, w1, b1, w2, b2, ln_w, ln_b, inj, resi):
    """Kernel M on CUDA tensors, its plain version on CPU tensors."""
    kw = dict(w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
              resi=resi)
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, **kw)
    _check_mlp(x, w1, w2, ln_w, ln_b, inj, resi)
    a = _contig(x=x, **kw)
    b, t, c = x.shape
    out = torch.empty_like(a["x"])
    _build.launch("ln_mlp", a["x"], a["inj"], a["resi"], a["ln_w"],
                  a["ln_b"], a["w1"], a["b1"], a["w2"], a["b2"], out, b * t, t,
                  c, w1.shape[0])
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


class _LnMlp(torch.autograd.Function):
    """Forward M, backward MB (the custom VJP `_ln_mlp_core` of the JAX
    package): saves the inputs only."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_w, ln_b, inj, resi):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_w, ln_b, inj, resi)
        return _ln_mlp_fwd(x, w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w,
                           ln_b=ln_b, inj=inj, resi=resi)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, ln_w, ln_b, inj, resi = ctx.saved_tensors
        dx, dresi, dinj, dlnw, dlnb, dw1, db1, dw2, db2 = ln_mlp_residual_bwd(
            x, g, w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
            resi=resi)
        return dx, dw1, db1, dw2, db2, dlnw, dlnb, dinj, dresi


def ln_mlp_residual(x, *, w1, b1, w2, b2, ln_w=None, ln_b=None, inj=None,
                    resi=None, zero_base: bool = False):
    """out = (resi | x+inj) + fc2(relu(fc1(LN?(x + inj?)))).

    x, resi: (B, T, C); inj: (B, C) broadcast over T; w1 (hid, C), w2
    (C, hid). float32. Differentiable in every tensor argument (kernel MB
    on the card)."""
    if zero_base:
        raise NotImplementedError("zero_base comes with the Enhanced family")
    return _LnMlp.apply(x, w1, b1, w2, b2, ln_w, ln_b, inj, resi)


ln_mlp_residual.launches = 0


def ln_attn_proj_plain(x, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                       num_heads: int, bias=None, pos=None, kv=None,
                       scale=None):
    """Plain PyTorch version of kernel A."""
    b, tq, c = x.shape
    hd = c // num_heads
    if scale is None:
        scale = hd ** -0.5
    xq = _ln(x, ln_w, ln_b)
    if pos is not None:
        xq = xq + pos
    src = kv if kv is not None else xq
    tk = src.shape[1]
    q = (xq @ wq.t() + bq).reshape(b, tq, num_heads, hd).transpose(1, 2)
    k = (src @ wk.t() + bk).reshape(b, tk, num_heads, hd).transpose(1, 2)
    v = (src @ wv.t() + bv).reshape(b, tk, num_heads, hd).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    att = (p @ v).transpose(1, 2).reshape(b, tq, c)
    return att @ wo.t() + bo


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


def _check_attn(x, num_heads, ws, bias, pos, kv):
    b, tq, c = x.shape
    tk = kv.shape[1] if kv is not None else tq
    if (any(w.shape != (c, c) for w in ws)
            or (kv is not None and kv.shape != (b, tk, c))
            or (pos is not None and pos.shape != (tq, c))
            or (bias is not None and bias.shape != (num_heads, tq, tk))):
        raise ValueError("ln_attn_proj: inconsistent shapes")
    return b, tq, tk, c


def _ln_attn_fwd(x, *, num_heads, scale, **kw):
    """Kernel A on CUDA tensors, its plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ln_attn_proj_plain(x, num_heads=num_heads, scale=scale, **kw)
    b, tq, tk, c = _check_attn(x, num_heads, (kw["wq"], kw["wk"], kw["wv"],
                                              kw["wo"]),
                               kw["bias"], kw["pos"], kw["kv"])
    a = _contig(x=x, **kw)
    att = torch.empty_like(a["x"])
    out = torch.empty_like(a["x"])
    _build.launch("ln_attn", a["x"], a["pos"], a["kv"], a["ln_w"],
                  a["ln_b"], a["wq"], a["bq"], a["wk"], a["bk"], a["wv"],
                  a["bv"], a["wo"], a["bo"], a["bias"], att, out, b, tq, tk,
                  c, num_heads, float(scale))
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
    package): saves the inputs only."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias,
                pos, kv, num_heads, scale):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                              bias, pos, kv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _ln_attn_fwd(x, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
                            wo=wo, bo=bo, ln_w=ln_w, ln_b=ln_b, bias=bias,
                            pos=pos, kv=kv, num_heads=num_heads, scale=scale)

    @staticmethod
    def backward(ctx, g):
        (x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias, pos,
         kv) = ctx.saved_tensors
        (dx, dpos, dkv, dlnw, dlnb, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo,
         dbias) = ln_attn_proj_bwd(
            x, g, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv, wo=wo, bo=bo,
            ln_w=ln_w, ln_b=ln_b, num_heads=ctx.num_heads, bias=bias,
            pos=pos, kv=kv, scale=ctx.scale)
        return (dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, dlnw, dlnb, dbias,
                dpos, dkv, None, None)


def ln_attn_proj(x, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                 num_heads: int, bias=None, pos=None, kv=None, scale=None,
                 rope_cos_q=None, rope_sin_q=None, rope_cos_k=None,
                 rope_sin_k=None):
    """out = proj(MHA(LN(x) (+pos), kv | self, +bias)); residual outside.

    x: (B, Tq, C); kv: (B, Tk, C) un-normed cross-attention source or None
    for self-attention; pos: (Tq, C) added after the LN; bias:
    (num_heads, Tq, Tk). float32. Differentiable in every tensor argument
    (kernel AB on the card)."""
    if any(r is not None for r in (rope_cos_q, rope_sin_q, rope_cos_k,
                                   rope_sin_k)):
        raise NotImplementedError("RoPE comes with the Enhanced family")
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    return _LnAttn.apply(x, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b, bias,
                         pos, kv, num_heads, float(scale))


ln_attn_proj.launches = 0
