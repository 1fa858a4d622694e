"""Fused decoder-layer kernels (counterpart of `gsasr_tpu/ops/fused_layers.py`,
forward only, paper options).

- `ln_mlp_residual`: out = (resi | x+inj) + fc2(relu(fc1(LN?(x + inj?))))
  -> kernel M (`csrc/ln_mlp.cu`).
- `ln_attn_proj`: out = proj(MHA(LN(x) (+pos) -> q; kv | LN(x) -> k, v;
  + bias[h])) -> kernel A (`csrc/ln_attn.cu`).

Weights are in nn.Linear layout, (out, in). CPU tensors take the plain
PyTorch version beside each wrapper; CUDA tensors launch the kernel.
LN statistics and the softmax are f32; eps is 1e-5.
"""

from __future__ import annotations

import torch

from gsasr_torch.ops import _build

_EPS = 1e-5


def _ln(x, w, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _EPS) * w + b


def ln_mlp_residual_plain(x, *, w1, b1, w2, b2, ln_w=None, ln_b=None,
                          inj=None, resi=None):
    """Plain PyTorch version of kernel M."""
    t = x + inj[:, None, :] if inj is not None else x
    h = _ln(t, ln_w, ln_b) if ln_w is not None else t
    z = torch.relu(h @ w1.t() + b1)
    z = z @ w2.t() + b2
    return (resi if resi is not None else t) + z


def ln_mlp_residual(x, *, w1, b1, w2, b2, ln_w=None, ln_b=None, inj=None,
                    resi=None, zero_base: bool = False):
    """out = (resi | x+inj) + fc2(relu(fc1(LN?(x + inj?)))).

    x, resi: (B, T, C); inj: (B, C) broadcast over T; w1 (hid, C), w2
    (C, hid). float32, forward only."""
    if zero_base:
        raise NotImplementedError("zero_base comes with the Enhanced family")
    kw = dict(w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, inj=inj,
              resi=resi)
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, **kw)
    args = {"x": x, **{k: v for k, v in kw.items() if v is not None}}
    for name, t in args.items():
        _build.check_tensor(t, name)
    b, t, c = x.shape
    hid = w1.shape[0]
    if (w1.shape != (hid, c) or w2.shape != (c, hid)
            or (inj is not None and inj.shape != (b, c))
            or (resi is not None and resi.shape != x.shape)
            or (ln_w is None) != (ln_b is None)):
        raise ValueError("ln_mlp_residual: inconsistent shapes or options")
    a = {k: (v.contiguous() if v is not None else None)
         for k, v in dict(x=x, **kw).items()}
    out = torch.empty_like(a["x"])
    _build.launch("ln_mlp", a["x"], a["inj"], a["resi"], a["ln_w"],
                  a["ln_b"], a["w1"], a["b1"], a["w2"], a["b2"], out, b * t, t,
                  c, hid)
    ln_mlp_residual.launches += 1
    return out


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


def ln_attn_proj(x, *, wq, bq, wk, bk, wv, bv, wo, bo, ln_w, ln_b,
                 num_heads: int, bias=None, pos=None, kv=None, scale=None,
                 rope_cos_q=None, rope_sin_q=None, rope_cos_k=None,
                 rope_sin_k=None):
    """out = proj(MHA(LN(x) (+pos), kv | self, +bias)); residual outside.

    x: (B, Tq, C); kv: (B, Tk, C) un-normed cross-attention source or None
    for self-attention; pos: (Tq, C) added after the LN; bias:
    (num_heads, Tq, Tk). float32, forward only."""
    if any(r is not None for r in (rope_cos_q, rope_sin_q, rope_cos_k,
                                   rope_sin_k)):
        raise NotImplementedError("RoPE comes with the Enhanced family")
    b, tq, c = x.shape
    if scale is None:
        scale = (c // num_heads) ** -0.5
    kw = dict(wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv, wo=wo, bo=bo,
              ln_w=ln_w, ln_b=ln_b, bias=bias, pos=pos, kv=kv)
    if x.device.type == "cpu":
        return ln_attn_proj_plain(x, num_heads=num_heads, scale=scale, **kw)
    args = {"x": x, **{k: v for k, v in kw.items() if v is not None}}
    for name, t in args.items():
        _build.check_tensor(t, name)
    tk = kv.shape[1] if kv is not None else tq
    if (any(w.shape != (c, c) for w in (wq, wk, wv, wo))
            or (kv is not None and kv.shape != (b, tk, c))
            or (pos is not None and pos.shape != (tq, c))
            or (bias is not None and bias.shape != (num_heads, tq, tk))):
        raise ValueError("ln_attn_proj: inconsistent shapes")
    a = {k: (v.contiguous() if v is not None else None)
         for k, v in dict(x=x, **kw).items()}
    att = torch.empty_like(a["x"])
    out = torch.empty_like(a["x"])
    _build.launch("ln_attn", a["x"], a["pos"], a["kv"], a["ln_w"],
                  a["ln_b"], a["wq"], a["bq"], a["wk"], a["bk"], a["wv"],
                  a["bv"], a["wo"], a["bo"], a["bias"], att, out, b, tq, tk,
                  c, num_heads, float(scale))
    ln_attn_proj.launches += 1
    return out


ln_attn_proj.launches = 0
