"""Packed multi-head window attention (counterpart of
`gsasr_tpu/ops/attention.py::window_attention_packed`, without the window
mask).

Operands keep the projections' packed (B, T, C) layout: head h is columns
[h*hd, (h+1)*hd) of C, as torch's MultiheadAttention packs them, and no
(B, nh, T, hd) copy is made. Per window and head:

    s = q_h k_h^T * scale + bias[h];  p = softmax(s);  out_h = p v_h

The forward is kernel W (`csrc/window_attn_fwd.cu`), the backward kernel
WB (`csrc/window_attn_bwd.cu`), both inside one autograd Function. CPU
tensors take the plain versions beside the wrappers.
"""

from __future__ import annotations

from typing import Optional

import torch

from gsasr_torch.ops import _build

# Limits of kernels W and WB: a lane holds 5 keys of a score row and one
# head column.
_MAX_T = 160
_MAX_HD = 32


def _heads(x, num_heads: int):
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def _probs(q, k, bias, scale: float, num_heads: int):
    """(B, nh, Tq, Tk) softmax probabilities, f32, row max subtracted."""
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _merge(x):
    b, nh, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, nh * hd)


def window_attention_packed_plain(q, k, v, bias, scale: float,
                                  num_heads: int):
    """Plain PyTorch version of kernel W: (B, Tq, C)."""
    p = _probs(q, k, bias, scale, num_heads)
    return _merge(p @ _heads(v, num_heads))


def window_attention_packed_bwd_plain(q, k, v, bias, g, scale: float,
                                      num_heads: int):
    """Plain PyTorch version of kernel WB: (dq, dk, dv, dbias), the
    attention VJP with the softmax recomputed. dbias sums the windows and is
    None when bias is None."""
    p = _probs(q, k, bias, scale, num_heads)
    gh = _heads(g, num_heads)
    dv = p.transpose(-1, -2) @ gh
    dp = gh @ _heads(v, num_heads).transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ _heads(k, num_heads)) * scale
    dk = (ds.transpose(-1, -2) @ _heads(q, num_heads)) * scale
    dbias = None if bias is None else ds.sum(dim=0)
    return _merge(dq), _merge(dk), _merge(dv), dbias


def _check(q, k, v, bias, num_heads: int, extra=()):
    b, tq, c = q.shape
    tk = k.shape[1]
    for t, name in ((q, "q"), (k, "k"), (v, "v"), *extra):
        _build.check_tensor(t, name)
    if bias is not None:
        _build.check_tensor(bias, "bias")
    if (k.shape != (b, tk, c) or v.shape != k.shape or c % num_heads
            or c // num_heads > _MAX_HD or tq > _MAX_T or tk > _MAX_T
            or (bias is not None and bias.shape != (num_heads, tq, tk))):
        raise ValueError(
            f"window attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, {num_heads} heads: the kernels take T <= "
            f"{_MAX_T}, head width <= {_MAX_HD} and bias (nh, Tq, Tk)")


def window_attention_packed_fwd(q, k, v, bias, scale: float, num_heads: int):
    """Forward of the packed attention: kernel W on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads)
    _check(q, k, v, bias, num_heads)
    b, tq, c = q.shape
    out = torch.empty((b, tq, c), dtype=torch.float32, device=q.device)
    _build.launch("window_attn_fwd", q.contiguous(), k.contiguous(),
                  v.contiguous(),
                  None if bias is None else bias.contiguous(), out, b, tq,
                  k.shape[1], c, num_heads, float(scale))
    window_attention_packed_fwd.launches += 1
    return out


window_attention_packed_fwd.launches = 0


def window_attention_packed_bwd(q, k, v, bias, g, scale: float,
                                num_heads: int):
    """Backward of the packed attention: kernel WB on CUDA tensors, the plain
    version on CPU tensors. Returns (dq, dk, dv, dbias or None)."""
    if q.device.type == "cpu":
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads)
    _check(q, k, v, bias, num_heads, extra=((g, "g"),))
    b, tq, c = q.shape
    tk = k.shape[1]
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} must match q {tuple(q.shape)}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, tk, c), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    # per-window ds (B, nh, Tq, Tk): dk's operand, and dbias's partial sums
    ds = torch.empty((b, num_heads, tq, tk), dtype=torch.float32,
                     device=q.device)
    dbias = (None if bias is None else
             torch.empty((num_heads, tq, tk), dtype=torch.float32,
                         device=q.device))
    _build.launch("window_attn_bwd", q.contiguous(), k.contiguous(),
                  v.contiguous(),
                  None if bias is None else bias.contiguous(),
                  g.contiguous(), dq, dk, dv, ds, dbias, b, tq, tk, c,
                  num_heads, float(scale))
    window_attention_packed_bwd.launches += 1
    return dq, dk, dv, dbias


window_attention_packed_bwd.launches = 0


class _PackedWindowAttention(torch.autograd.Function):
    """Forward W, backward WB (the custom VJP of `_packed_window_attention`
    in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, num_heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.num_heads = scale, num_heads
        return window_attention_packed_fwd(q, k, v, bias, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_packed_bwd(
            q, k, v, bias, g, ctx.scale, ctx.num_heads)
        return dq, dk, dv, dbias, None, None


def window_attention_packed(q, k, v, bias: Optional[torch.Tensor] = None, *,
                            num_heads: int, scale: Optional[float] = None,
                            window_mask: Optional[torch.Tensor] = None):
    """Multi-head window attention on packed operands, differentiable in q,
    k, v and bias.

    q: (B, Tq, C); k, v: (B, Tk, C); bias: (num_heads, Tq, Tk) or None.
    Returns (B, Tq, C)."""
    if window_mask is not None:
        raise NotImplementedError(
            "window_mask (Swin SW-MSA) comes with the masked kernel K13")
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    return _PackedWindowAttention.apply(q, k, v, bias, float(scale),
                                        num_heads)
