"""Packed multi-head window attention (counterpart of
`gsasr_tpu/ops/attention.py::window_attention_packed`, with and without the
window mask).

Operands keep the projections' packed (B, T, C) layout: head h is columns
[h*hd, (h+1)*hd) of C, as torch's MultiheadAttention packs them, and no
(B, nh, T, hd) copy is made. Per window w and head h:

    s = q_h k_h^T * scale + bias[h] (+ mask[w % nW]);  p = softmax(s);
    out_h = p v_h

Without a mask the forward is kernel W (`csrc/window_attn_fwd.cu`) and the
backward kernel WB (`csrc/window_attn_bwd.cu`); with the (nW, Tq, Tk)
additive mask of Swin's shifted windows they are kernels WM and WMB, the
masked forms of the same sources. Each pair sits inside one autograd
Function; the mask is a constant and gets no gradient. CPU tensors take
the plain versions beside the wrappers.
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


def _probs(q, k, bias, scale: float, num_heads: int, mask=None):
    """(B, nh, Tq, Tk) softmax probabilities, f32, row max subtracted;
    window w takes mask[w % nW] after the bias."""
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, *s.shape[1:]) + mask[None, :, None]).reshape(
            s.shape)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _merge(x):
    b, nh, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, nh * hd)


def window_attention_packed_plain(q, k, v, bias, scale: float,
                                  num_heads: int, mask=None):
    """Plain PyTorch version of kernel W (kernel WM with `mask`):
    (B, Tq, C)."""
    p = _probs(q, k, bias, scale, num_heads, mask)
    return _merge(p @ _heads(v, num_heads))


def window_attention_packed_bwd_plain(q, k, v, bias, g, scale: float,
                                      num_heads: int, mask=None):
    """Plain PyTorch version of kernel WB (kernel WMB with `mask`): (dq, dk,
    dv, dbias), the attention VJP with the softmax recomputed. dbias sums
    the windows and is None when bias is None."""
    p = _probs(q, k, bias, scale, num_heads, mask)
    gh = _heads(g, num_heads)
    dv = p.transpose(-1, -2) @ gh
    dp = gh @ _heads(v, num_heads).transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ _heads(k, num_heads)) * scale
    dk = (ds.transpose(-1, -2) @ _heads(q, num_heads)) * scale
    dbias = None if bias is None else ds.sum(dim=0)
    return _merge(dq), _merge(dk), _merge(dv), dbias


def _check_mask(q, k, mask):
    """A window mask is (nW, Tq, Tk) and its period divides the window
    count, as the JAX package requires."""
    b, tq = q.shape[:2]
    if mask.dim() != 3 or mask.shape[1:] != (tq, k.shape[1]):
        raise ValueError(f"window mask {tuple(mask.shape)} is not (nW, "
                         f"{tq}, {k.shape[1]})")
    if b % mask.shape[0]:
        raise ValueError(f"window axis {b} not a multiple of mask period "
                         f"{mask.shape[0]}")


def _check(q, k, v, bias, num_heads: int, extra=(), mask=None):
    b, tq, c = q.shape
    tk = k.shape[1]
    if mask is not None:
        _check_mask(q, k, mask)
        _build.check_tensor(mask, "mask")
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


def _fwd(q, k, v, bias, mask, scale: float, num_heads: int):
    """Launch kernel W, or WM when `mask` is given; returns out."""
    _check(q, k, v, bias, num_heads, mask=mask)
    b, tq, c = q.shape
    out = torch.empty((b, tq, c), dtype=torch.float32, device=q.device)
    ops = (q.contiguous(), k.contiguous(), v.contiguous(),
           None if bias is None else bias.contiguous())
    dims = (b, tq, k.shape[1], c, num_heads)
    if mask is None:
        _build.launch("window_attn_fwd", *ops, out, *dims, float(scale))
    else:
        _build.launch("window_attn_fwd_masked", *ops, mask.contiguous(), out,
                      *dims, mask.shape[0], float(scale))
    return out


def _bwd(q, k, v, bias, mask, g, scale: float, num_heads: int):
    """Launch kernel WB, or WMB when `mask` is given; returns (dq, dk, dv,
    dbias or None)."""
    _check(q, k, v, bias, num_heads, extra=((g, "g"),), mask=mask)
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
    ops = (q.contiguous(), k.contiguous(), v.contiguous(),
           None if bias is None else bias.contiguous())
    outs = (g.contiguous(), dq, dk, dv, ds, dbias, b, tq, tk, c, num_heads)
    if mask is None:
        _build.launch("window_attn_bwd", *ops, *outs, float(scale))
    else:
        _build.launch("window_attn_bwd_masked", *ops, mask.contiguous(),
                      *outs, mask.shape[0], float(scale))
    return dq, dk, dv, dbias


def window_attention_packed_fwd(q, k, v, bias, scale: float, num_heads: int):
    """Forward of the packed attention: kernel W on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads)
    out = _fwd(q, k, v, bias, None, scale, num_heads)
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
    out = _bwd(q, k, v, bias, None, g, scale, num_heads)
    window_attention_packed_bwd.launches += 1
    return out


window_attention_packed_bwd.launches = 0


def window_attention_packed_masked_fwd(q, k, v, bias, mask, scale: float,
                                       num_heads: int):
    """Forward of the masked attention: kernel WM on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads,
                                             mask)
    out = _fwd(q, k, v, bias, mask, scale, num_heads)
    window_attention_packed_masked_fwd.launches += 1
    return out


window_attention_packed_masked_fwd.launches = 0


def window_attention_packed_masked_bwd(q, k, v, bias, mask, g, scale: float,
                                       num_heads: int):
    """Backward of the masked attention: kernel WMB on CUDA tensors, the
    plain version on CPU tensors. Returns (dq, dk, dv, dbias or None)."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads, mask)
    out = _bwd(q, k, v, bias, mask, g, scale, num_heads)
    window_attention_packed_masked_bwd.launches += 1
    return out


window_attention_packed_masked_bwd.launches = 0


class _PackedWindowAttention(torch.autograd.Function):
    """Forward W and backward WB, or WM and WMB with a mask (the custom VJPs
    of `_packed_window_attention` and `_masked_packed_window_attention` in
    the JAX package). The mask gets no gradient where JAX returns zeros for
    it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, num_heads):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale, ctx.num_heads = scale, num_heads
        if mask is None:
            return window_attention_packed_fwd(q, k, v, bias, scale,
                                               num_heads)
        return window_attention_packed_masked_fwd(q, k, v, bias, mask, scale,
                                                  num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        if mask is None:
            grads = window_attention_packed_bwd(q, k, v, bias, g, ctx.scale,
                                                ctx.num_heads)
        else:
            grads = window_attention_packed_masked_bwd(
                q, k, v, bias, mask, g, ctx.scale, ctx.num_heads)
        return (*grads, None, None, None)


def window_attention_packed(q, k, v, bias: Optional[torch.Tensor] = None, *,
                            num_heads: int, scale: Optional[float] = None,
                            window_mask: Optional[torch.Tensor] = None):
    """Multi-head window attention on packed operands, differentiable in q,
    k, v and bias.

    q: (B, Tq, C); k, v: (B, Tk, C); bias: (num_heads, Tq, Tk) or None;
    window_mask: (nW, Tq, Tk) or None, added to window w's scores as
    window_mask[w % nW] (B must be a multiple of nW). Returns (B, Tq, C)."""
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    return _PackedWindowAttention.apply(q, k, v, bias, window_mask,
                                        float(scale), num_heads)
