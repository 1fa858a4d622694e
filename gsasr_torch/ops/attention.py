"""Multi-head window attention (counterpart of
`gsasr_tpu/ops/attention.py`): the packed layout of
`window_attention_packed`, with and without the window mask, and the 4D
layout of `window_attention`.

Operands keep the projections' packed (B, T, C) layout: head h is columns
[h*hd, (h+1)*hd) of C, as torch's MultiheadAttention packs them, and no
(B, nh, T, hd) copy is made. Per window w and head h:

    s = q_h k_h^T * scale + bias[h] (+ mask[w % nW]);  p = softmax(s);
    out_h = p v_h

Without a mask the forward is kernel W (`csrc/window_attn_fwd.cu`, the
3xTF32 tensor-core body of `csrc/window_attn_short_tf32.cuh`) and the
backward kernel WB (`csrc/window_attn_bwd.cu`); with the (nW, Tq, Tk)
additive mask of Swin's shifted windows they are kernels WM and WMB, the
masked forms of the same sources. With bfloat16 q, k, v (the bf16 module
paths: the Enhanced decoder, SwinIR and the HATs in bf16) they are W-bf16
and WB-bf16 (WM-bf16 and WMB-bf16 with a mask), tensor-core bodies of
their own (`csrc/window_attn_short_mma.cuh`, `_bwd.cuh`), which round where
the Pallas bodies round: scores and softmax in f32, p rounded to bfloat16
before the PV product, out in bfloat16; in the backward p is recomputed in
f32 and not rounded, and dq, dk, dv come out in bfloat16 while dbias stays
f32. Windows of more than `_MAX_T` tokens (HAT's 256, OCAB's 256 x 576)
take the window-16 forms, which walk the keys (and, backward, the queries)
in tiles: W-long and WB-long, and with a mask (the paper HAT's shifted
windows) WM-long and WMB-long, each also in bfloat16. Each pair sits inside
one autograd Function, which picks it by (mask, type, length); the mask is
a constant and gets no gradient. CPU tensors take the plain versions beside
the wrappers.

`window_attention` takes the JAX package's 4D layout: q (B, nh, Tq, hd), k
and v (B, nh, Tk, hd), a bias (nh, Tq, Tk). Its forward is kernel W4 and
its backward WB4 (`window_attn_fwd_4d`, `window_attn_bwd_4d` and their
bfloat16 forms): W's and WB's bodies (in bfloat16 W-bf16's and WB-bf16's),
or beyond `_MAX_T` tokens W-long's and WB-long's, reading and writing the
head-major layout in place (a template flag on their index arithmetic), so
no transpose to the packed layout is made. They round where K14 and K14b round: scores and softmax in
f32, p rounded to v's type before the PV product, out in q's type; the
backward recomputes p in f32, forms dq, dk, dv in f32 and stores them in
the operands' type, and sums dbias over the windows in f32. With a window
mask it runs the plain composition, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from gsasr_torch.ops import _build

# Limits of kernels W and WB and of their bf16 forms: a window's q, k, v
# and g on chip.
_MAX_T = 160
_MAX_HD = 32


def _heads(x, num_heads: int):
    b, t, c = x.shape
    return x.reshape(b, t, num_heads, c // num_heads).transpose(1, 2)


def _probs(q, k, bias, scale: float, num_heads: int, mask=None):
    """(B, nh, Tq, Tk) softmax probabilities of packed q and k, f32, row max
    subtracted; window w takes mask[w % nW] after the bias."""
    return _probs4(_heads(q, num_heads), _heads(k, num_heads), bias, scale,
                   mask)


def _probs4(q, k, bias, scale: float, mask=None):
    """(B, nh, Tq, Tk) softmax probabilities of head-major q (B, nh, Tq, hd)
    and k (B, nh, Tk, hd), in their type (f32 or wider), row max
    subtracted; window w takes mask[w % nW] after the bias."""
    s = (q @ k.transpose(-1, -2)) * scale
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


def _wide(*xs):
    """The operands widened to at least float32 (bfloat16 exactly; float32
    and float64 as they are), where the products accumulate."""
    acc = torch.promote_types(xs[0].dtype, torch.float32)
    return [x.to(acc) for x in xs]


def window_attention_plain(q, k, v, bias, scale: float, mask=None):
    """Plain PyTorch version of kernel W4 (K14; W4-bf16 with bfloat16
    operands), and the masked composition of `window_attention`: head-major
    q (B, nh, Tq, hd), k, v (B, nh, Tk, hd) -> (B, nh, Tq, hd) in q's type.
    Scores and softmax in f32 (or wider), p rounded to v's type before the
    PV product."""
    qw, kw, vw = _wide(q, k, v)
    p = _probs4(qw, kw, bias, scale, mask)
    return (p.to(v.dtype).to(vw.dtype) @ vw).to(q.dtype)


def window_attention_bwd_plain(q, k, v, bias, g, scale: float, mask=None):
    """Plain PyTorch version of kernel WB4 (K14b; WB4-bf16 with bfloat16
    operands) on the head-major layout: (dq, dk, dv, dbias), the attention
    VJP with the softmax recomputed, unrounded. dq, dk, dv are formed in f32
    (or wider) and come out in the operands' type; dbias sums the windows
    in f32 (or wider), comes out in bias's type and is None when bias is
    None."""
    qw, kw, vw, gw = _wide(q, k, v, g)
    p = _probs4(qw, kw, bias, scale, mask)
    dv = p.transpose(-1, -2) @ gw
    dp = gw @ vw.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ kw) * scale
    dk = (ds.transpose(-1, -2) @ qw) * scale
    dbias = None if bias is None else ds.sum(dim=0).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def window_attention_packed_plain(q, k, v, bias, scale: float,
                                  num_heads: int, mask=None):
    """Plain PyTorch version of kernel W (WM with `mask`, W-bf16 with
    bfloat16 operands): (B, Tq, C) in q's type; p is rounded to v's type
    before the PV product."""
    return _merge(window_attention_plain(
        *(_heads(x, num_heads) for x in (q, k, v)), bias, scale, mask))


def window_attention_packed_bwd_plain(q, k, v, bias, g, scale: float,
                                      num_heads: int, mask=None):
    """Plain PyTorch version of kernel WB (WMB with `mask`, WB-bf16 with
    bfloat16 operands): (dq, dk, dv, dbias), the attention VJP with the
    softmax recomputed, unrounded. dq, dk, dv come out in the operands'
    type; dbias sums the windows in f32 (or wider) and is None when bias is
    None."""
    dq, dk, dv, dbias = window_attention_bwd_plain(
        *(_heads(x, num_heads) for x in (q, k, v)), bias,
        _heads(g, num_heads), scale, mask)
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


def _long(q, k) -> bool:
    """Windows too long for W's body: W-long's."""
    return max(q.shape[1], k.shape[1]) > _MAX_T


def _check(q, k, v, bias, num_heads: int, dtype, extra=(), mask=None,
           max_t=_MAX_T):
    """q, k, v (and `extra`) of `dtype` (float32, or bfloat16 for the bf16
    forms); bias and mask float32; Tq, Tk <= max_t (None: any, the
    window-16 forms)."""
    b, tq, c = q.shape
    tk = k.shape[1]
    if mask is not None:
        _check_mask(q, k, mask)
    for t, name in ((q, "q"), (k, "k"), (v, "v"), *extra):
        _build.check_tensor(t, name, dtype)
    if mask is not None:
        _build.check_tensor(mask, "mask")
    if bias is not None:
        _build.check_tensor(bias, "bias")
    if (k.shape != (b, tk, c) or v.shape != k.shape or c % num_heads
            or c // num_heads > _MAX_HD
            or (max_t is not None and max(tq, tk) > max_t)
            or (bias is not None and bias.shape != (num_heads, tq, tk))):
        raise ValueError(
            f"window attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, {num_heads} heads: the kernels take T <= "
            f"{max_t or 'any'}, head width <= {_MAX_HD} and bias (nh, Tq, "
            "Tk)")


# Entry points by (masked, window-16) form and operand type.
_F32, _BF16 = torch.float32, torch.bfloat16
_FWD = {(False, False): {_F32: "window_attn_fwd",
                         _BF16: "window_attn_fwd_bf16"},
        (True, False): {_F32: "window_attn_fwd_masked",
                        _BF16: "window_attn_fwd_masked_bf16"},
        (False, True): {_F32: "window_attn_fwd_long",
                        _BF16: "window_attn_fwd_long_bf16"},
        (True, True): {_F32: "window_attn_fwd_long_masked",
                       _BF16: "window_attn_fwd_long_masked_bf16"}}
_BWD = {(False, False): {_F32: "window_attn_bwd",
                         _BF16: "window_attn_bwd_bf16"},
        (True, False): {_F32: "window_attn_bwd_masked",
                        _BF16: "window_attn_bwd_masked_bf16"},
        (False, True): {_F32: "window_attn_bwd_long",
                        _BF16: "window_attn_bwd_long_bf16"},
        (True, True): {_F32: "window_attn_bwd_long_masked",
                       _BF16: "window_attn_bwd_long_masked_bf16"}}


def _mask_args(mask):
    """What a masked entry point takes besides the unmasked one's arguments:
    the mask after the bias, and its period before the scale (nothing and
    nothing without a mask)."""
    return ((), ()) if mask is None else ((mask.contiguous(),),
                                          (mask.shape[0],))


def _fwd(q, k, v, bias, mask, scale: float, num_heads: int, dtype,
         long: bool = False):
    """Launch kernel W (W-bf16 for bfloat16 `dtype`), WM with `mask`, or
    their window-16 forms with `long` (W-long, WM-long and their bf16
    forms); returns out."""
    _check(q, k, v, bias, num_heads, dtype, mask=mask,
           max_t=None if long else _MAX_T)
    b, tq, c = q.shape
    out = torch.empty((b, tq, c), dtype=dtype, device=q.device)
    m, nw = _mask_args(mask)
    _build.launch(_FWD[mask is not None, long][dtype], q.contiguous(),
                  k.contiguous(), v.contiguous(),
                  None if bias is None else bias.contiguous(), *m, out, b,
                  tq, k.shape[1], c, num_heads, *nw, float(scale))
    return out


def _bwd_outputs(q, k, v, bias, g, num_heads: int, dtype, max_t, mask=None):
    """Check the backward's operands; returns (b, tq, tk, c, dq, dk, dv,
    dbias or None), the gradients allocated in `dtype` (dbias f32)."""
    _check(q, k, v, bias, num_heads, dtype, extra=((g, "g"),), mask=mask,
           max_t=max_t)
    b, tq, c = q.shape
    tk = k.shape[1]
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} must match q {tuple(q.shape)}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, tk, c), dtype=dtype, device=q.device)
    dv = torch.empty_like(dk)
    dbias = (None if bias is None else
             torch.empty((num_heads, tq, tk), dtype=torch.float32,
                         device=q.device))
    return b, tq, tk, c, dq, dk, dv, dbias


def _bwd(q, k, v, bias, mask, g, scale: float, num_heads: int, dtype,
         long: bool = False):
    """Launch kernel WB (WB-bf16 for bfloat16 `dtype`), WMB with `mask`, or
    their window-16 forms with `long` (WB-long, WMB-long and their bf16
    forms); returns (dq, dk, dv, dbias or None)."""
    b, tq, tk, c, dq, dk, dv, dbias = _bwd_outputs(
        q, k, v, bias, g, num_heads, dtype, None if long else _MAX_T, mask)
    f32 = dict(dtype=torch.float32, device=q.device)
    # the per-window ds (B, nh, Tq, Tk), f32 whatever the operand type: the
    # tensor-core bodies keep ds on the chip and need it only for dbias's
    # ordered sum; the window-16 forms keep each query row's (max, sum, D)
    # in stats (B, nh, Tq, 3), and so do the fp32 forms up to 160 tokens
    # where WB-long's launches stand in for their body (shared memory)
    ds = (None if bias is None else
          torch.empty((b, num_heads, tq, tk), **f32))
    scratch = (torch.empty((b, num_heads, tq, 3), **f32), ds) \
        if long or dtype == torch.float32 else (ds,)
    m, nw = _mask_args(mask)
    _build.launch(_BWD[mask is not None, long][dtype], q.contiguous(),
                  k.contiguous(), v.contiguous(),
                  None if bias is None else bias.contiguous(), *m,
                  g.contiguous(), dq, dk, dv, *scratch, dbias, b, tq, tk, c,
                  num_heads, *nw, float(scale))
    return dq, dk, dv, dbias


def window_attention_packed_fwd(q, k, v, bias, scale: float, num_heads: int):
    """Forward of the packed attention in float32: kernel W on CUDA tensors,
    the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads)
    out = _fwd(q, k, v, bias, None, scale, num_heads, torch.float32)
    window_attention_packed_fwd.launches += 1
    return out


window_attention_packed_fwd.launches = 0


def window_attention_packed_bwd(q, k, v, bias, g, scale: float,
                                num_heads: int):
    """Backward of the packed attention in float32: kernel WB on CUDA
    tensors, the plain version on CPU tensors. Returns (dq, dk, dv, dbias or
    None)."""
    if q.device.type == "cpu":
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads)
    out = _bwd(q, k, v, bias, None, g, scale, num_heads, torch.float32)
    window_attention_packed_bwd.launches += 1
    return out


window_attention_packed_bwd.launches = 0


def window_attention_packed_bf16_fwd(q, k, v, bias, scale: float,
                                     num_heads: int):
    """Forward of the packed attention with bfloat16 q, k, v (bias float32
    or None): kernel W-bf16 on CUDA tensors, the plain version on CPU
    tensors. Returns bfloat16."""
    if q.device.type == "cpu":
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads)
    out = _fwd(q, k, v, bias, None, scale, num_heads, torch.bfloat16)
    window_attention_packed_bf16_fwd.launches += 1
    return out


window_attention_packed_bf16_fwd.launches = 0


def window_attention_packed_bf16_bwd(q, k, v, bias, g, scale: float,
                                     num_heads: int):
    """Backward of the packed attention with bfloat16 q, k, v and g: kernel
    WB-bf16 on CUDA tensors, the plain version on CPU tensors. Returns (dq,
    dk, dv in bfloat16, dbias float32 or None)."""
    if q.device.type == "cpu":
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads)
    out = _bwd(q, k, v, bias, None, g, scale, num_heads, torch.bfloat16)
    window_attention_packed_bf16_bwd.launches += 1
    return out


window_attention_packed_bf16_bwd.launches = 0


def window_attention_packed_long_fwd(q, k, v, bias, scale: float,
                                     num_heads: int):
    """Forward of the packed attention in float32 for any Tq and Tk: kernel
    W-long on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads)
    out = _fwd(q, k, v, bias, None, scale, num_heads, torch.float32, True)
    window_attention_packed_long_fwd.launches += 1
    return out


window_attention_packed_long_fwd.launches = 0


def window_attention_packed_long_bf16_fwd(q, k, v, bias, scale: float,
                                          num_heads: int):
    """Forward of the packed attention with bfloat16 q, k, v for any Tq and
    Tk: kernel W-long-bf16 on CUDA tensors, the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads)
    out = _fwd(q, k, v, bias, None, scale, num_heads, torch.bfloat16,
               True)
    window_attention_packed_long_bf16_fwd.launches += 1
    return out


window_attention_packed_long_bf16_fwd.launches = 0


def window_attention_packed_long_bwd(q, k, v, bias, g, scale: float,
                                     num_heads: int):
    """Backward of the packed attention in float32 for any Tq and Tk:
    kernel WB-long on CUDA tensors, the plain version on CPU tensors.
    Returns (dq, dk, dv, dbias or None)."""
    if q.device.type == "cpu":
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads)
    out = _bwd(q, k, v, bias, None, g, scale, num_heads, torch.float32,
               True)
    window_attention_packed_long_bwd.launches += 1
    return out


window_attention_packed_long_bwd.launches = 0


def window_attention_packed_long_bf16_bwd(q, k, v, bias, g, scale: float,
                                          num_heads: int):
    """Backward of the packed attention with bfloat16 q, k, v and g for any
    Tq and Tk: kernel WB-long-bf16 on CUDA tensors, the plain version on
    CPU tensors. Returns (dq, dk, dv in bfloat16, dbias float32 or None)."""
    if q.device.type == "cpu":
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads)
    out = _bwd(q, k, v, bias, None, g, scale, num_heads, torch.bfloat16,
               True)
    window_attention_packed_long_bf16_bwd.launches += 1
    return out


window_attention_packed_long_bf16_bwd.launches = 0


def window_attention_packed_masked_fwd(q, k, v, bias, mask, scale: float,
                                       num_heads: int):
    """Forward of the masked attention: kernel WM on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads,
                                             mask)
    out = _fwd(q, k, v, bias, mask, scale, num_heads, torch.float32)
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
    out = _bwd(q, k, v, bias, mask, g, scale, num_heads, torch.float32)
    window_attention_packed_masked_bwd.launches += 1
    return out


window_attention_packed_masked_bwd.launches = 0


def window_attention_packed_masked_bf16_fwd(q, k, v, bias, mask,
                                            scale: float, num_heads: int):
    """Forward of the masked attention with bfloat16 q, k, v (bias and mask
    float32): kernel WM-bf16 on CUDA tensors, the plain version on CPU
    tensors. Returns bfloat16."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads,
                                             mask)
    out = _fwd(q, k, v, bias, mask, scale, num_heads, torch.bfloat16)
    window_attention_packed_masked_bf16_fwd.launches += 1
    return out


window_attention_packed_masked_bf16_fwd.launches = 0


def window_attention_packed_masked_bf16_bwd(q, k, v, bias, mask, g,
                                            scale: float, num_heads: int):
    """Backward of the masked attention with bfloat16 q, k, v and g: kernel
    WMB-bf16 on CUDA tensors, the plain version on CPU tensors. Returns
    (dq, dk, dv in bfloat16, dbias float32 or None)."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads, mask)
    out = _bwd(q, k, v, bias, mask, g, scale, num_heads, torch.bfloat16)
    window_attention_packed_masked_bf16_bwd.launches += 1
    return out


window_attention_packed_masked_bf16_bwd.launches = 0


def window_attention_packed_long_masked_fwd(q, k, v, bias, mask,
                                            scale: float, num_heads: int):
    """Forward of the masked attention in float32 for any Tq and Tk: kernel
    WM-long on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads,
                                             mask)
    out = _fwd(q, k, v, bias, mask, scale, num_heads, torch.float32, True)
    window_attention_packed_long_masked_fwd.launches += 1
    return out


window_attention_packed_long_masked_fwd.launches = 0


def window_attention_packed_long_masked_bf16_fwd(q, k, v, bias, mask,
                                                 scale: float,
                                                 num_heads: int):
    """Forward of the masked attention with bfloat16 q, k, v for any Tq and
    Tk: kernel WM-long-bf16 on CUDA tensors, the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_plain(q, k, v, bias, scale, num_heads,
                                             mask)
    out = _fwd(q, k, v, bias, mask, scale, num_heads, torch.bfloat16, True)
    window_attention_packed_long_masked_bf16_fwd.launches += 1
    return out


window_attention_packed_long_masked_bf16_fwd.launches = 0


def window_attention_packed_long_masked_bwd(q, k, v, bias, mask, g,
                                            scale: float, num_heads: int):
    """Backward of the masked attention in float32 for any Tq and Tk:
    kernel WMB-long on CUDA tensors, the plain version on CPU tensors.
    Returns (dq, dk, dv, dbias or None)."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads, mask)
    out = _bwd(q, k, v, bias, mask, g, scale, num_heads, torch.float32, True)
    window_attention_packed_long_masked_bwd.launches += 1
    return out


window_attention_packed_long_masked_bwd.launches = 0


def window_attention_packed_long_masked_bf16_bwd(q, k, v, bias, mask, g,
                                                 scale: float,
                                                 num_heads: int):
    """Backward of the masked attention with bfloat16 q, k, v and g for any
    Tq and Tk: kernel WMB-long-bf16 on CUDA tensors, the plain version on
    CPU tensors. Returns (dq, dk, dv in bfloat16, dbias float32 or
    None)."""
    if q.device.type == "cpu":
        _check_mask(q, k, mask)
        return window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                 num_heads, mask)
    out = _bwd(q, k, v, bias, mask, g, scale, num_heads, torch.bfloat16,
               True)
    window_attention_packed_long_masked_bf16_bwd.launches += 1
    return out


window_attention_packed_long_masked_bf16_bwd.launches = 0

# The (forward, backward) wrappers of each form by (masked, bfloat16,
# window-16); the masked ones take the mask after the bias.
_FORMS = {
    (False, False, False): (window_attention_packed_fwd,
                            window_attention_packed_bwd),
    (False, True, False): (window_attention_packed_bf16_fwd,
                           window_attention_packed_bf16_bwd),
    (False, False, True): (window_attention_packed_long_fwd,
                           window_attention_packed_long_bwd),
    (False, True, True): (window_attention_packed_long_bf16_fwd,
                          window_attention_packed_long_bf16_bwd),
    (True, False, False): (window_attention_packed_masked_fwd,
                           window_attention_packed_masked_bwd),
    (True, True, False): (window_attention_packed_masked_bf16_fwd,
                          window_attention_packed_masked_bf16_bwd),
    (True, False, True): (window_attention_packed_long_masked_fwd,
                          window_attention_packed_long_masked_bwd),
    (True, True, True): (window_attention_packed_long_masked_bf16_fwd,
                         window_attention_packed_long_masked_bf16_bwd),
}


class _PackedWindowAttention(torch.autograd.Function):
    """One (forward, backward) pair of `_FORMS`, picked by the mask, the
    operand type and the window length: W and WB (the custom VJP of
    `_packed_window_attention` in the JAX package), WM and WMB with a mask
    (`_masked_packed_window_attention`'s), their bf16 forms, and the
    window-16 forms of all four beyond `_MAX_T` tokens. The mask gets no
    gradient where JAX returns zeros for it."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, num_heads):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale, ctx.num_heads = scale, num_heads
        fwd, _ = _FORMS[mask is not None, q.dtype == torch.bfloat16,
                        _long(q, k)]
        ops = (q, k, v, bias) if mask is None else (q, k, v, bias, mask)
        return fwd(*ops, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        _, bwd = _FORMS[mask is not None, q.dtype == torch.bfloat16,
                        _long(q, k)]
        ops = (q, k, v, bias) if mask is None else (q, k, v, bias, mask)
        grads = bwd(*ops, g, ctx.scale, ctx.num_heads)
        return (*grads, None, None, None)


def window_attention_packed(q, k, v, bias: Optional[torch.Tensor] = None, *,
                            num_heads: int, scale: Optional[float] = None,
                            window_mask: Optional[torch.Tensor] = None):
    """Multi-head window attention on packed operands, differentiable in q,
    k, v and bias.

    q: (B, Tq, C); k, v: (B, Tk, C), all float32 or all bfloat16; bias:
    (num_heads, Tq, Tk) float32 or None; window_mask: (nW, Tq, Tk) float32
    or None, added to window w's scores as window_mask[w % nW] (B must be a
    multiple of nW). Returns (B, Tq, C) in q's type."""
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    return _PackedWindowAttention.apply(q, k, v, bias, window_mask,
                                        float(scale), num_heads)


# ---------------------------------------------------------------------------
# 4D (head-major) layout: window_attention, kernels W4 and WB4
# ---------------------------------------------------------------------------

_FWD4 = {_F32: "window_attn_fwd_4d", _BF16: "window_attn_fwd_4d_bf16"}
_BWD4 = {_F32: "window_attn_bwd_4d", _BF16: "window_attn_bwd_4d_bf16"}


def _check4(q, k, v, bias, dtype, extra=()):
    """Head-major q (B, nh, Tq, hd), k and v (B, nh, Tk, hd) (and `extra`)
    of `dtype`, head width <= _MAX_HD, bias (nh, Tq, Tk) float32 or None.
    Returns (B, nh, Tq, Tk, hd)."""
    for t, name in ((q, "q"), (k, "k"), (v, "v"), *extra):
        _build.check_tensor(t, name, dtype)
    if bias is not None:
        _build.check_tensor(bias, "bias")
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} is not (B, nh, Tq, hd)")
    b, nh, tq, hd = q.shape
    tk = k.shape[2]
    if (k.shape != (b, nh, tk, hd) or v.shape != k.shape or hd > _MAX_HD
            or (bias is not None and bias.shape != (nh, tq, tk))):
        raise ValueError(
            f"window attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}: the kernels take (B, nh, T, hd) operands, "
            f"head width <= {_MAX_HD} and bias (nh, Tq, Tk)")
    return b, nh, tq, tk, hd


def _fwd4(q, k, v, bias, scale: float, dtype):
    """Launch kernel W4 (W4-bf16 for bfloat16 `dtype`; W-long's body beyond
    _MAX_T tokens); returns out (B, nh, Tq, hd)."""
    b, nh, tq, tk, hd = _check4(q, k, v, bias, dtype)
    out = torch.empty((b, nh, tq, hd), dtype=dtype, device=q.device)
    _build.launch(_FWD4[dtype], q.contiguous(), k.contiguous(),
                  v.contiguous(), None if bias is None else bias.contiguous(),
                  out, b, tq, tk, nh * hd, nh, float(scale))
    return out


def _bwd4(q, k, v, bias, g, scale: float, dtype):
    """Launch kernel WB4 (WB4-bf16 for bfloat16 `dtype`; WB-long's launches
    beyond _MAX_T tokens); returns (dq, dk, dv, dbias f32 or None)."""
    b, nh, tq, tk, hd = _check4(q, k, v, bias, dtype, extra=((g, "g"),))
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} must match q {tuple(q.shape)}")
    dq = torch.empty((b, nh, tq, hd), dtype=dtype, device=q.device)
    dk = torch.empty((b, nh, tk, hd), dtype=dtype, device=q.device)
    dv = torch.empty_like(dk)
    f32 = dict(dtype=torch.float32, device=q.device)
    dbias = None if bias is None else torch.empty((nh, tq, tk), **f32)
    # the per-window ds, needed only for dbias's ordered sum; the window-16
    # forms keep each query row's (max, sum, D) in stats, and so may the
    # fp32 form up to 160 tokens (WB-long's launches standing in)
    long = max(tq, tk) > _MAX_T
    stats = (torch.empty((b, nh, tq, 3), **f32)
             if long or dtype == torch.float32 else None)
    ds = None if bias is None else torch.empty((b, nh, tq, tk), **f32)
    _build.launch(_BWD4[dtype], q.contiguous(), k.contiguous(),
                  v.contiguous(), None if bias is None else bias.contiguous(),
                  g.contiguous(), dq, dk, dv, stats, ds, dbias, b, tq, tk,
                  nh * hd, nh, float(scale))
    return dq, dk, dv, dbias


def window_attention_4d_fwd(q, k, v, bias, scale: float):
    """Forward of the 4D attention in float32: kernel W4 on CUDA tensors,
    the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale)
    out = _fwd4(q, k, v, bias, scale, torch.float32)
    window_attention_4d_fwd.launches += 1
    return out


window_attention_4d_fwd.launches = 0


def window_attention_4d_bf16_fwd(q, k, v, bias, scale: float):
    """Forward of the 4D attention with bfloat16 q, k, v (bias float32 or
    None): kernel W4-bf16 on CUDA tensors, the plain version on CPU
    tensors. Returns bfloat16."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale)
    out = _fwd4(q, k, v, bias, scale, torch.bfloat16)
    window_attention_4d_bf16_fwd.launches += 1
    return out


window_attention_4d_bf16_fwd.launches = 0


def window_attention_4d_bwd(q, k, v, bias, g, scale: float):
    """Backward of the 4D attention in float32: kernel WB4 on CUDA tensors,
    the plain version on CPU tensors. Returns (dq, dk, dv, dbias or None)."""
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, g, scale)
    out = _bwd4(q, k, v, bias, g, scale, torch.float32)
    window_attention_4d_bwd.launches += 1
    return out


window_attention_4d_bwd.launches = 0


def window_attention_4d_bf16_bwd(q, k, v, bias, g, scale: float):
    """Backward of the 4D attention with bfloat16 q, k, v and g: kernel
    WB4-bf16 on CUDA tensors, the plain version on CPU tensors. Returns (dq,
    dk, dv in bfloat16, dbias float32 or None)."""
    if q.device.type == "cpu":
        return window_attention_bwd_plain(q, k, v, bias, g, scale)
    out = _bwd4(q, k, v, bias, g, scale, torch.bfloat16)
    window_attention_4d_bf16_bwd.launches += 1
    return out


window_attention_4d_bf16_bwd.launches = 0

# The (forward, backward) wrappers of the 4D layout by bfloat16 operands.
_FORMS4 = {False: (window_attention_4d_fwd, window_attention_4d_bwd),
           True: (window_attention_4d_bf16_fwd, window_attention_4d_bf16_bwd)}


class _WindowAttention(torch.autograd.Function):
    """W4 and WB4 (or their bf16 forms), the custom VJP of the JAX
    package's `fused_window_attention`: the forward saves its inputs and the
    backward recomputes the softmax. A bias of another float type is taken
    in float32 and its gradient returned in its own type."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        b32 = None if bias is None else bias.to(torch.float32)
        ctx.save_for_backward(q, k, v, b32)
        ctx.scale = scale
        ctx.bias_dtype = None if bias is None else bias.dtype
        fwd, _ = _FORMS4[q.dtype == torch.bfloat16]
        return fwd(q, k, v, b32, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, b32 = ctx.saved_tensors
        _, bwd = _FORMS4[q.dtype == torch.bfloat16]
        dq, dk, dv, dbias = bwd(q, k, v, b32, g, ctx.scale)
        if dbias is not None:
            dbias = dbias.to(ctx.bias_dtype)
        return dq, dk, dv, dbias, None


def fused_window_attention(q, k, v, bias, scale: float):
    """softmax(q k^T * scale + bias) v on the head-major layout, its logits
    never written out: q (B, nh, Tq, hd); k, v (B, nh, Tk, hd), all float32
    or all bfloat16; bias (nh, Tq, Tk) or None, broadcast over B. Returns
    (B, nh, Tq, hd) in q's type; differentiable in q, k, v and bias."""
    return _WindowAttention.apply(q, k, v, bias, float(scale))


def window_attention(q, k, v, bias: Optional[torch.Tensor] = None, *,
                     scale: Optional[float] = None,
                     window_mask: Optional[torch.Tensor] = None):
    """Window attention on the JAX package's 4D layout (its public
    `window_attention`): `fused_window_attention` with the scale defaulting
    to hd^-0.5. window_mask, an (nW, Tq, Tk) additive mask where window row
    i of the (B, ...) operands takes window_mask[i % nW], runs the plain
    composition (`window_attention_plain`), as the JAX package runs its
    einsum composition there; B must be a multiple of nW."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window_mask is not None:
        if q.shape[0] % window_mask.shape[0] != 0:
            raise ValueError(
                f"window axis {q.shape[0]} not a multiple of mask period "
                f"{window_mask.shape[0]}")
        return window_attention_plain(q, k, v, bias, float(scale),
                                      window_mask)
    return fused_window_attention(q, k, v, bias, float(scale))
