"""The arithmetic of the fp32 window-16 attention forward on the tensor
cores (W-long and WM-long: `gsasr_torch/ops/csrc/window_attn_long_tf32.cuh`)
emulated in torch on the CPU, where the kernel cannot run: the scores in
3xTF32 in the kernel's column slots, one online sweep over halves of 32
keys, o += p v over 8-key steps in key slot order. Held within atol = rtol
= 1e-4 of JAX's window attention (Pallas K11, K13 with a mask, in
interpret mode) and of the plain version; `-s` prints the distances from a
float64 reference beside 1xTF32's. The backward's emulation and the shared
helpers are in tests/test_torch_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops.attention import window_attention_packed as jattn
from gsasr_torch.ops import attention as ta
from test_torch_attention import (_SLOT_COLS, _inputs, _mask, _mma_steps,
                                  _slots)


def _tf32_window16_fwd(q, k, v, bias, scale, nh, mask, three=True):
    """W-long's (WM-long's with a mask) arithmetic emulated in torch on the
    packed layout: head columns padded to 32 with zeros; the scores in the
    column slots (3xTF32 in k-steps of 8); one sweep over the keys in
    halves of 32 in order, each row's max joined over the half, the output
    and each lane's sum of exponentials (lane t of a quad holding keys 8n +
    2t, + 1 of the half) rescaled when it grows; o += p v over 8-key steps
    in key slot order; the quad's sums joined in a butterfly at the end
    and out = o / sum."""
    b, tq, c = q.shape
    tk = k.shape[1]
    hd = c // nh
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        ta._heads(x, nh), (0, 32 - hd))
    qh, kh, vh = (pad(x) for x in (q, k, v))
    col = torch.tensor(_SLOT_COLS)
    s = _mma_steps(torch.zeros(b, nh, tq, tk), qh[..., col],
                   kh[..., col].transpose(-1, -2), three) * scale
    if bias is not None:
        s = s + bias
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, nh, tq, tk) + mask[None, :, None]
             ).reshape(s.shape)
    mx = torch.full((b, nh, tq, 1), -torch.inf)
    sm = torch.zeros(b, nh, tq, 4)
    o = torch.zeros(b, nh, tq, 32)
    for h in range(0, tk, 32):
        sh = s[..., h:h + 32]
        m = torch.maximum(mx, sh.amax(-1, keepdim=True))
        base = torch.where(m == -torch.inf, 0.0, m)
        f = torch.exp(mx - base)
        p = torch.exp(sh - base)
        # (..., lane t, value 2n + e): key 8n + 2t + e of the half
        pl = p.reshape(b, nh, tq, 4, 4, 2).permute(0, 1, 2, 4, 3, 5).reshape(
            b, nh, tq, 4, 8)
        sm = sm * f
        for i in range(8):
            sm = sm + pl[..., i]
        o = _mma_steps(o * f, _slots(p, -1), _slots(vh[..., h:h + 32, :], -2),
                       three)
        mx = m
    l_ = (sm[..., 0] + sm[..., 1]) + (sm[..., 2] + sm[..., 3])
    return ta._merge((o * (1.0 / l_)[..., None])[..., :hd])


# (windows, Tq, Tk, C, heads, bias, mask period) for the arithmetic of the
# fp32 window-16 forward on the tensor cores (3xTF32): HAT-L Ultra's 256 x
# 256 and OCAB's 256 x 576 at a head width of 32, and the paper HAT's 256 x
# 256 at 30 with a bias and a mask of period 2
FWD_TF32_CASES = [(2, 256, 256, 192, 6, False, 0),
                  (2, 256, 576, 192, 6, False, 0),
                  (2, 256, 256, 180, 6, True, 2)]


@pytest.mark.parametrize("b,tq,tk,c,nh,bias,nw", FWD_TF32_CASES)
def test_fp32_window16_forward_tf32_arithmetic(b, tq, tk, c, nh, bias, nw):
    """W-long's and WM-long's precision design emulated in torch (the
    3xTF32 products in their slot orders, the one online sweep): out within
    atol = rtol = 1e-4 of window_attention_packed in JAX (K11, K13 with the
    mask, in interpret mode) and of the plain version, the card tests'
    budget. Prints its distance from a float64 reference beside 1xTF32's
    (each operand rounded once), which is not asserted, and the plain
    version's."""
    q, k, v, bs, _ = (None if x is None else torch.from_numpy(x)
                      for x in _inputs(b, tq, tk, c, nh, bias, seed=19))
    mask = torch.from_numpy(_mask(nw, tq, tk, seed=20)) if nw else None
    scale = (c // nh) ** -0.5
    emu = _tf32_window16_fwd(q, k, v, bs, scale, nh, mask)
    plain = ta.window_attention_packed_plain(q, k, v, bs, scale, nh, mask)
    jout = torch.from_numpy(np.array(jattn(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        None if bs is None else jnp.asarray(bs.numpy()), num_heads=nh,
        window_mask=None if mask is None else jnp.asarray(mask.numpy()))))
    for ref in (jout, plain):
        torch.testing.assert_close(emu, ref, rtol=1e-4, atol=1e-4)
    wide = ta.window_attention_packed_plain(
        *(x.double() for x in (q, k, v)), None if bs is None else bs.double(),
        scale, nh, None if mask is None else mask.double())
    one = _tf32_window16_fwd(q, k, v, bs, scale, nh, mask, three=False)
    dist = [float((x - wide).abs().max()) for x in (emu, one, plain)]
    top = float(wide.abs().max())
    print(f"out: 3xTF32 {dist[0]:.2e}, 1xTF32 {dist[1]:.2e}, plain fp32 "
          f"{dist[2]:.2e} ({dist[0] / top:.2e}, {dist[1] / top:.2e}, "
          f"{dist[2] / top:.2e} of max|float64 ref|)")
