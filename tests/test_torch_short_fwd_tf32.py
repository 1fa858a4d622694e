"""The arithmetic of the fp32 window attention forward up to 160 tokens on
the tensor cores (W, WM, W4 and kernel A's fp32 attention:
`gsasr_torch/ops/csrc/window_attn_short_tf32.cuh`) emulated in torch on the
CPU, where the kernel cannot run: the products in 3xTF32 (each operand a
pair of tf32 values, three m16n8k8 products a k-step of 8, f32 sums) in
the kernel's contraction slots, one online sweep over steps of 32 keys and
a 16-key tail (the row max joined over each step, each lane's sum of
exponentials of its own keys and the output rescaled when it grows, the
quad's sums joined in a butterfly at the end), p v over 8-key steps in key
slot order, out = o / sum. Held within atol = rtol = 1e-4 of JAX's
window attention (Pallas K11, K13 with a mask, K14 on the 4D layout, in
interpret mode) and of the plain version, the card tests' budget; `-s`
prints the distances from a float64 reference beside 1xTF32's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import attention as ja
from gsasr_torch.ops import attention as ta
from test_torch_attention import (_SLOT_COLS, _inputs, _mask, _mma_steps,
                                  _slots)


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread (the tier-1 run's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def short_tf32_fwd(q, k, v, bias, scale, nh, mask, three=True):
    """The short body's arithmetic on the packed layout (B, T, C): head
    columns padded to 32 with zeros and keys to a multiple of 16 (scores
    -inf past Tk); the scores in the column slots, fixed up as mma_fix
    does (scale, bias, mask); one online sweep over steps of 32 keys and a
    16-key tail: the row max joined over the step, each lane t's sum (keys
    8 n + 2 t + e of the step, in the order (n, e)) and o rescaled by
    exp(old max - new max), p = exp(s - max), o += p v over 8-key steps in
    key slot order; at the end the quad's sums joined as (l0 + l1) + (l2 +
    l3) and out = o * (1 / sum)."""
    b, tq, c = q.shape
    tk = k.shape[1]
    hd = c // nh
    tk16 = -(-tk // 16) * 16
    pad = lambda x, t: torch.nn.functional.pad(  # noqa: E731
        ta._heads(x, nh), (0, 32 - hd, 0, t - x.shape[1]))
    qh, kh, vh = pad(q, tq), pad(k, tk16), pad(v, tk16)
    col = torch.tensor(_SLOT_COLS)
    s = _mma_steps(torch.zeros(b, nh, tq, tk16), qh[..., col],
                   kh[..., col].transpose(-1, -2), three) * scale
    if bias is not None:
        s[..., :tk] = s[..., :tk] + bias
    if mask is not None:
        nw = mask.shape[0]
        s[..., :tk] = (s[..., :tk].reshape(-1, nw, nh, tq, tk)
                       + mask[None, :, None]).reshape(b, nh, tq, tk)
    s[..., tk:] = -torch.inf
    mx = torch.full((b, nh, tq, 1), -torch.inf)
    sm = torch.zeros(b, nh, tq, 4)
    o = torch.zeros(b, nh, tq, 32)
    steps = [(h, 32) for h in range(0, tk16 - 31, 32)]
    if tk16 % 32:
        steps.append((tk16 - 16, 16))
    for h, w in steps:
        sh = s[..., h:h + w]
        m = torch.maximum(mx, sh.amax(-1, keepdim=True))
        base = torch.where(m == -torch.inf, 0.0, m)
        f = torch.exp(mx - base)
        p = torch.exp(sh - base)
        # (..., lane t, value 2n + e): key 8n + 2t + e of the step
        pl = p.reshape(b, nh, tq, w // 8, 4, 2).permute(0, 1, 2, 4, 3, 5
                                                         ).reshape(
            b, nh, tq, 4, w // 4)
        sm = sm * f
        for i in range(w // 4):
            sm = sm + pl[..., i]
        o = _mma_steps(o * f, _slots(p, -1), _slots(vh[..., h:h + w, :], -2),
                       three)
        mx = m
    l_ = (sm[..., 0] + sm[..., 1]) + (sm[..., 2] + sm[..., 3])
    return ta._merge((o * (1.0 / l_)[..., None])[..., :hd])


# (windows, Tq, Tk, C, heads, bias, mask period): the paper step's 144
# tokens at a head width of 30 with a bias; SwinIR's 64 with a bias and
# the mask of period 2; the longest short window, 160 x 160; an odd length
# (77 queries against 100 keys: a ragged last warp and key chunk)
CASES = [(2, 144, 144, 180, 6, True, 0), (4, 64, 64, 180, 6, True, 2),
         (2, 160, 160, 192, 6, False, 0), (3, 77, 100, 180, 6, True, 0)]


def _report(name, emu, one, plain, wide):
    dist = [float((x - wide).abs().max()) for x in (emu, one, plain)]
    top = float(wide.abs().max())
    print(f"{name}: 3xTF32 {dist[0] / top:.2e}, 1xTF32 {dist[1] / top:.2e}, "
          f"plain fp32 {dist[2] / top:.2e} of max|float64 ref|")


@pytest.mark.parametrize("b,tq,tk,c,nh,bias,nw", CASES)
def test_short_forward_tf32_arithmetic(b, tq, tk, c, nh, bias, nw):
    q, k, v, bs, _ = (None if x is None else torch.from_numpy(x)
                      for x in _inputs(b, tq, tk, c, nh, bias, seed=23))
    mask = torch.from_numpy(_mask(nw, tq, tk, seed=24)) if nw else None
    scale = (c // nh) ** -0.5
    emu = short_tf32_fwd(q, k, v, bs, scale, nh, mask)
    plain = ta.window_attention_packed_plain(q, k, v, bs, scale, nh, mask)
    jout = torch.from_numpy(np.array(ja.window_attention_packed(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        None if bs is None else jnp.asarray(bs.numpy()), num_heads=nh,
        window_mask=None if mask is None else jnp.asarray(mask.numpy()))))
    for ref in (jout, plain):
        torch.testing.assert_close(emu, ref, rtol=1e-4, atol=1e-4)
    wide = ta.window_attention_packed_plain(
        *(x.double() for x in (q, k, v)), None if bs is None else bs.double(),
        scale, nh, None if mask is None else mask.double())
    one = short_tf32_fwd(q, k, v, bs, scale, nh, mask, three=False)
    _report(f"{tq}x{tk}", emu, one, plain, wide)


def test_short_forward_tf32_arithmetic_4d():
    """W4: the same body on the head-major (B, nh, T, hd) layout (the flag
    kHM changes only where a head lies), at the paper step's 144 tokens
    with a bias, against JAX's 4D window_attention (K14) and the plain 4D
    version."""
    b, nh, t, hd = 2, 6, 144, 30
    rng = np.random.default_rng(25)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, nh, t, hd)).astype(
        np.float32)) for _ in range(3))
    bs = torch.from_numpy(0.5 * rng.standard_normal((nh, t, t)).astype(
        np.float32))
    scale = hd ** -0.5
    packed = [ta._merge(x) for x in (q, k, v)]
    emu = ta._heads(short_tf32_fwd(*packed, bs, scale, nh, None), nh)
    plain = ta.window_attention_plain(q, k, v, bs, scale)
    jout = torch.from_numpy(np.array(ja.window_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(bs.numpy()),
        scale=scale)))
    for ref in (jout, plain):
        torch.testing.assert_close(emu, ref, rtol=1e-4, atol=1e-4)
    wide = ta.window_attention_plain(*(x.double() for x in (q, k, v)),
                                     bs.double(), scale)
    one = ta._heads(short_tf32_fwd(*packed, bs, scale, nh, None, three=False),
                    nh)
    _report("4D 144x144", emu, one, plain, wide)
