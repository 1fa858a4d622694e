"""The fp32 arithmetic of kernels M and A (A-long's projections too) on the
tensor cores, emulated in torch on the CPU: the row-tile product of
csrc/tile_mma.cuh in 3xTF32 (each f32 operand as big = tf32(x), small =
tf32(x - big), three products a k-step, small_a big_b + big_a small_b +
big_a big_b), in the kernel's slabs of 16 columns and its slot order, with
widths padded to the slab with zeros. M's two products and A's four
projections go through it; A's attention between them is the plain fp32
version's (its 3xTF32 body has its own emulation in
tests/test_torch_attention.py). Each is held within 1e-5 of max|float64
reference|; 1xTF32's distance (each operand rounded once) is printed
(`-s`), not asserted."""

import numpy as np
import pytest
import torch

from gsasr_torch.models.fea2gs_rope_fast import rope_tables
from gsasr_torch.ops import fused_layers as tf

# A slab of 16 columns in two k-steps of 8: slot t of k-step s is column
# 4 t + 2 s, slot t + 4 is column 4 t + 2 s + 1 (a lane's float4 of a row
# serves both steps).
_SLAB = [4 * t + 2 * s + h for s in range(2) for h in (0, 1)
         for t in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread, as the other files that
    run beside the JAX tests in the six-worker run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """x rounded to tf32 as the kernel rounds it (tf32_rna: a 10-bit
    mantissa, to the nearest, ties away from zero), by bit operations on
    the f32 word."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _tile(rows, w, three=True):
    """rows (M, K) @ w (N, K)^T as tile_mma forms it: K padded with zeros
    to a multiple of 16, slab by slab, each slab's two k-steps of 8 in slot
    order, three tf32 products a step into f32 sums (one without
    `three`)."""
    k = rows.shape[-1]
    pad = -k % 16
    a = torch.nn.functional.pad(rows, (0, pad))
    b = torch.nn.functional.pad(w, (0, pad)).t()
    acc = torch.zeros(*rows.shape[:-1], w.shape[0])
    for k0 in range(0, k + pad, 16):
        idx = torch.tensor([k0 + c for c in _SLAB])
        x, y = a[..., idx], b[idx]
        for j in range(0, 16, 8):
            xs, ys = x[..., j:j + 8], y[j:j + 8]
            xb, yb = _tf32(xs), _tf32(ys)
            if three:
                acc = acc + _tf32(xs - xb) @ yb
                acc = acc + xb @ _tf32(ys - yb)
            acc = acc + xb @ yb
    return acc


def _mlp(x, kw, mm):
    """M in f32 with the products taken by mm; float64 when x is."""
    t = x if kw["inj"] is None else x + kw["inj"][:, None, :]
    h = t
    if kw["ln_w"] is not None:
        mu = t.mean(-1, keepdim=True)
        var = (t - mu).square().mean(-1, keepdim=True)
        h = (t - mu) * torch.rsqrt(var + 1e-5) * kw["ln_w"] + kw["ln_b"]
    z = torch.relu(mm(h, kw["w1"]) + kw["b1"])
    z = mm(z, kw["w2"]) + kw["b2"]
    return z if kw["zero_base"] else t + z


def _attn(x, kw, nh, mm):
    """A in f32 with the four projections taken by mm and the attention
    between them as the plain version computes it; float64 when x is."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    xq = (x - mu) * torch.rsqrt(var + 1e-5) * kw["ln_w"] + kw["ln_b"]
    if kw["pos"] is not None:
        xq = xq + kw["pos"]
    src = kw["kv"] if kw["kv"] is not None else xq
    q = mm(xq, kw["wq"]) + kw["bq"]
    k = mm(src, kw["wk"]) + kw["bk"]
    v = mm(src, kw["wv"]) + kw["bv"]
    if kw["rope_cos_q"] is not None:
        q = tf.rope_rotate(q, kw["rope_cos_q"], kw["rope_sin_q"])
        k = tf.rope_rotate(k, kw["rope_cos_k"], kw["rope_sin_k"])
    b, tq, c = x.shape
    hd = c // nh
    q, k, v = (y.reshape(b, -1, nh, hd).transpose(1, 2) for y in (q, k, v))
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    if kw["bias"] is not None:
        s = s + kw["bias"]
    p = torch.softmax(s, dim=-1)
    att = (p @ v).transpose(1, 2).reshape(b, tq, c)
    return mm(att, kw["wo"]) + kw["bo"]


def _weights(rng, c, names):
    bound = 1 / np.sqrt(c)
    return {n: torch.from_numpy(rng.uniform(
        -bound, bound, (c, c) if n[0] == "w" else c).astype(np.float32))
        for n in names}


def _ln(rng, c):
    return dict(ln_w=torch.from_numpy(
        (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)),
        ln_b=torch.from_numpy((0.1 * rng.standard_normal(c))
                              .astype(np.float32)))


def _report(name, emu, one, plain, wide):
    top = float(wide.abs().max())
    dist = [float((x.double() - wide).abs().max()) / top
            for x in (emu, one, plain)]
    print(f"{name}: of max|float64 ref| ({top:.3f}): 3xTF32 {dist[0]:.2e}, "
          f"1xTF32 {dist[1]:.2e}, plain fp32 {dist[2]:.2e}")
    return dist


# (kernel form, channels, heads): the paper decoder's 180 channels in 6
# heads of 30 (the slabs' padding to 192 shows) and the Enhanced
# decoder's 192 in 6 of 32
CASES = [("ln_inj", 180, 6), ("no_ln", 180, 6), ("zero_base", 192, 6),
         ("cross_bias", 180, 6), ("self_bias", 180, 6),
         ("rope_cross", 192, 6), ("rope_self", 192, 6)]


@pytest.mark.parametrize("form,c,nh", CASES)
def test_fused_forward_tf32_arithmetic(form, c, nh):
    """M (LN and inj, no LN, zero_base) and A (the paper's cross-attention
    with pos, kv and a bias, its self-attention, the Enhanced RoPE forms)
    at 2 windows of 144 tokens, their products emulated as tile_mma forms
    them in 3xTF32: within 1e-5 of max|float64 reference|, as close as the
    plain fp32 version; 1xTF32 lands outside the card tests' 1e-4 budget
    and is only printed."""
    rng = np.random.default_rng(len(form) + c)
    b, t = 2, 144
    x = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32))
    if form in ("ln_inj", "no_ln", "zero_base"):
        kw = dict(_weights(rng, c, ("w1", "b1", "w2", "b2")), inj=None,
                  ln_w=None, ln_b=None, zero_base=form == "zero_base")
        if form == "ln_inj":
            kw.update(_ln(rng, c), inj=torch.from_numpy(
                rng.standard_normal((b, c)).astype(np.float32)))
        plain = tf.ln_mlp_residual_plain(x, **kw)

        def run(x_, mm):
            return _mlp(x_, kw if x_.dtype == torch.float32 else {
                k: v.double() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}, mm)
    else:
        kw = dict(_weights(rng, c, ("wq", "bq", "wk", "bk", "wv", "bv",
                                    "wo", "bo")), **_ln(rng, c), pos=None,
                  kv=None, bias=None, rope_cos_q=None, rope_sin_q=None,
                  rope_cos_k=None, rope_sin_k=None)
        if form.endswith("cross"):
            kw.update(pos=torch.from_numpy(
                rng.standard_normal((t, c)).astype(np.float32)),
                kv=torch.from_numpy(
                    rng.standard_normal((b, t, c)).astype(np.float32)))
        if form.startswith("rope"):
            freqs = torch.from_numpy(
                0.5 * rng.standard_normal((2, nh, c // nh // 2))
                .astype(np.float32))
            cos, sin = rope_tables(freqs, 12, t)
            kw.update(rope_cos_q=cos, rope_sin_q=sin, rope_cos_k=cos,
                      rope_sin_k=sin)
        else:
            kw["bias"] = torch.from_numpy(
                (0.5 * rng.standard_normal((nh, t, t))).astype(np.float32))
        plain = tf.ln_attn_proj_plain(x, num_heads=nh, **kw)

        def run(x_, mm):
            return _attn(x_, kw if x_.dtype == torch.float32 else {
                k: None if v is None else v.double()
                for k, v in kw.items()}, nh, mm)

    emu = run(x, _tile)
    one = run(x, lambda a, w: _tile(a, w, three=False))
    wide = run(x.double(), lambda a, w: a @ w.t())
    dist = _report(f"{form} C={c}", emu, one, plain, wide)
    assert dist[0] <= 1e-5
    assert dist[2] <= 1e-5
