"""The arithmetic of kernels MB and AB (and AB-long) on the tensor cores,
emulated in torch on the CPU.

fp32: the row products of csrc/tile_mma.cuh and csrc/tile_mma_bwd.cuh in
3xTF32 (each f32 operand as big = tf32(x), small = tf32(x - big), three
products a k-step, small_a big_b + big_a small_b + big_a big_b), in the
kernel's slabs of 16 columns and its slot order, terms added into one
accumulator in order: MB's recomputed fc1, g w2 (masked), dz1 w1; AB's
recomputed q, k, v, g wo and dxq / dkv; MB's pre-activations near 0 take
the f32 sum's sign, as its FMA chain decides them. The weight gradients
dW = D^T X as
wgrad_mma_kernel forms them: the rows cut into at most 128 groups of
group_rows(M) rows, each group's partial summed k-step by k-step (8 rows
in 3xTF32), the bias as the f32 column sums of D row by row, and the
partials summed in group order. AB's attention between the products is
the plain fp32 version's (its 3xTF32 bodies have their own emulation in
tests/test_torch_attention.py). Each output is held within 1e-5 of
max|float64 reference| at the paper (180 channels, 6 heads of 30) and
Enhanced (192, 6 heads of 32) widths, and against jax.vjp of the JAX
package's ln_mlp_residual and ln_attn_proj (K9 and K10 in interpret mode)
at tests/test_torch_fused_backward.py's tolerance. 1xTF32's distance (each
operand rounded once) is printed (`-s`), not asserted.

bf16: AB-bf16's attention as its tensor-core body forms it (WB-bf16's
body in its AB form): p and ds rounded once to bf16 as the operands of dv,
dq and dk, D from the unrounded p, the products summed chunk by chunk of
16 keys (queries) in f32, and held against ln_attn_proj_bwd_plain in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import fused_layers as jf
from gsasr_torch.models.fea2gs_rope_fast import rope_tables
from gsasr_torch.ops import fused_layers as tf

# A slab of 16 columns in two k-steps of 8: slot t of k-step s is column
# 4 t + 2 s, slot t + 4 is column 4 t + 2 s + 1 (tile_mma.cuh).
_SLAB = [4 * t + 2 * s + h for s in range(2) for h in (0, 1)
         for t in range(4)]
_EPS = 1e-5
# (channels, heads): the paper decoder's and the Enhanced decoder's widths
WIDTHS = {"paper": (180, 6), "enhanced": (192, 6)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread, as the other files that
    run beside the JAX tests in the six-worker run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x):
    """x rounded to tf32 as the kernels round it (tf32_rna: a 10-bit
    mantissa, to the nearest, ties away from zero), by bit operations on
    the f32 word."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def _step(a, b, acc, three):
    """acc + a @ b for one k-step in tf32: three products (small_a big_b,
    big_a small_b, big_a big_b) or one (big_a big_b)."""
    ab, bb = _tf32(a), _tf32(b)
    if three:
        acc = acc + _tf32(a - ab) @ bb
        acc = acc + ab @ _tf32(b - bb)
    return acc + ab @ bb


class Arith:
    """The kernels' products: `rows(terms)` = sum_t a_t @ w_t^T (w_t (N,
    K)) as tile_mma accumulates them, and `wgrad(D, X)` = (D^T X, D's column
    sums) as wgrad_mma_kernel forms them; in 3xTF32 or 1xTF32 on f32
    tensors."""

    def __init__(self, three=True):
        self.three = three

    def rows(self, terms):
        acc = None
        for a, w in terms:
            k = a.shape[-1]
            pad = -k % 16
            a = torch.nn.functional.pad(a, (0, pad))
            b = torch.nn.functional.pad(w, (0, pad)).t()
            if acc is None:
                acc = torch.zeros(*a.shape[:-1], w.shape[0])
            for k0 in range(0, k + pad, 16):
                idx = torch.tensor([k0 + c for c in _SLAB])
                x, y = a[..., idx], b[idx]
                for j in range(0, 16, 8):
                    acc = _step(x[..., j:j + 8], y[j:j + 8], acc, self.three)
        return acc

    def wgrad(self, d, x):
        d, x = d.flatten(0, -2), x.flatten(0, -2)
        m = d.shape[0]
        per = -(-m // 128)
        r = -(-per // 16) * 16  # group_rows
        dw = torch.zeros(d.shape[1], x.shape[1])
        db = torch.zeros(d.shape[1])
        for r0 in range(0, m, r):
            part = torch.zeros_like(dw)
            bsum = torch.zeros_like(db)
            for k0 in range(r0, min(r0 + r, m), 8):
                dk, xk = d[k0:k0 + 8], x[k0:k0 + 8]
                part = _step(dk.t(), xk, part, self.three)
                for row in dk:
                    bsum = bsum + row
            dw, db = dw + part, db + bsum
        return dw, db

    def pre(self, h, w, b):
        """MB's recomputed pre-activation h w^T + b: the tile product, and
        where it lies within 2^-14 ||h_r|| ||w_n|| of 0 (kSignTol of
        ln_mlp_bwd.cu) the f32 value of the sum in column order, whose sign
        the kernel's FMA chain decides there."""
        z = self.rows([(h, w)]) + b
        near = z.abs() <= 2.0 ** -14 * (h.norm(dim=-1, keepdim=True)
                                        * w.norm(dim=-1))
        exact = (h.double() @ w.double().t()).float() + b
        return torch.where(near, exact, z)


class F64:
    """The same products in float64: the reference."""

    @staticmethod
    def rows(terms):
        return sum(a @ w.t() for a, w in terms)

    @staticmethod
    def pre(h, w, b):
        return h @ w.t() + b

    @staticmethod
    def wgrad(d, x):
        d, x = d.flatten(0, -2), x.flatten(0, -2)
        return d.t() @ x, d.sum(0)


def _ln_stats(t):
    mu = t.mean(-1, keepdim=True)
    var = (t - mu).square().mean(-1, keepdim=True)
    inv = 1 / torch.sqrt(var + _EPS)
    return (t - mu) * inv, inv


def _ln_bwd(dh, y, inv, w):
    dyh = dh * w
    dt = inv * (dyh - dyh.mean(-1, keepdim=True)
                - y * (dyh * y).mean(-1, keepdim=True))
    return dt, (dh * y).flatten(0, -2).sum(0), dh.flatten(0, -2).sum(0)


def _mb(x, g, kw, ar):
    """MB's VJP of ln_mlp_residual (base x + inj), returned as
    ln_mlp_residual_bwd returns it, with its products taken by `ar`."""
    t = x + kw["inj"][:, None, :]
    y, inv = _ln_stats(t)
    h = y * kw["ln_w"] + kw["ln_b"]
    z1p = ar.pre(h, kw["w1"], kw["b1"])
    z1 = torch.relu(z1p)
    dz1 = ar.rows([(g, kw["w2"].t())]) * (z1p > 0)
    dh = ar.rows([(dz1, kw["w1"].t())])
    dt, dlnw, dlnb = _ln_bwd(dh, y, inv, kw["ln_w"])
    dt = dt + g
    dw2, db2 = ar.wgrad(g, z1)
    dw1, db1 = ar.wgrad(dz1, h)
    return dict(x=dt, inj=dt.sum(1), ln_w=dlnw, ln_b=dlnb, w1=dw1, b1=db1,
                w2=dw2, b2=db2)


def _shuffle(x):
    p = x.unflatten(-1, (-1, 2))
    return torch.stack([-p[..., 1], p[..., 0]], -1).flatten(-2)


def _heads(t, nh):
    b, n, c = t.shape
    return t.reshape(b, n, nh, c // nh).transpose(1, 2)


def _merge(t):
    b, nh, n, hd = t.shape
    return t.transpose(1, 2).reshape(b, n, nh * hd)


def _ab(x, g, kw, nh, ar):
    """AB's VJP of ln_attn_proj (paper bias or Enhanced RoPE; cross with pos
    and kv, or self), returned by argument name, with its row products and
    weight gradients taken by `ar` and the attention in x's type."""
    c = x.shape[-1]
    scale = (c // nh) ** -0.5
    y, inv = _ln_stats(x)
    xq = y * kw["ln_w"] + kw["ln_b"]
    if "pos" in kw:
        xq = xq + kw["pos"]
    src = kw.get("kv", xq)
    q0 = ar.rows([(xq, kw["wq"])]) + kw["bq"]
    k0 = ar.rows([(src, kw["wk"])]) + kw["bk"]
    v = ar.rows([(src, kw["wv"])]) + kw["bv"]
    rope = "rope_cos_q" in kw
    if rope:
        q = q0 * kw["rope_cos_q"] + _shuffle(q0) * kw["rope_sin_q"]
        k = k0 * kw["rope_cos_k"] + _shuffle(k0) * kw["rope_sin_k"]
    else:
        q, k = q0, k0
    qh, kh, vh = _heads(q, nh), _heads(k, nh), _heads(v, nh)
    s = qh @ kh.transpose(-1, -2) * scale
    if "bias" in kw:
        s = s + kw["bias"]
    p = torch.softmax(s, -1)
    att = _merge(p @ vh)
    gh = _heads(ar.rows([(g, kw["wo"].t())]), nh)
    dv = _merge(p.transpose(-1, -2) @ gh)
    dp = gh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = _merge(ds @ kh) * scale
    dk = _merge(ds.transpose(-1, -2) @ qh) * scale
    out = {}
    if rope:
        out.update(rope_cos_q=(dq * q0).sum(0),
                   rope_sin_q=(dq * _shuffle(q0)).sum(0),
                   rope_cos_k=(dk * k0).sum(0),
                   rope_sin_k=(dk * _shuffle(k0)).sum(0))
        dq = dq * kw["rope_cos_q"] + _shuffle(dq) * -kw["rope_sin_q"]
        dk = dk * kw["rope_cos_k"] + _shuffle(dk) * -kw["rope_sin_k"]
    terms = [(dk, kw["wk"].t()), (dv, kw["wv"].t())]
    if "kv" in kw:
        dxq = ar.rows([(dq, kw["wq"].t())])
        out["kv"] = ar.rows(terms)
    else:
        dxq = ar.rows([(dq, kw["wq"].t())] + terms)
    if "pos" in kw:
        out["pos"] = dxq.sum(0)
    out["x"], out["ln_w"], out["ln_b"] = _ln_bwd(dxq, y, inv, kw["ln_w"])
    for n, (d, xs) in (("o", (g, att)), ("q", (dq, xq)), ("k", (dk, src)),
                       ("v", (dv, src))):
        out[f"w{n}"], out[f"b{n}"] = ar.wgrad(d, xs)
    if "bias" in kw:
        out["bias"] = ds.sum(0)
    return out


def _mlp_args(rng, b, t, c):
    a = {"x": rng.standard_normal((b, t, c)),
         "inj": rng.standard_normal((b, c)),
         "ln_w": 1 + 0.1 * rng.standard_normal(c),
         "ln_b": 0.1 * rng.standard_normal(c)}
    bound = 1 / np.sqrt(c)
    for n in ("1", "2"):
        a[f"w{n}"] = rng.uniform(-bound, bound, (c, c))
        a[f"b{n}"] = rng.uniform(-bound, bound, c)
    return {k: v.astype(np.float32) for k, v in a.items()}


def _attn_args(rng, opts, b, t, c, nh):
    a = {"x": rng.standard_normal((b, t, c)),
         "ln_w": 1 + 0.1 * rng.standard_normal(c),
         "ln_b": 0.1 * rng.standard_normal(c)}
    bound = 1 / np.sqrt(c)
    for n in "qkvo":
        a[f"w{n}"] = rng.uniform(-bound, bound, (c, c))
        a[f"b{n}"] = rng.uniform(-bound, bound, c)
    if "cross" in opts:
        a["pos"] = rng.standard_normal((t, c))
        a["kv"] = rng.standard_normal((b, t, c))
    if "bias" in opts:
        a["bias"] = 0.5 * rng.standard_normal((nh, t, t))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    if "rope" in opts:
        end = int(round(t ** 0.5))
        freqs = torch.from_numpy(
            (0.5 * rng.standard_normal((2, nh, c // nh // 2))).astype(
                np.float32))
        cos, sin = rope_tables(freqs, end, t)
        a.update(rope_cos_q=cos.numpy(), rope_sin_q=sin.numpy(),
                 rope_cos_k=cos.numpy(), rope_sin_k=sin.numpy())
    return a


def _torch(args, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in args.items()}


def _check(got, ref, one, label):
    """got within 1e-5 of max|ref| per output; one's distance printed."""
    for n, r in ref.items():
        scale = float(r.abs().max())
        if n == "bk":  # true value 0: float32 noise, held to dwk's scale
            scale = float(ref["wk"].abs().max())
        d3 = float((got[n].double() - r).abs().max())
        d1 = float((one[n].double() - r).abs().max())
        print(f"{label} d{n}: 3xTF32 {d3 / scale:.2e}, 1xTF32 "
              f"{d1 / scale:.2e} of max|ref|")
        assert d3 <= 1e-5 * scale, (label, n, d3, scale)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mb_tf32_arithmetic(width):
    """MB's products and weight gradients in 3xTF32 at 3 windows of 144
    tokens against float64."""
    c, _ = WIDTHS[width]
    args = _mlp_args(np.random.default_rng(1), 3, 144, c)
    g = np.random.default_rng(2).standard_normal((3, 144, c)).astype(
        np.float32)
    ref = _mb(*(torch.from_numpy(v).double() for v in (args["x"], g)),
              _torch(args, torch.float64), F64)
    kw = _torch(args, torch.float32)
    got = _mb(kw["x"], torch.from_numpy(g), kw, Arith())
    one = _mb(kw["x"], torch.from_numpy(g), kw, Arith(three=False))
    _check(got, ref, one, f"MB {width}")


@pytest.mark.parametrize("width,opts", [("paper", "bias_cross"),
                                        ("paper", "bias_self"),
                                        ("enhanced", "rope_cross"),
                                        ("enhanced", "rope_self")])
def test_ab_tf32_arithmetic(width, opts):
    """AB's products and weight gradients in 3xTF32 at 2 windows of 144
    tokens against float64: the paper decoder's bias forms and the
    Enhanced decoder's RoPE forms (the table gradients among the
    outputs)."""
    c, nh = WIDTHS[width]
    args = _attn_args(np.random.default_rng(3), opts, 2, 144, c, nh)
    g = np.random.default_rng(4).standard_normal((2, 144, c)).astype(
        np.float32)
    kw64 = _torch(args, torch.float64)
    ref = _ab(kw64["x"], torch.from_numpy(g).double(), kw64, nh, F64)
    kw = _torch(args, torch.float32)
    got = _ab(kw["x"], torch.from_numpy(g), kw, nh, Arith())
    one = _ab(kw["x"], torch.from_numpy(g), kw, nh, Arith(three=False))
    _check(got, ref, one, f"AB {width} {opts}")


def _jax_vjp(fn, args, g):
    """jax.vjp of fn at the numpy args (weights transposed to JAX's
    layout), gradients back in the port's layout, by name."""
    names = list(args)
    tr = {n for n in names if n[0] == "w" and len(n) == 2}

    def f(*vals):
        return fn(**dict(zip(names, vals)))

    vals = [jnp.asarray(args[n].T if n in tr else args[n]) for n in names]
    _, vjp = jax.vjp(f, *vals)
    return {n: (np.asarray(d).T if n in tr else np.asarray(d))
            for n, d in zip(names, vjp(jnp.asarray(g)))}


def _assert_close(got, ref, name, scale=None):
    """tests/test_torch_fused_backward.py's tolerance: 1e-5 of the column's
    largest |ref| (or `scale`) + 1e-5 |ref|."""
    r = ref.reshape(-1, ref.shape[-1]) if ref.ndim >= 2 else ref.reshape(1, -1)
    if scale is None:
        scale = np.abs(r).max(axis=0) if ref.ndim >= 2 else np.abs(r).max()
    err = np.abs(np.asarray(got).reshape(r.shape) - r)
    assert not (err > 1e-5 * scale + 1e-5 * np.abs(r)).any(), \
        (name, float(err.max()), float(np.abs(r).max()))


@pytest.mark.parametrize("width", list(WIDTHS))
def test_mb_emulation_matches_jax(width):
    """The 3xTF32 emulation of MB against jax.vjp of ln_mlp_residual (K9
    in interpret mode) at 3 windows of 16 tokens."""
    c, _ = WIDTHS[width]
    args = _mlp_args(np.random.default_rng(5), 3, 16, c)
    g = np.random.default_rng(6).standard_normal((3, 16, c)).astype(
        np.float32)
    want = _jax_vjp(lambda x, **kw: jf.ln_mlp_residual(x, **kw), args, g)
    kw = _torch(args, torch.float32)
    got = _mb(kw["x"], torch.from_numpy(g), kw, Arith())
    for n in args:
        _assert_close(got[n].numpy(), want[n], n)


@pytest.mark.parametrize("width,opts", [("paper", "bias_cross"),
                                        ("enhanced", "rope_self")])
def test_ab_emulation_matches_jax(width, opts):
    """The 3xTF32 emulation of AB against jax.vjp of ln_attn_proj (K10 in
    interpret mode) at 3 windows of 16 tokens."""
    c, nh = WIDTHS[width]
    args = _attn_args(np.random.default_rng(7), opts, 3, 16, c, nh)
    g = np.random.default_rng(8).standard_normal((3, 16, c)).astype(
        np.float32)
    want = _jax_vjp(lambda x, **kw: jf.ln_attn_proj(x, num_heads=nh, **kw),
                    args, g)
    kw = _torch(args, torch.float32)
    got = _ab(kw["x"], torch.from_numpy(g), kw, nh, Arith())
    for n in args:
        # the k bias's true gradient is 0: noise, held to wk's scale
        _assert_close(got[n].numpy(), want[n], n,
                      np.abs(want["wk"]).max() if n == "bk" else None)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _attn_bwd_bf16_tiles(q, k, v, g, bias, scale):
    """AB-bf16's attention backward as WB-bf16's body forms it in its AB
    form, per (window, head) on bf16-valued f32 tensors (B, nh, T, hd): p
    of each query row in f32; D = sum_j p dp in key order; ds = p (dp -
    D); dq += bf16(ds) k over chunks of 16 keys and dv += bf16(p)^T g, dk
    += bf16(ds)^T q over chunks of 16 queries, each chunk's products into
    f32 sums in chunk order. Returns (dq, dk, dv, ds)."""
    s = q @ k.transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, -1)
    dp = g @ v.transpose(-1, -2)
    d = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - d)
    dsr, pr = _bf(ds), _bf(p)
    tq, tk = q.shape[-2], k.shape[-2]
    dq = torch.zeros_like(q)
    for j in range(0, tk, 16):
        dq = dq + dsr[..., j:j + 16] @ k[..., j:j + 16, :]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(0, tq, 16):
        dv = dv + pr[..., i:i + 16, :].transpose(-1, -2) @ g[..., i:i + 16, :]
        dk = dk + dsr[..., i:i + 16, :].transpose(-1, -2) @ q[..., i:i + 16, :]
    return dq * scale, dk * scale, dv, ds


def _ab_bf16(x, g, kw, nh):
    """AB-bf16's VJP, rounding where _k_ln_attn_bwd rounds (xq, q, k, v, p,
    att, g wo^T, ds, dq0, dk0, dv, the weights), its attention as
    _attn_bwd_bf16_tiles forms it; outputs as ln_attn_proj_bwd_plain's."""
    c = x.shape[-1]
    scale = (c // nh) ** -0.5
    w = {n: _bf(kw[f"w{n}"]) for n in "qkvo"}
    y, inv = _ln_stats(x.float())
    xq = y * kw["ln_w"] + kw["ln_b"]
    if "pos" in kw:
        xq = xq + kw["pos"].float()
    xq = _bf(xq)
    src = kw["kv"].float() if "kv" in kw else xq
    q0, k0 = xq @ w["q"].t() + kw["bq"], src @ w["k"].t() + kw["bk"]
    v = src @ w["v"].t() + kw["bv"]
    rope = "rope_cos_q" in kw
    if rope:
        q = q0 * kw["rope_cos_q"] + _shuffle(q0) * kw["rope_sin_q"]
        k = k0 * kw["rope_cos_k"] + _shuffle(k0) * kw["rope_sin_k"]
    else:
        q, k = q0, k0
    qh, kh, vh = (_heads(_bf(t), nh) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2) * scale
    if "bias" in kw:
        s = s + kw["bias"]
    att = _bf(_merge(_bf(torch.softmax(s, -1)) @ vh))
    gf = g.float()
    gh = _heads(_bf(gf @ w["o"]), nh)
    dq, dk, dv, ds = _attn_bwd_bf16_tiles(qh, kh, vh, gh, kw.get("bias"),
                                          scale)
    dq, dk, dv = _merge(dq), _merge(dk), _merge(dv)
    tables = (None,) * 4
    if rope:
        tables = ((dq * q0).sum(0), (dq * _shuffle(q0)).sum(0),
                  (dk * k0).sum(0), (dk * _shuffle(k0)).sum(0))
        dq = dq * kw["rope_cos_q"] + _shuffle(dq) * -kw["rope_sin_q"]
        dk = dk * kw["rope_cos_k"] + _shuffle(dk) * -kw["rope_sin_k"]
    dqd, dkd, dvd = _bf(dq), _bf(dk), _bf(dv)
    dxq = dqd @ w["q"]
    dsrc = dkd @ w["k"] + dvd @ w["v"]
    if "kv" not in kw:
        dxq = dxq + dsrc
    dx, dlnw, dlnb = _ln_bwd(dxq, y, inv, kw["ln_w"])
    bf = torch.bfloat16

    def wg(d, xs):
        return d.flatten(0, -2).t() @ xs.flatten(0, -2)

    return (dx.to(bf), dxq.sum(0).to(bf) if "pos" in kw else None,
            dsrc.to(bf) if "kv" in kw else None, dlnw, dlnb,
            wg(dqd, xq), dq.flatten(0, -2).sum(0), wg(dkd, src),
            dk.flatten(0, -2).sum(0), wg(dvd, src), dv.flatten(0, -2).sum(0),
            wg(gf, att), gf.flatten(0, -2).sum(0),
            ds.sum(0) if "bias" in kw else None, *tables)


@pytest.mark.parametrize("opts", ["rope_self", "rope_cross", "bias_self"])
def test_ab_bf16_attention_single_rounding(opts):
    """AB-bf16 with its attention as the tensor-core body forms it (p and
    ds rounded once, in the tile order) against ln_attn_proj_bwd_plain in
    bf16, 2 windows of 144 tokens at the Enhanced width: every output
    within relative L2 2^-7 (the card tests' bf16 tolerance; dbk, whose
    true value is 0, against dwk's norm scaled to C entries)."""
    c, nh = WIDTHS["enhanced"]
    args = _attn_args(np.random.default_rng(9), opts, 2, 144, c, nh)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 144, c)).astype(np.float32)).to(torch.bfloat16)
    kw = _torch(args, torch.float32)
    for n in ("x", "pos", "kv"):
        if n in kw:
            kw[n] = kw[n].to(torch.bfloat16)
    x = kw.pop("x")
    got = _ab_bf16(x, g, kw, nh)
    ref = tf.ln_attn_proj_bwd_plain(x, g, num_heads=nh, **kw)
    for i, (o, r) in enumerate(zip(got, ref)):
        assert (o is None) == (r is None), i
        if r is None:
            continue
        assert o.dtype == r.dtype, i
        d = float((o.double() - r.double()).norm())
        n = float(r.double().norm())
        if i == 8:
            n = max(n, float(ref[7].double().norm()) / c ** 0.5)
        print(f"AB-bf16 {opts} output {i}: relative L2 {d / n:.2e}")
        assert d <= 2 ** -7 * n, (i, d, n)
