"""The port's CUDA kernels against their plain PyTorch versions, on the
card only (marker `cuda`; run with `python -m pytest -m cuda
tests/test_torch_kernels_gpu.py` on a machine with an H100 and nvcc).
Without a card each test skips. chip_smoke.py makes the same comparisons at
the main path's full shapes."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_raster_fwd_matches_plain(cuda):
    from gsasr_torch.ops import rasterizer as tr

    rng = np.random.default_rng(0)
    s = 3000
    sig = rng.random((s, 3), dtype=np.float32)
    sig[:, :2] = 0.05 * sig[:, :2] + 1e-3
    sig[:, 2] = 1.9 * sig[:, 2] - 0.95
    co = (2.4 * rng.random((s, 2)) - 1.2).astype(np.float32)
    col = rng.random((s, 3), dtype=np.float32)
    geom = tr.pack_geometry(torch.from_numpy(sig).to(cuda),
                            torch.from_numpy(co).to(cuda), (100, 150), 0.2)
    col_t = torch.from_numpy(col).to(cuda)
    geom = torch.cat([geom, geom[:72]])
    col_t = torch.cat([col_t, col_t[:72]])
    bbox = tr._chunk_bboxes(geom, 256)
    out = tr.raster_fwd(geom, col_t, bbox, 100, 150)
    ref = tr.raster_fwd_plain(geom, col_t, bbox, 100, 150)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opts", ["ln_inj", "ln", "resi"])
def test_ln_mlp_matches_plain(cuda, opts):
    from gsasr_torch.ops import fused_layers as tf

    g = torch.Generator(device="cpu").manual_seed(0)
    b, t, c = 7, 144, 180
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    kw = dict(w1=r(c, c) / 14, b1=r(c), w2=r(c, c) / 14, b2=r(c))
    if opts != "resi":
        kw.update(ln_w=r(c), ln_b=r(c))
    if opts == "ln_inj":
        kw.update(inj=r(b, c))
    if opts == "resi":
        kw.update(resi=r(b, t, c))
    x = r(b, t, c)
    torch.testing.assert_close(tf.ln_mlp_residual(x, **kw),
                               tf.ln_mlp_residual_plain(x, **kw),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cross", [True, False])
def test_ln_attn_matches_plain(cuda, cross):
    from gsasr_torch.ops import fused_layers as tf

    g = torch.Generator(device="cpu").manual_seed(1)
    b, t, c, nh = 5, 144, 180, 6
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    kw = {k: r(c, c) / 14 if k[0] == "w" else r(c)
          for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    kw.update(ln_w=r(c), ln_b=r(c), num_heads=nh, bias=0.02 * r(nh, t, t))
    if cross:
        kw.update(pos=r(t, c), kv=r(b, t, c))
    x = r(b, t, c)
    torch.testing.assert_close(tf.ln_attn_proj(x, **kw),
                               tf.ln_attn_proj_plain(x, **kw),
                               rtol=1e-4, atol=1e-4)


def _attn_inputs(cuda, b, tq, tk, c, nh, bias=True, seed=2):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    return (r(b, tq, c), r(b, tk, c), r(b, tk, c),
            0.5 * r(nh, tq, tk) if bias else None, r(b, tq, c))


# (windows, Tq, Tk, C, heads, bias): the paper decoder's shape with a prime
# window count, Tq != Tk, no bias, and a head width below 32
ATTN_CASES = [(37, 144, 144, 180, 6, True), (11, 64, 144, 180, 6, True),
              (13, 144, 100, 180, 6, False), (7, 49, 49, 96, 4, True)]


@pytest.mark.parametrize("b,tq,tk,c,nh,bias", ATTN_CASES)
def test_window_attn_fwd_matches_plain(cuda, b, tq, tk, c, nh, bias):
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, _ = _attn_inputs(cuda, b, tq, tk, c, nh, bias)
    scale = (c // nh) ** -0.5
    torch.testing.assert_close(
        ta.window_attention_packed_fwd(q, k, v, bs, scale, nh),
        ta.window_attention_packed_plain(q, k, v, bs, scale, nh),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,tq,tk,c,nh,bias", ATTN_CASES)
def test_window_attn_bwd_matches_plain_and_repeats(cuda, b, tq, tk, c, nh,
                                                   bias):
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, g = _attn_inputs(cuda, b, tq, tk, c, nh, bias)
    scale = (c // nh) ** -0.5
    out = ta.window_attention_packed_bwd(q, k, v, bs, g, scale, nh)
    again = ta.window_attention_packed_bwd(q, k, v, bs, g, scale, nh)
    ref = ta.window_attention_packed_bwd_plain(q, k, v, bs, g, scale, nh)
    assert (out[3] is None) == (not bias)
    for o, a, r in zip(out, again, ref):
        if r is None:
            continue
        assert torch.equal(o, a)  # bitwise repeatable: no atomics
        # per-output scale: dbias sums b windows of ds
        tol = 1e-4 * float(r.abs().max())
        torch.testing.assert_close(o, r, rtol=1e-4, atol=tol)


def test_raster_bwd_matches_plain_and_repeats(cuda):
    from gsasr_torch.ops import rasterizer as tr

    rng = np.random.default_rng(3)
    s, h, w = 5000, 3 * 64, 96
    sig = rng.random((s, 3), dtype=np.float32)
    sig[:, :2] = 0.04 * sig[:, :2] + 2e-3
    sig[:, 2] = 1.9 * sig[:, 2] - 0.95
    co = (2.2 * rng.random((s, 2)) - 1.1).astype(np.float32)
    geom = tr.pack_geometry(torch.from_numpy(sig).to(cuda),
                            torch.from_numpy(co).to(cuda), (h, w), 0.25)
    col = torch.from_numpy(rng.random((s, 3), dtype=np.float32)).to(cuda)
    geom, col, bbox = tr.chunk_geometry(geom, col, (h, w))
    g = torch.from_numpy(rng.standard_normal((h, w, 3)).astype(
        np.float32)).to(cuda)
    out = tr.raster_bwd(geom, col, bbox, g, h, w)
    again = tr.raster_bwd(geom, col, bbox, g, h, w)
    ref = tr.raster_bwd_plain(geom, col, bbox, g, h, w)
    for o, a, r in zip(out, again, ref):
        assert torch.equal(o, a)  # bitwise repeatable: no atomics
        # moment sums over many pixels cancel: scale by each column's max
        tol = 1e-4 * r.abs().amax(dim=0) + 1e-4 * r.abs()
        assert bool(((o - r).abs() <= tol).all())
    assert torch.all(out[0][:, 5:] == 0)


def _assert_grad_close(out, ref, scale=None):
    """|out - ref| <= 1e-4 (the column's largest |ref|, a vector's largest,
    or `scale`) + 1e-4 |ref|: sums over 36,864 rows and over windows
    cancel, so an entry's error follows its column's scale."""
    r = ref.reshape(-1, ref.shape[-1]) if ref.dim() >= 2 else ref.reshape(1, -1)
    if scale is None:
        scale = r.abs().amax(dim=0) if ref.dim() >= 2 else r.abs().max()
    err = (out.reshape(r.shape) - r).abs()
    assert bool((err <= 1e-4 * scale + 1e-4 * r.abs()).all()), float(err.max())


def _fused_inputs(cuda, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731


@pytest.mark.parametrize("opts", ["ln_inj", "ln", "resi"])
def test_ln_mlp_bwd_matches_plain_and_repeats(cuda, opts):
    from gsasr_torch.ops import fused_layers as tf

    r = _fused_inputs(cuda, 4)
    b, t, c = 7, 144, 180
    kw = dict(w1=r(c, c) / 14, b1=r(c), w2=r(c, c) / 14, b2=r(c))
    if opts != "resi":
        kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c))
    if opts == "ln_inj":
        kw.update(inj=r(b, c))
    if opts == "resi":
        kw.update(resi=r(b, t, c))
    x, g = r(b, t, c), r(b, t, c)
    out = tf.ln_mlp_residual_bwd(x, g, **kw)
    again = tf.ln_mlp_residual_bwd(x, g, **kw)
    ref = tf.ln_mlp_residual_bwd_plain(x, g, **kw)
    for o, a, rf in zip(out, again, ref):
        assert (o is None) == (rf is None)
        if rf is not None:
            assert torch.equal(o, a)  # bitwise repeatable: no atomics
            _assert_grad_close(o, rf)


@pytest.mark.parametrize("cross", [True, False])
def test_ln_attn_bwd_matches_plain_and_repeats(cuda, cross):
    from gsasr_torch.ops import fused_layers as tf

    r = _fused_inputs(cuda, 5)
    b, t, c, nh = 5, 144, 180, 6
    kw = {k: r(c, c) / 14 if k[0] == "w" else r(c)
          for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c), num_heads=nh,
              bias=0.5 * r(nh, t, t))
    if cross:
        kw.update(pos=r(t, c), kv=r(b, t, c))
    x, g = r(b, t, c), r(b, t, c)
    out = tf.ln_attn_proj_bwd(x, g, **kw)
    again = tf.ln_attn_proj_bwd(x, g, **kw)
    ref = tf.ln_attn_proj_bwd_plain(x, g, **kw)
    for i, (o, a, rf) in enumerate(zip(out, again, ref)):
        assert (o is None) == (rf is None)
        if rf is not None:
            assert torch.equal(o, a)  # bitwise repeatable: no atomics
            # dbk (index 8): its true value is 0, so both sides are
            # float32 noise, held to dwk's scale
            _assert_grad_close(o, rf, ref[7].abs().max() if i == 8 else None)


def test_fused_layers_backward_through_autograd(cuda):
    """On the card, ln_mlp_residual and ln_attn_proj differentiate through
    kernels MB and AB: one launch each per backward, none under no_grad."""
    from gsasr_torch.ops import fused_layers as tf

    r = _fused_inputs(cuda, 6)
    b, t, c, nh = 3, 144, 180, 6
    x = r(b, t, c).requires_grad_()
    mlp = dict(w1=r(c, c) / 14, b1=r(c), w2=r(c, c) / 14, b2=r(c),
               ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c))
    attn = {k: r(c, c) / 14 if k[0] == "w" else r(c)
            for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    attn.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c), num_heads=nh,
                bias=0.5 * r(nh, t, t))
    n_mb, n_ab = tf.ln_mlp_residual_bwd.launches, tf.ln_attn_proj_bwd.launches
    with torch.no_grad():
        tf.ln_attn_proj(tf.ln_mlp_residual(x, **mlp), **attn)
    y = tf.ln_attn_proj(tf.ln_mlp_residual(x, **mlp), **attn)
    (dx,) = torch.autograd.grad(y.square().sum(), x)
    torch.cuda.synchronize()
    assert tf.ln_mlp_residual_bwd.launches == n_mb + 1
    assert tf.ln_attn_proj_bwd.launches == n_ab + 1
    assert bool(torch.isfinite(dx).all())


def test_bias_table_bwd_matches_plain_and_repeats(cuda):
    from gsasr_torch.models.fea2gs import self_attn_rel_pos_index
    from gsasr_torch.ops import bias_table as bt

    index = self_attn_rel_pos_index(12)
    inv = torch.from_numpy(bt.inverse_index(index, 23 ** 2)).to(cuda)
    g = _fused_inputs(cuda, 7)(6, 144, 144)
    out = bt.bias_table_bwd(g, inv)
    again = bt.bias_table_bwd(g, inv)
    assert torch.equal(out, again)  # bitwise repeatable: no atomics
    # up to 144 entries a row summed in another order
    _assert_grad_close(out, bt.bias_table_bwd_plain(g, inv),
                       out.abs().max())
