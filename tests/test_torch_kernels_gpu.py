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


def _assert_bf16_close(out, ref):
    """bf16 forms: both sides round at the same places but sum their f32
    products in another order, which can move a rounded intermediate by one
    bf16 step: |out - ref| <= 2^-7 |ref| + 2^-8 max|ref|."""
    assert out.dtype == ref.dtype == torch.bfloat16
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    tol = 2 ** -7 * r.abs() + 2 ** -8 * float(r.abs().max())
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("opts,bf16", [("zero_base", False),
                                       ("zero_base", True), ("ln_inj", True),
                                       ("ln", True), ("resi", True)])
def test_ln_mlp_enhanced_forms_match_plain(cuda, opts, bf16):
    """M's Enhanced forms at 192 channels: the bare MLP of the block tails,
    and bf16 activations (the inject and FFN chains, the paper tail)."""
    from gsasr_torch.ops import fused_layers as tf

    g = torch.Generator(device="cpu").manual_seed(8)
    b, t, c = 7, 144, 192
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = dict(w1=r(c, c) / 14, b1=r(c), w2=r(c, c) / 14, b2=r(c))
    if opts in ("ln_inj", "ln"):
        kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c))
    if opts == "ln_inj":
        kw.update(inj=r(b, c).to(dt))
    if opts == "resi":
        kw.update(resi=r(b, t, c).to(dt))
    if opts == "zero_base":
        kw.update(zero_base=True)
    x = r(b, t, c).to(dt)
    out, ref = tf.ln_mlp_residual(x, **kw), tf.ln_mlp_residual_plain(x, **kw)
    if bf16:
        _assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("opts,bf16", [("rope_cross", False),
                                       ("rope_self", False),
                                       ("rope_cross", True),
                                       ("rope_self", True),
                                       ("bias_self", True)])
def test_ln_attn_enhanced_forms_match_plain(cuda, opts, bf16):
    """A's Enhanced forms at 192 channels and 6 heads of 32: RoPE on q and k
    (cross-attention with pos and kv, and self-attention), in both types,
    and the paper's bias form in bf16."""
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import fused_layers as tf

    g = torch.Generator(device="cpu").manual_seed(9)
    b, t, c, nh = 5, 144, 192, 6
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = {k: r(c, c) / 14 if k[0] == "w" else r(c)
          for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c), num_heads=nh)
    if opts.endswith("cross"):
        kw.update(pos=r(t, c).to(dt), kv=r(b, t, c).to(dt))
    if opts.startswith("rope"):
        cos, sin = rope_tables(0.5 * r(2, nh, c // nh // 2), 12, t)
        kw.update(rope_cos_q=cos, rope_sin_q=sin, rope_cos_k=cos,
                  rope_sin_k=sin)
    else:
        kw.update(bias=0.5 * r(nh, t, t))
    x = r(b, t, c).to(dt)
    out, ref = tf.ln_attn_proj(x, **kw), tf.ln_attn_proj_plain(x, **kw)
    if bf16:
        _assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


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


# (windows, mask period nW, T, C, heads, bias): SwinIR's inference shape
# (one 192x192 image: 576 window classes) cut to 72 windows, its training
# shape (36 classes repeated), a prime period with r = 3, no bias
MASKED_CASES = [(72, 72, 64, 180, 6, True), (144, 36, 64, 180, 6, True),
                (39, 13, 64, 180, 6, True), (24, 8, 64, 96, 4, False)]


def _swin_mask(cuda, nw, t, seed=4):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.where(torch.rand(nw, t, t, generator=g) < 0.4, -100.0,
                       0.0).to(cuda)


@pytest.mark.parametrize("b,nw,t,c,nh,bias", MASKED_CASES)
def test_window_attn_masked_matches_plain_and_repeats(cuda, b, nw, t, c, nh,
                                                      bias):
    """WM and WMB against their plain versions; WMB twice, bitwise."""
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, g = _attn_inputs(cuda, b, t, t, c, nh, bias)
    mask = _swin_mask(cuda, nw, t)
    scale = (c // nh) ** -0.5
    torch.testing.assert_close(
        ta.window_attention_packed_masked_fwd(q, k, v, bs, mask, scale, nh),
        ta.window_attention_packed_plain(q, k, v, bs, scale, nh, mask),
        rtol=1e-4, atol=1e-4)
    out = ta.window_attention_packed_masked_bwd(q, k, v, bs, mask, g, scale,
                                                nh)
    again = ta.window_attention_packed_masked_bwd(q, k, v, bs, mask, g,
                                                  scale, nh)
    ref = ta.window_attention_packed_bwd_plain(q, k, v, bs, g, scale, nh,
                                               mask)
    assert (out[3] is None) == (not bias)
    for o, a, r in zip(out, again, ref):
        if r is None:
            continue
        assert torch.equal(o, a)
        tol = 1e-4 * float(r.abs().max())
        torch.testing.assert_close(o, r, rtol=1e-4, atol=tol)


def test_window_attn_masked_refuses_bad_period(cuda):
    """No fallback on the card: a period that does not divide the window
    count, or T above the kernels' limit, raises before any launch."""
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, g = _attn_inputs(cuda, 10, 64, 64, 180, 6)
    n = ta.window_attention_packed_masked_fwd.launches
    with pytest.raises(ValueError, match="multiple"):
        ta.window_attention_packed_masked_fwd(q, k, v, bs,
                                              _swin_mask(cuda, 4, 64), 0.2, 6)
    big = torch.zeros(2, 169, 180, device=cuda)
    with pytest.raises(ValueError, match="T <="):
        ta.window_attention_packed_masked_bwd(
            big, big, big, None, torch.zeros(1, 169, 169, device=cuda), big,
            0.2, 6)
    assert ta.window_attention_packed_masked_fwd.launches == n


def test_swinir_block_through_autograd(cuda):
    """A shifted SwinIR block on the card (WM forward, WMB backward, T for
    its bias table) against the same block on the CPU."""
    import copy

    from gsasr_torch.models.init import init_weights
    from gsasr_torch.models.swinir import SwinIRNOUP

    torch.backends.cudnn.allow_tf32 = False
    m = init_weights(SwinIRNOUP(embed_dim=60, depths=(2,), num_heads=(6,),
                                drop_path_rate=0.0),
                     torch.Generator().manual_seed(5))
    x = torch.rand(2, 24, 16, 3, generator=torch.Generator().manual_seed(6))
    outs = []
    for dev in ("cpu", cuda):
        mm = copy.deepcopy(m).to(dev)
        y = mm(x.to(dev))
        y.square().sum().backward()
        outs.append([y.detach().cpu()] + [p.grad.cpu()
                                         for p in mm.parameters()])
    for a, r in zip(*outs):
        tol = 1e-4 * float(r.abs().max())
        torch.testing.assert_close(a, r, rtol=1e-4, atol=tol)


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
