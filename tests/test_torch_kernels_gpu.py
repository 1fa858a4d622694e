"""The port's CUDA kernels against their plain PyTorch versions, on the
card only (marker `cuda`; run with `python -m pytest -m cuda
tests/test_torch_kernels_gpu.py` on a machine with an H100 and nvcc).
Without a card each test skips. chip_smoke.py makes the same comparisons at
the main path's full shapes."""

import numpy as np
import pytest
import torch

from raster_cases import CASES, edge_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# Kernels R and RB: tests/raster_cases.py's edge cases, a random chunked
# set (a chunk of 72 repeated Gaussians) and chip_smoke.py's phase 37
# init-like workload at full size (720 x 720, 518,400 Gaussians, every box
# at the dmax clamp: the tile cull's worst case)
RASTER_CASES = ["random", *CASES, "init720"]


def _raster_case(cuda, name):
    """(geom, colors, bbox, h, w) on the card, chunked as gs_render_px
    chunks them."""
    from gsasr_torch.ops import rasterizer as tr

    rng = np.random.default_rng(0)
    if name == "random":
        s, h, w = 3000, 100, 150
        sig = rng.random((s, 3), dtype=np.float32)
        sig[:, :2] = 0.05 * sig[:, :2] + 1e-3
        sig[:, 2] = 1.9 * sig[:, 2] - 0.95
        co = (2.4 * rng.random((s, 2)) - 1.2).astype(np.float32)
        col = torch.from_numpy(rng.random((s, 3), dtype=np.float32)).to(cuda)
        geom = tr.pack_geometry(torch.from_numpy(sig).to(cuda),
                                torch.from_numpy(co).to(cuda), (h, w), 0.2)
        geom = torch.cat([geom, geom[:72]])
        col = torch.cat([col, col[:72]])
        return geom, col, tr._chunk_bboxes(geom, 256), h, w
    if name == "init720":
        import chip_smoke as cs

        hw = cs.EXACT_HW
        sigmas, coords, colors = cs.exact_workload("init", cuda)
        geom = tr.pack_geometry(sigmas, coords, (hw, hw), cs.EXACT_DMAX)
        return (*tr.chunk_geometry(geom, colors, (hw, hw)), hw, hw)
    geom, col, (h, w), sort = edge_case(name, rng)
    return (*tr.chunk_geometry(torch.from_numpy(geom).to(cuda),
                               torch.from_numpy(col).to(cuda), (h, w),
                               spatial_sort=sort), h, w)


@pytest.mark.parametrize("name", RASTER_CASES)
def test_raster_fwd_matches_plain(cuda, name):
    """R against its plain version (1e-5: the same terms in another order)
    and the same bits twice."""
    from gsasr_torch.ops import rasterizer as tr

    geom, col, bbox, h, w = _raster_case(cuda, name)
    out = tr.raster_fwd(geom, col, bbox, h, w)
    assert torch.equal(out, tr.raster_fwd(geom, col, bbox, h, w))
    ref = tr.raster_fwd_plain(geom, col, bbox, h, w)
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


@pytest.mark.parametrize("opts,bf16", [("ln_inj", False), ("ln", True),
                                       ("zero_base", True), ("ln", False),
                                       ("odd", False), ("odd", True)])
def test_ln_mlp_ultra_matches_plain_and_repeats(cuda, opts, bf16):
    """M on the tensor cores at the Ultra decoder's 256 tokens and 192
    channels (row tiles of 128 across window boundaries), in both types,
    and at an odd shape (130 channels, a hidden width of 100: the scalar
    paths and the zero padding of the slabs): against the plain version,
    and the same bits twice."""
    from gsasr_torch.ops import fused_layers as tf

    g = torch.Generator(device="cpu").manual_seed(16)
    b, t, c, hid = 9, 256, 192, 192
    if opts == "odd":
        b, t, c, hid = 3, 70, 130, 100
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = dict(w1=r(hid, c) / 14, b1=r(hid), w2=r(c, hid) / 10, b2=r(c))
    if opts != "zero_base":
        kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c))
    if opts in ("ln_inj", "odd"):
        kw.update(inj=r(b, c))
    if opts == "zero_base":
        kw.update(zero_base=True)
    x = r(b, t, c).to(dt)
    n = tf.ln_mlp_residual.launches
    out = tf.ln_mlp_residual(x, **kw)
    assert torch.equal(out, tf.ln_mlp_residual(x, **kw))
    assert tf.ln_mlp_residual.launches == n + 2
    ref = tf.ln_mlp_residual_plain(x, **kw)
    if bf16:
        _assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("opts,bf16", [("paper_cross", False),
                                       ("paper_self", False),
                                       ("rope_cross", True),
                                       ("rope_self", True),
                                       ("odd", False)])
def test_ln_attn_repeats(cuda, opts, bf16):
    """A at the paper decoder's 180 channels in 6 heads of 30 (cross with
    pos, kv and a bias; self with a bias; fp32) and the Enhanced decoder's
    192 with RoPE in bf16, and an odd shape (Tq 100 against Tk 37, 5 heads
    of 12): the same bits twice, A launched and not A-long, and against
    the plain version."""
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import fused_layers as tf

    g = torch.Generator(device="cpu").manual_seed(17)
    b, tq, tk, c, nh = 7, 144, 144, 180, 6
    if opts.startswith("rope"):
        c = 192
    if opts == "odd":
        b, tq, tk, c, nh = 5, 100, 37, 60, 5
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = {k: r(c, c) / 14 if k[0] == "w" else r(c)
          for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c), num_heads=nh)
    if opts.endswith("cross") or opts == "odd":
        kw.update(pos=r(tq, c).to(dt), kv=r(b, tk, c).to(dt))
    if opts.startswith("rope"):
        cos, sin = rope_tables(0.5 * r(2, nh, c // nh // 2), 12, tq)
        kw.update(rope_cos_q=cos, rope_sin_q=sin, rope_cos_k=cos,
                  rope_sin_k=sin)
    else:
        kw.update(bias=0.5 * r(nh, tq, tk))
    x = r(b, tq, c).to(dt)
    n = (tf.ln_attn_proj.launches, tf.ln_attn_proj_long.launches)
    out = tf.ln_attn_proj(x, **kw)
    assert torch.equal(out, tf.ln_attn_proj(x, **kw))
    assert (tf.ln_attn_proj.launches,
            tf.ln_attn_proj_long.launches) == (n[0] + 2, n[1])
    ref = tf.ln_attn_proj_plain(x, **kw)
    if bf16:
        _assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_fused_forward_kernels_fit(cuda):
    """ptxas's report of ln_mlp.cu and ln_attn.cu: M's and A's tensor-core
    kernels (ln_mlp_kernel, ln_qkv_kernel, out_proj_kernel), each in fp32
    and bf16, spill no register, and the per-(window, head) FMA kernel
    they replaced is gone."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["ln_mlp", "ln_attn"])
    found = {}
    for src in ("ln_mlp", "ln_attn"):
        name = None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                assert "attn_heads_kernel" not in name, name
            if not name or not any(k in name for k in (
                    "ln_mlp_kernel", "ln_qkv_kernel", "out_proj_kernel")):
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                found[src, name] = sp.groups()
    assert len(found) == 6, sorted(found)
    assert all(sp == ("0", "0") for sp in found.values()), found


def _attn_inputs(cuda, b, tq, tk, c, nh, bias=True, seed=2):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    return (r(b, tq, c), r(b, tk, c), r(b, tk, c),
            0.5 * r(nh, tq, tk) if bias else None, r(b, tq, c))


# (windows, Tq, Tk, C, heads, bias): the paper decoder's shape with a prime
# window count, Tq != Tk, no bias, and a head width below 32; and the edges
# of WB's 3xTF32 tensor-core tiling: 160 tokens, three keys, and a head
# width of 24
ATTN_CASES = [(37, 144, 144, 180, 6, True), (11, 64, 144, 180, 6, True),
              (13, 144, 100, 180, 6, False), (7, 49, 49, 96, 4, True),
              (9, 160, 160, 192, 6, True), (5, 64, 3, 180, 6, True),
              (6, 144, 144, 144, 6, True)]


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
# shape (36 classes repeated), a prime period with r = 3, no bias; and 160
# tokens (where the bias and mask rows exceed the 3xTF32 body's shared
# memory and WB-long's launches stand in), three, and a head width of 24
MASKED_CASES = [(72, 72, 64, 180, 6, True), (144, 36, 64, 180, 6, True),
                (39, 13, 64, 180, 6, True), (24, 8, 64, 96, 4, False),
                (18, 9, 160, 192, 6, True), (8, 4, 3, 180, 6, True),
                (24, 8, 64, 144, 6, True)]


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


@pytest.mark.parametrize("name", ["chunked", *RASTER_CASES])
def test_raster_bwd_matches_plain_and_repeats(cuda, name):
    """RB against its plain version and the same bits twice; the cull
    boxes' and the pad's columns get exactly zero."""
    from gsasr_torch.ops import rasterizer as tr

    rng = np.random.default_rng(3)
    if name == "chunked":
        s, h, w = 5000, 3 * 64, 96
        sig = rng.random((s, 3), dtype=np.float32)
        sig[:, :2] = 0.04 * sig[:, :2] + 2e-3
        sig[:, 2] = 1.9 * sig[:, 2] - 0.95
        co = (2.2 * rng.random((s, 2)) - 1.1).astype(np.float32)
        geom = tr.pack_geometry(torch.from_numpy(sig).to(cuda),
                                torch.from_numpy(co).to(cuda), (h, w), 0.25)
        col = torch.from_numpy(rng.random((s, 3), dtype=np.float32)).to(cuda)
        geom, col, bbox = tr.chunk_geometry(geom, col, (h, w))
    else:
        geom, col, bbox, h, w = _raster_case(cuda, name)
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


def _assert_bwd_close(out, ref, bf16, scale=None):
    """A backward output against its plain version: float32 as
    _assert_grad_close; an output of a bf16 form within relative L2
    distance 2^-7 of the plain version's (`scale`: the floor of the norm).
    The two round at the same points but sum in another order, so an LN
    output may round one step apart, move a pre-activation across the
    ReLU's 0 and move a whole entry of dz1: single entries move by many
    bf16 steps, and no elementwise bound holds (chip_smoke.py,
    BWD_BF16_TOL)."""
    if not bf16:
        _assert_grad_close(out, ref, scale)
        return
    assert out.dtype == ref.dtype
    d = float((out.double() - ref.double()).norm())
    r = float(ref.double().norm())
    if scale is not None:
        r = max(r, float(scale))
    assert d <= 2 ** -7 * r, (d, r)


@pytest.mark.parametrize("opts,bf16", [("zero_base", False),
                                       ("ln_inj", True), ("ln", True),
                                       ("zero_base", True)])
def test_ln_mlp_bwd_enhanced_forms_match_plain_and_repeats(cuda, opts,
                                                           bf16):
    """MB's Enhanced forms at 192 channels (the weight gradients' 193
    columns): the block tails' zero base, and bf16 activations in the
    decoder's three option sets; twice each, bitwise."""
    from gsasr_torch.ops import fused_layers as tf

    r = _fused_inputs(cuda, 14)
    b, t, c = 7, 144, 192
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = dict(w1=r(c, c) / 14, b1=r(c), w2=r(c, c) / 14, b2=r(c),
              zero_base=opts == "zero_base")
    if opts != "zero_base":
        kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c))
    if opts == "ln_inj":
        kw.update(inj=r(b, c).to(dt))
    x, g = r(b, t, c).to(dt), r(b, t, c).to(dt)
    out = tf.ln_mlp_residual_bwd(x, g, **kw)
    again = tf.ln_mlp_residual_bwd(x, g, **kw)
    ref = tf.ln_mlp_residual_bwd_plain(x, g, **kw)
    for o, a, rf in zip(out, again, ref):
        assert (o is None) == (rf is None)
        if rf is not None:
            assert torch.equal(o, a)  # bitwise repeatable: no atomics
            _assert_bwd_close(o, rf, bf16)


@pytest.mark.parametrize("opts,bf16", [("rope_cross", False),
                                       ("rope_self", False),
                                       ("rope_cross", True),
                                       ("rope_self", True),
                                       ("bias_self", True)])
def test_ln_attn_bwd_enhanced_forms_match_plain_and_repeats(cuda, opts,
                                                            bf16):
    """AB's Enhanced forms at 192 channels and 6 heads of 32: RoPE (cross-
    attention with pos and kv, and self-attention; the four table
    gradients among the outputs) in both types, and the paper's bias form
    in bf16; twice each, bitwise."""
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import fused_layers as tf

    r = _fused_inputs(cuda, 15)
    b, t, c, nh = 5, 144, 192, 6
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = {k: r(c, c) / 14 if k[0] == "w" else r(c)
          for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c), num_heads=nh)
    if opts.endswith("cross"):
        kw.update(pos=r(t, c).to(dt), kv=r(b, t, c).to(dt))
    if opts.startswith("rope"):
        cq, sq = rope_tables(0.5 * r(2, nh, c // nh // 2), 12, t)
        ck, sk = rope_tables(0.5 * r(2, nh, c // nh // 2), 12, t)
        kw.update(rope_cos_q=cq, rope_sin_q=sq, rope_cos_k=ck,
                  rope_sin_k=sk)
    else:
        kw.update(bias=0.5 * r(nh, t, t))
    x, g = r(b, t, c).to(dt), r(b, t, c).to(dt)
    out = tf.ln_attn_proj_bwd(x, g, **kw)
    again = tf.ln_attn_proj_bwd(x, g, **kw)
    ref = tf.ln_attn_proj_bwd_plain(x, g, **kw)
    for i, (o, a, rf) in enumerate(zip(out, again, ref)):
        assert (o is None) == (rf is None)
        if rf is not None:
            assert torch.equal(o, a)  # bitwise repeatable: no atomics
            # dbk (index 8): its true value is 0, held to dwk's scale
            # (with bf16, dwk's norm scaled to C entries)
            floor = None
            if i == 8:
                floor = (ref[7].double().norm() / ref[7].shape[0] ** 0.5
                         if bf16 else ref[7].abs().max())
            _assert_bwd_close(o, rf, bf16, floor)


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


# (windows, Tq, Tk, C, heads, bias) for W-bf16 and WB-bf16 (the tensor-core
# bodies): the Enhanced module path's shape (6 heads of 32, no bias), Tq !=
# Tk with a bias (the paper's bf16 module path), a head width below 32,
# SwinIR's T = 64 with a bias (C = 180, head width 30: 4-byte copies), the
# longest window (160 tokens, ten 16-row tiles) and a head width of 16
BF16_ATTN_CASES = [(37, 144, 144, 192, 6, False), (11, 64, 144, 192, 6, True),
                   (13, 144, 100, 180, 6, True), (7, 49, 49, 96, 4, False),
                   (24, 64, 64, 180, 6, True), (5, 160, 160, 192, 6, True),
                   (9, 144, 144, 64, 4, True)]


@pytest.mark.parametrize("b,tq,tk,c,nh,bias", BF16_ATTN_CASES)
def test_window_attn_bf16_matches_plain_and_repeats(cuda, b, tq, tk, c, nh,
                                                    bias):
    """W-bf16 and WB-bf16 against their plain versions: bf16 out, dq, dk and
    dv within one bf16 step (`_assert_bf16_close`), dbias in f32; WB-bf16
    twice, bitwise; the float32 kernels untouched (no launch)."""
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, g = _attn_inputs(cuda, b, tq, tk, c, nh, bias, seed=10)
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    scale = (c // nh) ** -0.5
    n = (ta.window_attention_packed_fwd.launches,
         ta.window_attention_packed_bwd.launches)
    _assert_bf16_close(
        ta.window_attention_packed_bf16_fwd(q, k, v, bs, scale, nh),
        ta.window_attention_packed_plain(q, k, v, bs, scale, nh))
    out = ta.window_attention_packed_bf16_bwd(q, k, v, bs, g, scale, nh)
    again = ta.window_attention_packed_bf16_bwd(q, k, v, bs, g, scale, nh)
    ref = ta.window_attention_packed_bwd_plain(q, k, v, bs, g, scale, nh)
    assert (out[3] is None) == (not bias)
    for o, a, r in zip(out[:3], again[:3], ref[:3]):
        assert torch.equal(o, a)
        _assert_bf16_close(o, r)
    if bias:
        assert torch.equal(out[3], again[3]) and out[3].dtype == torch.float32
        torch.testing.assert_close(out[3], ref[3], rtol=1e-4,
                                   atol=1e-4 * float(ref[3].abs().max()))
    assert (ta.window_attention_packed_fwd.launches,
            ta.window_attention_packed_bwd.launches) == n


def test_enhanced_bf16_module_step_through_autograd(cuda):
    """A tiny bf16 Enhanced decoder's module path on the card (W-bf16
    forward, WB-bf16 backward, one each per attention) against the same
    module on the CPU: outputs and every parameter's gradient within the
    bf16 trunk's one-step differences carried through its sub-layers
    (2^-8 x 17 of each tensor's largest entry)."""
    import copy

    from gsasr_torch.models import Fea2GSRopeAMP
    from gsasr_torch.models.init import init_weights
    from gsasr_torch.ops import attention as ta

    torch.backends.cudnn.allow_tf32 = False
    m = init_weights(Fea2GSRopeAMP(inchannel=16, channel=24, num_heads=6,
                                   num_crossattn_blocks=1,
                                   num_crossattn_layers=1,
                                   num_selfattn_blocks=1,
                                   num_selfattn_layers=2, num_gs_seed=16,
                                   window_size=4, dtype=torch.bfloat16),
                     torch.Generator().manual_seed(11))
    x = torch.rand(2, 8, 12, 16, generator=torch.Generator().manual_seed(12))
    s = torch.tensor([2.5, 3.5])
    outs = []
    n = (ta.window_attention_packed_bf16_fwd.launches,
         ta.window_attention_packed_bf16_bwd.launches)
    for dev in ("cpu", cuda):
        mm = copy.deepcopy(m).to(dev)
        y = mm(x.to(dev).to(torch.bfloat16), s.to(dev))
        y.square().sum().backward()
        # the dead LayerNorms get no gradient
        outs.append([y.detach().cpu()] + [p.grad.cpu()
                                         for p in mm.parameters()
                                         if p.grad is not None])
    torch.cuda.synchronize()
    assert (ta.window_attention_packed_bf16_fwd.launches - n[0],
            ta.window_attention_packed_bf16_bwd.launches - n[1]) == (3, 3)
    for a, r in zip(*outs):
        tol = 2 ** -8 * 17 * float(r.abs().max())
        torch.testing.assert_close(a, r, rtol=0, atol=tol)


# (windows, Tq, Tk, C, heads, bias, dtype) for W-long and W-long-bf16, the
# window-16 forms: HAT's 256-token windows and OCAB's 256 x 576 (cut to 7
# windows), a ragged query tile and key tile with a bias, a head width
# below 32, and bf16 at 256 x 256; and the edges of W-long-bf16's
# tensor-core tiling: a head width of 30 on packed rows that are not 16-byte
# aligned (C = 180) with a bias, a head width of 24 with Tk not a multiple
# of 16, and three keys; the fp32 twins of those edges for W-long's
# 3xTF32 body, and the paper HAT's 256 x 256 with hd 30 and a bias
LONG_ATTN_CASES = [(7, 256, 256, 192, 6, False, torch.float32),
                   (5, 256, 576, 192, 6, False, torch.float32),
                   (3, 130, 300, 180, 6, True, torch.float32),
                   (4, 200, 161, 96, 4, False, torch.float32),
                   (4, 256, 256, 180, 6, True, torch.float32),
                   (3, 170, 203, 72, 3, True, torch.float32),
                   (2, 161, 3, 64, 2, False, torch.float32),
                   (7, 256, 256, 192, 6, False, torch.bfloat16),
                   (3, 130, 300, 180, 6, True, torch.bfloat16),
                   (4, 200, 161, 96, 4, False, torch.bfloat16),
                   (2, 161, 3, 64, 2, False, torch.bfloat16)]


@pytest.mark.parametrize("b,tq,tk,c,nh,bias,dt", LONG_ATTN_CASES)
def test_window_attn_long_matches_plain_and_repeats(cuda, b, tq, tk, c, nh,
                                                    bias, dt):
    """W-long (W-long-bf16) against the plain version, twice bitwise; the
    T <= 160 kernels are not launched, and the autograd Function takes the
    long forms both ways (its backward WB-long or WB-long-bf16, once)."""
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, _ = _attn_inputs(cuda, b, tq, tk, c, nh, bias, seed=14)
    q, k, v = (x.to(dt) for x in (q, k, v))
    scale = (c // nh) ** -0.5
    long_fwd = (ta.window_attention_packed_long_bf16_fwd
                if dt == torch.bfloat16
                else ta.window_attention_packed_long_fwd)
    n = (ta.window_attention_packed_fwd.launches,
         ta.window_attention_packed_bf16_fwd.launches, long_fwd.launches)
    out = long_fwd(q, k, v, bs, scale, nh)
    assert torch.equal(out, long_fwd(q, k, v, bs, scale, nh))
    ref = ta.window_attention_packed_plain(q, k, v, bs, scale, nh)
    if dt == torch.bfloat16:
        _assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    qg = q.detach().requires_grad_()
    y = ta.window_attention_packed(qg, k, v, bs, num_heads=nh)
    assert torch.equal(y, out)
    assert (ta.window_attention_packed_fwd.launches,
            ta.window_attention_packed_bf16_fwd.launches,
            long_fwd.launches) == (n[0], n[1], n[2] + 3)
    long_bwd = (ta.window_attention_packed_long_bf16_bwd
                if dt == torch.bfloat16
                else ta.window_attention_packed_long_bwd)
    m = (ta.window_attention_packed_bwd.launches,
         ta.window_attention_packed_bf16_bwd.launches, long_bwd.launches)
    y.float().sum().backward()
    assert (ta.window_attention_packed_bwd.launches,
            ta.window_attention_packed_bf16_bwd.launches,
            long_bwd.launches) == (m[0], m[1], m[2] + 1)
    ref = ta.window_attention_packed_bwd_plain(
        q, k, v, bs, torch.ones_like(out), scale, nh)[0]
    if dt == torch.bfloat16:
        _assert_bf16_close(qg.grad, ref)
    else:
        torch.testing.assert_close(qg.grad, ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))


# (windows, Tq, Tk, C, heads, bias, dtype) for WB-long and WB-long-bf16, the
# window-16 forms of WB: a HAB's and the Ultra decoder's 256 x 256 and an
# OCAB's 256 x 576 (6 heads of 32, cut to 9 and 5 windows) in both types,
# a ragged query and key tile with a bias in both types, and a head width
# below 32; and the edges of the tensor-core tilings in both types: a head
# width of 24 with Tk not a multiple of 16 (fp32 also with a bias and Tk
# not a multiple of 8), and three keys
LONG_BWD_CASES = [(9, 256, 256, 192, 6, False, torch.bfloat16),
                  (5, 256, 576, 192, 6, False, torch.bfloat16),
                  (9, 256, 256, 192, 6, False, torch.float32),
                  (5, 256, 576, 192, 6, False, torch.float32),
                  (3, 130, 300, 180, 6, True, torch.float32),
                  (3, 130, 300, 180, 6, True, torch.bfloat16),
                  (4, 200, 161, 96, 4, False, torch.float32),
                  (4, 200, 161, 96, 4, False, torch.bfloat16),
                  (3, 170, 203, 72, 3, True, torch.float32),
                  (2, 161, 3, 64, 2, False, torch.bfloat16),
                  (2, 161, 3, 64, 2, False, torch.float32)]


@pytest.mark.parametrize("b,tq,tk,c,nh,bias,dt", LONG_BWD_CASES)
def test_window_attn_long_bwd_matches_plain_and_repeats(cuda, b, tq, tk, c,
                                                        nh, bias, dt):
    """WB-long (WB-long-bf16) against the plain backward: fp32 dq, dk, dv
    within 1e-4 of each tensor's largest entry, bf16 within one bf16 step
    (`_assert_bf16_close`), dbias f32; twice, bitwise (no atomics, every
    sum in one order); WB and WB-bf16 not launched."""
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, g = _attn_inputs(cuda, b, tq, tk, c, nh, bias, seed=16)
    q, k, v, g = (x.to(dt) for x in (q, k, v, g))
    scale = (c // nh) ** -0.5
    bwd = (ta.window_attention_packed_long_bf16_bwd if dt == torch.bfloat16
           else ta.window_attention_packed_long_bwd)
    n = (ta.window_attention_packed_bwd.launches,
         ta.window_attention_packed_bf16_bwd.launches)
    out = bwd(q, k, v, bs, g, scale, nh)
    again = bwd(q, k, v, bs, g, scale, nh)
    ref = ta.window_attention_packed_bwd_plain(q, k, v, bs, g, scale, nh)
    assert (out[3] is None) == (not bias)
    for o, a, r in zip(out[:3], again[:3], ref[:3]):
        assert torch.equal(o, a)
        if dt == torch.bfloat16:
            _assert_bf16_close(o, r)
        else:
            torch.testing.assert_close(o, r, rtol=1e-4,
                                       atol=1e-4 * float(r.abs().max()))
    if bias:
        assert torch.equal(out[3], again[3]) and out[3].dtype == torch.float32
        torch.testing.assert_close(out[3], ref[3], rtol=1e-4,
                                   atol=1e-4 * float(ref[3].abs().max()))
    assert (ta.window_attention_packed_bwd.launches,
            ta.window_attention_packed_bf16_bwd.launches) == n


# (windows, mask period, Tq, Tk, C, heads, bias, dtype) for the masked
# forms beyond WM and WMB: WM-bf16 and WMB-bf16 at SwinIR's training shape
# (36 classes, cut to 72 windows) and inference shape (cut to 48 classes),
# and at 144 tokens without a bias, 144 queries against 100 keys, 49 and 160
# tokens and a head width of 16; WM-long and WMB-long at the paper HAT's
# 256 x 256 (period 9 and its inference's one class a window, cut), fp32
# and bf16; a ragged query and key tile; no bias and a head width below 32;
# WMB-long at the paper HAT's head width of 30 with Tq != Tk
MASKED_FORM_CASES = [(72, 36, 64, 64, 180, 6, True, torch.bfloat16),
                     (48, 48, 64, 64, 180, 6, True, torch.bfloat16),
                     (8, 4, 144, 144, 192, 6, False, torch.bfloat16),
                     (6, 3, 144, 100, 180, 6, True, torch.bfloat16),
                     (6, 2, 49, 49, 96, 4, True, torch.bfloat16),
                     (4, 2, 160, 160, 192, 6, True, torch.bfloat16),
                     (6, 3, 64, 64, 64, 4, True, torch.bfloat16),
                     (18, 9, 256, 256, 180, 6, True, torch.float32),
                     (18, 9, 256, 256, 180, 6, True, torch.bfloat16),
                     (12, 12, 256, 256, 180, 6, True, torch.bfloat16),
                     (4, 2, 130, 300, 180, 6, True, torch.float32),
                     (6, 3, 256, 256, 96, 4, False, torch.bfloat16),
                     (4, 2, 200, 264, 180, 6, True, torch.float32)]


@pytest.mark.parametrize("b,nw,tq,tk,c,nh,bias,dt", MASKED_FORM_CASES)
def test_window_attn_masked_forms_match_plain_and_repeat(cuda, b, nw, tq, tk,
                                                         c, nh, bias, dt):
    """WM-bf16 and WMB-bf16 (T <= 160), WM-long and WMB-long (fp32 and
    bf16) against their plain versions, each twice, bitwise; the autograd
    Function takes them both ways and launches no other form."""
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, g = _attn_inputs(cuda, b, tq, tk, c, nh, bias, seed=18)
    q, k, v, g = (x.to(dt) for x in (q, k, v, g))
    g32 = torch.Generator(device="cpu").manual_seed(19)
    mask = torch.where(torch.rand(nw, tq, tk, generator=g32) < 0.4, -100.0,
                       0.0).to(cuda)
    scale = (c // nh) ** -0.5
    bf16 = dt == torch.bfloat16
    fwd, bwd = ta._FORMS[True, bf16, max(tq, tk) > ta._MAX_T]
    out = fwd(q, k, v, bs, mask, scale, nh)
    assert torch.equal(out, fwd(q, k, v, bs, mask, scale, nh))
    ref = ta.window_attention_packed_plain(q, k, v, bs, scale, nh, mask)
    grads = bwd(q, k, v, bs, mask, g, scale, nh)
    again = bwd(q, k, v, bs, mask, g, scale, nh)
    refs = ta.window_attention_packed_bwd_plain(q, k, v, bs, g, scale, nh,
                                                mask)
    assert (grads[3] is None) == (not bias)
    for o, a, r in zip((out, *grads), (out, *again), (ref, *refs)):
        if r is None:
            continue
        assert torch.equal(o, a)
        if bf16 and o.dtype == torch.bfloat16:
            _assert_bf16_close(o, r)
        else:
            torch.testing.assert_close(o, r, rtol=1e-4,
                                       atol=1e-4 * float(r.abs().max()))
    counts = lambda: [f.launches for pair in ta._FORMS.values()  # noqa: E731
                      for f in pair]
    n = counts()
    qg = q.detach().requires_grad_()
    y = ta.window_attention_packed(qg, k, v, bs, num_heads=nh,
                                   window_mask=mask)
    assert torch.equal(y, out)
    y.backward(g)
    torch.testing.assert_close(qg.grad, grads[0], rtol=0, atol=0)
    want = [m + (f in (fwd, bwd)) for m, f in
            zip(n, [f for pair in ta._FORMS.values() for f in pair])]
    assert counts() == want


def test_window_attn_bwd_kernels_do_not_spill(cuda):
    """ptxas's report of WB's source (the 3xTF32 tensor-core body that WB,
    WMB, WB4 and their window-16 forms run, and the bf16 bodies), and the
    attention kernels of AB's source (WB's tensor-core bodies: the fp32
    ones as WB and WB-long instantiate them, the bf16 ones in AB's form,
    TO = float): no kernel spills a register to local memory, and neither
    source keeps an FMA attention body."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["window_attn_bwd_long", "ln_attn_bwd_long"])
    for src, key in (("window_attn_bwd_long", ""),
                     ("ln_attn_bwd_long", "window_attn_bwd")):
        spills, name = {}, None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp and key in name:
                spills[name] = sp.groups()
        assert spills and all(v == ("0", "0") for v in spills.values()), \
            spills
        if key:
            assert not any("window_attn_bwd_kernel" in k
                           or "window_attn_bwd_long_q_kernel" in k
                           or "window_attn_bwd_long_kv_kernel" in k
                           for k in spills), sorted(spills)
            # AB: the short 3xTF32 body in its two block sizes, WB-long's
            # two launches; AB-bf16: WB-bf16's body in its three chunk
            # counts, AB-long-bf16: WB-long-bf16's two launches (TO = float)
            assert sum("_short_tf32_" in k for k in spills) == 2, spills
            assert sum("_long_tf32_q_" in k or "_long_tf32_kv_" in k
                       for k in spills) == 2, spills
            assert sum("_short_mma_kernel" in k and "EfEE" in k
                       for k in spills) == 3, spills
            assert sum("_long_mma_" in k and "EfEE" in k
                       for k in spills) == 2, spills
        else:
            assert not any("window_attn_bwd_kernel" in k or "_bwd_4d_" in k
                           for k in spills), sorted(spills)
            assert sum("_long_tf32_" in k for k in spills) == 6, spills
            # WB, WMB and WB4 up to 160 tokens in their two block sizes
            assert sum("_short_tf32_" in k for k in spills) == 6, spills


@pytest.mark.parametrize("opts,bf16", [("ln_inj", False), ("ln", True),
                                       ("zero_base", True), ("ln_inj", True),
                                       ("zero_base", False)])
def test_ln_mlp_bwd_ultra_matches_plain_and_repeats(cuda, opts, bf16):
    """MB at the Ultra decoder's 256 tokens and 192 channels (row tiles of
    128 inside each window; 9 windows) in both types and the decoder's
    three option sets: against the plain version, and the same bits
    twice."""
    from gsasr_torch.ops import fused_layers as tf

    r = _fused_inputs(cuda, 24)
    b, t, c = 9, 256, 192
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = dict(w1=r(c, c) / 14, b1=r(c), w2=r(c, c) / 14, b2=r(c),
              zero_base=opts == "zero_base")
    if opts != "zero_base":
        kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c))
    if opts == "ln_inj":
        kw.update(inj=r(b, c).to(dt))
    x, g = r(b, t, c).to(dt), r(b, t, c).to(dt)
    n = tf.ln_mlp_residual_bwd.launches
    out = tf.ln_mlp_residual_bwd(x, g, **kw)
    again = tf.ln_mlp_residual_bwd(x, g, **kw)
    assert tf.ln_mlp_residual_bwd.launches == n + 2
    ref = tf.ln_mlp_residual_bwd_plain(x, g, **kw)
    for o, a, rf in zip(out, again, ref):
        assert (o is None) == (rf is None)
        if rf is not None:
            assert torch.equal(o, a)  # bitwise repeatable: no atomics
            _assert_bwd_close(o, rf, bf16)


def test_fused_backward_kernels_fit(cuda):
    """ptxas's report of ln_mlp_bwd.cu and ln_attn_bwd.cu: no kernel spills
    a register, MB's and AB's tensor-core kernels are there in fp32 and
    bf16 (MB's two row-tile launches, AB's row products, the weight
    gradients, AB's recompute), and no FMA product or FMA attention kernel
    is left."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["ln_mlp_bwd", "ln_attn_bwd"])
    fma = ("linear_rows_kernel", "wgrad_partial_kernel",
           "window_attn_bwd_kernel", "window_attn_bwd_long_q_kernel",
           "window_attn_bwd_long_kv_kernel")
    spills, name = {}, None
    for src in ("ln_mlp_bwd", "ln_attn_bwd"):
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                assert not any(k in name for k in fma), name
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                spills[src, name] = sp.groups()
    assert spills and all(v == ("0", "0") for v in spills.values()), spills
    for src, key, n in (("ln_mlp_bwd", "ln_fc1_kernel", 2),
                        ("ln_mlp_bwd", "ln_mlp_bwd_kernel", 2),
                        ("ln_mlp_bwd", "wgrad_mma_kernel", 2),
                        ("ln_attn_bwd", "wgrad_mma_kernel", 2),
                        ("ln_attn_bwd", "rows_bwd_kernel", 3),
                        ("ln_attn_bwd", "ln_qkv_kernel", 2)):
        assert sum(s == src and key in k for s, k in spills) == n, \
            (src, key, sorted(spills))


@pytest.mark.parametrize("opts,bf16", [("rope_cross", False),
                                       ("rope_self", False),
                                       ("rope_cross", True),
                                       ("rope_self", True),
                                       ("bias_self", False)])
def test_ln_attn_bwd_long_matches_plain_and_repeats(cuda, opts, bf16):
    """AB-long, the window-16 form of AB, at T = 256, 192 channels and 6
    heads of 32: RoPE cross-attention (pos, kv) and self-attention in both
    types (the Ultra decoder's forms; the four table gradients among the
    outputs) and the bias form in fp32 (dbias, the ordered sum over
    windows); twice bitwise, AB itself not launched; through autograd on
    the card, one AB-long launch per backward."""
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import fused_layers as tf

    r = _fused_inputs(cuda, 16)
    b, t, c, nh = 5, 256, 192, 6
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = {k: r(c, c) / 14 if k[0] == "w" else r(c)
          for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c), num_heads=nh)
    if opts.endswith("cross"):
        kw.update(pos=r(t, c).to(dt), kv=r(b, t, c).to(dt))
    if opts.startswith("rope"):
        cq, sq = rope_tables(0.5 * r(2, nh, c // nh // 2), 16, t)
        ck, sk = rope_tables(0.5 * r(2, nh, c // nh // 2), 16, t)
        kw.update(rope_cos_q=cq, rope_sin_q=sq, rope_cos_k=ck,
                  rope_sin_k=sk)
    else:
        kw.update(bias=0.5 * r(nh, t, t))
    x, g = r(b, t, c).to(dt), r(b, t, c).to(dt)
    n = (tf.ln_attn_proj_bwd.launches, tf.ln_attn_proj_bwd_long.launches)
    out = tf.ln_attn_proj_bwd(x, g, **kw)
    again = tf.ln_attn_proj_bwd(x, g, **kw)
    assert (tf.ln_attn_proj_bwd.launches,
            tf.ln_attn_proj_bwd_long.launches) == (n[0], n[1] + 2)
    ref = tf.ln_attn_proj_bwd_plain(x, g, **kw)
    for i, (o, a, rf) in enumerate(zip(out, again, ref)):
        assert (o is None) == (rf is None)
        if rf is not None:
            assert torch.equal(o, a)  # bitwise repeatable: no atomics
            # dbk (index 8): its true value is 0, held to dwk's scale
            # (with bf16, dwk's norm scaled to C entries)
            floor = None
            if i == 8:
                floor = (ref[7].double().norm() / ref[7].shape[0] ** 0.5
                         if bf16 else ref[7].abs().max())
            _assert_bwd_close(o, rf, bf16, floor)
    xg = x.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tf.ln_attn_proj(xg, **kw), xg, g)
    assert tf.ln_attn_proj_bwd_long.launches == n[1] + 3
    assert torch.equal(dx, out[0])


@pytest.mark.parametrize("opts,bf16", [("rope_cross", False),
                                       ("rope_self", False),
                                       ("rope_cross", True),
                                       ("rope_self", True),
                                       ("bias_self", False),
                                       ("pos_kv_odd", True)])
def test_ln_attn_long_matches_plain_and_repeats(cuda, opts, bf16):
    """A-long, the window-16 form of A, at T = 256, 192 channels and 6 heads
    of 32: RoPE cross-attention (pos, kv) and self-attention in both types
    (the Ultra decoder's forms), the paper's bias form in fp32, and a
    ragged shape (Tq 200 against Tk 300, no RoPE) in bf16; twice bitwise,
    and A itself not launched."""
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import fused_layers as tf

    g = torch.Generator(device="cpu").manual_seed(15)
    b, tq, tk, c, nh = 9, 256, 256, 192, 6
    if opts == "pos_kv_odd":
        tq, tk = 200, 300
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    dt = torch.bfloat16 if bf16 else torch.float32
    kw = {k: r(c, c) / 14 if k[0] == "w" else r(c)
          for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    kw.update(ln_w=1 + 0.1 * r(c), ln_b=0.1 * r(c), num_heads=nh)
    if opts.endswith("cross") or opts == "pos_kv_odd":
        kw.update(pos=r(tq, c).to(dt), kv=r(b, tk, c).to(dt))
    if opts.startswith("rope"):
        cos, sin = rope_tables(0.5 * r(2, nh, c // nh // 2), 16, tq)
        kw.update(rope_cos_q=cos, rope_sin_q=sin, rope_cos_k=cos,
                  rope_sin_k=sin)
    elif opts == "bias_self":
        kw.update(bias=0.5 * r(nh, tq, tk))
    x = r(b, tq, c).to(dt)
    n = (tf.ln_attn_proj.launches, tf.ln_attn_proj_long.launches)
    out = tf.ln_attn_proj(x, **kw)
    assert torch.equal(out, tf.ln_attn_proj(x, **kw))
    assert (tf.ln_attn_proj.launches,
            tf.ln_attn_proj_long.launches) == (n[0], n[1] + 2)
    ref = tf.ln_attn_proj_plain(x, **kw)
    if bf16:
        _assert_bf16_close(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def _trained_like(cuda, s, h, w, sat=False, seed=30):
    """scripts/bench_exact_render.py's Gaussians, cut in count and canvas:
    lattice centers with jitter, sigmas lognormal around 1.1 px (clipped
    to [0.3, 60]), or with `sat` saturated at 300 px; packed at dmax 0.1."""
    from gsasr_torch.ops import rasterizer as tr

    rng = np.random.default_rng(seed)
    half = np.array([(w - 1) / 2.0, (h - 1) / 2.0], np.float32)
    sig = (np.full((s, 2), 300.0, np.float32) if sat else np.clip(
        np.exp(rng.normal(np.log(1.1), 0.7, (s, 2))), 0.3, 60.0))
    sigmas = np.concatenate([sig / half, rng.uniform(-0.6, 0.6, (s, 1))],
                            axis=1).astype(np.float32)
    coords = rng.uniform(-1, 1, (s, 2)).astype(np.float32)
    colors = rng.uniform(0, 0.3, (s, 3)).astype(np.float32)
    return [torch.from_numpy(x).to(cuda) for x in (sigmas, coords, colors)]


def test_raster_fwd_exact_matches_plain_and_repeats(cuda):
    """R-exact against its plain list walk and against R on the same sorted
    Gaussians (1e-5: the same terms in another order), twice bitwise, on a
    canvas that is not a whole number of 8 x 128 list tiles."""
    from gsasr_torch.ops import rasterizer as tr

    h, w = 203, 300
    sigmas, coords, colors = _trained_like(cuda, 40000, h, w)
    geom = tr.pack_geometry(sigmas, coords, (h, w), 0.1)
    mr, mc = tr._exact_spans(h, w, (0.1 * (h - 1) + 1, 0.1 * (w - 1) + 1))
    g, col, bbox, lists, tab, ok = tr.exact_geometry(geom, colors, (h, w),
                                                     mr, mc)
    assert bool(ok)
    n = tr.raster_fwd_exact.launches
    out = tr.raster_fwd_exact(g, col, lists, tab, h, w)
    assert torch.equal(out, tr.raster_fwd_exact(g, col, lists, tab, h, w))
    assert tr.raster_fwd_exact.launches == n + 2
    for ref in (tr.raster_fwd_exact_plain(g, col, lists, tab, h, w),
                tr.raster_fwd(g, col, bbox, h, w)):
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_gs_render_exact_routes_and_differentiates(cuda):
    """gs_render(binning="exact") launches R-exact once and no R on
    trained-like boxes (dmax 0.1), R once and no R-exact on saturated ones
    at dmax 0.5 (about 80 x 128 px boxes, 20 list tiles each: the lists
    overflow); both images and gradients agree with binning="auto" (R, RB)
    on the same Gaussians."""
    from gsasr_torch.ops import rasterizer as tr

    h, w = 160, 256
    for sat, dmax, want in ((False, 0.1, (1, 0)), (True, 0.5, (0, 1))):
        args = _trained_like(cuda, 20000, h, w, sat=sat, seed=31)
        grads = []
        for binning in ("exact", "auto"):
            tens = [x.clone().requires_grad_() for x in args]
            n = (tr.raster_fwd_exact.launches, tr.raster_fwd.launches)
            out = tr.gs_render(*tens, (h, w), dmax, binning=binning)
            if binning == "exact":
                assert (tr.raster_fwd_exact.launches - n[0],
                        tr.raster_fwd.launches - n[1]) == want
                img = out.detach()
            else:
                torch.testing.assert_close(img, out.detach(), rtol=1e-5,
                                           atol=1e-5)
            out.square().sum().backward()
            grads.append([t.grad for t in tens])
        for a, r in zip(*grads):
            _assert_grad_close(a, r)


# (windows, heads, Tq, Tk, hd, bias, dtype) for W4 and WB4 on the 4D
# layout: the decoder's window (cut to 37 windows, prime), rectangular
# without a bias, window 16 (HAT's 256 tokens) and a ragged 130 x 300 with
# a bias, in fp32 and bf16; in bf16 (the tensor-core bodies up to 160
# tokens) also T = 64 with a bias at a head width of 30, 144 tokens
# without a bias, 144 queries against 100 keys, 49 and 160 tokens and a
# head width of 16
ATTN4_CASES = [(37, 6, 144, 144, 30, True, torch.float32),
               (11, 6, 64, 144, 30, False, torch.float32),
               (9, 6, 144, 144, 32, True, torch.bfloat16),
               (5, 6, 256, 256, 32, True, torch.float32),
               (5, 6, 256, 256, 32, False, torch.bfloat16),
               (3, 6, 130, 300, 30, True, torch.float32),
               (7, 6, 64, 64, 30, True, torch.bfloat16),
               (5, 6, 144, 144, 32, False, torch.bfloat16),
               (4, 6, 144, 100, 30, True, torch.bfloat16),
               (3, 4, 49, 49, 24, False, torch.bfloat16),
               (3, 6, 160, 160, 32, True, torch.bfloat16),
               (5, 4, 64, 64, 16, True, torch.bfloat16)]


@pytest.mark.parametrize("b,nh,tq,tk,hd,bias,dt", ATTN4_CASES)
def test_window_attn_4d_matches_plain_and_repeats(cuda, b, nh, tq, tk, hd,
                                                  bias, dt):
    """W4 and WB4 (their bf16 forms; W-long's and WB-long's bodies beyond 160
    tokens) against their plain versions on the head-major layout, each
    twice bitwise; window_attention launches each once and no packed form."""
    from gsasr_torch.ops import attention as ta

    g = torch.Generator(device="cpu").manual_seed(33)
    r = lambda *s: torch.randn(*s, generator=g).to(cuda)  # noqa: E731
    q, k, v, go = (r(b, nh, t, hd).to(dt) for t in (tq, tk, tk, tq))
    bs = 0.5 * r(nh, tq, tk) if bias else None
    scale = hd ** -0.5
    fwd, bwd = ta._FORMS4[dt == torch.bfloat16]
    out = fwd(q, k, v, bs, scale)
    assert torch.equal(out, fwd(q, k, v, bs, scale))
    grads, again = bwd(q, k, v, bs, go, scale), bwd(q, k, v, bs, go, scale)
    refs = (ta.window_attention_plain(q, k, v, bs, scale),
            *ta.window_attention_bwd_plain(q, k, v, bs, go, scale))
    assert (grads[3] is None) == (not bias)
    for o, a, ref in zip((out, *grads), (out, *again), refs):
        if ref is None:
            continue
        assert torch.equal(o, a)
        if o.dtype == torch.bfloat16:
            _assert_bf16_close(o, ref)
        else:
            torch.testing.assert_close(o, ref, rtol=1e-4,
                                       atol=1e-4 * float(ref.abs().max()))
    packed = [f.launches for pair in ta._FORMS.values() for f in pair]
    n = (fwd.launches, bwd.launches)
    qg = q.detach().requires_grad_()
    y = ta.window_attention(qg, k, v, bs)
    assert torch.equal(y, out)
    y.backward(go)
    assert torch.equal(qg.grad, grads[0])
    assert (fwd.launches, bwd.launches) == (n[0] + 1, n[1] + 1)
    assert [f.launches for pair in ta._FORMS.values() for f in pair] == packed


def test_exact_and_4d_kernels_do_not_spill(cuda):
    """ptxas's report: R-exact and the head-major kernels (the tensor-core
    bodies' head-major instantiations, kHM: W4's, W4-long's and WB4's
    3xTF32 bodies, W4-bf16's, WB4-bf16's and their window-16 forms') use no
    local memory for spills."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["raster_fwd_exact", "window_attn_fwd_4d",
                  "window_attn_bwd_4d"])
    for src, key in (("raster_fwd", "raster_fwd_exact"),
                     ("window_attn_fwd", "Lb0ELb1E"),
                     ("window_attn_bwd", "Lb0ELb1E")):
        spills, name = {}, None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp and (key in name or "_4d_" in name):
                spills[name] = sp.groups()
        assert spills and all(v == ("0", "0") for v in spills.values()), \
            spills
        if src != "raster_fwd":
            # W4-long's 3xTF32 body; WB4's two launches
            assert sum("_long_tf32_" in k for k in spills) == \
                (1 if src.endswith("fwd") else 2), sorted(spills)


def test_window16_bf16_mma_kernels_fit(cuda):
    """ptxas's report: the tensor-core bodies of the window-16 forms
    (W-long-bf16, WM-long-bf16, W4-long-bf16 and A-long-bf16's attention;
    WB-long-bf16's two launches and their masked and head-major forms) use
    at most 128 registers, so four 128-thread blocks fit an SM, and the
    fp32 3xTF32 bodies (W-long's forward, its WM-long and W4-long forms and
    A-long's fp32 attention; WB-long's two launches and their WMB-long and
    WB4-long forms) at most 168, three blocks; none spills, and no fp32
    instantiation of the FMA bodies is left in W's and WB's sources."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["window_attn_fwd_long_bf16", "window_attn_bwd_long_bf16",
                  "ln_attn_long"])
    found = {}
    for src in ("window_attn_fwd", "window_attn_bwd", "ln_attn"):
        name = None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                assert "window_attn_bwd_long_q_kernel" not in name and \
                    "window_attn_bwd_long_kv_kernel" not in name and \
                    "window_attn_fwd_long_kernel" not in name and \
                    "attn_long_kernel" not in name, name
            if not name or ("_long_mma_" not in name
                            and "_long_tf32_" not in name):
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                found[src, name] = [sp.groups()]
            reg = re.search(r"Used (\d+) registers", line)
            if reg and (src, name) in found:
                found[src, name].append(int(reg.group(1)))
    # forward, bf16 and fp32: three flag pairs and A-long's each; backward,
    # bf16 and fp32: two launches each of three flag pairs
    assert len(found) == 20, sorted(found)
    assert all(sp == ("0", "0") and r <= (168 if "_tf32_" in name else 128)
               for (_, name), (sp, r) in found.items()), found


def test_short_bf16_mma_kernels_fit(cuda):
    """ptxas's report: the tensor-core bodies of the bf16 forms up to 160
    tokens (W-bf16, WM-bf16 and W4-bf16; WB-bf16, WMB-bf16 and WB4-bf16),
    each flag pair in its three register-array sizes (4, 9 and 10 chunks of
    16 keys), spill no register, and no bf16 instantiation of W's or WB's
    FMA body is left."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["window_attn_fwd_bf16", "window_attn_bwd_bf16"])
    found = {}
    for src in ("window_attn_fwd", "window_attn_bwd"):
        name = None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                assert not ("13__nv_bfloat16" in name and "_mma_" not in name
                            and "_long_" not in name), name
            if not name or "_short_mma_" not in name:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                found[src, name] = sp.groups()
    # three flag pairs (plain, mask, head-major) x three sizes, each source
    assert len(found) == 18, sorted(found)
    assert all(sp == ("0", "0") for sp in found.values()), found


# The fp32 forward up to 160 tokens on the tensor cores (3xTF32,
# window_attn_short_tf32.cuh): (form, windows, Tq, Tk, C, heads, bias, mask
# period): W at the paper step's 144 tokens with a bias (256 windows, 38 a
# step), SwinIR's T = 64 with a bias (576 windows) and WM there with the
# training mask's period 36, 160 x 160, an odd 77 x 100, three keys, a head
# width of 24, and W4 at 144 with a bias and at 64 x 144 without
SHORT_FWD_CASES = [("W", 256, 144, 144, 180, 6, True, 0),
                   ("W", 576, 64, 64, 180, 6, True, 0),
                   ("WM", 576, 64, 64, 180, 6, True, 36),
                   ("WM", 54, 144, 144, 180, 6, False, 9),
                   ("W", 9, 160, 160, 192, 6, True, 0),
                   ("W", 13, 77, 100, 180, 6, True, 0),
                   ("W", 5, 64, 3, 180, 6, True, 0),
                   ("W", 6, 144, 144, 144, 6, True, 0),
                   ("W4", 225, 144, 144, 180, 6, True, 0),
                   ("W4", 11, 64, 144, 180, 6, False, 0)]


@pytest.mark.parametrize("form,b,tq,tk,c,nh,bias,nw", SHORT_FWD_CASES)
def test_short_tf32_fwd_matches_plain_and_repeats(cuda, form, b, tq, tk, c,
                                                  nh, bias, nw):
    """W, WM and W4 on the 3xTF32 body against their plain versions (1e-4
    of max|ref|), twice bitwise, one launch each of the form's wrapper."""
    from gsasr_torch.ops import attention as ta

    q, k, v, bs, _ = _attn_inputs(cuda, b, tq, tk, c, nh, bias, seed=41)
    scale = (c // nh) ** -0.5
    if form == "W4":
        q, k, v = (ta._heads(x, nh).contiguous() for x in (q, k, v))
        fn, wrap = (lambda: ta.window_attention_4d_fwd(q, k, v, bs, scale),
                    ta.window_attention_4d_fwd)
        ref = ta.window_attention_plain(q, k, v, bs, scale)
    elif form == "WM":
        mask = _swin_mask(cuda, nw, tq)
        fn, wrap = (lambda: ta.window_attention_packed_masked_fwd(
            q, k, v, bs, mask, scale, nh), ta.window_attention_packed_masked_fwd)
        ref = ta.window_attention_packed_plain(q, k, v, bs, scale, nh, mask)
    else:
        fn, wrap = (lambda: ta.window_attention_packed_fwd(q, k, v, bs, scale,
                                                           nh),
                    ta.window_attention_packed_fwd)
        ref = ta.window_attention_packed_plain(q, k, v, bs, scale, nh)
    n = wrap.launches
    out = fn()
    assert torch.equal(out, fn())
    assert wrap.launches == n + 2
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


def test_short_tf32_fwd_kernels_fit(cuda):
    """ptxas's report: the 3xTF32 forward body up to 160 tokens in W's
    source (W, WM, W4: three flag pairs), in A's (its fp32 attention) and
    in AB's (att) spills no register, and no FMA forward kernel
    (window_attn_fwd_kernel, _masked_kernel, _4d_kernel) is left."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["window_attn_fwd", "ln_attn", "ln_attn_bwd"])
    fma = ("window_attn_fwd_kernel", "window_attn_fwd_masked_kernel",
           "window_attn_fwd_4d_kernel")
    found = {}
    for src in ("window_attn_fwd", "ln_attn", "ln_attn_bwd"):
        name = None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
                assert not any(k in name for k in fma), name
            if not name or "_short_tf32_kernel" not in name or \
                    "fwd" not in name:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                found[src, name] = sp.groups()
    assert sum(s == "window_attn_fwd" for s, _ in found) == 3, sorted(found)
    assert sum(s == "ln_attn" for s, _ in found) == 1, sorted(found)
    assert sum(s == "ln_attn_bwd" for s, _ in found) == 1, sorted(found)
    assert all(sp == ("0", "0") for sp in found.values()), found


def _phase37_workload(cuda, kind, s=518400, hw=720, seed=0):
    """chip_smoke.py's phase 37 Gaussians (scripts/bench_exact_render.py's):
    lattice centers with jitter; sigmas trained-like (lognormal around 1.1
    px) or init-like (300 px); packed at dmax 0.1 on 720 x 720."""
    from gsasr_torch.ops import rasterizer as tr

    rng = np.random.default_rng(seed)
    half = (hw - 1) / 2.0
    sig = (np.clip(np.exp(rng.normal(np.log(1.1), 0.7, (s, 2))).astype(
        np.float32), 0.3, 60.0) if kind == "trained"
        else np.full((s, 2), 300.0, np.float32))
    sigmas = np.concatenate(
        [sig / half, rng.uniform(-0.6, 0.6, (s, 1)).astype(np.float32)], 1)
    n = int(np.sqrt(s))
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    coords = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    coords += rng.uniform(-1.0 / n, 1.0 / n, coords.shape).astype(np.float32)
    return tr.pack_geometry(torch.from_numpy(sigmas).to(cuda),
                            torch.from_numpy(coords).to(cuda), (hw, hw), 0.1)


@pytest.mark.parametrize("kind,want_ok", [("trained", True),
                                          ("init", False)])
def test_exact_build_matches_tables(cuda, kind, want_ok):
    """Kernel XB against exact_tables (the plain version, torch ops on the
    card) integer for integer on phase 37's two workloads at full size: the
    trained-like lists fit, the init-like ones overflow; twice the same."""
    from gsasr_torch.ops import rasterizer as tr

    hw = 720
    geom = _phase37_workload(cuda, kind)
    mr, mc = tr._exact_spans(hw, hw, (0.1 * (hw - 1) + 1,) * 2)
    fy0, fx0, _, _, _ = tr._corner_tiles(geom, hw, hw, tr._TH_BIN,
                                         tr._TW_BIN)
    perm = torch.argsort(fy0 * tr._cdiv(hw, tr._TW_BIN) + fx0, stable=True)
    g, _ = tr._pad(geom[perm], torch.zeros_like(geom[:, :3]), tr._LIST_ALIGN)
    nt = tr._cdiv(hw, tr._TH_BIN) * tr._cdiv(hw, tr._TW_BIN)
    cap = tr._cdiv(nt * tr._GC_LIST + min(mr * mc, tr._LIST_BUDGET)
                   * g.shape[0], tr._GC_LIST) * tr._GC_LIST
    args = (g, hw, hw, tr._TH_BIN, tr._TW_BIN, tr._GC_LIST, mr, mc, cap)
    n = tr.exact_build.launches
    got = tr.exact_build(*args)
    again = tr.exact_build(*args)
    assert tr.exact_build.launches == n + 2
    ref = tr.exact_tables(*args)
    assert bool(got[2]) == bool(ref[2]) == want_ok
    for a, b, r in zip(got, again, ref):
        assert a.dtype == r.dtype and torch.equal(a, b) and torch.equal(a, r)


def test_exact_build_kernels_fit(cuda):
    """ptxas's report of exact_build.cu and R-exact's walk: no spills."""
    import re

    from gsasr_torch.ops import _build

    _build.build(["exact_build", "raster_fwd_exact"])
    found = {}
    for src, keys in (("exact_build", ("corner_kernel", "count_kernel",
                                       "write_kernel")),
                      ("raster_fwd", ("raster_fwd_exact_kernel",))):
        name = None
        for line in _build.ptxas_report(src).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp and name and any(k in name for k in keys):
                found[name] = sp.groups()
    assert len(found) == 4, sorted(found)
    assert all(sp == ("0", "0") for sp in found.values()), found
