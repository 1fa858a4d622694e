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
