"""gsasr_torch's exact-list render forward against gsasr_tpu on the CPU:
`exact_tables` against `_exact_tables` integer for integer (lists, chunk
table, capacity flag) in the ok and the overflow regime, the corner key and
its sort order, gs_render(binning="exact") forward (the plain version of
kernel R-exact, or R where the lists overflow, as JAX decides) and its
gradients against the JAX package (K6, or its windowed fallback, in
interpret mode), the plain list walk against R's plain version, and the
launch arguments of R-exact's wrapper against its C signature."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import rasterizer as jr
from gsasr_torch.ops import rasterizer as tr

TH, TW, GC = 8, 128, 256


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread: the tier-1 run's workers share the
    cores, and these many small ops spin on a pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_gaussians(rng, s):
    """tests/test_rasterizer.py's mix: small to mid sigmas, any rho, centers
    partly off the canvas."""
    sigmas = rng.random((s, 3), dtype=np.float32)
    sigmas[:, :2] = 0.15 * sigmas[:, :2] + 2e-3
    sigmas[:, 2] = 1.8 * sigmas[:, 2] - 0.9
    coords = (2.2 * rng.random((s, 2)) - 1.1).astype(np.float32)
    colors = rng.random((s, 3), dtype=np.float32)
    return sigmas, coords, colors


def _sorted_geom(geom, h, w):
    """geom (S, 16) numpy, stably sorted by JAX's corner key."""
    fy0, fx0, _, _, _ = jr._corner_tiles(jnp.asarray(geom.T), h=h, w=w,
                                         th=TH, tw=TW)
    key = np.asarray(fy0) * -(-w // TW) + np.asarray(fx0)
    return geom[np.argsort(key, kind="stable")]


def _ok_case(rng):
    """test_exact_tables_are_exact's workload: 800 Gaussians on 48 x 260,
    dmax 0.4, the whole canvas as the span; the capacity suffices."""
    s, h, w = 800, 48, 260
    sigmas, coords, _ = _mixed_gaussians(rng, s)
    geom = np.array(jr.pack_geometry(jnp.asarray(sigmas), jnp.asarray(coords),
                                     (h, w), 0.4))
    mr, mc = -(-h // TH), -(-w // TW)
    return geom, h, w, mr, mc, s


def _overflow_case(rng):
    """test_exact_forward_overflow_falls_back's workload: 3000 saturated
    boxes on 256 x 256, dmax 0.9; the lists overflow their capacity."""
    s, h, w = 3000, 256, 256
    sigmas = 5 * rng.random((s, 3), dtype=np.float32) + 0.5
    sigmas[:, 2] = 0.0
    coords = 2 * rng.random((s, 2), dtype=np.float32) - 1.0
    geom = np.array(jr.pack_geometry(jnp.asarray(sigmas), jnp.asarray(coords),
                                     (h, w), 0.9))
    mr = min(-(-h // TH), (int(0.9 * (h - 1)) + TH - 1) // TH + 1)
    mc = min(-(-w // TW), (int(0.9 * (w - 1)) + TW - 1) // TW + 1)
    return geom, h, w, mr, mc, s


@pytest.mark.parametrize("case,want_ok", [(_ok_case, True),
                                          (_overflow_case, False)])
def test_exact_tables_match_jax(rng, case, want_ok):
    """The same lists, chunk table and ok as JAX, integer for integer, on
    the tables' input: Gaussians sorted by the corner key (the key rows'
    searchsorted assumes it), with the JAX tests' capacity."""
    geom, h, w, mr, mc, s = case(rng)
    geom = _sorted_geom(geom, h, w)
    cap = (-(-h // TH) * -(-w // TW) + -(-min(mr * mc, 10) * s // GC) + 1) \
        * GC
    jl, jt, jo = jax.jit(functools.partial(
        jr._exact_tables, h=h, w=w, th=TH, tw=TW, gc=GC, mr=mr, mc=mc,
        cap=cap))(jnp.asarray(geom.T))
    tl, tt, to = tr.exact_tables(torch.from_numpy(geom), h, w, TH, TW, GC, mr,
                                 mc, cap)
    assert bool(jo) == bool(to) == want_ok
    assert tl.dtype == tt.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).reshape(-1))


def test_exact_lists_hold_every_overlap_once(rng):
    """Walking the port's lists gives each (tile, Gaussian) box overlap
    exactly once (the tables' defining property, brute force)."""
    geom, h, w, mr, mc, s = _ok_case(rng)
    geom = _sorted_geom(geom, h, w)
    n_tw = -(-w // TW)
    cap = (-(-h // TH) * n_tw + -(-min(mr * mc, 10) * s // GC) + 1) * GC
    lists, tab, ok = tr.exact_tables(torch.from_numpy(geom), h, w, TH, TW,
                                     GC, mr, mc, cap)
    assert bool(ok)
    got = []
    for k, code in enumerate(tab.tolist()):
        if code % 4:
            got += [(code // 4, i) for i in
                    lists[k * GC:(k + 1) * GC].tolist() if i < s]
    want = set()
    for i, (xlo, xhi, ylo, yhi) in enumerate(geom[:, 5:9].tolist()):
        if xhi < 0 or xlo > w - 1 or yhi < 0 or ylo > h - 1 or xhi < xlo \
                or yhi < ylo:
            continue
        for ti in range(int(max(ylo, 0) // TH), int(min(yhi, h - 1) // TH)
                        + 1):
            for tj in range(int(max(xlo, 0) // TW),
                            int(min(xhi, w - 1) // TW) + 1):
                want.add((ti * n_tw + tj, i))
    assert len(got) == len(set(got)) and set(got) == want


def test_corner_tiles_and_sort_order_match_jax(rng):
    """The corner tiles, extents and visibility of each box, and the stable
    order of their key, as JAX's: boxes partly and wholly off the canvas,
    inverted ones, and exact tile edges."""
    s, h, w = 600, 41, 300
    geom = np.zeros((s, 16), np.float32)
    geom[:, 0:2] = 1.0
    geom[:, 5] = rng.uniform(-80, w + 40, s)
    geom[:, 6] = geom[:, 5] + rng.uniform(-5, 150, s)
    geom[:, 7] = rng.uniform(-30, h + 10, s)
    geom[:, 8] = geom[:, 7] + rng.uniform(-3, 30, s)
    geom[:8, 5:9] = [[128, 255, 8, 15], [127.5, 128, 7.9, 8], [0, 0, 0, 0],
                     [-1, -0.5, 3, 4], [w - 1, w, h - 1, h], [5, 4, 2, 9],
                     [255.9, 256, 39.9, 40], [10, 20, 41, 50]]
    jt = jr._corner_tiles(jnp.asarray(geom.T), h=h, w=w, th=TH, tw=TW)
    tt = tr._corner_tiles(torch.from_numpy(geom), h, w, TH, TW)
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n_tw = -(-w // TW)
    perm = torch.argsort(tt[0] * n_tw + tt[1], stable=True).numpy()
    np.testing.assert_array_equal(
        perm, np.argsort(np.asarray(jt[0]) * n_tw + np.asarray(jt[1]),
                         kind="stable"))


def _jax_route(s, size, dmax):
    """JAX's trace-time decision for gs_render(binning="exact"): the span
    (mr, mc) of its list tiles and whether the lists are built at all."""
    h, w = size
    mbh, mbw = (min(h, dmax * (h - 1) + 1), min(w, dmax * (w - 1) + 1))
    n_th, n_tw = -(-h // TH), -(-w // TW)
    mr = min(n_th, -(-(max(int(np.ceil(mbh)) - 1, 1)) // TH) + 1)
    mc = min(n_tw, -(-(max(int(np.ceil(mbw)) - 1, 1)) // TW) + 1)
    return mr, mc, mr * mc <= 64


# (Gaussians, canvas, dmax): test_exact_forward_matches_reference's shapes;
# the last has no box bound short of the canvas (mr, mc = all of it)
EXACT_CASES = [(512, (40, 140), 0.3), (2048, (64, 256), 0.15),
               (700, (33, 129), 100.0)]


def _spy(monkeypatch):
    """Which forward ran: the names of the plain versions called."""
    calls = []
    for name in ("raster_fwd_exact_plain", "raster_fwd_plain"):
        fn = getattr(tr, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(tr, name, spy)
    return calls


@pytest.mark.parametrize("s,size,dmax", EXACT_CASES)
def test_exact_render_matches_jax(rng, monkeypatch, s, size, dmax):
    """gs_render(binning="exact") against JAX's (1e-5: the same terms summed
    in another order), taking the lists where JAX does: each case's span as
    JAX computes it at trace time, and the lists' ok (equal to JAX's,
    test_exact_tables_match_jax) from the port's tables. All three fit: the
    last spans 5 x 2 list tiles, at most the 10 memberships a Gaussian the
    capacity holds."""
    sigmas, coords, colors = _mixed_gaussians(rng, s)
    ref = np.asarray(jr.gs_render(jnp.asarray(sigmas), jnp.asarray(coords),
                                  jnp.asarray(colors), size, dmax,
                                  binning="exact"))
    mr, mc, fits = _jax_route(s, size, dmax)
    geom = tr.pack_geometry(torch.from_numpy(sigmas),
                            torch.from_numpy(coords), size, dmax)
    assert (mr, mc) == tr._exact_spans(*size, (
        min(size[0], dmax * (size[0] - 1) + 1),
        min(size[1], dmax * (size[1] - 1) + 1)))
    ok = fits and bool(tr.exact_geometry(geom, torch.from_numpy(colors),
                                         size, mr, mc)[5])
    calls = _spy(monkeypatch)
    out = tr.gs_render(torch.from_numpy(sigmas), torch.from_numpy(coords),
                       torch.from_numpy(colors), size, dmax,
                       binning="exact").numpy()
    assert calls == ["raster_fwd_exact_plain" if ok else "raster_fwd_plain"]
    assert ok
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_exact_render_overflow_takes_r(rng, monkeypatch):
    """The saturated workload of test_exact_forward_overflow_falls_back
    overflows the lists (test_exact_tables_match_jax holds JAX's ok false
    there): R renders the corner-sorted Gaussians once, as JAX's windowed
    fallback does, the same image as binning="auto"'s R (1e-4, JAX's own
    test's tolerance between its two paths)."""
    s, size = 3000, (256, 256)
    sigmas = 5 * rng.random((s, 3), dtype=np.float32) + 0.5
    sigmas[:, 2] = 0.0
    coords = 2 * rng.random((s, 2), dtype=np.float32) - 1.0
    colors = rng.random((s, 3), dtype=np.float32)
    a = [torch.from_numpy(x) for x in (sigmas, coords, colors)]
    calls = _spy(monkeypatch)
    out = tr.gs_render(*a, size, 0.9, binning="exact")
    assert calls == ["raster_fwd_plain"]
    torch.testing.assert_close(out, tr.gs_render(*a, size, 0.9), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("binning", ["auto", "on", "off"])
def test_other_binnings_take_r(rng, monkeypatch, binning):
    """Every binning but "exact" renders with R, as before."""
    sigmas, coords, colors = _mixed_gaussians(rng, 300)
    calls = _spy(monkeypatch)
    a = [torch.from_numpy(x) for x in (sigmas, coords, colors)]
    out = tr.gs_render(*a, (40, 140), 0.3, binning=binning)
    assert calls == ["raster_fwd_plain"]
    assert torch.equal(out, tr.gs_render(*a, (40, 140), 0.3))


def test_exact_render_gradients_match_jax(rng):
    """jax.grad through the exact forward and the raster VJP (K4 in
    interpret mode) against autograd through R-exact's and RB's plain
    versions: sigmas, coords, colors within 1e-4 of each gradient's largest
    entry."""
    s, size, dmax = 400, (40, 140), 0.3
    sigmas, coords, colors = _mixed_gaussians(rng, s)
    weight = rng.standard_normal((*size, 3)).astype(np.float32)

    def jloss(sg, co, cl):
        return jnp.sum(jnp.asarray(weight) * jr.gs_render(
            sg, co, cl, size, dmax, binning="exact"))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (sigmas, coords, colors)))
    tens = [torch.from_numpy(x).requires_grad_()
            for x in (sigmas, coords, colors)]
    out = tr.gs_render(*tens, size, dmax, binning="exact")
    (out * torch.from_numpy(weight)).sum().backward()
    for t, g, name in zip(tens, jg, ("sigmas", "coords", "colors")):
        g = np.asarray(g)
        err = np.abs(t.grad.numpy() - g).max() / np.abs(g).max()
        assert err < 1e-4, f"{name}: {err:.2e}"


def test_plain_walk_matches_r_plain(rng):
    """The plain list walk against R's plain version on the same sorted,
    padded Gaussians (1e-5: the same terms, another order), on a canvas that
    is not a whole number of list tiles."""
    sigmas, coords, colors = _mixed_gaussians(rng, 1500)
    h, w = 45, 300
    geom = tr.pack_geometry(torch.from_numpy(sigmas),
                            torch.from_numpy(coords), (h, w), 0.2)
    mr, mc = tr._exact_spans(h, w, (0.2 * (h - 1) + 1, 0.2 * (w - 1) + 1))
    g, col, bbox, lists, tab, ok = tr.exact_geometry(
        geom, torch.from_numpy(colors), (h, w), mr, mc)
    assert bool(ok) and g.shape[0] % 1024 == 0
    out = tr.raster_fwd_exact_plain(g, col, lists, tab, h, w)
    ref = tr.raster_fwd_plain(g, col, bbox, h, w)
    assert out.shape == (h, w, 3)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_exact_wrapper_launch_arguments(monkeypatch):
    """R-exact's wrapper passes its entry point what the C signature
    declares (ctypes and CPU tensors stand in for the library and the card),
    counts the launch, and refuses lists that are not whole chunks."""
    from gsasr_torch.ops import _build

    calls = []
    monkeypatch.setattr(_build, "check_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build, "_libs", {
        n: (lambda *a, _n=n: calls.append((_n, a)) or 0)
        for n in _build.SIGNATURES})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    geom, col = torch.zeros(1024, 16), torch.zeros(1024, 3)
    lists = torch.zeros(3 * GC, dtype=torch.int32)
    tab = torch.zeros(3, dtype=torch.int32)
    meta = torch.empty(0, device="meta")
    n = tr.raster_fwd_exact.launches
    tr.raster_fwd_exact(geom.to("meta"), col, lists, tab, 20, 300)
    assert tr.raster_fwd_exact.launches == n + 1
    (name, args), = calls
    assert name == "raster_fwd_exact"
    sig = _build.SIGNATURES[name]
    assert [a for a, k in zip(args, sig) if k == "i"] == [1024, 3, 20, 300]
    assert args[2] == lists.data_ptr() and args[3] == tab.data_ptr()
    with pytest.raises(ValueError):
        tr.raster_fwd_exact(meta.new_empty(1024, 16), col, lists[:-1], tab,
                            20, 300)
