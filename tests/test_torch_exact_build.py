"""The designs of the exact-list render's CUDA kernels (kernel XB,
`gsasr_torch/ops/csrc/exact_build.cu`, and kernel R-exact's walk in
`raster_fwd.cu`) emulated in torch on the CPU, where the kernels cannot run.

XB: the run starts by corner key (each Gaussian writing the keys between
its predecessor's and its own), a block a tile counting the valid members
of its Q runs (the run of corner tile (ty - r, tx - c) for each lattice
offset (r, c) in order), the segments' starts from the counts' chunks, and
a block a tile writing its segment 256 members at a time in index order,
then its pad slots, its table entries and a share of the unused capacity.
Its (list_idx, tab, ok) must equal `exact_tables`' and JAX's
`_exact_tables`' integer for integer, where the lists fit, where they
overflow their capacity, and where a box spans beyond the lattice.

R-exact's walk: a 256-thread block a list tile of 8 x 128, each segment
chunk's occupied slots staged in slot order into lists of at most 512
(pad slots dropped), each warp's 16 x 8 sub-rectangle (lane l: column l %
16, rows l / 16 + 2 p) culling a list 32 boxes at a time, a pair of rows
that a box misses skipped by the warp, a pixel adding a Gaussian whose box
holds it. Every pixel must visit exactly the Gaussians whose box holds it,
each once, in slot order; the image must match the plain list walk and JAX
(Pallas in interpret mode) within 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import rasterizer as jr
from gsasr_torch.ops import rasterizer as tr
from raster_cases import edge_case

TH, TW, GC = 8, 128, 256
# raster_fwd.cu's kThreads, kSubW, kPixPer and kStageCap for R-exact
THREADS, SUB_W, PIX, CAP = 256, 16, 4, 512
LANES = 32


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread: the tier-1 run's workers share the
    cores, and these many small ops spin on a pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tile_of(x, hi, n):
    """exact_build.cu's tile_of: clamp, then PyTorch's floor division in
    float32 (fmod, the quotient, floor)."""
    a = torch.clamp(x, 0.0, float(hi))
    mod = torch.fmod(a, float(n))
    div = (a - mod) / float(n)
    fl = torch.floor(div)
    return (fl + (div - fl > 0.5).float()).to(torch.int64)


def emulate_build(geom, h, w, th, tw, gc, mr, mc, cap):
    """Kernel XB's three launches on geom (S, 16) sorted by corner key:
    (list_idx (cap,), tab (cap // gc,), ok), int32 but ok."""
    sp = geom.shape[0]
    n_th, n_tw = -(-h // th), -(-w // tw)
    nt = n_th * n_tw
    nchunks = cap // gc
    # 1. corner keys, spans and run starts
    xlo, xhi, ylo, yhi = (geom[:, i] for i in (5, 6, 7, 8))
    vis = ((xhi >= 0) & (xlo <= w - 1) & (yhi >= 0) & (ylo <= h - 1)
           & (xhi >= xlo) & (yhi >= ylo))
    fx0, fx1 = _tile_of(xlo, w - 1, tw), _tile_of(xhi, w - 1, tw)
    fy0, fy1 = _tile_of(ylo, h - 1, th), _tile_of(yhi, h - 1, th)
    key = torch.where(vis, fy0 * n_tw + fx0, nt).tolist()
    rows = torch.where(vis, fy1 - fy0 + 1, 0).tolist()
    cols = torch.where(vis, fx1 - fx0 + 1, 0).tolist()
    run_start = [None] * (nt + 2)
    prev = -1
    for i in range(sp):
        for kk in range(prev + 1, key[i] + 1):
            run_start[kk] = i
        prev = key[i]
    for kk in range(prev + 1, nt + 2):
        run_start[kk] = sp
    assert None not in run_start
    rows_t, cols_t = torch.tensor(rows), torch.tensor(cols)

    def members(t, r, c):
        ty, tx = divmod(t, n_tw)
        if ty < r or tx < c:
            return torch.zeros(0, dtype=torch.long)
        k = (ty - r) * n_tw + tx - c
        ids = torch.arange(run_start[k], run_start[k + 1])
        return ids[(r < rows_t[ids]) & (c < cols_t[ids])]

    # 2. counts, and the span check
    runs = [[members(t, r, c) for r in range(mr) for c in range(mc)]
            for t in range(nt)]
    counts = [sum(int(m.numel()) for m in rs) for rs in runs]
    bad = any(r > mr for r in rows) or any(c > mc for c in cols)
    # 3. each tile's segment: members in q order, pad slots, tab entries;
    # then the unused capacity
    chunks = [max(1, -(-n // gc)) for n in counts]
    used = sum(chunks)
    list_idx = torch.full((cap,), -1, dtype=torch.int64)
    tab = torch.full((nchunks,), -1, dtype=torch.int64)
    seg = 0
    for t in range(nt):
        slots = torch.cat(runs[t])
        slots = torch.cat([slots, torch.full((chunks[t] * gc - slots.numel(),),
                                             sp)])
        dest = seg * gc + torch.arange(slots.numel())
        keep = dest < cap
        assert bool((list_idx[dest[keep]] == -1).all()), "a slot twice"
        list_idx[dest[keep]] = slots[keep]
        for j in range(chunks[t]):
            if seg + j < nchunks:
                tab[seg + j] = t * 4 + (2 if j == 0 else 1)
        seg += chunks[t]
    if used < nchunks:
        list_idx[used * gc:] = sp
        tab[used:] = (nt - 1) * 4
    assert bool((list_idx >= 0).all()) and bool((tab >= 0).all())
    return (list_idx.to(torch.int32), tab.to(torch.int32),
            (not bad) and used <= nchunks)


def _sorted_geom(geom, h, w):
    """geom (S, 16) numpy, stably sorted by JAX's corner key."""
    fy0, fx0, _, _, _ = jr._corner_tiles(jnp.asarray(geom.T), h=h, w=w,
                                         th=TH, tw=TW)
    key = np.asarray(fy0) * -(-w // TW) + np.asarray(fx0)
    return geom[np.argsort(key, kind="stable")]


def _mixed(rng, s, size, dmax):
    """tests/test_rasterizer.py's mix, packed at dmax: small to mid sigmas,
    any rho, centers partly off the canvas."""
    sigmas = rng.random((s, 3), dtype=np.float32)
    sigmas[:, :2] = 0.15 * sigmas[:, :2] + 2e-3
    sigmas[:, 2] = 1.8 * sigmas[:, 2] - 0.9
    coords = (2.2 * rng.random((s, 2)) - 1.1).astype(np.float32)
    return np.array(jr.pack_geometry(jnp.asarray(sigmas), jnp.asarray(coords),
                                     size, dmax))


def _fits(rng):
    """800 Gaussians on 48 x 260 at dmax 0.4, the whole canvas as the span:
    the lists fit."""
    h, w = 48, 260
    return _mixed(rng, 800, (h, w), 0.4), h, w, -(-h // TH), -(-w // TW)


def _over_capacity(rng):
    """3000 saturated boxes on 256 x 256 at dmax 0.9: the segments exceed
    the capacity."""
    s, h, w = 3000, 256, 256
    sigmas = 5 * rng.random((s, 3), dtype=np.float32) + 0.5
    sigmas[:, 2] = 0.0
    coords = 2 * rng.random((s, 2), dtype=np.float32) - 1.0
    geom = np.array(jr.pack_geometry(jnp.asarray(sigmas), jnp.asarray(coords),
                                     (h, w), 0.9))
    mr = min(-(-h // TH), (int(0.9 * (h - 1)) + TH - 1) // TH + 1)
    mc = min(-(-w // TW), (int(0.9 * (w - 1)) + TW - 1) // TW + 1)
    return geom, h, w, mr, mc


def _beyond_span(rng):
    """The first case's Gaussians with a lattice of 2 x 1 tiles: boxes span
    more, so ok is false, and the memberships inside the lattice are still
    listed."""
    geom, h, w, _, _ = _fits(rng)
    return geom, h, w, 2, 1


@pytest.mark.parametrize("case,want_ok", [(_fits, True),
                                          (_over_capacity, False),
                                          (_beyond_span, False)])
def test_build_design_matches_tables(rng, case, want_ok):
    geom, h, w, mr, mc = case(rng)
    geom = _sorted_geom(geom, h, w)
    s = geom.shape[0]
    cap = (-(-h // TH) * -(-w // TW) + -(-min(mr * mc, 10) * s // GC) + 1) \
        * GC
    jl, jt, jo = jax.jit(functools.partial(
        jr._exact_tables, h=h, w=w, th=TH, tw=TW, gc=GC, mr=mr, mc=mc,
        cap=cap))(jnp.asarray(geom.T))
    g = torch.from_numpy(geom)
    tl, tt, to = tr.exact_tables(g, h, w, TH, TW, GC, mr, mc, cap)
    el, et, eo = emulate_build(g, h, w, TH, TW, GC, mr, mc, cap)
    assert bool(jo) == bool(to) == eo == want_ok
    for got in (tl, el):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jl))
    for got in (tt, et):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jt).reshape(-1))
    # exact_build takes the plain version on CPU tensors
    bl, bt, bo = tr.exact_build(g, h, w, TH, TW, GC, mr, mc, cap)
    assert torch.equal(bl, tl) and torch.equal(bt, tt) and bool(bo) == eo


def _in_box(g, fx, fy):
    return ((fx >= g[..., 5]) & (fx <= g[..., 6]) & (fy >= g[..., 7])
            & (fy <= g[..., 8]))


def emulate_walk(geom, colors, list_idx, tab, h, w):
    """Kernel R-exact's walk: (image (h, w, 3), order: for each pixel the
    Gaussians it added, in the order it added them)."""
    n = geom.shape[0]
    n_th, n_tw = -(-h // TH), -(-w // TW)
    tab = tab.tolist()
    out = torch.zeros(h, w, 3)
    order = [[] for _ in range(h * w)]
    # lane l's PIX pixels: column l % 16, rows l // 16 + 2 p
    slot = torch.arange(LANES * PIX)
    lane, p = slot % LANES, slot // LANES
    for t in range(n_th * n_tw):
        ti, tj = divmod(t, n_tw)
        ks = [k for k, code in enumerate(tab) if code // 4 == t
              and code % 4]
        assert ks == list(range(ks[0], ks[0] + len(ks)))
        assert tab[ks[0]] == t * 4 + 2
        lists, cur = [], torch.zeros(0, dtype=torch.long)
        for k in ks:
            idx = list_idx[k * GC:(k + 1) * GC].long()
            occ = idx[(idx >= 0) & (idx < n)]
            if cur.numel() + occ.numel() > CAP:
                lists.append(cur)
                cur = torch.zeros(0, dtype=torch.long)
            cur = torch.cat([cur, occ])
        if cur.numel():
            lists.append(cur)
        x0w, y0 = tj * TW, ti * TH
        for warp in range(THREADS // LANES):
            x0 = x0w + warp * SUB_W
            if x0 >= w or y0 >= h:
                continue
            rx1, ry1 = min(x0 + SUB_W, w) - 1, min(y0 + TH, h) - 1
            px = x0 + lane % SUB_W
            py = y0 + lane // SUB_W + 2 * p
            fx, fy = px.float()[:, None], py.float()[:, None]
            acc = torch.zeros(LANES * PIX, 3)
            for ids in lists:
                # the ballots, 32 staged boxes at a time, keep the boxes
                # that meet the sub-rectangle, in list order
                b = geom[ids]
                sel = ids[(b[:, 5] <= rx1) & (b[:, 6] >= x0)
                          & (b[:, 7] <= ry1) & (b[:, 8] >= y0)]
                if not sel.numel():
                    continue
                g = geom[sel]
                # a pair of rows the box misses: the whole warp skips it
                g0 = (y0 + 2 * p).float()[None]
                rows = ~((g[:, 7:8] > g0 + 1) | (g[:, 8:9] < g0))
                add = (rows & _in_box(g[:, None], fx[:, 0], fy[:, 0])).T
                v = _kernel_values(g[:, None], fx[:, 0], fy[:, 0]).T
                terms = torch.where(add[..., None],
                                    v[..., None] * colors[sel], 0.0)
                # each pixel's sum in list order, one add at a time
                acc = torch.cumsum(torch.cat([acc[:, None], terms], 1),
                                   dim=1)[:, -1]
                for j in range(LANES * PIX):
                    if px[j] < w and py[j] < h:
                        order[int(py[j] * w + px[j])] += sel[add[j]].tolist()
            ok = (px < w) & (py < h)
            out[py[ok], px[ok]] = acc[ok]
    return out, order


def _kernel_values(g, fx, fy):
    """The kernel value of Gaussians g (..., 16) at pixels (fx, fy), with
    R's arithmetic (no box mask)."""
    inv_sx, inv_sy, w1, w2, w3, w4 = tr._coeffs(g)
    c2 = 2.0 * g[..., 2] * w3
    dx = fx - g[..., 3]
    dy = fy - g[..., 4]
    return torch.exp(w1 * (w2 * (dx * dx) - c2 * (dx * dy) + w4 * (dy * dy)))


@pytest.mark.parametrize("name", ["edges", "saturated", "wide"])
def test_walk_design_visits_exactly_the_boxes(rng, name):
    """Every pixel adds exactly the Gaussians whose box holds it, each
    once, in slot order; the image matches the plain list walk and JAX's
    exact render of the same Gaussians. "saturated" puts 600 Gaussians on
    every tile, more than one staging list; "wide" spans three tile
    columns, the last ragged."""
    if name == "wide":
        h, w = 45, 300
        geom_np = _mixed(rng, 800, (h, w), 0.2)
        col_np = rng.random((800, 3), dtype=np.float32)
    else:
        geom_np, col_np, (h, w), _ = edge_case(name, rng)
    mr, mc = -(-h // TH), -(-w // TW)
    g, col, _, lists, tab, ok = tr.exact_geometry(
        torch.from_numpy(geom_np), torch.from_numpy(col_np), (h, w), mr, mc)
    assert bool(ok)
    out, order = emulate_walk(g, col, lists, tab, h, w)
    # slot order within each tile's segment
    pos = {}
    for k, code in enumerate(tab.tolist()):
        if code % 4:
            for j, i in enumerate(lists[k * GC:(k + 1) * GC].tolist()):
                if i < g.shape[0]:
                    pos[(code // 4, i)] = k * GC + j
    ys, xs = torch.meshgrid(torch.arange(h).float(), torch.arange(w).float(),
                            indexing="ij")
    inside = _in_box(g[None], xs.reshape(-1, 1), ys.reshape(-1, 1))
    assert int(inside.sum()) > 0
    n_tw = -(-w // TW)
    for pix in range(h * w):
        y, x = divmod(pix, w)
        t = (y // TH) * n_tw + x // TW
        want = sorted(torch.nonzero(inside[pix]).reshape(-1).tolist(),
                      key=lambda i: pos[(t, i)])
        assert order[pix] == want, pix
    ref = tr.raster_fwd_exact_plain(g, col, lists, tab, h, w)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    jref = np.asarray(jr.gs_render_px(jnp.asarray(g.numpy()),
                                      jnp.asarray(col.numpy()), (h, w)))
    np.testing.assert_allclose(out.numpy(), jref, rtol=1e-5, atol=1e-5)
