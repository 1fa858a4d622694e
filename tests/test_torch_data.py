"""gsasr_torch's training data pipeline against gsasr_tpu's on the CPU, bit
for bit on the same PNGs and seeds: the continuous-scale samples (both
round modes, the scale clamped to the image, sparse supervision), the
validation pairs, augment_pair, epoch_indices, batch_iterator with 0 and 3
workers, the bicubic resize (C++ core and numpy); and DevicePrefetcher's
conversion, error propagation and close()."""

import random
import threading

import numpy as np
import pytest
import torch

from gsasr_tpu.data import datasets as jds
from gsasr_tpu.data.matlab_resize import imresize as jimresize
from gsasr_tpu.data.matlab_resize import imresize_new as jimresize_new
from gsasr_torch.data import datasets as tds
from gsasr_torch.data.matlab_resize import imresize, imresize_new
from gsasr_torch.data.prefetch import DevicePrefetcher
from gsasr_torch.utils.png import write_png


@pytest.fixture(scope="module")
def gt_folder(tmp_path_factory):
    """Five seeded RGB PNGs of assorted sizes."""
    d = tmp_path_factory.mktemp("gt")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((64, 80), (72, 72), (97, 65), (80, 96),
                                (70, 90))):
        write_png(d / f"{i:02d}.png",
                  (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return str(d)


def _equal(a, b):
    """Two samples or batches: the same keys, dtypes, shapes and bits."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


CASES = {
    "round": dict(round_mode="round"),
    "ceil": dict(round_mode="ceil"),
    "clamp": dict(scale_list=(1.0, 8.0), clamp_scale_to_image=True),
    "list": dict(scale_list=(2.0, 3.0, 4.0)),
    "sparse": dict(sample_size=50),
}


@pytest.mark.parametrize("case", list(CASES))
def test_samples_match_jax(gt_folder, case):
    """The shared-RNG stream (num_workers 0) of eight samples, and three
    per-position RNG samples, bit for bit."""
    kw = dict(lr_size=12, seed=3, **CASES[case])
    ours = tds.ContinuousBicubicDataset([gt_folder], **kw)
    ref = jds.ContinuousBicubicDataset([gt_folder], **kw)
    assert ours.paths == ref.paths and ours.gt_size_max == ref.gt_size_max
    for i in (0, 1, 2, 3, 4, 2, 0, 1):
        _equal(ours[i], ref[i])
    for pos in range(3):
        _equal(ours.sample(pos, random.Random(pos)),
               ref.sample(pos, random.Random(pos)))


def test_paired_dataset_and_augment_match_jax(gt_folder, tmp_path):
    ours = tds.PairedImageDataset(gt_folder, gt_folder, 4)
    ref = jds.PairedImageDataset(gt_folder, gt_folder, 4)
    assert len(ours) == len(ref) == 5
    for i in range(len(ref)):
        _equal(ours[i], ref[i])
    imgs = [np.random.default_rng(s).random((6, 9, 3), dtype=np.float32)
            for s in (1, 2)]
    for seed in range(8):
        a = tds.augment_pair(imgs, True, True, random.Random(seed))
        b = jds.augment_pair(imgs, True, True, random.Random(seed))
        for x, y in zip(a, b):
            assert np.array_equal(x, y) and x.flags.c_contiguous
    with pytest.raises(FileNotFoundError):
        tds.imread_rgb(tmp_path / "missing.png")


@pytest.mark.parametrize("kw", [dict(), dict(enlarge_ratio=3),
                                dict(num_shards=2, shard=1),
                                dict(num_shards=3, shard=2, enlarge_ratio=2)])
def test_epoch_indices_match_jax(kw):
    for n, epoch, seed in ((5, 0, 0), (7, 3, 11), (16, 1, 5)):
        assert np.array_equal(tds.epoch_indices(n, epoch, seed, **kw),
                              jds.epoch_indices(n, epoch, seed, **kw))


@pytest.mark.parametrize("workers", [0, 3])
def test_batch_iterator_matches_jax(gt_folder, workers):
    """Two epochs of batches of 2 over an enlarged set: the same batches,
    bit for bit; with 3 workers the per-position RNGs make them
    independent of thread timing."""
    kw = dict(lr_size=12, scale_list=(1.0, 4.0), round_mode="round", seed=1)
    ours = tds.ContinuousBicubicDataset([gt_folder], **kw)
    ref = jds.ContinuousBicubicDataset([gt_folder], **kw)
    n = 0
    for epoch in (0, 1):
        it = dict(epoch=epoch, seed=1, enlarge_ratio=2, num_workers=workers)
        got = list(tds.batch_iterator(ours, 2, **it))
        want = list(jds.batch_iterator(ref, 2, **it))
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            _equal(a, b)
            n += 1
    assert n == 10


@pytest.mark.parametrize("native", [True, False])
def test_resize_matches_jax(native):
    """imresize_new (C++ core or numpy) and imresize, bit for bit, on RGB
    and gray arrays, down and up, with and without antialiasing."""
    rng = np.random.default_rng(4)
    for shape in ((37, 53, 3), (20, 17)):
        img = rng.random(shape, dtype=np.float32)
        for sh, sw, aa in ((1 / 3.3, 1 / 2.7, True), (0.5, 0.5, True),
                           (2.0, 1.5, True), (0.4, 0.6, False)):
            a = imresize_new(img, sh, sw, aa, use_native=native)
            b = jimresize_new(img, sh, sw, aa, use_native=native)
            assert a.dtype == b.dtype == np.float32
            assert np.array_equal(a, b), (shape, sh, sw, aa)
        assert np.array_equal(imresize(img, 0.25), jimresize(img, 0.25))
    if native:
        from gsasr_torch.native import load
        assert load() is not None


def test_prefetcher_cpu_errors_and_close():
    """On the CPU the prefetcher yields the batches as tensors, the same
    bits; an error in the wrapped iterator is raised in the consumer after
    the batches before it; close() stops the worker and closes the
    generator."""
    batches = [{"lq": np.random.default_rng(i).random((2, 4, 4, 3),
                                                     dtype=np.float32),
                "gt_h": np.int32([5, 6])} for i in range(3)]
    got = list(DevicePrefetcher(iter(batches), device="cpu"))
    assert len(got) == 3
    for a, b in zip(got, batches):
        assert all(torch.is_tensor(v) and v.device.type == "cpu"
                   for v in a.values())
        _equal({k: v.numpy() for k, v in a.items()}, b)

    def failing():
        yield batches[0]
        raise RuntimeError("decode failed")

    it = iter(DevicePrefetcher(failing(), device="cpu"))
    assert next(it)["lq"].shape == (2, 4, 4, 3)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)

    closed = threading.Event()

    def endless():
        try:
            while True:
                yield batches[1]
        finally:
            closed.set()

    pf = DevicePrefetcher(endless(), device="cpu", depth=2)
    it = iter(pf)
    next(it)
    next(it)
    pf.close()
    assert not pf._thread.is_alive()
    assert closed.wait(5)


@pytest.mark.parametrize("ctype,depth", [(2, 8), (6, 16), (0, 4), (3, 8)])
def test_read_png_running_sum_path_matches_cv2(tmp_path, ctype, depth):
    """PNGs whose scanlines take the None, Sub and Up filters only (row r
    under filter r % 3; a Sub row is a running sum along the row, a run of
    Up rows one down the columns), as cv2.imwrite writes at its default
    level and write_png without `adaptive`: the same pixels as
    cv2.imread(IMREAD_COLOR), channels reversed."""
    import cv2

    from gsasr_torch.utils.png import read_png
    from test_torch_infer import _png

    rng = np.random.default_rng(ctype * 7 + depth)
    h, w = 23, 17
    ch = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    top = 200 if ctype == 3 else 1 << depth
    raw = rng.integers(0, top, (h, w, ch))
    path = str(tmp_path / "s.png")
    _png(path, raw, ctype, depth, filters=3,
         palette=rng.integers(0, 256, (200, 3)) if ctype == 3 else None)
    np.testing.assert_array_equal(
        read_png(path), cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1])


def _natural(rng, h, w):
    """A seeded RGB image with a photograph's neighbour correlation: a
    random walk down and across each channel, spread over 0..255."""
    x = rng.standard_normal((h, w, 3)).cumsum(0).cumsum(1)
    x -= x.min((0, 1))
    return (x / x.max((0, 1)) * 255).round().astype(np.uint8)


def _filter_types(path, h):
    import zlib

    from gsasr_torch.utils.png import _chunks

    data = open(path, "rb").read()
    idat = b"".join(b for k, b in _chunks(data, path) if k == b"IDAT")
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[
        :, 0]


@pytest.mark.parametrize("kind", ["noise", "natural", "flat", "narrow"])
def test_write_png_adaptive_filters_match_cv2(tmp_path, kind):
    """write_png(adaptive=True) picks, row by row, the filter that
    cv2.imwrite picks at IMWRITE_PNG_COMPRESSION 3 (libpng's heuristic; the
    level at which BasicSR's extract_subimages writes DIV2K's training
    sub-images), and read_png reads both files as cv2.imread does."""
    import cv2

    from gsasr_torch.utils.png import read_png

    rng = np.random.default_rng(len(kind))
    h, w = (3, 2) if kind == "narrow" else (41, 57)
    img = {"noise": lambda: rng.integers(0, 256, (h, w, 3)),
           "natural": lambda: _natural(rng, h, w),
           "flat": lambda: np.full((h, w, 3), 77),
           "narrow": lambda: rng.integers(0, 256, (h, w, 3))}[kind]()
    img = img.astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    write_png(ours, img, adaptive=True, level=3)
    cv2.imwrite(theirs, img[:, :, ::-1], [cv2.IMWRITE_PNG_COMPRESSION, 3])
    np.testing.assert_array_equal(_filter_types(ours, h),
                                  _filter_types(theirs, h))
    for path in (ours, theirs):
        np.testing.assert_array_equal(read_png(path), img)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1], img)
    if kind == "natural":
        # such files carry Average and Paeth rows, the serial filters
        assert set(_filter_types(theirs, h)) & {3, 4}


def test_read_png_refuses_bad_filter_and_needs_the_library(tmp_path,
                                                           monkeypatch):
    """A filter type past 4 and image data of the wrong length raise a
    ValueError; where the native library cannot be built, reading raises
    a RuntimeError that says why."""
    import struct
    import zlib

    from gsasr_torch import native
    from gsasr_torch.utils.png import SIGNATURE, _chunk, read_png

    def png(scan):
        return (SIGNATURE + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 2, 2, 8, 0, 0, 0, 0)) + _chunk(
                b"IDAT", zlib.compress(bytes(scan))) + _chunk(b"IEND", b""))

    path = tmp_path / "x.png"
    path.write_bytes(png([0, 1, 2, 5, 3, 4]))
    with pytest.raises(ValueError, match="filter type in row 1"):
        read_png(str(path))
    path.write_bytes(png([0, 1, 2, 0, 3]))
    with pytest.raises(ValueError, match="5 bytes, 6 expected"):
        read_png(str(path))
    path.write_bytes(png([0, 1, 2, 4, 3, 4]))
    np.testing.assert_array_equal(read_png(str(path))[:, :, 0],
                                  [[1, 2], [4, 8]])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_error", "g++ failed: no compiler")
    with pytest.raises(RuntimeError, match="no compiler"):
        read_png(str(path))
