"""The port's inference entry point on the CPU: `tiling.paste_tiles` and
`tiling.split_and_joint_image` against the JAX package's, the PNG codec
against OpenCV, and `gsasr_torch.cli.infer.main` on a PNG with a
reference-format checkpoint pair against the port's own `sr_forward` /
`split_and_joint_image`.

The JAX side runs its fused decoder in interpret mode, once per scale;
its weights come from port modules drawn with the reference initializers
(the JAX package's reference converter reads them), as in
tests/test_torch_model.py.
"""

import functools
import math
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from gsasr_torch.utils.png import SIGNATURE, read_png, write_png

# tests/test_tiling.py's tiny configuration and request
TINY_ENC = dict(num_feat=8, num_block=1)
TINY_DEC = dict(inchannel=8, channel=12, num_heads=6, num_crossattn_blocks=1,
                num_crossattn_layers=1, num_selfattn_blocks=1,
                num_selfattn_layers=1, num_gs_seed=16, window_size=4)
TILE = dict(split_size=12, overlap_size=4, crop_size=2, dmax=0.5,
            tile_batch=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread, restored after the file:
    the full-width CLI requests ran 60 to 130 times slower in the
    six-worker suite, each worker's thread pool spinning on the same
    cores, than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("th,tw,split,stride,crop,fractional", [
    (2, 2, 8, 6, 2, False), (2, 3, 10, 7, 1, True),
    # tests/test_tiling.py's last-column case: interior rows of the last
    # column keep their top rows
    (3, 2, 8, 6, 2, True)])
def test_paste_tiles_matches_jax(th, tw, split, stride, crop, fractional):
    from gsasr_tpu.tiling import paste_tiles as jpaste
    from gsasr_torch.tiling import paste_tiles

    tiles = np.random.default_rng(th * tw).random(
        (th * tw, split, split, 3), dtype=np.float32)
    out = paste_tiles(tiles, th, tw, stride, split, crop,
                      fractional=fractional)
    np.testing.assert_array_equal(out, jpaste(tiles, th, tw, stride, split,
                                              crop, fractional=fractional))


@pytest.mark.parametrize("encoder,version", [("edsr", "paper"),
                                              ("swinir", "enhanced")])
def test_make_models_decoder_kwargs_match_jax(encoder, version):
    """make_models(..., decoder_kwargs=...) builds the decoder JAX's
    make_models builds: the kwargs over the version's settings."""
    from gsasr_tpu.model import make_models as jmake
    from gsasr_torch.model import make_models

    kw = dict(channel=24, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=2, num_selfattn_blocks=1, num_gs_seed=16,
              window_size=4)
    _, dec = make_models(encoder, version, decoder_kwargs=kw, device="cpu")
    _, jdec = jmake(encoder, version, decoder_kwargs=kw)
    for name in ("channel", "num_heads", "num_gs_seed", "window_size"):
        assert getattr(dec, name) == getattr(jdec, name), name
    for kind in ("crossattn", "selfattn"):
        stack = getattr(dec, f"{'window' if kind == 'crossattn' else 'gs'}_"
                             f"{kind}_blocks")
        assert len(stack) == getattr(jdec, f"num_{kind}_blocks")
        assert len(stack[0].blocks) == getattr(jdec, f"num_{kind}_layers")


@pytest.fixture(scope="module")
def tiny():
    """JAX and port tiny EDSR + paper Fea2GS on the same weights. JAX's
    tiler jits its encoder and decoder anew on every call; while the
    module's tests run, those jits are kept per module, so the second
    scale reuses the first's encoder and decoder programs (the same tile
    shapes; the scale is an argument) and compiles only its render."""
    import gsasr_tpu.model as jmodel
    import gsasr_tpu.tiling as jtiling
    from gsasr_tpu.models import EDSRNOUP as JEDSR
    from gsasr_tpu.models import Fea2GS as JFea2GS
    from gsasr_tpu.utils.torch_convert import convert_edsr, convert_fea2gs
    from gsasr_torch.models import EDSRNOUP, Fea2GS
    from gsasr_torch.models.init import init_weights

    g = torch.Generator().manual_seed(8)
    enc = init_weights(EDSRNOUP(**TINY_ENC), g).eval()
    dec = init_weights(Fea2GS(**TINY_DEC), g).eval()
    ep = convert_edsr(enc.state_dict())
    dp = convert_fea2gs(dec.state_dict(), num_gs_seed=16, window_size=4,
                        num_heads=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtiling, "_jitted_apply",
                   functools.lru_cache(maxsize=None)(jmodel._jitted_apply))
        yield JEDSR(**TINY_ENC), JFea2GS(**TINY_DEC), ep, dp, enc, dec


@pytest.mark.parametrize("scale", [2.0, 2.5])
def test_split_and_joint_matches_jax(tiny, scale):
    """tests/test_tiling.py's request (20 x 28, tiles of 12 overlapping by
    4, JAX's last batch of 4 padded with zeros, the port's not) within 1e-4
    absolute, the port's sr_forward tolerance against JAX: the raster sums
    its Gaussians in another order than the Pallas walk, on top of the
    decoder's float32 differences."""
    from gsasr_tpu.tiling import split_and_joint_image as jsplit
    from gsasr_torch.tiling import split_and_joint_image

    jenc, jdec, ep, dp, enc, dec = tiny
    lq = np.random.default_rng(1).random((1, 20, 28, 3), dtype=np.float32)
    kw = dict(TILE)
    split, overlap = kw.pop("split_size"), kw.pop("overlap_size")
    ref = jsplit(lq, scale, split, overlap, jenc, jdec, ep, dp, **kw)
    out = split_and_joint_image(lq, scale, split, overlap, enc, dec,
                                device="cpu", **kw)
    assert out.shape == ref.shape and out.dtype == np.float32
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------


def _png(path, raw, ctype, depth, *, palette=None, trns=None,
         interlace=0, filters=5):
    """A PNG of the samples `raw` (H, W, channels) written independently of
    the codec under test: scanlines packed MSB first, row r under filter
    r % filters (None, Sub, Up, Average, Paeth; filters=3 the first three
    only), one zlib stream."""
    h, w, ch = raw.shape
    bits = ch * depth
    bpp = max(1, bits // 8)
    if depth == 16:
        rows = raw.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = raw.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        v = raw[:, :, 0].astype(np.uint8)
        v = np.pad(v, ((0, 0), (0, -w % per)))
        v = v.reshape(h, -1, per) << np.arange(8 - depth, -1, -depth,
                                               dtype=np.uint8)
        rows = np.bitwise_or.reduce(v, axis=2).astype(np.uint8)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for r in range(h):
        x = rows[r].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - ul
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        f = r % filters
        pred = [0, left, prev, (left + prev) // 2, paeth][f]
        out += bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prev = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", trns)
    data += chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


# (color type, bit depth, palette entries or 0, tRNS)
PNG_KINDS = [(0, 1, 0, False), (0, 2, 0, False), (0, 4, 0, False),
             (0, 8, 0, False), (0, 16, 0, False), (4, 8, 0, False),
             (4, 16, 0, False), (2, 8, 0, False), (2, 16, 0, False),
             (6, 8, 0, False), (6, 16, 0, False), (3, 1, 2, False),
             (3, 2, 4, False), (3, 4, 16, True), (3, 8, 200, True)]


@pytest.mark.parametrize("ctype,depth,entries,trns", PNG_KINDS,
                         ids=[f"type{c}-{d}bit" for c, d, *_ in PNG_KINDS])
def test_read_png_matches_cv2(ctype, depth, entries, trns, tmp_path):
    """Every color type and bit depth, under the five filters (odd width:
    padded rows below 8 bits), read as cv2.imread(IMREAD_COLOR) reads it,
    channels reversed."""
    rng = np.random.default_rng(ctype * 17 + depth)
    h, w = 11, 13
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = entries if ctype == 3 else 1 << depth
    raw = rng.integers(0, top, (h, w, ch))
    raw[0, :, 0] = top - 1
    palette = rng.integers(0, 256, (entries, 3)) if entries else None
    path = str(tmp_path / "x.png")
    _png(path, raw, ctype, depth, palette=palette,
         trns=bytes(rng.integers(0, 256, entries).astype(np.uint8))
         if trns else None)
    got = read_png(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_write_png_reads_back_in_cv2(tmp_path):
    rgb = np.random.default_rng(3).integers(0, 256, (17, 23, 3)).astype(
        np.uint8)
    path = str(tmp_path / "y.png")
    write_png(path, rgb)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR),
                                  rgb[:, :, ::-1])
    np.testing.assert_array_equal(read_png(path), rgb)


def test_read_png_refuses_interlaced_and_other_formats(tmp_path):
    raw = np.random.default_rng(4).integers(0, 256, (8, 8, 3))
    _png(str(tmp_path / "i.png"), raw, 2, 8, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(str(tmp_path / "i.png"))
    cv2.imwrite(str(tmp_path / "j.jpg"), raw.astype(np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "j.jpg"))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A seeded 24 x 24 PNG and a reference-format pair of the full-width
    paper EDSR + Fea2GS ({"params", "params_ema"}, different weights), and
    the port's modules on the params_ema weights."""
    from gsasr_torch.model import make_models

    d = tmp_path_factory.mktemp("infer")
    img = np.random.default_rng(5).integers(0, 256, (24, 24, 3)).astype(
        np.uint8)
    write_png(str(d / "in.png"), img)
    pairs = [make_models("edsr", "paper", device="cpu",
                         generator=torch.Generator().manual_seed(s))
             for s in (11, 12)]
    for i, name in enumerate(("net_g", "net_fea2gs")):
        torch.save({"params": pairs[0][i].state_dict(),
                    "params_ema": pairs[1][i].state_dict()},
                   d / f"{name}.pth")
    return d, img, pairs[1]


@pytest.mark.parametrize("scale,tile", [(4.0, None), (4.0, (12, 2)),
                                        (2.5, None)],
                         ids=["x4", "x4-tiled", "x2.5"])
def test_infer_cli_matches_in_process(cli_files, scale, tile):
    """main(argv) on the CPU writes JAX's file name, and its pixels are
    round(clip(out, 0, 1) * 255) of sr_forward (or split_and_joint_image)
    on the params_ema weights."""
    from gsasr_torch.cli.infer import main
    from gsasr_torch.model import sr_forward
    from gsasr_torch.tiling import split_and_joint_image

    d, img, (enc, dec) = cli_files
    argv = ["--input_img_path", str(d / "in.png"), "--save_sr_path",
            str(d / "out"), "--scale", str(scale), "--enc_ckpt",
            str(d / "net_g.pth"), "--dec_ckpt", str(d / "net_fea2gs.pth"),
            "--device", "cpu"]
    if tile:
        argv += ["--tile_process", "--tile_size", str(tile[0]),
                 "--tile_overlap", str(tile[1])]
    path = main(argv)
    assert path == str(d / "out" / f"in_GSASR_tpu_EDSR_{scale}.png")
    lq = img.astype(np.float32)[None] / 255.0
    n = math.floor(24 * scale)
    if tile:
        out = split_and_joint_image(lq, scale, *tile, enc, dec, crop_size=4,
                                    device="cpu")[:, :n, :n]
    else:
        out = sr_forward(enc, dec, lq, scale, denominator=12,
                         device="cpu").numpy()
    want = (np.clip(out[0], 0, 1) * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(read_png(path), want)
    os.remove(path)


def test_infer_cli_refuses(cli_files, monkeypatch):
    """--ckpt_dir beside --enc_ckpt, HATL with the paper version, and the
    default device without a card exit; so does a file that is not a PNG.
    (--bf16 with the paper version runs since the paper Fea2GS in bf16 is
    ported.)"""
    from gsasr_torch.cli.infer import main

    d, _, _ = cli_files
    base = ["--input_img_path", str(d / "in.png"), "--save_sr_path",
            str(d / "out")]
    with pytest.raises(SystemExit, match="not both"):
        main(base + ["--ckpt_dir", str(d), "--enc_ckpt", "g.pth",
                     "--dec_ckpt", "d.pth", "--device", "cpu"])
    with pytest.raises(SystemExit, match="HATL"):
        main(base + ["--model", "HATL", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(base)
    (d / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(SystemExit, match="not a PNG"):
        main(["--input_img_path", str(d / "x.jpg"), "--device", "cpu",
              "--save_sr_path", str(d / "out")])


def test_cli_needs_no_image_library(tmp_path):
    """The CLI's modules import, and the codec round-trips, with cv2, PIL,
    imageio, orbax and JAX blocked (the card's machine has none of them)."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'imageio', 'orbax', 'jax', 'gsasr_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import gsasr_torch.cli.infer, gsasr_torch.tiling\n"
        "import gsasr_torch.utils.checkpoint\n"
        "from gsasr_torch.utils.png import read_png, write_png\n"
        "x = np.arange(60, dtype=np.uint8).reshape(4, 5, 3)\n"
        "write_png(sys.argv[1], x)\n"
        "assert (read_png(sys.argv[1]) == x).all()\n")
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "x.png")],
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr
