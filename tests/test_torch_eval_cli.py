"""The port's evaluation entry points on the CPU: `gsasr_torch.cli.test` on
seeded pairs with a reference-format checkpoint pair of the full-width
paper EDSR + Fea2GS and official-layout LPIPS and DISTS files, untiled and
tiled, against the same values computed in process; `gsasr_torch.cli.metrics`
(NIQE, PSNR/SSIM, FID with a seeded TorchScript net); the exits without a
card; the PNG codec's byte forms; the new modules without an image
library, JAX or the JAX package. The inputs are chip_smoke.py's phase 43
files (`eval_files`) at a small size.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gsasr_torch.utils.png import decode_png, encode_png, read_png, write_png

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the file (the full-width requests, as in
    tests/test_torch_infer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Phase 43's inputs at LR 24x24 and 24x20 (GT at x4), and the port's
    params_ema modules on the CPU."""
    from gsasr_torch.model import make_models
    from gsasr_torch.utils.convert import load_params

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.EVAL_LR = ((24, 24), (24, 20))
    paths, ema = cs.eval_files(str(tmp_path_factory.mktemp("eval")))
    enc, dec = (load_params(m, sd) for m, sd in zip(
        make_models("edsr", "paper", device="cpu"), ema))
    return paths, enc, dec


@pytest.mark.parametrize("tile", [None, 12], ids=["untiled", "tiled"])
def test_test_cli_matches_in_process(files, tile, capsys):
    """main(argv) prints a line per image and the AVG line; each value is
    the one computed in process from sr_forward (or split_and_joint_image
    in tiles of 12 overlapping by 2) on the params_ema weights, PSNR and
    SSIM on Y, LPIPS-alex and DISTS through the protocol wrappers; each
    --save_sr PNG is that output's."""
    from gsasr_torch.cli.test import main
    from gsasr_torch.data.datasets import PairedImageDataset
    from gsasr_torch.metrics import calculate_psnr, calculate_ssim
    from gsasr_torch.metrics_perceptual import (calculate_dists,
                                                calculate_lpips, load_dists,
                                                load_lpips)
    from gsasr_torch.model import sr_forward
    from gsasr_torch.tiling import split_and_joint_image

    paths, enc, dec = files
    save = os.path.join(os.path.dirname(paths["gt"]), f"sr_{tile}")
    argv = ["--gt", paths["gt"], "--lq", paths["lq"], "--scale", "4",
            "--enc_ckpt", paths["net_g"], "--dec_ckpt", paths["net_fea2gs"],
            "--save_sr", save, "--lpips_weights", paths["lpips_alex"],
            "--dists_weights", paths["dists"], "--device", "cpu"]
    if tile:
        argv += ["--tile_size", str(tile), "--tile_overlap", "2"]
    res = main(argv)
    lines = capsys.readouterr().out.splitlines()
    lp = load_lpips(torch.load(paths["lpips_alex"]), device="cpu")
    ds_model = load_dists(torch.load(paths["dists"]), device="cpu")
    ds = PairedImageDataset(paths["gt"], paths["lq"], 4)
    assert len(res["rows"]) == len(ds) == 2
    for i, row in enumerate(res["rows"]):
        item = ds[i]
        want = item["gt"].shape[:2]
        if tile:
            sr = split_and_joint_image(item["lq"][None], 4.0, tile, 2, enc,
                                       dec, crop_size=4, device="cpu")[
                0, :want[0], :want[1]]
        else:
            sr = sr_forward(enc, dec, item["lq"][None], 4.0, sr_size=want,
                            device="cpu").numpy()[0]
        sr255 = np.clip(sr, 0, 1) * 255.0
        gt255 = item["gt"] * 255.0
        ref = dict(
            psnr=calculate_psnr(sr255, gt255, 4, test_y_channel=True,
                                channel_order="rgb"),
            ssim=calculate_ssim(sr255, gt255, 4, test_y_channel=True,
                                channel_order="rgb"),
            lpips=calculate_lpips(sr255[..., ::-1], gt255[..., ::-1], 4, lp),
            dists=calculate_dists(sr255[..., ::-1], gt255[..., ::-1], 4,
                                  ds_model))
        assert {k: row[k] for k in ref} == ref
        assert lines[-3 + i] == (
            f"[{i + 1}/2] {row['name']} psnr {ref['psnr']:.3f} ssim "
            f"{ref['ssim']:.4f} {row['seconds'] * 1e3:.0f} ms lpips "
            f"{ref['lpips']:.4f} dists {ref['dists']:.4f}")
        np.testing.assert_array_equal(
            read_png(os.path.join(save, row["name"])),
            (np.clip(sr, 0, 1) * 255).round().astype(np.uint8))
    mean = {k: np.mean([r[k] for r in res["rows"]]) for k in ref}
    avg_t = np.mean([r["seconds"] for r in res["rows"]])
    assert lines[-1] == res["summary"] == (
        f"AVG psnr {mean['psnr']:.4f} ssim {mean['ssim']:.5f} time "
        f"{avg_t * 1e3:.1f} ms over 2 images lpips {mean['lpips']:.4f} "
        f"dists {mean['dists']:.4f} peak_mem n/a")


def test_test_cli_refuses(files, monkeypatch, tmp_path):
    """A tile size off the denominator, one checkpoint of two, --ckpt_dir
    beside --enc_ckpt, a DISTS file without its backbone (JAX's message),
    and the default device without a card exit."""
    from gsasr_torch.cli.test import main

    paths, *_ = files
    base = ["--gt", paths["gt"], "--lq", paths["lq"], "--device", "cpu"]
    with pytest.raises(SystemExit, match="multiple of the denominator"):
        main(base + ["--tile_size", "10"])
    with pytest.raises(SystemExit, match="both --enc_ckpt"):
        main(base + ["--enc_ckpt", paths["net_g"]])
    with pytest.raises(SystemExit, match="not both"):
        main(base + ["--ckpt_dir", str(tmp_path), "--enc_ckpt", "g.pth",
                     "--dec_ckpt", "d.pth"])
    sd = torch.load(paths["dists"])
    torch.save({"alpha": sd["alpha"], "beta": sd["beta"]},
               tmp_path / "alpha_beta.pt")
    with pytest.raises(SystemExit, match="VGG16 backbone"):
        main(base + ["--dists_weights", str(tmp_path / "alpha_beta.pt"),
                     "--limit", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--gt", paths["gt"], "--lq", paths["lq"]])


def test_metrics_cli(files, tmp_path, monkeypatch):
    """niqe over a folder, psnr_ssim with a name suffix, fid-stats then fid
    with a seeded TorchScript net (on the CPU): each the in-process value;
    lpips and dists exit without their packages, as JAX's do; FID without
    a card and without --device cpu exits."""
    from gsasr_torch.cli.metrics import main
    from gsasr_torch.metrics import calculate_psnr, calculate_ssim
    from gsasr_torch.metrics_niqe import calculate_niqe
    from gsasr_torch.metrics_perceptual import (calculate_fid,
                                                compute_feature_stats)

    paths, *_ = files
    names = sorted(os.listdir(paths["gt"]))
    gts = [read_png(os.path.join(paths["gt"], n)) for n in names]
    rng = np.random.default_rng(20)
    restored = tmp_path / "restored"
    restored.mkdir()
    outs = []
    for n, gt in zip(names, gts):
        noisy = np.clip(gt + rng.normal(0, 8, gt.shape), 0, 255).astype(
            np.uint8)
        write_png(str(restored / n.replace(".png", "_x4.png")), noisy)
        outs.append(noisy)
    # NIQE takes blocks of 96: two seeded 112x104 images, border 2
    from scipy.ndimage import gaussian_filter
    (tmp_path / "niqe").mkdir()
    blurred = [gaussian_filter(rng.random((112, 104, 3)) * 255, (s, s, 0))
               .round().astype(np.uint8) for s in (1, 2)]
    for i, img in enumerate(blurred):
        write_png(str(tmp_path / "niqe" / f"{i}.png"), img)
    niqe = main(["--metric", "niqe", "--restored", str(tmp_path / "niqe"),
                 "--crop", "2"])
    assert niqe == [calculate_niqe(g, 2, channel_order="rgb")
                    for g in blurred]
    psnr, ssim = main(["--gt", paths["gt"], "--restored", str(restored),
                       "--suffix", "_x4", "--test_y_channel"])
    assert psnr == [calculate_psnr(o.astype(float), g.astype(float), 4,
                                   test_y_channel=True, channel_order="rgb")
                    for o, g in zip(outs, gts)]
    assert ssim[0] == calculate_ssim(outs[0].astype(float),
                                     gts[0].astype(float), 4,
                                     test_y_channel=True, channel_order="rgb")
    stats = str(tmp_path / "stats.npz")
    mu, sigma = main(["--metric", "fid-stats", "--restored", paths["gt"],
                      "--inception_params", paths["fid_net"], "--out", stats,
                      "--device", "cpu"])
    fid = main(["--metric", "fid", "--restored", str(restored),
                "--inception_params", paths["fid_net"], "--fid_stats",
                stats, "--device", "cpu"])
    net = torch.jit.load(paths["fid_net"])
    with torch.no_grad():
        feats = [net(torch.from_numpy((img / 255.0).astype(np.float32))
                     .permute(2, 0, 1)[None]).reshape(-1).numpy()
                 for img in outs]
    mu2, sigma2 = compute_feature_stats(np.stack(feats))
    assert fid == calculate_fid(mu2, sigma2, mu, sigma)
    assert np.isfinite(fid) and fid > 0
    for metric, pkg in (("lpips", "lpips"), ("dists", "DISTS_pytorch")):
        with pytest.raises(SystemExit, match=pkg):
            main(["--metric", metric, "--gt", paths["gt"], "--restored",
                  str(restored)])
    with pytest.raises(SystemExit, match="InceptionV3"):
        main(["--metric", "fid", "--restored", str(restored), "--device",
              "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--metric", "fid", "--restored", str(restored),
              "--inception_params", paths["fid_net"]])


def test_png_bytes_round_trip(tmp_path):
    """encode_png / decode_png round-trip, and agree with the path forms:
    write_png writes encode_png's bytes, read_png reads what decode_png
    decodes; a body that is not a PNG raises."""
    rgb = np.random.default_rng(21).integers(0, 256, (13, 17, 3)).astype(
        np.uint8)
    for adaptive in (False, True):
        data = encode_png(rgb, adaptive=adaptive, level=3)
        np.testing.assert_array_equal(decode_png(data), rgb)
        path = str(tmp_path / f"a{adaptive}.png")
        write_png(path, rgb, adaptive=adaptive, level=3)
        assert Path(path).read_bytes() == data
        np.testing.assert_array_equal(read_png(path), decode_png(data))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="RGB uint8"):
        encode_png(rgb.astype(np.float32))


def test_eval_modules_need_no_image_library(tmp_path):
    """The evaluation and demo modules import, and NIQE and the codec's
    byte forms run, with cv2, PIL, imageio, JAX and the JAX package blocked
    (the card's machine has none of them)."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'imageio', 'orbax', 'jax', 'gsasr_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import gsasr_torch.cli.test, gsasr_torch.cli.metrics\n"
        "import gsasr_torch.cli.demo, gsasr_torch.metrics_perceptual\n"
        "import gsasr_torch.models.vgg\n"
        "from gsasr_torch.metrics_niqe import calculate_niqe\n"
        "from gsasr_torch.utils.png import decode_png, encode_png\n"
        "x = np.arange(60, dtype=np.uint8).reshape(4, 5, 3)\n"
        "assert (decode_png(encode_png(x)) == x).all()\n"
        "img = np.random.default_rng(0).random((100, 100, 3)) * 255\n"
        "assert np.isfinite(calculate_niqe(img))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
