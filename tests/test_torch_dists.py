"""The port's DISTS, L2 pooling and FID against the JAX package's: the same
seeded inputs (a 72x72 pair, 64x64 inside the crop) and the same weights,
drawn as the DISTS package's checkpoint (chip_smoke.py's
`dists_official_state_dict`), read by JAX's `convert_dists` and carried to
the port by `dists_params_from_jax`; the port's own loader against that
path; the module and the protocol wrapper against JAX's `calculate_dists`
(GT first), the network's one JAX apply in the file (a module-scoped
fixture, un-jitted); FID on seeded covariances.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_torch import metrics_perceptual as mp
from gsasr_torch.utils.convert import dists_params_from_jax
from gsasr_tpu import metrics_perceptual as jmp

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dists_case():
    """(official state_dict, JAX params, a seeded 72x72 BGR 0-255 pair,
    JAX's calculate_dists of it with crop 4: the network's one JAX apply in
    the file, on 64x64 RGB inputs)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sd = {k: v.numpy() for k, v in cs.dists_official_state_dict(8).items()}
    params = jmp.convert_dists(sd)
    rng = np.random.default_rng(9)
    a = rng.random((72, 72, 3)) * 255
    b = rng.random((72, 72, 3)) * 255
    return sd, params, a, b, jmp.calculate_dists(a, b, 4, params)


def _rgb01(img):
    x = img[4:-4, 4:-4, ::-1] / 255.0
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(2, 0, 1)[None], np.float32))


def test_dists_matches_jax(dists_case):
    """The port's DISTS on JAX's weights, carried by dists_params_from_jax,
    on the inputs of JAX's score (GT first); 0 on identical images."""
    _, params, a, b, want = dists_case
    model = mp.DISTS()
    model.load_state_dict(dists_params_from_jax(params))
    with torch.no_grad():
        got = model(_rgb01(b), _rgb01(a))
        same = model(_rgb01(a), _rgb01(a))
    np.testing.assert_allclose(float(got[0]), want, rtol=TOL, atol=TOL)
    assert want > 1e-3 and abs(float(same[0])) < 1e-5


def test_dists_loader_matches_jax_converter(dists_case):
    """convert_dists (stage keys, the pools' filters and the normalisation
    buffers dropped, alpha and beta flattened), and on torchvision's
    `features.{idx}` keys too, gives JAX's convert_dists carried by
    dists_params_from_jax, tensor for tensor; a file without the backbone
    does not load."""
    sd, params, *_ = dists_case
    want = dists_params_from_jax(params)
    tv = {k.replace(k.split(".")[0], "features", 1) if k.startswith("stage")
          else k: v for k, v in sd.items()}
    for layout in (sd, tv):
        got = mp.convert_dists({k: torch.from_numpy(v)
                                for k, v in layout.items()})
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    mp.load_dists(sd, device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        mp.load_dists({"alpha": sd["alpha"], "beta": sd["beta"]},
                      device="cpu")


def test_calculate_dists_matches_jax(dists_case):
    """The protocol wrapper (BGR 0-255, crop, the model called GT first)
    against JAX's; RGB input with color_order="RGB" gives the same."""
    sd, _, a, b, want = dists_case
    model = mp.load_dists(sd, device="cpu")
    got = mp.calculate_dists(a, b, 4, model)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert mp.calculate_dists(a[..., ::-1], b[..., ::-1], 4, model,
                              color_order="RGB") == got


@pytest.mark.parametrize("shape", [(1, 8, 8, 2), (2, 9, 7, 3)])
def test_l2_pool_matches_jax(shape):
    x = np.random.default_rng(11).random(shape, dtype=np.float32)
    want = np.asarray(jmp.l2_pool(jnp.asarray(x), channels=shape[-1]))
    got = mp.l2_pool(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                     shape[-1]).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fid_matches_jax():
    rng = np.random.default_rng(12)
    f1 = rng.standard_normal((200, 16))
    f2 = rng.standard_normal((200, 16)) * 1.3 + 0.2
    mu1, s1 = mp.compute_feature_stats(f1)
    mu2, s2 = mp.compute_feature_stats(f2)
    for a, b in zip((mu1, s1, mu2, s2), jmp.compute_feature_stats(f1)
                    + jmp.compute_feature_stats(f2)):
        np.testing.assert_array_equal(a, b)
    assert mp.calculate_fid(mu1, s1, mu2, s2) == jmp.calculate_fid(
        mu1, s1, mu2, s2)
    assert mp.calculate_fid(mu1, s1, mu1, s1) < 1e-8
    # a singular product takes the eps offset, as in JAX
    s3 = np.diag([1.0] * 15 + [0.0])
    assert mp.calculate_fid(mu1, s3, mu2, s3) == jmp.calculate_fid(
        mu1, s3, mu2, s3)
    feats = mp.extract_features(
        [np.full((4, 4, 3), v) for v in (0.1, 0.5)],
        lambda img: img.mean(axis=(0, 1)))
    np.testing.assert_allclose(feats, [[0.1] * 3, [0.5] * 3])
