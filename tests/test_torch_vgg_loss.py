"""The port's VGG feature extractor and perceptual loss against the JAX
package's `gsasr_tpu/models/vgg.py`: the same seeded 16x16 inputs and the
same weights, a seeded torchvision-layout VGG19 (chip_smoke.py's
`vgg19_torchvision_state_dict`) read by JAX's `convert_vgg` and carried to
the port by `vgg_params_from_jax`; the port's own loader against that
path; the loss and its input gradient against `jax.grad` for an L1 loss
with a style term and for the Frobenius criterion.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_torch.models import vgg
from gsasr_torch.utils.convert import vgg_params_from_jax
from gsasr_tpu.models import vgg as jvgg

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(torchvision-layout state_dict, JAX params of it)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sd = {k: v.numpy() for k, v in
          cs.vgg19_torchvision_state_dict(13).items()}
    return sd, jvgg.convert_vgg(sd, "vgg19")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("kw", [
    dict(layer_name_list=("relu1_1", "conv2_2", "relu3_4", "pool4")),
    dict(layer_name_list=("relu2_1", "conv3_1", "pool2"), range_norm=True,
         use_input_norm=False, remove_pooling=True),
    dict(layer_name_list=("pool1", "relu2_2"), vgg_type="vgg16",
         pooling_stride=1)],
    ids=["taps", "range_norm-no_pool", "vgg16-stride1"])
def test_vgg_feature_extractor_matches_jax(weights, kw):
    sd, params = weights
    x = np.random.default_rng(14).random((2, 16, 16, 3), dtype=np.float32)
    want = jvgg.VGGFeatureExtractor(**kw).apply({"params": params},
                                                jnp.asarray(x))
    ext = vgg.VGGFeatureExtractor(**kw)
    ext.load_state_dict({k: v for k, v in vgg_params_from_jax(params).items()
                         if k in ext.state_dict()})
    with torch.no_grad():
        got = ext(_nchw(x))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(
            want[k]).transpose(0, 3, 1, 2), rtol=TOL, atol=TOL)


def test_vgg_loader_matches_jax_converter(weights):
    """convert_vgg on torchvision's, a bare Sequential's and the
    reference's layouts gives JAX's convert_vgg carried by
    vgg_params_from_jax; load_vgg takes the layers an extractor has and
    refuses a file without them."""
    sd, params = weights
    want = vgg_params_from_jax(params)
    bare = {k[len("features."):]: v for k, v in sd.items()}
    for layout in (sd, bare, want):
        got = vgg.convert_vgg({k: torch.as_tensor(v)
                               for k, v in layout.items()})
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    ext = vgg.load_vgg(vgg.VGGFeatureExtractor(["relu2_2"]), sd)
    assert torch.equal(ext.vgg_net.conv2_2.weight, want[
        "vgg_net.conv2_2.weight"])
    with pytest.raises(RuntimeError, match="Missing key"):
        vgg.load_vgg(vgg.VGGFeatureExtractor(["relu2_2"]),
                     {k: v for k, v in sd.items() if "features.2." not in k})


@pytest.mark.parametrize("layers,kw", [
    ({"relu1_1": 0.5, "relu2_2": 1.5},
     dict(perceptual_weight=2.0, style_weight=3.0, criterion="l1")),
    ({"conv3_4": 1.0, "relu2_2": 0.5},
     dict(perceptual_weight=1.0, style_weight=0.5, criterion="fro"))],
    ids=["l1-style", "fro"])
def test_perceptual_loss_and_grad_match_jax(weights, layers, kw):
    """Both terms, and the gradient of their sum with respect to x (the GT
    branch stopped), against jax.grad; a zero weight gives None."""
    _, params = weights
    rng = np.random.default_rng(15)
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    gt = rng.random((2, 16, 16, 3), dtype=np.float32)
    jloss = jvgg.PerceptualLoss(layers, **kw)

    def total(xj):
        p, s = jloss(params, xj, jnp.asarray(gt))
        return p + s, (p, s)

    (_, (jp, js)), jg = jax.value_and_grad(total, has_aux=True)(
        jnp.asarray(x))
    loss = vgg.PerceptualLoss(layers, **kw)
    vgg.load_vgg(loss.vgg, vgg_params_from_jax(params))
    xt = _nchw(x).requires_grad_(True)
    gtt = _nchw(gt).requires_grad_(True)
    p, s = loss(xt, gtt)
    (p + s).backward()
    np.testing.assert_allclose(float(p.detach()), float(jp), rtol=TOL)
    np.testing.assert_allclose(float(s.detach()), float(js), rtol=TOL)
    g = xt.grad.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=TOL,
                               atol=TOL * float(np.abs(jg).max()))
    assert gtt.grad is None
    assert not any(q.requires_grad for q in loss.parameters())
    p0, s0 = vgg.PerceptualLoss(layers, perceptual_weight=0.0)(xt, gtt)
    assert p0 is None and s0 is None
    with pytest.raises(NotImplementedError):
        vgg.PerceptualLoss(layers, criterion="l3")


def test_gram_matrix_matches_jax():
    f = np.random.default_rng(16).random((2, 5, 6, 4), dtype=np.float32)
    np.testing.assert_allclose(
        vgg.gram_matrix(_nchw(f)).numpy(),
        np.asarray(jvgg.gram_matrix(jnp.asarray(f))), rtol=1e-6)
