"""The port's LPIPS (AlexNet and VGG16 backbones) against the JAX
package's: the same seeded inputs (a 72x72 pair, 64x64 inside the crop)
and the same weights, drawn as an official `lpips` checkpoint
(chip_smoke.py's `lpips_official_state_dict`), read by JAX's
`convert_lpips` and carried to the port by `lpips_params_from_jax`; the
port's own loader against that path; the module and the protocol wrapper
against JAX's `calculate_lpips`, each network's one JAX apply in the file
(a module-scoped fixture, un-jitted).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gsasr_torch import metrics_perceptual as mp
from gsasr_torch.utils.convert import lpips_params_from_jax
from gsasr_tpu import metrics_perceptual as jmp

ROOT = Path(__file__).resolve().parents[1]
# the JAX package's own tests hold its networks at 1e-4
TOL = 1e-4


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread, restored after the file
    (the six-worker suite's thread pools share the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["alex", "vgg"])
def lpips_case(request):
    """(net, official state_dict, JAX params, a seeded 72x72 BGR 0-255
    pair, JAX's calculate_lpips of it with crop 4: the network's one JAX
    apply in the file, on 64x64 RGB inputs)."""
    net = request.param
    sd = {k: v.numpy() for k, v in
          chip_smoke().lpips_official_state_dict(net, 5).items()}
    params = jmp.convert_lpips(sd, net=net)
    rng = np.random.default_rng(6)
    a = rng.random((72, 72, 3)) * 255
    b = rng.random((72, 72, 3)) * 255
    return net, sd, params, a, b, jmp.calculate_lpips(a, b, 4, params,
                                                      net=net)


def _rgb01(img):
    """What the protocol feeds the network: the 64x64 centre, [0, 1],
    BGR -> RGB, (1, 3, H, W) float32."""
    x = img[4:-4, 4:-4, ::-1] / 255.0
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(2, 0, 1)[None], np.float32))


def test_lpips_matches_jax(lpips_case):
    """The port's LPIPS on JAX's weights, carried by lpips_params_from_jax,
    on the inputs of JAX's score; 0 on identical images."""
    net, _, params, a, b, want = lpips_case
    model = mp.LPIPS(net)
    model.load_state_dict(lpips_params_from_jax(params))
    with torch.no_grad():
        got = model(_rgb01(a), _rgb01(b))
        same = model(_rgb01(a), _rgb01(a))
    np.testing.assert_allclose(float(got[0]), want, rtol=TOL, atol=TOL)
    assert want > 0 and abs(float(same[0])) < 1e-8


def test_lpips_loader_matches_jax_converter(lpips_case):
    """convert_lpips (official keys: both head spellings, the scaling
    layer's buffers dropped) gives what JAX's convert_lpips carried by
    lpips_params_from_jax gives, tensor for tensor; load_lpips loads it
    strictly."""
    net, sd, params, *_ = lpips_case
    got = mp.convert_lpips({k: torch.from_numpy(v) for k, v in sd.items()})
    want = lpips_params_from_jax(params)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = mp.load_lpips(sd, net, device="cpu")
    assert not model.training and model.lins[0].weight.device.type == "cpu"
    with pytest.raises(RuntimeError, match="Missing key"):
        mp.load_lpips({k: v for k, v in sd.items() if "slice1" not in k},
                      net, device="cpu")


def test_calculate_lpips_matches_jax(lpips_case):
    """The protocol wrapper (BGR 0-255, border crop, float32 with TF32 off)
    against JAX's, in HWC and CHW; the caller's TF32 settings come back; a
    `net` other than the model's backbone raises."""
    net, sd, _, a, b, want = lpips_case
    model = mp.load_lpips(sd, net, device="cpu")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    got = mp.calculate_lpips(a, b, 4, model, net=net)
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    chw = mp.calculate_lpips(a.transpose(2, 0, 1), b.transpose(2, 0, 1), 4,
                             model, net=net, input_order="CHW")
    assert chw == got
    with pytest.raises(ValueError, match="backbone"):
        mp.calculate_lpips(a, b, 4, model, net="vgg" if net == "alex"
                           else "alex")


def test_fp32_math_restores_the_flags():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(ValueError):
            with mp.fp32_math():
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
                raise ValueError
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
