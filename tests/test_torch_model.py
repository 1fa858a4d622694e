"""gsasr_torch end to end against gsasr_tpu on the CPU: the EDSR encoder,
the fused paper decoder, sr_forward, padding, the state_dict round trip
through the reference converter, import hygiene and device selection.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port runs its plain PyTorch versions. Weights are drawn with the
reference initializers by the port, read into JAX trees by the JAX
package's reference converter and loaded into fresh port modules with
params_from_jax.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import EDSRNOUP as JEDSR
from gsasr_tpu.models import Fea2GS as JFea2GS
from gsasr_torch.models import EDSRNOUP, Fea2GS
from gsasr_torch.models.init import init_weights
from gsasr_torch.utils.convert import load_params, params_from_jax

# tests/test_model.py's tiny configuration
TINY_ENC = dict(num_feat=8, num_block=1)
TINY_DEC = dict(inchannel=8, channel=12, num_heads=6, num_crossattn_blocks=1,
                num_crossattn_layers=1, num_selfattn_blocks=1,
                num_selfattn_layers=1, num_gs_seed=16, window_size=4)
# production widths (channel 180, 6 heads, 144 seeds, window 12) trimmed
# to one self-attention block
FULL_DEC = dict(num_selfattn_blocks=1, num_selfattn_layers=2)


def _jax_params(enc, dec):
    """JAX parameter trees of port modules, read by the JAX package's
    reference converter."""
    from gsasr_tpu.utils.torch_convert import convert_edsr, convert_fea2gs

    return (convert_edsr(enc.state_dict()),
            convert_fea2gs(dec.state_dict(), num_gs_seed=dec.num_gs_seed,
                           window_size=dec.window_size,
                           num_heads=dec.num_heads))


def _pair(enc_kw, dec_kw, seed=0):
    """JAX modules and params with the reference initializers, and fresh
    port modules loaded with those params through params_from_jax."""
    g = torch.Generator().manual_seed(seed)
    ep, dp = _jax_params(init_weights(EDSRNOUP(**enc_kw), g),
                         init_weights(Fea2GS(**dec_kw), g))
    esd, dsd = params_from_jax(ep, dp)
    enc = load_params(EDSRNOUP(**enc_kw), esd).eval()
    dec = load_params(Fea2GS(**dec_kw), dsd).eval()
    return JEDSR(**enc_kw), JFea2GS(**dec_kw), ep, dp, enc, dec


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY_ENC, TINY_DEC)


def test_edsr_matches_jax(tiny):
    jenc, _, ep, _, enc, _ = tiny
    x = np.random.default_rng(0).random((2, 12, 16, 3), dtype=np.float32)
    ref = np.asarray(jenc.apply({"params": ep}, jnp.asarray(x)))
    with torch.no_grad():
        out = enc(torch.from_numpy(x)).numpy()
    # 1e-5: two conv implementations summing 27-72 products per output
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dec_kw,b,hw", [(TINY_DEC, 2, (8, 12)),
                                         (FULL_DEC, 1, (12, 24))],
                         ids=["tiny", "full_width"])
def test_fused_decoder_matches_jax(dec_kw, b, hw):
    from gsasr_tpu.models.fea2gs_fast import fea2gs_apply_fused as jfused
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused

    _, jdec, _, dp, _, dec = _pair(TINY_ENC, dec_kw)
    rng = np.random.default_rng(1)
    inch = dec_kw.get("inchannel", 64)
    srcs = rng.random((b, *hw, inch), dtype=np.float32)
    scale = rng.uniform(1.5, 4.0, (b,)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x, sc: jfused(jdec, {"params": p}, x,
                                                      sc))(
        dp, jnp.asarray(srcs), jnp.asarray(scale)))
    with torch.no_grad():
        out = fea2gs_apply_fused(dec, torch.from_numpy(srcs),
                                 torch.from_numpy(scale)).numpy()
    assert out.shape == ref.shape
    # 2e-4, as tests/test_fea2gs_fast.py: float32 products summed in
    # another order through up to 17 residual sub-layers
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hw,scale", [((12, 16), 2.0), ((10, 13), 3.3),
                                      ((6, 7), 12.0)])
def test_sr_forward_matches_jax(tiny, hw, scale):
    from gsasr_tpu.model import sr_forward as jsr_forward
    from gsasr_torch.model import sr_forward

    jenc, jdec, ep, dp, enc, dec = tiny
    lq = np.random.default_rng(2).random((1, *hw, 3), dtype=np.float32)
    ref = np.asarray(jsr_forward(jenc, jdec, ep, dp, jnp.asarray(lq), scale,
                                 denominator=4, dmax=0.5))
    out = sr_forward(enc, dec, torch.from_numpy(lq), scale, denominator=4,
                     dmax=0.5, device="cpu").numpy()
    want = (math.floor(hw[0] * scale), math.floor(hw[1] * scale))
    assert out.shape == ref.shape == (1, *want, 3)
    assert np.isfinite(out).all()
    # 1e-4 absolute: the raster sums its Gaussians in another order than
    # the Pallas walk, on top of the decoder's float32 differences
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,denom", [((1, 5, 7, 3), 12),
                                         ((2, 10, 13, 3), 4),
                                         ((1, 1, 3, 3), 4),
                                         ((1, 8, 8, 3), 4)])
def test_pad_to_denominator_matches_jnp(shape, denom):
    """Reflect padding equals jnp.pad even when the pad exceeds the side,
    which torch's own reflect pad refuses."""
    from gsasr_tpu.model import pad_to_denominator as jpad
    from gsasr_torch.model import pad_to_denominator

    x = np.random.default_rng(3).random(shape, dtype=np.float32)
    ref, ref_hw = jpad(jnp.asarray(x), denom)
    out, out_hw = pad_to_denominator(torch.from_numpy(x), denom)
    assert out_hw == ref_hw
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _assert_same_structure(tree, abstract, path=""):
    if isinstance(abstract, dict):
        assert set(tree) == set(abstract), (path, set(tree) ^ set(abstract))
        for k in abstract:
            _assert_same_structure(tree[k], abstract[k], f"{path}/{k}")
    else:
        assert np.shape(tree) == abstract.shape, path


@pytest.mark.parametrize("dec_kw", [TINY_DEC, FULL_DEC],
                         ids=["tiny", "full_width"])
def test_state_dict_roundtrip_through_reference_converter(dec_kw):
    """The reference converter reads the state_dict of port modules loaded
    by params_from_jax back into exactly the JAX params they were loaded
    from, and those params have the flax modules' own tree: the port's keys
    are the reference's, and its relative_position_index buffers make the
    bias-table remap the identity."""
    jenc, jdec, ep, dp, enc, dec = _pair(TINY_ENC, dec_kw, seed=5)
    ep2, dp2 = _jax_params(enc, dec)
    _assert_tree_equal(ep2, ep)
    _assert_tree_equal(dp2, dp)
    inch = dec_kw.get("inchannel", 64)
    rng = jax.random.PRNGKey(0)
    _assert_same_structure(dp, jax.eval_shape(lambda: jdec.init(
        rng, jnp.zeros((1, 12, 12, inch)), jnp.ones((1,))))["params"])
    _assert_same_structure(ep, jax.eval_shape(lambda: jenc.init(
        rng, jnp.zeros((1, 4, 4, 3))))["params"])


def test_port_imports_no_jax():
    """Every gsasr_torch module and chip_smoke import without JAX or the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gsasr_torch\n"
        "for m in pkgutil.walk_packages(gsasr_torch.__path__, 'gsasr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gsasr_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('gsasr_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parents[1]))
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_raise_without_gpu(monkeypatch, tiny):
    """Without a card and without device='cpu' the entry points raise;
    they never fall back to the CPU on their own."""
    from gsasr_torch.model import make_models, sr_forward
    from gsasr_torch.rendering import render_gaussians

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    *_, enc, dec = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_models("edsr", "paper")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sr_forward(enc, dec, torch.zeros(1, 4, 4, 3), 2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_gaussians((8, 8), torch.zeros(16, 9), 2.0)


def test_make_models_seeded_and_shaped():
    """make_models draws every weight from the generator: the same seed
    gives the same weights, another seed others; the global RNG is left
    alone. Widths are the paper EDSR-GSASR's."""
    from gsasr_torch.model import make_models

    state = torch.random.get_rng_state()
    enc, dec = make_models("edsr", "paper", device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(state, torch.random.get_rng_state())
    enc2, dec2 = make_models("edsr", "paper", device="cpu",
                             generator=torch.Generator().manual_seed(0))
    _, dec3 = make_models("edsr", "paper", device="cpu",
                          generator=torch.Generator().manual_seed(1))
    for k, v in dec.state_dict().items():
        assert torch.equal(v, dec2.state_dict()[k]), k
    assert not torch.equal(dec.gs_embedding, dec3.gs_embedding)
    assert enc.conv_first.weight.shape == (64, 3, 3, 3)
    assert len(enc.body) == 16
    assert dec.gs_embedding.shape == (144, 180)
    assert len(dec.gs_selfattn_blocks) == 6
    si = dec.gs_selfattn_blocks[0].blocks[0].gs_cross_attn_scale
    assert torch.all(si.in_proj_bias == 0) and torch.all(si.out_proj.bias == 0)
    bound = 1 / math.sqrt(180)
    w = dec.gs_selfattn_blocks[0].blocks[0].mlp_selfattn.fc1.weight
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    with pytest.raises(NotImplementedError):
        make_models("hat", "paper", device="cpu")


# two layers per block, so the odd layers' feature and lattice rolls run
TINY_DEC2 = dict(TINY_DEC, num_crossattn_layers=2, num_selfattn_layers=2)


@pytest.mark.parametrize("dec_kw,b,hw", [(TINY_DEC2, 1, (4, 8)),
                                         (FULL_DEC, 1, (12, 24))],
                         ids=["tiny", "full_width"])
def test_module_decoder_matches_jax_forward_and_grads(dec_kw, b, hw):
    """Fea2GS.forward is the differentiable module path: its output and
    every parameter gradient match JAX's Fea2GS.apply and jax.grad (K11 and
    K12 in interpret mode). The JAX gradient tree converts with
    params_from_jax as it is, since it has the parameters' structure; the
    dead LayerNorms and ScaleInject's q/k thirds get zero on both sides."""
    _, jdec, ep, dp, _, dec = _pair(TINY_ENC, dec_kw, seed=3)
    rng = np.random.default_rng(4)
    srcs = rng.random((b, *hw, dec_kw.get("inchannel", 64)), dtype=np.float32)
    scale = rng.uniform(1.5, 4.0, (b,)).astype(np.float32)
    nsq = math.isqrt(dec.num_gs_seed)
    n = (hw[0] // dec.window_size * 4 * nsq) * (hw[1] // dec.window_size * 4
                                                 * nsq)
    weight = rng.standard_normal((b, n, 9)).astype(np.float32)

    def jloss(p):
        out = jdec.apply({"params": p}, jnp.asarray(srcs), jnp.asarray(scale))
        return jnp.sum(out * weight), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(dp)
    out = dec(torch.from_numpy(srcs), torch.from_numpy(scale))
    assert out.grad_fn is not None
    # 2e-4, as the fused decoder's test: float32 sums in another order
    # through up to 17 residual sub-layers
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-4, atol=2e-4)
    dec.zero_grad(set_to_none=True)
    (out * torch.from_numpy(weight)).sum().backward()
    want = params_from_jax(ep, jgrad)[1]
    for name, p in dec.named_parameters():
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        ref = want[name].numpy()
        if dec_kw is TINY_DEC2:
            # 1e-4 of the tensor's largest entry: sums over windows and
            # heads in another order (each side is within 2e-5 of a
            # float64 run of the port)
            np.testing.assert_allclose(got, ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max() + 1e-7,
                                       err_msg=name)
        else:
            # Relative Frobenius 1e-2 (measured up to 3.4e-3): at this size
            # a few of the heads' 20 M ReLU inputs lie within float32 noise
            # of zero and switch differently, each moving one row of a
            # weight gradient. 1e-6 absolute: the k biases' true gradient
            # is 0 (softmax ignores a per-query constant).
            assert np.linalg.norm(got - ref) <= (
                1e-2 * np.linalg.norm(ref) + 1e-6), name


def test_module_path_equals_fused_path(tiny):
    """dec(...) (module path) and fea2gs_apply_fused give the same
    Gaussians; both carry a graph (the fused path trains with
    fused_decoder=True)."""
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused

    *_, dec = _pair(TINY_ENC, TINY_DEC2, seed=6)
    rng = np.random.default_rng(7)
    srcs = torch.from_numpy(rng.random((2, 8, 12, 8), dtype=np.float32))
    scale = torch.tensor([2.0, 3.5])
    out = dec(srcs, scale)
    ref = fea2gs_apply_fused(dec, srcs, scale)
    assert out.grad_fn is not None and ref.grad_fn is not None
    # 1e-5: the same float32 sub-layers, composed in another order
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_sr_forward_takes_the_fused_decoder(tiny, monkeypatch):
    """Inference stays on the fused path (kernels M and A on the card),
    never on the module path (kernels W and WB)."""
    import gsasr_torch.model as tm

    *_, enc, dec = tiny
    calls = []
    fused = tm.fea2gs_apply_fused
    monkeypatch.setattr(tm, "fea2gs_apply_fused",
                        lambda *a: calls.append(1) or fused(*a))
    monkeypatch.setattr(type(dec), "forward", lambda *a: pytest.fail(
        "sr_forward ran the module decoder"))
    tm.sr_forward(enc, dec, torch.rand(1, 8, 8, 3), 2.0, denominator=4,
                  device="cpu")
    assert calls == [1]
