"""The HAT-L Ultra recipe's networks built from its YAML on the CPU (moved
here from tests/test_torch_hat_train.py, whose helpers it uses, so that
the test runs spread over more files).
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsasr_torch.models import Fea2GSRopeAMP, HATNOUP
from gsasr_torch.train import TrainConfig
from gsasr_tpu.utils.torch_convert import convert_fea2gs_rope, convert_hat
from test_torch_hat_train import BF16, ROOT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_build_networks_ultra_recipe():
    """configs/train_hatl_ultra.yml builds the bf16 HAT-L and the bf16
    Fea2GSRopeAMP at the yaml's widths and depths (fp32 parameters and
    heads); their parameter trees, read by the reference converters, have
    the shapes of the JAX package's build_networks of the same file (cut
    to one RHAG and one self-attention block); build_train_config
    gives the 1024x1024 canvas of ceil(16 x 64); chip_smoke.py's written-out
    recipe, batch and networks are the file's, weight for weight."""
    from gsasr_torch.config import (build_networks, build_train_config,
                                    load_options)
    from gsasr_tpu.config import build_networks as jbuild_networks

    opt = load_options(ROOT / "configs" / "train_hatl_ultra.yml")
    enc, dec = build_networks(opt)
    assert isinstance(enc, HATNOUP) and isinstance(dec, Fea2GSRopeAMP)
    assert enc.dtype == BF16 and dec.dtype == BF16
    assert enc.drop_path_rate == 0.1 and enc.window_size == 16
    blk = enc.layers[0].residual_group["blocks"][1]
    assert blk.attn.qkv.compute_dtype == BF16 and blk.shift_size == 8
    assert blk.conv_block.cab[0].compute_dtype == BF16
    assert dec.head_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    assert len(enc.layers) == 12 and len(dec.gs_selfattn_blocks) == 8
    assert all(len(layer.residual_group["blocks"]) == 6
               for layer in enc.layers)
    # the trees at the yaml's widths, cut to one RHAG and one self-attention
    # block on both sides (JAX traces HAT-L's whole init in about 45 s)
    cut = dict(opt, network_g=dict(opt["network_g"], depths=[6],
                                   num_heads=[6]),
               network_fea2gs=dict(opt["network_fea2gs"],
                                   num_selfattn_blocks=1))
    enc1, dec1 = build_networks(cut)
    jenc, jdec = jbuild_networks(cut)
    assert jenc.dtype == jnp.bfloat16 and jdec.dtype == jnp.bfloat16
    shapes = jax.eval_shape(lambda: {
        "g": jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))),
        "d": jdec.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 64)),
                       jnp.ones((1,)))})
    shape = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shape(convert_hat(enc1.state_dict())) == shape(
        shapes["g"]["params"])
    assert shape(convert_fea2gs_rope(dec1.state_dict())) == shape(
        shapes["d"]["params"])

    cfg = build_train_config(opt)
    assert cfg.canvas_hw == (1024, 1024) and cfg.clip_grad_norm is None
    cs = _chip_smoke()
    assert TrainConfig(**cs.ULTRA_TRAIN) == cfg
    ds = opt["datasets"]["train"]
    assert (cs.ULTRA_BATCH, cs.ULTRA_LR_SIZE, cs.ULTRA_SCALES) == (
        ds["batch_size_per_gpu"], ds["lr_size"], tuple(ds["scale_list"]))
    assert ds["round_mode"] == "ceil"
    batch = cs.paper_batch(2, seed=0, ultra=True)
    assert batch["lq"].shape == (2, 64, 64, 3)
    assert batch["gt"].shape == (2, 1024, 1024, 3)
    assert (batch["gt_h"] == np.ceil(64 * batch["scale"])).all()
    for got, want in zip(cs.enhanced_networks("hat"), (enc, dec)):
        assert type(got) is type(want) and got.dtype == want.dtype
        sd = want.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, sd[k]), k
