"""gsasr_torch.utils.checkpoint against the JAX package's reference
checkpoint loader on the CPU: for every kind, `load_torch_checkpoint` of a
reference-format `.pth` file ({"params", "params_ema"}, or a bare
state_dict) equals the JAX package's `load_torch_checkpoint` read back into
the port's keys by `params_from_jax`, tensor for tensor and bit for bit.
The checkpoints are written from port modules at narrow widths with
seeded weights; JAX's converters are numpy, so nothing is compiled.
"""

import numpy as np
import pytest
import torch

from gsasr_torch.models import (EDSRNOUP, HATNOUP, RDNNOUP, Fea2GS,
                                Fea2GSRopeAMP, HATNOUPPaper, SwinIRNOUP)
from gsasr_torch.models.init import init_weights
from gsasr_torch.utils.checkpoint import (CONVERTER_KINDS,
                                          load_pretrained_params,
                                          load_torch_checkpoint)
from gsasr_torch.utils.convert import load_params, params_from_jax

PAPER_DEC = dict(inchannel=8, channel=12, num_heads=6, num_crossattn_blocks=1,
                 num_crossattn_layers=2, num_selfattn_blocks=2,
                 num_selfattn_layers=1, num_gs_seed=16, window_size=4)
ROPE_DEC = dict(inchannel=8, channel=24, num_heads=6, num_crossattn_blocks=1,
                num_crossattn_layers=1, num_selfattn_blocks=1,
                num_selfattn_layers=2, num_gs_seed=16, window_size=4)
# (encoder kind, its module, decoder kind, its module)
PAIRS = {
    "edsr": (EDSRNOUP, dict(num_feat=8, num_block=2), "fea2gs"),
    "rdn": (RDNNOUP, dict(g0=8, config="A"), "fea2gs_rope"),
    "swinir": (SwinIRNOUP, dict(embed_dim=24, depths=(2, 2),
                                num_heads=(6, 6), window_size=4, num_feat=8),
               "fea2gs"),
    "hat": (HATNOUP, dict(embed_dim=24, depths=(2,), num_heads=(6,),
                          window_size=4, squeeze_factor=4, mlp_ratio=2,
                          num_feat=8), "fea2gs_rope"),
    "hat_paper": (HATNOUPPaper, dict(embed_dim=24, depths=(2,),
                                     num_heads=(6,), window_size=16,
                                     squeeze_factor=4, conv_scale=0.5,
                                     num_feat=8), "fea2gs"),
}
DECODERS = {"fea2gs": (Fea2GS, PAPER_DEC), "fea2gs_rope": (Fea2GSRopeAMP,
                                                          ROPE_DEC)}
# buffers the reference modules register that no converter reads
# (SwinIR's and HAT's shifted-window masks, HAT's index tables)
REFERENCE_BUFFERS = {
    "swinir": ("layers.0.residual_group.blocks.1.attn_mask",),
    "hat": ("relative_position_index_SA", "relative_position_index_OCA",
            "layers.0.residual_group.blocks.1.attn_mask"),
    "hat_paper": ("relative_position_index_SA",
                  "relative_position_index_OCA",
                  "layers.0.residual_group.blocks.1.attn_mask"),
}


def _modules(kind, seed):
    """Seeded port encoder and decoder of PAIRS[kind]."""
    cls, kw, dec_kind = PAIRS[kind]
    dcls, dkw = DECODERS[dec_kind]
    g = torch.Generator().manual_seed(seed)
    return init_weights(cls(**kw), g), init_weights(dcls(**dkw), g)


def _jax_load(path, kind, key):
    from gsasr_tpu.utils.checkpoint import load_torch_checkpoint as jload

    kw = {}
    if kind == "fea2gs":
        kw = dict(num_gs_seed=PAPER_DEC["num_gs_seed"],
                  window_size=PAPER_DEC["window_size"],
                  num_heads=PAPER_DEC["num_heads"])
    return jload(str(path), kind, param_key=key, **kw)


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


def _assert_matches(port, ref):
    """Every tensor params_from_jax gives, bit for bit; the port keeps
    only the relative_position_index buffers beside them."""
    assert set(ref) <= set(port), set(ref) - set(port)
    extra = set(port) - set(ref)
    assert all(k.endswith("relative_position_index") for k in extra), extra
    for k, v in ref.items():
        assert _same_bits(port[k], v), k


@pytest.mark.parametrize("kind", list(PAIRS))
def test_load_matches_jax_loader(kind, tmp_path):
    """Both keys of a {"params", "params_ema"} pair and a bare state_dict,
    with the reference modules' unread buffers in the files: the port's
    loader equals params_from_jax of JAX's loader for the encoder kind and
    its decoder kind, and loads strictly into fresh modules."""
    dec_kind = PAIRS[kind][2]
    sds = [[m.state_dict() for m in _modules(kind, seed)] for seed in (1, 2)]
    for sd in sds:
        for name in REFERENCE_BUFFERS.get(kind, ()):
            sd[0][name] = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    paths = {}
    for i, k in enumerate((kind, dec_kind)):
        paths[k] = tmp_path / f"{k}.pth"
        torch.save({"params": sds[0][i], "params_ema": sds[1][i]}, paths[k])
    bare = {k: tmp_path / f"{k}_bare.pth" for k in (kind, dec_kind)}
    for i, k in enumerate((kind, dec_kind)):
        torch.save(sds[0][i], bare[k])
    for key, files in (("params", paths), ("params_ema", paths),
                       ("params_ema", bare)):
        port = [load_torch_checkpoint(files[k], k, key)
                for k in (kind, dec_kind)]
        ref = params_from_jax(_jax_load(files[kind], kind, key),
                              _jax_load(files[dec_kind], dec_kind, key))
        for p, r in zip(port, ref):
            _assert_matches(p, r)
        fresh = _modules(kind, 3)
        for m, p in zip(fresh, port):
            load_params(m, p)
        want = sds[1] if key == "params_ema" and files is paths else sds[0]
        for m, sd in zip(fresh, want):
            for k, v in m.state_dict().items():
                assert _same_bits(v, sd[k]), k


def test_permuted_index_gives_jax_bias(tmp_path):
    """A paper decoder checkpoint whose relative_position_index is another
    order of the table's rows (the reference builds the cross-attention
    index in set order): the port loads the index and rebuilds its inverse,
    JAX permutes the table rows; both give the bias the file means."""
    from gsasr_tpu.models.fea2gs import (cross_attn_rel_pos_index,
                                         self_attn_rel_pos_index)

    dec = _modules("edsr", 4)[1]
    sd = dec.state_dict()
    rng = np.random.default_rng(5)
    want = {}
    for key in [k for k in sd if k.endswith("relative_position_index")]:
        pre = key[:-len("relative_position_index")]
        table, ours = sd[pre + "relative_position_bias_table"], sd[key]
        # row perm[r] of the file's table holds row r of ours
        perm = torch.from_numpy(rng.permutation(table.shape[0]))
        moved = torch.empty_like(table)
        moved[perm] = table
        sd[key], sd[pre + "relative_position_bias_table"] = perm[ours], moved
        want[pre] = table[ours].permute(2, 0, 1)
    path = tmp_path / "dec.pth"
    torch.save({"params_ema": sd}, path)
    port = load_params(Fea2GS(**PAPER_DEC), load_torch_checkpoint(
        path, "fea2gs"))
    tree = _jax_load(path, "fea2gs", "params_ema")
    nsq = int(PAPER_DEC["num_gs_seed"] ** 0.5)
    idx = {"window_cross_attn": cross_attn_rel_pos_index(
        nsq, PAPER_DEC["window_size"]), "gs_self_attn":
        self_attn_rel_pos_index(nsq)}
    for pre, bias in want.items():
        mod = port.get_submodule(pre[:-1])
        assert torch.equal(mod.bias(), bias), pre
        parts = pre[:-1].split(".")
        node = tree[f"{parts[0]}_{parts[1]}"][f"blocks_{parts[3]}"][parts[4]]
        jax_bias = np.asarray(node["relative_position_bias_table"])[
            idx[parts[4]]].transpose(2, 0, 1)
        np.testing.assert_array_equal(jax_bias, bias.numpy())


@pytest.mark.parametrize("fault", ["extra", "missing", "stray"])
def test_extra_or_missing_key_raises(fault, tmp_path):
    """A key the converter reads but the module lacks (a third EDSR block,
    a second cross-attention layer's norm), a key no converter reads (a
    MeanShift's weight), or a missing parameter, raises in load_params."""
    enc, dec = _modules("edsr", 6)
    for mod, kind, key in ((enc, "edsr", "body.2.conv1.weight"),
                           (dec, "fea2gs",
                            "window_crossattn_blocks.0.blocks.2.norm1.bias")):
        sd = mod.state_dict()
        if fault == "extra":
            sd[key] = torch.zeros(3)
        elif fault == "stray":
            sd["sub_mean.weight"] = torch.zeros(3)
        else:
            del sd[next(k for k in sd if k.endswith(".weight"))]
        path = tmp_path / f"{kind}.pth"
        torch.save({"params_ema": sd}, path)
        with pytest.raises(KeyError):
            load_params(mod, load_torch_checkpoint(path, kind))


def test_pretrained_params_and_kinds(tmp_path):
    """load_pretrained_params reads a .pth file's key and a step directory
    of the port's training-state format (the network by its kind), returns
    None for no spec; CONVERTER_KINDS is JAX's; an unknown kind raises."""
    from gsasr_tpu.utils.checkpoint import CONVERTER_KINDS as JKINDS

    enc = _modules("edsr", 7)[0]
    torch.save({"params": enc.state_dict()}, tmp_path / "g.pth")
    got = load_pretrained_params(str(tmp_path / "g.pth"), "edsr", "params")
    assert all(_same_bits(v, enc.state_dict()[k]) for k, v in got.items())
    assert load_pretrained_params("", "edsr") is None
    step = tmp_path / "7"
    step.mkdir()
    dec = _modules("edsr", 8)[1]
    for name, mod in (("net_g", enc), ("net_fea2gs", dec)):
        torch.save({"params": mod.state_dict(), "params_ema": {}},
                   step / f"{name}.pth")
    for kind, mod in (("edsr", enc), ("fea2gs", dec)):
        got = load_pretrained_params(str(step), kind)
        assert got.keys() == mod.state_dict().keys()
        assert all(_same_bits(v, mod.state_dict()[k]) for k, v in got.items())
    with pytest.raises(ValueError, match="unknown checkpoint kind"):
        load_torch_checkpoint(tmp_path / "g.pth", "vgg")
    assert CONVERTER_KINDS == JKINDS
