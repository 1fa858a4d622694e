"""RDN's Enhanced sr_forward against JAX's on the CPU, the decoder of two
cross-attention blocks on its fused path with the family's bf16 trunk
(moved here from tests/test_torch_enhanced_train.py, whose helpers it
uses, so that the test runs spread over more files).
"""

import jax.numpy as jnp
import numpy as np
import torch

from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.models import RDNNOUP as JRDN
from test_torch_enhanced_train import _port, _weights


def test_rdn_enhanced_sr_forward_matches_jax():
    """sr_forward of RDN (config B, g0 = 8) with an Enhanced decoder of two
    cross-attention blocks (`gsasr_tpu/model.py`'s RDN enhanced_cfg; the
    converter reads both blocks) against JAX's sr_forward, the decoder on
    its fused path with the family's bf16 trunk and fp32 heads. Tolerance
    that of test_torch_enhanced.py's EDSR case: the bf16 trunk's one-step
    differences, through the Gaussians into the image."""
    from gsasr_tpu.model import sr_forward as jsr_forward
    from gsasr_torch.model import sr_forward

    dec_kw = dict(inchannel=8, channel=32, num_heads=4,
                  num_crossattn_blocks=2, num_crossattn_layers=2,
                  num_selfattn_blocks=1, num_selfattn_layers=2,
                  num_gs_seed=16, window_size=4)
    enc_spec = ("rdn", dict(g0=8))
    params = _weights(9, dec_kw, enc=enc_spec)
    enc, dec = _port(params, dec_kw, enc=enc_spec)
    assert len(dec.window_crossattn_blocks) == 2
    lq = np.random.default_rng(10).random((1, 10, 13, 3), dtype=np.float32)
    ref = np.asarray(jsr_forward(JRDN(g0=8), JRope(**dec_kw), params["g"],
                                 params["d"], jnp.asarray(lq), 3.3,
                                 denominator=4, dmax=0.5))
    out = sr_forward(enc.eval(), dec.eval(), torch.from_numpy(lq), 3.3,
                     denominator=4, dmax=0.5, device="cpu").numpy()
    assert out.shape == ref.shape == (1, 33, 42, 3)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3)
