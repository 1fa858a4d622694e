"""The port's paper Trainer against the JAX package's on the CPU: the loss
and gradients of one batch, and three steps (moved here from
tests/test_torch_trainer.py, whose helpers they use, so that the test runs
spread over more files).
"""

import jax
import jax.numpy as jnp
import numpy as np

from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.train.schedules import multistep_warmup_schedule
from test_torch_trainer import (CFG, STEP_CFG, _assert_ema_close,
                                _assert_params_close, _batch, _by_name,
                                _jax_trainer, _nets, _run_both)


def test_loss_and_grads_match_jax():
    enc, dec, params = _nets(1)
    batch = _batch(2)
    jtr, _ = _jax_trainer(params, CFG)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jtr._loss_fn, has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    tr = Trainer(enc, dec, TrainConfig(**CFG), device="cpu")
    loss, met, g_g, g_d = tr.grads(batch)
    # 1e-5 relative: the render sums Gaussians in another order
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["l_pix"]), float(jmet["l_pix"]),
                               rtol=1e-5)
    want_g, want_d = _by_name(jgrads["g"], jgrads["d"])
    for mod, grads, want in ((enc, g_g, want_g), (dec, g_d, want_d)):
        for (name, _), got in zip(mod.named_parameters(), grads):
            ref = want[name]
            # 1e-3 of the tensor's largest entry: a gradient chain through
            # the render's moment sums and the decoder, summed in another
            # order
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                                       atol=1e-3 * np.abs(ref).max() + 1e-9,
                                       err_msg=name)


def test_three_steps_match_jax_trainer():
    """Default options (clip 5, Adam, warm-up, EMA at STEP_CFG's decay) for
    three steps from the same weights."""
    batches = [_batch(s) for s in (4, 5, 6)]
    tr, state, jm, tm, start = _run_both(STEP_CFG, batches)
    for j, t in zip(jm, tm):
        assert set(t) == set(j)
        for k in j:
            # 1e-4 relative: losses, norms and the schedule in float32
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    sched = multistep_warmup_schedule(2e-4, (100,), 0.5, 2)
    assert tr.update_count == 3
    _assert_params_close(tr, state, sum(sched(n) for n in range(3)))
    _assert_ema_close(tr, state, start)
