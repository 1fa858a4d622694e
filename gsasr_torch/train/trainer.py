"""GSASR trainer on one device (counterpart of `gsasr_tpu/train/trainer.py`).

One step: encoder -> decoder -> slot-stacked canvas render -> masked L1
(+ SSIM) -> gradients -> per-network clip by norm -> Adam (0.9/0.99, eps
1e-8) under the multistep warm-up schedule -> EMA (0.999) of both networks.
`accumulation_steps` = k averages k micro-step gradients (a running mean,
as optax.MultiSteps) and updates every k-th call; the EMA moves on every
call.

The decoder runs its module path by default (`dec(feat, scale)`, for the
paper Fea2GS and the Enhanced Fea2GSRopeAMP in the module's compute type)
and its fused path with `fused_decoder=True`, as the JAX Trainer's
`_dec_apply` does: `fea2gs_apply_fused` for Fea2GS, `fea2gs_rope_apply_fused`
for Fea2GSRopeAMP, either with the trunk in the decoder's compute type
(bf16 with fp32 UPNet and heads, or fp32). Per step of the paper decoder
on the card: module path 38 W and 38 WB; fused path 83 M and 38 A forward,
83 MB and 38 AB backward; either way 1 R, 1 RB and 38 T (the bias-table
gradients). The Enhanced decoder's fused path launches 83 M, 38 A, 83 MB
and 38 AB (RDN-Enhanced's two cross blocks 88 and 40 of each), 1 R and 1
RB per step, and no T; at 256 seeds in windows of 16 its attentions take
A-long and AB-long: the HAT-L Ultra decoder 140 M, 140 MB, 64 A-long and
64 AB-long per step, SwinIR-Enhanced's 96, 96, 44 and 44. A
SwinIR encoder adds 18 W, 18 WB, 18 WM, 18 WMB and 36 T per step (its
unshifted and shifted blocks and their bias tables), and its DropPath masks
come from a generator on the trainer's device seeded from (config.seed,
step). The Enhanced decoder at the bf16 recipe launches 38 W-bf16 and 38
WB-bf16, 1 R and 1 RB per step, and no T (RoPE has no bias table). No
GradScaler: bf16 keeps float32's exponent range, and the JAX Trainer uses
none. The forward and backward run with cuDNN's deterministic algorithms,
so one state and batch give one gradient, the same bits, as JAX's do.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Optional, Tuple

import numpy as np
import torch

from gsasr_torch import resolve_device
from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
from gsasr_torch.models.fea2gs_rope import Fea2GSRopeAMP
from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
from gsasr_torch.rendering import render_training_batch
from gsasr_torch.train.losses import masked_l1, size_mask, ssim
from gsasr_torch.train.schedules import multistep_warmup_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Paper recipe defaults (the JAX `TrainConfig`'s fields and defaults)."""
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.9, 0.99)
    milestones: Tuple[int, ...] = (250000, 400000, 450000, 475000)
    gamma: float = 0.5
    total_iter: int = 500000
    warmup_iter: int = 2000
    ema_decay: float = 0.999
    clip_grad_norm: Optional[float] = 5.0
    accumulation_steps: int = 1
    # rendering
    default_step_size: float = 1.2
    dmax: float = 0.5
    dmax_mode: str = "fix"
    if_dmax: bool = True
    # canvas: the largest gt size of the dataset
    canvas_hw: Tuple[int, int] = (192, 192)
    # l_total = L1 + ssim_weight * (1 - SSIM); 0 disables it
    ssim_weight: float = 0.0
    # seed of the encoder's stochastic depth (SwinIR's DropPath): each
    # step's masks come from (seed, step)
    seed: int = 0
    # the decoder through the fused layer kernels (M and A forward, MB and
    # AB backward) instead of the module path (W and WB); the module path
    # stays the default until a step-time A/B on the card picks a winner
    fused_decoder: bool = False


_ADAM_EPS = 1e-8
# optax.clip_by_global_norm's eps: scale = min(1, c / (norm + 1e-12))
_CLIP_EPS = 1e-12
_SSIM_WIN = 11


def _global_norm(grads):
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def deterministic_cudnn():
    """`torch.backends.cudnn.flags` with deterministic=True and every other
    flag as it stands: `flags()` resets each argument it is not given
    (enabled to False among them), so enabled, benchmark and allow_tf32 are
    passed as they are, and the rest of its arguments as None, which leaves
    them alone."""
    cudnn = torch.backends.cudnn
    keep = dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                allow_tf32=cudnn.allow_tf32, deterministic=True)
    rest = {k: None for k in inspect.signature(cudnn.flags).parameters
            if k not in keep}
    return cudnn.flags(**keep, **rest)


class Trainer:
    """`metrics = trainer.step(batch)` on `enc` and `dec` in place.

    Batch dict: lq (B, h, w, 3), gt (B, Hmax, Wmax, 3), scale (B,), gt_h
    (B,), gt_w (B,); or, for sparse supervision, sample_coords (B, K, 2) as
    (y, x) and gt_samples (B, K, 3) instead of gt. Arrays or tensors; they
    are moved to the trainer's device (default: the CUDA card).

    Metrics: loss, l_pix, lr (the schedule at this call's step), l_ssim
    when SSIM is on, grad_norm_g and grad_norm_d when clipping; losses and
    norms are 0-dim tensors on the device. `ema_g` and `ema_d` are copies
    of the networks holding the EMA weights."""

    def __init__(self, enc, dec, config: TrainConfig = TrainConfig(),
                 device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "meshes (data and band axes) come with the multi-GPU slice")
        self.device = resolve_device(device)
        self.cfg = config
        self.enc = enc.to(self.device).train()
        self.dec = dec.to(self.device).train()
        self.ema_g = copy.deepcopy(self.enc).requires_grad_(False).eval()
        self.ema_d = copy.deepcopy(self.dec).requires_grad_(False).eval()
        self.params_g = list(self.enc.parameters())
        self.params_d = list(self.dec.parameters())
        self.schedule = multistep_warmup_schedule(
            config.lr, config.milestones, config.gamma, config.warmup_iter)
        # fused: the step counters stay on the device and every tensor is
        # updated in a few launches; the foreach form spends tens of ms on
        # the host over the two networks' 1,256 parameter tensors
        self.opt = torch.optim.Adam(self.params_g + self.params_d,
                                    lr=config.lr, betas=config.betas,
                                    eps=_ADAM_EPS, fused=True)
        self.step_count = 0    # calls of step()
        self.update_count = 0  # optimizer updates
        self._mini_step = 0
        self._acc = None

    def loss_fn(self, batch):
        """(loss, metrics) of one batch on the current weights, with the
        autograd graph kept."""
        cfg = self.cfg
        if getattr(self.enc, "drop_path_rate", 0.0) > 0.0:
            feat = self.enc(batch["lq"], generator=self.droppath_generator())
        else:
            feat = self.enc(batch["lq"])
        if cfg.fused_decoder and isinstance(self.dec, Fea2GSRopeAMP):
            dt = self.dec.dtype
            gs = fea2gs_rope_apply_fused(
                self.dec, feat, batch["scale"],
                dtype=None if dt == torch.float32 else dt)
        elif cfg.fused_decoder:
            gs = fea2gs_apply_fused(self.dec, feat, batch["scale"])
        else:
            gs = self.dec(feat, batch["scale"])
        out = render_training_batch(
            gs, batch["scale"], batch["gt_h"], batch["gt_w"], cfg.canvas_hw,
            default_step_size=cfg.default_step_size, if_dmax=cfg.if_dmax,
            dmax_mode=cfg.dmax_mode, dmax=cfg.dmax)
        if "sample_coords" in batch:
            c = batch["sample_coords"].long()
            bi = torch.arange(out.shape[0], device=out.device)[:, None]
            sampled = out[bi, c[..., 0], c[..., 1]]
            l_pix = (sampled - batch["gt_samples"]).abs().mean()
            return l_pix, {"l_pix": l_pix}
        mask = size_mask(batch["gt_h"], batch["gt_w"], *cfg.canvas_hw)
        l_pix = masked_l1(out, batch["gt"], mask)
        if cfg.ssim_weight <= 0.0:
            return l_pix, {"l_pix": l_pix}
        # 1 - SSIM per sample over its windows that lie wholly inside its
        # gt_h x gt_w crop, averaged over the batch (the reference's
        # per-crop SSIMLoss); windows over padding are masked out.
        smap = ssim(out * mask, batch["gt"] * mask, reduce=False)
        wh, ww = smap.shape[1], smap.shape[2]
        iy = torch.arange(wh, device=out.device)[None, :, None, None]
        ix = torch.arange(ww, device=out.device)[None, None, :, None]
        vh = batch["gt_h"].long()[:, None, None, None]
        vw = batch["gt_w"].long()[:, None, None, None]
        wmask = ((iy < vh - (_SSIM_WIN - 1))
                 & (ix < vw - (_SSIM_WIN - 1))).to(smap.dtype)
        num = ((1.0 - smap) * wmask).sum(dim=(1, 2, 3))
        den = wmask.sum(dim=(1, 2, 3)) * smap.shape[-1]
        l_ssim = cfg.ssim_weight * (num / den.clamp(min=1.0)).mean()
        return l_pix + l_ssim, {"l_pix": l_pix, "l_ssim": l_ssim}

    def droppath_generator(self) -> torch.Generator:
        """The generator of this step's DropPath masks, on the trainer's
        device, seeded from (config.seed, step): deterministic in (seed,
        step) as the JAX Trainer's fold_in stream is, though not the same
        bits."""
        seed = np.random.SeedSequence(
            (17, self.cfg.seed, self.step_count)).generate_state(1, np.uint64)
        return torch.Generator(device=self.device).manual_seed(int(seed[0]))

    def grads(self, batch):
        """(loss, metrics, grads_g, grads_d) of one batch, moved to the
        device first, with cuDNN's deterministic algorithms; unused
        parameters (the dead LayerNorms, ScaleInject's q/k thirds) get zero
        gradients."""
        params = self.params_g + self.params_d
        with deterministic_cudnn():
            loss, metrics = self.loss_fn(self.to_device(batch))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        n = len(self.params_g)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads[:n], grads[n:]

    def to_device(self, batch):
        """The batch as tensors on the trainer's device, floats in float32."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(self.device)
            out[k] = t.to(torch.float32) if t.is_floating_point() else t
        return out

    def _clip(self, grads):
        norm = _global_norm(grads)
        scale = torch.clamp(self.cfg.clip_grad_norm / (norm + _CLIP_EPS),
                            max=1.0)
        torch._foreach_mul_(grads, scale)
        return norm

    @torch.no_grad()
    def apply(self, loss, metrics, grads_g, grads_d):
        """The update half of `step` on the output of `grads`: clip,
        accumulate, Adam, EMA. Returns the step's metrics."""
        cfg = self.cfg
        metrics = dict(metrics)
        if cfg.clip_grad_norm is not None:
            metrics["grad_norm_g"] = self._clip(grads_g)
            metrics["grad_norm_d"] = self._clip(grads_d)
        grads = grads_g + grads_d
        k = cfg.accumulation_steps
        if k > 1:
            # running mean acc += (g - acc) / (n + 1), as optax.MultiSteps
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, float(self._mini_step + 1))
            torch._foreach_add_(self._acc, diff)
            self._mini_step += 1
            grads = self._acc if self._mini_step == k else None
        if grads is not None:
            # fused Adam reads a gradient as laid out like its parameter
            # (contiguous); autograd may hand back transposed strides
            for p, g in zip(self.params_g + self.params_d, grads):
                p.grad = g.contiguous()
            for group in self.opt.param_groups:
                group["lr"] = self.schedule(self.update_count)
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            self.update_count += 1
            self._acc, self._mini_step = None, 0
        d = cfg.ema_decay
        for ema, net in ((self.ema_g, self.params_g),
                         (self.ema_d, self.params_d)):
            e = list(ema.parameters())
            torch._foreach_mul_(e, d)
            torch._foreach_add_(e, net, alpha=1.0 - d)
        metrics.update(loss=loss, lr=self.schedule(self.step_count))
        self.step_count += 1
        return metrics

    def step(self, batch):
        """One training step on `batch`; returns its metrics."""
        return self.apply(*self.grads(batch))
