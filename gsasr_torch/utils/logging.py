"""Training loggers (a copy of `gsasr_tpu/utils/logging.py`, host-only
code) — equivalents of `basicsr/utils/logger.py`.

- AvgTimer (:10-44): windowed average iteration timer.
- MessageLogger (:45-117): epoch/iter/lr/time/ETA console lines + optional
  TensorBoard scalars (through tensorboardX or torch.utils.tensorboard
  where either is installed, else none).
- get_root_logger (:146-186): rank-aware logger (suppresses non-zero
  ranks of torch.distributed like the reference does).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional


def _rank() -> int:
    """This process's rank in torch.distributed, 0 outside it."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def get_root_logger(name="gsasr_torch", log_file: Optional[str] = None,
                    level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s: %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    is_main = _rank() == 0
    logger.setLevel(level if is_main else logging.ERROR)
    if log_file and is_main:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class AvgTimer:
    """Windowed average timer (`logger.py:10-44`)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.times = []
        self._start = time.time()

    def start(self):
        self._start = time.time()

    def record(self):
        self.times.append(time.time() - self._start)
        if len(self.times) > self.window:
            self.times.pop(0)
        self._start = time.time()

    def get_avg_time(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


class MessageLogger:
    """Console + TensorBoard training logger (`logger.py:45-117`)."""

    def __init__(self, total_iter: int, start_iter: int = 0,
                 tb_dir: Optional[str] = None):
        self.total_iter = total_iter
        self.start_iter = start_iter
        self.start_time = time.time()
        self.logger = get_root_logger()
        self.tb = None
        if tb_dir:
            try:
                from tensorboardX import SummaryWriter  # type: ignore
                self.tb = SummaryWriter(tb_dir)
            except ImportError:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self.tb = SummaryWriter(tb_dir)
                except Exception:
                    self.logger.warning("no tensorboard writer available")

    def __call__(self, it: int, epoch: int, lr: float,
                 metrics: Dict[str, float], iter_time: float = None):
        msg = f"[epoch:{epoch:3d}, iter:{it:8,d}, lr:({lr:.3e})] "
        if iter_time is not None:
            done = max(it - self.start_iter, 1)
            eta = iter_time * (self.total_iter - it)
            msg += f"[time: {iter_time:.3f}s, eta: {eta/3600:.1f}h] "
        msg += " ".join(f"{k}: {v:.4e}" for k, v in metrics.items())
        self.logger.info(msg)
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"train/{k}", v, it)
            self.tb.add_scalar("train/lr", lr, it)

    def log_validation(self, it: int, dataset: str,
                       metrics: Dict[str, float],
                       best: Optional["MetricHistory"] = None):
        msg = f"Validation {dataset} @ iter {it:,d}: " + ", ".join(
            f"{k}: {v:.4f}" for k, v in metrics.items())
        if best is not None:
            msg += " | best: " + ", ".join(
                f"{k}: {rec['val']:.4f}@{rec['iter']:,d}"
                for k, rec in best.best(dataset).items())
        self.logger.info(msg)
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"metrics/{dataset}/{k}", v, it)


# Metrics where a smaller value is better (`basicsr/metrics`: lpips, dists,
# niqe, fid); everything else (psnr, ssim) is higher-better, matching the
# reference's per-metric `better: higher|lower` yaml key default.
_LOWER_BETTER = {"lpips", "dists", "niqe", "fid"}


class MetricHistory:
    """Validation metric history with best tracking — equivalent of
    `base_model.py:50-73` (`_initialize_best_metric_results` /
    `_update_best_metric_result`)."""

    def __init__(self):
        self._hist: Dict[str, Dict[str, list]] = {}
        self._best: Dict[str, Dict[str, Dict]] = {}

    def update(self, dataset: str, it: int,
               metrics: Dict[str, float]) -> bool:
        """Record one validation round; returns True if any metric improved
        on its best."""
        hist = self._hist.setdefault(dataset, {})
        best = self._best.setdefault(dataset, {})
        improved = False
        for name, val in metrics.items():
            hist.setdefault(name, []).append((it, float(val)))
            lower = name.lower() in _LOWER_BETTER
            rec = best.get(name)
            if (rec is None or (val < rec["val"] if lower
                                else val > rec["val"])):
                best[name] = {"val": float(val), "iter": it}
                improved = True
        return improved

    def best(self, dataset: str) -> Dict[str, Dict]:
        return self._best.get(dataset, {})

    def history(self, dataset: str, metric: str):
        return self._hist.get(dataset, {}).get(metric, [])


def init_wandb_logger(opt) -> Optional[object]:
    """W&B run init — equivalent of `basicsr/utils/logger.py:126-144`
    (resume by wandb_id, project from opt['logger']['wandb']). Returns the
    run object, or None when the wandb package is unavailable (zero-egress
    environments) or unconfigured."""
    wandb_opt = (opt.get("logger", {}) or {}).get("wandb") or {}
    if not wandb_opt.get("project"):
        return None
    try:
        import wandb  # type: ignore
    except ImportError:
        get_root_logger().warning(
            "wandb requested in yaml but the package is not installed; "
            "continuing without it")
        return None
    resume_id = wandb_opt.get("resume_id")
    kwargs = dict(resume="allow", id=resume_id) if resume_id else {}
    run = wandb.init(project=wandb_opt["project"],
                     name=opt.get("name"), config=dict(opt),
                     sync_tensorboard=True, **kwargs)
    get_root_logger().info(f"Use wandb logger; id={run.id}")
    return run
