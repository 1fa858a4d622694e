"""Learning-rate schedule of the paper recipe (counterpart of
`gsasr_tpu/train/schedules.py::multistep_warmup_schedule`): MultiStepLR
(lr *= gamma at each milestone) times a linear warm-up
min((step + 1) / warmup_iter, 1)."""

from __future__ import annotations

import bisect
from typing import Sequence


def multistep_warmup_schedule(base_lr: float, milestones: Sequence[int],
                              gamma: float = 0.5, warmup_iter: int = -1):
    """MultiStepLR x linear warm-up: a function of the step (counted from
    0) to the learning rate."""
    ms = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        lr = base_lr * gamma ** bisect.bisect_right(ms, int(step))
        if warmup_iter > 0:
            lr *= min((int(step) + 1.0) / warmup_iter, 1.0)
        return lr

    return schedule
