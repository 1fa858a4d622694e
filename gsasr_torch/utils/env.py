"""Runtime environment banner (counterpart of `gsasr_tpu/utils/env.py`)."""

from __future__ import annotations


def get_env_info() -> str:
    """The reference's `get_env_info` (`basicsr/utils/logger.py:188-213`):
    Python, PyTorch and CUDA versions, the cards' name and count, this
    process's rank."""
    import platform

    import numpy as np
    import torch

    lines = [f"python: {platform.python_version()}",
             f"torch: {torch.__version__}",
             f"numpy: {np.__version__}",
             f"CUDA: {torch.version.cuda or 'none'}"]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        lines.append(f"cards: {n}x {torch.cuda.get_device_name(0)}")
    else:
        lines.append("cards: none (CPU)")
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        lines.append(f"rank: {dist.get_rank()}/{dist.get_world_size()}")
    return "\n\t".join(["Environment:"] + lines)
