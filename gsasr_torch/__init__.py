"""GSASR in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

A port of `gsasr_tpu` (JAX/Pallas) module by module: the same names, the
same public layouts (NHWC images, (B, N, 9) Gaussian parameters, (3, H, W)
renders) and reference-PyTorch `state_dict` keys. Every Pallas kernel on the
ported path has a CUDA counterpart under `ops/csrc/` and a plain PyTorch
version of the same function beside its wrapper; the wrapper takes the
plain version only for tensors on the CPU.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    first CUDA card. Without a card and without an explicit request for the
    CPU this raises rather than running quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gsasr_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")
