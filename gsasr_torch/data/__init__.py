"""Training data: the continuous-scale bicubic dataset, validation pairs,
the epoch sampler, threaded batches and the device prefetcher (host-side
numpy, as in the JAX package, with the bicubic resize's C++ core)."""

from gsasr_torch.data.matlab_resize import imresize, imresize_new

__all__ = ["imresize", "imresize_new"]
