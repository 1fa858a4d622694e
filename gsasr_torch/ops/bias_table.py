"""Relative-position bias gather with a deterministic gradient.

The window attentions read their bias as bias[h, i, j] = table[index[i, j],
h]. PyTorch's indexing backward adds into the table with atomics on the
card, so its bits change from run to run, while the JAX package's gather
gradient (XLA's scatter on the TPU) does not. Here the backward sums each
table row's entries in ascending position order from an inverse index:
kernel T (`csrc/bias_table_bwd.cu`) on CUDA tensors, one thread per (row,
head), and a gather-and-sum over the same index on CPU tensors. Neither
uses an accumulating index-put or index-add.
"""

from __future__ import annotations

import numpy as np
import torch

from gsasr_torch.ops import _build


def inverse_index(index: np.ndarray, rows: int) -> np.ndarray:
    """(rows, maxc) int32: row r lists the flat positions p with
    index.flat[p] == r in ascending order, padded with index.size."""
    flat = np.asarray(index).reshape(-1)
    counts = np.bincount(flat, minlength=rows)
    order = np.argsort(flat, kind="stable")
    starts = np.cumsum(counts) - counts
    out = np.full((rows, max(int(counts.max()), 1)), flat.size, np.int32)
    out[flat[order], np.arange(flat.size) - np.repeat(starts, counts)] = order
    return out


def bias_table_bwd_plain(g, inverse):
    """Plain PyTorch version of kernel T: g (nh, Tq, Tk) -> the table
    gradient (rows, nh)."""
    nh = g.shape[0]
    gf = torch.cat([g.reshape(nh, -1), g.new_zeros(nh, 1)], dim=1)
    return gf[:, inverse.long()].sum(dim=-1).t().contiguous()


def bias_table_bwd(g, inverse):
    """Kernel T on CUDA tensors, its plain version on CPU tensors."""
    if g.device.type == "cpu":
        return bias_table_bwd_plain(g, inverse)
    _build.check_tensor(g, "g")
    _build.check_tensor(inverse, "inverse", dtype=torch.int32)
    nh = g.shape[0]
    rows, maxc = inverse.shape
    dtable = torch.empty((rows, nh), dtype=torch.float32, device=g.device)
    _build.launch("bias_table_bwd", g.contiguous(), inverse.contiguous(),
                  dtable, rows, maxc, nh, g[0].numel())
    bias_table_bwd.launches += 1
    return dtable


bias_table_bwd.launches = 0


class _BiasGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, index, inverse):
        ctx.save_for_backward(inverse)
        return table.t()[:, index]

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        return bias_table_bwd(g, inverse), None, None


def relative_position_bias(table, index, inverse):
    """(num_heads, Tq, Tk) bias from table (rows, num_heads), index (Tq, Tk)
    int64 and `inverse_index(index, rows)` as an int32 tensor;
    differentiable in the table."""
    return _BiasGather.apply(table, index, inverse)
