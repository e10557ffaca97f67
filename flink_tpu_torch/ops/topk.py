"""Exact masked top-k (port of ``flink_tpu/ops/topk.py``).

Contract: ``(values[k'], indices[k'], ok[k'])`` with k' = min(k, n), sorted
descending; ``ok[i]`` False marks a seat left unfilled when fewer than k
rows are valid, and such a seat holds the dtype's minimum.

Every dtype runs the 8-bit histogram radix select of
``radix_topk.masked_topk_hist``, whose histogram is the hand-written
CUDA kernel on the card. Ties at the k-th value take the lowest indices.
``masked_topk_sort`` (``torch.topk``) is the plain reference.
"""

from __future__ import annotations

import torch

from .radix_topk import masked_topk_hist, sentinel

__all__ = ["masked_topk", "masked_topk_sort"]


def masked_topk(values: torch.Tensor, valid: torch.Tensor, k: int,
                value_bits: int = 64):
    """``value_bits``: static bound on a non-negative integer value domain
    (below 2^value_bits); each 8 bits saved drops one histogram pass.
    64 is always safe. Floats ignore it."""
    return masked_topk_hist(values, valid, k, value_bits)


def masked_topk_sort(values: torch.Tensor, valid: torch.Tensor, k: int):
    """Sort-based reference: ``torch.topk`` over sentinel-masked values."""
    masked = torch.where(valid, values, sentinel(values.dtype))
    kk = min(int(k), values.numel())
    vals, idx = torch.topk(masked, kk)
    return vals, idx, valid[idx]
