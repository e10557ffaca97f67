"""Radix-select top-k on 8-bit digit histograms (counterpart of
``flink_tpu/ops/pallas_topk.py``).

``histogram256`` is the port of the reference's only Pallas kernel,
``_hist_kernel``: a 256-bin int32 histogram of ``(u >> shift) & 0xFF``
over the rows where ``valid`` holds. On a CUDA tensor it launches the
hand-written kernel ``csrc/hist256.cu``; on a CPU tensor it runs the plain
version (an ``index_add_`` of the valid flags into 256 bins).

``masked_topk_hist`` is the torch counterpart of ``_topk_pallas``:
one histogram per 8-bit digit walks the value space top-down and pins the
exact k-th largest value T on the device (no host sync), then the winners
compact the way ``ops/topk.py::_masked_topk_bisect`` does it: strict
winners (> T) first, then the lowest-index ties, found with ``cumsum`` +
``searchsorted`` (deterministic, scatter-free).

Values of every dtype map to a signed int64 ORDER KEY (a < b <=> key(a) <
key(b)): integers are their own key, floats use the sign-magnitude trick
of the reference's ``_to_uint64``. Digits are read from the uint64 word
``key ^ 2^63`` emulated as two int32 words, because torch has no uint64
arithmetic: the high word feeds shifts 56..32 and the low word 24..0.
"""

from __future__ import annotations

import torch

from ..device import note_launch

__all__ = ["histogram256", "histogram256_plain", "masked_topk_hist",
           "order_key", "sentinel"]

_M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)


def _check_hist_args(u: torch.Tensor, valid: torch.Tensor,
                     shift: int) -> None:
    if u.dtype != torch.int32 or u.dim() != 1 or not u.is_contiguous():
        raise ValueError("u must be a contiguous 1-D int32 tensor")
    if valid.dtype not in (torch.bool, torch.uint8) \
            or valid.shape != u.shape or not valid.is_contiguous() \
            or valid.device != u.device:
        raise ValueError("valid must be a contiguous bool/uint8 tensor "
                         "shaped like u, on u's device")
    if not 0 <= shift <= 24:
        raise ValueError(f"shift {shift} outside [0, 24]")


def histogram256_plain(u: torch.Tensor, valid: torch.Tensor,
                       shift: int) -> torch.Tensor:
    """Plain version: [256] int32 counts of ((u >> shift) & 0xFF) where
    valid (any device)."""
    digits = (u.to(torch.int64) >> shift) & 0xFF
    return torch.zeros(256, dtype=torch.int32, device=u.device).index_add_(
        0, digits, valid.to(torch.int32))


def histogram256(u: torch.Tensor, valid: torch.Tensor,
                 shift: int) -> torch.Tensor:
    """[256] int32 histogram of ((u >> shift) & 0xFF) where valid."""
    _check_hist_args(u, valid, shift)
    if u.device.type == "cpu":
        return histogram256_plain(u, valid, shift)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    from . import kernels

    out = torch.zeros(256, dtype=torch.int32, device=u.device)
    n = u.numel()
    if n:
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = kernels.library("hist256").hist256_launch(
            u.data_ptr(), valid.data_ptr(), n, shift, out.data_ptr(), stream)
        kernels.check("hist256", rc)
        note_launch("hist256")
    return out


def sentinel(dtype: torch.dtype):
    """Value of unfilled top-k seats: the dtype's minimum."""
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


def order_key(values: torch.Tensor) -> torch.Tensor:
    """Monotone map of any ordered dtype onto int64 (the reference's
    ``_to_uint64`` followed by a sign-bit flip, so signed int64 compares
    like the uint64 map)."""
    dt = values.dtype
    if dt == torch.float32:
        bits = values.view(torch.int32).to(torch.int64)
        u32 = torch.where(bits >= 0, bits | (1 << 31), (~bits) & _M32)
        return (u32 - (1 << 31)) * (1 << 32)
    if dt == torch.float64:
        bits = values.view(torch.int64)
        return torch.where(bits >= 0, bits, ~bits ^ _I64_MIN)
    if dt.is_floating_point:
        raise TypeError(f"unsupported float dtype {dt}")
    return values.to(torch.int64)


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return ((x ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _digit_plan(dtype: torch.dtype, value_bits: int):
    """(shifts in uint64 bit positions, known prefix high word). Bounded
    non-negative integer domains skip digits above ``value_bits`` (their
    mapped top bits are the constant 1 then 0s); float32's low word is
    always 0; everything else walks all eight digits."""
    if dtype.is_floating_point:
        shifts = (56, 48, 40, 32) if dtype == torch.float32 else \
            (56, 48, 40, 32, 24, 16, 8, 0)
        return shifts, 0
    if value_bits >= 64:
        return (56, 48, 40, 32, 24, 16, 8, 0), 0
    shifts = tuple(s for s in (56, 48, 40, 32, 24, 16, 8, 0)
                   if s < value_bits)
    return shifts, 1 << 31


def masked_topk_hist(values: torch.Tensor, valid: torch.Tensor, k: int,
                     value_bits: int = 64):
    """Exact masked top-k by 8-bit radix select: ``(values[k'], idx[k'],
    ok[k'])`` sorted descending with k' = min(k, n); ``ok`` False marks
    seats left unfilled when fewer than k rows are valid (their value is
    the dtype's minimum). ``value_bits`` bounds a non-negative integer
    domain (ignored for floats)."""
    n = values.numel()
    k = min(int(k), n)
    dev = values.device
    if k == 0:
        return (values[:0].clone(), torch.zeros(0, dtype=torch.int64,
                                                device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    valid = valid.to(torch.bool).contiguous()
    key = order_key(values)
    shifts, hi_seed = _digit_plan(values.dtype, value_bits)
    words = {}
    if any(s >= 32 for s in shifts):
        words["hi"] = _as_int32_bits(((key >> 32) & _M32) ^ (1 << 31))
    if any(s < 32 for s in shifts):
        words["lo"] = _as_int32_bits(key & _M32)
    kk = torch.clamp(valid.sum(), max=k)                 # effective k
    bins = torch.arange(256, dtype=torch.int64, device=dev)
    cand = valid
    above = torch.zeros((), dtype=torch.int64, device=dev)
    prefix = {"hi": torch.full((), hi_seed, dtype=torch.int64, device=dev),
              "lo": torch.zeros((), dtype=torch.int64, device=dev)}
    for s in shifts:
        which = "hi" if s >= 32 else "lo"
        word, sh = words[which], s % 32
        hist = histogram256(word, cand, sh).to(torch.int64)
        # candidates at or above each bin; above + revcum[0] >= kk always
        # holds, so bstar is a real bin (255 when kk == 0, harmlessly)
        revcum = hist.flip(0).cumsum(0).flip(0)
        bstar = torch.where(above + revcum >= kk, bins, -1).amax()
        above = above + torch.where(bins > bstar, hist, 0).sum()
        prefix[which] = prefix[which] | (bstar << sh)
        cand = cand & (((word.to(torch.int64) >> sh) & 0xFF) == bstar)
    # the k-th largest key, back from the uint64 word
    thr = (prefix["hi"] - (1 << 31)) * (1 << 32) + prefix["lo"]
    strict = valid & (key > thr)
    tie = valid & (key == thr)
    cum_s = strict.cumsum(0)
    cum_t = tie.cumsum(0)
    n_s = cum_s[-1]
    # seat t (1-based): the t-th strict row while they last, then the
    # (t - n_s)-th tie row
    targets = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
    pos_s = torch.searchsorted(cum_s, targets)
    pos_t = torch.searchsorted(cum_t, torch.clamp(targets - n_s, min=1))
    idx = torch.clamp(torch.where(targets <= n_s, pos_s, pos_t), max=n - 1)
    filled = targets <= kk
    buf_v = torch.where(filled, values[idx], sentinel(values.dtype))
    # filled seats first, then value descending (ties in reverse seat
    # order, as the reference's lexsort(...)[::-1])
    sec = torch.where(filled, order_key(buf_v), _I64_MIN)
    o1 = torch.sort(sec, stable=True).indices
    o2 = torch.sort(filled[o1].to(torch.int8), stable=True).indices
    order = o1[o2].flip(0)
    return buf_v[order], idx[order], filled[order]
