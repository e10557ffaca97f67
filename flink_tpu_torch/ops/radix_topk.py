"""Radix-select top-k on 8-bit digit histograms (counterpart of
``flink_tpu/ops/pallas_topk.py``).

``histogram256`` keeps the contract of the reference's only Pallas kernel,
``_hist_kernel``: a 256-bin int32 histogram of ``(u >> shift) & 0xFF``
over the rows where ``valid`` holds.

``radix_select`` pins the exact k-th largest value T on the device, one
8-bit digit per pass, top-down. Each pass (``csrc/hist256.cu``, the same
source as the histogram) reads the ranked values in their own dtype, maps
them to their order word in registers, counts the digit of the rows that
are valid and still match the prefix fixed so far, and updates a [3] int64
device state, (prefix word, rows above it, kk): on a CUDA tensor one launch
per pass and no other launch between the first pass and the last.

``masked_topk_hist`` is the torch counterpart of ``_topk_pallas``: the
select, then the winners compact the way
``ops/topk.py::_masked_topk_bisect`` does it: strict winners (> T) first,
then the lowest-index ties, found with ``cumsum`` + ``searchsorted``
(deterministic, scatter-free). No host sync anywhere.

Values of every dtype map to a signed int64 ORDER KEY (a < b <=> key(a) <
key(b)): integers are their own key, floats use the sign-magnitude trick
of the reference's ``_to_uint64``. A pass reads digits from the uint64
ORDER WORD ``key ^ 2^63``; torch has no uint64 arithmetic, so the plain
versions hold the word's 64 bits in an int64.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..device import note_launch

__all__ = ["histogram256", "histogram256_plain", "masked_topk_hist",
           "radix_select", "radix_select_plain", "digit_plan", "order_key",
           "sentinel"]

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_SHIFTS = (56, 48, 40, 32, 24, 16, 8, 0)
#: value dtype -> dtype code of csrc/hist256.cu (bool reads as uint8)
_CODES = {torch.int64: 0, torch.int32: 1, torch.float32: 2,
          torch.float64: 3, torch.uint8: 4, torch.bool: 4}
_GRIDS: dict[tuple, int] = {}        # (device, code, select) -> blocks
_WORKSPACE: dict[tuple, tuple] = {}  # (device, stream) -> (ticket, partials)


def _check_hist_args(u: torch.Tensor, valid: torch.Tensor,
                     shift: int) -> None:
    if u.dtype != torch.int32 or u.dim() != 1 or not u.is_contiguous():
        raise ValueError("u must be a contiguous 1-D int32 tensor")
    _check_valid(u, valid)
    if not 0 <= shift <= 24:
        raise ValueError(f"shift {shift} outside [0, 24]")


def _check_valid(values: torch.Tensor, valid: torch.Tensor) -> None:
    if valid.dtype not in (torch.bool, torch.uint8) \
            or valid.shape != values.shape or not valid.is_contiguous() \
            or valid.device != values.device:
        raise ValueError("valid must be a contiguous bool/uint8 tensor "
                         "shaped like the values, on their device")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def _grid(dev: torch.device, code: int, select: bool) -> int:
    """Blocks of one resident wave of the pass kernel, asked once per
    (device, dtype, mode) and process."""
    from . import kernels

    key = (dev.index, code, select)
    grid = _GRIDS.get(key)
    if grid is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            kernels.check("hist256", kernels.library("hist256").radix_grid(
                code, int(select), ctypes.byref(out)))
        grid = _GRIDS[key] = out.value
    return grid


def _workspace(dev: torch.device, grid: int):
    """(ticket, partials) of the current stream: a uint32 ticket that every
    launch leaves at 0, so it is zeroed once, and the [grid, 256] int32
    partial counts. Launches on one stream run in order, so they share it."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[1].numel() < grid * 256:
        ticket = ws[0] if ws is not None else torch.zeros(
            1, dtype=torch.int32, device=dev)
        ws = _WORKSPACE[key] = (ticket, torch.empty(
            grid * 256, dtype=torch.int32, device=dev))
    return ws


def _aligned(*tensors: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


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
    _require_cuda(u)
    from . import kernels

    out = torch.empty(256, dtype=torch.int32, device=u.device)
    n = u.numel()
    if n == 0:
        return out.zero_()
    grid = _grid(u.device, _CODES[torch.int32], False)
    ticket, partials = _workspace(u.device, grid)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = kernels.library("hist256").hist256_launch(
        u.data_ptr(), valid.data_ptr(), n, shift, _aligned(u, valid),
        out.data_ptr(), partials.data_ptr(), ticket.data_ptr(), grid, stream)
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
        u32 = torch.where(bits >= 0, bits | (1 << 31), (~bits) & 0xFFFFFFFF)
        return (u32 - (1 << 31)) * (1 << 32)
    if dt == torch.float64:
        bits = values.view(torch.int64)
        return torch.where(bits >= 0, bits, ~bits ^ _I64_MIN)
    if dt.is_floating_point:
        raise TypeError(f"unsupported float dtype {dt}")
    return values.to(torch.int64)


def digit_plan(dtype: torch.dtype, value_bits: int):
    """([(shift, mask)] per pass, top-down, and the seed prefix word).

    A pass counts the rows whose order-word bits under ``mask`` equal the
    prefix fixed by the passes before it: the bits from the end of the
    first pass's digit down to the end of this pass's. Bounded
    non-negative integer domains skip the digits above ``value_bits``
    (their order words start with the constant bits of ``seed``: a 1, then
    0s); float32's low word is always 0; everything else walks all eight
    digits."""
    if dtype.is_floating_point:
        shifts = _SHIFTS[:4] if dtype == torch.float32 else _SHIFTS
        seed = 0
    elif value_bits >= 64:
        shifts, seed = _SHIFTS, 0
    else:
        shifts = tuple(s for s in _SHIFTS if s < max(value_bits, 1))
        seed = 1 << 63
    top = shifts[0] + 8
    plan = [(s, 0 if i == 0 else ((1 << top) - 1) & ~((1 << (s + 8)) - 1))
            for i, s in enumerate(shifts)]
    return plan, seed


def _signed(word: int) -> int:
    """A uint64 word as the int64 with the same bits."""
    return word - (1 << 64) if word > _I64_MAX else word


def radix_select_plain(values: torch.Tensor, valid: torch.Tensor, k: int,
                       value_bits: int = 64,
                       hists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``radix_select`` (any device): the same passes in
    torch operators on the int64 bits of the order word."""
    plan, seed = digit_plan(values.dtype, value_bits)
    word = order_key(values) ^ _I64_MIN
    bins = torch.arange(256, dtype=torch.int64, device=values.device)
    state = torch.empty(3, dtype=torch.int64, device=values.device)
    for i, (shift, mask) in enumerate(plan):
        cand = valid if mask == 0 else \
            valid & (((word ^ state[0]) & _signed(mask)) == 0)
        digit = (word >> shift) & 0xFF
        hist = torch.zeros(256, dtype=torch.int64,
                           device=values.device).index_add_(
            0, digit, cand.to(torch.int64))
        if hists is not None:
            hists[i] = hist.to(torch.int32)
        # candidates at or above each bin; above + revcum[0] >= kk always
        # holds, so bstar is a real bin (255 when kk == 0, harmlessly)
        revcum = hist.flip(0).cumsum(0).flip(0)
        if i == 0:
            state[0] = _signed(seed)
            state[1] = 0
            state[2] = torch.clamp(revcum[0], max=k)
        bstar = torch.where(state[1] + revcum >= state[2], bins, -1).amax()
        state[1] += torch.where(bins > bstar, hist, 0).sum()
        # bstar << shift without int64 overflow: the top digit as int8
        digit_bits = bstar - ((bstar >> 7) << 8) if shift == 56 else bstar
        state[0] |= digit_bits * (1 << shift)
    return state


def radix_select(values: torch.Tensor, valid: torch.Tensor, k: int,
                 value_bits: int = 64,
                 hists: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The [3] int64 state (prefix word, rows above it, kk) after every
    digit pass of the exact k-th largest value among the valid rows:
    ``state[0] ^ -2^63`` is that value's order key and ``state[2]`` is
    min(k, valid rows). ``value_bits`` bounds a non-negative integer
    domain (ignored for floats). ``hists``, if given, an int32
    [passes, 256] tensor, receives each pass's histogram."""
    if values.dim() != 1 or not values.is_contiguous():
        raise ValueError("values must be a contiguous 1-D tensor")
    _check_valid(values, valid)
    if values.device.type == "cpu":
        return radix_select_plain(values, valid, k, value_bits, hists)
    _require_cuda(values)
    from . import kernels

    code = _CODES.get(values.dtype)
    if code is None:
        raise TypeError(f"the select kernel does not take {values.dtype}")
    n = values.numel()
    if not 0 < n < (1 << 31):
        raise ValueError(f"the select kernel takes 1 to 2^31 - 1 rows, "
                         f"not {n}")
    plan, seed = digit_plan(values.dtype, value_bits)
    if hists is not None and (hists.dtype != torch.int32
                              or hists.shape != (len(plan), 256)
                              or not hists.is_contiguous()
                              or hists.device != values.device):
        raise ValueError(f"hists must be a contiguous int32 "
                         f"[{len(plan)}, 256] tensor on the values' device")
    dev = values.device
    grid = _grid(dev, code, True)
    ticket, partials = _workspace(dev, grid)
    state = torch.empty(3, dtype=torch.int64, device=dev)
    vec = _aligned(values, valid)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = kernels.library("hist256")
    for i, (shift, mask) in enumerate(plan):
        rc = lib.radix_pass_launch(
            values.data_ptr(), code, valid.data_ptr(), n, shift, mask, seed,
            k, int(i == 0), vec, state.data_ptr(),
            hists[i].data_ptr() if hists is not None else None,
            partials.data_ptr(), ticket.data_ptr(), grid, stream)
        kernels.check("hist256", rc)
        note_launch("hist256")
    return state


def _compare_space(values: torch.Tensor, thr_key: torch.Tensor):
    """(values in a space ordered like their order keys, the threshold key
    in that space). Integers compare as they are; floats through their
    sign-magnitude bits at their own width, where -0.0 < +0.0 and NaNs
    order by their bits, as in the order key."""
    dt = values.dtype
    if dt == torch.float32:
        bits = values.view(torch.int32)
        return bits ^ ((bits >> 31) & 0x7FFFFFFF), \
            (thr_key >> 32).to(torch.int32)
    if dt == torch.float64:
        bits = values.view(torch.int64)
        return bits ^ ((bits >> 63) & _I64_MAX), thr_key
    if dt.is_floating_point:
        raise TypeError(f"unsupported float dtype {dt}")
    return values, thr_key


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
    values = values.contiguous()
    valid = valid.to(torch.bool).contiguous()
    state = radix_select(values, valid, k, value_bits)
    kk = state[2]
    # the k-th largest order key, back from the uint64 word; when kk == 0
    # it is no value's key, and no seat is filled below
    cmp, thr = _compare_space(values, state[0] ^ _I64_MIN)
    strict = valid & (cmp > thr)
    tie = valid & (cmp == thr)
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
