"""Device policy, dtype bridge and the kernel launch counters.

* Entry points take an explicit ``device`` and default to ``"cuda"``.
  Without CUDA they raise unless the caller asked for ``"cpu"``: there is
  no quiet fallback, so a run on the CPU is always one somebody asked for.
* Every kernel wrapper adds one to its counter in ``KERNEL_LAUNCHES``
  where it launches its kernel, and nowhere else; a replay of a CUDA
  graph adds one for each kernel launch the graph holds. A launch of
  ``ingest_step`` in one of its two optional forms also counts into the
  form's own counter, ``ingest_step_dirty`` (dirty marking) or
  ``ingest_step_spill`` (the spill split, which marks dirty blocks too).
  A session window launches ``session_step`` once per batch and
  ``session_fire`` once per fire round. A device GROUP BY batch launches
  ``group_agg_first``, ``_compact``, ``_fold`` and ``_emit`` once each.
  The device list state of the interval join counts one launch of
  ``list_append`` (one cooperative kernel) and ``list_prune`` (one
  kernel) a call, and ``list_probe`` a launch of its one kernel (a call
  launches again only when its matches pass the output's room).
  The row plane counts one launch of ``dedup_first`` and ``row_set`` a
  call (each one cooperative kernel) and of ``row_get`` and
  ``row_unset`` (one kernel each).
  A caller resets the counters, drives a path and reads them back to show
  which kernels the path went through.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["resolve_device", "KERNEL_LAUNCHES", "note_launch",
           "reset_launches", "torch_dtype", "numpy_dtype"]

#: kernel name -> launches since the last reset
KERNEL_LAUNCHES: dict[str, int] = {"hist256": 0, "hash_probe": 0,
                                   "ingest_step": 0, "ingest_step_dirty": 0,
                                   "ingest_step_spill": 0, "window_seal": 0,
                                   "window_rebuild": 0, "session_step": 0,
                                   "session_fire": 0, "group_agg_first": 0,
                                   "group_agg_compact": 0,
                                   "group_agg_fold": 0, "group_agg_emit": 0,
                                   "list_append": 0, "list_probe": 0,
                                   "list_prune": 0, "dedup_first": 0,
                                   "row_set": 0, "row_get": 0,
                                   "row_unset": 0}
# the tasks of a job launch from threads of their own
_LAUNCH_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.
    Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flink_tpu_torch runs on a CUDA device unless told otherwise, "
            "and torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


def note_launch(kernel: str) -> None:
    """Count one launch of ``kernel``. A launch recorded into a CUDA graph
    under capture does not run then: its graph's replays count it
    (``runtime/compiled.py``)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    with _LAUNCH_LOCK:
        KERNEL_LAUNCHES[kernel] = KERNEL_LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[name] = 0


_NP_TO_TORCH = {
    np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or name, or torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def numpy_dtype(dtype) -> np.dtype:
    """torch dtype (or numpy dtype) -> numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)
