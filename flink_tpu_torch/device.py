"""Device policy, dtype bridge and the kernel launch counters.

* Entry points take an explicit ``device`` and default to ``"cuda"``.
  Without CUDA they raise unless the caller asked for ``"cpu"``: there is
  no quiet fallback, so a run on the CPU is always one somebody asked for.
* Every kernel wrapper adds one to its counter in ``KERNEL_LAUNCHES``
  where it launches its kernel, and nowhere else. A caller resets the
  counters, drives a path and reads them back to show which kernels the
  path went through.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "KERNEL_LAUNCHES", "note_launch",
           "reset_launches", "torch_dtype", "numpy_dtype"]

#: kernel name -> launches since the last reset
KERNEL_LAUNCHES: dict[str, int] = {"hist256": 0, "hash_probe": 0,
                                   "ingest_step": 0}


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
    KERNEL_LAUNCHES[kernel] = KERNEL_LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


_NP_TO_TORCH = {
    np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
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
