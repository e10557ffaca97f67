"""The mesh: shards, their devices and key-group routing (port of
``flink_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` of n devices that one
process drives. The port's is the same single-controller shape: one
process holds D shards, each a set of tensors on a ``torch.device`` from
the list ``make_mesh`` returns. By default every shard sits on the entry
point's device, so one card holds all D shards, as the reference's tests
put 8 shards on one CPU.

A shard index is a position along the mesh; shard i owns the contiguous
key-group range ``shard_ranges`` gives it, with the reference's rounding
(``KeyGroupRangeAssignment``), so mesh checkpoints restore onto host
subtasks, other mesh sizes and the single-device operator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.keygroups import KeyGroupRange, _M32, _mul32, _rotl32_t, \
    key_group_range_for_operator, key_groups_device
from ..device import resolve_device

__all__ = ["make_mesh", "shard_ranges", "murmur_mix_device",
           "hash_int64_device", "key_groups_device",
           "device_index_for_key_groups", "DATA_AXIS"]

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              device=None) -> list[torch.device]:
    """The device of each of ``n_devices`` shards. ``devices``: the first
    ``n_devices`` of that list (it must hold that many); otherwise every
    shard on ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        n = len(devs) if n_devices is None else int(n_devices)
        if len(devs) < n:
            raise ValueError(f"need {n} devices, have {len(devs)}")
        return devs[:n]
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return [resolve_device(device)] * n


def shard_ranges(max_parallelism: int, n_devices: int,
                 base: Optional[KeyGroupRange] = None
                 ) -> list[KeyGroupRange]:
    """Key-group range owned by each mesh position. With ``base`` the
    shards split that subtask range instead of the whole key space (the
    two-level split: host subtasks by operator-index math, then the local
    mesh within a subtask's range, with the same rounding in local
    coordinates). Device i gets [ceil(i*MP/n), floor(((i+1)*MP - 1)/n)]:
    contiguous ranges that cover the space exactly, sizes differing by at
    most one. Every range must be non-empty."""
    if base is None:
        if max_parallelism < n_devices:
            raise ValueError(
                f"max_parallelism {max_parallelism} < {n_devices} devices "
                f"leaves some devices without key groups; raise "
                f"pipeline.max-parallelism or shrink the mesh")
        return [key_group_range_for_operator(max_parallelism, n_devices, i)
                for i in range(n_devices)]
    length = base.end - base.start + 1
    if length < n_devices:
        raise ValueError(
            f"subtask key-group range {base} has {length} groups < "
            f"{n_devices} devices; raise pipeline.max-parallelism")
    out = []
    for i in range(n_devices):
        r = key_group_range_for_operator(length, n_devices, i)
        out.append(KeyGroupRange(base.start + r.start, base.start + r.end))
    return out


def murmur_mix_device(code: torch.Tensor) -> torch.Tensor:
    """``core.keygroups.murmur_mix`` on a tensor of uint32 codes held in
    int64: the non-negative int32 result, bit-equal to the host path."""
    k = code.to(torch.int64) & _M32
    k = _mul32(k, 0xCC9E2D51)
    k = _rotl32_t(k, 15)
    k = _mul32(k, 0x1B873593)
    h = _rotl32_t(k, 13)
    h = (_mul32(h, 5) + 0xE6546B64) & _M32
    h = h ^ 4
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    s = torch.where(h >= (1 << 31), h - (1 << 32), h)
    return torch.where(s == -(1 << 31), torch.zeros_like(s),
                       s.abs()).to(torch.int32)


def hash_int64_device(keys: torch.Tensor) -> torch.Tensor:
    """The integer fast path of ``hash_batch`` (Long.hashCode: v ^ (v >>>
    32), low 32 bits), as uint32 values in int64."""
    u = keys.to(torch.int64)
    return (u ^ ((u >> 32) & _M32)) & _M32


def device_index_for_key_groups(key_groups: torch.Tensor, n_devices: int,
                                max_parallelism: int, base_start: int = 0,
                                base_len: Optional[int] = None
                                ) -> torch.Tensor:
    """``operator_index_for_key_group`` on a tensor: (kg - base_start) * n
    // base_len, floored (a group below the range gives a negative index,
    one past it an index >= n: neither is a shard)."""
    length = max_parallelism if base_len is None else int(base_len)
    rel = key_groups.to(torch.int64) - int(base_start)
    return torch.div(rel * int(n_devices), length,
                     rounding_mode="floor").to(torch.int32)
