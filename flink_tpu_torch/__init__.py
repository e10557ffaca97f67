"""flink_tpu_torch: the flink-tpu device window path on PyTorch and CUDA.

A port of ``flink_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. The
JAX package stays the reference; this package imports nothing of it and
keeps its own trimmed copies of the host modules it needs. Layout mirrors
``flink_tpu`` so each module's counterpart is found under the same path:

  core/       records, key groups, watermarks, device batches, config
  window/     tumbling and sliding event-time assigners
  ops/        hash table, segment folds, radix top-k, kernel build + binding
  csrc/       hand-written CUDA kernels (sm_90a), built at first use
  state/      device keyed-state backend (hash table + pane planes)
  parallel/   the mesh: D shards in one process, the keyBy exchange on the
              device, sharded window state, live rescale
  runtime/    operator base and chain, harness, the window operator, stream
              tasks, channels, record writers, the fused chain
  graph/      transformations, StreamGraph/JobGraph, fusion certificate
  cluster/    local deployment of a JobGraph as threads
  checkpoint/ checkpoint coordinator and storage
  connectors/ datagen and collection sources
  metrics/    device counters
  api/        StreamExecutionEnvironment / DataStream

Device policy (``device.py``): entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; there is no fallback. On the CPU every
kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from .device import KERNEL_LAUNCHES, reset_launches, resolve_device  # noqa: F401
