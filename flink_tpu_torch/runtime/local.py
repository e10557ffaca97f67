"""Local runner: one in-process subtask that owns every key group.

The loop of the reference's source task, trimmed to one linear chain:
read a batch, assign timestamps, push it through the chain, emit the
watermark when it advanced; at end of input emit the MAX watermark and
finish the chain. Graph compilation, StreamTask, channels, checkpoint
coordination and the cluster are later slices.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..core.config import Configuration
from ..core.elements import MAX_WATERMARK, Watermark
from ..core.records import MIN_TIMESTAMP
from ..core.watermarks import WatermarkStrategy
from .operators.base import Output, OperatorContext, chain_operators

__all__ = ["JobResult", "run_pipeline"]


class _Discard(Output):
    def emit(self, batch) -> None:
        pass

    def emit_watermark(self, watermark) -> None:
        pass


@dataclass
class JobResult:
    name: str
    operators: list = field(default_factory=list)
    wall_s: float = 0.0
    records_in: int = 0


def run_pipeline(name: str, source, ws: WatermarkStrategy, operators: list,
                 config: Configuration, device: torch.device) -> JobResult:
    ctx = OperatorContext(name, 0, 1, config.get("pipeline.max-parallelism"),
                          config)
    chain_operators(operators, ctx, _Discard())
    head = operators[0]
    for op in operators:
        op.initialize_state([], None)
    for op in reversed(operators):
        op.open()
    reader = source.create_reader(device)
    gen = ws.create_generator()
    batch_size = config.get("pipeline.micro-batch-size")
    result = JobResult(name, operators)
    t0 = time.perf_counter()
    last_wm = MIN_TIMESTAMP
    try:
        while True:
            batch = reader.read_batch(batch_size)
            if batch is None:
                break
            if not batch.n:
                continue
            result.records_in += batch.n
            batch = ws.assign_timestamps(batch)
            gen.on_batch(batch)
            head.process_batch(batch)
            wm = gen.current_watermark()
            if wm > last_wm:
                last_wm = wm
                head.process_watermark(Watermark(wm))
        head.process_watermark(MAX_WATERMARK)
        for op in operators:
            op.finish()
        reader.close()
    finally:
        for op in operators:
            op.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    result.wall_s = time.perf_counter() - t0
    return result
