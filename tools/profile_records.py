#!/usr/bin/env python3
"""Whether torch.profiler keeps a record of every kernel launch of the SQL
TPC-H Q1 cell on one CUDA card, alone and after a phase of the smoke.

Run from the repository root, on the card:

    python3 tools/profile_records.py [--tries N] [--before PHASE]
                                     [--margin S] [--join] [--out FILE]

Builds the package's kernels, then profiles ``chip_smoke.run_tpch_q1``
(2^25 rows, as the smoke's ``sql_tpch_q1`` phase does) N times (default
4); runs the phase named by ``--before``: ``tiering`` (the default,
``chip_smoke.tiering_phase``, the hot-set shift at Q5-10M under the
2^23-slot budget) or ``sessions`` (the smoke's session cells and its
session checkpoint phase, the phases the smoke runs just before the
cell) or ``threads`` (THREAD_CHURN threads, one after another, each
launching one kernel and ending, as the smoke's many jobs start and end
task threads); reports the threads still alive and, for every budgeted backend
still reachable, whether its prefetch pipeline is idle and its staging
stream has no work left; then profiles the cell N times more. With
``--margin S`` the profiles after the phase alternate between the plain
form and one that idles the card for S seconds after the profiler starts
and after the run, before the profiler stops. For each profile: the
profiler's records of the four group aggregation stages and of the probe
against the launch counters, the launch calls it recorded on the host
side, the batches (each begun by its probe's record) whose stage records
are missing, and where the device records lie against the host records
(microseconds from the trace's start). With ``--join``, then N
profiles of the ``q7_join_ref`` cell (its list kernels' and probe's
records against the counters). With ``--empty``, both again after
``torch.cuda.empty_cache()``. One JSON line each (``--out``: also
appended to FILE), with the card's name and power limit.
"""

from __future__ import annotations

import gc
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def profile_once(torch, cs, dev, margin_s: float = 0.0) -> dict:
    """One profiled run of the TPC-H cell, its records against the
    launch counters; ``margin_s`` seconds of an idle card inside the
    profile before and after the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if margin_s:
            time.sleep(margin_s)
        job, _res = cs.run_tpch_q1(torch, dev)
        if margin_s:
            torch.cuda.synchronize()
            time.sleep(margin_s)
    kernels, launch_calls, host = [], {}, []
    device_end = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.name))
            device_end = max(device_end, e.time_range.end)
        else:
            host.append((e.time_range.start, e.time_range.end))
            if "Launch" in e.name:
                launch_calls[e.name] = launch_calls.get(e.name, 0) + 1
    kernels.sort()
    probes = [t for t, name in kernels if "hash_probe_kernel" in name]
    symbols = cs.GAGG_SYMBOLS + (("hash_probe", "hash_probe_kernel"),)
    counted = {k: sum(sym in n for _t, n in kernels) for k, sym in symbols}
    # a batch: the probe's record, then the four stages' records
    per_batch, short = [], []
    for _t, name in kernels:
        if "hash_probe_kernel" in name:
            per_batch.append(0)
        elif per_batch and any(sym in name for _k, sym in cs.GAGG_SYMBOLS):
            per_batch[-1] += 1
    short = [(i, n, probes[i]) for i, n in enumerate(per_batch) if n != 4]
    return {"margin_s": margin_s, **card_memory(torch), "counted": counted,
            "launches": {k: KERNEL_LAUNCHES[k] for k in counted},
            "lost": {k: KERNEL_LAUNCHES[k] - n for k, n in counted.items()},
            "kernel_records": len(kernels),
            "host_launch_calls": launch_calls,
            "batches_seen": len(per_batch),
            "batches_short_of_stages": short,
            "host_first_us": min(a for a, _b in host),
            "host_last_end_us": max(b for _a, b in host),
            "device_first_us": kernels[0][0] if kernels else None,
            "device_last_end_us": device_end,
            "probe_first_us": probes[0] if probes else None,
            "probe_last_us": probes[-1] if probes else None,
            "wall_s": job.wall_s}


THREAD_CHURN = 3000             # threads the ``threads`` phase starts
THREAD_KERNELS = 64             # kernels a profiled thread launches


def thread_profile(torch, dev) -> dict:
    """A profile of one thread that launches THREAD_KERNELS one-kernel
    additions and ends before the profiler stops: the records kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 10, device=dev)

    def work() -> None:
        for _ in range(THREAD_KERNELS):
            x.add_(1)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    kept = sum(e.device_type == DeviceType.CUDA and "elementwise" in e.name
               for e in prof.events())
    return {"launched": THREAD_KERNELS, "kept": kept}


def card_memory(torch) -> dict:
    """Bytes free on the card (``cudaMemGetInfo``), and bytes the caching
    allocator holds."""
    free, total = torch.cuda.mem_get_info()
    return {"card_free": free, "card_total": total,
            "reserved": torch.cuda.memory_reserved(),
            "allocated": torch.cuda.memory_allocated()}


def fill_card(torch, dev) -> dict:
    """Reserve the card's memory through the caching allocator, 1 GiB,
    then 64 MiB, then 2 MiB at a time until none is left, and free the
    tensors: the allocator keeps the memory, as after a large cell."""
    held = []
    for step in (1 << 30, 1 << 26, 1 << 21):
        while True:
            try:
                held.append(torch.empty(step, dtype=torch.uint8, device=dev))
            except torch.OutOfMemoryError:
                break
    del held
    return card_memory(torch)


def join_once(torch, cs, dev, c: dict) -> dict:
    """One plain profile of the q7_join_ref cell: the profiler's records
    of the list kernels and the probe against the launch counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    symbols = cs.LIST_SYMBOLS + (("hash_probe", "hash_probe_kernel"),)
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.run_q7_join(torch, dev, c)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    counted = {k: sum(sym in n for n in names) for k, sym in symbols}
    return {"counted": counted,
            "lost": {k: KERNEL_LAUNCHES[k] - n for k, n in counted.items()},
            "kernel_records": len(names), **card_memory(torch)}


def budgeted_backends() -> list:
    """The budgeted backends still reachable: the prefetch pipeline's
    state, its thread, and whether the staging stream has work left."""
    from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend

    out = []
    for o in gc.get_objects():
        if isinstance(o, DeviceKeyedStateBackend) and o.tiering_active:
            pipe = o.prefetch_pipeline
            out.append({"asynchronous": pipe.asynchronous,
                        "pipeline_idle": pipe.idle,
                        "thread_alive": bool(pipe._thread is not None
                                             and pipe._thread.is_alive()),
                        "stage_stream_done": (o._stage_stream.query()
                                              if o._stage_stream is not None
                                              else None)})
    return out


def main(argv: list[str]) -> int:
    import torch

    tries, out_path, before, margin_s = 4, None, "tiering", 0.0
    join = empty = False
    while argv:
        if argv[0] in ("--join", "--empty"):
            join, empty = (join or argv[0] == "--join",
                           empty or argv[0] == "--empty")
            argv = argv[1:]
            continue
        if argv[0] == "--tries":
            tries, argv = int(argv[1]), argv[2:]
        elif argv[0] == "--out":
            out_path, argv = argv[1], argv[2:]
        elif argv[0] == "--before" and argv[1:2] in (
                ["tiering"], ["sessions"], ["threads"], ["fill"]):
            before, argv = argv[1], argv[2:]
        elif argv[0] == "--margin":
            margin_s, argv = float(argv[1]), argv[2:]
        else:
            print("usage: profile_records.py [--tries N] [--before "
                  "tiering|sessions|threads|fill] [--margin S] [--join] "
                  "[--empty] [--out FILE]", file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("profile_records: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flink_tpu_torch.ops import kernels

    smi = cs.nvidia_smi_line()

    def emit(rec: dict) -> None:
        rec = {"card": smi, **rec}
        cs.emit(rec)
        if out_path:
            with open(out_path, "a") as f:
                f.write(cs.json.dumps(rec) + "\n")

    dev = torch.device("cuda", 0)
    kernels.build_all()
    cs.run_tpch_q1(torch, dev, 4 * cs.BATCH)
    c = cs.Q7J_CELLS["q7_join_ref"]
    if join:
        cs.run_q7_join(torch, dev, dict(c, bids=1 << 16))
    for i in range(tries):
        emit({"when": "alone", "profile": i + 1,
              **profile_once(torch, cs, dev)})
    done: dict = {}
    if before == "tiering":
        tier = cs.tiering_phase(torch, dev, {})
        done["promotions"] = {m: r["promotions"]
                              for m, r in tier["shift"]["runs"].items()}
        del tier
    elif before == "fill":
        done["fill"] = fill_card(torch, dev)
    elif before == "threads":
        done["thread_profiles_before"] = [thread_profile(torch, dev)
                                          for _ in range(tries)]
        y = torch.zeros(1, device=dev)
        for _ in range(THREAD_CHURN):
            t = threading.Thread(target=y.add_, args=(1,))
            t.start()
            t.join()
        done["thread_profiles_after"] = [thread_profile(torch, dev)
                                         for _ in range(tries)]
    else:
        for cell in cs.SESSION_CELLS:
            cs.session_cell(torch, dev, cell)
        cs.session_checkpoint_phase(torch, dev)
    torch.cuda.synchronize()
    emit({"when": f"{before} phase done", **done,
          "threads": sorted(t.name for t in threading.enumerate()),
          "budgeted_backends": budgeted_backends()})
    gc.collect()
    emit({"when": "after gc", "budgeted_backends": budgeted_backends()})
    for i in range(tries):
        emit({"when": f"after {before}", "profile": i + 1,
              **profile_once(torch, cs, dev, margin_s if i % 2 else 0.0)})
    if join:
        for i in range(tries):
            emit({"when": f"after {before}", "q7_join_ref_profile": i + 1,
                  **join_once(torch, cs, dev, c)})
    if empty:
        torch.cuda.empty_cache()
        emit({"when": "cache emptied", **card_memory(torch)})
        for i in range(tries):
            emit({"when": "after empty_cache", "profile": i + 1,
                  **profile_once(torch, cs, dev)})
        for i in range(tries if join else 0):
            emit({"when": "after empty_cache", "q7_join_ref_profile": i + 1,
                  **join_once(torch, cs, dev, c)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
