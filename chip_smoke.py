#!/usr/bin/env python3
"""Smoke run of flink_tpu_torch on one CUDA card: build, kernels, Q5.

Run from the repository root:  python3 chip_smoke.py

1. The card: name and power limit as nvidia-smi reports them, torch and
   CUDA versions.
2. Build: every ``flink_tpu_torch/csrc/*.cu`` with nvcc for sm_90a (one
   process per source, in parallel); the seconds spent.
3. Kernels, each held against its plain PyTorch version on the card at
   the shapes the Q5 path gives it:
   * hist256 at n = 2^21 and 2^24, shifts 0/8/16/24: exactly equal to the
     plain version and to torch.bincount;
   * hash_probe: 2^19 keys with duplicates into capacity 2^21 and 2^24:
     the kernel's table holds the plain version's key set, table[slot] ==
     key, each key has one slot, lookup agrees with the insert, ok holds
     everywhere, absent keys look up as -1, masked rows never probe.
   Median kernel time over CUDA events (L2 flushed before each launch),
   the plain version's time, the library call's time where one exists,
   and the bound reckoned from the bytes each kernel must move.
4. Nexmark Q5 at 1M keys (the bench.py headline: capacity 2^21, ring 16,
   batch 2^19, 2^23 events, 2000 ms panes, 5-pane sliding windows, top
   1000 by count(value_bits=31) with sum(price)) through the port's
   StreamExecutionEnvironment with datagen(device=True), after a short
   warm-up run under PyTorch's sync debug mode, which must flag no wait
   for the card that recurs per batch or per fire. Then 5 timed runs:
   launch counters are zeroed just before each and read just after, and
   both kernels must have run; every emitted window of every run is
   checked against a numpy oracle (per-pane bincount of the same events,
   top 1000 by count under the tie rule, revenue of each winner). The
   median events/sec, its range, and p99 fire latency over all the
   runs' fires are printed.
   One more run under torch.profiler gives the card's busy time by
   kernel against the run's wall time.
5. The same at 10M keys (capacity 2^24, 2^25 events).
6. The kernels line, the nvidia-smi line, then the last line
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; without CUDA, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import linecache
import os
import subprocess
import sys
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
MULT = 0x9E3779B97F4A7C15      # bench.py's key mixer
INT64_MAX = (1 << 63) - 1
PANE_MS, WINDOW_PANES, RING, BATCH, TOPK = 2000, 5, 16, 1 << 19, 1000
Q5_RUNS = 5                    # timed Q5 runs per configuration


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing ---------------------------------------------------------------
def cuda_ms(fn, torch, reps: int = 15, setup=None) -> float:
    """Median ms of ``fn`` between two CUDA events, ``setup`` (not timed)
    before each run, after two warm-up runs. Each timed run is queued
    behind a ~1 ms device sleep, so the host has enqueued the whole run
    before the card reaches it and the events time the card alone."""
    for _ in range(2):
        if setup:
            setup()
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- kernel phase -----------------------------------------------------------
def check_hist256(torch, dev) -> dict:
    from flink_tpu_torch.ops.radix_topk import histogram256, \
        histogram256_plain

    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shapes = {}
    max_err = 0
    for n in (1 << 21, 1 << 24):
        u = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32,
                          device=dev, generator=gen)
        valid = torch.rand(n, device=dev, generator=gen) < 0.5
        for shift in (0, 8, 16, 24):
            got = histogram256(u, valid, shift)
            plain = histogram256_plain(u, valid, shift)
            lib = torch.bincount((u.to(torch.int64) >> shift) & 0xFF,
                                 weights=valid.to(torch.float64),
                                 minlength=256).to(torch.int64)
            torch.cuda.synchronize()
            err = int(max((got.to(torch.int64) - plain.to(torch.int64))
                          .abs().max(), (got.to(torch.int64) - lib)
                          .abs().max()))
            if err:
                raise AssertionError(
                    f"hist256 n={n} shift={shift}: differs from the plain "
                    f"version by up to {err}")
            max_err = max(max_err, err)
        # timed at the top digit, the first pass of every fire; writing
        # 64 MB before each launch evicts the inputs from the 50 MB L2
        shift = 24
        weights = valid.to(torch.float32)
        ms = cuda_ms(lambda: histogram256(u, valid, shift), torch,
                     setup=lambda: flush.fill_(1))
        plain_ms = cuda_ms(lambda: histogram256_plain(u, valid, shift),
                           torch, setup=lambda: flush.fill_(2))
        lib_ms = cuda_ms(lambda: torch.bincount(
            (u >> shift) & 0xFF, weights=weights, minlength=256), torch,
            setup=lambda: flush.fill_(3))
        nbytes = n * 4 + n * 1 + 256 * 4
        shapes[n] = {"n": n, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"}
    return {"max_abs_err": max_err, "shapes": shapes}


def check_hash_probe(torch, dev) -> dict:
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, lookup, \
        lookup_or_insert, lookup_or_insert_plain, make_table

    gen = torch.Generator(device=dev).manual_seed(2)
    n = 1 << 19
    distinct = torch.randint(-(1 << 62), 1 << 62, (1 << 18,),
                             dtype=torch.int64, device=dev, generator=gen)
    keys = distinct[torch.randint(0, 1 << 18, (n,), device=dev,
                                  generator=gen)].contiguous()
    uniq = torch.unique(keys)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shapes = {}
    mismatches = 0

    def sym_diff(a, b) -> int:
        return int((~torch.isin(a, b)).sum() + (~torch.isin(b, a)).sum())

    for cap in (1 << 21, 1 << 24):
        table, slots, ok = lookup_or_insert(make_table(cap, dev), keys)
        ptable, pslots, pok = lookup_or_insert_plain(make_table(cap, dev),
                                                     keys)
        torch.cuda.synchronize()
        occupied = table[table != EMPTY_KEY]
        safe = torch.where(ok, slots, 0).long()
        absent = torch.tensor([EMPTY_KEY - 1, 12345], device=dev)
        absent = absent[~torch.isin(absent, uniq)]
        valid = torch.rand(n, device=dev, generator=gen) < 0.5
        mtable, mslots, mok = lookup_or_insert(make_table(cap, dev), keys,
                                               valid)
        # each entry counts the keys or rows that break one invariant
        bad = {
            "ok_false": int((~ok).sum() + (~pok).sum()),
            "duplicate_slots": int(occupied.numel()
                                   - torch.unique(occupied).numel()),
            "key_set_vs_batch": sym_diff(occupied, uniq),
            "key_set_vs_plain": sym_diff(occupied,
                                         ptable[ptable != EMPTY_KEY]),
            "table_at_slot_not_key": int((ok & (table[safe] != keys))
                                         .sum()),
            "lookup_vs_insert": int((lookup(table, keys) != slots).sum()),
            "absent_found": int((lookup(table, absent) != -1).sum()),
            "masked_rows_probed": int((mslots[~valid] != -1).sum()
                                      + mok[~valid].sum()),
            "valid_rows_failed": int((~mok[valid]).sum()),
            "masked_key_set": sym_diff(mtable[mtable != EMPTY_KEY],
                                       torch.unique(keys[valid])),
        }
        if any(bad.values()):
            raise AssertionError(f"hash_probe cap={cap}: rows breaking an "
                                 f"invariant: {bad}")
        mismatches += sum(bad.values())
        fresh = make_table(cap, dev)

        def reset():
            flush.fill_(1)
            fresh.fill_(EMPTY_KEY)

        ms = cuda_ms(lambda: lookup_or_insert(fresh, keys), torch,
                     setup=reset)
        plain_ms = cuda_ms(lambda: lookup_or_insert_plain(fresh, keys),
                           torch, reps=3, setup=reset)
        # the least traffic: each key read (8 B), its slot and ok flag
        # written (4 B + 1 B); each distinct key's home sector of the
        # table read (32 B, the DRAM access unit) and its claim written
        # (8 B); duplicates can find their key's sector in L2
        nbytes = n * (8 + 4 + 1) + int(uniq.numel()) * (32 + 8)
        shapes[cap] = {"n": n, "capacity": cap, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": None,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "bound_by": "bytes"}
    # the table holds keys, not values to be near, so its error is the
    # count of keys and rows that broke an invariant above
    return {"max_abs_err": mismatches, "shapes": shapes}


# -- Q5 -------------------------------------------------------------------
def q5_panes(n_events: int, batch: int = BATCH) -> int:
    """bench.py's pane count for the default ring and W = 5."""
    return max(4, min(RING - WINDOW_PANES - 2, n_events // batch))


def q5_gen(n_keys: int, n_events: int, span: int):
    """bench.py's Q5 generator on int64 torch indices. The auction key is
    (idx * MULT) % n_keys in uint64; torch has no uint64 remainder, so it
    is computed from int64 ops: the product wraps mod 2^64 alike, then
    x % n = ((x >>> 1) % n * 2 + (x & 1)) % n, where x >>> 1 is the
    logical shift (x >> 1) & INT64_MAX."""
    mult = MULT - (1 << 64)    # the same 64 bits as a signed int64

    def gen(idx):
        x = idx * mult
        auction = (((x >> 1) & INT64_MAX) % n_keys * 2 + (x & 1)) % n_keys
        return {"auction": auction, "price": idx % 997 + 1,
                "ts": (idx * span) // n_events}

    return gen


def run_q5(torch, dev, n_keys: int, n_events: int, capacity: int,
           batch: int = BATCH, topk: int = TOPK):
    """One run of the Q5 pipeline through the port's public API; returns
    (job result, [(window end - 1, auctions, bids, revenue)], span ms)."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import SlidingEventTimeWindows

    span = q5_panes(n_events, batch) * PANE_MS
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    got = []

    def sink(b):
        got.append((int(b.timestamps[0]), b.column("auction"),
                    b.column("bids"), b.column("revenue")))

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": batch}), device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    (env.datagen(q5_gen(n_keys, n_events, span), schema, count=n_events,
                 timestamp_column="ts", watermark_strategy=ws, device=True)
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS))
        .device_aggregate([AggSpec("count", out_name="bids", value_bits=31),
                           AggSpec("sum", "price", out_name="revenue")],
                          capacity=capacity, ring_size=RING,
                          emit_window_bounds=False, emit_topk=topk,
                          defer_overflow=True, async_fire=True)
        .add_sink(sink))
    job = env.execute("nexmark-q5")
    return job, got, span


def q5_oracle_check(n_keys: int, n_events: int, span: int, got,
                    topk: int = TOPK) -> int:
    """Hold every emitted window against numpy under the tie rule; returns
    the windows checked."""
    idx = np.arange(n_events, dtype=np.int64)
    keys = ((idx.astype(np.uint64) * np.uint64(MULT))
            % np.uint64(n_keys)).astype(np.int64)
    price = idx % 997 + 1
    panes = (idx * span) // n_events // PANE_MS
    n_p = int(panes[-1]) + 1
    bounds = np.searchsorted(panes, np.arange(n_p + 1))
    cnt, rev = [], []
    for p in range(n_p):
        a, b = bounds[p], bounds[p + 1]
        cnt.append(np.bincount(keys[a:b], minlength=n_keys))
        rev.append(np.bincount(keys[a:b], weights=price[a:b],
                               minlength=n_keys).astype(np.int64))
    expected_ends = list(range(int(panes[0]) + 1, n_p + WINDOW_PANES))
    ends = [(ts + 1) // PANE_MS for ts, *_ in got]
    if ends != expected_ends:
        raise AssertionError(f"fired windows {ends} != {expected_ends}")
    for (ts, k, bids, revenue), p_end in zip(got, ends):
        live = range(max(0, p_end - WINDOW_PANES), min(p_end, n_p))
        c = sum(cnt[p] for p in live)
        r = sum(rev[p] for p in live)
        nz = int((c > 0).sum())
        kk = min(topk, nz)
        want = -np.sort(-np.partition(c, len(c) - kk)[len(c) - kk:])
        kth = want[-1]
        ok = (len(k) == kk and len(np.unique(k)) == kk
              and np.array_equal(bids.astype(np.int64), want)
              and np.array_equal(c[k], bids.astype(np.int64))
              and np.array_equal(r[k], revenue.astype(np.int64))
              and set(k[bids > kth].tolist())
              == set(np.flatnonzero(c > kth).tolist()))
        if not ok:
            raise AssertionError(f"Q5 window ending at pane {p_end} "
                                 "disagrees with the numpy oracle")
    return len(got)


def implicit_syncs(torch, fn) -> list[str]:
    """Run ``fn`` with PyTorch's sync debug mode on; returns where each
    operation that made the host wait for the card was called (a
    ``.item()``, a boolean-mask index, ``nonzero``, a blocking copy,
    ``torch.cuda.synchronize``), once per wait. Waits the pipeline asks
    for on an event (``Event.synchronize``) are not flagged."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            if w.filename.startswith(HERE) else
            f"{os.path.basename(w.filename)}:{w.lineno} "
            f"{linecache.getline(w.filename, w.lineno).strip()}"
            for w in caught if "synchroniz" in str(w.message)]


def check_sync_detector(torch, dev) -> None:
    """The sync check below counts repeats, so it must see every wait."""
    x = torch.ones(4, device=dev)
    seen = implicit_syncs(torch, lambda: [int(x.sum()) for _ in range(3)])
    if sum(loc.startswith("chip_smoke.py") for loc in seen) != 3:
        raise AssertionError(f"sync debug mode flagged {seen} for 3 "
                             "waits; the per-batch sync check is blind")


def q5_profile(torch, dev, n_keys: int, n_events: int,
               capacity: int) -> dict:
    """One more Q5 run under torch.profiler: the card's busy time by
    kernel (CUPTI records every kernel in the process, the ones this
    package launches through ctypes too) against the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        job, _got, _span = run_q5(torch, dev, n_keys, n_events, capacity)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name[:90], [0.0, 0])
            acc[0] += e.self_device_time_total / 1e3
            acc[1] += 1
    busy = sum(ms for ms, _n in by_name.values())
    wall = job.wall_s * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": (1 - busy / wall) if busy else None,
            "top": [{"name": k, "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def q5_phase(torch, dev, label: str, n_keys: int, n_events: int,
             capacity: int) -> dict:
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    # warm-up of 4 batches and 8 fires, which also shows that no batch and
    # no fire makes the host wait for the card: the only waits are the
    # once-per-job reads at end of input (the source's monotonicity flag,
    # the late counter)
    syncs = implicit_syncs(torch, lambda: run_q5(torch, dev, n_keys,
                                                 4 * BATCH, capacity))
    repeated = sorted({s for s in syncs if syncs.count(s) > 1})
    if repeated:
        raise AssertionError(f"Q5 {label}: the host waited for the card "
                             f"more than once per job at {repeated}")
    # the run is host-bound and short, so its wall time is noisy: time
    # several runs, check every one against the oracle
    walls, lat, peaks, launches = [], [], [], None
    for _ in range(Q5_RUNS):
        job = got = None   # the last run's state goes back to the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        job, got, span = run_q5(torch, dev, n_keys, n_events, capacity)
        peaks.append(torch.cuda.max_memory_allocated())
        launches = dict(KERNEL_LAUNCHES)
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"Q5 {label}: kernels never launched on "
                                 f"the main path: {missing}")
        windows = q5_oracle_check(n_keys, n_events, span, got)
        walls.append(job.wall_s)
        lat += job.operators[0].fire_latencies_ms
    lat.sort()
    eps = sorted(n_events / w for w in walls)
    op = job.operators[0]
    return {"q5": label, "keys": n_keys, "events": n_events,
            "capacity": capacity, "batch": BATCH, "runs": Q5_RUNS,
            "wall_s": walls,
            "events_per_sec": float(np.median(eps)),
            "events_per_sec_min_max": [eps[0], eps[-1]],
            "p99_fire_latency_ms": lat[min(len(lat) - 1,
                                           int(0.99 * len(lat)))],
            "fires": len(lat), "windows_checked_per_run": windows,
            "late_dropped": op.late_dropped,
            "host_waits_per_job": sorted(syncs),
            "state_bytes": op.backend.state_nbytes,
            "max_memory_allocated": max(peaks),
            "launches_per_run": launches,
            "profile": q5_profile(torch, dev, n_keys, n_events, capacity)}


def main() -> int:
    # the smoke runs on one card: show torch only the first one, so the
    # count it reports is the count it used
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import flink_tpu_torch  # noqa: F401
        from flink_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: cannot import flink_tpu_torch beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    emit({"device": {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()},
          "torch": torch.__version__, "cuda": torch.version.cuda})
    nvcc_s = kernels.build_all()
    emit({"build": {"nvcc_s": nvcc_s, "dir": str(kernels.BUILD_DIR),
                    "sources": sorted(kernels.SOURCES)}})
    hist = check_hist256(torch, dev)
    probe = check_hash_probe(torch, dev)
    emit({"kernel_checks": {"hist256": hist, "hash_probe": probe}})
    check_sync_detector(torch, dev)
    q5_1m = q5_phase(torch, dev, "1M", 1_000_000, 1 << 23, 1 << 21)
    emit(q5_1m)
    emit(q5_phase(torch, dev, "10M", 10_000_000, 1 << 25, 1 << 24))
    headline = q5_1m["launches_per_run"]
    h, p = hist["shapes"][1 << 21], probe["shapes"][1 << 21]
    emit({"kernels": [
        {"name": "hist256", "route": "cuda",
         "source": "flink_tpu_torch/csrc/hist256.cu",
         "replaces": "flink_tpu/ops/pallas_topk.py:40",
         "launches": headline["hist256"],
         "max_abs_err": hist["max_abs_err"], **h,
         "at_n_2^24": hist["shapes"][1 << 24]},
        {"name": "hash_probe", "route": "cuda",
         "source": "flink_tpu_torch/csrc/hash_table.cu",
         "replaces": "flink_tpu/ops/hash_table.py:133",
         "launches": headline["hash_probe"],
         "max_abs_err": probe["max_abs_err"], **p,
         "at_capacity_2^24": probe["shapes"][1 << 24]},
    ]})
    print(smi, flush=True)
    if torch.cuda.device_count() != 1:
        raise AssertionError(f"{torch.cuda.device_count()} cards visible; "
                             "the smoke uses one")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
