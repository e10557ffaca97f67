#!/usr/bin/env python3
"""Smoke run of flink_tpu_torch on one CUDA card: build, kernels, Q5, Q7,
checkpoints and state beyond an HBM budget.

Run from the repository root:  python3 chip_smoke.py

1. The card: name and power limit as nvidia-smi reports them, torch and
   CUDA versions.
2. Build: every ``flink_tpu_torch/csrc/*.cu`` with nvcc for sm_90a (one
   process per source, in parallel); the seconds spent.
3. Kernels, each held against its plain PyTorch version on the card at
   the shapes the main paths give it:
   * hist256, the TPU kernel's contract, at n = 2^21 and 2^24, shifts
     0/8/16/24: exactly equal to the plain version and to torch.bincount;
   * the select pass (hist256.cu's radix_pass_kernel) on every value
     type and digit plan the paths rank: Q5 window counts from the full
     merge (int64, value_bits 31, k 1000) at n = 2^21 and 2^24, from the
     incremental view (int32, value_bits 31, k 1000) at 2^24, and Q7's
     max view (int64, value_bits 34: 5 passes, k 1) at 2^24: every pass's
     histogram and the device state (prefix, above, kk) exactly equal to
     the plain version's, and the top k equal to torch.topk's under the
     tie rule;
   * hash_probe: 2^19 keys with duplicates into capacity 2^21 and 2^24:
     the kernel's table holds the plain version's key set, table[slot] ==
     key, each key has one slot, lookup agrees with the insert, ok holds
     everywhere, absent keys look up as -1, masked rows never probe;
   * ingest_step on the next Q5 batch (2^19 rows) of a table that holds
     the keys of the 4 batches before it, at 1M keys (capacity 2^21) and
     10M keys (2^24): the same key set as the plain version, the count and
     revenue planes equal key by key, the late and dropped counters equal;
   * ingest_step's two optional forms on that batch, against the plain
     version with the same parts: dirty marking at 2^21 and 2^24 (the
     marked blocks exactly those written) and the spill split at 2^23 with
     about half the key groups spilled (staged rows equal as a multiset,
     stage count and touch clock equal), each timed beside today's form;
   * window_seal and window_rebuild (csrc/window_seal.cu) on Q5's
     signature (int32 count, int64 revenue) at W = 5 on ring 16 (capacity
     2^21 and 2^24) and at W = 20 on ring 46 (2^24), on Q7's (int64
     count, int64 max tree) tumbling on ring 16 (2^21 and 2^24), and on a
     128-pane window (ring 262, a tree of 512 leaves; 2^16): a rebuild
     from the window's live rows, then seals at W with the retiring pane
     valid and not and at another width, every view and state exactly
     equal to the plain version's.
   Median kernel time over CUDA events with the L2 flushed before each
   launch, the plain version's time (for the window kernels: the eager
   seal and rebuild they replace), the library call's time where one
   exists (and, for ingest_step, the chain it replaces: the probe kernel
   and eager folds), and the bound reckoned from the bytes each kernel
   must move. A profiler shows that one step is one launch and that the
   select's passes run back to back.
4. Nexmark Q5 at 1M keys (the bench.py headline: capacity 2^21, ring 16,
   batch 2^19, 2^23 events, 2000 ms panes, 5-pane sliding windows, top
   1000 by count(value_bits=31) with sum(price)) through the port's
   StreamExecutionEnvironment with datagen(device=True) and
   ``env.execute()`` on the task runtime (a source task and a window task
   on two threads, joined by a channel; the watermark interval at 0, so a
   watermark follows every batch), after a short
   warm-up run under PyTorch's sync debug mode, which must flag no wait
   for the card that recurs per batch or per fire. Then 3 timed runs:
   launch counters are zeroed just before each and read just after; each
   run must launch ingest_step once per batch and hist256 once per digit
   pass of each fire; every emitted window of every run is checked
   against a numpy oracle (per-pane bincounts of the same events, top
   1000 by count under the tie rule, revenue of each winner). The median
   events/sec, its range, and p99 fire latency over all the runs' fires
   are printed. One more run under torch.profiler gives the card's busy
   time by kernel against the run's wall time, and counts the launches of
   both kernels again.
5. The same at 10M keys (capacity 2^24, 2^25 events; 5 timed runs), then
   once more with each fire profiled on its own (``fire_device_ms``): the
   device time of one fire (those runs chain source and window into one
   task with the fused chain, so no other thread enqueues work while a
   fire is timed).
6. Q5-10M with ``window.fire.incremental``: the same checks, and one
   window_seal or window_rebuild per fire; the rebuilds are printed by
   cause.
7. Q5-10M at W = 20 (bench.py --window-panes 20: ring 46, 24 panes), 2
   timed runs in each fire mode, and the device time per fire of each.
8. Nexmark Q7 at 10M keys (bench.py _run_q7: 9 tumbling panes of
   10 000 ms, max(packed = (price << 20) | bidder, value_bits 34), top 1,
   window bounds), 3 timed runs in each fire mode: every window's row is
   the auction of its pane's largest packed word, with its bounds; 5
   select passes per fire.
9. Coalesced ingest at the operator level: the Q5-1M events in device
   batches of 2^16 rows, task.coalesce.target-records 2^19, a watermark
   every 8 batches: one ingest_step per 8 batches, windows equal to the
   oracle.
10. The host-batch path: a short Q5 run with defer_overflow=False at 100k
    keys into capacity 2^17, which must launch hash_probe, grow the table
    exactly once, and pass the oracle.
11. The fused chain at the Q5-10M shape, at the operator level: a run's
    batches (and two power-of-two tails) once through the fused chain and
    once through the reader's decode and the unfused step: the table,
    both planes and the late and dropped counters equal bit for bit;
    under the profiler one CUDA graph launch and one ingest_step per
    micro-batch, and chain_fused_dispatches_total equal to the
    micro-batches.
12. Q5-10M through the runtime, fusion off ("runtime") and on ("fused"),
    in turns with the earlier single-thread loop over the same operators
    ("direct"): every window against the oracle, events/s, p99 fire
    latency, peak device memory, launches per run, one profiled run of
    each (idle share) and the host's enqueue per batch.
13. Coalesced ingest inside the runtime: Q5-1M in 2^16-row batches, the
    watermark every 5 ms of wall time, task.coalesce.target-records 2^19:
    batches must gather, and every window equals the oracle.
14. Snapshots through the mirror at Q5-10M (operator level): a full
    capture, a delta under load, an idle one, 64 hot keys, a retired ring
    row; each equal to the whole-copy snapshot, with its capture, order
    and gather seconds, DMA bytes and dirty share.
15. Checkpoint and restore at Q5-10M into FsCheckpointStorage in a
    temporary directory: a paced source, checkpoints every 0.5 s, the
    source paused after the first so the third is idle; the job is
    cancelled, the idle checkpoint on disk equals the whole-copy snapshot,
    a fresh job restores from the directory and runs to the end; every
    window of both equals the oracle and none repeats. Per checkpoint the
    window task's barrier to ack, the snapshot's capture, order and
    gather, the store, DMA and fs bytes; the restore's time to its first
    batch.
16. Q5-10M through env.execute() at state.backend.tpu.hbm-budget-slots
    2^23: every window against the oracle, one spill-form ingest_step per
    batch, no staged row dropped; events/sec, p99 fire latency, keys per
    tier, evictions, host seconds, peak memory. Then a budgeted job's
    checkpoint restored into an unbudgeted job and the reverse: windows
    against the oracle, and each checkpoint restored under the other
    budget snapshots byte for byte as it was stored.
17. The kernels line, the nvidia-smi line, then the last line
    {"ok": true, "device": {...}}.

``python3 chip_smoke.py --parent-kernels DIR`` instead times, with the same
method, the kernels that an older checkout at DIR also has (hist256,
hash_probe, and the probe-plus-eager-folds step chain) and prints one JSON
line: the way to set a new kernel beside its predecessor in one call.

Any failure raises and exits non-zero; without CUDA, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import gc
import json
import linecache
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
MULT = 0x9E3779B97F4A7C15      # bench.py's key mixer
INT64_MAX = (1 << 63) - 1
MIN_TIMESTAMP = -(1 << 62)     # first open pane before any fire
PANE_MS, WINDOW_PANES, RING, BATCH, TOPK = 2000, 5, 16, 1 << 19, 1000
Q5_RUNS = 5                    # timed runs of Q5-10M and the runtime cell
SHORT_RUNS = 3                 # timed runs of the Q5-1M and Q7 cells
WIDE_RUNS = 2                  # timed runs of the W = 20 cell
WIDE_PANES = 20                # bench.py --window-panes 20
#: (label, keys, events, capacity) of the two Q5 cells
Q5_CELLS = (("1M", 1_000_000, 1 << 23, 1 << 21),
            ("10M", 10_000_000, 1 << 25, 1 << 24))
STEP_PREFIX = 4                # batches in the table before a timed step
FIRE_SLEEP_CYCLES = 40_000_000  # ~20 ms of device sleep before a timed fire
PROFILE_TRIES = 3              # profiles taken before a lost record fails
Q7_PANE_MS, Q7_VALUE_BITS = 10_000, 34   # bench.py _run_q7
Q7_PRICES, Q7_BIDDER_BITS = 9973, 20
CO_BATCH, CO_TARGET, CO_WM_EVERY = 1 << 16, 1 << 19, 8   # coalesced ingest
MAXP = 128                     # pipeline.max-parallelism: the key groups
DIRTY_SHIFT = 9                # 512-slot dirty blocks of the state backend
SPILL_BUDGET = 1 << 23         # the spill phase's hbm-budget-slots
# the spill phase drains its stage at every watermark, which the runtime
# emits after every batch at interval 0: one batch is the most it stages
SPILL_STAGING = BATCH


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- timing ---------------------------------------------------------------
class L2Flush:
    """Evicts the 50 MB L2 by reading a 96 MB buffer, so it holds clean
    lines of that buffer: the timed launch finds its inputs in device
    memory and pays no write-back of dirty lines (a flush that writes
    leaves those, and their write-back lands inside the timed launch)."""

    def __init__(self, torch, dev):
        self.buf = torch.ones(96 << 20, dtype=torch.uint8, device=dev)

    def __call__(self) -> None:
        self.buf.sum()


def cuda_ms(fn, torch, flush, reps: int = 15, setup=None) -> float:
    """Median ms of ``fn`` between two CUDA events, ``setup`` and the L2
    flush (not timed) before each run, after two warm-up runs. Each timed
    run is queued behind a ~1 ms device sleep, so the host has enqueued
    the whole run before the card reaches it and the events time the card
    alone."""
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
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# -- kernel phase -----------------------------------------------------------
def check_hist256(torch, dev, flush) -> dict:
    """The TPU kernel's contract: [256] int32 histogram of an int32 word."""
    from flink_tpu_torch.ops.radix_topk import histogram256, \
        histogram256_plain

    gen = torch.Generator(device=dev).manual_seed(1)
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
        # timed at the top digit, the first pass of a 32-bit walk
        shift = 24
        weights = valid.to(torch.float32)
        shapes[n] = {
            "n": n,
            "ms": cuda_ms(lambda: histogram256(u, valid, shift), torch,
                          flush),
            "plain_ms": cuda_ms(lambda: histogram256_plain(u, valid, shift),
                                torch, flush),
            "library_ms": cuda_ms(lambda: torch.bincount(
                (u >> shift) & 0xFF, weights=weights, minlength=256), torch,
                flush),
            "bound_ms": bound_ms(n * 4 + n * 1 + 256 * 4),
            "bound_by": "bytes"}
    return {"max_abs_err": max_err, "shapes": shapes}


def q5_window_counts(torch, dev, n: int, gen, dtype=None):
    """Ranked values shaped like a Q5 fire's: window counts (int64 from
    the full merge, int32 from the incremental view) of about 4.6 bids
    per key over the occupied half of the slots."""
    valid = torch.rand(n, device=dev, generator=gen) < 0.48
    counts = torch.poisson(torch.full((n,), 4.6, device=dev),
                           generator=gen).to(dtype or torch.int64) + 1
    return torch.where(valid, counts, 0), valid


def q7_window_maxima(torch, dev, n: int, gen, dtype=None):
    """Ranked values shaped like a Q7 fire's: the int64 max view, a packed
    word below 2^34 at the slots with a bid in the pane (about 3.1M of
    10M keys in 2^24 slots) and the max's identity elsewhere."""
    valid = torch.rand(n, device=dev, generator=gen) < 0.18
    words = torch.randint(0, 1 << Q7_VALUE_BITS, (n,), dtype=torch.int64,
                          device=dev, generator=gen)
    return torch.where(valid, words, torch.iinfo(torch.int64).min), valid


#: (label, values, dtype, value_bits, k, n) of the checked selects: Q5's
#: full-mode int64 merge, its incremental int32 view, Q7's int64 max view
SELECT_CASES = (("q5_int64", q5_window_counts, "int64", 31, TOPK, 1 << 21),
                ("q5_int64", q5_window_counts, "int64", 31, TOPK, 1 << 24),
                ("q5_int32", q5_window_counts, "int32", 31, TOPK, 1 << 24),
                ("q7_int64", q7_window_maxima, "int64", Q7_VALUE_BITS, 1,
                 1 << 24))


def check_select(torch, dev, flush) -> dict:
    """The fire's select: one radix_pass_kernel launch per digit pass, on
    each value type and digit plan the main paths rank."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.ops.radix_topk import digit_plan, radix_select, \
        radix_select_plain
    from flink_tpu_torch.ops.topk import masked_topk, masked_topk_sort

    gen = torch.Generator(device=dev).manual_seed(5)
    shapes = {}
    mismatches = 0
    for label, make, dt_name, value_bits, k, n in SELECT_CASES:
        name = f"{label}_n_2^{n.bit_length() - 1}"
        dtype = getattr(torch, dt_name)
        passes = len(digit_plan(dtype, value_bits)[0])
        values, valid = make(torch, dev, n, gen, dtype)
        got_h = torch.zeros((passes, 256), dtype=torch.int32, device=dev)
        want_h = torch.zeros_like(got_h)
        reset_launches()
        got = radix_select(values, valid, k, value_bits, got_h)
        if KERNEL_LAUNCHES["hist256"] != passes:
            raise AssertionError(f"select {name}: "
                                 f"{KERNEL_LAUNCHES['hist256']} launches "
                                 f"for {passes} passes")
        want = radix_select_plain(values, valid, k, value_bits, want_h)
        v, i, ok = masked_topk(values, valid, k, value_bits=value_bits)
        sv, _si, sok = masked_topk_sort(values, valid, k)
        torch.cuda.synchronize()
        bad = {"hist_bins": int((got_h != want_h).sum()),
               "state": int((got != want).sum()),
               "topk_values": int((v != sv).sum() + (ok != sok).sum()),
               "topk_index_values": int((values[i[ok]] != v[ok]).sum()
                                        + (~valid[i[ok]]).sum())}
        if any(bad.values()):
            raise AssertionError(f"select {name}: entries differing from "
                                 f"the plain version: {bad}")
        mismatches += sum(bad.values())
        masked = torch.where(valid, values, torch.iinfo(dtype).min)
        sel_ms = cuda_ms(lambda: radix_select(values, valid, k, value_bits),
                         torch, flush)
        plain_ms = cuda_ms(lambda: radix_select_plain(values, valid, k,
                                                      value_bits),
                           torch, flush)
        # one pass reads each value and valid byte once
        per_pass = bound_ms(n * (values.element_size() + 1) + 3 * 8)
        shapes[name] = {"n": n, "dtype": dt_name, "value_bits": value_bits,
                        "k": k, "passes": passes,
                        "ms": sel_ms / passes, "plain_ms": plain_ms / passes,
                        "bound_ms": per_pass, "bound_by": "bytes",
                        "library_ms": None,
                        "share_of_bound": per_pass * passes / sel_ms,
                        "select_ms": sel_ms, "select_plain_ms": plain_ms,
                        "select_bound_ms": per_pass * passes,
                        "select_library_ms": cuda_ms(
                            lambda: torch.topk(masked, k), torch, flush)}
        del values, valid, masked
    # integers: the count of histogram bins, state words and top-k seats
    # that differ from the plain version
    return {"max_abs_err": mismatches, "shapes": shapes}


def check_hash_probe(torch, dev, flush) -> dict:
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, lookup, \
        lookup_or_insert, lookup_or_insert_plain, make_table

    gen = torch.Generator(device=dev).manual_seed(2)
    n = 1 << 19
    distinct = torch.randint(-(1 << 62), 1 << 62, (1 << 18,),
                             dtype=torch.int64, device=dev, generator=gen)
    keys = distinct[torch.randint(0, 1 << 18, (n,), device=dev,
                                  generator=gen)].contiguous()
    uniq = torch.unique(keys)
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
            fresh.fill_(EMPTY_KEY)

        ms = cuda_ms(lambda: lookup_or_insert(fresh, keys), torch, flush,
                     setup=reset)
        plain_ms = cuda_ms(lambda: lookup_or_insert_plain(fresh, keys),
                           torch, flush, reps=3, setup=reset)
        # the least traffic: each key read (8 B), its slot and ok flag
        # written (4 B + 1 B); each distinct key's home sector of the
        # table read (32 B, the DRAM access unit) and its claim written
        # (8 B); duplicates can find their key's sector in L2
        nbytes = n * (8 + 4 + 1) + int(uniq.numel()) * (32 + 8)
        shapes[cap] = {"n": n, "capacity": cap, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": None,
                       "bound_ms": bound_ms(nbytes), "bound_by": "bytes"}
    # the table holds keys, not values to be near, so its error is the
    # count of keys and rows that broke an invariant above
    return {"max_abs_err": mismatches, "shapes": shapes}


def eager_step_chain(torch, table, count, rev, ts, keys, price,
                     first_open, late, dropped) -> None:
    """The Q5 ingest step as a chain of the probe kernel and eager
    operators (pane division, late count, sanitize, masks, one scatter
    per plane): what ingest_step replaces, and its yardstick."""
    from flink_tpu_torch.ops.hash_table import lookup_or_insert, \
        sanitize_keys_device
    from flink_tpu_torch.ops.segment_ops import scatter_fold

    panes = torch.div(ts, PANE_MS, rounding_mode="floor")
    fresh = panes >= first_open
    late += (~fresh).sum()
    _, slots, ok = lookup_or_insert(table, sanitize_keys_device(keys), fresh)
    dropped += (fresh & ~ok).sum()
    ok = slots >= 0
    ring_idx = panes % RING
    for kind, arr, vals in (("count", count, torch.ones_like(slots)),
                            ("sum", rev, price)):
        flat = ring_idx.to(torch.int64) * arr.shape[-1] + \
            slots.to(torch.int64).clamp(min=0)
        scatter_fold(kind, arr.view(-1), flat, vals, ok)


def q5_step_case(torch, dev, n_keys: int, n_events: int, cap: int) -> dict:
    """Q5 state after STEP_PREFIX batches (built by the step chain, which
    every checkout has) and the batch after them."""
    from flink_tpu_torch.ops.hash_table import make_table
    from flink_tpu_torch.ops.segment_ops import make_accumulator

    span = q5_panes(n_events) * PANE_MS
    gen = q5_gen(n_keys, n_events, span)

    def batch(b):
        idx = b * BATCH + torch.arange(BATCH, dtype=torch.int64, device=dev)
        cols = gen(idx)
        return cols["ts"], cols["auction"], cols["price"]

    table = make_table(cap, dev)
    count = make_accumulator("count", (RING, cap), torch.int32, dev)
    rev = make_accumulator("sum", (RING, cap), torch.int64, dev)
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(STEP_PREFIX):
        eager_step_chain(torch, table, count, rev, *batch(b), MIN_TIMESTAMP,
                         late, dropped)
    return {"table": table, "count": count, "rev": rev,
            "batch": batch(STEP_PREFIX)}


def time_step_chain(torch, dev, flush, case: dict) -> float:
    table0, count, rev = case["table"], case["count"], case["rev"]
    table = table0.clone()
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    return cuda_ms(lambda: eager_step_chain(
        torch, table, count, rev, *case["batch"], MIN_TIMESTAMP, late,
        dropped), torch, flush, setup=lambda: table.copy_(table0))


def check_ingest(torch, dev, flush) -> dict:
    """The fused step on the next Q5 batch, against its plain version."""
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, ingest_step, \
        ingest_step_plain, lookup, sanitize_keys_device

    shapes = {}
    mismatches = 0
    # the scalar-buffer form: first_open read from a device scalar, as a
    # CUDA graph replays it (runtime/compiled.py)
    first_open_at = torch.full((), MIN_TIMESTAMP, dtype=torch.int64,
                               device=dev)
    forms = (("kernel", ingest_step, MIN_TIMESTAMP),
             ("plain", ingest_step_plain, MIN_TIMESTAMP),
             ("kernel_scalar_buffer", ingest_step, first_open_at),
             ("plain_scalar_buffer", ingest_step_plain, first_open_at))
    for label, n_keys, n_events, cap in Q5_CELLS:
        case = q5_step_case(torch, dev, n_keys, n_events, cap)
        ts, keys, price = case["batch"]
        runs = {}
        for name, step, first_open in forms:
            table = case["table"].clone()
            count, rev = case["count"].clone(), case["rev"].clone()
            late = torch.zeros((), dtype=torch.int64, device=dev)
            dropped = torch.zeros((), dtype=torch.int64, device=dev)
            step(table, [("count", count, None), ("sum", rev, price)], ts,
                 keys, PANE_MS, 0, first_open, late, dropped)
            occupied = torch.nonzero(table != EMPTY_KEY).flatten()
            sorted_keys, order = torch.sort(table[occupied])
            slots = occupied[order]
            rows = sorted({int(ts[0]) // PANE_MS % RING,
                           int(ts[-1]) // PANE_MS % RING})
            runs[name] = (sorted_keys, count[rows][:, slots],
                          rev[rows][:, slots], int(late), int(dropped),
                          table)
        wk, wc, wr, wl, wd, _ = runs["plain"]
        for form in ("kernel", "kernel_scalar_buffer", "plain_scalar_buffer"):
            gk, gc, gr, gl, gd, _ = runs[form]
            bad = {"key_set": int(gk.numel() != wk.numel())
                   or int((gk != wk).sum()),
                   "count_plane": 0 if gk.numel() != wk.numel()
                   else int((gc != wc).sum()),
                   "revenue_plane": 0 if gk.numel() != wk.numel()
                   else int((gr != wr).sum()),
                   "late": abs(gl - wl), "dropped": abs(gd - wd)}
            if any(bad.values()):
                raise AssertionError(f"ingest_step {label} {form}: entries "
                                     "differing from the plain version: "
                                     f"{bad}")
            mismatches += sum(bad.values())
        gtable = runs["kernel"][5]
        # the bound, from this batch: new keys and (ring row, key) pairs
        table0 = case["table"]
        d_new = int((gtable != EMPTY_KEY).sum() - (table0 != EMPTY_KEY).sum())
        slot = lookup(gtable, sanitize_keys_device(keys)).to(torch.int64)
        d_pk = int(torch.unique((ts // PANE_MS % RING) * cap + slot).numel())
        nbytes = BATCH * (8 + 8 + 8) + d_new * (32 + 8) + d_pk * 2 * 2 * 32
        table = table0.clone()
        count, rev = case["count"], case["rev"]
        late = torch.zeros((), dtype=torch.int64, device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)

        def run(step, first_open=MIN_TIMESTAMP):
            return lambda: step(table, [("count", count, None),
                                        ("sum", rev, price)], ts, keys,
                                PANE_MS, 0, first_open, late, dropped)

        reset = lambda: table.copy_(table0)  # noqa: E731
        shapes[cap] = {
            "q5": label, "n": BATCH, "capacity": cap, "new_keys": d_new,
            "ring_key_pairs": d_pk,
            "ms": cuda_ms(run(ingest_step), torch, flush, setup=reset),
            "ms_scalar_buffer": cuda_ms(run(ingest_step, first_open_at),
                                        torch, flush, setup=reset),
            "plain_ms": cuda_ms(run(ingest_step_plain), torch, flush,
                                reps=3, setup=reset),
            "eager_chain_ms": time_step_chain(torch, dev, flush, case),
            "library_ms": None, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes"}
        del case, runs, table
    return {"max_abs_err": mismatches, "shapes": shapes}


def check_ingest_forms(torch, dev, flush) -> dict:
    """The two optional forms of ingest_step on the next Q5 batch, each
    against the plain version with the same parts: dirty marking (the form
    of every step of the main paths) at capacity 2^21 and 2^24, and the
    spill split at the spill phase's capacity 2^23 with about half of the
    128 key groups spilled. Table key set, planes key by key, late and
    dropped equal; the marked blocks exactly the blocks the kernel's folds
    wrote; the staged rows equal as a multiset, the stage count and the
    touch clock equal. Times the form beside today's form (no parts) in
    the same call; the bound adds the bytes of the parts to the step's."""
    from flink_tpu_torch.core.keygroups import key_groups_device
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, StepSpill, \
        ingest_step, ingest_step_plain, lookup, sanitize_keys_device

    spilled = torch.from_numpy(
        np.random.default_rng(5).random(MAXP) < 0.5).to(dev)
    cases = [("dirty", label, k, e, c) for label, k, e, c in Q5_CELLS]
    cases.append(("spill", "10M", Q5_CELLS[1][1], Q5_CELLS[1][2],
                  SPILL_BUDGET))
    shapes, mismatches = {}, 0
    for form, label, n_keys, n_events, cap in cases:
        case = q5_step_case(torch, dev, n_keys, n_events, cap)
        ts, keys, price = case["batch"]
        nb = cap >> DIRTY_SHIFT

        def parts():
            dirty = torch.zeros(nb + 1, dtype=torch.uint8, device=dev)
            spill = None
            if form == "spill":
                spill = StepSpill(
                    spilled, torch.zeros(MAXP, dtype=torch.int64, device=dev),
                    1, torch.zeros((), dtype=torch.int64, device=dev),
                    torch.zeros(BATCH, dtype=torch.int64, device=dev),
                    torch.zeros(BATCH, dtype=torch.int32, device=dev),
                    [None, torch.zeros(BATCH, dtype=torch.int64, device=dev)])
            return dirty, spill

        runs = {}
        for name, step in (("kernel", ingest_step),
                           ("plain", ingest_step_plain)):
            table = case["table"].clone()
            count, rev = case["count"].clone(), case["rev"].clone()
            late = torch.zeros((), dtype=torch.int64, device=dev)
            dropped = torch.zeros((), dtype=torch.int64, device=dev)
            dirty, spill = parts()
            step(table, [("count", count, None), ("sum", rev, price)], ts,
                 keys, PANE_MS, 0, MIN_TIMESTAMP, late, dropped, dirty,
                 DIRTY_SHIFT, spill)
            occupied = torch.nonzero(table != EMPTY_KEY).flatten()
            sorted_keys, order = torch.sort(table[occupied])
            slots = occupied[order]
            rows = sorted({int(ts[0]) // PANE_MS % RING,
                           int(ts[-1]) // PANE_MS % RING})
            runs[name] = (sorted_keys, count[rows][:, slots],
                          rev[rows][:, slots], int(late), int(dropped),
                          table, dirty, spill)
        gk, gc, gr, gl, gd, gtable, gdirty, gspill = runs["kernel"]
        wk, wc, wr, wl, wd, _wt, _wdirty, wspill = runs["plain"]
        same = gk.numel() == wk.numel()
        bad = {"key_set": int(not same) or int((gk != wk).sum()),
               "count_plane": 0 if not same else int((gc != wc).sum()),
               "revenue_plane": 0 if not same else int((gr != wr).sum()),
               "late": abs(gl - wl), "dropped": abs(gd - wd)}
        skeys = sanitize_keys_device(keys)
        folds = torch.ones_like(skeys, dtype=torch.bool)
        staged = 0
        if form == "spill":
            folds = ~spilled[key_groups_device(skeys, MAXP).to(torch.int64)]
            staged = int(gspill.count)
            n = min(staged, BATCH)
            got_rows, want_rows = (
                np.unique(np.stack([sp.keys[:n].cpu().numpy(),
                                    sp.ring[:n].cpu().numpy(),
                                    sp.values[1][:n].cpu().numpy()]), axis=1,
                          return_counts=True)
                for sp in (gspill, wspill))
            bad["stage_count"] = abs(staged - int(wspill.count))
            bad["stage_rows"] = int(not (
                np.array_equal(got_rows[0], want_rows[0])
                and np.array_equal(got_rows[1], want_rows[1])))
            bad["touch"] = int((gspill.touch != wspill.touch).sum())
            if staged == 0 or int((~folds).sum()) != staged:
                bad["stage_count"] += 1
        written = torch.unique(
            lookup(gtable, skeys)[folds].to(torch.int64) >> DIRTY_SHIFT)
        marked = torch.nonzero(gdirty[:nb]).flatten()
        bad["dirty_blocks"] = (int(written.numel() != marked.numel())
                               or int((written != marked).sum()))
        if any(bad.values()):
            raise AssertionError(f"ingest_step {form} form at {label}: "
                                 "entries differing from the plain version: "
                                 f"{bad}")
        mismatches += sum(bad.values())
        # the bound: the step's bytes for the rows that fold, plus the
        # parts: one byte per marked block; a staged row's 8 + 4 + 8 bytes;
        # the clock's read and write
        table0 = case["table"]
        d_new = int((gtable != EMPTY_KEY).sum() - (table0 != EMPTY_KEY).sum())
        slot = lookup(gtable, skeys)[folds].to(torch.int64)
        d_pk = int(torch.unique((ts[folds] // PANE_MS % RING) * cap
                                + slot).numel())
        nbytes = (BATCH * (8 + 8 + 8) + d_new * (32 + 8) + d_pk * 2 * 2 * 32
                  + marked.numel() + staged * 20
                  + (2 * MAXP * 8 if form == "spill" else 0))
        table = table0.clone()
        count, rev = case["count"], case["rev"]
        late = torch.zeros((), dtype=torch.int64, device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        dirty, spill = parts()

        def run(step, with_parts=True):
            return lambda: step(
                table, [("count", count, None), ("sum", rev, price)], ts,
                keys, PANE_MS, 0, MIN_TIMESTAMP, late, dropped,
                dirty if with_parts else None, DIRTY_SHIFT,
                spill if with_parts else None)

        def reset():
            table.copy_(table0)
            if spill is not None:
                spill.count.zero_()

        ms = cuda_ms(run(ingest_step), torch, flush, setup=reset)
        shapes[f"{form}_cap_2^{cap.bit_length() - 1}"] = {
            "q5": label, "form": form, "n": BATCH, "capacity": cap,
            "new_keys": d_new, "ring_key_pairs": d_pk,
            "dirty_blocks": int(marked.numel()), "staged_rows": staged,
            "ms": ms,
            "ms_without_parts": cuda_ms(run(ingest_step, False), torch,
                                        flush, setup=reset),
            "plain_ms": cuda_ms(run(ingest_step_plain), torch, flush,
                                reps=3, setup=reset),
            "library_ms": None, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "share_of_bound": bound_ms(nbytes) / ms}
        del case, runs, table
    return {"max_abs_err": mismatches, "shapes": shapes}


#: plane signatures of the window kernels on the two paths: (kind, pane
#: dtype name); Q5 ranks count(value_bits=31) with sum(price), Q7 takes
#: max(packed) with the count plane every window operator keeps
SEAL_SIGS = {"q5": (("count", "int32"), ("sum", "int64")),
             "q7": (("count", "int64"), ("max", "int64"))}
#: (label, signature, window panes, ring, capacities) of the checked
#: window kernels: Q5 at W = 5 and W = 20 (bench.py's ring 2W + 6), Q7
#: tumbling, and a 128-pane window whose ring and 512-leaf tree the
#: kernels' parameters could not hold by value
SEAL_CASES = (("q5", "q5", WINDOW_PANES, RING, (1 << 21, 1 << 24)),
              ("q7", "q7", 1, RING, (1 << 21, 1 << 24)),
              ("q5_w20", "q5", WIDE_PANES, 2 * WIDE_PANES + 6, (1 << 24,)),
              ("q7_w128", "q7", 128, 2 * 128 + 6, (1 << 16,)))


def tree_walk(leaves: int, old_leaf: int, new_leaf: int) -> tuple[int, int]:
    """(sibling reads, node writes) of one tree seal in csrc/window_seal.cu:
    both leaves written, then the union of their ancestor paths."""
    a, b = leaves + old_leaf, leaves + new_leaf
    reads, writes = 0, 2
    while a > 1:
        if a == b:
            reads, writes, a = reads + 1, writes + 1, a >> 1
        elif a ^ 1 == b:
            writes, a = writes + 1, a >> 1
        else:
            reads, writes, a, b = reads + 2, writes + 2, a >> 1, b >> 1
            continue
        b = a
    return reads, writes


def seal_bytes(planes, new_row: int, sub_row: int, sub_valid: bool,
               new_leaf: int, old_leaf: int) -> int:
    """Bytes one seal must move, each read once and each write once: an
    invertible plane reads its window and the new (and retiring) pane row
    and writes the view and the window; a tree reads the new row and the
    siblings on the two paths and writes the changed nodes and the view."""
    total = 0
    for kind, pane, state, _view in planes:
        pb, ab = pane.element_size(), state.element_size()
        if kind in ("sum", "count"):
            retire = pb if sub_valid and sub_row != new_row else 0
            total += ab + pb + retire + 2 * ab
        else:
            reads, writes = tree_walk(state.shape[0] // 2, old_leaf,
                                      new_leaf)
            total += pb + reads * ab + (writes + 1) * ab
    return total * planes[0][1].shape[1]


def rebuild_bytes(planes, rows: list, sub_row: int, sub_valid: bool) -> int:
    """Bytes one rebuild must move: each live row read once (and the
    retiring row, when it is not one of them), the view and the window
    (or every node of the tree) written once."""
    total = 0
    for kind, pane, state, _view in planes:
        pb, ab = pane.element_size(), state.element_size()
        reads = len(rows) * pb
        if kind in ("sum", "count"):
            extra = pb if sub_valid and sub_row not in rows else 0
            total += reads + extra + 2 * ab
        else:
            total += reads + (state.shape[0] + 1) * ab
    return total * planes[0][1].shape[1]


def seal_planes(torch, dev, sig: str, ring: int, cap: int, gen):
    """Two equal copies of a signature's planes on a ring of ``ring``
    rows: random pane rows (Q5: counts of a few bids and revenues; Q7:
    packed words below 2^34), zeroed windows and identity trees of
    pow2_ceil(ring) leaves, and a view each."""
    from flink_tpu_torch.ops.segment_ops import make_accumulator, pow2_ceil
    from flink_tpu_torch.runtime.operators.device_window import \
        _window_dtype

    copies = ([], [])
    for kind, dt_name in SEAL_SIGS[sig]:
        dt = getattr(torch, dt_name)
        hi = {"count": 9, "sum": 997 * 9, "max": 1 << Q7_VALUE_BITS}[kind]
        pane = torch.randint(0, hi, (ring, cap), dtype=torch.int64,
                             device=dev, generator=gen).to(dt)
        wdt = _window_dtype(kind, dt)
        shape = ((cap,) if kind in ("sum", "count")
                 else (2 * pow2_ceil(ring), cap))
        for planes in copies:
            planes.append((kind, pane,
                           make_accumulator(kind, shape, wdt, dev),
                           torch.empty(cap, dtype=wdt, device=dev)))
    return copies


def check_window_seal(torch, dev, flush) -> dict:
    """window_seal and window_rebuild against their plain versions on each
    SEAL_CASES shape: a rebuild from the window's W live rows, then seals
    at W (the retiring pane valid and not) and at another width, each
    followed by a check that every view and state is exactly equal. Timed
    on the case's own shape: a seal and a rebuild at W."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.ops.segment_ops import pow2_ceil
    from flink_tpu_torch.ops.window_seal import rebuild, rebuild_plain, \
        seal, seal_plain

    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    mismatches = 0
    for label, sig, W, ring, caps in SEAL_CASES:
        L = pow2_ceil(ring)
        steps = ((f"w{W}", W, True), (f"w{W}_sub_invalid", W, False),
                 ("w5", 5, True) if W == 1 else ("w1", 1, True))
        for cap in caps:
            name = f"{label}_cap_2^{cap.bit_length() - 1}"
            kern, plain = seal_planes(torch, dev, sig, ring, cap, gen)
            p_end = 3 * ring + 7
            rows = [p % ring for p in range(p_end - W, p_end)]
            leaves = [p % L for p in range(p_end - W, p_end)]
            sub_row = (p_end - W) % ring
            reset_launches()
            rebuild(kern, rows, leaves, sub_row, True)
            rebuild_plain(plain, rows, leaves, sub_row, True)
            for step, w, sub_valid in (("rebuild", W, True),) + steps:
                if step != "rebuild":
                    p_end += 1
                    args = ((p_end - 1) % ring, (p_end - w) % ring,
                            sub_valid, (p_end - 1) % L, (p_end - 1 - w) % L)
                    seal(kern, *args)
                    seal_plain(plain, *args)
                torch.cuda.synchronize()
                bad = sum(int((a[2] != b[2]).sum() + (a[3] != b[3]).sum())
                          for a, b in zip(kern, plain))
                mismatches += bad
                if bad:
                    raise AssertionError(
                        f"window kernels {name} {step}: {bad} entries "
                        "differ from the plain version")
            if (KERNEL_LAUNCHES["window_seal"], KERNEL_LAUNCHES[
                    "window_rebuild"]) != (len(steps), 1):
                raise AssertionError(f"window kernels launched "
                                     f"{KERNEL_LAUNCHES}")
            args = (p_end % ring, (p_end + 1 - W) % ring, True, p_end % L,
                    (p_end - W) % L)
            rargs = (rows, leaves, sub_row, True)
            seal_ms = cuda_ms(lambda: seal(kern, *args), torch, flush)
            rebuild_ms = cuda_ms(lambda: rebuild(kern, *rargs), torch, flush)
            seal_bound = bound_ms(seal_bytes(kern, *args))
            rebuild_bound = bound_ms(rebuild_bytes(kern, rows, sub_row,
                                                   True))
            out[name] = {
                "capacity": cap, "ring": ring, "tree_leaves": L,
                "window_panes": W,
                "checked": ["rebuild"] + [st for st, _w, _v in steps],
                "seal_ms": seal_ms,
                "seal_plain_ms": cuda_ms(lambda: seal_plain(plain, *args),
                                         torch, flush, reps=5),
                "seal_bound_ms": seal_bound,
                "seal_share_of_bound": seal_bound / seal_ms,
                "rebuild_ms": rebuild_ms,
                "rebuild_plain_ms": cuda_ms(
                    lambda: rebuild_plain(plain, *rargs), torch, flush,
                    reps=5),
                "rebuild_bound_ms": rebuild_bound,
                "rebuild_share_of_bound": rebuild_bound / rebuild_ms,
                "bound_by": "bytes", "library_ms": None}
            del kern, plain
    # integers: the count of view and state entries that differ
    return {"max_abs_err": mismatches, "shapes": out}


def device_kernels(torch, fn, symbol: str,
                   count: int) -> tuple[list[str], int]:
    """Names of the kernels ``fn`` ran on the card, in start order, from
    the first of up to PROFILE_TRIES profiles that recorded ``count``
    kernels named ``symbol`` (the profiler at times loses a kernel's
    record; the launch counters do not); and the profiles taken."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        if sum(symbol in n for n in names) == count:
            break
    return names, tries


def check_launch_shape(torch, dev) -> dict:
    """A profiler's count: one Q5 step is one launch, and a fire's select
    runs its passes back to back, with no other kernel between them."""
    from flink_tpu_torch.ops.hash_table import ingest_step
    from flink_tpu_torch.ops.topk import masked_topk

    label, n_keys, n_events, cap = Q5_CELLS[0]
    case = q5_step_case(torch, dev, n_keys, n_events, cap)
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    step, step_tries = device_kernels(torch, lambda: ingest_step(
        case["table"], [("count", case["count"], None),
                        ("sum", case["rev"], case["batch"][2])],
        case["batch"][0], case["batch"][1], PANE_MS, 0, MIN_TIMESTAMP, late,
        dropped), "ingest_step_kernel", 1)
    if len(step) != 1 or "ingest_step_kernel" not in step[0]:
        raise AssertionError(f"one Q5 step ran {step}")
    gen = torch.Generator(device=dev).manual_seed(6)
    values, valid = q5_window_counts(torch, dev, cap, gen)
    fire, fire_tries = device_kernels(
        torch, lambda: masked_topk(values, valid, TOPK, value_bits=31),
        "radix_pass_kernel", 4)
    passes = [j for j, name in enumerate(fire) if "radix_pass_kernel" in name]
    if len(passes) != 4 or passes != list(range(passes[0], passes[0] + 4)):
        raise AssertionError(f"the select's passes are not 4 back-to-back "
                             f"launches: {fire}")
    return {"q5_step_kernels": len(step), "select_kernels": len(fire),
            "select_passes_back_to_back": len(passes),
            "profiles_taken": step_tries + fire_tries}


def parent_kernels(torch, dev, flush) -> dict:
    """The kernels an older checkout shares with this one, timed alike."""
    return {"hist256": check_hist256(torch, dev, flush),
            "hash_probe": check_hash_probe(torch, dev, flush),
            "eager_step_chain": {
                cap: {"q5": label, "ms": time_step_chain(
                    torch, dev, flush,
                    q5_step_case(torch, dev, n_keys, n_events, cap))}
                for label, n_keys, n_events, cap in Q5_CELLS}}


# -- Q5 -------------------------------------------------------------------
def ring_for(window_panes: int) -> int:
    """bench.py's ring for a window width: 16, or 2W + 6 for wide ones."""
    return max(RING, 2 * window_panes + 6)


def q5_panes(n_events: int, batch: int = BATCH,
             window_panes: int = WINDOW_PANES) -> int:
    """bench.py's pane count: the stream spans at most ring - W - 2 panes
    of the ring ``ring_for(W)``."""
    return max(4, min(ring_for(window_panes) - window_panes - 2,
                      n_events // batch))


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


def q5_env(torch, dev, n_keys: int, n_events: int, capacity: int,
           batch: int = BATCH, topk: int = TOPK, defer: bool = True,
           fire_mode: str = "full", window_panes: int = WINDOW_PANES,
           fused: bool = False, wm_interval: float = 0.0,
           settings: dict | None = None, rate: float | None = None,
           staging: int = 1 << 16, source_hook=None):
    """The Q5 pipeline on a fresh StreamExecutionEnvironment, not yet
    executed; returns (env, got, span ms), ``got`` filled by the sink with
    (window end - 1, auctions, bids, revenue) per window. ``defer`` False
    takes the host-batch path: each device batch comes to the host, and
    the table grows inline. ``fire_mode`` "incremental" sets
    ``window.fire.incremental``; ``fused`` sets
    ``pipeline.fusion.enabled``; ``wm_interval`` is the source's
    watermark interval (0: after every batch, the cadence of the old
    single-thread runner); ``settings`` adds configuration keys (an HBM
    budget: ``state.backend.tpu.hbm-budget-slots``); ``rate`` caps the
    source's events per second; ``staging`` is the operator's
    ``spill_staging_slots``; ``source_hook(source)`` receives the
    ``DataGenSource``."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import SlidingEventTimeWindows

    span = q5_panes(n_events, batch, window_panes) * PANE_MS
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    got = []

    def sink(b):
        got.append((int(b.timestamps[0]), b.column("auction"),
                    b.column("bids"), b.column("revenue")))

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": batch,
                       "window.fire.incremental": fire_mode == "incremental",
                       "pipeline.fusion.enabled": fused,
                       "pipeline.auto-watermark-interval": wm_interval,
                       **(settings or {})}), device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    source = DataGenSource(q5_gen(n_keys, n_events, span), schema,
                           count=n_events, rate_per_sec=rate,
                           timestamp_column="ts", device=True)
    if source_hook is not None:
        source_hook(source)
    (env.from_source(source, ws, "DataGen")
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(window_panes * PANE_MS, PANE_MS))
        .device_aggregate([AggSpec("count", out_name="bids", value_bits=31),
                           AggSpec("sum", "price", out_name="revenue")],
                          capacity=capacity,
                          ring_size=ring_for(window_panes),
                          emit_window_bounds=False, emit_topk=topk,
                          defer_overflow=defer, async_fire=True,
                          spill_staging_slots=staging)
        .add_sink(sink))
    return env, got, span


def run_q5(torch, dev, n_keys: int, n_events: int, capacity: int, **kw):
    """One run of the Q5 pipeline through ``env.execute()`` on the
    runtime (keywords: ``q5_env``'s); returns (the finished job, [(window
    end - 1, auctions, bids, revenue)], span ms)."""
    env, got, span = q5_env(torch, dev, n_keys, n_events, capacity, **kw)
    job = env.execute("nexmark-q5")
    return job, got, span


def q5_expected(n_keys: int, n_events: int, span: int, topk: int = TOPK,
                window_panes: int = WINDOW_PANES) -> list:
    """The numpy oracle of every Q5 window, once per configuration:
    [(end pane, top values, candidates, their bids and revenue, keys
    strictly above the k-th value)], where the candidates are the keys at
    or above the k-th value. Each window's sums slide: its newest pane is
    added and the pane that left it subtracted, one bincount each."""
    idx = np.arange(n_events, dtype=np.int64)
    keys = ((idx.astype(np.uint64) * np.uint64(MULT))
            % np.uint64(n_keys)).astype(np.int64)
    price = idx % 997 + 1
    panes = (idx * span) // n_events // PANE_MS
    n_p = int(panes[-1]) + 1
    bounds = np.searchsorted(panes, np.arange(n_p + 1))

    def pane_sums(p):
        a, b = bounds[p], bounds[p + 1]
        return (np.bincount(keys[a:b], minlength=n_keys),
                np.bincount(keys[a:b], weights=price[a:b],
                            minlength=n_keys).astype(np.int64))

    c = np.zeros(n_keys, np.int64)
    r = np.zeros(n_keys, np.int64)
    out = []
    for p_end in range(int(panes[0]) + 1, n_p + window_panes):
        for p, sign in ((p_end - 1, 1), (p_end - 1 - window_panes, -1)):
            if 0 <= p < n_p:
                pc, pr = pane_sums(p)
                c += sign * pc
                r += sign * pr
        kk = min(topk, int((c > 0).sum()))
        want = -np.sort(-np.partition(c, len(c) - kk)[len(c) - kk:])
        cand = np.flatnonzero(c >= want[-1])
        out.append((p_end, want, cand, c[cand], r[cand],
                    set(np.flatnonzero(c > want[-1]).tolist())))
    return out


def q5_check(expected: list, got) -> int:
    """Hold every emitted window against the oracle under the tie rule;
    returns the windows checked."""
    ends = [(ts + 1) // PANE_MS for ts, *_ in got]
    if ends != [e[0] for e in expected]:
        raise AssertionError(f"fired windows {ends} != "
                             f"{[e[0] for e in expected]}")
    for (ts, k, bids, revenue), (p_end, want, cand, cc, cr, strict) in zip(
            got, expected):
        kk, kth = len(want), want[-1]
        pos = np.minimum(np.searchsorted(cand, k), len(cand) - 1)
        ok = (len(k) == kk and len(np.unique(k)) == kk
              and np.array_equal(cand[pos], k)
              and np.array_equal(bids.astype(np.int64), want)
              and np.array_equal(cc[pos], bids.astype(np.int64))
              and np.array_equal(cr[pos], revenue.astype(np.int64))
              and set(k[bids > kth].tolist()) == strict)
        if not ok:
            raise AssertionError(f"Q5 window ending at pane {p_end} "
                                 "disagrees with the numpy oracle")
    return len(got)


def q5_oracle_check(n_keys: int, n_events: int, span: int, got,
                    topk: int = TOPK,
                    window_panes: int = WINDOW_PANES) -> int:
    """Hold every emitted window against numpy under the tie rule; returns
    the windows checked."""
    return q5_check(q5_expected(n_keys, n_events, span, topk, window_panes),
                    got)


# -- Q7 -------------------------------------------------------------------
def q7_gen(n_keys: int, n_events: int, span: int):
    """bench.py's Q7 generator on int64 torch indices: the auction key as
    in ``q5_gen``, and the packed word (price << 20) | bidder, whose max
    carries the winning bid's payload."""
    q5 = q5_gen(n_keys, n_events, span)

    def gen(idx):
        cols = q5(idx)
        price = idx % Q7_PRICES + 1
        bidder = idx % (1 << Q7_BIDDER_BITS)
        return {"auction": cols["auction"],
                "packed": (price << Q7_BIDDER_BITS) | bidder,
                "ts": cols["ts"]}

    return gen


def run_q7(torch, dev, n_keys: int, n_events: int, capacity: int,
           batch: int = BATCH, fire_mode: str = "full", fused: bool = False,
           wm_interval: float = 0.0):
    """One run of bench.py's Q7 (the highest bid of each tumbling window:
    max(packed, value_bits=34), top 1, with window bounds) through the
    port's public API; returns (job result, [(window end - 1, auctions,
    starts, ends, best)], span ms)."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import TumblingEventTimeWindows

    span = q5_panes(n_events, batch) * Q7_PANE_MS
    schema = Schema([("auction", np.int64), ("packed", np.int64),
                     ("ts", np.int64)])
    got = []

    def sink(b):
        got.append((int(b.timestamps[0]), b.column("auction"),
                    b.column("window_start"), b.column("window_end"),
                    b.column("best")))

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": batch,
                       "window.fire.incremental": fire_mode == "incremental",
                       "pipeline.fusion.enabled": fused,
                       "pipeline.auto-watermark-interval": wm_interval}),
        device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    (env.datagen(q7_gen(n_keys, n_events, span), schema, count=n_events,
                 timestamp_column="ts", watermark_strategy=ws, device=True)
        .key_by("auction")
        .window(TumblingEventTimeWindows.of(Q7_PANE_MS))
        .device_aggregate([AggSpec("max", "packed", out_name="best",
                                   value_bits=Q7_VALUE_BITS)],
                          capacity=capacity, ring_size=RING,
                          emit_window_bounds=True, emit_topk=1,
                          defer_overflow=True, async_fire=True)
        .add_sink(sink))
    job = env.execute("nexmark-q7")
    return job, got, span


def q7_expected(n_keys: int, n_events: int, span: int) -> list:
    """[(end pane, auction, window start, window end, packed word)] of
    every window: the auction of the pane's largest packed word, which is
    unique (price and bidder together name the event up to 9973 * 2^20
    events)."""
    idx = np.arange(n_events, dtype=np.int64)
    keys = ((idx.astype(np.uint64) * np.uint64(MULT))
            % np.uint64(n_keys)).astype(np.int64)
    packed = ((idx % Q7_PRICES + 1) << Q7_BIDDER_BITS) | \
        (idx % (1 << Q7_BIDDER_BITS))
    panes = (idx * span) // n_events // Q7_PANE_MS
    n_p = int(panes[-1]) + 1
    bounds = np.searchsorted(panes, np.arange(n_p + 1))
    out = []
    for p in range(int(panes[0]), n_p):
        block = packed[bounds[p]:bounds[p + 1]]
        j = int(np.argmax(block))
        if int((block == block[j]).sum()) != 1:
            raise AssertionError(f"Q7 pane {p}: the top packed word is not "
                                 "unique; the oracle needs it to be")
        out.append((p + 1, int(keys[bounds[p] + j]), p * Q7_PANE_MS,
                    (p + 1) * Q7_PANE_MS, int(block[j])))
    return out


def q7_check(expected: list, got) -> int:
    """Every window: its one row is the expected winner, with its bounds;
    returns the windows checked."""
    if any(len(cols[0]) != 1 for _ts, *cols in got):
        raise AssertionError("Q7: a window emitted other than one row")
    rows = [(((ts + 1) // Q7_PANE_MS), *(int(c[0]) for c in cols))
            for ts, *cols in got]
    if rows != expected:
        bad = [(g, e) for g, e in zip(rows, expected) if g != e][:3]
        raise AssertionError(f"Q7: {len(rows)} windows, {len(expected)} "
                             f"expected; first differences {bad}")
    return len(got)


# -- coalesced ingest ---------------------------------------------------------
def run_coalesced_q5(torch, dev, n_keys: int, n_events: int, capacity: int,
                     batch: int = CO_BATCH, target: int = CO_TARGET,
                     wm_every: int = CO_WM_EVERY, topk: int = TOPK):
    """Q5 through ``DeviceWindowAggOperator`` driven directly, with the
    watermark cadence fixed in batches rather than wall time:
    device batches of ``batch`` rows, ``task.coalesce.target-records`` =
    ``target``, and a watermark (the batch's largest timestamp - 1, as the
    monotonous strategy gives) every ``wm_every`` batches. Returns
    (operator, [(window end - 1, auctions, bids, revenue)], span ms)."""
    from flink_tpu_torch.core import Configuration, Schema
    from flink_tpu_torch.core.device_records import DeviceRecordBatch
    from flink_tpu_torch.core.elements import MAX_WATERMARK
    from flink_tpu_torch.runtime import OneInputOperatorTestHarness
    from flink_tpu_torch.runtime.operators import AggSpec, \
        DeviceWindowAggOperator
    from flink_tpu_torch.window import SlidingEventTimeWindows

    span = q5_panes(n_events) * PANE_MS
    gen = q5_gen(n_keys, n_events, span)
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    op = DeviceWindowAggOperator(
        SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS),
        "auction", [AggSpec("count", out_name="bids", value_bits=31),
                    AggSpec("sum", "price", out_name="revenue")],
        capacity=capacity, ring_size=RING, emit_window_bounds=False,
        emit_topk=topk, defer_overflow=True, async_fire=True, device=dev)
    h = OneInputOperatorTestHarness(
        op, schema, Configuration({"task.coalesce.target-records": target}))
    for i in range(n_events // batch):
        idx = torch.arange(i * batch, (i + 1) * batch, dtype=torch.int64,
                           device=dev)
        cols = gen(idx)
        ts_max = ((i + 1) * batch - 1) * span // n_events
        h.process_batch(DeviceRecordBatch(
            schema, cols, cols["ts"], i * batch * span // n_events, ts_max,
            ts_column="ts"))
        if (i + 1) % wm_every == 0:
            h.process_watermark(ts_max - 1)
    h.process_watermark(MAX_WATERMARK.timestamp)
    h.close()
    got = [(int(b.timestamps[0]), b.column("auction"), b.column("bids"),
            b.column("revenue")) for b in h.output.batches]
    return op, got, span


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


#: hand kernel -> the symbol the profiler records it under
KERNEL_SYMBOLS = (("ingest_step", "ingest_step_kernel"),
                  ("hist256", "radix_pass_kernel"),
                  ("window_seal", "window_kernel<true>"),
                  ("window_rebuild", "window_kernel<false>"))


def run_profile(torch, run) -> dict:
    """One more run under torch.profiler: the card's busy time by kernel
    (CUPTI records every kernel in the process, the ones this package
    launches through ctypes too) against the run's wall time, and the
    profiler's count of each hand kernel, which must equal its launch
    counter (a profile that lost a kernel would understate busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    for tries in range(1, PROFILE_TRIES + 1):
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            job, _got, _span = run()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                acc = by_name.setdefault(e.name[:90], [0.0, 0])
                acc[0] += e.self_device_time_total / 1e3
                acc[1] += 1
        counted = {kernel: sum(n for name, (_ms, n) in by_name.items()
                               if symbol in name)
                   for kernel, symbol in KERNEL_SYMBOLS}
        if all(n == KERNEL_LAUNCHES[k] for k, n in counted.items()):
            break
    else:
        raise AssertionError(f"profiler counted {counted} launches in each "
                             f"of {PROFILE_TRIES} profiles, the counters "
                             f"{dict(KERNEL_LAUNCHES)}")
    busy = sum(ms for ms, _n in by_name.values())
    wall = job.wall_s * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": (1 - busy / wall) if busy else None,
            "kernel_launches": sum(n for _ms, n in by_name.values()),
            "profiler_counts": counted, "profiles_taken": tries,
            "top": [{"name": k, "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def fire_device_ms(torch, run) -> dict:
    """Runs ``run()`` with every window fire timed on the card alone: the
    card is drained and put to sleep for about 20 ms, the fire is enqueued
    between two CUDA events (seal or merge, emit mask, select, gathers,
    the copy home, the retirement of the oldest pane) while the card
    sleeps, so the events time the fire's device work back to back,
    without the host's launch gaps. A fire whose start event the card
    reached before the host had enqueued the fire would include such
    gaps: the run fails if one does."""
    from flink_tpu_torch.runtime.operators.device_window import \
        DeviceWindowAggOperator as Op

    fire = Op._fire
    per_fire, host_ms, overtaken = [], [], []

    def timed(self, p_end):
        torch.cuda.synchronize()
        torch.cuda._sleep(FIRE_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fire(self, p_end)
        end.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        overtaken.append(start.query())
        end.synchronize()
        per_fire.append(start.elapsed_time(end))

    Op._fire = timed
    try:
        run()
    finally:
        Op._fire = fire
    if any(overtaken):
        raise AssertionError(f"{sum(overtaken)} fires were reached by the "
                             "card before the host had enqueued them")
    return {"fires": len(per_fire),
            "median_ms": float(np.median(per_fire)),
            "mean_ms": float(np.mean(per_fire)),
            "first_ms": per_fire[0], "max_ms": max(per_fire),
            "host_enqueue_median_ms": float(np.median(host_ms))}


def check_no_repeated_waits(torch, label: str, run) -> list[str]:
    """A warm-up run under the sync debug mode: no batch and no fire may
    make the host wait for the card; the only waits are the once-per-job
    reads at end of input (the source's monotonicity flag, the late
    counter). Returns where the host waited."""
    syncs = implicit_syncs(torch, run)
    repeated = sorted({s for s in syncs if syncs.count(s) > 1})
    if repeated:
        raise AssertionError(f"{label}: the host waited for the card more "
                             f"than once per job at {repeated}")
    return sorted(syncs)


def timed_run(torch, label: str, run, check, passes: int, fire_mode: str,
              n_events: int) -> dict:
    """One timed run, held to the oracle (``check(got)`` returns the
    windows) and to the path's launches: one ingest step per batch,
    ``passes`` select passes per fire, and in incremental mode one seal or
    rebuild per fire. Counters are zeroed just before the run."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    start = fresh_memory(torch)
    reset_launches()
    job, got, _span = run()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    windows = check(got)
    seen = {"ingest_step": launches["ingest_step"],
            "ingest_step_dirty": launches["ingest_step_dirty"],
            "hist256": launches["hist256"],
            "window_kernels": launches["window_seal"]
            + launches["window_rebuild"]}
    want = {"ingest_step": n_events // BATCH,
            "ingest_step_dirty": n_events // BATCH,
            "hist256": passes * windows,
            "window_kernels": windows if fire_mode == "incremental" else 0}
    if seen != want:
        raise AssertionError(f"{label} {fire_mode}: launches {launches}, "
                             f"expected {want} on the main path")
    op = job.operators[0]
    return {"wall_s": job.wall_s, "lat": list(op.fire_latencies_ms),
            "peak": peak, "start": start, "launches": launches,
            "windows": windows,
            "rebuilds": dict(op.inc_rebuilds),
            "late_dropped": op.late_dropped,
            "state_bytes": op.backend.state_nbytes,
            "tasks": task_record(job)}


def fresh_memory(torch) -> dict:
    """Before a measured run: drain the card, free what earlier runs left
    (a finished job's tasks and its reporter reference each other, so
    its device state waits for the cyclic collector), and reset the peak.
    Returns the bytes allocated before and after the collection."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return {"allocated_before_gc": before,
            "allocated_at_start": torch.cuda.memory_allocated()}


def task_record(job) -> dict:
    """Per task of a runtime job: CPU seconds of its thread, seconds its
    loop slept with nothing to do, seconds its writers were blocked on a
    full channel, and the most elements one of its output channels held;
    for a direct run, the CPU seconds of the one thread."""
    if not hasattr(job, "tasks"):
        return {"direct": {"cpu_s": job.cpu_s}}
    return {tid: {"cpu_s": t.cpu_s, "idle_s": t.idle_s,
                  "backpressured_s": sum(w.backpressured_s
                                         for w in t.writers),
                  "max_queued": max((w.max_queued for w in t.writers),
                                    default=0)}
            for tid, t in job.tasks.items()}


def summary(runs: list, n_events: int) -> dict:
    lat = sorted(x for r in runs for x in r["lat"])
    eps = sorted(n_events / r["wall_s"] for r in runs)
    last = runs[-1]
    return {"runs": len(runs), "wall_s": [r["wall_s"] for r in runs],
            "events_per_sec": float(np.median(eps)),
            "events_per_sec_min_max": [eps[0], eps[-1]],
            "p99_fire_latency_ms": lat[min(len(lat) - 1,
                                           int(0.99 * len(lat)))],
            "fires": len(lat), "windows_checked_per_run": last["windows"],
            "rebuilds_by_cause": last["rebuilds"],
            "late_dropped": last["late_dropped"],
            "state_bytes": last["state_bytes"],
            "max_memory_allocated": max(r["peak"] for r in runs),
            "memory_at_start": [r["start"] for r in runs],
            "launches_per_run": last["launches"],
            "tasks_last_run": last["tasks"]}


def cell_phase(torch, label: str, modes: tuple, runs: int, run, check,
               passes: int, n_events: int, meta: dict) -> dict:
    """A cell's timed runs: a warm-up of 4 batches per mode under the sync
    check, then ``runs`` timed runs of each mode in turns (full,
    incremental, full, ...), so both modes meet the same state of the
    process and the card. ``run(mode, events)`` runs the pipeline."""
    waits = {m: check_no_repeated_waits(
        torch, f"{label} {m}", lambda m=m: run(m, 4 * BATCH))
        for m in modes}
    done = {m: [] for m in modes}
    for _ in range(runs):
        for m in modes:
            done[m].append(timed_run(torch, label, lambda m=m: run(m, None),
                                     check, passes, m, n_events))
    return {m: {"cell": label, "fire_mode": m, **meta,
                "host_waits_per_job": waits[m],
                **summary(done[m], n_events)} for m in modes}


def q5_cell(torch, dev, label: str, n_keys: int, n_events: int,
            capacity: int, modes=("full",), window_panes: int = WINDOW_PANES,
            runs: int = Q5_RUNS) -> tuple[dict, object]:
    """A Q5 cell's timed runs in each of ``modes``; returns (results by
    mode, run(mode, events) for the profiles)."""
    def run(mode, events, **kw):
        return run_q5(torch, dev, n_keys, events or n_events, capacity,
                      fire_mode=mode, window_panes=window_panes, **kw)

    span = q5_panes(n_events, BATCH, window_panes) * PANE_MS
    expected = q5_expected(n_keys, n_events, span, TOPK, window_panes)
    meta = {"q5": label, "window_panes": window_panes,
            "ring": ring_for(window_panes), "keys": n_keys,
            "events": n_events, "capacity": capacity, "batch": BATCH}
    return cell_phase(torch, f"Q5 {label}", modes, runs, run,
                      lambda got: q5_check(expected, got), 4, n_events,
                      meta), run


def q7_cell(torch, dev, n_keys: int, n_events: int,
            capacity: int) -> tuple[dict, object]:
    """The Q7 cell's timed runs in both modes; value_bits 34 makes 5
    digit passes of the select per fire."""
    def run(mode, events, **kw):
        return run_q7(torch, dev, n_keys, events or n_events, capacity,
                      fire_mode=mode, **kw)

    expected = q7_expected(n_keys, n_events,
                           q5_panes(n_events, BATCH) * Q7_PANE_MS)
    meta = {"q7": f"{n_keys // 1_000_000}M", "keys": n_keys,
            "events": n_events, "capacity": capacity, "batch": BATCH,
            "pane_ms": Q7_PANE_MS}
    return cell_phase(torch, "Q7 10M", ("full", "incremental"), SHORT_RUNS,
                      run, lambda got: q7_check(expected, got), 5,
                      n_events, meta), run


def coalesce_phase(torch, dev) -> dict:
    """Coalesced ingest at the operator level, Q5-1M: batches of 2^16
    rows gather to 2^19 records, so one ingest step runs per 8 batches."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.metrics import DEVICE_STATS

    _label, n_keys, n_events, cap = Q5_CELLS[0]
    before = DEVICE_STATS.snapshot()["batches_coalesced_total"]
    reset_launches()
    op, got, span = run_coalesced_q5(torch, dev, n_keys, n_events, cap)
    launches = dict(KERNEL_LAUNCHES)
    windows = q5_oracle_check(n_keys, n_events, span, got)
    n_batches = n_events // CO_BATCH
    merged = DEVICE_STATS.snapshot()["batches_coalesced_total"] - before
    steps = n_batches * CO_BATCH // CO_TARGET
    if launches["ingest_step"] != steps or merged != n_batches:
        raise AssertionError(f"coalesced Q5: {launches['ingest_step']} "
                             f"ingest steps for {n_batches} batches "
                             f"({merged} coalesced), expected {steps}")
    return {"coalesce": "Q5-1M", "batch": CO_BATCH, "target": CO_TARGET,
            "watermark_every": CO_WM_EVERY, "batches": n_batches,
            "batches_coalesced": merged, "windows_checked": windows,
            "launches": launches}


def q5_host_batch_phase(torch, dev) -> dict:
    """Q5 with defer_overflow=False: host batches through the standalone
    probe, with the table growing once (100k keys pass 0.6 x 2^17)."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    n_keys, n_events, cap = 100_000, 1 << 21, 1 << 17
    reset_launches()
    job, got, span = run_q5(torch, dev, n_keys, n_events, cap, defer=False)
    launches = dict(KERNEL_LAUNCHES)
    windows = q5_oracle_check(n_keys, n_events, span, got)
    grown = job.operators[0].backend.capacity
    if launches["hash_probe"] == 0 or grown != 2 * cap:
        raise AssertionError(f"host-batch Q5: launches {launches}, table "
                             f"{cap} -> {grown}; expected hash_probe "
                             "launches and one doubling")
    return {"q5": "host-batch", "keys": n_keys, "events": n_events,
            "capacity": [cap, grown], "windows_checked": windows,
            "wall_s": job.wall_s, "launches": launches}


# -- the runtime -------------------------------------------------------------
#: the Q5-10M runtime cell's runners: the single-thread loop of the old
#: local runner over the same operators ("direct"), the task/channel
#: runtime ("runtime"), and the runtime with the fused chain ("fused")
RT_MODES = ("direct", "runtime", "fused")
CKPT_RUN_S, CKPT_INTERVAL_S = 2.5, 0.5   # checkpoint phase: source pacing
CO_WM_INTERVAL_S = 0.005                 # coalescing through the runtime


def run_q5_direct(torch, dev, n_keys: int, n_events: int, capacity: int,
                  **kw):
    """Q5 on the deployed job's own reader and operator chain, driven on
    the calling thread by the single-thread loop the local runner of the
    port ran before the task runtime: read a batch, assign timestamps,
    push it through the chain, emit the watermark when it advanced; at
    end of input the MAX watermark, finish, and drain the card. Returns
    (run record with ``operators``, ``wall_s`` and the thread's
    ``cpu_s``, windows, span ms)."""
    from types import SimpleNamespace

    from flink_tpu_torch.cluster import deploy_local
    from flink_tpu_torch.core.elements import MAX_WATERMARK, Watermark

    env, got, span = q5_env(torch, dev, n_keys, n_events, capacity, **kw)
    job = deploy_local(env.get_job_graph("nexmark-q5-direct"), env.config,
                       env.device)
    (src,) = job.source_tasks.values()
    (win,) = [t for t in job.tasks.values() if t is not src]
    chain, reader, ws = win.chain, src.reader, src.ws
    size = env.config.get("pipeline.micro-batch-size")
    chain.open()
    gen = ws.create_generator()
    last = MIN_TIMESTAMP
    t0, cpu0 = time.perf_counter(), time.thread_time()
    while (batch := reader.read_batch(size)) is not None:
        batch = ws.assign_timestamps(batch)
        gen.on_batch(batch)
        chain.process_batch(batch)
        wm = gen.current_watermark()
        if wm > last:
            last = wm
            chain.process_watermark(Watermark(wm))
    chain.process_watermark(MAX_WATERMARK)
    chain.finish()
    chain.close()
    reader.close()
    torch.cuda.synchronize()
    run = SimpleNamespace(operators=chain.operators,
                          wall_s=time.perf_counter() - t0,
                          cpu_s=time.thread_time() - cpu0)
    return run, got, span


def host_enqueue(torch, run) -> dict:
    """Runs ``run()`` with the device reader's ``read_batch`` and the
    window operator's ``process_batch`` timed on the host: the median ms
    per micro-batch each thread spends enqueueing (a fire's enqueue falls
    in the watermark, not here)."""
    from flink_tpu_torch.connectors.datagen import _DeviceDataGenReader
    from flink_tpu_torch.runtime.operators.device_window import \
        DeviceWindowAggOperator as Op

    times = {"read_ms": [], "process_ms": []}
    originals = ((_DeviceDataGenReader, "read_batch", "read_ms"),
                 (Op, "process_batch", "process_ms"))

    def timed(fn, key):
        def wrapper(self, *a):
            t0 = time.perf_counter()
            out = fn(self, *a)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    saved = [getattr(cls, name) for cls, name, _key in originals]
    for (cls, name, key), fn in zip(originals, saved):
        setattr(cls, name, timed(fn, key))
    try:
        run()
    finally:
        for (cls, name, _key), fn in zip(originals, saved):
            setattr(cls, name, fn)
    return {k: float(np.median(v)) if v else None for k, v in times.items()}


def runtime_phase(torch, dev) -> dict:
    """Q5-10M through the runtime, fusion off and on, in turns with the
    old single-thread loop over the same operators; every window of every
    run against the oracle; one profiled run of each; the host's enqueue
    per batch."""
    label, n_keys, n_events, cap = Q5_CELLS[1]
    runners = {"direct": run_q5_direct, "runtime": run_q5,
               "fused": lambda *a, **k: run_q5(*a, fused=True, **k)}

    def run(mode, events):
        return runners[mode](torch, dev, n_keys, events or n_events, cap)

    span = q5_panes(n_events) * PANE_MS
    expected = q5_expected(n_keys, n_events, span)
    meta = {"q5": label, "keys": n_keys, "events": n_events,
            "capacity": cap, "batch": BATCH, "watermark_interval_s": 0.0}
    cells = cell_phase(torch, f"Q5 {label} runtime", RT_MODES, Q5_RUNS, run,
                       lambda got: q5_check(expected, got), 4, n_events,
                       meta)
    for mode in RT_MODES:
        cells[mode]["runner"] = mode
        cells[mode]["profile"] = run_profile(
            torch, lambda m=mode: run(m, None))
        cells[mode]["host_enqueue_per_batch"] = host_enqueue(
            torch, lambda m=mode: run(m, None))
    return cells


def fused_chain_phase(torch, dev) -> dict:
    """The fused chain at the Q5-10M shape, at the operator level: a
    run's batches (64 of 2^19 rows and two power-of-two tails) go once
    through the fused chain and once through the reader's decode and the
    unfused step, into two operators. The key set, every pane plane of
    every key, and the late and dropped counters must be equal bit for
    bit; under the profiler the fused feed must be one graph launch and
    one ingest_step per micro-batch, and chain_fused_dispatches_total
    must count every micro-batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.metrics import DEVICE_STATS
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY
    from flink_tpu_torch.runtime import OneInputOperatorTestHarness
    from flink_tpu_torch.runtime.operators import AggSpec, \
        DeviceWindowAggOperator
    from flink_tpu_torch.window import SlidingEventTimeWindows

    _label, n_keys, base, cap = Q5_CELLS[1]
    n_events = base + (1 << 18) + (1 << 16)
    span = q5_panes(base) * PANE_MS
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    source = DataGenSource(q5_gen(n_keys, n_events, span), schema,
                           count=n_events, timestamp_column="ts",
                           device=True)
    feeds = {}
    for fused in (False, True):
        reader = source.create_reader(source.create_splits(1)[0], dev)
        op = DeviceWindowAggOperator(
            SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS),
            "auction", [AggSpec("count", out_name="bids", value_bits=31),
                        AggSpec("sum", "price", out_name="revenue")],
            capacity=cap, ring_size=RING, emit_window_bounds=False,
            emit_topk=TOPK, defer_overflow=True, async_fire=True,
            device=dev)
        if fused:
            reader.enable_fused()
            op.enable_fused_chain(source, 0, 1)
        h = OneInputOperatorTestHarness(op, schema)
        h.open()
        feeds[fused] = (reader, op, h)

    def feed(fused: bool) -> tuple[int, list]:
        reader, op, h = feeds[fused]
        host_ms = []
        n = 0
        while True:
            t0 = time.perf_counter()
            batch = reader.read_batch(BATCH)
            if batch is None:
                break
            h.process_batch(batch)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            n += 1
        torch.cuda.synchronize()
        return n, host_ms

    reset_launches()
    n_unfused, host_unfused = feed(False)
    unfused_launches = KERNEL_LAUNCHES["ingest_step"]
    before = DEVICE_STATS.snapshot()["chain_fused_dispatches_total"]
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n_fused, host_fused = feed(True)
    fused_launches = KERNEL_LAUNCHES["ingest_step"]
    dispatches = DEVICE_STATS.snapshot()["chain_fused_dispatches_total"] \
        - before
    graph_launches = sum("cudaGraphLaunch" in e.name for e in prof.events()
                         if e.device_type == DeviceType.CPU)
    step_kernels = sum("ingest_step_kernel" in e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA)

    def state(op):
        backend = op.backend
        table = backend.table
        slots = torch.nonzero(table != EMPTY_KEY).flatten()
        keys, order = torch.sort(table[slots])
        slots = slots[order]
        return ([keys] + [backend.get_array(name)[:, slots]
                          for name in ("__count__", "revenue")]
                + [backend.dropped_device.reshape(1),
                   op._late_dev.reshape(1)])

    got, want = state(feeds[True][1]), state(feeds[False][1])
    names = ("keys", "count_plane", "revenue_plane", "dropped", "late")
    bad = {name: (int(a.numel() != b.numel()) if a.shape != b.shape
                  else int((a != b).sum()))
           for name, a, b in zip(names, got, want)}
    batches = n_events // BATCH + 2
    counts = {"micro_batches": (n_fused, n_unfused, batches),
              "graph_launches": graph_launches,
              "ingest_step_kernels": step_kernels,
              "ingest_step_launches": (fused_launches, unfused_launches),
              "chain_fused_dispatches_total": dispatches}
    if any(bad.values()):
        raise AssertionError(f"fused chain: state differing from the "
                             f"unfused run: {bad}")
    if not (n_fused == n_unfused == batches == graph_launches
            == step_kernels == fused_launches == unfused_launches
            == dispatches):
        raise AssertionError(f"fused chain: expected {batches} of each: "
                             f"{counts}")
    captures = feeds[True][1].fused_chain.captures
    for _reader, _op, h in feeds.values():
        h.close()
    return {"fused_chain": "Q5-10M", "events": n_events, "capacity": cap,
            "differing_entries": bad, **counts, "graph_captures": captures,
            "host_ms_per_batch_fused": float(np.median(host_fused)),
            "host_ms_per_batch_unfused": float(np.median(host_unfused))}


def coalesce_runtime_phase(torch, dev) -> dict:
    """Coalesced ingest inside the runtime: Q5-1M in batches of 2^16
    rows, task.coalesce.target-records 2^19, the source's watermark every
    5 ms of wall time: batches must gather, and every window must equal
    the oracle."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.metrics import DEVICE_STATS

    _label, n_keys, n_events, cap = Q5_CELLS[0]
    before = DEVICE_STATS.snapshot()["batches_coalesced_total"]
    reset_launches()
    job, got, span = run_q5(
        torch, dev, n_keys, n_events, cap, batch=CO_BATCH,
        wm_interval=CO_WM_INTERVAL_S,
        settings={"task.coalesce.target-records": CO_TARGET})
    launches = dict(KERNEL_LAUNCHES)
    merged = DEVICE_STATS.snapshot()["batches_coalesced_total"] - before
    windows = q5_oracle_check(n_keys, n_events, span, got)
    if merged == 0:
        raise AssertionError("coalesced Q5 through the runtime: no batch "
                             "gathered at a 5 ms watermark interval")
    (src,) = job.source_tasks.values()
    return {"coalesce_runtime": "Q5-1M", "batch": CO_BATCH,
            "target": CO_TARGET, "watermark_interval_s": CO_WM_INTERVAL_S,
            "batches": n_events // CO_BATCH, "batches_coalesced": merged,
            "ingest_steps": launches["ingest_step"],
            "watermarks": src.watermarks_out, "windows_checked": windows,
            "wall_s": job.wall_s, "events_per_sec": n_events / job.wall_s}


def snapshot_digest(snap: dict) -> str:
    """blake2b over every field of a keyed snapshot, in order: the keys,
    the key groups, and each state's kind, dtype, ring and value bytes."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for f in ("keys", "key_groups"):
        a = np.ascontiguousarray(snap[f])
        h.update(a.dtype.str.encode())
        h.update(a.tobytes())
    h.update(str(snap["max_parallelism"]).encode())
    for name, st in snap["states"].items():
        v = np.ascontiguousarray(st["values"])
        h.update(f"{name}|{st['kind']}|{st['dtype']}|{st['ring']}|"
                 f"{v.dtype.str}|{v.shape}".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def q5_operator(torch, dev, capacity: int, **kw):
    """The Q5 window operator of ``q5_env`` in a test harness, opened;
    keywords go to the operator (a budget, a staging size)."""
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.runtime import OneInputOperatorTestHarness
    from flink_tpu_torch.runtime.operators import AggSpec, \
        DeviceWindowAggOperator
    from flink_tpu_torch.window import SlidingEventTimeWindows

    op = DeviceWindowAggOperator(
        SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS),
        "auction", [AggSpec("count", out_name="bids", value_bits=31),
                    AggSpec("sum", "price", out_name="revenue")],
        capacity=capacity, ring_size=RING, emit_window_bounds=False,
        emit_topk=TOPK, defer_overflow=True, async_fire=True, device=dev,
        **kw)
    h = OneInputOperatorTestHarness(op, Schema(
        [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]))
    h.open()
    return op, h


def mirror_phase(torch, dev) -> dict:
    """Snapshots through the mirror against the whole-copy snapshot at
    Q5-10M, at the operator level: the state of 16 batches (a full
    capture), 8 batches more (a delta under load: Q5 spreads a batch over
    every block), none (idle), and a batch of 64 hot keys (a few blocks)
    with a retired ring row (replayed on the host). Each snapshot must equal
    the whole-copy snapshot of the same state field by field; prints each
    one's phases, DMA bytes and dirty share beside the whole copy's
    seconds."""
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.core.device_records import DeviceRecordBatch

    _label, n_keys, n_events, cap = Q5_CELLS[1]
    span = q5_panes(n_events) * PANE_MS
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    source = DataGenSource(q5_gen(n_keys, n_events, span), schema,
                           count=n_events, timestamp_column="ts",
                           device=True)
    reader = source.create_reader(source.create_splits(1)[0], dev)
    fresh_memory(torch)
    op, h = q5_operator(torch, dev, cap)
    backend = op.backend
    records = []
    last = [None]

    def feed(k: int) -> None:
        for _ in range(k):
            batch = reader.read_batch(BATCH)
            last[0] = batch
            h.process_batch(batch)

    def snap(label: str) -> None:
        cid = len(records) + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = op.snapshot_state(cid)["keyed"]["backend"]
        took = time.perf_counter() - t0
        log = dict(backend.snapshot_log[-1])
        t1 = time.perf_counter()
        want = backend.snapshot_plain(cid)
        plain_s = time.perf_counter() - t1
        if snapshot_digest(got) != snapshot_digest(want):
            raise AssertionError(f"mirror snapshot '{label}' differs from "
                                 "the whole-copy snapshot")
        records.append({"snapshot": label, "seconds": took, **log,
                        "whole_copy_s": plain_s})

    feed(16)
    snap("full_capture")
    feed(8)
    snap("delta_under_load")
    snap("idle")
    hot = torch.arange(64, dtype=torch.int64, device=dev).repeat(16)
    ts = torch.full_like(hot, last[0].ts_max)
    h.process_batch(DeviceRecordBatch(
        schema, {"auction": hot, "price": hot + 1, "ts": ts}, ts,
        last[0].ts_max, last[0].ts_max, ts_column="ts"))
    backend.reset_ring_row(0)
    snap("hot_keys_and_a_retired_row")
    full = records[0]["dma_bytes"]
    if not (records[2]["dma_bytes"] * 100 < full
            and records[3]["dma_bytes"] * 10 < full):
        raise AssertionError(f"idle or hot-key snapshots moved too much: "
                             f"{[r['dma_bytes'] for r in records]}")
    return {"mirror": "Q5-10M", "capacity": cap, "keys": records[-1]["keys"],
            "state_bytes": backend.state_nbytes, "snapshots": records}


def wait_checkpoints(job, n: int, spilled: bool = False,
                     after: float = 0.0, timeout: float = 300.0) -> None:
    """Until ``n`` checkpoints of ``job`` triggered after the wall time
    ``after`` completed (or the job failed); with ``spilled``, until the
    last of them holds host-tier keys too."""
    def done() -> bool:
        stats = [s for s in job.coordinator.stats
                 if s.get("started", 0.0) > after]
        if len(stats) < n:
            return False
        log = {r["checkpoint_id"]: r
               for r in job.operators[0].backend.snapshot_log}
        return not spilled or log.get(stats[-1]["id"], {}).get(
            "host_keys", 0) > 0

    t0 = time.perf_counter()
    while (not done() and not job._failed
           and time.perf_counter() - t0 < timeout):
        time.sleep(0.002)
    if not done():
        raise AssertionError(f"{len(job.coordinator.stats)} checkpoints "
                             f"completed, waiting for {n} after {after} "
                             f"(spilled: {spilled}): {job._failed}")


def checkpoint_record(job, stat: dict) -> dict:
    """A finished checkpoint: the window task's barrier-to-ack split into
    the snapshot's capture, order and gather (and host tier), the store,
    the DMA bytes, dirty share, snapshot bytes and fs bytes written."""
    op = job.operators[0]
    (win,) = [t for t in stat["barrier_to_ack_s"]
              if t not in job.source_tasks]
    log = next((r for r in op.backend.snapshot_log
                if r["checkpoint_id"] == stat["id"]), {})
    return {"id": stat["id"],
            "window_barrier_to_ack_s": stat["barrier_to_ack_s"].get(win),
            "barrier_to_ack_s": stat["barrier_to_ack_s"],
            "capture_s": log.get("capture"), "order_s": log.get("order"),
            "gather_s": log.get("gather"), "host_tier_s": log.get("host_tier"),
            "store_s": stat["store_s"], "dma_bytes": log.get("dma_bytes"),
            "dirty_share": log.get("dirty_share"),
            "host_keys": log.get("host_keys"),
            "snapshot_bytes": stat["bytes"],
            "fs_bytes_written": stat.get("bytes_written")}


def checkpoint_phase(torch, dev) -> dict:
    """Checkpoint and restore at Q5-10M into FsCheckpointStorage (a
    temporary directory). The source is paced to finish in CKPT_RUN_S
    seconds and checkpoints are on every CKPT_INTERVAL_S. After the first
    checkpoint (a full capture) completed the source pauses until two
    checkpoints triggered after the pause completed: the first of them
    still takes the batches queued before the pause, the second is idle
    (the window task has drained), and its DMA bytes must be a small
    fraction of the full capture's. The second checkpoint of the run is
    a delta under load. The job is cancelled still paused;
    the idle checkpoint, loaded from disk, must equal the whole-copy
    snapshot of the job's state, and a fresh job restores from the
    checkpoint's directory and runs to the end. Every window of both equals the
    oracle; none repeats, and together they are every window."""
    import shutil
    import tempfile

    from flink_tpu_torch.checkpoint.storage import load_checkpoint

    label, n_keys, n_events, cap = Q5_CELLS[1]
    ckpt_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_ckpt_")
    sources = []
    try:
        env, got, span = q5_env(
            torch, dev, n_keys, n_events, cap, rate=n_events / CKPT_RUN_S,
            source_hook=sources.append,
            settings={"execution.checkpointing.interval": CKPT_INTERVAL_S,
                      "execution.checkpointing.dir": ckpt_dir})
        fresh_memory(torch)
        t0 = time.perf_counter()
        job = env.execute_async("q5-checkpointed")
        wait_checkpoints(job, 1)
        sources[0].set_rate(0)
        paused_at = time.perf_counter() - t0
        wait_checkpoints(job, 2, after=time.time())
        job.cancel()
        stats = [s for s in job.coordinator.stats if not s.get("failed")]
        cp = job.coordinator.latest_checkpoint()
        op = job.operators[0]
        records = [checkpoint_record(job, s) for s in stats]
        idle, full = records[-1], records[0]
        if not idle["dma_bytes"] * 100 < full["dma_bytes"]:
            raise AssertionError(f"the idle checkpoint moved "
                                 f"{idle['dma_bytes']} bytes against the "
                                 f"full capture's {full['dma_bytes']}")
        on_disk = load_checkpoint(cp.external_path)
        (snap,) = [s["chain"] for s in on_disk.task_snapshots.values()
                   if s.get("chain")]
        (window,) = [v for v in snap.values() if "keyed" in v]
        stored = window["keyed"]["backend"]
        t1 = time.perf_counter()
        whole = op.backend.snapshot_plain(cp.checkpoint_id)
        whole_copy_s = time.perf_counter() - t1
        if snapshot_digest(stored) != snapshot_digest(whole):
            raise AssertionError("the idle checkpoint on disk differs from "
                                 "the whole-copy snapshot of the state")
        before = list(got)
        del job, op, env, whole, stored, snap, window, on_disk
        env2, got2, _span = q5_env(torch, dev, n_keys, n_events, cap)
        env2.restore_from_checkpoint(cp.external_path)
        t2 = time.perf_counter()
        job2 = env2.execute_async("q5-restored")
        deploy_s = time.perf_counter() - t2
        job2.wait()
        restore_s = job2.operators[0].first_batch_at - t2
        expected = q5_expected(n_keys, n_events, span)
        by_end = {e[0]: e for e in expected}

        def check(rows) -> list:
            ends = [(ts + 1) // PANE_MS for ts, *_ in rows]
            q5_check([by_end[e] for e in ends], rows)
            return ends

        ends1, ends2 = check(before), check(got2)
        if not ends2 or not ends1 or set(ends1) & set(ends2):
            raise AssertionError(f"windows before the cancel {ends1} and "
                                 f"after the restore {ends2} overlap or one "
                                 "side is empty")
        if sorted(ends1 + ends2) != sorted(by_end):
            raise AssertionError("windows of the two jobs miss some: "
                                 f"{ends1} and {ends2}")
        return {"checkpoint": f"Q5-{label}", "events": n_events,
                "storage": "FsCheckpointStorage",
                "source_rate_per_s": n_events / CKPT_RUN_S,
                "interval_s": CKPT_INTERVAL_S, "paused_after_s": paused_at,
                "checkpoints": records, "restored_from": cp.checkpoint_id,
                "whole_copy_s": whole_copy_s,
                "chunks_on_disk": len(os.listdir(os.path.join(ckpt_dir,
                                                              "chunks"))),
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "restore_deploy_s": deploy_s,
                "restore_to_first_batch_s": restore_s,
                "windows_before_cancel": len(ends1),
                "windows_after_restore": len(ends2),
                "windows_repeated": 0}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def spill_record(job, n_events: int, peak: int) -> dict:
    """A budgeted run: throughput, fire latency, where the keys live,
    evictions, the host tier's seconds and peak device memory."""
    op = job.operators[0]
    b = op.backend
    lat = sorted(op.fire_latencies_ms)
    host = b.host_tier
    return {"wall_s": job.wall_s, "events_per_sec": n_events / job.wall_s,
            "p99_fire_latency_ms": lat[min(len(lat) - 1,
                                           int(0.99 * len(lat)))],
            "fires": len(lat), "capacity": b.capacity,
            "keys_resident": b.num_keys,
            "keys_spilled": len(host.index) if host else 0,
            "groups_spilled": int(host.spilled_mask.sum()) if host else 0,
            "evictions": dict(b.evictions),
            "host_fold_s": b.spill_s["host_fold"],
            "evict_s": b.spill_s["evict"],
            "drain_s": op.spill_s["drain"],
            "host_fire_s": op.spill_s["host_fire"],
            "rows_drained": op.spill_rows_drained,
            "dropped": int(b.dropped_device),
            "max_memory_allocated": peak}


def spill_phase(torch, dev) -> dict:
    """Q5-10M through ``env.execute()`` with
    ``state.backend.tpu.hbm-budget-slots`` = SPILL_BUDGET (2^23: about
    half the key groups end on the host): every window against the
    oracle, one spill-form ingest_step per batch, no staged row dropped,
    and the run's spill record. Then across budgets: a paced budgeted job
    checkpointed into a directory, cancelled, and restored into an
    unbudgeted job (at the first checkpoint that holds host-tier keys),
    and the reverse; every window of both jobs equals the
    oracle (a window may repeat, with equal values), and each checkpoint
    restored into an operator of the other budget snapshots byte for
    byte as the checkpoint it came from. The budgeted side holds host-tier
    keys: at the checkpoint going one way, during the restored run going
    the other."""
    import shutil
    import tempfile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.checkpoint.storage import load_checkpoint

    label, n_keys, n_events, cap = Q5_CELLS[1]
    budget = {"state.backend.tpu.hbm-budget-slots": SPILL_BUDGET}
    fresh_memory(torch)
    reset_launches()
    job, got, span = run_q5(torch, dev, n_keys, n_events, cap,
                            settings=budget, staging=SPILL_STAGING)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    windows = q5_oracle_check(n_keys, n_events, span, got)
    record = spill_record(job, n_events, peak)
    emit({"spill_run": f"Q5-{label}", **record})
    if (launches["ingest_step_spill"] != n_events // BATCH
            or record["dropped"] or not record["groups_spilled"]):
        raise AssertionError(f"spill run: launches {launches}, record "
                             f"{record}")
    del job, got
    expected = q5_expected(n_keys, n_events, span)
    by_end = {e[0]: e for e in expected}
    crossings = {}
    for name, first, second in (("budgeted_to_unbudgeted", budget, {}),
                                ("unbudgeted_to_budgeted", {}, budget)):
        ckpt_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_spill_")
        try:
            env, got1, _span = q5_env(
                torch, dev, n_keys, n_events, cap, staging=SPILL_STAGING,
                rate=n_events / (2 * CKPT_RUN_S),
                settings={**first,
                          "execution.checkpointing.interval": CKPT_INTERVAL_S,
                          "execution.checkpointing.dir": ckpt_dir})
            fresh_memory(torch)
            job = env.execute_async(f"q5-{name}")
            wait_checkpoints(job, 1, spilled=bool(first))
            job.cancel()
            cp = job.coordinator.latest_checkpoint()
            stat = checkpoint_record(job, job.coordinator.stats[-1])
            spilled_at_cp = job.operators[0].backend.spill_active
            before = list(got1)
            del job, env
            loaded = load_checkpoint(cp.external_path)
            (chain,) = [s["chain"] for s in loaded.task_snapshots.values()
                        if s.get("chain")]
            (window,) = [v for v in chain.values() if "keyed" in v]
            op, _h = q5_operator(
                torch, dev, cap, spill_staging_slots=SPILL_STAGING,
                hbm_budget_slots=second.get(
                    "state.backend.tpu.hbm-budget-slots", 0))
            op.initialize_state([window["keyed"]], None)
            twin = op.backend.snapshot(cp.checkpoint_id)
            if snapshot_digest(twin) != snapshot_digest(
                    window["keyed"]["backend"]):
                raise AssertionError(f"{name}: the checkpoint restored "
                                     "under the other budget snapshots "
                                     "differently")
            twin_spilled = op.backend.spill_active
            del op, _h, twin, loaded, chain, window
            env2, got2, _span = q5_env(torch, dev, n_keys, n_events, cap,
                                       staging=SPILL_STAGING, settings=second)
            env2.restore_from_checkpoint(cp.external_path)
            job2 = env2.execute_async(f"q5-{name}-restored")
            job2.wait()
            ends = []
            for rows in (before, got2):
                e = [(ts + 1) // PANE_MS for ts, *_ in rows]
                q5_check([by_end[x] for x in e], rows)
                ends.append(e)
            if not ends[1] or sorted(set(ends[0]) | set(ends[1])) != \
                    sorted(by_end):
                raise AssertionError(f"{name}: windows {ends}")
            crossings[name] = {
                "checkpoint": stat, "spill_active_at_checkpoint":
                spilled_at_cp, "spill_active_after_restore": twin_spilled,
                "restored_run": spill_record(
                    job2, n_events, torch.cuda.max_memory_allocated()),
                "windows_before": len(ends[0]),
                "windows_after": len(ends[1]),
                "windows_repeated": len(set(ends[0]) & set(ends[1]))}
            del job2, env2, got2
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not (crossings["budgeted_to_unbudgeted"]["spill_active_at_checkpoint"]
            and crossings["unbudgeted_to_budgeted"]["restored_run"][
                "groups_spilled"]):
        raise AssertionError("a crossing did not hold spilled state on the "
                             f"budgeted side: {crossings}")
    return {"spill": f"Q5-{label}", "hbm_budget_slots": SPILL_BUDGET,
            "staging_slots": SPILL_STAGING, "windows_checked": windows,
            "ingest_step_spill_launches": launches["ingest_step_spill"],
            **record, "across_budgets": crossings}


def main(argv: list[str]) -> int:
    if argv and (argv[0] != "--parent-kernels" or len(argv) != 2):
        print("usage: chip_smoke.py [--parent-kernels DIR]", file=sys.stderr)
        return 2
    pkg_dir = os.path.abspath(argv[1]) if argv else HERE
    # the smoke runs on one card: show torch only the first one, so the
    # count it reports is the count it used
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, pkg_dir)
    try:
        import flink_tpu_torch  # noqa: F401
        from flink_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: cannot import flink_tpu_torch from {pkg_dir} "
              f"({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    emit({"device": {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "package": pkg_dir})
    nvcc_s = kernels.build_all()
    emit({"build": {"nvcc_s": nvcc_s, "dir": str(kernels.BUILD_DIR),
                    "sources": sorted(kernels.SOURCES)}})
    flush = L2Flush(torch, dev)
    if argv:
        emit({"parent_kernels": parent_kernels(torch, dev, flush)})
        return 0
    hist = check_hist256(torch, dev, flush)
    select = check_select(torch, dev, flush)
    probe = check_hash_probe(torch, dev, flush)
    step = check_ingest(torch, dev, flush)
    forms = check_ingest_forms(torch, dev, flush)
    shape = check_launch_shape(torch, dev)
    window = check_window_seal(torch, dev, flush)
    emit({"kernel_checks": {"hist256": hist, "select_pass": select,
                            "hash_probe": probe, "ingest_step": step,
                            "ingest_step_forms": forms,
                            "launch_shape": shape, "window_seal": window}})
    del flush
    phase_s = {"build_and_kernels": time.perf_counter() - t_start}
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now

    check_sync_detector(torch, dev)
    # every cell's timed runs first, both fire modes in turns; then the
    # profiled runs, so no profiler session precedes a timed run
    modes = ("full", "incremental")
    (l1, k1, e1, c1), (l10, k10, e10, c10) = Q5_CELLS
    q5_1m, run_1m = q5_cell(torch, dev, l1, k1, e1, c1, runs=SHORT_RUNS)
    emit(q5_1m["full"])
    q5_10m, run_10m = q5_cell(torch, dev, l10, k10, e10, c10, modes)
    wide, run_wide = q5_cell(torch, dev, f"{l10}-W{WIDE_PANES}", k10, e10,
                             c10, modes, WIDE_PANES, WIDE_RUNS)
    q7, run_7 = q7_cell(torch, dev, k10, e10, c10)
    for cell in (q5_10m, wide, q7):
        for m in modes:
            emit(cell[m])
    phase_done("cells")
    cells = (("Q5-10M", run_10m), ("Q5-10M-W20", run_wide),
             ("Q7-10M", run_7))
    emit({"run_profiles": {
        "Q5-1M full": run_profile(torch, lambda: run_1m("full", None)),
        **{f"{cell} {m}": run_profile(torch, lambda r=r, m=m: r(m, None))
           for cell, r in cells for m in modes}}})
    # fires are timed with the fused chain on: source and window are then
    # one task, so no other thread enqueues device work during a fire
    emit({"fire_device_ms": {
        f"{cell} {m}": fire_device_ms(
            torch, lambda r=r, m=m: r(m, None, fused=True))
        for cell, r in cells for m in modes}})
    phase_done("profiles_and_fire_times")
    emit(coalesce_phase(torch, dev))
    host = q5_host_batch_phase(torch, dev)
    emit(host)
    phase_done("coalesce_and_host_batch")
    fused = fused_chain_phase(torch, dev)
    emit(fused)
    phase_done("fused_chain")
    runtime = runtime_phase(torch, dev)
    for m in RT_MODES:
        emit(runtime[m])
    phase_done("runtime")
    emit(coalesce_runtime_phase(torch, dev))
    phase_done("coalesce_runtime")
    emit(mirror_phase(torch, dev))
    phase_done("mirror")
    emit(checkpoint_phase(torch, dev))
    phase_done("checkpoint")
    spill = spill_phase(torch, dev)
    emit(spill)
    phase_done("spill")
    emit({"phase_seconds": phase_s})
    emit({"smoke_seconds_before_kernels_line": time.perf_counter() - t_start})
    main_run = q5_1m["full"]["launches_per_run"]
    inc_run = q5_10m["incremental"]["launches_per_run"]
    small, large = 1 << 21, 1 << 24
    # each window kernel leads with the shape of Q5-10M incremental, the
    # path whose launches it reports
    seal_q5 = window["shapes"]["q5_cap_2^24"]

    def window_entry(kernel: str, replaces: str) -> dict:
        return {"name": f"window_{kernel}", "route": "cuda",
                "source": "flink_tpu_torch/csrc/window_seal.cu",
                "replaces": replaces,
                "launches": inc_run[f"window_{kernel}"],
                "max_abs_err": window["max_abs_err"],
                "ms": seal_q5[f"{kernel}_ms"],
                "plain_ms": seal_q5[f"{kernel}_plain_ms"],
                "bound_ms": seal_q5[f"{kernel}_bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "launches_by_path": {
                    f"{cell} incremental": c["incremental"][
                        "launches_per_run"][f"window_{kernel}"]
                    for cell, c in (("Q5-10M-W20", wide), ("Q7-10M", q7))},
                "shapes": {k: {f: v[f"{kernel}_{f}"] for f in
                               ("ms", "plain_ms", "bound_ms",
                                "share_of_bound")}
                           for k, v in window["shapes"].items()}}

    def form_entry(form: str, launches: int, lead: str,
                   others: set) -> dict:
        entry = forms["shapes"][lead]
        return {"name": f"ingest_step_{form}", "route": "cuda",
                "source": "flink_tpu_torch/csrc/hash_table.cu",
                "replaces": "flink_tpu/runtime/operators/device_window.py:"
                            + ("150" if form == "dirty" else "106"),
                "launches": launches, "max_abs_err": forms["max_abs_err"],
                **{k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                "ms_without_parts": entry["ms_without_parts"],
                "share_of_bound": entry["share_of_bound"],
                "shapes": {k: forms["shapes"][k] for k in {lead} | others}}

    emit({"kernels": [
        {"name": "hist256", "route": "cuda",
         "source": "flink_tpu_torch/csrc/hist256.cu",
         "replaces": "flink_tpu/ops/pallas_topk.py:40",
         "launches": main_run["hist256"],
         "max_abs_err": max(hist["max_abs_err"], select["max_abs_err"]),
         **select["shapes"]["q5_int64_n_2^21"],
         "select_passes": {k: v for k, v in select["shapes"].items()
                           if k != "q5_int64_n_2^21"},
         "standalone_at_n_2^21": hist["shapes"][small],
         "standalone_at_n_2^24": hist["shapes"][large],
         "launches_by_path": {
             f"{cell} {m}": c[m]["launches_per_run"]["hist256"]
             for cell, c in (("Q5-10M", q5_10m), ("Q5-10M-W20", wide),
                             ("Q7-10M", q7)) for m in modes}},
        {"name": "hash_probe", "route": "cuda",
         "source": "flink_tpu_torch/csrc/hash_table.cu",
         "replaces": "flink_tpu/ops/hash_table.py:133",
         "launches": host["launches"]["hash_probe"],
         "max_abs_err": probe["max_abs_err"], **probe["shapes"][small],
         "at_capacity_2^24": probe["shapes"][large]},
        {"name": "ingest_step", "route": "cuda",
         "source": "flink_tpu_torch/csrc/hash_table.cu",
         "replaces": "flink_tpu/runtime/operators/device_window.py:84",
         "launches": main_run["ingest_step"],
         "max_abs_err": step["max_abs_err"], **step["shapes"][small],
         "at_capacity_2^24": step["shapes"][large],
         "launches_q5_10M": q5_10m["full"]["launches_per_run"][
             "ingest_step"],
         "launches_q5_10M_fused": runtime["fused"]["launches_per_run"][
             "ingest_step"],
         "fused_graph_launches_per_micro_batch":
             fused["graph_launches"] / fused["micro_batches"][0]},
        form_entry("dirty", main_run["ingest_step_dirty"],
                   "dirty_cap_2^21", {"dirty_cap_2^24"}),
        form_entry("spill", spill["ingest_step_spill_launches"],
                   "spill_cap_2^23", set()),
        window_entry("seal",
                     "flink_tpu/runtime/operators/device_window.py:295"),
        window_entry("rebuild",
                     "flink_tpu/runtime/operators/device_window.py:352"),
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
    sys.exit(main(sys.argv[1:]))
