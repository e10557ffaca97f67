#!/usr/bin/env python3
"""Smoke run of flink_tpu_torch on one CUDA card: build, kernels, Q5, Q7,
checkpoints, state beyond an HBM budget, session windows (Q11), SQL
GROUP BY on the card (TPC-H Q1, 10M keys), the interval join of two
streams over device list state (Nexmark Q7's join, 100K and 10M
auctions), the row plane (ValueState, keep-first deduplication at 10M
keys), the SQL joins, the DataStream core (WordCount, Nexmark Q1/Q2 as
map and filter, a KeyedProcessFunction, CUMULATE), connectors, CEP and
MATCH_RECOGNIZE, broadcast state, async I/O, the SQL gateway and the
multi-device window path (Q5-10M over 4 shards on the one card, the
builtin route, live rescale).

Run from the repository root:  python3 chip_smoke.py

1. The card: name and power limit as nvidia-smi reports them, torch and
   CUDA versions.
2. Build: every ``flink_tpu_torch/csrc/*.cu`` with nvcc for sm_90a (one
   process per source, in parallel, with ``tools/sector_rate.cu`` beside
   them); the seconds spent.
3. The card's own rate for the scattered accesses of the ingest step
   (``sector_rates``): 2^19 8-byte reads, read-then-CAS claims, CAS, 4-
   and 8-byte atomic adds and plain stores at the Q5-10M cell's
   footprints (a 2^24-slot table, one ring row of [16, 2^24] int32 and
   int64 planes), at random addresses, bucketed into spans of 2^14 slots
   and sorted: G sectors/s each.
4. Kernels, each held against its plain PyTorch version on the card at
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
     version with the same parts: dirty marking at 2^21 and 2^24, and at
     2^24 on Q5-10M's 33rd batch, whose keys are all present (the marked
     blocks exactly those written), and the spill split at 2^23 with
     about half the key groups spilled (staged rows equal position by
     position, in batch order; stage count and touch clock equal), each
     timed beside the step without parts, with its sector floor (the
     sectors its pattern touches) and that floor at the measured rates;
   * both forms on adversarial inputs (``INGEST_EDGE_CASES``): a hot key,
     one bucket of home slots, 1 and ragged row counts, every row late, a
     full table, cells past 2^31, every kind and dtype, and the spill
     split with no group spilled, every group, an overflowing stage, 1,
     100 and 4096 key groups and a clock ahead of the batch number;
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
5. Nexmark Q5 at 1M keys (the bench.py headline: capacity 2^21, ring 16,
   batch 2^19, 2^23 events, 2000 ms panes, 5-pane sliding windows, top
   1000 by count(value_bits=31) with sum(price)) through the port's
   StreamExecutionEnvironment with datagen(device=True) and
   ``env.execute()`` on the task runtime (a source task and a window task
   on two threads, joined by a channel; the watermark interval at 0, so a
   watermark follows every batch), after a short
   warm-up run under PyTorch's sync debug mode, which must flag no wait
   for the card that recurs per batch or per fire. Then 2 timed runs:
   launch counters are zeroed just before each and read just after; each
   run must launch ingest_step once per batch and hist256 once per digit
   pass of each fire; every emitted window of every run is checked
   against a numpy oracle (per-pane bincounts of the same events, top
   1000 by count under the tie rule, revenue of each winner). The median
   events/sec, its range, and p99 fire latency over all the runs' fires
   are printed. One more run under torch.profiler gives the card's busy
   time by kernel against the run's wall time, and counts the launches of
   both kernels again.
6. The same at 10M keys (capacity 2^24, 2^25 events; 4 timed runs), then
   once more with each fire profiled on its own (``fire_device_ms``): the
   device time of one fire (those runs chain source and window into one
   task with the fused chain, so no other thread enqueues work while a
   fire is timed).
7. Q5-10M with ``window.fire.incremental``: the same checks, and one
   window_seal or window_rebuild per fire; the rebuilds are printed by
   cause.
8. Q5-10M at W = 20 (bench.py --window-panes 20: ring 46, 24 panes), 2
   timed runs in each fire mode, and the device time per fire of each.
9. Nexmark Q7 at 10M keys (bench.py _run_q7: 9 tumbling panes of
   10 000 ms, max(packed = (price << 20) | bidder, value_bits 34), top 1,
   window bounds), 2 timed runs in each fire mode: every window's row is
   the auction of its pane's largest packed word, with its bounds; 5
   select passes per fire.
10. Coalesced ingest at the operator level: the Q5-1M events in device
   batches of 2^16 rows, task.coalesce.target-records 2^19, a watermark
   every 8 batches: one ingest_step per 8 batches, windows equal to the
   oracle.
11. The host-batch path: a short Q5 run with defer_overflow=False at 100k
    keys into capacity 2^17, which must launch hash_probe, grow the table
    exactly once, and pass the oracle.
12. The fused chain at the Q5-10M shape, at the operator level: a run's
    batches (and two power-of-two tails) once through the fused chain and
    once through the reader's decode and the unfused step: the table,
    both planes and the late and dropped counters equal bit for bit;
    under the profiler one CUDA graph launch and one ingest_step per
    micro-batch, and chain_fused_dispatches_total equal to the
    micro-batches.
13. Q5-10M through the runtime, fusion off ("runtime") and on ("fused"),
    in turns with the earlier single-thread loop over the same operators
    ("direct"): every window against the oracle, events/s, p99 fire
    latency, peak device memory, launches per run, one profiled run of
    each (idle share) and the host's enqueue per batch.
14. Coalesced ingest inside the runtime: Q5-1M in 2^16-row batches, the
    watermark every 5 ms of wall time, task.coalesce.target-records 2^19:
    batches must gather, and every window equals the oracle.
15. Snapshots through the mirror at Q5-10M (operator level): a full
    capture, a delta under load, an idle one, 64 hot keys, a retired ring
    row; each equal to the whole-copy snapshot, with its capture, order
    and gather seconds, DMA bytes and dirty share.
16. Checkpoint and restore at Q5-10M into FsCheckpointStorage in a
    temporary directory: a paced source, checkpoints every 0.5 s, the
    source paused after the first so the third is idle; the job is
    cancelled, the idle checkpoint on disk equals the whole-copy snapshot,
    a fresh job restores from the directory and runs to the end; every
    window of both equals the oracle and none repeats. Per checkpoint the
    window task's barrier to ack, the snapshot's capture, order and
    gather, the store, DMA and fs bytes; the restore's time to its first
    batch.
17. Q5-10M through env.execute() at state.backend.tpu.hbm-budget-slots
    2^23, with tiered residency (state/tiering/: the 2Q heat policy's
    evictions, promotions of warm key groups back into the table at batch
    boundaries, staged by the prefetch pipeline): every window against
    the oracle, one spill-form ingest_step per batch, no staged row
    dropped; events/sec, p99 fire latency, keys per tier, evictions and
    promotions, the hit ratio per boundary, host seconds (tier_boundary
    on the task's thread, staging off it), apply_promotion's device ms,
    hash_probe launches, peak memory. Then an unbudgeted job's checkpoint
    restored into a budgeted job: windows against the oracle, and the
    checkpoint restored under the budget snapshots byte for byte as it was
    stored. Then ``tiering_phase``: the same
    configuration on the hot-set shift (``shift_keys``: a seeded set of
    key groups goes cold, is driven to the host, then turns hot), through
    the deferred step (staging inline) and through host batches (staging
    off the task's thread, on a stream of its own): each window against
    the oracle, a promotion landing in each, the two runs' rows equal
    under the tie rule; then a deferred run checkpointed and cancelled at
    its first checkpoint that holds a promotion and host-tier keys,
    restored into an unbudgeted operator (its snapshot byte for byte the
    checkpoint's) and an unbudgeted job run to the end (windows against
    the oracle): the budgeted-to-unbudgeted crossing, which the spill
    phase ran on its own before.
18. Session windows (csrc/session_window.cu): in the kernel phase,
    session_step and session_fire against their plain versions at
    Q11-10M's shapes (a 2^19-row batch into 2^24 slots and 4 lanes, the
    fifth batch and the 33rd; a fire over [4, 2^24] with half the lanes
    due, two rounds; the cell's own fire after its 33rd batch, a scan with
    few lanes due), on a signature with sum, min, max and avg under
    disorder and late rows, and on adversarial cases (a hot key across
    blocks; every lane of a key open at 1, 4, 16 and 64 lanes; 0 and 8
    aggregate planes of every dtype; fires with exactly capacity due,
    capacity + 1, none, every lane, ragged entries): planes equal key by
    key (slot for slot on a shared table), emitted and fired rows, the
    counters and the dirty blocks equal, the lanes that are not open at
    the identities; each timed beside its plain version, with its byte
    bound and its sector floor (the 32-byte sectors the layout makes it
    touch), that floor also at the card's measured rates (``priced_sectors``:
    random for the step, in address order for the fire, whose dense blocks
    stream). ptxas's registers, shared memory and spills of every kernel
    are printed after the build. Then the cells, through env.execute()
    with a watermark after every batch: Nexmark Q11 at 10M bidders
    (q11.sql: count(*) per SESSION(dateTime, 10 s); bench.py's key mixer,
    2^25 events over 30 000 ms, batch 2^19, capacity 2^24, 4 lanes) and
    bench.py::bench_session's session-100K (2^21 events over 200 000 ms,
    batch 2^16, gap 5000, sum(v), the watermark 1000 ms behind): every
    emitted window against a numpy oracle, session_step once per batch,
    session_fire at least once per fire, no ingest_step; events/sec, p99
    fire latency, the fire kernel's device ms, peak memory. Then
    session-100K with fs checkpoints around fires, cancelled and restored
    from the last: no window repeated, none lost, the checkpoint equal to
    the whole-copy snapshot.
19. The device GROUP BY (csrc/group_agg.cu). In the kernel phase
    (``check_group_agg``) its step (first and last rows of each slot;
    the compaction in batch order, which finishes a group of one row in
    the batch itself; the fold; the emit) against its plain version at
    both SQL cells' shapes (TPC-H Q1's 6th batch after its WHERE: 300,110
    rows, 6 groups, 12 planes, capacity 2^16; the GROUP BY's 6th batch:
    2^19 rows into 2^24 slots, 7 planes): groups, row indices, counts,
    min, max and whole-number sums equal, other sums within 1e-12
    relative; and on adversarial batches (``GAGG_EDGE_CASES``: one key,
    drains within and across batches, +-inf, -0.0 and NaN, invalid rows,
    ragged and empty batches, 32 planes, composite keys;
    ``GAGG_STEP_CASES``: groups of one row and of several side by side,
    in 32 planes too, with specials, short n_valid, nothing to fold, runs
    of a slot across warps and tiles, a group drained and re-inserted
    within a batch; ``GAGG_CARD_CASES``: 2^19 rows on one and on six
    slots, more slots a fold block meets than its pre-fold table holds,
    all-distinct rows at 2^24 slots) bit for bit. The whole step timed as
    one call (the L2 flushed before it only), each stage's device time
    inside such steps (profiled) and alone (the L2 flushed before it)
    beside its plain version, with its byte bound, 32-byte sector floor
    and floor at the card's measured random rates, and the library calls
    that compute a stage's function (``scatter_reduce_`` for the first
    rows, ``index_add_`` for one sum plane's fold). Then two cells
    through ``TableEnvironment.execute_sql`` on the graph runtime, each a
    warm-up, a timed run (launch counters zeroed before it: each stage of
    the step once per batch, the probe at least once) and a profiled run:
    ``sql_tpch_q1`` (bench.py::bench_tpch_q1's schema, generator and
    query, BASELINE config #5, at 2^25 rows in batches of 2^19; the 6
    final groups against a numpy oracle, the changelog's retractions
    against the rows they retract) and ``sql_groupby_10m`` (COUNT, SUM,
    MIN, MAX and AVG of price per auction over 10M auctions, 2^25 events,
    the table growing by rehash from 2^16 slots; every final group
    against the oracle through a replay of the changelog; then the
    changelog table with one batch of UPDATE_BEFORE rows, some groups
    draining to DELETE). Rows/s, host seconds per batch by part, the
    kernels' device ms and launches, peak device memory.
20. The device list state of the interval join (csrc/device_lists.cu).
    In the kernel phase (``check_device_lists``) list_append, list_probe
    and list_prune against their plain versions at both join cells'
    shapes (capacity 2^25 a side and 2^18, 32 rows a key): the bids' lists
    holding a pane's bids, the next batch of 2^15 appended, the pane's
    maxes (one a distinct auction, about 3.4M at 10M) probing them with
    their interval, the next watermark's prune; a fire's maxes appended to
    the maxes' lists (C = 3, maxprice float32), a batch of bids probing
    them, the prune that drops them all. Flags, failed rows, every key's
    whole list, the matches in order and the counts equal; each timed
    (the L2 flushed, the state put back before each launch) beside its
    plain version, with its byte bound, its 32-byte sector floor and that
    floor at the card's measured random rates (the prune's bound what its
    tile summary leaves it to move, the earlier design's beside it); the
    probe also with room for one match fewer than it finds, so that its
    launch runs again. (``tools/list_designs.py`` times the earlier
    kernels beside these.) Then the adversarial
    sequences (``LIST_EDGE_CASES``: a hot key past L, in-batch duplicates,
    ragged batches and keys, a horizon that drops everything, ts at the
    exact bounds, float and bool columns, lists out of ts order, lists of
    256 rows of 9 columns, one row, a probe's output room at M, one below
    it and 0, lists past the kernel's 32-row match mask) and a store on
    the card against one
    on the CPU through rehashes and a dead-key rebuild, snapshots equal
    field by field, and a pane of the 10M join replayed through kernels
    and plain versions at 2^25 slots (``check_list_sequence``), every
    prune's lists and summaries compared.
21. The Q7 join cells through ``env.execute()``: bench.py::
    bench_framework_q7_join (bids -> tumbling max per auction on the
    device window -> connect(bids) -> IntervalJoinOperator -> is-winner),
    8 panes of 10 000 ms, batches of 2^15, 32 rows a key, a watermark
    after every batch: ``q7_join_ref`` (100K auctions, 2^18 bids, window
    and stores at 2^18, host batches as in the reference) and
    ``q7_join_10m`` (10M auctions, 2^25 device-batch bids, window 2^24,
    stores 2^25 a side). A warm-up run of 2^16 bids, 2 timed runs (launch
    counters zeroed before each: every list kernel launched, the window's
    probe at least once a batch on device batches) and a profiled run; every run's
    winners (each bid whose price is its auction's pane maximum) against
    a numpy oracle as a multiset. Bids/s, peak memory, prunes and probes
    run and skipped, rebuilds, host seconds a batch by part, kernel builds after
    the warm-up, idle share and the profiled busy split.
22. The row plane (csrc/row_state.cu). In the kernel phase
    (``check_row_state``) dedup_first, row_set, row_get and row_unset
    against their plain versions at two shapes (``ROW_SHAPES``): the
    dedup cell's 17th batch of 2^19 rows into 2^24 slots holding its
    first 16 batches' keys, and 2^12 rows into 2^16 slots; fresh masks,
    status words and the state by key (presence, clock, value) equal,
    the batch map back to its resting state; each timed (the L2 flushed,
    the state put back before each launch) beside its plain version, with
    its byte bound, its 32-byte sector floor and that floor at the card's
    measured random rates (dedup_first and row_set also without the
    sectors of the earlier design's [capacity] scratch, which they no
    longer touch), and a row_set of one key (the ValueState path's shape)
    beside its plain version.
    Then the adversarial sequences (``ROW_EDGE_CASES``: a random mix, one
    key repeated, every row invalid, the EMPTY sentinel key, ts - last ==
    ttl, an int64-max clock, an overflow on a 16-slot table that must
    leave presence and clock as they were and a retry that admits the
    plain version's rows, last-write-wins, every value dtype, one key
    spread over a batch behind a warp of long probes, slots that collide
    in the batch map, a batch at the map's full load, a row_set of one
    key) and a backend on the card against one on the CPU
    (``check_row_backend``: keep-first batches that grow a 64-slot table,
    a TTL value plane; snapshots equal).
23. ``value_state``: a ValueState over the row plane on the card, 600
    updates, clears and reads of 300 keys against a dict, then TTL
    expiry (row_set, row_get and row_unset each launched).
24. ``dedup_10m``: datagen device batches of 2^19 -> key_by ->
    DeduplicateOperator(keep first, TTL 10 000 ms) -> sink through
    ``env.execute()``: 2^25 events over 10M keys (the MULT mixer) in
    ascending event time over 30 000 ms, one batch of UPDATE_BEFORE rows
    mid-run, the table growing by rehash from 2^16 to 2^24 slots; every
    emitted row against a numpy oracle of the reference's batch-granular
    rule (flink_tpu/sql/dedup.py:17-20), in order. A warm-up of 4
    batches, 2 timed runs (launch counters zeroed before each:
    dedup_first once a batch and once a retry), a profiled run, and a
    run checkpointed mid-run, cancelled and restored into a fresh job
    whose rows continue the first's with none lost or repeated. Events/s,
    peak memory, rehashes, retries, host seconds a batch by part, kernel
    builds after the warm-up, dedup_first's device ms and the idle share.
25. ``sql_join``: through ``execute_sql`` on datagen tables (2^16
    auctions, 2^14 persons; the host plane: the reference's join
    operators): a Nexmark Q3-shaped inner join (category = 10; q3.sql's
    string state filter cut), a LEFT JOIN under a GROUP BY over its
    changelog (the device GROUP BY retracting the padded rows) and a
    temporal join; each query's final rows against a dict oracle, rows/s.
26. ``datastream_core``: the DataStream core through ``env.execute()``,
    each job against its oracle: (a) BASELINE config #1, bench.py's
    WordCount (500 000 events, 5000 words as an object column, 8 tumbling
    event-time windows of 5000 ms, batch 2^15) on the hashmap backend and
    the host WindowOperator, every window against a Counter, events/s and
    the tasks' CPU seconds; (b) BASELINE config #2 on Q5-10M's device bid
    stream (2^25 events, batches of 2^19): Nexmark Q1 as a map whose
    map_batch computes 0.908 * price in float64 on the card, Q2 as a
    filter whose filter_batch masks auction % 123 == 0 and compacts the
    device batch on the card, each into a sink that counts and sums on
    the card (the count and integer sums exact, the float sum within
    1e-9 relative, the first batch exact, no batch copied home), then Q2
    -> key_by -> the Q5 sliding window -> device_aggregate(count, sum,
    emit_topk) with every window against the oracle under the tie rule
    (one ingest_step a batch), each job after a warm-up of 4 batches; (c)
    a KeyedProcessFunction on the device backend (2^12 bids over 2^11
    auctions across 40 000 ms, batch 2^12, a watermark a batch: a
    ValueState count an auction, an event-time timer 10 000 ms after its
    first bid that emits and clears it; a thirty-second of 2^17 bids over
    an eighth of 2^14 auctions for the time limit: every row is a Python
    call, three launches and about
    seven host transfers), every row against a dict,
    row_get, row_set and row_unset each launched, and a host profile of
    500 rows of the ValueState calls (``row_api_profile``); (d) CUMULATE
    (2 s step, 10 s size) through SQL on the host WindowOperator over the
    datagen DDL (2^14 rows, an eighth of 2^17 for the time limit, auction
    random over [0, 4095], ts the sequence number), every row against
    numpy.
    ``python3 chip_smoke.py --datastream`` builds the kernels and runs
    this phase alone. Then ``connectors`` (``--connectors`` alone).
27. ``patterns``, each part against an oracle written here: (a) the V
    shape of Flink's MATCH_RECOGNIZE documentation (SKIP PAST LAST ROW,
    WITHIN 10 s) over 2^15 ticks of 2^13 symbols, alone (every match
    against a per-symbol scan) and under a device GROUP BY (every group),
    with the documented forms the port refuses; (b) CEP on bench.py's
    bid stream (2^16 bids, 2^13 bidders, 30 s): a bid followed by a
    higher bid of the bidder within 10 s, SKIP_PAST_LAST_EVENT, its
    matches by auction through the card into Q5's window (W = 5, top
    100), then a checkpoint, a cancel and a restore, every window once;
    (c) the dynamic-rules broadcast pattern at parallelism 2 on the
    hashmap backend (2^14 bids, thresholds of 16 buckets changed three
    times), restored mid-run; (d) async enrichment of 2^16 of Q5's bids
    over 2^16 auctions (a thread-pool lookup of about 100 us, capacity 100),
    ordered with an injected timeout that retries, then unordered across
    a checkpoint taken with a hung request in flight and a restore, into
    Q5's window on the card; (e) the SQL gateway on loopback: (a)'s GROUP
    BY and Q17's aggregates over HTTP equal to a TableEnvironment's, a
    bad statement a 400. ``python3 chip_smoke.py --patterns`` builds
    the kernels and runs this phase alone.
28. ``runtime_io``, each part against an oracle written here: (a)
    Q5-10M's stream (10M keys, 2^24 slots, W = 5, ring 16, top 1000,
    device batches of 2^19, 2^25 events) from two sources (the even
    indices unpaced, the odd ones paced over 1.5 s) into one window task,
    unfused, with ``execution.checkpointing.unaligned``: the unpaced
    source holds the window task 0.1 s through its mailbox at its 2nd
    batch and triggers a checkpoint at its 12th, which captures its
    batches queued at the gate; the window task's barrier-to-ack seconds,
    the in-flight batches, rows and card bytes, the seconds they take to
    come home, against the same job aligned (run first: a process's first
    snapshot also allocates its pinned mirror); a cancel and a restore from
    the fs checkpoint, the captured batches replayed first, every window
    once against the oracle; (b) the same window fed by two sources of
    one alignment group (drift 4000 ms), one taking an index in 5 (its
    event time 4 times the other's a record): pauses, the largest
    overshoot (at most one of its batches' event time), the widest pane
    span the ring held, events/s, and with ``metrics.latency.interval``
    10 ms the markers the window and the sink saw and the sink's latency
    p50 and p99 beside p99 fire latency, then the same job without
    alignment; (c) datastream_core's keyed_process job (2^13 bids, 2^12
    auctions)
    with a queryable total a key on ``changelog`` and ``hashmap``,
    checkpoints every 200 ms: bytes written, materializations, segments;
    counts read over a ``KvStateServer`` while it runs (never going
    down); a cancel and a restore (base plus segments), the rows across
    it and the restored totals over TCP against the oracle; (d) the
    Collatz-style loop of tests/test_iterations.py at 2^14 seeds on host
    batches, each seed's steps against numpy. ``python3 chip_smoke.py
    --runtime-io`` builds the kernels and runs this phase alone.
29. ``faults_phase``: Q5-1M at its widths through ``env.execute()``,
    every window against the oracle: a seeded transient ``device.execute``
    schedule (retries), a persistent trip (one degrade to the CPU rung,
    its seconds), a poison trip on the first step (that batch
    quarantined, the oracle without it), a hang past a 1 s deadline (one
    watchdog trip, one retry); ``execute(recover=True)`` with checkpoints
    and a ``sink.invoke`` failure after the first (one restart from a
    checkpoint, no window twice, peak memory beside the same run without
    the fault); and the watchdog's cost at Q5-10M full (on and off in
    turns, two runs each: events/s, supervised calls, host µs a call).
    Every other phase must leave the fault counters at 0
    (``fault_counters_by_phase``).
30. ``mesh_phase``, the multi-device window path: ``exchange_bucket``
    (csrc/exchange.cu) against its plain version at the mesh cell's shape
    (4 source blocks of 2^17 rows of Q5-10M's 33rd batch to 4 shards) and
    on edge cases (every key to one shard, each block to its own shard,
    an empty block, EMPTY_KEY and negative keys, a base_range subset, 3
    shards, 256 shards at a small block, calls back to back on the same
    buffers and after a shape change): counts equal and every live row
    equal position by position; ``ingest_step``'s counted form against
    its plain version on shard 0's buffer at 2^23 slots; each timed with
    its bound (the exchange also at the mesh Q5-1M block of 4 x 2^12
    rows, beside the library sort its plain version runs, with its device
    operations a call by the profiler: one; the counted step also with its
    sector floor at the card's measured rates). Then the mesh cell:
    Q5-10M through ``mesh_aggregate(..., n_devices=4)`` on the one card
    (4 shards of 2^23 slots, ``device_batch`` 2^17), a warm-up a mode
    under the sync check,
    2 timed runs of each fire mode in turns (launches: one exchange a
    batch, one counted step a shard and batch, a seal or rebuild a shard
    and fire), every window against the oracle, and every fire timed on
    the card in a run on one thread; a mesh that must grow (4 shards of
    2^12 slots, 100K keys); the builtin route (``window(...).sum`` with
    ``state.backend.tpu.mesh-devices`` 4 at Q5-1M against the
    single-device operator's rows); ``live_rescale`` at Q5-1M, 4 -> 2 ->
    4 shards mid-run (every window once, no kernel built); and a mesh
    checkpoint restored into the single-device operator and the other way
    round. ``python3 chip_smoke.py --mesh`` builds the kernels and runs
    this phase alone.
31. The kernels line, the nvidia-smi line, then the last line
    {"ok": true, "device": {...}}.

``python3 chip_smoke.py --parent-kernels DIR`` instead times, with the same
method, the kernels that an older checkout at DIR also has (ingest_step
with no parts and in its dirty and spill forms, timed only, as the older
spill form stages in another order; the session kernels with their
checks, hist256, hash_probe, the group aggregation step and its stages
at both shapes, timed only, and the probe-plus-eager-folds step chain)
and prints one JSON line: the way to set a new kernel beside its
predecessor in one call.

Any failure raises and exits non-zero; without CUDA, or without the
package beside this script, it exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import importlib.util
import json
import linecache
import math
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
Q5_RUNS = 2                    # timed runs of Q5-10M and the runtime cell
#                                (4 before the connectors phase: cut for
#                                the time limit)
SHORT_RUNS = 2                 # timed runs of the Q5-1M and Q7 cells
WIDE_RUNS = 1                  # timed runs of the W = 20 cell
WIDE_PANES = 20                # bench.py --window-panes 20
#: (label, keys, events, capacity) of the two Q5 cells
Q5_CELLS = (("1M", 1_000_000, 1 << 23, 1 << 21),
            ("10M", 10_000_000, 1 << 25, 1 << 24))
STEP_PREFIX = 4                # batches in the table before a timed step
PRESENT_PREFIX = 32            # Q5-10M batches before one whose keys are all
#                                in the table (its 33rd)
SECTOR_SPAN = 1 << 14          # slots of an address-ordered span
#: the scattered accesses of the step, as tools/sector_rate.cu numbers them
SECTOR_OPS = ("read8", "probe8", "cas8", "red4", "red8", "store4", "store8")
FIRE_SLEEP_CYCLES = 40_000_000  # ~20 ms of device sleep before a timed fire
FIRE_TIMING_TRIES = 3          # timed-fire runs, the sleep doubled each
PROFILE_TRIES = 3              # profiles taken before a lost record fails
PROFILE_CHILD_TIMEOUT_S = 600  # a profile taken again in a fresh process
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
class ProfileRecordsLost(AssertionError):
    """Every one of PROFILE_TRIES profiles of a run lacked a kernel record
    that the launch counters hold."""


@contextlib.contextmanager
def card_profile(torch, host: bool = False):
    """``torch.profiler.profile`` of the card (and, with ``host``, of the
    host) around a block, the card drained before it starts and after
    the block, before it stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        yield prof
        torch.cuda.synchronize()


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


def check_hash_probe(torch, dev, flush, rates: dict | None = None) -> dict:
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
        # its sector floor: each distinct key's claimed sector, priced at
        # the card's measured random claim rate, the rows streamed
        cost = list_cost({"claim": distinct_sectors(torch, safe[ok] * 8)},
                         n * (8 + 4 + 1), nbytes, rates)
        shapes[cap] = {"n": n, "capacity": cap, "ms": ms,
                       "plain_ms": plain_ms, "library_ms": None,
                       "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                       **{k: cost[k] for k in ("sectors", "sector_floor_ms",
                                               "at_measured_rate_ms")
                          if k in cost}}
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


def q5_step_case(torch, dev, n_keys: int, n_events: int, cap: int,
                 prefix: int = STEP_PREFIX) -> dict:
    """Q5 state after ``prefix`` batches (built by the step chain, which
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
    for b in range(prefix):
        eager_step_chain(torch, table, count, rev, *batch(b), MIN_TIMESTAMP,
                         late, dropped)
    return {"table": table, "count": count, "rev": rev,
            "batch": batch(prefix)}


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
        # the bound, from this batch: new keys, present keys (their table
        # sector read) and (ring row, key) pairs
        table0 = case["table"]
        d_new = int((gtable != EMPTY_KEY).sum() - (table0 != EMPTY_KEY).sum())
        slot = lookup(gtable, sanitize_keys_device(keys)).to(torch.int64)
        d_present = int(torch.unique(slot).numel()) - d_new
        d_pk = int(torch.unique((ts // PANE_MS % RING) * cap + slot).numel())
        nbytes = (BATCH * (8 + 8 + 8) + d_new * (32 + 8) + d_present * 32
                  + d_pk * 2 * 2 * 32)
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
            "present_keys": d_present, "ring_key_pairs": d_pk,
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


def start_sector_build():
    """Starts nvcc on tools/sector_rate.cu with the package's flags, into
    its build directory, beside the package's own builds. Returns the
    library's path and the build under way (None: already built)."""
    from flink_tpu_torch.ops import kernels

    src = os.path.join(HERE, "tools", "sector_rate.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(kernels.NVCC_FLAGS).encode()).hexdigest()
    out = kernels.BUILD_DIR / f"libsector_rate-{digest[:12]}.so"
    if out.exists():
        return out, None
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    return out, (tmp, subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(tmp), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))


def sector_library(build):
    """The loaded library of a ``start_sector_build``, once built."""
    out, job = build
    if job is not None:
        tmp, proc = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on tools/sector_rate.cu:\n"
                               + log.decode(errors="replace"))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.sector_rate_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_void_p]
    lib.sector_rate_launch.restype = ctypes.c_int
    return lib


def sector_rates(torch, dev, flush, lib) -> dict:
    """The card's own rate for each scattered access of the step
    (SECTOR_OPS, tools/sector_rate.cu), a batch's 2^19 accesses at the
    Q5-10M cell's footprints: the 8-byte slots of a 2^24-slot table (128
    MB); the 4-byte and 8-byte cells of one ring row of [16, 2^24] planes
    (1 GB and 2 GB). Each op at the same addresses in three orders:
    random; bucketed into spans of SECTOR_SPAN slots taken in address
    order, random within a span (as a block would take a bucket); sorted.
    The rate is distinct 32-byte sectors touched per second, the L2
    flushed before each launch."""
    cap, row = 1 << 24, 5
    gen = torch.Generator(device=dev).manual_seed(8)
    slots = torch.randint(0, cap, (BATCH,), generator=gen, device=dev,
                          dtype=torch.int64)
    span = f"spans_of_2^{SECTOR_SPAN.bit_length() - 1}"
    orders = {"random": slots,
              span: slots[torch.sort(slots // SECTOR_SPAN,
                                     stable=True).indices],
              "sorted": torch.sort(slots).values}
    table = torch.empty(cap, dtype=torch.int64, device=dev)
    plane4 = torch.zeros((RING, cap), dtype=torch.int32, device=dev)
    plane8 = torch.zeros((RING, cap), dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    where = {"read8": (table, 0, 8), "probe8": (table, 0, 8),
             "cas8": (table, 0, 8), "red4": (plane4, row * cap, 4),
             "red8": (plane8, row * cap, 8), "store4": (plane4, row * cap, 4),
             "store8": (plane8, row * cap, 8)}
    out = {}
    for code, op in enumerate(SECTOR_OPS):
        base, offset, width = where[op]
        out[op] = {}
        for order, at in orders.items():
            idx = (at + offset).contiguous()

            def launch(idx=idx, base=base, code=code):
                rc = lib.sector_rate_launch(code, base.data_ptr(),
                                            idx.data_ptr(), idx.numel(),
                                            INT64_MAX, sink.data_ptr(),
                                            stream)
                if rc:
                    raise RuntimeError(f"sector_rate launch failed: {rc}")

            ms = cuda_ms(launch, torch, flush,
                         setup=lambda: table.fill_(INT64_MAX))
            sectors = int(torch.unique(idx * width // 32).numel())
            out[op][order] = {"ms": ms, "sectors": sectors,
                              "g_sectors_per_s": sectors / ms / 1e6}
        random = out[op]["random"]["g_sectors_per_s"]
        out[op]["sorted_over_random"] = (
            out[op]["sorted"]["g_sectors_per_s"] / random)
        out[op]["spans_over_random"] = (
            out[op][span]["g_sectors_per_s"] / random)
    del table, plane4, plane8
    return {"n": BATCH, "span_slots": SECTOR_SPAN, "ops": out}


def ingest_sectors(torch, table0, gtable, ts, skeys, folds, cap: int,
                   staged: int, rates: dict | None) -> dict:
    """The step's sector floor for this batch: every probing row's table
    sector read (a present key's too), a new key's table sector written
    back; per plane (int32 count, int64 revenue) each distinct (ring row,
    slot) sector read and written; the streamed columns (ts, key, price:
    24 B a row) and 20 B a staged row. The dirty bitmap stays in L2 and is
    not counted. With ``rates`` (``sector_rates``), that pattern at the
    card's measured random rates: present keys' table sectors at read8's,
    new keys' at probe8's, the count plane's at red4's, the revenue
    plane's at red8's, the streamed bytes at 3.35 TB/s, one after
    another."""
    from flink_tpu_torch.ops.hash_table import lookup

    slot = lookup(gtable, skeys).to(torch.int64)
    on = folds & (slot >= 0)
    s = slot[on]
    was = lookup(table0, skeys[on]) >= 0
    cell = (ts[on] // PANE_MS % RING) * cap + s
    table_read = sector_ids(torch, 0, s, 8)
    table_new = sector_ids(torch, 0, s[~was], 8)
    count_sec = sector_ids(torch, 1, cell, 4)
    rev_sec = sector_ids(torch, 2, cell, 8)
    n = sector_floor(torch, [table_read, count_sec, rev_sec],
                     [table_new, count_sec, rev_sec])
    streamed = BATCH * 24 + staged * 20
    out = {"sectors": n, "streamed_bytes": streamed,
           "sector_floor_ms": bound_ms(32 * n + streamed)}
    if rates is not None:
        def distinct(ids):
            return int(torch.unique(ids).numel())

        def per_ms(op):
            return rates["ops"][op]["random"]["g_sectors_per_s"] * 1e6

        out["at_measured_rate_ms"] = (
            distinct(sector_ids(torch, 0, s[was], 8)) / per_ms("read8")
            + distinct(table_new) / per_ms("probe8")
            + distinct(count_sec) / per_ms("red4")
            + distinct(rev_sec) / per_ms("red8") + bound_ms(streamed))
    return out


def check_ingest_forms(torch, dev, flush, rates: dict | None = None,
                       compare: bool = True) -> dict:
    """The two optional forms of ingest_step on the next Q5 batch, each
    against the plain version with the same parts: dirty marking (the form
    of every step of the main paths) at capacity 2^21 and 2^24, and at
    2^24 on Q5-10M's 33rd batch, whose keys are all in the table; and the
    spill split at the spill phase's capacity 2^23 with about half of the
    128 key groups spilled. Table key set, planes key by key, late and
    dropped equal; the marked blocks exactly the blocks the kernel's folds
    wrote; the staged rows equal position by position (batch order), the
    stage count and the touch clock equal. Times the form beside the step
    without parts in the same call; the bound adds the bytes of the parts
    to the step's, and the sector floor (``ingest_sectors``) counts the
    sectors the pattern touches. ``compare`` False: times the kernel only
    (an older checkout's, whose staging order differs)."""
    from flink_tpu_torch.core.keygroups import key_groups_device
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, StepSpill, \
        ingest_step, ingest_step_plain, lookup, sanitize_keys_device

    spilled = torch.from_numpy(
        np.random.default_rng(5).random(MAXP) < 0.5).to(dev)
    cases = [("dirty", label, k, e, c, STEP_PREFIX, "")
             for label, k, e, c in Q5_CELLS]
    cases.append(("dirty", "10M", Q5_CELLS[1][1], Q5_CELLS[1][2],
                  Q5_CELLS[1][3], PRESENT_PREFIX, "_present"))
    cases.append(("spill", "10M", Q5_CELLS[1][1], Q5_CELLS[1][2],
                  SPILL_BUDGET, STEP_PREFIX, ""))
    shapes, mismatches = {}, 0
    for form, label, n_keys, n_events, cap, prefix, tag in cases:
        case = q5_step_case(torch, dev, n_keys, n_events, cap, prefix)
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
                           ("plain", ingest_step_plain))[:2 if compare
                                                         else 1]:
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
        skeys = sanitize_keys_device(keys)
        folds = torch.ones_like(skeys, dtype=torch.bool)
        staged = int(gspill.count) if form == "spill" else 0
        if form == "spill":
            folds = ~spilled[key_groups_device(skeys, MAXP).to(torch.int64)]
        marked = torch.nonzero(gdirty[:nb]).flatten()
        if compare:
            wk, wc, wr, wl, wd, _wt, _wdirty, wspill = runs["plain"]
            same = gk.numel() == wk.numel()
            bad = {"key_set": int(not same) or int((gk != wk).sum()),
                   "count_plane": 0 if not same else int((gc != wc).sum()),
                   "revenue_plane": 0 if not same else int((gr != wr).sum()),
                   "late": abs(gl - wl), "dropped": abs(gd - wd)}
            if form == "spill":
                n = min(staged, BATCH)
                bad["stage_count"] = abs(staged - int(wspill.count))
                # position by position: both stage in batch order
                bad["stage_rows"] = sum(
                    int((g[:n] != w[:n]).sum())
                    for g, w in ((gspill.keys, wspill.keys),
                                 (gspill.ring, wspill.ring),
                                 (gspill.values[1], wspill.values[1])))
                bad["touch"] = int((gspill.touch != wspill.touch).sum())
                if staged == 0 or int((~folds).sum()) != staged:
                    bad["stage_count"] += 1
            written = torch.unique(
                lookup(gtable, skeys)[folds].to(torch.int64) >> DIRTY_SHIFT)
            bad["dirty_blocks"] = (int(written.numel() != marked.numel())
                                   or int((written != marked).sum()))
            if any(bad.values()):
                raise AssertionError(f"ingest_step {form} form at {label}"
                                     f"{tag}: entries differing from the "
                                     f"plain version: {bad}")
            mismatches += sum(bad.values())
        # the bound: the step's bytes for the rows that fold (a new key's
        # table sector read and its key written, a present key's table
        # sector read), plus the parts: one byte per marked block; a staged
        # row's 8 + 4 + 8 bytes; the clock's read and write
        table0 = case["table"]
        d_new = int((gtable != EMPTY_KEY).sum() - (table0 != EMPTY_KEY).sum())
        slot = lookup(gtable, skeys)[folds].to(torch.int64)
        d_present = int(torch.unique(slot).numel()) - d_new
        d_pk = int(torch.unique((ts[folds] // PANE_MS % RING) * cap
                                + slot).numel())
        nbytes = (BATCH * (8 + 8 + 8) + d_new * (32 + 8) + d_present * 32
                  + d_pk * 2 * 2 * 32 + marked.numel() + staged * 20
                  + (2 * MAXP * 8 if form == "spill" else 0))
        sectors = ingest_sectors(torch, table0, gtable, ts, skeys, folds,
                                 cap, staged, rates)
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
        entry = {
            "q5": label, "form": form, "n": BATCH, "capacity": cap,
            "batches_before": prefix, "new_keys": d_new,
            "present_keys": d_present, "ring_key_pairs": d_pk,
            "dirty_blocks": int(marked.numel()),
            "staged_rows": staged, "ms": ms,
            "ms_without_parts": cuda_ms(run(ingest_step, False), torch,
                                        flush, setup=reset),
            "library_ms": None, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "share_of_bound": bound_ms(nbytes) / ms,
            **sectors,
            "share_of_sector_floor": sectors["sector_floor_ms"] / ms}
        if "at_measured_rate_ms" in sectors:
            entry["share_of_measured_rate"] = (
                sectors["at_measured_rate_ms"] / ms)
        if compare:
            entry["plain_ms"] = cuda_ms(run(ingest_step_plain), torch, flush,
                                        reps=3, setup=reset)
        shapes[f"{form}_cap_2^{cap.bit_length() - 1}{tag}"] = entry
        del case, runs, table
    return {"max_abs_err": mismatches, "shapes": shapes}


# -- adversarial inputs of ingest_step ----------------------------------------
#: every row one key; every key's home slot in one bucket (1/64) of the
#: table; one row; rows that are not a multiple of a block; every row
#: late; a table with no free slot; cells past 2^31 (ring 129 x 2^24,
#: uint8 planes); every fold kind and dtype; the spill split with no group
#: spilled, every group, a stage that overflows, 1, 100 and 4096 key
#: groups, and a restored clock above the batch number. Each case runs
#: the dirty form, and the spill form where it has one: the spill cases
#: only that. Panes of EDGE_PANE ms from EDGE_OFFSET; panes below
#: EDGE_FIRST_OPEN are late (about a quarter of the rows).
INGEST_EDGE_CASES = ("hot_key", "one_bucket", "n_1", "n_ragged", "all_late",
                     "full_table", "cells_past_2^31", "kinds_dtypes",
                     "spill_none", "spill_all", "spill_overflow",
                     "spill_maxp_1", "spill_maxp_100", "spill_maxp_4096",
                     "spill_clock_ahead")
EDGE_PANE, EDGE_OFFSET, EDGE_FIRST_OPEN, EDGE_RING = 100, -37, -4, 4
EDGE_SHIFT = 3                 # 8-slot dirty blocks
EDGE_SPLIT_MAXP = 128


def _ingest_edge_batch(rng, pool, n: int, cols: dict,
                       late: bool = False) -> tuple:
    """(keys, ts, {column: values}): keys drawn from ``pool``, panes -7 to
    6 (every row late: -20 to -5), values small, so every sum is exact."""
    keys = pool[rng.integers(0, pool.size, n)].astype(np.int64)
    ts = (rng.integers(-2037, -537, n) if late
          else rng.integers(-700, 600, n)).astype(np.int64)
    vals = {}
    for name, dt in cols.items():
        v = rng.integers(-40, 40, n)
        if np.dtype(dt) == np.uint8:
            v = rng.integers(0, 256, n)
        elif np.dtype(dt) == np.bool_:
            v = rng.integers(0, 2, n)
        elif np.dtype(dt).kind == "f":
            v = v / 8.0
        vals[name] = v.astype(dt)
    return keys, ts, vals


def _edge_spill(rng, maxp: int, spilled=None, stage: int = 1 << 14,
                touch=None, batch_no: int = 1) -> dict:
    return {"maxp": maxp,
            "spilled": (rng.random(maxp) < 0.5 if spilled is None
                        else np.asarray(spilled, dtype=bool)),
            "touch": (np.zeros(maxp, np.int64) if touch is None
                      else np.asarray(touch, dtype=np.int64)),
            "stage": stage, "batch_no": batch_no}


def ingest_edge_configs(case: str) -> list:
    """The configurations of one adversarial case, from a seed: each a
    dict of capacity, ring, the prepared table (numpy), planes (kind,
    torch dtype name, column or None), value columns, batches, the forms
    to run ("dirty", "spill") and the spill split's parameters."""
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, \
        hash_keys_device, lookup_or_insert_plain, make_table

    rng = np.random.default_rng(sum(map(ord, case)))
    pool = rng.integers(-(10 ** 12), 10 ** 12, 700)
    pool[:2] = [EMPTY_KEY, EMPTY_KEY - 1]
    mixed = [("count", "int32", None), ("sum", "int64", "v"),
             ("min", "float32", "v"), ("max", "int64", "v")]
    base = {"cap": 1 << 12, "ring": EDGE_RING, "planes": mixed,
            "cols": {"v": np.int64}, "prefill": None,
            "forms": ("dirty", "spill"),
            "spill": _edge_spill(rng, EDGE_SPLIT_MAXP)}

    def cfg(n_batches=2, n=3001, late=False, pool=pool, **kw):
        c = {**base, **kw}
        c["batches"] = [_ingest_edge_batch(rng, pool, n, c["cols"], late)
                        for _ in range(n_batches)]
        return c

    if case == "hot_key":
        return [cfg(n=5001, pool=np.array([42], np.int64))]
    if case == "one_bucket":
        cap = 1 << 16
        cand = rng.integers(-(10 ** 15), 10 ** 15, 1 << 18)
        home = hash_keys_device(torch_cpu_tensor(cand)).numpy() & (cap - 1)
        keys = cand[(home >> 10) == 0][:300]
        return [cfg(n=4000, pool=keys, cap=cap)]
    if case == "n_1":
        return [cfg(n_batches=1, n=1)]
    if case == "n_ragged":
        return [cfg(n_batches=1, n=n) for n in (255, 257, 1000, 4097)]
    if case == "all_late":
        return [cfg(late=True)]
    if case == "full_table":
        cap = 1 << 10
        present = pool[2:302]
        table = make_table(cap, "cpu")
        lookup_or_insert_plain(table, torch_cpu_tensor(present))
        table = table.numpy()
        free = np.flatnonzero(table == EMPTY_KEY)
        table[free] = 10 ** 13 + np.arange(free.size)   # no batch key
        return [cfg(cap=cap, prefill=table,
                    spill=_edge_spill(rng, EDGE_SPLIT_MAXP,
                                      spilled=np.arange(EDGE_SPLIT_MAXP) % 4
                                      == 0))]
    if case == "cells_past_2^31":
        c = cfg(n_batches=1, n=4000, cap=1 << 24, ring=129,
                planes=[("count", "uint8", None), ("max", "uint8", "v")],
                cols={"v": np.uint8}, forms=("dirty",))
        keys, _ts, vals = c["batches"][0]
        panes = 128 + 129 * rng.integers(0, 3, keys.size)
        c["batches"] = [(keys, EDGE_OFFSET + panes * EDGE_PANE, vals)]
        return [c]
    if case == "kinds_dtypes":
        out = []
        for kind in ("sum", "min", "max"):
            for dt in ("int32", "int64", "float32", "float64", "uint8"):
                out.append(cfg(n_batches=1, n=2000,
                               planes=[("count", "int32", None),
                                       (kind, dt, "v"),
                                       ("sum", "float32", "v")],
                               cols={"v": np.dtype(dt).type}))
        out.append(cfg(n_batches=1, n=2000,
                       planes=[("count", "int64", None),
                               ("sum", "int64", "b")],
                       cols={"b": np.bool_}))
        return out
    spill_only = {"forms": ("spill",)}
    if case == "spill_none":
        return [cfg(**spill_only, spill=_edge_spill(
            rng, EDGE_SPLIT_MAXP, spilled=np.zeros(EDGE_SPLIT_MAXP)))]
    if case == "spill_all":
        return [cfg(**spill_only, spill=_edge_spill(
            rng, EDGE_SPLIT_MAXP, spilled=np.ones(EDGE_SPLIT_MAXP)))]
    if case == "spill_overflow":
        # the first batch overflows the stage; the second finds it full
        return [cfg(**spill_only, spill=_edge_spill(rng, EDGE_SPLIT_MAXP,
                                                    stage=700))]
    if case.startswith("spill_maxp_"):
        maxp = int(case.rsplit("_", 1)[1])
        return [cfg(**spill_only, spill=_edge_spill(rng, maxp))]
    if case == "spill_clock_ahead":
        touch = np.where(np.arange(EDGE_SPLIT_MAXP) % 3 == 0, 9, 0)
        return [cfg(**spill_only, spill=_edge_spill(
            rng, EDGE_SPLIT_MAXP, touch=touch, batch_no=4))]
    raise ValueError(case)


def torch_cpu_tensor(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def run_ingest_edge(torch, dev, c: dict, form: str, step) -> dict:
    """One configuration through ``step`` (ingest_step or its plain
    version) in one form, from fresh state; the state after it."""
    from flink_tpu_torch.ops.hash_table import StepSpill, make_table
    from flink_tpu_torch.ops.segment_ops import make_accumulator

    cap, ring = c["cap"], c["ring"]
    table = (make_table(cap, dev) if c["prefill"] is None
             else torch_cpu_tensor(c["prefill"]).to(dev))
    planes = [(kind, make_accumulator(kind, (ring, cap), getattr(torch, dt),
                                      dev), col)
              for kind, dt, col in c["planes"]]
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    dirty = torch.zeros((cap >> EDGE_SHIFT) + 1, dtype=torch.uint8,
                        device=dev)
    spill = None
    if form == "spill":
        sp = c["spill"]
        S = sp["stage"]
        spill = StepSpill(
            torch_cpu_tensor(sp["spilled"]).to(dev),
            torch_cpu_tensor(sp["touch"]).to(dev), sp["batch_no"],
            torch.zeros((), dtype=torch.int64, device=dev),
            torch.zeros(S, dtype=torch.int64, device=dev),
            torch.zeros(S, dtype=torch.int32, device=dev),
            [None if col is None else
             torch.zeros(S, dtype=getattr(torch, dt), device=dev)
             for _kind, dt, col in c["planes"]])
    for b, (keys, ts, vals) in enumerate(c["batches"]):
        if spill is not None:
            spill.batch_no = c["spill"]["batch_no"] + b
        cols = {k: torch_cpu_tensor(v).to(dev) for k, v in vals.items()}
        step(table, [(kind, arr, None if col is None else cols[col])
                     for kind, arr, col in planes],
             torch_cpu_tensor(ts).to(dev), torch_cpu_tensor(keys).to(dev),
             EDGE_PANE, EDGE_OFFSET, EDGE_FIRST_OPEN, late, dropped, dirty,
             EDGE_SHIFT, spill)
    return {"table": table, "planes": [arr for _k, arr, _c in planes],
            "late": int(late), "dropped": int(dropped), "dirty": dirty,
            "spill": spill}


def edge_folded_blocks(torch, c: dict, form: str, table):
    """The dirty blocks a run must have marked: the blocks of the slots,
    in its final table, of every fresh row that probes (not of a spilled
    group) and whose key is there."""
    from flink_tpu_torch.core.keygroups import key_groups_device
    from flink_tpu_torch.ops.hash_table import lookup, sanitize_keys_device

    blocks = []
    for keys, ts, _vals in c["batches"]:
        k = sanitize_keys_device(torch_cpu_tensor(keys).to(table.device))
        t = torch_cpu_tensor(ts).to(table.device)
        on = torch.div(t - EDGE_OFFSET, EDGE_PANE,
                       rounding_mode="floor") >= EDGE_FIRST_OPEN
        if form == "spill":
            sp = torch_cpu_tensor(c["spill"]["spilled"]).to(table.device)
            on &= ~sp[key_groups_device(k, c["spill"]["maxp"]).long()]
        slot = lookup(table, k).to(torch.int64)
        blocks.append(slot[on & (slot >= 0)] >> EDGE_SHIFT)
    return torch.unique(torch.cat(blocks))


def check_ingest_edge(torch, dev, case: str) -> dict:
    """Every configuration of ``case`` through the kernel and the plain
    version in each of its forms: the table's key set, every plane key by
    key (the slot layouts differ), late and dropped equal; each run's
    dirty blocks exactly those of its folds; the staged rows equal
    position by position (both stage in batch order), the stage count and
    the touch clock equal. Returns per form the counts seen."""
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, ingest_step, \
        ingest_step_plain

    def by_key(st):
        table = st["table"]
        occupied = torch.nonzero(table != EMPTY_KEY).flatten()
        keys, order = torch.sort(table[occupied])
        return keys, [p[:, occupied[order]] for p in st["planes"]]

    seen = {}
    for i, c in enumerate(ingest_edge_configs(case)):
        for form in c["forms"]:
            got = run_ingest_edge(torch, dev, c, form, ingest_step)
            want = run_ingest_edge(torch, dev, c, form, ingest_step_plain)
            what = f"ingest_step {case}[{i}] {form} form"
            gk, gp = by_key(got)
            wk, wp = by_key(want)
            if not torch.equal(gk, wk):
                only_got = gk[~torch.isin(gk, wk)]
                only_want = wk[~torch.isin(wk, gk)]
                raise AssertionError(
                    f"{what}: key sets differ: {gk.numel()} keys against "
                    f"{wk.numel()}; only the kernel's "
                    f"{only_got[:5].tolist()}, only the plain version's "
                    f"{only_want[:5].tolist()}")
            for q, (g, w) in enumerate(zip(gp, wp)):
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise AssertionError(f"{what}: plane {q} differs key "
                                         "by key")
            if (got["late"], got["dropped"]) != (want["late"],
                                                 want["dropped"]):
                raise AssertionError(
                    f"{what}: late, dropped {got['late'], got['dropped']} "
                    f"against {want['late'], want['dropped']}")
            for st, name in ((got, "kernel"), (want, "plain")):
                blocks = edge_folded_blocks(torch, c, form, st["table"])
                marked = torch.nonzero(
                    st["dirty"][:c["cap"] >> EDGE_SHIFT]).flatten()
                if not torch.equal(blocks, marked):
                    raise AssertionError(f"{what}: the {name}'s dirty "
                                         "blocks are not its folds' blocks")
            staged = 0
            if form == "spill":
                gs, ws = got["spill"], want["spill"]
                staged = int(gs.count)
                if staged != int(ws.count):
                    raise AssertionError(f"{what}: stage count {staged} "
                                         f"against {int(ws.count)}")
                n = min(staged, gs.keys.numel())
                pairs = [(gs.keys, ws.keys), (gs.ring, ws.ring)] + [
                    (g, w) for g, w in zip(gs.values, ws.values)
                    if g is not None]
                for g, w in pairs:
                    if not torch.equal(g[:n], w[:n]):
                        raise AssertionError(f"{what}: staged rows differ "
                                             "in batch order")
                if not torch.equal(gs.touch, ws.touch):
                    raise AssertionError(f"{what}: touch clocks differ")
            rows = sum(k.size for k, _t, _v in c["batches"])
            entry = seen.setdefault(form, {"rows": 0, "late": 0,
                                           "dropped": 0, "staged": 0,
                                           "keys": 0})
            entry["rows"] += rows
            entry["late"] += got["late"]
            entry["dropped"] += got["dropped"]
            entry["staged"] += staged
            entry["keys"] += int(gk.numel())
            del got, want
    return seen


def ingest_edges(torch, dev) -> dict:
    """Every adversarial case of ingest_step on the card."""
    return {case: check_ingest_edge(torch, dev, case)
            for case in INGEST_EDGE_CASES}


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


def window_library_ms(torch, flush, planes, rows: list, leaves: list,
                      sub_row: int) -> dict:
    """The library call beside the window kernels: one ``torch.sum`` over
    dim 0 of the W ring rows of a plane (a slice of the ring, no gather),
    which gives an invertible plane's window value, the view the rebuild
    and the seal write (they also write the state the next seal starts
    from, the view less the retiring row); first held equal to the view a
    plain rebuild of the window's own live rows writes. A plane that
    keeps a merge tree (max) has no such call: ``torch.amax`` gives its
    view, not the tree the kernels keep, so ``library_ms`` is None."""
    from flink_tpu_torch.ops.window_seal import rebuild_plain

    if any(kind not in ("sum", "count") for kind, *_ in planes):
        return {"library_ms": None,
                "library_call": "none: torch.amax gives the view, not the "
                                "merge tree the kernels keep"}
    rebuild_plain(planes, rows, leaves, sub_row, True)
    idx = torch.tensor(rows, device=planes[0][1].device)
    for _kind, pane, _state, view in planes:
        if not torch.equal(torch.sum(pane.index_select(0, idx), 0)
                           .to(view.dtype), view):
            raise AssertionError("torch.sum over the live rows differs from "
                                 "the window's view")
    W = len(rows)
    return {"library_ms": sum(
        cuda_ms(lambda p=pane: torch.sum(p[:W], 0), torch, flush)
        for _kind, pane, _state, _view in planes),
        "library_call": f"torch.sum(pane[:{W}], 0), one a plane"}


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
            library = window_library_ms(torch, flush, plain, rows, leaves,
                                        sub_row)
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
                "bound_by": "bytes", **library}
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

    for tries in range(1, PROFILE_TRIES + 1):
        with card_profile(torch) as prof:
            fn()
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
    """The kernels an older checkout shares with this one, timed alike
    (its ingest_step's forms timed only: its stage fills in another
    order)."""
    return {"ingest_step": check_ingest(torch, dev, flush),
            "ingest_step_forms": check_ingest_forms(torch, dev, flush,
                                                    compare=False),
            "session": check_session(torch, dev, flush, edges=False),
            "group_agg": check_group_agg(torch, dev, flush, compare=False,
                                         edges=False),
            "hist256": check_hist256(torch, dev, flush),
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


def mixed_keys(idx, n_keys: int):
    """bench.py's key mixer (idx * MULT) % n_keys in uint64, on int64 torch
    indices. Torch has no uint64 remainder, so it is computed from int64
    ops: the product wraps mod 2^64 alike (MULT as the signed int64 of the
    same 64 bits), then x % n = ((x >>> 1) % n * 2 + (x & 1)) % n, where
    x >>> 1 is the logical shift (x >> 1) & INT64_MAX."""
    x = idx * (MULT - (1 << 64))
    return (((x >> 1) & INT64_MAX) % n_keys * 2 + (x & 1)) % n_keys


def q5_gen(n_keys: int, n_events: int, span: int):
    """bench.py's Q5 generator on int64 torch indices: the auction key by
    ``mixed_keys``, price idx % 997 + 1, ts idx * span // n_events."""
    def gen(idx):
        return {"auction": mixed_keys(idx, n_keys), "price": idx % 997 + 1,
                "ts": (idx * span) // n_events}

    return gen


def q5_env(torch, dev, n_keys: int, n_events: int, capacity: int,
           batch: int = BATCH, topk: int = TOPK, defer: bool = True,
           fire_mode: str = "full", window_panes: int = WINDOW_PANES,
           fused: bool = False, wm_interval: float = 0.0,
           settings: dict | None = None, rate: float | None = None,
           staging: int = 1 << 16, source_hook=None, gen=None, sink=None,
           stage=None, source=None, watermarks=None,
           window_bounds: bool = False):
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
    ``DataGenSource``; ``gen(n_keys, n_events, span)`` makes the
    generator in place of ``q5_gen`` (the same price and ts, other
    keys); ``sink``: a port ``Sink`` in place of the one that fills
    ``got``; ``stage(stream) -> stream``: steps between the source and
    the keyed exchange (a filter); ``source``: a port ``Source`` of the
    same schema in place of the ``DataGenSource`` (a file or a log), with
    ``watermarks`` in place of monotonous ones on ``ts``;
    ``window_bounds``: the rows carry window_start and window_end."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import SlidingEventTimeWindows

    span = q5_panes(n_events, batch, window_panes) * PANE_MS
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    got = []

    def collect(b):
        got.append((int(b.timestamps[0]), b.column("auction"),
                    b.column("bids"), b.column("revenue")))

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": batch,
                       "window.fire.incremental": fire_mode == "incremental",
                       "pipeline.fusion.enabled": fused,
                       "pipeline.auto-watermark-interval": wm_interval,
                       **(settings or {})}), device=dev)
    ws = (watermarks or WatermarkStrategy.for_monotonous_timestamps()) \
        .with_timestamp_column("ts")
    name = "DataGen" if source is None else type(source).__name__
    if source is None:
        source = DataGenSource((gen or q5_gen)(n_keys, n_events, span),
                               schema, count=n_events, rate_per_sec=rate,
                               timestamp_column="ts", device=True)
    if source_hook is not None:
        source_hook(source)
    stream = env.from_source(source, ws, name)
    if stage is not None:
        stream = stage(stream)
    (stream
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(window_panes * PANE_MS, PANE_MS))
        .device_aggregate([AggSpec("count", out_name="bids", value_bits=31),
                           AggSpec("sum", "price", out_name="revenue")],
                          capacity=capacity,
                          ring_size=ring_for(window_panes),
                          emit_window_bounds=window_bounds, emit_topk=topk,
                          defer_overflow=defer, async_fire=True,
                          spill_staging_slots=staging)
        .add_sink(collect if sink is None else sink))
    return env, got, span


def run_q5(torch, dev, n_keys: int, n_events: int, capacity: int, **kw):
    """One run of the Q5 pipeline through ``env.execute()`` on the
    runtime (keywords: ``q5_env``'s); returns (the finished job, [(window
    end - 1, auctions, bids, revenue)], span ms)."""
    env, got, span = q5_env(torch, dev, n_keys, n_events, capacity, **kw)
    job = env.execute("nexmark-q5")
    return job, got, span


#: q5_expected's oracles of bench.py's own keys (no ``keys``, ``skip`` or
#: ``keep``) by (n_keys, n_events, span, topk, window_panes): the phases
#: check the same configuration many times, and one Q5-10M oracle takes
#: tens of seconds of numpy (a partition of the 10M counts a window)
_Q5_EXPECTED: dict = {}


def q5_expected(n_keys: int, n_events: int, span: int, topk: int = TOPK,
                window_panes: int = WINDOW_PANES, keys=None,
                skip: tuple | None = None, keep=None) -> list:
    """The numpy oracle of every Q5 window, once per configuration:
    [(end pane, top values, candidates, their bids and revenue, keys
    strictly above the k-th value)], where the candidates are the keys at
    or above the k-th value. Each window's sums slide: its newest pane is
    added and the pane that left it subtracted, one bincount each.
    ``keys``: each event's key, in place of ``q5_gen``'s; ``skip``: the
    event indices [lo, hi) left out (a quarantined batch); ``keep``: a
    bool mask of the events a filter lets through. The result is shared:
    callers read it and change nothing."""
    plain = keys is None and skip is None and keep is None
    memo = (n_keys, n_events, span, topk, window_panes)
    if plain and memo in _Q5_EXPECTED:
        return _Q5_EXPECTED[memo]
    idx = np.arange(n_events, dtype=np.int64)
    if keys is None:
        keys = ((idx.astype(np.uint64) * np.uint64(MULT))
                % np.uint64(n_keys)).astype(np.int64)
    price = idx % 997 + 1
    panes = (idx * span) // n_events // PANE_MS
    n_p = int(panes[-1]) + 1
    bounds = np.searchsorted(panes, np.arange(n_p + 1))
    kept = np.ones(n_events, np.int64)
    if skip is not None:
        kept[skip[0]:skip[1]] = 0
    if keep is not None:
        kept *= keep

    def pane_sums(p):
        a, b = bounds[p], bounds[p + 1]
        return (np.bincount(keys[a:b], weights=kept[a:b],
                            minlength=n_keys).astype(np.int64),
                np.bincount(keys[a:b], weights=price[a:b] * kept[a:b],
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
    if plain:
        _Q5_EXPECTED[memo] = out
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
                  ("window_rebuild", "window_kernel<false>"),
                  ("session_step", "session_step_kernel"),
                  ("session_fire", "session_fire_kernel"))


def run_profile(torch, run) -> dict:
    """One more run under torch.profiler: the card's busy time by kernel
    (CUPTI records every kernel in the process, the ones this package
    launches through ctypes too) against the run's wall time, and the
    profiler's count of each hand kernel, which must equal its launch
    counter (a profile that lost a kernel would understate busy time)."""
    from torch.autograd import DeviceType

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    for tries in range(1, PROFILE_TRIES + 1):
        reset_launches()
        with card_profile(torch, host=True) as prof:
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
            "kernel_ms": {kernel: sum(ms for name, (ms, _n) in by_name.items()
                                      if symbol in name)
                          for kernel, symbol in KERNEL_SYMBOLS},
            "top": [{"name": k, "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def fire_device_ms(torch, run, op_cls=None) -> dict:
    """Runs ``run()`` with every window fire timed on the card alone: the
    card is drained and put to sleep for about 20 ms, the fire is enqueued
    between two CUDA events (seal or merge, emit mask, select, gathers,
    the copy home, the retirement of the oldest pane) while the card
    sleeps, so the events time the fire's device work back to back,
    without the host's launch gaps. The garbage collector is paused while
    a fire is enqueued. A fire whose start event the card reached before
    the host had enqueued the fire would include such gaps: the whole run
    is then discarded and made again with twice the sleep, and the phase
    fails if every one of ``FIRE_TIMING_TRIES`` runs had such a fire."""
    from flink_tpu_torch.runtime.operators.device_window import \
        DeviceWindowAggOperator

    Op = op_cls or DeviceWindowAggOperator
    fire = Op._fire
    overtaken_runs = []
    for tries in range(1, FIRE_TIMING_TRIES + 1):
        sleep_cycles = FIRE_SLEEP_CYCLES << (tries - 1)
        per_fire, host_ms, overtaken = [], [], []

        def timed(self, p_end, sleep_cycles=sleep_cycles, per_fire=per_fire,
                  host_ms=host_ms, overtaken=overtaken):
            torch.cuda.synchronize()
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                torch.cuda._sleep(sleep_cycles)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                fire(self, p_end)
                end.record()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                overtaken.append(start.query())
            finally:
                if gc_was_on:
                    gc.enable()
            end.synchronize()
            per_fire.append(start.elapsed_time(end))

        Op._fire = timed
        try:
            run()
        finally:
            Op._fire = fire
        if not any(overtaken):
            break
        overtaken_runs.append({"sleep_cycles": sleep_cycles,
                               "overtaken": sum(overtaken),
                               "host_enqueue_max_ms": max(host_ms)})
    else:
        raise AssertionError(f"every one of {FIRE_TIMING_TRIES} runs had "
                             "fires that the card reached before the host "
                             f"had enqueued them: {overtaken_runs}")
    return {"fires": len(per_fire),
            "median_ms": float(np.median(per_fire)),
            "mean_ms": float(np.mean(per_fire)),
            "first_ms": per_fire[0], "max_ms": max(per_fire),
            "host_enqueue_median_ms": float(np.median(host_ms)),
            "host_enqueue_max_ms": max(host_ms),
            "runs_taken": tries, "discarded_runs": overtaken_runs}


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
    with card_profile(torch, host=True) as prof:
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
    whole = [None]   # the digest of the last whole-copy snapshot

    def feed(k: int) -> None:
        for _ in range(k):
            batch = reader.read_batch(BATCH)
            last[0] = batch
            h.process_batch(batch)

    def snap(label: str, unchanged: bool = False) -> None:
        """``unchanged``: nothing reached the state since the last
        snapshot, so its whole copy (15 to 20 s at Q5-10M) stands."""
        cid = len(records) + 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = op.snapshot_state(cid)["keyed"]["backend"]
        took = time.perf_counter() - t0
        log = dict(backend.snapshot_log[-1])
        plain_s = None
        if not unchanged:
            t1 = time.perf_counter()
            whole[0] = snapshot_digest(backend.snapshot_plain(cid))
            plain_s = time.perf_counter() - t1
        if snapshot_digest(got) != whole[0]:
            raise AssertionError(f"mirror snapshot '{label}' differs from "
                                 "the whole-copy snapshot")
        records.append({"snapshot": label, "seconds": took, **log,
                        "whole_copy_s": plain_s})

    feed(16)
    snap("full_capture")
    feed(8)
    snap("delta_under_load")
    snap("idle", unchanged=True)
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


def wait_checkpoints(job, n: int, after: float = 0.0,
                     timeout: float = 300.0, holds=None) -> None:
    """Until ``n`` checkpoints of ``job`` triggered after the wall time
    ``after`` completed (or the job ended or failed); with ``holds``, until
    the last of them also has a snapshot log record for which
    ``holds(record)`` is true."""
    def done() -> bool:
        stats = [s for s in job.coordinator.stats
                 if s.get("started", 0.0) > after and not s.get("failed")]
        if len(stats) < n or holds is None:
            return len(stats) >= n
        log = {r["checkpoint_id"]: r
               for r in job.operators[0].backend.snapshot_log}
        return holds(log.get(stats[-1]["id"], {}))

    t0 = time.perf_counter()
    while (not done() and not job._done.is_set()
           and time.perf_counter() - t0 < timeout):
        time.sleep(0.002)
    if not done():
        raise AssertionError(f"{len(job.coordinator.stats)} checkpoints "
                             f"completed, waiting for {n} after {after}: "
                             f"{job._failed}")


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
    and the run's spill and tier record. Then across budgets: a paced
    unbudgeted job checkpointed into a directory, cancelled, and restored
    into a budgeted job, which holds host-tier keys during its run; every
    window of both jobs equals the oracle (a window may repeat, with equal
    values), and the checkpoint restored into a budgeted operator
    snapshots byte for byte as it came. The other way, a budgeted
    checkpoint holding host-tier keys restored unbudgeted, is
    ``tiering_phase``'s checkpoint after a promotion."""
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
    record = {**spill_record(job, n_events, peak),
              **tier_record(torch, job.operators[0].backend),
              "hash_probe_launches": launches["hash_probe"]}
    emit({"spill_run": f"Q5-{label}", **record})
    if (launches["ingest_step_spill"] != n_events // BATCH
            or record["dropped"] or not record["groups_spilled"]):
        raise AssertionError(f"spill run: launches {launches}, record "
                             f"{record}")
    del job, got
    expected = q5_expected(n_keys, n_events, span)
    by_end = {e[0]: e for e in expected}
    crossings = {}
    name = "unbudgeted_to_budgeted"
    ckpt_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_spill_")
    try:
        env, got1, _span = q5_env(
            torch, dev, n_keys, n_events, cap, staging=SPILL_STAGING,
            rate=n_events / (2 * CKPT_RUN_S),
            settings={"execution.checkpointing.interval": CKPT_INTERVAL_S,
                      "execution.checkpointing.dir": ckpt_dir})
        fresh_memory(torch)
        job = env.execute_async(f"q5-{name}")
        wait_checkpoints(job, 1)
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
            hbm_budget_slots=SPILL_BUDGET)
        op.initialize_state([window["keyed"]], None)
        twin = op.backend.snapshot(cp.checkpoint_id)
        if snapshot_digest(twin) != snapshot_digest(
                window["keyed"]["backend"]):
            raise AssertionError(f"{name}: the checkpoint restored "
                                 "under the other budget snapshots "
                                 "differently")
        twin_spilled = op.backend.spill_active
        op.backend.prefetch_pipeline.close()
        del op, _h, twin, loaded, chain, window
        env2, got2, _span = q5_env(torch, dev, n_keys, n_events, cap,
                                   staging=SPILL_STAGING, settings=budget)
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
    if not crossings["unbudgeted_to_budgeted"]["restored_run"][
            "groups_spilled"]:
        raise AssertionError("the crossing did not hold spilled state on "
                             f"the budgeted side: {crossings}")
    return {"spill": f"Q5-{label}", "hbm_budget_slots": SPILL_BUDGET,
            "staging_slots": SPILL_STAGING, "windows_checked": windows,
            "ingest_step_spill_launches": launches["ingest_step_spill"],
            **record, "across_budgets": crossings}


# -- tiered residency: the 2Q heat policy, promotion and the prefetch ------
#: the hot-set shift (``shift_keys``): the seed of its key-group sets (C,
#: cold then hot again; R, kept hot; X, the rest), the groups in C and in
#: R, the share of R's keys drawn before the shift, and the events
#: (shares of the run) where the phases change
SHIFT_SEED = 16
SHIFT_GROUPS = 32
SHIFT_EARLY = 0.25
SHIFT_PHASES = (1 / 8, 5 / 8)
SHIFT_CKPT_INTERVAL_S = 2.0    # the checkpointed shift run's interval
#: the shift's runs, (label, deferred step), both with
#: ``state.tiering.async-prefetch`` true: the deferred step stages inline
#: (its drains race a payload staged off the thread), host batches stage
#: on the prefetch thread and its own stream
SHIFT_RUNS = (("deferred", True), ("host_batch_async", False))


def shift_pools(n_keys: int, seed: int = SHIFT_SEED) -> tuple:
    """The keys 0..n_keys-1 in four pools laid end to end in one
    permutation: X's keys, R's early keys, C's keys, R's late keys (C and
    R each SHIFT_GROUPS key groups, seeded and disjoint; X the others).
    Returns (the permutation, the pool sizes, C as a [MAXP] mask)."""
    from flink_tpu_torch.core.keygroups import hash_batch, \
        key_groups_for_hash_batch

    groups = key_groups_for_hash_batch(
        hash_batch(np.arange(n_keys, dtype=np.int64)), MAXP)
    pick = np.random.default_rng(seed).permutation(MAXP)
    c_set = np.zeros(MAXP, bool)
    c_set[pick[:SHIFT_GROUPS]] = True
    r_set = np.zeros(MAXP, bool)
    r_set[pick[SHIFT_GROUPS:2 * SHIFT_GROUPS]] = True
    x = np.flatnonzero(~(c_set | r_set)[groups])
    r = np.flatnonzero(r_set[groups])
    early = int(SHIFT_EARLY * len(r))
    c = np.flatnonzero(c_set[groups])
    perm = np.concatenate([x, r[:early], c, r[early:]]).astype(np.int64)
    return perm, (len(x), early, len(c), len(r) - early), c_set


def shift_pool_index(m, idx, batch: int, e0: int, e1: int, sizes: tuple):
    """Each event's position in ``shift_pools``' permutation, from the
    MULT mixer's key m (numpy or torch). Until event e0, X, R's early keys
    and C: every group is touched. Until e1, C is touched no more: X and
    R's early keys in even batches, R's early keys alone in odd ones, so
    R's groups gain heat twice as fast as X's and, as X's keys fill the
    table past the budget, evictions drive C to the host first, then X's
    groups. After e1, C and R's late keys: C turns hot on the host, while
    the late keys are new to R's groups on the card, so the table grows,
    evictions of X's cooling groups make room, and C's groups, hotter than
    X's on the host after a few boundaries, are promoted."""
    x, re_, c, rl = sizes
    odd = (idx // batch) % 2 == 1
    p1 = odd * (x + m % re_) + ~odd * (m % (x + re_))
    return ((idx < e0) * (m % (x + re_ + c))
            + ((idx >= e0) & (idx < e1)) * p1
            + (idx >= e1) * (x + re_ + m % (c + rl)))


def shift_keys(n_keys: int, n_events: int, batch: int = BATCH
               ) -> np.ndarray:
    """Every event's key in the hot-set shift, in numpy (the oracle's)."""
    perm, sizes, _c = shift_pools(n_keys)
    idx = np.arange(n_events, dtype=np.int64)
    m = ((idx.astype(np.uint64) * np.uint64(MULT))
         % np.uint64(n_keys)).astype(np.int64)
    e0, e1 = (int(f * n_events) for f in SHIFT_PHASES)
    return perm[shift_pool_index(m, idx, batch, e0, e1, sizes)]


def shift_gen_factory(torch, dev, batch: int = BATCH):
    """``q5_env``'s ``gen`` for the hot-set shift: ``shift_keys`` on int64
    indices on the card, the permutation uploaded once."""
    def make(n_keys: int, n_events: int, span: int):
        perm, sizes, _c = shift_pools(n_keys)
        perm = torch.from_numpy(perm).to(dev)
        e0, e1 = (int(f * n_events) for f in SHIFT_PHASES)
        q5 = q5_gen(n_keys, n_events, span)

        def gen(idx):
            cols = q5(idx)
            cols["auction"] = perm[shift_pool_index(
                cols["auction"], idx, batch, e0, e1, sizes)]
            return cols

        return gen

    return make


def tier_record(torch, b) -> dict:
    """A budgeted backend's tiering: groups and keys demoted (those a
    forced spill took beyond its own apart: none, as the rebuilds the
    card's probe cannot place take the home-slot layout, counted in
    ``ordered_rebuilds``) and promoted, promotions
    applied and refused, boundaries, the hit ratio
    per boundary, seconds of tier_boundary on the task's thread and of
    staging (off it when staging is asynchronous) and apply_promotion's
    device ms between CUDA events."""
    r = b.residency
    if b.device.type == "cuda":
        torch.cuda.synchronize()
    series = r.hit_ratio_series()
    return {"groups_demoted": r.evicted_groups,
            "groups_demoted_by_forced_fallback": b.evictions[
                "forced_fallback"],
            "ordered_rebuilds": b.evictions["ordered_rebuilds"],
            "groups_promoted": r.promoted_groups,
            "keys_promoted": b.host_tier.promoted_keys if b.host_tier else 0,
            "promotions": dict(b.promotions), "boundaries": r.boundaries,
            "hit_ratio_last": series[-1] if series else None,
            "hit_ratio_series_len": len(series), "hit_ratio_series": series,
            "tier_boundary_s": b.tier_s["boundary"],
            "staging_s": b.tier_s["stage"], "apply_s": b.tier_s["apply"],
            "apply_promotion_device_ms": sum(
                s.elapsed_time(e) for s, e in b.promotion_events)}


def rows_equal_under_tie_rule(a: list, b: list) -> int:
    """Two Q5 runs' windows: the same ends, values and revenue, the keys
    strictly above each window's k-th value equal with their values;
    returns the windows whose rows are equal outright too."""
    if [r[0] for r in a] != [r[0] for r in b]:
        raise AssertionError("the runs fired different windows")
    same = 0
    for (ts, ka, ba, ra), (_t, kb, bb, rb) in zip(a, b):
        if not np.array_equal(ba, bb) or len(ka) != len(kb):
            raise AssertionError(f"window {ts}: counts differ")
        kth = ba[-1] if len(ba) else 0
        sa = {(int(k), int(c), int(v)) for k, c, v in zip(ka, ba, ra)
              if c > kth}
        sb = {(int(k), int(c), int(v)) for k, c, v in zip(kb, bb, rb)
              if c > kth}
        if sa != sb:
            raise AssertionError(f"window {ts}: keys above the k-th value "
                                 "differ")
        same += bool(np.array_equal(ka, kb) and np.array_equal(ra, rb))
    return same


def tiering_phase(torch, dev, spill: dict, keys: int = 10_000_000,
                  events: int = 1 << 25, cap: int = 1 << 24,
                  budget: int = SPILL_BUDGET,
                  staging: int = SPILL_STAGING, batch: int = BATCH,
                  ckpt_interval: float = SHIFT_CKPT_INTERVAL_S) -> dict:
    """Tiered residency at Q5-10M under ``hbm-budget-slots`` 2^23. The
    spill phase's budgeted run is tiered (its record, ``spill``). Then the
    hot-set shift (``shift_keys``): the runs of SHIFT_RUNS, every window
    of each against the oracle, equal rows under the tie rule, at least
    one promotion landing in each; then a deferred run checkpointed every
    SHIFT_CKPT_INTERVAL_S and cancelled at its first checkpoint that holds
    a promotion and host-tier keys (the backend's spill still active),
    which restores into an unbudgeted operator that snapshots
    byte for byte as it was stored, and into an unbudgeted job run to the
    end (every window of both jobs against the oracle, together all of
    them). Each run's tier record, events/s, peak memory and probe
    launches."""
    import shutil
    import tempfile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.checkpoint.storage import load_checkpoint

    setting = {"state.backend.tpu.hbm-budget-slots": budget}
    make_gen = shift_gen_factory(torch, dev, batch)
    span = q5_panes(events, batch) * PANE_MS
    expected = q5_expected(keys, events, span,
                           keys=shift_keys(keys, events, batch))
    by_end = {e[0]: e for e in expected}
    cold = shift_pools(keys)[2]
    runs, rows = {}, {}
    for mode, defer in SHIFT_RUNS:
        fresh_memory(torch)
        reset_launches()
        job, got, _span = run_q5(
            torch, dev, keys, events, cap, batch=batch, staging=staging,
            gen=make_gen, defer=defer,
            settings={**setting, "state.tiering.async-prefetch": True})
        peak = torch.cuda.max_memory_allocated()
        launches = dict(KERNEL_LAUNCHES)
        windows = q5_check(expected, got)
        b = job.operators[0].backend
        rec = {**spill_record(job, events, peak), **tier_record(torch, b),
               "staging": ("off the task's thread"
                           if b.prefetch_pipeline.asynchronous
                           else "inline"),
               "windows_checked": windows,
               "hash_probe_launches": launches["hash_probe"],
               "ingest_step_spill_launches": launches["ingest_step_spill"],
               "cold_set_promoted": int(
                   (cold & ~b.host_tier.spilled_mask).sum())}
        if not rec["promotions"]["applied"]:
            raise AssertionError(f"shift run ({mode}): no promotion landed: "
                                 f"{rec}")
        if b.prefetch_pipeline.asynchronous == defer:
            raise AssertionError(f"shift run ({mode}): staging {rec['staging']}")
        if rec["groups_demoted_by_forced_fallback"]:
            raise AssertionError(
                f"shift run ({mode}): a forced spill took "
                f"{rec['groups_demoted_by_forced_fallback']} groups beyond "
                "those the reference evicts")
        runs[mode], rows[mode] = rec, got
        emit({"tiering_shift_run": mode, **rec})
        del job, b
    same = rows_equal_under_tie_rule(*rows.values())
    del rows
    ckpt_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_tier_")
    try:
        env, got1, _span = q5_env(
            torch, dev, keys, events, cap, batch=batch, staging=staging,
            gen=make_gen,
            settings={**setting,
                      "execution.checkpointing.interval": ckpt_interval,
                      "execution.checkpointing.dir": ckpt_dir})
        fresh_memory(torch)
        job = env.execute_async("q5-shift-checkpointed")
        op = job.operators[0]
        wait_checkpoints(job, 1, timeout=600.0,
                         holds=lambda r: r.get("promotions", 0) > 0
                         and r.get("host_keys", 0) > 0)
        job.cancel()
        spilled_at_cp = op.backend.spill_active
        # the latest completed checkpoint: the first after a promotion, or
        # one that completed after it before the cancel
        cp = job.coordinator.latest_checkpoint()
        (stat,) = [st for st in job.coordinator.stats
                   if st["id"] == cp.checkpoint_id]
        record = checkpoint_record(job, stat)
        (at,) = [r for r in op.backend.snapshot_log
                 if r["checkpoint_id"] == stat["id"]]
        promotions_at, host_keys_at = at["promotions"], at["host_keys"]
        if not (promotions_at and host_keys_at and spilled_at_cp):
            raise AssertionError(
                f"checkpoint {stat['id']}: promotions {promotions_at}, "
                f"host-tier keys {host_keys_at}, spill active "
                f"{spilled_at_cp}: it must hold a promotion and spilled "
                "state")
        before = list(got1)
        del job, env, op
        loaded = load_checkpoint(cp.external_path)
        (chain,) = [s["chain"] for s in loaded.task_snapshots.values()
                    if s.get("chain")]
        (window,) = [v for v in chain.values() if "keyed" in v]
        twin_op, _h = q5_operator(torch, dev, cap,
                                  spill_staging_slots=staging)
        twin_op.initialize_state([window["keyed"]], None)
        if snapshot_digest(twin_op.backend.snapshot(cp.checkpoint_id)) != \
                snapshot_digest(window["keyed"]["backend"]):
            raise AssertionError("the checkpoint after a promotion restored "
                                 "unbudgeted snapshots differently")
        del twin_op, _h, loaded, chain, window
        env2, got2, _span = q5_env(torch, dev, keys, events, cap,
                                   batch=batch, staging=staging,
                                   gen=make_gen)
        env2.restore_from_checkpoint(cp.external_path)
        job2 = env2.execute_async("q5-shift-restored")
        job2.wait()
        ends = []
        for part in (before, got2):
            e = [(ts + 1) // PANE_MS for ts, *_ in part]
            q5_check([by_end[x] for x in e], part)
            ends.append(e)
        if not ends[1] or sorted(set(ends[0]) | set(ends[1])) != \
                sorted(by_end):
            raise AssertionError(f"checkpointed shift run: windows {ends}")
        restored = {"checkpoint": record,
                    "promotions_at_checkpoint": promotions_at,
                    "host_keys_at_checkpoint": host_keys_at,
                    "spill_active_at_checkpoint": spilled_at_cp,
                    "snapshot_equal_unbudgeted": True,
                    "windows_before": len(ends[0]),
                    "windows_after": len(ends[1]),
                    "windows_repeated": len(set(ends[0]) & set(ends[1]))}
        del job2, env2, got2
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"tiering": f"Q5-{keys // 1_000_000}M", "hbm_budget_slots": budget,
            "budgeted_run": {k: spill[k] for k in spill
                             if k != "across_budgets"},
            "shift": {"seed": SHIFT_SEED, "groups_c_r": SHIFT_GROUPS,
                      "early_share": SHIFT_EARLY, "phases": SHIFT_PHASES,
                      "runs": runs,
                      "rows_equal_under_tie_rule": True,
                      "windows_identical_outright": same},
            "restored_after_promotion": restored}


# -- session windows: Nexmark Q11 and bench.py's session configuration ------
#: the two session cells: bench.py's MULT mixer over ``keys`` bidders with
#: ts = idx * span // events (Q11: q11.sql's SESSION(dateTime, 10 s) with
#: count(*)), and bench.py::bench_session's seeded numpy stream (sum(v));
#: ``lag``: the watermark trails the batch's largest timestamp by it
SESSION_CELLS = {
    "Q11-10M": {"keys": 10_000_000, "events": 1 << 25, "batch": BATCH,
                "capacity": 1 << 24, "lanes": 4, "span": 30_000,
                "gap": 10_000, "lag": 1, "agg": "count"},
    "session-100K": {"keys": 100_000, "events": 1 << 21, "batch": 1 << 16,
                     "capacity": 1 << 18, "lanes": 4, "span": 200_000,
                     "gap": 5000, "lag": 1000, "agg": "sum"},
}
SESSION_RUNS = 2               # timed runs of each session cell (3 before
#                                the connectors phase: cut for the limit)
SESSION_PREFIX = 4             # Q11 batches in the state before a timed step
SESSION_MID = 32               # Q11 batches before the mid-run step and fire
SESS_CKPT_RUN_S, SESS_CKPT_INTERVAL_S = 2.0, 0.25   # session checkpoints


def session_config(cell: str, **overrides) -> dict:
    """A session cell's configuration, with ``overrides`` (a smaller
    stream for a run on the CPU)."""
    return {"cell": cell, **SESSION_CELLS[cell], **overrides}


def session_data(c: dict) -> dict:
    """The cell's events in numpy, in index order: key, ts and the summed
    value (session-100K: bench_session's rng draws, in its order)."""
    n_events = c["events"]
    if c["agg"] == "count":
        idx = np.arange(n_events, dtype=np.int64)
        keys = ((idx.astype(np.uint64) * np.uint64(MULT))
                % np.uint64(c["keys"])).astype(np.int64)
        return {"key": keys, "ts": (idx * c["span"]) // n_events}
    rng = np.random.default_rng(0)
    keys = rng.integers(0, c["keys"], n_events).astype(np.int64)
    vals = rng.integers(1, 100, n_events).astype(np.int64)
    ts = np.sort(rng.integers(0, c["span"], n_events)).astype(np.int64)
    return {"key": keys, "ts": ts, "v": vals}


def session_gen(torch, c: dict):
    """The cell's datagen(device=True) generator: Q11 computes its columns
    from the indices on the device; session-100K gathers its stream, made
    in bulk with numpy and uploaded once per device."""
    if c["agg"] == "count":
        span, n_events = c["span"], c["events"]

        def q11(idx):
            return {"bidder": mixed_keys(idx, c["keys"]),
                    "ts": (idx * span) // n_events}

        return q11
    data = session_data(c)
    cols: dict = {}

    def stream(idx):
        if idx.device not in cols:
            cols[idx.device] = {k: torch.from_numpy(v).to(idx.device)
                                for k, v in data.items()}
        d = cols[idx.device]
        return {"k": d["key"][idx], "v": d["v"][idx], "ts": d["ts"][idx]}

    return stream


def session_env(torch, dev, c: dict, n_events: int | None = None,
                settings: dict | None = None, rate: float | None = None,
                source_hook=None):
    """The cell's pipeline, datagen(device=True) -> key_by -> session
    window -> device_aggregate -> sink, on a fresh environment, not yet
    executed: a watermark after every batch; ``n_events`` stops the source
    early (the stream stays the cell's). Returns (env, got), ``got``
    filled with (key, window_start, window_end, aggregate) per batch."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import EventTimeSessionWindows

    n = n_events or c["events"]
    count = c["agg"] == "count"
    key, out = ("bidder", "bids") if count else ("k", "total")
    fields = [(key, np.int64)] + ([] if count else [("v", np.int64)])
    got = []

    def sink(b):
        got.append((b.column(key), b.column("window_start"),
                    b.column("window_end"), b.column(out)))

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": c["batch"],
                       "pipeline.auto-watermark-interval": 0.0,
                       **(settings or {})}), device=dev)
    ws = WatermarkStrategy.for_bounded_out_of_orderness(c["lag"] - 1) \
        .with_timestamp_column("ts")
    source = DataGenSource(session_gen(torch, c),
                           Schema(fields + [("ts", np.int64)]), count=n,
                           rate_per_sec=rate, timestamp_column="ts",
                           device=True)
    if source_hook is not None:
        source_hook(source)
    agg = (AggSpec("count", out_name=out) if count
           else AggSpec("sum", "v", out_name=out))
    (env.from_source(source, ws, "DataGen")
        .key_by(key)
        .window(EventTimeSessionWindows.with_gap(c["gap"]))
        .device_aggregate([agg], capacity=c["capacity"],
                          ring_size=c["lanes"])
        .add_sink(sink))
    return env, got


def run_session(torch, dev, c: dict, n_events: int | None = None, **kw):
    """One run of the cell through ``env.execute()``; returns (job, got)."""
    env, got = session_env(torch, dev, c, n_events, **kw)
    return env.execute(f"sessions-{c['cell']}"), got


def session_expected(c: dict) -> np.ndarray:
    """The numpy oracle: the events sorted by (key, ts), a new session
    where the key changes or the gap to the previous event is at least
    ``gap``; window [first, last + gap), count (Q11) or sum(v). Rows
    [key, start, end, aggregate], sorted by (key, start)."""
    d = session_data(c)
    order = np.lexsort((d["ts"], d["key"]))
    k, t = d["key"][order], d["ts"][order]
    new = np.ones(len(k), bool)
    new[1:] = (k[1:] != k[:-1]) | (t[1:] - t[:-1] >= c["gap"])
    first = np.flatnonzero(new)
    last = np.r_[first[1:], len(k)] - 1
    agg = (last - first + 1 if c["agg"] == "count"
           else np.add.reduceat(d["v"][order], first))
    return by_session(np.stack([k[first], t[first], t[last] + c["gap"],
                                agg.astype(np.int64)], 1))


def by_session(rows: np.ndarray) -> np.ndarray:
    """Rows [key, start, ...] sorted by (key, start), one argsort of
    key * (largest start + 1) + start (keys and starts are not negative,
    and the product fits int64 for every cell)."""
    if not len(rows):
        return rows
    width = int(rows[:, 1].max()) + 1
    return rows[np.argsort(rows[:, 0] * width + rows[:, 1], kind="stable")]


def session_rows(got) -> np.ndarray:
    """Emitted rows as [key, start, end, aggregate], sorted by (key,
    start)."""
    if not got:
        return np.zeros((0, 4), np.int64)
    return by_session(np.stack([np.concatenate([np.asarray(g[i])
                                                for g in got])
                                .astype(np.int64) for i in range(4)], 1))


def session_check(expected: np.ndarray, got) -> int:
    """Every emitted session window equals the oracle's, as a set; returns
    the windows checked."""
    rows = session_rows(got)
    if rows.shape != expected.shape or not np.array_equal(rows, expected):
        raise AssertionError(
            f"session windows disagree with the numpy oracle: {len(rows)} "
            f"emitted, {len(expected)} expected")
    return len(rows)


def session_cell(torch, dev, cell: str) -> dict:
    """A session cell's timed runs: a warm-up of 4 batches, then
    SESSION_RUNS runs, each held to the oracle and to the path's launches
    (session_step once per batch, session_fire at least once per fire,
    no ingest_step); then a profiled run (busy time, the fire kernel's
    device ms per fire)."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    c = session_config(cell)
    n = c["events"]
    expected = session_expected(c)
    run_session(torch, dev, c, 4 * c["batch"])
    runs = []
    for _ in range(SESSION_RUNS):
        start = fresh_memory(torch)
        reset_launches()
        job, got = run_session(torch, dev, c)
        peak = torch.cuda.max_memory_allocated()
        launches = dict(KERNEL_LAUNCHES)
        windows = session_check(expected, got)
        op = job.operators[0]
        fires = len(op.fire_latencies_ms)
        if (launches["session_step"] != n // c["batch"]
                or launches["session_fire"] < fires
                or launches["ingest_step"] or op.late_dropped):
            raise AssertionError(f"{cell}: launches {launches} for "
                                 f"{n // c['batch']} batches and {fires} "
                                 f"fires, {op.late_dropped} late")
        runs.append({"wall_s": job.wall_s, "lat": list(op.fire_latencies_ms),
                     "peak": peak, "start": start, "launches": launches,
                     "windows": windows, "rebuilds": {},
                     "late_dropped": op.late_dropped,
                     "state_bytes": op.backend.state_nbytes,
                     "tasks": task_record(job)})
        del job, got, op   # the next run's memory starts without this state
    profile = run_profile(torch, lambda: (*run_session(torch, dev, c),
                                          None))
    fire_ms = profile["kernel_ms"]["session_fire"]
    return {**c, "fire_kernel_ms_per_fire_profiled":
            fire_ms / max(1, len(runs[-1]["lat"])),
            "profile": profile, **summary(runs, n)}


# -- session kernels against their plain versions ---------------------------
def session_state(torch, dev, cap: int, lanes: int, folds=()) -> dict:
    """Empty session state: the table, the lane planes at the reference's
    identities, cur_lane, the dirty bitmap, the counters, and one plane per
    (kind, dtype) of ``folds``."""
    from flink_tpu_torch.ops.hash_table import make_table
    from flink_tpu_torch.ops.segment_ops import make_accumulator

    shape = (lanes, cap)
    return {"table": make_table(cap, dev),
            "start": make_accumulator("min", shape, torch.int64, dev),
            "end": make_accumulator("max", shape, torch.int64, dev),
            "open": make_accumulator("max", shape, torch.int8, dev),
            "count": torch.zeros(shape, dtype=torch.int64, device=dev),
            "cur_lane": torch.zeros(cap, dtype=torch.int32, device=dev),
            "dirty": torch.zeros((cap >> DIRTY_SHIFT) + 2,
                                 dtype=torch.uint8, device=dev),
            "dropped": torch.zeros((), dtype=torch.int64, device=dev),
            "late": torch.zeros((), dtype=torch.int64, device=dev),
            "folds": [(k, make_accumulator(k, shape, d, dev))
                      for k, d in folds]}


def clone_state(st: dict) -> dict:
    return {k: ([(kind, p.clone()) for kind, p in v] if k == "folds"
                else v.clone()) for k, v in st.items()}


def copy_state(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if k == "folds":
            for (_k, d), (_k2, s) in zip(dst[k], v):
                d.copy_(s)
        else:
            dst[k].copy_(v)


def step_on(fn, st: dict, b: dict, gap: int, boundary: int):
    """``session_step`` or its plain version on state ``st`` and sorted
    batch ``b`` (keys, ts, one value column per fold plane)."""
    return fn(st["table"], st["start"], st["end"], st["open"], st["count"],
              [(k, p, v) for (k, p), v in zip(st["folds"], b["vals"])],
              st["cur_lane"], b["keys"], b["ts"], gap, boundary,
              st["dropped"], st["late"], st["dirty"], DIRTY_SHIFT)


def fire_on(fn, st: dict, outs, gap: int, boundary: int):
    return fn(st["table"], st["start"], st["end"], st["open"], st["count"],
              st["folds"], outs(st), gap, boundary, st["dirty"],
              DIRTY_SHIFT)


def state_by_key(st: dict) -> tuple:
    """(sorted keys, every plane and cur_lane at their slots): a state as a
    function of its keys, whatever slots its table gave them."""
    table = st["table"].cpu().numpy()
    slots = np.flatnonzero(table != INT64_MAX)
    order = np.argsort(table[slots], kind="stable")
    s = slots[order]
    planes = [st[k].cpu().numpy()[..., s] for k in
              ("start", "end", "open", "count", "cur_lane")]
    planes += [p.cpu().numpy()[..., s] for _k, p in st["folds"]]
    return table[s], planes


def assert_states_equal(a: dict, b: dict, what: str) -> None:
    ka, pa = state_by_key(a)
    kb, pb = state_by_key(b)
    same = np.array_equal(ka, kb) and all(
        np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
        for x, y in zip(pa, pb))
    same = same and all(int(a[c]) == int(b[c]) for c in ("dropped", "late"))
    if not same:
        raise AssertionError(f"session {what}: the kernel's state differs "
                             "from the plain version's")


def assert_dirty_is_touched(torch, st: dict, keys, before, what: str) -> None:
    """The dirty bytes set by one step are exactly the blocks of the slots
    of the batch's keys (``before``: the bitmap before the step)."""
    from flink_tpu_torch.ops.hash_table import lookup, sanitize_keys_device

    slots = lookup(st["table"], sanitize_keys_device(keys)).to(torch.int64)
    want = before.clone()
    want[slots[slots >= 0] >> DIRTY_SHIFT] = 1
    if not torch.equal(want, st["dirty"]):
        raise AssertionError(f"session {what}: dirty blocks are not those "
                             "of the batch's slots")


def emitted_rows(rows) -> np.ndarray:
    g = int(rows.n)
    cols = [rows.key, rows.start, rows.end, rows.count, *rows.values]
    out = np.stack([c[:g].cpu().double().numpy() for c in cols], 1)
    return out[np.lexsort(out.T[::-1])] if g else out


def fired_rows(rows) -> np.ndarray:
    f = int(rows.counts[0])
    cols = [rows.key, rows.start, rows.end, rows.count, *rows.values]
    return np.stack([c[:f].cpu().double().numpy() for c in cols], 1)


def sort_batch(torch, keys, ts, vals):
    """The operator's sort: ts then key, both stable."""
    order = torch.sort(ts, stable=True).indices
    order = order[torch.sort(keys[order], stable=True).indices]
    return {"keys": keys[order].contiguous(), "ts": ts[order].contiguous(),
            "vals": [v[order].contiguous() for v in vals]}


def q11_batch(torch, dev, b: int, c: dict) -> tuple[dict, int]:
    """Q11-10M's batch ``b``, sorted, and the fire boundary after it."""
    idx = torch.arange(b * c["batch"], (b + 1) * c["batch"],
                       dtype=torch.int64, device=dev)
    ts = (idx * c["span"]) // c["events"]
    return (sort_batch(torch, mixed_keys(idx, c["keys"]), ts, []),
            int(ts.max()) - c["lag"] + 1)


def step_bytes(torch, pre: dict, b: dict, gap: int) -> int:
    """Bytes one step must move on this batch: each row's key, ts and
    values; per distinct key its table cell (written too when new), the
    open cells of its lanes and the start and end of its open ones, and
    its cur_lane read and written; per segment its lane's start, end,
    open, count and aggregate cells written (the rows here are never
    late)."""
    from flink_tpu_torch.ops.hash_table import lookup, sanitize_keys_device

    keys, ts = b["keys"], b["ts"]
    n, L = keys.numel(), pre["open"].shape[0]
    vbytes = sum(v.element_size() for v in b["vals"])
    distinct = torch.ones(n, dtype=torch.bool, device=keys.device)
    distinct[1:] = keys[1:] != keys[:-1]
    anchors = distinct.clone()
    anchors[1:] |= ts[1:] - ts[:-1] >= gap
    uk = keys[distinct]
    slots = lookup(pre["table"], sanitize_keys_device(uk)).to(torch.int64)
    old = slots[slots >= 0]
    open_lanes = int((pre["open"][:, old] > 0).sum())
    d, new = int(uk.numel()), int((slots < 0).sum())
    lane_cell = 8 + 8 + 1 + 8 + sum(p.element_size()
                                    for _k, p in pre["folds"])
    return (n * (16 + vbytes) + d * (8 + L + 4 + 4) + new * 8
            + open_lanes * 16 + int(anchors.sum()) * lane_cell)


def fire_bytes(st: dict, due: int, outs_bytes: int) -> int:
    """Bytes one fire round must move: the open plane, the end of each open
    lane; per fired lane its key, start, count and aggregate cells read,
    the outputs written and the lane's cells reset."""
    L, cap = st["open"].shape
    fired = min(due, cap)
    agg = sum(p.element_size() for _k, p in st["folds"])
    open_lanes = int((st["open"] > 0).sum())
    return (L * cap + 8 * open_lanes
            + fired * (24 + agg + 32 + outs_bytes + 25 + agg))


def sector_ids(torch, plane: int, idx, esize: int):
    """Ids of the 32-byte sectors that hold cells ``idx`` of a plane of
    ``esize``-byte cells, distinct across planes."""
    return plane * (1 << 44) + (idx.to(torch.int64) * esize) // 32


def sector_floor(torch, read: list, written: list) -> int:
    """Sectors device memory must move: each distinct sector read or
    written in part once in, each written sector once out (every sector
    here is written in part, so it is read first)."""
    everything = torch.unique(torch.cat(read + written))
    return int(everything.numel()) + int(torch.unique(torch.cat(
        written)).numel())


#: a kernel that walks a plane in address order streams a block of
#: DENSE_BLOCK sectors (2 KiB) of which at least DENSE_SHARE are touched;
#: ``sector_rates`` measures address order at 12% to 22% of the sectors
DENSE_BLOCK = 64
DENSE_SHARE = 0.25


def priced_sectors(torch, rates: dict, read: list, written: list,
                   widths: dict, claimed=None, ordered: bool = False
                   ) -> float:
    """Milliseconds the card needs for a sector pattern at its measured
    rates (``sector_rates``): sectors only read at read8's rate, sectors
    ``claimed`` (a new key's table sector) at probe8's, every other
    written sector once at store8's or store4's by its plane's cell width
    (``widths``: plane -> bytes). The rates are the random ones, or with
    ``ordered`` (the kernel walks every plane in address order) those in
    address order, and the sectors of a dense block (DENSE_BLOCK sectors
    of a plane, at least DENSE_SHARE of them touched) then stream at
    3.35 TB/s, counted as ``sector_floor`` counts them."""
    order = "sorted" if ordered else "random"

    def per_ms(op):
        return rates["ops"][op][order]["g_sectors_per_s"] * 1e6

    w = torch.unique(torch.cat(written))
    r = torch.unique(torch.cat(read))
    r = r[~torch.isin(r, w)]
    ms = 0.0
    if ordered:
        blocks, n = torch.unique(torch.cat([r, w]) // DENSE_BLOCK,
                                 return_counts=True)
        dense = blocks[n >= DENSE_SHARE * DENSE_BLOCK]
        on_r = torch.isin(r // DENSE_BLOCK, dense)
        on_w = torch.isin(w // DENSE_BLOCK, dense)
        ms += bound_ms(32 * (int(on_r.sum()) + 2 * int(on_w.sum())))
        r, w = r[~on_r], w[~on_w]
    ms += r.numel() / per_ms("read8")
    if claimed is not None:
        on = torch.isin(w, claimed)
        ms += int(on.sum()) / per_ms("probe8")
        w = w[~on]
    wide = torch.zeros(max(widths) + 1, dtype=torch.bool, device=w.device)
    wide[[p for p, width in widths.items() if width >= 8]] = True
    eight = wide[w >> 44]
    return (ms + int(eight.sum()) / per_ms("store8")
            + int((~eight).sum()) / per_ms("store4"))


def step_sectors(torch, pre: dict, post: dict, b: dict,
                 rates: dict | None = None) -> dict:
    """The step's sector floor on the [L, capacity] layout for this batch:
    per distinct key its table sector (written when new); for a key
    already present the open sectors of its L lanes, its cur_lane sector
    and the start and end sectors of its open lanes; the start, end, open,
    count and aggregate sectors of every lane the batch changed and the
    cur_lane sectors it changed, each read and written. The dirty bitmap
    stays in L2 and is not counted. With ``rates``, that pattern at the
    card's measured random rates (``priced_sectors``: a new key's table
    sector claimed)."""
    from flink_tpu_torch.ops.hash_table import lookup, sanitize_keys_device

    keys = b["keys"]
    L, cap = pre["open"].shape
    distinct = torch.ones(keys.numel(), dtype=torch.bool, device=keys.device)
    distinct[1:] = keys[1:] != keys[:-1]
    uk = sanitize_keys_device(keys[distinct])
    before = lookup(pre["table"], uk).to(torch.int64)
    after = lookup(post["table"], uk).to(torch.int64)
    slots, old = after[after >= 0], before[before >= 0]
    new = after[(before < 0) & (after >= 0)]
    lane_idx = (torch.arange(L, device=keys.device)[:, None] * cap
                + old[None, :]).flatten()
    open_idx = lane_idx[pre["open"].view(-1)[lane_idx] > 0]
    changed = ((pre["start"] != post["start"]) | (pre["end"] != post["end"])
               | (pre["open"] != post["open"])
               | (pre["count"] != post["count"])).view(-1)
    for (_k, p), (_k2, q) in zip(pre["folds"], post["folds"]):
        changed |= (p != q).view(-1)
    w = torch.nonzero(changed).flatten()
    cl = torch.nonzero(pre["cur_lane"] != post["cur_lane"]).flatten()
    read = [sector_ids(torch, 0, slots, 8), sector_ids(torch, 1, lane_idx, 1),
            sector_ids(torch, 2, old, 4), sector_ids(torch, 3, open_idx, 8),
            sector_ids(torch, 4, open_idx, 8)]
    written = [sector_ids(torch, 0, new, 8), sector_ids(torch, 1, w, 1),
               sector_ids(torch, 2, cl, 4), sector_ids(torch, 3, w, 8),
               sector_ids(torch, 4, w, 8), sector_ids(torch, 5, w, 8)]
    written += [sector_ids(torch, 6 + q, w, p.element_size())
                for q, (_k, p) in enumerate(pre["folds"])]
    n = sector_floor(torch, read, written)
    out = {"sectors": n, "keys": int(uk.numel()), "new_keys": int(
        new.numel()), "sectors_per_key": n / max(1, int(uk.numel())),
        "sector_floor_ms": bound_ms(32 * n)}
    if rates is not None:
        widths = {0: 8, 1: 1, 2: 4, 3: 8, 4: 8, 5: 8,
                  **{6 + q: p.element_size()
                     for q, (_k, p) in enumerate(pre["folds"])}}
        out["at_measured_rate_ms"] = priced_sectors(
            torch, rates, read, written, widths,
            claimed=sector_ids(torch, 0, new, 8))
    return out


def fire_sectors(torch, pre: dict, post: dict, outs_bytes: int,
                 rates: dict | None = None) -> dict:
    """One fire round's sector floor on the layout: the open plane, the
    end sectors that hold an open lane, the table sectors of fired slots,
    and the start, end, count, open and aggregate sectors that hold a
    fired lane, read and written; the outputs written whole. With
    ``rates``, that pattern at the card's measured rates in address order,
    the order the kernel walks its lanes in (``priced_sectors``: dense
    blocks, the open plane's scan among them, and the outputs at
    3.35 TB/s)."""
    L, cap = pre["open"].shape
    idx = torch.arange(L * cap, device=pre["open"].device)
    opened = idx[pre["open"].view(-1) > 0]
    fired = idx[(pre["open"].view(-1) > 0) & (post["open"].view(-1) <= 0)]
    read = [sector_ids(torch, 1, idx[::32], 1), sector_ids(torch, 4, opened, 8),
            sector_ids(torch, 0, fired & (cap - 1), 8)]
    written = [sector_ids(torch, 1, fired, 1), sector_ids(torch, 3, fired, 8),
               sector_ids(torch, 4, fired, 8), sector_ids(torch, 5, fired, 8)]
    written += [sector_ids(torch, 6 + q, fired, p.element_size())
                for q, (_k, p) in enumerate(pre["folds"])]
    n = sector_floor(torch, read, written)
    out = fired.numel() * (32 + outs_bytes) // 32
    rec = {"sectors": n + out, "fired": int(fired.numel()),
           "open_lanes": int(opened.numel()),
           "sector_floor_ms": bound_ms(32 * (n + out))}
    if rates is not None:
        widths = {0: 8, 1: 1, 3: 8, 4: 8, 5: 8,
                  **{6 + q: p.element_size()
                     for q, (_k, p) in enumerate(pre["folds"])}}
        rec["at_measured_rate_ms"] = bound_ms(32 * out) + priced_sectors(
            torch, rates, read, written, widths, ordered=True)
    return rec


# -- adversarial inputs of the session kernels --------------------------------
#: step cases: a hot key whose run crosses blocks; every lane of a key open
#: (segments dropped) at 1, 4, 16 and 64 lanes; no aggregate and 8 of
#: every dtype under disorder and late rows. Fire cases: exactly capacity
#: due, capacity + 1, none, every lane; entries that are not a multiple of
#: the fire's 4096-lane tile (2.5 tiles), and not of a thread's lanes.
EDGE_STEP_CASES = ("hot_key", "lanes_1", "lanes_4", "lanes_16", "lanes_64",
                   "folds_0", "folds_8")
EDGE_FIRE_CASES = ("due_capacity", "due_capacity_plus_1", "due_none",
                   "due_every_lane", "ragged_tiles", "ragged_threads")
EDGE_FOLDS_8 = (("sum", "int64"), ("min", "int64"), ("max", "int64"),
                ("sum", "int32"), ("max", "int32"), ("min", "float32"),
                ("sum", "float32"), ("max", "float64"))
EDGE_FIRE_FOLDS = (("sum", "int64"), ("min", "float32"), ("max", "int32"),
                   ("sum", "float64"))
EDGE_GAP = 30


def _edge_batch(keys, ts, vals, boundary) -> tuple:
    order = np.lexsort((ts, keys))
    return (keys[order].astype(np.int64), ts[order].astype(np.int64),
            [v[order] for v in vals], int(boundary))


def session_edge_steps(case: str) -> dict:
    """One step case in numpy: ``cap``, ``lanes``, ``folds`` ((kind, dtype
    name) per aggregate plane) and ``batches``, each (keys, ts, values per
    plane, the fire boundary after it), sorted by (key, ts); the gap is
    EDGE_GAP. Values are integers, so float sums are exact."""
    rng = np.random.default_rng(EDGE_STEP_CASES.index(case) + 70)
    batches = []
    if case == "hot_key":
        # key 200 sorts after about half of 2000 other rows: its run of
        # 1800 rows in three segments starts inside a block and crosses
        # seven block boundaries
        t0 = 0
        for _ in range(3):
            hot = np.concatenate([t0 + rng.integers(lo, lo + 200, 600)
                                  for lo in (0, 300, 700)])
            other = rng.integers(0, 400, 2000)
            keys = np.concatenate([np.full(hot.size, 200), other])
            ts = np.concatenate([hot, t0 + rng.integers(-700, 900, 2000)])
            v = rng.integers(-50, 50, keys.size)
            batches.append(_edge_batch(keys, ts, [v], t0 + 400))
            t0 += 1000
        return {"cap": 1 << 12, "lanes": 4, "folds": (("sum", "int64"),),
                "batches": batches}
    if case.startswith("lanes_"):
        # 100 keys open L + 2 sessions each, 100 ms apart: every lane
        # opens and 2 segments of each key are dropped; each boundary
        # fires the oldest; the next batch merges into open lanes, takes
        # the freed ones, drops the rest and has late rows
        L = int(case.split("_")[1])
        k = np.arange(100)
        t0 = 0
        for b in range(3):
            seg = t0 + 100 * np.arange(L + 2)
            ts = np.concatenate([seg + d for d in (0, 5)])
            keys = np.repeat(k, ts.size)
            ts = np.tile(ts, k.size)
            if b:
                # one row into the last lane the key opened before, one
                # late row behind the last boundary
                prev = t0 - 100 * (L + 2) - 200
                keys = np.concatenate([keys, k, k])
                ts = np.concatenate([
                    ts, np.full(k.size, prev + 100 * (L - 1) + 3),
                    np.full(k.size, prev + 150 - EDGE_GAP - 10)])
            batches.append(_edge_batch(keys, ts, [], t0 + 150))
            t0 += 100 * (L + 2) + 200
        return {"cap": 1 << 13, "lanes": L, "folds": (), "batches": batches}
    folds = EDGE_FOLDS_8 if case == "folds_8" else ()
    t0 = 0
    for _ in range(6):
        n = 2048
        keys = rng.integers(0, 300, n)
        ts = (t0 + np.sort(rng.integers(0, 300, n))
              + rng.integers(-2 * EDGE_GAP, 2 * EDGE_GAP, n))
        v = rng.integers(-50, 50, n)
        batches.append(_edge_batch(keys, ts, [v.astype(d) for _k, d in folds],
                                   t0 + 250))
        t0 += 200
    return {"cap": 1 << 12, "lanes": 8, "folds": folds, "batches": batches}


def session_edge_fire(case: str) -> dict:
    """One fire case in numpy: ``cap``, ``lanes``, ``boundary``, ``due``
    (the lanes due), the table's keys and the planes (start, end, open,
    count, one per EDGE_FIRE_FOLDS); lanes that are not open hold the
    identities, as the step and the fire leave them."""
    rng = np.random.default_rng(EDGE_FIRE_CASES.index(case) + 90)
    L, cap = {"ragged_tiles": (5, 1 << 11),
              "ragged_threads": (3, 8)}.get(case, (4, 1 << 12))
    n = L * cap
    boundary = 1_000_000
    if case == "due_every_lane":
        is_open = np.ones(n, bool)
    else:
        is_open = rng.random(n) < 0.75
    opened = np.flatnonzero(is_open)
    want = {"due_capacity": cap, "due_capacity_plus_1": cap + 1,
            "due_none": 0, "due_every_lane": n}.get(case,
                                                    int(0.4 * opened.size))
    due = np.zeros(n, bool)
    due[rng.permutation(opened)[:want]] = True
    r = rng.random(n)
    end = np.where(due, boundary - EDGE_GAP - (r * 5000).astype(np.int64),
                   boundary - EDGE_GAP + 1 + (r * 5000).astype(np.int64))
    start = end - (r * 9000).astype(np.int64)
    count = rng.integers(1, 8, n)
    closed = ~is_open
    start[closed], end[closed], count[closed] = INT64_MAX, -INT64_MAX - 1, 0
    open_ = np.where(is_open, 1, rng.choice([0, -128], n)).astype(np.int8)
    folds = []
    for kind, d in EDGE_FIRE_FOLDS:
        v = rng.integers(-40, 40, n).astype(d)
        if kind == "sum":
            v[closed] = 0
        elif d.startswith("float"):   # fresh: the largest finite; reset: inf
            sign = 1 if kind == "min" else -1
            v[closed & (open_ < 0)] = sign * np.finfo(d).max
            v[closed & (open_ == 0)] = sign * np.inf
        else:
            v[closed] = np.iinfo(d).max if kind == "min" else np.iinfo(d).min
        folds.append(v.reshape(L, cap))
    return {"cap": cap, "lanes": L, "boundary": boundary, "due": want,
            "table": rng.permutation(cap).astype(np.int64) * 7 + 1,
            "start": start.reshape(L, cap), "end": end.reshape(L, cap),
            "open": open_.reshape(L, cap),
            "count": count.astype(np.int64).reshape(L, cap), "folds": folds}


def edge_fire_outs(st: dict) -> list:
    """Outputs of the fire cases: count, and sum, min, max and avg of the
    EDGE_FIRE_FOLDS planes."""
    (_a, total), (_b, lo), (_c, hi), (_d, mean) = st["folds"]
    return [("count", st["count"]), ("sum", total), ("min", lo),
            ("max", hi), ("avg", mean)]


def assert_free_lanes_hold_identities(torch, st: dict, what: str) -> None:
    """Every lane that is not open (open -128 as the planes start, or 0
    after a fire) holds its planes' identities: start int64 max, end int64
    min, count 0, each aggregate its kind's identity, which a float min or
    max plane holds as its largest finite value (as it starts) or as inf
    (as a fire resets it). Every slot without a key has no open lane and
    cur_lane 0. The step writes a free lane without reading it."""
    from flink_tpu_torch.ops.segment_ops import identity

    free = st["open"] <= 0
    ok = bool(((st["open"] == 0) | (st["open"] == -128)
               | (st["open"] == 1)).all())
    ok &= bool((st["start"][free] == INT64_MAX).all()
               and (st["end"][free] == -INT64_MAX - 1).all()
               and (st["count"][free] == 0).all())
    for kind, p in st["folds"]:
        cells = p[free]
        same = cells == identity(kind, p.dtype)
        if p.dtype.is_floating_point and kind != "sum":
            same |= cells == (float("inf") if kind == "min"
                              else -float("inf"))
        ok &= bool(same.all())
    empty = st["table"] == INT64_MAX
    ok &= bool((st["open"][:, empty] == -128).all()
               and (st["cur_lane"][empty] == 0).all())
    if not ok:
        raise AssertionError(f"session {what}: a lane that is not open "
                             "holds other values than the identities")


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def edge_state(torch, dev, c: dict) -> dict:
    return session_state(torch, dev, c["cap"], c["lanes"],
                         [(k, getattr(torch, d)) for k, d in c["folds"]])


def edge_batch_on(torch, dev, batch: tuple) -> dict:
    """A numpy batch of ``session_edge_steps`` as the step's tensors."""
    keys, ts, vals, _b = batch
    return {"keys": torch.from_numpy(keys).to(dev),
            "ts": torch.from_numpy(ts).to(dev),
            "vals": [torch.from_numpy(v).to(dev) for v in vals]}


def check_session_edge_steps(torch, dev, case: str) -> dict:
    """A step case, kernel against plain version: on fresh tables (the
    kernel's CAS claims and the plain version's differ, so key by key,
    the dirty blocks those of the batch's slots) and on one table that
    already holds each batch's keys (slot for slot, every plane, cur_lane,
    the dirty bitmap and the counters); one launch per step; each batch's
    fire rounds equal; the free lanes at the identities."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.ops.hash_table import lookup_or_insert, \
        sanitize_keys_device
    from flink_tpu_torch.ops.session import session_fire, \
        session_fire_plain, session_step, session_step_plain

    c = session_edge_steps(case)
    gap, seen = EDGE_GAP, {}

    def outs(st):
        return [("count", st["count"])] + [(k, p) for k, p in st["folds"]]

    for shared in (False, True):
        kst = edge_state(torch, dev, c)
        pst = clone_state(kst)
        fb = MIN_TIMESTAMP
        for j, raw in enumerate(c["batches"]):
            what = f"{case} batch {j}{' shared' if shared else ''}"
            b = edge_batch_on(torch, dev, raw)
            if shared:
                lookup_or_insert(kst["table"], sanitize_keys_device(b["keys"]))
                pst["table"].copy_(kst["table"])
            before = kst["dirty"].clone()
            reset_launches()
            got = step_on(session_step, kst, b, gap, fb)
            if KERNEL_LAUNCHES["session_step"] != (dev.type == "cuda"):
                raise AssertionError(f"session {what}: "
                                     f"{KERNEL_LAUNCHES['session_step']} "
                                     "step launches")
            want = step_on(session_step_plain, pst, b, gap, fb)
            sync(torch, dev)
            assert_states_equal(kst, pst, f"step {what}")
            assert_dirty_is_touched(torch, kst, b["keys"], before, what)
            if not np.array_equal(emitted_rows(got), emitted_rows(want)):
                raise AssertionError(f"session {what}: emitted rows differ")
            fb = raw[3]
            while True:
                a = fire_on(session_fire, kst, outs, gap, fb)
                w = fire_on(session_fire_plain, pst, outs, gap, fb)
                x, y = fired_rows(a), fired_rows(w)
                if shared:
                    same = np.array_equal(x, y, equal_nan=True)
                else:
                    same = np.array_equal(x[np.lexsort(x.T[::-1])],
                                          y[np.lexsort(y.T[::-1])])
                if not (torch.equal(a.counts, w.counts) and same):
                    raise AssertionError(f"session fire after {what}: fired "
                                         "rows differ")
                assert_states_equal(kst, pst, f"fire after {what}")
                if int(w.counts[1]) == 0:
                    break
            if shared:
                for k in ("table", "start", "end", "open", "count",
                          "cur_lane", "dirty"):
                    if not torch.equal(kst[k], pst[k]):
                        raise AssertionError(f"session {what}: {k} differs "
                                             "slot for slot")
            assert_free_lanes_hold_identities(torch, kst, what)
        seen["shared" if shared else "fresh"] = {
            "late": int(kst["late"]), "dropped": int(kst["dropped"])}
    return seen


def edge_fire_state(torch, dev, c: dict) -> dict:
    st = session_state(torch, dev, c["cap"], c["lanes"],
                       [(k, getattr(torch, d)) for k, d in EDGE_FIRE_FOLDS])
    for k in ("table", "start", "end", "open", "count"):
        st[k].copy_(torch.from_numpy(c[k]))
    for (_k, p), v in zip(st["folds"], c["folds"]):
        p.copy_(torch.from_numpy(v))
    return st


def check_session_edge_fire(torch, dev, case: str) -> dict:
    """A fire case, kernel against plain version: every round's counts,
    its fired rows in lane-major order, every plane and the dirty bitmap
    exactly equal, rounds until none overflows; the rounds those the due
    count asks for (one when none is due)."""
    from flink_tpu_torch.ops.session import session_fire, session_fire_plain

    c = session_edge_fire(case)
    kst = edge_fire_state(torch, dev, c)
    pst = clone_state(kst)
    rounds, fired = 0, 0
    while True:
        a = fire_on(session_fire, kst, edge_fire_outs, EDGE_GAP,
                    c["boundary"])
        w = fire_on(session_fire_plain, pst, edge_fire_outs, EDGE_GAP,
                    c["boundary"])
        sync(torch, dev)
        rounds += 1
        if not (torch.equal(a.counts, w.counts) and np.array_equal(
                fired_rows(a), fired_rows(w), equal_nan=True)):
            raise AssertionError(f"session fire {case} round {rounds}: "
                                 "fired rows differ")
        for k in ("start", "end", "open", "count", "dirty"):
            if not torch.equal(kst[k], pst[k]):
                raise AssertionError(f"session fire {case} round {rounds}: "
                                     f"{k} differs")
        for (_k, x), (_k2, y) in zip(kst["folds"], pst["folds"]):
            if not torch.equal(x, y):
                raise AssertionError(f"session fire {case} round {rounds}: "
                                     "an aggregate plane differs")
        fired += int(a.counts[0])
        if int(a.counts[1]) == 0:
            break
    if fired != c["due"] or rounds != max(1, -(-c["due"] // c["cap"])):
        raise AssertionError(f"session fire {case}: {fired} of {c['due']} "
                             f"due fired in {rounds} rounds")
    assert_free_lanes_hold_identities(torch, kst, f"fire {case}")
    return {"due": c["due"], "rounds": rounds, "entries": c["lanes"] * c["cap"]}


def session_edges(torch, dev) -> dict:
    """Every adversarial case of the session kernels on the card."""
    return {**{case: check_session_edge_steps(torch, dev, case)
               for case in EDGE_STEP_CASES},
            **{case: check_session_edge_fire(torch, dev, case)
               for case in EDGE_FIRE_CASES}}


def ptxas_report(text: str) -> dict:
    """Registers, shared memory, stack and spills per kernel from ptxas's
    ``-v`` output, keyed by the kernel's mangled name."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(s.group(1)) if s else 0
    return out

def check_session(torch, dev, flush, q11: dict | None = None,
                  edges: bool = True, rates: dict | None = None) -> dict:
    """session_step and session_fire against their plain versions: at
    Q11-10M's shapes (a 2^19-row batch into 2^24 slots, 4 lanes, with 4
    batches and their fires in the state; a fire over [4, 2^24] with half
    the lanes due, so two rounds) and on a small signature with sum, min,
    max and avg under disorder and late rows. The step equals the plain
    version on a shared table slot for slot (the batch's keys inserted
    beforehand, so both find the same slots), and from a state where the
    batch's keys are new, key by key, its dirty blocks those of the batch's
    slots; emitted and fired rows equal; each kernel timed beside its
    plain version. ``q11``: another configuration in place of Q11-10M's;
    ``edges``: also the adversarial cases (``session_edges``); ``rates``
    (``sector_rates``): each shape's sector floor also at the card's
    measured random rates."""
    from flink_tpu_torch.ops.hash_table import lookup_or_insert, \
        sanitize_keys_device
    from flink_tpu_torch.ops.session import session_fire, \
        session_fire_plain, session_step, session_step_plain

    c = q11 or session_config("Q11-10M")
    gap, L, cap = c["gap"], c["lanes"], c["capacity"]
    shapes = {}

    def count_out(st):
        return [("count", st["count"])]

    # -- the step at Q11-10M ------------------------------------------------
    st = session_state(torch, dev, cap, L)
    boundary = MIN_TIMESTAMP
    for b in range(SESSION_PREFIX):
        batch, nxt = q11_batch(torch, dev, b, c)
        step_on(session_step, st, batch, gap, boundary)
        boundary = nxt
        while int(fire_on(session_fire, st, count_out, gap,
                          boundary).counts[1]):
            pass
    batch, _ = q11_batch(torch, dev, SESSION_PREFIX, c)
    pre = clone_state(st)
    plain = clone_state(pre)
    before = st["dirty"].clone()
    got = step_on(session_step, st, batch, gap, boundary)
    want = step_on(session_step_plain, plain, batch, gap, boundary)
    torch.cuda.synchronize()
    assert_states_equal(st, plain, "step at Q11-10M, new keys")
    assert_dirty_is_touched(torch, st, batch["keys"], before, "step")
    if not np.array_equal(emitted_rows(got), emitted_rows(want)):
        raise AssertionError("session step: emitted segments differ")
    # the same batch on one table, its keys in place: slot for slot
    shared = clone_state(pre)
    lookup_or_insert(shared["table"], sanitize_keys_device(batch["keys"]))
    twin = clone_state(shared)
    step_on(session_step, shared, batch, gap, boundary)
    step_on(session_step_plain, twin, batch, gap, boundary)
    torch.cuda.synchronize()
    for k in ("table", "start", "end", "open", "count", "cur_lane", "dirty",
              "dropped", "late"):
        if not torch.equal(shared[k], twin[k]):
            raise AssertionError(f"session step on a shared table: {k} "
                                 "differs from the plain version's")
    live, live_plain = clone_state(pre), clone_state(pre)
    shapes["q11_step_cap_2^24"] = {
        "rows": batch["keys"].numel(), "capacity": cap, "lanes": L,
        "ms": cuda_ms(lambda: step_on(session_step, live, batch, gap,
                                      boundary), torch, flush,
                      setup=lambda: copy_state(live, pre)),
        "plain_ms": cuda_ms(lambda: step_on(session_step_plain, live_plain,
                                            batch, gap, boundary), torch,
                            flush, setup=lambda: copy_state(live_plain, pre)),
        "bound_ms": bound_ms(step_bytes(torch, pre, batch, gap)),
        "bound_by": "bytes", "library_ms": None,
        **step_sectors(torch, pre, st, batch, rates)}
    del st, plain, shared, twin, live, live_plain, pre

    # -- the cell's own shapes: half its batches and their fires, then the
    # next batch's step, and the fire at the cell's boundary after it -------
    st = session_state(torch, dev, cap, L)
    boundary = MIN_TIMESTAMP
    for b in range(SESSION_MID):
        batch, nxt = q11_batch(torch, dev, b, c)
        step_on(session_step, st, batch, gap, boundary)
        boundary = nxt
        while int(fire_on(session_fire, st, count_out, gap,
                          boundary).counts[1]):
            pass
    batch, nxt = q11_batch(torch, dev, SESSION_MID, c)
    pre = clone_state(st)
    plain = clone_state(pre)
    step_on(session_step, st, batch, gap, boundary)
    step_on(session_step_plain, plain, batch, gap, boundary)
    torch.cuda.synchronize()
    assert_states_equal(st, plain, "step at the cell's middle")
    live, live_plain = clone_state(pre), clone_state(pre)
    shapes["q11_step_mid_run"] = {
        "batch": SESSION_MID, "rows": batch["keys"].numel(),
        "ms": cuda_ms(lambda: step_on(session_step, live, batch, gap,
                                      boundary), torch, flush,
                      setup=lambda: copy_state(live, pre)),
        "plain_ms": cuda_ms(lambda: step_on(session_step_plain, live_plain,
                                            batch, gap, boundary), torch,
                            flush, setup=lambda: copy_state(live_plain, pre)),
        "bound_ms": bound_ms(step_bytes(torch, pre, batch, gap)),
        "bound_by": "bytes", "library_ms": None,
        **step_sectors(torch, pre, st, batch, rates)}
    del plain, live, live_plain, pre
    pre = clone_state(st)
    plain = clone_state(st)
    got = fire_on(session_fire, st, count_out, gap, nxt)
    want = fire_on(session_fire_plain, plain, count_out, gap, nxt)
    torch.cuda.synchronize()
    if not (torch.equal(got.counts, want.counts)
            and np.array_equal(fired_rows(got), fired_rows(want))
            and int(got.counts[1]) == 0):
        raise AssertionError("session fire at the cell's shape: fired rows "
                             "differ from the plain version's")
    for k in ("start", "end", "open", "count", "dirty"):
        if not torch.equal(st[k], plain[k]):
            raise AssertionError(f"session fire at the cell's shape: {k} "
                                 "differs from the plain version's")
    n_due = int(got.counts[0])
    live, live_plain = clone_state(pre), clone_state(pre)
    shapes["q11_fire_cell"] = {
        "batch": SESSION_MID, "lanes": L, "capacity": cap, "due": n_due,
        "ms": cuda_ms(lambda: fire_on(session_fire, live, count_out, gap,
                                      nxt), torch, flush,
                      setup=lambda: copy_state(live, pre)),
        "plain_ms": cuda_ms(lambda: fire_on(session_fire_plain, live_plain,
                                            count_out, gap, nxt), torch,
                            flush, setup=lambda: copy_state(live_plain, pre)),
        "bound_ms": bound_ms(fire_bytes(pre, n_due, 0)),
        "bound_by": "bytes", "library_ms": None,
        **fire_sectors(torch, pre, live, 0, rates)}
    assert_free_lanes_hold_identities(torch, st, "the cell's middle")
    del st, plain, live, live_plain, pre

    # -- the fire at Q11-10M: half the lanes due, two rounds ------------------
    gen = torch.Generator(device=dev).manual_seed(11)
    st = session_state(torch, dev, cap, L)
    st["table"].copy_(torch.randperm(cap, device=dev, generator=gen) * 7 + 1)
    r = torch.rand((L, cap), device=dev, generator=gen)
    bnd = 1_000_000
    st["open"].copy_((r < 0.75).to(torch.int8))
    due = r < 0.49   # under 2^25 lanes: two rounds of 2^24
    st["end"].copy_(torch.where(
        due, bnd - gap - (r * 5000).to(torch.int64),
        bnd - gap + 1 + (r * 5000).to(torch.int64)))
    st["start"].copy_(st["end"] - (r * 9000).to(torch.int64))
    st["count"].copy_((r * 7).to(torch.int64) + 1)
    pre = clone_state(st)
    plain = clone_state(pre)
    n_due = int(due.sum())
    for rnd in range(3):
        got = fire_on(session_fire, st, count_out, gap, bnd)
        want = fire_on(session_fire_plain, plain, count_out, gap, bnd)
        torch.cuda.synchronize()
        if not (torch.equal(got.counts, want.counts)
                and np.array_equal(fired_rows(got), fired_rows(want))):
            raise AssertionError(f"session fire round {rnd}: fired rows "
                                 "differ from the plain version's")
        for k in ("start", "end", "open", "count", "dirty"):
            if not torch.equal(st[k], plain[k]):
                raise AssertionError(f"session fire round {rnd}: {k} "
                                     "differs from the plain version's")
        if int(got.counts[1]) == 0:
            break
    rounds = rnd + 1
    if rounds != 2:
        raise AssertionError(f"{n_due} lanes due fired in {rounds} rounds")
    live, live_plain = clone_state(pre), clone_state(pre)
    shapes["q11_fire_cap_2^24"] = {
        "lanes": L, "capacity": cap, "due": n_due, "rounds": rounds,
        "ms": cuda_ms(lambda: fire_on(session_fire, live, count_out, gap,
                                      bnd), torch, flush,
                      setup=lambda: copy_state(live, pre)),
        "plain_ms": cuda_ms(lambda: fire_on(session_fire_plain, live_plain,
                                            count_out, gap, bnd), torch,
                            flush, setup=lambda: copy_state(live_plain, pre)),
        "bound_ms": bound_ms(fire_bytes(pre, n_due, 0)),
        "bound_by": "bytes", "library_ms": None,
        **fire_sectors(torch, pre, live, 0, rates)}
    del st, plain, live, live_plain, pre

    # -- a small signature: sum, min, max, avg; disorder and late rows -------
    sig = (("sum", torch.int64), ("min", torch.int64), ("max", torch.int32),
           ("sum", torch.float32))
    rng = np.random.default_rng(3)
    small_gap, small_cap, small_lanes = 40, 1 << 12, 16
    k_st = session_state(torch, dev, small_cap, small_lanes, sig)
    p_st = clone_state(k_st)

    def sig_out(s):
        (_a, total), (_b, lo), (_c, hi), (_d, mean) = s["folds"]
        return [("count", s["count"]), ("sum", total), ("min", lo),
                ("max", hi), ("avg", mean)]

    boundary, t0, emitted, fired = MIN_TIMESTAMP, 0, 0, 0
    for step in range(12):
        n = 1 << 12
        keys = torch.from_numpy(rng.integers(0, 500, n)).to(dev)
        ts = torch.from_numpy(t0 + np.sort(rng.integers(0, 600, n))
                              + rng.integers(-90, 90, n)).to(dev)
        v = torch.from_numpy(rng.integers(-40, 40, n)).to(dev)
        batch = sort_batch(torch, keys, ts,
                           [v, v, v.to(torch.int32), v.to(torch.float32)])
        before = k_st["dirty"].clone()
        got = step_on(session_step, k_st, batch, small_gap, boundary)
        want = step_on(session_step_plain, p_st, batch, small_gap, boundary)
        torch.cuda.synchronize()
        assert_states_equal(k_st, p_st, f"small step {step}")
        assert_dirty_is_touched(torch, k_st, batch["keys"], before,
                                f"small step {step}")
        if not np.array_equal(emitted_rows(got), emitted_rows(want)):
            raise AssertionError(f"small step {step}: emitted differ")
        emitted += int(got.n)
        t0 += 500
        boundary = t0 + 200   # ahead of the next batch's first rows
        while True:
            got = fire_on(session_fire, k_st, sig_out, small_gap, boundary)
            want = fire_on(session_fire_plain, p_st, sig_out, small_gap,
                           boundary)
            a, b = fired_rows(got), fired_rows(want)
            if not (torch.equal(got.counts, want.counts) and np.array_equal(
                    a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])])):
                raise AssertionError(f"small fire after step {step}: "
                                     "fired rows differ")
            fired += len(a)
            assert_states_equal(k_st, p_st, f"small fire after {step}")
            if int(got.counts[1]) == 0:
                break
    late, dropped = int(k_st["late"]), int(k_st["dropped"])
    if not (late and fired):
        raise AssertionError(f"the small signature saw {late} late rows "
                             f"and fired {fired} sessions")
    return {"max_abs_err": 0, "shapes": shapes,
            "small_signature": {"steps": 12, "late": late,
                                "dropped": dropped, "emitted": emitted,
                                "fired": fired},
            "edges": session_edges(torch, dev) if edges else {}}


def session_checkpoint_phase(torch, dev, c: dict | None = None) -> dict:
    """session-100K with fs checkpoints: the source paced to finish in
    SESS_CKPT_RUN_S seconds, checkpoints every SESS_CKPT_INTERVAL_S. Once
    two checkpoints completed with fires between them, the source pauses
    and the job is cancelled; a fresh job restores from the last checkpoint
    and runs to the end. The rows the first job emitted before that
    checkpoint and the restored job's rows together equal the oracle, and
    no window repeats. Every checkpoint's snapshot through the mirror
    equals the whole-copy snapshot taken at the same point.
    ``c``: another configuration in place of session-100K's."""
    import shutil
    import tempfile

    from flink_tpu_torch.runtime.operators import DeviceSessionWindowOperator

    c = c or session_config("session-100K")
    ckpt_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_sessions_")
    sources, marks, emitted = [], {}, []
    snap = DeviceSessionWindowOperator.snapshot_state

    def marked(self, checkpoint_id):
        out = snap(self, checkpoint_id)
        whole = self.backend.snapshot_plain(checkpoint_id)
        marks[checkpoint_id] = {
            "fires": len(self.fire_latencies_ms), "rows": len(emitted[0]),
            "mirror_equals_whole_copy": snapshot_digest(
                out["keyed"]["backend"]) == snapshot_digest(whole)}
        return out

    DeviceSessionWindowOperator.snapshot_state = marked
    try:
        env, got = session_env(
            torch, dev, c, rate=c["events"] / SESS_CKPT_RUN_S,
            source_hook=sources.append,
            settings={"execution.checkpointing.interval":
                      SESS_CKPT_INTERVAL_S,
                      "execution.checkpointing.dir": ckpt_dir})
        emitted.append(got)
        fresh_memory(torch)
        job = env.execute_async("sessions-checkpointed")
        wait_checkpoints(job, 1)
        wait_checkpoints(job, 1, after=time.time())
        sources[0].set_rate(0)
        job.cancel()
        cp = job.coordinator.latest_checkpoint()
        ids = [s["id"] for s in job.coordinator.stats if not s.get("failed")]
        fires = marks[ids[-1]]["fires"] - marks[ids[0]]["fires"]
        if len(ids) < 2 or not fires or cp.checkpoint_id != ids[-1]:
            raise AssertionError(f"checkpoints {ids} (restoring {cp}) with "
                                 f"{fires} fires between: {marks}")
        if not all(m["mirror_equals_whole_copy"] for m in marks.values()):
            raise AssertionError(f"a session snapshot through the mirror "
                                 f"differs from the whole copy: {marks}")
        before = got[:marks[cp.checkpoint_id]["rows"]]
        del job, env
        env2, got2 = session_env(torch, dev, c)
        env2.restore_from_checkpoint(cp.external_path)
        t2 = time.perf_counter()
        job2 = env2.execute("sessions-restored")
        restore_s = job2.operators[0].first_batch_at - t2
        a, b = session_rows(before), session_rows(got2)
        repeated = (set(map(tuple, a[:, :2].tolist()))
                    & set(map(tuple, b[:, :2].tolist())))
        if repeated:
            raise AssertionError(f"{len(repeated)} session windows repeat "
                                 "after the restore")
        session_check(session_expected(c),
                      [tuple(r[:, i] for i in range(4)) for r in (a, b)])
        return {"checkpoint": c["cell"], "events": c["events"],
                "storage": "FsCheckpointStorage", "checkpoints": ids,
                "marks": marks, "fires_between": fires,
                "restored_from": cp.checkpoint_id,
                "windows_before_checkpoint": len(a),
                "windows_after_restore": len(b), "windows_repeated": 0,
                "restore_to_first_batch_s": restore_s}
    finally:
        DeviceSessionWindowOperator.snapshot_state = snap
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# -- device GROUP BY: the group aggregation kernels and the SQL cells --------
#: the stages of a group aggregation step, each a kernel of csrc/group_agg.cu
GAGG_STAGES = ("first", "compact", "fold", "emit")
GAGG_SYMBOLS = tuple((f"group_agg_{s}", f"group_agg_{s}_kernel")
                     for s in GAGG_STAGES)
GAGG_REL_TOL = 1e-12           # sums of values no float64 holds exactly
#: bench.py::bench_tpch_q1: schema, generator and query (BASELINE config #5)
TPCH_FIELDS = [("l_returnflag", np.int64), ("l_linestatus", np.int64),
               ("l_quantity", np.float64), ("l_extendedprice", np.float64),
               ("l_discount", np.float64), ("l_tax", np.float64),
               ("l_shipdate", np.int64)]
TPCH_Q1_SQL = (
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity) sq, "
    "SUM(l_extendedprice) sp, "
    "SUM(l_extendedprice * (1 - l_discount)) sd, "
    "SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) sc, "
    "AVG(l_quantity) aq, AVG(l_extendedprice) ap, AVG(l_discount) ad, "
    "COUNT(*) co FROM lineitem WHERE l_shipdate <= 19980902 "
    "GROUP BY l_returnflag, l_linestatus")
TPCH_SHIPDATE_MAX = 19980902
TPCH_ROWS = 1 << 25            # BASELINE says 100M rows: cut for the limit
#: the query's output columns: exact ones (integer sums, counts and their
#: quotients) and ones held to GAGG_REL_TOL
TPCH_EXACT = ("sq", "sp", "aq", "ap", "co")
TPCH_TOL = ("sd", "sc", "ad")
#: Nexmark Q17's per-auction aggregates at the north star's 10M keys
GROUPBY_KEYS = 10_000_000
GROUPBY_ROWS = 1 << 24          # cut from 2^25 for the time limit
GROUPBY_SQL = ("SELECT auction, COUNT(*) c, SUM(price) s, MIN(price) mn, "
               "MAX(price) mx, AVG(price) a FROM bid GROUP BY auction")
# over a changelog input the planner sends MIN/MAX to the host's exact
# retraction path, so the retraction run asks the device route's others
GROUPBY_RETRACT_SQL = ("SELECT auction, COUNT(*) c, SUM(price) s, "
                       "AVG(price) a FROM bid_cl GROUP BY auction")
SQL_TIMEOUT_S = 900.0


def tpch_gen(idx) -> dict:
    """bench.py::bench_tpch_q1's generator, on an int64 numpy index."""
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return {"l_returnflag": (u % np.uint64(3)).astype(np.int64),
            "l_linestatus": ((u >> np.uint64(8)) % np.uint64(2)).astype(
                np.int64),
            "l_quantity": ((idx % 50) + 1).astype(np.float64),
            "l_extendedprice": ((idx % 9973) + 1).astype(np.float64),
            "l_discount": (idx % 11).astype(np.float64) / 100.0,
            "l_tax": (idx % 9).astype(np.float64) / 100.0,
            "l_shipdate": 19980101 + (idx % 1400)}


def bid_keys(idx, n_keys: int):
    """bench.py's key mixer (idx * MULT) % n_keys in uint64, numpy."""
    return ((idx.astype(np.uint64) * np.uint64(MULT))
            % np.uint64(n_keys)).astype(np.int64)


def retraction_rows(n_keys: int, n_rows: int, budget: int,
                    seed: int = 17) -> tuple[np.ndarray, np.ndarray]:
    """UPDATE_BEFORE rows for a seeded subset of the keys, at most
    ``budget``: every event of some keys (their groups drain and emit
    DELETE) and one event of others that hold two or more. Returns the
    retracted events' (auction, price), shuffled."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n_rows, dtype=np.int64)
    keys = bid_keys(idx, n_keys)
    counts = np.bincount(keys, minlength=n_keys)
    present = np.flatnonzero(counts)
    chosen = rng.choice(present, size=min(len(present), budget // 4),
                        replace=False)
    drain = chosen[: len(chosen) // 2]
    part = chosen[len(chosen) // 2:]
    part = part[counts[part] >= 2]
    drain = drain[np.cumsum(counts[drain]) <= budget - len(part)]
    ev = idx[np.isin(keys, drain)]
    first = idx[np.isin(keys, part)]
    _, at = np.unique(keys[first], return_index=True)
    ev = np.concatenate([ev, first[at]])
    rng.shuffle(ev)
    return keys[ev], ev % 997 + 1


def bid_gen(n_keys: int, n_rows: int, retract=None):
    """The bid stream: auction by the key mixer, price idx % 997 + 1;
    with ``retract`` = (auction, price), a __rowkind__ column and those
    rows as UPDATE_BEFORE after the first ``n_rows``."""
    def gen(idx):
        out = {"auction": bid_keys(idx, n_keys), "price": idx % 997 + 1}
        if retract is not None:
            tail = idx >= n_rows
            j = np.where(tail, idx - n_rows, 0)
            out["auction"] = np.where(tail, retract[0][j], out["auction"])
            out["price"] = np.where(tail, retract[1][j], out["price"])
            out["__rowkind__"] = np.where(tail, 1, 0).astype(np.int8)
        return out

    return gen


def sql_env(torch, dev, batch: int):
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration

    return StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": batch,
                       "pipeline.auto-watermark-interval": 0}), device=dev)


def run_tpch_q1(torch, dev, n_rows: int = TPCH_ROWS, batch: int = BATCH):
    """bench.py::bench_tpch_q1 through the port: a datagen view and
    TPC-H Q1 by ``TableEnvironment.execute_sql``. Returns (job, result)."""
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.sql import TableEnvironment

    env = sql_env(torch, dev, batch)
    t_env = TableEnvironment(env)
    schema = Schema(TPCH_FIELDS)
    t_env.create_temporary_view(
        "lineitem", env.datagen(tpch_gen, schema, count=n_rows), schema)
    res = t_env.execute_sql(TPCH_Q1_SQL, timeout=SQL_TIMEOUT_S)
    return env.last_job, res


def run_groupby(torch, dev, n_keys: int = GROUPBY_KEYS,
                n_rows: int = GROUPBY_ROWS, batch: int = BATCH,
                retract=None):
    """The 10M-key GROUP BY through ``execute_sql``; with ``retract``
    (``retraction_rows``) the changelog table and its query. Returns
    (job, result)."""
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.sql import TableEnvironment

    env = sql_env(torch, dev, batch)
    t_env = TableEnvironment(env)
    fields = [("auction", np.int64), ("price", np.int64)]
    count = n_rows
    if retract is not None:
        fields.append(("__rowkind__", np.int8))
        count += len(retract[0])
    schema = Schema(fields)
    name = "bid" if retract is None else "bid_cl"
    t_env.create_temporary_view(
        name, env.datagen(bid_gen(n_keys, n_rows, retract), schema,
                          count=count), schema)
    res = t_env.execute_sql(GROUPBY_SQL if retract is None
                            else GROUPBY_RETRACT_SQL, timeout=SQL_TIMEOUT_S)
    return env.last_job, res


def tpch_expected(n_rows: int) -> dict:
    """Numpy oracle of TPC-H Q1 on the generator: (returnflag, linestatus)
    -> the query's columns; sums pairwise over each group's rows."""
    c = tpch_gen(np.arange(n_rows, dtype=np.int64))
    keep = c["l_shipdate"] <= TPCH_SHIPDATE_MAX
    c = {k: v[keep] for k, v in c.items()}
    g = c["l_returnflag"] * 2 + c["l_linestatus"]
    disc = c["l_extendedprice"] * (1 - c["l_discount"])
    out = {}
    for gid in np.unique(g):
        m = g == gid
        co = float(m.sum())
        sq, sp = c["l_quantity"][m].sum(), c["l_extendedprice"][m].sum()
        out[(int(gid) // 2, int(gid) % 2)] = {
            "sq": sq, "sp": sp, "sd": disc[m].sum(),
            "sc": (disc[m] * (1 + c["l_tax"][m])).sum(),
            "aq": sq / co, "ap": sp / co,
            "ad": c["l_discount"][m].sum() / co, "co": co}
    return out


def fold_changelog(batches, key_of, n_keys: int,
                   val_cols: tuple) -> tuple[np.ndarray, np.ndarray, int]:
    """Replays a keyed changelog batch by batch on dense per-key state
    (``key_of(batch)``: each row's key in [0, n_keys)) and holds it to its
    own rules: -U and -D retract exactly the row last emitted for their
    key (bit for bit), +I only for a key not alive, +U only for one
    alive. Returns (values [n_keys, cols], alive, keys that were alive
    once and are not at the end)."""
    state = np.zeros((n_keys, len(val_cols)), np.float64)
    alive = np.zeros(n_keys, bool)
    seen = np.zeros(n_keys, bool)
    for b in batches:
        k = np.asarray(key_of(b)).astype(np.int64)
        kind = np.asarray(b.column("__rowkind__"))
        vals = np.stack([np.asarray(b.column(c), np.float64)
                         for c in val_cols], axis=1)
        r = (kind == 1) | (kind == 3)
        kr = k[r]
        if not alive[kr].all():
            raise AssertionError("a retraction of a key that is not alive")
        if not np.array_equal(state[kr].view(np.int64),
                              vals[r].view(np.int64)):
            raise AssertionError("a retraction differs from the row it "
                                 "retracts")
        alive[k[kind == 3]] = False
        if alive[k[kind == 0]].any() or not alive[k[kind == 2]].all():
            raise AssertionError("+I of a live key or +U of a dead one")
        a = (kind == 0) | (kind == 2)
        state[k[a]] = vals[a]
        alive[k[a]] = True
        seen[k[a]] = True
    return state, alive, int((seen & ~alive).sum())


def tpch_check(expected: dict, res) -> dict:
    """The 6 final groups of ``collect_final`` against the oracle (exact
    where the oracle's value is exact, else GAGG_REL_TOL relative), and
    the changelog's retractions against the rows they retract."""
    names = [f.name for f in res.schema.fields]
    final = {(int(r[0]), int(r[1])): dict(zip(names[2:], r[2:]))
             for r in res.collect_final()}
    if set(final) != set(expected) or len(final) != 6:
        raise AssertionError(f"TPC-H Q1 groups {sorted(final)} != "
                             f"{sorted(expected)}")
    worst = 0.0
    for key, want in expected.items():
        got = final[key]
        for col in TPCH_EXACT:
            if got[col] != want[col]:
                raise AssertionError(f"TPC-H Q1 {key} {col}: {got[col]} != "
                                     f"{want[col]}")
        for col in TPCH_TOL:
            rel = abs(got[col] - want[col]) / abs(want[col])
            worst = max(worst, rel)
            if rel > GAGG_REL_TOL:
                raise AssertionError(f"TPC-H Q1 {key} {col}: {got[col]} vs "
                                     f"{want[col]} (relative {rel})")
    batches = res.batches()
    state, alive, _ = fold_changelog(
        batches, lambda b: b.column("l_returnflag") * 2
        + b.column("l_linestatus"), 6, tuple(names[2:-1]))
    for (rf, ls), want in expected.items():
        got = dict(zip(names[2:-1], state[rf * 2 + ls]))
        if not alive[rf * 2 + ls] or got != final[(rf, ls)]:
            raise AssertionError(f"TPC-H Q1 {(rf, ls)}: the changelog's "
                                 "last row is not the final one")
    return {"groups": len(final), "max_rel_err": worst,
            "changelog_rows": sum(b.n for b in batches)}


def groupby_expected(n_keys: int, n_rows: int, retract=None) -> dict:
    """Numpy oracle of the GROUP BY per auction: count, sum, min, max and
    avg of price over the events, less the retracted ones (min and max
    then unused)."""
    idx = np.arange(n_rows, dtype=np.int64)
    keys, price = bid_keys(idx, n_keys), idx % 997 + 1
    count = np.bincount(keys, minlength=n_keys).astype(np.float64)
    total = np.bincount(keys, weights=price, minlength=n_keys)
    srt = np.sort(keys * 1024 + price)
    sk = srt >> 10
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    ends = np.r_[starts[1:], len(srt)] - 1
    mn = np.full(n_keys, np.nan)
    mx = np.full(n_keys, np.nan)
    mn[sk[starts]] = srt[starts] & 1023
    mx[sk[starts]] = srt[ends] & 1023
    if retract is not None:
        count -= np.bincount(retract[0], minlength=n_keys)
        total -= np.bincount(retract[0], weights=retract[1],
                             minlength=n_keys)
    return {"c": count, "s": total, "mn": mn, "mx": mx,
            "a": np.divide(total, count, out=np.zeros(n_keys),
                           where=count > 0)}


def groupby_check(expected: dict, res, retract=None) -> dict:
    """Every final group against the oracle, exactly (integer sums and
    their quotients), through the changelog replay (``fold_changelog``);
    after retractions the drained groups must be dead."""
    cols = ("c", "s", "a") if retract is not None else ("c", "s", "mn",
                                                        "mx", "a")
    n_keys = len(expected["c"])
    batches = res.batches()
    state, alive, drained = fold_changelog(
        batches, lambda b: b.column("auction"), n_keys, cols)
    want_alive = expected["c"] > 0
    if not np.array_equal(alive, want_alive):
        raise AssertionError(f"{int((alive != want_alive).sum())} groups "
                             "alive or dead against the oracle")
    for j, col in enumerate(cols):
        got, want = state[alive, j], expected[col][alive]
        if not np.array_equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"GROUP BY {col}: {bad} groups differ "
                                 "from the oracle")
    kinds = np.concatenate([np.asarray(b.column("__rowkind__"))
                            for b in batches])
    return {"groups": int(alive.sum()), "changelog_rows": int(len(kinds)),
            "deletes": int((kinds == 3).sum()), "drained": drained}


# -- the group aggregation kernels against their plain versions -------------
GAGG_EDGE_CASES = ("one_key", "drain_in_batch", "drain_across", "specials",
                   "invalid_rows", "ragged", "few_groups_many_tiles",
                   "planes_32", "composite")
#: small cases of the step's two paths (a group of one row in the batch,
#: finished by the compaction; a group of several, folded and emitted)
#: side by side: a slot spread over the whole batch, a group drained and
#: re-inserted within a batch, batches not a multiple of 256 rows,
#: ``n_valid < n``, specials in min and max, 32 planes, batches with
#: nothing to fold, runs of one slot across warps and tiles
GAGG_STEP_CASES = ("slot_spread", "drain_then_reinsert", "odd_batches",
                   "n_valid_short", "specials_mixed", "planes_32_mixed",
                   "nothing_to_fold", "runs_across_warps",
                   "planes_32_one_row_groups")
#: card-sized cases: 2^19 rows on one and on six slots, more distinct slots
#: a fold block meets than its pre-fold table holds, all-distinct rows at
#: 2^24 slots
GAGG_CARD_CASES = ("hot_slot", "six_slots", "prefold_overflow",
                   "distinct_2^24")
#: the fold signature of most edge cases: rc, COUNT, SUM, MIN, MAX, AVG
EDGE_KINDS = ("sum", "sum", "sum", "min", "max", "sum", "sum")
EDGE_COLS = (-1, -1, 0, 0, 0, 0, -1)
PREFOLD_TABLE = 64             # csrc/group_agg.cu's kTable


def _edge_rows(rng, n: int, slots, retract: float = 0.0, vals=None,
               n_valid=None) -> dict:
    slots = np.asarray(slots, np.int32)
    sign = np.where(rng.random(n) < retract, -1.0, 1.0)
    if vals is None:
        vals = rng.integers(-50, 50, (1, n)).astype(np.float64)
    return {"slots": slots, "sign": sign,
            "vals": np.ascontiguousarray(vals, np.float64),
            "n_valid": n if n_valid is None else n_valid}


def _planes_32(c: dict) -> None:
    c["kinds"] = ("sum",) + ("sum", "min", "max", "sum") * 7 + (
        "sum", "min", "max")
    c["cols"] = (-1,) + tuple(-1 if k == "sum" and q % 5 == 4 else q % 4
                              for q, k in enumerate(c["kinds"][1:]))


def gagg_edge_config(case: str) -> dict:
    """Adversarial inputs of the group aggregation step, numpy: capacity,
    plane kinds and value columns, and batches of slots (or ``keys``, two
    integer columns to combine and probe), signs, values and n_valid."""
    cases = GAGG_EDGE_CASES + GAGG_STEP_CASES + GAGG_CARD_CASES
    rng = np.random.default_rng(cases.index(case) + 1)
    c = {"cap": 1 << 10, "kinds": EDGE_KINDS, "cols": EDGE_COLS,
         "batches": []}
    bs = c["batches"]
    if case == "one_key":
        for n in (5000, 5000, 300):
            bs.append(_edge_rows(rng, n, np.full(n, 7), retract=0.2))
    elif case == "drain_in_batch":
        # slot 3 holds 4 rows, then a batch retracts all 4 and inserts one
        # more: the net count stays 1 and no reset happens in between
        bs.append(_edge_rows(rng, 4, [3] * 4, vals=[[5, 6, 7, 8]]))
        b = _edge_rows(rng, 5, [3] * 5, vals=[[5, 6, 7, 8, 2]])
        b["sign"][:4] = -1.0
        bs.append(b)
        bs.append(_edge_rows(rng, 3, [3, 4, 3], vals=[[9, 1, 0]]))
    elif case == "drain_across":
        bs.append(_edge_rows(rng, 6, [1, 2, 1, 2, 1, 9],
                             vals=[[4, -3, 8, 5, 6, 1]]))
        b = _edge_rows(rng, 5, [1, 1, 1, 2, 9], vals=[[4, 8, 6, -3, 1]])
        b["sign"][:] = -1.0          # 1 and 9 drain, 2 keeps one row
        bs.append(b)
        bs.append(_edge_rows(rng, 4, [1, 9, 9, 2], vals=[[50, 7, -7, 0]]))
    elif case == "specials":
        inf, nan = np.inf, np.nan
        sp = [inf, -inf, -0.0, 0.0, nan, 3.0]
        bs.append(_edge_rows(rng, 8, [0, 1, 1, 2, 2, 3, 4, 5], vals=[
            [inf, -0.0, 0.0, 0.0, -0.0, nan, -inf, inf]]))
        bs.append(_edge_rows(rng, 12, rng.integers(0, 6, 12),
                             vals=[rng.choice(sp, 12)]))
        b = _edge_rows(rng, 2, [0, 4], vals=[[inf, -inf]])
        b["sign"][:] = -1.0          # 0 and 4 drain: reset to +-inf
        bs.append(b)
        bs.append(_edge_rows(rng, 4, [0, 4, 0, 4], vals=[
            [inf, -inf, -0.0, 0.0]]))
    elif case == "invalid_rows":
        for n in (700, 700):
            s = rng.integers(0, 5, n)
            s[rng.random(n) < 0.3] = -1
            bs.append(_edge_rows(rng, n, s, retract=0.3, n_valid=n - 37))
    elif case == "ragged":
        for n in (1, 255, 257, 1000, 0):
            bs.append(_edge_rows(rng, n, rng.integers(0, 300, n),
                                 retract=0.2))
    elif case == "few_groups_many_tiles":
        for n in (1 << 16, 1 << 16):
            bs.append(_edge_rows(rng, n, rng.integers(0, 6, n),
                                 retract=0.1))
    elif case == "planes_32":
        _planes_32(c)
        for n in (3000, 3000):
            bs.append(_edge_rows(rng, n, rng.integers(0, 40, n),
                                 retract=0.25,
                                 vals=rng.integers(-9, 9, (4, n))))
    elif case == "composite":
        for n in (2000, 2000):
            k1 = rng.integers(-3, 5, n)
            k2 = rng.integers(0, 7, n) * (1 << 40)
            b = _edge_rows(rng, n, np.zeros(n), retract=0.2)
            b["keys"] = (k1, k2)
            bs.append(b)
    elif case == "slot_spread":
        s = rng.integers(0, 200, 4000)
        s[::7] = 5                   # slot 5 from the first tile to the last
        for order in (s, s[::-1]):
            bs.append(_edge_rows(rng, 4000, order, retract=0.25))
    elif case == "drain_then_reinsert":
        bs.append(_edge_rows(rng, 6, [3, 3, 3, 3, 9, 9],
                             vals=[[5, 6, 7, 8, 4, 2]]))
        # slot 3's four rows retracted (its count passes 0), then inserted
        # again later in the batch: no reset; 9 drains; 4 is new
        b = _edge_rows(rng, 9, [3, 3, 3, 3, 9, 4, 4, 3, 9],
                       vals=[[5, 6, 7, 8, 4, 1, 1, 2, 2]])
        b["sign"][:] = [-1, -1, -1, -1, -1, 1, 1, 1, -1]
        bs.append(b)
        # 9 restarts from the identities
        bs.append(_edge_rows(rng, 4, [9, 3, 9, 4], vals=[[7, 0, -7, 3]]))
    elif case == "odd_batches":
        for n in (3000, 2999, 257):
            bs.append(_edge_rows(rng, n, rng.integers(0, 300, n),
                                 retract=0.2))
    elif case == "n_valid_short":
        for n in (2000, 1500):
            s = rng.integers(0, 64, n)
            s[rng.random(n) < 0.2] = -1
            bs.append(_edge_rows(rng, n, s, retract=0.3, n_valid=n - 663))
    elif case == "specials_mixed":
        sp = [np.inf, -np.inf, -0.0, 0.0, np.nan, 3.0]
        for n, retract in ((24, 0.0), (24, 0.3), (6, 0.5), (12, 0.0)):
            bs.append(_edge_rows(rng, n, rng.integers(0, 12, n),
                                 retract=retract, vals=[rng.choice(sp, n)]))
    elif case == "planes_32_mixed":
        # 32 planes, groups of one row and of several side by side
        _planes_32(c)
        c["cap"] = 1 << 13
        for n in (3000, 3000):
            bs.append(_edge_rows(rng, n, rng.integers(0, 4000, n),
                                 retract=0.25,
                                 vals=rng.integers(-9, 9, (4, n))))
    elif case == "nothing_to_fold":
        # no valid row (n_valid 0), no rows, every slot -1 but a few
        bs.append(_edge_rows(rng, 2000, rng.integers(0, 100, 2000),
                             n_valid=0))
        bs.append(_edge_rows(rng, 0, []))
        s = np.full(500, -1)
        s[[3, 250, 499]] = [7, 7, 8]
        bs.append(_edge_rows(rng, 500, s, retract=0.4))
    elif case == "runs_across_warps":
        # runs of 7 and of 37 rows on one slot, across warp and tile
        # boundaries
        for run in (7, 37):
            s = np.repeat(rng.integers(0, 50, 3000 // run + 1), run)[:3000]
            bs.append(_edge_rows(rng, 3000, s, retract=0.3))
    elif case == "planes_32_one_row_groups":
        # groups of one row (the compaction finishes them) over 32 planes,
        # in 4 chunks of loads; specials in one value column; the second
        # batch meets half of the first's slots again, some to drain, and
        # repeats a few slots
        _planes_32(c)
        c["cap"] = 1 << 14
        sp = np.array([np.inf, -np.inf, -0.0, 0.0, np.nan, 7.0])
        first = rng.choice(c["cap"], 3000, replace=False)
        second = np.concatenate([first[:1500],
                                 rng.choice(c["cap"], 1400, replace=False),
                                 first[:100]])
        for s, retract in ((first, 0.0), (rng.permutation(second), 0.5)):
            vals = rng.integers(-9, 9, (4, s.size)).astype(np.float64)
            vals[3] = rng.choice(sp, s.size)
            bs.append(_edge_rows(rng, s.size, s, retract=retract,
                                 vals=vals))
    elif case in ("hot_slot", "six_slots"):
        for _ in range(2):
            s = (np.full(BATCH, 7) if case == "hot_slot"
                 else rng.integers(0, 6, BATCH) * 131)
            bs.append(_edge_rows(rng, BATCH, s, retract=0.2))
    elif case == "prefold_overflow":
        # every tile of 256 rows holds 64 slots, 4 rows each inside a warp,
        # and no tile shares a slot: a tile pre-folds (64 peer sets), and a
        # fold block that walks more than one tile outgrows its table
        c["cap"] = 1 << 17
        i = np.arange(BATCH)
        s = (i // 256) * PREFOLD_TABLE + (i % 256) // 4
        for _ in range(2):
            bs.append(_edge_rows(rng, BATCH, s, retract=0.2))
    elif case == "distinct_2^24":
        c["cap"] = 1 << 24
        i = np.arange(BATCH, dtype=np.int64)
        # an odd multiplier is a bijection of the slots: every row its own
        # slot; the second batch meets half of the first's slots again
        for shift, retract in ((0, 0.0), (BATCH // 2, 0.5)):
            s = ((i + shift) * 0x9E3779B1 + 12345) & (c["cap"] - 1)
            bs.append(_edge_rows(rng, BATCH, s, retract=retract))
    else:
        raise ValueError(case)
    return c


def combined_keys(cols) -> np.ndarray:
    """The device GROUP BY's combine of integer key columns (the port's
    ``combine_key_columns``)."""
    from flink_tpu_torch.sql.device_group_agg import combine_key_columns

    return combine_key_columns([np.asarray(x, np.int64) for x in cols])


def gagg_state(torch, dev, c: dict) -> dict:
    """Fresh planes (at the state backend's identities), the row scratch
    (and views of its first-row and last-row halves), dirty bitmap and
    hash table of an edge configuration."""
    from flink_tpu_torch.ops.group_agg import new_rowpos
    from flink_tpu_torch.ops.hash_table import make_table
    from flink_tpu_torch.ops.segment_ops import make_accumulator

    cap = c["cap"]
    rowpos = new_rowpos(cap, dev)
    return {"planes": [make_accumulator(k, (cap,), torch.float64, dev)
                       for k in c["kinds"]],
            "rowpos": rowpos, "firstpos": rowpos[:, 0],
            "lastpos": rowpos[:, 1],
            "dirty": torch.zeros(cap // 8 + 1, dtype=torch.uint8,
                                 device=dev),
            "table": make_table(cap, dev)}


def gagg_batch_on(torch, dev, st: dict, b: dict) -> dict:
    """A batch's tensors on ``dev``; ``keys`` batches probe the state's
    table for their slots."""
    from flink_tpu_torch.ops.hash_table import lookup_or_insert

    slots = torch.from_numpy(b["slots"]).to(dev)
    if "keys" in b:
        keys = torch.from_numpy(combined_keys(b["keys"])).to(dev)
        _, slots, ok = lookup_or_insert(st["table"], keys)
        if not bool(ok.all()):
            raise AssertionError("edge table overflow")
    return {"slots": slots.contiguous(),
            "sign": torch.from_numpy(b["sign"]).to(dev),
            "vals": torch.from_numpy(b["vals"]).to(dev),
            "n_valid": b["n_valid"]}


def gagg_step_on(fn, c: dict, st: dict, b: dict):
    return fn(st["planes"], c["kinds"], c["cols"], b["slots"], b["sign"],
              b["vals"], b["n_valid"], st["rowpos"], st["dirty"], 3)


def gagg_outputs(torch, step) -> dict:
    """A step's outputs on the host: groups, row indices, PREV and NEW."""
    g = int(step.n_groups[0])
    return {"groups": g, "row_idx": step.row_idx[:g].cpu().numpy(),
            "comp": step.comp[:g].cpu().numpy()}


def same_bits(a, b) -> bool:
    """Equal float64 arrays, NaN where NaN (any payload), -0.0 apart from
    +0.0."""
    a, b = np.asarray(a), np.asarray(b)
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb) and np.array_equal(
        np.where(na, 0, a).view(np.int64), np.where(nb, 0, b).view(np.int64)))


def check_gagg_edge(torch, dev, case: str) -> dict:
    """An edge case, kernel against plain version on the same inputs:
    groups, row indices, PREV and NEW rows, every plane, the dirty bitmap
    and the row scratch (NO_ROW and NO_LAST everywhere after a step) equal
    bit for bit; one launch of each stage per step of any rows."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.ops.group_agg import NO_LAST, NO_ROW, \
        group_agg_step, group_agg_step_plain

    c = gagg_edge_config(case)
    kst, pst = gagg_state(torch, dev, c), gagg_state(torch, dev, c)
    groups = 0
    for j, raw in enumerate(c["batches"]):
        b = gagg_batch_on(torch, dev, kst, raw)   # one set of slots for both
        reset_launches()
        kstep = gagg_step_on(group_agg_step, c, kst, b)
        launched = {s: KERNEL_LAUNCHES[f"group_agg_{s}"]
                    for s in GAGG_STAGES}
        got = gagg_outputs(torch, kstep)
        want = gagg_outputs(torch, gagg_step_on(group_agg_step_plain, c,
                                                pst, b))
        what = f"group_agg {case} batch {j}"
        if set(launched.values()) != {int(dev.type == "cuda"
                                          and raw["slots"].size > 0)}:
            raise AssertionError(f"{what}: launches {launched}")
        if got["groups"] != want["groups"] or not np.array_equal(
                got["row_idx"], want["row_idx"]):
            raise AssertionError(f"{what}: groups or their rows differ")
        if not same_bits(got["comp"], want["comp"]):
            raise AssertionError(f"{what}: PREV/NEW rows differ")
        for q, (a, b) in enumerate(zip(kst["planes"], pst["planes"])):
            if not same_bits(a.cpu().numpy(), b.cpu().numpy()):
                raise AssertionError(f"{what}: plane {q} differs")
        for name in ("dirty", "rowpos"):
            if not torch.equal(kst[name], pst[name]):
                raise AssertionError(f"{what}: {name} differs")
        if bool((kst["firstpos"] != NO_ROW).any()) or bool(
                (kst["lastpos"] != NO_LAST).any()):
            raise AssertionError(f"{what}: a scratch not restored")
        groups += got["groups"]
    return {"batches": len(c["batches"]), "groups": groups}


def gagg_edges(torch, dev) -> dict:
    return {case: check_gagg_edge(torch, dev, case)
            for case in GAGG_EDGE_CASES + GAGG_STEP_CASES
            + GAGG_CARD_CASES}


def gagg_scratches(ga, cap: int, dev) -> tuple:
    """A step's persistent scratch: (rowpos,); (firstpos,) for an older
    checkout whose step (four whole-batch launches) keeps first rows
    only."""
    if hasattr(ga, "new_rowpos"):
        return (ga.new_rowpos(cap, dev),)
    return (ga.new_firstpos(cap, dev),)


def gagg_call(fn, sh: dict, planes, scratch, dirty):
    """``fn`` (a step or ``make_step``) on a shape's batch, with these
    planes, scratches and dirty bitmap."""
    s = sh["step"]
    return fn(planes, sh["kinds"], sh["cols"], s["slots"], s["sign"],
              s["vals"], s["n_valid"], *scratch, dirty, DIRTY_SHIFT)


def gagg_shape(torch, dev, label: str) -> dict:
    """A main path's step at its real shape: TPC-H Q1's 6th batch after
    its WHERE (12 planes, 5 value columns, capacity 2^16, the 5 batches
    before it folded), or the 10M GROUP BY's 6th batch (7 planes, one
    value column, capacity 2^24)."""
    from flink_tpu_torch.ops import group_agg as ga
    from flink_tpu_torch.ops.hash_table import lookup_or_insert, make_table
    from flink_tpu_torch.ops.segment_ops import make_accumulator

    if label == "tpch_q1":
        cap = 1 << 16
        kinds = ("sum",) * 12
        cols = (-1, 0, 1, 2, 3, 0, -1, 1, -1, 4, -1, -1)
    else:
        cap = 1 << 24
        kinds = ("sum", "sum", "sum", "min", "max", "sum", "sum")
        cols = (-1, -1, 0, 0, 0, 0, -1)

    def batch(b: int) -> dict:
        idx = np.arange(b * BATCH, (b + 1) * BATCH, dtype=np.int64)
        if label == "tpch_q1":
            g = tpch_gen(idx)
            keep = g["l_shipdate"] <= TPCH_SHIPDATE_MAX
            g = {k: v[keep] for k, v in g.items()}
            price, disc = g["l_extendedprice"], g["l_discount"]
            keys = combined_keys([g["l_returnflag"], g["l_linestatus"]])
            vals = np.stack([g["l_quantity"], price, price * (1 - disc),
                             price * (1 - disc) * (1 + g["l_tax"]), disc])
        else:
            keys = bid_keys(idx, GROUPBY_KEYS)
            vals = (idx % 997 + 1).astype(np.float64)[None]
        return {"keys": torch.from_numpy(keys).to(dev),
                "vals": torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
                "sign": torch.ones(len(keys), dtype=torch.float64,
                                   device=dev)}

    table = make_table(cap, dev)
    sh = {"label": label, "cap": cap, "kinds": kinds, "cols": cols,
          "planes": [make_accumulator(k, (cap,), torch.float64, dev)
                     for k in kinds],
          "scratch": gagg_scratches(ga, cap, dev),
          "dirty": torch.zeros((cap >> DIRTY_SHIFT) + 1, dtype=torch.uint8,
                               device=dev)}
    for b in range(STEP_PREFIX + 2):
        raw = batch(b)
        _, slots, ok = lookup_or_insert(table, raw["keys"])
        if not bool(ok.all()):
            raise AssertionError(f"{label}: table overflow")
        sh["step"] = {"slots": slots, "sign": raw["sign"],
                      "vals": raw["vals"], "n_valid": slots.numel()}
        if b <= STEP_PREFIX:
            gagg_call(ga.group_agg_step, sh, sh["planes"], sh["scratch"],
                      sh["dirty"])
    return sh


def gagg_bytes_and_sectors(torch, sh: dict, post_planes: list,
                           rates: dict | None = None) -> dict:
    """Per stage, the bytes it must move (each input read once, each
    output written once, counted on this batch's data: G groups, G1 of
    them one-row groups that the compaction finishes, the dead ones
    written), its 32-byte sector floor and, with ``rates``
    (``sector_rates``), its random sectors at the card's measured rates
    plus its streamed bytes at 3.35 TB/s; and the whole step's bytes,
    sector floor and floor at the measured rates, each group's sectors
    fetched once (the row scratch's by the first stage's atomics, the
    planes' by one read, written back once). A random sector is priced
    by the operation the kernels issue on it: the first stage's atomics
    at red4's rate, a read at read8's, a plane's write-back at red8's
    for a sum and at cas8's for a min or max (the fold's atomics, also
    the compaction's for a one-row group), a drained group's reset at
    store8's."""
    s = sh["step"]
    dev = s["slots"].device
    n, P = s["slots"].numel(), len(sh["planes"])
    slots = s["slots"].to(torch.int64)
    rows = torch.arange(n, device=dev)
    on = slots >= 0
    uniq, inv, counts = torch.unique(slots[on], return_inverse=True,
                                     return_counts=True)
    G = int(uniq.numel())
    first_row = torch.full((G,), n, dtype=torch.int64, device=dev)
    first_row.scatter_reduce_(0, inv, rows[on], "amin")
    gpos = torch.empty(G, dtype=torch.int64, device=dev)
    gpos[torch.argsort(first_row)] = torch.arange(G, device=dev)
    one = counts == 1
    dead = post_planes[0][uniq] <= 0
    G1, D = int(one.sum()), int(dead.sum())
    Dm = int((dead & ~one).sum())
    multi_rows = rows[on][~one[inv]]
    single_rows = rows[on][one[inv]]
    cols = sorted({c for c in sh["cols"] if c >= 0})
    C = len(cols)
    blocks = torch.unique(uniq >> DIRTY_SHIFT)
    nb = int(blocks.numel())
    nb1 = int(torch.unique(uniq[one] >> DIRTY_SHIFT).numel())
    nbm = int(torch.unique(uniq[~one] >> DIRTY_SHIFT).numel())
    Gm, nm = G - G1, int(multi_rows.numel())

    def comp_at(pos, half: int):
        return (pos[:, None] * 2 * P + half * P
                + torch.arange(P, device=dev)[None]).flatten()

    # sector id spaces: 0 slots, 1 rowpos, 2 row_idx, 3 comp, 4 sign,
    # 5 single flags, 6 dirty, 7 n_groups, 8 + c value column c, 64 + q
    # plane q
    slot_s = sector_ids(torch, 0, rows, 4)
    flag_s = sector_ids(torch, 5, rows, 1)

    def rp(idx):
        return sector_ids(torch, 1, idx, 8)

    def row_cols(r) -> list:
        return [sector_ids(torch, 4, r, 8)] + [
            sector_ids(torch, 8 + c, r, 8) for c in cols]

    def planes_at(idx) -> list:
        return [sector_ids(torch, 64 + q, idx, 8) for q in range(P)]

    def dirty_at(idx):
        return sector_ids(torch, 6, torch.unique(idx >> DIRTY_SHIFT), 1)

    u1, um = uniq[one], uniq[~one]
    streamed = {
        "first": 4 * n,
        "compact": 4 * n + n + 4 * G + 8 * P * G + 8 * G1 * (1 + C)
        + 8 * P * G1 + nb1 + 8,
        "fold": 4 * n + n + 8 * nm * (1 + C),
        "emit": 4 * n + n + 8 * P * Gm + nbm}
    stages = {
        "first": (4 * n + 16 * G, [slot_s, rp(uniq)], [rp(uniq)]),
        "compact": (streamed["compact"] + 8 * G + 8 * P * G + 8 * P * G1
                    + 8 * G, [slot_s, rp(uniq)] + planes_at(uniq)
                    + row_cols(single_rows),
                    [sector_ids(torch, 2, gpos, 4),
                     sector_ids(torch, 3, comp_at(gpos, 0), 8),
                     sector_ids(torch, 3, comp_at(gpos[one], 1), 8),
                     flag_s, rp(uniq), dirty_at(u1),
                     sector_ids(torch, 7, gpos[:1], 8)] + planes_at(u1)),
        "fold": (streamed["fold"] + 16 * P * Gm,
                 [slot_s, flag_s] + row_cols(multi_rows) + planes_at(um),
                 planes_at(um)),
        "emit": (streamed["emit"] + 8 * Gm + 8 * P * Gm + 8 * P * Dm
                 + 8 * Gm, [slot_s, flag_s, rp(um)] + planes_at(um),
                 [sector_ids(torch, 3, comp_at(gpos[~one], 1), 8), rp(um),
                  dirty_at(um)] + planes_at(um[dead[~one]])),
    }
    out = {st: {"bytes": nbytes, "bound_ms": bound_ms(nbytes),
                "sector_floor_ms": bound_ms(32 * sector_floor(torch, rd,
                                                              wr))}
           for st, (nbytes, rd, wr) in stages.items()}
    whole = n * (4 + 8 + 8 * C) + 16 * P * G + 4 * G + 16 * P * G + 8 + nb
    rec = {"rows": n, "groups": G, "one_row_groups": G1, "dead": D,
           "planes": P, "value_cols": C, "stages": out, "step_bytes": whole,
           "step_bound_ms": bound_ms(whole),
           "step_sector_floor_ms": bound_ms(32 * sector_floor(
               torch, [slot_s] + row_cols(rows) + [rp(uniq)]
               + planes_at(uniq),
               [sector_ids(torch, 2, gpos, 4),
                sector_ids(torch, 3, torch.cat([comp_at(gpos, 0),
                                                comp_at(gpos, 1)]), 8),
                rp(uniq), dirty_at(uniq)] + planes_at(uniq)))}
    if rates is None:
        return rec

    def per_ms(op: str) -> float:
        return rates["ops"][op]["random"]["g_sectors_per_s"] * 1e6

    def sec(ids) -> int:
        return int(torch.unique(ids).numel())

    def write_back(live: int, dead: int) -> float:
        # live: plane sectors folded by atomics, dead: reset by stores
        return (sums * live / per_ms("red8") + (P - sums) * live
                / per_ms("cas8") + P * dead / per_ms("store8"))

    r_all, r_m = sec(rp(uniq)), sec(rp(um))
    p_all, p_m = (sec(planes_at(x)[0]) for x in (uniq, um))
    p_1l, p_1d, p_ml, p_md = (
        sec(planes_at(x)[0]) for x in (u1[~dead[one]], u1[dead[one]],
                                       um[~dead[~one]], um[dead[~one]]))
    sums = sum(k == "sum" for k in sh["kinds"])
    random = {"first": r_all / per_ms("red4"),
              "compact": (r_all + P * p_all) / per_ms("read8")
              + write_back(p_1l, p_1d),
              "fold": write_back(p_m, 0),
              "emit": (r_m + P * p_m) / per_ms("read8")
              + write_back(0, p_md)}
    for st, ms in random.items():
        out[st]["at_measured_rate_ms"] = ms + bound_ms(streamed[st])
    rec["step_at_measured_rate_ms"] = (
        r_all / per_ms("red4") + P * p_all / per_ms("read8")
        + write_back(p_1l + p_ml, p_1d + p_md)
        + bound_ms(whole - 16 * P * G))
    return rec


def gagg_compare(got: np.ndarray, want: np.ndarray,
                 exact: np.ndarray) -> tuple[float, float]:
    """Kernel values against the plain version's: NaN at the same places,
    equal where ``exact`` (counts, min, max, whole-number sums) or not
    finite, elsewhere the (max absolute, max relative) difference."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        raise AssertionError("NaN where the plain version has none")
    eq = ~nan & (exact | ~np.isfinite(want))
    if not np.array_equal(got[eq], want[eq]):
        raise AssertionError("an exact value differs from the plain "
                             "version's")
    tol = ~nan & ~eq
    diff = np.abs(got[tol] - want[tol])
    if not diff.size:
        return 0.0, 0.0
    return (float(diff.max()),
            float((diff / np.maximum(np.abs(want[tol]), 1e-300)).max()))


def compare_gagg_shape(torch, sh: dict) -> tuple:
    """The step's kernels against its plain version from the shape's
    state: groups and row indices equal, counts, min, max and whole-number
    sums equal, other sums within GAGG_REL_TOL relative, in the PREV/NEW
    rows and in every plane; the dirty bitmaps and both scratches equal.
    Returns (the plain version's planes after the step, max relative
    error, max absolute error)."""
    from flink_tpu_torch.ops import group_agg as ga

    label = sh["label"]
    k_planes = [p.clone() for p in sh["planes"]]
    p_planes = [p.clone() for p in sh["planes"]]
    kscr = tuple(x.clone() for x in sh["scratch"])
    pscr = tuple(x.clone() for x in sh["scratch"])
    kd, pd = sh["dirty"].clone(), sh["dirty"].clone()
    kst = gagg_call(ga.group_agg_step, sh, k_planes, kscr, kd)
    pst = gagg_call(ga.group_agg_step_plain, sh, p_planes, pscr, pd)
    got, want = gagg_outputs(torch, kst), gagg_outputs(torch, pst)
    if got["groups"] != want["groups"] or not np.array_equal(
            got["row_idx"], want["row_idx"]):
        raise AssertionError(f"group_agg {label}: groups differ")
    P = len(sh["planes"])
    err = abs_err = 0.0
    for q in range(P):
        wv = np.concatenate([want["comp"][:, q], want["comp"][:, P + q],
                             p_planes[q].cpu().numpy()])
        gv = np.concatenate([got["comp"][:, q], got["comp"][:, P + q],
                             k_planes[q].cpu().numpy()])
        exact = np.full(wv.shape, sh["kinds"][q] != "sum") | (
            wv == np.round(wv))
        a_err, r_err = gagg_compare(gv, wv, exact)
        abs_err, err = max(abs_err, a_err), max(err, r_err)
    if err > GAGG_REL_TOL:
        raise AssertionError(f"group_agg {label}: relative error {err}")
    if not torch.equal(kd, pd) or not all(
            torch.equal(a, b) for a, b in zip(kscr, pscr)):
        raise AssertionError(f"group_agg {label}: dirty or a scratch "
                             "differs")
    return p_planes, err, abs_err


def gagg_stage_device_ms(torch, step, setup, flush, launches: dict,
                         reps: int = 7) -> dict:
    """Each stage's device ms inside whole steps (its launches summed over
    a step, the mean of ``reps`` steps, each after ``setup`` and the L2
    flush), from the first of up to PROFILE_TRIES profiles that recorded
    every launch of the counters' ``launches`` a step."""
    from torch.autograd import DeviceType

    for tries in range(1, PROFILE_TRIES + 1):
        with card_profile(torch) as prof:
            for _ in range(reps):
                setup()
                flush()
                step()
        got = {s: [0.0, 0] for s in GAGG_STAGES}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            for s in GAGG_STAGES:
                if f"group_agg_{s}_kernel" in e.name:
                    got[s][0] += e.self_device_time_total / 1e3
                    got[s][1] += 1
        if all(got[s][1] == reps * launches[s] for s in GAGG_STAGES):
            break
    else:
        raise AssertionError(f"profiler counted {got} in {reps} steps, the "
                             f"counters {launches} a step")
    return {s: {"ms": ms / reps, "launches": n // reps}
            for s, (ms, n) in got.items()} | {"profiles_taken": tries}


def time_gagg(torch, dev, flush, sh: dict, plain: bool = True) -> dict:
    """The step at a shape, from the shape's state each time: the whole
    step as one ``group_agg_step`` call (the L2 flushed before it only);
    each stage's device ms inside such steps (profiled); each stage alone
    (from the state the stages before it leave, the L2 flushed before it)
    beside its plain version. Works on an older
    checkout's step too (four whole-batch launches)."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.ops import group_agg as ga

    pre = {"planes": sh["planes"], "scratch": sh["scratch"],
           "dirty": sh["dirty"]}
    planes = [p.clone() for p in pre["planes"]]
    scratch = tuple(x.clone() for x in pre["scratch"])
    dirty = pre["dirty"].clone()

    def restore():
        for p, p0 in zip(planes, pre["planes"]):
            p.copy_(p0)
        for x, x0 in zip(scratch, pre["scratch"]):
            x.copy_(x0)
        dirty.copy_(pre["dirty"])

    def step():
        gagg_call(ga.group_agg_step, sh, planes, scratch, dirty)

    restore()
    reset_launches()
    step()
    launches = {s: KERNEL_LAUNCHES[f"group_agg_{s}"] for s in GAGG_STAGES}
    out = {"step_ms": cuda_ms(step, torch, flush, setup=restore),
           "launches_per_step": launches,
           "in_step": gagg_stage_device_ms(torch, step, restore, flush,
                                           launches)}
    if plain:
        out["step_plain_ms"] = cuda_ms(
            lambda: gagg_call(ga.group_agg_step_plain, sh, planes, scratch,
                              dirty), torch, flush, setup=restore)
    alone = {}
    for j, stage in enumerate(GAGG_STAGES):
        restore()
        st = gagg_call(ga.make_step, sh, planes, scratch, dirty)
        for before in GAGG_STAGES[:j]:
            getattr(ga, f"group_agg_{before}")(st)
        mut = [*st.planes, *scratch, st.dirty, st.n_groups] + (
            [st.status] if st.status is not None else [])
        snap = [x.clone() for x in mut]

        def setup(mut=mut, snap=snap):
            for x, x0 in zip(mut, snap):
                x.copy_(x0)

        rec = {"ms": cuda_ms(lambda st=st, s=stage: getattr(
            ga, f"group_agg_{s}")(st), torch, flush, setup=setup)}
        if plain:
            rec["plain_ms"] = cuda_ms(lambda st=st, s=stage: getattr(
                ga, f"group_agg_{s}_plain")(st), torch, flush, setup=setup)
        alone[stage] = rec
        del st, mut, snap
    out["alone"] = alone
    del planes, scratch, dirty
    torch.cuda.empty_cache()
    return out


def gagg_library_ms(torch, flush, sh: dict) -> dict:
    """One PyTorch call for a stage's function at the shape: the first
    stage's first rows by ``scatter_reduce_(..., "amin")`` into firstpos;
    one sum plane's fold (the first value column times the sign) by
    ``index_add_``. The compaction and the emit have none."""
    from flink_tpu_torch.ops.group_agg import NO_ROW

    s = sh["step"]
    idx = s["slots"].to(torch.int64)
    rows = torch.arange(idx.numel(), dtype=torch.int32, device=idx.device)
    fp0 = torch.full((sh["cap"],), NO_ROW, dtype=torch.int32,
                     device=idx.device)
    fp = fp0.clone()
    q = next(q for q, c in enumerate(sh["cols"]) if c >= 0)
    plane0 = sh["planes"][q]
    plane = plane0.clone()
    v = s["vals"][sh["cols"][q]] * s["sign"]
    return {"first": cuda_ms(lambda: fp.scatter_reduce_(0, idx, rows, "amin"),
                             torch, flush, setup=lambda: fp.copy_(fp0)),
            "compact": None,
            "fold": cuda_ms(lambda: plane.index_add_(0, idx, v), torch,
                            flush, setup=lambda: plane.copy_(plane0)),
            "emit": None}


def check_group_agg(torch, dev, flush, rates: dict | None = None,
                    compare: bool = True, edges: bool = True) -> dict:
    """The group aggregation step's kernels at both main paths' shapes
    (``gagg_shape``): against the plain version
    (``compare_gagg_shape``), timed (``time_gagg``: the whole step as one
    call, each stage inside it and alone, beside the plain versions), with
    each stage's byte bound, sector floor and, with ``rates``, its floor at
    the card's measured random rates (``gagg_bytes_and_sectors``), and the
    library calls that compute a stage's function; then the adversarial
    cases (``gagg_edges``). ``compare=False`` (an older checkout's step)
    times only."""
    shapes, worst, worst_abs = {}, 0.0, 0.0
    for label in ("tpch_q1", "groupby_10m"):
        sh = gagg_shape(torch, dev, label)
        record = {}
        if compare:
            p_planes, err, abs_err = compare_gagg_shape(torch, sh)
            record = gagg_bytes_and_sectors(torch, sh, p_planes, rates)
            record.update(max_rel_err=err, max_abs_err=abs_err)
            worst, worst_abs = max(worst, err), max(worst_abs, abs_err)
            del p_planes
            lib = gagg_library_ms(torch, flush, sh)
        t = time_gagg(torch, dev, flush, sh, plain=compare)
        stages = record.setdefault("stages", {s: {} for s in GAGG_STAGES})
        for s in GAGG_STAGES:
            v = stages[s]
            v["ms"] = t["in_step"][s]["ms"]
            v["launches_per_step"] = t["launches_per_step"][s]
            v["alone_ms"] = t["alone"][s]["ms"]
            if compare:
                v["plain_ms"] = t["alone"][s]["plain_ms"]
                v["library_ms"] = lib[s]
                v["share_of_bound"] = v["bound_ms"] / v["ms"]
                v["share_of_sector_floor"] = v["sector_floor_ms"] / v["ms"]
        record["step_ms"] = t["step_ms"]
        record["profiles_taken"] = t["in_step"]["profiles_taken"]
        if compare:
            record["step_plain_ms"] = t["step_plain_ms"]
            record["step_share_of_bound"] = (record["step_bound_ms"]
                                             / t["step_ms"])
        shapes[label] = record
        del sh
        torch.cuda.empty_cache()
    out = {"shapes": shapes}
    if compare:
        out.update(max_rel_err=worst, max_abs_err=worst_abs,
                   tolerance=GAGG_REL_TOL)
    if edges:
        out["edges"] = gagg_edges(torch, dev)
    return out


# -- the SQL cells -------------------------------------------------------------
def sql_operators(job) -> tuple:
    """The run's device GROUP BY operator and its batch operators."""
    from flink_tpu_torch.runtime.operators.simple import BatchFnOperator
    from flink_tpu_torch.sql.device_group_agg import DeviceGroupAggOperator

    ops = job.operators
    agg = [op for op in ops if isinstance(op, DeviceGroupAggOperator)]
    if len(agg) != 1:
        raise AssertionError(f"{len(agg)} device GROUP BY operators in the "
                             "plan; expected one")
    return agg[0], [op for op in ops if isinstance(op, BatchFnOperator)]


def sql_profile(torch, run) -> dict:
    """A run under torch.profiler: the card's busy time by kernel against
    the run's wall time; the profiler's count of each group aggregation
    kernel must equal its launch counter."""
    from torch.autograd import DeviceType

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    symbols = GAGG_SYMBOLS + (("hash_probe", "hash_probe_kernel"),)
    for tries in range(1, PROFILE_TRIES + 1):
        reset_launches()
        with card_profile(torch, host=True) as prof:
            job, _res = run()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                acc = by_name.setdefault(e.name[:90], [0.0, 0])
                acc[0] += e.self_device_time_total / 1e3
                acc[1] += 1
        counted = {k: sum(n for name, (_ms, n) in by_name.items()
                          if sym in name) for k, sym in GAGG_SYMBOLS}
        if all(n == KERNEL_LAUNCHES[k] for k, n in counted.items()):
            break
    else:
        raise ProfileRecordsLost(f"profiler counted {counted}, the "
                                 f"counters {dict(KERNEL_LAUNCHES)}")
    busy = sum(ms for ms, _n in by_name.values())
    wall = job.wall_s * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if wall else None,
            "profiles_taken": tries,
            "kernel_ms": {k: sum(ms for name, (ms, _n) in by_name.items()
                                 if sym in name) for k, sym in symbols},
            "top": [{"name": k, "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def sql_run_record(torch, label: str, run, check, n_rows: int) -> dict:
    """One run of a SQL cell with the launch counters zeroed just before
    and read just after: every stage of the group aggregation step once
    per batch of the device GROUP BY (at least once), the probe at least
    once a batch, the result held to its oracle; rows/s, host seconds per
    batch by part, rehashes and peak device memory."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    start = fresh_memory(torch)
    reset_launches()
    job, res = run()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    agg, batch_ops = sql_operators(job)
    batches = agg.stats["batches"]
    stage_launches = {f"group_agg_{s}": launches[f"group_agg_{s}"]
                      for s in GAGG_STAGES}
    if batches < 1 or set(stage_launches.values()) != {batches} \
            or launches["hash_probe"] < batches:
        raise AssertionError(f"{label}: launches {launches} for {batches} "
                             "device GROUP BY batches")
    checked = check(res)
    host = {k: v / batches for k, v in agg.stats.items()
            if k.endswith("_s")}
    calc = {}
    for op in batch_ops:
        calc[op.name] = calc.get(op.name, 0.0) + op.busy_s / batches
    return {"cell": label, "rows": n_rows, "wall_s": job.wall_s,
            "rows_per_sec": n_rows / job.wall_s, "batches": batches,
            "groups_emitted": agg.stats["groups"],
            "host_s_per_batch": {**calc, **host,
                                 "total": sum(calc.values())
                                 + sum(host.values())},
            "rehashes": list(agg.rehashes),
            "capacity": agg.backend.capacity,
            "launches": launches, "max_memory_allocated": peak,
            "memory_at_start": start, "tasks": task_record(job),
            "check": checked}


def sql_tpch_q1_phase(torch, dev) -> dict:
    """BASELINE config #5: TPC-H Q1 at TPCH_ROWS rows in batches of
    2^19 through execute_sql; a warm-up of 4 batches, a timed run held to
    the oracle, and a profiled one."""
    expected = tpch_expected(TPCH_ROWS)
    run_tpch_q1(torch, dev, 4 * BATCH)
    rec = sql_run_record(torch, "sql_tpch_q1",
                         lambda: run_tpch_q1(torch, dev),
                         lambda res: tpch_check(expected, res), TPCH_ROWS)
    rec["profile"] = cell_profile(torch, dev, "sql_tpch_q1")
    return {"sql_tpch_q1": rec}


def sql_groupby_phase(torch, dev) -> dict:
    """The 10M-key GROUP BY: the query at GROUPBY_ROWS events, timed and
    held group by group to the oracle, then profiled; then the changelog
    table with one batch of UPDATE_BEFORE rows (some groups drain and emit
    DELETE), held to the oracle less the retracted events."""
    expected = groupby_expected(GROUPBY_KEYS, GROUPBY_ROWS)
    run_groupby(torch, dev, n_rows=4 * BATCH)
    rec = sql_run_record(torch, "sql_groupby_10m",
                         lambda: run_groupby(torch, dev),
                         lambda res: groupby_check(expected, res),
                         GROUPBY_ROWS)
    rec["profile"] = cell_profile(torch, dev, "sql_groupby_10m")
    del expected
    retract = retraction_rows(GROUPBY_KEYS, GROUPBY_ROWS, BATCH)
    expected = groupby_expected(GROUPBY_KEYS, GROUPBY_ROWS, retract)
    rec["retraction_run"] = sql_run_record(
        torch, "sql_groupby_10m retractions",
        lambda: run_groupby(torch, dev, retract=retract),
        lambda res: groupby_check(expected, res, retract),
        GROUPBY_ROWS + len(retract[0]))
    rec["retraction_run"]["retracted_rows"] = len(retract[0])
    if rec["retraction_run"]["check"]["deletes"] == 0:
        raise AssertionError("the retraction batch drained no group")
    return {"sql_groupby_10m": rec}


# -- device list state and the interval join (Q7 join) ---------------------
LIST_KERNELS = ("list_append", "list_probe", "list_prune")
#: kernel -> the launch's CUDA kernels (the profiler names them so)
LIST_SYMBOLS = (("list_append", "list_append_kernel"),
                ("list_probe", "list_probe_kernel"),
                ("list_prune", "list_prune_kernel"))
#: the CUDA kernels of one launch of each
LIST_PARTS = {"list_append": ("list_append_kernel",),
              "list_probe": ("list_probe_kernel",),
              "list_prune": ("list_prune_kernel",)}
LIST_EDGE_CASES = ("hot_key_past_L", "duplicates", "ragged", "drop_all",
                   "lo_hi_exact", "float_columns", "unsorted_prune",
                   "wide_list", "one_row", "probe_room")
Q7J_PANE_MS, Q7J_PANES, Q7J_BATCH = 10_000, 8, 1 << 15
Q7J_ROWS_PER_KEY = 32          # bench.py's rows_per_key
Q7J_RUNS = 1                   # timed runs of each join cell
#: bench.py::bench_framework_q7_join (:590-677), and the same job at 10M
#: auctions; the 10M cell's bids are device batches (datagen(device=True))
Q7J_CELLS = {
    "q7_join_ref": {"auctions": 100_000, "bids": 1 << 18,
                    "window_capacity": 1 << 18, "store_capacity": 1 << 18,
                    "device_batches": False},
    "q7_join_10m": {"auctions": 10_000_000, "bids": 1 << 25,
                    "window_capacity": 1 << 24, "store_capacity": 1 << 25,
                    "device_batches": True},
}


def _list_batch(rng, n: int, pool, t0: int = 0, span: int = 1000,
                dtypes=(np.int64, np.float64)) -> tuple:
    keys = np.asarray(pool)[rng.integers(0, len(pool), n)].astype(np.int64)
    ts = np.sort(rng.integers(t0, t0 + span, n)).astype(np.int64)
    cols = []
    for d in dtypes:
        d = np.dtype(d)
        if d.kind == "f":
            cols.append((rng.integers(-64, 64, n) / 8.0).astype(d))
        elif d.kind == "b":
            cols.append(rng.random(n) < 0.5)
        else:
            cols.append(rng.integers(-1000, 1000, n).astype(d))
    return keys, ts, cols


def list_edge_config(case: str) -> dict:
    """An adversarial sequence of list operations: ("append", keys, ts,
    cols), ("prune", horizon), ("probe", keys, ts, lo_off, hi_off[,
    room]) and ("probe_batch", keys), on a state of ``capacity`` slots
    and ``L`` rows a key that never needs to grow. ``room``: the kernel's
    output has room for M + room matches (M the probe's), so 0 puts M at
    the room and -1 one past it (the launch runs again); a store ignores
    it."""
    rng = np.random.default_rng(LIST_EDGE_CASES.index(case) + 40)
    dtypes = [np.dtype(np.int64), np.dtype(np.float64)]
    cap, L, ops = 1 << 12, 32, []
    if case == "hot_key_past_L":
        # one key 40 times in one batch among others: the first L - 3 of
        # its rows (batch order) fit behind the 3 it holds, then overflow
        L = 8
        k, t, c = _list_batch(rng, 3, [7])
        ops.append(("append", k, t, c))
        k, t, c = _list_batch(rng, 60, [7, 7, 7, 1, 2], t0=1000)
        ops += [("append", k, t, c), ("probe_batch", np.array([7, 1, 2]))]
    elif case == "duplicates":
        L = 128
        for i, n in enumerate((1000, 1, 777)):
            ops.append(("append", *_list_batch(rng, n, np.arange(50),
                                               t0=1000 * i)))
        ops += [("probe", np.arange(-3, 53), np.full(56, 1500), -600, 600),
                ("prune", 800), ("probe_batch", np.arange(50))]
    elif case == "ragged":
        pool = rng.integers(-(1 << 62), 1 << 62, 3000)
        pool[:3] = [0, -1, INT64_MAX]        # INT64_MAX: the sanitised key
        for i, n in enumerate((1, 255, 257, 4097, 31)):
            ops.append(("append", *_list_batch(rng, n, pool[:1500 + 300 * i],
                                               t0=100 * i, span=300)))
        probe = pool[rng.integers(0, 3000, 2000)]
        ops += [("probe", probe, rng.integers(0, 800, 2000), -100, 50),
                ("probe_batch", probe)]
    elif case == "drop_all":
        k, t, c = _list_batch(rng, 3000, np.arange(800))
        ops += [("append", k, t, c), ("prune", 1 << 40),
                ("probe_batch", np.arange(800)),
                ("append", *_list_batch(rng, 500, np.arange(1200),
                                        t0=1 << 41)),
                ("probe_batch", np.arange(1200))]
    elif case == "lo_hi_exact":
        k, t, c = _list_batch(rng, 2000, np.arange(300))
        pk = k[rng.integers(0, 2000, 1000)]
        at = t[rng.integers(0, 2000, 1000)]
        ops += [("append", k, t, c), ("probe", pk, at, 0, 0),
                ("probe", pk, at + 10, -10, -10), ("probe", pk, at, -5, 7),
                ("probe", pk, at, 3, 2)]
    elif case == "float_columns":
        dtypes = [np.dtype(np.float32), np.dtype(np.float64),
                  np.dtype(np.bool_), np.dtype(np.int32)]
        k, t, c = _list_batch(rng, 1500, np.arange(200), dtypes=dtypes)
        c[0][:4] = [np.inf, -0.0, np.nan, 1e-30]
        c[1][:4] = [np.nan, -np.inf, 1e300, -0.0]
        ops += [("append", k, t, c), ("probe_batch", np.arange(200)),
                ("prune", 500), ("probe", k, t, -200, 200)]
    elif case == "unsorted_prune":
        # lists out of ts order, two chunks of 32 a list: the move pass
        L = 64
        k, t, c = _list_batch(rng, 6000, np.arange(150))
        perm = rng.permutation(6000)
        ops += [("append", k[perm], t[perm], [x[perm] for x in c]),
                ("prune", 400), ("probe_batch", np.arange(150)),
                ("prune", 700), ("probe", k, t, -50, 50)]
    elif case == "wide_list":
        # 256 rows of 9 columns: 18 KiB of shared memory a warp
        L, dtypes = 256, [np.dtype(np.int64)] * 8
        k, t, c = _list_batch(rng, 5000, np.arange(40), dtypes=dtypes)
        perm = rng.permutation(5000)
        ops += [("append", k[perm], t[perm], [x[perm] for x in c]),
                ("prune", 333), ("probe_batch", np.arange(40)),
                ("probe", k[:700], t[:700], -100, 100)]
    elif case == "one_row":
        ops += [("append", *_list_batch(rng, 1, [5])),
                ("probe", np.array([5]), np.array([0]), -10000, 10000),
                ("prune", 1 << 20), ("probe_batch", np.array([5]))]
    elif case == "probe_room":
        # the probe's output room: M at 0, M at the room and one past it,
        # lists of about 50 rows (past the 32 of the kernel's match mask)
        L = 128
        k, t, c = _list_batch(rng, 3000, np.arange(60))
        ops += [("append", k, t, c),
                ("probe", np.arange(60), np.full(60, 5000), 0, 10, 0),
                ("probe", k[:500], t[:500], -100, 100, 0),
                ("probe", k[:500], t[:500], -100, 100, -1),
                ("probe", k[:40], t[:40], -2000, 2000, -1),
                ("probe_batch", np.arange(60))]
    else:
        raise ValueError(case)
    return {"dtypes": dtypes, "capacity": cap, "L": L, "ops": ops}


def apply_list_op(store, op):
    """One operation on a list store of either package; the probes'
    results as plain lists (matches in order; each key's live rows)."""
    kind = op[0]
    if kind == "append":
        store.append_batch(*op[1:])
        return None
    if kind == "prune":
        store.prune(op[1])
        return None
    keys = np.asarray(op[1], np.int64)
    if kind == "probe" and hasattr(store, "probe_range"):
        import torch
        ts = np.asarray(op[2], np.int64)
        bi, packed = store.probe_range(
            torch.from_numpy(keys).to(store.device),
            torch.from_numpy(ts).to(store.device), op[3], op[4],
            int(ts.min()), int(ts.max()))
        return bi.cpu().tolist(), packed.cpu().tolist()
    packed, counts = store.probe_batch(keys)
    if kind == "probe":      # the reference: the join's host mask
        ts = np.asarray(op[2], np.int64)
        ots = packed[:, :, 0]
        m = (np.arange(packed.shape[1])[None, :] < counts[:, None]) \
            & (ots >= (ts + op[3])[:, None]) & (ots <= (ts + op[4])[:, None])
        bi, li = np.nonzero(m)
        return bi.tolist(), packed[bi, li].tolist()
    return counts.tolist(), [packed[b, :c].tolist()
                             for b, c in enumerate(counts)]


def list_state(torch, dev, cap: int, L: int, C: int) -> dict:
    """An empty list state: table, rows (not cleared: a claim writes a
    whole list), counts, the tile summary, and the zero scratch."""
    from flink_tpu_torch.ops.device_lists import make_tiles
    from flink_tpu_torch.ops.hash_table import make_table

    return {"table": make_table(cap, dev),
            "rows": torch.empty((cap, L, C), dtype=torch.int64, device=dev),
            "counts": torch.zeros(cap, dtype=torch.int32, device=dev),
            "tiles": make_tiles(cap, dev),
            "hits": torch.zeros(cap, dtype=torch.int64, device=dev)}


def check_tiles(torch, st: dict, what: str, exact: bool = False) -> dict:
    """A state's tile summary against the one its rows and counts give:
    each tile's live slots equal, and its bounds hold every live row's ts
    (``exact``: equal them, as the plain versions keep them). Returns the
    tiles whose bounds are wider than their rows'."""
    from flink_tpu_torch.ops.device_lists import tile_summary

    t = st["tiles"]
    want = tile_summary(st["rows"], st["counts"], t.shape[1])
    live = want[2] > 0
    if not torch.equal(t[2], want[2]):
        raise AssertionError(f"{what}: the tiles' live slots differ from "
                             "the counts'")
    if exact and not torch.equal(t, want):
        raise AssertionError(f"{what}: the tile bounds are not exact")
    if bool((t[0][live] > want[0][live]).any()
            or (t[1][live] < want[1][live]).any()):
        raise AssertionError(f"{what}: a live row lies outside its tile's "
                             "bounds")
    loose = live & ((t[0] < want[0]) | (t[1] > want[1]))
    return {"tiles": t.shape[1], "live_tiles": int(live.sum()),
            "loose_tiles": int(loose.sum())}


def lists_equal_by_key(torch, a: dict, b: dict, what: str,
                       chunk: int = 1 << 20) -> int:
    """Every occupied key of two list states, its count and its whole
    [L, C] list (the snapshot's fields) equal, key by key, a chunk of
    keys at a time. Returns the keys."""
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY

    def by_key(st):
        slots = torch.nonzero(st["table"] != EMPTY_KEY).flatten()
        keys = st["table"][slots]
        order = torch.argsort(keys)
        return keys[order], slots[order]

    (ka, sa), (kb, sb) = by_key(a), by_key(b)
    if not (torch.equal(ka, kb)
            and torch.equal(a["counts"][sa], b["counts"][sb])):
        raise AssertionError(f"{what}: keys or counts differ")
    for i in range(0, sa.numel(), chunk):
        if not torch.equal(a["rows"][sa[i:i + chunk]],
                           b["rows"][sb[i:i + chunk]]):
            raise AssertionError(f"{what}: lists differ")
    return int(ka.numel())


def _packed_on(torch, dev, ts, cols, dtypes):
    from flink_tpu_torch.state.device_lists import pack_columns

    return pack_columns(torch.from_numpy(np.asarray(ts, np.int64)),
                        [torch.from_numpy(np.ascontiguousarray(c))
                         for c in cols], dtypes).to(dev)


def check_list_edge(torch, dev, case: str) -> dict:
    """One ``LIST_EDGE_CASES`` sequence through the kernels and, on a
    second state, through the plain versions, on the card: after every
    operation the flags, failed rows, probe outputs (in order), live
    counts, and every key's whole list (rows past its count too) equal,
    the kernels' tile summary holding their rows (the plain one exact
    after a prune), and the kernels' scratch back at zero. A probe with a
    ``room`` gives the kernel room for M + room matches (else the batch's
    rows), and must launch again when that is below M."""
    from flink_tpu_torch import KERNEL_LAUNCHES
    from flink_tpu_torch.ops import device_lists as dl

    c = list_edge_config(case)
    C = 1 + len(c["dtypes"])
    k = list_state(torch, dev, c["capacity"], c["L"], C)
    p = list_state(torch, dev, c["capacity"], c["L"], C)
    plain_args = ("table", "rows", "counts", "tiles")
    for i, op in enumerate(c["ops"]):
        what = f"list edge {case} op {i} ({op[0]})"
        if op[0] == "append":
            keys = torch.from_numpy(op[1]).to(dev)
            packed = _packed_on(torch, dev, op[2], op[3], c["dtypes"])
            fk, xk = dl.list_append(*(k[n] for n in plain_args), k["hits"],
                                    keys, packed)
            fp, xp = dl.list_append_plain(*(p[n] for n in plain_args),
                                          keys, packed)
            same = (fk.tolist() == fp.tolist()
                    and torch.equal(xk.cpu(), xp.cpu()))
        elif op[0] == "prune":
            same = int(dl.list_prune(k["rows"], k["counts"], k["tiles"],
                                     k["hits"], op[1])) \
                == int(dl.list_prune_plain(p["rows"], p["counts"],
                                           p["tiles"], op[1]))
        else:
            keys = torch.from_numpy(np.asarray(op[1], np.int64)).to(dev)
            ts = (torch.from_numpy(np.asarray(op[2], np.int64)).to(dev)
                  if op[0] == "probe" else None)
            rng = op[3:5] if op[0] == "probe" else (0, 0)
            want = dl.list_probe_plain(p["table"], p["rows"], p["counts"],
                                       keys, ts, *rng)
            room = (int(want[0].numel()) + op[5] if len(op) > 5 else None)
            before = KERNEL_LAUNCHES["list_probe"]
            got = dl.list_probe(k["table"], k["rows"], k["counts"], keys,
                                ts, *rng, capacity=room)
            launches = KERNEL_LAUNCHES["list_probe"] - before
            # the default room is the batch's rows
            again = want[0].numel() > (keys.numel() if room is None
                                       else room)
            if launches != 1 + again:
                raise AssertionError(f"{what}: {launches} launches at room "
                                     f"{room} for {want[0].numel()} matches")
            same = all(torch.equal(g.cpu(), w.cpu())
                       for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"{what}: kernel and plain version differ")
        lists_equal_by_key(torch, k, p, what)
        check_tiles(torch, k, what)
        check_tiles(torch, p, what, exact=True)
        if bool((k["hits"] != 0).any()):
            raise AssertionError(f"{what}: the scratch is not zero again")
    return {"ops": len(c["ops"]), "L": c["L"], "C": C}


def list_snapshots_equal(a: dict, b: dict) -> bool:
    """Two list snapshots equal field by field after a canonical sort by
    key."""
    def canon(s):
        order = np.argsort(np.asarray(s["keys"]), kind="stable")
        return [np.asarray(s[f])[order] for f in ("keys", "key_groups",
                                                   "rows", "counts")]
    if any(a[f] != b[f] for f in ("kind", "L", "C", "dtypes")):
        return False
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(canon(a), canon(b)))


def list_store_ops(seed: int) -> list:
    """A seeded sequence of list-store operations with a watermark after
    every batch, for stores of L = 16 rows from 64 slots: batches with
    in-batch duplicates and rows out of ts order over a key pool that
    grows (rehashes), a hot key past L (the overflow), prunes below every
    list, inside them, at the same horizon again and above every list (a
    dead-key rebuild, then skipped prunes of the emptied store), probes,
    and a restore from the store's own snapshot ("restore")."""
    rng = np.random.default_rng(seed)
    ops, t = [], 0
    for step in range(28):
        pool = np.arange(30 + 12 * step)
        n = int(rng.integers(1, 90))
        k, ts, c = _list_batch(rng, n, pool, t0=t, span=300)
        perm = rng.permutation(n)
        ops.append(("append", k[perm], ts[perm], [x[perm] for x in c]))
        if step == 9:
            k, ts, c = _list_batch(rng, 20, [7], t0=t, span=50)
            ops.append(("append", k, ts, c))         # past L: overflow
        if step == 14:
            ops.append(("restore",))
        if step in (18, 19, 20):
            horizon = t + (1 << 40)                  # above every list
        elif step % 7 == 3:
            horizon = -(1 << 40)                     # below every list
        elif step % 5 == 4:
            horizon = ops[-2][1] if ops[-2][0] == "prune" else t - 400
        else:
            horizon = t - int(rng.integers(100, 400))
        ops.append(("prune", horizon))
        if step % 6 == 5:
            ops.append(("probe", pool, rng.integers(t - 300, t + 300,
                                                    len(pool)), -150, 50))
        t += 100
    ops.append(("probe_batch", np.arange(400)))
    return ops


def list_probe_skip_ops(seed: int) -> list:
    """A seeded sequence of list-store operations for stores of L = 16
    rows from 64 slots, with probes after every step whose batch interval
    [ts_min + lo_off, ts_max + hi_off] lies before the live rows' ts, ends
    on their least, spans them, starts on their largest and lies after
    them, a probe_batch, and ("skipped", n): the probes the store has
    skipped so far. Appends (one grows the table), prunes at a live row's
    ts (so the store's bounds stay the live rows' own), a dead-key
    rebuild, a prune past every row (the store empties: every probe
    skips), then appends, and a restore ("restore"; the new store skips
    no probe until its next append)."""
    rng = np.random.default_rng(seed)
    lo_off, hi_off = -20, 30
    ops, live, known, skipped = [], [], True, 0

    def append(keys, t0, span):
        nonlocal known
        n = len(keys)
        ts = np.sort(rng.integers(t0, t0 + span, n)).astype(np.int64)
        cols = [rng.integers(-1000, 1000, n).astype(np.int64),
                rng.integers(-64, 64, n) / 8.0]
        perm = rng.permutation(n)
        ops.append(("append", np.asarray(keys, np.int64)[perm], ts[perm],
                    [c[perm] for c in cols]))
        live.append(ts)
        known = True

    def prune(horizon):
        ops.append(("prune", int(horizon)))
        live[:] = [t[t >= horizon] for t in live]

    def ts_of():
        return np.concatenate(live) if live else np.zeros(0, np.int64)

    def probes(pool):
        nonlocal skipped
        ts = ts_of()
        empty = ts.size == 0
        lo, hi = (int(ts.min()), int(ts.max())) if not empty else (0, 0)
        keys = np.asarray(pool)[rng.integers(0, len(pool), 48)]
        for a, b in ((lo - 100, lo - 1), (lo - 100, lo), (lo - 50, hi + 50),
                     (hi, hi + 100), (hi + 1, hi + 100)):
            t = np.sort(rng.integers(a - lo_off, b - hi_off + 1, 48))
            t[0], t[-1] = a - lo_off, b - hi_off
            ops.append(("probe", keys, t.astype(np.int64), lo_off, hi_off))
            skipped += empty or (known and (b < lo or a > hi))
        ops.append(("probe_batch", keys))
        skipped += empty
        ops.append(("skipped", skipped))

    pool = np.arange(50)
    append(rng.integers(0, 30, 40), 1000, 300)
    probes(pool)
    append(rng.integers(0, 50, 40), 1200, 400)      # the table grows
    probes(pool)
    prune(np.sort(ts_of())[len(ts_of()) // 3])
    probes(pool)
    old = rng.permutation(np.arange(1000, 1150))
    append(old, 100, 100)                           # 150 keys, ts below
    probes(np.r_[pool, old])
    prune(int(ts_of()[ts_of() >= 1000].min()))      # a dead-key rebuild
    probes(np.r_[pool, old])
    prune(int(ts_of().max()) + 1)                   # the store empties
    probes(pool)
    append(rng.integers(0, 40, 30), 3000, 200)
    probes(pool)
    append(rng.integers(0, 40, 20), 2900, 600)
    probes(pool)
    ops.append(("restore",))
    known, skipped = False, 0
    probes(pool)
    prune(np.sort(ts_of())[len(ts_of()) // 4])
    probes(pool)
    append(rng.integers(0, 40, 20), 3400, 200)
    probes(pool)
    return ops


def check_list_store(torch, dev) -> dict:
    """A DeviceListStore on the card and one on the CPU through
    ``list_store_ops`` (two seeds), ``list_probe_skip_ops`` (two seeds)
    and the earlier fixed sequence (appends with in-batch duplicates and
    a hot key, probes, prunes, rehashes from 64 slots, a dead-key
    rebuild): every probe and every raised overflow equal, the snapshots
    equal field by field after each step, the card's tile summary holding
    its rows and the CPU's exact after a prune that reloaded nothing, the
    stats (prunes and probes run and skipped, rebuilds, rehashes) equal,
    and the probes skipped those the sequence expects."""
    from flink_tpu_torch.core import KeyGroupRange
    from flink_tpu_torch.state.device_lists import DeviceListStore

    dtypes = [np.dtype(np.int64), np.dtype(np.float64)]
    rng = np.random.default_rng(77)
    fixed = [("append", *_list_batch(rng, n, np.arange(700), t0=200 * i))
             for i, n in enumerate((300, 64, 1000, 5, 900))]
    fixed += [("probe", np.arange(800), rng.integers(0, 1000, 800), -150, 0),
              ("prune", 500), ("probe_batch", np.arange(750)),
              ("append", *_list_batch(rng, 400, np.arange(690, 900),
                                      t0=2000)),
              ("prune", 1900), ("probe_batch", np.arange(950))]
    out: dict = {"ops": 0, "loose_tiles": 0}

    def tally(name: str, stores: list) -> None:
        if stores[0].stats != stores[1].stats:
            raise AssertionError(f"list store {name}: stats "
                                 f"{stores[0].stats} on the card, "
                                 f"{stores[1].stats} on the CPU")
        for k, v in stores[0].stats.items():
            out[k] = out.get(k, 0) + v
            out.setdefault(name, {})[k] = out.get(name, {}).get(k, 0) + v

    for name, ops in (("fixed", fixed), ("seed 1", list_store_ops(1)),
                      ("seed 2", list_store_ops(2)),
                      ("skips 1", list_probe_skip_ops(1)),
                      ("skips 2", list_probe_skip_ops(2))):
        stores = [DeviceListStore(KeyGroupRange(0, 127), MAXP, dtypes,
                                  capacity=64, rows_per_key=16, device=d)
                  for d in (dev, "cpu")]
        for i, op in enumerate(ops):
            what = f"list store {name} op {i} ({op[0]})"
            before = dict(stores[1].stats)
            if op[0] == "skipped":
                if any(st.stats["probes_skipped"] != op[1]
                       for st in stores):
                    raise AssertionError(f"{what}: probes skipped "
                                         f"{[st.stats for st in stores]}, "
                                         f"{op[1]} expected")
                continue
            if op[0] == "restore":
                tally(name, stores)
                snap = stores[1].snapshot()
                stores = [DeviceListStore.from_snapshots(
                    KeyGroupRange(0, 127), MAXP, [snap], capacity=64,
                    device=d) for d in (dev, "cpu")]
                outs = [None, None]
            else:
                outs = []
                for st in stores:
                    try:
                        outs.append(apply_list_op(st, op))
                    except RuntimeError as e:
                        outs.append(("raised", str(e)))
            if outs[0] != outs[1]:
                raise AssertionError(f"{what}: the card and the CPU differ")
            if not list_snapshots_equal(stores[0].snapshot(),
                                        stores[1].snapshot()):
                raise AssertionError(f"{what}: snapshots differ")
            # a plain prune that ran, and reloaded nothing, is exact
            exact = op[0] == "prune" and stores[1].stats == dict(
                before, prunes=before["prunes"] + 1)
            got = [check_tiles(torch, {"rows": st.rows, "counts": st.counts,
                                       "tiles": st.tiles}, what, exact=x)
                   for st, x in zip(stores, (False, exact))]
            out["loose_tiles"] = max(out["loose_tiles"],
                                     got[0]["loose_tiles"])
        tally(name, stores)
        out["ops"] += len(ops)
    return out


def q7j_span() -> int:
    return Q7J_PANES * Q7J_PANE_MS


def q7j_pane_range(p: int, count: int) -> tuple[int, int]:
    """The bid indices of pane p: ts = idx * span // count in [p, p + 1)
    panes."""
    span = q7j_span()
    return (-(-(p * Q7J_PANE_MS * count) // span),
            -(-((p + 1) * Q7J_PANE_MS * count) // span))


def q7j_bids(n_keys: int, count: int, lo: int, hi: int) -> tuple:
    """bench.py::bench_framework_q7_join's bids [lo, hi) in numpy:
    (auction, price, ts)."""
    idx = np.arange(lo, hi, dtype=np.int64)
    auction = ((idx.astype(np.uint64) * np.uint64(MULT))
               % np.uint64(n_keys)).astype(np.int64)
    return auction, idx % Q7_PRICES + 1, (idx * q7j_span()) // count


def q7_join_gen(n_keys: int, count: int, device: bool):
    """The reference's generator: numpy indices in and numpy columns out,
    or (``device``) int64 torch indices with ``mixed_keys``."""
    span = q7j_span()

    def gen(idx):
        if device:
            return {"auction": mixed_keys(idx, n_keys),
                    "price": idx % Q7_PRICES + 1,
                    "ts": (idx * span) // count}
        u = idx.astype(np.uint64)
        return {"auction": ((u * np.uint64(MULT))
                            % np.uint64(n_keys)).astype(np.int64),
                "price": (idx % Q7_PRICES) + 1,
                "ts": (idx * span) // count}

    return gen


def q7j_winner_word(auction, price, ts):
    """A winner (auction, price, ts) in one int64: ts < 2^17, price <
    2^14, auction < 2^24, so the multiset compares as sorted words."""
    return (auction << 31) | (price << 17) | ts


def q7_join_expected(c: dict) -> np.ndarray:
    """Every winner of the job as a sorted ``q7j_winner_word``: each bid
    whose price equals the largest price of its auction in its pane. None
    is lost at a boundary: a pane's max row (ts = end - 1) reaches the
    join while the combined watermark is below end - 1, so the bids'
    horizon (watermark - pane + 1) is below the pane's start; a bid that
    reaches the join after its pane's max finds it kept, as the maxes'
    horizon is the watermark, below the bid's ts."""
    if q7j_span() >= 1 << 17 or c["auctions"] >= 1 << 24:
        raise AssertionError("the winner word does not hold this cell")
    n_keys, count = c["auctions"], c["bids"]
    out = []
    for p in range(Q7J_PANES):
        auction, price, ts = q7j_bids(n_keys, count, *q7j_pane_range(p,
                                                                     count))
        s = np.sort(auction * 16384 + price)
        last = np.r_[(s[1:] >> 14) != (s[:-1] >> 14), True]
        maxp = np.zeros(n_keys, np.int64)
        maxp[s[last] >> 14] = s[last] & 16383
        win = price == maxp[auction]
        out.append(q7j_winner_word(auction[win], price[win], ts[win]))
    return np.sort(np.concatenate(out))


def q7_join_check(expected: np.ndarray, got: list) -> int:
    g = np.sort(np.concatenate(got)) if got else np.zeros(0, np.int64)
    if not np.array_equal(g, expected):
        raise AssertionError(f"Q7 join: {len(g)} winners, {len(expected)} "
                             "expected, or they differ")
    return len(g)


def q7_join_env(torch, dev, c: dict, count: int | None = None,
                rate: float | None = None, source_hook=None,
                settings: dict | None = None):
    """bench.py::bench_framework_q7_join through the port's public API:
    bids -> key_by -> tumbling max per auction (the device window) ->
    connect(bids) -> IntervalJoinOperator (max row ts = end - 1; offsets
    [-(pane - 1), 0]) -> is-winner -> sink, a watermark after every batch
    (``c["batch"]`` rows, 2^15 by default). ``rate`` paces the source,
    ``source_hook(source)`` receives it, ``settings`` adds configuration
    keys. Returns (env, [winner words of each sink batch])."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators import AggSpec, BatchFnOperator
    from flink_tpu_torch.sql.join import IntervalJoinOperator
    from flink_tpu_torch.window import TumblingEventTimeWindows

    count = count or c["bids"]
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    env = StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": c.get("batch", Q7J_BATCH),
        "pipeline.auto-watermark-interval": 0.0, **(settings or {})}),
        device=dev)
    env.set_state_backend("tpu")
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    source = DataGenSource(q7_join_gen(c["auctions"], count,
                                       c["device_batches"]), schema,
                           count=count, rate_per_sec=rate,
                           timestamp_column="ts",
                           device=c["device_batches"])
    if source_hook is not None:
        source_hook(source)
    bids = env.from_source(source, ws, "DataGen")
    maxes = (bids.key_by("auction")
             .window(TumblingEventTimeWindows.of(Q7J_PANE_MS))
             .device_aggregate([AggSpec("max", "price",
                                        out_name="maxprice")],
                               capacity=c["window_capacity"],
                               ring_size=RING, emit_window_bounds=False))
    out_schema = Schema([("m_auction", np.int64), ("maxprice", np.int64),
                         ("auction", np.int64), ("price", np.int64),
                         ("ts", np.int64)])

    def join_factory():
        return IntervalJoinOperator(
            0, 0, -(Q7J_PANE_MS - 1), 0, out_schema,
            rows_per_key=Q7J_ROWS_PER_KEY,
            store_capacity=c["store_capacity"], name="q7-join", device=dev)

    def is_winner(batch):
        mask = batch.column("price") == batch.column("maxprice")
        return batch.take(np.flatnonzero(mask))

    got = []

    def sink(b):
        a, p = b.column("auction"), b.column("price")
        if not (np.array_equal(b.column("m_auction"), a)
                and np.array_equal(b.column("maxprice"), p)):
            raise AssertionError("Q7 join: a winner joined another "
                                 "auction's max")
        got.append(q7j_winner_word(a, p, b.column("ts")))

    (maxes.connect(bids).transform("q7-join", join_factory)
     .transform("is-winner", lambda: BatchFnOperator(is_winner, "is-winner"))
     .add_sink(sink, "winners"))
    return env, got


def run_q7_join(torch, dev, c: dict, count: int | None = None):
    """One run of ``q7_join_env``'s job through ``env.execute()``;
    returns (job, winner words)."""
    env, got = q7_join_env(torch, dev, c, count)
    return env.execute("nexmark-q7-join", timeout=900.0), got


def q7_join_operator(job):
    from flink_tpu_torch.sql.join import IntervalJoinOperator

    ops = [op for op in job.operators if isinstance(op, IntervalJoinOperator)]
    if len(ops) != 1:
        raise AssertionError(f"{len(ops)} interval joins in the job")
    return ops[0]


def join_profile(torch, run) -> dict:
    """A run under torch.profiler: the card's busy time by kernel against
    the run's wall time, and the profiler's count of each list kernel and
    of the window's probe beside its launch counter. Up to PROFILE_TRIES
    profiles are taken until they agree; the records a profile still
    lacks are reported (``lost_records``): on an H100 80GB HBM3, each of
    three profiles of q7_join_ref once lacked one list_append and one
    hash_probe launch."""
    from torch.autograd import DeviceType

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    symbols = LIST_SYMBOLS + (("hash_probe", "hash_probe_kernel"),)
    job = None
    for tries in range(1, PROFILE_TRIES + 1):
        job = None          # the 10M cell's state fits on the card once
        fresh_memory(torch)
        reset_launches()
        with card_profile(torch, host=True) as prof:
            job, _got = run()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                acc = by_name.setdefault(e.name[:90], [0.0, 0])
                acc[0] += e.self_device_time_total / 1e3
                acc[1] += 1
        counted = {k: sum(n for name, (_ms, n) in by_name.items()
                          if sym in name) for k, sym in symbols}
        lost = {k: KERNEL_LAUNCHES[k] - n for k, n in counted.items()}
        if not any(lost.values()):
            break
    if any(n < 0 or n == KERNEL_LAUNCHES[k] for k, n in lost.items()
           if KERNEL_LAUNCHES[k]):
        raise AssertionError(f"profiler counted {counted}, the counters "
                             f"{dict(KERNEL_LAUNCHES)}")
    busy = sum(ms for ms, _n in by_name.values())
    wall = job.wall_s * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if wall else None,
            "profiles_taken": tries, "profiler_counts": counted,
            "lost_records": lost,
            "kernel_ms": {k: sum(ms for name, (ms, _n) in by_name.items()
                                 if any(part in name for part in parts))
                          for k, parts in (*LIST_PARTS.items(),
                                           ("hash_probe",
                                            ("hash_probe_kernel",)))},
            "list_parts_ms": {part: sum(ms for name, (ms, _n)
                                        in by_name.items() if part in name)
                              for parts in LIST_PARTS.values()
                              for part in parts},
            "top": [{"name": k, "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def q7_join_run_record(torch, label: str, c: dict, run, expected) -> dict:
    """One timed run with the launch counters zeroed just before it: the
    winners against the oracle, each list kernel launched, the window's
    probe at least once a batch (device batches); bids/s, peak memory, the
    stores' prunes and rebuilds, host seconds a batch by part."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.ops import kernels

    start = fresh_memory(torch)
    built = sorted(p.name for p in kernels.BUILD_DIR.glob("*.so"))
    reset_launches()
    job, got = run()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    winners = q7_join_check(expected, got)
    missing = [k for k in LIST_KERNELS if not launches[k]]
    batches = c["bids"] // Q7J_BATCH
    # the reference's window here defers no overflow: a device batch is
    # one hash_probe and eager folds (the list stores' reloads probe too)
    if missing or (c["device_batches"]
                   and launches["hash_probe"] < batches):
        raise AssertionError(f"{label}: launches {launches}; each list "
                             "kernel must launch, and the window's probe "
                             "once a batch")
    op = q7_join_operator(job)
    st = op.stats
    n = max(st["batches"], 1)
    stores = {side: dict(s.stats, capacity=s.capacity, occupied=s._occ,
                         rows_bytes=s.rows.numel() * 8)
              for side, s in zip(("maxes", "bids"), op._stores)
              if s is not None}
    return {"wall_s": job.wall_s, "bids_per_sec": c["bids"] / job.wall_s,
            "winners": winners, "matches": st["matches"],
            "join_batches": st["batches"], "peak": peak, "start": start,
            "launches": launches, "stores": stores,
            "host_s_per_batch": {k: st[k] / n for k in
                                 ("pack_s", "upload_s", "probe_s",
                                  "append_s", "copy_home_s", "emit_s")},
            "prune_s_total": st["prune_s"],
            "kernel_builds_after_warmup": len(
                set(p.name for p in kernels.BUILD_DIR.glob("*.so"))
                - set(built)),
            "tasks": task_record(job)}


def q7_join_cell(torch, dev, cell: str) -> dict:
    """A Q7 join cell: the reference's warm-up run (2^16 bids), then
    ``Q7J_RUNS`` timed runs and one profiled run, every run's winners
    against the numpy oracle."""
    c = Q7J_CELLS[cell]
    expected = q7_join_expected(c)
    small = dict(c, bids=min(1 << 16, c["bids"]))
    job, got = run_q7_join(torch, dev, small)
    q7_join_check(q7_join_expected(small), got)
    del job, got
    runs = [q7_join_run_record(torch, cell, c,
                               lambda: run_q7_join(torch, dev, c), expected)
            for _ in range(Q7J_RUNS)]
    prof = join_profile(torch, lambda: run_q7_join(torch, dev, c))
    bps = sorted(r["bids_per_sec"] for r in runs)
    last = runs[-1]
    return {"cell": cell, **c, "pane_ms": Q7J_PANE_MS, "panes": Q7J_PANES,
            "batch": Q7J_BATCH, "rows_per_key": Q7J_ROWS_PER_KEY,
            "window_ring": RING, "runs": len(runs),
            "bids_per_sec": float(np.median(bps)),
            "bids_per_sec_min_max": [bps[0], bps[-1]],
            "wall_s": [r["wall_s"] for r in runs],
            "winners": last["winners"], "matches": last["matches"],
            "join_batches": last["join_batches"],
            "max_memory_allocated": max(r["peak"] for r in runs),
            "memory_at_start": [r["start"] for r in runs],
            "stores": last["stores"],
            # the join's probe calls: launched (a launch again past the
            # output's room counts too) and skipped by the stores' bounds
            "probe_calls": {side: {k: st[k] for k in ("probes",
                                                      "probes_skipped")}
                            for side, st in last["stores"].items()},
            "list_probe_launches": last["launches"]["list_probe"],
            "host_s_per_batch": last["host_s_per_batch"],
            "prune_s_total": last["prune_s_total"],
            "kernel_builds_after_warmup": sum(
                r["kernel_builds_after_warmup"] for r in runs),
            "launches_per_run": last["launches"],
            "tasks_last_run": last["tasks"], "profile": prof}


#: (label, auctions, bids, capacity a side) of the list kernels' shapes
LIST_SHAPES = (("q7_join_10m", 10_000_000, 1 << 25, 1 << 25),
               ("q7_join_ref", 100_000, 1 << 18, 1 << 18))
#: sector class -> the measured rate (``sector_rates``: op, order) it is
#: priced at; the prune walks the slots in address order
LIST_RATE_OF = {"read": ("read8", "random"), "claim": ("probe8", "random"),
                "atomic": ("red8", "random"), "store": ("store8", "random"),
                "store4": ("store4", "random"),
                "read_in_order": ("read8", "sorted"),
                "store_in_order": ("store8", "sorted"),
                "store4_in_order": ("store4", "sorted")}


def list_lists_of(torch, st: dict, keys) -> tuple:
    """(sorted distinct keys present, their counts, their whole [L, C]
    lists), on the device."""
    from flink_tpu_torch.ops.hash_table import lookup, sanitize_keys_device

    k = torch.unique(sanitize_keys_device(keys))
    slots = lookup(st["table"], k.contiguous()).to(torch.int64)
    on = slots >= 0
    k, slots = k[on], slots[on]
    return k, st["counts"][slots], st["rows"][slots]


def range_sectors(torch, starts, nbytes) -> int:
    """32-byte sectors covering the disjoint byte ranges [start, start +
    nbytes) (nbytes a tensor or an int; empty ranges add none)."""
    nbytes = torch.as_tensor(nbytes, device=starts.device)
    ends = starts + nbytes - 1
    n = torch.where(nbytes > 0, ends // 32 - starts // 32 + 1, 0)
    return int(n.sum())


def distinct_sectors(torch, byte_addr) -> int:
    return int(torch.unique(byte_addr // 32).numel())


def list_cost(sectors: dict, streamed: int, nbytes: int,
              rates: dict | None) -> dict:
    """Byte bound, 32-byte sector floor, and that floor at the card's
    measured rates for each class's access and order (streamed bytes at
    3.35 TB/s)."""
    n = sum(sectors.values())
    out = {"bytes": nbytes, "bound_ms": bound_ms(nbytes),
           "sectors": sectors, "streamed_bytes": streamed,
           "sector_floor_ms": bound_ms(32 * n + streamed)}
    if rates is not None:
        out["at_measured_rate_ms"] = bound_ms(streamed) + sum(
            v / (rates["ops"][LIST_RATE_OF[k][0]][LIST_RATE_OF[k][1]][
                "g_sectors_per_s"] * 1e6) for k, v in sectors.items())
    return out


def turns(torch, flush, setup, **fns) -> dict:
    """Each of ``fns`` timed by ``cuda_ms`` (``setup`` before every run),
    in turns and then again in reverse order; ``<name>_ms`` the first
    turn's, ``<name>_ms_again`` the second's."""
    out = {}
    order = list(fns)
    for suffix, names in (("", order), ("_again", order[::-1])):
        for name in names:
            out[f"{name}_ms{suffix}"] = cuda_ms(fns[name], torch, flush,
                                               setup=setup)
    return out


def list_append_case(torch, flush, rates, st: dict, keys, packed) -> dict:
    """list_append against its plain version on one state (the state put
    back between them): flags, failed rows, and the batch keys' counts
    and whole lists equal, and both tile summaries exact; the kernel and
    the plain version timed, the state put back before each launch.
    Its cost: each row's key and packed row read and row written, a
    distinct key's table entry read and count read and written, a new
    key's claim and its list written."""
    from flink_tpu_torch.ops import device_lists as dl
    from flink_tpu_torch.ops.hash_table import lookup, sanitize_keys_device

    L, C = st["rows"].shape[1], st["rows"].shape[2]
    t0, c0, g0 = (st[k].clone() for k in ("table", "counts", "tiles"))

    def restore():
        st["table"].copy_(t0)
        st["counts"].copy_(c0)
        st["tiles"].copy_(g0)

    args = (st["table"], st["rows"], st["counts"], st["tiles"])
    fk, xk = dl.list_append(*args, st["hits"], keys, packed)
    got = list_lists_of(torch, st, keys)
    tiles = check_tiles(torch, st, "list_append", exact=True)
    fk, xk = fk.tolist(), xk.cpu()
    skeys = sanitize_keys_device(keys)
    slots = lookup(st["table"], skeys).to(torch.int64)
    restore()
    fp, xp = dl.list_append_plain(*args, keys, packed)
    want = list_lists_of(torch, st, keys)
    check_tiles(torch, st, "list_append_plain", exact=True)
    err = max_abs_diff(torch, [(torch.tensor(fk), fp.cpu()), (xk, xp.cpu()),
                               (len(got), len(want)), *zip(got, want)])
    if err:
        raise AssertionError("list_append: kernel and plain version differ "
                             f"by {err}")
    del got, want
    times = turns(torch, flush, restore,
                  kernel=lambda: dl.list_append(*args, st["hits"], keys,
                                                packed))
    plain_ms = cuda_ms(lambda: dl.list_append_plain(*args, keys, packed),
                       torch, flush, setup=restore)
    restore()
    n = keys.numel()
    uslots, per_slot = torch.unique(slots, return_counts=True)
    new = torch.unique(slots[lookup(t0, skeys) < 0])
    # a slot's rows land side by side from its count before the batch
    before = c0[uslots].to(torch.int64)
    written = torch.clamp(torch.minimum(per_slot, L - before), min=0)
    sectors = {"read": distinct_sectors(torch, uslots * 8)
               + distinct_sectors(torch, uslots * 4),
               "claim": distinct_sectors(torch, new * 8),
               "atomic": distinct_sectors(torch, uslots * 8),
               "store4": distinct_sectors(torch, uslots * 4),
               "store": range_sectors(torch, (uslots * L + before) * C * 8,
                                      written * C * 8)}
    streamed = n * (8 + 8 * C) + int(new.numel()) * L * C * 8
    nbytes = (n * (8 + 16 * C) + int(uslots.numel()) * 16
              + int(new.numel()) * (8 + L * C * 8))
    cost = list_cost(sectors, streamed, nbytes, rates)
    ms = times["kernel_ms"]
    return {"n": n, "capacity": st["table"].numel(), "L": L, "C": C,
            "distinct_keys": int(uslots.numel()),
            "new_keys": int(new.numel()), "flags": fk, "max_abs_err": err,
            "ms": ms,
            **times, "plain_ms": plain_ms, "tiles": tiles, **cost,
            "share_of_bound": cost["bound_ms"] / ms}


def kernel_device_ms(torch, fn, flush, symbols: tuple, reps: int = 7
                     ) -> float:
    """Device ms of the kernels a call of ``fn`` launches whose names hold
    any of ``symbols``: the profiler's sum over ``reps`` calls, each after
    the L2 flush, over ``reps`` (the host's part of a call left out)."""
    from torch.autograd import DeviceType

    fn()
    with card_profile(torch) as prof:
        for _ in range(reps):
            flush()
            fn()
    return sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and any(sym in e.name for sym in symbols)) / 1e3 / reps


def list_probe_case(torch, flush, rates, st: dict, keys, ts, lo_off: int,
                    hi_off: int) -> dict:
    """list_probe against its plain version: matches, their order and
    each row's count equal, at the output's default room and again with
    room for one match fewer than M (the launch runs again: two launches,
    the same result); both timed (the kernel's one host read of M inside),
    the kernel with the room a store gives it once it has seen M, and
    its kernel's device time alone by the profiler (``device_ms``). Its
    cost: each key and ts read, a key's table entry, a found key's count
    and its live rows' ts, a match's row and output."""
    from flink_tpu_torch import KERNEL_LAUNCHES
    from flink_tpu_torch.ops import device_lists as dl
    from flink_tpu_torch.ops.hash_table import lookup, sanitize_keys_device

    L, C = st["rows"].shape[1], st["rows"].shape[2]
    args = (st["table"], st["rows"], st["counts"], keys, ts, lo_off, hi_off)
    want = dl.list_probe_plain(*args)
    m = int(want[0].numel())
    err = 0.0
    for room in (None, max(m - 1, 0)):
        before = KERNEL_LAUNCHES["list_probe"]
        got = dl.list_probe(*args, capacity=room)
        launches = KERNEL_LAUNCHES["list_probe"] - before
        err = max(err, max_abs_diff(torch, [(len(got), len(want)),
                                            *zip(got, want)]))
        if err or launches != 1 + (m > (keys.numel() if room is None
                                        else room)):
            raise AssertionError(f"list_probe at room {room}: kernel and "
                                 f"plain version differ by {err}, or "
                                 f"{launches} launches")
    del got, want
    ms = cuda_ms(lambda: dl.list_probe(*args, hint=m), torch, flush)
    device_ms = kernel_device_ms(torch, lambda: dl.list_probe(*args, hint=m),
                                 flush, LIST_PARTS["list_probe"])
    plain_ms = cuda_ms(lambda: dl.list_probe_plain(*args), torch, flush)
    n = keys.numel()
    slots = lookup(st["table"], sanitize_keys_device(keys)).to(torch.int64)
    found = torch.unique(slots[slots >= 0])
    cnt = st["counts"][found].to(torch.int64)
    examined = int(cnt.sum())
    sectors = {"read": distinct_sectors(torch, found * 8)
               + int((slots < 0).sum())
               + distinct_sectors(torch, found * 4)
               + range_sectors(torch, found * L * C * 8, cnt * C * 8)}
    streamed = n * 16 + m * (8 + 8 * C)
    nbytes = n * 24 + int(found.numel()) * 4 + examined * 8 \
        + m * (C - 1) * 8 + m * (8 + 8 * C)
    cost = list_cost(sectors, streamed, nbytes, rates)
    return {"n": n, "capacity": st["table"].numel(), "L": L, "C": C,
            "found_keys": int(found.numel()), "live_rows_examined": examined,
            "matches": m, "lo_off": lo_off, "hi_off": hi_off,
            "max_abs_err": err, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms, **cost,
            "share_of_bound": cost["bound_ms"] / ms}


def list_prune_case(torch, flush, rates, st: dict, horizon: int) -> dict:
    """list_prune against its plain version on one state (put back
    between them and before each timed launch): live keys, every count,
    every live slot's whole list and the tile summary equal (the
    kernel's exact). The kernel and the plain version timed. Its bound, what the design must
    move: the summary read, a visited tile's counts and its live lists'
    sectors, an emptied tile's counts written, the changed counts, the
    moved lists written, and the summaries written (from the
    summary before the prune: a tile is visited unless its lower bound is
    at the horizon or its upper bound below it). Beside it, ``earlier_*``,
    the earlier design's bound: every count read, live rows' ts, a changed
    count written, a moved list read and written, all in address order,
    with its sector floors."""
    from flink_tpu_torch.ops import device_lists as dl

    L, C = st["rows"].shape[1], st["rows"].shape[2]
    c0, g0 = st["counts"].clone(), st["tiles"].clone()
    live = torch.nonzero(c0 > 0).flatten()
    r0 = st["rows"][live]

    def restore():
        st["counts"].copy_(c0)
        st["rows"][live] = r0
        st["tiles"].copy_(g0)

    lk = int(dl.list_prune(st["rows"], st["counts"], st["tiles"],
                           st["hits"], horizon))
    tiles = check_tiles(torch, st, "list_prune", exact=True)
    ck, rk, gk = st["counts"].clone(), st["rows"][live], st["tiles"].clone()
    restore()
    lp = int(dl.list_prune_plain(st["rows"], st["counts"], st["tiles"],
                                 horizon))
    err = max_abs_diff(torch, [(lk, lp), (ck, st["counts"]),
                               (rk, st["rows"][live]), (gk, st["tiles"])])
    if err or bool((st["hits"] != 0).any()):
        raise AssertionError("list_prune: kernel and plain version differ "
                             f"by {err}, or its hits were left set")
    del ck, rk, gk
    times = turns(torch, flush, restore,
                  kernel=lambda: dl.list_prune(st["rows"], st["counts"],
                                               st["tiles"], st["hits"],
                                               horizon))
    plain_ms = cuda_ms(lambda: dl.list_prune_plain(st["rows"], st["counts"],
                                                   st["tiles"], horizon),
                       torch, flush, setup=restore)
    restore()
    cap = c0.numel()
    cnt = c0[live].to(torch.int64)
    ts = r0[:, :, 0]
    pos = torch.arange(L, device=ts.device)[None, :]
    keep = (pos < cnt[:, None]) & (ts >= horizon)
    drop = (pos < cnt[:, None]) & ~keep
    # a list moves when a dropped row precedes a kept one
    moved = (keep & (torch.cumsum(drop.to(torch.int32), 1) > 0)).any(1)
    kept = keep.sum(1)
    changed = live[kept != cnt]
    base = live * L * C * 8
    sectors = {"read_in_order": range_sectors(torch, base, cnt * C * 8),
               "store_in_order": range_sectors(torch, base[moved],
                                               cnt[moved] * C * 8),
               "store4_in_order": distinct_sectors(torch, changed * 4)}
    streamed = cap * 4
    nbytes = cap * 4 + int(cnt.sum()) * 8 + int(changed.numel()) * 4 \
        + 2 * int(cnt[moved].sum()) * C * 8
    old_bound = {f"earlier_{k}": v for k, v in
                 list_cost(sectors, streamed, nbytes, rates).items()}
    # the bound, from the summary before the prune; a moved list is read
    # with its tile's live lists, then written
    n_tiles, T = g0.shape[1], cap // g0.shape[1]
    has = g0[2] > 0
    skip = has & (g0[0] >= horizon)
    zero = has & ~skip & (g0[1] < horizon)
    visit = has & ~skip & ~zero
    in_visit = visit[live // T]
    nbytes = (n_tiles * 24 + int((visit | zero).sum()) * (24 + T * 4)
              + 32 * range_sectors(torch, base[in_visit],
                                   cnt[in_visit] * C * 8)
              + 32 * distinct_sectors(torch, changed[visit[changed // T]] * 4)
              + 32 * range_sectors(torch, base[moved], cnt[moved] * C * 8))
    ms = times["kernel_ms"]
    return {"capacity": cap, "L": L, "C": C, "horizon": horizon,
            "live_keys_before": int(live.numel()), "live_keys_after": lk,
            "live_rows": int(cnt.sum()), "dropped_rows": int(drop.sum()),
            "lists_moved": int(moved.sum()), "tiles": tiles,
            "tiles_skipped": int(skip.sum()), "tiles_emptied": int(zero.sum()),
            "tiles_visited": int(visit.sum()), "max_abs_err": err,
            "ms": ms, **times,
            "plain_ms": plain_ms,
            "bytes": nbytes, "bound_ms": bound_ms(nbytes),
            "share_of_bound": bound_ms(nbytes) / ms, **old_bound,
            "share_of_earlier_bound": old_bound["earlier_bound_ms"] / ms}


def list_shape_cases(torch, dev, flush, rates, n_keys: int, count: int,
                     cap: int) -> dict:
    """The list kernels at one cell's shapes. The bids' side: pane 3's
    bids appended a batch at a time (the state a fire meets), then the
    next batch appended, the pane's maxes probing it with their interval,
    and the prune of the next watermark (a batch's rows older than the
    horizon). The maxes' side (C = 3, maxprice float32 as the window
    emits it): a fire's maxes appended to an empty state, a batch of bids
    probing them, and the prune that drops them all."""
    from flink_tpu_torch.ops import device_lists as dl

    L, P = Q7J_ROWS_PER_KEY, Q7J_PANE_MS
    i64 = [np.dtype(np.int64)] * 3
    b0, b1 = q7j_pane_range(3, count)

    def bids(lo, hi):
        auction, price, ts = q7j_bids(n_keys, count, lo, hi)
        return (torch.from_numpy(auction).to(dev),
                _packed_on(torch, dev, ts, [auction, price, ts], i64), ts)

    out = {}
    st = list_state(torch, dev, cap, L, 4)
    for lo in range(b0, b1, Q7J_BATCH):
        keys, packed, _ts = bids(lo, min(lo + Q7J_BATCH, b1))
        flags, _failed = dl.list_append(st["table"], st["rows"],
                                        st["counts"], st["tiles"],
                                        st["hits"], keys, packed)
        if any(flags[:2].tolist()):
            raise AssertionError(f"bids' state: flags {flags.tolist()}")
    keys, packed, _ts = bids(b1, b1 + Q7J_BATCH)
    out["append_bids_batch"] = list_append_case(torch, flush, rates, st,
                                                keys, packed)
    auction, price, _ts = q7j_bids(n_keys, count, b0, b1)
    s = np.sort(auction * 16384 + price)
    last = np.r_[(s[1:] >> 14) != (s[:-1] >> 14), True]
    m_keys, m_price = s[last] >> 14, (s[last] & 16383).astype(np.float32)
    m_ts = np.full(len(m_keys), 4 * P - 1, np.int64)
    mk = torch.from_numpy(m_keys).to(dev)
    out["probe_bids_by_fire"] = list_probe_case(
        torch, flush, rates, st, mk, torch.from_numpy(m_ts).to(dev),
        -(P - 1), 0)
    horizon = int((b0 + Q7J_BATCH) * q7j_span() // count)
    out["prune_bids_watermark"] = list_prune_case(torch, flush, rates, st,
                                                  horizon)
    del st
    fresh_memory(torch)
    st = list_state(torch, dev, cap, L, 3)
    packed = _packed_on(torch, dev, m_ts, [m_keys, m_price],
                        [np.dtype(np.int64), np.dtype(np.float32)])
    out["append_maxes_fire"] = list_append_case(torch, flush, rates, st, mk,
                                                packed)
    dl.list_append(st["table"], st["rows"], st["counts"], st["tiles"],
                   st["hits"], mk, packed)
    keys, _packed, ts = bids(b1, b1 + Q7J_BATCH)
    out["probe_maxes_by_batch"] = list_probe_case(
        torch, flush, rates, st, keys, torch.from_numpy(ts).to(dev), 0,
        P - 1)
    out["prune_maxes_watermark"] = list_prune_case(torch, flush, rates, st,
                                                   4 * P)
    del st
    fresh_memory(torch)
    return out


def check_device_lists(torch, dev, flush, rates: dict | None = None
                       ) -> dict:
    """The three list kernels against their plain versions on the card:
    at both join cells' shapes (timed, with bounds and sector floors;
    ``tools/list_designs.py`` times the earlier designs beside them), on
    ``LIST_EDGE_CASES``, a store
    on the card against one on the CPU (rehashes, rebuilds, many
    watermarks, a restore), and a pane of the 10M join replayed through
    both (``check_list_sequence``)."""
    shapes = {label: list_shape_cases(torch, dev, flush, rates, n_keys,
                                      count, cap)
              for label, n_keys, count, cap in LIST_SHAPES}
    edges = {case: check_list_edge(torch, dev, case)
             for case in LIST_EDGE_CASES}
    # the largest |kernel - plain| over the shapes' outputs and states (the
    # edge cases, the store and the sequence compare alike and raise)
    return {"shapes": shapes, "edges": edges,
            "store": check_list_store(torch, dev),
            "sequence": check_list_sequence(torch, dev),
            "max_abs_err": max(c["max_abs_err"] for sh in shapes.values()
                               for c in sh.values())}


def check_list_sequence(torch, dev, c: dict | None = None,
                        batch: int = Q7J_BATCH) -> dict:
    """A pane of the q7_join_10m cell replayed through the kernels on one
    state and the plain versions on another, on the card, a side at a
    time, each state of the cell's store capacity (2^25 slots: a side's
    two states, 2 x 32 GiB for the bids, share the card, the plain prune
    permuting a chunk of lists at a time). The bids: pane 2's 128
    batches of 2^15 appended, then pane 3's, each followed by the prune
    at its watermark (the batch's last ts - 1; horizon watermark - pane +
    1). The maxes: pane 2's fire (one max an auction, ts its end - 1),
    then after each of pane 3's 128 batches that batch's own maxes (one
    an auction of the batch, ts the batch's last ts, as an early fire
    would emit them) and the prune at horizon watermark - pane / 8: the
    early prunes skip every tile (pane 2's ts is each tile's lower
    bound), the one that passes pane 2's ts visits every tile with a row
    of both, and the later ones visit, skip and empty tiles as the rows
    of a sliding eighth of the pane come and go; then pane 3's fire.
    After every prune the keys left with a live row equal, every
    occupied key's count and whole list equal key by key (the snapshot's
    fields), both tile summaries exact, and the scratch zero; after the
    last append the same. Returns per side the last check and the
    prunes that visited, skipped and emptied tiles (from the kernels'
    summary before each prune)."""
    from flink_tpu_torch.ops import device_lists as dl

    c = c or Q7J_CELLS["q7_join_10m"]
    n_keys, count, L, P = c["auctions"], c["bids"], Q7J_ROWS_PER_KEY, \
        Q7J_PANE_MS
    cap = c["store_capacity"]
    i64 = [np.dtype(np.int64)] * 3
    args = ("table", "rows", "counts", "tiles")

    def both_append(k, p, keys, packed, what):
        fk, xk = dl.list_append(*(k[n] for n in args), k["hits"], keys,
                                packed)
        fp, xp = dl.list_append_plain(*(p[n] for n in args), keys, packed)
        if fk.tolist() != fp.tolist() or not torch.equal(xk, xp):
            raise AssertionError(f"{what}: flags or failed rows differ")

    def both_prune(k, p, horizon, what, paths) -> int:
        g = k["tiles"]
        skip = (g[2] > 0) & (g[0] >= horizon)
        empty = (g[2] > 0) & ~skip & (g[1] < horizon)
        for path, n in (("visited", int(((g[2] > 0) & ~skip & ~empty)
                                         .sum())),
                        ("skipped", int(skip.sum())),
                        ("emptied", int(empty.sum()))):
            paths[f"prunes_that_{path}"] += n > 0
        lk = int(dl.list_prune(k["rows"], k["counts"], k["tiles"],
                               k["hits"], horizon))
        lp = int(dl.list_prune_plain(p["rows"], p["counts"], p["tiles"],
                                     horizon))
        if lk != lp:
            raise AssertionError(f"{what}: {lk} and {lp} live keys")
        return lk

    def check(k, p, what) -> dict:
        keys = lists_equal_by_key(torch, k, p, what)
        tk = check_tiles(torch, k, what, exact=True)
        check_tiles(torch, p, what, exact=True)
        if bool((k["hits"] != 0).any()):
            raise AssertionError(f"{what}: the scratch is not zero again")
        return {"keys": keys, **tk}

    def pane_batches(p):
        lo, hi = q7j_pane_range(p, count)
        for b in range(lo, hi, batch):
            auction, price, ts = q7j_bids(n_keys, count, b,
                                          min(b + batch, hi))
            yield (torch.from_numpy(auction).to(dev),
                   _packed_on(torch, dev, ts, [auction, price, ts], i64),
                   int(ts[-1]) - 1)

    def maxes(lo, hi, ts):
        """One max an auction of bids [lo, hi), each at ``ts``."""
        auction, price, _ts = q7j_bids(n_keys, count, lo, hi)
        s = np.sort(auction * 16384 + price)
        last = np.r_[(s[1:] >> 14) != (s[:-1] >> 14), True]
        keys = s[last] >> 14
        return (torch.from_numpy(keys).to(dev),
                _packed_on(torch, dev, np.full(len(keys), ts, np.int64),
                           [keys, (s[last] & 16383).astype(np.float32)],
                           [np.dtype(np.int64), np.dtype(np.float32)]))

    def fresh():
        if torch.device(dev).type == "cuda":
            fresh_memory(torch)
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = {"capacity": cap, "L": L, "batches": 0, "prunes": 0}
    fresh()
    paths = dict.fromkeys(("prunes_that_visited", "prunes_that_skipped",
                           "prunes_that_emptied"), 0)
    k, p = (list_state(torch, dev, cap, L, 4) for _ in range(2))
    for keys, packed, _wm in pane_batches(2):
        both_append(k, p, keys, packed, "bids pane 2")
    live = []
    for j, (keys, packed, wm) in enumerate(pane_batches(3)):
        both_append(k, p, keys, packed, f"bids batch {j}")
        live.append(both_prune(k, p, wm - P + 1, f"bids prune {j}", paths))
        out["bids"] = check(k, p, f"bids prune {j}")
        out["batches"] += 1
        out["prunes"] += 1
    out["bids"].update(paths, live_keys_first_last=[live[0], live[-1]])
    del k, p
    fresh()
    paths = dict.fromkeys(paths, 0)
    k, p = (list_state(torch, dev, cap, L, 3) for _ in range(2))
    both_append(k, p, *maxes(*q7j_pane_range(2, count), 3 * P - 1),
                "maxes pane 2")
    check(k, p, "maxes pane 2")
    lo = q7j_pane_range(3, count)[0]
    for j, (_keys, _packed, wm) in enumerate(pane_batches(3)):
        hi = min(lo + batch, q7j_pane_range(3, count)[1])
        both_append(k, p, *maxes(lo, hi, wm + 1), f"maxes batch {j}")
        lo = hi
        both_prune(k, p, wm - P // 8, f"maxes prune {j}", paths)
        out["maxes"] = check(k, p, f"maxes prune {j}")
        out["prunes"] += 1
    out["maxes"].update(paths)
    both_append(k, p, *maxes(*q7j_pane_range(3, count), 4 * P - 1),
                "maxes pane 3")
    out["maxes_end"] = check(k, p, "maxes pane 3")
    del k, p
    fresh()
    out["seconds"] = time.perf_counter() - t0
    return out


# -- the row plane: row_state.cu's four kernels ------------------------------
ROW_EDGE_CASES = ("random", "one_key", "all_invalid", "empty_key",
                  "ttl_equal", "max_clock", "overflow", "last_wins",
                  "dtypes", "spread", "map_collide", "map_full",
                  "set_one_key")
ROW_DTYPES = ("int8", "int32", "int64", "float32", "float64")
#: kernel -> the part of its CUDA kernels' names (ptxas, the profiler)
ROW_PTXAS = {"dedup_first": "dedup_first_kernel",
             "row_set": "row_set_kernel", "row_get": "row_get_kernel",
             "row_unset": "row_unset_kernel"}


def _row_values(rng, n: int, dtype: str) -> np.ndarray:
    """Values every dtype of the plane holds exactly."""
    return rng.integers(-100, 100, n).astype(dtype)


def row_edge_configs(case: str) -> list:
    """The adversarial operation sequences of the row programs: each a dict
    of the state's ``cap``, ``ttl`` (0: no clock), value ``dtype`` and
    ``ops``: ("dedup", keys, valid or None, ts), ("set", keys, values,
    now: an int or an int64 array), ("get", keys, now), ("unset", keys),
    ("grow",) (the table doubled, as the backend's rehash) and
    ("fill_clock", value) (as a restore that adds a clock)."""
    rng = np.random.default_rng(1400 + ROW_EDGE_CASES.index(case))
    i64 = np.int64

    def batch(n, pool, t0, span, p_valid=None):
        keys = rng.choice(pool, n).astype(i64)
        ts = np.sort(rng.integers(t0, t0 + span, n)).astype(i64)
        valid = None if p_valid is None else rng.random(n) < p_valid
        return ("dedup", keys, valid, ts)

    c = {"cap": 256, "ttl": 0, "dtype": "float64"}
    if case == "random":
        pool = np.arange(40)
        c["ttl"] = 50
        c["ops"] = [batch(60, pool, 40 * b, 60, 0.85) for b in range(4)] + [
            ("set", rng.choice(pool, 30).astype(i64),
             _row_values(rng, 30, "float64"), 170),
            ("get", rng.choice(np.arange(50), 40).astype(i64), 200),
            ("unset", rng.choice(np.arange(50), 10).astype(i64)),
            ("get", np.arange(50, dtype=i64), 230),
            batch(80, np.arange(60), 230, 40, 0.9)]
    elif case == "one_key":
        c.update(cap=64, ttl=10)
        key = np.full(100, 7, i64)
        c["ops"] = [("dedup", key, None, np.sort(rng.integers(0, 50, 100))),
                    ("dedup", key[:50], None, np.arange(55, 105, dtype=i64)),
                    ("dedup", key[:20], None, np.arange(60, 80, dtype=i64)),
                    ("get", key[:3], 65), ("get", key[:3], 10 ** 6)]
    elif case == "all_invalid":
        c.update(cap=64, ttl=100)
        keys = rng.integers(0, 30, 40).astype(i64)
        ts = np.arange(40, dtype=i64)
        c["ops"] = [("dedup", keys, np.zeros(40, bool), ts),
                    ("get", keys, 40), ("dedup", keys, None, ts + 1),
                    ("dedup", keys, np.zeros(40, bool), ts + 500)]
    elif case == "empty_key":
        c.update(cap=64, ttl=100)
        keys = np.array([INT64_MAX, INT64_MAX - 1, 5, INT64_MAX, -1, 0], i64)
        c["ops"] = [("dedup", keys, None, np.zeros(6, i64)),
                    ("set", keys, _row_values(rng, 6, "float64"), 3),
                    ("get", keys, 5), ("unset", keys[:1]),
                    ("get", keys, 5), ("dedup", keys, None, np.full(6, 7, i64))]
    elif case == "ttl_equal":
        c.update(cap=64, ttl=100)
        keys = np.array([1, 2, 3], i64)
        c["ops"] = [("dedup", keys, None, np.zeros(3, i64)),
                    ("get", keys, 100), ("get", keys, 101),
                    ("dedup", keys, None, np.array([100, 101, 99], i64)),
                    ("dedup", keys, None, np.array([201, 202, 199], i64))]
    elif case == "max_clock":
        c.update(cap=64, ttl=100)
        c["ops"] = [("dedup", np.arange(10, dtype=i64), None,
                     np.zeros(10, i64)),
                    ("fill_clock", INT64_MAX),
                    ("dedup", np.arange(20, dtype=i64), None,
                     np.full(20, 10 ** 12, i64)),
                    ("get", np.arange(20, dtype=i64), 10 ** 12),
                    ("dedup", np.arange(20, dtype=i64), None,
                     np.full(20, 10 ** 12 + 101, i64))]
    elif case == "overflow":
        c.update(cap=16, ttl=100)
        old = np.arange(8, dtype=i64)
        new = np.concatenate([rng.permutation(np.arange(100, 130)), old,
                              np.arange(100, 110)]).astype(i64)
        valid = np.ones(len(new), bool)
        valid[::7] = False
        ts = np.sort(rng.integers(200, 300, len(new))).astype(i64)
        c["ops"] = [("dedup", old, None, np.zeros(8, i64)),
                    ("dedup", new, valid, ts), ("grow",),
                    ("dedup", new, valid, ts), ("get", new, 300)]
        # the same on the many-block path: 600 rows, 400 new keys into 256
        big = {"cap": 256, "ttl": 100, "dtype": "float64"}
        old = np.arange(100, dtype=i64)
        new = rng.permutation(np.concatenate(
            [np.arange(1000, 1400), old, old[:100]])).astype(i64)
        valid = rng.random(len(new)) > 0.1
        ts = np.sort(rng.integers(200, 300, len(new))).astype(i64)
        big["ops"] = [("dedup", old, None, np.zeros(100, i64)),
                      ("dedup", new, valid, ts), ("grow",), ("grow",),
                      ("dedup", new, valid, ts), ("get", new, 300)]
        return [c, big]
    elif case == "last_wins":
        c.update(cap=64, ttl=1000)
        keys = rng.integers(0, 6, 200).astype(i64)
        c["ops"] = [("set", keys, _row_values(rng, 200, "float64"),
                     np.arange(200, dtype=i64)),
                    ("get", np.arange(8, dtype=i64), 1100),
                    ("set", keys[::-1].copy(),
                     _row_values(rng, 200, "float64"), 1500),
                    ("get", np.arange(8, dtype=i64), 2400),
                    ("get", np.arange(8, dtype=i64), 2600)]
    elif case == "spread":
        # one key's rows spread over a batch of 4096; its lowest row sits
        # in a warp whose other 31 rows share one home slot, so they probe
        # past each other and the key's later rows reach the map first
        c.update(cap=8192, ttl=1000)
        n, key = 4096, 77
        keys = rng.choice(np.arange(10 ** 6, 2 * 10 ** 6), n,
                          replace=False).astype(i64)
        keys[:32] = np.insert(_keys_homed(8192, [100] * 31), 7, key)
        keys[[40, 500, 1029, 2050, 3000, 4095]] = key
        ts = np.sort(rng.integers(0, 400, n)).astype(i64)
        c["ops"] = [("dedup", keys, None, ts),
                    ("get", np.array([key], i64), 500),
                    ("dedup", keys, None, ts + 500),
                    ("dedup", keys, None, ts + 2000)]
    elif case == "map_collide":
        # 16 rows, a map of 32 entries: the slots of 8 keys are 5 and of 4
        # keys 6 modulo 32, so they share two entries' probe chains
        c.update(cap=1024, ttl=100)
        homes = [5 + 32 * j for j in range(8)] + [6 + 32 * j
                                                  for j in range(8, 12)]
        hot = _keys_homed(1024, homes)
        keys = rng.permutation(np.concatenate([hot, hot[:4]])).astype(i64)
        c["ops"] = [("dedup", keys, None, np.arange(16, dtype=i64)),
                    ("set", keys[::-1].copy(),
                     _row_values(rng, 16, "float64"), 20),
                    ("get", hot, 50),
                    ("dedup", keys, None, np.arange(16, dtype=i64) * 10 + 60),
                    ("get", hot, 200)]
    elif case == "map_full":
        # distinct keys filling the map to its full load (two entries a
        # row), their slots colliding in it: 256 rows on the one-block
        # path, 2^16 on the many-block path
        out = []
        for n, cap in ((256, 4096), (1 << 16, 1 << 18)):
            keys = rng.choice(10 ** 7, n, replace=False).astype(i64)
            ts = np.sort(rng.integers(0, 100, n)).astype(i64)
            late = ts + np.where(np.arange(n) % 2 == 1, 50, 5000)
            out.append({"cap": cap, "ttl": 1000, "dtype": "float64", "ops": [
                ("dedup", keys, None, ts),
                ("set", keys, _row_values(rng, n, "float64"), ts),
                ("get", keys, 200), ("dedup", keys, None, late),
                ("get", keys, 6000)]})
        return out
    elif case == "set_one_key":
        c.update(cap=64, ttl=100)
        one = np.array([9], i64)
        c["ops"] = [("set", one, _row_values(rng, 1, "float64"), 10),
                    ("get", np.array([9, 3], i64), 50),
                    ("set", one, _row_values(rng, 1, "float64"),
                     np.array([70], i64)),
                    ("get", one, 150), ("get", one, 171),
                    ("set", np.full(3, 9, i64),
                     _row_values(rng, 3, "float64"), 200),
                    ("get", one, 250), ("dedup", one, None,
                                        np.array([400], i64))]
    elif case == "dtypes":
        out = []
        for dt in ROW_DTYPES:
            keys = rng.integers(0, 20, 50).astype(i64)
            out.append({"cap": 64, "ttl": 0, "dtype": dt, "ops": [
                ("set", keys, _row_values(rng, 50, dt), 0),
                ("get", np.arange(24, dtype=i64), 0),
                ("unset", keys[:5].copy()),
                ("get", np.arange(24, dtype=i64), 0),
                ("set", keys[::2].copy(), _row_values(rng, 25, dt), 0),
                ("get", np.arange(24, dtype=i64), 0)]})
        return out
    else:
        raise ValueError(case)
    return [c]


def _keys_homed(cap: int, homes) -> np.ndarray:
    """A distinct key for each of ``homes``: the first non-negative keys
    whose hash (the table's probe hash) lands on that slot of a table of
    ``cap`` slots."""
    import torch

    from flink_tpu_torch.ops.hash_table import hash_keys_device

    cand = np.arange(1 << 22, dtype=np.int64)
    home = hash_keys_device(torch.from_numpy(cand)).numpy() & (cap - 1)
    out, used = [], set()
    for h in homes:
        k = next(int(k) for k in cand[home == h] if int(k) not in used)
        used.add(k)
        out.append(k)
    return np.array(out, np.int64)


def row_state_new(torch, dev, c: dict) -> dict:
    """A config's empty state, with a batch map for its largest batch on
    a card (the plain versions need none)."""
    from flink_tpu_torch.device import torch_dtype
    from flink_tpu_torch.ops.hash_table import make_table
    from flink_tpu_torch.ops.row_state import new_batch_map

    cap = c["cap"]
    most = max([len(op[1]) for op in c["ops"] if op[0] in ("dedup", "set")],
               default=1)
    return {"table": make_table(cap, dev),
            "vals": torch.zeros(cap, dtype=torch_dtype(c["dtype"]),
                                device=dev),
            "presence": torch.zeros(cap, dtype=torch.int8, device=dev),
            "last_ts": (torch.zeros(cap, dtype=torch.int64, device=dev)
                        if c["ttl"] else None),
            "map": new_batch_map(most, dev) if dev.type == "cuda" else None,
            "dirty": torch.zeros((cap >> EDGE_SHIFT) + 1, dtype=torch.uint8,
                                 device=dev)}


def row_map_resting(batch_map) -> bool:
    """A batch map as every call must leave it (``new_batch_map``)."""
    from flink_tpu_torch.ops.row_state import MAP_HEAD

    return bool((batch_map[:MAP_HEAD] == 0).all()
                and (batch_map[MAP_HEAD:] == -1).all())


def row_grow(torch, st: dict) -> None:
    """Double the table and move every plane to its keys' new slots (the
    backend's rehash)."""
    from flink_tpu_torch.ops.hash_table import EMPTY_KEY, lookup_or_insert, \
        make_table

    table = st["table"]
    cap, dev = 2 * table.numel(), table.device
    old = torch.nonzero(table != EMPTY_KEY).flatten()
    new_table = make_table(cap, dev)
    _, slots, ok = lookup_or_insert(new_table, table[old].contiguous())
    assert bool(ok.all()), "row_grow: the doubled table overflowed"
    slots = slots.to(torch.int64)
    for name in ("vals", "presence", "last_ts"):
        if st[name] is not None:
            plane = torch.zeros(cap, dtype=st[name].dtype, device=dev)
            plane[slots] = st[name][old]
            st[name] = plane
    st["table"] = new_table
    st["dirty"] = torch.zeros((cap >> EDGE_SHIFT) + 1, dtype=torch.uint8,
                              device=dev)


def apply_row_op(torch, st: dict, op: tuple, ttl: int) -> dict:
    """One operation of ``row_edge_configs`` through the wrappers (the
    kernels on a card, the plain versions on the CPU); its outputs as
    numpy. A dedup must mark the dirty block of every slot whose key,
    presence or clock it changed, and a kernel must leave its batch map
    as it found it."""
    from flink_tpu_torch.ops.hash_table import lookup_or_insert, \
        sanitize_keys_device
    from flink_tpu_torch.ops.row_state import dedup_first, row_get, \
        row_set, row_unset

    dev = st["table"].device

    def t(a, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    kind = op[0]
    def map_back():
        if st["map"] is not None:
            assert row_map_resting(st["map"]), \
                f"{kind}: the batch map is not back at rest"

    if kind == "dedup":
        _, keys, valid, ts = op
        st["dirty"].zero_()
        before = {k: st[k].clone() for k in ("table", "presence", "last_ts")
                  if st[k] is not None}
        fresh, _slots, status = dedup_first(
            st["table"], st["presence"], st["last_ts"], t(keys),
            None if valid is None else t(valid, torch.bool), t(ts), ttl,
            st["dirty"], EDGE_SHIFT, st["map"])
        s = status.cpu().numpy()
        map_back()
        if not s[0]:
            changed = torch.zeros_like(st["table"], dtype=torch.bool)
            for k, v in before.items():
                changed |= st[k] != v
            blocks = torch.nonzero(changed).flatten() >> EDGE_SHIFT
            assert bool((st["dirty"][blocks] == 1).all()), \
                "a changed slot's dirty block is unmarked"
        return {"fresh": fresh.cpu().numpy(), "failed": bool(s[0]),
                "claims": int(s[1]), "n_fresh": int(s[2])}
    if kind == "set":
        _, keys, vals, now = op
        _, slots, ok = lookup_or_insert(st["table"],
                                        sanitize_keys_device(t(keys)))
        assert bool(ok.all())
        row_set(st["vals"], st["presence"], st["last_ts"], slots,
                t(vals, st["vals"].dtype),
                now if np.ndim(now) == 0 else t(now), st["map"])
        map_back()
        return {}
    if kind == "get":
        v, p = row_get(st["table"], st["vals"], st["presence"], st["last_ts"],
                       t(op[1]), op[2], ttl)
        return {"vals": v.cpu().numpy(), "present": p.cpu().numpy()}
    if kind == "unset":
        slots = row_unset(st["table"], st["presence"], t(op[1]))
        return {"found": (slots >= 0).cpu().numpy()}
    if kind == "grow":
        row_grow(torch, st)
        return {}
    if kind == "fill_clock":
        st["last_ts"].fill_(op[1])
        return {}
    raise ValueError(kind)


def row_state_by_key(table: np.ndarray, planes: dict) -> dict:
    """The state by key, in key order: a key's presence, clock and value
    bits, keys whose every plane holds 0 left out (an absent key reads
    so), so states of two slot layouts compare."""
    occ = np.flatnonzero(table != INT64_MAX)
    order = occ[np.argsort(table[occ], kind="stable")]
    out = {"keys": table[order]}
    keep = np.zeros(len(order), bool)
    for name in ("presence", "last_ts", "vals"):
        a = planes.get(name)
        if a is None:
            continue
        a = np.asarray(a)
        bits = a.view(f"u{a.dtype.itemsize}")[order]
        out[name] = bits
        keep |= bits != 0
    return {k: v[keep] for k, v in out.items()}


def row_state_host(st: dict) -> dict:
    return row_state_by_key(
        st["table"].cpu().numpy(),
        {n: st[n].cpu().numpy() for n in ("presence", "last_ts", "vals")
         if st[n] is not None})


def states_by_key_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def max_abs_diff(torch, pairs) -> float:
    """The largest |a - b| over pairs of tensors or arrays compared entry
    by entry (on a's device): 0.0 when every pair is equal; inf when a
    pair's shapes differ, or where entries differ by less than float64
    shows (or are NaN)."""
    worst = 0.0
    for a, b in pairs:
        a = torch.as_tensor(a)
        b = torch.as_tensor(b).to(a.device)
        if a.shape != b.shape:
            return math.inf
        ne = a != b
        if bool(ne.any()):
            d = float((a[ne].double() - b[ne].double()).abs().max())
            worst = max(worst, d if d > 0 else math.inf)
    return worst


def by_key_diff(torch, a: dict, b: dict) -> float:
    """max_abs_diff of two states by key (``row_state_by_key``)."""
    if a.keys() != b.keys():
        return math.inf
    return max_abs_diff(torch, [(a[k], b[k]) for k in a])


def run_row_edge(torch, dev, c: dict) -> tuple:
    """Every op of a config: (outputs, the state by key after each op)."""
    st = row_state_new(torch, dev, c)
    outs, states = [], []
    for op in c["ops"]:
        outs.append(apply_row_op(torch, st, op, c["ttl"]))
        states.append(row_state_host(st))
    return outs, states


def check_row_edge(torch, dev, case: str) -> dict:
    """The kernels on ``dev`` against the plain versions on the CPU through
    one case: outputs equal (a get's values where present: an absent key
    reads slot 0, whose key differs between the layouts), states equal by
    key after every op; an overflowing dedup leaves presence and clock as
    they were."""
    ops = 0
    for c in row_edge_configs(case):
        got, got_st = run_row_edge(torch, dev, c)
        want, want_st = run_row_edge(torch, torch.device("cpu"), c)
        prev = None
        for i, (op, g, w) in enumerate(zip(c["ops"], got, want)):
            what = f"{case} op {i} ({op[0]})"
            if "present" in g:
                assert np.array_equal(g["present"], w["present"]), what
                p = w["present"]
                assert np.array_equal(g["vals"][p], w["vals"][p]), what
            else:
                assert g.keys() == w.keys() and all(
                    np.array_equal(g[k], w[k]) for k in g), what
            assert states_by_key_equal(got_st[i], want_st[i]), what
            if op[0] == "dedup" and g["failed"]:
                assert not g["fresh"].any(), what
                for name in ("presence", "last_ts"):
                    if name in prev:
                        keys = got_st[i]["keys"]
                        pos = np.searchsorted(keys, prev["keys"])
                        assert np.array_equal(got_st[i][name][pos],
                                              prev[name]), what
            prev = got_st[i]
            ops += 1
    return {"ops": ops}


def row_edges(torch, dev) -> dict:
    return {case: check_row_edge(torch, dev, case)["ops"]
            for case in ROW_EDGE_CASES}


def check_row_backend(torch, dev) -> dict:
    """Keep-first batches (with retractions) through a backend on ``dev``
    and one on the CPU from a 64-slot table: fresh masks, capacities,
    occupancy and snapshots equal after every batch; then a ValueState's
    upserts, lookups and clears on both."""
    from flink_tpu_torch.core import KeyGroupRange
    from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend

    rng = np.random.default_rng(77)
    bs = [DeviceKeyedStateBackend(KeyGroupRange(0, MAXP - 1), MAXP,
                                  capacity=64, device=d)
          for d in (dev, torch.device("cpu"))]
    for b in bs:
        b.register_row_state("seen", np.int8, ttl_ms=300)
        b.register_row_state("v", np.float64, ttl_ms=100)
    caps, fresh_rows = [], 0
    for step in range(10):
        keys = rng.integers(0, 3000, 400).astype(np.int64)
        ts = np.sort(rng.integers(100 * step, 100 * step + 90, 400))
        valid = rng.random(400) > 0.1
        got = [b.dedup_first_batch("seen", keys, ts, valid) for b in bs]
        if not np.array_equal(*got) or len({(b.capacity, b.num_keys)
                                            for b in bs}) != 1:
            raise AssertionError(f"row backend batch {step}: the card's "
                                 "admissions or table differ")
        fresh_rows += int(got[0].sum())
        caps.append(bs[0].capacity)
        for b in bs:
            b.rows_upsert("v", keys[:50], keys[:50] * 0.25, now_ms=ts[:50])
            b.rows_clear("v", keys[50:60])
        looked = [b.rows_lookup("v", np.arange(3100, dtype=np.int64),
                                now_ms=int(ts[-1])) for b in bs]
        if not (np.array_equal(looked[0][1], looked[1][1])
                and np.array_equal(looked[0][0][looked[0][1]],
                                   looked[1][0][looked[1][1]])):
            raise AssertionError(f"row backend batch {step}: lookups differ")
    snaps = [b.snapshot(1) for b in bs]
    if snapshot_digest(snaps[0]) != snapshot_digest(snaps[1]):
        raise AssertionError("row backend: the card's snapshot differs")
    return {"batches": 10, "fresh_rows": fresh_rows, "capacities": caps,
            "rehashes": int(np.log2(caps[-1] // 64))}


#: the big shapes of the row kernels: (label, rows, capacity, keys held)
ROW_SHAPES = (("dedup_10m", 1 << 19, 1 << 24, 10_000_000),
              ("small", 1 << 12, 1 << 16, 30_000))


def row_shape_state(torch, dev, rows: int, cap: int, n_keys: int) -> dict:
    """The state of the dedup cell after its first 16 batches (the mixer's
    keys, ts over the cell's 30 s; at the small shape the same stream over
    fewer keys), built through the kernels, and the 17th batch: keys, ts,
    valid (all), plus a float64 value plane for the set and get."""
    from flink_tpu_torch.ops.hash_table import make_table
    from flink_tpu_torch.ops.row_state import dedup_first, new_batch_map

    span, count, ttl = 30_000, 32 * rows, 10_000
    st = {"table": make_table(cap, dev),
          "presence": torch.zeros(cap, dtype=torch.int8, device=dev),
          "last_ts": torch.zeros(cap, dtype=torch.int64, device=dev),
          "vals": torch.zeros(cap, dtype=torch.float64, device=dev),
          "map": new_batch_map(rows, dev),
          "dirty": torch.zeros((cap >> DIRTY_SHIFT) + 1, dtype=torch.uint8,
                               device=dev), "ttl": ttl}

    def batch(b):
        idx = torch.arange(b * rows, (b + 1) * rows, dtype=torch.int64,
                           device=dev)
        return mixed_keys(idx, n_keys), (idx * span) // count

    for b in range(16):
        keys, ts = batch(b)
        _f, _s, status = dedup_first(st["table"], st["presence"],
                                     st["last_ts"], keys, None, ts, ttl,
                                     st["dirty"], DIRTY_SHIFT, st["map"])
        if int(status[0]):
            raise AssertionError("row shape state: the table overflowed")
    st["keys"], st["ts"] = batch(16)
    return st


def row_clone(st: dict) -> dict:
    return {k: v.clone() if hasattr(v, "clone") else v for k, v in st.items()}


def row_put_back(dst: dict, src: dict) -> None:
    for k in ("table", "presence", "last_ts", "vals"):
        dst[k].copy_(src[k])


def row_state_of(torch, st: dict) -> dict:
    return row_state_by_key(st["table"].cpu().numpy(),
                            {n: st[n].cpu().numpy()
                             for n in ("presence", "last_ts", "vals")})


def row_floors(touched: dict, scratch: int, streamed: int, nbytes: int,
               rates: dict | None, ms: float) -> dict:
    """``list_cost`` of the sectors ``touched`` plus ``scratch`` atomic
    sectors (the earlier design's [capacity] scratch, the floor as first
    printed), the same floors without them (``_no_scratch``), and the
    kernel's ``ms`` as a share of each floor at the measured rates."""
    out = list_cost({**touched, "atomic": scratch}, streamed, nbytes, rates)
    bare = list_cost(touched, streamed, nbytes, rates)
    out["sector_floor_no_scratch_ms"] = bare["sector_floor_ms"]
    if rates is not None:
        out["at_measured_rate_no_scratch_ms"] = bare["at_measured_rate_ms"]
        out["share_of_rate_floor"] = out["at_measured_rate_ms"] / ms
        out["share_of_rate_floor_no_scratch"] = \
            bare["at_measured_rate_ms"] / ms
    return out


def row_shape_cases(torch, dev, flush, rates, label: str, rows: int,
                    cap: int, n_keys: int) -> dict:
    """The four kernels against their plain versions at one shape (the
    plain versions run on the card too, on a copy of the same state),
    each timed with the L2 flushed and the state put back before every
    launch, with its byte bound, its 32-byte sector floor and that floor
    at the card's measured random rates. dedup_first's and row_set's
    floors count the atomic sectors of the earlier design's [capacity]
    int32 scratch, as they were first printed; the ``_no_scratch`` floors
    leave them out (the kernels now fold into a batch map in L2), and
    ``share_of_*`` gives the kernel's time against each."""
    from flink_tpu_torch.ops.hash_table import lookup, \
        lookup_or_insert_plain, sanitize_keys_device
    from flink_tpu_torch.ops.row_state import dedup_first, \
        dedup_first_plain, row_get, row_get_plain, row_set, row_set_plain, \
        row_unset, row_unset_plain

    st = row_shape_state(torch, dev, rows, cap, n_keys)
    base = row_clone(st)
    keys, ts, ttl = st["keys"], st["ts"], st["ttl"]
    n = keys.numel()
    out = {}

    def sectors(idx, esize):
        return distinct_sectors(torch, idx.to(torch.int64) * esize)

    # -- dedup_first --------------------------------------------------------
    def run_dedup(s):
        return dedup_first(s["table"], s["presence"], s["last_ts"], keys,
                           None, ts, ttl, s["dirty"], DIRTY_SHIFT, s["map"])

    def run_dedup_plain(s):
        return dedup_first_plain(s["table"], s["presence"], s["last_ts"],
                                 keys, None, ts, ttl, s["dirty"],
                                 DIRTY_SHIFT)

    def map_at_rest(what):
        if not row_map_resting(st["map"]):
            raise AssertionError(f"{what} at {label}: the batch map is not "
                                 "back at rest")

    plain_st = row_clone(base)
    fk, sk, stk = run_dedup(st)
    fp, sp, stp = run_dedup_plain(plain_st)
    torch.cuda.synchronize()
    map_at_rest("dedup_first")
    err = max(max_abs_diff(torch, [(fk, fp), (stk, stp)]),
              by_key_diff(torch, row_state_of(torch, st),
                          row_state_of(torch, plain_st)))
    if err:
        raise AssertionError(f"dedup_first at {label}: the kernel and the "
                             f"plain version differ by {err}")
    failed, claims, n_fresh = (int(v) for v in stk.tolist())
    ok = sk[sk >= 0].to(torch.int64)
    distinct = torch.unique(ok)
    fresh_slots = sk[fk].to(torch.int64)
    was_held = base["table"][distinct] != INT64_MAX
    new_slots = distinct[~was_held]
    p0 = base["presence"][distinct]
    # the kernel reads a slot's clock only where presence is set, and
    # writes presence (and marks the block) only where the slot is fresh
    # or its presence is not already 1
    clock_read = distinct[p0 > 0]
    written = torch.unique(torch.cat([fresh_slots, distinct[p0 != 1]]))
    ms = cuda_ms(lambda: run_dedup(st), torch, flush,
                 setup=lambda: row_put_back(st, base))
    plain_ms = cuda_ms(lambda: run_dedup_plain(plain_st), torch, flush,
                       reps=3, setup=lambda: row_put_back(plain_st, base))
    # least bytes: a row's key and ts read, its slot and fresh flag
    # written; a distinct key's table entry and presence read (a new
    # key's entry claimed), the clock read where presence is set, presence
    # written where it changes, a fresh key's clock written, a dirty byte a
    # written block
    d = int(distinct.numel())
    nbytes = (n * (8 + 8 + 4 + 1) + d * (8 + 1)
              + int(new_slots.numel()) * 8 + int(clock_read.numel()) * 8
              + int(written.numel()) + n_fresh * 8
              + int(torch.unique(written >> DIRTY_SHIFT).numel()))
    # table sectors: a new key's at the claim's rate, the rest read; the
    # presence sectors that no write covers read
    claim = sectors(new_slots, 8)
    stored = sectors(written, 1)
    cost = row_floors({"claim": claim,
                       "read": sectors(distinct, 8) - claim
                       + sectors(clock_read, 8)
                       + sectors(distinct, 1) - stored,
                       "store": stored + sectors(fresh_slots, 8)},
                      sectors(distinct, 4), n * (8 + 8 + 4 + 1), nbytes,
                      rates, ms)
    out["dedup_first"] = {"rows": n, "capacity": cap, "keys_in_state": int(
        (base["table"] != INT64_MAX).sum()), "distinct_keys": d,
        "claims": claims, "fresh": n_fresh,
        "clock_reads": int(clock_read.numel()),
        "slots_written": int(written.numel()), "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": None, "bound_by": "bytes", **cost,
        "share_of_bound": cost["bound_ms"] / ms}
    # -- row_set: the batch's keys into the value plane, last row wins --------
    row_put_back(st, base)
    _, slots, okk = lookup_or_insert_plain(st["table"],
                                           sanitize_keys_device(keys))
    torch.cuda.synchronize()
    # the table now holds every key: set the kernel's and plain's states
    base2 = row_clone(st)
    vals = (keys % 1000).to(torch.float64) * 0.5
    now = ts + 1

    def run_set(s):
        row_set(s["vals"], s["presence"], s["last_ts"], slots, vals, now,
                s["map"])

    def run_set_plain(s):
        row_set_plain(s["vals"], s["presence"], s["last_ts"], slots, vals,
                      now)

    plain_st = row_clone(base2)
    run_set(st)
    run_set_plain(plain_st)
    torch.cuda.synchronize()
    map_at_rest("row_set")
    err = max_abs_diff(torch, [(st[k], plain_st[k]) for k in
                               ("vals", "presence", "last_ts")])
    if err:
        raise AssertionError(f"row_set at {label}: the kernel and the plain "
                             f"version differ by {err}")
    ms = cuda_ms(lambda: run_set(st), torch, flush,
                 setup=lambda: row_put_back(st, base2))
    plain_ms = cuda_ms(lambda: run_set_plain(plain_st), torch, flush, reps=3,
                       setup=lambda: row_put_back(plain_st, base2))
    ws = torch.unique(slots.to(torch.int64))
    w = int(ws.numel())
    nbytes = n * (4 + 8 + 8) + w * (8 + 1 + 8)
    cost = row_floors({"store": sectors(ws, 8) * 2 + sectors(ws, 1)},
                      sectors(ws, 4), n * (4 + 8 + 8), nbytes, rates, ms)
    out["row_set"] = {"rows": n, "capacity": cap, "slots_written": w,
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": None,
                      "bound_by": "bytes", **cost,
                      "share_of_bound": cost["bound_ms"] / ms}
    # -- row_set of one key: the ValueState path's shape ----------------------
    one = (slots[:1].contiguous(), vals[:1].contiguous(),
           now[:1].contiguous())
    row_put_back(st, base2)
    row_put_back(plain_st, base2)
    row_set(st["vals"], st["presence"], st["last_ts"], *one, st["map"])
    row_set_plain(plain_st["vals"], plain_st["presence"],
                  plain_st["last_ts"], *one)
    torch.cuda.synchronize()
    map_at_rest("row_set of one key")
    err = max_abs_diff(torch, [(st[k], plain_st[k]) for k in
                               ("vals", "presence", "last_ts")])
    if err:
        raise AssertionError(f"row_set of one key at {label}: the kernel "
                             f"and the plain version differ by {err}")
    ms = cuda_ms(lambda: row_set(st["vals"], st["presence"], st["last_ts"],
                                 *one, st["map"]), torch, flush,
                 setup=lambda: row_put_back(st, base2))
    plain_ms = cuda_ms(lambda: row_set_plain(
        plain_st["vals"], plain_st["presence"], plain_st["last_ts"], *one),
        torch, flush, reps=3, setup=lambda: row_put_back(plain_st, base2))
    nbytes = 4 + 8 + 8 + 8 + 1 + 8
    out["row_set_one_key"] = {"rows": 1, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": None,
                              "bound_by": "bytes", "bytes": nbytes,
                              "bound_ms": bound_ms(nbytes)}
    row_put_back(st, base2)
    run_set(st)     # the batch's values, which row_get and row_unset read
    # -- row_get: half the keys of the state, half absent ---------------------
    probe = torch.where(torch.arange(n, device=dev) % 2 == 0, keys,
                        keys + (1 << 40)).contiguous()
    now_get = int(ts[-1]) + 5_000

    def run_get(fn):
        return fn(st["table"], st["vals"], st["presence"], st["last_ts"],
                  probe, now_get, ttl)

    vk, pk = run_get(row_get)
    vp, pp = run_get(row_get_plain)
    torch.cuda.synchronize()
    err = max_abs_diff(torch, [(pk, pp), (vk[pk], vp[pp])])
    if err:
        raise AssertionError(f"row_get at {label}: the kernel and the plain "
                             f"version differ by {err}")
    ms = cuda_ms(lambda: run_get(row_get), torch, flush)
    plain_ms = cuda_ms(lambda: run_get(row_get_plain), torch, flush, reps=3)
    found = lookup(st["table"], sanitize_keys_device(probe))
    fs = torch.unique(found[found >= 0].to(torch.int64))
    nbytes = n * (8 + 8 + 1) + int(fs.numel()) * (8 + 8 + 1 + 8)
    cost = list_cost({"read": sectors(fs, 8) * 3 + sectors(fs, 1)
                      + int((found < 0).sum())},
                     n * (8 + 8 + 1), nbytes, rates)
    out["row_get"] = {"rows": n, "capacity": cap, "present": int(pk.sum()),
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": None,
                      "bound_by": "bytes", **cost,
                      "share_of_bound": cost["bound_ms"] / ms}
    # -- row_unset: the same keys -------------------------------------------
    base3 = row_clone(st)
    plain_st = row_clone(base3)
    uk = row_unset(st["table"], st["presence"], probe)
    up = row_unset_plain(plain_st["table"], plain_st["presence"], probe)
    torch.cuda.synchronize()
    err = max_abs_diff(torch, [(uk >= 0, up >= 0),
                               (st["presence"], plain_st["presence"])])
    if err:
        raise AssertionError(f"row_unset at {label}: the kernel and the "
                             f"plain version differ by {err}")
    ms = cuda_ms(lambda: row_unset(st["table"], st["presence"], probe),
                 torch, flush, setup=lambda: row_put_back(st, base3))
    plain_ms = cuda_ms(lambda: row_unset_plain(plain_st["table"],
                                               plain_st["presence"], probe),
                       torch, flush, reps=3,
                       setup=lambda: row_put_back(plain_st, base3))
    nbytes = n * (8 + 4) + int(fs.numel()) * (8 + 1)
    cost = list_cost({"read": sectors(fs, 8) + int((found < 0).sum()),
                      "store": sectors(fs, 1)}, n * (8 + 4), nbytes, rates)
    out["row_unset"] = {"rows": n, "capacity": cap, "found": int(
        (uk >= 0).sum()), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_by": "bytes", **cost,
        "share_of_bound": cost["bound_ms"] / ms}
    del st, base, base2, base3, plain_st
    return out


def check_row_state(torch, dev, flush, rates: dict | None = None) -> dict:
    """The row kernels against their plain versions: at both shapes
    (``ROW_SHAPES``), on the adversarial sequences (``ROW_EDGE_CASES``)
    and through a backend on the card against one on the CPU."""
    shapes = {label: row_shape_cases(torch, dev, flush, rates, label, rows,
                                     cap, n_keys)
              for label, rows, cap, n_keys in ROW_SHAPES}
    gc.collect()
    torch.cuda.empty_cache()
    # the largest |kernel - plain| over the shapes' outputs and states (the
    # edge cases and the backend compare the same way and raise)
    return {"max_abs_err": max(c["max_abs_err"] for sh in shapes.values()
                               for c in sh.values()),
            "shapes": shapes, "edges": row_edges(torch, dev),
            "backend": check_row_backend(torch, dev)}


# -- keep-first deduplication on the card (dedup_10m) -------------------------
#: Flink's documented keep-first deduplication (ROW_NUMBER() OVER
#: (PARTITION BY id ORDER BY proctime ASC) = 1) with table.exec.state.ttl
DEDUP_CELLS = {"dedup_10m": {"keys": 10_000_000, "events": 1 << 25,
                             "batch": BATCH, "span_ms": 30_000,
                             "ttl_ms": 10_000, "capacity": 1 << 16,
                             "retract_batch": 32}}
DEDUP_RUNS = 2                 # timed runs of the dedup cell
DEDUP_CKPT_RUN_S = 3.0         # the checkpointed run's source pacing
DEDUP_CKPT_INTERVAL_S = 0.25


def dedup_config(cell: str = "dedup_10m", **overrides) -> dict:
    return dict(DEDUP_CELLS[cell], **overrides)


def dedup_gen(torch, c: dict):
    """Row ``idx``: key ``mixed_keys(idx, keys)``, ts ascending over the
    span, the row id, and UPDATE_BEFORE for every row of the retraction
    batch (INSERT elsewhere). Torch indices (device batches) or numpy."""
    n_keys, count, span = c["keys"], c["events"], c["span_ms"]
    batch, rb = c["batch"], c["retract_batch"]

    def gen(idx):
        retract = (idx // batch) == rb
        kind = (retract.astype(np.int8) if isinstance(idx, np.ndarray)
                else retract.to(torch.int8))
        return {"key": mixed_keys(idx, n_keys), "ts": (idx * span) // count,
                "row": idx, "__rowkind__": kind}

    return gen


def dedup_expected(c: dict) -> np.ndarray:
    """The row ids a keep-first deduplication emits, in order, by the
    reference's batch-granular rule (flink_tpu/sql/dedup.py:17-20): in a
    batch, a key's first valid row is fresh when the key is absent or
    its last admission is more than the TTL before the row's ts; every
    valid row's key becomes present; a fresh row restarts its key's
    clock. The retraction batch's rows are not valid."""
    n_keys, count, span, batch = (c["keys"], c["events"], c["span_ms"],
                                  c["batch"])
    present = np.zeros(n_keys, bool)
    last = np.zeros(n_keys, np.int64)
    out = []
    for lo in range(0, count, batch):
        if lo // batch == c["retract_batch"]:
            continue
        idx = np.arange(lo, min(lo + batch, count), dtype=np.int64)
        key = mixed_keys(idx, n_keys)
        ts = (idx * span) // count
        uk, first = np.unique(key, return_index=True)
        t = ts[first]
        fresh = ~(present[uk] & (t - last[uk] <= c["ttl_ms"]))
        present[uk] = True
        last[uk[fresh]] = t[fresh]
        out.append(idx[np.sort(first[fresh])])
    return np.concatenate(out)


def dedup_env(torch, dev, c: dict, count: int | None = None,
              rate: float | None = None, source_hook=None,
              settings: dict | None = None):
    """datagen device batches -> key_by("key") -> DeduplicateOperator(keep
    first, the cell's TTL) -> sink, a watermark after every batch. Returns
    (env, [row ids of each sink batch, on the device])."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.sql.dedup import DeduplicateOperator

    schema = Schema([("key", np.int64), ("ts", np.int64), ("row", np.int64),
                     ("__rowkind__", np.int8)])
    env = StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": c["batch"],
        "pipeline.auto-watermark-interval": 0.0, **(settings or {})}),
        device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    source = DataGenSource(dedup_gen(torch, c), schema,
                           count=count or c["events"], rate_per_sec=rate,
                           timestamp_column="ts", device=True)
    if source_hook is not None:
        source_hook(source)
    got = []

    def sink(b):
        got.append(b.device_column("row"))

    def dedup_factory():
        return DeduplicateOperator(0, keep="first", ttl_ms=c["ttl_ms"],
                                   capacity=c["capacity"], device=dev)

    (env.from_source(source, ws, "DataGen").key_by("key")
     .transform("Deduplicate", dedup_factory).add_sink(sink, "fresh"))
    return env, got


def run_dedup(torch, dev, c: dict, count: int | None = None):
    env, got = dedup_env(torch, dev, c, count)
    return env.execute("dedup-keep-first", timeout=900.0), got


def dedup_operator(job):
    from flink_tpu_torch.sql.dedup import DeduplicateOperator

    ops = [op for op in job.operators if isinstance(op, DeduplicateOperator)]
    if len(ops) != 1:
        raise AssertionError(f"{len(ops)} deduplications in the job")
    return ops[0]


def dedup_rows(got: list) -> np.ndarray:
    return (np.concatenate([g.cpu().numpy() for g in got]) if got
            else np.zeros(0, np.int64))


def dedup_check(expected: np.ndarray, got: list) -> int:
    g = dedup_rows(got)
    if not np.array_equal(g, expected):
        raise AssertionError(f"dedup: {len(g)} rows emitted, {len(expected)} "
                             "expected, or they differ")
    return len(g)


def dedup_run_record(torch, c: dict, run, expected) -> dict:
    """One timed run with the launch counters zeroed just before it:
    every emitted row against the oracle, dedup_first launched once a
    batch at least (twice for a batch that overflowed); events/s, peak
    memory, rehashes, host seconds a batch by part."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.ops import kernels

    start = fresh_memory(torch)
    built = set(p.name for p in kernels.BUILD_DIR.glob("*.so"))
    reset_launches()
    job, got = run()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    rows = dedup_check(expected, got)
    op = dedup_operator(job)
    st = op.stats
    b = op.backend
    if launches["dedup_first"] != st["batches"] + b.row_overflows:
        raise AssertionError(f"dedup: {launches['dedup_first']} launches "
                             f"for {st['batches']} batches and "
                             f"{b.row_overflows} retries")
    return {"wall_s": job.wall_s, "events_per_sec": c["events"] / job.wall_s,
            "fresh_rows": rows, "peak": peak, "start": start,
            "launches": launches, "capacity": b.capacity,
            "keys_in_state": b.num_keys,
            "rehashes": int(np.log2(b.capacity // c["capacity"])),
            "overflow_retries": b.row_overflows, "batches": st["batches"],
            "host_s_per_batch": {k: st[k] / st["batches"]
                                 for k in ("prep_s", "admit_s", "compact_s",
                                           "emit_s")},
            "kernel_builds_after_warmup": len(
                set(p.name for p in kernels.BUILD_DIR.glob("*.so")) - built),
            "tasks": task_record(job)}


def dedup_profile(torch, run) -> dict:
    """A run under torch.profiler: the card's busy time by kernel against
    the run's wall time; the profiler's count of dedup_first's kernel must
    equal its launch counter."""
    from torch.autograd import DeviceType

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    symbols = ("dedup_first_kernel",)
    for tries in range(1, PROFILE_TRIES + 1):
        reset_launches()
        with card_profile(torch, host=True) as prof:
            job, _got = run()
        by_name: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                acc = by_name.setdefault(e.name[:90], [0.0, 0])
                acc[0] += e.self_device_time_total / 1e3
                acc[1] += 1
        counted = {s: sum(n for name, (_ms, n) in by_name.items()
                          if s in name) for s in symbols}
        if set(counted.values()) == {KERNEL_LAUNCHES["dedup_first"]}:
            break
    else:
        raise ProfileRecordsLost(f"profiler counted {counted}, the counter "
                                 f"{KERNEL_LAUNCHES['dedup_first']}")
    busy = sum(ms for ms, _n in by_name.values())
    wall = job.wall_s * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if wall else None,
            "profiles_taken": tries,
            "dedup_first_device_ms": sum(
                ms for name, (ms, _n) in by_name.items()
                if any(s in name for s in symbols)),
            "dedup_first_launches": KERNEL_LAUNCHES["dedup_first"],
            "top": [{"name": k, "ms": ms, "calls": n}
                    for k, (ms, n) in top]}


def dedup_checkpoint(torch, dev, c: dict, expected: np.ndarray) -> dict:
    """A checkpoint mid-run and a restore into a fresh job that continues:
    the source paced, paused after the first completed checkpoint; after
    a checkpoint triggered during the pause completes, the job is
    cancelled and a new job restores from it. The rows of the two jobs,
    one after the other, equal the oracle's: none lost, none repeated."""
    sources = []
    env, got = dedup_env(
        torch, dev, c, rate=c["events"] / DEDUP_CKPT_RUN_S,
        source_hook=sources.append,
        settings={"execution.checkpointing.interval": DEDUP_CKPT_INTERVAL_S})
    job = env.execute_async("dedup-checkpointed")

    def completed(after: float) -> int:
        return len([s for s in job.coordinator.stats
                    if s.get("started", 0.0) > after
                    and not s.get("failed")])

    def wait(n: int, after: float) -> None:
        t0 = time.perf_counter()
        while (completed(after) < n and not job._failed
               and time.perf_counter() - t0 < 300):
            time.sleep(0.002)
        if completed(after) < n:
            raise AssertionError(f"dedup: no checkpoint completed after "
                                 f"{after}: {job._failed}")

    wait(1, 0.0)
    sources[0].set_rate(0)
    paused = time.time()
    wait(1, paused)
    job.cancel()
    cp = job.coordinator.latest_checkpoint()
    before = dedup_rows(got)
    del job, env, got
    env2, got2 = dedup_env(torch, dev, c)
    env2.restore_from_checkpoint(cp)
    t0 = time.perf_counter()
    job2 = env2.execute("dedup-restored", timeout=900.0)
    restored_s = time.perf_counter() - t0
    after = dedup_rows(got2)
    if not np.array_equal(np.concatenate([before, after]), expected):
        raise AssertionError(f"dedup checkpoint: {len(before)} rows before "
                             f"the cancel and {len(after)} after the "
                             f"restore are not the oracle's {len(expected)}")
    if not len(before) or not len(after):
        raise AssertionError("dedup checkpoint: one job emitted nothing")
    return {"restored_from": cp.checkpoint_id, "rows_before": len(before),
            "rows_after_restore": len(after), "rows_repeated": 0,
            "restored_run_s": restored_s,
            "keys_restored_capacity": dedup_operator(job2).backend.capacity}


def dedup_cell(torch, dev, cell: str = "dedup_10m") -> dict:
    """The dedup cell: a warm-up run of 4 batches, ``DEDUP_RUNS`` timed
    runs, a profiled run, then the checkpoint and restore; every run's
    rows against the oracle."""
    c = dedup_config(cell)
    expected = dedup_expected(c)
    job, got = run_dedup(torch, dev, c, count=4 * c["batch"])
    del job, got
    runs = [dedup_run_record(torch, c, lambda: run_dedup(torch, dev, c),
                             expected) for _ in range(DEDUP_RUNS)]
    prof = cell_profile(torch, dev, cell)
    ckpt = dedup_checkpoint(torch, dev, c, expected)
    eps = sorted(r["events_per_sec"] for r in runs)
    last = runs[-1]
    return {"cell": cell, **c, "runs": len(runs),
            "events_per_sec": float(np.median(eps)),
            "events_per_sec_min_max": [eps[0], eps[-1]],
            "wall_s": [r["wall_s"] for r in runs],
            "fresh_rows": last["fresh_rows"],
            "max_memory_allocated": max(r["peak"] for r in runs),
            "memory_at_start": [r["start"] for r in runs],
            "capacity": last["capacity"],
            "keys_in_state": last["keys_in_state"],
            "rehashes": last["rehashes"],
            "overflow_retries": last["overflow_retries"],
            "batches": last["batches"],
            "host_s_per_batch": last["host_s_per_batch"],
            "kernel_builds_after_warmup": sum(
                r["kernel_builds_after_warmup"] for r in runs),
            "launches_per_run": last["launches"],
            "tasks_last_run": last["tasks"], "profile": prof,
            "checkpoint": ckpt}


VALUE_TTL_S = 2.0               # the ValueState phase's TTL


def value_state_phase(torch, dev) -> dict:
    """ValueState over the row plane on the card: a few hundred keys of
    update, value and clear, and TTL expiry, against a dict; the launch
    counters zeroed just before, read after: row_set, row_get and
    row_unset each launched."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.core import KeyGroupRange
    from flink_tpu_torch.state.descriptors import StateTtlConfig, \
        ValueStateDescriptor
    from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend

    rng = np.random.default_rng(14)
    reset_launches()
    t0 = time.perf_counter()
    b = DeviceKeyedStateBackend(KeyGroupRange(0, MAXP - 1), MAXP,
                                capacity=256, device=dev)
    h = b.get_partitioned_state(ValueStateDescriptor(
        "total", default=0.0, ttl=StateTtlConfig(VALUE_TTL_S)))
    want = {}
    for i, key in enumerate(rng.integers(0, 300, 600).tolist()):
        b.set_current_key(key)
        if i % 9 == 8:
            h.clear()
            want.pop(key, None)
        else:
            h.update(h.value() + i)
            want[key] = want.get(key, 0.0) + i
    got = {}
    for key in range(300):
        b.set_current_key(key)
        v = h.value()
        if v != want.get(key, 0.0):
            raise AssertionError(f"ValueState key {key}: {v}, "
                                 f"{want.get(key, 0.0)} expected")
        got[key] = v
    if time.perf_counter() - t0 > VALUE_TTL_S / 2:
        raise AssertionError("ValueState: the writes and reads took more "
                             "than half the TTL, so some may have expired")
    time.sleep(VALUE_TTL_S + 0.05)      # past the TTL of every write
    expired = 0
    for key in want:
        b.set_current_key(key)
        expired += h.value() == 0.0
    if expired != len(want):
        raise AssertionError(f"{len(want) - expired} values outlived "
                             "their TTL")
    launches = dict(KERNEL_LAUNCHES)
    if not all(launches[k] for k in ("row_set", "row_get", "row_unset")):
        raise AssertionError(f"ValueState: launches {launches}")
    return {"keys": len(want), "ops": 600 + 300 + len(want),
            "expired": expired, "capacity": b.capacity,
            "seconds": time.perf_counter() - t0, "launches": launches}


# -- the SQL joins on the host plane (sql_join) --------------------------------
SQL_JOIN_AUCTIONS = 1 << 16    # 2^17 and 2^15 before runtime_io, 2^18 and
SQL_JOIN_PERSONS = 1 << 14     # 2^16 before connectors: cut for the time limit
SQL_JOIN_Q3 = ("SELECT A.id AS aid, A.seller AS seller, P.id AS pid "
               "FROM auction AS A INNER JOIN person AS P "
               "ON A.seller = P.id WHERE A.category = 10")
SQL_JOIN_LEFT_AGG = ("SELECT A.seller AS seller, COUNT(*) AS c, "
                     "SUM(A.id) AS s FROM auction AS A LEFT JOIN person AS P "
                     "ON A.seller = P.id GROUP BY A.seller")
SQL_JOIN_TEMPORAL = ("SELECT A.id AS aid, A.category AS category, "
                     "P.id AS pid FROM auction AS A JOIN person "
                     "FOR SYSTEM_TIME AS OF A.ts AS P ON A.seller = P.id")


def sql_join_tables(t_env, auctions: int, persons: int) -> None:
    """Nexmark's auction and person tables through the datagen DDL:
    person.id a sequence, auction.seller random over [0, sellers) (a few
    beyond the persons), auction.category random over [0, 15], event time
    the row's sequence number."""
    sellers = persons + max(persons >> 4, 1)
    for stmt in (
            "CREATE TABLE person (id BIGINT, ts BIGINT, WATERMARK FOR ts AS "
            "ts - INTERVAL '0' SECOND) WITH ('connector' = 'datagen', "
            f"'number-of-rows' = '{persons}')",
            "CREATE TABLE auction (id BIGINT, seller BIGINT, category BIGINT,"
            " ts BIGINT, WATERMARK FOR ts AS ts - INTERVAL '0' SECOND) WITH "
            f"('connector' = 'datagen', 'number-of-rows' = '{auctions}', "
            "'fields.seller.kind' = 'random', 'fields.seller.min' = '0', "
            f"'fields.seller.max' = '{sellers - 1}', "
            "'fields.category.kind' = 'random', "
            "'fields.category.min' = '0', 'fields.category.max' = '15')"):
        t_env.execute_sql(stmt)


def sql_join_random(idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The datagen connector's random field (sql/ddl.py::_datagen_fn)."""
    u = (idx.astype(np.uint64) * np.uint64(MULT)) >> np.uint64(33)
    return lo + (u % np.uint64(hi - lo + 1)).astype(np.int64)


def sql_join_expected(auctions: int, persons: int) -> dict:
    """Dict oracles of the three queries' final rows."""
    sellers = persons + max(persons >> 4, 1)
    aid = np.arange(auctions, dtype=np.int64)
    seller = sql_join_random(aid, 0, sellers - 1)
    category = sql_join_random(aid, 0, 15)
    known = seller < persons
    q3 = sorted(zip(aid[(category == 10) & known].tolist(),
                    seller[(category == 10) & known].tolist()))
    agg = {}
    for s, a in zip(seller.tolist(), aid.tolist()):
        c, t = agg.get(s, (0, 0))
        agg[s] = (c + 1, t + a)
    temporal = known & (seller <= aid)   # person s's version from ts = s
    return {"q3": q3, "left_agg": agg,
            "temporal": sorted(zip(aid[temporal].tolist(),
                                   category[temporal].tolist(),
                                   seller[temporal].tolist()))}


def run_sql_join(torch, dev, query: str, auctions: int = SQL_JOIN_AUCTIONS,
                 persons: int = SQL_JOIN_PERSONS, batch: int = 1 << 14):
    from flink_tpu_torch.sql import TableEnvironment

    """One query over ``sql_join_tables``; returns (wall seconds of the
    statement, planning included, and its result). A query over catalog
    tables runs in an environment of its own."""
    t_env = TableEnvironment(sql_env(torch, dev, batch))
    sql_join_tables(t_env, auctions, persons)
    t0 = time.perf_counter()
    res = t_env.execute_sql(query, timeout=SQL_TIMEOUT_S)
    return time.perf_counter() - t0, res


def sql_join_check(name: str, expected: dict, res) -> int:
    rows = res.collect_final()
    if name == "q3":
        got = sorted((int(a), int(s)) for a, s, p in rows if p == s)
        ok = got == expected["q3"] and len(rows) == len(got)
    elif name == "left_agg":
        got = {int(s): (int(c), int(t)) for s, c, t in rows}
        ok = got == expected["left_agg"]
    else:
        got = sorted((int(a), int(c), int(p)) for a, c, p in rows)
        ok = got == expected["temporal"]
    if not ok:
        raise AssertionError(f"sql_join {name}: {len(rows)} final rows "
                             "differ from the oracle")
    return len(rows)


def sql_join_phase(torch, dev, auctions: int = SQL_JOIN_AUCTIONS,
                   persons: int = SQL_JOIN_PERSONS) -> dict:
    """The SQL joins through ``execute_sql`` on datagen tables (the host
    plane: the reference's operators, rows joined in Python): a Nexmark
    Q3-shaped inner join, a LEFT JOIN under a GROUP BY over its changelog
    (the device GROUP BY, retracting the null-padded rows) and a temporal
    join; each one timed run, its final rows against a dict oracle."""
    expected = sql_join_expected(auctions, persons)
    out = {"auctions": auctions, "persons": persons, "plane": "host"}
    for name, query in (("q3", SQL_JOIN_Q3), ("left_agg", SQL_JOIN_LEFT_AGG),
                        ("temporal", SQL_JOIN_TEMPORAL)):
        wall, res = run_sql_join(torch, dev, query, auctions, persons)
        rows = sql_join_check(name, expected, res)
        out[name] = {"sql": query, "final_rows": rows,
                     "changelog_rows": len(res.collect()), "wall_s": wall,
                     "input_rows_per_sec": (auctions + persons) / wall}
    return out


#: the cells whose profile a fresh process can take again (``--profile
#: CELL``): the profile function, the run it profiles, the cell's warm-up
# -- faults, the watchdog and the supervisor ---------------------------------
#: (run, faults.spec, extra keys) of the faults phase at Q5-1M; the visit
#: numbers count guarded dispatches (each ingest step and each fire visits
#: device.execute once): the poison trips the first step, the persistent
#: fault lands late in the stream so the CPU rung's share stays short
FAULT_RUNS = (
    ("transient", "device.execute=p0.2", {}),
    ("persistent", "device.execute=once@22!persistent", {}),
    ("poison", "device.execute=once@1!poison", {}),
    ("hang", "device.execute=once@5!hang@3000",
     {"watchdog.device.execute-timeout": 1.0}),
)
FAULT_SEED = 17
RESTART_RUN_S = 3.0            # the supervised run's source pacing
RESTART_INTERVAL_S = 0.5       # and its checkpoint interval
RESTART_SPEC = "sink.invoke=once@8!persistent"
WATCHDOG_RUNS = 3              # Q5-10M runs with the watchdog on and off
#                                (5 before the connectors phase: cut for
#                                the time limit)
HANDOFF_CALLS = 20_000         # no-op guarded and supervised calls timed
HANDOFF_REPEATS = 5            # on the host, this many times each


def fault_counters() -> dict:
    """The device guard's, the ladder's and the watchdog's counters."""
    from flink_tpu_torch.metrics import DEVICE_STATS
    snap = DEVICE_STATS.snapshot()
    return {k: snap[k] for k in ("device_retries_total",
                                 "device_degraded_total",
                                 "dead_letter_records_total",
                                 "dead_letter_batches_total",
                                 "watchdog_trips_total",
                                 "injected_faults_total",
                                 "stall_detections_total")}


def counters_delta(before: dict) -> dict:
    now = fault_counters()
    return {k: now[k] - before[k] for k in now}


def fault_run(torch, dev, name: str, spec: str, extra: dict, expected,
              n_keys: int, n_events: int, cap: int,
              batch: int = BATCH) -> dict:
    """One Q5 run through ``env.execute()`` under ``spec``: its windows
    against ``expected`` (under the tie rule), the counters it moved, the
    trip log and what the operator did."""
    from flink_tpu_torch.runtime.faults import FAULTS
    from flink_tpu_torch.runtime.watchdog import WATCHDOG

    FAULTS.reset()
    WATCHDOG.reset()
    before = fault_counters()
    fresh_memory(torch)
    job, got, _span = run_q5(
        torch, dev, n_keys, n_events, cap, batch=batch,
        settings={"faults.enabled": True, "faults.seed": FAULT_SEED,
                  "faults.spec": spec, **extra})
    windows = q5_check(expected, got)
    op = job.operators[0]
    moved = counters_delta(before)
    return {"run": name, "spec": spec, **extra,
            "windows_checked": windows, "wall_s": job.wall_s,
            "events_per_sec": n_events / job.wall_s,
            "counters": moved, "trips": list(FAULTS.events),
            "visits": FAULTS.snapshot()["visits"],
            "guard": {"retries": op._guard.retries,
                      "failures": op._guard.failures,
                      "stalls": op._guard.stalls},
            "degraded": op._degraded, "degrade_s": op.degrade_s,
            "quarantined_batches": op.quarantined_batches,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def supervised_run(torch, dev, n_keys: int, n_events: int, cap: int,
                   expected, spec: str, batch: int = BATCH,
                   extra: dict | None = None) -> dict:
    """Q5 through ``env.execute(recover=True)`` with checkpoints every
    RESTART_INTERVAL_S, the source paced to RESTART_RUN_S, into a
    two-phase sink; ``spec`` (may be empty) arms the faults. Every window
    against the oracle, none twice; the attempts, restores and peak
    memory."""
    from flink_tpu_torch.connectors.core import TransactionalCollectSink
    from flink_tpu_torch.runtime.faults import FAULTS

    FAULTS.reset()
    sink = TransactionalCollectSink()
    before = fault_counters()
    fresh_memory(torch)
    env, _got, _span = q5_env(
        torch, dev, n_keys, n_events, cap, batch=batch,
        rate=n_events / RESTART_RUN_S, sink=sink,
        settings={"execution.checkpointing.interval": RESTART_INTERVAL_S,
                  "restart-strategy.type": "fixed-delay",
                  "restart-strategy.fixed-delay.delay": 0.0,
                  **({"faults.enabled": True, "faults.spec": spec}
                     if spec else {}), **(extra or {})})
    t0 = time.perf_counter()
    job = env.execute("q5-supervised", recover=True)
    wall = time.perf_counter() - t0
    sup = env.last_supervisor
    got = [(int(b.timestamps[0]), b.column("auction"), b.column("bids"),
            b.column("revenue")) for b in sink.batches]
    ends = [(ts + 1) // PANE_MS for ts, *_ in got]
    if len(ends) != len(set(ends)):
        raise AssertionError(f"a window was emitted twice: {ends}")
    windows = q5_check(expected, got)
    restored = [h.get("restored_checkpoint") for h in sup.failure_history
                if h["kind"] == "restart"]
    return {"spec": spec or None, "attempts": sup.attempt,
            "failure_kinds": [h["kind"] for h in sup.failure_history],
            "restored_checkpoints": restored,
            "restart_s": sup.restart_s, "wall_s": wall,
            "checkpoints_completed": len(
                [st for st in job.coordinator.stats if not st.get("failed")]),
            "windows_checked": windows, "windows_repeated": 0,
            "counters": counters_delta(before),
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def watchdog_cost(torch, dev, cell: tuple = Q5_CELLS[1],
                  batch: int = BATCH) -> dict:
    """The watchdog's cost at Q5-10M full: WATCHDOG_RUNS runs with the
    watchdog at its defaults and with ``watchdog.enabled`` false, in turns
    (on, off, on, off, ...); events/s of each, their median, range and
    spread, and the guarded and supervised calls of the on runs. Then the
    host cost of one call alone, HANDOFF_REPEATS times HANDOFF_CALLS
    no-op calls each: a guarded dispatch (on the caller's thread) and a
    supervised call (handed to the worker), against as many direct
    calls."""
    from flink_tpu_torch.runtime.faults import FAULTS, DeviceGuard
    from flink_tpu_torch.runtime.watchdog import WATCHDOG

    label, n_keys, n_events, cap = cell
    expected = q5_expected(n_keys, n_events,
                           q5_panes(n_events, batch) * PANE_MS)
    FAULTS.reset()
    runs = {"on": [], "off": []}
    for _ in range(WATCHDOG_RUNS):
        for mode in ("on", "off"):
            WATCHDOG.reset()
            calls0 = WATCHDOG.calls
            fresh_memory(torch)
            job, got, _span = run_q5(
                torch, dev, n_keys, n_events, cap, batch=batch,
                settings={"watchdog.enabled": mode == "on"})
            q5_check(expected, got)
            runs[mode].append({
                "wall_s": job.wall_s, "events_per_sec": n_events / job.wall_s,
                "guarded_calls": job.operators[0]._guard.calls,
                "supervised_calls": WATCHDOG.calls - calls0})
            del job, got
    WATCHDOG.reset()

    def per_call_us(fn) -> list:
        out = []
        for _ in range(HANDOFF_REPEATS):
            t0 = time.perf_counter()
            for _ in range(HANDOFF_CALLS):
                fn()
            on_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(HANDOFF_CALLS):
                int()
            out.append((on_s - (time.perf_counter() - t0))
                       / HANDOFF_CALLS * 1e6)
        return out

    guard = DeviceGuard("watchdog_cost")
    guarded = per_call_us(lambda: guard.run(int))
    supervised = per_call_us(lambda: WATCHDOG.run("transfer.d2h", int))
    eps = {m: [r["events_per_sec"] for r in rs] for m, rs in runs.items()}
    med = {m: float(np.median(v)) for m, v in eps.items()}
    return {"cell": f"Q5-{label} full", "events": n_events,
            "runs": runs,
            "events_per_sec": {m: {"median": med[m], "min": min(v),
                                   "max": max(v),
                                   "spread": (max(v) - min(v)) / med[m]}
                               for m, v in eps.items()},
            "on_over_off_median": med["on"] / med["off"],
            "guarded_calls_per_run": runs["on"][0]["guarded_calls"],
            "supervised_calls_per_run": [r["supervised_calls"]
                                         for r in runs["on"]],
            "guarded_us_per_call": guarded,
            "supervised_us_per_call": supervised,
            "workers_started": WATCHDOG.workers_started}


def faults_phase(torch, dev, cell: tuple = Q5_CELLS[0],
                 cost_cell: tuple = Q5_CELLS[1], batch: int = BATCH
                 ) -> dict:
    """Faults, the watchdog and the supervisor on Q5-1M at its full
    widths (1M keys, capacity 2^21, ring 16, batch 2^19, W = 5, top 1000
    by count with sum(price), 2^23 events), every run through
    ``env.execute()`` and every window against the oracle:

    * transient ``device.execute`` trips on a seeded schedule: retries;
    * a persistent trip late in the stream: exactly one degrade, the rest
      on the CPU rung, its evacuation timed;
    * a poison trip on the first step: exactly that batch quarantined,
      the oracle without it;
    * a hang above a 1 s ``device.execute`` deadline: one watchdog trip
      and one retry;
    * ``execute(recover=True)`` with checkpoints and a persistent
      ``sink.invoke`` trip after the first completed checkpoint: one
      restart from it, no window twice, peak memory beside the same run
      without the fault;
    * the watchdog's cost at Q5-10M full (``watchdog_cost``)."""
    import tempfile

    label, n_keys, n_events, cap = cell
    span = q5_panes(n_events, batch) * PANE_MS
    expected = q5_expected(n_keys, n_events, span)
    # the stall's and the restart's flight-recorder dumps go here (the
    # tracing phase reports them)
    flight = {"traces.flight-recorder.dir": tempfile.mkdtemp(
        prefix="flink_tpu_torch_flight_")}
    runs = {}
    for name, spec, extra in FAULT_RUNS:
        exp = (q5_expected(n_keys, n_events, span, skip=(0, batch))
               if name == "poison" else expected)
        if name == "hang":
            extra = {**extra, **flight}
        runs[name] = rec = fault_run(torch, dev, name, spec, extra, exp,
                                     n_keys, n_events, cap, batch)
        c = rec["counters"]
        ok = {"transient": c["device_retries_total"] > 0
              and not rec["degraded"] and not rec["quarantined_batches"],
              "persistent": c["device_degraded_total"] == 1
              and rec["degraded"],
              "poison": rec["quarantined_batches"] == 1
              and c["dead_letter_batches_total"] == 1
              and c["dead_letter_records_total"] == batch
              and not rec["degraded"],
              "hang": c["watchdog_trips_total"] == 1
              and rec["guard"]["stalls"] == 1
              and c["device_retries_total"] == 1
              and not rec["degraded"]}[name]
        if not ok:
            raise AssertionError(f"faults phase, {name} run: {rec}")
        emit({"faults_run": name, **{k: v for k, v in rec.items()
                                     if k != "trips"},
              "trips": rec["trips"][:16]})
        if name == "hang":
            FLIGHT_DUMPS["stall"] = flight_dump(
                flight, "stall", "watchdog", "Stall")
    clean = supervised_run(torch, dev, n_keys, n_events, cap, expected, "",
                           batch)
    restart = supervised_run(torch, dev, n_keys, n_events, cap, expected,
                             RESTART_SPEC, batch, flight)
    FLIGHT_DUMPS["job-restart"] = flight_dump(flight, "job-restart",
                                              "restart", "JobRestart")
    if not (clean["attempts"] == 1 and restart["attempts"] == 2
            and restart["failure_kinds"] == ["task-failure", "restart"]
            and restart["restored_checkpoints"] != [None]):
        raise AssertionError(f"supervised runs: {clean} {restart}")
    cost = watchdog_cost(torch, dev, cost_cell, batch)
    return {"faults_phase": f"Q5-{label}", "keys": n_keys,
            "events": n_events, "capacity": cap, "batch": batch,
            "runs": runs, "supervised": {"without_fault": clean,
                                         "with_restart": restart},
            "flight_dumps": FLIGHT_DUMPS, "watchdog_cost": cost}


# -- the multi-device window path (mesh) -------------------------------------
MESH_SHARDS = 4                # shards of the mesh cells, all on the one card
MESH_CAPACITY = 1 << 23        # slots a shard at Q5-10M (2.5M keys a shard)
MESH_DEVICE_BATCH = 1 << 17    # a source block: a 2^19-row batch is 4
MESH_RESCALE_TO = (2, 1, 4)    # live_rescale's shard counts, mid-run
MESH_RESCALE_RUN_S = 24.0      # the rescaled run's source pacing: 6 s a step
#                                (a rescale takes 2.6 to 4 s on an H100's
#                                host; at 4 s a step the last one could
#                                start after the source had ended)
MESH_RESTORE_CUT = 8           # batches before the cross restores' snapshot
MESH_RUNS = 2                  # timed runs of each fire mode of the cell
# a mesh run's peak over its resident tensors (tables, pane planes,
# incremental planes, exchange buffers): the fire's temporaries took 1.06x
# to 1.14x at the cell; a second copy of the state would take 2x
MESH_PEAK_MARGIN = 1.3
MESH_START_SHARE = 0.05        # memory left allocated before a run, at most
MESH_CELLS = {
    "q5_10m": {"keys": 10_000_000, "events": 1 << 25, "batch": BATCH,
               "shards": MESH_SHARDS, "device_batch": MESH_DEVICE_BATCH,
               "capacity": MESH_CAPACITY},
    "q5_1m": {"keys": 1_000_000, "events": 1 << 23, "batch": BATCH,
              "shards": MESH_SHARDS, "device_batch": MESH_DEVICE_BATCH,
              "capacity": 1 << 20},
    # a mesh that must grow: 4 shards of 2^12 slots against 100K keys
    "grow": {"keys": 100_000, "events": 1 << 18, "batch": 1 << 12,
             "shards": MESH_SHARDS, "device_batch": 1 << 10,
             "capacity": 1 << 12},
}


def mesh_config(cell: str = "q5_10m", **overrides) -> dict:
    return {**MESH_CELLS[cell], **overrides}


def mesh_span(c: dict) -> int:
    return q5_panes(c["events"], c["batch"]) * PANE_MS


def mesh_q5_env(torch, dev, c: dict, fire_mode: str = "full",
                rate: float | None = None, settings: dict | None = None,
                sink=None):
    """Q5 through ``mesh_aggregate`` on a fresh environment, not yet
    executed: ``c`` (``mesh_config``) gives keys, events, batch, shards,
    device_batch and capacity (a shard's slots). Returns (env, got,
    source), ``got`` as ``q5_env``'s."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import SlidingEventTimeWindows

    span = mesh_span(c)
    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    got = []

    def collect(b):
        got.append((int(b.timestamps[0]), b.column("auction"),
                    b.column("bids"), b.column("revenue")))

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": c["batch"],
                       "window.fire.incremental": fire_mode == "incremental",
                       "pipeline.auto-watermark-interval": 0.0,
                       **(settings or {})}), device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    source = DataGenSource(q5_gen(c["keys"], c["events"], span), schema,
                           count=c["events"], rate_per_sec=rate,
                           timestamp_column="ts", device=True)
    (env.from_source(source, ws, "DataGen")
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS))
        .mesh_aggregate([AggSpec("count", out_name="bids", value_bits=31),
                         AggSpec("sum", "price", out_name="revenue")],
                        n_devices=c["shards"], capacity=c["capacity"],
                        ring_size=RING, device_batch=c["device_batch"],
                        emit_window_bounds=False,
                        emit_topk=c.get("topk", TOPK), async_fire=True)
        .add_sink(collect if sink is None else sink))
    return env, got, source


def run_mesh_q5(torch, dev, c: dict, fire_mode: str = "full", **kw):
    """One run of ``mesh_q5_env``'s pipeline through ``env.execute()``;
    returns (the finished job, windows)."""
    env, got, _source = mesh_q5_env(torch, dev, c, fire_mode, **kw)
    job = env.execute("nexmark-q5-mesh")
    return job, got


def mesh_q5_expected(c: dict) -> list:
    return q5_expected(c["keys"], c["events"], mesh_span(c),
                       c.get("topk", TOPK))


def mesh_operator(job):
    from flink_tpu_torch.runtime.operators import MeshWindowAggOperator
    return next(op for op in job.operators
                if isinstance(op, MeshWindowAggOperator))


def run_mesh_direct(torch, dev, c: dict, fire_mode: str = "full"):
    """The mesh Q5 job's reader and chain driven on the calling thread
    (``run_q5_direct``'s loop), so nothing else enqueues work on the card
    while a fire is timed. Returns (operator, windows)."""
    from flink_tpu_torch.cluster import deploy_local
    from flink_tpu_torch.core.elements import MAX_WATERMARK, Watermark

    env, got, _source = mesh_q5_env(torch, dev, c, fire_mode)
    job = deploy_local(env.get_job_graph("nexmark-q5-mesh-direct"),
                       env.config, env.device)
    (src,) = job.source_tasks.values()
    (win,) = [t for t in job.tasks.values() if t is not src]
    chain, reader, ws = win.chain, src.reader, src.ws
    chain.open()
    gen = ws.create_generator()
    last = MIN_TIMESTAMP
    while (batch := reader.read_batch(c["batch"])) is not None:
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
    return mesh_operator(job), got


def _q5_block(torch, dev, c: dict, first_row: int, rows: int):
    """Q5's rows [first_row, first_row + rows) on the card: (auction,
    price, ts)."""
    idx = torch.arange(first_row, first_row + rows, dtype=torch.int64,
                       device=dev)
    cols = q5_gen(c["keys"], c["events"], mesh_span(c))(idx)
    return cols["auction"], cols["price"], cols["ts"]


EXCHANGE_CASES = ("cell", "one_shard", "empty", "sentinel_and_negative",
                  "base_subset", "three_shards", "d256_small_block",
                  "block_to_own_destination", "back_to_back",
                  "after_shape_change")
#: a small source block: the mesh Q5-1M cells' (device_batch 2^12)
EXCHANGE_SMALL_BLOCK = 1 << 12


def exchange_case(torch, dev, c: dict, case: str,
                  batch_no: int = PRESENT_PREFIX) -> dict:
    """The inputs of one exchange case: S = shards source blocks of
    device_batch rows of the stream's batch ``batch_no`` (Q5-10M's 33rd
    for the cell), with D, n_valid, the ownership bounds and the max
    parallelism. ``back_to_back`` and ``after_shape_change`` start from
    the cell's inputs (``check_exchange`` runs them)."""
    S, B = c["shards"], c["device_batch"]
    if case == "d256_small_block":
        B = EXCHANGE_SMALL_BLOCK
    keys, price, ts = _q5_block(torch, dev, c, batch_no * c["batch"], S * B)
    D, n_valid, start, length, maxp = S, S * B, 0, MAXP, MAXP
    if case == "one_shard":
        keys = torch.full_like(keys, 12345)
    elif case == "empty":
        n_valid = 0
    elif case == "sentinel_and_negative":
        keys = keys - c["keys"] // 2
        keys[:4] = torch.tensor([INT64_MAX, INT64_MAX - 1, -1, -(1 << 63)],
                                device=dev)
    elif case == "base_subset":
        n_valid, start, length = S * B - 1000, 32, 64
    elif case == "three_shards":
        D = 3
    elif case == "d256_small_block":
        D, maxp = 256, 4096
        length = maxp
    elif case == "block_to_own_destination":
        # source s's whole block to destination s: each segment full
        from flink_tpu_torch.core.keygroups import key_groups_device

        cand = torch.arange(1 << 12, dtype=torch.int64, device=dev)
        dest = key_groups_device(cand, MAXP).to(torch.int64) * D // MAXP
        own = torch.stack([cand[dest == s][0] for s in range(S)])
        keys = own.repeat_interleave(B)
    return {"keys": keys.view(S, B).contiguous(),
            "ts": ts.view(S, B).contiguous(),
            "cols": [price.view(S, B).contiguous()], "n_valid": n_valid,
            "start": start, "length": length, "maxp": maxp, "S": S, "B": B,
            "D": D}


def run_exchange(torch, dev, x: dict, D: int, plain: bool, out=None):
    """The kernel (or its plain version) on ``x`` into ``out``, or into
    new buffers."""
    from flink_tpu_torch.ops.exchange import ExchangeBuffers, \
        exchange_bucket, exchange_bucket_plain

    if out is None:
        out = ExchangeBuffers.allocate(D, x["S"], x["B"],
                                       [c.dtype for c in x["cols"]], dev)
    maxp, pane = x["maxp"], x.get("pane", PANE_MS)
    if plain:
        exchange_bucket_plain(x["keys"], x["ts"], x["cols"], out,
                              x["n_valid"], None, pane, 0, D, maxp,
                              x["start"], x["length"])
    else:
        exchange_bucket(x["keys"], x["ts"], x["cols"], out,
                        n_valid=x["n_valid"], pane=pane, n_dest=D,
                        max_parallelism=maxp, base_start=x["start"],
                        base_len=x["length"])
    return out


def exchange_segments_equal(torch, a, b) -> bool:
    """Equal counts, and every live row of every (source, destination)
    segment equal position by position: key, pane and each column (both
    keep batch order within a segment)."""
    if not torch.equal(a.counts, b.counts):
        return False
    S, B, D = a.n_src, a.block, a.n_dest
    pos = torch.arange(S * B, device=a.keys.device)
    live = (pos % B)[None, :] < a.counts.t().repeat_interleave(B, 1)
    return all(torch.equal(x[d][live[d]], y[d][live[d]])
               for x, y in zip([a.keys, a.panes, *a.cols],
                               [b.keys, b.panes, *b.cols])
               for d in range(D))


def exchange_snapshot(out):
    """A copy of a call's buffers, taken on the stream behind it."""
    from flink_tpu_torch.ops.exchange import ExchangeBuffers

    return ExchangeBuffers(out.keys.clone(), out.panes.clone(),
                           [c.clone() for c in out.cols], out.counts.clone(),
                           out.scratch)


def exchange_sequence(torch, dev, c: dict, case: str) -> list:
    """(kernel, plain) buffer pairs of a sequence of calls: two batches
    back to back on the same buffers, nothing synchronised between; or a
    call, one on new buffers of another shape (as the mesh replaces them),
    and one on the first buffers again."""
    S, B = c["shards"], c["device_batch"]
    first = exchange_case(torch, dev, c, "cell")
    keys, price, ts = _q5_block(torch, dev, c,
                                (PRESENT_PREFIX + 1) * c["batch"], S * B)
    second = {**first, "keys": keys.view(S, B), "ts": ts.view(S, B),
              "cols": [price.view(S, B)]}
    bufs = run_exchange(torch, dev, first, S, False)
    torch.cuda.synchronize()
    if case == "back_to_back":
        calls = [(first, bufs), (second, bufs)]
    else:
        small = exchange_case(torch, dev, c, "d256_small_block")
        small = {**small, "D": S, "maxp": MAXP, "length": MAXP}
        calls = [(small, None), (second, bufs)]
    pairs = []
    for x, out in calls:
        got = exchange_snapshot(run_exchange(torch, dev, x, S, False, out))
        pairs.append((got, run_exchange(torch, dev, x, S, True)))
    return pairs


def exchange_shapes(torch, dev) -> dict:
    """The exchange's timed inputs: the mesh cell's block and the mesh
    Q5-1M block (4 blocks of 2^12 rows of Q5-1M's 9th batch)."""
    return {"cell": exchange_case(torch, dev, mesh_config(), "cell"),
            "q5_1m_block": exchange_case(torch, dev, mesh_config(
                "q5_1m", device_batch=EXCHANGE_SMALL_BLOCK), "cell",
                batch_no=8)}


def exchange_device_ops(torch, dev) -> dict:
    """The device operations one exchange_bucket call makes at each of
    ``exchange_shapes``, by the profiler: its kernel alone. Taken early in
    the smoke's process (late in it the profiler has lost every record of
    a profile), or at the start of ``--mesh``."""
    out = {}
    for label, x in exchange_shapes(torch, dev).items():
        bufs = run_exchange(torch, dev, x, x["D"], False)
        torch.cuda.synchronize()
        ops, tries = device_kernels(
            torch, lambda: run_exchange(torch, dev, x, x["D"], False, bufs),
            "exchange_bucket_kernel", 1)
        if len(ops) != 1 or "exchange_bucket_kernel" not in ops[0]:
            raise AssertionError(f"one exchange_bucket call at {label} ran "
                                 f"{ops} on the card, one kernel expected")
        out[label] = {"device_ops_a_call": len(ops), "device_ops": ops,
                      "profiles_taken": tries}
    return out


def exchange_timing(torch, dev, x: dict, flush) -> dict:
    """The kernel at one shape, beside its plain version and the library
    sort the plain version runs (``torch.argsort(stable=True)`` of the
    (source, destination) codes), on buffers allocated once. Bound: each
    row's key, ts and price read once, each routed row's key, pane and
    price written once, the counts written once."""
    from flink_tpu_torch.core.keygroups import key_groups_device

    S, B, D = x["S"], x["B"], x["D"]
    out = run_exchange(torch, dev, x, D, False)
    torch.cuda.synchronize()
    routed = int(out.counts.sum())
    nbytes = S * B * 24 + routed * 24 + S * D * 8
    ms = cuda_ms(lambda: run_exchange(torch, dev, x, D, False, out), torch,
                 flush)
    plain_out = run_exchange(torch, dev, x, D, True)
    plain_ms = cuda_ms(lambda: run_exchange(torch, dev, x, D, True,
                                            plain_out), torch, flush,
                       reps=5)
    kg = key_groups_device(x["keys"].reshape(-1), MAXP).to(torch.int64)
    code = (torch.arange(S * B, device=dev) // B) * (D + 1) + kg * D // MAXP
    library_ms = cuda_ms(lambda: torch.argsort(code, stable=True), torch,
                         flush)
    return {"sources": S, "block": B, "destinations": D, "routed": routed,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "share_of_bound": bound_ms(nbytes) / ms}


def check_exchange(torch, dev, flush, device_ops: dict) -> dict:
    """exchange_bucket against its plain version on the card, at the mesh
    cell's shape (4 blocks of 2^17 rows of Q5-10M's 33rd batch to 4
    shards) and on ``EXCHANGE_CASES``: counts equal and every live row
    equal position by position, also across calls back to back on the
    same buffers and after a shape change. Timed at ``exchange_shapes``
    (the cell's and the mesh Q5-1M block), each with its ``device_ops``
    (``exchange_device_ops``)."""
    c = mesh_config()
    out = {"shapes": {}, "edge_cases": {}}
    for case in EXCHANGE_CASES:
        if case in ("back_to_back", "after_shape_change"):
            pairs = exchange_sequence(torch, dev, c, case)
        else:
            x = exchange_case(torch, dev, c, case)
            pairs = [(run_exchange(torch, dev, x, x["D"], plain=False),
                      run_exchange(torch, dev, x, x["D"], plain=True))]
        torch.cuda.synchronize()
        for j, (got, want) in enumerate(pairs):
            if not exchange_segments_equal(torch, got, want):
                raise AssertionError(f"exchange_bucket {case} (call {j}): "
                                     "the kernel disagrees with its plain "
                                     "version")
        counts = pairs[-1][0].counts.cpu().numpy()
        if case == "one_shard" and (counts > 0).sum(1).max() != 1:
            raise AssertionError("one_shard: rows reached two shards")
        if case == "block_to_own_destination" and not (
                counts == np.diag(counts.diagonal())).all():
            raise AssertionError("block_to_own_destination: a block split")
        if case == "empty" and counts.sum():
            raise AssertionError("empty: rows were routed")
        out["edge_cases"][case] = {
            "calls": len(pairs), "destinations": counts.shape[1],
            "routed": int(counts.sum()), "deepest_bucket": int(counts.max())}
        del pairs
    for label, x in exchange_shapes(torch, dev).items():
        got = run_exchange(torch, dev, x, x["D"], False)
        if not exchange_segments_equal(
                torch, got, run_exchange(torch, dev, x, x["D"], True)):
            raise AssertionError(f"exchange_bucket at {label}: the kernel "
                                 "disagrees with its plain version")
        out["shapes"][label] = {**exchange_timing(torch, dev, x, flush),
                                **device_ops[label]}
    out["max_abs_err"] = 0
    return out


def counted_step_state(torch, dev, c: dict, prefix: int) -> dict:
    """Shard 0's state at the cell's shape after ``prefix`` Q5-10M batches
    through the kernels (the exchange, then the counted step), with the
    exchange of the next batch: {table, planes, late, dropped, out}."""
    from flink_tpu_torch.ops.hash_table import make_table

    S, B, cap = c["shards"], c["device_batch"], c["capacity"]
    st = {"table": make_table(cap, dev),
          "count": torch.zeros((RING, cap), dtype=torch.int64, device=dev),
          "revenue": torch.zeros((RING, cap), dtype=torch.int64,
                                 device=dev),
          "late": torch.zeros((), dtype=torch.int64, device=dev),
          "dropped": torch.zeros((), dtype=torch.int64, device=dev)}
    x = exchange_case(torch, dev, c, "cell")
    for b in range(prefix + 1):
        keys, price, ts = _q5_block(torch, dev, c, b * S * B, S * B)
        x = {**x, "keys": keys.view(S, B), "ts": ts.view(S, B),
             "cols": [price.view(S, B)]}
        out = run_exchange(torch, dev, x, S, plain=False)
        if b < prefix:
            counted_step(st, out, 0, plain=False)
    st["out"] = out
    return st


def counted_step(st: dict, out, d: int, plain: bool) -> None:
    from flink_tpu_torch.ops.hash_table import ingest_step, ingest_step_plain

    fn = ingest_step_plain if plain else ingest_step
    fn(st["table"], [("count", st["count"], None),
                     ("sum", st["revenue"], out.cols[0][d])],
       out.panes[d], out.keys[d], 1, 0, MIN_TIMESTAMP, st["late"],
       st["dropped"], segments=out.counts[:, d])


def shard_state_by_key(torch, st: dict) -> tuple:
    """(sorted keys, their count and revenue rows) of a shard's state."""
    slots = torch.nonzero(st["table"] != INT64_MAX).flatten()
    keys = st["table"][slots]
    order = torch.argsort(keys)
    s = slots[order]
    return keys[order], st["count"][:, s], st["revenue"][:, s]


def dense_step_ms(torch, pre: dict, out, work: dict, flush, setup,
                  want: dict) -> float:
    """The uncounted step over shard 0's counted rows packed densely (a
    gather of each segment's front), held to the counted step's state by
    key and timed as it is."""
    from flink_tpu_torch.ops.hash_table import ingest_step

    S, B = out.n_src, out.block
    pos = torch.arange(B, device=out.keys.device)
    rows = ((pos[None, :] < out.counts[:, 0:1]).reshape(-1)
            .nonzero().flatten())
    keys, panes = out.keys[0][rows], out.panes[0][rows]
    price = out.cols[0][0][rows]

    def step(st):
        ingest_step(st["table"], [("count", st["count"], None),
                                  ("sum", st["revenue"], price)],
                    panes, keys, 1, 0, MIN_TIMESTAMP, st["late"],
                    st["dropped"])

    setup()
    step(work)
    torch.cuda.synchronize()
    if any(not torch.equal(a, b) for a, b in zip(
            shard_state_by_key(torch, work),
            shard_state_by_key(torch, want))):
        raise AssertionError("the uncounted step over the packed rows "
                             "disagrees with the counted step")
    return cuda_ms(lambda: step(work), torch, flush, setup=setup)


def counted_sectors(torch, pre_table, table, keys, panes, cap: int,
                    rates: dict | None) -> dict:
    """The counted step's sector floor for shard 0's counted rows
    (``keys``, ``panes``): every row's table sector read (a present key's
    too), a new key's table sector written back; per plane (int64 count,
    int64 revenue) each distinct (ring row, slot) sector read and written;
    the counted rows streamed (24 B a row). With ``rates``
    (``sector_rates``), that pattern at the card's measured random rates:
    present keys' table sectors at read8's, new keys' at probe8's (the
    claim), each plane's at red8's, the streamed bytes at 3.35 TB/s, one
    after another."""
    from flink_tpu_torch.ops.hash_table import lookup

    slot = lookup(table, keys).to(torch.int64)
    on = slot >= 0
    s = slot[on]
    was = lookup(pre_table, keys[on]) >= 0
    cell = (panes[on] % RING) * cap + s
    table_read = sector_ids(torch, 0, s, 8)
    table_new = sector_ids(torch, 0, s[~was], 8)
    count_sec = sector_ids(torch, 1, cell, 8)
    rev_sec = sector_ids(torch, 2, cell, 8)
    n = sector_floor(torch, [table_read, count_sec, rev_sec],
                     [table_new, count_sec, rev_sec])
    streamed = int(keys.numel()) * 24
    out = {"sectors": n, "streamed_bytes": streamed,
           "sector_floor_ms": bound_ms(32 * n + streamed)}
    if rates is not None:
        def distinct(ids):
            return int(torch.unique(ids).numel())

        def per_ms(op):
            return rates["ops"][op]["random"]["g_sectors_per_s"] * 1e6

        out["at_measured_rate_ms"] = (
            distinct(sector_ids(torch, 0, s[was], 8)) / per_ms("read8")
            + distinct(table_new) / per_ms("probe8")
            + (distinct(count_sec) + distinct(rev_sec)) / per_ms("red8")
            + bound_ms(streamed))
    return out


def check_counted_ingest(torch, dev, flush, rates: dict | None = None
                         ) -> dict:
    """ingest_step's counted form against its plain version on the card:
    shard 0's fold of Q5-10M's 5th batch after 4 batches, at the cell's
    2^23 slots, from the exchange's buffer (4 segments of 2^17 rows, their
    counts on the card): the same keys, the count and revenue planes
    equal key by key, late and dropped equal. Timed beside the plain
    version; bound: each counted row's ts, key and price read once, a new
    key's slot written, each (ring row, key) cell of the two planes read
    and written once."""
    c = mesh_config()
    base = counted_step_state(torch, dev, c, STEP_PREFIX)
    out = base.pop("out")
    pre = {k: v.clone() for k, v in base.items()}
    outs = []
    for plain in (False, True):
        st = {k: v.clone() for k, v in pre.items()}
        counted_step(st, out, 0, plain)
        outs.append(st)
    torch.cuda.synchronize()
    (kk, kc, kr), (pk, pc, pr) = (shard_state_by_key(torch, s)
                                  for s in outs)
    if not (torch.equal(kk, pk) and torch.equal(kc, pc)
            and torch.equal(kr, pr)
            and int(outs[0]["late"]) == int(outs[1]["late"])
            and int(outs[0]["dropped"]) == int(outs[1]["dropped"])):
        raise AssertionError("ingest_step counted form disagrees with its "
                             "plain version")
    rows = int(out.counts[:, 0].sum())
    new_keys = int((pre["table"] == INT64_MAX).sum()
                   - (outs[0]["table"] == INT64_MAX).sum())
    touched = int(((outs[0]["count"] != pre["count"])).sum())
    nbytes = rows * 24 + new_keys * 8 + touched * 2 * 2 * 8
    work = {k: v.clone() for k, v in pre.items()}

    def setup():
        for k, v in pre.items():
            work[k].copy_(v)

    ms = cuda_ms(lambda: counted_step(work, out, 0, False), torch, flush,
                 setup=setup)
    plain_ms = cuda_ms(lambda: counted_step(work, out, 0, True), torch,
                       flush, reps=3, setup=setup)
    # the cost of the segments: the same rows packed densely, folded by
    # the step without the counted form (one thread a row, no div/mod)
    dense_ms = dense_step_ms(torch, pre, out, work, flush, setup, outs[0])
    B = out.block
    live = ((torch.arange(out.keys.shape[1], device=dev) % B)
            < out.counts[:, 0].repeat_interleave(B))
    sectors = counted_sectors(torch, pre["table"], outs[0]["table"],
                              out.keys[0][live], out.panes[0][live],
                              c["capacity"], rates)
    floor = {"sector_floor_ms": sectors["sector_floor_ms"],
             "share_of_sector_floor": sectors["sector_floor_ms"] / ms}
    if "at_measured_rate_ms" in sectors:
        floor.update({
            "at_measured_rate_ms": sectors["at_measured_rate_ms"],
            "share_of_rate_floor": sectors["at_measured_rate_ms"] / ms})
    return {"shapes": {"cell_shard0": {
        "rows_in_buffer": out.keys.shape[1], "rows_counted": rows,
        "new_keys": new_keys, "cells_touched": touched,
        "capacity": c["capacity"], "ms": ms, "plain_ms": plain_ms,
        "dense_uncounted_ms": dense_ms,
        "library_ms": None, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "share_of_bound": bound_ms(nbytes) / ms,
        "sectors": sectors, **floor}},
        "max_abs_err": 0}


def mesh_resident_bytes(torch, op) -> int:
    """Bytes of the card tensors a mesh operator holds after its run: the
    shards' tables, pane planes and counters, the incremental planes and
    the exchange buffers (each storage once)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.is_cuda and x.untyped_storage().data_ptr() not in seen:
                seen.add(x.untyped_storage().data_ptr())
                total += x.untyped_storage().nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))

    walk([op._state, op._inc_wins, op._inc_trees, op._dstage,
          op._agg._buffers])
    return total


def mesh_run_record(torch, dev, c: dict, mode: str, expected: list) -> dict:
    """One timed run of the mesh cell through ``env.execute()``: the
    oracle, the launches of the path (one exchange_bucket a block, one
    counted ingest_step a shard and block, the select's passes, a seal or
    rebuild a shard and fire), events/s, p99 fire latency, peak memory,
    host waits."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    start = fresh_memory(torch)
    reset_launches()
    job, got = run_mesh_q5(torch, dev, c, mode)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    windows = q5_check(expected, got)
    op = mesh_operator(job)
    resident = mesh_resident_bytes(torch, op)
    if (op._agg.capacity != c["capacity"]
            or peak > MESH_PEAK_MARGIN * resident
            or start["allocated_at_start"] > MESH_START_SHARE * resident):
        raise AssertionError(
            f"mesh {mode}: peak {peak} B against {resident} B resident "
            f"(margin {MESH_PEAK_MARGIN}), {start} at the start, capacity "
            f"{op._agg.capacity} a shard (no grow expected)")
    batches = c["events"] // c["batch"]
    D = c["shards"]
    want = {"exchange_bucket": op.steps,
            "ingest_step_counted": D * op.steps,
            "ingest_step": D * op.steps,
            "window_kernels": D * windows if mode == "incremental" else 0}
    seen = {"exchange_bucket": launches["exchange_bucket"],
            "ingest_step_counted": launches["ingest_step_counted"],
            "ingest_step": launches["ingest_step"],
            "window_kernels": launches["window_seal"]
            + launches["window_rebuild"]}
    if seen != want or op.steps != batches or not launches["hist256"]:
        raise AssertionError(f"mesh {mode}: launches {launches}, expected "
                             f"{want} and {batches} steps")
    return {"wall_s": job.wall_s, "events_per_sec": c["events"] / job.wall_s,
            "lat": list(op.fire_latencies_ms), "windows": windows,
            "capacity_at_end": op._agg.capacity,
            "max_memory_allocated": peak, "memory_at_start": start,
            "resident_bytes": resident,
            "launches_per_run": launches,
            "launches_per_batch": {k: v / batches for k, v in seen.items()},
            "host_waits_per_batch": op.host_waits / batches,
            "zero_copy_blocks": op.zero_copy_blocks,
            "late_dropped": op.late_dropped, "tasks": task_record(job)}


def mesh_cell(torch, dev, expected: list) -> dict:
    """The mesh cell, Q5-10M through 4 shards on the one card, in both
    fire modes: a warm-up of 4 batches a mode under the sync check (no
    wait for the card may recur per batch or fire), ``MESH_RUNS`` timed
    runs of each mode in turns through the runtime, then a run on one
    thread with every fire timed on the card (``fire_device_ms``); every
    run against the oracle."""
    from flink_tpu_torch.runtime.operators import MeshWindowAggOperator

    c = mesh_config()
    modes = ("full", "incremental")
    warm = mesh_config(events=4 * c["batch"])
    waits = {m: check_no_repeated_waits(
        torch, f"mesh {m}", lambda m=m: run_mesh_q5(torch, dev, warm, m))
        for m in modes}
    runs = {m: [] for m in modes}
    for _ in range(MESH_RUNS):
        for m in modes:
            runs[m].append(mesh_run_record(torch, dev, c, m, expected))
    out = {}
    for m in modes:
        checked = []

        def direct(m=m, checked=checked):
            _op, got = run_mesh_direct(torch, dev, c, m)
            checked.append(q5_check(expected, got))

        fire = fire_device_ms(torch, direct, MeshWindowAggOperator)
        eps = sorted(r["events_per_sec"] for r in runs[m])
        lat = sorted(x for r in runs[m] for x in r.pop("lat"))
        out[m] = {**runs[m][-1], "runs": len(runs[m]),
                  "events_per_sec": float(np.median(eps)),
                  "events_per_sec_min_max": [eps[0], eps[-1]],
                  "wall_s": [r["wall_s"] for r in runs[m]],
                  "p99_fire_latency_ms": lat[min(len(lat) - 1,
                                                 int(0.99 * len(lat)))],
                  "fires": len(lat),
                  "max_memory_allocated": max(r["max_memory_allocated"]
                                              for r in runs[m]),
                  "memory_by_run": [{"at_start": r["memory_at_start"],
                                     "peak": r["max_memory_allocated"],
                                     "resident": r["resident_bytes"],
                                     "capacity_at_end": r["capacity_at_end"]}
                                    for r in runs[m]],
                  "host_waits_per_job": waits[m], "fire_device_ms": fire,
                  "direct_windows_checked": checked[-1]}
    return out


def mesh_grow_run(torch, dev) -> dict:
    """A mesh that grows: 4 shards of 2^12 slots against 100K keys in
    batches of 2^12; the probe grows every shard at watermarks, nothing is
    dropped, every window equals the oracle."""
    c = mesh_config("grow")
    job, got = run_mesh_q5(torch, dev, c)
    op = mesh_operator(job)
    return {"windows": q5_check(mesh_q5_expected(c), got),
            "capacity_before": c["capacity"],
            "capacity_after": op._agg.capacity}


def builtin_env(torch, dev, c: dict, mesh_devices: int):
    """``window(...).sum("price")`` on Q5's stream (capacity 2^21 a shard
    or device) with ``state.backend.tpu.mesh-devices``; rows (window end -
    1, auction, result) a batch."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
    from flink_tpu_torch.window import SlidingEventTimeWindows

    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    got = []
    env = StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": c["batch"],
        "pipeline.auto-watermark-interval": 0.0,
        "state.backend.tpu.mesh-devices": mesh_devices,
        "state.backend.tpu.slots-per-key-group": 1 << 21}), device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    (env.from_source(DataGenSource(q5_gen(c["keys"], c["events"],
                                          mesh_span(c)), schema,
                                   count=c["events"], timestamp_column="ts",
                                   device=True), ws, "DataGen")
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS))
        .sum("price")
        .add_sink(lambda b: got.append((int(b.timestamps[0]),
                                        b.column("auction"),
                                        b.column("result")))))
    return env, got


def builtin_rows(got: list) -> dict:
    """{window end - 1: (keys, results) in key order}."""
    out = {}
    for ts, k, v in got:
        pk, pv = out.get(ts, (np.empty(0, np.int64), np.empty(0, np.int64)))
        out[ts] = (np.concatenate([pk, k]), np.concatenate([pv, v]))
    return {ts: (k[np.argsort(k)], v[np.argsort(k)])
            for ts, (k, v) in out.items()}


def mesh_builtin_route(torch, dev) -> dict:
    """The builtin route at Q5-1M: ``state.backend.tpu.mesh-devices`` 4
    against the single-device operator (0): every window's rows equal."""
    c = mesh_config("q5_1m")
    rows, walls = {}, {}
    for n in (MESH_SHARDS, 0):
        fresh_memory(torch)
        env, got = builtin_env(torch, dev, c, n)
        job = env.execute("builtin-sum")
        rows[n], walls[n] = builtin_rows(got), job.wall_s
        if n:
            op = mesh_operator(job)
            if op._n_devices != n:
                raise AssertionError("the builtin route took no mesh")
    mesh, single = rows[MESH_SHARDS], rows[0]
    if sorted(mesh) != sorted(single) or not all(
            np.array_equal(mesh[t][0], single[t][0])
            and np.array_equal(mesh[t][1], single[t][1]) for t in single):
        raise AssertionError("builtin sum on the mesh disagrees with the "
                             "single-device operator")
    return {"windows": len(single),
            "rows": int(sum(len(k) for k, _v in single.values())),
            "wall_s_mesh": walls[MESH_SHARDS], "wall_s_single": walls[0]}


def mesh_rescale_run(torch, dev) -> dict:
    """``live_rescale`` at Q5-1M, 4 -> 2 -> 1 -> 4 shards mid-run (the
    source paced to ``MESH_RESCALE_RUN_S``, a rescale at each equal share
    of it after the first batch): every window once and equal to the
    oracle, no kernel built, and each new mesh at 2x headroom for the keys
    it received (the scale-in to one shard brings it more keys than its
    old 2^20 slots take at that headroom)."""
    from flink_tpu_torch.cluster.local import live_rescale
    from flink_tpu_torch.ops import kernels

    c = mesh_config("q5_1m")
    expected = mesh_q5_expected(c)
    builds = kernels.builds()
    fresh_memory(torch)
    env, got, _source = mesh_q5_env(torch, dev, c,
                                    rate=c["events"] / MESH_RESCALE_RUN_S)
    job = env.execute_async("mesh-rescale")
    stats = []
    try:
        op = mesh_operator(job)
        deadline = time.monotonic() + 60
        while op.first_batch_at is None and time.monotonic() < deadline:
            time.sleep(0.005)
        for i, n in enumerate(MESH_RESCALE_TO):
            at = op.first_batch_at + MESH_RESCALE_RUN_S * (i + 1) / (
                len(MESH_RESCALE_TO) + 1)
            while time.perf_counter() < at:
                time.sleep(0.005)
            if job._finished:
                raise AssertionError("the rescaled run ended before its "
                                     f"rescale to {n} shards")
            st = live_rescale(job, n, timeout=120)
            keys = int(sum((t != INT64_MAX).sum() for t in op._state.table))
            stats.append({**st, "after_steps": op.steps, "keys": keys,
                          "capacity_per_shard": op._agg.capacity})
            if op._agg.capacity * n < 2 * keys:
                raise AssertionError(f"rescale to {n} shards: {keys} keys "
                                     f"in {op._agg.capacity} slots a shard")
        job.wait(300)
    finally:
        job.cancel()
    windows = q5_check(expected, got)
    if kernels.builds() != builds:
        raise AssertionError("the live rescale built a kernel")
    return {"windows": windows, "rescales": stats,
            "shards_at_end": op._n_devices, "kernel_builds": 0,
            "wall_s": job.wall_s}


def q5_device_batches(torch, dev, c: dict):
    """Q5's device batches of ``c`` with the watermark after each."""
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.core.device_records import DeviceRecordBatch

    schema = Schema([("auction", np.int64), ("price", np.int64)])
    span, n = mesh_span(c), c["batch"]
    for b in range(c["events"] // n):
        keys, price, ts = _q5_block(torch, dev, c, b * n, n)
        lo = (b * n * span) // c["events"]
        hi = (((b + 1) * n - 1) * span) // c["events"]
        yield DeviceRecordBatch(schema, {"auction": keys, "price": price},
                                ts, lo, hi), hi - 1


def q5_operator_of(torch, dev, kind: str, c: dict):
    from flink_tpu_torch.runtime.operators import AggSpec, \
        DeviceWindowAggOperator, MeshWindowAggOperator
    from flink_tpu_torch.window import SlidingEventTimeWindows

    w = SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS)
    aggs = [AggSpec("count", out_name="bids", value_bits=31),
            AggSpec("sum", "price", out_name="revenue")]
    if kind == "mesh":
        return MeshWindowAggOperator(
            w, "auction", aggs, n_devices=c["shards"],
            capacity=c["capacity"], ring_size=RING,
            device_batch=c["device_batch"], emit_window_bounds=False,
            emit_topk=TOPK, async_fire=True, device=dev)
    return DeviceWindowAggOperator(
        w, "auction", aggs, capacity=1 << 21, ring_size=RING,
        emit_window_bounds=False, emit_topk=TOPK, defer_overflow=True,
        async_fire=True, device=dev)


def mesh_cross_restores(torch, dev) -> dict:
    """At Q5-1M, a checkpoint after ``MESH_RESTORE_CUT`` batches of the
    mesh restored into the single-device operator, and the other way
    round: both halves' windows together equal the oracle."""
    from flink_tpu_torch.core import Configuration
    from flink_tpu_torch.core.elements import MAX_TIMESTAMP
    from flink_tpu_torch.runtime import OneInputOperatorTestHarness

    c = mesh_config("q5_1m")
    expected = mesh_q5_expected(c)
    out = {}
    for first, second in (("mesh", "single"), ("single", "mesh")):
        fresh_memory(torch)
        hs = [OneInputOperatorTestHarness(
            q5_operator_of(torch, dev, kind, c), config=Configuration())
            for kind in (first, second)]
        h = hs[0]
        for i, (batch, wm) in enumerate(q5_device_batches(torch, dev, c)):
            if i == MESH_RESTORE_CUT:
                snap = h.snapshot(1)
                h = hs[1]
                h.open([snap["keyed"]])
                keys = len(snap["keyed"]["backend"]["keys"])
            h.process_batch(batch)
            h.process_watermark(wm)
        h.process_watermark(MAX_TIMESTAMP)
        for hh in hs:
            hh.close()
        got = [(int(b.timestamps[0]), b.column("auction"), b.column("bids"),
                b.column("revenue")) for hh in hs
               for b in hh.output.batches]
        out[f"{first}_to_{second}"] = {"windows": q5_check(expected, got),
                                       "keys_restored": keys}
    return out


def mesh_entry(mesh: dict, kernel: str, source: str, shape: str,
               replaces: str) -> dict:
    """The kernels line's entry of a mesh kernel: its check at the cell's
    shape, launches of the mesh cell's full-mode run (and by path)."""
    check = mesh[kernel]
    at = check["shapes"][shape]
    cell = mesh["cell"]
    return {"name": kernel, "route": "cuda",
            "source": f"flink_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": cell["full"]["launches_per_run"][kernel],
            "max_abs_err": check["max_abs_err"],
            **{k: at[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "share_of_bound")},
            "shape": at,
            **{f"at_{k}": v for k, v in check["shapes"].items()
               if k != shape},
            "launches_by_path": {
                f"mesh Q5-10M {m}": cell[m]["launches_per_run"][kernel]
                for m in ("full", "incremental")},
            "launches_per_batch": cell["full"]["launches_per_batch"][kernel],
            **({"edge_cases": check["edge_cases"]}
               if "edge_cases" in check else {})}


def mesh_phase(torch, dev, flush, rates: dict | None = None,
               exchange_ops: dict | None = None) -> dict:
    """The multi-device window path: the exchange kernel (its device
    operations a call ``exchange_ops``, counted here when not given) and
    the counted step against their plain versions (the step's sector
    floor at the card's measured ``rates``), the mesh cell in both fire
    modes, a mesh that grows, the builtin route, the live rescale and the
    cross restores."""
    t0 = time.perf_counter()
    out, seconds = {}, {}

    def part(name: str, fn) -> None:
        t = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t
        emit({f"mesh_{name}": out[name], "seconds": seconds[name]})

    if exchange_ops is None:
        exchange_ops = exchange_device_ops(torch, dev)
    part("exchange_bucket",
         lambda: check_exchange(torch, dev, flush, exchange_ops))
    part("ingest_step_counted",
         lambda: check_counted_ingest(torch, dev, flush, rates))
    expected = mesh_q5_expected(mesh_config())
    part("cell", lambda: {"config": mesh_config(),
                          **mesh_cell(torch, dev, expected)})
    del expected
    part("grow", lambda: mesh_grow_run(torch, dev))
    part("builtin_route", lambda: mesh_builtin_route(torch, dev))
    part("live_rescale", lambda: mesh_rescale_run(torch, dev))
    part("cross_restores", lambda: mesh_cross_restores(torch, dev))
    return {**out, "seconds": {**seconds,
                               "all": time.perf_counter() - t0}}


PROFILED_CELLS = {
    "sql_tpch_q1": (sql_profile, lambda torch, dev: run_tpch_q1(torch, dev),
                    lambda torch, dev: run_tpch_q1(torch, dev, 4 * BATCH)),
    "sql_groupby_10m": (
        sql_profile, lambda torch, dev: run_groupby(torch, dev),
        lambda torch, dev: run_groupby(torch, dev, n_rows=4 * BATCH)),
    "dedup_10m": (
        dedup_profile, lambda torch, dev: run_dedup(torch, dev,
                                                    dedup_config()),
        lambda torch, dev: run_dedup(torch, dev, dedup_config(),
                                     count=4 * dedup_config()["batch"])),
}


def cell_profile(torch, dev, cell: str) -> dict:
    """A cell's profile (``PROFILED_CELLS``), taken in this process. When
    each of its PROFILE_TRIES profiles lacked a kernel record, it is taken
    again in a fresh process on the same card (``--profile CELL``), held
    to the same count: late in this long process the profiler has lost a
    record of 64 or 70 in three profiles in a row, and no profile of a
    short process lost one (``tools/profile_records.py``). The record says
    where it was taken and what the profiles here counted."""
    profile_fn, run, _warm = PROFILED_CELLS[cell]
    try:
        return {**profile_fn(torch, lambda: run(torch, dev)),
                "profiled_in": "this process"}
    except ProfileRecordsLost as e:
        lost = str(e)
    fresh_memory(torch)
    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--profile", cell], capture_output=True,
                         text=True, timeout=PROFILE_CHILD_TIMEOUT_S,
                         cwd=HERE, stdin=subprocess.DEVNULL)
    if out.returncode != 0:
        raise AssertionError(f"{cell}: {lost}; the fresh process's "
                             f"profile failed (rc {out.returncode}): "
                             f"{out.stderr[-3000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])["profile"]
    return {**rec, "profiled_in": "a fresh process",
            "lost_in_this_process": lost}


def profile_child(torch, dev, cell: str) -> int:
    """``--profile CELL``: the cell's warm-up, then its profile, printed
    as the last line ``{"profile": ...}``."""
    profile_fn, run, warm = PROFILED_CELLS[cell]
    warm(torch, dev)
    emit({"profile": profile_fn(torch, lambda: run(torch, dev))})
    return 0


# -- the device-time ledger, the build cache and the sync audit -----------
LEDGER_TURNS = (False, True, False, True)   # profiler.enabled, in turns
LEDGER_GBPS = 3350.0           # profiler.cost-model.gbps: H100 SXM HBM3
AOT_CHILD_TIMEOUT_S = 300      # a build-cache child process
AOT_CHILD_FREE_BYTES = 8 << 30  # the card's free bytes before the children
AUDIT_BATCHES = 4              # batches of each sync-audit run


def ledger_profile_rows(profile: dict) -> list:
    """The ledger's ``profile()`` rows, in its order, with the keys the
    smoke reports."""
    keys = ("job", "operator", "site", "shape_signature", "count",
            "compiles", "self_ms", "compile_ms", "mean_ms", "p95_ms",
            "est_flops", "est_bytes", "est_ms", "achieved_vs_estimated")
    return [{k: r[k] for k in keys} for r in profile["programs"]]


def ledger_counts(profile: dict) -> dict:
    """site -> (count, compiles), summed over jobs, operators and shapes."""
    out: dict = {}
    for r in profile["programs"]:
        c = out.setdefault(r["site"], [0, 0])
        c[0] += r["count"]
        c[1] += r["compiles"]
    return {k: tuple(v) for k, v in out.items()}


def ledger_phase(torch, dev) -> dict:
    """Q5-1M with ``profiler.enabled`` and without, in turns
    (``LEDGER_TURNS``), each run held to the oracle. The last profiled run
    runs under torch.profiler too: the ledger's ``device_window.step``
    device ms must cover at least 0.95 of the profiler's
    ``ingest_step_kernel`` total (its events enclose the kernel). Counts:
    ``device_window.step`` one a batch, ``device_window.fire`` and
    ``ops.pallas_topk`` one a fire, ``hist256`` 4 launches a fire (Q5's
    31-bit counts: 4 digit passes a select); the first profiled run
    charges each site's first dispatch as compile. The sync check finds
    the same waits with the ledger on as off. Events/s of both are the
    ledger's cost, not a claim."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.metrics.profiler import DEVICE_LEDGER

    label, n_keys, n_events, cap = Q5_CELLS[0]
    span = q5_panes(n_events) * PANE_MS
    expected = q5_expected(n_keys, n_events, span)
    batches = n_events // BATCH
    on = {"profiler.enabled": True, "profiler.cost-model.gbps": LEDGER_GBPS}
    off = {"profiler.enabled": False}
    waits = {name: sorted(implicit_syncs(torch, lambda s=s: run_q5(
        torch, dev, n_keys, AUDIT_BATCHES * BATCH, cap, settings=s)))
        for name, s in (("off", off), ("on", on))}
    if waits["on"] != waits["off"]:
        raise AssertionError(f"the ledger changes the host waits: "
                             f"{waits['on']} != {waits['off']}")
    eps = {"on": [], "off": []}
    runs = []
    for turn, enabled in enumerate(LEDGER_TURNS):
        last = turn == len(LEDGER_TURNS) - 1
        fresh_memory(torch)
        DEVICE_LEDGER.reset()
        reset_launches()
        if last:
            with card_profile(torch) as prof:
                job, got, _span = run_q5(torch, dev, n_keys, n_events, cap,
                                         settings=on)
        else:
            job, got, _span = run_q5(torch, dev, n_keys, n_events, cap,
                                     settings=on if enabled else off)
        fires = q5_check(expected, got)
        eps["on" if enabled else "off"].append(n_events / job.wall_s)
        launches = dict(KERNEL_LAUNCHES)
        if not enabled:
            if DEVICE_LEDGER.snapshot()["entries"]:
                raise AssertionError("a disabled ledger recorded samples")
            continue
        profile = DEVICE_LEDGER.profile(top=1000)
        counts = ledger_counts(profile)
        want = {"device_window.step": batches, "device_window.fire": fires,
                "ops.pallas_topk": fires}
        for site, n in want.items():
            got_n = counts.get(site, (0, 0))
            if sum(got_n) != n or (turn > 1 and got_n[1]):
                raise AssertionError(f"ledger {site}: (count, compiles) "
                                     f"{got_n}, want {n} dispatches")
        if launches["hist256"] != 4 * fires:
            raise AssertionError(f"hist256 launched {launches['hist256']} "
                                 f"times for {fires} fires of 4 passes")
        run = {"turn": turn, "fires": fires, "batches": batches,
               "counts": counts, "hist256_launches": launches["hist256"],
               "total_device_ms": profile["total_device_ms"],
               "total_compile_ms": profile["total_compile_ms"],
               "programs": ledger_profile_rows(profile),
               "recompiles": profile["recompiles"],
               "forced_waits": DEVICE_LEDGER.forced_waits}
        if last:
            from torch.autograd import DeviceType
            kernel_ms = sum(e.self_device_time_total for e in prof.events()
                            if e.device_type == DeviceType.CUDA
                            and "ingest_step_kernel" in e.name) / 1e3
            step_ms = sum(r["self_ms"] + r["compile_ms"]
                          for r in profile["programs"]
                          if r["site"] == "device_window.step")
            if step_ms < 0.95 * kernel_ms:
                raise AssertionError(
                    f"the ledger's device_window.step {step_ms} ms is "
                    f"below 0.95 of the profiler's ingest_step_kernel "
                    f"{kernel_ms} ms")
            run.update(profiler_ingest_step_ms=kernel_ms,
                       ledger_step_ms=step_ms,
                       ledger_over_profiler=step_ms / kernel_ms)
        runs.append(run)
    DEVICE_LEDGER.reset()
    return {"ledger_phase": {
        "cell": f"Q5-{label}", "keys": n_keys, "events": n_events,
        "capacity": cap, "cost_model_gbps": LEDGER_GBPS,
        "events_per_sec": eps,
        "events_per_sec_median": {k: float(np.median(v))
                                  for k, v in eps.items()},
        "host_waits": waits, "profiled_runs": runs}}


def aot_child(torch, dev, directory: str) -> int:
    """A fresh process on the build cache at ``directory``: the warm-up
    (``AOT.warmup`` alone, timed), then Q5-1M through ``env.execute()``
    with the cache on, held to the oracle. The last line is the record."""
    from flink_tpu_torch.core import Configuration
    from flink_tpu_torch.ops import kernels
    from flink_tpu_torch.runtime.aot import AOT

    settings = {"aot.enabled": True, "aot.dir": directory}
    AOT.configure(Configuration(settings))
    t0 = time.perf_counter()
    warmed = AOT.warmup()
    warmup_s = time.perf_counter() - t0
    builds_after_warmup = kernels.builds()
    label, n_keys, n_events, cap = Q5_CELLS[0]
    job, got, span = run_q5(torch, dev, n_keys, n_events, cap,
                            settings=settings)
    windows = q5_oracle_check(n_keys, n_events, span, got)
    emit({"aot_child": {
        "warmup_s": warmup_s, "warmup_loaded": warmed,
        "builds_after_warmup": builds_after_warmup,
        "builds": kernels.builds(), "windows": windows,
        "events_per_sec": n_events / job.wall_s,
        "max_memory_reserved": torch.cuda.max_memory_reserved(),
        "aot": AOT.snapshot(),
        "events": [{k: v for k, v in e.items() if k != "timestamp"}
                   for e in AOT.events]}})
    return 0


def release_for_children(torch) -> dict:
    """Before child processes on this card: this process's caching
    allocator keeps the blocks earlier phases reserved (the 10M-key cells
    leave tens of GB), and a child whose card is full fails at its first
    allocation, a library's module load included ("out of memory" from
    ``hash_table_load``). Frees the cached blocks; returns the bytes this
    process had allocated and reserved and the card's free bytes after,
    and raises when fewer than ``AOT_CHILD_FREE_BYTES`` are free."""
    fresh = fresh_memory(torch)
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    rec = {**fresh, "reserved_before_release": reserved,
           "reserved_after_release": torch.cuda.memory_reserved(),
           "card_free": free, "card_total": total}
    if free < AOT_CHILD_FREE_BYTES:
        raise AssertionError(f"the card has {free} bytes free for the "
                             f"build-cache children, fewer than "
                             f"{AOT_CHILD_FREE_BYTES}: {rec}")
    return rec


def run_aot_child(directory: str) -> dict:
    """``chip_smoke.py --aot-child DIR`` in a child process, on the card
    this process uses (``CUDA_VISIBLE_DEVICES`` as set in ``main``)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--aot-child",
         directory], capture_output=True, text=True,
        timeout=AOT_CHILD_TIMEOUT_S, env=dict(os.environ))
    if proc.returncode != 0:
        raise AssertionError(f"build-cache child failed ({proc.returncode}):"
                             f" {proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["aot_child"]


def aot_phase(torch, dev) -> dict:
    """The verified build cache on the card. This process builds every
    library with ``aot.enabled`` into a fresh ``aot.dir`` (the cold
    process: it stores them all), then three child processes run Q5-1M
    from it: warm (0 builds), after one flipped payload byte of the
    hist256 artifact (quarantined as .corrupt, exactly that source built
    again, nothing else) and after an edited header fingerprint (a miss:
    that source built again, nothing quarantined). Every child's windows
    equal the oracle. The children start after this process has freed
    its cached device blocks (``release_for_children``)."""
    import tempfile

    from flink_tpu_torch.core import Configuration
    from flink_tpu_torch.ops import kernels
    from flink_tpu_torch.runtime.aot import AOT, verify_aot_cache

    with tempfile.TemporaryDirectory(prefix="aot-") as directory:
        AOT.configure(Configuration({"aot.enabled": True,
                                     "aot.dir": directory}))
        try:
            before = kernels.builds()
            cold_s = kernels.build_all()
            cold_builds = kernels.builds() - before
            stores = AOT.snapshot()["stores"]
        finally:
            AOT.reset()
        if cold_builds != len(kernels.SOURCES) or \
                stores != len(kernels.SOURCES):
            raise AssertionError(f"the cold process built {cold_builds} and "
                                 f"stored {stores} of "
                                 f"{len(kernels.SOURCES)} sources")
        hist = [n for n in os.listdir(directory)
                if n.startswith("hist256-") and n.endswith(".aotx")]
        path = os.path.join(directory, hist[0])
        memory = release_for_children(torch)
        warm = run_aot_child(directory)
        raw = bytearray(open(path, "rb").read())
        raw[raw.index(b"\n") + 1 + (len(raw) - raw.index(b"\n")) // 2] ^= 0x01
        open(path, "wb").write(bytes(raw))
        corrupt = run_aot_child(directory)
        quarantined = sorted(n for n in os.listdir(directory)
                             if n.endswith(".corrupt"))
        raw = open(path, "rb").read()
        nl = raw.index(b"\n")
        header = json.loads(raw[:nl])
        header["fingerprint"][-1] = "another toolkit"
        open(path, "wb").write(json.dumps(header, sort_keys=True).encode()
                               + raw[nl:])
        skew = run_aot_child(directory)
        after = sorted(n for n in os.listdir(directory)
                       if n.endswith(".corrupt"))
        rows = verify_aot_cache(directory)
    checks = {"warm": (warm, 0, 0), "corrupt": (corrupt, 1, 1),
              "skew": (skew, 1, 0)}
    for name, (child, builds, quar) in checks.items():
        if child["builds"] != builds or child["aot"]["quarantined"] != quar:
            raise AssertionError(f"build-cache child {name}: {child}")
    if quarantined != [hist[0] + ".corrupt"] or after != quarantined:
        raise AssertionError(f"quarantined {quarantined}, then {after}")
    if not all(status in ("OK", "QUARANTINED") for _n, status, _d in rows):
        raise AssertionError(f"the cache does not verify: {rows}")
    return {"aot_phase": {
        "cold": {"nvcc_s": cold_s, "builds": cold_builds, "stores": stores},
        "memory_before_children": memory, "warm": warm, "corrupt": corrupt, "skew": skew,
        "quarantined": quarantined, "verify": rows}}


def sync_audit_phase(torch, dev) -> dict:
    """Tier B of the port's lint: a Q5-1M step and fire, a session step,
    a GROUP BY step and a mesh step under the sync debug mode
    (``implicit_syncs``); every host wait in the package must be one a
    ``# lint: sync-ok`` line or a TPU101 baseline entry names
    (``analysis/sync_audit.py``)."""
    from flink_tpu_torch.analysis.sync_audit import audit_waits

    label, n_keys, n_events, cap = Q5_CELLS[0]
    n = AUDIT_BATCHES * BATCH
    sess = session_config("session-100K")
    runs = {
        f"Q5-{label}": lambda: run_q5(torch, dev, n_keys, n, cap),
        "session-100K": lambda: run_session(
            torch, dev, sess, AUDIT_BATCHES * sess["batch"]),
        "groupby": lambda: run_groupby(torch, dev, n_keys, n, BATCH),
        "mesh_q5_1m": lambda: run_mesh_q5(
            torch, dev, mesh_config("q5_1m", events=n)),
    }
    out = {}
    for name, run in runs.items():
        fresh_memory(torch)
        waits = implicit_syncs(torch, run)
        out[name] = {"waits": len(waits), **audit_waits(waits)}
    unnamed = {name: r["unnamed"] for name, r in out.items() if r["unnamed"]}
    if unnamed:
        emit({"sync_audit": out})
        raise AssertionError(f"sync audit: host waits no sync-ok or "
                             f"baseline entry names: {unnamed}")
    return {"sync_audit": out}


# -- tracing, the flight recorder and the reporters (tracing) ----------------
TRACE_RUNS = 2                 # Q5-10M runs with traces.enabled on and off,
#                                each, in turns
TRACE_RUN_S = 2.0              # (b): the traced run's source pacing, and
TRACE_CKPT_S = 1.2             # its checkpoint interval: one checkpoint
#                                lands mid-run
SPAN_LOOP = 100_000            # spans timed alone on the host
TRACE_TAIL = 8                 # a dump's last entries that must hold its span
#: the faults phase's flight-recorder dumps by reason, reported by (d)
FLIGHT_DUMPS: dict = {}


def flight_dump(settings: dict, reason: str, scope: str, name: str) -> dict:
    """The flight recorder's dump of ``reason``: it must be in the
    directory ``settings`` name, and its last TRACE_TAIL entries must hold
    the ``scope.name`` span of the fault."""
    from flink_tpu_torch.metrics.tracing import FLIGHT_RECORDER

    directory = settings["traces.flight-recorder.dir"]
    dumps = [d for d in FLIGHT_RECORDER.dumps if d["reason"] == reason
             and d["path"].startswith(directory)]
    if not dumps:
        raise AssertionError(f"no {reason} flight dump in {directory}: "
                             f"{FLIGHT_RECORDER.dumps}")
    path = dumps[-1]["path"]
    with open(path) as f:
        payload = json.load(f)
    tail = payload["entries"][-TRACE_TAIL:]
    held = [e for e in tail if e.get("type") == "span"
            and e.get("scope") == scope and e.get("name") == name]
    if not held:
        raise AssertionError(f"the {reason} dump's tail holds no "
                             f"{scope}.{name} span: {tail}")
    return {"path": path, "bytes": os.path.getsize(path),
            "entries": payload["entry_count"],
            "span": {k: held[-1][k] for k in ("scope", "name",
                                              "duration_ms", "attributes")}}


def scrape(port: int) -> dict:
    """One GET of a PrometheusReporter over loopback: ms, bytes and the
    samples by name."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        body = r.read()
    ms = (time.perf_counter() - t0) * 1e3
    vals = {}
    for ln in body.decode().splitlines():
        if ln and not ln.startswith("#"):
            name, _, val = ln.rpartition(" ")
            vals[name] = float(val)
    return {"ms": ms, "bytes": len(body), "values": vals}


def span_cost_us(loop: int, retained: int) -> float:
    """Host µs of one span (a builder, two attributes, finish and the
    reporters) through a tracer with the global one's reporters: an
    in-memory ring of ``retained`` spans and a flight recorder of the
    default capacity. With ``retained`` below ``loop`` the ring evicts,
    as a long run's does."""
    from flink_tpu_torch.metrics.tracing import FlightRecorder, \
        InMemoryTraceReporter, Tracer

    tracer = Tracer([InMemoryTraceReporter(max_retained=retained),
                     FlightRecorder()])
    t0 = time.perf_counter()
    for i in range(loop):
        (tracer.span("task", "SourceBatch").set_attribute("task", "t#0")
         .set_attribute("records", i).finish())
    return (time.perf_counter() - t0) / loop * 1e6


def tracing_cost(torch, dev) -> dict:
    """(a) Q5-10M full at its configuration, TRACE_RUNS runs each with
    ``traces.enabled`` true and false in turns (on, off, on, off) after an
    untimed run of 4 batches (a first run in a process pays its
    allocations): events/s (median and range), p99 fire latency, the spans
    of each run by (scope, name), the spans dropped and the CPU seconds of
    each task's thread; every window against the oracle."""
    from flink_tpu_torch.metrics import DEVICE_STATS, TRACER

    _label, n_keys, n_events, cap = Q5_CELLS[1]
    expected = q5_expected(n_keys, n_events,
                           q5_panes(n_events) * PANE_MS)
    fresh_memory(torch)
    run_q5(torch, dev, n_keys, 4 * BATCH, cap)
    runs = {"on": [], "off": []}
    for _ in range(TRACE_RUNS):
        for mode in ("on", "off"):
            TRACER.reset()
            dropped = DEVICE_STATS.spans_dropped
            fresh_memory(torch)
            job, got, _span = run_q5(
                torch, dev, n_keys, n_events, cap,
                settings={"traces.enabled": mode == "on"})
            windows = q5_check(expected, got)
            spans = {}
            for sp in TRACER.retained_spans():
                key = f"{sp.scope}.{sp.name}"
                spans[key] = spans.get(key, 0) + 1
            lat = sorted(job.operators[0].fire_latencies_ms)
            runs[mode].append({
                "wall_s": job.wall_s, "events_per_sec": n_events / job.wall_s,
                "p99_fire_latency_ms": lat[min(len(lat) - 1,
                                               int(0.99 * len(lat)))],
                "windows": windows, "spans": spans,
                "spans_dropped": DEVICE_STATS.spans_dropped - dropped,
                "task_cpu_s": {tid: t.cpu_s for tid, t in job.tasks.items()}})
            del job, got
    batches = n_events // BATCH
    for r in runs["on"]:
        if r["spans"].get("task.SourceBatch") != batches \
                or r["spans"].get("device.Execute", 0) < batches:
            raise AssertionError(f"traced Q5-10M run: spans {r['spans']}, "
                                 f"expected {batches} SourceBatch and as "
                                 "many Execute at least")
    if any(r["spans"] for r in runs["off"]):
        raise AssertionError(f"untraced runs reported spans: {runs['off']}")
    eps = {m: [r["events_per_sec"] for r in rs] for m, rs in runs.items()}
    med = {m: float(np.median(v)) for m, v in eps.items()}
    per_run = sum(runs["on"][0]["spans"].values())
    loop = {"retained_above_loop": span_cost_us(SPAN_LOOP, SPAN_LOOP),
            "retained_4096_evicting": span_cost_us(SPAN_LOOP, 4096)}
    return {"cell": "Q5-10M full", "runs": runs,
            "events_per_sec": {m: {"median": med[m], "min": min(v),
                                   "max": max(v)}
                               for m, v in eps.items()},
            "on_over_off_median": med["on"] / med["off"],
            "p99_fire_latency_ms": {
                m: max(r["p99_fire_latency_ms"] for r in rs)
                for m, rs in runs.items()},
            "spans_per_run": per_run,
            "host_us_per_span": loop,
            "host_ms_per_run": per_run * loop["retained_above_loop"] / 1e3,
            "run_wall_ms_on": [r["wall_s"] * 1e3 for r in runs["on"]]}


def tracing_run(torch, dev) -> dict:
    """(b) and (c): one traced Q5-10M run, paced to TRACE_RUN_S, with the
    ledger on and one checkpoint to fs storage in its middle, its metrics
    in a registry that ``reporters_from_config`` opened (``metrics.
    reporters: prometheus``) and passed to ``execute(...,
    metrics_registry=reg)``. The checkpoint's tree beside the
    coordinator's own seconds; the spans exported for Perfetto with the
    ledger's counter tracks; the reporter scraped mid-run and after, its
    device and profiler series equal to DEVICE_STATS and the ledger."""
    import shutil
    import tempfile
    import threading

    from flink_tpu_torch.metrics import DEVICE_LEDGER, DEVICE_STATS, \
        MetricRegistry, PrometheusReporter, TRACER, chrome_trace_events, \
        reporters_from_config
    from flink_tpu_torch.metrics.device import DEVICE_GAUGES

    _label, n_keys, n_events, cap = Q5_CELLS[1]
    ckpt_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_ckpt_")
    export_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_trace_")
    try:
        env, got, span = q5_env(
            torch, dev, n_keys, n_events, cap, rate=n_events / TRACE_RUN_S,
            settings={"execution.checkpointing.interval": TRACE_CKPT_S,
                      "execution.checkpointing.dir": ckpt_dir,
                      "profiler.enabled": True,
                      "metrics.reporters": "prometheus"})
        reg = MetricRegistry()
        reporters = reporters_from_config(env.config)
        for rep in reporters:
            rep.open(reg)
        (prom,) = [r for r in reporters if isinstance(r, PrometheusReporter)]
        TRACER.reset()
        DEVICE_LEDGER.reset()
        fresh_memory(torch)
        mid = {}
        timer = threading.Timer(TRACE_RUN_S / 2,
                                lambda: mid.update(scrape(prom.port)))
        timer.start()
        job = env.execute("q5-traced", metrics_registry=reg)
        timer.join()
        final = scrape(prom.port)
        for rep in reporters:
            rep.close()
        windows = q5_oracle_check(n_keys, n_events, span, got)
        # (c): the scrape after the run against the counters themselves
        vals = final.pop("values")
        wrong = {name: (vals.get(f"flink_tpu_device_{name}"),
                        getattr(DEVICE_STATS, attr))
                 for name, attr in DEVICE_GAUGES
                 if vals.get(f"flink_tpu_device_{name}")
                 != float(getattr(DEVICE_STATS, attr))}
        snap = DEVICE_LEDGER.snapshot()
        for name, key in (("entries", "entries"),
                          ("device_ms_total", "device_ms_total"),
                          ("compile_ms_total", "compile_ms_total"),
                          ("dispatches_total", "dispatches_total"),
                          ("recompiles_attributed_total",
                           "recompiles_attributed")):
            if vals.get(f"flink_tpu_profiler_{name}") != float(snap[key]):
                wrong[f"profiler_{name}"] = (
                    vals.get(f"flink_tpu_profiler_{name}"), snap[key])
        if wrong or not mid or vals.get("flink_tpu_profiler_enabled") != 1:
            raise AssertionError(f"the scrape disagrees with DEVICE_STATS "
                                 f"and the ledger: {wrong}, mid-run {mid}")
        mid_vals = mid.pop("values")
        # (b): the first completed checkpoint's tree
        stats = [st for st in job.coordinator.stats if "barrier_to_ack_s"
                 in st]
        if not stats:
            raise AssertionError("no checkpoint completed mid-run")
        st = stats[0]
        spans = TRACER.retained_spans()
        (root,) = [sp for sp in spans if sp.name == "Checkpoint"
                   and sp.attributes.get("checkpointId") == st["id"]]
        tree = [sp for sp in spans if sp.trace_id == root.trace_id
                and sp is not root]
        bad = [sp.name for sp in tree if sp.parent_id != root.span_id]
        names = sorted(f"{sp.name}:{sp.attributes.get('task', '')}"
                       for sp in tree)
        want = sorted([f"Snapshot:{t}" for t in job.tasks]
                      + [f"Align:{t}" for t in job.tasks
                         if t not in job.source_tasks]
                      + ["Store:", "Notify:"])
        if bad or root.parent_id or names != want:
            raise AssertionError(f"checkpoint {st['id']}'s tree: {names}, "
                                 f"want {want}; not on the root: {bad}")
        tree_ms = {f"{sp.name}:{sp.attributes.get('task', '')}".rstrip(":"):
                   sp.duration_ms for sp in tree}
        # the Perfetto export
        doc = chrome_trace_events(spans,
                                  counters=DEVICE_LEDGER.trace_counters())
        path = os.path.join(export_dir, "q5_10m.trace.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        with open(path) as f:
            back = json.load(f)
        events = back["traceEvents"]
        ids = {e["args"]["span_id"] for e in events if e["ph"] == "X"}
        dangling = [e["name"] for e in events if e["ph"] == "X"
                    and e["args"].get("parent_id", "") not in ids | {""}]
        if dangling:
            raise AssertionError(f"spans whose parent is not in the "
                                 f"export: {dangling}")
        tracks: dict = {}
        for e in events:
            if e["ph"] == "C":
                tracks[e["name"]] = tracks.get(e["name"], 0) + 1
        kinds: dict = {}
        for e in events:
            kinds[e["ph"]] = kinds.get(e["ph"], 0) + 1
        by_name: dict = {}
        for sp in spans:
            key = f"{sp.scope}.{sp.name}"
            by_name[key] = by_name.get(key, 0) + 1
        return {
            "run": {"wall_s": job.wall_s, "windows_checked": windows,
                    "checkpoints_completed": len(stats),
                    "spans": by_name},
            "checkpoint_tree": {
                "id": st["id"], "root_ms": root.duration_ms,
                "span_ms": tree_ms,
                "coordinator": {"duration_s": st["duration_s"],
                                "barrier_to_ack_s": st["barrier_to_ack_s"],
                                "store_s": st["store_s"],
                                "bytes_written": st["bytes_written"]}},
            "perfetto": {"path": path, "bytes": os.path.getsize(path),
                         "events": len(events), "by_phase": kinds,
                         "counter_tracks": tracks},
            "scrape": {"mid_run": {**mid, "series": len(mid_vals),
                                   "d2h_fires": mid_vals.get(
                                       "flink_tpu_device_d2h_fires")},
                       "after_run": {**final, "series": len(vals)},
                       "device_series_equal": len(DEVICE_GAUGES),
                       "profiler_series_equal": 5}}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def tracing_phase(torch, dev) -> dict:
    """Spans, the flight recorder, the Perfetto export and the reporters
    on Q5-10M: (a) tracing's cost, (b) one traced run's checkpoint tree
    and its export, (c) a scrape, (d) the faults phase's dumps. The
    tracer's settings go back to the defaults afterwards."""
    from flink_tpu_torch.core import Configuration
    from flink_tpu_torch.metrics import TRACER, set_compile_tracer

    t0 = time.perf_counter()
    _label, n_keys, n_events, _cap = Q5_CELLS[1]
    q5_expected(n_keys, n_events, q5_panes(n_events) * PANE_MS)
    oracle_s = time.perf_counter() - t0
    try:
        cost = tracing_cost(torch, dev)
        run = tracing_run(torch, dev)
    finally:
        TRACER.configure(Configuration())
        set_compile_tracer(TRACER)
    return {"tracing": {
        "oracle_s": oracle_s, "cost": cost, **run,
        "dumps": FLIGHT_DUMPS or "the faults phase did not run in this "
                                 "call",
        "seconds_without_oracle": time.perf_counter() - t0 - oracle_s}}


def observability_phases(torch, dev) -> dict:
    """The ledger, the build cache, the sync audit and tracing, timed."""
    t0 = time.perf_counter()
    emit(ledger_phase(torch, dev))
    t1 = time.perf_counter()
    emit(aot_phase(torch, dev))
    t2 = time.perf_counter()
    emit(sync_audit_phase(torch, dev))
    t3 = time.perf_counter()
    emit(tracing_phase(torch, dev))
    return {"ledger": t1 - t0, "aot": t2 - t1, "sync_audit": t3 - t2,
            "tracing": time.perf_counter() - t3}

# -- the DataStream core (datastream_core) --------------------------------------
#: (a) BASELINE config #1, bench.py::bench_wordcount: events, words, the
#: tumbling window, the event-time span (8 windows) and the batch
WC_EVENTS, WC_WORDS, WC_WINDOW_MS, WC_SPAN_MS, WC_BATCH = \
    500_000, 5000, 5000, 40_000, 1 << 15
#: (b) BASELINE config #2 on Q5-10M's bid stream: Q1's rate (q1.sql) and
#: Q2's auction modulus (q2.sql)
Q1_RATE, Q2_MOD = 0.908, 123
#: (c) the KeyedProcessFunction job: bids, auctions, event-time span,
#: batch and the timer's delay after an auction's first bid. Cut for the
#: smoke's time limit: a row is one Python call, three launches (the
#: probe, row_set, row_get) and about seven host transfers, 786 us a row
#: on an H100 (2^17 bids over 2^14 auctions took 103.1 s); a sixteenth
#: of the bids and an eighth of the auctions keep 4 bids an auction (an
#: eighth of both, 8 an auction, before the patterns phase; 2^13 bids
#: before the runtime_io phase)
KP_BIDS, KP_AUCTIONS, KP_SPAN_MS, KP_BATCH, KP_TIMER_MS = \
    1 << 12, 1 << 11, 40_000, 1 << 12, 10_000
#: (d) CUMULATE through SQL on the datagen DDL (the shape of Flink's
#: documented CUMULATE example: a 2 s step in a 10 s window); 2^15 rows,
#: a quarter of 2^17, for the smoke's time limit (a row is about 5
#: windows of host state work, 7.1 K to 7.8 K rows/s on an H100's host;
#: 2^16 before the patterns phase, 2^15 before the runtime_io phase)
CUM_ROWS, CUM_AUCTIONS, CUM_STEP_MS, CUM_SIZE_MS = 1 << 14, 4096, 2000, \
    10_000
CUM_SQL = ("SELECT auction, window_start, window_end, COUNT(*) AS c, "
           "SUM(price) AS s FROM CUMULATE(TABLE bid, DESCRIPTOR(ts), "
           "INTERVAL '2' SECOND, INTERVAL '10' SECOND) GROUP BY auction, "
           "window_start, window_end")


def wordcount_words(idx: np.ndarray) -> np.ndarray:
    """bench.py::bench_wordcount's word of each event index."""
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return (u % np.uint64(WC_WORDS)).astype(np.int64)


def wordcount_phase(torch, dev, events: int = WC_EVENTS) -> dict:
    """(a) Streaming WordCount on the host path, as bench_wordcount: words
    (an object column) -> key_by(word) -> 5 s tumbling event-time windows
    -> sum(one) on the hashmap backend and the host WindowOperator, every
    window's counts against a Counter of the same words."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration, Schema, \
        WatermarkStrategy
    from flink_tpu_torch.window import TumblingEventTimeWindows

    vocab = np.array([f"word{i:04d}" for i in range(WC_WORDS)],
                     dtype=object)

    def gen(idx):
        return {"word": vocab[wordcount_words(idx)],
                "one": np.ones(len(idx), np.int64),
                "ts": (idx * WC_SPAN_MS) // events}

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": WC_BATCH,
                       "pipeline.auto-watermark-interval": 0}), device=dev)
    env.set_state_backend("hashmap")
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    got = {}

    def sink(b):
        for t, (word, count) in zip(b.timestamps.tolist(), b.iter_rows()):
            if (t, word) in got:
                raise AssertionError(f"WordCount: window {t} of {word!r} "
                                     "fired twice")
            got[(t, word)] = count

    (env.datagen(gen, Schema([("word", object), ("one", np.int64),
                              ("ts", np.int64)]), count=events,
                 timestamp_column="ts", watermark_strategy=ws)
        .key_by("word").window(TumblingEventTimeWindows.of(WC_WINDOW_MS))
        .sum("one").add_sink(sink, "count"))
    job = env.execute("wordcount")
    idx = np.arange(events, dtype=np.int64)
    window = (idx * WC_SPAN_MS) // events // WC_WINDOW_MS
    codes, counts = np.unique(window * WC_WORDS + wordcount_words(idx),
                              return_counts=True)
    want = {(int(c // WC_WORDS) * WC_WINDOW_MS + WC_WINDOW_MS - 1,
             str(vocab[c % WC_WORDS])): int(n)
            for c, n in zip(codes.tolist(), counts.tolist())}
    if got != want:
        raise AssertionError(f"WordCount: {len(got)} window rows, "
                             f"{len(want)} expected, "
                             f"{sum(got.get(k) != v for k, v in want.items())}"
                             " differ")
    return {"events": events, "words": WC_WORDS, "windows": 8,
            "batch": WC_BATCH, "backend": "hashmap", "rows": len(got),
            "wall_s": job.wall_s,
            "events_per_sec": events / job.wall_s,
            "tasks": task_record(job)}


class _DeviceTally:
    """A callable sink of device batches: counts rows and batches, sums
    ``columns`` on the card (no host copy), keeps the first batch's columns
    for the check, and counts batches that reached it copied home."""

    def __init__(self, torch, columns: tuple):
        self.torch = torch
        self.columns = columns
        self.rows = self.batches = self.host_copies = 0
        self.sums = None
        self.first = None

    def __call__(self, b):
        from flink_tpu_torch.core.device_records import DeviceRecordBatch
        if not isinstance(b, DeviceRecordBatch):
            raise AssertionError(f"a {type(b).__name__} reached the device "
                                 "sink: the stage left the card")
        self.batches += 1
        self.rows += b.n
        self.host_copies += b._host is not None
        cols = [b.dcolumns[c] for c in self.columns]
        if self.first is None:
            self.first = [c.clone() for c in cols + [b.dtimestamps]]
        part = [c.sum(dtype=c.dtype) for c in cols]
        self.sums = part if self.sums is None else [
            a + p for a, p in zip(self.sums, part)]


def q1_q2_functions(torch):
    """Nexmark Q1 (the price in euros, 0.908 * price in float64, as a
    torch op) and Q2 (auction % 123 == 0, a torch mask) as vectorized
    DataStream functions over device batches."""
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.core.device_records import DeviceRecordBatch
    from flink_tpu_torch.core.functions import FilterFunction, MapFunction

    class Q1(MapFunction):
        def map_batch(self, batch):
            cols = dict(batch.dcolumns)
            cols["price"] = cols["price"].to(torch.float64) * Q1_RATE
            schema = Schema([(f.name, np.float64 if f.name == "price"
                              else f.dtype) for f in batch.schema.fields])
            return DeviceRecordBatch(schema, cols, batch.dtimestamps,
                                     batch.ts_min, batch.ts_max,
                                     batch.ts_column)

    class Q2(FilterFunction):
        def filter_batch(self, batch):
            return batch.device_column("auction") % Q2_MOD == 0

    return Q1, Q2


def stateless_job(torch, dev, name: str, stage, n_keys: int,
                  n_events: int, span: int, batch: int, count: int):
    """One Nexmark stateless job on Q5's device bid stream of
    ``n_events`` (the first ``count`` of them read): datagen ->
    ``stage`` -> a ``_DeviceTally`` of auction and price; returns (the
    tally, the finished job)."""
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Schema, WatermarkStrategy

    tally = _DeviceTally(torch, ("auction", "price"))
    env = sql_env(torch, dev, batch)
    source = DataGenSource(
        q5_gen(n_keys, n_events, span),
        Schema([("auction", np.int64), ("price", np.int64),
                ("ts", np.int64)]), count=count, timestamp_column="ts",
        device=True)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    stage(env.from_source(source, ws, "DataGen")).add_sink(tally, name)
    return tally, env.execute(f"nexmark-{name}")


def filtered_q5_expected(keys: np.ndarray, keep: np.ndarray, n_events: int,
                         span: int) -> list:
    """``q5_expected`` of the events ``keep`` lets through, over dense ids
    of their keys (a bincount over the kept keys, not the key space),
    the candidates and strict sets mapped back to the keys."""
    uniq, dense = np.unique(keys[keep], return_inverse=True)
    ids = np.zeros(n_events, np.int64)
    ids[keep] = dense
    out = []
    for p_end, want, cand, cc, cr, strict in q5_expected(
            len(uniq), n_events, span, keys=ids, keep=keep):
        out.append((p_end, want, uniq[cand], cc, cr,
                    {int(uniq[i]) for i in strict}))
    return out


def nexmark_stateless_phase(torch, dev, cell: tuple = Q5_CELLS[1],
                            batch: int = BATCH) -> dict:
    """(b) Q1 and Q2 as DataStream map and filter on Q5-10M's device bid
    stream (2^25 events, batches of 2^19), each into a sink that counts
    and sums on the card; then Q2 -> key_by -> the Q5 sliding window ->
    device_aggregate(count, emit_topk), every window against the oracle
    under the tie rule. Each job runs 4 batches first (a warm-up: the
    kernels' first launches), then once timed."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    label, n_keys, n_events, cap = cell
    span = q5_panes(n_events, batch) * PANE_MS
    Q1, Q2 = q1_q2_functions(torch)
    idx = np.arange(n_events, dtype=np.int64)
    keys = ((idx.astype(np.uint64) * np.uint64(MULT))
            % np.uint64(n_keys)).astype(np.int64)
    price = idx % 997 + 1
    ts = (idx * span) // n_events
    warm = min(4 * batch, n_events)
    out = {"cell": f"Q5-{label} bids", "events": n_events, "batch": batch}
    for name, stage in (("q1", lambda s: s.map(Q1())),
                        ("q2", lambda s: s.filter(Q2()))):
        stateless_job(torch, dev, name, stage, n_keys, n_events, span, batch,
                      warm)
        tally, job = stateless_job(torch, dev, name, stage, n_keys, n_events,
                                   span, batch, n_events)
        first_n = min(batch, n_events)
        if name == "q1":
            keep = np.ones(n_events, bool)
            want_price = price * Q1_RATE
        else:
            keep = keys % Q2_MOD == 0
            want_price = price
        a_sum, p_sum = (v.item() for v in tally.sums)
        f_keep = keep[:first_n]
        f_auction, f_price, f_ts = (t.cpu().numpy() for t in tally.first)
        exact = (tally.rows == int(keep.sum())
                 and a_sum == int(keys[keep].sum())
                 and np.array_equal(f_auction, keys[:first_n][f_keep])
                 and np.array_equal(f_price, want_price[:first_n][f_keep])
                 and np.array_equal(f_ts, ts[:first_n][f_keep]))
        want_p = float(want_price[keep].sum())
        if name == "q2":
            exact = exact and p_sum == int(want_p)
        rel = abs(p_sum - want_p) / want_p
        if not exact or rel > 1e-9 or tally.host_copies:
            raise AssertionError(
                f"{name}: rows {tally.rows} (want {int(keep.sum())}), sums "
                f"{a_sum}, {p_sum} (want {int(keys[keep].sum())}, {want_p}),"
                f" host copies {tally.host_copies}")
        out[name] = {"rows_out": tally.rows, "batches": tally.batches,
                     "host_copies_per_batch": tally.host_copies
                     / tally.batches,
                     "price_sum_rel_err": rel, "wall_s": job.wall_s,
                     "events_per_sec": n_events / job.wall_s,
                     "tasks": task_record(job)}
    # Q2 in front of the Q5 device window
    keep = keys % Q2_MOD == 0
    expected = filtered_q5_expected(keys, keep, n_events, span)
    run_q5(torch, dev, n_keys, warm, cap, batch=batch,
           stage=lambda s: s.filter(Q2()))
    reset_launches()
    job, got, _span = run_q5(torch, dev, n_keys, n_events, cap, batch=batch,
                             stage=lambda s: s.filter(Q2()))
    launches = dict(KERNEL_LAUNCHES)
    windows = q5_check(expected, got)
    batches = -(-n_events // batch)
    if launches["ingest_step"] != batches or not launches["hist256"]:
        raise AssertionError(f"Q2 -> Q5: launches {launches}, "
                             f"{batches} batches")
    out["q2_q5_window"] = {"rows_in_window": int(keep.sum()),
                           "windows_checked": windows,
                           "wall_s": job.wall_s,
                           "events_per_sec": n_events / job.wall_s,
                           "launches": {k: v for k, v in launches.items()
                                        if v},
                           "tasks": task_record(job)}
    return out


def keyed_process_expected(bids: int = KP_BIDS,
                           auctions: int = KP_AUCTIONS,
                           batch: int = KP_BATCH) -> list:
    """Dict oracle of (c): the operator's order of events, a batch at a
    time; after each batch the watermark (the batch's last ts - 1) fires
    the timers at or before it, and the end of input fires the rest."""
    import heapq
    idx = np.arange(bids, dtype=np.int64)
    auction = sql_join_random(idx, 0, auctions - 1).tolist()
    ts = ((idx * KP_SPAN_MS) // bids).tolist()
    count, timers, rows = {}, [], []

    def fire(upto):
        while timers and timers[0][0] <= upto:
            t, a = heapq.heappop(timers)
            rows.append((a, count.pop(a), t))

    for lo in range(0, bids, batch):
        for a, t in zip(auction[lo:lo + batch], ts[lo:lo + batch]):
            if not count.get(a):
                heapq.heappush(timers, (t + KP_TIMER_MS, a))
                count[a] = 0
            count[a] += 1
        fire(ts[min(lo + batch, bids) - 1] - 1)
    fire(1 << 62)
    return sorted(rows)


def row_api_profile(torch, dev, rows: int = 500) -> dict:
    """Where a process function's row goes on the device backend: ``rows``
    of ``value()`` and ``update()`` on one ValueState (a key a row, as in
    (c)), timed, then again under cProfile (the host's functions by their
    own seconds, the profiler's cost included)."""
    import cProfile
    import pstats
    from flink_tpu_torch.core import KeyGroupRange
    from flink_tpu_torch.state.descriptors import ValueStateDescriptor
    from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend

    b = DeviceKeyedStateBackend(KeyGroupRange(0, MAXP - 1), MAXP, device=dev)
    h = b.get_partitioned_state(ValueStateDescriptor("n", default=0))
    keys = sql_join_random(np.arange(rows), 0, KP_AUCTIONS - 1).tolist()

    def run():
        for k in keys:
            b.set_current_key(k)
            h.update(h.value() + 1)

    run()                                        # warm-up
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    prof = cProfile.Profile()
    prof.enable()
    run()
    prof.disable()
    top = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][2])[:10]
    return {"rows": rows, "us_per_row": wall / rows * 1e6,
            "profiled_top_own_s": [
                {"function": f"{os.path.basename(f)}:{line}({name})",
                 "calls": v[1], "own_s": v[2]}
                for (f, line, name), v in top]}


def keyed_process_phase(torch, dev, bids: int = KP_BIDS) -> dict:
    """(c) A KeyedProcessFunction on the device backend: a ValueState
    count an auction on the row plane; an auction's first bid sets an
    event-time timer 10 s on, which emits (auction, count) and clears the
    count. Every row against a dict; row_get, row_set and row_unset must
    each launch."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration, Schema, \
        WatermarkStrategy
    from flink_tpu_torch.core.functions import ProcessFunction
    from flink_tpu_torch.state.descriptors import ValueStateDescriptor

    class FirstBidTimer(ProcessFunction):
        def open(self, ctx):
            self._ctx = ctx
            self._desc = ValueStateDescriptor("bids", default=0)

        def process_element(self, value, ctx, out):
            st = self._ctx.get_state(self._desc)
            c = st.value()
            if c == 0:
                ctx.timer_service.register_event_time_timer(
                    ctx.timestamp + KP_TIMER_MS)
            st.update(c + 1)

        def on_timer(self, ts, ctx, out):
            st = self._ctx.get_state(self._desc)
            out.collect((ctx.current_key, int(st.value()), ts), ts)
            st.clear()

    def gen(idx):
        return {"auction": sql_join_random(idx, 0, KP_AUCTIONS - 1),
                "ts": (idx * KP_SPAN_MS) // bids}

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": KP_BATCH,
                       "pipeline.auto-watermark-interval": 0}), device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    stream = (env.datagen(gen, Schema([("auction", np.int64),
                                       ("ts", np.int64)]), count=bids,
                          timestamp_column="ts", watermark_strategy=ws)
              .key_by("auction").process(FirstBidTimer()))
    got = []
    stream.add_sink(lambda b: got.extend(b.iter_rows()), "rows")
    reset_launches()
    job = env.execute("keyed-process")
    launches = dict(KERNEL_LAUNCHES)
    want = keyed_process_expected(bids)
    if sorted(got) != want:
        raise AssertionError(f"keyed process: {len(got)} rows, {len(want)} "
                             "expected, or their values differ")
    if not all(launches[k] for k in ("row_get", "row_set", "row_unset")):
        raise AssertionError(f"keyed process: launches {launches}")
    (op,) = [o for o in job.operators if type(o).__name__
             == "KeyedProcessOperator"]
    if op._backend.device.type != torch.device(dev).type:
        raise AssertionError("keyed process: the backend is not on "
                             f"{dev}: {op._backend.device}")
    return {"bids": bids, "auctions": KP_AUCTIONS, "batch": KP_BATCH,
            "rows_out": len(got), "backend": "tpu",
            "capacity": op._backend.capacity, "wall_s": job.wall_s,
            "rows_per_sec": bids / job.wall_s,
            "launches": {k: v for k, v in launches.items() if v},
            "tasks": task_record(job),
            "row_api_profile": row_api_profile(torch, dev)}


def cumulate_expected(rows: int = CUM_ROWS) -> dict:
    """numpy oracle of CUM_SQL over the datagen table: every (auction,
    window_start, window_end) -> (count, sum of price)."""
    idx = np.arange(rows, dtype=np.int64)
    auction = sql_join_random(idx, 0, CUM_AUCTIONS - 1)
    price = sql_join_random(idx, 1, 1000)
    out = {}
    for base in range(0, rows, CUM_SIZE_MS):
        for end in range(base + CUM_STEP_MS, base + CUM_SIZE_MS + 1,
                         CUM_STEP_MS):
            lo, hi = base, min(end, rows)
            if lo >= hi:
                continue
            c = np.bincount(auction[lo:hi], minlength=CUM_AUCTIONS)
            s = np.bincount(auction[lo:hi], weights=price[lo:hi],
                            minlength=CUM_AUCTIONS)
            for a in np.flatnonzero(c).tolist():
                out[(a, base, end)] = (int(c[a]), int(s[a]))
    return out


def cumulate_phase(torch, dev, rows: int = CUM_ROWS) -> dict:
    """(d) CUMULATE through SQL on the host WindowOperator: the datagen
    DDL's bid table (auction random over [0, 4095], price random over [1,
    1000], ts the sequence number), every final row against numpy."""
    from flink_tpu_torch.sql import TableEnvironment

    t_env = TableEnvironment(sql_env(torch, dev, 1 << 14))
    t_env.execute_sql(
        "CREATE TABLE bid (auction BIGINT, price BIGINT, ts BIGINT, "
        "WATERMARK FOR ts AS ts - INTERVAL '0' SECOND) WITH ('connector' = "
        f"'datagen', 'number-of-rows' = '{rows}', "
        "'fields.auction.kind' = 'random', 'fields.auction.min' = '0', "
        f"'fields.auction.max' = '{CUM_AUCTIONS - 1}', "
        "'fields.price.kind' = 'random', 'fields.price.min' = '1', "
        "'fields.price.max' = '1000')")
    t0 = time.perf_counter()
    res = t_env.execute_sql(CUM_SQL, timeout=SQL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = res.collect()
    got = {(int(a), int(ws), int(we)): (int(c), int(s))
           for a, ws, we, c, s in out}
    want = cumulate_expected(rows)
    if len(got) != len(out) or got != want:
        raise AssertionError(f"CUMULATE: {len(out)} rows, {len(want)} "
                             "expected, or their values differ")
    return {"rows_in": rows, "rows_out": len(out), "sql": CUM_SQL,
            "wall_s": wall, "rows_per_sec": rows / wall}


def datastream_core_phase(torch, dev, sizes: dict | None = None) -> dict:
    """The DataStream core on the card, each job through ``env.execute()``
    against its oracle: (a) WordCount, (b) Q1/Q2 and Q2 -> Q5, (c) a
    KeyedProcessFunction on the device backend, (d) CUMULATE through SQL;
    the seconds of each. ``sizes``: keyword arguments a job (a rehearsal
    at a small size on the CPU)."""
    out, seconds = {}, {}
    for name, fn in (("wordcount", wordcount_phase),
                     ("nexmark_q1_q2", nexmark_stateless_phase),
                     ("keyed_process", keyed_process_phase),
                     ("cumulate_sql", cumulate_phase)):
        t0 = time.perf_counter()
        out[name] = fn(torch, dev, **(sizes or {}).get(name, {}))
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


# -- connectors, file systems and formats ------------------------------------
#: (a) Q5 at 10M keys from columnar files: Q5-10M's bid stream, written in
#: ``files`` parts (a manual checkpoint rolls each), read back through
#: FileSource
CONN_Q5 = {"keys": 10_000_000, "events": 1 << 25, "capacity": 1 << 24,
           "batch": BATCH, "files": 4}
#: (b) SQL over the filesystem: csv bids into the device GROUP BY, and an
#: append-only INSERT INTO a json table under checkpoints of ``ckpt_s``
#: (2^17 rows: 2^18 before the runtime_io phase, cut for the time limit)
CONN_SQL = {"rows": 1 << 17, "auctions": 1 << 16, "batch": 1 << 14,
            "hot_price": 990, "ckpt_s": 0.05}
#: (c) the log: Q5's shape over ``auctions`` from a topic of ``lines`` json
#: bids in ``partitions``, its fired rows into a transactional topic; then
#: ``net_lines`` through a broker on loopback (2^17 lines: 2^18 before PR
#: 24, cut for the time limit)
CONN_LOG = {"lines": 1 << 17, "net_lines": 1 << 14, "auctions": 1 << 16,
            "partitions": 4, "batch": 1 << 12, "capacity": 1 << 18,
            "cut": 2 / 3}
#: (d) the socket: ``lines`` of "word ts" into a word count of tumbling
#: windows of ``window_ms`` on the host WindowOperator
CONN_SOCKET = {"lines": 1 << 14, "words": 500, "window_ms": 1000,
               "span_ms": 8000}
Q5_FIELDS = (("auction", np.int64), ("price", np.int64), ("ts", np.int64))


def q5_host_gen(n_keys: int, n_events: int, span: int):
    """``q5_gen`` on numpy indices (a host source's batches)."""
    def gen(idx):
        return {"auction": bid_keys(idx, n_keys), "price": idx % 997 + 1,
                "ts": (idx * span) // n_events}

    return gen


def commit_watch(sink):
    """``sink`` behind a port ``Sink`` whose writers pass every call on
    and record each checkpoint id they committed (``committed``);
    ``wait_commit(cid)`` blocks until one did."""
    import threading

    from flink_tpu_torch.connectors.core import Sink, SinkWriter

    class Watch(Sink):
        def __init__(self):
            self.inner = sink
            self.committed: list[int] = []
            self.cond = threading.Condition()

        def create_writer(self, subtask_index: int):
            inner, watch = sink.create_writer(subtask_index), self

            class Writer(SinkWriter):
                def write_batch(self, batch):
                    inner.write_batch(batch)

                def flush(self):
                    inner.flush()

                def prepare_commit(self, checkpoint_id):
                    inner.prepare_commit(checkpoint_id)

                def commit(self, checkpoint_id):
                    inner.commit(checkpoint_id)
                    with watch.cond:
                        watch.committed.append(checkpoint_id)
                        watch.cond.notify_all()

                def snapshot(self):
                    return inner.snapshot()

                def restore(self, state):
                    inner.restore(state)

                def close(self):
                    inner.close()

            return Writer()

        def wait_commit(self, cid: int, timeout: float = 120.0) -> None:
            with self.cond:
                if not self.cond.wait_for(lambda: cid in self.committed,
                                          timeout):
                    raise AssertionError(f"checkpoint {cid} never "
                                         "committed at the sink")

    return Watch()


def checkpoint_at(job, coordinator, records: int,
                  timeout: float = 300.0):
    """Once the job's sources have read ``records``, one checkpoint
    (the job has no periodic ones); returns the completed checkpoint."""
    t0 = time.perf_counter()
    while (job.records_in < records and not job._done.is_set()
           and time.perf_counter() - t0 < timeout):
        time.sleep(0.001)
    if job._done.is_set():
        raise AssertionError(f"the job ended before {records} records "
                             f"were read ({job.records_in}): "
                             f"{job._failed}")
    pending = coordinator.trigger_checkpoint()
    t0 = time.perf_counter()
    # a source that ended before the barrier reached it never takes it
    while (not pending.done.wait(0.05) and not job._done.is_set()
           and time.perf_counter() - t0 < timeout):
        pass
    if pending.completed is None and not pending.done.wait(1.0):
        raise AssertionError(f"checkpoint {pending.checkpoint_id} did not "
                             f"complete; the job ended: {job._done.is_set()}")
    if pending.completed is None:
        raise AssertionError(f"checkpoint {pending.checkpoint_id} failed")
    return pending.completed


def manual_coordinator(job):
    from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator
    return CheckpointCoordinator(job, job.config)


def card_stage(torch, dev):
    """The stage a job puts between a host source and the device window:
    a map whose batch path moves the columns and timestamps to the card
    (a ``DeviceRecordBatch``), so the window takes its deferred step, one
    ``ingest_step`` a batch, as on a device source."""
    from flink_tpu_torch.core.device_records import DeviceRecordBatch
    from flink_tpu_torch.core.functions import MapFunction

    class ToCard(MapFunction):
        def map_batch(self, b):
            ts = np.asarray(b.timestamps)
            cols = {n: torch.from_numpy(np.ascontiguousarray(c)).to(dev)
                    for n, c in b.columns.items()}
            return DeviceRecordBatch(b.schema, cols,
                                     torch.from_numpy(ts).to(dev),
                                     int(ts.min()), int(ts.max()), "ts")

    return lambda stream: stream.map(ToCard(), "ToCard")


def q5_rows(batches) -> list:
    """A Q5 sink's batches as ``q5_env``'s ``got`` rows."""
    return [(int(b.timestamps[0]), b.column("auction"), b.column("bids"),
             b.column("revenue")) for b in batches if b.n]


def disjoint_windows(expected: list, parts: list) -> list:
    """Every part's windows against the oracle, none in two parts, and
    together every window; returns each part's window count."""
    by_end = {e[0]: e for e in expected}
    ends = []
    for rows in parts:
        e = [(ts + 1) // PANE_MS for ts, *_ in rows]
        if not set(e) <= set(by_end) or len(set(e)) != len(e):
            raise AssertionError(f"windows {e} repeat or are unknown")
        q5_check([by_end[x] for x in e], rows)
        ends.append(e)
    every = sorted(x for e in ends for x in e)
    if every != sorted(by_end):
        raise AssertionError(f"the parts' windows {ends} are not every "
                             f"window once")
    return [len(e) for e in ends]


def part_files(directory: str) -> tuple[list, list]:
    """(committed part files, in-progress files) of a sink directory."""
    names = sorted(os.listdir(directory))
    return ([n for n in names if not n.startswith(".")],
            [n for n in names if n.endswith(".inprogress")])


def q5_files_write(torch, dev, directory: str, c: dict) -> dict:
    """(a), the write: Q5's bid stream (a host source) into a columnar
    FileSink, a manual checkpoint after each ``files``-th of the events;
    each checkpoint's part must be visible once it committed, and the end
    leaves every part committed and none in progress."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.file import FileSink
    from flink_tpu_torch.core import Configuration, Schema
    from flink_tpu_torch.formats.columnar import ColumnarFormat

    n, span = c["events"], q5_panes(c["events"], c["batch"]) * PANE_MS
    schema = Schema(list(Q5_FIELDS))
    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": c["batch"]}), device=dev)
    sink = commit_watch(FileSink(directory, ColumnarFormat(schema),
                                 rolling_size=1 << 40))
    env.datagen(q5_host_gen(c["keys"], n, span), schema,
                count=n).add_sink(sink, "ColumnarFiles")
    t0 = time.perf_counter()
    job = env.execute_async("q5-files-write")
    coordinator = manual_coordinator(job)
    for k in range(1, c["files"]):
        cp = checkpoint_at(job, coordinator, k * n // c["files"])
        sink.wait_commit(cp.checkpoint_id)
        if len(part_files(directory)[0]) != k:
            raise AssertionError(f"after checkpoint {k}: parts "
                                 f"{part_files(directory)}")
    job.wait()
    wall = time.perf_counter() - t0
    committed, in_progress = part_files(directory)
    if in_progress or len(committed) != c["files"]:
        raise AssertionError(f"the write left parts {committed} and in "
                             f"progress {in_progress}")
    nbytes = sum(os.path.getsize(os.path.join(directory, f))
                 for f in committed)
    (src,) = job.source_tasks.values()
    return {"events": n, "batch": c["batch"], "format": "columnar",
            "checkpoints": len(coordinator.stats),
            "files_committed": len(committed), "in_progress_left": 0,
            "bytes_written": nbytes, "bytes_a_row": nbytes / n,
            "wall_s": wall, "events_per_sec": n / wall,
            "task_cpu_s": src.cpu_s}


def q5_files_env(torch, dev, directory: str, c: dict, **kw):
    """(a), the read: FileSource over the committed parts -> the card ->
    key_by(auction) -> Q5's sliding window, count and sum(price), top
    1000, as ``q5_env``."""
    from flink_tpu_torch.connectors.file import FileSource
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.formats.columnar import ColumnarFormat

    source = FileSource(directory, ColumnarFormat(Schema(list(Q5_FIELDS))))
    return q5_env(torch, dev, c["keys"], c["events"], c["capacity"],
                  batch=c["batch"], source=source,
                  stage=card_stage(torch, dev), **kw)


def q5_files_read(torch, dev, directory: str, c: dict) -> dict:
    """(a), the read, timed: every window against the Q5 oracle, one
    ``ingest_step`` a batch; the reader's CPU seconds in reads and in
    decode, the window task's idle share and the peak memory."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    start = fresh_memory(torch)
    env, got, span = q5_files_env(torch, dev, directory, c)
    reset_launches()
    job = env.execute("q5-files-read")
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    windows = q5_oracle_check(c["keys"], c["events"], span, got)
    if dev.type == "cuda" and (
            launches["ingest_step"] != c["events"] // c["batch"]
            or not launches["hist256"]):
        raise AssertionError(f"(a) read: launches {launches}")
    (src,) = job.source_tasks.values()
    tasks = task_record(job)
    (win,) = [t for t in tasks if t not in job.source_tasks]
    return {"windows_checked": windows, "wall_s": job.wall_s,
            "events_per_sec": c["events"] / job.wall_s,
            "source_cpu_s": src.cpu_s, "reader": dict(src.reader.stats),
            "window_task_idle_share": tasks[win]["idle_s"] / job.wall_s,
            "tasks": tasks, "peak_bytes": peak, "start": start,
            "launches": {k: v for k, v in launches.items() if v},
            "state_bytes": next(op.backend.state_nbytes
                                for op in job.operators
                                if hasattr(op, "backend"))}


def columnar_frames(path: str) -> list[int]:
    """The rows of each frame of a columnar file, from the frames'
    headers (``formats/columnar.py``'s layout)."""
    import struct

    rows = []
    with open(path, "rb") as f:
        while head := f.read(12):
            ln, _magic, hlen = struct.unpack("<I4sI", head)
            rows.append(json.loads(f.read(hlen))["n"])
            f.seek(ln - 8 - hlen, os.SEEK_CUR)
    return rows


def mid_file_cut(directory: str) -> int:
    """Events to read before the read job's checkpoint: half the frames
    of the middle part, so windows fire before it and the checkpoint
    lands inside the part unless the source runs ahead by the rest of
    its frames."""
    frames = [columnar_frames(os.path.join(directory, f))
              for f in part_files(directory)[0]]
    mid = len(frames) // 2
    return (sum(sum(f) for f in frames[:mid])
            + sum(frames[mid][:max(1, len(frames[mid]) // 2)]))


def q5_files_restore(torch, dev, directory: str, c: dict) -> dict:
    """(a) across a restore: the read job into a transactional sink, one
    checkpoint inside a part file (``mid_file_cut``), a cancel after the
    checkpoint committed, then a fresh job restored from it; the first
    job's committed windows and the second's are every window once."""
    from flink_tpu_torch.connectors.core import TransactionalCollectSink

    cut = mid_file_cut(directory)
    fresh_memory(torch)
    tx = TransactionalCollectSink()
    sink = commit_watch(tx)
    env, _got, span = q5_files_env(torch, dev, directory, c, sink=sink)
    job = env.execute_async("q5-files-checkpointed")
    coordinator = manual_coordinator(job)
    t0 = time.perf_counter()
    cp = checkpoint_at(job, coordinator, cut)
    ckpt_s = time.perf_counter() - t0
    sink.wait_commit(cp.checkpoint_id)
    job.cancel()
    (reader,) = [s["reader"] for s in cp.task_snapshots.values()
                 if s.get("reader") is not None]
    parts = part_files(directory)[0]
    size = os.path.getsize(os.path.join(directory, parts[reader["file"]]))
    if not 0 < reader["pos"] < size:
        raise AssertionError(f"the checkpoint's reader {reader} is not "
                             f"inside its file of {size} bytes")
    before = q5_rows(tx.batches)
    job.release()
    del job, env, tx, sink
    fresh_memory(torch)
    env2, got2, _span = q5_files_env(torch, dev, directory, c)
    env2.restore_from_checkpoint(cp)
    t1 = time.perf_counter()
    job2 = env2.execute("q5-files-restored")
    restored_s = time.perf_counter() - t1
    counts = disjoint_windows(q5_expected(c["keys"], c["events"], span),
                              [before, got2])
    if not all(counts):
        raise AssertionError(f"(a) restore: windows before the cancel and "
                             f"after the restore {counts}; one side empty")
    job2.release()
    return {"cut_events": cut, "checkpoint_reader": reader,
            "file_bytes": size,
            "checkpoint_s": ckpt_s, "snapshot_bytes":
            coordinator.stats[-1]["bytes"],
            "windows_before_cancel": counts[0],
            "windows_after_restore": counts[1], "windows_repeated": 0,
            "restored_run_s": restored_s}


def connectors_q5_files(torch, dev, c: dict | None = None) -> dict:
    """(a): Q5 at 10M keys written to and read from committed columnar
    files (a temporary directory, removed after)."""
    import shutil
    import tempfile

    c = dict(CONN_Q5, **(c or {}))
    directory = tempfile.mkdtemp(prefix="flink_tpu_torch_q5_files_")
    try:
        write = q5_files_write(torch, dev, directory, c)
        read = q5_files_read(torch, dev, directory, c)
        restore = q5_files_restore(torch, dev, directory, c)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return {"keys": c["keys"], "events": c["events"],
            "capacity": c["capacity"], "write": write, "read": read,
            "restore": restore}


def connectors_sql(torch, dev, c: dict | None = None) -> dict:
    """(b): a csv filesystem table of bids (written through INSERT INTO
    from a view of a host source) read into the device GROUP BY (COUNT,
    SUM, MIN, MAX of price by auction), every final group against numpy;
    then an append-only INSERT INTO a json table under checkpoints, its
    committed parts read back against the oracle's rows."""
    import shutil
    import tempfile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.core import Schema
    from flink_tpu_torch.formats.core import JsonFormat
    from flink_tpu_torch.sql import TableEnvironment

    c = dict(CONN_SQL, **(c or {}))
    n, auctions = c["rows"], c["auctions"]
    root = tempfile.mkdtemp(prefix="flink_tpu_torch_sql_fs_")
    cols = "auction BIGINT, price BIGINT, ts BIGINT"
    try:
        env = sql_env(torch, dev, c["batch"])
        t_env = TableEnvironment(env)
        schema = Schema(list(Q5_FIELDS))
        # Q5's bids with ts the event's index
        t_env.create_temporary_view("gen", env.datagen(
            q5_host_gen(auctions, n, n), schema, count=n), schema)
        t_env.execute_sql(f"CREATE TABLE bids ({cols}) WITH ('connector' = "
                          f"'filesystem', 'path' = '{root}/bids', "
                          "'format' = 'csv')")
        t0 = time.perf_counter()
        wrote = t_env.execute_sql("INSERT INTO bids SELECT * FROM gen",
                                  timeout=SQL_TIMEOUT_S).collect()
        write_s = time.perf_counter() - t0
        reset_launches()
        t1 = time.perf_counter()
        res = t_env.execute_sql(
            "SELECT auction, COUNT(*) c, SUM(price) s, MIN(price) mn, "
            "MAX(price) mx, AVG(price) a FROM bids GROUP BY auction",
            timeout=SQL_TIMEOUT_S)
        query_s = time.perf_counter() - t1
        launches = {k: v for k, v in KERNEL_LAUNCHES.items() if v}
        if dev.type == "cuda" and not launches.get("group_agg_first"):
            raise AssertionError(f"(b): the GROUP BY left the card: "
                                 f"{launches}")
        groups = groupby_check(groupby_expected(auctions, n), res)
        env.config.set("execution.checkpointing.interval", c["ckpt_s"])
        t_env.execute_sql(f"CREATE TABLE hot ({cols}) WITH ('connector' = "
                          f"'filesystem', 'path' = '{root}/hot', "
                          "'format' = 'json')")
        t2 = time.perf_counter()
        hot = t_env.execute_sql(
            f"INSERT INTO hot SELECT auction, price, ts FROM bids WHERE "
            f"price > {c['hot_price']}", timeout=SQL_TIMEOUT_S).collect()
        insert_s = time.perf_counter() - t2
        committed, in_progress = part_files(f"{root}/hot")
        if in_progress or len(committed) < 2:
            raise AssertionError(f"(b) json sink: parts {committed}, in "
                                 f"progress {in_progress}; a checkpoint "
                                 "rolls and commits a part")
        fmt = JsonFormat(schema)
        rows = sorted(r for f in committed for r in fmt.decode_lines(
            open(f"{root}/hot/{f}").read().splitlines()).iter_rows())
        idx = np.arange(n, dtype=np.int64)
        want = q5_host_gen(auctions, n, n)(idx)
        keep = want["price"] > c["hot_price"]
        expect = sorted(zip(want["auction"][keep].tolist(),
                            want["price"][keep].tolist(),
                            want["ts"][keep].tolist()))
        if rows != expect or hot != [(len(expect),)]:
            raise AssertionError(f"(b) json sink: {len(rows)} rows read "
                                 f"back, {len(expect)} expected")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"rows": n, "auctions": auctions, "rows_written": wrote[0][0],
            "csv_write_s": write_s, "group_by_s": query_s,
            "group_by_rows_per_sec": n / query_s, "launches": launches,
            **groups, "json_rows": len(rows), "json_parts": len(committed),
            "insert_s": insert_s}


def log_shape(c: dict, n: int) -> tuple[int, int]:
    """(c)'s micro-batch and span ms for a topic of ``n`` lines: the
    batch scaled with the topic, so the watermark's lag behind the
    partitions' round-robin (``log_q5_env``) stays a few panes."""
    batch = max(1, c["batch"] * n // c["lines"])
    return batch, q5_panes(n, batch) * PANE_MS


def log_bid_lines(n: int, auctions: int, partitions: int,
                  span: int) -> list:
    """(c)'s topic: Q5's bids (``auctions`` keys) as json lines, bid i in
    partition i % partitions; the lines by partition."""
    from flink_tpu_torch.core import RecordBatch, Schema
    from flink_tpu_torch.formats.core import JsonFormat

    idx = np.arange(n, dtype=np.int64)
    batch = RecordBatch(Schema(list(Q5_FIELDS)),
                        q5_host_gen(auctions, n, span)(idx))
    lines = JsonFormat(batch.schema).encode_batch(batch).splitlines()
    return [lines[p::partitions] for p in range(partitions)]


def log_q5_env(torch, dev, broker, topic: str, out_topic: str, c: dict,
               n: int, sink_wrap=None):
    """(c)'s job: a bounded LogSource over ``topic`` -> Q5's window on the
    card (a watermark behind the round-robin's disorder) -> a LogSink of
    json rows into ``out_topic``."""
    from flink_tpu_torch.connectors.log import LogSink, LogSource
    from flink_tpu_torch.core import Schema, WatermarkStrategy
    from flink_tpu_torch.formats.core import JsonFormat

    # a poll reads a micro-batch of one partition, in turns: rows of the
    # other partitions trail it by up to partitions x batch events, twice
    # that after a restore (the turns start again at partition 0, where a
    # partition read a batch ahead reads one more)
    batch, span = log_shape(c, n)
    lag = 2 * c["partitions"] * batch * span // n + PANE_MS
    out = Schema([("auction", np.int64), ("window_start", np.int64),
                  ("window_end", np.int64), ("bids", np.int32),
                  ("revenue", np.int64)])
    sink = LogSink(broker, out_topic, JsonFormat(out))
    env, _got, _span = q5_env(
        torch, dev, c["auctions"], n, c["capacity"], batch=batch,
        source=LogSource(broker, topic, JsonFormat(Schema(list(Q5_FIELDS))),
                         bounded=True),
        watermarks=WatermarkStrategy.for_bounded_out_of_orderness(lag),
        stage=card_stage(torch, dev), window_bounds=True,
        sink=sink if sink_wrap is None else sink_wrap(sink))
    return env, span


def log_windows(broker, topic: str, partitions: int) -> list:
    """The committed rows of a Q5 out topic as ``got`` rows, a window's
    rows in the order they were written; a window whose rows repeat
    fails."""
    import json

    rows = {}
    for p in range(partitions):
        for _o, line in broker.poll(topic, p, 0,
                                    broker.end_offset(topic, p)):
            r = json.loads(line)
            rows.setdefault(r["window_end"], []).append(
                (r["auction"], r["bids"], r["revenue"]))
    got = []
    for end in sorted(rows):
        w = rows[end]
        if len({a for a, _b, _r in w}) != len(w):
            raise AssertionError(f"window {end}: a row committed twice")
        got.append((end - 1, *(np.array(x) for x in zip(*w))))
    return got


def connectors_log(torch, dev, c: dict | None = None) -> dict:
    """(c): Q5's shape over a 4-partition json topic in an
    InMemoryLogBroker into a LogSink topic, cancelled after its first
    checkpoint committed and restored, every window and line once; then
    the same job through a LogBrokerServer on loopback."""
    from flink_tpu_torch.connectors.log import InMemoryLogBroker
    from flink_tpu_torch.connectors.log_net import LogBrokerServer, \
        RemoteLogBroker

    c = dict(CONN_LOG, **(c or {}))
    n, parts = c["lines"], c["partitions"]
    broker = InMemoryLogBroker(parts)
    t0 = time.perf_counter()
    span = log_shape(c, n)[1]
    by_part = log_bid_lines(n, c["auctions"], parts, span)
    for p, lines in enumerate(by_part):
        broker.append("bids", p, lines)
    produce_s = time.perf_counter() - t0
    broker.create_topic("q5")
    watch = {}

    def wrap(sink):
        watch["sink"] = commit_watch(sink)
        return watch["sink"]

    env, _span = log_q5_env(torch, dev, broker, "bids", "q5", c, n, wrap)
    job = env.execute_async("q5-log-checkpointed")
    cp = checkpoint_at(job, manual_coordinator(job), int(n * c["cut"]))
    watch["sink"].wait_commit(cp.checkpoint_id)
    job.cancel()
    job.release()
    committed_before = sum(broker.end_offset("q5", p) for p in range(parts))
    env2, _span = log_q5_env(torch, dev, broker, "bids", "q5", c, n)
    env2.restore_from_checkpoint(cp)
    t1 = time.perf_counter()
    job2 = env2.execute("q5-log-restored")
    restored_s = time.perf_counter() - t1
    if not committed_before:
        raise AssertionError("(c): no window committed before the cancel")
    expected = q5_expected(c["auctions"], n, span)
    got = log_windows(broker, "q5", parts)
    windows = q5_check(expected, got)
    lines = sum(broker.end_offset("q5", p) for p in range(parts))
    if lines != sum(len(w[1]) for w in got):
        raise AssertionError("(c): the out topic holds lines of no window")
    (reader,) = [s["reader"] for s in cp.task_snapshots.values()
                 if s.get("reader") is not None]
    job2.release()
    # the same job at net_lines through a broker behind TCP on loopback
    m = c["net_lines"]
    server = LogBrokerServer(InMemoryLogBroker(parts), port=0)
    remote = RemoteLogBroker(server.address)
    try:
        span_m = log_shape(c, m)[1]
        by_part = log_bid_lines(m, c["auctions"], parts, span_m)
        for p, lines_p in enumerate(by_part):
            remote.append("bids", p, lines_p)
        remote.create_topic("q5")
        env3, _span = log_q5_env(torch, dev, remote, "bids", "q5", c, m)
        t2 = time.perf_counter()
        env3.execute("q5-log-net")
        net_s = time.perf_counter() - t2
        net_windows = q5_check(q5_expected(c["auctions"], m, span_m),
                               log_windows(remote, "q5", parts))
    finally:
        remote.close()
        server.close()
    return {"lines": n, "partitions": parts, "auctions": c["auctions"],
            "produce_s": produce_s, "checkpoint_offsets": reader,
            "lines_committed_before_cancel": committed_before,
            "lines_committed": lines, "windows_checked": windows,
            "restored_run_s": restored_s,
            "restored_lines_per_sec": n * (1 - c["cut"]) / restored_s,
            "net_lines": m, "net_windows_checked": net_windows,
            "net_run_s": net_s}


def connectors_socket(torch, dev, c: dict | None = None) -> dict:
    """(d): a loopback server writes ``lines`` of "word ts" and closes;
    SocketSource -> a map that parses them (event time from ts) ->
    key_by(word) -> tumbling windows -> sum on the hashmap backend and
    the host WindowOperator, every window against a dict of the words."""
    import socket
    import threading

    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.connectors.socket import SocketSource
    from flink_tpu_torch.core import Configuration, RecordBatch, Schema
    from flink_tpu_torch.core.functions import MapFunction
    from flink_tpu_torch.window import TumblingEventTimeWindows

    c = dict(CONN_SOCKET, **(c or {}))
    n = c["lines"]
    idx = np.arange(n, dtype=np.int64)
    words = wordcount_words(idx) % c["words"]
    ts = idx * c["span_ms"] // n
    payload = "".join(f"w{w} {t}\n" for w, t in zip(words.tolist(),
                                                     ts.tolist())).encode()
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def serve():
        conn, _ = srv.accept()
        with conn:
            conn.sendall(payload)

    server = threading.Thread(target=serve, name="socket-smoke",
                              daemon=True)
    server.start()
    out_schema = Schema([("word", object), ("one", np.int64)])

    class Parse(MapFunction):
        def map_batch(self, b):
            split = [ln.split(" ") for ln in b.column("line")]
            return RecordBatch(
                out_schema, {"word": np.array([s[0] for s in split],
                                              dtype=object),
                             "one": np.ones(len(split), np.int64)},
                np.array([int(s[1]) for s in split], np.int64))

    env = StreamExecutionEnvironment(
        Configuration({"pipeline.auto-watermark-interval": 0}), device=dev)
    env.set_state_backend("hashmap")
    got = {}

    def sink(b):
        for t, (word, count) in zip(b.timestamps.tolist(), b.iter_rows()):
            if (t, word) in got:
                raise AssertionError(f"(d): window {t} of {word} twice")
            got[(t, word)] = count

    try:
        (env.from_source(SocketSource("127.0.0.1", port), name="Socket")
            .map(Parse(), "Parse")
            .key_by("word")
            .window(TumblingEventTimeWindows.of(c["window_ms"]))
            .sum("one").add_sink(sink, "count"))
        job = env.execute("socket-wordcount", timeout=300)
    finally:
        server.join(60)
        srv.close()
    want = {}
    for w, t in zip(words.tolist(), ts.tolist()):
        key = (t // c["window_ms"] * c["window_ms"] + c["window_ms"] - 1,
               f"w{w}")
        want[key] = want.get(key, 0) + 1
    if got != want:
        raise AssertionError(f"(d): {len(got)} window rows, {len(want)} "
                             "expected, or counts differ")
    return {"lines": n, "words": c["words"], "rows": len(got),
            "wall_s": job.wall_s, "lines_per_sec": n / job.wall_s}


def connectors_phase(torch, dev, sizes: dict | None = None) -> dict:
    """Connectors, file systems and formats on the card: (a) Q5 at 10M
    keys through committed columnar files, (b) SQL over filesystem
    tables, (c) the log, (d) the socket; the seconds of each.
    ``sizes``: each part's configuration overrides (a rehearsal on the
    CPU)."""
    out, seconds = {}, {}
    for name, fn in (("q5_files", connectors_q5_files),
                     ("sql_filesystem", connectors_sql),
                     ("log", connectors_log),
                     ("socket", connectors_socket)):
        t0 = time.perf_counter()
        out[name] = fn(torch, dev, (sizes or {}).get(name))
        seconds[name] = time.perf_counter() - t0
        emit({f"connectors_{name}": out[name]})
    out["seconds"] = seconds
    return out


# -- patterns: CEP, MATCH_RECOGNIZE, broadcast state, async I/O, gateway ---
#: the patterns phase's parts; (a) to (c) cut to half their stream for
#: the time limit when the runtime_io phase came (the rates kept: the
#: span halved with the events), the earlier figures in brackets. (a)
#: MATCH_RECOGNIZE's V shape over ticks of 2^13 symbols (about the listed
#: US equities), each about every 2 s (2^15 ticks over 8 s; 2^16 over 16
#: s, 2^17 before); (b) bench.py's bid stream with 2^13 bidders into CEP
#: (2^16 bids over 30 s, paced over 3 s; 2^17 over 60 s, 6 s); (c) the
#: dynamic-rules broadcast pattern (2^14 bids over 20 s; 2^15 over 40 s);
#: (d) async enrichment of Q5's bids over 2^16 auctions (2^16 bids: a
#: quarter of 2^18, for the time limit; its checkpoint waits for a
#: periodic watermark after half the bids); (e) the SQL gateway
PATTERNS = {
    "mr": {"ticks": 1 << 15, "symbols": 1 << 13, "span_ms": 8_000,
           "batch": 1 << 12, "prices": 64},
    "cep": {"bids": 1 << 16, "bidders": 1 << 13, "auctions": 1 << 12,
            "span_ms": 30_000, "within_ms": 10_000, "batch": 1 << 13,
            "capacity": 1 << 14, "topk": 100, "paced_s": 3.0},
    "broadcast": {"bids": 1 << 14, "auctions": 1 << 10, "buckets": 16,
                  "changes": 3, "span_ms": 20_000, "batch": 1 << 11,
                  "parallelism": 2, "paced_s": 1.0},
    "async": {"bids": 1 << 16, "auctions": 1 << 16, "batch": 1 << 12,
              "capacity": 100, "lookup_s": 1e-4, "threads": 16,
              "timeout_ms": 500, "ckpt_timeout_ms": 3000,
              "window_capacity": 1 << 17, "topk": 100, "wm_interval_s": 2.0},
    "gateway": {"ticks": 1 << 14, "symbols": 256, "bids": 1 << 16,
                "auctions": 1 << 12, "batch": 1 << 12},
}
PATTERN_TIMEOUT_S = 600
TICK_FIELDS = (("symbol", np.int64), ("price", np.int64), ("ts", np.int64))
CEP_BID_FIELDS = (("auction", np.int64), ("price", np.int64),
                  ("bidder", np.int64), ("ts", np.int64))
CEP_MATCH_FIELDS = (("auction", np.int64), ("price", np.int64),
                    ("ts", np.int64))
ENRICHED_FIELDS = (("auction", np.int64), ("price", np.int64),
                   ("ts", np.int64), ("category", np.int64))
#: (a)'s query: the V shape of Flink's MATCH_RECOGNIZE documentation (the
#: Ticker example) in the form the parser takes, under a device GROUP BY
MR_CLAUSE = """ticks MATCH_RECOGNIZE (
    PARTITION BY symbol ORDER BY ts
    MEASURES FIRST(START_ROW.price) AS start_price,
             LAST(PRICE_DOWN.price) AS bottom_price,
             PRICE_UP.price AS end_price
    ONE ROW PER MATCH
    AFTER MATCH SKIP PAST LAST ROW
    PATTERN (START_ROW PRICE_DOWN+ PRICE_UP)
    WITHIN INTERVAL '10' SECOND
    DEFINE PRICE_DOWN AS PRICE_DOWN.price < START_ROW.price,
           PRICE_UP AS PRICE_UP.price > LAST(PRICE_DOWN.price)
)"""
MR_MATCHES_SQL = f"SELECT * FROM {MR_CLAUSE}"
MR_GROUP_SQL = ("SELECT symbol, COUNT(*) AS matches, MIN(bottom_price) AS "
                "low, MAX(end_price) AS high FROM (SELECT * FROM "
                f"{MR_CLAUSE}) GROUP BY symbol")
#: what of the documentation's text the port does not take: each
#: replaces a part of MR_MATCHES_SQL
MR_DOC_FORMS = {
    "LAST(var.col, 1)": ("LAST(PRICE_DOWN.price)",
                         "LAST(PRICE_DOWN.price, 1)"),
    "IS NULL": ("PRICE_DOWN.price < START_ROW.price",
                "(LAST(PRICE_DOWN.price) IS NULL AND PRICE_DOWN.price < "
                "START_ROW.price)"),
    "AFTER MATCH SKIP TO LAST var": ("SKIP PAST LAST ROW",
                                     "SKIP TO LAST PRICE_UP"),
    "MATCH_ROWTIME()": ("PRICE_UP.price AS end_price",
                        "MATCH_ROWTIME() AS end_price"),
}
Q17_SQL = ("SELECT auction, COUNT(*) c, SUM(price) s, MIN(price) mn, "
           "MAX(price) mx, AVG(price) a FROM bids GROUP BY auction")


def mix_bits(idx: np.ndarray, shift: int) -> np.ndarray:
    """A second hash of the index (splitmix64's multiplier), uint64."""
    return ((idx.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9))
            >> np.uint64(shift))


def mr_ticks(c: dict):
    """(a)'s ticks on numpy indices: the symbol by the MULT mixer, a price
    of 1 to ``prices`` by a second hash, ts index * span // ticks."""
    n = c["ticks"]

    def gen(idx):
        return {"symbol": bid_keys(idx, c["symbols"]),
                "price": (mix_bits(idx, 40) % np.uint64(c["prices"]))
                .astype(np.int64) + 1,
                "ts": (idx * c["span_ms"]) // n}

    return gen


def mr_scan(c: dict, within_ms: int = 10_000) -> list:
    """The oracle of (a)'s clause: a scan of each symbol's ticks in (ts,
    arrival) order. From a start row A the longest match: B rows below A
    (consecutive), then C above the last B, every row within
    ``within_ms`` of A; AFTER MATCH SKIP PAST LAST ROW (the next start
    after C), leftmost first. Rows (symbol, start, bottom, end price)."""
    cols = mr_ticks(c)(np.arange(c["ticks"], dtype=np.int64))
    sym, price, ts = cols["symbol"], cols["price"], cols["ts"]
    order = np.argsort(sym, kind="stable")
    cuts = np.flatnonzero(np.diff(sym[order])) + 1
    out = []
    for rows in np.split(order, cuts):
        p, t = price[rows].tolist(), ts[rows].tolist()
        n, i = len(rows), 0
        while i < n:
            best, j = None, i + 1
            while j < n and p[j] < p[i] and t[j] - t[i] <= within_ms:
                r = j + 1
                if r < n and t[r] - t[i] <= within_ms and p[r] > p[j]:
                    best = r
                j += 1
            if best is None:
                i += 1
                continue
            out.append((int(sym[rows[0]]), p[i], p[best - 1], p[best]))
            i = best + 1
    return sorted(out)


def mr_groups(matches: list) -> dict:
    """symbol -> (matches, lowest bottom, highest end) of the oracle."""
    out: dict = {}
    for s, _a, low, high in matches:
        n, lo, hi = out.get(s, (0, low, high))
        out[s] = (n + 1, min(lo, low), max(hi, high))
    return out


def patterns_env(torch, dev, batch: int, **settings):
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration

    return StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": batch,
                       "pipeline.auto-watermark-interval": 0,
                       **settings}), device=dev)


def mr_t_env(torch, dev, c: dict):
    """A TableEnvironment with (a)'s ticks as the view ``ticks`` (a host
    source, event time on ts)."""
    from flink_tpu_torch.core import Schema, WatermarkStrategy
    from flink_tpu_torch.sql import TableEnvironment

    env = patterns_env(torch, dev, c["batch"])
    t_env = TableEnvironment(env)
    schema = Schema(list(TICK_FIELDS))
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    t_env.create_temporary_view("ticks", env.datagen(
        mr_ticks(c), schema, count=c["ticks"], timestamp_column="ts",
        watermark_strategy=ws), schema)
    return env, t_env


def op_task_cpu(job, kind: str) -> float:
    """CPU seconds of the tasks whose chains hold an operator of class
    ``kind``."""
    return sum(t.cpu_s for t in job.tasks.values()
               if t.chain is not None
               and any(type(op).__name__ == kind
                       for op in t.chain.operators))


def pattern_record(torch, job, rows: int, kind: str, launches: dict,
                   start: dict) -> dict:
    return {"wall_s": job.wall_s, "rows_per_sec": rows / job.wall_s,
            "operator_task_cpu_s": op_task_cpu(job, kind),
            "launches": {k: launches.get(k, 0)
                         for k in ("ingest_step", "hist256", "hash_probe",
                                   *(f"group_agg_{s}" for s in GAGG_STAGES))},
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "memory_at_start": start, "tasks": task_record(job)}


def mr_doc_forms(torch, dev, c: dict) -> dict:
    """Each documented form the port does not take, with its error: each
    runs on 256 ticks of 4 symbols, and must fail."""
    out = {}
    for name, (old, new) in MR_DOC_FORMS.items():
        # a fresh environment each: a failed job leaves its sink behind
        _env, t_env = mr_t_env(torch, dev, dict(c, ticks=256, symbols=4,
                                                batch=256))
        try:
            rows = t_env.execute_sql(MR_MATCHES_SQL.replace(old, new),
                                     timeout=PATTERN_TIMEOUT_S).collect()
        except Exception as e:  # noqa: BLE001 - the refusal is the record
            out[name] = f"{type(e).__name__}: {e}"
            continue
        raise AssertionError(f"(a): the documented form {name} now runs "
                             f"({len(rows)} rows); take it off the list")
    return out


def patterns_mr(torch, dev, c: dict | None = None) -> dict:
    """(a): the clause alone (every match against the scan), then under
    the device GROUP BY (every group against the scan's)."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    c = dict(PATTERNS["mr"], **(c or {}))
    expected = mr_scan(c)
    env, t_env = mr_t_env(torch, dev, c)
    start = fresh_memory(torch)
    reset_launches()
    res = t_env.execute_sql(MR_MATCHES_SQL, timeout=PATTERN_TIMEOUT_S)
    clause = pattern_record(torch, env.last_job, c["ticks"], "CepOperator",
                            dict(KERNEL_LAUNCHES), start)
    got = sorted((int(s), int(a), int(b), int(e))
                 for s, a, b, e in res.collect_final())
    if got != expected:
        raise AssertionError(f"(a): {len(got)} matches, {len(expected)} "
                             "by the scan, or they differ")
    start = fresh_memory(torch)
    reset_launches()
    res = t_env.execute_sql(MR_GROUP_SQL, timeout=PATTERN_TIMEOUT_S)
    job = env.last_job
    launches = dict(KERNEL_LAUNCHES)
    grouped = pattern_record(torch, job, c["ticks"], "CepOperator",
                             launches, start)
    groups = {int(s): (int(n), int(lo), int(hi))
              for s, n, lo, hi in res.collect_final()}
    if groups != mr_groups(expected):
        raise AssertionError(f"(a) GROUP BY: {len(groups)} groups, or they "
                             "differ from the scan's")
    if dev.type == "cuda" and not launches["group_agg_first"]:
        raise AssertionError(f"(a): the GROUP BY left the card: {launches}")
    forms = mr_doc_forms(torch, dev, c)
    return {"ticks": c["ticks"], "symbols": c["symbols"],
            "matches": len(expected), "groups": len(groups),
            "clause": clause, "group_by": grouped,
            "documented_forms_refused": forms}


# -- (b) DataStream CEP into the window --------------------------------------
def cep_bid_gen(c: dict, torch=None):
    """bench.py's bid stream at (b)'s size: the auction by the MULT
    mixer, price index % 997 + 1, bidder index % bidders, ts index *
    span // bids; on torch indices (a device source) when ``torch`` is
    given, else numpy."""
    n = c["bids"]

    def gen(idx):
        keys = (mixed_keys(idx, c["auctions"]) if torch is not None
                else bid_keys(idx, c["auctions"]))
        return {"auction": keys, "price": idx % 997 + 1,
                "bidder": idx % c["bidders"],
                "ts": (idx * c["span_ms"]) // n}

    return gen


def cep_higher(event: dict, history: dict) -> bool:
    return event["price"] > history["first"][0]["price"]


def cep_pattern(Pattern, within_ms: int = 10_000):
    """A bid followed by a higher bid of the same bidder, within 10 s."""
    return (Pattern.begin("first").followed_by("higher")
            .where_with_history(cep_higher).within(within_ms))


def cep_select(match) -> tuple:
    h = match["higher"][0]
    return (h["auction"], h["price"], h["ts"])


def cep_matches_expected(c: dict) -> np.ndarray:
    """The oracle of (b)'s matches, a scan of each bidder's bids: a start
    at every bid, dropped past ``within``; the first bid above a live
    start matches the earliest such start, and SKIP_PAST_LAST_EVENT then
    drops every start (the new bid's too). Rows [auction, price, ts]."""
    cols = cep_bid_gen(c)(np.arange(c["bids"], dtype=np.int64))
    price, ts = cols["price"].tolist(), cols["ts"].tolist()
    order = np.argsort(cols["bidder"], kind="stable")
    cuts = np.flatnonzero(np.diff(cols["bidder"][order])) + 1
    hits = []
    for rows in np.split(order, cuts):
        live: list = []
        for i in rows.tolist():
            live = [s for s in live if ts[i] - ts[s] <= c["within_ms"]]
            if any(price[i] > price[s] for s in live):
                hits.append(i)
                live = []
            else:
                live.append(i)
    hits = np.sort(np.asarray(hits, np.int64))
    return np.stack([cols["auction"][hits], cols["price"][hits],
                     cols["ts"][hits]], axis=1)


def windows_expected(keys: np.ndarray, values: np.ndarray, ts: np.ndarray,
                     n_keys: int, topk: int,
                     window_panes: int = WINDOW_PANES) -> list:
    """``q5_expected``'s oracle for any rows: count and sum of ``values``
    by key in every sliding window, in ``q5_check``'s form."""
    order = np.argsort(ts, kind="stable")
    keys, values = keys[order], values[order]
    panes = ts[order] // PANE_MS
    first, n_p = int(panes[0]), int(panes[-1]) + 1
    bounds = np.searchsorted(panes, np.arange(n_p + 1))
    c = np.zeros(n_keys, np.int64)
    r = np.zeros(n_keys, np.int64)
    out = []
    for p_end in range(first + 1, n_p + window_panes):
        for p, sign in ((p_end - 1, 1), (p_end - 1 - window_panes, -1)):
            if first <= p < n_p:
                a, b = bounds[p], bounds[p + 1]
                c += sign * np.bincount(keys[a:b], minlength=n_keys)
                r += sign * np.bincount(keys[a:b], weights=values[a:b],
                                        minlength=n_keys).astype(np.int64)
        kk = min(topk, int((c > 0).sum()))
        if not kk:
            continue
        want = -np.sort(-np.partition(c, len(c) - kk)[len(c) - kk:])
        cand = np.flatnonzero(c >= want[-1])
        out.append((p_end, want, cand, c[cand], r[cand],
                    set(np.flatnonzero(c > want[-1]).tolist())))
    return out


def cep_windows_expected(c: dict) -> list:
    m = cep_matches_expected(c)
    return windows_expected(m[:, 0], m[:, 1], m[:, 2], c["auctions"],
                            c["topk"])


def window_stage(torch, dev, stream, c: dict, value: str, capacity: int,
                 sink):
    """The card (a map to device batches), key_by auction, Q5's sliding
    window (W = 5) of count and sum(``value``), top ``topk``."""
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import SlidingEventTimeWindows

    (card_stage(torch, dev)(stream)
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS))
        .device_aggregate([AggSpec("count", out_name="bids", value_bits=31),
                           AggSpec("sum", value, out_name="revenue")],
                          capacity=capacity, ring_size=RING,
                          emit_window_bounds=False, emit_topk=c["topk"],
                          defer_overflow=True, async_fire=True)
        .add_sink(sink))


def collect_windows(got: list):
    def collect(b):
        got.append((int(b.timestamps[0]), b.column("auction"),
                    b.column("bids"), b.column("revenue")))
    return collect


def cep_env(torch, dev, c: dict, sink=None, rate=None):
    """(b): the bid stream (a device source) -> CEP by bidder -> the card
    -> Q5's window of the matches by auction; returns (env, got,
    matches), ``matches`` counting the select calls."""
    from flink_tpu_torch.cep import CEP, SKIP_PAST_LAST_EVENT, Pattern
    from flink_tpu_torch.core import Schema, WatermarkStrategy

    env = patterns_env(torch, dev, c["batch"])
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    bids = env.datagen(cep_bid_gen(c, torch), Schema(list(CEP_BID_FIELDS)),
                       count=c["bids"], rate_per_sec=rate,
                       timestamp_column="ts", watermark_strategy=ws,
                       device=True)
    matches = [0]

    def select(m):
        matches[0] += 1
        return cep_select(m)

    out = CEP.pattern(bids, cep_pattern(Pattern, c["within_ms"]),
                      key="bidder") \
        .with_skip_strategy(SKIP_PAST_LAST_EVENT) \
        .select(select, Schema(list(CEP_MATCH_FIELDS)))
    got: list = []
    window_stage(torch, dev, out, c, "price", c["capacity"],
                 collect_windows(got) if sink is None else sink)
    return env, got, matches


def cep_run(torch, dev, c: dict) -> dict:
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    env, got, matches = cep_env(torch, dev, c)
    start = fresh_memory(torch)
    reset_launches()
    job = env.execute("cep-b")
    rec = pattern_record(torch, job, c["bids"], "CepOperator",
                         dict(KERNEL_LAUNCHES), start)
    return {**rec, "got": got, "matches": matches[0]}


def checkpointed_run(torch, dev, make_env, records: int, expected: list,
                     extra=None, trigger=None) -> dict:
    """A job into a transactional sink, one checkpoint once its sources
    read ``records`` (``trigger(job, coordinator, records)``, by default
    ``checkpoint_at``), a cancel after the checkpoint committed, then a
    fresh job restored from it: the windows committed before the cancel
    and those after the restore are every window once.
    ``make_env(sink, paced) -> env``; ``extra(checkpoint)`` adds to the
    record."""
    from flink_tpu_torch.connectors.core import TransactionalCollectSink

    fresh_memory(torch)
    tx = TransactionalCollectSink()
    sink = commit_watch(tx)
    job = make_env(sink, True).execute_async("checkpointed")
    coordinator = manual_coordinator(job)
    t0 = time.perf_counter()
    cp = (trigger or checkpoint_at)(job, coordinator, records)
    ckpt_s = time.perf_counter() - t0
    sink.wait_commit(cp.checkpoint_id)
    job.cancel()
    before = q5_rows(tx.batches)
    job.release()
    fresh_memory(torch)
    got: list = []
    env2 = make_env(collect_windows(got), False)
    env2.restore_from_checkpoint(cp)
    job2 = env2.execute("restored")
    restored_s = job2.wall_s
    counts = disjoint_windows(expected, [before, got])
    if not all(counts):
        raise AssertionError(f"windows before the cancel and after the "
                             f"restore {counts}; one side empty")
    job2.release()
    return {"checkpoint_s": ckpt_s, "snapshot_bytes":
            coordinator.stats[-1]["bytes"],
            "windows_before_cancel": counts[0],
            "windows_after_restore": counts[1], "windows_repeated": 0,
            "restored_run_s": restored_s,
            **(extra(cp) if extra is not None else {})}


def patterns_cep(torch, dev, c: dict | None = None) -> dict:
    """(b): a timed run, every window against the oracle, the matches
    counted; then a checkpoint in the middle, a cancel and a restore."""
    c = dict(PATTERNS["cep"], **(c or {}))
    expected = cep_windows_expected(c)
    run = cep_run(torch, dev, c)
    windows = q5_check(expected, run.pop("got"))
    launches = run["launches"]
    want = len(cep_matches_expected(c))
    if run["matches"] != want:
        raise AssertionError(f"(b): {run['matches']} matches, {want} by "
                             "the scan")
    if dev.type == "cuda" and not (launches["ingest_step"]
                                   and launches["hist256"]):
        raise AssertionError(f"(b): launches {launches}")

    def make_env(sink, paced):
        rate = c["bids"] / c["paced_s"] if paced else None
        return cep_env(torch, dev, c, sink=sink, rate=rate)[0]

    restore = checkpointed_run(torch, dev, make_env, c["bids"] // 4,
                               expected)
    return {"bids": c["bids"], "bidders": c["bidders"],
            "auctions": c["auctions"], "matches": want, "windows": windows,
            **run, "restore": restore}


# -- (c) broadcast state: dynamic rules ---------------------------------------
def bcast_rules(c: dict):
    """The rule stream on numpy indices, paced as the bids: row i gives
    bucket i % buckets the threshold of the version in force at its ts
    (``changes`` new versions at equal steps of the span), so a bucket's
    threshold changes at its first row of a new version."""
    n, span = c["bids"], c["span_ms"]

    def gen(idx):
        ts = (idx * span) // n
        bucket = idx % c["buckets"]
        version = ts * (c["changes"] + 1) // span
        return {"bucket": bucket, "threshold": (bucket * 37 + version * 211)
                % 900 + 50, "eff": ts}

    return gen


def bcast_versions(c: dict) -> dict:
    """bucket -> [(ts from which, threshold)]: where each rule row changed
    its bucket's threshold."""
    rules = bcast_rules(c)(np.arange(c["bids"], dtype=np.int64))
    out: dict = {}
    for b, thr, eff in zip(rules["bucket"].tolist(),
                           rules["threshold"].tolist(),
                           rules["eff"].tolist()):
        v = out.setdefault(b, [])
        if not v or v[-1][1] != thr:
            v.append((eff, thr))
    return out


def bcast_bids(c: dict):
    n = c["bids"]

    def gen(idx):
        return {"auction": bid_keys(idx, c["auctions"]),
                "price": idx % 997 + 1, "ts": (idx * c["span_ms"]) // n}

    return gen


def bcast_expected(c: dict) -> list:
    """Each bid over its bucket's threshold in force at its ts (none
    before the bucket's first rule), with its auction's running count of
    alerts (ts order)."""
    versions = bcast_versions(c)
    cols = bcast_bids(c)(np.arange(c["bids"], dtype=np.int64))
    counts: dict = {}
    out = []
    for a, p, t in zip(cols["auction"].tolist(), cols["price"].tolist(),
                       cols["ts"].tolist()):
        thr = [v for eff, v in versions[a % c["buckets"]] if eff <= t]
        if thr and p > thr[-1]:
            counts[a] = counts.get(a, 0) + 1
            out.append((a, p, t, counts[a]))
    return sorted(out)


def bcast_function(c: dict):
    """Flink's dynamic-rules pattern at event time: thresholds by bucket
    ride the broadcast side into a map of versions; each bid waits in
    keyed list state for the watermark (an event-time timer at its ts),
    then is held against the threshold in force at its ts, and a keyed
    count numbers its auction's alerts."""
    from flink_tpu_torch.core.functions import KeyedBroadcastProcessFunction
    from flink_tpu_torch.state.descriptors import ListStateDescriptor, \
        MapStateDescriptor, ValueStateDescriptor

    rules = MapStateDescriptor("thresholds")
    buckets = c["buckets"]

    class ThresholdAlerts(KeyedBroadcastProcessFunction):
        def open(self, ctx):
            self._ctx = ctx
            self._pending = ListStateDescriptor("pending")
            self._alerts = ValueStateDescriptor("alerts", default=0)

        def process_element(self, value, ctx, out):
            self._ctx.get_state(self._pending).add(value)
            ctx.timer_service.register_event_time_timer(ctx.timestamp)

        def process_broadcast_element(self, value, ctx, out):
            bucket, thr, eff = (int(v) for v in value)
            versions = ctx.get_broadcast_state(rules)
            held = versions.get(bucket, ())
            if not held or held[-1][1] != thr:
                versions[bucket] = held + ((eff, thr),)

        def on_timer(self, timestamp, ctx, out):
            pending = self._ctx.get_state(self._pending)
            rows = list(pending.get() or [])
            due = sorted((r for r in rows if r[2] <= timestamp),
                         key=lambda r: r[2])
            pending.update([r for r in rows if r[2] > timestamp])
            versions = ctx.get_broadcast_state(rules)
            count = self._ctx.get_state(self._alerts)
            for a, p, t in due:
                thr = [v for eff, v in versions.get(a % buckets, ())
                       if eff <= t]
                if thr and p > thr[-1]:
                    count.update(count.value() + 1)
                    out.collect((a, p, t, count.value()), t)

    return ThresholdAlerts(), rules


def bcast_env(torch, dev, c: dict, sink, rate=None):
    from flink_tpu_torch.core import Schema, WatermarkStrategy

    env = patterns_env(torch, dev, c["batch"],
                       **{"state.backend.type": "hashmap"})
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    fn, desc = bcast_function(c)
    rules = env.datagen(
        bcast_rules(c), Schema([("bucket", np.int64),
                                ("threshold", np.int64), ("eff", np.int64)]),
        count=c["bids"], rate_per_sec=rate, timestamp_column="eff",
        watermark_strategy=WatermarkStrategy.for_monotonous_timestamps()
        .with_timestamp_column("eff"))
    bids = env.datagen(bcast_bids(c), Schema(list(Q5_FIELDS)),
                       count=c["bids"], rate_per_sec=rate,
                       timestamp_column="ts", watermark_strategy=ws)
    (bids.key_by("auction").connect(rules.broadcast(desc))
        .process(fn, out_schema=Schema([("auction", np.int64),
                                        ("price", np.int64),
                                        ("ts", np.int64),
                                        ("alerts", np.int64)]),
                 parallelism=c["parallelism"])
        .add_sink(sink, parallelism=1))
    return env


def patterns_broadcast(torch, dev, c: dict | None = None) -> dict:
    """(c): a run at parallelism 2 against the oracle; then a checkpoint,
    a cancel and a restore: the rows committed before and those after
    are the oracle's, once."""
    from flink_tpu_torch.connectors.core import TransactionalCollectSink

    c = dict(PATTERNS["broadcast"], **(c or {}))
    expected = bcast_expected(c)
    rows: list = []
    env = bcast_env(torch, dev, c, lambda b: rows.extend(b.iter_rows()))
    start = fresh_memory(torch)
    job = env.execute("broadcast-c")
    rec = pattern_record(torch, job, c["bids"], "CoBroadcastWithKeyedOperator",
                         {}, start)
    if sorted(rows) != expected:
        raise AssertionError(f"(c): {len(rows)} alerts, {len(expected)} "
                             "expected, or they differ")
    fresh_memory(torch)
    tx = TransactionalCollectSink()
    sink = commit_watch(tx)
    job = bcast_env(torch, dev, c, sink,
                    rate=c["bids"] / c["paced_s"]).execute_async("bc-ckpt")
    coordinator = manual_coordinator(job)
    cp = checkpoint_at(job, coordinator, c["bids"] // 2)
    sink.wait_commit(cp.checkpoint_id)
    job.cancel()
    before = tx.rows
    job.release()
    after: list = []
    env2 = bcast_env(torch, dev, c, lambda b: after.extend(b.iter_rows()))
    env2.restore_from_checkpoint(cp)
    env2.execute("bc-restored")
    if sorted(before + after) != expected or not before or not after:
        raise AssertionError(f"(c) restore: {len(before)} alerts before the "
                             f"cancel, {len(after)} after, {len(expected)} "
                             "expected once")
    return {"bids": c["bids"], "auctions": c["auctions"],
            "rule_changes": c["changes"],
            "threshold_changes": sum(len(v) - 1
                                     for v in bcast_versions(c).values()),
            "alerts": len(expected),
            "parallelism": c["parallelism"], **rec,
            "restore": {"alerts_before_cancel": len(before),
                        "alerts_after_restore": len(after)}}


# -- (d) async enrichment -------------------------------------------------
#: the injected timeout, shared by the function's copies: ``armed``
#: hangs the next row offered (its first attempt never answers, so its
#: timeout retries it); then ``row`` is that row and ``attempts`` counts
#: its attempts
ASYNC_HANG: dict = {}


def async_category(auction):
    """The lookup's answer: a category of 16 by a hash of the auction."""
    return (auction * 0x9E3779B1 >> 16) % 16


def async_function(c: dict):
    """A thread-pool lookup of about ``lookup_s`` a call, with the
    injected timeout of ``ASYNC_HANG``."""
    from concurrent.futures import Future, ThreadPoolExecutor

    from flink_tpu_torch.runtime.operators.async_io import AsyncFunction

    class Enrich(AsyncFunction):
        def open(self):
            self.pool = ThreadPoolExecutor(c["threads"])

        def async_invoke(self, row, ts):
            hang = ASYNC_HANG
            if hang.get("armed"):
                hang.update(armed=False, row=row, attempts=1)
                return Future()
            if row == hang.get("row"):
                hang["attempts"] += 1

            def lookup():
                time.sleep(c["lookup_s"])
                return (*row, async_category(row[0]))

            return self.pool.submit(lookup)

        def close(self):
            self.pool.shutdown(wait=False)

    return Enrich()


def async_span(c: dict) -> int:
    return q5_panes(c["bids"], c["batch"]) * PANE_MS


def async_expected(c: dict) -> list:
    idx = np.arange(c["bids"], dtype=np.int64)
    cols = q5_host_gen(c["auctions"], c["bids"], async_span(c))(idx)
    return windows_expected(cols["auction"], async_category(cols["auction"]),
                            cols["ts"], c["auctions"], c["topk"])


def async_env(torch, dev, c: dict, mode: str, sink, timeout_ms: int):
    """(d): Q5's bids (a device source) -> async enrichment -> the card
    -> Q5's window of count and sum(category) by auction, top 100."""
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Schema, WatermarkStrategy
    from flink_tpu_torch.runtime.operators.async_io import RetryPolicy

    # a watermark drains the queue: one every wm_interval_s, not after
    # every batch, lets a barrier find requests in flight
    env = patterns_env(torch, dev, c["batch"], **{
        "pipeline.auto-watermark-interval": c["wm_interval_s"]})
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    source = DataGenSource(q5_gen(c["auctions"], c["bids"], async_span(c)),
                           Schema(list(Q5_FIELDS)), count=c["bids"],
                           timestamp_column="ts", device=True)
    out = env.from_source(source, ws, "DataGen").async_io(
        async_function(c), capacity=c["capacity"],
        timeout_ms=timeout_ms, mode=mode,
        retry=RetryPolicy(max_attempts=3, delay_ms=1), on_timeout="fail",
        out_schema=Schema(list(ENRICHED_FIELDS)))
    window_stage(torch, dev, out, c, "category", c["window_capacity"], sink)
    return env


def patterns_async(torch, dev, c: dict | None = None) -> dict:
    """(d): ordered, with one injected timeout that retries; then
    unordered with a checkpoint while requests are in flight, a cancel
    and a restore (the restored run timed); every window against the
    oracle, once in the two halves."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches

    c = dict(PATTERNS["async"], **(c or {}))
    expected = async_expected(c)
    ASYNC_HANG.clear()
    ASYNC_HANG["armed"] = True      # the first row hangs, then retries
    got: list = []
    env = async_env(torch, dev, c, "ordered", collect_windows(got),
                    c["timeout_ms"])
    start = fresh_memory(torch)
    reset_launches()
    job = env.execute("async-d-ordered")
    ordered = pattern_record(torch, job, c["bids"], "AsyncWaitOperator",
                             dict(KERNEL_LAUNCHES), start)
    windows = q5_check(expected, got)
    hung = ASYNC_HANG.get("attempts", 0)
    if hung != 2:
        raise AssertionError(f"(d): the injected timeout made {hung} "
                             "attempts; one retry expected")
    launches = ordered["launches"]
    if dev.type == "cuda" and not (launches["ingest_step"]
                                   and launches["hist256"]):
        raise AssertionError(f"(d): launches {launches}")

    def make_env(sink, _paced):
        return async_env(torch, dev, c, "unordered", sink,
                         c["ckpt_timeout_ms"])

    def checkpoint_while_hung(job, coordinator, records: int):
        """Once the source read ``records``, after a watermark: hang the
        next row offered, then a checkpoint. The barrier follows that
        row's batch, before the next watermark (the interval is longer
        than a batch) and before its timeout, so the row is in flight."""
        (src,) = job.source_tasks.values()
        while src.records_in < records and not job._done.is_set():
            time.sleep(0.001)
        wms = src.watermarks_out
        while src.watermarks_out == wms and not job._done.is_set():
            time.sleep(0.0005)
        ASYNC_HANG.clear()
        ASYNC_HANG["armed"] = True
        while "row" not in ASYNC_HANG and not job._done.is_set():
            time.sleep(0.0005)
        return checkpoint_at(job, coordinator, 0)

    def in_flight(cp) -> dict:
        pending, read = [], 0
        for snap in cp.task_snapshots.values():
            reader = snap.get("reader")
            if reader is not None:   # a device datagen reader's position
                read += reader["next"]
            for key, op in (snap.get("chain") or {}).items():
                if key.endswith(":AsyncIO"):
                    pending += (op.get("operator") or {}).get("pending", [])
        return {"in_flight_at_checkpoint": len(pending),
                "hung_row_in_flight": any(tuple(row) == ASYNC_HANG["row"]
                                          for row, _ts in pending),
                "read_at_checkpoint": read}

    restore = checkpointed_run(torch, dev, make_env, c["bids"] // 2,
                               expected, in_flight, checkpoint_while_hung)
    if not restore["hung_row_in_flight"]:
        raise AssertionError("(d): the hung request was not in flight at "
                             f"the checkpoint: {restore}")
    rest = c["bids"] - restore["read_at_checkpoint"]
    return {"bids": c["bids"], "auctions": c["auctions"],
            "capacity": c["capacity"], "windows": windows,
            "injected_attempts": hung, "ordered": ordered,
            "unordered_restored": {
                "rows": rest, "wall_s": restore["restored_run_s"],
                "rows_per_sec": rest / restore["restored_run_s"]},
            "restore": restore}


# -- (e) the SQL gateway --------------------------------------------------
def gateway_ddl(c: dict) -> list:
    """(e)'s tables on the datagen connector: ticks with event time on ts
    (one a ms) for (a)'s query, bids for Q17's aggregates."""
    return [
        "CREATE TABLE ticks (symbol BIGINT, price BIGINT, ts BIGINT, "
        "WATERMARK FOR ts AS ts - INTERVAL '0' SECOND) WITH ("
        f"'connector' = 'datagen', 'number-of-rows' = '{c['ticks']}', "
        "'fields.symbol.kind' = 'random', 'fields.symbol.min' = '0', "
        f"'fields.symbol.max' = '{c['symbols'] - 1}', "
        "'fields.price.kind' = 'random', 'fields.price.min' = '1', "
        "'fields.price.max' = '1000')",
        "CREATE TABLE bids (auction BIGINT, price BIGINT, ts BIGINT) WITH ("
        f"'connector' = 'datagen', 'number-of-rows' = '{c['bids']}', "
        "'fields.auction.kind' = 'random', 'fields.auction.min' = '0', "
        f"'fields.auction.max' = '{c['auctions'] - 1}', "
        "'fields.price.kind' = 'random', 'fields.price.min' = '1', "
        "'fields.price.max' = '1000')"]


def http_json(port: int, method: str, path: str, body=None):
    """One call to a gateway on loopback: (status, JSON body)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=PATTERN_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def patterns_gateway(torch, dev, c: dict | None = None) -> dict:
    """(e): the gateway on loopback, port 0: a session, the DDL, (a)'s
    GROUP BY and Q17's device GROUP BY over HTTP, a bad statement (400,
    the session survives), the session closed; the rows equal a
    TableEnvironment's on the same device."""
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.sql import TableEnvironment
    from flink_tpu_torch.sql.gateway import SqlGateway, _json_safe

    c = dict(PATTERNS["gateway"], **(c or {}))
    sql = {"mr_group_by": MR_GROUP_SQL, "q17": Q17_SQL}
    gw = SqlGateway(port=0, device=dev)
    port = gw.start()
    t0 = time.perf_counter()
    try:
        code, out = http_json(port, "POST", "/v1/sessions")
        sid = out["session_id"]
        for stmt in gateway_ddl(c):
            code, out = http_json(port, "POST",
                                  f"/v1/sessions/{sid}/statements",
                                  {"statement": stmt})
            if code != 200:
                raise AssertionError(f"(e) DDL: {code} {out}")
        http_rows, seconds, launches = {}, {}, {}
        for name, q in sql.items():
            reset_launches()
            t1 = time.perf_counter()
            code, out = http_json(port, "POST",
                                  f"/v1/sessions/{sid}/statements",
                                  {"statement": q})
            seconds[name] = time.perf_counter() - t1
            launches[name] = {k: v for k, v in KERNEL_LAUNCHES.items() if v}
            if code != 200:
                raise AssertionError(f"(e) {name}: {code} {out}")
            http_rows[name] = sorted(out["rows"])
        bad = http_json(port, "POST", f"/v1/sessions/{sid}/statements",
                        {"statement": "SELEC nope"})
        alive = http_json(port, "POST", f"/v1/sessions/{sid}/statements",
                          {"statement": "SHOW TABLES"})
        if bad[0] != 400 or alive[0] != 200:
            raise AssertionError(f"(e): a bad statement gave {bad}, the "
                                 f"next {alive}")
        closed = http_json(port, "DELETE", f"/v1/sessions/{sid}")[0]
        gone = http_json(port, "GET", f"/v1/sessions/{sid}")[0]
        if (closed, gone) != (200, 404):
            raise AssertionError(f"(e): close gave {closed}, then {gone}")
    finally:
        gw.stop()
    wall = time.perf_counter() - t0
    t_env = TableEnvironment(patterns_env(torch, dev, c["batch"]))
    for stmt in gateway_ddl(c):
        t_env.execute_sql(stmt)
    direct = {name: sorted([_json_safe(v) for v in r]
                           for r in t_env.execute_sql(q).collect_final())
              for name, q in sql.items()}
    if direct != http_rows or not all(http_rows.values()):
        raise AssertionError("(e): the rows over HTTP differ from the "
                             "TableEnvironment's")
    if dev.type == "cuda" and not launches["q17"].get("group_agg_first"):
        raise AssertionError(f"(e): Q17 left the card: {launches['q17']}")
    return {"ticks": c["ticks"], "bids": c["bids"],
            "groups": {k: len(v) for k, v in http_rows.items()},
            "statement_s": seconds, "wall_s": wall,
            "rows_per_sec": {"mr_group_by": c["ticks"]
                             / seconds["mr_group_by"],
                             "q17": c["bids"] / seconds["q17"]},
            "launches": launches, "bad_statement": bad[0]}


def patterns_phase(torch, dev, sizes: dict | None = None) -> dict:
    """CEP, MATCH_RECOGNIZE, broadcast state, async I/O and the SQL
    gateway on the card: (a) to (e), the seconds of each. ``sizes``:
    each part's configuration overrides (a rehearsal on the CPU)."""
    out, seconds = {}, {}
    for name, fn in (("mr", patterns_mr), ("cep", patterns_cep),
                     ("broadcast", patterns_broadcast),
                     ("async", patterns_async),
                     ("gateway", patterns_gateway)):
        t0 = time.perf_counter()
        out[name] = fn(torch, dev, (sizes or {}).get(name))
        seconds[name] = time.perf_counter() - t0
        emit({f"patterns_{name}": out[name]})
    out["seconds"] = seconds
    return out


# -- the task runtime and state I/O (runtime_io) -------------------------------
#: (a) Q5-10M's stream from two sources (the even and the odd indices,
#: the strided split of two source subtasks) into one window task,
#: unfused. The paced one reads nothing until the checkpoint, then
#: spreads its share over RIO_PACED_S seconds, so its channel is empty
#: and its barrier reaches the gate first (paced from the deploy at that
#: rate, it kept up with the other on the card, and both queues held
#: ten batches: nothing was captured). The unpaced one holds the window
#: task RIO_HOLD_S seconds through its mailbox at its RIO_HOLD_BATCH-th
#: batch (a window busy with a fire or a snapshot) and triggers the
#: checkpoint at its RIO_TRIGGER_BATCH-th, so the batches between queue
#: ahead of its barrier
RIO_PACED_S, RIO_HOLD_BATCH, RIO_TRIGGER_BATCH, RIO_HOLD_S = \
    1.5, 2, 12, 0.1
#: (b) the alignment group's drift (2 panes) and the latency markers'
#: interval; two sources of the strided halves, the slow one paced over
#: RIO_SKEW_S seconds and the fast one RIO_SKEW times its rate, so the
#: fast one's event time runs RIO_SKEW times as fast (unpaced, with 4
#: times the event time a record, the first source of two fell behind the
#: other on the card and the slow one paused instead)
RIO_DRIFT_MS, RIO_MARKER_S, RIO_SKEW, RIO_SKEW_S = 4000, 0.01, 4, 2.0
#: (c) the keyed_process job on the changelog and hashmap backends: bids,
#: auctions, checkpoint interval, the paced run's seconds
RIO_KP_BIDS, RIO_KP_AUCTIONS, RIO_CKPT_S, RIO_KP_PACED_S = \
    1 << 13, 1 << 12, 0.2, 1.2
#: (d) the Collatz-style loop: seeds (host batches) and the head's wait
RIO_SEEDS, RIO_LOOP_WAIT_S = 1 << 14, 0.5
RIO_TIMEOUT_S = 300


def rio_q5_config(**overrides) -> dict:
    """(a) and (b)'s configuration: Q5-10M (bench.py:315-414) unless a
    rehearsal shrinks it."""
    _label, keys, events, capacity = Q5_CELLS[1]
    c = {"keys": keys, "events": events, "capacity": capacity,
         "batch": BATCH, "topk": TOPK, "paced_s": RIO_PACED_S,
         "hold_batch": RIO_HOLD_BATCH, "trigger_batch": RIO_TRIGGER_BATCH,
         "hold_s": RIO_HOLD_S}
    c.update(overrides)
    c["span"] = q5_panes(c["events"], c["batch"]) * PANE_MS
    return c


def rio_sources(env, c: dict, parts, ws):
    """One device datagen source per ``(name, index_of, count, rate,
    on_batch)``: its i-th record is the Q5 stream's record
    ``index_of(i)``, and ``on_batch()`` runs after each batch it makes;
    returns their union and the (name, source) pairs."""
    from flink_tpu_torch.connectors.datagen import DataGenSource
    from flink_tpu_torch.core import Schema

    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    q5 = q5_gen(c["keys"], c["events"], c["span"])
    streams, made = [], []
    for name, index_of, count, rate, on_batch in parts:
        def gen(idx, index_of=index_of, on_batch=on_batch):
            cols = q5(index_of(idx))
            if on_batch is not None and idx.numel() > 2:
                on_batch()      # not the 2-index event-time bound probe
            return cols

        src = DataGenSource(gen, schema, count=count, rate_per_sec=rate,
                            timestamp_column="ts", device=True)
        made.append((name, src))
        streams.append(env.from_source(src, ws, name))
    return streams[0].union(*streams[1:]), made


def rio_window(stream, c: dict, sink):
    """Q5's window (W = 5, ring 16, count and revenue, top k) on the
    card, deferred overflow, asynchronous fires, as ``q5_env``'s."""
    from flink_tpu_torch.runtime.operators import AggSpec
    from flink_tpu_torch.window import SlidingEventTimeWindows

    (stream.key_by("auction")
        .window(SlidingEventTimeWindows.of(WINDOW_PANES * PANE_MS, PANE_MS))
        .device_aggregate([AggSpec("count", out_name="bids", value_bits=31),
                           AggSpec("sum", "price", out_name="revenue")],
                          capacity=c["capacity"], ring_size=RING,
                          emit_topk=c["topk"], emit_window_bounds=False,
                          defer_overflow=True, async_fire=True)
        .add_sink(sink))


def rio_env(torch, dev, c: dict, **settings):
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration

    return StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": c["batch"],
        "pipeline.auto-watermark-interval": 0, **settings}), device=dev)


def rio_split_parts(c: dict, paced: bool, on_batch=None):
    """(a)'s two sources: the even indices unpaced (with ``on_batch``),
    the odd ones paused (rate 0) until the checkpoint is triggered, then
    at the rate that spreads them over ``paced_s`` (``rio_pace``; the
    clock starts at the next read, so no backlog of due batches): their
    channel is empty when their barrier goes in."""
    half = c["events"] // 2
    return [("even", lambda i: 2 * i, half, None, on_batch),
            ("odd", lambda i: 2 * i + 1, half, 0.0 if paced else None,
             None)]


def rio_pace(sources: list, c: dict) -> None:
    (odd,) = [s for name, s in sources if name == "odd"]
    odd.set_rate(c["events"] // 2 / c["paced_s"])


def inflight_bytes(batches: list) -> int:
    """Bytes of the card tensors of captured device batches (what a
    retained checkpoint holds on the card)."""
    seen: dict = {}
    for b in batches:
        tensors = list(getattr(b, "dcolumns", {}).values())
        if getattr(b, "dtimestamps", None) is not None:
            tensors.append(b.dtimestamps)   # often the ts column itself
        for t in tensors:
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def window_task(job):
    """The task whose chain holds the device window operator."""
    (task,) = [t for t in job.tasks.values()
               if hasattr(t, "gate") and t.chain is not None
               and any(type(o).__name__ == "DeviceWindowAggOperator"
                       for o in t.chain.operators)]
    return task


def rio_checkpointed_run(torch, dev, c: dict, unaligned: bool,
                         ckpt_dir: str | None) -> dict:
    """(a)'s paced job: the unpaced source holds the window task
    ``hold_s`` at its ``hold_batch``-th batch and triggers one checkpoint
    at its ``trigger_batch``-th; a cancel once it committed. Returns the
    record, the completed checkpoint and the committed windows."""
    import threading

    from flink_tpu_torch.connectors.core import TransactionalCollectSink
    from flink_tpu_torch.core import WatermarkStrategy

    holder: dict = {}
    ready = threading.Event()
    made = [0]

    def on_batch():
        made[0] += 1
        if made[0] not in (c["hold_batch"], c["trigger_batch"]):
            return
        if not ready.wait(30):
            raise AssertionError("runtime_io (a): the job never started")
        job = holder["job"]
        gate = window_task(job).gate
        queued = [ch.size() for ch in gate.channels]
        if made[0] == c["hold_batch"]:
            holder["queued_at_hold"] = queued
            window_task(job).execute_in_mailbox(
                lambda: time.sleep(c["hold_s"]))
            return
        holder["queued_at_trigger"] = queued
        holder["paced_read_at_trigger"] = sum(
            t.records_in for t in job.source_tasks.values()
            if t.ctx.task_name == "odd")
        holder["pending"] = job.coordinator.trigger_checkpoint()
        rio_pace(holder["sources"], c)

    tx = TransactionalCollectSink()
    sink = commit_watch(tx)
    settings = {"execution.checkpointing.unaligned": unaligned,
                "execution.checkpointing.interval": 3600.0}
    if ckpt_dir:
        settings["execution.checkpointing.dir"] = ckpt_dir
    env = rio_env(torch, dev, c, **settings)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    stream, holder["sources"] = rio_sources(
        env, c, rio_split_parts(c, True, on_batch), ws)
    rio_window(stream, c, sink)
    start = fresh_memory(torch)
    job = env.execute_async("runtime-io-a")
    holder["job"] = job
    ready.set()
    t0 = time.perf_counter()
    while "pending" not in holder:
        if job._done.is_set() or time.perf_counter() - t0 > RIO_TIMEOUT_S:
            raise AssertionError(f"runtime_io (a): no checkpoint was "
                                 f"triggered ({made[0]} batches, "
                                 f"{job._failed})")
        time.sleep(0.001)
    pending = holder["pending"]
    if not pending.done.wait(RIO_TIMEOUT_S) or pending.completed is None:
        raise AssertionError(f"runtime_io (a): checkpoint "
                             f"{pending.checkpoint_id} did not complete "
                             f"({job._failed})")
    cp = pending.completed
    sink.wait_commit(cp.checkpoint_id)
    job.cancel()
    stats = job.coordinator.stats[-1]
    wid = window_task(job).task_id
    inflight = cp.task_snapshots[wid].get("inflight", [])
    record = {"unaligned": unaligned,
              "barrier_to_ack_s": stats["barrier_to_ack_s"],
              "window_barrier_to_ack_s": stats["barrier_to_ack_s"][wid],
              "checkpoint_s": stats["duration_s"],
              "store_s": stats["store_s"],
              "bytes_written": stats["bytes_written"],
              "inflight_batches": len(inflight),
              "inflight_rows": sum(b.n for b in inflight),
              "inflight_card_bytes": inflight_bytes(inflight),
              "even_batches_made": made[0],
              "channel_sizes_at_hold": holder.get("queued_at_hold"),
              "channel_sizes_at_trigger": holder.get("queued_at_trigger"),
              "paced_records_at_trigger": holder.get(
                  "paced_read_at_trigger"),
              "memory_at_start": start,
              "peak_bytes": torch.cuda.max_memory_allocated()}
    if inflight:
        # the seconds the captured columns take to come home, beside the
        # store's (which copies them home as it pickles them)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in inflight:
            for col in list(b.dcolumns.values()) + [b.dtimestamps]:
                col.cpu()
        record["home_s"] = time.perf_counter() - t1
    before = q5_rows(tx.batches)
    job.release()
    return {"record": record, "checkpoint": cp, "before": before}


def rio_unaligned(torch, dev, c: dict | None = None) -> dict:
    """(a) An unaligned checkpoint of Q5-10M on the card against the same
    paced job aligned, then a cancel and a restore of the unaligned one
    from fs storage: the in-flight batches replay before new input and
    every window equals the oracle (under the tie rule)."""
    import shutil
    import tempfile

    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.core import WatermarkStrategy

    c = rio_q5_config(**(c or {}))
    expected = q5_expected(c["keys"], c["events"], c["span"], c["topk"])
    ckpt_dir = tempfile.mkdtemp(prefix="flink_tpu_torch_unaligned_")
    try:
        # aligned first: the first snapshot of a process also allocates
        # its pinned host mirror (1.668 s against 0.537 s after, on an H100)
        ali = rio_checkpointed_run(torch, dev, c, False, None)["record"]
        if ali["inflight_batches"]:
            raise AssertionError("runtime_io (a): an aligned checkpoint "
                                 "carried in-flight batches")
        una = rio_checkpointed_run(torch, dev, c, True, ckpt_dir)
        cp = una["checkpoint"]
        if not una["record"]["inflight_batches"]:
            raise AssertionError("runtime_io (a): the unaligned checkpoint "
                                 "captured no in-flight batch: "
                                 f"{una['record']}")
        path = cp.external_path
        del una["checkpoint"], cp
        gc.collect()
        fresh_memory(torch)
        got: list = []
        env = rio_env(torch, dev, c)
        ws = WatermarkStrategy.for_monotonous_timestamps() \
            .with_timestamp_column("ts")
        stream, _ = rio_sources(env, c, rio_split_parts(c, False), ws)
        rio_window(stream, c, collect_windows(got))
        env.restore_from_checkpoint(path)
        reset_launches()
        job = env.execute("runtime-io-a-restored")
        launches = dict(KERNEL_LAUNCHES)
        # the checkpoint comes early (the paced source holds the
        # watermark back), so few windows commit before the cancel; a
        # lost in-flight batch would leave later windows short of the
        # oracle
        counts = disjoint_windows(expected, [una["before"], got])
        restored = {"wall_s": job.wall_s, "windows_before_cancel": counts[0],
                    "windows_after_restore": counts[1],
                    "launches": {k: launches.get(k, 0)
                                 for k in ("ingest_step", "hist256")},
                    "tasks": task_record(job)}
        job.release()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"config": dict(c), "unaligned": una["record"], "aligned": ali,
            "restore_from_fs": restored}


class PaneSpan:
    """Records the widest span of panes the device window's ring held:
    from its first open pane to the newest pane a batch reached, at each
    batch's bookkeeping."""

    def __init__(self):
        self.widest = 0

    @contextlib.contextmanager
    def watching(self):
        from flink_tpu_torch.runtime.operators.device_window import \
            DeviceWindowAggOperator as Op

        inner = Op._device_bookkeeping
        span = self

        def bookkeeping(op, batch):
            out = inner(op, batch)
            hi = (batch.ts_max - op._offset) // op._pane
            lo = (op._fired_boundary - op._window_panes
                  if op._fired_boundary is not None else op._min_seen_pane)
            if lo is not None:
                span.widest = max(span.widest, int(hi - lo + 1))
            return out

        Op._device_bookkeeping = bookkeeping
        try:
            yield self
        finally:
            Op._device_bookkeeping = inner


def rio_skew_parts(c: dict):
    """(b)'s two sources over Q5's stream, the even and the odd indices:
    the slow one spread over ``skew_s`` seconds, the fast one at RIO_SKEW
    times its rate; both paused (rate 0) until ``rio_skew_pace``."""
    half = c["events"] // 2
    return [("fast", lambda i: 2 * i, half, 0.0, None),
            ("slow", lambda i: 2 * i + 1, half, 0.0, None)]


def rio_skew_pace(sources: list, c: dict) -> None:
    rate = c["events"] // 2 / c["skew_s"]
    for name, src in sources:
        src.set_rate(rate * (RIO_SKEW if name == "fast" else 1))


def rio_aligned_run(torch, dev, c: dict, aligned: bool, markers: bool):
    from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
    from flink_tpu_torch.core import WatermarkStrategy
    from flink_tpu_torch.metrics.core import Histogram, MetricRegistry

    settings = {"metrics.latency.interval": RIO_MARKER_S} if markers else {}
    env = rio_env(torch, dev, c, **settings)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    if aligned:
        ws = ws.with_watermark_alignment("bids", RIO_DRIFT_MS)
    got: list = []
    stream, sources = rio_sources(env, c, rio_skew_parts(c), ws)
    rio_window(stream, c, collect_windows(got))
    reg = MetricRegistry()
    span = PaneSpan()
    start = fresh_memory(torch)
    reset_launches()
    with span.watching():
        job = env.execute_async("runtime-io-b", metrics_registry=reg)
        # the readers' clocks start now, not at the deploy
        rio_skew_pace(sources, c)
        job.wait(RIO_TIMEOUT_S)
    launches = dict(KERNEL_LAUNCHES)
    ops = job.operators
    (window,) = [o for o in ops
                 if type(o).__name__ == "DeviceWindowAggOperator"]
    (sink,) = [o for o in ops if "Sink" in type(o).__name__]
    srcs = {t.ctx.task_name: t for t in job.source_tasks.values()}
    hist = [m for scope, m in reg.all_metrics().items()
            if scope[-1] == "latency" and isinstance(m, Histogram)
            and sink._op_key in scope]
    lat = sorted(window.fire_latencies_ms)
    rec = {"wall_s": job.wall_s, "events_per_sec": c["events"] / job.wall_s,
           "widest_pane_span": span.widest, "ring": RING,
           "alignment_pauses": {n: t.alignment_pauses
                                for n, t in srcs.items()},
           "alignment_max_overshoot_ms": {
               n: t.alignment_max_overshoot_ms for n, t in srcs.items()},
           # a batch of either half spans 2 x batch indices of event time
           "batch_event_time_ms": 2 * c["batch"] * c["span"] // c["events"],
           "p99_fire_latency_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))]
           if lat else None,
           "fires": len(lat),
           "launches": {k: launches.get(k, 0)
                        for k in ("ingest_step", "hist256")},
           "memory_at_start": start,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "tasks": task_record(job)}
    if markers:
        (h,) = hist
        rec["latency_markers"] = {
            "sent": sum(t.latency_markers_out for t in srcs.values()),
            "window_saw": window.latency_markers_seen,
            "sink_saw": sink.latency_markers_seen,
            "sink_p50_ms": h.quantile(0.5), "sink_p99_ms": h.quantile(0.99),
            "sink_samples": h.count}
    job.release()
    return rec, got


def rio_alignment(torch, dev, c: dict | None = None) -> dict:
    """(b) Watermark alignment into Q5-10M's window: two sources of one
    group (drift 2 panes), the fast one's event time RIO_SKEW times the
    slow one's; latency markers every RIO_MARKER_S. Every window against
    the oracle; no aligned source past its group's bound by more than one
    of its batches' event time. Then the same job without alignment, for
    the pane span it leaves the ring."""
    c = rio_q5_config(**{"skew_s": RIO_SKEW_S, **(c or {})})
    expected = q5_expected(c["keys"], c["events"], c["span"], c["topk"])
    aligned, got = rio_aligned_run(torch, dev, c, True, True)
    aligned["windows_checked"] = q5_check(expected, got)
    over = max(aligned["alignment_max_overshoot_ms"].values())
    if over > aligned["batch_event_time_ms"] \
            or aligned["alignment_pauses"]["fast"] == 0:
        raise AssertionError(f"runtime_io (b): overshoot {over} ms, pauses "
                             f"{aligned['alignment_pauses']}")
    if aligned["widest_pane_span"] > RING:
        raise AssertionError(f"runtime_io (b): {aligned['widest_pane_span']}"
                             f" panes open in a ring of {RING}")
    lm = aligned["latency_markers"]
    if not (lm["window_saw"] and lm["sink_saw"] and lm["sink_samples"]):
        raise AssertionError(f"runtime_io (b): latency markers {lm}")
    free, got = rio_aligned_run(torch, dev, c, False, False)
    free["windows_checked"] = q5_check(expected, got)
    return {"config": c, "aligned": aligned, "unaligned_sources": free}


def keyed_process_counts(bids: int, auctions: int) -> np.ndarray:
    idx = np.arange(bids, dtype=np.int64)
    return np.bincount(sql_join_random(idx, 0, auctions - 1),
                       minlength=auctions)


def rio_keyed_env(torch, dev, c: dict, backend: str, ckpt_dir: str,
                  paced: bool, interval: float, sink):
    """(c): datastream_core's keyed_process job with a queryable total
    a key."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration, Schema, \
        WatermarkStrategy
    from flink_tpu_torch.core.functions import ProcessFunction
    from flink_tpu_torch.state.descriptors import ValueStateDescriptor

    bids, auctions = c["bids"], c["auctions"]

    class FirstBidTimer(ProcessFunction):
        def open(self, ctx):
            self._ctx = ctx
            self._desc = ValueStateDescriptor("bids", default=0)
            self._total = ValueStateDescriptor(
                "total", default=0).queryable("count")

        def process_element(self, value, ctx, out):
            st = self._ctx.get_state(self._desc)
            n = st.value()
            if n == 0:
                ctx.timer_service.register_event_time_timer(
                    ctx.timestamp + KP_TIMER_MS)
            st.update(n + 1)
            tot = self._ctx.get_state(self._total)
            tot.update(tot.value() + 1)

        def on_timer(self, ts, ctx, out):
            st = self._ctx.get_state(self._desc)
            out.collect((ctx.current_key, int(st.value()), ts), ts)
            st.clear()

    def gen(idx):
        return {"auction": sql_join_random(idx, 0, auctions - 1),
                "ts": (idx * KP_SPAN_MS) // bids}

    env = StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": c["batch"],
        "pipeline.auto-watermark-interval": 0,
        "state.backend.type": backend,
        "execution.checkpointing.interval": interval,
        "execution.checkpointing.dir": ckpt_dir}), device=dev)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    (env.datagen(gen, Schema([("auction", np.int64), ("ts", np.int64)]),
                 count=bids, timestamp_column="ts", watermark_strategy=ws,
                 rate_per_sec=bids / c["paced_s"] if paced else None)
        .key_by("auction").process(FirstBidTimer())
        .add_sink(sink, "rows"))
    return env


def rio_keyed_run(torch, dev, c: dict, backend: str, want: list,
                  totals: np.ndarray) -> dict:
    """(c) on one backend: periodic checkpoints while the paced job runs
    and queryable reads over TCP; after 3 checkpoints the coordinator
    pauses, the last one commits and the job is cancelled; a fresh job
    restored from it (base plus segments on ``changelog``) runs to the
    end. Rows before the cancel and after the restore are the oracle's
    once; the restored job's totals read over TCP equal the oracle."""
    import shutil
    import tempfile

    from flink_tpu_torch.connectors.core import TransactionalCollectSink
    from flink_tpu_torch.state.queryable_net import KvStateServer, \
        RemoteQueryableStateClient

    ckpt_dir = tempfile.mkdtemp(prefix=f"flink_tpu_torch_{backend}_")
    try:
        tx = TransactionalCollectSink()
        sink = commit_watch(tx)
        env = rio_keyed_env(torch, dev, c, backend, ckpt_dir, True,
                            RIO_CKPT_S, sink)
        job = env.execute_async(f"runtime-io-c-{backend}")
        srv = KvStateServer.for_job(job)
        client = RemoteQueryableStateClient(srv.address)
        probe = list(range(0, c["auctions"], max(1, c["auctions"] // 16)))
        reads = {k: [] for k in probe}
        coord = job.coordinator
        t0 = time.perf_counter()
        while len([s for s in coord.stats if not s.get("failed")
                   and not s.get("declined")]) < 3:
            if job._done.is_set() or time.perf_counter() - t0 > \
                    RIO_TIMEOUT_S:
                raise AssertionError(f"runtime_io (c) {backend}: "
                                     f"{coord.stats} ({job._failed})")
            if "count" in client.names():   # registered at first use
                for k in probe:
                    reads[k].append(client.get_kv_state("count", k,
                                                        default=0))
            time.sleep(0.01)
        coord.pause()
        cp = coord.latest_checkpoint()
        sink.wait_commit(cp.checkpoint_id)
        client.close()
        srv.close()
        (op,) = [o for o in job.operators
                 if type(o).__name__ == "KeyedProcessOperator"]
        back = op._backend
        record = {
            "checkpoints": [{k: s.get(k) for k in ("id", "duration_s",
                                                   "store_s", "bytes",
                                                   "bytes_written")}
                            for s in coord.stats],
            "records_in_at_cancel": job.records_in}
        if backend == "changelog":
            record.update(materializations=back.materializations,
                          segments_uploaded=back._writer.segments_uploaded,
                          segment_bytes_uploaded=back.bytes_uploaded,
                          changelog_dir_bytes=sum(
                              os.path.getsize(os.path.join(r, f))
                              for r, _d, fs in os.walk(
                                  os.path.join(ckpt_dir, "changelog"))
                              for f in fs))
        job.cancel()
        if any(v != sorted(v) for v in reads.values()):
            raise AssertionError(f"runtime_io (c) {backend}: a live count "
                                 "read over TCP went down")
        before = tx.rows
        job.release()
        got: list = []
        env2 = rio_keyed_env(torch, dev, c, backend, ckpt_dir, False, 0.0,
                             lambda b: got.extend(b.iter_rows()))
        env2.restore_from_checkpoint(cp.external_path)
        t1 = time.perf_counter()
        job2 = env2.execute(f"runtime-io-c-{backend}-restored")
        restore_s = time.perf_counter() - t1
        if sorted(tuple(r) for r in before + got) != want:
            raise AssertionError(f"runtime_io (c) {backend}: "
                                 f"{len(before)} + {len(got)} rows across "
                                 f"the restore, {len(want)} expected")
        srv = KvStateServer.for_job(job2)
        client = RemoteQueryableStateClient(srv.address)
        try:
            final = [client.get_kv_state("count", k, default=0)
                     for k in range(c["auctions"])]
        finally:
            client.close()
            srv.close()
        if final != totals.tolist():
            raise AssertionError(f"runtime_io (c) {backend}: queryable "
                                 "totals after the restore differ")
        record.update(rows_before_cancel=len(before),
                      rows_after_restore=len(got),
                      live_reads=sum(len(v) for v in reads.values()),
                      restored_run_s=restore_s,
                      restored_wall_s=job2.wall_s)
        job2.release()
        return record
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def rio_changelog(torch, dev, c: dict | None = None) -> dict:
    """(c) The changelog backend against hashmap, and queryable state."""
    c = {"bids": RIO_KP_BIDS, "auctions": RIO_KP_AUCTIONS,
         "batch": KP_BATCH // 8, "paced_s": RIO_KP_PACED_S, **(c or {})}
    want = keyed_process_expected(c["bids"], c["auctions"], c["batch"])
    totals = keyed_process_counts(c["bids"], c["auctions"])
    return {"config": c,
            **{b: rio_keyed_run(torch, dev, c, b, want, totals)
               for b in ("changelog", "hashmap")}}


def collatz_steps(seeds: np.ndarray) -> np.ndarray:
    """numpy oracle of (d): the steps each seed takes to reach 1."""
    v, steps = seeds.copy(), np.zeros_like(seeds)
    live = v != 1
    while live.any():
        v[live] = np.where(v[live] % 2 == 0, v[live] // 2, 3 * v[live] + 1)
        steps[live] += 1
        live = v != 1
    return steps


def rio_iteration(torch, dev, c: dict | None = None) -> dict:
    """(d) The reference test's Collatz-style loop (tests/
    test_iterations.py:22) on host batches: each seed loops (halve the
    evens, 3v + 1 the odds) until it reaches 1 and leaves with its step
    count; every (seed, steps) against numpy."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration, RecordBatch, Schema
    from flink_tpu_torch.core.functions import FilterFunction
    from flink_tpu_torch.runtime.operators.simple import BatchFnOperator

    class AtOne(FilterFunction):
        """v == 1 (or, with ``done=False``, v != 1), a batch at a time."""

        def __init__(self, done: bool):
            self.done = done

        def filter(self, row):
            return (row[1] == 1) == self.done

        def filter_batch(self, batch):
            return (batch.column("v") == 1) == self.done

    c = {"seeds": RIO_SEEDS, "batch": 1 << 12, "wait_s": RIO_LOOP_WAIT_S,
         **(c or {})}
    schema = Schema([("seed", np.int64), ("v", np.int64),
                     ("steps", np.int64)])
    seeds = np.arange(2, c["seeds"] + 2, dtype=np.int64)
    env = StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": c["batch"]}), device=dev)
    src = env.datagen(lambda idx: {"seed": idx + 2, "v": idx + 2,
                                   "steps": idx * 0}, schema,
                      count=c["seeds"])
    it = src.iterate(max_wait_s=c["wait_s"])
    passes = [0]

    def step(b):
        passes[0] += 1
        v = b.column("v")
        return RecordBatch(schema, {
            "seed": b.column("seed"),
            "v": np.where(v % 2 == 0, v // 2, 3 * v + 1),
            "steps": b.column("steps") + 1}, b.timestamps)

    stepped = it.transform("collatz-step",
                           lambda: BatchFnOperator(step, "collatz-step"))
    it.close_with(stepped.filter(AtOne(False), name="loop"))
    got: list = []
    stepped.filter(AtOne(True), name="done").add_sink(
        lambda b: got.extend(b.iter_rows()), "rows")
    t0 = time.perf_counter()
    job = env.execute("runtime-io-d", timeout=RIO_TIMEOUT_S)
    wall = time.perf_counter() - t0
    want = collatz_steps(seeds)
    rows = sorted((int(s), int(n)) for s, _v, n in got)
    if rows != list(zip(seeds.tolist(), want.tolist())):
        raise AssertionError(f"runtime_io (d): {len(rows)} rows, "
                             f"{len(seeds)} expected, or their steps differ")
    rec = {"config": c, "rows": len(rows), "max_steps": int(want.max()),
           "batches_through_the_loop": passes[0], "wall_s": wall,
           "seeds_per_sec": len(seeds) / wall, "tasks": task_record(job)}
    job.release()
    return rec


def runtime_io_phase(torch, dev, sizes: dict | None = None) -> dict:
    """The task runtime and state I/O on the card: (a) an unaligned
    checkpoint of Q5-10M's in-flight device batches, (b) watermark
    alignment and latency markers into Q5-10M's window, (c) the changelog
    backend and queryable state, (d) an iteration; the seconds of each.
    ``sizes``: each part's configuration overrides (a rehearsal)."""
    out, seconds = {}, {}
    for name, fn in (("unaligned", rio_unaligned),
                     ("alignment", rio_alignment),
                     ("changelog", rio_changelog),
                     ("iteration", rio_iteration)):
        t0 = time.perf_counter()
        out[name] = fn(torch, dev, (sizes or {}).get(name))
        seconds[name] = time.perf_counter() - t0
        emit({f"runtime_io_{name}": out[name]})
    out["seconds"] = seconds
    return out


def main(argv: list[str]) -> int:
    mesh_only = argv == ["--mesh"]
    obs_only = argv == ["--observability"]
    ds_only = argv == ["--datastream"]
    conn_only = argv == ["--connectors"]
    pat_only = argv == ["--patterns"]
    rio_only = argv == ["--runtime-io"]
    if mesh_only or obs_only or ds_only or conn_only or pat_only \
            or rio_only:
        argv = []
    if argv and (len(argv) != 2 or argv[0] not in ("--parent-kernels",
                                                   "--profile", "--aot-child")
                 or argv[0] == "--profile"
                 and argv[1] not in PROFILED_CELLS):
        print("usage: chip_smoke.py [--parent-kernels DIR | --profile "
              f"{'|'.join(PROFILED_CELLS)} | --mesh | --observability | "
              "--datastream | --connectors | --patterns | --runtime-io | "
              "--aot-child DIR]",
              file=sys.stderr)
        return 2
    child = argv[1] if argv and argv[0] == "--profile" else None
    aot_dir = argv[1] if argv and argv[0] == "--aot-child" else None
    if child or aot_dir:
        argv = []
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
    if child:
        kernels.build_all()
        return profile_child(torch, torch.device("cuda", 0), child)
    if aot_dir:
        return aot_child(torch, torch.device("cuda", 0), aot_dir)
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    dev = torch.device("cuda", 0)
    emit({"device": {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "package": pkg_dir})
    sector_build = None if argv else start_sector_build()
    nvcc_s = kernels.build_all()
    sector_lib = None if argv else sector_library(sector_build)
    emit({"build": {"nvcc_s": nvcc_s, "dir": str(kernels.BUILD_DIR),
                    "sources": sorted(kernels.SOURCES)}})
    ptxas = {stem: ptxas_report(kernels.build_log(stem))
             for stem in kernels.SOURCES} if hasattr(kernels,
                                                     "build_log") else {}
    emit({"ptxas": ptxas})
    flush = L2Flush(torch, dev)
    if argv:
        emit({"parent_kernels": parent_kernels(torch, dev, flush)})
        return 0
    if obs_only:
        check_sync_detector(torch, dev)
        emit({"observability_seconds": observability_phases(torch, dev)})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if conn_only:
        emit({"connectors_seconds": connectors_phase(torch, dev)["seconds"]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if pat_only:
        emit({"patterns_seconds": patterns_phase(torch, dev)["seconds"]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if rio_only:
        emit({"runtime_io_seconds": runtime_io_phase(torch, dev)["seconds"]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if ds_only:
        emit({"datastream_core": datastream_core_phase(torch, dev)})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if mesh_only:
        rates = sector_rates(torch, dev, flush, sector_lib)
        emit({"mesh_phase_seconds": mesh_phase(torch, dev, flush,
                                               rates)["seconds"]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    rates = sector_rates(torch, dev, flush, sector_lib)
    emit({"sector_rates": rates})
    hist = check_hist256(torch, dev, flush)
    select = check_select(torch, dev, flush)
    probe = check_hash_probe(torch, dev, flush, rates)
    step = check_ingest(torch, dev, flush)
    forms = check_ingest_forms(torch, dev, flush, rates)
    edges = ingest_edges(torch, dev)
    shape = check_launch_shape(torch, dev)
    exchange_ops = exchange_device_ops(torch, dev)
    window = check_window_seal(torch, dev, flush)
    sess = check_session(torch, dev, flush, rates=rates)
    gagg = check_group_agg(torch, dev, flush, rates)
    lists = check_device_lists(torch, dev, flush, rates)
    rows = check_row_state(torch, dev, flush, rates)
    mesh_flush = flush
    emit({"kernel_checks": {"hist256": hist, "select_pass": select,
                            "hash_probe": probe, "ingest_step": step,
                            "ingest_step_forms": forms,
                            "ingest_step_edges": edges,
                            "launch_shape": shape,
                            "exchange_device_ops": exchange_ops,
                            "window_seal": window,
                            "session": sess, "group_agg": gagg,
                            "device_lists": lists, "row_state": rows}})
    del flush
    phase_s = {"build_and_kernels": time.perf_counter() - t_start}
    t_phase = time.perf_counter()
    # every phase but the faults phase runs with no fault armed: it must
    # move none of the guard's, the ladder's or the watchdog's counters
    phase_faults = {"build_and_kernels": counters_delta(
        {k: 0 for k in fault_counters()})}
    if any(phase_faults["build_and_kernels"].values()):
        raise AssertionError("the kernel checks moved the fault counters: "
                             f"{phase_faults['build_and_kernels']}")
    counters_at = fault_counters()

    def phase_done(name: str) -> None:
        nonlocal t_phase, counters_at
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now
        phase_faults[name] = counters_delta(counters_at)
        counters_at = fault_counters()
        if name != "faults" and any(phase_faults[name].values()):
            raise AssertionError(f"phase {name} moved the fault counters: "
                                 f"{phase_faults[name]}")

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
    tiering = tiering_phase(torch, dev, spill)
    emit({"tiering_phase": tiering})
    phase_done("tiering")
    sessions = {cell: session_cell(torch, dev, cell)
                for cell in SESSION_CELLS}
    for cell in SESSION_CELLS:
        emit(sessions[cell])
    phase_done("session_cells")
    emit(session_checkpoint_phase(torch, dev))
    phase_done("session_checkpoint")
    tpch = sql_tpch_q1_phase(torch, dev)["sql_tpch_q1"]
    emit({"sql_tpch_q1": tpch})
    phase_done("sql_tpch_q1")
    groupby = sql_groupby_phase(torch, dev)["sql_groupby_10m"]
    emit({"sql_groupby_10m": groupby})
    phase_done("sql_groupby_10m")
    joins = {}
    for cell in Q7J_CELLS:
        joins[cell] = q7_join_cell(torch, dev, cell)
        emit({cell: joins[cell]})
        phase_done(cell)
    value = value_state_phase(torch, dev)
    emit({"value_state": value})
    phase_done("value_state")
    dedup = dedup_cell(torch, dev)
    emit({"dedup_10m": dedup})
    phase_done("dedup_10m")
    emit({"sql_join": sql_join_phase(torch, dev)})
    phase_done("sql_join")
    emit({"datastream_core": datastream_core_phase(torch, dev)})
    phase_done("datastream_core")
    emit({"connectors_seconds": connectors_phase(torch, dev)["seconds"]})
    phase_done("connectors")
    pats = patterns_phase(torch, dev)
    emit({"patterns_seconds": pats["seconds"]})
    phase_done("patterns")
    rio = runtime_io_phase(torch, dev)
    emit({"runtime_io_seconds": rio["seconds"]})
    phase_done("runtime_io")
    emit(faults_phase(torch, dev))
    phase_done("faults")
    obs = observability_phases(torch, dev)
    emit({"observability_seconds": obs})
    phase_done("observability")
    # the tracing phase's part of it, on a line of its own
    phase_s["observability.tracing"] = obs["tracing"]
    mesh = mesh_phase(torch, dev, mesh_flush, rates, exchange_ops)
    del mesh_flush
    phase_done("mesh")
    emit({"phase_seconds": phase_s})
    emit({"fault_counters_by_phase": phase_faults})
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
                "bound_by": "bytes", "library_ms": seal_q5["library_ms"],
                "library_call": seal_q5["library_call"],
                "launches_by_path": {
                    f"{cell} incremental": c["incremental"][
                        "launches_per_run"][f"window_{kernel}"]
                    for cell, c in (("Q5-10M-W20", wide), ("Q7-10M", q7))},
                "shapes": {k: {**{f: v[f"{kernel}_{f}"] for f in
                                  ("ms", "plain_ms", "bound_ms",
                                   "share_of_bound")},
                               "library_ms": v["library_ms"]}
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
                                         "bound_by", "library_ms",
                                         "ms_without_parts", "share_of_bound",
                                         "sector_floor_ms",
                                         "at_measured_rate_ms",
                                         "share_of_measured_rate")},
                "edge_cases": sorted(k for k, v in edges.items()
                                     if form in v),
                "shapes": {k: forms["shapes"][k] for k in {lead} | others},
                "ptxas": {k: v for k, v in ptxas["hash_table"].items()
                          if ("ingest_spill_kernel" if form == "spill"
                              else "ingest_step_kernel") in k}}

    def session_entry(kernel: str, line: int) -> dict:
        shape = sess["shapes"][f"q11_{kernel}_cap_2^24"]
        return {"name": f"session_{kernel}", "route": "cuda",
                "source": "flink_tpu_torch/csrc/session_window.cu",
                "replaces": "flink_tpu/runtime/operators/device_session.py:"
                            f"{line}",
                "launches": sessions["Q11-10M"]["launches_per_run"][
                    f"session_{kernel}"],
                "max_abs_err": sess["max_abs_err"],
                **{k: shape[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                "share_of_bound": shape["bound_ms"] / shape["ms"],
                "sector_floor_ms": shape["sector_floor_ms"],
                "at_measured_rate_ms": shape["at_measured_rate_ms"],
                "share_of_measured_rate": shape["at_measured_rate_ms"]
                / shape["ms"],
                "launches_session_100K": sessions["session-100K"][
                    "launches_per_run"][f"session_{kernel}"],
                "shape": shape,
                "at_the_cells_middle": sess["shapes"][
                    {"step": "q11_step_mid_run",
                     "fire": "q11_fire_cell"}[kernel]],
                "ptxas": {k: v for k, v in ptxas["session_window"].items()
                          if f"session_{kernel}_kernel" in k}}

    def gagg_entry(stage: str) -> dict:
        # "ms": the stage's device time inside one whole step at TPC-H
        # Q1's shape, "alone_ms" the stage alone, the L2 flushed before it
        at = gagg["shapes"]["tpch_q1"]["stages"][stage]
        key = f"group_agg_{stage}"
        return {"name": key, "route": "cuda",
                "source": "flink_tpu_torch/csrc/group_agg.cu",
                "replaces": "flink_tpu/sql/device_group_agg.py:71",
                "launches": tpch["launches"][key],
                "max_abs_err": gagg["max_abs_err"],
                "max_rel_err": gagg["max_rel_err"],
                **{k: at[k] for k in ("ms", "alone_ms", "plain_ms",
                                      "bound_ms", "sector_floor_ms",
                                      "at_measured_rate_ms",
                                      "share_of_bound",
                                      "share_of_sector_floor",
                                      "library_ms", "launches_per_step")},
                "bound_by": "bytes",
                "step_ms": {k: v["step_ms"]
                            for k, v in gagg["shapes"].items()},
                "launches_by_path": {
                    "sql_groupby_10m": groupby["launches"][key],
                    "sql_groupby_10m retractions": groupby[
                        "retraction_run"]["launches"][key],
                    "patterns (a) GROUP BY": pats["mr"]["group_by"][
                        "launches"][key],
                    "patterns (e) Q17 over HTTP": pats["gateway"][
                        "launches"]["q17"].get(key, 0)},
                "at_groupby_10m": gagg["shapes"]["groupby_10m"]["stages"][
                    stage],
                "edge_cases": sorted(gagg["edges"]),
                "ptxas": {k: v for k, v in ptxas["group_agg"].items()
                          if f"{key}_kernel" in k}}

    def list_entry(kernel: str, line: str, lead: str, others: tuple
                   ) -> dict:
        shapes = lists["shapes"]["q7_join_10m"]
        at = shapes[lead]
        return {"name": kernel, "route": "cuda",
                "source": "flink_tpu_torch/csrc/device_lists.cu",
                "replaces": f"flink_tpu/state/device_lists.py:{line}",
                "launches": joins["q7_join_10m"]["launches_per_run"][kernel],
                "max_abs_err": max(lists["shapes"][cell][k]["max_abs_err"]
                                   for cell in lists["shapes"]
                                   for k in (lead, *others)),
                **{k: at[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "share_of_bound")},
                # the sector floors, a second turn's time, and the
                # prune's earlier bound
                **{k: at[k] for k in ("sector_floor_ms", "at_measured_rate_ms",
                                      "kernel_ms_again", "earlier_bound_ms",
                                      "share_of_earlier_bound") if k in at},
                "bound_by": "bytes", "library_ms": None, "lead_shape": lead,
                "launches_q7_join_ref": joins["q7_join_ref"][
                    "launches_per_run"][kernel],
                "shapes": {f"{cell} {k}": lists["shapes"][cell][k]
                           for cell in lists["shapes"]
                           for k in (lead, *others)},
                "edge_cases": sorted(lists["edges"]),
                "ptxas": {k: v for k, v in ptxas["device_lists"].items()
                          if any(part in k for part in LIST_PARTS[kernel])}}

    def row_entry(kernel: str, line: int) -> dict:
        # dedup_first's launches are the dedup_10m cell's; the value
        # plane's kernels launch on the ValueState path
        at = rows["shapes"]["dedup_10m"][kernel]
        path, launched = (("dedup_10m", dedup["launches_per_run"])
                          if kernel == "dedup_first"
                          else ("value_state", value["launches"]))
        return {"name": kernel, "route": "cuda",
                "source": "flink_tpu_torch/csrc/row_state.cu",
                "replaces": f"flink_tpu/state/tpu_backend.py:{line}",
                "launches": launched[kernel], "launches_path": path,
                "max_abs_err": max(sh[kernel]["max_abs_err"]
                                   for sh in rows["shapes"].values()),
                **{k: at[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "sector_floor_ms",
                                      "at_measured_rate_ms",
                                      "share_of_bound")},
                # dedup_first's and row_set's floors also without the earlier
                # scratch, and the kernel's share of each
                **{k: at[k] for k in ("sector_floor_no_scratch_ms",
                                      "at_measured_rate_no_scratch_ms",
                                      "share_of_rate_floor",
                                      "share_of_rate_floor_no_scratch")
                   if k in at},
                "shape": at, "at_small_shape": rows["shapes"]["small"][kernel],
                # row_set launches at one key on the ValueState path
                **({"at_one_key": rows["shapes"]["dedup_10m"][
                    "row_set_one_key"]} if kernel == "row_set" else {}),
                "edge_cases": sorted(rows["edges"]),
                "ptxas": {k: v for k, v in ptxas.get("row_state", {}).items()
                          if ROW_PTXAS[kernel] in k}}

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
             **{f"{cell} {m}": c[m]["launches_per_run"]["hist256"]
                for cell, c in (("Q5-10M", q5_10m), ("Q5-10M-W20", wide),
                                ("Q7-10M", q7)) for m in modes},
             "patterns (b) CEP": pats["cep"]["launches"]["hist256"],
             "patterns (d) async": pats["async"]["ordered"]["launches"][
                 "hist256"],
             "runtime_io (a) restored": rio["unaligned"][
                 "restore_from_fs"]["launches"]["hist256"],
             "runtime_io (b) aligned": rio["alignment"]["aligned"][
                 "launches"]["hist256"]}},
        {"name": "hash_probe", "route": "cuda",
         "source": "flink_tpu_torch/csrc/hash_table.cu",
         "replaces": "flink_tpu/ops/hash_table.py:133",
         "launches": host["launches"]["hash_probe"],
         "max_abs_err": probe["max_abs_err"], **probe["shapes"][small],
         "at_capacity_2^24": probe["shapes"][large],
         # a device GROUP BY batch probes once; a join's launches are the
         # window's probes and its list stores' reloads
         "launches_by_path": {
             "Q5-10M budget 2^23, tiered": spill["hash_probe_launches"],
             **{f"tiering shift, {m} staging": r["hash_probe_launches"]
                for m, r in tiering["shift"]["runs"].items()},
             "sql_tpch_q1": tpch["launches"]["hash_probe"],
             "sql_groupby_10m": groupby["launches"]["hash_probe"],
             "patterns (a) GROUP BY": pats["mr"]["group_by"]["launches"][
                 "hash_probe"],
             **{cell: joins[cell]["launches_per_run"]["hash_probe"]
                for cell in Q7J_CELLS}},
         "list_reloads_by_cell": {
             cell: {side: st["rebuilds"] + st["rehashes"]
                    for side, st in joins[cell]["stores"].items()}
             for cell in Q7J_CELLS}},
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
         "launches_patterns": {
             "(b) CEP": pats["cep"]["launches"]["ingest_step"],
             "(d) async": pats["async"]["ordered"]["launches"][
                 "ingest_step"]},
         "launches_runtime_io": {
             "(a) restored": rio["unaligned"]["restore_from_fs"][
                 "launches"]["ingest_step"],
             "(b) aligned": rio["alignment"]["aligned"]["launches"][
                 "ingest_step"]},
         "fused_graph_launches_per_micro_batch":
             fused["graph_launches"] / fused["micro_batches"][0]},
        form_entry("dirty", main_run["ingest_step_dirty"],
                   "dirty_cap_2^21", {"dirty_cap_2^24",
                                      "dirty_cap_2^24_present"}),
        form_entry("spill", spill["ingest_step_spill_launches"],
                   "spill_cap_2^23", set()),
        window_entry("seal",
                     "flink_tpu/runtime/operators/device_window.py:295"),
        window_entry("rebuild",
                     "flink_tpu/runtime/operators/device_window.py:352"),
        session_entry("step", 76),
        session_entry("fire", 256),
        *[gagg_entry(stage) for stage in GAGG_STAGES],
        list_entry("list_append", "44", "append_bids_batch",
                   ("append_maxes_fire",)),
        list_entry("list_probe", "77", "probe_bids_by_fire",
                   ("probe_maxes_by_batch",)),
        list_entry("list_prune", "91", "prune_bids_watermark",
                   ("prune_maxes_watermark",)),
        row_entry("dedup_first", 189),
        row_entry("row_set", 111),
        row_entry("row_get", 127),
        row_entry("row_unset", 157),
        mesh_entry(mesh, "exchange_bucket", "exchange", "cell",
                   "flink_tpu/parallel/exchange.py:110"),
        mesh_entry(mesh, "ingest_step_counted", "hash_table",
                   "cell_shard0",
                   "flink_tpu/parallel/sharded_window.py:122"),
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
