"""Port parity of CEP (``flink_tpu_torch/cep``) against ``flink_tpu/cep``.

* Patterns built by the same calls compile to equal stages, and the same
  malformed patterns raise in both packages.
* A hypothesis test draws patterns from the reference's own grammar
  (strict, relaxed and non-deterministic contiguity, loops with every
  inner contiguity, optional and greedy stages, ``until``, NOT guards,
  ``within``, every skip strategy, greedy-per-start) and event
  sequences; both NFAs give equal matches and equal partials after every
  event and every prune.
* ``CepOperator`` through the harness: equal rows, late rows on the
  ``dead-letter`` side output and dead-letter counts.
* Snapshots taken mid-stream, holding partials and pending best matches,
  restore across the packages both ways (the reference's classes are
  rebuilt from the port's fields by ``_to_reference``, a helper of this
  test only).
* chip_smoke.py's CEP job (b), tiny, through the port's runtime on the
  CPU and through the reference's: both windows equal the oracle under
  the tie rule; and the same job, with its checkpoint, cancel and
  restore, in a subprocess that cannot import jax or flink_tpu.

Tolerance: exact (integer values).
"""

import importlib.util
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

jax = pytest.importorskip("jax")

import flink_tpu.cep as ref_cep  # noqa: E402
import flink_tpu.cep.nfa as ref_nfa  # noqa: E402
import flink_tpu.core.functions as ref_fn  # noqa: E402
from flink_tpu.cep.operator import CepOperator as RefCepOperator  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.metrics import DEVICE_STATS as REF_STATS  # noqa: E402
from flink_tpu.runtime.harness import \
    OneInputOperatorTestHarness as RefHarness  # noqa: E402
import flink_tpu_torch.cep as port_cep  # noqa: E402
import flink_tpu_torch.cep.nfa as port_nfa  # noqa: E402
from flink_tpu_torch.cep.operator import CepOperator  # noqa: E402
from flink_tpu_torch.core.records import Schema  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402
from flink_tpu_torch.runtime.harness import \
    OneInputOperatorTestHarness  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDES = {
    "ref": types.SimpleNamespace(cep=ref_cep, nfa=ref_nfa, Op=RefCepOperator,
                                 Schema=RefSchema, Harness=RefHarness,
                                 stats=REF_STATS),
    "port": types.SimpleNamespace(cep=port_cep, nfa=port_nfa, Op=CepOperator,
                                  Schema=Schema,
                                  Harness=OneInputOperatorTestHarness,
                                  stats=DEVICE_STATS),
}
FIELDS = [("k", np.int64), ("v", np.int64)]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- patterns as recipes, built in either package -----------------------------

def _cond(kind, c):
    if kind == "eq":
        return lambda e: e["v"] == c
    if kind == "ge":
        return lambda e: e["v"] >= c
    return lambda e: e["v"] != c


def _hist(first):
    """A history condition: above the first captured event of ``first``."""
    def pred(e, h):
        prev = h.get(first)
        return bool(prev) and e["v"] > prev[0]["v"]
    return pred


def _build(side: str, recipe: dict):
    """Apply ``recipe`` (stage steps, within) to the package's Pattern."""
    Pattern = SIDES[side].cep.Pattern
    pat = None
    for st_ in recipe["stages"]:
        if pat is None:
            pat = Pattern.begin(st_["name"])
        else:
            pat = getattr(pat, st_["link"])(st_["name"])
        for kind, c in st_["conds"]:
            pat = pat.where(_cond(kind, c))
        if st_.get("hist"):
            pat = pat.where_with_history(_hist(recipe["stages"][0]["name"]))
        for q in st_.get("quant", ()):
            pat = getattr(pat, q[0])(*q[1:])
    if recipe.get("within") is not None:
        pat = pat.within(recipe["within"])
    return pat


def _stage_fields(s) -> tuple:
    return (s.name, s.contiguity, len(s.preds), len(s.ctx_preds),
            s.until is None, s.min_count, s.max_count, s.optional,
            s.negated, s.greedy, s.inner_contiguity)


def _compile(side, recipe):
    try:
        pat = _build(side, recipe)
        return pat, pat.compile(), None
    except SIDES[side].cep.MalformedPatternError as e:
        return None, None, type(e).__name__ + ":" + str(e)


COMPILE_CASES = [
    {"stages": [{"name": "a", "conds": [("eq", 1)]},
                {"name": "b", "link": "followed_by", "conds": [("eq", 3)]}]},
    {"stages": [{"name": "a", "conds": [("eq", 1)],
                 "quant": [("one_or_more",), ("consecutive",)]},
                {"name": "b", "link": "next", "conds": [("ge", 2)],
                 "quant": [("optional",)]},
                {"name": "c", "link": "followed_by_any", "conds": [],
                 "hist": True}], "within": 500},
    {"stages": [{"name": "a", "conds": [("eq", 1)],
                 "quant": [("times", 2, 4), ("allow_combinations",),
                           ("greedy",), ("until", lambda e: e["v"] == 0)]},
                {"name": "n", "link": "not_next", "conds": [("eq", 5)]},
                {"name": "b", "link": "followed_by", "conds": [("eq", 2)],
                 "quant": [("times_or_more", 2)]}]},
    # malformed: a NOT last without within, a looping NOT, all optional,
    # a NOT start is impossible to build, until on a non-loop, a duplicate
    {"stages": [{"name": "a", "conds": []},
                {"name": "n", "link": "not_followed_by", "conds": []}]},
    {"stages": [{"name": "a", "conds": []},
                {"name": "n", "link": "not_next", "conds": [],
                 "quant": [("one_or_more",)]},
                {"name": "b", "link": "next", "conds": []}]},
    {"stages": [{"name": "a", "conds": [], "quant": [("optional",)]}]},
    {"stages": [{"name": "a", "conds": [],
                 "quant": [("until", lambda e: True)]}]},
    {"stages": [{"name": "a", "conds": []},
                {"name": "a", "link": "next", "conds": []}]},
]


def test_patterns_compile_to_equal_stages_and_equal_errors():
    for recipe in COMPILE_CASES:
        got = {}
        for side in SIDES:
            try:
                _pat, stages, err = _compile(side, recipe)
            except Exception as e:  # builder-time errors (duplicate, until)
                stages, err = None, type(e).__name__ + ":" + str(e)
            got[side] = (err if stages is None
                         else [_stage_fields(s) for s in stages])
        assert got["ref"] == got["port"], recipe


# -- the NFAs on drawn patterns and events ------------------------------------

_LINKS = ("next", "followed_by", "followed_by_any", "not_next",
          "not_followed_by")


@st.composite
def _recipes(draw):
    n = draw(st.integers(1, 4))
    stages = []
    for i in range(n):
        link = None if i == 0 else draw(st.sampled_from(_LINKS))
        conds = draw(st.lists(st.tuples(st.sampled_from(("eq", "ge", "ne")),
                                        st.integers(0, 3)),
                              min_size=0, max_size=2))
        stage = {"name": f"s{i}", "link": link, "conds": conds,
                 "hist": i > 0 and draw(st.booleans())}
        negated = link in ("not_next", "not_followed_by")
        quant = []
        if not negated:
            q = draw(st.sampled_from(("", "one_or_more", "times",
                                      "times_range", "times_or_more",
                                      "optional", "loop_optional")))
            if q == "one_or_more":
                quant.append(("one_or_more",))
            elif q == "times":
                quant.append(("times", draw(st.integers(1, 3))))
            elif q == "times_range":
                quant.append(("times", 1, draw(st.integers(2, 3))))
            elif q == "times_or_more":
                quant.append(("times_or_more", draw(st.integers(1, 2))))
            elif q == "optional":
                quant.append(("optional",))
            elif q == "loop_optional":
                quant += [("one_or_more",), ("optional",)]
            if q in ("one_or_more", "times_range", "times_or_more",
                     "loop_optional") or (q == "times"
                                          and quant[-1][1] > 1):
                inner = draw(st.sampled_from(("", "consecutive",
                                              "allow_combinations")))
                if inner:
                    quant.append((inner,))
                if draw(st.booleans()):
                    quant.append(("greedy",))
                if draw(st.booleans()):
                    quant.append(("until", _cond("eq", 0)))
        stage["quant"] = quant
        stages.append(stage)
    within = draw(st.one_of(st.none(), st.integers(20, 80)))
    return {"stages": stages, "within": within}


def _norm_match(m) -> tuple:
    return (tuple(sorted((name, tuple(d["i"] for d in evs))
                         for name, evs in m.events.items())),
            m.start_ts, m.end_ts, m.last_seq, m.start_seq)


def _norm_partial(p) -> tuple:
    if hasattr(p, "match"):
        return ("best", p.start_seq, p.start_ts, _norm_match(p.match))
    return ("partial", p.stage, p.count, p.taking,
            tuple((si, e.seq, e.ts) for si, e in p.captured), p.start_ts,
            p.start_seq, p.ignored_since_advance)


def _run_nfa(side, stages, recipe, skip, greedy, events, prunes):
    nfa_mod = SIDES[side].nfa
    nfa = nfa_mod.NFA(stages, recipe.get("within"), skip,
                      greedy_per_start=greedy)
    partials, trace = [], []
    for seq, (v, ts) in enumerate(events):
        partials, ms = nfa.advance(partials, nfa_mod.Event(
            seq, ts, {"v": v, "i": seq}))
        trace.append(([_norm_match(m) for m in ms],
                      [_norm_partial(p) for p in partials]))
        if seq in prunes:
            partials, ms = nfa.prune(partials, ts)
            trace.append(([_norm_match(m) for m in ms],
                          [_norm_partial(p) for p in partials]))
    partials, ms = nfa.prune(partials, nfa.END_OF_STREAM_TS)
    trace.append(([_norm_match(m) for m in ms],
                  [_norm_partial(p) for p in partials]))
    return trace


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(recipe=_recipes(),
       events=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 30)),
                       min_size=1, max_size=9),
       skip=st.sampled_from(("no_skip", "skip_past_last_event",
                             "skip_to_next_row")),
       greedy=st.booleans(), prunes=st.sets(st.integers(0, 8)))
def test_nfas_give_equal_matches_on_drawn_patterns(recipe, events, skip,
                                                   greedy, prunes):
    ts, t = [], 0
    for _v, gap in events:
        t += gap
        ts.append(t)
    evs = [(v, t) for (v, _g), t in zip(events, ts)]
    out = {}
    for side in SIDES:
        _pat, stages, err = _compile(side, recipe)
        out[side] = err if stages is None else _run_nfa(
            side, stages, recipe, skip, greedy, evs, prunes)
    assert out["ref"] == out["port"]


# -- the operator through the harness -----------------------------------------

def _v_pattern(side, within=None):
    P = SIDES[side].cep.Pattern
    pat = (P.begin("a").where(lambda e: e["v"] >= 5)
           .next("b").where_with_history(
               lambda e, h: e["v"] < h["a"][0]["v"]).one_or_more()
           .consecutive()
           .next("c").where_with_history(
               lambda e, h: e["v"] > h["b"][-1]["v"]))
    return pat.within(within) if within else pat


def _v_select(m):
    return (m["a"][0]["k"], m["a"][0]["v"], m["b"][-1]["v"], m["c"][0]["v"],
            len(m["b"]))


V_OUT = [("k", np.int64), ("a", np.int64), ("low", np.int64),
         ("c", np.int64), ("n_b", np.int64)]


def _operator(side, within=None, skip="skip_past_last_event", greedy=True):
    s = SIDES[side]
    pat = _v_pattern(side, within)
    return s.Op(s.nfa.NFA(pat.compile(), pat.within_ms, skip,
                          greedy_per_start=greedy),
                "k", _v_select, s.Schema(V_OUT))


def _stream(n=400, keys=5, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, n)
    v = rng.integers(0, 10, n)
    ts = np.cumsum(rng.integers(0, 4, n))
    return [(int(a), int(b)) for a, b in zip(k, v)], ts.tolist()


@pytest.mark.parametrize("skip,greedy", [("skip_past_last_event", True),
                                         ("skip_to_next_row", True),
                                         ("no_skip", False),
                                         ("skip_past_last_event", False)])
def test_cep_operator_rows_late_rows_and_dead_letters_equal(skip, greedy):
    rows, ts = _stream()
    got = {}
    for side, s in SIDES.items():
        h = s.Harness(_operator(side, within=40, skip=skip, greedy=greedy),
                      schema=s.Schema(FIELDS))
        before = s.stats.dead_letter_records
        for lo in range(0, len(rows), 50):
            h.process_elements(rows[lo:lo + 50], ts[lo:lo + 50])
            # the watermark runs ahead of the next rows: some come late
            h.process_watermark(ts[min(lo + 60, len(rows) - 1)])
        h.close()
        got[side] = (h.get_output(), h.get_side_output("dead-letter"),
                     s.stats.dead_letter_records - before,
                     h.operator.late_dropped)
    assert got["ref"] == got["port"]
    assert got["port"][0] and got["port"][1]
    assert got["port"][2] == got["port"][3] == len(got["port"][1])


# -- snapshots across the packages --------------------------------------------

def _to_reference(snapshot: dict) -> dict:
    """The port's CEP snapshot with the reference's classes, rebuilt from
    the port's fields."""
    def event(e):
        return ref_nfa.Event(e.seq, e.ts, dict(e.data))

    def partial(p):
        if hasattr(p, "match"):
            m = p.match
            return ref_nfa._PendingBest(p.start_seq, p.start_ts, ref_nfa.Match(
                dict(m.events), m.start_ts, m.end_ts, m.last_seq,
                m.start_seq))
        return ref_nfa._Partial(p.stage, p.count, p.taking,
                                tuple((si, event(e)) for si, e in p.captured),
                                p.start_ts, p.start_seq,
                                p.ignored_since_advance)

    cep = snapshot["keyed"]["backend"]["cep"]
    return {"keyed": {"backend": {"cep": {
        kg: {k: {"buffer": [event(e) for e in st_["buffer"]],
                 "partials": [partial(p) for p in st_["partials"]]}
             for k, st_ in m.items()} for kg, m in cep.items()}}},
        "operator": dict(snapshot["operator"])}


def _held(snapshot: dict) -> tuple[int, int, int]:
    """(partials, pending bests, buffered events) in a snapshot."""
    parts = best = buf = 0
    for m in snapshot["keyed"]["backend"]["cep"].values():
        for st_ in m.values():
            buf += len(st_["buffer"])
            for p in st_["partials"]:
                if hasattr(p, "match"):
                    best += 1
                else:
                    parts += 1
    return parts, best, buf


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshots_mid_stream_restore_across_the_packages(direction):
    rows, ts = _stream(n=300, keys=3, seed=11)
    cut = 170
    src, dst = direction.split("_to_")

    def run(side, parts):
        s = SIDES[side]
        h = s.Harness(_operator(side, within=60), schema=s.Schema(FIELDS))
        for lo, hi, wm in parts:
            h.process_elements(rows[lo:hi], ts[lo:hi])
            h.process_watermark(wm)
        return h

    whole = run("ref", [(0, cut, ts[cut - 1] - 5), (cut, len(rows), 1 << 61)])
    first = run(src, [(0, cut, ts[cut - 1] - 5)])
    snap = first.snapshot()
    parts, best, buf = _held(snap)
    assert parts and best and buf, (parts, best, buf)
    if src == "port":
        snap = _to_reference(snap)
    s = SIDES[dst]
    h2 = s.Harness.restored(lambda: _operator(dst, within=60), snap,
                            schema=s.Schema(FIELDS))
    h2.process_elements(rows[cut:], ts[cut:])
    h2.process_watermark(1 << 61)
    assert first.get_output() + h2.get_output() == whole.get_output()


def test_cep_datastream_jobs_equal_reference():
    """Flink's CEPITCase shape through both runtimes at parallelism 2: a
    start and an end per key, relaxed, within, flat select."""
    rows, ts = _stream(n=600, keys=7, seed=5)
    got = {}
    for side in SIDES:
        if side == "ref":
            from flink_tpu.api.environment import StreamExecutionEnvironment
            env = StreamExecutionEnvironment()
        else:
            from flink_tpu_torch.api.environment import \
                StreamExecutionEnvironment
            env = StreamExecutionEnvironment(device="cpu")
        env.set_parallelism(2)
        env.config.set("pipeline.micro-batch-size", 64)
        s = SIDES[side]
        ds = env.from_collection(rows, s.Schema(FIELDS), timestamps=ts)
        pat = (s.cep.Pattern.begin("start").where(lambda e: e["v"] == 1)
               .followed_by("end").where(lambda e: e["v"] == 2).within(30))
        out = s.cep.CEP.pattern(ds, pat, key="k").flat_select(
            lambda m: [(m["start"][0]["k"], m["start"][0]["v"],
                        m["end"][0]["v"])] * 2,
            s.Schema([("k", np.int64), ("s", np.int64), ("e", np.int64)]))
        got[side] = sorted(out.execute_and_collect("cep"))
    assert got["ref"] == got["port"] and got["port"]


# -- chip_smoke.py's job (b), tiny --------------------------------------------

TINY_B = {"bids": 1 << 13, "bidders": 1 << 7, "auctions": 1 << 8,
          "span_ms": 30_000, "batch": 1 << 9, "capacity": 1 << 10,
          "topk": 20}


def _reference_b(cs, c: dict) -> list:
    """Job (b) through the reference's runtime: the same bid stream, the
    same pattern, the Q5 window of its matches; [(window end - 1,
    auctions, bids, revenue)]."""
    from flink_tpu.api.environment import StreamExecutionEnvironment
    from flink_tpu.core.watermarks import WatermarkStrategy
    from flink_tpu.runtime.operators.device_window import AggSpec
    from flink_tpu.window import SlidingEventTimeWindows

    env = StreamExecutionEnvironment()
    env.set_state_backend("tpu")
    env.config.set("pipeline.micro-batch-size", c["batch"])
    env.config.set("pipeline.auto-watermark-interval", 0)
    schema = RefSchema(list(cs.CEP_BID_FIELDS))
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    bids = env.datagen(cs.cep_bid_gen(c), schema, count=c["bids"],
                       timestamp_column="ts", watermark_strategy=ws)
    pat = cs.cep_pattern(ref_cep.Pattern)
    matches = ref_cep.CEP.pattern(bids, pat, key="bidder") \
        .with_skip_strategy(ref_cep.SKIP_PAST_LAST_EVENT) \
        .select(cs.cep_select, RefSchema(list(cs.CEP_MATCH_FIELDS)))
    got = []

    class Windows(ref_fn.SinkFunction):
        def invoke_batch(self, b):
            got.append((int(b.timestamps[0]), b.column("auction"),
                        b.column("bids"), b.column("revenue")))
            return True

    (matches.key_by("auction")
        .window(SlidingEventTimeWindows.of(cs.WINDOW_PANES * cs.PANE_MS,
                                           cs.PANE_MS))
        .device_aggregate([AggSpec("count", out_name="bids"),
                           AggSpec("sum", "price", out_name="revenue")],
                          capacity=c["capacity"], ring_size=cs.RING,
                          emit_window_bounds=False, emit_topk=c["topk"])
        .add_sink(Windows()))
    env.execute("cep-b-ref")
    return got


def test_tiny_cep_job_equals_the_reference_under_the_tie_rule(monkeypatch):
    import torch

    cs = _smoke()
    # the smoke's memory records are the card's
    cs.fresh_memory = lambda torch: {}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    c = dict(cs.PATTERNS["cep"], **TINY_B)
    expected = cs.cep_windows_expected(c)
    port = cs.cep_run(torch, torch.device("cpu"), c)
    ref = _reference_b(cs, c)
    assert cs.q5_check(expected, port["got"]) == len(expected) > 5
    assert cs.q5_check(expected, ref) == len(expected)
    assert port["matches"] == len(cs.cep_matches_expected(c))


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import importlib.util, json
import torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.fresh_memory = lambda torch: {{}}
torch.cuda.max_memory_allocated = lambda *a, **k: 0
out = cs.patterns_cep(torch, torch.device("cpu"), {tiny!r})
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(json.dumps({{"windows": out["windows"],
                  "before": out["restore"]["windows_before_cancel"],
                  "after": out["restore"]["windows_after_restore"]}}))
"""


def test_cep_job_with_a_restore_runs_with_jax_and_flink_tpu_blocked():
    proc = subprocess.run(
        [sys.executable, "-c",
         _BLOCKED.format(root=str(ROOT), tiny=dict(TINY_B, paced=0.01))],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["windows"] > 5 and got["before"] and got["after"]
