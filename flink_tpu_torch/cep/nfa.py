"""The NFA over one key's events (port of ``flink_tpu/cep/nfa.py``).

Flink's NFA with its shared buffer (``computeNextStates``' TAKE, IGNORE
and PROCEED branches, ``AfterMatchSkipStrategy``), held as an explicit
list of partial matches: each partial is (stage, count, captured events).
The branches give the three consuming strategies between stages and
inside loops, greedy loops, optional stages, NOT guards and ``within``.

The state stays on the host, as in the reference: conditions are Python
predicates, and a key's partials are few. ``greedy_per_start`` holds a
completed match back until no live partial of the same start (nor, under
skip past last, an earlier start) could still give a longer or a
preferred one: SQL's greedy quantifiers by deferral instead of
backtracking. The deferred bests live in the partials list as
``_PendingBest`` so they snapshot with the keyed state.

``adopt_partial`` rebuilds a partial, a pending best or an event from any
object with the same fields, so a snapshot written by the reference
restores here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .pattern import NDR, RELAXED, STRICT, Stage

__all__ = ["NFA", "Event", "Match", "NO_SKIP", "SKIP_PAST_LAST_EVENT",
           "SKIP_TO_NEXT_ROW", "adopt_event", "adopt_partial"]

NO_SKIP = "no_skip"
SKIP_PAST_LAST_EVENT = "skip_past_last_event"
SKIP_TO_NEXT_ROW = "skip_to_next_row"


@dataclass(frozen=True)
class Event:
    seq: int
    ts: int
    data: dict


@dataclass
class Match:
    """One complete match: pattern name -> its event dicts."""

    events: dict
    start_ts: int
    end_ts: int
    last_seq: int
    start_seq: int = 0

    def __getitem__(self, name: str) -> list:
        return self.events[name]


@dataclass
class _Partial:
    stage: int                   # index into the positive stages
    count: int                   # events taken in the current stage
    taking: bool                 # the loop still takes (until, consecutive)
    captured: tuple              # ((stage index, Event), ...)
    start_ts: int
    start_seq: int
    ignored_since_advance: int   # events ignored since the last take


@dataclass
class _PendingBest:
    """The longest completed match of one start row, held while a live
    partial could still give a longer one (``greedy_per_start``)."""

    start_seq: int
    start_ts: int
    match: Match


def adopt_event(e) -> Event:
    if isinstance(e, Event):
        return e
    return Event(int(e.seq), int(e.ts), dict(e.data))


def _adopt_match(m) -> Match:
    if isinstance(m, Match):
        return m
    return Match(dict(m.events), int(m.start_ts), int(m.end_ts),
                 int(m.last_seq), int(m.start_seq))


def adopt_partial(p):
    """A port ``_Partial`` or ``_PendingBest`` from an object with the
    same fields (the reference's own dataclasses, unpickled)."""
    if isinstance(p, (_Partial, _PendingBest)):
        return p
    if hasattr(p, "match"):
        return _PendingBest(int(p.start_seq), int(p.start_ts),
                            _adopt_match(p.match))
    return _Partial(int(p.stage), int(p.count), bool(p.taking),
                    tuple((int(si), adopt_event(ev))
                          for si, ev in p.captured),
                    int(p.start_ts), int(p.start_seq),
                    int(p.ignored_since_advance))


def _events_by_name(stages: list, captured: tuple) -> dict:
    out: dict[str, list] = {}
    for si, ev in captured:
        out.setdefault(stages[si].name, []).append(ev.data)
    return out


class NFA:
    #: a watermark at or above this ends the input
    END_OF_STREAM_TS = 1 << 61

    def __init__(self, stages: list, within_ms: Optional[int] = None,
                 skip_strategy: str = NO_SKIP,
                 greedy_per_start: bool = False):
        """``greedy_per_start``: exactly one match, the longest, a start
        row (with SKIP_PAST_LAST_EVENT: AFTER MATCH SKIP PAST LAST ROW;
        with SKIP_TO_NEXT_ROW: one a start, overlaps kept)."""
        self.stages = stages
        self.within_ms = within_ms
        self.skip = skip_strategy
        self.greedy_per_start = greedy_per_start
        # the positive stages in order; negated ones guard between them
        self.pos: list[int] = [i for i, s in enumerate(stages)
                               if not s.negated]
        if not self.pos:
            raise ValueError("pattern has no positive stages")
        # per positive stage, fixed once the pattern is compiled: its
        # guards, its PROCEED candidates, and the count that makes it final
        # (None: a later stage is required)
        n = len(self.pos)
        self._guards = [self._guards_of(pi) for pi in range(n)]
        self._nexts = [self._candidates_of(pi) for pi in range(n)]
        self._final_at = [
            self._stage(pi).min_count
            if all(self._stage(j).optional for j in range(pi + 1, n))
            else None for pi in range(n)]

    def _stage(self, pi: int) -> Stage:
        return self.stages[self.pos[pi]]

    def _guards_of(self, pi: int) -> list[Stage]:
        """The negated stages after positive ``pi`` (and before the next
        positive one, or the trailing ones)."""
        lo = self.pos[pi]
        hi = self.pos[pi + 1] if pi + 1 < len(self.pos) else len(self.stages)
        return [self.stages[i] for i in range(lo + 1, hi)
                if self.stages[i].negated]

    def _candidates_of(self, pi: int) -> list[int]:
        """The positive stages a PROCEED from ``pi`` reaches: the next one,
        and past it while the stage passed over is optional."""
        out = []
        j = pi + 1
        while j < len(self.pos):
            out.append(j)
            if not self._stage(j).optional:
                break
            j += 1
        return out

    def _captured_ctx(self, captured: tuple):
        """The {stage name: [event dicts]} view of ``captured``, built at
        its first use and kept: one event may test several conditions."""
        cache: list = []

        def build() -> dict:
            if not cache:
                cache.append(_events_by_name(self.stages, captured))
            return cache[0]
        return build

    def _is_final(self, pi: int, count: int) -> bool:
        at = self._final_at[pi]
        return at is not None and count >= at

    # -- greedy per start --------------------------------------------------
    @staticmethod
    def _match_rank(m: Match) -> tuple:
        return (m.last_seq, sum(len(v) for v in m.events.values()))

    def _resolve_pending(self, pending: list, raw: list, live: list,
                         flush_all: bool = False) -> tuple[list, list]:
        """Merge new matches into each start's best; release a best once
        no live partial could extend it, nor (skip past last) precede it.
        Returns (the partials with the bests still held, released)."""
        by_start = {pb.start_seq: pb for pb in pending}
        for m in raw:
            cur = by_start.get(m.start_seq)
            if cur is None or self._match_rank(m) > self._match_rank(
                    cur.match):
                by_start[m.start_seq] = _PendingBest(m.start_seq,
                                                     m.start_ts, m)
        live_starts = {p.start_seq for p in live}
        min_live = min(live_starts) if live_starts else None
        released: list[Match] = []
        still: list[_PendingBest] = []
        horizon = -1
        for pb in sorted(by_start.values(), key=lambda x: x.start_seq):
            if pb.start_seq <= horizon:
                continue            # inside a released match
            blocked = (not flush_all
                       and (pb.start_seq in live_starts
                            or (self.skip == SKIP_PAST_LAST_EVENT
                                and min_live is not None
                                and min_live < pb.start_seq)))
            if blocked:
                still.append(pb)
                continue
            released.append(pb.match)
            if self.skip == SKIP_PAST_LAST_EVENT:
                horizon = pb.match.last_seq
        if horizon >= 0:
            live = [p for p in live if p.start_seq > horizon]
            still = [pb for pb in still if pb.start_seq > horizon]
        return still + live, released

    # -- one event ---------------------------------------------------------
    def advance(self, partials: list, event: Event) -> tuple[list, list]:
        """``event`` through every partial and the start state; returns
        (the new partials, the matches)."""
        pending: list[_PendingBest] = []
        if self.greedy_per_start:
            pending = [p for p in partials if isinstance(p, _PendingBest)]
            partials = [p for p in partials
                        if not isinstance(p, _PendingBest)]
        out: list[_Partial] = []
        matches: list[Match] = []
        seen: set = set()

        def emit(p: _Partial) -> None:
            key = tuple(e.seq for _, e in p.captured)
            if key in seen:
                return
            seen.add(key)
            matches.append(Match(_events_by_name(self.stages, p.captured),
                                 p.start_ts, event.ts,
                                 max(e.seq for _, e in p.captured),
                                 p.start_seq))

        def offer(p: _Partial) -> None:
            """A successor: emitted when final, kept while it can grow."""
            if not self._is_final(p.stage, p.count):
                out.append(p)
                return
            if self._guards[p.stage]:
                out.append(p)   # a trailing NOT: decided at the timeout
                return
            emit(p)
            s = self._stage(p.stage)
            if p.taking and s.looping and (
                    s.max_count is None or p.count < s.max_count):
                out.append(p)   # the loop may still give a longer match

        for p in partials:
            if (self.within_ms is not None
                    and event.ts - p.start_ts > self.within_ms):
                self._flush_deferred(p, event.ts, matches)
                continue
            out.extend(self._advance_one(p, event, offer))

        # every event may start a match (the start state's self-loop); the
        # first positive stage that takes it starts the run
        first = self._stage(0)
        starts = [0] + (self._nexts[0] if first.optional else [])
        for pi in starts:
            s = self._stage(pi)
            if not s.negated and s.matches(event.data,
                                           self._captured_ctx(())):
                offer(_Partial(pi, 1, True, ((self.pos[pi], event),),
                               event.ts, event.seq, 0))
                break

        if self.greedy_per_start:
            return self._resolve_pending(pending, matches, out)
        if self.skip == SKIP_PAST_LAST_EVENT and matches:
            # keep the earliest start, drop what overlaps it
            matches.sort(key=lambda m: m.start_seq)
            kept: list[Match] = []
            horizon = -1
            for m in matches:
                if m.start_seq > horizon:
                    kept.append(m)
                    horizon = m.last_seq
            matches = kept
            out = [p for p in out if p.start_seq > horizon]
        return out, matches

    def _advance_one(self, p: _Partial, event: Event, offer) -> list:
        """The TAKE, PROCEED and IGNORE branches of one partial."""
        s = self._stage(p.stage)
        branches: list[_Partial] = []
        ctx = self._captured_ctx(p.captured)
        e_matches = s.matches(event.data, ctx)

        # until() ends the loop's taking (the event is not consumed)
        taking = p.taking
        if taking and s.until is not None and p.count >= 1 \
                and s.until(event.data):
            taking = False

        can_take = (taking and e_matches
                    and (s.max_count is None or p.count < s.max_count))
        took = False
        if can_take:
            offer(_Partial(p.stage, p.count + 1, taking,
                           p.captured + ((self.pos[p.stage], event),),
                           p.start_ts, p.start_seq, 0))
            took = True

        proceeded = False
        if p.count >= s.min_count and not (s.greedy and can_take):
            guards = self._guards[p.stage]
            if any(g.matches(event.data, ctx)
                   and (g.contiguity != STRICT
                        or p.ignored_since_advance == 0)
                   for g in guards):
                return branches    # a NOT guard matched: the path dies
            for pj in self._nexts[p.stage]:
                nxt = self._stage(pj)
                # a strict next stage needs the event right after the last
                # take; only this candidate is blocked, an optional one
                # lets a later relaxed candidate be reached
                if nxt.contiguity == STRICT and p.ignored_since_advance > 0:
                    if nxt.optional:
                        continue
                    break
                if nxt.matches(event.data, ctx):
                    offer(_Partial(pj, 1, True,
                                   p.captured + ((self.pos[pj], event),),
                                   p.start_ts, p.start_seq, 0))
                    proceeded = True
                    if nxt.contiguity != NDR:
                        break

        # IGNORE: keep waiting, as the contiguity allows
        in_loop = p.count >= 1
        cont = s.inner_contiguity if in_loop else s.contiguity
        ignore_ok = True
        new_taking = taking
        if in_loop:
            if cont == STRICT and taking:
                # consecutive(): any ignored event ends the loop's taking;
                # the branch may still wait for the next stage
                new_taking = False
            if cont == RELAXED and took:
                ignore_ok = False
            if p.count >= s.min_count:
                # waiting is useless when every next candidate is strict
                # (they die once anything was ignored)
                nxts = self._nexts[p.stage]
                all_strict = nxts and all(
                    self._stage(j).contiguity == STRICT for j in nxts)
                if all_strict and not took and (cont == STRICT
                                                or not proceeded):
                    ignore_ok = False
        else:
            if cont == STRICT and not took:
                return branches    # a strict stage's first event missed
            if cont == RELAXED and took:
                ignore_ok = False
        if ignore_ok and not (took and cont == RELAXED and not in_loop):
            branches.append(_Partial(p.stage, p.count, new_taking,
                                     p.captured, p.start_ts, p.start_seq,
                                     p.ignored_since_advance + 1))
        return branches

    def _flush_deferred(self, p: _Partial, now_ts: int,
                        matches: list) -> None:
        """A timed-out partial whose positive stages are done and whose
        only obligation left was a trailing NOT matches at its timeout."""
        if not self._is_final(p.stage, p.count) \
                or not self._guards[p.stage]:
            return
        end_ts = (p.start_ts + self.within_ms if self.within_ms is not None
                  else now_ts)
        matches.append(Match(_events_by_name(self.stages, p.captured),
                             p.start_ts, end_ts,
                             max(e.seq for _, e in p.captured),
                             p.start_seq))

    def prune(self, partials: list, watermark_ts: int) -> tuple[list, list]:
        """Drop the partials whose ``within`` has passed (a deferred
        trailing-NOT match fires here); under ``greedy_per_start`` resolve
        the held bests again, releasing all at the end of the input."""
        pending: list[_PendingBest] = []
        if self.greedy_per_start:
            pending = [p for p in partials if isinstance(p, _PendingBest)]
            partials = [p for p in partials
                        if not isinstance(p, _PendingBest)]
        if self.within_ms is None:
            kept, matches = list(partials), []
        else:
            kept, matches = [], []
            for p in partials:
                if watermark_ts - p.start_ts > self.within_ms:
                    self._flush_deferred(p, p.start_ts + self.within_ms,
                                         matches)
                else:
                    kept.append(p)
        if self.greedy_per_start:
            return self._resolve_pending(
                pending, matches, kept,
                flush_all=watermark_ts >= self.END_OF_STREAM_TS)
        return kept, matches
