"""The CEP pattern API (port of ``flink_tpu/cep/pattern.py``).

A fluent builder over stages, as Flink's ``Pattern``: ``begin``,
``next`` / ``followed_by`` / ``followed_by_any`` (strict, relaxed and
non-deterministic relaxed contiguity), ``not_next`` /
``not_followed_by`` guards, ``where`` / ``or_`` conditions over the event
as a dict ``{column: value}``, ``where_with_history`` conditions that
also see the events the partial match captured so far, the quantifiers
(``times``, ``times_or_more``, ``one_or_more``, ``optional``, ``greedy``,
``consecutive``, ``allow_combinations``), ``until`` and ``within``.
``compile`` validates the stages for the NFA (``cep/nfa.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["Pattern", "Stage", "MalformedPatternError", "STRICT",
           "RELAXED", "NDR"]

# contiguity between stages and inside a loop: strict, skip till next,
# skip till any
STRICT = "strict"
RELAXED = "relaxed"
NDR = "ndr"

Predicate = Callable[[dict], bool]


class MalformedPatternError(ValueError):
    pass


@dataclass
class Stage:
    """One compiled pattern node. ``preds`` are OR-combined conditions of
    the event; ``ctx_preds`` take (event, {stage name: [captured event
    dicts]}), the events the partial captured so far."""

    name: str
    contiguity: str = RELAXED         # against the previous stage
    preds: list = field(default_factory=list)
    ctx_preds: list = field(default_factory=list)
    until: Optional[Predicate] = None
    min_count: int = 1
    max_count: Optional[int] = 1      # None: unbounded
    optional: bool = False
    negated: bool = False             # not_next / not_followed_by
    greedy: bool = False
    inner_contiguity: str = RELAXED   # inside a loop

    def matches(self, event: dict, ctx: Optional[Callable] = None) -> bool:
        """``ctx()`` builds the captured-events view on demand; without
        it (the start state) the history is empty."""
        if not self.preds and not self.ctx_preds:
            return True
        if any(p(event) for p in self.preds):
            return True
        if self.ctx_preds:
            by_name = ctx() if ctx is not None else {}
            return any(p(event, by_name) for p in self.ctx_preds)
        return False

    @property
    def looping(self) -> bool:
        return self.max_count is None or self.max_count > 1


class Pattern:
    """The builder; the terminal operations are on ``PatternStream``."""

    def __init__(self, stages: list, within_ms: Optional[int] = None):
        self._stages = stages
        self.within_ms = within_ms

    @staticmethod
    def begin(name: str) -> "Pattern":
        return Pattern([Stage(name, contiguity=RELAXED)])

    def _last(self) -> Stage:
        return self._stages[-1]

    def _append(self, name: str, contiguity: str,
                negated: bool = False) -> "Pattern":
        if any(s.name == name for s in self._stages):
            raise MalformedPatternError(f"duplicate pattern name {name!r}")
        self._stages.append(Stage(name, contiguity=contiguity,
                                  negated=negated))
        return self

    def next(self, name: str) -> "Pattern":
        return self._append(name, STRICT)

    def followed_by(self, name: str) -> "Pattern":
        return self._append(name, RELAXED)

    def followed_by_any(self, name: str) -> "Pattern":
        return self._append(name, NDR)

    def not_next(self, name: str) -> "Pattern":
        return self._append(name, STRICT, negated=True)

    def not_followed_by(self, name: str) -> "Pattern":
        return self._append(name, RELAXED, negated=True)

    # -- conditions --------------------------------------------------------
    def where(self, pred: Predicate) -> "Pattern":
        self._last().preds.append(pred)
        return self

    def or_(self, pred: Predicate) -> "Pattern":
        return self.where(pred)

    def where_with_history(self, pred: Callable[[dict, dict], bool]
                           ) -> "Pattern":
        """A condition of (event, {name: [captured event dicts]}): Flink's
        IterativeCondition, what a MATCH_RECOGNIZE DEFINE that names
        another variable lowers to."""
        self._last().ctx_preds.append(pred)
        return self

    def until(self, pred: Predicate) -> "Pattern":
        if not self._last().looping:
            raise MalformedPatternError("until() needs a looping stage")
        self._last().until = pred
        return self

    # -- quantifiers -------------------------------------------------------
    def times(self, n: int, to: Optional[int] = None) -> "Pattern":
        s = self._last()
        s.min_count = n
        s.max_count = n if to is None else to
        return self

    def times_or_more(self, n: int) -> "Pattern":
        s = self._last()
        s.min_count = n
        s.max_count = None
        return self

    def one_or_more(self) -> "Pattern":
        return self.times_or_more(1)

    def optional(self) -> "Pattern":
        self._last().optional = True
        return self

    def greedy(self) -> "Pattern":
        self._last().greedy = True
        return self

    def consecutive(self) -> "Pattern":
        """Strict contiguity inside the loop."""
        self._last().inner_contiguity = STRICT
        return self

    def allow_combinations(self) -> "Pattern":
        self._last().inner_contiguity = NDR
        return self

    def within(self, ms: int) -> "Pattern":
        self.within_ms = int(ms)
        return self

    def compile(self) -> list:
        """Validate and return the stage list for the NFA."""
        if not self._stages:
            raise MalformedPatternError("empty pattern")
        if self._stages[0].negated:
            raise MalformedPatternError("pattern cannot start with NOT")
        if self._stages[-1].negated and self.within_ms is None:
            raise MalformedPatternError(
                "notFollowedBy cannot be the last pattern without within()")
        for s in self._stages:
            if s.negated and (s.looping or s.optional):
                raise MalformedPatternError(
                    "NOT patterns cannot be looping or optional")
        if all(s.negated or s.optional for s in self._stages):
            raise MalformedPatternError("pattern needs a positive stage")
        return list(self._stages)
