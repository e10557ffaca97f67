"""CEP: complex event processing over keyed streams (port of
``flink_tpu/cep``).

Flink's CEP library: ``CEP.pattern(stream, pattern, key).select(fn,
out_schema)``. A pattern (``cep/pattern.py``) compiles to an NFA
(``cep/nfa.py``) that ``CepOperator`` (``cep/operator.py``) drives a key
at a time in event-time order. Every part runs on the host; the rows it
emits reach a device operator downstream as host batches.

Usage::

    pat = (Pattern.begin("start").where(lambda e: e["v"] == 1)
           .followed_by("end").where(lambda e: e["v"] == 2)
           .within(10_000))
    out = CEP.pattern(ds, pat, key="user").select(
        lambda m: (m["start"][0]["user"],), out_schema)
"""

from __future__ import annotations

from typing import Callable

from ..core.records import Schema
from .nfa import NFA, NO_SKIP, SKIP_PAST_LAST_EVENT, SKIP_TO_NEXT_ROW, Match
from .operator import CepOperator
from .pattern import MalformedPatternError, Pattern

__all__ = ["CEP", "Pattern", "PatternStream", "Match", "NFA",
           "MalformedPatternError", "NO_SKIP", "SKIP_PAST_LAST_EVENT",
           "SKIP_TO_NEXT_ROW", "CepOperator"]


class PatternStream:
    def __init__(self, stream, pattern: Pattern, key: str,
                 skip_strategy: str = NO_SKIP,
                 greedy_per_start: bool = False,
                 order_column: str = None):
        self.stream = stream
        self.pattern = pattern
        self.key = key
        self.skip_strategy = skip_strategy
        self.greedy_per_start = greedy_per_start
        self.order_column = order_column

    def with_skip_strategy(self, strategy: str) -> "PatternStream":
        return PatternStream(self.stream, self.pattern, self.key, strategy,
                             self.greedy_per_start, self.order_column)

    def _build(self, select_fn, out_schema: Schema, flat: bool):
        stages = self.pattern.compile()
        within, key = self.pattern.within_ms, self.key
        skip, greedy = self.skip_strategy, self.greedy_per_start
        order_col = self.order_column
        keyed = self.stream.key_by(key)

        def factory():
            return CepOperator(
                NFA(stages, within, skip, greedy_per_start=greedy), key,
                select_fn, out_schema, flat_select=flat,
                order_column=order_col)

        out = keyed._one_input("CepOperator", factory,
                               key_extractor=keyed.key_extractor)
        out._sql_schema = out_schema
        return out

    def select(self, fn: Callable[[Match], tuple], out_schema: Schema):
        """One output row a match (Flink's PatternSelectFunction)."""
        return self._build(fn, out_schema, flat=False)

    def flat_select(self, fn, out_schema: Schema):
        """Any number of rows a match (PatternFlatSelectFunction)."""
        return self._build(fn, out_schema, flat=True)


class CEP:
    @staticmethod
    def pattern(stream, pattern: Pattern, key: str) -> PatternStream:
        return PatternStream(stream, pattern, key)
