"""Deterministic 2Q-style residency policy over key groups (a copy of
``flink_tpu/state/tiering/policy.py``; the eviction and promotion
sequences depend on it, so it must replay the reference bit for bit).

Pure numpy, no device state, no wall clock: every input is an explicit
batch/boundary counter, decay runs on a fixed boundary cadence, and all
ties break through one seeded permutation fixed at construction.  Feeding
the same observation sequence therefore yields the same eviction and
promotion order on every run.

Stages follow the classic 2Q split:

* ``COLD`` (0) — never touched, or demoted to the warm tier.
* ``PROBATION`` (1) — touched once; evicted first, by recency alone.
* ``PROTECTED`` (2) — re-touched in a *later* batch than its first
  touch; evicted last, by decayed heat then recency.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

COLD = 0
PROBATION = 1
PROTECTED = 2

_STAGE_NAMES = ("cold", "probation", "protected")


def stage_name(stage: int) -> str:
    """Human-readable stage label for the residency table."""
    return _STAGE_NAMES[int(stage)]


class TieringPolicy:
    """Decayed frequency+recency (2Q) scoring at key-group granularity.

    ``heat`` is the decayed access-frequency estimate, ``last_touch`` the
    batch counter of the most recent access, ``stage`` the 2Q queue the
    group currently sits in.  The policy never looks at device memory; the
    backend feeds it either per-batch group histograms (sync spill path)
    or the merged device touch clock (deferred spill path).
    """

    def __init__(self, max_parallelism: int, *, seed: int = 24243,
                 decay_interval: int = 8, decay_factor: float = 0.5):
        if max_parallelism <= 0:
            raise ValueError("max_parallelism must be positive")
        self.max_parallelism = int(max_parallelism)
        self.decay_interval = max(1, int(decay_interval))
        self.decay_factor = float(decay_factor)
        self.heat = np.zeros(self.max_parallelism, np.float64)
        self.last_touch = np.zeros(self.max_parallelism, np.int64)
        self.first_touch = np.zeros(self.max_parallelism, np.int64)
        self.stage = np.zeros(self.max_parallelism, np.int8)
        # Seeded tie-break: groups with identical (stage, heat, recency)
        # keys order by this fixed permutation, never by dict/hash order.
        self._tiebreak = np.random.default_rng(int(seed)).permutation(
            self.max_parallelism)
        self._boundaries = 0
        self.decays = 0

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    def touch(self, groups: np.ndarray, batch_no: int,
              counts: Optional[np.ndarray] = None) -> None:
        """Record accesses for ``groups`` during batch ``batch_no``.

        ``groups`` may contain duplicates unless ``counts`` is given, in
        which case ``groups`` must be unique and ``counts`` carries the
        per-group access count.
        """
        if len(groups) == 0:
            return
        groups = np.asarray(groups, np.int64)
        if counts is None:
            groups, counts = np.unique(groups, return_counts=True)
        batch_no = int(batch_no)
        # 2Q transitions: first touch parks a group in probation; a touch
        # in a strictly later batch than the first promotes to protected.
        fresh = self.stage[groups] == COLD
        self.stage[groups[fresh]] = PROBATION
        self.first_touch[groups[fresh]] = batch_no
        again = (self.stage[groups] == PROBATION) & (
            self.first_touch[groups] < batch_no)
        self.stage[groups[again]] = PROTECTED
        self.heat[groups] += counts.astype(np.float64)
        np.maximum.at(self.last_touch, groups,
                      np.full(len(groups), batch_no, np.int64))

    def adopt_clock(self, clock: np.ndarray) -> np.ndarray:
        """Merge a device touch clock (int64[max_parallelism]).

        The deferred spill path keeps an on-device per-group LRU clock;
        the backend syncs it at boundaries and hands it here.  A group
        whose clock advanced since the last adoption counts as one touch
        in that batch.  Returns the boolean mask of advanced groups so the
        caller can account hit ratios.
        """
        clock = np.asarray(clock, np.int64)
        advanced = clock > self.last_touch
        if advanced.any():
            groups = np.nonzero(advanced)[0]
            fresh = self.stage[groups] == COLD
            self.stage[groups[fresh]] = PROBATION
            self.first_touch[groups[fresh]] = clock[groups[fresh]]
            again = (self.stage[groups] == PROBATION) & (
                self.first_touch[groups] < clock[groups])
            self.stage[groups[again]] = PROTECTED
            self.heat[groups] += 1.0
            self.last_touch[groups] = clock[groups]
        return advanced

    def on_boundary(self) -> bool:
        """Advance the boundary cadence; decay heat when it is due.

        Boundaries are checkpoint/fire events, never wall clock, so the
        decay schedule replays identically.
        Returns True when a decay step ran.
        """
        self._boundaries += 1
        if self._boundaries % self.decay_interval != 0:
            return False
        self.heat *= self.decay_factor
        self.decays += 1
        return True

    def demote(self, groups: Sequence[int]) -> None:
        """Mark ``groups`` as paged out to the warm tier (stage COLD)."""
        groups = np.asarray(groups, np.int64)
        if len(groups):
            self.stage[groups] = COLD

    def promote(self, groups: Sequence[int]) -> None:
        """Mark ``groups`` as paged back in (stage PROTECTED).

        A promoted group earned its way back with sustained heat, so it
        re-enters the protected queue, not probation.
        """
        groups = np.asarray(groups, np.int64)
        if len(groups):
            self.stage[groups] = PROTECTED

    # ------------------------------------------------------------------
    # decisions
    # ------------------------------------------------------------------
    def eviction_order(self, candidates: np.ndarray) -> np.ndarray:
        """Order ``candidates`` coldest-first for eviction.

        Probationary groups go first (recency only, 2Q's A1 queue), then
        protected groups by (decayed heat, recency).  ``np.lexsort`` keys
        are listed least significant first; the fixed permutation is the
        final tie-break so the order is total and seeded.
        """
        candidates = np.asarray(candidates, np.int64)
        if len(candidates) == 0:
            return candidates
        protected = (self.stage[candidates] == PROTECTED).astype(np.int8)
        order = np.lexsort((
            self._tiebreak[candidates],
            self.last_touch[candidates],
            self.heat[candidates],
            protected,
        ))
        return candidates[order]

    def promotion_order(self, candidates: np.ndarray,
                        min_heat: float) -> np.ndarray:
        """Order warm ``candidates`` hottest-first, dropping tepid ones."""
        candidates = np.asarray(candidates, np.int64)
        if len(candidates) == 0:
            return candidates
        hot = candidates[self.heat[candidates] >= float(min_heat)]
        if len(hot) == 0:
            return hot
        order = np.lexsort((
            self._tiebreak[hot],
            -self.last_touch[hot],
            -self.heat[hot],
        ))
        return hot[order]
