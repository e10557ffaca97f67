"""Restart backoff strategies (port of ``flink_tpu/cluster/failover.py``,
whole).

Flink's RestartBackoffTimeStrategy family (fixed delay, exponential
delay, failure rate, none), selected through ``restart-strategy.*`` keys
as the reference's RestartStrategyOptions select it. The device guard
(``runtime/faults.py``) reuses the exponential strategy's backoff math.
"""

from __future__ import annotations

import time

from ..core.config import Configuration

__all__ = ["RestartStrategy", "NoRestartStrategy", "FixedDelayRestartStrategy",
           "ExponentialDelayRestartStrategy", "FailureRateRestartStrategy",
           "restart_strategy_from_config"]


class RestartStrategy:
    def can_restart(self) -> bool:
        raise NotImplementedError

    def backoff_seconds(self) -> float:
        raise NotImplementedError

    def notify_failure(self) -> None:
        pass

    def notify_recovered(self) -> None:
        """Called after a stretch of healthy running (resets escalation)."""


class NoRestartStrategy(RestartStrategy):
    def can_restart(self) -> bool:
        return False

    def backoff_seconds(self) -> float:
        return 0.0


class FixedDelayRestartStrategy(RestartStrategy):
    def __init__(self, attempts: int, delay: float):
        self.attempts = attempts
        self.delay = delay
        self._failures = 0

    def notify_failure(self) -> None:
        self._failures += 1

    def can_restart(self) -> bool:
        return self._failures <= self.attempts

    def backoff_seconds(self) -> float:
        return self.delay


class ExponentialDelayRestartStrategy(RestartStrategy):
    def __init__(self, initial: float, maximum: float, multiplier: float = 2.0,
                 reset_after: float = 60.0):
        self.initial = initial
        self.maximum = maximum
        self.multiplier = multiplier
        self.reset_after = reset_after
        self._current = initial
        self._last_failure = 0.0

    def notify_failure(self) -> None:
        now = time.time()
        if now - self._last_failure > self.reset_after:
            self._current = self.initial
        else:
            self._current = min(self._current * self.multiplier, self.maximum)
        self._last_failure = now

    def notify_recovered(self) -> None:
        # reset the escalation AND the failure clock: without clearing
        # _last_failure, the first failure AFTER a healthy stretch still
        # lands inside the old reset_after window and escalates straight
        # to initial*multiplier (reference ExponentialDelayRestartBackoff-
        # TimeStrategy resets its whole state on a stable run)
        self._current = self.initial
        self._last_failure = 0.0

    def can_restart(self) -> bool:
        return True

    def backoff_seconds(self) -> float:
        return self._current


class FailureRateRestartStrategy(RestartStrategy):
    """Give up when more than ``max_failures`` within ``interval`` seconds."""

    def __init__(self, max_failures: int, interval: float, delay: float):
        self.max_failures = max_failures
        self.interval = interval
        self.delay = delay
        self._failures: list[float] = []

    def notify_failure(self) -> None:
        self._failures.append(time.time())
        self._prune()

    def _prune(self) -> None:
        cutoff = time.time() - self.interval
        self._failures = [t for t in self._failures if t >= cutoff]

    def can_restart(self) -> bool:
        # prune HERE too: old entries must age out even when no new
        # failure arrives, otherwise a burst permanently poisons the
        # window and the strategy never allows another restart
        self._prune()
        return len(self._failures) <= self.max_failures

    def backoff_seconds(self) -> float:
        return self.delay


def restart_strategy_from_config(config: Configuration) -> RestartStrategy:
    kind = config.get("restart-strategy.type")
    if kind == "none":
        return NoRestartStrategy()
    if kind == "fixed-delay":
        return FixedDelayRestartStrategy(
            config.get("restart-strategy.fixed-delay.attempts"),
            config.get("restart-strategy.fixed-delay.delay"))
    if kind == "failure-rate":
        return FailureRateRestartStrategy(
            config.get("restart-strategy.failure-rate."
                       "max-failures-per-interval"),
            interval=config.get(
                "restart-strategy.failure-rate.failure-rate-interval"),
            delay=config.get("restart-strategy.failure-rate.delay"))
    return ExponentialDelayRestartStrategy(
        config.get("restart-strategy.exponential-delay.initial-backoff"),
        config.get("restart-strategy.exponential-delay.max-backoff"))
