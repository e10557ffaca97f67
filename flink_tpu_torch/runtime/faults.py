"""Deterministic fault injection and the device guard (trimmed port of
``flink_tpu/runtime/faults.py``).

A process-wide registry of named fault sites threaded through the device
operators, the transfer points, channels, the sink, checkpoint storage and
the tier moves. Every site is seeded and schedulable through the
``faults.enabled``, ``faults.seed`` and ``faults.spec`` keys, so a chaos
run replays exactly: the same seed, spec and visit order give the same
trips, down to the visit number in each event.

Sites the port threads:

    device.execute    a guarded dispatch: an ingest step, a chain replay,
                      a fire (``DeviceGuard``)
    transfer.h2d      a host->device upload of a batch, a restore
    transfer.d2h      a device->host read: a fire's results, a staged
                      spill drain, a status or count read, a snapshot
    channel.send      writing into a downstream channel
    channel.backpressure  drop-style: a put reports "queue full" once
    checkpoint.write  persisting a completed checkpoint
    checkpoint.load   reading a checkpoint back for restore
    checkpoint.corrupt   mutation-style: bit-flip a stored chunk file
    checkpoint.truncate  mutation-style: truncate a stored chunk file
    sink.invoke       delivering a batch to a sink
    tier.evict        paging cold key groups to the host tier
    tier.prefetch     staging warm key groups for promotion
    device.compile    an ``nvcc`` build of a kernel library
                      (``ops/kernels.py``), under the watchdog's
                      ``device.compile`` deadline
    aot.load          reading a cached kernel library back
                      (``runtime/aot.py``); a ``!poison`` trip
                      corrupt-mutates the bytes read, so the digest check,
                      not luck, must catch it
    aot.store         persisting a freshly built library; a trip skips
                      persistence (the next process builds again), a
                      ``!poison`` trip commits a corrupt-mutated artifact
                      for the verified load to quarantine

Rule grammar ``site=mode[!flag...]``: modes ``once@N`` (trip on the Nth
visit), ``every@N``, ``p<float>`` (seeded per-visit probability),
``always`` and ``off``; flags ``!persistent`` (not retryable; the default
is transient), ``!poison`` (a data fault: the batch is quarantined, never
retried) and ``!hang@MS`` (the trip SLEEPS MS milliseconds instead of
raising, and the stall watchdog's deadline is what surfaces it). The
reference's ``!job@NAME`` tenant filter belongs to multi-job isolation,
which the port does not have.

A site is visited on the caller's thread before the work behind it
starts. A hang sleeps there too: past the deadline of the watchdog region
the visit opens, it sleeps only to the deadline and raises that region's
``StallError``. Such a stall comes before the work began, so it may be
retried; the reference's ``HangAbandoned`` (a hang that wakes on an
abandoned worker) has no counterpart.

``DeviceGuard`` is the reflex around every guarded dispatch: transient
faults and stalls of its own visits retry with exponential backoff (the
restart strategy's math, ``cluster/failover.py``); persistent faults
surface as ``DeviceSegmentError`` so the operator can evacuate its state
and degrade to its CPU rung; poison faults skip retry so the operator
quarantines the batch. Only those are classified: whatever the dispatch
itself raises (a real CUDA error, a failed kernel build, a library that
does not load, a fault or stall of a region nested in it) propagates
untouched into task failover. Launches are asynchronous and change state
in place, so a dispatch that began is never run again; and after a
sticky CUDA error the context cannot even run the evacuating snapshot,
so retrying or degrading would only hide the card's fault.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from .watchdog import WATCHDOG, StallError

__all__ = ["FAULT_SITES", "FaultRule", "InjectedFault", "DeviceSegmentError", "FaultInjector", "FAULTS",
           "fire_with_retries", "DeviceGuard"]

#: Every site the port threads; a spec naming another site is rejected, so
#: a typo fails loudly instead of injecting nothing.
FAULT_SITES = (
    "device.compile", "device.execute",
    "transfer.h2d", "transfer.d2h",
    "channel.send", "channel.backpressure",
    "checkpoint.write", "checkpoint.load",
    "checkpoint.corrupt", "checkpoint.truncate",
    "sink.invoke",
    "tier.evict", "tier.prefetch",
    "aot.load", "aot.store",
)


class InjectedFault(RuntimeError):
    """Raised (or reported, at drop-style sites) by a tripped rule.
    ``hang_ms > 0`` marks a hang: the site sleeps instead of raising."""

    def __init__(self, site: str, visit: int, transient: bool = True,
                 poison: bool = False, hang_ms: int = 0):
        super().__init__(
            f"injected fault at {site} (visit {visit}, "
            f"{'transient' if transient else 'persistent'}"
            f"{', poison' if poison else ''}"
            f"{f', hang {hang_ms}ms' if hang_ms else ''})")
        self.site = site
        self.visit = visit
        self.transient = transient
        self.poison = poison
        self.hang_ms = hang_ms


class DeviceSegmentError(RuntimeError):
    """A guarded dispatch failed beyond what retries absorb. ``poison``
    marks a data fault (quarantine the batch); otherwise the operator
    degrades or fails over."""

    def __init__(self, scope: str, cause: BaseException,
                 poison: bool = False):
        super().__init__(f"device segment {scope!r} failed: {cause}")
        self.scope = scope
        self.cause = cause
        self.poison = poison


@dataclass
class FaultRule:
    """One parsed ``site=mode[!flags]`` entry of ``faults.spec``."""

    site: str
    mode: str            # "once" | "every" | "prob" | "always" | "off"
    at: int = 1          # once: trip ON this visit; every: the period
    p: float = 0.0       # prob: per-visit trip probability
    transient: bool = True
    poison: bool = False
    hang_ms: int = 0     # > 0: the trip sleeps this long instead

    @staticmethod
    def parse(entry: str) -> "FaultRule":
        entry = entry.strip()
        if "=" not in entry:
            raise ValueError(f"fault rule {entry!r}: expected 'site=mode'")
        site, _, mode = entry.partition("=")
        site = site.strip()
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(known: {', '.join(FAULT_SITES)})")
        parts = mode.strip().split("!")
        mode, flags = parts[0].strip(), {f.strip() for f in parts[1:]}
        hang_ms = 0
        for f in list(flags):
            if f.startswith("hang@"):
                flags.discard(f)
                hang_ms = int(f[5:])
                if hang_ms < 1:
                    raise ValueError(
                        f"fault rule {entry!r}: hang@MS needs MS>=1")
        bad = flags - {"persistent", "transient", "poison"}
        if bad:
            raise ValueError(f"fault rule {entry!r}: unknown flags {bad}")
        rule = FaultRule(site, "off", transient="persistent" not in flags,
                         poison="poison" in flags, hang_ms=hang_ms)
        if mode in ("off", ""):
            rule.mode = "off"
        elif mode == "always":
            rule.mode = "always"
        elif mode.startswith("once"):
            rule.mode = "once"
            rule.at = int(mode[5:]) if mode.startswith("once@") else 1
        elif mode.startswith("every@"):
            rule.mode = "every"
            rule.at = int(mode[6:])
            if rule.at < 1:
                raise ValueError(f"fault rule {entry!r}: every@N needs N>=1")
        elif mode.startswith("p"):
            rule.mode = "prob"
            rule.p = float(mode[1:])
            if not 0.0 <= rule.p <= 1.0:
                raise ValueError(f"fault rule {entry!r}: p out of [0,1]")
        else:
            raise ValueError(f"fault rule {entry!r}: unknown mode {mode!r}")
        return rule


class FaultInjector:
    """Process-wide registry of schedulable fault sites.

    Disabled (the default) every check is one attribute read. Enabled,
    each visit to a site bumps the site's counter under a lock and
    evaluates its rules; probability rules draw from a per-site
    ``random.Random`` seeded by ``"{seed}:{site}"``, so determinism needs
    only a stable visit order, which one mailbox loop per subtask gives.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.seed = 0
        self._rules: dict[str, list[FaultRule]] = {}
        self._visits: dict[str, int] = {}
        self._trips: dict[str, int] = {}
        self._rngs: dict[str, random.Random] = {}
        self._fingerprint: Optional[tuple] = None
        self._suppress = 0  # > 0: no site trips (degrade/evacuate paths)
        self.events: list[dict] = []  # bounded trip log

    # -- configuration ---------------------------------------------------
    def configure(self, config) -> None:
        """Adopt the ``faults.*`` keys of a job's Configuration. Idempotent
        on an unchanged (enabled, seed, spec): a redeploy of the same job
        keeps its visit counters, so a once@N fault does not re-arm on
        every restart attempt."""
        enabled = bool(config.get("faults.enabled"))
        seed = int(config.get("faults.seed"))
        spec = str(config.get("faults.spec") or "")
        fingerprint = (enabled, seed, spec)
        with self._lock:
            if fingerprint == self._fingerprint:
                return
        self.configure_spec(spec, seed=seed, enabled=enabled)
        with self._lock:
            self._fingerprint = fingerprint

    def configure_spec(self, spec: str, seed: int = 0,
                       enabled: bool = True) -> None:
        rules: dict[str, list[FaultRule]] = {}
        for entry in (spec or "").split(","):
            if not entry.strip():
                continue
            rule = FaultRule.parse(entry)
            rules.setdefault(rule.site, []).append(rule)
        with self._lock:
            self._rules = rules
            self.seed = seed
            self.enabled = enabled and bool(rules)
            self._clear_locked()

    def reset(self) -> None:
        """Disarm and clear every schedule and counter (test isolation)."""
        with self._lock:
            self.enabled = False
            self._rules = {}
            self._clear_locked()

    def _clear_locked(self) -> None:
        self._visits.clear()
        self._trips.clear()
        self._rngs.clear()
        self.events.clear()
        self._fingerprint = None

    # -- suppression (degrade/evacuate paths must not trip again) ----------
    class _Suppressed:
        def __init__(self, inj):
            self._inj = inj

        def __enter__(self):
            with self._inj._lock:
                self._inj._suppress += 1

        def __exit__(self, *exc):
            with self._inj._lock:
                self._inj._suppress -= 1
            return False

    def suppressed(self) -> "_Suppressed":
        """Context manager: no site trips inside (the evacuation and the
        fallback of last resort are never chaos-injected)."""
        return self._Suppressed(self)

    # -- the hot check ---------------------------------------------------
    def _trip(self, site: str) -> Optional[InjectedFault]:
        with self._lock:
            if self._suppress:
                return None
            rules = self._rules.get(site)
            if not rules:
                return None
            visit = self._visits.get(site, 0) + 1
            self._visits[site] = visit
            hit_rule = None
            for rule in rules:
                if rule.mode == "off":
                    continue
                if rule.mode == "once":
                    hit = visit == rule.at
                elif rule.mode == "every":
                    hit = visit % rule.at == 0
                elif rule.mode == "always":
                    hit = True
                else:  # prob
                    rng = self._rngs.get(site)
                    if rng is None:
                        rng = self._rngs[site] = random.Random(
                            f"{self.seed}:{site}")
                    hit = rng.random() < rule.p
                if hit:
                    hit_rule = rule
                    break
            if hit_rule is None:
                return None
            rule = hit_rule
            self._trips[site] = self._trips.get(site, 0) + 1
            if len(self.events) < 4096:
                self.events.append({"site": site, "visit": visit,
                                    "transient": rule.transient,
                                    "poison": rule.poison,
                                    "hang_ms": rule.hang_ms})
        from ..metrics.device import DEVICE_STATS
        DEVICE_STATS.note_injected(site)
        return InjectedFault(site, visit, transient=rule.transient,
                             poison=rule.poison, hang_ms=rule.hang_ms)

    @staticmethod
    def _hang(fault: InjectedFault, bound: Optional[tuple]) -> None:
        """Sleep out a hang trip outside the lock, on the caller's thread.
        ``bound`` is ``(site, deadline s, scope)`` of the watchdog region
        the visit opens: a hang past that deadline sleeps only to it, and
        the watchdog records the region's stall, which the caller gets
        before the region's work began."""
        hang_s = fault.hang_ms / 1000.0
        if bound is not None and 0 < bound[1] < hang_s:
            time.sleep(bound[1])
            raise WATCHDOG.note_stall(*bound)
        time.sleep(hang_s)

    def fire(self, site: str, bound: Optional[tuple] = None) -> None:
        """Visit a raising site; raises InjectedFault when its rule trips.
        A hang trip sleeps instead (see ``_hang`` for ``bound``)."""
        if not self.enabled:
            return
        fault = self._trip(site)
        if fault is None:
            return
        if fault.hang_ms:
            self._hang(fault, bound)
            return
        raise fault

    def check(self, site: str) -> bool:
        """Visit a drop-style site: True when its rule trips (the caller
        drops or declines instead of raising). A hang trip sleeps and
        reports not tripped."""
        if not self.enabled:
            return False
        fault = self._trip(site)
        if fault is None:
            return False
        if fault.hang_ms:
            self._hang(fault, None)
            return False
        return True

    # -- views -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "seed": self.seed,
                    "visits": dict(self._visits),
                    "trips": dict(self._trips)}


#: The process-global injector every site consults; ``deploy_local``
#: configures it from the job's Configuration.
FAULTS = FaultInjector()


def fire_with_retries(site: str, scope: Optional[str] = None,
                      max_attempts: int = 5,
                      bound: Optional[tuple] = None) -> int:
    """Visit a raising site with transient-retry semantics: a transient
    trip counts one retry and visits again; persistent or poison trips,
    exhausted retries and a hang's stall (``bound``, as ``FAULTS.fire``)
    propagate. Returns the retries spent. The idiom of transfer, channel,
    sink and tier sites, whose retry is simply attempting the operation
    again."""
    if not FAULTS.enabled:
        return 0
    from ..metrics.device import DEVICE_STATS
    for attempt in range(max_attempts + 1):
        try:
            FAULTS.fire(site, bound)
            return attempt
        except InjectedFault as e:
            if not e.transient or e.poison or attempt >= max_attempts:
                raise
            DEVICE_STATS.note_retry(scope or site)
    return max_attempts  # pragma: no cover - the loop returns or raises


class DeviceGuard:
    """Retry and escalation around guarded dispatches.

    The guard visits its sites on the caller's thread and then calls the
    dispatch there too: no thread hand-off on a step or a fire.

    * transient injected faults, and hangs past the watchdog's
      ``device.execute`` deadline, retry up to
      ``device.failover.max-retries`` times with exponential backoff,
      counted in ``DEVICE_STATS`` (``device_retries_total``);
    * poison faults skip retry and surface as
      ``DeviceSegmentError(poison=True)``: the operator quarantines the
      batch;
    * persistent faults and exhausted retries surface as
      ``DeviceSegmentError`` for the operator's degrade ladder;
    * whatever the dispatch raises propagates untouched.

    Every fault or stall the guard classifies came before the dispatch
    began, so a retry or the CPU rung never runs a batch's launches
    twice. A dispatch ends at its launches and blocks on nothing; what
    does block (a read, the in-flight wait) is a supervised region of its
    own, whose stall fails the task.

    ``active=False`` (an operator on its CPU rung) makes the guard a
    passthrough: the fallback of last resort is never chaos-injected."""

    def __init__(self, scope: str, config=None):
        from ..cluster.failover import ExponentialDelayRestartStrategy

        self.scope = scope
        self.active = True
        if config is not None:
            self.max_retries = int(config.get("device.failover.max-retries"))
            initial = float(config.get("device.failover.retry-backoff"))
            maximum = float(config.get("device.failover.retry-backoff-max"))
        else:
            self.max_retries, initial, maximum = 3, 0.005, 0.25
        # consecutive failures back off exponentially; a healthy call
        # resets the ladder
        self._strategy = ExponentialDelayRestartStrategy(
            initial=initial, maximum=maximum, reset_after=60.0)
        self.calls = 0        # guarded dispatches
        self.retries = 0
        self.failures = 0
        self.stalls = 0       # injected hangs past the deadline here

    def run(self, fn: Callable, sites: tuple = ("device.execute",)):
        """Visit ``sites``, then call ``fn``. Retries transient faults and
        stalls of the visits; raises DeviceSegmentError beyond them. Each
        attempt is a ``device.Execute`` span (host times: it covers the
        visits and the enqueue, as the reference's covers an asynchronous
        dispatch). It is the ambient parent of the visits (a stall's span
        hangs off it) but not of ``fn``: in the reference the dispatch runs
        on the watchdog's worker, so what it emits (a kernel build)
        parents on nothing, here as there."""
        if not self.active:
            return fn()
        from ..metrics.tracing import TRACER, use_context
        self.calls += 1
        attempt = 0
        while True:
            sb = (TRACER.span("device", "Execute")
                  .set_attribute("scope", self.scope)
                  .set_attribute("attempt", attempt))
            try:
                if FAULTS.enabled:
                    with use_context(sb.context):
                        self._visit(sites)
            except InjectedFault as e:
                sb.set_attribute("error", True).finish()
                if e.poison:
                    self.failures += 1
                    raise DeviceSegmentError(self.scope, e, poison=True) \
                        from e
                err, retryable = e, e.transient
            except StallError as e:
                sb.set_attribute("error", True).finish()
                self.stalls += 1
                err, retryable = e, True
            else:
                try:
                    out = fn()
                except BaseException:
                    sb.set_attribute("error", True).finish()
                    raise
                sb.set_attribute("error", False).finish()
                if attempt:
                    self._strategy.notify_recovered()
                return out
            if not retryable or attempt >= self.max_retries:
                self.failures += 1
                raise DeviceSegmentError(self.scope, err) from err
            attempt += 1
            self.retries += 1
            from ..metrics.device import DEVICE_STATS
            DEVICE_STATS.note_retry(self.scope)
            self._strategy.notify_failure()
            time.sleep(self._strategy.backoff_seconds())

    def _visit(self, sites: tuple) -> None:
        bound = ("device.execute", WATCHDOG.deadline_in_force(
            "device.execute"), self.scope)
        for s in sites:
            FAULTS.fire(s, bound)
