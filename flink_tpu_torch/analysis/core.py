"""Rule registry, finding model, suppression comments, and the
committed-baseline workflow shared by every rule of the port's lint (port
of ``flink_tpu/analysis/core.py``, pointed at ``flink_tpu_torch``).

Design notes
------------
* A ``Finding``'s **fingerprint** deliberately excludes the line number:
  baselined findings must survive unrelated edits that shift lines.  The
  stable identity is (rule, file, symbol, detail).
* Suppressions are inline comments: ``# lint: <tag> <reason>`` on the
  flagged line or the line above.  A tag with no reason does NOT
  suppress — the reason is the point (it is the reviewable record of
  why the exception is sound).
* Rules import neither torch nor the port's runtime at module import
  time: Tier A runs anywhere Python runs. The port's Tier B is the sync
  audit on the card (``chip_smoke.py``), not a rule of this registry.
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


# --------------------------------------------------------------------------
# Findings


@dataclass(frozen=True)
class Finding:
    """One lint hit: where, what, and how to fix it."""

    rule: str                 # rule id, e.g. "TPU101"
    file: str                 # repo-relative posix path
    line: int                 # 1-based; 0 when the finding is file-level
    symbol: str               # stable anchor (qualname / key / site name)
    message: str
    hint: str = ""

    @property
    def fingerprint(self) -> str:
        raw = "|".join((self.rule, self.file, self.symbol))
        return hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]

    def location(self) -> str:
        return f"{self.file}:{self.line}" if self.line else self.file

    def to_dict(self) -> dict:
        return {
            "rule": self.rule, "file": self.file, "line": self.line,
            "symbol": self.symbol, "message": self.message,
            "hint": self.hint, "fingerprint": self.fingerprint,
        }


# --------------------------------------------------------------------------
# Rules


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    tier: str                 # "A" (AST) or "P" (plan)
    description: str
    fn: Callable[["AnalysisContext"], List[Finding]]


_RULES: Dict[str, Rule] = {}


def rule(id: str, title: str, tier: str, description: str):
    """Register a rule function ``fn(ctx) -> [Finding]`` under ``id``."""

    def deco(fn):
        if id in _RULES:
            raise ValueError(f"duplicate rule id {id}")
        _RULES[id] = Rule(id=id, title=title, tier=tier,
                          description=description, fn=fn)
        return fn

    return deco


def all_rules() -> Dict[str, Rule]:
    # Ensure the rule modules have been imported (registration side
    # effect) even when core is imported directly.
    from . import ast_rules, inventory, plan_rules, program_rules  # noqa: F401
    return dict(_RULES)


# --------------------------------------------------------------------------
# Settings + context


@dataclass
class AnalysisSettings:
    """Everything a rule keys off that tests may want to override (tests
    point these at a synthetic mini-package to prove each rule fires)."""

    # TPU101: package-relative module paths that form the device hot path
    # (one dispatch per batch / per fire): the port's counterparts of the
    # reference's list
    hot_path_modules: Tuple[str, ...] = (
        "runtime/operators/device_window.py",
        "runtime/operators/device_session.py",
        "runtime/stream_task.py",
        "sql/device_group_agg.py",
        "parallel/sharded_window.py",
        # tiered residency: policy, manager and pipeline take plain numpy
        # from the backend, which applies their decisions on the card
        "state/tiering/policy.py",
        "state/tiering/residency.py",
        "state/tiering/prefetch.py",
    )
    # TPU201: deploy entry points -> (module, qualname). A class entry
    # point means "somewhere in the class's transitive call graph".
    entry_points: Tuple[Tuple[str, str], ...] = (
        ("cluster/local.py", "run_job"),
        ("cluster/scheduler.py", "JobSupervisor"),
    )
    # TPU201: process-global singletons every deploy path must configure,
    # each with the NAME(s) whose ``.configure(...)`` call satisfies it;
    # FLIGHT_RECORDER is a reporter of TRACER, so TRACER.configure() wires
    # it too (metrics/tracing.py)
    singletons: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("FAULTS", ("FAULTS",)),
        ("WATCHDOG", ("WATCHDOG",)),
        ("TRACER", ("TRACER",)),
        ("FLIGHT_RECORDER", ("FLIGHT_RECORDER", "TRACER")),
        ("MESH_RUNTIME", ("MESH_RUNTIME",)),
        ("DEVICE_LEDGER", ("DEVICE_LEDGER",)),
        ("AOT", ("AOT",)),
    )
    # TPU501: span/tracing modules where time.time() is banned
    # (monotonic-anchored clock only: now_ms() in metrics/tracing.py)
    span_clock_modules: Tuple[str, ...] = (
        "metrics/tracing.py",
        "metrics/device.py",
        "metrics/profiler.py",
    )
    # TPU502: runtime module prefixes where unseeded RNG is banned
    # (replayability of fault schedules and recovery paths)
    runtime_rng_prefixes: Tuple[str, ...] = (
        "runtime/", "cluster/", "state/", "checkpoint/", "connectors/",
    )
    # TPU304: extra dotted literals that are legitimate despite sharing a
    # first segment with a config-option family (watchdog and fault sites
    # and scopes that are not config keys)
    extra_key_vocab: Tuple[str, ...] = (
        "checkpoint.storage",     # watchdog scope label
        "aot.warmup",             # watchdog site of the cache's warm-up
    )
    # JX502: modules whose device-plane allocations must not be float64
    device_plane_prefixes: Tuple[str, ...] = (
        "ops/", "state/", "parallel/", "runtime/operators/", "sql/",
    )
    # JX504: (module, class, method) of each in-memory program cache whose
    # key must be built from pointers and shapes, never tensor values
    program_caches: Tuple[Tuple[str, str, str], ...] = (
        ("runtime/compiled.py", "FusedChain", "run"),
    )
    # the directory of the documents the inventory rules compare against
    docs_dir: str = "flink_tpu_torch/docs"


_TAG_RE = re.compile(r"#\s*lint:\s*([a-z0-9-]+)\s*(.*)$")


class AnalysisContext:
    """Shared state for one lint run: file set, parsed ASTs, suppression
    comments, settings.  ``package_root`` is the directory containing
    the ``flink_tpu_torch`` package (i.e. the repo root)."""

    def __init__(self, package_root: Optional[Path] = None,
                 package_name: str = "flink_tpu_torch",
                 settings: Optional[AnalysisSettings] = None,
                 extra_files: Sequence[str] = ()):
        if package_root is None:
            package_root = Path(__file__).resolve().parent.parent.parent
        self.root = Path(package_root)
        self.package_name = package_name
        self.pkg_dir = self.root / package_name
        self.settings = settings or AnalysisSettings()
        self.extra_files = tuple(extra_files)
        self._sources: Dict[str, str] = {}
        self._trees: Dict[str, ast.Module] = {}
        self._suppressions: Dict[str, Dict[int, Tuple[str, str]]] = {}

    # -- file discovery ---------------------------------------------------

    def package_files(self) -> List[str]:
        """Repo-relative posix paths of every package .py file (analysis/
        itself excluded — the linter does not lint its own rule fixtures)
        plus ``extra_files`` that exist."""
        out = []
        for p in sorted(self.pkg_dir.rglob("*.py")):
            rel = p.relative_to(self.root).as_posix()
            if rel.startswith(f"{self.package_name}/analysis/"):
                continue
            out.append(rel)
        for extra in self.extra_files:
            if (self.root / extra).is_file():
                out.append(extra)
        return out

    def pkg_rel(self, rel: str) -> str:
        """Package-relative path -> repo-relative path."""
        return f"{self.package_name}/{rel}"

    def doc_rel(self, name: str) -> str:
        """A document of the docs directory, repo-relative."""
        return f"{self.settings.docs_dir}/{name}"

    def source(self, rel: str) -> str:
        if rel not in self._sources:
            self._sources[rel] = (self.root / rel).read_text()
        return self._sources[rel]

    def tree(self, rel: str) -> ast.Module:
        if rel not in self._trees:
            self._trees[rel] = ast.parse(self.source(rel), filename=rel)
        return self._trees[rel]

    # -- suppressions -----------------------------------------------------

    def _file_suppressions(self, rel: str) -> Dict[int, Tuple[str, str]]:
        if rel not in self._suppressions:
            table: Dict[int, Tuple[str, str]] = {}
            for i, line in enumerate(self.source(rel).splitlines(), 1):
                m = _TAG_RE.search(line)
                if m:
                    table[i] = (m.group(1), m.group(2).strip())
            self._suppressions[rel] = table
        return self._suppressions[rel]

    def suppression(self, rel: str, line: int, tag: str) -> Optional[str]:
        """Return the reason string if ``line`` (or the line above it)
        carries ``# lint: <tag> <reason>`` with a non-empty reason."""
        table = self._file_suppressions(rel)
        for ln in (line, line - 1):
            hit = table.get(ln)
            if hit and hit[0] == tag and hit[1]:
                return hit[1]
        return None


# --------------------------------------------------------------------------
# Running + baseline


def run_rules(ctx: AnalysisContext,
              rule_ids: Optional[Iterable[str]] = None,
              skipped: Optional[List[str]] = None) -> List[Finding]:
    """Run the selected rules (all by default) and return findings sorted
    by (file, line, rule).  Unknown rule ids raise ValueError."""
    rules = all_rules()
    if rule_ids is None:
        selected = list(rules.values())
    else:
        ids = list(rule_ids)
        unknown = [r for r in ids if r not in rules]
        if unknown:
            raise ValueError(f"unknown rule id(s): {', '.join(unknown)}")
        selected = [rules[r] for r in ids]
    findings: List[Finding] = []
    for r in selected:
        try:
            findings.extend(r.fn(ctx))
        except _RuleSkipped as e:
            if skipped is not None:
                skipped.append(f"{r.id}: {e}")
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.symbol))
    return findings


class _RuleSkipped(Exception):
    """Raised by a rule that cannot run in this environment (e.g. the plan
    rules with no certificate to read).  Reported as skipped, never as
    clean-by-accident when the caller asked to see skips."""


def skip_rule(reason: str) -> None:
    raise _RuleSkipped(reason)


def baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Optional[Path] = None) -> List[dict]:
    path = path or baseline_path()
    if not path.is_file():
        return []
    data = json.loads(path.read_text())
    return list(data.get("entries", []))


def save_baseline(findings: Sequence[Finding],
                  path: Optional[Path] = None,
                  previous: Optional[List[dict]] = None,
                  default_reason: Optional[str] = None) -> None:
    """Write the baseline for ``findings``; reasons from a previous
    baseline are preserved by fingerprint, new entries get
    ``default_reason`` or a TODO reason to be replaced by a justified one
    (the committed baseline holds only justified exceptions — BASE601
    flags entries still carrying the TODO)."""
    path = path or baseline_path()
    prev = {e["fingerprint"]: e for e in (previous
                                          if previous is not None
                                          else load_baseline(path))}
    entries = []
    for f in findings:
        old = prev.get(f.fingerprint)
        entries.append({
            "rule": f.rule, "file": f.file, "symbol": f.symbol,
            "fingerprint": f.fingerprint,
            "reason": (old or {}).get(
                "reason",
                default_reason or "TODO: justify this exception or fix it"),
        })
    path.write_text(json.dumps({"version": 1, "entries": entries},
                               indent=2, sort_keys=True) + "\n")


def diff_against_baseline(
        findings: Sequence[Finding],
        baseline: Optional[List[dict]] = None,
) -> Tuple[List[Finding], List[dict]]:
    """Split findings into (unbaselined, stale_baseline_entries).  Stale
    entries — baselined findings that no longer occur — are reported so
    the baseline shrinks as fixes land instead of rotting."""
    if baseline is None:
        baseline = load_baseline()
    known = {e["fingerprint"] for e in baseline}
    seen = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in known]
    stale = [e for e in baseline if e["fingerprint"] not in seen]
    return new, stale
