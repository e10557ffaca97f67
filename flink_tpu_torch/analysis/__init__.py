"""The port's lint: static analysis of the device-path invariants of
``flink_tpu_torch`` (port of ``flink_tpu/analysis``).

* Tier A: AST passes over the whole package: host-sync discipline in
  hot-path modules (PyTorch's host waits), singleton wiring on the deploy
  entry points, inventory locks (spans, fault sites, ledger sites, config
  keys against code and the port's docs), lock discipline, determinism
  (wall clock, unseeded RNG), and the program rules that replace the
  reference's jaxpr audit (float64 on device planes, value-keyed program
  caches).
* Tier P: the fusion certifier's PLAN6xx findings.
* Tier B is the sync audit on the card (``chip_smoke.py``).

Findings carry file:line, rule id and a fix hint, and diff against the
committed ``flink_tpu_torch/analysis/baseline.json``; every baseline entry
carries a reviewed reason. ``flink_tpu_torch/docs/ANALYSIS.md`` is the rule
catalogue, with the reference rules that have no counterpart and why.
"""

from .core import (  # noqa: F401
    AnalysisContext,
    AnalysisSettings,
    Finding,
    Rule,
    all_rules,
    baseline_path,
    diff_against_baseline,
    load_baseline,
    run_rules,
    rule,
    save_baseline,
)

# Importing the rule modules registers their rules.
from . import ast_rules  # noqa: F401,E402
from . import inventory  # noqa: F401,E402
from . import plan_rules  # noqa: F401,E402
from . import program_rules  # noqa: F401,E402
