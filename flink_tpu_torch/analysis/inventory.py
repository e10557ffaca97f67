"""Tier-A inventory-drift rules (TPU3xx) of the port: one mechanism
locking code literals <-> declared inventories <-> committed docs (port
of ``flink_tpu/analysis/inventory.py``). The documents are the port's own,
under ``flink_tpu_torch/docs/`` (``AnalysisSettings.docs_dir``): the span
and ledger-site tables of ``OBSERVABILITY.md``, the fault-site table of
``ROBUSTNESS.md`` and the generated ``CONFIG.md``.

Imports here touch only the port's torch-free modules (metrics.tracing,
metrics.profiler, runtime.faults, core.config).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from .core import AnalysisContext, Finding, rule

# --------------------------------------------------------------------------
# TPU301 — span inventory: code spans == SPAN_INVENTORY == OBSERVABILITY.md

_SPAN_CALL_RE = re.compile(r'\.span\(\s*"(\w+)",\s*"(\w+)"')
_SPAN_DOC_ROW = re.compile(r"^\| `(\w+)` \| `(\w+)` \|")


def _load_span_inventory(ctx: AnalysisContext):
    from ..metrics.tracing import SPAN_INVENTORY
    return SPAN_INVENTORY


@rule("TPU301", "span inventory drift", "A",
      "every TRACER.span(scope, name) literal must appear in "
      "SPAN_INVENTORY (metrics/tracing.py) and in the span table of "
      "the OBSERVABILITY.md, and vice versa — the inventory is the "
      "contract consumers filter traces by")
def span_inventory_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    inv_rel = ctx.pkg_rel("metrics/tracing.py")
    inventory = _load_span_inventory(ctx)
    inv_pairs = {(scope, name) for scope, name, _where in inventory}

    code_pairs: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for rel in ctx.package_files():
        if not rel.startswith(f"{ctx.package_name}/"):
            continue
        for i, line in enumerate(ctx.source(rel).splitlines(), 1):
            for m in _SPAN_CALL_RE.finditer(line):
                code_pairs.setdefault((m.group(1), m.group(2)), (rel, i))

    doc_rel = ctx.doc_rel("OBSERVABILITY.md")
    doc_pairs: Set[Tuple[str, str]] = set()
    doc_path = ctx.root / doc_rel
    if doc_path.is_file():
        for line in doc_path.read_text().splitlines():
            m = _SPAN_DOC_ROW.match(line)
            if m:
                doc_pairs.add((m.group(1), m.group(2)))
    else:
        findings.append(Finding(
            rule="TPU301", file=doc_rel, line=0, symbol=doc_rel,
            message=f"{doc_rel} missing", hint="restore it"))

    for pair, (rel, line) in sorted(code_pairs.items()):
        if pair not in inv_pairs:
            findings.append(Finding(
                rule="TPU301", file=rel, line=line,
                symbol=f"code-not-inventoried:{pair[0]}.{pair[1]}",
                message=f"span ({pair[0]}, {pair[1]}) emitted here but "
                        "missing from SPAN_INVENTORY",
                hint="add it to SPAN_INVENTORY in metrics/tracing.py "
                     "and to the the OBSERVABILITY.md table"))
    for scope, name, where in inventory:
        if (scope, name) not in code_pairs:
            findings.append(Finding(
                rule="TPU301", file=inv_rel, line=0,
                symbol=f"inventoried-not-in-code:{scope}.{name}",
                message=f"SPAN_INVENTORY lists ({scope}, {name}) but no "
                        "code emits it",
                hint="delete the stale inventory row (and its docs row)"))
        for cited in re.findall(r"[\w/]+\.py", where):
            if not (ctx.root / ctx.package_name / cited).is_file():
                findings.append(Finding(
                    rule="TPU301", file=inv_rel, line=0,
                    symbol=f"stale-citation:{scope}.{name}:{cited}",
                    message=f"SPAN_INVENTORY cites {cited} but "
                            f"{ctx.package_name}/{cited} does not exist",
                    hint="fix the 'where' citation"))
    if doc_pairs:
        for pair in sorted(inv_pairs - doc_pairs):
            findings.append(Finding(
                rule="TPU301", file=doc_rel, line=0,
                symbol=f"doc-missing:{pair[0]}.{pair[1]}",
                message=f"span ({pair[0]}, {pair[1]}) is inventoried but "
                        "missing from the the OBSERVABILITY.md table",
                hint="add the table row"))
        for pair in sorted(doc_pairs - inv_pairs):
            findings.append(Finding(
                rule="TPU301", file=doc_rel, line=0,
                symbol=f"doc-stale:{pair[0]}.{pair[1]}",
                message=f"the OBSERVABILITY.md lists span "
                        f"({pair[0]}, {pair[1]}) that is not inventoried",
                hint="delete the stale table row"))
    if list(inventory) != sorted(inventory):
        findings.append(Finding(
            rule="TPU301", file=inv_rel, line=0, symbol="unsorted",
            message="SPAN_INVENTORY is not sorted (scope, name)",
            hint="keep it sorted so diffs stay reviewable"))
    return findings


# --------------------------------------------------------------------------
# TPU302 — fault-site inventory: FAULT_SITES == code literals == docs

_SITE_DOC_ROW = re.compile(r"^\| `([a-z0-9_.-]+)` \|")


def _load_fault_sites(ctx: AnalysisContext):
    from ..runtime.faults import FAULT_SITES
    return FAULT_SITES


@rule("TPU302", "fault-site inventory drift", "A",
      "every FAULTS.fire/check site literal must be a declared "
      "FAULT_SITES member, every declared site must be threaded "
      "somewhere in code, and the the ROBUSTNESS.md fault-site table "
      "must list exactly the declared sites")
def fault_site_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    sites_rel = ctx.pkg_rel("runtime/faults.py")
    declared = tuple(_load_fault_sites(ctx))
    declared_set = set(declared)

    fire_re = re.compile(
        r'(?:FAULTS\.(?:fire|check)|fire_with_retries)\(\s*"([^"]+)"')
    used: Dict[str, Tuple[str, int]] = {}
    literals: Set[str] = set()
    for rel in ctx.package_files():
        src = ctx.source(rel)
        for i, line in enumerate(src.splitlines(), 1):
            for m in fire_re.finditer(line):
                used.setdefault(m.group(1), (rel, i))
        for m in re.finditer(r'"([a-z0-9_.-]+)"', src):
            literals.add(m.group(1))

    for site, (rel, line) in sorted(used.items()):
        if site not in declared_set:
            findings.append(Finding(
                rule="TPU302", file=rel, line=line,
                symbol=f"undeclared-site:{site}",
                message=f"fault site '{site}' fired here but not in "
                        "FAULT_SITES (FaultRule.parse would reject a "
                        "rule targeting it)",
                hint="add it to FAULT_SITES in runtime/faults.py and to "
                     "the the ROBUSTNESS.md table"))
    for site in declared:
        if site not in literals:
            findings.append(Finding(
                rule="TPU302", file=sites_rel, line=0,
                symbol=f"unthreaded-site:{site}",
                message=f"FAULT_SITES declares '{site}' but no code "
                        "references it",
                hint="thread the site or delete the declaration"))

    doc_rel = ctx.doc_rel("ROBUSTNESS.md")
    doc_path = ctx.root / doc_rel
    if doc_path.is_file():
        text = doc_path.read_text()
        section = text.split("## Fault sites", 1)
        doc_sites: Set[str] = set()
        if len(section) == 2:
            for line in section[1].split("\n## ", 1)[0].splitlines():
                m = _SITE_DOC_ROW.match(line)
                if m and m.group(1) != "Site":
                    doc_sites.add(m.group(1))
        for site in sorted(declared_set - doc_sites):
            findings.append(Finding(
                rule="TPU302", file=doc_rel, line=0,
                symbol=f"doc-missing:{site}",
                message=f"fault site '{site}' missing from the "
                        "the ROBUSTNESS.md fault-site table",
                hint="add the table row"))
        for site in sorted(doc_sites - declared_set):
            findings.append(Finding(
                rule="TPU302", file=doc_rel, line=0,
                symbol=f"doc-stale:{site}",
                message=f"the ROBUSTNESS.md lists fault site '{site}' "
                        "that FAULT_SITES does not declare",
                hint="delete the stale table row"))
    else:
        findings.append(Finding(
            rule="TPU302", file=doc_rel, line=0, symbol=doc_rel,
            message=f"{doc_rel} missing", hint="restore it"))
    return findings


# --------------------------------------------------------------------------
# TPU303 — committed config docs must be freshly generated


@rule("TPU303", "config docs stale", "A",
      "flink_tpu_torch/docs/CONFIG.md is generated from the port's keys "
      "(core/config.py generate_config_docs); a hand edit or a key added "
      "without regenerating makes the committed docs lie")
def config_docs_rule(ctx: AnalysisContext) -> List[Finding]:
    from ..core.config import all_options, generate_config_docs
    findings: List[Finding] = []
    doc_rel = ctx.doc_rel("CONFIG.md")
    expected = generate_config_docs()
    for key in all_options():
        n = expected.count(f"| `{key}` |")
        if n != 1:
            findings.append(Finding(
                rule="TPU303", file=doc_rel, line=0,
                symbol=f"coverage:{key}",
                message=f"option {key} has {n} table rows in the "
                        "generated docs (want exactly 1)",
                hint="fix generate_config_docs"))
    doc_path = ctx.root / doc_rel
    if not doc_path.is_file() or doc_path.read_text() != expected:
        findings.append(Finding(
            rule="TPU303", file=doc_rel, line=0, symbol="stale",
            message=f"{doc_rel} does not match generate_config_docs() "
                    "output",
            hint="regenerate it from flink_tpu_torch.core.config."
                 "generate_config_docs()"))
    return findings


# --------------------------------------------------------------------------
# TPU305 — ledger-site inventory: code literals == LEDGER_SITE_INVENTORY
# == the "### Ledger sites" table of the OBSERVABILITY.md

# Sites appear as a timed dispatch's open or as a direct ledger record;
# both calls wrap arguments, so these run against the whole source (\s*
# crosses the line break after the open paren).
_LEDGER_SITE_RE = re.compile(
    r'DEVICE_LEDGER\.(?:begin|record)\(\s*'
    r'"([a-z0-9_.]+)"')
_LEDGER_DOC_ROW = re.compile(r"^\| `([a-z0-9_.]+)` \|")


def _load_ledger_inventory(ctx: AnalysisContext):
    from ..metrics.profiler import LEDGER_SITE_INVENTORY
    return LEDGER_SITE_INVENTORY


@rule("TPU305", "ledger-site inventory drift", "A",
      "every DEVICE_LEDGER.begin / DEVICE_LEDGER.record site literal "
      "must appear in LEDGER_SITE_INVENTORY "
      "(metrics/profiler.py) and in the ledger-site table of "
      "the OBSERVABILITY.md, and vice versa — the inventory is the "
      "contract profile consumers attribute device time by")
def ledger_site_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    inv_rel = ctx.pkg_rel("metrics/profiler.py")
    inventory = _load_ledger_inventory(ctx)
    inv_sites = {site for site, _where in inventory}

    code_sites: Dict[str, Tuple[str, int]] = {}
    for rel in ctx.package_files():
        src = ctx.source(rel)
        for m in _LEDGER_SITE_RE.finditer(src):
            line = src.count("\n", 0, m.start()) + 1
            code_sites.setdefault(m.group(1), (rel, line))

    doc_rel = ctx.doc_rel("OBSERVABILITY.md")
    doc_sites: Set[str] = set()
    doc_path = ctx.root / doc_rel
    if doc_path.is_file():
        section = doc_path.read_text().split("### Ledger sites", 1)
        if len(section) == 2:
            for line in section[1].split("\n#", 1)[0].splitlines():
                m = _LEDGER_DOC_ROW.match(line)
                if m:
                    doc_sites.add(m.group(1))
    else:
        findings.append(Finding(
            rule="TPU305", file=doc_rel, line=0, symbol=doc_rel,
            message=f"{doc_rel} missing", hint="restore it"))

    for site, (rel, line) in sorted(code_sites.items()):
        if site not in inv_sites:
            findings.append(Finding(
                rule="TPU305", file=rel, line=line,
                symbol=f"code-not-inventoried:{site}",
                message=f"ledger site '{site}' recorded here but missing "
                        "from LEDGER_SITE_INVENTORY",
                hint="add it to LEDGER_SITE_INVENTORY in "
                     "metrics/profiler.py and to the the OBSERVABILITY.md "
                     "ledger-site table"))
    for site, where in inventory:
        if site not in code_sites:
            findings.append(Finding(
                rule="TPU305", file=inv_rel, line=0,
                symbol=f"inventoried-not-in-code:{site}",
                message=f"LEDGER_SITE_INVENTORY lists '{site}' but no "
                        "code records it",
                hint="delete the stale inventory row (and its docs row)"))
        for cited in re.findall(r"[\w/]+\.py", where):
            if not (ctx.root / ctx.package_name / cited).is_file():
                findings.append(Finding(
                    rule="TPU305", file=inv_rel, line=0,
                    symbol=f"stale-citation:{site}:{cited}",
                    message=f"LEDGER_SITE_INVENTORY cites {cited} but "
                            f"{ctx.package_name}/{cited} does not exist",
                    hint="fix the 'where' citation"))
    if doc_path.is_file():
        if not doc_sites:
            findings.append(Finding(
                rule="TPU305", file=doc_rel, line=0,
                symbol="section-missing",
                message="the OBSERVABILITY.md has no '### Ledger sites' "
                        "table",
                hint="add the section (see LEDGER_SITE_INVENTORY)"))
        else:
            for site in sorted(inv_sites - doc_sites):
                findings.append(Finding(
                    rule="TPU305", file=doc_rel, line=0,
                    symbol=f"doc-missing:{site}",
                    message=f"ledger site '{site}' is inventoried but "
                            "missing from the the OBSERVABILITY.md "
                            "ledger-site table",
                    hint="add the table row"))
            for site in sorted(doc_sites - inv_sites):
                findings.append(Finding(
                    rule="TPU305", file=doc_rel, line=0,
                    symbol=f"doc-stale:{site}",
                    message=f"the OBSERVABILITY.md lists ledger site "
                            f"'{site}' that is not inventoried",
                    hint="delete the stale table row"))
    if list(inventory) != sorted(inventory):
        findings.append(Finding(
            rule="TPU305", file=inv_rel, line=0, symbol="unsorted",
            message="LEDGER_SITE_INVENTORY is not sorted by site",
            hint="keep it sorted so diffs stay reviewable"))
    return findings


# --------------------------------------------------------------------------
# TPU304 — config-key literals must resolve to declared options

_KEYISH_RE = re.compile(r"^[a-z][a-z0-9-]*(\.[a-z0-9-]+)+$")
_SITEISH_KWARGS = {"scope", "site"}


def _config_vocab(ctx: AnalysisContext) -> Tuple[Set[str], Set[str]]:
    from ..core.config import all_options
    from ..runtime.faults import FAULT_SITES
    keys = set(all_options())
    vocab = set(keys) | set(FAULT_SITES) | set(ctx.settings.extra_key_vocab)
    families = {k.split(".")[0] for k in keys}
    return vocab, families


def _exempt_constants(tree: ast.Module) -> Set[int]:
    """ids of string Constant nodes used as watchdog/fault SITE labels
    (scope=/site= kwargs or first arg of run/fire/check/deadline_for/
    stall_bounded/fire_with_retries) — sites are an open namespace, not
    config keys."""
    exempt: Set[int] = set()
    site_fns = {"run", "fire", "check", "fire_with_retries",
                "stall_bounded", "deadline_for", "trip", "StallError",
                "note_stall", "note_verify_failure",
                "note_restore_fallback",
                # ledger sites ("mesh.step", ...) are an open namespace
                # of dispatch sites, not config keys
                "begin", "record", "note_build"}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg in _SITEISH_KWARGS and isinstance(kw.value,
                                                        ast.Constant):
                exempt.add(id(kw.value))
        fname = None
        f = node.func
        if isinstance(f, ast.Attribute):
            fname = f.attr
        elif isinstance(f, ast.Name):
            fname = f.id
        if fname in site_fns and node.args and \
                isinstance(node.args[0], ast.Constant):
            exempt.add(id(node.args[0]))
    return exempt


@rule("TPU304", "config-key literal not declared", "A",
      "a dotted literal whose first segment matches a config-option "
      "family but that is not a declared key is a typo waiting to "
      "silently fall back to defaults (config.set/get never validates "
      "free-form keys)")
def config_key_literal_rule(ctx: AnalysisContext) -> List[Finding]:
    vocab, families = _config_vocab(ctx)
    findings: List[Finding] = []
    for rel in ctx.package_files():
        try:
            tree = ctx.tree(rel)
        except (FileNotFoundError, SyntaxError):
            continue
        exempt = _exempt_constants(tree)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            val = node.value
            if not _KEYISH_RE.match(val):
                continue
            if val.split(".")[0] not in families:
                continue
            if val in vocab or id(node) in exempt:
                continue
            # prefix strings used for startswith()-style family matches
            if any(k.startswith(val + ".") or k == val for k in vocab):
                continue
            if ctx.suppression(rel, node.lineno, "key-ok"):
                continue
            findings.append(Finding(
                rule="TPU304", file=rel, line=node.lineno,
                symbol=f"key:{val}",
                message=f"'{val}' looks like a config key (family "
                        f"'{val.split('.')[0]}') but no such option is "
                        "declared in core/config.py DEFAULTS",
                hint="fix the typo, declare the option, or annotate "
                     "'# lint: key-ok <reason>' if it is not a config "
                     "key"))
    return findings
