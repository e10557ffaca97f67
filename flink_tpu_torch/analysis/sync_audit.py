"""Tier B of the port's lint: hold the host waits seen on the card to the
waits the code names.

On the card, ``chip_smoke.py`` runs a Q5 step and fire, a session step, a
GROUP BY step and a mesh step under ``torch.cuda.set_sync_debug_mode``
(``implicit_syncs``), which reports the file and line of every operation
that made the host wait. A wait in the package is *named* when its line,
or the line above it, carries ``# lint: sync-ok <reason>``, or when it is
the line of a TPU101 finding held in the committed baseline (matched by
fingerprint, so the baseline's reason is the wait's). Every other wait in
the package is a finding. On the CPU the debug mode sees nothing; the CPU
tests cover this mapping on made-up wait lists.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .ast_rules import sync_findings
from .core import AnalysisContext, load_baseline

__all__ = ["named_waits", "audit_waits"]


def named_waits(ctx: Optional[AnalysisContext] = None
                ) -> Dict[str, Dict[int, str]]:
    """Repo-relative file -> {line: reason} of every wait the package
    names: the line of a ``sync-ok`` comment and the line after it, and
    the lines of baselined TPU101 findings (over every module, not only
    the hot-path ones)."""
    ctx = ctx or AnalysisContext()
    baseline = {e["fingerprint"]: e.get("reason", "")
                for e in load_baseline() if e.get("rule") == "TPU101"}
    out: Dict[str, Dict[int, str]] = {}
    for rel in ctx.package_files():
        lines: Dict[int, str] = {}
        for ln, (tag, reason) in ctx._file_suppressions(rel).items():
            if tag == "sync-ok" and reason:
                lines.setdefault(ln, reason)
                lines.setdefault(ln + 1, reason)
        try:
            tree = ctx.tree(rel)
        except SyntaxError:
            tree = None
        if tree is not None:
            for f in sync_findings(ctx, rel, tree, suppress=False):
                if f.fingerprint in baseline:
                    lines.setdefault(f.line, baseline[f.fingerprint])
        if lines:
            out[rel] = lines
    return out


def audit_waits(waits: List[str], ctx: Optional[AnalysisContext] = None
                ) -> dict:
    """Sort the waits ``implicit_syncs`` reported (``"<file>:<line>"``,
    repo-relative for files of the checkout) into ``named`` ({wait:
    reason}), ``unnamed`` (waits in the package that nothing names: the
    audit's findings) and ``outside`` (waits reported in files outside
    the package: the calling script's own, a library's)."""
    ctx = ctx or AnalysisContext()
    names = named_waits(ctx)
    prefix = f"{ctx.package_name}/"
    named: Dict[str, str] = {}
    unnamed: List[str] = []
    outside: List[str] = []
    for w in sorted(set(waits)):
        loc = w.split(" ", 1)[0]
        file, _, line = loc.rpartition(":")
        if not file.startswith(prefix) or not line.isdigit():
            outside.append(w)
            continue
        reason = names.get(file, {}).get(int(line))
        if reason is None:
            unnamed.append(w)
        else:
            named[w] = reason
    return {"named": named, "unnamed": unnamed, "outside": outside}
