"""Program rules of the port (the counterpart of
``flink_tpu/analysis/jaxpr_rules.py``).

The reference re-traces every compiled program's jaxpr and lints the IR.
The port compiles no program from Python: its device work is hand-written
kernels (``csrc/``), PyTorch operators and one CUDA graph per fused
micro-batch length. So each reference program rule either becomes an AST
rule over the code that allocates device planes or keys a program cache,
or has no counterpart, listed in :data:`NOT_APPLICABLE` with its reason
(the catalogue of ``flink_tpu_torch/docs/ANALYSIS.md`` renders both).

* JX502 (float64 leak) becomes an AST rule: a device-plane allocation or
  cast to float64 in the state, ops, mesh, operator or SQL modules must
  say why (``# lint: f64-ok <reason>``).
* JX504 (value-keyed cache) becomes an AST rule over the in-memory
  program caches (``AnalysisSettings.program_caches``: the fused chain's
  graph cache): a cache key may be built from pointers and shapes only,
  never from a tensor's value.

The port's Tier B is the sync audit on the card (``chip_smoke.py``): a Q5
step and fire, a session step, a GROUP BY step and a mesh step under
``torch.cuda.set_sync_debug_mode``, every wait held to a ``sync-ok``
comment or a baseline entry of TPU101.
"""

from __future__ import annotations

import ast
from typing import List

from .ast_rules import _call_snippet, _dotted, _walk_with_qualname
from .core import AnalysisContext, Finding, rule

__all__ = ["NOT_APPLICABLE"]

#: reference rule -> why the port has no counterpart
NOT_APPLICABLE = {
    "TPU102": "collectives over declared mesh axes: the port's mesh runs "
              "no collective and names no axis (one process holds every "
              "shard; MESH_RUNTIME refuses a non-empty mesh.axis-rules)",
    "JX501": "scatter lowering on the fire path: the fire's scatters are "
             "hand kernels (window_seal, window_rebuild, hist256), no "
             "compiler lowers them",
    "JX503": "donation of large outputs: PyTorch writes the state planes "
             "in place, no program returns a copy to alias",
    "JX505": "sharded programs keyed by local shapes: the port's mesh "
             "compiles no program per shape; its kernels take any shape",
    "JX601": "a scatter-free fused-chain prelude: the chain's decode is "
             "the user's torch generator inside one CUDA graph, its step "
             "the hand ingest_step kernel",
    "JX602": "donation through the fused chain: the graph writes the "
             "state in place",
    "JX603": "a shape-only fused-chain cache key: JX504 holds the fused "
             "chain's graph key to pointers and shapes",
}

# --------------------------------------------------------------------------
# JX502 — float64 on a device plane

_ALLOCATORS = {"zeros", "ones", "empty", "full", "tensor", "as_tensor",
               "arange", "zeros_like", "ones_like", "empty_like",
               "full_like"}
_F64 = {"torch.float64", "torch.double"}


def _f64_kind(node: ast.Call) -> str:
    """"" or what the call does in float64."""
    dotted = _dotted(node.func) or ""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "double" and not node.args:
        return ".double()"
    dtype = [kw.value for kw in node.keywords if kw.arg == "dtype"]
    if isinstance(f, ast.Attribute) and f.attr == "to":
        dtype += list(node.args)
    elif not (dotted.startswith("torch.")
              and dotted.split(".")[-1] in _ALLOCATORS):
        return ""
    if any(_dotted(d) in _F64 for d in dtype):
        return f"{dotted.split('.')[-1] if dotted else 'call'}(float64)"
    return ""


@rule("JX502", "float64 on a device plane", "A",
      "float64 halves the card's arithmetic rate and doubles the bytes "
      "of every plane it sits in; the device planes are int/f32 unless "
      "the aggregate's exactness needs f64 — say so with "
      "'# lint: f64-ok <reason>'")
def f64_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    prefixes = tuple(ctx.pkg_rel(p) for p in
                     ctx.settings.device_plane_prefixes)
    for rel in ctx.package_files():
        if not rel.startswith(prefixes):
            continue
        try:
            tree = ctx.tree(rel)
        except (FileNotFoundError, SyntaxError):
            continue
        for node, qual in _walk_with_qualname(tree):
            if not isinstance(node, ast.Call):
                continue
            what = _f64_kind(node)
            if not what or ctx.suppression(rel, node.lineno, "f64-ok"):
                continue
            snippet = _call_snippet(ctx, rel, node)
            findings.append(Finding(
                rule="JX502", file=rel, line=node.lineno,
                symbol=f"{qual}:{snippet}",
                message=f"{what} on the device ({snippet})",
                hint="pin the plane's dtype (float32 / int64) or annotate "
                     "'# lint: f64-ok <reason>' where f64 is needed for "
                     "exactness"))
    return findings


# --------------------------------------------------------------------------
# JX504 — value-keyed program cache

#: calls a cache key may make: pointers and shapes, never values
_KEY_CALLS = {"data_ptr", "tuple", "len", "numel", "size", "element_size",
              "stride", "id", "str", "repr"}


@rule("JX504", "cache key derived from values, not shapes", "A",
      "an in-memory program cache (a CUDA graph per key) keyed on a "
      "tensor's VALUE captures anew for every value, and reads the value "
      "back with a host wait; keys are pointers, shapes and host ints")
def value_keyed_cache_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod, cls, meth in ctx.settings.program_caches:
        rel = ctx.pkg_rel(mod)
        try:
            tree = ctx.tree(rel)
        except FileNotFoundError:
            findings.append(Finding(
                rule="JX504", file=rel, line=0, symbol=f"{cls}.{meth}",
                message=f"declared program cache {cls}.{meth} not found",
                hint="update AnalysisSettings.program_caches"))
            continue
        fn = None
        for node, qual in _walk_with_qualname(tree):
            if (isinstance(node, ast.FunctionDef) and node.name == meth
                    and qual == cls):
                fn = node
        if fn is None:
            findings.append(Finding(
                rule="JX504", file=rel, line=0, symbol=f"{cls}.{meth}",
                message=f"declared program cache {cls}.{meth} not found",
                hint="update AnalysisSettings.program_caches"))
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.endswith("key")):
                continue
            for sub in ast.walk(node.value):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                name = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else "")
                if name in _KEY_CALLS:
                    continue
                if ctx.suppression(rel, sub.lineno, "key-value-ok"):
                    continue
                snippet = _call_snippet(ctx, rel, sub)
                findings.append(Finding(
                    rule="JX504", file=rel, line=sub.lineno,
                    symbol=f"{cls}.{meth}:{snippet}",
                    message=f"{cls}.{meth} builds its cache key with "
                            f"{name}() ({snippet}): a value, not a "
                            "pointer or a shape",
                    hint="key the cache on data_ptr(), shapes and host "
                         "ints; pass per-batch values through a device "
                         "buffer the graph reads"))
    return findings
