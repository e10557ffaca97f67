"""Tier-A AST rules of the port: host-sync discipline, singleton wiring,
lock discipline and determinism (port of
``flink_tpu/analysis/ast_rules.py``). Pure stdlib ``ast``: no torch
import.

Rule ids follow the reference's TPU<family><n>: 1xx device/host
boundary, 2xx wiring, 4xx concurrency, 5xx determinism (3xx inventory
rules live in inventory.py, the program rules in program_rules.py).
TPU101 flags PyTorch's host waits; TPU502 flags PyTorch's unseeded RNG
too. TPU102 (collectives over declared mesh axes) has no counterpart:
the port's mesh runs no collective and names no axis
(``program_rules.NOT_APPLICABLE``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import AnalysisContext, Finding, rule

# --------------------------------------------------------------------------
# Shared AST helpers


def _walk_with_qualname(tree: ast.Module):
    """Yield (node, qualname_of_enclosing_def) for every node, where
    qualname is e.g. 'Class.method' ('<module>' at module level).
    Nested defs (closures inside a method) keep the OUTER def's qualname
    suffix chain so findings anchor to a greppable symbol."""
    def visit(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                yield child, ".".join(stack) or "<module>"
                yield from visit(child, stack + [child.name])
            else:
                yield child, ".".join(stack) or "<module>"
                yield from visit(child, stack)

    yield from visit(tree, [])


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_snippet(ctx: AnalysisContext, rel: str, node: ast.AST) -> str:
    seg = ast.get_source_segment(ctx.source(rel), node) or ""
    return " ".join(seg.split())[:120]


# --------------------------------------------------------------------------
# TPU101 — host-sync in hot-path modules

_SYNC_WRAPPERS = {"float", "int", "bool"}
_SYNC_NP_FUNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_DEVICE_TOKEN = re.compile(r"(^|_)dev(ice)?(_|$|s$)")
#: tensor methods that make the host wait for the card
_SYNC_METHODS = {"item", "tolist", "numpy", "nonzero"}
_SYNC_CALLS = {"torch.cuda.synchronize", "torch.nonzero"}
_NP_NONZERO = {"np.nonzero", "numpy.nonzero"}


def _mentions_device_value(node: ast.AST) -> bool:
    """Heuristic: does any identifier in this expression look like a
    device-resident value (…_dev, device_…, …_device, devices)?  Plain
    host numpy locals ('ts', 'counts', …) do not match, which keeps
    int(ts.min()) on host arrays out of scope."""
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name and _DEVICE_TOKEN.search(name):
            return True
    return False


def _calls_torch(node: ast.AST) -> bool:
    """Does the expression call a ``torch.`` function (its value is a
    tensor)?"""
    return any(isinstance(sub, ast.Call)
               and (_dotted(sub.func) or "").startswith("torch.")
               for sub in ast.walk(node))


def _non_blocking(node: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords)


def _to_host(node: ast.Call) -> bool:
    """``.to("cpu")`` / ``.to(torch.device("cpu"))`` / ``.to(device=
    "cpu")``."""
    args = list(node.args) + [kw.value for kw in node.keywords
                              if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and _dotted(a.func) == "torch.device"
                and a.args and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False


def _sync_kind(node: ast.Call) -> str:
    """What host wait ``node`` is, or "" for none."""
    dotted = _dotted(node.func)
    f = node.func
    if dotted in ("jax.device_get",) or (
            dotted and dotted.endswith(".device_get")):
        return "jax.device_get"
    if dotted in _SYNC_CALLS:
        return f"{dotted}()"
    if isinstance(f, ast.Attribute):
        if (f.attr in _SYNC_METHODS and dotted not in _NP_NONZERO
                and (f.attr == "nonzero" or not node.args)):
            return f".{f.attr}()"
        if f.attr == "cpu" and not _non_blocking(node):
            return ".cpu()"
        if f.attr == "to" and _to_host(node) and not _non_blocking(node):
            return ".to(cpu)"
    if (isinstance(f, ast.Name) and f.id in _SYNC_WRAPPERS and node.args
            and (_mentions_device_value(node.args[0])
                 or _calls_torch(node.args[0]))):
        return f"{f.id}()"
    if (dotted in _SYNC_NP_FUNCS and node.args
            and _mentions_device_value(node.args[0])):
        return dotted
    return ""


@rule("TPU101", "host-sync in hot path", "A",
      "a host wait on a device value inside a hot-path module: "
      ".item()/.tolist()/.numpy(), .cpu() or .to('cpu') without "
      "non_blocking, .nonzero(), torch.cuda.synchronize(), "
      "float()/int()/bool() of a tensor, np.asarray() of a device value; "
      "each forces a device->host sync per call; annotate deliberate "
      "syncs with '# lint: sync-ok <reason>'")
def host_sync_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.settings.hot_path_modules:
        rel = ctx.pkg_rel(mod)
        try:
            tree = ctx.tree(rel)
        except FileNotFoundError:
            continue
        findings.extend(sync_findings(ctx, rel, tree))
    return findings


def sync_findings(ctx: AnalysisContext, rel: str, tree: ast.Module,
                  suppress: bool = True) -> List[Finding]:
    """TPU101's findings in one module (``suppress=False``: sync-ok lines
    too, which the card's sync audit maps its waits onto)."""
    findings: List[Finding] = []
    flagged = []
    for node, qual in _walk_with_qualname(tree):
        if not isinstance(node, ast.Call):
            continue
        what = _sync_kind(node)
        if what:
            flagged.append((node, qual, what))
    # int(x.item()) / x.cpu().numpy() is ONE sync: report the outermost
    # call only, not the nested one a second time
    inner = set()
    for node, _q, _w in flagged:
        for sub in ast.walk(node):
            if sub is not node and isinstance(sub, ast.Call):
                inner.add(id(sub))
    for node, qual, what in flagged:
        if id(node) in inner:
            continue
        if suppress and ctx.suppression(rel, node.lineno, "sync-ok"):
            continue
        snippet = _call_snippet(ctx, rel, node)
        findings.append(Finding(
            rule="TPU101", file=rel, line=node.lineno,
            symbol=f"{qual}:{snippet}",
            message=f"{what} on a device value in hot-path module "
                    f"({snippet})",
            hint="keep the value on the device (torch ops / device "
                 "accumulators, a non-blocking copy behind an event) or, "
                 "if this sync is deliberate and amortized, annotate "
                 "'# lint: sync-ok <reason>'"))
    return findings


# --------------------------------------------------------------------------
# TPU201 — singleton wiring on deploy entry points


class _ModuleIndex:
    """Per-module call-graph facts: function/method bodies, the
    singletons each configures, the local+imported callees each calls."""

    def __init__(self, ctx: AnalysisContext, rel: str):
        self.rel = rel
        self.defs: Dict[str, ast.AST] = {}           # qualname -> def node
        self.class_methods: Dict[str, List[str]] = {}
        self.imports: Dict[str, Tuple[str, str]] = {}  # name -> (mod_rel, name)
        tree = ctx.tree(rel)
        pkg = ctx.package_name
        # import resolution: `from .local import deploy_local` etc.
        mod_dir = "/".join(rel.split("/")[:-1])
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level >= 0:
                target = self._resolve_from(ctx, rel, mod_dir, node, pkg)
                if target:
                    for alias in node.names:
                        self.imports[alias.asname or alias.name] = (
                            target, alias.name)
        for node, qual in _walk_with_qualname(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{qual}.{node.name}" if qual != "<module>" \
                    else node.name
                self.defs[name] = node
                if qual != "<module>" and "." not in qual:
                    self.class_methods.setdefault(qual, []).append(name)

    @staticmethod
    def _resolve_from(ctx, rel, mod_dir, node: ast.ImportFrom, pkg):
        """Best-effort: map an import-from to a repo-relative module
        path inside the package (None for stdlib / external)."""
        if node.level:  # relative import
            base = rel.split("/")[:-1]
            up = node.level - 1
            if up:
                base = base[:-up] if up <= len(base) else []
            mod = node.module.split(".") if node.module else []
            parts = base + mod
        else:
            if not node.module or not node.module.startswith(pkg):
                return None
            parts = node.module.split(".")
        cand = "/".join(parts) + ".py"
        if (ctx.root / cand).is_file():
            return cand
        cand = "/".join(parts) + "/__init__.py"
        if (ctx.root / cand).is_file():
            return cand
        return None


def _fn_facts(fn_node: ast.AST) -> Tuple[Set[str], Set[str], Set[str]]:
    """(configured_names, called_locals, called_self_methods) within one
    def body (nested defs included — closures run on behalf of the
    caller)."""
    configured: Set[str] = set()
    called: Set[str] = set()
    self_calls: Set[str] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "configure":
                base = _dotted(f.value)
                if base:
                    configured.add(base.split(".")[-1])
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                self_calls.add(f.attr)
            else:
                called.add(f.attr)
        elif isinstance(f, ast.Name):
            called.add(f.id)
    return configured, called, self_calls


@rule("TPU201", "deploy path misses a singleton configure", "A",
      "every deploy entry point must (transitively) call "
      "X.configure(config) for each registered process-global — an "
      "unwired FAULTS/WATCHDOG/MESH_RUNTIME/DEVICE_LEDGER/AOT silently "
      "degrades fault injection, stall supervision, the mesh's rules, "
      "device-time attribution or the build cache")
def singleton_wiring_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    indexes: Dict[str, _ModuleIndex] = {}

    def index(rel: str) -> Optional[_ModuleIndex]:
        if rel not in indexes:
            try:
                indexes[rel] = _ModuleIndex(ctx, rel)
            except FileNotFoundError:
                return None
        return indexes[rel]

    def reachable_configured(rel: str, qual: str,
                             seen: Set[Tuple[str, str]]) -> Set[str]:
        """BFS over the package-local call graph from (module, qualname)
        collecting every singleton name whose .configure() is called."""
        out: Set[str] = set()
        work = [(rel, qual)]
        while work:
            mrel, q = work.pop()
            if (mrel, q) in seen:
                continue
            seen.add((mrel, q))
            idx = index(mrel)
            if idx is None:
                continue
            # A class entry point means the union over its methods.
            if q in idx.class_methods:
                for meth in idx.class_methods[q]:
                    work.append((mrel, meth))
                continue
            fn = idx.defs.get(q)
            if fn is None:
                continue
            configured, called, self_calls = _fn_facts(fn)
            out |= configured
            cls = q.split(".")[0] if "." in q else None
            for meth in self_calls:
                if cls and f"{cls}.{meth}" in idx.defs:
                    work.append((mrel, f"{cls}.{meth}"))
            for name in called:
                if name in idx.defs:
                    work.append((mrel, name))
                elif name in idx.imports:
                    tgt_rel, tgt_name = idx.imports[name]
                    work.append((tgt_rel, tgt_name))
        return out

    for mod, qual in ctx.settings.entry_points:
        rel = ctx.pkg_rel(mod)
        idx = index(rel)
        if idx is None or (qual not in idx.defs
                           and qual not in idx.class_methods):
            findings.append(Finding(
                rule="TPU201", file=rel, line=0, symbol=qual,
                message=f"declared deploy entry point {qual} not found",
                hint="update AnalysisSettings.entry_points"))
            continue
        configured = reachable_configured(rel, qual, set())
        node = idx.defs.get(qual)
        line = getattr(node, "lineno", 0) if node else 0
        if not line and qual in idx.class_methods:
            for n in ast.walk(ctx.tree(rel)):
                if isinstance(n, ast.ClassDef) and n.name == qual:
                    line = n.lineno
                    break
        for singleton, accepted in ctx.settings.singletons:
            if not any(a in configured for a in accepted):
                findings.append(Finding(
                    rule="TPU201", file=rel, line=line,
                    symbol=f"{qual}:{singleton}",
                    message=f"deploy entry point {qual} never configures "
                            f"{singleton} (accepted via "
                            f"{'/'.join(accepted)}.configure)",
                    hint=f"call {accepted[0]}.configure(config) on this "
                         "deploy path (see cluster/local.py deploy_local "
                         "for the canonical wiring block)"))
    return findings


# --------------------------------------------------------------------------
# TPU401 — lock discipline on classes owning _lock

_MUTATING_METHODS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "clear",
    "update", "add", "discard", "appendleft", "setdefault",
}


def _self_attr(node: ast.AST) -> Optional[str]:
    """self.X -> 'X'; self.X[...] -> 'X'; else None."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _class_lock_findings(ctx: AnalysisContext, rel: str,
                         cls: ast.ClassDef) -> List[Finding]:
    owns_lock = False
    for node in ast.walk(cls):
        attr = None
        if isinstance(node, ast.Assign) and node.targets:
            attr = _self_attr(node.targets[0])
        if attr == "_lock":
            owns_lock = True
            break
    if not owns_lock:
        return []

    # Pass 1: which attrs does this class EVER mutate under the lock?
    # Only those are treated as lock-protected; attrs that are never
    # guarded anywhere (init-once config, etc.) stay out of scope, which
    # keeps the rule precise instead of flagging every assignment.
    guarded: Set[str] = set()
    mutations: List[Tuple[str, int, str, bool]] = []  # attr, line, meth, locked

    def scan(node, in_lock: bool, meth: str):
        if isinstance(node, ast.With):
            locked = in_lock or any(
                (_dotted(item.context_expr) or "").endswith("._lock")
                or (isinstance(item.context_expr, ast.Call)
                    and (_dotted(item.context_expr.func) or "")
                    .endswith("._lock"))
                for item in node.items)
            for child in node.body:
                scan(child, locked, meth)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested def: a closure body runs later, possibly without
            # the lock — treat it as its own (unlocked) scope.
            for child in ast.iter_child_nodes(node):
                scan(child, False, meth)
            return
        attr = None
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr:
                    mutations.append((attr, node.lineno, meth, in_lock))
                    if in_lock:
                        guarded.add(attr)
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in _MUTATING_METHODS):
                attr = _self_attr(f.value)
                if attr:
                    mutations.append((attr, node.lineno, meth, in_lock))
                    if in_lock:
                        guarded.add(attr)
        for child in ast.iter_child_nodes(node):
            scan(child, in_lock, meth)

    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # the `_locked` suffix is the caller-holds-the-lock
            # convention (e.g. _verified_candidate_locked)
            held = item.name.endswith("_locked")
            for child in item.body:
                scan(child, held, item.name)

    findings: List[Finding] = []
    seen: Set[Tuple[str, int]] = set()
    for attr, line, meth, locked in mutations:
        if locked or attr not in guarded or attr == "_lock":
            continue
        if meth == "__init__":
            continue  # construction happens-before publication
        if (attr, line) in seen:
            continue
        seen.add((attr, line))
        if ctx.suppression(rel, line, "lock-ok"):
            continue
        findings.append(Finding(
            rule="TPU401", file=rel, line=line,
            symbol=f"{cls.name}.{meth}:{attr}",
            message=f"{cls.name}.{meth} mutates self.{attr} outside "
                    f"'with self._lock' but the class guards that attr "
                    f"elsewhere",
            hint="move the mutation under the lock, or annotate "
                 "'# lint: lock-ok <reason>' if single-threaded by "
                 "construction"))
    return findings


@rule("TPU401", "un-locked mutation in a lock-owning class", "A",
      "classes that own a _lock must mutate their lock-guarded "
      "attributes under 'with self._lock' — a torn read on the scrape "
      "or checkpoint path is silent corruption")
def lock_discipline_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for rel in ctx.package_files():
        try:
            tree = ctx.tree(rel)
        except (FileNotFoundError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_class_lock_findings(ctx, rel, node))
    return findings


# --------------------------------------------------------------------------
# TPU402 — module-level mutable containers need a guard annotation

_CONTAINER_CALLS = {"dict", "list", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter"}


@rule("TPU402", "unguarded module-level mutable container", "A",
      "a module-level dict/list/set/deque mutated from more than one "
      "function is cross-thread shared state; it needs a lock or an "
      "explicit '# lint: guarded-by <reason>' annotation at its "
      "definition")
def global_guard_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for rel in ctx.package_files():
        try:
            tree = ctx.tree(rel)
        except (FileNotFoundError, SyntaxError):
            continue
        # module-level containers
        containers: Dict[str, int] = {}
        for node in tree.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            v = node.value
            is_container = (
                isinstance(v, (ast.Dict, ast.List, ast.Set))
                or (isinstance(v, ast.Call)
                    and (_dotted(v.func) or "").split(".")[-1]
                    in _CONTAINER_CALLS))
            if is_container:
                containers[tgt.id] = node.lineno
        if not containers:
            continue
        # functions that mutate each container (module-level decorator
        # registration at import time is single-threaded and exempt)
        mutators: Dict[str, Set[str]] = {name: set() for name in containers}
        for node, qual in _walk_with_qualname(tree):
            if qual == "<module>":
                continue
            name = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name):
                        name = t.value.id
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in _MUTATING_METHODS
                        and isinstance(f.value, ast.Name)):
                    name = f.value.id
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name):
                        name = t.value.id
            if name in mutators:
                mutators[name].add(qual)
        for name, funcs in mutators.items():
            if len(funcs) < 2:
                continue
            line = containers[name]
            if ctx.suppression(rel, line, "guarded-by"):
                continue
            findings.append(Finding(
                rule="TPU402", file=rel, line=line, symbol=name,
                message=f"module-level container {name} is mutated from "
                        f"{len(funcs)} functions "
                        f"({', '.join(sorted(funcs)[:4])}) with no guard "
                        "annotation",
                hint="protect it with a lock or annotate the definition "
                     "'# lint: guarded-by <reason>' (e.g. GIL-atomic "
                     "deque ops, import-time only)"))
    return findings


# --------------------------------------------------------------------------
# TPU501 — wall clock in span/tracing paths


@rule("TPU501", "time.time() in a span/tracing module", "A",
      "span timestamps must come from the monotonic-anchored clock "
      "(now_ms in metrics/tracing.py) so traces stay ordered under NTP "
      "steps; raw time.time() breaks cross-host span ordering")
def wall_clock_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for mod in ctx.settings.span_clock_modules:
        rel = ctx.pkg_rel(mod)
        try:
            tree = ctx.tree(rel)
        except FileNotFoundError:
            continue
        for node, qual in _walk_with_qualname(tree):
            if not isinstance(node, ast.Call):
                continue
            if _dotted(node.func) != "time.time":
                continue
            if ctx.suppression(rel, node.lineno, "wall-clock-ok"):
                continue
            findings.append(Finding(
                rule="TPU501", file=rel, line=node.lineno,
                symbol=f"{qual}:time.time",
                message=f"time.time() in span path ({qual})",
                hint="use now_ms() (monotonic-anchored) from "
                     "flink_tpu_torch.metrics.tracing, or annotate "
                     "'# lint: wall-clock-ok <reason>'"))
    return findings


# --------------------------------------------------------------------------
# TPU502 — unseeded RNG in runtime modules

_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64"}


_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "bernoulli", "multinomial",
              "normal"}


@rule("TPU502", "unseeded RNG in a runtime module", "A",
      "fault schedules, backoff jitter, and recovery paths must be "
      "replayable from a seed; module-level random.* / np.random.* "
      "calls, bare random.Random() and torch.rand*/randint/randperm "
      "without generator= are not")
def unseeded_rng_rule(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    prefixes = tuple(ctx.pkg_rel(p) for p in
                     ctx.settings.runtime_rng_prefixes)
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
            dotted = _dotted(node.func) or ""
            bad = None
            if dotted.startswith("random.") and dotted != "random.Random":
                bad = dotted
            elif dotted == "random.Random" and not node.args:
                bad = "random.Random()  (no seed)"
            elif (dotted.startswith(("np.random.", "numpy.random."))
                  and dotted.split(".")[-1] not in _NP_RANDOM_OK):
                bad = dotted
            elif (dotted.split(".")[-1] == "default_rng"
                  and "random" in dotted and not node.args):
                bad = f"{dotted}()  (no seed)"
            elif (dotted.startswith("torch.")
                  and dotted.split(".")[-1] in _TORCH_RNG
                  and not any(kw.arg == "generator"
                              for kw in node.keywords)):
                bad = f"{dotted}()  (no generator)"
            if bad is None:
                continue
            if ctx.suppression(rel, node.lineno, "rng-ok"):
                continue
            findings.append(Finding(
                rule="TPU502", file=rel, line=node.lineno,
                symbol=f"{qual}:{bad}",
                message=f"unseeded RNG {bad} in runtime module ({qual})",
                hint="thread a seeded random.Random(seed) / "
                     "np.random.default_rng(seed) / torch.Generator "
                     "through the config, or "
                     "annotate '# lint: rng-ok <reason>'"))
    return findings
