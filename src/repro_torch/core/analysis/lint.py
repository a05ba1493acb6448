"""Determinism, registry and kernel-table linter of the port (pure AST:
it imports nothing it lints), ported from
``repro/core/analysis/lint.py``.

Static checks for the failure modes that type inference cannot see
because they live in *our* Python, not in the plans:

DET001    wall-clock reads (``time.time``/``perf_counter``/
          ``datetime.now``/…) under ``core/`` — results must be a
          function of (plan, data, config), never of the clock.
DET002    unkeyed RNG under ``core/``: legacy ``np.random.<fn>`` global
          state, the stdlib ``random`` module, or torch's global
          generator — ``torch.manual_seed`` and ``torch.rand``/
          ``randn``/``randint``/``randperm``/``normal``/``bernoulli``/
          ``multinomial`` without ``generator=``. Only explicitly
          seeded generators (``np.random.default_rng(seed)``, a
          ``torch.Generator`` passed as ``generator=``) keep runs
          reproducible.
CAP001    an ExecConfig ``*_cap`` field (or ``join_bucket``) missing
          from the executor's ``OVERFLOW_FLAGS`` registry — a
          capacity knob whose overflow nobody can observe.
CAP002    a registry flag never raised via ``ctx.note(flag, ...)`` in
          the executor — an observable that is never written.
CAP003    a registry flag never read as ``rs.overflow_*`` in
          service.py — an overflow with no regrowth rung.
CAP004    a registry cap never presized (no ``dataclasses.replace(...,
          cap=...)`` in service.py) — first-shot configs would always
          start at the fallback ceiling.  ``join_bucket`` is exempt
          (regrowth-only by design).
OBS001    a ``<obj>.stats.<field>`` increment site under ``core/``
          whose field has no entry in ``obs.metrics.
          REGISTERED_STATS`` — a counter the metrics exposition
          silently drops.  Covers ``+=`` and dict-entry writes
          (``stats.d[k] = stats.d.get(k, 0) + 1``).
OBS002    a ``REGISTERED_STATS`` key naming no field of
          ``ServiceStats``/``RuntimeStats`` — a stale registration
          that would export nothing.
KRN001    the port's kernel table (``kernels/registry.py`` ``KERNELS``)
          against the sources: every entry names an existing CUDA
          source, an existing ``kernels/ref.py`` function (``plain``)
          and an existing wrapper; its ``replaces`` is a
          ``src/repro/kernels/*.py:line`` whose function builds a
          ``pl.pallas_call`` (read as text by ``ast``, never imported),
          or ``None`` with ``backward_of`` naming another entry; every
          Pallas entry point of the JAX package has an entry (its
          ``jax_ref``) or a ``NOT_PORTED`` line; stale keys flag.

Not ported: TRACE001–003 (a host cast, ``.item()`` or Python control
flow on a traced value inside a ``jax.jit``/``shard_map`` scope). The
port has no traced scope: it runs eagerly, and a host read there is a
sync, not an error.

Waivers: a finding whose line (or the line above it) carries
``# lint: allow(CODE)`` is suppressed — the waiver is the audit trail
for intentional exceptions.

CLI: ``python -m repro_torch.core.analysis.lint [paths...]`` prints
``path:line:col CODE message`` per finding and exits nonzero if any
survive; with a path that is (or holds) ``repro_torch`` the
cross-file CAP, OBS and KRN checks run too. The default path is
``src/repro_torch``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
import sys
from typing import Iterable, Optional

# -- configuration -----------------------------------------------------------

#: the package this linter checks, under its source root
PKG = "repro_torch"

#: DET rules apply only under these directory suffixes
DETERMINISTIC_DIRS = ("core/",)

_CLOCK_CALLS = ("time", "perf_counter", "monotonic", "now", "utcnow",
                "today")
_SEEDED_RNG_FNS = ("default_rng", "Generator", "SeedSequence",
                   "PCG64", "Philox")
#: torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = ("rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "rand_like", "randn_like",
                   "randint_like")

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([A-Z0-9,\s]+)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.code} {self.message}")


# -- helpers -----------------------------------------------------------------


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _in_dirs(path: str, dirs: tuple) -> bool:
    p = _norm(path)
    return any(d in p for d in dirs)


def _attr_chain(e: ast.AST) -> list:
    """``a.b.c`` -> ["a", "b", "c"]; [] when not a pure name chain."""
    parts: list = []
    while isinstance(e, ast.Attribute):
        parts.append(e.attr)
        e = e.value
    if isinstance(e, ast.Name):
        parts.append(e.id)
        return parts[::-1]
    return []


def _waived(lines: list, finding: Finding) -> bool:
    for ln in (finding.line, finding.line - 1):
        if 1 <= ln <= len(lines):
            m = _ALLOW_RE.search(lines[ln - 1])
            if m and finding.code in {c.strip()
                                      for c in m.group(1).split(",")}:
                return True
    return False


# -- the per-file visitor ----------------------------------------------------


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str) -> None:
        self.path = path
        self.findings: list[Finding] = []
        self._det = _in_dirs(path, DETERMINISTIC_DIRS)

    def _emit(self, code: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(code, self.path, node.lineno,
                                     node.col_offset, msg))

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if self._det and chain:
            self._check_det(node, chain)
        self.generic_visit(node)

    # -- DET rules -------------------------------------------------------

    def _check_det(self, node: ast.Call, chain: list) -> None:
        if (len(chain) == 2 and chain[0] in ("time", "datetime")
                and chain[1] in _CLOCK_CALLS):
            self._emit("DET001", node,
                       f"wall-clock read {'.'.join(chain)}() — "
                       f"results must not depend on the clock")
        elif (len(chain) >= 3 and chain[0] in ("np", "numpy")
                and chain[1] == "random"
                and chain[2] not in _SEEDED_RNG_FNS):
            self._emit("DET002", node,
                       f"legacy global-state RNG "
                       f"{'.'.join(chain)}() — use a seeded "
                       f"np.random.default_rng(seed)")
        elif (len(chain) == 2 and chain[0] == "random"
                and chain[1] != "seed"):
            self._emit("DET002", node,
                       f"stdlib random.{chain[1]}() shares hidden "
                       f"global state — use a seeded generator")
        elif chain == ["torch", "manual_seed"]:
            self._emit("DET002", node,
                       "torch.manual_seed() seeds torch's global "
                       "generator — pass a seeded torch.Generator")
        elif (len(chain) == 2 and chain[0] == "torch"
                and chain[1] in _TORCH_SAMPLERS
                and not any(kw.arg == "generator" for kw in node.keywords)):
            self._emit("DET002", node,
                       f"torch.{chain[1]}() without generator= draws "
                       f"from torch's global generator — pass a seeded "
                       f"torch.Generator")


# -- entry points ------------------------------------------------------------


def lint_source(text: str, path: str = "<string>") -> list[Finding]:
    """Lint one module's source text (the unit-test API)."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("PARSE", path, e.lineno or 0, e.offset or 0,
                        f"syntax error: {e.msg}")]
    v = _Visitor(path)
    v.visit(tree)
    lines = text.splitlines()
    return [f for f in v.findings if not _waived(lines, f)]


def _py_files(paths: Iterable[str]) -> list:
    out = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, _dirs, files in os.walk(p):
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return sorted(out)


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    findings: list[Finding] = []
    for path in _py_files(paths):
        with open(path, encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), path))
    return findings


# -- capacity-registry completeness (cross-file, AST-only) -------------------


def _parse_file(path: str) -> Optional[ast.Module]:
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return ast.parse(fh.read())


def _exec_config_fields(tree: ast.Module) -> list:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "ExecConfig":
            return [s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)]
    return []


def _overflow_registry(tree: ast.Module) -> dict:
    """The literal OVERFLOW_FLAGS dict, read without importing."""
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target]
                   if isinstance(node, ast.AnnAssign) else [])
        if (any(isinstance(t, ast.Name) and t.id == "OVERFLOW_FLAGS"
                for t in targets)
                and isinstance(node.value, ast.Dict)):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if (isinstance(k, ast.Constant)
                        and isinstance(v, ast.Constant)):
                    out[k.value] = v.value
            return out
    return {}


def _noted_flags(tree: ast.Module) -> set:
    """Every flag raised via ``<ctx>.note("flag", ...)``."""
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "note" and node.args
                and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


def _read_attrs(tree: ast.Module, prefix: str) -> set:
    return {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)
            and node.attr.startswith(prefix)}


def _replace_kwargs(tree: ast.Module) -> set:
    """Every field presized via ``dataclasses.replace(cfg, f=...)``."""
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and _attr_chain(node.func) == ["dataclasses",
                                               "replace"]):
            out.update(kw.arg for kw in node.keywords if kw.arg)
    return out


def lint_registry(repo_src: str) -> list[Finding]:
    """Cross-file capacity-registry completeness over a source tree
    rooted at ``repo_src`` (the directory holding ``repro_torch/``)."""
    exec_path = os.path.join(repo_src, PKG, "core", "executor.py")
    svc_path = os.path.join(repo_src, PKG, "core", "service.py")
    exec_tree = _parse_file(exec_path)
    svc_tree = _parse_file(svc_path)
    if exec_tree is None or svc_tree is None:
        return [Finding("CAP001", repo_src, 0, 0,
                        f"cannot locate {PKG}/core/{{executor,service}}"
                        ".py under this root")]
    findings: list[Finding] = []

    fields = _exec_config_fields(exec_tree)
    registry = _overflow_registry(exec_tree)
    capacity_fields = [f for f in fields
                       if f.endswith("_cap") or f == "join_bucket"]
    for f in capacity_fields:
        if f not in registry:
            findings.append(Finding(
                "CAP001", exec_path, 0, 0,
                f"ExecConfig capacity field {f!r} has no "
                f"OVERFLOW_FLAGS entry — its overflow is "
                f"unobservable"))
    noted = _noted_flags(exec_tree)
    rungs = _read_attrs(svc_tree, "overflow_")
    presized = _replace_kwargs(svc_tree)
    for cap, flag in registry.items():
        if flag not in noted:
            findings.append(Finding(
                "CAP002", exec_path, 0, 0,
                f"registry flag {flag!r} is never raised via "
                f"ctx.note() in the executor"))
        if flag not in rungs:
            findings.append(Finding(
                "CAP003", svc_path, 0, 0,
                f"registry flag {flag!r} is never read in "
                f"service.py — overflow with no regrowth rung"))
        if cap != "join_bucket" and cap not in presized:
            findings.append(Finding(
                "CAP004", svc_path, 0, 0,
                f"registry cap {cap!r} is never presized via "
                f"dataclasses.replace in service.py"))
    return findings


# -- the port's kernel table (cross-file, AST-only) ---------------------------


def _literal(tree: ast.Module, name: str):
    """The value of the module-level literal ``name = ...`` (None when the
    assignment is missing or not a literal)."""
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target]
                   if isinstance(node, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
    return None


def _functions(tree: Optional[ast.Module]) -> set:
    return ({n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
            if tree is not None else set())


def _pallas_entry_points(tree: ast.Module) -> dict:
    """{name: (first line, last line)} of the top-level functions whose
    body builds a ``pl.pallas_call``."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for n in ast.walk(node):
                if (isinstance(n, ast.Call)
                        and _attr_chain(n.func) == ["pl", "pallas_call"]):
                    out[node.name] = (node.lineno, node.end_lineno)
                    break
    return out


def lint_kernel_registry(repo_src: str) -> list[Finding]:
    """KRN001 over a source tree rooted at ``repo_src`` (the directory
    holding ``repro_torch/`` and the JAX package ``repro/``; the
    ``source`` and ``replaces`` paths are read from its parent, the
    repository's root)."""
    kdir = os.path.join(repo_src, PKG, "kernels")
    reg_path = os.path.join(kdir, "registry.py")
    reg_tree = _parse_file(reg_path)
    if reg_tree is None:
        return [Finding("KRN001", repo_src, 0, 0,
                        f"cannot locate {PKG}/kernels/registry.py under "
                        f"this root")]
    kernels = _literal(reg_tree, "KERNELS")
    not_ported = _literal(reg_tree, "NOT_PORTED")
    if not isinstance(kernels, dict) or not isinstance(not_ported, dict):
        return [Finding("KRN001", reg_path, 0, 0,
                        "no literal KERNELS and NOT_PORTED dicts in "
                        "kernels/registry.py")]
    root = os.path.dirname(os.path.abspath(repo_src))
    ref_fns = _functions(_parse_file(os.path.join(kdir, "ref.py")))
    jax_kdir = os.path.join(repo_src, "repro", "kernels")
    entries: dict = {}       # "<module>.<fn>" -> (path, first, last)
    for path in _py_files([jax_kdir]):
        tree = _parse_file(path)
        if tree is None:
            continue
        mod = os.path.basename(path)[:-3]
        for fn, (a, b) in _pallas_entry_points(tree).items():
            entries[f"{mod}.{fn}"] = (os.path.abspath(path), a, b)

    findings: list[Finding] = []

    def bad(msg: str) -> None:
        findings.append(Finding("KRN001", reg_path, 0, 0, msg))

    for name, e in kernels.items():
        if not os.path.isfile(os.path.join(root, e.get("source") or "")):
            bad(f"KERNELS[{name!r}] source {e.get('source')!r} is no file")
        if e.get("plain") not in ref_fns:
            bad(f"KERNELS[{name!r}] plain {e.get('plain')!r} is not a "
                f"function in kernels/ref.py")
        mod, _, fn = (e.get("wrapper") or "").partition(".")
        if fn not in _functions(_parse_file(os.path.join(kdir,
                                                         f"{mod}.py"))):
            bad(f"KERNELS[{name!r}] wrapper {e.get('wrapper')!r} names no "
                f"function under kernels/")
        rep = e.get("replaces")
        if rep is None:
            if e.get("backward_of") not in kernels:
                bad(f"KERNELS[{name!r}] replaces no Pallas kernel and names "
                    f"no forward (backward_of) in KERNELS")
            continue
        file, _, line = rep.rpartition(":")
        hit = [k for k, (p, a, b) in entries.items()
               if p == os.path.join(root, file)
               and line.isdigit() and a <= int(line) <= b]
        if not hit:
            bad(f"KERNELS[{name!r}] replaces {rep!r}, where no function "
                f"builds a pl.pallas_call")
        elif e.get("jax_ref") not in hit:
            bad(f"KERNELS[{name!r}] jax_ref {e.get('jax_ref')!r} is not "
                f"the Pallas entry point at {rep!r} ({hit[0]!r})")
    covered = {e.get("jax_ref") for e in kernels.values()}
    for key in sorted(set(entries) - covered - set(not_ported)):
        bad(f"Pallas entry point {key!r} has no KERNELS entry and no "
            f"NOT_PORTED line")
    for key in sorted(set(not_ported) - set(entries)):
        bad(f"NOT_PORTED key {key!r} names no pallas_call entry point "
            f"under repro/kernels — stale registration")
    for key in sorted(set(not_ported) & covered):
        bad(f"NOT_PORTED key {key!r} has a KERNELS entry — stale "
            f"registration")
    return findings


# -- metrics-registry completeness (cross-file, AST-only) --------------------


def _registered_stats_keys(tree: ast.Module) -> Optional[set]:
    """Keys of the literal REGISTERED_STATS dict (None when the
    assignment is missing — distinct from legitimately empty)."""
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target]
                   if isinstance(node, ast.AnnAssign) else [])
        if (any(isinstance(t, ast.Name) and t.id == "REGISTERED_STATS"
                for t in targets)
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
    return None


def _class_field_names(tree: ast.Module, cls: str) -> set:
    """Annotated field names of a dataclass body."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)}
    return set()


def _stats_increment_sites(tree: ast.Module) -> list:
    """(node, field) for every write that bumps a stats counter:
    ``<obj>.stats.<field> += n`` and ``<obj>.stats.<field>[k] = ...``
    (the dict-entry form of an increment)."""
    out = []

    def field_of(target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Subscript):
            target = target.value
        chain = _attr_chain(target)
        if len(chain) >= 3 and chain[-2] == "stats":
            return chain[-1]
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.AugAssign):
            f = field_of(node.target)
            if f is not None:
                out.append((node, f))
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    f = field_of(t)
                    if f is not None:
                        out.append((node, f))
    return out


def lint_stats_sources(files: Iterable[tuple],
                       registered: set) -> list[Finding]:
    """OBS001 over (path, source) pairs: every stats increment site
    must name a REGISTERED_STATS key. Waivers honored."""
    findings: list[Finding] = []
    for path, text in files:
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        lines = text.splitlines()
        for node, field in _stats_increment_sites(tree):
            if field in registered:
                continue
            f = Finding(
                "OBS001", path, node.lineno, node.col_offset,
                f"stats field {field!r} is incremented here but has "
                f"no obs.metrics.REGISTERED_STATS entry — it would "
                f"be invisible to the metrics exposition")
            if not _waived(lines, f):
                findings.append(f)
    return findings


def lint_metrics(repo_src: str) -> list[Finding]:
    """Cross-file metrics-registry completeness over a source tree
    rooted at ``repo_src``: OBS001 (unregistered increment sites under
    core/) and OBS002 (stale registrations)."""
    metrics_path = os.path.join(repo_src, PKG, "core", "obs",
                                "metrics.py")
    metrics_tree = _parse_file(metrics_path)
    if metrics_tree is None:
        return [Finding("OBS001", repo_src, 0, 0,
                        f"cannot locate {PKG}/core/obs/metrics.py "
                        "under this root")]
    registered = _registered_stats_keys(metrics_tree)
    if registered is None:
        return [Finding("OBS001", metrics_path, 0, 0,
                        "no literal REGISTERED_STATS dict in "
                        "obs/metrics.py")]

    core = os.path.join(repo_src, PKG, "core")
    files = []
    for path in _py_files([core]):
        with open(path, encoding="utf-8") as fh:
            files.append((path, fh.read()))
    findings = lint_stats_sources(files, registered)

    svc_tree = _parse_file(os.path.join(repo_src, PKG, "core",
                                        "service.py"))
    rt_tree = _parse_file(os.path.join(repo_src, PKG, "core",
                                       "serving", "scheduler.py"))
    fields: set = set()
    if svc_tree is not None:
        fields |= _class_field_names(svc_tree, "ServiceStats")
    if rt_tree is not None:
        fields |= _class_field_names(rt_tree, "RuntimeStats")
    if fields:
        for key in sorted(registered - fields):
            findings.append(Finding(
                "OBS002", metrics_path, 0, 0,
                f"REGISTERED_STATS key {key!r} names no field of "
                f"ServiceStats/RuntimeStats — stale registration"))
    return findings


# -- CLI ---------------------------------------------------------------------


def main(argv: Optional[list] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        args = [os.path.join("src", PKG)]
    findings = lint_paths(args)
    # the cross-file checks run when an arg is (or holds) the package
    for a in args:
        root = a.rstrip("/" + os.sep)
        if os.path.basename(root) == PKG:
            root = os.path.dirname(root)
        if os.path.isdir(os.path.join(root, PKG, "core")):
            findings.extend(lint_registry(root))
            findings.extend(lint_metrics(root))
            findings.extend(lint_kernel_registry(root))
            break
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} lint finding(s)", file=sys.stderr)
        return 1
    print(f"lint clean over {', '.join(args)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
