"""Fixpoint rewrite driver + plan analyses (paper §4 intro, §4.1.1).

The driver mirrors Algebricks' staged rule sets: each stage is a list
of rules applied bottom-up to a fixpoint. ``Context`` carries the
whole-plan analyses the rules key on:

* ``use``        variable use counts (inline / dead-code decisions)
* ``singleton``  vars guaranteed to hold exactly one item per tuple
* ``props``      (document-ordered, duplicate-free) lattice per var —
                 the property tracking of rule 4.1.1 (after [19])
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

from repro_torch.core.algebra import (Aggregate, Assign, Call, Const, DataScan,
                                Expr, Op, Some, Subplan, Unnest, Var,
                                fn_info, free_vars, transform_bottom_up,
                                var_use_counts, walk)
from repro_torch.core.obs import trace as obs_trace

Rule = Callable[[Op, "Context"], Optional[Op]]


@dataclasses.dataclass
class Context:
    use: dict[int, int]
    singleton: dict[int, bool]
    props: dict[int, tuple[bool, bool]]   # (ordered, nodup)
    max_var: int = 0

    def fresh(self) -> int:
        """Globally fresh variable (rules must not mint locally —
        nested plans don't see outer defs)."""
        self.max_var += 1
        return self.max_var

    @classmethod
    def analyze(cls, root: Op) -> "Context":
        from repro_torch.core.algebra import (DistributeResult, defined_vars,
                                        used_exprs)
        use = var_use_counts(root)
        max_var = 0
        for op in walk(root):
            # defined_vars (not defined_var): GROUP-BY defines its key
            # and aggregate vars, and DISTRIBUTE-RESULT's vars may be
            # exactly those — missing either would let fresh() mint a
            # colliding variable
            max_var = max(max_var, *defined_vars(op), 0)
            if isinstance(op, DistributeResult):
                max_var = max(max_var, *op.vars, 0)
            for e in used_exprs(op):
                max_var = max(max_var, max(free_vars(e), default=0))
        singleton: dict[int, bool] = {}
        props: dict[int, tuple[bool, bool]] = {}
        # resolve def-chains to fixpoint (defs may reference later-
        # visited vars across subplan boundaries; a few passes suffice)
        defs = [op for op in walk(root)
                if isinstance(op, (Assign, Unnest, Aggregate, DataScan))]
        for _ in range(len(defs) + 1):
            changed = False
            for op in defs:
                if isinstance(op, DataScan):
                    s, p = True, (True, True)
                elif isinstance(op, Unnest):
                    s = True          # unnest emits one item per tuple
                    p = expr_props(op.expr, props)
                elif isinstance(op, Aggregate):
                    s = True          # aggregates produce one value
                    p = expr_props(op.expr, props)
                else:
                    s = expr_singleton(op.expr, singleton)
                    p = expr_props(op.expr, props)
                if singleton.get(op.var) != s or props.get(op.var) != p:
                    singleton[op.var] = s
                    props[op.var] = p
                    changed = True
            if not changed:
                break
        return cls(use=use, singleton=singleton, props=props,
                   max_var=max_var)


def expr_singleton(e: Expr, flags: dict[int, bool]) -> bool:
    if isinstance(e, Const):
        return True
    if isinstance(e, Var):
        return flags.get(e.n, False)
    if isinstance(e, Some):
        return True
    if isinstance(e, Call):
        info = fn_info(e.fn)
        if info.card == "one":
            return True
        if info.card == "same":
            return all(expr_singleton(a, flags) for a in e.args)
        return False
    return False


def expr_props(e: Expr, props: dict[int, tuple[bool, bool]]
               ) -> tuple[bool, bool]:
    """(document-ordered, duplicate-free) of an expression's value."""
    if isinstance(e, (Const, Some)):
        return (True, True)
    if isinstance(e, Var):
        return props.get(e.n, (False, False))
    if isinstance(e, Call):
        info = fn_info(e.fn)
        if e.fn in ("doc", "collection"):
            return (True, True)
        if e.fn == "sort-distinct-nodes-asc-or-atomics":
            return (True, True)
        if e.fn == "sort-nodes-asc-or-atomics":
            return (True, expr_props(e.args[0], props)[1])
        if e.fn == "distinct-nodes-or-atomics":
            return (expr_props(e.args[0], props)[0], True)
        args = [expr_props(a, props) for a in e.args] or [(True, True)]
        o = all(a[0] for a in args) and info.preserves_order
        d = all(a[1] for a in args) and info.preserves_nodup
        return (o, d)
    return (False, False)


def remove_identity_assigns(root: Op) -> Op:
    """Drop ASSIGN($v: $u) ops, substituting $u for $v globally.

    Identity assigns appear after sort-distinct removal (4.1.1 replaces
    the expression with its argument) and would otherwise block the
    operator-adjacency patterns of 4.1.2/4.1.3.
    """
    from repro_torch.core.algebra import (DistributeResult, substitute,
                                    used_exprs, with_children, children)
    mapping: dict[int, Var] = {}
    for op in walk(root):
        if isinstance(op, Assign) and isinstance(op.expr, Var):
            mapping[op.var] = op.expr
    if not mapping:
        return root
    # resolve transitive chains
    def resolve(v: int) -> Var:
        seen = set()
        while v in mapping and v not in seen:
            seen.add(v)
            v = mapping[v].n
        return Var(v)
    mapping = {k: resolve(k) for k in mapping}

    def f(op: Op) -> Op:
        if isinstance(op, Assign) and isinstance(op.expr, Var):
            return op.child
        if isinstance(op, (Assign, Unnest, Aggregate)):
            return op.replace(expr=substitute(op.expr, mapping))
        if isinstance(op, DataScan):
            return op
        from repro_torch.core.algebra import GroupBy, Join, OrderBy, Select
        if isinstance(op, Select):
            return op.replace(expr=substitute(op.expr, mapping))
        if isinstance(op, OrderBy):
            return op.replace(keys=tuple(
                (substitute(e, mapping), d) for e, d in op.keys))
        if isinstance(op, GroupBy):
            return op.replace(
                key_expr=substitute(op.key_expr, mapping),
                aggs=tuple((v, fn, substitute(e, mapping))
                           for v, fn, e in op.aggs))
        if isinstance(op, Join):
            return op.replace(
                cond=substitute(op.cond, mapping),
                hash_keys=tuple((substitute(a, mapping),
                                 substitute(b, mapping))
                                for a, b in op.hash_keys))
        if isinstance(op, DistributeResult):
            return op.replace(vars=tuple(
                mapping[v].n if v in mapping else v for v in op.vars))
        return op

    return transform_bottom_up(root, f)


def apply_rule_once(root: Op, rule: Rule) -> tuple[Op, bool]:
    """Apply ``rule`` at the first (bottom-up) matching node only."""
    ctx = Context.analyze(root)
    fired = [False]

    def f(op: Op) -> Op:
        if fired[0]:
            return op
        new = rule(op, ctx)
        if new is not None:
            fired[0] = True
            return new
        return op

    return transform_bottom_up(root, f), fired[0]


# -- rewrite soundness (debug/CI mode) ---------------------------------------

_CHECK_REWRITES = os.environ.get("REPRO_CHECK_REWRITES", "") not in ("",
                                                                    "0")


def set_soundness_checks(on: bool) -> bool:
    """Toggle per-firing soundness checks (analysis/check.py): after
    every rule application the plan's result schema must be equivalent
    and its capacity set monotone.  Debug/CI mode — the default-off
    path adds zero work.  Returns the previous setting.  Also
    switchable via the ``REPRO_CHECK_REWRITES=1`` environment
    variable."""
    global _CHECK_REWRITES
    prev = _CHECK_REWRITES
    _CHECK_REWRITES = bool(on)
    return prev


def soundness_checks_enabled() -> bool:
    return _CHECK_REWRITES


def run_rules(root: Op, rules: list[Rule], max_iters: int = 200) -> Op:
    """Apply a rule stage to fixpoint (one rule firing per pass so
    analyses stay fresh — plans here are small, clarity wins)."""
    root = remove_identity_assigns(root)
    for _ in range(max_iters):
        for rule in rules:
            prev = root
            root, fired = apply_rule_once(root, rule)
            if fired:
                root = remove_identity_assigns(root)
                # one instant per rule firing through the ambient
                # tracer (a no-op unless the service installed one
                # around prepare — obs/trace.using)
                obs_trace.current().event(
                    "rewrite-rule", cat="rewrite",
                    rule=getattr(rule, "__name__", str(rule)))
                if _CHECK_REWRITES:
                    from repro_torch.core.analysis.check import check_rewrite
                    check_rewrite(prev, root,
                                  getattr(rule, "__name__", str(rule)))
                break
        else:
            return root
    return root


def optimize(root: Op, trace: Optional[list] = None) -> Op:
    """The full staged pipeline: path rules -> parallel rules ->
    cleanup (mirrors Logical-to-Logical staging in §3.2)."""
    from repro_torch.core.rewrite import parallel_rules, path_rules

    stages = [
        ("path", path_rules.RULES),
        ("parallel", parallel_rules.RULES),
        ("cleanup", path_rules.CLEANUP_RULES),
    ]
    for name, rules in stages:
        with obs_trace.current().span(f"rewrite.{name}",
                                      cat="rewrite"):
            root = run_rules(root, rules)
        if trace is not None:
            trace.append((name, root))
    return root
