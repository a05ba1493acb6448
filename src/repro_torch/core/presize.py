"""First-shot capacities from build-time statistics.

The JAX package sizes a query's ExecConfig inside its serving tier
(``QueryService._presized_config``); the port's serving tier comes in
a later slice and will call this function. Without presized caps a
query runs at the padded table widths, which at a realistic scale
makes the dense join probe of Q8 about 1.6e13 compares instead of
about 6e11.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import algebra as A
from repro_torch.core import xdm
from repro_torch.core.executor import ExecConfig
from repro_torch.core.physical import (estimate_group_cap, estimate_scan_cap,
                                       estimate_topk_cap, round_cap)
from repro_torch.core.rewrite.parallel_rules import _child_chain


def presized_config(db: xdm.Database, plan: A.Op) -> ExecConfig:
    """ExecConfig for ``plan`` with every capacity estimated from
    ``db.stats``, with the top-k pushdown. Where estimation fails (no
    stats, an unnest whose source collection is ambiguous, a group-by
    key that resolves to no statistics tag) that capacity keeps the
    default's safe behaviour (padded table / full string dictionary /
    uncompacted probe / full-width sort). Call it after the Executor is
    built, so that the string dictionary holds its derived entries."""
    parts = len(next(iter(db.collections.values())).partitions)
    # the caps clamp where overflow becomes impossible: the widest
    # padded partition (scan), every partition's rows gathered on one
    # (join output), the full string dictionary (group, top-k)
    scan_ceiling = max(
        int(math.ceil(max(t.num_nodes for t in c.partitions) / 128) * 128)
        for c in db.collections.values())
    group_ceiling = len(db.strings)
    cfg = ExecConfig()
    caps: list[Optional[int]] = []
    for op in A.walk(plan):
        if isinstance(op, A.DataScan):
            caps.append(estimate_scan_cap(db, op.collection, op.path))
        elif isinstance(op, A.Unnest):
            caps.append(_unnest_bound(db, op))
    if caps and None not in caps:
        cfg = dataclasses.replace(cfg, scan_cap=max(caps))
    gcap = _group_bound(db, plan)
    if gcap is not None:
        cfg = dataclasses.replace(cfg, group_cap=min(gcap, group_ceiling))
    if cfg.scan_cap is not None and any(isinstance(op, A.Join)
                                        for op in A.walk(plan)):
        # matched rows per partition are bounded by the probe tile's
        # width (scan_cap under the default broadcast join)
        cfg = dataclasses.replace(cfg, join_cap=min(
            round_cap(cfg.scan_cap), scan_ceiling * parts))
    lim, ordered = _order_limit(plan)
    if ordered:
        tags = _group_key_tags(plan)
        tcaps = ([estimate_topk_cap(db, t, lim) for t in tags] if tags
                 else [round_cap(lim)] if lim is not None else [])
        known = [c for c in tcaps if c is not None]
        if known:
            cfg = dataclasses.replace(cfg, topk_cap=min(max(known),
                                                        group_ceiling))
    return cfg


def _order_limit(plan: A.Op) -> tuple[Optional[int], bool]:
    """(limit k, has ORDER-BY) of a plan — the top-k pushdown's inputs."""
    lim, ordered = None, False
    for op in A.walk(plan):
        if isinstance(op, A.Limit):
            lim = op.k
        elif isinstance(op, A.OrderBy):
            ordered = True
    return lim, ordered


def _group_key_tags(plan: A.Op) -> Optional[list[str]]:
    """The statistics tag of every GROUP-BY key: each key expression
    resolved through ASSIGN chains to its child chain's final tag.
    None when the plan has no GROUP-BY or a key is unresolvable."""
    gbs = [op for op in A.walk(plan) if isinstance(op, A.GroupBy)]
    if not gbs:
        return None
    assigns = {op.var: op.expr for op in A.walk(plan)
               if isinstance(op, A.Assign)}
    tags: list[str] = []
    for gb in gbs:
        e = gb.key_expr
        seen: set[int] = set()
        while isinstance(e, A.Var) and e.n in assigns and e.n not in seen:
            seen.add(e.n)
            e = assigns[e.n]
        got = _child_chain(e) if isinstance(e, A.Call) else None
        if got is None or not got[1]:
            return None
        tags.append(got[1][-1])
    return tags


def _group_bound(db: xdm.Database, plan: A.Op) -> Optional[int]:
    """Segment capacity for every GROUP-BY in the plan from the global
    distinct-value bounds of the resolved key tags."""
    tags = _group_key_tags(plan)
    if tags is None:
        return None
    bounds = [estimate_group_cap(db, tag) for tag in tags]
    return None if any(b is None for b in bounds) else max(bounds)


def _unnest_bound(db: xdm.Database, op: A.Unnest) -> Optional[int]:
    """Per-partition bound for an UNNEST child chain: the chain's final
    tag count, maxed over collections. ``iterate`` unnests are aliases
    with no capacity of their own."""
    e = op.expr
    if isinstance(e, A.Call) and e.fn == "iterate":
        return 0
    got = _child_chain(e) if isinstance(e, A.Call) else None
    if got is None:
        return None
    _, names = got
    bounds = [estimate_scan_cap(db, c, (names[-1],)) for c in db.collections]
    known = [b for b in bounds if b is not None]
    return max(known) if known else None
