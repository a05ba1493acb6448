"""First-shot capacities from build-time statistics.

``presized_config`` is the JAX package's
``QueryService._presized_config`` as a function: the port's serving
tier (``service.py``) calls it for every first run of a signature, and
``chip_smoke.py`` calls it for the bare executor. Without presized caps
a query runs at the padded table widths, which at a realistic scale
makes the join probe of Q8 and the output tiles of Q6 several times
larger than the data needs.
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


def presized_config(db: xdm.Database, plan: A.Op,
                    base: Optional[ExecConfig] = None, *,
                    pushdown_topk: bool = True,
                    num_partitions: Optional[int] = None) -> ExecConfig:
    """ExecConfig for ``plan`` with every capacity that ``base`` leaves
    unset estimated from ``db.stats``; explicit caps in ``base`` win.
    Where estimation fails (no stats, an unnest whose source collection
    is ambiguous, a group-by key that resolves to no statistics tag)
    that capacity keeps the base's safe behaviour (padded table / full
    string dictionary / uncompacted probe / full-width sort). The
    ordered-output tile is presized to ~limit k only under
    ``pushdown_topk`` (False: full-sort-then-slice). ``num_partitions``
    defaults to the database's. Call it after the Executor is built,
    so that the string dictionary holds its derived entries."""
    cfg = base if base is not None else ExecConfig()
    parts = num_partitions or len(
        next(iter(db.collections.values())).partitions)
    # the caps clamp where overflow becomes impossible: every
    # partition's padded rows gathered on one (join output), the full
    # string dictionary (group, top-k)
    scan_ceiling = max(
        int(math.ceil(max(t.num_nodes for t in c.partitions) / 128) * 128)
        for c in db.collections.values())
    joincap_ceiling = scan_ceiling * parts
    group_ceiling = len(db.strings)
    if cfg.scan_cap is None:
        caps: list[Optional[int]] = []
        for op in A.walk(plan):
            if isinstance(op, A.DataScan):
                caps.append(estimate_scan_cap(db, op.collection, op.path))
            elif isinstance(op, A.Unnest):
                caps.append(_unnest_bound(db, op))
        if caps and None not in caps:
            cfg = dataclasses.replace(cfg, scan_cap=max(caps))
    if cfg.group_cap is None:
        gcap = _group_bound(db, plan)
        if gcap is not None:
            cfg = dataclasses.replace(cfg,
                                      group_cap=min(gcap, group_ceiling))
    if cfg.join_cap is None and cfg.scan_cap is not None and any(
            isinstance(op, A.Join) for op in A.walk(plan)):
        # matched rows per partition are bounded by the probe tile's
        # width: scan_cap under the broadcast join, the all-gathered
        # width under the repartition join, where key skew can land
        # every match on one partition
        mult = parts if cfg.join_strategy == "repartition" else 1
        cfg = dataclasses.replace(cfg, join_cap=min(
            round_cap(cfg.scan_cap * mult), joincap_ceiling))
    if cfg.topk_cap is None and pushdown_topk:
        lim, ordered = _order_limit(plan)
        if ordered:
            tags = _group_key_tags(plan)
            tcaps = ([estimate_topk_cap(db, t, lim) for t in tags] if tags
                     else [round_cap(lim)] if lim is not None else [])
            known = [c for c in tcaps if c is not None]
            if known:
                cfg = dataclasses.replace(cfg, topk_cap=min(
                    max(known), group_ceiling))
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
