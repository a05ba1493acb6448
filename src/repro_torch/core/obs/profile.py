"""Per-query operator profiles: the static plan joined with runtime
facts, rendered as an annotated plan tree.

``QueryService.explain(query, profile=True)`` runs the query once
through a profile-mode compilation (the executor appends a per-op
valid-row count to the fused function's outputs — see
``Executor.compile(profile=True)``), then this module joins three
views per operator:

* **static** — capacity-flow sites (``analysis/capflow``): which
  ``ExecConfig`` cap bounds the operator and the statistics-derived
  static row bound;
* **configured** — the actual cap value of the (possibly regrown)
  config the run used, giving cap utilization = rows / cap;
* **runtime** — global valid rows flowing out of the operator, plus
  overflow flags and the service's per-signature compile/execute wall
  split and regrowth history.

OrderBy under Limit (top-k pushdown) and Aggregate under Subplan
execute fused into their parent — they carry no row count of their
own and render as ``(fused ↑)``.

Host-only: never touches the warm path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import algebra as A
from repro_torch.core.analysis.schema import op_label
from repro_torch.core.obs.trace import sig_digest

#: operator class -> the ExecConfig cap that bounds its output tile
#: (mirrors executor.OVERFLOW_FLAGS; Limit-over-OrderBy reports
#: topk_cap at the Limit, where the fused sort actually runs).
_OP_CAPS = {
    A.DataScan: "scan_cap",
    A.Join: "join_cap",
    A.GroupBy: "group_cap",
    A.OrderBy: "topk_cap",
}


@dataclasses.dataclass
class OpProfile:
    index: int                       # pre-order index (A.walk)
    label: str                       # op_label diagnostic name
    depth: int
    rows: Optional[int] = None       # global valid rows out; None if
    #                                  not measured (fused / no run)
    rows_peak: Optional[int] = None  # busiest partition's rows out —
    #                                  what the per-partition cap binds
    fused: bool = False              # executes inside its parent
    cap: Optional[str] = None        # ExecConfig field bounding it
    cap_value: Optional[int] = None  # that cap in the run's config
    static_bound: Optional[int] = None   # capflow statistics bound
    overflow: bool = False           # this op's cap flag raised

    @property
    def utilization(self) -> Optional[float]:
        rows = self.rows_peak if self.rows_peak is not None \
            else self.rows
        if rows is None or not self.cap_value:
            return None
        return rows / self.cap_value


@dataclasses.dataclass
class QueryProfile:
    text: str
    signature: str                   # erased-signature digest
    path: str                        # prepared | batched | scheduled
    mode: str                        # sim | spmd
    config: object                   # ExecConfig the final run used
    ops: list                        # [OpProfile] in pre-order
    compile_s: Optional[float] = None
    execute_s: Optional[float] = None
    compiles: int = 0                # compiles this explain triggered
    retries: int = 0                 # regrowth retries during the run
    regrowths: tuple = ()            # ((cap, old, new), ...) history
    overflow_flags: tuple = ()       # flags raised on the final run

    def op(self, label_prefix: str) -> OpProfile:
        """First op whose label starts with ``label_prefix`` (test
        convenience)."""
        for o in self.ops:
            if o.label.startswith(label_prefix):
                return o
        raise KeyError(label_prefix)

    def render(self) -> str:
        """Annotated plan tree, one line per operator."""
        head = [f"profile path={self.path} mode={self.mode} "
                f"sig={self.signature}"]
        cfg = self.config
        if cfg is not None:
            caps = " ".join(
                f"{f.name}={getattr(cfg, f.name)}"
                for f in dataclasses.fields(cfg)
                if f.name.endswith("_cap") or f.name == "join_bucket")
            head.append(f"config: {caps}")
        split = []
        if self.compile_s is not None:
            split.append(f"compile {self.compiles}x "
                         f"{self.compile_s * 1e3:.1f}ms")
        if self.execute_s is not None:
            split.append(f"execute {self.execute_s * 1e3:.1f}ms")
        if self.retries:
            split.append(f"regrow-retries {self.retries}")
        if split:
            head.append(" · ".join(split))
        for cap, old, new in self.regrowths:
            head.append(f"regrew {cap}: {old} -> {new}")
        width = max(len("  " * o.depth + o.label) for o in self.ops)
        lines = []
        for o in self.ops:
            left = "  " * o.depth + o.label
            ann = []
            if o.fused:
                ann.append("(fused ↑)")
            elif o.rows is not None:
                ann.append(f"rows={o.rows}")
            if o.cap is not None and not o.fused:
                if o.cap_value is not None:
                    ann.append(f"{o.cap}={o.cap_value}")
                u = o.utilization
                if u is not None:
                    ann.append(f"util={u:.0%}")
                if o.static_bound is not None:
                    ann.append(f"bound<={o.static_bound}")
            if o.overflow:
                ann.append("OVERFLOWED")
            lines.append(f"{left:<{width}}  " + " ".join(ann)
                         if ann else left)
        return "\n".join(head + lines)


def _tree(op: A.Op):
    """(op, depth, fused) in the executor's pre-order (A.walk order),
    marking ops that execute fused into their parent: OrderBy directly
    under Limit (top-k pushdown) and Aggregate under Subplan."""
    out = []

    def rec(op, depth, fused):
        out.append((op, depth, fused))
        if isinstance(op, A.Subplan):
            rec(op.plan, depth + 1, isinstance(op.plan, A.Aggregate))
        for c in A.children(op):
            child_fused = (isinstance(op, A.Limit)
                           and isinstance(c, A.OrderBy))
            rec(c, depth + 1, child_fused)

    rec(op, 0, False)
    return out


def _cap_for(op: A.Op, fused: bool) -> Optional[str]:
    if isinstance(op, A.Limit) and isinstance(op.child, A.OrderBy):
        return "topk_cap"            # the fused sort's capacity
    if isinstance(op, A.Unnest):
        return "scan_cap"            # unnest chains share the scan tile
    cap = _OP_CAPS.get(type(op))
    if cap is not None and fused:
        return None                  # reported at the parent instead
    return cap


def build_profile(pq, *, db=None, config=None, rs=None, path="prepared",
                  mode="sim", compile_s=None, execute_s=None,
                  compiles=0, retries=0, regrowths=()) -> QueryProfile:
    """Join static plan facts with one run's measurements. ``rs`` may
    be None (static-only explain: tree + caps + bounds, no rows)."""
    from repro_torch.core.analysis import capflow
    from repro_torch.core.executor import OVERFLOW_FLAGS

    plan = pq.plan
    static_bounds: dict[int, Optional[int]] = {}
    try:
        flow = capflow.analyze(plan, db=db)
        for site in flow.sites:
            b = static_bounds.get(site.cap)
            static_bounds[site.cap] = (site.bound if b is None
                                       else max(b, site.bound or 0))
    except Exception:
        flow = None                  # profile must not fail on an
        #                              analysis gap; bounds just absent

    op_rows = rs.op_rows() if rs is not None else None
    op_peak = rs.op_rows_peak() if rs is not None else None
    flags = {flag: bool(getattr(rs, flag, False))
             for cap, flag in OVERFLOW_FLAGS.items()} if rs is not None \
        else {}

    ops = []
    for index, (op, depth, fused) in enumerate(_tree(plan)):
        cap = _cap_for(op, fused)
        cap_value = getattr(config, cap, None) if cap and config \
            else None
        p = OpProfile(
            index=index, label=op_label(op), depth=depth, fused=fused,
            cap=cap, cap_value=cap_value,
            static_bound=static_bounds.get(cap),
            overflow=bool(cap and flags.get(OVERFLOW_FLAGS[cap])))
        if op_rows is not None and index in op_rows and not fused:
            p.rows = op_rows[index]
            p.rows_peak = op_peak[index]
        ops.append(p)

    return QueryProfile(
        text=pq.text or "", signature=sig_digest(pq.signature),
        path=path, mode=mode, config=config, ops=ops,
        compile_s=compile_s, execute_s=execute_s, compiles=compiles,
        retries=retries, regrowths=tuple(regrowths),
        overflow_flags=tuple(sorted(f for f, v in flags.items()
                                    if v)))
