"""Rewrite soundness + the prepare-time plan verifier.

``check_rewrite(before, after, rule)`` runs after every rewrite-rule
firing when soundness checks are enabled (``rewrite.engine.
set_soundness_checks`` / ``REPRO_CHECK_REWRITES=1`` — CI/debug mode,
zero overhead otherwise) and asserts two static invariants:

* **schema equivalence** — the plan's DISTRIBUTE-RESULT columns keep
  their (kind, anchoring table) signature.  Sequence-ness and
  nullability may legitimately change (UNNEST erasure, join
  introduction), value types may not.
* **capacity-set monotonicity** — the set of ExecConfig caps the plan
  can overflow never *shrinks*: a rule may introduce capacity-bounded
  stages (scan introduction, join introduction, top-k pushdown) but a
  rule that drops one while keeping the operators that needed it has
  lost an overflow surface, which would silently disable the service
  regrowth rung for that plan.

The ``after`` plan is additionally re-inferred from scratch, so a rule
that produces an ill-formed plan (unbound columns, ill-typed
expressions) is caught at the exact firing that broke it, with the
rule's name in the diagnostic.

``verify_plan`` is the prepare-time entry: executor-mode schema
inference + capacity-flow + registry agreement over the final plan,
called once per prepared plan by ``QueryService.prepare()`` (memoized
— the warm execute path never pays for it).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import algebra as A
from repro_torch.core.analysis import capflow, schema
from repro_torch.core.errors import (PlanTypeError, QueryError,
                               RewriteSoundnessError)


def output_signature(plan: A.Op, db=None,
                     mode: str = "logical") -> tuple:
    """The (kind, table) pair of every DISTRIBUTE-RESULT column — the
    part of the schema every rewrite must preserve."""
    s = schema.infer_schema(plan, db=db, mode=mode)
    if isinstance(plan, A.DistributeResult):
        return tuple((s[v].kind, s[v].table) for v in plan.vars)
    return tuple(sorted((v, t.kind, t.table) for v, t in s.items()))


def check_rewrite(before: A.Op, after: A.Op, rule: str,
                  db=None) -> None:
    """Assert one rule firing preserved the plan's static contract."""
    try:
        before_sig = output_signature(before, db=db)
    except QueryError:
        return      # the rule can't be blamed for a pre-broken plan
    try:
        after_sig = output_signature(after, db=db)
    except QueryError as e:
        raise RewriteSoundnessError(
            f"rule {rule} produced an ill-formed plan: {e.message}",
            path=e.path) from e
    if before_sig != after_sig:
        raise RewriteSoundnessError(
            f"rule {rule} changed the result schema: "
            f"{before_sig} -> {after_sig}")
    before_caps = capflow.analyze(before).caps
    after_caps = capflow.analyze(after).caps
    if not before_caps <= after_caps:
        dropped = sorted(before_caps - after_caps)
        raise RewriteSoundnessError(
            f"rule {rule} shrank the capacity set "
            f"{sorted(before_caps)} -> {sorted(after_caps)}: "
            f"dropped {dropped} — a capacity-bounded stage lost its "
            f"overflow surface")


def verify_plan(plan: A.Op, db=None, text: Optional[str] = None
                ) -> dict:
    """Prepare-time static verification of an executable plan:
    executor-mode schema inference, capacity-flow analysis, and
    agreement of every capacity site with the executor's overflow-flag
    registry.  Returns the inferred root schema; raises QueryError
    subclasses (with ``text`` attached for caret rendering) on any
    violation."""
    try:
        s = schema.infer_schema(plan, db=db, mode="executor")
        flow = capflow.analyze(plan, db=db)
        capflow.check_registry(flow)
    except QueryError as e:
        raise e.with_text(text)
    return s


def assert_well_typed(plan: A.Op, db=None) -> None:
    """Convenience wrapper: verify or raise PlanTypeError."""
    got = verify_plan(plan, db=db)
    assert isinstance(got, dict)


__all__ = ["check_rewrite", "output_signature", "verify_plan",
           "assert_well_typed", "PlanTypeError"]
