"""Static plan analysis (the prepare-time verifier).

* ``schema``  — bottom-up schema/type inference over algebra plans
* ``capflow`` — which ExecConfig caps a plan can overflow, with static
  cardinality bounds from CollectionStats
* ``check``   — rewrite soundness (schema equivalence + capacity-set
  monotonicity per rule firing) and the prepare-time ``verify_plan``

Host-only. Attribute access is lazy, as in the JAX package, so that
importing the package loads no submodule it does not use.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "ColType": ("repro_torch.core.analysis.schema", "ColType"),
    "infer_schema": ("repro_torch.core.analysis.schema", "infer_schema"),
    "check_param_uses": ("repro_torch.core.analysis.schema",
                         "check_param_uses"),
    "CapFlow": ("repro_torch.core.analysis.capflow", "CapFlow"),
    "CapSite": ("repro_torch.core.analysis.capflow", "CapSite"),
    "analyze_capflow": ("repro_torch.core.analysis.capflow", "analyze"),
    "check_rewrite": ("repro_torch.core.analysis.check", "check_rewrite"),
    "verify_plan": ("repro_torch.core.analysis.check", "verify_plan"),
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    try:
        mod, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    return getattr(importlib.import_module(mod), attr)
