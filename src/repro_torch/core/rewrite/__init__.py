from repro_torch.core.rewrite.engine import (Context, apply_rule_once, optimize,
                                       run_rules)  # noqa: F401
from repro_torch.core.rewrite import path_rules, parallel_rules  # noqa: F401
