"""Whole-suite static verification runner, ported from
``repro/core/analysis/verify.py``.

    PYTHONPATH=src python -m repro_torch.core.analysis.verify   # the GPU
    PYTHONPATH=src python -m repro_torch.core.analysis.verify --device cpu

It builds a small weather database, then for every paper query Q1–Q12:

1. translates + optimizes with **rewrite soundness checks on** — every
   rule firing must preserve the result schema and keep the capacity
   set monotone (analysis/check.check_rewrite);
2. lifts parameters and re-verifies declared Param types against use
   sites (prepared.prepare_plan -> schema.check_param_uses);
3. runs the prepare-time verifier (schema inference + capacity-flow +
   overflow-registry agreement);
4. cross-validates the capacity-flow static bounds against the
   statistics-presized ExecConfig the serving tier would actually use
   — a presized cap below a static bound is a first-shot overflow the
   statistics should have prevented.

It also asserts the analysis-side capacity registry literally equals
the executor's ``OVERFLOW_FLAGS`` (completeness both ways: no orphan
knob, no unanalyzable flag).

Prints one summary line per query and exits nonzero on any failure.
The ``QueryService`` it builds uploads its tables to ``--device`` (the
GPU unless ``cpu`` is named; without a GPU it raises). Unlike the
linter this imports the executor: it is the dynamic half of the
port's lint check.
"""
from __future__ import annotations

import argparse
import sys


def run(argv=None) -> int:
    from repro_torch.core import executor, queries
    from repro_torch.core.analysis import capflow
    from repro_torch.core.analysis.check import verify_plan
    from repro_torch.core.errors import QueryError
    from repro_torch.core.prepared import prepare_plan
    from repro_torch.core.rewrite import optimize
    from repro_torch.core.rewrite.engine import set_soundness_checks
    from repro_torch.core.service import QueryService
    from repro_torch.core.translator import translate
    from repro_torch.data.weather import WeatherSpec, build_database

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    if capflow.registry_coverage() != executor.OVERFLOW_FLAGS:
        print(f"FAIL registry: analysis {capflow.registry_coverage()} "
              f"!= executor {executor.OVERFLOW_FLAGS}")
        return 1

    spec = WeatherSpec(num_stations=5, years=(1976, 2000),
                       days_per_year=2)
    db = build_database(spec, num_partitions=2)
    svc = QueryService(db, device=args.device)

    failures = 0
    prev = set_soundness_checks(True)
    try:
        for name in sorted(queries.ALL, key=lambda n: int(n[1:])):
            text = queries.ALL[name]
            try:
                plan = optimize(translate(text))
                pq = prepare_plan(plan, text)
                schema = verify_plan(pq.plan, db=db, text=text)
                flow = capflow.analyze(pq.plan, db=db)
                problems = capflow.cross_validate(
                    pq.plan, db, svc._presized_config(pq.plan))
            except QueryError as e:
                print(f"FAIL {name}: {e}")
                failures += 1
                continue
            if problems:
                for p in problems:
                    print(f"FAIL {name}: {p}")
                failures += 1
                continue
            caps = ",".join(sorted(flow.caps)) or "-"
            print(f"ok   {name}: {len(schema)} result cols, "
                  f"{len(pq.specs)} params, caps [{caps}]")
    finally:
        set_soundness_checks(prev)

    if failures:
        print(f"{failures} verification failure(s)", file=sys.stderr)
        return 1
    print(f"all {len(queries.ALL)} queries statically verified "
          f"(rewrite soundness on, presizing cross-validated)")
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
