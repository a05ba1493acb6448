"""Quickstart of the PyTorch port: compile and run an XQuery over
weather XML, end to end (the steps of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py              # GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Shows the full paper pipeline: XML -> columnar shred -> parse ->
normalized plan -> rewritten plan (watch the §4 rules fire) -> the
partitions run on one device (the CUDA kernels on the GPU, their plain
versions on the CPU) -> results.
"""
import argparse

from repro_torch.core import ExecConfig, Executor, compile_query, translate
from repro_torch.core.algebra import pretty
from repro_torch.core.rewrite import optimize
from repro_torch.data.weather import WeatherSpec, build_database

QUERY = '''
for $r in collection("/sensors")/dataCollection/data
where $r/dataType eq "TMAX"
 and decimal(data($r/value)) gt 400
return $r
'''


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    print("=== 1. build + shred the weather collection (4 partitions)")
    db = build_database(WeatherSpec(num_stations=10,
                                    years=(2000, 2001),
                                    days_per_year=4),
                        num_partitions=4)
    nodes = sum(t.num_nodes for t in db.collection("/sensors").partitions)
    print(f"    /sensors: {nodes} XDM nodes across 4 partitions")

    print("\n=== 2. normalized logical plan (paper §4 'initial plan')")
    plan0 = translate(QUERY)
    print(pretty(plan0))

    print("\n=== 3. after path + parallel rewrite rules (§4.1, §4.2)")
    plan = optimize(plan0)
    print(pretty(plan))

    print("\n=== 4. execute (the partitions side by side on one device)")
    ex = Executor(db, ExecConfig(), device=args.device)
    rs = ex.run(plan)
    rows = rs.rows()
    print(f"    {len(rows)} hot TMAX readings on {ex.device}; first 5:")
    for fp, in rows[:5]:
        date, typ, station, value = fp.split("|")
        print(f"      {station} {date[:10]} {typ}={value}")

    print("\n=== 5. an aggregation (two-step local/global, rule 4.2.2)")
    q4 = 'max( for $r in collection("/sensors")/dataCollection/data '\
         'where $r/dataType eq "TMAX" return $r/value ) div 10'
    print(f"    max TMAX = {ex.run(compile_query(q4)).scalar():.1f} C")


if __name__ == "__main__":
    main()
