"""Cluster-mode XQuery: one partition a rank of a torch.distributed group.

    torchrun --nproc-per-node N -m repro_torch.launch.xquery_cluster
    torchrun --nproc-per-node 4 -m repro_torch.launch.xquery_cluster \
        --device cpu --stations 16          # gloo ranks on the CPU

The counterpart of ``examples/xquery_cluster.py``: the same compiled
plans run as one SPMD program over the group's ranks (``torchrun`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address),
with collectives at the exchange points: all_gather for the
hybrid-hash join build side (broadcast) and for the grace repartition,
gather-then-sum for the two-step aggregation — the Hyracks connector
analogues. The database is built with P = world size. Every query runs
on both join strategies through the executor, then through the
``QueryService`` (statistics-presized caps, the plan cache: the second
request of a query is a cache hit). Rank 0 prints the rows and times.
Each rank uses GPU ``LOCAL_RANK`` and NCCL, or gloo with ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import ExecConfig, Executor, QueryService, compile_query
from repro_torch.core.queries import ALL, SCALAR
from repro_torch.data.weather import WeatherSpec, build_database
from repro_torch.launch.mesh import BACKENDS, make_data_mesh


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _summary(name: str, rs) -> str:
    if name in SCALAR:
        return f"{rs.scalar():.3f}"
    return f"{len(rs.rows())} rows"


def run(args) -> None:
    """Every query on both strategies through the executor, then
    through the service; rank 0 prints."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", 0))
    if args.device == "cpu":
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[dev.type])
    mesh = make_data_mesh(dev)
    spec = WeatherSpec(num_stations=args.stations,
                       years=tuple(range(args.first_year, 2005)),
                       days_per_year=args.days)
    db = build_database(spec, num_partitions=world)
    names = args.queries or list(ALL)

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    say(f"{world} ranks on {dev.type}; {spec.num_stations} stations x "
        f"{len(spec.years)} years x {spec.days_per_year} days, P={world}")
    for strategy in ("broadcast", "repartition"):
        ex = Executor(db, ExecConfig(join_strategy=strategy), device=dev)
        for name in names:
            plan = compile_query(ALL[name])
            _sync(dev)
            t0 = time.perf_counter()
            rs = ex.run(plan, mode="spmd", mesh=mesh)
            ms = (time.perf_counter() - t0) * 1e3
            say(f"{name} [{strategy:11s}] -> {_summary(name, rs)} "
                f"({ms:.1f} ms, first run)")
        del ex
    svc = QueryService(db, mode="spmd", mesh=mesh, device=dev)
    for name in names:
        _sync(dev)
        t0 = time.perf_counter()
        svc.execute(ALL[name])
        cold = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rs = svc.execute(ALL[name])
        warm = (time.perf_counter() - t0) * 1e3
        say(f"{name} [service    ] -> {_summary(name, rs)} cold "
            f"{cold:.1f} ms, warm {warm:.1f} ms")
    say(f"service stats: compiles {svc.stats.compiles}, retries "
        f"{svc.stats.retries}, cache hits {svc.stats.cache_hits}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--stations", type=int, default=2000)
    ap.add_argument("--first-year", type=int, default=1955)
    ap.add_argument("--days", type=int, default=8)
    ap.add_argument("--queries", nargs="*", help="default: Q1-Q12")
    args = ap.parse_args(argv)
    try:
        run(args)
    finally:
        if dist.is_initialized():
            # every rank done with its collectives before any tears its
            # connections down: a gloo rank whose peer closed first can
            # abort in its transport threads
            dist.barrier()
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
