#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, one GPU.

    python3 benchmarks/torch_trace.py       # from the repository root

Builds the data of ``chip_smoke.py`` (same spec, P = 4), runs each of
Q1–Q12 once on the kernel route with statistics-presized caps, then
traces one more warm run per query with ``torch.profiler`` and prints
one JSON line per query:

- ``wall_ms``: host clock around the traced run (ends in a sync);
- ``device_ms``: the sum of the device time of every kernel the run
  launched, and ``busy`` = device_ms / wall_ms (1 - busy is the share
  of the run in which the card was idle: host work, launches, syncs);
- ``launches``: device kernels launched, and the three kernel names
  with the most device time.

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.core import Executor, compile_query
    from repro_torch.core.presize import presized_config
    from repro_torch.core.queries import ALL
    from repro_torch.data.weather import WeatherSpec, build_database

    db = build_database(WeatherSpec(**chip_smoke.SPEC), chip_smoke.PARTITIONS)
    ex = Executor(db, device="cuda")
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    for name, text in ALL.items():
        plan = compile_query(text)
        cp = ex.compile(plan, config=presized_config(db, plan))
        for _ in range(2):                      # cold, then warm
            ex.run_raw(cp)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.run_raw(cp)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = Counter()
        for e in kernels:
            by_name[e.name[:60]] += e.device_time_total / 1e3
        device_ms = sum(by_name.values())
        print(json.dumps({
            "query": name, "wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms, "launches": len(kernels),
            "top": [[k, v] for k, v in by_name.most_common(3)]}),
            flush=True)
    print(subprocess_smi())
    return 0


def subprocess_smi() -> str:
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
