#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, one GPU.

    python3 benchmarks/torch_trace.py       # from the repository root
    python3 benchmarks/torch_trace.py --lm  # the LM serving path

Builds the data of ``chip_smoke.py`` (same spec, P = 4), runs each of
Q1–Q12 once on the kernel route with statistics-presized caps, then
traces one more warm run per query with ``torch.profiler`` and prints
one JSON line per query. With ``--lm``: qwen3-1.7b at full size with
seeded random weights (``chip_smoke.py``'s phase 5), one warm
``serve_batch`` of 8 x 2048-token prompts, then a traced prefill step
(8 x 2048 tokens) and four traced decode steps of the same batch, one
JSON line each. Every line has:

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


def traced(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``, ending in a sync:
    wall and summed kernel device time, busy share, launches, the top
    kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.device_time_total / 1e3
    device_ms = sum(by_name.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms, "launches": len(kernels),
            "top": [[k, v] for k, v in by_name.most_common(5)]}


def trace_lm() -> None:
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model, steps
    cfg = get_config(chip_smoke.LM_ARCH)
    dev = torch.device("cuda")
    b, s = chip_smoke.LM_REQUESTS, chip_smoke.LM_PROMPT
    params = model.init_params(cfg, chip_smoke.SEED, dev)
    serve_batch(chip_smoke.LM_ARCH, smoke=False, num_requests=b,
                prompt_len=s, gen_len=chip_smoke.LM_GEN, device=dev,
                params=params)                  # warm-up: the cold serve
    cparams = model.compute_params(cfg, params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    toks = torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                         device=dev, dtype=torch.int32)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    out = {}

    def run_prefill():
        out["logits"], out["caches"] = prefill(cparams, {"tokens": toks})

    print(json.dumps({"lm": "prefill", "tokens": b * s,
                      **traced(run_prefill)}), flush=True)
    caches = model.init_cache(cfg, b, s + 8, dev)
    for dst, src in zip(caches, out.pop("caches")):
        dst["k"][:, :s] = src["k"]
        dst["v"][:, :s] = src["v"]
    state = {"tok": toks[:, -1:],
             "kv_len": torch.full((b,), s, dtype=torch.int32, device=dev)}

    def run_decode():
        state["kv_len"] = state["kv_len"] + 1
        logits, _ = decode(cparams, caches, state["tok"], state["kv_len"])
        state["tok"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    run_decode()
    for step in range(4):
        print(json.dumps({"lm": "decode_step", "step": step,
                          **traced(run_decode)}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    if "--lm" in sys.argv[1:]:
        trace_lm()
        print(subprocess_smi())
        return 0

    import chip_smoke
    from repro_torch.core import Executor, compile_query
    from repro_torch.core.presize import presized_config
    from repro_torch.core.queries import ALL
    from repro_torch.data.weather import WeatherSpec, build_database

    db = build_database(WeatherSpec(**chip_smoke.SPEC), chip_smoke.PARTITIONS)
    ex = Executor(db, device="cuda")
    for name, text in ALL.items():
        plan = compile_query(text)
        cp = ex.compile(plan, config=presized_config(db, plan))
        for _ in range(2):                      # cold, then warm
            ex.run_raw(cp)
        rec = traced(lambda: ex.run_raw(cp))
        rec["top"] = rec["top"][:3]
        print(json.dumps({"query": name, **rec}), flush=True)
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
