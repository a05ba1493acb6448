#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, one GPU.

    python3 benchmarks/torch_trace.py         # from the repository root
    python3 benchmarks/torch_trace.py --lm    # the LM serving path
    python3 benchmarks/torch_trace.py --spmd  # sim vs spmd mode, P = 1
    python3 benchmarks/torch_trace.py --train # the LM training path
    python3 benchmarks/torch_trace.py --lm --arch mamba2-370m  # another model
    python3 benchmarks/torch_trace.py --train --arch hubert-xlarge
    python3 benchmarks/torch_trace.py --lm --arch jamba-v0.1-52b
    python3 benchmarks/torch_trace.py --tp-layer --arch jamba-v0.1-52b

Builds the data of ``chip_smoke.py`` (same spec, P = 4), runs each of
Q1–Q12 once on the kernel route with statistics-presized caps, then
traces one more warm run per query with ``torch.profiler`` and prints
one JSON line per query. With ``--lm``: qwen3-1.7b at full size with
seeded random weights (``chip_smoke.py``'s phase 5), one warm
``serve_batch`` of 8 x 2048-token prompts, then a traced prefill step
(8 x 2048 tokens) and four traced decode steps of the same batch, one
JSON line each. With ``--spmd``: the same data built with P = 1, each
query traced once in sim mode and once in spmd mode over an in-process
NCCL group of one rank, through ``run_compiled`` (the run and the copy
of its outputs to the host), one JSON line per query and mode. With
``--train``: qwen3-1.7b at full width (``chip_smoke.py``'s phase 9:
seeded random weights, 8 x 2048 tokens a step, 2 microbatches, remat),
one cold step, then one traced warm step, one JSON line with its ten
kernels of most device time, with the config's microbatches. ``--arch``
names another config for ``--lm`` or ``--train`` (phase 10's
granite-moe-1b-a400m, phase 11's mamba2-370m, phase 12's qwen2-vl-2b and
hubert-xlarge), at full size the same way; phase 16's llama4-scout-17b-a16e
and jamba-v0.1-52b, whose whole depths do not fit one card, at the depths
of ``chip_smoke.MOE_WIDE_LAYERS`` (12 and 16 layers). The serve's weights are
drawn in the compute dtype layer by layer (``model.init_compute_params``).
With ``--tp-layer``: ``chip_smoke.py`` phase 17's layer (the first of
``--arch``, default llama3-8b, at published width, its seeded weights and
8 x 2048 tokens, bfloat16, forward and backward), one warm run whole and
one of its share on one of 4 ``model`` ranks (``fsdp.split_in_turn``, the
first rank's tree alone), one JSON line each. ``serve_batch`` takes token
prompts only, so with ``--lm`` qwen2-vl-2b's batch is batch 0 of
``data.pipeline`` (8 x 2048 positions, 512 of them patches), warmed up
by one prefill, then traced through ``steps`` as above; hubert-xlarge,
which has no decode step, traces one warm ``model.forward`` and
``logits_from_hidden`` over 8 x 2048 frames (``chip_smoke.audio_forward``).
Every line has:

- ``wall_ms``: host clock around the traced run (ends in a sync);
- ``device_ms``: the sum of the device time of every kernel the run
  launched, and ``busy`` = device_ms / wall_ms (1 - busy is the share
  of the run in which the card was idle: host work, launches, syncs);
- ``launches``: device kernels launched, and the three kernel names
  with the most device time;
- ``repo_kernels``: [name, device ms, launches] of each of this
  repository's own kernels (the ``__global__`` functions of
  ``src/repro_torch/kernels/csrc``) that the run launched.

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def repo_kernel_pattern():
    """A pattern that finds, in a profiler's kernel name, a ``__global__``
    function defined in the CUDA sources."""
    import re
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(")
    names = {n for f in CSRC.glob("*.cu") for n in decl.findall(f.read_text())}
    return re.compile(r"\b(?:" + "|".join(sorted(names)) + r")\s*[<(]")


def traced(fn, top: int = 5) -> dict:
    """Run ``fn`` once under ``torch.profiler``, ending in a sync:
    wall and summed kernel device time, busy share, launches, the ``top``
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
    ours, ours_n = Counter(), Counter()
    repo = repo_kernel_pattern()
    for e in kernels:
        by_name[e.name[:60]] += e.device_time_total / 1e3
        if repo.search(e.name):
            ours[e.name[:60]] += e.device_time_total / 1e3
            ours_n[e.name[:60]] += 1
    device_ms = sum(by_name.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms, "launches": len(kernels),
            "top": [[k, v] for k, v in by_name.most_common(top)],
            "repo_kernels": [[k, v, ours_n[k]] for k, v in ours.most_common()]}


def trace_lm(arch: str | None) -> None:
    import dataclasses

    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_at
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model, steps
    arch = arch or chip_smoke.LM_ARCH
    overrides = ({"num_layers": chip_smoke.MOE_WIDE_LAYERS[arch]}
                 if arch in chip_smoke.MOE_WIDE_LAYERS else {})
    cfg = dataclasses.replace(get_config(arch), **overrides)
    dev = torch.device("cuda")
    b, s = chip_smoke.LM_REQUESTS, chip_smoke.LM_PROMPT
    cparams = model.init_compute_params(cfg, chip_smoke.SEED, dev)
    if cfg.frontend == "frames":
        frames = batch_at(cfg, 0, batch=b, seq=s, seed=chip_smoke.SEED,
                          device=dev)["frames"]

        def run_forward():
            chip_smoke.audio_forward(cfg, cparams, frames, dev)

        run_forward()                           # warm-up: the cold run
        print(json.dumps({"lm": "forward", "arch": arch, "frames": b * s,
                          **traced(run_forward)}), flush=True)
        return
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    if cfg.frontend == "patches":
        batch = batch_at(cfg, 0, batch=b, seq=s, seed=chip_smoke.SEED,
                         device=dev)
        batch.pop("labels")
        prefill(cparams, batch)                 # warm-up: the cold prefill
    else:
        serve_batch(arch, smoke=False, num_requests=b,
                    prompt_len=s, gen_len=chip_smoke.LM_GEN, device=dev,
                    params=cparams, overrides=overrides)  # the cold serve
        gen = torch.Generator(device=dev)
        gen.manual_seed(chip_smoke.SEED)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (b, s),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}
    out = {}

    def run_prefill():
        out["logits"], out["caches"] = prefill(cparams, batch)

    print(json.dumps({"lm": "prefill", "arch": arch, "tokens": b * s,
                      "layers": cfg.num_layers, **traced(run_prefill, 8)}),
          flush=True)
    caches = model.init_cache(cfg, b, s + 8, dev)
    for dst, src in zip(caches, out.pop("caches")):
        if "k" in src:
            dst["k"][:, :s] = src["k"]
            dst["v"][:, :s] = src["v"]
        else:                                   # Mamba-2: as it is
            dst.update(src)
    state = {"tok": batch["tokens"][:, -1:],
             "kv_len": torch.full((b,), s, dtype=torch.int32, device=dev)}

    def run_decode():
        state["kv_len"] = state["kv_len"] + 1
        logits, _ = decode(cparams, caches, state["tok"], state["kv_len"])
        state["tok"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    run_decode()
    for step in range(4):
        print(json.dumps({"lm": "decode_step", "arch": arch, "step": step,
                          **traced(run_decode)}), flush=True)


def trace_train(arch: str | None) -> None:
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_at
    from repro_torch.models import flops, model, steps
    from repro_torch.optim import adamw_init
    arch = arch or chip_smoke.TRAIN_ARCH
    cfg = get_config(arch)
    dev = torch.device("cuda")
    b, s = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ
    micro = cfg.train_microbatches
    state = {"params": model.init_params(cfg, chip_smoke.SEED, dev)}
    state["opt"] = adamw_init(state["params"])
    step_fn = steps.make_train_step(cfg, num_microbatches=micro,
                                    total_steps=10)
    batches = [batch_at(cfg, i, batch=b, seq=s, seed=chip_smoke.SEED,
                        device=dev) for i in range(2)]

    def run(i):
        state["params"], state["opt"], m = step_fn(
            state["params"], state["opt"], batches[i])
        float(m["loss"])                        # the step ends here

    run(0)                                      # the cold step
    torch.cuda.reset_peak_memory_stats(dev)
    rec = traced(lambda: run(1), top=10)
    print(json.dumps({
        "train": "warm_step", "arch": arch,
        "tokens": b * s, "microbatches": micro,
        "model_flops": flops.model_flops(cfg, "train", b, s)["total"],
        "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20, **rec}),
        flush=True)


def trace_tp_layer(arch: str | None) -> None:
    import dataclasses

    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import fsdp
    from repro_torch.models import model
    arch = arch or chip_smoke.TP_ARCHS[0]
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), compute_dtype="bfloat16",
                              attn_impl="auto")
    spec, layer32 = chip_smoke.tp_layer_weights(cfg, dev)
    layer = model.tree_map(lambda t: t.to(cfg.cdtype).requires_grad_(),
                           layer32)
    leaves = list(model._leaves(layer))
    b, s = chip_smoke.TP_TOKENS
    x, dy, positions = chip_smoke.tp_layer_inputs(cfg, dev, (b, s,
                                                  cfg.d_model), cfg.cdtype)
    ranks = chip_smoke.TP_RANKS
    tree, split = fsdp.split_in_turn(cfg, 0, layer, ranks)
    one = {**tree, **{k: tree[k][:1] for k in split.sublayers}}

    def run(p, sp):
        y, _ = model._apply_block(cfg, spec, p, x, positions, None, sp)
        torch.autograd.grad(y, [x] + leaves, dy, allow_unused=True)

    for name, p, sp in (("whole", layer, None), ("one_rank", one, split)):
        run(p, sp)                              # warm-up: the cold run
        print(json.dumps({"tp_layer": name, "arch": arch, "ranks": ranks,
                          "tokens": [b, s], "split": split.sublayers,
                          **traced(lambda: run(p, sp))}), flush=True)


def trace_spmd() -> None:
    import torch
    import torch.distributed as dist

    import chip_smoke
    from repro_torch.core import Executor, compile_query
    from repro_torch.core.presize import presized_config
    from repro_torch.core.queries import ALL
    from repro_torch.data.weather import WeatherSpec, build_database
    from repro_torch.launch.mesh import make_data_mesh

    db = build_database(WeatherSpec(**chip_smoke.SPEC), 1)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{chip_smoke.free_port()}", rank=0, world_size=1)
    try:
        mesh = make_data_mesh()
        ex = Executor(db, device="cuda")
        ex.tables               # spmd's partition tables are views of these
        for name, text in ALL.items():
            plan = compile_query(text)
            cfg = presized_config(db, plan)
            for mode in ("sim", "spmd"):
                cp = ex.compile(plan, mode=mode, config=cfg,
                                mesh=mesh if mode == "spmd" else None)
                for _ in range(2):              # cold, then warm
                    ex.run_compiled(cp)
                rec = traced(lambda: ex.run_compiled(cp))
                rec["top"] = rec["top"][:3]
                print(json.dumps({"query": name, "mode": mode, **rec}),
                      flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    print(f"device {torch.cuda.get_device_name(0)}", flush=True)
    args = sys.argv[1:]
    arch = args[args.index("--arch") + 1] if "--arch" in args else None
    if "--lm" in args:
        trace_lm(arch)
        print(subprocess_smi())
        return 0
    if "--train" in args:
        trace_train(arch)
        print(subprocess_smi())
        return 0
    if "--tp-layer" in args:
        trace_tp_layer(arch)
        print(subprocess_smi())
        return 0
    if "--spmd" in sys.argv[1:]:
        trace_spmd()
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
