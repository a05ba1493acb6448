"""Serving over the ``("data", "model")`` mesh across four cards:
``launch/serve.py``'s ``serve_batch(..., mesh=)`` (``launch/fsdp.py``'s
``ServeLayout``) over NCCL, held against one process on rank 0's card,
then llama4-scout-17b-a16e served at all 48 layers.

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_serve_cards.py                     # four cards, NCCL
    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_serve_cards.py --device cpu        # four gloo ranks

``CHECKS``, one at a time: each arch served by one process on rank 0's
card (the other ranks wait), then by the four ranks over the mesh on the
same seeded weights (each rank keeps its blocks as the one process's
are drawn), teacher-forced with the one process's tokens and, for a MoE
arch, routed as the one process routed (``chip_smoke.RouteReplay``: at
top-1 one decision flipped by a bf16 rounding swaps a token's routed
output): the prefill and every step's logits against the one process's
(``LOGIT_ATOL``), and the greedy tokens equal in float32. llama3-8b at
full width and depth on (1, 4) and (2, 2) in float32 and on (1, 4) in
bf16; llama4-scout at full width, in float32 at 4 layers (phase 16's
float32 gate, 40.5 GiB on one card) and in bf16 at 12 (phase 16's
serve). Then llama4-scout at all 48 layers on (1, 4), which no card
holds alone (200.7 GiB in bf16), with phase 5's traffic, cold and warm:
prefill ms, decode ms per token, each rank's peak MiB (after the
weights are drawn, and over the warm serve), and the bytes each
collective moves in one decode step on one rank (``CollectiveBytes``:
the tensors handed to NCCL, the outputs of the gathers). With
``--device cpu`` the smoke configs run on four gloo ranks (8/4 heads).

Rank 0 prints one JSON line a check and one for the 48-layer serve, the
card's name and power limit, and last ``{"ok": ...}``; every rank exits
1 if a check failed.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import steps  # noqa: E402

SEED = 0
#: (arch, mesh, compute dtype, layers: None for the published depth)
CHECKS = (("llama3-8b", (1, 4), "float32", None),
          ("llama3-8b", (2, 2), "float32", None),
          ("llama3-8b", (1, 4), "bfloat16", None),
          ("llama4-scout-17b-a16e", (1, 4), "float32", 4),
          ("llama4-scout-17b-a16e", (1, 4), "bfloat16", 12))
#: the checks' traffic: requests, prompt length, generated tokens
CHECK_TRAFFIC = (8, 512, 16)
#: the 48-layer serve: phase 5's traffic
FULL_ARCH = "llama4-scout-17b-a16e"
FULL_TRAFFIC = (chip_smoke.LM_REQUESTS, chip_smoke.LM_PROMPT,
                chip_smoke.LM_GEN)
#: the largest |logit| difference of any prefill or step logit, split
#: against one process, teacher-forced: in float32 the split re-associates
#: the heads' and the vocabulary's sums and the combine weighs the slices'
#: partials (phase 16's float32 kernel-against-plain-route gate read
#: 2.37e-5 at 4 llama4 layers and phase 15's 2.02e-5 at 8 llama3 layers,
#: so 1e-3 at llama3's 32 layers); in bf16 each path rounds the attention
#: and the row products once, in other places, as phase 5's kernel and
#: plain routes do (``chip_smoke.LOGIT_ATOL``). Read on 4 x H100 80GB HBM3,
#: 700.00 W: float32 3.03e-5 / 3.22e-5 (llama3 on (1, 4) / (2, 2)) and
#: 3.74e-5 (llama4, 4 layers); bf16 0.105 (llama3) and 0.137 (llama4, 12
#: layers, routes replayed)
LOGIT_ATOL = {"float32": 1e-3, "bfloat16": chip_smoke.LOGIT_ATOL}
#: the smoke run's heads: m = 4 divides 8/4
SMOKE_HEADS = {"num_heads": 8, "num_kv_heads": 4}


class CollectiveBytes:
    """Counts the bytes of the tensors this process hands to
    ``torch.distributed``'s collectives, by collective (an all-gather's
    output, an all-to-all's input), while ``on`` is set, by standing in
    for them in the module."""

    NAMES = ("all_reduce", "all_gather", "all_to_all_single")

    def __init__(self):
        self.bytes = {n: 0 for n in self.NAMES}
        self.calls = {n: 0 for n in self.NAMES}
        self.on = False

    def __enter__(self):
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

        def counted(name, fn):
            def run(*a, **k):
                if self.on:
                    t = a[0]
                    n = sum(x.numel() * x.element_size() for x in t) \
                        if isinstance(t, list) else t.numel() * t.element_size()
                    if name == "all_to_all_single":
                        n = a[1].numel() * a[1].element_size()
                    self.bytes[name] += n
                    self.calls[name] += 1
                return fn(*a, **k)
            return run

        for n, fn in self.saved.items():
            setattr(dist, n, counted(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(dist, n, fn)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _overrides(dtype: str, layers, smoke: bool) -> dict:
    out = {"compute_dtype": dtype}
    if layers and not smoke:
        out["num_layers"] = layers
    if smoke:
        out.update(SMOKE_HEADS)
    return out


_MESHES: dict = {}


def _mesh(shape: tuple, dev):
    """One ``DeviceMesh`` (and its groups) a shape, made once."""
    if shape not in _MESHES:
        _MESHES[shape] = mesh_lib.make_mesh(shape, dev.type)
    return _MESHES[shape]


def _broadcast(obj, dev):
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def check(dev, arch: str, shape: tuple, dtype: str, layers, smoke: bool,
          traffic: tuple) -> dict | None:
    """One of ``CHECKS`` (module docstring); the record on rank 0."""
    requests, prompt, gen = traffic
    over = _overrides(dtype, layers, smoke)
    kw = dict(smoke=smoke, num_requests=requests, prompt_len=prompt,
              gen_len=gen, seed=SEED, device=dev, overrides=over)
    rank = dist.get_rank()
    one = None
    if rank == 0:
        log = chip_smoke.RouteLog()
        t0 = time.perf_counter()
        with log:
            got = serve.serve_batch(arch, **kw)
        one = {"generated": got["generated"],
               "prefill_logits": got["prefill_logits"].cpu(),
               "step_logits": got["step_logits"].cpu(),
               "ids": [i.cpu() for i in log.ids],
               "seconds": time.perf_counter() - t0}
        del got, log
        _free(dev)
    tokens = _broadcast(None if one is None else one["generated"], dev)
    ids = _broadcast(None if one is None else one["ids"], dev)
    mesh = _mesh(shape, dev)
    replay = (chip_smoke.RouteReplay([i.to(dev) for i in ids]) if ids
              else contextlib.nullcontext())
    t0 = time.perf_counter()
    with replay:
        split = serve.serve_batch(arch, mesh=mesh, force_tokens=tokens, **kw)
    seconds = time.perf_counter() - t0
    ok = bool(dist.get_world_size() == 4)
    rec = None
    if rank == 0:
        errs = {k: float((split[k].cpu() - one[k]).abs().max())
                for k in ("prefill_logits", "step_logits")}
        finite = all(bool(torch.isfinite(split[k]).all())
                     for k in ("prefill_logits", "step_logits"))
        same = float((split["generated"] == one["generated"]).mean())
        ok = ok and finite and max(errs.values()) <= LOGIT_ATOL[dtype] \
            and (dtype != "float32" or same == 1.0)
        rec = {"check": "serve", "arch": arch, "mesh": list(shape),
               "compute_dtype": dtype, "layers": layers,
               "traffic": list(traffic), "max_abs_logit_err": errs,
               "tol": LOGIT_ATOL[dtype], "tokens_equal_share": same,
               "routes_replayed": len(ids), "one_process_s": one["seconds"],
               "mesh_s": seconds, "ok": ok}
    del split
    _free(dev)
    return rec


def full_serve(dev, smoke: bool) -> dict | None:
    """llama4-scout at all its layers on (1, 4), cold then warm."""
    requests, prompt, gen = FULL_TRAFFIC if not smoke else (8, 32, 8)
    over = _overrides("bfloat16", None, smoke)
    mesh = _mesh((1, 4), dev)
    vocab = get_config(FULL_ARCH).vocab_size
    counter = CollectiveBytes()
    make = steps.make_decode_step

    def counted_step(cfg, layout=None):
        step = make(cfg, layout)

        def run(*a):
            counter.on = True
            try:
                return step(*a)
            finally:
                counter.on = False
        return run

    runs = []
    steps.make_decode_step = counted_step
    try:
        with counter:
            for warm in (False, True):
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                counter.bytes = {n: 0 for n in counter.NAMES}
                counter.calls = {n: 0 for n in counter.NAMES}
                t0 = time.perf_counter()
                got = serve.serve_batch(
                    FULL_ARCH, smoke=smoke, num_requests=requests,
                    prompt_len=prompt, gen_len=gen, seed=SEED, device=dev,
                    overrides=over, mesh=mesh)
                _sync(dev)
                total = time.perf_counter() - t0
                peak = (torch.cuda.max_memory_allocated(dev) / 2**20
                        if dev.type == "cuda" else None)
                runs.append({
                    "warm": warm, "prefill_ms": got["prefill_s"] * 1e3,
                    "decode_ms_per_token": got["decode_s"] * 1e3 / gen,
                    "tok_per_s": got["tok_per_s"],
                    "serve_s_with_init": total, "peak_mib": peak,
                    "decode_step_bytes": {n: b / gen for n, b in
                                          counter.bytes.items()},
                    "decode_step_collectives": {n: c / gen for n, c in
                                                counter.calls.items()},
                    "tokens_in_vocab": bool(
                        (got["generated"] >= 0).all()
                        and (got["generated"] < vocab).all())})
                del got
                _free(dev)
    finally:
        steps.make_decode_step = make
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, runs)
    if dist.get_rank():
        return None
    return {"check": "serve full depth", "arch": FULL_ARCH, "mesh": [1, 4],
            "traffic": [requests, prompt, gen], "ranks": every,
            "ok": all(r["tokens_in_vocab"] for rs in every for r in rs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the smoke configs "
                    "on gloo ranks")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    smoke = dev.type == "cpu"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dev = torch.device("cuda", torch.cuda.current_device())
        # float32 products in float32, as the one process's
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(mesh_lib.BACKENDS[dev.type])
    ok = True
    try:
        if dist.get_world_size() != 4:
            raise SystemExit("run on 4 ranks")
        traffic = CHECK_TRAFFIC if not smoke else (4, 32, 8)
        for arch, shape, dtype, layers in CHECKS:
            rec = check(dev, arch, shape, dtype, layers, smoke, traffic)
            if rec is not None:
                ok = ok and rec["ok"]
                print(json.dumps(rec), flush=True)
        rec = full_serve(dev, smoke)
        if rec is not None:
            ok = ok and rec["ok"]
            print(json.dumps(rec), flush=True)
        ok = bool(_broadcast(ok, dev))
        if dist.get_rank() == 0:
            if dev.type == "cuda":
                print(subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True).stdout.strip().splitlines()[0], flush=True)
            print(json.dumps({"ok": ok}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
