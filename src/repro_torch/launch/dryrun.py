"""One-card dry run: build every (arch x shape) cell's step on the meta
device and size it for one H100, ported from ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --device-bytes 85520809984
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --batch 8 --seq 2048 --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Per cell (``configs.SHAPES`` minus ``SKIPS``) it builds the step the
port would run (``steps.make_train_step`` with ``adamw_init`` state,
``make_prefill_step`` or ``make_decode_step``) on the parameters of
``model.abstract_params`` and the inputs of ``configs.input_specs``,
all on the meta device, and runs it there: every op computes shapes
only, and the kernels' wrappers allocate their outputs and scratch as
on the card and launch nothing (``kernels/ops.py``). ``attn_impl=
"auto"`` is taken as the card takes it, the kernels. Nothing is
allocated on any device. It records

* **argument bytes**, exact: params, optimizer state, batch, caches;
* **estimated peak bytes**: the arguments plus the most bytes of
  storage that the step's own tensors hold alive at once (``PeakTracker``,
  a dispatch mode that follows every storage an op makes until it is
  freed). The card's caching allocator rounds and fragments on top;
  ``chip_smoke.py`` prints the measured peak beside it;
* **model FLOPs** (``models/flops.model_flops``);
* the **compute and memory terms** of a roofline at the H100's dense
  bf16 peak and memory rate, and which dominates. Both are analytic:
  compute is the model FLOPs, memory the least traffic (each argument
  read once, each output in a new storage written once; the writes of
  an in-place update are left out). The JAX version reads both from the
  compiled HLO (``launch/hloparse.py``), which has no torch counterpart;
* whether the estimated peak **fits one card**: under
  ``torch.cuda.get_device_properties(0).total_memory`` where a card is
  present, else under ``--device-bytes``.

``--mesh pod|multipod|both`` sizes each cell on the reference's pod
meshes instead (16 x 16 and 2 x 16 x 16, ``launch.mesh.
make_production_mesh``; ``--mesh one``, the default, is the one-card
run above): per device, the argument bytes of each part (params, AdamW
state and batch; caches, tokens and ``kv_len`` for decode) from
``mesh.param_specs``/``opt_specs``/``batch_specs``/``cache_specs`` on
the meta device, the reference's ``argument_size_in_bytes``, and the
model FLOPs per chip. No per-device activation peak is estimated on a
pod mesh, since the port has no per-device program of such a mesh
(its sharded step gathers weights and computes on one card's rows):
the line says ``peak: not estimated``.

``--batch/--seq/--microbatches`` name a shape of one's
own (a chip phase's); ``--smoke`` takes the reduced configs (whose
16-wide heads the flash kernels refuse: add ``--set head_dim=64``);
``--jobs`` sizes cells in that many processes
(the meta device runs elementwise shape rules in Python, so a Mamba-2
training cell takes tens of seconds on one core).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                 get_smoke_config, input_specs, supported)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.flops import model_flops
from repro_torch.optim import adamw_init

PEAK_FLOPS = 989e12          # H100 SXM dense bf16, FLOP/s
HBM_BW = 3.35e12             # H100 SXM HBM3, bytes/s


def _leaves(tree) -> list:
    return [t for t in model_lib._leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (a view counts
    once)."""
    seen = {}
    for t in _leaves(tree):
        key, st = _storage_key(t)
        seen[key] = st.nbytes()
    return sum(seen.values())


class PeakTracker(TorchDispatchMode):
    """Follows every storage the ops under it create, from the op that
    makes it until it is freed: ``peak`` is the most bytes alive at
    once. Storages alive when it starts (the arguments) are not
    counted."""

    def __init__(self, existing=()):
        super().__init__()
        # keyed by address, so each entry leaves when its storage is freed
        # (a new storage may take a freed one's address)
        self.known: dict[int, Any] = {}
        for t in _leaves(existing):
            key, st = _storage_key(t)
            self.known[key] = weakref.ref(
                st, lambda r, k=key: self.known.pop(k, None))
        self.live: dict[int, tuple[int, Any]] = {}
        self.now = 0
        self.peak = 0

    def _freed(self, key: int, _ref) -> None:
        nbytes, _ = self.live.pop(key, (0, None))
        self.now -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out if isinstance(out, (tuple, list)) else [out]):
            key, st = _storage_key(t)
            if key in self.known or key in self.live:
                continue
            nbytes = st.nbytes()
            self.live[key] = (nbytes,
                              weakref.ref(st, lambda r, k=key: self._freed(k, r)))
            self.now += nbytes
            self.peak = max(self.peak, self.now)
        return out


def cell_shape(shape_name: str, batch: int | None = None,
               seq: int | None = None) -> dict:
    """The cell's ``SHAPES`` entry with ``batch``/``seq`` replaced."""
    sh = dict(SHAPES[shape_name])
    sh["batch"] = batch or sh["batch"]
    sh["seq"] = seq or sh["seq"]
    return sh


def build_step_and_args(cfg, shape_name: str, *, batch: int | None = None,
                        seq: int | None = None,
                        microbatches: int | None = None) -> tuple:
    """(step, its meta arguments by name, in order) of one cell."""
    sh = cell_shape(shape_name, batch, seq)
    spec = input_specs(cfg, shape_name, batch=sh["batch"], seq=sh["seq"])
    params = model_lib.abstract_params(cfg)
    kind = sh["kind"]
    if kind == "train":
        step = steps_lib.make_train_step(
            cfg, num_microbatches=microbatches or cfg.train_microbatches)
        return step, {"params": params, "opt": adamw_init(params),
                      "batch": spec["batch"]}
    if kind == "prefill":
        return steps_lib.make_prefill_step(cfg), {"params": params,
                                                  "batch": spec["batch"]}
    if kind == "decode":
        return steps_lib.make_decode_step(cfg), {"params": params, **spec}
    raise ValueError(kind)


def device_bytes(given: int | None = None) -> int:
    """The budget of one card: ``given``, else the first card's memory."""
    if given:
        return int(given)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to size against: pass "
                           "--device-bytes")
    return torch.cuda.get_device_properties(0).total_memory


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v in ("True", "False"):
        return k, v == "True"
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if "," in v or k.startswith("act_shard"):
        return k, tuple(x for x in v.split(",") if x)
    return k, v


def run_cell(arch: str, shape_name: str, *, budget: int,
             outdir: str | None = None, overrides: dict | None = None,
             tag: str = "", batch: int | None = None, seq: int | None = None,
             microbatches: int | None = None, smoke: bool = False) -> dict:
    """Size one cell (module docstring) and return its record."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.attn_impl == "auto":     # what "auto" resolves to on the card
        cfg = dataclasses.replace(cfg, attn_impl="kernel")
    sh = cell_shape(shape_name, batch, seq)
    t0 = time.perf_counter()
    step, args = build_step_and_args(cfg, shape_name, batch=batch, seq=seq,
                                     microbatches=microbatches)
    arg_bytes = tree_bytes(args)
    tracker = PeakTracker(args)
    with tracker:
        out = step(*args.values())
    fresh = {}
    for t in _leaves(out):
        key, st = _storage_key(t)
        if key not in tracker.known:
            fresh[key] = st.nbytes()
    out_bytes = sum(fresh.values())
    del out
    mf = model_flops(cfg, sh["kind"], sh["batch"], sh["seq"])
    terms = {"compute_s": mf["total"] / PEAK_FLOPS,
             "memory_s": (arg_bytes + out_bytes) / HBM_BW}
    dominant = max(terms, key=terms.get)
    peak = arg_bytes + tracker.peak
    result = {
        "arch": arch, "shape": shape_name, "kind": sh["kind"],
        "batch": sh["batch"], "seq": sh["seq"],
        "microbatches": ((microbatches or cfg.train_microbatches)
                         if sh["kind"] == "train" else None),
        "remat_policy": cfg.remat_policy, "chips": 1, "ok": True,
        "build_s": time.perf_counter() - t0,
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_bytes_by_part": {k: tree_bytes(v)
                                       for k, v in args.items()},
            "output_bytes": out_bytes,
            "step_peak_bytes": tracker.peak,
            "estimated_peak_bytes": peak,
            "device_bytes": budget,
            "fits": peak <= budget,
        },
        "model_flops": mf,
        "roofline": {**terms, "dominant": dominant,
                     "bound_s": max(terms.values())},
    }
    if overrides:
        result["overrides"] = {k: list(v) if isinstance(v, tuple) else v
                               for k, v in overrides.items()}
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        suffix = f".{tag}" if tag else ""
        with open(os.path.join(outdir, f"{arch}_{shape_name}_1xH100"
                               f"{suffix}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def cell_line(r: dict) -> str:
    m, rl = r["memory"], r["roofline"]
    return (f"OK   {r['arch']} x {r['shape']} ({r['batch']} x {r['seq']}): "
            f"args={m['argument_bytes'] / 2**30:.2f}GiB "
            f"peak={m['estimated_peak_bytes'] / 2**30:.2f}GiB "
            f"fits={'yes' if m['fits'] else 'no'} "
            f"dominant={rl['dominant']} bound={rl['bound_s']:.4f}s "
            f"build={r['build_s']:.1f}s")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_mesh_cell(arch: str, shape_name: str, multi_pod: bool, *,
                  outdir: str | None = None, overrides: dict | None = None,
                  tag: str = "", smoke: bool = False) -> dict:
    """One cell on a pod mesh (module docstring): per-device argument
    bytes by part from the specs, model FLOPs per chip."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    sh = SHAPES[shape_name]
    t0 = time.perf_counter()
    spec = input_specs(cfg, shape_name)
    params = model_lib.abstract_params(cfg)
    ps = mesh_lib.param_specs(cfg, mesh, params)
    parts = {"params": mesh_lib.block_bytes(params, ps, mesh)}
    if sh["kind"] == "train":
        parts["opt"] = mesh_lib.block_bytes(
            adamw_init(params), mesh_lib.opt_specs(ps), mesh)
    if sh["kind"] in ("train", "prefill"):
        parts["batch"] = mesh_lib.block_bytes(
            spec["batch"], mesh_lib.batch_specs(cfg, mesh, spec["batch"]),
            mesh)
    else:
        parts["caches"] = mesh_lib.block_bytes(
            spec["caches"], mesh_lib.cache_specs(cfg, mesh, spec["caches"]),
            mesh)
        io = {"tokens": spec["tokens"], "kv_len": spec["kv_len"]}
        io_specs = mesh_lib.batch_specs(cfg, mesh, io)
        for k, t in io.items():
            parts[k] = mesh_lib.block_bytes({k: t}, {k: io_specs[k]}, mesh)
    mf = model_flops(cfg, sh["kind"], sh["batch"], sh["seq"])
    result = {
        "arch": arch, "shape": shape_name, "kind": sh["kind"],
        "batch": sh["batch"], "seq": sh["seq"],
        "mesh": mesh_name(multi_pod), "chips": chips, "ok": True,
        "build_s": time.perf_counter() - t0,
        "memory": {"argument_bytes_per_device": sum(parts.values()),
                   "argument_bytes_by_part": parts,
                   "peak": "not estimated"},
        "model_flops": mf,
        "model_flops_per_chip": mf["total"] / chips,
    }
    if overrides:
        result["overrides"] = {k: list(v) if isinstance(v, tuple) else v
                               for k, v in overrides.items()}
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        suffix = f".{tag}" if tag else ""
        with open(os.path.join(outdir, f"{arch}_{shape_name}_"
                               f"{result['mesh']}{suffix}.json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def mesh_cell_line(r: dict) -> str:
    m = r["memory"]
    parts = " ".join(f"{k}={v / 2**30:.3f}GiB"
                     for k, v in m["argument_bytes_by_part"].items())
    return (f"OK   {r['arch']} x {r['shape']} x {r['mesh']} "
            f"({r['chips']} chips): args/dev="
            f"{m['argument_bytes_per_device'] / 2**30:.3f}GiB ({parts}) "
            f"flops/chip={r['model_flops_per_chip']:.4g} "
            "peak: not estimated")


def run_mesh_cells(cells: list, meshes: list, **kw) -> list:
    """Every (arch, shape) of ``cells`` on each pod mesh of ``meshes``
    (``multi_pod`` flags), in this process (specs only: no step runs);
    prints each line and returns the records (None for a failure)."""
    out = []
    for a, s in cells:
        for mp in meshes:
            try:
                r = run_mesh_cell(a, s, mp, **kw)
                line = mesh_cell_line(r)
            except Exception as e:  # noqa: BLE001 - a cell's failure is its line
                r, line = None, (f"FAIL {a} x {s} x {mesh_name(mp)}: "
                                 f"{type(e).__name__}: {e}\n"
                                 f"{traceback.format_exc()}")
            print(line, flush=True)
            out.append(r)
    return out


def _run_one(job: tuple) -> tuple[dict | None, str]:
    """(record or None, the cell's printed line) of one cell."""
    a, s, kw = job
    try:
        r = run_cell(a, s, **kw)
        return r, cell_line(r)
    except Exception as e:  # noqa: BLE001 - a cell's failure is its line
        return None, (f"FAIL {a} x {s}: {type(e).__name__}: {e}\n"
                      f"{traceback.format_exc()}")


def run_cells(cells: list, *, jobs: int = 1, **kw) -> list:
    """Every (arch, shape) of ``cells`` (or (arch, shape, keywords of its
    own)) in ``jobs`` processes; prints each cell's line as it comes and
    returns the records in ``cells``' order (None for a cell that
    failed)."""
    work = [(c[0], c[1], {**kw, **(c[2] if len(c) > 2 else {})})
            for c in cells]
    if jobs > 1 and len(work) > 1:
        import multiprocessing as mp
        # the training cells take the longest: start them first
        order = sorted(range(len(work)),
                       key=lambda i: SHAPES[work[i][1]]["kind"] != "train")
        got: list = [None] * len(work)
        with mp.get_context("spawn").Pool(min(jobs, len(work))) as pool:
            for i, g in zip(order, pool.imap(_run_one,
                                             [work[i] for i in order])):
                got[i] = _emit(g)
        return got
    return [_emit(_run_one(job)) for job in work]


def _emit(got: tuple) -> dict | None:
    print(got[1], flush=True)
    return got[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every supported cell (what no --arch/--shape "
                    "gives too)")
    ap.add_argument("--outdir", default=None,
                    help="write one JSON record per cell here")
    ap.add_argument("--set", dest="overrides", action="append",
                    default=[], metavar="KEY=VALUE",
                    help="ModelConfig overrides")
    ap.add_argument("--tag", default="", help="suffix for the JSON records")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="one card's memory (default: the first card's)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configs")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--mesh", choices=["one", "pod", "multipod", "both"],
                    default="one",
                    help="one card (default), or the pod meshes 16x16 "
                    "and 2x16x16 (both)")
    args = ap.parse_args(argv)
    overrides = dict(_parse_override(kv) for kv in args.overrides)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    cells = [(a, s) for a in archs for s in shapes if supported(a, s)]
    if args.mesh == "one":
        got = run_cells(cells, jobs=args.jobs,
                        budget=device_bytes(args.device_bytes),
                        outdir=args.outdir, overrides=overrides,
                        tag=args.tag, batch=args.batch, seq=args.seq,
                        microbatches=args.microbatches, smoke=args.smoke)
    else:
        meshes = {"pod": [False], "multipod": [True],
                  "both": [False, True]}[args.mesh]
        got = run_mesh_cells(cells, meshes, outdir=args.outdir,
                             overrides=overrides, tag=args.tag,
                             smoke=args.smoke)
    failures = sum(r is None for r in got)
    print(f"done: {len(got) - failures}/{len(got)} cells OK")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
