"""Training driver: config -> params -> train loop with checkpoints,
ported from ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --full --steps 4 --batch 8 --seq 2048       # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --device cpu --steps 8                       # smoke size, CPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3-8b --device cpu --mesh 2,2 --steps 4   # FSDP, CPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite-moe-1b-a400m --device cpu --mesh 2,2  # MoE, CPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3-8b --device cpu --mesh 2,2 --tensor-parallel

Wires together, on one device (the GPU unless ``device="cpu"``) or,
with ``mesh=``, on each rank of a ``("data", "model")`` mesh:
  * data pipeline (data/pipeline.py — step-indexed synthetic LM
    batches, the same numpy draws as the JAX package's),
  * the train step (models/steps.py: microbatched grad accumulation,
    AdamW, clipping; on the card the attention's forward and backward
    are the flash kernels),
  * CheckpointManager: async atomic saves, resume-from-latest,
  * StragglerMonitor on per-step host timings (one host per rank; each
    rank records its own).

With ``mesh`` (a ``DeviceMesh`` from ``launch.mesh.make_mesh`` or
``make_host_mesh``, over an initialized group of the device's backend)
the params and the AdamW state are placed as the JAX driver places them
(``mesh.param_specs`` / ``opt_specs``): each rank keeps its blocks
(``launch/fsdp.py``; the model is drawn layer by layer and sharded as
it goes), the global batch of ``batch_at`` is split over the batch
axes (``mesh.batch_specs``), and checkpoints are written whole and
restored onto this mesh's blocks. A MoE model routes each microbatch
whole across the batch ranks and computes each expert on the ``model``
ranks that hold it. ``tensor_parallel`` (``--tensor-parallel``) also
splits attention heads, Mamba-2 mixer heads (the gated norm's
statistic summed over the ranks), the dense MLP's columns and the
vocabulary of the embedding, the output head and the loss over the
``model`` ranks (``fsdp.Layout``). ``--mesh DATA,MODEL`` under
``torchrun`` starts the group from torchrun's environment.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.data.pipeline import batch_at
from repro_torch.launch import fsdp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import steps as steps_lib
from repro_torch.optim import adamw_init
from repro_torch.runtime import StragglerMonitor


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 64, ckpt_dir: str | None = None,
          ckpt_every: int = 20, fail_at: int | None = None,
          lr: float = 3e-4, log_every: int = 10,
          num_microbatches: int = 2, seed: int = 0, device=None,
          params=None, overrides: dict | None = None,
          on_step: Optional[Callable[[int, dict, float], None]] = None,
          mesh=None, tensor_parallel: bool = False) -> dict:
    """Train ``arch`` for ``steps`` steps (smoke config unless
    ``smoke=False``) and return the reference's keys (``losses``,
    ``wall_s``, ``final_step``, ``params``, ``opt``, ``stragglers``).

    ``params``: the initial weights (else seeded random ones; updated in
    place); ``overrides``: ``ModelConfig`` fields to replace (e.g.
    ``attn_impl``, ``head_dim``); ``on_step(step, metrics, seconds)``
    is called after every step, ``seconds`` the host clock around the
    step, which ends by reading the loss. ``mesh``: train sharded
    (module docstring); ``params``, when given, are the whole weights
    (each rank copies its blocks), and the returned ``params`` and
    ``opt`` are this rank's blocks; ``tensor_parallel``: ``fsdp.Layout``'s."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    layout = shardings = None
    if mesh is not None:
        if mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a "
                             f"{device.type} run")
        layout = fsdp.Layout(cfg, mesh, tensor_parallel)
        shardings = mesh_lib.named(mesh, {
            "params": layout.specs, "opt": mesh_lib.opt_specs(layout.specs)})
        params = (fsdp.init_params(cfg, layout, seed, device)
                  if params is None else layout.shard(params))
    elif params is None:
        params = model_lib.init_params(cfg, seed, device)
    opt = adamw_init(params)
    step_fn = steps_lib.make_train_step(
        cfg, num_microbatches=num_microbatches, peak_lr=lr,
        total_steps=max(steps, 10), layout=layout)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None:
        got, state = mgr.restore_latest({"params": params, "opt": opt},
                                        device, shardings)
        if got is not None:
            params, opt = state["params"], state["opt"]
            start = got
            print(f"resumed from step {got}")

    rank = dist.get_rank() if mesh is not None else 0
    mon = StragglerMonitor(
        num_hosts=dist.get_world_size() if mesh is not None else 1)
    losses = []
    t_all = time.time()
    try:
        for step in range(start, steps):
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            # step-indexed batches: resume replays the exact data order
            bt = batch_at(cfg, step, batch=batch, seq=seq, seed=seed,
                          device=device)
            t0 = time.time()
            params, opt, metrics = step_fn(params, opt, bt)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            mon.record(rank, dt)
            losses.append(loss)
            if on_step is not None:
                on_step(step, metrics, dt)
            if step % log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f}",
                      flush=True)
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, {"params": params, "opt": opt},
                               extra_meta={"arch": arch},
                               shardings=shardings)
    finally:
        # crash path included: never lose a committed-but-unflushed save
        if mgr is not None:
            mgr.wait()
    wall = time.time() - t_all
    return {"losses": losses, "wall_s": wall, "final_step": steps,
            "params": params, "opt": opt, "stragglers": mon.flagged}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke config)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train sharded over a (data, model) mesh of the "
                    "ranks torchrun starts (NCCL on the GPU, gloo on the "
                    "CPU); a MoE model routes over the whole microbatch "
                    "and splits its experts over MODEL")
    ap.add_argument("--tensor-parallel", action="store_true",
                    help="with --mesh: split attention heads, Mamba-2 "
                    "mixer heads, the dense MLP's columns and the "
                    "vocabulary over MODEL")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        device = resolve_device(args.device)
        dist.init_process_group(mesh_lib.BACKENDS[device.type])
        if device.type == "cuda":
            torch.cuda.set_device(dist.get_rank()
                                  % torch.cuda.device_count())
        mesh = mesh_lib.make_mesh(
            tuple(int(n) for n in args.mesh.split(",")), device)
    try:
        out = train(args.arch, smoke=not args.full, steps=args.steps,
                    batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                    fail_at=args.fail_at, device=args.device, mesh=mesh,
                    tensor_parallel=args.tensor_parallel)
        where = f"rank {dist.get_rank()}: " if mesh is not None else ""
        print(f"{where}done: final loss {out['losses'][-1]:.4f} "
              f"({out['wall_s']:.1f}s), {fsdp.numel(out['params'])} "
              "params stored")
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
