"""The port's sharded training across several ranks, held against one
process: what ``tests/test_torch_fsdp.py`` checks over gloo on the CPU,
here over the collectives of the device's own backend (NCCL on cards).

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_fsdp_cards.py                    # four cards, NCCL
    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_fsdp_cards.py --device cpu       # four gloo ranks

Each rank takes one card (``LOCAL_RANK``). For each (arch, mesh,
compute dtype) of ``RUNS``, the arch's smoke config trains ``STEPS``
steps from the same seeded weights through ``launch/fsdp.py``: the
blocks cast and all-gathered, the float32 gradients summed over the
data ranks, the global norm summed over the shards. The MoE archs
(granite-moe-1b-a400m, llama4-scout) also route each microbatch over
every batch rank's tokens (``fsdp.MoeExchange``) and, on (2, 2),
compute each expert on the ``model`` rank that holds it. Rank 0 then
runs the one-process step on its own device on the same weights and
batches, and holds the losses and grad norms, and in float32 the
gathered params, in bfloat16 the first batch's gathered gradients, to
the CPU tests' bounds (``TOL``); every rank must report the same
losses. The ``tensor_parallel`` runs (``TP_RUNS``) also split each
attention, Mamba-2 mixer and dense MLP over the ``model`` ranks
(``fsdp.Layout(..., tensor_parallel=True)``): llama3-8b with its heads
replaced to 8/4 on (1, 4) and as it is on (2, 2), gemma3-12b 8/4 on
(1, 4), jamba-v0.1-52b 8/4 on (1, 4) (its mixers, attention, dense MLPs,
experts and vocabulary over ``model`` at once) and mamba2-370m on
(2, 2) (the mixers beside the data split); their float32
runs are held on the losses, norms and first-batch gradients
(``tests/test_torch_tp.py``'s bounds, ``TOL["split"]``), their bfloat16
ones on the losses and norms within ``TOL["split bfloat16"]`` and the
first-batch gradients within the bf16 bound; each record holds what the
layout split. The vocabulary splits there too (the smoke V of 128
divides by m): each record's ``vocab_blocks`` lists every rank's row
range and the rows of ``embed`` and columns of ``lm_head`` it gathers,
V/m where split. Then llama3-8b's bf16 (2, 2) run's params and AdamW state are
saved sharded and restored onto the mesh bit for bit, and a save whose
write fails must raise on every rank, in ``save`` and at
``save_async``'s ``wait``. Attention takes the plain route
(``attn_impl="dense"``): the check is of the collectives, and the
kernels' own are ``chip_smoke.py``'s.

Rank 0 prints one JSON line a check and ``{"ok": ...}`` last; every
rank exits 1 if a check failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import CheckpointManager, restore, save  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.data.pipeline import batch_at  # noqa: E402
from repro_torch.launch import fsdp  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model, steps  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
RUNS = ((("llama3-8b", (2, 2), "bfloat16"), ("llama3-8b", (4, 1), "bfloat16"),
         ("llama3-8b", (2, 2), "float32"))
        + tuple((a, m, "float32") for a in MOE_ARCHS
                for m in ((2, 2), (4, 1))))
#: (arch, mesh, compute dtype, config fields) split over ``model``
HEADS = {"num_heads": 8, "num_kv_heads": 4}
TP_RUNS = (("llama3-8b", (1, 4), "float32", HEADS),
           ("llama3-8b", (1, 4), "bfloat16", HEADS),
           ("gemma3-12b", (1, 4), "float32", HEADS),
           ("llama3-8b", (2, 2), "float32", {}),
           ("llama3-8b", (2, 2), "bfloat16", {}),
           ("jamba-v0.1-52b", (1, 4), "float32", HEADS),
           ("mamba2-370m", (2, 2), "float32", {}))
STEPS, BATCH, SEQ, SEED = 2, 8, 64, 0
KW = dict(num_microbatches=2, peak_lr=1e-3, warmup_steps=1, total_steps=10)
#: per compute dtype, ``tests/test_torch_fsdp.py``'s bounds: losses and
#: grad norms (rtol); float32 params (atol); bfloat16 gradients, each
#: leaf's largest error over its largest |value| ("grad")
#: ``"split bfloat16"``'s rtol is 1.0 x a reading on the card: the
#: smallest gap, over the seeds 0-7, between the one-process llama3-8b
#: smoke step in bfloat16 and in float32 on the card-drawn weights this
#: script trains from (heads 8/4, 2 steps of 8 x 64 tokens; the largest
#: relative gap of the losses and grad norms), 3.769e-4 at seed 2, the
#: others 7.0e-4 to 1.26e-3 (``torch_tp_probe.py --one-process
#: --card-weights --seeds 8``, NVIDIA H100 80GB HBM3, 700.00 W). A split
#: is another set of bf16 roundings of the same step, so it is held no
#: closer to the one-process step than that step comes to float32 (the
#: operations round as the CPU's do: ``torch_tp_probe.py --ops``). It was
#: 2e-4, which seed 0's split exceeded on the card at 3.37e-4.
TOL = {"float32": {"rtol": 1e-5, "atol": 1e-6},
       "bfloat16": {"rtol": 2e-5, "grad": 2e-2},
       "split": {"rtol": 1e-5, "grad": 1e-4},
       "split bfloat16": {"rtol": 3.769e-4, "grad": 2e-2}}


def run_steps(params, opt, step_fn, batches):
    losses, norms = [], []
    for b in batches:
        params, opt, m = step_fn(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, opt, losses, norms


def rel_err(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def vocab_blocks(layout, params) -> list:
    """Every rank's row range of the vocabulary (None where it is whole)
    and the V rows of ``embed`` and columns of ``lm_head`` it gathers to
    compute with: V/m of each where the layout splits the vocabulary."""
    with torch.no_grad():
        top = layout.gather_top(params, ("embed", "lm_head"))
    mine = {"ranges": None if layout.vocab is None else layout.vocab.ranges,
            "rows": {k: v.shape[1 if k == "lm_head" else 0]
                     for k, v in top.items()}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def train_check(dev, arch, shape, dtype, split=None):
    """(record, layout, params blocks, opt blocks) of one mesh run; the
    record's comparison is filled on rank 0. ``split``: config fields of
    a ``tensor_parallel`` run (None: the layers computed whole)."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype,
                              attn_impl="dense", **(split or {}))
    batches = [batch_at(cfg, i, batch=BATCH, seq=SEQ, seed=SEED, device=dev)
               for i in range(STEPS)]
    layout = fsdp.Layout(cfg, mesh_lib.make_mesh(shape, dev),
                         tensor_parallel=split is not None)
    t0 = time.perf_counter()
    params = fsdp.init_params(cfg, layout, SEED, dev)
    blocks = vocab_blocks(layout, params)
    params, opt, losses, norms = run_steps(
        params, adamw_init(params),
        steps.make_train_step(cfg, layout=layout, **KW), batches)
    whole = layout.full(params)
    if dtype == "bfloat16" or split is not None:
        # the first batch's gradients from the same initial weights
        start = fsdp.init_params(cfg, layout, SEED, dev)
        _, _, grads = steps.value_and_grad(cfg, start, batches[0],
                                           layout=layout)
        grads = layout.full(grads)
        del start
    rec = {"check": "train", "arch": arch, "mesh": list(shape),
           "compute_dtype": dtype, "steps": STEPS, "batch": BATCH,
           "seq": SEQ, "mesh_s": time.perf_counter() - t0,
           "losses": losses, "grad_norms": norms,
           "stored_numel": fsdp.numel(params),
           "whole_numel": fsdp.numel(whole),
           "split": layout.split if split is not None else None,
           "vocab_blocks": blocks, "config": split}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, losses)
    rec["ranks_agree"] = all(x == losses for x in every)
    if dist.get_rank() == 0:
        ref = model.init_params(cfg, SEED, dev)
        ref, _, ref_losses, ref_norms = run_steps(
            ref, adamw_init(ref), steps.make_train_step(cfg, **KW), batches)
        tol = TOL[dtype if split is None else
                  "split" + (" bfloat16" if dtype == "bfloat16" else "")]
        rec.update({
            "one_process": {"losses": ref_losses, "grad_norms": ref_norms},
            "loss_rel_err": rel_err(losses, ref_losses),
            "norm_rel_err": rel_err(norms, ref_norms), "tol": tol})
        close = (rec["ranks_agree"] and rec["loss_rel_err"] <= tol["rtol"]
                 and rec["norm_rel_err"] <= tol["rtol"])
        if dtype == "bfloat16" or split is not None:
            ref = model.init_params(cfg, SEED, dev)
            _, _, ref_grads = steps.value_and_grad(cfg, ref, batches[0])
            rec["grad_leaf_rel_err"] = max(
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip(model._leaves(grads),
                                model._leaves(ref_grads)))
            close = close and rec["grad_leaf_rel_err"] <= tol["grad"]
        else:
            pairs = list(zip(model._leaves(whole), model._leaves(ref)))
            rec["param_max_abs_err"] = max(float((a - b).abs().max())
                                           for a, b in pairs)
            close = close and all(
                torch.allclose(a, b, rtol=tol["rtol"], atol=tol["atol"])
                for a, b in pairs)
        rec["ok"] = bool(close)
    return rec, layout, params, opt


def save_check(dev, layout, params, opt) -> dict:
    """The sharded save restored onto the same mesh bit for bit; a save
    whose write fails raises on every rank."""
    rank = dist.get_rank()
    box = [tempfile.mkdtemp(prefix="fsdp_cards_") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    tmp = box[0]
    bad = os.path.join(tmp, "not_a_directory")
    if rank == 0:
        Path(bad).write_text("")
    specs = mesh_lib.named(layout.mesh, {
        "params": layout.specs, "opt": mesh_lib.opt_specs(layout.specs)})
    tree = {"params": params, "opt": opt}
    save(os.path.join(tmp, "ckpt"), STEPS, tree, shardings=specs)
    like = layout.shard(model.abstract_params(layout.cfg))
    state = restore(os.path.join(tmp, "ckpt"), STEPS,
                    {"params": like, "opt": adamw_init(like)}, dev, specs)
    unequal = sum(not torch.equal(a, b) for a, b in
                  zip(model._leaves(tree), model._leaves(state)))
    errors = {}
    try:
        save(bad, 1, params, shardings=specs["params"])
        errors["save"] = "no error"
    except (OSError, RuntimeError) as e:
        errors["save"] = type(e).__name__
    mgr = CheckpointManager(bad)
    mgr.save_async(1, params, shardings=specs["params"])
    try:
        mgr.wait()
        errors["save_async"] = "no error"
    except (OSError, RuntimeError) as e:
        errors["save_async"] = type(e).__name__
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"unequal": unequal, "errors": errors})
    dist.barrier()
    if rank == 0:
        shutil.rmtree(tmp)
    writer_raised = all(r["errors"][k] in ("FileExistsError",
                                           "NotADirectoryError")
                        for r in every[:1] for k in r["errors"])
    others_raised = all(v == "RuntimeError" for r in every[1:]
                        for v in r["errors"].values())
    return {"check": "save", "mesh": list(layout.sizes.values()),
            "ranks": every,
            "ok": bool(all(r["unequal"] == 0 for r in every)
                       and writer_raised and others_raised)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs gloo ranks")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(mesh_lib.BACKENDS[dev.type])
    try:
        if dist.get_world_size() != 4:
            raise SystemExit("run on 4 ranks: the meshes are (2, 2), "
                             "(4, 1) and (1, 4)")
        records = []
        for arch, shape, dtype in RUNS:
            rec, layout, params, opt = train_check(dev, arch, shape, dtype)
            records.append(rec)
            if arch == "llama3-8b" and shape == (2, 2) and dtype == "bfloat16":
                records.append(save_check(dev, layout, params, opt))
            del layout, params, opt
        for arch, shape, dtype, split in TP_RUNS:
            records.append(train_check(dev, arch, shape, dtype, split)[0])
        ok = [all(r.get("ok", True) for r in records)]
        dist.broadcast_object_list(ok, src=0)
        if dist.get_rank() == 0:
            if dev.type == "cuda":
                records.append({"check": "device",
                                "name": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()})
            for r in records:
                print(json.dumps(r), flush=True)
            print(json.dumps({"ok": ok[0]}), flush=True)
        return 0 if ok[0] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
