"""Where the bfloat16 tensor-parallel step departs from the one-process
step: ``scripts/torch_fsdp_cards.py``'s llama3-8b bfloat16 (1, 4) run
(heads 8/4, every attention and dense MLP split four ways, the
vocabulary too), repeated with one thing changed at a time.

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_tp_probe.py                      # four cards, NCCL
    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_tp_probe.py --device cpu         # four gloo ranks

Each variant runs ``torch_fsdp_cards.train_check`` (two steps against
the one-process step on the same weights and batches: the losses' and
grad norms' largest relative differences, the first batch's gradients'
largest difference over each leaf's largest |g|) and then, on the first
batch from the initial weights, both gradients' global norms, the
leaves whose squared norms differ most, as shares of the one-process
step's squared norm, and the global norm of the one-process float32
step's gradient on the same weights, which neither bf16 step rounds.
The variants, in order:

* ``split``: as ``torch_fsdp_cards.py`` runs it;
* ``vocab whole``: ``fsdp.vocab_splits`` answers no, so ``embed`` and
  ``lm_head`` are gathered whole and the loss is the one-process loss,
  while the layers still split;
* ``upcast``: ``layers._mm_f32`` upcasts its operands and multiplies in
  float32, as it does off the card, in place of the card's
  float32-output GEMM of the bf16 operands;
* ``no reduced reductions``: cuBLAS may not reduce bf16 GEMMs' partial
  sums in reduced precision
  (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  off), in the split and the one-process step alike;
* ``upcast, no reduced reductions``: both;
* ``attention split only`` and ``MLP split only``: ``split_sublayers``
  keeps one of the two, so that the other is computed whole;
* ``split again``: the first variant again, to show the run repeats.

Rank 0 prints one JSON line a variant, then the device's name and power
limit on the card. It checks nothing and exits 0: ``torch_fsdp_cards.py``
holds the bounds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fsdp_cards as cards  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.data.pipeline import batch_at  # noqa: E402
from repro_torch.launch import fsdp  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, model, steps  # noqa: E402

ARCH, SHAPE, DTYPE = "llama3-8b", (1, 4), "bfloat16"
BOTH = ("attn", "mlp")
#: (name, vocabulary split, ``_mm_f32`` upcasts, reduced bf16
#: reductions, the sublayers that may split)
VARIANTS = (("split", True, False, True, BOTH),
            ("vocab whole", False, False, True, BOTH),
            ("upcast", True, True, True, BOTH),
            ("no reduced reductions", True, False, False, BOTH),
            ("upcast, no reduced reductions", True, True, False, BOTH),
            ("attention split only", True, False, True, ("attn",)),
            ("MLP split only", True, False, True, ("mlp",)),
            ("split again", True, False, True, BOTH))
#: leaves listed per variant, by their share of the squared norm's gap
TOP = 6


def _upcast_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


@contextlib.contextmanager
def variant(vocab: bool, upcast: bool, reduced: bool, sublayers: tuple):
    """The module functions and the cuBLAS flag of one variant, put back
    after it."""
    matmul = torch.backends.cuda.matmul
    saved = (fsdp.vocab_splits, fsdp.split_sublayers, layers._mm_f32,
             matmul.allow_bf16_reduced_precision_reduction)
    split = fsdp.split_sublayers
    if not vocab:
        fsdp.vocab_splits = lambda specs, m: False
    fsdp.split_sublayers = lambda cfg, specs, m: tuple(
        s for s in split(cfg, specs, m) if s in sublayers)
    if upcast:
        layers._mm_f32 = _upcast_mm
    matmul.allow_bf16_reduced_precision_reduction = reduced
    try:
        yield
    finally:
        (fsdp.vocab_splits, fsdp.split_sublayers, layers._mm_f32,
         matmul.allow_bf16_reduced_precision_reduction) = saved


def _paths(tree, prefix: str = "") -> list:
    """Leaf paths in ``model._leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in
                _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in
                _paths(t, f"{prefix}{i}/")]
    return [prefix[:-1]]


def gradient_gap(dev) -> dict | None:
    """The first batch's gradients from the initial weights, split and
    one process: their global norms and the ``TOP`` leaves whose squared
    norms differ most, and the one-process float32 gradient's norm (rank
    0; None elsewhere)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype=DTYPE,
                              attn_impl="dense", **cards.HEADS)
    batch = batch_at(cfg, 0, batch=cards.BATCH, seq=cards.SEQ,
                     seed=cards.SEED, device=dev)
    layout = fsdp.Layout(cfg, mesh_lib.make_mesh(SHAPE, dev),
                         tensor_parallel=True)
    start = fsdp.init_params(cfg, layout, cards.SEED, dev)
    _, _, grads = steps.value_and_grad(cfg, start, batch, layout=layout)
    grads = layout.full(grads)
    if dist.get_rank() != 0:
        return None
    ref = model.init_params(cfg, cards.SEED, dev)
    _, _, want = steps.value_and_grad(cfg, ref, batch)
    paths = _paths(want)
    got_l, want_l = list(model._leaves(grads)), list(model._leaves(want))
    sq = [(float(a.double().square().sum()), float(b.double().square().sum()))
          for a, b in zip(got_l, want_l)]
    total = sum(b for _, b in sq)
    rows = sorted(
        ({"leaf": p, "sq_gap_share": (a - b) / total,
          "rel_err": float((x - y).abs().max() / y.abs().max())}
         for p, (a, b), x, y in zip(paths, sq, got_l, want_l)),
        key=lambda r: -abs(r["sq_gap_share"]))
    norm, ref_norm = sum(a for a, _ in sq) ** 0.5, total ** 0.5
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    _, _, g32 = steps.value_and_grad(
        cfg32, model.init_params(cfg32, cards.SEED, dev), batch)
    f32 = sum(float(t.double().square().sum())
              for t in model._leaves(g32)) ** 0.5
    return {"norm": norm, "one_process_norm": ref_norm,
            "norm_rel_err": abs(norm - ref_norm) / ref_norm,
            "float32_norm": f32, "leaves": rows[:TOP]}


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
            raise SystemExit("run on 4 ranks: the mesh is (1, 4)")
        for name, vocab, upcast, reduced, sublayers in VARIANTS:
            with variant(vocab, upcast, reduced, sublayers):
                rec, *_ = cards.train_check(dev, ARCH, SHAPE, DTYPE,
                                            cards.HEADS)
                gap = gradient_gap(dev)
            if dist.get_rank() == 0:
                out = {"variant": name, "vocab_split": vocab,
                       "upcast": upcast, "reduced_reductions": reduced,
                       "split": rec["split"]}
                out.update({k: rec[k] for k in (
                    "loss_rel_err", "norm_rel_err", "grad_leaf_rel_err",
                    "losses", "grad_norms", "one_process", "tol")})
                out["within_tol"] = rec["ok"]
                out["vocab_rows"] = rec["vocab_blocks"][0]["rows"]
                out["first_batch"] = gap
                print(json.dumps(out), flush=True)
        if dist.get_rank() == 0 and dev.type == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True)
            print(json.dumps({"device": torch.cuda.get_device_name(0),
                              "count": torch.cuda.device_count(),
                              "nvidia_smi": smi.stdout.strip()}),
                  flush=True)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
