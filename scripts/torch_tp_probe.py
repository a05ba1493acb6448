"""Where the bfloat16 tensor-parallel step departs from the one-process
step: ``scripts/torch_fsdp_cards.py``'s llama3-8b bfloat16 (1, 4) run
(heads 8/4, every attention and dense MLP split four ways, the
vocabulary too), repeated with one thing changed at a time.

    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_tp_probe.py                      # four cards, NCCL
    python -m torch.distributed.run --nproc-per-node 4 \\
        scripts/torch_tp_probe.py --device cpu         # four gloo ranks
    python scripts/torch_tp_probe.py --one-process     # one card, no group

``--cpu-weights``: ``model.init_params`` draws every weight with a CPU
generator and moves it to the device, so that the card's runs start
from the CPU's weights (by default each device draws its own from the
same seed, and the card's and the CPU's weights differ).

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

``--layer ARCH`` (no group) repeats ``chip_smoke.py`` phase 17's float32
check of ARCH's first layer (published width, or the smoke config with
``--smoke``; 8 x 2048 tokens, or ``--tokens B S``) and holds both the
whole float32 layer and its split over 4 ranks in turn against the whole
layer in float64 on the same weights and inputs: each tensor's largest
difference over its largest |value|, for the output, the input gradient
and every weight gradient, of the whole and of the split against
float64 and of the split against the whole (the check's own number).
The float64 run keeps the port's float32 upcasts (``Tensor.float``) in
float64 and fails if any function still computes a float32 tensor from
a float32 one. For a Mamba-2 mixer also each head's ``a_log`` gradient
as a sum over the tokens (``ssm.ssd_chunked`` given ``a_log`` broadcast
to every token, whose gradient is each token's term): the largest and
the median cancellation ratio (sum of |terms| over |sum|), and the
largest summed |terms| over the largest |gradient|, the scale of a
float32 rounding of the sum against the check's normaliser. One JSON
line, then the card's name and power limit.

``--ops`` (no group, one card) takes one llama3-8b smoke layer at the
(1, 4) split's shapes (one rank's 2/1 heads of 16 and 32 of the 128 MLP
columns, over ``cards.BATCH`` x ``cards.SEQ`` tokens) and feeds the card
and the CPU the same bf16 inputs, drawn on the CPU and copied across.
Each operation of the step's forward and backward runs in turn (``OPS``:
the norm, the one-process and the split column and row products, RoPE,
the dense attention that ``torch_fsdp_cards.py`` trains with and the
flash kernels at head_dim 64, the gated activation, the f and g sums,
the embedding lookup and the loss, each with its input and weight
gradients), on the card, on the CPU, and on the CPU from the same
inputs upcast to float32 (the operation's exact arithmetic up to float32
roundings). For each output it prints the largest difference over the
largest |value| of card against CPU, card against float32 and CPU
against float32; the products run on the card twice, with cuBLAS's
reduced-precision bf16 reductions allowed (the default) and not. One
JSON line an operation, then the card's name and power limit; with
``--one-process`` too, that mode's lines first.

``--one-process --card-weights`` (no group, one card) runs the card's
one-process steps alone on the weights its own generator draws, as
``torch_fsdp_cards.py`` draws them, from seed 0 or, with ``--seeds N``,
from each of the seeds 0 .. N-1: the readings that
``torch_fsdp_cards.TOL["split bfloat16"]`` is set from (``bf16_gap``'s
``max``, the largest relative gap of the bfloat16 step's losses and grad
norms to the float32 step's).

``--seeds N`` (four ranks) repeats ``torch_fsdp_cards.py``'s llama3-8b
bfloat16 (1, 4) split from each of the seeds 0 .. N-1 (weights and
batches; ``cards.SEED``) and, on rank 0, the one-process steps on the
same weights as ``--one-process --card-weights`` runs them: one JSON
line a seed with the split's gap to one process (``train_check``'s
largest loss and grad norm differences) and the one-process bfloat16
step's gap to float32 (``bf16_gap``'s ``max``), then one line with the
largest split gap, the smallest and largest one-process gap and their
ratios: the readings ``TOL["split bfloat16"]`` is set from.

``--one-process`` (no group; ``--cpu-weights`` implied) computes the
one-process step alone, bfloat16 and float32, on the device and on the
CPU from the same weights and batches: the first batch's gradient
norms and, over ``cards.STEPS`` steps, the losses and grad norms, each
bfloat16 norm's relative gap to the float32 one, and then, leaf by
leaf, the card's gradients against the CPU's in each dtype (the
``TOP`` leaves whose largest difference over their largest |g| is
widest, by layer), to find the layer where the card's bfloat16 step
starts to depart. One JSON line a device, one for the comparison.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(Path(__file__).resolve().parent), str(ROOT / "src"),
                str(ROOT)]

import torch_fsdp_cards as cards  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.executor import resolve_device  # noqa: E402
from repro_torch.data.pipeline import batch_at  # noqa: E402
from repro_torch.launch import fsdp  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, model, steps  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

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


@contextlib.contextmanager
def cpu_weights():
    """``model.init_params`` drawing on the CPU and moving the weights to
    the device asked for (``fsdp.init_params`` and
    ``torch_fsdp_cards.train_check`` call it through the module)."""
    init = model.init_params

    def drawn(cfg, seed=0, device=None, keep=None):
        if str(device) == "meta":             # shapes only, nothing drawn
            return init(cfg, seed, device, keep=keep)
        tree = init(cfg, seed, "cpu", keep=keep)
        return model.tree_map(lambda t: t.to(resolve_device(device)), tree)

    model.init_params = drawn
    try:
        yield
    finally:
        model.init_params = init


def one_process(dev, cpu_draw: bool = True) -> tuple:
    """(record, {dtype: the first batch's gradients, on the CPU}) of the
    one-process step on ``dev`` in bfloat16 and float32 from the same
    CPU-drawn weights (``cpu_draw`` False: drawn by ``dev``'s generator,
    as ``torch_fsdp_cards.py`` draws them): the first batch's gradient
    norms and ``cards.STEPS`` steps' losses and grad norms."""
    out = {"device": str(dev), "cpu_weights": cpu_draw}
    grads = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_smoke_config(ARCH),
                                  compute_dtype=dtype, attn_impl="dense",
                                  **cards.HEADS)
        batches = [batch_at(cfg, i, batch=cards.BATCH, seq=cards.SEQ,
                            seed=cards.SEED, device=dev)
                   for i in range(cards.STEPS)]
        with cpu_weights() if cpu_draw else contextlib.nullcontext():
            params = model.init_params(cfg, cards.SEED, dev)
        _, _, g = steps.value_and_grad(cfg, params, batches[0])
        grads[dtype] = model.tree_map(lambda t: t.detach().cpu(), g)
        _, _, losses, norms = cards.run_steps(
            params, adamw_init(params), steps.make_train_step(cfg, **cards.KW),
            batches)
        out[dtype] = {"first_batch_norm": _norm(g), "losses": losses,
                      "grad_norms": norms}
    f32 = out["float32"]
    out["bf16_gap"] = {
        "first_batch": abs(out["bfloat16"]["first_batch_norm"]
                           - f32["first_batch_norm"])
        / f32["first_batch_norm"],
        "grad_norms": [abs(a - b) / b for a, b in zip(
            out["bfloat16"]["grad_norms"], f32["grad_norms"])],
        "losses": [abs(a - b) / b for a, b in zip(
            out["bfloat16"]["losses"], f32["losses"])]}
    # what ``cards.train_check`` measures of a split, of this step: the
    # largest relative gap of the losses and grad norms over the steps
    out["bf16_gap"]["max"] = max(out["bf16_gap"]["grad_norms"]
                                 + out["bf16_gap"]["losses"])
    return out, grads


def _norm(tree) -> float:
    return sum(float(t.double().square().sum())
               for t in model._leaves(tree)) ** 0.5


def leaf_gaps(a, b) -> list:
    """The ``TOP`` leaves of ``a`` farthest from ``b``'s, each largest
    difference over ``b``'s largest |g|, and every layer's worst."""
    rows = [(float((x.float() - y.float()).abs().max()
                   / y.float().abs().max()), p)
            for p, x, y in zip(_paths(b), model._leaves(a),
                               model._leaves(b))]
    by_layer = {}
    for e, p in rows:
        key = "/".join(p.split("/")[:2]) if p.startswith("layers") else p
        by_layer[key] = max(by_layer.get(key, 0.0), e)
    return {"top": [{"leaf": p, "rel_err": e}
                    for e, p in sorted(rows, reverse=True)[:TOP]],
            "by_layer": by_layer}


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


class Float32Ops(torch.overrides.TorchFunctionMode):
    """Records the functions that compute a float32 tensor from a
    float32 one."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, _ = torch.utils._pytree.tree_flatten((args, kwargs))
        outs, _ = torch.utils._pytree.tree_flatten(out)
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in outs) and any(
                   isinstance(t, torch.Tensor) and t.dtype == torch.float32
                   for t in ins):
            self.seen.add(getattr(func, "__qualname__", str(func)))
        return out


@contextlib.contextmanager
def float64_kept():
    """``Tensor.float()`` leaves a float64 tensor as it is."""
    saved = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else saved(t, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = saved


@contextlib.contextmanager
def a_log_terms(terms: list):
    """``ssm.ssd_chunked`` with ``a_log`` broadcast to (B, L, H): the
    broadcast copy's gradient, each token's term of a_log's gradient, is
    appended to ``terms``. Its zero initial state in x's dtype (the scan
    makes a float32 one)."""
    from repro_torch.models import ssm
    scan = ssm.ssd_chunked

    def per_token(x, dt, a_log, bmat, *a, **k):
        tok = a_log.expand(dt.shape)
        tok.register_hook(terms.append)
        b, _, h, p = x.shape
        k.setdefault("init_state", x.new_zeros(b, h, bmat.shape[-1], p))
        return scan(x, dt, tok, bmat, *a, **k)

    ssm.ssd_chunked = per_token
    try:
        yield
    finally:
        ssm.ssd_chunked = scan


def layer_f64(dev, arch: str, smoke: bool, tokens: tuple) -> dict:
    """``--layer``: the record of ARCH's first layer in float32, whole
    and split, against float64."""
    import chip_smoke
    from repro_torch.configs import get_config
    cfg = (get_smoke_config if smoke else get_config)(arch)
    cfg = dataclasses.replace(cfg, attn_impl="dense")
    spec, layer32 = chip_smoke.tp_layer_weights(cfg, dev)
    shape = (*tokens, cfg.d_model)
    paths = ["out", "x"] + chip_smoke.model_paths(layer32)
    x32, dy32, positions = chip_smoke.tp_layer_inputs(cfg, dev, shape,
                                                      torch.float32)

    def run(dtype, split: bool):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        layer = model.tree_map(
            lambda t: t.detach().to(c.cdtype).requires_grad_(), layer32)
        x = x32.detach().to(c.cdtype).requires_grad_()
        p, sp = layer, None
        if split:
            p, sp = fsdp.split_in_turn(c, 0, layer, chip_smoke.TP_RANKS)
        y, _ = model._apply_block(c, spec, p, x, positions, None, sp)
        grads = torch.autograd.grad(y, [x] + list(model._leaves(layer)),
                                    dy32.to(c.cdtype))
        return [t.detach().double() for t in (y, *grads)]

    terms, ops = [], Float32Ops()
    with float64_kept(), a_log_terms(terms) if spec.mixer == "mamba"             else contextlib.nullcontext():
        c = dataclasses.replace(cfg, compute_dtype="float64")
        layer = model.tree_map(
            lambda t: t.detach().double().requires_grad_(), layer32)
        x = x32.detach().double().requires_grad_()
        with ops:
            y, _ = model._apply_block(c, spec, layer, x, positions, None,
                                      None)
        grads = torch.autograd.grad(y, [x] + list(model._leaves(layer)),
                                    dy32.double())
        ref = [t.detach() for t in (y, *grads)]
        del y, grads, layer, x
    if ops.seen:
        raise SystemExit(f"the float64 layer computed float32 in "
                         f"{sorted(ops.seen)}")
    whole = run("float32", False)
    split = run("float32", True)

    def rel(a, b):
        return float((a - b).abs().max() / max(float(b.abs().max()),
                                               1e-300))

    rows = [{"tensor": n, "whole_vs_f64": rel(w, r),
             "split_vs_f64": rel(t, r), "split_vs_whole": rel(t, w)}
            for n, w, t, r in zip(paths, whole, split, ref)]
    rec = {"arch": cfg.name, "layer": [spec.mixer, spec.mlp],
           "tokens": list(tokens), "ranks": chip_smoke.TP_RANKS,
           "worst_split_vs_whole": max(rows, key=lambda r:
                                       r["split_vs_whole"]),
           "tensors": rows}
    if terms:
        t = torch.cat([t.reshape(-1, t.shape[-1]) for t in terms])
        g = t.sum(0)
        ratio = t.abs().sum(0) / g.abs().clamp_min(1e-300)
        rec["a_log"] = {
            "terms": t.shape[0], "heads": t.shape[1],
            "ratio_max": float(ratio.max()),
            "ratio_median": float(ratio.median()),
            "summed_abs_over_max_grad": float(t.abs().sum(0).max()
                                              / g.abs().max()),
            "grad_vs_leaf": rel(g, ref[paths.index("mamba/a_log")])}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs gloo ranks")
    ap.add_argument("--cpu-weights", action="store_true",
                    help="draw the weights on the CPU, then move them")
    ap.add_argument("--one-process", action="store_true",
                    help="no group: the one-process step on the device "
                    "and on the CPU from the same weights")
    ap.add_argument("--layer", metavar="ARCH",
                    help="no group: phase 17's float32 layer check of "
                    "ARCH against the layer in float64")
    ap.add_argument("--smoke", action="store_true",
                    help="--layer: the smoke config")
    ap.add_argument("--tokens", type=int, nargs=2, default=(8, 2048),
                    metavar=("B", "S"), help="--layer: batch and length")
    ap.add_argument("--card-weights", action="store_true",
                    help="--one-process: the card alone, on the weights "
                    "its generator draws")
    ap.add_argument("--seeds", type=int, default=0, metavar="N",
                    help="4 ranks: the bf16 split and the one-process "
                    "bf16-to-float32 gap from each of N seeds; with "
                    "--one-process --card-weights, that gap alone")
    ap.add_argument("--ops", action="store_true",
                    help="no group: the split layer's operations one at a "
                    "time, on the card and on the CPU from the same inputs")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ops:
        if args.one_process:
            one_process_main(dev)
        return ops_main(dev)
    if args.layer:
        print(json.dumps(layer_f64(dev, args.layer, args.smoke,
                                   tuple(args.tokens))), flush=True)
        if dev.type == "cuda":
            print_card()
        return 0
    if args.one_process and args.card_weights:
        for seed in range(max(args.seeds, 1)):
            cards.SEED = seed
            print(json.dumps({"seed": seed,
                              **one_process(dev, cpu_draw=False)[0]}),
                  flush=True)
        if dev.type == "cuda":
            print_card()
        return 0
    if args.one_process:
        return one_process_main(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(mesh_lib.BACKENDS[dev.type])
    try:
        if dist.get_world_size() != 4:
            raise SystemExit("run on 4 ranks: the mesh is (1, 4)")
        if args.seeds:
            return seeds_main(dev, args.seeds)
        for name, vocab, upcast, reduced, sublayers in VARIANTS:
            with (cpu_weights() if args.cpu_weights
                  else contextlib.nullcontext()), \
                    variant(vocab, upcast, reduced, sublayers):
                rec, *_ = cards.train_check(dev, ARCH, SHAPE, DTYPE,
                                            cards.HEADS)
                gap = gradient_gap(dev)
            if dist.get_rank() == 0:
                out = {"variant": name, "cpu_weights": args.cpu_weights,
                       "vocab_split": vocab,
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
            print_card()
        return 0
    finally:
        dist.destroy_process_group()


def seeds_main(dev, n: int) -> int:
    """``--seeds``: the split's and the one-process step's gaps from
    each of ``n`` seeds (module docstring)."""
    rows = []
    try:
        for seed in range(n):
            cards.SEED = seed
            rec, *_ = cards.train_check(dev, ARCH, SHAPE, DTYPE, cards.HEADS)
            if dist.get_rank():
                continue
            gap = one_process(dev, cpu_draw=False)[0]["bf16_gap"]
            rows.append({"seed": seed,
                         "split_gap": max(rec["loss_rel_err"],
                                          rec["norm_rel_err"]),
                         "one_process_gap": gap["max"],
                         "grad_leaf_rel_err": rec["grad_leaf_rel_err"],
                         "tol": rec["tol"], "within_tol": rec["ok"],
                         "one_process": gap})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        cards.SEED = 0
    if rows:
        split = max(r["split_gap"] for r in rows)
        lo = min(r["one_process_gap"] for r in rows)
        hi = max(r["one_process_gap"] for r in rows)
        print(json.dumps({"seeds": n, "split_gap_max": split,
                          "one_process_gap_min": lo,
                          "one_process_gap_max": hi,
                          "split_max_over_one_process_min": split / lo,
                          "worst_seed_ratio": max(
                              r["split_gap"] / r["one_process_gap"]
                              for r in rows)}), flush=True)
        if dev.type == "cuda":
            print_card()
    return 0


def _rel_gap(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _ops(cfg) -> dict:
    """{name: (function of the inputs dict -> outputs, the input names
    whose gradients to take, the output gradient's name)}: the
    operations ``--ops`` compares, at one rank's share of the (1, 4)
    split of ``cfg``'s layer."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention

    def g_sum(t):
        parts = [t["p0"], t["p1"], t["p2"], t["p3"]]
        return (fsdp._sum_in_order(parts).to(t["x"].dtype),)

    def f_sum(t):
        # _SplitEnter's backward: the three products' float32 partials
        # summed over the ranks, rounded once, added v + k + q
        g = torch.stack([t["p0"], t["p1"], t["p2"]]).to(t["x"].dtype)
        return (g[2] + g[1] + g[0],)

    pos = torch.arange(cards.SEQ).expand(cards.BATCH, cards.SEQ)
    theta = cfg.rope_theta
    return {
        "rmsnorm": (lambda t: (layers.rmsnorm({"scale": t["scale"]},
                                              t["x"]),),
                    ("x", "scale"), "dy"),
        "one-process product x @ w": (lambda t: (t["x"] @ t["wq"],),
                                      ("x", "wq"), "dq"),
        "column product (split)": (
            lambda t: (layers.column_product(t["x"].float(), t["wq"]),),
            ("x", "wq"), "dq"),
        "row product (split)": (
            lambda t: (layers.row_product(t["a"], t["wo"]),),
            ("a", "wo"), "dy"),
        "one-process product a @ wo": (lambda t: (t["a"] @ t["wo"],),
                                       ("a", "wo"), "dy"),
        "rope": (lambda t: (layers.apply_rope(t["q"], pos.to(
            t["q"].device), theta),), ("q",), "do"),
        "dense attention": (
            lambda t: (attention.dense_attention(t["q"], t["k"], t["v"]),),
            ("q", "k", "v"), "do"),
        "flash attention (head_dim 64)": (
            lambda t: (kops.flash_attention(t["q64"], t["k64"], t["v64"]),),
            ("q64", "k64", "v64"), "do64"),
        "silu gate": (lambda t: (layers._act(t["gate"], cfg.act)
                                 * t["up"],), ("gate", "up"), "dh"),
        "f sum": (f_sum, (), None),
        "g sum": (g_sum, (), None),
        "embed lookup": (
            lambda t: (model._embed_tokens(cfg, {"embed": t["embed"]},
                                           t["tokens"]),),
            ("embed",), "dy3"),
        "cross entropy": (
            lambda t: (layers.chunked_cross_entropy_loss(
                t["x"], t["embed"], t["labels"],
                num_chunks=cfg.ce_chunks),), ("x", "embed"), None),
    }


def _ops_inputs(cfg) -> dict:
    """The ``--ops`` inputs, drawn on the CPU from ``cards.SEED`` in
    bf16 (the partials of the sums in float32)."""
    m = SHAPE[1]
    b, s, d, hd = cards.BATCH, cards.SEQ, cfg.d_model, cfg.head_dim
    hq, hkv, ff = cfg.num_heads // m, cfg.num_kv_heads // m, cfg.d_ff // m
    t = b * s
    gen = torch.Generator().manual_seed(cards.SEED)

    def r(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dtype)

    return {"x": r(t, d), "dy": r(t, d), "scale": r(d, scale=0.1),
            "wq": r(d, hq * hd, scale=d ** -0.5), "dq": r(t, hq * hd),
            "a": r(t, hq * hd), "wo": r(hq * hd, d, scale=(hq * hd) ** -0.5),
            "q": r(b, s, hq, hd), "k": r(b, s, hkv, hd),
            "v": r(b, s, hkv, hd), "do": r(b, s, hq, hd),
            "q64": r(b, s, hq, 64), "k64": r(b, s, hkv, 64),
            "v64": r(b, s, hkv, 64), "do64": r(b, s, hq, 64),
            "gate": r(t, ff), "up": r(t, ff), "dh": r(t, ff),
            "p0": r(t, d, dtype=torch.float32),
            "p1": r(t, d, dtype=torch.float32),
            "p2": r(t, d, dtype=torch.float32),
            "p3": r(t, d, dtype=torch.float32),
            "embed": r(cfg.vocab_size, d),
            "tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen),
            "labels": torch.randint(0, cfg.vocab_size, (t,), generator=gen),
            "dy3": r(b, s, d)}


def _run_op(op, inputs: dict, dev, dtype=None) -> list:
    """The op's outputs and its gradients for the named inputs, on
    ``dev``; ``dtype``: the floating inputs cast to it first."""
    fn, wrt, grad_name = op
    t = {}
    for k, v in inputs.items():
        v = v.to(dev)
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        t[k] = v.requires_grad_() if k in wrt else v
    outs = fn(t)
    grads = []
    if wrt:
        dy = [torch.ones_like(outs[0]) if grad_name is None
              else t[grad_name].to(outs[0].dtype)]
        grads = list(torch.autograd.grad(outs, [t[k] for k in wrt], dy))
    return [x.detach() for x in outs] + grads


def ops_main(dev) -> int:
    """``--ops``: one JSON line an operation (module docstring)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              compute_dtype="bfloat16", **cards.HEADS)
    inputs = _ops_inputs(cfg)
    cpu = torch.device("cpu")
    matmul = torch.backends.cuda.matmul
    products = ("product", "attention", "cross entropy")
    for name, op in _ops(cfg).items():
        card = _run_op(op, inputs, dev)
        here = _run_op(op, inputs, cpu)
        f32 = _run_op(op, inputs, cpu, torch.float32)
        names = ["out"] + [f"d{k}" for k in op[1]]
        rec = {"op": name, "outputs": {n: {
            "card_vs_cpu": _rel_gap(a, b), "card_vs_f32": _rel_gap(a, c),
            "cpu_vs_f32": _rel_gap(b, c), "dtype": str(a.dtype)}
            for n, a, b, c in zip(names, card, here, f32)}}
        if dev.type == "cuda" and any(p in name for p in products):
            saved = matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = False
            try:
                plain = _run_op(op, inputs, dev)
            finally:
                matmul.allow_bf16_reduced_precision_reduction = saved
            for n, a, c in zip(names, plain, f32):
                rec["outputs"][n]["card_no_reduced_vs_f32"] = _rel_gap(a, c)
        print(json.dumps(rec), flush=True)
    if dev.type == "cuda":
        print_card()
    return 0


def print_card() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "nvidia_smi": smi.stdout.strip()}), flush=True)


def one_process_main(dev) -> int:
    """``--one-process``: one JSON line for ``dev``, one for the CPU,
    one for the leaf-by-leaf comparison of their gradients."""
    runs = [one_process(d) for d in dict.fromkeys([dev,
                                                   torch.device("cpu")])]
    for rec, _ in runs:
        print(json.dumps(rec), flush=True)
    if len(runs) == 2:
        (_, card), (_, cpu) = runs
        print(json.dumps({"card_vs_cpu": {
            dtype: leaf_gaps(card[dtype], cpu[dtype]) for dtype in card}}),
            flush=True)
    if dev.type == "cuda":
        print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
