"""Fully sharded parameters over a ``("data", "model")`` (or ``("pod",
"data", "model")``) ``DeviceMesh``: each rank holds its block of every
leaf, as ``launch/mesh.py``'s specs say, and blocks move between ranks
where the model uses them. The reference leaves this to GSPMD, which
places each leaf by its ``NamedSharding`` and inserts the collectives.

* **Storage.** ``Layout.shard`` (or ``init_params``, which draws the
  model layer by layer and keeps each layer's blocks at once, so no
  rank ever holds the whole float32 model) keeps only this rank's
  block of each leaf: the rank's parameter, gradient, m and v bytes are
  the reference's per-device argument bytes.
* **Compute runs on gathered weights.** ``gather_layer`` casts each
  block to the compute dtype (which halves the traffic; the cast is
  elementwise, so the values are those of casting the whole leaf) and
  all-gathers it over the axes its spec uses. The model gathers each
  layer inside the function that ``checkpoint`` wraps, so the backward
  gathers it again instead of keeping every layer's full weights.
* **Gradients.** The gather's backward upcasts the full-shape gradient
  to float32, sums it over the ranks that split the batch (``pod``,
  ``data``) and keeps this rank's block: a reduce-scatter in float32,
  as the reference's gradients of its float32 params are float32 (a
  bfloat16 sum would drift). A slice alone, which is what DTensor's
  Replicate-to-Shard backward does, would drop the other ranks' rows.
  The sum is an all-reduce followed by the slice (gloo has no
  reduce-scatter).
* **The ``model`` axis splits the experts' compute.** Where the specs
  put a MoE layer's E experts over ``model`` (E divisible by its size),
  ``gather_layer`` gathers them over ``data`` only and each ``model``
  rank computes the assignments routed to its E/m experts
  (``models/moe.py``, expert parallelism, as the reference's rules name
  it).
* **With ``tensor_parallel``, it splits attention, the dense MLP and the
  Mamba-2 mixer too.** Where the specs put the columns of
  ``wq``/``wk``/``wv`` and the rows of ``wo`` over ``model`` and H and
  Hkv divide by its size m, each ``model`` rank computes its H/m query
  and Hkv/m KV heads (rotation, norms, masks and the flash kernel on
  those heads) and their rows of ``wo``; where ``wi_gate``/``wi_up``'s
  columns and ``wo``'s rows are over it and d_ff divides by m, its
  d_ff/m columns of the dense MLP; where ``wz``/``wx``/``wdt``'s
  columns, ``wo``'s rows and ``dt_bias``/``a_log``/``D`` are over it and
  the mixer's heads divide by m, its H/m SSD heads (``models/ssm.py``'s
  ``mamba2_share_in``/``_out``: z, x and dt on its columns, the causal
  conv on its d_inner/m x-channels, the scan, the D skip and the gate on
  its heads, its rows of ``wo``). B and C depend on no head: every rank
  computes them whole (``mamba2_share_bc``) from the whole ``wB``/``wC``
  and the B/C channels of the conv, and their gradient, each rank's
  partial over its heads, is summed over the ranks where B and C enter
  the heads and rounded once (``_SharedEnter``). ``gather_layer``
  gathers the ``SPLIT_LEAVES`` over the batch axes only, and
  ``Layout.split`` records, layer by layer, which sublayers split. The
  input enters through f and the row-parallel output leaves through g
  (``ModelSplit``), both summed over ``model`` in float32 over partials
  that were not rounded to the compute dtype, and rounded once: the row
  product (``layers.row_product``) and the column products' input
  gradients (``layers.column_product``) are float32 products (on the
  card a float32-output GEMM, on the CPU the operands upcast), each
  input gradient summed over the ranks and rounded once, then the
  products' added in the compute dtype as the one-process backward adds
  them. The rest of a split sublayer (attention's ``q_norm``/``k_norm``;
  the mixer's ``wB``, ``wC``, ``conv_w``, ``conv_b`` and ``norm``) is
  gathered whole as float32, its gradient summed over ``model`` too
  (``partial``); the mixer reads the rank's channels of ``conv_w``,
  ``conv_b`` and ``norm`` (``mixer_channels``: ``conv_w``'s stored block
  does not follow the heads). The mixer's gated RMSNorm takes its mean
  of squares over all d_inner channels, so each rank's float32 sum of
  squares is summed over ``model`` in the middle of its share, the third
  collective beside f and g (``_StatSum``, whose backward is an
  all-reduce too: each rank's gradient of the statistic is a partial),
  and ``ModelSplit.run_staged`` runs the share in two stages around it.
  Where the specs put ``embed``'s rows and ``lm_head``'s columns over
  ``model`` (V divides by m), the vocabulary splits as well
  (``VocabSplit``, ``Layout.vocab``): each rank gathers its V/m rows
  over the batch axes only, looks up the tokens it holds (zeros
  elsewhere, summed over ``model``: exact, one rank holds each row) and
  computes the cross-entropy on its V/m logits, the max, the sum of
  exponentials and the gold logit combined over ``model``; a tied table
  is read as the same block twice. MoE layers' shared experts and any
  sublayer or table whose counts do not divide by m are gathered whole,
  and every rank along ``model`` computes the same rows with them; at m
  = 1 nothing splits.
  It is off by default: a split re-associates the sums of every split
  product, so that the step is no longer the one-process step's
  arithmetic up to the order of the batch ranks' gradient sums (in
  bfloat16 a sum that rounds the other way changes what follows it;
  ``tests/test_torch_tp.py`` holds the split step to its own bounds).
* **Batches.** Every rank builds the same global batch; ``local_batch``
  keeps its rows of each microbatch (per ``batch_specs``), which must
  split evenly over (pod, data). The loss divides each rank's summed
  nll by the token count summed over those ranks (``batch_sum``), so
  the ranks' losses and gradients add up to the global ones.
* **MoE routing is the whole microbatch's.** Capacity, each
  assignment's rank within its expert and the Switch aux loss are
  computed over every batch rank's tokens, as the reference computes
  them over the whole microbatch: ``MoeExchange`` gathers each rank's
  per-expert counts once a MoE layer and microbatch (inside the
  checkpointed function, so the recompute gathers them again), and
  each rank's aux is its share of the global one, so that
  ``batch_sum`` gives the reference's.

* **Serving** (``ServeLayout``, ``launch/serve.py``'s ``serve_batch(...,
  mesh=)``). Forward only, with the same splits: each rank holds its
  heads' columns of wq/wk/wv and rows of wo, its d_ff/m columns of a
  dense MLP, its V/m rows of ``embed``/``lm_head`` and its E/m experts;
  every leaf the split does not compute on by block (norms, the router,
  the shared expert) is held whole along ``model`` from load
  (``serve_specs``), so at ``data`` = 1 no weight moves in a step; over
  ``data`` > 1 the FSDP dims are gathered layer by layer. The batch
  splits over (pod, data) where it divides (``batch_specs``), else every
  batch rank computes all of it. The decode caches follow
  ``cache_specs``: the sequence over ``model`` (over ``data`` too where
  the batch cannot take it), so prefill's caches, computed on each
  rank's heads, are relaid to each rank's slots of every head
  (``ServeLayout.fill_caches``, one all-to-all a layer), and each decode
  step runs the decode kernel's partial mode over the rank's slice and
  combines the rows' partials over the ranks the sequence spans
  (``CacheSplit``, ``models/attention.py``'s ``combine_partials``).
  Mamba-2 layers do not serve split (their conv cache's channels over
  ``model`` meet the split mixer's B and C held whole): ``ServeLayout``
  raises for them.

Collectives run over the mesh's own groups (one per axis of size > 1),
so a mesh over a subgroup of the world works (``runtime/elastic.py``).
At world 1 no collective runs and the results are those of the
one-process path, bit for bit.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models import ssm as ssm_lib

Params = dict[str, Any]


def batch_ranks(mesh) -> int:
    """How many ranks split the batch: the product of the pod and data
    axis sizes."""
    return math.prod(sharding.axis_sizes(mesh).get(a, 1)
                     for a in mesh_lib.BATCH)


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` in the tree's structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


class _Gather(torch.autograd.Function):
    """Forward: cast the block, all-gather it. Backward: upcast the
    gradient to float32, sum it over the batch ranks, keep the block.
    ``partial``: the leaf is used on each ``model`` rank's share of a
    split sublayer, so its gradient there is a partial sum: the gathered
    leaf is float32 (the cast's values) and its gradient is summed over
    ``model`` as well, in float32."""

    @staticmethod
    def forward(ctx, shard, layout, spec, dtype, partial):
        ctx.layout, ctx.spec, ctx.dtype = layout, spec, shard.dtype
        ctx.partial = partial
        x = shard if dtype is None else shard.to(dtype)
        ctx.cast = x.dtype
        x = layout.all_gather(x, spec)
        return x.float() if partial else x

    @staticmethod
    def backward(ctx, grad):
        g = grad.float()
        if ctx.partial:
            # rounded once, to the dtype the one-process leaf's gradient
            # takes
            g = g.contiguous()
            dist.all_reduce(g, group=ctx.layout.groups[mesh_lib.TP])
            g = g.to(ctx.cast).float()
        g = ctx.layout.reduce_block(g, ctx.spec)
        return g.to(ctx.dtype), None, None, None, None


class _ModelSum(torch.autograd.Function):
    """g: forward, the sum over the ``model`` ranks; backward, the
    identity (what follows is replicated along ``model``)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ModelEnter(torch.autograd.Function):
    """f: forward, the identity; backward, the gradient summed over the
    ``model`` ranks (each holds its experts' share of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _StatSum(torch.autograd.Function):
    """The third collective of a split sublayer, beside f and g: a
    statistic of every rank's channels (the mixer's float32 sum of
    squares) summed over the ``model`` ranks, forward and backward. What
    follows the sum is not replicated along ``model``: each rank
    normalises its own channels, so each rank's gradient of the sum is a
    partial and the whole gradient is their sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SharedEnter(torch.autograd.Function):
    """f of a tensor that every ``model`` rank computes whole and reads
    on its own heads (the mixer's B and C): forward, a float32 copy;
    backward, each rank's float32 partial gradient summed over the ranks
    and rounded once to the tensor's dtype, as the one process rounds
    it, then handed on by the group's first rank alone (the others hand
    on zeros), so that what computed the tensor gets the whole gradient
    once and its leaves' and input's partial sums over the ranks add up
    to it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.dtype = group, x.dtype
        return x.float()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        if dist.get_rank(ctx.group) != 0:
            grad.zero_()
        return grad.to(ctx.dtype), None


class _SplitEnter(torch.autograd.Function):
    """f of a split sublayer's ``n`` column products: forward, ``n``
    float32 copies of ``x``, one a product; backward, each product's
    input gradient (a float32 partial sum over this rank's heads or
    columns) summed over the ``model`` ranks in float32, in one
    all-reduce, and rounded once to ``x``'s dtype, then the products'
    gradients added in that dtype, the last product's first: the
    one-process backward's order, where autograd runs the node made
    last first (``_qkv``: v, then k, then q). ``group`` None: the ranks
    were computed in turn in this process, and autograd has already
    summed their partials in float32."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.dtype = group, x.dtype
        return tuple(x.float() for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        g = torch.stack(grads)
        if ctx.group is not None:
            dist.all_reduce(g, group=ctx.group)
        g = g.to(ctx.dtype)
        out = g[-1]
        for i in reversed(range(len(grads) - 1)):
            out = out + g[i]
        return out, None, None


class ModelSplit:
    """What a layer whose ``sublayers`` ("attn", "mamba", "mlp") are
    split over the ``model`` ranks of ``group`` needs
    (``models/model.py``):
    ``run(share, p, x, n)`` is the sublayer's output from this rank's
    ``share(p, xs)``, a float32 partial sum over the ranks, of its input
    ``x`` entered through f (``_SplitEnter``, ``xs`` one float32 copy
    for each of the ``n`` column products), summed by g in float32 and
    rounded once to ``x``'s dtype. ``group`` None is the stand-in for
    the collectives on one device: ``p`` is then a list of every rank's
    tree, each rank's share is computed in turn and the shares are
    summed in float32, as the all-reduce would sum them."""

    def __init__(self, group, sublayers: tuple):
        self.group = group
        self.sublayers = sublayers

    def run(self, share, p, x: torch.Tensor, n: int) -> torch.Tensor:
        xs = _SplitEnter.apply(x, self.group, n)
        if self.group is None:
            y = _sum_in_order([share(q, xs) for q in p])
        else:
            y = _ModelSum.apply(share(p, xs), self.group)
        return y.to(x.dtype)

    def run_staged(self, shared, first, second, p, x: torch.Tensor,
                   n: int) -> torch.Tensor:
        """``run`` of a share whose middle needs a statistic of every
        rank's channels (the mixer's gated RMSNorm) and which reads a
        tensor that depends on no rank's block (the mixer's B and C):
        ``shared(p, xs)`` is that tensor, computed whole and entered
        through ``_SharedEnter`` (the stand-in computes it once, as
        float32, and autograd sums the ranks' gradients into it);
        ``first(p, xs, shared)`` is (what the rank carries on, its
        float32 part of the statistic); the parts are summed over the
        ranks (``_StatSum``) and ``second(p, carried, total)`` is the
        rank's float32 partial output. The stand-in runs every rank's
        first stage, sums the parts in rank order, then runs every
        rank's second stage."""
        xs = _SplitEnter.apply(x, self.group, n)
        if self.group is None:
            common = shared(p[0], xs).float()
            mids = [first(q, xs, common) for q in p]
            total = _sum_in_order([s for _, s in mids])
            y = _sum_in_order([second(q, c, total)
                               for q, (c, _) in zip(p, mids)])
        else:
            c, s = first(p, xs, _SharedEnter.apply(shared(p, xs),
                                                   self.group))
            y = _ModelSum.apply(second(p, c, _StatSum.apply(s, self.group)),
                                self.group)
        return y.to(x.dtype)

    def ranks(self, p) -> list:
        """The ``model`` ranks whose shares this process computes: its
        own, or the stand-in's every rank (``p`` its list of trees)."""
        if self.group is None:
            return list(range(len(p)))
        return [dist.get_rank(self.group)]

    def gather(self, parts: list, dim: int) -> torch.Tensor:
        """Every rank's block of a tensor split over the ``model`` ranks
        (``parts``: this process's, one a rank it computes), concatenated
        along ``dim`` in rank order: an all-gather, outside autograd."""
        if self.group is None:
            return torch.cat(parts, dim)
        x = parts[0].contiguous()
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(
            self.group))]
        dist.all_gather(out, x, group=self.group)
        return torch.cat(out, dim)

    def sum(self, parts: list) -> torch.Tensor:
        """g of float32 partials: their sum over the ``model`` ranks."""
        if self.group is None:
            return _sum_in_order(parts)
        return _ModelSum.apply(parts[0], self.group)


class CacheSplit:
    """The decode caches' sequence split over the ranks of ``groups``
    (the process groups of the axes ``cache_specs`` puts it over, major
    first; empty where the sequence stays whole): ``ranges`` holds the
    slots ``(lo, hi)`` of each slice this process keeps, this rank's
    alone. ``groups`` None is the stand-in on one device: every rank's
    slice in rank order, the partials combined here as the all-reduces
    would (``models/attention.py``'s ``combine_partials``)."""

    def __init__(self, groups, ranges):
        self.groups = groups
        self.ranges = tuple(ranges)

    @property
    def split(self) -> bool:
        """Whether the slices are parts of the sequence, to be combined."""
        return self.groups is None or bool(self.groups)

    def reduce(self, parts: list, op: str) -> torch.Tensor:
        """The ``op`` ("max" or "sum") over the ranks of ``parts`` (this
        process's, one a slice it keeps)."""
        if self.groups is None:
            if op == "max":
                return torch.stack(parts).amax(0)
            return _sum_in_order(parts)
        x = parts[0].contiguous().clone()
        for group in self.groups:
            dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM, group=group)
        return x


#: the leaves of a split sublayer that each ``model`` rank holds a block
#: of and computes with: row blocks of ``wo``, head blocks of the 1-D
#: leaves, column blocks of the rest
SPLIT_LEAVES = {"attn": ("wq", "wk", "wv", "wo"),
                "mamba": ("wz", "wx", "wdt", "dt_bias", "a_log", "D", "wo"),
                "mlp": ("wi_gate", "wi_up", "wo")}


def _split_dim(name: str, spec: tuple) -> int:
    """The dim of a ``SPLIT_LEAVES`` leaf that the ``model`` ranks
    split."""
    return 0 if name == "wo" or len(spec) == 1 else 1


def _counts(cfg) -> dict:
    """What each splittable sublayer's split must divide: the heads, the
    KV heads, d_ff, the mixer's SSD heads."""
    _, nheads = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm_expand,
                                 cfg.ssm_head_dim)
    return {"attn": (cfg.num_heads, cfg.num_kv_heads), "mamba": (nheads,),
            "mlp": (cfg.d_ff,)}


def without_model(spec: tuple) -> tuple:
    """``spec`` with the ``model`` axis taken out of every entry: what a
    leaf is gathered over when each ``model`` rank computes with its own
    block of it."""
    out = []
    for entry in spec:
        axes = tuple(a for a in sharding.entry_axes(entry)
                     if a != mesh_lib.TP)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(out)


def split_sublayers(cfg, specs: Params, m: int) -> tuple:
    """Which sublayers of one layer (``specs``: its spec tree) compute
    split over ``model`` of size ``m``: attention where the specs put
    the columns of wq/wk/wv and the rows of wo over ``model`` and H and
    Hkv divide by m; the Mamba-2 mixer where they put wz/wx/wdt's
    columns, wo's rows and dt_bias/a_log/D there and its heads divide by
    m; the dense MLP where they put wi_gate/wi_up's columns and wo's
    rows there and d_ff divides by m. None at m = 1."""
    if m == 1:
        return ()
    counts = _counts(cfg)
    out = []
    for name, leaves in SPLIT_LEAVES.items():
        if name not in specs or any(n % m for n in counts[name]):
            continue
        dims = [specs[name][k][_split_dim(k, specs[name][k])]
                for k in leaves]
        if all(mesh_lib.TP in sharding.entry_axes(e) for e in dims):
            out.append(name)
    return tuple(out)


class VocabSplit:
    """The vocabulary split over the ``model`` ranks of ``group``
    (``models/model.py``'s lookup, ``models/layers.py``'s cross-entropy):
    ``ranges`` holds the row range ``(lo, hi)`` of the V rows of each
    block of ``embed`` (``lm_head``'s columns) that this process
    computes with: this rank's alone. ``group`` None is the stand-in on
    one device: every rank's range in rank order, each rank's share
    computed in turn and combined here as the all-reduces would."""

    def __init__(self, group, ranges):
        self.group = group
        self.ranges = tuple(ranges)

    def blocks(self, table) -> list:
        """The blocks this process computes with: a rank's ``table``, or
        the stand-in's list of every rank's as it is."""
        return [table] if self.group is not None else list(table)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """f of the hidden states that meet the vocab blocks: a float32
        copy whose gradient, float32 partial sums over each rank's
        columns, is summed over ``model`` and rounded once to ``x``'s
        dtype."""
        return _SplitEnter.apply(x, self.group, 1)[0]

    def sum(self, parts: list) -> torch.Tensor:
        """g: the sum over the ranks of each block's ``parts`` (the
        backward hands each its gradient)."""
        if self.group is not None:
            return _ModelSum.apply(parts[0], self.group)
        return _sum_in_order(parts)

    def combine(self, parts: list, op: str) -> torch.Tensor:
        """The ``op`` ("sum", "max" or "min") over the ranks of each
        block's ``parts``, outside autograd."""
        if self.group is not None:
            x = parts[0].clone()
            dist.all_reduce(x, op={"max": dist.ReduceOp.MAX,
                                   "min": dist.ReduceOp.MIN}.get(
                                       op, dist.ReduceOp.SUM),
                            group=self.group)
            return x
        if op == "max":
            return torch.stack(parts).amax(0)
        if op == "min":
            return torch.stack(parts).amin(0)
        return _sum_in_order(parts)


def _sum_in_order(parts: list) -> torch.Tensor:
    """The stand-in's sum over the ranks, in rank order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def vocab_splits(specs: Params, m: int) -> bool:
    """Whether the vocabulary splits over ``model`` of size ``m``: the
    specs put ``model`` on ``embed``'s rows or ``lm_head``'s columns
    (``mesh._sh`` puts it there where m divides V). Never at m = 1."""
    if m == 1:
        return False
    dims = [specs["embed"][0]] if "embed" in specs else []
    if "lm_head" in specs:
        dims.append(specs["lm_head"][1])
    return any(mesh_lib.TP in sharding.entry_axes(e) for e in dims)


def vocab_in_turn(cfg, table: torch.Tensor, m: int):
    """(blocks, ``VocabSplit``): the (V, d) table ``table`` (``embed``,
    or ``lm_head``'s transpose) as the ``m`` ``model`` ranks of a (1, m)
    mesh hold it, a list of every rank's V/m rows (views of ``table``,
    so their gradients reach it), with the stand-in that computes every
    rank's share in turn in this process (``VocabSplit`` with no group):
    the split checked on one device. ``(table, None)`` where the
    vocabulary does not split (m = 1, or V not divisible by m)."""
    mesh = sharding.MeshShape((1, m), (mesh_lib.FSDP, mesh_lib.TP))
    specs = mesh_lib.param_specs(cfg, mesh)
    if not vocab_splits(specs, m):
        return table, None
    n = table.shape[0] // m
    ranges = [(r * n, (r + 1) * n) for r in range(m)]
    return [table[lo:hi] for lo, hi in ranges], VocabSplit(None, ranges)


def mixer_channels(cfg, p: Params, r: int, m: int) -> Params:
    """A split mixer's tree ``p`` with rank ``r``'s channels (of ``m``)
    of ``conv_w``, ``conv_b`` and ``norm``: its d_inner/m x-channels,
    then the 2N B/C channels for the first two; its x-channels for the
    norm. ``conv_w``'s stored block (channels over ``model``) does not
    follow the heads, so these leaves arrive whole; the slices' gradients
    land in the whole leaf, and the sum over ``model`` makes it whole."""
    d_inner, _ = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm_expand,
                                  cfg.ssm_head_dim)
    lo, hi = r * d_inner // m, (r + 1) * d_inner // m

    def conv(t):
        return torch.cat([t[..., lo:hi], t[..., d_inner:]], -1)

    return {**p, "conv_w": conv(p["conv_w"]), "conv_b": conv(p["conv_b"]),
            "norm": {"scale": p["norm"]["scale"][lo:hi]}}


def split_in_turn(cfg, i: int, layer: Params, m: int):
    """(tree, ``ModelSplit``): layer ``i``'s weights ``layer`` (whole,
    in the compute dtype) as the ``m`` ``model`` ranks of a (1, m) mesh
    hold them once gathered, each split sublayer a list of every rank's
    tree, with the stand-in that computes every rank's share in turn in
    this process (``ModelSplit`` with no group): the split checked on
    one device. The blocks are views of ``layer``'s leaves, so their
    gradients reach those leaves; the rest of a split sublayer
    (``q_norm``, ``k_norm``; the mixer's ``wB``, ``wC``, ``conv_w``,
    ``conv_b``, ``norm``) is one float32 copy that every rank reads (the
    mixer's channels of it, ``mixer_channels``), as ``gather_layer``
    gives it."""
    mesh = sharding.MeshShape((1, m), (mesh_lib.FSDP, mesh_lib.TP))
    specs = mesh_lib.param_specs(cfg, mesh)["layers"][i]
    subs = split_sublayers(cfg, specs, m)
    tree = dict(layer)
    for name in subs:
        shared = {k: model_lib.tree_map(lambda t: t.float(), v)
                  for k, v in layer[name].items()
                  if k not in SPLIT_LEAVES[name]}
        tree[name] = [{**shared, **{
            k: sharding.block(layer[name][k], specs[name][k], mesh, (0, r))
            for k in SPLIT_LEAVES[name]}} for r in range(m)]
        if name == "mamba":
            tree[name] = [mixer_channels(cfg, q, r, m)
                          for r, q in enumerate(tree[name])]
    return tree, ModelSplit(None, subs)


class MoeExchange:
    """What a MoE layer (``models/moe.py``: ``route``, ``moe_apply``)
    needs of ``mesh``: ``ranks`` split the batch (pod x data), this
    rank's rows are block ``index`` of them (pod-major, as
    ``batch_specs`` splits them), and ``model_rank`` is its coordinate
    along ``model``, whose ranks hold the experts in that order.
    ``batch_axes``: the axes that split the batch where not all of
    (pod, data) do (a served batch too small for them: the other batch
    ranks hold the same rows)."""

    def __init__(self, mesh, batch_axes=mesh_lib.BATCH):
        self.sizes = sharding.axis_sizes(mesh)
        coords = mesh.get_coordinate()
        if coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh "
                               f"{mesh}")
        coord = dict(zip(self.sizes, coords))
        groups = sharding.mesh_groups(mesh)
        axes = [a for a in batch_axes if a in self.sizes]
        self.ranks = math.prod(self.sizes[a] for a in axes)
        self.index = 0
        for a in axes:
            self.index = self.index * self.sizes[a] + coord[a]
        self.batch_entry = tuple(axes)
        self.batch_groups = {a: g for a, g in groups.items() if a in axes}
        self.model_rank = coord.get(mesh_lib.TP, 0)
        self.model_group = groups.get(mesh_lib.TP)

    def gather_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """(ranks, n): every batch rank's ``counts`` (n,), in block
        order (integers: the same on every rank, and no gradient)."""
        return sharding.gather_block(counts[None], (self.batch_entry,),
                                     self.sizes, self.batch_groups)

    def model_sum(self, y: torch.Tensor) -> torch.Tensor:
        """g of the experts' partial outputs."""
        return _ModelSum.apply(y, self.model_group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """f of a tensor that enters this rank's experts."""
        return _ModelEnter.apply(x, self.model_group)

    def experts(self, terms, w: tuple, x: torch.Tensor, gate: torch.Tensor):
        """The float32 sum over ``model`` of every rank's experts'
        ``terms(w, x, gate, model_rank)`` (``moe._expert_terms``): this
        rank's experts ``w`` take the tokens ``x`` and their ``gate``
        through f, their terms are summed by g (top-1's one term a token
        is exact in float32)."""
        gate, xe = self.enter(gate), self.enter(x)
        return self.model_sum(terms(w, xe, gate, self.model_rank).float())


class ExpertsInTurn:
    """``MoeExchange``'s stand-in on one device for the ``model`` ranks of
    a (1, m) mesh (``moe_in_turn``): ``blocks`` holds every rank's
    (wi_gate, wi_up, wo) experts; ``experts`` computes every rank's terms
    in turn and sums them in float32 in rank order, where the all-reduce
    would. It splits no batch (``ranks`` 1)."""

    ranks = 1

    def __init__(self, blocks: list):
        self.blocks = blocks

    def experts(self, terms, w: tuple, x: torch.Tensor, gate: torch.Tensor):
        return _sum_in_order([terms(b, x, gate, rank).float()
                              for rank, b in enumerate(self.blocks)])


class Layout:
    """Where each parameter leaf lives on ``mesh`` (a ``DeviceMesh``
    named ``("data", "model")`` or ``("pod", "data", "model")``) and how
    its blocks move: ``specs`` is ``mesh.param_specs(cfg, mesh)``;
    ``moe_exchange`` the ``MoeExchange`` of a MoE model (else None).
    ``tensor_parallel``: split attention, the Mamba-2 mixer and the
    dense MLP over ``model`` where ``split_sublayers`` allows (``split``
    records it, a tuple of sublayer names per layer), and the vocabulary
    of ``embed``, ``lm_head`` and the loss where ``vocab_splits`` does
    (``vocab``, this rank's ``VocabSplit``, else None); off, every rank
    along ``model`` computes them whole, and the step is the one-process
    step's arithmetic but for the order of the sums over the batch
    ranks."""

    def __init__(self, cfg, mesh, tensor_parallel: bool = False):
        mesh_lib.require_group(mesh.device_type, "a sharded layout")
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = sharding.axis_sizes(mesh)
        coords = mesh.get_coordinate()
        if coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh "
                               f"{mesh}")
        self.coords = tuple(coords)
        self.groups = sharding.mesh_groups(mesh)
        self.batch_axes = tuple(a for a in mesh_lib.BATCH
                                if a in self.groups)
        self.specs = mesh_lib.param_specs(cfg, mesh)
        self.moe_exchange = MoeExchange(mesh) if cfg.num_experts else None
        m = self.sizes.get(mesh_lib.TP, 1) if tensor_parallel else 1
        #: per layer, the sublayers it computes split over ``model``
        self.split = [split_sublayers(cfg, s, m)
                      for s in self.specs["layers"]]
        #: the ``model`` ranks that split the compute (1: none do)
        self.model_ranks = m
        #: this rank's coordinate along ``model``
        self.model_rank = dict(zip(self.sizes, self.coords)).get(
            mesh_lib.TP, 0)
        #: the vocabulary's split over ``model``, None where it is whole
        self.vocab = None
        if vocab_splits(self.specs, m):
            n, r = cfg.vocab_size // m, self.model_rank
            self.vocab = VocabSplit(self.groups[mesh_lib.TP],
                                    [(r * n, (r + 1) * n)])

    # -- blocks ------------------------------------------------------------

    def block(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of ``full``: a copy where the spec splits
        it (the full tensor may be freed), ``full`` itself where not."""
        out = sharding.block(full, spec, self.mesh, self.coords)
        return out.clone() if out.shape != full.shape else out

    def shard(self, tree: Params) -> Params:
        """Copies of this rank's blocks of a parameter-shaped tree; the
        tree is left as it is."""
        return _map2(lambda t, s: sharding.block(t, s, self.mesh,
                                                 self.coords).clone(),
                     tree, self.specs)

    def keep(self, where: tuple, tree):
        """``model.init_params``'s hook: the blocks of the subtree at
        ``where`` (a key path), as soon as it is drawn."""
        specs = self.specs
        for k in where:
            specs = specs[k]
        return _map2(self.block, tree, specs)

    # -- collectives -------------------------------------------------------

    def all_gather(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole leaf from this rank's block ``x``
        (``sharding.gather_block``)."""
        return sharding.gather_block(x, spec, self.sizes, self.groups)

    def reduce_block(self, g: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The sum over the batch ranks of a full-shape gradient, then
        this rank's block of it."""
        if self.batch_axes:
            g = g.contiguous()
            for a in self.batch_axes:
                dist.all_reduce(g, group=self.groups[a])
        return self.block(g, spec)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks that split the batch, detached."""
        if not self.batch_axes:
            return x.detach()
        x = x.detach().clone()
        for a in self.batch_axes:
            dist.all_reduce(x, group=self.groups[a])
        return x

    # -- what the model and the step call ----------------------------------

    def gather(self, shard: torch.Tensor, spec: tuple, dtype=None,
               partial: bool = False):
        """The whole leaf for compute, in ``dtype`` (cast before the
        gather) where given; differentiable. ``partial``: see
        ``_Gather``."""
        if dtype is not None and shard.dtype != torch.float32:
            dtype = None
        return _Gather.apply(shard, self, spec, dtype, partial)

    def gather_layer(self, i: int, p: Params) -> Params:
        """Layer ``i``'s weights from its blocks ``p``, every float32
        leaf in the compute dtype (``model.cast_layers``' rule). A MoE
        layer's experts are gathered over every axis but ``model``:
        this rank's E/m of them where the spec splits E. So are the
        ``SPLIT_LEAVES`` of the sublayers ``split[i]`` names: this
        rank's heads' columns of wq/wk/wv and rows of wo, its d_ff/m
        columns of wi_gate/wi_up and rows of wo, its heads' columns of
        wz/wx/wdt, rows of wo and blocks of dt_bias/a_log/D; the rest of
        a split sublayer is gathered ``partial``, a mixer's then cut to
        this rank's channels (``mixer_channels``)."""
        cd = self.cfg.cdtype
        specs = self.specs["layers"][i]
        if "moe" in specs:
            moe = dict(specs["moe"])
            for k in ("wi_gate", "wi_up", "wo"):     # (E, ...)
                if moe[k][0] == mesh_lib.TP:
                    moe[k] = (None,) + moe[k][1:]
            specs = {**specs, "moe": moe}
        for name in self.split[i]:
            sub = dict(specs[name])
            for k in SPLIT_LEAVES[name]:
                sub[k] = without_model(sub[k])
            specs = {**specs, name: sub}
        out = {}
        for k, v in p.items():
            if k in self.split[i]:
                out[k] = {n: _map2(lambda t, s: self.gather(
                    t, s, cd, partial=n not in SPLIT_LEAVES[k]),
                    w, specs[k][n]) for n, w in v.items()}
            else:
                out[k] = _map2(lambda t, s: self.gather(t, s, cd), v,
                               specs[k])
        if "mamba" in self.split[i]:
            out["mamba"] = mixer_channels(self.cfg, out["mamba"],
                                          self.model_rank, self.model_ranks)
        return out

    def model_split(self, i: int) -> ModelSplit | None:
        """The ``ModelSplit`` layer ``i`` computes with, None where no
        sublayer of it splits."""
        if not self.split[i]:
            return None
        return ModelSplit(self.groups[mesh_lib.TP], self.split[i])

    def gather_top(self, params: Params, names, dtype=None) -> Params:
        """The top-level entries ``names`` (those present) gathered;
        under the vocab split, ``embed`` and ``lm_head`` over the batch
        axes only: this rank's V/m rows (``lm_head``'s columns)."""
        def spec(k):
            if self.vocab is not None and k in ("embed", "lm_head"):
                return without_model(self.specs[k])
            return self.specs[k]
        return {k: _map2(lambda t, s: self.gather(t, s, dtype), params[k],
                         spec(k))
                for k in names if k in params}

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a (micro)batch, which must split evenly
        over every batch axis of the mesh."""
        specs = mesh_lib.batch_specs(self.cfg, self.mesh, batch)
        out = {}
        for key, x in batch.items():
            spec = specs[key]
            ax = 1 if key == "positions" else 0
            if set(self.batch_axes) - set(sharding.entry_axes(spec[ax])):
                raise ValueError(
                    f"{key}: {x.shape[ax]} rows do not split over the "
                    f"{batch_ranks(self.mesh)} batch ranks (pod x data)")
            out[key] = sharding.block(x, spec, self.mesh, self.coords)
        return out

    def norm_groups(self, tree: Params) -> list:
        """For each leaf of ``tree`` (``model._leaves`` order), the groups
        to sum its squares over: the axes its spec splits (a replicated
        axis holds copies, counted once)."""
        return [tuple(self.groups[a] for a in sharding.spec_axes(s)
                      if a in self.groups)
                for _, s in mesh_lib.zip_specs(tree, self.specs)]

    def full(self, tree: Params) -> Params:
        """The whole leaves of a parameter-shaped tree of blocks (no
        gradient)."""
        with torch.no_grad():
            return _map2(self.all_gather, tree, self.specs)


def init_params(cfg, layout: Layout, seed: int = 0, device=None) -> Params:
    """``model.init_params``' seeded weights, each layer's and each
    top-level leaf's blocks kept as soon as it is drawn: the same values
    as the whole model's blocks."""
    return model_lib.init_params(cfg, seed, device, keep=layout.keep)


def numel(tree) -> int:
    return sum(t.numel() for t in model_lib._leaves(tree))


# ---------------------------------------------------------------------------
# Serving over the mesh
# ---------------------------------------------------------------------------

#: a MoE layer's leaves that each ``model`` rank holds E/m of
EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def _map_specs(fn, specs):
    """``fn`` over the specs (tuples) of a spec tree."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def serve_specs(specs: Params, split: list, vocab_split: bool) -> Params:
    """The parameter specs of a serve (``param_specs``' tree ``specs``):
    a leaf keeps ``model`` where a rank computes with its block of it
    (the ``SPLIT_LEAVES`` of the sublayers ``split[i]`` names, the
    experts, ``embed``/``lm_head`` where ``vocab_split``); every other
    leaf is held whole along ``model`` (norms, the router, the shared
    expert, a sublayer whose counts m does not divide), so that no step
    gathers it over ``model``."""
    def whole(tree):
        return _map_specs(without_model, tree)

    out = {k: v if vocab_split and k in ("embed", "lm_head") else whole(v)
           for k, v in specs.items() if k != "layers"}
    out["layers"] = []
    for layer, subs in zip(specs["layers"], split):
        keep = {name: SPLIT_LEAVES[name] for name in subs}
        keep["moe"] = EXPERT_LEAVES
        out["layers"].append({
            name: {k: v if k in keep.get(name, ()) else whole(v)
                   for k, v in sub.items()} if isinstance(sub, dict)
            else whole(sub) for name, sub in layer.items()})
    return out


class ServeLayout(Layout):
    """Where a serve over ``mesh`` (a ``("data", "model")`` or ``("pod",
    "data", "model")`` ``DeviceMesh``) keeps its weights, batch rows and
    caches for ``batch`` requests of up to ``max_len`` slots, and how they
    move (module docstring, "Serving"):

    * ``split`` (per layer, the sublayers its ``model`` ranks split:
      "attn", "mlp") and ``vocab`` (this rank's ``VocabSplit``, None
      where V stays whole) as in ``Layout`` with ``tensor_parallel``;
      ``specs``: ``serve_specs`` of the parameters; ``moe_exchange``
      routing over the ranks that split the batch;
    * ``batch_spec``: the rows of the batch a rank serves
      (``batch_specs``; over none of the batch axes where the batch does
      not divide by them);
    * ``cache_specs`` and ``cache``: the caches' blocks and this rank's
      ``CacheSplit`` (every attention layer's caches split alike).

    Raises ``ValueError`` for a model with Mamba-2 layers."""

    def __init__(self, cfg, mesh, batch: int, max_len: int):
        if any(s.mixer == "mamba" for s in cfg.pattern):
            raise ValueError(
                f"{cfg.name} has Mamba-2 layers, which do not serve over a "
                "mesh: their conv cache's channels over 'model' meet the "
                "split mixer's B and C held whole; serve it on one device")
        super().__init__(cfg, mesh, tensor_parallel=True)
        self.coord = dict(zip(self.sizes, self.coords))
        self.specs = serve_specs(self.specs, self.split,
                                 self.vocab is not None)
        tokens = torch.empty((batch, 1), dtype=torch.int32, device="meta")
        self.batch_spec = mesh_lib.batch_specs(cfg, mesh,
                                               {"tokens": tokens})["tokens"]
        self.moe_exchange = MoeExchange(
            mesh, sharding.entry_axes(self.batch_spec[0])) \
            if cfg.num_experts else None
        self.max_len = max_len
        self.cache_specs = mesh_lib.cache_specs(
            cfg, mesh, model_lib.init_cache(cfg, batch, max_len, "meta"))
        self.kv_spec = next(s["k"] for s in self.cache_specs if "k" in s)
        self.cache = CacheSplit(
            [self.groups[a] for a in sharding.entry_axes(self.kv_spec[1])
             if a in self.groups],
            [mesh_lib.seq_range(self.kv_spec, mesh, self.coords, max_len)])

    # -- weights -------------------------------------------------------------

    def keep(self, where: tuple, tree):
        """``model.init_params``' hook: the blocks of the subtree at
        ``where`` as soon as it is drawn, in the compute dtype
        (``model.cast_drawn``; a cast is elementwise, so a block's values
        are those of the whole leaf cast)."""
        specs = self.specs
        for k in where:
            specs = specs[k]

        def one(t, spec):
            b = sharding.block(t, spec, self.mesh, self.coords)
            return b.clone() if b.shape != t.shape else b

        return model_lib.cast_drawn(self.cfg, where,
                                    _map2(one, tree, specs))

    def shard(self, params: Params) -> Params:
        """This rank's blocks of whole weights ``params`` (float32 or
        already cast), in the compute dtype."""
        return {k: [self.keep((k, i), p) for i, p in enumerate(v)]
                if k == "layers" else self.keep((k,), v)
                for k, v in params.items()}

    def _gather(self, tree, specs):
        """``tree``'s blocks gathered over ``data`` (the FSDP dims); the
        blocks over ``model`` stay. At ``data`` = 1, ``tree`` itself."""
        if mesh_lib.FSDP not in self.groups:
            return tree
        with torch.no_grad():
            return _map2(lambda t, s: self.all_gather(t, without_model(s)),
                         tree, specs)

    def layer(self, i: int, p: Params) -> Params:
        """Layer ``i``'s weights for compute from its blocks ``p``."""
        return self._gather(p, self.specs["layers"][i])

    def top(self, params: Params, names) -> Params:
        """The top-level entries ``names`` (those present) for compute:
        ``embed``/``lm_head`` this rank's V/m rows (columns) where the
        vocabulary splits."""
        return {k: self._gather(params[k], self.specs[k]) for k in names
                if k in params}

    # -- batch rows ----------------------------------------------------------

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor whose dim 0 is the batch."""
        spec = (self.batch_spec[0],) + (None,) * (x.dim() - 1)
        return sharding.block(x, spec, self.mesh, self.coords)

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a tensor whose dim 0 is this rank's
        batch rows, in batch order."""
        spec = (self.batch_spec[0],) + (None,) * (x.dim() - 1)
        return self.all_gather(x, spec)

    def whole_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of this rank's rows and vocabulary block gathered into
        the whole batch's and vocabulary's (last dim), on every rank."""
        if self.vocab is not None:
            x = ModelSplit(self.groups[mesh_lib.TP], ()).gather([x], -1)
        return self.all_rows(x)

    # -- caches --------------------------------------------------------------

    def cache_shape(self, i: int, name: str, shape) -> tuple:
        """The shape of this rank's block of layer ``i``'s cache ``name``
        of global ``shape``."""
        return sharding.block_shape(shape, self.cache_specs[i][name],
                                    self.mesh)

    def fill_caches(self, caches: list, pcaches: list,
                    prompt_len: int) -> None:
        """Copy prefill's caches ``pcaches`` (each attention layer's k/v
        (B, prompt_len, H', D) on this rank's heads where ``model`` splits
        its heads, else every head) into this rank's decode caches
        ``caches`` (``cache_specs``' blocks): each rank's slots of every
        head, its prompt slots filled. Where both the heads and the
        sequence split over ``model``, one all-to-all over ``model`` a
        layer sends each rank its slots of this rank's heads; where the
        sequence stays whole, the heads are all-gathered."""
        (lo, hi), = self.cache.ranges
        tp = self.groups.get(mesh_lib.TP)
        m = self.model_ranks
        n_me = max(0, min(hi, prompt_len) - lo)
        for i, (dst, src) in enumerate(zip(caches, pcaches)):
            kv = torch.stack([src["k"], src["v"]])   # (2, B, P, H', D)
            if "attn" not in self.split[i]:
                got = kv[:, :, lo:lo + n_me]
            elif not self.cache.split:
                got = ModelSplit(tp, ()).gather([kv], 3)
            else:
                # the slots of each rank of this rank's model group
                peers = [mesh_lib.seq_range(
                    self.kv_spec, self.mesh,
                    tuple(j if a == mesh_lib.TP else self.coord[a]
                          for a in self.sizes), self.max_len)
                    for j in range(m)]
                sends = relay_sends(kv, peers, prompt_len)
                one = kv[:, :, :n_me].numel()
                out = kv.new_empty(m * one)
                dist.all_to_all_single(
                    out, torch.cat([t.reshape(-1) for t in sends]),
                    [one] * m, [t.numel() for t in sends], group=tp)
                got = relay_receive(list(out.view(
                    m, 2, kv.shape[1], n_me, *kv.shape[3:]).unbind(0)))
            dst["k"][:, :n_me] = got[0]
            dst["v"][:, :n_me] = got[1]


def relay_sends(kv: torch.Tensor, ranges: list, prompt_len: int) -> list:
    """The pieces of one rank's prefill caches ``kv`` (2, B, P, H', D),
    its heads' k and v, that the ranks holding the slots ``ranges`` (one
    ``(lo, hi)`` a rank of its model group, in rank order) keep: each
    rank's prompt slots."""
    return [kv[:, :, lo:lo + max(0, min(hi, prompt_len) - lo)]
            for lo, hi in ranges]


def relay_receive(pieces: list) -> torch.Tensor:
    """A rank's slots of every head from the pieces each rank of its
    model group sent it (``relay_sends``), in rank order: their heads
    concatenated, (2, B, n, m H', D)."""
    return torch.cat(pieces, 3)


def relayout_in_turn(kvs: list, ranges: list, prompt_len: int) -> list:
    """``ServeLayout.fill_caches``' all-to-all on one device: ``kvs``
    every ``model`` rank's prefill caches (2, B, P, H', D) on its heads,
    ``ranges`` every rank's slots; returns each rank's prompt slots of
    every head, as the all-to-all delivers them."""
    sends = [relay_sends(kv, ranges, prompt_len) for kv in kvs]
    return [relay_receive([s[j] for s in sends]) for j in range(len(ranges))]


def moe_in_turn(moe: Params, m: int):
    """(tree, exchange): a MoE sublayer's tree ``moe`` (whole) as rank 0
    of the ``m`` ``model`` ranks of a (1, m) mesh holds it for expert
    parallelism, on one device (each of ``EXPERT_LEAVES`` its E/m
    experts, the router and the shared expert whole), and the
    ``ExpertsInTurn`` over every rank's experts (views) that
    ``models/moe.py``'s ``moe_apply`` takes as its exchange. Experts that
    ``m`` does not divide stay whole, with no exchange."""
    e = moe["wi_gate"].shape[0]
    if e % m:
        return moe, None
    n = e // m
    blocks = [tuple(moe[k][r * n:(r + 1) * n] for k in EXPERT_LEAVES)
              for r in range(m)]
    return {**moe, **dict(zip(EXPERT_LEAVES, blocks[0]))}, \
        ExpertsInTurn(blocks)


def decode_in_turn(cfg, i: int, layer: Params, cache: Params, m: int):
    """(tree, ``ModelSplit``, caches, ``CacheSplit``, exchange): layer
    ``i``'s weights ``layer`` (whole, in the compute dtype) and its
    decode cache ``cache`` (``{"k", "v"}`` (B, Smax, Hkv, D)) as the
    ``m`` ``model`` ranks of a (1, m) serve hold them, with the stand-ins
    that compute every rank's share in turn on one device:
    ``split_in_turn``'s trees, each rank's slots of the cache (copies)
    where ``cache_specs`` splits the sequence, else the whole cache once,
    and a MoE layer's ``moe_in_turn`` (else None).
    ``models/model.py``'s ``decode_block`` runs them."""
    tree, split = split_in_turn(cfg, i, layer, m)
    exchange = None
    if "moe" in tree:
        tree["moe"], exchange = moe_in_turn(tree["moe"], m)
    mesh = sharding.MeshShape((1, m), (mesh_lib.FSDP, mesh_lib.TP))
    spec = mesh_lib.cache_specs(cfg, mesh, [cache])[0]["k"]
    smax = cache["k"].shape[1]
    if sharding.entry_axes(spec[1]):
        ranges = [mesh_lib.seq_range(spec, mesh, (0, r), smax)
                  for r in range(m)]
    else:
        ranges = [(0, smax)]
    caches = [{k: v[:, lo:hi].clone() for k, v in cache.items()}
              for lo, hi in ranges]
    return (tree, split, caches,
            CacheSplit(None if len(ranges) > 1 else [], ranges), exchange)
