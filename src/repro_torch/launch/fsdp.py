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
* **With ``tensor_parallel``, it splits attention and the dense MLP
  too.** Where the specs put the columns of ``wq``/``wk``/``wv`` and the
  rows of ``wo`` over ``model`` and H and Hkv divide by its size m, each
  ``model`` rank computes its H/m query and Hkv/m KV heads (rotation,
  norms, masks and the flash kernel on those heads) and their rows of
  ``wo``; where ``wi_gate``/``wi_up``'s columns and ``wo``'s rows are
  over it and d_ff divides by m, its d_ff/m columns of the dense MLP.
  ``gather_layer`` gathers those leaves over the batch axes only, and
  ``Layout.split`` records, layer by layer, which sublayers split. The
  input enters through f and the row-parallel output leaves through g
  (``ModelSplit``), both summed over ``model`` in float32 over partials
  that were not rounded to the compute dtype, and rounded once: the
  row product (``layers.row_product``) and the column products' input
  gradients (``layers.column_product``) are float32 products (on the
  card a float32-output GEMM, on the CPU the operands upcast), each
  input gradient summed over the ranks and rounded once, then the
  products' added in the compute dtype as the one-process backward
  adds them. ``q_norm``/``k_norm``,
  applied to the rank's own heads, are gathered as float32 and their
  gradients summed over ``model`` too. Embeddings, the loss, Mamba-2
  mixers, MoE layers' shared experts and any sublayer whose counts do
  not divide by m are gathered whole, and every rank along ``model``
  computes the same rows with them; at m = 1 nothing splits.
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
    """What a layer whose ``sublayers`` ("attn", "mlp") are split over
    the ``model`` ranks of ``group`` needs (``models/model.py``):
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
            y = share(p[0], xs)
            for q in p[1:]:
                y = y + share(q, xs)
        else:
            y = _ModelSum.apply(share(p, xs), self.group)
        return y.to(x.dtype)


#: the leaves of a split sublayer that each ``model`` rank holds a block
#: of and computes with: column blocks of the first three, row blocks of
#: ``wo``
SPLIT_LEAVES = {"attn": ("wq", "wk", "wv", "wo"),
                "mlp": ("wi_gate", "wi_up", "wo")}


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
    Hkv divide by m; the dense MLP where they put wi_gate/wi_up's
    columns and wo's rows there and d_ff divides by m. None at m = 1."""
    if m == 1:
        return ()
    counts = {"attn": (cfg.num_heads, cfg.num_kv_heads), "mlp": (cfg.d_ff,)}
    out = []
    for name, leaves in SPLIT_LEAVES.items():
        if name not in specs or any(n % m for n in counts[name]):
            continue
        dims = [specs[name][k][0 if k == "wo" else 1] for k in leaves]
        if all(mesh_lib.TP in sharding.entry_axes(e) for e in dims):
            out.append(name)
    return tuple(out)


def split_in_turn(cfg, i: int, layer: Params, m: int):
    """(tree, ``ModelSplit``): layer ``i``'s weights ``layer`` (whole,
    in the compute dtype) as the ``m`` ``model`` ranks of a (1, m) mesh
    hold them once gathered, each split sublayer a list of every rank's
    tree, with the stand-in that computes every rank's share in turn in
    this process (``ModelSplit`` with no group): the split checked on
    one device. The blocks are views of ``layer``'s leaves, so their
    gradients reach those leaves; the rest of a split attention
    (``q_norm``, ``k_norm``) is one float32 copy that every rank reads,
    as ``gather_layer`` gives it."""
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
    return tree, ModelSplit(None, subs)


class MoeExchange:
    """What a MoE layer (``models/moe.py``: ``route``, ``moe_apply``)
    needs of ``mesh``: ``ranks`` split the batch (pod x data), this
    rank's rows are block ``index`` of them (pod-major, as
    ``batch_specs`` splits them), and ``model_rank`` is its coordinate
    along ``model``, whose ranks hold the experts in that order."""

    def __init__(self, mesh):
        self.sizes = sharding.axis_sizes(mesh)
        coords = mesh.get_coordinate()
        if coords is None:
            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh "
                               f"{mesh}")
        coord = dict(zip(self.sizes, coords))
        groups = sharding.mesh_groups(mesh)
        self.ranks = batch_ranks(mesh)
        self.index = 0
        for a in mesh_lib.BATCH:
            if a in self.sizes:
                self.index = self.index * self.sizes[a] + coord[a]
        self.batch_groups = {a: g for a, g in groups.items()
                             if a in mesh_lib.BATCH}
        self.model_rank = coord.get(mesh_lib.TP, 0)
        self.model_group = groups.get(mesh_lib.TP)

    def gather_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """(ranks, n): every batch rank's ``counts`` (n,), in block
        order (integers: the same on every rank, and no gradient)."""
        return sharding.gather_block(counts[None], (mesh_lib.BATCH,),
                                     self.sizes, self.batch_groups)

    def model_sum(self, y: torch.Tensor) -> torch.Tensor:
        """g of the experts' partial outputs."""
        return _ModelSum.apply(y, self.model_group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """f of a tensor that enters this rank's experts."""
        return _ModelEnter.apply(x, self.model_group)


class Layout:
    """Where each parameter leaf lives on ``mesh`` (a ``DeviceMesh``
    named ``("data", "model")`` or ``("pod", "data", "model")``) and how
    its blocks move: ``specs`` is ``mesh.param_specs(cfg, mesh)``;
    ``moe_exchange`` the ``MoeExchange`` of a MoE model (else None).
    ``tensor_parallel``: split attention and the dense MLP over
    ``model`` where ``split_sublayers`` allows (``split`` records it, a
    tuple of sublayer names per layer); off, every rank along ``model``
    computes them whole, and the step is the one-process step's
    arithmetic but for the order of the sums over the batch ranks."""

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
        columns of wi_gate/wi_up and rows of wo; the rest of a split
        attention (``q_norm``, ``k_norm``) is gathered ``partial``."""
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
            if k == "attn" and "attn" in self.split[i]:
                out[k] = {n: _map2(lambda t, s: self.gather(
                    t, s, cd, partial=n not in SPLIT_LEAVES["attn"]),
                    w, specs[k][n]) for n, w in v.items()}
            else:
                out[k] = _map2(lambda t, s: self.gather(t, s, cd), v,
                               specs[k])
        return out

    def model_split(self, i: int) -> ModelSplit | None:
        """The ``ModelSplit`` layer ``i`` computes with, None where no
        sublayer of it splits."""
        if not self.split[i]:
            return None
        return ModelSplit(self.groups[mesh_lib.TP], self.split[i])

    def gather_top(self, params: Params, names, dtype=None) -> Params:
        """The top-level entries ``names`` (those present) gathered."""
        return {k: _map2(lambda t, s: self.gather(t, s, dtype), params[k],
                         self.specs[k])
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
