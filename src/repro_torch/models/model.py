"""Composable decoder/encoder LM, ported from ``repro/models/model.py``:
attention (RoPE, M-RoPE or none) and Mamba-2 mixers, dense and MoE
MLPs, the ``tokens``, ``frames`` and ``patches`` front ends, the serve
path (prefill, decode with per-layer caches) and the forward of
training.

A model is a stack of ``num_layers`` blocks whose specs cycle through a
period ``pattern`` of ``BlockSpec``s, as in the JAX package. Where JAX
stacks each period position's parameters on a leading K axis and runs
one ``lax.scan`` over K (to keep the HLO small), the port keeps one
parameter dict per layer (``params["layers"]``) and runs a Python loop
over the layers; ``models/convert.py`` maps one tree onto the other.
Caches are one dict per layer: ``{"k", "v"}`` (B, Smax, Hkv, D) for an
attention layer, ``{"conv", "ssm"}`` (``models/ssm.py``) for a Mamba-2
one. ``forward`` returns the sum of the MoE layers' load-balance losses
(``models/moe.py``), 0 where the model has none.

Left out, because it has no meaning on one card: ``_seq_constraint``
(a GSPMD sharding constraint). ``_remat`` becomes
``torch.utils.checkpoint`` around each layer where ``cfg.remat`` is on
and grad is enabled (training). ``remat_policy="full"`` saves only the
layer's inputs; ``"dots"`` (the reference's
``dots_with_no_batch_dims_saveable``) also saves the outputs of the
layer's 2-D products (``aten.mm``/``aten.addmm``: the projections, the
router) through a selective-checkpoint context and recomputes the rest.
Batched products (``aten.bmm``: the MoE experts, the plain attention)
are recomputed, as JAX recomputes a ``dot_general`` with batch
dimensions. The flash kernels launch through ctypes, which no dispatch
mode sees, so the recompute launches the forward kernel again, as JAX
recomputes a ``pallas_call``.

The front ends take what the reference's stubs give: ``frames``
(B, S, frontend_dim) or ``patches`` (B, P, frontend_dim), float32
embeddings of a waveform or an image that ``frontend_proj``
(frontend_dim, d_model) projects into the model (``data/pipeline.py``
draws them from the seed). The ``patches`` rows come before the token
rows, and M-RoPE ``positions`` are (3, B, S) for (t, h, w).

The JAX steps cast the block weights to the compute dtype inside every
jitted call (``_cast_blocks``): every float32 leaf of ndim > 1 in its
layout, where each layer leaf is stacked on a leading K axis, so every
float32 layer leaf, the norm scales and Mamba-2's ``a_log``, ``D``,
``dt_bias`` and ``conv_b`` included. ``compute_params`` casts the same
leaves, and the top-level matrices (embedding, output) once per serve;
``final_norm`` stays float32. The functions below accept either tree and
cast what is still float32 (a no-op on a cast tree). Casting
elementwise before or after a gather or a transpose gives the same
values, so the results are those of the JAX order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.executor import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_mrope, apply_rope,
                                       column_product, dense_init,
                                       embed_init, mlp, mlp_init, mlp_share,
                                       rmsnorm, rmsnorm_init, row_product,
                                       softcap)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    mixer: str  # "attn" | "attn_local" | "mamba"
    mlp: str    # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[BlockSpec, ...]
    # attention
    causal: bool = True
    window: int = 0                   # sliding window for "attn_local"
    rope_theta: float = 10_000.0
    local_rope_theta: float = 0.0     # 0 => use rope_theta
    use_rope: bool = True             # jamba/hubert: no rotary positions
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0   # 0 => off
    final_logit_softcap: float = 0.0
    use_post_norm: bool = False       # gemma-style post-sublayer norms
    # moe
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # embeddings / io
    tie_embeddings: bool = True
    embed_scale: bool = False
    frontend: str = "tokens"          # tokens | frames | patches
    frontend_dim: int = 0
    mrope_sections: tuple[int, ...] = ()
    act: str = "silu"
    norm_eps: float = 1e-6
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True                # training: checkpoint each layer
    remat_policy: str = "full"        # "full" | "dots" (save 2-D products)
    attn_impl: str = "auto"           # auto | kernel (pallas) | dense | chunked
    attn_chunk: int = 512
    ce_chunks: int = 8
    train_microbatches: int = 4
    # sequence parallelism (GSPMD only: not used here)
    act_shard_batch: tuple[str, ...] = ()
    act_shard_seq: tuple[str, ...] = ()

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def repeats(self) -> int:
        assert self.num_layers % self.period == 0, (self.name,)
        return self.num_layers // self.period

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_spec(self, i: int) -> BlockSpec:
        return self.pattern[i % self.period]

    def num_params(self) -> int:
        """Total parameter count (from the meta-device tree)."""
        return sum(t.numel() for t in _leaves(abstract_params(self)))

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        total = self.num_params()
        if self.num_experts == 0:
            return total
        n_moe_layers = self.repeats * sum(
            1 for s in self.pattern if s.mlp == "moe")
        per_expert = 3 * self.d_model * self.d_ff_expert
        inactive = n_moe_layers * (self.num_experts - self.top_k) * per_expert
        return total - inactive


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block spec the model does not know."""
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "attn_local", "mamba") \
                or spec.mlp not in ("dense", "moe", "none"):
            raise ValueError(spec)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """``fn`` over the tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, spec: BlockSpec, gen, device) -> Params:
    dt = cfg.pdtype
    d, hd = cfg.d_model, cfg.head_dim
    p: Params = {"ln_mixer": rmsnorm_init(d, dt, device)}
    if spec.mixer.startswith("attn"):
        p["attn"] = {
            "wq": dense_init(gen, d, cfg.num_heads * hd, dt, device),
            "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
            "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
            "wo": dense_init(gen, cfg.num_heads * hd, d, dt, device),
        }
        if cfg.qk_norm:
            p["attn"]["q_norm"] = rmsnorm_init(hd, dt, device)
            p["attn"]["k_norm"] = rmsnorm_init(hd, dt, device)
    else:
        p["mamba"] = ssm_lib.mamba2_init(
            gen, d, state=cfg.ssm_state, conv=cfg.ssm_conv,
            expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, dtype=dt,
            device=device)
    if cfg.use_post_norm:
        p["post_ln_mixer"] = rmsnorm_init(d, dt, device)
    if spec.mlp == "dense":
        p["ln_mlp"] = rmsnorm_init(d, dt, device)
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, dt, device)
    elif spec.mlp == "moe":
        p["ln_mlp"] = rmsnorm_init(d, dt, device)
        p["moe"] = moe_lib.moe_init(gen, d, cfg.d_ff_expert,
                                    cfg.num_experts, cfg.num_shared_experts,
                                    dt, device)
    if cfg.use_post_norm and spec.mlp != "none":
        p["post_ln_mlp"] = rmsnorm_init(d, dt, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                keep=None) -> Params:
    """Seeded random weights on ``device`` (``None``: the GPU; one
    ``torch.Generator`` of that device, drawn layer by layer):
    ``{"embed", "layers": [one dict per layer], "final_norm",
    "frontend_proj"?, "lm_head"?}``. ``keep(where, tree)``, where given,
    replaces each layer's tree (``where`` ``("layers", i)``) and each
    top-level leaf (``(name,)``) as soon as it is drawn: a sharded run
    keeps its blocks (``launch/fsdp.py``); the draws are unchanged."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    keep = keep or (lambda where, tree: tree)
    layers = [keep(("layers", i), _init_block(cfg, cfg.layer_spec(i), gen,
                                              device))
              for i in range(cfg.num_layers)]
    p: Params = {
        "embed": keep(("embed",), embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, cfg.pdtype,
                                             device)),
        "layers": layers,
        "final_norm": keep(("final_norm",),
                           rmsnorm_init(cfg.d_model, cfg.pdtype, device)),
    }
    if cfg.frontend in ("frames", "patches") and cfg.frontend_dim:
        p["frontend_proj"] = keep(("frontend_proj",), dense_init(
            gen, cfg.frontend_dim, cfg.d_model, cfg.pdtype, device))
    if not cfg.tie_embeddings:
        p["lm_head"] = keep(("lm_head",), dense_init(
            gen, cfg.d_model, cfg.vocab_size, cfg.pdtype, device))
    return p


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree on the meta device: shapes and dtypes, no
    memory."""
    return init_params(cfg, device="meta")


def decay_mask(params: Params) -> Params:
    """Where the JAX package's AdamW applies weight decay: to leaves of
    ndim >= 2 in its layout, where each layer leaf is stacked on a
    leading K axis (``convert.py``). So every layer leaf is decayed,
    norm scales included, and of the rest only the matrices. The port
    keeps that rule to train as the reference does."""
    out = {k: tree_map(lambda t: t.dim() >= 2, v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = tree_map(lambda t: True, params["layers"])
    return out


def cast_layers(cfg: ModelConfig, layers: list) -> list:
    """Every float32 leaf of the per-layer trees cast to the compute
    dtype, whatever its ``dim()``: the leaves the reference's
    ``_cast_blocks`` casts (ndim > 1 once stacked on K)."""
    cd = cfg.cdtype
    return tree_map(lambda a: a.to(cd) if a.dtype == torch.float32 else a,
                    layers)


def _cast_matrices(cfg: ModelConfig, tree):
    """Every float32 matrix of ``tree`` in the compute dtype (the rule
    for the leaves outside the layers)."""
    cd = cfg.cdtype
    return tree_map(lambda a: a.to(cd) if a.dtype == torch.float32
                    and a.dim() > 1 else a, tree)


def compute_params(cfg: ModelConfig, params: Params) -> Params:
    """The tree in the compute dtype as the reference uses it, made once
    per serve (module docstring): the layers by ``cast_layers``; of the
    rest every float32 matrix (``final_norm`` stays float32)."""
    out = {k: _cast_matrices(cfg, v) for k, v in params.items()
           if k != "layers"}
    out["layers"] = cast_layers(cfg, params["layers"])
    return out


def init_compute_params(cfg: ModelConfig, seed: int = 0,
                        device=None) -> Params:
    """``compute_params(cfg, init_params(cfg, seed, device))``, bit for
    bit, with each layer and each top-level leaf cast as soon as it is
    drawn (``init_params``' ``keep``): the whole float32 model never
    exists at once. A 12B model's float32 weights (48 GB) beside their
    bf16 copy would not fit on one 80 GB card."""
    def keep(where, tree):
        if where[0] == "layers":
            return cast_layers(cfg, [tree])[0]
        return _cast_matrices(cfg, tree)

    return init_params(cfg, seed, device, keep=keep)


# ---------------------------------------------------------------------------
# Block application (full sequence)
# ---------------------------------------------------------------------------

def _theta(cfg: ModelConfig, spec: BlockSpec) -> float:
    if spec.mixer == "attn_local":
        return cfg.local_rope_theta or cfg.rope_theta
    return cfg.rope_theta


def _qkv(cfg: ModelConfig, p: Params, h: torch.Tensor):
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _rotate(cfg: ModelConfig, spec: BlockSpec, x: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """M-RoPE where the config has sections (positions (3, B, S)), else
    RoPE where it uses rotary positions (positions (B, S)), else x."""
    if cfg.mrope_sections:
        return apply_mrope(x, positions, _theta(cfg, spec),
                           cfg.mrope_sections)
    if cfg.use_rope:
        return apply_rope(x, positions, _theta(cfg, spec))
    return x


def _attn_block(cfg: ModelConfig, spec: BlockSpec, p: Params,
                h: torch.Tensor, positions: torch.Tensor):
    b, s, _ = h.shape
    local = spec.mixer == "attn_local"
    q, k, v = _qkv(cfg, p, h)
    q = _rotate(cfg, spec, q, positions)
    k = _rotate(cfg, spec, k, positions)
    out = attn_lib.attention(
        q, k, v, causal=cfg.causal, window=cfg.window if local else None,
        logit_softcap=cfg.attn_logit_softcap or None,
        impl=cfg.attn_impl, chunk_size=cfg.attn_chunk)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]
    cache = {"k": k.to(cfg.cdtype), "v": v.to(cfg.cdtype)}
    return out, cache


def attn_share(cfg: ModelConfig, spec: BlockSpec, p: Params, xs: tuple,
               positions: torch.Tensor) -> torch.Tensor:
    """One ``model`` rank's share of an attention sublayer split over the
    ranks (``launch/fsdp.py``): ``p`` holds its column blocks of
    wq/wk/wv, so H/m query and Hkv/m KV heads (GQA keeps its groups, as
    head j reads KV head j // g), and the matching row block of wo.
    ``xs``: the normed input in float32, one copy for each of the q, k
    and v products (f's outputs). ``_attn_block`` on the rank's heads:
    the products (``layers.column_product``), rotation,
    ``q_norm``/``k_norm`` (float32 leaves: their gradient here is a
    partial sum), masks and attention; the row product
    (``layers.row_product``) is float32 and not rounded: (b, s, d), a
    partial sum over the ranks that g adds."""
    b, s, _ = xs[0].shape
    local = spec.mixer == "attn_local"
    q, k, v = (column_product(x32, p[n]).reshape(b, s, -1, cfg.head_dim)
               for x32, n in zip(xs, ("wq", "wk", "wv")))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = _rotate(cfg, spec, q, positions)
    k = _rotate(cfg, spec, k, positions)
    out = attn_lib.attention(
        q, k, v, causal=cfg.causal, window=cfg.window if local else None,
        logit_softcap=cfg.attn_logit_softcap or None,
        impl=cfg.attn_impl, chunk_size=cfg.attn_chunk)
    return row_product(out.reshape(b, s, -1), p["wo"])


def _ssm_kw(cfg: ModelConfig) -> dict:
    return dict(state=cfg.ssm_state, conv=cfg.ssm_conv,
                expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                norm_eps=cfg.norm_eps)


def _mlp_part(cfg: ModelConfig, spec: BlockSpec, p: Params,
              h: torch.Tensor, exchange=None, split=None):
    """(h + the MLP sublayer's output, its MoE aux loss or None).
    ``exchange``: a sharded run's ``fsdp.MoeExchange`` (``moe_apply``);
    ``split``: its ``fsdp.ModelSplit`` where the layer splits over
    ``model`` (the dense MLP through ``mlp_share`` where it names
    "mlp")."""
    if spec.mlp == "none":
        return h, None
    x = rmsnorm(p["ln_mlp"], h, cfg.norm_eps)
    aux = None
    if spec.mlp == "dense" and split is not None \
            and "mlp" in split.sublayers:
        out = split.run(lambda q, xs: mlp_share(q, xs, act=cfg.act),
                        p["mlp"], x, 2)
    elif spec.mlp == "dense":
        out = mlp(p["mlp"], x, act=cfg.act)
    else:
        b, s, d = x.shape
        out, aux = moe_lib.moe_apply(
            p["moe"], x.reshape(b * s, d), top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.act,
            exchange=exchange)
        out = out.reshape(b, s, d)
    if cfg.use_post_norm:
        out = rmsnorm(p["post_ln_mlp"], out, cfg.norm_eps)
    return h + out, aux


def _apply_block_with_cache(cfg: ModelConfig, spec: BlockSpec, p: Params,
                            h: torch.Tensor, positions: torch.Tensor,
                            exchange=None, split=None):
    """(h, MoE aux or None, the layer's decode cache). ``split``: the
    layer's ``fsdp.ModelSplit`` on a mesh whose ``model`` ranks split
    its attention (``attn_share``; no cache) or its dense MLP; the
    post-norms and the residual adds run on the summed outputs."""
    x = rmsnorm(p["ln_mixer"], h, cfg.norm_eps)
    if split is not None and "attn" in split.sublayers:
        out = split.run(lambda q, xs: attn_share(cfg, spec, q, xs,
                                                 positions), p["attn"], x, 3)
        cache = None
    elif spec.mixer.startswith("attn"):
        out, cache = _attn_block(cfg, spec, p["attn"], x, positions)
    else:
        out, cache = ssm_lib.mamba2_forward(
            p["mamba"], x, chunk=cfg.ssm_chunk, return_cache=True,
            **_ssm_kw(cfg))
    if cfg.use_post_norm:
        out = rmsnorm(p["post_ln_mixer"], out, cfg.norm_eps)
    h, aux = _mlp_part(cfg, spec, p, h + out, exchange, split)
    return h, aux, cache


def _scaled(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype)
    return h


def _embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor):
    """(B, S, d) token rows in the compute dtype. Rows are gathered, then
    cast: the same values as the JAX order (cast the table, then gather)
    at a fraction of the traffic."""
    return params["embed"][tokens.long()].to(cfg.cdtype)


def _project(cfg: ModelConfig, params: Params, x: torch.Tensor):
    """Front-end embeddings (B, S, frontend_dim) through
    ``frontend_proj``, both cast first: the product runs in the compute
    dtype, as the reference's does."""
    cd = cfg.cdtype
    return x.to(cd) @ params["frontend_proj"].to(cd)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: dict):
    """(h (B, S, d), positions): (B, S), or (3, B, S) with M-RoPE. The
    ``patches`` rows come first, then the tokens'."""
    if cfg.frontend == "tokens":
        h = _embed_tokens(cfg, params, batch["tokens"])
    elif cfg.frontend == "frames":
        h = _project(cfg, params, batch["frames"])
    elif cfg.frontend == "patches":
        h = torch.cat([_project(cfg, params, batch["patches"]),
                       _embed_tokens(cfg, params, batch["tokens"])], 1)
    else:
        raise ValueError(cfg.frontend)
    h = _scaled(cfg, h)
    if "positions" in batch:
        positions = batch["positions"]
    else:
        b, s = h.shape[:2]
        positions = torch.arange(s, device=h.device).expand(b, s)
        if cfg.mrope_sections:
            positions = positions.expand(3, b, s)
    return h, positions


def _apply_block(cfg: ModelConfig, spec: BlockSpec, p: Params,
                 h: torch.Tensor, positions: torch.Tensor, exchange=None,
                 split=None):
    """(h, MoE aux or None): what ``checkpoint`` recomputes."""
    h, aux, _ = _apply_block_with_cache(cfg, spec, p, h, positions,
                                        exchange, split)
    return h, aux


# the 2-D products "dots" saves: JAX's dot_general with no batch dims
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(cfg: ModelConfig, params: Params) -> dict | None:
    """The ``checkpoint`` keywords of each layer
    (``repro/models/model.py:_remat``), or None where nothing is
    checkpointed: on when ``cfg.remat`` is, grad is enabled and a
    parameter requires it (training)."""
    if not (cfg.remat and torch.is_grad_enabled()
            and any(t.requires_grad for t in _leaves(params))):
        return None
    if cfg.remat_policy == "dots":
        return {"use_reentrant": False, "context_fn": _dots_context}
    return {"use_reentrant": False}     # "full", as any other name there


def _apply_gathered(cfg: ModelConfig, spec: BlockSpec, layout, i: int,
                    p: Params, h: torch.Tensor, positions: torch.Tensor):
    """``_apply_block`` on layer ``i``'s weights gathered from its blocks
    ``p`` (``launch/fsdp.py``), its sublayers split over ``model`` as
    the layout records: under ``checkpoint`` the backward gathers them
    again (and a MoE layer exchanges its counts again)."""
    return _apply_block(cfg, spec, layout.gather_layer(i, p), h, positions,
                        layout.moe_exchange, layout.model_split(i))


def _run_blocks(cfg: ModelConfig, params: Params, batch: dict,
                caches: list | None, layout=None):
    """(final hidden states, the sum of the MoE aux losses in float32);
    appends each layer's cache to ``caches`` where given. ``layout``
    (``launch/fsdp.Layout``): ``params`` are this rank's blocks,
    gathered where they are used."""
    check_supported(cfg)
    remat = _remat(cfg, params) if caches is None else None
    if layout is None:
        layers = cast_layers(cfg, params["layers"])
    else:
        if caches is not None:
            raise ValueError("a sharded forward has no decode caches")
        layers = params["layers"]
        params = layout.gather_top(params, ("embed", "frontend_proj",
                                            "final_norm"))
    h, positions = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, p in enumerate(layers):
        spec = cfg.layer_spec(i)
        if layout is not None:
            fn, args = _apply_gathered, (cfg, spec, layout, i, p, h,
                                         positions)
        else:
            fn, args = _apply_block, (cfg, spec, p, h, positions)
        if remat is not None:
            h, a = checkpoint(fn, *args, **remat)
        elif layout is not None:
            h, a = fn(*args)
        else:
            h, a, cache = _apply_block_with_cache(cfg, spec, p, h,
                                                  positions)
            if caches is not None:
                caches.append(cache)
        if a is not None:
            aux = aux + a
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), aux


def forward(cfg: ModelConfig, params: Params, batch: dict, layout=None):
    """Full-sequence forward -> (final hidden states (B, S, d), the MoE
    layers' summed load-balance loss (0 without MoE)). ``layout``: the
    sharded run's (``params`` this rank's blocks)."""
    return _run_blocks(cfg, params, batch, None, layout)


def prefill(cfg: ModelConfig, params: Params, batch: dict):
    """Full-sequence forward that also materializes the decode caches:
    (final hidden states (B, S, d), one cache per layer: ``{"k", "v"}``
    (B, S, Hkv, D) of post-RoPE keys, or Mamba-2's ``{"conv", "ssm"}``)."""
    caches: list = []
    return _run_blocks(cfg, params, batch, caches)[0], caches


def output_embedding(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """(V, d)."""
    return params["lm_head"].T if "lm_head" in params else params["embed"]


def logits_from_hidden(cfg: ModelConfig, params: Params,
                       h: torch.Tensor) -> torch.Tensor:
    emb = output_embedding(cfg, params).to(cfg.cdtype)
    logits = (h @ emb.T).float()
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Decode path (single-token step with caches)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device=None) -> list[Params]:
    """Zeroed caches on ``device`` (``None``: the GPU; ``"meta"``: shapes
    only, JAX's ``abstract=True``), one per layer: ``{"k", "v"}`` (B,
    max_len, Hkv, D) in the compute dtype for attention, for Mamba-2
    ``{"conv"}`` (B, conv - 1, channels) in the compute dtype and
    ``{"ssm"}`` (B, H, N, P) float32."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    out = []
    for i in range(cfg.num_layers):
        if cfg.layer_spec(i).mixer.startswith("attn"):
            out.append({"k": torch.zeros(shape, dtype=cfg.cdtype,
                                         device=device),
                        "v": torch.zeros(shape, dtype=cfg.cdtype,
                                         device=device)})
        else:
            out.append(ssm_lib.mamba2_init_cache(
                batch_size, cfg.d_model, state=cfg.ssm_state,
                conv=cfg.ssm_conv, expand=cfg.ssm_expand,
                head_dim=cfg.ssm_head_dim, dtype=cfg.cdtype, device=device))
    return out


def _attn_decode_block(cfg: ModelConfig, spec: BlockSpec, p: Params,
                       cache: Params, h: torch.Tensor, kv_len: torch.Tensor):
    b, s, _ = h.shape  # s == 1
    local = spec.mixer == "attn_local"
    q, k, v = _qkv(cfg, p, h)
    pos = (kv_len - 1)[:, None]              # (B, 1) current position
    if cfg.mrope_sections:
        pos = pos.expand(3, b, 1)            # the same in t, h and w
    q = _rotate(cfg, spec, q, pos)
    k = _rotate(cfg, spec, k, pos)
    # Write the new k/v at position kv_len - 1, in place in the
    # preallocated cache. (JAX's .at[].set, model.py:450-451, makes a
    # new cache array; outside a donating jit that is a copy per layer
    # per token.)
    rows = torch.arange(b, device=h.device)
    idx = (kv_len - 1).long()
    cache["k"][rows, idx] = k[:, 0].to(cfg.cdtype)
    cache["v"][rows, idx] = v[:, 0].to(cfg.cdtype)
    out = attn_lib.decode(q, cache["k"], cache["v"], kv_len=kv_len,
                          window=cfg.window if local else None,
                          logit_softcap=cfg.attn_logit_softcap or None,
                          impl=cfg.attn_impl)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return out, cache


def decode_step_hidden(cfg: ModelConfig, params: Params, caches,
                       tokens: torch.Tensor, kv_len: torch.Tensor):
    """One decode step. tokens (B, 1); kv_len (B,) int32 lengths
    *including* the new token. Returns (hidden (B, 1, d), caches), the
    caches updated in place."""
    check_supported(cfg)
    layers = cast_layers(cfg, params["layers"])
    h = _scaled(cfg, _embed_tokens(cfg, params, tokens))
    for i, (p, c) in enumerate(zip(layers, caches)):
        spec = cfg.layer_spec(i)
        x = rmsnorm(p["ln_mixer"], h, cfg.norm_eps)
        if spec.mixer.startswith("attn"):
            out, _ = _attn_decode_block(cfg, spec, p["attn"], c, x, kv_len)
        else:
            # the recurrence makes a new state; the layer's dict takes it
            out, new = ssm_lib.mamba2_decode(p["mamba"], c, x,
                                             **_ssm_kw(cfg))
            c.update(new)
        if cfg.use_post_norm:
            out = rmsnorm(p["post_ln_mixer"], out, cfg.norm_eps)
        h, _ = _mlp_part(cfg, spec, p, h + out)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), caches
