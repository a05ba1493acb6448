"""Composable decoder LM, ported from ``repro/models/model.py``: dense
attention blocks with the serve path (prefill, decode with a KV cache).

A model is a stack of ``num_layers`` blocks whose specs cycle through a
period ``pattern`` of ``BlockSpec``s, as in the JAX package. Where JAX
stacks each period position's parameters on a leading K axis and runs
one ``lax.scan`` over K (to keep the HLO small), the port keeps one
parameter dict per layer (``params["layers"]``) and runs a Python loop
over the layers; ``models/convert.py`` maps one tree onto the other.
Caches are one ``{"k", "v"}`` dict per layer, (B, Smax, Hkv, D).

Left out, because they have no meaning in an eager serve path:
``_seq_constraint`` (a GSPMD sharding constraint) and ``_remat``
(activation checkpointing for training). Not ported yet, and raising
``NotImplementedError`` naming their ROADMAP item (ROADMAP.md, open
item 7): the ``mamba`` mixer, the ``moe`` MLP, M-RoPE and the
``frames``/``patches`` front ends.

The JAX steps cast the block weights to the compute dtype inside every
jitted call (``_cast_blocks``). Here ``compute_params`` does that cast
once, for the embedding and output matrices too; the functions below
accept either tree and cast what is still float32 (a no-op on a cast
tree). Casting elementwise before or after a gather or a transpose gives
the same values, so the results are those of the JAX order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       mlp, mlp_init, rmsnorm, rmsnorm_init,
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
    remat: bool = True                # training only: not used here
    remat_policy: str = "full"        # training only: not used here
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


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet
    (module docstring)."""
    todo = "not ported yet (ROADMAP.md, open item 7: {})"
    for spec in cfg.pattern:
        if spec.mixer == "mamba":
            raise NotImplementedError("mamba mixer " + todo.format("ssm"))
        if spec.mlp == "moe":
            raise NotImplementedError("moe MLP " + todo.format("moe"))
        if spec.mixer not in ("attn", "attn_local") \
                or spec.mlp not in ("dense", "none"):
            raise ValueError(spec)
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE " + todo.format("vlm/audio"))
    if cfg.frontend != "tokens":
        raise NotImplementedError(f"{cfg.frontend} front end "
                                  + todo.format("vlm/audio"))


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
    p["attn"] = {
        "wq": dense_init(gen, d, cfg.num_heads * hd, dt, device),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
        "wo": dense_init(gen, cfg.num_heads * hd, d, dt, device),
    }
    if cfg.qk_norm:
        p["attn"]["q_norm"] = rmsnorm_init(hd, dt, device)
        p["attn"]["k_norm"] = rmsnorm_init(hd, dt, device)
    if cfg.use_post_norm:
        p["post_ln_mixer"] = rmsnorm_init(d, dt, device)
    if spec.mlp == "dense":
        p["ln_mlp"] = rmsnorm_init(d, dt, device)
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, dt, device)
    if cfg.use_post_norm and spec.mlp != "none":
        p["post_ln_mlp"] = rmsnorm_init(d, dt, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> Params:
    """Seeded random weights on ``device`` (one ``torch.Generator`` of
    that device, drawn layer by layer): ``{"embed", "layers": [one dict
    per layer], "final_norm", "lm_head"?}``."""
    check_supported(cfg)
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    layers = [_init_block(cfg, cfg.layer_spec(i), gen, device)
              for i in range(cfg.num_layers)]
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype,
                            device),
        "layers": layers,
        "final_norm": rmsnorm_init(cfg.d_model, cfg.pdtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                  cfg.pdtype, device)
    return p


def abstract_params(cfg: ModelConfig) -> Params:
    """The parameter tree on the meta device: shapes and dtypes, no
    memory."""
    return init_params(cfg, device="meta")


def compute_params(cfg: ModelConfig, params: Params) -> Params:
    """The tree with every float32 matrix cast to the compute dtype (the
    norm scales stay float32), made once per serve (module docstring)."""
    cd = cfg.cdtype
    return tree_map(lambda a: a.to(cd) if a.dtype == torch.float32
                    and a.dim() > 1 else a, params)


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


def _attn_block(cfg: ModelConfig, spec: BlockSpec, p: Params,
                h: torch.Tensor, positions: torch.Tensor):
    b, s, _ = h.shape
    local = spec.mixer == "attn_local"
    q, k, v = _qkv(cfg, p, h)
    if cfg.use_rope:
        q = apply_rope(q, positions, _theta(cfg, spec))
        k = apply_rope(k, positions, _theta(cfg, spec))
    out = attn_lib.attention(
        q, k, v, causal=cfg.causal, window=cfg.window if local else None,
        logit_softcap=cfg.attn_logit_softcap or None,
        impl=cfg.attn_impl, chunk_size=cfg.attn_chunk)
    out = out.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]
    cache = {"k": k.to(cfg.cdtype), "v": v.to(cfg.cdtype)}
    return out, cache


def _mlp_part(cfg: ModelConfig, spec: BlockSpec, p: Params,
              h: torch.Tensor) -> torch.Tensor:
    if spec.mlp == "none":
        return h
    out = mlp(p["mlp"], rmsnorm(p["ln_mlp"], h, cfg.norm_eps), act=cfg.act)
    if cfg.use_post_norm:
        out = rmsnorm(p["post_ln_mlp"], out, cfg.norm_eps)
    return h + out


def _apply_block_with_cache(cfg: ModelConfig, spec: BlockSpec, p: Params,
                            h: torch.Tensor, positions: torch.Tensor):
    x = rmsnorm(p["ln_mixer"], h, cfg.norm_eps)
    out, cache = _attn_block(cfg, spec, p["attn"], x, positions)
    if cfg.use_post_norm:
        out = rmsnorm(p["post_ln_mixer"], out, cfg.norm_eps)
    return _mlp_part(cfg, spec, p, h + out), cache


def _embed_inputs(cfg: ModelConfig, params: Params, batch: dict):
    """(h (B, S, d), positions (B, S)). Rows are gathered, then cast:
    the same values as the JAX order (cast the table, then gather) at a
    fraction of the traffic."""
    cd = cfg.cdtype
    tokens = batch["tokens"]
    h = params["embed"][tokens.long()].to(cd)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cd)
    if "positions" in batch:
        positions = batch["positions"]
    else:
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    return h, positions


def _run_blocks(cfg: ModelConfig, params: Params, batch: dict,
                caches: list | None) -> torch.Tensor:
    check_supported(cfg)
    layers = compute_params(cfg, params["layers"])
    h, positions = _embed_inputs(cfg, params, batch)
    for i, p in enumerate(layers):
        h, cache = _apply_block_with_cache(cfg, cfg.layer_spec(i), p, h,
                                           positions)
        if caches is not None:
            caches.append(cache)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)


def forward(cfg: ModelConfig, params: Params, batch: dict):
    """Full-sequence forward -> (final hidden states (B, S, d), moe aux
    (always 0: no moe yet))."""
    h = _run_blocks(cfg, params, batch, None)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def prefill(cfg: ModelConfig, params: Params, batch: dict):
    """Full-sequence forward that also materializes the decode caches:
    (final hidden states (B, S, d), [{"k", "v"} (B, S, Hkv, D) per
    layer] of post-RoPE keys)."""
    caches: list = []
    return _run_blocks(cfg, params, batch, caches), caches


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
               device="cpu") -> list[Params]:
    """Zeroed caches, one ``{"k", "v"}`` (B, max_len, Hkv, D) per layer
    (``device="meta"``: shapes only, JAX's ``abstract=True``)."""
    check_supported(cfg)
    shape = (batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
            for _ in range(cfg.num_layers)]


def _attn_decode_block(cfg: ModelConfig, spec: BlockSpec, p: Params,
                       cache: Params, h: torch.Tensor, kv_len: torch.Tensor):
    b, s, _ = h.shape  # s == 1
    local = spec.mixer == "attn_local"
    q, k, v = _qkv(cfg, p, h)
    if cfg.use_rope:
        pos = (kv_len - 1)[:, None]          # (B, 1) current position
        q = apply_rope(q, pos, _theta(cfg, spec))
        k = apply_rope(k, pos, _theta(cfg, spec))
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
    layers = compute_params(cfg, params["layers"])
    h, _ = _embed_inputs(cfg, params, {"tokens": tokens})
    for i, (p, c) in enumerate(zip(layers, caches)):
        spec = cfg.layer_spec(i)
        x = rmsnorm(p["ln_mixer"], h, cfg.norm_eps)
        out, _ = _attn_decode_block(cfg, spec, p["attn"], c, x, kv_len)
        if cfg.use_post_norm:
            out = rmsnorm(p["post_ln_mixer"], out, cfg.norm_eps)
        h = _mlp_part(cfg, spec, p, h + out)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps), caches
