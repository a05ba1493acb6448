"""Mixture-of-Experts layer, ported from ``repro/models/moe.py``: a top-k
router and sort-based dispatch into fixed-capacity expert buffers.

Token->expert assignments are sorted by expert id (stable), each expert
takes the first ``cap`` of its assignments into an (E, cap, d) buffer,
the three expert products are batched matmuls over that buffer, and
each token's results come back weighted by its gates. Assignments past
an expert's capacity are dropped, as the reference's ``mode="drop"``
scatter drops them; which ones are dropped follows from the capacity,
the router's top-k order and the stable sort, each kept as in the
reference.

Everything keeps a fixed shape on the device: the dispatch writes the
dropped rows to one spare row of the buffer, and the gather back fills
0 for them, and the experts' counts are a ``scatter_add_`` into E
slots, so no step waits on a count from the card (``bincount`` would
read its input's maximum, and has no meta kernel for the dry run).

On a mesh (``launch/fsdp.py``) both functions take the layout's
``exchange`` (``fsdp.MoeExchange``); ``None`` is the one-process path.

* **Routing over the whole microbatch.** Where the batch is split over
  R ranks, the reference still routes the whole microbatch: capacity
  from all its tokens, each assignment's rank within its expert counted
  over all of them, the aux loss over all of them. Each rank gathers
  every rank's per-expert assignment counts and top-1 counts (2E
  integers) in block order: an assignment's rank within its expert is
  its local rank plus that expert's count on the earlier blocks, which
  is the reference's stable-sort rank over the flat (B * S) tokens,
  since block r holds the rows after blocks 0..r-1. The aux loss is
  returned as this rank's share, the gathered top-1 density against its
  own probabilities over the global token count: the shares add up to
  the reference's aux, and so does its gradient.
* **Experts over ``model``.** Where the spec splits E over ``model``,
  each rank holds E/m experts (gathered over ``data`` only) and
  computes only the assignments routed to them; the float32 partial
  outputs are all-reduced over ``model`` before the cast
  (``exchange.model_sum``), and the tokens and gates enter the expert
  part through ``exchange.enter``, whose backward all-reduces their
  gradients over ``model`` (Megatron's f and g). The router, the aux
  loss and the shared expert are computed whole on every ``model``
  rank. A serve's decode step takes the same path at its token count
  (one token a request), the capacity that of the whole batch. On one
  device, ``launch/fsdp.moe_in_turn``'s stand-in exchange computes
  every rank's experts in turn and sums their float32 terms in rank
  order, where the all-reduce would.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _act, dense_init, mlp, mlp_init

Params = dict[str, Any]


def moe_init(gen, d_model: int, d_ff: int, num_experts: int,
             num_shared: int = 0, dtype=torch.float32,
             device=None) -> Params:
    def e_init(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, dtype, device)
                            for _ in range(num_experts)])

    p = {
        "router": dense_init(gen, d_model, num_experts, torch.float32,
                             device),
        "wi_gate": e_init(d_model, d_ff),
        "wi_up": e_init(d_model, d_ff),
        "wo": e_init(d_ff, d_model),
    }
    if num_shared:
        p["shared"] = mlp_init(gen, d_model, d_ff * num_shared, dtype, device)
    return p


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    cap = int(math.ceil(num_tokens * top_k * capacity_factor / num_experts))
    # rounded up to 8 as the reference rounds it (its TPU tiles): the
    # capacity decides which assignments are dropped, so it stays
    return max(8, ((cap + 7) // 8) * 8)


def route(params: Params, x: torch.Tensor, *, top_k: int,
          capacity_factor: float = 1.25, exchange=None) -> dict:
    """The router and the repartition of ``x`` (T, d): every decision
    that says which token runs in which expert slot.

    Returns ``gate`` (T, k) normalised float32, ``expert_ids`` (T, k),
    ``aux`` (the Switch load-balance loss),
    ``cap``, and per assignment in the reference's sorted order
    (``order``, the stable argsort of the flat expert ids): ``pos`` its
    rank within its expert and ``dest`` its row in the flat
    (E * cap + 1, d) buffer (the last row takes the dropped ones).

    ``exchange`` (``launch/fsdp.MoeExchange``): ``x`` is this rank's
    block of a microbatch split over ``exchange.ranks`` ranks; ``cap``
    and ``pos`` are then the whole microbatch's and ``aux`` this rank's
    share of its aux loss (module docstring)."""
    t = x.shape[0]
    num_experts = params["router"].shape[1]
    split = exchange is not None and exchange.ranks > 1
    t_all = t * exchange.ranks if split else t
    cap = expert_capacity(t_all, num_experts, top_k, capacity_factor)
    # float32 logits from the weight as given (bf16 where the compute
    # dtype is: JAX promotes bf16 to float32 in the product)
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k puts the lower index first among equal values;
    # torch.topk does not, on the CPU (tests/test_torch_moe.py) nor on
    # CUDA (chip_smoke.py phase 10 prints it), so the top k come from a
    # stable descending sort, which keeps equal values in index order
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_ids = srt.values[:, :top_k], srt.indices[:, :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = _counts(flat_e, num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * top_k, device=x.device) - starts[se]

    # load-balance aux loss (Switch-style): no gradient through the ids;
    # split, the ranks and the aux count every batch rank's tokens
    if split:
        top1 = _counts(expert_ids[:, 0], num_experts)
        every = exchange.gather_counts(torch.cat([counts, top1]))  # (R, 2E)
        pos = pos + every[:exchange.index, :num_experts].sum(0)[se]
        density = every[:, num_experts:].sum(0).float() / t_all
        aux = num_experts * torch.sum(density * probs.sum(0)) / t_all
    else:
        density = F.one_hot(expert_ids[:, 0], num_experts).float().mean(0)
        aux = num_experts * torch.sum(density * probs.mean(0))

    dest = torch.where(pos < cap, se * cap + pos,
                       torch.full_like(pos, num_experts * cap))
    return {"gate": gate, "expert_ids": expert_ids, "aux": aux, "cap": cap,
            "order": order, "pos": pos, "dest": dest}


def _counts(ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """How many of ``ids`` name each expert, (E,) int64."""
    return torch.zeros(num_experts, dtype=ids.dtype,
                       device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def moe_apply(params: Params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              exchange=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flat tokens -> (out (T, d), aux load-balance loss).

    ``exchange`` (``launch/fsdp.MoeExchange``): routing over the whole
    microbatch (``route``), and where ``params``' experts are this
    rank's E/m of E, the experts computed on the ``model`` ranks that
    hold them (module docstring)."""
    num_experts = params["router"].shape[1]
    r = route(params, x, top_k=top_k, capacity_factor=capacity_factor,
              exchange=exchange)
    w = (params["wi_gate"], params["wi_up"], params["wo"])
    terms = partial(_expert_terms, r=r, num_experts=num_experts, top_k=top_k,
                    act=act)
    if w[0].shape[0] < num_experts:         # this rank's E/m experts
        y = exchange.experts(terms, w, x, r["gate"])
    else:
        y = terms(w, x, r["gate"], 0)
    y = y.to(x.dtype)

    if "shared" in params:
        y = y + mlp(params["shared"], x, act=act)
    return y, r["aux"]


def _expert_terms(w: tuple, xe: torch.Tensor, gate: torch.Tensor,
                  model_rank: int, *, r: dict, num_experts: int, top_k: int,
                  act: str) -> torch.Tensor:
    """Each token's gated results of the experts ``w`` (wi_gate, wi_up,
    wo) holds, summed over its k assignments (T, d): all E experts, or
    block ``model_rank`` of E/m of them (0 for the tokens routed
    elsewhere), in float32 for top-k > 1, else in ``xe``'s dtype."""
    t, d = xe.shape
    cap, order, dest = r["cap"], r["order"], r["dest"]
    held = w[0].shape[0]
    rows = held * cap
    if held < num_experts:
        # this rank's experts' slots, the rest (and the dropped) to the
        # spare row
        dest = dest - model_rank * rows
        dest = torch.where((dest >= 0) & (dest < rows), dest,
                           torch.full_like(dest, rows))

    # scatter the sorted assignments' tokens into the (E, cap, d) buffer
    st = order // top_k                      # token of each assignment
    buf = xe.new_zeros((rows + 1, d)).index_put((dest,), xe[st])
    buf = buf[:rows].view(held, cap, d)

    # grouped expert products (library batched matmuls, as the
    # reference's XLA einsums)
    h = _act(torch.bmm(buf, w[0]), act) * torch.bmm(buf, w[1])
    out = torch.bmm(h, w[2]).view(rows, d)

    # each token's k results in its (token, slot) order, 0 where dropped,
    # summed over k: the reference's scatter-add in another order only
    # (no float atomics, so the same bits from launch to launch)
    dest_tk = torch.empty_like(dest).scatter_(0, order, dest)
    got = out[dest_tk.clamp(max=rows - 1)]
    got = torch.where((dest_tk < rows)[:, None], got, torch.zeros_like(got))
    # top-1 has one term per token: the reference combines it in the
    # compute dtype (moe.py:92-97), top-k > 1 in float32
    acc = torch.float32 if top_k > 1 else xe.dtype
    return (got.view(t, top_k, d).to(acc) * gate.to(acc)[..., None]).sum(1)
