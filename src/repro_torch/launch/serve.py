"""Serving driver: batched prefill + greedy decode with a KV cache,
ported from ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --full
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --full --mesh 1,4

Requests arrive with different prompt lengths; the server right-pads
them to ``prompt_len``, prefills the batch in one shot, then decodes
greedily with per-request ``kv_len`` so that shorter prompts are masked
correctly. As in the reference, the first decode step feeds the last
prompt token again, at position ``len`` (``serve.py:60-66``). Runs on
the GPU unless ``device="cpu"`` is asked for; with ``attn_impl`` at
"auto" the card's path goes through the flash and decode kernels.

With ``mesh`` (a ``("data", "model")`` ``DeviceMesh`` over an initialized
process group; ``--mesh D,M`` under ``torchrun``, NCCL on the GPUs, gloo
with ``--device cpu``) every rank of the mesh serves the same requests
together (``launch/fsdp.ServeLayout``): the batch split over ``data``,
attention heads, dense-MLP columns, experts and the vocabulary over
``model``, the caches' sequence over ``model``, each decode step's
attention the decode kernel's partial mode on each rank's slice with
the rows' partials combined over the ranks, and the greedy token the
argmax over the split vocabulary. Models with Mamba-2 layers raise
``ValueError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models import steps as steps_lib
from repro_torch.models.layers import split_argmax


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(arch: str = "qwen3-1.7b", *, smoke: bool = True,
                num_requests: int = 4, prompt_len: int = 32,
                gen_len: int = 16, seed: int = 0, device=None,
                params=None, overrides: dict | None = None,
                force_tokens=None, mesh=None) -> dict:
    """Serve ``num_requests`` random prompts of lengths in
    [prompt_len // 2, prompt_len] and generate ``gen_len`` tokens each.

    ``params``: the model's weights (else seeded random ones, as the
    reference's); ``overrides``: ``ModelConfig`` fields to replace
    (e.g. ``compute_dtype``, ``attn_impl``); ``force_tokens``
    (num_requests, gen_len): feed these tokens instead of the argmax
    (teacher forcing; ``generated`` still holds the argmax).

    Returns the reference's keys (``generated``, ``prefill_s``,
    ``decode_s``, ``tok_per_s``) and ``prefill_logits`` (B, 1, V) and
    ``step_logits`` (B, gen_len, V), float32 on the device.

    ``mesh``: serve over it (module docstring); ``params`` are then whole
    weights from which each rank keeps its blocks, and every rank returns
    the whole batch's tokens and the whole batch's and vocabulary's
    logits."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.frontend != "tokens":
        raise SystemExit(f"{arch}: serving demo targets token LMs")
    rng = np.random.default_rng(seed)
    if mesh is not None:
        lens, toks = _requests(rng, cfg, num_requests, prompt_len)
        return _serve_split(cfg, mesh, toks, lens, gen_len, seed, device,
                            params, force_tokens)
    # the seeded weights drawn in the compute dtype layer by layer; given
    # weights are cast once per serve
    cparams = (model_lib.init_compute_params(cfg, seed, device)
               if params is None else model_lib.compute_params(cfg, params))

    max_len = prompt_len + gen_len
    lens, toks = _requests(rng, cfg, num_requests, prompt_len)

    prefill = steps_lib.make_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    prefill_logits, pcaches = prefill(
        cparams, {"tokens": torch.as_tensor(toks, device=device)})
    # attention caches from prefill hold prompt_len slots; decode needs
    # room to grow: copy them into max_len buffers. A Mamba-2 cache
    # ({"conv", "ssm"}) has the same shape in both: copied whole, as
    # the reference's grow keeps it
    caches = model_lib.init_cache(cfg, num_requests, max_len, device)
    for dst, src in zip(caches, pcaches):
        if "k" in src:
            dst["k"][:, :prompt_len] = src["k"]
            dst["v"][:, :prompt_len] = src["v"]
        else:
            for key in dst:
                dst[key].copy_(src[key])
    del pcaches
    _sync(device)
    t_prefill = time.perf_counter() - t0

    kv_len = torch.as_tensor(lens, dtype=torch.int32, device=device)
    tok = torch.as_tensor([toks[i, n - 1] for i, n in enumerate(lens)],
                          dtype=torch.int32, device=device)[:, None]
    forced = None if force_tokens is None else torch.as_tensor(
        np.asarray(force_tokens), dtype=torch.int32, device=device)
    outs, step_logits = [], []
    t0 = time.perf_counter()
    for step in range(gen_len):
        kv_len = kv_len + 1
        logits, caches = decode(cparams, caches, tok, kv_len)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        outs.append(tok[:, 0])
        step_logits.append(logits[:, -1])
        if forced is not None:
            tok = forced[:, step:step + 1]
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = torch.stack(outs, 1).cpu().numpy()
    return {"generated": gen, "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": num_requests * gen_len / max(t_decode, 1e-9),
            "prefill_logits": prefill_logits,
            "step_logits": torch.stack(step_logits, 1)}


def _requests(rng, cfg, num_requests: int, prompt_len: int):
    """(lengths, right-padded prompt tokens) of the random requests."""
    lens = rng.integers(prompt_len // 2, prompt_len + 1, num_requests)
    toks = np.zeros((num_requests, prompt_len), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)
    return lens, toks


def _serve_split(cfg, mesh, toks, lens, gen_len: int, seed: int, device,
                 params, force_tokens) -> dict:
    """``serve_batch`` over ``mesh`` on this rank (``launch/fsdp.py``)."""
    from repro_torch.launch import fsdp
    n, prompt_len = toks.shape
    max_len = prompt_len + gen_len
    layout = fsdp.ServeLayout(cfg, mesh, n, max_len)
    # each rank keeps its blocks of the seeded whole as it is drawn
    cparams = (model_lib.init_params(cfg, seed, device, keep=layout.keep)
               if params is None else layout.shard(params))
    prefill = steps_lib.make_prefill_step(cfg, layout)
    decode = steps_lib.make_decode_step(cfg, layout)

    def rows(x):
        return layout.rows(torch.as_tensor(np.asarray(x), device=device))

    _sync(device)
    t0 = time.perf_counter()
    tokens = rows(toks)
    prefill_logits, pcaches = prefill(cparams, {"tokens": tokens})
    caches = model_lib.init_cache(cfg, n, max_len, device, layout)
    layout.fill_caches(caches, pcaches, prompt_len)
    del pcaches
    _sync(device)
    t_prefill = time.perf_counter() - t0

    kv_len = rows(lens.astype(np.int32))
    tok = rows(np.asarray([toks[i, m - 1] for i, m in enumerate(lens)],
                          np.int32)[:, None])
    forced = None if force_tokens is None \
        else rows(np.asarray(force_tokens, np.int32))
    outs, step_logits = [], []
    t0 = time.perf_counter()
    for step in range(gen_len):
        kv_len = kv_len + 1
        logits, caches = decode(cparams, caches, tok, kv_len)
        tok = split_argmax(logits[:, -1], layout.vocab).to(
            torch.int32)[:, None]
        outs.append(tok[:, 0])
        step_logits.append(logits[:, -1])
        if forced is not None:
            tok = forced[:, step:step + 1]
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = layout.all_rows(torch.stack(outs, 1)).cpu().numpy()
    return {"generated": gen, "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": n * gen_len / max(t_decode, 1e-9),
            "prefill_logits": layout.whole_logits(prefill_logits),
            "step_logits": layout.whole_logits(torch.stack(step_logits, 1))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--mesh", default=None,
                    help="D,M: serve over a (data, model) mesh of D x M "
                         "ranks (under torchrun; NCCL on the GPUs, gloo "
                         "with --device cpu)")
    args = ap.parse_args()
    mesh = None
    device = args.device
    if args.mesh:
        import torch.distributed as dist
        from repro_torch.launch import mesh as mesh_lib
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            device = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(mesh_lib.BACKENDS[dev.type])
        mesh = mesh_lib.make_mesh(tuple(int(x) for x in
                                        args.mesh.split(",")), dev.type)
    out = serve_batch(args.arch, smoke=not args.full,
                      num_requests=args.requests,
                      prompt_len=args.prompt_len, gen_len=args.gen,
                      device=device, mesh=mesh)
    if mesh is not None:
        import torch.distributed as dist
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank:
            return
    print(f"generated {out['generated'].shape} tokens; "
          f"prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
