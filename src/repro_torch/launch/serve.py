"""Serving driver: batched prefill + greedy decode with a KV cache,
ported from ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --full

Requests arrive with different prompt lengths; the server right-pads
them to ``prompt_len``, prefills the batch in one shot, then decodes
greedily with per-request ``kv_len`` so that shorter prompts are masked
correctly. As in the reference, the first decode step feeds the last
prompt token again, at position ``len`` (``serve.py:60-66``). Runs on
the GPU unless ``device="cpu"`` is asked for; with ``attn_impl`` at
"auto" the card's path goes through the flash and decode kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.executor import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models import steps as steps_lib


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(arch: str = "qwen3-1.7b", *, smoke: bool = True,
                num_requests: int = 4, prompt_len: int = 32,
                gen_len: int = 16, seed: int = 0, device=None,
                params=None, overrides: dict | None = None,
                force_tokens=None) -> dict:
    """Serve ``num_requests`` random prompts of lengths in
    [prompt_len // 2, prompt_len] and generate ``gen_len`` tokens each.

    ``params``: the model's weights (else seeded random ones, as the
    reference's); ``overrides``: ``ModelConfig`` fields to replace
    (e.g. ``compute_dtype``, ``attn_impl``); ``force_tokens``
    (num_requests, gen_len): feed these tokens instead of the argmax
    (teacher forcing; ``generated`` still holds the argmax).

    Returns the reference's keys (``generated``, ``prefill_s``,
    ``decode_s``, ``tok_per_s``) and ``prefill_logits`` (B, 1, V) and
    ``step_logits`` (B, gen_len, V), float32 on the device."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.frontend != "tokens":
        raise SystemExit(f"{arch}: serving demo targets token LMs")
    rng = np.random.default_rng(seed)
    if params is None:
        params = model_lib.init_params(cfg, seed, device)
    cparams = model_lib.compute_params(cfg, params)

    max_len = prompt_len + gen_len
    lens = rng.integers(prompt_len // 2, prompt_len + 1, num_requests)
    toks = np.zeros((num_requests, prompt_len), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)

    prefill = steps_lib.make_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    prefill_logits, pcaches = prefill(
        cparams, {"tokens": torch.as_tensor(toks, device=device)})
    # caches from prefill hold prompt_len slots; decode needs room to
    # grow: copy them into max_len buffers
    caches = model_lib.init_cache(cfg, num_requests, max_len, device)
    for dst, src in zip(caches, pcaches):
        dst["k"][:, :prompt_len] = src["k"]
        dst["v"][:, :prompt_len] = src["v"]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args()
    out = serve_batch(args.arch, smoke=not args.full,
                      num_requests=args.requests,
                      prompt_len=args.prompt_len, gen_len=args.gen,
                      device=args.device)
    print(f"generated {out['generated'].shape} tokens; "
          f"prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")


if __name__ == "__main__":
    main()
