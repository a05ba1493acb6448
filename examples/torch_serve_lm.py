"""Batched LM serving on the PyTorch port: prefill + greedy decode with
KV caches (the steps of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py                # GPU
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Requests with ragged prompt lengths are batched, prefilled in one shot
(the flash-attention kernel on the GPU) and decoded with per-request
kv_len masking (the decode-attention kernel). The reduced config's
heads are 16 wide, which the kernels do not take: on the GPU it runs
with head_dim 64, the kernels' narrowest. ``--full`` serves the
published config (GPU).
"""
import argparse

from repro_torch.launch.serve import serve_batch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    overrides = None if on_cpu or args.full else {"head_dim": 64}
    out = serve_batch(args.arch, smoke=not args.full,
                      num_requests=args.requests, prompt_len=48,
                      gen_len=args.gen, device=args.device,
                      overrides=overrides)
    size = "full" if args.full else "reduced"
    print(f"generated {out['generated'].shape[0]} x "
          f"{out['generated'].shape[1]} tokens")
    print(f"prefill {out['prefill_s']:.2f}s, decode {out['decode_s']:.2f}s"
          f" -> {out['tok_per_s']:.1f} tok/s ({size} cfg, "
          f"{'CPU' if on_cpu else 'GPU'})")
    for i, row in enumerate(out["generated"][:3]):
        print(f"req {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
