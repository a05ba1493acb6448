"""End-to-end LM training on the PyTorch port, with fault tolerance
(the steps of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py                # GPU
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

Trains a reduced-config model through the production path —
microbatched grad accumulation, AdamW + clipping, async atomic
checkpointing, the flash-attention kernels forward and backward on the
GPU — then kills itself mid-run and resumes from the last committed
checkpoint, demonstrating the restart story. ``--full`` trains the
published config (one GPU). The reduced config's heads are 16 wide,
which the kernels do not take: on the GPU it runs with head_dim 64.
"""
import argparse
import shutil
import tempfile

from repro_torch.checkpoint import latest_step
from repro_torch.launch.train import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    overrides = (None if args.device == "cpu" or args.full
                 else {"head_dim": 64})
    every = max(1, min(25, args.steps // 4))
    kw = dict(smoke=not args.full, steps=args.steps, batch=8, seq=64,
              ckpt_every=every, log_every=every, device=args.device,
              overrides=overrides)

    ckpt = tempfile.mkdtemp(prefix="vxtorch_ckpt_")
    try:
        crash_at = args.steps // 2
        print(f"=== phase 1: train to step {crash_at}, then crash")
        try:
            train(args.arch, ckpt_dir=ckpt, fail_at=crash_at, **kw)
        except RuntimeError as e:
            print(f"    crashed as planned: {e}")
        print(f"    last committed checkpoint: step {latest_step(ckpt)}")

        print("=== phase 2: restart — resumes from the checkpoint")
        out = train(args.arch, ckpt_dir=ckpt, **kw)
        print(f"=== done: {len(out['losses'])} post-resume steps, "
              f"final loss {out['losses'][-1]:.4f} "
              f"({out['wall_s']:.1f}s)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
