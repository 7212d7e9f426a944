"""Fault-tolerant training CLI. Port of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir ckpts
    python -m repro_torch.launch.train --smoke --device cpu --steps 20

Runs on the GPU (``cuda``) unless ``--device cpu`` is given, and raises
when no GPU is present. The model is built with its kernels off: the CUDA
kernels have no backward (``Model.loss`` refuses them under autograd).
``--smoke`` takes the arch's reduced config in float32 and turns layer
remat off, as in the reference.

Fault-tolerance contract:
  * a checkpoint every ``--ckpt-every`` steps (async, atomic commit) and a
    final one;
  * ``--resume auto`` restarts from the newest committed step: params,
    optimizer state and the data loader's position (the stream resumes
    exactly);
  * SIGTERM (preemption) triggers one synchronous checkpoint, then exit 0;
  * the loader is a pure function of (seed, shard, step);
  * straggler log: a step over ``--step-timeout`` x the median step time
    prints a straggler line.

One difference from the reference: when ``--resume auto`` finds the run
already finished (the restored step is ``--steps``), it prints the
restored step and exits 0, where the reference's final line indexes an
empty loss list and raises.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import override
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import ShardedLoader
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.balance import apply_balance_update


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--step-timeout", type=float, default=5.0,
                    help="straggler threshold: multiple of median step time")
    ap.add_argument("--balance-gamma", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless this is 'cpu')")
    return ap


def step_batch(cfg, loader: ShardedLoader, step: int, batch_size: int,
               device) -> dict:
    """The loader's next tokens on `device`, with the audio family's frames
    and the VLM family's patches drawn N(0, 1) from
    ``np.random.default_rng(step)``, as the reference draws them."""
    batch = {"tokens": torch.as_tensor(next(loader)["tokens"],
                                       dtype=torch.long, device=device)}
    if cfg.family == "audio":
        rng = np.random.default_rng(step)
        batch["frames"] = torch.as_tensor(rng.normal(
            0, 1, (batch_size, cfg.encoder.num_frames,
                   cfg.d_model)).astype(np.float32), device=device)
    if cfg.family == "vlm":
        rng = np.random.default_rng(step)
        batch["patches"] = torch.as_tensor(rng.normal(
            0, 1, (batch_size, cfg.vision.num_patches,
                   cfg.d_model)).astype(np.float32), device=device)
    return batch


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # float32 products in full float32 and bfloat16 products summed in
        # float32, as the reference's preferred_element_type=f32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = override(cfg, dtype="float32") if args.smoke else cfg
    model = build_model(cfg, use_kernel=False, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    opt = adamw_init(params)
    loader = ShardedLoader(cfg.vocab_size, args.batch, args.seq,
                           seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)

    start_step = 0
    if args.resume == "auto" and mgr.latest_step() is not None:
        (state, extra) = mgr.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        loader.load_state_dict(extra["loader"])
        start_step = int(extra["step"])
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    step_fn = make_train_step(
        model, lr=args.lr, warmup=args.warmup, total=args.steps,
        remat=not args.smoke)

    # preemption: one synchronous save then exit cleanly
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_term)
    try:
        return _loop(args, cfg, device, params, opt, loader, mgr, step_fn,
                     start_step, preempted)
    finally:
        signal.signal(signal.SIGTERM, old_handler)


def _loop(args, cfg, device, params, opt, loader, mgr, step_fn,
          start_step, preempted) -> int:
    times: list[float] = []
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = step_batch(cfg, loader, step, args.batch, device)
        params, opt, metrics = step_fn(params, opt, batch)
        if "moe_load" in metrics and args.balance_gamma > 0:
            params = apply_balance_update(params, metrics["moe_load"],
                                          gamma=args.balance_gamma)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(loss)
        if len(times) > 8:
            med = float(np.median(times[-64:]))
            if dt > args.step_timeout * med:
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s)", flush=True)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt*1000:.0f}ms", flush=True)
        if (step + 1) % args.ckpt_every == 0 or preempted["flag"]:
            mgr.save(step + 1, {"params": params, "opt": opt},
                     {"loader": loader.state_dict(), "step": step + 1},
                     block=preempted["flag"])
            if preempted["flag"]:
                print(f"[preempt] saved step {step + 1}; exiting")
                return 0
    mgr.save(args.steps, {"params": params, "opt": opt},
             {"loader": loader.state_dict(), "step": args.steps},
             block=True)
    if not losses:
        print(f"done: restored step {start_step}, nothing left to run")
        return 0
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
