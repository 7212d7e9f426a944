"""Conversion CLI: a dense (or MoE) checkpoint -> a CMoE checkpoint. Port
of ``repro/launch/convert.py``.

    python -m repro_torch.launch.convert --arch qwen1.5-0.5b \\
        --cmoe S3A3E8 --calib-samples 8 --out ckpts/cmoe
    python -m repro_torch.launch.convert --smoke --device cpu --out ckpts/cmoe

The paper's pipeline: load (seeded random weights, or ``--from-ckpt``, a
checkpoint holding {"params": ...}) -> profile on calibration tokens ->
partition + analytical router -> save {"params": ...} with the extra state
{arch, cmoe, smoke}. Dense models go through ``convert_dense_model``, the
moe family through ``convert_moe_model`` (hierarchical CMoE). Runs on the
GPU unless ``--device cpu`` is given, and raises when no GPU is present.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import override
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.convert import convert_dense_model
from repro_torch.core.hierarchical import convert_moe_model
from repro_torch.data import make_calibration_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.serve import parse_sxayez
from repro_torch.models import build_model


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cmoe", default="S3A3E8")
    ap.add_argument("--k-activation", type=int, default=0,
                    help="0 = auto (d_ff/32, min 2)")
    ap.add_argument("--calib-samples", type=int, default=8)
    ap.add_argument("--calib-seq", type=int, default=128)
    ap.add_argument("--assignment", default="auto",
                    choices=["auto", "jv", "sinkhorn"])
    ap.add_argument("--from-ckpt", default=None,
                    help="checkpoint dir holding {'params': ...}")
    ap.add_argument("--out", default="checkpoints/cmoe")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless this is 'cpu')")
    return ap


def conversion_config(cfg, args):
    """The CMoEConfig the CLI converts with: the SxAyEz tag, k_activation
    (0 = max(2, d_ff // 32)) and the assignment solver."""
    cm = parse_sxayez(args.cmoe)
    ka = args.k_activation or max(2, cfg.d_ff // 32 if cfg.d_ff else 2)
    return dataclasses.replace(cm, k_activation=ka,
                               assignment=args.assignment)


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = override(cfg, dtype="float32") if args.smoke else cfg
    # no kernels, as the reference's CLI builds its model: the calibration
    # forward runs the plain FFN, so a conversion here reaches no kernel
    model = build_model(cfg, use_kernel=False, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    if args.from_ckpt:
        mgr_in = CheckpointManager(args.from_ckpt)
        (state, _) = mgr_in.restore({"params": params})
        params = state["params"]
        print(f"loaded params from {args.from_ckpt} "
              f"(step {mgr_in.latest_step()})")

    cm = conversion_config(cfg, args)
    calib = make_calibration_batch(cfg.vocab_size, args.calib_samples,
                                   args.calib_seq, seed=1234)
    calib = {"tokens": torch.as_tensor(calib["tokens"], dtype=torch.long,
                                       device=device)}

    t0 = time.perf_counter()
    with torch.no_grad():
        if cfg.family == "moe":
            new_model, new_params, rep = convert_moe_model(model, params,
                                                           calib, cm)
            print(f"hierarchical conversion: {rep.num_layers} layers x "
                  f"{rep.num_experts} experts in {rep.seconds_total:.1f}s")
        else:
            new_model, new_params, rep = convert_dense_model(model, params,
                                                             calib, cm)
            print(f"converted {rep.num_layers} FFN layers in "
                  f"{rep.seconds_total:.1f}s (profile "
                  f"{rep.seconds_profile:.1f}s + cluster "
                  f"{rep.seconds_cluster:.1f}s, {rep.calib_tokens} calib "
                  f"tokens)")

    mgr = CheckpointManager(args.out, keep=2)
    mgr.save(0, {"params": new_params},
             {"arch": args.arch, "cmoe": cm.tag(), "smoke": args.smoke},
             block=True)
    print(f"saved converted checkpoint to {args.out} "
          f"({cm.tag()}, {cm.sparsity:.0%} sparsity, "
          f"total {time.perf_counter()-t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
