"""Serving CLI, static mode: build a dense model from a seed, optionally
convert it to CMoE on a synthetic calibration batch, then one prefill and a
greedy (or temperature) decode loop. Port of the static mode of
``repro/launch/serve.py``; the continuous-batching engine comes with a
later slice.

Runs on the GPU (``cuda``) unless ``--device cpu`` is given, and raises when
no GPU is present and the CPU was not asked for. ``--use-kernel`` defaults
to on exactly on CUDA; ``--no-use-kernel`` runs the plain PyTorch path.

    python -m repro_torch.launch.serve --cmoe S3A3E8
    python -m repro_torch.launch.serve --smoke --cmoe S3A3E8 --device cpu
"""
from __future__ import annotations

import argparse
import re
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.config import CMoEConfig, override
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.convert import convert_dense_model
from repro_torch.core.experts import BACKENDS, microbatch_backend
from repro_torch.data import make_calibration_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build_model
from repro_torch.models.model import tree_map
from repro_torch.serving import make_sampler

# timed prefills after the warm-up one; prefill_ms is their median
PREFILL_REPEATS = 5


def parse_sxayez(tag: str) -> CMoEConfig:
    """'S3A3E8' -> CMoEConfig(num_shared=3, top_k=3, num_experts=8)."""
    m = re.fullmatch(r"[Ss](\d+)[Aa](\d+)[Ee](\d+)", tag)
    if not m:
        raise ValueError(f"bad SxAyEz tag: {tag}")
    s, a, e = map(int, m.groups())
    return CMoEConfig(num_experts=e, num_shared=s, top_k=a)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in float32")
    ap.add_argument("--cmoe", default=None, help="SxAyEz conversion tag")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--backend", default=None,
                    choices=list(BACKENDS) + ["auto", "all"],
                    help="routed-expert backend (default: phase-driven "
                         "auto, grouped prefill and gather decode); 'all' "
                         "also times decode per backend")
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="run the CUDA kernels (default: on when the device "
                         "is CUDA; on a CPU device the kernel wrappers run "
                         "their plain versions)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a "
                         "GPU unless this is 'cpu')")
    return ap


def run(argv=None) -> dict:
    """Parse, build, (convert), prefill and decode. Returns the numbers the
    CLI prints: prefill_ms (median of PREFILL_REPEATS warm prefills),
    decode_tok_s, tokens (B, gen), backends per phase, conversion seconds,
    and per-backend decode tok/s for 'all'."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 matmuls in full fp32 and bf16 matmuls summed in fp32, as the
        # reference's preferred_element_type=f32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    backend = None if args.backend in (None, "auto", "all") else args.backend
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = override(cfg, dtype="float32") if args.smoke else cfg
    use_kernel = device.type == "cuda" if args.use_kernel is None \
        else args.use_kernel
    model = build_model(cfg, use_kernel=use_kernel, backend=backend,
                        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    result: dict = {"device": str(device), "use_kernel": use_kernel}

    if args.cmoe:
        cm = parse_sxayez(args.cmoe)
        if cm.k_activation > cfg.d_ff // cm.num_experts:
            cm = CMoEConfig(num_experts=cm.num_experts,
                            num_shared=cm.num_shared, top_k=cm.top_k,
                            k_activation=max(2, cfg.d_ff // 32))
        calib = make_calibration_batch(cfg.vocab_size, 4, 128,
                                       seed=args.seed)
        calib = {"tokens": torch.as_tensor(calib["tokens"],
                                           dtype=torch.long, device=device)}
        model, params, report = convert_dense_model(model, params, calib, cm)
        _sync(device)
        result["convert_s"] = report.seconds_total
        print(f"[cmoe] converted {report.num_layers} layers ({cm.tag()}) in "
              f"{report.seconds_total:.2f}s (profile "
              f"{report.seconds_profile:.2f}s, cluster "
              f"{report.seconds_cluster:.2f}s)")

    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.long, device=device)
    max_len = args.prompt_len + args.gen
    result["backends"] = {
        "prefill": microbatch_backend(model.cfg,
                                      args.batch * args.prompt_len,
                                      "prefill", use_kernel=use_kernel,
                                      override=backend),
        "decode": microbatch_backend(model.cfg, args.batch, "decode",
                                     use_kernel=use_kernel,
                                     override=backend)}

    def run_prefill():
        """One prefill into a fresh cache. Returns ((logits, cache), s)."""
        _sync(device)
        t0 = time.perf_counter()
        out = model.prefill(params, {"tokens": prompts}, max_len=max_len)
        _sync(device)
        return out, time.perf_counter() - t0

    # an untimed prefill at the same shapes takes the first-use costs
    # (library algorithm choice, allocator growth, kernel library loads);
    # the reported time is the median of the timed ones that follow
    run_prefill()
    times = []
    for _ in range(PREFILL_REPEATS):
        (logits, cache), dt = run_prefill()
        times.append(dt)
    t_prefill = statistics.median(times)
    every_backend = args.backend == "all" and model.cfg.cmoe is not None
    # the post-prefill state each backend of 'all' decodes from
    cache0 = tree_map(torch.clone, cache) if every_backend else None
    steps = args.gen - 1      # prefill's argmax supplies the first token
    first = torch.argmax(logits, dim=-1)[:, None]

    def run_decode(m, cache, pick):
        """Warm up on the first step (an idempotent cache write), then
        `steps` timed decode steps. Returns (tokens, seconds)."""
        wl, _ = m.decode_step(params, first, cache, args.prompt_len)
        pick(wl)
        _sync(device)
        toks = [first]
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cache = m.decode_step(params, toks[-1], cache,
                                      args.prompt_len + i)
            toks.append(pick(lg)[:, None])
        _sync(device)
        return toks, time.perf_counter() - t0

    pick = make_sampler(args.temperature, args.seed, device)
    toks, t_decode = run_decode(model, cache, pick)
    out = torch.cat(toks, dim=1).cpu()
    tput = args.batch * steps / max(t_decode, 1e-9)
    result.update(prefill_ms=t_prefill * 1e3, decode_tok_s=tput,
                  decode_s=t_decode, tokens=out.tolist(),
                  prefill_logits=logits.float().cpu())
    tag = model.backend or "auto"
    print(f"prefill: {t_prefill * 1e3:.1f} ms for "
          f"{args.batch}x{args.prompt_len} tokens (median of "
          f"{PREFILL_REPEATS} after a warm-up)")
    print(f"decode[{tag}]: {tput:.1f} tok/s ({t_decode * 1e3:.1f} ms "
          f"total)")
    print(f"backends: {result['backends']}")
    print("sample:", out[0, :16].tolist())

    if every_backend:
        result["per_backend_tok_s"] = {}
        for be in BACKENDS:
            if be == "grouped_kernel" and \
                    model.cfg.activation not in ("swiglu", "geglu"):
                print(f"decode[{be}]: skipped (the kernel is glu-only)")
                continue
            m_be = build_model(model.cfg, use_kernel=use_kernel,
                               backend=be, device=device)
            _, dt = run_decode(m_be, tree_map(torch.clone, cache0),
                               make_sampler(args.temperature, args.seed,
                                            device))
            tput = args.batch * steps / max(dt, 1e-9)
            result["per_backend_tok_s"][be] = tput
            print(f"decode[{be}]: {tput:.1f} tok/s ({dt * 1e3:.1f} ms "
                  f"total)")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
