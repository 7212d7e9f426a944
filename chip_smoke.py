#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # phases 1-2: build, check, time

Phases (any failure raises and exits nonzero; no phase catches its own):
  1. device and build: the card's name and power limit (nvidia-smi), then
     the CUDA kernels built from ``src/repro_torch/kernels/csrc`` with nvcc;
  2. each kernel against its plain PyTorch version on the card at the shapes
     of the convert-and-serve path, in float32 (|err| <= 1e-4 max|ref|) and
     bfloat16 (|err| <= 2e-2 max|ref|; sentinel rows of moe_gather exactly
     zero), then timed with CUDA events in bfloat16 beside its plain
     version, a PyTorch yardstick (library_ms) and its bound on the card;
  3. end to end at the full width of qwen1.5-0.5b (24 layers, seeded random
     weights): (a) in float32 the kernel path against the plain path on one
     converted model (prefill logits within 1e-3 max|logit|, greedy tokens
     compared), (b) the main path in bfloat16 through the serving CLI's
     entry point (convert S3A3E8, prefill 4 x 32, decode 16 tokens), with
     every kernel's launch count zeroed just before and read just after.
Prints the kernels JSON line, then ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 FMA
# outside them, and HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

ARCH = "qwen1.5-0.5b"
CMOE = "S3A3E8"
BATCH, PROMPT, GEN = 4, 32, 16
CALIB_ROWS = 4 * 128
L2_BYTES = 50e6


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, inputs: list, iters: int = 50) -> float:
    """Mean ms per call with CUDA events. Calls rotate over `inputs` (sets
    whose bytes together exceed L2), so each call finds its operands cold,
    as the next layer's call does on the main path."""
    import torch
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, got, ref, dtype, sentinel_rows=None) -> float:
    """Kernel against plain on the same inputs; returns max |err|."""
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else 2e-2) * max(scale, 1e-30)
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{name} {dtype}: max|err| {err:.3e} > "
                             f"{tol:.3e} (max|ref| {scale:.3e})")
    if sentinel_rows is not None and got[sentinel_rows].abs().max() != 0:
        raise AssertionError(f"{name}: sentinel rows are not exactly zero")
    print(f"[check] {name} {str(dtype).split('.')[-1]}: max|err| {err:.3e} "
          f"(tol {tol:.3e})")
    return err


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def n_sets(nbytes: float) -> int:
    return max(2, min(16, math.ceil(2 * L2_BYTES / nbytes)))


def kernel_phase() -> dict:
    """Phase 2. Returns per-kernel records. Their launches stay None (no
    count was taken) until phase 3b fills them from the main path's run."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.experts import ragged_layout, ragged_scatter
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_gather import moe_gather_plain
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged_plain
    from repro_torch.kernels.swiglu import swiglu_ffn_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    d, f = 1024, 2816
    n_e, m, top_k = 5, f // 8, 3
    block = ops.ragged_block_c()

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def swiglu_set(dtype):
        return [rnd((CALIB_ROWS, d), dtype), rnd((d, f), dtype, d ** -0.5),
                rnd((d, f), dtype, d ** -0.5), rnd((f, d), dtype, f ** -0.5)]

    def banks(dtype):
        return [rnd((n_e, d, m), dtype, d ** -0.5),
                rnd((n_e, d, m), dtype, d ** -0.5),
                rnd((n_e, m, d), dtype, m ** -0.5)]

    def gmm_set(dtype):
        t = BATCH * PROMPT
        ids = torch.randint(0, n_e, (t * top_k,), generator=g, device=dev)
        slot, owner, _, p_total = ragged_layout(ids, n_e, block)
        xp = ragged_scatter(rnd((t, d), dtype), top_k, slot, p_total)
        return [xp, owner] + banks(dtype)

    def gather_set(dtype, sentinels=False):
        ids = torch.randint(0, n_e, (BATCH * top_k,), generator=g,
                            device=dev).to(torch.int32)
        if sentinels:
            ids[1::4] = n_e
        return [rnd((BATCH, d), dtype), ids] + banks(dtype)

    records = {}
    act = "swiglu"

    # --- swiglu_ffn: the dense FFN of the calibration forward (T = 512)
    for dt in (torch.float32, torch.bfloat16):
        x, wg, wu, wd = swiglu_set(dt)
        err = check("swiglu_ffn", ops.swiglu_ffn(x, wg, wu, wd),
                    swiglu_ffn_plain(x, wg, wu, wd, act), dt)
    nbytes = 2 * (2 * CALIB_ROWS * d + 3 * d * f)
    sets = [swiglu_set(torch.bfloat16) for _ in range(n_sets(nbytes))]
    ms = time_ms(lambda x, wg, wu, wd: ops.swiglu_ffn(x, wg, wu, wd), sets)
    plain_ms = time_ms(lambda *a: swiglu_ffn_plain(*a, act), sets)
    lib_ms = time_ms(lambda x, wg, wu, wd: (F.silu(x @ wg) * (x @ wu)) @ wd,
                     sets)
    b_ms, b_by = bound(6 * CALIB_ROWS * d * f, nbytes, "bfloat16")
    records["swiglu_ffn"] = dict(
        name="swiglu_ffn", route="cuda",
        source="src/repro_torch/kernels/csrc/swiglu.cu",
        replaces="src/repro/kernels/swiglu.py:55", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, dtype="bfloat16",
        shape=f"T={CALIB_ROWS} d={d} f={f}")

    # --- moe_gmm_ragged: routed experts at prefill (4 x 32 tokens, top-3)
    for dt in (torch.float32, torch.bfloat16):
        xp, owner, wg, wu, wd = gmm_set(dt)
        err = check("moe_gmm_ragged",
                    ops.moe_gmm_ragged(xp, owner, wg, wu, wd, block_c=block),
                    moe_gmm_ragged_plain(xp, owner, wg, wu, wd, act, block),
                    dt)
    live = BATCH * PROMPT * top_k
    nbytes = 2 * (3 * n_e * d * m + 2 * live * d)
    sets = [gmm_set(torch.bfloat16) for _ in range(n_sets(nbytes))]
    ms = time_ms(lambda xp, o, wg, wu, wd: ops.moe_gmm_ragged(
        xp, o, wg, wu, wd, block_c=block), sets)
    plain_ms = time_ms(lambda xp, o, wg, wu, wd: moe_gmm_ragged_plain(
        xp, o, wg, wu, wd, act, block), sets)

    def gmm_library(xp, o, wg, wu, wd):
        own = o.long()
        xb = xp.reshape(-1, block, d)
        h = F.silu(torch.bmm(xb, wg[own])) * torch.bmm(xb, wu[own])
        return torch.bmm(h, wd[own])

    lib_ms = time_ms(gmm_library, sets)
    b_ms, b_by = bound(6 * live * d * m, nbytes, "bfloat16")
    records["moe_gmm_ragged"] = dict(
        name="moe_gmm_ragged", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:124", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, dtype="bfloat16",
        shape=f"P={xp.shape[0]} live rows={live} E={n_e} d={d} m={m} "
              f"block_c={block}")

    # --- moe_gather: routed experts at decode (4 tokens, top-3)
    for dt in (torch.float32, torch.bfloat16):
        xf, ids, wg, wu, wd = gather_set(dt, sentinels=True)
        err = check("moe_gather",
                    ops.moe_gather(xf, ids, wg, wu, wd, top_k=top_k),
                    moe_gather_plain(xf, ids, wg, wu, wd, top_k=top_k),
                    dt, sentinel_rows=ids == n_e)
    sets = [gather_set(torch.bfloat16) for _ in range(16)]
    distinct = sum(len(set(s[1].tolist())) for s in sets) / len(sets)
    nbytes = 2 * (3 * distinct * d * m + BATCH * d + BATCH * top_k * d)
    sets = sets[:n_sets(nbytes)]
    ms = time_ms(lambda xf, i, wg, wu, wd: ops.moe_gather(
        xf, i, wg, wu, wd, top_k=top_k), sets)
    plain_ms = time_ms(lambda xf, i, wg, wu, wd: moe_gather_plain(
        xf, i, wg, wu, wd, top_k=top_k), sets)

    def gather_library(xf, i, wg, wu, wd):
        ids = i.long()
        xr = xf.repeat_interleave(top_k, dim=0)[:, None]
        h = F.silu(torch.bmm(xr, wg[ids])) * torch.bmm(xr, wu[ids])
        return torch.bmm(h, wd[ids])[:, 0]

    lib_ms = time_ms(gather_library, sets)
    b_ms, b_by = bound(6 * BATCH * top_k * d * m, nbytes, "bfloat16")
    records["moe_gather"] = dict(
        name="moe_gather", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gather.cu",
        replaces="src/repro/kernels/moe_gather.py:100", launches=None,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, dtype="bfloat16",
        shape=f"rows={BATCH * top_k} E={n_e} d={d} m={m} "
              f"distinct experts~{distinct:.2f}")
    for r in records.values():
        print(f"[time] {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}"
              f" ms, {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms")
    return records


def f32_agreement() -> None:
    """Phase 3a: kernel path vs plain path on one converted f32 model."""
    import numpy as np
    import torch

    from repro_torch.config import CMoEConfig, override
    from repro_torch.configs import get_config
    from repro_torch.core.convert import convert_dense_model
    from repro_torch.data import make_calibration_batch
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    cfg = override(get_config(ARCH), dtype="float32")
    model = build_model(cfg, use_kernel=True, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    calib = make_calibration_batch(cfg.vocab_size, 4, 128, seed=0)
    calib = {"tokens": torch.as_tensor(calib["tokens"], dtype=torch.long,
                                       device=dev)}
    cm = CMoEConfig(num_experts=8, num_shared=3, top_k=3)
    t0 = time.perf_counter()
    k_model, cparams, report = convert_dense_model(model, params, calib, cm)
    torch.cuda.synchronize()
    print(f"[e2e f32] converted {report.num_layers} layers ({cm.tag()}) in "
          f"{time.perf_counter() - t0:.2f} s")
    p_model = build_model(k_model.cfg, use_kernel=False, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (BATCH, PROMPT)),
                              dtype=torch.long, device=dev)
    toks = {}
    for tag, m in (("kernel", k_model), ("plain", p_model)):
        logits, cache = m.prefill(cparams, {"tokens": prompts},
                                  max_len=PROMPT + GEN)
        seq = [torch.argmax(logits, -1)]
        for i in range(GEN - 1):
            lg, cache = m.decode_step(cparams, seq[-1][:, None], cache,
                                      PROMPT + i)
            seq.append(torch.argmax(lg, -1))
        toks[tag] = (logits.float(), torch.stack(seq, 1).cpu())
    lk, lp = toks["kernel"][0], toks["plain"][0]
    err = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    agree = int((toks["kernel"][1] == toks["plain"][1]).sum())
    print(f"[e2e f32] prefill logits max|kernel - plain| {err:.3e} "
          f"(max|logit| {scale:.3e}, tol {1e-3 * scale:.3e}); greedy "
          f"tokens agree {agree}/{BATCH * GEN}")
    if not (torch.isfinite(lk).all() and err <= 1e-3 * scale):
        raise AssertionError("f32 kernel path disagrees with the plain path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build, check and time); the "
                         "kernels line then has launches null")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve

    # phase 1: device and build
    smi = nvidia_smi()
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"[build] {len(seconds)} kernels built in "
          f"{time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")

    # phase 2: kernels against their plain versions, then timed
    records = kernel_phase()
    if args.kernels_only:
        print(smi)
        print(json.dumps({"kernels": list(records.values())}))
        return 0

    # phase 3a: f32 kernel path vs plain path at full width
    f32_agreement()

    # phase 3b: the main path, bf16, through the serving CLI's entry point
    torch.cuda.synchronize()
    ops.reset_launches()
    res = serve.run(["--arch", ARCH, "--cmoe", CMOE, "--batch", str(BATCH),
                     "--prompt-len", str(PROMPT), "--gen", str(GEN),
                     "--seed", "0"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    toks = torch.as_tensor(res["tokens"])
    from repro_torch.configs import get_config
    vocab = get_config(ARCH).vocab_size
    if toks.shape != (BATCH, GEN) or toks.min() < 0 or toks.max() >= vocab \
            or not torch.isfinite(res["prefill_logits"]).all():
        raise AssertionError(f"bad serve output: tokens {tuple(toks.shape)}")
    if res["backends"] != {"prefill": "grouped_kernel", "decode": "gather"}:
        raise AssertionError(f"backends per phase: {res['backends']}")
    print(f"[e2e bf16] convert {res['convert_s']:.2f} s, prefill "
          f"{res['prefill_ms']:.2f} ms ({BATCH}x{PROMPT}, median of "
          f"{serve.PREFILL_REPEATS} warm), decode "
          f"{res['decode_tok_s']:.1f} tok/s ({BATCH} lanes, {GEN - 1} "
          f"steps), launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
        records[name]["launches"] = n

    print(smi)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
