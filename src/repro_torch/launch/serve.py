"""Serving CLI: build a model from a seed (a dense decoder, optionally
converted to CMoE on a synthetic calibration batch, llama4's interleaved
dense / GQA-MoE stack or deepseek-v2's MLA + pretrained MoE, each as it
stands or hierarchically converted, or a Mamba2 / zamba2 model), then
serve. Port of ``repro/launch/serve.py``.

Static mode (default): one prefill and a greedy (or temperature) decode
loop. ``--continuous``: the continuous-batching engine
(``repro_torch.serving``) on a staggered-arrival mixed-length request set,
overlapped by default (``--no-overlap`` for the sequential loop), with
chunked prefill (``--max-prefill-tokens``), the paged block pool
(``--paged``), prefix reuse, priority preemption, activation tiers and
``--parity`` replays that assert token-identical streams.

Runs on the GPU (``cuda``) unless ``--device cpu`` is given, and raises when
no GPU is present and the CPU was not asked for. ``--use-kernel`` defaults
to on exactly on CUDA; ``--no-use-kernel`` runs the plain PyTorch path.
``--layers N`` cuts the depth (widths stay as published) so that a large
arch fits one card; llama4's must stay a whole number of periods (one
dense and one MoE layer). ``--cmoe`` on an MoE arch converts it
hierarchically (``core.hierarchical``: each routed expert split into
shared and routed sub-experts), after the ``--layers`` cut; the ``--smoke --continuous``
default (``--cmoe S2A2E8``) does so too, and ``--tier`` then sets the
sub-level k.
The VLM arch (internvl2-26b) is served text-only, as in the reference.
The SSM and hybrid archs (mamba2-370m, zamba2-1.2b) serve statically only,
as in the reference: ``--cmoe`` (conversion does not apply to them) and
``--continuous`` (the engine needs a positional KV cache) are refused.
whisper-small (the enc-dec family) is refused on every path: its batches
need frame embeddings, which this CLI's token-only batches lack (the
reference's CLI fails on them too), and the engine refuses the family; the
model's entry points run and convert it.

    python -m repro_torch.launch.serve --cmoe S3A3E8
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 4
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --layers 2 \
        --cmoe S3A3E8
    python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b \
        --layers 2 --cmoe S3A3E8 --continuous --paged --parity
    python -m repro_torch.launch.serve --arch phi3-medium-14b --cmoe S3A3E8
    python -m repro_torch.launch.serve --arch granite-34b --layers 8 \
        --cmoe S3A3E8 --continuous --paged --parity
    python -m repro_torch.launch.serve --arch mamba2-370m
    python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu
    python -m repro_torch.launch.serve --smoke --cmoe S3A3E8 --device cpu
    python -m repro_torch.launch.serve --smoke --continuous --paged \
        --parity --device cpu
    python -m repro_torch.launch.serve --cmoe S3A3E8 --continuous --paged \
        --batch 4 --requests 8 --prompt-len 64 --gen 16 \
        --max-prefill-tokens 32 --parity
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
from repro_torch.core.convert import check_convertible, convert_dense_model
from repro_torch.core.experts import BACKENDS, microbatch_backend
from repro_torch.core.hierarchical import convert_moe_model
from repro_torch.data import make_calibration_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build_model
from repro_torch.models.blocks import block_kind
from repro_torch.models.model import tree_map
from repro_torch.serving import ServingEngine, make_requests, make_sampler
from repro_torch.serving.engine import check_servable

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


def _note_peak(result: dict, device: torch.device, stage: str) -> None:
    """On CUDA, record and print the device's peak allocation so far (since
    the caller's last ``reset_peak_memory_stats``) after `stage`."""
    if device.type != "cuda":
        return
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    result.setdefault("peak_gb", {})[stage] = peak
    print(f"[memory] peak {peak:.2f} GB after {stage}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config, in float32")
    ap.add_argument("--cmoe", default=None, help="SxAyEz conversion tag")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to N layers (its widths stay "
                         "as published)")
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
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching engine: staggered arrivals, "
                         "mixed lengths, slot recycling")
    ap.add_argument("--requests", type=int, default=8,
                    help="[--continuous] number of requests")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="[--continuous] Poisson arrival rate (requests "
                         "per engine step; 0 = all at once)")
    ap.add_argument("--max-prefill-tokens", type=int, default=None,
                    help="[--continuous] per-step prefill token budget "
                         "(longer prompts are chunked across steps)")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="capacity factor of the sharded dispatch policy "
                         "(not ported yet: raises)")
    ap.add_argument("--paged", action="store_true",
                    help="[--continuous] paged KV cache: a block pool with "
                         "per-request block tables; admission is gated on "
                         "pool headroom")
    ap.add_argument("--block-size", type=int, default=16,
                    help="[--paged] tokens per cache block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="[--paged] pool size in blocks (default: the "
                         "contiguous cache's token capacity)")
    ap.add_argument("--prefix-reuse", action="store_true",
                    help="[--paged] content-addressed prefix sharing "
                         "(token-identical to reuse off)")
    ap.add_argument("--prefix-groups", default=None,
                    help="[--continuous] comma list of shared system-"
                         "prompt lengths cycled over requests, e.g. '24'")
    ap.add_argument("--priority", default=None,
                    help="[--continuous] comma list of priority classes "
                         "cycled over requests, e.g. '0,1'")
    ap.add_argument("--expect-preemption", action="store_true",
                    help="assert at least one lane was preempted and every "
                         "request still completed")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="[--continuous] overlapped engine: one fused "
                         "dispatch per step, on-device sampling, readback "
                         "one step late (default on)")
    ap.add_argument("--tier", default=None,
                    help="[--continuous] per-request activation tier(s), "
                         "an int or a comma list cycled over requests, "
                         "e.g. '1,default' (needs --cmoe)")
    ap.add_argument("--parity", action="store_true",
                    help="[--continuous] replay the requests on the other "
                         "axes (sequential, contiguous, unchunked, reuse "
                         "off, unpressured) and assert identical streams "
                         "and zero dropped pairs")
    return ap


def run(argv=None) -> dict:
    """Parse, build, (convert), prefill and decode. Returns the numbers the
    CLI prints: prefill_ms (median of PREFILL_REPEATS warm prefills),
    decode_tok_s, tokens (B, gen), backends per phase, conversion seconds,
    and per-backend decode tok/s for 'all'; and the served (converted)
    model and params, so a caller can run them further without converting
    again. In --continuous mode, serve_continuous's dict instead. On CUDA
    also peak_gb: the device's peak allocation after init, conversion and
    serving."""
    args = parser().parse_args(argv)
    if args.capacity_factor is not None:
        raise NotImplementedError(
            "--capacity-factor feeds the sharded dispatch policy "
            "(repro.distributed.policy), which is not ported yet")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # the reference's refusals of the SSM and hybrid families, before
    # anything is built (and before the smoke engine's implicit --cmoe)
    if args.continuous:
        check_servable(cfg, block_kind(cfg))
    if args.cmoe:
        check_convertible(cfg)
    if cfg.family == "audio":
        # the reference's CLI fails here with KeyError: 'frames'
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder, whose batches need 'frames' "
            f"(precomputed frame embeddings) beside the tokens; this CLI "
            f"builds token-only batches (the static prompts and the --cmoe "
            f"calibration batch), as the reference's does. Drive it through "
            f"the model's entry points (Model.forward, prefill, decode_step; "
            f"core.convert.convert_dense_model) with a batch that carries "
            f"frames")
    if args.continuous and args.smoke and not args.cmoe:
        # exercise the per-micro-batch backend policy: without routed
        # experts there is nothing for the phase split to select
        args.cmoe = "S2A2E8"
        print("[continuous] defaulting --cmoe S2A2E8 (smoke)")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 matmuls in full fp32 and bf16 matmuls summed in fp32, as the
        # reference's preferred_element_type=f32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    backend = None if args.backend in (None, "auto", "all") else args.backend
    cfg = override(cfg, dtype="float32") if args.smoke else cfg
    if args.layers is not None:
        print(f"[layers] depth cut from {cfg.num_layers} to {args.layers} "
              f"layers; widths as published (d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads, vocab {cfg.vocab_size})")
        cfg = override(cfg, num_layers=args.layers)
    use_kernel = device.type == "cuda" if args.use_kernel is None \
        else args.use_kernel
    model = build_model(cfg, use_kernel=use_kernel, backend=backend,
                        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    result: dict = {"device": str(device), "use_kernel": use_kernel}
    _note_peak(result, device, "init")

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
        if cfg.family == "moe":
            model, params, report = convert_moe_model(model, params, calib,
                                                      cm)
        else:
            model, params, report = convert_dense_model(model, params,
                                                        calib, cm)
        _sync(device)
        _note_peak(result, device, "conversion")
        result["convert_s"] = report.seconds_total
        result["convert_profile_s"] = report.seconds_profile
        result["convert_cluster_s"] = report.seconds_cluster
        print(f"[cmoe] converted {report.num_layers} layers ({cm.tag()}) in "
              f"{report.seconds_total:.2f}s (profile "
              f"{report.seconds_profile:.2f}s, cluster "
              f"{report.seconds_cluster:.2f}s)")

    if args.continuous:
        if args.backend == "all":
            print("[continuous] note: --backend all is a static-mode "
                  "feature; the engine runs the auto phase policy")
        result.update(serve_continuous(model, params, args))
        _note_peak(result, device, "serving")
        return result

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
    every_backend = args.backend == "all" and (
        model.cfg.cmoe is not None or model.cfg.moe is not None)
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
                  prefill_logits=logits.float().cpu(), model=model,
                  params=params)
    _note_peak(result, device, "serving")
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



def serve_continuous(model, params, args) -> dict:
    """Continuous-batching mode: Poisson arrivals, per-request lengths.
    --parity replays the same requests on the OTHER axes and asserts
    token-identical streams with zero dropped pairs: under --overlap (the
    default) against a sequential run, then with --paged against a
    contiguous run, with --prefix-reuse against reuse off, with a pressured
    --priority pool against an unpressured one, or with
    --max-prefill-tokens (contiguous) against an unchunked run; every
    baseline runs overlap-off. Returns {"report", "parity" (what was
    compared, in order), "engine"}."""
    cfg = model.cfg
    if args.prefix_reuse and not args.paged:
        raise SystemExit("--prefix-reuse needs --paged: sharing is a "
                         "block-table property")
    max_len = args.prompt_len + args.gen
    tiers = None
    if args.tier:
        tiers = [None if t.strip().lower() == "default" else int(t)
                 for t in args.tier.split(",")]
        if cfg.cmoe is None:
            raise SystemExit("--tier needs a CMoE-routed model (--cmoe)")
    k_max = cfg.cmoe.top_k if cfg.cmoe is not None else 1
    tiered = bool(tiers) and any(t is not None and t != k_max
                                 for t in tiers)
    prefix_groups = None
    if args.prefix_groups:
        prefix_groups = [int(p) for p in args.prefix_groups.split(",")]
        # shared prefixes lengthen prompts: widen the max_len wall so
        # nothing truncates just for carrying one
        max_len += max(prefix_groups)
    priorities = None
    if args.priority:
        priorities = [int(p) for p in args.priority.split(",")]
    lo_p = min(max(4, args.prompt_len // 2), args.prompt_len)
    reqs = make_requests(args.requests, cfg.vocab_size,
                         prompt_range=(lo_p, args.prompt_len),
                         gen_range=(max(1, args.gen // 2), args.gen),
                         rate=args.rate, seed=args.seed, tiers=tiers,
                         prefix_groups=prefix_groups,
                         priorities=priorities)
    engine = ServingEngine(model, params, max_slots=args.batch,
                           max_len=max_len,
                           max_prefill_tokens=args.max_prefill_tokens,
                           temperature=args.temperature, seed=args.seed,
                           paged=args.paged, block_size=args.block_size,
                           num_blocks=args.num_blocks,
                           prefix_reuse=args.prefix_reuse,
                           overlap=args.overlap)
    report = engine.run(reqs)
    print(f"[continuous] {report.summary()}")
    assert all(r.done for r in report.requests), "unfinished requests"
    if tiers:
        for k, m in sorted(report.tier_metrics().items()):
            print(f"[continuous] tier k={k}: {m['requests']} requests, "
                  f"{m['tokens']} tokens ({m['pairs']} routed pairs), "
                  f"TTFT p50/p95 {m['ttft_p50_s'] * 1e3:.1f}/"
                  f"{m['ttft_p95_s'] * 1e3:.1f} ms, TPOT p50/p95 "
                  f"{m['tpot_p50_s'] * 1e3:.1f}/"
                  f"{m['tpot_p95_s'] * 1e3:.1f} ms")
    if args.paged:
        kv = engine.kv
        print(f"[continuous] paged pool: {kv.num_blocks} blocks x "
              f"{kv.block_size} tokens (+1 trash), peak occupancy "
              f"{report.peak_occupancy}/{args.batch} slots, "
              f"{report.gate_deferrals} admission deferrals "
              f"({report.deferral_causes or 'none'}), "
              f"{report.preemptions} preemptions, {report.truncated} "
              f"truncated, end-of-run audit {report.pool_audit}")
    if args.prefix_reuse:
        print(f"[continuous] prefix reuse: hit-rate "
              f"{report.prefix_hit_rate * 100:.0f}% "
              f"({report.prefix_matched_tokens}/"
              f"{report.prefix_prompt_tokens} prefill tokens skipped, "
              f"{report.prefix_hits} hits), {report.reused_blocks} blocks "
              f"shared by refcount, {report.cow_copies} copy-on-write "
              f"tails")
    if args.expect_preemption:
        assert report.preemptions > 0, (
            "--expect-preemption: no lane was preempted")
        print(f"[continuous] preemption OK: {report.preemptions} "
              f"evictions, every request (victims included) completed")
    parity = []
    if args.parity:
        comparisons = []   # (what, fork message, engine kwargs)
        common = dict(max_slots=args.batch, max_len=max_len,
                      temperature=args.temperature, seed=args.seed)
        if args.overlap:
            comparisons.append((
                "overlap == sequential",
                "the overlapped engine forked the generated streams",
                dict(common, max_prefill_tokens=args.max_prefill_tokens,
                     paged=args.paged, block_size=args.block_size,
                     num_blocks=args.num_blocks,
                     prefix_reuse=args.prefix_reuse, overlap=False)))
        if args.prefix_reuse:
            comparisons.append((
                "prefix reuse == no reuse",
                "prefix sharing forked the generated streams",
                dict(common, max_prefill_tokens=args.max_prefill_tokens,
                     paged=True, block_size=args.block_size,
                     num_blocks=args.num_blocks, prefix_reuse=False,
                     overlap=False)))
        if args.priority and args.paged and args.num_blocks is not None:
            comparisons.append((
                "preempted == unpressured",
                "preemption forked the generated streams",
                dict(common, max_prefill_tokens=args.max_prefill_tokens,
                     paged=True, block_size=args.block_size,
                     num_blocks=None, prefix_reuse=args.prefix_reuse,
                     overlap=False)))
        if args.paged:
            comparisons.append((
                "paged == contiguous",
                "paged and contiguous serving forked the generated "
                "streams",
                dict(common, max_prefill_tokens=args.max_prefill_tokens,
                     overlap=False)))
        elif args.max_prefill_tokens is not None:
            comparisons.append((
                "chunked == unchunked",
                "chunked and unchunked prefill forked the generated "
                "streams",
                dict(common, max_prefill_tokens=None, overlap=False)))
        if not comparisons:
            raise SystemExit("--parity needs an axis to compare: --overlap "
                             "(default), --paged, or --max-prefill-tokens")
        toks = {r.rid: tuple(r.generated) for r in report.requests}
        assert report.dropped_pairs == 0, (
            "routed pairs were dropped", report.dropped_pairs)
        for what, fork_msg, kw in comparisons:
            base = ServingEngine(model, params, **kw).run(reqs)
            toks_base = {r.rid: tuple(r.generated) for r in base.requests}
            assert toks == toks_base, fork_msg
            assert base.dropped_pairs == 0, (
                "routed pairs were dropped", base.dropped_pairs)
            parity.append(what)
            print(f"[continuous] parity OK: {what} token-for-token "
                  f"({sum(len(t) for t in toks.values())} tokens), "
                  f"0 dropped pairs in both runs")

    # the backend policy: sequential decode on gather and prefill above the
    # break-even on a grouped path; a fused step by its padded width
    # (phase "mixed"). Asserted only under the auto policy.
    bc = report.backend_counts
    has_experts = any(b != "-" for c in bc.values() for b in c)
    if has_experts and args.backend in (None, "auto", "all"):
        decode_b, prefill_b = set(bc["decode"]), set(bc["prefill"])
        if args.overlap:
            assert not prefill_b, \
                f"fused mode dispatched prefill micro-batches: {prefill_b}"
            for _, _, padded, live, backend, _, active in \
                    engine.backend_log:
                eff = (active / max(live, 1)) if tiered else None
                want = microbatch_backend(cfg, padded, "mixed",
                                          use_kernel=model.use_kernel,
                                          effective_k=eff)
                assert backend == want, \
                    f"fused width {padded} ran {backend}, policy {want}"
        else:
            grouped = {"grouped_plain", "grouped_kernel"}
            assert decode_b == {"gather"}, f"decode ran {decode_b}"
            assert prefill_b <= grouped | {"gather"} and \
                prefill_b & grouped, f"prefill ran {prefill_b}"
        print(f"[continuous] backend policy OK: prefill={sorted(prefill_b)} "
              f"decode={sorted(decode_b)}")
    if report.slot_reuse == 0 and args.requests > args.batch:
        print("[continuous] warning: no slot was recycled (arrivals too "
              "spread out?)")
    return {"report": report, "parity": parity, "engine": engine}



def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

