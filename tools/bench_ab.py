"""Time one family of the port's kernels for one or more checkouts of this
repository on one GPU, in one call: ``flash`` (``flash_attention``),
``ffn`` (``swiglu_ffn`` and ``moe_gmm``), ``decode`` (``flash_decode``
and ``paged_attn_decode``), ``ssd`` (``ssd_scan``), ``mla``
(``mla_paged_decode``) or ``router`` (``router_score``).

Each ROOT is a checkout (its ``src/`` holds ``repro_torch`` and it has a
``chip_smoke.py`` with ``time_ms``, ``graph_ms``, ``bound`` and
``n_sets``); each runs in a process of its own, in the order given, so that
``parent change change parent`` balances drift over the call. A process
builds the root's kernels, then times them in bfloat16 with
``chip_smoke.py``'s ``time_ms`` (CUDA events over calls that rotate through
input sets larger than L2) and, where the line says so, ``graph_ms`` (the
same calls replayed from one CUDA graph), beside the bound and a PyTorch
call or chain of the same function:

- ``flash``: llama2-7b's prefill (BH 32, S = T = 4096) at head widths 128,
  64 and 256, causal and not, against SDPA; one line each.
- ``ffn``: ``swiglu_ffn`` at the calibration forward (T 512, d 1024,
  f 2816) and at zamba2-1.2b's decode (T 4, d 2048, f 8192), and
  ``moe_gmm`` at deepseek-v2's experts (E 160, C 8, d 5120, m 1536), each
  after one call held against its plain version (max|err| / max|ref|).
- ``decode``: ``flash_decode`` at chip_smoke's FD_MAIN (llama2-7b's
  decode, BH 128, T 1100, pos 1024) and FD_LONG (T 4096) against SDPA with
  the mask kpos <= pos, and ``paged_attn_decode`` at PAGED_MAIN (qwen's
  engine decode) and PAGED_LONG (32 rows at depth 2048); one JSON line a
  root, which also gives the host time of one ``common.stream_ptr`` call
  (every wrapper makes one a launch) beside the public
  ``torch.cuda.current_stream(dev).cuda_stream``. With ``--profile`` a
  second line gives each kernel's device time per call
  (``torch.profiler``), the split-KV core's split and merge kernels apart.
  With ``--core L:S ...`` the roots are copies of the first ROOT under
  ``build/bench_ab/`` whose split-KV core (``csrc/decode_split.cuh``)
  takes chunks of L keys and rings of S tiles instead of 256 and 3.
- ``ssd``: ``ssd_scan`` at chip_smoke's SSD_MAIN (mamba2-370m's 4 x 32
  prefill), SSD_ZAMBA (zamba2-1.2b's) and SSD_LONG (2 x 2048), bf16 x, B
  and C from a float32 zero state as phase 2 times it, back to back and in
  a CUDA graph, beside the plain version and the bound (and the bound at
  the TF32 rate of the tensor-core passes the kernels run), after one call
  held against the plain version (max|err| / max|ref| of y and h_fin); one
  JSON line a root, and with ``--profile`` a second with each of the
  call's CUDA kernels' device time.
- ``mla``: ``mla_paged_decode`` in bfloat16 at chip_smoke's MLA_MAIN
  (deepseek-v2's engine decode: 4 rows, 128 heads, r 512, dr 64, depth 80)
  and MLA_LONG (32 rows at depth 2048), every row at depth, back to back
  and in a CUDA graph, beside the plain version and the bound, after one
  call held against the plain version (max|err| / max|ref|); one JSON
  line a root, and with ``--profile`` a second with each CUDA kernel's
  device time (the tensor-core route's split and merge kernels apart).
- ``router``: ``router_score`` in bfloat16 at chip_smoke's ROUTER_MAIN
  (T 512, d 1024, N_r 5) and at T 4, back to back and in a CUDA graph,
  beside the plain version, the ``torch`` chain and the bound, after one
  call held against the plain version; one JSON line a root.

    python3 tools/bench_ab.py flash build/parent . . build/parent
    python3 tools/bench_ab.py ffn build/variant . . build/variant
    python3 tools/bench_ab.py decode --profile build/parent . . build/parent
    python3 tools/bench_ab.py decode --core 128:3 256:3 512:3 256:2 256:4
    python3 tools/bench_ab.py ssd --profile build/parent . . build/parent
    python3 tools/bench_ab.py mla --profile build/parent . . build/parent
    python3 tools/bench_ab.py router build/parent . . build/parent
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

PRELUDE = r"""
import json, sys, time
import torch
import torch.nn.functional as F
import chip_smoke as cs
from repro_torch.kernels import build, ops
build.build_all()
dev = torch.device("cuda", torch.cuda.current_device())
bf = torch.bfloat16
root = sys.argv[1]
g = torch.Generator(device=dev)
g.manual_seed(0)


# device time of each CUDA kernel that fn launches, in ms per call
# (torch.profiler's CUDA activity over `calls` calls after 3 warm ones),
# keyed by the kernel's name cut to 60 characters
def kernel_ms(fn, sets, calls=20):
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
        if t_us > 0:
            per[e.key[:60]] = round(t_us / calls / 1e3, 5)
    return per
"""

FLASH = r"""
bh, s, t = 32, 4096, 4096
for d in (128, 64, 256):
    flops, nbytes = cs.attention_work(bh, s, t, d, True, 2)
    sets = [[torch.randn(shape, generator=g, device=dev).to(bf)
             for shape in ((bh, s, d), (bh, t, d), (bh, t, d))]
            for _ in range(cs.n_sets(nbytes))]
    for causal in (True, False):
        ms = cs.time_ms(lambda q, k, v: ops.flash_attention(
            q, k, v, causal=causal), sets, iters=10)
        lib = cs.time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal), sets, iters=10)
        work = flops if causal else 4.0 * bh * d * s * t
        print(f"{root}: D={d} {'causal' if causal else 'full'}: "
              f"{ms:.4f} ms ({work / ms * 1e-9:.1f} TFLOP/s), SDPA "
              f"{lib:.4f} ms, bound "
              f"{cs.bound(work, nbytes, 'bfloat16')[0]:.4f} ms", flush=True)
    del sets
"""

FFN = r"""
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.kernels.swiglu import swiglu_ffn_plain


def rnd(shape, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)


def chain(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() /
            ref.float().abs().max()).item()


for t, d, f in ((512, 1024, 2816), (4, 2048, 8192)):
    nbytes = 2 * (2 * t * d + 3 * d * f)
    sets = [[rnd((t, d)), rnd((d, f), d ** -0.5), rnd((d, f), d ** -0.5),
             rnd((f, d), f ** -0.5)] for _ in range(cs.n_sets(nbytes))]
    fn = lambda *a: ops.swiglu_ffn(*a)
    err = rel_err(fn(*sets[0]), swiglu_ffn_plain(*sets[0]))
    ms, gms = cs.time_ms(fn, sets), cs.graph_ms(fn, sets)
    lib, glib = cs.time_ms(chain, sets), cs.graph_ms(chain, sets)
    b, by = cs.bound(6 * t * d * f, nbytes, "bfloat16")
    print(f"{root}: swiglu_ffn T={t} d={d} f={f}: {ms:.4f} ms "
          f"({gms:.4f} in a graph), chain {lib:.4f} ({glib:.4f}), bound "
          f"{b:.4f} ms ({by}); err {err:.2e}", flush=True)
    del sets
e, c, d, m = 160, 8, 5120, 1536
bank = [rnd((e, d, m), d ** -0.5), rnd((e, d, m), d ** -0.5),
        rnd((e, m, d), m ** -0.5)]
sets = [[rnd((e, c, d))] + bank for _ in range(2)]
err = rel_err(ops.moe_gmm(*sets[0]), moe_gmm_plain(*sets[0]))
ms = cs.time_ms(lambda *a: ops.moe_gmm(*a), sets, iters=10)
lib = cs.time_ms(lambda x, wg, wu, wd: torch.bmm(
    F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd), sets, iters=10)
nbytes = 2 * (3 * e * d * m + 2 * e * c * d)
b, by = cs.bound(6 * e * c * d * m, nbytes, "bfloat16")
print(f"{root}: moe_gmm E={e} C={c} d={d} m={m}: {ms:.4f} ms, "
      f"bmm chain {lib:.4f} ms, bound {b:.4f} ms ({by}), "
      f"{nbytes / ms * 1e-6:.0f} GB/s; err {err:.2e}", flush=True)
"""

DECODE = r"""
from repro_torch.kernels import common


def fd_sets(shape):
    bh, t, d, pos = shape.values()
    flops, nbytes = cs.decode_work(bh, t, d, pos, 2)

    def one():
        q, k, v = [torch.randn(s, generator=g, device=dev).to(bf)
                   for s in ((bh, 1, d), (bh, t, d), (bh, t, d))]
        return [q, k, v, torch.full((1,), pos, dtype=torch.int32,
                                    device=dev),
                (torch.arange(t, device=dev) <= pos)[None]]
    return [one() for _ in range(cs.n_sets(nbytes))], \
        cs.bound(flops, nbytes, "bfloat16")[0]


def paged_sets(shape):
    def one():
        q, kp, vp, table, pos = cs.paged_case(g, dev, bf, **shape)
        return [q, kp, vp, table, pos.fill_(shape["depth"])]
    sets = [one()]
    sets += [one() for _ in range(cs.n_sets(
        sum(t.numel() * t.element_size() for t in sets[0])) - 1)]
    rows, kh, grp, hd = (shape[k] for k in ("rows", "kh", "grp", "hd"))
    live = shape["depth"] + 1
    nbytes = (2 * rows * live * kh * hd * 2 + 2 * rows * kh * grp * hd * 2
              + rows * (-(-live // shape["bs"]) + 1) * 4)
    return sets, cs.bound(4 * rows * live * kh * grp * hd, nbytes,
                          "bfloat16")[0]


def fd(q, k, v, p, keep):
    return ops.flash_decode(q, k, v, p)


def sdpa(q, k, v, p, keep):
    return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                          attn_mask=keep)


def paged(q, kp, vp, t, p):
    return ops.paged_attn_decode(q, kp, vp, table=t, pos=p,
                                 scale=cs.PAGED_MAIN["hd"] ** -0.5)


def host_us(fn, n=20000):
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


data = [(name, fns, *make(shape)) for name, fns, make, shape in (
    ("FD_MAIN", {"kernel": fd, "sdpa": sdpa}, fd_sets, cs.FD_MAIN),
    ("FD_LONG", {"kernel": fd, "sdpa": sdpa}, fd_sets, cs.FD_LONG),
    ("PAGED_MAIN", {"kernel": paged}, paged_sets, cs.PAGED_MAIN),
    ("PAGED_LONG", {"kernel": paged}, paged_sets, cs.PAGED_LONG))]
out = {"root": root, "host_us": {
    "stream_ptr": host_us(lambda: common.stream_ptr(dev)),
    "current_stream": host_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream)}}
for name, fns, sets, b_ms in data:
    rec = {}
    for what, fn in fns.items():
        pre = "" if what == "kernel" else what + "_"
        rec[pre + "ms"] = cs.time_ms(fn, sets)
        rec[pre + "graph_ms"] = cs.graph_ms(fn, sets)
    out[name] = dict(rec, bound_ms=b_ms)
print(json.dumps(out), flush=True)
if "--profile" in sys.argv[2:]:
    prof_out = {"root": root}
    for name, fns, sets, b_ms in data:
        for what, fn in fns.items():
            prof_out[f"{name} {what}"] = kernel_ms(fn, sets)
    print(json.dumps(prof_out), flush=True)
"""

SSD = r"""
from repro_torch.kernels.ssd_scan import ssd_scan_plain


def scan(*a):
    return ops.ssd_scan(*a[:6], chunk=256, h0=a[6])


def plain(*a):
    return ssd_scan_plain(*a[:6], 256, h0=a[6])


def one_set(shape):
    args = cs.ssd_case(g, dev, bf, **shape)
    args[6].zero_()
    return args


out = {"root": root}
data = []
for name in ("SSD_MAIN", "SSD_ZAMBA", "SSD_LONG"):
    shape = getattr(cs, name)
    flops, nbytes = cs.ssd_work(**shape, itemsize=2)
    tc_flops, _ = cs.ssd_work(**shape, itemsize=2,
                              passes=cs.SSD_TC_PASSES[2])
    sets = [one_set(shape) for _ in range(cs.n_sets(nbytes))]
    got, ref = scan(*sets[0]), plain(*sets[0])
    err = max(((x - r).abs().max() / r.abs().max()).item()
              for x, r in zip(got, ref))
    out[name] = dict(ms=cs.time_ms(scan, sets),
                     graph_ms=cs.graph_ms(scan, sets),
                     plain_ms=cs.time_ms(plain, sets),
                     bound_ms=cs.bound(flops, nbytes, "float32")[0],
                     tc_bound_ms=cs.bound(tc_flops, nbytes, "tf32")[0],
                     rel_err=err)
    data.append((name, sets))
print(json.dumps(out), flush=True)
if "--profile" in sys.argv[2:]:
    print(json.dumps(dict({"root": root}, **{
        name: kernel_ms(scan, sets) for name, sets in data})), flush=True)
"""

MLA = r"""
from repro_torch.kernels.paged_attention import mla_paged_decode_plain


def kernel(qa, qp, cc, cp, t, p):
    return ops.mla_paged_decode(qa, qp, cc, cp, table=t, pos=p,
                                scale=cs.MLA_SCALE)


def plain(qa, qp, cc, cp, t, p):
    return mla_paged_decode_plain(qa, qp, cc, cp, t, p, scale=cs.MLA_SCALE)


out = {"root": root}
data = []
for name in ("MLA_MAIN", "MLA_LONG"):
    shape = getattr(cs, name)

    def one():
        *ts, pos = cs.mla_case(g, dev, bf, **shape)
        return ts + [pos.fill_(shape["depth"])]
    sets = [one()]
    sets += [one() for _ in range(cs.n_sets(
        sum(t.numel() * t.element_size() for t in sets[0])) - 1)]
    rows, h, r, dr, bs = (shape[k] for k in ("rows", "heads", "r", "dr",
                                             "bs"))
    live = shape["depth"] + 1
    nbytes = (rows * live * (r + dr) * 2 + rows * h * (2 * r + dr) * 2
              + rows * (-(-live // bs) + 1) * 4)
    flops = rows * h * live * (2 * (r + dr) + 2 * r)
    got, ref = kernel(*sets[0]), plain(*sets[0])
    out[name] = dict(ms=cs.time_ms(kernel, sets),
                     graph_ms=cs.graph_ms(kernel, sets),
                     plain_ms=cs.time_ms(plain, sets),
                     bound_ms=cs.bound(flops, nbytes, "bfloat16")[0],
                     rel_err=((got.float() - ref.float()).abs().max() /
                              ref.float().abs().max()).item())
    data.append((name, sets))
print(json.dumps(out), flush=True)
if "--profile" in sys.argv[2:]:
    print(json.dumps(dict({"root": root}, **{
        name: kernel_ms(kernel, sets) for name, sets in data})), flush=True)
"""

ROUTER = r"""
from repro_torch.kernels.router_score import router_score_plain


def kernel(x, wg, wu):
    return ops.router_score(x, wg, wu)


def chain(x, wg, wu):
    return F.silu((x @ wg).float()) * (x @ wu).float()


out = {"root": root}
_, d, nr = cs.ROUTER_MAIN
for t in (cs.ROUTER_MAIN[0], 4):
    nbytes = 2 * t * d + 2 * 2 * d * nr + 4 * t * nr

    def one():
        x = torch.randn((t, d), generator=g, device=dev).to(bf)
        return [x] + [(torch.randn((d, nr), generator=g, device=dev) *
                       d ** -0.5).to(bf) for _ in range(2)]
    sets = [one() for _ in range(cs.n_sets(nbytes))]
    got, ref = kernel(*sets[0]), router_score_plain(*sets[0])
    out[f"T={t} d={d} N_r={nr}"] = dict(
        ms=cs.time_ms(kernel, sets), graph_ms=cs.graph_ms(kernel, sets),
        plain_ms=cs.time_ms(router_score_plain, sets),
        chain_ms=cs.time_ms(chain, sets),
        chain_graph_ms=cs.graph_ms(chain, sets),
        bound_ms=cs.bound(4 * t * d * nr, nbytes, "bfloat16")[0],
        rel_err=((got - ref).abs().max() / ref.abs().max()).item())
print(json.dumps(out), flush=True)
"""

BENCHES = {"flash": FLASH, "ffn": FFN, "decode": DECODE, "ssd": SSD,
           "mla": MLA, "router": ROUTER}

CORE = "src/repro_torch/kernels/csrc/decode_split.cuh"
COMMON = "src/repro_torch/kernels/common.py"


def core_copy(root: str, chunk: int, stages: int) -> str:
    """A copy of `root`'s src/ and chip_smoke.py under build/bench_ab/
    whose split-KV core takes chunks of `chunk` keys and rings of `stages`
    tiles; the path of the copy."""
    dst = Path(root, "build", "bench_ab", f"core-{chunk}-{stages}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(Path(root, "src"), dst / "src",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(Path(root, "chip_smoke.py"), dst)
    for rel, subs in ((CORE, {"constexpr int kChunk = 256;":
                              f"constexpr int kChunk = {chunk};",
                              "constexpr int kStages = 3;":
                              f"constexpr int kStages = {stages};"}),
                      (COMMON, {"DECODE_CHUNK = 256":
                                f"DECODE_CHUNK = {chunk}"})):
        path = dst / rel
        text = path.read_text()
        for old, new in subs.items():
            if text.count(old) != 1:
                raise SystemExit(f"{rel}: expected one '{old}'")
            text = text.replace(old, new)
        path.write_text(text)
    return str(dst)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bench", choices=sorted(BENCHES))
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--profile", action="store_true",
                    help="decode, ssd, mla: also print each kernel's "
                         "device time per call (torch.profiler) for every "
                         "root")
    ap.add_argument("--core", nargs="+", metavar="L:S",
                    help="decode: time copies of the first root whose core "
                         "takes chunks of L keys (a multiple of 64) and "
                         "rings of S tiles (2 or more)")
    args = ap.parse_intermixed_args(argv)
    if args.profile and args.bench not in ("decode", "ssd", "mla"):
        ap.error("--profile belongs to the decode, ssd and mla benches")
    if args.core and args.bench != "decode":
        ap.error("--core belongs to the decode bench")
    roots = args.roots
    if args.core:
        roots = [core_copy(args.roots[0], *map(int, v.split(":")))
                 for v in args.core]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    child = PRELUDE + BENCHES[args.bench]
    for root in roots:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.abspath(root), "src"))
        subprocess.run([sys.executable, "-c", child, root,
                        *(["--profile"] if args.profile else [])],
                       cwd=os.path.abspath(root), env=env, check=True,
                       timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
