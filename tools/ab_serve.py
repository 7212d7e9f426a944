"""Compare the qwen1.5-0.5b serving paths of two (or more) checkouts of this
repository on one GPU, in one call, so that the card and its power limit
are the same for each.

Each ROOT is a checkout (its ``src/`` holds ``repro_torch``); each is run in
a process of its own, in the order given, so that ``parent change change
parent`` balances drift over the call. A process serves qwen1.5-0.5b at
full width, converted to CMoE S3A3E8, through ``repro_torch.launch.serve``:
the static mode (4 x 32 prefill, 16 generated) and the paged overlapped
engine (8 requests, as ``chip_smoke.py`` phase 4 runs it, without its
parity replays). It prints one JSON line per root with conversion seconds,
prefill ms, decode tok/s, and the engine's wall, goodput, TTFT and TPOT.
With ``--arch ARCH`` it serves that arch instead, unconverted and in the
static mode only (4 x 32 prefill, 16 generated), as ``chip_smoke.py``
phase 6 serves mamba2-370m and zamba2-1.2b, and prints its prefill ms and
decode tok/s; ``--layers N`` cuts its depth to N layers, as ``chip_smoke.py``
phase 5b cuts deepseek-v2-236b to 4 to fit one card. ``--engine`` (with
``--arch``) serves that arch through the paged overlapped engine instead,
unconverted, with phase 4's requests, as ``chip_smoke.py`` phase 5c serves
deepseek-v2-236b (the only end-to-end path of ``mla_paged_decode``), and
prints the engine's wall, goodput, TTFT and TPOT.

    python3 tools/ab_serve.py build/parent . . build/parent
    python3 tools/ab_serve.py --arch zamba2-1.2b build/parent . . build/parent
    python3 tools/ab_serve.py --arch deepseek-v2-236b --layers 4 \
        build/parent . . build/parent
    python3 tools/ab_serve.py --arch deepseek-v2-236b --layers 4 --engine \
        build/parent . . build/parent
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

STATIC = ["--arch", "qwen1.5-0.5b", "--cmoe", "S3A3E8", "--batch", "4",
          "--prompt-len", "32", "--gen", "16", "--seed", "0"]
ENGINE = ["--arch", "qwen1.5-0.5b", "--cmoe", "S3A3E8", "--continuous",
          "--paged", "--batch", "4", "--requests", "8", "--rate", "0.5",
          "--prompt-len", "64", "--gen", "16", "--max-prefill-tokens", "32",
          "--block-size", "16", "--seed", "0"]

CHILD = r"""
import contextlib, io, json, sys
from repro_torch.launch import serve
static, engine = json.loads(sys.argv[1])
with contextlib.redirect_stdout(io.StringIO()):
    s = serve.run(static) if static else None
    e = serve.run(engine) if engine else None
if e is None:
    print(json.dumps({"prefill_ms": s["prefill_ms"],
                      "decode_tok_s": s["decode_tok_s"]}))
    raise SystemExit(0)
rep = e["report"]
row = {} if s is None else {
    "convert_s": s["convert_s"], "prefill_ms": s["prefill_ms"],
    "decode_tok_s": s["decode_tok_s"]}
print(json.dumps({
    **row, "engine_convert_s": e.get("convert_s"),
    "engine_wall_s": rep.wall_s,
    "goodput_tok_s": rep.goodput,
    "ttft_p50_ms": rep.ttft_p50_s * 1e3, "ttft_p95_ms": rep.ttft_p95_s * 1e3,
    "tpot_p50_ms": rep.tpot_p50_s * 1e3, "tpot_p95_ms": rep.tpot_p95_s * 1e3,
    "dropped_pairs": rep.dropped_pairs}))
"""


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", help="serve this arch unconverted, static "
                                   "mode only unless --engine")
    ap.add_argument("--layers", type=int,
                    help="cut the arch to this many layers (with --arch)")
    ap.add_argument("--engine", action="store_true",
                    help="with --arch: serve it through the engine only")
    ap.add_argument("roots", nargs="+", help="checkouts, run in this order")
    args = ap.parse_args(argv)
    static, engine, roots = STATIC, ENGINE, args.roots
    if args.arch:
        cut = ["--layers", str(args.layers)] if args.layers else []
        static = ["--arch", args.arch] + STATIC[STATIC.index("--batch"):] + \
            cut
        engine = None
        if args.engine:
            static = None
            engine = ["--arch", args.arch] + cut + \
                ENGINE[ENGINE.index("--continuous"):]
    elif args.layers or args.engine:
        ap.error("--layers and --engine need --arch")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(out)
    for root in roots:
        src = os.path.join(os.path.abspath(root), "src")
        env = dict(os.environ, PYTHONPATH=src)
        res = subprocess.run([sys.executable, "-c", CHILD,
                              json.dumps([static, engine])], env=env,
                             capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"{root}: exit code {res.returncode}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"root": root, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
