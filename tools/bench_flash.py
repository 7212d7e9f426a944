"""Time ``flash_attention`` of one or more checkouts of this repository on
one GPU, in one call, beside ``scaled_dot_product_attention``.

Each ROOT is a checkout (its ``src/`` holds ``repro_torch`` and it has a
``chip_smoke.py``); each runs in a process of its own, in the order given,
so that ``parent change change parent`` balances drift over the call. A
process builds the root's kernels, then times ``ops.flash_attention`` in
bfloat16 at llama2-7b's prefill (BH 32, S = T = 4096) with head widths 128,
64 and 256, causal and not, with ``chip_smoke.py``'s ``time_ms`` (CUDA
events over calls that rotate through input sets larger than L2) and its
FLOP count, beside SDPA on the same inputs, and prints one line each.

    python3 tools/bench_flash.py build/parent . . build/parent
"""
from __future__ import annotations

import os
import subprocess
import sys

CHILD = r"""
import sys
import torch
import torch.nn.functional as F
import chip_smoke as cs
from repro_torch.kernels import build, ops
build.build_all()
g = torch.Generator(device="cuda")
g.manual_seed(0)
bh, s, t = 32, 4096, 4096
for d in (128, 64, 256):
    flops, nbytes = cs.attention_work(bh, s, t, d, True, 2)
    sets = [[torch.randn(shape, generator=g, device="cuda").bfloat16()
             for shape in ((bh, s, d), (bh, t, d), (bh, t, d))]
            for _ in range(cs.n_sets(nbytes))]
    for causal in (True, False):
        ms = cs.time_ms(lambda q, k, v: ops.flash_attention(
            q, k, v, causal=causal), sets, iters=10)
        lib = cs.time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal), sets, iters=10)
        work = flops if causal else 4.0 * bh * d * s * t
        print(f"{sys.argv[1]}: D={d} {'causal' if causal else 'full'}: "
              f"{ms:.4f} ms ({work / ms * 1e-9:.1f} TFLOP/s), SDPA "
              f"{lib:.4f} ms, bound "
              f"{cs.bound(work, nbytes, 'bfloat16')[0]:.4f} ms", flush=True)
    del sets
"""


def main(argv: list[str]) -> int:
    roots = argv or ["."]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    for root in roots:
        env = dict(os.environ, PYTHONPATH=os.path.join(
            os.path.abspath(root), "src"))
        subprocess.run([sys.executable, "-c", CHILD, root],
                       cwd=os.path.abspath(root), env=env, check=True,
                       timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
