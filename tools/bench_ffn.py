"""Time ``swiglu_ffn`` and ``moe_gmm`` of one or more checkouts of this
repository on one GPU, in one call, beside the PyTorch chains of the same
products.

Each ROOT is a checkout (its ``src/`` holds ``repro_torch`` and it has a
``chip_smoke.py`` with ``time_ms`` and ``graph_ms``); each runs in a
process of its own, in the order given, so that ``a b b a`` balances drift
over the call. A process builds the root's kernels, then times in bfloat16,
with ``chip_smoke.py``'s ``time_ms`` (CUDA events over calls that rotate
through input sets larger than L2) and ``graph_ms`` (the same calls
replayed from one CUDA graph), after holding one call against the plain
version (max|err| / max|ref|):
``swiglu_ffn`` at the calibration forward (T 512, d 1024, f 2816) and at
zamba2-1.2b's decode (T 4, d 2048, f 8192), and ``moe_gmm`` at
deepseek-v2's experts (E 160, C 8, d 5120, m 1536), each beside its chain
and its bound, one line each.

    python3 tools/bench_ffn.py build/variant . . build/variant
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
from repro_torch.kernels.moe_gmm import moe_gmm_plain
from repro_torch.kernels.swiglu import swiglu_ffn_plain
build.build_all()
g = torch.Generator(device="cuda")
g.manual_seed(0)
bf = torch.bfloat16


def rnd(shape, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)


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
    print(f"{sys.argv[1]}: swiglu_ffn T={t} d={d} f={f}: {ms:.4f} ms "
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
print(f"{sys.argv[1]}: moe_gmm E={e} C={c} d={d} m={m}: {ms:.4f} ms, "
      f"bmm chain {lib:.4f} ms, bound {b:.4f} ms ({by}), "
      f"{nbytes / ms * 1e-6:.0f} GB/s; err {err:.2e}", flush=True)
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
