"""Peak device memory of initialising llama4-maverick-400b-a17b at its
published widths, bfloat16, cut to one period (a dense and an MoE layer),
on one GPU.

It prints, each after ``torch.cuda.reset_peak_memory_stats()`` on an
emptied card:

  * ``Model.init`` of the 2-layer model (what ``repro_torch.launch.serve``
    runs);
  * the MoE layer alone through ``init_stacked(make, 1)``, which gives a
    single draw its leading axis as a view;
  * the same draw stacked the way ``init_stacked`` stacked every count
    before it had a case for one draw: a new (1, ...) stack of each leaf,
    and the draw copied into it.

    python3 tools/init_peak.py
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "llama4-maverick-400b-a17b"


def stack_by_copy(make, n: int):
    """Stack n draws of ``make()`` into new (n, ...) leaves, copying each
    draw in."""
    from repro_torch.models.model import tree_map

    def place(stacked, tree, i):
        if isinstance(stacked, dict):
            for k in stacked:
                place(stacked[k], tree[k], i)
        else:
            stacked[i] = tree

    first = make()
    stacked = tree_map(lambda a: a.new_empty((n, *a.shape)), first)
    place(stacked, first, 0)
    del first
    for i in range(1, n):
        place(stacked, make(), i)
    return stacked


def peak_gb(fn) -> float:
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("init_peak: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.config import override
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.blocks import init_moe_block
    from repro_torch.models.model import init_stacked, torch_dtype

    cfg = override(get_config(ARCH), num_layers=2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    def make():
        return init_moe_block(cfg, torch_dtype(cfg), dev, gen)

    model = build_model(cfg, device=dev)
    out = {"arch": ARCH, "layers": 2, "dtype": cfg.dtype,
           "model_init_gb": peak_gb(lambda: model.init(gen.manual_seed(0))),
           "moe_layer_view_gb": peak_gb(lambda: init_stacked(make, 1)),
           "moe_layer_copy_gb": peak_gb(lambda: stack_by_copy(make, 1))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
