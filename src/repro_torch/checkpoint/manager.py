"""Fault-tolerant checkpointing. Port of ``repro/checkpoint/manager.py``.

Layout per step:
    <dir>/ckpt_00000123.tmp/          (written first)
        manifest.json                 (leaf paths, shapes, dtypes, extra)
        arrays.npz                    (leaf payloads, keyed by flat index)
    <dir>/ckpt_00000123/              (atomic rename == commit)

Guarantees:
  * atomic commit via rename: a crash mid-save never corrupts the latest;
  * retention of the newest ``keep`` checkpoints;
  * async save: the leaves are copied to the host in ``save``, and a
    background thread writes them unless ``block``; ``wait`` (and the next
    ``save``) joins it, so at most one save is in flight;
  * ``restore`` finds the newest COMMITTED step; ``.tmp`` dirs are ignored;
  * ``extra_state`` carries the data loader's step, so a resume replays
    the exact stream.

Leaves are flattened in the port's one fixed order (``tree_leaves``: dicts
in insertion order, tuples and NamedTuples such as ``AdamWState`` by
position), each recorded with its path. numpy has no bfloat16, so a
bfloat16 leaf is stored as its raw 16-bit pattern (int16) with
``bfloat16`` as its dtype in the manifest, and crosses back bit for bit.
``restore`` matches leaves by path and puts each on the target leaf's
device and dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.model import tree_leaves, tree_map


def _paths(tree, prefix: str = "") -> list[str]:
    """Each leaf's path, in tree_leaves order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        return [p for k, v in zip(names, tree)
                for p in _paths(v, f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _to_host(x: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf -> (host array, dtype name). bfloat16 as its int16 bits."""
    # a copy even on the CPU: the async writer must not see later writes
    t = x.detach().to("cpu", copy=True).contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy(), name


def _from_host(arr: np.ndarray, name: str, ref: torch.Tensor
               ) -> torch.Tensor:
    t = torch.from_numpy(arr)               # a fresh array from the npz
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=ref.device, dtype=ref.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: Any, extra_state: Optional[dict] = None,
             block: bool = False) -> None:
        self.wait()                                  # one in-flight save max
        host = [_to_host(x) for x in tree_leaves(tree)]
        manifest = {
            "step": int(step),
            "paths": _paths(tree),
            "num_leaves": len(host),
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [name for _, name in host],
            "extra_state": extra_state or {},
            "time": time.time(),
        }

        def _write():
            tmp = os.path.join(self.dir, f"ckpt_{step:08d}.tmp")
            final = os.path.join(self.dir, f"ckpt_{step:08d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                     # atomic commit
            self._retain()

        if not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"ckpt_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and not name.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, name,
                                                "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree: Any, step: Optional[int] = None):
        """Returns (tree, extra_state). ``target_tree`` gives the structure
        and each leaf's shape, device and dtype; leaves are matched by their
        path, so a tree whose dicts were built in another order (a
        converted model's ``init`` against its conversion) restores too."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"ckpt_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        paths = _paths(target_tree)
        index = {p: i for i, p in enumerate(manifest["paths"])}
        if sorted(paths) != sorted(index):
            raise ValueError(
                f"checkpoint {path} holds leaves "
                f"{sorted(set(index) ^ set(paths))[:8]} that the target "
                f"lacks, or lacks the target's")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            it = iter(paths)

            def load(ref):
                i = index[next(it)]
                if list(ref.shape) != manifest["shapes"][i]:
                    raise ValueError(f"{manifest['paths'][i]}: stored "
                                     f"{manifest['shapes'][i]}, target "
                                     f"{list(ref.shape)}")
                return _from_host(data[f"leaf_{i}"], manifest["dtypes"][i],
                                  ref)

            tree = tree_map(load, target_tree)
        return tree, manifest["extra_state"]
