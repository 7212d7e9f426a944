"""Synthetic serving workloads: Poisson arrivals, mixed request lengths."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.serving.request import Request


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """n arrival times (engine steps, float) of a Poisson process with
    `rate` arrivals per step. rate <= 0 or inf means all at t=0."""
    if n <= 0:
        return np.zeros(0)
    if rate <= 0 or math.isinf(rate):
        return np.zeros(n)
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def make_requests(n: int, vocab_size: int, *,
                  prompt_range: tuple[int, int] = (16, 32),
                  gen_range: tuple[int, int] = (4, 16),
                  rate: float = 0.5,
                  seed: int = 0,
                  eos_id: Optional[int] = None,
                  tiers: Optional[list] = None,
                  prefix_groups: Optional[list] = None,
                  priorities: Optional[list] = None) -> list[Request]:
    """A mixed-length request set with staggered Poisson arrivals.

    Prompt and generation lengths are uniform over the given inclusive
    ranges — the length spread is what separates continuous from static
    batching (static drains at the slowest request of each batch).

    `tiers` assigns each request an activation tier (effective routed
    top-k; None = the model's default tier) by cycling the list across
    rids — e.g. ``tiers=[1, None]`` interleaves a k=1 tier with the
    default so every co-batched step mixes both. Tiers are routing DATA:
    the engine serves the mix in the same compiled steps.

    `prefix_groups` generates HOT-PREFIX traffic: entry g is a shared
    "system prompt" length (0/None = no shared prefix), cycled across
    rids like `tiers` — every request in group g gets the SAME
    group-deterministic prefix of that length prepended to its unique
    prompt, so prompts grow to prefix + prompt_range tokens. With the
    engine's ``prefix_reuse`` on, every admission after a group's first
    adopts the shared prefix from the block pool instead of prefilling
    it — the bench and tests generate hot traffic with no hand-built
    prompts. ``tiers`` cycles independently, so a group can deliberately
    straddle tiers (cross-tier requests never share, by the chain key).

    `priorities` assigns each request an SLO priority class (higher
    wins; default 0), cycled like `tiers` — e.g. ``priorities=[0, 1]``
    interleaves a background class with one that may preempt it under
    paged pool pressure.
    """
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n, rate, seed=seed + 1)
    shared: dict[int, list[int]] = {}
    if prefix_groups:
        for g, plen in enumerate(prefix_groups):
            if not plen:
                continue
            # group-keyed rng: the prefix is a function of (seed, group),
            # independent of n or the per-request draws
            pfx = np.random.default_rng(seed * 7919 + g).integers(
                0, vocab_size, size=int(plen)).astype(np.int32)
            if eos_id is not None:
                pfx = np.where(pfx == eos_id, (eos_id + 1) % vocab_size,
                               pfx)
            shared[g] = [int(t) for t in pfx]
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        gen = int(rng.integers(gen_range[0], gen_range[1] + 1))
        prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        if eos_id is not None:
            prompt = np.where(prompt == eos_id, (eos_id + 1) % vocab_size,
                              prompt)
        tokens = [int(t) for t in prompt]
        if prefix_groups:
            tokens = shared.get(i % len(prefix_groups), []) + tokens
        tier = tiers[i % len(tiers)] if tiers else None
        prio = int(priorities[i % len(priorities)]) if priorities else 0
        reqs.append(Request(rid=i, prompt=tokens,
                            max_new=gen, arrival=float(arrivals[i]),
                            eos_id=eos_id, tier=tier, priority=prio))
    return reqs
