"""One sampling rule for every consumer. Port of
``repro/serving/sampling.py``: greedy argmax, and temperature sampling in
stream mode from a seeded ``torch.Generator``. (The schedule-invariant keyed
mode of the serving engine comes with the engine's slice.)"""
from __future__ import annotations

import torch


def make_sampler(temperature: float = 0.0, seed: int = 0, device=None):
    """Returns pick(logits (B, V)) -> (B,) token ids.

    temperature <= 0 is greedy argmax (ties to the lowest id, as jnp.argmax).
    For temperature > 0 each call draws from softmax(logits / temperature)
    with one generator seeded once, so two samplers built with the same
    (temperature, seed) on one device replay the same stream. The numbers
    differ from the JAX package's threefry stream for the same seed.
    """
    if temperature <= 0:
        def greedy(logits: torch.Tensor) -> torch.Tensor:
            return torch.argmax(logits, dim=-1)
        return greedy

    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(seed)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    return pick
