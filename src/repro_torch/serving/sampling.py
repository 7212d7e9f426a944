"""One sampling rule for every consumer. Port of
``repro/serving/sampling.py``: greedy argmax, temperature sampling in
stream mode from a seeded ``torch.Generator``, and the serving engine's
schedule-invariant keyed mode."""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (the "lowbias32" finalizer) on int64 tensors
    holding values in [0, 2^32). Products wrap in int64 and only their low
    32 bits are kept, so the result is exact and the same on every
    device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def keyed_gumbel(seed: int, rids: torch.Tensor, token_idx: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(R, vocab) float32 Gumbel noise, a stateless function of (seed,
    rids[r], token_idx[r], vocab index): a counter-based hash, computed on
    the rows' device with no host loop."""
    dev = rids.device
    key = _mix32(torch.full_like(rids, seed & _M32, dtype=torch.int64)
                 ^ 0x9E3779B9)
    key = _mix32(key ^ (rids.long() & _M32))
    key = _mix32(key ^ (token_idx.long().to(dev) & _M32))     # (R,)
    col = _mix32(torch.arange(vocab, device=dev, dtype=torch.int64))
    h = _mix32((key[:, None] + col[None, :] * 0x9E3779B9) & _M32)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))          # (0, 1)
    return -torch.log(-torch.log(u))


def make_sampler(temperature: float = 0.0, seed: int = 0, device=None):
    """Returns pick(logits (B, V)[, rids (B,), token_idx (B,)]) -> (B,).

    temperature <= 0 is greedy argmax (ties to the lowest id, as
    jnp.argmax). For temperature > 0 two modes:

      pick(logits): stream mode, one generator seeded once, so two
        samplers built with the same (temperature, seed) on one device
        replay the same stream (the static CLI's decode loops);

      pick(logits, rids, token_idx): SCHEDULE-INVARIANT mode (the serving
        engine): row i takes argmax(logits / temperature + Gumbel noise)
        with noise keyed by (seed, rids[i], token_idx[i]), so a request's
        sampled stream depends only on its logits and (rid, token index),
        never on the step, slot or micro-batch it was sampled in. It runs
        on the logits' device, so the overlapped engine samples without a
        host readback.

    Neither mode reproduces the JAX package's threefry bits for the same
    seed: at temperature > 0 the two packages draw different tokens.
    """
    if temperature <= 0:
        def greedy(logits: torch.Tensor, rids=None, token_idx=None
                   ) -> torch.Tensor:
            return torch.argmax(logits, dim=-1)
        return greedy

    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(seed)

    def pick(logits: torch.Tensor, rids=None, token_idx=None
             ) -> torch.Tensor:
        scaled = logits.float() / temperature
        if rids is None:
            probs = torch.softmax(scaled, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]
        rids = torch.as_tensor(rids, device=logits.device)
        token_idx = torch.as_tensor(token_idx, device=logits.device)
        noise = keyed_gumbel(seed, rids, token_idx, logits.shape[-1])
        return torch.argmax(scaled + noise, dim=-1)

    return pick
