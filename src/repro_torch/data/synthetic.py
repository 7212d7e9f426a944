"""Deterministic synthetic corpus with DOMAIN STRUCTURE.

CMoE's premise is that FFN neurons develop input-conditional activation
patterns; a uniform-random token stream trains none. This corpus mixes K
"domains", each a distinct sparse bigram process over its own vocabulary
band plus shared function tokens — after a few hundred training steps the
model's FFN neurons specialize per domain, giving the profiling step real
bimodal structure (benchmarks/fig2 verifies this).

Everything is a pure function of (seed, domain, position): reproducible
across hosts, shardable by slicing, no files.
"""
from __future__ import annotations

import numpy as np

Array = np.ndarray


def _domain_table(vocab: int, domain: int, table_seed: int,
                  branch: int = 4) -> Array:
    """Sparse bigram successor table: (vocab, branch) int32. Tables are a
    function of table_seed ONLY — the corpus-level structure every stream
    shares (a per-stream seed here would make the corpus unlearnable)."""
    rng = np.random.default_rng(np.random.PCG64(table_seed * 1000 + domain))
    lo = (domain * vocab) // 8 % vocab
    band = max(vocab // 4, 8)
    return (lo + rng.integers(0, band, size=(vocab, branch))) % vocab


def synthetic_tokens(vocab: int, num_tokens: int, *, seed: int = 0,
                     num_domains: int = 4, doc_len: int = 256,
                     branch: int = 4, table_seed: int = 0) -> Array:
    """Generate a deterministic token stream (num_tokens,) int32.
    ``seed`` varies the SAMPLING; ``table_seed`` fixes the shared corpus
    structure (domain bigram tables)."""
    rng = np.random.default_rng(np.random.PCG64(seed))
    tables = [_domain_table(vocab, d, table_seed, branch)
              for d in range(num_domains)]
    out = np.empty(num_tokens, np.int32)
    pos = 0
    while pos < num_tokens:
        d = int(rng.integers(num_domains))
        table = tables[d]
        n = min(doc_len, num_tokens - pos)
        cur = int(rng.integers(vocab))
        picks = rng.integers(0, branch, size=n)
        noise = rng.random(n) < 0.05                 # 5% out-of-domain noise
        rand_tok = rng.integers(0, vocab, size=n)
        for i in range(n):
            cur = int(rand_tok[i]) if noise[i] else int(table[cur, picks[i]])
            out[pos + i] = cur
        pos += n
    return out


def make_calibration_batch(vocab: int, num_samples: int, seq_len: int, *,
                           seed: int = 1234, num_domains: int = 4,
                           table_seed: int = 0) -> dict:
    """The paper's calibration set: `num_samples` docs of `seq_len` tokens."""
    toks = synthetic_tokens(vocab, num_samples * seq_len, seed=seed,
                            num_domains=num_domains, table_seed=table_seed)
    return {"tokens": toks.reshape(num_samples, seq_len)}
