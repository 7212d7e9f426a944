"""Step executor: the serving engine's micro-batch steps over Model.step.

Port of ``repro/serving/executor.py``. The reference compiles each step
with ``jax.jit`` and threads updated caches through it; here every method
runs eagerly and updates the cache IN PLACE on the current stream. The
engine hands host-known metadata (tokens, slots, positions, tables) over as
numpy arrays; they go to the device as copies, from pinned host memory
without a device sync when the model runs on CUDA, so the host may mutate
its own arrays as soon as a method returns.

  prefill(tokens (n, W), slots (n,), lengths (n,), starts (n,), hist)
      one prefill CHUNK per row: row i covers positions [starts[i],
      starts[i] + lengths[i]) of its slot. The executor copies the first
      `hist` cache columns of the admitted slots (hist >= max(starts) + W,
      so a chunk's queries see the slot's whole filled prefix), runs the
      slot-aware step at per-slot start positions, and writes back ONLY
      each row's window [start, start + W) (columns past max_len dropped).

  decode(tokens (B, 1), positions (B,))
      full width over ALL slots at per-slot positions. Free lanes decode a
      dummy token whose write lands in a free slot and is overwritten by
      the next prefill before anything attends it.

  step_fused(base (R,), use_prev, slot_tokens, row_slots, positions, ...)
      the OVERLAPPED engine's one dispatch per step: decode lanes and
      flattened prefill-chunk tokens as one (R, 1) micro-batch (R rounded
      to a small granule, padding rows duplicating row 0). Sampling runs on
      the device and the sampled tokens stay in an on-device (max_slots,)
      carry keyed by lane, so step t+1 is dispatched before step t's
      tokens reach the host. The routed-expert phase is "mixed": backend
      by the TRUE fused width R.

Each has a PAGED twin taking block tables instead of slot indices: the pool
is the cache, writes go through the table, and a resumed chunk's prefix is
a table lookup instead of a copied [0, hist) window. Free lanes carry
all-trash tables (physical block 0).

Each call returns the routed-expert backend its micro-batch ran
(``microbatch_backend``, chosen on the host and passed into the step, so
the logged and the executed backend are the same) and the micro-batch's
routed drop count as a device scalar (zero on every engine backend).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.experts import microbatch_backend
from repro_torch.serving.cache import gather_slots, scatter_slots


class StepExecutor:
    def __init__(self, model, sampler=None):
        self.model = model
        self.device = model.device
        # `sampler(logits (R, V), rids (R,), token_idx (R,)) -> (R,)` runs
        # on the device inside the fused step (greedy argmax when None), so
        # the sampled tokens never visit the host between steps
        self._sample = sampler if sampler is not None else \
            (lambda logits, rids, token_idx: torch.argmax(logits, dim=-1))

    def to_device(self, a, dtype=torch.int32) -> Optional[torch.Tensor]:
        """A host array -> a tensor on the model's device (a copy). On CUDA
        the copy goes through pinned memory, asynchronously: nothing waits
        for the device, and the host array may change right after."""
        if a is None:
            return None
        t = torch.from_numpy(np.array(a)).to(dtype)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _backend(self, num_tokens: int, phase: str,
                 effective_k: Optional[float] = None):
        """The routed-expert backend policy for this micro-batch (the
        same choice the step then runs: it is passed in as the override).
        ``effective_k`` is the dispatch's mean per-row k under activation
        tiers; None reads the config top_k."""
        m = self.model
        return microbatch_backend(m.cfg, num_tokens, phase,
                                  use_kernel=m.use_kernel,
                                  override=m.backend,
                                  effective_k=effective_k)

    def _step(self, params, tokens, cache, pos, **kw):
        logits, cache, stats = self.model.step(params, tokens, cache, pos,
                                               return_stats=True, **kw)
        return logits, cache, stats["dropped"]

    # ----------------------------------------------------------- prefill

    def prefill(self, params, cache, tokens, slots, lengths, starts=None,
                hist: Optional[int] = None, row_k=None,
                effective_k: Optional[float] = None):
        """Run one prefill-chunk micro-batch on the contiguous cache.

        starts (n,) are each row's absolute start position (default 0:
        the whole-prompt case); `hist` is the prefix window copied out of
        the cache (default the chunk width, right only when all starts are
        0); `row_k` (n,) each row's activation tier. Returns (logits (n, V)
        at each row's last valid chunk token, cache, backend, dropped)."""
        n, w = tokens.shape
        starts = np.zeros(n, np.int32) if starts is None else \
            np.asarray(starts)
        hist = w if hist is None else hist
        be = self._backend(int(tokens.size), "prefill", effective_k)
        slots_t = self.to_device(slots, torch.long)
        starts_t = self.to_device(starts)
        sub = gather_slots(cache, slots_t, width=hist)
        logits, sub, dropped = self._step(
            params, self.to_device(tokens, torch.long), sub, starts_t,
            lengths=self.to_device(lengths), phase="prefill",
            row_k=self.to_device(row_k), backend=be)
        # only the chunk's write window changed: copy it back
        rows = torch.arange(n, device=self.device)
        chunk = gather_slots(sub, rows, width=w, start=starts_t)
        scatter_slots(cache, slots_t, chunk, width=w, start=starts)
        return logits, cache, be, dropped

    def prefill_paged(self, params, cache, tokens, tables, lengths, starts,
                      row_k=None, effective_k: Optional[float] = None):
        """Paged twin of `prefill`: `tables` (n, nblk) replaces (slots,
        hist); row i's chunk writes land at starts[i] + j through its table
        and its queries attend the [0, nblk * block_size) logical window.
        Returns (logits (n, V), cache, backend, dropped)."""
        be = self._backend(int(tokens.size), "prefill", effective_k)
        logits, cache, dropped = self._step(
            params, self.to_device(tokens, torch.long), cache,
            self.to_device(starts), lengths=self.to_device(lengths),
            phase="prefill", block_tables=self.to_device(tables),
            row_k=self.to_device(row_k), backend=be)
        return logits, cache, be, dropped

    # ------------------------------------------------------------ decode

    def decode(self, params, cache, tokens, positions, row_k=None,
               effective_k: Optional[float] = None):
        """Returns (logits (B, V), cache, backend, dropped)."""
        be = self._backend(int(tokens.shape[0]), "decode", effective_k)
        logits, cache, dropped = self._step(
            params, self.to_device(tokens, torch.long), cache,
            self.to_device(positions), phase="decode",
            row_k=self.to_device(row_k), backend=be)
        return logits, cache, be, dropped

    def decode_paged(self, params, cache, tokens, positions, tables,
                     row_k=None, effective_k: Optional[float] = None):
        """Paged twin of `decode`: every lane reads and writes its own
        blocks through `tables` (B, blocks_per_slot); free lanes' tables
        are all-trash, so their dummy writes land in block 0."""
        be = self._backend(int(tokens.shape[0]), "decode", effective_k)
        logits, cache, dropped = self._step(
            params, self.to_device(tokens, torch.long), cache,
            self.to_device(positions), phase="decode",
            block_tables=self.to_device(tables),
            row_k=self.to_device(row_k), backend=be)
        return logits, cache, be, dropped

    # ------------------------------------------------------------- fused

    def _fused(self, params, cache, base, use_prev, slot_tokens, row_slots,
               positions, rids, tidx, carry, row_k, effective_k, tables):
        be = self._backend(int(base.shape[0]), "mixed", effective_k)
        row_slots_t = self.to_device(row_slots, torch.long)
        # row r's input: the staged prompt token, or for a decode row the
        # token its own lane sampled last step, read from the device carry
        tokens = torch.where(self.to_device(use_prev, torch.bool),
                             slot_tokens[row_slots_t],
                             self.to_device(base))
        kw = dict(block_tables=self.to_device(tables)) if tables is not None \
            else dict(row_slots=row_slots_t)
        logits, cache, dropped = self._step(
            params, tokens[:, None].long(), cache, self.to_device(positions),
            phase="mixed", row_k=self.to_device(row_k), backend=be, **kw)
        nxt = self._sample(logits, self.to_device(rids, torch.long),
                           self.to_device(tidx, torch.long)).to(torch.int32)
        # at most one carry row per lane (its decode row, or the final row
        # of its completing chunk); the others write a spare cell that is
        # cut off
        n = slot_tokens.shape[0]
        idx = torch.where(self.to_device(carry, torch.bool), row_slots_t,
                          torch.full_like(row_slots_t, n))
        st = torch.cat([slot_tokens, slot_tokens.new_zeros(1)])
        st[idx] = nxt
        return nxt, st[:n], cache, be, dropped

    def step_fused(self, params, cache, base, use_prev, slot_tokens,
                   row_slots, positions, rids, token_idx, carry,
                   row_k=None, effective_k: Optional[float] = None):
        """ONE fused ragged micro-batch over the contiguous cache: row r is
        a width-1 token for lane row_slots[r] at positions[r], its input
        `base[r]` (a staged prompt token) or, where use_prev[r], the token
        lane row_slots[r] sampled last step (the device carry
        `slot_tokens`). Rows with carry[r] write their sample back into the
        carry. Padding rows must duplicate row 0 with carry False.

        Returns (nxt (R,) on the device, new slot_tokens, cache, backend,
        dropped on the device): nothing is read back here, so the caller
        can dispatch the next step before reading this one."""
        return self._fused(params, cache, base, use_prev, slot_tokens,
                           row_slots, positions, rids, token_idx, carry,
                           row_k, effective_k, None)

    def step_fused_paged(self, params, cache, base, use_prev, slot_tokens,
                         row_slots, tables, positions, rids, token_idx,
                         carry, row_k=None,
                         effective_k: Optional[float] = None):
        """Paged twin of `step_fused`: row r addresses the pool through its
        own block-table snapshot `tables[r]` (rows of one lane share a
        table; padding rows duplicate row 0's); row_slots still drives the
        token composition and the carry."""
        return self._fused(params, cache, base, use_prev, slot_tokens,
                           row_slots, positions, rids, token_idx, carry,
                           row_k, effective_k, tables)
