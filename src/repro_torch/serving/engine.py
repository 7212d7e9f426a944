"""The continuous-batching serving loop: overlapped single-dispatch, or
the sequential two-dispatch baseline.

Port of ``repro/serving/engine.py``: the loop, the scheduling and the
telemetry are the reference's; the steps run eagerly through
``repro_torch.serving.executor`` and update the cache in place. In the
overlapped loop, step t's sampled tokens come back through an asynchronous
copy into pinned host memory and a CUDA event that is waited on only after
step t+1 has been dispatched; nothing on the dispatch path reads a device
value back.

OVERLAPPED mode (``overlap=True`` — serve.py's default) runs ONE fused
ragged micro-batch per step and double-buffers the host loop:

  1. plan prefill under the `max_prefill_tokens` budget (resume
     PREFILLING cursors, admit due requests into free slots);
  2. flatten every decode lane and every planned chunk token into width-1
     rows of a single (R, 1) dispatch — per-row (slot, position) metadata
     over one padded token buffer; the width-1 piggyback path of the old
     loop generalized until it IS the whole step (no separate prefill
     micro-batch exists);
  3. sample ON DEVICE inside the step and keep the tokens in a
     per-lane device carry, so step t+1 is dispatched from snapshots of
     tables/positions taken at dispatch BEFORE step t's tokens are read
     back (block allocation is host-only bookkeeping — `PagedKVCache.
     ensure` touches no device state, so paged overlaps as cleanly as
     contiguous);
  4. read step t's tokens back while t+1 computes: emission therefore
     LAGS DISPATCH BY ONE STEP. max_new/max_len finishes are decided at
     dispatch (host-deterministic); only EOS is discovered at readback,
     and the lane's speculative row in the one newer in-flight step is
     rolled back (invalidated — its device writes land in freed cells no
     mask can reach).

SEQUENTIAL mode (``overlap=False`` — the constructor default, and the
fused path's parity baseline) keeps the classic shape: one padded prefill
micro-batch for the planned chunks (width-1 chunks piggyback on decode),
then one full-width decode dispatch, with a host sync for sampling every
step.

The phase is threaded per micro-batch down to the routed-expert engine —
in sequential mode prefill chunks run the grouped (ragged segment)
backend while decode runs gather; a fused step runs phase "mixed",
picking its backend by the TRUE padded row count R (host-known per
shape): decode-only widths stay on gather, chunk-heavy steps cross the
gather break-even and run grouped. Every backend is bitwise identical
under the engine's per-token capacity contract, which is what makes
overlap-on == overlap-off token parity hold across the switch (on the
card both kernels run one arithmetic a row, csrc/ffn_tc.cuh in bfloat16:
chip_smoke.py phase 4a checks a gather row, the ragged row of the same
(token, expert) and moe_gmm's capacity row bitwise equal, and
tests/test_torch_cuda.py the two backends' outputs). `backend_log` records what each
micro-batch ran, its padded vs live rows (a fused step charges its
actual padded row count, not max_slots), and its routed drop count
(`EngineReport.dropped_pairs` aggregates; zero on every engine backend).
The cache behind the loop is either contiguous slot lanes or — with
``paged=True`` — a refcounted block pool with per-request block tables
(`serving.cache.PagedKVCache`): admission then reserves each request's
worst-case block count against POOL headroom (not just a free slot), so
concurrency is bounded by actual footprint, pool pressure surfaces as
admission deferrals (`EngineReport.pool_deferrals`), and both layouts
serve token-identical streams (tests/test_torch_serving.py).

Two policies ride the refcounted pool. PREFIX REUSE (``prefix_reuse=
True``): full blocks written by prefill are content-addressed in a
token-chain trie (keyed by the request's resolved activation tier), and
admission points a new request's table at matching prefix blocks —
shared full blocks by refcount, a partial tail by copy-on-write — then
fast-forwards ``Request.prefill_pos`` past the match, so a hot-prefix
request prefills only its unmatched tail (TTFT collapses to table
assembly + the tail; the chunked-prefill resume machinery IS the
dispatch path, no new kernel shape exists). PRIORITY PREEMPTION: when a
due request finds no pool headroom, the gate evicts the lowest RUNNING
lane STRICTLY below its priority class — private blocks decref to zero
and recycle, shared prefix blocks survive by refcount — and requeues it
for recompute (prompt + emitted tokens replayed through prefill; the
resumed stream is token-identical by width-invariant prefill + keyed
sampling), instead of deferring the head behind lower-priority work
forever. Both policies are token-identity-preserving by construction:
reuse on == reuse off, preemption-pressured == unpressured, across
sequential and overlapped dispatch (tests/test_torch_serving.py).

Latency telemetry under overlap splits in two. A DISPATCH gap
(`dispatch_gaps_s`) is the wall time between consecutive fused
dispatches — how fast the host issues work; it can undercut the device
step time because issuing never waits on results. A DECODE/COMPLETION
gap (`decode_gaps_s`, the TPOT percentiles) is the wall time between
consecutive READBACKS — the inter-token latency a client actually
observes, including the one-step emission lag. In sequential mode the
two coincide and both columns carry the same gaps. Either chain only
continues across steps where a decode lane is live (a chunk-only step is
a stall no decode token paid, so it breaks the chain), and
`overlap_occupancy` reports the fraction of dispatches issued while the
previous step was still in flight — ~1.0 means the device never waited
on the host. Wall-clock TTFT (`ttft_p50_s`/`ttft_p95_s`, from
`Request.arrival_t` to `Request.first_token_t`) is stamped at EMISSION,
so it too includes the lag the client would see.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from collections import Counter, deque
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.cache import PagedKVCache, SlotKVCache
from repro_torch.serving.executor import StepExecutor
from repro_torch.serving.request import RUNNING, Request
from repro_torch.serving.sampling import make_sampler
from repro_torch.serving.scheduler import Scheduler


@dataclasses.dataclass
class EngineReport:
    num_requests: int
    steps: int
    wall_s: float
    total_new_tokens: int
    mean_ttft_steps: float          # arrival -> first token, in steps
    slot_busy_frac: float           # occupied lanes / (steps * max_slots)
    slot_reuse: int                 # admissions that recycled a used slot
    backend_counts: dict            # phase -> Counter of backends run
    dropped_pairs: int              # routed (token, expert) assignments
    #   any bounded-buffer dispatch stage failed to keep, summed over all
    #   micro-batches. The buffer-free engine backends never drop, so a
    #   nonzero count fingers the one bounded stage left (EP all-to-all
    #   shard binning) — per-micro-batch counts live in
    #   `backend_log`. Zero is the width-invariance precondition: it
    #   certifies no token's routed output was perturbed by how the
    #   scheduler happened to batch tokens.
    decode_gaps_s: list             # wall gap between consecutive decode
    #   steps — the inter-token latency every decode lane paid that step
    #   (prefill chunks dispatched between two decode steps are inside
    #   the gap: the head-of-line stall chunked prefill bounds). The
    #   chain breaks across idle periods AND piggyback-only dispatches
    #   (no RUNNING lane), so gaps no decode token paid don't count.
    requests: list[Request]         # SNAPSHOTS of end-of-run state — a
    #   later engine.run() on the same request list resets/mutates the
    #   live objects, but not these copies
    truncated: int                  # requests finished by the max_len
    #   wall before reaching max_new (or EOS) — each also carries
    #   Request.truncated, so a clipped stream is never a silent finish
    pool_deferrals: int             # plans where a due request with a
    #   free slot was deferred because the paged pool lacked headroom
    #   for its reservation (0 in contiguous mode) — the "pool"-cause
    #   slice of gate_deferrals, kept as its own column so pre-priority
    #   readers (bench gates) keep reading the number they always did
    peak_occupancy: int             # max lanes simultaneously occupied —
    #   the concurrency the cache layout actually admitted
    live_tokens: int                # micro-batch tokens backed by real
    #   work (decode: RUNNING + piggyback lanes; prefill: real chunk
    #   tokens), summed over backend_log
    padded_tokens: int              # what the dispatches actually
    #   charged (sequential decode: max_slots per step; prefill: rows x
    #   padded width; fused: the step's granule-rounded row count) —
    #   live/padded is the engine's compute utilization
    dispatch_gaps_s: list = dataclasses.field(default_factory=list)
    #   wall gap between consecutive fused DISPATCHES — host issue rate.
    #   Under overlap it can undercut the device step time (issuing
    #   never waits on results); in sequential mode it equals
    #   decode_gaps_s, where dispatch and completion coincide.
    ttft_s: list = dataclasses.field(default_factory=list)
    #   wall-clock arrival -> first EMITTED token per finished-prefill
    #   request (includes the overlapped engine's one-step emission lag —
    #   what a client would measure, where mean_ttft_steps counts
    #   scheduler steps)
    overlap_occupancy: float = 0.0  # dispatches issued while the previous
    #   step was still in flight / total dispatches — ~1.0 means the
    #   device never waited on host readback (0.0 in sequential mode)
    active_pairs: int = 0           # k-weighted live work: sum over live
    #   tokens of that row's effective routed top-k (its activation
    #   TIER). Two tokens at k=1 and k=6 charge identical LIVE TOKENS but
    #   6x different routed-expert compute — this column is the one that
    #   sees the difference, which is what makes a low-activation tier
    #   measurably cheaper inside the same co-batched run
    padded_pairs: int = 0           # padded tokens x K_max — the routed
    #   pairs the dispatches would charge if every row ran the default
    #   tier; active/padded is k-aware compute utilization
    k_max: int = 1                  # the DEFAULT tier: config top_k (what
    #   Request.tier=None resolves to, and the bound tiers live under)
    gate_deferrals: int = 0         # ALL admission-gate deferrals, every
    #   cause — pool_deferrals plus the priority-cause slice
    deferral_causes: dict = dataclasses.field(default_factory=dict)
    #   per-cause breakdown: "pool" = no headroom and nothing strictly
    #   lower-priority to preempt; "priority" = every pool holder
    #   strictly outranks the deferred head
    prefix_matched_tokens: int = 0  # prompt tokens adopted from the
    #   prefix index instead of prefilled (reuse on; 0 otherwise)
    prefix_prompt_tokens: int = 0   # prefill tokens ADMITTED while reuse
    #   was on (replays included) — prefix_hit_rate's denominator
    prefix_hits: int = 0            # admissions that matched >= 1 token
    reused_blocks: int = 0          # full blocks adopted by refcount
    #   (zero copy, zero recompute)
    cow_copies: int = 0             # partial-tail adoptions: one device
    #   block copy each (the copy-on-write private tail)
    preemptions: int = 0            # RUNNING lanes evicted under pool
    #   pressure and requeued for recompute — never a drop: every
    #   preempted request still completes, token-identically
    pool_audit: dict = dataclasses.field(default_factory=dict)
    #   end-of-run PagedKVCache.audit(): the free + cached + allocated
    #   == num_blocks conservation law, asserted before the report is
    #   built ({} in contiguous mode)

    @property
    def prefix_hit_rate(self) -> float:
        """Matched / admitted prefill tokens while prefix reuse was on —
        the fraction of prompt work the trie turned into table
        assembly."""
        return self.prefix_matched_tokens / max(self.prefix_prompt_tokens,
                                                1)

    @property
    def goodput(self) -> float:
        """Generated tokens per wall-clock second."""
        return self.total_new_tokens / max(self.wall_s, 1e-9)

    @property
    def tpot_p50_s(self) -> float:
        """Median time-per-output-token (decode-step gap)."""
        return float(np.percentile(self.decode_gaps_s, 50)) \
            if self.decode_gaps_s else 0.0

    @property
    def tpot_p95_s(self) -> float:
        """p95 inter-token latency — the decode-stall tail a long
        prompt's unchunked prefill inflates."""
        return float(np.percentile(self.decode_gaps_s, 95)) \
            if self.decode_gaps_s else 0.0

    @property
    def ttft_p50_s(self) -> float:
        """Median wall-clock time-to-first-token (seconds)."""
        return float(np.percentile(self.ttft_s, 50)) if self.ttft_s else 0.0

    @property
    def ttft_p95_s(self) -> float:
        """p95 wall-clock time-to-first-token (seconds)."""
        return float(np.percentile(self.ttft_s, 95)) if self.ttft_s else 0.0

    @property
    def compute_utilization(self) -> float:
        """Live tokens / padded tokens over every dispatched micro-batch
        — how much of the charged compute backed real lanes. Token-
        weighted: blind to activation tiers (a k=1 and a k=K_max token
        count the same) — `active_pair_utilization` is the k-aware
        column."""
        return self.live_tokens / max(self.padded_tokens, 1)

    @property
    def active_pair_utilization(self) -> float:
        """Active routed (token, expert) pairs / padded pairs — compute
        utilization weighted by each row's activation tier. Equals
        compute_utilization x (mean live k / K_max): co-batching
        low-activation tiers shows up here as headroom the token-weighted
        column cannot see."""
        return self.active_pairs / max(self.padded_pairs, 1)

    def tier_metrics(self) -> dict:
        """Per-tier latency/throughput table from the request snapshots:
        {tier_k: {"requests", "tokens", "pairs", "ttft_p50_s",
        "ttft_p95_s", "tpot_p50_s", "tpot_p95_s"}}. tier_k is the
        RESOLVED effective routed top-k (Request.tier, with None -> the
        default tier `k_max`); "pairs" is tokens x k — per-token routed
        compute, so in a mixed run the low tier's pairs/token is strictly
        below the default's by construction. Per-request TPOT is
        (last_token_t - first_token_t) / (tokens - 1) — each request's
        own mean inter-token latency, aggregated per tier (the global
        tpot_p50_s percentiles mix tiers)."""
        groups: dict[int, list[Request]] = {}
        for r in self.requests:
            k = r.tier if r.tier is not None else self.k_max
            groups.setdefault(int(k), []).append(r)
        out = {}
        for k in sorted(groups):
            reqs = groups[k]
            ttft = [r.first_token_t - r.arrival_t for r in reqs
                    if r.first_token_t >= 0 and r.arrival_t >= 0]
            tpot = [(r.last_token_t - r.first_token_t) /
                    (len(r.generated) - 1)
                    for r in reqs
                    if len(r.generated) > 1 and r.last_token_t
                    > r.first_token_t >= 0]
            tokens = sum(len(r.generated) for r in reqs)
            out[k] = {
                "requests": len(reqs),
                "tokens": tokens,
                "pairs": tokens * k,
                "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft
                else 0.0,
                "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft
                else 0.0,
                "tpot_p50_s": float(np.percentile(tpot, 50)) if tpot
                else 0.0,
                "tpot_p95_s": float(np.percentile(tpot, 95)) if tpot
                else 0.0,
            }
        return out

    def summary(self) -> str:
        bc = {ph: dict(c) for ph, c in self.backend_counts.items()}
        return (f"{self.num_requests} requests in {self.steps} steps / "
                f"{self.wall_s:.2f}s: {self.total_new_tokens} tokens, "
                f"goodput {self.goodput:.1f} tok/s, mean TTFT "
                f"{self.mean_ttft_steps:.1f} steps, TTFT p50/p95 "
                f"{self.ttft_p50_s * 1e3:.1f}/{self.ttft_p95_s * 1e3:.1f} "
                f"ms, TPOT p50/p95 "
                f"{self.tpot_p50_s * 1e3:.1f}/{self.tpot_p95_s * 1e3:.1f} "
                f"ms, overlap occupancy "
                f"{self.overlap_occupancy * 100:.0f}%, slot busy "
                f"{self.slot_busy_frac * 100:.0f}%, peak "
                f"occupancy {self.peak_occupancy}, slot reuse "
                f"{self.slot_reuse}, truncated {self.truncated}, pool "
                f"deferrals {self.pool_deferrals}, gate deferrals "
                f"{self.gate_deferrals} {self.deferral_causes or '{}'}, "
                f"prefix hit-rate {self.prefix_hit_rate * 100:.0f}% "
                f"({self.prefix_matched_tokens}/"
                f"{self.prefix_prompt_tokens} tokens, {self.prefix_hits} "
                f"hits), reused blocks {self.reused_blocks}, cow copies "
                f"{self.cow_copies}, preemptions {self.preemptions}, "
                f"live/padded tokens "
                f"{self.live_tokens}/{self.padded_tokens} "
                f"({self.compute_utilization * 100:.0f}%), active/padded "
                f"pairs {self.active_pairs}/{self.padded_pairs} "
                f"({self.active_pair_utilization * 100:.0f}%), dropped "
                f"pairs {self.dropped_pairs}, backends {bc}")


@dataclasses.dataclass
class _FusedRow:
    """One width-1 row of a fused dispatch (host-side descriptor)."""
    req: Request
    kind: str            # "decode" | "mid" (chunk token) | "first" (final
    #                      chunk token — its logits row is the request's
    #                      first sampled token)
    slot: int
    pos: int             # absolute cache position the row writes at
    base: int            # staged input token (a prompt token; 0 = unused)
    use_prev: bool       # True: input is the lane's device-carried token
    tidx: int            # schedule-invariant sampling token index
    carry: bool          # write the sample back into the device carry
    valid: bool = True   # cleared by EOS rollback — emission is skipped


@dataclasses.dataclass
class _InFlight:
    """A dispatched fused step whose results have not been read back."""
    step: int
    host: object         # (R_pad + 1,) int32 host buffer: the sampled
    #                      tokens, then the dropped count — filled by an
    #                      asynchronous copy; an int() of a device value at
    #                      dispatch would sync the step and forfeit overlap
    ready: object        # CUDA event recorded after that copy (None on CPU)
    rows: list           # _FusedRow per real row, index-aligned with nxt
    running: int         # decode rows (gap-chain bookkeeping)
    padded: int          # granule-rounded row count the dispatch charged
    live: int            # real rows
    backend: Optional[str]
    active_pairs: int    # k-weighted live rows (sum of each real row's
    #                      activation tier) — the 7th backend_log column


def check_servable(cfg, kind) -> None:
    """Raise unless the engine serves this model. As in the reference it
    needs a positional KV cache, which the SSM, hybrid and enc-dec families
    lack; of the KV families, the port serves the dense (and the VLM
    family's dense blocks, text-only), GQA-MoE (llama4) and MLA ones."""
    if cfg.family in ("ssm", "hybrid", "audio"):
        raise NotImplementedError(
            f"serving engine needs a positional KV cache; family="
            f"{cfg.family!r} kind={kind!r} is not slot-addressable")
    if kind not in ("dense", "moe", "mla_moe"):
        raise NotImplementedError(
            f"serving engine needs a positional KV cache of a ported "
            f"family; family={cfg.family!r} kind={kind!r} is not ported")


def _weak_hook(method):
    """A plain function that calls the bound ``method`` through a weak
    reference to its object."""
    ref = weakref.WeakMethod(method)

    def hook(*args, **kwargs):
        return ref()(*args, **kwargs)
    return hook


class ServingEngine:
    """Continuous-batching engine over a slot KV cache.

    model/params: the port's dense GQA family (plain or CMoE-converted),
    llama4's interleaved dense / GQA-MoE stack (pretrained or
    hierarchically converted), or deepseek-v2's MLA + pretrained MoE,
    whose cache is the (latent, rope key) pair. max_slots is the batch width (one slot = one lane of
    the cache); max_len bounds prompt + generation per request.
    policy="static" turns the same machinery into the fixed-batch
    baseline (admit only when all slots are free) — used by the goodput
    benchmark so both sides run identical compiled steps.
    max_prefill_tokens is a true per-step prefill token budget: prompts
    longer than it are split into per-step chunks interleaved with decode
    (None = whole prompts in one micro-batch).
    paged=True swaps the contiguous slot lanes for a refcounted block
    pool with per-request block tables: each request's cache footprint
    is ceil(len / block_size) blocks, admission reserves its worst case
    against `num_blocks` pool headroom (default: the same token capacity
    as max_slots contiguous lanes — pass fewer blocks to oversubscribe
    slots against memory), and pool pressure surfaces as
    `EngineReport.pool_deferrals`. Both layouts serve token-identical
    streams.
    prefix_reuse=True (paged only) turns on content-addressed prefix
    sharing: admission probes the trie with the request's tokens and
    adopts matched blocks instead of prefilling them (see the module
    docstring) — token-identical to prefix_reuse=False, with the matched
    tokens' prefill compute gone and the savings surfaced as
    `EngineReport.prefix_hit_rate` / `reused_blocks` / `cow_copies`.
    Requests may carry a PRIORITY class (`Request.priority`, default 0):
    due requests admit in (priority desc, arrival, rid) order, and under
    paged pool pressure a due request preempts the lowest RUNNING lane
    strictly below its class (`EngineReport.preemptions`) — all-default
    runs never reorder and never preempt.
    A request whose prompt + max_new exceeds max_len is served but
    CLIPPED at the max_len wall: it finishes early with
    ``Request.truncated`` set (counted in `EngineReport.truncated`) —
    never silently. Prompts longer than max_len are rejected.
    overlap=True switches run() to the OVERLAPPED loop: one fused ragged
    dispatch per step, on-device sampling, host readback lagging one step
    (see the module docstring) — token streams are identical to
    overlap=False by the schedule-invariance contract; only wall-clock
    telemetry and the backend_log shape differ.
    """

    def __init__(self, model, params, *, max_slots: int, max_len: int,
                 policy: str = "continuous",
                 prefill_bucket: int = 16,
                 max_prefill_tokens: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_reuse: bool = False,
                 overlap: bool = False):
        if prefix_reuse and not paged:
            raise ValueError("prefix_reuse needs paged=True — sharing is "
                             "a block-table property")
        check_servable(model.cfg, getattr(model, "kind", None))
        self.model = model
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.prefill_bucket = max(1, prefill_bucket)
        self.temperature = temperature
        self.seed = seed
        self.paged = paged
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prefix_reuse = prefix_reuse
        self.overlap = overlap
        # the engine always samples in keyed mode, which is stateless, so
        # one sampler serves every run; the executor runs the same rule in
        # the fused step, so overlap-on and overlap-off draw identical
        # tokens per (rid, token index)
        self._sampler = make_sampler(temperature, seed, model.device)
        self.executor = StepExecutor(model, sampler=self._sampler)
        # one padding granule shared with the scheduler, so the planner's
        # padded-compute budget accounting matches what actually runs
        self._granule = self.prefill_bucket if max_prefill_tokens is None \
            else min(self.prefill_bucket, max_prefill_tokens)
        self.scheduler = Scheduler(max_slots, policy=policy,
                                   max_prefill_tokens=max_prefill_tokens,
                                   prefill_granule=self._granule)
        # fused dispatches round their row count up to this granule —
        # compiled fused shapes stay O(budget / granule) per run
        self._row_granule = 4
        self.kv: Optional[SlotKVCache | PagedKVCache] = None
        # (step, phase, padded tokens, live tokens, backend, dropped
        # pairs, active pairs) per micro-batch — the drop column is the
        # surfaced form of what used to be silent capacity eviction; the
        # live column is the real work next to what the dispatch charged
        # (a decode row always charges max_slots padded lanes, so without
        # it per-step compute accounting diverged from live work); the
        # ACTIVE PAIRS column is live work weighted by each row's
        # activation tier (its effective routed top-k), the only column
        # where a k=1 row is cheaper than a k=K_max row
        self.backend_log: list[
            tuple[int, str, int, int, Optional[str], int, int]] = []

    # ------------------------------------------------------------- loop

    def run(self, requests: list[Request], *,
            max_steps: Optional[int] = None) -> EngineReport:
        """Serve `requests` to completion; reusable (state resets here)."""
        for r in requests:
            if r.prompt_len < 1 or r.max_new < 1:
                raise ValueError(f"request {r.rid}: empty prompt or gen")
            if r.prompt_len > self.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} exceeds "
                    f"max_len {self.max_len}")
            # prompt + max_new past max_len is allowed: the stream is
            # clipped at the wall and SURFACED via Request.truncated
            r.reset()
        cm = getattr(self.model.cfg, "cmoe", None)
        self._k_max = int(cm.top_k) if cm is not None else 1
        for r in requests:
            if r.tier is None:
                continue
            if cm is None:
                raise ValueError(
                    f"request {r.rid}: tier={r.tier} needs a CMoE-routed "
                    f"model — activation tiers are a routed-k knob")
            if not 1 <= r.tier <= self._k_max:
                raise ValueError(
                    f"request {r.rid}: tier {r.tier} outside [1, "
                    f"{self._k_max}] (K_max = config top_k, the default "
                    f"tier)")
        # all-default runs keep row_k=None end to end: the compiled step
        # is the exact pre-tier graph, so adding tiers costs nothing
        # until a request actually asks for one
        self._tiered = any(
            r.tier is not None and r.tier != self._k_max for r in requests)
        self.scheduler.reset()
        if self.paged:
            self.kv = PagedKVCache(self.model, self.max_slots,
                                   self.max_len,
                                   block_size=self.block_size,
                                   num_blocks=self.num_blocks,
                                   reuse=self.prefix_reuse)
            for r in requests:
                need = self.kv.blocks_for(self._footprint(r))
                if need > self.kv.num_blocks:
                    raise ValueError(
                        f"request {r.rid}: needs {need} blocks, pool has "
                        f"{self.kv.num_blocks} — it could never admit")
            # the scheduler the engine owns holds these hooks weakly: a
            # bound method would close a cycle engine -> scheduler ->
            # engine, and a finished engine's model would stay allocated
            # until the garbage collector runs
            self.scheduler.admission_gate = _weak_hook(self._paged_gate)
            self.scheduler.prefix_skip = \
                _weak_hook(self._prefix_skip) if self.prefix_reuse else None
            self.scheduler.on_admit = \
                _weak_hook(self._on_admit) if self.prefix_reuse else None
        else:
            self.kv = SlotKVCache(self.model, self.max_slots, self.max_len)
            self.scheduler.admission_gate = None
            self.scheduler.prefix_skip = None
            self.scheduler.on_admit = None
        self._probe = {}                 # rid -> pending PrefixMatch|None
        self._prefix_matched_tokens = 0
        self._prefix_prompt_tokens = 0
        self._prefix_hits = 0
        self._reused_blocks = 0
        self._cow_copies = 0
        self._inflight = None            # overlapped in-flight deque —
        #   _preempt invalidates a victim's speculative rows through it
        self._disp_counts: dict[int, int] = {}
        self.backend_log = []
        self._decode_gaps: list[float] = []
        self._last_decode_t: Optional[float] = None
        self._dispatch_gaps: list[float] = []
        self._last_dispatch_t: Optional[float] = None
        if max_steps is None:
            # every iteration with occupied slots prefills >= 1 prompt
            # token or decodes >= 1 token, so the loop is bounded by
            # total work + the arrival horizon
            horizon = max((r.arrival for r in requests), default=0.0)
            work = sum(r.prompt_len + r.max_new for r in requests)
            if any(r.priority != requests[0].priority for r in requests):
                # mixed priorities: preemption UNDOES progress (a victim
                # replays prompt + emitted tokens). Each higher-priority
                # admission preempts at most max_slots lanes and each
                # replay is at most one request's work, so scale the
                # bound instead of modelling the exact recompute
                work *= 1 + len(requests)
            max_steps = int(horizon) + work + 16
        self.scheduler.submit(requests)
        if self.overlap:
            return self._run_fused(requests, max_steps)

        step = 0
        busy = 0
        peak = 0
        t0 = time.perf_counter()
        while not self.scheduler.all_done():
            self._stamp_arrivals(requests, step)
            plan = self.scheduler.plan_prefill(step)
            # width-1 chunks ALWAYS ride the decode micro-batch: with
            # decode lanes live their compute rides a dispatch that runs
            # anyway, and without them the decode shape is the one the
            # run has already compiled — either way no (n, 1) prefill
            # bucket is dispatched (a piggyback-ONLY step records no
            # decode gap; see _decode_microbatch)
            piggy = [(r, c) for r, c in plan if c == 1]
            chunks = [(r, c) for r, c in plan if c != 1]
            if chunks:
                self._prefill_microbatch(chunks, step)
            occupied = len(self.scheduler.occupied())
            busy += occupied
            peak = max(peak, occupied)
            if self.scheduler.active() or piggy:
                self._decode_microbatch(step, piggy)
            else:
                # no decode lanes this step: an idle/arrival or pure-
                # prefill-rampup gap, not a stall any token waited on
                self._last_decode_t = None
            step += 1
            if step > max_steps:
                raise RuntimeError(f"engine made no progress in "
                                   f"{max_steps} steps")
        wall = time.perf_counter() - t0
        # sequential mode: dispatch and completion coincide, so the
        # dispatch-gap column carries the same gaps as the decode gaps
        return self._mk_report(requests, step=step, wall=wall, busy=busy,
                               peak=peak,
                               dispatch_gaps=list(self._decode_gaps),
                               overlap_occupancy=0.0)

    def _mk_report(self, requests, *, step, wall, busy, peak,
                   dispatch_gaps, overlap_occupancy) -> EngineReport:
        ttft = [r.first_token_step - r.arrival for r in requests]
        ttft_s = [r.first_token_t - r.arrival_t for r in requests
                  if r.first_token_t >= 0 and r.arrival_t >= 0]
        audit = {}
        if self.paged:
            # the conservation law, checked at the end of EVERY paged
            # run: with all requests drained, no block may be leaked,
            # double-freed, or hold a stale refcount
            audit = self.kv.audit()
            assert audit["ok"] and audit["allocated"] == 0, (
                f"block-pool conservation violated at end of run: {audit}")
        causes = dict(self.scheduler.deferral_causes)
        return EngineReport(
            num_requests=len(requests),
            steps=step,
            wall_s=wall,
            total_new_tokens=sum(len(r.generated) for r in requests),
            mean_ttft_steps=float(np.mean(ttft)) if ttft else 0.0,
            slot_busy_frac=busy / max(step * self.max_slots, 1),
            slot_reuse=self.scheduler.slot_reuse,
            backend_counts=self.backend_counts(),
            dropped_pairs=sum(row[5] for row in self.backend_log),
            decode_gaps_s=list(self._decode_gaps),
            requests=[dataclasses.replace(r, generated=list(r.generated))
                      for r in requests],
            truncated=sum(1 for r in requests if r.truncated),
            pool_deferrals=causes.get("pool", 0),
            gate_deferrals=self.scheduler.gate_deferrals,
            deferral_causes=causes,
            prefix_matched_tokens=self._prefix_matched_tokens,
            prefix_prompt_tokens=self._prefix_prompt_tokens,
            prefix_hits=self._prefix_hits,
            reused_blocks=self._reused_blocks,
            cow_copies=self._cow_copies,
            preemptions=self.scheduler.preemptions,
            pool_audit=audit,
            peak_occupancy=peak,
            live_tokens=sum(row[3] for row in self.backend_log),
            padded_tokens=sum(row[2] for row in self.backend_log),
            active_pairs=sum(row[6] for row in self.backend_log),
            padded_pairs=sum(row[2] for row in self.backend_log)
            * self._k_max,
            k_max=self._k_max,
            dispatch_gaps_s=dispatch_gaps,
            ttft_s=ttft_s,
            overlap_occupancy=overlap_occupancy,
        )

    def _stamp_arrivals(self, requests, step: int) -> None:
        """Stamp the wall clock on requests that just became due — the
        TTFT numerator's zero point."""
        now = time.perf_counter()
        for r in requests:
            if r.arrival_t < 0 and r.arrival <= step:
                r.arrival_t = now

    def backend_counts(self) -> dict:
        out: dict[str, Counter] = {"prefill": Counter(), "decode": Counter()}
        for row in self.backend_log:
            out[row[1]][row[4] or "-"] += 1
        return out

    # ------------------------------------------------------------- paged

    def _footprint(self, req: Request) -> int:
        """Worst-case cache tokens a request can occupy: its prompt plus
        generation, clipped at the max_len wall (past which it finishes
        truncated)."""
        return min(req.prompt_len + req.max_new, self.max_len)

    def _paged_gate(self, req: Request):
        """Scheduler admission gate: reserve the request's worst-case
        block count against pool headroom (idempotent per rid — a
        deferred or budget-stalled head keeps its reservation). When the
        pool is exhausted, PREEMPT the lowest RUNNING lane strictly
        below the head's priority class — repeatedly, until the
        reservation fits or no victim remains — then defer with a cause:
        "pool" (headroom exhaustion among peers-or-lower) or "priority"
        (every pool holder strictly outranks the head)."""
        if self.kv.reserve(req, self._footprint(req)):
            return True
        while True:
            victim = self.scheduler.preemption_victim(req.priority)
            if victim is None:
                break
            self._preempt(victim)
            if self.kv.reserve(req, self._footprint(req)):
                return True
        holders = self.scheduler.occupied()
        if holders and all(r.priority > req.priority for r in holders):
            return "priority"
        return "pool"

    def _preempt(self, victim: Request) -> None:
        """Evict a RUNNING lane for a higher-priority admission: roll
        back its speculative in-flight rows (overlapped mode — their
        tokens were dispatched but never emitted, and the replay
        recomputes them identically), decref its blocks (shared prefix
        blocks survive by refcount; private ones recycle), and requeue
        it for recompute."""
        if self._inflight is not None:
            for later in self._inflight:
                for row in later.rows:
                    if row.req is victim:
                        row.valid = False
        self.kv.free_request(victim)   # needs the slot requeue() clears
        self.scheduler.requeue(victim)

    # ------------------------------------------------------ prefix reuse

    def _chain_key(self, req: Request) -> tuple:
        """The prefix trie a request may share from: keyed by its
        RESOLVED activation tier, because the effective routed top-k
        changes every layer's hidden states and therefore the K/V a
        token writes — cross-tier sharing would break bitwise
        identity."""
        return (self._tier_k(req),)

    def _prefix_skip(self, req: Request) -> int:
        """Scheduler probe hook: how many prefill tokens admission would
        adopt from the prefix index. Pure lookup; the match is parked
        for _on_admit, which runs before the pool can change."""
        m = self.kv.match_prefix(req.seq_tokens, key=self._chain_key(req))
        self._probe[req.rid] = m
        return 0 if m is None else m.matched

    def _on_admit(self, req: Request) -> None:
        """Scheduler admission hook (reuse on): adopt the probed match
        into the freshly-assigned slot and fast-forward the prefill
        cursor past it — the chunked-prefill resume machinery then
        prefills only the unmatched tail. On a miss, just point the
        slot's chain cursor at the trie root so its full blocks
        register as prefill advances."""
        m = self._probe.pop(req.rid, None)
        self._prefix_prompt_tokens += req.seq_len
        if m is None:
            self.kv.begin_chain(req, key=self._chain_key(req))
            return
        nblocks, cows = self.kv.adopt_prefix(req, m)
        req.prefill_pos = m.matched
        self._prefix_matched_tokens += m.matched
        self._prefix_hits += 1
        self._reused_blocks += nblocks
        self._cow_copies += cows

    # ------------------------------------------------------------- tiers

    def _tier_k(self, req: Request) -> int:
        """The request's RESOLVED activation tier: its effective routed
        top-k, defaulting to K_max (the config top_k)."""
        return req.tier if req.tier is not None else self._k_max

    def _row_k_arg(self, row_k):
        """None unless this run actually mixes tiers — an all-default run
        runs the exact pre-tier path (the uniform-tier parity gate is then
        an identity, not a numerical claim)."""
        return row_k if self._tiered else None

    def _pick_host(self, logits, rids, tidx) -> np.ndarray:
        """Sample on the device and read the tokens back (the sequential
        loop's one host sync per micro-batch)."""
        ex = self.executor
        return self._sampler(logits, ex.to_device(rids, torch.long),
                             ex.to_device(tidx, torch.long)).cpu().numpy()

    def _eff_k(self, active_pairs: int, live: int):
        """Mean live-row k for the backend break-even, or None when the
        run is all-default (policy then reads the static config top_k —
        bitwise the pre-tier decision)."""
        return active_pairs / max(live, 1) if self._tiered else None

    # ------------------------------------------------------ micro-batches

    def _chunk_width(self, w: int) -> int:
        """Pad a chunk micro-batch to the shared planning granule. The
        scheduler charges every planned row this padded width against the
        granule-rounded budget (see Scheduler.plan_prefill), so
        n_rows x padded width never exceeds one budget of compute."""
        g = self._granule
        return min(((w + g - 1) // g) * g, self.max_len)

    def _hist_width(self, start_max: int, w_pad: int) -> int:
        """Gathered prefix window for a chunk micro-batch. All-fresh rows
        (start 0) need exactly the chunk width — the classic whole-prompt
        prefill. Resumed chunks need [0, start + width); that is bucket-
        rounded then grown in powers of two so a long prompt's cursor
        positions compile O(log S) prefill shapes instead of one each."""
        if start_max == 0:
            return w_pad
        b = self.prefill_bucket
        h = ((start_max + w_pad + b - 1) // b) * b
        p = b
        while p < h:
            p *= 2
        return min(p, self.max_len)

    def _prefill_microbatch(self, chunks: list[tuple[Request, int]],
                            step: int) -> None:
        n = len(chunks)
        w_pad = self._chunk_width(max(c for _, c in chunks))
        tokens = np.zeros((n, w_pad), np.int32)
        lengths = np.zeros(n, np.int32)
        slots = np.zeros(n, np.int32)
        starts = np.zeros(n, np.int32)
        rids = np.zeros(n, np.int32)
        tidx = np.zeros(n, np.int32)
        row_k = np.full(n, self._k_max, np.int32)
        active = 0
        for i, (r, c) in enumerate(chunks):
            # seq_tokens = the prompt, or the preemption replay (prompt +
            # emitted tokens); either way the ordinary chunked path
            toks = r.seq_tokens
            tokens[i, :c] = toks[r.prefill_pos:r.prefill_pos + c]
            lengths[i] = c
            slots[i] = r.slot
            starts[i] = r.prefill_pos
            rids[i] = r.rid
            tidx[i] = r.resume_m      # a replay's final logits re-sample
            #   token index resume_m — the stream continues, no duplicate
            row_k[i] = self._tier_k(r)
            active += c * int(row_k[i])
            if r.admit_step < 0:
                r.admit_step = step
            if self.paged:
                # allocate (from the admission reservation) the blocks
                # this chunk's write window [cursor, cursor + c) lands in
                self.kv.ensure(r, r.prefill_pos + c)
        hist = self._hist_width(int(starts.max()), w_pad)
        if self.paged:
            # the prefix window is a block-table lookup: hist rounds up
            # to whole blocks and each row hands the step its first
            # hist // block_size table entries (unallocated tail entries
            # are trash — masked, like padded lane columns)
            nblk = min(self.kv.blocks_for(hist), self.kv.blocks_per_slot)
            tables = np.zeros((n, nblk), np.int32)
            for i, (r, _) in enumerate(chunks):
                tables[i] = self.kv.tables[r.slot, :nblk]
            logits, cache, backend, dropped = self.executor.prefill_paged(
                self.params, self.kv.cache, tokens, tables, lengths,
                starts, row_k=self._row_k_arg(row_k),
                effective_k=self._eff_k(active, int(lengths.sum())))
        else:
            logits, cache, backend, dropped = self.executor.prefill(
                self.params, self.kv.cache, tokens, slots, lengths,
                starts, hist=hist,
                row_k=self._row_k_arg(row_k),
                effective_k=self._eff_k(active, int(lengths.sum())))
        self.kv.cache = cache
        self.backend_log.append((step, "prefill", n * w_pad,
                                 int(lengths.sum()), backend,
                                 int(dropped), active))
        first = self._pick_host(logits, rids, tidx)
        for i, (r, c) in enumerate(chunks):
            r.prefill_pos += c
            self.kv.lengths[r.slot] = r.prefill_pos
            if self.paged:
                self.kv.commit(r)     # register newly-FULL blocks
            if r.prefill_pos == r.seq_len:
                self.scheduler.prefill_done(r)
                if r.first_token_step < 0:
                    r.first_token_step = step
                self._emit(r, int(first[i]), step)

    def _decode_microbatch(self, step: int,
                           piggy: list[tuple[Request, int]]) -> None:
        tokens = np.zeros((self.max_slots, 1), np.int32)
        rids = np.zeros(self.max_slots, np.int32)
        tidx = np.zeros(self.max_slots, np.int32)
        # free lanes keep the default tier: their rows are padding whose
        # routed output no one reads, so any k is correct — K_max keeps
        # the all-default run's row_k literally constant
        row_k = np.full(self.max_slots, self._k_max, np.int32)
        running = 0
        active = 0
        for slot, r in enumerate(self.scheduler.slots):
            if r is not None and r.state == RUNNING:
                tokens[slot, 0] = r.generated[-1]
                rids[slot] = r.rid
                tidx[slot] = len(r.generated)
                row_k[slot] = self._tier_k(r)
                active += int(row_k[slot])
                running += 1
                if self.paged:
                    # the input token's K/V lands at lengths[slot]
                    self.kv.ensure(r, int(self.kv.lengths[slot]) + 1)
        for r, _ in piggy:
            # a width-1 prefill chunk riding the decode dispatch: feed the
            # next sequence token at the slot's cursor; its logits row is
            # the request's next sampled token when the prefill completes
            tokens[r.slot, 0] = r.seq_tokens[r.prefill_pos]
            rids[r.slot] = r.rid
            tidx[r.slot] = r.resume_m
            row_k[r.slot] = self._tier_k(r)
            active += int(row_k[r.slot])
            if r.admit_step < 0:
                r.admit_step = step
            if self.paged:
                self.kv.ensure(r, r.prefill_pos + 1)
        positions = self.kv.positions()
        live = running + len(piggy)
        if self.paged:
            logits, cache, backend, dropped = self.executor.decode_paged(
                self.params, self.kv.cache, tokens, positions,
                self.kv.tables_snapshot(),
                row_k=self._row_k_arg(row_k),
                effective_k=self._eff_k(active, live))
        else:
            logits, cache, backend, dropped = self.executor.decode(
                self.params, self.kv.cache, tokens, positions,
                row_k=self._row_k_arg(row_k),
                effective_k=self._eff_k(active, live))
        self.kv.cache = cache
        self.backend_log.append((step, "decode", self.max_slots,
                                 live, backend, int(dropped), active))
        nxt = self._pick_host(logits, rids, tidx)
        if running:
            # the gap is inter-token latency only for lanes that decoded:
            # a piggyback-only dispatch (no RUNNING lane) pays it for no
            # decode token, so it breaks the chain instead of recording —
            # recording here used to inflate TPOT p50/p95 with stalls no
            # lane paid
            now = time.perf_counter()
            if self._last_decode_t is not None:
                self._decode_gaps.append(now - self._last_decode_t)
            self._last_decode_t = now
        else:
            self._last_decode_t = None
        for slot, r in enumerate(self.scheduler.slots):
            if r is None or r.state != RUNNING:
                continue
            self.kv.lengths[slot] += 1      # the input token's K/V landed
            self._emit(r, int(nxt[slot]), step)
        for r, _ in piggy:
            self.kv.lengths[r.slot] += 1
            r.prefill_pos += 1
            if self.paged:
                self.kv.commit(r)
            if r.prefill_pos == r.seq_len:
                self.scheduler.prefill_done(r)
                if r.first_token_step < 0:
                    r.first_token_step = step
                self._emit(r, int(nxt[r.slot]), step)

    def _emit(self, req: Request, token: int, step: int) -> None:
        req.generated.append(token)
        now = time.perf_counter()
        if len(req.generated) == 1:
            req.first_token_t = now
        req.last_token_t = now
        hit_eos = req.eos_id is not None and token == req.eos_id
        # the next decode would write this token's K/V at position
        # lengths[slot]; finish when that write would fall off the cache
        slot_len = int(self.kv.lengths[req.slot])
        full = slot_len >= self.max_len
        if hit_eos or len(req.generated) >= req.max_new or full:
            if full and not hit_eos and len(req.generated) < req.max_new:
                # the max_len wall clipped the stream before max_new:
                # surface it — a silent finish here misreported clipped
                # requests as complete (paged admission deferrals are
                # surfaced separately, via EngineReport.pool_deferrals)
                req.truncated = True
            self.scheduler.finish(req, step)
            self.kv.free_request(req)

    # ------------------------------------------------- overlapped (fused)

    def _run_fused(self, requests: list[Request],
                   max_steps: int) -> EngineReport:
        """The overlapped loop: one fused ragged dispatch per step, host
        readback lagging one step behind (double buffer). Dispatch-time
        state (plan, positions, max_new/max_len finishes) is
        host-deterministic — it never needs the step's results — so only
        EOS discovery waits for a readback, and only by one step."""
        sched = self.scheduler
        slot_tokens = torch.zeros((self.max_slots,), dtype=torch.int32,
                                  device=self.model.device)
        # tokens dispatched (= sampled on device) per request — runs one
        # step AHEAD of len(r.generated), which counts emissions
        self._disp_counts = {r.rid: 0 for r in requests}
        inflight: deque[_InFlight] = deque()
        self._inflight = inflight      # _preempt rolls back a victim's
        #                                speculative rows through this
        step = busy = peak = 0
        n_disp = n_overlapped = 0
        t0 = time.perf_counter()
        while not (sched.all_done() and not inflight):
            self._stamp_arrivals(requests, step)
            rec = None
            if not sched.all_done():
                rec, slot_tokens, occ = self._dispatch_fused(step,
                                                             slot_tokens)
                busy += occ
                peak = max(peak, occ)
            if rec is not None:
                n_disp += 1
                if inflight:
                    n_overlapped += 1
                if rec.running:
                    now = time.perf_counter()
                    if self._last_dispatch_t is not None:
                        self._dispatch_gaps.append(
                            now - self._last_dispatch_t)
                    self._last_dispatch_t = now
                else:
                    self._last_dispatch_t = None
                inflight.append(rec)
            else:
                self._last_dispatch_t = None
            # double buffer: with a fresh dispatch in flight, read back
            # everything OLDER than it (steady state: exactly the
            # previous step); with nothing dispatched this tick there is
            # nothing to overlap with, so drain fully
            while len(inflight) > (1 if rec is not None else 0):
                self._readback_fused(inflight.popleft(), inflight)
            step += 1
            if step > max_steps:
                raise RuntimeError(f"engine made no progress in "
                                   f"{max_steps} steps")
        wall = time.perf_counter() - t0
        return self._mk_report(requests, step=step, wall=wall, busy=busy,
                               peak=peak,
                               dispatch_gaps=list(self._dispatch_gaps),
                               overlap_occupancy=(n_overlapped /
                                                  max(n_disp, 1)))

    def _dispatch_fused(self, step: int, slot_tokens):
        """Plan, flatten, and dispatch ONE fused ragged micro-batch
        without waiting on its results.

        Returns (record | None, new slot_tokens, occupied lanes). Decode
        rows read their input from the device carry; chunk rows stage
        prompt tokens. max_new/max_len finishes are applied here — they
        are functions of dispatch counts and positions, both host-known —
        but only AFTER every row (and its paged table snapshot) is
        collected: freeing a slot or table mid-collection could hand this
        same dispatch's later rows a recycled cell, and two live rows
        sharing a scatter cell inside one step is the one
        collision the write-before-attend invariant cannot absorb."""
        sched = self.scheduler
        plan = sched.plan_prefill(step)
        rows: list[_FusedRow] = []
        finishes: list[Request] = []
        promotions: list[Request] = []
        running = 0
        for r in sched.active():
            # RUNNING lanes decode one token at their current depth
            pos = int(self.kv.lengths[r.slot])
            if self.paged:
                self.kv.ensure(r, pos + 1)
            idx = self._disp_counts[r.rid]
            rows.append(_FusedRow(req=r, kind="decode", slot=r.slot,
                                  pos=pos, base=0, use_prev=True,
                                  tidx=idx, carry=True))
            self.kv.lengths[r.slot] = pos + 1
            self._disp_counts[r.rid] = idx + 1
            running += 1
            full = pos + 1 >= self.max_len
            if idx + 1 >= r.max_new or full:
                if full and idx + 1 < r.max_new:
                    # speculative: readback clears it if this very token
                    # (or an in-flight earlier one) turns out to be EOS
                    r.truncated = True
                finishes.append(r)
        for r, c in plan:
            # a planned chunk contributes c width-1 rows at consecutive
            # positions — the generalized piggyback: no separate prefill
            # micro-batch shape exists in this loop
            if r.admit_step < 0:
                r.admit_step = step
            if self.paged:
                self.kv.ensure(r, r.prefill_pos + c)
            toks = r.seq_tokens      # prompt, or the preemption replay
            for j in range(c):
                pos = r.prefill_pos + j
                last = pos == r.seq_len - 1
                rows.append(_FusedRow(req=r,
                                      kind="first" if last else "mid",
                                      slot=r.slot, pos=pos,
                                      base=int(toks[pos]),
                                      use_prev=False,
                                      tidx=r.resume_m if last else 0,
                                      carry=last))
            r.prefill_pos += c
            self.kv.lengths[r.slot] = r.prefill_pos
            if self.paged:
                self.kv.commit(r)
            if r.prefill_pos == r.seq_len:
                promotions.append(r)
                # dispatch count continues across a preemption: resume_m
                # tokens were emitted before the eviction, and the
                # "first" row above just re-dispatched index resume_m
                self._disp_counts[r.rid] = r.resume_m + 1
                full = r.seq_len >= self.max_len
                if r.resume_m + 1 >= r.max_new or full:
                    if full and r.resume_m + 1 < r.max_new:
                        r.truncated = True
                    finishes.append(r)
        occupied = len(sched.occupied())
        if not rows:
            return None, slot_tokens, occupied
        n = len(rows)
        g = self._row_granule
        rp = -(-n // g) * g
        base = np.zeros(rp, np.int32)
        use_prev = np.zeros(rp, bool)
        slots = np.zeros(rp, np.int32)
        pos_a = np.zeros(rp, np.int32)
        rids = np.zeros(rp, np.int32)
        tidx = np.zeros(rp, np.int32)
        carry = np.zeros(rp, bool)
        row_k = np.full(rp, self._k_max, np.int32)
        for i, row in enumerate(rows):
            base[i] = row.base
            use_prev[i] = row.use_prev
            slots[i] = row.slot
            pos_a[i] = row.pos
            rids[i] = row.req.rid
            tidx[i] = row.tidx
            carry[i] = row.carry
            row_k[i] = self._tier_k(row.req)
        active = int(row_k[:n].sum())
        # padding rows duplicate row 0 — same scatter cell, same value, a
        # no-op rewrite — with carry=False so they never touch the token
        # carry (and their sampled rows are simply never read); row 0's
        # tier rides along so the padded row_k vector stays a function of
        # the real rows only
        base[n:] = base[0]
        use_prev[n:] = use_prev[0]
        slots[n:] = slots[0]
        pos_a[n:] = pos_a[0]
        rids[n:] = rids[0]
        tidx[n:] = tidx[0]
        row_k[n:] = row_k[0]
        if self.paged:
            tables = self.kv.table_rows(slots)
            nxt, slot_tokens, cache, backend, dropped = \
                self.executor.step_fused_paged(
                    self.params, self.kv.cache, base, use_prev,
                    slot_tokens, slots, tables, pos_a, rids, tidx, carry,
                    row_k=self._row_k_arg(row_k),
                    effective_k=self._eff_k(active, n))
        else:
            nxt, slot_tokens, cache, backend, dropped = \
                self.executor.step_fused(
                    self.params, self.kv.cache, base, use_prev,
                    slot_tokens, slots, pos_a, rids, tidx, carry,
                    row_k=self._row_k_arg(row_k),
                    effective_k=self._eff_k(active, n))
        self.kv.cache = cache
        # start step t's readback now; it is waited on only after step
        # t+1 has been dispatched
        packed = torch.cat([nxt, dropped.reshape(1).to(torch.int32)])
        ready = None
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host = packed
        for r in promotions:
            sched.prefill_done(r)
        for r in finishes:
            sched.finish(r, step)
            self.kv.free_request(r)
        return (_InFlight(step=step, host=host, ready=ready, rows=rows,
                          running=running, padded=rp, live=n,
                          backend=backend, active_pairs=active),
                slot_tokens, occupied)

    def _readback_fused(self, rec: _InFlight,
                        inflight: "deque[_InFlight]") -> None:
        """Read one lagged step's device results and apply the host
        effects the dispatch speculated past: emission (and wall-clock
        TTFT), the backend_log row (its dropped column is a device scalar
        until here), completion-gap accounting, and EOS finishes."""
        if rec.ready is not None:
            rec.ready.synchronize()         # the one host sync per step
        host = rec.host.numpy()
        nxt = host[:-1]
        now = time.perf_counter()
        self.backend_log.append((rec.step, "decode", rec.padded, rec.live,
                                 rec.backend, int(host[-1]),
                                 rec.active_pairs))
        if rec.running:
            if self._last_decode_t is not None:
                self._decode_gaps.append(now - self._last_decode_t)
            self._last_decode_t = now
        else:
            self._last_decode_t = None
        for i, row in enumerate(rec.rows):
            if row.kind == "mid" or not row.valid:
                continue
            r = row.req
            tok = int(nxt[i])
            if row.kind == "first" and r.first_token_step < 0:
                # a resumed request's "first" row is its replay
                # completion — the original first-token stamps stand
                r.first_token_step = rec.step
                r.first_token_t = now
            r.generated.append(tok)
            r.last_token_t = now
            if r.eos_id is not None and tok == r.eos_id:
                self._eos_rollback(r, rec.step, inflight)

    def _eos_rollback(self, r: Request, step: int,
                      inflight: "deque[_InFlight]") -> None:
        """EOS surfaced one step late. The lane may already have a
        speculative row in the newer in-flight dispatch — invalidate it
        (its device writes land at positions/blocks past the finished
        stream or in freed cells; masks stop at valid lengths and the
        next tenant overwrites before attending, so they are garbage no
        one reads) — and finish the request now unless the dispatch-time
        state machine already finished it for max_new/max_len on this
        same token (then only the speculative `truncated` flag and the
        finish step need correcting)."""
        r.truncated = False
        for later in inflight:
            for row in later.rows:
                if row.req is r:
                    row.valid = False
        if r.state == RUNNING:
            self.scheduler.finish(r, step)
            self.kv.free_request(r)
        else:
            r.finish_step = step
