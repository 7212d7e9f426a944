"""Per-request state for the serving engine."""
from __future__ import annotations

import dataclasses
from typing import Optional

QUEUED = "queued"
PREFILLING = "prefilling"     # admitted to a slot, prompt partially in cache
RUNNING = "running"           # prompt fully prefilled, decoding
FINISHED = "finished"

# Lifecycle with preemption: a PREFILLING/RUNNING request evicted under
# pool pressure goes BACK to QUEUED with its private blocks freed; on
# re-admission it re-prefills prompt + already-emitted tokens (the
# ``prefill_tokens`` replay) and resumes decoding where it left off —
# token-identical to the unpreempted stream, because prefill is width-
# invariant and sampling is keyed by (rid, token index).


@dataclasses.dataclass
class Request:
    """One generation request.

    The caller fills the first block (identity + workload); the engine
    owns the runtime block and resets it at the start of every run, so a
    request list can be replayed (benchmark warm-up reruns).

    Lifecycle: QUEUED -> PREFILLING -> RUNNING -> FINISHED. A request
    sits in PREFILLING while its prompt is fed to the cache in per-step
    chunks bounded by the scheduler's ``max_prefill_tokens`` budget;
    ``prefill_pos`` is the progress cursor (prompt tokens already written
    to the KV cache). When the budget is unlimited the whole prompt is
    one chunk and the state passes through PREFILLING within a single
    engine step.
    """
    rid: int
    prompt: list[int]
    max_new: int                      # tokens to generate (incl. the first)
    arrival: float = 0.0              # due time, in engine steps
    eos_id: Optional[int] = None
    tier: Optional[int] = None        # activation TIER: the effective
    #   routed top-k this request runs at, in [1, K_max] where K_max is
    #   the model's config top_k (the DEFAULT tier — None means K_max).
    #   k is routing DATA, not shape: mixed tiers co-batch into the same
    #   compiled step, so picking an operating point of the converted
    #   weight family is a per-request knob, not a model swap. Part of
    #   the caller's identity block — reset() preserves it.
    priority: int = 0                 # SLO priority class (higher wins).
    #   Admission orders due requests by (priority desc, arrival, rid) —
    #   all-default-priority runs keep the exact FIFO order — and under
    #   paged pool pressure a due higher-priority request may PREEMPT
    #   the lowest-priority RUNNING lane instead of deferring behind it.
    #   Part of the caller's identity block — reset() preserves it.

    # --- runtime (engine-owned) ---
    state: str = QUEUED
    slot: int = -1
    generated: list[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0              # prompt tokens already in the cache
    admit_step: int = -1              # step the request got its slot
    first_token_step: int = -1        # step the first token was sampled
    arrival_t: float = -1.0           # wall clock the request became due
    first_token_t: float = -1.0       # wall clock the first token was
    #   EMITTED (host-visible) — under the overlapped engine this lags
    #   the sampling dispatch by one step, which is exactly the latency
    #   a client would see; ttft_p50_s/p95_s on EngineReport use these
    last_token_t: float = -1.0        # wall clock of the most recent
    #   emission — (last - first) / (tokens - 1) is the request's own
    #   mean TPOT, which EngineReport.tier_metrics() aggregates per tier
    finish_step: int = -1
    truncated: bool = False           # finished because the slot hit
    #   max_len before max_new (and before EOS) — surfaced on
    #   EngineReport.summary(), never a silent early finish
    prefill_tokens: Optional[list] = None   # PREEMPTION REPLAY: the
    #   token sequence to (re-)prefill — prompt + every token emitted
    #   before the eviction. None (the normal case) means the prompt
    #   itself; the engine reads prompts only through seq_tokens/seq_len
    #   so a resumed request re-enters the ordinary chunked-prefill path.
    preemptions: int = 0              # times this request was evicted
    #   and re-queued for recompute (aggregated on EngineReport)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def seq_tokens(self) -> list:
        """The sequence prefill must put in the cache: the prompt, or —
        after a preemption — the prompt plus the already-emitted tokens
        (recompute replay). The last replayed token's logits re-sample
        token index ``resume_m`` (keyed sampling), so the stream resumes
        with a NEW token and no emission is duplicated."""
        return self.prefill_tokens if self.prefill_tokens is not None \
            else self.prompt

    @property
    def seq_len(self) -> int:
        return len(self.seq_tokens)

    @property
    def resume_m(self) -> int:
        """Tokens already emitted when the prefill replay was snapshot:
        the sampling token-index the resumed stream continues from (0
        for a never-preempted request)."""
        return 0 if self.prefill_tokens is None \
            else len(self.prefill_tokens) - len(self.prompt)

    @property
    def done(self) -> bool:
        return self.state == FINISHED

    def reset(self) -> None:
        self.state = QUEUED
        self.slot = -1
        self.generated = []
        self.prefill_pos = 0
        self.admit_step = -1
        self.first_token_step = -1
        self.arrival_t = -1.0
        self.first_token_t = -1.0
        self.last_token_t = -1.0
        self.finish_step = -1
        self.truncated = False
        self.prefill_tokens = None
        self.preemptions = 0
