"""Request scheduler: admission queue, slot table, chunked-prefill plan.

Pure host-side bookkeeping — no jax. The engine drives it with an integer
step clock: ``plan_prefill(now)`` resumes partially-prefilled requests and
hands out free slots to due requests — ordered by (priority desc, arrival,
rid), which is the exact historical FIFO whenever every request carries
the default priority 0 — splitting prompts into per-step chunks bounded by
``max_prefill_tokens``; ``prefill_done(req)`` promotes a fully-prefilled
request to a decode lane; ``finish(req, step)`` recycles the slot for the
next admission; ``requeue(req)`` is the PREEMPTION path — a RUNNING lane
evicted under pool pressure goes back to the due queue with a recompute
replay (prompt + emitted tokens) and re-enters through the ordinary
admission/chunked-prefill machinery.

Admission beyond slot availability is delegated through ``admission_gate``
(the paged engine's pool-headroom reservation, and — with priorities — its
preemption policy): the gate returns True to admit or a CAUSE string to
defer ("pool" = no headroom and nothing strictly lower-priority to
preempt; "priority" = every pool holder strictly outranks the head).
Deferrals are head-blocking — nothing behind the highest-priority due
request may jump it — and are counted per cause in ``deferral_causes``
(total in ``gate_deferrals``), never a silent drop.

Under the OVERLAPPED engine the clock is DISPATCH time: promotions and
max_new/max_len finishes are applied the step their last token is
dispatched (host-deterministic, no device sync), so a freed slot is
re-admittable one step earlier than its tokens are host-visible; only an
EOS finish arrives a step late, via the engine's readback rollback. The
scheduler itself is oblivious — the same plan/promote/finish calls, made
at dispatch instead of completion.

Data structures are O(log max_slots) per admission: free slots live in a
min-heap (lowest slot index first, matching the historical fill order) and
the pending queue is an arrival-sorted deque popped from the left.

ACTIVATION TIERS are invisible here by design: a request's effective
routed top-k (``Request.tier``) is routing data the engine threads into
the dispatch as a per-row vector, not a shape — so mixed tiers co-batch
into the same plan, the same slots, the same fused step, and the
scheduler needs no tier-aware queueing for co-batching to be free.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Optional

from repro_torch.serving.request import (FINISHED, PREFILLING, QUEUED, RUNNING,
                                   Request)

POLICIES = ("continuous", "static")


class Scheduler:
    """Slot-table scheduler with a chunked-prefill planner.

    policy:
      continuous — a freed slot is reusable at the very next admission
          (the engine's normal mode).
      static     — admit only when ALL slots are free: the fixed-batch
          baseline, where a batch drains fully (its slowest request)
          before the next batch starts. Same machinery, same compiled
          step functions — the honest comparison for the goodput bench.

    max_prefill_tokens is a TRUE per-step budget on prefill COMPUTE, the
    first admitted request included. A prompt longer than the budget is
    split into per-step chunks (request state PREFILLING, progress cursor
    ``Request.prefill_pos``) which the engine interleaves with decode —
    so a long prompt can never stall decode lanes for more than one
    budget's worth of prefill compute, yet every step with pending work
    still makes progress (the first planned chunk is never empty).
    Partially-prefilled requests are resumed, in admission order, before
    any new request is admitted. None = unlimited (whole prompts are
    planned as single chunks).

    prefill_granule is the engine's micro-batch padding unit: every
    planned row is padded to the widest chunk's granule-rounded width, so
    the plan charges each row that PADDED width and caps the total at the
    granule-rounded budget — n_rows x padded_width never exceeds
    round_up(max_prefill_tokens, granule), which is exactly the budget
    whenever the budget is a granule multiple (sum of REAL chunk tokens
    is capped by the same bound). The first chunk sets the step's width
    class (up to the whole budget — a resumed long prompt comes first and
    gets full throughput); later rows are capped at that width.
    """

    def __init__(self, max_slots: int, *, policy: str = "continuous",
                 max_prefill_tokens: Optional[int] = None,
                 prefill_granule: int = 1):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if max_prefill_tokens is not None and max_prefill_tokens < 1:
            raise ValueError("max_prefill_tokens must be >= 1")
        if prefill_granule < 1:
            raise ValueError("prefill_granule must be >= 1")
        self.max_slots = max_slots
        self.policy = policy
        self.max_prefill_tokens = max_prefill_tokens
        self.prefill_granule = prefill_granule
        # optional admission gate beyond slot availability (the paged
        # engine's pool-headroom reservation + preemption policy: returns
        # True to admit, or a cause string — "pool" / "priority" — to
        # DEFER the head request; plain False is accepted as "pool" for
        # older gates. Must be idempotent, because a deferred or
        # budget-stalled head is re-gated on the next plan). Set by the
        # engine per run — reset() preserves it.
        self.admission_gate = None
        # prefix-reuse admission hooks (paged engine, reuse on):
        #   prefix_skip(req) -> int   tokens the engine will fast-forward
        #       at admission (a PURE cache probe — called before the
        #       chunk budget is charged, so matched tokens cost nothing)
        #   on_admit(req)             called right after the slot is
        #       assigned; the engine adopts the matched blocks and
        #       fast-forwards req.prefill_pos to the probed skip
        self.prefix_skip = None
        self.on_admit = None
        self.reset()

    def reset(self) -> None:
        self.pending: deque[Request] = deque()
        # DUE requests, ordered (priority desc, arrival, rid): plan moves
        # arrived pending requests here, so priority only ever reorders
        # requests that are simultaneously waiting — it never sees the
        # future. All-default-priority runs pop in exact FIFO order.
        self._due: list[tuple] = []
        self.slots: list[Optional[Request]] = [None] * self.max_slots
        self._free_heap = list(range(self.max_slots))   # sorted == heapified
        self.prefilling: list[Request] = []             # admission order
        self.num_admitted = 0
        self.slot_reuse = 0            # admissions into a previously-used slot
        self.gate_deferrals = 0        # plans where the admission gate
        #   deferred a due request a free slot was available for —
        #   totalled here, split per cause in deferral_causes ("pool" =
        #   headroom exhaustion, "priority" = outranked by every pool
        #   holder); surfaced via EngineReport, never a silent drop
        self.deferral_causes: dict[str, int] = {}
        self.preemptions = 0           # RUNNING lanes evicted + requeued
        self._slot_used = [False] * self.max_slots

    # ------------------------------------------------------------- queue

    def submit(self, requests) -> None:
        for r in requests:
            if r.state != QUEUED:
                raise ValueError(f"request {r.rid} already {r.state}")
        merged = sorted([*self.pending, *requests],
                        key=lambda r: (r.arrival, r.rid))
        self.pending = deque(merged)

    @property
    def free_slots(self) -> list[int]:
        return sorted(self._free_heap)

    def occupied(self) -> list[Request]:
        """Requests holding a slot (PREFILLING or RUNNING)."""
        return [r for r in self.slots if r is not None]

    def active(self) -> list[Request]:
        """Decode lanes: slot-holding requests whose prompt is fully in
        the cache."""
        return [r for r in self.slots
                if r is not None and r.state == RUNNING]

    def all_done(self) -> bool:
        return not self.pending and not self._due and not self.occupied()

    # --------------------------------------------------------- admission

    def plan_prefill(self, now: float) -> list[tuple[Request, int]]:
        """This step's prefill plan: [(request, chunk_len)]. Each chunk
        covers prompt positions [r.prefill_pos, r.prefill_pos +
        chunk_len); the engine advances the cursor after executing it.
        Partially-prefilled requests come first (admission order), then
        due pending requests are admitted into free slots while budget
        remains.

        Budget accounting charges PADDED compute (see class docstring):
        the first chunk may span up to the whole budget and fixes the
        step's row width w = round_up(chunk, granule); every further row
        is capped at w tokens and charged w, and rows stop when the
        charges reach round_up(budget, granule) — so the executed
        micro-batch (n rows right-padded to w) never exceeds one
        granule-rounded budget of tokens."""
        budget = self.max_prefill_tokens
        g = self.prefill_granule
        budget_pad = None if budget is None else ((budget + g - 1) // g) * g
        state = {"w_cap": 0, "used": 0}

        def take(remaining: int) -> int:
            """Chunk length for a row with `remaining` prompt tokens, or
            0 when the step's padded budget is exhausted."""
            if budget is None:
                return remaining
            if state["w_cap"] == 0:                    # first row: sets w
                chunk = min(remaining, budget)
                state["w_cap"] = ((chunk + g - 1) // g) * g
            else:
                chunk = min(remaining, state["w_cap"])
            if state["used"] + state["w_cap"] > budget_pad:
                return 0
            state["used"] += state["w_cap"]
            return chunk

        plan: list[tuple[Request, int]] = []
        for r in self.prefilling:
            chunk = take(r.seq_len - r.prefill_pos)
            if chunk == 0:
                break
            plan.append((r, chunk))
        if self.policy == "static" and self.occupied():
            return plan
        while self.pending and self.pending[0].arrival <= now:
            r = self.pending.popleft()
            heapq.heappush(self._due, (-r.priority, r.arrival, r.rid, r))
        while self._due and self._free_heap:
            head = self._due[0][3]
            # gate BEFORE charging the budget: a gate-passed reservation
            # is idempotent, so a head that then stalls on budget is
            # simply re-admitted (reservation intact) next plan. The
            # gate may PREEMPT a lower-priority RUNNING lane to make
            # headroom (requeue() below) — safe mid-loop, because
            # RUNNING lanes are never in this step's plan rows.
            if self.admission_gate is not None:
                verdict = self.admission_gate(head)
                if verdict is not True:
                    cause = verdict if isinstance(verdict, str) else "pool"
                    self.gate_deferrals += 1
                    self.deferral_causes[cause] = \
                        self.deferral_causes.get(cause, 0) + 1
                    break          # head-blocking: nothing may jump it
            # matched prefix tokens are adopted, not prefilled — charge
            # the budget only for the unmatched tail (probe is pure; the
            # pool is untouched between probe and the on_admit adoption)
            skip = self.prefix_skip(head) if self.prefix_skip else 0
            chunk = take(head.seq_len - skip)
            if chunk == 0:
                break
            heapq.heappop(self._due)
            req = head
            slot = heapq.heappop(self._free_heap)
            req.slot = slot
            req.state = PREFILLING
            req.prefill_pos = 0
            self.slots[slot] = req
            self.prefilling.append(req)
            if self._slot_used[slot]:
                self.slot_reuse += 1
            self._slot_used[slot] = True
            self.num_admitted += 1
            if self.on_admit is not None:
                self.on_admit(req)
            plan.append((req, chunk))
        return plan

    def prefill_done(self, req: Request) -> None:
        """Prompt fully in the cache: PREFILLING -> RUNNING decode lane."""
        if req.state != PREFILLING:
            raise ValueError(f"request {req.rid} is {req.state}")
        self.prefilling.remove(req)
        req.state = RUNNING

    def finish(self, req: Request, step: int) -> None:
        if self.slots[req.slot] is not req:
            raise ValueError(f"request {req.rid} does not own slot "
                             f"{req.slot}")
        self.slots[req.slot] = None
        heapq.heappush(self._free_heap, req.slot)
        req.state = FINISHED
        req.finish_step = step

    # -------------------------------------------------------- preemption

    def preemption_victim(self, priority: int) -> Optional[Request]:
        """The lane a due request of ``priority`` may evict: the lowest-
        priority RUNNING request STRICTLY below it (ties broken toward
        the latest arrival, then highest rid — evict the newest work,
        it has the least sunk compute). None when nothing qualifies.
        PREFILLING lanes are never victims: they may already own rows in
        the step's prefill plan."""
        best = None
        for r in self.slots:
            if r is None or r.state != RUNNING or r.priority >= priority:
                continue
            if best is None or (r.priority, -r.arrival, -r.rid) < \
                    (best.priority, -best.arrival, -best.rid):
                best = r
        return best

    def requeue(self, req: Request) -> None:
        """Evict a RUNNING lane back to the due queue for RECOMPUTE: the
        replay sequence (prompt + every emitted token) becomes its
        prefill, so on re-admission it flows through the ordinary
        chunked-prefill path and resumes decoding token-identically
        (width-invariant prefill + keyed sampling). The caller frees the
        lane's cache state FIRST — free_request needs the slot id this
        method clears."""
        if self.slots[req.slot] is not req:
            raise ValueError(f"request {req.rid} does not own slot "
                             f"{req.slot}")
        if req.state != RUNNING:
            raise ValueError(f"request {req.rid} is {req.state}, only "
                             "RUNNING lanes are preemptible")
        self.slots[req.slot] = None
        heapq.heappush(self._free_heap, req.slot)
        req.state = QUEUED
        req.slot = -1
        req.prefill_tokens = list(req.prompt) + list(req.generated)
        req.prefill_pos = 0
        req.preemptions += 1
        self.preemptions += 1
        heapq.heappush(self._due, (-req.priority, req.arrival, req.rid,
                                   req))
