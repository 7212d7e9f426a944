"""KV cache state for the serving engine: contiguous slot lanes or a
refcounted, content-addressed paged block pool.

Port of ``repro/serving/cache.py``. The bookkeeping is the reference's,
line for line; the device state is torch tensors that the executor and the
copy-on-write copy update IN PLACE (the reference threads updated copies
through jitted functions).

Two layouts, one masking contract. Every cache family this engine serves
(GQA K/V, MLA latent) stacks layers at axis 0:

``SlotKVCache`` — contiguous lanes (L, B, max_len, ...): a "slot" is one
    batch lane; gather/scatter over axis 1 move a micro-batch's slot rows
    in and out of the global cache around the executor's step.
    Every request owns a full max_len lane for its lifetime, so one long
    request dictates the HBM footprint of every short one.

``PagedKVCache`` — a flat pool (L, 1 + num_blocks, block_size, ...) plus
    a per-slot BLOCK TABLE: lane b's logical block j lives in physical
    block ``tables[b, j]``. Blocks are allocated lazily as a lane's
    length crosses block boundaries, so a request's HBM footprint is
    ceil(len / block_size) blocks — not max_len — and admission is gated
    on POOL HEADROOM (rid-keyed reservations of the request's worst-case
    block count), never on slot count alone. Physical block 0 is the
    TRASH block: unallocated table entries point at it, so dummy decode
    writes from free lanes and padded chunk-tail spills land there
    (finite garbage no mask can reach). The trash block is never hashed,
    refcounted, or recycled.

ALLOCATION PROTOCOL (refcounted / copy-on-write). Every physical block
except trash carries a REFCOUNT — the number of slot-table entries
pointing at it. Recycling is a DECREF, not a free: ``free_request``
decrements each of the request's table entries, and only a block whose
count reaches zero leaves circulation — to the free list, or (when the
block is registered in the prefix index, below) to a resurrectable
CACHED set that allocation reclaims LRU-first when the free list runs
dry. A block is therefore in exactly one of three states — free, cached
(refcount 0 but content-addressable), or allocated (refcount >= 1) —
and ``audit()`` checks the conservation law free + cached + allocated ==
num_blocks plus refcount == table-entry-count per block (the hypothesis
property in the JAX package's tests/test_prefix_reuse.py drives random
admit/ensure/adopt/free/preempt sequences against it).

PREFIX SHARING (``reuse=True``). Full (immutable) blocks written by
prefill are content-addressed: ``commit`` registers each newly-FULL
block of a slot's sequence in a radix trie keyed by its token-id chain
from position 0 (so a hit is positionally exact — same tokens at the
same absolute positions ⇒ bitwise-identical K/V, by the engine's
width-invariance contract). A chain key (the engine passes the resolved
activation tier) separates sequences whose K/V would differ for equal
tokens. ``match_prefix`` walks a new request's prompt down the trie —
full-block hits first, then at the divergence point the longest
token-level partial match against any child block — and
``adopt_prefix`` points the request's table at the matched blocks:
full-block hits are SHARED (incref, zero copy, zero recompute);
a partial tail hit is COPY-ON-WRITE — the source block is copied into a
fresh private block (one device copy) because the request will
write its own divergent tokens into the remainder, and a shared block
is never written. The last, partial block of any sequence is always
private. At most seq_len - 1 tokens ever match: the final prompt token
is always prefilled, because its logits sample the first output token.

Recycling a slot is a DECREF of its blocks (paged) or a length reset
(contiguous), never a wipe: attention masks stop at each slot's valid
depth, and a lane writes position p before any query can attend it, so
K/V left behind by a previous occupant — in a recycled lane or a
recycled block — is never read. Cached/shared blocks are the deliberate
exception: their content is valid by construction (registered only when
full and immutable, evicted from the index before any reuse as a fresh
block). (tests/test_torch_serving.py proves paged == contiguous,
reuse-on == reuse-off and preempted == unpressured token parity for the
port; the JAX package's tests/test_paged.py and test_prefix_reuse.py
prove the same bookkeeping over fragmented pools.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import tree_map


def _col_index(slot_idx, width: int, start) -> tuple:
    """(rows (n, 1), cols (n, width)) index tensors of each row's window
    [start[i], start[i] + width)."""
    slot_idx = torch.as_tensor(slot_idx)
    start = torch.as_tensor(start, device=slot_idx.device)
    rows = slot_idx.long()[:, None]
    cols = start.long()[:, None] + torch.arange(width,
                                                device=slot_idx.device)
    return rows, cols


def gather_slots(cache, slot_idx, width: int | None = None, start=None):
    """Pull slot rows out of every cache leaf: (L, B, ...) -> (L, n, ...),
    a copy.

    width limits the sequence axis (axis 2: (L, B, T, KH, hd)) to `width`
    entries. With start=None that is the PREFIX window [0, width): a
    prefill chunk at per-slot positions p attends the whole already-filled
    prefix, so the executor gathers [0, hist) with hist >= max(p) + chunk
    width instead of the full max_len column range. `start` (n,) shifts
    each row's window to [start[i], start[i] + width) — the chunked-prefill
    WRITE window, used to slice a chunk's freshly written columns out of
    the updated sub-cache (out-of-range columns clamp; the engine only
    reads windows it wrote)."""
    slot_idx = torch.as_tensor(slot_idx).long()
    if width is None:
        return tree_map(lambda a: a[:, slot_idx], cache)
    if start is None:
        return tree_map(lambda a: a[:, slot_idx, :width], cache)
    rows, cols = _col_index(slot_idx, width, start)
    return tree_map(lambda a: a[:, rows, cols.clamp(max=a.shape[2] - 1)],
                    cache)


def scatter_slots(cache, slot_idx, sub, width: int | None = None,
                  start=None):
    """Write gathered rows back IN PLACE (the JAX reference returns an
    updated copy): the inverse of gather_slots. Returns the cache.

    With `start`, row i of `sub` lands in columns [start[i], start[i] +
    width) of its slot lane; columns past max_len are dropped (a padded
    chunk tail may spill; those entries are rewritten by the slot's next
    chunk or decode step before any mask can reach them). `start` is a
    host array here, so the dropped cells are cut on the host and no
    device value is read back."""
    slot_idx = torch.as_tensor(slot_idx).long()
    leaves_c = cache
    if width is None:
        for a, s in zip(leaves_c, sub):
            a[:, slot_idx] = s
        return cache
    if start is None:
        for a, s in zip(leaves_c, sub):
            a[:, slot_idx, :width] = s
        return cache
    start = np.asarray(start)
    t = cache[0].shape[2]
    cols = start[:, None] + np.arange(width)
    ri, ci = np.nonzero(cols < t)                   # kept (row, column)
    dev = cache[0].device
    rows_t = slot_idx.to(dev)[torch.as_tensor(ri, device=dev)]
    cols_t = torch.as_tensor(cols[ri, ci], device=dev)
    ri_t = torch.as_tensor(ri, device=dev)
    ci_t = torch.as_tensor(ci, device=dev)
    for a, s in zip(leaves_c, sub):
        a[:, rows_t, cols_t] = s[:, ri_t, ci_t]
    return cache


class SlotKVCache:
    """The global cache plus host-side per-slot bookkeeping.

    ``lengths[i]`` is slot i's valid depth — the next write position. The
    engine advances it after each prefill/decode write; ``free`` resets it
    to recycle the slot.

    CAUTION: never hand ``lengths`` itself to a step — ``torch.from_numpy``
    ALIASES the host buffer, and mutating it (``lengths += 1``) would race
    an asynchronously dispatched copy. ``positions()`` returns the copy to
    hand to the device.
    """

    def __init__(self, model, max_slots: int, max_len: int):
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = model.init_cache(max_slots, max_len)
        self.lengths = np.zeros(max_slots, np.int32)

    def free(self, slot: int) -> None:
        self.lengths[slot] = 0

    def free_request(self, req) -> None:
        """Uniform recycling entry shared with PagedKVCache."""
        self.free(req.slot)

    def positions(self) -> np.ndarray:
        """Per-slot write positions for a full-width decode step."""
        return self.lengths.copy()


@dataclasses.dataclass
class PrefixMatch:
    """One ``match_prefix`` result, handed back to ``adopt_prefix``.

    ``blocks`` are FULL-block hits (shared by incref, in chain order);
    ``cow`` is an optional (source block, valid tokens) partial tail hit
    the adopter copies into a private block; ``node`` is the trie
    position after the full-block walk (where the slot's chain resumes
    registration); ``matched`` counts skipped prefill tokens. A match is
    only valid against an unmodified pool: probe and adopt with no
    allocation, free, or eviction in between (the scheduler's admission
    hook sequence guarantees this)."""
    key: tuple
    blocks: list
    node: dict
    cow: Optional[tuple]
    matched: int


class PagedKVCache:
    """A refcounted block pool + per-slot block tables + rid-keyed
    reservations + (``reuse=True``) a content-addressed prefix index.

    The device state is ``cache`` — every leaf (L, 1 + num_blocks,
    block_size, ...), physical block 0 reserved as the trash block — and
    the host state is:

    ``tables``   (max_slots, blocks_per_slot) int32 — lane b's logical
                 block j is physical block tables[b, j]; 0 marks a not-
                 yet-allocated entry (reads through it hit trash, which
                 masks never attend).
    ``lengths``  per-slot valid depth, exactly as in SlotKVCache.
    ``refcount`` per-block table-entry count — the allocation state
                 machine (free / cached / allocated) the module
                 docstring describes. Shared prefix blocks hold one
                 count per adopting lane, so a finish (or preemption)
                 by one sharer never invalidates the others: recycling
                 is a decref, and only count zero leaves circulation.
    ``reserve/ensure/free_request`` — the allocation protocol. The engine
                 RESERVES a request's worst-case block count at admission
                 (`reserve` is the scheduler's admission gate: it fails —
                 deferring the request — when the pool lacks headroom,
                 and is idempotent per rid so a retried admission never
                 double-books). Blocks are then ALLOCATED lazily from the
                 free list (falling back to LRU eviction of cached
                 blocks) by `ensure(req, upto)` at chunk/decode
                 boundaries; because a request's table entries (shared
                 adoptions included) never exceed its reservation and
                 reservations never exceed the pool, allocation provably
                 cannot fail mid-flight — pool pressure surfaces as
                 admission deferrals or priority preemption, never as a
                 dropped or stalled running lane. `free_request` DECREFS
                 the blocks and releases the reservation.
    ``match_prefix/adopt_prefix/commit`` — the prefix-sharing protocol
                 (see the module docstring): probe the trie, point a new
                 table at shared blocks (+ at most one COW copy), and
                 register newly-full blocks as the prefill cursor
                 advances.

    The same CAUTION as SlotKVCache applies to ``lengths`` AND
    ``tables``: both are mutated between steps, so hand the device the
    ``positions()`` / ``tables_snapshot()`` copies, never the live
    arrays.
    """

    def __init__(self, model, max_slots: int, max_len: int, *,
                 block_size: int = 16, num_blocks: int | None = None,
                 reuse: bool = False):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.max_slots = max_slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = -(-max_len // block_size)
        if num_blocks is None:
            # default: the same token capacity as max_slots contiguous
            # lanes (the interesting configs pass fewer blocks)
            num_blocks = max_slots * self.blocks_per_slot
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        self.num_blocks = num_blocks
        self.reuse = reuse
        self.cache = model.init_paged_cache(num_blocks + 1, block_size)
        self.tables = np.zeros((max_slots, self.blocks_per_slot), np.int32)
        self.nalloc = np.zeros(max_slots, np.int32)
        self.lengths = np.zeros(max_slots, np.int32)
        # list.pop() takes the tail: blocks hand out 1, 2, 3, ... on a
        # fresh pool, then most-recently-freed first (LIFO)
        self._free = list(range(num_blocks, 0, -1))
        self._reserved: dict[int, int] = {}          # rid -> block count
        self.reserved_blocks = 0
        # --- refcounts + prefix index (all no-ops while reuse is False
        # except the refcounts themselves, which are the uniform
        # recycling protocol) ---
        self.refcount = np.zeros(num_blocks + 1, np.int32)
        self._cached: dict[int, None] = {}   # refcount-0 registered blocks,
        #   insertion-ordered: reclaimed LRU-first when _free runs dry
        self._tries: dict[tuple, dict] = {}  # chain key -> root children
        #   node = children dict: token-id tuple -> (block, child node)
        self._reg: dict[int, tuple] = {}     # block -> (parent children
        #   dict, its token tuple, its own children dict) — the reverse
        #   map eviction uses to unregister
        self._node: list = [None] * max_slots   # per-slot chain cursor:
        #   the children dict the slot's NEXT full block registers into
        self._nreg = np.zeros(max_slots, np.int32)  # full blocks walked

    # ------------------------------------------------------- reservations

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    @property
    def headroom(self) -> int:
        """Blocks not yet promised to any admitted/deferred-head request.
        Cached (refcount-0, resurrectable) blocks do NOT reduce headroom:
        allocation reclaims them on demand, so only reservations bind."""
        return self.num_blocks - self.reserved_blocks

    def reserve(self, req, tokens: int) -> bool:
        """Reserve the request's worst-case footprint; False = no
        headroom (the caller defers admission or preempts a lower-
        priority lane). Idempotent per rid."""
        if req.rid in self._reserved:
            return True
        need = self.blocks_for(tokens)
        if need > self.headroom:
            return False
        self._reserved[req.rid] = need
        self.reserved_blocks += need
        return True

    def release(self, req) -> None:
        """Drop a reservation without touching blocks — the preemption
        path releases the VICTIM's reservation after its decrefs so the
        preemptor's reserve() can see the headroom."""
        self.reserved_blocks -= self._reserved.pop(req.rid, 0)

    def ensure(self, req, upto: int) -> None:
        """Allocate blocks until slot capacity covers [0, upto)."""
        slot = req.slot
        while int(self.nalloc[slot]) * self.block_size < upto:
            assert int(self.nalloc[slot]) < self._reserved[req.rid], (
                f"request {req.rid} outgrew its reservation "
                f"({self._reserved[req.rid]} blocks)")
            blk = self._take_block()
            self.refcount[blk] = 1
            self.tables[slot, self.nalloc[slot]] = blk
            self.nalloc[slot] += 1

    def free_request(self, req) -> None:
        """Recycle a finished or preempted request's table: one DECREF
        per entry — a block still shared by another lane (or resurrect-
        able from the prefix index) stays resident; only refcount zero
        returns a block to circulation."""
        slot = req.slot
        for j in range(int(self.nalloc[slot])):
            self._decref(int(self.tables[slot, j]))
        self.tables[slot, :] = 0
        self.nalloc[slot] = 0
        self.lengths[slot] = 0
        self._node[slot] = None
        self._nreg[slot] = 0
        self.release(req)

    # -------------------------------------------- refcounts + block states

    def _incref(self, blk: int) -> None:
        if self.refcount[blk] == 0:
            self._cached.pop(blk, None)      # resurrected from the index
        self.refcount[blk] += 1

    def _decref(self, blk: int) -> None:
        self.refcount[blk] -= 1
        assert self.refcount[blk] >= 0, f"block {blk} refcount underflow"
        if self.refcount[blk] == 0:
            if blk in self._reg:
                # registered content survives its last reference: park it
                # in the resurrectable cache (most-recently-freed last)
                self._cached.pop(blk, None)
                self._cached[blk] = None
            else:
                self._free.append(blk)

    def _take_block(self) -> int:
        """One unreferenced block: the free list first, else reclaim the
        least-recently-cached resurrectable block (evicting it — and any
        now-unreachable registered descendants — from the prefix index).
        The reservation invariant guarantees one exists."""
        if self._free:
            return self._free.pop()
        victim = next(iter(self._cached))
        self._unregister(victim)
        return self._free.pop()

    def _unregister(self, blk: int) -> None:
        """Remove a registered block (and its registered subtree) from
        the prefix index. The block itself must be refcount-0 (cached);
        descendants may still be referenced by running lanes — they stay
        allocated and merely lose future matchability, while refcount-0
        descendants become plain free blocks."""
        parent, tup, own = self._reg.pop(blk)
        del parent[tup]
        del self._cached[blk]
        self._free.append(blk)
        stack = [own]
        while stack:
            children = stack.pop()
            for _, (b, child) in children.items():
                self._reg.pop(b)
                if b in self._cached:
                    del self._cached[b]
                    self._free.append(b)
                stack.append(child)
            children.clear()

    # --------------------------------------------------- prefix sharing

    def match_prefix(self, tokens, key: tuple = ()) -> Optional[PrefixMatch]:
        """Walk ``tokens`` down the chain-key's trie: exact FULL-block
        hits first, then — at the divergence point — the longest token-
        level partial match against any child block (>= 1 token). At
        most len(tokens) - 1 tokens match: the last token is always
        prefilled, because its logits sample the request's next output
        token. Returns None on a miss (or with reuse off). Pure lookup —
        adoption (incref + COW copy) happens in ``adopt_prefix``."""
        if not self.reuse or len(tokens) < 2:
            return None
        bs = self.block_size
        limit = len(tokens) - 1
        node = self._tries.get(key)
        if node is None:
            return None
        blocks: list[int] = []
        matched = 0
        while node and matched + bs <= limit:
            ent = node.get(tuple(int(t) for t in tokens[matched:
                                                        matched + bs]))
            if ent is None:
                break
            blocks.append(ent[0])
            node = ent[1]
            matched += bs
        cow = None
        if node:
            rem = [int(t) for t in tokens[matched:limit]]
            best_l, best_b = 0, None
            for tup, (b, _) in node.items():
                l = 0
                for a, c in zip(tup, rem):
                    if a != c:
                        break
                    l += 1
                # deterministic tiebreak: longest match, then lowest block
                if l > best_l or (l == best_l and best_b is not None
                                  and l > 0 and b < best_b):
                    best_l, best_b = l, b
            if best_l > 0:
                cow = (best_b, best_l)
                matched += best_l
        if matched == 0:
            return None
        return PrefixMatch(key=key, blocks=blocks,
                           node=node if node is not None else {},
                           cow=cow, matched=matched)

    def begin_chain(self, req, key: tuple = ()) -> None:
        """Point a freshly-admitted (unmatched) slot's chain cursor at
        the key's trie root so ``commit`` can register its full blocks."""
        if not self.reuse:
            return
        self._node[req.slot] = self._tries.setdefault(key, {})
        self._nreg[req.slot] = 0

    def adopt_prefix(self, req, m: PrefixMatch) -> tuple[int, int]:
        """Point the request's (empty) table at a match: shared full
        blocks by INCREF, the partial tail by COPY-ON-WRITE into a fresh
        private block (one device copy — the request will write
        its own divergent tokens past the shared prefix, and a shared
        block is never written). Sets the slot's valid length to the
        matched token count; the caller fast-forwards the prefill
        cursor. Returns (reused full blocks, cow copies)."""
        slot = req.slot
        assert int(self.nalloc[slot]) == 0 and int(self.lengths[slot]) == 0
        need = len(m.blocks) + (1 if m.cow else 0)
        assert need <= self._reserved[req.rid], (
            f"request {req.rid}: prefix match ({need} blocks) outgrew "
            f"its reservation ({self._reserved[req.rid]})")
        for j, b in enumerate(m.blocks):
            self._incref(b)
            self.tables[slot, j] = b
        self.nalloc[slot] = len(m.blocks)
        cow_copies = 0
        if m.cow is not None:
            src, _valid = m.cow
            # pin the source so _take_block's eviction cannot reclaim it
            self._incref(src)
            dst = self._take_block()
            self.refcount[dst] = 1
            self._block_copy(src, dst)
            self._decref(src)
            self.tables[slot, self.nalloc[slot]] = dst
            self.nalloc[slot] += 1
            cow_copies = 1
        self.lengths[slot] = m.matched
        self._node[slot] = m.node
        self._nreg[slot] = len(m.blocks)
        return len(m.blocks), cow_copies

    def commit(self, req) -> None:
        """Register the slot's newly-FULL sequence blocks in the prefix
        trie (content = the token-id chain from position 0). Called as
        the engine advances the prefill cursor; a block is registered
        the moment every one of its entries has been written — full
        blocks are immutable from then on (the lane only ever writes
        forward), which is what makes sharing them sound. First
        registration wins: a concurrent twin prefill keeps its private
        copy and the chain walks through the existing entry. Blocks
        filled by DECODE tokens are not registered — under the
        overlapped engine their token ids are not host-known at
        dispatch, and hot-prefix traffic is a prompt phenomenon."""
        if not self.reuse:
            return
        slot = req.slot
        node = self._node[slot]
        if node is None:
            return
        bs = self.block_size
        toks = req.seq_tokens
        upto = min(int(req.prefill_pos), len(toks))
        while (int(self._nreg[slot]) + 1) * bs <= upto:
            i = int(self._nreg[slot])
            b = int(self.tables[slot, i])
            tup = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            ent = node.get(tup)
            if ent is not None:
                node = ent[1]                      # first-wins: walk through
            elif b != 0 and b not in self._reg:
                child: dict = {}
                node[tup] = (b, child)
                self._reg[b] = (node, tup, child)
                node = child
            else:                                  # pragma: no cover
                self._node[slot] = None            # chain lost; stop
                return
            self._nreg[slot] += 1
        self._node[slot] = node

    def _block_copy(self, src: int, dst: int) -> None:
        """cache[:, dst] = cache[:, src] on every leaf: the COW device
        copy, in place on the current stream, so it lands before any later
        step reads the block and after every earlier step wrote it."""
        for a in self.cache:
            a[:, dst].copy_(a[:, src])

    # ------------------------------------------------------- conservation

    def audit(self) -> dict:
        """The pool conservation law, checked exhaustively: every block
        is in exactly one of free / cached / allocated, refcounts equal
        table-entry counts, reservations sum consistently, and the trash
        block never entered circulation. Cheap at pool scale — the
        engine asserts it at the end of every paged run."""
        counts = np.zeros(self.num_blocks + 1, np.int32)
        for slot in range(self.max_slots):
            for j in range(int(self.nalloc[slot])):
                counts[self.tables[slot, j]] += 1
        allocated = int((self.refcount[1:] > 0).sum())
        free, cached = len(self._free), len(self._cached)
        ok = (free + cached + allocated == self.num_blocks
              and int(self.refcount.min()) >= 0
              and int(self.refcount[0]) == 0
              and bool((counts[1:] == self.refcount[1:]).all())
              and not (set(self._free) & set(self._cached))
              and len(set(self._free)) == free
              and all(self.refcount[b] == 0 for b in self._free)
              and all(self.refcount[b] == 0 for b in self._cached)
              and all(b in self._reg for b in self._cached)
              and self.reserved_blocks == sum(self._reserved.values())
              and self.reserved_blocks <= self.num_blocks)
        return {"free": free, "cached": cached, "allocated": allocated,
                "total": self.num_blocks, "ok": ok}

    # ---------------------------------------------------------- step args

    def positions(self) -> np.ndarray:
        """Per-slot write positions for a full-width decode step."""
        return self.lengths.copy()

    def tables_snapshot(self) -> np.ndarray:
        """A COPY of the block tables safe to hand to an asynchronously
        dispatched step."""
        return self.tables.copy()

    def table_rows(self, slots) -> np.ndarray:
        """Per-ROW block-table snapshot for a fused micro-batch: row i is
        a copy of tables[slots[i]] (rows sharing a lane repeat its table).
        Fancy indexing copies, so the snapshot is immune to frees or
        allocations the host performs while the step is still in flight —
        the overlapped engine's dispatch-time invariant. Take it BEFORE
        applying the step's dispatch-time finishes: a finish zeroes the
        live table, and the in-flight rows must keep addressing the
        blocks they were scheduled against."""
        return self.tables[np.asarray(slots, np.int32)]
