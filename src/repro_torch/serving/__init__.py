"""Continuous-batching serving engine: scheduler + KV cache + step
executor. Port of ``repro/serving`` (same exports).

``Scheduler`` (`scheduler.py`), ``Request`` (`request.py`) and
``make_requests`` (`workload.py`) are copies of the reference's host-side
modules: admission queue, slot table, chunked-prefill budget, priority
preemption and the numpy request generator, so both packages draw the same
request set from one seed.

``SlotKVCache`` / ``PagedKVCache`` (`cache.py`) keep the contiguous slot
lanes or the refcounted, content-addressed block pool (prefix trie,
copy-on-write, conservation ``audit()``) with the reference's bookkeeping;
the device tensors are updated in place.

``StepExecutor`` (`executor.py`) runs the prefill, decode and fused steps
eagerly over ``Model.step``; ``ServingEngine`` (`engine.py`) is the
sequential and the overlapped loop and returns an ``EngineReport``.

    python -m repro_torch.launch.serve --smoke --continuous --paged \\
        --parity --device cpu
"""
from repro_torch.serving.cache import (PagedKVCache, SlotKVCache,
                                       gather_slots, scatter_slots)
from repro_torch.serving.engine import EngineReport, ServingEngine
from repro_torch.serving.executor import StepExecutor
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import make_sampler
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.workload import make_requests, poisson_arrivals

__all__ = [
    "EngineReport", "PagedKVCache", "Request", "Scheduler", "ServingEngine",
    "SlotKVCache", "StepExecutor", "gather_slots", "make_requests",
    "make_sampler", "poisson_arrivals", "scatter_slots",
]
