"""Continuous-batching scheduler: request queue + KV-cache slot allocation
(reference: ``repro/serving/scheduler.py``).

The engine owns ``n_slots`` cache rows, each with its own position.  The
scheduler hands a free slot to each admitted request, interleaves
prompt-consumption (chunked prefill + decode catch-up) with generation, and
reclaims the slot the step the request completes.

Invariants (tested):
  - no two live requests ever share a cache slot;
  - a freed slot is reclaimed by the next admission;
  - a request whose prompt + budget cannot fit ``max_seq`` is rejected at
    submit time rather than poisoning a slot;
  - retained request objects are bounded (``max_retained``); lifetime
    totals live in ``stats()`` counters, which are also mirrored into
    ``repro_torch.obs`` metrics when tracing is enabled.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any

import numpy as np

from repro_torch import obs as OBS

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    rid: int
    adapter_id: str
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int
    eos_id: int | None = None
    state: str = WAITING
    slot: int | None = None
    n_cached: int = 0                   # tokens resident in this slot's cache
    out: list[int] = dataclasses.field(default_factory=list)
    submit_step: int = -1
    start_step: int = -1
    finish_step: int = -1
    entry: Any = None                   # AdapterEntry while running
    error: str | None = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        if len(self.out) >= self.max_new_tokens:
            return True
        return self.eos_id is not None and bool(self.out) \
            and self.out[-1] == self.eos_id

    def next_input(self) -> int:
        """Token to feed at the next decode step: the unconsumed prompt tail
        first (decode catch-up after a chunked prefill), then the last
        generated token."""
        if self.n_cached < self.prompt_len:
            return int(self.prompt[self.n_cached])
        return self.out[-1]

    def observe(self, token: int) -> None:
        """Account one decoded step: the fed token entered the cache; its
        logits are a real sample only once the whole prompt is resident."""
        self.n_cached += 1
        if self.n_cached >= self.prompt_len:
            self.out.append(int(token))


class Scheduler:
    def __init__(self, n_slots: int, max_seq: int, max_retained: int = 256):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self._free = deque(range(n_slots))
        self._queue: deque[Request] = deque()
        self._running: dict[int, Request] = {}      # slot -> request
        self._rid = itertools.count()
        self.step_count = 0
        self.rejected: deque[Request] = deque(maxlen=max_retained)
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_preempted = 0
        self.n_finished = 0
        self.rejects_by_reason: dict[str, int] = {}

    def _count_reject(self, kind: str) -> None:
        self.rejects_by_reason[kind] = self.rejects_by_reason.get(kind, 0) + 1
        OBS.get_metrics().counter("sched.rejects", reason=kind).inc()

    # ---- intake ------------------------------------------------------------

    def submit(self, adapter_id: str, prompt, max_new_tokens: int,
               eos_id: int | None = None) -> Request:
        req = Request(rid=next(self._rid), adapter_id=adapter_id,
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=int(max_new_tokens), eos_id=eos_id,
                      submit_step=self.step_count)
        self.n_submitted += 1
        if req.prompt_len == 0 or req.max_new_tokens < 1 or \
                req.prompt_len + req.max_new_tokens > self.max_seq:
            req.state = REJECTED
            req.error = (f"need prompt_len >= 1, max_new >= 1 and "
                         f"prompt_len={req.prompt_len} + "
                         f"max_new={req.max_new_tokens} <= "
                         f"max_seq={self.max_seq}")
            self.rejected.append(req)
            self._count_reject("invalid")
            return req
        self._queue.append(req)
        return req

    # ---- scheduling --------------------------------------------------------

    def admit(self) -> list[Request]:
        """Grant free slots to waiting requests, FIFO."""
        admitted = []
        while self._queue and self._free:
            req = self._queue.popleft()
            slot = self._free.popleft()
            if slot in self._running:
                raise RuntimeError(f"slot {slot} double-allocated")
            req.slot = slot
            req.state = RUNNING
            req.start_step = self.step_count
            self._running[slot] = req
            admitted.append(req)
        if admitted:
            self.n_admitted += len(admitted)
            OBS.get_metrics().counter("sched.admits").inc(len(admitted))
        return admitted

    def defer(self, req: Request) -> None:
        """Return an admitted request to the head of the queue (e.g. its
        adapter could not be acquired this step); frees the slot."""
        self._release_slot(req)
        req.state = WAITING
        self._queue.appendleft(req)
        self.n_preempted += 1
        OBS.get_metrics().counter("sched.preemptions").inc()

    def reject(self, req: Request, reason: str,
               kind: str = "runtime") -> None:
        """Drop an admitted request (e.g. unknown adapter); frees the slot."""
        self._release_slot(req)
        req.state = REJECTED
        req.error = reason
        self.rejected.append(req)
        self._count_reject(kind)

    def running(self) -> list[Request]:
        return list(self._running.values())

    def finish(self, req: Request) -> None:
        if req.slot is None or self._running.get(req.slot) is not req:
            raise RuntimeError(f"request {req.rid} is not running")
        self._release_slot(req)
        req.state = FINISHED
        req.finish_step = self.step_count
        self.n_finished += 1

    def _release_slot(self, req: Request) -> None:
        if req.slot is None:
            raise RuntimeError(f"request {req.rid} holds no slot")
        del self._running[req.slot]
        self._free.append(req.slot)
        req.slot = None

    # ---- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {"submitted": self.n_submitted, "admits": self.n_admitted,
                "preemptions": self.n_preempted, "finished": self.n_finished,
                "rejects": dict(self.rejects_by_reason),
                "running": self.n_running, "waiting": self.n_waiting,
                "free": self.n_free}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_waiting(self) -> int:
        return len(self._queue)

    @property
    def n_running(self) -> int:
        return len(self._running)

    @property
    def idle(self) -> bool:
        return not self._queue and not self._running

    def slot_bytes(self, cache_slot_bytes: int) -> dict:
        """Device cache accounting against model.cache_meta(1, max_seq)."""
        return {"per_slot": cache_slot_bytes,
                "total": cache_slot_bytes * self.n_slots,
                "in_use": cache_slot_bytes * self.n_running}
