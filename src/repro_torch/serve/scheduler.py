"""Iteration-level request scheduling for continuous batching.

Port of ``repro.serve.scheduler``.  Orca-style
admission: the scheduler owns an open FIFO queue of :class:`Request`\\ s
and the per-slot :class:`Sequence` bookkeeping of everything in flight.
The engine (:class:`repro_torch.serve.continuous.ContinuousEngine`)
drives one iteration at a time: admit queued requests into free slots,
one batched decode step for every live slot, stream the new tokens,
evict the sequences that reached their budget.  A request waits for a
slot, never for a batch.  Pure host-side policy: the device state lives
in :class:`repro_torch.serve.kvcache.SlotPool`.  Its telemetry is the
reference's: the queue depth gauge (set on submit and admit) and the
admitted and evicted counters.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np

from repro_torch import telemetry as tm

_G_QUEUE = tm.gauge(
    "repro_serve_queue_depth",
    "Requests waiting for a slot (updated on submit/admit).")
_C_ADMITTED = tm.counter(
    "repro_serve_admitted_total", "Requests admitted into a slot.")
_C_EVICTED = tm.counter(
    "repro_serve_evicted_total", "Finished sequences evicted from slots.")

TokenCallback = Callable[[int, int, bool], None]


@dataclasses.dataclass
class Request:
    """One generation request.

    ``max_tokens`` counts every generated token, the one sampled at
    prefill included (``ServeEngine.generate``'s convention).  ``seed``
    roots the request's sampling: token n depends on (seed, n) alone
    (``repro_torch.serve.engine.sample_tokens_batch``).
    ``on_token(rid, token, done)`` streams tokens as they are sampled.
    """

    rid: int
    prompt: np.ndarray
    max_tokens: int
    temperature: float = 0.0
    seed: int = 0
    on_token: TokenCallback | None = None


@dataclasses.dataclass
class Sequence:
    """In-flight state of one admitted request."""

    req: Request
    slot: int
    epoch: int                 # bank epoch pinned at admission
    n_emitted: int = 0
    tokens: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.n_emitted >= self.req.max_tokens


class RequestScheduler:
    """Open request queue + per-slot sequence bookkeeping."""

    def __init__(self):
        self.queue: deque[Request] = deque()
        self.live: dict[int, Sequence] = {}       # slot -> Sequence
        self.results: dict[int, list[int]] = {}   # rid -> tokens (done)
        self._next_rid = 0

    def submit(self, prompt, max_tokens: int, temperature: float = 0.0,
               seed: int = 0, on_token: TokenCallback | None = None
               ) -> int:
        """Enqueue a request; returns its rid."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_tokens,
                                  float(temperature), int(seed), on_token))
        _G_QUEUE.set(len(self.queue))
        return rid

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + in flight)."""
        return len(self.queue) + len(self.live)

    def pop_admission(self) -> Request | None:
        """Next queued request (FIFO), or None."""
        if not self.queue:
            return None
        req = self.queue.popleft()
        _G_QUEUE.set(len(self.queue))
        return req

    def start(self, req: Request, slot: int, epoch: int) -> Sequence:
        """Register an admitted request as live in ``slot``."""
        if slot in self.live:
            raise ValueError(f"slot {slot} already occupied")
        seq = Sequence(req, slot, epoch)
        self.live[slot] = seq
        _C_ADMITTED.inc()
        return seq

    def record_token(self, slot: int, token: int) -> bool:
        """Append one sampled token to the slot's sequence; True when it
        just reached its budget (the caller evicts).  Streams it
        through the request's callback either way."""
        seq = self.live[slot]
        seq.tokens.append(int(token))
        seq.n_emitted += 1
        done = seq.done
        if seq.req.on_token is not None:
            seq.req.on_token(seq.req.rid, int(token), done)
        return done

    def finish(self, slot: int) -> Sequence:
        """Evict a finished sequence; its tokens land in ``results``."""
        seq = self.live.pop(slot)
        self.results[seq.req.rid] = list(seq.tokens)
        _C_EVICTED.inc()
        return seq

    def epochs_live(self) -> list[int]:
        """Distinct bank epochs currently in flight, ascending."""
        return sorted({seq.epoch for seq in self.live.values()})
