"""Slot-pool KV cache for continuous batching.

Port of ``repro.serve.kvcache``.  A :class:`SlotPool` owns one
fixed-capacity per-slot decode state (``init_decode_state(...,
per_slot=True)``): the batch axis is a pool of ``capacity`` slots,
each holding one sequence's ring-buffer KV cache and position clock.
Batch composition changes by in-place index updates only: a sequence
joins by writing its prefilled B=1 state into its slot's lanes, and is
evicted by resetting that slot's ``kpos`` to ``EMPTY_POS`` (a dead slot
attends to nothing).  No shape ever changes.

Join masks the padded tail of the prompt: prefill runs at the fixed
``max_prompt`` length, so the cache entries it wrote at positions >=
the true prompt length are garbage that later queries would otherwise
attend to; their ``kpos`` becomes ``EMPTY_POS``.

The receipt.  The reference counts its jit retraces to show that batch
composition never changes a shape.  The port has no tracing, so
``traces`` counts the distinct call signatures of ``join``, ``evict``
and ``merge``: the (shape, dtype) of every tensor operand
(:func:`call_signature`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import EMPTY_POS
from repro_torch.models.model import init_decode_state


def call_signature(*operands) -> tuple:
    """(shape, dtype) of every tensor in ``operands``, walking dicts,
    lists, tuples and the compared fields of dataclasses (a
    ``CimDeployment``'s codes, pos and scale)."""
    sig: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.dtype))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                if f.compare:             # not a cache such as _layers
                    walk(getattr(x, f.name))

    for op in operands:
        walk(op)
    return tuple(sig)


class SignatureCounter:
    """``counts[name]``: distinct call signatures seen for ``name``."""

    def __init__(self, *names: str):
        self.counts = {n: 0 for n in names}
        self._seen: dict[str, set] = {n: set() for n in names}

    def note(self, name: str, *operands) -> None:
        sig = call_signature(*operands)
        if sig not in self._seen[name]:
            self._seen[name].add(sig)
            self.counts[name] += 1


def _leaves(state: dict):
    """(slot name, leaf name, tensor) of every per-slot leaf but pos."""
    for slot_name, sub in state.items():
        if slot_name != "pos":
            for k, leaf in sub.items():
                yield slot_name, k, leaf


class SlotPool:
    """Fixed-capacity slot pool over the per-slot decode state."""

    def __init__(self, cfg: ModelConfig, capacity: int, max_seq: int,
                 device: str | torch.device):
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.device = torch.device(device)
        self.state = init_decode_state(cfg, capacity, max_seq, self.device,
                                       per_slot=True)
        self._free = list(range(capacity))
        self._sigs = SignatureCounter("join", "evict", "merge")
        self.traces = self._sigs.counts

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.capacity - len(self._free)

    def acquire(self) -> int | None:
        """Lowest free slot, or None when the pool is full."""
        return self._free.pop(0) if self._free else None

    def fresh_seq_state(self) -> dict:
        """A B=1 per-slot state for one prefill (same cache depth)."""
        return init_decode_state(self.cfg, 1, self.max_seq, self.device,
                                 per_slot=True)

    def join(self, slot: int, seq_state: dict, length: int) -> None:
        """Write a prefilled B=1 state into ``slot``: every leaf's lane,
        ``kpos`` at positions >= ``length`` (the true prompt length)
        masked to EMPTY_POS, and the slot's clock set to ``length``."""
        self._sigs.note("join", self.state, seq_state)
        for slot_name, k, leaf in _leaves(self.state):
            src = seq_state[slot_name][k][:, 0]
            if k == "kpos":
                src = torch.where(src >= length, EMPTY_POS, src)
            leaf[:, slot] = src
        self.state["pos"][slot] = length

    def evict(self, slot: int) -> None:
        """Mask ``slot`` dead (kpos -> EMPTY_POS, clock -> 0), free it."""
        self._sigs.note("evict", self.state)
        for _, k, leaf in _leaves(self.state):
            if k == "kpos":
                leaf[:, slot] = EMPTY_POS
        self.state["pos"][slot] = 0
        self._free.append(slot)
        self._free.sort()

    def merge(self, state_a: dict, state_b: dict, take_b) -> dict:
        """Per-slot merge of two post-decode states (a new state):
        slots where the (capacity,) bool mask ``take_b`` is set take
        ``state_b``'s lanes, the others ``state_a``'s."""
        take_b = torch.as_tensor(take_b, dtype=torch.bool,
                                 device=self.device)
        self._sigs.note("merge", state_a, state_b, take_b)

        def pick(x, y):
            m = take_b.reshape((1, -1) + (1,) * (x.ndim - 2)) \
                if x.ndim >= 2 else take_b
            return torch.where(m, y, x)

        out = {slot_name: {k: pick(leaf, state_b[slot_name][k])
                           for k, leaf in sub.items()}
               for slot_name, sub in state_a.items() if slot_name != "pos"}
        out["pos"] = pick(state_a["pos"], state_b["pos"])
        return out

    def fork(self) -> dict:
        """A copy of the pool state."""
        return {slot_name: (sub.clone() if slot_name == "pos" else
                            {k: leaf.clone() for k, leaf in sub.items()})
                for slot_name, sub in self.state.items()}
