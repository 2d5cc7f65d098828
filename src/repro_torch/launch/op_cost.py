"""Per-op cost counter: the operations, bytes and live memory of a step,
counted while it runs.

The port's counterpart of ``src/repro/launch/hlo_cost.py``.  The
reference walks the HLO of a compiled program; here a
``TorchDispatchMode`` (:class:`OpCost`) sees every aten op the step
runs, on the card, on the CPU or on ``meta`` tensors (shapes only,
nothing allocated), and counts as the reference's walker does:

* matmul-class operations by ``torch.utils.flop_counter``'s rules;
  elementwise ops at their elements and reductions at their input's
  (the larger of the two);
* bytes as operands plus result, views, reshapes and metadata ops at
  zero and left out of the table (the reference's ``_NO_BYTES``), a
  gather at its window (indices and twice the result) and a scatter or
  index write at its update (indices and twice the values), a copy at
  source plus destination;
* the live bytes of the storages the step allocates (a storage once,
  however many views share it; an in-place op allocates nothing), and
  their peak.

An eager step runs every layer, so no trip counts are needed.  A hand
kernel counts through its own rule (each kernel's ``ops.cost``):
:func:`counted` wraps an :class:`~repro_torch.models.model.Ops` so that
each member records its kernel's cost under the kernel's launch-counter
name and the aten ops beneath it are not counted again, and
:data:`COST_OPS` records the same rules and returns outputs of the right
shape without computing, for a step on ``meta``.  The main path counted
on the card through ``counted(KERNELS)``, on the CPU through
``counted(PLAIN)`` or on ``meta`` through ``COST_OPS`` gives the same
numbers.  The flash rule counts the (query, key) pairs the positions let
through: a counter's ``pos0`` is the forward's first position (a Python
int the caller sets, never read from a tensor).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.cim_mvm import ops as cim
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.slstm_scan import ops as slstm
from repro_torch.launch.roofline import PEAK_F32, Cost, peak_for
from repro_torch.models.model import Ops

aten = torch.ops.aten
BF16 = torch.bfloat16

# Metadata ops and bare allocations: no operations, no bytes.
_FREE = {aten.detach, aten.alias, aten.lift_fresh, aten._local_scalar_dense,
         aten._unsafe_view, aten.empty, aten.empty_like, aten.empty_strided,
         aten.new_empty, aten.new_empty_strided, aten.resize_, aten.set_}
# Reads only the window its indices pick from its first operand.
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding}
# Writes its last operand's values at its indices into its first.
_SCATTER = {aten.index_put_, aten.index_put, aten._index_put_impl_,
            aten.scatter, aten.scatter_, aten.scatter_add,
            aten.scatter_add_, aten.index_add, aten.index_add_,
            aten.index_copy, aten.index_copy_}
# Writes its first operand without reading it.
_WRITE = {aten.copy_, aten.fill_, aten.zero_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_cost(func, args, kwargs, out, ins: list, outs: list) -> Cost:
    """The :class:`Cost` of one aten op (not a free one) from its
    operands' shapes."""
    packet = func.overloadpacket
    lead = outs[0] if outs else ins[0] if ins else None
    peak = peak_for(lead.dtype) if lead is not None else PEAK_F32
    n_out = sum(_nbytes(t) for t in outs)
    if packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
        return Cost(float(flops), peak, sum(map(_nbytes, ins)) + n_out)
    if packet in _GATHER:
        return Cost(float(sum(t.numel() for t in outs)), peak,
                    sum(map(_nbytes, ins[1:])) + 2 * n_out)
    if packet in _SCATTER:
        return Cost(float(ins[-1].numel()), peak,
                    sum(map(_nbytes, ins[1:])) + _nbytes(ins[-1]))
    if packet in _WRITE:
        return Cost(0.0, peak, sum(map(_nbytes, ins[1:])) + n_out)
    flops = max(t.numel() for t in ins + outs) if ins else 0
    return Cost(float(flops), peak, sum(map(_nbytes, ins)) + n_out)


@dataclass
class Row:
    """One op's or kernel's calls: their count, operations, bytes, time
    at the operations' peaks and the sum of each call's bound."""

    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    compute_s: float = 0.0
    bound_s: float = 0.0

    def add(self, c: Cost) -> None:
        self.count += 1
        self.flops += c.flops + c.f32_ops
        self.bytes += c.bytes
        self.compute_s += max(c.flops / c.peak, c.f32_ops / PEAK_F32)
        self.bound_s += c.bound()[0]

    def as_tuple(self) -> tuple:
        return self.count, self.flops, self.bytes


@dataclass
class Result:
    """A step's counts: the reference's ``HloCost`` fields (operations,
    bytes, collective bytes and their breakdown), the aten ops and the
    hand kernels by name, the time of the operations at their peaks, and
    the live bytes the step allocated: at their peak and at its end."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    coll_breakdown: dict = field(default_factory=dict)
    compute_s: float = 0.0
    ops: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    peak_bytes: int = 0
    end_bytes: int = 0


_ACTIVE: list = []


class OpCost(TorchDispatchMode):
    """Counts every aten op run inside it (and the hand kernels through
    :func:`counted` / :data:`COST_OPS`); ``pos0`` is the first position
    of the forward it counts, for the flash rule."""

    def __init__(self, pos0: int = 0):
        super().__init__()
        self.pos0 = pos0
        self.ops: dict[str, Row] = defaultdict(Row)
        self.kernels: dict[str, Row] = defaultdict(Row)
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}
        self._muted = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted or func.namespace != "aten":
            return out
        # An operand passed twice (x * x) is read once.
        ins = list({id(t): t for t in _tensors(args) + _tensors(kwargs)
                    }.values())
        outs = _tensors(out)
        self.track(outs, ins)
        # Views and metadata ops cost nothing and are not rows: how many
        # a step makes depends on caches (a deployment's per-layer views
        # are made once), not on its work.
        if not (func.is_view or func.overloadpacket in _FREE):
            self.ops[func.overloadpacket.__name__].add(
                op_cost(func, args, kwargs, out, ins, outs))
        return out

    def track(self, outs: list, ins: list = ()) -> None:
        """Count the storages of ``outs`` that no input shares and that
        are not counted yet as allocated, until they are freed."""
        given = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._sizes or key in given:
                continue
            self._sizes[key] = n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def kernel(self, name: str, cost: Cost, fn, *args):
        """``fn(*args)``, a hand kernel's call, counted as ``cost`` under
        ``name`` (a profiler range of that name around it); its aten ops
        are not counted, its outputs' storages are."""
        self.kernels[name].add(cost)
        self._muted += 1
        try:
            with torch.profiler.record_function(name):
                out = fn(*args)
        finally:
            self._muted -= 1
        self.track(_tensors(out))
        return out

    def result(self) -> Result:
        rows = list(self.ops.values()) + list(self.kernels.values())
        return Result(flops=sum(r.flops for r in rows),
                      bytes_accessed=sum(r.bytes for r in rows),
                      compute_s=sum(r.compute_s for r in rows),
                      ops=dict(self.ops), kernels=dict(self.kernels),
                      peak_bytes=self.peak, end_bytes=self.live)


def _tensors(tree) -> list:
    """The tensors of an op's operands or outputs: a tensor, or nested
    lists, tuples and dicts of them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def analyze(fn, *args, pos0: int = 0, **kwargs) -> Result:
    """The :class:`Result` of ``fn(*args, **kwargs)`` run once under an
    :class:`OpCost` (its end bytes taken while fn's output lives)."""
    with OpCost(pos0) as c:
        out = fn(*args, **kwargs)
        res = c.result()
    del out
    return res


# ------------------------------------------------- the kernels' rules

def _cim(x, dep, read_seed) -> tuple[str, Cost]:
    noise = dep.folded is not None and cim.noisy(dep, read_seed)
    return "cim_mvm", cim.cost(x.numel() // x.shape[-1], dep,
                               x.dtype == BF16, noise)


def _flash(q, k, q_pos, k_pos, window, pos0) -> tuple[str, Cost]:
    if q_pos.ndim != 1:
        raise NotImplementedError(
            "the flash rule counts from one shared first position; "
            "per-lane positions have none")
    B, Sq, H, Dh = q.shape
    pairs, seen = flash.visible(pos0, Sq, k.shape[1], window)
    return "flash_attention", flash.cost(
        B, Sq, H, k.shape[2], Dh, q.dtype == BF16, B * pairs, B * seen,
        q_pos.numel() + k_pos.numel())


def _slstm(gx, r, h0) -> tuple[str, Cost]:
    B, T, H, Dh4 = gx.shape
    form = slstm.slstm_form(max(B, 1), max(T, 1), Dh4 // 4, r.dtype == BF16)
    return slstm.COUNTERS[form], slstm.cost(
        B, T, H, Dh4 // 4, gx.element_size(), r.element_size(),
        h0.element_size(), form)


def _grouped(x, dep, cap, read_seed) -> tuple[str, Cost]:
    """Every row of x on min(E, rows) experts: the most the call can
    need, the offsets being on the device."""
    A, E = x.shape[0], dep.codes.shape[0]
    noise = dep.folded is not None and cim.noisy(dep, read_seed)
    name = "cim_mvm_grouped" + ("_folded" if dep.folded is not None else "")
    return name, cim.grouped_cost(A, cap, A, min(E, A), dep, x.dtype == BF16,
                                  noise)


def _call(rule, fn, *args):
    c = _ACTIVE[-1] if _ACTIVE else None
    if c is None:
        return fn(*args)
    return c.kernel(*rule(c.pos0), fn, *args)


def counted(ops: Ops) -> Ops:
    """``ops`` with each member's kernel counted by its rule under the
    innermost :class:`OpCost` (uncounted outside one)."""
    def matmul(x, dep, read_seed=None):
        return _call(lambda p: _cim(x, dep, read_seed), ops.matmul, x, dep,
                     read_seed)

    def attention(q, k, v, q_pos, k_pos, window, chunk):
        return _call(lambda p: _flash(q, k, q_pos, k_pos, window, p),
                     ops.attention, q, k, v, q_pos, k_pos, window, chunk)

    def scan(gx, r, h0, c0):
        return _call(lambda p: _slstm(gx, r, h0), ops.slstm_scan, gx, r,
                     h0, c0)

    def grouped(x, dep, offsets, cap, read_seed=None):
        return _call(lambda p: _grouped(x, dep, cap, read_seed), ops.grouped,
                     x, dep, offsets, cap, read_seed)

    return Ops(matmul, attention, scan, grouped)


def _empty(*shape, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


# Shapes only: each member returns its kernel's outputs uncomputed.
COST_OPS = counted(Ops(
    matmul=lambda x, dep, read_seed=None: _empty(
        *x.shape[:-1], dep.out_dim, like=x, dtype=torch.float32),
    attention=lambda q, k, v, q_pos, k_pos, window, chunk: torch.empty_like(
        q),
    slstm_scan=lambda gx, r, h0, c0: (
        _empty(*gx.shape[:-1], gx.shape[-1] // 4, like=h0),
        torch.empty_like(h0), torch.empty_like(c0)),
    grouped=lambda x, dep, offsets, cap, read_seed=None: _empty(
        x.shape[0], dep.out_dim, like=x, dtype=torch.float32)))


def to_meta(tree):
    """``tree`` (dicts, lists, tuples of tensors and deployments) with
    every tensor a ``meta`` tensor of its shape and dtype.  A
    deployment's ``degraded`` and ``noise_tag`` stay: they are host
    scalars the forward reads."""
    if isinstance(tree, torch.Tensor):
        return torch.empty_like(tree, device="meta")
    if isinstance(tree, cim.CimDeployment):
        out = dataclasses.replace(tree, **{
            f: to_meta(getattr(tree, f))
            for f in ("codes", "pos", "scale", "gain", "col_pos")})
        out.folded = to_meta(tree.folded)
        out.device_tags = to_meta(tree.device_tags)
        return out
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    return tree
