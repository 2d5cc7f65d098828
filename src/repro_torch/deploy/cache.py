"""Persistent, content-addressed MDM plan cache, byte-compatible with the
reference's.

Port of ``repro.deploy.cache``.  Each matrix's plan is addressed by
(weight bytes, crossbar spec, pipeline cache token, format version):
an unchanged checkpoint redeploys from the cache, and any change to
the weights, the spec or the mode changes the key.  Keys, entry files
and manifests are the reference's, bit for bit, so the two packages
read each other's entries:

- an entry is a 17-byte header (flags, version, three pad bytes,
  ti / tn / rows as u32-LE), then ``row_perm`` and ``row_position``
  in the smallest unsigned dtype that holds ``rows``, the two NF grids
  and the scale as f32-LE;
- a manifest is one JSON header line of ``[name, key, offset,
  length]`` entries, then the entries' bytes back to back.

Flags bit 0 is the reversed dataflow.  Bit 1 marks a column-permuted
plan: a ``cols`` u32-LE field follows the header, and ``col_perm`` and
``col_position`` (in the smallest unsigned dtype that holds ``cols``)
follow the NF block.  Decoded plans hold CPU tensors; packaging moves
them to its device.  A plan keyed on a fault map adds the map's
fingerprint to the key (``plan_key(fault_fingerprint=...)``).

Writes are atomic (tmp file, fsync, ``os.replace``) and best-effort: a
full or read-only disk costs the cache, not the deployment.  The
default root is the reference's fallback ``~/.cache/repro/mdm_plans``,
so the packages share entries unless the reference places its cache
beside a configured JAX compilation cache.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.core.mdm import MdmPlan
from repro_torch.core.tiling import CrossbarSpec

# The reference's format version; entries of another version miss.
PLAN_CACHE_VERSION = 1

# The cache's traffic on the port's registry (the reference's four
# counters, by name); no-ops while telemetry is off.
_M_PROBES = tm.counter(
    "repro_plan_cache_probes_total",
    "Plan-cache entry probes by result (hit/miss).", labels=("result",))
_M_MANIFEST_PROBES = tm.counter(
    "repro_plan_cache_manifest_probes_total",
    "Whole-checkpoint manifest probes by result (hit/miss).",
    labels=("result",))
_M_PUTS = tm.counter(
    "repro_plan_cache_puts_total", "Plan entries written.")
_M_READ_BYTES = tm.counter(
    "repro_plan_cache_read_bytes_total",
    "Bytes read by plan-cache hits (entries and manifests).")

_HEADER = 17


def default_cache_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                        "mdm_plans")


def weight_fingerprint(w) -> str:
    """blake2b over the weight's shape, dtype and raw bytes.

    ``w`` is a numpy array or a tensor (copied to the host first); the
    header names numpy's dtype (``'float32'``), as the reference's
    does.  A bf16 tensor is hashed as its int16 view under the name
    ``'bfloat16'``: byte for byte what the reference hashes for the
    same ml_dtypes array.  Hashing releases the GIL, so a thread pool
    overlaps it.
    """
    name = None
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu()
        if w.dtype == torch.bfloat16:
            w, name = w.contiguous().view(torch.int16), "bfloat16"
        w = w.numpy()
    arr = np.ascontiguousarray(w)
    h = hashlib.blake2b(digest_size=32)
    h.update(repr((arr.shape, name or str(arr.dtype))).encode())
    h.update(arr.data)
    return h.hexdigest()


def plan_key(w_fingerprint: str, spec: CrossbarSpec, mode: str,
             fault_fingerprint: str | None = None) -> str:
    """Content address of one matrix's plan; ``mode`` is the pipeline's
    cache token (``MappingPipeline.cache_token``) and
    ``fault_fingerprint`` the :func:`weight_fingerprint` of the int8
    physical fault map, when a fault-consuming pass planned it."""
    payload = {"version": PLAN_CACHE_VERSION, "weights": w_fingerprint,
               "spec": list(spec), "mode": mode}
    if fault_fingerprint is not None:
        payload["faults"] = fault_fingerprint
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def manifest_key(keys) -> str:
    """Content address of a whole ``{name: plan_key}`` plan set."""
    payload = json.dumps(sorted(dict(keys).items()))
    return hashlib.sha256(payload.encode()).hexdigest()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    manifest_hits: int = 0
    manifest_misses: int = 0


def _perm_dtype(rows: int):
    return (np.uint8 if rows <= 256 else
            np.uint16 if rows <= 65536 else np.uint32)


def encode_plan(plan: MdmPlan) -> bytes:
    """One plan as the bytes of a cache entry."""
    perm = plan.row_perm.cpu().numpy()
    ti, tn, rows = perm.shape
    has_cols = plan.col_perm is not None
    flags = int(bool(plan.reversed_dataflow)) | (2 if has_cols else 0)
    nf = [t.detach().cpu().numpy().astype(np.float32).ravel()
          for t in (plan.nf_before, plan.nf_after)]
    scale = np.asarray(torch.as_tensor(plan.scale).cpu(),
                       np.float32).reshape(1)
    parts = [bytes([flags, PLAN_CACHE_VERSION, 0, 0, 0]),
             np.asarray([ti, tn, rows], "<u4").tobytes()]
    if has_cols:
        cols = plan.col_perm.shape[-1]
        parts.append(np.asarray([cols], "<u4").tobytes())
    parts += [np.stack([perm, plan.row_position.cpu().numpy()]
                       ).astype(_perm_dtype(rows)).tobytes(),
              np.concatenate(nf + [scale]).astype("<f4").tobytes()]
    if has_cols:
        parts.append(np.stack([plan.col_perm.cpu().numpy(),
                               plan.col_position.cpu().numpy()]
                              ).astype(_perm_dtype(cols)).tobytes())
    return b"".join(parts)


def decode_plan(buf: bytes) -> MdmPlan:
    """An entry's bytes as a plan of CPU tensors; ``ValueError`` for a
    bad header or a length that does not match the header exactly."""
    if len(buf) < _HEADER or buf[1] != PLAN_CACHE_VERSION:
        raise ValueError("bad plan entry header")
    flags = buf[0]
    has_cols = bool(flags & 2)
    ti, tn, rows = (int(v) for v in np.frombuffer(buf, "<u4", 3, offset=5))
    off = _HEADER
    cols = 0
    if has_cols:
        if len(buf) < off + 4:
            raise ValueError("plan entry length mismatch")
        cols = int(np.frombuffer(buf, "<u4", 1, offset=off)[0])
        off += 4
    dt = _perm_dtype(rows)
    n_perm = 2 * ti * tn * rows
    n_nf = 2 * ti * tn + 1
    off_nf = off + n_perm * np.dtype(dt).itemsize
    off_col = off_nf + 4 * n_nf
    cdt = _perm_dtype(cols)
    n_col = 2 * ti * tn * cols
    if off_col + n_col * np.dtype(cdt).itemsize != len(buf):
        raise ValueError("plan entry length mismatch")
    perms = np.frombuffer(buf, dt, n_perm, offset=off)
    perms = torch.from_numpy(perms.astype(np.int32).reshape(2, ti, tn, rows))
    nfs = torch.from_numpy(np.frombuffer(buf, "<f4", n_nf, offset=off_nf)
                           .astype(np.float32))
    col_perm = col_position = None
    if has_cols:
        cperms = torch.from_numpy(
            np.frombuffer(buf, cdt, n_col, offset=off_col)
            .astype(np.int32).reshape(2, ti, tn, cols))
        col_perm, col_position = cperms[0], cperms[1]
    return MdmPlan(row_perm=perms[0], row_position=perms[1],
                   reversed_dataflow=bool(flags & 1),
                   nf_before=nfs[:ti * tn].reshape(ti, tn),
                   nf_after=nfs[ti * tn:2 * ti * tn].reshape(ti, tn),
                   scale=nfs[-1].clone(), col_perm=col_perm,
                   col_position=col_position)


class PlanCache:
    """Filesystem-backed plan store keyed by :func:`plan_key`.

    ``get`` / ``put`` are thread-safe (the planner probes from a thread
    pool); only the stats need the lock, file writes being atomic.
    """

    def __init__(self, root: str | None = None):
        self.root = root or default_cache_dir()
        self.stats = CacheStats()
        self.bytes_written = 0
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".mdmplan")

    def _manifest_path(self, mkey: str) -> str:
        return os.path.join(self.root, "manifest", mkey[:2],
                            mkey + ".mdmmanifest")

    def _count(self, field: str) -> None:
        with self._lock:
            setattr(self.stats, field, getattr(self.stats, field) + 1)

    def get(self, key: str) -> MdmPlan | None:
        try:
            with open(self._path(key), "rb") as f:
                buf = f.read()
            plan = decode_plan(buf)
        except (ValueError, OSError):
            self._count("misses")
            _M_PROBES.labels(result="miss").inc()
            return None
        self._count("hits")
        _M_PROBES.labels(result="hit").inc()
        _M_READ_BYTES.inc(len(buf))
        return plan

    def put(self, key: str, plan: MdmPlan | bytes) -> None:
        """Write one entry (a plan, or its :func:`encode_plan` bytes)."""
        blob = plan if isinstance(plan, bytes) else encode_plan(plan)
        if self._atomic_write(self._path(key), blob):
            self._count("puts")
            _M_PUTS.inc()

    def _atomic_write(self, path: str, payload: bytes) -> bool:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       suffix=".tmp")
        except OSError:
            return False
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        with self._lock:
            self.bytes_written += len(payload)
        return True

    def get_manifest(self, keys) -> dict[str, MdmPlan] | None:
        """The whole ``{name: key}`` plan set from one read, or None when
        the manifest is absent, corrupt, or does not cover exactly these
        entries."""
        keys = dict(keys)
        try:
            with open(self._manifest_path(manifest_key(keys)), "rb") as f:
                buf = f.read()
            nl = buf.index(b"\n")
            head = json.loads(buf[:nl])
            if head.get("v") != PLAN_CACHE_VERSION:
                raise ValueError("manifest version mismatch")
            entries = head["entries"]
            if {e[0]: e[1] for e in entries} != keys:
                raise ValueError("manifest entry set mismatch")
            base = nl + 1
            plans = {name: decode_plan(buf[base + off:base + off + length])
                     for name, _, off, length in entries}
        except (ValueError, KeyError, TypeError, OSError):
            self._count("manifest_misses")
            _M_MANIFEST_PROBES.labels(result="miss").inc()
            return None
        self._count("manifest_hits")
        _M_MANIFEST_PROBES.labels(result="hit").inc()
        _M_READ_BYTES.inc(len(buf))
        return plans

    def put_manifest(self, keys, plans) -> None:
        """Write the one-read manifest of a ``{name: key}`` plan set;
        ``plans[name]`` is a plan or its :func:`encode_plan` bytes."""
        keys = dict(keys)
        blobs, entries, off = [], [], 0
        for name, key in keys.items():
            p = plans[name]
            blob = p if isinstance(p, bytes) else encode_plan(p)
            entries.append([name, key, off, len(blob)])
            blobs.append(blob)
            off += len(blob)
        head = json.dumps({"v": PLAN_CACHE_VERSION,
                           "entries": entries}).encode() + b"\n"
        self._atomic_write(self._manifest_path(manifest_key(keys)),
                           head + b"".join(blobs))
