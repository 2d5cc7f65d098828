"""Checkpoints in the reference's format, both ways.

Port of ``repro.checkpoint.ckpt``.  A checkpoint is a directory
``step_<8 digits>`` holding one ``.npy`` file a leaf and an
``index.json`` that names, for each leaf, its pytree path (as
``jax.tree_util.keystr`` prints it: ``['slot0_attn']['wq']`` for dict
keys, ``.m`` for a NamedTuple field, so an optimizer state's leaves are
``['opt'].m['embed']``), its file, shape and dtype.  Leaves of
``bfloat16`` and ``float8_*`` are stored as same-width unsigned integer
views and reinterpreted by a torch ``view``, without ``ml_dtypes``.

The write side writes what the reference's does, byte for byte: the
leaves in ``jax.tree_util`` order (dict keys sorted, NamedTuple fields
in order, None fields skipped), the same files and ``index.json``, so a
checkpoint of either package restores in the other.  A save is atomic
(a ``.tmp`` directory renamed into place); :class:`CheckpointManager`
keeps the newest ``keep`` and can write on a background thread from a
host snapshot taken on the caller's thread.
"""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

# dtype names of index.json stored as integer views -> (numpy view
# dtype to load through, torch dtype to reinterpret as).
_VIEW_DTYPES = {
    "bfloat16": (np.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}
_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|-?\d+)\]"
                  r"|\.([A-Za-z_]\w*)")


def latest_step(directory: str) -> int | None:
    """The newest complete step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def parse_keystr(path: str) -> list:
    """``"['slot0_attn']['wq']"`` -> ``['slot0_attn', 'wq']`` (dict keys,
    sequence indices and ``.name`` attributes: ``"['opt'].m['embed']"``
    -> ``['opt', 'm', 'embed']``; raises for any other path syntax)."""
    keys, end = [], 0
    for m in _KEY.finditer(path):
        if m.start() != end:
            break
        keys.append(m.group(2) if m.group(1) is None
                    else ast.literal_eval(m.group(1)))
        end = m.end()
    if end != len(path) or not keys:
        raise ValueError(f"unsupported checkpoint leaf path {path!r}")
    return keys


def _leaf(file: str, dtype: str) -> torch.Tensor:
    arr = np.load(file)
    view = _VIEW_DTYPES.get(dtype)
    if view is not None:
        return torch.from_numpy(arr.view(view[0])).view(view[1])
    if str(arr.dtype) != dtype:
        raise ValueError(f"{file}: stored {arr.dtype}, index says {dtype}")
    return torch.from_numpy(arr)


def load_checkpoint(directory: str, step: int | None = None,
                    device: str | torch.device = "cuda") -> dict:
    """The checkpoint at ``step`` (default: the latest) as nested dicts
    of tensors on ``device``, keyed as the saved pytree was."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    tree: dict = {}
    for entry in index["leaves"]:
        keys = parse_keystr(entry["path"])
        t = _leaf(os.path.join(path, entry["file"]), entry["dtype"])
        if list(t.shape) != list(entry["shape"]):
            raise ValueError(f"{entry['path']}: shape {tuple(t.shape)} != "
                             f"index {entry['shape']}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.to(dev)
    return tree


# --------------------------------- write ---------------------------------

def leaf_items(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(keystr path, leaf) pairs in ``jax.tree_util`` order: dict keys
    sorted (``['k']``), NamedTuple fields in order (``.f``), None an
    empty subtree; anything else a leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from leaf_items(getattr(tree, f), f"{prefix}.{f}")
    else:
        yield prefix, tree


def _snapshot(tree) -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) items with every leaf a CPU tensor of its own (a copy
    even on the CPU, so that training may go on updating the original in
    place)."""
    return [(p, t.detach().to("cpu", copy=True))
            for p, t in leaf_items(tree)]


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array written, the dtype name index.json keeps): a bf16 or
    float8 leaf as its unsigned integer view, as the reference's."""
    name = str(t.dtype).removeprefix("torch.")
    if name not in _VIEW_DTYPES:
        return t.numpy(), name
    tv, nv = {1: (torch.uint8, np.uint8),
              2: (torch.int16, np.uint16)}[t.element_size()]
    return t.view(tv).numpy().view(nv), name


def _write(directory: str, step: int, items: list) -> str:
    """Write host (path, tensor) items as checkpoint ``step``,
    atomically: into ``step_<n>.tmp``, renamed into place."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = {"step": step, "leaves": []}
    for i, (path, t) in enumerate(items):
        arr, dtype = _encode(t)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index["leaves"].append({"path": path, "file": fname,
                                "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Atomic synchronous save of a tree of tensors (nested dicts and
    NamedTuples such as ``AdamWState``).  Returns the checkpoint path."""
    return _write(directory, step, _snapshot(tree))


def restore_into(directory: str, step: int, target) -> None:
    """Copy checkpoint ``step`` into the tensors of ``target`` in place
    (any device), leaf by leaf through the host: every leaf of
    ``target`` must be in the checkpoint with its shape and dtype."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}
    for p, tgt in leaf_items(target):
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"{path}: no leaf {p}")
        t = _leaf(os.path.join(path, entry["file"]), entry["dtype"])
        if t.shape != tgt.shape or t.dtype != tgt.dtype:
            raise ValueError(f"{p}: checkpoint {entry['dtype']} "
                             f"{tuple(t.shape)}, target {tgt.dtype} "
                             f"{tuple(tgt.shape)}")
        tgt.copy_(t)


class CheckpointManager:
    """Retention + async saves."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def wait(self) -> None:
        """Join the save in flight; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree) -> None:
        self.wait()
        # The host snapshot is taken here, on the caller's thread, so
        # training may update its tensors in place while the I/O runs.
        items = _snapshot(tree)

        def run():
            _write(self.directory, step, items)
            self._gc()

        if not self.async_save:
            run()
            return

        def guarded():
            try:
                run()
            except Exception as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, target):
        """(step, target) with the latest checkpoint copied into
        ``target`` in place, or (None, None) where there is none."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        restore_into(self.directory, step, target)
        return step, target
