"""Read the reference's checkpoints into torch.

Port of the read side of ``repro.checkpoint.ckpt``.  A checkpoint is a
directory ``step_<8 digits>`` holding one ``.npy`` file a leaf and an
``index.json`` that names, for each leaf, its pytree path (as
``jax.tree_util.keystr`` prints it, e.g. ``['slot0_attn']['wq']``), its
file, shape and dtype.  Leaves of ``bfloat16`` and ``float8_*`` are
stored as same-width unsigned integer views; here they are
reinterpreted by a torch ``view``, without ``ml_dtypes``.  The write
side and ``CheckpointManager`` come with the training slice.
"""
from __future__ import annotations

import ast
import json
import os
import re

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
_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|-?\d+)\]")


def latest_step(directory: str) -> int | None:
    """The newest complete step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def parse_keystr(path: str) -> list:
    """``"['slot0_attn']['wq']"`` -> ``['slot0_attn', 'wq']`` (dict keys
    and sequence indices; raises for any other path syntax)."""
    keys, end = [], 0
    for m in _KEY.finditer(path):
        if m.start() != end:
            break
        keys.append(ast.literal_eval(m.group(1)))
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
