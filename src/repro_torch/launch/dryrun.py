"""Dry-run: every (arch x shape) cell's real step, counted on ``meta``.

The port's counterpart of ``src/repro/launch/dryrun.py``.  The reference
lowers and compiles each cell for a TPU pod and reads the compiled
program; here each cell builds the port's own step on ``meta`` tensors
(shapes and dtypes, nothing allocated: the counterpart of its
``ShapeDtypeStruct`` inputs) and runs it once under the per-op counter
(``launch/op_cost.py``):

* train_4k: ``train/step.py::make_train_step`` with its AdamW state
  (forward, backward under ``cfg.remat``, the update in place);
* prefill_32k: a prefill from position 0 into a ``seq_len``-deep state;
* decode_32k, long_500k: one decode step at position ``seq_len - 1``
  against a ``seq_len``-deep cache.

The serving cells run their hand kernels through ``COST_OPS`` (each
counted by its rule).  Each record keeps the reference's keys (``ok``,
``memory``, ``params``, ``roofline``, ``wall_s``; ``error`` and
``traceback`` for a cell that failed) and adds ``fits``: whether the
step's peak, its arguments plus the live bytes it allocates, is at most
one card's HBM.

Cards: ``--data N`` runs N data-parallel processes, each holding the
whole state and 1/N of the global batch; a training step then reduces
its gradients as ``train/step.py`` does across processes (int8 with
error feedback, an int32 payload an element summed by ``all_reduce``),
whose ring moves 2 (N - 1) / N of the payload out of each card.  The
port has no tensor-parallel or FSDP program, so no term is counted for
one (``tensor_parallel`` in each record).

    python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--data N] [--force]

No card is needed.  Results land in
``results/dryrun_torch/<arch>__<shape>__data<N>[__<tag>].json``.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

import torch

from repro_torch import telemetry as tm
from repro_torch.configs import SHAPES, arch_shape_cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import op_cost
from repro_torch.launch.roofline import HBM_BYTES, Roofline, peak_for
from repro_torch.models import schema as sch
from repro_torch.models.frontend import embedding_spec
from repro_torch.models.model import apply_model, init_decode_state
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.serve.engine import sample_tokens
from repro_torch.train.step import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
TENSOR_PARALLEL = ("none: the port has no tensor-parallel or FSDP program; "
                   "each card holds the whole state")


def param_counts(cfg: ModelConfig) -> dict:
    """Parameters in all, routed-expert (``ffn_we_*``), embedding and
    active (experts at top-k / E), from the schema alone."""
    total = expert = embed = 0

    def walk(node, name):
        nonlocal total, expert, embed
        if isinstance(node, sch.ParamSpec):
            n = 1
            for s in node.shape:
                n *= s
            total += n
            expert += n if "ffn_we_" in name else 0
            embed += n if name == "embed" else 0
            return
        for k, v in node.items():
            walk(v, k)

    walk(sch.model_schema(cfg), "")
    active = total - expert
    if cfg.n_experts:
        active += expert * cfg.n_experts_per_token / cfg.n_experts
    return {"total": total, "active": active, "embed": embed,
            "expert": expert}


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _serve_step(cfg: ModelConfig, decode: bool):
    """(params, state, inputs) -> (greedy tokens (B,), state): the
    serving engines' prefill or decode forward with ``COST_OPS``."""
    def step(params, state, x):
        kind = "embeds" if cfg.frontend and not decode else "tokens"
        logits, state = apply_model(params, cfg, state=state, decode=decode,
                                    ops=op_cost.COST_OPS, **{kind: x})
        return sample_tokens(logits[:, -1]), state
    return step


def build_cell(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
               data: int = 1):
    """(fn, args, pos0): one process's step of the cell on ``meta``
    tensors, its batch global_batch / data rows, and its first
    position."""
    if shape.global_batch % data:
        raise ValueError(f"{shape.name}: a global batch of "
                         f"{shape.global_batch} does not split over {data}")
    B, S = shape.global_batch // data, shape.seq_len
    params = sch.abstract_params(cfg)
    if shape.kind == "train":
        opt = adamw_init(params, tcfg.grad_compression == "int8_ef")
        batch = ({"embeds": embedding_spec(cfg, B, S),
                  "labels": _meta((B, S))} if cfg.frontend
                 else {"tokens": _meta((B, S + 1))})
        return make_train_step(cfg, tcfg), (params, opt, batch), 0
    state = init_decode_state(cfg, B, S, "meta")
    if shape.kind == "prefill":
        x = embedding_spec(cfg, B, S) if cfg.frontend else _meta((B, S))
        return _serve_step(cfg, False), (params, state, x), 0
    state["pos"] = S - 1
    return _serve_step(cfg, True), (params, state, _meta((B, 1))), S - 1


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen = {}
    for t in op_cost._tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _grad_reduce_bytes(cfg: ModelConfig, data: int) -> float:
    """Bytes one card's ring ``all_reduce`` moves for the int8
    error-feedback gradient sum: an int32 payload an element and an f32
    scale a leaf, 2 (N - 1) / N of it."""
    leaves = tree_leaves(sch.abstract_params(cfg))
    payload = sum(4 * t.numel() + 4 for t in leaves)
    return 2.0 * (data - 1) / data * payload


def _name(arch: str, shape: str, data: int, tag: str) -> str:
    return f"{arch}__{shape}__data{data}" + (f"__{tag}" if tag else "")


def run_cell(arch: str, shape_name: str, data: int = 1, tag: str = "",
             overrides: dict | None = None,
             out_dir: str = RESULTS_DIR) -> dict:
    """Build, count and record one cell; the record is also written
    under ``out_dir``."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    tcfg = TrainConfig(grad_compression="int8_ef" if data > 1 else "")
    rec = {"arch": arch, "shape": shape_name, "mesh": f"data{data}",
           "kind": shape.kind, "tag": tag,
           "overrides": {k: str(v) for k, v in (overrides or {}).items()},
           "chips": data, "tensor_parallel": TENSOR_PARALLEL}
    t0 = tm.monotonic()
    try:
        fn, args, pos0 = build_cell(cfg, shape, tcfg, data)
        arg_bytes = _storage_bytes(args)
        cost = op_cost.analyze(fn, *args, pos0=pos0)
        counts = param_counts(cfg)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        n = counts["active"] - counts["embed"]
        mf = (6 if shape.kind == "train" else 2) * n * tokens
        coll = (_grad_reduce_bytes(cfg, data)
                if shape.kind == "train" and data > 1 else 0.0)
        # Counts are one process's; the terms divide by the cards again.
        roof = Roofline(flops=cost.flops * data,
                        bytes_accessed=cost.bytes_accessed * data,
                        coll_bytes=coll * data, chips=data, model_flops=mf,
                        coll_breakdown={"all-reduce": coll * data} if coll
                        else {}, peak_flops=peak_for(sch.param_dtype(cfg)),
                        compute_s=cost.compute_s * data)
        peak = arg_bytes + cost.peak_bytes
        rec.update({
            "ok": True,
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": cost.end_bytes,
                       "temp_bytes": cost.peak_bytes - cost.end_bytes,
                       "peak_bytes": peak},
            "fits": peak <= HBM_BYTES,
            "params": counts,
            "roofline": roof.as_dict(),
            "grad_reduction": ("int8_ef all_reduce (train/step.py)" if coll
                               else None),
            "kernels": {k: r.as_tuple() for k, r in cost.kernels.items()},
            "top_ops": sorted(((k,) + r.as_tuple()
                               for k, r in cost.ops.items()),
                              key=lambda t: -t[3])[:12],
        })
    except Exception as e:  # a failing cell is a bug; record it loudly
        rec.update({"ok": False, "error": repr(e),
                    "traceback": traceback.format_exc()})
    rec["wall_s"] = round(tm.monotonic() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, _name(arch, shape_name, data, tag)
                           + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary(rec: dict) -> str:
    """One line of a record."""
    head = f"{rec['arch']:20s} {rec['shape']:12s} {rec['mesh']:7s}"
    if not rec["ok"]:
        return f"[FAIL] {head} {rec['error']}"
    r, m = rec["roofline"], rec["memory"]
    return (f"[ok] {head} trace={rec['wall_s']:6.1f}s "
            f"peakGB={m['peak_bytes'] / 1e9:8.1f} fits={rec['fits']!s:5s} "
            f"dom={r['dominant']:10s} roofline={r['roofline_fraction']:.3f}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if args.all:
        cells = arch_shape_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape (or --all) required")
        cells = [(args.arch, args.shape)]
    for arch, shape in cells:
        path = os.path.join(args.out, _name(arch, shape, args.data,
                                            args.tag) + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[skip cached] {arch} {shape} data{args.data}")
            continue
        print(summary(run_cell(arch, shape, args.data, args.tag,
                               out_dir=args.out)), flush=True)


if __name__ == "__main__":
    main()
