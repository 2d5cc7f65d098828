"""Tagged dry-run variants of three cells, printed as deltas against the
untagged baseline.

The port's counterpart of ``src/repro/launch/perf.py``, with the same
three cells and the variants the port's config can express.  Each
hypothesis is about the port's eager program: the counted bytes and the
live-byte peak of one process (``launch/dryrun.py``), not TPU
collectives.  The reference's variants that need ``attn_remat_chunk``,
``gqa_broadcast`` or ``slstm_tp`` are not ported (:data:`NOT_PORTED`):
they are XLA layout knobs the port's config never had.

    python -m repro_torch.launch.perf [--cell mixtral] [--iter 1]

The baselines are read from ``results/dryrun_torch/`` (run
``python -m repro_torch.launch.dryrun`` first); no card is needed.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR, run_cell

# cell -> [(tag, overrides, hypothesis)]
ITERATIONS = {
    "mixtral-8x7b|train_4k": [
        ("grouped_moe", {"moe_dispatch": "grouped"},
         "global dispatch sorts all B*S tokens into one (E, cap, D) "
         "capacity buffer; per-sequence buckets keep the same rows "
         "(cap rounds to 8 per sequence, not 128 overall) -> counted "
         "bytes within a few % and the same peak"),
    ],
    "internvl2-76b|train_4k": [
        ("chunk2k", {"attn_chunk": 2048},
         "the plain attention's online softmax rereads its (m, l, acc) "
         "f32 carry once a KV chunk: 8 -> 2 chunks cuts those passes 4x "
         "but makes each chunk's (B, S, H, 2048) scores 4x larger -> "
         "bytes down, peak up"),
        ("chunk2k_lc", {"attn_chunk": 2048, "loss_chunk": 512},
         "the (B, S, V) f32 logits (and their gradient) are the largest "
         "live tensors of the step; 512-position chunks recomputed in "
         "the backward never hold them whole -> peak down"),
    ],
    "xlstm-1.3b|train_4k": [
        ("mlstm_chunk512", {"mlstm_chunk": 512},
         "the mLSTM state (B, H, Dh, Dh) f32 is carried chunk to chunk: "
         "32 -> 8 chunks cuts its traffic 4x, while each chunk's "
         "(B, H, 512, 512) gate matrix grows 16x -> bytes and peak "
         "decide between them"),
    ],
}

# The reference's variants whose knob the port's config does not have.
NOT_PORTED = {
    "mixtral-8x7b|train_4k": ("grouped_rematchunk",
                              "grouped_rematchunk_c2k"),
    "internvl2-76b|train_4k": ("gqa_take", "chunk2k_rematchunk",
                               "chunk2k_rematchunk_lc"),
    "xlstm-1.3b|train_4k": ("slstm_replicate", "slstm_repl_mlstm512"),
}


def baseline_record(arch: str, shape: str) -> dict:
    with open(os.path.join(RESULTS_DIR,
                           f"{arch}__{shape}__data1.json")) as f:
        return json.load(f)


def show(rec: dict, base: dict) -> None:
    r, b = rec["roofline"], base["roofline"]
    for term in ("t_compute_s", "t_memory_s", "t_collective_s"):
        delta = r[term] / b[term] if b[term] else float("inf")
        print(f"    {term:16s} {b[term]:10.3g} -> {r[term]:10.3g} "
              f"(x{delta:.3f})")
    print(f"    dominant {b['dominant']} -> {r['dominant']}; roofline "
          f"fraction {b['roofline_fraction']:.4f} -> "
          f"{r['roofline_fraction']:.4f}")
    pk = rec["memory"]["peak_bytes"] / 1e9
    pb = base["memory"]["peak_bytes"] / 1e9
    print(f"    peak {pb:.2f} -> {pk:.2f} GB (fits one card: "
          f"{base['fits']} -> {rec['fits']})")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="")
    ap.add_argument("--iter", type=int, default=0)  # 1-based; 0 = all
    args = ap.parse_args(argv)
    for cell, iters in ITERATIONS.items():
        arch, shape = cell.split("|")
        if args.cell and args.cell not in arch:
            continue
        base = baseline_record(arch, shape)
        print(f"== {arch} {shape}: not ported {NOT_PORTED[cell]}")
        for i, (tag, overrides, hypo) in enumerate(iters, 1):
            if args.iter and i != args.iter:
                continue
            print(f"== {arch} {shape} iter {i}: {tag}")
            print(f"   hypothesis: {hypo}")
            rec = run_cell(arch, shape, tag=tag, overrides=overrides)
            if rec["ok"] and base["ok"]:
                show(rec, base)
            else:
                print("   FAILED:", rec.get("error") or base.get("error"))


if __name__ == "__main__":
    main()
