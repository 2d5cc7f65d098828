"""Serving launcher: batched greedy (or sampled) generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu] \
        [--trace trace.jsonl]

Port of ``repro.launch.serve``, with its flags, plus ``--device``
(default ``cuda``; raises where there is no card) and ``--trace PATH``,
which turns telemetry on, writes the run's spans to PATH and prints
their table.  Params are drawn from ``torch.Generator(0)`` on the
device; prompts are the synthetic token stream's first batch, or for a
stub-frontend arch its stub embeddings (generator 1).  The engine is the
arch config's own: ``cim.enabled`` decides whether it deploys onto
crossbars.  :func:`main` returns the (batch, gen) tokens, so that a
caller can run the launcher in its own process.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import telemetry as tm
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenDataset
from repro_torch.device import resolve_device
from repro_torch.models.frontend import synthetic_embeddings
from repro_torch.models.model import init_params
from repro_torch.serve import ServeEngine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default="",
                    help="turn telemetry on and write the spans here")
    return ap


def main(argv: list[str] | None = None) -> torch.Tensor:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    was_on = tm.enabled()
    if args.trace:
        tm.enable()
        tm.trace_to(args.trace)
    try:
        with tm.span("launch/serve", arch=args.arch, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen):
            cfg = get_config(args.arch, smoke=args.smoke)
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
            eng = ServeEngine(cfg, params,
                              max_seq=args.prompt_len + args.gen + 1,
                              temperature=args.temperature, device=dev)
            if cfg.frontend:
                prompts = synthetic_embeddings(
                    cfg, args.batch, args.prompt_len,
                    torch.Generator(device=dev).manual_seed(1))
            else:
                ds = SyntheticTokenDataset(cfg.vocab_size, args.prompt_len,
                                           args.batch)
                prompts = torch.from_numpy(
                    ds.batch_at(0)[:, :args.prompt_len])
            t0 = tm.monotonic()
            out = eng.generate(prompts, args.gen).cpu()
            dt = tm.monotonic() - t0
    finally:
        if args.trace:
            tm.trace_stop()
            if not was_on:
                tm.disable()
    toks = args.batch * args.gen
    print(f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"on {dev}, first call: warm-up included)")
    print(out[:2].numpy())
    if args.trace:
        from repro_torch.telemetry.report import report

        print(report(args.trace))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
