"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --smoke --steps 100 --batch 8 --seq 128 [--device cpu]

Port of ``repro.launch.train``, with its flags, plus ``--device``
(default ``cuda``; raises where there is no card).  The log holds every
``TrainConfig.log_every``-th step and the last.  The checkpoints go
to ``--ckpt-dir`` (default ``repro_ckpt`` under the temporary
directory); ``--resume`` continues from the latest one there.  :func:`main` returns the metrics
log (each entry the step's loss, grad norm, learning rate, ``step`` and
``dt``, its seconds), which ``--metrics-out`` also writes as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import SyntheticTokenDataset
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.train import Trainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default="",
                    choices=["", "int8_ef"])
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    args = parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(total_steps=args.steps, learning_rate=args.lr,
                       microbatches=args.microbatches,
                       checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every,
                       grad_compression=args.grad_compression)
    ds = SyntheticTokenDataset(cfg.vocab_size, args.seq, args.batch,
                               seed=tcfg.seed)
    tr = Trainer(cfg, tcfg, ds, ctx=ShardingCtx(), device=args.device)
    if args.resume:
        tr.resume_or_init()
    else:
        tr.init_state()
    log = tr.run(args.steps)
    for m in log[-5:]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in m.items()})
    if tr.watchdog.stragglers:
        print(f"watchdog: {len(tr.watchdog.stragglers)} straggler steps")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(log, f)
    return log


if __name__ == "__main__":
    main(sys.argv[1:])
