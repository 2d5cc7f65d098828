#!/usr/bin/env python3
"""Time the line-preconditioner kernel (``line_solve``) at the
phi3-circuit node count in one checkout of the port.

    python3 line_ab.py [--src DIR] [--label NAME] [--variants]

Imports ``repro_torch`` from ``DIR`` (default: the ``src`` beside this
script), builds its kernels there and, on one CUDA card, holds its
public ``line_solve`` against the plain version (bit for bit, and
within ``chip_smoke.LINE_TOL``) and times it with
``chip_smoke.device_ms`` at 64x64, 32x32, 128x10 and 128x128 tiles, in
f64 and f32, each at 49,152 x 64 x 64 nodes (random masks at 20%
density; the work does not depend on the data), beside its byte bound.
With ``--variants`` (a checkout whose ``ops`` has ``line_geometry``,
``geometry`` and ``launch``) it also times every geometry of the fast
form that fits: one and two slots, the factor in registers (square 32
and 64; 128 in f32) or in two shared planes, the default odd pitch
(word copies, no bank conflicts) and a 16-byte-aligned one (16-byte
copies, bank conflicts in the wordline sweep); and the stream form; and
prints the build's registers and spills.

Prints one JSON line.  Run it for two checkouts in one call (parent,
change, change, parent) to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from chip_smoke import LINE_TOL, _line_bound, device_ms, phase_build

NODES = 49_152 * 64 * 64
SHAPES = ((64, 64), (32, 32), (128, 10), (128, 128))


def inputs(J: int, K: int, seed: int = 0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    T = NODES // (J * K)
    on = torch.rand((T, J, K), generator=gen, device="cuda") < 0.2
    g = torch.where(on, 1 / 300e3, 1 / 3e6).to(torch.float64)
    r = torch.randn((T, 2, J, K), generator=gen, device="cuda",
                    dtype=torch.float64)
    return g, r


def variants(J: int, K: int, dtype) -> dict:
    """Geometries worth timing against the default: the fast form at one
    and two slots, the factor in registers or in shared planes, a
    16-byte-aligned pitch; the stream form."""
    from repro_torch.kernels.line_solve import ops

    out = {"default": ops.geometry(J, K, dtype)}
    vec = 2 if dtype == torch.float64 else 4
    aligned = -(-K // vec) * vec
    for stages in (1, 2):
        for registers in (True, False):
            for pitch in (None, aligned) if K % vec == 0 else (None,):
                try:
                    geom = ops.line_geometry(J, K, dtype, form="fast",
                                             stages=stages, pitch=pitch,
                                             registers=registers)
                except ValueError:
                    continue
                if geom not in out.values():
                    name = "registers" if registers else "planes"
                    out[f"{name} stages={stages} pitch={geom['pitch']}"] \
                        = geom
    stream = ops.line_geometry(J, K, dtype, form="stream")
    if stream not in out.values():
        out["stream"] = stream
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("line_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.src))
    from repro_torch.kernels.line_solve import line_solve
    from repro_torch.kernels.line_solve.ref import line_solve_plain

    built = phase_build() if a.variants else {}
    out = {"label": a.label, "src": a.src, "card":
           torch.cuda.get_device_name(0), "cases": {}}
    for J, K in SHAPES:
        g64, r64 = inputs(J, K)
        T = g64.shape[0]
        for dtype in (torch.float64, torch.float32):
            dt = "f64" if dtype == torch.float64 else "f32"
            g, r = g64.to(dtype), r64.to(dtype)
            b_ms, _ = _line_bound(T, J, K, dtype)
            want = line_solve_plain(g, r, 0.4)
            runs = {"public": None}
            if a.variants:
                runs.update(variants(J, K, dtype))
            for name, geom in runs.items():
                from repro_torch.kernels.line_solve import ops

                fn = ((lambda: line_solve(g, r, 0.4)) if geom is None else
                      (lambda geom=geom: ops.launch(g, r, 0.4, geom)))
                try:
                    z = fn()
                except (RuntimeError, ValueError) as e:
                    print(f"{a.label} {J}x{K} {dt} {name}: refused ({e})")
                    out["cases"][f"{J}x{K} {dt} {name}"] = {"refused": str(e)}
                    continue
                same = bool(torch.equal(z, want))
                err = (z - want).abs().max().item()
                ok = err <= LINE_TOL[dtype] * want.abs().max().item()
                ms = device_ms(fn, iters=10)
                del z
                print(f"{a.label} {J}x{K} {dt} {name}: {ms:.4f} ms, bound "
                      f"{b_ms:.4f} ({100 * b_ms / ms:.1f}%), bit for bit "
                      f"{same}, max|dz| {err:.3e} {'ok' if ok else 'FAIL'}"
                      + ("" if geom is None else
                         f"; {ops.FORMS[geom['form']]} stages "
                         f"{geom['stages']} pitch {geom['pitch']} "
                         f"registers {geom['reg_len']} smem "
                         f"{geom['smem']}"))
                out["cases"][f"{J}x{K} {dt} {name}"] = dict(
                    ms=ms, bound_ms=b_ms, bit_for_bit=same, max_abs_err=err,
                    ok=ok)
            del g, r, want
        del g64, r64
        torch.cuda.empty_cache()
    out["kernels"] = {k: v for k, v in built.items() if k.startswith("line")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
