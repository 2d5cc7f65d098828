#!/usr/bin/env python3
"""Where the time of flash_attention's bf16 decode form goes, on one card.

    python3 flash_stages.py

Builds copies of ``src/repro_torch/kernels/flash_attention/kernel.cu``
in which ``flash_decode_bf16_kernel`` stops early, each into its own
library under ``build/flash_stages/``, and times each with
``chip_smoke.device_ms`` at phi3's decode (B = 4, C = 160, H = 32, Dh =
96; unsplit and split over 2) and at a 4096-slot cache (split over 8):

* ``empty``: returns at once (the launch of this geometry);
* ``mem``: issues the position loads and copies, waits for all, returns;
* ``noflags``: the whole kernel with every key taken as visible (no
  position load before the copies);
* ``nomerge``: the whole kernel but the merge (its sums kept alive);
* ``full``: the kernel as shipped.

Prints one line a case, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import device_ms, phase_card  # noqa: E402

KERNEL = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/kernel.cu")
# Lines of the decode kernel the variants cut at (each once in the file).
ROUNDS = "  const int n_rounds = ((k1 - k0 + gph - 1) / gph + R - 1) / R;\n"
LOOP = "  // Round r as it lands, the next in flight: the round's R dots (their\n"
MERGE = ("  // The warp's 4 groups (one head) merge by shuffles, then the warps"
         " of\n")
FLAG = ("okr[t] = tt < nk && key_valid(kp_row[k0 + u + gph * tt], qpos, "
        "window);")
KEEP = ("  if (kpr >= 0) { if (m + l + acc[0][0] == 12345.0f) "
        "out[0] = __float2bfloat16_rn(0.0f); return; }\n")


def variants(src: str) -> dict[str, str]:
    for mark in (ROUNDS, LOOP, MERGE, FLAG):
        if src.count(mark) != 1:
            raise SystemExit(f"flash_stages: kernel.cu no longer has {mark!r}")
    return {
        "empty": src.replace(ROUNDS, ROUNDS + "  if (kpr >= 0) return;\n"),
        "mem": src.replace(LOOP, "  if (kpr >= 0) { tf32::cp_async_wait<0>();"
                                 " __syncthreads(); return; }\n" + LOOP),
        "noflags": src.replace(FLAG, "okr[t] = tt < nk;"),
        "nomerge": src.replace(MERGE, KEEP + MERGE),
        "full": src,
    }


def build(out_dir: str) -> dict[str, ctypes.CDLL]:
    """Each variant compiled with the port's flags, in parallel."""
    from repro_torch.kernels import runtime

    header = os.path.join(os.path.dirname(os.path.dirname(KERNEL)),
                          "tf32_mma.cuh")
    procs = {}
    for name, text in variants(open(KERNEL).read()).items():
        d = os.path.join(out_dir, name)
        os.makedirs(os.path.join(d, "flash_attention"), exist_ok=True)
        with open(os.path.join(d, "flash_attention", "kernel.cu"), "w") as f:
            f.write(text)
        shutil.copy(header, d)
        procs[name] = subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"),
             os.path.join(d, "flash_attention", "kernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_stages: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        lib.flash_attention_launch.argtypes = \
            runtime._ARGTYPES["flash_attention_launch"]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_stages: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import EMPTY_POS

    libs = build(os.path.join(ROOT, "build", "flash_stages"))
    g = torch.Generator(device="cuda").manual_seed(1)
    H, Dh = 32, 96
    for B, C, splits in ((4, 160, (1, 2)), (4, 4096, (8,))):
        k, v = (torch.randn((B, C, H, Dh), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        q = torch.randn((B, 1, H, Dh), generator=g,
                        device="cuda").to(torch.bfloat16)
        kp = torch.full((1, C), EMPTY_POS, dtype=torch.int32, device="cuda")
        kp[0, :C - 1] = torch.arange(C - 1, dtype=torch.int32)
        qp = torch.tensor([[C - 2]], dtype=torch.int32, device="cuda")
        out = torch.empty_like(q)
        for split in splits:
            geom = ops.flash_geometry(1, True, B, H, H, C, Dh, split=split)
            times = []
            for name, lib in libs.items():
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        qp.data_ptr(), kp.data_ptr(), out.data_ptr(), B, 1,
                        C, H, H, Dh, 0, 0, 0, Dh ** -0.5, geom.array,
                        runtime.stream_arg(out.device))
                runtime.check_status(name, lib.flash_attention_launch(*args))
                ms = device_ms(lambda: lib.flash_attention_launch(*args),
                               iters=50)
                times.append(f"{name} {ms * 1e3:.2f} us")
            print(f"bf16 decode B={B} C={C} split={split}: "
                  + "; ".join(times))
    phase_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
