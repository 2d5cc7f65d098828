#!/usr/bin/env python3
"""Where the time of slstm_scan's scan and decode forms goes, on one card.

    python3 slstm_stages.py

Builds copies of ``src/repro_torch/kernels/slstm_scan/kernel.cu`` with
one stage of a form cut out or simplified, each into its own library
under ``build/slstm_stages/``, and times each at xlstm-1.3b's shape (B =
4, H = 4, Dh = 512, bf16 gx and R, f32 state) with
``chip_smoke.device_ms``:

* the scan form (``slstm_tc_kernel``) at T = 2, 64 and 128, and its
  step (the slope of T = 128 over T = 64), in the variants ``full`` (as
  shipped), ``nomma`` (no tensor-core products: the h buffers still read
  by ldmatrix), ``halfn`` (the products of n-tile 1, the lo pieces, left
  out: half the mma.sync), ``nogates`` (the gates replaced by a scaled
  sum), ``accurate`` (the gates through expf, tanhf and IEEE division,
  as the general form) and ``local`` (every rank sends its h only to
  itself, 16 times, counted on each source's barrier: no transfer
  between SMs; the waits and bytes the same), each beside its max error
  against the plain version at T = 128 (all but ``full`` and
  ``accurate`` compute something else);
* the decode form (``slstm_decode_kernel``) at T = 1, split over a
  cluster of 1, 2 and 4 blocks, in the variants ``full``, ``empty``
  (returns after its first cluster arrive: the launch of this geometry)
  and ``loads`` (issues R's and h0's loads, waits for them, returns).

Prints one line a form, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import device_ms, phase_card  # noqa: E402

KERNEL = os.path.join(ROOT, "src/repro_torch/kernels/slstm_scan/kernel.cu")
# Lines the variants edit (each once in the file).
MMA = ("        mma_bf16(acc[u][0], a[kt], b[0], b[1]);\n"
       "        mma_bf16(acc[u][1], a[kt], b[2], b[3]);\n")
GATES = ("      c = sigmoid_fast(pre[1]) * c + sigmoid_fast(pre[0]) * "
         "tanh_fast(pre[2]);\n"
         "      h = sigmoid_fast(pre[3]) * tanh_fast(c);\n")
ACCURATE = ("      c = sigmoid_f(pre[1]) * c + sigmoid_f(pre[0]) * tanhf(pre[2]);\n"
            "      h = sigmoid_f(pre[3]) * tanhf(c);\n")
SEND = "        st_async16(map_rank(dst, rr), v, map_rank(bar, rr));\n"
DC_START = ("  const int q = tid / (2 * g.ks), ch = tid & 1, "
            "ks = (tid >> 1) % g.ks;\n")
DC_WAIT = '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'


def variants(src: str) -> dict[str, str]:
    for mark in (MMA, GATES, SEND, DC_START, DC_WAIT):
        if src.count(mark) != 1:
            raise SystemExit(f"slstm_stages: kernel.cu no longer has {mark!r}")
    keep = ("  { unsigned x = 0; for (int i = 0; i < DC_MAX_RPT; ++i) x ^= "
            "w[i].x ^ w[i].w; if (x == 0x9e3779b9u && hsl[tid] == 1.5f) "
            "st_val(hs, 0, 0.0f, sbf); return; }\n")
    return {
        "full": src,
        "nomma": src.replace(MMA, ""),
        "nogates": src.replace(GATES, "      h = 1e-3f * ((pre[0] + pre[1]) "
                               "+ (pre[2] + pre[3]));\n      c = h;\n"),
        "local": src.replace(SEND, "        st_async16(map_rank(dst, rank), "
                             "v, map_rank(bar - 8 * rank + 8 * rr, rank));\n"),
        "halfn": src.replace(MMA, MMA.splitlines(True)[0]),
        "accurate": src.replace(GATES, ACCURATE),
        "empty": src.replace(DC_START, "  return;\n" + DC_START),
        "loads": src.replace(DC_WAIT, keep + DC_WAIT),
    }


def build(out_dir: str) -> dict[str, ctypes.CDLL]:
    """Each variant compiled with the port's flags, in parallel."""
    from repro_torch.kernels import runtime

    procs = {}
    for name, text in variants(open(KERNEL).read()).items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "kernel.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "kernel.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"slstm_stages: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        lib.slstm_scan_launch.argtypes = \
            runtime._ARGTYPES["slstm_scan_launch"]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("slstm_stages: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime
    from repro_torch.kernels.slstm_scan import ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain

    libs = build(os.path.join(ROOT, "build", "slstm_stages"))
    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, Dh = 4, 4, 512
    r = (torch.randn((H, Dh, 4 * Dh), generator=g, device="cuda")
         * 0.02).to(torch.bfloat16)
    h0, c0 = (torch.randn((B, H, Dh), generator=g, device="cuda") * 0.1
              for _ in range(2))
    flags = ops.GX_BF16 | ops.R_BF16

    def time(lib, form, T, split=None):
        gx = (torch.randn((B, T, H, 4 * Dh), generator=g, device="cuda")
              * 0.5).to(torch.bfloat16)
        hs = torch.empty((B, T, H, Dh), device="cuda")
        hT, cT = torch.empty_like(h0), torch.empty_like(c0)
        geom = (ops.decode_geometry(B, Dh, split) if form == ops.FORM_DECODE
                else ops.geometry(form, B, Dh, True))
        args = (gx.data_ptr(), r.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                hs.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H, Dh,
                ops.FORMS[form], geom.array, flags,
                runtime.stream_arg(hs.device))
        runtime.check_status(form, lib.slstm_scan_launch(*args))
        torch.cuda.synchronize()
        err = max((a - p).abs().max().item() for a, p in zip(
            (hs, hT, cT), slstm_scan_plain(gx, r, h0, c0)))
        return device_ms(lambda: lib.slstm_scan_launch(*args), iters=50), err

    parts = []
    for name in ("full", "nomma", "halfn", "nogates", "accurate", "local"):
        t = {T: time(libs[name], ops.FORM_SCAN, T) for T in (2, 64, 128)}
        step = 1e3 * (t[128][0] - t[64][0]) / 64
        parts.append(f"{name} T=2 {t[2][0] * 1e3:.2f} us, T=64 "
                     f"{t[64][0]:.4f} ms, T=128 {t[128][0]:.4f} ms, "
                     f"{step:.3f} us a step (err {t[128][1]:.2e})")
    print("scan form (B=4, H=4, Dh=512): " + "; ".join(parts))
    for split in (4, 2, 1):
        parts = []
        for name in ("full", "empty", "loads"):
            ms, err = time(libs[name], ops.FORM_DECODE, 1, split)
            parts.append(f"{name} {ms * 1e3:.2f} us"
                         + (f" (err {err:.2e})" if name == "full" else ""))
        print(f"decode form (B=4, T=1, H=4, Dh=512, split {split}): "
              + "; ".join(parts))
    phase_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
