#!/usr/bin/env python3
"""Drive the PyTorch port's MDM serving and export paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout and holds each against its plain PyTorch version at the shapes
of the paths below: the five counterparts of the TPU kernels, cim_mvm's
folded forms (gain, column permutation, in-kernel read noise, bf16 x)
and the bf16 forms of flash_attention (its decode form also over a
LONG_C-slot cache, split across a cluster) and slstm_scan included, and
the fold kernel (W' * gain, once a deployment) bit for bit.  Then it drives seven paths
through the entry points a user calls, each with the launch counts set
to 0 just before it and read just after (a check's own launches inside
a path left out):

1. phi3-mini serving: random full-width weights (seed 0, f32, all 32
   layers), ``ServeEngine`` with ``cim.enabled`` (quantise, MDM-plan and
   package every projection on the card, through a plan cache) and
   greedy generation for a batch of prompts (cim_mvm, flash_attention,
   manhattan_score);
2. phi3-continuous: the same weights through ``ContinuousEngine``
   (capacity 8, a cold deploy through a fresh plan cache), 16 requests
   of mixed lengths, half greedy, served three times: in order,
   reversed on a fresh engine over the same bank, and with a hot swap
   to the same checkpoint (cim_mvm, per-lane flash_attention,
   manhattan_score);
3. the deployment-image export of phi3's ``lm_head``: quantise, signed
   codes, ``bitslice_pack`` (bitslice_pack);
4. phi3-nonideal: full-width phi3-mini at its config dtype (bf16),
   random weights from seed 0, on imperfect devices (stuck cells,
   i.i.d. and correlated variation, drift, line opens, read noise;
   ``NONIDEAL``) under the ``spare_line`` mapping, through
   ``ServeEngine`` (cim_fold once a served matrix at deploy, cim_mvm's
   folded forms with read noise and bf16 x, flash_attention in bf16,
   manhattan_score);
5. phi3-health: the same model and devices without line opens, plus
   relaxation (``HEALTH``), aging and healing through
   ``ServeEngine(health=...)``, then at ``CROSS_LAYERS`` layers through
   ``ServeEngine`` and ``ContinuousEngine(health=...)`` with the same
   seed: the reference's escalation arc (warm-up probe
   rounds, then advances of the drift clock that trip recalibration,
   reprogramming and demotion), with batches served between rounds,
   and a heal swap under load at full depth (cim_mvm's batched
   folded decode form for the probes, cim_fold at every refresh,
   cim_mvm's folded forms, flash_attention in bf16, manhattan_score);
6. phi3-circuit: the circuit solver (the repo's SPICE replacement) on
   the crossbar-placed masks of path 1's layer-0 ffn_w_gate (49,152
   tiles of 64x64) under the baseline and MDM placements, through the
   checked batched PCG in mixed and f64 precision, one of the solves
   profiled by kernel; then 512-tile throughput up to the paper's
   128x128 crossbar (a checked mixed solve there), calibrate_eta and a
   Monte-Carlo NF ensemble (line_solve, the line preconditioner's chain
   solve; manhattan_score);
7. xlstm-1.3b serving at its config dtype (bf16): random full-width
   weights (seed 0, all 48 layers), deploy (the reference deploys the
   mLSTM q/k/v) and greedy generation (slstm_scan in bf16,
   manhattan_score).

For each serving path it checks plans built on the card against the
port's CPU mirror, the kernel path's logits and tokens against the
plain path (a bf16 path: every kernel call of a teacher-forced pass
against its plain version on the same inputs, and its deployments
served in f32 end to end), and that every kernel of the path was
launched.  The
continuous path must give every request the same tokens in all three
runs, one call signature each for prefill, decode, join and evict,
greedy tokens equal to ``ServeEngine`` alone (a flip passes only
inside the logits' tolerance, and is listed with its gap), and banks
(cold, and warm from the manifest) bit-identical to ``ServeEngine``'s.
The nonideal path must launch cim_mvm once a forward for every matrix
its open lines did not degrade, fold every such matrix bit-identically
to the fold's plain version (the plain path itself reads the devices'
state, never the fold), give bit-identical tokens in two
``generate`` calls with the same seeds, pass the bf16 checks above at
one read seed, and hold its bf16 logits within 5e-2 x max|logit|.
The health path must give the two engines identical event histories,
every refreshed fold bit-identical to its plain version, every batched
probe read within the cim_mvm tolerance of its plain loop (with and
without read noise), each recalibrated matrix a lower probe error, and
after demotion no cim_mvm launch for a demoted matrix; a heal under
load must leave the sequences in flight their tokens.  The circuit path
must hold line_solve to its plain version (64x64, 32x32, 128x10 and
128x128, f64 and f32), leave no tile unconverged (512 tiles of 128x128
too),
keep mixed within 1e-6 of f64 and 64 tiles within 1e-7 of the CPU's
f64 solve, 4 small tiles within 1e-7 of the dense oracle, and
calibrate_eta's two policies within 1e-8.
Plan caches live in a temporary directory removed at the end.

Every phase prints its result; any failure raises and exits non-zero.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
of JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# f32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# Dense TF32 tensor-core operations/s; a 3xTF32 product counts 3.
PEAK_TF32 = 495e12
# Dense bf16 tensor-core operations/s; flash's bf16 prefill form counts 1
# product for Q.K^T and 3 for P.V (P in three bf16 pieces).
PEAK_BF16 = 989e12
# The long-cache decode case of the bf16 flash check: a cache this long
# splits over a cluster (about 200 MB of K/V at phi3's heads).
LONG_C = 4096
# A torch.cuda._sleep that outlasts the host's enqueue of a timed run
# (~10 ms at the H100's ~1.98 GHz boost clock).
SLEEP_CYCLES = 20_000_000
# Decode timings rotate over copies of the weights this large in all,
# three times the 50 MB L2, so every call finds its weights cold.
COLD_BYTES = 150 * 2 ** 20

B, PROMPT, NEW = 4, 128, 32          # requests served in each path
MAX_SEQ = PROMPT + NEW
# The continuous-batching path: slots, padded prompt length, requests.
CAPACITY, CONT_PROMPT, N_REQUESTS = 8, 128, 16
CIM_TOL = 1e-5       # max|kernel - plain| <= CIM_TOL * max|plain|
FLASH_TOL = 2e-5     # |kernel - plain| <= FLASH_TOL * (1 + |plain|)
SLSTM_TOL = 1e-5     # |kernel - plain| <= SLSTM_TOL * (1 + |plain|)
LOGIT_TOL = 1e-3     # max|kernel - plain| logits <= LOGIT_TOL * max|plain|
# bf16 outputs: kernel and plain version each round once from f32, so a
# value near a rounding boundary may differ by one bf16 ulp (at most
# 2^-7 of it) beyond the f32 tolerance.  A bf16 path is held call by
# call (every kernel launch of a teacher-forced pass against its plain
# version on the same inputs, at the tolerances above plus that ulp) and
# end to end in f32 (its deployments served with f32 activations, at
# LOGIT_TOL): its bf16 logits differ from the plain path's far more than
# any kernel error, because bf16 roundings that flip with the f32
# summation order compound over the layers and steps.
BF16_ULP = 2.0 ** -7
# phi3-nonideal's bf16 logits against the plain path's, a fixed bound:
# the plain path against itself with its crossbar products in f64 moved
# them by 3.67e-2 x max|logit| on an H100 (no kernel involved), so a
# sound kernel path may differ by about that much; 5e-2 leaves margin.
# xlstm's bf16 logits have no such bound: that floor is 0.39 there.
NONIDEAL_BF16_LOGIT_TOL = 5e-2
# The phi3-nonideal path's devices (the paper's setting beyond parasitic
# resistance: stuck cells, i.i.d. and correlated programming variation,
# drift to 10 t0, line opens, per-read noise), seed and mapping.  With
# these line-open rates every full-width matrix keeps programmed bits on
# an open line after the spare-line remap (its random weights leave no
# all-zero row, and a dead wordline severs 8 weights), so every matrix
# would serve digitally: the path deploys this model once to count the
# demotions, and serves the same devices without line opens.
NONIDEAL = dict(p_stuck_off=0.01, p_stuck_on=0.001, sigma_program=0.05,
                sigma_corr=0.05, drift_nu=0.05, drift_time=10.0,
                p_open_wordline=0.002, p_open_bitline=0.002, sigma_read=0.01)
NONIDEAL_SEED, NONIDEAL_PIPELINE = 0, "spare_line"
TF_STEPS = 4         # decode steps of the kernel-vs-plain logits check
# Kernels each path must launch.
PATH_KERNELS = {"phi3": ("cim_mvm", "flash_attention", "manhattan_score"),
                "phi3-continuous": ("cim_mvm", "flash_attention",
                                    "manhattan_score"),
                "export": ("bitslice_pack",),
                "phi3-nonideal": ("cim_mvm", "cim_fold", "flash_attention",
                                  "manhattan_score"),
                "phi3-health": ("cim_mvm", "cim_fold", "cim_mvm_batched",
                                "flash_attention", "manhattan_score"),
                "xlstm": ("slstm_scan", "manhattan_score"),
                "phi3-circuit": ("line_solve", "manhattan_score"),
                "qwen2-moe": ("cim_mvm", "cim_mvm_grouped",
                              "flash_attention", "manhattan_score"),
                "qwen2-moe-nonideal": ("cim_mvm", "cim_mvm_grouped_folded",
                                       "cim_fold", "flash_attention",
                                       "manhattan_score")}
# The paths each kernel record's form runs on (its launches are its
# kernel's launches there).
RECORD_PATHS = {
    "cim_mvm": ("phi3", "phi3-continuous", "qwen2-moe"),
    "flash_attention": ("phi3", "phi3-continuous"),
    "manhattan_score": tuple(PATH_KERNELS),
    "slstm_scan": (),                 # the xlstm path now serves bf16
    "bitslice_pack": ("export",),
    "flash_attention[bf16]": ("phi3-nonideal", "phi3-health"),
    "cim_fold": ("phi3-nonideal", "phi3-health", "qwen2-moe-nonideal"),
    "cim_mvm_batched": ("phi3-health",),
    "slstm_scan[bf16]": ("xlstm",),
    "line_solve": ("phi3-circuit",),
    "cim_mvm_grouped": ("qwen2-moe",),
    "flash_attention[bf16,Dh=128]": ("qwen2-moe", "qwen2-moe-nonideal"),
    "cim_mvm_grouped_folded": ("qwen2-moe-nonideal",),
}
# The paths of every other record (cim_mvm's folded forms).
NONIDEAL_PATHS = ("phi3-nonideal", "phi3-health", "qwen2-moe-nonideal")
# Substrings of the port's CUDA kernel names, as the profiler shows them.
PORT_KERNEL_NAMES = ("cim_decode", "cim_prefill", "cim_fold", "cim_grouped",
                     "flash_decode", "flash_prefill", "score_vec",
                     "score_byte", "slstm_", "pack8_", "pack_kernel")


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, args=None) -> float:
    """Device time of ``fn`` in ms a launch: ``iters`` launches (of
    ``fn(a)`` for ``a`` in ``args`` in turn, if given) queued behind a
    ``torch.cuda._sleep``, so the events time the card's back-to-back
    work and not the host's enqueue."""
    calls = ([lambda: fn()] if args is None
             else [lambda a=a: fn(a) for a in args])
    for c in calls:
        c()
    torch.cuda.synchronize()
    n = max(iters, len(calls))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(n):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, iters: int = 200) -> float:
    """Host time of one call of ``fn`` in us (the enqueue: the card is
    kept busy by a ``torch.cuda._sleep`` so it never waits on it)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def bound(n_bytes: float, n_ops: float,
          peak_ops: float = PEAK_F32) -> tuple[float, str]:
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_card() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return line


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, e.g.
    ``cim_decode_kernel<Li4ELb1>``: an identifier ending in ``kernel``
    whose length prefixes it."""
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*?kernel))", mangled):
        digits, ident = m.groups()
        if int(digits) == len(ident):
            rest = mangled[m.start() + len(digits) + len(ident):]
            args = re.match(r"I(.*?)EE", rest)
            return ident + (f"<{args.group(1)}>" if args else "")
    return mangled


def phase_build() -> dict:
    """Build the kernels; print, per compiled kernel, its target,
    registers and spills (``-Xptxas -v``), the tensor-core instructions
    in its SASS and its SASS instruction count (``cuobjdump``, where the
    toolkit has it).  Returns kernel name -> {"regs", "spill", "sass"}."""
    from repro_torch.kernels import runtime
    from torch.utils.cpp_extension import CUDA_HOME

    t0 = time.perf_counter()
    runtime.library()
    dt = time.perf_counter() - t0
    info = runtime.build_info()
    print(f"phase build: {'built' if info['built'] else 'loaded'} "
          f"{os.path.relpath(info['path'], ROOT)} in {dt:.1f} s "
          "(nvcc sm_90a, one process per source)")

    mma: dict = {}
    sass_n: dict = {}
    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin",
                             "cuobjdump")
    if os.path.exists(cuobjdump):
        fn = None
        sass = subprocess.run([cuobjdump, "-sass", info["path"]],
                              capture_output=True, text=True).stdout
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                sass_n[fn] = 0
                continue
            if fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line) \
                    and " NOP" not in line:
                sass_n[fn] += 1
            if fn and ("HMMA" in line or "HGMMA" in line):
                op = "HGMMA" if "HGMMA" in line else "HMMA"
                mma.setdefault(fn, {}).setdefault(op, 0)
                mma[fn][op] += 1
    built: dict = {}
    kernel = None
    for line in info["log"].splitlines():
        m = re.search(r"entry function '(\S+)' for '(\w+)'", line)
        if m:
            kernel = m.group(1)
            built[kernel_name(kernel)] = {"sass": sass_n.get(kernel),
                                          "mma": mma.get(kernel, {})}
            print(f"  {kernel_name(kernel)} for {m.group(2)}: "
                  f"{mma.get(kernel, {}) or 'no tensor-core instructions'}, "
                  f"{sass_n.get(kernel, '?')} SASS instructions", end="")
        elif kernel and ("registers" in line or "spill" in line):
            print("; " + line.split(":")[-1].strip(), end="")
            entry = built[kernel_name(kernel)]
            if "spill" in line:
                entry["spill"] = sum(int(n) for n in re.findall(
                    r"(\d+) bytes spill", line))
            if "registers" in line:
                entry["regs"] = int(re.search(r"Used (\d+) registers",
                                              line).group(1))
                print()
                kernel = None
    print(f"  (SASS counts from {os.path.basename(cuobjdump)}"
          f"{'' if os.path.exists(cuobjdump) else ': not found'})")
    return built


def _deploy_random(I: int, N: int, seed: int):
    from repro_torch.configs.phi3_mini_38b import CONFIG
    from repro_torch.deploy import spec_from_config
    from repro_torch.kernels.cim_mvm import deploy

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((I, N), generator=g, device="cuda") * 0.02
    cfg = CONFIG.replace(dtype="float32")
    dep, plan = deploy(w, spec_from_config(cfg), "mdm", eta=cfg.cim.eta)
    return dep, plan


def _check_cim(g) -> dict:
    """cim_mvm at the three matrix shapes of phi3 and the paths' row
    counts (ServeEngine's decode M = 1 and M = B and prefill M = B *
    PROMPT; ContinuousEngine's decode M = CAPACITY and prefill M =
    CONT_PROMPT): against its
    plain version, device time warm and, at decode, cold (rotating over
    copies of the deployment larger than L2 together, as a decode step
    finds its weights), beside ``x @ W'`` on the materialised f32 W'
    timed the same way."""
    from repro_torch.kernels.cim_mvm.ops import DECODE_MAX_M, cim_mvm
    from repro_torch.kernels.cim_mvm.ref import (
        cim_effective_weights,
        cim_mvm_plain,
    )

    regimes = {}
    for (I, N) in ((3072, 3072), (3072, 8192), (8192, 3072)):
        dep, _ = _deploy_random(I, N, seed=I + N)
        w_eff = cim_effective_weights(
            dep.codes, dep.pos, dep.scale, n_bits=dep.n_bits, wpt=dep.wpt,
            cols=dep.cols, eta=dep.eta, reversed_df=dep.reversed_df)
        dep_bytes = dep.codes.numel() * 2 + dep.pos.numel() * 4
        n_dep = max(2, -(-COLD_BYTES // dep_bytes))
        deps = [dep] + [dataclasses.replace(
            dep, codes=dep.codes.clone(), pos=dep.pos.clone(),
            scale=dep.scale.clone()) for _ in range(n_dep - 1)]
        n_w = max(2, -(-COLD_BYTES // (w_eff.numel() * 4)))
        ws = [w_eff] + [w_eff.clone() for _ in range(n_w - 1)]
        for M in (1, B, CAPACITY, CONT_PROMPT, B * PROMPT):
            x = torch.randn((M, I), generator=g, device="cuda")
            y_k = cim_mvm(x, dep)
            y_p = cim_mvm_plain(x, dep)
            torch.cuda.synchronize()
            err = (y_k - y_p).abs().max().item()
            ref = y_p.abs().max().item()
            ok = err <= CIM_TOL * ref
            ms = device_ms(lambda: cim_mvm(x, dep))
            plain_ms = cuda_ms(lambda: cim_mvm_plain(x, dep), iters=5)
            lib_ms = device_ms(lambda: x @ w_eff)
            n_bytes = (x.numel() * 4 + dep_bytes + 4 + M * N * 4)
            flops = 2.0 * M * I * N
            b_ms, b_by = bound(n_bytes, flops)
            tc_ms, tc_by = bound(n_bytes, 3 * flops, PEAK_TF32)
            bytes_ms = n_bytes / PEAK_BYTES * 1e3
            line = (f"cim_mvm M={M:4d} I={I} N={N}: max_abs_err {err:.3e} "
                    f"(tol {CIM_TOL:g} x max|y| {ref:.3e}) "
                    f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms warm, "
                    f"plain {plain_ms:.4f} ms, x @ W' {lib_ms:.4f} ms warm; "
                    f"bound {b_ms:.4f} ms ({b_by}, f32), {tc_ms:.4f} ms "
                    f"({tc_by}, 3xTF32); bytes alone {bytes_ms:.4f} ms "
                    f"({n_bytes / 1e6:.1f} MB)")
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       bound_bytes_ms=bytes_ms)
            if M <= DECODE_MAX_M:
                cold = device_ms(lambda d: cim_mvm(x, d), args=deps)
                lib_cold = device_ms(lambda w: x @ w, args=ws)
                line += (f"; cold ({n_dep} copies): kernel {cold:.4f} ms, "
                         f"x @ W' {lib_cold:.4f} ms")
                rec.update(ms=cold, library_ms=lib_cold, ms_warm=ms,
                           library_ms_warm=lib_ms)
            else:
                rec.update(bound_ms=tc_ms, bound_by=tc_by,
                           bound_f32_ms=b_ms)
            print(line)
            if not ok:
                raise AssertionError(f"cim_mvm disagrees at M={M} I={I} N={N}")
            regime = {B: "decode", B * PROMPT: "prefill",
                      CAPACITY: "decode_continuous",
                      CONT_PROMPT: "prefill_continuous"}.get(M)
            if (I, N) == (3072, 8192) and regime:
                regimes[regime] = dict(M=M, I=I, N=N, **rec)
        if (I, N) == (3072, 3072):
            x = torch.randn((B, I), generator=g, device="cuda")
            print(f"  cim_mvm wrapper host time (M={B}, {I}x{N}): "
                  f"{host_us(lambda: cim_mvm(x, dep)):.1f} us a call, of "
                  f"which the C launch alone "
                  f"{host_us(_bare_cim_launch(x, dep)):.1f} us")
        del dep, deps, w_eff, ws
    return dict(name="cim_mvm", route="cuda",
                source="src/repro_torch/kernels/cim_mvm/kernel.cu",
                replaces="src/repro/kernels/cim_mvm/kernel.py:82",
                **{k: v for k, v in regimes["decode"].items()
                   if k not in ("M", "I", "N")},
                regimes=regimes)


def _bare_cim_launch(x, dep):
    """The cim_mvm launcher called directly (geometry, output and
    stream prepared once): the part of a call no Python can cut."""
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cim_mvm.ops import _sm_count, cim_geometry

    out = torch.empty((x.shape[0], dep.out_dim), device="cuda")
    geom = cim_geometry(x.shape[0], dep.in_dim, dep.out_dim,
                        *dep.codes.shape, dep.wpt, dep.n_bits, dep.cols,
                        dep.reversed_df, _sm_count(0),
                        dep.codes.data_ptr() % 16 == 0)
    args = (x.data_ptr(), dep.codes.data_ptr(), dep.pos.data_ptr(),
            dep.scale.data_ptr(), out.data_ptr(), geom.array, dep.eta,
            None, 0, 0, 0.0, runtime.stream_arg(out.device))
    launch = runtime.library().cim_mvm_launch
    return lambda: launch(*args)


# Operations a weight of the read noise before the SASS count: one
# Philox4x32-10 call (10 rounds of 2 high and 2 low 32-bit products, 4
# xors and 2 key adds: 100) for four weights, one Box-Muller (~15) for
# two normals, and 2 to scale eps and add it: 35 a weight, the estimate
# the unfolded forms' bounds used.  The run replaces it by the count from
# the SASS (:func:`noise_ops`).
NOISE_OPS_ESTIMATE = 35
NONIDEAL_FORMS = ("gain", "colpos", "noise", "all")


def noise_ops(built: dict) -> tuple[float, dict]:
    """SASS instructions a weight of the read noise, counted at the f32
    rate as the other integer work here: the SASS of the folded forms
    with noise less the SASS of the same forms without, over the weights
    whose noise their unrolled code draws (the decode form at MT = 4:
    2 rows a step, 8 columns each; the prefill form: 8 pieces of a slab,
    4 weights each).  The decode form's count is the one used; the
    estimate where no SASS was read."""
    counts = {}
    for name, pair, weights in (
            ("decode", ("cim_decode_folded_kernel<Li4ELb1>",
                        "cim_decode_folded_kernel<Li4ELb0>"), 2 * 8),
            ("prefill", ("cim_prefill_folded_kernel<Lb1>",
                         "cim_prefill_folded_kernel<Lb0>"), 8 * 4)):
        n = [built.get(k, {}).get("sass") for k in pair]
        if None not in n:
            counts[name] = (n[0] - n[1]) / weights
    ops = counts.get("decode", NOISE_OPS_ESTIMATE)
    print(f"  read noise: {counts or 'no SASS'} SASS instructions a weight "
          f"(noise form less noiseless form, over the weights drawn); "
          f"bounds use {ops:.2f} (the earlier estimate: "
          f"{NOISE_OPS_ESTIMATE})")
    return ops, counts


def _nonideal_dep(I: int, N: int, form: str, seed: int):
    """A deployment of a random (I, N) matrix with phi3's spec carrying
    the operands of ``form``: a log-normal gain (sigma 0.05), the
    bitline permutation of the X-CHANGR column sort, read noise
    (sigma_read 0.01, tag 3); not folded."""
    from repro_torch.configs.phi3_mini_38b import CONFIG
    from repro_torch.deploy import spec_from_config
    from repro_torch.kernels.cim_mvm import deploy

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((I, N), generator=g, device="cuda") * 0.02
    mode = "xchangr" if form in ("colpos", "all") else "mdm"
    dep, _ = deploy(w, spec_from_config(CONFIG), mode, eta=CONFIG.cim.eta)
    extra = {}
    if form in ("gain", "all"):
        extra["gain"] = torch.exp(0.05 * torch.randn(
            dep.codes.shape, generator=g, device="cuda"))
    if form in ("noise", "all"):
        extra.update(noise_tag=torch.tensor(3, dtype=torch.int32),
                     sigma_read=0.01)
    return dataclasses.replace(dep, **extra)


def _operand_bytes(dep) -> int:
    """Bytes of a deployment's unfolded operands: codes, pos, gain and
    col_pos (what the unfolded nonideal forms read)."""
    return sum(t.numel() * t.element_size()
               for t in (dep.codes, dep.pos, dep.gain, dep.col_pos)
               if t is not None)


def _occupancy(built: dict, kernel: str, geom) -> dict:
    """``kernel``'s registers and spills (this run's ``-Xptxas -v``) and
    its occupancy at ``geom``'s launch, from the CUDA runtime's occupancy
    calculator in the built library (``ops.occupancy``): blocks a SM and,
    for a cluster launch, clusters the card holds at once."""
    from repro_torch.kernels.cim_mvm.ops import occupancy

    return dict(kernel=kernel, registers=built.get(kernel, {}).get("regs"),
                spill_bytes=built.get(kernel, {}).get("spill"),
                **occupancy(geom))


def _occ_text(occ: dict) -> str:
    return (f"{occ['registers']} registers, {occ['blocks_per_sm']} blocks "
            f"a SM" + (f", {occ['clusters']} clusters on the card"
                       if occ["clusters"] else ""))


def _check_cim_fold(built: dict) -> dict:
    """The fold kernel (W'(col_pos) * gain, once a deployment) on phi3's
    three matrix shapes with every operand: bit for bit against its plain
    version, device time a matrix beside its byte bound and the plain
    version's time.  No single PyTorch call computes it."""
    from repro_torch.kernels.cim_mvm.ops import fold_geometry, fold_weights
    from repro_torch.kernels.cim_mvm.ref import folded_weights

    regimes = {}
    for (I, N) in ((3072, 8192), (3072, 3072), (8192, 3072)):
        dep = _nonideal_dep(I, N, "all", I + N)
        got = fold_weights(dep)
        want = folded_weights(dep)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        ms = device_ms(lambda: fold_weights(dep))
        plain_ms = cuda_ms(lambda: folded_weights(dep), iters=3)
        n_bytes = _operand_bytes(dep) + 4 + got.numel() * 4
        b_ms, b_by = bound(n_bytes, 0.0)
        rows = dep.codes.shape[0] // dep.col_pos.shape[0]
        geom = fold_geometry(*dep.codes.shape, dep.wpt, dep.n_bits,
                             dep.cols, dep.reversed_df, True, rows)
        occ = _occupancy(built, f"cim_fold_kernel<Lb{geom.fast}ELb"
                                f"{int(geom.rows > 0)}>", geom)
        print(f"cim_fold {I}x{N} (gain, col_pos): bit-identical to the "
              f"plain version {'ok' if exact else 'FAIL'}; kernel {ms:.4f} "
              f"ms a matrix, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {n_bytes / 1e6:.1f} MB); {_occ_text(occ)}")
        if not exact:
            raise AssertionError(f"cim_fold differs from its plain version "
                                 f"at {I}x{N}")
        regimes[f"{I}x{N}"] = dict(max_abs_err=0.0, ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None, **occ)
        del dep, got, want
    return dict(name="cim_fold", route="cuda",
                source="src/repro_torch/kernels/cim_mvm/kernel.cu",
                replaces="src/repro/kernels/cim_mvm/xla.py:101 "
                         "(cim_effective_weights * gain in cim_mvm_xla; "
                         "not a TPU kernel)",
                **{k: v for k, v in regimes["3072x8192"].items()
                   if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                regimes=regimes)


def _check_cim_nonideal(g, built: dict) -> list[dict]:
    """cim_mvm's folded forms on deployments with nonideal operands (gain,
    column permutation, in-kernel read noise, all three) at phi3's shapes
    and the paths' row counts, x in bf16 as the bf16 engines give it: the
    kernel on the folded deployment against the plain version on the
    unfolded one at the same read seed, device time beside ``x @ W_eff``
    (the f32 W' with gain and noise materialised).  One record for the
    decode form (M = B, cold) and one for the prefill form (M = B *
    PROMPT), each with every form and shape as a regime, its registers
    and blocks a SM."""
    from repro_torch.kernels.cim_mvm.ops import (
        DECODE_MAX_M,
        _sm_count,
        cim_geometry,
        cim_mvm,
        fold,
    )
    from repro_torch.kernels.cim_mvm.ref import (
        cim_mvm_plain,
        deployment_weights,
    )

    n_ops, _ = noise_ops(built)
    seed = 21
    regimes = {"decode": {}, "prefill": {}}
    for (I, N) in ((3072, 8192), (3072, 3072), (8192, 3072)):
        for form in NONIDEAL_FORMS:
            if (I, N) != (3072, 8192) and form != "all":
                continue
            raw = _nonideal_dep(I, N, form, I + N)
            dep = fold(raw)
            w_eff = deployment_weights(raw, seed)
            old_bytes = _operand_bytes(raw)
            dep_bytes = dep.folded.numel() * 4
            n_dep = max(2, -(-COLD_BYTES // dep_bytes))
            deps = [dep]
            for _ in range(n_dep - 1):
                deps.append(dataclasses.replace(dep))
                deps[-1].folded = dep.folded.clone()
            n_w = max(2, -(-COLD_BYTES // (w_eff.numel() * 4)))
            ws = [w_eff] + [w_eff.clone() for _ in range(n_w - 1)]
            rows = ((1, B, CAPACITY, CONT_PROMPT, B * PROMPT)
                    if form == "all" else (B, B * PROMPT))
            for M in rows:
                x = torch.randn((M, I), generator=g, device="cuda").to(
                    torch.bfloat16)
                xf = x.float()
                y_k = cim_mvm(x, dep, seed)
                y_p = cim_mvm_plain(x, raw, seed)
                torch.cuda.synchronize()
                err = (y_k - y_p).abs().max().item()
                ref = y_p.abs().max().item()
                ok = err <= CIM_TOL * ref
                ms = device_ms(lambda: cim_mvm(x, dep, seed))
                plain_ms = cuda_ms(lambda: cim_mvm_plain(x, raw, seed),
                                   iters=3)
                lib_ms = device_ms(lambda: xf @ w_eff)
                io = x.numel() * 2 + 4 + M * N * 4
                n_bytes, unf_bytes = io + dep_bytes, io + old_bytes
                flops = 2.0 * M * I * N
                extra_ops = n_ops * I * N if dep.sigma_read else 0.0
                b_ms, b_by = bound(n_bytes, flops + extra_ops)
                # Prefill: the products on the tensor cores (3xTF32 with
                # f32 x; bf16 x has no lo part: 2 TF32 products), the
                # noise on the CUDA cores beside them.
                t_b, t_tc, t_alu = (n_bytes / PEAK_BYTES,
                                    2 * flops / PEAK_TF32,
                                    extra_ops / PEAK_F32)
                tc_ms = max(t_b, t_tc, t_alu) * 1e3
                tc_by = "bytes" if t_b >= max(t_tc, t_alu) else "operations"
                decode = M <= DECODE_MAX_M
                geom = cim_geometry(M, I, N, *dep.codes.shape, dep.wpt,
                                    dep.n_bits, dep.cols, dep.reversed_df,
                                    _sm_count(0), True, True, True,
                                    bool(dep.sigma_read))
                noise = int(bool(dep.sigma_read))
                kname = (f"cim_decode_folded_kernel<Li{geom.mt}ELb{noise}>"
                         if geom.form == 2
                         else f"cim_prefill_folded_kernel<Lb{noise}>")
                occ = _occupancy(built, kname, geom)
                line = (f"cim_mvm[{form}] M={M:4d} I={I} N={N} x bf16: "
                        f"max_abs_err {err:.3e} (tol {CIM_TOL:g} x max|y| "
                        f"{ref:.3e}) {'ok' if ok else 'FAIL'}; kernel "
                        f"{ms:.4f} ms warm, plain {plain_ms:.4f} ms, "
                        f"x @ W_eff {lib_ms:.4f} ms warm; bound {b_ms:.4f} "
                        f"ms ({b_by}, f32; {n_bytes / 1e6:.1f} MB; the "
                        f"unfolded operands {unf_bytes / 1e6:.1f} MB, "
                        f"{unf_bytes / PEAK_BYTES * 1e3:.4f} ms), "
                        f"{tc_ms:.4f} ms ({tc_by}, TF32 products); "
                        f"{_occ_text(occ)}")
                rec = dict(M=M, I=I, N=N, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms,
                           bound_unfolded_bytes_ms=unf_bytes / PEAK_BYTES
                           * 1e3,
                           **occ)
                if decode:
                    cold = device_ms(lambda d: cim_mvm(x, d, seed), args=deps)
                    lib_cold = device_ms(lambda w: xf @ w, args=ws)
                    line += (f"; cold ({n_dep} copies): kernel {cold:.4f} "
                             f"ms, x @ W_eff {lib_cold:.4f} ms")
                    rec.update(ms=cold, library_ms=lib_cold, ms_warm=ms,
                               library_ms_warm=lib_ms)
                else:
                    rec.update(bound_ms=tc_ms, bound_by=tc_by,
                               bound_f32_ms=b_ms)
                print(line)
                if not ok:
                    raise AssertionError(f"cim_mvm[{form}] disagrees at "
                                         f"M={M} I={I} N={N}")
                regimes["decode" if decode else "prefill"][
                    f"{form} M={M} {I}x{N}"] = rec
            if form == "all" and (I, N) == (3072, 8192):
                xb = torch.randn((B, I), generator=g, device="cuda").to(
                    torch.bfloat16)
                same = all(torch.equal(cim_mvm(xs, dep, seed),
                                       cim_mvm(xs, dep, seed))
                           for xs in (xb, torch.cat([xb] * PROMPT)))
                print(f"  read noise bit-identical across two calls "
                      f"(M = {B}, {B * PROMPT}): {'ok' if same else 'FAIL'}")
                if not same:
                    raise AssertionError("two noisy reads with one seed "
                                         "differ")
            del dep, raw, deps, w_eff, ws
    out = []
    for form, key in (("decode", f"all M={B} 3072x8192"),
                      ("prefill", f"all M={B * PROMPT} 3072x8192")):
        main = {k: v for k, v in regimes[form][key].items()
                if k not in ("M", "I", "N")}
        out.append(dict(
            name=f"cim_mvm[gain+col_pos+read_noise, bf16 x, {form}]",
            route="cuda", source="src/repro_torch/kernels/cim_mvm/kernel.cu",
            replaces="src/repro/kernels/cim_mvm/kernel.py:82", **main,
            regimes=regimes[form], noise_ops=n_ops))
    return out


def _sdpa_kernels(fn) -> list[str]:
    """Names of the CUDA kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def _flash_cases(long: bool = False):
    """(name, B, Sq, C, q positions, k positions) of the flash checks, at
    phi3's heads over a MAX_SEQ-long cache whose unwritten slots hold
    EMPTY_POS: the shared-position prefill and decode of ServeEngine,
    and the per-lane forms of ContinuousEngine: one padded prompt's
    prefill (B = 1, Sq = CONT_PROMPT), and a decode over CAPACITY lanes
    at staggered clocks, two of them dead (all EMPTY_POS); with ``long``
    also a decode of B lanes over a LONG_C-long cache."""
    from repro_torch.kernels.flash_attention.ref import EMPTY_POS

    def kpos_rows(filled, C=MAX_SEQ):
        kp = torch.full((len(filled), C), EMPTY_POS, dtype=torch.int32,
                        device="cuda")
        for b, n in enumerate(filled):
            kp[b, :n] = torch.arange(n, dtype=torch.int32)
        return kp

    cases = []
    for name, Sq, filled, C in (("prefill", PROMPT, PROMPT, MAX_SEQ),
                                ("decode", 1, MAX_SEQ - 1, MAX_SEQ),
                                ("decode_long", 1, LONG_C - 1, LONG_C)):
        if name == "decode_long" and not long:
            continue
        qpos = torch.arange(filled - Sq, filled, dtype=torch.int32,
                            device="cuda")
        cases.append((name, B, Sq, C, qpos, kpos_rows([filled], C)[0]))
    cases.append(("prefill_lanes", 1, CONT_PROMPT, MAX_SEQ,
                  torch.arange(CONT_PROMPT, dtype=torch.int32,
                               device="cuda")[None],
                  kpos_rows([CONT_PROMPT])))
    filled = [0, 0, 17, 40, 77, 128, 150, MAX_SEQ - 1][:CAPACITY]
    cases.append(("decode_lanes", CAPACITY, 1, MAX_SEQ,
                  torch.tensor([max(n - 1, 0) for n in filled],
                               dtype=torch.int32, device="cuda")[:, None],
                  kpos_rows(filled)))
    return cases


def _flash_variants(run_geom, o_p, geom, built: dict, Dh: int) -> dict:
    """A bf16 form's launch ``geom`` (chosen by ``flash_geometry``) and,
    for the decode form, its other cluster splits (1 and 2 blocks, or 4
    and 8): each one's device time, occupancy, registers and error
    against the plain version ``o_p``, held to the same tolerance."""
    from repro_torch.kernels.flash_attention import ops

    g = geom.geom
    pre = g["form"] == ops.FORM_PREFILL_BF16
    key, values = (("warps", (ops.BF16_PREFILL_WARPS,)) if pre else
                   ("split", (1, 2) if g["gx"] <= 2 else (4, 8)))
    dc = -(-Dh // 32)
    out = {}
    for val in values:
        vg = run_geom() if pre else run_geom(split=val)
        o = vg[1]().float()
        err = (o - o_p).abs().max().item()
        if ((o - o_p).abs() - FLASH_TOL * (1 + o_p.abs())
                - BF16_ULP * o_p.abs()).max().item() > 0:
            raise AssertionError(f"flash bf16 disagrees at {key}={val}")
        kern = (f"flash_prefill_bf16_kernel<Li{dc}>" if pre
                else f"flash_decode_bf16_kernel<Li{dc}>")
        occ = ops.occupancy(vg[0], Dh)
        out[f"{key}={val}"] = dict(
            ms=device_ms(vg[1]), max_abs_err=err, kernel=kern,
            registers=built.get(kern, {}).get("regs"),
            spill_bytes=built.get(kern, {}).get("spill"),
            sass=built.get(kern, {}).get("sass"),
            mma=built.get(kern, {}).get("mma"), **occ,
            chosen=pre or val == g["gx"])
    return out


def _check_flash(g, dtype=torch.float32, built: dict | None = None,
                 H: int = 32, Dh: int = 96, cases=None,
                 name: str | None = None) -> dict:
    """flash attention at the paths' shapes (``_flash_cases``, or those of
    them named in ``cases``; bf16 also at a LONG_C-long cache), H heads of
    Dh (phi3's 32 of 96 by default), q, k and v in ``dtype``, against
    its plain version; device time beside SDPA on the same inputs, the
    byte bound and the tensor-core bound of the form's products.  bf16
    outputs: both sides round once from f32, so a value near a rounding
    boundary may differ by one bf16 ulp (2^-7 relative) beyond the f32
    tolerance.  bf16: each case also at the form's other geometries
    (:func:`_flash_variants`), with registers, SASS and blocks a SM."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ops import (
        DECODE_MAX_SQ,
        flash_attention,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    bf = dtype == torch.bfloat16
    esize = 2 if bf else 4
    regimes = {}
    record = name or ("flash_attention[bf16]" if bf else "flash_attention")
    for name, Bq, Sq, C, qpos, kpos in _flash_cases(long=bf):
        if cases is not None and name not in cases:
            continue
        k = torch.randn((Bq, C, H, Dh), generator=g, device="cuda").to(dtype)
        v = torch.randn((Bq, C, H, Dh), generator=g, device="cuda").to(dtype)
        q = torch.randn((Bq, Sq, H, Dh), generator=g,
                        device="cuda").to(dtype)
        run = lambda: flash_attention(q, k, v, q_positions=qpos,
                                      k_positions=kpos)
        o_k = run().float()
        o_p = flash_attention_plain(q, k, v, qpos, kpos).float()
        torch.cuda.synchronize()
        err = (o_k - o_p).abs().max().item()
        excess = ((o_k - o_p).abs() - FLASH_TOL * (1 + o_p.abs())
                  - (BF16_ULP * o_p.abs() if bf else 0)).max()
        ok = excess.item() <= 0 and torch.equal(run(), run())
        ms = device_ms(run)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, qpos, kpos),
                           iters=3 if C > MAX_SEQ else 20)
        qp = qpos if qpos.ndim == 2 else qpos[None]
        kp = kpos if kpos.ndim == 2 else kpos[None]
        mask = (kp[:, None, :] <= qp[:, :, None])           # (b, Sq, C)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None])
        lib_ms = device_ms(sdpa)
        pairs = int(mask.sum().item()) * H * (Bq if mask.shape[0] == 1
                                              else 1)
        # Q read and O written once; K and V only at the slots some query
        # of the lane can see (EMPTY_POS slots and keys past every query
        # need no read).
        seen = int(mask.any(1).sum().item()) * (Bq if mask.shape[0] == 1
                                                else 1)
        n_bytes = (2 * q.numel() + 2 * seen * H * Dh) * esize \
            + (qpos.numel() + kpos.numel()) * 4
        # Q.K^T and P.V over the valid pairs, 2 Dh operations each.
        b_ms, b_by = bound(n_bytes, pairs * 4.0 * Dh)
        # Tensor-core products: f32 3xTF32 (3 a product); bf16 1 for
        # Q.K^T and 3 for P.V.
        tc_ops, tc_peak = ((2 * pairs * 4.0 * Dh, PEAK_BF16) if bf
                           else (3 * pairs * 4.0 * Dh, PEAK_TF32))
        tc_ms, tc_by = bound(n_bytes, tc_ops, tc_peak)
        print(f"flash{'[bf16]' if bf else ''} {name} B={Bq} Sq={Sq} "
              f"C={C} H={H} Dh={Dh} "
              f"positions {tuple(qpos.shape)}/{tuple(kpos.shape)}: "
              f"max_abs_err {err:.3e} (tol {FLASH_TOL:g}(1+|ref|)"
              f"{' + 2^-7|ref|' if bf else ''}, two calls bit-identical) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}, f32), {tc_ms:.4f} ms ({tc_by}, "
              f"{'bf16 1+3 products' if bf else '3xTF32'}; the products "
              f"alone {tc_ops / tc_peak * 1e3:.4f} ms); "
              f"host {host_us(run):.1f} us a call")
        if name in ("prefill", "decode") and not bf:
            print(f"  sdpa kernels: {_sdpa_kernels(sdpa)}")
        if not ok:
            raise AssertionError(f"flash attention disagrees ({name})")
        if name == "decode_lanes" and not (o_k[:2] == 0).all():
            raise AssertionError("dead lanes attend to something")
        # The prefill forms run their products on tensor cores, the
        # decode forms in f32 on the CUDA cores.
        pre = Sq > DECODE_MAX_SQ
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=tc_ms if pre else b_ms,
                   bound_by=tc_by if pre else b_by, library_ms=lib_ms,
                   bound_bytes_ms=n_bytes / PEAK_BYTES * 1e3)
        if pre:
            rec["bound_f32_ms"] = b_ms
        if bf:
            rec["bound_bf16_ms"] = tc_ms
            rec["bf16_products_ms"] = tc_ops / tc_peak * 1e3
            geom = ops.flash_geometry(Sq, True, Bq, H, H, C, Dh)

            def run_geom(**kw):
                vg = ops.flash_geometry(Sq, True, Bq, H, H, C, Dh, **kw)
                return vg, lambda: ops.launch(q, k, v, qpos, kpos, 0, vg)

            rec["geometry"] = geom.geom
            rec["variants"] = _flash_variants(run_geom, o_p, geom,
                                              built or {}, Dh)
            for key, var in rec["variants"].items():
                print(f"  {key}{' (chosen)' if var['chosen'] else ''}: "
                      f"{var['ms']:.4f} ms, max_abs_err "
                      f"{var['max_abs_err']:.3e}; {var['kernel']}: "
                      f"{var['registers']} registers, {var['spill_bytes']} "
                      f"bytes spilled, {var['sass']} SASS, {var['mma']}, "
                      f"{var['blocks_per_sm']} blocks a SM"
                      + (f", {var['clusters']} clusters on the card"
                         if var["clusters"] else ""))
        regimes[name] = dict(B=Bq, Sq=Sq, C=C, **rec)
    return dict(name=record, route="cuda",
                source="src/repro_torch/kernels/flash_attention/kernel.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:75",
                **{k: v for k, v in regimes["prefill"].items()
                   if k not in ("B", "Sq", "C", "geometry", "variants")},
                regimes=regimes)


def phase_kernels(built: dict) -> list[dict]:
    """Each kernel against its plain version at the slice's shapes;
    ``built``: registers and SASS counts (:func:`phase_build`)."""
    from repro_torch.kernels.manhattan_score.ops import manhattan_score
    from repro_torch.kernels.manhattan_score.ref import manhattan_score_plain
    from repro_torch.core.bitslice import codes_to_bits, quantize_magnitude
    from repro_torch.core.tiling import CrossbarSpec, tile_masks

    g = torch.Generator(device="cuda").manual_seed(1)
    records = [_check_cim(g), _check_flash(g)]

    records.append(_check_manhattan(g))
    records.append(_check_slstm_scan(g))
    records.append(_check_cim_fold(built))
    records += _check_cim_nonideal(g, built)
    records.append(_check_flash(g, torch.bfloat16, built))
    records.append(_check_slstm_scan(g, torch.bfloat16))
    return records


def _check_manhattan(g) -> dict:
    """manhattan_score on one full 3072 x 8192 matrix's tile population
    (T = 49,152 tiles of 64x64), in the planner's three forms (raw,
    reversed, reversed and placed): bit for bit against the plain
    version, device time of each beside its byte bound."""
    from repro_torch.core.bitslice import codes_to_bits, quantize_magnitude
    from repro_torch.core.tiling import CrossbarSpec, tile_masks
    from repro_torch.kernels.manhattan_score.ops import manhattan_score
    from repro_torch.kernels.manhattan_score.ref import manhattan_score_plain

    spec = CrossbarSpec(64, 64, 8)
    w = torch.randn((3072, 8192), generator=g, device="cuda") * 0.02
    codes, _, _ = quantize_magnitude(w, spec.n_bits)
    masks = tile_masks(codes_to_bits(codes, spec.n_bits), spec)
    masks = masks.reshape(-1, spec.rows, spec.cols).contiguous()
    T = masks.shape[0]
    perm = torch.argsort(torch.rand((T, 64), generator=g, device="cuda"), -1)
    position = torch.empty_like(perm).scatter_(
        -1, perm, torch.arange(64, device="cuda").expand(T, 64)).to(torch.int32)
    err, forms = 0.0, {}
    for name, rev, rp in (("raw", False, None), ("reversed", True, None),
                          ("placed", True, position)):
        got = manhattan_score(masks, spec.nf_unit, reverse=rev, row_position=rp)
        want = manhattan_score_plain(masks, spec.nf_unit, rev, rp)
        for a, b in zip(got, want):
            err = max(err, (a - b).abs().max().item())
        ms = device_ms(lambda: manhattan_score(masks, spec.nf_unit,
                                               reverse=rev, row_position=rp))
        plain_ms = cuda_ms(lambda: manhattan_score_plain(masks, spec.nf_unit,
                                                         rev, rp), iters=5)
        # Masks in, scores and counts and NF out (and the placement in).
        n_bytes = (masks.numel() + T * 64 * 4 * 2 + T * 4
                   + (0 if rp is None else rp.numel() * 4))
        b_ms, b_by = bound(n_bytes, 3.0 * masks.numel())
        forms[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
        print(f"manhattan_score {name} T={T} 64x64: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{100 * b_ms / ms:.1f}% of it)")
    ok = err == 0.0
    print(f"manhattan_score: max_abs_err {err:.3e} (exact, three forms) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("manhattan_score disagrees")
    return dict(name="manhattan_score", route="cuda",
                source="src/repro_torch/kernels/manhattan_score/kernel.cu",
                replaces="src/repro/kernels/manhattan_score/kernel.py:34",
                max_abs_err=err, **forms["raw"], library_ms=None,
                forms=forms)


def phase_layer_deploy(eng):
    """manhattan_score's device time over the deploy of one layer's 7
    matrices (torch.profiler), on a second deploy of layer 0 of the
    served model, so the timed deploy is not perturbed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.deploy import plan_matrix, spec_from_config
    from repro_torch.deploy.engine import collect_model_matrices

    spec = spec_from_config(eng.cfg)
    mats, _ = collect_model_matrices(eng.params, eng.cfg)
    layer0 = {k: w for k, w in mats.items() if k.endswith("/0")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for w in layer0.values():
            plan_matrix(w, spec, eng.cfg.cim.mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    score_us, n, busy_us = 0.0, 0, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += e.self_device_time_total
        if "score_" in e.key:
            score_us += e.self_device_time_total
            n += e.count
    if busy_us == 0:
        print("phase layer deploy: the profiler saw no device time: "
              "not measured")
        return
    print(f"phase layer deploy: {len(layer0)} matrices of layer 0, "
          f"{wall * 1e3:.1f} ms wall (profiled); device busy "
          f"{busy_us / 1e3:.3f} ms, manhattan_score {score_us / 1e3:.3f} ms "
          f"in {n} launches ({100 * score_us / busy_us:.1f}% of busy)")


def _check_slstm_scan(g, dtype=torch.float32) -> dict:
    """slstm_scan at xlstm-1.3b shapes: B lanes, H = 4, Dh = 512, the
    prefill (T = PROMPT) and a decode step (T = 1); gx and R in
    ``dtype``, the state f32 (the serving form: the outputs are f32, so
    the f32 tolerance holds)."""
    from repro_torch.kernels.slstm_scan.ops import (
        CLUSTER,
        max_active_clusters,
        slstm_geometry,
        slstm_scan,
    )
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain

    H, Dh = 4, 512
    bf = dtype == torch.bfloat16
    r = (torch.randn((H, Dh, 4 * Dh), generator=g, device="cuda")
         * 0.02).to(dtype)
    geom = slstm_geometry(B, Dh, bf)
    print(f"slstm_scan launch (B={B}, Dh={Dh}): {H * geom.groups} clusters "
          f"of {CLUSTER} blocks, {geom.smem} bytes of shared memory a "
          f"block, R rows a slice: {geom.reg_rows} in registers, "
          f"{geom.sm_rows} in shared memory, "
          f"{geom.kper - geom.reg_rows - geom.sm_rows} from L2; "
          f"cudaOccupancyMaxActiveClusters {max_active_clusters(B, Dh)}")
    regimes = {}
    for name, T in (("prefill", PROMPT), ("decode", 1)):
        gx = (torch.randn((B, T, H, 4 * Dh), generator=g, device="cuda")
              * 0.5).to(dtype)
        h0 = torch.randn((B, H, Dh), generator=g, device="cuda") * 0.1
        c0 = torch.randn((B, H, Dh), generator=g, device="cuda") * 0.1
        got = slstm_scan(gx, r, h0, c0)
        want = slstm_scan_plain(gx, r, h0, c0)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        ok = all(((a - b).abs() <= SLSTM_TOL * (1 + b.abs())).all().item()
                 for a, b in zip(got, want))
        ms = device_ms(lambda: slstm_scan(gx, r, h0, c0))
        plain_ms = cuda_ms(lambda: slstm_scan_plain(gx, r, h0, c0), iters=3)
        n_bytes = ((2 if bf else 4) * (gx.numel() + r.numel())
                   + 4 * (4 * h0.numel() + B * T * H * Dh))
        # h @ R per step (2 Dh ops a gate column), ~20 for the gates.
        b_ms, b_by = bound(n_bytes, B * T * H * (2.0 * Dh * 4 * Dh + 20 * Dh))
        print(f"slstm_scan{'[bf16]' if bf else ''} {name} B={B} T={T} "
              f"H={H} Dh={Dh}: max_abs_err "
              f"{err:.3e} (tol {SLSTM_TOL:g}(1+|ref|)) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise AssertionError(f"slstm_scan disagrees ({name})")
        regimes[name] = dict(T=T, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    step_us = 1e3 * (regimes["prefill"]["ms"] - regimes["decode"]["ms"]) \
        / (PROMPT - 1)
    print(f"  slstm_scan: {step_us:.3f} us a step (slope of T={PROMPT} over "
          f"T=1), {1e3 * regimes['decode']['ms'] - step_us:.3f} us a launch "
          f"besides (R loaded on chip, state in and out)")
    rep = {k: v for k, v in regimes["prefill"].items() if k != "T"}
    return dict(name="slstm_scan[bf16]" if bf else "slstm_scan",
                route="cuda",
                source="src/repro_torch/kernels/slstm_scan/kernel.cu",
                replaces="src/repro/kernels/slstm_scan/kernel.py:66", **rep,
                step_us=step_us, regimes=regimes)


def _launches(path: str) -> dict:
    """The launch counts of the path just driven, less a check's
    (EXCLUDED); raises unless every kernel of the path was launched."""
    from repro_torch.kernels import runtime

    counts = {k: n - EXCLUDED.pop(k, 0)
              for k, n in runtime.launch_counts().items()}
    print(f"{path} path launches: {counts}")
    missing = [k for k in PATH_KERNELS[path] if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")
    return counts


def phase_serve(path: str, cfg, cache_dir: str):
    """Init, deploy (through a plan cache in the fresh ``cache_dir``)
    and serve a full-width model through the kernels; then the
    uncached deploy alone, for comparison."""
    from repro_torch.deploy import PlanCache, deploy_model_params
    from repro_torch.kernels import runtime
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ,
                      plan_cache=PlanCache(cache_dir), device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rep = eng.deploy_report
    print(f"phase deploy ({path}): init {t1 - t0:.2f} s, deploy "
          f"{t2 - t1:.2f} s through a cold plan cache "
          f"({rep['cache_misses']} misses): {rep['n_matrices']} matrices, "
          f"{rep['tiles_planned']} tiles, mean NF reduction "
          f"{100 * rep['nf_reduction']:.3f}% (NF {rep['nf_before']:.6g} "
          f"-> {rep['nf_after']:.6g})")
    summary = rep["matrices"]
    reasons: dict = {}
    for reason in summary["skipped"].values():
        reasons[reason] = reasons.get(reason, 0) + 1
    print(f"  deploy summary: {summary['n_deployed']} deployed, "
          f"{summary['n_skipped']} skipped {reasons}")

    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    eng.generate(prompts, 2)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    step = (t_all - t_prefill) / (NEW - 1)
    print(f"phase serve ({path}): B={B} prompt {PROMPT} new {NEW}: prefill "
          f"{t_prefill * 1e3:.1f} ms, decode {step * 1e3:.2f} ms/step, "
          f"{B * NEW / t_all:.1f} tokens/s "
          f"(peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
    counts = _launches(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cim, _ = deploy_model_params(params, cfg, device="cuda")
    torch.cuda.synchronize()
    uncached_s = time.perf_counter() - t0
    print(f"  uncached deploy_model_params ({path}): {uncached_s:.2f} s "
          f"(the deploy timed up to PR 14)")
    del cim
    if not torch.isfinite(eng.teacher_forced_logits(
            torch.cat([prompts.cuda(), tokens.long()], 1)[:, :PROMPT + 1],
            PROMPT)).all():
        raise AssertionError("non-finite logits")
    phase_profile(eng, prompts, step * 1e3)
    return eng, prompts, tokens, counts, uncached_s


def phase_profile(eng, prompts, step_ms: float, steps: int = 3):
    """Device time by kernel over a few decode steps (torch.profiler),
    reading the crossbars as ``generate`` does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import apply_model, init_decode_state

    cfg = eng.cfg
    read = getattr(eng, "_read", lambda seed, t: None)
    state = init_decode_state(cfg, B, MAX_SEQ, "cuda")
    logits, state = apply_model(eng.params, cfg, prompts.cuda(), state=state,
                                cim=eng.cim, read_seed=read(0, 0))
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            logits, state = apply_model(eng.params, cfg, tok, state=state,
                                        decode=True, cim=eng.cim,
                                        read_seed=read(0, t + 1))
            tok = logits[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # Kernel events only: a CPU op's device time repeats its kernels'.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us / steps / 1e3, e.count // steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("phase profile: the profiler saw no device time: not measured")
        return None
    print(f"phase profile ({steps} decode steps): device busy {busy:.2f} ms "
          f"of a {step_ms:.2f} ms step (unprofiled) -> busy share "
          f"{100 * min(1.0, busy / step_ms):.1f}%, idle share "
          f"{100 * max(0.0, 1 - busy / step_ms):.1f}%")
    for i, (ms, n, key) in enumerate(rows):
        # The 8 largest, and every kernel of the port.
        if i < 8 or any(k in key for k in PORT_KERNEL_NAMES):
            print(f"  {ms:8.3f} ms/step {n:5d} launches/step "
                  f"({1e3 * ms / max(n, 1):.2f} us each)  {key[:70]}")
    return busy


def phase_plans(eng, names):
    """Plans built on the card vs the port's CPU mirror, bit for bit, for
    the first repeat of each (slot, parameter) in ``names``, or of expert
    e of an expert bank for a (slot, parameter, e)."""
    import numpy as np

    from repro_torch.core.bitslice import magnitude_scale_host
    from repro_torch.deploy import plan_matrix, quantize_codes_host
    from repro_torch.deploy import spec_from_config

    cfg = eng.cfg
    spec = spec_from_config(cfg)
    for slot, name, *expert in names:
        w = eng.params[slot][name][0]
        dep = eng.cim[slot][name].layer(0)
        if expert:                                # one expert's matrix
            w, dep = w[expert[0]], dep.layer(expert[0])
        elif w.ndim == 3:                         # q/k/v (I, H, Dh)
            w = w.reshape(w.shape[0], -1)
        gpu = plan_matrix(w, spec, cfg.cim.mode)
        cpu = plan_matrix(w.cpu(), spec, cfg.cim.mode)
        for a, b in zip(gpu[0], cpu[0]):
            if isinstance(a, torch.Tensor) and not torch.equal(a.cpu(), b):
                raise AssertionError(f"{name}: card plan != CPU plan")
        w_np = w.float().cpu().numpy()
        scale = magnitude_scale_host(w_np, spec.n_bits)
        host_codes = quantize_codes_host(w_np, scale, spec.n_bits)
        if not (np.array_equal(gpu[1].cpu().numpy(), host_codes)
                and gpu[3].cpu().numpy().tobytes() == scale.tobytes()):
            raise AssertionError(f"{name}: card codes/scale != numpy mirror")
        I, N = w.shape
        if not torch.equal(dep.codes[:I, :N].abs().to(torch.int32), gpu[1]):
            raise AssertionError(f"{name}: packaged codes != planned codes")
        plan = gpu[0]
        red = 1 - plan.nf_after.sum().item() / plan.nf_before.sum().item()
        what = f"{slot}/{name}/0" + (f"/e{expert[0]}" if expert else "")
        print(f"plan {what} {I}x{N}: {plan.nf_before.numel()} tiles, "
              f"card == CPU mirror (row_perm, row_position, nf_before, "
              f"nf_after, scale, codes); NF reduction {100 * red:.3f}%")


def phase_export(eng) -> tuple[dict, dict]:
    """The deployment image of phi3's lm_head (quantise, signed codes,
    ``bitslice_pack``), then the kernel against its plain version on
    those codes, int32 and int16, in both orientations."""
    from repro_torch.core.bitslice import quantize_magnitude
    from repro_torch.deploy import spec_from_config
    from repro_torch.kernels import runtime
    from repro_torch.kernels.bitslice_pack import bitslice_pack
    from repro_torch.kernels.bitslice_pack.ref import bitslice_pack_plain
    from repro_torch.mapping import resolve_pipeline

    K = spec_from_config(eng.cfg).n_bits
    rev = resolve_pipeline(eng.cfg.cim.mode).reversed_dataflow
    w = eng.params["lm_head"]
    runtime.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes, sign, _ = quantize_magnitude(w, K)
    img = bitslice_pack(codes * sign, K, reversed_df=rev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"phase export: lm_head {tuple(w.shape)} f32 -> image "
          f"{tuple(img.shape)} {str(img.dtype).split('.')[-1]} "
          f"({img.numel() / 1e6:.1f} MB, reversed dataflow {rev}) in "
          f"{dt * 1e3:.1f} ms")
    counts = _launches("export")
    signed = codes * sign
    del img, codes, sign
    for dtype in (torch.int32, torch.int16):
        c = signed.to(dtype)
        for r in (False, True):
            if not torch.equal(bitslice_pack(c, K, r),
                               bitslice_pack_plain(c, K, r)):
                raise AssertionError(f"bitslice_pack disagrees ({dtype}, "
                                     f"reversed {r})")
    c16 = signed.to(torch.int16)
    ms = cuda_ms(lambda: bitslice_pack(signed, K, rev))
    ms16 = cuda_ms(lambda: bitslice_pack(c16, K, rev))
    plain_ms = cuda_ms(lambda: bitslice_pack_plain(signed, K, rev), iters=3)
    n = signed.numel()
    # Integer shift/and/or per plane, counted at the f32 rate.
    b_ms, b_by = bound(n * 4 + n * K, 3.0 * K * n)
    print(f"bitslice_pack {tuple(signed.shape)} K={K}: exact in both "
          f"orientations, int32 and int16 codes; kernel {ms:.4f} ms "
          f"(int16 codes {ms16:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return dict(name="bitslice_pack", route="cuda",
                source="src/repro_torch/kernels/bitslice_pack/kernel.cu",
                replaces="src/repro/kernels/bitslice_pack/kernel.py:26",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), counts


def _plain_ops():
    """The plain versions of a forward's kernels (``PLAIN``), every
    deployment read from the devices' state (codes, pos, gain, col_pos):
    ``dataclasses.replace`` drops the fold, so a check's reference never
    reads the fold kernel's output."""
    from repro_torch.models.model import PLAIN, Ops

    def matmul(x, dep, read_seed=None):
        return PLAIN.matmul(x, dataclasses.replace(dep), read_seed)

    def grouped(x, dep, offsets, cap, read_seed=None):
        return PLAIN.grouped(x, dataclasses.replace(dep), offsets, cap,
                             read_seed)

    return Ops(matmul, PLAIN.attention, PLAIN.slstm_scan, grouped)


def phase_compare(eng, prompts, tokens):
    """Kernel path vs plain path.  f32: teacher-forced logits within
    LOGIT_TOL x max|logit|, greedy tokens listed.  bf16: every kernel
    call of a teacher-forced pass against its plain version
    (:func:`_check_calls`), the same deployments served in f32 at
    LOGIT_TOL (:func:`_check_f32`), and the bf16 paths' logits and
    greedy tokens printed beside each other (no bound: module
    constants)."""
    plain_eng = copy.copy(eng)           # same params and deployments
    plain_eng.ops = _plain_ops()
    seq = torch.cat([prompts.cuda(), tokens.long()], 1)[:, :PROMPT + NEW - 1]
    V = eng.cfg.vocab_size       # padded columns sit at -1e9; left out
    f32 = eng.cfg.dtype == "float32"
    if f32:
        lk = eng.teacher_forced_logits(seq, PROMPT)[..., :V].float()
    else:
        lk = _check_calls(eng, seq, "xlstm")[..., :V].float()
        _check_f32(eng, seq)
    lp = plain_eng.teacher_forced_logits(seq, PROMPT)[..., :V].float()
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    tol = LOGIT_TOL * ref
    ok = err <= tol
    print(f"teacher-forced logits ({lk.shape[1]} steps, {eng.cfg.dtype}): "
          f"max_abs_err {err:.3e} ({err / ref:.3e} of max|logit| "
          f"{ref:.3e})" + (f", tol {tol:.3e} {'ok' if ok else 'FAIL'}"
                           if f32 else " (bf16: a reading, no bound)"))
    if f32 and not ok:
        raise AssertionError("kernel-path logits disagree with plain path")
    plain_tokens = plain_eng.generate(prompts, NEW)
    same = (plain_tokens == tokens)
    top2 = lp.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    print(f"greedy tokens: {int(same.sum())}/{same.numel()} equal; "
          f"smallest top-2 gap {gap.min().item():.3e}")
    for b in range(B):
        bad = (~same[b]).nonzero()
        if len(bad):
            t = int(bad[0])
            print(f"  flip row {b} step {t}: kernel {int(tokens[b, t])} "
                  f"plain {int(plain_tokens[b, t])}, plain top-2 gap "
                  f"{gap[b, t].item():.3e}")


def _checked_ops(worst: dict):
    """The kernels of a forward (``KERNELS``), each call also run
    through its plain version on the same inputs; ``worst[kernel]``
    gathers (calls, largest |kernel - plain| / its limit).  The limits
    are the kernel checks': CIM_TOL x max|plain| for cim_mvm and its
    grouped form (f32 outputs), FLASH_TOL and SLSTM_TOL x (1 + |plain|) plus one bf16 ulp
    for bf16 outputs; cim_mvm's reference reads no fold
    (:func:`_plain_ops`).  The kernel's result flows on."""
    from repro_torch.models.model import KERNELS, Ops

    plain = _plain_ops()

    def held(name, got, want, limit):
        r = ((got.float() - want.float()).abs() / limit).max().item()
        if not math.isfinite(r):        # a NaN or inf is off any limit
            r = math.inf
        n, w = worst.get(name, (0, 0.0))
        worst[name] = (n + 1, max(w, r))

    def elementwise(tol, want):
        w = want.float().abs()
        return tol * (1 + w) + (BF16_ULP * w
                                if want.dtype == torch.bfloat16 else 0.0)

    def matmul(x, dep, read_seed=None):
        y = KERNELS.matmul(x, dep, read_seed)
        p = plain.matmul(x, dep, read_seed)
        held("cim_mvm", y, p, CIM_TOL * p.abs().max().clamp_min(1e-30))
        return y

    def attention(q, k, v, q_pos, k_pos, window, chunk):
        o = KERNELS.attention(q, k, v, q_pos, k_pos, window, chunk)
        p = plain.attention(q, k, v, q_pos, k_pos, window, chunk)
        held("flash_attention", o, p, elementwise(FLASH_TOL, p))
        return o

    def scan(gx, r, h0, c0):
        out = KERNELS.slstm_scan(gx, r, h0, c0)
        for a, p in zip(out, plain.slstm_scan(gx, r, h0, c0)):
            held("slstm_scan", a, p, elementwise(SLSTM_TOL, p))
        return out

    def grouped(x, dep, offsets, cap, read_seed=None):
        y = KERNELS.grouped(x, dep, offsets, cap, read_seed)
        p = plain.grouped(x, dep, offsets, cap, read_seed)
        held("cim_mvm_grouped_folded" if dep.folded is not None
             else "cim_mvm_grouped", y, p,
             CIM_TOL * p.abs().max().clamp_min(1e-30))
        return y

    return Ops(matmul, attention, scan, grouped)


def _check_calls(eng, seq, path: str, seed: int = 0) -> torch.Tensor:
    """A teacher-forced pass of ``eng`` (prefill, then a decode step a
    token: both forms of every kernel) with every kernel call held
    against its plain version on its own inputs (:func:`_checked_ops`);
    raises if any call is off its limit or a kernel of ``path`` was not
    called.  Returns the pass's logits (the kernel path's)."""
    worst: dict = {}
    checked = copy.copy(eng)
    checked.ops = _checked_ops(worst)
    logits = checked.teacher_forced_logits(seq, PROMPT, seed=seed)
    want = [k for k in PATH_KERNELS[path]
            if k not in ("manhattan_score", "cim_fold")]   # deploy only
    print(f"  kernel calls of a teacher-forced pass ({eng.cfg.dtype}, "
          f"{seq.shape[1] - PROMPT} decode steps), each against its plain "
          f"version on the same inputs: " + ", ".join(
              f"{k} {n} calls, worst |kernel - plain| {w:.3f} of its limit"
              for k, (n, w) in sorted(worst.items())))
    bad = [k for k in want if k not in worst or worst[k][1] > 1.0]
    if bad:
        raise AssertionError(f"kernel calls off their plain version or "
                             f"missing on the {path} path: {bad}")
    return logits


def _check_f32(eng, seq, seed: int = 0) -> None:
    """The bf16 engine's deployments served with f32 activations (its
    params widened, the same banks and read seeds): kernel path vs plain
    path, teacher-forced logits within LOGIT_TOL x max|logit|, and the
    argmax flips listed with the plain path's top-2 gap (a flip needs a
    gap within twice the error)."""
    twin = copy.copy(eng)
    twin.cfg = eng.cfg.replace(dtype="float32")
    twin.params = _widen(eng.params)
    plain = copy.copy(twin)
    plain.ops = _plain_ops()
    V = eng.cfg.vocab_size
    lk = twin.teacher_forced_logits(seq, PROMPT, seed=seed)[..., :V]
    lp = plain.teacher_forced_logits(seq, PROMPT, seed=seed)[..., :V]
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flips = lk.argmax(-1) != lp.argmax(-1)
    ok = err <= LOGIT_TOL * ref
    print(f"  the same deployments in f32: teacher-forced logits "
          f"({lk.shape[1]} steps) max_abs_err {err:.3e} ({err / ref:.3e} of "
          f"max|logit| {ref:.3e}), tol {LOGIT_TOL:g} x max "
          f"{'ok' if ok else 'FAIL'}; argmax differs at {int(flips.sum())} "
          f"of {flips.numel()} (plain top-2 gaps "
          f"{[float(f'{g:.3e}') for g in gap[flips].tolist()][:8]})")
    del twin, plain
    if not ok:
        raise AssertionError("f32 kernel-path logits disagree with the "
                             "plain path")


def _widen(tree):
    """A params tree with every floating leaf in f32."""
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def phase_nonideal(cfg, cache_dir: str) -> dict:
    """Full-width phi3-mini at its config dtype (bf16) on imperfect
    devices (``NONIDEAL``) under the ``spare_line`` mapping: deploy
    through a cold plan cache (its stages timed), hold every served
    matrix's fold bit for bit against its plain version, serve greedily,
    and hold the kernel path against the plain path (which reads no
    fold) at one read seed, call by call in bf16, end to end in f32, and
    its bf16 logits within NONIDEAL_BF16_LOGIT_TOL x max|logit|."""
    from repro_torch.deploy import PlanCache, deploy_model_params
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cim_mvm.ref import folded_weights
    from repro_torch.models.model import init_params
    from repro_torch.nonideal import NonidealModel
    from repro_torch.serve import ServeEngine

    full = NonidealModel(**NONIDEAL)
    model = dataclasses.replace(full, p_open_wordline=0.0,
                                p_open_bitline=0.0)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cim, rep = deploy_model_params(params, cfg, device="cuda", nonideal=full,
                                   nonideal_key=NONIDEAL_SEED,
                                   pipeline=NONIDEAL_PIPELINE)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    print(f"phase deploy (phi3-nonideal, with line opens): {full}: "
          f"{t_full:.2f} s uncached; n_degraded "
          f"{rep['n_degraded']} of {rep['n_matrices']} matrices (programmed "
          f"bits left on open lines after the {NONIDEAL_PIPELINE} remap, "
          f"{sum(int(d.degraded.sum()) for sl in cim.values() for d in sl.values())} "
          f"in all), {rep['stuck_cells']} stuck or open cells")
    del cim
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ,
                      plan_cache=PlanCache(cache_dir), nonideal=model,
                      nonideal_seed=NONIDEAL_SEED,
                      pipeline=NONIDEAL_PIPELINE, timed_deploy=True,
                      device="cuda")
    torch.cuda.synchronize()
    t_deploy = time.perf_counter() - t0
    rep = eng.deploy_report
    n_mats = rep["n_matrices"]
    sec = rep["seconds"]
    print(f"phase deploy (phi3-nonideal, served): {cfg.dtype}, {model}, seed "
          f"{NONIDEAL_SEED}, pipeline {NONIDEAL_PIPELINE}: {t_deploy:.2f} s "
          f"through a cold plan cache ({rep['cache_misses']} misses): "
          f"{n_mats} matrices, {rep['tiles_planned']} tiles, "
          f"{rep['stuck_cells']} stuck or open cells, n_degraded "
          f"{rep['n_degraded']}, fault-aware {rep['fault_aware']}, NF "
          f"reduction {100 * rep['nf_reduction']:.3f}%")
    print(f"  deploy stages (the engine's deploy, the card synchronised "
          f"between stages): sample {sec.get('sample', 0.0):.2f} s, inject "
          f"{sec.get('inject', 0.0):.2f} s, plan {sec.get('plan', 0.0):.2f} s "
          f"(the plan cache and its fault-map draws included), package "
          f"{sec.get('package', 0.0):.2f} s (a fold launch a served "
          f"matrix included); "
          f"{t_deploy - sum(sec.values()):.2f} s besides")
    for name, why in list(rep["degraded"].items())[:4]:
        print(f"  demoted {name}: {why}")
    size = lambda fields: sum(
        t.numel() * t.element_size() for slot in eng.cim.values()
        for d in slot.values() for t in (getattr(d, f) for f in fields)
        if t is not None)
    operands = size(("codes", "pos", "gain", "col_pos"))
    folded = size(("folded",))
    print(f"  bank: {(operands + folded) / 1e9:.2f} GB on the card: the "
          f"folded W' * gain the reads take {folded / 1e9:.2f} GB, the "
          f"devices' state kept beside it (codes, pos, gain, col_pos; "
          f"the checks' plain reference reads it) {operands / 1e9:.2f} GB; "
          f"params "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB")
    n_folds = 0
    for slot in eng.cim.values():
        for d in slot.values():
            for r in range(d.codes.shape[0]):
                if d.degraded is not None and int(d.degraded[r]):
                    continue
                view = d.layer(r)
                if view.folded is None or not torch.equal(
                        view.folded, folded_weights(view)):
                    raise AssertionError("a served matrix's fold differs "
                                         "from its plain version")
                n_folds += 1
    if n_folds != n_mats - rep["n_degraded"]:
        raise AssertionError(f"{n_folds} folds != {n_mats} matrices less "
                             f"{rep['n_degraded']} degraded")
    print(f"  the fold of every served matrix ({n_folds}) bit-identical to "
          f"its plain version on the devices' state (codes, pos, gain, "
          f"col_pos)")

    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    eng.generate(prompts, 2)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    step = (t_all - t_prefill) / (NEW - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase serve (phi3-nonideal): B={B} prompt {PROMPT} new {NEW}: "
          f"prefill {t_prefill * 1e3:.1f} ms, decode {step * 1e3:.2f} "
          f"ms/step, {B * NEW / t_all:.1f} tokens/s (peak memory "
          f"{peak:.1f} GiB)")
    counts = _launches("phi3-nonideal")
    forwards = 2 + 1 + NEW
    live = n_mats - rep["n_degraded"]
    if counts["cim_mvm"] != live * forwards:
        raise AssertionError(f"cim_mvm launches {counts['cim_mvm']} != "
                             f"{live} non-degraded matrices x {forwards} "
                             "forwards")
    print(f"  cim_mvm: {counts['cim_mvm']} launches = {live} non-degraded "
          f"matrices x {forwards} forwards, each through the folded forms "
          f"with read noise; {rep['n_degraded']} degraded served "
          f"digitally; cim_fold: {counts['cim_fold']} launches (one a "
          f"served matrix, in the deploy's package stage)")
    if counts["cim_fold"] != live:
        raise AssertionError(f"cim_fold launches {counts['cim_fold']} != "
                             f"{live} non-degraded matrices")
    phase_profile(eng, prompts, step * 1e3)

    again = eng.generate(prompts, NEW)
    if not torch.equal(again, tokens):
        raise AssertionError("two generate calls with the same sampling "
                             "and read seeds gave different tokens")
    print(f"  two generate calls (sampling seed 0, read seeds of nonideal "
          f"seed {NONIDEAL_SEED}): tokens bit-identical ({tokens.numel()})")

    seq = torch.cat([prompts.cuda(), tokens.long()], 1)[
        :, :PROMPT + TF_STEPS]
    V = cfg.vocab_size
    lk = _check_calls(eng, seq, "phi3-nonideal", seed=5)[..., :V].float()
    if not (torch.isfinite(lk).all() and lk.shape == (B, TF_STEPS + 1, V)):
        raise AssertionError("non-finite or misshapen logits")
    _check_f32(eng, seq, seed=5)
    plain_eng = copy.copy(eng)
    plain_eng.ops = _plain_ops()
    lp = plain_eng.teacher_forced_logits(seq, PROMPT, seed=5)[..., :V].float()
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    ok = err <= NONIDEAL_BF16_LOGIT_TOL * ref
    flips = int((lk.argmax(-1) != lp.argmax(-1)).sum())
    print(f"teacher-forced logits, kernel vs plain path at read seed 5 "
          f"({lk.shape[1]} steps, bf16): max_abs_err {err:.3e} "
          f"({err / ref:.3e} of max|logit| {ref:.3e}), tol "
          f"{NONIDEAL_BF16_LOGIT_TOL:g} x max {'ok' if ok else 'FAIL'}; "
          f"argmax differs at {flips} of {lk.shape[0] * lk.shape[1]}")
    if not ok:
        raise AssertionError("nonideal bf16 kernel-path logits disagree")
    del plain_eng, lk, lp, eng
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _requests(vocab: int) -> list[tuple]:
    """The continuous path's traffic, from a numpy seed: N_REQUESTS
    (prompt, max_tokens, temperature, seed), prompts of 16-CONT_PROMPT
    tokens, 8-32 new tokens with prompt + new <= MAX_SEQ, even indices
    greedy and odd ones at temperature 0.8, distinct seeds."""
    import numpy as np

    rng = np.random.default_rng(7)
    out = []
    for i in range(N_REQUESTS):
        L = int(rng.integers(16, CONT_PROMPT + 1))
        n = min(int(rng.integers(8, 33)), MAX_SEQ - L)
        out.append((rng.integers(0, vocab, L), n,
                    0.0 if i % 2 == 0 else 0.8, 1000 + i))
    return out


def _serve_continuous(eng, reqs, order, swap_at=None, params=None) -> dict:
    """Submit ``reqs`` in ``order`` up front and step ``eng`` until all
    finish; with ``swap_at``, ``begin_redeploy(params)`` after that many
    iterations.  Returns the tokens by request index and the run's
    numbers (host wall times around work that ends in a sync)."""
    times = {"_admit": [], "_decode_iteration": []}
    for name in times:
        fn = getattr(eng, name)

        def timed(*a, fn=fn, name=name):
            t0 = time.perf_counter()
            out = fn(*a)
            times[name].append(time.perf_counter() - t0)
            return out

        setattr(eng, name, timed)
    rids = {i: eng.submit(reqs[i][0], max_tokens=reqs[i][1],
                          temperature=reqs[i][2], seed=reqs[i][3])
            for i in order}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swap = {}
    while eng.scheduler.pending:
        if swap_at is not None and eng.iterations == swap_at:
            t_swap = time.perf_counter()
            thread = eng.begin_redeploy(params)
            n0 = len(times["_decode_iteration"])
            # Serve meanwhile, but leave requests queued for the new bank.
            while thread.is_alive() and eng.scheduler.queue_depth > 2:
                eng.step()
            during = times["_decode_iteration"][n0:]
            thread.join()
            swap = dict(ready_s=time.perf_counter() - t_swap,
                        iterations_meanwhile=len(during),
                        decode_ms_meanwhile=1e3 * sum(during)
                        / max(1, len(during)))
        eng.step()
    wall = time.perf_counter() - t0
    out = {i: eng.results[r] for i, r in rids.items()}
    tokens = sum(len(t) for t in out.values())
    decoded = tokens - len(reqs)
    return dict(tokens_by_request=out, wall_s=wall,
                iterations=eng.iterations, tokens=tokens,
                tokens_per_s=tokens / wall,
                occupancy=decoded / max(1, len(times["_decode_iteration"])
                                        * eng.capacity),
                prefill_ms=1e3 * sum(times["_admit"])
                / max(1, len(times["_admit"])),
                decode_ms=1e3 * sum(times["_decode_iteration"])
                / max(1, len(times["_decode_iteration"])), swap=swap)


def _print_run(name: str, run: dict) -> None:
    print(f"  run {name}: {run['wall_s']:.3f} s, {run['iterations']} "
          f"iterations, {run['tokens']} tokens, {run['tokens_per_s']:.1f} "
          f"tokens/s, mean occupancy {run['occupancy']:.3f}; prefill "
          f"{run['prefill_ms']:.2f} ms an admission, decode "
          f"{run['decode_ms']:.2f} ms an iteration"
          + (f"; redeploy ready {run['swap']['ready_s']:.2f} s after "
             f"begin_redeploy, {run['swap']['iterations_meanwhile']} "
             f"iterations served meanwhile at "
             f"{run['swap']['decode_ms_meanwhile']:.2f} ms each"
             if run["swap"] else ""))


def _same_bank(a: dict, b: dict, what: str) -> None:
    for slot, deps in b.items():
        for pname, d in deps.items():
            for f in ("codes", "pos", "scale"):
                if not torch.equal(getattr(a[slot][pname], f),
                                   getattr(d, f)):
                    raise AssertionError(f"{what}: {slot}/{pname}.{f} "
                                         "differs")


def _check_greedy_parity(cont, serve_eng, reqs, tokens_by_request) -> None:
    """Each greedy request against ServeEngine alone (B = 1, the exact
    prompt): tokens equal, or each flip listed with the top-2 gap of
    ServeEngine's logits there and failing if the gap is outside the
    logits' tolerance; and the largest first-step logit difference
    between the padded per-lane prefill and ServeEngine's."""
    from repro_torch.models.model import apply_model, init_decode_state

    bank, dev = cont.banks[0], cont.device
    V = cont.cfg.vocab_size
    worst, flips, n_tok = 0.0, [], 0
    for i, (prompt, n, temp, _) in enumerate(reqs):
        if temp > 0:
            continue
        p = torch.as_tensor(prompt)[None].to(dev)
        L = p.shape[1]
        ref = serve_eng.generate(p, n)[0].tolist()
        got = tokens_by_request[i]
        n_tok += n
        padded = torch.zeros((1, cont.max_prompt), dtype=torch.int64,
                             device=dev)
        padded[0, :L] = p[0]
        st = init_decode_state(cont.cfg, 1, cont.max_seq, dev,
                               per_slot=True)
        lc = apply_model(bank.params, cont.cfg, padded, state=st,
                         cim=bank.cim)[0][0, L - 1, :V]
        st = init_decode_state(cont.cfg, 1, cont.max_seq, dev)
        ls = apply_model(serve_eng.params, cont.cfg, p, state=st,
                         cim=serve_eng.cim)[0][0, -1, :V]
        worst = max(worst, (lc - ls).abs().max().item())
        if got != ref:
            t = next(j for j in range(n) if got[j] != ref[j])
            seq = torch.cat([p[0], torch.tensor(ref[:-1], device=dev)])
            lg = serve_eng.teacher_forced_logits(seq[None], L)[0, t, :V]
            top = lg.topk(2).values
            gap = (top[0] - top[1]).item()
            flips.append((i, t, ref[t], got[t], gap,
                          gap <= LOGIT_TOL * lg.abs().max().item()))
    print(f"  greedy parity with ServeEngine alone: "
          f"{(N_REQUESTS + 1) // 2 - len(flips)}/{(N_REQUESTS + 1) // 2} "
          f"requests equal ({n_tok} tokens); largest first-step logit "
          f"difference {worst:.3e}")
    for i, t, a, b, gap, ok in flips:
        print(f"  flip request {i} step {t}: ServeEngine {a}, continuous "
              f"{b}, ServeEngine top-2 gap {gap:.3e} "
              f"({'within' if ok else 'OUTSIDE'} {LOGIT_TOL:g} x max|logit|)")
    if not all(f[-1] for f in flips):
        raise AssertionError("a greedy flip outside the logits' tolerance")


def phase_continuous(cfg, params, serve_eng, cache_dir: str,
                     uncached_s: float) -> dict:
    """phi3-mini through ContinuousEngine at full width: a cold deploy
    through a fresh plan cache (beside ``uncached_s``, the same deploy
    without a cache), then N_REQUESTS requests served three
    times (submission order, reversed order on a fresh engine over the
    same bank, and with a hot swap to the same checkpoint after 5
    iterations), each held to the first run bit for bit; the receipt
    of one call signature a function; greedy parity with ServeEngine;
    the banks' codes and pos against ServeEngine's."""
    from repro_torch.deploy import (
        PlanCache,
        collect_model_matrices,
        fingerprint_matrices,
        spec_from_config,
    )
    from repro_torch.kernels import runtime
    from repro_torch.serve import ContinuousEngine, deploy_serving_bank

    reqs = _requests(cfg.vocab_size)
    cache = PlanCache(cache_dir)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kw = dict(capacity=CAPACITY, max_seq=MAX_SEQ, max_prompt=CONT_PROMPT,
              plan_cache=cache, device=serve_eng.device)
    eng1 = ContinuousEngine(cfg, params, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    rep = eng1.deploy_report
    bank = eng1.banks[0].cim
    run1 = _serve_continuous(eng1, reqs, range(N_REQUESTS))
    eng2 = ContinuousEngine(cfg, params, cim=bank, **kw)
    run2 = _serve_continuous(eng2, reqs, reversed(range(N_REQUESTS)))
    eng3 = ContinuousEngine(cfg, params, cim=bank, **kw)
    run3 = _serve_continuous(eng3, reqs, range(N_REQUESTS), swap_at=5,
                             params=params)
    torch.cuda.synchronize()
    counts = _launches("phi3-continuous")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    print(f"phase phi3-continuous: capacity {CAPACITY}, max_seq {MAX_SEQ}, "
          f"max_prompt {CONT_PROMPT}, {N_REQUESTS} requests (prompts "
          f"{min(len(r[0]) for r in reqs)}-{max(len(r[0]) for r in reqs)}, "
          f"{sum(r[1] for r in reqs)} tokens asked); cold deploy "
          f"{cold_s:.2f} s through a fresh plan cache ({rep['cache_misses']}"
          f" misses, {cache.bytes_written / 1e9:.3f} GB written in "
          f"{cache.stats.puts} entries and a manifest): plan/package "
          f"{uncached_s:.2f} s (the uncached deploy), fingerprint/write "
          f"{cold_s - uncached_s:.2f} s")
    for name, run in (("1 (in order)", run1), ("2 (reversed)", run2),
                      ("3 (hot swap)", run3)):
        _print_run(name, run)
    print(f"  peak memory {peak:.1f} GiB")

    for name, run, eng in (("reversed", run2, eng2), ("hot swap", run3, eng3),
                           ("in order", run1, eng1)):
        if run["tokens_by_request"] != run1["tokens_by_request"]:
            bad = [i for i in range(N_REQUESTS)
                   if run["tokens_by_request"][i]
                   != run1["tokens_by_request"][i]]
            raise AssertionError(f"run {name}: requests {bad} not "
                                 "bit-identical to run 1")
        if eng.traces != {"prefill": 1, "decode": 1} or \
                eng.pool.traces["join"] != 1 or eng.pool.traces["evict"] != 1:
            raise AssertionError(f"run {name}: call signatures "
                                 f"{eng.traces} {eng.pool.traces}")
    rep3 = eng3.deploy_report
    print(f"  composition determinism: all {N_REQUESTS} requests "
          f"bit-identical in runs 1-3; signatures {eng1.traces}, join "
          f"{eng1.pool.traces['join']}, evict {eng1.pool.traces['evict']}")
    print(f"  hot swap: epoch {eng3.serving_epoch} installed, "
          f"{eng3.fanout_iterations} iterations decoded over two epochs, "
          f"merge signatures {eng3.pool.traces['merge']}; redeploy "
          f"manifest hit {rep3['manifest_hit']}, {rep3['cache_hits']}/"
          f"{rep3['n_matrices']} cached")
    if not (eng3.serving_epoch == 1 and eng3.fanout_iterations > 0
            and rep3["manifest_hit"]
            and rep3["cache_hits"] == rep3["n_matrices"]):
        raise AssertionError("the hot swap did not run as planned")

    _same_bank(bank, serve_eng.cim, "cold continuous bank vs ServeEngine")
    _same_bank(eng3.banks[1].cim, serve_eng.cim,
               "warm manifest-hit bank vs ServeEngine")
    print("  cache parity: the cold and the warm (manifest-hit) banks' "
          "codes, pos and scale bit-identical to ServeEngine's")
    _check_greedy_parity(eng1, serve_eng, reqs, run1["tokens_by_request"])
    del eng2, eng3
    gc.collect()
    torch.cuda.empty_cache()

    # The cache's costs alone: the fingerprint pass, and a warm
    # manifest-hit deploy with nothing else running.
    mats, _ = collect_model_matrices(params, cfg)
    t0 = time.perf_counter()
    fingerprint_matrices(mats, spec_from_config(cfg), cfg.cim.mode)
    fp_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm, wrep, _, _ = deploy_serving_bank(cfg, params, cache,
                                           serve_eng.device)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not wrep["manifest_hit"]:
        raise AssertionError("the warm deploy missed the manifest")
    print(f"  plan cache at full width: fingerprint pass {fp_s:.2f} s "
          f"({_gb(mats):.2f} GB to the host and blake2b), warm "
          f"manifest-hit deploy {warm_s:.2f} s, cold cached deploy "
          f"{cold_s:.2f} s")
    del warm
    _cache_costs(mats, cfg, cache, cache_dir)
    return counts


def _gb(mats) -> float:
    return sum(w.numel() * w.element_size() for w in mats.values()) / 1e9


def _cache_costs(mats, cfg, cache, cache_dir: str) -> None:
    """Where a cached deploy's host time goes: copy and hash rates on
    layer 0's matrices (pageable and pinned copies, blake2b on one
    core), and over the whole plan set the manifest's read and decode,
    the entries' encoding and their writing (to a scratch directory)."""
    import hashlib

    from repro_torch.deploy import PlanCache, fingerprint_matrices
    from repro_torch.deploy import spec_from_config
    from repro_torch.deploy.cache import encode_plan

    layer0 = [w for k, w in mats.items() if k.endswith("/0")]
    n = _gb({i: w for i, w in enumerate(layer0)})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [w.cpu() for w in layer0]
    pageable = n / (time.perf_counter() - t0)
    pinned = [torch.empty(w.shape, pin_memory=True) for w in layer0]
    t0 = time.perf_counter()
    for h, w in zip(pinned, layer0):
        h.copy_(w, non_blocking=True)
    torch.cuda.synchronize()
    pinned_rate = n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for h in host:
        hashlib.blake2b(h.numpy().data, digest_size=32)
    hash_rate = n / (time.perf_counter() - t0)
    del host, pinned
    keys = fingerprint_matrices(mats, spec_from_config(cfg), cfg.cim.mode)
    t0 = time.perf_counter()
    plans = cache.get_manifest(keys)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blobs = {name: encode_plan(p) for name, p in plans.items()}
    enc_s = time.perf_counter() - t0
    scratch = PlanCache(os.path.join(cache_dir, "scratch"))
    t0 = time.perf_counter()
    for name, key in keys.items():
        scratch.put(key, blobs[name])
    scratch.put_manifest(keys, blobs)
    write_s = time.perf_counter() - t0
    shutil.rmtree(scratch.root)
    print(f"  cache costs: layer 0 ({n:.3f} GB) to the host at "
          f"{pageable:.2f} GB/s pageable, {pinned_rate:.2f} GB/s pinned; "
          f"blake2b {hash_rate:.2f} GB/s on one core; whole plan set: "
          f"manifest read + decode {read_s:.2f} s, encode {enc_s:.2f} s, "
          f"{scratch.bytes_written / 1e9:.3f} GB written with fsync "
          f"{write_s:.2f} s")


# The phi3-health path: phi3-nonideal's devices without line opens, plus
# relaxation (so that the drift clock moves every gain); seed, mapping,
# probe batch and endurance budget.
HEALTH = dict(p_stuck_off=0.01, p_stuck_on=0.001, sigma_program=0.05,
              sigma_corr=0.05, drift_nu=0.05, drift_time=10.0,
              sigma_relax=0.08, sigma_read=0.01)
HEALTH_SEED, HEALTH_PROBES, HEALTH_REPROGRAMS = 0, 16, 1
# The detector of that reference test (warmup 3, z_trip 6, z_clear 2):
# the default's warmup of 8 rounds would still be learning its baseline
# at the arc's fifth round.
HEALTH_DETECTOR = dict(warmup=3, z_trip=6.0, z_clear=2.0)
# The reference's escalation arc (tests/test_health.py::
# test_escalation_ladder_deterministic_per_seed) at full width: a number
# is an advance of the drift clock (t0 units) before a probe round, 0 a
# round alone, "serve" a batch served (B prompts, NEW tokens) between
# rounds.
HEALTH_ARC = (0, 0, 0, 0, 1e4, "serve", 1e8, 1e4, 1e8, "serve")
# Depth of the cross-engine check (ServeEngine and ContinuousEngine with
# one seed, the arc on each): the run's time limit.  The ServeEngine arc
# and the heal swap under load run at full depth.
CROSS_LAYERS = 8


# Launches made by a check inside a path (a kernel against its plain
# version, a re-read), which the path's counts leave out.
EXCLUDED: dict = {}


class _Uncounted:
    """Launches inside the block are a check's: they go to EXCLUDED."""

    def __enter__(self):
        from repro_torch.kernels import runtime

        self.before = runtime.launch_counts()

    def __exit__(self, *exc):
        from repro_torch.kernels import runtime

        for k, n in runtime.launch_counts().items():
            EXCLUDED[k] = EXCLUDED.get(k, 0) + n - self.before[k]
        return False


def _health_groups(eng):
    """(slot, pname) -> (stacked bank, probes (G, M, I), live repeats) of
    the engine's live lifetimes."""
    groups = {}
    for name, lt in eng.lifetime.items():
        if lt.demoted:
            continue
        key = tuple(name.split("/")[:2])
        bank, probes, reps = groups.setdefault(key, (lt.bank, [], []))
        probes.append(eng.health.monitors[name].probes_dev)
        reps.append(lt.rep)
    return {k: (b, torch.stack(p), r) for k, (b, p, r) in groups.items()}


def _check_batched_reads(eng, seed, what: str) -> float:
    """Every live group's batched probe read against the plain loop over
    its members at ``seed`` (None: noiseless), normwise; returns the
    worst error over the limit."""
    from repro_torch.kernels.cim_mvm.ops import cim_mvm_batched
    from repro_torch.kernels.cim_mvm.ref import cim_mvm_batched_plain

    worst = 0.0
    for (slot, pname), (bank, probes, reps) in _health_groups(eng).items():
        y = cim_mvm_batched(probes, bank, seed, reps, probes.device)
        want = cim_mvm_batched_plain(probes, bank, seed, reps)
        for g in range(len(reps)):
            err = (y[g] - want[g]).abs().max().item()
            lim = CIM_TOL * want[g].abs().max().item()
            worst = max(worst, err / lim)
            if err > lim:
                raise AssertionError(f"batched read of {slot}/{pname} "
                                     f"member {reps[g]} ({what}): {err:.3e}"
                                     f" > {lim:.3e}")
    print(f"  batched probe reads ({what}, read seed {seed}): every live "
          f"group's one launch against the plain loop over its members, "
          f"worst {worst:.3f} of the limit {CIM_TOL:g} x max|y|")
    return worst


def _check_refolds(eng, what: str) -> None:
    """Every live matrix's fold bit-identical to the fold's plain version
    of its current gain."""
    from repro_torch.kernels.cim_mvm.ref import folded_weights

    n = 0
    for lt in eng.lifetime.values():
        if lt.demoted:
            continue
        if not torch.equal(lt.dep.folded, folded_weights(lt.dep)):
            raise AssertionError(f"{lt.name}: refreshed fold differs from "
                                 f"its plain version ({what})")
        n += 1
    print(f"  folds after {what}: {n} live matrices bit-identical to the "
          f"plain fold of their gain")


# The earlier batched form (a grid z over the folded decode form, f32
# FMAs) at the same group, for comparison: NVIDIA H100 80GB HBM3, 700 W.
BATCHED_EARLIER = ("the earlier form: 254 registers, no spills, 1 block a "
                   "SM, 15 clusters, no HMMA; 2.8830 ms with noise, 2.0751 "
                   "without")


def _batched_record(eng, built: dict) -> dict:
    """The batched folded decode form at phi3's largest group (a probe
    read of G = 32 members, M = 16, 3072x8192, every member's Wg read
    once: bound by bytes): device time with and without read noise
    beside the byte bound, the plain loop and ``torch.bmm`` on W_eff with
    the noise materialised; registers, spills, blocks a SM, clusters and
    tensor-core instructions of the f32-x instances with and without
    noise, beside the earlier form's."""
    from repro_torch.kernels.cim_mvm.ops import (
        _sm_count,
        batched_geometry,
        cim_mvm_batched,
    )
    from repro_torch.kernels.cim_mvm.ref import (
        cim_mvm_batched_plain,
        deployment_weights,
    )

    n_ops, _ = noise_ops(built)
    bank, probes, reps = _health_groups(eng)[("slot0_attn", "ffn_w_up")]
    G, M, I = probes.shape
    seed = 31
    dev = probes.device
    y = cim_mvm_batched(probes, bank, seed, reps, dev)
    want = cim_mvm_batched_plain(probes, bank, seed, reps)
    err = (y - want).abs().max().item()
    ms = device_ms(lambda: cim_mvm_batched(probes, bank, seed, reps, dev))
    ms_clean = device_ms(lambda: cim_mvm_batched(probes, bank, None, reps,
                                                 dev))
    plain_ms = cuda_ms(lambda: cim_mvm_batched_plain(probes, bank, seed,
                                                     reps), iters=1)
    w_eff = torch.stack([deployment_weights(bank.layer(r), seed)
                         for r in reps])
    lib_ms = device_ms(lambda: torch.bmm(probes, w_eff))
    del w_eff
    i_pad, ld = bank.folded.shape[1:]
    N = bank.out_dim
    n_bytes = G * i_pad * ld * 4 + probes.numel() * 4 + G * M * N * 4 + 4 * G
    b_ms, b_by = bound(n_bytes, 2.0 * G * M * I * N + n_ops * G * I * N)
    occs = {}
    for noise in (True, False):
        geom = batched_geometry(G, M, I, N, *bank.codes.shape[1:], bank.wpt,
                                bank.n_bits, bank.cols, bank.reversed_df,
                                _sm_count(0), False, noise)
        name = f"cim_decode_batched_kernel<Lb{int(noise)}ELb0>"
        occs[noise] = dict(_occupancy(built, name, geom),
                           hmma=built.get(name, {}).get("mma", {}).get(
                               "HMMA"))
    occ = occs[True]
    print(f"cim_mvm_batched G={G} M={M} {I}x{N} (ffn_w_up, the phi3 bank's "
          f"own folds): max_abs_err {err:.3e} against the plain loop (tol "
          f"{CIM_TOL:g} x max|y| {want.abs().max().item():.3e}); kernel "
          f"{ms:.4f} ms with read noise, {ms_clean:.4f} ms without; plain "
          f"{plain_ms:.4f} ms; torch.bmm on W_eff {lib_ms:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB); tile "
          f"{geom.tile}, {geom.gx} persistent blocks in clusters of "
          f"{geom.gy}")
    for o in occs.values():
        print(f"  {o['kernel']}: {_occ_text(o)}, {o['spill_bytes']} bytes "
              f"spilled, {o['hmma']} HMMA in its SASS")
    print(f"  {BATCHED_EARLIER}")
    if err > CIM_TOL * want.abs().max().item():
        raise AssertionError("the batched form disagrees with its plain "
                             "loop at phi3's largest group")
    return dict(name="cim_mvm_batched", route="cuda",
                source="src/repro_torch/kernels/cim_mvm/kernel.cu",
                replaces="src/repro/kernels/cim_mvm/kernel.py:82 (vmapped "
                         "over a stacked group, src/repro/health/"
                         "controller.py:155-162)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, ms_noiseless=ms_clean,
                G=G, M=M, I=I, N=N, **occ,
                blocks_per_sm_noiseless=occs[False]["blocks_per_sm"])


def _round_launches(eng) -> None:
    """Device time of a probe round's batched launches (one a group, the
    round's own arguments), each timed with CUDA events behind a
    ``torch.cuda._sleep``, beside its byte bound (every member's Wg
    read once)."""
    from repro_torch.kernels.cim_mvm.ops import cim_mvm_batched
    from repro_torch.serve.engine import probe_seed

    seed = probe_seed(HEALTH_SEED, eng.health.rounds)
    total = bound_total = 0.0
    parts = []
    for (slot, pname), (bank, probes, reps) in _health_groups(eng).items():
        ms = device_ms(lambda: cim_mvm_batched(probes, bank, seed, reps,
                                               probes.device), iters=5)
        b_ms, _ = bound(len(reps) * bank.folded[0].numel() * 4, 0.0)
        total, bound_total = total + ms, bound_total + b_ms
        parts.append(f"{pname} {ms:.3f}")
    print(f"  a probe round's {len(parts)} batched launches: {total:.3f} ms "
          f"of device time ({', '.join(parts)} ms), byte bound "
          f"{bound_total:.3f} ms")


def _health_arc(eng, serve, check=None) -> dict:
    """Drive HEALTH_ARC on ``eng``: ``serve(eng)`` serves a batch and
    returns (tokens, seconds); ``check(eng, what)`` runs after every
    advance and round.  Prints counters and events by kind after each
    round and the seconds of each step (and, with the engine's swap
    clock, the swaps' draw, aged-gain and fold seconds).  Returns the
    (matrix, event) history, the served runs, the rounds' times and each
    round's probe error a matrix."""
    clock = getattr(eng, "swap_clock", None)
    split = lambda: dict(getattr(clock, "seconds", {}))
    served, rounds, errs = [], [], []
    for i, step in enumerate(HEALTH_ARC):
        if step == "serve":
            served.append(serve(eng))
            continue
        if step:
            s0 = split()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.advance(step)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            s1 = split()
            parts = ", ".join(f"{k} {s1[k] - s0.get(k, 0.0):.2f} s"
                              for k in s1)
            print(f"  advance({step:g}): {dt:.2f} s"
                  + (f" ({parts})" if parts else ""))
            if check:
                check(eng, f"advance({step:g})")
        n_ev = len(eng.health.events)
        s0 = split()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.check_health()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        s1 = split()
        rounds.append(dt)
        errs.append({n: m["last_err"] for n, m in rep.matrices.items()})
        kinds: dict = {}
        for e in rep.events[n_ev:]:
            kinds[e["event"]] = kinds.get(e["event"], 0) + 1
        parts = ", ".join(f"{k} {s1[k] - s0.get(k, 0.0):.2f} s" for k in s1
                          if s1[k] - s0.get(k, 0.0) > 0)
        print(f"  round {rep.rounds}: {dt * 1e3:.1f} ms (swaps: "
              f"{parts or 'none'}); counters {rep.counters}; events "
              f"{kinds or 'none'}")
        if check:
            check(eng, f"round {rep.rounds}")
    hist = [(e["round"], e["matrix"], e["event"])
            for e in eng.health.events]
    return dict(history=hist, served=served, rounds=rounds, errs=errs)


def phase_health(cfg, built: dict, records: list) -> dict:
    """Full-width phi3-mini (bf16) ageing and healing on imperfect
    devices (``HEALTH``, ``spare_line``) through ``ServeEngine(health=)``
    at full depth, then at ``CROSS_LAYERS`` layers through
    ``ServeEngine(health=)`` and ``ContinuousEngine(health=)`` with the
    same seed: the reference's escalation arc on each, the two
    same-depth event histories identical and each round's probe errors
    equal; on each, every refreshed fold bit for bit
    against its plain version, the batched probe reads against their
    plain loop with and without read noise, recalibration lowering each
    tripped matrix's probe error, and after demotion cim_mvm launched
    for the live matrices only.  Then one heal swap under load at full
    depth.  Returns the launch counts of the path (the three arcs and
    the run under load), less the checks'."""
    from repro_torch.health import DetectorConfig, HealthConfig, probe_error
    from repro_torch.kernels import runtime
    from repro_torch.models.model import init_params
    from repro_torch.nonideal import NonidealModel
    from repro_torch.serve import ContinuousEngine, ServeEngine
    from repro_torch.serve.engine import probe_seed

    model = NonidealModel(**HEALTH)
    health = HealthConfig(n_probes=HEALTH_PROBES,
                          max_reprograms=HEALTH_REPROGRAMS,
                          detector=DetectorConfig(**HEALTH_DETECTOR))
    kw = dict(nonideal=model, nonideal_seed=HEALTH_SEED,
              pipeline=NONIDEAL_PIPELINE, health=health, plan_cache=False,
              device="cuda")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, timed_deploy=True, **kw)
    torch.cuda.synchronize()
    n_mats = len(eng.lifetime)
    print(f"phase deploy (phi3-health): {cfg.dtype}, {model}, seed "
          f"{HEALTH_SEED}, {NONIDEAL_PIPELINE}, no plan cache: "
          f"{time.perf_counter() - t0:.2f} s, {n_mats} lifetimes, "
          f"{health}; stages "
          f"{ {k: round(v, 2) for k, v in eng.deploy_report['seconds'].items()} }")
    with _Uncounted():
        records.append(_batched_record(eng, built))
        _check_batched_reads(eng, None, "fresh bank, noiseless")
        _check_batched_reads(eng, probe_seed(HEALTH_SEED, 0),
                             "fresh bank, with read noise")

    def serve(e):
        e.generate(prompts, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = runtime.launch_counts()["cim_mvm"]
        tokens = e.generate(prompts, NEW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = runtime.launch_counts()["cim_mvm"] - before
        live = sum(not lt.demoted for lt in e.lifetime.values())
        print(f"  serve: B={B} prompt {PROMPT} new {NEW}: {dt:.2f} s, "
              f"{B * NEW / dt:.1f} tokens/s; cim_mvm {launches} launches = "
              f"{live} live matrices x {NEW} forwards"
              f"{'' if launches == live * NEW else ' FAIL'}")
        if launches != live * NEW:
            raise AssertionError("cim_mvm launches != live matrices x "
                                 "forwards")
        if not torch.isfinite(e.teacher_forced_logits(torch.cat(
                [prompts.to(e.device), tokens.long()], 1)[:, :PROMPT + 1],
                PROMPT)).all():
            raise AssertionError("non-finite logits")
        return dict(tokens=tokens, tokens_per_s=B * NEW / dt)

    def check(e, what):
        with _Uncounted():
            _check_refolds(e, what)
            if what == "round 5":       # the recalibration round
                _check_recalibration(e)
            if what == "round 6":       # after the reprogram
                _check_batched_reads(e, probe_seed(HEALTH_SEED, 5),
                                     "reprogrammed bank, with read noise")

    def _check_recalibration(e):
        tripped = [ev["matrix"] for ev in e.health.events
                   if ev["round"] == e.health.rounds
                   and ev["event"] == "recalibrate"]
        live = [(n, e.lifetime[n]) for n in tripped]
        ys = e.health._probe_reads(live, probe_seed(HEALTH_SEED,
                                                    e.health.rounds - 1))
        worse = [n for n in tripped if probe_error(
            ys[n], e.health.monitors[n].y_ref)
            >= e.health.monitors[n].last_err]
        print(f"  recalibration: {len(tripped)} tripped matrices "
              f"re-read at the round's read seed, probe error lower for "
              f"{len(tripped) - len(worse)}")
        if worse:
            raise AssertionError(f"recalibration did not lower the probe "
                                 f"error of {worse[:4]}")

    print(f"phase phi3-health (ServeEngine): the arc {HEALTH_ARC}")
    with _Uncounted():
        _round_launches(eng)
    serve_arc = _health_arc(eng, serve, check)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rep = eng.health_report
    print(f"  ServeEngine arc: counters {rep.counters}, flaps {rep.flaps}, "
          f"tokens/s before the heals {serve_arc['served'][0]['tokens_per_s']:.1f}"
          f", after {serve_arc['served'][1]['tokens_per_s']:.1f}; probe "
          f"rounds {[round(r * 1e3, 1) for r in serve_arc['rounds']]} "
          f"ms; peak memory {peak:.1f} GiB")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # The cross-engine check at CROSS_LAYERS layers: ServeEngine, then
    # ContinuousEngine (its swaps landing between batches: no sequence in
    # flight holds the old bank) with the same seed.
    cfg_x = cfg.replace(n_layers=CROSS_LAYERS)
    params_x = {k: {n: t[:CROSS_LAYERS] for n, t in v.items()}
                if k.startswith("slot") else v for k, v in params.items()}
    print(f"phase phi3-health (ServeEngine, {CROSS_LAYERS} layers, same "
          f"seed)")
    eng = ServeEngine(cfg_x, params_x, max_seq=MAX_SEQ, **kw)
    serve_arc = _health_arc(eng, serve, check)
    del eng
    cont = ContinuousEngine(cfg_x, params_x, capacity=2 * B,
                            max_seq=MAX_SEQ, max_prompt=PROMPT, **kw)

    def serve_cont(e):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [e.submit(p.numpy(), max_tokens=NEW) for p in prompts]
        e.run()
        dt = time.perf_counter() - t0
        if e.banks.keys() != {e.serving_epoch}:
            raise AssertionError("an old bank outlived its sequences")
        print(f"  serve (ContinuousEngine): {B} requests, {dt:.2f} s, "
              f"{B * NEW / dt:.1f} tokens/s, epoch {e.serving_epoch}")
        return dict(tokens=[e.results[r] for r in rids],
                    tokens_per_s=B * NEW / dt)

    print(f"phase phi3-health (ContinuousEngine, {CROSS_LAYERS} layers, "
          f"same seed)")
    cont_arc = _health_arc(cont, serve_cont, check)
    if cont_arc["history"] != serve_arc["history"]:
        raise AssertionError("two same-seed engines gave different event "
                             "histories")
    _same_errors(serve_arc["errs"], cont_arc["errs"])
    print(f"  event histories identical across the two engines "
          f"({len(serve_arc['history'])} events: "
          f"{ {k: sum(1 for h in serve_arc['history'] if h[2] == k) for k in ('trip', 'recalibrate', 'reprogram', 'demote', 'clear')} })")
    del cont, params_x
    gc.collect()
    torch.cuda.empty_cache()
    _health_under_load(cfg, params, kw)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return _launches("phi3-health")


def _same_errors(a: list, b: list, rtol: float = 1e-4) -> None:
    """Each round's probe error a matrix of two same-seed engines
    (``_health_arc``'s ``errs``) equal at ``rtol``, the CPU parity
    tests' bound against the reference."""
    worst, n = 0.0, 0
    for r, (ra, rb) in enumerate(zip(a, b, strict=True), 1):
        if ra.keys() != rb.keys():
            raise AssertionError(f"round {r}: the engines' matrices differ")
        for name, ea in ra.items():
            eb = rb[name]
            if (ea is None) != (eb is None):
                raise AssertionError(f"round {r}, {name}: probed on one "
                                     "engine only")
            if ea is None:
                continue
            rel = abs(ea - eb) / max(abs(eb), 1e-30)
            worst, n = max(worst, rel), n + 1
            if rel > rtol:
                raise AssertionError(f"round {r}, {name}: probe error "
                                     f"{ea!r} against {eb!r}")
    print(f"  probe errors of the two engines: {n} (round, matrix) pairs, "
          f"worst relative difference {worst:.3e} (limit {rtol:g})")


def _health_under_load(cfg, params, kw) -> None:
    """A heal swap under load at the config's depth: two requests in
    flight at epoch 0 while ``advance`` lands every refreshed group as a
    new epoch; their tokens equal a same-seed engine's without the swap,
    the pinned bank is dropped when they finish, and the peak memory of
    the two banks (the pinned one whole, the healed one's new gains and
    folds) is printed."""
    from repro_torch.serve import ContinuousEngine

    prompts = torch.randint(0, cfg.vocab_size, (2, PROMPT),
                            generator=torch.Generator().manual_seed(2))
    outs = []
    for swap in (False, True):
        torch.cuda.reset_peak_memory_stats()
        eng = ContinuousEngine(cfg, params, capacity=2, max_seq=MAX_SEQ,
                               max_prompt=PROMPT, **kw)
        base = torch.cuda.max_memory_allocated() / 2 ** 30
        rids = [eng.submit(p.numpy(), max_tokens=NEW) for p in prompts]
        eng.step()
        if swap:
            eng.advance(1e4)
            held = sorted(eng.banks)
        eng.run()
        outs.append([eng.results[r] for r in rids])
        if swap:
            print(f"  heal under load ({cfg.n_layers} layers): advance(1e4) "
                  f"with 2 requests in flight: banks {held} held, "
                  f"{list(eng.banks)} after they finished; peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB "
                  f"allocated, {torch.cuda.max_memory_reserved() / 2 ** 30:.1f}"
                  f" GiB reserved, of the card's "
                  f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}"
                  f" GiB (one bank deployed: {base:.1f} GiB)")
            if list(eng.banks) != [eng.serving_epoch] or held[0] != 0:
                raise AssertionError("the pinned bank was not dropped")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if outs[0] != outs[1]:
        raise AssertionError("a heal swap under load changed the tokens of "
                             "sequences in flight")
    print("  tokens of the sequences in flight bit-identical to a same-seed "
          "engine without the swap")


# ---------------------------------------------------------------- circuit

# Published f64 peak of one H100 SXM outside the tensor cores (NVIDIA
# data sheet); the line-solve kernel's arithmetic runs there.
PEAK_F64 = 34e12
# Operations a node of the line solve takes: its diagonal (2), the
# pivot (2), one reciprocal, c (1), y (3) and the back sweep (2).
LINE_OPS = 11
LINE_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# The phi3-circuit path's Monte-Carlo devices: phi3-nonideal's without
# line opens.
CIRCUIT_MC = {k: v for k, v in NONIDEAL.items() if not k.startswith("p_open")}
MIXED_TOL = 1e-6     # mixed vs f64 currents (tests/test_solver_shard.py:77)


def _line_bound(T: int, J: int, K: int, dtype) -> tuple[float, str]:
    """r (two planes) and g read once, z (two planes) written once; the
    operations at the f64 (or f32) rate outside the tensor cores."""
    n = T * J * K
    f64 = dtype == torch.float64
    return bound(5 * n * (8 if f64 else 4), 2 * n * LINE_OPS,
                 PEAK_F64 if f64 else PEAK_F32)


def _line_kernel(geom: dict) -> str:
    """The compiled name (as ``phase_build`` keys it) of the line-solve
    kernel a geometry launches."""
    from repro_torch.kernels.line_solve.ops import FORMS

    t = "d" if geom["f64"] else "f"
    if FORMS[geom["form"]] == "stream":
        return f"line_stream_kernel<{t}>"
    return f"line_fast_kernel<{t}Li{geom['reg_len']}>"


def _check_line_solve(g64: torch.Tensor, built: dict, card: str) -> dict:
    """line_solve against its plain version at the population's shape
    (g64: the MDM-placed ffn_w_gate tiles, 49,152 of 64x64) and, at the
    same number of nodes, 32x32, the paper's 128x10 tiles and its 128x128
    crossbar, of random masks, in f64 and f32: max|dz| <= LINE_TOL *
    max|z| (and whether bit for bit); device ms beside the byte bound and
    the plain version; the form, registers (this run's -Xptxas -v),
    shared memory, threads, blocks a SM and sweeping warps a SM."""
    from repro_torch.kernels.line_solve import line_solve
    from repro_torch.kernels.line_solve.ops import geometry, occupancy
    from repro_torch.kernels.line_solve.ref import line_solve_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    nodes = g64.numel()
    forms, worst = {}, 0.0
    for J, K in ((64, 64), (32, 32), (128, 10), (128, 128)):
        T = nodes // (J * K)
        if (J, K) == (64, 64):
            g = g64
        else:
            on = torch.rand((T, J, K), generator=gen, device="cuda") < 0.2
            g = torch.where(on, 1 / 300e3, 1 / 3e6).to(torch.float64)
        r = torch.randn((T, 2, J, K), generator=gen, device="cuda",
                        dtype=torch.float64)
        for dtype in (torch.float64, torch.float32):
            gd, rd = g.to(dtype), r.to(dtype)
            with _Uncounted():
                z = line_solve(gd, rd, 0.4)
                want = line_solve_plain(gd, rd, 0.4)
                same = bool(torch.equal(z, want))
                err = (z - want).abs().max().item()
                scale = want.abs().max().item()
                ms = device_ms(lambda: line_solve(gd, rd, 0.4), iters=10)
                plain_ms = cuda_ms(lambda: line_solve_plain(gd, rd, 0.4),
                                   iters=2)
            del z, want
            b_ms, b_by = _line_bound(T, J, K, dtype)
            dt = "f64" if dtype == torch.float64 else "f32"
            occ = occupancy(J, K, dtype)
            kname = _line_kernel(geometry(J, K, dtype))
            ok = err <= LINE_TOL[dtype] * scale
            name = f"{J}x{K} {dt}"
            forms[name] = dict(T=T, max_abs_err=err, max_abs=scale,
                               bit_for_bit=same, ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, kernel=kname,
                               registers=built.get(kname, {}).get("regs"),
                               spill=built.get(kname, {}).get("spill"),
                               **occ)
            print(f"line_solve {name} T={T}: max|dz| {err:.3e} (limit "
                  f"{LINE_TOL[dtype] * scale:.3e}; bit for bit {same}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"{100 * b_ms / ms:.1f}% of it); {occ['form']} form "
                  f"{kname}, {forms[name]['registers']} registers "
                  f"({forms[name]['spill']} B spilled), {occ['stages']} "
                  f"slot(s), {occ['smem_bytes']} B shared, "
                  f"{occ['threads']} threads, {occ['blocks_per_sm']} blocks "
                  f"a SM, {occ['sweeping_warps_per_sm']} sweeping warps a "
                  f"SM [{card}]")
            if not ok:
                raise AssertionError(f"line_solve disagrees at {name}")
            if (J, K) == (64, 64) and dtype == torch.float64:
                worst = err
        del g, r
    main = forms["64x64 f64"]
    return dict(name="line_solve", route="cuda",
                source="src/repro_torch/kernels/line_solve/kernel.cu",
                replaces="src/repro/crossbar/batched.py:312 (not a TPU "
                         "kernel: jax.lax.linalg.tridiagonal_solve)",
                max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, forms=forms)


def _solve_population(masks, spec, precision: str, card: str, what: str):
    """One checked batched solve of the whole population, timed, with
    its iterations, line-solve launches and peak memory."""
    from repro_torch.crossbar import measured_nf_batched_checked
    from repro_torch.kernels import runtime

    T, J, K = masks.shape
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n0 = runtime.launch_counts()["line_solve"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, rep = measured_nf_batched_checked(masks, spec, precision=precision,
                                           device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = runtime.launch_counts()["line_solve"] - n0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # An iteration reads g and the (T, 2, J, K) state x, r, p once and
    # writes x, r, p once: 13 words a node.
    word = 8 if precision == "f64" else 4
    it_ms, _ = bound(13 * T * J * K * word, 0.0)
    print(f"  solve {what} {precision}: {dt:.3f} s, {T / dt:,.0f} tiles/s, "
          f"{rep.iterations} PCG iterations, {n} line_solve launches, "
          f"{rep.escalations} escalations, n_failed {rep.n_failed}; peak "
          f"{peak:.1f} GiB; byte bound {it_ms:.3f} ms an iteration "
          f"({1e3 * dt / max(rep.iterations, 1):.2f} ms measured) [{card}]")
    if rep.n_failed:
        raise AssertionError(f"{rep.n_failed} tiles unconverged ({what}, "
                             f"{precision})")
    return res, dict(seconds=dt, tiles_per_s=T / dt,
                     iterations=rep.iterations, launches=n, peak_gib=peak)


def _profile_solve(masks, spec, seconds: float, iters: int, card: str):
    """Device time by kernel of one MDM mixed population solve
    (torch.profiler): the 10 largest, line_solve's share of the busy
    time, and the idle share against the unprofiled solve's seconds."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.crossbar import measured_nf_batched_checked

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        measured_nf_batched_checked(masks, spec, precision="mixed",
                                    device="cuda")
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print("  profile: the profiler saw no device time: not measured")
        return None
    line = sum(r[0] for r in rows if "line_" in r[2])
    wall = 1e3 * seconds
    print(f"  profile of one MDM mixed solve ({iters} PCG iterations): "
          f"device busy {busy:.2f} ms of {wall:.2f} ms (unprofiled) -> "
          f"idle share {100 * max(0.0, 1 - busy / wall):.1f}%; line_solve "
          f"{line:.2f} ms ({100 * line / busy:.1f}% of busy); "
          f"{len(rows)} kernels [{card}]")
    for ms, n, key in rows[:10]:
        print(f"    {ms:9.3f} ms {n:5d} launches ({1e3 * ms / max(n, 1):8.1f}"
              f" us each, {100 * ms / busy:5.1f}%)  {key[:80]}")
    return dict(busy_ms=busy, line_solve_ms=line, wall_ms=wall,
                top=[dict(ms=ms, launches=n, kernel=key[:120])
                     for ms, n, key in rows[:10]])


def phase_circuit(w: torch.Tensor, built: dict, card: str):
    """phi3-circuit: the circuit solver on the placed masks of one
    full-width phi3 projection (layer 0's ffn_w_gate, 3072x8192, the f32
    path's seed-0 weights: 49,152 tiles of 64x64) under the baseline and
    the MDM placements, through the checked batched solver (MIXED, and
    F64 under MDM); the line-solve kernel against its plain version
    first; then throughput at benchmarks/solver_throughput.py's shapes,
    calibrate_eta and a Monte-Carlo ensemble.  Returns (the kernel's
    record, the path's launch counts)."""
    from repro_torch.core.bitslice import bitslice
    from repro_torch.core.manhattan import nonideality_factor
    from repro_torch.core.mdm import placed_masks, plan_layer
    from repro_torch.core.noise import PAPER_ETA, calibrate_eta
    from repro_torch.core.tiling import CrossbarSpec
    from repro_torch.crossbar import (
        column_currents_dense,
        conductances,
        measured_nf_batched,
        measured_nf_batched_checked,
        measured_nf_sequential,
    )
    from repro_torch.kernels import runtime
    from repro_torch.nonideal import NonidealModel, mc_nf, summarize

    spec = CrossbarSpec(64, 64, 8)
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    bits = bitslice(w, spec.n_bits).bits
    masks = {}
    for placement in ("baseline", "mdm"):
        plan = plan_layer(w, spec, placement)
        masks[placement] = placed_masks(bits, plan, spec).reshape(
            -1, spec.rows, spec.cols).contiguous()
    del bits
    torch.cuda.synchronize()
    T = masks["mdm"].shape[0]
    print(f"phase phi3-circuit: layer 0 ffn_w_gate {tuple(w.shape)} -> "
          f"{T} tiles of 64x64, placed masks (baseline, mdm) in "
          f"{time.perf_counter() - t0:.2f} s")
    rec = _check_line_solve(conductances(masks["mdm"], spec), built, card)

    gen = torch.Generator(device="cuda").manual_seed(3)
    # At tests/test_solver.py's density (its rand_mask, p = 0.2).
    small = torch.rand((4, 16, 16), generator=gen, device="cuda") < 0.2
    spec16 = CrossbarSpec(16, 16, 8)
    res = measured_nf_batched(small, spec16, device="cuda")
    err = max(float(abs(res.currents[i].cpu().numpy() / column_currents_dense(
        small[i].cpu().numpy(), [spec16.v_read] * 16, spec16) - 1).max())
        for i in range(4))
    print(f"  4 tiles of 16x16 against the dense numpy oracle: max rel "
          f"{err:.3e} (limit 1e-7) {'ok' if err <= 1e-7 else 'FAIL'}")
    if err > 1e-7:
        raise AssertionError("the card's solve disagrees with the oracle")

    solves, nf = {}, {}
    for placement, precision in (("baseline", "mixed"), ("mdm", "mixed"),
                                 ("mdm", "f64")):
        r, solves[f"{placement} {precision}"] = _solve_population(
            masks[placement], spec, precision, card, placement)
        if precision == "mixed":
            nf[placement] = r.nf_total
        if placement == "mdm":
            if precision == "mixed":
                mixed = r.currents
            else:
                rel = ((mixed - r.currents).abs()
                       / r.currents.abs()).max().item()
                print(f"  mixed vs f64 currents (mdm): max rel {rel:.3e} "
                      f"(limit {MIXED_TOL}) "
                      f"{'ok' if rel <= MIXED_TOL else 'FAIL'}")
                if rel > MIXED_TOL:
                    raise AssertionError("mixed and f64 solves disagree")
                sub = masks["mdm"][:64].cpu()
                cpu = measured_nf_batched(sub, spec, device="cpu")
                rel = (cpu.currents - r.currents[:64].cpu()).abs().div(
                    cpu.currents.abs()).max().item()
                print(f"  64 tiles against the CPU port's f64 solve: max "
                      f"rel {rel:.3e} (limit 1e-7) "
                      f"{'ok' if rel <= 1e-7 else 'FAIL'}")
                if rel > 1e-7:
                    raise AssertionError("card and CPU solves disagree")
                del mixed
        del r
    total = {k: v.sum().item() for k, v in nf.items()}
    corr = {}
    for k, v in nf.items():
        pred = nonideality_factor(masks[k], spec.r, spec.r_on).double()
        corr[k] = torch.corrcoef(torch.stack([v, pred]))[0, 1].item()
    print(f"  sum NF over {T} tiles: baseline {total['baseline']:.6f}, mdm "
          f"{total['mdm']:.6f}: {100 * (1 - total['mdm'] / total['baseline']):.2f}"
          f"% lower under MDM; correlation with the analytic NF "
          f"(Eq 16): baseline {corr['baseline']:.4f}, mdm {corr['mdm']:.4f}")
    mdm = solves["mdm mixed"]
    prof = _profile_solve(masks["mdm"], spec, mdm["seconds"],
                          mdm["iterations"], card)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for J in (32, 64, 128):
        m = (torch.rand((512, J, J), generator=gen, device="cuda")
             < 0.2).to(torch.float32)
        sp = CrossbarSpec(J, J, 8)
        line = []
        for precision in ("f64", "mixed"):
            measured_nf_batched(m, sp, precision=precision,
                                device="cuda")                # warm
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = measured_nf_batched(m, sp, precision=precision, device="cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            line.append(f"{precision} {dt * 1e3:.1f} ms ({512 / dt:,.0f} "
                        f"tiles/s, {r.iterations} iterations)")
        if J == 128:
            # The paper's crossbar, checked: no tile left unconverged.
            res, rep = measured_nf_batched_checked(m, sp, precision="mixed",
                                                   device="cuda")
            rel = ((res.currents - r.currents).abs()
                   / r.currents.abs()).max().item()
            print(f"  throughput, 512 tiles of {J}x{J} at 20% density: "
                  f"{', '.join(line)}; checked mixed: {rep.iterations} "
                  f"iterations, {rep.escalations} escalations, n_failed "
                  f"{rep.n_failed}, currents within {rel:.1e} of the "
                  f"unchecked mixed solve [{card}]")
            if rep.n_failed or rel > MIXED_TOL:
                raise AssertionError("the checked 128x128 solve failed")
            continue
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seq = measured_nf_sequential(m[:8], sp, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        rel = ((seq.currents - r.currents[:8]).abs()
               / r.currents[:8].abs()).max().item()
        print(f"  throughput, 512 tiles of {J}x{J} at 20% density: "
              f"{', '.join(line)}; sequential Jacobi CG on 8 of them "
              f"{dt:.3f} s ({8 / dt:,.1f} tiles/s; currents within "
              f"{rel:.1e} of the batched solve) [{card}]")
        if rel > 1e-5:
            raise AssertionError("sequential and batched solves disagree")

    etas = {}
    for precision in (None, "mixed"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        etas[precision] = calibrate_eta(spec, n_tiles=16, precision=precision,
                                        device="cuda")
        torch.cuda.synchronize()
        etas[f"{precision} s"] = time.perf_counter() - t1
    rel = abs(etas["mixed"] - etas[None]) / etas[None]
    print(f"  calibrate_eta (64x64x8, 16 tiles): f64 {etas[None]:.6e} "
          f"({etas['None s']:.3f} s), mixed {etas['mixed']:.6e} "
          f"({etas['mixed s']:.3f} s), PAPER_ETA {PAPER_ETA:.1e}; policies "
          f"within {rel:.1e} (limit 1e-8) {'ok' if rel <= 1e-8 else 'FAIL'}")
    if rel > 1e-8:
        raise AssertionError("calibrate_eta's policies disagree")

    model = NonidealModel(**CIRCUIT_MC)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mc = mc_nf(masks["mdm"][:512], spec, model, 4, 0, precision="mixed",
               device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    print(f"  mc_nf: {model}, S=4 x 512 tiles, mixed: {dt:.3f} s, "
          f"{mc.iterations} iterations, unconverged {mc.unconverged}; NF "
          f"{summarize(mc.nf_total)}, weighted error "
          f"{summarize(mc.weighted_err)} [{card}]")
    if mc.unconverged:
        raise AssertionError("mc_nf left tiles unconverged")
    counts = _launches("phi3-circuit")
    rec.update(solves=solves, sum_nf=total, nf_correlation=corr,
               eta=etas[None], eta_mixed=etas["mixed"], profile=prof)
    return rec, counts


# The qwen2-moe path: the depth cut of its f32 end-to-end check and that
# check's greedy tokens.
MOE_F32_LAYERS, MOE_F32_NEW = 4, 8


def _bank_bytes(dep) -> int:
    return sum(getattr(dep, f).numel() * getattr(dep, f).element_size()
               for f in ("codes", "pos", "scale"))


class _GroupedCalls:
    """An ``Ops.grouped`` that records every call, around the kernel:
    (assignments, the offsets on the host, cap, x, the offsets).  Its
    host syncs make it a measuring tool only, never the timed path."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __call__(self, x, dep, offsets, cap, read_seed=None):
        self.calls.append((x.shape[0] - 1, offsets.tolist(), cap, x,
                           offsets, read_seed))
        return self.inner(x, dep, offsets, cap, read_seed)


def _routing_stats(eng, prompts, steps: int = 3):
    """Routing of a generate call (prefill, then ``steps`` - 1 decode
    steps): tokens' assignments dropped at prefill (all layers), distinct
    experts a decode step a layer hits, and the recorded calls."""
    from repro_torch.models.model import KERNELS

    rec = _GroupedCalls(KERNELS.grouped)
    probe = copy.copy(eng)
    probe.ops = KERNELS._replace(grouped=rec)
    probe.generate(prompts, steps)
    R = eng.cfg.pattern_repeats
    per_forward = 3 * R                   # gate, up, down a layer
    fw = [rec.calls[i:i + per_forward]
          for i in range(0, len(rec.calls), per_forward)]
    E = eng.cfg.n_experts
    drop = [n - off[E] for n, off, _, *_ in fw[0][::3]]
    hits = [[sum(1 for e in range(E) if off[e + 1] > off[e])
             for _, off, _, *_ in f[::3]] for f in fw[1:]]
    return drop, hits, fw


def _check_grouped(eng, fw, g) -> dict:
    """The grouped forms against their plain version on layer 0's real
    calls (the prefill's and a decode step's gate and down products,
    ``fw`` from :func:`_routing_stats`) and on three forced routings (one
    expert with every row, the others empty; one expert at exactly the
    capacity; a continuous decode step, ``ContinuousEngine(capacity=8)``
    x top-4: 32 rows, cap 32): CIM_TOL x max|y|, rows no expert computes
    exactly 0, two calls bit-identical.  Its device time cold (each call
    reads another layer's bank), beside the bound of this call's hit
    experts and rows: bytes, or the operations of the form the call took
    (the decode form's f32 FMAs at PEAK_F32; the prefill form's TF32
    tensor-core products at PEAK_TF32, 2 a product with bf16 x and 3 with
    f32), the plain version and ``torch.bmm`` of the (E, cap, I) capacity
    buffer on the materialised f32 (E, I, N) W'; the form, its cluster
    and its blocks a SM."""
    from repro_torch.kernels.cim_mvm.ops import (
        FORM_GROUPED_DECODE,
        FORM_GROUPED_PREFILL,
        cim_mvm_grouped,
        grouped_geometry,
        occupancy,
    )
    from repro_torch.kernels.cim_mvm.ref import (
        cim_effective_weights,
        cim_mvm_grouped_plain,
    )

    slot = eng.cim["slot0_attn"]
    R, E = eng.cfg.pattern_repeats, eng.cfg.n_experts
    cases = []
    for regime, f in (("prefill", fw[0]), ("decode", fw[1])):
        for j, pname in ((0, "ffn_we_gate"), (2, "ffn_we_down")):
            _, _, cap, x, offsets, _ = f[j]
            cases.append((f"{regime} {pname}", pname, x, offsets, cap))
    cap = fw[0][0][2]
    K = eng.cfg.n_experts_per_token
    cont = [0] * E                 # 8 tokens, each on K distinct experts
    for t in range(CAPACITY):
        for e in torch.randperm(E, generator=torch.Generator().manual_seed(
                t))[:K].tolist():
            cont[e] += 1
    for regime, counts, c in (
            ("one expert", [0] * 3 + [cap] + [0] * (E - 4), cap),
            ("at cap", [cap // 3] * 7 + [cap] + [cap // 5] * (E - 8), cap),
            ("continuous decode", cont, CAPACITY * K)):
        offsets = torch.tensor([0] + list(itertools.accumulate(counts)),
                               dtype=torch.int32, device="cuda")
        A = sum(counts) + 1
        x = torch.randn((A, eng.cfg.d_model), generator=g,
                        device="cuda").to(torch.bfloat16)
        cases.append((regime, "ffn_we_gate", x, offsets, c))
    regimes = {}
    w_eff = {}
    for regime, pname, x, offsets, cap in cases:
        dep = slot[pname].layer(0)
        y = cim_mvm_grouped(x, dep, offsets, cap, device="cuda")
        p = cim_mvm_grouped_plain(x, dep, offsets, cap)
        torch.cuda.synchronize()
        err = (y - p).abs().max().item()
        ref = p.abs().max().item()
        off = offsets.tolist()
        done = torch.zeros(x.shape[0], dtype=torch.bool, device="cuda")
        counts = []
        for e in range(E):
            done[off[e]:min(off[e + 1], off[e] + cap)] = True
            counts.append(min(off[e + 1] - off[e], cap))
        ok = (err <= CIM_TOL * ref and (y[~done] == 0).all().item()
              and torch.equal(y, cim_mvm_grouped(x, dep, offsets, cap, device="cuda")))
        banks = [slot[pname].layer(r) for r in range(R)]
        ms = device_ms(lambda d: cim_mvm_grouped(x, d, offsets, cap, device="cuda"),
                       args=banks)
        plain_ms = cuda_ms(lambda: cim_mvm_grouped_plain(x, dep, offsets,
                                                         cap), iters=2)
        if pname not in w_eff:
            w_eff[pname] = torch.stack([cim_effective_weights(
                d.codes, d.pos, d.scale, n_bits=d.n_bits, wpt=d.wpt,
                cols=d.cols, eta=d.eta, reversed_df=d.reversed_df)[
                    :d.in_dim, :d.out_dim]
                for d in (dep.layer(e) for e in range(E))])
        W = w_eff[pname]
        buf = torch.zeros((E, cap, dep.in_dim), device="cuda")
        for e in range(E):
            buf[e, :counts[e]] = x[off[e]:off[e] + counts[e]].float()
        lib_ms = device_ms(lambda: torch.bmm(buf, W))
        hit = sum(1 for c in counts if c)
        rows = sum(counts)
        per_expert = _bank_bytes(dep.layer(0))
        n_bytes = (hit * per_expert + x.numel() * x.element_size()
                   + x.shape[0] * dep.out_dim * 4 + (E + 1) * 4)
        bf = x.dtype == torch.bfloat16
        geom = grouped_geometry(E, cap, dep.in_dim, dep.out_dim,
                                dep.codes.shape[2], dep.wpt, dep.n_bits,
                                dep.cols, dep.reversed_df,
                                dep.codes.data_ptr() % 16 == 0, bf,
                                x.shape[0])
        flops = 2.0 * rows * dep.in_dim * dep.out_dim
        if geom.form == FORM_GROUPED_PREFILL:
            b_ms, b_by = bound(n_bytes, (2 if bf else 3) * flops, PEAK_TF32)
        else:
            b_ms, b_by = bound(n_bytes, flops)
        form = {FORM_GROUPED_DECODE: "decode", FORM_GROUPED_PREFILL:
                "prefill"}.get(geom.form, "general")
        split = geom.gy if form != "general" else 1
        occ = occupancy(geom)
        print(f"cim_mvm_grouped {regime} E={E} {dep.in_dim}x{dep.out_dim} "
              f"cap {cap}: {rows} rows on {hit} experts, max_abs_err "
              f"{err:.3e} (tol {CIM_TOL:g} x max|y| {ref:.3e}, rows no "
              f"expert computes 0, two calls bit-identical) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms cold (a layer "
              f"a call), plain {plain_ms:.4f} ms, bmm on W' {lib_ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}; {n_bytes / 1e6:.1f} MB, "
              f"{100 * b_ms / ms:.1f}% of it); {form} form, grid "
              f"{geom.gx}x{geom.gy}x{geom.gz}, cluster of {split}, "
              f"{occ['blocks_per_sm']} blocks a SM"
              + (f", {occ['clusters']} clusters at once"
                 if occ["clusters"] else ""))
        if not ok:
            raise AssertionError(f"cim_mvm_grouped disagrees ({regime})")
        regimes[regime] = dict(rows=rows, hit=hit, cap=cap, max_abs_err=err,
                               ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=lib_ms, form=form,
                               cluster=split,
                               blocks_per_sm=occ["blocks_per_sm"])
        del buf
    del w_eff
    top = regimes["decode ffn_we_gate"]
    return dict(name="cim_mvm_grouped", route="cuda",
                source="src/repro_torch/kernels/cim_mvm/kernel.cu",
                replaces="src/repro/kernels/cim_mvm/kernel.py:82",
                vmapped_at="src/repro/models/moe.py:50-61",
                max_abs_err=max(r["max_abs_err"] for r in regimes.values()),
                **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                regimes=regimes)


def _moe_f32_twin(eng, n_layers: int):
    """The engine at its first ``n_layers`` layers with f32 activations:
    its params sliced and widened, its bank's first repeats (views of
    every field: the devices' state, the fold and the device tags)."""
    cfg = eng.cfg.replace(n_layers=n_layers, dtype="float32")
    params = {k: (v.float() if isinstance(v, torch.Tensor) else
                  {n: t[:n_layers].float() for n, t in v.items()})
              for k, v in eng.params.items()}

    def cut(d):
        out = dataclasses.replace(d, **{
            f: getattr(d, f)[:n_layers]
            for f in ("codes", "pos", "scale", "gain", "col_pos",
                      "degraded", "noise_tag") if getattr(d, f) is not None})
        for f in ("folded", "device_tags"):
            if getattr(d, f) is not None:
                setattr(out, f, getattr(d, f)[:n_layers])
        return out

    cim = {slot: {k: cut(d) for k, d in deps.items()}
           for slot, deps in eng.cim.items()}
    twin = copy.copy(eng)
    twin.cfg, twin.params, twin.cim = cfg, params, cim
    return twin


def phase_moe(records: list, built: dict, card: str) -> dict:
    """qwen2-moe-a2.7b at full width and depth in its config dtype
    (bf16), random weights from seed 0, through ``ServeEngine`` with
    ``mdm_expert`` (every expert bank deployed, one matrix an expert; no
    plan cache: one deploy, its stages timed), B x PROMPT-token prompts
    and NEW greedy tokens: the attention projections through cim_mvm's
    ideal forms, the expert banks through its grouped form, attention
    through flash in bf16 at Dh = 128.  Then the grouped form against its
    plain version on real and forced routings, flash's Dh = 128 bf16
    forms, every kernel call of a teacher-forced pass against its plain
    version, one expert's plan against the CPU mirror, and the first
    MOE_F32_LAYERS layers with f32 activations end to end against the
    plain path."""
    from repro_torch.configs import CimConfig
    from repro_torch.configs.qwen2_moe_a27b import CONFIG as QWEN
    from repro_torch.kernels import runtime
    from repro_torch.models.model import apply_model, init_decode_state
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    cfg = QWEN.replace(cim=CimConfig(enabled=True, mode="mdm_expert"))
    E, K = cfg.n_experts, cfg.n_experts_per_token
    print(f"config {cfg.name} ({cfg.dtype}, its CONFIG dtype): "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, "
          f"{E} experts top-{K} of width {cfg.moe_d_ff}, "
          f"{cfg.n_shared_experts} fused shared experts of {cfg.d_ff}, qkv "
          f"bias, vocab {cfg.vocab_size}; pipeline mdm_expert; no depth cut")
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, plan_cache=False,
                      timed_deploy=True, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rep = eng.deploy_report
    summary = rep["matrices"]
    reasons: dict = {}
    for reason in summary["skipped"].values():
        reasons[reason] = reasons.get(reason, 0) + 1
    n_exp = sum(1 for n in summary["deployed"] if "/e" in n)
    print(f"phase deploy (qwen2-moe): init {t1 - t0:.2f} s, deploy "
          f"{t2 - t1:.2f} s uncached (by stage "
          f"{ {k: round(v, 3) for k, v in rep['seconds'].items()} }): "
          f"{summary['n_deployed']} matrices deployed ({n_exp} expert, "
          f"{summary['n_deployed'] - n_exp} attention), "
          f"{summary['n_skipped']} skipped {reasons}; {rep['tiles']} tiles, "
          f"NF reduction {100 * rep['nf_reduction']:.3f}%")
    fields = {"codes": 0, "pos": 0, "scale": 0}
    expert_gb = 0
    for deps in eng.cim.values():
        for pname, d in deps.items():
            for f in fields:
                n = getattr(d, f).numel() * getattr(d, f).element_size()
                fields[f] += n
                expert_gb += n if pname.startswith("ffn_we") else 0
    param_gb = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  bank {sum(fields.values()) / 1e9:.2f} GB "
          f"({ {f: round(n / 1e9, 3) for f, n in fields.items()} }; "
          f"experts {expert_gb / 1e9:.2f} GB), params "
          f"{param_gb / 1e9:.2f} GB; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, "
          f"reserved {torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB")

    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    eng.generate(prompts, 2)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    step = (t_all - t_prefill) / (NEW - 1)
    print(f"phase serve (qwen2-moe): B={B} prompt {PROMPT} new {NEW}: "
          f"prefill {t_prefill * 1e3:.1f} ms, decode {step * 1e3:.2f} "
          f"ms/step, {B * NEW / t_all:.1f} tokens/s (peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f})")
    counts = _launches("qwen2-moe")
    forwards = 2 + 1 + NEW
    if counts["cim_mvm_grouped"] != 3 * cfg.n_layers * forwards \
            or counts["cim_mvm"] != 4 * cfg.n_layers * forwards:
        raise AssertionError(f"launches {counts} != 3 grouped and 4 "
                             f"cim_mvm a layer x {forwards} forwards")
    print(f"  cim_mvm_grouped {counts['cim_mvm_grouped']} launches = 3 "
          f"expert banks x {cfg.n_layers} layers x {forwards} forwards; "
          f"cim_mvm {counts['cim_mvm']} = 4 attention projections x "
          f"{cfg.n_layers} x {forwards}")
    if not torch.isfinite(eng.teacher_forced_logits(
            torch.cat([prompts.cuda(), tokens.long()], 1)[:, :PROMPT + 1],
            PROMPT)).all():
        raise AssertionError("non-finite logits")
    busy = phase_profile(eng, prompts, step * 1e3)

    # Launches of one decode step by kernel.
    state = init_decode_state(cfg, B, MAX_SEQ, "cuda")
    logits, state = apply_model(eng.params, cfg, prompts.cuda(), state=state,
                                cim=eng.cim)
    runtime.reset_launch_counts()
    apply_model(eng.params, cfg, logits[:, -1].argmax(-1)[:, None],
                state=state, decode=True, cim=eng.cim)
    torch.cuda.synchronize()
    per_step = {k: n for k, n in runtime.launch_counts().items() if n}
    del state, logits
    drop, hits, fw = _routing_stats(eng, prompts)
    flat = [h for f in hits for h in f]
    n_assign = B * PROMPT * K
    print(f"  launches a decode step: {per_step}; prefill drops "
          f"{sum(drop)} of {n_assign * cfg.n_layers} assignments "
          f"({n_assign} a layer, capacity {fw[0][0][2]} an expert; per "
          f"layer {drop}); distinct experts hit a decode step a layer: "
          f"mean {sum(flat) / len(flat):.2f}, max {max(flat)} of {E} "
          f"(B x top-{K} = {B * K})")
    # The decode step's byte bound: every hit expert's three banks, the
    # attention bank, the digital shared experts, router and biases, and
    # lm_head, each read once (embedding rows and the KV cache left out).
    slot = eng.cim["slot0_attn"]
    per_expert = sum(_bank_bytes(slot[n].layer(0).layer(0))
                     for n in ("ffn_we_gate", "ffn_we_up", "ffn_we_down"))
    attn = sum(_bank_bytes(slot[n]) for n in ("wq", "wk", "wv", "wo"))
    digital = sum(t.numel() * t.element_size()
                  for n, t in params["slot0_attn"].items()
                  if not n.startswith("ffn_we") and n not in (
                      "wq", "wk", "wv", "wo"))
    head = params["lm_head"].numel() * params["lm_head"].element_size()
    rest = attn + digital + head
    run_bytes = sum(flat) / len(hits) * per_expert + rest
    worst = cfg.n_layers * B * K * per_expert + rest
    print(f"  decode step {step * 1e3:.2f} ms against its byte bound "
          f"{run_bytes / PEAK_BYTES * 1e3:.3f} ms at this run's hits "
          f"({run_bytes / 1e9:.2f} GB: experts "
          f"{(run_bytes - rest) / 1e9:.2f}, attention bank {attn / 1e9:.2f}, "
          f"shared experts / router / norms / biases {digital / 1e9:.2f}, "
          f"lm_head {head / 1e9:.2f}) and "
          f"{worst / PEAK_BYTES * 1e3:.3f} ms at {B * K} experts a layer "
          f"({worst / 1e9:.2f} GB); device busy "
          + (f"{busy:.2f} ms a step" if busy else "not measured"))

    g = torch.Generator(device="cuda").manual_seed(3)
    records.append(_check_grouped(eng, fw, g))
    del fw
    records.append(_check_flash(g, torch.bfloat16, built, H=cfg.n_heads,
                                Dh=cfg.resolved_head_dim,
                                cases=("prefill", "decode"),
                                name="flash_attention[bf16,Dh=128]"))
    phase_plans(eng, [("slot0_attn", "ffn_we_gate", 7), ("slot0_attn", "wq")])
    seq = torch.cat([prompts.cuda(), tokens.long()], 1)[:, :PROMPT + TF_STEPS]
    lk = _check_calls(eng, seq, "qwen2-moe")
    if not (torch.isfinite(lk).all()
            and lk.shape == (B, TF_STEPS + 1, cfg.padded_vocab)):
        raise AssertionError("non-finite or misshapen logits")
    del lk

    # f32 activations at a depth cut: the bf16 params are freed first.
    twin = _moe_f32_twin(eng, MOE_F32_LAYERS)
    eng.params = None
    del params
    gc.collect()
    torch.cuda.empty_cache()
    plain = copy.copy(twin)
    plain.ops = _plain_ops()
    seq = torch.cat([prompts.cuda(), tokens.long()], 1)[
        :, :PROMPT + MOE_F32_NEW - 1]
    V = cfg.vocab_size
    lk = twin.teacher_forced_logits(seq, PROMPT)[..., :V]
    lp = plain.teacher_forced_logits(seq, PROMPT)[..., :V]
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    ok = err <= LOGIT_TOL * ref
    tk, tp = twin.generate(prompts, MOE_F32_NEW), plain.generate(
        prompts, MOE_F32_NEW)
    top2 = lp.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flips = [(b, t, int(tk[b, t]), int(tp[b, t]), gap[b, t].item())
             for b, t in (tk != tp).nonzero().tolist()]
    print(f"  f32 activations, first {MOE_F32_LAYERS} of {cfg.n_layers} "
          f"layers (same bank): teacher-forced logits ({lk.shape[1]} steps) "
          f"max_abs_err {err:.3e} ({err / ref:.3e} of max|logit| "
          f"{ref:.3e}), tol {LOGIT_TOL:g} x max {'ok' if ok else 'FAIL'}; "
          f"greedy tokens {int((tk == tp).sum())}/{tk.numel()} equal"
          + (f"; flips (row, step, kernel, plain, plain top-2 gap): {flips}"
             if flips else ""))
    if not ok:
        raise AssertionError("f32 kernel-path logits disagree with the "
                             "plain path (qwen2-moe)")
    if flips:
        raise AssertionError(f"qwen2-moe f32 greedy tokens flip: {flips}")
    del twin, plain, eng, lk, lp
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# qwen2-moe on imperfect devices: the depth the card holds (a served
# expert weight costs ~11 B: int16 code 2, pos 0.5, f32 gain 4, col_pos
# 0.5, f32 fold 4; 24 layers would take ~137 GB), the phi3-nonideal
# devices without line opens (which would demote every full-width
# expert), the spare-line mapping on the expert partition.
MOE_NONIDEAL_LAYERS = 8
MOE_NONIDEAL_PIPELINE = "part=expert,row=spare_line,col=spare_line"
MOE_TF_STEPS = 2     # decode steps of its call-by-call check
# Its forced demotion: moe_ffn of the kernel and plain paths in f32, three
# grouped products (each at CIM_TOL of its own scale) through silu and the
# combine.
MOE_FFN_TOL = 1e-4


def _bank_fields(eng) -> dict:
    """Bytes of every field of the engine's banks: the expert banks'
    and the attention projections' apart."""
    out: dict = {}
    for deps in eng.cim.values():
        for pname, d in deps.items():
            part = out.setdefault("experts" if pname.startswith("ffn_we")
                                  else "attention", {})
            for f in ("codes", "pos", "scale", "gain", "col_pos", "folded"):
                t = getattr(d, f)
                if t is not None:
                    part[f] = part.get(f, 0) + t.numel() * t.element_size()
    return out


def _grouped_folded_record(eng, fw, built: dict) -> dict:
    """The grouped folded forms on layer 0's real gate calls (the
    prefill's and a decode step's, at their read seeds) against their
    plain version (CIM_TOL x max|y|, rows no expert computes 0, two calls
    bit-identical), the device time of the form the geometry takes cold
    (each call reads another layer's bank) with and without the read's
    noise, of the first (general) form forced on the same call, of the
    plain version, and of ``torch.bmm`` of the (E, cap, I) capacity
    buffer on the (E, I, N) W_eff with this read's noise materialised;
    beside the bound of the call's hit experts for the form taken: their
    folds' bytes, or the operations on the pipe that does most (the
    decode and general forms: the noise, NOISE_OPS a weight, and the
    products on the f32 pipe; the prefill form: the noise on the f32 pipe
    or the TF32 products, 2 a product with bf16 x, 3 with f32); with the
    form's registers, spills and blocks a SM."""
    from repro_torch.kernels.cim_mvm.ops import (
        FORM_GROUPED_FOLDED,
        FORM_GROUPED_FOLDED_DECODE,
        FORM_GROUPED_FOLDED_PREFILL,
        cim_mvm_grouped,
        grouped_folded_geometry,
    )
    from repro_torch.kernels.cim_mvm.ref import (
        cim_mvm_grouped_plain,
        deployment_weights,
    )

    kernels = {FORM_GROUPED_FOLDED: ("general", "cim_grouped_folded_kernel"),
               FORM_GROUPED_FOLDED_DECODE:
                   ("decode", "cim_grouped_folded_decode_kernel"),
               FORM_GROUPED_FOLDED_PREFILL:
                   ("prefill", "cim_grouped_folded_prefill_kernel")}
    slot = eng.cim["slot0_attn"]
    R, E = eng.cfg.pattern_repeats, eng.cfg.n_experts
    per_weight = noise_ops(built)[0]
    regimes = {}
    for regime, f in (("prefill", fw[0]), ("decode", fw[1])):
        _, off, cap, x, offsets, seed = f[0]
        dep = slot["ffn_we_gate"].layer(0)
        I, N = dep.in_dim, dep.out_dim
        run = lambda d, s=seed, form=None: cim_mvm_grouped(
            x, d, offsets, cap, s, device="cuda", form=form)
        y = run(dep)
        p = cim_mvm_grouped_plain(x, dep, offsets, cap, seed)
        err = (y - p).abs().max().item()
        ref = p.abs().max().item()
        counts = [min(off[e + 1] - off[e], cap) for e in range(E)]
        done = torch.zeros(x.shape[0], dtype=torch.bool, device="cuda")
        for e in range(E):
            done[off[e]:off[e] + counts[e]] = True
        ok = (err <= CIM_TOL * ref and (y[~done] == 0).all().item()
              and torch.equal(y, run(dep)))
        general_err = (run(dep, form=FORM_GROUPED_FOLDED) - p).abs().max(
        ).item()
        ok = ok and general_err <= CIM_TOL * ref
        banks = [slot["ffn_we_gate"].layer(r) for r in range(R)]
        ms = device_ms(run, args=banks)
        clean_ms = device_ms(lambda d: run(d, None), args=banks)
        general_ms = device_ms(lambda d: run(d, form=FORM_GROUPED_FOLDED),
                               args=banks)
        plain_ms = cuda_ms(lambda: cim_mvm_grouped_plain(
            x, dep, offsets, cap, seed), iters=2)
        W = torch.stack([deployment_weights(dep.layer(e), seed)[:I, :N]
                         for e in range(E)])
        buf = torch.zeros((E, cap, I), device="cuda")
        for e in range(E):
            buf[e, :counts[e]] = x[off[e]:off[e] + counts[e]].float()
        lib_ms = device_ms(lambda: torch.bmm(buf, W))
        del W, buf
        hit = sum(1 for c in counts if c)
        rows = sum(counts)
        bf = x.dtype == torch.bfloat16
        geom = grouped_folded_geometry(E, cap, I, N, dep.codes.shape[2], bf,
                                       True, x.shape[0],
                                       torch.cuda.get_device_properties(0)
                                       .multi_processor_count)
        n_bytes = (hit * dep.folded[0].numel() * 4
                   + x.numel() * x.element_size()
                   + x.shape[0] * N * 4 + (E + 1) * 4 + E * 4)
        noise_n = hit * I * N * per_weight
        if geom.form == FORM_GROUPED_FOLDED_PREFILL:
            b_ms, b_by = max(bound(n_bytes, noise_n),
                             bound(0.0, (2 if bf else 3) * 2.0 * rows * I
                                   * N, PEAK_TF32))
        else:
            b_ms, b_by = bound(n_bytes, noise_n + 2.0 * rows * I * N)
        form, kname = kernels[geom.form]
        occ = _occupancy(built, f"{kname}<Lb1ELb{int(bf)}>", geom)
        print(f"cim_mvm_grouped_folded {regime} (layer 0 gate, read seed "
              f"{seed}) E={E} {I}x{N} cap {cap}: {rows} rows on {hit} "
              f"experts, {form} form, max_abs_err {err:.3e} (general form "
              f"{general_err:.3e}; tol {CIM_TOL:g} x max|y| {ref:.3e}, rows "
              f"no expert computes 0, two calls bit-identical) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms cold "
              f"({clean_ms:.4f} without the noise; the first, general form "
              f"forced {general_ms:.4f}), plain {plain_ms:.4f} ms, bmm on "
              f"W_eff {lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}; "
              f"{n_bytes / 1e6:.1f} MB; {100 * b_ms / ms:.1f}% of it); grid "
              f"{geom.gx}x{geom.gy}x{geom.gz}"
              f"{f' in clusters of {geom.gy}' if geom.gy > 1 and form != 'general' else ''}, "
              f"{_occ_text(occ)}, {occ['spill_bytes']} B spilled")
        if not ok:
            raise AssertionError(f"cim_mvm_grouped_folded disagrees "
                                 f"({regime})")
        regimes[regime] = dict(rows=rows, hit=hit, cap=cap, form=form,
                               max_abs_err=err, ms=ms,
                               ms_without_noise=clean_ms,
                               general_ms=general_ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by,
                               library_ms=lib_ms,
                               registers=occ["registers"],
                               spill_bytes=occ["spill_bytes"],
                               blocks_per_sm=occ["blocks_per_sm"],
                               clusters=occ["clusters"])
    top = regimes["decode"]
    return dict(name="cim_mvm_grouped_folded", route="cuda",
                source="src/repro_torch/kernels/cim_mvm/kernel.cu",
                replaces="src/repro/kernels/cim_mvm/kernel.py:82",
                vmapped_at="src/repro/models/moe.py:50-61",
                max_abs_err=max(r["max_abs_err"] for r in regimes.values()),
                **{k: top[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
                regimes=regimes)


def _forced_demotion(eng, seed: int) -> None:
    """Layer 0's moe_ffn with its two most-hit experts of a random f32
    input marked degraded in every bank (served digitally in f32), on
    f32 activations: the kernel path against the plain path (which reads
    no fold) at MOE_FFN_TOL x max|y|, and the demotion moving y."""
    from repro_torch.models.model import KERNELS
    from repro_torch.models.moe import _route, moe_ffn

    cfg = eng.cfg.replace(dtype="float32")
    p = {k: v[0].float() for k, v in eng.params["slot0_attn"].items()}
    x = torch.randn((B, PROMPT, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    _, _, idx = _route((x @ p["ffn_router"]).float(),
                       cfg.n_experts_per_token)
    hits = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    two = hits.topk(2).indices.tolist()
    plain = _plain_ops()

    def layer(demote):
        out = {}
        for k, d in eng.cim["slot0_attn"].items():
            d = d.layer(0)
            if k.startswith("ffn_we") and demote:
                deg = d.degraded.clone()
                deg[two] = 5
                view = dataclasses.replace(d, degraded=deg)
                view.folded, view.device_tags = d.folded, d.device_tags
                d = view
            out[k] = d
        return out

    ys, errs = {}, []
    for demote in (False, True):
        c = layer(demote)
        yk, _ = moe_ffn(p, x, cfg, KERNELS.grouped, cim=c, read_seed=seed)
        yp, _ = moe_ffn(p, x, cfg, plain.grouped, cim=c, read_seed=seed)
        err = (yk - yp).abs().max().item()
        ref = yp.abs().max().item()
        ys[demote] = yk
        errs.append(err)
        print(f"  forced demotion ({'experts ' + str(two) + ' demoted' if demote else 'none'}"
              f"; layer 0 moe_ffn, f32, {B}x{PROMPT} tokens, read seed "
              f"{seed}): kernel vs plain path max_abs_err {err:.3e} "
              f"({err / ref:.3e} of max|y| {ref:.3e}), tol {MOE_FFN_TOL:g} "
              f"{'ok' if err <= MOE_FFN_TOL * ref else 'FAIL'}")
        if err > MOE_FFN_TOL * ref:
            raise AssertionError("moe_ffn kernel path disagrees with the "
                                 "plain path (forced demotion)")
    moved = (ys[True] - ys[False]).abs().max().item()
    print(f"  the demotion of experts {two} ({hits[two].tolist()} rows) moves "
          f"y by {moved:.3e} (10x the paths' largest difference: "
          f"{10 * max(errs):.3e})")
    if moved <= 10 * max(errs) or moved == 0.0:
        raise AssertionError("the forced demotion did not change y beyond "
                             "the kernel's error")


def phase_moe_nonideal(records: list, built: dict) -> dict:
    """qwen2-moe-a2.7b at full width and MOE_NONIDEAL_LAYERS layers in
    bf16, random weights from seed 0, on imperfect devices (NONIDEAL
    without line opens, NONIDEAL_SEED) under MOE_NONIDEAL_PIPELINE,
    through ``ServeEngine`` with no plan cache (the deploy's stages
    timed): every expert bank folded at deploy and read by cim_mvm's
    grouped folded forms with read noise (the decode form at a decode
    step's capacity, the prefill form at the prefill's), the attention
    projections by its folded forms.  Then every served matrix's fold bit for bit
    against its plain version, two generate calls bit-identical, every
    kernel call of a teacher-forced pass (prefill and MOE_TF_STEPS decode
    steps) against its plain version, the first MOE_F32_LAYERS layers
    with f32 activations end to end against the plain path, a forced
    demotion, and the grouped folded forms' record."""
    from repro_torch.configs import CimConfig
    from repro_torch.configs.qwen2_moe_a27b import CONFIG as QWEN
    from repro_torch.kernels import runtime
    from repro_torch.kernels.cim_mvm.ref import folded_weights
    from repro_torch.models.model import init_params
    from repro_torch.nonideal import NonidealModel
    from repro_torch.serve import ServeEngine

    cfg = QWEN.replace(n_layers=MOE_NONIDEAL_LAYERS,
                       cim=CimConfig(enabled=True, mode="mdm_expert"))
    model = NonidealModel(**{k: v for k, v in NONIDEAL.items()
                             if not k.startswith("p_open")})
    E, L = cfg.n_experts, cfg.n_layers
    n_exp = 3 * L * E * cfg.d_model * cfg.moe_d_ff
    per = {"codes": 2, "pos": 0.5, "gain": 4, "col_pos": 0.5, "folded": 4}
    print(f"  reckoned before the deploy: {n_exp / 1e9:.3f} G expert weights "
          f"x {sum(per.values())} B = {n_exp * sum(per.values()) / 1e9:.1f} GB "
          f"({ {f: round(n_exp * b / 1e9, 2) for f, b in per.items()} } GB); "
          f"24 layers would be {3 * n_exp * sum(per.values()) / 1e9:.0f} GB")
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, plan_cache=False,
                      nonideal=model, nonideal_seed=NONIDEAL_SEED,
                      pipeline=MOE_NONIDEAL_PIPELINE, timed_deploy=True,
                      device="cuda")
    torch.cuda.synchronize()
    t_deploy = time.perf_counter() - t0
    rep = eng.deploy_report
    n_mats = rep["n_matrices"]
    print(f"phase deploy (qwen2-moe-nonideal): {cfg.dtype}, {L} of 24 layers, "
          f"{model}, seed {NONIDEAL_SEED}, pipeline {MOE_NONIDEAL_PIPELINE}: "
          f"{t_deploy:.2f} s uncached (by stage "
          f"{ {k: round(v, 3) for k, v in rep['seconds'].items()} }): "
          f"{n_mats} matrices, {rep['tiles']} tiles, {rep['stuck_cells']} "
          f"stuck cells, n_degraded {rep['n_degraded']}, fault-aware "
          f"{rep['fault_aware']}, NF reduction {100 * rep['nf_reduction']:.3f}%")
    fields = _bank_fields(eng)
    param_gb = sum(t.numel() * t.element_size() for t in _leaves(params))
    for part, fb in fields.items():
        print(f"  {part} bank {sum(fb.values()) / 1e9:.2f} GB "
              f"({ {f: round(n / 1e9, 3) for f, n in fb.items()} })")
    print(f"  params {param_gb / 1e9:.2f} GB; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}")

    n_folds = 0
    with _Uncounted():
        for deps in eng.cim.values():
            for d in deps.values():
                lead = d.scale.shape
                for idx in itertools.product(*map(range, lead)):
                    view = d
                    for i in idx:
                        view = view.layer(i)
                    if int(view.degraded):
                        continue
                    if view.folded is None or not torch.equal(
                            view.folded, folded_weights(view)):
                        raise AssertionError(f"a served matrix's fold "
                                             f"differs from its plain "
                                             f"version {idx}")
                    n_folds += 1
    if n_folds != n_mats - rep["n_degraded"]:
        raise AssertionError(f"{n_folds} folds != {n_mats} matrices less "
                             f"{rep['n_degraded']} degraded")
    print(f"  the fold of every served matrix ({n_folds}: "
          f"{n_folds - 4 * L} experts, {4 * L} attention) bit-identical to "
          f"its plain version on the devices' state")

    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                            generator=torch.Generator().manual_seed(1))
    eng.generate(prompts, 2)                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, NEW)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    step = (t_all - t_prefill) / (NEW - 1)
    print(f"phase serve (qwen2-moe-nonideal): B={B} prompt {PROMPT} new {NEW}, "
          f"read noise armed: prefill {t_prefill * 1e3:.1f} ms, decode "
          f"{step * 1e3:.2f} ms/step, {B * NEW / t_all:.1f} tokens/s (peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB)")
    counts = _launches("qwen2-moe-nonideal")
    forwards = 2 + 1 + NEW
    live = n_mats - rep["n_degraded"]
    if counts["cim_mvm_grouped_folded"] != 3 * L * forwards \
            or counts["cim_mvm_grouped"] != 0 \
            or counts["cim_mvm"] != 4 * L * forwards \
            or counts["cim_fold"] != live:
        raise AssertionError(f"launches {counts} != 3 grouped folded and 4 "
                             f"cim_mvm a layer x {forwards} forwards, "
                             f"{live} folds")
    print(f"  cim_mvm_grouped_folded {counts['cim_mvm_grouped_folded']} "
          f"launches = 3 expert banks x {L} layers x {forwards} forwards; "
          f"cim_mvm {counts['cim_mvm']} = 4 attention projections x {L} x "
          f"{forwards} (folded forms, read noise); cim_fold "
          f"{counts['cim_fold']} = one a served matrix, at deploy")
    phase_profile(eng, prompts, step * 1e3)
    if not torch.equal(eng.generate(prompts, NEW), tokens):
        raise AssertionError("two generate calls with the same sampling "
                             "and read seeds gave different tokens")
    print(f"  two generate calls (sampling seed 0, read seeds of nonideal "
          f"seed {NONIDEAL_SEED}): tokens bit-identical ({tokens.numel()})")

    _, _, fw = _routing_stats(eng, prompts)
    records.append(_grouped_folded_record(eng, fw, built))
    del fw
    seq = torch.cat([prompts.cuda(), tokens.long()], 1)[:, :PROMPT + MOE_TF_STEPS]
    lk = _check_calls(eng, seq, "qwen2-moe-nonideal", seed=5)
    if not (torch.isfinite(lk).all()
            and lk.shape == (B, MOE_TF_STEPS + 1, cfg.padded_vocab)):
        raise AssertionError("non-finite or misshapen logits")
    del lk
    _forced_demotion(eng, 5)

    # f32 activations at a depth cut: the bf16 params are freed first.
    twin = _moe_f32_twin(eng, MOE_F32_LAYERS)
    eng.params = None
    del params
    gc.collect()
    torch.cuda.empty_cache()
    plain = copy.copy(twin)
    plain.ops = _plain_ops()
    seq = torch.cat([prompts.cuda(), tokens.long()], 1)[
        :, :PROMPT + MOE_F32_NEW - 1]
    V = cfg.vocab_size
    lk = twin.teacher_forced_logits(seq, PROMPT, seed=5)[..., :V]
    lp = plain.teacher_forced_logits(seq, PROMPT, seed=5)[..., :V]
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    top2 = lp.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    flips = lk.argmax(-1) != lp.argmax(-1)
    ok = err <= LOGIT_TOL * ref and bool((gap[flips] <= 2 * err).all())
    print(f"  f32 activations, first {MOE_F32_LAYERS} of {L} layers (same "
          f"bank, read seed 5): teacher-forced logits ({lk.shape[1]} steps) "
          f"max_abs_err {err:.3e} ({err / ref:.3e} of max|logit| {ref:.3e}), "
          f"tol {LOGIT_TOL:g} x max; argmax differs at {int(flips.sum())} of "
          f"{flips.numel()} (plain top-2 gaps {gap[flips].tolist()[:8]}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("f32 kernel-path logits disagree with the "
                             "plain path (qwen2-moe-nonideal)")
    del twin, plain, eng, lk, lp
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32} (yardsticks in full f32)")
    t_start = time.perf_counter()
    card = phase_card()
    built = phase_build()
    records = phase_kernels(built)
    # Plan caches live in fresh directories under TMPDIR, so every
    # deploy here starts cold and nothing outlives the run.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plans_") as tmp:
        phase_paths(records, built, tmp, card)
    bad = [m for m in ("jax", "repro", "ml_dtypes") if m in sys.modules]
    if bad:
        raise AssertionError(f"the port imported {bad}")
    print(f"card {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_paths(records: list[dict], built: dict, tmp: str,
                card: str) -> None:
    """Drive every path, each with the launch counts set to 0 just
    before it and read just after; record each kernel's launches."""
    from repro_torch.configs import CimConfig
    from repro_torch.configs.phi3_mini_38b import CONFIG as PHI3
    from repro_torch.configs.xlstm_13b import CONFIG as XLSTM

    cim = CimConfig(enabled=True, mode="mdm")
    by_path: dict = {}
    cfg = PHI3.replace(dtype="float32", cim=cim)
    print(f"config {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}); no depth cut")
    eng, prompts, tokens, counts, uncached_s = phase_serve(
        "phi3", cfg, os.path.join(tmp, "phi3"))
    by_path["phi3"] = counts
    by_path["phi3-continuous"] = phase_continuous(
        cfg, eng.params, eng, os.path.join(tmp, "phi3-continuous"),
        uncached_s)
    for d in ("phi3", "phi3-continuous"):
        shutil.rmtree(os.path.join(tmp, d))
    phase_plans(eng, [("slot0_attn", "wq"), ("slot0_attn", "ffn_w_gate"),
                      ("slot0_attn", "ffn_w_down")])
    phase_layer_deploy(eng)
    phase_compare(eng, prompts, tokens)
    rec, counts = phase_export(eng)
    records.append(rec)
    by_path["export"] = counts
    w_gate = eng.params["slot0_attn"]["ffn_w_gate"][0].clone()
    del eng, prompts, tokens
    gc.collect()
    torch.cuda.empty_cache()
    rec, by_path["phi3-circuit"] = phase_circuit(w_gate, built, card)
    records.append(rec)
    del w_gate

    cfg = PHI3.replace(cim=cim)
    print(f"config {cfg.name} ({cfg.dtype}, its CONFIG dtype): imperfect "
          f"devices; no depth cut")
    by_path["phi3-nonideal"] = phase_nonideal(
        cfg, os.path.join(tmp, "phi3-nonideal"))
    shutil.rmtree(os.path.join(tmp, "phi3-nonideal"), ignore_errors=True)
    print(f"config {cfg.name} ({cfg.dtype}): ageing and self-healing; no "
          f"depth cut")
    by_path["phi3-health"] = phase_health(cfg, built, records)

    cfg = XLSTM.replace(cim=cim)
    print(f"config {cfg.name} ({cfg.dtype}): {cfg.n_layers} layers "
          f"{cfg.block_pattern} x {cfg.pattern_repeats}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}, mLSTM inner "
          f"{cfg.d_model * cfg.ssm_expand}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}); no depth cut")
    eng, prompts, tokens, counts, _ = phase_serve(
        "xlstm", cfg, os.path.join(tmp, "xlstm"))
    by_path["xlstm"] = counts
    phase_plans(eng, [("slot0_mlstm", "wq")])
    phase_compare(eng, prompts, tokens)
    del eng, prompts, tokens
    gc.collect()
    torch.cuda.empty_cache()

    print("config qwen2-moe-a2.7b: MoE serving, alone on the card")
    by_path["qwen2-moe"] = phase_moe(records, built, card)
    print(f"config qwen2-moe-a2.7b on imperfect devices, {MOE_NONIDEAL_LAYERS} "
          f"of 24 layers, alone on the card")
    by_path["qwen2-moe-nonideal"] = phase_moe_nonideal(records, built)
    for r in records:
        name = r["name"]
        kernel = name.split("[")[0]
        paths = RECORD_PATHS.get(name, NONIDEAL_PATHS)
        r["launches"] = sum(by_path[p][kernel] for p in paths)
        r["launches_by_path"] = {p: by_path[p][kernel] for p in paths
                                 if by_path[p][kernel]}


if __name__ == "__main__":
    sys.exit(main())
