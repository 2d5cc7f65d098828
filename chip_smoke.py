#!/usr/bin/env python3
"""Drive the PyTorch port's MDM serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from the sources in this
checkout, holds each kernel against its plain PyTorch version at the
shapes of full-width phi3-mini, then drives the main path through the
entry points a user calls: random full-width phi3-mini weights (seed 0,
f32, all 32 layers), ``ServeEngine`` with ``cim.enabled`` (quantise,
MDM-plan and package every projection on the card) and greedy
generation for a batch of prompts.  It checks the plans built on the
card against the port's CPU mirror, the kernel path's logits and tokens
against the plain path, and that every kernel of the path was launched.

Every phase prints its result; any failure raises and exits non-zero.
The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
of JAX.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# f32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

B, PROMPT, NEW = 4, 128, 32          # requests served in the main path
MAX_SEQ = PROMPT + NEW
CIM_TOL = 1e-5       # max|kernel - plain| <= CIM_TOL * max|plain|
FLASH_TOL = 2e-5     # |kernel - plain| <= FLASH_TOL * (1 + |plain|)
LOGIT_TOL = 1e-3     # max|kernel - plain| logits <= LOGIT_TOL * max|plain|


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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
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


def phase_build():
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    runtime.library()
    dt = time.perf_counter() - t0
    info = runtime.build_info()
    print(f"phase build: {'built' if info['built'] else 'loaded'} "
          f"{os.path.relpath(info['path'], ROOT)} in {dt:.1f} s "
          "(nvcc sm_90a, one process per source)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())


def _deploy_random(I: int, N: int, seed: int):
    from repro_torch.configs.phi3_mini_38b import CONFIG
    from repro_torch.deploy import spec_from_config
    from repro_torch.kernels.cim_mvm import deploy

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((I, N), generator=g, device="cuda") * 0.02
    cfg = CONFIG.replace(dtype="float32")
    dep, plan = deploy(w, spec_from_config(cfg), "mdm", eta=cfg.cim.eta)
    return dep, plan


def phase_kernels() -> list[dict]:
    """Each kernel against its plain version at the slice's shapes."""
    from repro_torch.kernels.cim_mvm.ops import cim_mvm
    from repro_torch.kernels.cim_mvm.ref import (
        cim_effective_weights,
        cim_mvm_plain,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        EMPTY_POS,
        flash_attention_plain,
    )
    from repro_torch.kernels.manhattan_score.ops import manhattan_score
    from repro_torch.kernels.manhattan_score.ref import manhattan_score_plain
    from repro_torch.core.bitslice import codes_to_bits, quantize_magnitude
    from repro_torch.core.tiling import CrossbarSpec, tile_masks

    records = []
    g = torch.Generator(device="cuda").manual_seed(1)

    # cim_mvm: the three matrix shapes x (decode M=1, M=B, prefill B*S).
    rep = None
    for (I, N) in ((3072, 3072), (3072, 8192), (8192, 3072)):
        dep, _ = _deploy_random(I, N, seed=I + N)
        w_eff = cim_effective_weights(
            dep.codes, dep.pos, dep.scale, n_bits=dep.n_bits, wpt=dep.wpt,
            cols=dep.cols, eta=dep.eta, reversed_df=dep.reversed_df)
        for M in (1, B, B * PROMPT):
            x = torch.randn((M, I), generator=g, device="cuda")
            y_k = cim_mvm(x, dep)
            y_p = cim_mvm_plain(x, dep)
            torch.cuda.synchronize()
            err = (y_k - y_p).abs().max().item()
            ref = y_p.abs().max().item()
            ok = err <= CIM_TOL * ref
            ms = cuda_ms(lambda: cim_mvm(x, dep))
            plain_ms = cuda_ms(lambda: cim_mvm_plain(x, dep), iters=5)
            lib_ms = cuda_ms(lambda: x @ w_eff)
            n_bytes = (x.numel() * 4 + dep.codes.numel() * 2
                       + dep.pos.numel() * 4 + 4 + M * N * 4)
            b_ms, b_by = bound(n_bytes, 2.0 * M * I * N)
            print(f"cim_mvm M={M:4d} I={I} N={N}: max_abs_err {err:.3e} "
                  f"(tol {CIM_TOL:g} x max|y| {ref:.3e}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, matmul on W' {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})")
            if not ok:
                raise AssertionError(f"cim_mvm disagrees at M={M} I={I} N={N}")
            if (M, I, N) == (B, 3072, 8192):
                rep = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        del dep, w_eff
    records.append(dict(
        name="cim_mvm", route="cuda",
        source="src/repro_torch/kernels/cim_mvm/kernel.cu",
        replaces="src/repro/kernels/cim_mvm/kernel.py:82", **rep))

    # flash attention: prefill (Sq = 128) and decode (Sq = 1), Dh = 96,
    # against a MAX_SEQ-long cache whose unwritten slots hold EMPTY_POS.
    H, Dh = 32, 96
    k = torch.randn((B, MAX_SEQ, H, Dh), generator=g, device="cuda")
    v = torch.randn((B, MAX_SEQ, H, Dh), generator=g, device="cuda")
    rep = None
    for name, Sq, filled in (("prefill", PROMPT, PROMPT),
                             ("decode", 1, MAX_SEQ - 1)):
        q = torch.randn((B, Sq, H, Dh), generator=g, device="cuda")
        kpos = torch.full((MAX_SEQ,), EMPTY_POS, dtype=torch.int32,
                          device="cuda")
        kpos[:filled] = torch.arange(filled, dtype=torch.int32)
        qpos = torch.arange(filled - Sq, filled, dtype=torch.int32,
                            device="cuda")
        o_k = flash_attention(q, k, v, q_positions=qpos, k_positions=kpos)
        o_p = flash_attention_plain(q, k, v, qpos, kpos)
        torch.cuda.synchronize()
        err = (o_k - o_p).abs().max().item()
        excess = ((o_k - o_p).abs() - FLASH_TOL * (1 + o_p.abs())).max()
        ok = excess.item() <= 0
        ms = cuda_ms(lambda: flash_attention(q, k, v, q_positions=qpos,
                                             k_positions=kpos))
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, qpos, kpos))
        mask = (kpos[None, :] <= qpos[:, None])
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask))
        pairs = int(mask.sum().item()) * B * H
        n_bytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 4 \
            + (qpos.numel() + kpos.numel()) * 4
        b_ms, b_by = bound(n_bytes, pairs * 4.0 * Dh)
        print(f"flash {name} B={B} Sq={Sq} C={MAX_SEQ} H={H} Dh={Dh}: "
              f"max_abs_err {err:.3e} (tol {FLASH_TOL:g}(1+|ref|)) "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        if not ok:
            raise AssertionError(f"flash attention disagrees ({name})")
        if name == "prefill":
            rep = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    records.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/kernel.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:75", **rep))

    # manhattan_score: one full 3072 x 8192 matrix's tile population.
    spec = CrossbarSpec(64, 64, 8)
    w = torch.randn((3072, 8192), generator=g, device="cuda") * 0.02
    codes, _, _ = quantize_magnitude(w, spec.n_bits)
    masks = tile_masks(codes_to_bits(codes, spec.n_bits), spec)
    masks = masks.reshape(-1, spec.rows, spec.cols).contiguous()
    T = masks.shape[0]
    perm = torch.argsort(torch.rand((T, 64), generator=g, device="cuda"), -1)
    position = torch.empty_like(perm).scatter_(
        -1, perm, torch.arange(64, device="cuda").expand(T, 64)).to(torch.int32)
    err = 0.0
    for rev, rp in ((False, None), (True, None), (True, position)):
        got = manhattan_score(masks, spec.nf_unit, reverse=rev, row_position=rp)
        want = manhattan_score_plain(masks, spec.nf_unit, rev, rp)
        for a, b in zip(got, want):
            err = max(err, (a - b).abs().max().item())
    ok = err == 0.0
    ms = cuda_ms(lambda: manhattan_score(masks, spec.nf_unit))
    plain_ms = cuda_ms(lambda: manhattan_score_plain(masks, spec.nf_unit))
    n_bytes = masks.numel() + T * 64 * 4 * 2 + T * 4
    b_ms, b_by = bound(n_bytes, 3.0 * masks.numel())
    print(f"manhattan_score T={T} 64x64: max_abs_err {err:.3e} (exact, "
          f"three variants) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not ok:
        raise AssertionError("manhattan_score disagrees")
    records.append(dict(
        name="manhattan_score", route="cuda",
        source="src/repro_torch/kernels/manhattan_score/kernel.cu",
        replaces="src/repro/kernels/manhattan_score/kernel.py:34",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None))
    return records


def phase_main_path():
    """Init, deploy and serve full-width phi3-mini through the kernels."""
    from repro_torch.configs import CimConfig
    from repro_torch.configs.phi3_mini_38b import CONFIG
    from repro_torch.kernels import runtime
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeEngine

    cfg = CONFIG.replace(dtype="float32", cim=CimConfig(enabled=True,
                                                        mode="mdm"))
    print(f"config {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}); no depth cut")
    runtime.reset_launch_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rep = eng.deploy_report
    print(f"phase deploy: init {t1 - t0:.2f} s, deploy {t2 - t1:.2f} s: "
          f"{rep['n_matrices']} matrices, {rep['tiles_planned']} tiles, "
          f"mean NF reduction {100 * rep['nf_reduction']:.3f}% "
          f"(NF {rep['nf_before']:.6g} -> {rep['nf_after']:.6g})")

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
    print(f"phase serve: B={B} prompt {PROMPT} new {NEW}: prefill "
          f"{t_prefill * 1e3:.1f} ms, decode {step * 1e3:.2f} ms/step, "
          f"{B * NEW / t_all:.1f} tokens/s "
          f"(peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
    counts = runtime.launch_counts()
    print(f"main-path launches: {counts}")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if not torch.isfinite(eng.teacher_forced_logits(
            torch.cat([prompts.cuda(), tokens.long()], 1)[:, :PROMPT + 1],
            PROMPT)).all():
        raise AssertionError("non-finite logits")
    phase_profile(eng, prompts, step * 1e3)
    return cfg, eng, prompts, tokens, counts


def phase_profile(eng, prompts, step_ms: float, steps: int = 3):
    """Device time by kernel over a few decode steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import apply_model, init_decode_state

    cfg = eng.cfg
    state = init_decode_state(cfg, B, MAX_SEQ, "cuda")
    logits, state = apply_model(eng.params, cfg, prompts.cuda(), state=state,
                                cim=eng.cim)
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state = apply_model(eng.params, cfg, tok, state=state,
                                        cim=eng.cim)
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
        return
    print(f"phase profile ({steps} decode steps): device busy {busy:.2f} ms "
          f"of a {step_ms:.2f} ms step (unprofiled) -> idle share "
          f"{100 * max(0.0, 1 - busy / step_ms):.1f}%")
    for ms, n, key in rows[:8]:
        print(f"  {ms:8.3f} ms/step {n:5d} launches/step  {key[:70]}")


def phase_plans(cfg, eng):
    """Plans built on the card vs the port's CPU mirror, bit for bit."""
    import numpy as np

    from repro_torch.core.bitslice import magnitude_scale_host
    from repro_torch.deploy import plan_matrix, quantize_codes_host
    from repro_torch.deploy import spec_from_config

    spec = spec_from_config(cfg)
    slot = eng.params["slot0_attn"]
    for name, w in (("wq", slot["wq"][0].reshape(cfg.d_model, -1)),
                    ("ffn_w_gate", slot["ffn_w_gate"][0]),
                    ("ffn_w_down", slot["ffn_w_down"][0])):
        gpu = plan_matrix(w, spec, cfg.cim.mode)
        cpu = plan_matrix(w.cpu(), spec, cfg.cim.mode)
        for a, b in zip(gpu[0], cpu[0]):
            if isinstance(a, torch.Tensor) and not torch.equal(a.cpu(), b):
                raise AssertionError(f"{name}: card plan != CPU plan")
        w_np = w.cpu().numpy()
        scale = magnitude_scale_host(w_np, spec.n_bits)
        host_codes = quantize_codes_host(w_np, scale, spec.n_bits)
        if not (np.array_equal(gpu[1].cpu().numpy(), host_codes)
                and gpu[3].cpu().numpy().tobytes() == scale.tobytes()):
            raise AssertionError(f"{name}: card codes/scale != numpy mirror")
        dep = eng.cim["slot0_attn"][name].layer(0)
        I, N = w.shape
        if not torch.equal(dep.codes[:I, :N].abs().to(torch.int32), gpu[1]):
            raise AssertionError(f"{name}: packaged codes != planned codes")
        plan = gpu[0]
        red = 1 - plan.nf_after.sum().item() / plan.nf_before.sum().item()
        print(f"plan {name} {I}x{N}: {plan.nf_before.numel()} tiles, card == "
              f"CPU mirror (row_perm, row_position, nf_before, nf_after, "
              f"scale, codes); NF reduction {100 * red:.3f}%")


def phase_compare(eng, prompts, tokens):
    """Kernel path vs plain path: teacher-forced logits, greedy tokens."""
    from repro_torch.models.model import PLAIN

    plain_eng = copy.copy(eng)           # same params and deployments
    plain_eng.ops = PLAIN
    seq = torch.cat([prompts.cuda(), tokens.long()], 1)[:, :PROMPT + NEW - 1]
    V = eng.cfg.vocab_size       # padded columns sit at -1e9; left out
    lk = eng.teacher_forced_logits(seq, PROMPT)[..., :V]
    lp = plain_eng.teacher_forced_logits(seq, PROMPT)[..., :V]
    err = (lk - lp).abs().max().item()
    ref = lp.abs().max().item()
    ok = err <= LOGIT_TOL * ref
    print(f"teacher-forced logits ({lk.shape[1]} steps): max_abs_err "
          f"{err:.3e}, max|logit| {ref:.3e} (tol {LOGIT_TOL:g} x max) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    records = phase_kernels()
    cfg, eng, prompts, tokens, counts = phase_main_path()
    phase_plans(cfg, eng)
    phase_compare(eng, prompts, tokens)
    for r in records:
        r["launches"] = counts[r["name"]]
    if "jax" in sys.modules or "repro" in sys.modules:
        raise AssertionError("the port imported jax or repro")
    print(f"card {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
