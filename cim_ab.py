#!/usr/bin/env python3
"""Time cim_mvm's, flash_attention's or slstm_scan's forms in one
checkout of the port.

    python3 cim_ab.py [--src DIR] [--label NAME] [--flash | --batched |
                      --grouped [--forms] [--folded] |
                      --slstm [--forms] [--serve]]

Imports ``repro_torch`` from ``DIR`` (default: the ``src`` beside this
script), builds its kernels there and times its public ``cim_mvm`` on
one CUDA card with ``chip_smoke.device_ms`` (decode rows cold, rotating
over copies of the deployment larger than ``chip_smoke.COLD_BYTES``):

* the ideal forms, x f32: 3072x8192 at M = 4, 128 and 512, 8192x3072 at
  M = 128;
* the nonideal forms, x bf16, on ``chip_smoke._nonideal_dep``'s
  deployment with a gain, the X-CHANGR bitline permutation and read
  noise: 3072x8192 and 8192x3072 at M = 4, 128 and 512, folded where the
  checkout has ``ops.fold``.

With ``--flash`` it times the public ``flash_attention`` instead, f32
and bf16, at ``chip_smoke._flash_cases``'s shapes (the bf16 forms also
at the long-cache decode), and adds the checkout's flash kernels'
registers, spills, SASS and tensor-core counts (``chip_smoke.phase_build``).

With ``--batched`` it times the public ``cim_mvm_batched`` at a phi3
probe round's group shapes (G = 32 members, M = 16 f32 probes): 3072x3072
(wq, wk, wv, wo), 3072x8192 (ffn_w_gate, ffn_w_up), 8192x3072
(ffn_w_down), each on a stack of 32 folds of ``chip_smoke._nonideal_dep``'s
deployment (``stack_deployments``, noise tag g for member g), with and
without read noise, beside ``torch.bmm`` on the materialised W_eff and
the byte bound (every member's fold read once); ``round`` sums the
round's seven launches (4, 2 and 1 of the three shapes); plus the
checkout's batched kernels as its build reports them.

With ``--grouped`` it times the public ``cim_mvm_grouped`` at
qwen2-moe-a2.7b's expert banks (E = 60 random experts deployed under
MDM, codes of 2048x1408 for the gate and 1408x2048 for the down
product, bf16 x) in the routings of a serving run: a decode step (16
rows on 14 experts, cap 16), a continuous decode step
(``ContinuousEngine(capacity=8)`` x top-4: 32 rows, cap 32), a prefill
(2,048 rows on 60 experts, cap 128), one expert at 128 rows, and one
expert at the capacity beside 59 partly filled (chip_smoke's forced
routings).  Cold: each call reads another of two copies of the bank
(the decode calls' hit experts alone pass ``chip_smoke.COLD_BYTES``
over the two).  Beside each time: its byte bound (every hit expert's
codes, pos and scale, x, y and the offsets once), its TF32 bound (2
products a product with bf16 x), ``torch.bmm`` of the (E, cap, I)
capacity buffer on the materialised f32 (E, I, N) W' (the yardstick
only), the kernel's max error against ``cim_mvm_grouped_plain`` over
max|plain|, and the form its geometry took.  ``--forms`` also times each
case with the decode form's capacity threshold forced to 0 and to
1,000,000 (every call on the prefill form, or on the decode form), for
a checkout that has the threshold.  For a checkout with the grouped
folded form (``ops.grouped_folded_geometry``) each case is also timed on
a folded bank of the same codes (expert e with a log-normal gain,
sigma_read 0.01 and tag e, folded by ``ops.fold``), without and with
read noise (keys ``[folded]``, ``[folded, noise]``; ``folded_bound_ms``
reads every hit expert's fold once; ``folded_form`` the form its
geometry took); with ``--forms`` also forced onto each grouped folded
form, for a checkout whose ``cim_mvm_grouped`` takes ``form`` (keys
``[folded, ...] [general]``, ``[decode]``, ``[prefill]``).  ``--folded``
times the folded banks only (no ideal bank, no ``torch.bmm``).

With ``--slstm`` it times the public ``slstm_scan`` at xlstm-1.3b's
sLSTM shape (B = 4 lanes, H = 4, Dh = 512, bf16 gx and R, f32 state,
random from seed 0) at T = 128 (a prefill), 64 and 1 (a decode step),
warm and cold (each call on another of enough copies of R to pass
``chip_smoke.COLD_BYTES``), with the max error against that checkout's
``slstm_scan_plain``, the step (the slope of T = 128 over T = 64) and
the checkout's slstm kernels as its build reports them; ``--forms``
also times each of its forms forced at each T it takes, for a checkout
whose ``slstm_scan`` takes ``form`` (keys ``slstm[<form>] ...``).
``--serve`` also serves xlstm-1.3b at full width and depth (bf16, random
weights from seed 0, ``ServeEngine`` with ``chip_smoke``'s CIM config
and a fresh plan cache) to B = 4 prompts of 128 tokens: the prefill's
ms (median of 3), a decode step's ms (over 8 steps), and, under
``torch.profiler`` over 3 decode steps, the card's busy ms a step and
the slstm kernels' ms a step (keys ``xlstm ...``).

Prints one JSON line.  Run it for two checkouts in one call (parent,
change, change, parent) to compare them on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

import inspect
import itertools

import numpy as np

from chip_smoke import (COLD_BYTES, PEAK_BYTES, PEAK_TF32, _flash_cases,
                        _nonideal_dep, bound, device_ms, phase_build)


def copies(dep, nbytes: int) -> list:
    """``dep`` and enough copies of it to exceed COLD_BYTES together."""
    out = [dep]
    for _ in range(max(2, -(-COLD_BYTES // nbytes)) - 1):
        c = dataclasses.replace(dep, **{
            f: getattr(dep, f).clone() for f in ("codes", "pos", "scale",
                                                 "gain", "col_pos")
            if getattr(dep, f) is not None})
        if getattr(dep, "folded", None) is not None:
            c.folded = dep.folded.clone()
        out.append(c)
    return out


def time_flash(out: dict) -> None:
    """flash_attention's forms at the flash checks' shapes, f32 and bf16
    (H = 32, Dh = 96, random q, k, v from seed 0), and the checkout's
    flash kernels as its build reports them."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    built = phase_build()
    out["kernels"] = {k: v for k, v in built.items() if "flash" in k}
    g = torch.Generator(device="cuda").manual_seed(0)
    H, Dh = 32, 96
    for dtype in (torch.float32, torch.bfloat16):
        bf = dtype == torch.bfloat16
        for name, Bq, Sq, C, qpos, kpos in _flash_cases(long=bf):
            q, k, v = (torch.randn((Bq, S, H, Dh), generator=g,
                                   device="cuda").to(dtype)
                       for S in (Sq, C, C))
            out["ms"][f"flash{'[bf16]' if bf else ''} {name}"] = device_ms(
                lambda: flash_attention(q, k, v, q_positions=qpos,
                                        k_positions=kpos))


def time_slstm(out: dict, forms: bool) -> None:
    """slstm_scan at xlstm-1.3b's sLSTM shape (module docstring)."""
    from repro_torch.kernels.slstm_scan import ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_plain

    built = phase_build()
    out["kernels"] = {k: v for k, v in built.items() if "slstm" in k}
    out["err"] = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, Dh = 4, 4, 512
    r = (torch.randn((H, Dh, 4 * Dh), generator=g, device="cuda")
         * 0.02).to(torch.bfloat16)
    rs = [r] + [r.clone() for _ in range(
        max(2, -(-COLD_BYTES // (r.numel() * 2))) - 1)]
    h0, c0 = (torch.randn((B, H, Dh), generator=g, device="cuda") * 0.1
              for _ in range(2))
    takes_form = "form" in inspect.signature(ops.slstm_scan).parameters
    variants = [("", {})]
    if forms and takes_form:
        variants += [(f"[{f}]", {"form": f}) for f in ops.FORMS]
    for T in (128, 64, 1):
        gx = (torch.randn((B, T, H, 4 * Dh), generator=g, device="cuda")
              * 0.5).to(torch.bfloat16)
        want = slstm_scan_plain(gx, r, h0, c0)
        for tag, kw in variants:
            if kw.get("form") == "decode" and T > 1:
                continue
            key = f"slstm{tag} T={T}"
            got = ops.slstm_scan(gx, r, h0, c0, **kw)
            torch.cuda.synchronize()
            out["err"][key] = max((a - w).abs().max().item()
                                  for a, w in zip(got, want))
            out["ms"][key] = device_ms(
                lambda: ops.slstm_scan(gx, r, h0, c0, **kw))
            out["ms"][f"{key} cold"] = device_ms(
                lambda a: ops.slstm_scan(gx, a, h0, c0, **kw), args=rs)
    for tag, kw in variants:
        if f"slstm{tag} T=64" in out["ms"]:
            out["ms"][f"slstm{tag} step_us"] = 1e3 * (
                out["ms"][f"slstm{tag} T=128"]
                - out["ms"][f"slstm{tag} T=64"]) / 64


def serve_xlstm(out: dict) -> None:
    """xlstm-1.3b served at full width (module docstring)."""
    import tempfile
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import CimConfig
    from repro_torch.configs.xlstm_13b import CONFIG
    from repro_torch.deploy import PlanCache
    from repro_torch.models.model import (apply_model, init_decode_state,
                                          init_params)
    from repro_torch.serve import ServeEngine

    cfg = CONFIG.replace(cim=CimConfig(enabled=True, mode="mdm"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (4, 128),
                            generator=torch.Generator().manual_seed(1))

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with tempfile.TemporaryDirectory(prefix="cim_ab_plans_") as d:
        eng = ServeEngine(cfg, params, max_seq=160, plan_cache=PlanCache(d),
                          device="cuda")
        eng.generate(prompts, 2)
        pre = sorted(wall(lambda: eng.generate(prompts, 1)) for _ in range(3))
        out["ms"]["xlstm prefill"] = pre[1]
        out["ms"]["xlstm decode step"] = (
            wall(lambda: eng.generate(prompts, 9)) - pre[1]) / 8
        state = init_decode_state(cfg, 4, 160, "cuda")
        logits, state = apply_model(eng.params, cfg, prompts.to("cuda"),
                                    state=state, cim=eng.cim)
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                logits, state = apply_model(eng.params, cfg, tok, state=state,
                                            decode=True, cim=eng.cim)
                tok = logits[:, 0].argmax(-1)[:, None]
            torch.cuda.synchronize()
    busy = slstm = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total
            if "slstm_" in e.key:
                slstm += e.self_device_time_total
    out["ms"]["xlstm busy a decode step"] = busy / 3e3
    out["ms"]["xlstm slstm a decode step"] = slstm / 3e3


def time_batched(out: dict) -> None:
    """cim_mvm_batched at a probe round's group shapes (module docstring)."""
    from repro_torch.deploy.lifetime import stack_deployments
    from repro_torch.kernels.cim_mvm.ops import cim_mvm_batched
    from repro_torch.kernels.cim_mvm.ref import deployment_weights

    built = phase_build()
    out["kernels"] = {k: v for k, v in built.items() if "batched" in k}
    G, M, seed = 32, 16, 31
    reps = list(range(G))
    g = torch.Generator(device="cuda").manual_seed(1)
    out.update(bound_ms={}, err={})
    for (I, N), per_round in (((3072, 3072), 4), ((3072, 8192), 2),
                              ((8192, 3072), 1)):
        dep = _nonideal_dep(I, N, "all", I + N)
        bank = stack_deployments([dataclasses.replace(
            dep, noise_tag=torch.tensor(t, dtype=torch.int32))
            for t in reps])
        del dep
        x = torch.randn((G, M, I), generator=g, device="cuda")
        key = f"{I}x{N}"
        for s, what in ((seed, "noise"), (None, "clean")):
            out["ms"][f"batched {what} {key}"] = device_ms(
                lambda s=s: cim_mvm_batched(x, bank, s, reps))
        w_eff = torch.stack([deployment_weights(bank.layer(r), seed)
                             for r in reps])[:, :I, :N]
        out["ms"][f"bmm {key}"] = device_ms(lambda: torch.bmm(x, w_eff))
        want = torch.bmm(x, w_eff)
        out["err"][key] = ((cim_mvm_batched(x, bank, seed, reps) - want)
                           .abs().max() / want.abs().max()).item()
        n_bytes = 4 * (G * bank.folded[0].numel() + x.numel() + want.numel())
        out["bound_ms"][key] = bound(n_bytes, 0.0)[0]
        for what in ("batched noise", "batched clean", "bmm"):
            out["ms"][f"{what} round"] = out["ms"].get(
                f"{what} round", 0.0) + per_round * out["ms"][f"{what} {key}"]
        out["bound_ms"]["round"] = out["bound_ms"].get("round", 0.0) + \
            per_round * out["bound_ms"][key]
        del bank, w_eff, want


def _grouped_routings(E: int) -> list[tuple[str, list[int], int]]:
    """(name, rows an expert, cap) of the grouped cases, from seed 0."""
    rng = np.random.default_rng(0)

    def routed(T, K, cap):
        probs = rng.random((T, E)) ** 3              # uneven loads
        top = np.argsort(-probs, axis=1, kind="stable")[:, :K]
        return np.minimum(np.bincount(top.reshape(-1), minlength=E),
                          cap).tolist()

    decode = [0] * E
    for e in rng.choice(E, 14, replace=False):
        decode[e] = 1
    for e in np.nonzero(decode)[0][:2]:
        decode[e] += 1                  # 16 rows on 14 experts
    cap = 128
    return [("decode", decode, 16), ("continuous", routed(8, 4, 32), 32),
            ("prefill", routed(512, 4, cap), cap),
            ("one expert", [0] * 3 + [cap] + [0] * (E - 4), cap),
            ("at cap", [cap // 3] * 7 + [cap] + [cap // 5] * (E - 8), cap)]


def time_grouped(out: dict, forms: bool, folded_only: bool = False) -> None:
    """cim_mvm_grouped at qwen2-moe's expert banks (module docstring)."""
    from repro_torch.configs.qwen2_moe_a27b import CONFIG as QWEN
    from repro_torch.deploy import spec_from_config
    from repro_torch.kernels.cim_mvm import ops
    from repro_torch.kernels.cim_mvm.ref import (
        cim_effective_weights,
        cim_mvm_grouped_plain,
    )

    built = phase_build()
    out["kernels"] = {k: v for k, v in built.items() if "grouped" in k}
    E, spec = QWEN.n_experts, spec_from_config(QWEN)
    g = torch.Generator(device="cuda").manual_seed(2)
    takes_a = "assignments" in inspect.signature(
        ops.grouped_geometry).parameters
    folded_forms = ({"general": ops.FORM_GROUPED_FOLDED,
                     "decode": ops.FORM_GROUPED_FOLDED_DECODE,
                     "prefill": ops.FORM_GROUPED_FOLDED_PREFILL}
                    if forms and "form" in inspect.signature(
                        ops.cim_mvm_grouped).parameters else {})
    out.update(bound_ms={}, tf32_ms={}, err={}, form={}, rows={})
    for pname, (I, N) in (("gate", (QWEN.d_model, QWEN.moe_d_ff)),
                          ("down", (QWEN.moe_d_ff, QWEN.d_model))):
        deps = [ops.deploy(torch.randn((I, N), generator=g, device="cuda")
                           * 0.02, spec, "mdm", eta=QWEN.cim.eta)[0]
                for _ in range(E)]
        bank = dataclasses.replace(deps[0], **{
            f: torch.stack([getattr(d, f) for d in deps]).contiguous()
            for f in ("codes", "pos", "scale")})
        del deps
        banks = [bank, dataclasses.replace(bank, **{
            f: getattr(bank, f).clone() for f in ("codes", "pos", "scale")})]
        per_expert = sum(getattr(bank, f)[0].numel()
                         * getattr(bank, f).element_size()
                         for f in ("codes", "pos", "scale"))
        W = None if folded_only else torch.stack([cim_effective_weights(
            d.codes, d.pos, d.scale, n_bits=d.n_bits, wpt=d.wpt,
            cols=d.cols, eta=d.eta, reversed_df=d.reversed_df)[:I, :N]
            for d in (bank.layer(e) for e in range(E))])
        fbanks = []
        if hasattr(ops, "grouped_folded_geometry"):
            fb = dataclasses.replace(bank, sigma_read=0.01,
                                     noise_tag=torch.arange(
                                         E, dtype=torch.int32))
            fb.folded = torch.stack([ops.fold(dataclasses.replace(
                bank.layer(e), gain=torch.exp(0.05 * torch.randn(
                    bank.codes.shape[1:], generator=g, device="cuda"))))
                .folded for e in range(E)])
            fb.device_tags = fb.noise_tag.to("cuda")
            fb2 = dataclasses.replace(fb)
            fb2.folded, fb2.device_tags = fb.folded.clone(), fb.device_tags
            fbanks = [fb, fb2]
        for name, counts, cap in _grouped_routings(E):
            key = f"{name} {pname}"
            offsets = torch.tensor([0] + list(itertools.accumulate(counts)),
                                   dtype=torch.int32, device="cuda")
            A = sum(counts) + 1
            x = torch.randn((A, I), generator=g, device="cuda").to(
                torch.bfloat16)
            run = lambda d: ops.cim_mvm_grouped(x, d, offsets, cap)
            rows = sum(counts)
            hit = sum(1 for c in counts if c)
            if fbanks:
                out.setdefault("folded_form", {})[key] = \
                    ops.grouped_folded_geometry(E, cap, I, N,
                                                bank.codes.shape[2], True,
                                                True, A).form
            for tag, seed in (("folded", None), ("folded, noise", 3)):
                if not fbanks:
                    break
                frun = lambda d, s=seed: ops.cim_mvm_grouped(x, d, offsets,
                                                             cap, s)
                out["ms"][f"{key} [{tag}]"] = device_ms(frun, args=fbanks)
                want = cim_mvm_grouped_plain(x, fbanks[0], offsets, cap,
                                             seed)
                out["err"][f"{key} [{tag}]"] = (
                    (frun(fbanks[0]) - want).abs().max()
                    / want.abs().max()).item()
                for fname, form in folded_forms.items():
                    out["ms"][f"{key} [{tag}] [{fname}]"] = device_ms(
                        lambda d, s=seed, f=form: ops.cim_mvm_grouped(
                            x, d, offsets, cap, s, form=f), args=fbanks)
                    out["err"][f"{key} [{tag}] [{fname}]"] = (
                        (ops.cim_mvm_grouped(x, fbanks[0], offsets, cap, seed,
                                             form=form) - want).abs().max()
                        / want.abs().max()).item()
                del want
                out.setdefault("folded_bound_ms", {})[key] = (
                    hit * fbanks[0].folded[0].numel() * 4 + x.numel() * 2
                    + A * N * 4 + (E + 1) * 4) / PEAK_BYTES * 1e3
            out["rows"][key] = [rows, hit, cap]
            out["tf32_ms"][key] = bound(0.0, 2 * 2.0 * rows * I * N,
                                        PEAK_TF32)[0]
            if folded_only:
                continue
            out["ms"][key] = device_ms(run, args=banks)
            want = cim_mvm_grouped_plain(x, bank, offsets, cap)
            out["err"][key] = ((run(bank) - want).abs().max()
                               / want.abs().max()).item()
            del want
            geo = (bank.codes.shape[0], cap, I, N, bank.codes.shape[2],
                   bank.wpt, bank.n_bits, bank.cols, bank.reversed_df,
                   bank.codes.data_ptr() % 16 == 0, True)
            out["form"][key] = ops.grouped_geometry(
                *geo, *((A,) if takes_a else ())).form
            if forms and hasattr(ops, "GROUPED_DECODE_MAX_CAP"):
                keep = ops.GROUPED_DECODE_MAX_CAP
                for tag, limit in (("prefill form", 0),
                                   ("decode form", 1_000_000)):
                    ops.GROUPED_DECODE_MAX_CAP = limit
                    ops.grouped_geometry.cache_clear()
                    out["ms"][f"{key} [{tag}]"] = device_ms(run, args=banks)
                ops.GROUPED_DECODE_MAX_CAP = keep
                ops.grouped_geometry.cache_clear()
            buf = torch.zeros((E, cap, I), device="cuda")
            for e in range(E):
                a = int(offsets[e])
                buf[e, :counts[e]] = x[a:a + counts[e]].float()
            out["ms"][f"{key} bmm"] = device_ms(lambda: torch.bmm(buf, W))
            del buf
            n_bytes = (hit * per_expert + x.numel() * 2 + A * N * 4
                       + (E + 1) * 4)
            out["bound_ms"][key] = n_bytes / PEAK_BYTES * 1e3
        del banks, bank, W, fbanks


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--flash", action="store_true",
                    help="time flash_attention's forms, not cim_mvm's")
    ap.add_argument("--batched", action="store_true",
                    help="time cim_mvm_batched at a probe round's shapes")
    ap.add_argument("--grouped", action="store_true",
                    help="time cim_mvm_grouped at qwen2-moe's expert banks")
    ap.add_argument("--slstm", action="store_true",
                    help="time slstm_scan at xlstm-1.3b's sLSTM shape")
    ap.add_argument("--serve", action="store_true",
                    help="with --slstm, also serve xlstm-1.3b at full width")
    ap.add_argument("--forms", action="store_true",
                    help="with --grouped or --slstm, also time each case "
                         "on each form")
    ap.add_argument("--folded", action="store_true",
                    help="with --grouped, time the folded banks only")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("cim_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.src))
    from repro_torch.configs.phi3_mini_38b import CONFIG
    from repro_torch.deploy import spec_from_config
    from repro_torch.kernels.cim_mvm import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"label": a.label, "src": a.src,
           "card": torch.cuda.get_device_name(0), "ms": {}}

    if a.flash or a.batched:
        (time_flash if a.flash else time_batched)(out)
        print(json.dumps(out))
        return 0
    if a.grouped:
        time_grouped(out, a.forms, a.folded)
        print(json.dumps(out))
        return 0
    if a.slstm:
        time_slstm(out, a.forms)
        if a.serve:
            serve_xlstm(out)
        print(json.dumps(out))
        return 0

    def run(name, x, dep, nbytes, seed=None):
        deps = copies(dep, nbytes) if x.shape[0] <= ops.DECODE_MAX_M \
            else [dep]
        out["ms"][name] = device_ms(lambda d: ops.cim_mvm(x, d, seed),
                                    args=deps)

    for (I, N), rows in (((3072, 8192), (4, 128, 512)),
                         ((8192, 3072), (128,))):
        w = torch.randn((I, N), generator=g, device="cuda") * 0.02
        dep, _ = ops.deploy(w, spec_from_config(CONFIG), "mdm",
                            eta=CONFIG.cim.eta)
        for M in rows:
            x = torch.randn((M, I), generator=g, device="cuda")
            run(f"ideal M={M} {I}x{N}", x, dep,
                dep.codes.numel() * 2 + dep.pos.numel() * 4)
        del dep
    for (I, N) in ((3072, 8192), (8192, 3072)):
        dep = _nonideal_dep(I, N, "all", I + N)
        if hasattr(ops, "fold"):
            dep = ops.fold(dep)
            nbytes = dep.folded.numel() * 4
        else:
            nbytes = sum(t.numel() * t.element_size() for t in (
                dep.codes, dep.pos, dep.gain, dep.col_pos))
        for M in (4, 128, 512):
            x = torch.randn((M, I), generator=g, device="cuda").to(
                torch.bfloat16)
            run(f"nonideal M={M} {I}x{N}", x, dep, nbytes, 21)
        del dep
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
