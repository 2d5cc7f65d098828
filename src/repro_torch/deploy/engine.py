"""Whole-model CIM deployment: model params -> stacked CimDeployments.

Port of the dense part of ``repro.deploy.engine``: every parameter of
every pattern slot whose name the reference deploys (attention and
mLSTM q/k/v, attention o, SwiGLU projections) is quantised, planned
(:mod:`repro_torch.deploy.planner`, one matrix at a time, through a
plan cache when one is given) and packaged; each slot's deployments are
stacked over its pattern repeats, the layout
``repro_torch.models.model.apply_model`` walks.  Every other parameter
stays digital and is recorded with the reference's reason.  Ideal
devices only: the nonideal and lifetime parts of the reference are
later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.core.bitslice import quantize_magnitude
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy.cache import PlanCache
from repro_torch.deploy.planner import plan_matrices
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels.cim_mvm.ops import CimDeployment, package_deployment

# The reference's name lists (``repro/deploy/engine.py``).
_QKV_NAMES = ("wq", "wk", "wv", "attn_wq", "attn_wk", "attn_wv")
_OUT_NAMES = ("wo", "attn_wo")
_MLP_NAMES = ("ffn_w_gate", "ffn_w_up", "ffn_w_down")
DEPLOYABLE = _QKV_NAMES + _OUT_NAMES + _MLP_NAMES
MOE_EXPERT_NAMES = ("ffn_we_gate", "ffn_we_up", "ffn_we_down")


def _as_matrix(name: str, w: torch.Tensor) -> torch.Tensor:
    """Per-layer projection tensor -> its (in_dim, out_dim) matmul view."""
    if name in _QKV_NAMES:        # (D, H, Dh) -> (D, H*Dh)
        return w.reshape(w.shape[0], -1)
    if name in _OUT_NAMES:        # (H, Dh, D) -> (H*Dh, D)
        return w.reshape(-1, w.shape[-1])
    return w                      # MLP projections are already 2-D


def spec_from_config(cfg: ModelConfig) -> CrossbarSpec:
    c = cfg.cim
    return CrossbarSpec(rows=c.rows, cols=c.cols, n_bits=c.n_bits,
                        r=c.r, r_on=c.r_on, r_off=c.r_off)


def _skip_reason(pname: str) -> str:
    """Why a parameter stays digital: the reference's ``_skip_reason``
    without an expert-axis partition (the port has none yet)."""
    if pname in MOE_EXPERT_NAMES:
        return ("moe-expert-bank: select an expert-axis partition "
                "(e.g. pipeline 'mdm_expert') to deploy")
    if "norm" in pname or pname in ("bq", "bk", "bv"):
        return "norm/bias (digital)"
    if pname.startswith(("ffn_router", "ffn_shared", "ffn_ws")):
        return "moe routing / shared expert (digital)"
    if pname.startswith(("ssm_", "mlstm_", "slstm_", "conv_")) \
            or pname.startswith(("w_in", "w_x", "w_h", "a_log", "dt_")):
        return "recurrent/SSM state path (digital)"
    return "no crossbar mapping for this parameter"


def collect_model_matrices(params: dict, cfg: ModelConfig
                           ) -> tuple[dict[str, torch.Tensor], dict]:
    """Every deployable matrix as ``"slot/param/repeat"`` -> (I, N) view,
    in deterministic order, and a summary of what stays digital."""
    mats: dict[str, torch.Tensor] = {}
    skipped: dict[str, str] = {}
    for top in params:
        if not top.startswith("slot"):
            skipped[top] = "embedding/head/final-norm (digital by design)"
    for i, bt in enumerate(cfg.block_pattern):
        slot = f"slot{i}_{bt}"
        slot_params = params.get(slot, {})
        for pname in DEPLOYABLE:
            if pname not in slot_params:
                continue
            stacked = slot_params[pname]
            for r in range(stacked.shape[0]):
                mats[f"{slot}/{pname}/{r}"] = _as_matrix(pname, stacked[r])
        for pname in slot_params:
            if pname not in DEPLOYABLE:
                skipped[f"{slot}/{pname}"] = _skip_reason(pname)
    summary = {"deployed": list(mats), "skipped": skipped,
               "n_deployed": len(mats), "n_skipped": len(skipped)}
    return mats, summary


def deploy_model_params(params: dict, cfg: ModelConfig,
                        cache: PlanCache | None = None,
                        device: str | torch.device = "cuda"
                        ) -> tuple[dict, dict]:
    """Deploy every projection matrix of a model onto crossbars.

    Returns (cim_tree, report): ``cim_tree[slot][param]`` is one
    :class:`CimDeployment` whose codes / pos / scale are stacked over the
    slot's pattern repeats.  The parameters must lie on ``device``;
    quantisation, planning (of the cache's misses, with ``cache``) and
    packaging run there, one matrix at a time.  The report carries
    matrix and tile counts, the cache's hits and misses, and the summed
    NF before and after planning.
    """
    dev = resolve_device(device)
    check_supported(cfg)
    spec = spec_from_config(cfg)
    mats, summary = collect_model_matrices(params, cfg)
    check_on(dev, **{name.replace("/", "_"): w for name, w in mats.items()})
    plans, report = plan_matrices(mats, spec, cfg.cim.mode, cache)

    nf_before = torch.zeros((), dtype=torch.float64, device=dev)
    nf_after = torch.zeros((), dtype=torch.float64, device=dev)
    tiles = 0
    cim_tree: dict = {}
    for i, bt in enumerate(cfg.block_pattern):
        slot = f"slot{i}_{bt}"
        slot_deps: dict = {}
        for pname in DEPLOYABLE:
            if pname not in params.get(slot, {}):
                continue
            reps = params[slot][pname].shape[0]
            stacked = None
            for r in range(reps):
                name = f"{slot}/{pname}/{r}"
                plan = plans.pop(name)
                codes, sign, scale = quantize_magnitude(mats[name],
                                                        spec.n_bits)
                dep = package_deployment(
                    codes, sign, scale,
                    plan._replace(row_position=plan.row_position.to(dev)),
                    spec, cfg.cim.eta)
                nf_before += plan.nf_before.sum(dtype=torch.float64).to(dev)
                nf_after += plan.nf_after.sum(dtype=torch.float64).to(dev)
                tiles += plan.nf_before.numel()
                del plan, codes, sign
                if stacked is None:
                    stacked = CimDeployment(
                        codes=torch.empty((reps,) + dep.codes.shape,
                                          dtype=dep.codes.dtype, device=dev),
                        pos=torch.empty((reps,) + dep.pos.shape,
                                        dtype=dep.pos.dtype, device=dev),
                        scale=torch.empty((reps,), dtype=torch.float32,
                                          device=dev),
                        n_bits=dep.n_bits, wpt=dep.wpt, cols=dep.cols,
                        eta=dep.eta, reversed_df=dep.reversed_df,
                        in_dim=dep.in_dim, out_dim=dep.out_dim)
                stacked.codes[r].copy_(dep.codes)
                stacked.pos[r].copy_(dep.pos)
                stacked.scale[r] = dep.scale
            slot_deps[pname] = stacked
        cim_tree[slot] = slot_deps
    b, a = float(nf_before), float(nf_after)
    report.update(tiles=tiles, nf_before=b, nf_after=a,
                  nf_reduction=(b - a) / max(b, 1e-30),
                  matrices=summary, n_slots=len(cim_tree))
    return cim_tree, report
