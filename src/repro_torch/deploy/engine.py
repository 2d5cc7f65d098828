"""Whole-model CIM deployment: model params -> stacked CimDeployments.

Port of ``repro.deploy.engine``: every parameter of every pattern slot
whose name the reference deploys (attention and mLSTM q/k/v, attention
o, SwiGLU projections) and, under an expert-axis partition (pipeline
``mdm_expert``), every MoE expert bank, one matrix an expert, is
quantised, planned (:mod:`repro_torch.deploy.planner`, one matrix at a
time, through a plan cache when one is given, else each right before it
is packaged) and packaged; each slot's deployments are stacked over its
pattern repeats (an expert bank over repeats and experts), the layout
``repro_torch.models.model.apply_model`` walks.  Every other parameter
stays digital and is recorded with the reference's reason.  Expert
banks deploy onto ideal devices only: their folded grouped form, which
imperfect devices and lifetime state need, is a later slice.

Imperfect devices (``nonideal``): every matrix's physical cells are
drawn on the device from (seed, its traversal index) — one matrix at a
time, never the whole checkpoint's population, which at phi3-mini's
width would not fit the card — or taken from a ``cells`` mapping (the
seam the parity tests feed the reference's draws through).  Known
stuck cells steer the fault-consuming mapping passes and key their
plans; packaging folds stuck bits into the codes and variation and
drift into the deployment's ``gain``, counts the programmed bits that
line opens still hold after the remap (``degraded``), and folds each
served matrix's W'(col_pos) * gain once (``CimDeployment.folded``, the
fold kernel on the card), which its reads take instead of the codes.
With ``lifetime`` it captures what serving-time aging and self-healing
need (:mod:`repro_torch.deploy.lifetime`), as the reference does.
"""
from __future__ import annotations

import contextlib
import time
from collections.abc import Mapping

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.core.bitslice import quantize_magnitude
from repro_torch.core.mdm import MdmPlan
from repro_torch.core.tiling import CrossbarSpec
from repro_torch.deploy.cache import PlanCache
from repro_torch.deploy.planner import plan_matrices
from repro_torch.device import check_on, resolve_device
from repro_torch.deploy.lifetime import MatrixLifetime, _untimed
from repro_torch.kernels.cim_mvm.ops import CimDeployment, fold, package_padded
from repro_torch.mapping import FaultAwareRows, MdmRows, resolve_pipeline
from repro_torch.nonideal.inject import (
    HostCells,
    aged_gain_host,
    cells_on,
    gather_physical_host,
    has_faults,
    matrix_cells,
    matrix_stuck,
    open_bit_overlap_host,
    perturb_codes_host,
)
from repro_torch.nonideal.models import NonidealModel

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
    """Why a parameter stays digital: the reference's ``_skip_reason``."""
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


def collect_model_matrices(params: dict, cfg: ModelConfig, pipeline=None
                           ) -> tuple[dict[str, torch.Tensor], dict]:
    """Every deployable matrix, in the reference's deterministic order,
    and a summary of what stays digital.

    ``mats`` maps ``"slot/param/repeat"`` (and, under an expert-axis
    partition of ``pipeline``, default ``cfg.cim.mode``,
    ``"slot/param/repeat/e{expert}"`` for the MoE banks) to an (I, N)
    view of the parameter: in each slot the ``DEPLOYABLE`` names first,
    then the expert banks, then the skip accounting, as the reference's
    traversal.  ``summary``: ``{"deployed": [...], "skipped": {name:
    reason}, "n_deployed": int, "n_skipped": int}``."""
    pipe = resolve_pipeline(pipeline if pipeline is not None
                            else cfg.cim.mode)
    expert = getattr(pipe.partition, "expert_axis", False)
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
        for pname in MOE_EXPERT_NAMES:
            if pname not in slot_params or not expert:
                continue
            stacked = slot_params[pname]                 # (R, E, I, N)
            for r in range(stacked.shape[0]):
                parts = pipe.partition.split(f"{slot}/{pname}/{r}",
                                             stacked[r])
                if parts is None:
                    skipped[f"{slot}/{pname}"] = (
                        f"partition {pipe.partition.name!r} cannot "
                        f"split shape {tuple(stacked[r].shape)}")
                    break
                mats.update(parts)
        for pname in slot_params:
            if pname in DEPLOYABLE or (pname in MOE_EXPERT_NAMES and expert):
                continue
            skipped[f"{slot}/{pname}"] = _skip_reason(pname)
    summary = {"deployed": list(mats), "skipped": skipped,
               "n_deployed": len(mats), "n_skipped": len(skipped)}
    return mats, summary


def _bank_index(name: str) -> tuple[str, str, tuple[int, ...]]:
    """(slot, param, index into the stacked bank) of a matrix name:
    (repeat,) or, for an expert, (repeat, expert)."""
    slot, pname, r, *sub = name.split("/")
    return slot, pname, (int(r),) + tuple(int(e[1:]) for e in sub)


class StageClock:
    """Seconds a deploy stage on the host clock, the device synchronised
    at each stage boundary; a stage's time excludes the stages nested in
    it.  Stages run on the calling thread (the planner's fault-map
    draws, made in its thread pool, count under "plan")."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict[str, float] = {}
        self._inner: list[float] = []

    def _mark(self) -> float:
        """The host clock once the device has drained its queue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()  # reprolint: disable=RPL006 -- the port imports nothing of repro, whose telemetry owns the clocks

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = self._mark()
        self._inner.append(0.0)
        try:
            yield
        finally:
            dt = self._mark() - t0
            inner = self._inner.pop()
            self.seconds[stage] = self.seconds.get(stage, 0.0) + dt - inner
            if self._inner:
                self._inner[-1] += dt


# Logical rows a packaging step injects at once: the gathered fault and
# gain fields of 256 rows of a 8192-wide matrix are ~120 MB.
_INJECT_ROWS = 256


def package_deployment_host(w: torch.Tensor, spec: CrossbarSpec, mode,
                            eta: float, plan: MdmPlan,
                            cells: HostCells | None = None,
                            nonideal: NonidealModel | None = None,
                            noise_tag: int | None = None,
                            stats: dict | None = None,
                            clock=_untimed,
                            capture: bool = False) -> CimDeployment:
    """Quantise and package one planned (I, N) matrix on its device (the
    reference's host packaging, run where ``w`` lies; ``mode`` is kept
    for its signature, the layout comes from the plan).

    ``cells`` (physical fields on ``w``'s device) inject the device
    state, a few tiles of rows at a time: stuck bits fold into the
    padded codes (padding included, as in the reference), the
    programmed bits on OPEN cells before that fold are the deployment's
    ``degraded`` count (also ``stats["open_bits"]``), and variation and
    drift (at the model's ``drift_time``) fold into ``gain``.  With
    ``nonideal.sigma_read > 0`` the deployment carries ``noise_tag``.
    ``clock`` (a :class:`StageClock`) times the injection as "inject".
    ``capture`` (a deployment whose lifetime is kept,
    :mod:`repro_torch.deploy.lifetime`) always carries a ``gain`` (ones
    where nothing perturbs it) and ``degraded`` (0), and is folded even
    where degraded (the health probes read it), as the reference's
    captured deployments keep one structure across hot swaps.
    """
    del mode
    I, N = w.shape
    ti, tn = spec.grid(I, N)
    i_pad, n_pad = ti * spec.rows, tn * spec.weights_per_tile
    codes, sign, scale = quantize_magnitude(w, spec.n_bits)
    codes = F.pad(codes, (0, n_pad - N, 0, i_pad - I))
    sign = F.pad(sign.to(torch.int32), (0, n_pad - N, 0, i_pad - I), value=1)
    gain = degraded = None
    if cells is not None and any(f is not None for f in cells):
        rev, K = bool(plan.reversed_dataflow), spec.n_bits
        model = nonideal if nonideal is not None else NonidealModel()
        want_gain = cells.gamma is not None or cells.relax is not None
        if want_gain:
            gain = torch.empty(codes.shape, dtype=torch.float32,
                               device=codes.device)
        open_bits = 0
        with clock("inject"):
            for r0 in range(0, i_pad, _INJECT_ROWS):
                sl = slice(r0, r0 + _INJECT_ROWS)
                log = lambda f: None if f is None else gather_physical_host(
                    f, plan.row_position, rev, spec, plan.col_position, sl)
                stuck_log = log(cells.stuck)
                if stuck_log is not None:
                    open_bits += open_bit_overlap_host(codes[sl], stuck_log,
                                                       K)
                    codes[sl] = perturb_codes_host(codes[sl], stuck_log, K)
                if want_gain:
                    gain[sl] = aged_gain_host(
                        codes[sl], stuck_log, log(cells.gamma),
                        log(cells.relax), K, model, model.drift_time)
        if cells.stuck is not None:
            degraded = torch.tensor(open_bits, dtype=torch.int32)
            if stats is not None:
                stats["open_bits"] = open_bits
    if capture:
        if gain is None:
            gain = torch.ones(codes.shape, dtype=torch.float32,
                              device=codes.device)
        if degraded is None:
            degraded = torch.tensor(0, dtype=torch.int32)
    sigma_read = 0.0 if nonideal is None else float(nonideal.sigma_read)
    tag = (torch.tensor(noise_tag, dtype=torch.int32)
           if noise_tag is not None and sigma_read > 0.0 else None)
    signed = (codes * sign).to(torch.int16)
    dep = package_padded(signed, scale, plan, spec, eta, I, N, gain=gain,
                         degraded=degraded, noise_tag=tag,
                         sigma_read=sigma_read)
    return fold(dep) if capture and dep.folded is None else dep


class _LazyFaults(Mapping):
    """name -> fault map, drawn when the planner asks for it."""

    def __init__(self, names, draw):
        self._names, self._draw = list(names), draw

    def __getitem__(self, name):
        if name not in self._names:
            raise KeyError(name)
        return self._draw(name)

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)


def _stack(lead: tuple[int, ...], dep: CimDeployment,
           dev) -> CimDeployment:
    """An empty stacked deployment shaped like ``dep`` over ``lead``: the
    repeats, or the repeats and experts of an expert bank."""
    new = lambda t, where: None if t is None else torch.empty(
        lead + tuple(t.shape), dtype=t.dtype, device=where)
    return CimDeployment(
        codes=new(dep.codes, dev), pos=new(dep.pos, dev),
        scale=torch.empty(lead, dtype=torch.float32, device=dev),
        n_bits=dep.n_bits, wpt=dep.wpt, cols=dep.cols, eta=dep.eta,
        reversed_df=dep.reversed_df, in_dim=dep.in_dim, out_dim=dep.out_dim,
        gain=new(dep.gain, dev), col_pos=new(dep.col_pos, dev),
        degraded=new(dep.degraded, "cpu"),
        noise_tag=new(dep.noise_tag, "cpu"), sigma_read=dep.sigma_read)


def _put(stacked: CimDeployment, idx: tuple[int, ...],
         dep: CimDeployment) -> None:
    """Entry ``idx`` (a repeat, or a repeat and an expert) of ``stacked``
    from ``dep``.  The folded W' * gain is allocated at the slot's first
    served (non-degraded) repeat; a degraded repeat's stays zero (its
    reads are digital)."""
    for f in ("codes", "pos", "scale", "gain", "col_pos", "degraded",
              "noise_tag"):
        if getattr(dep, f) is not None:
            getattr(stacked, f)[idx].copy_(getattr(dep, f))
    if dep.folded is not None:
        if stacked.folded is None:
            lead = tuple(stacked.scale.shape)
            stacked.folded = torch.zeros(lead + tuple(dep.folded.shape),
                                         dtype=torch.float32,
                                         device=dep.folded.device)
        stacked.folded[idx].copy_(dep.folded)


def deploy_model_params(params: dict, cfg: ModelConfig,
                        cache: PlanCache | None = None,
                        device: str | torch.device = "cuda",
                        nonideal: NonidealModel | None = None,
                        nonideal_key: int | None = None,
                        fault_aware: bool = True, pipeline=None,
                        cells: Mapping | None = None, timed: bool = False,
                        lifetime: dict | None = None) -> tuple[dict, dict]:
    """Deploy every projection matrix of a model onto crossbars.

    Returns (cim_tree, report): ``cim_tree[slot][param]`` is one
    :class:`CimDeployment` whose tensors are stacked over the slot's
    pattern repeats (an expert bank's over the repeats and its experts,
    (R, E, ...)).  The parameters must lie on ``device``; quantisation,
    planning (of the cache's misses, with ``cache``; without one each
    matrix right before it is packaged, so one plan at a time is alive)
    and packaging run there, one matrix at a time.  ``pipeline`` (a
    :class:`repro_torch.mapping.MappingPipeline`, a named pipeline or a
    spec string) defaults to ``cfg.cim.mode``; an expert-axis partition
    (``"mdm_expert"``) deploys the MoE expert banks, onto ideal devices
    only (``nonideal`` or ``lifetime`` with expert banks raise
    ``NotImplementedError``).

    ``nonideal`` deploys onto imperfect devices keyed by the int
    ``nonideal_key`` (default 0): each matrix's cells are drawn on the
    device from (key, traversal index), or taken from ``cells`` (name ->
    cells with ``stuck`` / ``gamma`` / ``relax`` fields, numpy or
    tensors).  With ``fault_aware`` the stuck cells steer the planning,
    an MDM row pass becoming the fault-aware one, and key the plans.
    The report carries matrix and tile counts, the cache's hits and
    misses and the summed NF before and after planning, and with
    ``nonideal`` the stuck cells, the ``degraded`` matrices (each with
    the reference's reason) and ``n_degraded``.  ``timed`` synchronises
    the device at every stage boundary and adds ``seconds``: the time
    spent drawing the packaged cells ("sample"), planning ("plan": the
    cache and the fault maps it keys on included), injecting ("inject")
    and the rest of packaging ("package").

    ``lifetime`` (a dict, filled in place; with a non-ideal ``nonideal``
    only) captures a :class:`repro_torch.deploy.lifetime.MatrixLifetime`
    a matrix: its key, traversal index, crossbar spec and model, a view
    of its weight and its repeat of the stacked bank (whose codes,
    ``pos`` and ``col_pos`` are what a refresh re-draws and gathers
    through), aged at the model's ``drift_time``.  Every captured
    deployment carries a gain and ``degraded`` and is folded.
    """
    dev = resolve_device(device)
    check_supported(cfg)
    spec = spec_from_config(cfg)
    mode = pipeline if pipeline is not None else cfg.cim.mode
    mats, summary = collect_model_matrices(params, cfg, mode)
    check_on(dev, **{name.replace("/", "_"): w for name, w in mats.items()})
    experts = [n for n in mats if len(_bank_index(n)[2]) > 1]
    if experts and ((nonideal is not None and not nonideal.is_ideal)
                    or lifetime is not None):
        raise NotImplementedError(
            f"{len(experts)} MoE expert matrices: expert banks deploy onto "
            "ideal devices only; imperfect devices and lifetime state on "
            "an expert partition need the folded grouped cim_mvm form, a "
            "later slice of the port")
    clock = StageClock(dev) if timed else _untimed

    cells_of = fault_maps = None
    if nonideal is not None and not nonideal.is_ideal:
        key = 0 if nonideal_key is None else int(nonideal_key)
        index = {name: t for t, name in enumerate(mats)}
        grids = {name: spec.grid(*w.shape) for name, w in mats.items()}
        if cells is None:
            draw = lambda name: matrix_cells(
                key, index[name], grids[name], spec, nonideal, dev)
            draw_stuck = lambda name: matrix_stuck(
                key, index[name], grids[name], spec, nonideal, dev)
            faulty = has_faults(nonideal)
        else:
            draw = lambda name: cells_on(cells[name], dev)
            draw_stuck = lambda name: draw(name).stuck
            faulty = any(c.stuck is not None for c in cells.values())

        def cells_of(name):
            with clock("sample"):
                return draw(name)

        if fault_aware and faulty:
            fault_maps = _LazyFaults(mats, draw_stuck)
    capture = lifetime is not None and cells_of is not None
    if fault_maps is not None:
        pipe = resolve_pipeline(mode, True)
        if isinstance(pipe.rows, MdmRows):
            pipe = pipe.replace(rows=FaultAwareRows())
        mode = pipe
    with clock("plan"):
        plans, report = plan_matrices(mats, spec, mode, cache, fault_maps,
                                      lazy=cache is None)

    nf_before = torch.zeros((), dtype=torch.float64, device=dev)
    nf_after = torch.zeros((), dtype=torch.float64, device=dev)
    tiles = stuck_cells = 0
    degraded: dict[str, int] = {}
    cim_tree: dict = {}
    for t, name in enumerate(mats):
        slot, pname, idx = _bank_index(name)
        with clock("plan"):
            plan = plans.pop(name)
        c = None if cells_of is None else cells_of(name)
        if c is not None and c.stuck is not None:
            stuck_cells += int((c.stuck != 0).sum())
        stats: dict = {}
        col_position = (None if plan.col_position is None
                        else plan.col_position.to(dev))
        with clock("package"):
            dep = package_deployment_host(
                mats[name], spec, mode, cfg.cim.eta,
                plan._replace(row_position=plan.row_position.to(dev),
                              col_position=col_position),
                cells=c, nonideal=nonideal, noise_tag=t, stats=stats,
                clock=clock, capture=capture)
        if stats.get("open_bits"):
            degraded[name] = stats["open_bits"]
        nf_before += plan.nf_before.sum(dtype=torch.float64).to(dev)
        nf_after += plan.nf_after.sum(dtype=torch.float64).to(dev)
        tiles += plan.nf_before.numel()
        del plan, c
        slot_deps = cim_tree.setdefault(slot, {})
        if pname not in slot_deps:
            lead = tuple(params[slot][pname].shape[:len(idx)])
            slot_deps[pname] = _stack(lead, dep, dev)
        _put(slot_deps[pname], idx, dep)
    for i, bt in enumerate(cfg.block_pattern):
        cim_tree.setdefault(f"slot{i}_{bt}", {})
    if capture:
        for t, name in enumerate(mats):
            slot, pname, r = name.split("/")
            bank = cim_tree[slot][pname]
            lifetime[name] = MatrixLifetime(
                name=name, noise_tag=t, spec=spec, model=nonideal,
                eta=cfg.cim.eta, key=key, w=mats[name],
                dep=bank.layer(int(r)), bank=bank, rep=int(r),
                cells=None if cells is None else cells_on(cells[name], dev),
                age=float(nonideal.drift_time))
    b, a = float(nf_before), float(nf_after)
    report.update(tiles=tiles, nf_before=b, nf_after=a,
                  nf_reduction=(b - a) / max(b, 1e-30),
                  matrices=summary, n_slots=len(cim_tree))
    if timed:
        report["seconds"] = dict(clock.seconds)
    if cells_of is not None:
        report["nonideal"] = True
        report["fault_aware"] = (fault_maps is not None
                                 and resolve_pipeline(mode, True)
                                 .rows.uses_faults)
        report["stuck_cells"] = stuck_cells
        report["degraded"] = {
            name: (f"degraded: {n} programmed bit(s) on open lines "
                   "after remap (spares exhausted); serving via "
                   "digital fallback")
            for name, n in sorted(degraded.items())}
        report["n_degraded"] = len(degraded)
    return cim_tree, report
