"""Continuous-batching serving engine over the CIM path.

Port of ``repro.serve.continuous``.  :class:`ContinuousEngine` is the
multi-tenant tier: an Orca-style iteration loop (``step``) admits
queued prompts mid-flight into a fixed-capacity
:class:`repro_torch.serve.kvcache.SlotPool`, runs one batched decode
for every live slot, streams the sampled tokens and evicts finished
sequences.

**Fixed shapes.**  Prefill runs at ``(1, max_prompt)``, the prompt
padded, its first token taken at row ``length - 1``; the join masks
the padded tail out of the cache.  Decode runs at ``(capacity,)``, the
dead slots at temperature 0 over ``EMPTY_POS`` lanes.  So every
kernel sees one shape a form whatever the batch composition (the
``cim_mvm`` launch geometry follows M, never the live count), and
``traces`` counts the distinct call signatures of prefill and decode
(one each) as the reference counts its jit traces.  Positions are a
(capacity,) device tensor, so a decode step needs no host value but the
tokens it returns.

**Per-lane attention.**  Each lane carries its own clock: q positions
(B, S) and k positions (B, C) reach the ``flash_attention`` kernel in
its per-lane form, which the reference's TPU kernel lacks (it serves
this tier through plain JAX attention).

**Bank epochs and hot swaps.**  Every sequence is pinned at admission
to the (params, cim) *bank* then serving.  ``begin_redeploy(params)``
deploys a checkpoint in a background thread through the shared plan
cache while the current bank serves, and installs it as a new epoch at
the next ``step()``.  In-flight sequences decode against their own
bank; while several epochs are live, each decodes a fork of the full
slot state and the lanes merge by epoch mask.  A bank is dropped as
soon as nothing refers to it (at the install, or when its last
sequence finishes).

**Determinism.**  Row b's token depends only on its logits row, its
request seed, its token count and its temperature
(``sample_tokens_batch``), and every kernel of the path computes each
row on its own in a fixed order, so a request's tokens are
bit-identical whatever its slot, its batchmates or a swap to an
identical bank.

**Imperfect devices.**  ``nonideal``, ``nonideal_seed``, ``fault_aware``
and ``pipeline`` deploy every bank as ``ServeEngine`` does.  With
``sigma_read > 0`` each forward (an admission's prefill, an
iteration's decode) reads the crossbars with the seed of (nonideal
seed, forward counter), so noisy tokens depend on the order of the
forwards, unlike noiseless ones.

**Lifetime resilience.**  ``health`` arms the reference's monitoring
(``ServeEngine``'s): ``advance(dt)`` and ``check_health()`` refresh
deployments, and every changed (slot, pname) group lands as a new bank
epoch of its own, so an epoch that no sequence holds is freed group by
group while one pinned by sequences in flight keeps its bank.
``begin_redeploy(..., health=)`` captures fresh lifetime state for the
new checkpoint.

**Telemetry** (``repro_torch.telemetry``, the reference's names): the
spans ``serve/iteration``, ``serve/admit``, ``serve/decode_batch``,
``serve/swap`` and ``serve/redeploy`` (in the redeploy thread), each
iteration's occupancy, each decode step's seconds (its tokens' host
copy syncs the card, telemetry or not), the hot-swapped groups and
the installed redeploys.

The ``"attn"`` pattern only: a recurrent pattern would run the padded
prefill's pad tokens through its state (a defect of the reference's
tier, which the port does not mirror).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.deploy import PlanCache, restack_group
from repro_torch.device import check_on, resolve_device
from repro_torch.kernels import runtime
from repro_torch.models.model import KERNELS, Ops, apply_model
from repro_torch.serve.engine import (
    _C_SWAPS,
    _H_DECODE,
    deploy_serving_bank,
    probe_seed,
    read_seed,
    reads_noise,
    sample_tokens_batch,
)
from repro_torch.serve.kvcache import SignatureCounter, SlotPool
from repro_torch.serve.scheduler import Request, RequestScheduler

_H_OCCUPANCY = tm.histogram(
    "repro_serve_batch_occupancy",
    "Live slots / capacity per scheduler iteration.",
    buckets=(0.0625, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_C_REDEPLOYS = tm.counter(
    "repro_serve_redeploys_total",
    "Async checkpoint redeploys installed into the serving loop.")

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class Bank:
    """One immutable serving bank: a checkpoint's params + cim tree."""

    epoch: int
    params: Any
    cim: Any


def make_slot_prefill(cfg: ModelConfig, ops: Ops = KERNELS):
    """(params, state (B=1, per slot), tokens (1, P), length, seed,
    temp, cim) -> first token (1,) int32, advancing ``state``.

    ``tokens`` is the prompt padded to the fixed ``max_prompt`` P; the
    first token samples the logits row at ``length - 1`` as token 0 of
    the request's stream.
    """

    def prefill(params, state, tokens, length, seed, temp, cim=None,
                read=None):
        logits, _ = apply_model(params, cfg, tokens, state=state, cim=cim,
                                ops=ops, read_seed=read)
        lg = logits[:, length - 1]
        return sample_tokens_batch(lg, seed, torch.zeros_like(seed), temp)

    return prefill


def make_slot_decode(cfg: ModelConfig, ops: Ops = KERNELS):
    """(params, state, tokens (B,), seeds (B,), counts (B,), temps (B,),
    cim) -> (next tokens (B,) int32, state).

    ``counts`` are the tokens each sequence has emitted so far, the
    index of the token drawn.  Dead slots carry temperature 0 and
    EMPTY_POS lanes: their tokens are discarded.
    """

    def decode(params, state, tokens, seeds, counts, temps, cim=None,
               read=None):
        logits, state = apply_model(params, cfg, tokens[:, None],
                                    state=state, decode=True, cim=cim,
                                    ops=ops, read_seed=read)
        return sample_tokens_batch(logits[:, 0], seeds, counts, temps), state

    return decode


class ContinuousEngine:
    """Multi-tenant continuous-batching engine (see module docstring).

    ``params`` must lie on ``device`` (default the card).  ``cim``, a
    deployment of ``params`` made earlier (``deploy_serving_bank``),
    serves as bank 0 instead of deploying again (not with ``health``,
    whose lifetime state the deploy captures).
    """

    def __init__(self, cfg: ModelConfig, params: dict, capacity: int = 4,
                 max_seq: int = 256, max_prompt: int = 32, plan_cache=None,
                 nonideal=None, nonideal_seed: int = 0,
                 fault_aware: bool = True, pipeline=None, health=None,
                 cim=None, device: str | torch.device = "cuda"):
        if cfg.frontend:
            raise ValueError("ContinuousEngine serves token frontends "
                             "only (embedding prompts are not paged)")
        self.device = resolve_device(device)
        check_supported(cfg)
        if cim is not None and health is not None:
            raise ValueError("health needs the engine's own deploy (it "
                             "captures the lifetime state): pass no cim")
        if tuple(cfg.block_pattern) != ("attn",):
            raise NotImplementedError(
                f"{cfg.name}: continuous batching serves the 'attn' "
                "pattern; a recurrent state would take in the padded "
                "prefill's pad tokens")
        if max_prompt > max_seq:
            raise ValueError("max_prompt must be <= max_seq")
        check_on(self.device, embed=params["embed"],
                 lm_head=params["lm_head"])
        self.cfg = cfg
        self.capacity = capacity
        self.max_seq = max_seq
        self.max_prompt = max_prompt
        self.plan_cache = None
        if cfg.cim.enabled:
            self.plan_cache = (plan_cache if plan_cache is not None
                               else PlanCache())
        self.deploy_report = None
        self._nonideal = (nonideal, int(nonideal_seed), fault_aware,
                          pipeline)
        self._health_cfg = health
        self.lifetime, self.health = {}, None
        if cim is None:
            cim, self.deploy_report, self.lifetime, self.health = \
                deploy_serving_bank(cfg, params, self.plan_cache,
                                    self.device, *self._nonideal, False,
                                    health)
        self.read_noise = reads_noise(cim, nonideal)
        self._forwards = 0               # read-seed counter
        self.banks: dict[int, Bank] = {0: Bank(0, params, cim)}
        self.serving_epoch = 0
        self._next_epoch = 1

        self.scheduler = RequestScheduler()
        self.pool = SlotPool(cfg, capacity, max_seq, self.device)
        # Per-slot host mirrors of the decode operands, index-updated on
        # join and evict like the pool's state.
        self._tok = np.zeros(capacity, np.int32)
        self._seed = np.zeros(capacity, np.int64)
        self._nem = np.zeros(capacity, np.int32)
        self._temp = np.zeros(capacity, np.float32)

        self.ops = KERNELS
        self._sigs = SignatureCounter("prefill", "decode")
        self.traces = self._sigs.counts
        self._lock = threading.Lock()
        self._pending = None
        self._redeploy_thread: threading.Thread | None = None
        self.iterations = 0
        self.fanout_iterations = 0       # decodes over more than one epoch

    # -- public API ----------------------------------------------------

    def submit(self, prompt, max_tokens: int, temperature: float = 0.0,
               seed: int = 0, on_token=None) -> int:
        """Enqueue one request; returns its rid (tokens land in
        ``results[rid]`` once finished, streamed via ``on_token``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size > self.max_prompt:
            raise ValueError(f"prompt length {prompt.size} > "
                             f"max_prompt {self.max_prompt}")
        return self.scheduler.submit(prompt, max_tokens, temperature,
                                     seed, on_token)

    @property
    def results(self) -> dict[int, list[int]]:
        return self.scheduler.results

    def run(self, max_iters: int | None = None) -> dict[int, list[int]]:
        """Step until every submitted request has finished."""
        it = 0
        while self.scheduler.pending:
            self.step()
            it += 1
            if max_iters is not None and it >= max_iters:
                break
        return dict(self.scheduler.results)

    @torch.no_grad()
    def step(self) -> None:
        """One scheduler iteration: install pending bank -> admit ->
        batched decode -> stream -> evict."""
        with tm.span("serve/iteration", it=self.iterations,
                     live=self.pool.n_live,
                     queued=self.scheduler.queue_depth):
            self._install_pending()
            while self.scheduler.queue and self.pool.n_free:
                req = self.scheduler.pop_admission()
                with tm.span("serve/admit", rid=req.rid):
                    self._admit(req)
            _H_OCCUPANCY.observe(self.pool.n_live / self.capacity)
            if self.scheduler.live:
                self._decode_iteration()
        self.iterations += 1

    # -- admission -----------------------------------------------------

    def _read(self) -> int | None:
        """The next forward's read seed, or None without read noise."""
        if not self.read_noise:
            return None
        self._forwards += 1
        return read_seed(self._nonideal[1], self._forwards)

    def _prefill(self, bank: Bank, state, tokens, length, seed, temp):
        self._sigs.note("prefill", bank.params, state, tokens, seed, temp,
                        bank.cim)
        return make_slot_prefill(self.cfg, self.ops)(
            bank.params, state, tokens, length, seed, temp, bank.cim,
            self._read())

    def _admit(self, req: Request) -> None:
        bank = self.banks[self.serving_epoch]
        slot = self.pool.acquire()
        L = int(req.prompt.size)
        prompt = np.zeros((1, self.max_prompt), np.int64)
        prompt[0, :L] = req.prompt
        st = self.pool.fresh_seq_state()
        dev = self.device
        tok = self._prefill(
            bank, st, torch.from_numpy(prompt).to(dev), L,
            torch.tensor([_seed64(req.seed)], dtype=torch.int64, device=dev),
            torch.tensor([req.temperature], dtype=torch.float32, device=dev))
        self.pool.join(slot, st, L)
        self.scheduler.start(req, slot, self.serving_epoch)
        tok0 = int(tok[0])
        self._tok[slot] = tok0
        self._seed[slot] = _seed64(req.seed)
        self._nem[slot] = 1
        self._temp[slot] = req.temperature
        if self.scheduler.record_token(slot, tok0):
            self._evict(slot)

    def _evict(self, slot: int) -> None:
        seq = self.scheduler.finish(slot)
        if seq.epoch != self.serving_epoch:
            self._gc_banks()          # maybe the old bank's last sequence
        self.pool.evict(slot)
        self._tok[slot] = 0
        self._seed[slot] = 0
        self._nem[slot] = 0
        self._temp[slot] = 0.0

    # -- decode --------------------------------------------------------

    def _decode(self, bank: Bank, state, operands, read=None):
        self._sigs.note("decode", bank.params, state, *operands, bank.cim)
        return make_slot_decode(self.cfg, self.ops)(
            bank.params, state, *operands, bank.cim, read)

    def _decode_iteration(self) -> None:
        live = self.scheduler.live
        t_on = tm.enabled()
        t0 = tm.monotonic() if t_on else 0.0
        with tm.span("serve/decode_batch", live=len(live),
                     epochs=len(self.scheduler.epochs_live())):
            tok_host = self._decode_all_banks()   # a host copy: synced
        if t_on:
            _H_DECODE.observe(tm.monotonic() - t0)
        finished = []
        for slot in sorted(live):
            t = int(tok_host[slot])
            self._tok[slot] = t
            self._nem[slot] += 1
            if self.scheduler.record_token(slot, t):
                finished.append(slot)
        for slot in finished:
            self._evict(slot)

    def _decode_all_banks(self) -> np.ndarray:
        """One decode step for all slots, grouped by bank epoch.

        One live epoch: one decode, in place on the pool state.  Across
        a hot swap, each live epoch decodes the full batch against its
        own bank (on a fork of the state but for the last), the states
        merge by epoch mask, and each slot takes its epoch's token.
        """
        epochs = self.scheduler.epochs_live()
        dev = self.device
        read = self._read()
        operands = (torch.from_numpy(self._tok).to(dev),
                    torch.from_numpy(self._seed).to(dev),
                    torch.from_numpy(self._nem).to(dev),
                    torch.from_numpy(self._temp).to(dev))
        if len(epochs) == 1:
            tok, self.pool.state = self._decode(self.banks[epochs[0]],
                                                self.pool.state, operands,
                                                read)
            return tok.cpu().numpy()

        self.fanout_iterations += 1
        per_epoch: dict[int, np.ndarray] = {}
        merged = None
        for i, e in enumerate(epochs):
            st_in = (self.pool.fork() if i < len(epochs) - 1
                     else self.pool.state)
            tok, st_out = self._decode(self.banks[e], st_in, operands, read)
            per_epoch[e] = tok.cpu().numpy()
            if merged is None:
                merged = st_out
            else:
                take_b = np.zeros(self.capacity, bool)
                for slot, seq in self.scheduler.live.items():
                    take_b[slot] = seq.epoch == e
                merged = self.pool.merge(merged, st_out, take_b)
        self.pool.state = merged
        tok_host = per_epoch[epochs[0]].copy()
        for slot, seq in self.scheduler.live.items():
            tok_host[slot] = per_epoch[seq.epoch][slot]
        return tok_host

    # -- banks / hot swap ----------------------------------------------

    def _install_bank(self, params, cim) -> int:
        """Install a new serving bank epoch (fresh objects, no mutation)."""
        e = self._next_epoch
        self._next_epoch += 1
        self.banks[e] = Bank(e, params, cim)
        self.serving_epoch = e
        self._gc_banks()
        return e

    def _gc_banks(self) -> None:
        held = {seq.epoch for seq in self.scheduler.live.values()}
        held.add(self.serving_epoch)
        for e in [e for e in self.banks if e not in held]:
            del self.banks[e]

    # -- lifetime resilience -------------------------------------------

    def _swap(self, dirty: set) -> None:
        """Restack each refreshed group into a new bank epoch of its own
        (fresh dicts; in-flight sequences keep their admission epoch)."""
        if not dirty:
            return
        with tm.span("serve/swap", groups=len(dirty)):
            for slot, pname in sorted(dirty):
                cur = self.banks[self.serving_epoch]
                cim = {s: dict(sub) for s, sub in cur.cim.items()}
                cim[slot][pname] = restack_group(self.lifetime, slot, pname)
                self._install_bank(cur.params, cim)
        _C_SWAPS.inc(len(dirty))

    def advance(self, dt: float) -> None:
        """Advance the drift clock; heal-swaps land as new epochs."""
        if self.health is not None:
            self._swap(self.health.advance(dt))

    def check_health(self, read_seed: int | None = None):
        """One probe round + remediation (the probe read seed as
        ``ServeEngine``'s); swaps land as new epochs.  Returns a
        HealthReport, or None without health."""
        if self.health is None:
            return None
        if read_seed is None and self.read_noise:
            read_seed = probe_seed(self._nonideal[1], self.health.rounds)
        self._swap(self.health.probe(read_seed))
        return self.health.report()

    @property
    def health_report(self):
        """Current HealthReport, or None when health is not armed."""
        return None if self.health is None else self.health.report()

    def begin_redeploy(self, params: dict, *, nonideal=_UNSET,
                       nonideal_seed=_UNSET, fault_aware=_UNSET,
                       pipeline=_UNSET, health=_UNSET) -> threading.Thread:
        """Deploy a new checkpoint in the background; swap when ready.

        Planning and packaging run in a worker thread through the
        shared plan cache while the current bank serves; the new bank
        (with fresh lifetime capture and controller when ``health`` is
        armed) is installed at the next ``step()`` boundary.  Each
        keyword left unset inherits the engine's init-time setting; the
        engine's own settings (read seeds among them) stay as they
        were.  Returns the thread (``join()`` it to rendezvous; serving
        never has to).
        """
        if (self._redeploy_thread is not None
                and self._redeploy_thread.is_alive()):
            raise RuntimeError("a redeploy is already in progress")
        check_on(self.device, embed=params["embed"],
                 lm_head=params["lm_head"])
        if self.device.type == "cuda":
            runtime.library()            # built before two threads launch
        given = (nonideal, nonideal_seed, fault_aware, pipeline)
        deploy = tuple(own if v is _UNSET else v
                       for v, own in zip(given, self._nonideal))
        health = self._health_cfg if health is _UNSET else health

        def work():
            try:
                with torch.no_grad(), tm.span("serve/redeploy"):
                    pending = (params, *deploy_serving_bank(
                        self.cfg, params, self.plan_cache, self.device,
                        deploy[0], int(deploy[1]), *deploy[2:], False,
                        health))
            except Exception as exc:          # raised again by step()
                pending = exc
            with self._lock:
                self._pending = pending

        t = threading.Thread(target=work, name="repro-torch-redeploy",
                             daemon=True)
        self._redeploy_thread = t
        t.start()
        return t

    def redeploy_ready(self) -> bool:
        with self._lock:
            return self._pending is not None

    def _install_pending(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        if isinstance(pending, Exception):
            raise RuntimeError("the background redeploy failed") from pending
        params, cim, report, lifetime, controller = pending
        self._install_bank(params, cim)
        self.deploy_report = report
        # The old lifetime state describes the retired checkpoint.
        self.lifetime, self.health = lifetime, controller
        _C_REDEPLOYS.inc()


def _seed64(seed: int) -> int:
    """A request seed as a signed 64-bit integer (seeds mod 2^64)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return s - (1 << 64) if s >= 1 << 63 else s
