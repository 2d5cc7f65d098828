"""Serving: prefill + batched autoregressive decode over ring-buffer
caches, with greedy or temperature sampling.

Port of ``repro.serve.engine.ServeEngine``.  With ``cfg.cim.enabled`` the
engine deploys every projection matrix onto crossbars at init
(``repro_torch.deploy.deploy_model_params``: quantise, plan, package, on
the engine's device), and generation runs every deployed attention and
MLP projection through ``cim_mvm`` and every attention through
``flash_attention``.  An MoE model (``cfg.n_experts``) deployed under
an expert-axis pipeline (``"mdm_expert"``) serves its expert banks
through ``cim_mvm``'s grouped form, onto ideal devices only: imperfect
devices (and with them ``health``) on an expert partition raise
``NotImplementedError`` at deploy (the folded grouped form is a later
slice).  An xLSTM model serves every sLSTM recurrence
through ``slstm_scan``; its mLSTM q/k/v are deployed but, as in the
reference, served digitally, and ``max_seq`` sizes nothing for it (the
recurrent state is O(1) in the sequence).

The deployment goes through a plan cache (``plan_cache``; by default a
:class:`repro_torch.deploy.PlanCache` at its default root, as in the
reference), so an unchanged checkpoint redeploys from it.  The engine
serves ``cfg.dtype`` (f32 or bf16: activations, parameters and KV
cache; logits f32).

Imperfect devices (``nonideal``, a
:class:`repro_torch.nonideal.NonidealModel`): the cells are drawn at
deployment from ``nonideal_seed``, steered around by the mapping with
``fault_aware``, and folded into the deployments (stuck bits into the
codes, variation and drift into the gain; matrices whose open lines
outran the spares serve digitally).  With ``sigma_read > 0`` every
forward reads the crossbars afresh: forward t of a ``generate(seed)``
call reads with the seed :func:`read_seed` (nonideal_seed, seed, t),
so two calls with one seed give the same tokens.

Lifetime resilience (``health=HealthConfig(...)`` with a non-ideal
``nonideal``): the deploy captures each matrix's lifetime state
(:mod:`repro_torch.deploy.lifetime`) and the engine owns a
:class:`repro_torch.health.HealthController`.  ``advance(dt)`` ages the
devices on the drift clock; ``check_health()`` runs one probe round
(read seed :func:`probe_seed` of (nonideal_seed, round)) and climbs the
remediation ladder.  Each changed (slot, pname) group is swapped in as
a fresh tree, one group at a time (so that at most one group's old and
new gain and fold coexist); ``generate`` takes the tree once at entry,
so a generation keeps the bank it started with.

Greedy decoding is the parity target with the reference
(``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does).
Temperature sampling draws from a ``torch.Generator`` seeded per
``generate`` call; its numbers differ from JAX's, and no parity is
claimed for them.  :func:`sample_tokens_batch` is the row-independent
sampler of continuous batching: a counter-based hash of (request seed,
token count, vocabulary index) gives each row its own Gumbel noise,
the same integers on the CPU and on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.deploy import PlanCache, deploy_model_params, restack_group
from repro_torch.deploy.engine import StageClock, _untimed
from repro_torch.device import check_on, resolve_device
from repro_torch.health import HealthController
from repro_torch.models.model import KERNELS, apply_model, init_decode_state
from repro_torch.nonideal.models import derive_key

_M32 = 0xFFFFFFFF


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """logits (B, V) -> (B,) int32: argmax at temperature <= 0, else one
    categorical draw per row from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) (int64), by 16-bit halves of
    ``c`` so that no product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (lowbias32) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sample_uniforms(seeds: torch.Tensor, counts: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """(B, vocab) f32 uniforms in (0, 1): entry (b, v) is a hash of
    (seeds[b], counts[b], v) alone, exact in integers on any device."""
    s = seeds.to(torch.int64)
    key = _mix32(_mix32((s & _M32) ^ 0x9E3779B9) ^ ((s >> 32) & _M32))
    key = _mix32(key ^ _mix32((counts.to(torch.int64) & _M32)
                              ^ 0x85EBCA6B))
    v = _mix32(torch.arange(vocab, dtype=torch.int64, device=seeds.device)
               ^ 0x632BE5AB)
    h = _mix32(key[:, None] ^ v[None, :])
    return ((h >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def sample_tokens_batch(logits: torch.Tensor, seeds: torch.Tensor,
                        counts: torch.Tensor,
                        temps: torch.Tensor) -> torch.Tensor:
    """Row-independent sampling: logits (B, V), request seeds (B,),
    tokens emitted so far (B,), temperatures (B,) -> (B,) int32.

    Row b's token depends only on its logits row, seed, count and
    temperature (the Gumbel-max trick over :func:`sample_uniforms`), so
    a request's tokens do not depend on its slot or its batchmates.
    Rows with t <= 0 take the argmax."""
    t = temps.to(torch.float32)
    g = -torch.log(-torch.log(sample_uniforms(seeds, counts,
                                              logits.shape[-1])))
    scores = logits.to(torch.float32) / torch.clamp(t, min=1e-6)[:, None] + g
    return torch.where(t > 0.0, scores.argmax(-1),
                       logits.argmax(-1)).to(torch.int32)


def deploy_serving_bank(cfg: ModelConfig, params: dict, plan_cache=None,
                        device: str | torch.device = "cuda", nonideal=None,
                        nonideal_seed: int = 0, fault_aware: bool = True,
                        pipeline=None, timed: bool = False, health=None):
    """Deploy one checkpoint's crossbar bank for serving: (cim, report,
    lifetime, controller); cim and report None unless
    ``cfg.cim.enabled``, lifetime ``{}`` and controller None unless
    ``health`` is armed on a non-ideal ``nonideal`` (ideal devices do
    not age).  Goes through ``plan_cache``, a default
    :class:`repro_torch.deploy.PlanCache` when None, or no cache when
    False, onto the devices ``nonideal`` describes (cells keyed by
    ``nonideal_seed``).  ``timed`` puts each deploy stage's seconds in
    the report (``deploy_model_params``).  The shared init path of
    :class:`ServeEngine` and
    :class:`repro_torch.serve.continuous.ContinuousEngine` (whose async
    redeploy runs it in a background thread)."""
    if not cfg.cim.enabled:
        return None, None, {}, None
    cache = (None if plan_cache is False
             else plan_cache if plan_cache is not None else PlanCache())
    want_health = (health is not None and nonideal is not None
                   and not nonideal.is_ideal)
    lifetime: dict = {}
    cim, report = deploy_model_params(
        params, cfg, cache=cache, device=device, nonideal=nonideal,
        nonideal_key=nonideal_seed, fault_aware=fault_aware,
        pipeline=pipeline, timed=timed,
        lifetime=lifetime if want_health else None)
    controller = HealthController(lifetime, health) if want_health else None
    return cim, report, lifetime, controller


def read_seed(nonideal_seed: int, *counters: int) -> int:
    """The 32-bit crossbar read seed of one forward, a function of the
    deployment's ``nonideal_seed`` and the forward's counters alone."""
    return derive_key(nonideal_seed, 0x5EAD, *counters) & 0xFFFFFFFF


def probe_seed(nonideal_seed: int, round_: int) -> int:
    """The read seed of health probe round ``round_`` (0-based): the
    reference's ``fold_in(fold_in(PRNGKey(nonideal_seed), 9), round)``
    as a derived key, apart from every forward's :func:`read_seed`."""
    return derive_key(nonideal_seed, 9, round_) & 0xFFFFFFFF


def reads_noise(cim, nonideal) -> bool:
    """Does a forward through ``cim`` draw read noise?"""
    return (cim is not None and nonideal is not None
            and nonideal.sigma_read > 0.0)


class ServeEngine:
    """Batched engine: deploy at init, prefill a batch of prompts, decode.

    ``params`` (from ``repro_torch.convert.params_from_numpy`` or
    ``repro_torch.models.model.init_params``) must lie on ``device``;
    the default is the card, and a CPU run has to be asked for.
    ``plan_cache`` is the deployment's :class:`repro_torch.deploy.PlanCache`
    (a default one when None); ``nonideal``, ``nonideal_seed``,
    ``fault_aware`` and ``pipeline`` are the reference's imperfect-device
    and mapping options and ``health`` (a
    :class:`repro_torch.health.HealthConfig`) its lifetime monitoring
    (module docstring).  ``timed_deploy`` records the deploy's stage
    seconds in ``deploy_report["seconds"]`` and the swaps' in
    ``swap_clock.seconds`` ("draw", "gain", "fold"), synchronising the
    device between stages.
    ``ops`` is the triple of kernels every forward calls
    (``repro_torch.models.model.KERNELS``); a copy of the engine with
    ``PLAIN`` there serves the same deployments through the plain
    PyTorch versions, to validate the kernels on the card.
    """

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int = 2048,
                 temperature: float = 0.0, plan_cache=None, nonideal=None,
                 nonideal_seed: int = 0, fault_aware: bool = True,
                 pipeline=None, health=None, timed_deploy: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        check_supported(cfg)
        check_on(self.device, embed=params["embed"],
                 lm_head=params["lm_head"])
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.temperature = temperature
        self.ops = KERNELS
        self.nonideal_seed = int(nonideal_seed)
        self.cim, self.deploy_report, self.lifetime, self.health = \
            deploy_serving_bank(cfg, params, plan_cache, self.device,
                                nonideal, nonideal_seed, fault_aware,
                                pipeline, timed_deploy, health)
        self.read_noise = reads_noise(self.cim, nonideal)
        self.swap_clock = StageClock(self.device) if timed_deploy \
            else _untimed

    # -- lifetime resilience -------------------------------------------

    def _swap(self, dirty: set) -> None:
        """Swap the refreshed groups into the serving tree, one group at
        a time, each as a fresh tree: the old tree is never mutated, so
        a generation holding it keeps a consistent bank."""
        for slot, pname in sorted(dirty):
            cim = {s: dict(sub) for s, sub in self.cim.items()}
            cim[slot][pname] = restack_group(self.lifetime, slot, pname,
                                             self.swap_clock)
            self.cim = cim

    def advance(self, dt: float) -> None:
        """Advance the drift clock by ``dt`` (t0 units): every live
        matrix is re-derived at its new age (same draws, later point on
        the trajectory) and swapped in.  No-op without health."""
        if self.health is not None:
            self._swap(self.health.advance(dt))

    def check_health(self, read_seed: int | None = None):
        """One probe round + remediation pass; returns a HealthReport
        (None without health).  With read noise armed the round reads
        with :func:`probe_seed` (nonideal_seed, round) unless
        ``read_seed`` is given."""
        if self.health is None:
            return None
        if read_seed is None and self.read_noise:
            read_seed = probe_seed(self.nonideal_seed, self.health.rounds)
        self._swap(self.health.probe(read_seed))
        return self.health.report()

    @property
    def health_report(self):
        """Current HealthReport, or None when health is not armed."""
        return None if self.health is None else self.health.report()

    def _read(self, seed: int, t: int) -> int | None:
        """Forward t's read seed under ``generate(seed=seed)``, or None
        when the deployment draws no read noise."""
        return read_seed(self.nonideal_seed, seed, t) if self.read_noise \
            else None

    def _prompts(self, prompts) -> torch.Tensor:
        p = torch.as_tensor(prompts)
        if p.ndim != 2:
            raise ValueError(f"prompts must be (B, S) token ids, got "
                             f"{tuple(p.shape)}")
        return p.to(device=self.device, dtype=torch.int64)

    @torch.no_grad()
    def generate(self, prompts, n_tokens: int,
                 seed: int = 0) -> torch.Tensor:
        """prompts (B, S) token ids -> (B, n_tokens) int32 generated ids.

        The cim tree is taken once at entry (a swap never mutates it).
        With ``health.age_per_token > 0`` the served tokens advance the
        drift clock after the batch."""
        prompts = self._prompts(prompts)
        cim = self.cim
        B = prompts.shape[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = init_decode_state(self.cfg, B, self.max_seq, self.device)
        logits, state = apply_model(self.params, self.cfg, prompts,
                                    state=state, cim=cim, ops=self.ops,
                                    read_seed=self._read(seed, 0))
        tok = sample_tokens(logits[:, -1], self.temperature, gen)
        out = [tok]
        for t in range(1, n_tokens):
            logits, state = apply_model(self.params, self.cfg, tok[:, None],
                                        state=state, decode=True,
                                        cim=cim, ops=self.ops,
                                        read_seed=self._read(seed, t))
            tok = sample_tokens(logits[:, 0], self.temperature, gen)
            out.append(tok)
        if self.health is not None and self.health.cfg.age_per_token > 0.0:
            self.advance(n_tokens * self.health.cfg.age_per_token)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def teacher_forced_logits(self, tokens, n_prompt: int,
                              seed: int = 0) -> torch.Tensor:
        """Per-step logits through the serving path with given tokens.

        Prefills ``tokens[:, :n_prompt]``, then decodes the remaining
        tokens one at a time, reading the crossbars as
        ``generate(seed=seed)`` does.  Returns (B, S - n_prompt + 1, V):
        the prefill's last-position logits, then one row per decode step.
        """
        tokens = self._prompts(tokens)
        cim = self.cim
        B, S = tokens.shape
        state = init_decode_state(self.cfg, B, self.max_seq, self.device)
        logits, state = apply_model(self.params, self.cfg,
                                    tokens[:, :n_prompt], state=state,
                                    cim=cim, ops=self.ops,
                                    read_seed=self._read(seed, 0))
        rows = [logits[:, -1]]
        for t in range(n_prompt, S):
            logits, state = apply_model(self.params, self.cfg,
                                        tokens[:, t:t + 1], state=state,
                                        decode=True, cim=cim,
                                        ops=self.ops,
                                        read_seed=self._read(
                                            seed, t - n_prompt + 1))
            rows.append(logits[:, 0])
        return torch.stack(rows, dim=1)
