"""Composable device-nonideality models for memristive bit cells.

Port of ``repro.nonideal.models``.  Every nonideality is a perturbation
of the per-cell conductance field of a deployed tile population:
stuck-at faults, log-normal programming variation (i.i.d. and
spatially correlated), per-read noise, power-law drift, stochastic
relaxation, and wordline / bitline opens.  The :class:`NonidealModel`
record, its validation and its lifetime helpers are the reference's.

**Random draws.**  JAX's ``fold_in`` key streams cannot be reproduced
in torch, so the samplers take an integer ``key`` and derive one
``torch.Generator`` a term from (key, term tag) with the reference's
tags (stuck 0, program 1, read 2, line 3, corr 4, relax 5; line opens
take sub-tags 0 for wordlines and 1 for bitlines).  Enabling or
re-rating one term therefore never reshuffles another's draws, the
reference's composition contract.  A draw is a function of (key, term,
device): the CPU and the card give different numbers, each
deterministic.  Parity with the reference moves its sampled cells
across (``repro_torch.deploy.deploy_model_params(cells=...)``) or holds
the samplers to statistics.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

# Cell-state codes of a fault map (int8), in physical tile coordinates
# (ti, tn, row, col).  OPEN: the cell sits on a severed line and conducts
# nothing; it overrides any stuck state.
HEALTHY, STUCK_OFF, STUCK_ON, OPEN = 0, 1, 2, 3

# The reference's per-term tags.
TAG_STUCK, TAG_PROGRAM, TAG_READ = 0, 1, 2
TAG_LINE, TAG_CORR, TAG_RELAX = 3, 4, 5


@dataclasses.dataclass(frozen=True)
class NonidealModel:
    """One composable device-nonideality scenario (hashable).  Every
    field defaults to "off", so ``NonidealModel()`` is the ideal device
    and any subset of terms composes."""

    p_stuck_off: float = 0.0    # stuck-at-OFF (HRS) cell rate
    p_stuck_on: float = 0.0     # stuck-at-ON (LRS) cell rate
    sigma_program: float = 0.0  # log-normal programming spread (of ln g)
    sigma_read: float = 0.0     # additive read noise, in units of g_on
    drift_nu: float = 0.0       # power-law ON-conductance drift exponent
    drift_time: float = 1.0     # read time / programming time t0
    p_open_wordline: float = 0.0  # whole-row (wordline) open rate
    p_open_bitline: float = 0.0   # whole-column (bitline) open rate
    sigma_corr: float = 0.0     # correlated log-normal spread (of ln g)
    corr_length: float = 4.0    # Gaussian correlation length, in cells
    sigma_relax: float = 0.0    # relaxation spread of ln g per sqrt(ln t)

    def __post_init__(self):
        for name in ("p_stuck_off", "p_stuck_on", "p_open_wordline",
                     "p_open_bitline"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"{name}={p!r} must be a probability in [0, 1]")
        for name in ("sigma_program", "sigma_read", "sigma_corr",
                     "sigma_relax", "drift_nu"):
            s = getattr(self, name)
            if not s >= 0.0:   # rejects negatives *and* NaN
                raise ValueError(f"{name}={s!r} must be >= 0")
        if self.p_stuck_off + self.p_stuck_on > 1.0:
            raise ValueError("p_stuck_off + p_stuck_on > 1")
        if not self.drift_time > 0.0:
            raise ValueError(
                f"drift_time={self.drift_time!r} must be > 0 "
                "(time in units of the programming time t0)")
        if self.corr_length < 1.0:
            raise ValueError(
                f"corr_length={self.corr_length!r} must be >= 1 cell")

    @property
    def drift_factor(self) -> float:
        """Multiplier on the ON-state conductance at ``drift_time``."""
        return self.drift_factor_at(self.drift_time)

    def drift_factor_at(self, age: float) -> float:
        """Power-law ON-conductance multiplier at runtime ``age`` (in
        units of t0; ages below 1 clamp to 1)."""
        if self.drift_nu == 0.0:
            return 1.0
        return float(max(float(age), 1.0) ** -self.drift_nu)

    def relax_sigma_at(self, age: float) -> float:
        """Spread of the relaxation term of ln g at ``age``:
        ``sigma_relax * sqrt(ln age)``, zero at age <= 1."""
        if self.sigma_relax == 0.0:
            return 0.0
        return float(self.sigma_relax
                     * math.sqrt(max(math.log(float(age)), 0.0)))

    @property
    def has_aging(self) -> bool:
        """Does any term change as the runtime age clock advances?"""
        return self.drift_nu > 0.0 or self.sigma_relax > 0.0

    @property
    def has_line_opens(self) -> bool:
        return self.p_open_wordline > 0.0 or self.p_open_bitline > 0.0

    @property
    def is_ideal(self) -> bool:
        return (self.p_stuck_off == 0.0 and self.p_stuck_on == 0.0
                and self.sigma_program == 0.0 and self.sigma_read == 0.0
                and self.drift_nu == 0.0 and not self.has_line_opens
                and self.sigma_corr == 0.0 and self.sigma_relax == 0.0)


class CellSample(NamedTuple):
    """One drawn realisation of the per-cell device state: int8 cell
    codes, f32 programming gains (1 where sigma = 0), an f32 standard
    normal read draw (0 where sigma_read = 0, or None where not drawn)
    and the fixed unit-normal relaxation draw (or None)."""

    stuck: torch.Tensor
    gamma: torch.Tensor
    read: torch.Tensor | None
    relax: torch.Tensor | None = None


def derive_key(key: int, *tags: int) -> int:
    """A 63-bit key from ``key`` and a path of tags (the port's
    ``fold_in``): a blake2b digest, the same on every machine."""
    h = hashlib.blake2b(repr((int(key),) + tuple(int(t) for t in tags))
                        .encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(key: int, *tags: int, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (key, tags)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(derive_key(key, *tags))
    return g


def sample_stuck(key: int, shape, p_stuck_off: float, p_stuck_on: float,
                 device="cuda") -> torch.Tensor:
    """Mutually exclusive stuck-at codes from one uniform draw."""
    device = resolve_device(device)
    u = torch.rand(shape, generator=generator(key, device=device),
                   device=device)
    out = torch.full(shape, HEALTHY, dtype=torch.int8, device=device)
    out[u < p_stuck_off + p_stuck_on] = STUCK_ON
    out[u < p_stuck_off] = STUCK_OFF
    return out


def sample_line_open(key: int, shape, p_open_wordline: float,
                     p_open_bitline: float, device="cuda") -> torch.Tensor:
    """OPEN codes for a (..., rows, cols) population: one uniform a
    wordline and one a bitline a tile (sub-tags 0 and 1 off ``key``)."""
    device = resolve_device(device)
    rows, cols = shape[-2], shape[-1]
    lead = tuple(shape[:-2])
    wl = torch.rand(lead + (rows,), generator=generator(key, 0, device=device),
                    device=device) < p_open_wordline
    bl = torch.rand(lead + (cols,), generator=generator(key, 1, device=device),
                    device=device) < p_open_bitline
    open_ = wl[..., :, None] | bl[..., None, :]
    return torch.where(open_, OPEN, HEALTHY).to(torch.int8)


def _smooth_matrix(n: int, corr_length: float, device) -> torch.Tensor:
    d = torch.arange(n, dtype=torch.float32, device=device)
    a = torch.exp(-0.5 * ((d[:, None] - d[None, :])
                          / torch.tensor(corr_length, dtype=torch.float32,
                                         device=device)) ** 2)
    return a / torch.sqrt((a * a).sum(1, keepdim=True))


def sample_corr_field(key: int, shape, corr_length: float,
                      device="cuda") -> torch.Tensor:
    """Unit-variance Gaussian field, smooth over each tile's (rows, cols):
    white noise filtered with L2-row-normalised separable Gaussians of
    length ``corr_length`` cells, so every cell stays N(0, 1)."""
    device = resolve_device(device)
    rows, cols = shape[-2], shape[-1]
    eps = torch.randn(shape, generator=generator(key, device=device),
                      device=device)
    return torch.einsum("Jj,...jk,Kk->...JK",
                        _smooth_matrix(rows, corr_length, device), eps,
                        _smooth_matrix(cols, corr_length, device))


def sample_stuck_state(key: int, shape, model: NonidealModel,
                       device="cuda") -> torch.Tensor:
    """The structural part of :func:`sample_cell_state`: stuck-at codes
    (tag 0) with line opens (tag 3) overriding them, int8."""
    device = resolve_device(device)
    shape = tuple(shape)
    if model.p_stuck_off > 0.0 or model.p_stuck_on > 0.0:
        stuck = sample_stuck(derive_key(key, TAG_STUCK), shape,
                             model.p_stuck_off, model.p_stuck_on, device)
    else:
        stuck = torch.zeros(shape, dtype=torch.int8, device=device)
    if model.has_line_opens:
        line = sample_line_open(derive_key(key, TAG_LINE), shape,
                                model.p_open_wordline, model.p_open_bitline,
                                device)
        stuck = torch.where(line == OPEN, line, stuck)
    return stuck


def sample_cell_state(key: int, shape, model: NonidealModel,
                      stuck: torch.Tensor | None = None, device="cuda",
                      read: bool = True) -> CellSample:
    """Draw one :class:`CellSample` for a cell population of ``shape``.

    Each term draws from its own generator (the reference's tags), so
    one term's draws never depend on another's rate.  Zero-rate terms
    draw nothing and return the identity field.  ``stuck`` pins a known
    fault map (line opens are then the caller's, as in the reference).
    ``read=False`` skips the read-noise draw (``read`` is then None):
    a deployment applies read noise a read, in the kernel.
    """
    device = resolve_device(device)
    shape = tuple(shape)
    if stuck is None:
        stuck = sample_stuck_state(key, shape, model, device)
    else:
        stuck = torch.as_tensor(stuck, dtype=torch.int8,
                                device=device).expand(shape)
    if model.sigma_program > 0.0:
        gamma = torch.exp(model.sigma_program * torch.randn(
            shape, generator=generator(key, TAG_PROGRAM, device=device),
            device=device))
    else:
        gamma = torch.ones(shape, dtype=torch.float32, device=device)
    if model.sigma_corr > 0.0:
        gamma = gamma * torch.exp(model.sigma_corr * sample_corr_field(
            derive_key(key, TAG_CORR), shape, model.corr_length, device))
    if not read:
        noise = None
    elif model.sigma_read > 0.0:
        noise = torch.randn(shape, generator=generator(key, TAG_READ,
                                                       device=device),
                            device=device)
    else:
        noise = torch.zeros(shape, dtype=torch.float32, device=device)
    relax = (torch.randn(shape, generator=generator(key, TAG_RELAX,
                                                    device=device),
                         device=device)
             if model.sigma_relax > 0.0 else None)
    return CellSample(stuck, gamma, noise, relax)


def cell_values(bits: torch.Tensor, stuck: torch.Tensor,
                gamma: torch.Tensor, model: NonidealModel | None = None,
                age: float | None = None) -> torch.Tensor:
    """Analog cell values for the Eq-17 evaluator: stuck-ON -> 1,
    stuck-OFF and OPEN -> 0, healthy -> drift * gamma * b (all
    arguments broadcast; ``age`` evaluates drift at a runtime clock)."""
    if model is None:
        drift = 1.0
    else:
        drift = model.drift_factor_at(
            model.drift_time if age is None else age)
    c = bits.to(torch.float32) * gamma * torch.tensor(
        drift, dtype=torch.float32, device=bits.device)
    c = torch.where(stuck == STUCK_ON, 1.0, c)
    return torch.where((stuck == STUCK_OFF) | (stuck == OPEN), 0.0, c)


def conductances_from_masks(active: torch.Tensor,
                            spec) -> torch.Tensor:
    """Clean (intended) conductance field of activity masks, f32 [S]."""
    on = torch.tensor(1.0 / spec.r_on, dtype=torch.float32,
                      device=active.device)
    off = torch.tensor(1.0 / spec.r_off, dtype=torch.float32,
                       device=active.device)
    return torch.where(active > 0, on, off)


def apply_to_conductances(active: torch.Tensor, sample: CellSample, spec,
                          model: NonidealModel,
                          age: float | None = None) -> torch.Tensor:
    """Perturbed conductance field (f32) of a tile population.

    ``active`` (..., J, K) holds the clean masks; the sample's fields
    broadcast against it (the Monte-Carlo engine passes (S, T, J, K)
    samples against (T, J, K) masks).  Drift scales what was programmed,
    variation spreads it, stuck cells override everything, read noise
    perturbs what is read back; conductances clip at 0 (the solver's
    operator stays positive semi-definite) and OPEN cells conduct
    nothing.  ``age`` evaluates drift and relaxation at a runtime clock
    instead of ``model.drift_time``."""
    t = model.drift_time if age is None else age
    f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=active.device)
    g_on, g_off = f32(1.0 / spec.r_on), f32(1.0 / spec.r_off)
    g = torch.where(active > 0, g_on * f32(model.drift_factor_at(t)), g_off)
    g = g * sample.gamma
    s_relax = model.relax_sigma_at(t)
    if sample.relax is not None and s_relax > 0.0:
        g = g * torch.exp(f32(s_relax) * sample.relax)
    g = torch.where(sample.stuck == STUCK_ON, g_on, g)
    g = torch.where(sample.stuck == STUCK_OFF, g_off, g)
    if model.sigma_read > 0.0:
        g = g + f32(model.sigma_read) * g_on * sample.read
    g = g.clamp_min(0.0)
    return torch.where(sample.stuck == OPEN, f32(0.0), g)
