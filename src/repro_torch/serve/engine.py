"""Serving: prefill + batched autoregressive decode over ring-buffer
caches, with greedy or temperature sampling.

Port of ``repro.serve.engine.ServeEngine``.  With ``cfg.cim.enabled`` the
engine deploys every projection matrix onto crossbars at init
(``repro_torch.deploy.deploy_model_params``: quantise, plan, package, on
the engine's device), and generation runs every deployed attention and
MLP projection through ``cim_mvm`` and every attention through
``flash_attention``.  An xLSTM model serves every sLSTM recurrence
through ``slstm_scan``; its mLSTM q/k/v are deployed but, as in the
reference, served digitally, and ``max_seq`` sizes nothing for it (the
recurrent state is O(1) in the sequence).

Greedy decoding is the parity target with the reference
(``torch.argmax`` returns the first maximum, as ``jnp.argmax`` does).
Temperature sampling draws from a ``torch.Generator`` seeded per
``generate`` call; its numbers differ from JAX's, and no parity is
claimed for them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.device import check_on, resolve_device
from repro_torch.models.model import KERNELS, apply_model, init_decode_state


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """logits (B, V) -> (B,) int32: argmax at temperature <= 0, else one
    categorical draw per row from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class ServeEngine:
    """Batched engine: deploy at init, prefill a batch of prompts, decode.

    ``params`` (from ``repro_torch.convert.params_from_numpy`` or
    ``repro_torch.models.model.init_params``) must lie on ``device``;
    the default is the card, and a CPU run has to be asked for.
    ``ops`` is the triple of kernels every forward calls
    (``repro_torch.models.model.KERNELS``); a copy of the engine with
    ``PLAIN`` there serves the same deployments through the plain
    PyTorch versions, to validate the kernels on the card.
    """

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int = 2048,
                 temperature: float = 0.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        check_supported(cfg)
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"dtype={cfg.dtype!r}: the port's kernels serve float32")
        check_on(self.device, embed=params["embed"],
                 lm_head=params["lm_head"])
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.temperature = temperature
        self.ops = KERNELS
        self.cim, self.deploy_report = None, None
        if cfg.cim.enabled:
            from repro_torch.deploy import deploy_model_params

            self.cim, self.deploy_report = deploy_model_params(
                params, cfg, device=self.device)

    def _prompts(self, prompts) -> torch.Tensor:
        p = torch.as_tensor(prompts)
        if p.ndim != 2:
            raise ValueError(f"prompts must be (B, S) token ids, got "
                             f"{tuple(p.shape)}")
        return p.to(device=self.device, dtype=torch.int64)

    @torch.no_grad()
    def generate(self, prompts, n_tokens: int,
                 seed: int = 0) -> torch.Tensor:
        """prompts (B, S) token ids -> (B, n_tokens) int32 generated ids."""
        prompts = self._prompts(prompts)
        B = prompts.shape[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = init_decode_state(self.cfg, B, self.max_seq, self.device)
        logits, state = apply_model(self.params, self.cfg, prompts,
                                    state=state, cim=self.cim, ops=self.ops)
        tok = sample_tokens(logits[:, -1], self.temperature, gen)
        out = [tok]
        for _ in range(n_tokens - 1):
            logits, state = apply_model(self.params, self.cfg, tok[:, None],
                                        state=state, decode=True,
                                        cim=self.cim, ops=self.ops)
            tok = sample_tokens(logits[:, 0], self.temperature, gen)
            out.append(tok)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def teacher_forced_logits(self, tokens,
                              n_prompt: int) -> torch.Tensor:
        """Per-step logits through the serving path with given tokens.

        Prefills ``tokens[:, :n_prompt]``, then decodes the remaining
        tokens one at a time.  Returns (B, S - n_prompt + 1, V): the
        prefill's last-position logits, then one row per decode step.
        """
        tokens = self._prompts(tokens)
        B, S = tokens.shape
        state = init_decode_state(self.cfg, B, self.max_seq, self.device)
        logits, state = apply_model(self.params, self.cfg,
                                    tokens[:, :n_prompt], state=state,
                                    cim=self.cim, ops=self.ops)
        rows = [logits[:, -1]]
        for t in range(n_prompt, S):
            logits, state = apply_model(self.params, self.cfg,
                                        tokens[:, t:t + 1], state=state,
                                        decode=True, cim=self.cim,
                                        ops=self.ops)
            rows.append(logits[:, 0])
        return torch.stack(rows, dim=1)
