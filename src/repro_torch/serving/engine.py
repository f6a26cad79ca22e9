"""Batched serving: prefill + decode loop over the model's KV cache."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.lm import LM, serving_params

# the families whose cache is K/V rows, with a per-row append position:
# the reference's dense/audio/moe. The vlm family's grouped cache has none
# (it serves uniform batches through generate, with zero images, as the
# reference's engine does), nor has the recurrent state of hybrid and rwkv6
KV_CACHE_FAMILIES = ("dense", "audio", "moe")


class ServeEngine:
    """Single-host batched generation (also the local compute of
    :class:`~repro_torch.serving.tp.TPServeEngine`).

    Holds the params on ``device`` with the matmul weights cast once to
    ``cfg.dtype`` (see :func:`~repro_torch.models.lm.serving_params`)."""

    def __init__(self, model: LM, params, max_len: int = 256,
                 device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.params = serving_params(params, model.cfg, self.device)
        self.max_len = max_len

    def _prefill(self, prompts, last_pos=None):
        return self.model.prefill(self.params, prompts, max_len=self.max_len,
                                  last_pos=last_pos)

    def _decode(self, cache, tokens):
        return self.model.decode_step(self.params, cache, tokens)

    def _sample(self, logits, greedy: bool, gen: torch.Generator):
        """(B,) int32 tokens from (B, 1, V) logits; greedy is argmax (the
        first maximum on ties) and ignores ``gen``."""
        last = logits[:, -1]
        if greedy:
            return last.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(last.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    def start(self, prompts: np.ndarray, n_tokens: int,
              prompt_lens: Optional[np.ndarray] = None):
        """Check a generate request and prefill it: (logits, cache)."""
        B, S = prompts.shape
        if S + n_tokens > self.max_len:
            raise ValueError(
                f"prompt ({S}) + generation ({n_tokens}) tokens exceed "
                f"max_len={self.max_len}")
        if prompt_lens is None:
            return self._prefill(prompts)
        prompt_lens = np.asarray(prompt_lens, dtype=np.int32)
        if prompt_lens.shape != (B,):
            raise ValueError(f"prompt_lens shape {prompt_lens.shape} "
                             f"!= ({B},)")
        if (prompt_lens < 1).any() or (prompt_lens > S).any():
            raise ValueError("prompt_lens must be in [1, S]")
        if self.model.cfg.family not in KV_CACHE_FAMILIES:
            raise ValueError(
                f"ragged prompts are not supported for family "
                f"{self.model.cfg.family!r} (recurrent state cannot mask "
                f"pad positions)")
        return self._prefill(prompts, last_pos=prompt_lens - 1)

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 greedy: bool = True, seed: int = 0,
                 prompt_lens: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts: (B, S) int32 -> (B, S + n_tokens) generations.

        ``prompt_lens`` (optional, (B,) ints) marks right-padded ragged
        prompts: each sequence samples its first token at its true last
        prompt position and decodes with its own cache length. Sampling
        (``greedy=False``) draws from a torch.Generator seeded with
        ``seed``; its tokens are not the reference's."""
        prompts = np.asarray(prompts)
        logits, cache = self.start(prompts, n_tokens, prompt_lens)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = []
        for _ in range(n_tokens):
            nxt = self._sample(logits, greedy, gen)
            toks.append(nxt)
            logits, cache = self._decode(cache, nxt[:, None])
        new = torch.stack(toks, dim=1).cpu().numpy() if toks else \
            np.zeros((prompts.shape[0], 0), np.int32)
        return np.concatenate([prompts, new], axis=1)
