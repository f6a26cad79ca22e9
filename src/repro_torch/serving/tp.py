"""Tensor-parallel serving engine, local mode.

``TPServeEngine`` is the reference's rank-sharded engine with ``world=None``:
the same compute as :class:`~repro_torch.serving.engine.ServeEngine`, one
synchronization point (``sync_rounds``) per prefill and decode step, and
the slot cache of continuous batching (``start_batch`` / ``admit`` /
``decode_batch``). Serving over a ``JcclWorld``, which carries logits and
K/V rows between ranks on the port's fabric, is not ported yet (ROADMAP
A14, after MoE, A12), so any ``world`` raises.

Continuous batching: a prompt is right-padded to ``prefill_len``, prefilled
alone and spliced into its slot with its own length; a decode step advances
every slot. A free slot decodes a don't-care row and its length keeps
growing, possibly past the end of the cache: the attention sublayer clamps
the write position and the attended length, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.lm import LM
from .engine import ServeEngine


class TPServeEngine:
    """Rank-sharded serving engine; this port runs the local mode only."""

    def __init__(self, model: LM, params, world=None, max_len: int = 256,
                 local: Optional[ServeEngine] = None, device="cuda"):
        if model.cfg.family != "dense":
            raise ValueError(
                f"tensor-parallel serving requires a KV-cache family "
                f"(dense), not {model.cfg.family!r}")
        if world is not None:
            raise NotImplementedError(
                "TPServeEngine over a JcclWorld (serving on the port's "
                "fabric) is not ported yet (ROADMAP A14, after MoE, A12); "
                "pass world=None")
        self.device = resolve_device(device)
        self.model = model
        self.max_len = max_len
        self._local = local if local is not None else ServeEngine(
            model, params, max_len=max_len, device=self.device)
        if self._local.max_len != max_len:
            raise ValueError("shared local engine max_len mismatch")
        if self._local.device != self.device:
            raise ValueError("shared local engine device mismatch")
        self.params = self._local.params
        self.sync_rounds = 0
        # continuous-batching state
        self._cache = None
        self._n_slots = 0
        self._prefill_len = 0

    def _sync(self, logits):
        """One step's synchronization point. With no world the logits are
        the local ones."""
        self.sync_rounds += 1
        return logits

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 greedy: bool = True, seed: int = 0,
                 prompt_lens: Optional[np.ndarray] = None) -> np.ndarray:
        """:meth:`ServeEngine.generate` with a synchronization per step."""
        prompts = np.asarray(prompts)
        logits, cache = self._local.start(prompts, n_tokens, prompt_lens)
        rec = self._sync(logits)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = []
        for _ in range(n_tokens):
            nxt = self._local._sample(rec, greedy, gen)
            toks.append(nxt)
            logits, cache = self._local._decode(cache, nxt[:, None])
            rec = self._sync(logits)
        new = torch.stack(toks, dim=1).cpu().numpy() if toks else \
            np.zeros((prompts.shape[0], 0), np.int32)
        return np.concatenate([prompts, new], axis=1)

    def start_batch(self, n_slots: int, prefill_len: int) -> None:
        """Allocate the slot cache: ``n_slots`` sequences with their own
        lengths, prompts admitted right-padded to ``prefill_len``."""
        if not 1 <= prefill_len <= self.max_len:
            raise ValueError("prefill_len must be in [1, max_len]")
        cache = self.model.init_cache(n_slots, self.max_len)
        cache["len"] = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device)
        self._cache = cache
        self._n_slots = n_slots
        self._prefill_len = prefill_len

    def admit(self, slot: int, prompt: np.ndarray) -> int:
        """Prefill one request alone and splice it into ``slot``; returns
        its first token, greedily sampled at its true last position."""
        if self._cache is None:
            raise RuntimeError("start_batch() before admit()")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        n = prompt.size
        if not 1 <= n <= self._prefill_len:
            raise ValueError(f"prompt length {n} outside "
                             f"[1, {self._prefill_len}]")
        padded = np.zeros((1, self._prefill_len), np.int32)
        padded[0, :n] = prompt
        logits, pcache = self._local._prefill(padded, last_pos=[n - 1])
        c = self._cache
        c["k"][:, slot] = pcache["k"][:, 0]
        c["v"][:, slot] = pcache["v"][:, 0]
        c["len"][slot] = n
        rec = self._sync(logits)
        return int(rec[0, -1].argmax())

    def decode_batch(self, feed: np.ndarray) -> np.ndarray:
        """One decode step over every slot; ``feed`` is the (n_slots,)
        token vector (free slots carry don't-care tokens). Returns the
        (n_slots,) greedy next tokens."""
        if self._cache is None:
            raise RuntimeError("start_batch() before decode_batch()")
        feed = np.asarray(feed, dtype=np.int32).reshape(-1)
        if feed.size != self._n_slots:
            raise ValueError(f"feed size {feed.size} != {self._n_slots}")
        tokens = torch.as_tensor(feed, device=self.device)[:, None]
        logits, self._cache = self._local._decode(self._cache, tokens)
        rec = self._sync(logits)
        return rec[:, -1].argmax(dim=-1).to(torch.int32).cpu().numpy()
