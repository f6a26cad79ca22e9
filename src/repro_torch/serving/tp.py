"""Tensor-parallel serving on the JCCL fabric.

``TPServeEngine`` shards a :class:`~repro_torch.serving.engine.ServeEngine`
across the ranks of a :class:`~repro_torch.collectives.JcclWorld`. Every
rank runs the same compute as the single-host engine (replicated
parameters, one engine shared by all ranks), so the model math equals the
single-host engine's by construction; what the fabric adds, and what a
rail fault can therefore corrupt, is the data movement between the shards:

* **logits all-gather**: each rank owns a contiguous vocab slice
  (``JcclWorld.shard_bounds``); the full logits of a step are reassembled
  over the fabric and sampling reads the reconstructed bytes, never the
  local copy, so a lost, duplicated or misordered chunk shows up as a
  wrong token, not a silent pass.
* **per-layer activation all-gathers**: the K/V rows each decode step
  appends to the cache are gathered layer by layer (one concurrent work
  per layer) and checked byte for byte against the locally computed rows.
* **MoE expert all-to-alls**: for ``family == "moe"`` models the first
  layer's K/V row bytes take a dispatch and combine ``all_to_all`` round
  trip (every ordered rank pair carries real payload) and must come back
  unchanged.

The bytes on the wire are the reference's: bf16 logits of (B, 1, V), K/V
rows at the pre-step length clamped to the cache end, all of a layer's K
bytes before its V bytes. All of a step's works are issued before any is
waited on, so a scenario fault lands while several collectives are in
flight. ``world=None`` is pure local compute: that mode is the reference
run the campaign compares tokens against.

Continuous batching (``start_batch`` / ``admit`` / ``decode_batch``): a
prompt is prefilled alone, at its own length, and spliced into its slot
with that length; a decode step advances every slot. A model whose
outputs can depend on later positions (``reads_later_positions``: MoE,
whose expert capacity counts the padding) is prefilled right-padded to
``prefill_len``, as the reference does, since there the padding changes
the result. A free slot decodes a don't-care row and its length keeps
growing, possibly past the end of the cache: the attention sublayer
clamps the write position and the attended length, as the reference
does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.lm import LM
from ..spans import span
from .engine import KV_CACHE_FAMILIES, ServeEngine


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes on the host as flat uint8 (numpy has no bfloat16,
    so the bytes are reinterpreted on the device before the copy)."""
    return t.detach().contiguous().view(torch.uint8).cpu().numpy().reshape(-1)


class TPServeEngine:
    """Rank-sharded serving engine over a ``JcclWorld`` (or local-only).

    ``local`` lets callers share one :class:`ServeEngine` (and its params
    on the device) across many TP engines: the campaign runs one TP engine
    per scenario cell. ``timeout`` bounds every fabric wait in virtual
    seconds.

    ``reconstruction_mismatches`` counts fabric reconstructions whose
    bytes differed from the locally computed truth, the payload-level
    corruption metric the campaign invariants gate on. ``sync_rounds``
    counts synchronization points (one per prefill and decode step).
    ``prefill_positions`` counts the positions the admission prefills ran,
    summed over admissions: each prompt's own length, or ``prefill_len``
    for a model that reads later positions.
    """

    def __init__(self, model: LM, params, world=None, max_len: int = 256,
                 timeout: float = 120.0,
                 local: Optional[ServeEngine] = None, device="cuda"):
        if model.cfg.family not in KV_CACHE_FAMILIES:
            raise ValueError(
                f"tensor-parallel serving requires a KV-cache family "
                f"({'/'.join(KV_CACHE_FAMILIES)}), not "
                f"{model.cfg.family!r}")
        self.device = resolve_device(device)
        self.model = model
        self.max_len = max_len
        self.world = world
        self.timeout = timeout
        self._local = local if local is not None else ServeEngine(
            model, params, max_len=max_len, device=self.device)
        if self._local.max_len != max_len:
            raise ValueError("shared local engine max_len mismatch")
        if self._local.device != self.device:
            raise ValueError("shared local engine device mismatch")
        self.params = self._local.params
        self.sync_rounds = 0
        self.reconstruction_mismatches = 0
        self.prefill_positions = 0
        # continuous-batching state
        self._cache = None
        self._n_slots = 0
        self._prefill_len = 0

    # -- fabric synchronization --------------------------------------------

    def _step_kv_bytes(self, cache, prev_len) -> Dict[str, np.ndarray]:
        """Per-layer bytes of the K/V rows this decode step wrote: the
        cache row at each sequence's pre-step length (scalar or (B,)),
        clamped to the last row, K then V for each layer. The rows are
        picked on the device and only they are copied to the host."""
        k, v = cache["k"], cache["v"]                   # (L, B, S, KV, hd)
        S = k.shape[2]
        if prev_len.dim() == 0:
            at = min(int(prev_len), S - 1)
            rows = torch.stack([k[:, :, at], v[:, :, at]], dim=1)
        else:
            at = prev_len.long().clamp(0, S - 1)
            b = torch.arange(k.shape[1], device=k.device)
            rows = torch.stack([k[:, b, at], v[:, b, at]], dim=1)
        host = _host_bytes(rows).reshape(k.shape[0], -1)  # (L, K and V bytes)
        return {f"kv{layer}": host[layer] for layer in range(k.shape[0])}

    def _expert_dispatch(self, flat: np.ndarray):
        """Launch the MoE expert-dispatch all-to-all carrying the step's
        activation bytes: every rank sends row j of the byte matrix to
        rank j, so each ordered rank pair moves real payload."""
        n = self.world.n_ranks
        width = max(1, -(-flat.size // n))
        mat = np.zeros((n, width), dtype=np.uint8)
        mat.reshape(-1)[:flat.size] = flat
        mats = [mat.copy() for _ in range(n)]
        return mat, self.world.all_to_all_async(
            mats, priority="latency_critical")

    def _expert_combine(self, mat: np.ndarray, dispatch) -> None:
        """Verify the dispatch leg, then run the combine leg (the return
        all-to-all) and verify the round trip restored every byte."""
        outs = dispatch.result()
        n = self.world.n_ranks
        for j in range(n):
            for i in range(n):
                if not np.array_equal(outs[j][i], mat[j]):
                    self.reconstruction_mismatches += 1
        combine = self.world.all_to_all_async([o.copy() for o in outs],
                                              priority="latency_critical")
        self.world.wait_all([combine], timeout=self.timeout)
        for back in combine.result():
            if not np.array_equal(back, mat):
                self.reconstruction_mismatches += 1

    def _sync(self, logits, cache=None, prev_len=None):
        """One step's fabric synchronization point.

        Issues every work of the step before waiting on any of them (the
        logits all-gather, one K/V-row all-gather per layer and, for MoE,
        the expert dispatch), all in the ``latency_critical`` class, so
        their chunks overtake queued bulk traffic at the dispatch queues.
        It then waits for the batch, checks each reconstruction against
        the local bytes and runs the MoE combine leg. Returns the logits
        rebuilt from the fabric's bytes, on the engine's device: the
        sampler only sees what the network delivered. With no world the
        logits are the local ones."""
        self.sync_rounds += 1
        if self.world is None:
            return logits
        with span("serve.fabric"):
            payloads = {"logits": _host_bytes(logits)}
            if cache is not None and prev_len is not None:
                payloads.update(self._step_kv_bytes(cache, prev_len))
            works = {name: self.world.gather_replicated_async(
                         b, priority="latency_critical")
                     for name, b in payloads.items()}
            moe = None
            if self.model.cfg.family == "moe" and "kv0" in payloads:
                moe = self._expert_dispatch(payloads["kv0"])
            batch = list(works.values()) + ([moe[1]] if moe else [])
            self.world.wait_all(batch, timeout=self.timeout)
            for name, b in payloads.items():
                for rec in works[name].result():
                    if not np.array_equal(rec, b):
                        self.reconstruction_mismatches += 1
            if moe is not None:
                self._expert_combine(*moe)
            rec0 = np.array(works["logits"].result()[0])
            return torch.from_numpy(rec0).to(self.device) \
                .view(logits.dtype).view(logits.shape)

    # -- static batch generation -------------------------------------------

    def generate(self, prompts: np.ndarray, n_tokens: int,
                 greedy: bool = True, seed: int = 0,
                 prompt_lens: Optional[np.ndarray] = None) -> np.ndarray:
        """:meth:`ServeEngine.generate` with a fabric synchronization every
        step, sampling from the reconstructed logits. The last decode
        step's logits are never sampled, but its K/V rows still sync."""
        prompts = np.asarray(prompts)
        logits, cache = self._local.start(prompts, n_tokens, prompt_lens)
        rec = self._sync(logits)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = []
        for _ in range(n_tokens):
            nxt = self._local._sample(rec, greedy, gen)
            toks.append(nxt)
            prev_len = cache["len"]
            logits, cache = self._local._decode(cache, nxt[:, None])
            rec = self._sync(logits, cache, prev_len)
        new = torch.stack(toks, dim=1).cpu().numpy() if toks else \
            np.zeros((prompts.shape[0], 0), np.int32)
        return np.concatenate([prompts, new], axis=1)

    # -- continuous batching -----------------------------------------------

    def start_batch(self, n_slots: int, prefill_len: int) -> None:
        """Allocate the slot cache: ``n_slots`` sequences with their own
        lengths, prompts of at most ``prefill_len`` tokens admitted."""
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
        its first token, greedily sampled at its true last position from
        the fabric-reconstructed prefill logits.

        The prefill runs at the prompt's own length n: padding would
        change no real position's outputs, and a decode step writes each
        of the slot's rows from n on before one reads it. A model that
        ``reads_later_positions`` is prefilled right-padded to
        ``prefill_len``."""
        if self._cache is None:
            raise RuntimeError("start_batch() before admit()")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        n = prompt.size
        if not 1 <= n <= self._prefill_len:
            raise ValueError(f"prompt length {n} outside "
                             f"[1, {self._prefill_len}]")
        tokens = prompt[None]
        if self.model.reads_later_positions:
            tokens = np.zeros((1, self._prefill_len), np.int32)
            tokens[0, :n] = prompt
        with span("serve.admit.prefill"):
            logits, pcache = self._local._prefill(tokens, last_pos=[n - 1])
        self.prefill_positions += tokens.shape[1]
        with span("serve.admit.splice"):
            c = self._cache
            c["k"][:, slot] = pcache["k"][:, 0]
            c["v"][:, slot] = pcache["v"][:, 0]
            c["len"][slot] = n
        rec = self._sync(logits)
        with span("serve.admit.readback"):
            return int(rec[0, -1].argmax())

    def decode_batch(self, feed: np.ndarray) -> np.ndarray:
        """One decode step over every slot; ``feed`` is the (n_slots,)
        token vector (free slots carry don't-care tokens). Returns the
        (n_slots,) greedy next tokens from the fabric-reconstructed
        logits."""
        if self._cache is None:
            raise RuntimeError("start_batch() before decode_batch()")
        feed = np.asarray(feed, dtype=np.int32).reshape(-1)
        if feed.size != self._n_slots:
            raise ValueError(f"feed size {feed.size} != {self._n_slots}")
        with span("serve.decode.feed"):
            tokens = torch.as_tensor(feed, device=self.device)[:, None]
        prev_len = self._cache["len"]
        with span("serve.decode.step"):
            logits, self._cache = self._local._decode(self._cache, tokens)
        rec = self._sync(logits, self._cache, prev_len)
        with span("serve.decode.readback"):
            return rec[:, -1].argmax(dim=-1).to(torch.int32).cpu().numpy()
