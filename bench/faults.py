"""Faults planted underneath a run, to show that ``correct`` comes out
false: each patches an entry point of the program for the length of a
``with`` block. Used by the CPU tests and by ``bench/calibrate.py`` (the
benchmark's own runs plant nothing)."""

from __future__ import annotations

import contextlib

import numpy as np

import repro_torch.launch as launch
from repro_torch.serving import tp


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _train_step(wrap):
    def make(original):
        def make_train_step(model, opt):
            return wrap(original(model, opt))
        return make_train_step
    return _patched(launch, "make_train_step", make)


def train_half_batch():
    """Every step sees the first half of its rows, the mean over those."""
    def wrap(step):
        def half(params, state, batch):
            tokens = batch["tokens"]
            return step(params, state,
                        {"tokens": tokens[:max(tokens.shape[0] // 2, 1)]})
        return half
    return _train_step(wrap)


def train_unchanged():
    """Every step returns the params and optimizer state it was given."""
    def wrap(step):
        def unchanged(params, state, batch):
            _, _, metrics = step(params, state, batch)
            return params, state, metrics
        return unchanged
    return _train_step(wrap)


def serve_token_altered(every: int = 8):
    """Every slot's token of every ``every``-th decode step is changed
    where it is made."""
    def make(original):
        calls = [0]

        def decode_batch(self, feed):
            out = np.array(original(self, feed))
            calls[0] += 1
            if calls[0] % every == 0:
                out = (out + 1) % self.model.cfg.vocab
            return out.astype(np.int32)
        return decode_batch
    return _patched(tp.TPServeEngine, "decode_batch", make)


def serve_half_batch():
    """Every decode step leaves half of the slots out (fed token 0), the
    second half on odd steps and the first on even ones."""
    def make(original):
        calls = [0]

        def decode_batch(self, feed):
            feed = np.array(feed)
            half = len(feed) // 2
            calls[0] += 1
            if calls[0] % 2:
                feed[half:] = 0
            else:
                feed[:half] = 0
            return original(self, feed)
        return decode_batch
    return _patched(tp.TPServeEngine, "decode_batch", make)


def serve_unchanged():
    """Every decode step leaves the cache's lengths as they were."""
    def make(original):
        def decode_batch(self, feed):
            lens = self._cache["len"].clone()
            out = original(self, feed)
            self._cache["len"] = lens
            return out
        return decode_batch
    return _patched(tp.TPServeEngine, "decode_batch", make)


FAULTS = {"train.half_batch": train_half_batch,
          "train.unchanged": train_unchanged,
          "serve.token_altered": serve_token_altered,
          "serve.half_batch": serve_half_batch,
          "serve.unchanged": serve_unchanged}
