"""Atomic (+optionally async) checkpointing of parameter/optimizer trees.

The port's own copy of the reference's checkpoint store, on nested dicts
of tensors (or numpy arrays) walked in :func:`repro_torch.models.lm.flatten`
order: keys joined with ``/`` and sorted at every level, which is the
order and the key set of ``jax.tree_util`` on the same dicts. The on-disk
format is the reference's, byte for byte: ``state.npz`` with those keys,
``meta.json``, and the ``committed`` marker, so a checkpoint written by
either package restores in the other. numpy has no bfloat16, so a
bfloat16 tensor is written as float32, which holds it exactly, and read
back in its template's dtype.

Writes are crash-safe end to end:

* **Publish** — a temp directory is populated (``state.npz``, ``meta.json``,
  then a ``committed`` marker written LAST) and atomically renamed, so a
  failure mid-checkpoint can never corrupt the latest restorable state.
* **Visibility** — ``list_steps``/``restore`` only count directories that
  carry the ``committed`` marker: a directory torn by a crash mid-write
  or mid-delete is invisible, never half-restored.
* **Deletion** (GC and same-step overwrite) unlinks the marker FIRST and
  removes the tree second — a crash between the two leaves an unmarked
  (invisible) directory, not a torn checkpoint that ``restore()`` would
  load.
* **Async writers are non-daemon threads**: a process that exits without
  calling ``wait()`` still joins the writer at interpreter shutdown, so
  ``save(async_save=True)`` + exit cannot kill the write mid-``np.savez``.

Supports the paper's §4.4 optimization: ``checkpoint promptly after
fallback`` — the trainer calls ``save(..., reason="post-fallback")`` as
soon as SHIFT reports a fallback, bounding progress loss under degraded
throughput.

When a :class:`~repro_torch.collectives.JcclWorld` is attached via
:meth:`CheckpointStore.attach_world`, every ``save()`` additionally
streams the first ``stream_limit`` bytes of the checkpoint over the
fabric as a **background-class** broadcast. Background is the lowest
latency class: the stream yields to both latency-critical serving works
and bulk gradient buckets at the channel dispatch queues (DESIGN.md §10).
The stream is best-effort — the checkpoint is already durably committed
to local disk before the broadcast is issued, so ``drain_stream()``
swallows ``CollectiveError`` from a fabric that died mid-replication.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.lm import flatten, unflatten

_MARKER = "committed"


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array (a tensor is copied to the host; bfloat16
    becomes float32, which holds it exactly)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in flatten(tree)}


class CheckpointStore:
    """Crash-safe checkpoint directory with optional async writes and
    optional background-class fabric replication (see module docstring).

    ``stream_limit`` caps the bytes any single ``save()`` puts on the
    fabric — replication is a smoke signal for the scheduler's
    background class, not a byte-complete remote copy."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = False,
                 stream_limit: int = 1 << 16):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.stream_limit = stream_limit
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._world = None
        self._stream: List[Any] = []
        self.streamed_saves = 0
        self.streamed_bytes = 0
        os.makedirs(root, exist_ok=True)

    # -- background fabric replication ---------------------------------
    def attach_world(self, world) -> None:
        """Replicate future saves over ``world`` as background-class
        broadcasts. Any stream works issued against a previously
        attached world are dropped unwaited (that world may be dead)."""
        self._world = world
        self._stream = []

    def _stream_background(self, flat: Dict[str, np.ndarray]) -> None:
        """Issue (not wait) one background broadcast of the first
        ``stream_limit`` bytes of the checkpoint, in key order. Runs on
        the CALLER's thread — the simulated fabric is single-threaded —
        and never raises: local durability must not depend on fabric
        health."""
        world = self._world
        if world is None or getattr(world, "failed", False):
            return
        # only the prefix that goes on the wire is gathered: the same
        # bytes as joining every leaf and cutting, without copying a
        # full-width state to take its first 64 KiB
        parts, have = [], 0
        for a in flat.values():
            if have >= self.stream_limit:
                break
            part = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            parts.append(part[:self.stream_limit - have])
            have += parts[-1].size
        blob = np.concatenate(parts) if parts else np.zeros(1, np.uint8)
        blob = np.ascontiguousarray(blob[:self.stream_limit])
        try:
            work = world.broadcast_async(blob, root=0,
                                         priority="background")
        except Exception:
            return
        self._stream.append(work)
        self.streamed_saves += 1
        self.streamed_bytes += int(blob.nbytes)

    def drain_stream(self, timeout: Optional[float] = None) -> int:
        """Wait out the in-flight replication works; returns how many
        completed. ``CollectiveError`` (fabric died mid-stream) is
        swallowed — the checkpoints are already committed locally."""
        from ..collectives import CollectiveError

        works, self._stream = self._stream, []
        done = 0
        for w in works:
            try:
                w.wait(timeout)
                done += 1
            except CollectiveError:
                pass
        return done

    # ------------------------------------------------------------------
    def _remove(self, final: str) -> None:
        """Delete a checkpoint directory crash-safely: unlink the commit
        marker FIRST (atomic — the checkpoint becomes invisible), then
        remove the tree. A crash anywhere in between leaves an unmarked
        directory that ``list_steps`` ignores and a later save for the
        same step simply clears."""
        try:
            os.unlink(os.path.join(final, _MARKER))
        except FileNotFoundError:
            pass
        shutil.rmtree(final, ignore_errors=True)

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> str:
        """Write ``tree`` as step ``step`` (the host copy is taken on the
        caller's thread) and return its directory; ``metadata`` goes into
        ``meta.json`` beside the step and the time."""
        flat = _flatten(tree)  # snapshot on the caller's thread
        self._stream_background(flat)

        def _write():
            tmp = os.path.join(self.root, f".tmp-{step}-{os.getpid()}")
            final = os.path.join(self.root, f"step-{step:08d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "state.npz"), **flat)
            meta = {"step": step, "time": time.time(), **(metadata or {})}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            # the marker is the LAST byte written before publication:
            # a directory without it is, by definition, torn
            with open(os.path.join(tmp, _MARKER), "w") as f:
                f.write(str(step))
            with self._lock:
                if os.path.exists(final):
                    self._remove(final)
                os.rename(tmp, final)  # atomic publish
                self._gc()

        if self.async_save:
            self.wait()
            # non-daemon: the interpreter joins this thread at exit, so a
            # caller that never calls wait() still gets a complete write
            t = threading.Thread(target=_write, daemon=False,
                                 name=f"ckpt-save-{step}")
            t.start()
            self._pending = t
        else:
            _write()
        return os.path.join(self.root, f"step-{step:08d}")

    def wait(self) -> None:
        """Join the pending async write, if any."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            self._remove(os.path.join(self.root, f"step-{s:08d}"))

    # ------------------------------------------------------------------
    def list_steps(self) -> List[int]:
        """Steps with a COMMITTED (marker-carrying) checkpoint directory;
        torn directories from a crashed write or delete are excluded."""
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("step-"):
                continue
            if not os.path.exists(os.path.join(self.root, name, _MARKER)):
                continue
            try:
                out.append(int(name.split("-")[1]))
            except ValueError:
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step, or None."""
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[Any, dict]:
        """Restore into the structure of ``template``: a tensor leaf comes
        back as a tensor of its dtype on its device, a numpy leaf as a
        numpy array of its dtype."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints")
        d = os.path.join(self.root, f"step-{step:08d}")
        if not os.path.exists(os.path.join(d, _MARKER)):
            raise FileNotFoundError(
                f"checkpoint step {step} is uncommitted (torn write?)")
        data = np.load(os.path.join(d, "state.npz"))
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        leaves = []
        for path, leaf in flatten(template):
            arr = data[path]
            if isinstance(leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(device=leaf.device,
                                               dtype=leaf.dtype)
            elif hasattr(leaf, "dtype"):
                arr = arr.astype(leaf.dtype)
            leaves.append((path, arr))
        return unflatten(leaves), meta
