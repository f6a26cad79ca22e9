"""Tree-aware backward readiness schedule for issue-as-produced DDP.

The trainer's ``value_and_grad`` produces the whole gradient
tree at once, but a real backward pass produces it INCREMENTALLY, in
reverse layer order: head first, then layer L-1 down to layer 0, then
the embedding table last. ``BackwardScheduler`` reconstructs that
production order from the parameter pytree alone (shapes, no values):
it maps every flat-gradient element range to the backward *segment*
that produces it, then folds those intervals onto the engine-aligned
gradient buckets so the trainer knows, after each modeled per-layer
compute slice, exactly which buckets are complete and can be launched
as ``allreduce_async`` works while later segments are still computing
(DESIGN.md §13, docs/overlap.md).

Key structural fact (``repro_torch.models.lm``): layer parameters are
STACKED — ``params["blocks"]`` is one tree whose leaves carry a
leading layer dimension. A leaf
therefore spans ALL layers, so the schedule is sub-leaf: each stacked
leaf's flat range is split into per-layer rows and row ``i`` is
assigned to the segment that runs layer ``i``'s backward. Per model
family:

* dense / moe / audio / rwkv6: ``blocks`` (leading dim = n_layers);
* vlm: ``cross_blocks`` (G, ...) and ``self_blocks`` (G, S, ...) scan
  together — row ``g`` of both lands in the same segment;
* hybrid: ``groups`` (G, S, ...) then ``rem`` (R, ...) in forward
  order, so backward produces ``rem`` rows first; ``shared_attn`` is
  applied inside EVERY group iteration, so its gradient only finishes
  accumulating with the last-processed (first-forward) group — it is
  assigned to the final layer segment, like any unrecognized leaf.

Segment order: ``0`` = head (``final_norm`` + ``lm_head``), ``1..R`` =
stacked rows in reverse forward order, ``R+1`` = ``embed`` (the token
embedding's gradient lands last). The scheduler works identically on
concrete gradient tensors and on anything else with a ``.shape``: meta
tensors built from :func:`repro_torch.convert.param_shapes`, which is how
the trainer builds it without materializing a single gradient byte.

The port's own copy of the reference's scheduler: it walks the tree in
:func:`repro_torch.models.lm.flatten` order (keys sorted at every level,
the order of the reference's tree utilities on the same dicts and of the
trainer's flat gradient vector), so dense, hybrid and rwkv6 trees give
the reference's ``n_segments`` and ``ready_after``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..models.lm import flatten

#: top-level param entries produced by the FIRST backward segment
HEAD_KEYS = ("final_norm", "lm_head")
#: stacked block collections in BACKWARD production order (collections
#: later in the forward pass produce their gradients first); keys in
#: the same tuple scan together and share row segments
STACKED_BACKWARD_ORDER = (("rem",), ("groups",), ("blocks",),
                          ("cross_blocks", "self_blocks"))
#: top-level param entries produced by the LAST backward segment
EMBED_KEYS = ("embed",)


def _top_key(path: str) -> str:
    """Top-level key of a '/'-joined :func:`flatten` path."""
    return path.split("/", 1)[0]


class BackwardScheduler:
    """Leaf -> aligned-bucket -> ready-segment schedule for one model.

    Built from the parameter (or gradient) tree and the engine-aligned
    bucket bounds (``repro_torch.collectives.aligned_bucket_bounds``);
    works on meta tensors, so giant-model schedules cost only tree walks.
    """

    def __init__(self, tree, bounds: Sequence[Tuple[int, int]]):
        """Derive per-segment intervals from ``tree`` (flattened in
        :func:`flatten` order, matching the trainer's flat gradient
        vector) and fold them onto ``bounds``."""
        leaves = flatten(tree)
        entries = []  # (offset, size, top_key, leading_dim)
        off = 0
        for path, leaf in leaves:
            size = int(np.prod(leaf.shape)) if leaf.shape else 1
            lead = int(leaf.shape[0]) if leaf.shape else 1
            entries.append((off, size, _top_key(path), lead))
            off += size
        self.total_elems = off
        self.n_leaves = len(entries)

        # rows per stacked collection group, in backward order
        present: List[Tuple[Tuple[str, ...], int]] = []
        for group in STACKED_BACKWARD_ORDER:
            rows = max((lead for _, _, top, lead in entries
                        if top in group), default=0)
            if rows:
                present.append((group, rows))
        self.n_segments = 1 + sum(rows for _, rows in present) + 1
        seg_base: Dict[str, Tuple[int, int]] = {}
        base = 1
        for group, rows in present:
            for key in group:
                seg_base[key] = (base, rows)
            base += rows
        last_layer_seg = max(0, self.n_segments - 2)

        intervals: List[Tuple[int, int, int]] = []  # (lo, hi, segment)
        for off, size, top, lead in entries:
            if top in HEAD_KEYS:
                intervals.append((off, off + size, 0))
            elif top in EMBED_KEYS:
                intervals.append((off, off + size, self.n_segments - 1))
            elif top in seg_base:
                base, rows = seg_base[top]
                rowsize = size // lead
                for i in range(lead):
                    intervals.append((off + i * rowsize,
                                      off + (i + 1) * rowsize,
                                      base + (rows - 1 - i)))
            else:
                # conservative: shared / unrecognized params are only
                # complete once every layer's backward has run
                intervals.append((off, off + size, last_layer_seg))
        intervals.sort()
        self.n_intervals = len(intervals)

        # fold intervals onto buckets: a bucket is ready after the MAX
        # segment of any interval it intersects (two-pointer sweep;
        # bounds and intervals are both sorted by lo)
        self.bounds = list(bounds)
        ready = [0] * len(self.bounds)
        bi = 0
        for lo, hi, seg in intervals:
            while bi < len(self.bounds) and self.bounds[bi][1] <= lo:
                bi += 1
            j = bi
            while j < len(self.bounds) and self.bounds[j][0] < hi:
                if seg > ready[j]:
                    ready[j] = seg
                j += 1
        self.bucket_ready = ready
        self._by_segment: Dict[int, List[int]] = {}
        for i, seg in enumerate(ready):
            self._by_segment.setdefault(seg, []).append(i)

    def ready_after(self, segment: int) -> List[int]:
        """Bucket indices whose last leaf lands in ``segment`` — i.e.
        the buckets the trainer launches the moment that backward
        segment's modeled compute finishes."""
        return self._by_segment.get(segment, [])

    def stats(self) -> Dict[str, object]:
        """Summary for dry-runs and docs: totals plus the ready-burst
        distribution (how many buckets each segment releases)."""
        bursts = [len(self._by_segment.get(s, []))
                  for s in range(self.n_segments)]
        issuing = [b for b in bursts if b]
        return {
            "total_params": self.total_elems,
            "n_leaves": self.n_leaves,
            "n_intervals": self.n_intervals,
            "n_buckets": len(self.bounds),
            "n_segments": self.n_segments,
            "first_ready_segment": next(
                (s for s, b in enumerate(bursts) if b), 0),
            "max_burst": max(bursts) if bursts else 0,
            "mean_burst": (round(float(np.mean(issuing)), 3)
                           if issuing else 0.0),
        }
