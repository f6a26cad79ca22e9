"""Declarative fault-scenario DSL over the discrete-event fabric.

A :class:`Scenario` is a named, immutable timeline of
:class:`FaultAction`\\ s plus the expectations SHIFT must meet under it
(masked vs. unmaskable, minimum fallback count, recovery, a bound on
fallback latency). Action times are **relative to workload start**; the
campaign engine rebases them onto the cluster's virtual clock via
``Cluster.schedule_fault``. Targets use the fabric's uniform vocabulary:
a NIC GID (``"host0/mlx5_0"``) or a rail selector (``"rail:0"`` — NIC
index 0 of every host, i.e. a correlated rail failure).

Composite timelines (flap trains, correlated failures) are built from the
fabric's generator functions so the exact same primitives drive ad-hoc
experiments and the named library. See DESIGN.md §3 for the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

from ..core import fabric


@dataclass(frozen=True)
class FaultAction:
    """One scheduled fault: apply ``kind`` to ``target`` at t0 + ``at``.

    ``arg`` parameterizes the partial-degradation kinds (``bw_degrade``:
    bandwidth fraction, ``lat_inflate``: latency multiplier) and is
    ``None`` for the binary up/down kinds."""

    at: float      # seconds after workload start
    kind: str      # one of fabric.Cluster.FAULT_KINDS
    target: str    # NIC GID or "rail:<k>" selector
    arg: Optional[float] = None  # magnitude for degradation kinds

    def __post_init__(self):
        if self.kind not in fabric.Cluster.FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.at < 0:
            raise ValueError("fault time must be >= 0")


@dataclass(frozen=True)
class Scenario:
    """A named fault timeline + the invariants/expectations for the run."""

    name: str
    description: str
    actions: Tuple[FaultAction, ...]
    duration: float = 0.25          # virtual seconds the workload runs
    expect_masked: bool = True      # SHIFT hides it from the application
    min_fallbacks: int = 0          # lower bound on observed fallbacks
    expect_recovery: bool = False   # traffic must return to the default NIC
    latency_bound: float = 20e-3    # max allowed fallback latency (virtual s)
    # multi-rail: lower bound on chunks the channel scheduler must move
    # off their home channel — only checked when the workload actually
    # ran channelized (>1 channel), so single-rail workloads of the same
    # scenario are unaffected
    min_resteers: int = 0
    # upper bound on fallbacks: degradation scenarios (straggler, partial
    # bandwidth loss) must be handled by the SCHEDULER alone, with no
    # SHIFT health transition at all (None disables the check)
    max_fallbacks: Optional[int] = None
    # proportional-share invariants: channel index -> (min, max) bounds
    # on its final share of assigned chunks; checked only on channelized
    # runs (the proportional-degradation contract, see docs/scheduler.md)
    share_bounds: Optional[Dict[int, Tuple[float, float]]] = None
    tags: Tuple[str, ...] = field(default=())
    # per-workload engine overrides, e.g. {"pingpong": {"n_msgs": 240}} —
    # lets a timeline demand a longer stream without changing the engine
    workload_hints: Optional[Dict[str, dict]] = None

    def schedule(self, cluster, t0: float) -> None:
        """Rebase the timeline onto the cluster's virtual clock."""
        for act in self.actions:
            cluster.schedule_fault(t0 + act.at, act.kind, act.target,
                                   act.arg)


def actions(triples: Iterable[Tuple]) -> Tuple[FaultAction, ...]:
    """Wrap raw (time, kind, target[, arg]) tuples — e.g. the output of
    the fabric generators — into a sorted, immutable action timeline."""
    acts = tuple(FaultAction(t[0], t[1], t[2], t[3] if len(t) > 3 else None)
                 for t in sorted(triples, key=lambda x: x[:3]))
    return acts


def flap_train(target: str, start: float, count: int, down_time: float,
               period: float, kind: str = "nic") -> Tuple[FaultAction, ...]:
    """Scenario-level wrapper over :func:`fabric.flap_train`."""
    return actions(fabric.flap_train(target, start, count, down_time,
                                     period, kind=kind))


def correlated(targets: Sequence[str], at: float,
               kind: str = "nic_down") -> Tuple[FaultAction, ...]:
    """Scenario-level wrapper over :func:`fabric.correlated_failure`."""
    return actions(fabric.correlated_failure(targets, at, kind=kind))
