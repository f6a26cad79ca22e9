"""Adaptive fault-policy layer: per-fault response selection (the
port's own copy, numpy only).

Public surface:

* :class:`FaultPolicyEngine` — the live selector (attach to a cluster
  + SHIFT libs + JCCL world; decisions accumulate with full signal
  snapshots);
* :class:`PolicyConfig`, :class:`PolicySignals`,
  :class:`PolicyDecision` — knobs and audit records;
* :data:`RESPONSES` / :data:`FIXED_POLICIES` / :data:`POLICIES` — the
  response vocabulary and the policy names the comparison campaign
  sweeps.

See ``docs/policies.md`` and DESIGN.md §12.
"""

from .engine import (FIXED_POLICIES, POLICIES, RESPONSES,
                     FaultPolicyEngine, PolicyConfig, PolicyDecision,
                     PolicySignals)

__all__ = ["FIXED_POLICIES", "POLICIES", "RESPONSES",
           "FaultPolicyEngine", "PolicyConfig", "PolicyDecision",
           "PolicySignals"]
