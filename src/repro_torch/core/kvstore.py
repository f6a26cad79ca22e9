"""Out-of-band key-value store over the management network (§4.2).

SHIFT cannot assume access to the application's out-of-band channel, so it
publishes *default attrs -> backup attrs* mappings (QP route attributes and
MR keys) to a cluster-level KV store reachable over the management network.
All interactions happen from background actors, so KV latency is off the
application's critical path (the paper uses Redis; we model a store with a
configurable management-network RTT and the same get/put surface).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .fabric import Simulator


class KVStore:
    """Cluster-level KV store. ``get``/``put`` are synchronous (used by the
    background control actors); ``async_get_until`` models retry-until-ready
    resolution of not-yet-published peer attributes (App. B.1 best-effort
    shadow-verb execution)."""

    def __init__(self, sim: Simulator, rtt: float = 200e-6):
        self.sim = sim
        self.rtt = rtt
        self._data: Dict[str, Any] = {}
        self.n_puts = 0
        self.n_gets = 0

    # -- synchronous surface (background-thread context) -------------------
    def put(self, key: str, value: Any) -> None:
        """Publish ``key`` -> ``value`` (e.g. a default->backup mapping)."""
        self.n_puts += 1
        self._data[key] = value

    def get(self, key: str) -> Optional[Any]:
        """Fetch ``key``'s value, or None if not (yet) published."""
        self.n_gets += 1
        return self._data.get(key)

    def contains(self, key: str) -> bool:
        """True if ``key`` has been published."""
        return key in self._data

    # -- async retry-until-ready -------------------------------------------
    def async_get_until(self, key: str, cb: Callable[[Any], None],
                        retry_every: float = 1e-3,
                        max_tries: int = 100000) -> None:
        """Deliver ``cb(value)`` once ``key`` exists; retries model the
        best-effort dependency resolution of shadow control verbs."""

        def attempt(tries_left: int) -> None:
            val = self.get(key)
            if val is not None:
                cb(val)
                return
            if tries_left <= 0:
                raise KeyError(f"KV key never appeared: {key}")
            self.sim.schedule(retry_every, attempt, tries_left - 1)

        self.sim.schedule(self.rtt, attempt, max_tries)
