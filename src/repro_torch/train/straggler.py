"""Straggler mitigation via proactive SHIFT failover (beyond-paper).

The paper switches NICs only on *error* WCs. Degraded-but-alive links
(dirty optics, partial PCIe lane failures) are a documented production
straggler source that stalls gang-scheduled training without ever
erroring. This monitor watches per-rank communication time and, when a
rank is persistently slower than the fleet median, triggers SHIFT's
``force_fallback()`` — the identical handshake/counter machinery migrates
the rank's traffic to its backup NIC while the default stays up. If the
backup is no better, SHIFT's probe/recovery path migrates back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.shift import ShiftLib, ShiftQP


@dataclasses.dataclass
class StragglerConfig:
    """Detection/action thresholds for the straggler monitor."""

    ewma: float = 0.5             # smoothing of per-rank comm time
    threshold: float = 2.0        # rank is a straggler at N x fleet median
    patience: int = 3             # consecutive slow steps before acting
    cooldown_steps: int = 10      # min steps between migrations per rank


class StragglerMonitor:
    """Watches per-rank communication-time EWMAs and force-fails ranks
    persistently slower than the fleet median over to their backup NIC
    (SHIFT's degraded-but-alive straggler mitigation)."""

    def __init__(self, libs: List, cfg: Optional[StragglerConfig] = None):
        """``libs`` are the per-rank ShiftLib handles to migrate."""
        self.libs = libs
        self.cfg = cfg or StragglerConfig()
        self.ewma: Dict[int, float] = {}
        self.slow_count: Dict[int, int] = {}
        self.last_action: Dict[int, int] = {}
        self.migrations: List[tuple] = []
        self.step = 0

    def observe(self, comm_times: Dict[int, float]) -> List[int]:
        """Feed per-rank comm times for one step; returns ranks migrated."""
        self.step += 1
        cfg = self.cfg
        for r, t in comm_times.items():
            prev = self.ewma.get(r, t)
            self.ewma[r] = cfg.ewma * t + (1 - cfg.ewma) * prev
        med = float(np.median(list(self.ewma.values())))
        acted = []
        for r, t in self.ewma.items():
            if med > 0 and t > cfg.threshold * med:
                self.slow_count[r] = self.slow_count.get(r, 0) + 1
            else:
                self.slow_count[r] = 0
            recent = self.step - self.last_action.get(r, -10 ** 9)
            if (self.slow_count[r] >= cfg.patience
                    and recent >= cfg.cooldown_steps):
                if self._migrate(r):
                    acted.append(r)
                    self.last_action[r] = self.step
                    self.slow_count[r] = 0
        return acted

    def _migrate(self, rank: int) -> bool:
        lib = self.libs[rank]
        if not isinstance(lib, ShiftLib):
            return False
        ok = False
        for sqp in lib.shift_qps:
            ok = sqp.force_fallback() or ok
        if ok:
            self.migrations.append((self.step, rank))
        return ok
