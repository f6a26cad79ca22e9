"""JCCL — an NCCL-like collective library over SHIFT-protected RDMA (the
port's own copy; the fabric under it is numpy on the host).

Implements the paper's Table-1 'NCCL (Simple)' protocol: bulk RDMA Writes
followed by a Write-with-Imm notification, which is exactly the traffic
class SHIFT can fail over safely. See DESIGN.md §2 for how this maps the
paper's GPU/NCCL placement onto the training system (cross-host gradient
sync / DCN-side traffic) and DESIGN.md §6 for the multi-rail channel
layer (``channels=N`` stripes collectives across all host NICs with
rail-aware SHIFT failover).
"""

from .channel import (PRIORITY_CLASSES, Channel,        # noqa: F401
                      ChannelScheduler, SchedulerConfig)
from .endpoint import RankEndpoint                      # noqa: F401
from .world import (DEFAULT_MAX_CHUNK_BYTES,            # noqa: F401
                    CollectiveError, JcclWorld, Work,
                    aligned_bucket_bounds, build_world)
