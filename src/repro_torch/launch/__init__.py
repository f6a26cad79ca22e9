"""Launch tooling of the port: the step builders (train, prefill, decode),
the production meshes, the sharding rules, the backward-hook readiness
dry-run and the meta-device dry-run (import
``repro_torch.launch.dryrun`` for the last)."""

from .steps import (make_decode_step, make_prefill_step,  # noqa: F401
                    make_train_step, value_and_grad)
from .mesh import (Mesh, axis_size, device_mesh, dp_axes,  # noqa: F401
                   make_debug_mesh, make_production_mesh)
from .sharding import (batch_specs, cache_specs, distribute,  # noqa: F401
                       opt_specs, param_specs, shard_shape, to_placements)
from .hook_dryrun import readiness_report  # noqa: F401
