"""Data-parallel training on the port's JCCL fabric: bucketed and
overlapped DDP (bulk-class gradient collectives), the backward readiness
schedule, fault-injected end-to-end runs, and the straggler monitor
(``straggler``)."""

from .backward import BackwardScheduler                   # noqa: F401
from .trainer import (DDPTrainer, RestartNeeded,          # noqa: F401
                      TrainerConfig, TrainRun, build_smoke_trainer,
                      resume_training)
