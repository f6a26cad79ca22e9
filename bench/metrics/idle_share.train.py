"""idle_share.train: share of the traced window with nothing running on
the device (torch.profiler)."""

from bench.readers import idle_share


def read(rec):
    return idle_share(rec) if rec.steps is not None else None
