"""setup_s: everything before the window (process start, loading, weights
made on the device, kernels built or loaded, warm-up), host clock."""


def read(rec):
    return rec.setup_s
