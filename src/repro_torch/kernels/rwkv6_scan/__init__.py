"""RWKV6 scan (replaces the Pallas ``_rwkv_kernel``)."""
