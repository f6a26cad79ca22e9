"""Flash-attention forward (replaces the Pallas ``_fwd_kernel``)."""
