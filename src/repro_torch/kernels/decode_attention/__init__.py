"""Decode attention (replaces the Pallas ``_decode_kernel``)."""
