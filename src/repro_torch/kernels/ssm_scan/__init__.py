"""Mamba2 SSD scan (replaces the Pallas ``_ssd_kernel``)."""
