"""Int8 gradient compression with error feedback — the distributed-
optimization trick for cross-pod (DCN) gradient sync: 4x fewer bytes on
the slowest links, with the quantization error fed back into the next
step's gradient so convergence is preserved.

Error-feedback contract (the property tests assert both):

* after N steps of ``int8_compress(x_i, error)`` the CUMULATIVE sum of
  decompressed outputs equals the cumulative sum of inputs minus the
  final error buffer exactly (float arithmetic aside) — no gradient
  mass is ever lost, only deferred;
* the carried error is elementwise bounded by ``scale / 2`` of the last
  step (half a quantization bucket), so the deferred mass cannot grow
  without bound while inputs stay bounded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def int8_compress(x: np.ndarray, error: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.float32, np.ndarray]:
    """Quantize ``x + error`` to int8. Returns ``(q, scale, new_error)``.

    ``error`` is the feedback buffer carried from the previous step
    (``None`` on the first step). The result decompresses as
    ``q * scale``; ``new_error`` holds exactly what the quantization
    dropped, ready to be added into the next step's input.

    Edge cases are explicit rather than silent: non-finite inputs
    (NaN/inf — a diverging or overflowed gradient) raise ``ValueError``
    instead of propagating garbage through the exchange, and an
    all-zero input returns a zero ``q``, the neutral scale ``1/127``
    and a ZERO error buffer of the input's shape (never ``None`` or a
    scalar surprise).
    """
    x = np.asarray(x, dtype=np.float32)
    if error is not None:
        x = x + error
    if not np.all(np.isfinite(x)):
        raise ValueError("int8_compress: non-finite input "
                         "(NaN/inf gradient must be handled upstream)")
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    if amax == 0.0:
        # all-zero input: nothing to quantize, nothing deferred
        return (np.zeros(x.shape, dtype=np.int8), np.float32(1.0 / 127.0),
                np.zeros(x.shape, dtype=np.float32))
    scale = np.float32(amax / 127.0)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    new_error = x - q.astype(np.float32) * scale
    return q, scale, new_error


def int8_decompress(q: np.ndarray, scale: np.float32,
                    dtype: Optional[np.dtype] = None) -> np.ndarray:
    """Dequantize ``q * scale``. ``dtype`` restores the original input
    dtype (e.g. float64 callers get float64 back); the default keeps
    the float32 wire format."""
    out = q.astype(np.float32) * np.float32(scale)
    if dtype is not None and out.dtype != np.dtype(dtype):
        out = out.astype(dtype)
    return out
