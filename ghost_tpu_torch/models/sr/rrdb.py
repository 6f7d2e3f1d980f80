"""Real-ESRGAN RRDBNet pieces, mirroring `ghost_tpu/models/sr/rrdb.py`.

Only `nearest_up2` is ported (SRVGG's input skip uses it); the RRDB
trunk itself is still to port (ROADMAP).
"""

from __future__ import annotations


def nearest_up2(x):
    """F.interpolate(scale_factor=2, mode='nearest') parity, NHWC."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)
