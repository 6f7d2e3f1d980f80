"""Temporal keypoint smoothing (host-side, tiny arrays), a copy of
`ghost_tpu/pipeline/smoothing.py`.

Centered moving average of window n over runs of consecutive detections,
runs broken at scene cuts (a jump of > 5 px in keypoint 0 or 2 between
adjacent frames) and at missing detections. Operates on (T, 5, 2)
keypoint tracks with a (T,) present mask; numpy only.
"""

from __future__ import annotations

import numpy as np


def smooth_keypoint_track(kps: np.ndarray, present: np.ndarray, n: int = 2):
    """kps (T,5,2), present (T,) bool -> smoothed kps (T,5,2)."""
    t = kps.shape[0]
    out = kps.copy()

    # split into runs: break on missing frames or >5px jumps of kp0/kp2
    run_start = 0
    runs = []
    for i in range(1, t + 1):
        brk = i == t
        if not brk:
            if not (present[i] and present[i - 1]):
                brk = True
            else:
                d0 = np.linalg.norm(kps[i, 0] - kps[i - 1, 0])
                d2 = np.linalg.norm(kps[i, 2] - kps[i - 1, 2])
                brk = d0 > 5.0 or d2 > 5.0
        if brk:
            runs.append((run_start, i))
            run_start = i

    for s, e in runs:
        seg = kps[s:e]
        ln = e - s
        for i in range(ln):
            q = min(i, ln - i - 1, n)
            out[s + i] = seg[i - q : i + 1 + q].mean(axis=0)
    return out


def smooth_tracks(kps: np.ndarray, present: np.ndarray, n: int = 2):
    """Batched over targets: kps (T, n_targets, 5, 2), present (T, n_targets)."""
    out = kps.copy()
    for j in range(kps.shape[1]):
        out[:, j] = smooth_keypoint_track(kps[:, j], present[:, j], n)
    return out
