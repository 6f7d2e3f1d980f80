"""Preemption-aware training shutdown, mirroring `ghost_tpu/train/preempt.py`.

A spot or maintenance reclaim sends SIGTERM ahead of the kill.
`PreemptionGuard` latches the signal into a flag on the host (the
handler only sets it); `train/loop.py:train_loop` polls the flag once a
step, saves a forced full-state checkpoint (parameters, BN statistics,
optimizer moments, the ratchets; exact resume, see
`core/checkpoint.py`) and returns.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager latching shutdown signals into a step-poll flag.

    Watches SIGTERM by default (SIGINT stays ctrl-C) and chains to the
    handler it replaced, so an outer supervisor still sees the signal:

        with PreemptionGuard() as guard:
            train_loop(..., preemption=guard)
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._flag = threading.Event()
        self._prev: dict = {}

    def __enter__(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            # None: the previous handler was installed outside Python;
            # signal.signal(s, None) would raise, so leave it in place
            if prev is not None:
                signal.signal(s, prev)
        self._prev.clear()

    def _handler(self, signum, frame) -> None:
        self._flag.set()
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    @property
    def triggered(self) -> bool:
        return self._flag.is_set()
