"""Threaded prefetch batch loader, a copy of `ghost_tpu/data/loader.py`
(the reference's torch DataLoader with num_workers=8, reference
train.py:526).

Worker threads pull indices and assemble items (cv2 and numpy release
the GIL), and the consumer stacks contiguous NHWC numpy batches;
`prefetch` batches are staged ahead so the train step does not wait on
the host. Threads, not worker processes: every worker draws from the
dataset's one `random.Random`, so with num_workers=1 the pairs are the
JAX loader's, draw for draw (a process would copy the generator).
Batches stay numpy; `train/loop.py` moves them to the state's device.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Iterator

import numpy as np


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)

        idx_q: queue.Queue = queue.Queue()
        item_q: queue.Queue = queue.Queue(maxsize=self.prefetch * self.batch_size)
        n_batches = len(self)
        n_items = n_batches * self.batch_size if self.drop_last else len(order)
        for i in order[:n_items]:
            idx_q.put(int(i))
        stop = threading.Event()

        failures = [0]
        fail_budget = max(2 * len(self.dataset), 64)

        def put_or_stop(it) -> bool:
            # Bounded put that still honors `stop`: a consumer that exits
            # early (break from the train loop, raised exception) must not
            # strand workers blocked on the full queue: leaked threads
            # would contend for the GIL with later host work.
            while not stop.is_set():
                try:
                    item_q.put(it, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                try:
                    i = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self.dataset[i]
                except Exception as e:
                    # skip unreadable samples (the reference's per-sample
                    # try/except resilience, train.py:101-165) — but a
                    # fully unreadable dataset must surface, not spin
                    failures[0] += 1
                    if failures[0] > fail_budget:
                        put_or_stop(RuntimeError(
                            f"dataset unreadable: {failures[0]} sample "
                            f"failures (last: {e!r})"))
                        return
                    idx_q.put(int(np.random.default_rng().integers(len(self.dataset))))
                    continue
                failures[0] = 0
                if not put_or_stop(item):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            remaining = n_items
            for _ in range(n_batches):
                # Final batch under drop_last=False is short: asking the
                # queue for a full batch_size would block forever.
                want = min(self.batch_size, remaining)
                items = []
                while len(items) < want:
                    # Bounded get with a liveness check: a worker dying
                    # via a non-Exception throwable (KeyboardInterrupt,
                    # MemoryError) escapes its `except Exception` and
                    # leaves nothing in the queue — a bare get() would
                    # then block the consumer forever.
                    try:
                        it = item_q.get(timeout=1.0)
                    except queue.Empty:
                        if not any(t.is_alive() for t in threads):
                            raise RuntimeError(
                                "PrefetchLoader: all worker threads died "
                                "without delivering the remaining items "
                                f"({len(items)}/{want} of this batch)")
                        continue
                    if isinstance(it, Exception):
                        raise it
                    items.append(it)
                remaining -= want
                batch = {
                    k: np.stack([it[k] for it in items]) for k in items[0]
                }
                yield batch
        finally:
            stop.set()
            # Shared deadline across the joins (per-thread timeouts add
            # up to 2s*num_workers on consumer exit), and a visible
            # warning if a worker is stuck in a slow dataset[i] read:
            # leaked threads would contend for the GIL with later host
            # work.
            deadline = time.monotonic() + 2.0
            for t in threads:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            leaked = sum(t.is_alive() for t in threads)
            if leaked:
                warnings.warn(
                    f"PrefetchLoader: {leaked} worker thread(s) still "
                    "alive 2s after consumer exit (stuck dataset read?) "
                    "— they will die with the process but may slow "
                    "host-side work until then", RuntimeWarning)
