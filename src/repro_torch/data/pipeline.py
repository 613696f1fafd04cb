"""Sharded deterministic data pipeline.

Host-side batching with deterministic per-step seeds: every (task, step)
yields identical batches across restarts, which makes checkpoint/restart
bitwise reproducible — the fault-tolerance tests rely on this.  Prefetching
runs on a background thread (double-buffering the host->device transfer).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from .tasks import TaskSpec, batch_of


class TaskDataLoader:
    def __init__(self, spec: TaskSpec, batch: int, seq_len: int,
                 base_seed: int = 0, prefetch: int = 2):
        self.spec = spec
        self.batch = batch
        self.seq_len = seq_len
        self.base_seed = base_seed
        self.prefetch = prefetch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        seed = (self.base_seed * 1_000_003 + self.spec.task_id * 7919
                + step) % (2 ** 31)
        return batch_of(self.spec, self.batch, self.seq_len, seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Resumable iterator (start_step from a restored checkpoint)."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.2)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def mixture_loader(specs, batch: int, seq_len: int, base_seed: int = 0):
    """Round-robin over tasks (multi-task training batches)."""
    loaders = [TaskDataLoader(s, batch, seq_len, base_seed) for s in specs]

    def gen(start_step: int = 0):
        step = start_step
        while True:
            yield loaders[step % len(loaders)].batch_at(step // len(loaders))
            step += 1

    return gen
