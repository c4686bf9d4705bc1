"""Host-side streaming pipeline for the sharded loop: background prefetch
with straggler-tolerant assembly of a tick's per-shard batches (the JAX
package's ``data/pipeline.py``).

The assembly of a tick waits up to ``tick_timeout`` for the per-shard
producers; a shard that misses the deadline contributes ZERO items this
tick and delivers its data the next. R-TBS is correct under any
batch-size fluctuation (paper Thm 4.2 holds for any {B_t}), so stragglers
cost freshness, never statistical correctness.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np


class StreamPipeline:
    """Pulls per-shard batches from ``make_batch(t, shard)`` producers on
    background threads; :meth:`next_tick` returns (per-shard arrays,
    per-shard counts) with zeros for late shards: one tick of
    :func:`repro_torch.manage.make_sharded_manage_step`, its items
    reshaped to ``[num_shards * cap, *item_shape]``."""

    def __init__(self, make_batch: Callable[[int, int], np.ndarray], *, num_shards: int,
                 shard_capacity: int, item_shape: tuple, dtype=np.float32, prefetch: int = 2,
                 tick_timeout: float = 10.0):
        self.make_batch = make_batch
        self.num_shards = num_shards
        self.cap = shard_capacity
        self.item_shape = tuple(item_shape)
        self.dtype = dtype
        self.tick_timeout = tick_timeout
        self._queues = [queue.Queue(maxsize=prefetch) for _ in range(num_shards)]
        self._carry: list[Optional[np.ndarray]] = [None] * num_shards
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._producer, args=(s,), daemon=True)
                         for s in range(num_shards)]
        self.stats = {"late_shards": 0, "ticks": 0}
        for th in self._threads:
            th.start()

    def _producer(self, shard: int):
        t = 0
        while not self._stop.is_set():
            data = np.asarray(self.make_batch(t, shard))
            while not self._stop.is_set():
                try:
                    self._queues[shard].put(data, timeout=0.2)  # backpressure
                    break
                except queue.Full:
                    continue
            t += 1

    def next_tick(self):
        """-> (items [num_shards, cap, *item_shape], counts [num_shards])."""
        items = np.zeros((self.num_shards, self.cap) + self.item_shape, self.dtype)
        counts = np.zeros((self.num_shards,), np.int32)
        deadline = time.monotonic() + self.tick_timeout
        for s in range(self.num_shards):
            data = self._carry[s]
            self._carry[s] = None
            if data is None:
                try:
                    data = self._queues[s].get(timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    self.stats["late_shards"] += 1
                    continue  # straggler: zero items this tick
            n = min(len(data), self.cap)
            if len(data) > self.cap:  # overflow -> carry the remainder forward
                self._carry[s] = data[self.cap:]
            items[s, :n] = data[:n]
            counts[s] = n
        self.stats["ticks"] += 1
        return items, counts

    def close(self):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=1.0)
