"""Shared decode-ahead producer for the multiplexed pipelines.

pipeline/streaming.py overlaps host decode with device compute by producing
detector batches in a worker thread (cv2 decode releases the GIL, so the C
work runs concurrently with GIL-bound tracking and scoring). The hand-off
protocol lives here: bounded queue, None sentinel at EOF, and producer
exceptions crossing the queue to re-raise in the consumer (a dead producer
without a sentinel would hang the main loop forever).
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Callable, Dict, Tuple


def make_next_batch(
    read_batch: Callable[[], Tuple],
    stage: Dict[str, float],
    depth: int,
    use_thread: bool,
):
    """Wrap ``read_batch() -> (frames, meta, k)`` into ``next_batch()``.

    next_batch returns (None, None, 0) once the source is exhausted; wall
    time spent reading accrues into ``stage['read']``. With use_thread the
    batches are produced ahead in a daemon thread (queue depth
    ``max(2, depth)``); batch order is preserved (single producer).
    """
    if not use_thread:
        def next_batch():
            t0 = time.perf_counter()
            frames, meta, k = read_batch()
            stage["read"] += time.perf_counter() - t0
            return (frames, meta, k) if k else (None, None, 0)

        return next_batch

    q: _queue.Queue = _queue.Queue(maxsize=max(2, int(depth)))

    def _producer() -> None:
        try:
            while True:
                t0 = time.perf_counter()
                frames, meta, k = read_batch()
                stage["read"] += time.perf_counter() - t0
                if not k:
                    q.put(None)
                    return
                q.put((frames, meta, k))
        except BaseException as e:  # noqa: BLE001 — surfaced in consumer
            q.put(e)

    threading.Thread(target=_producer, daemon=True).start()

    def next_batch():
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        return item if item is not None else (None, None, 0)

    return next_batch
