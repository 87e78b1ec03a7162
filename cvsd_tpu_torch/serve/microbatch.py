"""Adaptive micro-batching for the serving endpoint (the port's copy of
``cvsd_tpu/serve/microbatch.py``; pure threading).

Each device dispatch has a fixed cost (the host's launch and the fetch that
waits on the card), so a server that dispatches one request at a time caps
out near 1/dispatch regardless of batch headroom. ``MicroBatcher``: requests
from concurrent client threads queue up; a single dispatcher thread drains
everything pending into ONE batched device call and fans the results back
out. With window_ms=0 (the default) no artificial latency is added — an idle
server dispatches a lone request immediately, and batches form naturally
whenever a dispatch is in flight while new requests arrive (adaptive
batching). A small positive window_ms gathers harder at a latency cost.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Sequence


class _Request:
    __slots__ = ("item", "result", "error", "done")

    def __init__(self, item: Any):
        self.item = item
        self.result: Any = None
        self.error: BaseException | None = None
        self.done = threading.Event()


class MicroBatcher:
    """Gather concurrent submit() calls into single run_batch() dispatches.

    run_batch(items) -> results must return one result per item, in order.
    A run_batch exception is delivered to every request in that batch.
    """

    def __init__(self, run_batch: Callable[[List[Any]], Sequence[Any]],
                 max_items: int = 64, window_ms: float = 0.0,
                 name: str = "microbatch"):
        self._run = run_batch
        self._max = max(1, int(max_items))
        self._window = max(0.0, float(window_ms)) / 1000.0
        self._cv = threading.Condition()
        self._pending: List[_Request] = []
        self._stopped = False
        # dispatch stats (exposed via /healthz)
        self.batches = 0
        self.items = 0
        self.max_batch_seen = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def submit(self, item: Any) -> Any:
        req = _Request(item)
        with self._cv:
            if self._stopped:
                raise RuntimeError("microbatcher stopped")
            self._pending.append(req)
            self._cv.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=5)
        with self._cv:
            for r in self._pending:  # fail anything still queued
                r.error = RuntimeError("microbatcher stopped")
                r.done.set()
            self._pending.clear()

    def stats(self) -> dict:
        return {"batches": self.batches, "items": self.items,
                "items_per_batch": (self.items / self.batches
                                    if self.batches else 0.0),
                "max_batch": self.max_batch_seen}

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._pending:
                    return
            if self._window:
                with self._cv:
                    full = len(self._pending) >= self._max
                if not full:  # a full batch gains nothing from waiting
                    time.sleep(self._window)  # optional gather window
            with self._cv:
                batch = self._pending[: self._max]
                del self._pending[: len(batch)]
            if not batch:
                continue
            try:
                results = self._run([r.item for r in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results "
                        f"for {len(batch)} items")
                for r, res in zip(batch, results):
                    r.result = res
            except BaseException as e:  # noqa: BLE001 — fan the fault out
                for r in batch:
                    r.error = e
            self.batches += 1
            self.items += len(batch)
            self.max_batch_seen = max(self.max_batch_seen, len(batch))
            for r in batch:
                r.done.set()
