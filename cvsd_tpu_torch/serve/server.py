"""Minimal HTTP serving endpoint for the anomaly scorer and detector (PyTorch
port of ``cvsd_tpu/serve/server.py``; stdlib ``http.server`` + numpy).

Endpoints:
- GET  /healthz             -> {"status": "ok", "model": {...}}
- POST /score               <- {"poses": [[[...]]]} (N, T, V, C) normalized
                            -> {"scores": [...]}
- POST /detect              <- raw JPEG/PNG bytes (Content-Type: image/*)
                            -> {"boxes": [[x1,y1,x2,y2]...], "scores": [...]
                                [, "keypoints": ...]} in source pixels

``/detect`` decodes with ``cv2``, imported on the request thread only; where
``cv2`` is not installed it answers HTTP 501 naming it, and the rest of the
server runs. Its device half, ``_detect_canvas``, takes an already
letterboxed uint8 canvas and needs no ``cv2``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

from cvsd_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_params
from cvsd_tpu_torch.serve.microbatch import MicroBatcher
from cvsd_tpu_torch.utils.hostmem import maybe_malloc_trim


class MissingModule(RuntimeError):
    """An endpoint needs a module this installation lacks (HTTP 501)."""


class _Server(ThreadingHTTPServer):
    # the stdlib default backlog is 5; 32+ concurrent clients connecting while
    # a handler thread holds a long first dispatch can overflow it
    request_queue_size = 128


class ScoringServer:
    """Wraps a ShopformerScorer (+ optional DetectionPipeline) in HTTP.

    Concurrent requests are micro-batched (serve/microbatch.py): each
    endpoint has a dispatcher thread that drains every pending request into
    ONE device call, so the per-dispatch cost is paid once per batch instead
    of once per request. window_ms=0 adds no latency for a lone request.
    Model calls run on the dispatcher threads (each model call enters its own
    ``torch.no_grad``: grad mode is per thread), one at a time under a lock.
    """

    def __init__(self, scorer, detection=None, host: str = "127.0.0.1",
                 port: int = 8470, microbatch: bool = True,
                 window_ms: float = 0.0, detect_batch: int = 8,
                 max_score_items: int = 64):
        self.scorer = scorer
        self.detection = detection
        self.host = host
        self.port = int(port)
        self._lock = threading.Lock()  # serialize device dispatch
        self._httpd: Optional[ThreadingHTTPServer] = None
        self.detect_batch = max(1, int(detect_batch))
        self._score_mb = self._detect_mb = None
        if microbatch:
            self._score_mb = MicroBatcher(self._run_score_batch,
                                          max_items=max_score_items,
                                          window_ms=window_ms, name="score-mb")
            if detection is not None:
                self._detect_mb = MicroBatcher(self._run_detect_batch,
                                               max_items=self.detect_batch,
                                               window_ms=window_ms,
                                               name="detect-mb")

    def _window_shape(self):
        m = self.scorer.config.get("model", {})
        return (int(m.get("seq_len", 12)), int(m.get("num_keypoints", 18)),
                int(m.get("in_channels", 2)))

    def warmup(self) -> Dict[str, float]:
        """Run both serving programs once before accepting traffic, at the
        shapes live traffic dispatches (the scorer pads to data.batch_size;
        micro-batched detect pads to (detect_batch, S, S, 3), detect without
        micro-batching sends (1, S, S, 3)), so the first request does not pay
        for cuDNN's algorithm choice or the nvcc build of the NMS kernel.
        Returns seconds per program."""
        times: Dict[str, float] = {}
        t0 = time.perf_counter()
        with self._lock:
            self.scorer.score(np.zeros((1, *self._window_shape()), np.float32))
        times["score_s"] = time.perf_counter() - t0
        if self.detection is not None:
            size = self.detection.model.img_size
            n = self.detect_batch if self._detect_mb is not None else 1
            batch = np.full((n, size, size, 3), PAD_VALUE, np.uint8)
            t0 = time.perf_counter()
            with self._lock:
                self.detection.detect_frames(batch)  # returns on the host: synchronised
            times["detect_s"] = time.perf_counter() - t0
        return times

    # -- request handlers (plain methods for testability) ---------------------

    def health(self) -> Dict[str, Any]:
        m = self.scorer.config.get("model", {})
        out = {"status": "ok",
               "model": {"variant": m.get("variant"),
                         "seq_len": m.get("seq_len"),
                         "num_keypoints": m.get("num_keypoints")},
               "detector": bool(self.detection is not None)}
        score_mb, detect_mb = self._score_mb, self._detect_mb  # vs stop() race
        if score_mb is not None:
            out["microbatch"] = {"score": score_mb.stats()}
            if detect_mb is not None:
                out["microbatch"]["detect"] = detect_mb.stats()
        return out

    # batched backends (called from the micro-batcher dispatcher threads) ----

    def _run_score_batch(self, items):
        """items: list of (Ni, T, V, C) arrays -> list of (Ni,) score arrays.
        One concatenated scorer call per gather."""
        sizes = [len(x) for x in items]
        cat = np.concatenate(items) if len(items) > 1 else items[0]
        with self._lock:
            scores = self.scorer.score(cat)
        out, off = [], 0
        for n in sizes:
            out.append(scores[off:off + n])
            off += n
        # long-running server: return freed arena pages, time-gated so it
        # never shows in per-request latency
        maybe_malloc_trim()
        return out

    def _run_detect_batch(self, canvases):
        """canvases: list of (S, S, 3) uint8 -> list of per-image raw outs.
        Always pads to the fixed detect_batch, so one batch shape runs."""
        k = len(canvases)
        size = self.detection.model.img_size
        batch = np.zeros((self.detect_batch, size, size, 3), np.uint8)
        for i, c in enumerate(canvases):
            batch[i] = c
        with self._lock:
            outs = self.detection.detect_frames(batch)
        results = []
        for i in range(k):
            boxes, _xywhn, scores, valid = (o[i] for o in outs[:4])
            kpts = outs[4][i] if len(outs) > 4 else None
            results.append((boxes, scores, valid, kpts))
        return results

    def score(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        poses = np.asarray(payload["poses"], np.float32)
        T, V, C = self._window_shape()
        # strict shape check: a mismatched window must not reach the model
        if poses.ndim != 4 or poses.shape[1:] != (T, V, C):
            raise ValueError(
                f"poses must be (N, {T}, {V}, {C}); got {tuple(poses.shape)}")
        score_mb = self._score_mb  # snapshot vs concurrent stop()
        if score_mb is not None:
            scores = score_mb.submit(poses)
        else:
            with self._lock:
                scores = self.scorer.score(poses)
        return {"scores": [float(s) for s in scores]}

    def detect(self, image_bytes: bytes) -> Dict[str, Any]:
        """The cv2 half, on the request thread: decode, then letterbox on the
        host onto one fixed canvas (INTER_LINEAR), so every client resolution
        runs the same batch shape; then ``_detect_canvas``."""
        if self.detection is None:
            raise ValueError("server started without a detector checkpoint")
        try:
            import cv2
        except ImportError as e:
            raise MissingModule(
                "/detect needs the cv2 module (opencv-python) to decode images, and it "
                f"is not installed here: {e}") from e
        img = cv2.imdecode(np.frombuffer(image_bytes, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("undecodable image payload")
        h, w = img.shape[:2]
        size = self.detection.model.img_size
        scale, px, py, nw, nh = letterbox_params(h, w, size)
        canvas = np.full((size, size, 3), PAD_VALUE, np.uint8)
        canvas[py:py + nh, px:px + nw] = cv2.resize(
            img, (nw, nh), interpolation=cv2.INTER_LINEAR)[..., ::-1]
        return self._detect_canvas(canvas, h, w, scale, px, py)

    def _detect_canvas(self, canvas: np.ndarray, h: int, w: int, scale: float,
                       px: int, py: int) -> Dict[str, Any]:
        """The device half: one (S, S, 3) uint8 RGB canvas of an (h, w) source
        letterboxed at ``scale`` with offsets (px, py) -> the response, boxes
        and keypoints unmapped to source pixels on the host."""
        detect_mb = self._detect_mb  # snapshot vs concurrent stop()
        if detect_mb is not None:
            boxes, scores, valid, kpts = detect_mb.submit(canvas)
        else:
            with self._lock:
                outs = self.detection.detect_frames(canvas[None])
            boxes, scores, valid = outs[0][0], outs[2][0], outs[3][0]
            kpts = outs[4][0] if len(outs) > 4 else None
        keep = valid
        b = np.asarray(boxes[keep], np.float64)
        b[:, [0, 2]] = (b[:, [0, 2]] - px) / scale
        b[:, [1, 3]] = (b[:, [1, 3]] - py) / scale
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        out: Dict[str, Any] = {
            "boxes": b.round(2).tolist(),
            "scores": np.asarray(scores[keep], np.float64).round(4).tolist(),
        }
        if kpts is not None:
            k = np.asarray(kpts[keep, :, :2], np.float64)
            k[..., 0] = (k[..., 0] - px) / scale
            k[..., 1] = (k[..., 1] - py) / scale
            out["keypoints"] = k.round(2).tolist()
        return out

    # -- http plumbing --------------------------------------------------------

    def _make_handler(server):  # noqa: N805 — closure over the server
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, obj: Dict[str, Any]) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, server.health())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                try:
                    if self.path == "/score":
                        self._reply(200, server.score(json.loads(body)))
                    elif self.path == "/detect":
                        self._reply(200, server.detect(body))
                    else:
                        self._reply(404, {"error": f"no route {self.path}"})
                except (ValueError, KeyError, TypeError) as e:
                    # validation problems are the client's fault
                    self._safe_error_reply(400, e)
                except MissingModule as e:
                    self._safe_error_reply(501, e)
                except Exception as e:  # noqa: BLE001 — genuine server fault
                    self._safe_error_reply(500, e)

            def _safe_error_reply(self, code: int, err: Exception) -> None:
                # the error reply itself must never kill the handler thread
                # without a trace (the client would just see a connection
                # reset); log the fault and best-effort the JSON reply
                print(f"serve error ({code}): {err!r}", file=sys.stderr, flush=True)
                if code == 500:
                    traceback.print_exc()
                try:
                    self._reply(code, {"error": str(err)})
                except OSError:
                    pass  # client already gone

        return Handler

    def _bind(self) -> None:
        self._httpd = _Server((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]  # resolve port 0

    def start(self) -> None:
        """Start serving in a background thread (returns immediately)."""
        self._bind()
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def serve_forever(self) -> None:
        """Bind, print the address (port 0 resolved), then serve until stopped."""
        self._bind()
        print(f"serving on http://{self.host}:{self.port} "
              f"(/healthz /score{' /detect' if self.detection else ''})", flush=True)
        self._httpd.serve_forever()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for mb in (self._score_mb, self._detect_mb):
            if mb is not None:
                mb.stop()
        self._score_mb = self._detect_mb = None
