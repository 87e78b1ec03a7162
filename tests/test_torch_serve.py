"""The port's HTTP server (cvsd_tpu_torch/serve/) on the CPU: every test of
tests/test_serve.py on the port's ScoringServer, the MicroBatcher alone, the
same requests against the JAX ScoringServer with the same flax weights, and
/detect without cv2 (CPU-sized detector: img 128, width 0.25, depth 0.34,
float32, pose head; Shopformer hidden 8)."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
from cvsd_tpu.serve.server import ScoringServer as ScoringServerJax
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.models.shopformer import build_shopformer
from cvsd_tpu_torch.ops.letterbox import letterbox_params
from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
from cvsd_tpu_torch.serve.microbatch import MicroBatcher
from cvsd_tpu_torch.serve.server import ScoringServer
from cvsd_tpu_torch.utils.weights import flax_to_state_dict
from torch_testutil import random_flax_variables

cv2 = pytest.importorskip("cv2")

DET = dict(img_size=128, width_mult=0.25, depth_mult=0.34, batch_size=1, conf_threshold=0.0,
           max_detections=4, dtype="float32", pose_head=True)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(cfg):
    cfg["model"]["hidden_channels"] = 8
    cfg["detector"].update(DET)
    return cfg


@pytest.fixture(scope="module")
def weights():
    """Flax Shopformer and detector variables, and the JAX models."""
    cfg_j = _config(get_default_config_jax())
    sf_j = build_shopformer_jax(cfg_j)
    sf_vars = random_flax_variables(lambda: sf_j.init_variables(jax.random.PRNGKey(0)), 31)
    det_j = PersonDetectorJax(img_size=128, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                              dtype=jnp.float32)
    det_vars = random_flax_variables(
        lambda: det_j.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 128, 128, 3)),
                           train=False), 32)
    return cfg_j, sf_j, sf_vars, det_vars


def _port_parts(weights):
    _cfg_j, _sf_j, sf_vars, det_vars = weights
    cfg = _config(get_default_config())
    sf = build_shopformer(cfg, device="cpu")
    sf.load_state_dict(flax_to_state_dict(sf_vars, sf))
    det_sd = flax_to_state_dict(det_vars, build_detector(cfg, device="cpu"))
    return (ShopformerScorer(sf, cfg, device="cpu"),
            DetectionPipeline(cfg, state_dict=det_sd, device="cpu"))


@pytest.fixture(scope="module")
def server(weights):
    srv = ScoringServer(*_port_parts(weights), port=0)  # ephemeral port
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_server(weights):
    cfg_j, sf_j, sf_vars, det_vars = weights
    srv = ScoringServerJax(ShopformerScorerJax(sf_j, sf_vars, cfg_j),
                           DetectionPipelineJax(cfg_j, variables=det_vars), port=0)
    srv.start()
    yield srv
    srv.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def _post(url, data, content_type="application/json"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _window(server):
    m = server.scorer.config["model"]
    return int(m.get("seq_len", 12)), int(m.get("num_keypoints", 18))


def test_healthz(server):
    status, obj = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert status == 200 and obj["status"] == "ok" and obj["detector"]
    assert set(obj["microbatch"]) == {"score", "detect"}


def test_score_endpoint(server):
    T, V = _window(server)
    poses = np.random.default_rng(0).normal(size=(3, T, V, 2)).tolist()
    status, obj = _post(f"http://127.0.0.1:{server.port}/score",
                        json.dumps({"poses": poses}).encode())
    assert status == 200
    assert len(obj["scores"]) == 3 and all(np.isfinite(obj["scores"]))
    direct = server.scorer.score(np.asarray(poses, np.float32))
    np.testing.assert_allclose(obj["scores"], direct, rtol=1e-5)


def test_detect_endpoint(server):
    img = np.random.default_rng(1).integers(0, 255, (240, 320, 3), np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    status, obj = _post(f"http://127.0.0.1:{server.port}/detect", buf.tobytes(), "image/jpeg")
    assert status == 200
    assert len(obj["boxes"]) == len(obj["scores"]) == len(obj["keypoints"]) == 4
    for b in obj["boxes"]:
        assert len(b) == 4


def test_detect_unmaps_to_source_pixels(server):
    """An oracle detection pipeline shows /detect's canvas->source unmap is
    exact: a box at known canvas coords comes back at the right source
    pixels for a non-square image."""
    size = server.detection.model.img_size
    h, w = 240, 320
    scale, px, py, _nw, _nh = letterbox_params(h, w, size)
    src = np.array([40.0, 60.0, 200.0, 180.0])
    canvas_box = np.array([src[0] * scale + px, src[1] * scale + py,
                           src[2] * scale + px, src[3] * scale + py])

    class Oracle:
        model = server.detection.model

        @staticmethod
        def detect_frames(frames):
            B = frames.shape[0]  # 1 direct, detect_batch via the micro-batcher
            assert frames.shape[1:] == (size, size, 3)
            boxes = np.zeros((B, 1, 4), np.float32)
            boxes[0, 0] = canvas_box
            scores = np.zeros((B, 1), np.float32)
            scores[0, 0] = 0.9
            valid = np.zeros((B, 1), bool)
            valid[0, 0] = True
            return (boxes, np.zeros((B, 1, 4), np.float32), scores, valid)

    real = server.detection
    server.detection = Oracle()
    try:
        img = np.random.default_rng(2).integers(0, 255, (h, w, 3), np.uint8)
        ok, buf = cv2.imencode(".png", img)
        status, obj = _post(f"http://127.0.0.1:{server.port}/detect", buf.tobytes(), "image/png")
        assert status == 200
        np.testing.assert_allclose(obj["boxes"][0], src, atol=0.05)
        assert "keypoints" not in obj
    finally:
        server.detection = real


def test_bad_requests(server):
    status, obj = _post(f"http://127.0.0.1:{server.port}/score",
                        json.dumps({"poses": [[1.0]]}).encode())
    assert status == 400 and "poses" in obj["error"]
    # wrong T: right rank, wrong window shape — must 400
    bad = np.zeros((1, 3, 18, 2)).tolist()
    status, obj = _post(f"http://127.0.0.1:{server.port}/score", json.dumps({"poses": bad}).encode())
    assert status == 400 and "poses must be" in obj["error"]
    status, obj = _post(f"http://127.0.0.1:{server.port}/detect", b"not an image", "image/jpeg")
    assert status == 400
    status, obj = _post(f"http://127.0.0.1:{server.port}/nowhere", b"{}")
    assert status == 404
    status, obj = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert status == 200  # server still alive after errors


def test_detect_without_cv2_answers_501(server, monkeypatch):
    """Where cv2 is not installed /detect answers 501 naming it, and /score
    and /healthz go on serving."""
    img = np.random.default_rng(5).integers(0, 255, (64, 80, 3), np.uint8)
    ok, buf = cv2.imencode(".png", img)
    monkeypatch.setitem(sys.modules, "cv2", None)
    status, obj = _post(f"http://127.0.0.1:{server.port}/detect", buf.tobytes(), "image/png")
    assert status == 501 and "cv2" in obj["error"]
    T, V = _window(server)
    status, obj = _post(f"http://127.0.0.1:{server.port}/score",
                        json.dumps({"poses": np.zeros((1, T, V, 2)).tolist()}).encode())
    assert status == 200 and len(obj["scores"]) == 1


def test_concurrent_score_requests_share_dispatches(server):
    """32 concurrent clients: the micro-batcher packs >1 request per device
    dispatch, with responses equal to serial scoring."""
    T, V = _window(server)
    rng = np.random.default_rng(3)
    payloads = [rng.normal(size=(2, T, V, 2)).astype(np.float32) for _ in range(24)]
    direct = [server.scorer.score(p) for p in payloads]
    url = f"http://127.0.0.1:{server.port}/score"
    mb = server._score_mb
    assert mb is not None
    b0, i0 = mb.batches, mb.items
    old_window = mb._window
    mb._window = 0.03  # force a gather window so batching is deterministic
    try:
        with ThreadPoolExecutor(max_workers=32) as ex:
            results = list(ex.map(
                lambda p: _post(url, json.dumps({"poses": p.tolist()}).encode()), payloads))
    finally:
        mb._window = old_window
    for (status, obj), want in zip(results, direct):
        assert status == 200
        np.testing.assert_allclose(obj["scores"], want, rtol=1e-5)
    di, db = mb.items - i0, mb.batches - b0
    assert di == 24
    assert db < di, f"no batching happened: {db} dispatches for {di} requests"
    _, h = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert h["microbatch"]["score"]["items"] >= 24


def test_concurrent_detect_requests_share_dispatches(server):
    img = np.random.default_rng(4).integers(0, 255, (240, 320, 3), np.uint8)
    ok, buf = cv2.imencode(".png", img)  # png: identical payload each time
    assert ok
    url = f"http://127.0.0.1:{server.port}/detect"
    serial = _post(url, buf.tobytes(), "image/png")[1]
    mb = server._detect_mb
    assert mb is not None
    b0, i0 = mb.batches, mb.items
    old_window = mb._window
    mb._window = 0.03
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            results = [f.result() for f in [ex.submit(_post, url, buf.tobytes(), "image/png")
                                             for _ in range(8)]]
    finally:
        mb._window = old_window
    for status, obj in results:
        assert status == 200
        assert obj == serial  # identical image -> identical response
    di, db = mb.items - i0, mb.batches - b0
    assert di >= 8 and db < di


@pytest.mark.parametrize("microbatch", [False, True], ids=["direct", "microbatch"])
def test_warmup_runs_the_serving_shapes(weights, microbatch):
    """warmup() dispatches the exact batch shapes live traffic uses (the
    scorer pads to data.batch_size; detect sends (1, S, S, 3) without the
    micro-batcher and (detect_batch, S, S, 3) with it), so the first request
    finds cuDNN's choice made and the NMS kernel built. Fresh server: the
    module fixture has already dispatched."""
    scorer, detection = _port_parts(weights)
    srv = ScoringServer(scorer, detection, port=0, microbatch=microbatch, detect_batch=4)
    score_shapes, detect_shapes = [], []
    real_score, real_detect = scorer.score_async, detection.detect_frames
    scorer.score_async = lambda poses: (score_shapes.append(poses.shape), real_score(poses))[1]
    detection.detect_frames = lambda f: (detect_shapes.append(f.shape), real_detect(f))[1]
    try:
        times = srv.warmup()
        T, V = _window(srv)
        S = detection.model.img_size
        n = 4 if microbatch else 1
        assert score_shapes == [(32, T, V, 2)] and detect_shapes == [(n, S, S, 3)]
        assert set(times) == {"score_s", "detect_s"} and all(t >= 0 for t in times.values())
        # live traffic after warmup: the same shapes
        assert len(srv.score({"poses": np.zeros((3, T, V, 2)).tolist()})["scores"]) == 3
        ok, buf = cv2.imencode(".png", np.zeros((50, 70, 3), np.uint8))
        assert "boxes" in srv.detect(buf.tobytes())
        assert set(score_shapes) == {(32, T, V, 2)} and set(detect_shapes) == {(n, S, S, 3)}
    finally:
        srv.stop()


def test_score_and_detect_match_the_jax_server(server, jax_server):
    """The same windows to /score and the same PNG to /detect on both
    servers, with the same flax weights: scores within the Shopformer
    tolerance (rtol 1e-5, atol 1e-6); boxes equal in count and within the
    pipeline's 2e-3 px, keypoints likewise, scores within 1e-5, each plus one
    step of the response's rounding (0.01 px, 1e-4)."""
    T, V = _window(server)
    poses = np.random.default_rng(6).normal(size=(5, T, V, 2)).tolist()
    body = json.dumps({"poses": poses}).encode()
    got = _post(f"http://127.0.0.1:{server.port}/score", body)
    want = _post(f"http://127.0.0.1:{jax_server.port}/score", body)
    assert got[0] == want[0] == 200
    np.testing.assert_allclose(got[1]["scores"], want[1]["scores"], rtol=1e-5, atol=1e-6)
    img = np.random.default_rng(7).integers(0, 255, (240, 320, 3), np.uint8)
    ok, buf = cv2.imencode(".png", img)
    got = _post(f"http://127.0.0.1:{server.port}/detect", buf.tobytes(), "image/png")
    want = _post(f"http://127.0.0.1:{jax_server.port}/detect", buf.tobytes(), "image/png")
    assert got[0] == want[0] == 200
    assert sorted(got[1]) == sorted(want[1]) == ["boxes", "keypoints", "scores"]
    assert len(got[1]["boxes"]) == len(want[1]["boxes"]) == 4
    for key, tol in (("boxes", 2e-3 + 0.01), ("keypoints", 2e-3 + 0.01), ("scores", 1e-5 + 1e-4)):
        np.testing.assert_allclose(got[1][key], want[1][key], atol=tol, rtol=0, err_msg=key)


def _wait_for(cond, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.005)


def test_microbatcher_order_limits_errors_and_stop():
    """Items keep their order and batches their max_items; a run_batch error
    (or a wrong result count) reaches every request of its batch; stop()
    fails what is still queued when the dispatcher does not return, and
    refuses later submits."""
    calls, gate = [], threading.Event()

    def run(items):
        calls.append(list(items))
        assert gate.wait(20)
        if "bad" in items:
            raise ValueError("bad batch")
        if "short" in items:
            return []
        return [x * 2 for x in items]

    mb = MicroBatcher(run, max_items=3)
    results, threads = {}, []

    def submit(x):
        try:
            results[x] = mb.submit(x)
        except Exception as e:  # noqa: BLE001 — recorded for the assertions
            results[x] = e

    def queue(items):
        """Submit each item from its own thread, one after another, each once
        the one before is queued or dispatched."""
        for x in items:
            threads.append(threading.Thread(target=submit, args=(x,)))
            threads[-1].start()
            _wait_for(lambda: any(r.item == x for r in list(mb._pending))
                      or any(x in c for c in calls))

    gate.clear()
    queue([0])
    _wait_for(lambda: len(calls) == 1)  # the dispatcher holds item 0
    queue([1, 2, 3, 4, 5, 6, 7])
    gate.set()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    assert calls == [[0], [1, 2, 3], [4, 5, 6], [7]]
    assert results == {x: 2 * x for x in range(8)}
    assert mb.stats() == {"batches": 4, "items": 8, "items_per_batch": 2.0, "max_batch": 3}

    gate.clear()
    calls.clear()
    threads.clear()
    queue(["a"])
    _wait_for(lambda: len(calls) == 1)
    queue(["b", "bad"])
    gate.set()
    for t in threads:
        t.join(20)
    assert results["a"] == "aa"
    assert all(isinstance(results[x], ValueError) for x in ("b", "bad"))
    threads.clear()
    queue(["short"])
    threads[-1].join(20)
    assert isinstance(results["short"], RuntimeError) and "0 results" in str(results["short"])

    gate.clear()
    threads.clear()
    queue(["x"])
    _wait_for(lambda: calls[-1] == ["x"])
    queue(["y"])
    mb.stop()  # the dispatcher is held in run(["x"]): "y" is failed
    threads[1].join(20)
    assert isinstance(results["y"], RuntimeError) and "stopped" in str(results["y"])
    gate.set()
    threads[0].join(20)
    assert results["x"] == "xx"
    with pytest.raises(RuntimeError, match="stopped"):
        mb.submit("z")
