"""The port's StreamingPipeline against the JAX pipeline on the CPU: the
dryrun phase-3 fixture of __graft_entry__.py on one device (6 rendered
videos x 40 frames at 160x128 through 4 concurrent streams; img 64, conf 0.0,
max_det 2, float32, pose head, Shopformer hidden 8)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.config import load_config as load_config_jax
from cvsd_tpu.data.video import VideoBatcher as VideoBatcherJax
from cvsd_tpu.data.video import write_test_video
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.pipeline.streaming import StreamingPipeline as StreamingPipelineJax
from cvsd_tpu_torch.config import get_default_config, load_config
from cvsd_tpu_torch.data.video import VideoBatcher
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.models.shopformer import build_shopformer
from cvsd_tpu_torch.pipeline.streaming import ArraySource, RoundRobinReader, StreamingPipeline
from cvsd_tpu_torch.utils.weights import flax_to_state_dict
from torch_testutil import random_flax_variables

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(cfg):
    cfg["detector"].update(img_size=64, width_mult=0.25, depth_mult=0.34, batch_size=4,
                           conf_threshold=0.0, max_detections=2, dtype="float32",
                           pose_head=True, native_decode=False)
    cfg["model"]["hidden_channels"] = 8
    cfg["data"]["stride"] = 6
    return cfg


def ekey(e):
    return (e.video, e.track_id, e.frame_end)


def _jax_pipeline(cfg_j=None):
    """(the JAX StreamingPipeline, its detector variables, its Shopformer's)."""
    cfg_j = _config(get_default_config_jax()) if cfg_j is None else cfg_j
    det_j = PersonDetectorJax(img_size=64, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                              dtype=jnp.float32)
    det_vars = random_flax_variables(
        lambda: det_j.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                           train=False), 21)
    sf_j = build_shopformer_jax(cfg_j)
    sf_vars = random_flax_variables(lambda: sf_j.init_variables(jax.random.PRNGKey(0)), 22)
    pipe = StreamingPipelineJax(cfg_j, ShopformerScorerJax(sf_j, sf_vars, cfg_j),
                                detector_variables=det_vars)
    return pipe, det_vars, sf_vars


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    td = tmp_path_factory.mktemp("videos")
    vids = [write_test_video(str(td / f"v{i}.mp4"), num_frames=40, width=160, height=128, seed=i)
            for i in range(6)]
    cfg_t = _config(get_default_config())
    pipe_j, det_vars, sf_vars = _jax_pipeline()
    out_j = pipe_j.stream_videos_concurrent(vids, max_streams=4)

    det_sd = flax_to_state_dict(det_vars, build_detector(cfg_t, device="cpu"))
    sf_t = build_shopformer(cfg_t, device="cpu")
    sf_t.load_state_dict(flax_to_state_dict(sf_vars, sf_t))
    pipe = StreamingPipeline(cfg_t, ShopformerScorer(sf_t, cfg_t, device="cpu"),
                             detector_state_dict=det_sd, device="cpu")
    out_t = pipe.stream_videos_concurrent(vids, max_streams=4)
    return vids, out_j, out_t, pipe


def test_stream_events_match_jax(fixture):
    """Event keys (video, track_id, frame_end) identical; scores within 1e-4
    (float32 detector and scorer sums in another order); > 20 events."""
    _vids, out_j, out_t, _pipe = fixture
    ev_j, ev_t = out_j["events"], out_t["events"]
    assert len(ev_t) > 20
    assert sorted(map(ekey, ev_t)) == sorted(map(ekey, ev_j))
    ref = {ekey(e): e for e in ev_j}
    for e in ev_t:
        r = ref[ekey(e)]
        assert abs(e.score - r.score) < 1e-4, ekey(e)
        assert e.frames == r.frames and e.timestamp_ms == r.timestamp_ms
    assert out_t["frames"] == out_j["frames"] == 240
    assert out_t["videos"] == 6 and out_t["skipped"] == 0


def test_read_batch_seam_gives_the_same_events(fixture):
    """run_stream over in-memory frames (no cv2 in the loop) == the file path."""
    vids, _out_j, out_t, pipe = fixture
    sources = []
    for path in vids:
        cap = cv2.VideoCapture(path)
        frames, stamps = [], []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f[..., ::-1])
            stamps.append(cap.get(cv2.CAP_PROP_POS_MSEC))
        cap.release()
        sources.append(ArraySource(path.rsplit("/", 1)[-1], np.stack(frames), np.asarray(stamps)))
    reader = RoundRobinReader(pipe, sources, (128, 160), max_streams=4)
    events = pipe.run_stream(reader)
    assert reader.n_frames == 240 and reader.n_opened == 6
    assert events == out_t["events"]


def test_stream_video_matches_concurrent(fixture):
    """One video streamed alone gives that video's events of the multiplexed
    run (held against JAX above): the same keys, frames and stamps; scores
    within 1e-5 (the video's windows are scored in other batches)."""
    vids, _out_j, out_t, pipe = fixture
    name = vids[1].rsplit("/", 1)[-1]
    alone = list(pipe.stream_video(vids[1]))
    multiplexed = [e for e in out_t["events"] if e.video == name]
    assert alone and sorted(map(ekey, alone)) == sorted(map(ekey, multiplexed))
    ref = {ekey(e): e for e in multiplexed}
    for e in alone:
        r = ref[ekey(e)]
        assert e.frames == r.frames and e.timestamp_ms == r.timestamp_ms
        assert abs(e.score - r.score) < 1e-5, ekey(e)


@pytest.mark.parametrize("frame_stride", [1, 3])
def test_video_batcher_matches_jax(fixture, frame_stride):
    """The port's VideoBatcher copy yields the reference's batches exactly,
    on the Python path and on the default one (native decode and ring where
    they build, in both packages; tests/test_torch_native.py holds every
    path)."""
    vids = fixture[0]
    for kw in (dict(use_native_ring=False, use_native_decode=False), {}):
        got = list(VideoBatcher(vids[0], batch_size=16, frame_stride=frame_stride, **kw))
        ref = list(VideoBatcherJax(vids[0], batch_size=16, frame_stride=frame_stride, **kw))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            for name in ("frames", "frame_numbers", "mask", "timestamps_ms"):
                np.testing.assert_array_equal(getattr(g, name), getattr(r, name), err_msg=name)


def test_aggregate_events(fixture):
    _vids, _out_j, out_t, _pipe = fixture
    agg = StreamingPipeline.aggregate_events(out_t["events"])
    assert set(agg) == {e.video for e in out_t["events"]}
    for stats in agg.values():
        assert stats["max"] >= stats["mean"]


def test_stream_video_on_frame_matches_jax(fixture, monkeypatch):
    """stream_video's per-frame hook against the JAX package's on one video
    (both decoding with cv2: the reference's batcher is kept off its native
    decoder, which fails parity on this host): every decoded frame once, in
    order, from 1; the same track ids; boxes and keypoints in source pixels
    within 1e-3 px (float32 detectors summing in another order; the stream
    events above hold scores to 1e-4); ``kpts`` None in the same places; and
    the same events as without the hook."""
    vids, _out_j, _out_t, pipe = fixture
    monkeypatch.setattr(VideoBatcherJax, "_native_decode_available", staticmethod(lambda: False))
    pipe_j = _jax_pipeline()[0]
    got, ref = [], []
    ev_t = list(pipe.stream_video(vids[2], on_frame=lambda *a: got.append(a)))
    ev_j = list(pipe_j.stream_video(vids[2], on_frame=lambda *a: ref.append(a)))
    assert [f for f, _s, _d in got] == [f for f, _s, _d in ref] == list(range(1, 41))
    assert sorted(map(ekey, ev_t)) == sorted(map(ekey, ev_j)) and ev_t
    assert ev_t == list(pipe.stream_video(vids[2]))
    n_dets = 0
    for (f, st, dt), (_f, sj, dj) in zip(got, ref):
        assert st == sj, f
        assert [d["track_id"] for d in dt] == [d["track_id"] for d in dj], f
        for a, b in zip(dt, dj):
            np.testing.assert_allclose(a["box"], b["box"], atol=1e-3)
            assert abs(a["score"] - b["score"]) <= 1e-5
            assert (a["kpts"] is None) == (b["kpts"] is None)
            if b["kpts"] is not None:
                assert a["kpts"].shape == (17, 2)
                np.testing.assert_allclose(a["kpts"], b["kpts"], atol=1e-3)
            n_dets += 1
    assert n_dets > 40


PRODUCTION = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "configs", "streaming_production.yaml")


def test_production_config_events_match_jax(tmp_path, monkeypatch):
    """configs/streaming_production.yaml in both packages, cut to the test
    size by ``_config`` (its detector keys ``auto_size``, ``tracker: byte``,
    ``frame_stride: 2``, ``host_letterbox: content``, ``stream_depth: 3``,
    ``fetch_group: 4`` and ``model.num_tokens: 4`` kept), on 4 videos made as
    the fixture's: the same event keys, frames and stamps; scores within
    1e-4, the fixture's limit (the largest gap found on the CPU: 5.72e-06)."""
    cfg_t = _config(load_config(PRODUCTION))
    cfg_j = _config(load_config_jax(PRODUCTION))
    det = cfg_t["detector"]
    assert (det["auto_size"], det["tracker"], det["frame_stride"], det["host_letterbox"],
            det["stream_depth"], det["fetch_group"], cfg_t["model"]["num_tokens"]) == (
        True, "byte", 2, "content", 3, 4, 4)
    monkeypatch.setattr(VideoBatcherJax, "_native_decode_available", staticmethod(lambda: False))
    vids = [write_test_video(str(tmp_path / f"v{i}.mp4"), num_frames=40, width=160, height=128,
                             seed=i) for i in range(4)]
    pipe_j, det_vars, sf_vars = _jax_pipeline(cfg_j)
    out_j = pipe_j.stream_videos_concurrent(vids, max_streams=4)
    sf_t = build_shopformer(cfg_t, device="cpu")
    sf_t.load_state_dict(flax_to_state_dict(sf_vars, sf_t))
    pipe = StreamingPipeline(cfg_t, ShopformerScorer(sf_t, cfg_t, device="cpu"),
                             detector_state_dict=flax_to_state_dict(
                                 det_vars, build_detector(cfg_t, device="cpu")),
                             device="cpu")
    out_t = pipe.stream_videos_concurrent(vids, max_streams=4)
    ev_j, ev_t = out_j["events"], out_t["events"]
    assert len(ev_t) > 10
    assert sorted(map(ekey, ev_t)) == sorted(map(ekey, ev_j))
    ref = {ekey(e): e for e in ev_j}
    for e in ev_t:
        r = ref[ekey(e)]
        assert e.frames == r.frames and e.timestamp_ms == r.timestamp_ms, ekey(e)
        assert abs(e.score - r.score) < 1e-4, ekey(e)
    assert out_t["frames"] == out_j["frames"] == 80  # 4 x 40 frames at frame_stride 2
