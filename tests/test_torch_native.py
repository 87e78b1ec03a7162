"""The port's native host runtime (cvsd_tpu_torch/native/, csrc/host/,
utils/host_build.py) against the JAX package's on the CPU: the CSV writer's
bytes, the ring buffer (with a ThreadSanitizer stress run), the
multi-stream decoder in its three modes, VideoBatcher's four host paths,
and Pipeline A's CSVs and the concurrent stream's events with native and
with Python decode; then the selection rule (an explicit True raises
naming the missing compiler or opencv4; a failed automatic build warns once
and falls back) and the build itself (content-hashed names, concurrent
builders, the compile-cache directory).

The port's libraries are built from its own sources with g++ and
``pkg-config opencv4``, which these tests need. The decoders' stamps are OpenCV's
CAP_PROP_POS_MSEC as the system OpenCV reports it; on hosts where that
differs from the Python cv2's (0.0 against 400.0 for later frames, the
reference's known fault), the port's decoder is held to the JAX package's
decoder on every output, stamps included, and to the Python path on frames
and frame numbers only."""

import os
import subprocess
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from cvsd_tpu import native as native_jax  # noqa: E402
from cvsd_tpu.config import get_default_config as get_default_config_jax  # noqa: E402
from cvsd_tpu.data.bbox_schema import read_bboxes as read_bboxes_jax  # noqa: E402
from cvsd_tpu.data.video import VideoBatcher as VideoBatcherJax  # noqa: E402
from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax  # noqa: E402
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax  # noqa: E402
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax  # noqa: E402
from cvsd_tpu.native import video as video_jax  # noqa: E402
from cvsd_tpu.pipeline import preprocess as preprocess_jax  # noqa: E402
from cvsd_tpu.pipeline.streaming import StreamingPipeline as StreamingPipelineJax  # noqa: E402
from cvsd_tpu_torch import native  # noqa: E402
from cvsd_tpu_torch.config import get_default_config  # noqa: E402
from cvsd_tpu_torch.data.bbox_schema import BBox, append_bboxes, read_bboxes  # noqa: E402
from cvsd_tpu_torch.data.video import VideoBatcher, write_test_video  # noqa: E402
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer  # noqa: E402
from cvsd_tpu_torch.models.detector import build_detector  # noqa: E402
from cvsd_tpu_torch.models.shopformer import build_shopformer  # noqa: E402
from cvsd_tpu_torch.native import video as native_video  # noqa: E402
from cvsd_tpu_torch.pipeline import preprocess  # noqa: E402
from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline  # noqa: E402
from cvsd_tpu_torch.utils import cuda_build, host_build  # noqa: E402
from cvsd_tpu_torch.utils.weights import flax_to_state_dict  # noqa: E402
from torch_testutil import random_flax_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"raw": native_video.MODE_RAW, "content": native_video.MODE_CONTENT,
         "canvas": native_video.MODE_CANVAS}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Three 320x240 videos of 18, 22 and 26 frames (the JAX package's
    tests/test_native_decode.py fixture)."""
    d = tmp_path_factory.mktemp("nd")
    return [write_test_video(str(d / f"v{i}.mp4"), num_frames=18 + 4 * i, width=320,
                             height=240, seed=i) for i in range(3)]


def _decode_all_py(path, stride=1):
    """Every stride-th frame through cv2: RGB frames and their 1-based numbers."""
    cap = cv2.VideoCapture(path)
    frames, numbers, n = [], [], 0
    while True:
        ok, f = cap.read()
        if not ok:
            break
        n += 1
        if (n - 1) % stride == 0:
            frames.append(f[..., ::-1].copy())
            numbers.append(n)
    cap.release()
    return frames, numbers


# ---------------------------------------------------------------------------
# the CSV writer


def _rows(seed=0, n=20):
    rng = np.random.default_rng(seed)
    frames = np.arange(1, n + 1, dtype=np.int32)
    persons = rng.integers(1, 4, n).astype(np.float64)
    ltwh = rng.uniform(0, 1, (n, 4)).astype(np.float32).astype(np.float64)
    ltwh[::5] = [1.0, 0.5, 0.25, 0.0]  # integral and short floats
    ltwh[1, 0] = 0.1 + 0.2
    ltwh[2, 1] = 123456.789012345678
    ltwh[3, 2] = 1e-17
    return frames, persons, ltwh


@pytest.mark.parametrize("anom", [True, False])
def test_csv_bytes_match_jax_native_and_python(tmp_path, anom):
    """Two videos' rows appended to one file (long float reprs, integral
    floats, track ids as floats): the port's native writer, the JAX
    package's native writer and the port's Python writer give the same
    bytes; read_bboxes round-trips."""
    label = "Shoplifting" if anom else "Shopping"
    paths = {k: str(tmp_path / f"{k}.csv") for k in ("port", "jax", "python")}
    for clip, name, seed in ((7, "Shoplifting003_x264.mp4", 0), (9, "Shopping001_x264.mp4", 1)):
        frames, persons, ltwh = _rows(seed)
        with native.NativeCsvWriter(paths["port"]) as w:
            assert w.write_video_rows(clip, name, frames, persons, ltwh, anom, label) == 20
        with native_jax.NativeCsvWriter(paths["jax"]) as w:
            w.write_video_rows(clip, name, frames, persons, ltwh, anom, label)
        append_bboxes(paths["python"], [
            BBox(clip, name, int(f), float(p), *map(float, lt), anom, label)
            for f, p, lt in zip(frames, persons, ltwh)])
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["port"] == data["jax"] == data["python"]
    assert len(read_bboxes(paths["port"])) == 40


def test_csv_integral_floats(tmp_path):
    """1.0 prints as '1.0' (Python repr), not '1'; rows end in CRLF."""
    path = str(tmp_path / "n.csv")
    with native.NativeCsvWriter(path) as w:
        w.write_video_rows(1, "v.mp4", np.array([1], np.int32), np.array([2.0]),
                           np.array([[1.0, 0.5, 0.25, 0.0]]), False, "Shopping")
    raw = open(path, "rb").read()
    assert raw == b"1,v.mp4,1,2.0,1.0,0.5,0.25,0.0,False,Shopping\r\n"
    assert read_bboxes(path)[0].person == 2.0
    with pytest.raises(ValueError, match="ltwh"):
        with native.NativeCsvWriter(path) as w:
            w.write_video_rows(1, "v.mp4", np.array([1], np.int32), np.array([2.0]),
                               np.zeros((2, 4)), False, "Shopping")


def test_write_rows_takes_the_native_writer(tmp_path, monkeypatch):
    """preprocess._write_rows writes through the native writer where it
    builds and through the csv module where it does not, the same bytes;
    it refuses rows of two videos."""
    frames, persons, ltwh = _rows()
    rows = [BBox(3, "a.mp4", int(f), float(p), *map(float, lt), True, "Shoplifting")
            for f, p, lt in zip(frames, persons, ltwh)]
    assert preprocess._write_rows(str(tmp_path / "n.csv"), rows) == "native"
    monkeypatch.setattr(native, "available", lambda: False)
    assert preprocess._write_rows(str(tmp_path / "p.csv"), rows) == "python"
    assert open(tmp_path / "n.csv", "rb").read() == open(tmp_path / "p.csv", "rb").read()
    monkeypatch.undo()
    with pytest.raises(ValueError, match="one video"):
        preprocess._write_rows(str(tmp_path / "x.csv"),
                               rows[:2] + [BBox(4, "b.mp4", 1, 1.0, 0, 0, 0, 0, True, "S")])


# ---------------------------------------------------------------------------
# the ring buffer


def test_ring_buffer_producer_consumer():
    rb = native.NativeRingBuffer(slots=3, shape=(4, 4), dtype=np.uint8)
    received = []

    def producer():
        for i in range(40):
            s = rb.acquire_write()
            rb.slot(s)[:] = i
            rb.commit_write(s)
        rb.close()

    t = threading.Thread(target=producer)
    t.start()
    while True:
        s = rb.acquire_read()
        if s < 0:
            break
        received.append(int(rb.slot(s)[0, 0]))
        assert (rb.slot(s) == received[-1]).all()
        rb.release_read(s)
    t.join(10)
    assert not t.is_alive() and received == list(range(40))
    rb.destroy()


def test_ring_buffer_backpressure():
    """A full ring blocks the producer until the consumer frees a slot,
    which is the one the producer gets next."""
    rb = native.NativeRingBuffer(slots=2, shape=(2,), dtype=np.float32)
    s0 = rb.acquire_write()
    rb.commit_write(s0)
    s1 = rb.acquire_write()
    rb.commit_write(s1)
    got = []
    t = threading.Thread(target=lambda: got.append(rb.acquire_write()))
    t.start()
    t.join(0.3)
    assert t.is_alive() and not got  # blocked: no free slot
    r = rb.acquire_read()
    rb.release_read(r)
    t.join(5)
    assert not t.is_alive() and got == [r]
    rb.close()
    assert rb.acquire_write() == -1  # closed
    rb.destroy()


def test_ring_buffer_tsan_stress():
    """The port's copy of ring_stress.cpp built with ThreadSanitizer: a
    producer and a consumer hammer 4 slots with 20,000 items; TSAN exits
    non-zero on any data race."""
    exe = host_build.build_ring_stress_tsan()
    out = subprocess.run([str(exe)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ring stress OK: 20000 items" in out.stdout


# ---------------------------------------------------------------------------
# the multi-stream decoder


def _drain(dec, B):
    batches = []
    while True:
        frames, sidx, fno, stamp, k = dec.next_batch(B)
        batches.append((frames[:k].copy(), sidx[:k].copy(), fno[:k].copy(), stamp[:k].copy(), k))
        if k == 0:
            return batches


def _decoder_args(mode):
    """(out_hw, content_hw, pad_xy) of a 320x240 source in each mode:
    content 128x96, canvas 128x128 with the content at y 16."""
    if mode == "raw":
        return (240, 320), None, (0, 0)
    if mode == "content":
        return (96, 128), (96, 128), (0, 0)
    return (128, 128), (96, 128), (0, 16)


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("mode", ["raw", "content", "canvas"])
def test_decoder_matches_jax_and_python(videos, mode, stride):
    """Two live streams over three videos, batches of 5: every output of
    every batch (frames, stream index, frame number, stamp, count) equals
    the JAX package's decoder's; each stream's frames and numbers equal
    cv2's (read, resized with INTER_LINEAR where the mode resizes, padded
    with 114 on the canvas)."""
    out_hw, content_hw, pad = _decoder_args(mode)
    kw = dict(mode=MODES[mode], content_hw=content_hw, pad_xy=pad, frame_stride=stride)
    with native_video.MultiStreamDecoder(videos, 2, out_hw, **kw) as dec:
        got = _drain(dec, 5)
    ref = video_jax.MultiStreamDecoder(videos, 2, out_hw, **kw)
    want = _drain(ref, 5)
    ref.close()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g[:4], w[:4]):
            np.testing.assert_array_equal(a, b)
        assert g[4] == w[4]
    per = {i: ([], []) for i in range(3)}
    for frames, sidx, fno, _stamp, k in got:
        for b in range(k):
            per[int(sidx[b])][0].append(frames[b])
            per[int(sidx[b])][1].append(int(fno[b]))
    for i, path in enumerate(videos):
        py_frames, py_numbers = _decode_all_py(path, stride)
        assert per[i][1] == py_numbers
        for f, p in zip(per[i][0], py_frames):
            if mode == "raw":
                np.testing.assert_array_equal(f, p)
                continue
            r = cv2.resize(np.ascontiguousarray(p), (128, 96), interpolation=cv2.INTER_LINEAR)
            if mode == "content":
                np.testing.assert_array_equal(f, r)
            else:
                assert (f[:16] == 114).all() and (f[112:] == 114).all()
                np.testing.assert_array_equal(f[16:112], r)


def test_decoder_round_robin_and_eof_rollover(videos):
    """Two live streams round-robin; the queued third opens when one ends;
    next_batch_into fills a caller's buffer and zeroes the numbers past k."""
    dec = native_video.MultiStreamDecoder(videos, 2, (240, 320))
    seen = []
    while True:
        _, sidx, fno, _, k = dec.next_batch(4)
        if k == 0:
            break
        seen.extend((int(sidx[b]), int(fno[b])) for b in range(k))
    dec.close()
    per = {i: [f for s, f in seen if s == i] for i in range(3)}
    assert [len(per[i]) for i in range(3)] == [18, 22, 26]
    for i in range(3):
        assert per[i] == list(range(1, len(per[i]) + 1))
    first2 = seen.index((2, 1))
    assert (0, 18) in seen[:first2]
    assert seen[:4] == [(0, 1), (1, 1), (0, 2), (1, 2)]
    dec = native_video.MultiStreamDecoder(videos[:1], 1, (240, 320))
    buf = np.full((32, 240, 320, 3), 7, np.uint8)
    fno, stamp, k = dec.next_batch_into(buf)
    assert k == 18 and fno.tolist() == list(range(1, 19)) + [0] * 14
    assert (stamp[k:] == 0).all()
    with pytest.raises(ValueError, match="uint8"):
        dec.next_batch_into(np.zeros((2, 240, 320, 3), np.float32))
    dec.close()
    with pytest.raises(ValueError, match="CONTENT"):
        native_video.MultiStreamDecoder(videos, 1, (96, 128), native_video.MODE_CONTENT,
                                        (90, 128))
    with pytest.raises(RuntimeError, match="stride"):
        native_video.MultiStreamDecoder(videos, 1, (240, 320), frame_stride=0)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("decode", [False, True])
def test_video_batcher_matches_jax(tmp_path, ring, decode, stride):
    """Each of VideoBatcher's four host paths gives the JAX package's
    batches on the same path (frames, numbers, stamps, mask, padding), and
    the Python path's frames and numbers."""
    p = write_test_video(str(tmp_path / "v.mp4"), num_frames=37, width=160, height=128, seed=3)

    def collect(cls, **kw):
        return [(b.frames.copy(), b.frame_numbers.copy(), b.timestamps_ms.copy(), b.mask.copy())
                for b in cls(p, batch_size=8, frame_stride=stride, **kw)]

    port = VideoBatcher(p, batch_size=8, use_native_ring=ring, use_native_decode=decode)
    assert port.host_path == {"decode": "native" if decode else "python",
                              "ring": "native" if ring else "python"}
    got = collect(VideoBatcher, use_native_ring=ring, use_native_decode=decode)
    want = collect(VideoBatcherJax, use_native_ring=ring, use_native_decode=decode)
    py = collect(VideoBatcher, use_native_ring=False, use_native_decode=False)
    assert len(got) == len(want) == len(py) == -(-len(range(1, 38, stride)) // 8)
    for g, w, q in zip(got, want, py):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g[0], q[0])
        np.testing.assert_array_equal(g[1], q[1])
        np.testing.assert_array_equal(g[3], q[3])
    numbers = np.concatenate([g[1][g[3]] for g in got])
    assert numbers.tolist() == list(range(1, 38, stride))


def test_video_batcher_stops_early_on_the_ring(tmp_path):
    """A consumer that leaves after one batch releases the ring's producer
    (the generator's close unblocks it) and the next batcher runs."""
    p = write_test_video(str(tmp_path / "v.mp4"), num_frames=40, width=96, height=64)
    it = iter(VideoBatcher(p, batch_size=4, prefetch=1, use_native_ring=True))
    first = next(it)
    assert first.frame_numbers.tolist() == [1, 2, 3, 4]
    it.close()
    n = sum(int(b.mask.sum()) for b in VideoBatcher(p, batch_size=4, use_native_ring=True))
    assert n == 40


# ---------------------------------------------------------------------------
# Pipeline A and the concurrent stream, native decode against Python decode


S = 64
DET = dict(img_size=S, width_mult=0.25, depth_mult=0.34, batch_size=8, conf_threshold=0.0,
           max_detections=8, dtype="float32")


@pytest.fixture(scope="module")
def ucf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ucf")
    (d / "Shoplifting").mkdir()
    (d / "Shopping").mkdir()
    for i in range(2):
        write_test_video(str(d / "Shoplifting" / f"Shoplifting00{i + 1}_x264.mp4"),
                         num_frames=20 + 3 * i, width=160, height=128, seed=i)
        write_test_video(str(d / "Shopping" / f"Shopping00{i + 1}_x264.mp4"),
                         num_frames=18 + 5 * i, width=160, height=128, seed=10 + i)
    (d / "Anomaly_Train.txt").write_text("\n".join(
        f"{c}/{c}00{i}_x264.mp4" for i in (1, 2) for c in ("Shoplifting", "Shopping")))
    return str(d)


@pytest.fixture(scope="module")
def det_weights():
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=0,
                           dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        71)
    cfg = get_default_config()
    cfg["detector"].update(DET)
    return variables, flax_to_state_dict(variables, build_detector(cfg, device="cpu"))


def _csvs(out_dir):
    return {n: open(os.path.join(out_dir, n), "rb").read() for n in sorted(os.listdir(out_dir))}


@pytest.mark.parametrize("host_lb", [False, True, "content"])
def test_preprocess_csv_native_python_and_jax(ucf_dir, det_weights, tmp_path, host_lb):
    """Pipeline A's CSVs in each letterbox mode: the port with native decode
    and the native writer (multiplexed over 3 streams, and one video at a
    time through the native VideoBatcher) gives the bytes of the port with
    cv2 decode; against the JAX package's driver (its native decoder), equal
    keys (clip, name, frame, person, labels) and boxes within 2e-3 px (the
    float32 detectors sum in another order: tests/test_torch_pipeline_a.py).
    The results report the host path each took."""
    variables, sd = det_weights
    outs = {}
    stats = {}
    cfg = get_default_config()
    cfg["detector"].update(DET, host_letterbox=host_lb)
    pipe = preprocess.DetectionPipeline(cfg, state_dict=sd, device="cpu")
    for native_decode, streams in ((True, 3), (False, 3), (True, 1)):
        pipe.config["detector"]["native_decode"] = native_decode
        out = str(tmp_path / f"port_{native_decode}_{streams}")
        stats[(native_decode, streams)] = preprocess.preprocess_ucf_crime(
            pipe.config, ucf_dir, output_dir=out, verbose=False, pipeline=pipe,
            max_streams=streams)
        outs[(native_decode, streams)] = _csvs(out)
    cfg_j = get_default_config_jax()
    cfg_j["detector"].update(DET, host_letterbox=host_lb, native_decode=True)
    pipe_j = preprocess_jax.DetectionPipeline(cfg_j, variables=variables)
    out_j = str(tmp_path / "jax")
    preprocess_jax.preprocess_ucf_crime(cfg_j, ucf_dir, output_dir=out_j, verbose=False,
                                        pipeline=pipe_j, max_streams=3)
    ref = outs[(True, 3)]
    assert sorted(ref) == ["ucf-crime_dataset-normal.csv", "ucf-crime_dataset.csv"]
    assert all(ref.values())
    for key, got in outs.items():
        assert got == ref, key
    key = ("clip", "name", "frame", "person", "is_anomaly", "anomaly")
    for name in ref:
        rows_t = read_bboxes(str(tmp_path / "port_True_3" / name))
        rows_j = read_bboxes_jax(os.path.join(out_j, name))
        assert len(rows_t) == len(rows_j) > 0
        assert [tuple(getattr(r, k) for k in key) for r in rows_t] == \
               [tuple(getattr(r, k) for k in key) for r in rows_j]
        for field, size in (("left", 160), ("top", 128), ("width", 160), ("height", 128)):
            np.testing.assert_allclose(np.array([getattr(r, field) for r in rows_t]) * size,
                                       np.array([getattr(r, field) for r in rows_j]) * size,
                                       rtol=0, atol=2e-3, err_msg=field)
    assert stats[(True, 3)]["host_path"] == {"decode": "native", "csv_writer": "native"}
    assert stats[(False, 3)]["host_path"] == {"decode": "python", "csv_writer": "native"}
    assert stats[(True, 1)]["host_path"] == {"decode": "native", "ring": "native",
                                             "csv_writer": "native"}
    assert stats[(True, 3)]["frames"] == stats[(False, 3)]["frames"] == 20 + 23 + 18 + 23


def _stream_config(cfg, host_lb, native_decode):
    cfg["detector"].update(img_size=S, width_mult=0.25, depth_mult=0.34, batch_size=4,
                           conf_threshold=0.0, max_detections=2, dtype="float32",
                           pose_head=True, host_letterbox=host_lb, native_decode=native_decode)
    cfg["model"]["hidden_channels"] = 8
    cfg["data"]["stride"] = 6
    return cfg


def _events(out):
    return {(e.video, e.track_id, e.frame_end): (e.score, tuple(e.frames), e.timestamp_ms)
            for e in out["events"]}


@pytest.mark.parametrize("host_lb", [False, "content"])
def test_stream_events_native_python_and_jax(tmp_path, host_lb):
    """stream_videos_concurrent over 4 videos in 2 streams: the port with
    native decode gives the JAX package's native-decode events (keys,
    frames, stamps; scores within 1e-4, float32 sums in another order) and
    the port's cv2-decode events bit for bit except the stamps, which are
    the decoder's (module docstring)."""
    vids = [write_test_video(str(tmp_path / f"s{i}.mp4"), num_frames=20 + 4 * i, width=160,
                             height=128, seed=20 + i) for i in range(4)]
    det_j = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                              dtype=jnp.float32)
    det_vars = random_flax_variables(
        lambda: det_j.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)),
                           train=False), 31)
    cfg_j = _stream_config(get_default_config_jax(), host_lb, True)
    sf_j = build_shopformer_jax(cfg_j)
    sf_vars = random_flax_variables(lambda: sf_j.init_variables(jax.random.PRNGKey(0)), 32)
    out_j = StreamingPipelineJax(cfg_j, ShopformerScorerJax(sf_j, sf_vars, cfg_j),
                                 detector_variables=det_vars).stream_videos_concurrent(
                                     vids, max_streams=2)
    outs = {}
    for native_decode in (True, False):
        cfg = _stream_config(get_default_config(), host_lb, native_decode)
        det_sd = flax_to_state_dict(det_vars, build_detector(cfg, device="cpu"))
        sf = build_shopformer(cfg, device="cpu")
        sf.load_state_dict(flax_to_state_dict(sf_vars, sf))
        pipe = StreamingPipeline(cfg, ShopformerScorer(sf, cfg, device="cpu"),
                                 detector_state_dict=det_sd, device="cpu")
        outs[native_decode] = pipe.stream_videos_concurrent(vids, max_streams=2)
        assert outs[native_decode]["host_path"] == {
            "decode": "native" if native_decode else "python"}
    ref, nat, py = _events(out_j), _events(outs[True]), _events(outs[False])
    assert len(nat) > 10 and sorted(nat) == sorted(ref) == sorted(py)
    for key, (score, frames, stamp) in nat.items():
        assert abs(score - ref[key][0]) < 1e-4 and frames == ref[key][1] and stamp == ref[key][2]
        assert score == py[key][0] and frames == py[key][1], key
    assert outs[True]["frames"] == outs[False]["frames"] == out_j["frames"] == 104
    assert outs[True]["videos"] == outs[False]["videos"] == 4


# ---------------------------------------------------------------------------
# the selection rule and the build


@pytest.fixture
def fresh_native(monkeypatch):
    """Both libraries unloaded and unbuilt, as in a new process."""
    monkeypatch.setattr(native, "_state", {"lib": None, "failure": None, "warned": False})
    monkeypatch.setattr(native_video, "_vstate", {"lib": None, "failure": None, "warned": False})


def test_explicit_true_raises_without_the_compiler(tmp_path, monkeypatch, fresh_native):
    """With the compiler hidden ($CXX names nothing): an explicit True raises
    naming the compiler (ring, decode, the stream's native_decode, the
    preprocess driver); unset falls back to Python and warns once with the
    build's message; False asks for nothing."""
    p = write_test_video(str(tmp_path / "v.mp4"), num_frames=6, width=96, height=64)
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        VideoBatcher(p, use_native_ring=True, use_native_decode=False)
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        VideoBatcher(p, use_native_ring=False, use_native_decode=True)
    cfg = _stream_config(get_default_config(), False, True)
    with pytest.raises(RuntimeError, match="compiler"):
        StreamingPipeline(cfg, ShopformerScorer(build_shopformer(cfg, device="cpu"), cfg,
                                                device="cpu"), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        b = VideoBatcher(p)
        VideoBatcher(p)
    assert b.host_path == {"decode": "python", "ring": "python"}
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 2  # once per library
    assert all("no-such-compiler-xyz" in m and "Python path" in m for m in msgs)
    assert sum(int(x.mask.sum()) for x in b) == 6
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        VideoBatcher(p, use_native_ring=False, use_native_decode=False)


def test_explicit_true_raises_naming_opencv4(tmp_path, monkeypatch, fresh_native):
    """Without OpenCV's C++ development files the decoder is not built: unset
    falls back quietly (as the reference Makefile skips it), True raises
    naming opencv4, and the CSV writer and ring still build."""
    def missing():
        raise host_build.MissingOpenCV("the native video decoder needs OpenCV's C++ "
                                       "development files: pkg-config opencv4 failed")

    monkeypatch.setattr(host_build, "opencv_flags", missing)
    p = write_test_video(str(tmp_path / "v.mp4"), num_frames=6, width=96, height=64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not native_video.video_available()
        assert VideoBatcher(p).host_path == {"decode": "python", "ring": "native"}
    with pytest.raises(RuntimeError, match="opencv4"):
        VideoBatcher(p, use_native_decode=True)
    cfg = get_default_config()
    cfg["detector"].update(DET, native_decode=True)
    pipe = preprocess.DetectionPipeline(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="opencv4"):
        preprocess.process_videos_multiplexed(pipe, [(p, 1, "Shopping", "v.mp4", "x.csv", False)])
    assert native.available()


def test_build_is_content_hashed_concurrent_and_moved(tmp_path, monkeypatch):
    """Six processes building at once into an empty directory all load one
    library; its name carries the sources' hash; the compile-cache
    directory (cuda_build.BUILD_DIR, which CVSD_COMPILE_CACHE_DIR sets)
    moves it; nothing is written under the JAX package's native/."""
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    build_dir = tmp_path / "cache"
    code = ("import sys; from cvsd_tpu_torch.utils import cuda_build, host_build; "
            "from pathlib import Path; cuda_build.BUILD_DIR = Path(sys.argv[1]); "
            "import ctypes; print(ctypes.CDLL(str(host_build.build_native())).csvw_open)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    for pr in procs:
        out, err = pr.communicate(timeout=300)
        assert pr.returncode == 0, err
    built = sorted(os.listdir(build_dir))
    assert len(built) == 1 and built[0].startswith("cvsd_native-") and built[0].endswith(".so")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build_dir)
    assert host_build.build_native().name == built[0]
    edited = tmp_path / "host"
    edited.mkdir()
    for name in os.listdir(host_build.HOST_DIR):
        (edited / name).write_bytes((host_build.HOST_DIR / name).read_bytes())
    (edited / "csv_writer.cpp").write_text((edited / "csv_writer.cpp").read_text() + "\n// x\n")
    monkeypatch.setattr(host_build, "HOST_DIR", edited)
    assert host_build.build_native().name != built[0]
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before
    env = dict(os.environ, CVSD_COMPILE_CACHE_DIR=str(tmp_path / "env_cache"))
    r = subprocess.run([sys.executable, "-c",
                        "from cvsd_tpu_torch.cli import common; "
                        "from cvsd_tpu_torch.utils import host_build; "
                        "print(host_build.build_native())"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().startswith(str((tmp_path / "env_cache").resolve()))
