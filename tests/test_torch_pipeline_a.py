"""Pipeline A's preprocess driver in the port against the JAX package's on
the CPU: the CSV writer's bytes, the video list and its routing, the whole
driver on a small UCF-Crime layout (in both NMS methods), the multiplexed
driver's bytes against the sequential one's in the three letterbox modes,
the preprocess CLI, the options the port refuses, and the float32 entry
points turning TF32 off.

The JAX side decodes with cv2: its VideoBatcher would pick the native
decoder wherever that is built (cvsd_tpu/data/video.py:88-90), which fails
its own parity tests on some hosts, so each JAX run sets
``detector.native_decode: false`` and patches the batcher's probe."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.data import bbox_schema as bbox_jax
from cvsd_tpu.data import ucf_crime as ucf_jax
from cvsd_tpu.data.video import VideoBatcher as VideoBatcherJax
from cvsd_tpu.data.video import write_test_video as write_test_video_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.pipeline import preprocess as preprocess_jax
from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.data import bbox_schema, ucf_crime
from cvsd_tpu_torch.data.video import write_test_video
from cvsd_tpu_torch.models.detector import build_detector
from cvsd_tpu_torch.pipeline import preprocess
from cvsd_tpu_torch.utils.weights import flax_to_state_dict
from torch_testutil import random_flax_variables

# the JAX package's Pipeline-A fixture detector (tests/test_pipeline_a.py)
S = 128
DET = dict(img_size=S, width_mult=0.25, depth_mult=0.34, batch_size=8, conf_threshold=0.0,
           max_detections=8, dtype="float32", native_decode=False)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cv2_decode_in_jax(monkeypatch):
    monkeypatch.setattr(VideoBatcherJax, "_native_decode_available", staticmethod(lambda: False))


@pytest.fixture(scope="module")
def ucf_dir(tmp_path_factory):
    """tests/test_pipeline_a.py's layout: two 24-frame videos, a filtered-out
    category and a missing file in the list."""
    d = tmp_path_factory.mktemp("ucf")
    (d / "Shoplifting").mkdir()
    (d / "Shopping").mkdir()
    write_test_video(str(d / "Shoplifting" / "Shoplifting001_x264.mp4"), num_frames=24)
    write_test_video(str(d / "Shopping" / "Shopping001_x264.mp4"), num_frames=24, seed=1)
    lines = ["Abuse/Abuse001_x264.mp4", "Shoplifting/Shoplifting001_x264.mp4",
             "Shopping/Shopping001_x264.mp4", "Shoplifting/Shoplifting999_missing.mp4"]
    (d / "Anomaly_Train.txt").write_text("\n".join(lines))
    return str(d)


@pytest.fixture(scope="module")
def weights():
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=0,
                           dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False),
        61)
    cfg = get_default_config()
    cfg["detector"].update(DET)
    return variables, flax_to_state_dict(variables, build_detector(cfg, device="cpu"))


def _configs(**det):
    cfg_j, cfg_t = get_default_config_jax(), get_default_config()
    cfg_j["detector"].update(DET, **det)
    cfg_t["detector"].update(DET, **det)
    return cfg_j, cfg_t


def _det_overrides():
    """DET as the CLIs' --set flags."""
    return [a for k, v in DET.items()
            for a in ("--set", f"detector.{k}={str(v).lower() if isinstance(v, bool) else v}")]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_write_test_video_matches_jax(tmp_path):
    a = write_test_video(str(tmp_path / "a.mp4"), num_frames=5, width=96, height=64, seed=3)
    b = write_test_video_jax(str(tmp_path / "b.mp4"), num_frames=5, width=96, height=64, seed=3)
    assert _read(a) == _read(b)


def test_write_rows_bytes_match_jax(tmp_path):
    """Two videos' rows (floats with long reprs, track ids as floats, both
    flags): the port's writer gives the bytes of the JAX package's
    _write_rows (its native writer where built) and append_bboxes, appended
    without a header; read_bboxes round-trips."""
    vals = [0.1 + 0.2, 1 / 3, 2 / 3, 1e-17, 0.5, 123456.789012345678, 7.0, float(np.float32(0.1))]
    videos = [(7, "Shoplifting001_x264.mp4", True, "Shoplifting"),
              (9, "Shopping001_x264.mp4", False, "Shopping")]
    rows = {clip: [bbox_schema.BBox(clip=clip, name=name, frame=f,
                                    person=float(f % 3) + (0.5 if f == 4 else 0.0),
                                    left=vals[f % 8], top=vals[(f + 1) % 8],
                                    width=vals[(f + 2) % 8], height=vals[(f + 3) % 8],
                                    is_anomaly=anom, anomaly=label)
                   for f in range(1, 12)]
            for clip, name, anom, label in videos}
    port, ref_native, ref_py = (str(tmp_path / n) for n in ("port.csv", "native.csv", "py.csv"))
    written = []
    for clip, name, anom, label in videos:
        rows_j = [bbox_jax.BBox(**vars(r)) for r in rows[clip]]
        preprocess._write_rows(port, rows[clip])
        preprocess_jax._write_rows(ref_native, rows_j, clip, name, anom, label)
        bbox_jax.append_bboxes(ref_py, rows_j)
        written += rows[clip]
    assert _read(port) == _read(ref_py) == _read(ref_native)
    assert b"0.30000000000000004" in _read(port)
    assert bbox_schema.read_bboxes(port) == written
    header = str(tmp_path / "header.csv")
    bbox_schema.append_bboxes(header, written, write_header=True)
    bbox_jax.append_bboxes(str(tmp_path / "header_j.csv"),
                           [bbox_jax.BBox(**vars(r)) for r in written], write_header=True)
    assert _read(header) == _read(str(tmp_path / "header_j.csv"))
    assert bbox_schema.read_bboxes(header, has_header=True) == written
    assert bbox_schema.BBOX_COLUMNS == bbox_jax.BBOX_COLUMNS


def test_read_train_list_and_route_csv_match_jax(tmp_path):
    """1-based indices over the full list (skipped, blank and malformed lines
    counted), the category filter (also None), and routing."""
    p = tmp_path / "Anomaly_Train.txt"
    p.write_text("\n".join([
        "Abuse/Abuse001_x264.mp4", "", "Shoplifting/Shoplifting001_x264.mp4", "no_slash_line",
        "  Shopping/Shopping001_x264.mp4  ", "Stealing/Stealing010_x264.mp4",
        "Shoplifting/Shoplifting999_missing.mp4", "Normal_Videos_event/Normal_001.mp4", ""]))
    for filt in (ucf_crime.DEFAULT_CATEGORY_FILTER, ("Stealing", "Abuse"), None):
        got = [vars(e) for e in ucf_crime.read_train_list(str(p), filt)]
        ref = [vars(e) for e in ucf_jax.read_train_list(str(p), filt)]
        assert got == ref and got
    assert [e["index"] for e in got] == [1, 3, 5, 6, 7, 8]
    assert ucf_crime.ANOMALY_CATEGORIES == ucf_jax.ANOMALY_CATEGORIES
    assert ucf_crime.DEFAULT_CATEGORY_FILTER == ucf_jax.DEFAULT_CATEGORY_FILTER
    for label in ("Shoplifting", "Shopping", "Abuse", "Normal_Videos_event"):
        assert ucf_crime.is_anomaly_label(label) == ucf_jax.is_anomaly_label(label)
        assert ucf_crime.route_csv(label, "out") == ucf_jax.route_csv(label, "out")
        assert ucf_crime.route_csv(label) == ucf_jax.route_csv(label)


@pytest.mark.parametrize("nms_method", ["pallas_fixpoint", "pallas_seq"])
def test_preprocess_ucf_crime_matches_jax(nms_method, ucf_dir, weights, tmp_path,
                                          cv2_decode_in_jax):
    """The whole driver, JAX vs port, same weights: equal stats; per row
    equal clip, name, frame, person, is_anomaly and anomaly; left/top/width/
    height within 2e-3 px over the source size (the detector's float32 sums
    run in another order, tests/test_torch_pipeline.py)."""
    variables, state_dict = weights
    cfg_j, cfg_t = _configs(nms_method=nms_method)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = preprocess_jax.preprocess_ucf_crime(cfg_j, ucf_dir, output_dir=out_j,
                                              variables=variables, verbose=False)
    got = preprocess.preprocess_ucf_crime(cfg_t, ucf_dir, output_dir=out_t, state_dict=state_dict,
                                          verbose=False, device="cpu")
    for k in ("videos", "frames", "rows", "skipped"):
        assert got[k] == ref[k], k
    assert got["videos"] == 2 and got["frames"] == 48 and got["rows"] > 0
    assert got["skipped"] == ["Shoplifting/Shoplifting999_missing.mp4"]
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == sorted([
        ucf_crime.ANOMALY_CSV, ucf_crime.NORMAL_CSV])
    for name in os.listdir(out_t):
        rows_t = bbox_schema.read_bboxes(os.path.join(out_t, name))
        rows_j = bbox_jax.read_bboxes(os.path.join(out_j, name))
        assert len(rows_t) == len(rows_j) > 0
        key = ("clip", "name", "frame", "person", "is_anomaly", "anomaly")
        assert [tuple(getattr(r, k) for k in key) for r in rows_t] == \
               [tuple(getattr(r, k) for k in key) for r in rows_j]
        for field, size in (("left", 320), ("top", 240), ("width", 320), ("height", 240)):
            a = np.array([getattr(r, field) for r in rows_t])
            b = np.array([getattr(r, field) for r in rows_j])
            np.testing.assert_allclose(a * size, b * size, rtol=0, atol=2e-3, err_msg=field)


@pytest.fixture(scope="module")
def seq_and_mux(ucf_dir, tmp_path_factory):
    """The port's sequential and multiplexed (max_streams 4) CSVs in each
    letterbox mode, one pipeline per mode (seeded random weights)."""
    out = {}
    for mode in (False, True, "content"):
        _cfg_j, cfg = _configs(host_letterbox=mode)
        pipe = preprocess.DetectionPipeline(cfg, device="cpu")
        dirs = []
        for streams in (1, 4):
            d = str(tmp_path_factory.mktemp(f"out_{mode}_{streams}"))
            stats = preprocess.preprocess_ucf_crime(cfg, ucf_dir, output_dir=d, verbose=False,
                                                    pipeline=pipe, max_streams=streams)
            dirs.append((d, stats))
        out[mode] = dirs
    return out


@pytest.mark.parametrize("mode", [False, True, "content"], ids=["device", "canvas", "content"])
def test_multiplexed_bytes_equal_sequential(mode, seq_and_mux):
    (seq_dir, s), (mux_dir, m) = seq_and_mux[mode]
    assert m["videos"] == s["videos"] == 2
    assert m["frames"] == s["frames"] == 48
    assert m["rows"] == s["rows"] > 0
    assert set(m["stage_seconds"]) == {"read", "dispatch", "fetch", "track"}
    names = sorted(os.listdir(seq_dir))
    assert names == sorted(os.listdir(mux_dir)) and len(names) == 2
    for name in names:
        assert _read(os.path.join(seq_dir, name)) == _read(os.path.join(mux_dir, name)), name


def test_content_upload_bytes_equal_canvas(seq_and_mux):
    """Content-only upload (the device adds the constant border) gives the
    bytes of the full host canvas."""
    canvas_dir, content_dir = seq_and_mux[True][0][0], seq_and_mux["content"][0][0]
    for name in sorted(os.listdir(canvas_dir)):
        assert _read(os.path.join(canvas_dir, name)) == _read(os.path.join(content_dir, name))


def test_preprocess_cli_matches_library(ucf_dir, tmp_path, capsys):
    """python -m cvsd_tpu_torch.cli.preprocess --device cpu writes the rows of
    the library call with the same config (seeded random weights)."""
    from cvsd_tpu_torch.cli import preprocess as preprocess_cli

    _cfg_j, cfg = _configs()
    lib_dir, cli_dir = str(tmp_path / "lib"), str(tmp_path / "cli")
    stats = preprocess.preprocess_ucf_crime(cfg, ucf_dir, output_dir=lib_dir, verbose=False,
                                            device="cpu")
    preprocess_cli.main(["--dataset_dir", ucf_dir, "--output_dir", cli_dir, "--device", "cpu",
                         *_det_overrides()])
    printed = capsys.readouterr().out
    assert f'"rows": {stats["rows"]}' in printed
    for name in sorted(os.listdir(lib_dir)):
        assert _read(os.path.join(lib_dir, name)) == _read(os.path.join(cli_dir, name))


def test_unported_options_raise(ucf_dir, tmp_path):
    _cfg_j, cfg = _configs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        preprocess.preprocess_ucf_crime(cfg, ucf_dir, output_dir=str(tmp_path), device="cpu",
                                        mesh_config=object())
    cfg["detector"]["native_decode"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        preprocess.preprocess_ucf_crime(cfg, ucf_dir, output_dir=str(tmp_path), device="cpu")
    pipe = preprocess.DetectionPipeline(_configs()[1], device="cpu")
    pipe.config = cfg
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        preprocess.process_videos_multiplexed(pipe, [])
    assert not os.listdir(str(tmp_path))


def _tf32_entry_points(tmp_path):
    """Each float32 entry point, built on the CPU (the CLIs stop at a missing
    file, after they set the flags)."""
    from cvsd_tpu_torch.cli import preprocess as preprocess_cli
    from cvsd_tpu_torch.cli import evaluate as evaluate_cli
    from cvsd_tpu_torch.cli import inference as inference_cli
    from cvsd_tpu_torch.cli import serve, stream, train_tabular
    from cvsd_tpu_torch.cli import train as train_cli
    from cvsd_tpu_torch.eval.evaluate import evaluate_checkpoint
    from cvsd_tpu_torch.infer.inference import run_inference
    from cvsd_tpu_torch.eval.evaluate import ShopformerScorer, load_model
    from cvsd_tpu_torch.models.pose_topdown import build_pose_topdown, load_pose_topdown_checkpoint
    from cvsd_tpu_torch.models.shopformer import build_shopformer
    from cvsd_tpu_torch.models.xception_time import XceptionTimeClassifier
    from cvsd_tpu_torch.train.loop import Trainer, train_from_config

    cfg = _configs()[1]
    missing = str(tmp_path / "missing.msgpack")
    return {
        "ShopformerScorer": lambda: ShopformerScorer(build_shopformer(cfg, device="cpu"), cfg,
                                                     device="cpu"),
        "DetectionPipeline": lambda: preprocess.DetectionPipeline(cfg, device="cpu"),
        "build_pose_topdown": lambda: build_pose_topdown(cfg, device="cpu"),
        "load_pose_topdown_checkpoint": lambda: load_pose_topdown_checkpoint(missing, "cpu"),
        "load_model": lambda: load_model(missing, device="cpu"),
        "XceptionTimeClassifier": lambda: XceptionTimeClassifier(device="cpu"),
        "cli.serve": lambda: serve.main(["--checkpoint", missing, "--device", "cpu"]),
        "cli.stream": lambda: stream.main(["--checkpoint", missing, "--videos", "v.mp4",
                                           "--device", "cpu"]),
        "cli.preprocess": lambda: preprocess_cli.main(
            ["--dataset_dir", str(tmp_path / "none"), "--device", "cpu", *_det_overrides()]),
        "cli.train_tabular": lambda: train_tabular.main(
            ["--csv", str(tmp_path / "none.csv"), "--device", "cpu"]),
        # the trainer stops at the missing PoseLift directory, after the flags
        "Trainer": lambda: Trainer(cfg, device="cpu"),
        "train_from_config": lambda: train_from_config(
            {**cfg, "data": {**cfg["data"], "data_dir": str(tmp_path / "none")}}, device="cpu"),
        "evaluate_checkpoint": lambda: evaluate_checkpoint(missing, device="cpu"),
        "run_inference": lambda: run_inference(missing, device="cpu"),
        "cli.train": lambda: train_cli.main(
            ["--set", f"data.data_dir={tmp_path / 'none'}", "--device", "cpu"]),
        "cli.evaluate": lambda: evaluate_cli.main(["--checkpoint", missing, "--device", "cpu"]),
        "cli.inference": lambda: inference_cli.main(["--checkpoint", missing, "--device", "cpu"]),
    }


@pytest.mark.parametrize("entry", [
    "ShopformerScorer", "DetectionPipeline", "build_pose_topdown",
    "load_pose_topdown_checkpoint", "load_model", "XceptionTimeClassifier", "cli.serve",
    "cli.stream", "cli.preprocess", "cli.train_tabular", "Trainer", "train_from_config",
    "evaluate_checkpoint", "run_inference", "cli.train", "cli.evaluate", "cli.inference"])
def test_float32_entry_point_turns_tf32_off(entry, tmp_path):
    """The port runs float32 as float32 on the card: building a float32
    entry point sets cuDNN's and cuBLAS's TF32 flags to False (set True
    first, so the call is what turns them off)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _tf32_entry_points(tmp_path)[entry]()
        except FileNotFoundError:
            assert entry.startswith("cli.") or entry.startswith("load") or entry in (
                "train_from_config", "evaluate_checkpoint", "run_inference")
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
