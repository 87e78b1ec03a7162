"""The port's CLIs against the JAX package's on the CPU: cli.stream on one
cv2-written video with JAX-written checkpoints (events, the live JSONL sink,
thresholds and the annotation join), cli.serve as a subprocess, and the
streaming evaluation and ROC/AUC on seeded data."""

import argparse
import json
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.cli import stream as stream_jax
from cvsd_tpu.cli.common import resolve_config as resolve_config_jax
from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.data.ucf_crime import TemporalAnnotation as TemporalAnnotationJax
from cvsd_tpu.data.video import write_test_video
from cvsd_tpu.eval.streaming_eval import evaluate_streaming as evaluate_streaming_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax
from cvsd_tpu.utils.metrics import compute_auc_roc as compute_auc_roc_jax
from cvsd_tpu.utils.metrics import roc_curve as roc_curve_jax
from cvsd_tpu_torch.cli import serve, stream
from cvsd_tpu_torch.cli.common import resolve_config
from cvsd_tpu_torch.data.ucf_crime import TemporalAnnotation, read_temporal_annotations
from cvsd_tpu_torch.eval import evaluate
from cvsd_tpu_torch.eval.evaluate import load_model
from cvsd_tpu_torch.eval.streaming_eval import evaluate_streaming
from cvsd_tpu_torch.utils.metrics import compute_auc_roc, roc_curve
from torch_testutil import random_flax_variables

cv2 = pytest.importorskip("cv2")
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# the streaming fixture's sizes (test_torch_streaming.py): img 64, conf 0.0,
# two detections, float32, pose head; Shopformer hidden 8, window stride 6
DET = dict(img_size=64, width_mult=0.25, depth_mult=0.34, batch_size=4, conf_threshold=0.0,
           max_detections=2, dtype="float32", pose_head=True)
DECODE = ["--set", "detector.native_decode=false"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two rendered videos, a Shopformer checkpoint and a detector checkpoint
    written by the JAX package, and an annotation file."""
    td = tmp_path_factory.mktemp("cli")
    videos = [write_test_video(str(td / f"clip{i}.mp4"), num_frames=40, width=160, height=128,
                               seed=i) for i in range(2)]
    cfg = get_default_config_jax()
    cfg["detector"].update(DET)
    cfg["model"]["hidden_channels"] = 8
    cfg["data"]["stride"] = 6
    sf = build_shopformer_jax(cfg)
    sf_path = str(td / "stage2_best.msgpack")
    save_checkpoint_jax(sf_path, random_flax_variables(
        lambda: sf.init_variables(jax.random.PRNGKey(0)), 51), config=cfg)
    det = PersonDetectorJax(img_size=64, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                            dtype=jnp.float32)
    det_path = str(td / "detector.msgpack")
    save_checkpoint_jax(det_path, random_flax_variables(
        lambda: det.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                         train=False), 52), config={"detector": DET})
    ann = str(td / "annotations.txt")
    with open(ann, "w") as f:
        f.write("clip0.mp4 Shoplifting 10 25 -1 -1\nclip1.mp4 Normal -1 -1 -1 -1\n")
    return td, videos, sf_path, det_path, ann


def ekey(e):
    return (e["video"], e["track_id"], e["frame_end"])


def _run_both(files, name, extra):
    td, videos, sf_path, det_path, _ann = files
    outs = []
    for tag, main, dev in (("jax", stream_jax.main, []), ("port", stream.main, ["--device", "cpu"])):
        out = str(td / f"{name}_{tag}.json")
        args = ["--checkpoint", sf_path, "--detector_checkpoint", det_path, "--videos", *videos,
                "--output", out, *DECODE, *dev]
        main(args + [a.replace("{tag}", tag) for a in extra])
        with open(out) as f:
            outs.append(json.load(f))
    return outs


def _assert_same_events(got, want, stamps=True):
    """Event keys equal; scores within 1e-4, frames and stamps equal (the
    tolerances of test_torch_streaming.py)."""
    assert len(got) > 5
    assert sorted(map(ekey, got)) == sorted(map(ekey, want))
    ref = {ekey(e): e for e in want}
    for e in got:
        r = ref[ekey(e)]
        assert abs(e["score"] - r["score"]) < 1e-4, ekey(e)
        assert e["frames"] == r["frames"] and e.get("anomalous") == r.get("anomalous")
        assert not stamps or e["timestamp_ms"] == r["timestamp_ms"], ekey(e)


def test_stream_cli_matches_jax(files):
    """Without --concurrent. The reference's sequential path decodes with
    its native decoder wherever that is built, whatever
    detector.native_decode says, and on some hosts that decoder reports 0.0
    for the later frames' stamps (the known tests/test_native_decode.py
    failures), so stamps are held in the --concurrent test only."""
    want, got = _run_both(files, "seq", [])
    _assert_same_events(got["events"], want["events"], stamps=False)
    assert got["videos"] == want["videos"] == 2 and got["frames"] == want["frames"] == 80


def test_stream_cli_sink_threshold_and_annotations_match_jax(files, capsys):
    td, _videos, _sf, _det, ann = files
    want, got = _run_both(files, "conc", [
        "--concurrent", "--max_streams", "2", "--threshold", "0.5", "--annotations", ann,
        "--events_jsonl", str(td / "live_{tag}.jsonl")])
    _assert_same_events(got["events"], want["events"])
    assert all(e["anomalous"] == (e["score"] >= 0.5) for e in got["events"])
    for tag, res in (("jax", want), ("port", got)):
        with open(td / f"live_{tag}.jsonl") as f:
            live = [json.loads(line) for line in f]
        assert sorted(map(ekey, live)) == sorted(map(ekey, res["events"]))
    g, w = got["streaming_eval"], want["streaming_eval"]
    assert g["n_videos"] == w["n_videos"] == 2 and g["n_events"] == w["n_events"]
    assert g["unmatched_videos"] == w["unmatched_videos"] == []
    np.testing.assert_allclose([g["video_auc"], g["event_auc"], *g["video_auc_ci"]],
                               [w["video_auc"], w["event_auc"], *w["video_auc_ci"]], atol=1e-9)
    assert "video AUC (max)" in capsys.readouterr().out


def test_stream_cli_refuses_sink_without_concurrent(files):
    _td, videos, sf_path, _det, _ann = files
    with pytest.raises(SystemExit):
        stream.main(["--checkpoint", sf_path, "--videos", *videos, "--events_jsonl", "x.jsonl",
                     "--device", "cpu"])


def _read_lines(proc, lines: "queue.Queue"):
    for line in proc.stdout:
        lines.put(line)


def _wait_line(lines: "queue.Queue", prefix: str, deadline: float) -> str:
    while True:
        line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
        if line.startswith(prefix):
            return line


def test_serve_cli_subprocess(files):
    """``python -m cvsd_tpu_torch.cli.serve --device cpu --port 0`` warms up,
    prints its address, and answers /healthz and /score as load_model does
    (rtol 1e-5); it stops on SIGTERM."""
    _td, _videos, sf_path, _det, _ann = files
    proc = subprocess.Popen(
        [sys.executable, "-m", "cvsd_tpu_torch.cli.serve", "--checkpoint", sf_path,
         "--device", "cpu", "--port", "0"], cwd=REPO, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    lines: "queue.Queue" = queue.Queue()
    threading.Thread(target=_read_lines, args=(proc, lines), daemon=True).start()
    try:
        deadline = time.monotonic() + 240
        warm = _wait_line(lines, "warmup done:", deadline)
        assert "score_s" in warm and "detect_s" not in warm
        url = _wait_line(lines, "serving on ", deadline).split()[2]
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and not health["detector"]
        poses = np.random.default_rng(11).normal(size=(5, 12, 18, 2)).astype(np.float32)
        req = urllib.request.Request(f"{url}/score",
                                     data=json.dumps({"poses": poses.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            scores = json.loads(r.read())["scores"]
        np.testing.assert_allclose(scores, load_model(sf_path, device="cpu").score(poses),
                                   rtol=1e-5)
    finally:
        proc.terminate()
        proc.wait(30)
    assert proc.returncode is not None


class _Stop(Exception):
    pass


@pytest.mark.parametrize("cli", ["serve", "stream"])
def test_cli_config_file_reaches_load_model(tmp_path, monkeypatch, cli):
    """Without --config, load_model takes the checkpoint's embedded config
    (config=None); with it, the file merged over the defaults, with the
    --set overrides applied over it."""
    seen = []

    def fake_load_model(path, config=None, device=None):
        seen.append(config)
        raise _Stop

    monkeypatch.setattr(evaluate, "load_model", fake_load_model)
    path = tmp_path / "session.yaml"
    path.write_text(json.dumps({"model": {"hidden_channels": 8}, "data": {"stride": 6}}))
    main = {"serve": serve.main, "stream": stream.main}[cli]
    base = ["--checkpoint", "x.msgpack", "--device", "cpu"]
    base += ["--videos", "a.mp4"] if cli == "stream" else []
    for extra in ([], ["--config", str(path), "--set", "data.stride=3"]):
        with pytest.raises(_Stop):
            main(base + extra)
    assert seen[0] is None
    assert seen[1]["model"]["hidden_channels"] == 8 and seen[1]["data"]["stride"] == 3
    assert seen[1]["model"]["num_heads"] == get_default_config_jax()["model"]["num_heads"]


# a YAML file (JSON is YAML) of each kind validate_config accepts or refuses
CONFIG_FILES = {
    "valid": {"model": {"hidden_channels": 8}},
    "heads": {"model": {"num_heads": 7}},
    "seq_len": {"data": {"seq_len": 1}},
    "variant": {"model": {"variant": "v3"}},
    "layout": {"model": {"layout": "coco"}},
}


@pytest.mark.parametrize("case", sorted(CONFIG_FILES))
def test_resolve_config_matches_jax(tmp_path, case):
    """resolve_config: the same config from a file and --set, or the same
    ValueError from validate_config, as the JAX package's."""
    path = tmp_path / "c.yaml"
    path.write_text(json.dumps(CONFIG_FILES[case]))
    args = argparse.Namespace(config=str(path), overrides=["data.stride=3"])
    outs = []
    for fn in (resolve_config, resolve_config_jax):
        try:
            outs.append(fn(args))
        except ValueError as e:
            outs.append(str(e))
    got, want = outs
    if case == "valid":
        assert got["data"]["stride"] == want["data"]["stride"] == 3
        assert got["model"] == want["model"] and got["data"] == want["data"]
    else:
        assert isinstance(got, str) and got == want


@dataclass
class _Event:
    video: str
    track_id: int
    frame_end: int
    timestamp_ms: float
    score: float
    frames: List[int] = field(default_factory=list)


def test_streaming_eval_and_roc_match_jax(tmp_path):
    """evaluate_streaming on seeded events (eventless and unannotated videos
    included) and roc_curve / compute_auc_roc on seeded labels with ties:
    equal to the JAX package's."""
    rng = np.random.default_rng(12)
    events = [_Event(f"dir/v{v}.mp4", int(rng.integers(0, 3)), int(f), 0.0,
                     float(np.round(rng.uniform(), 2)), list(range(int(f) - 11, int(f) + 1)))
              for v in range(6) for f in rng.integers(12, 200, 5)]
    lines = [f"v{v}.mp4 {'Shoplifting' if v % 2 else 'Normal'} "
             f"{'40 90' if v % 2 else '-1 -1'} -1 -1" for v in range(5)] + ["v9.mp4 Normal -1 -1 -1 -1"]
    path = tmp_path / "ann.txt"
    path.write_text("\n".join(lines) + "\nshort line\n")
    anns = read_temporal_annotations(str(path))
    anns_j = [TemporalAnnotationJax(a.name, a.category, a.ranges) for a in anns]
    assert [a.ranges for a in anns][:2] == [[], [(40, 90)]] and len(anns) == 6
    for agg in ("max", "mean", "percentile_95"):
        got = evaluate_streaming(events, anns, aggregation=agg, n_boot=50,
                                 include_eventless_videos=["v9.mp4"])
        want = evaluate_streaming_jax(events, anns_j, aggregation=agg, n_boot=50,
                                      include_eventless_videos=["v9.mp4"])
        assert got.as_dict() == want.as_dict() and got.per_video == want.per_video
        assert got.unmatched_videos == ["v5"]
    labels = rng.integers(0, 2, 300)
    scores = np.round(rng.normal(size=300), 1)  # ties
    for g, w in zip(roc_curve(labels, scores), roc_curve_jax(labels, scores)):
        np.testing.assert_array_equal(g, w)
    got, want = compute_auc_roc(labels, scores), compute_auc_roc_jax(labels, scores)
    assert got[0] == want[0]
    assert compute_auc_roc(np.ones(4), np.arange(4))[0] == 0.5
    assert TemporalAnnotation("a", "b", [(3, 5)]).frame_label(5) == 1
