"""Data-parallel detection in the port (DetectionPipeline, StreamingPipeline,
preprocess_ucf_crime and cli.stream with a mesh) against the JAX package's
meshed results and the port's own single-process ones, on the CPU.

The port's side runs once for the module in a world of 2 spawned gloo
processes (``parallel/distributed.py::spawn_world``); the JAX side on a
2-device mesh of the 8 virtual CPU devices from tests/conftest.py. Both
take the same seeded inputs and the same flax variables. Limits are the
JAX package's mesh tests' (tests/test_detection_mesh.py): detection 1e-4,
top-down pose 2e-3. The module imports no JAX at top level: the spawned
processes import it."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cvsd_tpu_torch.config import get_default_config
from cvsd_tpu_torch.parallel.distributed import spawn_world
from cvsd_tpu_torch.parallel.mesh import MeshConfig, build_mesh

cv2 = pytest.importorskip("cv2")

HEAD = dict(img_size=128, width_mult=0.25, depth_mult=0.34, batch_size=8, conf_threshold=0.0,
            max_detections=8, dtype="float32", pose_head=True, native_decode=False)
TOPDOWN = dict(img_size=64, width_mult=0.25, depth_mult=0.34, batch_size=8, conf_threshold=0.0,
               max_detections=4, dtype="float32", pose_mode="topdown", native_decode=False,
               pose_topdown={"num_keypoints": 17, "width": 8, "crop_size": 32})
UCF = dict(img_size=128, width_mult=0.25, depth_mult=0.34, batch_size=8, conf_threshold=0.0,
           max_detections=8, dtype="float32", native_decode=False)
STREAM = dict(img_size=64, width_mult=0.25, depth_mult=0.34, batch_size=4, conf_threshold=0.0,
              max_detections=2, dtype="float32", pose_head=True, native_decode=False)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(det, hidden=8, stride=6):
    cfg = get_default_config()
    cfg["detector"].update(det)
    cfg["model"]["hidden_channels"] = hidden
    cfg["data"]["stride"] = stride
    return cfg


def ekey(e):
    return (e.video, e.track_id, e.frame_end)


def _pipelines(inp, mesh_config):
    """The head and top-down DetectionPipelines of ``inp``'s weights."""
    from cvsd_tpu_torch.models.pose_topdown import build_pose_topdown
    from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline

    pose = build_pose_topdown(_cfg(TOPDOWN), "cpu", 0)
    pose.load_state_dict(inp["pose_sd"])
    head = DetectionPipeline(_cfg(HEAD), state_dict=inp["head_sd"], device="cpu",
                             mesh_config=mesh_config)
    top = DetectionPipeline(_cfg(TOPDOWN), state_dict=inp["top_sd"], device="cpu",
                            mesh_config=mesh_config, pose_model=pose)
    return head, top


def _streaming(inp, mesh_config):
    from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
    from cvsd_tpu_torch.models.shopformer import build_shopformer
    from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline

    cfg = _cfg(STREAM)
    sf = build_shopformer(cfg, device="cpu")
    sf.load_state_dict(inp["sf_sd"])
    pipe = StreamingPipeline(cfg, ShopformerScorer(sf, cfg, device="cpu"),
                             detector_state_dict=inp["stream_sd"], device="cpu",
                             mesh_config=mesh_config)
    return pipe.stream_videos_concurrent(inp["videos"], max_streams=4)["events"]


def _stream_cli(inp, out, extra=()):
    """cli.stream on the fixture's videos; returns (events from --output or
    None where the file was not written, the pipeline's mesh)."""
    import json

    from cvsd_tpu_torch.cli import stream as stream_cli
    from cvsd_tpu_torch.pipeline import streaming

    made = []
    cls = streaming.StreamingPipeline

    class Recorded(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    streaming.StreamingPipeline = Recorded
    try:
        args = ["--checkpoint", inp["sf_ckpt"], "--videos", *inp["videos"][:2], "--concurrent",
                "--max_streams", "2", "--output", out, "--events_jsonl", out + "l",
                "--device", "cpu"]
        stream_cli.main(args + [a for k, v in STREAM.items()
                                for a in ("--set", f"detector.{k}={str(v).lower()}")]
                        + list(extra))
    finally:
        streaming.StreamingPipeline = cls
    events = None
    if os.path.exists(out):
        with open(out) as f:
            events = [(e["video"], e["track_id"], e["frame_end"], e["score"])
                      for e in json.load(f)["events"]]
    return events, os.path.exists(out + "l"), made[0].detection.mesh_config is not None


def _port_meshed(inp):
    """One rank of the 2-rank world: every meshed result of the module."""
    from cvsd_tpu_torch.pipeline.preprocess import preprocess_ucf_crime

    rank = dist.get_rank()
    mc = MeshConfig(build_mesh((2,), ("data",)))
    head, top = _pipelines(inp, mc)
    out = {"batch_size": head.batch_size,
           "head": head.detect_frames(inp["frames"]),
           "head_odd": head.detect_frames(inp["frames"][:5]),
           "top": top.detect_frames(inp["frames_small"]),
           "events": [(*ekey(e), e.score) for e in _streaming(inp, mc)]}
    for streams in (1, 2):
        d = os.path.join(inp["tmp"], f"ucf_rank{rank}_streams{streams}")
        stats = preprocess_ucf_crime(_cfg(UCF), inp["ucf_dir"], output_dir=d,
                                     state_dict=inp["ucf_sd"], verbose=False, device="cpu",
                                     mesh_config=mc, max_streams=streams)
        names = sorted(os.listdir(d)) if os.path.isdir(d) else []
        out[f"ucf{streams}"] = (stats["rows"], {n: open(os.path.join(d, n), "rb").read()
                                                for n in names})
    os.environ["WORLD_SIZE"] = "2"  # as torchrun would set it: cli.stream meshes
    out["cli"] = _stream_cli(inp, os.path.join(inp["tmp"], f"cli_rank{rank}.json"))
    out["cli_no_mesh"] = _stream_cli(inp, os.path.join(inp["tmp"], f"nomesh_rank{rank}.json"),
                                     ["--no_mesh"])
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
    from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
    from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
    from cvsd_tpu.config import get_default_config as get_default_config_jax
    from cvsd_tpu_torch.data.video import write_test_video
    from cvsd_tpu_torch.models.detector import build_detector
    from cvsd_tpu_torch.models.pose_topdown import build_pose_topdown
    from cvsd_tpu_torch.models.shopformer import build_shopformer
    from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
    from cvsd_tpu_torch.utils.weights import flax_to_state_dict
    from torch_testutil import random_flax_variables

    tmp = tmp_path_factory.mktemp("meshed")

    def det_vars(size, nk, seed):
        jm = PersonDetectorJax(img_size=size, width_mult=0.25, depth_mult=0.34,
                               num_keypoints=nk, dtype=jnp.float32)
        return random_flax_variables(
            lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, size, size, 3)),
                            train=False), seed)

    pose_j = TopDownPoseNetJax(num_keypoints=17, width=8, crop_size=32)
    cfg_sf = get_default_config_jax()
    cfg_sf["model"]["hidden_channels"] = 8
    sf_j = build_shopformer_jax(cfg_sf)
    variables = {"head": det_vars(128, 17, 31), "top": det_vars(64, 0, 32),
                 "ucf": det_vars(128, 0, 33), "stream": det_vars(64, 17, 34),
                 "pose": random_flax_variables(lambda: pose_j.init_variables(
                     jax.random.PRNGKey(0)), 35),
                 "sf": random_flax_variables(lambda: sf_j.init_variables(
                     jax.random.PRNGKey(0)), 36)}
    cfgs = {"head": _cfg(HEAD), "top": _cfg(TOPDOWN), "ucf": _cfg(UCF), "stream": _cfg(STREAM)}
    inp = {k + "_sd": flax_to_state_dict(variables[k], build_detector(cfgs[k], device="cpu"))
           for k in cfgs}
    inp["pose_sd"] = flax_to_state_dict(variables["pose"],
                                        build_pose_topdown(cfgs["top"], "cpu", 0))
    sf = build_shopformer(cfgs["stream"], device="cpu")
    inp["sf_sd"] = flax_to_state_dict(variables["sf"], sf)
    inp["sf_ckpt"] = str(tmp / "sf.msgpack")
    save_checkpoint(inp["sf_ckpt"], jax.device_get(variables["sf"]),
                    config=cfgs["stream"].to_dict())
    rng = np.random.default_rng(0)
    inp["frames"] = rng.integers(0, 255, (8, 240, 320, 3)).astype(np.uint8)
    inp["frames_small"] = rng.integers(0, 255, (8, 48, 64, 3)).astype(np.uint8)
    inp["videos"] = [write_test_video(str(tmp / f"v{i}.mp4"), num_frames=40, width=160,
                                      height=128, seed=i) for i in range(4)]
    ucf = tmp / "ucf"
    for cat, name, seed in (("Shoplifting", "Shoplifting001_x264.mp4", 0),
                            ("Shopping", "Shopping001_x264.mp4", 1)):
        (ucf / cat).mkdir(parents=True, exist_ok=True)
        write_test_video(str(ucf / cat / name), num_frames=24, seed=seed)
    (ucf / "Anomaly_Train.txt").write_text(
        "Shoplifting/Shoplifting001_x264.mp4\nShopping/Shopping001_x264.mp4\n"
        "Shoplifting/Shoplifting999_missing.mp4")
    inp["ucf_dir"], inp["tmp"] = str(ucf), str(tmp)
    store = tmp / "store"
    store.mkdir()
    # as many threads as this process's (_few_threads): float32 sums split
    # over threads alike, so the single-process bytes can be asked for
    meshed = spawn_world(_port_meshed, 2, (inp,), store_dir=str(store), timeout=300, threads=2)
    return inp, variables, meshed


@pytest.fixture(scope="module")
def jax_meshed(inputs):
    """The JAX package's DetectionPipelines and stream on a 2-device mesh."""
    import jax

    from cvsd_tpu.config import get_default_config as get_default_config_jax
    from cvsd_tpu.eval.evaluate import ShopformerScorer as ShopformerScorerJax
    from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
    from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
    from cvsd_tpu.parallel.mesh import MeshConfig as MeshConfigJax
    from cvsd_tpu.parallel.mesh import build_mesh as build_mesh_jax
    from cvsd_tpu.pipeline.preprocess import DetectionPipeline as DetectionPipelineJax
    from cvsd_tpu.pipeline.streaming import StreamingPipeline as StreamingPipelineJax

    inp, variables, _meshed = inputs
    mc = MeshConfigJax(mesh=build_mesh_jax((2,), ("data",), jax.devices()[:2]))

    def cfg(det):
        c = get_default_config_jax()
        c["detector"].update(det)
        c["model"]["hidden_channels"] = 8
        c["data"]["stride"] = 6
        return c

    head = DetectionPipelineJax(cfg(HEAD), variables=variables["head"], mesh_config=mc)
    top = DetectionPipelineJax(
        cfg(TOPDOWN), variables=variables["top"], mesh_config=mc,
        pose_model=TopDownPoseNetJax(num_keypoints=17, width=8, crop_size=32),
        pose_variables=variables["pose"])
    scfg = cfg(STREAM)
    sf = build_shopformer_jax(scfg)
    stream = StreamingPipelineJax(scfg, ShopformerScorerJax(sf, variables["sf"], scfg),
                                  detector_variables=variables["stream"], mesh_config=mc)
    return {"head": head.detect_frames(inp["frames"]),
            "top": top.detect_frames(inp["frames_small"]),
            "events": stream.stream_videos_concurrent(inp["videos"], max_streams=4)["events"]}


def test_meshed_detection_matches_jax_meshed(inputs, jax_meshed):
    """Both ranks return the whole batch (the gathered rows), within 1e-4 of
    the JAX package's meshed pipeline; the batch size stays a multiple of
    the data axis."""
    _inp, _v, meshed = inputs
    for rank_out in meshed:
        assert rank_out["batch_size"] == 8
        assert len(rank_out["head"]) == len(jax_meshed["head"]) == 5
        for got, ref in zip(rank_out["head"], jax_meshed["head"]):
            assert got.shape == ref.shape
            np.testing.assert_allclose(got, ref, atol=1e-4)


def test_meshed_topdown_pose_matches_jax_meshed(inputs, jax_meshed):
    _inp, _v, meshed = inputs
    for rank_out in meshed:
        assert len(rank_out["top"]) == len(jax_meshed["top"]) == 5
        for got, ref in zip(rank_out["top"], jax_meshed["top"]):
            np.testing.assert_allclose(got, ref, atol=2e-3)


def test_meshed_detection_equals_the_single_process(inputs):
    """Each rank's rows through the same weights give the single process's
    outputs bit for bit (as many threads on each side), on both ranks, also
    for a batch that does not split (5 rows, zero-padded to 6)."""
    inp, _v, meshed = inputs
    head, top = _pipelines(inp, None)
    single = {"head": head.detect_frames(inp["frames"]),
              "head_odd": head.detect_frames(inp["frames"][:5]),
              "top": top.detect_frames(inp["frames_small"])}
    for rank_out in meshed:
        for key, ref in single.items():
            for got, r in zip(rank_out[key], ref):
                assert got.shape == r.shape and got.dtype == r.dtype
                np.testing.assert_array_equal(got, r)


def test_meshed_stream_events_match_jax_meshed_and_single(inputs, jax_meshed):
    """The meshed stream's events: the keys of the JAX package's meshed
    stream and of the port's single process, scores within 1e-4 of JAX's
    and equal to the single process's, more than 20."""
    inp, _v, meshed = inputs
    single = [(*ekey(e), e.score) for e in _streaming(inp, None)]
    ref = {ekey(e): e.score for e in jax_meshed["events"]}
    for rank_out in meshed:
        events = rank_out["events"]
        assert len(events) > 20
        assert sorted(e[:3] for e in events) == sorted(ref) == sorted(e[:3] for e in single)
        assert max(abs(e[3] - ref[e[:3]]) for e in events) < 1e-4
        assert sorted(events) == sorted(single)


def test_meshed_preprocess_rank0_writes_the_single_bytes(inputs, tmp_path):
    """preprocess_ucf_crime with the mesh, sequential and multiplexed: rank
    0 writes both CSVs, byte-identical to the single process's; rank 1
    writes nothing and counts the same rows."""
    from cvsd_tpu_torch.pipeline.preprocess import preprocess_ucf_crime

    inp, _v, (r0, r1) = inputs
    for streams in (1, 2):
        d = str(tmp_path / f"single{streams}")
        stats = preprocess_ucf_crime(_cfg(UCF), inp["ucf_dir"], output_dir=d,
                                     state_dict=inp["ucf_sd"], verbose=False, device="cpu",
                                     max_streams=streams)
        ref = {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}
        assert len(ref) == 2 and stats["rows"] > 0
        assert r0[f"ucf{streams}"] == (stats["rows"], ref)
        assert r1[f"ucf{streams}"] == (stats["rows"], {})


def test_meshed_stream_cli_rank0_writes_and_no_mesh(inputs):
    """cli.stream under WORLD_SIZE=2: meshed, rank 0 alone writes --output
    and --events_jsonl, its events those of the unmeshed run; --no_mesh runs
    each rank unmeshed, on its own, each writing its own files."""
    _inp, _v, (r0, r1) = inputs
    events, jsonl, meshed = r0["cli"]
    assert meshed and jsonl and len(events) > 0
    assert r1["cli"] == (None, False, True)
    ref, ref_jsonl, ref_meshed = r0["cli_no_mesh"]
    assert not ref_meshed and ref_jsonl
    assert [e[:3] for e in events] == [e[:3] for e in ref]
    assert events == ref
    assert r1["cli_no_mesh"] == r0["cli_no_mesh"]


def test_one_rank_mesh_is_bit_equal_to_no_mesh(inputs, tmp_path):
    """A world of one: the meshed pipeline's outputs equal the unmeshed ones
    bit for bit (every collective is an identity), as phase 16 holds on the
    card."""
    inp, _v, _m = inputs
    single = _pipelines(inp, None)[0].detect_frames(inp["frames"][:4])
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        got = _pipelines(inp, MeshConfig(build_mesh((1,), ("data",))))[0].detect_frames(
            inp["frames"][:4])
    finally:
        dist.destroy_process_group()
    for g, r in zip(got, single):
        np.testing.assert_array_equal(g, r)
