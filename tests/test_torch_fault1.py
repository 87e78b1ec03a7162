"""Fault 1's tools: the verdict script (``examples_torch/fault1_verdict.py``)
on known rows and on the committed ``fault1_rows.json``, its motion rule
(i), the motion reading (``examples_torch/fault1_motion.py``) on
hand-built tracks and its replay of the rendered truth, the extracted-pose
sweep's phase A on a detector the JAX package wrote (the swap that reads
the port's later stages at 256 videos on a JAX detector), and the fit
driver's two recipes on one extraction."""

import ast
import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.train import detector_train as jdt
from cvsd_tpu_torch.models.detector import PersonDetector
from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet
from cvsd_tpu_torch.train.detector_train import clipped_adam
from cvsd_tpu_torch.train.pose_topdown_train import TopDownPoseTrainer
from cvsd_tpu_torch.utils.weights import load_flax_variables
from torch_testutil import random_flax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import fault1_fits  # noqa: E402
import fault1_motion  # noqa: E402
import fault1_verdict  # noqa: E402
import sweep_extracted  # noqa: E402

SCRIPT = os.path.join(ROOT, "examples_torch", "fault1_verdict.py")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# PR 14's rows at 64 / 60: window AUC of detector init seeds 0-4 (port) and
# 0-3 (JAX), each through the port's later stages with one pose net
PR14_PORT = [0.6637, 0.7413, 0.7584, 0.7739, 0.7250]
PR14_JAX = [0.8438, 0.7935, 0.5159, 0.7327]


def _brute_interval(port, jax_rows, alpha=0.05):
    """The exact Mann-Whitney interval by enumeration: every way to give n
    of the n + m ranks to the port side, the null distribution of U (pairs
    with the port value above), and the order statistic from it."""
    n, m = len(port), len(jax_rows)
    counts = np.zeros(n * m + 1, np.int64)
    for ranks in itertools.combinations(range(n + m), n):
        counts[sum(r - i for i, r in enumerate(ranks))] += 1
    cdf = np.cumsum(counts) / counts.sum()
    k = int(np.nonzero(cdf <= alpha / 2)[0][-1]) + 1
    d = sorted(p - j for p in port for j in jax_rows)
    return d[k - 1], d[n * m - k]


def _rows(port, jax_rows, **extra):
    return {"rows": [{"package": "port", "seed": i, "window_auc": a} for i, a in enumerate(port)]
            + [{"package": "jax", "seed": i, "window_auc": a} for i, a in enumerate(jax_rows)],
            **extra}


def _committed():
    with open(fault1_verdict.ROWS) as f:
        return json.load(f)


def test_pr14_rows_read_neither():
    """PR 14's nine rows: HL shift -0.0273, the interval the enumeration
    gives (-0.1298, +0.2425), Welch's difference +0.0110; verdict neither."""
    hl = fault1_verdict.hodges_lehmann(PR14_PORT, PR14_JAX)
    assert round(hl["shift"], 4) == -0.0273
    lo, hi = _brute_interval(PR14_PORT, PR14_JAX)
    assert (hl["lo"], hl["hi"]) == (lo, hi)
    assert (round(lo, 4), round(hi, 4)) == (-0.1298, 0.2425)
    assert round(fault1_verdict.welch(PR14_PORT, PR14_JAX)["diff"], 4) == 0.0110
    assert fault1_verdict.decide(_rows(PR14_PORT, PR14_JAX))["verdict"] == "neither"


@pytest.mark.parametrize("n,m", [(3, 3), (5, 4), (6, 7), (10, 10)])
def test_exact_order_statistic_matches_enumeration(n, m):
    """The script's rank-sum recursion gives the enumeration's null
    distribution, so its order statistic; with too few rows no count is
    rare enough and the interval is unbounded."""
    rng = np.random.default_rng(n * 100 + m)
    port, jax_rows = rng.uniform(0.5, 0.9, n), rng.uniform(0.5, 0.9, m)
    hl = fault1_verdict.hodges_lehmann(port, jax_rows)
    if n == m == 3:
        assert hl["k"] == 0 and np.isinf(hl["lo"]) and np.isinf(hl["hi"])
    else:
        assert (hl["lo"], hl["hi"]) == _brute_interval(list(port), list(jax_rows))


def test_rules_on_constructed_readings():
    """Each rule on readings made for it: a wide gap confirms, a tight
    band with the sweep on the JAX detector at the JAX file closes, the
    same band with that sweep near the port's sweep does not."""
    port = [0.70 + 0.005 * i for i in range(10)]
    close = [0.70 + 0.005 * i + 0.001 for i in range(10)]
    sweeps = {"B1_jax_detector": [{"window_auc": 0.95}] * 3,
              "B2_port_phase_a": [{"window_auc": 0.76}] * 3}
    near = {"B1_jax_detector": [{"window_auc": 0.78}] * 3,
            "B2_port_phase_a": [{"window_auc": 0.76}] * 3}
    assert fault1_verdict.decide(_rows(port, close, sweeps=sweeps))["verdict"] == "closed"
    assert fault1_verdict.decide(_rows(port, close, sweeps=near))["verdict"] == "neither"
    far = [a + 0.15 for a in port]
    assert fault1_verdict.decide(_rows(port, far, sweeps=sweeps))["verdict"] == "confirmed"
    assert fault1_verdict.decide(_rows(port, far, sweeps=near))["verdict"] == "neither"


def test_committed_rows_shifted_down_read_confirmed():
    """The committed rows with every port row lowered by 0.15 (the gap
    fault 1 describes) read confirmed."""
    data = _committed()
    for r in data["rows"]:
        if r["package"] == "port":
            r["window_auc"] -= 0.15
    assert fault1_verdict.decide(data)["verdict"] == "confirmed"


def test_committed_rows_one_pose_net():
    """At least ten rows a package in round 1, each with its detector's
    and the pose net's md5, and one pose net in every row."""
    rows = _committed()["rows"]
    for package in ("port", "jax"):
        assert sum(r["package"] == package and r.get("round", 1) == 1 for r in rows) >= 10
    assert all(re.fullmatch(r"[0-9a-f]{32}", r["detector_md5"]) for r in rows)
    assert len({r["pose_md5"] for r in rows}) == 1


def test_script_prints_the_verdict_perf_states():
    """``python examples_torch/fault1_verdict.py`` on the committed rows
    prints the verdict that PERF.md states (its one "Verdict" line, in the
    newest entry on fault 1), and the round-3 verdict, HL shift and interval
    of PERF.md's round-3 line (four decimals), in a process that loads
    neither jax nor the JAX package."""
    code = ("import runpy, sys; sys.argv = [sys.argv[1]]; runpy.run_path(sys.argv[0], "
            "run_name='__main__'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'cvsd_tpu', 'flax')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code, SCRIPT], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    printed = json.loads(r.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "PERF.md")) as f:
        text = f.read().replace("\u2212", "-")
    stated = re.findall(r"Verdict \(`fault1_verdict\.py`\):\s+\*\*(\w+)\*\*", text)
    assert stated == [printed["verdict"]]
    round_three = re.findall(r"Round 3, 26 a side:\s+\*\*(\w+)\*\*,\s+HL\s+([-+]\d\.\d{4})\s+"
                             r"\[([-+]\d\.\d{4}),\s+([-+]\d\.\d{4})\]", text)
    hl = printed["hl"]
    assert printed["rounds"] == 3
    assert round_three == [(printed["verdict"], f"{hl['shift']:+.4f}", f"{hl['lo']:+.4f}",
                            f"{hl['hi']:+.4f}")]


def test_verdict_script_imports_numpy_and_scipy_only():
    tree = ast.parse(open(SCRIPT).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names - {"__future__", "argparse", "json", "os", "typing"} == {"numpy", "scipy"}


IMG = 64


@pytest.fixture(scope="module")
def swapped_phase_a(tmp_path_factory):
    """The sweep's phase A at 2 + 2 videos on a test-sized detector the JAX
    package's ``DetectorTrainer.save`` wrote to ``<out>/phaseA_det.msgpack``
    and a port pose net beside it; the trainings fail if called. Returns
    (out, PoseLift dir, what phase A printed, the detector state it
    extracted with, the written EMA variables)."""
    pytest.importorskip("cv2")
    out = str(tmp_path_factory.mktemp("swap"))
    jm = PersonDetectorJax(img_size=IMG, width_mult=0.25, depth_mult=0.34, dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, IMG, IMG, 3)),
                        train=False), 5)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    mp = pytest.MonkeyPatch()
    mp.setattr(PersonDetectorJax, "init_variables", lambda self, rng, batch_size=1: variables)
    trainer = jdt.DetectorTrainer(jm, lr=2e-3, total_steps=4, warmup_steps=1, ema_decay=0.998)
    trainer.save(os.path.join(out, "phaseA_det.msgpack"), steps=0)
    written = jax.tree_util.tree_map(np.asarray, jax.device_get(trainer.ema_variables))
    pose = TopDownPoseTrainer(TopDownPoseNet(num_keypoints=17, width=8, crop_size=32),
                              total_steps=1, device="cpu")
    pose.save(os.path.join(out, "phaseA_pose.msgpack"), steps=0)

    def no_training(*a, **k):
        raise AssertionError("phase A trained a net beside cached ones")

    seen = {}
    extract = sweep_extracted.extract

    def spy(out_, poselift_dir, marker, detector_state, *a, **k):
        seen["state"] = {k_: v.detach().clone() for k_, v in detector_state.items()}
        return extract(out_, poselift_dir, marker, detector_state, *a, **k)

    mp.setattr(sweep_extracted.example, "train_detector", no_training)
    mp.setattr(sweep_extracted.example, "train_pose_net", no_training)
    mp.setattr(sweep_extracted, "extract", spy)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        poselift = sweep_extracted.build_dataset(out, IMG, 2, 2, 2, 2, torch.device("cpu"))
    mp.undo()
    yield out, poselift, printed.getvalue(), seen["state"], written


def test_sweep_phase_a_extracts_with_the_jax_detector(swapped_phase_a):
    """Phase A trains nothing, says the nets are cached, and extracts with
    exactly the variables the JAX package wrote, carried by
    ``utils/weights.py``."""
    _out, poselift, printed, state, written = swapped_phase_a
    assert "phase A nets cached" in printed
    assert os.path.exists(os.path.join(poselift, ".complete"))
    ref = load_flax_variables(
        PersonDetector(img_size=IMG, width_mult=0.25, depth_mult=0.34, dtype=torch.float32),
        written).state_dict()
    assert set(state) == set(ref)
    for k, v in ref.items():
        assert torch.equal(state[k].cpu(), v), k


def test_example_fit_is_the_sweep_fit_at_seed_42(swapped_phase_a):
    """The example's ``train_scorer`` and the sweep's ``fit_one`` are one
    recipe: on one extraction, ``fit_one`` at experiment seed 42 (sweep
    seed -958) reads the example fit's AUCs to the last bit."""
    out, poselift, *_ = swapped_phase_a
    ex = fault1_fits.run_fit("example", poselift, out, torch.device("cpu"))
    same = fault1_fits.run_fit("tok4:-958", poselift, out, torch.device("cpu"))
    assert ex["experiment_seed"] == same["experiment_seed"] == 42
    assert (ex["window_auc"], ex["video_auc_mean"]) == (same["window_auc"], same["video_auc_mean"])
    assert np.isfinite(ex["window_auc"])


def test_detector_optimizer_over_the_examples_2000_steps():
    """What only many steps exercise: the detector trainer's optimizer
    (clip at global norm 10, Adam, warm-up + cosine to 1 %) at the example's
    settings (lr 2e-3, 100 warm-up steps, 2,000 steps) against the JAX
    trainer's optax chain on one gradient series with a spike every 97th
    step: the rate within 1e-5 of optax's at every step (float32 against
    Python floats) and the parameters within 1e-5 after 2,000 steps
    (1.2e-6 read). The EMA's ramp min(d, (1 + t) / (10 + t)) stays below
    the example's 0.998 for all 2,000 steps in both packages."""
    steps, lr, warmup = 2000, 2e-3, 100
    rng = np.random.default_rng(0)
    shapes = [(64, 32), (32,), (7, 3, 3, 5)]
    init = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(0, 1, s) * (30.0 if t % 97 == 0 else 0.3)).astype(np.float32)
              for s in shapes] for t in range(steps)]
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt = clipped_adam(params, lr, steps, warmup)
    rates = []
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        opt.step()
        rates.append(opt.lr)
    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps, end_value=lr * 0.01)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(schedule))

    @jax.jit
    def update(ps, state, g):
        u, state = tx.update(g, state, ps)
        return optax.apply_updates(ps, u), state

    ref = [jnp.asarray(a) for a in init]
    state = tx.init(ref)
    for g in grads:
        ref, state = update(ref, state, [jnp.asarray(x) for x in g])
    want = np.array([float(schedule(t)) for t in range(steps)])
    np.testing.assert_allclose(np.float64(rates), want, rtol=1e-5, atol=0)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0, atol=1e-5)
    t = np.float32(steps - 1)
    assert (np.float32(1.0) + t) / (np.float32(10.0) + t) < np.float32(0.998)


# --- the motion reading (fault1_motion.py) ---------------------------------

T_HAND = 20
H_HAND = 80.0  # the hand-built truth's box height


def _hand_truth():
    """One person standing still: the same 17 points and a box 80 px high
    in every frame."""
    rng = np.random.default_rng(3)
    kpts = np.repeat(rng.uniform(100, 160, (1, 17, 2)), T_HAND, axis=0)
    boxes = np.repeat(np.array([[90.0, 80.0, 170.0, 80.0 + H_HAND]]), T_HAND, axis=0)
    return boxes, kpts


def _extracted(boxes, kpts, track_of=lambda f: 1):
    """A Test split's pickle content: frames from 1, ``[box, (17, 3)]``."""
    return {f + 1: {track_of(f): [boxes[f], np.concatenate([kpts[f], np.ones((17, 1))], 1)]}
            for f in range(len(boxes))}


@pytest.mark.parametrize("case", ["offset", "jitter", "split"])
def test_motion_reading_on_hand_built_tracks(case):
    """A constant offset of boxes and keypoints reads zero motion residual
    (and the offset as the static error); keypoints jittered by +-d px in x
    from frame to frame read 2d / h on every pair and d / h static; one
    person's frames split between two tracks read 2 tracks, full
    coverage and one pair fewer."""
    boxes, kpts = _hand_truth()
    truth = {"v": (boxes, kpts)}
    if case == "offset":
        got = fault1_motion.motion_reading(
            {"v": _extracted(boxes + 7.0, kpts + np.array([3.0, 4.0]))}, truth)
        for key in ("kpt_motion_median", "kpt_motion_track_mean", "box_motion_median",
                    "box_motion_track_mean"):
            assert got[key] == pytest.approx(0.0, abs=1e-12), key
        assert got["static_kpt_rms"] == pytest.approx(5.0 / H_HAND)
        assert (got["tracks_per_video"], got["frame_coverage"], got["pairs"]) == (1, 1.0, 19)
    elif case == "jitter":
        d = 1.5
        sign = np.where(np.arange(T_HAND) % 2, 1.0, -1.0)[:, None, None]
        got = fault1_motion.motion_reading(
            {"v": _extracted(boxes, kpts + sign * np.array([d, 0.0]))}, truth)
        assert got["kpt_motion_median"] == pytest.approx(2 * d / H_HAND)
        assert got["kpt_motion_track_mean"] == pytest.approx(2 * d / H_HAND)
        assert got["box_motion_median"] == pytest.approx(0.0, abs=1e-12)
        assert got["static_kpt_rms"] == pytest.approx(d / H_HAND)
    else:
        got = fault1_motion.motion_reading(
            {"v": _extracted(boxes, kpts, track_of=lambda f: 1 if f < 10 else 2)}, truth)
        assert (got["tracks_per_video"], got["tracks"], got["frame_coverage"]) == (2, 2, 1.0)
        assert got["pairs"] == 18
        assert got["kpt_motion_median"] == pytest.approx(0.0, abs=1e-12)


def test_replay_is_the_videos_frames():
    """Replaying a held-out video's seed gives the frames render_pose_video
    hands its writer before encoding, byte for byte (the writer is a
    stand-in that keeps them: no cv2 decode), the same again on a second
    replay and under one render_pose_frame call from the same rng state;
    its truth is the replay's boxes and points."""
    import types

    from cvsd_tpu_torch.data import render

    name, _kind, poses, seed = fault1_motion.held_out_specs(4)[2]
    poses = poses[:3]
    written = []

    class Writer:
        def __init__(self, *a):
            pass

        def write(self, frame):
            written.append(frame[..., ::-1].copy())  # BGR back to RGB

        def release(self):
            pass

    fake = types.SimpleNamespace(VideoWriter=Writer, VideoWriter_fourcc=lambda *a: 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", fake)
        render.render_pose_video("unused.mp4", poses, seed=seed)
    first, again = list(fault1_motion.replay(poses, seed)), list(fault1_motion.replay(poses, seed))
    direct = render.render_pose_frame(poses[0], fault1_motion.HEIGHT, fault1_motion.WIDTH,
                                      np.random.default_rng(seed))
    assert name == "test_anomalous_0" and len(written) == len(first) == 3
    for (frame, box, pts), (frame2, box2, pts2), video in zip(first, again, written):
        assert frame.tobytes() == frame2.tobytes() == video.tobytes()
        assert box.tobytes() == box2.tobytes() and pts.tobytes() == pts2.tobytes()
    assert first[0][0].tobytes() == direct[0].tobytes()
    boxes, kpts = fault1_motion.truth_of(poses, seed)
    assert np.array_equal(boxes, np.stack([b for _f, b, _p in first]))
    assert np.array_equal(kpts, np.stack([p for _f, _b, p in first]))


def _motion_rows(port_readings, jax_readings, aucs, key="kpt_motion_median"):
    """Rows with the re-run's window AUC and a motion dict: ``key`` takes
    the given readings, every other reading a seeded draw."""
    rng = np.random.default_rng(11)
    rows = []
    for package, readings in (("port", port_readings), ("jax", jax_readings)):
        for i, (x, auc) in enumerate(zip(readings, aucs)):
            motion = {k: float(rng.uniform()) for k in fault1_verdict.MOTION_READINGS}
            motion[key] = float(x)
            rows.append({"package": package, "seed": i, "window_auc": auc, "motion": motion,
                         "rerun": {"window_auc": auc}})
    return rows


def test_rule_i_on_known_rows():
    """Rule (i) picks the reading that follows the AUC (rho -1 here) and
    reads nothing in seeded noise (next: (iii))."""
    port = 0.100 + 0.001 * np.arange(14)
    aucs = list(0.9 - 2.0 * port)
    r1 = fault1_verdict.rule_i(_motion_rows(port, port, aucs))
    assert r1["reading"] == "kpt_motion_median" and r1["n_port"] == 14
    assert r1["rho"]["kpt_motion_median"] == pytest.approx(-1.0) and r1["next"] == "(ii)"
    assert r1["ranges"]["kpt_motion_median"] == [port[0], port[-1]]
    noise = fault1_verdict.rule_i(_motion_rows(np.random.default_rng(5).uniform(size=14),
                                               port, aucs))
    assert noise["reading"] is None and noise["next"] == "(iii)"
    assert max(abs(v) for v in noise["rho"].values()) < fault1_verdict.RHO_FLOOR


def test_round_three_waits_for_both_sides():
    """Rows of round 3 (the motion rules' (iii)) join the verdict only once
    both packages have them for the same seeds (the committed rows less
    their round 3, then made-up ones): the JAX side alone, or
    port seeds 14-25 beside JAX seeds 14-19, leaves the committed verdict
    as it is; both sides at 14-25, the port's new rows at 0.6 against
    JAX's at 0.9, make it "confirmed" on 26 rows a side."""
    data = _committed()
    data["rows"] = [r for r in data["rows"] if r.get("round", 1) < 3]
    before = fault1_verdict.decide(data)
    data["rows"] += [{"package": "jax", "seed": s, "round": 3, "window_auc": 0.9}
                     for s in range(14, 20)]
    assert fault1_verdict.decide(data) == before
    data["rows"] += [{"package": "port", "seed": s, "round": 3, "window_auc": 0.6}
                     for s in range(14, 26)]
    assert fault1_verdict.decide(data) == before
    data["rows"] += [{"package": "jax", "seed": s, "round": 3, "window_auc": 0.9}
                     for s in range(20, 26)]
    got = fault1_verdict.decide(data)
    assert (got["rounds"], got["n_port"], got["n_jax"], got["verdict"]) == (3, 26, 26,
                                                                            "confirmed")


def test_committed_motion_rows():
    """The committed rows after the motion reading: the 14 port rows of
    rounds 1-2 ran again with their committed md5s and window AUCs to the
    last bit, six JAX rows did too, and round 3 holds seeds 14-25 on each
    side; each package's medians are taken over the rows with a reading."""
    data = _committed()
    port = [r for r in data["rows"] if r["package"] == "port" and r.get("round", 1) < 3]
    assert len(port) == 14 and all(r["rerun"]["md5_match"] for r in port)
    assert all(r["rerun"]["window_auc"] == r["window_auc"] for r in port)
    reruns = [r for r in data["rows"] if r["package"] == "jax" and "rerun" in r]
    assert all(r["rerun"]["md5_match"] and r["rerun"]["window_auc"] == r["window_auc"]
               for r in reruns)
    for package in ("port", "jax"):
        third = sorted(r["seed"] for r in data["rows"]
                       if r.get("round") == 3 and r["package"] == package)
        assert third == list(range(14, 26))
    medians = fault1_verdict.motion_medians(data["rows"])
    assert (medians["port"]["rows"], medians["jax"]["rows"]) == (14 + 12, len(reruns) + 12)
    assert fault1_verdict.rule_i(data["rows"])["reading"] is None


POSE_MD5 = "78ad52dec9424cc92ec06d4501780c30"  # the example's pose net trained on the card


@pytest.mark.parametrize("package", ["port", "jax"])
def test_round_three_holds_seeds_0_to_25_once(package):
    """Each package holds detector init seeds 0-25 exactly once, every row
    at 64 training videos / 60 Shopformer epochs."""
    rows = [r for r in _committed()["rows"] if r["package"] == package]
    assert sorted(r["seed"] for r in rows) == list(range(26))
    assert all((r["train_videos"], r["epochs"]) == (64, 60) for r in rows)


def test_verdict_rows_carry_the_pose_net():
    """Every row the verdict reads (all three rounds, 26 a side) ran with
    the one pose net and carries its detector's md5, its chip call and the
    card's name and power limit."""
    data = _committed()
    res = fault1_verdict.decide(data)
    used = [r for r in data["rows"] if r.get("round", 1) <= res["rounds"]]
    assert (res["rounds"], res["n_port"], res["n_jax"], len(used)) == (3, 26, 26, 52)
    assert {r["pose_md5"] for r in used} == {POSE_MD5}
    assert len({(r["package"], r["detector_md5"]) for r in used}) == 52
    assert all(isinstance(r["call"], int) and r["card"].startswith("NVIDIA H100") for r in used)


CALL_RECORDS = ["rows", "rerun", "spot_checks"]


def _records(data, kind):
    """(pr, call, package, seed) of each record of one kind: the rows, the
    rows' runs again ('rerun'), or the spot checks."""
    if kind == "rows":
        return [(r["pr"], r["call"], r["package"], r["seed"]) for r in data["rows"]]
    if kind == "rerun":
        return [(r["rerun"]["pr"], r["rerun"]["call"], r["package"], r["seed"])
                for r in data["rows"] if "rerun" in r]
    return [(c["pr"], c["call"], c["package"], c["seed"]) for c in data["spot_checks"]]


@pytest.mark.parametrize("kind", CALL_RECORDS)
def test_records_name_a_real_call(kind):
    """Each record's (pr, call) pair is a chip call that ``calls`` lists,
    and that call ran the record's package and seed."""
    data = _committed()
    calls = {(c["pr"], c["call"]): c for c in data["calls"]}
    records = _records(data, kind)
    assert records
    for pr, call, package, seed in records:
        assert seed in calls[(pr, call)][package], (pr, call, package, seed)


def test_every_listed_call_seed_has_its_record():
    """The reverse: each seed a listed call ran is a row, a rerun or a spot
    check that names that call, so no call number stands for another's."""
    data = _committed()
    named = {rec for kind in CALL_RECORDS for rec in _records(data, kind)}
    listed = {(c["pr"], c["call"], package, seed) for c in data["calls"]
              for package in ("port", "jax") for seed in c[package]}
    assert listed == named


def test_spot_checks_repeat_their_rows():
    """Each spot check ran a committed row again with the same pose net and
    repeated its detector md5, window AUC and windows bit for bit."""
    data = _committed()
    rows = {(r["package"], r["seed"]): r for r in data["rows"]}
    assert {(c["package"], c["seed"]) for c in data["spot_checks"]} == {("port", 0), ("jax", 14)}
    for c in data["spot_checks"]:
        row = rows[(c["package"], c["seed"])]
        assert c["md5_match"] and c["auc_match"] and c["windows_match"]
        assert (c["detector_md5"], c["pose_md5"]) == (row["detector_md5"], POSE_MD5)
        assert (c["window_auc"], c["windows"]) == (row["window_auc"], row["windows"])
