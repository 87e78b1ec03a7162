"""The port's training data, metrics, logging, evaluation, inference and the
train / evaluate / inference CLIs against the JAX package's on the CPU. The
numpy parts (PoseAugmentor, the datasets, the batches, the metrics) must be
equal bit for bit; the batched augmentation draws from torch generators, so
it matches JAX where its draws are fixed and in its rates elsewhere."""

import copy
import json
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.config import save_config as save_config_jax
from cvsd_tpu.data import augment as aug_jax
from cvsd_tpu.data.datamodule import PoseLiftDataModule as PoseLiftDataModuleJax
from cvsd_tpu.data.poselift import PoseLiftDataset as PoseLiftDatasetJax
from cvsd_tpu.data.synthetic import SyntheticPoseLiftDataset as SyntheticJax
from cvsd_tpu.eval import evaluate as evaluate_jax
from cvsd_tpu.infer import inference as inference_jax
from cvsd_tpu.utils import metrics as metrics_jax
from cvsd_tpu.utils.logging import ScalarLogger as ScalarLoggerJax
from cvsd_tpu_torch.config import Config, save_config
from cvsd_tpu_torch.data import augment
from cvsd_tpu_torch.data.datamodule import PoseLiftDataModule
from cvsd_tpu_torch.data.poselift import PoseLiftDataset
from cvsd_tpu_torch.data.synthetic import SyntheticPoseLiftDataset
from cvsd_tpu_torch.eval import evaluate
from cvsd_tpu_torch.infer import inference
from cvsd_tpu_torch.train.loop import Trainer
from cvsd_tpu_torch.utils import metrics
from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
from cvsd_tpu_torch.utils.logging import ScalarLogger, StepTimer, device_trace
from cvsd_tpu_torch.utils.weights import state_dict_to_flax


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def binomial_ok(k, n, p, sigmas=5.0):
    """k successes of n within ``sigmas`` standard deviations of n p."""
    return abs(k - n * p) <= sigmas * math.sqrt(n * p * (1 - p))


# ---------------------------------------------------------------- augmentation


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_augmentor_bit_equal(seed):
    """The numpy PoseAugmentor (from a config, every knob on) gives the JAX
    package's arrays bit for bit over 20 sequences of one seed."""
    cfg = get_default_config_jax()
    cfg["data"]["augment"].update(shear_range=[-0.1, 0.1], translate_range=[-0.05, 0.05],
                                  keypoint_dropout_prob=0.1)
    a, b = augment.PoseAugmentor.from_config(cfg, seed), aug_jax.PoseAugmentor.from_config(cfg, seed)
    x = np.random.default_rng(seed).normal(size=(12, 18, 3)).astype(np.float32)
    for _ in range(20):
        np.testing.assert_array_equal(a(x), b(x))


def test_affine_helpers_bit_equal():
    x = np.random.default_rng(2).normal(size=(6, 17, 3)).astype(np.float32)
    for args in ((1.1, 0.9, 0.1, -0.2, 12.0, 0.1, -0.05, True), (1.0, 1.0, 0, 0, 0, 0, 0, False)):
        m = augment.affine_matrix(*args)
        np.testing.assert_array_equal(m, aug_jax.affine_matrix(*args))
        np.testing.assert_array_equal(augment.apply_affine(x, m), aug_jax.apply_affine(x, m))
    np.testing.assert_array_equal(augment.flip_keypoints(x, 17), aug_jax.flip_keypoints(x, 17))


@pytest.mark.parametrize("flip_prob", [0.0, 1.0])
def test_batched_augment_equals_jax_where_draws_are_fixed(flip_prob):
    """flip_prob 0 or 1, scale_range [1.07, 1.07], rotation, shear,
    translation, jitter and both dropouts 0: no draw changes the result, so
    the port's batch equals JAX's within 1e-6 (float32; the affine's
    3-term sums in another order), the confidence channel untouched."""
    poses = np.random.default_rng(3).normal(size=(5, 12, 18, 3)).astype(np.float32)
    kw = dict(flip_prob=flip_prob, jitter_std=0.0, scale_range=(1.07, 1.07), rotation_range=0.0,
              shear_range=0.0, translation_range=0.0, temporal_dropout_prob=0.0,
              keypoint_dropout_prob=0.0)
    ref = np.asarray(aug_jax.batched_augment(jax.random.PRNGKey(0), jnp.asarray(poses), **kw))
    got = augment.batched_augment(torch.Generator().manual_seed(0), torch.from_numpy(poses),
                                  **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., 2], poses[..., 2])


def test_batched_augment_rates_within_binomial_bounds():
    """Over 4,096 windows of 12 x 18: the flip rate (x negated), the temporal
    dropout rate (whole frames zeroed) and the keypoint dropout rate (single
    keypoints zeroed among the kept frames) each within 5 standard deviations
    of its probability; the jitter's standard deviation within 1 %."""
    B, T, V = 4096, 12, 18
    poses = torch.ones(B, T, V, 2)
    poses[:, :, :, 0] = 2.0
    g = torch.Generator().manual_seed(5)
    out = augment.batched_augment(g, poses, flip_prob=0.3, jitter_std=0.0, scale_range=(1, 1),
                                  rotation_range=0.0, temporal_dropout_prob=0.1,
                                  keypoint_dropout_prob=0.05)
    frame_zero = (out == 0).all(-1).all(-1)
    kept = ~frame_zero
    x = out[..., 0]
    flipped = ((x < 0) & kept[..., None]).any(-1).any(-1)
    assert binomial_ok(int(flipped.sum()), B, 0.3)
    assert binomial_ok(int(frame_zero.sum()), B * T, 0.1)
    kp_zero = (out == 0).all(-1) & kept[..., None]
    assert binomial_ok(int(kp_zero.sum()), int(kept.sum()) * V, 0.05)
    jit = augment.batched_augment(torch.Generator().manual_seed(6), torch.zeros(512, T, V, 2),
                                  flip_prob=0.0, jitter_std=0.02, scale_range=(1, 1),
                                  rotation_range=0.0, temporal_dropout_prob=0.0,
                                  keypoint_dropout_prob=0.0)
    assert abs(float(jit.std()) / 0.02 - 1) < 0.01


def _inversions(p):
    return sum(1 for i in range(len(p)) for j in range(i + 1, len(p)) if p[i] > p[j])


def test_time_warp_permutation_is_adjacent_swaps():
    """Every row is a permutation reachable by at most 2 adjacent swaps
    (inversion count <= 2, each frame within 2 of its place); warped rows
    appear at rate prob times the chance the two swaps do not cancel."""
    B, T, prob = 4000, 12, 0.5
    perm = augment.time_warp_permutation(torch.Generator().manual_seed(7), B, T, prob).numpy()
    ident = np.arange(T)
    for row in perm:
        assert sorted(row) == list(ident)
        assert _inversions(row) <= 2 and np.abs(row - ident).max() <= 2
    moved = int((perm != ident).any(1).sum())
    # P(moved) = prob * (1 - P(two swaps at one index)) = prob * (1 - 1/2 * 1/(T-1))
    assert binomial_ok(moved, B, prob * (1 - 0.5 / (T - 1)))
    poses = torch.arange(2 * T, dtype=torch.float32).reshape(2, T, 1, 1).expand(2, T, 3, 2)
    warped = augment.batched_time_warp(torch.Generator().manual_seed(8), poses, 1.0)
    assert sorted(warped[0, :, 0, 0].tolist()) == list(range(T))


@pytest.mark.parametrize("alpha", [0.4, 2.0])
def test_mixup_blend_and_beta_moments(alpha):
    """mixed == lam x + (1 - lam) x[perm] exactly, perm a permutation; over
    3,000 draws lam's mean is 1/2 and its variance 1 / (4 (2 alpha + 1))
    (Beta(alpha, alpha)), each within 5 standard errors."""
    x = torch.randn(6, 12, 18, 2, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(10)
    mixed, lam, perm = augment.batched_mixup(g, x, alpha)
    assert sorted(perm.tolist()) == list(range(6))
    assert torch.equal(mixed, lam * x + (1.0 - lam) * x[perm])
    lams = np.array([float(augment.batched_mixup(g, x[:2], alpha)[1]) for _ in range(3000)])
    var = 1 / (4 * (2 * alpha + 1))
    assert np.all((lams >= 0) & (lams <= 1))  # float32 rounds the tails of Beta(0.4) to 0 or 1
    assert abs(lams.mean() - 0.5) <= 5 * math.sqrt(var / len(lams))
    assert abs(lams.var() - var) <= 5 * var * math.sqrt(2 / len(lams)) * 1.5


def test_batched_augment_from_config_paper_settings():
    """configs/paper.yaml's augmentation through both packages on 2,048
    windows: same shape, finite, and the flip and temporal-dropout rates of
    the two within 5 standard deviations of each other's probability."""
    cfg = get_default_config_jax()
    cfg["data"]["augment"].update(flip_prob=0.3, jitter_std=0.01, scale_range=[0.95, 1.05],
                                  rotation_range=[-5.0, 5.0], temporal_dropout_prob=0.05,
                                  keypoint_dropout_prob=0.0)
    poses = np.ones((2048, 12, 18, 2), np.float32)
    poses[..., 0] = 2.0
    ref = np.asarray(aug_jax.batched_augment_from_config(jax.random.PRNGKey(1), poses, cfg))
    got = augment.batched_augment_from_config(torch.Generator().manual_seed(1),
                                              torch.from_numpy(poses), cfg).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    for out in (got, ref):
        frame_zero = (out == 0).all(-1).all(-1)
        assert binomial_ok(int(frame_zero.sum()), out.shape[0] * 12, 0.05)
        flipped = ((out[..., 0] < 0) & ~frame_zero[..., None]).any(-1).any(-1)
        assert binomial_ok(int(flipped.sum()), out.shape[0], 0.3)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_dataset_bit_equal(split):
    cfg = get_default_config_jax()
    cfg["data"]["synthetic"].update(num_train=40, num_test=24, train_anomaly_ratio=0.1)
    a, b = SyntheticPoseLiftDataset.from_config(cfg, split), SyntheticJax.from_config(cfg, split)
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.video_ids == b.video_ids and a.frame_indices == b.frame_indices
    assert a.get_video_info(3) == b.get_video_info(3) and a[5][1] == b[5][1]
    c = SyntheticPoseLiftDataset(num_samples=8, num_keypoints=17, num_channels=3, seed=4,
                                 normalize=True)
    np.testing.assert_array_equal(c.poses, SyntheticJax(num_samples=8, num_keypoints=17,
                                                        num_channels=3, seed=4,
                                                        normalize=True).poses)


@pytest.fixture
def poselift_dir(tmp_path):
    """A miniature PoseLift tree: two train videos (one person with a frame
    gap, one frame of NaN keypoints, two people) and a test video with GT."""
    rng = np.random.default_rng(11)
    for split in ("Train", "Test"):
        (tmp_path / "Pickle_files" / split).mkdir(parents=True)
    (tmp_path / "Pickle_files" / "GT").mkdir()

    def video(n_frames, n_people, gap_at=(), nan_at=()):
        data = {}
        for f in range(n_frames):
            if f in gap_at:
                continue
            frame = {}
            for p in range(n_people):
                kpts = rng.uniform(100, 200, (17, 3))
                if f in nan_at:
                    kpts[3, 0] = np.nan
                if p == 1:
                    kpts[5, :2] = 0.0  # a missing left shoulder: the neck falls back
                frame[p] = [np.array([0, 0, 50, 50]), kpts]
            data[f] = frame
        return data

    for name, vid in (("cam1_vid1", video(40, 2, gap_at=(20, 21, 22, 23, 24, 25, 26))),
                      ("cam1_vid2", video(30, 1, nan_at=(4,)))):
        with open(tmp_path / "Pickle_files" / "Train" / f"{name}.pkl", "wb") as f:
            pickle.dump(vid, f)
    with open(tmp_path / "Pickle_files" / "Test" / "cam2_vid9.pkl", "wb") as f:
        pickle.dump(video(36, 2), f)
    gt = np.zeros(36)
    gt[15:] = 1
    np.save(tmp_path / "Pickle_files" / "GT" / "cam2_vid9.npy", gt)
    return tmp_path


@pytest.mark.parametrize("split", ["train", "test"])
def test_poselift_dataset_bit_equal(poselift_dir, split):
    cfg = get_default_config_jax()
    cfg["data"]["data_dir"] = str(poselift_dir)
    a = PoseLiftDataset.from_config(cfg, split, verbose=False)
    b = PoseLiftDatasetJax.from_config(cfg, split, verbose=False)
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.video_ids == b.video_ids and a.frame_indices == b.frame_indices
    if split == "test":
        assert 0 < a.labels.sum() < len(a)


def test_datamodule_batches_equal(poselift_dir):
    """PoseLiftDataModule on synthetic data: train batches of epochs 1 and 2
    (seeded by experiment.seed + epoch, drop_last), the padded test batches,
    steps_per_epoch (also padded to a multiple) and get_stats equal JAX's."""
    cfg = get_default_config_jax()
    cfg["data"]["dataset"] = "synthetic"
    cfg["data"]["synthetic"].update(num_train=70, num_test=37)
    cfg["data"]["batch_size"] = 16
    a = PoseLiftDataModule(copy.deepcopy(cfg), verbose=False).setup()
    b = PoseLiftDataModuleJax(cfg, verbose=False).setup()
    for epoch in (1, 2):
        ba, bb = list(a.train_batches(epoch=epoch)), list(b.train_batches(epoch=epoch))
        assert len(ba) == len(bb) == 4
        for x, y in zip(ba, bb):
            assert set(x) == set(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
    for x, y in zip(a.test_batches(), b.test_batches()):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert a.steps_per_epoch() == b.steps_per_epoch() and \
        a.steps_per_epoch(3) == b.steps_per_epoch(3)
    assert a.get_stats() == b.get_stats()
    cfg["data"]["dataset"] = "poselift"
    cfg["data"]["data_dir"] = str(poselift_dir)
    c = PoseLiftDataModule(copy.deepcopy(cfg), verbose=False).setup()
    d = PoseLiftDataModuleJax(cfg, verbose=False).setup()
    assert c.get_stats() == d.get_stats()


# ---------------------------------------------------------------- metrics


def _metric_cases():
    rng = np.random.default_rng(12)
    labels = (rng.random(200) < 0.3).astype(int)
    scores = rng.normal(size=200) + labels
    ties = np.round(scores, 1)
    vids = [f"v{i // 9}" for i in range(200)]
    return {"plain": (labels, scores, vids), "ties": (labels, ties, vids),
            "one_class": (np.zeros(50, int), rng.normal(size=50), vids[:50])}


@pytest.mark.parametrize("case", ["plain", "ties", "one_class"])
def test_metrics_equal(case, capsys):
    """pr_curve, compute_auc_pr, find_optimal_threshold (youden and f1),
    compute_metrics (optimal and fixed thresholds), compute_video_level_metrics
    and print_metrics: equal to JAX's, floats bit for bit."""
    labels, scores, vids = _metric_cases()[case]
    if case != "one_class":
        for a, b in zip(metrics.pr_curve(labels, scores), metrics_jax.pr_curve(labels, scores)):
            np.testing.assert_array_equal(a, b)
    auc_a, auc_b = metrics.compute_auc_pr(labels, scores), metrics_jax.compute_auc_pr(labels, scores)
    assert auc_a[0] == auc_b[0]
    for method in ("youden", "f1"):
        assert metrics.find_optimal_threshold(labels, scores, method) == \
            metrics_jax.find_optimal_threshold(labels, scores, method)
    for thr in (None, 0.3):
        assert metrics.compute_metrics(labels, scores, thr) == \
            metrics_jax.compute_metrics(labels, scores, thr)
    assert metrics.compute_video_level_metrics(labels, scores, vids) == \
        metrics_jax.compute_video_level_metrics(labels, scores, vids)
    m = metrics.compute_metrics(labels, scores)
    metrics.print_metrics(m, "a/")
    mine = capsys.readouterr().out
    metrics_jax.print_metrics(m, "a/")
    assert mine == capsys.readouterr().out


# ---------------------------------------------------------------- logging, config


def test_scalar_logger_and_config_match_jax(tmp_path):
    """ScalarLogger writes the JAX package's JSONL records (time aside) and
    hparams.json; save_config writes the same JSON; StepTimer times; and
    device_trace writes a chrome trace on the CPU."""
    for name, cls in (("port", ScalarLogger), ("jax", ScalarLoggerJax)):
        lg = cls(str(tmp_path / name), tensorboard=False)
        lg.log_scalar("Stage1/Loss", np.float32(0.5), 3)
        lg.log_dict({"a": 1.0, "b": "skip"}, 4, prefix="x/")
        lg.log_hparams({"lr": 1e-3}, {"auc_roc": 0.7})
        lg.close()
    rows = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "scalars.jsonl") as f:
            rows[name] = [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]
    assert rows["port"] == rows["jax"]
    assert (tmp_path / "port" / "hparams.json").read_text() == \
        (tmp_path / "jax" / "hparams.json").read_text()
    cfg = get_default_config_jax()
    save_config(Config(copy.deepcopy(dict(cfg))), str(tmp_path / "p.json"))
    save_config_jax(cfg, str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    timer = StepTimer()
    timer.start()
    assert timer.stop(torch.zeros(2)) >= 0 and timer.mean == timer.times[0]
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    with device_trace(None):
        pass


# ---------------------------------------------------------------- evaluation, inference, CLIs


def tiny_config(ckpt_dir):
    cfg = get_default_config_jax()
    cfg["data"]["dataset"] = "synthetic"
    cfg["data"]["synthetic"].update(num_train=64, num_test=64)
    cfg["data"]["batch_size"] = 16
    cfg["data"]["augment"]["enabled"] = False
    cfg["model"]["hidden_channels"] = 16
    cfg["model"]["dropout"] = 0.0
    cfg["training"].update(stage1_epochs=1, stage2_epochs=2, lr=1e-3,
                           checkpoint_every_n_epochs=1)
    cfg["experiment"]["checkpoint_dir"] = str(ckpt_dir)
    return copy.deepcopy(dict(cfg))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A 1 + 2-epoch fit by the port on the CPU: its stage checkpoints."""
    d = tmp_path_factory.mktemp("port_run")
    tp = Trainer(tiny_config(d / "ckpt"), verbose=False, device="cpu").setup()
    init = str(d / "init.msgpack")
    save_checkpoint(init, state_dict_to_flax(tp.model), config=tp.config.to_dict())
    art = tp.fit()
    return {"dir": d / "ckpt", "init": init, "artifact": art, "root": d}


def _close(a, b, rel=1e-5, path=""):
    """Nested results equal: strings, ints and keys exactly, floats within
    ``rel`` of the larger magnitude (scores differ by float32 rounding)."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], rel, f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, rel, f"{path}[{i}]")
    elif isinstance(b, float) and not isinstance(a, str):
        assert abs(a - b) <= rel * max(abs(a), abs(b), 1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_evaluate_checkpoint_matches_jax(port_run, tmp_path):
    """evaluate_checkpoint on the port's stage2_best (with per-sample scores
    and plots): the same artifact as the JAX package's, keys, the mined
    history and checkpoint names exactly, every number within 1e-5
    relative; metrics.json written by both."""
    path = str(port_run["dir"] / "stage2_best.msgpack")
    ref = evaluate_jax.evaluate_checkpoint(path, output_dir=str(tmp_path / "j"), save_scores=True)
    got = evaluate.evaluate_checkpoint(path, output_dir=str(tmp_path / "p"), save_scores=True,
                                       device="cpu")
    _close(got, ref)
    assert got["history_sources"] == {"stage1": "stage1_final", "stage2": "stage2_final"}
    for name in ("metrics.json", "roc_curve.png", "pr_curve.png", "score_distribution.png"):
        assert (tmp_path / "p" / name).exists() == (tmp_path / "j" / name).exists()
    assert (tmp_path / "p" / "metrics.json").exists()


def test_mine_training_history_matches_jax(port_run):
    for name in ("stage2_best", "stage1_best", "stage2_epoch1"):
        path = str(port_run["dir"] / f"{name}.msgpack")
        assert evaluate.mine_training_history(path) == evaluate_jax.mine_training_history(path)


def test_run_inference_matches_jax(port_run, tmp_path):
    """run_inference at the optimal and at a fixed threshold: the same
    predictions, metrics within 1e-5 relative, the JSON file written."""
    path = str(port_run["dir"] / "stage2_best.msgpack")
    for thr in (None, 0.5):
        out = str(tmp_path / f"p_{thr}.json")
        got = inference.run_inference(path, threshold=thr, output_path=out, device="cpu")
        ref = inference_jax.run_inference(path, threshold=thr)
        _close(got, ref)
        assert json.loads(open(out).read())["num_sequences"] == ref["num_sequences"]
    scorer = evaluate.load_model(path, device="cpu")
    poses = PoseLiftDataModule(scorer.config, verbose=False).setup().test_dataset.poses[:20]
    got = inference.predict_poses(scorer, poses, threshold=0.5, batch_size=8)
    ref = inference_jax.predict_poses(evaluate_jax.load_model(path), poses, 0.5, batch_size=8)
    np.testing.assert_array_equal(got["predictions"], ref["predictions"])
    _close(got["summary"], ref["summary"])


def test_train_cli_matches_jax_cli(port_run, tmp_path, capsys):
    """python -m cvsd_tpu_torch.cli.train --use_synthetic --device cpu and
    the JAX package's cli.train (on its 8-device CPU test mesh), both
    resuming from one initial checkpoint with 1 + 1 epochs: the same
    artifacts' keys, the same epochs, losses within 1e-3 (stage 1) and
    5e-3 (stage 2) relative as in test_torch_train.py::test_fit_matches_jax,
    and the four stage checkpoints; then both evaluate CLIs and both
    inference CLIs on the port's stage2_best give the same JSON (numbers
    within 1e-5 relative)."""
    from cvsd_tpu.cli import evaluate as evaluate_cli_jax
    from cvsd_tpu.cli import inference as inference_cli_jax
    from cvsd_tpu.cli import train as train_cli_jax
    from cvsd_tpu_torch.cli import evaluate as evaluate_cli
    from cvsd_tpu_torch.cli import inference as inference_cli
    from cvsd_tpu_torch.cli import train as train_cli

    sets = ["--set", "model.hidden_channels=16", "--set", "model.dropout=0.0",
            "--set", "data.synthetic.num_train=64", "--set", "data.synthetic.num_test=64",
            "--set", "data.batch_size=16", "--set", "data.augment.enabled=false",
            "--set", "training.stage1_epochs=1", "--set", "training.stage2_epochs=1",
            "--set", "training.lr=0.001"]
    train_cli.main(["--use_synthetic", "--checkpoint", port_run["init"], "--device", "cpu",
                    "--output_dir", str(tmp_path / "p"), *sets])
    train_cli_jax.main(["--use_synthetic", "--checkpoint", port_run["init"],
                        "--output_dir", str(tmp_path / "j"), *sets])
    res = {n: json.loads((tmp_path / n / "training_results.json").read_text()) for n in "pj"}
    assert set(res["p"]) == set(res["j"])
    for stage, limit in (("stage1", 1e-3), ("stage2", 5e-3)):
        hp, hj = res["p"]["history"][stage], res["j"]["history"][stage]
        assert [r["epoch"] for r in hp] == [r["epoch"] for r in hj] == [1]
        assert abs(hp[0]["loss"] - hj[0]["loss"]) <= limit * abs(hj[0]["loss"])
    for name in ("stage1_best", "stage1_final", "stage2_best", "stage2_final", "config"):
        assert (tmp_path / "p" / f"{name}.msgpack").exists() or name == "config"
    assert (tmp_path / "p" / "config.json").exists()
    capsys.readouterr()

    ckpt = str(tmp_path / "p" / "stage2_best.msgpack")
    evaluate_cli.main(["--checkpoint", ckpt, "--output_dir", str(tmp_path / "ep"), "--device", "cpu"])
    evaluate_cli_jax.main(["--checkpoint", ckpt, "--output_dir", str(tmp_path / "ej")])
    _close(json.loads((tmp_path / "ep" / "metrics.json").read_text()),
           json.loads((tmp_path / "ej" / "metrics.json").read_text()))
    inference_cli.main(["--checkpoint", ckpt, "--output", str(tmp_path / "ip.json"),
                        "--device", "cpu"])
    inference_cli_jax.main(["--checkpoint", ckpt, "--output", str(tmp_path / "ij.json")])
    _close(json.loads((tmp_path / "ip.json").read_text()),
           json.loads((tmp_path / "ij.json").read_text()))
    out = capsys.readouterr().out
    assert out.count("sequences=64") == 2


def test_cli_use_synthetic_flag():
    import argparse

    from cvsd_tpu_torch.cli.common import add_config_args, resolve_config

    p = argparse.ArgumentParser()
    add_config_args(p)
    assert resolve_config(p.parse_args(["--use_synthetic"]))["data"]["dataset"] == "synthetic"
    assert resolve_config(p.parse_args([]))["data"]["dataset"] == "poselift"
