"""The port's XceptionTime tabular classifier against the JAX package's on
the CPU: windowing, split and standardizer (exactly equal), the one-cycle
schedule against optax, the forward pass and one Adam step on carried
weights, two epochs of training from carried initial weights, checkpoints
(byte-identical, each package loading the other's), the UCF dataset and the
MIL ranking loss, and the train_tabular CLI on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvsd_tpu.data.bbox_schema import BBox as BBoxJax
from cvsd_tpu.data.bbox_schema import append_bboxes as append_bboxes_jax
from cvsd_tpu.data.ucf_dataset import UCFCrimeDataset as UCFCrimeDatasetJax
from cvsd_tpu.data.ucf_dataset import mil_ranking_loss as mil_ranking_loss_jax
from cvsd_tpu.models import xception_time as xt_jax
from cvsd_tpu_torch.data.ucf_dataset import UCFCrimeDataset, mil_ranking_loss
from cvsd_tpu_torch.models import xception_time as xt
from cvsd_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax
from torch_testutil import random_flax_variables

C = 4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _max_rel(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _make_csv(tmp_path, name, clip, anomaly, n_frames=100, drift=0.0, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    x = 0.5
    for f in range(1, n_frames + 1):
        x += drift + rng.normal(0, 0.002)
        rows.append(BBoxJax(clip, name, f, 1.0, float(x), 0.5, 0.1, 0.3,
                            anomaly, "Shoplifting" if anomaly else "Shopping"))
    p = str(tmp_path / f"{name}.csv")
    append_bboxes_jax(p, rows)
    return p


@pytest.mark.parametrize("appended_twice", [False, True], ids=["once", "twice"])
def test_windows_split_standardizer_equal(tmp_path, appended_twice):
    """windows_from_bbox_csv (with clips), stratified_split and Standardizer
    give exactly the JAX package's arrays; a CSV appended twice (a second
    preprocess run over one directory) gives the same windows as once."""
    paths = [_make_csv(tmp_path, "a", 1, True, 130, 0.001, 1),
             _make_csv(tmp_path, "b", 2, False, 100, 0.0, 2)]
    if appended_twice:
        _make_csv(tmp_path, "a", 1, True, 130, 0.001, 1)
        _make_csv(tmp_path, "b", 2, False, 100, 0.0, 2)
    for kw in (dict(seq_len=64, stride=32), dict(seq_len=16, stride=8, return_clips=True)):
        ref = xt_jax.windows_from_bbox_csv(paths, **kw)
        got = xt.windows_from_bbox_csv(paths, **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    X, y = xt.windows_from_bbox_csv(paths, seq_len=16, stride=8)
    assert len(X) > 10
    for g, r in zip(xt.stratified_split(X, y, 0.2, 3), xt_jax.stratified_split(X, y, 0.2, 3)):
        np.testing.assert_array_equal(g, r)
    s, sj = xt.Standardizer().fit(X), xt_jax.Standardizer().fit(X)
    np.testing.assert_array_equal(s.mean, sj.mean)
    np.testing.assert_array_equal(s.std, sj.std)
    np.testing.assert_array_equal(s(X), sj(X))


@pytest.mark.parametrize("total", [1, 2, 3, 4, 10, 257])
def test_onecycle_schedule_matches_optax(total):
    """Every step's rate against optax's as Adam evaluates it (jitted, int32
    count). rtol 1e-6, and an absolute floor of 2^-21 of the peak: optax
    computes the cosine in float32, whose last-place error is a fixed
    fraction of the peak, so near the schedule's end (values ~1e-4 of the
    peak) it is a large share of the value; optax's jitted and eager
    evaluations differ there by 4.3e-05 relative. Under 4 steps the first
    piece has no length and optax gives NaN throughout; so does the port."""
    peak = 3e-4
    ref_fn = optax.cosine_onecycle_schedule(total, peak_value=peak)
    ref = np.asarray(jax.jit(jax.vmap(ref_fn))(jnp.arange(total + 2, dtype=jnp.int32)), np.float64)
    sched = xt.cosine_onecycle_schedule(total, peak_value=peak)
    got = np.array([sched(i) for i in range(total + 2)])
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).all() == (total < 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2.0 ** -21 * peak)


def _variables(nf, T, seed):
    m = xt_jax.XceptionTime(num_classes=2, nf=nf)
    return random_flax_variables(
        lambda: m.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, T, C)), train=False),
        seed, conv1d=True)


def _port_model(variables, nf):
    model = xt.XceptionTime(C, 2, nf)
    model.load_state_dict(flax_to_state_dict(variables, model))
    return model


@pytest.mark.parametrize("nf,T", [(4, 16), (4, 32), (8, 16), (8, 32)])
def test_forward_matches_jax(nf, T):
    """Eval mode on carried weights (non-trivial BatchNorm statistics):
    logits within 1e-5 of the largest; the bridge carries the weights back
    to the same flax variables."""
    variables = _variables(nf, T, 10 + nf + T)
    x = np.random.default_rng(nf * T).normal(size=(6, T, C)).astype(np.float32)
    ref = np.asarray(xt_jax.XceptionTime(num_classes=2, nf=nf).apply(variables, x, train=False))
    model = _port_model(variables, nf).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).transpose(1, 2)).numpy()
    assert got.shape == ref.shape == (6, 2)
    assert _max_rel(got, ref) <= 1e-5
    back = state_dict_to_flax(model)
    for (path, r), (_p, g) in zip(jax.tree_util.tree_leaves_with_path(variables),
                                  jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(g, r, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("nf,T", [(4, 16), (4, 32), (8, 16), (8, 32)])
def test_one_train_step_matches_jax(nf, T):
    """One Adam step on a fixed batch in train mode against the reference's
    step (softmax cross-entropy, batch statistics, optax.adam), each against
    the largest entry of its tensor: the loss, the BatchNorm running
    statistics and the updated parameters against optax.adam applied to the
    port's own gradients within 1e-5; every gradient within 1e-4 (it passes
    back through the batch statistics of two BatchNorms, whose backward
    subtracts two per-channel means: 3.2e-06 and 1.28e-05 read here).

    The updated parameters are not held to JAX's directly: Adam's first step
    moves each element by lr * g / (|g| + 1e-8), so an element whose gradient
    is near 1e-8 moves by a share of lr that its rounding noise sets. The
    head's Conv_0 and Conv_1 biases are all such elements: they feed a
    train-mode BatchNorm, which subtracts the batch mean, so their gradient
    is zero in exact arithmetic and rounding noise in both frameworks
    (checked: under 1e-4 of the largest gradient; they are not compared)."""
    variables = _variables(nf, T, 20 + nf)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(16, T, C)).astype(np.float32)
    y = rng.integers(0, 2, 16).astype(np.int32)
    lr = 1e-3
    mj = xt_jax.XceptionTime(num_classes=2, nf=nf)

    def loss_fn(p, bs):
        logits, upd = mj.apply({"params": p, "batch_stats": bs}, x, train=True,
                               mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), upd

    (loss_j, upd), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"], variables["batch_stats"])

    clf = xt.XceptionTimeClassifier(seq_len=T, num_channels=C, nf=nf, device="cpu")
    clf.model.load_state_dict(flax_to_state_dict(variables, clf.model))
    clf.model.train()
    opt_t = torch.optim.Adam(clf.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss_t = clf._step(opt_t, torch.from_numpy(x).transpose(1, 2),
                       torch.from_numpy(y.astype(np.int64)))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    got = state_dict_to_flax(clf.model)
    grad_model = xt.XceptionTime(C, 2, nf)
    with torch.no_grad():
        for p, g in zip(clf.model.parameters(), grad_model.parameters()):
            g.copy_(p.grad)
    grads_t = state_dict_to_flax(grad_model)["params"]

    g_max = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads_j))
    null = {"['Conv_0']['bias']", "['Conv_1']['bias']"}
    n = 0
    for (path, gj), gt in zip(jax.tree_util.tree_leaves_with_path(grads_j),
                              jax.tree_util.tree_leaves(grads_t)):
        key = jax.tree_util.keystr(path)
        if key in null:
            assert max(np.abs(gj).max(), np.abs(gt).max()) <= 1e-4 * g_max, key
        else:
            assert float(np.abs(gj).max()) > 1e-2 * g_max, key
            assert _max_rel(gt, gj) <= 1e-4, key
            n += 1
    assert n == len(jax.tree_util.tree_leaves(grads_j)) - 2
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(upd["batch_stats"]),
                            jax.tree_util.tree_leaves(got["batch_stats"])):
        assert _max_rel(g, r) <= 1e-5, jax.tree_util.keystr(path)
    opt = optax.adam(lr)
    updates, _ = opt.update(grads_t, opt.init(variables["params"]), variables["params"])
    want = optax.apply_updates(variables["params"], updates)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got["params"])):
        assert _max_rel(g, r) <= 1e-5, jax.tree_util.keystr(path)


def test_train_two_epochs_matches_jax(monkeypatch):
    """train() for 2 epochs from JAX's own initial variables (the port's
    _init returns them): the loss history within rtol 1e-4 and predict_proba
    within rtol 5e-3, atol 1e-3, the limits the reference holds its scan
    and loop versions to."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(100, 32, 6)).astype(np.float32)
    y = (X.mean((1, 2)) > 0).astype(np.int64)
    ref = xt_jax.XceptionTimeClassifier(num_channels=6, seq_len=32, nf=8, seed=1)
    init = ref._init()
    hist_j = ref.train(X, y, epochs=2, batch_size=16)["history"]
    clf = xt.XceptionTimeClassifier(num_channels=6, seq_len=32, nf=8, seed=1, device="cpu")
    monkeypatch.setattr(clf, "_init", lambda: flax_to_state_dict(init, clf.model))
    hist_t = clf.train(X, y, epochs=2, batch_size=16)["history"]
    assert [r["epoch"] for r in hist_t] == [1, 2]
    np.testing.assert_allclose([r["loss"] for r in hist_t], [r["loss"] for r in hist_j],
                               rtol=1e-4)
    np.testing.assert_allclose(clf.predict_proba(X), ref.predict_proba(X), rtol=5e-3, atol=1e-3)


def test_checkpoints_byte_identical_and_cross_load(tmp_path):
    """A JAX file loaded and saved by the port comes out byte-identical; the
    JAX package loads the port's file; both predict the same within the
    forward limit."""
    nf, T = 4, 16
    ref = xt_jax.XceptionTimeClassifier(seq_len=T, num_channels=C, nf=nf)
    ref.variables = _variables(nf, T, 31)
    X = np.random.default_rng(5).normal(0.5, 0.2, (40, T, C)).astype(np.float32)
    ref.standardizer.fit(X)
    path_j, path_t = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    ref.save(path_j)
    clf = xt.XceptionTimeClassifier.load(path_j, device="cpu")
    clf.save(path_t)
    with open(path_j, "rb") as a, open(path_t, "rb") as b:
        assert a.read() == b.read()
    back = xt_jax.XceptionTimeClassifier.load(path_t)
    p_ref = ref.predict_proba(X)
    assert _max_rel(clf.predict_proba(X), p_ref) <= 1e-5
    np.testing.assert_array_equal(back.predict_proba(X), p_ref)
    np.testing.assert_array_equal(clf.predict(X), ref.predict(X))
    with pytest.raises(RuntimeError, match="train or load first"):
        xt.XceptionTimeClassifier(device="cpu").predict(X)


def test_ucf_dataset_and_mil_loss_match_jax(tmp_path):
    p = _make_csv(tmp_path, "v", 1, True, 130, 0.001, 4)
    ds, ds_j = UCFCrimeDataset([p], seq_len=32, stride=16), UCFCrimeDatasetJax([p], 32, 16)
    assert len(ds) == len(ds_j) == 7
    np.testing.assert_array_equal(ds.X, ds_j.X)
    np.testing.assert_array_equal(ds.y, ds_j.y)
    x, lab = ds[3]
    np.testing.assert_array_equal(x, ds_j[3][0])
    assert lab == ds_j[3][1] == 1
    assert ds.class_counts() == ds_j.class_counts() == {1: 7}
    rng = np.random.default_rng(9)
    a, n = rng.uniform(size=(2, 5, 32)).astype(np.float32)
    for kw in ({}, dict(margin=0.5, sparsity_weight=0.1, smoothness_weight=0.2)):
        ref = float(mil_ranking_loss_jax(jnp.asarray(a), jnp.asarray(n), **kw))
        got = float(mil_ranking_loss(torch.from_numpy(a), torch.from_numpy(n), **kw))
        assert abs(got - ref) <= 1e-6 * max(abs(ref), 1.0)
        # the roles swapped: the hinge is active
        ref = float(mil_ranking_loss_jax(jnp.asarray(n), jnp.asarray(a), **kw))
        got = float(mil_ranking_loss(torch.from_numpy(n), torch.from_numpy(a), **kw))
        assert ref > 0.5 and abs(got - ref) <= 1e-6 * max(abs(ref), 1.0)


def test_train_tabular_cli_on_cpu(tmp_path, capsys):
    """python -m cvsd_tpu_torch.cli.train_tabular --device cpu on the CSVs of
    the port's preprocess CLI over two 40-frame videos (the JAX package's
    tabular integration fixture): it prints train_acc and writes a file the
    JAX package loads and predicts with as the port does."""
    from cvsd_tpu.models.xception_time import XceptionTimeClassifier as ClassifierJax
    from cvsd_tpu_torch.cli import preprocess as preprocess_cli
    from cvsd_tpu_torch.cli import train_tabular
    from cvsd_tpu_torch.data.video import write_test_video

    d = tmp_path / "ucf"
    (d / "Shoplifting").mkdir(parents=True)
    (d / "Shopping").mkdir()
    write_test_video(str(d / "Shoplifting" / "Shoplifting001_x264.mp4"), num_frames=40)
    write_test_video(str(d / "Shopping" / "Shopping001_x264.mp4"), num_frames=40, seed=1)
    (d / "Anomaly_Train.txt").write_text(
        "Shoplifting/Shoplifting001_x264.mp4\nShopping/Shopping001_x264.mp4")
    out = tmp_path / "csvs"
    preprocess_cli.main([
        "--dataset_dir", str(d), "--output_dir", str(out), "--device", "cpu",
        "--set", "detector.img_size=128", "--set", "detector.width_mult=0.25",
        "--set", "detector.depth_mult=0.34", "--set", "detector.batch_size=8",
        "--set", "detector.conf_threshold=0.0", "--set", "detector.max_detections=4",
        "--set", "detector.dtype=float32"])
    csvs = [str(out / "ucf-crime_dataset.csv"), str(out / "ucf-crime_dataset-normal.csv")]
    model_path = str(tmp_path / "xt.msgpack")
    train_tabular.main(["--csv", *csvs, "--seq_len", "16", "--stride", "8", "--epochs", "2",
                        "--batch_size", "8", "--nf", "4", "--output", model_path,
                        "--device", "cpu"])
    assert "train_acc" in capsys.readouterr().out
    X, _y = xt.windows_from_bbox_csv(csvs, seq_len=16, stride=8)
    assert len(X) > 0
    got = xt.XceptionTimeClassifier.load(model_path, device="cpu").predict_proba(X)
    ref = ClassifierJax.load(model_path).predict_proba(X)
    assert got.shape == ref.shape == (len(X), 2)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
