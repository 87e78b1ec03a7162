"""The Shopformer Trainer over a mesh in the port against the JAX package's
meshed Trainer and the port's own single process, on the CPU; a world of
one against no mesh, bit for bit.

The tiny configuration of tests/test_torch_train.py (hidden 16, batch 16),
with 60 training windows: the last batch holds 12, padded to 16 and masked,
so the two ranks' valid counts differ (8 and 4). The port's side runs once
for the module in a world of 2 spawned gloo processes, the JAX side on a
2-device mesh of the 8 virtual CPU devices from tests/conftest.py, both
from one initial checkpoint. The loss limit against JAX is 1e-3. The module
imports no JAX at top level: the spawned processes import it."""

import copy
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cvsd_tpu_torch.parallel.distributed import spawn_world
from cvsd_tpu_torch.parallel.mesh import MeshConfig, build_mesh


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(ckpt_dir, augment=False, dropout=0.0):
    from cvsd_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg["data"]["dataset"] = "synthetic"
    cfg["data"]["synthetic"].update(num_train=60, num_test=64)
    cfg["data"]["batch_size"] = 16
    cfg["data"]["augment"]["enabled"] = augment
    cfg["model"]["hidden_channels"] = 16
    cfg["model"]["dropout"] = dropout
    cfg["training"].update(stage1_epochs=1, stage2_epochs=1, lr=1e-3)
    cfg["experiment"]["checkpoint_dir"] = str(ckpt_dir)
    return copy.deepcopy(cfg.to_dict())


def _fit(init, ckpt_dir, mesh_config):
    from cvsd_tpu_torch.train.loop import Trainer

    tr = Trainer(_config(ckpt_dir), mesh_config=mesh_config, verbose=False, device="cpu")
    art = tr.setup().fit(resume_checkpoint=init)
    losses = [r["loss"] for s in ("stage1", "stage2") for r in art["history"][s]]
    return losses, art["best_auc"]


def _augmented_step(init, ckpt_dir, mesh_config):
    """One stage-1 step with augmentation and dropout on, on the first
    global batch: (loss, the flax parameters after it)."""
    from cvsd_tpu_torch.train.loop import Trainer
    from cvsd_tpu_torch.utils.weights import state_dict_to_flax

    tr = Trainer(_config(ckpt_dir, augment=True, dropout=0.1), mesh_config=mesh_config,
                 verbose=False, device="cpu").setup()
    tr.load_model_state(init)
    batch = next(tr.datamodule.train_batches(epoch=1, pad_to_multiple_of=2))
    loss = tr.train_step(1, tr.make_optimizer(1), torch.from_numpy(batch["poses"]),
                         torch.from_numpy(batch["mask"]), 100003)
    return float(loss), state_dict_to_flax(tr.model)["params"]


def _world(init, root):
    rank = dist.get_rank()
    mc = MeshConfig(build_mesh((2,), ("data",)))
    fit_dir = os.path.join(root, f"fit_rank{rank}")
    out = {"fit": _fit(init, fit_dir, mc),
           "step": _augmented_step(init, os.path.join(root, f"step_rank{rank}"), mc)}
    out["files"] = sorted(os.listdir(fit_dir))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from cvsd_tpu.models.shopformer import build_shopformer as build_shopformer_jax
    from cvsd_tpu.utils.checkpoint import save_checkpoint as save_checkpoint_jax
    from torch_testutil import random_flax_variables

    root = tmp_path_factory.mktemp("sf")
    cfg = _config(root / "jax")
    init = str(root / "init.msgpack")
    variables = random_flax_variables(
        lambda: build_shopformer_jax(cfg).init_variables(jax.random.PRNGKey(0)), 51)
    save_checkpoint_jax(init, jax.device_get(variables), config=cfg)
    store = root / "store"
    store.mkdir()
    meshed = spawn_world(_world, 2, (init, str(root)), store_dir=str(store), timeout=300,
                         threads=2)
    single = {"fit": _fit(init, str(root / "single"), None),
              "step": _augmented_step(init, str(root / "single_step"), None),
              "files": sorted(os.listdir(root / "single"))}
    return init, cfg, meshed, single


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def test_meshed_trainer_matches_jax_meshed(runs):
    """One + one epochs from one initial checkpoint: each epoch's loss
    within 1e-3 of the JAX package's Trainer over its 2-device mesh, on
    both ranks."""
    import jax

    from cvsd_tpu.parallel.mesh import MeshConfig as MeshConfigJax
    from cvsd_tpu.parallel.mesh import build_mesh as build_mesh_jax
    from cvsd_tpu.train.loop import Trainer as TrainerJax

    init, cfg, meshed, _single = runs
    mc = MeshConfigJax(mesh=build_mesh_jax((2,), ("data",), jax.devices()[:2]))
    art = TrainerJax(cfg, mesh_config=mc, verbose=False).setup().fit(resume_checkpoint=init)
    ref = [r["loss"] for s in ("stage1", "stage2") for r in art["history"][s]]
    for w in meshed:
        np.testing.assert_allclose(w["fit"][0], ref, rtol=1e-3)


def test_meshed_trainer_matches_the_single_process(runs):
    """The meshed fit's epoch losses equal the single process's within 1e-4
    (read: 3.6e-5; the masked shares over the global valid count and the
    BatchNorm statistics over the global batch are summed over two halves in
    float32, and Adam's early steps take the sign of gradients that are
    rounding noise), the best AUC within 1e-2 (on 64 test windows of
    nearly tied random-weight scores one swapped pair moves it by about
    1e-3; read: 3.2e-3); the ranks agree bit for bit; rank 0 alone writes,
    the files the single process writes."""
    _init, _cfg, (r0, r1), single = runs
    assert r0["fit"] == r1["fit"]
    np.testing.assert_allclose(r0["fit"][0], single["fit"][0], rtol=1e-4)
    assert abs(r0["fit"][1] - single["fit"][1]) < 1e-2
    assert r0["files"] == single["files"] and "stage2_best.msgpack" in r0["files"]
    assert r1["files"] == []


def test_meshed_augmented_step_is_the_global_batch_step(runs):
    """With augmentation and dropout on, one meshed step (the global batch
    augmented whole and its dropout masks drawn whole, each rank keeping its
    rows) gives the single process's loss within 1e-6 and its parameters
    within 1e-6 of the step (lr 1e-3) where the gradient is not rounding
    noise; a per-rank draw would move the loss by far more."""
    _init, _cfg, (r0, r1), single = runs
    loss, params = single["step"]
    assert r0["step"][0] == r1["step"][0]
    assert abs(r0["step"][0] - loss) <= 1e-6 * abs(loss)
    got, ref = _leaves(r0["step"][1]), _leaves(params)
    moved = [float(np.abs(got[k] - ref[k]).max()) for k in ref]
    assert np.median(moved) <= 1e-6 and max(moved) <= 2e-3  # at most a sign of rounding noise


def test_one_rank_mesh_is_bit_equal_to_no_mesh(runs, tmp_path):
    """A world of one: a meshed stage-1 and stage-2 step of the Shopformer
    Trainer and a meshed DetectorTrainer step equal the unmeshed ones bit
    for bit, as phase 16 holds at world size 1 on the card."""
    from cvsd_tpu_torch.models.detector import PersonDetector
    from cvsd_tpu_torch.train.detector_train import DetectorTrainer, synthetic_detection_batch
    from cvsd_tpu_torch.train.loop import Trainer
    from cvsd_tpu_torch.utils.weights import state_dict_to_flax

    init = runs[0]
    batch = synthetic_detection_batch(np.random.default_rng(0), 4, 64, max_gt=2)

    def steps(mesh_config, d):
        tr = Trainer(_config(d, augment=True, dropout=0.1), mesh_config=mesh_config,
                     verbose=False, device="cpu").setup()
        tr.load_model_state(init)
        b = next(tr.datamodule.train_batches(epoch=1))
        losses = [float(tr.train_step(stage, tr.make_optimizer(stage),
                                      torch.from_numpy(b["poses"]),
                                      torch.from_numpy(b["mask"]), 7)) for stage in (1, 2)]
        det = DetectorTrainer(PersonDetector(img_size=64, width_mult=0.25, depth_mult=0.34,
                                             dtype=torch.float32), seed=0,
                              mesh_config=mesh_config, device="cpu")
        losses.append(det.train_step(*batch)["loss"])
        return losses, _leaves(state_dict_to_flax(tr.model)), _leaves(det.variables)

    ref = steps(None, tmp_path / "single")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        got = steps(MeshConfig(build_mesh((1,), ("data",))), tmp_path / "meshed")
    finally:
        dist.destroy_process_group()
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def _deadline_world(root):
    """A meshed fit of up to 3 + 3 epochs in which rank 1 is past its
    wall-clock deadline from the start and rank 0 has an hour left: each
    rank's (per-stage epochs run, timed_out, epoch losses)."""
    import time

    from cvsd_tpu_torch.train.loop import Trainer

    rank = dist.get_rank()
    cfg = _config(os.path.join(root, f"deadline_rank{rank}"))
    cfg["training"].update(stage1_epochs=3, stage2_epochs=3)
    tr = Trainer(cfg, mesh_config=MeshConfig(build_mesh((2,), ("data",))), verbose=False,
                 device="cpu").setup()
    tr._fit_deadline = 0.0 if rank == 1 else time.perf_counter() + 3600.0
    art = tr.fit()
    hist = art["history"]
    return ([len(hist[s]) for s in ("stage1", "stage2")], art["timed_out"],
            [r["loss"] for s in ("stage1", "stage2") for r in hist[s]])


def test_meshed_deadline_is_decided_by_all_ranks(tmp_path):
    """training.max_seconds under a mesh: one rank past the deadline stops
    every rank after the same epoch of each stage, so no rank runs steps
    (and their gradient sums) that another has left; the ranks' histories
    are the same."""
    store = tmp_path / "store"
    store.mkdir()
    r0, r1 = spawn_world(_deadline_world, 2, (str(tmp_path),), store_dir=str(store),
                         timeout=180, threads=2)
    assert r0 == r1
    assert r0[0] == [1, 1] and r0[1] is True
    assert all(np.isfinite(r0[2]))
