"""``python -m cvsd_tpu_torch.cli.train_detector`` against the JAX package's
CLI on the CPU: one tiny YOLO-format layout, one initial checkpoint written
by the JAX package (the test-sized detector, img 64, width 0.25, depth 0.34,
float32, 17 keypoints)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu_torch.data import yolo_dataset
from cvsd_tpu_torch.models.detector import PersonDetector
from cvsd_tpu_torch.train.detector_train import anchor_centers, detection_loss
from cvsd_tpu_torch.utils.weights import load_flax_variables
from torch_testutil import random_flax_variables, write_yolo_layout

S = 64


def test_train_detector_cli_matches_jax(tmp_path, monkeypatch):
    """``cli.train_detector --device cpu`` and the JAX package's CLI on one
    tiny YOLO layout (17 keypoints) from one --init-checkpoint written by the
    JAX package, --steps 4 --scan-chunk 2 --eval-every 2: the same split and
    batches from the seed. The first chunk (2 steps; the first update's rate
    is 0, so both steps see the initial weights) is held to the same two
    batches' loss in float64 within 1e-5 relative (reading 1.1e-06), and to
    the JAX CLI's within 1e-3: at batch 2 the 64-pixel detector's deepest
    train-mode BatchNorms see 8 values a channel, and flax's E[x^2] - E[x]^2
    variance loses digits in float32 (the JAX CLI's reading is 1.45e-04 off
    the port's and 1.8e-04 off float64 on the first batch). The summary keys
    are equal; both write the best and the last checkpoint, and each
    package's loader reads the other's last one."""
    from cvsd_tpu.cli import train_detector as jcli
    from cvsd_tpu.models.detector import load_detector_checkpoint as load_jax
    from cvsd_tpu.train.detector_train import DetectorTrainer as DetectorTrainerJax
    from cvsd_tpu_torch.cli import train_detector as cli
    from cvsd_tpu_torch.models.detector import load_detector_checkpoint

    img_dir, _ = write_yolo_layout(str(tmp_path / "ds"), n=8, kpts=17)
    jm = PersonDetectorJax(img_size=S, width_mult=0.25, depth_mult=0.34, num_keypoints=17,
                           dtype=jnp.float32)
    variables = random_flax_variables(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, S, S, 3)), train=False), 6)
    # the reference trainer's own init draws weights that the checkpoint replaces
    monkeypatch.setattr(PersonDetectorJax, "init_variables",
                        lambda self, rng, batch_size=1: variables)
    init = str(tmp_path / "init.msgpack")
    DetectorTrainerJax(jm).save(init)
    summaries = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / name
        main(["--images", img_dir, "--init-checkpoint", init, "--steps", "4", "--scan-chunk", "2",
              "--batch", "2", "--eval-every", "2", "--eval-frac", "0.25", "--max-persons", "3",
              "--save-checkpoint", str(out / "det.msgpack"), "--output", str(out / "s.json"),
              *extra])
        with open(out / "s.json") as f:
            summaries[name] = json.load(f)
        assert (out / "det.msgpack").exists() and (out / "det.msgpack.best.msgpack").exists()
    ref, got = summaries["jax"], summaries["port"]
    assert got.keys() == ref.keys() and got["eval_images"] == ref["eval_images"] == 2
    assert abs(got["train_loss_first"] - ref["train_loss_first"]) <= 1e-3 * ref["train_loss_first"]
    # the CLI's draws from --seed 0: the split, then one batch per step
    rng = np.random.default_rng(0)
    train_idx = rng.permutation(8)[2:]
    ds = yolo_dataset.YOLODetectionDataset(img_dir, img_size=S, max_persons=3, num_keypoints=17)
    model = load_flax_variables(PersonDetector(img_size=S, width_mult=0.25, depth_mult=0.34,
                                               num_keypoints=17, dtype=torch.float32),
                                variables).double().train()
    c, st = (torch.from_numpy(a).double() for a in anchor_centers(S))
    exact = []
    for _step in range(2):
        imgs, bx, vl, kp = (torch.from_numpy(np.stack(a)) for a in zip(
            *[ds.load(int(i)) for i in rng.choice(train_idx, size=2, replace=False)]))
        with torch.no_grad():
            exact.append(float(detection_loss(model(imgs.double()), bx.double(), vl, S, c, st,
                                              gt_kpts=kp.double(), num_keypoints=17,
                                              obj_pos_weight=3.0)[0]))
    assert abs(got["train_loss_first"] - np.mean(exact)) <= 1e-5 * np.mean(exact)
    model, _v, meta = load_detector_checkpoint(str(tmp_path / "jax" / "det.msgpack"), device="cpu")
    assert model.num_keypoints == 17 and meta["config"]["detector"]["img_size"] == S
    _jm, jvars, _meta = load_jax(str(tmp_path / "port" / "det.msgpack"))
    assert jax.tree_util.tree_structure(jvars) == jax.tree_util.tree_structure(variables)
