"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).
Not collected as tests: the file name does not start with ``test_``."""

import contextlib
import os

import jax
import numpy as np


def random_flax_variables(init_fn, seed, conv1d=False):
    """Flax variables of ``init_fn``'s shapes, filled from a seeded numpy
    generator (``jax.eval_shape`` avoids the CPU compile of the flax init).
    BatchNorm statistics are not trivial, so the bridge's running-stat
    mapping is exercised. Kernels are scaled by 1/sqrt(fan_in); a 3-D
    kernel is an attention ``DenseGeneral`` one, (d, heads, head_dim) with
    fan-in d (``out``: (heads, head_dim, d)), unless ``conv1d``, where it is
    a 1-D convolution's (k, in/groups, out)."""
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        key, shape = jax.tree_util.keystr(path), sd.shape
        if key.endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if key.endswith("['mean']") or key.endswith("['bias']"):
            return rng.normal(0, 0.05, shape).astype(np.float32)
        if key.endswith("['scale']"):
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        attention = len(shape) == 3 and not conv1d and "['out']" not in key
        fan_in = shape[0] if attention else int(np.prod(shape[:-1]))
        return (rng.normal(0, 1, shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init_fn))


@contextlib.contextmanager
def cuda_mesh_config(tmp_path):
    """A one-rank gloo group and a MeshConfig over it whose rank runs on
    cuda:0: an entry point given it (and no device) raises on a host
    without a card, as it does without a mesh."""
    import torch
    import torch.distributed as dist

    from cvsd_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "cuda_mesh.store"), 1),
                            rank=0, world_size=1)
    try:
        yield MeshConfig(build_mesh((1,), ("data",), "cpu"), device=torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()


def write_yolo_layout(root, n=7, w=96, h=64, kpts=4):
    """Images with one or two people (keypoint triples, odd ones invisible),
    a filtered non-person row, and one background image with no label file."""
    import pytest

    cv2 = pytest.importorskip("cv2")
    img_dir = os.path.join(root, "images", "train")
    lbl_dir = os.path.join(root, "labels", "train")
    os.makedirs(img_dir)
    os.makedirs(lbl_dir)
    rng = np.random.default_rng(0)
    for i in range(n):
        cv2.imwrite(os.path.join(img_dir, f"im{i}.png"), rng.integers(0, 255, (h, w, 3), np.uint8))
        if i == n - 1:
            continue
        lines = []
        for _p in range(1 + i % 2):
            cx, cy = rng.uniform(0.3, 0.7, 2)
            bw, bh = rng.uniform(0.1, 0.4, 2)
            line = f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"
            for k in range(kpts):
                line += f" {cx + rng.uniform(-0.1, 0.1):.6f} {cy + rng.uniform(-0.1, 0.1):.6f} "
                line += "2" if k % 2 == 0 else "0"
            lines.append(line)
        lines.append("1 0.2 0.2 0.1 0.1" + " 0.2 0.2 2" * kpts)  # not a person: filtered
        with open(os.path.join(lbl_dir, f"im{i}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return img_dir, lbl_dir
