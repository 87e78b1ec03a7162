"""The port's msgpack checkpoints against cvsd_tpu/utils/checkpoint.py on the
CPU: each package reads the other's files bit for bit, the two write
byte-identical files from the same state, config and metadata, and
state_dict_to_flax undoes the weight bridge exactly for every model the port
holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cvsd_tpu.config import get_default_config as get_default_config_jax
from cvsd_tpu.models.detector import PersonDetector as PersonDetectorJax
from cvsd_tpu.models.pose_topdown import TopDownPoseNet as TopDownPoseNetJax
from cvsd_tpu.models.shopformer import Shopformer as ShopformerJax
from cvsd_tpu.utils import checkpoint as ckpt_jax
from cvsd_tpu_torch.models.detector import PersonDetector
from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet
from cvsd_tpu_torch.models.shopformer import Shopformer
from cvsd_tpu_torch.utils import checkpoint as ckpt
from cvsd_tpu_torch.utils import flax_msgpack
from cvsd_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax
from torch_testutil import random_flax_variables


def mixed_state():
    """A state of every leaf kind a checkpoint holds: float32/float16/int/
    uint8/bool arrays, 0-d and empty arrays, bfloat16, a list, None and a
    Python number; keys out of order at every level."""
    rng = np.random.default_rng(0)
    return {
        "params": {
            "Conv_10": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32)},
            "Conv_2": {"kernel": rng.normal(size=(1, 1, 8, 2)).astype(np.float32),
                       "bias": np.zeros((2,), np.float32)},
            "BatchNorm_0": {"scale": rng.uniform(size=(300,)).astype(np.float16)},
        },
        "batch_stats": {"BatchNorm_0": {"var": np.float32(1.5) * np.ones((), np.float32),
                                        "mean": np.zeros((0, 3), np.float64)}},
        "step": 7,
        "history": [np.arange(3, dtype=np.int32), np.asarray([True, False])],
        "bf16": np.asarray(jnp.arange(-4, 8, dtype=jnp.bfloat16).reshape(3, 4)),
        "codes": (np.arange(70000) % 251).astype(np.uint8),
        "none": None,
    }


CONFIG = {"model": {"variant": "v2", "num_heads": 2}, "list": [1, -40, 2.5, 70000, "x" * 40],
          "nothing": None}


def _as_numpy(x):
    if isinstance(x, torch.Tensor):  # bfloat16 reads back as a torch tensor
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy(), "bfloat16"
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16), "bfloat16"
    return x, x.dtype.name


def assert_same_tree(got, want, path="state"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    if want is None:
        assert got is None, path
        return
    g, g_dtype = _as_numpy(got)
    w, w_dtype = _as_numpy(want)
    assert g_dtype == w_dtype and g.shape == w.shape, (path, g_dtype, w_dtype, g.shape, w.shape)
    assert g.tobytes() == w.tobytes(), path


def test_jax_file_loads_in_port(tmp_path):
    path = str(tmp_path / "jax.msgpack")
    ckpt_jax.save_checkpoint(path, mixed_state(), config=CONFIG, epoch=3, metrics={"auc": 0.5})
    want_state, want_meta = ckpt_jax.load_checkpoint(path)
    got_state, got_meta = ckpt.load_checkpoint(path)
    assert got_meta == want_meta == {"config": CONFIG, "epoch": 3, "metrics": {"auc": 0.5}}
    assert sorted(got_state["history"]) == ["0", "1"]  # lists come back as {"0": ..} maps
    assert isinstance(got_state["bf16"], torch.Tensor)
    assert got_state["params"]["Conv_10"]["kernel"].flags.writeable
    assert_same_tree(got_state, want_state)


def test_port_file_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.msgpack")
    state = mixed_state()
    ckpt.save_checkpoint(path, state, config=CONFIG, epoch=4)
    got_state, got_meta = ckpt_jax.load_checkpoint(path)
    assert got_meta == {"config": CONFIG, "epoch": 4}
    want_state, _ = ckpt.load_checkpoint(path)
    assert_same_tree(got_state, want_state)
    assert np.array_equal(got_state["params"]["Conv_10"]["kernel"],
                          state["params"]["Conv_10"]["kernel"])


def test_files_are_byte_identical(tmp_path):
    """The same state, config and metadata give the same bytes."""
    a, b = (str(tmp_path / f"{n}.msgpack") for n in "ab")
    ckpt_jax.save_checkpoint(a, mixed_state(), config=CONFIG, epoch=1, note="x")
    ckpt.save_checkpoint(b, mixed_state(), config=CONFIG, epoch=1, note="x")
    raw = [open(p, "rb").read() for p in (a, b)]
    assert raw[0] == raw[1]


def test_npscalar_and_chunked_arrays(monkeypatch):
    """ext 3 (a numpy scalar) decodes to a 0-d array; a leaf over
    MAX_CHUNK_SIZE bytes, which flax writes as a chunked-array dict, decodes
    to the whole array (a bfloat16 one to a torch tensor), and the port
    chunks it to the same bytes."""
    scalars = {"a": np.int64(-3), "b": np.float32(1.5), "c": np.bool_(True)}
    raw = serialization.msgpack_serialize(scalars)
    got = flax_msgpack.restore(raw)
    for k, v in scalars.items():
        assert got[k].shape == () and got[k].dtype == np.asarray(v).dtype and got[k] == v
    assert flax_msgpack.serialize(scalars) == raw
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"small": np.ones(4, np.int8), "w": np.arange(50, dtype=np.float32).reshape(5, 10),
            "x16": np.asarray(jnp.arange(-20, 20, dtype=jnp.bfloat16).reshape(8, 5))}
    raw = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in raw
    got = flax_msgpack.restore(raw)
    assert got["w"].shape == (5, 10) and np.array_equal(got["w"], tree["w"])
    assert isinstance(got["x16"], torch.Tensor) and got["x16"].shape == (8, 5)
    assert np.array_equal(got["x16"].float().numpy(), tree["x16"].astype(np.float32))
    assert np.array_equal(got["small"], tree["small"])
    assert flax_msgpack.serialize(tree) == raw


def test_reader_refuses_bad_input():
    good = flax_msgpack.serialize({"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(good[:-2])
    with pytest.raises(ValueError, match="after the msgpack object"):
        flax_msgpack.restore(good + b"\x00")
    odd = flax_msgpack.serialize({"w": np.ones(3, np.float32)}).replace(b"float32", b"floatXY")
    with pytest.raises(ValueError, match="floatXY"):
        flax_msgpack.restore(odd)


def test_subtree_config_and_manager_match_jax(tmp_path):
    cfg = {"model": {"variant": "v1"}}
    state = mixed_state()
    jm = ckpt_jax.CheckpointManager(str(tmp_path / "jax"), config=cfg)
    pm = ckpt.CheckpointManager(str(tmp_path / "port"), config=cfg)
    for saver in ("save_best", "save_final"):
        pj, pp = getattr(jm, saver)(2, state, epoch=5), getattr(pm, saver)(2, state, epoch=5)
        assert pj.rsplit("/", 1)[1] == pp.rsplit("/", 1)[1]
        assert open(pj, "rb").read() == open(pp, "rb").read()
    pj, pp = jm.save_epoch(1, 3, state), pm.save_epoch(1, 3, state)
    assert pj.rsplit("/", 1)[1] == pp.rsplit("/", 1)[1] == "stage1_epoch3.msgpack"
    assert pm.exists("stage2_best") and not pm.exists("stage1_best")
    assert pm.restore("stage2_best")[1] == jm.restore("stage2_best")[1]
    assert ckpt.checkpoint_config(pp) == ckpt_jax.checkpoint_config(pj) == cfg
    assert_same_tree(ckpt.load_subtree(pp, "params/Conv_2"),
                     ckpt_jax.load_subtree(pj, "params/Conv_2"))


def _shopformer():
    cfg = get_default_config_jax()
    jm = ShopformerJax.from_config(cfg)
    return (random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), 1),
            Shopformer.from_config(cfg), ())


def _detector(head, nk, seed):
    def build():
        jm = PersonDetectorJax(img_size=128, width_mult=0.25, depth_mult=0.34, num_keypoints=nk,
                               head_variant=head, dtype=jnp.float32)
        variables = random_flax_variables(
            lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 128, 128, 3)),
                            train=False), seed)
        return variables, PersonDetector(img_size=128, width_mult=0.25, depth_mult=0.34,
                                         num_keypoints=nk, head_variant=head,
                                         dtype=torch.float32), ()
    return build


def _topdown():
    jm = TopDownPoseNetJax(num_keypoints=17, width=8, crop_size=32)
    return (random_flax_variables(lambda: jm.init_variables(jax.random.PRNGKey(0)), 4),
            TopDownPoseNet(17, 8, 32), ())


MODELS = {"shopformer": _shopformer, "v5m_pose": _detector("anchor_free", 17, 2),
          "v8dfl": _detector("v8dfl", 0, 3), "topdown": _topdown}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_to_flax_inverts_the_bridge(name):
    """flax -> port -> flax gives the original variables bit for bit (the
    subtrees the port does not hold left out), and through a checkpoint too."""
    variables, module, skip = MODELS[name]()
    load_flax_variables(module, variables, skip=skip)
    back = state_dict_to_flax(module)
    want = jax.tree_util.tree_map(np.asarray, variables)
    for prefix in skip:  # "gcae/decoder", in params and batch_stats
        parent, leaf = prefix.rsplit("/", 1)
        for node in want.values():
            for k in parent.split("/"):
                node = node[k]
            node.pop(leaf, None)
    assert_same_tree(back, want)
    assert all(v.dtype == np.float32 for v in jax.tree_util.tree_leaves(back))


def test_state_dict_to_flax_skip():
    variables, module, _ = _detector("anchor_free", 17, 5)()
    load_flax_variables(module, variables)
    back = state_dict_to_flax(module, skip=("DetectHead_1",))
    assert "DetectHead_1" not in back["params"] and "DetectHead_1" in variables["params"]
    assert sorted(back["params"]) == sorted(k for k in variables["params"] if k != "DetectHead_1")
