"""The port's parallel layer (cvsd_tpu_torch/parallel/, cli/common.py's
maybe_mesh, utils/compile_cache.py) against the JAX package's on the CPU:
the pure functions equal the reference's, the mesh forms over gloo worlds
of spawned processes (the counterpart of the reference's 8 virtual CPU
devices), and the dry run passes at 4 processes."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cvsd_tpu_torch.parallel import distributed as tdist
from cvsd_tpu_torch.parallel import mesh as tmesh
from cvsd_tpu_torch.utils import compile_cache as cc
from cvsd_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_axes", [1, 2, 3])
def test_default_mesh_shape_matches_jax(n_axes):
    from cvsd_tpu.parallel.mesh import default_mesh_shape as ref

    for n in range(1, 17):
        assert tmesh.default_mesh_shape(n, n_axes) == ref(n, n_axes), (n, n_axes)


def test_initialize_distributed_single_process():
    assert tdist.initialize_distributed() is False
    assert tdist.initialize_distributed(num_processes=1) is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("device,card,backend", [
    ("cpu", False, "gloo"),     # the CPU asked for: gloo, with or without a card
    ("cpu", True, "gloo"),
    (None, True, "nccl"),       # unset: the card, NCCL
    ("cuda", True, "nccl"),
    (None, False, None),        # unset or the card without a card: raises
    ("cuda", False, None),
])
def test_initialize_distributed_follows_the_device(monkeypatch, device, card, backend):
    """initialize_distributed joins the group of the device asked for, as
    maybe_mesh does: 'cpu' -> gloo; anything else resolves the card first
    and joins NCCL, raising without one (before any group is joined)."""
    joined = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(tdist.dist, "init_process_group", lambda **kw: joined.append(kw))
    if backend is None:
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.initialize_distributed("localhost:1234", 2, 1, device=device)
        assert joined == []
        return
    assert tdist.initialize_distributed("localhost:1234", 2, 1, device=device) is True
    assert joined == [dict(backend=backend, init_method="tcp://localhost:1234",
                           world_size=2, rank=1)]


def test_process_local_batch_slice_without_a_group():
    assert tdist.process_local_batch_slice(64) == (64, 0)


def test_hybrid_rank_layout_flat_and_hybrid():
    """Flat: the ranks in order. Hybrid, 2 nodes of 4 ranks with ici (2, 2)
    and dcn (2, 1): the node part of "data" is outermost, so every "model"
    pair and every inner "data" pair lie inside one node."""
    np.testing.assert_array_equal(tdist.hybrid_rank_layout((4, 2)),
                                  np.arange(8).reshape(4, 2))
    lay = tdist.hybrid_rank_layout((2, 2), (2, 1))
    np.testing.assert_array_equal(lay, [[0, 1], [2, 3], [4, 5], [6, 7]])
    assert all(len({r // 4 for r in row}) == 1 for row in lay)  # model axis: one node
    assert {r // 4 for r in lay[:2].ravel()} == {0} and {r // 4 for r in lay[2:].ravel()} == {1}
    lay = tdist.hybrid_rank_layout((1, 2), (2, 2))  # dcn on both axes
    np.testing.assert_array_equal(lay, [[0, 1, 2, 3], [4, 5, 6, 7]])
    with pytest.raises(ValueError, match="length"):
        tdist.hybrid_rank_layout((2, 2), (2,))


def _world_facts(cfg):
    """One rank of a 4-rank world: the meshes and helpers it sees."""
    from cvsd_tpu_torch.parallel.distributed import (create_hybrid_mesh,
                                                     process_local_batch_slice)
    from cvsd_tpu_torch.parallel.mesh import MeshConfig, replicate, shard_batch

    rank = dist.get_rank()
    flat = MeshConfig.from_config({})
    mc = MeshConfig.from_config(cfg)
    dg = mc.data_group()
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    mine = shard_batch(mc.mesh, {"x": x, "m": [np.arange(8)]})
    w = torch.full((3,), float(rank))
    replicate(mc.mesh, {"w": w})
    hybrid = create_hybrid_mesh((1, 2), (2, 1), ("data", "model"))
    return {
        "flat": (tuple(flat.mesh.mesh.shape), flat.mesh.mesh_dim_names, flat.n_devices),
        "mesh": (tuple(mc.mesh.mesh.shape), mc.mesh.mesh_dim_names, mc.n_devices,
                 mc.model_axis),
        "spec": [str(p) for p in mc.batch_spec(3)],
        "data": (dg.size, dg.rank), "rows": mine["x"].numpy(), "m": mine["m"][0].numpy(),
        "replicated": w.numpy(), "slice": process_local_batch_slice(64),
        "hybrid": hybrid.mesh.numpy().tolist(), "device": str(mc.device),
        "writer": mc.is_writer,
    }


def test_mesh_config_1d_and_2d_over_four_ranks(tmp_path):
    """MeshConfig.from_config 1-D (the default) and 2-D (data x model,
    default_mesh_shape's (2, 2)) over 4 gloo ranks; shard_batch keeps each
    rank's rows of the data axis (a model pair shares them), replicate
    copies rank 0's tensors, create_hybrid_mesh lays the ranks out
    node-major, process_local_batch_slice splits by rank."""
    from cvsd_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    cfg = {"parallel": {"mesh_axes": ["data", "model"], "model_axis": "model"}}
    jmc = JaxMeshConfig.from_config(cfg, devices=__import__("jax").devices()[:4])
    facts = tdist.spawn_world(_world_facts, 4, (cfg,), store_dir=str(tmp_path), timeout=120)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for rank, f in enumerate(facts):
        assert f["flat"] == ((4,), ("data",), 4)
        assert f["mesh"][:2] == (tuple(jmc.mesh.devices.shape), jmc.mesh.axis_names)
        assert f["mesh"][2:] == (4, "model")
        assert f["spec"] == ["S(0)", "R"]
        data_rank = rank // 2
        assert f["data"] == (2, data_rank)
        np.testing.assert_array_equal(f["rows"], x[4 * data_rank: 4 * data_rank + 4])
        np.testing.assert_array_equal(f["m"], np.arange(8)[4 * data_rank: 4 * data_rank + 4])
        np.testing.assert_array_equal(f["replicated"], np.zeros(3))
        assert f["slice"] == (16, 16 * rank)
        assert f["hybrid"] == [[0, 1], [2, 3]]
        assert f["device"] == "cpu" and f["writer"] == (rank == 0)


def test_build_mesh_refuses_a_bad_shape_and_a_cuda_mesh_without_a_card(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="mesh shape"):
            tmesh.build_mesh((2,), ("data",))
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.build_mesh((1,), ("data",), "cuda")
        one = tmesh.MeshConfig(tmesh.build_mesh((1,), ("data",)))
        assert one.data_group().rows(3) == slice(0, 3) and one.device == torch.device("cpu")
        with pytest.raises(ValueError, match="does not split"):
            tmesh.DataGroup(None, 2, 0).rows(3)
    finally:
        dist.destroy_process_group()


def test_maybe_mesh_none_without_world_size(monkeypatch):
    from cvsd_tpu_torch.cli.common import maybe_mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert maybe_mesh({}) is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert maybe_mesh({}) is None
    assert tmesh.writes(None)
    assert not dist.is_initialized()


def test_maybe_mesh_without_a_card_raises_unless_the_cpu_was_asked(monkeypatch):
    """WORLD_SIZE > 1 and no device asked for: the mesh is the card's, so it
    raises on a host without one, before any group forms, as the unmeshed
    entry points do; nothing falls back to a gloo group on the CPU."""
    from cvsd_tpu_torch.cli.common import maybe_mesh

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            maybe_mesh({}, device)
    assert not dist.is_initialized()


def _maybe_mesh_children(tmp_path, device_arg):
    """Two fresh processes launched as torchrun launches its ranks
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR/PORT), each calling
    maybe_mesh(cfg, device_arg) with no card visible; their results."""
    import socket

    child = (
        "import sys, torch.distributed as dist\n"
        "from cvsd_tpu_torch.cli.common import maybe_mesh\n"
        "mc = maybe_mesh({}, None if sys.argv[1] == 'none' else sys.argv[1])\n"
        "g = mc.data_group()\n"
        "print('MESH', dist.get_backend(), mc.mesh.device_type, mc.device, g.size, g.rank,\n"
        "      mc.is_writer)\n"
        "dist.destroy_process_group()\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "", "WORLD_SIZE": "2",
               "RANK": str(rank), "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, "-c", child, device_arg], env=env,
                                      cwd=str(tmp_path), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_maybe_mesh_joins_a_gloo_group_when_the_cpu_is_asked(tmp_path):
    """device='cpu' in a launched rank: maybe_mesh joins the launcher's
    group over gloo itself, and the mesh and its device are the CPU's;
    rank 0 alone writes."""
    outs = _maybe_mesh_children(tmp_path, "cpu")
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-2000:]
        line = next(x for x in out.splitlines() if x.startswith("MESH "))
        assert line.split()[1:] == ["gloo", "cpu", "cpu", "2", str(rank), str(rank == 0)]


def test_meshed_preprocess_cli_without_a_card_raises(tmp_path):
    """cli.preprocess launched as one of two ranks with no --device on a
    host without a card raises naming the missing device, as the unmeshed
    command does; it runs no detection on the CPU."""
    (tmp_path / "dataset").mkdir()
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "", "WORLD_SIZE": "2",
           "RANK": "0", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}
    r = subprocess.run([sys.executable, "-m", "cvsd_tpu_torch.cli.preprocess", "--dataset_dir",
                        str(tmp_path / "dataset"), "--output_dir", str(tmp_path / "csvs")],
                       env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "RuntimeError: no CUDA device is available" in r.stderr, r.stderr[-2000:]
    assert not (tmp_path / "csvs").exists()


def test_dryrun_four_processes(capsys):
    """The dry run's three phases on 4 gloo processes: mesh (2, 2), both TP
    phases' losses within rtol 1e-4 of the unsharded steps' (raised inside
    otherwise), the meshed stream's events equal the single device's."""
    pytest.importorskip("cv2")
    from cvsd_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4, timeout=240)
    assert line.startswith("dryrun_multichip(4): mesh={'data': 2, 'model': 2}")
    assert "det_tp_loss=" in line and "(mesh==single) OK" in line
    events = int(line.split("streaming_events=")[1].split("(")[0])
    assert events > 20
    assert line in capsys.readouterr().out


# -- the compile cache --------------------------------------------------------------------------


def test_compile_cache_noop_without_env(monkeypatch):
    monkeypatch.delenv(cc._ENV, raising=False)
    monkeypatch.setattr(cc, "_enabled_path", None)
    before = cuda_build.BUILD_DIR
    assert cc.maybe_enable_compile_cache() is False
    assert cuda_build.BUILD_DIR == before == cuda_build.CSRC_DIR / "build"


def test_compile_cache_moves_the_build_dir_in_a_fresh_process(tmp_path):
    """CVSD_COMPILE_CACHE_DIR set, importing the CLIs' common module enables
    the cache: the hashed library path lies under the cache directory; a
    second, different path keeps the first and warns."""
    child = (
        "import warnings, sys\n"
        "import cvsd_tpu_torch.cli.common\n"
        "from cvsd_tpu_torch.utils import compile_cache, cuda_build\n"
        "print(cuda_build.library_path('nms_fixpoint'))\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    assert compile_cache.maybe_enable_compile_cache(sys.argv[1] + '/other')\n"
        "print(len(w), cuda_build.BUILD_DIR)\n")
    env = {**os.environ, cc._ENV: str(tmp_path / "cache"), "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", child, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lib, tail = r.stdout.splitlines()[-2:]
    cache = (tmp_path / "cache").resolve()
    assert lib.startswith(str(cache) + os.sep) and lib.endswith(".so")
    assert tail == f"1 {cache}"


def test_compile_cache_loads_a_built_library_without_nvcc(tmp_path, monkeypatch):
    """A library already under its hash in the cache directory is used as it
    is: build() starts no compiler (nvcc faked to fail)."""
    monkeypatch.setattr(cc, "_enabled_path", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    assert cc.maybe_enable_compile_cache(str(tmp_path / "cache"))
    lib = cuda_build.library_path("nms_fixpoint")
    assert lib.parent == (tmp_path / "cache").resolve()
    lib.write_bytes(b"built earlier")

    def no_nvcc(*a, **k):
        raise AssertionError("nvcc started for a cached library")

    monkeypatch.setattr(cuda_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(cuda_build.subprocess, "Popen", no_nvcc)
    assert cuda_build.build(["nms_fixpoint"]) == {"nms_fixpoint": lib}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cc.maybe_enable_compile_cache(str(tmp_path / "cache"))  # same path: no warning
