"""The port stands alone: no module of cvsd_tpu_torch, and nothing
chip_smoke.py imports, loads jax, flax or cvsd_tpu, nor msgpack, cv2, yaml
or pandas, which the card machine may lack; and the entry points' default device (the
CUDA card) raises when there is none, with no silent CPU fallback. Checked
in fresh subprocesses: this test process has JAX loaded by conftest.py."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_and_chip_smoke_import_no_jax_or_cvsd_tpu():
    r = _run("""
        import ast, importlib, importlib.util, pkgutil, sys
        import cvsd_tpu_torch
        for m in pkgutil.walk_packages(cvsd_tpu_torch.__path__, "cvsd_tpu_torch."):
            importlib.import_module(m.name)
        names = []
        for node in ast.walk(ast.parse(open("chip_smoke.py").read())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        for name in names:
            # an optional yardstick (torchvision) that is not installed is skipped
            if importlib.util.find_spec(name.split(".")[0]) is not None:
                importlib.import_module(name)
        # msgpack, cv2, yaml and pandas may be absent on the card machine:
        # the port imports them (cv2, yaml, pandas) only inside the functions
        # that need them
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cvsd_tpu",
                                            "msgpack", "cv2", "yaml", "pandas"))
        print("BAD", bad)
        n = sum(1 for m in sys.modules if m.startswith("cvsd_tpu_torch."))
        print("PORT_MODULES", n)
    """)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert int(r.stdout.split("PORT_MODULES")[1].split()[0]) >= 79


def test_default_device_raises_without_cuda():
    r = _run("""
        import torch
        assert not torch.cuda.is_available()
        from cvsd_tpu_torch.config import get_default_config
        from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
        from cvsd_tpu_torch.models.detector import build_detector
        from cvsd_tpu_torch.models.pose_topdown import build_pose_topdown
        from cvsd_tpu_torch.models.shopformer import build_shopformer
        from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline
        from cvsd_tpu_torch.pipeline.streaming import StreamingPipeline
        from cvsd_tpu_torch.eval.evaluate import load_model
        from cvsd_tpu_torch.models.pose_topdown import load_pose_topdown_checkpoint
        from cvsd_tpu_torch.cli import preprocess, serve, stream, train_tabular
        from cvsd_tpu_torch.models.xception_time import XceptionTimeClassifier
        from cvsd_tpu_torch.pipeline.preprocess import preprocess_ucf_crime
        from cvsd_tpu_torch.train.loop import Trainer, train_from_config
        from cvsd_tpu_torch.eval.evaluate import evaluate_checkpoint
        from cvsd_tpu_torch.infer.inference import run_inference
        from cvsd_tpu_torch.cli import evaluate, inference, train
        from cvsd_tpu_torch.models.detector import PersonDetector, load_detector_checkpoint
        from cvsd_tpu_torch.models.pose_topdown import TopDownPoseNet
        from cvsd_tpu_torch.train.detector_train import DetectorTrainer
        from cvsd_tpu_torch.train.pose_topdown_train import TopDownPoseTrainer
        from cvsd_tpu_torch.eval.detection import evaluate_detector
        from cvsd_tpu_torch.sweep import run_sweep
        from cvsd_tpu_torch.cli import sweep, train_detector
        from cvsd_tpu_torch.train.qat import QATFineTuner
        from cvsd_tpu_torch.models.detector_int8 import QuantPersonDetector
        from cvsd_tpu_torch.cli import annotate, pose_export, quantize_detector
        cfg = get_default_config()
        cfg["detector"].update(img_size=64, width_mult=0.25, depth_mult=0.34, dtype="float32")
        cpu_model = build_shopformer(cfg, device="cpu")
        scorer = ShopformerScorer(cpu_model, cfg, device="cpu")
        calls = {
            "build_detector": lambda: build_detector(cfg),
            "build_pose_topdown": lambda: build_pose_topdown(cfg),
            "build_shopformer": lambda: build_shopformer(cfg),
            "DetectionPipeline": lambda: DetectionPipeline(cfg),
            "ShopformerScorer": lambda: ShopformerScorer(cpu_model, cfg),
            "StreamingPipeline": lambda: StreamingPipeline(cfg, scorer),
            # the device is resolved before the file is read
            "load_model": lambda: load_model("no_such.msgpack"),
            "load_pose_topdown_checkpoint": lambda: load_pose_topdown_checkpoint("no_such.msgpack"),
            "cli.serve": lambda: serve.main(["--checkpoint", "no_such.msgpack"]),
            "cli.stream": lambda: stream.main(["--checkpoint", "no_such.msgpack",
                                               "--videos", "v.mp4"]),
            # the device is resolved before the list or the CSVs are read
            "XceptionTimeClassifier": lambda: XceptionTimeClassifier(),
            "preprocess_ucf_crime": lambda: preprocess_ucf_crime(cfg, "no_such_dir"),
            "cli.preprocess": lambda: preprocess.main(["--dataset_dir", "no_such_dir"]),
            "cli.train_tabular": lambda: train_tabular.main(["--csv", "no_such.csv"]),
            # the device is resolved before the data or a checkpoint is read
            "Trainer": lambda: Trainer(cfg),
            "train_from_config": lambda: train_from_config(cfg),
            "evaluate_checkpoint": lambda: evaluate_checkpoint("no_such.msgpack"),
            "run_inference": lambda: run_inference("no_such.msgpack"),
            "cli.train": lambda: train.main(["--use_synthetic"]),
            "cli.evaluate": lambda: evaluate.main(["--checkpoint", "no_such.msgpack"]),
            "cli.inference": lambda: inference.main(["--checkpoint", "no_such.msgpack"]),
            # the device is resolved before weights, files or configs are touched
            "DetectorTrainer": lambda: DetectorTrainer(PersonDetector(64, 0.25, 0.34)),
            "TopDownPoseTrainer": lambda: TopDownPoseTrainer(TopDownPoseNet(17, 8, 32)),
            "load_detector_checkpoint": lambda: load_detector_checkpoint("no_such.msgpack"),
            "evaluate_detector": lambda: evaluate_detector(None, [], [], []),
            "run_sweep": lambda: run_sweep([], "no_such_dir"),
            "cli.train_detector": lambda: train_detector.main(["--images", "no_such_dir"]),
            "cli.sweep": lambda: sweep.main(["--mode", "quick"]),
            # int8: the quantized build, the QAT tuner and the three CLIs
            "build_detector(quantized)": lambda: build_detector(
                {"detector": {**cfg["detector"], "quantized": True}}),
            "QATFineTuner": lambda: QATFineTuner(
                QuantPersonDetector(64, 0.25, 0.34, qat=True), {"params": {}}),
            "cli.quantize_detector": lambda: quantize_detector.main(
                ["--detector_checkpoint", "no_such.msgpack", "--output", "o.msgpack"]),
            "cli.pose_export": lambda: pose_export.main(["--videos", "v.mp4", "--output", "o"]),
            "cli.annotate": lambda: annotate.main(["--detector_checkpoint", "no_such.msgpack",
                                                   "--videos", "v.mp4"]),
        }
        for name, fn in calls.items():
            try:
                fn()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), (name, e)
                print("RAISED", name)
            else:
                print("FELL_BACK", name)
    """)
    assert r.returncode == 0, r.stderr
    assert "FELL_BACK" not in r.stdout, r.stdout
    assert r.stdout.count("RAISED") == 33, r.stdout


def test_nms_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: a CPU tensor is refused."""
    import pytest
    import torch

    from cvsd_tpu_torch.ops.nms import nms_fixpoint_cuda

    before = nms_fixpoint_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        nms_fixpoint_cuda(torch.zeros(1, 4, 4), torch.ones(1, 4))
    assert nms_fixpoint_cuda.launches == before


def test_importers_and_export_import_no_jax_or_ultralytics():
    """The checkpoint importers, the export module and their three CLIs load
    none of jax, flax, optax, ultralytics or cvsd_tpu."""
    r = _run("""
        import importlib, sys
        for name in ("utils.yolo_import", "utils.shopformer_import", "serve.export",
                     "cli.import_yolo", "cli.import_shopformer", "cli.export"):
            importlib.import_module("cvsd_tpu_torch." + name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ultralytics",
                                            "cvsd_tpu"))
        print("BAD", bad)
    """)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_import_and_export_entry_points_without_cuda(tmp_path):
    """Without a card, the Shopformer importer and cli.export raise before
    reading a file, as every entry point does; cli.import_yolo, a numpy
    conversion that runs no model, writes its checkpoint on the host."""
    r = _run(f"""
        import numpy as np, torch
        assert not torch.cuda.is_available()
        from cvsd_tpu_torch.cli import export, import_shopformer, import_yolo
        from cvsd_tpu_torch.utils.shopformer_import import import_shopformer_checkpoint
        from cvsd_tpu_torch.utils.yolo_import import synthesize_state_dict
        calls = {{
            "import_shopformer_checkpoint": lambda: import_shopformer_checkpoint("no_such.pt"),
            "cli.import_shopformer": lambda: import_shopformer.main(
                ["--torch_checkpoint", "no_such.pt", "--output", "o.msgpack"]),
            "cli.export(detector)": lambda: export.main(
                ["--detector_checkpoint", "no_such.msgpack", "--output", "o.pt2"]),
            "cli.export(scorer)": lambda: export.main(
                ["--checkpoint", "no_such.msgpack", "--output", "o.pt2"]),
        }}
        for name, fn in calls.items():
            try:
                fn()
            except RuntimeError as e:
                assert "no CUDA device" in str(e), (name, e)
                print("RAISED", name)
            else:
                print("FELL_BACK", name)
        sd = synthesize_state_dict(depth_mult=0.34, width_mult=0.25)
        torch.save({{k: torch.from_numpy(v) for k, v in sd.items()}}, r"{tmp_path}/y.pt")
        import_yolo.main(["--torch_checkpoint", r"{tmp_path}/y.pt", "--output",
                          r"{tmp_path}/y.msgpack", "--width_mult", "0.25", "--depth_mult", "0.34"])
    """)
    assert r.returncode == 0, r.stderr
    assert "FELL_BACK" not in r.stdout, r.stdout
    assert r.stdout.count("RAISED") == 4, r.stdout
    assert (tmp_path / "y.msgpack").exists()
