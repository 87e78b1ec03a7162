"""The port's packages export the names the JAX package's ``__init__``s
export, subpackage by subpackage, and no others. The only names the port
lacks are the JAX-only ones: the XLA and Pallas NMS entry points (the port's
kernels sit behind ``batched_nms``), flax's ``TrainState`` and the
``PositionalEncoding`` module (the port's transformer keeps its table as a
buffer)."""

import __future__
import importlib
import inspect

import pytest

JAX_ONLY = {"nms_jax", "nms_fixpoint_jax", "nms_pallas", "nms_pallas_fixpoint", "TrainState",
            "PositionalEncoding"}
# every subpackage of the reference but native/, which the port does not
# have yet (ROADMAP.md)
SUBPACKAGES = ["", "cli", "config", "data", "eval", "infer", "models", "ops", "parallel",
               "pipeline", "serve", "sweep", "track", "train", "utils", "viz"]


def _exported(package: str) -> set:
    mod = importlib.import_module(package)
    return {n for n, obj in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(obj)
            and not isinstance(obj, __future__._Feature)
            and getattr(obj, "__module__", None) != "typing"}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_port_exports_the_reference_names(sub):
    suffix = "." + sub if sub else ""
    ref = _exported("cvsd_tpu" + suffix)
    assert _exported("cvsd_tpu_torch" + suffix) == ref - JAX_ONLY


def test_build_transformer_is_from_config():
    from cvsd_tpu_torch.config import get_default_config
    from cvsd_tpu_torch.models import ShopformerTransformer, build_transformer

    cfg = get_default_config()
    built, direct = build_transformer(cfg), ShopformerTransformer.from_config(cfg)
    assert isinstance(built, ShopformerTransformer)
    assert {k: v.shape for k, v in built.state_dict().items()} == {
        k: v.shape for k, v in direct.state_dict().items()}
