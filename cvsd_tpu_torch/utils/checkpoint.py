"""Checkpoint store: a state tree plus its embedded config and metadata (the
port's copy of ``cvsd_tpu/utils/checkpoint.py``, same file format).

One msgpack file in ``flax.serialization``'s encoding, ``{"state": {...},
"meta_json": str}``: the state with its dict keys sorted at every level, as
``jax.tree_util.tree_map`` leaves them, and the config and metadata as one
JSON string. Read and written by ``utils/flax_msgpack.py`` in pure Python,
so a file either package writes loads in the other, bit for bit, and a file
written here from the same state, config and metadata is byte-identical to
the JAX package's.

There is no ``target_state``: ``load_checkpoint`` returns raw nested dicts of
numpy arrays, which ``utils/weights.py`` carries into a module.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from cvsd_tpu_torch.utils import flax_msgpack


def _to_host(tree: Any) -> Any:
    """What ``tree_map(np.asarray, tree)`` gives: dict keys sorted, leaves as
    numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if tree is None:
        return None
    return np.asarray(tree)


def save_checkpoint(path: str, state: Any, config: Optional[Dict[str, Any]] = None,
                    **metadata: Any) -> None:
    """Save a state tree plus config/metadata to ``path`` (.msgpack)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "state": _to_host(state),
        "meta_json": json.dumps({"config": config, **metadata}, default=str),
    }
    with open(path, "wb") as f:
        f.write(flax_msgpack.serialize(payload))


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load (state, metadata): the state as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        payload = flax_msgpack.restore(f.read())
    meta = json.loads(payload["meta_json"]) if payload.get("meta_json") else {}
    return payload["state"], meta


def load_subtree(path: str, key: str) -> Any:
    """One '/'-separated sub-tree (e.g. 'params/gcae') of a checkpoint's state."""
    state, _ = load_checkpoint(path)
    node = state
    for k in key.split("/"):
        node = node[k]
    return node


def checkpoint_config(path: str) -> Optional[Dict[str, Any]]:
    """The config embedded in a checkpoint."""
    _, meta = load_checkpoint(path)
    return meta.get("config")


class CheckpointManager:
    """Stage-aware best/periodic/final checkpoint names,
    ``stage{N}_{best,final,epoch{E}}.msgpack``."""

    def __init__(self, directory: str, config: Optional[Dict[str, Any]] = None):
        self.directory = directory
        self.config = config
        os.makedirs(directory, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.msgpack")

    def save(self, name: str, state: Any, **metadata: Any) -> str:
        p = self.path(name)
        save_checkpoint(p, state, config=self.config, **metadata)
        return p

    def save_best(self, stage: int, state: Any, **metadata: Any) -> str:
        return self.save(f"stage{stage}_best", state, **metadata)

    def save_final(self, stage: int, state: Any, **metadata: Any) -> str:
        return self.save(f"stage{stage}_final", state, **metadata)

    def save_epoch(self, stage: int, epoch: int, state: Any, **metadata: Any) -> str:
        return self.save(f"stage{stage}_epoch{epoch}", state, **metadata)

    def restore(self, name: str) -> Tuple[Any, Dict[str, Any]]:
        return load_checkpoint(self.path(name))

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path(name))
