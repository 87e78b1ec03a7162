"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).
Not collected as tests: the file name does not start with ``test_``."""

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
