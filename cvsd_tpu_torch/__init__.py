"""cvsd_tpu_torch — the PyTorch/CUDA port of ``cvsd_tpu`` for one NVIDIA H100.

Same configs, same layouts at the public functions (NHWC frames, (B, T, V, C)
poses), same outputs as the JAX package, which stays the reference. The one
TPU kernel on the streaming path, the NMS fixpoint, is a hand-written CUDA
kernel (``csrc/nms_fixpoint.cu``) built with nvcc at first use. This package
imports torch and never jax or cvsd_tpu.
"""

__version__ = "0.1.0"

from cvsd_tpu_torch.config import Config, load_config, merge_configs, validate_config  # noqa: F401,E402
