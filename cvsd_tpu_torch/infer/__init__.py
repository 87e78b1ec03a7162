"""Batch inference over pose sequences."""

from cvsd_tpu_torch.infer.inference import predict_poses, run_inference  # noqa: F401
