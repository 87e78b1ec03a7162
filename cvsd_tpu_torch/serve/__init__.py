"""Serving: the HTTP ``ScoringServer`` with its micro-batcher, and the `.pt2` artifacts."""

from cvsd_tpu_torch.serve.export import export_detector, export_scorer, load_exported, save_exported

__all__ = ["export_detector", "export_scorer", "save_exported", "load_exported"]
