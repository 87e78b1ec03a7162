from cvsd_tpu_torch.eval.evaluate import ShopformerScorer  # noqa: F401
