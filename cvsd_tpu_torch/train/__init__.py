"""Two-stage Shopformer training: optimizers and schedules, the trainer."""
