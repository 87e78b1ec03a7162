"""HTTP serving: ``ScoringServer`` and its micro-batcher."""
