"""Batch inference over pose sequences."""
