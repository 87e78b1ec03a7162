"""The benchmark's harness: cells, traffic, weights, the timed loops, the
trace reading and the comparison that decides ``correct``."""
