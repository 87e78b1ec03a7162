"""The traffic generator: the same seed gives the same inputs, another
seed other inputs of the same sizes."""

import numpy as np

from harness import traffic as TR

BIG = 2 ** 33 + 17


def test_frames_repeat_for_a_seed_and_keep_their_sizes():
    t = {"frame_h": 24, "frame_w": 32, "batch": 3, "pool_batches": 2, "persons": [1, 8]}
    a, b = TR.detect_pool(t, BIG, "cpu"), TR.detect_pool(t, BIG, "cpu")
    c = TR.detect_pool(t, BIG + 1, "cpu")
    assert a.shape == c.shape == (2, 3, 24, 32, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_reservoir_sample_is_seeded_and_uniform_in_size():
    picks = []
    for _ in range(2):
        offer = TR.reservoir_keep(TR.seed_rng(BIG, 1), 3)
        picks.append([offer() for _ in range(50)])
    assert picks[0] == picks[1]
    assert sorted(set(picks[0]) - {-1}) == [0, 1, 2]
