"""The one traffic generator. A mix is a data file,
``benchmark/traffic/<name>.json``; its ``kind`` names the loop that drives
it (``harness/cells.py``) and the rest are its parameters. The same seed
gives the same inputs, and every seed gives the same sizes.

Frames are rendered on the device from the seed and kept in host memory,
as a recorder's decoded frames are: a smooth background (a coarse random
grid, bilinearly enlarged), ``persons`` soft-edged ellipses of random
colour a frame (a body and a head each), and a little noise. Smooth
content keeps a crop's pixels steady under the sub-pixel shifts that
rounding gives a box, as camera footage does."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2654435761 + 97 * int(stream) + 1) % (2 ** 63))
    return g


def _u(g, shape, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


@torch.no_grad()
def render_frames(n: int, h: int, w: int, persons: Tuple[int, int], seed: int, device,
                  stream: int = 0, chunk: int = 128) -> np.ndarray:
    """(n, h, w, 3) uint8 frames from ``seed``, made on ``device`` in chunks
    and returned in host memory."""
    g = generator(seed, device, stream)
    out = np.empty((n, h, w, 3), np.uint8)
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    lo, hi = int(persons[0]), int(persons[1])
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        coarse = _u(g, (m, 3, 6, 8), device, 40.0, 200.0)
        img = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
        count = torch.randint(lo, hi + 1, (m,), generator=g, device=device)
        P = hi
        # bodies: centre, half-height (a fifth to two fifths of the frame), aspect
        cx = _u(g, (m, P), device, 0.05, 0.95) * w
        cy = _u(g, (m, P), device, 0.15, 0.85) * h
        bh = _u(g, (m, P), device, 0.1, 0.2) * h
        bw = bh * _u(g, (m, P), device, 0.3, 0.5)
        colour = _u(g, (m, P, 3), device, 0.0, 255.0)
        present = torch.arange(P, device=device)[None, :] < count[:, None]
        for p in range(P):
            for oy, ry, rx in ((0.0, 1.0, 1.0), (-1.25, 0.3, 0.6)):  # body, head
                ccy = cy[:, p] + oy * bh[:, p]
                r = (((xs[None] - cx[:, p, None, None]) / (rx * bw[:, p, None, None])) ** 2
                     + ((ys[None] - ccy[:, None, None]) / (ry * bh[:, p, None, None])) ** 2)
                a = torch.sigmoid((1.0 - r) * 6.0) * present[:, p, None, None]
                img = img * (1 - a[:, None]) + colour[:, p, :, None, None] * a[:, None]
        img = img + _u(g, img.shape, device, -3.0, 3.0)
        out[s:s + m] = img.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return out


def detect_pool(traffic: Dict, seed: int, device) -> np.ndarray:
    """The cell's pool: (pool_batches, batch, h, w, 3) uint8, host memory."""
    nb, b = int(traffic["pool_batches"]), int(traffic["batch"])
    frames = render_frames(nb * b, int(traffic["frame_h"]), int(traffic["frame_w"]),
                           tuple(traffic["persons"]), seed, device)
    return frames.reshape(nb, b, *frames.shape[1:])


def reservoir_keep(rng: np.random.Generator, k: int):
    """Keep a uniform sample of ``k`` items of a stream of unknown length:
    ``offer(i)`` says whether item i replaces a kept one, and which slot."""
    state = {"n": 0}

    def offer() -> int:
        n = state["n"]
        state["n"] = n + 1
        if n < k:
            return n
        j = int(rng.integers(0, n + 1))
        return j if j < k else -1

    return offer


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 64), int(seed) // (2 ** 64), stream])

