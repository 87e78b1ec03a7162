"""XceptionTime: the 1-D Inception-style time-series classifier over bbox
tracks, Pipeline A's second half (PyTorch port of
``cvsd_tpu/models/xception_time.py``).

The BBox CSVs are cut into (n, seq_len, 4) windows per (clip, person) track
(seq_len 64, stride 32), split 80/20 by class, standardized per channel and
fed to an XceptionTime network trained with Adam under a one-cycle cosine
schedule. The data preparation is the reference's numpy, copied.

Network: Xception modules (a 1x1 bottleneck -> depthwise-separable convs of
kernel 39/19/9 + a max-pool -> 1x1 branch, concatenated), a residual every
second module, then average pooling over time and 1x1 convs down to the
classes. The port runs it over (B, C, T) ``Conv1d``s; submodules carry the
flax auto-names (``XceptionBlock_0``, ``XceptionModule_0``, ``Conv_0``,
``BatchNorm_0``, ...), so ``utils/weights.py`` maps the reference's variables
by name, both ways.

What differs from PyTorch's stock parts, and is held to JAX by the tests:
  - flax's BatchNorm (``models/layers.py::FlaxBatchNorm``): the batch variance is
    E[x^2] - E[x]^2, clipped at 0, and the running statistics move by
    momentum 0.9 towards the BIASED batch variance; ``nn.BatchNorm1d`` keeps
    the unbiased one;
  - ``optax.cosine_onecycle_schedule`` (``cosine_onecycle_schedule``): its
    boundaries are int(0.3 total) and total, which ``OneCycleLR`` does not
    share; each step's learning rate is set on ``torch.optim.Adam`` from it,
    step ``count`` (from 0) taking ``schedule(count)`` as optax does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvsd_tpu_torch.models.layers import FlaxBatchNorm
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math

BBOX_CHANNELS = ("left", "top", "width", "height")


# ---------------------------------------------------------------- data prep

def windows_from_bbox_csv(
    csv_paths: Sequence[str],
    seq_len: int = 64,
    stride: int = 32,
    min_len: Optional[int] = None,
    return_clips: bool = False,
):
    """BBox CSVs -> ((N, seq_len, 4) float32 windows, (N,) int labels).
    Groups rows by (clip, person) track, sorts by frame and slides windows.
    With return_clips, also returns the (N,) int clip id per window, the key
    for video-level score aggregation."""
    from cvsd_tpu_torch.data.bbox_schema import read_bboxes

    min_len = min_len or seq_len
    X: List[np.ndarray] = []
    y: List[int] = []
    clips: List[int] = []
    for path in csv_paths:
        tracks: Dict[Tuple[int, float], List] = {}
        for r in read_bboxes(path):
            tracks.setdefault((r.clip, r.person), []).append(r)
        for rows in tracks.values():
            rows.sort(key=lambda r: r.frame)
            # drop duplicate frames within a track: the CSVs are appended to,
            # so a second preprocess run over one directory doubles every
            # row, and windows across the duplicate boundary would be garbage
            rows = [r for i, r in enumerate(rows)
                    if i == 0 or r.frame != rows[i - 1].frame]
            feats = np.asarray([[r.left, r.top, r.width, r.height] for r in rows], np.float32)
            label = int(rows[0].is_anomaly)
            if len(feats) < min_len:
                continue
            for s in range(0, len(feats) - seq_len + 1, stride):
                X.append(feats[s : s + seq_len])
                y.append(label)
                clips.append(int(rows[0].clip))
    if not X:
        empty = (np.zeros((0, seq_len, len(BBOX_CHANNELS)), np.float32),
                 np.zeros(0, np.int32))
        return (*empty, np.zeros(0, np.int32)) if return_clips else empty
    out = (np.stack(X), np.asarray(y, np.int32))
    return (*out, np.asarray(clips, np.int32)) if return_clips else out


def stratified_split(
    X: np.ndarray, y: np.ndarray, valid_frac: float = 0.2, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stratified train/valid split."""
    rng = np.random.default_rng(seed)
    train_idx, valid_idx = [], []
    for cls in np.unique(y):
        idx = np.where(y == cls)[0]
        rng.shuffle(idx)
        k = max(1, int(round(len(idx) * valid_frac))) if len(idx) > 1 else 0
        valid_idx.extend(idx[:k])
        train_idx.extend(idx[k:])
    tr = np.asarray(sorted(train_idx))
    va = np.asarray(sorted(valid_idx))
    return X[tr], y[tr], X[va], y[va]


class Standardizer:
    """Per-channel mean/std standardization."""

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray) -> "Standardizer":
        self.mean = X.mean(axis=(0, 1), keepdims=True)
        self.std = X.std(axis=(0, 1), keepdims=True) + 1e-8
        return self

    def __call__(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mean) / self.std


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """``optax.cosine_onecycle_schedule``: cosine from peak/div_factor up to
    peak at step int(pct_start * transition_steps), then down to
    peak/(div_factor * final_div_factor) at transition_steps; returns
    ``count -> learning rate``. optax's own piecewise interpolation, so its
    edge case comes along: with transition_steps < 4 the first piece has no
    length and every value is NaN."""
    if transition_steps <= 0:
        raise ValueError("transition_steps must be positive")
    bounds = np.array([0, int(pct_start * transition_steps), int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    sizes = bounds[1:] - bounds[:-1]

    def schedule(count: int) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            inside = (bounds[:-1] <= count) & (count < bounds[1:])
            pct = (count - bounds[:-1]) / sizes
            start, end = values[:-1], values[1:]
            interp = end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)
            return float(inside.dot(interp) + (bounds[-1] <= count) * values[-1])

    return schedule


# ---------------------------------------------------------------- model

class XceptionModule(nn.Module):
    """(B, in, T) -> (B, 4 nf, T): bottleneck ``Conv_0``; per kernel 39/19/9 a
    depthwise conv and a pointwise one (``Conv_1``..``Conv_6``); a max-pool
    of the input through ``Conv_7``."""

    def __init__(self, in_channels: int, nf: int):
        super().__init__()
        self.Conv_0 = nn.Conv1d(in_channels, nf, 1, bias=False)
        for i, k in enumerate((39, 19, 9)):
            # depthwise over time ('SAME': k is odd) + pointwise mix
            self.add_module(f"Conv_{2 * i + 1}",
                            nn.Conv1d(nf, nf, k, padding=k // 2, groups=nf, bias=False))
            self.add_module(f"Conv_{2 * i + 2}", nn.Conv1d(nf, nf, 1, bias=False))
        self.Conv_7 = nn.Conv1d(in_channels, nf, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.Conv_0(x)
        outs = [self.get_submodule(f"Conv_{2 * i + 2}")(self.get_submodule(f"Conv_{2 * i + 1}")(b))
                for i in range(3)]
        # flax max_pool(3, SAME) pads with -inf, as max_pool1d does
        outs.append(self.Conv_7(F.max_pool1d(x, 3, stride=1, padding=1)))
        return torch.cat(outs, dim=1)


class XceptionBlock(nn.Module):
    """``depth`` Xception modules of nf * 2^d filters; after every second one
    a 1x1 conv + BatchNorm of the block's last residual is added and ReLU'd."""

    def __init__(self, in_channels: int, nf: int, depth: int = 4):
        super().__init__()
        self.depth = depth
        ch, res_ch = in_channels, in_channels
        for d in range(depth):
            self.add_module(f"XceptionModule_{d}", XceptionModule(ch, nf * 2 ** d))
            ch = 4 * nf * 2 ** d
            if d % 2 == 1:
                self.add_module(f"Conv_{d // 2}", nn.Conv1d(res_ch, ch, 1, bias=False))
                self.add_module(f"BatchNorm_{d // 2}", FlaxBatchNorm(ch))
                res_ch = ch
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        for d in range(self.depth):
            x = self.get_submodule(f"XceptionModule_{d}")(x)
            if d % 2 == 1:
                res = self.get_submodule(f"Conv_{d // 2}")(residual)
                x = F.relu(x + self.get_submodule(f"BatchNorm_{d // 2}")(res))
                residual = x
        return x


class XceptionTime(nn.Module):
    """(B, C, T) windows -> (B, num_classes) logits: the block, the mean over
    time, then 1x1 convs to c/2, c/4 and the classes."""

    def __init__(self, num_channels: int = 4, num_classes: int = 2, nf: int = 16, depth: int = 4):
        super().__init__()
        self.XceptionBlock_0 = XceptionBlock(num_channels, nf, depth)
        c = self.XceptionBlock_0.out_channels
        self.Conv_0 = nn.Conv1d(c, c // 2, 1)
        self.BatchNorm_0 = FlaxBatchNorm(c // 2)
        self.Conv_1 = nn.Conv1d(c // 2, c // 4, 1)
        self.BatchNorm_1 = FlaxBatchNorm(c // 4)
        self.Conv_2 = nn.Conv1d(c // 4, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.XceptionBlock_0(x).mean(dim=2, keepdim=True)
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.relu(self.BatchNorm_1(self.Conv_1(x)))
        return self.Conv_2(x)[:, :, 0]


# ---------------------------------------------------------------- trainer

class XceptionTimeClassifier:
    """Train/infer driver with the one-cycle schedule and msgpack export
    (files byte-identical to the JAX package's for the same variables, and
    each package loads the other's). ``device``: the default is the CUDA
    card, raising without one."""

    def __init__(self, seq_len: int = 64, num_channels: int = 4, num_classes: int = 2,
                 nf: int = 16, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        use_float32_math()  # the reference trains and predicts in float32
        self.seq_len = seq_len
        self.num_channels = num_channels
        self.num_classes = num_classes
        self.nf = nf
        self.seed = seed
        self.model = XceptionTime(num_channels, num_classes, nf).to(self.device)
        self.standardizer = Standardizer()
        self._ready = False  # trained or loaded

    def _init(self) -> Dict[str, torch.Tensor]:
        """Initial weights, from a seeded ``torch.Generator`` (the reference
        draws them from ``jax.random.PRNGKey(seed)``, which the port cannot
        redraw)."""
        from cvsd_tpu_torch.utils.weights import init_module

        return init_module(XceptionTime(self.num_channels, self.num_classes, self.nf),
                           self.seed).state_dict()

    def _windows(self, X: np.ndarray) -> torch.Tensor:
        """(N, T, C) numpy -> (N, C, T) float32 on the device."""
        return torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
            self.device).transpose(1, 2).contiguous()

    def train(self, X: np.ndarray, y: np.ndarray, epochs: int = 20, lr: float = 3e-4,
              batch_size: int = 64, valid_frac: float = 0.2, verbose: bool = False,
              scan_epoch: bool = True) -> Dict[str, Any]:
        """One-cycle training. Each epoch takes a fresh permutation of the
        training windows from ``np.random.default_rng(seed)`` in whole
        batches; the history holds each epoch's mean loss and, with a
        validation split, its accuracy. ``scan_epoch`` is the reference's
        choice between one ``lax.scan`` per epoch and a step loop, which give
        the same batch sequence; the port always runs the step loop."""
        del scan_epoch
        Xtr, ytr, Xva, yva = stratified_split(X, y, valid_frac, self.seed)
        self.standardizer.fit(Xtr)
        Xtr, Xva = self.standardizer(Xtr), self.standardizer(Xva) if len(Xva) else Xva

        self.model.load_state_dict(self._init())
        steps_per_epoch = max(len(Xtr) // batch_size, 1)
        sched = cosine_onecycle_schedule(steps_per_epoch * epochs, peak_value=lr)
        # the rate given here is replaced before every step
        opt = torch.optim.Adam(self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        xs = self._windows(Xtr)
        ys = torch.from_numpy(np.asarray(ytr, np.int64)).to(self.device)
        rng = np.random.default_rng(self.seed)
        count = 0
        history = []
        for epoch in range(epochs):
            self.model.train()
            order = rng.permutation(len(Xtr))[: steps_per_epoch * batch_size]
            order_dev = torch.from_numpy(order).to(self.device)
            losses = []
            for s in range(0, steps_per_epoch * batch_size, batch_size):
                if len(order[s : s + batch_size]) < batch_size:
                    break
                idx = order_dev[s : s + batch_size]
                for g in opt.param_groups:
                    g["lr"] = sched(count)
                losses.append(self._step(opt, xs[idx], ys[idx]))
                count += 1
            mean = (float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
                    if losses else float("nan"))
            rec = {"epoch": epoch + 1, "loss": mean}
            if len(Xva):
                rec["valid_acc"] = float((self._predict_logits(Xva).argmax(-1) == yva).mean())
            history.append(rec)
            if verbose:
                print(rec)
        self.model.eval()
        self._ready = True
        return {"history": history}

    def _step(self, opt: torch.optim.Optimizer, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """One Adam step on the mean softmax cross-entropy of a batch (train
        mode: batch statistics, running statistics updated). Returns the loss
        on the device."""
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(self.model(xb), yb)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def _predict_logits(self, X: np.ndarray, batch_size: int = 256) -> np.ndarray:
        """(N, T, C) standardized windows -> (N, num_classes) logits, in eval
        mode, ``batch_size`` windows a forward."""
        self.model.eval()
        out = [self.model(self._windows(X[s : s + batch_size]))
               for s in range(0, len(X), batch_size)]
        return (torch.cat(out).cpu().numpy() if out
                else np.zeros((0, self.num_classes), np.float32))

    def _check_ready(self) -> None:
        if not self._ready:
            raise RuntimeError("train or load first")

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Class predictions for raw (N, T, C) windows (standardized internally)."""
        self._check_ready()
        return self._predict_logits(self.standardizer(np.asarray(X, np.float32))).argmax(-1)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """(N, num_classes) softmax probabilities (standardized internally)."""
        self._check_ready()
        logits = self._predict_logits(self.standardizer(np.asarray(X, np.float32)))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def save(self, path: str) -> None:
        from cvsd_tpu_torch.utils.checkpoint import save_checkpoint
        from cvsd_tpu_torch.utils.weights import state_dict_to_flax

        save_checkpoint(path, {
            "variables": state_dict_to_flax(self.model),
            "standardizer": {"mean": self.standardizer.mean, "std": self.standardizer.std},
        }, config={"seq_len": self.seq_len, "num_channels": self.num_channels,
                   "num_classes": self.num_classes, "nf": self.nf})

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "XceptionTimeClassifier":
        """A classifier from a ``save`` file of either package."""
        from cvsd_tpu_torch.utils.checkpoint import load_checkpoint
        from cvsd_tpu_torch.utils.weights import load_flax_variables

        state, meta = load_checkpoint(path)
        cfg = meta.get("config") or {}
        obj = cls(seq_len=int(cfg.get("seq_len", 64)), num_channels=int(cfg.get("num_channels", 4)),
                  num_classes=int(cfg.get("num_classes", 2)), nf=int(cfg.get("nf", 16)),
                  device=device)
        load_flax_variables(obj.model, state["variables"])
        obj.model.eval()
        obj.standardizer.mean = np.asarray(state["standardizer"]["mean"])
        obj.standardizer.std = np.asarray(state["standardizer"]["std"])
        obj._ready = True
        return obj
