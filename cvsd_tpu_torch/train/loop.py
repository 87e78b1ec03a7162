"""Two-stage Shopformer trainer: stage freezing, schedules, accumulation,
early stopping, checkpoints, metrics and artifacts (PyTorch port of
``cvsd_tpu/train/loop.py``, on one device).

Stage 1 trains the GCAE on its reconstruction loss (BatchNorm statistics
move); stage 2 freezes it and trains the transformer on tokens from the GCAE
in eval mode. Each stage gets a fresh optimizer over its part
(``train/optim.py``). Checkpoints are the JAX package's msgpack files,
``stage{1,2}_{best,final,epochN}.msgpack``, and either package loads the
other's; ``config.json``, ``training_history.json`` and
``training_results.json`` have the JAX keys.

Randomness: each step's augmentation and dropout draw from two explicit
``torch.Generator``s on the device, seeded from host counters only,
(seed, epoch * 100003 + i) as in JAX, so a run repeats bit for bit on one
device. The global RNG is never used.

``training.scan_epoch`` (the JAX package's one ``lax.scan`` per epoch) copies
the epoch's batches to the device in one transfer (``scan_epoch_chunk``
batches at a time) and runs the same sequential per-batch updates as the
step loop. ``training.remat`` wraps the loss in ``torch.utils.checkpoint``:
the recomputed forward replays the step's dropout masks and moves no
BatchNorm statistics (``models/layers.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from cvsd_tpu_torch.config import Config, save_config, validate_config
from cvsd_tpu_torch.data.augment import batched_augment_from_config
from cvsd_tpu_torch.data.datamodule import PoseLiftDataModule
from cvsd_tpu_torch.eval.evaluate import ShopformerScorer
from cvsd_tpu_torch.models.layers import DropoutRNG, frozen_batch_stats
from cvsd_tpu_torch.models.shopformer import Shopformer, build_shopformer, count_parameters
from cvsd_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauController,
    StageOptimizer,
    build_optimizer,
    current_learning_rate,
    set_learning_rate,
    stage_param_labels,
)
from cvsd_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from cvsd_tpu_torch.utils.device import DeviceLike, resolve_device, use_float32_math
from cvsd_tpu_torch.utils.logging import ScalarLogger
from cvsd_tpu_torch.utils.metrics import compute_metrics, compute_video_level_metrics
from cvsd_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

STEP_KEY_STRIDE = 100003  # a step's key is (seed, epoch * STEP_KEY_STRIDE + i)


def step_seeds(seed: int, counter: int) -> Tuple[int, int]:
    """The augmentation and dropout seeds of one step, from host counters."""
    words = np.random.SeedSequence([int(seed), int(counter)]).generate_state(4, np.uint32)
    w = [int(x) for x in words]
    return (w[0] << 31) ^ w[1], (w[2] << 31) ^ w[3]


class Trainer:
    """Two-stage trainer. Usage: ``Trainer(config).setup().fit()``.
    ``device``: the default is the CUDA card, raising without one."""

    def __init__(self, config: Dict[str, Any], mesh_config: Any = None, verbose: bool = True,
                 device: DeviceLike = None):
        if mesh_config is not None:
            raise NotImplementedError(
                "mesh_config: the port trains on one device; a mesh waits for ROADMAP.md "
                "section 1, item Parallel")
        self.device = resolve_device(device)
        use_float32_math()  # the reference trains the Shopformer in float32
        # a run repeats bit for bit on one device: cuDNN's backward kernels
        # that add with atomics are not chosen (process-wide, as TF32's flags)
        torch.backends.cudnn.deterministic = True
        validate_config(config)
        self.config = Config(config)
        self.verbose = verbose
        self.model: Optional[Shopformer] = None
        self.datamodule: Optional[PoseLiftDataModule] = None
        self.history: Dict[str, Any] = {"stage1": [], "stage2": []}
        self.best_auc = -1.0
        self.best_epoch = -1
        self._fit_deadline: Optional[float] = None
        self.timed_out = False

    # -- setup ------------------------------------------------------------------

    def setup(self) -> "Trainer":
        cfg = self.config
        self.seed = int(cfg["experiment"].get("seed", 42))
        self.datamodule = PoseLiftDataModule(cfg, verbose=self.verbose).setup()
        self.model = build_shopformer(cfg, device=self.device, seed=self.seed)
        self.scorer = ShopformerScorer(self.model, cfg, device=self.device)
        t = cfg["training"]
        self._augment = bool(cfg["data"].get("augment", {}).get("enabled", True))
        self._remat = bool(t.get("remat", False))
        self._gens = (torch.Generator(device=self.device), torch.Generator(device=self.device))

        out_dir = cfg["experiment"].get("checkpoint_dir", "checkpoints")
        self.ckpt = CheckpointManager(out_dir, config=cfg.to_dict())
        self.logger = ScalarLogger(out_dir) if self.verbose else None
        save_config(cfg, os.path.join(out_dir, "config.json"))
        if self.verbose:
            print(f"Model parameters: {count_parameters(self.model)}")
            print(f"Dataset stats: {self.datamodule.get_stats()}")
        return self

    def make_optimizer(self, stage: int) -> StageOptimizer:
        """A fresh optimizer over the stage's trained part; the clip's norm
        is taken over every parameter's gradient."""
        t = self.config["training"]
        epochs = int(t[f"stage{stage}_epochs"])
        steps = max(self.datamodule.steps_per_epoch() // int(t.get("grad_accum_steps", 1)), 1)
        labels = stage_param_labels([n for n, _ in self.model.named_children()], stage)
        trained = [p for name, part in self.model.named_children() if labels[name] == "train"
                   for p in part.parameters()]
        return build_optimizer(self.config, steps, epochs, trained, self.model.parameters())

    # -- one step ---------------------------------------------------------------

    def _loss(self, stage: int, poses: torch.Tensor, mask: torch.Tensor,
              rng: DropoutRNG) -> torch.Tensor:
        if stage == 1:
            return self.model.compute_gcae_loss(poses, train=True, mask=mask, rng=rng)
        return self.model.compute_transformer_loss(poses, train=True, mask=mask, rng=rng)

    def train_step(self, stage: int, opt: StageOptimizer, poses: torch.Tensor,
                   mask: torch.Tensor, counter: int) -> torch.Tensor:
        """One micro-step on a batch already on the device: augment, forward,
        backward, the optimizer's micro-step. Returns the loss on the device
        (no host sync)."""
        aug_seed, drop_seed = step_seeds(self.seed, counter)
        aug_gen, drop_gen = self._gens
        if self._augment:
            aug_gen.manual_seed(aug_seed)
            poses = batched_augment_from_config(aug_gen, poses, self.config)
        drop_gen.manual_seed(drop_seed)
        rng = DropoutRNG(drop_gen)
        if self._remat:
            def forward(p):
                rng.rewind()  # a recomputed forward takes the same masks
                return self._loss(stage, p, mask, rng)

            loss = torch.utils.checkpoint.checkpoint(forward, poses, use_reentrant=False)
            with frozen_batch_stats(self.model):  # the recomputed forward moves no statistics
                loss.backward()
        else:
            loss = self._loss(stage, poses, mask, rng)
            loss.backward()
        opt.step()
        return loss.detach()

    def _put(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device, non_blocking=True)

    def _run_epoch(self, stage: int, opt: StageOptimizer, epoch: int) -> Tuple[float, int]:
        """Every batch of the epoch, in order: (mean loss, batches); the loss
        is NaN without batches."""
        t = self.config["training"]
        losses: List[torch.Tensor] = []
        if bool(t.get("scan_epoch", False)):
            batches = list(self.datamodule.train_batches(epoch=epoch))
            chunk = int(t.get("scan_epoch_chunk", 0) or 0) or max(len(batches), 1)
            for c0 in range(0, len(batches), chunk):
                part = batches[c0: c0 + chunk]
                poses_all = self._put(np.stack([b["poses"] for b in part]))
                masks_all = self._put(np.stack([b["mask"] for b in part]))
                for j in range(len(part)):
                    losses.append(self.train_step(stage, opt, poses_all[j], masks_all[j],
                                                  epoch * STEP_KEY_STRIDE + c0 + j))
        else:
            for i, batch in enumerate(self.datamodule.train_batches(epoch=epoch)):
                losses.append(self.train_step(stage, opt, self._put(batch["poses"]),
                                              self._put(batch["mask"]),
                                              epoch * STEP_KEY_STRIDE + i))
        if not losses:
            return float("nan"), 0
        return float(np.mean(torch.stack(losses).cpu().numpy())), len(losses)

    # -- stages -----------------------------------------------------------------

    def train_stage(self, stage: int, opt: Optional[StageOptimizer] = None) -> StageOptimizer:
        cfg = self.config
        t = cfg["training"]
        epochs = int(t[f"stage{stage}_epochs"])
        if opt is None:
            opt = self.make_optimizer(stage)
        early = None
        es_cfg = t.get("early_stopping", {})
        if stage == 2 and es_cfg.get("enabled", True):
            early = EarlyStopping(
                patience=int(es_cfg.get("patience", 20)),
                min_delta=float(es_cfg.get("min_delta", 0.0)),
                mode=es_cfg.get("mode", "max"),
            )
        plateau = None
        if t.get("scheduler") == "reduce_on_plateau":
            sp = t.get("scheduler_params", {})
            plateau = PlateauController(
                factor=float(sp.get("plateau_factor", 0.5)),
                patience=int(sp.get("plateau_patience", 5)),
                mode="min" if stage == 1 else "max",
            )

        # wall-clock budget (training.max_seconds, 0 = unlimited), checked
        # between epochs; fit() arms one deadline for both stages
        max_seconds = float(t.get("max_seconds", 0) or 0)
        if max_seconds > 0 and self._fit_deadline is None:
            self._fit_deadline = time.perf_counter() + max_seconds
        deadline = self._fit_deadline

        ckpt_every = int(t.get("checkpoint_every_n_epochs", 0) or 0)
        eval_every = int(t.get("eval_every_n_epochs", 1) or 1)
        best_loss = float("inf")
        epoch_loss = float("nan")  # stays NaN when epochs == 0
        for epoch in range(1, epochs + 1):
            t0 = time.perf_counter()
            epoch_loss, batches = self._run_epoch(stage, opt, epoch)
            if batches and not np.isfinite(epoch_loss) and t.get("abort_on_nan", True):
                # a NaN/inf loss means diverged training: stop the stage
                self.history[f"stage{stage}"].append(
                    {"epoch": epoch, "loss": epoch_loss, "aborted": "non-finite loss"})
                if self.verbose:
                    print(f"[stage{stage}] ABORT at epoch {epoch}: non-finite loss {epoch_loss}")
                break
            lr = current_learning_rate(opt)
            dt = time.perf_counter() - t0

            record: Dict[str, Any] = {"epoch": epoch, "loss": epoch_loss, "lr": lr, "seconds": dt}
            if self.logger:
                self.logger.log_scalar(f"Stage{stage}/Loss", epoch_loss, epoch)
                if lr is not None:
                    self.logger.log_scalar(f"Stage{stage}/LR", lr, epoch)

            if stage == 2 and (epoch % eval_every == 0):
                labels, scores, _ = self.score_test_set()
                m = compute_metrics(labels, scores)
                record.update({"auc_roc": m["auc_roc"], "auc_pr": m["auc_pr"]})
                if self.logger:
                    self.logger.log_scalar("Stage2/AUC_ROC", m["auc_roc"], epoch)
                    self.logger.log_scalar("Stage2/AUC_PR", m["auc_pr"], epoch)
                if m["auc_roc"] > self.best_auc:
                    self.best_auc = m["auc_roc"]
                    self.best_epoch = epoch
                    self.ckpt.save_best(2, self._ckpt_state(), epoch=epoch, metrics=m,
                                        history=self.history)
                if plateau is not None and lr is not None:
                    new_lr = plateau.update(m["auc_roc"], lr)
                    if new_lr != lr:
                        set_learning_rate(opt, new_lr)
                if early is not None and early(m["auc_roc"]):
                    self.history[f"stage{stage}"].append(record)
                    if self.verbose:
                        print(f"[stage2] early stop at epoch {epoch} (best AUC {self.best_auc:.4f})")
                    break
            elif stage == 1:
                if plateau is not None and lr is not None:
                    new_lr = plateau.update(epoch_loss, lr)
                    if new_lr != lr:
                        set_learning_rate(opt, new_lr)
                if epoch_loss < best_loss:
                    best_loss = epoch_loss
                    self.ckpt.save_best(1, self._ckpt_state(), epoch=epoch,
                                        metrics={"loss": epoch_loss}, history=self.history)

            self.history[f"stage{stage}"].append(record)
            if ckpt_every and epoch % ckpt_every == 0:
                self.ckpt.save_epoch(stage, epoch, self._ckpt_state())
            if self.verbose:
                msg = f"[stage{stage}] epoch {epoch}/{epochs} loss={epoch_loss:.6f}"
                if "auc_roc" in record:
                    msg += f" auc={record['auc_roc']:.4f}"
                print(msg + f" ({dt:.1f}s)")
            if deadline is not None and time.perf_counter() > deadline:
                record["aborted"] = "max_seconds exceeded"
                self.timed_out = True
                if self.verbose:
                    print(f"[stage{stage}] ABORT at epoch {epoch}: "
                          f"training.max_seconds budget exceeded")
                break

        self.ckpt.save_final(stage, self._ckpt_state(), metrics={"loss": epoch_loss},
                             history=self.history)
        return opt

    def _ckpt_state(self) -> Dict[str, Any]:
        """The model as flax variables ({params, batch_stats}) on the host."""
        return state_dict_to_flax(self.model)

    # -- eval -------------------------------------------------------------------

    def score_test_set(self) -> Tuple[np.ndarray, np.ndarray, list]:
        """(labels, scores, video_ids) over the test split, scored in batches of
        ``data.batch_size`` by the same scorer ``load_model`` builds."""
        ds = self.datamodule.test_dataset
        scores = self.scorer.score(ds.poses)
        labels = np.asarray(ds.labels)[: len(scores)]
        return labels, scores, list(ds.video_ids)[: len(scores)]

    def evaluate(self) -> Dict[str, Any]:
        labels, scores, video_ids = self.score_test_set()
        ev = self.config.get("eval", {})
        metrics = compute_metrics(labels, scores, threshold=ev.get("threshold"),
                                  threshold_method=ev.get("threshold_method", "youden"))
        result: Dict[str, Any] = {"frame_level": metrics}
        aggs = ev.get("video_aggregations")
        if aggs and len(video_ids) == len(scores):
            result["video_level"] = compute_video_level_metrics(labels, scores, video_ids, aggs)
        result["score_stats"] = {
            "mean": float(scores.mean()) if scores.size else 0.0,
            "std": float(scores.std()) if scores.size else 0.0,
            "min": float(scores.min()) if scores.size else 0.0,
            "max": float(scores.max()) if scores.size else 0.0,
            "median": float(np.median(scores)) if scores.size else 0.0,
        }
        return result

    # -- orchestration ------------------------------------------------------------

    def fit(self, start_stage: int = 1, resume_checkpoint: Optional[str] = None) -> Dict[str, Any]:
        """Both stages (from ``start_stage``; stage 2 alone loads
        ``stage1_best`` where it exists), then the best stage-2 checkpoint
        evaluated; writes the history and results artifacts."""
        max_s = float(self.config["training"].get("max_seconds", 0) or 0)
        if max_s > 0 and self._fit_deadline is None:
            # one budget for the whole fit, so a slow stage 1 cannot hand
            # stage 2 a fresh clock
            self._fit_deadline = time.perf_counter() + max_s
        if resume_checkpoint:
            self.load_model_state(resume_checkpoint)
        elif start_stage == 2 and self.ckpt.exists("stage1_best"):
            self.load_model_state(self.ckpt.path("stage1_best"))

        if start_stage <= 1:
            self.train_stage(1)
        self.train_stage(2)

        if self.ckpt.exists("stage2_best"):
            self.load_model_state(self.ckpt.path("stage2_best"))
        results = self.evaluate()
        artifact = {
            "config": self.config.to_dict(),
            "history": self.history,
            "timed_out": self.timed_out,
            "best_auc": self.best_auc,
            "best_epoch": self.best_epoch,
            "test_metrics": results["frame_level"],
            "video_metrics": results.get("video_level"),
            "score_stats": results["score_stats"],
        }
        out_dir = self.config["experiment"].get("checkpoint_dir", "checkpoints")
        with open(os.path.join(out_dir, "training_history.json"), "w") as f:
            json.dump(self.history, f, indent=2, default=float)
        with open(os.path.join(out_dir, "training_results.json"), "w") as f:
            json.dump(artifact, f, indent=2, default=float)
        if self.logger:
            flat_hp = {
                "lr": self.config["training"]["lr"],
                "optimizer": self.config["training"]["optimizer"],
                "variant": self.config["model"]["variant"],
                "num_tokens": self.config["model"]["num_tokens"],
            }
            self.logger.log_hparams(flat_hp, results["frame_level"])
        if self.verbose:
            print(f"Final test metrics: {results['frame_level']}")
        return artifact

    def load_model_state(self, path: str) -> None:
        """Fill the model from a checkpoint of either package (strict)."""
        state, _meta = load_checkpoint(path)
        variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
        load_flax_variables(self.model, variables)


def train_from_config(config: Dict[str, Any], mesh_config: Any = None, verbose: bool = True,
                      start_stage: int = 1, resume_checkpoint: Optional[str] = None,
                      device: DeviceLike = None) -> Dict[str, Any]:
    return Trainer(config, mesh_config, verbose=verbose, device=device).setup().fit(
        start_stage=start_stage, resume_checkpoint=resume_checkpoint)
