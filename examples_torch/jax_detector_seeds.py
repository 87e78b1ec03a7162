"""Train the synthetic example's detector in the JAX package from several
init seeds and save each one, for the port's later stages to read.

The port's synthetic chain reads window AUCs below the reference's rows
(ROADMAP.md, fault 1), and the detector stage carries the gap. One JAX
detector against a few port detectors cannot tell the spread over detector
seeds from a systematic gap; this probe gives the JAX side's spread. Each
seed's detector is trained exactly as ``examples/end_to_end_synthetic.py``
trains its own (img 128, width 0.25, depth 0.34, float32, lr 2e-3, 2000
steps, 100 warm-up, EMA 0.998, chunks of 200 batches of
``rendered_detection_batch(rng, 8, 128)`` from ``np.random.default_rng(0)``)
except that ``DetectorTrainer(seed=s)`` draws its init from seed ``s``: the
data are the example's for every seed. Each seed writes
``OUT/seed{s}/detector.msgpack`` (the EMA weights, as the example saves
them), which the port's ``load_detector_checkpoint`` reads; then

    python examples_torch/synthetic_auc_probe.py --weights-from DIR ...

runs the port's later stages on it (DIR holding the detector and one
``pose_topdown.msgpack``).

This is a CPU probe beside the JAX package: it imports jax and cvsd_tpu
inside ``main``, never runs on the card, and nothing of the port depends
on it. One seed takes about 25 minutes on an 8-core CPU.

    JAX_PLATFORMS=cpu python examples_torch/jax_detector_seeds.py \\
        --out DIR --seeds 0 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

IMG = 128
CHUNK = 200


def train_seed(seed: int, steps: int, out: str) -> dict:
    """The example's detector stage with the trainer's init from ``seed``."""
    import jax.numpy as jnp

    from cvsd_tpu.data.render import rendered_detection_batch
    from cvsd_tpu.models.detector import PersonDetector
    from cvsd_tpu.train.detector_train import DetectorTrainer

    t0 = time.time()
    rng = np.random.default_rng(0)
    model = PersonDetector(img_size=IMG, width_mult=0.25, depth_mult=0.34, dtype=jnp.float32)
    trainer = DetectorTrainer(model, lr=2e-3, seed=seed, total_steps=steps,
                              warmup_steps=100, ema_decay=0.998)
    done, losses = 0, []
    while done < steps:
        n = min(CHUNK, steps - done)
        data = [rendered_detection_batch(rng, 8, IMG) for _ in range(n)]
        res = trainer.train_steps_scan(np.stack([d[0] for d in data]),
                                       np.stack([d[1] for d in data]),
                                       np.stack([d[2] for d in data]))
        done += n
        losses.append([float(res["losses"][0]), float(res["losses"][-1])])
        print(f"  seed {seed} steps {done}: loss {losses[-1][0]:.2f} -> {losses[-1][1]:.2f}",
              flush=True)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "detector.msgpack")
    trainer.save(path, steps=steps)
    return {"seed": seed, "steps": steps, "path": path, "chunk_losses": losses,
            "seconds": time.time() - t0}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--steps", type=int, default=2000)
    args = p.parse_args(argv)

    import jax

    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    for seed in args.seeds:
        record = train_seed(seed, args.steps, os.path.join(args.out, f"seed{seed}"))
        print("jax_detector " + json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
