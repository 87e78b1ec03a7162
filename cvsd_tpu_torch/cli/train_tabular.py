"""Train the XceptionTime tabular classifier over preprocessed BBox CSVs.

    python -m cvsd_tpu_torch.cli.train_tabular \
        --csv dataset/ucf-crime_dataset.csv dataset/ucf-crime_dataset-normal.csv \
        --epochs 50 --output models/xception_time.msgpack [--device cpu]

The msgpack file is the JAX package's format: either package loads it.
``--device`` unset means the CUDA card, an error without one.
"""

from __future__ import annotations

import argparse
import json

from cvsd_tpu_torch.utils.device import resolve_device, use_float32_math


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--csv", nargs="+", required=True, help="BBox CSV paths")
    p.add_argument("--seq_len", type=int, default=64)
    p.add_argument("--stride", type=int, default=32)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--nf", type=int, default=16)
    p.add_argument("--output", type=str, default="models/xception_time.msgpack")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, an error without one; "
                        "'cpu' runs on the host)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # a missing card is reported before any file
    use_float32_math()

    from cvsd_tpu_torch.models.xception_time import XceptionTimeClassifier, windows_from_bbox_csv

    X, y = windows_from_bbox_csv(args.csv, seq_len=args.seq_len, stride=args.stride)
    print(f"windows: {X.shape}, anomalous: {int(y.sum())}/{len(y)}")
    if len(X) == 0:
        raise SystemExit("no windows extracted — run preprocessing first")
    clf = XceptionTimeClassifier(seq_len=args.seq_len, num_channels=X.shape[-1], nf=args.nf,
                                 device=device)
    out = clf.train(X, y, epochs=args.epochs, lr=args.lr, batch_size=args.batch_size,
                    verbose=True)
    clf.save(args.output)
    preds = clf.predict(X)
    acc = float((preds == y).mean())
    print(json.dumps({"train_acc": acc, "saved": args.output,
                      "final": out["history"][-1]}, default=float))


if __name__ == "__main__":
    main()
