"""Serve the anomaly scorer (+ optional detector) over HTTP.

    python -m cvsd_tpu_torch.cli.serve --checkpoint stage2_best.msgpack \
        --detector_checkpoint det.msgpack --port 8470 [--device cpu]
"""

from __future__ import annotations

import argparse

from cvsd_tpu_torch.cli.common import add_config_args, resolve_config
from cvsd_tpu_torch.utils.device import use_float32_math


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_config_args(p)
    p.add_argument("--checkpoint", type=str, required=True, help="Shopformer checkpoint")
    p.add_argument("--detector_checkpoint", type=str, default=None,
                   help="enable /detect with this detector")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8470)
    p.add_argument("--no-microbatch", action="store_true",
                   help="disable adaptive request micro-batching (one device "
                        "dispatch per request)")
    p.add_argument("--window-ms", type=float, default=0.0,
                   help="extra gather window per micro-batch (0 = adaptive "
                        "only, no added latency)")
    p.add_argument("--detect-batch", type=int, default=8,
                   help="fixed /detect batch (one batch shape)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup run of both programs (the first "
                        "request then pays cuDNN's algorithm choice and the "
                        "NMS kernel's nvcc build)")
    args = p.parse_args(argv)
    use_float32_math()

    from cvsd_tpu_torch.config import apply_overrides
    from cvsd_tpu_torch.eval.evaluate import load_model
    from cvsd_tpu_torch.serve.server import ScoringServer

    # --config takes the place of the checkpoint's embedded config, as
    # load_model's explicit config does; --set applies over either
    scorer = load_model(args.checkpoint, config=resolve_config(args) if args.config else None,
                        device=args.device)
    cfg = apply_overrides(scorer.config, args.overrides)
    scorer.config = cfg
    detection = None
    if args.detector_checkpoint:
        from cvsd_tpu_torch.cli.common import load_detector_cli
        from cvsd_tpu_torch.pipeline.preprocess import DetectionPipeline

        state_dict, cfg = load_detector_cli(args.detector_checkpoint, cfg, args.overrides)
        detection = DetectionPipeline(cfg, state_dict=state_dict, device=args.device)
    server = ScoringServer(scorer, detection, host=args.host, port=args.port,
                           microbatch=not args.no_microbatch,
                           window_ms=args.window_ms,
                           detect_batch=args.detect_batch)
    if not args.no_warmup:
        print("warming up (running both serving programs once)...", flush=True)
        print(f"warmup done: {server.warmup()}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
