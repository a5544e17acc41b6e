"""Serving CLI of the PyTorch port.

    # export a checkpoint into a serving artifact (torch.export programs per
    # bucket, for the CPU and the card; the card must be there)
    python -m multi_task_breast_cancer_tpu_torch.serve export \
        --config config.yaml --task multitask \
        --checkpoint runs/<run>/fold_0/model_<ts>_fold_0 --output ./artifact \
        --buckets 1,8,64 [--device-postprocess]

    # serve an artifact: the port's (its exported programs) or the JAX
    # package's (its manifest.json + weights.npz, as a live model)
    python -m multi_task_breast_cancer_tpu_torch.serve run --artifact ./artifact \
        --port 8000 --max-batch 64 --batch-wait-ms 5

    # serve a config's model with a checkpoint the port's driver wrote
    python -m multi_task_breast_cancer_tpu_torch.serve run \
        --config runs/<run>/config.yaml --task multitask \
        --checkpoint runs/<run>/fold_0/model_<ts>_fold_0

    # or with a serving artifact's weights.npz
    python -m multi_task_breast_cancer_tpu_torch.serve run \
        --config config.yaml --task multitask --checkpoint ./artifact/weights.npz

Both compute in the config's or the artifact's ``compute_dtype`` (float32 or
bfloat16). ``--device`` defaults to ``cuda``; ``--device cpu`` runs on the
CPU (``export --platforms cpu`` exports without a card).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="multi_task_breast_cancer_tpu_torch.serve")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_exp = sub.add_parser("export", help="export a checkpoint to a serving artifact")
    p_exp.add_argument("--config", default="./config.yaml")
    p_exp.add_argument("--task", default="multitask",
                       choices=["segmentation", "classification", "multitask"])
    p_exp.add_argument("--checkpoint", required=True)
    p_exp.add_argument("--output", required=True)
    p_exp.add_argument("--buckets", default="1,8,64",
                       help="comma-separated batch sizes to export")
    p_exp.add_argument("--size", type=int, default=128)
    p_exp.add_argument("--platforms", default="cpu,cuda")
    p_exp.add_argument("--device-postprocess", action="store_true",
                       help="put postprocessing (sigmoid/argmax/pixel counts) into the "
                            "programs: they then emit uint8 masks + probabilities")

    p_run = sub.add_parser("run", help="start the online inference server")
    p_run.add_argument("--artifact", help="serving artifact directory (the port's or JAX's)")
    p_run.add_argument("--config", default="./config.yaml")
    p_run.add_argument("--task", default="multitask",
                       choices=["segmentation", "classification", "multitask"])
    p_run.add_argument("--checkpoint", help="a training checkpoint of the port, or a "
                                            "weights.npz in the artifact layout")
    p_run.add_argument("--size", type=int, default=128)
    p_run.add_argument("--host", default="0.0.0.0")
    p_run.add_argument("--port", type=int, default=8000)
    p_run.add_argument("--max-batch", type=int, default=64)
    p_run.add_argument("--batch-wait-ms", type=float, default=5.0)
    p_run.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.cmd == "export":
        from multi_task_breast_cancer_tpu_torch.config import load_config
        from multi_task_breast_cancer_tpu_torch.serve.export import export_inference
        export_inference(load_config(args.config), args.task, args.checkpoint, args.output,
                         buckets=[int(b) for b in args.buckets.split(",")], size=args.size,
                         platforms=tuple(args.platforms.split(",")),
                         device_postprocess=args.device_postprocess)
        return

    from multi_task_breast_cancer_tpu_torch.serve.server import (
        ArtifactBackend, CheckpointBackend, InferenceServer)
    if args.artifact:
        backend = ArtifactBackend(args.artifact, device=args.device)
    else:
        if not args.checkpoint:
            raise SystemExit("run: provide --artifact or --checkpoint")
        from multi_task_breast_cancer_tpu_torch.config import load_config
        cfg = load_config(args.config)
        backend = CheckpointBackend(cfg, args.task, args.checkpoint,
                                    size=args.size, max_batch=args.max_batch,
                                    device=args.device)
    InferenceServer(backend, host=args.host, port=args.port,
                    max_batch=args.max_batch,
                    batch_wait_ms=args.batch_wait_ms).serve_forever()


if __name__ == "__main__":
    main()
