"""Serving CLI of the PyTorch port.

    # serve a JAX serving artifact (its manifest.json + weights.npz)
    python -m multi_task_breast_cancer_tpu_torch.serve run --artifact ./artifact \
        --port 8000 --max-batch 64 --batch-wait-ms 5

    # serve a config's model with a checkpoint the port's driver wrote
    python -m multi_task_breast_cancer_tpu_torch.serve run \
        --config runs/<run>/config.yaml --task multitask \
        --checkpoint runs/<run>/fold_0/model_<ts>_fold_0

    # or with a JAX serving artifact's weights.npz
    python -m multi_task_breast_cancer_tpu_torch.serve run \
        --config config.yaml --task multitask --checkpoint ./artifact/weights.npz

``--device`` defaults to ``cuda``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import logging


def main() -> None:
    parser = argparse.ArgumentParser(prog="multi_task_breast_cancer_tpu_torch.serve")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="start the online inference server")
    p_run.add_argument("--artifact", help="JAX serving artifact directory")
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

    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)

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
