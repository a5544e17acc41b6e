"""Split-plan inspection CLI (twin of
``multi_task_breast_cancer_tpu/data/holdout_check.py``): prints the fold
memberships and class distributions of a mapping.csv under a seed, to check
fold membership against a reference run before a long training.

    python -m multi_task_breast_cancer_tpu_torch.data.holdout_check \\
        --mapping ./data/Curated_BUSI_128/mapping.csv --seed 1993 --folds 4

The output is the JAX tool's, line for line (the splits are sklearn's,
replayed in numpy by :mod:`.splits`). Like every tool of the port it runs
where the port runs, ``cuda`` unless ``--device cpu``, though it does no
device work.
"""

from __future__ import annotations

import argparse

import pandas as pd

from multi_task_breast_cancer_tpu_torch.data.splits import holdout_split, stratified_cv_splits
from multi_task_breast_cancer_tpu_torch.device import resolve_device


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mapping", required=True)
    parser.add_argument("--seed", type=int, default=1993)
    parser.add_argument("--folds", type=int, default=4)
    parser.add_argument("--mode", default="CV", choices=["CV", "CV_PROD", "holdout"])
    # DataConfig.oversampling's default (reference config.yaml:42), so the
    # printout agrees with a training run
    parser.add_argument("--no-oversampling", dest="oversampling",
                        action="store_false", default=True)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    mapping = pd.read_csv(args.mapping)
    if args.mode == "holdout":
        split = holdout_split(mapping, args.seed, oversampling=args.oversampling)
        for name, df in split.items():
            print(f"{name}: n={len(df)}")
            print(df.groupby("class")["id"].apply(list).to_string())
        return

    folds = stratified_cv_splits(mapping, args.seed, args.folds,
                                 oversampling=args.oversampling,
                                 merge_val=args.mode == "CV_PROD")
    for n, fold in enumerate(folds):
        print(f"--- fold {n} ---")
        for name, df in fold.items():
            dist = df["class"].value_counts().to_dict()
            print(f"{name}: n={len(df)} {dist}")
            if name == "test":
                ids = sorted(zip(df["class"], df["id"]))
                print("  test ids:", ids)


if __name__ == "__main__":
    main()
