"""Run bookkeeping: logging, seeding, metrics files, cross-fold result sheets
(twin of ``multi_task_breast_cancer_tpu/utils/miscellany.py``).

The artifact contract is the reference's ``src/utils/miscellany.py``: the
same log format, ``metrics.csv`` append semantics, and per-run Excel sheets
with fold columns, mean, std and a LaTeX ``mean $\\pm$ std`` column.
``seed_everything`` seeds the host RNGs and returns the root seed; the port
draws its torch randomness from explicit generators seeded from it
(``train/driver.py``). The JAX module's ``enable_compilation_cache`` has no
counterpart: the port compiles nothing per run but its kernels, which
``ops/_build.py`` caches by source hash.
"""

from __future__ import annotations

import glob
import logging
import os
import random

import numpy as np
import pandas as pd

from multi_task_breast_cancer_tpu_torch.ops.metrics import (
    binary_classification_metrics,
    multiclass_classification_metrics,
)
from multi_task_breast_cancer_tpu_torch.utils.xlsx import write_xlsx


def init_log(log_name: str) -> None:
    """File and console logging in the reference's format
    (``miscellany.py:55-75``)."""
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] - [%(levelname)s] - [%(filename)s:%(lineno)s] --- %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        filename=log_name,
        filemode="a",
        force=True,
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    logging.getLogger().addHandler(console)


def seed_everything(seed: int) -> int:
    """Seed ``random``, numpy's global RNG and ``PYTHONHASHSEED``; return the
    root seed."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    return int(seed)


def write_metrics_file(path_file: str, text_to_write: str) -> None:
    """Append one line (``miscellany.py:155-169``)."""
    with open(path_file, "a") as fm:
        fm.write(text_to_write)
        fm.write("\n")


def _latex(grouped: pd.DataFrame) -> pd.Series:
    return (round(grouped["mean"], 3).astype(str).str.ljust(5, "0") + " $\\pm$ "
            + round(grouped["std"], 3).astype(str).str.ljust(5, "0"))


def save_segmentation_results(path: str) -> None:
    """Cross-fold mean / std / LaTeX sheet from each fold's
    ``results_segmentation.csv`` (``miscellany.py:99-121``). The reference's
    quirks stay (``:92-98,109,117-118``): the fold files come from a
    lexicographic glob (fold10 before fold2), and 'std' is taken after the
    'mean' column was appended, so it includes the mean."""
    results = []
    for n, f in enumerate(sorted(glob.glob(path + "/fold*/results_segmentation.csv"))):
        df = pd.read_csv(f)
        df["fold"] = n
        results.append(df)
    if not results:
        logging.warning("save_segmentation_results: no fold results under %s", path)
        return
    df = pd.concat(results)
    grouped = (df.drop(columns=["patient_id", "class"], errors="ignore")
                 .groupby("fold").mean(numeric_only=True)
                 .reset_index().drop(columns="fold").T)
    grouped.columns = [f"fold {c}" for c in grouped.columns]
    grouped["mean"] = grouped.mean(axis=1)
    grouped["std"] = grouped.std(axis=1)
    grouped["latex"] = _latex(grouped)
    write_xlsx(path + "/results_segmentation.xlsx", grouped.reset_index(), index=False)


def save_classification_results(path: str, n_classes: int) -> None:
    """Cross-fold classification sheet (``miscellany.py:124-152``). The
    reference's quirks stay (``:118-121,145-148``): single-row frames keep
    index 0, so every fold column is labelled 'fold 0'; 'std' includes the
    appended 'mean'."""
    results = []
    for f in sorted(glob.glob(path + "/fold*/results_classification.csv")):
        df = pd.read_csv(f)
        if n_classes <= 2:
            metric = binary_classification_metrics(df.ground_truth, df.predicted_label)
        else:
            metric = multiclass_classification_metrics(df.ground_truth, df.predicted_label)
        results.append(pd.DataFrame([metric]))
    if not results:
        logging.warning("save_classification_results: no fold results under %s", path)
        return
    grouped = pd.concat(results).T
    grouped.columns = [f"fold {c}" for c in grouped.columns]
    grouped["mean"] = grouped.mean(axis=1)
    grouped["std"] = grouped.std(axis=1)
    grouped["latex"] = _latex(grouped)
    write_xlsx(path + "/classification_results.xlsx", grouped.reset_index(), index=False)
