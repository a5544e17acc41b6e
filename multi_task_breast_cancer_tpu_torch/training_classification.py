"""Entry point: classification, k-fold CV, on the GPU (equivalent of
``python -m src.training_classification``)."""

from multi_task_breast_cancer_tpu_torch._entry import run_entry


def main() -> None:
    run_entry(task="classification", mode="CV")


if __name__ == "__main__":
    main()
