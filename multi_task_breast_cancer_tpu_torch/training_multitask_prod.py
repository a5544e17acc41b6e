"""Entry point: multi-task, production mode (train = train ∪ val, no
validation), on the GPU (equivalent of
``python -m src.training_multitask_prod``)."""

from multi_task_breast_cancer_tpu_torch._entry import run_entry


def main() -> None:
    run_entry(task="multitask", mode="CV_PROD")


if __name__ == "__main__":
    main()
