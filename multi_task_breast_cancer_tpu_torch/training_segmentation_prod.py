"""Entry point: segmentation, production mode (train = train ∪ val, no
validation), on the GPU (equivalent of
``python -m src.training_segmentation_prod``)."""

from multi_task_breast_cancer_tpu_torch._entry import run_entry


def main() -> None:
    run_entry(task="segmentation", mode="CV_PROD")


if __name__ == "__main__":
    main()
