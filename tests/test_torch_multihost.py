"""The port's multi-process start-up (``parallel/multihost.py``, the training
CLIs' ``--coordinator/--num-processes/--process-id``) and the driver over
ranks, on the CPU over Gloo (twin of ``tests/test_multihost.py``).

The two-rank driver runs are the JAX test's full driver run: every rank runs
the whole experiment, one user-visible run directory comes out with the
artifact contract, and a killed run resumed on two ranks continues in that
directory and ends byte for byte as an uninterrupted two-rank run (rank 1's
artifacts in its scratch directory equal rank 0's, checkpoints included).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import pandas as pd
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
from multi_task_breast_cancer_tpu_torch.parallel import multihost
from test_torch_parallel import run_ranks


def case_torchrun_env(rank, world, port):
    """``initialize()`` with no argument under torchrun's environment."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), LOCAL_RANK=str(rank))
    active = multihost.initialize(backend="gloo", timeout_s=60)
    t = torch.tensor([float(rank + 1)])
    torch.distributed.all_reduce(t)
    return {"active": active, "rank": multihost.process_index(),
            "count": multihost.process_count(), "local_rank": multihost.local_rank(),
            "sum": t.item(), "slice": multihost.process_local_slice(8)}


def case_cli(rank, world, port, argv, crash_at=0):
    """The training CLI (``_entry.run_entry``) as rank ``rank``, on the CPU;
    ``crash_at`` kills the run at that checkpoint write. Returns the run
    directory this rank wrote."""
    from multi_task_breast_cancer_tpu_torch import _entry
    from multi_task_breast_cancer_tpu_torch.train import driver

    _entry.run_experiment = functools.partial(driver.run_experiment, device="cpu")
    flags = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
             "--process-id", str(rank)]
    if crash_at:
        real_save, calls = driver.save_checkpoint, {"n": 0}

        def crashing_save(*args, **kwargs):
            calls["n"] += 1
            if calls["n"] == crash_at:
                raise KeyboardInterrupt  # a kill between a metrics row and its checkpoint
            return real_save(*args, **kwargs)

        driver.save_checkpoint = crashing_save
        try:
            _entry.run_entry("multitask", "CV", argv + flags)
        except KeyboardInterrupt:
            return {"killed": True}
        raise AssertionError(f"the run ended before checkpoint write {crash_at}")
    return {"run": _entry.run_entry("multitask", "CV", argv + flags)}


def test_initialize_is_a_no_op_without_flags_or_environment(monkeypatch):
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    monkeypatch.setenv("RANK", "0")  # an incomplete environment is no process group
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_detects_torchrun_environment(tmp_path):
    ranks = run_ranks(2, "test_torch_multihost", "case_torchrun_env", tmp_path, {},
                      init=False)
    for r, res in enumerate(ranks):
        assert res == {"active": True, "rank": r, "count": 2, "local_rank": r, "sum": 3.0,
                       "slice": slice(4 * r, 4 * r + 4)}


def test_initialize_raises_instead_of_carrying_on_alone():
    """JAX logs a failed initialisation and carries on as one process; the
    port raises."""
    with pytest.raises(ValueError, match="host:port"):
        multihost.initialize("no-port", 2, 1)
    with pytest.raises(ValueError, match="--num-processes"):
        multihost.initialize("127.0.0.1:1234")
    with pytest.raises(ValueError, match="outside"):
        multihost.initialize("127.0.0.1:1234", 2, 2)
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="timed out"):  # nobody listens there
        multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 2, 1, backend="gloo",
                             timeout_s=2)
    assert time.perf_counter() - t0 < 60
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("count,index", [(4, 3), (4, 0), (2, 1)])
def test_process_slices_and_run_roots_match_jax(monkeypatch, tmp_path, count, index):
    """``process_local_slice`` and ``coordinator_run_root`` answer as the
    JAX functions under the same counts (``tests/test_multihost.py``)."""
    import jax

    from multi_task_breast_cancer_tpu.parallel import multihost as jax_multihost

    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(multihost, "process_count", lambda: count)
    monkeypatch.setattr(multihost, "process_index", lambda: index)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    for n in (8, 12, 10, 6):
        try:
            want = jax_multihost.process_local_slice(n)
        except ValueError as e:
            with pytest.raises(ValueError, match="does not shard evenly"):
                multihost.process_local_slice(n)
            assert "does not shard evenly" in str(e)
        else:
            assert multihost.process_local_slice(n) == want
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    root = str(tmp_path / "runs")
    got, want = multihost.coordinator_run_root(root), jax_multihost.coordinator_run_root(root)
    if index == 0:
        assert got == want == root
    else:
        assert got != root and want != root and Path(got).is_dir()
        assert Path(got).name.startswith(f"mtbc_proc{index}_artifacts_")
        assert Path(want).name.startswith(f"mtbc_proc{index}_artifacts_")


def test_cli_flags_and_one_worker_per_gpu(monkeypatch, tmp_path):
    """The training CLIs pass ``--coordinator/--num-processes/--process-id``
    to ``initialize``; a rank other than 0 writes to scratch and resumes a
    private copy of the run; with ``data_parallel``, several visible GPUs
    and no process group, the command starts one worker per GPU (the
    module's own ``__main__``) and fails when a worker fails."""
    from multi_task_breast_cancer_tpu_torch import _entry, training_segmentation_prod

    cfg = tmp_path / "config.yaml"
    cfg.write_text("training: {seed: 7}\n")
    resume = tmp_path / "runs" / "20260101_000000_MTnnUNet"
    resume.mkdir(parents=True)
    (resume / "marker").write_text("x")
    seen = {}
    monkeypatch.setattr(multihost, "initialize",
                        lambda **kw: seen.setdefault("init", kw) is not None)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    monkeypatch.setattr(multihost, "barrier", lambda: seen.setdefault("barrier", True))
    monkeypatch.setenv("TMPDIR", str(tmp_path / "scratch"))
    (tmp_path / "scratch").mkdir()
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "scratch"))
    monkeypatch.setattr(_entry, "run_experiment",
                        lambda cfg, **kw: seen.setdefault("run", kw) and "run")
    monkeypatch.setattr(sys, "argv", ["x", "--config", str(cfg), "--run-root",
                                      str(tmp_path / "runs"), "--resume", str(resume),
                                      "--coordinator", "10.0.0.1:4321", "--num-processes",
                                      "2", "--process-id", "1"])
    training_segmentation_prod.main()
    assert seen["init"] == {"coordinator_address": "10.0.0.1:4321", "num_processes": 2,
                            "process_id": 1}
    run = seen["run"]
    assert (run["task"], run["mode"]) == ("segmentation", "CV_PROD")
    assert Path(run["run_root"]).parent == tmp_path / "scratch"
    assert Path(run["resume_dir"]) == Path(run["run_root"]) / resume.name
    assert (Path(run["resume_dir"]) / "marker").read_text() == "x"
    assert seen["barrier"]

    launched = []
    monkeypatch.setattr(multihost, "initialize", lambda **kw: False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(multihost, "launch_local_workers",
                        lambda n, argv: launched.append((n, argv)) or 0)
    assert _entry.run_entry("multitask", "CV", ["--config", str(cfg)]) is None
    assert launched == [(2, [sys.executable, "-m", "multi_task_breast_cancer_tpu_torch._entry",
                             "multitask", "CV", "--config", str(cfg)])]
    monkeypatch.setattr(multihost, "launch_local_workers", lambda n, argv: 7)
    with pytest.raises(SystemExit, match="exit code 7"):
        _entry.run_entry("multitask", "CV", ["--config", str(cfg)])


def test_a_failing_worker_stops_the_others():
    """``launch_local_workers``: rank 0 fails at once, rank 1 would sleep a
    minute; the launch returns rank 0's code within seconds, rank 1 ended."""
    code = ("import os, sys, time\n"
            "assert os.environ['WORLD_SIZE'] == '2' and os.environ['MASTER_ADDR']\n"
            "if os.environ['RANK'] == '0': sys.exit(5)\n"
            "time.sleep(60)\n")
    t0 = time.perf_counter()
    assert multihost.launch_local_workers(2, [sys.executable, "-c", code]) == 5
    assert time.perf_counter() - t0 < 30
    ok = "import os; assert os.environ['LOCAL_RANK'] == os.environ['RANK']"
    assert multihost.launch_local_workers(2, [sys.executable, "-c", ok]) == 0


def _artifacts(run: Path) -> dict:
    from test_torch_driver import _artifact_bytes
    return _artifact_bytes(run)


def test_driver_on_two_ranks_one_run_directory_and_resume(tmp_path):
    """Two ranks run ``training_multitask`` (``run_entry`` with the JAX-style
    flags, on the CPU): Multi_BTSUNet at width 4 on a 24-image 32² tree, CV
    2, 3 epochs, fast augmentation on (batch 4 over 2 ranks). One user-visible
    run directory with the artifact contract; rank 1's artifacts equal rank
    0's; killed at a checkpoint write and resumed on two ranks, the run
    continues in its directory and its checkpoints and CSVs equal the
    uninterrupted run's, byte for byte."""
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi
    from test_torch_driver import _resume_config

    root = make_preprocessed_busi(tmp_path / "busi", n_per_class=8, size=32)
    cfg = _resume_config(root, "multitask", "Multi_BTSUNet")
    cfg.training.data_parallel = True
    (tmp_path / "config.yaml").write_text(config_to_yaml(cfg))

    def run(name, crash_at=0, resume=None):
        argv = ["--config", str(tmp_path / "config.yaml"), "--run-root", str(tmp_path / name)]
        argv += ["--resume", str(resume)] if resume else []
        return run_ranks(2, "test_torch_multihost", "case_cli", tmp_path / f"{name}{crash_at}",
                         dict(argv=argv, crash_at=crash_at), init=False)

    whole = run("a")
    runs = [d for d in (tmp_path / "a").iterdir() if d.is_dir()]
    assert len(runs) == 1 and Path(whole[0]["run"]) == runs[0]
    assert Path(whole[1]["run"]).parent != tmp_path / "a"
    for n in (0, 1):
        m = pd.read_csv(runs[0] / f"fold_{n}" / "metrics.csv")
        assert len(m) == 3 and m.notna().all().all()
        assert (runs[0] / f"fold_{n}" / "results_segmentation.csv").exists()
        assert (runs[0] / f"fold_{n}" / "results_classification.csv").exists()
    a = _artifacts(runs[0])
    assert any(k.endswith("CKPT") for k in a)
    assert _artifacts(Path(whole[1]["run"])) == a
    assert "Parallelism over 2 ranks" in (runs[0] / "execution.log").read_text()

    assert all(r == {"killed": True} for r in run("b", crash_at=2))
    killed = [d for d in (tmp_path / "b").iterdir() if d.is_dir()]
    assert len(killed) == 1
    resumed = run("b", resume=killed[0])
    assert Path(resumed[0]["run"]) == killed[0]
    assert len([d for d in (tmp_path / "b").iterdir() if d.is_dir()]) == 1
    assert "resuming from epoch" in (killed[0] / "execution.log").read_text()
    assert _artifacts(killed[0]) == a
    assert _artifacts(Path(resumed[1]["run"])) == a


def test_checkpoint_backend_replicas_answer_as_one(tmp_path):
    """``CheckpointBackend`` with two injected CPU replicas: ``max_batch``
    rounds up to a multiple of the replicas, and the answer equals one
    replica's running the same per-replica batch, exactly (and one replica's
    running the whole bucket to 1e-5 of each output's scale: the CPU's
    convolutions sum in other orders at other batch sizes)."""
    import numpy as np

    from multi_task_breast_cancer_tpu_torch.config import Config, DataConfig, ModelConfig
    from multi_task_breast_cancer_tpu_torch.serve.server import CheckpointBackend
    from test_torch_parallel import _outputs_close

    cfg = Config(model=ModelConfig(architecture="MTnnUNet", nnunet_widths=[4, 8, 8, 16, 16]),
                 data=DataConfig(batch_size=2))

    def backend(**kw):
        return CheckpointBackend(cfg, "multitask", size=32, **kw)

    two = backend(max_batch=3, devices=["cpu", "cpu"])
    assert two.buckets == [4] and two.info["buckets"] == [4] and len(two.replicas) == 2
    assert two.replicas[0] is not two.replicas[1]
    images = (np.random.default_rng(0).random((7, 32, 32, 1)) * 255).astype(np.uint8)
    got = two.predict(images)
    one_shard = backend(max_batch=2, device="cpu")
    assert len(one_shard.replicas) == 1
    want = one_shard.predict(np.concatenate([images, images[4:5]]))  # the same shards

    def as_tensor(tree) -> list:
        if isinstance(tree, (tuple, list)):
            return [t for part in tree for t in as_tensor(part)]
        return [torch.from_numpy(tree)]

    for g, w in zip(as_tensor(got), as_tensor(want)):
        assert torch.equal(g, w[:7])
    for g, w in zip(as_tensor(got), as_tensor(backend(max_batch=4, device="cpu").predict(images))):
        _outputs_close(g, w)


@pytest.mark.parametrize("buckets", [(1, 8, 64), (1, 2, 4), (4,), (1, 16), (2, 32, 128)])
def test_exported_model_shards_when_jax_would(buckets):
    """``ExportedModel``'s data-parallel plan (which replica runs which rows
    in which bucket, or all serially) equals JAX's ``predict`` rule over a
    table of batch sizes and replica counts."""
    import numpy as np

    from multi_task_breast_cancer_tpu.serve.export import ExportedModel as JaxExportedModel
    from multi_task_breast_cancer_tpu_torch.serve.export import ExportedModel

    def plan(cls, devices_attr, n, ndev):
        model, calls = object.__new__(cls), []
        model.buckets = list(buckets)
        setattr(model, devices_attr, list(range(ndev)))
        model._dispatch = lambda part, bucket, dev=0: calls.append((len(part), bucket, dev))
        model._fetch = lambda dispatched: None
        model.predict(np.zeros((n, 1, 1, 1), np.uint8))
        return calls

    for ndev in (1, 2, 3, 4, 8):
        for n in (1, 2, 3, 5, 7, 8, 9, 16, 33, 64, 65, 100, 200, 300):
            want = plan(JaxExportedModel, "_devices", n, ndev)
            assert plan(ExportedModel, "devices", n, ndev) == want, (n, ndev)
