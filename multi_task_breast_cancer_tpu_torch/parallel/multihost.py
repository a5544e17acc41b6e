"""Multi-process runs (twin of ``multi_task_breast_cancer_tpu/parallel/multihost.py``).

One process runs per GPU, on one host or several. Call :func:`initialize`
once at program start, before any device query:

    from multi_task_breast_cancer_tpu_torch.parallel import multihost
    multihost.initialize()        # False, no side effect, when nothing is set
    mesh = data_mesh()            # then spans every rank

The process group comes from explicit arguments (the training CLIs'
``--coordinator host:port --num-processes N --process-id I``) or, without
them, from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the GPU). Unlike the
JAX twin, a failed initialisation raises: carrying on as one process would
hide the other devices.
"""

from __future__ import annotations

import datetime
import logging
import os
import signal
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _check_address(address: str) -> None:
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not host:port")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> bool:
    """Join the default process group; returns True when one is active.

    With ``coordinator_address`` (``host:port``; process 0 listens there)
    ``num_processes`` and ``process_id`` are needed; without it, torchrun's
    environment is used if it is complete, and otherwise nothing happens and
    the result is False. ``backend`` defaults to NCCL when CUDA is available
    and Gloo otherwise. A failure (a bad address, a rendezvous that does not
    complete within ``timeout_s``) raises."""
    if active():
        return True
    if coordinator_address is None:
        if not all(k in os.environ for k in TORCHRUN_ENV):
            return False
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        _check_address(coordinator_address)
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process id {process_id} is outside 0..{num_processes - 1}")
        init_method = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":  # NCCL's own calls (a barrier) use the current device
        torch.cuda.set_device(local_rank_of(process_id))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logging.info("torch.distributed initialised: rank %d of %d (%s)", dist.get_rank(),
                 dist.get_world_size(), backend)
    return True


def active() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def process_index() -> int:
    return dist.get_rank() if active() else 0


def barrier() -> None:
    """Wait until every rank gets here."""
    dist.barrier()


def local_rank() -> int:
    """The GPU index of this rank on its host: ``LOCAL_RANK`` when set
    (torchrun, the training CLIs' own workers), else the rank modulo the
    visible GPUs."""
    return local_rank_of(process_index())


def local_rank_of(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def coordinator_run_root(run_root: str) -> str:
    """Artifact root for this process: process 0 keeps ``run_root``; every
    other process runs the whole driver too (it must join every collective)
    but writes its redundant artifacts to a scratch directory of its own,
    so that a shared filesystem holds one run directory."""
    if process_count() > 1 and process_index() != 0:
        scratch = tempfile.mkdtemp(prefix=f"mtbc_proc{process_index()}_artifacts_")
        logging.info("process %d: artifacts redirected to %s", process_index(), scratch)
        return scratch
    return run_root


def process_local_slice(n_global: int) -> slice:
    """The rows of a global batch of ``n_global`` owned by this process
    (equal shards; an uneven batch raises)."""
    count = process_count()
    if n_global % count:
        raise ValueError(
            f"global batch of {n_global} does not shard evenly over "
            f"{count} processes — trailing samples would silently be owned "
            f"by no process; pad or trim the batch to a multiple of {count}")
    per = n_global // count
    start = process_index() * per
    return slice(start, start + per)


def free_port() -> int:
    """A TCP port of this host that is free now (for a local rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_workers(n_workers: int, argv: Sequence[str],
                         env: Optional[dict] = None, poll_s: float = 0.2) -> int:
    """Run ``argv`` in ``n_workers`` processes with torchrun's environment
    for a rendezvous on this host (rank ``i`` on GPU ``i``); wait for all.
    If one exits with an error, the others are terminated. Returns 0 when
    every worker succeeded, else the first failing worker's code."""
    port = free_port()
    procs = []
    for i in range(n_workers):
        wenv = dict(os.environ if env is None else env, RANK=str(i), LOCAL_RANK=str(i),
                    WORLD_SIZE=str(n_workers), LOCAL_WORLD_SIZE=str(n_workers),
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(list(argv), env=wenv))
    code = 0
    try:
        while procs:
            for p in list(procs):
                rc = p.poll()
                if rc is None:
                    continue
                procs.remove(p)
                if rc != 0 and code == 0:
                    code = rc
                    logging.error("worker %d exited with %d; stopping the others",
                                  p.pid, rc)
                    for q in procs:
                        q.send_signal(signal.SIGTERM)
            time.sleep(poll_s)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return code
