"""Multi-process launch helpers on torch.distributed.

Port of radiative_transfer_tpu/parallel/distributed.py. Every process runs
the same program on its own shard of the mesh (parallel/mesh.py), as
under ``torchrun --nproc_per_node P``, which sets RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT:

    from radiative_transfer_tpu_torch.parallel import distributed, mesh
    distributed.initialize()                  # env-driven (torchrun)
    m = mesh.make_mesh_2d(n_group, n_spatial)
    eng = make_multichip_engine(cfg, tables, m, engine="pallas",
                                device=distributed.local_device("cuda"))

The backend is chosen explicitly and printed, never by a silent fallback:
NCCL when every rank of a host has a card of its own, gloo on the CPU and
when ranks share a card (NCCL refuses two ranks on one device). On gloo
the mesh collectives stage CUDA payloads through host memory; the kernels
still run on the card in every rank.

Failure policy: fail fast. Explicit coordinator arguments that cannot be
reached raise; only a process with no launcher environment at all runs
alone (a no-op initialize).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def choose_backend(device_type: str, local_world: int) -> tuple:
    """(backend, reason) for ranks whose tensors live on `device_type`,
    `local_world` ranks on this host."""
    if device_type != "cuda":
        return "gloo", "CPU tensors"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s) on {cards} card(s), one each"
    return "gloo", (f"{local_world} ranks share {cards} card(s): NCCL "
                    "refuses two ranks on one device, so payloads are "
                    "staged through host memory")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device_type: str = "cuda",
               timeout_s: float = 300.0) -> dict:
    """Join the process group (no-op if already joined, or if this is a
    single process with no launcher environment).

    `coordinator_address` ("host:port"), `num_processes` and `process_id`
    name the group explicitly; otherwise torchrun's environment does. A
    group that cannot be formed raises. choose_backend(device_type, ranks
    on this host) picks the backend, and the choice is printed: ranks
    whose tensors live on the card (the default) get NCCL where each has
    a card of its own; pass device_type="cpu" for CPU tensors. Returns
    {process_index, process_count, backend}."""
    explicit = coordinator_address is not None
    if not dist.is_initialized():
        if explicit or all(k in os.environ for k in _ENV):
            if explicit:
                init = f"tcp://{coordinator_address}"
                world, rank = int(num_processes), int(process_id)
                local = world
            else:
                init = "env://"
                world = int(os.environ["WORLD_SIZE"])
                rank = int(os.environ["RANK"])
                local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            backend, reason = choose_backend(device_type, local)
            print(f"distributed: backend {backend} ({reason}); rank {rank} "
                  f"of {world}", flush=True)
            dist.init_process_group(
                backend=backend, init_method=init, world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return {"process_index": process_index(),
            "process_count": process_count(),
            "backend": dist.get_backend() if dist.is_initialized() else None}


def shutdown() -> None:
    """Leave the process group (a no-op outside one): a barrier, so that
    no rank exits while another still talks to it, then the group's
    teardown. A gloo rank that exits with its group still up can abort in
    the group's teardown at interpreter exit."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: its LOCAL_RANK's card (several ranks of a host
    share a card when there are fewer cards), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def host_array(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global array of a rank-local shard, on every rank: the shard's
    last axis (cells) concatenated over the spatial axis 'x', then its
    second-to-last (rows) over the group axis 'g' where the mesh has
    one."""
    if mesh is None:
        return x
    out = torch.cat(tuple(mesh.all_gather(x, "x")), dim=-1)
    if "g" in mesh.shape:
        out = torch.cat(tuple(mesh.all_gather(out, "g")), dim=-2)
    return out


def assert_mesh_spans_hosts(mesh) -> None:
    """Every process must own a shard: a mesh of fewer ranks than the
    processes running would solve a different, smaller problem on each."""
    assert mesh.size == process_count(), (
        f"mesh of {mesh.size} ranks but {process_count()} processes are "
        "running")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_local(argv: Sequence[str], nprocs: int, env: Optional[dict] = None,
                 timeout: Optional[float] = None, cwd: Optional[str] = None
                 ) -> List[subprocess.CompletedProcess]:
    """Run `nprocs` ranks of ``python argv...`` on this host with the
    environment torchrun --nproc_per_node gives them (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR=127.0.0.1, a free
    MASTER_PORT), all started together; waits for every one (killing them
    all at `timeout`) and returns their results, rank order. torchrun does
    the same from the command line; this is its in-program form, which
    the tests and chip_smoke.py (which imports nothing from tests/) use to
    start their ranks."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    procs, files = [], []
    try:
        for rank in range(nprocs):
            renv = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
            # Files, not pipes: a rank blocked on a full pipe would stall
            # the collectives of the others.
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], env=renv,
                                          cwd=cwd, stdout=out, stderr=err))
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for proc, (out, err) in zip(procs, files):
        text = []
        for f in (out, err):
            f.seek(0)
            text.append(f.read().decode(errors="replace"))
            f.close()
        results.append(subprocess.CompletedProcess(proc.args,
                                                   proc.returncode, *text))
    return results
