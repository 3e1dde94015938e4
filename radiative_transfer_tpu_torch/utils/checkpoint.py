"""Checkpoint / resume for the transport solve.

Port of radiative_transfer_tpu/utils/checkpoint.py, in the same file
format, so a checkpoint crosses between the two packages both ways.

The reference has no checkpointing, only end-of-run CSV dumps
(reference: src/main.cc:117-133); a long multigroup run that dies must
restart from t=0. Here the full step state {ends, prev_ends, half_ends}
plus the step index is periodically written as a compressed .npz
(`ckpt_%09d.npz`: float64 (M, G, N, 2) arrays, a bit-exact round trip),
so any run can resume. It is deflated at level 1, not at
np.savez_compressed's default: one host core's deflate is a save's whole
cost, and level 1 costs a fraction of it for a few percent more bytes.

Exactness across the BDF2 sub-cycle: every engine runs all 4 BDF2 phases
(BE/CN/BE/BDF of dt/2) inside one full-timestep transition
(models/transport.py _step_from; the kernels' K-step launches), so a
checkpoint at a full-step boundary captures the complete integrator
history: no separate `_it % 4` phase needs saving (the reference's
sub-step counter, src/solver.cpp:620-625, is internal to a step).

A config fingerprint (every field that affects the trajectory) is stored
and verified on load; resuming with a different problem is an error.

On a mesh every rank runs the same chunk loop: the engines' `ends` and
`prev_half_ends` hooks gather the global arrays on every rank
(parallel/distributed.host_array), only rank 0 writes, and a barrier
holds every rank until the file is renamed into place.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config.config import Config
from ..models.transport import State

_CKPT_RE = re.compile(r"ckpt_(\d{9})\.npz$")

# Fields excluded from the trajectory fingerprint: they do not change the
# step function (max_timesteps is a stopping criterion; validation is a
# setup-time assert).
_NON_TRAJECTORY_FIELDS = ("max_timesteps", "include_validation")


def config_fingerprint(cfg: Config) -> str:
    d = dataclasses.asdict(cfg)
    for k in _NON_TRAJECTORY_FIELDS:
        d.pop(k, None)
    return json.dumps(d, sort_keys=True)


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:09d}.npz")


def _host(x) -> np.ndarray:
    """A global state array as float64 numpy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _multi() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _barrier() -> None:
    """Cross-process sync (no-op single-process): a checkpoint write must
    complete before any process can race ahead (or exit, tearing down the
    process group under the writer)."""
    if _multi():
        dist.barrier()


def _assert_same_start(start: int) -> None:
    """Multi-process resume guard: rank 0 alone writes checkpoints, so
    ckpt_dir MUST be a filesystem every rank shares; if it is not, ranks
    find different newest checkpoints and would run different chunk
    counts into mismatched collectives (a silent hang). Gather the
    resumed step and fail fast with guidance instead. NCCL gathers CUDA
    tensors, gloo CPU ones."""
    if not _multi():
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.tensor([start], dtype=torch.int64, device=dev)
    outs = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, mine)
    starts = torch.cat(outs).cpu().numpy()
    if not (starts == starts[0]).all():
        raise RuntimeError(
            f"processes resumed from different checkpoint steps "
            f"{starts.tolist()} — the checkpoint directory must be a "
            "filesystem shared by every process (process 0 is the only "
            "writer)")


def _savez_level1(fh, **arrays) -> None:
    """np.savez_compressed's file (a zip of deflated .npy members, which
    np.load and the JAX package read) at deflate level 1 (module doc)."""
    with zipfile.ZipFile(fh, "w", compression=zipfile.ZIP_DEFLATED,
                         compresslevel=1) as zf:
        for name, x in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(x),
                                          allow_pickle=False)


def save_checkpoint(ckpt_dir: str, state: State, step: int,
                    cfg: Config) -> str:
    """Write the global state at full-step `step`. Atomic (write +
    rename). Every rank calls it with the same global arrays; only rank 0
    touches the filesystem (a shared checkpoint directory must not see
    concurrent writers), and a barrier holds every rank until the file is
    in place."""
    path = checkpoint_path(ckpt_dir, step)
    if not dist.is_initialized() or dist.get_rank() == 0:
        host = [_host(x) for x in state]
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            _savez_level1(
                fh,
                ends=host[0],
                prev_ends=host[1],
                half_ends=host[2],
                step=np.int64(step),
                fingerprint=np.frombuffer(
                    config_fingerprint(cfg).encode(), dtype=np.uint8
                ),
            )
        os.replace(tmp, path)
    _barrier()
    return path


def load_checkpoint(path: str,
                    cfg: Optional[Config] = None) -> Tuple[State, int]:
    """Load (state, step); the state's leaves are float64 CPU tensors. If
    `cfg` is given, the stored fingerprint must match, guarding against
    resuming a different problem."""
    with np.load(path) as z:
        if cfg is not None:
            stored = bytes(z["fingerprint"]).decode()
            want = config_fingerprint(cfg)
            if stored != want:
                raise ValueError(
                    f"checkpoint {path} was written for a different problem:\n"
                    f"  stored : {stored}\n  current: {want}"
                )
        state = State(*(torch.from_numpy(z[k]) for k in
                        ("ends", "prev_ends", "half_ends")))
        step = int(z["step"])
    return state, step


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-step checkpoint in `ckpt_dir`, or None."""
    best, best_step = None, -1
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz")):
        m = _CKPT_RE.search(p)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


def _resume(ckpt_dir: str, cfg: Config, resume: bool, check_fn):
    """(state or None, start step) from the newest checkpoint; the
    resumed ends checked before anything runs."""
    state, start = None, 0
    if resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:
            state, start = load_checkpoint(latest, cfg)
            if check_fn is not None:
                check_fn(state.ends, start)
        _assert_same_start(start)
    return state, start


def solve_with_checkpoints(
    cfg: Config,
    tables,
    state: State,
    ckpt_dir: str,
    every: int,
    resume: bool = True,
    num_steps: Optional[int] = None,
    check_fn=None,
    solve_fn=None,
    dtype=torch.float64,
    device="cuda",
) -> Tuple[State, int]:
    """Run the general engine in chunks of `every` steps, checkpointing
    after each chunk; on entry, resume from the newest valid checkpoint
    if present. `check_fn(ends, step)` (utils/debug.make_ends_checker)
    runs after each chunk INCLUDING the resumed state, before anything is
    written: a failing check aborts without committing a poisoned
    checkpoint. The default chunk runner is transport.solve at `dtype` on
    `device`; `solve_fn(state, n) -> state` overrides it (e.g.
    parallel.sharded.solve_sharded bound to a mesh).

    Returns (final_state, start_step_resumed_from). The trajectory is
    bit-identical to an uninterrupted solve: chunking the step loop at
    full-step boundaries changes no computation.
    """
    from ..models import transport

    total = cfg.max_timesteps if num_steps is None else num_steps
    loaded, start = _resume(ckpt_dir, cfg, resume, check_fn)
    if loaded is not None:
        state = loaded
    if solve_fn is None:
        def solve_fn(s: State, n: int) -> State:
            return transport.solve(cfg, tables, s, num_steps=n, dtype=dtype,
                                   device=device)

    done = start
    while done < total:
        n = min(every, total - done)
        state = solve_fn(state, n)
        done += n
        if check_fn is not None:
            check_fn(state.ends, done)
        save_checkpoint(ckpt_dir, state, done, cfg)
    return state, start


def solve_with_checkpoints_engine(
    eng,
    cfg: Config,
    ckpt_dir: str,
    every: int,
    resume: bool = True,
    num_steps: Optional[int] = None,
    check_fn=None,
):
    """Checkpointed solve for the kernel engines and the mesh engines
    (any engine exposing init_state/solve/from_ends and the ends +
    prev_half_ends materialisers: CudaSweepEngine, DFCudaEngine, the halo,
    sharded and fused-exchange engines). Checkpoints store the same
    portable global (M, G, N, 2) float64 arrays as the general engine:
    the engine layout is converted at chunk boundaries, so a run
    checkpointed by one engine can resume under another (or under the
    general solver).

    The float32 engines' planes round-trip exactly through the float64
    container; the double-float engines' (hi, lo) pairs are summed into
    it and split again on resume (cuda_df.DFLayout.from_ends), which
    costs at most the double-float representation error. Returns
    (final engine state, start step resumed from).
    """
    total = cfg.max_timesteps if num_steps is None else num_steps

    def global_state(state) -> State:
        prev, half = eng.prev_half_ends(state)
        return State(eng.ends(state), prev, half)

    loaded, start = _resume(ckpt_dir, cfg, resume, check_fn)
    state = (eng.init_state() if loaded is None
             else eng.from_ends(*loaded))

    done = start
    while done < total:
        n = min(every, total - done)
        state = eng.solve(state, num_steps=n)
        done += n
        gstate = global_state(state)
        if check_fn is not None:
            check_fn(gstate.ends, done)
        save_checkpoint(ckpt_dir, gstate, done, cfg)
    return state, start
