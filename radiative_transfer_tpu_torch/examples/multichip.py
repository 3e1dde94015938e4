"""Example 3: a solve on a mesh of ranks, on the port.

Shards a gray-ish multigroup slab over the ranks of a torchrun environment
with the sharded fast engine (parallel/sharded_fast.ShardedFastEngine, in
float64) and checks it against a single-device FastEngine run; then runs
the f32 mesh route the port's own selection picks
(parallel.make_multichip_engine with ``auto``: the halo engine where its
creep bound admits the workload, else the fused engine at BDF2, else the
sharded engine) at f32 accuracy against the same reference.

    torchrun --nproc_per_node 2 -m \
        radiative_transfer_tpu_torch.examples.multichip [--device cuda|cpu]

Each rank runs on its own card where the host has one for each (NCCL),
else the ranks share the cards over gloo; one process alone is a
one-rank mesh.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import parallel
from ..config.config import Config
from ..models import transport
from ..ops.fast_sweep import FastEngine
from ..parallel import distributed
from ..parallel.mesh import make_mesh_1d, make_mesh_2d
from ..parallel.sharded_fast import ShardedFastEngine
from ._common import add_device, device_of


def parser() -> argparse.ArgumentParser:
    """The script's arguments and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args.device)

    info = distributed.initialize(device_type=dev.type)
    print("processes:", info)
    if dev.type == "cuda":
        dev = distributed.local_device("cuda")

    n_dev = distributed.process_count()
    cfg = Config(
        M=8, G=4, N=256 * max(n_dev, 1), X=float(max(n_dev, 1)),
        bc_left_indicator=2, bc_right_indicator=1,
        # use_mg_equilib replaces psi_source with the comoving-equilibrium
        # Planckian (+ Doppler term) at setup.
        use_correction=True, V=1.0, use_mg_equilib=True,
        ts_method=3, dt=1e-5, max_timesteps=20,
        include_validation=False,
    )
    tables, _, _ = transport.build_tables(cfg)

    if n_dev % 2 == 0 and n_dev > 2:
        mesh = make_mesh_2d(2, n_dev // 2)
    else:
        mesh = make_mesh_1d(n_dev)
    distributed.assert_mesh_spans_hosts(mesh)
    print(f"mesh: {dict(mesh.shape)} over {n_dev} ranks")

    seng = ShardedFastEngine(cfg, tables, mesh, dtype=torch.float64,
                             device=dev)
    sharded_ends = seng.ends(seng.solve()).cpu().numpy()

    eng = FastEngine(cfg, tables, dtype=torch.float64, device=dev)
    single_ends = eng.ends(eng.solve()).cpu().numpy()

    scale = np.abs(single_ends).max()
    err = float(np.abs(sharded_ends - single_ends).max() / scale)
    print(f"sharded vs single-device max rel diff: {err:.2e}")
    assert err < 1e-12, "sharded result diverged"
    print("multi-chip solve matches single-device")

    # The production f32 path on the mesh, as the port's selection routes
    # it (on the card and on the CPU alike). The f32 bar is the documented
    # drift class for correction-coupled multigroup decks
    # (docs/PERFORMANCE.md "f32 accuracy").
    peng = parallel.make_multichip_engine(cfg, tables, mesh, device=dev)
    pends = peng.ends(peng.solve()).to(torch.float64).cpu().numpy()
    perr = float(np.abs(pends - single_ends).max() / scale)
    print(f"{type(peng).__name__} (f32) vs f64 max rel diff: {perr:.2e}")
    assert perr < 2e-3, "f32 multi-chip engine diverged"
    print("f32 multi-chip engine matches at f32 accuracy")
    return {"rc": 0, "ranks": n_dev, "mesh": dict(mesh.shape),
            "backend": info["backend"], "err": err, "engine":
            type(peng).__name__, "f32_err": perr,
            "sharded_ends": sharded_ends, "single_ends": single_ends,
            "f32_ends": pends}


if __name__ == "__main__":
    rc = main()["rc"]
    distributed.shutdown()
    sys.exit(rc)
