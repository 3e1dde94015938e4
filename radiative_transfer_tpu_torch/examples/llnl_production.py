"""Example 4: the production story on the real LLNL 124-group deck, on the
port.

Loads the reference's shipped multigroup deck (tabulated group bounds and
absorption opacities spanning 8 decades), widens it to a benchmark
resolution at a stable Courant number, and runs the production path:
shape-aware engine selection (parallel.make_multichip_engine: the f32
CUDA kernels), periodic exact checkpoints and a resume, the balance
diagnostics, and the end-of-run conservation identities.

    python -m radiative_transfer_tpu_torch.examples.llnl_production \
        [--device cuda|cpu]

On several ranks use the CLI instead:
    torchrun --nproc_per_node 2 -m radiative_transfer_tpu_torch.cli \
        prm/llnl_slab_test.prm --engine auto --mesh 1x2 --checkpoint-dir ck/
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from .. import constants, load_config, parallel
from ..models import transport
from ..utils import checkpoint as ckpt
from ._common import add_device, deck, device_of


def parser() -> argparse.ArgumentParser:
    """The script's arguments and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--N", type=int, default=1 << 10, help="cells")
    ap.add_argument("--steps", type=int, default=40,
                    help="timesteps (checkpointed every --every, killed "
                         "after half of them and resumed)")
    ap.add_argument("--every", type=int, default=10)
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args.device)

    C = constants.SPEED_OF_LIGHT
    N, steps = args.N, args.steps
    path = deck("llnl_slab_test.prm")
    cfg0 = load_config(path)
    # Courant-0.4 dt: the shipped dt=1e-3 exceeds the BDF2 stability
    # envelope at this resolution (docs/QUIRKS.md).
    cfg = load_config(path, N=N, max_timesteps=steps,
                      dt=0.4 * (cfg0.X / N) / C)
    print(f"LLNL deck: M={cfg.M} G={cfg.G} N={cfg.N} steps={steps}")

    tables, _, _ = transport.build_tables(cfg)
    eng = parallel.make_multichip_engine(cfg, tables, None, device=dev)
    print(f"auto-selected engine: {type(eng).__name__}")

    with tempfile.TemporaryDirectory() as ckdir:
        # The first half with a checkpoint every --every steps...
        st, resumed = ckpt.solve_with_checkpoints_engine(
            eng, cfg, ckdir, every=args.every, num_steps=steps // 2)
        assert resumed == 0
        # ... then "crash" and resume for the rest (exact restart: the
        # trajectory equals an uninterrupted run bit for bit).
        st, resumed = ckpt.solve_with_checkpoints_engine(
            eng, cfg, ckdir, every=args.every)
        print(f"resumed from checkpointed step {resumed}")

    ends = eng.ends(st).to(torch.float64)
    result = transport.result_from_ends(cfg, tables, ends)
    bal = result.balance.cpu().numpy()
    print(f"per-group balance: max={bal.max():.3e} mean={bal.mean():.3e}")

    # Spot conservation: the group Planck integrals sum to the grey
    # integral a*c*T^4 (the reference's own validation identities,
    # src/correction.cpp:39-122).
    B = np.asarray(tables.B, dtype=np.float64)
    acT4 = constants.AC * cfg.T ** 4
    b_err = abs(B.sum() - acT4)
    print(f"|sum B_g - acT^4| = {b_err:.2e} (tol 1e-6)")
    assert b_err < 1e-6
    phi = result.phi.cpu().numpy()
    assert np.isfinite(phi).all()
    print("ok")
    return {"rc": 0, "engine": type(eng).__name__, "resumed": resumed,
            "balance": bal, "B_sum_err": b_err, "ends": ends.cpu().numpy()}


if __name__ == "__main__":
    sys.exit(main()["rc"])
