"""Example 1: gray equilibrium slab — the GrayTest invariant, on the port.

Runs the shipped single-group deck (reflective left, equilibrium source
right, started from psi = B) on the general engine in float64 and checks
the radiative flux stays at zero: the reference's pass criterion
max F < 1e-6 after 1000 BDF2 steps (reference: tests/test_gray.cpp:89-98).

    python -m radiative_transfer_tpu_torch.examples.gray_equilibrium \
        [--steps N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import load_config
from ..models import transport
from ._common import add_device, deck, device_of


def parser() -> argparse.ArgumentParser:
    """The script's arguments and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args.device)

    cfg = load_config(deck("single_group.prm"), max_timesteps=args.steps)
    print(f"gray slab: M={cfg.M} G={cfg.G} N={cfg.N}, "
          f"{args.steps} BDF2 steps of dt={cfg.dt}")

    res = transport.run_problem(cfg, device=dev)
    F = res.F.cpu().numpy()
    max_elem = float(F.max())          # the reference criterion:
    max_abs = float(np.abs(F).max())   # F.maxCoeff() is the SIGNED max
    out = {"rc": 0, "max_element": max_elem, "max_abs": max_abs,
           "F": F, "phi": res.phi.cpu().numpy(), "steps": args.steps}
    if args.steps >= 1000:
        # The deck's source 4.0931 is acT^4 to 5 digits only, which
        # injects a small NEGATIVE flux (~ -8e-6); the reference's pass
        # criterion `F.maxCoeff() < 1e-6` (tests/test_gray.cpp:89) is on
        # the signed max element and tolerates it.
        print(f"max element of F = {max_elem:.3e}  (pass bar 1e-6, "
              f"reference tests/test_gray.cpp:89); max |F| = {max_abs:.3e}")
        print("equilibrium preserved" if max_elem < 1e-6 else "FAILED")
        out["rc"] = 0 if max_elem < 1e-6 else 1
        return out
    print(f"max element of F = {max_elem:.3e} after {args.steps} steps "
          f"(run >= 1000 steps for the 1e-6 criterion)")
    return out


if __name__ == "__main__":
    sys.exit(main()["rc"])
