"""Example 5: inverse opacity estimation through the exact discrete
adjoint, on the port.

Because the solve is a PyTorch program, autograd differentiates through
the full implicit time integration — every BE/CN/BDF2 sweep, the
relativistic correction tables, the boundary coupling — giving exact
gradients of any observable with respect to the group opacities.

Scenario: a "measured" flux profile was produced by an unknown opacity
spectrum. Starting from the nominal kappas, recover the true spectrum by
gradient descent on the profile mismatch (adjoint.fit_params, Adam, on
the general engine in float64).

    python -m radiative_transfer_tpu_torch.examples.inverse_opacity \
        [--groups 8] [--iters 400] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import adjoint
from ..config.config import Config
from ..models import transport
from ._common import add_device, device_of


def example_config(G: int, steps: int) -> Config:
    """The examples' small multigroup slab (inverse_opacity, uncertainty)."""
    return Config(
        M=4, G=G, N=64, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(
            tuple(0.02 + 0.005 * g for g in range(G)) for _ in range(4)
        ),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.001,
        use_correction=True, ts_method=3, dt=5e-5,
        max_timesteps=steps, include_validation=False,
    )


def parser() -> argparse.ArgumentParser:
    """The script's arguments and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6, help="timesteps per solve")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.05)
    add_device(ap)
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = device_of(args.device)

    G = args.groups
    cfg = example_config(G, args.steps)
    tables, _, _ = transport.build_tables(cfg)
    state0 = transport.initial_state(cfg, tables)
    wt = torch.as_tensor(np.asarray(tables.wt), device=dev)

    # Synthesize the "measured" data from a hidden opacity spectrum.
    rng = np.random.default_rng(7)
    k_true = np.asarray(tables.kappa) * rng.uniform(0.6, 1.6, size=G)
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=args.steps,
                                       device=dev)
    with torch.no_grad():
        phi_target = transport.compute_phi(transport.psi_from_ends(
            solve_fn({"kappa": k_true}, state0).ends), wt)

    def loss_of_state(final, params):
        phi = transport.compute_phi(transport.psi_from_ends(final.ends), wt)
        return torch.mean((phi / phi_target - 1.0) ** 2)

    params0 = {"kappa": np.asarray(tables.kappa)}
    params, hist = adjoint.fit_params(
        cfg, tables, state0, loss_of_state, params0,
        num_steps=args.steps, learning_rate=args.lr, iterations=args.iters,
        device=dev)

    k_fit = params["kappa"].numpy()
    print(f"loss: {hist[0]:.3e} -> {hist[-1]:.3e} "
          f"({args.iters} Adam iterations)")
    print(f"{'g':>3} {'true':>10} {'recovered':>10} {'rel err':>9}")
    for g in range(G):
        rel = abs(k_fit[g] - k_true[g]) / k_true[g]
        print(f"{g:>3} {k_true[g]:>10.5f} {k_fit[g]:>10.5f} {rel:>9.2e}")
    worst = float(np.max(np.abs(k_fit / k_true - 1.0)))
    print(f"worst relative error: {worst:.2e}")
    passed = worst < 0.05
    if passed:
        print("PASS: opacity spectrum recovered within 5%")
    else:
        print("NOTE: not converged — raise --iters")
    return {"rc": 0, "passed": passed, "worst": worst, "loss": hist,
            "kappa_fit": k_fit, "kappa_true": k_true}


if __name__ == "__main__":
    sys.exit(main()["rc"])
