"""Example 6: uncertainty propagation through ensemble solves, on the port.

The serial C++ reference runs one deck per process; propagating opacity
uncertainty through it means scripting N independent runs. Here the whole
Monte-Carlo ensemble is one batched program (ensemble.solve_ensemble,
``torch.func.vmap`` over the differentiable solve).

Scenario: the group opacities carry log-normal uncertainty. Draw K
samples, propagate each through the full implicit transport solve, and
report the induced spread of the exit flux. Then cross-check the
Monte-Carlo spread against the linearised (first-order adjoint) estimate
sigma_lin = |J sigma_kappa|, J the exact gradient of the observable
(``torch.func.grad`` through adjoint.make_diff_solve): agreement at small
input noise validates both paths against each other.

    python -m radiative_transfer_tpu_torch.examples.uncertainty \
        [--samples 32] [--sigma 0.1] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import adjoint, ensemble
from ..models import transport
from ._common import add_device, device_of
from .inverse_opacity import example_config


def parser() -> argparse.ArgumentParser:
    """The script's arguments and defaults, and --device."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--steps", type=int, default=8, help="timesteps per solve")
    ap.add_argument("--sigma", type=float, default=0.1,
                    help="relative (log-normal) opacity uncertainty")
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
    k_nom = np.asarray(tables.kappa)

    # Monte-Carlo ensemble: K log-normal opacity samples, one program.
    rng = np.random.default_rng(11)
    K = args.samples
    kappas = k_nom * np.exp(args.sigma * rng.standard_normal((K, G)))
    final = ensemble.solve_ensemble(
        cfg, tables, {"kappa": kappas}, num_steps=args.steps, state=state0,
        device=dev)
    phi = ensemble.observe_phi(cfg, tables, final).cpu().numpy()  # (K,G,N)

    # Observable: group-summed exit flux at the right face.
    q = phi[:, :, -1].sum(axis=1)                                  # (K,)
    q_mean, q_std = float(q.mean()), float(q.std(ddof=1))

    # Linearised cross-check: sigma_lin^2 = sum_g (dq/dk_g * sd_g)^2.
    solve_fn = adjoint.make_diff_solve(cfg, tables, num_steps=args.steps,
                                       device=dev)

    def observable(kappa):
        f = solve_fn({"kappa": kappa}, state0)
        p = transport.compute_phi(transport.psi_from_ends(f.ends), wt)
        return torch.sum(p[:, -1])

    k0 = torch.as_tensor(k_nom, dtype=torch.float64)
    grad = torch.func.grad(observable)(k0).cpu().numpy()
    with torch.no_grad():
        q_nom = float(observable(k0))
    sd_k = k_nom * np.sqrt(np.exp(args.sigma**2) - 1.0)  # log-normal sd
    q_std_lin = float(np.sqrt(np.sum((grad * sd_k) ** 2)))

    print(f"ensemble: K={K} members, {args.steps} BDF2 steps each, "
          f"one batched program")
    print(f"exit flux  nominal      : {q_nom:.6e}")
    print(f"exit flux  MC mean      : {q_mean:.6e}")
    print(f"exit flux  MC std       : {q_std:.3e}")
    print(f"exit flux  linearised sd: {q_std_lin:.3e}  (adjoint x input sd)")
    ratio = q_std / q_std_lin
    print(f"MC / linearised ratio   : {ratio:.3f}")
    # With ~10% input noise the delta method should agree to the MC
    # sampling error (~1/sqrt(2K) relative on the std itself).
    tol = 4.0 / np.sqrt(2 * K) + 0.15
    passed = abs(ratio - 1.0) < tol
    if passed:
        print("PASS: Monte-Carlo spread matches the adjoint linearisation")
    else:
        print("NOTE: disagreement beyond tolerance — raise --samples "
              "or lower --sigma")
    return {"rc": 0, "passed": passed, "ratio": ratio, "tol": float(tol),
            "q": q, "q_nom": q_nom, "q_std": q_std, "q_std_lin": q_std_lin,
            "grad": grad}


if __name__ == "__main__":
    sys.exit(main()["rc"])
