"""Post-processing: plot the solver's CSV outputs.

Port of radiative_transfer_tpu/plot.py, the equivalent of the reference
plot scripts (reference: scripts/plot_results.py:42-115,
scripts/plot_gray_results.py:6-28) as a CLI: it takes the output
directory as an argument, saves every figure, and handles any (M, G, N).
It reads the 8 CSVs written by `radiative_transfer_tpu_torch.cli` /
`utils.io.write_solution_csvs` (the reference's own file layout:
whitespace-separated (G, N) matrices, one-per-line vectors, and the psi
matrix as M rows with columns interleaved n*G + g), and the JAX package's
CSVs, which its writers may name with a prefix (``--prefix``). The
reader is numpy only; matplotlib is imported when figures are drawn.

Usage:
    python -m radiative_transfer_tpu_torch.plot OUTDIR [--prefix P]
        [--save-dir DIR] [--show]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def read_solution(outdir: str, prefix: str = "") -> dict:
    """Load the CSV set into arrays keyed phi/phi_plus/psi/x/F/e_ave/
    left_ends/right_ends. psi is unpacked to (M, G, N)."""

    def p(name):
        return os.path.join(outdir, prefix + name + ".csv")

    def vec(name):
        return np.loadtxt(p(name), ndmin=1)

    def mat(name):
        return np.loadtxt(p(name), ndmin=2)

    out = {
        "x": vec("x"),
        "e_ave": vec("e_ave"),
        "left_ends": vec("left_ends"),
        "right_ends": vec("right_ends"),
        "phi": mat("phi"),
        "phi_plus": mat("phi_plus"),
        "F": mat("F"),
    }
    G, N = out["phi"].shape
    psi_rows = mat("psi")             # (M, N*G), columns ordered n*G + g
    M = psi_rows.shape[0]
    out["psi"] = psi_rows.reshape(M, N, G).transpose(0, 2, 1)  # (M, G, N)
    return out


def _per_group_lines(ax, x, arr, name):
    for g in range(arr.shape[0]):
        ax.plot(x, arr[g], label=f"{name}, g={g}", lw=1.2)
    if arr.shape[0] <= 12:
        ax.legend(fontsize=7)
    ax.set_xlabel("x (cm)")


def plot_solution(sol: dict, save_dir: str, show: bool = False) -> list:
    """The five standard figures: F, phi, phi_plus, psi, boundary spectra."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    x = sol["x"]
    made = []

    def save(fig, name):
        path = os.path.join(save_dir, name + ".png")
        fig.savefig(path, dpi=130, bbox_inches="tight")
        made.append(path)
        if show:
            plt.show()
        plt.close(fig)

    for key, title in (
        ("F", "Radiative flux F(x)"),
        ("phi", "Angle-integrated intensity phi(x)"),
        ("phi_plus", "Positive-direction intensity phi+(x)"),
    ):
        fig, ax = plt.subplots(figsize=(7, 4.5))
        _per_group_lines(ax, x, sol[key], key)
        ax.set_title(title)
        save(fig, key)

    M, G, _ = sol["psi"].shape
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for m in range(M):
        for g in range(G):
            ax.scatter(x, sol["psi"][m, g], s=6, label=f"psi m={m} g={g}")
    if M * G <= 16:
        ax.legend(fontsize=7)
    ax.set_xlabel("x (cm)")
    ax.set_title("Angular intensity psi(x) per (direction, group)")
    save(fig, "psi")

    # Boundary spectra vs group-average energy (loglog when multigroup).
    fig, ax = plt.subplots(figsize=(7, 4.5))
    plot = ax.loglog if G > 1 else ax.plot
    plot(sol["e_ave"], np.maximum(sol["left_ends"], 0), label="left ends")
    plot(sol["e_ave"], np.maximum(sol["right_ends"], 0), label="right ends")
    ax.set_xlabel("e_ave (keV)")
    ax.set_ylabel("boundary spectrum")
    ax.legend(fontsize=8)
    ax.set_title("Boundary edge spectra")
    save(fig, "ends")
    return made


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="radiative_transfer_tpu_torch.plot",
        description="Plot solver CSV outputs (F, phi, phi_plus, psi, ends)",
    )
    ap.add_argument("outdir", help="directory holding the solver CSVs")
    ap.add_argument("--prefix", default="", help="CSV filename prefix")
    ap.add_argument("--save-dir", default=None,
                    help="where to write PNGs (default: OUTDIR)")
    ap.add_argument("--show", action="store_true", help="also display")
    args = ap.parse_args(argv)

    sol = read_solution(args.outdir, args.prefix)
    made = plot_solution(sol, args.save_dir or args.outdir, show=args.show)
    for pth in made:
        print(pth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
