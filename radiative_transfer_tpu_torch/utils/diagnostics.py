"""Structured diagnostics: the reference's console tables as data + text.

Port of radiative_transfer_tpu/utils/diagnostics.py (numpy only; its
output is byte-identical to the JAX package's). The reference scatters
its observability across cout blocks: the input echo (reference:
src/ParameterHandler.cpp:20-96), the quadrature table
(src/solver.cpp:80-87), the energy-group table (src/solver.cpp:107-122),
the per-group balance print (src/solver.cpp:275-282) and the
Correction::Print() mega-dump of every physics table
(src/correction.cpp:404-603). Here each is a function returning the rows
as plain data, with a shared text renderer, so the same diagnostics can
be printed, logged, or written to CSV.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Table = Tuple[List[str], List[List]]  # (header, rows)


def render_table(table: Table, width: int = 16) -> str:
    header, rows = table

    def fmt(v):
        if isinstance(v, float) or isinstance(v, np.floating):
            return f"{v:.10g}"
        return str(v)

    lines = [
        "".join(f"{h:<{width}}" for h in header),
        "".join(f"{'-' * len(h):<{width}}" for h in header),
    ]
    for row in rows:
        lines.append("".join(f"{fmt(v):<{width}}" for v in row))
    return "\n".join(lines)


def quadrature_table(mu: Sequence[float], wt: Sequence[float]) -> Table:
    """The S_N direction set (src/solver.cpp:80-87)."""
    rows = [[float(m), float(w)] for m, w in zip(np.asarray(mu), np.asarray(wt))]
    return (["Mu", "Wt"], rows)


def group_table(e_ave, e_edge, de_ave) -> Table:
    """Energy-group grid (src/solver.cpp:107-122): per group the average
    energy, upper edge, and width, in keV."""
    e_ave, e_edge, de_ave = map(np.asarray, (e_ave, e_edge, de_ave))
    rows = [
        [g, float(e_ave[g]), float(e_edge[g + 1]), float(de_ave[g])]
        for g in range(e_ave.shape[0])
    ]
    return (
        ["Group", "AvgEnergy(keV)", "UpperEnergy(keV)", "Width(keV)"],
        rows,
    )


def planck_table(edisc, B, dBdT) -> Table:
    """Group Planck integrals (src/correction.cpp:433-455)."""
    edisc, B, dBdT = map(np.asarray, (edisc, B, dBdT))
    rows = [
        [g, float(edisc[g, 0]), float(edisc[g, 1]), float(B[g]), float(dBdT[g])]
        for g in range(B.shape[0])
    ]
    return (
        ["Group", "EGMin(keV)", "EGMax(keV)", "B(jk/cm2-sh)", "dBdT(jk/cm2-sh-keV)"],
        rows,
    )


def correction_components_table(ct) -> Table:
    """The correction-source component tables of Correction::Print()
    (src/correction.cpp:457-603): edge opacities and the energy-derivative
    terms feeding cor1/2/3."""
    G = ct.B.shape[0]
    rows = [
        [
            g,
            float(ct.kappa_edge[g]),
            float(ct.kappa_edge[g + 1]),
            float(ct.dEB[g]),
            float(ct.dsigEdE[g]),
            float(ct.dkapEB[g]),
            float(ct.cor1[g]),
            float(ct.cor2[g]),
            float(ct.cor3[g]),
        ]
        for g in range(G)
    ]
    return (
        ["Group", "KapEdgeLo", "KapEdgeHi", "dEB", "dsigEdE", "dkapEB",
         "cor1", "cor2", "cor3"],
        rows,
    )


def balance_table(balance, sources=None, sinks=None) -> Table:
    """Per-group energy balance (src/solver.cpp:275-282)."""
    balance = np.asarray(balance)
    header = ["Group", "Balance"]
    if sources is not None:
        header += ["Sources", "Sinks"]
    rows = []
    for g in range(balance.shape[0]):
        row = [g, float(balance[g])]
        if sources is not None:
            row += [float(np.asarray(sources)[g]), float(np.asarray(sinks)[g])]
        rows.append(row)
    return (header, rows)


def full_report(cfg, tables, grid, ct) -> str:
    """The Correction::Print() equivalent: every physics table at once."""
    parts = [
        "========== physics tables ==========",
        f"T = {cfg.T} keV   kappa_grey = {cfg.kappa_grey} cm^2/g   "
        f"G = {cfg.G}   M = {cfg.M}   V = {cfg.V} cm/sh",
        "",
        "-- quadrature --",
        render_table(quadrature_table(tables.mu, tables.wt)),
        "",
        "-- energy groups --",
        render_table(group_table(grid.e_ave, grid.e_edge, grid.de_ave)),
        "",
        "-- Planck integrals --",
        render_table(planck_table(grid.edisc, ct.B, ct.dBdT)),
        "",
        "-- correction components --",
        render_table(correction_components_table(ct)),
    ]
    return "\n".join(parts)


def write_tables_csv(outdir: str, cfg, tables, grid, ct) -> list:
    """Dump each physics table as a CSV for offline inspection."""
    import csv
    import os

    os.makedirs(outdir, exist_ok=True)
    named = {
        "quadrature": quadrature_table(tables.mu, tables.wt),
        "groups": group_table(grid.e_ave, grid.e_edge, grid.de_ave),
        "planck": planck_table(grid.edisc, ct.B, ct.dBdT),
        "correction": correction_components_table(ct),
    }
    paths = []
    for name, (header, rows) in named.items():
        path = os.path.join(outdir, f"table_{name}.csv")
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(header)
            w.writerows(rows)
        paths.append(path)
    return paths
