"""Energy-group grid construction.

Equivalent of the reference's group-grid setup
(reference: src/solver.cpp:6-43): log-spaced edges with the quirky
e_edge[0] = 0, e_edge[1] = efirst anchoring, or edges read from file;
group averages / widths; (G, 2) energy-discretization bound pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class GroupGrid(NamedTuple):
    e_edge: np.ndarray   # (G+1,) group edge energies, keV
    e_ave: np.ndarray    # (G,)   group average energies
    de_ave: np.ndarray   # (G,)   group widths
    edisc: np.ndarray    # (G, 2) [lower, upper] bounds per group


def generate_group_edges(G: int, efirst: float, elast: float) -> np.ndarray:
    """Log-spaced edges: e[0]=0, e[1]=efirst, e[g+1]=e[g]*logfac.

    For G == 1 the log factor is degenerate and unused; the grey group is
    [0, efirst] (reference: src/solver.cpp:6-19 — including the G=1
    behaviour where the loop body never runs).
    """
    e_edge = np.zeros(G + 1, dtype=np.float64)
    e_edge[1] = efirst
    if G > 1:
        logfac = np.exp((np.log(elast) - np.log(efirst)) / (G - 1.0))
        for g in range(1, G):
            e_edge[g + 1] = e_edge[g] * logfac
    return e_edge


def build_group_grid(
    G: int,
    efirst: float,
    elast: float,
    group_bounds: Optional[np.ndarray] = None,
) -> GroupGrid:
    if group_bounds is not None:
        e_edge = np.asarray(group_bounds, dtype=np.float64)
        assert e_edge.shape == (G + 1,)
    else:
        e_edge = generate_group_edges(G, efirst, elast)

    e_ave = 0.5 * (e_edge[:-1] + e_edge[1:])
    de_ave = e_edge[1:] - e_edge[:-1]
    edisc = np.stack([e_edge[:-1], e_edge[1:]], axis=1)
    return GroupGrid(e_edge=e_edge, e_ave=e_ave, de_ave=de_ave, edisc=edisc)
