"""Small decks of the benchmark's cells, for runs on the CPU."""

import copy

import harness
from reference import rtref


def small_spec(cell: str, N: int = 256, steps: int = 4):
    """The cell's spec with N cells (dt kept at the configuration's cell
    Courant number) and `steps` a request."""
    spec = harness.cell_spec(cell)
    spec = copy.copy(spec)
    deck = dict(spec.config["deck"])
    courant = deck["dt"] * rtref.SPEED_OF_LIGHT / rtref.dx_of(deck)
    deck["N"] = N
    deck["dt"] = rtref.courant_dt(deck, courant)
    spec.traffic = dict(spec.traffic, steps=steps)
    spec.config = dict(spec.config, deck=deck, mesh=None)
    return spec, deck
