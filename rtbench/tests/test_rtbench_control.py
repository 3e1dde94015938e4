"""The output check has to refuse what is wrong: the control (the reference
one precision below the cell's, in the program's place) fails the cell's
limits, and a run whose timed path is broken underneath reports
`correct: false`, for each fault the cell can have."""

from types import SimpleNamespace

import pytest
import torch

import calibrate
import harness
import run
from helpers import small_spec

CELLS = ["gray_s32.f32_bdf2", "llnl_124g.f64_bdf2", "gray_s32.grad_bdf2"]


def _passes(spec, numbers) -> bool:
    return all(r[3] for r in harness.judge(numbers, spec.limits["limits"]))


def _entry(spec, deck, seed, device="cpu"):
    ctx = run.build_context(spec, seed, device, deck=deck)
    return harness.entry_module(spec.traffic["entry"]).make(ctx)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails_at_a_small_size(cell):
    spec, deck = small_spec(cell, N=256, steps=8)
    entry = _entry(spec, deck, 11)
    res = entry.request(entry.make_input(0))
    assert _passes(spec, entry.check([(0, res)]))
    assert not _passes(spec, calibrate.control_numbers(spec, entry, 0))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_own_size(card, cell):
    spec = harness.cell_spec(cell)
    entry = _entry(spec, None, 0, device=card)
    for seed in (2**31 + 5, 2**31 + 77, 3 * 2**30 + 1):
        entry.ctx.seed = seed
        assert not _passes(spec, calibrate.control_numbers(spec, entry, 0))


# -- faults planted under a run ------------------------------------------------


def _unchanged_forward(entry):
    entry.engine.solve = lambda st, num_steps=None: st


def _half_batch_forward(entry):
    """The mu > 0 half of the directions left out: their edges come back
    as they went in."""
    eng, seen = entry.engine, {}
    from_ends, ends = eng.from_ends, eng.ends

    def keep(e, p, h):
        seen["in"] = e
        return from_ends(e, p, h)

    def half(st):
        out = ends(st).clone()
        Mh = out.shape[0] // 2
        out[Mh:] = seen["in"][Mh:].to(out.dtype)
        return out

    eng.from_ends, eng.ends = keep, half


def _altered_forward(entry):
    """phi altered by one part in a hundred at its largest cell, where
    result_from_ends produces it."""
    real = entry.transport.result_from_ends

    def altered(cfg, tables, ends):
        res = real(cfg, tables, ends)
        phi = res.phi.clone()
        flat = phi.view(-1)
        k = torch.argmax(flat.abs())
        flat[k] = flat[k] * 1.01
        return res._replace(phi=phi)

    entry.transport = SimpleNamespace(result_from_ends=altered)


def _unchanged_grad(entry):
    State = entry.State

    def same(params, state):
        e = state.ends.double() + 0.0 * params["kappa"].sum()
        return State(e, e, e)

    entry.solve_fn = same


def _half_batch_grad(entry):
    real, State = entry.solve_fn, entry.State

    def half(params, state):
        out = real(params, state)
        e = out.ends.clone()
        Mh = e.shape[0] // 2
        e[Mh:] = state.ends[Mh:].double()
        return State(e, out.prev_ends, out.half_ends)

    entry.solve_fn = half


def _altered_grad(entry):
    real = entry.request

    def altered(inp):
        out = real(inp)
        return dict(out, grad=out["grad"] * 1.01)

    entry.request = altered


FAULTS = {
    "gray_s32.f32_bdf2": [_unchanged_forward, _half_batch_forward,
                          _altered_forward],
    "llnl_124g.f64_bdf2": [_unchanged_forward, _half_batch_forward,
                           _altered_forward],
    "gray_s32.grad_bdf2": [_unchanged_grad, _half_batch_grad, _altered_grad],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    spec, deck = small_spec(cell, N=256, steps=8)
    result, rows = run.execute(spec, 2**31 + 3, 0.2, trace=False,
                               device="cpu", deck=deck, fault=fault)
    assert result["attempted"] > 0
    assert result["correct"] is False, rows


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    spec, deck = small_spec(cell, N=256, steps=8)
    result, rows = run.execute(spec, 2**31 + 3, 0.2, trace=False,
                               device="cpu", deck=deck)
    assert result["correct"] is True, rows
