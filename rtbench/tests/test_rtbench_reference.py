"""The frozen plain reference against the program's CPU path at a tiny N, on
both decks: its tables, its steps and what a solve reports."""

import numpy as np
import pytest
import torch

import harness
from helpers import small_spec
from reference import rtref


@pytest.mark.parametrize("cell", ["gray_s32.f32_bdf2", "llnl_124g.f64_bdf2"])
def test_tables_match_the_program(cell):
    from radiative_transfer_tpu_torch.models import transport

    _, deck = small_spec(cell, N=64)
    mine = rtref.build_tables(deck)
    theirs = transport.build_tables(harness.make_config(deck))[0]
    for field in rtref.Tables._fields:
        np.testing.assert_allclose(getattr(mine, field),
                                   getattr(theirs, field), rtol=1e-14,
                                   atol=0, err_msg=field)


@pytest.mark.parametrize("cell,N", [("gray_s32.f32_bdf2", 512),
                                    ("llnl_124g.f64_bdf2", 128)])
def test_steps_and_results_match_the_general_engine(cell, N):
    """From one seeded off-equilibrium state, 6 BDF2 steps of the
    reference and of the program's general engine (float64, CPU) agree to
    roundoff, and so do phi and the balance."""
    from radiative_transfer_tpu_torch.models import transport

    _, deck = small_spec(cell, N=N)
    cfg = harness.make_config(deck)
    tables = transport.build_tables(cfg)[0]
    g = torch.Generator().manual_seed(5)
    B = torch.as_tensor(np.asarray(tables.B))
    ends0 = B[None, :, None, None] * (0.5 + torch.rand(
        (cfg.M, cfg.G, cfg.N, 2), generator=g, dtype=torch.float64))
    st = transport.solve(cfg, tables, transport.State(ends0, ends0, ends0),
                         6, device="cpu")
    res = transport.result_from_ends(cfg, tables, st.ends)
    rt = rtref.build_tables(deck)
    ends = rtref.Stepper(deck, rt).solve(ends0, 6)
    assert rtref.nerr(ends, st.ends) < 1e-12
    phi, bal = rtref.phi_and_balance(deck, rt, ends)
    assert rtref.nerr(phi, res.phi) < 1e-12
    np.testing.assert_allclose(bal.numpy(), res.balance.numpy(), rtol=1e-9,
                               atol=1e-13)


@pytest.mark.parametrize("cell", ["gray_s32.f32_bdf2", "llnl_124g.f64_bdf2"])
def test_reference_against_the_timed_engines_on_the_cpu(cell):
    """The cell's own engine selection (its plain versions on the CPU):
    f32 to f32 roundoff, the double-float engine to f64 roundoff."""
    spec, deck = small_spec(cell, N=256, steps=8)
    import run

    ctx = run.build_context(spec, 99, "cpu", deck=deck)
    entry = harness.entry_module(spec.traffic["entry"]).make(ctx)
    res = entry.request(entry.make_input(3))
    numbers = entry.check([(3, res)])
    tol = 1e-5 if spec.traffic["dtype"] == "float32" else 1e-11
    assert numbers["phi_rel"] < tol and numbers["balance_abs"] < tol


def test_gradient_reference_matches_autograd():
    """The reference's difference quotient in kappa agrees with autograd
    through the same plain steps."""
    spec, deck = small_spec("gray_s32.grad_bdf2", N=64, steps=4)
    import run

    ctx = run.build_context(spec, 3, "cpu", deck=deck)
    entry = harness.entry_module("grad").make(ctx)
    ref = entry.reference(0, torch.float64)
    ends, target = entry.make_input(0)
    kappa = torch.tensor(entry.kappa0, requires_grad=True)
    t = rtref.build_tables(deck)
    step = rtref.Stepper(deck, t)
    rho = torch.full_like(kappa, deck["rho"])
    e = step.solve(ends, 4, step.t._replace(rhokap=rho * kappa))
    loss = torch.mean((e - target[:, :, None, None]) ** 2)
    loss.backward()
    assert ref["loss"] == pytest.approx(float(loss), rel=1e-13)
    assert ref["grad"][0] == pytest.approx(float(kappa.grad[0]), rel=1e-6)
