"""The port's utilities (ROADMAP A8) against the JAX package's, on the CPU.

* the CLI's console echo (``_echo_inputs``, ``_echo_solver_tables``),
  ``utils/diagnostics.full_report`` and ``write_tables_csv``: byte-equal
  to the JAX package's on every deck in ``prm/``;
* ``utils/profiling``: ``StepMetrics.summary()`` and ``updates_per_step``
  equal to JAX's, ``trace`` writing a Chrome trace, ``measure_solve``;
* ``utils/debug``: ``make_ends_checker`` naming each check and the step as
  JAX's does, ``checked_step``, ``assert_state_finite``, ``nan_debug``;
* ``--metrics-json``: the port CLI's keys equal to the JAX CLI's, and its
  echo equal to the JAX CLI's, on ``single_group.prm`` at 3 steps.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import contextlib
import io
import json
import os
import re

import jax.numpy as jnp
import pytest
import torch

from radiative_transfer_tpu import cli as jax_cli
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.utils import debug as jax_debug
from radiative_transfer_tpu.utils import diagnostics as jax_diag
from radiative_transfer_tpu.utils import profiling as jax_prof

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.utils import debug as port_debug
from radiative_transfer_tpu_torch.utils import diagnostics as port_diag
from radiative_transfer_tpu_torch.utils import profiling as port_prof

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = ("default.prm", "llnl_slab_test.prm", "multi_group_equilibrium.prm",
         "single_group.prm", "template.prm")
GRAY = os.path.join(REPO, "prm", "single_group.prm")


def _deck(name):
    return os.path.join(REPO, "prm", name)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# -- the echo, the tables -----------------------------------------------------

@pytest.mark.parametrize("fn", ["_echo_inputs", "_echo_solver_tables"])
@pytest.mark.parametrize("deck", DECKS)
def test_echo_byte_equal(deck, fn):
    _, got = _stdout(getattr(port_cli, fn), port.load_config(_deck(deck)))
    _, want = _stdout(getattr(jax_cli, fn), jax_load_config(_deck(deck)))
    assert got == want
    assert got.strip()


def _both_tables(deck):
    pcfg = port.load_config(_deck(deck))
    jcfg = jax_load_config(_deck(deck))
    return ((pcfg, *port_transport.build_tables(pcfg)),
            (jcfg, *jax_transport.build_tables(jcfg, dtype=jnp.float64)))


@pytest.mark.parametrize("deck", DECKS)
def test_full_report_byte_equal(deck):
    got, want = _both_tables(deck)
    assert port_diag.full_report(*got) == jax_diag.full_report(*want)


@pytest.mark.parametrize("deck", DECKS)
def test_tables_csv_byte_equal(deck, tmp_path):
    got, want = _both_tables(deck)
    paths = port_diag.write_tables_csv(str(tmp_path / "pt"), *got)
    jpaths = jax_diag.write_tables_csv(str(tmp_path / "jx"), *want)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        assert open(p, "rb").read() == open(q, "rb").read(), p


# -- profiling ----------------------------------------------------------------

@pytest.mark.parametrize("chunks,ts_method", [
    ([(4, 0.5)], 3), ([(2, 1e-3), (2, 2e-3), (1, 7.5e-4)], 2),
    ([(100, 12.25), (50, 3.0)], 1)])
def test_step_metrics_matches_jax(chunks, ts_method):
    cfg = port.load_config(GRAY, ts_method=ts_method)
    jcfg = jax_load_config(GRAY, ts_method=ts_method)
    ups = port_prof.updates_per_step(cfg)
    assert ups == jax_prof.updates_per_step(jcfg)
    got = port_prof.StepMetrics(updates_per_step=ups)
    want = jax_prof.StepMetrics(updates_per_step=ups)
    for steps, seconds in chunks:
        got.add(steps, seconds)
        want.add(steps, seconds)
    assert got.summary() == want.summary()
    assert (got.ms_per_step, got.updates_per_s, got.chunks) == (
        want.ms_per_step, want.updates_per_s, want.chunks)


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with port_prof.trace(logdir, "cpu") as prof:
        assert prof is not None
        torch.ones(64).cumsum(0)
    path = port_prof.trace_path(logdir)
    assert path == os.path.join(logdir, "trace_rank0.json")
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)


def test_trace_is_a_no_op_without_a_logdir(tmp_path):
    with port_prof.trace(None) as prof:
        assert prof is None
    assert not list(tmp_path.iterdir())


def test_measure_solve_returns_one_application():
    calls = []

    def run(x):
        calls.append(x)
        return x + 1

    out, best = port_prof.measure_solve(run, torch.zeros(3), repeats=2)
    assert torch.equal(out, torch.ones(3))
    assert len(calls) == 3 and best >= 0.0


# -- numeric guards -----------------------------------------------------------

def _ends(poison=None):
    cfg = port.load_config(GRAY, N=8)
    tables, _, _ = port_transport.build_tables(cfg)
    ends = port_transport.initial_state(cfg, tables).ends.clone()
    if poison is not None:
        ends[0, 0, 5, 1] = poison
    return ends


@pytest.mark.parametrize("poison,positivity,check", [
    (None, False, None), (None, True, None),
    (float("nan"), False, "finite-intensity"),
    (float("inf"), True, "finite-intensity"),
    (-1.0, False, None), (-1.0, True, "positive-intensity"),
    (0.0, True, "positive-intensity")])
def test_ends_checker_names_the_check_as_jax(poison, positivity, check):
    """The port's message is JAX's checkify message, check name, reference
    line and ' at step N' included."""
    ends = _ends(poison)
    port_check = port_debug.make_ends_checker(positivity=positivity)
    jax_check = jax_debug.make_ends_checker(positivity=positivity)
    if check is None:
        port_check(ends, step=7)
        port_check(ends.numpy())
        jax_check(jnp.asarray(ends.numpy()), step=7)
        return
    with pytest.raises(port_debug.NumericCheckError) as got:
        port_check(ends, step=7)
    with pytest.raises(Exception) as want:
        jax_check(jnp.asarray(ends.numpy()), step=7)
    assert f"check '{check}' failed" in str(got.value)
    assert str(got.value).endswith(" at step 7")
    head = str(got.value)[:-len(" at step 7")]
    assert head in str(want.value)
    assert re.search(f"{check}.*step 7", str(want.value))
    with pytest.raises(port_debug.NumericCheckError, match=f"{check}'"
                       " failed: [^@]*analogue\\)$"):
        port_check(ends)


@pytest.mark.parametrize("poison", [None, float("nan")])
def test_checked_step(poison):
    cfg = port.load_config(GRAY, N=8, max_timesteps=1)
    tables, _, _ = port_transport.build_tables(cfg)
    state = port_transport.initial_state(cfg, tables)
    if poison is not None:
        state = state._replace(ends=_ends(poison))
    step = port_transport.make_step_fn(cfg, tables, device="cpu")
    err, new = port_debug.checked_step(step, positivity=True)(state)
    if poison is None:
        assert err is None
        assert bool(torch.isfinite(new.ends).all())
    else:
        assert isinstance(err, port_debug.NumericCheckError)
        assert "non-finite intensity in ends after step" in str(err)


def test_assert_state_finite_names_the_leaf():
    cfg = port.load_config(GRAY, N=8)
    tables, _, _ = port_transport.build_tables(cfg)
    state = port_transport.initial_state(cfg, tables)
    port_debug.assert_state_finite(state)
    bad = state._replace(half_ends=_ends(float("nan")))
    with pytest.raises(FloatingPointError,
                       match=r"state\.half_ends contains 1 non-finite"):
        port_debug.assert_state_finite(bad)


def test_nan_debug_restores_anomaly_mode():
    before = torch.is_anomaly_enabled()
    with port_debug.nan_debug():
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        # Anomaly mode names the forward operation whose gradient is NaN.
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(
                UserWarning, match="Traceback of forward call"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    assert torch.is_anomaly_enabled() == before


# -- the CLI against the JAX CLI ----------------------------------------------

def test_metrics_json_and_echo_match_jax_cli(tmp_path):
    """--metrics-json has the JAX CLI's key set, and the console echo is
    the JAX CLI's, byte for byte, on single_group.prm at 3 steps."""
    argv = [GRAY, "--steps", "3", "--engine", "general"]
    rc, jout = _stdout(jax_cli.main, argv + [
        "--outdir", str(tmp_path / "jx"), "--metrics-json",
        str(tmp_path / "jx.json")])
    assert rc == 0
    rc, pout = _stdout(port_cli.main, argv + [
        "--outdir", str(tmp_path / "pt"), "--metrics-json",
        str(tmp_path / "pt.json"), "--device", "cpu"])
    assert rc == 0
    got = json.load(open(tmp_path / "pt.json"))
    want = json.load(open(tmp_path / "jx.json"))
    assert set(got) == set(want)
    assert set(got["outputs"]) == set(want["outputs"])
    for key in ("deck", "engine", "mesh", "dtype", "steps_run"):
        assert got[key] == want[key], key
    assert got["updates_per_s"] > 0
    assert abs(got["balance_max"] - want["balance_max"]) <= (
        1e-12 * abs(want["balance_max"]))
    echo = jout[:jout.index("sources:")]
    assert echo.startswith(f"filename: {GRAY}\n\n--- Input Parameters ---")
    assert pout[:pout.index("sources:")] == echo
