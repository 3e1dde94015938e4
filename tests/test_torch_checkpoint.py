"""The port's checkpoints (ROADMAP A8) against the JAX package's, on the CPU.

* the format: a save/load round trip bit for bit, ``config_fingerprint``
  string-equal to JAX's on every deck in ``prm/``, the fingerprint guard,
  ``latest_checkpoint``'s ordering;
* exact restart of the general engine: killed after 4 steps and resumed
  to 10, equal to 10 straight steps bit for bit (BE, CN, BDF2);
* portability both ways: a checkpoint the JAX package wrote resumes in
  the port within 1e-12 of JAX's straight run, and one the port wrote
  loads in JAX's ``load_checkpoint``;
* the CLI killed and resumed (``--checkpoint-dir``) on the CPU plain
  versions of every kernel engine: their resumed CSVs are the straight
  run's byte for byte, since every plain version computes a step by the
  same operations whatever the steps a launch;
* two gloo ranks (one launch): ``--mesh 1x2`` general and pallas killed
  and resumed, ``--balance-every`` there, ranks resuming from different
  steps failing fast;
* ``--check`` aborting a run that resumes from a checkpoint poisoned with
  a NaN, with no CSV written, and the same run completing without it
  (JAX ``tests/test_debug.py:72-97``).

The decks are single_group.prm with a boundary source of 2.0 against
B = 4.0931, so that the state moves, and its thick variant (N = 2048,
X = 20.48) that the halo engines' creep bound admits.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import contextlib
import io
import os
import textwrap

import numpy as np
import pytest
import torch

from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.utils import checkpoint as jax_ckpt

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.parallel.distributed import launch_local
from radiative_transfer_tpu_torch.utils import checkpoint as ck
from radiative_transfer_tpu_torch.utils.debug import NumericCheckError

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = ("default.prm", "llnl_slab_test.prm", "multi_group_equilibrium.prm",
         "single_group.prm", "template.prm")
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")


@pytest.fixture(scope="module")
def decks(tmp_path_factory):
    """{"mv", "mv_cn", "thick", "thick_cn"}: the moving decks, BDF2 and
    CN."""
    tmp = tmp_path_factory.mktemp("decks")
    base = open(os.path.join(REPO, "prm", "single_group.prm")).read()
    edits = {"mv": [("psi_source=4.0931 4.0931", "psi_source=2.0 2.0")]}
    edits["thick"] = edits["mv"] + [("N=100", "N=2048"), ("X=1.", "X=20.48")]
    paths = {}
    for name, subs in edits.items():
        for suffix, ts in (("", []), ("_cn", [("ts_method=3",
                                               "ts_method=2")])):
            text = base
            for old, new in subs + ts:
                text = conftest.deck_edit(text, old, new)
            paths[name + suffix] = str(tmp / f"{name}{suffix}.prm")
            with open(paths[name + suffix], "w") as fh:
                fh.write(text)
    return paths


def _setup(deck, **over):
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    return cfg, tables, port_transport.initial_state(cfg, tables)


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(argv)
    assert rc == 0, out.getvalue()[-3000:]
    return out.getvalue()


def _same_csvs(got_dir, ref_dir):
    return all(open(os.path.join(got_dir, f"{n}.csv"), "rb").read()
               == open(os.path.join(ref_dir, f"{n}.csv"), "rb").read()
               for n in CSVS)


# -- the format ---------------------------------------------------------------

def test_save_load_roundtrip_bitexact(tmp_path, decks):
    cfg, tables, state = _setup(decks["mv"], max_timesteps=3)
    state = port_transport.solve(cfg, tables, state, device="cpu")
    path = ck.save_checkpoint(str(tmp_path), state, 3, cfg)
    assert path == str(tmp_path / "ckpt_000000003.npz")
    assert not list(tmp_path.glob("*.tmp"))
    loaded, step = ck.load_checkpoint(path, cfg)
    assert step == 3
    for a, b in zip(state, loaded):
        assert b.dtype == torch.float64 and torch.equal(a, b)


@pytest.mark.parametrize("deck", DECKS)
def test_fingerprint_matches_jax(deck):
    path = os.path.join(REPO, "prm", deck)
    assert ck.config_fingerprint(port.load_config(path)) == (
        jax_ckpt.config_fingerprint(jax_load_config(path)))


def test_fingerprint_guard(tmp_path, decks):
    cfg, _, state = _setup(decks["mv"], max_timesteps=2)
    path = ck.save_checkpoint(str(tmp_path), state, 2, cfg)
    # Stopping criteria may change; the physics may not.
    ck.load_checkpoint(path, cfg.replace(max_timesteps=50))
    with pytest.raises(ValueError, match="different problem"):
        ck.load_checkpoint(path, cfg.replace(kappa_grey=2.0))


def test_latest_checkpoint_ordering(tmp_path, decks):
    cfg, _, state = _setup(decks["mv"], max_timesteps=1)
    for s in (1, 10, 2):
        ck.save_checkpoint(str(tmp_path), state, s, cfg)
    assert ck.latest_checkpoint(str(tmp_path)).endswith("ckpt_000000010.npz")
    assert ck.latest_checkpoint(str(tmp_path / "empty")) is None


# -- exact restart of the general engine --------------------------------------

@pytest.mark.parametrize("ts_method", [1, 2, 3])
def test_resume_matches_uninterrupted(tmp_path, decks, ts_method):
    """4 steps + crash + resume for 6 == 10 straight, bit for bit, the
    BDF2 history (prev/half ends) included."""
    cfg, tables, state0 = _setup(decks["mv"], max_timesteps=10,
                                 ts_method=ts_method)
    straight = port_transport.solve(cfg, tables, state0, device="cpu")
    ck.solve_with_checkpoints(cfg, tables, state0, str(tmp_path), every=2,
                              num_steps=4, device="cpu")
    assert ck.latest_checkpoint(str(tmp_path)).endswith("ckpt_000000004.npz")
    final, resumed = ck.solve_with_checkpoints(
        cfg, tables, state0, str(tmp_path), every=3, device="cpu")
    assert resumed == 4
    for a, b in zip(straight, final):
        assert torch.equal(a, b)
    # --no-resume starts over, the straight trajectory again.
    again, start = ck.solve_with_checkpoints(
        cfg, tables, state0, str(tmp_path), every=5, resume=False,
        device="cpu")
    assert start == 0 and torch.equal(again.ends, straight.ends)


# -- portability --------------------------------------------------------------

def test_jax_checkpoint_resumes_in_port(tmp_path, decks):
    jcfg = jax_load_config(decks["mv"], max_timesteps=10)
    jt, _, _ = jax_transport.build_tables(jcfg)
    js0 = jax_transport.initial_state(jcfg, jt)
    jax_ckpt.solve_with_checkpoints(jcfg, jt, js0, str(tmp_path), every=4,
                                    num_steps=4)
    jstraight = jax_transport.solve(jcfg, jt, js0, num_steps=10)
    cfg, tables, state0 = _setup(decks["mv"], max_timesteps=10)
    final, resumed = ck.solve_with_checkpoints(cfg, tables, state0,
                                               str(tmp_path), every=3,
                                               device="cpu")
    assert resumed == 4
    for a, b in zip(final, jstraight):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()


def test_port_checkpoint_loads_in_jax(tmp_path, decks):
    cfg, tables, state = _setup(decks["mv_cn"], max_timesteps=3)
    state = port_transport.solve(cfg, tables, state, device="cpu")
    path = ck.save_checkpoint(str(tmp_path), state, 3, cfg)
    jstate, step = jax_ckpt.load_checkpoint(
        path, jax_load_config(decks["mv_cn"]))
    assert step == 3
    for a, b in zip(state, jstate):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a.numpy(), b)
    assert jax_ckpt.latest_checkpoint(str(tmp_path)) == path


# -- kill and resume through the CLI, one device ------------------------------

ENGINES = [
    ("general", "mv", []),
    ("general", "mv", ["--dtype", "float32"]),
    ("pallas", "mv", ["--dtype", "float32"]),
    ("pallas", "mv_cn", ["--dtype", "float32"]),
    ("halo", "thick", []),
    ("halo", "thick_cn", []),
    ("df", "mv", []),
    ("df", "mv_cn", []),
    ("auto", "thick", []),
    ("auto", "thick_cn", []),
    ("fused", "mv", []),
]


@pytest.mark.parametrize("engine,deck,extra", ENGINES,
                         ids=[f"{e}-{d}{'-f32' if x else ''}"
                              for e, d, x in ENGINES])
def test_cli_kill_and_resume(tmp_path, decks, engine, deck, extra):
    """8 steps straight; killed at 6 with a checkpoint every 3, then
    resumed to 8 (the chunks do not divide the engines' K): the same
    CSVs."""
    base = [decks[deck], "--engine", engine, "--device", "cpu", *extra]
    ckdir = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
             "3"]
    _cli(base + ["--steps", "8", "--outdir", str(tmp_path / "straight")])
    _cli(base + ckdir + ["--steps", "6", "--outdir", str(tmp_path / "x")])
    assert ck.latest_checkpoint(str(tmp_path / "ck")).endswith("06.npz")
    out = _cli(base + ckdir + ["--steps", "8", "--profile", "--outdir",
                               str(tmp_path / "resumed")])
    assert "resumed from step 6" in out
    assert "wall: " in out and " for 2 steps " in out   # the resumed prefix
    if engine == "auto":
        assert "packed-rows df halo at 1-device mesh" in out
    assert _same_csvs(tmp_path / "resumed", tmp_path / "straight")


def test_cli_check_aborts_on_poisoned_checkpoint(tmp_path, decks):
    """A NaN injected mid-run (a poisoned checkpoint the run resumes from)
    aborts --check with the failing check NAMED, before any CSV; without
    --check the same run completes."""
    cfg, _, state = _setup(decks["mv"])
    ends = state.ends.clone()
    ends[0, 0, 2, 0] = float("nan")
    ckdir = tmp_path / "ck"
    ck.save_checkpoint(str(ckdir), state._replace(ends=ends), 3, cfg)
    outdir = tmp_path / "out"
    argv = [decks["mv"], "--engine", "pallas", "--device", "cpu", "--steps",
            "6", "--checkpoint-dir", str(ckdir), "--checkpoint-every", "3",
            "--outdir", str(outdir), "--check"]
    with pytest.raises(NumericCheckError,
                       match="'finite-intensity' failed.* at step 3$"):
        port_cli.main(argv)
    assert not list(outdir.glob("*.csv"))
    assert ck.latest_checkpoint(str(ckdir)).endswith("03.npz")
    _cli(argv[:-1])
    assert ck.latest_checkpoint(str(ckdir)).endswith("06.npz")


# -- two gloo ranks -----------------------------------------------------------

MESH_WORKER = textwrap.dedent("""
    import contextlib, io, os, sys
    import torch
    torch.set_num_threads(1)
    from radiative_transfer_tpu_torch import cli
    from radiative_transfer_tpu_torch.parallel import distributed
    from radiative_transfer_tpu_torch.utils import checkpoint as ck
    tmp, deck = sys.argv[1:3]
    for engine in ("general", "pallas"):
        base = [deck, "--engine", engine, "--mesh", "1x2", "--device",
                "cpu", "--dtype", "float32" if engine == "pallas"
                else "float64"]
        ckdir = ["--checkpoint-dir", f"{tmp}/{engine}_ck",
                 "--checkpoint-every", "3"]
        runs = [["--steps", "8", "--outdir", f"{tmp}/{engine}_straight"],
                ckdir + ["--steps", "6", "--outdir", f"{tmp}/{engine}_x"],
                ckdir + ["--steps", "8", "--outdir",
                         f"{tmp}/{engine}_resumed"],
                ["--steps", "4", "--balance-every", "2", "--outdir",
                 f"{tmp}/{engine}_balance"]]
        for i, extra in enumerate(runs):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(base + extra) == 0, (engine, extra)
            rank = distributed.process_index()
            with open(f"{tmp}/{engine}_{i}_rank{rank}.txt", "w") as fh:
                fh.write(buf.getvalue())
    # Ranks that resumed from different steps fail fast, not hang.
    try:
        ck._assert_same_start(distributed.process_index())
    except RuntimeError as e:
        with open(f"{tmp}/start_rank{distributed.process_index()}.txt",
                  "w") as fh:
            fh.write(str(e))
    distributed.shutdown()
""")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory, decks):
    tmp = tmp_path_factory.mktemp("ckpt_mesh")
    runs = launch_local(["-c", MESH_WORKER, str(tmp), decks["mv"]], 2,
                        cwd=REPO, timeout=240)
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    return tmp


@pytest.mark.parametrize("engine", ["general", "pallas"])
def test_mesh_kill_and_resume(mesh_runs, engine):
    tmp = mesh_runs
    assert "resumed from step 6" in open(tmp / f"{engine}_2_rank0.txt").read()
    assert "resumed" not in open(tmp / f"{engine}_2_rank1.txt").read()
    assert _same_csvs(tmp / f"{engine}_resumed", tmp / f"{engine}_straight")


def test_mesh_general_resumed_equals_one_device(mesh_runs, tmp_path, decks):
    _cli([decks["mv"], "--device", "cpu", "--steps", "8", "--outdir",
          str(tmp_path)])
    assert _same_csvs(mesh_runs / "general_resumed", tmp_path)


@pytest.mark.parametrize("engine", ["general", "pallas"])
def test_mesh_balance_every(mesh_runs, engine):
    """One balance line every 2 steps, printed by rank 0 alone."""
    out0 = open(mesh_runs / f"{engine}_3_rank0.txt").read()
    out1 = open(mesh_runs / f"{engine}_3_rank1.txt").read()
    assert out0.count(": balance max=") == 2
    assert "step      4: balance max=" in out0
    assert ": balance max=" not in out1


def test_mesh_ranks_resuming_from_different_steps_fail_fast(mesh_runs):
    for rank in (0, 1):
        msg = open(mesh_runs / f"start_rank{rank}.txt").read()
        assert "different checkpoint steps [0, 1]" in msg
        assert "shared by every process" in msg
