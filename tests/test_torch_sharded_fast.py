"""The port's ShardedFastEngine (parallel/sharded_fast.py) on gloo ranks
against the port's FastEngine on one device and JAX's ShardedFastEngine.

The ranks are spawned once per mesh shape (parallel/distributed
.launch_local: two ranks at 1x2, four at 2x2, one thread each, no jax) and
run every case of JAX's tests/test_sharded_fast.py at float64: gray at
BE/CN/BDF2, multigroup with the v/c correction, the LLNL deck (2 steps),
the boundary combinations (1x2); the 2-D mesh gray, multigroup reflective
(the direction flip crossing row shards) and LLNL, and the awkward-N chunk
autopick (2x2). Rank 0's gathered (ends, prev, half) are held within 1e-12
(relative to the largest magnitude) of FastEngine on one device, and on
the cases of JAX_HELD, which take every exchange (the BDF2 shift's
ppermutes, the composite all_gathers, the reflective flip over 'x' alone
and across row shards, the v/c correction), also of JAX's
ShardedFastEngine on the conftest's virtual CPU mesh of the same shape
(each JAX case compiles for ~2-3 s); the chunk each picks is JAX's (JAX's
rule, read off its engine without a compile); the refusals (degenerate
chunking, no even split of the columns or the rows) keep JAX's text.

In the same spawns: ``--engine fast --mesh 1x2`` killed at 6 and resumed to
8 (byte-equal CSVs to 8 straight), ``--balance-every 2``, ``--engine auto``
at float64 on ``--mesh 1x2`` with the LLNL deck at its shipped dt (the df
halo infeasible: JAX's fallback to ShardedFastEngine, within 1e-12 of the
single-device ``--engine fast`` CLI), and ``solve_ensemble_stacked`` on a
fast 2x2 mesh against each member's own solve. A 1x1 mesh runs in this
process.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import contextlib
import functools
import io
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.parallel import sharded_fast as jax_sf

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch import ensemble as port_ens
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs
from radiative_transfer_tpu_torch.parallel import make_multichip_engine
from radiative_transfer_tpu_torch.parallel import mesh as port_mesh
from radiative_transfer_tpu_torch.parallel.distributed import launch_local
from radiative_transfer_tpu_torch.parallel.sharded_fast import (
    ShardedFastEngine)

from test_torch_general import _jit_opt_off_f64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
MG = os.path.join(REPO, "prm", "multi_group_equilibrium.prm")
LLNL = os.path.join(REPO, "prm", "llnl_slab_test.prm")
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")
F64 = torch.float64
TOL = 1e-12
S8 = tuple((4.0931,) for _ in range(8))

# shape: {name: (deck, config overrides, steps, chunk)}
CASES = {
    "1x2": {
        "gray-be": (GRAY, dict(N=128, ts_method=1), 8, 8),
        "gray-cn": (GRAY, dict(N=128, ts_method=2), 8, 8),
        "gray-bdf2": (GRAY, dict(N=128, ts_method=3), 8, 8),
        "mg-correction": (MG, dict(N=64), 6, 8),
        "llnl": (LLNL, dict(N=64), 2, 8),
        "bc-vacuum-vacuum": (GRAY, dict(N=64, bc_left_indicator=0,
                                        bc_right_indicator=0), 5, 8),
        "bc-source-source": (GRAY, dict(N=64, bc_left_indicator=1,
                                        bc_right_indicator=1), 5, 8),
        "bc-reflective-vacuum": (GRAY, dict(N=64, bc_left_indicator=2,
                                            bc_right_indicator=0), 5, 8),
    },
    "2x2": {
        "2d-gray-be": (GRAY, dict(N=64, M=8, psi_source=S8, ts_method=1),
                       6, 8),
        "2d-gray-bdf2": (GRAY, dict(N=64, M=8, psi_source=S8, ts_method=3),
                         6, 8),
        "2d-mg-reflective": (MG, dict(N=64, bc_left_indicator=2), 5, 8),
        "2d-llnl": (LLNL, dict(N=64), 2, 8),
        "awkward-n": (GRAY, dict(M=8, psi_source=S8), 4, 256),
    },
}
# The cases held against JAX's ShardedFastEngine as well.
JAX_HELD = {("1x2", "gray-bdf2"), ("1x2", "mg-correction"),
            ("1x2", "bc-reflective-vacuum"), ("2x2", "2d-mg-reflective"),
            ("2x2", "awkward-n")}
# shape: {name: (deck, config overrides, chunk)} that must refuse.
REFUSED = {
    "1x2": {"columns": (GRAY, dict(N=101), 256)},
    "2x2": {"rows": (GRAY, dict(N=64), 8)},
}
# The stacked ensemble on the 2x2 mesh: K members of the mg deck.
ENS = (MG, dict(N=64, max_timesteps=4), np.array([[0.5], [2.0]]))

WORKER = textwrap.dedent("""
    import contextlib, io, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import radiative_transfer_tpu_torch as port
    from radiative_transfer_tpu_torch import cli
    from radiative_transfer_tpu_torch import ensemble as ens
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import (
        distributed, make_multichip_engine, mesh)
    out_path, shape, cases, refused, ens_case, tmp, mv, llnl = sys.argv[1:9]
    cases, refused = eval(cases), eval(refused)
    distributed.initialize(device_type="cpu")
    ng, nx = (int(v) for v in shape.split("x"))
    m = mesh.make_mesh_2d(ng, nx) if ng > 1 else mesh.make_mesh_1d(nx)
    rank = distributed.process_index()
    out = {}
    for name, (deck, over, steps, chunk) in cases.items():
        cfg = port.load_config(deck, **over)
        tables, _, _ = transport.build_tables(cfg)
        eng = make_multichip_engine(cfg, tables, m, engine="fast",
                                    dtype=torch.float64, chunk=chunk,
                                    device="cpu")
        st = eng.solve(num_steps=steps)
        out[name] = np.stack([x.numpy() for x in
                              [eng.ends(st), *eng.prev_half_ends(st)]])
        out[name + "/engine"] = np.array(type(eng).__name__)
        out[name + "/chunk"] = np.array([eng.chunk, eng.nc_l, eng.Bh_l])
    for name, (deck, over, chunk) in refused.items():
        cfg = port.load_config(deck, **over)
        tables, _, _ = transport.build_tables(cfg)
        try:
            make_multichip_engine(cfg, tables, m, engine="fast",
                                  dtype=torch.float64, chunk=chunk,
                                  device="cpu")
            out["refused/" + name] = np.array("built")
        except ValueError as e:
            out["refused/" + name] = np.array(str(e))
    if ens_case != "None":
        deck, over, kappa = eval(ens_case, {"array": np.array})
        cfg = port.load_config(deck, **over)
        tables, _, _ = transport.build_tables(cfg)
        got = ens.solve_ensemble_stacked(
            cfg, tables, {"kappa": kappa * tables.kappa}, mesh=m,
            engine="fast", dtype=torch.float64, device="cpu")
        out["ensemble"] = np.stack([x.numpy() for x in got])
    if shape == "1x2":
        base = [mv, "--engine", "fast", "--mesh", "1x2", "--device", "cpu"]
        ckdir = ["--checkpoint-dir", f"{tmp}/ck", "--checkpoint-every", "3"]
        runs = {"straight": base + ["--steps", "8"],
                "killed": base + ckdir + ["--steps", "6"],
                "resumed": base + ckdir + ["--steps", "8"],
                "balance": base + ["--steps", "4", "--balance-every", "2"],
                "auto": [llnl, "--engine", "auto", "--mesh", "1x2",
                         "--device", "cpu"]}
        for tag, argv in runs.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(argv + ["--outdir", f"{tmp}/{tag}"]) == 0, tag
            with open(f"{tmp}/{tag}_rank{rank}.txt", "w") as fh:
                fh.write(buf.getvalue())
    if rank == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
""")


def _moving_deck(tmp):
    """single_group.prm with a boundary source of 2.0 against B = 4.0931
    (the state moves)."""
    text = conftest.deck_edit(open(GRAY).read(), "psi_source=4.0931 4.0931",
                              "psi_source=2.0 2.0")
    path = os.path.join(tmp, "mv.prm")
    with open(path, "w") as fh:
        fh.write(text)
    return path


@functools.lru_cache(maxsize=None)
def _spawn(shape, tmp):
    nprocs = int(shape[0]) * int(shape[2])
    out_path = os.path.join(tmp, f"{shape}.npz")
    mv = _moving_deck(tmp)
    ens_case = repr(ENS) if shape == "2x2" else "None"
    runs = launch_local(["-c", WORKER, out_path, shape, repr(CASES[shape]),
                         repr(REFUSED[shape]), ens_case, tmp, mv, LLNL],
                        nprocs, cwd=REPO, timeout=300)
    for r in runs:
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(out_path))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_fast"))


def _jax_mesh(shape):
    ng, nx = int(shape[0]), int(shape[2])
    return (jax_sf.make_mesh_2d(ng, nx) if ng > 1
            else jax_sf.make_mesh_1d(nx))


def _jax_engine(shape, name):
    """JAX's ShardedFastEngine for a case, on the virtual CPU mesh of
    `shape` (built, not compiled)."""
    deck, over, _, chunk = CASES[shape][name]
    cfg = jax_load_config(deck, **over)
    tables, _, _ = jax_transport.build_tables(cfg)
    return jax_sf.ShardedFastEngine(cfg, tables, _jax_mesh(shape),
                                    dtype=jnp.float64, chunk=chunk)


def _jax_planes(shape, name):
    """JAX's ShardedFastEngine's global (ends, prev, half) for a case."""
    steps = CASES[shape][name][2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_opt_off_f64)
        eng = _jax_engine(shape, name)
        st = eng.solve(num_steps=steps)
        return np.stack([np.asarray(eng.ends_pair(st.e0, st.e1)),
                         np.asarray(eng.ends_pair(st.p0, st.p1)),
                         np.asarray(eng.ends_pair(st.h0, st.h1))])


def _one_device(deck, over, steps, chunk, tables=None):
    cfg = port.load_config(deck, **over)
    if tables is None:
        tables, _, _ = port_transport.build_tables(cfg)
    eng = port_fs.FastEngine(cfg, tables, dtype=F64, chunk=chunk,
                             device="cpu")
    st = eng.solve(num_steps=steps)
    return np.stack([x.numpy() for x in
                     [eng.ends(st), *eng.prev_half_ends(st)]])


def _rel(a, b):
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


SHAPED = [(shape, name) for shape in CASES for name in CASES[shape]]


@pytest.mark.parametrize("shape,name", SHAPED)
def test_ranks_match_one_device_and_jax(tmp, shape, name):
    got = _spawn(shape, tmp)[name]
    deck, over, steps, chunk = CASES[shape][name]
    one = _one_device(deck, over, steps, chunk)
    assert np.all(np.isfinite(got))
    e_one = _rel(got, one)
    print(f"{shape} {name}: vs FastEngine {e_one:.2e}")
    assert e_one < TOL
    if (shape, name) in JAX_HELD:
        e_jax = _rel(got, _jax_planes(shape, name))
        print(f"{shape} {name}: vs JAX ShardedFastEngine {e_jax:.2e}")
        assert e_jax < TOL


@pytest.mark.parametrize("shape,name", SHAPED)
def test_chunk_choice_and_engine_match_jax(tmp, shape, name):
    ranks = _spawn(shape, tmp)
    chunk, nc_l, bh_l = ranks[name + "/chunk"]
    assert str(ranks[name + "/engine"]) == "ShardedFastEngine"
    assert chunk == _jax_engine(shape, name).eng.chunk
    deck, over, _, _ = CASES[shape][name]
    cfg = port.load_config(deck, **over)
    ng, nx = int(shape[0]), int(shape[2])
    assert nc_l * chunk * nx == cfg.N
    assert bh_l * ng == cfg.M // 2 * cfg.G


def test_awkward_n_autopicks_a_compatible_chunk(tmp):
    """N = 100 has no power-of-two chunking over 2 spatial shards: the
    engine picks chunk 50 (2 columns, one a rank), as JAX's does."""
    chunk, nc_l, _ = _spawn("2x2", tmp)["awkward-n/chunk"]
    assert (chunk, nc_l) == (50, 1)


def _jax_refusal(shape, deck, over, chunk):
    cfg = jax_load_config(deck, **over)
    tables, _, _ = jax_transport.build_tables(cfg)
    with pytest.raises((ValueError, AssertionError)) as exc:
        jax_sf.ShardedFastEngine(cfg, tables, _jax_mesh(shape),
                                 dtype=jnp.float64, chunk=chunk)
    return str(exc.value)


@pytest.mark.parametrize("shape,name", [(s, n) for s in REFUSED
                                        for n in REFUSED[s]])
def test_refusals_keep_jax_text(tmp, shape, name):
    got = str(_spawn(shape, tmp)["refused/" + name])
    assert got == _jax_refusal(shape, *REFUSED[shape][name])
    assert ("spatial shards" if name == "columns" else "group shards") in got


def test_degenerate_chunking_refused_as_jax():
    over = dict(N=11)
    cfg = port.load_config(GRAY, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    with pytest.raises(ValueError, match="degenerate chunking") as exc:
        ShardedFastEngine(cfg, tables, port_mesh.make_mesh_1d(1),
                          dtype=F64, chunk=8, device="cpu")
    assert str(exc.value) == _jax_refusal("1x1", GRAY, over, 8)


@pytest.mark.parametrize("ts", [1, 2, 3])
def test_one_rank_mesh_in_process(ts):
    """At 1x1 the collectives are skipped: bit-equal to FastEngine at the
    same chunk."""
    deck, over, steps, chunk = GRAY, dict(N=128, ts_method=ts,
                                          bc_left_indicator=2), 6, 8
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    eng = make_multichip_engine(cfg, tables, port_mesh.make_mesh_2d(1, 1),
                                engine="fast", dtype=F64, chunk=chunk,
                                device="cpu")
    assert isinstance(eng, ShardedFastEngine) and eng.dtype == F64
    st = eng.solve(num_steps=steps)
    got = np.stack([x.numpy() for x in [eng.ends(st),
                                         *eng.prev_half_ends(st)]])
    np.testing.assert_array_equal(got, _one_device(deck, over, steps, chunk))
    # from_ends and the global state round-trip the layout.
    again = eng.from_ends(*(torch.as_tensor(x) for x in got))
    np.testing.assert_array_equal(eng.ends(again).numpy(), got[0])


def test_stacked_ensemble_on_fast_mesh(tmp):
    """solve_ensemble_stacked on a 2x2 fast mesh (the members' rows split
    over 'g'): each member within 1e-12 of its own FastEngine solve and of
    the stacked solve on one device."""
    got = _spawn("2x2", tmp)["ensemble"]           # (3, K, M, G, N, 2)
    deck, over, kappa = ENS
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    params = {"kappa": kappa * tables.kappa}
    one = port_ens.solve_ensemble_stacked(cfg, tables, params, engine="fast",
                                          dtype=F64, device="cpu")
    one = np.stack([x.numpy() for x in one])
    assert got.shape == one.shape and _rel(got, one) < TOL
    for k in range(len(kappa)):
        tab_k = port_ens._host_member_tables(cfg, tables,
                                             {"kappa": params["kappa"][k]})
        want = _one_device(deck, over, cfg.max_timesteps, 256, tab_k)
        assert _rel(got[:, k], want) < TOL, k


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port_cli.main(argv)
    assert rc == 0, out.getvalue()[-3000:]
    return out.getvalue()


def _read(tmp, tag, rank):
    return open(os.path.join(tmp, f"{tag}_rank{rank}.txt")).read()


def _csv_err(got_dir, ref_dir):
    phi_scale = np.max(np.abs(np.loadtxt(os.path.join(ref_dir, "phi.csv"))))
    worst = 0.0
    for name in CSVS:
        got = np.loadtxt(os.path.join(got_dir, f"{name}.csv"), ndmin=2)
        ref = np.loadtxt(os.path.join(ref_dir, f"{name}.csv"), ndmin=2)
        assert got.shape == ref.shape and np.all(np.isfinite(got)), name
        scale = phi_scale if name == "F" else np.max(np.abs(ref))
        worst = max(worst, np.max(np.abs(got - ref)) / (scale + 1e-300))
    return worst


def test_cli_fast_mesh_kill_and_resume(tmp):
    _spawn("1x2", tmp)
    assert "resumed from step 6" in _read(tmp, "resumed", 0)
    assert "resumed" not in _read(tmp, "resumed", 1)
    for name in CSVS:
        assert (open(os.path.join(tmp, "resumed", f"{name}.csv"), "rb").read()
                == open(os.path.join(tmp, "straight", f"{name}.csv"),
                        "rb").read()), name
    # The mesh run against the single-device fast engine's CLI.
    one = os.path.join(tmp, "one")
    _cli([os.path.join(tmp, "mv.prm"), "--engine", "fast", "--device", "cpu",
          "--steps", "8", "--outdir", one])
    assert _csv_err(os.path.join(tmp, "straight"), one) < TOL


def test_cli_fast_mesh_balance_every(tmp):
    _spawn("1x2", tmp)
    out0, out1 = _read(tmp, "balance", 0), _read(tmp, "balance", 1)
    assert out0.count(": balance max=") == 2
    assert "step      4: balance max=" in out0
    assert ": balance max=" not in out1
    assert "wrote 8 CSVs" in out0 and "wrote" not in out1


def test_cli_auto_f64_mesh_falls_back_to_sharded_fast(tmp):
    """The LLNL deck at its shipped dt: the df halo's creep bound refuses
    it, and auto at float64 takes JAX's fallback, ShardedFastEngine."""
    _spawn("1x2", tmp)
    out0 = _read(tmp, "auto", 0)
    assert "auto engine: df halo infeasible (" in out0
    assert "falling back to the sharded XLA f64 engine" in out0
    assert "auto engine: ShardedFastEngine" in out0
    assert "auto engine" not in _read(tmp, "auto", 1)
    one = os.path.join(tmp, "auto_one")
    _cli([LLNL, "--engine", "fast", "--device", "cpu", "--outdir", one])
    assert _csv_err(os.path.join(tmp, "auto"), one) < TOL


def test_cli_auto_f64_one_rank_mesh_runs_fast_engine(tmp_path, capsys):
    """At a one-rank mesh in one process the fallback is the plain
    FastEngine, as in JAX."""
    out = _cli([LLNL, "--engine", "auto", "--mesh", "1x1", "--device", "cpu",
                "--outdir", str(tmp_path)])
    assert "falling back to the sharded XLA f64 engine" in out
    assert "auto engine: FastEngine" in out
    assert "wrote 8 CSVs" in out
