"""The port's mesh layer on the CPU: the halo engines across ranks, the
mesh branch of the engine selection, the CLI under gloo ranks and the
process-group helpers.

* Halo engines: ``HaloCudaEngine`` and ``DFHaloCudaEngine`` on a 1x4 mesh
  of gloo ranks (spawned processes, one thread each, no jax): every rank's
  own cells bit-equal to the same engine at one device, as
  tests/test_halo_pallas.py and tests/test_df_halo.py hold JAX's (the plain
  versions keep the truncated scans whose hard influence cap makes the
  halo exact), reflective and source boundaries, BDF2, BE and CN.
* Selection: ``parallel.make_multichip_engine`` with a mesh against JAX
  ``make_multichip_engine(..., platform="tpu")`` on a virtual mesh, engine
  names mapped: on the 1x4 ranks against a 4-device mesh, in this
  process at one rank against a 1-device mesh.
* CLI: ``--mesh 1x2 --device cpu`` under two gloo ranks for ``pallas``,
  ``fused`` and ``auto``: rank 0's 8 CSVs within 1e-5 of the port's
  single-device ``--engine pallas`` CLI (JAX's mesh-versus-single bar).
* Process group: an explicit coordinator that cannot be reached raises
  (as tests/test_distributed.py holds JAX's); the backend choice.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu import parallel as jax_parallel
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.parallel import sharded_pallas as jax_sp

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch import parallel as port_parallel
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.parallel import distributed as port_dist
from radiative_transfer_tpu_torch.parallel import mesh as port_mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
LLNL = os.path.join(REPO, "prm", "llnl_slab_test.prm")
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")
# JAX engine -> the port's counterpart.
NAMES = {"PallasEngine": "CudaSweepEngine",
         "DFPallasEngine": "DFCudaEngine",
         "HaloPallasEngine": "HaloCudaEngine",
         "DFHaloEngine": "DFHaloCudaEngine",
         "ShardedPallasEngine": "ShardedCudaEngine",
         "FusedExchangeEngine": "FusedExchangeCudaEngine"}


def _thick(M, **kw):
    """The gray deck off equilibrium with thick cells (X = 40.96), whose
    truncated scans the halo engines' creep bound admits."""
    return dict(M=M, X=40.96, psi_source=tuple((6.0,) for _ in range(M)),
                **kw)


# -- the halo engines and the selection on 1x4 ranks ---------------------------

HALO_CASES = {
    # name: (engine, config overrides, steps)
    "halo-bdf2-refl": ("halo", _thick(4, N=256, ts_method=3,
                                      bc_left_indicator=2), 3),
    "halo-bdf2-src-sym": ("halo", _thick(4, N=256, ts_method=3,
                                         bc_left_indicator=1,
                                         bdf2_symmetric_half=True), 2),
    "halo-be-refl": ("halo", _thick(4, N=256, ts_method=1,
                                    bc_left_indicator=2), 3),
    "halo-cn-src": ("halo", _thick(4, N=256, ts_method=2,
                                   bc_left_indicator=1), 3),
    "dfhalo-bdf2-refl": ("df_halo", _thick(2, N=512, ts_method=3,
                                           bc_left_indicator=2), 2),
    "dfhalo-cn-refl": ("df_halo", _thick(2, N=512, ts_method=2,
                                         bc_left_indicator=2), 2),
}
HALO_BLK = 16

SELECT_CASES = {
    # name: (deck, config overrides, engine)
    "tiny-thick-auto": (GRAY, _thick(4, N=256), "auto"),
    "thin-bdf2-auto": (GRAY, dict(N=128), "auto"),
    "thin-be-auto": (GRAY, dict(N=128, ts_method=1), "auto"),
    "llnl-shipped-auto": (LLNL, dict(N=32), "auto"),
    "thick-pallas": (GRAY, _thick(4, N=256), "pallas"),
    "thick-fused": (GRAY, _thick(4, N=256), "fused"),
    "thick-halo": (GRAY, _thick(4, N=256), "halo"),
    "thick-df": (GRAY, _thick(4, N=256), "df"),
    "thick-df-halo": (GRAY, _thick(4, N=256), "df_halo"),
    "thin-df": (GRAY, dict(N=128), "df"),
    "thin-single": (GRAY, dict(N=128), "single"),
    "be-fused": (GRAY, dict(N=128, ts_method=1), "fused"),
}

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import radiative_transfer_tpu_torch as port
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import (
        distributed, make_multichip_engine, mesh)
    out_path, deck, blk, halo_cases, select_cases = sys.argv[1:6]
    blk, halo_cases = int(blk), eval(halo_cases)
    select_cases = eval(select_cases)
    distributed.initialize(device_type="cpu")
    m = mesh.make_mesh_1d(4)

    def planes(eng, st):
        ends = [eng.ends(st)] + list(eng.prev_half_ends(st))
        return np.stack([x.numpy() for x in ends])

    out = {}
    for name, (engine, over, steps) in halo_cases.items():
        cfg = port.load_config(deck, **over)
        tables, _, _ = transport.build_tables(cfg)
        kw = dict(block=blk, steps_per_launch=2, device="cpu")
        eng = make_multichip_engine(cfg, tables, m, engine=engine, **kw)
        out[name] = planes(eng, eng.solve(num_steps=steps))
        if m.rank == 0:
            one = type(eng)(cfg, tables, **kw)
            out[name + "/one"] = planes(one, one.solve(num_steps=steps))
            out[name + "/geometry"] = np.array(
                [eng.K_launch, eng.H, one.K_launch, one.H])
    for name, (sdeck, over, engine) in select_cases.items():
        cfg = port.load_config(sdeck, **over)
        tables, _, _ = transport.build_tables(cfg)
        try:
            got = type(make_multichip_engine(cfg, tables, m, engine=engine,
                                             device="cpu")).__name__
        except ValueError:
            got = "ValueError"
        out["select/" + name] = np.array(got)
    if m.rank == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results on a 1x4 mesh of gloo ranks."""
    path = tmp_path_factory.mktemp("mesh_ranks") / "1x4.npz"
    runs = launch(["-c", WORKER, str(path), GRAY, str(HALO_BLK),
                   repr(HALO_CASES), repr(SELECT_CASES)], 4)
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


def launch(argv, nprocs):
    return port_dist.launch_local(argv, nprocs, cwd=REPO, timeout=300)


@pytest.mark.parametrize("name", list(HALO_CASES))
def test_halo_ranks_bit_equal_one_device(ranks, name):
    got, want = ranks[name], ranks[name + "/one"]
    assert np.all(np.isfinite(want))
    # ends, prev and half; the shards' own cells, gathered.
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(HALO_CASES))
def test_halo_ranks_ran_the_halo(ranks, name):
    """The 1x4 shards prepend a halo no wider than their own cells and
    fuse at most as many steps a launch as the one-device engine (whose
    cap here is 2)."""
    K4, H4, K1, _ = ranks[name + "/geometry"]
    assert 1 <= K4 <= K1 <= 2
    assert 0 < H4 <= HALO_CASES[name][1]["N"] // 4


def _jax_select(deck, over, engine, mesh):
    cfg = jax_load_config(deck, **over)
    tables, _, _ = jax_transport.build_tables(cfg)
    try:
        eng = jax_parallel.make_multichip_engine(cfg, tables, mesh,
                                                 engine=engine,
                                                 platform="tpu")
    except ValueError:
        return "ValueError"
    return NAMES[type(eng).__name__]


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_selection_1x4_matches_jax(ranks, name):
    deck, over, engine = SELECT_CASES[name]
    mesh4 = jax_sp.Mesh(np.asarray(jax.devices()[:4]), ("x",))
    assert str(ranks["select/" + name]) == _jax_select(deck, over, engine,
                                                       mesh4)


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_selection_one_rank_matches_jax(name):
    deck, over, engine = SELECT_CASES[name]
    mesh1 = jax_sp.Mesh(np.asarray(jax.devices()[:1]), ("x",))
    want = _jax_select(deck, over, engine, mesh1)
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    try:
        got = type(port_parallel.make_multichip_engine(
            cfg, tables, port_mesh.make_mesh_1d(1), engine=engine,
            device="cpu")).__name__
    except ValueError:
        got = "ValueError"
    assert got == want


def test_selection_refusals():
    cfg = port.load_config(GRAY, N=128)
    tables, _, _ = port_transport.build_tables(cfg)
    make = port_parallel.make_multichip_engine
    from radiative_transfer_tpu_torch.parallel.sharded_fast import (
        ShardedFastEngine)

    assert isinstance(make(cfg, tables, port_mesh.make_mesh_1d(1),
                           engine="fast", device="cpu"), ShardedFastEngine)
    with pytest.raises(ValueError, match="pass a mesh"):
        make(cfg, tables, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown multi-chip engine"):
        make(cfg, tables, port_mesh.make_mesh_1d(1), engine="general",
             device="cpu")


# -- the CLI under two gloo ranks -------------------------------------------------

CLI_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from radiative_transfer_tpu_torch import cli
    from radiative_transfer_tpu_torch.parallel import distributed
    outdir, deck = sys.argv[1:3]
    for engine in ("pallas", "fused", "auto"):
        rc = cli.main([deck, "--outdir", f"{outdir}/{engine}", "--engine",
                       engine, "--mesh", "1x2", "--device", "cpu",
                       "--dtype", "float32", "--steps", "5"])
        assert rc == 0, (engine, rc)
    distributed.shutdown()
""")


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    runs = launch(["-c", CLI_WORKER, str(tmp), GRAY], 2)
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    rc = port_cli.main([GRAY, "--outdir", str(tmp / "single"), "--engine",
                        "pallas", "--device", "cpu", "--dtype", "float32",
                        "--steps", "5"])
    assert rc == 0
    return tmp, runs[0].stdout, runs[1].stdout


@pytest.mark.parametrize("engine", ["pallas", "fused", "auto"])
def test_cli_mesh_1x2_matches_single_device(cli_runs, engine):
    tmp, _, _ = cli_runs
    ref_dir = tmp / "single"
    phi_scale = np.max(np.abs(np.loadtxt(ref_dir / "phi.csv")))
    for name in CSVS:
        got = np.loadtxt(tmp / engine / f"{name}.csv", ndmin=2)
        ref = np.loadtxt(ref_dir / f"{name}.csv", ndmin=2)
        assert got.shape == ref.shape and np.all(np.isfinite(got))
        # F cancels to roundoff; phi bounds it.
        scale = phi_scale if name == "F" else np.max(np.abs(ref))
        assert np.max(np.abs(got - ref)) / (scale + 1e-300) < 1e-5, name


def test_cli_mesh_prints_backend_and_auto_pick(cli_runs):
    _, out0, out1 = cli_runs
    assert "distributed: backend gloo (CPU tensors); rank 0 of 2" in out0
    assert "distributed: backend gloo (CPU tensors); rank 1 of 2" in out1
    # single_group.prm is too thin for the halo: auto picks fused (BDF2).
    assert "auto engine: FusedExchangeCudaEngine" in out0
    assert "wrote 8 CSVs" in out0 and "wrote" not in out1


@pytest.mark.parametrize("extra,message", [
    (["--engine", "pallas", "--mesh", "1x2"], "needs 2 ranks"),
    (["--engine", "fused", "--mesh", "2x"], "--mesh must look like"),
    (["--engine", "fused", "--dtype", "float32", "--steps", "1",
      "--scan-tol", "1e-10"], None),
    (["--engine", "df", "--mesh", "1x1"],
     "--engine df infeasible for this mesh workload"),
])
def test_cli_mesh_exit_codes(tmp_path, capsys, extra, message):
    """A mesh of more ranks than run, a malformed mesh, fused's implied
    1x1 mesh (runs), and df on a mesh where its creep bound rejects the
    deck (an explicit --engine df has no fallback, as in JAX)."""
    rc = port_cli.main([GRAY, "--outdir", str(tmp_path), "--device", "cpu",
                        *extra])
    err = capsys.readouterr().err
    assert rc == (0 if message is None else 2), err
    if message:
        assert message in err
    assert bool(list(tmp_path.glob("*.csv"))) == (message is None)


# -- the process group ------------------------------------------------------------

def test_explicit_coordinator_failure_raises():
    """Explicit coordinator arguments that cannot be reached raise (the
    fail-fast policy), never fall back to a single process."""
    script = textwrap.dedent("""
        from radiative_transfer_tpu_torch.parallel import distributed
        try:
            distributed.initialize(coordinator_address="127.0.0.1:1",
                                   num_processes=2, process_id=1,
                                   timeout_s=2)
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("SWALLOWED")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "RAISED" in out.stdout, out.stdout + out.stderr[-2000:]


def test_single_process_initialize_is_a_no_op(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    info = port_dist.initialize(device_type="cpu")
    assert info == {"process_index": 0, "process_count": 1,
                    "backend": None}


def test_shutdown_alone_is_a_no_op():
    """Outside a process group, shutdown() leaves nothing to tear down."""
    assert not torch.distributed.is_initialized()
    port_dist.shutdown()
    assert not torch.distributed.is_initialized()


def test_backend_choice(monkeypatch):
    assert port_dist.choose_backend("cpu", 4)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_dist.choose_backend("cuda", 1)[0] == "nccl"
    backend, reason = port_dist.choose_backend("cuda", 2)
    assert backend == "gloo" and "share" in reason


def test_mesh_lines():
    """(g, x) rank order with x innermost: the lines each axis's groups
    are built from."""
    m = object.__new__(port_mesh.Mesh)
    m.shape, m.axis_names = {"g": 2, "x": 3}, ("g", "x")
    assert m._all_lines("x") == [(0, 1, 2), (3, 4, 5)]
    assert m._all_lines("g") == [(0, 3), (1, 4), (2, 5)]
