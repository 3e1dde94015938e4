"""The port's single-exchange fused BDF2 mesh engine against the JAX
package, on the CPU.

* Host map: the port's parallel/step_response.py bit-equal to JAX's
  (profiles and the outflow map M) on the gray deck and the LLNL deck.
* Kernel: the plain version of B13 (``fused_step_launch_ref``), both
  variants, against the JAX factory ``_make_fused_step_kernel`` in
  interpret mode, built through ``FusedExchangeEngine`` at a one-device
  mesh: packed rows of 4 blocks of 32 cells, seeded numpy unknowns v and
  zero-boundary planes. 1e-6.
* Engine: ``FusedExchangeCudaEngine(device="cpu")`` against the port's
  ``CudaSweepEngine`` at one rank and on a 1x4 mesh of gloo ranks
  (spawned processes, one thread each, no jax), ends, prev and half at
  JAX's own bar of 1e-5 (tests/test_fused_exchange.py), the LLNL deck at
  its shipped dt = 1e-3 included (the untruncatable regime the engine
  exists for); the from_ends round trip; the BE/CN refusal.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import os
import textwrap

import jax
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import fast_sweep as jax_fs
from radiative_transfer_tpu.parallel import fused_exchange as jax_fx
from radiative_transfer_tpu.parallel import step_response as jax_sr

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_fused as port_cf
from radiative_transfer_tpu_torch.ops import cuda_sweep as port_cs
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs
from radiative_transfer_tpu_torch.parallel import step_response as port_sr
from radiative_transfer_tpu_torch.parallel.distributed import launch_local
from radiative_transfer_tpu_torch.parallel.fused_exchange_cuda import (
    FusedExchangeCudaEngine)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
LLNL = os.path.join(REPO, "prm", "llnl_slab_test.prm")
TOL = 1e-6
MESH_TOL = 1e-5


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _gray(M, **kw):
    """The gray deck at M directions off equilibrium."""
    return dict(M=M, psi_source=tuple((6.0,) for _ in range(M)), **kw)


def _compile(fn, *args):
    """fn jitted and compiled for args with XLA's backend optimisation
    off: each reference here runs once at a tiny size."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


# -- the host outflow map ------------------------------------------------------

@pytest.mark.parametrize("deck,over", [
    (GRAY, _gray(4, N=64, bc_left_indicator=2)),
    (LLNL, dict(N=32)),
], ids=["gray", "llnl"])
def test_step_response_bit_equal(deck, over):
    pcfg = port.load_config(deck, **over)
    pt, _, _ = port_transport.build_tables(pcfg)
    jcfg = jax_load_config(deck, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    half = pcfg.dt / 2.0
    Bh = (pcfg.M // 2) * pcfg.G
    pkr = {k: port_sr.kind_rows(port_fs.build_kind_coeffs(
        pcfg, pt, k, half, np.float32)) for k in (1, 2, 3)}
    jkr = {k: jax_sr.kind_rows(jax_fs.build_kind_coeffs(
        jcfg, jt, k, half, np.float32)) for k in (1, 2, 3)}
    for k in pkr:
        for a, b in zip(pkr[k], jkr[k]):
            np.testing.assert_array_equal(a, b)
    got = port_sr.bdf2_cycle_response(pkr, Bh, pcfg.N, False, chunk=24)
    want = jax_sr.bdf2_cycle_response(jkr, Bh, pcfg.N, False, chunk=24)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- the kernel ----------------------------------------------------------------

ONE = _gray(4, N=128, ts_method=3, bc_left_indicator=2)
BLK = 32


@pytest.fixture(scope="module")
def jax_one():
    """JAX FusedExchangeEngine at a one-device mesh (interpret mode) and
    the port's engine for the same deck and block."""
    jcfg = jax_load_config(GRAY, **ONE)
    jt, _, _ = jax_transport.build_tables(jcfg)
    mesh1 = jax_fx.Mesh(np.asarray(jax.devices()[:1]), ("x",))
    je = jax_fx.FusedExchangeEngine(jcfg, jt, mesh1, block=BLK)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    pcfg = port.load_config(GRAY, **ONE)
    pt, _, _ = port_transport.build_tables(pcfg)
    pe = FusedExchangeCudaEngine(pcfg, pt, block=BLK, device="cpu")
    return je, pe


@pytest.mark.parametrize("materialize_only", [False, True],
                         ids=["step", "materialize"])
def test_b13_plain_matches_jax(jax_one, materialize_only):
    je, pe = jax_one
    Bh, N = je.Bh_l, je.N_loc
    rows = 2 * Bh
    assert pe.nblocks == 4 and pe.block == je.block == BLK
    assert pe.scan_npass == je.scan_npass
    rng = np.random.default_rng(int(materialize_only))
    B = float(np.asarray(je.tables.B)[0])
    v = (B * rng.uniform(-1, 1, (2, Bh, port_cf.NV))).astype(np.float32)
    z0, z1 = ((B * rng.uniform(0.5, 1.5, (2, Bh, N))).astype(np.float32)
              for _ in range(2))
    call = je._build_call(materialize_only=materialize_only)
    tb = {k: je._tb[k] for k in ("k1", "k2", "k3")}
    fn = _compile(lambda t, *a: call(t, *a), tb, v, z0, z1)
    out = fn(tb, v, z0, z1)
    want = ([np.asarray(x) for x in out] if materialize_only else
            [np.asarray(x) for x in out[0]] + [np.asarray(out[1])])

    def packed(x):
        return torch.as_tensor(x).reshape(rows, -1)

    got = port_cf.fused_step_launch(
        pe.coef[1], pe.coef[2], pe.coef[3], packed(v), packed(z0),
        packed(z1), symmetric_half=False, blk=BLK, npass=pe.scan_npass,
        materialize_only=materialize_only)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _relerr(g.numpy().reshape(w.shape), w) < TOL


# -- the engine ------------------------------------------------------------------

CASES = {
    # name: (deck, config overrides, steps, block)
    "gray-refl": (GRAY, _gray(8, N=128, bc_left_indicator=2), 4, 16),
    "gray-src-sym": (GRAY, _gray(8, N=128, bc_left_indicator=1,
                                 bdf2_symmetric_half=True), 3, 16),
    "llnl-shipped-dt": (LLNL, dict(N=32), 2, 4),
}


def _single(name):
    deck, over, steps, _ = CASES[name]
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_cs.CudaSweepEngine(cfg, tables, device="cpu")
    st = eng.solve(num_steps=steps)
    return np.stack([eng.ends(st).numpy()]
                    + [x.numpy() for x in eng.prev_half_ends(st)])


def _fused(name, mesh=None):
    deck, over, steps, blk = CASES[name]
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    eng = FusedExchangeCudaEngine(cfg, tables, mesh, block=blk, device="cpu")
    st = eng.solve(num_steps=steps)
    return np.stack([eng.ends(st).numpy()]
                    + [x.numpy() for x in eng.prev_half_ends(st)])


def test_llnl_is_shipped_dt():
    cfg = port.load_config(LLNL)
    assert cfg.dt == 1e-3 and cfg.ts_method == 3


@pytest.mark.parametrize("name", list(CASES))
def test_one_rank_matches_single_device(name):
    for g, w in zip(_fused(name), _single(name)):      # ends, prev, half
        assert _relerr(g, w) < MESH_TOL


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import radiative_transfer_tpu_torch as port
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import distributed, mesh
    from radiative_transfer_tpu_torch.parallel.fused_exchange_cuda import (
        FusedExchangeCudaEngine)
    out_path, cases = sys.argv[1], eval(sys.argv[2])
    distributed.initialize(device_type="cpu")
    m = mesh.make_mesh_1d(4)
    out = {}
    for name, (deck, over, steps, blk) in cases.items():
        cfg = port.load_config(deck, **over)
        tables, _, _ = transport.build_tables(cfg)
        eng = FusedExchangeCudaEngine(cfg, tables, m, block=blk,
                                      device="cpu")
        st = eng.solve(num_steps=steps)
        out[name] = np.stack([eng.ends(st).numpy()]
                             + [x.numpy() for x in eng.prev_half_ends(st)])
    if m.rank == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results on a 1x4 mesh of gloo ranks."""
    path = tmp_path_factory.mktemp("fused_ranks") / "1x4.npz"
    runs = launch_local(["-c", WORKER, str(path), repr(CASES)], 4, cwd=REPO,
                        timeout=240)
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_1x4_match_single_device(ranks, name):
    for g, w in zip(ranks[name], _single(name)):
        assert _relerr(g, w) < MESH_TOL


def test_from_ends_round_trip():
    """A state handed over mid-run with from_ends continues like the
    single-device engine from the same state."""
    deck, over, _, blk = CASES["gray-refl"]
    cfg = port.load_config(deck, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    ref = port_cs.CudaSweepEngine(cfg, tables, device="cpu")
    st = ref.solve(num_steps=2)
    ends, (prev, half) = ref.ends(st), ref.prev_half_ends(st)
    eng = FusedExchangeCudaEngine(cfg, tables, block=blk, device="cpu")
    fst = eng.from_ends(ends, prev, half)
    assert torch.equal(eng.ends(fst), ends)
    for got, want in zip(eng.prev_half_ends(fst), (prev, half)):
        assert torch.equal(got, want)
    fst = eng.solve(fst, num_steps=2)
    st = ref.solve(st, num_steps=2)
    assert _relerr(eng.ends(fst), ref.ends(st)) < MESH_TOL
    for got, want in zip(eng.prev_half_ends(fst), ref.prev_half_ends(st)):
        assert _relerr(got, want) < MESH_TOL


@pytest.mark.parametrize("ts_method", [1, 2])
def test_refuses_be_cn(ts_method):
    cfg = port.load_config(GRAY, **_gray(4, N=64, ts_method=ts_method))
    tables, _, _ = port_transport.build_tables(cfg)
    with pytest.raises(ValueError, match="BDF2"):
        FusedExchangeCudaEngine(cfg, tables, device="cpu")


def test_wrapper_never_falls_back():
    """A tensor on a device with no kernel raises; only the CPU runs the
    plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs B13")
    z = torch.zeros((4, 8), device="meta")
    c = torch.zeros((4, 10), device="meta")
    v = torch.zeros((4, 7), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cf.fused_step_launch(c, c, c, v, z, z, symmetric_half=False,
                                  blk=8, npass={1: 3, 2: 3, 3: 3})
