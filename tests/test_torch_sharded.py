"""The port's per-sub-step mesh engine against the JAX package, on the CPU.

* Kernel: the plain version of B8 (``sharded_substep_launch_ref``) against
  the JAX factory ``_make_sharded_packed_kernel`` in interpret mode, built
  through ``ShardedPallasEngine._calls[kind]`` at a one-device mesh: BE, CN
  and BDF on packed rows of 4 blocks of 32 cells, nonzero pending
  corrections (the engine's own d0, a, ln_a) and halo tails, seeded numpy
  inputs fed to both. 1e-6.
* Engine: ``ShardedCudaEngine(device="cpu")`` against JAX
  ``ShardedPallasEngine`` at a one-device mesh (reflective BDF2, 3 steps):
  ends, prev and half within 1e-6.
* Ranks: ``ShardedCudaEngine`` on 1x4 and 2x2 meshes of gloo ranks
  (spawned processes, one thread each, no jax) against the port's
  ``CudaSweepEngine`` on ends, prev and half at JAX's own bar of 1e-5
  (tests/test_sharded_pallas.py), BDF2 both boundaries and half modes, BE
  and CN; the 1x4 BDF2 case also against JAX ``ShardedPallasEngine`` on a
  4-device virtual mesh (1e-6); the refusals (N not divisible by the
  spatial shards, Bh not divisible by the group shards), raised inside
  the ranks, whose meshes exist only there.

Tolerances: the plain versions keep the JAX kernel's blocks, truncated
scans and operation order, so against JAX only float32 rounding differs
(XLA's CPU compiler contracts multiply-adds); against the single-device
engine the deferred corrections and the shard chain fold reassociate the
recurrence, as in JAX's own mesh tests.
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
from radiative_transfer_tpu.parallel import sharded_pallas as jax_sp

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_sweep as port_cs
from radiative_transfer_tpu_torch.ops.fast_sweep import BDF, BE, CN
from radiative_transfer_tpu_torch.parallel.distributed import launch_local
from radiative_transfer_tpu_torch.parallel.sharded_cuda import (
    ShardedCudaEngine)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
TOL = 1e-6
MESH_TOL = 1e-5


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _over(M, **kw):
    """The gray deck at M directions off equilibrium (the boundary source
    above the medium's B), so that both boundaries drive the state."""
    return dict(M=M, psi_source=tuple((6.0,) for _ in range(M)), **kw)


def _compile(fn, *args):
    """fn jitted and compiled for args with XLA's backend optimisation
    off: each reference here runs once at a tiny size."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


# -- the JAX engine at a one-device mesh -------------------------------------

ONE = _over(4, N=128, ts_method=3, bc_left_indicator=2)
BLK = 32


@pytest.fixture(scope="module")
def jax_one():
    """JAX ShardedPallasEngine at a one-device mesh (interpret mode) and
    the port's engine for the same deck and block."""
    jcfg = jax_load_config(GRAY, **ONE)
    jt, _, _ = jax_transport.build_tables(jcfg)
    mesh1 = jax_sp.Mesh(np.asarray(jax.devices()[:1]), ("x",))
    je = jax_sp.ShardedPallasEngine(jcfg, jt, mesh1, block=BLK)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    pcfg = port.load_config(GRAY, **ONE)
    pt, _, _ = port_transport.build_tables(pcfg)
    pe = ShardedCudaEngine(pcfg, pt, block=BLK, device="cpu")
    return je, pe


@pytest.mark.parametrize("kind", [BE, CN, BDF], ids=["BE", "CN", "BDF"])
def test_b8_plain_matches_jax(jax_one, kind):
    je, pe = jax_one
    Bh, N = je.Bh_l, je.N_loc
    rows = 2 * Bh
    assert pe.nblocks == 4 and pe.block == je.block == BLK
    rng = np.random.default_rng(kind)
    B = float(np.asarray(je.tables.B)[0])
    n_corr, n_halo, n_planes = {BE: (1, 0, 2), CN: (2, 1, 3),
                                BDF: (3, 2, 6)}[kind]
    cc = je._tb[f"k{kind}"]["cc"]                          # (2, Bh, 3)
    corrs = [np.concatenate([B * rng.uniform(-1, 1, (2, Bh, 1)), cc],
                            axis=-1).astype(np.float32)
             for _ in range(n_corr)]
    halos = [(B * rng.uniform(0.5, 1.5, (2, Bh, 1))).astype(np.float32)
             for _ in range(n_halo)]
    planes = [(B * rng.uniform(0.5, 1.5, (2, Bh, N))).astype(np.float32)
              for _ in range(n_planes)]
    args = (je._tb[f"k{kind}"]["coef"], je.scan_masks, *corrs, *halos,
            *planes)
    call = _compile(lambda *a: je._calls[kind](*a), *args)
    want = [np.asarray(x) for x in call(*args)]

    def packed(x):
        return torch.as_tensor(x).reshape(rows, -1)

    got = port_cs.sharded_substep_launch(
        kind, pe.coef[kind], [packed(c) for c in corrs],
        [packed(h) for h in halos], [packed(p) for p in planes],
        blk=BLK, npass=pe.scan_npass[kind])
    assert pe.scan_npass[kind] == je.scan_npass[kind]
    for g, w in zip(got, want):
        assert _relerr(g.reshape(2, Bh, N).numpy(), w) < TOL


def test_engine_matches_jax_one_device(jax_one):
    je, pe = jax_one
    jst = je.solve(num_steps=3)
    pst = pe.solve(num_steps=3)
    assert _relerr(pe.ends(pst), je.ends(jst)) < TOL
    for got, want in zip(pe.prev_half_ends(pst), je.prev_half_ends(jst)):
        assert _relerr(got, want) < TOL


# -- gloo ranks ----------------------------------------------------------------

CASES = {
    # name: config overrides (M = 8: Bh = 4 splits over 2 group ranks)
    "bdf2-refl": dict(ts_method=3, bc_left_indicator=2),
    "bdf2-src-sym": dict(ts_method=3, bc_left_indicator=1,
                         bdf2_symmetric_half=True),
    "be-refl": dict(ts_method=1, bc_left_indicator=2),
    "cn-src": dict(ts_method=2, bc_left_indicator=1),
}
RANK_N, RANK_BLK, STEPS = 128, 16, 5

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import radiative_transfer_tpu_torch as port
    from radiative_transfer_tpu_torch.models import transport
    from radiative_transfer_tpu_torch.parallel import distributed, mesh
    from radiative_transfer_tpu_torch.parallel.sharded_cuda import (
        ShardedCudaEngine)
    out_path, ng, nx, deck, cases = sys.argv[1:6]
    ng, nx, cases = int(ng), int(nx), eval(cases)
    distributed.initialize(device_type="cpu")
    m = mesh.make_mesh_2d(ng, nx) if ng > 1 else mesh.make_mesh_1d(nx)
    out = {}
    for name, over in cases.items():
        cfg = port.load_config(deck, **over)
        tables, _, _ = transport.build_tables(cfg)
        eng = ShardedCudaEngine(cfg, tables, m, block=%(blk)d, device="cpu")
        st = eng.solve(num_steps=%(steps)d)
        out[name] = np.stack([eng.ends(st).numpy()]
                             + [x.numpy() for x in eng.prev_half_ends(st)])
    # Refusals, which need the mesh: N over the spatial shards, Bh over
    # the group shards.
    first = cases[next(iter(cases))]
    bad = (dict(first, N=%(n)d + 2) if ng == 1 else
           dict(first, M=2, psi_source=((6.0,), (6.0,))))
    cfg = port.load_config(deck, **bad)
    tables, _, _ = transport.build_tables(cfg)
    try:
        ShardedCudaEngine(cfg, tables, m, device="cpu")
    except ValueError as e:
        out["refusal"] = np.array(str(e))
    if m.rank == 0:
        np.savez(out_path, **out)
    distributed.shutdown()
""") % dict(blk=RANK_BLK, steps=STEPS, n=RANK_N)


def _cases():
    return {name: _over(8, N=RANK_N, **over) for name, over in CASES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mesh: results of rank 0} for 1x4 and 2x2 gloo meshes."""
    tmp = tmp_path_factory.mktemp("sharded_ranks")
    out = {}
    for ng, nx in ((1, 4), (2, 2)):
        path = tmp / f"{ng}x{nx}.npz"
        runs = launch_local(["-c", WORKER, str(path), str(ng), str(nx), GRAY,
                             repr(_cases())], ng * nx, cwd=REPO, timeout=240)
        for r in runs:
            assert r.returncode == 0, r.stderr[-3000:]
        out[f"{ng}x{nx}"] = dict(np.load(path))
    return out


def _single(name):
    cfg = port.load_config(GRAY, **_cases()[name])
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_cs.CudaSweepEngine(cfg, tables, device="cpu")
    st = eng.solve(num_steps=STEPS)
    return np.stack([eng.ends(st).numpy()]
                    + [x.numpy() for x in eng.prev_half_ends(st)])


@pytest.mark.parametrize("mesh_shape", ["1x4", "2x2"])
@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_single_device(ranks, mesh_shape, name):
    got, want = ranks[mesh_shape][name], _single(name)
    for g, w in zip(got, want):                     # ends, prev, half
        assert _relerr(g, w) < MESH_TOL


def test_ranks_1x4_match_jax_virtual_mesh(ranks):
    over = _cases()["bdf2-refl"]
    jcfg = jax_load_config(GRAY, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    mesh4 = jax_sp.Mesh(np.asarray(jax.devices()[:4]), ("x",))
    je = jax_sp.ShardedPallasEngine(jcfg, jt, mesh4, block=RANK_BLK)
    jst = je.solve(num_steps=STEPS)
    want = [np.asarray(je.ends(jst))] + [np.asarray(x) for x in
                                         je.prev_half_ends(jst)]
    for g, w in zip(ranks["1x4"]["bdf2-refl"], want):
        assert _relerr(g, w) < TOL


@pytest.mark.parametrize("mesh_shape,message", [
    ("1x4", "does not split evenly over 4 spatial shards"),
    ("2x2", "not divisible by 2 group shards")])
def test_refusals(ranks, mesh_shape, message):
    assert message in str(ranks[mesh_shape]["refusal"])


def test_wrapper_never_falls_back():
    """A tensor on a device with no kernel raises; only the CPU runs the
    plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs B8")
    x = torch.zeros((4, 8), device="meta")
    c = torch.zeros((4, 10), device="meta")
    corr = torch.zeros((4, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cs.sharded_substep_launch(BE, c, [corr], [], [x, x], blk=8,
                                       npass=3)
