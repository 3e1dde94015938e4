"""The port's sweep kernels (plain PyTorch versions) against the JAX
Pallas kernels in interpret mode, on the CPU.

B3 (``_make_kernel``, one sub-step), B2 (``_make_multistep_kernel``, K
BE/CN steps) and B1 (``_make_bdf2_kernel``, K BDF2 steps) each get the
same seeded numpy state on both sides, at N=64 with block=16 (four
blocks, so the inter-block carries and tails run) for both boundary
kinds and both half-snapshot modes, and on the whole-N LLNL deck (N=50,
Bh=124, values over ~10 orders of magnitude).

Tolerance 1e-6 of the reference's largest magnitude: the plain versions
run the JAX kernels' blocked algorithm with the same blocks, the same
truncated scan passes and the same operation order, so only float32
rounding differs (XLA's CPU compiler contracts multiply-adds and fuses
the interpreted kernel body; measured differences are a few ulps,
~2e-7 after several sub-steps).
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import fast_sweep as jax_fs
from radiative_transfer_tpu.ops import pallas_sweep as jax_ps

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_sweep as port_cs
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _engines(deck, block=None, **over):
    path = os.path.join(REPO, "prm", deck)
    jcfg = jax_load_config(path, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    je = jax_ps.PallasEngine(jcfg, jt, block=block)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    pe = port_cs.CudaSweepEngine(port.load_config(path, **over), pt,
                                 block=block, device="cpu")
    assert (pe.block, pe.scan_npass) == (je.block, je.scan_npass)
    return je, pe


def _states(pe, seed):
    """The same random state on both sides: each plane is B_row times a
    seeded factor in [0.5, 1.5), so every row keeps its own scale."""
    rng = np.random.default_rng(seed)
    base = pe.init_state().e0.numpy()
    planes = [(base * rng.uniform(0.5, 1.5, base.shape)).astype(np.float32)
              for _ in range(6)]
    return (jax_fs.FlatState(*map(jnp.asarray, planes)),
            port_fs.FlatState(*map(torch.as_tensor, planes)))


def _compare(got, ref, names):
    for name, g, r in zip(names, got, ref):
        err = _relerr(g.numpy(), np.asarray(r))
        assert err < TOL, (name, err)


def _mg(ts_method, reflective, symmetric=False):
    """4 directions x 2 groups (Bh=4, so the reflective flip permutes),
    N=64 in four blocks of 16."""
    return _engines("multi_group_equilibrium.prm", block=16, N=64, M=4,
                    G=2, ts_method=ts_method,
                    bc_left_indicator=2 if reflective else 1,
                    bdf2_symmetric_half=symmetric)


@pytest.fixture(scope="module")
def bdf2_reflective():
    return _mg(3, reflective=True)


@pytest.mark.parametrize("kind", [port_fs.BE, port_fs.CN, port_fs.BDF])
def test_substep_b3(bdf2_reflective, kind):
    je, pe = bdf2_reflective
    assert pe.reflective
    jst, pst = _states(pe, seed=kind)
    _compare(pe.substep(kind, pst), je.substep(kind, jst), ("e0", "e1"))


@pytest.mark.parametrize("ts_method,K,reflective", [
    (1, 1, True), (1, 3, False), (2, 1, False), (2, 3, True),
])
def test_multi_step_b2(ts_method, K, reflective):
    je, pe = _mg(ts_method, reflective)
    assert pe.reflective == reflective
    jst, pst = _states(pe, seed=10 + K)
    got, ref = pe.multi_step(pst, K), je.multi_step(jst, K)
    _compare(got[:4], ref[:4], ("e0", "e1", "p0", "p1"))


@pytest.mark.parametrize("K,reflective,symmetric", [
    (1, True, False), (3, True, False), (3, False, True),
])
def test_multi_step_b1(K, reflective, symmetric):
    je, pe = _mg(3, reflective, symmetric)
    assert pe.reflective == reflective
    jst, pst = _states(pe, seed=20 + K)
    _compare(pe.multi_step(pst, K), je.multi_step(jst, K),
             port_fs.FlatState._fields)


def test_step_b3_be_cn_matches_multistep():
    """step() for BE/CN goes through the sub-step kernel: one step equals
    the K=1 multi-step launch (identical arithmetic)."""
    for ts_method in (1, 2):
        _, pe = _mg(ts_method, reflective=True)
        _, pst = _states(pe, seed=ts_method)
        one = pe.step(pst)
        fused = pe.multi_step(pst, 1)
        for a, b in zip(one[:4], fused[:4]):
            assert torch.equal(a, b)


def test_solve_body_and_tail(bdf2_reflective):
    """solve(): two fused K=2 launches and a K=1 tail from init_state."""
    je, pe = bdf2_reflective
    jst = je.solve(num_steps=5, steps_per_launch=2)
    pst = pe.solve(num_steps=5, steps_per_launch=2)
    _compare(pst, jst, port_fs.FlatState._fields)
    assert _relerr(pe.ends(pst).numpy(), np.asarray(je.ends(jst))) < TOL


def test_llnl_whole_n_b1():
    """The LLNL deck runs as one whole-N block (N=50, no power-of-two
    block), optically thick, values over ~10 orders of magnitude."""
    je, pe = _engines("llnl_slab_test.prm")
    assert pe.block == pe.cfg.N == 50 and pe.Bh == 124
    jst, pst = _states(pe, seed=3)
    _compare(pe.multi_step(pst, 1), je.multi_step(jst, 1),
             port_fs.FlatState._fields)


def test_wrappers_never_fall_back():
    """A tensor on a device with no kernel raises; nothing reroutes it to
    the plain version."""
    _, pe = _mg(2, reflective=True)
    meta = torch.empty((2, pe.Bh, 64), device="meta")
    coef = pe.coef[port_fs.CN].to("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cs.multistep_launch(port_fs.CN, coef, pe.bc.to("meta"),
                                 pe.flip.to("meta"), meta, meta, K=1, s=2.0,
                                 reflective=True, blk=16, npass=1)


def test_cuda_engine_needs_a_card(monkeypatch):
    """Without a CUDA device (or nvcc) the CUDA path raises; nothing falls
    back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs this path")
    cfg = port.load_config(os.path.join(REPO, "prm", "single_group.prm"))
    tables, _, _ = port_transport.build_tables(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        port_cs.CudaSweepEngine(cfg, tables, device="cuda")
    from radiative_transfer_tpu_torch.ops import _cuda_build

    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build._nvcc()
