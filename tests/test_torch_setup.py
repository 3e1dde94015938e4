"""The PyTorch port's setup layer against the JAX package.

Config, the physics tables, the packed sweep coefficients and the flat
plane layout are host computations that the port keeps operation for
operation, so they must be BIT-equal to the JAX package's on every deck
in prm/. Diagnostics run in float64 on both sides and agree to float64
roundoff. The port must import with jax blocked.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import dataclasses
import glob
import os
import subprocess
import sys

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
DECKS = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(REPO, "prm", "*.prm")))


def _deck(name):
    return os.path.join(REPO, "prm", name)


def _host_tables(tables):
    return {k: np.asarray(v) for k, v in tables._asdict().items()}


def _assert_bit_equal(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.array_equal(got, ref), what


def test_decks_found():
    assert {"default.prm", "llnl_slab_test.prm", "single_group.prm",
            "multi_group_equilibrium.prm"} <= set(DECKS)


@pytest.mark.parametrize("deck", DECKS)
def test_config_bit_equal(deck):
    jcfg = jax_load_config(_deck(deck))
    pcfg = port.load_config(_deck(deck))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert (pcfg.dx, pcfg.beta) == (jcfg.dx, jcfg.beta)
    over = dict(M=4, N=64, ts_method=2, max_timesteps=7)
    assert dataclasses.asdict(port.load_config(_deck(deck), **over)) \
        == dataclasses.asdict(jax_load_config(_deck(deck), **over))


@pytest.mark.parametrize("deck", DECKS)
def test_build_tables_bit_equal(deck):
    jcfg = jax_load_config(_deck(deck))
    pcfg = port.load_config(_deck(deck))
    jt, jgrid, jct = jax_transport.build_tables(jcfg)
    pt, pgrid, pct = port_transport.build_tables(pcfg)
    for name in jt._fields:
        _assert_bit_equal(getattr(pt, name), getattr(jt, name), name)
    for name in jgrid._fields:
        _assert_bit_equal(getattr(pgrid, name), getattr(jgrid, name), name)
    for name in jct._fields:
        _assert_bit_equal(getattr(pct, name), getattr(jct, name), name)
    assert port_transport.validate_tables(pcfg, pct) \
        == jax_transport.validate_tables(jcfg, jct)
    # tables_from_numpy carries the JAX tables across unchanged.
    moved = port_transport.tables_from_numpy(_host_tables(jt))
    for name in jt._fields:
        _assert_bit_equal(getattr(moved, name), getattr(jt, name), name)


@pytest.mark.parametrize("deck", DECKS)
def test_engine_constants_bit_equal(deck):
    """Packed coefficients, scan pass counts, block choice, K, boundary
    planes and the reflective flip all match PallasEngine's."""
    jcfg = jax_load_config(_deck(deck))
    jt, _, _ = jax_transport.build_tables(jcfg)
    je = jax_ps.PallasEngine(jcfg, jt)
    pe = port_cs.CudaSweepEngine(
        port.load_config(_deck(deck)),
        port_transport.tables_from_numpy(_host_tables(jt)), device="cpu")
    assert sorted(pe.coef) == sorted(je.coef)
    for kind in je.coef:
        _assert_bit_equal(pe.coef[kind].numpy(), je.coef[kind], kind)
        _assert_bit_equal(port_cs._pack_coeffs(pe.kcs[kind]),
                          je.coef[kind], kind)
        assert pe.kcs[kind].s == je._fe.kcs[kind].s
    assert pe.scan_npass == je.scan_npass
    assert (pe.block, pe.nblocks) == (je.block, je.nblocks)
    assert pe.max_steps_per_launch() == je.max_steps_per_launch()
    assert pe.reflective == je.reflective
    _assert_bit_equal(pe.bc.numpy(), je.bc, "bc")
    _assert_bit_equal(pe.flip.numpy().astype(np.int64),
                      np.argmax(je.refl_P, axis=1), "flip")
    _assert_bit_equal(pe.init_state().e0.numpy(),
                      np.asarray(je.init_state().e0), "init_state")


@pytest.mark.parametrize("blk,a_max,tol", [
    (16, 0.3, 1e-10), (4096, 0.9, 1e-10), (64, 0.999, 1e-10),
    (128, 0.5, 0.0), (1, 0.5, 1e-10), (50, float("nan"), 1e-10),
])
def test_scan_helpers_equal(blk, a_max, tol):
    assert port_cs._scan_strides(blk) == jax_ps._scan_strides(blk)
    assert port_cs._scan_npass(a_max, blk, tol) \
        == jax_ps._scan_npass(a_max, blk, tol)
    if blk > 1:
        _assert_bit_equal(port_cs._scan_masks(blk), jax_ps._scan_masks(blk),
                          "masks")


@pytest.mark.parametrize("M,G,N", [(2, 1, 7), (4, 3, 16), (8, 2, 5)])
def test_flat_layout_bit_equal(M, G, N):
    """from_ends / ends_pair: mu<0 half N-reversed with its edges swapped,
    exactly as the JAX engines lay out their planes."""
    rng = np.random.default_rng(M * 100 + G * 10 + N)
    ends, prev, half = (rng.standard_normal((M, G, N, 2)).astype(np.float32)
                        for _ in range(3))
    cfg = jax_load_config(_deck("single_group.prm"), M=M, G=G, N=N)
    jt, _, _ = jax_transport.build_tables(cfg)
    jfe = jax_fs.FastEngine(cfg, jt, dtype=jnp.float32, chunk=N, pad=False)
    jst = jfe.from_ends(ends, prev, half)
    pe = port_cs.CudaSweepEngine(
        port.load_config(_deck("single_group.prm"), M=M, G=G, N=N),
        port_transport.tables_from_numpy(_host_tables(jt)), block=N,
        device="cpu")
    pst = pe.from_ends(torch.as_tensor(ends), torch.as_tensor(prev),
                       torch.as_tensor(half))
    for name in port_fs.FlatState._fields:
        _assert_bit_equal(getattr(pst, name).numpy(),
                          np.asarray(jfe.untile(getattr(jst, name))), name)
    _assert_bit_equal(pe.ends(pst).numpy(), ends, "round trip")
    _assert_bit_equal(pe.ends_pair(pst.h0, pst.h1).numpy(), half, "half")


@pytest.mark.parametrize("deck", ["llnl_slab_test.prm",
                                  "multi_group_equilibrium.prm"])
def test_result_from_ends_matches(deck):
    """Diagnostics in float64: the same reductions in another library,
    so they agree to float64 roundoff (1e-12 relative)."""
    jcfg = jax_load_config(_deck(deck))
    jt, _, _ = jax_transport.build_tables(jcfg)
    pcfg = port.load_config(_deck(deck))
    pt = port_transport.tables_from_numpy(_host_tables(jt))
    rng = np.random.default_rng(7)
    B = np.asarray(jt.B)[None, :, None, None]
    ends = B * rng.uniform(0.5, 1.5, (jcfg.M, jcfg.G, jcfg.N, 2))
    jr = jax_transport.result_from_ends(jcfg, jt, jnp.asarray(ends))
    pr = port_transport.result_from_ends(pcfg, pt, torch.as_tensor(ends))
    for name in port_transport.SolveResult._fields:
        got = getattr(pr, name).numpy()
        ref = np.asarray(getattr(jr, name))
        assert got.dtype == np.float64 and got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(ref)),
                                   err_msg=name)


def test_import_without_jax():
    """The port never imports jax nor the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import radiative_transfer_tpu_torch as rt\n"
        "from radiative_transfer_tpu_torch import cli\n"
        "from radiative_transfer_tpu_torch.ops import cuda_sweep, "
        "_cuda_build, cuda_df, df, cuda_adjoint, cuda_fused\n"
        "from radiative_transfer_tpu_torch import adjoint\n"
        "from radiative_transfer_tpu_torch.utils import io, profiling\n"
        "from radiative_transfer_tpu_torch.parallel import halo_cuda, "
        "df_halo_cuda, sharded_cuda, fused_exchange_cuda, step_response, "
        "mesh, distributed\n"
        "from radiative_transfer_tpu_torch.examples import _common, "
        "gray_equilibrium, multigroup_correction, llnl_production, "
        "reference_precision, inverse_opacity, uncertainty, multichip\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('jax', 'radiative_transfer_tpu')]\n"
        "assert not bad, bad\n"
        "cfg = rt.load_config('prm/single_group.prm')\n"
        "print('ok', cfg.N)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok 100"


@pytest.mark.parametrize("over,block", [
    (dict(M=32, G=1, N=1 << 20), None),            # bench.py shape
    (dict(M=8, G=4, N=12800), None),
    (dict(M=16, G=64, N=4096, ts_method=1), None),
    (dict(M=4, G=2, N=64, ts_method=2), 16),
    (dict(M=2, G=1, N=100), 16),                   # pinned, shrinks to 4
    (dict(M=4, G=1, N=96), None),                  # whole-N fallback
])
def test_block_and_steps_selection_equal(over, block):
    """The JAX engine's block auto-selection and K choice, kept as is."""
    jcfg = jax_load_config(_deck("single_group.prm"), **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    je = jax_ps.PallasEngine(jcfg, jt, block=block)
    pe = port_cs.CudaSweepEngine(
        port.load_config(_deck("single_group.prm"), **over),
        port_transport.tables_from_numpy(_host_tables(jt)), block=block,
        device="cpu")
    assert (pe.block, pe.nblocks, pe.scan_npass) \
        == (je.block, je.nblocks, je.scan_npass)
    assert pe.max_steps_per_launch() == je.max_steps_per_launch()
