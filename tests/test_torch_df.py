"""The port's f64-grade path against the JAX package, on the CPU.

* Primitives: ``ops/df.py``'s error-free transforms exact against float64
  and bit-equal to the JAX ``ops/df.py``; the host packing bit-equal.
* Setup: the double-float coefficient packs bit-equal to JAX on every
  shipped deck; the block walk, the whole-N gate and the fusion depth
  equal to JAX over a grid of shapes.
* Kernels: the plain versions of B6 (``df_bdf2_launch_ref``) and B7
  (``df_multistep_launch_ref``) against the JAX factories
  ``_make_df_bdf2_kernel`` / ``_make_df_multistep_kernel`` in interpret
  mode, built through ``DFPallasEngine._build_*_call``: S_4 gray, 4 blocks
  of 32 cells, K = 1 for B6 (4 phase slots; the engine cases run it at
  K = 2 and 4) and K = 2 for B7, reflective and source left boundaries,
  both half-snapshot modes, seeded numpy (hi, lo) states fed to both.
* Engine: ``DFCudaEngine(device="cpu")`` against the JAX float64
  FastEngine on the cases of tests/test_df_sweep.py.
* Selection and CLI, with the one routing divergence from JAX named
  (tests/test_torch_df_halo.py holds the tiny-batch df halo route).

Tolerances. Per launch and per solve, 1e-11 of the reference's largest
magnitude in hi + lo summed in float64 (the JAX engine's own bar against
float64, tests/test_df_sweep.py): both sides run the same blocked
algorithm, and only the rounding of the base solve and of the error terms
differs (XLA's CPU compiler contracts multiply-adds where eager PyTorch
rounds each operation), which the residual absorbs far below 1e-11. The
CLI's CSVs against the JAX CLI's float64 general engine: 1e-10.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import contextlib
import io
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from radiative_transfer_tpu import cli as jax_cli
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu import parallel as jax_parallel
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import df as jax_df
from radiative_transfer_tpu.ops import df_sweep as jax_dfs
from radiative_transfer_tpu.ops import fast_sweep as jax_fs
from radiative_transfer_tpu.parallel import df_halo as jax_df_halo

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch import parallel as port_parallel
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_df as port_cd
from radiative_transfer_tpu_torch.ops import df as port_df
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs
from radiative_transfer_tpu_torch.parallel.df_halo_cuda import (
    DFHaloCudaEngine)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-11
GRAY = os.path.join(REPO, "prm", "single_group.prm")
DECKS = sorted(d for d in os.listdir(os.path.join(REPO, "prm"))
               if d.endswith(".prm"))
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")


def _deck(name):
    return os.path.join(REPO, "prm", name)


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _df_err(got, ref):
    """Largest error of the (hi, lo) plane pairs, hi + lo in float64."""
    errs = []
    for i in range(0, len(ref), 2):
        r = np.asarray(ref[i], np.float64) + np.asarray(ref[i + 1], np.float64)
        g = got[i].double().numpy() + got[i + 1].double().numpy()
        errs.append(_relerr(g, r))
    return max(errs)


def _compile(fn, *args):
    """The jitted fn compiled for args with XLA's backend optimisation off:
    each reference here runs once at a tiny size, so compiling is nearly
    all its cost."""
    return fn.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# -- primitives ----------------------------------------------------------------

@pytest.fixture(scope="module")
def eft_inputs():
    rng = np.random.default_rng(3)
    a = (rng.uniform(-4, 4, 512) * 10.0 ** rng.integers(-6, 6, 512))
    b = (rng.uniform(-4, 4, 512) * 10.0 ** rng.integers(-6, 6, 512))
    return a.astype(np.float32), b.astype(np.float32)


def test_eft_primitives_exact(eft_inputs):
    a, b = eft_inputs
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    s, e = port_df.two_sum(ta, tb)
    assert np.array_equal(s.double().numpy() + e.double().numpy(), a64 + b64)
    h, l = port_df.split(ta)
    assert np.array_equal(h.double().numpy() + l.double().numpy(), a64)
    # The split parts multiply exactly in float32.
    assert np.array_equal((h * h).double().numpy(),
                          h.double().numpy() * h.double().numpy())
    p, pe = port_df.two_prod(ta, tb)
    assert np.array_equal(p.double().numpy() + pe.double().numpy(),
                          a64 * b64)
    hb, lb = port_df.split(tb)
    assert np.array_equal(port_df.prod_err(p, h, l, hb, lb).numpy(),
                          pe.numpy())


def test_eft_primitives_bit_equal_jax(eft_inputs):
    a, b = eft_inputs
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [(port_df.two_sum(ta, tb), jax_df.two_sum(ja, jb)),
             (port_df.split(ta), jax_df.split(ja)),
             (port_df.two_prod(ta, tb), jax_df.two_prod(ja, jb)),
             (port_df.renorm(ta, tb), jax_df.renorm(ja, jb))]
    for got, ref in pairs:
        for g, r in zip(got, ref):
            assert np.array_equal(_bits(g.numpy()), _bits(r))


def test_host_packing_bit_equal_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-3, 3, 256) * 10.0 ** rng.integers(-9, 9, 256)
    for got, ref in ((port_df.np_df(x), jax_df.np_df(x)),
                     (port_df.np_split(x.astype(np.float32)),
                      jax_df.np_split(x.astype(np.float32)))):
        for g, r in zip(got, ref):
            assert np.array_equal(_bits(g), _bits(r))
    assert port_df.SPLITTER == jax_df.SPLITTER


# -- setup ---------------------------------------------------------------------

@pytest.mark.parametrize("deck", DECKS)
def test_df_coeff_packs_bit_equal_jax(deck):
    jcfg = jax_load_config(_deck(deck))
    jt, _, _ = jax_transport.build_tables(jcfg)
    pcfg = port.load_config(_deck(deck))
    pt, _, _ = port_transport.build_tables(pcfg)
    for kind in (port_fs.BE, port_fs.CN, port_fs.BDF):
        ts = pcfg.dt / 2.0 if kind == port_fs.BDF else pcfg.dt
        got = port_cd._pack_df_coeffs(pcfg, pt, kind, ts)
        ref = jax_dfs._pack_df_coeffs(jcfg, jt, kind, ts)
        assert got.shape == ref.shape == (2, (pcfg.M // 2) * pcfg.G,
                                          port_cd._NDF)
        assert np.array_equal(_bits(got), _bits(ref)), (deck, kind)


def _shapes():
    for M in (2, 8, 32):
        for G in (1, 4, 64):
            for N in (50, 100, 1001, 4096, 12800, 1 << 18):
                yield M, G, N


def test_block_walk_and_depth_equal_jax():
    """select_block (auto and pinned), whole_n_feasible and
    max_steps_per_launch over (M, G, N, ts_method)."""
    n = 0
    for M, G, N in _shapes():
        over = dict(M=M, G=G, N=N,
                    psi_source=tuple((4.0931,) * G for _ in range(M)))
        jcfg = jax_load_config(GRAY, **over)
        pcfg = port.load_config(GRAY, **over)
        for block in (None, 64, 256):
            for interpret in (False, True):
                assert (port_cd.select_block(pcfg, block, interpret)
                        == jax_dfs.select_block(jcfg, block, interpret))
        assert port_cd.whole_n_feasible(pcfg) == jax_dfs.whole_n_feasible(
            jcfg)
        blk = port_cd.select_block(pcfg)
        for ts in (1, 2, 3):
            ns = types.SimpleNamespace(
                cfg=types.SimpleNamespace(ts_method=ts), Bh=(M // 2) * G,
                block=blk)
            assert (port_cd.DFCudaEngine.max_steps_per_launch(ns)
                    == jax_dfs.DFPallasEngine.max_steps_per_launch(ns))
            n += 1
    assert n == 3 * 3 * 6 * 3


# -- kernels -------------------------------------------------------------------

KERNEL_CASES = {
    # name: (config overrides of the gray deck at M = 4, Bh = 2, where the
    # flip permutes; steps a launch)
    "bdf2-refl-asym": (dict(ts_method=3, bc_left_indicator=2), 1),
    "bdf2-src-sym": (dict(ts_method=3, bc_left_indicator=1,
                          bdf2_symmetric_half=True), 1),
    "be-refl": (dict(ts_method=1, bc_left_indicator=2), 2),
    "cn-src": (dict(ts_method=2, bc_left_indicator=1), 2),
}
BLK = 32


def _kernel_pair(name):
    """(JAX DFPallasEngine, its compiled K-step call, the port's engine,
    K)."""
    over, K = KERNEL_CASES[name]
    over = dict(M=4, N=4 * BLK, X=1.28, **over)
    jcfg = jax_load_config(GRAY, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    je = jax_dfs.DFPallasEngine(jcfg, jt, block=BLK)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    pcfg = port.load_config(GRAY, **over)
    pt, _, _ = port_transport.build_tables(pcfg)
    pe = port_cd.DFCudaEngine(pcfg, pt, block=BLK, device="cpu")
    assert (pe.block, pe.scan_npass, pe.corr_npass, pe.reflective) == (
        je.block, je.scan_npass, je.corr_npass, je.reflective)
    ts = jcfg.ts_method
    call = (je._build_bdf2_call(K) if ts == 3
            else je._build_multistep_call(ts, K))
    return je, call, pe, K


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_df_kernel_plain_matches_jax(name):
    je, call, pe, K = _kernel_pair(name)
    ts = pe.cfg.ts_method
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(name))
    B = float(np.asarray(je.tables.B)[0])
    shape = (2, pe.Bh, pe.cfg.N)
    his = [(B * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
           for _ in range(2)]
    los = [(h * rng.uniform(-1, 1, shape) * 2.0 ** -25).astype(np.float32)
           for h in his]
    ins = [his[0], los[0], his[1], los[1]]
    one = jnp.ones((1, 1), jnp.float32)
    pins = [torch.as_tensor(x) for x in ins]
    kw = dict(K=K, reflective=pe.reflective,
              use_corr=bool(pe.cfg.use_correction), blk=BLK)
    if ts == 3:
        args = (*(je.coef[k] for k in (1, 2, 3)),
                *(je.dcoef[k] for k in (1, 2, 3)), je.bc, je.bcl, je.refl_P,
                je.scan_masks, one, *ins)
        ref = _compile(call, *args)(*args)
        got = port_cd.df_bdf2_launch(
            *(pe.coef[k] for k in (1, 2, 3)),
            *(pe.dcoef[k] for k in (1, 2, 3)), pe.bc, pe.bcl, pe.flip,
            *pins, symmetric_half=pe.cfg.bdf2_symmetric_half,
            npass=pe.scan_npass, npass_c=pe.corr_npass, **kw)
    else:
        args = (je.coef[ts], je.dcoef[ts], je.bc, je.bcl, je.refl_P,
                je.scan_masks, one, *ins)
        ref = _compile(call, *args)(*args)
        got = port_cd.df_multistep_launch(
            ts, pe.coef[ts], pe.dcoef[ts], pe.bc, pe.bcl, pe.flip, *pins,
            npass=pe.scan_npass[ts], npass_c=pe.corr_npass[ts], **kw)
    assert len(got) == len(ref) == (12 if ts == 3 else 8)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float32
    assert _df_err(got, ref) < TOL


def test_df_wrappers_never_fall_back():
    """A tensor on a device with no kernel raises; nothing reroutes it to
    the plain version."""
    meta = torch.empty((2, 4, 64), device="meta")
    coef = torch.empty((2, 4, 10), device="meta")
    dcoef = torch.empty((2, 4, port_cd._NDF), device="meta")
    bc = torch.empty((2, 4, 1), device="meta")
    flip = torch.empty((4,), dtype=torch.int32, device="meta")
    kw = dict(K=2, reflective=True, use_corr=True, blk=16)
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cd.df_multistep_launch(port_fs.CN, coef, dcoef, bc, bc, flip,
                                    meta, meta, meta, meta, npass=1,
                                    npass_c=1, **kw)
    npass = {k: 1 for k in (1, 2, 3)}
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cd.df_bdf2_launch(coef, coef, coef, dcoef, dcoef, dcoef, bc, bc,
                               flip, meta, meta, meta, meta,
                               symmetric_half=False, npass=npass,
                               npass_c=npass, **kw)


# -- engine --------------------------------------------------------------------

_F64 = {}


def _f64_ends(deck, steps, over):
    """The JAX float64 FastEngine's ends after `steps` steps (its step loop
    compiled once per problem, the step count an argument)."""
    cfg = jax_load_config(_deck(deck), **over)
    if cfg not in _F64:
        tables, _, _ = jax_transport.build_tables(cfg)
        eng = jax_fs.FastEngine(cfg, tables, dtype=jnp.float64)
        st0 = eng.init_state()
        run = _compile(jax.jit(lambda s, n: eng.ends(lax.fori_loop(
            0, n, lambda _, x: eng.step(x), s))), st0, 0)
        _F64[cfg] = (run, st0)
    run, st0 = _F64[cfg]
    return np.asarray(run(st0, steps))


GRAY_SMALL = dict(M=8, N=128, X=1.28)


@pytest.mark.parametrize("deck,steps,over,K,block", [
    ("single_group.prm", 4, dict(GRAY_SMALL, ts_method=1), None, None),
    ("single_group.prm", 4, dict(GRAY_SMALL, ts_method=2), None, None),
    ("single_group.prm", 4, dict(GRAY_SMALL, ts_method=3), None, None),
    ("single_group.prm", 8, GRAY_SMALL, 2, None),
    ("single_group.prm", 8, GRAY_SMALL, 4, None),
    ("single_group.prm", 4, dict(M=8, N=256, X=2.56), None, 256),
    ("single_group.prm", 4, dict(M=8, N=256, X=2.56), None, 64),
    ("multi_group_equilibrium.prm", 4, dict(N=64), None, None),
    ("llnl_slab_test.prm", 2, {}, None, None),
    ("single_group.prm", 3, dict(GRAY_SMALL, ts_method=1,
                                 bc_left_indicator=0), None, None),
    ("single_group.prm", 3, dict(GRAY_SMALL, ts_method=1,
                                 bc_left_indicator=1), None, None),
    ("single_group.prm", 3, dict(GRAY_SMALL, ts_method=1,
                                 bc_left_indicator=2), None, None),
], ids=["gray-BE", "gray-CN", "gray-BDF2", "fused-K2", "fused-K4",
        "block256", "block64", "multigroup-correction", "llnl",
        "bc-vacuum", "bc-source", "bc-reflective"])
def test_df_engine_matches_jax_f64(deck, steps, over, K, block):
    ref = _f64_ends(deck, steps, over)
    cfg = port.load_config(_deck(deck), **over)
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_cd.DFCudaEngine(cfg, tables, block=block, device="cpu")
    if block is not None:
        assert eng.block == block
    ends = eng.ends(eng.solve(num_steps=steps, steps_per_launch=K))
    assert ends.dtype == torch.float64 and ends.shape == ref.shape
    assert _relerr(ends.numpy(), ref) < TOL


def test_df_engine_from_ends_round_trip():
    cfg = port.load_config(GRAY, **GRAY_SMALL)
    tables, _, _ = port_transport.build_tables(cfg)
    eng = port_cd.DFCudaEngine(cfg, tables, device="cpu")
    rng = np.random.default_rng(7)
    shape = (cfg.M, cfg.G, cfg.N, 2)
    ends, prev, half = (rng.uniform(0.5, 4.0, shape) for _ in range(3))
    st = eng.from_ends(ends, prev, half)
    # hi + lo reproduces the float64 input to double-float accuracy.
    for got, ref in zip((eng.ends(st), *eng.prev_half_ends(st)),
                        (ends, prev, half)):
        assert np.max(np.abs(got.numpy() - ref)) < 1e-12
    # and the state steps: two steps from the round trip equal two steps
    # from the state itself.
    a = eng.ends(eng.solve(st, num_steps=2)).numpy()
    b = eng.ends(eng.solve(eng.from_ends(*(x.numpy() for x in (
        eng.ends(st), *eng.prev_half_ends(st)))), num_steps=2)).numpy()
    assert np.all(np.isfinite(a)) and _relerr(b, a) < 1e-14


# -- selection -----------------------------------------------------------------

def _thick(M, **kw):
    """The gray deck at M directions with thick cells (dx = 0.04 at
    N = 1024), which JAX's df halo creep bound admits."""
    return dict(M=M, X=40.96, N=1024,
                psi_source=tuple((4.0931,) for _ in range(M)), **kw)


@pytest.mark.parametrize("case,over", [
    ("big-batch", _thick(16)),
    # Both route Bh < 8 to their packed-rows df halo at one device (JAX
    # DFHaloEngine at a 1-device mesh, the port's DFHaloCudaEngine on
    # B14-B15) where its creep bound admits the deck.
    ("tiny-batch", _thick(4)),
    # The one divergence left: an N whose df block would be a whole-N block
    # too big for TPU VMEM; the JAX CLI's auto at float64 falls back to its
    # XLA engine there, the port's CUDA kernels tile any N.
    ("awkward-N", dict(M=32, G=32, N=1001, psi_source=tuple(
        (4.0931,) * 32 for _ in range(32)))),
])
def test_df_selection(case, over):
    jcfg = jax_load_config(GRAY, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    pcfg = port.load_config(GRAY, **over)
    pt, _, _ = port_transport.build_tables(pcfg)
    pe = port_parallel.make_multichip_engine(pcfg, pt, engine="df",
                                             device="cpu")
    if case == "tiny-batch":
        assert isinstance(pe, DFHaloCudaEngine), case
    else:
        assert isinstance(pe, port_cd.DFCudaEngine), case
    if case == "awkward-N":
        assert not jax_dfs.whole_n_feasible(jcfg)
        assert not port_cd.whole_n_feasible(pcfg)
        return
    je = jax_parallel.make_multichip_engine(jcfg, jt, None, engine="df",
                                            platform="tpu")
    if case == "tiny-batch":
        assert isinstance(je, jax_df_halo.DFHaloEngine)
        assert (pe.block, pe.K_launch, pe.H) == (je.block, je.K_launch, je.H)
    else:
        assert isinstance(je, jax_dfs.DFPallasEngine)
        assert pe.block == je.block


# -- CLI -----------------------------------------------------------------------

def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("deck,steps", [("single_group.prm", 20),
                                        ("llnl_slab_test.prm", 2)])
def test_cli_df_matches_jax_general(tmp_path, deck, steps):
    """--engine df and --engine auto (float64, the default dtype) run
    DFCudaEngine; their CSVs match the JAX CLI's default float64 general
    engine within 1e-10."""
    port_cd.reset_launch_counts()
    base = [_deck(deck), "--steps", str(steps)]
    rc, out = _run(port_cli.main, base + [
        "--outdir", str(tmp_path / "auto"), "--engine", "auto", "--device",
        "cpu"])
    assert rc == 0, out
    assert "auto engine: df (single chip, double-float kernel)" in out
    rc, out = _run(port_cli.main, base + [
        "--outdir", str(tmp_path / "df"), "--engine", "df", "--dtype",
        "float32", "--device", "cpu"])
    assert rc == 0, out
    assert "note: --engine df is f64-grade" in out
    # On the CPU the plain versions run; no kernel was launched.
    assert port_cd.df_bdf2_launch.launches == 0
    rc, _ = _run(jax_cli.main, base + ["--outdir", str(tmp_path / "jx")])
    assert rc == 0
    phi_scale = np.max(np.abs(np.loadtxt(tmp_path / "jx" / "phi.csv")))
    for run in ("auto", "df"):
        for name in CSVS:
            got = np.loadtxt(tmp_path / run / f"{name}.csv", ndmin=2)
            ref = np.loadtxt(tmp_path / "jx" / f"{name}.csv", ndmin=2)
            assert got.shape == ref.shape, name
            assert np.all(np.isfinite(got)), name
            # F cancels to roundoff at equilibrium; phi bounds it.
            scale = phi_scale if name == "F" else np.max(np.abs(ref))
            err = np.max(np.abs(got - ref)) / (scale + 1e-300)
            assert err < 1e-10, (run, name, err)
