"""The port's f64-grade tiny-batch route against the JAX package, on the CPU.

* Kernels: the plain versions of B14 (``df_halo_bdf2_launch_ref``) and B15
  (``df_halo_multistep_launch_ref``) against the JAX factories
  ``_make_df_halo_bdf2_kernel`` / ``_make_df_halo_multistep_kernel`` in
  interpret mode, built through ``DFHaloEngine._build_call`` on a 1-device
  mesh: packed rows 2 and 4, 4 blocks of 32 cells, K = 1 (BDF2) and 2
  (BE, CN), reset 0 and > 0, seeded numpy (hi, lo) inputs fed to both.
* Engine: ``DFHaloCudaEngine(device="cpu")`` against ``DFCudaEngine`` at
  the same block (BDF2, BE and CN, reflective and source left, a tail
  group, a ``from_ends`` restart), and one anchor against the JAX float64
  general engine (``models/transport``). No JAX ``DFHaloEngine.solve``
  runs here: its interpreter costs minutes.
* Selection: ``make_multichip_engine(engine="df")`` against the JAX
  selection, and the CLI's ``--engine auto`` at float64.

Tolerances, in max|Δ(hi+lo)| / max|hi+lo| summed in float64: 1e-11 per
launch against the JAX kernels (both run the same blocked algorithm with
the same truncated scans; only the rounding of the base solve and of the
error terms differs, which the residual absorbs far below it) and against
the JAX float64 engine (the JAX df engine's own bar). The halo engine
against DFCudaEngine at the same block: 1e-11, and bit-equal, because the
own cells run the same block decomposition from the same seeds and the
creep bound keeps the zero-seeded halo's error out of them. CLI CSVs:
1e-10, as in tests/test_torch_df.py.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)
from conftest import deck_edit

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu import parallel as jax_parallel
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import df_sweep as jax_dfs
from radiative_transfer_tpu.parallel import df_halo as jax_df_halo

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch import parallel as port_parallel
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_df as port_cd
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs
from radiative_transfer_tpu_torch.parallel.df_halo_cuda import (
    DFHaloCudaEngine)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-11
GRAY = os.path.join(REPO, "prm", "single_group.prm")
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _df_err(got, ref):
    """Largest error of the (hi, lo) array pairs, hi + lo in float64."""
    errs = []
    for i in range(0, len(ref), 2):
        r = np.asarray(ref[i], np.float64) + np.asarray(ref[i + 1], np.float64)
        g = got[i].double().numpy() + got[i + 1].double().numpy()
        errs.append(_relerr(g, r.reshape(g.shape)))
    return max(errs)


def _compile(fn, *args):
    """The jitted fn compiled for args with XLA's backend optimisation off:
    each reference here runs once at a tiny size, so compiling is nearly
    all its cost."""
    return fn.lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


def _over(M, **kw):
    """The gray deck at M directions with thick cells (X = 40.96: dx =
    0.04 at N = 1024), which the df halo's creep bound admits."""
    return dict(M=M, X=40.96, psi_source=tuple((4.0931,) for _ in range(M)),
                **kw)


def _ports(over):
    cfg = port.load_config(GRAY, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    return cfg, tables


# -- kernels -------------------------------------------------------------------

KERNEL_CASES = {
    # name: (M, config overrides, K, reset block)
    "bdf2-refl-asym-reset2": (2, dict(ts_method=3, bc_left_indicator=2), 1,
                              2),
    "bdf2-src-sym-reset1": (4, dict(ts_method=3, bc_left_indicator=1,
                                    bdf2_symmetric_half=True), 1, 1),
    "cn-refl-reset2": (4, dict(ts_method=2, bc_left_indicator=2), 2, 2),
    "be-src-reset0": (2, dict(ts_method=1, bc_left_indicator=1), 2, 0),
}
NBLK, BLK = 4, 32


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_df_halo_kernel_plain_matches_jax(name):
    M, over, K, reset = KERNEL_CASES[name]
    jcfg = jax_load_config(GRAY, **_over(M, N=1024, **over))
    jt, _, _ = jax_transport.build_tables(jcfg)
    mesh1 = jax_df_halo.Mesh(np.asarray(jax.devices()[:1]), ("x",))
    je = jax_df_halo.DFHaloEngine(jcfg, jt, mesh1, block=BLK)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    call = jax.jit(je._build_call(K, NBLK * BLK))
    ts = jcfg.ts_method
    rows, Bh, X = je.rows, je.Bh_l, NBLK * BLK
    C = 4 * K if ts == 3 else K
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(name))
    B = float(np.asarray(je.tables.B)[0])

    def pair(shape, lo=2.0 ** -25):
        hi = (B * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
        return hi, (hi * rng.uniform(-1, 1, shape) * lo).astype(np.float32)

    seeds = pair((2, Bh, C))
    planes = [x for _ in range(2) for x in pair((2, Bh, X))]
    kinds = (1, 2, 3) if ts == 3 else (ts,)
    coefs = [je._tb[f"{p}{k}"] for p in "kd" for k in kinds]
    args = (*coefs, *seeds, np.array([[reset]], np.int32), je.scan_masks,
            jnp.ones((1, 1), jnp.float32), *planes)
    ref = _compile(call, *args)(*args)

    def packed(x):
        return torch.as_tensor(np.asarray(x)).reshape(rows, -1)

    pargs = ([packed(c) for c in coefs] + [packed(s) for s in seeds]
             + [reset] + [packed(p) for p in planes])
    kw = dict(K=K, use_corr=bool(jcfg.use_correction), blk=BLK)
    if ts == 3:
        got = port_cd.df_halo_bdf2_launch(
            *pargs, symmetric_half=jcfg.bdf2_symmetric_half,
            npass=je.scan_npass, npass_c=je.corr_npass, **kw)
    else:
        got = port_cd.df_halo_multistep_launch(
            ts, *pargs, npass=je.scan_npass[ts], npass_c=je.corr_npass[ts],
            **kw)
    assert len(got) == len(ref) == (14 if ts == 3 else 10)
    for g, r in zip(got, ref):
        assert g.shape == (rows, r.shape[-1]) and g.dtype == torch.float32
    # Planes, then the record (rows, C) of corrected outflows.
    assert _df_err(got, ref) < TOL


def test_df_halo_wrappers_never_fall_back():
    """A tensor on a device with no kernel raises; nothing reroutes it to
    the plain version."""
    meta = torch.empty((4, 64), device="meta")
    coef = torch.empty((4, 10), device="meta")
    dcoef = torch.empty((4, port_cd._NDF), device="meta")
    kw = dict(K=2, use_corr=True, blk=16)
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cd.df_halo_multistep_launch(
            port_fs.CN, coef, dcoef, meta[:, :2], meta[:, :2], 0, meta, meta,
            meta, meta, npass=1, npass_c=1, **kw)
    npass = {k: 1 for k in (1, 2, 3)}
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cd.df_halo_bdf2_launch(
            coef, coef, coef, dcoef, dcoef, dcoef, meta[:, :8], meta[:, :8],
            0, meta, meta, meta, meta, symmetric_half=False, npass=npass,
            npass_c=npass, **kw)


# -- engine --------------------------------------------------------------------

def _states(st):
    return (*st.hi, *st.lo)


@pytest.mark.parametrize("ts_method,bc_left,steps", [
    (3, 2, 3), (3, 1, 3), (1, 2, 5), (2, 2, 5), (2, 1, 5)],
    ids=["bdf2-refl", "bdf2-src", "be-refl", "cn-refl", "cn-src"])
def test_df_halo_engine_matches_df_engine(ts_method, bc_left, steps):
    """K = 2 launch groups and a K = 1 tail, against DFCudaEngine at the
    same block: within 1e-11 in hi + lo on ends, prev and half, and bit
    for bit on every plane."""
    cfg, tables = _ports(_over(4, N=256, ts_method=ts_method,
                               bc_left_indicator=bc_left))
    he = DFHaloCudaEngine(cfg, tables, block=32, steps_per_launch=2,
                          device="cpu")
    assert he.K_launch == 2 and he.reflective == (bc_left == 2)
    pe = port_cd.DFCudaEngine(cfg, tables, block=32, device="cpu")
    hs = he.solve(num_steps=steps)
    ps = pe.solve(num_steps=steps, steps_per_launch=2)
    for got, ref in zip((he.ends(hs), *he.prev_half_ends(hs)),
                        (pe.ends(ps), *pe.prev_half_ends(ps))):
        assert _relerr(got.numpy(), ref.numpy()) < TOL
    assert all(torch.equal(a, b) for a, b in zip(_states(hs), _states(ps)))


def test_df_halo_engine_geometry_and_restart():
    """The geometry equals JAX DFHaloEngine's, and solve(2) + export and
    import + solve(3) equals solve(5) within double-float precision."""
    over = _over(2, N=256)
    jcfg = jax_load_config(GRAY, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    mesh1 = jax_df_halo.Mesh(np.asarray(jax.devices()[:1]), ("x",))
    je = jax_df_halo.DFHaloEngine(jcfg, jt, mesh1, block=32,
                                  steps_per_launch=2)
    cfg, tables = _ports(over)
    he = DFHaloCudaEngine(cfg, tables, block=32, steps_per_launch=2,
                          device="cpu")
    geometry = ("block", "K_launch", "hb", "H", "reach", "scan_npass",
                "corr_npass", "reflective")
    assert ([getattr(he, a) for a in geometry]
            == [getattr(je, a) for a in geometry])
    mid = he.solve(num_steps=2)
    prev, half = he.prev_half_ends(mid)
    st = he.from_ends(he.ends(mid), prev, half)
    two = he.solve(st, num_steps=3)
    one = he.solve(num_steps=5)
    assert _relerr(he.ends(two).numpy(), he.ends(one).numpy()) < 1e-14


def test_df_halo_engine_matches_jax_f64_general():
    """Anchor: 3 BDF2 steps (a K = 2 group and a tail) of the thick gray
    deck, S_4, reflective left, against the JAX float64 general engine."""
    over = _over(4, N=256)
    jcfg = jax_load_config(GRAY, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    step = jax_transport.make_step_fn(jcfg, jt)
    st0 = jax_transport.initial_state(jcfg, jt)
    run = jax.jit(lambda s: lax.fori_loop(0, 3, lambda _, x: step(x), s))
    ref = np.asarray(_compile(run, st0)(st0).ends)
    cfg, tables = _ports(over)
    he = DFHaloCudaEngine(cfg, tables, block=32, steps_per_launch=2,
                          device="cpu")
    got = he.ends(he.solve(num_steps=3))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    assert _relerr(got.numpy(), ref) < TOL


# -- selection -----------------------------------------------------------------

@pytest.mark.parametrize("case,over,kw,halo", [
    ("tiny-batch", _over(4, N=1024), {}, True),
    ("tiny-batch-BE", _over(2, N=1024, ts_method=1), {}, True),
    ("shipped-gray", {}, {}, False),
    ("thin-optics", _over(4, N=1024), {"scan_tol": 0.0}, False),
    ("odd-N", _over(4, N=1001), {}, False),
    ("big-batch", _over(16, N=1024), {}, False),
])
def test_df_selection_matches_jax(case, over, kw, halo):
    """engine="df": both selections pick the packed-rows df halo at Bh < 8
    where its creep bound admits the deck, and fall back to the plain df
    engine where it raises (the shipped gray deck is too thin at N = 100;
    a full scan, scan_tol 0, leaves the carry's reach unbounded)."""
    jcfg = jax_load_config(GRAY, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    je = jax_parallel.make_multichip_engine(jcfg, jt, None, engine="df",
                                            platform="tpu", **kw)
    cfg, tables = _ports(over)
    pe = port_parallel.make_multichip_engine(cfg, tables, engine="df",
                                             device="cpu", **kw)
    if halo:
        assert isinstance(je, jax_df_halo.DFHaloEngine), case
        assert isinstance(pe, DFHaloCudaEngine), case
        assert (pe.block, pe.K_launch, pe.H) == (je.block, je.K_launch, je.H)
    else:
        assert isinstance(je, jax_dfs.DFPallasEngine), case
        assert isinstance(pe, port_cd.DFCudaEngine), case


def test_df_halo_refusals():
    cfg, tables = _ports(_over(4, N=1024))
    with pytest.raises(ValueError, match="unbounded"):
        DFHaloCudaEngine(cfg, tables, scan_tol=0.0, device="cpu")
    cfg, tables = _ports(_over(4, N=1001))
    with pytest.raises(ValueError, match="power-of-two block"):
        DFHaloCudaEngine(cfg, tables, device="cpu")
    # dx = 0.04 as above, but 64 cells: 4 sub-steps of reach 18 need 72.
    cfg, tables = _ports(dict(_over(4, N=64), X=2.56))
    with pytest.raises(ValueError, match="exceeds N_loc"):
        DFHaloCudaEngine(cfg, tables, device="cpu")


# -- CLI -----------------------------------------------------------------------

def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_auto_f64_runs_the_df_halo(tmp_path):
    """--engine auto at float64 on a tiny-batch deck thick enough for the
    creep bound (the gray deck at N = 2048, X = 20.48) picks the df halo
    and prints JAX's line; its CSVs are within 1e-10 of --engine df, which
    stays on DFCudaEngine."""
    text = open(GRAY).read()
    for old, new in (("N=100", "N=2048"), ("X=1.", "X=20.48")):
        text = deck_edit(text, old, new)
    deck = tmp_path / "thick.prm"
    deck.write_text(text)
    base = [str(deck), "--steps", "3", "--device", "cpu"]
    port_cd.reset_launch_counts()
    rc, auto_out, err = _run(base + ["--outdir", str(tmp_path / "auto"),
                                     "--engine", "auto"])
    assert rc == 0, err
    assert "auto engine: df (single chip, double-float kernel)" in auto_out
    assert ("auto engine: packed-rows df halo at 1-device mesh (tiny batch)"
            in auto_out)
    rc, df_out, err = _run(base + ["--outdir", str(tmp_path / "df"),
                                   "--engine", "df"])
    assert rc == 0, err
    assert "packed-rows df halo" not in df_out
    # On the CPU the plain versions run; no kernel was launched.
    assert port_cd.df_halo_bdf2_launch.launches == 0
    phi_scale = np.max(np.abs(np.loadtxt(tmp_path / "df" / "phi.csv")))
    for name in CSVS:
        got = np.loadtxt(tmp_path / "auto" / f"{name}.csv", ndmin=2)
        ref = np.loadtxt(tmp_path / "df" / f"{name}.csv", ndmin=2)
        assert got.shape == ref.shape and np.all(np.isfinite(got)), name
        # F cancels to roundoff at equilibrium; phi bounds it.
        scale = phi_scale if name == "F" else np.max(np.abs(ref))
        assert np.max(np.abs(got - ref)) / (scale + 1e-300) < 1e-10, name
