"""The port's tiny-batch route against the JAX package, on the CPU.

* Kernels: the plain versions of B4 (``halo_bdf2_launch_ref``) and B5
  (``halo_multistep_launch_ref``) against the JAX factories
  ``_make_halo_bdf2_kernel`` / ``_make_halo_multistep_kernel`` in
  interpret mode, built through ``HaloPallasEngine._build_call`` on a
  1-device mesh: packed rows 2 and 8, 4 blocks of 32 cells, K = 2, reset
  0 and 2, seeded numpy inputs fed to both.
* Engine: ``HaloCudaEngine(device="cpu")`` against JAX
  ``HaloPallasEngine`` at a 1-device mesh, reflective BDF2 (the fixup
  splice runs) for 3 steps at K = 2 (a body group and a tail group).
* Selection: ``parallel.make_multichip_engine`` against the JAX selection
  with ``platform="tpu"``.
* CLI: ``--engine auto|halo`` and ``--dtype``.

Tolerance 1e-6 of the reference's largest magnitude, as in
tests/test_torch_sweep.py: the plain versions keep the JAX kernels'
blocks, truncated scan passes and operation order, so only float32
rounding differs (XLA's CPU compiler contracts multiply-adds). The CLI
CSVs are held to 1e-5, as in tests/test_torch_cli.py.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)
from conftest import deck_edit

import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import cli as jax_cli
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu import parallel as jax_parallel
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import pallas_sweep as jax_ps
from radiative_transfer_tpu.parallel import halo_pallas as jax_halo

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import cli as port_cli
from radiative_transfer_tpu_torch import parallel as port_parallel
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_sweep as port_cs
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs
from radiative_transfer_tpu_torch.parallel import mesh as port_mesh
from radiative_transfer_tpu_torch.parallel.halo_cuda import HaloCudaEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
GRAY = os.path.join(REPO, "prm", "single_group.prm")
CSVS = ("phi", "phi_plus", "psi", "x", "F", "e_ave", "left_ends",
        "right_ends")


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _over(M, **kw):
    """The gray deck at M directions with thick cells (X = 40.96: dx =
    0.16 at N = 256, 0.04 at N = 1024; the scan truncates to 2 passes,
    so the creep bound admits a few hundred cells)."""
    return dict(M=M, X=40.96, psi_source=tuple((4.0931,) for _ in range(M)),
                **kw)


def _pair(over, block=32, **halo_kw):
    """(JAX HaloPallasEngine at a 1-device mesh, the port's tables and
    config) for the gray deck with `over`."""
    jcfg = jax_load_config(GRAY, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    mesh1 = jax_halo.Mesh(np.asarray(jax.devices()[:1]), ("x",))
    je = jax_halo.HaloPallasEngine(jcfg, jt, mesh1, block=block, **halo_kw)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    pcfg = port.load_config(GRAY, **over)
    pt, _, _ = port_transport.build_tables(pcfg)
    return je, pcfg, pt


# -- kernels -------------------------------------------------------------------

KERNEL_CASES = {
    # name: (M, ts_method, symmetric_half)
    "bdf2-rows2-asym": (2, 3, False),
    "bdf2-rows8-sym": (8, 3, True),
    "be-rows8": (8, 1, False),
    "cn-rows2": (2, 2, False),
}
K_LAUNCH, NBLK, BLK = 2, 4, 32


@pytest.fixture(scope="module")
def kernel_calls():
    """One JAX engine and one compiled (K=2, 128-cell) call per case,
    built on first use and shared by both reset values."""
    cache = {}

    def get(name):
        if name not in cache:
            M, ts, sym = KERNEL_CASES[name]
            je, _, _ = _pair(_over(M, N=1024, ts_method=ts,
                                   bdf2_symmetric_half=sym))
            cache[name] = (je, je._build_call(K_LAUNCH, NBLK * BLK))
        return cache[name]

    return get


@pytest.mark.parametrize("reset", [0, 2])
@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_halo_kernel_plain_matches_jax(kernel_calls, name, reset):
    je, call = kernel_calls(name)
    ts = je.cfg.ts_method
    rows, Bh, X = je.rows, je.Bh_l, NBLK * BLK
    C = 4 * K_LAUNCH if ts == 3 else K_LAUNCH
    rng = np.random.default_rng(100 * rows + 10 * ts + reset)
    B = float(np.asarray(je.tables.B)[0])
    seeds = (B * rng.uniform(0.5, 6.5, (2, Bh, C))).astype(np.float32)
    e0, e1 = ((B * rng.uniform(0.5, 1.5, (2, Bh, X))).astype(np.float32)
              for _ in range(2))
    kinds = (1, 2, 3) if ts == 3 else (ts,)
    coefs = [np.asarray(je._tb[f"k{k}"]["coef"]) for k in kinds]
    ref = call(*coefs, seeds, np.array([[reset]], np.int32), je.scan_masks,
               e0, e1)

    def packed(x):
        return torch.as_tensor(x).reshape(rows, -1)

    args = [packed(c) for c in coefs] + [packed(seeds), reset, packed(e0),
                                         packed(e1)]
    if ts == 3:
        got = port_cs.halo_bdf2_launch(
            *args, K=K_LAUNCH, symmetric_half=je.cfg.bdf2_symmetric_half,
            blk=BLK, npass_be=je.scan_npass[1], npass_cn=je.scan_npass[2],
            npass_bdf=je.scan_npass[3])
    else:
        got = port_cs.halo_multistep_launch(
            ts, *args, K=K_LAUNCH, blk=BLK, npass=je.scan_npass[ts])
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r).reshape(rows, -1)
        assert g.shape == r.shape, i
        assert _relerr(g.numpy(), r) < TOL, (i, _relerr(g.numpy(), r))


def test_halo_wrappers_never_fall_back():
    """A tensor on a device with no kernel raises; nothing reroutes it to
    the plain version."""
    meta = torch.empty((4, 64), device="meta")
    coef = torch.empty((4, port_cs._NCOEF), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cs.halo_multistep_launch(port_fs.CN, coef, meta[:, :2], 0, meta,
                                      meta, K=2, blk=16, npass=1)
    with pytest.raises(RuntimeError, match="no kernel"):
        port_cs.halo_bdf2_launch(coef, coef, coef, meta[:, :8], 0, meta,
                                 meta, K=2, symmetric_half=False, blk=16,
                                 npass_be=1, npass_cn=1, npass_bdf=1)


# -- engine --------------------------------------------------------------------

@pytest.fixture(scope="module")
def reflective_bdf2():
    """The one JAX halo solve of this file: M=4 (Bh=2, the flip
    permutes), N=256, block 32, K=2, 3 steps (a K=2 group and a K=1
    tail), reflective left boundary, next to the port's solve."""
    je, pcfg, pt = _pair(_over(4, N=256), steps_per_launch=2)
    pe = HaloCudaEngine(pcfg, pt, block=32, steps_per_launch=2, device="cpu")
    assert pe.reflective and je.reflective
    jst = je.solve(num_steps=3)
    pst = pe.solve(num_steps=3)
    return je, pe, jst, pst


def test_halo_engine_geometry(reflective_bdf2):
    je, pe, _, _ = reflective_bdf2
    assert (pe.block, pe.K_launch, pe.hb, pe.H, pe.reach, pe.scan_npass) == (
        je.block, je.K_launch, je.hb, je.H, je.reach, je.scan_npass)
    assert (pe.K_launch, pe.H) == (2, 64)


@pytest.mark.parametrize("which", ["ends", "prev", "half"])
def test_halo_engine_matches_jax(reflective_bdf2, which):
    je, pe, jst, pst = reflective_bdf2
    if which == "ends":
        got, ref = pe.ends(pst), je.ends(jst)
    else:
        i = 0 if which == "prev" else 1
        got, ref = pe.prev_half_ends(pst)[i], je.prev_half_ends(jst)[i]
    assert got.shape == ref.shape
    assert _relerr(got.numpy(), np.asarray(ref)) < TOL


@pytest.mark.parametrize("ts_method", [1, 2])
def test_halo_engine_source_boundary_matches_plain_engine(ts_method):
    """Source boundary, BE and CN, 5 steps at K = 2: no fixup; the halo
    engine's own cells are what the port's plain engine computes (the
    creep bound makes them exact, as for the JAX pair)."""
    over = _over(4, N=256, ts_method=ts_method, bc_left_indicator=1)
    cfg = port.load_config(GRAY, **over)
    tables, _, _ = port_transport.build_tables(cfg)
    he = HaloCudaEngine(cfg, tables, block=32, steps_per_launch=2,
                        device="cpu")
    assert not he.reflective and he.K_launch == 2
    pe = port_cs.CudaSweepEngine(cfg, tables, block=32, device="cpu")
    hs = he.solve(num_steps=5)
    ps = pe.solve(num_steps=5, steps_per_launch=2)
    for a, b in ((hs.e0, ps.e0), (hs.e1, ps.e1), (hs.p0, ps.p0),
                 (hs.p1, ps.p1)):
        assert _relerr(a.numpy(), b.numpy()) < TOL


def test_halo_engine_from_ends_restart():
    """solve(2) + export/import + solve(3) == solve(5)."""
    cfg = port.load_config(GRAY, **_over(2, N=256))
    tables, _, _ = port_transport.build_tables(cfg)
    he = HaloCudaEngine(cfg, tables, block=32, steps_per_launch=2,
                        device="cpu")
    mid = he.solve(num_steps=2)
    prev, half = he.prev_half_ends(mid)
    st = he.from_ends(he.ends(mid).double(), prev.double(), half.double())
    two = he.solve(st, num_steps=3)
    one = he.solve(num_steps=5)
    assert _relerr(he.ends(two).numpy(), he.ends(one).numpy()) < TOL


# -- selection -----------------------------------------------------------------

def _select(over=None, deck=GRAY, **kw):
    """(port engine, JAX engine) from the two selections, the JAX one as
    on a TPU."""
    over = over or {}
    jcfg = jax_load_config(deck, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    je = jax_parallel.make_multichip_engine(jcfg, jt, None, platform="tpu",
                                            **kw)
    pcfg = port.load_config(deck, **over)
    pt, _, _ = port_transport.build_tables(pcfg)
    pe = port_parallel.make_multichip_engine(pcfg, pt, device="cpu", **kw)
    return pe, je


@pytest.mark.parametrize("case,over,kw,halo", [
    ("tiny-batch", _over(4, N=1024), {}, True),
    ("big-batch", _over(16, N=1024), {}, False),
    ("odd-N", _over(4, N=1001), {}, False),
    ("thin-optics", _over(4, N=1024), {"scan_tol": 0.0}, False),
])
def test_auto_selection_matches_jax(case, over, kw, halo):
    pe, je = _select(over, steps_per_launch=4, **kw)
    if halo:
        assert isinstance(pe, HaloCudaEngine), case
        assert isinstance(je, jax_halo.HaloPallasEngine), case
        assert (pe.block, pe.K_launch, pe.H) == (je.block, je.K_launch, je.H)
    else:
        assert isinstance(pe, port_cs.CudaSweepEngine), case
        assert isinstance(je, jax_ps.PallasEngine), case
        assert pe.block == je.block


@pytest.mark.parametrize("deck", sorted(
    d for d in os.listdir(os.path.join(REPO, "prm")) if d.endswith(".prm")))
def test_auto_selection_shipped_decks(deck):
    """Every shipped deck is too thin at its resolution for the creep
    bound: both selections keep the plain single-device engine."""
    pe, je = _select(deck=os.path.join(REPO, "prm", deck))
    assert isinstance(pe, port_cs.CudaSweepEngine)
    assert isinstance(je, jax_ps.PallasEngine)


def test_selection_pins_and_refusals():
    cfg = port.load_config(GRAY, **_over(4, N=1024))
    tables, _, _ = port_transport.build_tables(cfg)
    make = port_parallel.make_multichip_engine
    assert isinstance(make(cfg, tables, engine="halo", device="cpu"),
                      HaloCudaEngine)
    assert isinstance(make(cfg, tables, engine="single", device="cpu"),
                      port_cs.CudaSweepEngine)
    # The XLA fast engine's mesh engine is ShardedFastEngine (A7).
    from radiative_transfer_tpu_torch.parallel.sharded_fast import (
        ShardedFastEngine)

    assert isinstance(make(cfg, tables, mesh=port_mesh.make_mesh_1d(1),
                           engine="fast", device="cpu"), ShardedFastEngine)
    with pytest.raises(ValueError, match="unknown engine"):
        make(cfg, tables, engine="fused", device="cpu")
    thin = port.load_config(GRAY)
    thin_tables, _, _ = port_transport.build_tables(thin)
    with pytest.raises(ValueError, match="unbounded"):
        make(thin, thin_tables, engine="halo", device="cpu")
    odd = port.load_config(GRAY, **_over(4, N=1001))
    odd_tables, _, _ = port_transport.build_tables(odd)
    with pytest.raises(ValueError, match="power-of-two block"):
        make(odd, odd_tables, engine="halo", device="cpu")


# -- CLI -----------------------------------------------------------------------

def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("extra,rc,message", [
    (["--engine", "auto", "--steps", "2"], 0,
     "auto engine: df (single chip, double-float kernel)"),
    (["--engine", "auto", "--dtype", "float64", "--steps", "2"], 0,
     "auto engine: df (single chip, double-float kernel)"),
    (["--engine", "halo"], 2, "--engine halo infeasible for this workload"),
    (["--engine", "halo", "--dtype", "float32"], 2,
     "--engine halo infeasible for this workload"),
])
def test_cli_exit_codes(tmp_path, extra, rc, message):
    """auto at float64 (the default dtype) runs the double-float engine;
    halo refuses a deck its creep bound rejects."""
    got, out, err = _run(port_cli.main, [GRAY, "--outdir", str(tmp_path),
                                         "--device", "cpu", *extra])
    assert got == rc, err
    assert message in (out if rc == 0 else err)
    assert bool(list(tmp_path.glob("*.csv"))) == (rc == 0)


def _csvs_close(got_dir, ref_dir, tol):
    phi_scale = np.max(np.abs(np.loadtxt(ref_dir / "phi.csv")))
    for name in CSVS:
        got = np.loadtxt(got_dir / f"{name}.csv", ndmin=2)
        ref = np.loadtxt(ref_dir / f"{name}.csv", ndmin=2)
        assert got.shape == ref.shape, name
        assert np.all(np.isfinite(got)), name
        # F cancels to roundoff at equilibrium; phi bounds it.
        scale = phi_scale if name == "F" else np.max(np.abs(ref))
        err = np.max(np.abs(got - ref)) / (scale + 1e-300)
        assert err < tol, (name, err)


def test_cli_auto_float32_matches_jax_pallas(tmp_path):
    """auto --dtype float32 on single_group.prm picks the plain engine,
    as JAX auto does on a TPU; its CSVs match the JAX CLI's --engine
    pallas (JAX auto off a TPU would pick its XLA engine instead)."""
    args = [GRAY, "--steps", "5"]
    rc, out, err = _run(port_cli.main, args + [
        "--outdir", str(tmp_path / "pt"), "--engine", "auto", "--dtype",
        "float32", "--device", "cpu"])
    assert rc == 0, err
    assert "auto engine: CudaSweepEngine (single chip)" in out
    rc, _, _ = _run(jax_cli.main, args + ["--outdir", str(tmp_path / "jx"),
                                          "--engine", "pallas"])
    assert rc == 0
    _csvs_close(tmp_path / "pt", tmp_path / "jx", 1e-5)


def test_cli_halo_and_auto_run_the_halo_engine(tmp_path):
    """On a deck the creep bound admits (the gray deck at N=1024, dx =
    0.16, S_4), --engine halo and --engine auto run HaloCudaEngine, and
    their CSVs equal --engine pallas's."""
    text = open(GRAY).read()
    for old, new in (("M=2", "M=4"), ("N=100", "N=1024"), ("X=1.", "X=163.84"),
                     ("psi_source=4.0931 4.0931",
                      "psi_source=4.0931 4.0931 4.0931 4.0931")):
        text = deck_edit(text, old, new)
    deck = tmp_path / "thick.prm"
    deck.write_text(text)
    base = [str(deck), "--steps", "3", "--device", "cpu", "--dtype",
            "float32"]
    port_cs.reset_launch_counts()
    rc, out, err = _run(port_cli.main, base + [
        "--outdir", str(tmp_path / "auto"), "--engine", "auto"])
    assert rc == 0, err
    assert "auto engine: HaloCudaEngine (single chip)" in out
    for engine in ("halo", "pallas"):
        rc, _, err = _run(port_cli.main, base + [
            "--outdir", str(tmp_path / engine), "--engine", engine])
        assert rc == 0, err
    # On the CPU the plain versions run; no kernel was launched.
    assert port_cs.halo_bdf2_launch.launches == 0
    _csvs_close(tmp_path / "auto", tmp_path / "halo", 1e-12)
    _csvs_close(tmp_path / "auto", tmp_path / "pallas", 1e-6)
