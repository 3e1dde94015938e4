"""The port's worked examples (radiative_transfer_tpu_torch/examples/)
against the JAX package, on the CPU.

Each example runs through its ``main(argv)`` with ``--device cpu`` at a
tiny size, and its figures are held against the JAX functions the JAX
example of the same name calls, run here on the same deck and arguments
(the JAX example scripts themselves are not run):

* ``gray_equilibrium``: F and phi against JAX ``transport.run_problem``,
  1e-12 of max|phi|;
* ``multigroup_correction``: the fast engine's ends and the balance
  against JAX's f64 FastEngine, 1e-12, the 8 CSVs written, and the
  no-matplotlib branch;
* ``llnl_production``: the kernels' plain versions through auto selection
  with a checkpoint resume against the f32 engine the JAX example's
  selection picks on the CPU (its FastEngine), 1e-6;
* ``reference_precision``: the f64 fast engine 1e-12 and the df kernel
  1e-11 of JAX's f64 FastEngine, the df halo engine bit-equal to the df
  kernel, the f32 kernel 1e-6 of JAX's f32 FastEngine, and
  the kernel-rate fit's first loss 1e-3 of JAX's f64 one (its
  gradients are held in tests/test_torch_adjoint.py);
* ``inverse_opacity`` and ``uncertainty``: the fit's history and kappas,
  the ensemble's exit fluxes and the adjoint gradient, 1e-12 of JAX's
  (one JAX value_and_grad through ``make_diff_solve`` serves both: the JAX
  general engine's BDF2 adjoint compiles in ~16 s here);
* ``multichip`` on two spawned gloo ranks: ShardedFastEngine and FastEngine
  1e-12 of JAX's f64 FastEngine, the f32 mesh route within 1e-5 of the
  f32 kernel engine on one process;
* every example's arguments and defaults, and ``--device cuda`` without a
  card raising.

Every JAX program here is compiled with XLA's backend optimisation off,
the float64 ones also with its older CPU emitters
(test_torch_general._OPT_OFF_F64).
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import contextlib
import io
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radiative_transfer_tpu as jax_rt
from radiative_transfer_tpu import adjoint as jax_adj
from radiative_transfer_tpu import parallel as jax_parallel
from radiative_transfer_tpu.config.config import Config as JaxConfig
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops.fast_sweep import FastEngine as JaxFast

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.examples import (
    gray_equilibrium, inverse_opacity, llnl_production, multichip,
    multigroup_correction, reference_precision, uncertainty)
from radiative_transfer_tpu_torch.parallel.distributed import launch_local
from radiative_transfer_tpu_torch.ops.cuda_sweep import CudaSweepEngine

from test_torch_general import _jit_opt_off, _jit_opt_off_f64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
DF_TOL = 1e-11
F32_TOL = 1e-6
EXAMPLES = {"gray_equilibrium": gray_equilibrium,
            "multigroup_correction": multigroup_correction,
            "llnl_production": llnl_production,
            "reference_precision": reference_precision,
            "inverse_opacity": inverse_opacity,
            "uncertainty": uncertainty, "multichip": multichip}


def _deck(name):
    return os.path.join(REPO, "prm", name)


def _relerr(got, ref, scale=None):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.max(np.abs(ref)) if scale is None else scale
    return np.max(np.abs(got - ref)) / (scale + 1e-300)


def _main(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = module.main(argv)
    return res, out.getvalue()


@pytest.fixture
def jit_off(monkeypatch):
    """Every jax.jit call made while the test runs compiles with XLA's
    backend optimisation off."""
    monkeypatch.setattr(jax, "jit", _jit_opt_off)


@pytest.fixture
def jit_off_f64(monkeypatch):
    """jit_off for a test whose JAX programs are all float64
    (test_torch_general._OPT_OFF_F64)."""
    monkeypatch.setattr(jax, "jit", _jit_opt_off_f64)


# -- arguments and refusals ---------------------------------------------------

DEFAULTS = {
    "gray_equilibrium": dict(steps=1000),
    "multigroup_correction": dict(outdir="out_multigroup", steps=100),
    "llnl_production": dict(N=1 << 10, steps=40, every=10),
    "reference_precision": dict(N=None, steps=None, iters=60),
    "inverse_opacity": dict(groups=8, steps=6, iters=400, lr=0.05),
    "uncertainty": dict(groups=8, samples=32, steps=8, sigma=0.1),
    "multichip": dict(),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_arguments_and_defaults(name):
    """The JAX script's arguments and defaults (the sizes its body fixes
    as options of the port's), and --device with cuda the default."""
    args = vars(EXAMPLES[name].parser().parse_args([]))
    assert args == dict(DEFAULTS[name], device="cuda")
    with pytest.raises(SystemExit):
        EXAMPLES[name].parser().parse_args(["--device", "tpu"])


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_cuda_without_a_card_raises(name):
    """--device cuda (the default) without a card raises; nothing steps
    down to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs the "
                    "examples there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EXAMPLES[name].main([])


# -- the examples against JAX -------------------------------------------------

def test_gray_equilibrium_matches_jax(jit_off_f64):
    res, out = _main(gray_equilibrium, ["--steps", "20", "--device", "cpu"])
    assert res["rc"] == 0
    assert "gray slab: M=2 G=1 N=100, 20 BDF2 steps" in out
    assert "run >= 1000 steps for the 1e-6 criterion" in out
    jres = jax_transport.run_problem(
        jax_rt.load_config(_deck("single_group.prm"), max_timesteps=20))
    scale = np.max(np.abs(np.asarray(jres.phi)))
    assert _relerr(res["phi"], jres.phi) < TOL
    assert _relerr(res["F"], jres.F, scale) < TOL
    assert res["max_element"] == pytest.approx(float(np.max(jres.F)),
                                               abs=TOL * scale)


def test_multigroup_correction_matches_jax(jit_off_f64, tmp_path,
                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    outdir = str(tmp_path / "mg")
    res, out = _main(multigroup_correction,
                     [outdir, "--steps", "5", "--device", "cpu"])
    assert res["rc"] == 0 and res["plots"] == []
    assert "(matplotlib not available)" in out
    assert sorted(os.listdir(outdir)) == sorted(
        f"{n}.csv" for n in ("phi", "phi_plus", "psi", "x", "F", "e_ave",
                             "left_ends", "right_ends"))
    jcfg = jax_rt.load_config(_deck("multi_group_equilibrium.prm"),
                              max_timesteps=5)
    jt, _, _ = jax_transport.build_tables(jcfg)
    eng = JaxFast(jcfg, jt, dtype=jnp.float64)
    ends = eng.ends(eng.solve())
    phi = jax_transport.compute_phi(jax_transport.psi_from_ends(ends), jt.wt)
    bal = jax_transport.compute_balance(jcfg, jt, ends, phi)
    assert _relerr(res["ends"], ends) < TOL
    assert _relerr(res["balance"], bal) < TOL
    np.testing.assert_allclose(np.loadtxt(os.path.join(outdir, "phi.csv")),
                               np.asarray(phi), rtol=1e-9)


def test_llnl_production_matches_jax(jit_off):
    res, out = _main(llnl_production, ["--N", "64", "--steps", "4",
                                       "--every", "1", "--device", "cpu"])
    assert res["rc"] == 0 and res["resumed"] == 2
    assert res["engine"] == "CudaSweepEngine"
    assert "auto-selected engine: CudaSweepEngine" in out
    assert out.rstrip().endswith("ok")
    path = _deck("llnl_slab_test.prm")
    C = 299.79245800
    jcfg = jax_rt.load_config(path, N=64, max_timesteps=4,
                              dt=0.4 * (jax_rt.load_config(path).X / 64) / C)
    jt, _, _ = jax_transport.build_tables(jcfg, dtype=jnp.float32)
    # The JAX example's call: off a TPU its selection picks the f32 XLA
    # FastEngine (the TPU's PallasEngine agrees with it to f32 roundoff).
    jeng = jax_parallel.make_multichip_engine(jcfg, jt, None)
    assert type(jeng).__name__ == "FastEngine"
    assert _relerr(res["ends"], jeng.ends(jeng.solve())) < F32_TOL
    assert res["B_sum_err"] < 1e-6


def test_reference_precision_matches_jax(monkeypatch):
    res, out = _main(reference_precision, ["--N", "128", "--steps", "4",
                                           "--iters", "2", "--device",
                                           "cpu"])
    assert res["rc"] == 0 and (res["N"], res["steps"]) == (128, 4)
    assert "df halo mesh-1" in out and "recovered kappa" in out
    monkeypatch.setattr(jax, "jit", _jit_opt_off_f64)
    jcfg = jax_rt.load_config(_deck("single_group.prm"), M=8, N=128,
                              X=1.28, max_timesteps=4)
    jt, _, _ = jax_transport.build_tables(jcfg)
    fe = JaxFast(jcfg, jt, dtype=jnp.float64)
    four = fe.solve(num_steps=4)
    ref = np.asarray(fe.ends(four))
    assert _relerr(res["ends_f64"], ref) < TOL
    assert _relerr(res["ends_df"], ref) < DF_TOL
    assert np.array_equal(res["ends_df_halo"], res["ends_df"])
    assert res["drift_df"] == res["drift_df_halo"] < DF_TOL

    # The fit's first loss (at the deck's kappa, before any update) from
    # JAX's f64 fast engine: the port's kernel adjoint runs float32 planes.
    # Its 8 steps run as 4 and 4 more (a full step carries the whole
    # state: bit-equal to one 8-step solve, one program fewer to compile).
    cfg_t = jcfg.replace(kappa_grey=jcfg.kappa_grey * 1.3, max_timesteps=8)
    tt, _, _ = jax_transport.build_tables(cfg_t)
    ft = JaxFast(cfg_t, tt, dtype=jnp.float64)
    target = np.asarray(ft.ends(ft.solve(num_steps=8)))
    start = np.asarray(fe.ends(fe.solve(four, num_steps=4)))
    loss0 = float(np.mean((start - target) ** 2))
    # The loss is a difference of solutions ~1e-3 of their size apart, so
    # the float32 planes' 1e-6 drift reaches ~1e-3 of it.
    assert abs(res["loss"][0] / loss0 - 1.0) < 1e-3
    assert res["kappa_target"] == pytest.approx(1.3 * jcfg.kappa_grey)
    assert len(res["loss"]) == 2 and res["loss"][1] < res["loss"][0]

    # JAX's f32 engine off a TPU (its PallasEngine in interpret mode, which
    # the plain B1 is held to in tests/test_torch_sweep.py, agrees with it
    # to f32 roundoff and costs ~11 s to build here).
    monkeypatch.setattr(jax, "jit", _jit_opt_off)
    jt32, _, _ = jax_transport.build_tables(jcfg, dtype=jnp.float32)
    pe = JaxFast(jcfg, jt32, dtype=jnp.float32)
    assert _relerr(res["ends_f32"], pe.ends(pe.solve(num_steps=4))) < F32_TOL


def _small_example_config(G, steps):
    return JaxConfig(
        M=4, G=G, N=64, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(0.02 + 0.005 * g for g in range(G))
                         for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.001,
        use_correction=True, ts_method=3, dt=5e-5,
        max_timesteps=steps, include_validation=False)


def test_example_config_is_jaxs():
    assert (inverse_opacity.example_config(3, 2).__dict__
            == _small_example_config(3, 2).__dict__)


@pytest.fixture(scope="module")
def small_slab():
    """One JAX program serves inverse_opacity and uncertainty (the same
    slab, G = 2, one step): value_and_grad in kappa, through the JAX
    example's ``adjoint.make_diff_solve``, of

        h(kappa, a, c) = mean((phi * a - 1)^2 * (a != 0)) + sum(c * phi)

    with phi as its aux: a = 1 / phi_target gives inverse_opacity's loss,
    c one at the right face its observable, a = c = 0 phi alone."""
    G, steps = 2, 1
    cfg = _small_example_config(G, steps)
    jt, _, _ = jax_transport.build_tables(cfg)
    state0 = jax_transport.initial_state(cfg, jt)
    solve_fn = jax_adj.make_diff_solve(cfg, jt, num_steps=steps)

    def h(kappa, a, c):
        phi = jax_transport.compute_phi(jax_transport.psi_from_ends(
            solve_fn({"kappa": kappa}, state0).ends), jt.wt)
        fit = jnp.mean(jnp.where(a != 0, (phi * a - 1.0) ** 2, 0.0))
        return fit + jnp.sum(c * phi), phi

    vg = _jit_opt_off_f64(jax.value_and_grad(h, has_aux=True))

    def call(kappa, a=None, c=None):
        z = np.zeros((G, cfg.N))
        (val, phi), grad = vg(jnp.asarray(kappa, jnp.float64),
                              jnp.asarray(z if a is None else a),
                              jnp.asarray(z if c is None else c))
        return float(val), np.asarray(phi), np.asarray(grad)

    return dict(G=G, steps=steps, cfg=cfg, tables=jt, call=call)


def test_inverse_opacity_matches_jax(small_slab):
    """The fit against JAX's: fit_params' loop (optax Adam on the JAX
    adjoint's value and gradient, as JAX's update step runs it)."""
    import optax

    G, steps, iters, lr = small_slab["G"], small_slab["steps"], 3, 0.05
    res, out = _main(inverse_opacity, ["--groups", str(G), "--steps",
                                       str(steps), "--iters", str(iters),
                                       "--device", "cpu"])
    assert res["rc"] == 0 and f"({iters} Adam iterations)" in out
    jt, call = small_slab["tables"], small_slab["call"]
    k_true = np.asarray(jt.kappa) * np.random.default_rng(7).uniform(
        0.6, 1.6, size=G)
    _, phi_target, _ = call(k_true)
    a = 1.0 / phi_target
    opt = optax.adam(lr)
    params = {"kappa": jnp.asarray(jt.kappa)}
    state = opt.init(params)
    hist = []
    for _ in range(iters):
        val, _, grad = call(params["kappa"], a=a)
        updates, state = opt.update({"kappa": jnp.asarray(grad)}, state,
                                    params)
        params = optax.apply_updates(params, updates)
        hist.append(val)
    np.testing.assert_array_equal(res["kappa_true"], k_true)
    assert _relerr(res["kappa_fit"], params["kappa"]) < TOL
    assert _relerr(res["loss"], hist) < TOL
    worst = float(np.max(np.abs(np.asarray(params["kappa"]) / k_true - 1)))
    assert res["worst"] == pytest.approx(worst, rel=1e-9)
    assert res["passed"] == (worst < 0.05)


def test_uncertainty_matches_jax(small_slab):
    """The ensemble's exit fluxes against JAX's solves member by member
    (solve_ensemble is their vmap), the linearised spread against the JAX
    adjoint's gradient."""
    G, steps, K, sigma = small_slab["G"], small_slab["steps"], 4, 0.1
    res, out = _main(uncertainty, ["--groups", str(G), "--samples", str(K),
                                   "--steps", str(steps), "--device", "cpu"])
    assert res["rc"] == 0 and f"ensemble: K={K} members" in out
    jt, call = small_slab["tables"], small_slab["call"]
    k_nom = np.asarray(jt.kappa)
    kappas = k_nom * np.exp(sigma * np.random.default_rng(11)
                            .standard_normal((K, G)))
    q = np.asarray([call(k)[1][:, -1].sum() for k in kappas])
    face = np.zeros((G, small_slab["cfg"].N))
    face[:, -1] = 1.0
    q_nom, _, grad = call(k_nom, c=face)
    assert _relerr(res["q"], q) < TOL
    assert _relerr(res["grad"], grad) < TOL
    assert res["q_nom"] == pytest.approx(q_nom, rel=TOL)
    sd_k = k_nom * np.sqrt(np.exp(sigma ** 2) - 1.0)
    lin = float(np.sqrt(np.sum((grad * sd_k) ** 2)))
    assert res["q_std_lin"] == pytest.approx(lin, rel=1e-10)
    assert res["ratio"] == pytest.approx(q.std(ddof=1) / lin, rel=1e-10)


def test_multichip_two_ranks_matches_jax(jit_off_f64, tmp_path):
    """Two gloo ranks (one spawn) through main(), rank 0's figures saved;
    JAX's f64 FastEngine on the same slab."""
    out = tmp_path / "rank0.npz"
    code = textwrap.dedent(f"""
        import numpy as np
        from radiative_transfer_tpu_torch.examples import multichip
        from radiative_transfer_tpu_torch.parallel import distributed
        res = multichip.main(["--device", "cpu"])
        if distributed.process_index() == 0:
            np.savez({str(out)!r}, sharded=res["sharded_ends"],
                     single=res["single_ends"], f32=res["f32_ends"],
                     err=res["err"], f32_err=res["f32_err"],
                     engine=res["engine"], ranks=res["ranks"])
        distributed.shutdown()
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    ranks = launch_local(["-c", code], 2, env=env, timeout=300, cwd=REPO)
    for r in ranks:
        assert r.returncode == 0, r.stdout + r.stderr[-3000:]
        assert "multi-chip solve matches single-device" in r.stdout
        assert "mesh: {'x': 2} over 2 ranks" in r.stdout
    got = np.load(out)
    assert int(got["ranks"]) == 2 and str(got["engine"]) == "HaloCudaEngine"
    cfg = JaxConfig(M=8, G=4, N=512, X=2.0, bc_left_indicator=2,
                    bc_right_indicator=1, use_correction=True, V=1.0,
                    use_mg_equilib=True, ts_method=3, dt=1e-5,
                    max_timesteps=20, include_validation=False)
    jt, _, _ = jax_transport.build_tables(cfg)
    eng = JaxFast(cfg, jt, dtype=jnp.float64)
    ref = np.asarray(eng.ends(eng.solve()))
    assert _relerr(got["single"], ref) < TOL
    assert _relerr(got["sharded"], ref) < TOL
    # The f32 mesh route at two ranks against the single-device kernel
    # engine on one process, at the mesh engines' bar (1e-5).
    pcfg = port.Config(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    pt, _, _ = port.transport.build_tables(pcfg)
    one = CudaSweepEngine(pcfg, pt, device="cpu")
    assert _relerr(got["f32"], one.ends(one.solve()).to(torch.float64)) < 1e-5
    assert float(got["f32_err"]) < 2e-3
