"""The port's K-fused BDF2 adjoint (B11-B12) against the JAX package, on
the CPU.

* Kernels: the plain versions of B11 (``fwd_record_k_launch_ref``) and B12
  (``bwd_k_launch_ref``) against ``DiffPallasStepK._fwd_call`` /
  ``_bwd_call`` in interpret mode, one launch at M = 4, G = 1, N = 64,
  block 32 (two blocks): reflective / asymmetric half at K = 3 (a middle
  step that is neither first nor last) and source / symmetric half at
  K = 2, seeded numpy planes and cotangents fed to both: planes, records,
  the intermediate inputs and cbc within 1e-6, gradient packs within 1e-5
  of each one's largest magnitude (the bars of tests/test_torch_adjoint.py
  for B9-B10: float32 rounding of the same blocked algorithm, the packs
  summed in another order). Plain B11 is bit-equal to plain B1
  (``bdf2_launch_ref``) at the same K: the same sub-step arithmetic per
  (step, block).
* Solve: ``make_diff_solve_cuda(device="cpu")`` K-fused against its own
  K = 1 chain, JAX's tests of the same property at JAX's bars:
  ``test_kfused_gradients_match_k1`` (1e-4, bc_left 1 and 2, 9 steps at
  K = 4 with a tail, a half-ends term in the loss),
  ``test_kfused_remat_group`` (1e-4, 17 steps in remat groups of 2
  launches) and tests/test_fuzz_round5.py's four seeded configurations
  (2e-4).
* K selection: the K that ``make_diff_solve_cuda`` fuses equals the K
  JAX ``make_diff_solve_pallas`` builds its ``DiffPallasStepK`` with, and
  its launches, tail steps and remat groups follow JAX's split
  (pallas_adjoint.py:1215-1231, 1283-1306), over a grid of step counts,
  integrators, ``steps_per_launch`` and ``remat_group``.
* K above the kernels' 64 a launch (``steps_per_launch`` 65 and 100):
  each K-step group split into launches of 64 and the rest, the
  gradients within 1e-4 of the K = 4 solve's, values and gradients
  against JAX's float64 adjoint (``make_diff_solve_fast``, the float64
  ``make_diff_solve`` to roundoff) at the f32 adjoint's bars
  (value 1e-5, kappa 2e-3, psi_source 1e-4; tests/test_torch_adjoint.py).
* Refusals: a launch wrapper's K outside 1..64, a non-BDF2 step, records
  of another K, and the card path without a card (a CUDA-side wrapper
  raises and never falls back to its plain version).

Every JAX program here runs once at a tiny size, compiled at XLA's
backend optimisation level 1 without HLO fusion (see _compile); the
float64 reference of K above 64 as test_torch_general's float64 programs.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import adjoint as jax_adj
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import pallas_adjoint as jax_pa
from radiative_transfer_tpu.ops import pallas_sweep as jax_ps

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch.config.config import Config as PortConfig
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_adjoint as port_ca
from radiative_transfer_tpu_torch.ops import cuda_sweep as port_cs

from test_torch_general import _jit_opt_off_f64

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
SRC = ((2.0,),) * 4      # off-equilibrium: an O(1) kappa sensitivity


def _compile(fn, *args):
    """jax.jit(fn) compiled for args at XLA's backend optimisation level 1
    without its fusion pass. Pinned to one CPU core, the K = 3 interpret-mode
    backward compiles in ~7 s so, against ~50 s with fusion; at level 0 (the
    other port test files' setting) it runs ~190 s, against 0.2 s at level
    1. Neither option changes an operation's rounding."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 1,
        "xla_llvm_disable_expensive_passes": True,
        "xla_disable_hlo_passes": "fusion"})


def _both(path, **over):
    """(JAX cfg, JAX tables, port cfg, port tables), the port's tables the
    JAX ones as numpy."""
    jcfg = jax_load_config(path, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    return jcfg, jt, port.load_config(path, **over), pt


# -- plain B11 and B12 against the Pallas kernels in interpret mode -----------

@pytest.fixture(scope="module", params=[(3, True, False), (2, False, True)],
                ids=lambda c: f"K{c[0]}-{'refl' if c[1] else 'src'}-"
                              f"{'sym' if c[2] else 'asym'}")
def kcase(request):
    """One K-step launch of each side: M = 4, G = 1, N = 64 in two blocks
    of 32."""
    K, refl, sym = request.param
    over = dict(M=4, G=1, N=64, ts_method=3, psi_source=SRC,
                bc_left_indicator=2 if refl else 1, bdf2_symmetric_half=sym)
    jcfg, jt, pcfg, pt = _both(GRAY, **over)
    je = jax_ps.PallasEngine(jcfg, jt, block=32)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    dk = jax_pa.DiffPallasStepK(je, K)
    pe = port_cs.CudaSweepEngine(pcfg, pt, block=32, device="cpu")
    geo = port_ca.step_geometry(pe)
    assert (pe.block, pe.reflective) == (je.block, je.reflective)
    rng = np.random.default_rng(40 + 10 * K + refl + 3 * sym)
    base = pe.init_state().e0.numpy()
    e0, e1 = [(base * rng.uniform(0.5, 1.5, base.shape)).astype(np.float32)
              for _ in range(2)]
    coefs = [pe.coef[k].numpy() for k in (1, 2, 3)]
    cots = [rng.uniform(-1, 1, e0.shape).astype(np.float32)
            for _ in range(6)]
    jin = [jnp.asarray(c) for c in coefs] + [
        jnp.asarray(pe.bc.numpy()), dk.refl_P, dk.scan_masks,
        jnp.asarray(e0), jnp.asarray(e1)]
    jfwd = _compile(dk._fwd_call, *jin)(*jin)
    # (cbe, ccn, cbdf, P, masks, rev masks, e0, e1, ri0, ri1, the six
    # cotangents, rc, ret, rht)
    jbin = [jnp.asarray(c) for c in coefs] + [
        dk.refl_P, dk.scan_masks, dk.rev_masks, jnp.asarray(e0),
        jnp.asarray(e1), jfwd[9], jfwd[10]] + [
        jnp.asarray(c) for c in cots] + list(jfwd[6:9])
    jbwd = _compile(dk._bwd_call, *jbin)(*jbin)
    t = [torch.as_tensor(c) for c in coefs]
    te0, te1 = torch.as_tensor(e0), torch.as_tensor(e1)
    pfwd = port_ca.fwd_record_k_launch(*t, pe.bc, pe.flip, te0, te1, K=K,
                                       **geo)
    pbwd = port_ca.bwd_k_launch(
        *t, pe.flip, te0, te1, *pfwd[9:], *map(torch.as_tensor, cots),
        *pfwd[6:9], K=K, **geo)
    return dict(K=K, pe=pe, geo=geo, t=t, e=(te0, te1), jfwd=jfwd,
                jbwd=jbwd, pfwd=pfwd, pbwd=pbwd)


def test_fwd_record_k_b11(kcase):
    """(o0, o1, h0, h1, p0, p1, rc, ret, rht, ri0, ri1), in JAX's order."""
    names = ("o0", "o1", "h0", "h1", "p0", "p1", "rc", "ret", "rht", "ri0",
             "ri1")
    assert len(kcase["pfwd"]) == len(kcase["jfwd"]) == len(names)
    for name, got, ref in zip(names, kcase["pfwd"], kcase["jfwd"]):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-6 * max(scale, 1e-30), name


def test_fwd_record_k_b11_equals_b1(kcase):
    """The plain B11's six planes are the plain B1's at the same K, bit
    for bit (B1 runs the same per-(step, block) arithmetic, block-major)."""
    c = kcase
    geo, pe = c["geo"], c["pe"]
    ref = port_cs.bdf2_launch_ref(
        *c["t"], pe.bc, pe.flip, *c["e"], K=c["K"], s_be=geo["s_be"],
        s_cn=geo["s_cn"], s_bdf=geo["s_bdf"], reflective=geo["reflective"],
        symmetric_half=geo["symmetric_half"], blk=geo["blk"],
        npass_be=geo["npass"][1], npass_cn=geo["npass"][2],
        npass_bdf=geo["npass"][3])
    # bdf2_launch_ref returns (ends, half, prev) as (e0, e1, h0, h1, p0, p1)
    for got, want in zip(kcase["pfwd"][:6], ref):
        assert torch.equal(got, want)


def test_bwd_k_b12(kcase):
    for name, i, tol in (("ce0", 0, 1e-6), ("ce1", 1, 1e-6), ("cbc", 2, 1e-6),
                         ("gbe", 3, 1e-5), ("gcn", 4, 1e-5),
                         ("gbdf", 5, 1e-5)):
        got, ref = kcase["pbwd"][i].numpy(), np.asarray(kcase["jbwd"][i])
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert scale > 0, name
        assert np.abs(got - ref).max() <= tol * scale, name


def test_records_of_another_k_refused(kcase):
    c = kcase
    K, pe, geo = c["K"], c["pe"], c["geo"]
    e0, e1 = c["e"]
    rc, ret, rht, ri0, ri1 = c["pfwd"][6:]
    cots = (e0,) * 6
    with pytest.raises(ValueError, match="another K"):
        port_ca.bwd_k_launch(*c["t"], pe.flip, e0, e1, ri0[:-1], ri1[:-1],
                             *cots, rc[:, 4:], ret[:, 1:], rht[:, 1:],
                             K=K, **geo)
    with pytest.raises(ValueError, match="another K"):
        port_ca.bwd_k_launch(*c["t"], pe.flip, e0, e1, ri0, ri1, *cots, rc,
                             ret, rht, K=K + 1, **geo)


# -- the K-fused solve against the port's own K = 1 ---------------------------

def _kfused_vs_k1(pcfg, pt, steps, params, loss, K=4, tol=1e-4, **kw):
    """Gradients of `loss(state)` through make_diff_solve_cuda at K and at
    K = 1 on the CPU; asserts each parameter's max relative difference."""
    def gradof(k):
        sf = port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=steps,
                                          steps_per_launch=k, device="cpu",
                                          **kw)
        tp = {key: torch.tensor(np.asarray(v, np.float64),
                                requires_grad=True)
              for key, v in params.items()}
        loss(sf(tp)).backward()
        return {key: v.grad.numpy() for key, v in tp.items()}

    g1, gk = gradof(1), gradof(K)
    for key in params:
        scale = np.abs(g1[key]).max() + 1e-300
        assert np.abs(g1[key] - gk[key]).max() / scale < tol, key


@pytest.mark.parametrize("bc_left", [1, 2])
def test_kfused_gradients_match_k1(bc_left):
    """JAX's test of the same name: 9 = 2 x 4 + 1 steps (a tail launch),
    the reflective boundary, correction physics, and a half-ends term."""
    pcfg = port.load_config(GRAY, M=4, N=256, X=2.56, max_timesteps=9,
                            bc_left_indicator=bc_left,
                            psi_source=((1.0,),) * 4, V=1.0,
                            use_correction=True)
    pt, _, _ = port_transport.build_tables(pcfg)
    params = dict(T=np.asarray(1.0),
                  psi_source=np.asarray(pcfg.psi_source, np.float64))
    _kfused_vs_k1(pcfg, pt, 9, params,
                  lambda s: torch.sum(s.ends ** 2) + torch.sum(s.half_ends))


def test_kfused_remat_group():
    """Remat groups count launches: 17 steps at K = 4 in groups of 2
    launches (2 groups and a tail step) against no remat, within 1e-4."""
    pcfg = port.load_config(GRAY, M=4, N=256, X=2.56, max_timesteps=17,
                            bc_left_indicator=1, psi_source=SRC)
    pt, _, _ = port_transport.build_tables(pcfg)

    def gradof(**kw):
        sf = port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=17,
                                          steps_per_launch=4, device="cpu",
                                          **kw)
        k = torch.ones(1, dtype=torch.float64, requires_grad=True)
        torch.sum(sf({"kappa": k}).ends ** 2).backward()
        return k.grad.numpy()

    np.testing.assert_allclose(gradof(remat_group=2), gradof(), rtol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_kfused_grads_match_k1(seed):
    """tests/test_fuzz_round5.py's random BDF2 configurations (the same
    draws): boundaries, correction physics, odd step counts forcing tails,
    both half-snapshot conventions; 2e-4."""
    rng = np.random.default_rng(6200 + seed)
    M = int(rng.choice([2, 4]))
    G = int(rng.integers(1, 3))
    N = 256
    steps = int(rng.integers(5, 10))
    cfg = PortConfig(
        M=M, G=G, N=N,
        X=float(N * 10.0 ** rng.uniform(-2.2, -1.8)),
        efirst=0.1, elast=10.0,
        bc_left_indicator=int(rng.choice([1, 2])),
        bc_right_indicator=1,
        psi_source=tuple(
            tuple(float(rng.uniform(0.5, 3.0)) for _ in range(G))
            for _ in range(M)),
        rho=float(rng.uniform(0.5, 2.0)),
        kappa_grey=float(10.0 ** rng.uniform(-0.2, 1.0)),
        T=float(rng.uniform(0.8, 1.5)),
        V=float(rng.uniform(0.0, 2.0)),
        use_correction=bool(rng.integers(0, 2)),
        ts_method=3,
        dt=float(10.0 ** rng.uniform(-6, -5)),
        max_timesteps=steps,
        include_validation=False,
        bdf2_symmetric_half=bool(rng.integers(0, 2)),
    )
    pt, _, _ = port_transport.build_tables(cfg)
    params = dict(T=np.asarray(cfg.T),
                  psi_source=np.asarray(cfg.psi_source, np.float64))
    _kfused_vs_k1(cfg, pt, steps, params,
                  lambda s: torch.sum(s.ends ** 2) * 1e-2, tol=2e-4)


# -- K selection and the launch / tail / remat split --------------------------

def _jax_split(n, Kd, remat_group):
    """JAX make_diff_solve_pallas's split (pallas_adjoint.py:1283-1306):
    (K-step launches, tail steps, remat groups, launches a group)."""
    n_launch, n_tail = divmod(n, Kd)
    g = remat_group
    if g is None and n > 256:
        g = max(1, int(np.sqrt(n_launch)))
    if g and g > 1 and n_launch > g:
        return n_launch, n_tail, n_launch // g, g
    return n_launch, n_tail, 0, None


def _split(K):
    """The launches make_diff_solve_cuda runs a K-step group in: 64 steps
    each and the rest (the kernels' MAX_FUSED_STEPS)."""
    return [64] * (K // 64) + ([K % 64] if K % 64 else [])


@pytest.mark.parametrize("n,ts_method,spl,remat", [
    (1, 3, None, None), (3, 3, None, None), (9, 3, None, None),
    (300, 3, None, None), (9, 3, 1, None), (9, 3, 2, None),
    (5, 3, 8, None), (17, 3, 4, 2), (9, 1, None, None), (9, 2, 4, None),
    (130, 3, 65, None), (100, 3, 100, None), (300, 3, 65, 2),
    (64, 3, 65, None)])
def test_k_selection_and_split(monkeypatch, n, ts_method, spl, remat):
    jcfg, jt, pcfg, pt = _both(GRAY, M=4, N=64, X=0.64, ts_method=ts_method,
                               max_timesteps=n)
    built = []

    class JaxStepK:                      # records the K JAX builds
        def __init__(self, eng, K):
            built.append(K)

    monkeypatch.setattr(jax_pa, "DiffPallasStepK", JaxStepK)
    jax_pa.make_diff_solve_pallas(jcfg, jt, num_steps=n, steps_per_launch=spl,
                                  remat_group=remat)
    jax_K = built[0] if built else 1

    calls = {"K": [], "step": 0, "groups": 0}

    class StepK:
        @staticmethod
        def apply(eng, K, e0, e1, *rest):
            calls["K"].append(K)
            return e0, e1, e0, e1, e0, e1

    class Step:
        @staticmethod
        def apply(eng, e0, e1, *rest):
            calls["step"] += 1
            return e0, e1, e0, e1

    def checkpoint(fn, *args, **kw):
        calls["groups"] += 1
        return fn(*args)

    monkeypatch.setattr(port_ca, "DiffCudaStepK", StepK)
    monkeypatch.setattr(port_ca, "DiffCudaStep", Step)
    monkeypatch.setattr(port_ca, "checkpoint", checkpoint)
    port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=n, steps_per_launch=spl,
                                 remat_group=remat, device="cpu")({})
    n_launch, n_tail, groups, _ = _jax_split(n, jax_K, remat)
    if jax_K >= 2:
        assert calls["K"] == _split(jax_K) * n_launch
        assert calls["step"] == n_tail
    else:
        assert calls["K"] == [] and calls["step"] == n
    assert calls["groups"] == groups
    if (n, ts_method, spl) == (300, 3, None):       # the default remat
        assert (jax_K, groups) == (4, 75 // int(math.sqrt(75)))


# -- K above 64 a launch -----------------------------------------------------

@pytest.fixture(scope="module")
def long_run():
    """130 BDF2 steps of the gray off-equilibrium slab (two groups of 65
    steps; one of 100 and a 30-step tail): the value_and_grad of JAX's
    float64 adjoint (one program, compiled as test_torch_general's float64
    programs; make_diff_solve_fast, which equals make_diff_solve to
    roundoff and compiles in a fraction of its time, its scan unrolled
    once) and the port's K = 4 solve."""
    n = 130
    params = dict(kappa=np.ones(1), psi_source=np.asarray(SRC, np.float64))
    jcfg, jt, pcfg, pt = _both(GRAY, M=4, N=64, X=0.64, max_timesteps=n,
                               psi_source=SRC, bc_left_indicator=1)
    sf = jax_adj.make_diff_solve_fast(jcfg, jt, num_steps=n, unroll=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jv, jg = _jit_opt_off_f64(jax.value_and_grad(
        lambda p: jnp.sum(sf(p, None).ends ** 2) * 1e-2))(jp)
    return dict(n=n, params=params, pcfg=pcfg, pt=pt, jax=(float(jv), jg),
                k4=_port_value_and_grad(pcfg, pt, n, params, 4))


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


def _port_value_and_grad(pcfg, pt, n, params, K):
    sf = port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=n,
                                      steps_per_launch=K, device="cpu")
    tp = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
          for k, v in params.items()}
    val = torch.sum(sf(tp).ends ** 2) * 1e-2
    val.backward()
    return float(val.detach()), {k: v.grad.numpy() for k, v in tp.items()}


@pytest.mark.parametrize("K", [65, 100])
def test_k_above_64_splits_and_matches(monkeypatch, long_run, K):
    """steps_per_launch above the kernels' 64 returns (it used to raise):
    each K-step group runs as launches of 64 steps and the rest, the same
    program as one K-step launch to float32 roundoff."""
    real = port_ca.DiffCudaStepK.apply
    launched = []

    def apply(eng, k, *rest):
        launched.append(k)
        return real(eng, k, *rest)

    monkeypatch.setattr(port_ca.DiffCudaStepK, "apply", apply)
    n = long_run["n"]
    pv, pg = _port_value_and_grad(long_run["pcfg"], long_run["pt"], n,
                                  long_run["params"], K)
    assert launched == _split(K) * (n // K)
    kv, kg = long_run["k4"]
    assert abs(pv - kv) / abs(kv) < 1e-4
    for key in pg:
        assert _relerr(pg[key], kg[key]) < 1e-4, key
    jv, jg = long_run["jax"]
    assert abs(pv - jv) / abs(jv) < 1e-5
    assert _relerr(pg["kappa"], jg["kappa"]) < 2e-3
    assert _relerr(pg["psi_source"], jg["psi_source"]) < 1e-4


# -- refusals -----------------------------------------------------------------

def test_refusals():
    _, _, pcfg, pt = _both(GRAY, M=4, N=64, X=0.64, max_timesteps=70)
    # n < K falls back to K = 1, as JAX does, and K = 64 builds.
    port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=64, steps_per_launch=65,
                                 device="cpu")
    port_ca.make_diff_solve_cuda(pcfg, pt, steps_per_launch=64, device="cpu")
    pe = port_cs.CudaSweepEngine(pcfg, pt, device="cpu")
    geo = port_ca.step_geometry(pe)
    e0 = pe.init_state().e0
    co = [pe.coef[k] for k in (1, 2, 3)]
    with pytest.raises(ValueError, match="outside 1..64"):
        port_ca.fwd_record_k_launch(*co, pe.bc, pe.flip, e0, e0, K=65, **geo)
    with pytest.raises(ValueError, match="outside 1..64"):
        port_ca.bwd_k_launch(*co, pe.flip, e0, e0, e0[None], e0[None],
                             *(e0,) * 6, e0, e0, e0, K=0, **geo)
    with pytest.raises(ValueError, match="BDF2"):
        port_ca.fwd_record_k_launch(*co, pe.bc, pe.flip, e0, e0, K=2,
                                    **dict(geo, ts_method=1))


def test_card_path_needs_a_card():
    """Without a CUDA device the K-fused wrappers raise for a tensor off
    the CPU; nothing falls back to a plain version on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs this path")
    meta = torch.empty((2, 2, 64), device="meta")
    coef = torch.empty((2, 2, 10), device="meta")
    geo = dict(ts_method=3, s_be=1.0, s_cn=2.0, s_bdf=6.0, reflective=False,
               symmetric_half=False, blk=32, npass={1: 5, 2: 5, 3: 5})
    flip = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port_ca.fwd_record_k_launch(
            coef, coef, coef, torch.empty((2, 2, 1), device="meta"), flip,
            meta, meta, K=2, **geo)
    ri = torch.empty((1, 2, 2, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port_ca.bwd_k_launch(coef, coef, coef, flip, meta, meta, ri, ri,
                             *(meta,) * 6, meta, meta, meta, K=2, **geo)
