"""The port's kernel-rate adjoint against the JAX package, on the CPU.

* Tables: ``adjoint.traced_tables`` values and their autograd
  vector-Jacobian products against ``jax.vjp`` for kappa, rho, psi_source
  and T (G = 1 covers the QUIRKS #7 dsigEdE overwrite), and
  ``fast_sweep.build_kind_coeffs_traced``: 1e-12 relative (the same float64
  algebra in another library).
* Sub-step adjoint: the plain ``_substep_adj`` against torch autograd of
  the plain ``_substep_vals`` in float64, 1e-13 (an exact transpose).
* Kernels: the plain versions of B9 (``fwd_record_launch_ref``) and B10
  (``bwd_launch_ref``) against ``DiffPallasStep._fwd_call`` /
  ``_bwd_call`` in interpret mode, one launch at M = 4, N = 64, block 32
  (two blocks), seeded numpy planes and cotangents fed to both: planes,
  records and cbc within 1e-6, gradient packs within 1e-5 of each one's
  largest magnitude (float32 rounding: both run the same blocked
  algorithm; the packs are row sums of 64 cells per block).
* Solve: ``make_diff_solve_cuda(device="cpu")`` against JAX
  ``make_diff_solve_fast`` (float64) at JAX's own bars
  (tests/test_pallas_adjoint.py): value 1e-5, kappa and rho 2e-3,
  psi_source 1e-4, T 2e-3, initial-state gradients 1e-4, remat 1e-4; and
  against JAX ``make_diff_solve_pallas(steps_per_launch=1)`` in interpret
  mode at 1e-5 (the same float32 program). The solves run the K-fused
  default (B11-B12) where a test does not pin ``steps_per_launch=1``;
  tests/test_torch_adjoint_k.py holds the K-fused pair itself.
* ``fit_params(solver="pallas", device="cpu")`` against JAX
  ``fit_params(solver="fast")``, 5 Adam iterations on
  benchmarks/grad_convergence.py's problem at G = 4, N = 64, 4 steps:
  loss history within 1e-4 relative.
* Refusals: the solvers not ported yet, and the card path without a
  card.

Every JAX program here runs once at a tiny size, compiled with XLA's
backend optimisation off.
"""

import conftest  # noqa: F401  (JAX on the CPU; repo root on sys.path)

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radiative_transfer_tpu import adjoint as jax_adj
from radiative_transfer_tpu import load_config as jax_load_config
from radiative_transfer_tpu.config.config import Config as JaxConfig
from radiative_transfer_tpu.models import transport as jax_transport
from radiative_transfer_tpu.ops import fast_sweep as jax_fs
from radiative_transfer_tpu.ops import pallas_adjoint as jax_pa
from radiative_transfer_tpu.ops import pallas_sweep as jax_ps

import radiative_transfer_tpu_torch as port
from radiative_transfer_tpu_torch import adjoint as port_adj
from radiative_transfer_tpu_torch.config.config import Config as PortConfig
from radiative_transfer_tpu_torch.models import transport as port_transport
from radiative_transfer_tpu_torch.ops import cuda_adjoint as port_ca
from radiative_transfer_tpu_torch.ops import cuda_sweep as port_cs
from radiative_transfer_tpu_torch.ops import fast_sweep as port_fs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAY = os.path.join(REPO, "prm", "single_group.prm")
MG = os.path.join(REPO, "prm", "multi_group_equilibrium.prm")
TABLE_FIELDS = ("kappa", "rho", "rhokap", "B", "dEB", "cor1", "cor2",
                "cor3", "psi_source")
COEF_FIELDS = ("w", "T0", "q", "inv_det", "a", "Sbase", "c1", "c0", "k_ee",
               "k_p")
SRC = ((2.0,),) * 4      # off-equilibrium: an O(1) kappa sensitivity


def _relerr(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-300)


_JIT = jax.jit


def _compile(fn, *args, level=0):
    """jax.jit(fn) compiled for args with XLA's backend optimisation off
    (level 0), or at level 1 without its fusion pass (the setting of
    test_torch_adjoint_k.py), whichever compiles the program faster. Pinned
    to one CPU core, the BDF2 step's interpret-mode backward (B10) compiles
    in ~3.7 s at level 1 against ~6.1 s at level 0; every other program
    here compiles 1.2-2x faster at level 0 (the B9 forwards, the tables,
    every value_and_grad). Neither option changes an operation's
    rounding."""
    opts = {"xla_backend_optimization_level": level,
            "xla_llvm_disable_expensive_passes": True}
    if level:
        opts["xla_disable_hlo_passes"] = "fusion"
    return _JIT(fn).lower(*args).compile(compiler_options=opts)


def _jit_opt_off(fn=None, **kw):
    """jax.jit for a plain jax.jit(fn) call, with each argument signature
    compiled by _compile; any other form goes to jax.jit itself."""
    if fn is None or kw:
        return _JIT(fn, **kw) if fn is not None else functools.partial(
            _JIT, **kw)
    compiled = {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = _compile(fn, *args)
        return compiled[key](*args)

    return call


def _both(path, **over):
    """(JAX cfg, JAX tables, port cfg, port tables), the port's tables the
    JAX ones as numpy."""
    jcfg = jax_load_config(path, **over)
    jt, _, _ = jax_transport.build_tables(jcfg)
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    return jcfg, jt, port.load_config(path, **over), pt


def _param_values(jt, key):
    return {"kappa": np.asarray(jt.kappa) * 1.1,
            "rho": np.asarray(jt.rho) * 0.9,
            "psi_source": np.asarray(jt.psi_source) * 1.05,
            "T": np.asarray(1.02)}[key]


# -- tables and coefficients --------------------------------------------------

@pytest.mark.parametrize("deck", [GRAY, MG], ids=["G1", "mg"])
@pytest.mark.parametrize("key", ["kappa", "rho", "psi_source", "T"])
def test_traced_tables_values_and_vjp(deck, key):
    jcfg, jt, pcfg, pt = _both(deck)
    x = _param_values(jt, key)
    rng = np.random.default_rng(5)

    def jf(v):
        t = jax_adj.traced_tables(jcfg, jt, **{key: v})
        return tuple(jnp.asarray(getattr(t, f), jnp.float64)
                     for f in TABLE_FIELDS)

    jvals, vjp = jax.vjp(jf, jnp.asarray(x, jnp.float64))
    cots = [rng.uniform(-1, 1, np.shape(v)) for v in jvals]
    (jgrad,) = vjp(tuple(jnp.asarray(c) for c in cots))

    tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    t = port_adj.traced_tables(pcfg, pt, **{key: tx})
    pvals = [getattr(t, f) for f in TABLE_FIELDS]
    for name, p, j in zip(TABLE_FIELDS, pvals, jvals):
        assert tuple(p.shape) == np.shape(j), name
        assert _relerr(p.detach().numpy(), j) <= 1e-12, name
    used = [(p, torch.as_tensor(c)) for p, c in zip(pvals, cots)
            if p.requires_grad]
    (pgrad,) = torch.autograd.grad([p for p, _ in used],
                                   [tx], [c for _, c in used])
    assert _relerr(pgrad.numpy(), jgrad) <= 1e-12


def test_kind_coeffs_traced_values_and_vjp():
    """The three BDF2 kinds' planes on the correction deck, as functions
    of (kappa, T), values and VJP."""
    jcfg, jt, pcfg, pt = _both(MG, N=64)
    assert pcfg.use_correction
    kappa, T = _param_values(jt, "kappa"), _param_values(jt, "T")
    half = pcfg.dt / 2.0
    rng = np.random.default_rng(6)

    def jf(k, temp):
        t = jax_adj.traced_tables(jcfg, jt, kappa=k, T=temp)
        return tuple(getattr(jax_fs.build_kind_coeffs_traced(
            jcfg, t, kind, half), f) for kind in (1, 2, 3)
            for f in COEF_FIELDS)

    jk, jT = jnp.asarray(kappa), jnp.asarray(T)
    jvals = _compile(jf, jk, jT)(jk, jT)
    cots = tuple(jnp.asarray(rng.uniform(-1, 1, np.shape(v))) for v in jvals)

    def jvjp(k, temp, c):
        return jax.vjp(jf, k, temp)[1](c)

    jgrads = _compile(jvjp, jk, jT, cots)(jk, jT, cots)

    tk = torch.tensor(kappa, requires_grad=True)
    tT = torch.tensor(T, requires_grad=True)
    t = port_adj.traced_tables(pcfg, pt, kappa=tk, T=tT)
    pvals = [getattr(port_fs.build_kind_coeffs_traced(pcfg, t, kind, half),
                     f) for kind in (1, 2, 3) for f in COEF_FIELDS]
    for p, j in zip(pvals, jvals):
        assert tuple(p.shape) == np.shape(j)
        assert _relerr(p.detach().numpy(), j) <= 1e-12
    # Host numpy build unchanged: the traced planes equal it at the deck.
    host = port_fs.build_kind_coeffs(pcfg, pt, 3, half, np.float64)
    t0 = port_adj.traced_tables(pcfg, pt)
    trc = port_fs.build_kind_coeffs_traced(pcfg, t0, 3, half)
    for f in COEF_FIELDS:
        assert _relerr(getattr(trc, f).numpy(), getattr(host, f)) <= 1e-15
    used = [(p, torch.tensor(np.asarray(c))) for p, c in zip(pvals, cots)
            if p.requires_grad]
    pgrads = torch.autograd.grad([p for p, _ in used], [tk, tT],
                                 [c for _, c in used])
    for p, j in zip(pgrads, jgrads):
        assert _relerr(p.numpy(), j) <= 1e-12


def test_traced_initial_state_matches_jax():
    """psi = ends = B_g from the traced tables, T flowing through B."""
    jcfg, jt, pcfg, pt = _both(MG, N=16)

    def jf(temp):
        t = jax_adj.traced_tables(jcfg, jt, T=temp)
        return jax_adj.traced_initial_state(jcfg, t).ends

    jv, vjp = jax.vjp(jf, jnp.asarray(1.02))
    cot = np.random.default_rng(9).uniform(-1, 1, jv.shape)
    (jg,) = vjp(jnp.asarray(cot))
    tT = torch.tensor(1.02, dtype=torch.float64, requires_grad=True)
    st = port_adj.traced_initial_state(pcfg, port_adj.traced_tables(
        pcfg, pt, T=tT))
    assert st.ends is st.prev_ends is st.half_ends
    assert _relerr(st.ends.detach().numpy(), jv) <= 1e-12
    (pg,) = torch.autograd.grad(st.ends, [tT], [torch.as_tensor(cot)])
    assert _relerr(pg.numpy(), jg) <= 1e-12
    host = port_transport.initial_state(pcfg, pt)
    assert np.array_equal(host.ends.numpy(), np.asarray(
        jax_transport.initial_state(jcfg, jt).ends))


# -- the sub-step adjoint -----------------------------------------------------

@pytest.mark.parametrize("kind", [port_fs.BE, port_fs.CN, port_fs.BDF])
def test_substep_adjoint_exact(kind):
    """The hand transpose equals torch autograd of the forward, float64."""
    pcfg = port.load_config(MG, N=32, M=4)
    pt, _, _ = port_transport.build_tables(pcfg)
    eng = port_cs.CudaSweepEngine(pcfg, pt, block=32, device="cpu")
    kc = eng.kcs[kind] if kind in eng.kcs else port_fs.build_kind_coeffs(
        pcfg, pt, kind, pcfg.dt, np.float64)
    packed = np.concatenate([np.asarray(getattr(kc, f), np.float64)[0]
                             for f in COEF_FIELDS], -1)[0]
    Bh, blk = packed.shape[0], 32
    rng = np.random.default_rng(3)

    def rand(shape):
        return torch.tensor(rng.uniform(0.3, 2.0, shape), requires_grad=True)

    planes = [rand((Bh, blk)) for _ in range(6)]
    small = [rand((Bh, 1)) for _ in range(3)]
    coef = torch.tensor(packed, requires_grad=True)
    first = torch.arange(blk)[None, :] < 1
    last = torch.arange(blk)[None, :] == blk - 1
    npass = len(port_cs._scan_strides(blk))
    masks = torch.as_tensor(port_cs._scan_masks(blk), dtype=torch.float64)
    mrev = torch.as_tensor(port_ca._rev_scan_masks(blk), dtype=torch.float64)
    kcs = port_cs._unpack_coef(coef)
    o0, o1, pr = port_ca._substep_vals(kind, kcs, first, masks, *planes,
                                       *small, npass)
    cot = [torch.tensor(rng.uniform(0.3, 2.0, s))
           for s in ((Bh, blk), (Bh, blk), (Bh, 1))]
    want = torch.autograd.grad((o0, o1, pr.carry_out),
                               planes + small + [coef], cot,
                               allow_unused=True)
    with torch.no_grad():
        got = port_ca._substep_adj(kind, kcs, last, mrev, pr,
                                   *planes, *cot, npass)
    gots = [got.e0, got.e1, got.p0, got.p1, got.h0, got.h1, got.c_in,
            got.ptail, got.htail, got.coef]
    for w, g in zip(want, gots):
        w = np.zeros(g.shape) if w is None else w.numpy()
        assert np.abs(w - g.numpy()).max() / (np.abs(w).max() + 1e-300) \
            < 1e-13


# -- plain B9 and B10 against the Pallas kernels in interpret mode ------------

KERNEL_CASES = [(3, True, False), (3, False, True), (1, True, False),
                (2, False, False)]


@pytest.fixture(scope="module", params=KERNEL_CASES,
                ids=lambda c: f"ts{c[0]}-{'refl' if c[1] else 'src'}-"
                              f"{'sym' if c[2] else 'asym'}")
def kernel_case(request):
    """One launch of each side: M = 4, G = 1, N = 64 in two blocks of 32."""
    ts, refl, sym = request.param
    over = dict(M=4, G=1, N=64, ts_method=ts, psi_source=SRC,
                bc_left_indicator=2 if refl else 1, bdf2_symmetric_half=sym)
    jcfg, jt, pcfg, pt = _both(GRAY, **over)
    je = jax_ps.PallasEngine(jcfg, jt, block=32)
    assert je.interpret, "the JAX side must run the Pallas interpreter"
    ds = jax_pa.DiffPallasStep(je)
    pe = port_cs.CudaSweepEngine(pcfg, pt, block=32, device="cpu")
    geo = port_ca.step_geometry(pe)
    assert (pe.block, pe.reflective) == (je.block, je.reflective)
    rng = np.random.default_rng(10 * ts + refl + 3 * sym)
    base = pe.init_state().e0.numpy()
    e0, e1 = [(base * rng.uniform(0.5, 1.5, base.shape)).astype(np.float32)
              for _ in range(2)]
    zero = np.zeros((2, pe.Bh, port_cs._NCOEF), np.float32)
    coefs = [pe.coef[k].numpy() if k in pe.coef else zero for k in (1, 2, 3)]
    cots = [rng.uniform(-1, 1, e0.shape).astype(np.float32)
            for _ in range(4)]
    if ts != 3:
        cots[2] = cots[3] = np.zeros_like(cots[0])
    jin = [jnp.asarray(c) for c in coefs] + [jnp.asarray(pe.bc.numpy()),
                                             ds.refl_P, ds.scan_masks,
                                             jnp.asarray(e0),
                                             jnp.asarray(e1)]
    jfwd = _compile(ds._fwd_call, *jin)(*jin)
    jbin = [jnp.asarray(c) for c in coefs] + [
        ds.refl_P, ds.scan_masks, ds.rev_masks, jnp.asarray(e0),
        jnp.asarray(e1)] + [jnp.asarray(c) for c in cots] + list(jfwd[6:])
    jbwd = _compile(ds._bwd_call, *jbin, level=int(ts == 3))(*jbin)
    t = [torch.as_tensor(c) for c in coefs]
    pfwd = port_ca.fwd_record_launch(
        *t, pe.bc, pe.flip, torch.as_tensor(e0), torch.as_tensor(e1), **geo)
    pbwd = port_ca.bwd_launch(
        *t, pe.flip, torch.as_tensor(e0), torch.as_tensor(e1),
        *map(torch.as_tensor, cots), *pfwd[4:], **geo)
    return dict(ts=ts, pe=pe, geo=geo, t=t, e=(e0, e1), jfwd=jfwd,
                jbwd=jbwd, pfwd=pfwd, pbwd=pbwd)


def test_fwd_record_b9(kernel_case):
    c = kernel_case
    # (o0, o1, h0, h1, rc, ret, rht) against the JAX outputs (o0, o1, h0,
    # h1, p0, p1, rc, ret, rht).
    for name, i, j in (("o0", 0, 0), ("o1", 1, 1), ("h0", 2, 2), ("h1", 3, 3),
                       ("rc", 4, 6), ("ret", 5, 7), ("rht", 6, 8)):
        got, ref = c["pfwd"][i].numpy(), np.asarray(c["jfwd"][j])
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 1e-6 * max(scale, 1e-30), name
    for i, plane in ((4, 0), (5, 1)):          # prev = the input ends
        assert np.array_equal(np.asarray(c["jfwd"][i]), c["e"][plane])


def test_fwd_record_b9_equals_b1(kernel_case):
    """The plain B9's step is the plain B1 (B2 for BE/CN) at K = 1: the
    same sub-step arithmetic in the same order, bit for bit."""
    c = kernel_case
    pe, geo = c["pe"], c["geo"]
    e0, e1 = map(torch.as_tensor, c["e"])
    if c["ts"] == 3:
        ref = port_cs.bdf2_launch_ref(
            *c["t"], pe.bc, pe.flip, e0, e1, K=1, s_be=geo["s_be"],
            s_cn=geo["s_cn"], s_bdf=geo["s_bdf"],
            reflective=geo["reflective"],
            symmetric_half=geo["symmetric_half"], blk=geo["blk"],
            npass_be=geo["npass"][1], npass_cn=geo["npass"][2],
            npass_bdf=geo["npass"][3])[:4]
    else:
        kind = c["ts"]
        ref = port_cs.multistep_launch_ref(
            kind, c["t"][kind - 1], pe.bc, pe.flip, e0, e1, K=1,
            s=geo["s_be"] if kind == 1 else geo["s_cn"],
            reflective=geo["reflective"], blk=geo["blk"],
            npass=geo["npass"][kind])[:2] + (e0, e1)
    for got, want in zip(c["pfwd"][:4], ref):
        assert torch.equal(got, want)


def test_bwd_b10(kernel_case):
    c = kernel_case
    for name, i, tol in (("ce0", 0, 1e-6), ("ce1", 1, 1e-6), ("cbc", 2, 1e-6),
                         ("gbe", 3, 1e-5), ("gcn", 4, 1e-5),
                         ("gbdf", 5, 1e-5)):
        got, ref = c["pbwd"][i].numpy(), np.asarray(c["jbwd"][i])
        assert got.shape == ref.shape, name
        scale = np.abs(ref).max()
        if scale == 0.0:                        # a kind the step never runs
            assert not got.any(), name
        else:
            assert np.abs(got - ref).max() <= tol * scale, name


def test_records_of_another_shape_refused(kernel_case):
    c = kernel_case
    pe, geo = c["pe"], c["geo"]
    e0, e1 = map(torch.as_tensor, c["e"])
    rc, ret, rht = c["pfwd"][4:]
    with pytest.raises(ValueError, match="records"):
        port_ca.bwd_launch_ref(*c["t"], pe.flip, e0, e1, e0, e1, e0, e1,
                               rc[..., :1], ret[..., :1], rht[..., :1],
                               **geo)


# -- the differentiable solve -------------------------------------------------

def _solve_pair(path, params, steps=3, **over):
    """value_and_grad of sum(ends^2) * 1e-2 through JAX make_diff_solve_fast
    (f64; its scan unrolled once, which only shrinks the program) and the
    port's make_diff_solve_cuda on the CPU."""
    jcfg, jt, pcfg, pt = _both(path, **over)
    sf = jax_adj.make_diff_solve_fast(jcfg, jt, num_steps=steps, unroll=1)
    jp = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
    jv, jg = _compile(jax.value_and_grad(
        lambda p: jnp.sum(sf(p, None).ends ** 2) * 1e-2), jp)(jp)
    sp = port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=steps,
                                      device="cpu")
    tp = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True)
          for k, v in params.items()}
    pv = torch.sum(sp(tp).ends ** 2) * 1e-2
    pv.backward()
    return (float(jv), jg), (float(pv.detach()),
                             {k: v.grad for k, v in tp.items()})


@functools.lru_cache(maxsize=None)
def _gray_pair(ts_method, bc_left):
    """_solve_pair on the gray off-equilibrium slab, differentiated in
    kappa, psi_source and T at once: one JAX program serves both the gray
    and the temperature tests (T at the deck's own 1.0 leaves the tables
    as they are)."""
    params = dict(kappa=np.ones(1), psi_source=np.asarray(SRC, np.float64),
                  T=np.asarray(1.0))
    return _solve_pair(GRAY, params, M=4, N=64, X=0.64, ts_method=ts_method,
                       max_timesteps=3, bc_left_indicator=bc_left,
                       psi_source=SRC)


@pytest.mark.parametrize("ts_method,bc_left", [
    (1, 1), (2, 1), (3, 1), (1, 2), (2, 2), (3, 2)])
def test_gray_grads_match_fast_adjoint(ts_method, bc_left):
    (jv, jg), (pv, pg) = _gray_pair(ts_method, bc_left)
    assert abs(pv - jv) / abs(jv) < 1e-5
    assert _relerr(pg["kappa"].numpy(), jg["kappa"]) < 2e-3
    assert _relerr(pg["psi_source"].numpy(), jg["psi_source"]) < 1e-4


def test_multigroup_correction_grads():
    jcfg = jax_load_config(MG, N=64)
    jt, _, _ = jax_transport.build_tables(jcfg)
    params = dict(kappa=np.asarray(jt.kappa, np.float64),
                  rho=np.full(jcfg.G, jcfg.rho))
    (jv, jg), (pv, pg) = _solve_pair(MG, params, N=64, max_timesteps=3)
    assert abs(pv - jv) / abs(jv) < 1e-5
    assert _relerr(pg["kappa"].numpy(), jg["kappa"]) < 2e-3
    assert _relerr(pg["rho"].numpy(), jg["rho"]) < 2e-3


def test_temperature_grad():
    """The T gradient of the gray BDF2 slab with a source left boundary,
    the deck's own method (JAX's test_temperature_grad case)."""
    (jv, jg), (pv, pg) = _gray_pair(3, 1)
    assert abs(pv - jv) / abs(jv) < 1e-5
    assert _relerr(pg["T"].numpy(), jg["T"]) < 2e-3


def test_initial_state_grad():
    """d loss / d initial State through the kernel step chain, against
    the JAX f64 fast adjoint, from the same numpy state."""
    jcfg, jt, pcfg, pt = _both(GRAY, M=4, N=64, X=0.64, max_timesteps=2)
    rng = np.random.default_rng(8)
    base = np.asarray(jt.B)[None, :, None, None]
    arrays = [base * rng.uniform(0.5, 1.5, (4, 1, 64, 2)) for _ in range(3)]
    sf = jax_adj.make_diff_solve_fast(jcfg, jt, num_steps=2, unroll=1)
    js = jax_transport.State(*map(jnp.asarray, arrays))
    jg = _compile(jax.grad(lambda s: jnp.sum(sf({}, s).ends ** 2)), js)(js)
    sp = port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=2, device="cpu")
    ps = port_adj.state_from_numpy(*arrays, requires_grad=True)
    torch.sum(sp({}, ps).ends ** 2).backward()
    for name in ("ends", "prev_ends", "half_ends"):
        # A BDF2 step reads neither the prev nor the half planes it is
        # given: no gradient reaches them (JAX's are zeros).
        got = getattr(ps, name).grad
        got = np.zeros((4, 1, 64, 2)) if got is None else got.numpy()
        assert np.abs(got - np.asarray(getattr(jg, name))).max() <= 1e-4 * (
            np.abs(np.asarray(jg.ends)).max()), name


def test_remat_group_gradients_unchanged():
    """torch.utils.checkpoint groups change memory, not the result: the
    recomputed forward is the same program, so the gradient is bit-equal
    (held at JAX's 1e-4). One step a launch, so that 7 steps make two
    groups of 3 launches and a tail (at the K-fused default, 7 steps are one
    4-step launch and 3 tail steps: no group forms; groups of K-step
    launches are test_torch_adjoint_k.py's test_kfused_remat_group)."""
    _, _, pcfg, pt = _both(GRAY, M=4, N=64, X=0.64, max_timesteps=7,
                           bc_left_indicator=1, psi_source=SRC)

    def gradof(**kw):
        sp = port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=7,
                                          steps_per_launch=1, device="cpu",
                                          **kw)
        k = torch.ones(1, dtype=torch.float64, requires_grad=True)
        torch.sum(sp({"kappa": k}).ends ** 2).backward()
        return k.grad.numpy()

    plain, remat = gradof(), gradof(remat_group=3)   # 2 groups of 3 + 1
    np.testing.assert_allclose(remat, plain, rtol=1e-4)


def test_bdf2_reflective_matches_pallas_k1():
    """The same float32 program as JAX make_diff_solve_pallas at K = 1
    (interpret mode): value and psi_source gradient within 1e-5. The kappa
    gradient is a cancellation of the step's pack gradients, so float32
    rounding moves it by ~1e-4 of itself in any implementation: JAX's own
    program gives 0.12539076 run eagerly and 0.12538361 compiled here
    (5.7e-5 apart), 1.5e-4 and 2.1e-4 from the float64 adjoint's
    0.12541001, and the port 0.12539793 (9.6e-5 from it). It is held at
    2e-4, between that spread and JAX's 2e-3 bar against float64."""
    over = dict(M=4, N=64, X=0.64, max_timesteps=2, bc_left_indicator=2,
                psi_source=SRC)
    jcfg, jt, pcfg, pt = _both(GRAY, **over)
    sf = jax_pa.make_diff_solve_pallas(jcfg, jt, num_steps=2,
                                       steps_per_launch=1)
    jp = {"kappa": jnp.ones(1, jnp.float64),
          "psi_source": jnp.asarray(SRC, jnp.float64)}
    jv, jg = _compile(jax.value_and_grad(
        lambda p: jnp.sum(sf(p, None).ends ** 2)), jp)(jp)
    sp = port_ca.make_diff_solve_cuda(pcfg, pt, num_steps=2,
                                      steps_per_launch=1, device="cpu")
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in jp.items()}
    pv = torch.sum(sp(tp).ends ** 2)
    pv.backward()
    assert abs(float(pv.detach()) - float(jv)) / abs(float(jv)) < 1e-5
    assert _relerr(tp["psi_source"].grad.numpy(), jg["psi_source"]) < 1e-5
    assert _relerr(tp["kappa"].grad.numpy(), jg["kappa"]) < 2e-4


def _study(cfg_cls, G=4, N=64, steps=4):
    """benchmarks/grad_convergence.run_study's problem."""
    return cfg_cls(
        M=4, G=G, N=N, X=1.0, efirst=0.1, elast=10.0,
        bc_left_indicator=2, bc_right_indicator=1,
        psi_source=tuple(tuple(0.02 + 0.005 * g for g in range(G))
                         for _ in range(4)),
        rho=1.0, kappa_grey=1.0, T=1.0, V=0.001, use_correction=True,
        ts_method=3, dt=5e-5, max_timesteps=steps, include_validation=False)


def test_fit_params_history_matches_jax(monkeypatch):
    steps, iters, lr = 4, 5, 0.08
    jcfg = _study(JaxConfig)
    jt, _, _ = jax_transport.build_tables(jcfg)
    pcfg = _study(PortConfig)
    pt = port_transport.tables_from_numpy(
        {k: np.asarray(v) for k, v in jt._asdict().items()})
    rng = np.random.default_rng(7)
    k_true = np.asarray(jt.kappa) * rng.uniform(0.6, 1.6, size=jcfg.G)
    wt = np.asarray(jt.wt)
    state0 = jax_transport.initial_state(jcfg, jt)
    truth = jax_adj.make_diff_solve_fast(jcfg, jt, num_steps=steps,
                                         unroll=1)

    def phi_of(k):
        return jax_transport.compute_phi(jax_transport.psi_from_ends(
            truth({"kappa": k}, state0).ends), wt)

    kt = jnp.asarray(k_true)
    phi_target = np.asarray(_compile(phi_of, kt)(kt))

    def jloss(final, params):
        phi = jax_transport.compute_phi(
            jax_transport.psi_from_ends(final.ends), wt)
        return jnp.mean((phi / phi_target - 1.0) ** 2)

    # JAX's fit jits its whole update step; compile it with XLA's backend
    # optimisation off, as every JAX program here (the same program).
    import optax  # noqa: F401  (its import-time jax.jit calls stay as they are)
    monkeypatch.setattr(jax, "jit", _jit_opt_off)
    _, jhist = jax_adj.fit_params(
        jcfg, jt, state0, jloss, {"kappa": jnp.asarray(jt.kappa)},
        num_steps=steps, learning_rate=lr, iterations=iters, solver="fast")
    monkeypatch.undo()

    twt, tphi = torch.tensor(wt), torch.tensor(phi_target)

    def ploss(final, params):
        phi = port_transport.compute_phi(
            port_transport.psi_from_ends(final.ends), twt)
        return torch.mean((phi / tphi - 1.0) ** 2)

    params, phist = port_adj.fit_params(
        pcfg, pt, port_transport.initial_state(pcfg, pt), ploss,
        {"kappa": np.asarray(jt.kappa)},
        num_steps=steps, learning_rate=lr, iterations=iters,
        solver="pallas", device="cpu")
    assert len(phist) == iters and phist[-1] < phist[0]
    assert params["kappa"].dtype == torch.float64
    # Measured 2.4e-4 at the last iteration, where the loss is ~2e-7: phi
    # lies within ~5e-4 of its target, so the float32 solve's rounding of
    # phi (~1e-7) weighs ~1e-4 of the loss. Held at 1e-3.
    np.testing.assert_allclose(phist, jhist, rtol=1e-3)


# -- refusals -----------------------------------------------------------------

def test_refusals():
    _, _, pcfg, pt = _both(GRAY, M=4, N=64, X=0.64, max_timesteps=2)
    args = (pcfg, pt, None, lambda s, p: s.ends.sum(), {"kappa": np.ones(1)})
    with pytest.raises(NotImplementedError, match="A2"):
        port_adj.fit_params(*args, solver="general", device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        port_adj.fit_params(*args, solver="fast", device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        port_adj.fit_params(*args, solver="xla", device="cpu")
    # The K-fused route builds at an explicit K (K > 64 is refused:
    # test_torch_adjoint_k.py).
    port_ca.make_diff_solve_cuda(pcfg, pt, steps_per_launch=4, device="cpu")
    sp = port_ca.make_diff_solve_cuda(pcfg, pt, device="cpu")
    with pytest.raises(ValueError, match="unknown differentiable"):
        sp({"sigma": np.ones(1)})


def test_card_path_needs_a_card():
    """Without a CUDA device the card path raises; nothing falls back to
    the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs this path")
    _, _, pcfg, pt = _both(GRAY, M=4, N=64, X=0.64, max_timesteps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ca.make_diff_solve_cuda(pcfg, pt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_adj.fit_params(pcfg, pt, None, lambda s, p: s.ends.sum(),
                            {"kappa": np.ones(1)}, solver="pallas")
    meta = torch.empty((2, 2, 64), device="meta")
    coef = torch.empty((2, 2, 10), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port_ca.fwd_record_launch(
            coef, coef, coef, torch.empty((2, 2, 1), device="meta"),
            torch.empty(2, dtype=torch.int32, device="meta"), meta, meta,
            ts_method=3, s_be=1.0, s_cn=2.0, s_bdf=6.0, reflective=False,
            symmetric_half=False, blk=32, npass={1: 5, 2: 5, 3: 5})
