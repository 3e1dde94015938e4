"""Per-sub-step mesh engine on the zero-inflow CUDA kernel B8.

Port of radiative_transfer_tpu/parallel/sharded_pallas.py
(ShardedPallasEngine) on torch.distributed (parallel/mesh.py). Every rank
holds its shard of the (2, Bh, N) planes: cells over the spatial axis
'x', batch rows over the group axis 'g'. The decomposition is the JAX
engine's:

* Per sub-step each shard launches B8 (ops/cuda_sweep
  .sharded_substep_launch) with ZERO inflow and no reflective coupling,
  both direction halves packed into 2*Bh_l rows. The recurrence is affine
  with a spatially constant carry multiplier a, so the shard's true output
  differs from the zero-inflow one by a closed form, o0(j) += d0 a^j inc,
  o1(j) += a^(j+1) inc, inc the carry entering the shard's first cell.
  Each shard's composite map is (A, B): A = a^N_loc a host constant, B
  the zero-inflow outflow read off the launch.
* ONE all_gather of the (2, Bh_l) B values over 'x' a sub-step folds the
  global chain (in float32, in the JAX order), gives the reflective mu>0
  inflow from the global mu<0 outflow (a gather over 'g' where the rows
  are split), and every shard its inc. The correction is not
  materialised: it rides along as a pending (inc, kind) tag and B8 applies
  it when it loads the planes of the next sub-step.
* The CN/BDF one-cell upwind shift crosses shard boundaries at the first
  local cell: one ppermute of the corrected last-cell edge per history
  plane (shard 0 keeps the zero fill, folded into the inflow).

At a one-rank mesh the collectives are skipped, as the JAX engine's
K == 1 branches skip them. The JAX engine takes its coefficients from
FastEngine; the port takes the same arrays from ops/fast_sweep
(kind_coeffs, boundary_planes, _refl_flip_indices). float32 only; a CPU
device runs B8's plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config.config import Config
from ..ops import cuda_sweep as cs
from ..ops import fast_sweep as fs
from ..ops.fast_sweep import BDF, BE, CN
from .mesh import Mesh, ShardedLayout


class ZState(NamedTuple):
    """Lazy sweep state of one rank: zero-inflow planes (2, Bh_l, N_loc)
    and the pending inflow corrections inc_* (2, Bh_l, 1), the carry that
    entered the shard's first cell when the producing sub-step ran."""

    e0: torch.Tensor
    e1: torch.Tensor
    p0: torch.Tensor
    p1: torch.Tensor
    h0: torch.Tensor
    h1: torch.Tensor
    inc_e: torch.Tensor
    inc_p: torch.Tensor
    inc_h: torch.Tensor


def _cc_arrays(kc: fs.KindCoeffs):
    """The float64 (2, Bh) correction coefficients (d0, a) of one kind,
    d0 = T0 w / det."""
    a = np.asarray(kc.a, dtype=np.float64)[0, :, :, 0]
    d0 = (np.asarray(kc.T0, dtype=np.float64)
          * np.asarray(kc.w, dtype=np.float64)
          * np.asarray(kc.inv_det, dtype=np.float64))[0, :, :, 0]
    return d0, a


def _pack_cc(d0: np.ndarray, a: np.ndarray) -> np.ndarray:
    """[d0, a, ln_a] (2, Bh, 3) float32; ln(a) clamped to >= -80 so that
    exp(j ln_a) is NaN-free at j = 0 even where a underflows float32."""
    with np.errstate(divide="ignore"):
        ln_a = np.maximum(np.log(a), -80.0)
    return np.stack([d0, a, ln_a], axis=-1).astype(np.float32)


class ShardedCudaEngine(ShardedLayout, cs.FlatLayout):
    """The counterpart of ShardedPallasEngine: the whole time loop on a
    mesh of ranks, four B8 launches and four exchanges a BDF2 step (one
    each for BE/CN)."""

    def __init__(self, cfg: Config, tables, mesh: Optional[Mesh] = None,
                 block: Optional[int] = None, scan_tol: float = 1e-10,
                 device="cuda"):
        sh = self._shard(cfg, tables, mesh, device)
        self.scan_tol = scan_tol
        Mh, G = self.Mh, self.G

        # The block rule (sharded_pallas.py:148-174): it shapes the plain
        # version's blocked scan; the kernel tiles the shard its own way.
        auto_block = block is None
        if auto_block:
            block = 2048
        blk = 1
        while (blk * 2 <= min(block, self.N_loc)
               and self.N_loc % (blk * 2) == 0):
            blk *= 2
        while 2 * self.Bh_l * blk > (1 << 17) and blk > 128:
            blk //= 2
        if blk < min(8, self.N_loc):
            blk = self.N_loc
        if auto_block:
            while (2 * self.Bh_l * blk * 2 <= (1 << 16)
                   and blk < self.N_loc
                   and self.N_loc % (blk * 2) == 0):
                blk *= 2
        self.block = blk
        self.nblocks = self.N_loc // blk

        self.kcs = fs.kind_coeffs(cfg, tables, np.float32)
        bc_neg, bc_pos = fs.boundary_planes(cfg, tables, np.float32)
        self.reflective = bc_pos is None
        if self.reflective:
            bc_pos = np.zeros_like(bc_neg)
        self._kind_s = {k: float(kc.s) for k, kc in self.kcs.items()}
        self.scan_npass = {
            kind: cs._scan_npass(
                float(np.max(np.asarray(kc.a, dtype=np.float64))),
                self.block, scan_tol)
            for kind, kc in self.kcs.items()
        }

        # Host constants (sharded_pallas.py:197-228), this rank's rows.
        dev, rows_g = self.device, sh.rows

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        self.bc_neg = put(bc_neg[rows_g])
        self.bc_pos = put(bc_pos[rows_g])
        self.flip = put(fs._refl_flip_indices(Mh, G))
        self.coef, self.cc, self.A = {}, {}, {}
        for kind, kc in self.kcs.items():
            d0, a = _cc_arrays(kc)
            cc = _pack_cc(d0, a)[:, rows_g]
            self.coef[kind] = put(cs._pack_coeffs(kc)[:, rows_g]
                                  .reshape(self.rows, cs._NCOEF))
            self.cc[kind] = put(cc)                          # (2, Bh_l, 3)
            self.A[kind] = put((a ** self.N_loc).astype(np.float32)
                               [:, rows_g])                  # (2, Bh_l)
        if cfg.ts_method == 3:
            # Half-snapshot slot: mu<0 rows CN-produced, mu>0 rows
            # BE-produced (reference quirk, solver.cpp:733 vs 784-787)
            # unless the corrected symmetric scheme is on.
            if cfg.bdf2_symmetric_half:
                self.cc_h, self.A_h = self.cc[CN], self.A[CN]
            else:
                self.cc_h = torch.cat([self.cc[CN][:1], self.cc[BE][1:]])
                self.A_h = torch.cat([self.A[CN][:1], self.A[BE][1:]])

    # -- sharded pieces ---------------------------------------------------------

    def _corr(self, inc: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
        """(inc (2, Bh_l, 1), cc (2, Bh_l, 3)) -> B8's packed (rows, 4)."""
        return torch.cat([inc, cc], dim=-1).reshape(self.rows, 4)

    def _halo(self, corrected_last: torch.Tensor) -> torch.Tensor:
        """The upstream shard's corrected last-cell edge (2, Bh_l, 1);
        shard 0 receives zeros (the folded boundary)."""
        if self.Kx == 1:
            return torch.zeros_like(corrected_last)
        return self.mesh.ppermute(corrected_last, "x",
                                  [(i, i + 1) for i in range(self.Kx - 1)])

    def _exchange(self, kind: int, totb: torch.Tensor) -> torch.Tensor:
        """Fold the shards' zero-inflow composites into this shard's true
        incoming carry (2, Bh_l, 1), in float32 in the JAX order. A is the
        same on every shard, so only the B values travel."""
        A = self.A[kind]                                    # (2, Bh_l)
        s = self._kind_s[kind]
        if self.Kx == 1:
            exclA = torch.ones_like(A)
            exclB = torch.zeros_like(totb)
            totA, totB = A, totb
        else:
            gB = self.mesh.all_gather(totb, "x")           # (Kx, 2, Bh_l)
            k = self.shards.xk
            accA, accB = torch.ones_like(A), torch.zeros_like(totb)
            exclA, exclB = accA, accB
            for i in range(self.Kx):
                if k == i:
                    exclA, exclB = accA, accB
                accA, accB = A * accA, A * accB + gB[i]
            totA, totB = accA, accB

        init_neg = s * self.bc_neg                          # (Bh_l,)
        if not self.reflective:
            bc_pos = self.bc_pos
        else:
            out_neg = totA[0] * init_neg + totB[0]
            bc_pos = self.shards.group_flip(out_neg, self.flip)
        inflow = torch.stack([init_neg, s * bc_pos], dim=0)  # (2, Bh_l)
        return (exclA * inflow + exclB)[..., None]

    def _launch(self, kind: int, corrs, halos, planes):
        """One B8 launch on (2, Bh_l, N_loc) planes; returns (z0, z1) so."""
        packed = [p.reshape(self.rows, -1) for p in planes]
        z0, z1 = cs.sharded_substep_launch(
            kind, self.coef[kind], corrs,
            [h.reshape(self.rows, 1) for h in halos], packed,
            blk=self.block, npass=self.scan_npass[kind])
        shape = (2, self.Bh_l, self.N_loc)
        return z0.reshape(shape), z1.reshape(shape)

    def _step(self, st: ZState) -> ZState:
        cfg = self.cfg
        if cfg.ts_method == 1:
            z0, z1 = self._launch(BE, [self._corr(st.inc_e, self.cc[BE])],
                                  [], (st.e0, st.e1))
            inc = self._exchange(BE, z1[:, :, -1])
            return ZState(z0, z1, st.e0, st.e1, st.h0, st.h1,
                          inc, st.inc_e, st.inc_h)
        if cfg.ts_method == 2:
            ce = self._corr(st.inc_e, self.cc[CN])
            halo = self._halo(st.e1[:, :, -1:]
                              + self.A[CN][..., None] * st.inc_e)
            z0, z1 = self._launch(CN, [ce, ce], [halo],
                                  (st.e0, st.e1, st.e1))
            inc = self._exchange(CN, z1[:, :, -1])
            return ZState(z0, z1, st.e0, st.e1, st.h0, st.h1,
                          inc, st.inc_e, st.inc_h)

        # BDF2 4-phase cycle (solver.cpp:594-598, 620-625, 700-811); prev
        # for every phase = this step's INPUT ends (committed at phase 0).
        ce_in = self._corr(st.inc_e, self.cc[BDF])  # input ends: BDF-made
        halo_e = self._halo(st.e1[:, :, -1:]
                            + self.A[BDF][..., None] * st.inc_e)
        # Phase 0: BE(dt/2) predictor.
        b0, b1 = self._launch(BE, [ce_in], [], (st.e0, st.e1))
        inc0 = self._exchange(BE, b1[:, :, -1])
        # Phase 1: CN(dt/2) corrector; prev = input ends.
        c0, c1 = self._launch(CN, [self._corr(inc0, self.cc[BE]), ce_in],
                              [halo_e], (b0, b1, st.e1))
        inc1 = self._exchange(CN, c1[:, :, -1])
        # Half snapshot: mu<0 = CN output, mu>0 = phase-0 BE output
        # (reference quirk, solver.cpp:733 vs 784-787).
        if cfg.bdf2_symmetric_half:
            h0z, h1z, inc_h = c0, c1, inc1
        else:
            h0z = torch.cat([c0[:1], b0[1:]])
            h1z = torch.cat([c1[:1], b1[1:]])
            inc_h = torch.cat([inc1[:1], inc0[1:]])
        # Phase 2: second BE(dt/2) predictor.
        d0_, d1_ = self._launch(BE, [self._corr(inc1, self.cc[CN])], [],
                                (c0, c1))
        inc2 = self._exchange(BE, d1_[:, :, -1])
        # Phase 3: BDF2 corrector (prev = input ends, half = snapshot).
        halo_h = self._halo(h1z[:, :, -1:] + self.A_h[..., None] * inc_h)
        f0, f1 = self._launch(
            BDF, [self._corr(inc2, self.cc[BE]), ce_in,
                  self._corr(inc_h, self.cc_h)],
            [halo_e, halo_h], (d0_, d1_, st.e0, st.e1, h0z, h1z))
        inc3 = self._exchange(BDF, f1[:, :, -1])
        return ZState(f0, f1, st.e0, st.e1, h0z, h1z,
                      inc3, st.inc_e, inc_h)

    # -- materialisation and layout --------------------------------------------

    def _materialize_local(self, z0, z1, inc, cc):
        """The pending correction applied to (2, Bh_l, N_loc) planes."""
        j = torch.arange(self.N_loc, dtype=torch.float32,
                         device=z0.device)[None, :]
        t0, t1 = cs._corrected(z0.reshape(self.rows, -1),
                               z1.reshape(self.rows, -1),
                               self._corr(inc, cc), j)
        return t0.reshape(z0.shape), t1.reshape(z1.shape)

    def _slot_cc(self, slot: str) -> torch.Tensor:
        """The correction coefficients of the kind that produced a state
        slot (e, p or h)."""
        ts = self.cfg.ts_method
        if ts in (1, 2):
            return self.cc[BE if ts == 1 else CN]
        return self.cc_h if slot == "h" else self.cc[BDF]

    def _materialize(self, st: ZState):
        """This rank's true (e0, e1, p0, p1, h0, h1) planes."""
        out = []
        for slot, (z0, z1, inc) in (("e", (st.e0, st.e1, st.inc_e)),
                                    ("p", (st.p0, st.p1, st.inc_p)),
                                    ("h", (st.h0, st.h1, st.inc_h))):
            out.extend(self._materialize_local(z0, z1, inc,
                                               self._slot_cc(slot)))
        return tuple(out)

    def _zeros_inc(self) -> torch.Tensor:
        return torch.zeros((2, self.Bh_l, 1), dtype=torch.float32,
                           device=self.device)

    def init_state(self) -> ZState:
        """psi = ends = B_g everywhere (src/solver.cpp:165-181)."""
        inc = self._zeros_inc()
        return ZState(*super().init_state(), inc, inc, inc)

    def from_ends(self, ends, prev, half) -> ZState:
        """Global (M, G, N, 2) arrays -> this rank's exact ZState (no
        pending correction)."""
        inc = self._zeros_inc()
        return ZState(*super().from_ends(ends, prev, half), inc, inc, inc)

    def ends(self, st: ZState) -> torch.Tensor:
        e0, e1 = self._materialize_local(st.e0, st.e1, st.inc_e,
                                         self._slot_cc("e"))
        return self.ends_pair(e0, e1)

    def prev_half_ends(self, st: ZState):
        """(prev_ends, half_ends) in the global (M, G, N, 2) layout."""
        _, _, p0, p1, h0, h1 = self._materialize(st)
        return self.ends_pair(p0, p1), self.ends_pair(h0, h1)
