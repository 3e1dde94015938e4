"""Packed-rows double-float halo engine on the fused K-step CUDA kernels
B14 and B15.

Port of radiative_transfer_tpu/parallel/df_halo.py (DFHaloEngine) on
torch.distributed (parallel/mesh.py): every rank holds its shard of the
(hi, lo) planes, cells over the spatial axis 'x' (Kx shards), batch rows
over the group axis 'g'. Both direction halves ride one launch as 2*Bh_l
packed rows, so a tiny batch (Bh < 8) keeps twice the thread blocks busy
that DFCudaEngine's reflective half-by-half launches do; that is why
``parallel.make_multichip_engine(engine="df")`` routes Bh < 8 here at one
device, and every df run on a mesh comes here.

The decomposition is the JAX engine's:

* Each launch group of K steps prepends an H-cell halo of (hi, lo) planes,
  the upstream shard's last H cells (one stacked ppermute over 'x'), and
  runs one fused launch over H + N_loc cells. Shard 0's halo is zeros and
  its chains re-seed where the own cells start (``reset`` = H / block)
  with the double-float boundary inflow: base carry and upwind o1 edge at
  its hi part, the inflow's lo part at its lo part, and no s-multiplier
  fold (the residual corrects the base's plain inflow); the other shards
  start from zero seeds at the halo start (reset 0).
* The JAX engine's truncated scans cap a df sub-step's upwind reach at
  ``reach`` = 2^(npass+1) + 2^(npass_c+1) + 2 cells (base scan, the
  residual's one-cell coupling, correction scan, the history shifts), so a
  seed error creeps at most (sub-steps) * reach cells in a launch and H
  covers it. The constructor keeps that bound, with the same errors,
  because the plain versions (ops/cuda_df.df_halo_*_launch_ref) reproduce
  the JAX kernels.
* A reflective left boundary couples the mu<0 CORRECTED outflow
  two_sum(base o1 edge, correction carry) at the end of the chain (shard
  Kx-1) into the mu>0 inflow at shard 0 per (step, phase), known only
  after the launch. The main launch runs the mu>0 rows with zero seeds and
  records every chain's outflow; one ppermute brings shard Kx-1's (hi, lo)
  record to shard 0 (and a gather over 'g' the flipped rows), where a
  fixup launch recomputes the own cells [0, H) with the flipped mu<0
  record as (hi, lo) seeds and is spliced over them.

The CUDA kernels scan exactly, so a zero seed's influence past H is not
zero but a^H-small (a < 1 the carry multiplier): far below double-float
roundoff wherever the creep bound admits the workload (csrc/df_sweep.cu
header).

Selection differs from the JAX engine's in one rule only: the block walk
drops the Mosaic "block % 128" rule, as HaloCudaEngine does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.config import Config
from ..ops import cuda_df as cd
from ..ops import cuda_sweep as cs
from ..ops import df
from ..ops import fast_sweep as fs
from ..ops.cuda_df import DFState
from ..ops.fast_sweep import BDF, BE, CN, FlatState
from .mesh import Mesh, ShardedLayout

_GUIDE = "use the plain double-float DFCudaEngine (--engine df)"


class DFHaloCudaEngine(ShardedLayout, cd.DFLayout):
    """The counterpart of DFHaloEngine: double-float DFState planes
    (2, Bh_l, N_loc) float32 of this rank's shard on `device`, K_launch
    whole steps a launch group. `mesh=None` is one device."""

    def __init__(self, cfg: Config, tables, block: Optional[int] = None,
                 steps_per_launch: Optional[int] = None,
                 scan_tol: float = 1e-10, device="cuda",
                 mesh: Optional[Mesh] = None):
        sh = self._shard(cfg, tables, mesh, device)
        Mh, G = self.Mh, self.G

        # -- block choice (df_halo.py:124-151): the f32 halo's divisor walk
        #    at the df target rows*blk <= 2^16; the Mosaic-only
        #    multiple-of-128 rule does not apply ----------------------------
        auto_block = block is None
        if auto_block:
            block = 2048
        blk = 1
        while (blk * 2 <= min(block, self.N_loc)
               and self.N_loc % (blk * 2) == 0):
            blk *= 2
        while auto_block and self.rows * blk > (1 << 16) and blk > 128:
            blk //= 2
        if auto_block:
            while (self.rows * blk * 2 <= (1 << 16) and blk < self.N_loc
                   and self.N_loc % (blk * 2) == 0):
                blk *= 2
        if blk < 2:
            raise ValueError(
                f"N_loc={self.N_loc} has no usable power-of-two block "
                f"(per-shard cell count must be even) — {_GUIDE} or "
                "adjust N/mesh")
        self.block = blk
        self.nblocks = self.N_loc // blk

        # -- coefficients and double-float boundary values -------------------
        self.kcs = fs.kind_coeffs(cfg, tables, np.float32)

        def npass(tol):
            return {kind: cs._scan_npass(
                float(np.max(np.asarray(kc.a, dtype=np.float64))), blk, tol)
                for kind, kc in self.kcs.items()}

        self.scan_npass = npass(scan_tol)
        self.corr_npass = npass(cd.CORR_SCAN_TOL)

        bc_neg, bc_pos = fs.boundary_planes(cfg, tables, np.float64)
        self.reflective = bc_pos is None
        if self.reflective:
            bc_pos = np.zeros(self.Bh)     # mu>0 rows: fixed up per group
        bch, bcl = df.np_df(np.stack([bc_neg, bc_pos]))
        dev, rows_g = self.device, sh.rows

        def packed(x, cols):
            """(2, Bh, ...) -> this rank's packed (rows, cols): the
            (2, Bh_l) leading dims collapse, positional."""
            return torch.as_tensor(np.ascontiguousarray(x[:, rows_g]),
                                   device=dev).reshape(self.rows, cols)

        self.bch = packed(bch, 1)
        self.bcl = packed(bcl, 1)
        self.flip = torch.as_tensor(fs._refl_flip_indices(Mh, G).copy(),
                                    device=dev)
        self.coef = {kind: packed(cs._pack_coeffs(kc), cs._NCOEF)
                     for kind, kc in self.kcs.items()}
        self.dcoef = {kind: packed(cd._pack_df_coeffs(cfg, tables, kind,
                                                      kc.ts), cd._NDF)
                      for kind, kc in self.kcs.items()}

        # -- halo regime: the creep bound (df_halo.py:178-215) ----------------
        npass_max = max(self.scan_npass.values())
        npass_c_max = max(self.corr_npass.values())
        if (1 << max(npass_max, npass_c_max)) > blk // 2:
            raise ValueError(
                f"scan truncation reaches 2^{max(npass_max, npass_c_max)} "
                f"of block {blk}: carry influence is unbounded (optically "
                f"thin workload) — {_GUIDE}")
        reach = (1 << (npass_max + 1)) + (1 << (npass_c_max + 1)) + 2
        self._subs = 4 if cfg.ts_method == 3 else 1
        # Fusion depth: the df frontier with packed rows in place of Bh.
        p = self.rows * blk
        if cfg.ts_method in (1, 2):
            cap = 8 if self.rows <= 32 else 4
        elif p <= (1 << 15):
            cap = 8
        elif p < (1 << 16):
            cap = 4
        else:
            cap = 2
        if steps_per_launch is not None:
            cap = min(cap, max(1, steps_per_launch))
        K = cap
        while K >= 1:
            hb = -(-(self._subs * K * reach) // blk)
            if hb * blk <= self.N_loc:
                break
            K -= 1
        if K < 1:
            raise ValueError(
                f"halo for even 1 step/launch ({self._subs * reach} cells, "
                f"influence reach {reach}) exceeds N_loc={self.N_loc} — "
                f"{_GUIDE} or use more cells")
        self.K_launch = K
        self.hb = -(-(self._subs * K * reach) // blk)
        self.H = self.hb * blk
        self.reach = reach
        self._seed_cache: dict = {}

    # -- seeds -----------------------------------------------------------------

    def _main_seeds(self, K: int):
        """(rows, C) (hi, lo) chain seeds of the main launch: the
        double-float boundary inflow (reflective mu>0 rows zero, fixed up
        after the launch). Kept per K on the device: a host-to-device copy
        in every launch group would wait for the queued kernels."""
        if K not in self._seed_cache:
            C = 4 * K if self.cfg.ts_method == 3 else K
            self._seed_cache[K] = tuple(
                (b if self.shards.xk == 0 else torch.zeros_like(b))
                .expand(self.rows, C).contiguous()
                for b in (self.bch, self.bcl))
        return self._seed_cache[K]

    def _fix_seeds(self, K: int, och: torch.Tensor, ocl: torch.Tensor):
        """(rows, C) (hi, lo) reflective fixup seeds of shard 0: mu<0 rows
        repeat the main seeds, mu>0 rows take the direction-flipped mu<0
        corrected end-of-chain record of shard Kx-1 (solver.cpp:679-683)."""
        Bh_l = self.Bh_l
        return tuple(
            torch.cat([s[:Bh_l], self.shards.group_flip(r[:Bh_l],
                                                        self.flip)], dim=0)
            for s, r in zip(self._main_seeds(K), (och, ocl)))

    def _halo_slices(self, st: DFState):
        """The upstream neighbour's last H cells of the (e0 hi, e0 lo, e1
        hi, e1 lo) planes, moved with ONE stacked ppermute over 'x'; shard
        0 receives zeros (its halo is skipped through `reset`)."""
        if self.Kx == 1:
            z = st.hi.e0.new_zeros((2, self.Bh_l, self.H))
            return z, z, z, z
        H = self.H
        sl = torch.stack([st.hi.e0[..., -H:], st.lo.e0[..., -H:],
                          st.hi.e1[..., -H:], st.lo.e1[..., -H:]])
        moved = self.mesh.ppermute(sl, "x",
                                   [(i, i + 1) for i in range(self.Kx - 1)])
        return tuple(moved)

    def _launch(self, K: int, seeds, reset: int, planes):
        """One packed kernel launch over four (2, Bh, X) planes; returns
        the (2, Bh, X) output planes and the (rows, C) record (hi, lo)."""
        xs = [p.reshape(self.rows, -1) for p in planes]
        kw = dict(K=K, use_corr=bool(self.cfg.use_correction),
                  blk=self.block)
        if self.cfg.ts_method == 3:
            outs = cd.df_halo_bdf2_launch(
                self.coef[BE], self.coef[CN], self.coef[BDF],
                self.dcoef[BE], self.dcoef[CN], self.dcoef[BDF], *seeds,
                reset, *xs, symmetric_half=self.cfg.bdf2_symmetric_half,
                npass=self.scan_npass, npass_c=self.corr_npass, **kw)
        else:
            kind = BE if self.cfg.ts_method == 1 else CN
            outs = cd.df_halo_multistep_launch(
                kind, self.coef[kind], self.dcoef[kind], *seeds, reset, *xs,
                npass=self.scan_npass[kind], npass_c=self.corr_npass[kind],
                **kw)
        return [o.reshape(2, self.Bh_l, -1) for o in outs[:-2]], outs[-2:]

    def _launch_group(self, st: DFState, K: int) -> DFState:
        """K whole timesteps: halo -> one fused launch over the extended
        domain -> (reflective) seed fixup splice."""
        H, xk = self.H, self.shards.xk
        hi, lo = st
        ins = (hi.e0, lo.e0, hi.e1, lo.e1)
        xe = [torch.cat([h, p], dim=-1)
              for h, p in zip(self._halo_slices(st), ins)]
        planes, (och, ocl) = self._launch(K, self._main_seeds(K),
                                          0 if xk else self.hb, xe)
        planes = [p[..., H:] for p in planes]
        if self.reflective:
            if self.Kx > 1:
                och, ocl = self.mesh.ppermute(torch.stack([och, ocl]),
                                              "x", [(self.Kx - 1, 0)])
            if xk == 0:
                fix, _ = self._launch(K, self._fix_seeds(K, och, ocl), 0,
                                      [p[..., :H].contiguous() for p in ins])
                # The main launch's outputs are this engine's own buffers:
                # splice the fixup over the first H own cells in place.
                for p, f in zip(planes, fix):
                    p[..., :H] = f
        if self.cfg.ts_method == 3:
            (ne0h, ne0l, ne1h, ne1l, nh0h, nh0l, nh1h, nh1l,
             np0h, np0l, np1h, np1l) = planes
            return DFState(FlatState(ne0h, ne1h, np0h, np1h, nh0h, nh1h),
                           FlatState(ne0l, ne1l, np0l, np1l, nh0l, nh1l))
        ne0h, ne0l, ne1h, ne1l, np0h, np0l, np1h, np1l = planes
        return DFState(FlatState(ne0h, ne1h, np0h, np1h, hi.h0, hi.h1),
                       FlatState(ne0l, ne1l, np0l, np1l, lo.h0, lo.h1))

    # -- time stepping ---------------------------------------------------------

    def solve(self, state: Optional[DFState] = None,
              num_steps: Optional[int] = None) -> DFState:
        """Run n timesteps, K_launch per fused launch group plus a tail."""
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()
        Kd = min(self.K_launch, max(n, 1))
        body, tail = divmod(n, Kd)
        for _ in range(body):
            state = self._launch_group(state, Kd)
        if tail:
            state = self._launch_group(state, tail)
        return state
