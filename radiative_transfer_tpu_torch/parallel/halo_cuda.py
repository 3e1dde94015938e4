"""Packed-rows halo engine on the fused K-step CUDA kernels B4 and B5.

Port of radiative_transfer_tpu/parallel/halo_pallas.py (HaloPallasEngine)
on torch.distributed (parallel/mesh.py): every rank holds its shard of
the planes, cells over the spatial axis 'x' (Kx shards), batch rows over
the group axis 'g'. Both direction halves ride one launch as 2*Bh_l
packed rows, so a tiny batch (Bh < 8) keeps twice the thread blocks busy
that the plain engine's reflective half-by-half launches do; that is why
``parallel.make_multichip_engine`` routes Bh < 8 here at one device.

The decomposition is the JAX engine's:

* Each launch group of K steps prepends an H-cell halo, the upstream
  shard's last H cells (one ppermute over 'x'), and runs one fused launch
  over H + N_loc cells with zero seeds at the halo start. Shard 0 has no
  upstream: its halo is zeros and the chains re-seed with the boundary
  inflow where the own cells start (``reset`` = H / block); the other
  shards re-seed nothing (reset 0, zero seeds).
* The JAX engine's truncated scan caps a sub-step's upwind reach at
  ``reach`` = 2^(npass+1) cells, so a seed error creeps at most
  (sub-steps) * reach cells in a launch and H covers it. The constructor
  keeps that bound, with the same errors, because the plain versions
  (ops/cuda_sweep.halo_*_launch_ref) reproduce the JAX kernels exactly.
* A reflective left boundary couples the mu<0 outflow at the end of the
  chain (shard Kx-1) into the mu>0 inflow at shard 0 per (step, phase),
  known only after the launch. The main launch runs the mu>0 rows with
  zero seeds and records every chain's end carries; one ppermute brings
  shard Kx-1's record to shard 0 (and a gather over 'g' the flipped rows),
  where a fixup launch recomputes the own cells [0, H) with the flipped
  mu<0 record as seeds and is spliced over them.

The CUDA kernels scan exactly, so a seed's influence past H is not zero
but a^H-small (a < 1 the carry multiplier): below f32 roundoff wherever
the creep bound admits the workload (csrc/sweep.cu header).

float32 only; on the CPU the wrappers run the plain versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.config import Config
from ..ops import cuda_sweep as cs
from ..ops import fast_sweep as fs
from ..ops.fast_sweep import BDF, BE, CN, FlatState
from .mesh import Mesh, ShardedLayout


class HaloCudaEngine(ShardedLayout, cs.FlatLayout):
    """The counterpart of HaloPallasEngine: exact FlatState planes
    (2, Bh_l, N_loc) float32 of this rank's shard on `device`, K_launch
    whole steps a launch group. `mesh=None` is one device."""

    def __init__(self, cfg: Config, tables, block: Optional[int] = None,
                 steps_per_launch: Optional[int] = None,
                 scan_tol: float = 1e-10, device="cuda",
                 mesh: Optional[Mesh] = None):
        sh = self._shard(cfg, tables, mesh, device)
        self.scan_tol = scan_tol
        Mh, G = self.Mh, self.G

        # -- block choice (halo_pallas.py:119-156; the Mosaic-only
        #    multiple-of-128 rule does not apply) ---------------------------
        auto_block = block is None
        if auto_block:
            block = 2048
        blk = 1
        while (blk * 2 <= min(block, self.N_loc)
               and self.N_loc % (blk * 2) == 0):
            blk *= 2
        while auto_block and self.rows * blk > (1 << 17) and blk > 128:
            blk //= 2
        if auto_block and cfg.ts_method == 3:
            while self.rows * blk > (1 << 16) and blk > 512:
                blk //= 2
        if auto_block:
            while (self.rows * blk * 2 <= (1 << 16) and blk < self.N_loc
                   and self.N_loc % (blk * 2) == 0):
                blk *= 2
        if blk < 2:
            raise ValueError(
                f"N_loc={self.N_loc} has no usable power-of-two block "
                "(per-shard cell count must be even) — use "
                "ShardedCudaEngine or adjust N/mesh")
        self.block = blk
        self.nblocks = self.N_loc // blk

        # -- coefficients and boundary values --------------------------------
        self.kcs = fs.kind_coeffs(cfg, tables, np.float32)
        bc_neg, bc_pos = fs.boundary_planes(cfg, tables, np.float32)
        self.reflective = bc_pos is None
        if self.reflective:
            bc_pos = np.zeros_like(bc_neg)   # mu>0 rows: fixed up per group
        dev, rows_g = self.device, sh.rows
        self.bc = torch.as_tensor(                             # (2, Bh_l, 1)
            np.ascontiguousarray(np.stack([bc_neg, bc_pos])[:, rows_g,
                                                            None]),
            device=dev)
        self.flip = torch.as_tensor(fs._refl_flip_indices(Mh, G).copy(),
                                    device=dev)
        # Packed (rows, NCOEF): the (2, Bh_l) leading dims collapse,
        # positional.
        self.coef = {kind: torch.as_tensor(np.ascontiguousarray(
            cs._pack_coeffs(kc)[:, rows_g]), device=dev)
            .reshape(self.rows, cs._NCOEF)
            for kind, kc in self.kcs.items()}

        self.scan_npass = {
            kind: cs._scan_npass(
                float(np.max(np.asarray(kc.a, dtype=np.float64))), blk,
                scan_tol)
            for kind, kc in self.kcs.items()
        }

        # -- halo regime: the creep bound (halo_pallas.py:177-203) -----------
        npass_max = max(self.scan_npass.values())
        if (1 << npass_max) > blk // 2:
            raise ValueError(
                f"scan truncation reaches 2^{npass_max} of block {blk}: "
                "carry influence is unbounded (optically thin workload) — "
                "use ShardedCudaEngine")
        reach = 1 << (npass_max + 1)        # max cells forward per sub-step
        self._subs = 4 if cfg.ts_method == 3 else 1
        cap = 8 if cfg.ts_method == 3 else (16 if self.rows <= 32 else 8)
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
                "use ShardedCudaEngine or more cells per shard")
        self.K_launch = K
        self.hb = -(-(self._subs * K * reach) // blk)
        self.H = self.hb * blk
        self.reach = reach
        self._s_cache: dict = {}

    # -- seeds -----------------------------------------------------------------

    def _s_cols(self, K: int) -> torch.Tensor:
        """(C,) per-seed-column fill multiplier s_p: BDF2 phases cycle
        (s_be, s_cn, s_be, s_bdf); BE/CN repeat their single s. Kept per
        K on the device: a host-to-device copy in every launch group
        would wait for the queued kernels."""
        if K not in self._s_cache:
            if self.cfg.ts_method == 3:
                s = [self.kcs[BE].s, self.kcs[CN].s, self.kcs[BE].s,
                     self.kcs[BDF].s] * K
            else:
                s = [self.kcs[self._kind()].s] * K
            self._s_cache[K] = torch.tensor(s, dtype=torch.float32,
                                            device=self.device)
        return self._s_cache[K]

    def _kind(self) -> int:
        return BE if self.cfg.ts_method == 1 else CN

    def _main_seeds(self, K: int) -> torch.Tensor:
        """(rows, C) carry seeds of the main launch: the boundary inflow on
        shard 0 (reflective mu>0 rows zero, fixed up after the launch),
        zeros on shards whose halo absorbs the upstream chain."""
        seeds = self._s_cols(K)[None, :] * self.bc.reshape(self.rows, 1)
        if self.shards.xk:
            seeds = torch.zeros_like(seeds)
        return seeds.contiguous()

    def _fix_seeds(self, K: int, rec: torch.Tensor) -> torch.Tensor:
        """(rows, C) reflective fixup seeds of shard 0: mu<0 rows repeat
        the main seeds, mu>0 rows take the direction-flipped mu<0
        end-of-chain record of shard Kx-1 (solver.cpp:679-683), scaled by
        s_p."""
        s = self._s_cols(K)[None, :]
        neg = s * self.bc[0]
        pos = s * self.shards.group_flip(rec[:self.Bh_l], self.flip)
        return torch.cat([neg, pos], dim=0).contiguous()

    def _halo_slices(self, e0: torch.Tensor, e1: torch.Tensor):
        """The upstream neighbour's last H cells of e0 and e1 ((2, Bh_l, H)
        each, one ppermute over 'x'); shard 0 receives zeros (its halo is
        skipped through `reset`)."""
        if self.Kx == 1:
            z = e0.new_zeros((2, self.Bh_l, self.H))
            return z, z
        sl = torch.stack([e0[..., -self.H:], e1[..., -self.H:]])
        moved = self.mesh.ppermute(sl, "x",
                                   [(i, i + 1) for i in range(self.Kx - 1)])
        return moved[0], moved[1]

    def _launch(self, K: int, seeds, reset: int, x0, x1):
        """One packed kernel launch over (2, Bh, X) planes; returns the
        (2, Bh, X) output planes and the (rows, C) record."""
        x0 = x0.reshape(self.rows, -1)
        x1 = x1.reshape(self.rows, -1)
        if self.cfg.ts_method == 3:
            outs = cs.halo_bdf2_launch(
                self.coef[BE], self.coef[CN], self.coef[BDF], seeds, reset,
                x0, x1, K=K, symmetric_half=self.cfg.bdf2_symmetric_half,
                blk=self.block, npass_be=self.scan_npass[BE],
                npass_cn=self.scan_npass[CN],
                npass_bdf=self.scan_npass[BDF])
        else:
            kind = self._kind()
            outs = cs.halo_multistep_launch(
                kind, self.coef[kind], seeds, reset, x0, x1, K=K,
                blk=self.block, npass=self.scan_npass[kind])
        planes = [o.reshape(2, self.Bh_l, -1) for o in outs[:-1]]
        return planes, outs[-1]

    def _launch_group(self, st: FlatState, K: int) -> FlatState:
        """K whole timesteps: halo -> one fused launch over the extended
        domain -> (reflective) seed fixup splice."""
        H, xk = self.H, self.shards.xk
        h0, h1 = self._halo_slices(st.e0, st.e1)
        xe0 = torch.cat([h0, st.e0], dim=-1)
        xe1 = torch.cat([h1, st.e1], dim=-1)
        planes, rec = self._launch(K, self._main_seeds(K),
                                   0 if xk else self.hb, xe0, xe1)
        planes = [p[..., H:] for p in planes]
        if self.reflective:
            if self.Kx > 1:
                rec = self.mesh.ppermute(rec, "x", [(self.Kx - 1, 0)])
            if xk == 0:
                fix, _ = self._launch(K, self._fix_seeds(K, rec), 0,
                                      st.e0[..., :H].contiguous(),
                                      st.e1[..., :H].contiguous())
                # The main launch's outputs are this engine's own buffers:
                # splice the fixup over the first H own cells in place.
                for p, f in zip(planes, fix):
                    p[..., :H] = f
        if self.cfg.ts_method == 3:
            ne0, ne1, nh0, nh1, np0, np1 = planes
            return FlatState(ne0, ne1, np0, np1, nh0, nh1)
        ne0, ne1, np0, np1 = planes
        return FlatState(ne0, ne1, np0, np1, st.h0, st.h1)

    # -- time stepping ---------------------------------------------------------

    def solve(self, state: Optional[FlatState] = None,
              num_steps: Optional[int] = None) -> FlatState:
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
