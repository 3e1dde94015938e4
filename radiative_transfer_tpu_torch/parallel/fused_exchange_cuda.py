"""Single-exchange fused BDF2 mesh engine on the CUDA kernel B13.

Port of radiative_transfer_tpu/parallel/fused_exchange.py
(FusedExchangeEngine) on torch.distributed (parallel/mesh.py): the mesh
path for the untruncatable regime (optically thin groups at large dt, the
LLNL deck at its shipped dt = 1e-3), whose workloads the halo engine's
creep bound rejects. ONE kernel launch and ONE small exchange a whole BDF2
step:

* The cycle is affine in the NV = 7 per-shard boundary scalars v (four
  phase inflows, the CN and BDF p1 fills, the h1 fill), so
  true_cycle(x, v) = cycle(x, 0) + linear_cycle(0, v). Each launch of B13
  (ops/cuda_fused.fused_step_launch) does both halves of that split,
  staggered by one step: the linear correction cycle of the PREVIOUS step
  from its folded v, the true input ends e = z + correction, and THIS
  step's zero-boundary cycle on them, recording per row the outflow
  carries, the half-snapshot edge and the input-e1 edge.
* ONE all_gather of those (rows, 6) records over 'x' folds the
  feed-forward shard chain on the device: shard k+1's unknowns are shard
  k's corrected outflows o_k = t_k + M v_k (M the (rows, 5, 7) host
  outflow map of parallel/step_response.py, float32, the JAX order), its
  p1 fills shard k's input-e1 edge, its h1 fill o_k's half edge. The axis
  start seeds all seven unknowns from the boundary value, or for the
  reflective mu>0 half from the flipped mu<0 chain end's outflows (a
  gather over 'g' where the rows are split).

BDF2 only: BE and CN steps already run one exchange a step on
ShardedCudaEngine. float32; a CPU device runs B13's plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config.config import Config
from ..ops import cuda_fused as cf
from ..ops import cuda_sweep as cs
from ..ops import fast_sweep as fs
from . import step_response as sr
from .mesh import Mesh, ShardedLayout

NV, NT = sr.NV, sr.NT


class FXState(NamedTuple):
    """One rank's state, corrections pending. z0/z1 are the current
    step's zero-boundary ends and h0/h1 its half-snapshot planes
    (2, Bh_l, N_loc); v (2, Bh_l, 1, NV) the step's folded boundary
    unknowns: the true planes are z + linear_cycle(v), materialised in the
    next launch or by a materialize_only launch. z0p/z1p/vp: the same for
    the previous step (whose corrected planes are this step's input, the
    reference's prev_ends)."""

    z0: torch.Tensor
    z1: torch.Tensor
    z0p: torch.Tensor
    z1p: torch.Tensor
    h0: torch.Tensor
    h1: torch.Tensor
    v: torch.Tensor
    vp: torch.Tensor


class FusedExchangeCudaEngine(ShardedLayout, cs.FlatLayout):
    """The counterpart of FusedExchangeEngine: one B13 launch and one
    exchange a BDF2 step on a mesh of ranks."""

    def __init__(self, cfg: Config, tables, mesh: Optional[Mesh] = None,
                 block: Optional[int] = None, scan_tol: float = 1e-10,
                 device="cuda"):
        if cfg.ts_method != 3:
            raise ValueError(
                "FusedExchangeCudaEngine fuses the BDF2 4-phase cycle; BE/CN "
                "steps already run one exchange per step on the "
                "per-substep engine")
        sh = self._shard(cfg, tables, mesh, device)
        Mh, G = self.Mh, self.G

        # The block rule (fused_exchange.py:290-309): it shapes the plain
        # version's blocked scan; the kernel tiles the shard its own way.
        auto_block = block is None
        if auto_block:
            block = 2048
        blk = 1
        while (blk * 2 <= min(block, self.N_loc)
               and self.N_loc % (blk * 2) == 0):
            blk *= 2
        while self.rows * blk > (1 << 17) and blk > 128:
            blk //= 2
        if blk < min(8, self.N_loc):
            blk = self.N_loc
        if auto_block:
            while (self.rows * blk * 2 <= (1 << 17)
                   and blk < self.N_loc
                   and self.N_loc % (blk * 2) == 0):
                blk *= 2
        self.block = blk
        self.nblocks = self.N_loc // blk

        self.kcs = fs.kind_coeffs(cfg, tables, np.float32)
        bc_neg, bc_pos = fs.boundary_planes(cfg, tables, np.float32)
        self.reflective = bc_pos is None
        if self.reflective:
            bc_pos = np.zeros(self.Bh, np.float32)
        self.scan_npass = {
            kind: cs._scan_npass(
                float(np.max(np.asarray(kc.a, dtype=np.float64))),
                self.block, scan_tol)
            for kind, kc in self.kcs.items()
        }

        # The host outflow map (stable f64 recurrences; no profiles: the
        # kernel re-runs the linear cycle instead of reading them).
        kr = {k: sr.kind_rows(kc) for k, kc in self.kcs.items()}
        resp = sr.bdf2_cycle_response(kr, self.Bh, self.N_loc,
                                      cfg.bdf2_symmetric_half,
                                      profiles=False)
        dev, rows_g = self.device, sh.rows

        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        M = np.asarray(resp.M, np.float32).reshape(2, self.Bh, NT, NV)
        self.M = put(M[:, rows_g].reshape(self.rows, NT, NV))
        self.bc_neg = put(np.asarray(bc_neg, np.float32)[rows_g])
        self.bc_pos = put(np.asarray(bc_pos, np.float32)[rows_g])
        self.flip = put(fs._refl_flip_indices(Mh, G))
        self.coef = {kind: put(cs._pack_coeffs(kc)[:, rows_g]
                               .reshape(self.rows, cs._NCOEF))
                     for kind, kc in self.kcs.items()}

    # -- the kernel -------------------------------------------------------------

    def _call(self, v, z0, z1, materialize_only: bool = False):
        """One B13 launch on (2, Bh_l, N_loc) planes and v (2, Bh_l, NV)."""
        shape = (2, self.Bh_l, self.N_loc)
        outs = cf.fused_step_launch(
            self.coef[fs.BE], self.coef[fs.CN], self.coef[fs.BDF],
            v.reshape(self.rows, NV), z0.reshape(self.rows, -1),
            z1.reshape(self.rows, -1),
            symmetric_half=self.cfg.bdf2_symmetric_half, blk=self.block,
            npass=self.scan_npass, materialize_only=materialize_only)
        planes = [o.reshape(shape) for o in outs[:4]]
        if materialize_only:
            return planes
        return planes, outs[4]

    # -- the fold -----------------------------------------------------------------

    @staticmethod
    def _assemble_interior(o, edge):
        """Shard k+1's unknowns from shard k's corrected outflows o
        (..., NT) and input-e1 edge: phase inflows from the per-phase
        outflows, both p1 fills from the edge, the h1 fill from the
        half-edge outflow."""
        return torch.stack([o[..., sr.T_BE1], o[..., sr.T_CN],
                            o[..., sr.T_BE2], o[..., sr.T_BDF],
                            edge, edge, o[..., sr.T_H1]], dim=-1)

    @staticmethod
    def _assemble_reflective(o):
        """The mu>0 axis-start unknowns from the flipped mu<0 chain-end
        corrected outflows: each phase's inflow and fills from that
        phase's outflow (solver.cpp:679-683, 695-697)."""
        return torch.stack([o[..., sr.T_BE1], o[..., sr.T_CN],
                            o[..., sr.T_BE2], o[..., sr.T_BDF],
                            o[..., sr.T_CN], o[..., sr.T_BDF],
                            o[..., sr.T_BDF]], dim=-1)

    @staticmethod
    def _apply(M, v):
        """M @ v per row, (rows, NT, NV) x (rows, NV): the sum over v's
        components in order, in float32."""
        acc = M[..., 0] * v[:, None, 0]
        for j in range(1, NV):
            acc = acc + M[..., j] * v[:, None, j]
        return acc

    def _fold(self, oc: torch.Tensor) -> torch.Tensor:
        """Fold the feed-forward shard chain from this rank's (rows, 6)
        record. Returns its unknowns (2, Bh_l, 1, NV)."""
        K, half = self.Kx, self.Bh_l
        gP = (oc[None] if K == 1
              else self.mesh.all_gather(oc, "x"))       # (K, rows, NT+1)
        M = self.M

        def chain(v0, gH, MH):
            vs, v, o = [v0], v0, None
            for k in range(K):
                o = self._apply(MH, v) + gH[k, :, :NT]
                v = self._assemble_interior(o, gH[k, :, NT])
                vs.append(v)
            return vs, o                                 # o = chain end

        zero7 = torch.zeros((half, NV), dtype=torch.float32,
                            device=oc.device)
        vsn, o_end = chain(zero7 + self.bc_neg[:, None], gP[:, :half],
                           M[:half])
        if self.reflective:
            v0p = self._assemble_reflective(
                self.shards.group_flip(o_end, self.flip))
        else:
            v0p = zero7 + self.bc_pos[:, None]
        vsp, _ = chain(v0p, gP[:, half:], M[half:])
        k = self.shards.xk
        return torch.stack([vsn[k], vsp[k]], dim=0)[:, :, None, :]

    def _step(self, st: FXState) -> FXState:
        planes, oc = self._call(st.v[:, :, 0, :], st.z0, st.z1)
        z0n, z1n, h0n, h1n = planes
        return FXState(z0n, z1n, st.z0, st.z1, h0n, h1n, self._fold(oc),
                       st.v)

    # -- materialisation and state ---------------------------------------------

    def _materialize(self, st: FXState, full: bool = True):
        """This rank's true planes: (e0, e1), and with `full` also the
        prev planes and the half planes with their corrections."""
        e0, e1, hc0, hc1 = self._call(st.v[:, :, 0, :], st.z0, st.z1,
                                      materialize_only=True)
        if not full:
            return e0, e1
        p0, p1, _, _ = self._call(st.vp[:, :, 0, :], st.z0p, st.z1p,
                                  materialize_only=True)
        return e0, e1, p0, p1, st.h0 + hc0, st.h1 + hc1

    def _zeros_v(self) -> torch.Tensor:
        return torch.zeros((2, self.Bh_l, 1, NV), dtype=torch.float32,
                           device=self.device)

    def init_state(self) -> FXState:
        """psi = ends = B_g everywhere (src/solver.cpp:165-181)."""
        v = self._zeros_v()
        return FXState(*super().init_state(), v, v)

    def from_ends(self, ends, prev, half) -> FXState:
        """Global (M, G, N, 2) arrays -> this rank's exact FXState."""
        v = self._zeros_v()
        return FXState(*super().from_ends(ends, prev, half), v, v)

    def ends(self, st: FXState) -> torch.Tensor:
        return self.ends_pair(*self._materialize(st, full=False))

    def prev_half_ends(self, st: FXState):
        _, _, p0, p1, h0, h1 = self._materialize(st)
        return self.ends_pair(p0, p1), self.ends_pair(h0, h1)
