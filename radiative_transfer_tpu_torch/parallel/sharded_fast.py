"""The fast engine on a mesh: ShardedFastEngine.

Port of radiative_transfer_tpu/parallel/sharded_fast.py (ShardedFastEngine)
on torch.distributed (parallel/mesh.py). It runs ops/fast_sweep.FastEngine's
sub-step (plain PyTorch, float32 or float64) on every rank's shard:

* Layout. FastEngine's tiled sweep-order planes (chunk, 2, Bh, nc) shard
  along the chunk-column axis nc over the spatial axis 'x' (global cell
  j = i*chunk + t in sweep order) and along the batch rows Bh over the
  group axis 'g' where the mesh has it at more than one rank. The mu<0 half
  is stored pre-reversed, so both halves sweep rank k -> k+1: the rank
  holding sweep-order columns [k nc/K, (k+1) nc/K) holds the physical
  block K-1-k of the mu<0 half and block k of the mu>0 half. ``ends`` and
  ``from_ends`` gather and slice the tiled sweep-order planes, and
  FastEngine's own ends_pair/from_ends do the physical inversion.
* Per sub-step: FastEngine.rhs (with a one-cell shift that patches the
  first local cell from the previous rank's last, one ppermute) and
  local_scan on the shard (zero inflow); an all_gather over 'x' of every
  rank's composite map (a^N_loc, tot_b); their inclusive prefix in sweep
  order, whose last entry is the global composite and gives the
  reflective mu>0 inflow from the global mu<0 outflow (a (Bh,) gather over
  'g' where the rows are split); the exclusive prefix at this rank maps
  the boundary inflow to the carry entering its first cell;
  FastEngine.finish.
* The chunk is the largest one <= `chunk` that divides N and whose N/chunk
  columns split evenly over the 'x' ranks (JAX's rule); there is no
  padding (FastEngine(pad=False)).

Exchanges a sub-step: 2 all_gathers of (2, Bh_l) over 'x', 0-3 ppermutes
of (2, Bh_l) (CN one, BDF two), and for a reflective deck on a split
group axis one all_gather of (Bh_l,) over 'g'. At a one-rank mesh the
collectives are skipped. ``init_state``, ``solve``, ``ends``,
``ends_pair``, ``from_ends`` and ``prev_half_ends`` take and give global
arrays on every rank, as the other mesh engines' (mesh.ShardedLayout), so
checkpoints, the CLI's chunked loops and the stacked ensembles run on it
unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config.config import Config
from ..ops import fast_sweep as fs
from ..ops.scan import _log_prefix
from .distributed import host_array
from .mesh import Mesh


class ShardedFastEngine:
    """FastEngine with its planes sharded over `mesh` (parallel/mesh.py):
    this rank's state is a FlatState of (chunk, 2, Bh_l, nc_l) planes."""

    def __init__(self, cfg: Config, tables, mesh: Mesh,
                 dtype=torch.float32, chunk: int = 256, device="cuda"):
        self.mesh = mesh
        self.K = mesh.shape["x"]
        self.NG = mesh.shape.get("g", 1)
        # The largest chunk <= `chunk` dividing N whose column count N/chunk
        # splits evenly over the K spatial shards.
        chunk = min(chunk, cfg.N)
        while chunk > 1 and (cfg.N % chunk or (cfg.N // chunk) % self.K):
            chunk -= 1
        valid = cfg.N % chunk == 0 and (cfg.N // chunk) % self.K == 0
        if valid and chunk < min(8, cfg.N // max(self.K, 1)):
            raise ValueError(
                f"N={cfg.N} over {self.K} spatial shards admits only a "
                f"degenerate chunking (chunk={chunk} serialises the scan); "
                "choose N with a power-of-two factor per shard")
        self.eng = eng = fs.FastEngine(cfg, tables, dtype=dtype, chunk=chunk,
                                       pad=False, device=device)
        if eng.nc % self.K:
            raise ValueError(
                f"no chunking of N={cfg.N} splits evenly over {self.K} "
                f"spatial shards (got chunk={eng.chunk})")
        if eng.Bh % self.NG:
            raise ValueError(f"batch rows Bh={eng.Bh} not divisible by "
                             f"{self.NG} group shards")
        self.cfg, self.tables, self.dtype = cfg, tables, dtype
        self.device = eng.device
        self.chunk, self.nc, self.Bh = eng.chunk, eng.nc, eng.Bh
        self.nc_l, self.Bh_l = eng.nc // self.K, eng.Bh // self.NG
        self.xk = xk = mesh.axis_index("x")
        gk = mesh.axis_index("g") if self.NG > 1 else 0
        self.rows = slice(gk * self.Bh_l, (gk + 1) * self.Bh_l)
        self.cols = slice(xk * self.nc_l, (xk + 1) * self.nc_l)
        # This rank's rows of the coefficient and boundary planes.
        self.kcs = {
            kind: fs.KindCoeffs(*(x[:, :, self.rows]
                                  if isinstance(x, torch.Tensor) else x
                                  for x in kc))
            for kind, kc in eng.kcs.items()}
        self.bc_neg = eng.bc_neg[self.rows]
        self.bc_pos = (None if eng.bc_pos_fixed is None
                       else eng.bc_pos_fixed[self.rows])

    # -- layout ---------------------------------------------------------------

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global tiled (chunk, 2, Bh, nc) plane."""
        return x[:, :, self.rows, self.cols].contiguous()

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tiled plane from every rank's block."""
        return host_array(x, self.mesh) if self.mesh.size > 1 else x

    def init_state(self) -> fs.FlatState:
        """psi = ends = B_g everywhere (src/solver.cpp:165-181)."""
        Bg = np.broadcast_to(
            np.asarray(self.tables.B, dtype=np.float64)[None, :],
            (self.eng.Mh, self.eng.G)).reshape(self.Bh)[self.rows]
        Bg = torch.tensor(Bg, dtype=self.dtype, device=self.device)
        plane = Bg[None, None, :, None].expand(
            self.chunk, 2, self.Bh_l, self.nc_l).contiguous()
        return fs.FlatState(plane, plane, plane, plane, plane, plane)

    def from_ends(self, ends, prev, half) -> fs.FlatState:
        """Global (M, G, N, 2) arrays -> this rank's blocks."""
        return fs.FlatState(*(self._local(p) for p in
                              self.eng.from_ends(ends, prev, half)))

    def ends_pair(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """This rank's edge blocks -> the global (M, G, N, 2), on every
        rank."""
        return self.eng.ends_pair(self._gather(x0), self._gather(x1))

    def ends(self, st: fs.FlatState) -> torch.Tensor:
        return self.ends_pair(st.e0, st.e1)

    def prev_half_ends(self, st: fs.FlatState):
        return (self.ends_pair(st.p0, st.p1), self.ends_pair(st.h0, st.h1))

    # -- one sub-step on the shard -------------------------------------------

    def _shift1(self, x: torch.Tensor) -> torch.Tensor:
        """One-cell-downwind shift; the first local cell takes the previous
        rank's last (the first rank keeps the zero fill, folded into the
        inflow)."""
        shifted = fs._shift1_tiled(x)
        if self.K > 1:
            shifted[0, :, :, 0] = self.mesh.ppermute(
                x[-1, :, :, -1], "x", [(i, i + 1) for i in range(self.K - 1)])
        return shifted

    def _inflow(self, kc: fs.KindCoeffs, a_powN, tot_b) -> torch.Tensor:
        """Effective inflow per half, (2, Bh_l, 1), from the GLOBAL
        composite; the reflective mu>0 inflow is the mu<0 half's global
        outflow, direction-flipped across the row shards."""
        init_neg = kc.s * self.bc_neg                       # (Bh_l,)
        if self.bc_pos is not None:
            bc_pos = self.bc_pos
        else:
            out_neg = a_powN[0, :, 0] * init_neg + tot_b[0, :, 0]
            full = (self.mesh.all_gather(out_neg, "g").reshape(-1)
                    if self.NG > 1 else out_neg)
            bc_pos = full[self.eng.refl_flip][self.rows]
        return torch.stack([init_neg, kc.s * bc_pos], dim=0)[..., None]

    def _substep(self, kind: int, st: fs.FlatState):
        eng, kc = self.eng, self.kcs[kind]
        r0, r1, b = eng.rhs(kind, st, shift1=self._shift1, kc=kc)
        pb, pow_t, EXa, EXb, a_powN, tot_b = eng.local_scan(kind, b, kc=kc)
        if self.K == 1:
            incoming = self._inflow(kc, a_powN, tot_b)
        else:
            # Shard order is sweep order for both halves: the inclusive
            # prefix of the gathered composites, (2, Bh_l, K).
            gA = self.mesh.all_gather(a_powN[..., 0], "x").movedim(0, -1)
            gB = self.mesh.all_gather(tot_b[..., 0], "x").movedim(0, -1)
            inclA, inclB = _log_prefix(gA, gB)
            k = self.xk
            eA = inclA[..., k - 1:k] if k else torch.ones_like(gA[..., :1])
            eB = inclB[..., k - 1:k] if k else torch.zeros_like(gB[..., :1])
            inflow = self._inflow(kc, inclA[..., -1:], inclB[..., -1:])
            incoming = eA * inflow + eB
        return eng.finish(kind, r0, r1, pb, pow_t, EXa, EXb, incoming, kc=kc)

    def _step(self, st: fs.FlatState) -> fs.FlatState:
        cfg = self.cfg
        if cfg.ts_method == 1:
            ne0, ne1 = self._substep(fs.BE, st)
            return fs.FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        if cfg.ts_method == 2:
            s1 = fs.FlatState(st.e0, st.e1, st.e0, st.e1, st.h0, st.h1)
            ne0, ne1 = self._substep(fs.CN, s1)
            return fs.FlatState(ne0, ne1, st.e0, st.e1, st.h0, st.h1)
        # BDF2 4-phase cycle (FastEngine.step).
        p0, p1 = st.e0, st.e1
        s1 = fs.FlatState(st.e0, st.e1, p0, p1, st.h0, st.h1)
        b0, b1 = self._substep(fs.BE, s1)
        s2 = fs.FlatState(b0, b1, p0, p1, st.h0, st.h1)
        e0, e1 = self._substep(fs.CN, s2)
        # mu>0 half snapshot = phase-0 BE output (reference quirk,
        # solver.cpp:733 vs 784-787; ops/fast_sweep.py).
        if cfg.bdf2_symmetric_half:
            h0, h1 = e0, e1
        else:
            h0 = torch.cat([e0[:, :1], b0[:, 1:]], dim=1)
            h1 = torch.cat([e1[:, :1], b1[:, 1:]], dim=1)
        s3 = fs.FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = self._substep(fs.BE, s3)
        s4 = fs.FlatState(e0, e1, p0, p1, h0, h1)
        e0, e1 = self._substep(fs.BDF, s4)
        return fs.FlatState(e0, e1, p0, p1, h0, h1)

    def solve(self, state: Optional[fs.FlatState] = None,
              num_steps: Optional[int] = None) -> fs.FlatState:
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()
        for _ in range(n):
            state = self._step(state)
        return state
