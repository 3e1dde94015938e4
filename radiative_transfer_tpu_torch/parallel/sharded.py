"""The general engine on a mesh: spatial decomposition of the transport
solve.

Port of radiative_transfer_tpu/parallel/sharded.py on torch.distributed
(parallel/mesh.py). A (g, x) mesh of ranks splits the global (M, G, N, 2)
state: the N cells over 'x' (the scan axis, carries couple the shards),
the G groups over 'g' (independent). Every rank runs the time loop on its
block; per sub-step and direction half (scan-of-scans, no wavefront):

  1. each shard runs the local inclusive affine scan over its N/K cells
     (ops/scan.py), giving per-cell prefix maps and the shard's total
     composite, an (Mh, Gl)-batched affine pair;
  2. the upwind shard's last-cell prev/half edges are ppermuted
     downstream as the shifted edges' fills (prev_fill / half_fill; the
     first shard in sweep order uses the boundary value, matching the
     carry initialisation at solver.cpp:695-697);
  3. the K composites are all_gathered over 'x' and each shard composes
     those upstream of it in sweep order (a log-depth exclusive prefix):
     mu<0 sweeps compose right to left, mu>0 left to right;
  4. every cell's edge pair is reconstructed locally from its incoming
     carry: the single-device scan up to associativity.

The reflective left boundary reads global cell 0's freshly swept mu<0
edges, which live on the first spatial shard: one all_gather over 'x'.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config.config import Config
from ..models import transport
from ..ops import sweep as sweep_mod
from ..ops.scan import affine_scan, apply_prefix
from ..ops.sweep import _shift_in
from .mesh import Mesh


class _Blocks:
    """This rank's block of the global (M, G, N, 2) arrays: N over 'x', G
    over 'g' where the mesh has that axis."""

    def __init__(self, cfg: Config, mesh: Mesh):
        self.mesh = mesh
        self.K = mesh.shape["x"]
        self.NG = mesh.shape.get("g", 1)
        if cfg.N % self.K:
            raise ValueError(f"N={cfg.N} does not split evenly over "
                             f"{self.K} spatial shards")
        if cfg.G % self.NG:
            raise ValueError(f"G={cfg.G} not divisible by {self.NG} group "
                             "shards")
        Nl, Gl = cfg.N // self.K, cfg.G // self.NG
        xk = mesh.axis_index("x")
        gk = mesh.axis_index("g") if "g" in mesh.shape else 0
        self.cells = slice(xk * Nl, (xk + 1) * Nl)
        self.groups = slice(gk * Gl, (gk + 1) * Gl)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.groups, self.cells].contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block, on every rank."""
        out = torch.cat(tuple(self.mesh.all_gather(x, "x")), dim=2)
        if "g" in self.mesh.shape:
            out = torch.cat(tuple(self.mesh.all_gather(out, "g")), dim=1)
        return out


def _sweep_half_sharded(kind: int, e, p, h, S, absmu, rhokap, bc, dx, ts,
                        dt_full, *, mesh: Mesh, reverse: bool
                        ) -> torch.Tensor:
    """One direction half of a sub-step on local (Mh, Gl, Nl, 2) blocks
    in the GLOBAL orientation; `reverse` for the mu<0 half (right to
    left); `bc` (Mh, Gl) the global boundary intensity."""
    o_ends, o_cells = sweep_mod.orient_ends, sweep_mod.orient_cells
    if reverse:
        e, p, h, S = o_ends(e), o_ends(p), o_ends(h), o_cells(S)
    K = mesh.shape["x"]
    k = mesh.axis_index("x")
    pos = (K - 1 - k) if reverse else k    # place in sweep order

    # Upwind halo: in sweep order shard pos receives the last oriented
    # prev/half edge of shard pos-1; in shard-index space data flows
    # k -> k+1 for forward sweeps and k -> k-1 for reverse ones.
    prev_fill = half_fill = bc
    if K > 1:
        perm = ([(i, i - 1) for i in range(1, K)] if reverse
                else [(i, i + 1) for i in range(K - 1)])
        prev_halo = mesh.ppermute(p[..., -1, 1], "x", perm)
        half_halo = mesh.ppermute(h[..., -1, 1], "x", perm)
        if pos != 0:
            prev_fill, half_fill = prev_halo, half_halo

    coeffs = sweep_mod.build_coeffs(kind, e, p, h, S, absmu, rhokap, bc,
                                    dx, ts, dt_full, prev_fill=prev_fill,
                                    half_fill=half_fill)
    a, b = sweep_mod.carry_terms(coeffs)
    pref_a, pref_b = affine_scan(a, b, axis=-1)

    incoming = bc
    if K > 1:
        # The shards' total maps in sweep order, composed by a log-depth
        # exclusive prefix: shard pos's incoming carry.
        gA = mesh.all_gather(pref_a[..., -1], "x")   # (K, Mh, Gl)
        gB = mesh.all_gather(pref_b[..., -1], "x")
        if reverse:
            gA, gB = torch.flip(gA, (0,)), torch.flip(gB, (0,))
        if pos > 0:
            inclA, inclB = affine_scan(gA, gB, axis=0)
            incoming = inclA[pos - 1] * bc + inclB[pos - 1]

    carry = apply_prefix(pref_a, pref_b, incoming)
    carry_in = _shift_in(carry, incoming)
    new = sweep_mod.reconstruct_ends(coeffs, carry_in)
    return o_ends(new) if reverse else new


def _substep_sharded(kind: int, cfg: Config, tb: transport.Tables, ends,
                     prev_ends, half_ends, ts, *, mesh: Mesh
                     ) -> torch.Tensor:
    """transport.substep on local (M, Gl, Nl, 2) blocks; `tb` holds this
    rank's group slice of the device tables."""
    Mh = cfg.M // 2
    absmu = torch.abs(tb.mu)
    S = transport._source_term(cfg, tb, ends, ts)   # local, elementwise
    neg, pos = slice(0, Mh), slice(Mh, cfg.M)
    new_neg = _sweep_half_sharded(
        kind, ends[neg], prev_ends[neg], half_ends[neg], S[neg], absmu[neg],
        tb.rhokap, transport._boundary_neg(cfg, tb, Mh), cfg.dx, ts, cfg.dt,
        mesh=mesh, reverse=True)

    if cfg.bc_left_indicator == 2:
        # Reflective: global cell 0's freshly swept incoming edges, on the
        # first spatial shard.
        left0 = new_neg[:, :, 0, 0]
        if mesh.shape["x"] > 1:
            left0 = mesh.all_gather(left0, "x")[0]
        bc_pos = torch.flip(left0, dims=(0,))
    else:
        bc_pos = transport._boundary_pos(cfg, tb, Mh, new_neg)

    new_pos = _sweep_half_sharded(
        kind, ends[pos], prev_ends[pos], half_ends[pos], S[pos], absmu[pos],
        tb.rhokap, bc_pos, cfg.dx, ts, cfg.dt, mesh=mesh, reverse=False)
    return torch.cat([new_neg, new_pos], dim=0)


def make_sharded_solve(cfg: Config, tables: transport.Tables, mesh: Mesh,
                       num_steps: Optional[int] = None, dtype=torch.float64,
                       device="cuda"):
    """Build ``run(local_state) -> local_state``: the full time loop on
    this rank's (M, G/NG, N/K, 2) block (on `device` at `dtype`),
    make_step_fn's stepping with one exchange set a sub-step."""
    n = cfg.max_timesteps if num_steps is None else num_steps
    blocks = _Blocks(cfg, mesh)
    t = transport.device_tables(tables, dtype, device)
    g = blocks.groups
    tb = t._replace(rhokap=t.rhokap[g], B=t.B[g], cor1=t.cor1[g],
                    cor2=t.cor2[g], cor3=t.cor3[g],
                    psi_source=t.psi_source[:, g])

    def sub(kind, ends, prev, half, ts):
        return _substep_sharded(kind, cfg, tb, ends, prev, half, ts,
                                mesh=mesh)

    step = transport._step_from(cfg, sub)

    def run(state: transport.State) -> transport.State:
        for _ in range(n):
            state = step(state)
        return state

    return run


def solve_sharded(cfg: Config, tables: transport.Tables,
                  state: transport.State, mesh: Mesh,
                  num_steps: Optional[int] = None, dtype=torch.float64,
                  device="cuda") -> transport.State:
    """Run the general engine on `mesh` from the global `state`: each rank
    takes its block, runs make_sharded_solve's loop on `device` at
    `dtype`, and gets the global final State back (gathered on every
    rank)."""
    device = transport.solve_device(device)
    blocks = _Blocks(cfg, mesh)
    run = make_sharded_solve(cfg, tables, mesh, num_steps, dtype, device)
    local = transport.State(*(blocks.local(torch.as_tensor(x)).to(
        device=device, dtype=dtype) for x in state))
    out = run(local)
    return transport.State(*(blocks.gather(x) for x in out))
