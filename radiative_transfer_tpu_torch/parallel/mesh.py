"""A device mesh on torch.distributed: the counterpart of jax.sharding.Mesh
and of radiative_transfer_tpu/parallel/sharded_fast.py make_mesh_1d /
make_mesh_2d, with the collectives the mesh engines use.

Ranks are laid out (g, x) with x innermost, as the JAX mesh lays out its
devices, so rank = g * nx + x. Each axis gets one process sub-group per
line of the grid (``dist.new_group``, created by every rank in the same
order); ``axis_index``, ``all_gather`` and ``ppermute`` then act on the
line through this rank, as lax.axis_index / lax.all_gather /
lax.ppermute act inside shard_map.

A one-rank mesh needs no process group (in a group, it is this process
alone): its all_gather is a self-copy and its ppermute sends nothing, as
JAX's collectives at 1x1.

Payloads here are tiny (a few values per row) except the halo engines'
plane slices. On the gloo backend a CUDA tensor is staged through host
memory explicitly; NCCL moves it on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .distributed import host_array


class Mesh:
    """Ranks on a named grid, e.g. Mesh({"g": 2, "x": 4})."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        # A one-rank mesh is this process alone, whatever group it is in.
        self.rank = 0
        if self.size > 1:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if self.size != world:
                raise ValueError(f"mesh {self.shape} needs {self.size} "
                                 f"ranks, the process group has {world}")
            self.rank = dist.get_rank()
        self.coords = {}
        rest = self.rank
        for name in reversed(self.axis_names):
            rest, self.coords[name] = divmod(rest, self.shape[name])
        self.stage = (self.size > 1 and dist.get_backend() == "gloo")
        # The line of ranks through this rank along each axis.
        self._lines: Dict[str, Tuple[object, Tuple[int, ...]]] = {}
        if self.size > 1:
            for name in self.axis_names:
                for line in self._all_lines(name):
                    group = dist.new_group(list(line))
                    if self.rank in line:
                        self._lines[name] = (group, line)

    def _all_lines(self, axis: str):
        """Every line of ranks along `axis`, in one order on all ranks."""
        names = self.axis_names
        others = [n for n in names if n != axis]
        strides = {n: math.prod(self.shape[m] for m in names[i + 1:])
                   for i, n in enumerate(names)}
        lines = []
        for idx in range(math.prod(self.shape[n] for n in others)):
            base, rest = 0, idx
            for n in reversed(others):
                rest, c = divmod(rest, self.shape[n])
                base += c * strides[n]
            lines.append(tuple(base + i * strides[axis]
                               for i in range(self.shape[axis])))
        return lines

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.stage and x.is_cuda else x

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *x.shape): x from every rank of this rank's line along
        `axis`, in axis order (lax.all_gather)."""
        n = self.shape[axis]
        if n == 1:
            return x[None].clone()
        group, _ = self._lines[axis]
        src = self._staged(x)
        outs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(outs, src, group=group)
        return torch.stack(outs).to(x.device)

    def ppermute(self, x: torch.Tensor, axis: str,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """lax.ppermute: for each (src, dst) of `perm` (axis indices), rank
        src's x arrives at rank dst; a rank nothing is sent to gets
        zeros."""
        me = self.coords[axis]
        out = torch.zeros_like(x)
        if self.shape[axis] == 1:
            if (0, 0) in perm:
                out.copy_(x)
            return out
        _, line = self._lines[axis]
        send = self._staged(x)
        recv = torch.zeros_like(send)
        ops = [dist.P2POp(dist.isend, send, line[d])
               for s, d in perm if s == me]
        ops += [dist.P2POp(dist.irecv, recv, line[s])
                for s, d in perm if d == me]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if any(d == me for _, d in perm):
            out.copy_(recv)
        return out


def make_mesh_1d(n_spatial: int) -> Mesh:
    return Mesh({"x": n_spatial})


def make_mesh_2d(n_group: int, n_spatial: int) -> Mesh:
    """(g, x) mesh, x innermost: spatial neighbours are adjacent ranks."""
    return Mesh({"g": n_group, "x": n_spatial})


class Shards:
    """How an engine's (2, Bh, N) planes split over a mesh: the N cells
    over the spatial axis 'x', the Bh batch rows over the group axis 'g'
    where the mesh has it at more than one rank. `mesh=None` is one
    rank."""

    def __init__(self, mesh: Optional[Mesh], N: int, Bh: int):
        self.mesh = make_mesh_1d(1) if mesh is None else mesh
        m = self.mesh
        self.K = m.shape["x"]
        self.NG = m.shape.get("g", 1)
        if N % self.K:
            raise ValueError(f"N={N} does not split evenly over {self.K} "
                             "spatial shards")
        if Bh % self.NG:
            raise ValueError(f"batch rows Bh={Bh} not divisible by "
                             f"{self.NG} group shards")
        self.N_loc, self.Bh_l = N // self.K, Bh // self.NG
        self.xk = m.axis_index("x")
        self.gk = m.axis_index("g") if self.NG > 1 else 0
        self.rows = slice(self.gk * self.Bh_l, (self.gk + 1) * self.Bh_l)
        self.cells = slice(self.xk * self.N_loc, (self.xk + 1) * self.N_loc)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a global (..., Bh, N) array."""
        return x[..., self.rows, self.cells].contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global (..., Bh, N) array from every rank's shard."""
        return host_array(x, self.mesh)

    def group_flip(self, x: torch.Tensor, flip: torch.Tensor):
        """Rows of the direction-flipped global (Bh, ...) array `x` that
        this rank owns, from each group rank's (Bh_l, ...) share: the
        reflective coupling's gather over the group axis."""
        if self.NG == 1:
            return x[flip]
        full = self.mesh.all_gather(x, "g")
        full = full.reshape((-1,) + tuple(x.shape[1:]))
        return full[flip][self.rows]


class ShardedLayout:
    """Mixin for an engine layout (ops/cuda_sweep.FlatLayout,
    ops/cuda_df.DFLayout) whose planes are this rank's shard
    (`self.shards`): global arrays in, global arrays out on every rank."""

    def _shard(self, cfg, tables, mesh: Optional[Mesh], device) -> Shards:
        """The attributes every mesh engine sets first: the deck, the
        device, the batch (Mh, G, Bh) and this rank's shard of it (Kx
        spatial shards of N_loc cells, Bh_l rows a half, rows = 2 Bh_l
        packed). Returns the Shards."""
        self.cfg, self.tables = cfg, tables
        self.device = torch.device(device)
        self.Mh, self.G = cfg.M // 2, cfg.G
        self.Bh = self.Mh * self.G
        self.shards = sh = Shards(mesh, cfg.N, self.Bh)
        self.mesh, self.Kx = sh.mesh, sh.K
        self.N_loc, self.Bh_l = sh.N_loc, sh.Bh_l
        self.rows = 2 * self.Bh_l
        return sh

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        return self.shards.local(x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.shards.gather(x)

    def solve(self, state=None, num_steps: Optional[int] = None):
        """Run n timesteps, one `_step` each (the halo engines, which run
        launch groups of K steps, have their own)."""
        n = self.cfg.max_timesteps if num_steps is None else num_steps
        if state is None:
            state = self.init_state()
        for _ in range(n):
            state = self._step(state)
        return state
