"""Forward requests: one solve of S timesteps through the program's engine
selection (`parallel.make_multichip_engine`), from a seeded
off-equilibrium state, ending when the per-group balance and the scalar
flux phi (G, N) of `models/transport.result_from_ends` are on the host.

Its check runs the plain reference (rtbench/reference/rtref.py) from the
same initial state and compares phi and the balance.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from harness import DTYPES, seeded_ends, sync, worse
from reference import rtref


class Forward:
    def __init__(self, ctx):
        from radiative_transfer_tpu_torch.models import transport
        from radiative_transfer_tpu_torch.parallel import make_multichip_engine

        self.ctx, self.transport = ctx, transport
        self.steps = ctx.traffic["steps"]
        self.dtype = DTYPES[ctx.traffic["dtype"]]
        self.engine = make_multichip_engine(
            ctx.cfg, ctx.tables, ctx.mesh, engine=ctx.traffic["engine"],
            device=ctx.device)
        self.name = type(self.engine).__name__
        self.host = {}

    def to_host(self, x: torch.Tensor) -> np.ndarray:
        """`x` in a host buffer of its shape and type, page-locked where it
        comes from the card and reused by every request (a fresh pageable
        buffer each request costs its allocation and page faults, which
        vary from run to run)."""
        key = (tuple(x.shape), x.dtype)
        if key not in self.host:
            self.host[key] = torch.empty(
                x.shape, dtype=x.dtype, pin_memory=x.device.type == "cuda")
        return self.host[key].copy_(x).numpy()

    def make_input(self, i: int) -> torch.Tensor:
        return seeded_ends(self.ctx, i, self.dtype)

    def request(self, ends: torch.Tensor):
        """One solve; the result on the host (rank 0), None elsewhere."""
        eng, ctx = self.engine, self.ctx
        with record_function("solve"):
            st = eng.solve(eng.from_ends(ends, ends, ends),
                           num_steps=self.steps)
            out = eng.ends(st)
        if ctx.rank != 0:
            sync(ctx.device)
            return None
        with record_function("result"):
            res = self.transport.result_from_ends(ctx.cfg, ctx.tables, out)
            small = torch.cat([res.balance,
                               torch.isfinite(res.phi).all()[None].double()])
        with record_function("readback"):
            phi = self.to_host(res.phi)
            small = small.cpu().numpy()
        return {"phi": phi, "balance": small[:-1], "ok": bool(small[-1])}

    @staticmethod
    def keep(result):
        """A copy of a result that the next request's read-back does not
        overwrite."""
        return dict(result, phi=result["phi"].copy())

    def close(self):
        self.engine = None

    def check(self, samples, dtype=torch.float64):
        """The numbers compared, worst over the sampled requests: phi's
        max |phi - phi_ref| / max |phi_ref| and the balance's max
        |balance - balance_ref| (a relative quantity already), against the
        reference at float64; with `dtype` lower, the reference at that
        precision stands in for the program (the control)."""
        ctx = self.ctx
        rt_tables = rtref.build_tables(ctx.deck)
        ref = rtref.Stepper(ctx.deck, rt_tables, torch.float64, ctx.device)
        low = (None if dtype == torch.float64 else
               rtref.Stepper(ctx.deck, rt_tables, dtype, ctx.device))
        worst = {"phi_rel": 0.0, "balance_abs": 0.0}
        for i, got in samples:
            ends0 = self.make_input(i)
            with torch.no_grad():
                phi_r, bal_r = rtref.phi_and_balance(
                    ctx.deck, rt_tables, ref.solve(ends0, self.steps))
                if low is not None:
                    phi_l, bal_l = rtref.phi_and_balance(
                        ctx.deck, rt_tables, low.solve(ends0, self.steps))
                    got = {"phi": phi_l.cpu().numpy(),
                           "balance": bal_l.cpu().numpy()}
            worst["phi_rel"] = worse(worst["phi_rel"],
                                     rtref.nerr(got["phi"], phi_r.cpu()))
            worst["balance_abs"] = worse(worst["balance_abs"], np.max(
                np.abs(got["balance"] - bal_r.cpu().numpy())))
            del ends0, phi_r, bal_r
        return worst


def make(ctx):
    return Forward(ctx)
