"""Gradient requests: one value-and-gradient, with respect to the opacities,
of a loss against a seeded target, through `ops/cuda_adjoint
.make_diff_solve_cuda` (what `adjoint.fit_params(solver="pallas")` runs each
iteration), ending when the loss and the gradient are on the host.

The loss is mean over (direction, group, cell, edge) of (ends - target)^2
after S steps, with target (M, G) = B_g U(lo, hi) drawn from the request's
seed. Its check differentiates the plain reference (rtref) at float64 by a
central difference in kappa, from the same state and target.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from harness import request_generator, seeded_ends, worse
from reference import rtref


def _loss(ends, target):
    return torch.mean((ends - target[:, :, None, None]) ** 2)


class Grad:
    def __init__(self, ctx):
        from radiative_transfer_tpu_torch.models import transport
        from radiative_transfer_tpu_torch.ops.cuda_adjoint import (
            make_diff_solve_cuda)

        if ctx.traffic["dtype"] != "float32":
            raise ValueError("the differentiable kernel solve is float32")
        self.ctx, self.State = ctx, transport.State
        self.steps = ctx.traffic["steps"]
        self.kappa0 = np.asarray(ctx.tables.kappa, dtype=np.float64)
        self.solve_fn = make_diff_solve_cuda(ctx.cfg, ctx.tables,
                                             num_steps=self.steps,
                                             device=ctx.device)
        self.name = "make_diff_solve_cuda"

    def make_input(self, i: int):
        ctx = self.ctx
        ends = seeded_ends(ctx, i, torch.float32)
        lo, hi = ctx.traffic["init"]
        g = request_generator(ctx, i, salt=1)
        u = torch.rand((ctx.cfg.M, ctx.cfg.G), generator=g,
                       device=ctx.device, dtype=torch.float64)
        B = torch.as_tensor(np.asarray(ctx.tables.B), device=ctx.device)
        return ends, B[None, :] * (lo + (hi - lo) * u)

    def request(self, inp):
        ends, target = inp
        kappa = torch.tensor(self.kappa0, requires_grad=True)
        with record_function("solve"):
            st = self.solve_fn({"kappa": kappa},
                               self.State(ends, ends, ends))
        with record_function("result"):
            loss = _loss(st.ends, target)
        with record_function("backward"):
            loss.backward()
        with record_function("readback"):
            value = float(loss.detach())
            grad = kappa.grad.numpy().copy()
        ok = bool(np.isfinite(value) and np.all(np.isfinite(grad)))
        return {"loss": value, "grad": grad, "ok": ok}

    @staticmethod
    def keep(result):
        return result

    def close(self):
        self.solve_fn = None

    def check(self, samples, dtype=torch.float64):
        """The numbers compared, worst over the sampled requests: the
        loss's |L - L_ref| / |L_ref| and the gradient's max |g - g_ref| /
        max |g_ref|; with `dtype` lower, the reference at that precision
        stands in for the program (the control)."""
        worst = {"loss_rel": 0.0, "grad_rel": 0.0}
        for i, got in samples:
            ref = self.reference(i, torch.float64)
            if dtype != torch.float64:
                got = self.reference(i, dtype)
            worst["loss_rel"] = worse(worst["loss_rel"], abs(
                got["loss"] - ref["loss"]) / abs(ref["loss"]))
            worst["grad_rel"] = worse(worst["grad_rel"], float(
                np.max(np.abs(got["grad"] - ref["grad"]))
                / np.max(np.abs(ref["grad"]))))
        return worst

    def reference(self, i: int, dtype, rel_step: float = 1e-3):
        """Loss and opacity gradient of request `i` by the plain reference
        at `dtype`: the loss at kappa, and each group's derivative by a
        central difference of the loss at kappa (1 +- rel_step) in that
        group (the loss is smooth in kappa: the truncation error lies far
        below float32's)."""
        ctx = self.ctx
        ends, target = self.make_input(i)

        def loss(kappa):
            t = rtref.build_tables(ctx.deck, kappa=kappa)
            step = rtref.Stepper(ctx.deck, t, dtype, ctx.device)
            with torch.no_grad():
                e = step.solve(ends, self.steps)
            return float(_loss(e.double(), target))

        grad = np.zeros_like(self.kappa0)
        for g in range(grad.size):
            h = rel_step * self.kappa0[g]
            up, down = self.kappa0.copy(), self.kappa0.copy()
            up[g] += h
            down[g] -= h
            grad[g] = (loss(up) - loss(down)) / (2 * h)
        return {"loss": loss(self.kappa0), "grad": grad}


def make(ctx):
    return Grad(ctx)
