"""The yardstick's counts: updates, operations and bytes of each cell's
request, pinned, and the readers that turn them into metrics."""

from types import SimpleNamespace

import pytest

import counts
import harness

# cell: (updates, operations, bytes, peak FLOP/s) of one request.
PINNED = {
    "gray_s32.f32_bdf2": (64 * 4 * 32 * 2**20, 64 * 124 * 32 * 2**20,
                          4 * 2 * 32 * 2**20 * 4, 67e12),
    "llnl_124g.f64_bdf2": (32 * 4 * 2 * 124 * 2**17,
                           32 * (124 + 4 * 4) * 2 * 124 * 2**17,
                           4 * 2 * 2 * 124 * 2**17 * 8, 34e12),
    "gray_s32.grad_bdf2": (32 * 4 * 32 * 2**20, 32 * 508 * 32 * 2**20,
                           2 * 32 * 2**20 * 4 + 8, 67e12),
}


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_request_work_is_pinned(cell):
    spec = harness.cell_spec(cell)
    work = counts.request_work(spec.config["deck"], spec.traffic)
    updates, flops, nbytes, peak = PINNED[cell]
    assert work == {"updates": updates, "flops": flops, "bytes": nbytes,
                    "peak_flops": peak}


def test_step_counts_follow_the_sub_steps():
    # A BDF2 step is BE, CN, BE, BDF: 2 * 25 + 31 + 43 = 124 a cell; the
    # adjoint adds 2 * 75 + 93 + 133 and 8 routing adds.
    deck = {"M": 2, "G": 3, "N": 5, "ts_method": 3}
    assert counts.step_flops(deck) == 30 * 124
    assert counts.step_flops(dict(deck, use_correction=True)) == 30 * 140
    assert counts.adjoint_step_flops(deck) == 30 * 508
    assert counts.updates_per_step(deck) == 4 * 30
    assert counts.updates_per_step(dict(deck, ts_method=1)) == 30


def test_bound_takes_the_larger_side():
    ops = {"flops": 67e12, "bytes": 0.0, "peak_flops": 67e12}
    assert counts.bound_seconds(ops) == pytest.approx(1.0)
    mem = {"flops": 0.0, "bytes": 3.35e12, "peak_flops": 67e12}
    assert counts.bound_seconds(mem) == pytest.approx(1.0)


def _run(**kw):
    base = dict(entry="forward", dtype="float32", world=1, requests=10,
                window_s=2.0, latencies=[0.1] * 10, setup_s=5.0,
                work={"updates": 1e9, "flops": 67e9, "bytes": 0.0,
                      "peak_flops": 67e12},
                peak_bytes=2**31, steps=640, launches=160,
                trace={"busy_s": 1.0, "window_s": 2.0, "nccl_s": 0.064})
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    r = _run()
    assert harness.reader("updates_per_s")(r) == pytest.approx(5e9)
    assert harness.reader("grad_updates_per_s")(r) is None
    assert harness.reader("peak_mem_gib")(r) == pytest.approx(2.0)
    assert harness.reader("setup_s")(r) == 5.0
    # 10 requests of 1 ms at the bound over 1 s busy: 1%.
    assert harness.reader("sweep_roofline")(r) == pytest.approx(1.0)
    assert harness.reader("df_roofline")(r) is None
    assert harness.reader("adjoint_roofline")(r) is None
    assert harness.reader("device_idle_pct.fwd")(r) == pytest.approx(50.0)
    assert harness.reader("device_idle_pct.grad")(r) is None
    assert harness.reader("launches_per_step")(r) == pytest.approx(0.25)
    assert harness.reader("nccl_ms_per_step")(r) is None
    four = _run(world=4, dtype="float64")
    assert harness.reader("df_roofline")(four) == pytest.approx(0.25)
    assert harness.reader("nccl_ms_per_step")(four) == pytest.approx(0.1)
    g = _run(entry="grad")
    assert harness.reader("grad_updates_per_s")(g) == pytest.approx(5e9)
    assert harness.reader("adjoint_roofline")(g) == pytest.approx(1.0)
    assert harness.reader("launches_per_step")(g) is None
    # Without a trace the per-layer readers find nothing to read.
    assert harness.reader("sweep_roofline")(_run(trace=None)) is None


def test_p95_is_taken_over_all_requests():
    # 100 requests: 94 fast, 6 slow. The tail of all of them lies in the
    # slow ones; a median of chunk tails would not.
    lat = [0.01] * 94 + [1.0] * 6
    r = _run(latencies=lat)
    assert harness.reader("solve_p95_ms")(r) == pytest.approx(
        harness.percentile(lat, 95) * 1e3)
    assert harness.reader("solve_p95_ms")(r) > 500
    chunks = [lat[i:i + 10] for i in range(0, 100, 10)]
    chunked = sorted(harness.percentile(c, 95) for c in chunks)[5]
    assert chunked * 1e3 < 500
