"""Run one cell of the benchmark once and print its result as the last line
of standard output:

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run builds the cell's deck and entry (set-up, with one warm-up request of
the cell's own shapes), measures a closed loop of requests from one client
for `--seconds`, checks a sample of the answers drawn from the seed against
the plain reference, and prints each number compared beside its limit as
the last lines of standard error and under "check" in the result line.
With `--trace 0` the metrics are the cell's end-to-end metrics, read on the
host's clock; with `--trace 1` its per-layer metrics, from a device trace
of the window and the program's launch counters.

A cell on several chips starts one process a card itself (NCCL over
localhost); rank 0 prints the result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

import counts  # noqa: E402
import harness  # noqa: E402
import tracing  # noqa: E402

T_IMPORTED = time.time()

_RANK_ENV = "RTBENCH_RANK"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def build_context(spec, seed: int, device, rank: int = 0, world: int = 1,
                  deck=None):
    """The program's Config, tables and mesh for the cell (deck: the
    configuration's own unless given)."""
    from radiative_transfer_tpu_torch.models import transport

    deck = dict(spec.config["deck"] if deck is None else deck)
    cfg = harness.make_config(deck)
    mesh = None
    if spec.config.get("mesh"):
        from radiative_transfer_tpu_torch.parallel.mesh import Mesh

        mesh = Mesh(spec.config["mesh"])
    tables = transport.build_tables(cfg)[0]
    return SimpleNamespace(cfg=cfg, tables=tables, deck=deck, mesh=mesh,
                           traffic=spec.traffic, device=torch.device(device),
                           seed=seed, rank=rank, world=world)


def _gather(obj, world: int) -> list:
    if world == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def _go_on(flag: bool, ctx) -> bool:
    """Rank 0's decision to start another request, on every rank."""
    if ctx.world == 1:
        return flag
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], device=ctx.device)
    dist.broadcast(t, 0)
    return bool(t.item())


def execute(spec, seed: int, seconds: float, trace: bool, device="cuda",
            rank: int = 0, world: int = 1, t0: float = T_START, deck=None,
            fault=None):
    """One run of the cell on this rank: (result line, check rows) on rank
    0, (None, None) elsewhere. `fault(entry)`, if given, breaks the timed
    path underneath before the run (the harness's own tests)."""
    marks = [("start", t0), ("imports", T_IMPORTED)]
    ctx = build_context(spec, seed, device, rank, world, deck)
    dev = ctx.device
    entry = harness.entry_module(spec.traffic["entry"]).make(ctx)
    if fault is not None:
        fault(entry)
    marks.append(("tables and " + entry.name, time.time()))
    entry.request(entry.make_input(-1))       # warm-up: the cell's shapes
    harness.sync(dev)
    marks.append(("warm-up request", time.time()))
    expected = int(seconds / max(marks[-1][1] - marks[-2][1], 1e-3))
    launches0 = harness.launch_counts()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t0
    if rank == 0:
        print("set-up: " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
            file=sys.stderr)
    sample = harness.Sample(spec.limits["samples"], seed, expected)
    lat, n, failed = [], 0, 0
    with record_function(tracing.WINDOW_SPAN):
        w0 = time.perf_counter()
        while _go_on(time.perf_counter() - w0 < seconds, ctx):
            with record_function("init"):
                inp = entry.make_input(n)
                harness.sync(dev)
            ta = time.perf_counter()
            res = entry.request(inp)
            lat.append(time.perf_counter() - ta)
            if rank == 0:
                failed += not res["ok"]
                sample.offer(n, res, entry.keep)
            n += 1
            del inp, res
        window_s = time.perf_counter() - w0
    summary = None
    if prof is not None:
        harness.sync(dev)
        prof.stop()
        summary = tracing.summarize(*tracing.from_profiler(prof))
        del prof
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    launches1 = harness.launch_counts()
    launches = sum(v - launches0.get(k, 0) for k, v in launches1.items())
    entry.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    facts = _gather({"peak": peak, "summary": summary}, world)
    if rank != 0:
        _gather(None, world)               # wait for rank 0's check
        return None, None

    numbers = entry.check(sample.close(entry.keep))
    rows = harness.judge(numbers, spec.limits["limits"])
    work = counts.request_work(ctx.deck, spec.traffic)
    run = SimpleNamespace(
        entry=spec.traffic["entry"], dtype=spec.traffic["dtype"],
        deck=ctx.deck, world=world, requests=n, window_s=window_s,
        latencies=lat, setup_s=setup_s, work=work,
        peak_bytes=max(f["peak"] for f in facts),
        steps=n * spec.traffic["steps"], launches=launches,
        trace=_merge(facts) if trace else None)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = harness.reader(m["name"])(run)
        if v is None:
            if not trace:
                raise RuntimeError(f"no reading of {m['name']}")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": world, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": all(r[3] for r in rows) and failed == 0 and n > 0,
              "attempted": n, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["check"] = {name: {"value": _number(v), "limit": lim}
                       for name, v, lim, _ in rows}
    _gather(None, world)
    return result, rows


def _merge(facts: list) -> dict:
    """Rank 0's trace summary, with the device-busy seconds averaged over
    the ranks."""
    sums = [f["summary"] for f in facts]
    out = dict(sums[0])
    out["busy_s"] = sum(s["busy_s"] for s in sums) / len(sums)
    return out


def _launch_ranks(argv, chips: int) -> int:
    """Start one process a card, with rank 0's output printed last."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, files = [], []
    try:
        for rank in range(chips):
            env = dict(os.environ, **{
                _RANK_ENV: str(rank), "RTBENCH_WORLD": str(chips),
                "RTBENCH_PORT": str(port), "RTBENCH_T0": repr(T_START),
                "NCCL_SHM_DISABLE": "1"})
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), *argv],
                env=env, stdout=out, stderr=err))
        deadline = time.time() + 1500
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for out, err in files:
        pair = []
        for f in (out, err):
            f.seek(0)
            pair.append(f.read().decode(errors="replace"))
            f.close()
        text.append(pair)
    for rank in list(range(1, chips)) + [0]:
        sys.stderr.write(text[rank][1])
    sys.stderr.flush()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"rtbench: rank exit codes {codes}", file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print("rtbench: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    sys.stdout.write(text[0][0])
    return 0


def _rank_main(args, spec) -> int:
    import torch.distributed as dist

    rank, world = int(os.environ[_RANK_ENV]), int(os.environ["RTBENCH_WORLD"])
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{os.environ['RTBENCH_PORT']}",
        world_size=world, rank=rank, device_id=torch.device("cuda", rank))
    try:
        result, rows = execute(spec, args.seed, args.seconds, bool(args.trace),
                               device=f"cuda:{rank}", rank=rank, world=world,
                               t0=float(os.environ["RTBENCH_T0"]))
    finally:
        dist.destroy_process_group()
    return _report(result, rows) if rank == 0 else 0


def _report(result, rows) -> int:
    found = harness.forbidden_modules()
    if found:
        print("rtbench: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, v, lim, ok in rows:
        print(f"check {name} = {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


def _number(v: float):
    """A reading for the result line: JSON has no inf or nan, so those are
    given as text."""
    return v if math.isfinite(v) else repr(v)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    spec = harness.cell_spec(args.workload)
    chips = spec.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: {args.workload} needs {chips} CUDA device(s), this "
              f"machine has {have}", file=sys.stderr)
        return 3
    if chips > 1:
        if _RANK_ENV not in os.environ:
            return _launch_ranks(argv, chips)
        return _rank_main(args, spec)
    result, rows = execute(spec, args.seed, args.seconds, bool(args.trace))
    return _report(result, rows)


if __name__ == "__main__":
    sys.exit(main())
