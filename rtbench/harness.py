"""The benchmark's general part: it finds a cell's configuration, traffic mix,
limits and metric readers by the names in BENCHMARK.json, builds the
program's deck from the configuration, drives a closed loop of requests for
the measured window, checks a seeded sample of the answers against the plain
reference, and assembles the result line.

A cell is `config` x `traffic`:

* rtbench/configs/<config>.json: "deck" (the program's Config fields as
  run), "mesh" ({"x": 4} or null), and the source, reductions and
  assumptions;
* rtbench/traffic/<traffic>.json: "entry" (a module under
  rtbench/entries/), "dtype", "steps" a request, "engine", "init" (the
  initial state's spread around B: psi = B U(lo, hi));
* rtbench/limits/<cell>.json: the limit of each number the check compares
  and how many answers it samples;
* rtbench/metrics/<metric>.py: `read(run) -> float or None` for each metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "radiative_transfer_tpu")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(name: str, root: Path = ROOT) -> SimpleNamespace:
    """Everything BENCHMARK.json and the cell's files say about cell
    `name`."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"rtbench: no workload {name!r} in BENCHMARK.json "
                         f"({', '.join(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    return SimpleNamespace(
        name=name, cell=cell, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in man["end_to_end"] if listed(m)],
        per_layer=[m for m in man["per_layer"] if listed(m)])


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of `metric`: rtbench/metrics/<metric>.py's `read`."""
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "rtbench_metric_" + metric.replace(".", "_")).read


def entry_module(entry: str):
    return load_module(HERE / "entries" / f"{entry}.py",
                       "rtbench_entry_" + entry)


def make_config(deck: dict):
    """The program's Config from a configuration's deck."""
    from radiative_transfer_tpu_torch.config.config import Config

    fields = dict(deck)
    for key in ("group_bounds", "group_kappa"):
        if key in fields:
            fields[key] = tuple(fields[key])
    if "psi_source" in fields:
        fields["psi_source"] = tuple(tuple(r) for r in fields["psi_source"])
    return Config(**fields)


def request_generator(ctx, i: int, salt: int = 0) -> torch.Generator:
    """The device generator of request `i` of a run of seed `ctx.seed`:
    the same seed and index give the same numbers (warm-up is i = -1)."""
    g = torch.Generator(device=ctx.device)
    g.manual_seed((ctx.seed * 1_000_003 + (i + 2) * 7_919 + salt)
                  % (1 << 63))
    return g


def seeded_ends(ctx, i: int, dtype) -> torch.Tensor:
    """Request `i`'s initial edges (M, G, N, 2) on the device: B_g times
    U(lo, hi) at every cell, edge, direction and group, drawn in one
    call."""
    cfg = ctx.cfg
    lo, hi = ctx.traffic["init"]
    u = torch.rand((cfg.M, cfg.G, cfg.N, 2), generator=request_generator(
        ctx, i), device=ctx.device, dtype=dtype)
    B = torch.as_tensor(np.asarray(ctx.tables.B), device=ctx.device,
                        dtype=dtype)
    return B[None, :, None, None] * (lo + (hi - lo) * u)


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def worse(a: float, b: float) -> float:
    """The larger of two readings, a reading that is not a number counting
    as infinitely large."""
    b = float(b)
    return math.inf if not math.isfinite(b) else max(a, b)


class Sample:
    """`k` requests of the window drawn from the run's seed, among the first
    `expected` (the count the warm-up request's time predicts); where the
    window ends before a drawn index, the last request stands in for it.
    `keep(result)` makes the private copy that is held for the check."""

    def __init__(self, k: int, seed: int, expected: int):
        rng = random.Random(seed)
        self.want = set(rng.sample(range(max(expected, k)), k))
        self.items, self.last = [], None

    def offer(self, i: int, result, keep) -> None:
        if i in self.want:
            self.items.append((i, keep(result)))
        self.last = (i, result)

    def close(self, keep) -> list:
        short = len(self.items) < len(self.want)
        if short and self.last and self.last[0] not in dict(self.items):
            self.items.append((self.last[0], keep(self.last[1])))
        return self.items


def percentile(values, q: float) -> float:
    """The q-th percentile of all `values`, linear between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def launch_counts() -> dict:
    """Every launch counter of the program's kernel wrappers (a function
    with an integer `launches`), by module and name."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("radiative_transfer_tpu_torch.") or \
                mod is None:
            continue
        for attr, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int) and \
                    getattr(fn, "__module__", None) == mod_name:
                out[f"{mod_name}.{attr}"] = n
    return out


def judge(numbers: dict, limits: dict) -> list:
    """[name, value, limit, passed] for each number compared."""
    rows = []
    for name, limit in limits.items():
        v = float(numbers.get(name, math.nan))
        rows.append([name, v, limit, bool(math.isfinite(v) and v <= limit)])
    return rows
