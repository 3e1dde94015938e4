"""The manifest and the files it names, the import guard, the sampling of
answers and the reading of a device trace."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import harness
import tracing

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_manifest_keys_and_names(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["rtbench"] and man["command"][1] == "rtbench/run.py"
    assert 1 <= man["run_seconds"] <= 51
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("rtbench/") and (ROOT / c["file"]).is_file()
        deck = harness.load_json(ROOT / c["file"])["deck"]
        assert all(NAME.match(k) and k in deck for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
        names += [w["name"], w["config"], w["traffic"]]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in man["end_to_end"] + man["per_layer"]}) \
        == len(man["end_to_end"]) + len(man["per_layer"])
    assert len(json.dumps(man)) < 64 * 1024


def test_every_cell_reports_what_it_must(man):
    for w in man["workloads"]:
        spec = harness.cell_spec(w["name"])
        e2e = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer
        for m in spec.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_forbidden_modules_by_whole_top_level_name():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "radiative_transfer_tpu", "radiative_transfer_tpu.ops.sweep",
              "radiative_transfer_tpu_torch", "radiative_transfer_tpu_torch.ops",
              "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "radiative_transfer_tpu", "radiative_transfer_tpu.ops.sweep"]


def test_a_run_loads_no_jax():
    """Everything a run loads (the harness, each entry and reader, the
    reference, the program's engines, one request and its check on the
    CPU) leaves no forbidden module in sys.modules."""
    code = f"""
import sys
sys.path.insert(0, {str(harness.HERE)!r})
sys.path.insert(0, {str(harness.HERE / 'tests')!r})
import run, calibrate, harness
from helpers import small_spec
for w in harness.manifest()["workloads"]:
    for m in harness.manifest()["end_to_end"] + harness.manifest()["per_layer"]:
        harness.reader(m["name"])
spec, deck = small_spec("gray_s32.f32_bdf2", N=64, steps=2)
run.execute(spec, 7, 0.01, trace=False, device="cpu", deck=deck)
spec, deck = small_spec("gray_s32.grad_bdf2", N=64, steps=2)
run.execute(spec, 7, 0.01, trace=False, device="cpu", deck=deck)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "gray_s32.f32_bdf2", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_sample_is_seeded_and_falls_to_the_last_request():
    def draw(seed, n, expected=100):
        s = harness.Sample(2, seed, expected)
        for i in range(n):
            s.offer(i, {"i": i}, dict)
        return sorted(i for i, _ in s.close(dict))

    assert draw(11, 100) == draw(11, 100)
    assert len(draw(11, 100)) == 2 and draw(11, 100) != draw(12, 100)
    hits = [0] * 100
    for seed in range(1000):
        for i in draw(seed, 100):
            hits[i] += 1
    assert min(hits) > 5 and max(hits) < 40    # 20 each expected
    # A window shorter than expected: the last request stands in.
    short = [draw(seed, 3) for seed in range(50)]
    assert all(1 <= len(d) <= 2 and max(d) <= 2 for d in short)
    assert any(2 in d for d in short)


def test_judge_and_worse():
    rows = harness.judge({"a": 1e-6, "b": float("nan")}, {"a": 1e-5, "b": 1})
    assert rows == [["a", 1e-6, 1e-5, True], ["b", rows[1][1], 1, False]]
    assert harness.worse(0.0, float("nan")) == float("inf")
    assert harness.worse(2.0, 1.0) == 2.0


def test_trace_reduction():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("Memcpy DtoH", 30.0, 40.0),
           ("ncclKernel_AllGather", 50.0, 55.0), ("late", 200.0, 300.0)]
    host = [(tracing.WINDOW_SPAN, 0.0, 100.0), ("solve", 0.0, 24.0),
            ("readback", 24.0, 44.0), ("init", 46.0, 100.0)]
    s = tracing.summarize(dev, host)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["nccl_s"] == pytest.approx(5e-6)
    assert s["device_ops"][0] == ["k2", pytest.approx(15e-6)]
    gaps = dict(s["idle_gaps"])
    assert gaps == {"init": pytest.approx(45e-6),
                    "readback": pytest.approx(10e-6),
                    "loop": pytest.approx(10e-6)}
    assert tracing.short_name(
        "(anonymous namespace)::bdf2_kernel(float const*, int)") == \
        "(anonymous namespace)::bdf2_kernel"
    assert tracing.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"
    assert tracing.idle_gaps(dev, 0.0, 100.0) == [(20.0, 30.0), (40.0, 50.0),
                                                  (55.0, 100.0)]


def test_config_files_hold_their_sources():
    for name in ("gray_s32", "llnl_124g", "llnl_124g_x4"):
        c = json.loads(Path(harness.HERE / "configs" / f"{name}.json")
                       .read_text())
        assert c["name"] == name and TEXT.match(c["source"])
        assert set(c["reduced"]) <= set(c["assumed"])
