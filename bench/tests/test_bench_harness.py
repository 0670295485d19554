"""CPU tests of the harness: the traffic generator, the metric readers on
a recorded fixture, the result line, the refusal without a card, the
import check, ``BENCHMARK.json`` against the contract, and a whole run
of each tiny twin cell (made only of new files and entries) on the CPU."""
import json
import re
import subprocess
import sys

import numpy as np
import pytest

from benchlib import cli, spec, trace, traffic as T
from conftest import ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "compared"}


def mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["keyswitch_backlog", "matvec_backlog"])
def test_generator_is_deterministic_per_seed(name):
    m, amounts = mix(name), [1, 2, 4, -1, -2, -4]
    draw = lambda seed: T.chunk(m, amounts, 6, seed, 3)
    a, b, c = draw(2**33 + 1), draw(2**33 + 1), draw(-5)
    for field in ("op", "basis", "a", "b", "r"):
        assert np.array_equal(getattr(a, field), getattr(b, field))
    assert any(not np.array_equal(getattr(a, f), getattr(c, f)) for f in ("op", "a", "r"))
    # the same work for every seed: exact shares of ops and levels
    assert np.array_equal(np.bincount(a.op, minlength=5), np.bincount(c.op, minlength=5))
    assert a.basis.sum() == c.basis.sum() == round(m["lower_share"] * len(a))
    assert set(a.r) <= set(m.get("rotations", amounts))


def test_a_mix_rotates_only_by_keyed_amounts():
    with pytest.raises(ValueError, match="not keyed"):
        T.chunk(dict(mix("keyswitch_backlog"), rotations=[3]), [1, 2], 6, 1, 0)


def test_slots_follow_each_class_in_queue_order():
    d = T.Requests(op=np.array([2, 0, 2, 2, 0, 2]), basis=np.array([0, 0, 0, 1, 0, 0]),
                   a=np.zeros(6, int), b=np.zeros(6, int), r=np.ones(6, int))
    assert T.slots(d, 2).tolist() == [0, 0, 1, 0, 1, 0]


def test_the_sample_holds_every_slot_of_every_class(tiny_checkout):
    """Kept over a few chunks and drawn after the window, the sample of a
    key-switch run holds each of the 32 slots, ``sample_per_slot`` times."""
    c = spec.load("tiny-keyswitch", tiny_checkout)
    run = spec.system(c.config["system"]).Run(c, 2**40 + 3, "cpu")
    chunks = 2 * c.traffic["slots"] // c.traffic["keep_per_chunk"]
    run.keep_without_program(1.0, chunks)
    assert len(run.kept) == chunks * c.traffic["keep_per_chunk"]
    sample = run.sample()
    slots = [s for _, s, _, _ in sample]
    assert sorted(set(slots)) == list(range(32)) and run.strata == {(4, s) for s in range(32)}
    per_slot = chunks * c.traffic["keep_per_chunk"] // 32
    assert len(sample) == 32 * min(c.traffic["sample_per_slot"], per_slot)


def fixture_records():
    """A recorded sub-window: two port kernels, two glue kernels, one copy,
    two host spans, 1 ms of window (times in ns)."""
    return {
        "window": (0, 1_000_000),
        "device": [("void ntt_regs::ntt_rows_kernel<unsigned int, 7>(...)", 100_000, 200_000),
                   ("void galois_bulk_kernel<true>(...)", 200_000, 250_000),
                   ("void at::native::vectorized_elementwise_kernel<2, add>", 300_000, 500_000),
                   ("void at::native::elementwise_kernel<128, 2, mul>", 450_000, 600_000),
                   ("Memcpy DtoD (Device -> Device)", 700_000, 750_000)],
        "spans": [("serve.run", 0, 1_000_000), ("serve.dispatch", 600_000, 700_000)],
        "port": ("galois_bulk_kernel", "ntt_rows_kernel"),
        "counters": {"batched_ops": 90, "padded": 10, "program_dispatches": 5,
                     "requests": 100},
        "gc": {"pause_s": 0.25, "counts": [40, 3, 1], "window_s": 10.0},
        "requests": 10, "transforms": 10**5, "n": 128,
    }


def test_readers_on_a_recorded_fixture():
    rec = fixture_records()
    read = lambda name: spec.reader(name, ROOT)(rec)
    busy = 100_000 + 50_000 + 300_000 + 50_000          # merged intervals
    assert read("host.gc_pause_pct.keyswitch") == pytest.approx(2.5)
    assert read("plan.programs_per_request") == pytest.approx(0.05)
    for cell in ("keyswitch", "matvec"):
        assert read(f"glue.busy_pct.{cell}") == pytest.approx(100 * 300_000 / busy)
        assert read(f"kernels.port_us_per_request.{cell}") == pytest.approx(150.0 / 10)
        assert read(f"device.idle_pct.{cell}") == pytest.approx(100 * (1 - busy / 1e6))
    assert read("device.idle_pct.ntt128") == read("device.idle_pct.keyswitch")
    least = max(10**5 * 128 * 8 / 3.35e12, 10**5 * 64 * 7 * 8 / (132 * 64 * 1.98e9))
    assert read("ntt128_roofline") == pytest.approx(100 * least / (busy / 1e9))
    b = trace.breakdown(rec)
    assert b["device_ops"][0][0].startswith("void at::native::vectorized")
    gaps = dict(b["idle_gaps"])
    assert gaps["serve.dispatch"] == pytest.approx(1e-4 / 2 * 2)   # 600-700 us
    assert sum(gaps.values()) == pytest.approx(1e-3 - busy / 1e9)


def test_readers_return_nothing_without_records():
    empty = {"window": None, "device": [], "spans": [], "port": (), "requests": 0,
             "transforms": 0, "n": 128,
             "counters": {"batched_ops": 0, "padded": 0, "program_dispatches": 0, "requests": 0}}
    for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]:
        assert spec.reader(m["name"], ROOT)(empty) is None, m["name"]


def test_port_kernels_are_read_from_the_sources():
    port = trace.port_kernels(ROOT)
    assert {"ntt_rows_kernel", "ntt_stream_kernel", "dyadic_inner_banks_kernel",
            "galois_bulk_kernel", "twiddle_mul_banks_kernel"} <= set(port)
    keep = trace.port_filter(port)
    assert keep("void (anonymous namespace)::ntt_stream_kernel<true, true, false, 7>(x)")
    assert not keep("void at::native::vectorized_elementwise_kernel<2>(x)")


def test_benchmark_json_meets_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["bench"] and b["command"] == ["python3", "bench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("bench/configs/") and (ROOT / c["file"]).is_file()
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    cells = [w["name"] for w in b["workloads"]]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
    for cell in cells:             # setup_s, one other end-to-end, one per-layer
        assert sum(cell in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_run_refuses_without_a_card(tmp_path):
    p = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
                        "ntt128-batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    (tmp_path / "bench").symlink_to(ROOT / "bench")
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    p = subprocess.run([sys.executable, str(tmp_path / "bench" / "run.py"), "--workload",
                        "ntt128-batch", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_nothing_imports_jax_or_the_jax_package():
    """Every module under bench/ and every port module the cells use, in a
    fresh process: no top-level jax, jaxlib or repro module is loaded."""
    mods = sorted({".".join(p.relative_to(ROOT / "bench").with_suffix("").parts)
                   for p in (ROOT / "bench").glob("*/**/*.py")
                   if p.parts[-2] not in ("tests", "metrics") and p.name != "__init__.py"})
    code = f"""
import importlib, importlib.util, sys, pathlib
sys.path[:0] = [{str(ROOT / 'bench')!r}, {str(ROOT / 'src')!r}]
for m in {mods!r} + ["repro_torch.fhe.serve", "repro_torch.fhe.ckks", "repro_torch.fhe.linalg",
        "repro_torch.kernels.ops", "repro_torch.core.params", "repro_torch.obs"]:
    importlib.import_module(m)
for p in pathlib.Path({str(ROOT / 'bench' / 'metrics')!r}).glob("*.py"):
    spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
    assert "benchlib.systems.ckks_serve" in mods and "reference.ckks" in mods


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_a_new_cell_of_new_files_runs(tiny_checkout, cell, traced):
    """A cell added as new files and entries only is found by name and runs
    end to end (on the CPU, below the look for a card); the result line
    has exactly the contract's keys, the compared numbers last."""
    c = spec.load(cell, tiny_checkout)
    r = cli.run_cell(c, 2**31 + 11, 0.5, traced, "cpu", 0.0)
    assert set(r) - {"breakdown"} == RESULT_KEYS and list(r)[-1] == "compared"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    assert set(r["metrics"]) <= want
    if not traced:                      # the host-clock metrics all read on the CPU
        assert set(r["metrics"]) == want
    json.dumps(r)
