"""CPU tests of the hybrid key-switch cell: its traffic mix and
configuration as the cell states them, the ``basis.*`` and
``plan.digits_per_request.n16`` readers on synthetic records, and a tiny
twin of the cell (n = 1024, L + 1 = 5, dnum = 2: digits of 3 + 2 primes,
K = 3) made only of new files and entries, run end to end with and
without a trace; the check fails it under the planted faults of
``tools/faults.py``, under a fault in one converted word, and under the
float64 control."""
import json

import pytest
import torch

from benchlib import cli, spec
from benchlib.systems import ckks_hybrid
from conftest import ROOT, make_tiny_checkout
from tools.faults import FAULTS

CELL = "n16-hybrid-keyswitch"
TWIN = "tiny-hybrid"
METRICS = ("basis.roofline.n16", "basis.busy_pct.n16", "plan.digits_per_request.n16")
GENERIC = ("glue.busy_pct.n16", "kernels.port_us_per_request.n16", "device.idle_pct.n16",
           "serve.wait_us_per_request.n16", "plan.host_us_per_request.n16")


def read(name, rec):
    return spec.reader(name, ROOT)(rec)


@pytest.fixture(scope="module")
def hybrid_checkout(tmp_path_factory):
    """A checkout with the tiny twins and a tiny twin of the hybrid cell,
    added as new files and entries."""
    dest = make_tiny_checkout(tmp_path_factory.mktemp("hybrid"))
    b = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench" / "configs" / "ckks-n16-dnum4.json").read_text())
    cut = {"n": 1024, "levels": 4, "dnum": 2}
    cfg.update(cut, reduced=sorted(cfg["reduced"] + list(cut)))
    (dest / "bench" / "configs" / "tiny-hybrid.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "bench" / "traffic" / "n16_keyswitch_backlog.json").read_text())
    mix.update(chunk=64, pool=16, warm_requests=16, profile_s=0.3, keep_per_chunk=32,
               sample_per_slot=1)
    (dest / "bench" / "traffic" / f"{TWIN}.json").write_text(json.dumps(mix))
    b["configs"].append({"name": "tiny-hybrid", "source": "a tiny twin",
                         "file": "bench/configs/tiny-hybrid.json",
                         "reduced": cfg["reduced"], "why": "the CPU tests"})
    b["workloads"].append({"name": TWIN, "config": "tiny-hybrid", "traffic": TWIN,
                           "chips": 1, "why": "a tiny twin for the CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TWIN)
    (dest / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dest


def test_the_cell_and_its_traffic_are_as_stated():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in b["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("ckks-n16-dnum4", "n16_keyswitch_backlog", 1)
    mix = json.loads((ROOT / "bench" / "traffic" / "n16_keyswitch_backlog.json").read_text())
    assert {k: v for k, v in mix.items() if k not in ("source", "assumed")} == {
        "arrival": "backlog", "chunk": 512, "ops": {"rotate": 1}, "rotations": [1],
        "lower_share": 0, "pool": 64, "slots": 32, "keep_per_chunk": 8,
        "sample_per_slot": 2, "warm_requests": 64, "profile_s": 2.0,
        "throughput_metric": "requests_per_s"}
    cfg = json.loads((ROOT / "bench" / "configs" / "ckks-n16-dnum4.json").read_text())
    assert (cfg["system"], cfg["n"], cfg["levels"], cfg["dnum"], cfg["key_bases"]) == (
        "ckks_hybrid", 1 << 16, 23, 4, 1)
    alpha, Ps, qs = ckks_hybrid.hybrid_chain(cfg["n"], cfg["levels"], cfg["dnum"])
    assert (alpha, len(Ps), len(qs)) == (6, 6, 24)
    # 4 digits, each a (b, a) pair over 30 primes: 62.9 MB a key; 31 keys
    # (relinearization, conjugation and +-2^i, i < 15, where +-2^14 coincide)
    assert 2 * 4 * 30 * cfg["n"] * 4 == 62_914_560
    inp = ckks_hybrid.Inputs(cfg, dict(mix, pool=1), 1, "cpu")
    assert len(inp.key_order) == 31 and len({s.g for s in inp.key_order}) == 31
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["requests_per_s"]["workloads"] and e2e["requests_per_s"]["bound"] == 0.1
    for name in METRICS + GENERIC:
        m = {x["name"]: x for x in b["per_layer"]}[name]
        assert m["workloads"] == [CELL] and m["moves"] == "requests_per_s"


def test_basis_kernels_are_read_from_basis_cu():
    assert ckks_hybrid.basis_kernels(ROOT) == (
        "base_conv_kernel", "extend_centered_kernel", "mod_down_tail_kernel")


def synthetic(key_switches=10):
    """A sub-window of 1 ms: two basis kernels, an NTT, a glue kernel."""
    return {
        "window": (0, 1_000_000),
        "device": [("void (anonymous namespace)::base_conv_kernel<8, 4>(...)", 0, 100_000),
                   ("void (anonymous namespace)::mod_down_tail_kernel<4, true>(x)",
                    150_000, 200_000),
                   ("void ntt_regs::ntt_rows_kernel<unsigned int, 7>(...)", 200_000, 700_000),
                   ("void at::native::vectorized_elementwise_kernel<2, add>", 650_000, 800_000)],
        "spans": [], "port": ("base_conv_kernel", "mod_down_tail_kernel", "ntt_rows_kernel"),
        "basis_kernels": ("base_conv_kernel", "extend_centered_kernel", "mod_down_tail_kernel"),
        "key_switches": key_switches, "requests": key_switches,
        "deployment": {"n": 1 << 16, "levels": 23, "dnum": 4},
        "counters": {"batched_ops": 10, "padded": 0, "program_dispatches": 1, "requests": 8,
                     "ks_digits": 32},
    }


def test_the_readers_on_synthetic_records():
    rec = synthetic()
    busy, basis = 750_000, 150_000          # merged intervals
    assert read("basis.busy_pct.n16", rec) == pytest.approx(100 * basis / busy)
    assert read("plan.digits_per_request.n16", rec) == pytest.approx(4.0)
    # 348 words and 948 multiply-adds of n a key switch: the bytes bound it
    least = 348 * (1 << 16) * 4 / 3.35e12
    assert read("basis.roofline.n16", rec) == pytest.approx(100 * 10 * least / (basis / 1e9))
    for name in METRICS[:2]:                # the device-trace readers
        assert read(name, {**rec, "window": None}) is None
    assert read("basis.roofline.n16", {**rec, "key_switches": 0}) is None
    assert read("plan.digits_per_request.n16", {**rec, "counters": {"requests": 8}}) is None


@pytest.mark.parametrize("name", GENERIC)
def test_the_generic_readers_read_as_the_keyswitch_cells(name):
    """Each re-reads its fig22-keyswitch twin's quantity on this cell."""
    rec = synthetic()
    twin = name.replace(".n16", ".keyswitch")
    assert read(name, rec) == read(twin, rec)
    if name.startswith(("glue", "device", "kernels")):
        assert read(name, {**rec, "window": None}) is None


def test_the_roofline_counts_the_deployment():
    import importlib.util
    path = ROOT / "bench" / "metrics" / "basis.roofline.n16.py"
    mod_spec = importlib.util.spec_from_file_location("roofline_n16", path)
    m = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(m)
    n = 1 << 16
    assert m.work(n, 23, 4) == (348 * n * 4, 948 * n)
    # mod-up alone: 24 read, 4 x 24 written, 4 x 6 x 24 + 24 multiply-adds
    assert m.work(n, 23, 4)[1] - 300 * n - 48 * n == 600 * n
    # digits of 3 + 2 at L + 1 = 5: kt = 8
    assert m.work(1, 4, 2) == ((5 + 5 + 6 + 2 * 8 + 2 * 3 * 5 + 5) * 4,
                               3 * 5 + 2 * 6 + 5 + 2 * (3 * 5 + 3) + 2 * 5)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_the_tiny_twin_runs(hybrid_checkout, traced):
    c = spec.load(TWIN, hybrid_checkout)
    r = cli.run_cell(c, 2**31 + 17, 0.5, traced, "cpu", 0.0)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["compared"]
    assert r["compared"]["missing_slots"]["value"] == 0
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    assert set(r["metrics"]) <= want
    if traced:      # no device trace on the CPU: the counter alone reads
        assert r["metrics"]["plan.digits_per_request.n16"]["value"] == pytest.approx(2.0)
    else:
        assert set(r["metrics"]) == {"requests_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_the_check(hybrid_checkout, monkeypatch, fault):
    FAULTS[fault](monkeypatch.setattr)
    r = cli.run_cell(spec.load(TWIN, hybrid_checkout), 977, 0.3, False, "cpu", 0.0)
    assert not r["correct"], r["compared"]


def test_one_converted_word_changed_fails_the_check(hybrid_checkout, monkeypatch):
    """One word of every mod-up's output (digit 0's first converted word,
    on the special prime P_0) changed: every answer is off."""
    from repro_torch.kernels import ops
    conv = ops.base_conv_banks

    def bumped(x, table):
        y = conv(x, table)
        if table["src"].shape[0] > 1 or table["dst"].shape[0] > x.shape[0]:
            y = y.clone()
            y[-1, 0].view(-1)[0] = (y[-1, 0].view(-1)[0].long() + 1) % (
                table["dst"][-1].long() & 0xFFFFFFFF)
        return y
    monkeypatch.setattr(ops, "base_conv_banks", bumped)
    r = cli.run_cell(spec.load(TWIN, hybrid_checkout), 979, 0.3, False, "cpu", 0.0)
    assert not r["correct"] and r["compared"]["mismatched_words"]["value"] > 0


def test_the_control_fails_the_check(hybrid_checkout):
    c = spec.load(TWIN, hybrid_checkout)
    run = spec.system(c.config["system"]).Run(c, 31, "cpu")
    run.keep_without_program(1.0, 2)
    compared = run.check(control=True)
    assert compared["mismatched_words"][0] > 0
    assert not all(v <= lim for v, lim in compared.values())


def test_a_k_mesh_is_refused_on_the_cells_context():
    from repro_torch.fhe.ckks import CkksContext
    from repro_torch.fhe.evalplan import EvalPlan
    from repro_torch.mesh import make_mesh
    ctx = CkksContext(n=64, levels=23, dnum=4, seed=0, device="cpu")
    assert (ctx.alpha, len(ctx.specials)) == (6, 6)
    with pytest.raises(NotImplementedError, match="dnum = 4"):
        EvalPlan(ctx, mesh=make_mesh(["cpu"] * 2, ("k",)))


torch.set_num_threads(1)
