"""CPU tests of the ML-KEM cell: the plain reference against the FIPS 203
oracle of the program's tests and the KAT vectors, §7.2's check, the
configuration and traffic as the cell states them, a tiny twin of the
cell (batches of 64, 2 malformed keys each) made only of new files and
entries and run end to end with and without a trace, two planted faults
and the float32 control each failing the check, and the 44-permutation
count and every new reader pinned on synthetic records."""
import json
import sys

import numpy as np
import pytest
import torch

from benchlib import cli, spec, trace
from benchlib.systems import mlkem_bulk
from conftest import ROOT, make_tiny_checkout
from reference import mlkem as R

sys.path.insert(0, str(ROOT / "tests"))
import mlkem_spec  # noqa: E402

CELL = "mlkem768-tls-encaps"
TWIN = "tiny-mlkem"
READERS = ("keccak.roofline.mlkem", "ring.roofline.mlkem", "glue.busy_pct.mlkem",
           "kernels.port_us_per_request.mlkem", "device.idle_pct.mlkem")


def read(name, rec):
    return spec.reader(name, ROOT)(rec)


def _kats():
    return json.loads((ROOT / "tests" / "vectors" / "mlkem768_kat.json").read_text())["vectors"]


def test_reference_equals_the_oracle_and_the_kats():
    ref = R.MlKem768()
    for v in _kats():
        ek, m = bytes.fromhex(v["ek"]), bytes.fromhex(v["m"])
        assert ref.encaps(ek, m) == (True, bytes.fromhex(v["K"]), bytes.fromhex(v["ct"]))
    rng = np.random.default_rng(3)
    for _ in range(2):
        d, z, m = (bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(3))
        ek, _ = mlkem_spec.keygen(d, z)
        assert ref.encaps(ek, m) == (True, *mlkem_spec.encaps(ek, m))
        seed = ek[:32] + bytes([1, 2])
        assert R.sample_ntt(seed) == mlkem_spec.sample_ntt(seed)
        assert R.byte_decode(12, ek[:384]) == mlkem_spec.byte_decode(12, ek[:384])


@pytest.mark.parametrize("value", [R.Q, R.Q + 1, 4095])
@pytest.mark.parametrize("coefficient", [0, 1, 500, 767])
def test_modulus_check_rejects_a_coefficient_at_q_or_above(value, coefficient):
    """§7.2: one 12-bit field at q or above fails ByteEncode12(ByteDecode12(ek))
    == ek; the key is rejected with zero K and ct."""
    ek = bytearray(bytes.fromhex(_kats()[0]["ek"]))
    assert R.modulus_check(bytes(ek))
    o = 3 * (coefficient // 2)
    if coefficient % 2 == 0:
        ek[o], ek[o + 1] = value & 255, (ek[o + 1] & 0xF0) | (value >> 8)
    else:
        ek[o + 1], ek[o + 2] = (ek[o + 1] & 0x0F) | ((value & 15) << 4), value >> 4
    assert not R.modulus_check(bytes(ek))
    assert R.MlKem768().encaps(bytes(ek), bytes(32)) == (False, bytes(32), bytes(R.CT_BYTES))


def test_the_cell_and_its_traffic_are_as_stated():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in b["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("mlkem768-tls13", "mlkem_tls_encaps", 1)
    c = {x["name"]: x for x in b["configs"]}["mlkem768-tls13"]
    assert c["reduced"] == [] and c["file"] == "bench/configs/mlkem768-tls13.json"
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert {k: cfg[k] for k in ("system", "n", "q", "k", "eta1", "eta2", "du", "dv")} == {
        "system": "mlkem_bulk", "n": 256, "q": 3329, "k": 3, "eta1": 2, "eta2": 2,
        "du": 10, "dv": 4}
    mix = json.loads((ROOT / "bench" / "traffic" / "mlkem_tls_encaps.json").read_text())
    assert {k: v for k, v in mix.items() if k not in ("source", "assumed")} == {
        "batch": 32768, "pool": 4, "malformed_per_batch": 32, "sample_per_batch": 32,
        "profile_s": 1.0, "profile_host": False, "throughput_metric": "requests_per_s"}
    # 256 rows checked a run; 9 b SampleNTT streams past the H100's resident threads
    assert mix["pool"] * (mix["malformed_per_batch"] + mix["sample_per_batch"]) == 256
    assert 9 * mix["batch"] > 132 * 2048 > 9 * mix["batch"] // 2
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["requests_per_s"]["workloads"] and e2e["requests_per_s"]["bound"] == 0.1
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "requests_per_s"


@pytest.fixture(scope="module")
def mlkem_checkout(tmp_path_factory):
    """A checkout with the tiny twins and a tiny twin of the ML-KEM cell,
    added as new files and entries."""
    dest = make_tiny_checkout(tmp_path_factory.mktemp("mlkem"))
    b = json.loads((dest / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "bench" / "traffic" / "mlkem_tls_encaps.json").read_text())
    mix.update(batch=64, pool=2, malformed_per_batch=2, sample_per_batch=3, profile_s=0.3)
    (dest / "bench" / "traffic" / f"{TWIN}.json").write_text(json.dumps(mix))
    b["workloads"].append({"name": TWIN, "config": "mlkem768-tls13", "traffic": TWIN,
                           "chips": 1, "why": "a tiny twin for the CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TWIN)
    (dest / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dest


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
def test_the_twin_runs_correct(mlkem_checkout, traced):
    r = cli.run_cell(spec.load(TWIN, mlkem_checkout), 2**33 + 5, 0.3, traced, "cpu", 0.0)
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == {"mismatched_bytes", "bad_verdicts", "missing_rows"}
    assert r["attempted"] >= 64 and r["attempted"] % 64 == 0 and r["failed"] == 0
    if not traced:
        assert set(r["metrics"]) == {"requests_per_s", "setup_s"}


def test_the_twin_draws_malformed_keys_from_the_seed(mlkem_checkout):
    cell = spec.load(TWIN, mlkem_checkout)
    a, b = (mlkem_bulk.Run(cell, s, "cpu") for s in (11, 11))
    c = mlkem_bulk.Run(cell, 12, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.ek, b.ek))
    assert not torch.equal(a.ek[0], c.ek[0])
    for ek, rows in zip(a.ek, a.rows):
        verdicts = [R.modulus_check(bytes(row)) for row in ek.numpy()]
        assert verdicts.count(False) == 2
        bad = {i for i, v in enumerate(verdicts) if not v}
        assert bad <= set(rows.tolist()) and len(rows) == 5


def _flip_a_byte(monkeypatch):
    from repro_torch.pq import mlkem
    real = mlkem.encaps_batch

    def encaps(ek, m, device=None):
        key, ct, ok = real(ek, m, device)
        ct = ct.clone()
        ct[:, 5] ^= 1
        return key, ct, ok
    monkeypatch.setattr(mlkem, "encaps_batch", encaps)


def _accept_every_key(monkeypatch):
    from repro_torch.pq import mlkem
    real = mlkem.encaps_batch

    def encaps(ek, m, device=None):
        key, ct, ok = real(ek, m, device)
        return key, ct, torch.ones_like(ok)
    monkeypatch.setattr(mlkem, "encaps_batch", encaps)


@pytest.mark.parametrize("fault", [_flip_a_byte, _accept_every_key],
                         ids=["flipped ct byte", "malformed key accepted"])
def test_a_planted_fault_fails_the_check(mlkem_checkout, monkeypatch, fault):
    fault(monkeypatch)
    r = cli.run_cell(spec.load(TWIN, mlkem_checkout), 977, 0.3, False, "cpu", 0.0)
    assert not r["correct"], r["compared"]


def test_the_float32_control_fails_the_check(mlkem_checkout):
    c = spec.load(TWIN, mlkem_checkout)
    run = mlkem_bulk.Run(c, 31, "cpu")
    run.keep_without_program(1.0, 4)
    compared = run.check(control=True)
    assert compared["mismatched_bytes"][0] > 0 and compared["bad_verdicts"][0] == 0


def test_a_run_that_kept_nothing_misses_rows(mlkem_checkout):
    run = mlkem_bulk.Run(spec.load(TWIN, mlkem_checkout), 5, "cpu")
    assert run.check()["missing_rows"] == (10, 0)


# ------------------------------------------------------------ readers

def _record(kernels, requests, window_ns=1_000_000_000):
    return {"window": (0, window_ns), "device": kernels, "requests": requests,
            "port": ("sample_ntt_kernel", "prf_cbd_kernel", "keccak_hash_kernel",
                     "ntt_rows_kernel", "basemul_vec_kernel"),
            "keccak_kernels": ("keccak_hash_kernel", "prf_cbd_kernel", "sample_ntt_kernel"),
            "ring_kernels": ("basemul_vec_kernel", "ntt_rows_kernel")}


def test_the_keccak_floor_is_44_permutations_of_4320_instructions():
    keccak = spec.reader("keccak.roofline.mlkem", ROOT).__globals__
    assert keccak["PERMS_A_ENCAPS"] == 44
    assert keccak["ROUNDS"] * keccak["LANE_OPS_A_ROUND"] * keccak["INT32_A_LANE_OP"] == 4320
    # about 190,000 INT32 instructions a row: 0.372 ms at b = 32768
    assert keccak["least_seconds"](32768) == pytest.approx(32768 * 44 * 4320 / (132 * 64 * 1.98e9))
    assert keccak["least_seconds"](32768) == pytest.approx(3.72364e-4, rel=1e-4)


def test_the_readers_on_a_synthetic_record():
    """1 ms of Keccak kernels, 0.5 ms of ring kernels, 0.25 ms of PyTorch
    glue and 0.25 ms idle in a 2 ms window over 32768 encapsulations."""
    dev = [("void (anonymous namespace)::keccak_hash_kernel<136>(x)", 0, 200_000),
           ("(anonymous namespace)::sample_ntt_kernel(y)", 200_000, 800_000),
           ("(anonymous namespace)::prf_cbd_kernel(z)", 800_000, 1_000_000),
           ("void ntt_regs::ntt_rows_kernel<unsigned short, true>(a)", 1_000_000, 1_300_000),
           ("void (anonymous namespace)::basemul_vec_kernel<true, 2, true>(b)", 1_300_000,
            1_500_000),
           ("void at::native::vectorized_elementwise_kernel<4>(c)", 1_500_000, 1_750_000)]
    rec = _record(dev, 32768, window_ns=2_000_000)
    assert read("keccak.roofline.mlkem", rec) == pytest.approx(100 * 3.72364e-4 / 1e-3, rel=1e-4)
    ring = spec.reader("ring.roofline.mlkem", ROOT).__globals__
    rows = ring["row_seconds"]()
    # forward and inverse rows bound by instructions, a product row by bytes
    assert rows["forward"] == pytest.approx((128 * 7 * 9 + 256) / (132 * 64 * 1.98e9))
    assert rows["inverse"] == pytest.approx((128 * 7 * 9 + 256 * 5) / (132 * 64 * 1.98e9))
    assert rows["product"] == pytest.approx(3 * 256 * 2 / 3.35e12)
    least = 32768 * (3 * rows["forward"] + 4 * rows["inverse"] + 12 * rows["product"])
    assert read("ring.roofline.mlkem", rec) == pytest.approx(100 * least / 5e-4)
    assert read("glue.busy_pct.mlkem", rec) == pytest.approx(100 * 0.25 / 1.75)
    assert read("kernels.port_us_per_request.mlkem", rec) == pytest.approx(1500 / 32768)
    assert read("device.idle_pct.mlkem", rec) == pytest.approx(100 * 0.25 / 2)
    assert 0 < read("keccak.roofline.mlkem", rec) < 100
    assert 0 < read("ring.roofline.mlkem", rec) < 100


def test_the_readers_find_nothing_without_the_kernels():
    """On a program without ``csrc/keccak.cu`` (the parent's) the Keccak
    reader finds nothing to read; none reads a record without a window."""
    rec = _record([("void ntt_regs::ntt_rows_kernel<unsigned short>(a)", 0, 10)], 64)
    rec["keccak_kernels"] = ()
    assert read("keccak.roofline.mlkem", rec) is None
    for name in READERS:
        assert read(name, {"window": None, "device": [], "requests": 0}) is None
    assert mlkem_bulk.kernels_of(ROOT, "no_such.cu") == ()
    assert {"sample_ntt_kernel", "prf_cbd_kernel"} <= set(mlkem_bulk.kernels_of(ROOT, "keccak.cu"))
    assert "ntt_rows_kernel" in mlkem_bulk.kernels_of(ROOT, "ntt_regs.cuh", "ntt_banks.cu")
    assert trace.port_filter(rec["keccak_kernels"])("sample_ntt_kernel") is False
