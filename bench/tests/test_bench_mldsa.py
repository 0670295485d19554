"""CPU tests of the ML-DSA cell: the configuration, traffic and reader
files as the cell states them, the plain reference's round trip (keygen,
sign, verify) and its refusals, a tiny twin of the cell (4 slots over a
pool of 16) made only of new files and entries and run end to end with
and without a trace, planted faults (a byte of a signature or of the
key, a request emitted twice) and the control (the bound on ||z|| left
out, drawn as ``bench/tools/control.py`` draws it) each failing the check, the stream's counters feeding
``mldsa.slot_iterations_per_signature``, and every new reader pinned on
synthetic records."""
import json

import numpy as np
import pytest

from benchlib import cli, spec, trace
from benchlib.systems import mldsa_stream
from conftest import ROOT, make_tiny_checkout
from reference import mldsa as R

CELL = "mldsa65-tls-sign"
TWIN = "tiny-mldsa"
READERS = ("keccak.roofline.mldsa", "ring.roofline.mldsa",
           "mldsa.slot_iterations_per_signature", "glue.busy_pct.mldsa",
           "kernels.port_us_per_request.mldsa", "device.idle_pct.mldsa")


def read(name, rec):
    return spec.reader(name, ROOT)(rec)


def test_the_cell_and_its_files_are_as_stated():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in b["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("mldsa65-tls13", "mldsa_tls_sign", 1)
    c = {x["name"]: x for x in b["configs"]}["mldsa65-tls13"]
    assert c["reduced"] == [] and c["file"] == "bench/configs/mldsa65-tls13.json"
    assert len(c["source"]) <= 200 and "FIPS 204" in c["source"] and \
        "draft-ietf-tls-mldsa" in c["source"]
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["system"] == "mldsa_stream" and cfg["reduced"] == []
    assert {k: cfg[k] for k in mldsa_stream.STATED} == mldsa_stream.STATED
    assert (cfg["pk_bytes"], cfg["sk_bytes"], cfg["sig_bytes"]) == (1952, 4032, 3309)
    mix = json.loads((ROOT / "bench" / "traffic" / "mldsa_tls_sign.json").read_text())
    assert {k: v for k, v in mix.items() if k not in ("source", "assumed")} == {
        "slots": 65536, "pool": 1 << 20, "context": "TLS 1.3, server CertificateVerify",
        "transcript_hash_bytes": 32, "ring": 131072, "sample": 256, "profile_s": 1.0,
        "profile_host": False, "throughput_metric": "requests_per_s"}
    # 5 ExpandMask streams a slot past the H100's resident threads; M' of 132 bytes
    assert 5 * mix["slots"] > 132 * 2048 > 5 * mix["slots"] // 2
    assert len(mldsa_stream.message_prefix(mix["context"])) + 32 == 132
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert CELL in e2e["requests_per_s"]["workloads"] and e2e["requests_per_s"]["bound"] == 0.1
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "requests_per_s"
        assert callable(spec.reader(name, ROOT))


def test_the_reference_round_trips_and_refuses():
    """KeyGen -> Sign -> Verify; a flipped byte, another message, a hint
    out of order and a bad length are refused."""
    pk, sk = R.MlDsa65.keygen(bytes(range(32)))
    assert (len(pk), len(sk)) == (R.PK_BYTES, R.SK_BYTES)
    msg = mldsa_stream.message_prefix("TLS 1.3, server CertificateVerify") + bytes(32)
    sig, n = R.MlDsa65().sign(sk, msg, bytes(32))
    assert len(sig) == R.SIG_BYTES and n >= 1
    assert R.MlDsa65().verify(pk, msg, sig)
    assert R.MlDsa65().sign(sk, msg, bytes(32)) == (sig, n)          # deterministic in rnd
    assert R.MlDsa65().sign(sk, msg, bytes([1] * 32))[0] != sig     # hedged by rnd
    for at in (0, R.CT_BYTES + 7, R.SIG_BYTES - 1):
        bad = bytearray(sig)
        bad[at] ^= 0x10
        assert not R.MlDsa65().verify(pk, msg, bytes(bad))
    assert not R.MlDsa65().verify(pk, msg + b"x", sig)
    assert not R.MlDsa65().verify(pk, msg, sig[:-1])
    h = bytearray(sig[-(R.OMEGA + R.K):])
    if h[R.OMEGA] >= 2:                    # two hints of row 0 swapped: out of order
        h[0], h[1] = h[1], h[0]
        assert R.hint_bit_unpack(bytes(h)) is None


@pytest.fixture(scope="module")
def mldsa_checkout(tmp_path_factory):
    """A checkout with the tiny twins and a tiny twin of the ML-DSA cell (4
    slots, a pool of 16, a ring of 32, 6 entries checked), added as new
    files and entries."""
    dest = make_tiny_checkout(tmp_path_factory.mktemp("mldsa"))
    b = json.loads((dest / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "bench" / "traffic" / "mldsa_tls_sign.json").read_text())
    mix.update(slots=4, pool=16, ring=32, sample=6, profile_s=0.3)
    (dest / "bench" / "traffic" / f"{TWIN}.json").write_text(json.dumps(mix))
    b["workloads"].append({"name": TWIN, "config": "mldsa65-tls13", "traffic": TWIN,
                           "chips": 1, "why": "a tiny twin for the CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TWIN)
    (dest / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dest


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
def test_the_twin_runs_correct(mldsa_checkout, traced):
    r = cli.run_cell(spec.load(TWIN, mldsa_checkout), 2**33 + 7, 0.3, traced, "cpu", 0.0)
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == {"mismatched_bytes", "bad_signatures", "bad_iterations",
                                  "missing_rows"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    if traced:           # the CPU has no device trace: the counters' metric alone
        assert "mldsa.slot_iterations_per_signature" in r["metrics"]
    else:
        assert set(r["metrics"]) == {"requests_per_s", "setup_s"}


def test_the_twin_draws_its_inputs_from_the_seed(mldsa_checkout):
    cell = spec.load(TWIN, mldsa_checkout)
    a, b, c = (mldsa_stream.Run(cell, s, "cpu") for s in (11, 11, 12))
    assert np.array_equal(a.xi, b.xi) and not np.array_equal(a.xi, c.xi)
    assert (a.msgs == b.msgs).all() and not (a.msgs == c.msgs).all()
    prefix = mldsa_stream.message_prefix("TLS 1.3, server CertificateVerify")
    assert all(bytes(m[:100].numpy()) == prefix for m in a.msgs)
    assert a.msgs.shape == (16, 132) and a.rnds.shape == (16, 32)


def _run_twin(mldsa_checkout, seed=977):
    run = mldsa_stream.Run(spec.load(TWIN, mldsa_checkout), seed, "cpu")
    run.setup()
    win = run.window(0.2)
    while not win["counters"]["signatures"]:
        win = run.window(0.2)
    run.free()
    return run, win


def test_a_planted_fault_and_the_control_fail_the_check(mldsa_checkout):
    """A byte of z flipped in the kept signatures fails the byte compare
    and Verify; a byte of the program's sk flipped fails the byte compare
    alone (the reference signs under its own key); the control (the
    reference without the bound on ||z||) misses bytes in the rows whose
    signing rejected a z; a run that kept nothing misses every row."""
    run, win = _run_twin(mldsa_checkout)
    assert all(v == 0 for v, _ in run.check().values())
    # the counters feed the stream's metric: slot-iterations a signature
    assert read("mldsa.slot_iterations_per_signature", {"counters": win["counters"]}) == \
        win["counters"]["slot_iterations"] / win["counters"]["signatures"]
    control = run.check(control=True)
    assert control["mismatched_bytes"][0] > 0 and run.mismatched_rows >= 1
    kept = list(run.kept)
    sk = run.sk.clone()
    run.sk[R.SK_BYTES - 5] ^= 1
    assert run.check() == {"mismatched_bytes": (1, 0), "bad_signatures": (0, 0),
                           "bad_iterations": (0, 0), "missing_rows": (0, 0)}
    run.sk = sk
    flip = lambda sig: sig[:R.CT_BYTES + 3] + bytes([sig[R.CT_BYTES + 3] ^ 1]) + \
        sig[R.CT_BYTES + 4:]
    run.kept = [(i, flip(sig), it, msg, rnd) for i, sig, it, msg, rnd in kept]
    faulty = run.check()
    assert faulty["mismatched_bytes"][0] == 6 and faulty["bad_signatures"][0] == 6
    run.kept = None
    assert run.check()["missing_rows"] == (6, 0)


def test_a_stream_that_emits_a_request_twice_fails_the_check(mldsa_checkout, monkeypatch):
    """A refill that leaves slot 0 on its old request once it accepts
    (planted after set-up, which waits for every slot to turn over): the
    slot signs it again, byte for byte, every round, so the sampled
    signatures all pass, but the ring holds the request many times and the
    signatures counter runs past the requests taken."""
    from repro_torch.pq import mldsa
    refill = mldsa.SignStream._refill

    def stuck(self, free):
        refill(self, free & (self._iota != 0))
    run = mldsa_stream.Run(spec.load(TWIN, mldsa_checkout), 977, "cpu")
    run.setup()
    monkeypatch.setattr(mldsa.SignStream, "_refill", stuck)
    while not run.window(0.2)["counters"]["signatures"]:
        pass
    run.free()
    got = run.check()
    assert got["missing_rows"][0] > 0, got
    assert (got["mismatched_bytes"], got["bad_signatures"], got["bad_iterations"]) == \
        ((0, 0), (0, 0), (0, 0))


def test_the_control_takes_the_shared_tool_path(mldsa_checkout):
    """``keep_without_program`` draws the sample a run would keep with no
    stream, as ``bench/tools/control.py`` asks of every cell; the control
    then fails the check on it."""
    run = mldsa_stream.Run(spec.load(TWIN, mldsa_checkout), 977, "cpu")
    run.keep_without_program(10.0, 1000)
    assert len(run.kept) == 6 and all(16 <= i + 32 < 1000 + 32 for i, *_ in run.kept)
    assert run.check(control=True)["mismatched_bytes"][0] > 0


# ------------------------------------------------------------ readers

def _record(kernels, signatures, iterations, window_ns=1_000_000_000):
    return {"window": (0, window_ns), "device": kernels, "requests": signatures,
            "row_iterations": iterations,
            "counters": {"slot_iterations": 5 * signatures + 100, "signatures": signatures},
            "port": ("expand_mask_kernel", "sample_in_ball_kernel", "keccak_hash_kernel",
                     "ntt_rows_kernel", "dyadic_inner_banks_kernel", "check_kernel"),
            "keccak_kernels": ("expand_mask_kernel", "keccak_hash_kernel",
                               "sample_in_ball_kernel"),
            "ring_kernels": ("ntt_rows_kernel", "dyadic_inner_banks_kernel")}


def test_the_floors_are_counted_from_fips_204():
    keccak = spec.reader("keccak.roofline.mldsa", ROOT).__globals__
    assert keccak["PERM_INT32"] == 4320
    assert keccak["PERMS_A_SIGNATURE"] == 3 and keccak["PERMS_AN_ITERATION"] == 33
    # 171 permutations for a signature of 5.1 iterations (FIPS 204's mean)
    assert 3 + 33 * 5.1 == pytest.approx(171.3)
    ring = spec.reader("ring.roofline.mldsa", ROOT).__globals__
    rows = ring["row_seconds"]()
    assert rows["forward"] == pytest.approx(2048 / 3.35e12)     # bytes bound
    assert rows["inverse"] == pytest.approx(2048 / 3.35e12)
    one = ring["least_seconds"](1, 1)
    assert one == pytest.approx((6 + 23) * 2048 / 3.35e12 + 29 * 1024 / 3.35e12)


def test_the_readers_on_a_synthetic_record():
    """1 ms of Keccak kernels, 0.5 ms of ring kernels, 0.25 ms of glue and
    0.25 ms idle in a 2 ms window over 2000 signatures of 10200
    iterations."""
    dev = [("(anonymous namespace)::expand_mask_kernel(x)", 0, 700_000),
           ("void (anonymous namespace)::keccak_hash_kernel<136>(y)", 700_000, 900_000),
           ("(anonymous namespace)::sample_in_ball_kernel(z)", 900_000, 1_000_000),
           ("void ntt_regs::ntt_rows_kernel<unsigned int, true>(a)", 1_000_000, 1_300_000),
           ("void (anonymous namespace)::dyadic_inner_banks_kernel<4, 1, true, 5, 23>(b)",
            1_300_000, 1_500_000),
           ("void at::native::vectorized_elementwise_kernel<4>(c)", 1_500_000, 1_750_000)]
    rec = _record(dev, 2000, 10200, window_ns=2_000_000)
    keccak = spec.reader("keccak.roofline.mldsa", ROOT).__globals__
    ring = spec.reader("ring.roofline.mldsa", ROOT).__globals__
    assert read("keccak.roofline.mldsa", rec) == pytest.approx(
        100 * (2000 * 3 + 10200 * 33) * 4320 / (132 * 64 * 1.98e9) / 1e-3)
    assert read("keccak.roofline.mldsa", rec) == pytest.approx(
        100 * keccak["least_seconds"](2000, 10200) / 1e-3)
    assert read("ring.roofline.mldsa", rec) == pytest.approx(
        100 * ring["least_seconds"](2000, 10200) / 5e-4)
    assert read("mldsa.slot_iterations_per_signature", rec) == pytest.approx(5.05)
    assert read("glue.busy_pct.mldsa", rec) == pytest.approx(100 * 0.25 / 1.75)
    assert read("kernels.port_us_per_request.mldsa", rec) == pytest.approx(1500 / 2000)
    assert read("device.idle_pct.mldsa", rec) == pytest.approx(100 * 0.25 / 2)
    assert 0 < read("keccak.roofline.mldsa", rec) < 100
    assert 0 < read("ring.roofline.mldsa", rec) < 100


def test_the_readers_find_nothing_without_the_stream():
    """On a program without the stream (the parent's) nothing is recorded
    to read; none reads a record without a window or counters."""
    rec = _record([("void ntt_regs::ntt_rows_kernel<unsigned int>(a)", 0, 10)], 0, 0)
    for name in READERS:
        assert read(name, {"window": None, "device": [], "requests": 0, "counters": {}}) is None
    assert read("keccak.roofline.mldsa", rec) is None
    assert read("mldsa.slot_iterations_per_signature", {"counters": {"signatures": 0}}) is None
    assert {"expand_mask_kernel", "sample_in_ball_kernel", "rej_ntt_poly_kernel",
            "mu_rho_kernel"} <= set(mldsa_stream.kernels_of(ROOT, "keccak.cu"))
    assert "dyadic_inner_banks_kernel" in mldsa_stream.kernels_of(ROOT, "dyadic_inner.cu")
    assert trace.port_filter(("expand_mask_kernel",))("check_kernel") is False
