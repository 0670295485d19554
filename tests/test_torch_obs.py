"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``): the same API, span semantics (per-thread
nesting, exception safety, the bounded buffer, the shared no-op span when
disabled), histogram bucket rules, and the same Chrome trace-event and
metrics-snapshot formats for the same calls; the profiler forwarding; and
the port's serve ``stats`` contract with instrumentation on (both drains,
every phase span, the mirrored counters)."""
import json
import threading

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.obs import trace as ref_trace

from repro_torch import obs as port_obs
from repro_torch.obs import trace as port_trace

torch.set_num_threads(2)

OBS = {"reference": (ref_obs, ref_trace), "port": (port_obs, port_trace)}


def _reset():
    for obs, _ in OBS.values():
        obs.disable()
        obs.clear()
        obs.reset()


@pytest.fixture(autouse=True)
def _obs_clean():
    _reset()
    yield
    _reset()


@pytest.fixture(params=list(OBS))
def which(request):
    return OBS[request.param]


def test_api_matches_reference():
    assert sorted(port_obs.__all__) == sorted(ref_obs.__all__)
    for name in ref_obs.__all__:
        assert hasattr(port_obs, name), name


def test_disabled_span_is_shared_noop_singleton(which):
    obs, _ = which
    s1, s2 = obs.span("a", kind="x"), obs.span("b")
    assert s1 is s2 is obs.NOOP_SPAN
    with s1:
        pass
    assert obs.events() == []


def test_disabled_metrics_record_nothing(which):
    obs, _ = which
    obs.counter_add("c", 5)
    obs.gauge_set("g", 1.0)
    obs.observe("h", 2.0)
    assert obs.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_span_nesting_depth_and_order(which):
    obs, _ = which
    obs.enable()
    with obs.span("outer"):
        with obs.span("mid"):
            with obs.span("inner"):
                pass
    evs = obs.events()
    assert [e["name"] for e in evs] == ["inner", "mid", "outer"]
    assert [e["depth"] for e in evs] == [2, 1, 0]


def test_span_exception_safety(which):
    obs, _ = which
    obs.enable()
    with pytest.raises(ValueError, match="boom"):
        with obs.span("failing", kind="dispatch"):
            raise ValueError("boom")
    (ev,) = obs.events()
    assert ev["name"] == "failing" and ev["dur_us"] >= 0.0
    assert ev["args"] == {"kind": "dispatch", "error": "ValueError"}
    with obs.span("after"):
        pass
    assert obs.events()[-1]["depth"] == 0


def test_span_thread_safety(which):
    obs, _ = which
    obs.enable()
    n_threads, n_spans = 8, 50
    barrier = threading.Barrier(n_threads)

    def work(tid):
        barrier.wait()
        for _ in range(n_spans):
            with obs.span("t", tid=tid):
                with obs.span("t.in", tid=tid):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    evs = obs.events()
    assert len(evs) == n_threads * n_spans * 2
    assert all(e["depth"] == (1 if e["name"] == "t.in" else 0) for e in evs)


def test_event_buffer_is_bounded(which):
    obs, trace = which
    obs.enable()
    old_max, old_events = trace.MAX_EVENTS, trace._EVENTS
    trace.MAX_EVENTS, trace._EVENTS = 16, type(old_events)(maxlen=16)
    try:
        for i in range(40):
            with obs.span(f"s{i}"):
                pass
        assert len(obs.events()) == 16 and obs.dropped() == 24
        assert obs.events()[0]["name"] == "s24"
    finally:
        trace.MAX_EVENTS, trace._EVENTS = old_max, old_events


@pytest.mark.parametrize("v", [4.0, 4.0001, 1.0, 0.75, 0.5, 0.0, -3.0, 1023.9, 3e-7, 1e12])
def test_histogram_bucket_boundaries_match_reference(v):
    assert port_obs.bucket_le(v) == ref_obs.bucket_le(v)


def test_histogram_stats_and_quantile(which):
    obs, _ = which
    obs.enable()
    for v in (1.0, 2.0, 3.0, 100.0):
        obs.observe("lat", v)
    h = obs.snapshot()["histograms"]["lat"]
    assert (h["count"], h["min"], h["max"]) == (4, 1.0, 100.0)
    assert h["mean"] == pytest.approx(26.5)
    assert h["buckets"] == {"1.0": 1, "2.0": 1, "4.0": 1, "128.0": 1}
    assert obs.histogram_quantile("lat", 0.5) == 2.0
    assert obs.histogram_quantile("lat", 1.0) == 128.0
    assert obs.histogram_quantile("absent", 0.5) is None


def test_gauges_and_counters(which):
    obs, _ = which
    obs.enable()
    for depth in (3, 1, 4, 1, 5):
        obs.gauge_set("queue", depth)
    obs.counter_add("c")
    obs.counter_add("c", 4)
    snap = obs.snapshot()
    g = snap["gauges"]["queue"]
    assert g["value"] == 5 and [v for _, v in g["samples"]] == [3, 1, 4, 1, 5]
    ts = [t for t, _ in g["samples"]]
    assert ts == sorted(ts) and snap["counters"]["c"] == 5


def _session(obs):
    """The same calls on either package: nested spans, an exception, a
    counter, a gauge and a histogram."""
    obs.enable()
    with obs.span("parent", kind="dispatch", n=3):
        with obs.span("child"):
            pass
    with pytest.raises(KeyError):
        with obs.span("fails"):
            raise KeyError("x")
    obs.counter_add("n", 2)
    obs.gauge_set("depth", 7)
    for v in (0.5, 3.0, 3.0, 900.0):
        obs.observe("lat", v)
    return obs.chrome_trace(), obs.snapshot()


def test_chrome_trace_and_snapshot_formats_match_reference():
    (rt, rs), (pt, ps) = _session(ref_obs), _session(port_obs)
    json.loads(json.dumps(pt))                   # the Perfetto round trip
    assert set(pt) == set(rt) and pt["displayTimeUnit"] == rt["displayTimeUnit"]
    assert set(pt["otherData"]) == set(rt["otherData"])
    assert pt["otherData"]["dropped_events"] == rt["otherData"]["dropped_events"] == 0
    assert len(pt["traceEvents"]) == len(rt["traceEvents"]) == 3
    for r, p in zip(rt["traceEvents"], pt["traceEvents"]):
        assert set(p) == set(r) and p["ph"] == r["ph"] == "X"
        assert (p["name"], p["args"]) == (r["name"], r["args"])
        assert p["dur"] >= 0.0 and isinstance(p["ts"], float)
    child, parent = pt["traceEvents"][0], pt["traceEvents"][1]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-6
    assert child["args"]["depth"] == 1 and parent["args"]["kind"] == "dispatch"
    # the snapshot: the same counters, gauge values and histogram buckets;
    # span histograms (<name>.us) hold host times, so only their counts
    assert set(ps) == set(rs) and ps["counters"] == rs["counters"]
    assert {k: g["value"] for k, g in ps["gauges"].items()} == \
        {k: g["value"] for k, g in rs["gauges"].items()}
    assert set(ps["histograms"]) == set(rs["histograms"])
    for name, h in rs["histograms"].items():
        assert set(ps["histograms"][name]) == set(h)
        assert ps["histograms"][name]["count"] == h["count"], name
    assert ps["histograms"]["lat"] == rs["histograms"]["lat"]


def test_write_trace_and_metrics(tmp_path):
    port_obs.enable()
    with port_obs.span("x"):
        pass
    port_obs.counter_add("n", 2)
    tp, mp = tmp_path / "t.json", tmp_path / "m.json"
    port_obs.write_trace(str(tp))
    port_obs.write_metrics(str(mp))
    assert json.loads(tp.read_text())["traceEvents"][0]["name"] == "x"
    assert json.loads(mp.read_text())["counters"]["n"] == 2


def test_spans_forward_to_the_profiler():
    """``enable(forward_to_profiler=True)`` enters each span as a
    torch.profiler range, so a profile of the run shows the host spans;
    without it, none."""
    from torch.profiler import ProfilerActivity, profile
    for forward in (True, False):
        port_obs.enable(forward_to_profiler=forward)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with port_obs.span("serve.forwarded"):
                torch.ones(4).sum()
        names = {e.name for e in prof.events()}
        assert ("serve.forwarded" in names) == forward
    port_obs.disable()
    assert not port_trace._FORWARD


def test_ops_spans_name_the_banks_entry_points():
    from repro_torch.fhe import rns
    from repro_torch.kernels import ops
    n = 16
    t = rns.basis_pack(tuple(rns.make_primes(n, 2)), n, "cpu")
    x = torch.zeros((2, 3, n), dtype=torch.int32)
    port_obs.enable()
    ops.intt_banks(ops.ntt_banks(x, t), t)
    assert [e["name"] for e in port_obs.events()] == ["ops.ntt_banks", "ops.intt_banks"]
    assert {e["cat"] for e in port_obs.events()} == {"kernel"}


# ------------------------------------------- serve-stats compatibility

SERVE_STAT_KEYS = {
    "mode", "dispatches", "batched_ops", "padded", "identity", "failed",
    "groups", "devices", "per_device_rows", "program_dispatches",
    "key_switches", "decomposes", "hoisted_reuse", "fresh_traces",
    "wall_s", "latency_us",
}


def _ctx():
    from repro_torch.fhe.ckks import CkksContext
    return CkksContext(n=256, levels=2, scale_bits=26, seed=71, device="cpu")


def _same(a, b):
    return (torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data)
            and a.scale == b.scale)


def test_serve_stats_contract_with_obs_enabled():
    from repro_torch.fhe.serve import CkksServeEngine, synthetic_trace
    ctx = _ctx()
    reqs, _ = synthetic_trace(ctx, 12, seed=5)
    engine = CkksServeEngine(ctx.plan(), batch_tile=2)
    baseline = engine.run(list(reqs))
    base = dict(engine.stats)
    port_obs.enable()
    out_sync = engine.run(list(reqs))
    sync_stats = dict(engine.stats)
    out_async = engine.run_async(list(reqs))
    async_stats = dict(engine.stats)
    port_obs.disable()
    for stats in (sync_stats, async_stats):
        assert SERVE_STAT_KEYS <= set(stats)
        lat = stats["latency_us"]
        assert set(lat) == {"p50", "p99", "mean", "max", "count"}
        assert lat["count"] == len(reqs) and 0 < lat["p50"] <= lat["p99"] <= lat["max"]
    assert "max_queue" in async_stats
    for key in ("mode", "dispatches", "batched_ops", "padded", "identity",
                "program_dispatches", "key_switches", "decomposes", "hoisted_reuse",
                "groups"):
        assert sync_stats[key] == base[key], key
    for rid, ct in baseline.items():
        assert _same(ct, out_sync[rid]) and _same(ct, out_async[rid])
    names = {e["name"] for e in port_obs.events()}
    for phase in ("serve.run", "serve.screen", "serve.group", "serve.dispatch",
                  "serve.block", "plan.stack", "plan.program"):
        assert phase in names, f"no span for {phase}"
    snap = port_obs.snapshot()
    counters = snap["counters"]
    assert counters["serve.batched_ops"] == sync_stats["batched_ops"] + async_stats["batched_ops"]
    assert counters["serve.drains"] == 2
    assert counters["plan.dispatches"] == (sync_stats["program_dispatches"]
                                           + async_stats["program_dispatches"])
    hists = snap["histograms"]
    assert hists["serve.dispatch.us"]["count"] >= 2
    assert "serve.lifecycle.drained_us" in hists and "serve.lifecycle.admitted_us" in hists
    assert len(snap["gauges"]["serve.queue_depth"]["samples"]) >= 1


def test_zero_request_drains_report_empty_latency():
    from repro_torch.fhe.serve import CkksServeEngine
    engine = CkksServeEngine(_ctx().plan(), batch_tile=2)
    assert engine.run([]) == {} and engine.stats["latency_us"] == {}
    assert engine.run_async([]) == {} and engine.stats["latency_us"] == {}


def test_sync_latency_counts_failures_and_identity():
    from repro_torch.fhe.serve import CkksServeEngine, FheRequest
    ctx = _ctx()
    plan = ctx.plan()
    ct = ctx.encrypt(ctx.encode(np.full(ctx.slots, 0.5)))
    low = plan.rescale(plan.rescale(ct))
    engine = CkksServeEngine(plan, batch_tile=2)
    out = engine.run([FheRequest(0, "rotate", ct, r=1), FheRequest(1, "rotate", ct, r=0),
                      FheRequest(2, "rescale", low)])
    assert set(out) == {0, 1} and engine.stats["identity"] == 1
    assert list(engine.stats["failed"]) == [2] and engine.stats["latency_us"]["count"] == 3
