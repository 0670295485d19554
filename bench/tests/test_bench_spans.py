"""CPU tests of the span readers (``benchlib/spans.py``) on hand-built
records with known answers, and of the tiny twin cells' traced runs,
which report the serve and plan layers' host time from the program's
own spans."""
import pytest

from benchlib import cli, spans, spec
from conftest import ROOT

US = 1_000          # ns


def drain_records():
    """One group's life in 1 ms of window (times in us, as ns): a drain
    with a dispatch (the plan's argument step, then its program, a
    collection inside it), the wait and the delivery; three device
    operations; 100 us at the end under no span."""
    return {
        "window": (0, 1000 * US),
        "spans": [("serve.run", 0, 900 * US), ("serve.dispatch", 100 * US, 500 * US),
                  ("plan.args", 120 * US, 200 * US), ("plan.program", 200 * US, 400 * US),
                  ("host.gc", 250 * US, 300 * US), ("serve.block", 500 * US, 700 * US),
                  ("serve.deliver", 700 * US, 750 * US)],
        "device": [("k1", 150 * US, 260 * US), ("k2", 320 * US, 480 * US),
                   ("k3", 600 * US, 800 * US)],
        "requests": 2,
    }


def read(name, rec):
    return spec.reader(name, ROOT)(rec)


def test_innermost_segments_and_self_time():
    rec = drain_records()
    seg = [(s // US, e // US, n) for s, e, n in spans.innermost(rec)]
    assert seg == [(0, 100, "serve.run"), (100, 120, "serve.dispatch"),
                   (120, 200, "plan.args"), (200, 250, "plan.program"),
                   (250, 300, "host.gc"), (300, 400, "plan.program"),
                   (400, 500, "serve.dispatch"), (500, 700, "serve.block"),
                   (700, 750, "serve.deliver"), (750, 900, "serve.run")]
    assert spans.self_ns(rec, lambda n: n == "plan.program") == 150 * US   # 200 less the collection
    assert spans.self_ns(rec, lambda n: n == "host.gc") == 50 * US
    # the self times partition the union of the spans
    assert spans.self_ns(rec, lambda n: True) == 900 * US


def test_an_outer_span_starting_with_its_child_holds_only_the_rest():
    rec = {"window": (0, 20), "spans": [("b", 0, 5), ("a", 0, 10)]}
    assert spans.innermost(rec) == [(0, 5, "b"), (5, 10, "a")]


def test_spans_are_clipped_to_the_window():
    rec = {"window": (10, 20), "spans": [("serve.run", 0, 30), ("plan.args", 15, 40)]}
    assert spans.innermost(rec) == [(10, 15, "serve.run"), (15, 20, "plan.args")]


def test_host_time_per_request():
    rec = drain_records()
    for cell in ("keyswitch", "matvec"):
        # serve.run 250 + serve.dispatch 120 + serve.deliver 50, over 2
        assert read(f"serve.host_us_per_request.{cell}", rec) == pytest.approx(210.0)
        # plan.args 80 + plan.program 150, over 2
        assert read(f"plan.host_us_per_request.{cell}", rec) == pytest.approx(115.0)
    assert read("serve.wait_us_per_request.keyswitch", rec) == pytest.approx(100.0)


def test_idle_is_split_by_overlap():
    """The gap 0-150 falls under three spans, 260-320 under the collection
    and the program, 480-600 under the dispatch and the wait, 800-1000
    half under serve.run and half under no span."""
    rec = drain_records()
    assert spans.idle_gaps(rec) == [(0, 150 * US), (260 * US, 320 * US),
                                    (480 * US, 600 * US), (800 * US, 1000 * US)]
    assert read("serve.idle_pct.keyswitch", rec) == pytest.approx(34.0)   # 200 + 40 + 100
    assert read("plan.idle_pct.keyswitch", rec) == pytest.approx(5.0)     # 30 + 20
    assert spans.idle_ns(rec, lambda n: n == "host.gc") == 40 * US
    device = read("device.idle_pct.keyswitch", rec)
    assert device == pytest.approx(53.0)            # 34 + 5 + 4 (gc) + 10 (no span)
    assert read("serve.idle_pct.keyswitch", rec) + read("plan.idle_pct.keyswitch", rec) <= device


def test_readers_need_their_spans():
    rec = drain_records()
    rec["spans"] = [sp for sp in rec["spans"] if not sp[0].startswith("plan.")]
    assert read("plan.host_us_per_request.keyswitch", rec) is None
    assert read("plan.idle_pct.keyswitch", rec) is None
    assert read("serve.host_us_per_request.keyswitch", rec) is not None
    assert read("serve.idle_pct.keyswitch", dict(rec, device=[])) is None
    assert read("serve.host_us_per_request.keyswitch", dict(rec, requests=0)) is None


@pytest.mark.parametrize("cell", ["tiny-keyswitch", "tiny-matvec"])
def test_the_tiny_traced_runs_report_host_time(tiny_checkout, cell):
    """On the CPU (no device trace) a traced run of each tiny twin reports
    the serve and plan layers' host time, and no idle share."""
    c = spec.load(cell, tiny_checkout)
    r = cli.run_cell(c, 2**33 + 5, 0.5, True, "cpu", 0.0)
    assert r["correct"]
    like = cell.replace("tiny-", "")
    for layer in ("serve", "plan"):
        assert r["metrics"][f"{layer}.host_us_per_request.{like}"]["value"] > 0
    if like == "keyswitch":
        assert r["metrics"]["serve.wait_us_per_request.keyswitch"]["value"] >= 0
    assert not any("idle_pct" in name for name in r["metrics"])
