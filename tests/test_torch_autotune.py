"""The port's tile funnel (``repro_torch.kernels.autotune``) against the
reference's (``repro.kernels.autotune``): every case of
tests/test_autotune.py that applies to the port runs on both packages
with the same inputs, env and cache files, and must resolve the same
tiles with the same ``autotune.*`` counter deltas.  The port's own
contract: with ``SCE_NTT_AUTOTUNE=1`` it measures once and then hits its
cache (the reference's jit guard never lets it measure), a CUDA graph
capture blocks a measurement, ``serve_batch`` is measured for real on
the CPU, a fault of the card in a runner raises, and each package reads
the other's sidecar."""
import json

import jax
import pytest
import torch

from repro import obs as ref_obs
from repro.fhe import serve as ref_serve
from repro.fhe.ckks import CkksContext as RefContext
from repro.kernels import autotune as ref_at

from repro_torch import kernels as K
from repro_torch import obs as port_obs
from repro_torch.fhe import serve
from repro_torch.fhe.ckks import CkksContext
from repro_torch.fhe.evalplan import EvalPlan
from repro_torch.kernels import autotune as port_at
from repro_torch.mesh import make_mesh

torch.set_num_threads(2)

BE = jax.default_backend()
# package -> (autotune module, obs package, the port's device argument)
PKGS = {"reference": (ref_at, ref_obs, {}), "port": (port_at, port_obs, {"device": "cpu"})}


def _reset_all(monkeypatch):
    for at, obs, _ in PKGS.values():
        for env in (at.ENV_PIN, at.ENV_CACHE, at.ENV_AUTOTUNE):
            monkeypatch.delenv(env, raising=False)
        at.clear()
        obs.disable()
        obs.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    _reset_all(monkeypatch)
    yield
    _reset_all(monkeypatch)


def _counters(obs) -> dict:
    return {k: v for k, v in obs.snapshot()["counters"].items() if k.startswith("autotune.")}


def both(case):
    """``case(at, kw)`` on the reference and then the port, each with its
    obs on: the two results and ``autotune.*`` counter deltas must be
    equal.  Returns the port's (result, counters)."""
    out = {}
    for name, (at, obs, kw) in PKGS.items():
        obs.enable()
        obs.reset()
        result = case(at, kw)
        out[name] = (result, _counters(obs))
        obs.disable()
        obs.reset()
    assert out["port"] == out["reference"]
    return out["port"]


def _key(family, k, n, b, dtype="uint32"):
    return (BE, family, k, n, b, dtype)


def test_backends_name_the_cpu_alike():
    assert port_at._backend("cpu") == BE == "cpu"
    assert port_at._key("ntt", 1, 256, 8, device="cpu") == _key("ntt", 1, 256, 8)


def test_clamp_rule():
    both(lambda at, kw: [at.clamp(8, 1), at.clamp(8, 5), at.clamp(8, 100), at.clamp(0, 4),
                         at.clamp(8, 0), at.clamp(8, -3)])


def test_resolve_precedence():
    _, counters = both(lambda at, kw: [
        at.resolve_tile("ntt", 1, 256, 100, **kw), at.resolve_tile("ntt", 1, 256, 3, **kw),
        at.resolve_tile("ntt", 1, 256, 5, tile=32, **kw),
        at.resolve_tile("ntt", 1, 256, 100, tile=16, **kw)])
    assert counters == {"autotune.resolve.cache_miss": 2, "autotune.resolve.default": 2,
                        "autotune.resolve.explicit": 2}


def test_env_pin(monkeypatch):
    def case(at, kw):
        monkeypatch.setenv(at.ENV_PIN, "4")
        out = [at.resolve_tile("ntt", 1, 256, 100, **kw), at.resolve_tile("ntt", 1, 256, 2, **kw),
               at.resolve_tile("ntt", 1, 256, 100, tile=16, **kw)]
        for pin in ("banana", " 2 ", "+3", "-1", "1_0", "1__0", "²"):
            monkeypatch.setenv(at.ENV_PIN, pin)
            out.append(at.resolve_tile("ntt", 1, 256, 100, **kw))
        return out
    result, _ = both(case)
    assert result == [4, 2, 16, 8, 2, 3, 1, 10, 8, 8]


def test_cache_hit_beats_default(monkeypatch):
    def case(at, kw):
        monkeypatch.setitem(at._MEM, _key("ntt", 1, 256, 100), 16)
        out = [at.resolve_tile("ntt", 1, 256, 100, **kw)]
        monkeypatch.setenv(at.ENV_PIN, "2")
        out.append(at.resolve_tile("ntt", 1, 256, 100, **kw))
        monkeypatch.delenv(at.ENV_PIN)
        return out
    assert both(case)[0] == [16, 2]


def test_no_measurement_without_flag(monkeypatch):
    def case(at, kw):
        monkeypatch.setattr(at, "measure", _boom("measure() ran without the flag"))
        return [at.resolve_tile(fam, 2, 256, 100, **kw) for fam in ("ntt_banks", "serve_batch")]
    assert both(case)[0] == [8, 8]


def _boom(msg):
    def call(*a, **kw):
        raise AssertionError(msg)
    return call


def test_no_measurement_inside_a_capture(monkeypatch):
    """With the flag on, a resolve inside the reference's jit trace and one
    inside the port's CUDA graph capture (the guard reads a capturing
    stream, monkeypatched here: there is no card) take the default, with
    the same counters."""
    monkeypatch.setenv(port_at.ENV_AUTOTUNE, "1")

    def case(at, kw):
        monkeypatch.setattr(at, "measure", _boom("measure() ran inside a capture"))
        if at is ref_at:
            @jax.jit
            def prog(x):
                return x * at.resolve_tile("serve_batch", 2, 256, 100)
            return int(prog(jax.numpy.ones((2,), jax.numpy.uint32))[0])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        return at.resolve_tile("serve_batch", 2, 256, 100, **kw)
    result, counters = both(case)
    assert result == port_at.DEFAULT_TILE
    assert counters == {"autotune.resolve.cache_miss": 1, "autotune.resolve.default": 1}


def test_capture_guard_also_holds_for_ensure(monkeypatch):
    monkeypatch.setattr(port_at, "measure", _boom("ensure() measured inside a capture"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert port_at.ensure("serve_batch", 2, 256, 32, device="cpu") == port_at.DEFAULT_TILE
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(port_at, "measure", lambda *a, **kw: 16)
    assert port_at.ensure("serve_batch", 2, 256, 32, device="cpu") == 16


def _fake_clock(monkeypatch, seconds: dict):
    """A runner whose call at tile t advances a fake clock by seconds[t]
    (what the tuner's perf_counter reads), recording the tiles it ran."""
    clock, calls = [0.0], []

    def runner(k, n, b, device):
        def run(tile):
            calls.append(tile)
            clock[0] += seconds[tile]
        return run
    monkeypatch.setattr(port_at.time, "perf_counter", lambda: clock[0])
    return runner, calls


def test_measure_gated_flag_measures_once_then_hits_the_cache(monkeypatch):
    """The port's contract where the reference's guard fails (ROADMAP Queue
    3): with the flag on, outside a capture, the first resolve measures
    every candidate (a warm-up and 3 timed passes each) and caches the
    argmin; the second is a cache hit that runs nothing."""
    runner, calls = _fake_clock(monkeypatch, {1: 9.0, 2: 5.0, 4: 1.0, 8: 7.0})
    monkeypatch.setenv(port_at.ENV_AUTOTUNE, "1")
    monkeypatch.setitem(port_at._RUNNERS, "fake_fam", runner)
    port_obs.enable()
    assert port_at.resolve_tile("fake_fam", 1, 128, 8, device="cpu") == 4
    assert calls == [t for t in (1, 2, 4, 8) for _ in range(4)]
    ev = port_at.table()["evidence"][f"{BE}|fake_fam|1|128|8|uint32"]
    assert ev == {"chosen": 4, "source": "measured",
                  "candidates": {"1": 9.0, "2": 5.0, "4": 1.0, "8": 7.0}}
    calls.clear()
    monkeypatch.setattr(port_at, "measure", _boom("re-measured a cached entry"))
    assert port_at.resolve_tile("fake_fam", 1, 128, 8, device="cpu") == 4
    assert calls == []
    assert _counters(port_obs) == {"autotune.resolve.cache_miss": 1,
                                   "autotune.measurements": 1,
                                   "autotune.resolve.cache_hit": 1}
    gauges = port_obs.snapshot()["gauges"]
    assert gauges[f"autotune.chosen.{BE}|fake_fam|1|128|8|uint32"]["value"] == 4


def test_serve_batch_measured_for_real_on_the_cpu(monkeypatch):
    """The one runner end to end on the CPU: the banks forward transform
    over b rows as ceil(b / t) calls of t rows, every candidate timed;
    resolve and ensure reuse the entry, also per shard."""
    monkeypatch.setenv(port_at.ENV_AUTOTUNE, "1")
    K.reset_counts()
    got = port_at.measure("serve_batch", 2, 64, 4, reps=1, device="cpu")
    assert got in (1, 2, 4)
    ev = port_at.table()["evidence"][f"{BE}|serve_batch|2|64|4|uint32"]
    assert ev["source"] == "measured" and set(ev["candidates"]) == {"1", "2", "4"}
    # a warm-up and one timed pass per candidate: 4 + 2 + 1 calls, twice
    assert K.snapshot()["ntt_fwd_banks"]["plain_calls"] == 2 * (4 + 2 + 1)
    assert port_at.resolve_tile("serve_batch", 2, 64, 4, device="cpu") == got
    assert port_at.ensure("serve_batch", 2, 64, 8, shards=2, device="cpu") == got


def test_runner_failures(monkeypatch):
    """A runner that cannot be built records ``runner-error`` and the
    default; a candidate that fails is skipped; a fault of the card
    raises out of the measurement."""
    def unbuildable(k, n, b, device):
        raise ValueError("no workload")

    def odd_only(k, n, b, device):
        def run(tile):
            if tile % 2 == 0:
                raise ValueError("even tile")
        return run

    def faulty(k, n, b, device):
        def run(tile):
            raise K.LaunchError("launch failed: 700")
        return run
    for fam, fn in (("unbuildable", unbuildable), ("odd_only", odd_only), ("faulty", faulty)):
        monkeypatch.setitem(port_at._RUNNERS, fam, fn)
    assert port_at.measure("unbuildable", 1, 64, 8, device="cpu") == 8
    assert port_at.measure("odd_only", 1, 64, 8, reps=1, device="cpu") == 1
    ev = port_at.table()["evidence"]
    assert ev[f"{BE}|unbuildable|1|64|8|uint32"]["source"] == "runner-error"
    assert ev[f"{BE}|odd_only|1|64|8|uint32"]["source"] == "measured"
    assert set(ev[f"{BE}|odd_only|1|64|8|uint32"]["candidates"]) == {"1"}
    with pytest.raises(K.LaunchError):
        port_at.measure("faulty", 1, 64, 8, device="cpu")


def test_disk_cache_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "tiles.json"

    def case(at, kw):
        monkeypatch.setenv(at.ENV_CACHE, str(path))
        at._MEM[_key("ntt_banks", 3, 1024, 16)] = 16
        at._save_disk()
        entry = json.loads(path.read_text())["entries"][f"{BE}|ntt_banks|3|1024|16|uint32"]
        at.clear()
        at._DISK_LOADED = False
        return entry, at.resolve_tile("ntt_banks", 3, 1024, 16, **kw)
    assert both(case)[0] == (16, 16)


def test_disk_cache_corrupt_is_ignored(tmp_path, monkeypatch):
    path = tmp_path / "tiles.json"
    path.write_text("{ not json")

    def case(at, kw):
        monkeypatch.setenv(at.ENV_CACHE, str(path))
        at._DISK_LOADED = False
        return at.resolve_tile("ntt", 1, 256, 100, **kw)
    assert both(case)[0] == port_at.DEFAULT_TILE


def test_dump_and_table(tmp_path):
    def case(at, kw):
        at._MEM[_key("dyadic_mul", 1, 512, 8)] = 2
        out = tmp_path / f"snap_{at.__name__}.json"
        at.dump(str(out))
        t = at.table()
        return t["backend"], json.loads(out.read_text())["entries"][f"{BE}|dyadic_mul|1|512|8|uint32"]
    assert both(case)[0] == (BE, 2)


def test_shard_batch_rule():
    both(lambda at, kw: [at.shard_batch(32, 1), at.shard_batch(32, 4), at.shard_batch(33, 4),
                         at.shard_batch(2, 4), at.shard_batch(32), at.shard_batch(0, 4)])


def test_resolve_uses_per_shard_cache_entry(monkeypatch):
    k, n = 3, 1024

    def case(at, kw):
        monkeypatch.setitem(at._MEM, _key("serve_batch", k, n, 8), 16)
        monkeypatch.setitem(at._MEM, _key("serve_batch", k, n, 32), 2)
        return [at.resolve_tile("serve_batch", k, n, 32, **kw),
                at.resolve_tile("serve_batch", k, n, 32, shards=4, **kw),
                at.ensure("serve_batch", k, n, 32, shards=4, **kw),
                at.resolve_tile("serve_batch", k, n, 4, shards=4, **kw),
                at.resolve_tile("serve_batch", k, n, 32, tile=32, shards=4, **kw)]
    assert both(case)[0] == [2, 8, 8, 1, 8]


def test_serve_engine_resolves_per_shard_tile(monkeypatch):
    """Through each serve engine: the reference's plan with a faked
    4-device mesh, the port's over a real mesh of 4 CPU shards.  Both
    resolve the per-shard b = 8 entry and size groups to tile x devices."""
    def case(at, kw):
        if at is ref_at:
            plan = RefContext(n=64, levels=2, seed=3).plan()
            monkeypatch.setattr(type(plan), "mesh_devices", property(lambda self: 4))
            Engine = ref_serve.CkksServeEngine
        else:
            plan = EvalPlan(CkksContext(n=64, levels=2, seed=3, device="cpu"),
                            mesh=make_mesh(["cpu"] * 4))
            Engine = serve.CkksServeEngine
        k = len(plan.ctx.qs)
        monkeypatch.setitem(at._MEM, _key("serve_batch", k, plan.n, 8), 2)
        monkeypatch.setitem(at._MEM, _key("serve_batch", k, plan.n, 32), 8)
        eng = Engine(plan)
        return eng.devices, eng.batch_tile, eng.group_tile, eng.max_batch
    assert both(case)[0] == (4, 2, 8, 32)


def test_dtype_keys_do_not_collide(monkeypatch):
    def case(at, kw):
        monkeypatch.setitem(at._MEM, _key("ntt_banks", 1, 256, 64), 32)
        monkeypatch.setitem(at._MEM, _key("ntt_banks", 1, 256, 64, "uint16"), 4)
        out = [at.resolve_tile("ntt_banks", 1, 256, 64, **kw),
               at.resolve_tile("ntt_banks", 1, 256, 64, dtype="uint16", **kw)]
        at.clear()
        monkeypatch.setitem(at._MEM, _key("ntt_banks", 1, 256, 64, "uint16"), 4)
        return out + [at.resolve_tile("ntt_banks", 1, 256, 64, **kw)]
    assert both(case)[0] == [32, 4, 8]


def test_disk_cache_roundtrips_dtype(tmp_path, monkeypatch):
    path = tmp_path / "tiles.json"

    def case(at, kw):
        monkeypatch.setenv(at.ENV_CACHE, str(path))
        at._MEM[_key("ntt_banks", 1, 256, 64)] = 16
        at._MEM[_key("ntt_banks", 1, 256, 64, "uint16")] = 2
        at._save_disk()
        entries = json.loads(path.read_text())["entries"]
        at.clear()
        at._DISK_LOADED = False
        return (entries[f"{BE}|ntt_banks|1|256|64|uint32"], entries[f"{BE}|ntt_banks|1|256|64|uint16"],
                at.resolve_tile("ntt_banks", 1, 256, 64, **kw),
                at.resolve_tile("ntt_banks", 1, 256, 64, dtype="uint16", **kw))
    assert both(case)[0] == (16, 2, 16, 2)


def test_disk_cache_old_format_ignored_with_warning(tmp_path, monkeypatch):
    path = tmp_path / "tiles.json"
    path.write_text(json.dumps({"entries": {f"{BE}|ntt_banks|1|256|64": 32,
                                            f"{BE}|ntt_banks|1|256|64|uint16": 2}}))

    def case(at, kw):
        monkeypatch.setenv(at.ENV_CACHE, str(path))
        at.clear()
        at._DISK_LOADED = False
        with pytest.warns(UserWarning, match="old-format"):
            at._load_disk()
        return (at.resolve_tile("ntt_banks", 1, 256, 64, **kw),
                at.resolve_tile("ntt_banks", 1, 256, 64, dtype="uint16", **kw))
    assert both(case)[0] == (port_at.DEFAULT_TILE, 2)


def test_measure_non_u32_caches_default_without_timing(monkeypatch):
    def case(at, kw):
        for fam in ("ntt_banks", "serve_batch"):
            monkeypatch.setitem(at._RUNNERS, fam, _boom("u32 runner ran for a uint16 measure"))
        got = [at.measure(fam, 1, 256, 64, dtype="uint16", **kw) for fam in ("ntt_banks", "serve_batch")]
        return got + [at.resolve_tile("ntt_banks", 1, 256, 64, dtype="uint16", **kw),
                      at.table()["evidence"][f"{BE}|ntt_banks|1|256|64|uint16"]["source"]]
    assert both(case)[0] == [8, 8, 8, "default-nonu32"]


@pytest.mark.parametrize("writer,reader", [(ref_at, port_at), (port_at, ref_at)],
                         ids=["reference->port", "port->reference"])
def test_each_reads_the_others_sidecar(tmp_path, monkeypatch, writer, reader):
    """A sidecar with evidence written by one package seeds the other's
    cache: the same tile, the candidate table kept, marked ``disk``."""
    path = tmp_path / "tiles.json"
    monkeypatch.setenv(writer.ENV_CACHE, str(path))
    key = _key("serve_batch", 8, 1 << 14, 16)
    writer._MEM[key] = 16
    writer._EVIDENCE[key] = {"chosen": 16, "source": "measured",
                             "candidates": {8: 0.004, 16: 0.003, 32: 0.005}}
    writer._save_disk()
    reader.clear()
    reader._DISK_LOADED = False
    kw = {"device": "cpu"} if reader is port_at else {}
    assert reader.resolve_tile("serve_batch", 8, 1 << 14, 32, shards=2, **kw) == 16
    assert reader.table()["evidence"][f"{BE}|serve_batch|8|16384|16|uint32"] == {
        "chosen": 16, "source": "disk",
        "candidates": {"8": 0.004, "16": 0.003, "32": 0.005}}


def test_serve_engine_takes_a_tuned_tile(monkeypatch):
    """A measured (here: seeded) serve_batch entry of 16 per shard gives a
    2-shard engine groups of 32, and its answers equal a tile-8 unsharded
    drain's."""
    ctx = CkksContext(n=64, levels=2, seed=5, device="cpu")
    plan = EvalPlan(ctx, mesh=make_mesh(["cpu"] * 2))
    monkeypatch.setitem(port_at._MEM, _key("serve_batch", len(ctx.qs), 64, 16), 16)
    eng = serve.CkksServeEngine(plan)
    assert (eng.devices, eng.batch_tile, eng.group_tile, eng.max_batch) == (2, 16, 32, 128)
    reqs, _ = serve.synthetic_trace(ctx, 12, seed=6)
    want = serve.CkksServeEngine(ctx.plan(), batch_tile=8).run(reqs)
    got = eng.run_async(reqs)
    assert set(got) == set(want)
    for rid in want:
        assert torch.equal(got[rid].c0.data, want[rid].c0.data)
        assert torch.equal(got[rid].c1.data, want[rid].c1.data)
    assert eng.stats["per_device_rows"] == [16 * eng.stats["dispatches"]] * 2
