"""The port's dry run (``launch/dryrun.py``, ``launch/dryrun_fhe.py``)
against the reference's own dry-run records.

The reference's side runs once, in one ``tests/subproc.run_multidevice``
subprocess on 512 simulated host devices: ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 devices when it is imported, so no pytest worker
imports it, and the script calls ``jax.devices()`` (the prelude's
``require_devices``) before it does.  The script replaces the module's
``make_mesh_ctx`` with one that builds the same mesh with Auto axes:
under JAX 0.9 ``jax.make_mesh`` makes Explicit axes, on which the LM
cells' ``with_sharding_constraint`` raises ("can only refer to Auto axes
of the mesh"); the FHE cells build their own mesh and run unpatched.
Nothing of the reference changes.  The port's records are counted in a
thread while the subprocess runs.

Exact equality on every cell: the parameter counts, the argument,
output and alias bytes per device, ``model_flops``, and the FHE cells'
collective counts, bytes and traffic.  The record keys equal the
reference's, but for the renamed ones (``lower_s``/``compile_s`` ->
``count_s``, ``fits_16gib_hbm`` -> ``fits_80gb_hbm``) and the port's
``method``, ``kernels`` and ``unread`` (the arguments left out).  Temp bytes, FLOPs and bytes are the port's
own counts (its eager ops, not XLA's fusions) and are not compared."""
import concurrent.futures
import json
import os

import pytest

from repro_torch.launch import dryrun

from subproc import run_multidevice

FHE_CELLS = [("sce-ntt", s, m) for m in ("pod1", "pod2")
             for s in ("ntt_batch", "fourstep_16k", "keyswitch_16k")]
LM_CELLS = [("smollm-135m", "train_4k", "pod1"), ("smollm-135m", "decode_32k", "pod1"),
            ("qwen3-moe-30b-a3b", "decode_32k", "pod1")]
CELLS = FHE_CELLS + LM_CELLS
IDS = ["-".join(c) for c in CELLS]

REFERENCE = """
import json
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as D
from repro.launch import dryrun_fhe
from repro.models.common import MeshCtx


def make_mesh_ctx(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(shape))
    dp = ("pod", "data") if multi_pod else ("data",)
    return MeshCtx(mesh=mesh, dp=dp, fsdp="data", tp="model", sp="model")


D.make_mesh_ctx = make_mesh_ctx
out = {}
for arch, shape, mesh in CELLS:
    out["-".join((arch, shape, mesh))] = (
        dryrun_fhe.run_cell(shape, mesh) if arch == "sce-ntt"
        else D.run_cell(arch, shape, mesh, "/dev/null"))
print("RECORDS" + json.dumps(out))
print("OK")
"""

RENAMED = {"lower_s": "count_s", "compile_s": "count_s",
           "fits_16gib_hbm": "fits_80gb_hbm"}
ADDED = {"method", "kernels", "unread"}


@pytest.fixture(scope="module")
def records():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(lambda: {"-".join(c): dryrun.run_cell(*c) for c in CELLS})
        r = run_multidevice(f"CELLS = {CELLS!r}\n" + REFERENCE, token="OK",
                            devices=512, timeout=240)
        ref = json.loads(r.stdout.split("RECORDS", 1)[1].splitlines()[0])
        return ref, port.result()


@pytest.mark.parametrize("cell", IDS)
def test_memory_bytes_equal(records, cell):
    ref, port = records
    for key in ("argument_bytes_per_device", "output_bytes_per_device",
                "alias_bytes_per_device"):
        assert port[cell]["memory"][key] == ref[cell]["memory"][key], key


@pytest.mark.parametrize("cell", IDS)
def test_params_and_model_flops_equal(records, cell):
    ref, port = records
    for key in ("params_total", "params_active"):
        assert port[cell].get(key) == ref[cell].get(key), key
    assert port[cell]["roofline"]["model_flops"] == ref[cell]["roofline"]["model_flops"]


@pytest.mark.parametrize("cell", ["-".join(c) for c in FHE_CELLS])
def test_fhe_collectives_equal(records, cell):
    ref, port = records
    for key in ("collective_counts", "collective_bytes_by_op",
                "collective_traffic_bytes"):
        assert port[cell]["roofline"][key] == ref[cell]["roofline"][key], key


@pytest.mark.parametrize("cell", IDS)
def test_record_keys_equal(records, cell):
    ref, port = records

    def keys(rec):
        out = set()
        for k, v in rec.items():
            out.add(RENAMED.get(k, k))
            if isinstance(v, dict) and k in ("memory", "roofline"):
                out |= {f"{k}.{RENAMED.get(kk, kk)}" for kk in v}
        return out
    assert keys(port[cell]) - ADDED == keys(ref[cell])


def test_smollm_decode_figures():
    """The smollm-135m decode_32k pod1 figures of the reference's record,
    held directly (the reference's run gives the same, above)."""
    rec = dryrun.run_cell("smollm-135m", "decode_32k", "pod1")
    assert rec["params_total"] == rec["params_active"] == 134_515_008
    assert rec["memory"]["argument_bytes_per_device"] == 385_949_988
    assert rec["memory"]["output_bytes_per_device"] == 379_060_260
    assert rec["memory"]["alias_bytes_per_device"] == 377_487_364
    assert rec["roofline"]["model_flops"] == 134_515_008
    assert rec["memory"]["fits_80gb_hbm"]


@pytest.fixture
def smoke_cli(monkeypatch):
    """--all over a smoke subset: smollm-135m at decode_32k and
    long_500k, and the ntt_batch FHE cell."""
    shapes = {s: dryrun.SHAPES[s] for s in ("decode_32k", "long_500k")}
    monkeypatch.setattr(dryrun, "ARCHS", ["smollm-135m"])
    monkeypatch.setattr(dryrun, "SHAPES", shapes)
    monkeypatch.setattr(dryrun, "FHE_SHAPES", ("ntt_batch",))


def test_cli_all_writes_then_skips(smoke_cli, tmp_path, capsys):
    dryrun.main(["--all", "--mesh", "pod1", "--out", str(tmp_path)])
    files = sorted(os.listdir(tmp_path))
    assert files == ["sce-ntt__ntt_batch__pod1.json", "smollm-135m__decode_32k__pod1.json",
                     "smollm-135m__long_500k__pod1.json"]
    with open(tmp_path / "smollm-135m__long_500k__pod1.json") as f:
        assert "full-attention" in json.load(f)["skipped"]
    first = capsys.readouterr().out
    assert first.count("[ok]") == 3 and "all requested cells passed" in first
    dryrun.main(["--all", "--mesh", "pod1", "--out", str(tmp_path)])
    again = capsys.readouterr().out
    assert again.count("[skip-existing]") == 3 and "[ok]" not in again

    dryrun.main(["--report", "--out", str(tmp_path)])
    rep = capsys.readouterr().out
    assert "### Dry-run table" in rep and "### Roofline table" in rep
    assert "| smollm-135m | long_500k | pod1 | — |" in rep
    assert "| sce-ntt | ntt_batch | pod1 |" in rep


def test_cli_failed_cell_exits_nonzero(smoke_cli, tmp_path, monkeypatch):
    def run_cell(arch, shape, mesh):
        if shape == "long_500k":
            raise RuntimeError("a failing cell")
        return {"arch": arch, "shape": shape, "mesh": mesh}
    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    with pytest.raises(RuntimeError, match="a failing cell"):
        dryrun.main(["--all", "--mesh", "pod1", "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == ["smollm-135m__decode_32k__pod1.json"]
