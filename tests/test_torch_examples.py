"""The six example twins (``examples/*_torch.py``) on the CPU: each runs
its ``main`` in process with ``--device cpu`` at the reference
example's sizes (``train_smollm_torch`` with ``--smoke`` and 30 steps:
a CPU step at full width takes seconds) and its printed report holds
the reference example's checks: the SRM simulator's match and the CKKS
error (and the NTT-128 and product words equal to the reference's
``core.ntt`` on the same input), 6 requests of 8 tokens, a falling
loss, both encrypted heads within 1e-2 of the cleartext, the drains
bit-exact with no fresh trace and no failure, the four-step round trip
and every shard count bit-exact against the unsharded plan.  Without
``--device`` each refuses to run where there is no card."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.modmath import mulmod_np
from repro.core.ntt import intt_negacyclic, ntt_cyclic, ntt_negacyclic
from repro.core.params import make_ntt_params

torch.set_num_threads(2)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart", "serve_demo", "train_smollm", "private_inference",
         "fhe_serve_demo", "distributed_ntt")


def load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    got = load("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "match=True" in out and "latency=1036 cycles" in out
    assert got["match"] and got["ckks_err"] < 1e-3
    rng = np.random.default_rng(0)
    p = make_ntt_params(128)
    poly = rng.integers(0, p.q, 128, dtype=np.uint32)
    assert np.array_equal(got["ntt"], np.asarray(ntt_cyclic(jnp.asarray(poly), p)))
    a = rng.integers(0, p.q, 128, dtype=np.uint32)
    b = rng.integers(0, p.q, 128, dtype=np.uint32)
    C = mulmod_np(np.asarray(ntt_negacyclic(jnp.asarray(a), p)),
                  np.asarray(ntt_negacyclic(jnp.asarray(b), p)), p.q)
    assert np.array_equal(got["product"], np.asarray(intt_negacyclic(jnp.asarray(C), p)))


def test_serve_demo(capsys):
    got = load("serve_demo").main(["--device", "cpu"])
    assert sorted(got) == list(range(6)) and all(len(v) == 8 for v in got.values())
    assert "[ok] 6 requests served in 2 waves of batch 4" in capsys.readouterr().out


def test_train_smollm(tmp_path, capsys):
    losses = load("train_smollm").main(["--device", "cpu", "--smoke", "--steps", "30",
                                        "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert "[done] loss" in capsys.readouterr().out


def test_private_inference(capsys):
    errs = load("private_inference").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert errs["naive"] < 1e-2 and errs["hoisted"] < 1e-2
    assert out.count("(OK)") == 2 and "FAIL" not in out


def test_fhe_serve_demo(capsys):
    got = load("fhe_serve_demo").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert got["exact"] and "bit-exact (async == sync == single-op): OK" in out
    assert got["err"] < 1e-2 and got["fresh_traces"] == 0 and got["failed"] == 0
    assert got["latency"]["count"] == 32


def test_distributed_ntt(capsys):
    got = load("distributed_ntt").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert got["roundtrip"] and "roundtrip MATCH" in out
    assert [d for d, _, ok in got["table"] if ok] == [1, 2, 4, 8]
    assert "take turns" in out


@pytest.mark.parametrize("name", TWINS)
def test_twin_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(name).main([])
