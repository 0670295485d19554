"""The port's LM serving engine and the private-inference composite
against the JAX reference on the CPU, with the reference's own weights
(``convert.params_from_reference``).

- ``ServeEngine.run`` returns exactly the reference engine's greedy
  tokens for the traffic of ``examples/serve_demo.py`` (qwen3-32b at
  smoke size, 6 requests of 12-17 tokens in waves of 4, max_len 96, 8
  new tokens each) and for smollm-135m at smoke size with unequal
  prompts and unequal ``max_new``, which pins the reference's quirks:
  right-padding with 0 and every row's first token read at S-1.
- The composite of ``examples/private_inference.py``: the port's
  smollm-135m gives the reference's last-position logits (float32,
  atol 1e-5); from the reference's x both packages encrypt, run the
  hoisted BSGS matvec on ``CkksContext(n=64, levels=3, scale_bits=28,
  seed=42)`` and get the same ciphertexts word for word, each within
  1e-2 of x @ W after decryption.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fhe import linalg as RLA
from repro.fhe.ckks import CkksContext as RefContext
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefServeEngine

from repro_torch.convert import tensor_to_u32
from repro_torch.fhe import linalg as TLA
from repro_torch.fhe.ckks import CkksContext as PortContext
from repro_torch.serve.engine import Request, ServeEngine, make_serve_fns

from test_torch_models import reference_pair

torch.set_num_threads(2)


def _ct_equal(r, p):
    """Residue stacks word for word, bases, NTT flags and scale equal."""
    return all(rp.primes == pp.primes and rp.is_ntt == pp.is_ntt
               and np.array_equal(np.asarray(rp.data), tensor_to_u32(pp.data))
               for rp, pp in ((r.c0, p.c0), (r.c1, p.c1))) and r.scale == p.scale


def serve_both(arch, lengths, max_new, batch_size, max_len, seed=0):
    rmodel, params, model = reference_pair(arch, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, model.cfg.vocab, n).astype(np.int32) for n in lengths]
    ref = RefServeEngine(rmodel, params, batch_size=batch_size, max_len=max_len).run(
        [RefRequest(rid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(zip(prompts, max_new))])
    engine = ServeEngine(model, batch_size=batch_size, max_len=max_len)
    got = engine.run([Request(rid=i, prompt=p, max_new=m)
                      for i, (p, m) in enumerate(zip(prompts, max_new))])
    return ref, got, engine


def test_serve_demo_traffic_equals_reference():
    ref, got, engine = serve_both("qwen3-32b", [12 + i for i in range(6)], [8] * 6,
                                  batch_size=4, max_len=96)
    assert got == ref
    assert all(len(v) == 8 for v in got.values())
    assert [(w["batch"], w["prompt_len"], w["steps"]) for w in engine.waves] == \
        [(4, 15, 8), (2, 17, 8)]


def test_unequal_prompts_pin_the_padding_quirk():
    """Rows shorter than the wave's longest prompt read their first token
    after the 0-padding, as the reference does; max_new differs per row."""
    lengths, max_new = [5, 23, 9, 31, 14], [3, 7, 1, 5, 6]
    ref, got, _ = serve_both("smollm-135m", lengths, max_new, batch_size=4, max_len=64)
    assert got == ref
    assert [len(got[i]) for i in range(5)] == max_new


def test_make_serve_fns_are_the_model_steps():
    _, _, model = reference_pair("smollm-135m")
    prefill, decode = make_serve_fns(model)
    toks = torch.arange(6).reshape(1, 6)
    logits, cache = prefill({"tokens": toks, "max_len": 8})
    want, wcache = model.prefill({"tokens": toks, "max_len": 8})
    assert torch.equal(logits, want) and cache["len"] == 6
    step, cache = decode(cache, {"tokens": torch.tensor([[1]])})
    assert cache["len"] == 7 and step.shape == logits.shape


@pytest.fixture(scope="module")
def head():
    """x from the smoke model's last-position logits, as
    ``examples/private_inference.py`` takes it, in both packages."""
    rmodel, params, model = reference_pair("smollm-135m")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (1, 16)).astype(np.int32)
    rlogits, _ = rmodel.forward(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, _ = model({"tokens": torch.from_numpy(toks)})
    hidden_dim, k = 16, 4
    rx = np.asarray(rlogits[0, -1, :hidden_dim], dtype=np.float64)
    px = logits[0, -1, :hidden_dim].double().numpy()
    np.testing.assert_allclose(px, rx, atol=1e-5)
    x = rx / (np.max(np.abs(rx)) + 1e-9)
    W = rng.uniform(-0.5, 0.5, (hidden_dim, k))
    return x, W


def test_private_inference_composite_equals_reference(head):
    x, W = head
    hidden_dim, k = W.shape
    ref = RefContext(n=64, levels=3, scale_bits=28, seed=42)
    port = PortContext(n=64, levels=3, scale_bits=28, seed=42, device="cpu")
    RM, PM = RLA.PtMatrix.encode(ref, W), TLA.PtMatrix.encode(port, W)
    # the matvec's baby and giant keys (the example's other rotation keys
    # serve its naive baseline, which this composite does not run)
    ref.plan().prepare(warm_jit=False, relin=False, matvecs=(RM,))
    port.plan().prepare(relin=False, matvecs=(PM,))
    rct = ref.encrypt(RLA.encode_vector(ref, x, k))
    pct = port.encrypt(TLA.encode_vector(port, x, k))
    assert _ct_equal(rct, pct)
    ry, py = RLA.matvec(ref.plan(), RM, rct), TLA.matvec(port.plan(), PM, pct)
    assert _ct_equal(ry, py)
    assert port.plan().stats == ref.plan().stats
    want = x @ W
    for got in (ref.decrypt_decode(ry).real[:k], port.decrypt_decode(py).real[:k]):
        assert np.max(np.abs(got - want)) < 1e-2
