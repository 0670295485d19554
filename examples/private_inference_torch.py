"""crypto-infer on the PyTorch port: encrypted inference of an LM
classification head.

The paper accelerates the NTT at the heart of CKKS; this example runs
the "outsourced inference" scenario it enables — a client encrypts an
activation vector, the server computes a linear layer (logits) UNDER
ENCRYPTION, and only the client can decrypt the logits.

The server builds ONE ``EvalPlan`` up front (``ctx.plan().prepare``):
all key-switch tables, stacked Galois key tensors and gather rows for
the rotation set are device-resident before the first request (on the
card each program is a CUDA graph captured there).

The matvec itself runs TWICE per request to show the slot-linalg layer
paying off:

  before  the naive diagonal method — one independent ``rotate``
          (= one full key switch) per nonzero diagonal, d-1 key
          switches total;
  after   ``fhe.linalg.matvec`` — BSGS diagonals with HOISTED baby
          steps: one hoisted dispatch shares a single digit
          decomposition across all baby rotations, and one
          mixed-amount ``rotate_many`` dispatch covers the giant steps.

Model: the smollm-135m (smallest assigned arch) final-hidden -> a small
class head.  Both paths are verified against the cleartext computation.
Runs on the card unless ``--device`` names another device.

Run:  PYTHONPATH=src python examples/private_inference_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.convert import resolve_device
from repro_torch.fhe import linalg
from repro_torch.fhe.ckks import CkksContext
from repro_torch.models.model import build_model


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def encode_diagonals(ctx, W):
    """One-time server setup for the NAIVE path: the nonzero weight
    diagonals of the rotate-and-multiply matvec, pre-encoded to
    plaintext RnsPolys (diag_r[j] = W[(j + r) % d, j] for j < k)."""
    d, k = W.shape
    diags = {}
    for r in range(d):
        diag = np.zeros(ctx.slots, dtype=np.complex128)
        for j in range(k):
            diag[j] = W[(j + r) % d, j]
        if np.any(diag):
            diags[r] = ctx.encode(diag)
    return diags


def encrypted_matvec_naive(ctx, plan, ct_x, diags):
    """Diagonal method matvec, one INDEPENDENT key switch per rotation:
    y = sum_r rot(x, r) * diag_r."""
    acc = None
    for r, diag_pt in diags.items():
        rot = plan.rotate(ct_x, r) if r else ct_x
        term = ctx.mul_plain(rot, diag_pt)
        acc = term if acc is None else ctx.add(acc, term)
    return acc


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- cleartext model: reduced smollm producing a hidden state -------
    cfg = smoke_config("smollm-135m")
    model = build_model(cfg, device=dev)          # weights drawn from seed 0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16)).astype(np.int32)).to(dev)
    with torch.no_grad():
        logits, _ = model({"tokens": toks})
    hidden_dim, k = 16, 4                     # small head for the demo
    x = logits[0, -1, :hidden_dim].double().cpu().numpy()
    x = x / (np.max(np.abs(x)) + 1e-9)        # normalize into CKKS range
    W = rng.uniform(-0.5, 0.5, (hidden_dim, k))

    want = x @ W
    print(f"cleartext head output: {np.round(want, 4)}")

    # --- encrypted path ---------------------------------------------------
    ctx = CkksContext(n=64, levels=3, scale_bits=28, seed=42, device=dev)
    t0 = time.perf_counter()
    M = linalg.PtMatrix.encode(ctx, W)
    plan = ctx.plan().prepare(
        rotations=tuple(range(1, hidden_dim)), relin=False,
        matvecs=(M,))   # the whole BSGS composite, no signature left to capture
    diags = encode_diagonals(ctx, W)    # no ct x ct multiply -> no relin key
    print(f"EvalPlan prepared in {time.perf_counter() - t0:.2f}s "
          f"({hidden_dim - 1} rotation keys, {len(diags)} naive diagonals, "
          f"BSGS n1={M.n1} n2={M.n2}, basis k={len(ctx.qs)})")

    # client encrypts in the tiled slot layout the diagonal method reads
    ct = ctx.encrypt(linalg.encode_vector(ctx, x, k))
    for req in range(2):                      # requests reuse plan + packs
        plan.reset_stats()
        t0 = time.perf_counter()
        ct_naive = encrypted_matvec_naive(ctx, plan, ct, diags)
        sync(dev)
        t_naive = time.perf_counter() - t0
        naive_stats = dict(plan.stats)

        plan.reset_stats()
        t0 = time.perf_counter()
        ct_y = linalg.matvec(plan, M, ct)     # server computes blindly
        sync(dev)
        t_bsgs = time.perf_counter() - t0
        print(f"request {req}: naive {t_naive * 1e3:7.1f} ms "
              f"({naive_stats['key_switches']} keyswitches, "
              f"{naive_stats['dispatches']} dispatches)  ->  "
              f"hoisted BSGS {t_bsgs * 1e3:7.1f} ms "
              f"({plan.stats['key_switches']} keyswitches/"
              f"{plan.stats['decomposes']} decomposes, "
              f"{plan.stats['dispatches']} dispatches)  "
              f"x{t_naive / t_bsgs:.2f}")

    errs = {}
    for name, ct_out in (("naive", ct_naive), ("hoisted", ct_y)):
        got = ctx.decrypt_decode(ct_out).real[:k]   # client decrypts
        errs[name] = err = float(np.max(np.abs(got - want)))
        print(f"encrypted {name:7s} output: {np.round(got, 4)}  "
              f"max abs error {err:.2e}  ({'OK' if err < 1e-2 else 'FAIL'})")
    where = "the banks kernels" if dev.type == "cuda" else "their plain versions on the CPU"
    print(f"every ring op above ran through {where} "
          f"(n={ctx.n}, {len(ctx.qs)} RNS primes)")
    return errs


if __name__ == "__main__":
    main()
