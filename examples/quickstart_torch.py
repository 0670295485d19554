"""Quickstart on the PyTorch port: the paper's pipeline end to end.

  1. NTT-128 through the constant-geometry network (+ SRM cycle sim)
  2. negacyclic polynomial multiply via NTT (the FHE primitive)
  3. CKKS: encrypt two vectors, multiply homomorphically, decrypt (the
     ring ops on the banks kernels on the card)
  4. the paper's headline numbers from the cycle model

Runs on the card unless ``--device`` names another device.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.convert import resolve_device, tensor_to_u32, u32_to_tensor
from repro_torch.core import srm_sim
from repro_torch.core.modmath import mulmod_np
from repro_torch.core.ntt import intt_negacyclic, ntt_cyclic, ntt_negacyclic
from repro_torch.core.params import make_ntt_params
from repro_torch.fhe.ckks import CkksContext


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # 1 — NTT-128 (paper §IV) --------------------------------------------
    p = make_ntt_params(128)
    poly = rng.integers(0, p.q, 128, dtype=np.uint32)
    A = tensor_to_u32(ntt_cyclic(u32_to_tensor(poly, dev), p))
    print(f"NTT-128 over q={p.q}: in[:4]={poly[:4]} out[:4]={A[:4]}")

    pipe = srm_sim.NTT128Pipeline(p)
    out, stats = pipe.run(poly[None, :])
    match = bool(np.array_equal(out[0], A))
    print(f"SRM pipeline simulator: match={match} "
          f"latency={stats['latency_cycles']} cycles (paper Table III: 1,036)")

    # 2 — negacyclic multiply (ring R_q = Z_q[x]/(x^n+1)) ------------------
    a = rng.integers(0, p.q, 128, dtype=np.uint32)
    b = rng.integers(0, p.q, 128, dtype=np.uint32)
    C = mulmod_np(tensor_to_u32(ntt_negacyclic(u32_to_tensor(a, dev), p)),
                  tensor_to_u32(ntt_negacyclic(u32_to_tensor(b, dev), p)), p.q)
    c = tensor_to_u32(intt_negacyclic(u32_to_tensor(C, dev), p))
    print(f"poly multiply via NTT: c[:4]={c[:4]}")

    # 3 — CKKS (paper §II/§VIII) ------------------------------------------
    ctx = CkksContext(n=512, levels=3, seed=1, device=dev)
    z1 = rng.uniform(-1, 1, ctx.slots)
    z2 = rng.uniform(-1, 1, ctx.slots)
    ct = ctx.rescale(ctx.multiply(ctx.encrypt(ctx.encode(z1)),
                                  ctx.encrypt(ctx.encode(z2))))
    got = ctx.decrypt_decode(ct).real
    err = float(np.max(np.abs(got - z1 * z2)))
    print(f"CKKS enc(x)*enc(y): max err {err:.2e} (scale 2^28)")

    # 4 — headline numbers (cycle model) -----------------------------------
    t3 = srm_sim.table3_model()
    big = srm_sim.large_ntt_cycles()
    ks = srm_sim.keyswitch_cycles()
    print(f"NTT-128 @34GHz: {t3['throughput_mntt_per_s']:.2f}M NTT/s (paper: 531)")
    print(f"2^14 NTT: {big['ideal_latency_ns']:.0f} ns (paper: ~482)")
    print(f"key-switch: {ks['throughput_per_s']:.2e}/s, "
          f"{ks['speedup_vs_cmos']:.0f}x HEAX (paper: 1.63M/s)")
    return {"ntt": A, "product": c, "match": match, "ckks_err": err}


if __name__ == "__main__":
    main()
