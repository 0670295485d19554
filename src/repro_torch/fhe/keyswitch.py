"""RNS-digit key switching, the paper's Fig 22 pipeline stage by stage:
the host-orchestrated oracle of the fused ``fhe.batched.batched_keyswitch``.

  INTT unit                  -> ``RnsPoly.to_coeff``  (step 1)
  mod-up / base extension    -> ``rns.extend_single`` (step 2, on the host)
  NTT banks                  -> ``RnsPoly.to_ntt``    (step 2)
  dyadic MM/MA arrays        -> ``.mul().add()``      (step 3)
  RNS floor (INTT+ext+NTT)   -> ``mod_down_by_last``  (step 4)

The digit loop is a Python loop and the base extension runs in numpy,
but every transform and product inside it runs on the ciphertext's
device through the banks entry points.  No scheme op calls it: the
scheme lowers to ``fhe.evalplan``'s programs, and this module is the
bit-exact pin those programs are held against in the tests.
"""
from __future__ import annotations

from repro_torch.convert import tensor_to_u32
from repro_torch.fhe.rns import RnsPoly, extend_single


def mod_down_by_last(x: RnsPoly) -> RnsPoly:
    """RNS floor: divide by the last prime of x's basis and round.  x in
    NTT form; returns NTT form over the shortened basis.  Serves both the
    key-switch mod-down by the special prime P and the rescale by q_l."""
    if not x.is_ntt:
        raise ValueError("mod_down_by_last: NTT form expected")
    last_q = x.primes[-1]
    last = RnsPoly(x.data[-1:], (last_q,), True).to_coeff()   # one INTT row
    rest = x.primes[:-1]
    ext = extend_single(tensor_to_u32(last.data)[0], last_q, rest,
                        x.device).to_ntt()
    diff = x.drop_last().sub(ext)
    return diff.mul_scalar_per_prime({q: pow(last_q, -1, q) for q in rest})


def keyswitch(d2: RnsPoly, evk: list[tuple[RnsPoly, RnsPoly]],
              special_prime: int) -> tuple[RnsPoly, RnsPoly]:
    """Switch the key under ``d2`` with digit keys ``evk`` (one per prime
    of d2's basis).  d2: NTT form over (q_0..q_l); each evk[i] a pair of
    RnsPoly over (q_0..q_l, P) encrypting P * T_i * s_from.  Returns
    (ks0, ks1) over (q_0..q_l)."""
    if not d2.is_ntt:
        raise ValueError("keyswitch: d2 must be in NTT form")
    primes = d2.primes
    full = primes + (special_prime,)
    d2c = tensor_to_u32(d2.to_coeff().data)                # INTT units
    acc0 = acc1 = None
    for i, qi in enumerate(primes):                        # outer loop, Fig 22
        ext = extend_single(d2c[i], qi, full, d2.device).to_ntt()   # mod-up + NTT
        t0 = ext.mul(evk[i][0])                            # dyadic MM
        t1 = ext.mul(evk[i][1])
        acc0 = t0 if acc0 is None else acc0.add(t0)        # MA accumulate
        acc1 = t1 if acc1 is None else acc1.add(t1)
    return mod_down_by_last(acc0), mod_down_by_last(acc1)  # RNS floor
