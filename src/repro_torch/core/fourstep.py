"""Four-step (Bailey) factor tables for the large-N NTT — paper §IX.

The paper composes a 2^14-point NTT from two passes of 128 NTT-128
units plus a data reorder between passes.  With N = N1*N2:

  1. view a as an (N1, N2) matrix, A[j1, j2] = a[j1*N2 + j2]
  2. NTT_N1 along columns (root w^N2)            -> B[k1, j2]
  3. pointwise twiddle multiply by w^(j2*k1)     -> C[k1, j2]
  4. NTT_N2 along rows (root w^N1)               -> D[k1, k2]
  and A_hat[k2*N1 + k1] = D[k1, k2].

This module builds the host tables (numpy uint32) and the single-prime
entry points over the pipeline ``repro_torch.kernels.ops.ntt_fourstep_banks``
(``fourstep_ntt`` / ``fourstep_intt``, run as a k = 1 bank row on the
input's device), its natural-order oracle ``ntt_natural`` and its static
schedule.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.convert import from_reference
from repro_torch.core.ntt import ntt_cyclic
from repro_torch.core.params import (NTTParams, bitrev_perm, gen_ntt_primes,
                                     make_ntt_params, root_of_unity,
                                     shoup_table)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import brev_index
from repro_torch.runtime import op_cost


def ntt_natural(x, p: NTTParams):
    """Cyclic CG-NTT permuted to natural frequency order (bitrev is an
    involution, so the same gather converts either way)."""
    perm = torch.from_numpy(bitrev_perm(p.n)).to(x.device)
    return ntt_cyclic(x, p)[..., perm]


@dataclasses.dataclass(frozen=True)
class FourStepParams:
    n: int
    n1: int
    n2: int
    q: int
    p1: NTTParams               # column transform, root w^N2
    p2: NTTParams               # row transform, root w^N1
    tw_mat: np.ndarray          # (n1, n2) w^(j2*k1)
    tw_mat_p: np.ndarray
    itw_mat: np.ndarray         # inverse twiddles
    itw_mat_p: np.ndarray
    psi_mat: np.ndarray         # (n1, n2) psi^(j1*N2+j2) — negacyclic pre-weight
    psi_mat_p: np.ndarray
    ipsi_mat: np.ndarray        # psi^-i (the sub-iNTTs already give 1/n)
    ipsi_mat_p: np.ndarray


def _row_powers(step: np.ndarray, cols: int, q: int,
                start: np.ndarray | None = None) -> np.ndarray:
    """(rows, cols) table t[r, c] = start[r] * step[r]^c mod q, built one
    column at a time over all rows (uint64 products stay below 2^60)."""
    qq = np.uint64(q)
    step = step.astype(np.uint64)
    v = (np.ones_like(step) if start is None else start.astype(np.uint64))
    t = np.empty((step.shape[0], cols), dtype=np.uint64)
    for c in range(cols):
        t[:, c] = v
        v = v * step % qq
    return t


@functools.lru_cache(maxsize=None)
def make_fourstep_params(n1: int, n2: int, q: int | None = None,
                         bits: int = 30) -> FourStepParams:
    n = n1 * n2
    if q is None:
        q = gen_ntt_primes(1, n, bits)[0]
    psi = root_of_unity(2 * n, q)
    omega = pow(psi, 2, q)
    p1 = make_ntt_params(n1, q=q, psi=pow(psi, n2, q))
    p2 = make_ntt_params(n2, q=q, psi=pow(psi, n1, q))

    rows = np.arange(n1)
    iomega = pow(omega, q - 2, q)
    ipsi = pow(psi, q - 2, q)
    # tw_mat[k1, j2] = omega^(j2*k1): row k1 steps by omega^k1
    tw_mat = _row_powers(np.array([pow(omega, int(r), q) for r in rows]), n2, q)
    itw_mat = _row_powers(np.array([pow(iomega, int(r), q) for r in rows]), n2, q)
    # psi_mat[j1, j2] = psi^(j1*n2 + j2): row j1 starts at psi^(j1*n2)
    psi_mat = _row_powers(np.full(n1, psi), n2, q,
                          start=np.array([pow(psi, int(r) * n2, q) for r in rows]))
    ipsi_mat = _row_powers(np.full(n1, ipsi), n2, q,
                           start=np.array([pow(ipsi, int(r) * n2, q) for r in rows]))

    u = np.uint32
    return FourStepParams(n=n, n1=n1, n2=n2, q=q, p1=p1, p2=p2,
                          tw_mat=tw_mat.astype(u), tw_mat_p=shoup_table(tw_mat, q),
                          itw_mat=itw_mat.astype(u), itw_mat_p=shoup_table(itw_mat, q),
                          psi_mat=psi_mat.astype(u), psi_mat_p=shoup_table(psi_mat, q),
                          ipsi_mat=ipsi_mat.astype(u),
                          ipsi_mat_p=shoup_table(ipsi_mat, q))


@functools.lru_cache(maxsize=None)
def _banks_pack(n1: int, n2: int, q: int, device: str) -> dict:
    """Single-prime (k = 1) FourStepPack on ``device`` for the banks
    pipeline."""
    # fhe.batched imports this module for make_fourstep_params
    from repro_torch.fhe.batched import fourstep_pack_from_params
    return from_reference(
        fourstep_pack_from_params([make_fourstep_params(n1, n2, q)]), device)


def fourstep_ntt(a, fsp: FourStepParams, negacyclic: bool = False):
    """a: (..., n) int32 -> natural-order NTT via the four-step path, on
    a's device: both passes and the step-3 twiddle run as one bank row
    through ``ops.ntt_fourstep_banks``."""
    fp = _banks_pack(fsp.n1, fsp.n2, fsp.q, str(a.device))
    return ops.ntt_fourstep_banks(a[None], fp, negacyclic=negacyclic)[0]


def fourstep_intt(A, fsp: FourStepParams, negacyclic: bool = False):
    fp = _banks_pack(fsp.n1, fsp.n2, fsp.q, str(A.device))
    return ops.intt_fourstep_banks(A[None], fp, negacyclic=negacyclic)[0]


def fourstep_schedule(n1: int, n2: int) -> dict:
    """Static structure of the §IX schedule — what runs in each pass, to
    hold ``srm_sim.large_ntt_cycles`` (two passes of 128 NTT-128s through
    128 units at 2^14) against the pipeline's shape."""
    return {
        "passes": 2,
        # pass 1 runs one NTT-N1 per column, pass 2 one NTT-N2 per row
        "transforms_per_pass": (n2, n1),
        "transform_sizes": (n1, n2),
        "butterfly_cycles_per_pass": (n2 * (n1 // 2), n1 * (n2 // 2)),
        "reorders": 1,                  # the inter-pass transpose
        "twiddle_muls": n1 * n2,        # fused step-3 correction
    }


# ------------------------------------------------------------- sharded

def fourstep_ntt_sharded(a2d, fsp: FourStepParams, mesh, axis: str = "model",
                         negacyclic: bool = False):
    """Four-step over the shards of one mesh axis (``repro_torch.mesh``).

    a2d: (n1, n2) int32 matrix whose columns split over the axis's D
    shards.  Shard i runs the pre-weight (negacyclic), its column
    NTT-N1s and the step-3 twiddle on its (n1, n2/D) block on its device;
    the reorder network between the two NTT banks (the reference's one
    ``all_to_all``) is explicit copies: shard j gathers rows
    [j n1/D, (j+1) n1/D) of every block, then runs its row NTT-N2s.
    Returns the D matrix (n1, n2) on a2d's device, row block j from
    shard j (the reference's ``P(axis, None)``); A_hat[k2*n1+k1] =
    D[k1, k2]."""
    n1, n2 = fsp.n1, fsp.n2
    devices = mesh.axis_devices(axis)
    D = len(devices)
    if tuple(a2d.shape) != (n1, n2) or n1 % D or n2 % D:
        raise ValueError(f"fourstep_ntt_sharded: a ({n1}, {n2}) matrix over "
                         f"{D} shards, got {tuple(a2d.shape)}")
    c, r = n2 // D, n1 // D
    blocks = []
    for i, d in enumerate(devices):
        fp = _banks_pack(n1, n2, fsp.q, str(d))
        cols = slice(i * c, (i + 1) * c)

        def weighted(x, name):
            w = fp[name].view(n1, n2)[:, cols].reshape(1, n1 * c)
            wp = fp[name + "p"].view(n1, n2)[:, cols].reshape(1, n1 * c)
            return ops.twiddle_mul_banks(x.reshape(1, 1, n1 * c), w, wp,
                                         fp["qs"]).view(n1, c)

        x = a2d[:, cols].to(d)
        if negacyclic:
            x = weighted(x, "psi")
        xt = ops.ntt_banks(x.t().contiguous()[None], fp["pack1"],
                           negacyclic=False)[0][:, brev_index(n1, d)]
        blocks.append(weighted(xt.t(), "tw"))
    op_cost.record_collective("all-to-all", op_cost.nbytes(blocks[0]), D)
    rows = []
    for j, d in enumerate(devices):
        fp = _banks_pack(n1, n2, fsp.q, str(d))
        x = torch.cat([b[j * r:(j + 1) * r].to(d) for b in blocks], dim=1)
        x = ops.ntt_banks(x[None], fp["pack2"], negacyclic=False)[0]
        rows.append(x[:, brev_index(n2, d)].to(a2d.device))
    return torch.cat(rows, dim=0)
