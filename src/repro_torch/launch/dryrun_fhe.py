"""sce-ntt dry-run cells: the paper's own workloads on the production
mesh, counted on ``meta`` tensors (invoked from ``launch/dryrun.py``).

  ntt_batch     streaming batch of negacyclic NTT-128s (the fabricated
                unit's steady-state workload, §IV), batch-parallel over
                every mesh axis.
  fourstep_16k  batched distributed 2^14-point NTT = column-NTT ->
                twiddle -> ALL-TO-ALL (the paper's reorder network, §IX)
                -> row-NTT, columns sharded on the model axis.
  keyswitch_16k batched CKKS key-switch (paper Fig 22): 8 digits,
                98 NTT-128-equivalent transforms per op (the paper
                counts "some 90 NTT-128 modules"), on the port's banks
                kernels (their meta branches record each launch).

Each cell runs its function once at the global shapes under
``runtime.op_cost.OpCounter``; every cell splits its work evenly over
all devices, so FLOPs (integer operations here), bytes and the live
peak are that count over the devices, and the roofline's compute term
uses the card's INT32 rate.  The argument and output bytes per device
are exact, from each tensor's partition spec; an argument the function
does not read is left out, as ``jax.jit`` leaves it out.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.configs.sce_ntt import CONFIG as SCE
from repro_torch.core.modmath import mulmod_shoup, u32
from repro_torch.core.ntt import cg_ntt
from repro_torch.core.params import bitrev_perm
from repro_torch.fhe import batched as FB
from repro_torch.launch.mesh import make_mesh_ctx
from repro_torch.mesh import NamedSharding, P
from repro_torch.runtime import op_cost
from repro_torch.runtime import roofline as RL

BUTTERFLY_FLOPS = 19      # 6 u32 mults + carries/adds/selects (Shoup BU)
TUPLE_ENTRY_BYTES = 8     # XLA's tuple index table, one pointer per output leaf


def _ntt_model_flops(batch: int, n: int) -> float:
    return batch * (n // 2) * (n.bit_length() - 1) * BUTTERFLY_FLOPS


def _meta(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _rep(t: torch.Tensor) -> P:
    return P(*([None] * t.ndim))


def _cell_ntt_batch(mctx):
    n = SCE.ring_n
    k = 1
    B = 65536
    dp_all = tuple(mctx.mesh.axis_names)          # batch over EVERY axis
    tables = FB.table_pack_shapes(k, n)
    args = {"x": _meta((B, n)), **{f"t.{name}": v for name, v in tables.items()}}
    specs = {"x": P(dp_all, None), **{f"t.{name}": _rep(v) for name, v in tables.items()}}

    def fn():
        return [FB.ntt_fwd_i(args["x"], tables, 0)]
    return fn, args, specs, [P(dp_all, None)], _ntt_model_flops(B, n) + B * n * 13


def _cell_fourstep(mctx):
    n1, n2 = SCE.large_n1, SCE.large_n2
    B = 4096
    s1 = n1.bit_length() - 1
    mesh, tp = mctx.mesh, mctx.tp
    tabs = {
        "tw1": _meta((s1, n1 // 2)), "twp1": _meta((s1, n1 // 2)),
        "tw2": _meta((n2.bit_length() - 1, n2 // 2)),
        "twp2": _meta((n2.bit_length() - 1, n2 // 2)),
        "tw_mat": _meta((n1, n2)), "tw_mat_p": _meta((n1, n2)),
        "psi_mat": _meta((n1, n2)), "psi_mat_p": _meta((n1, n2)),
    }
    a = _meta((B, n1, n2))
    q = 998244353  # placeholder static modulus (values never run)
    perm1 = torch.from_numpy(np.argsort(bitrev_perm(n1))).to("meta")
    perm2 = torch.from_numpy(np.argsort(bitrev_perm(n2))).to("meta")
    in_spec = P(mctx.dp, None, tp)
    col = P(None, tp)
    tab_specs = {name: (P(None, None) if name.startswith(("tw1", "twp1", "tw2", "twp2"))
                        else col) for name in tabs}

    def local(x, t):
        # the reference's shard_map body at the global shapes: every op
        # splits evenly over the devices, the exchange moves each device's
        # (B/dp, n1, n2/tp) block of int32 words
        x = mulmod_shoup(u32(x), u32(t["psi_mat"]), u32(t["psi_mat_p"]), q)
        xt = x.transpose(-1, -2)                           # (B, n2, n1)
        xt = cg_ntt(xt, t["tw1"], t["twp1"], q)[..., perm1]
        x = xt.transpose(-1, -2)
        x = mulmod_shoup(u32(x), u32(t["tw_mat"]), u32(t["tw_mat_p"]), q).int()
        op_cost.record_collective(
            "all-to-all", 4 * math.prod(NamedSharding(mesh, in_spec).shard_shape(x.shape)),
            mesh.shape[tp])
        return cg_ntt(x, t["tw2"], t["twp2"], q)[..., perm2]    # rows local

    args = {"a": a, **{f"t.{name}": v for name, v in tabs.items()}}
    specs = {"a": in_spec, **{f"t.{name}": s for name, s in tab_specs.items()}}
    n = n1 * n2
    mf = _ntt_model_flops(B, n) + 2 * B * n * 13          # + twiddle/psi passes
    return lambda: [local(a, tabs)], args, specs, [P(mctx.dp, tp, None)], mf


def _cell_keyswitch(mctx):
    n = SCE.large_n1 * SCE.large_n2
    k = SCE.rns_limbs                                      # 8 digits
    B = 1024
    dp_all = tuple(mctx.mesh.axis_names)
    tables = FB.table_pack_shapes(k + 1, n)
    d2, evk_b, evk_a = _meta((k, B, n)), _meta((k, k + 1, n)), _meta((k, k + 1, n))
    bsh = P(None, dp_all, None)
    args = {"d2": d2, "evk_b": evk_b, "evk_a": evk_a,
            **{f"t.{name}": v for name, v in tables.items()}}
    specs = {"d2": bsh, "evk_b": _rep(evk_b), "evk_a": _rep(evk_a),
             **{f"t.{name}": _rep(v) for name, v in tables.items()}}

    def fn():
        return list(FB.batched_keyswitch(d2, evk_b, evk_a, tables))
    # 98 NTT-equivalents + dyadic MACs (paper: "some 90 NTT-128 modules")
    ntts = k * (1 + (k + 1)) + 2 * (1 + k)
    mf = ntts * _ntt_model_flops(B, n) / 1 + 2 * k * (k + 1) * B * n * 25
    return fn, args, specs, [bsh, bsh], mf


BUILDERS = {"ntt_batch": _cell_ntt_batch, "fourstep_16k": _cell_fourstep,
            "keyswitch_16k": _cell_keyswitch}


def shard_bytes(mesh, spec, t: torch.Tensor) -> int:
    """Bytes of the block of ``t`` each device holds under ``spec``."""
    return math.prod(NamedSharding(mesh, spec).shard_shape(t.shape)) * t.element_size()


def output_bytes(leaf_bytes: list[int]) -> int:
    """Per-device output bytes in the reference's convention: the leaves,
    plus XLA's tuple index table where there is more than one."""
    return sum(leaf_bytes) + (TUPLE_ENTRY_BYTES * len(leaf_bytes) if len(leaf_bytes) > 1 else 0)


def memory_block(arg_b: int, out_b: int, alias_b: int, peak_dev: float) -> dict:
    """The record's ``memory`` block.  ``peak_dev`` is the pass's live
    peak per device; temp is that less the outputs not aliased to an
    argument, so that argument + output + temp - alias is the arguments
    plus the pass's peak, the bytes the program holds at its busiest."""
    temp = max(0, int(peak_dev) - (out_b - alias_b))
    peak = arg_b + out_b + temp - alias_b
    return {
        "argument_bytes_per_device": arg_b,
        "output_bytes_per_device": out_b,
        "temp_bytes_per_device": temp,
        "alias_bytes_per_device": alias_b,
        "peak_estimate_gib": round(peak / 2**30, 3),
        "fits_80gb_hbm": peak < RL.HBM_BYTES,
    }


TEMP_METHOD = ("temp: the live-tensor peak of one meta pass at the global shapes "
               "(runtime.op_cost), split over the devices, less the outputs not "
               "aliased to an argument; an upper bound where a device holds less "
               "than its share")


def count(shape_name: str, mctx) -> dict:
    """One FHE cell counted on ``mctx``'s mesh (of any devices: only its
    shape is read).  Returns the record's fields, with the kernels'
    launches and the arguments the cell does not read."""
    mesh = mctx.mesh
    ndev = len(mesh.devices)
    fn, args, specs, out_specs, model_flops = BUILDERS[shape_name](mctx)
    t0 = time.time()
    with op_cost.OpCounter(args) as c:
        outs = fn()
    count_s = time.time() - t0
    arg_b = sum(shard_bytes(mesh, specs[name], args[name]) for name in sorted(c.read))
    out_b = output_bytes([shard_bytes(mesh, s, o) for s, o in zip(out_specs, outs)])
    rl = RL.roofline_from_counts(c.per_device(ndev), model_flops, n_devices=ndev,
                                 peak=RL.INT32_OPS_PER_S)
    return {"count_s": round(count_s, 1),
            "memory": memory_block(arg_b, out_b, 0, c.peak / ndev),
            "roofline": rl.to_dict(), "kernels": dict(c.kernels),
            "unread": sorted(set(args) - c.read),
            "method": {"temp": TEMP_METHOD,
                       "flops": "integer operations: aten elementwise ops one per "
                                "element, each kernel's integer instructions "
                                "(runtime.roofline); compute_s at INT32_OPS_PER_S",
                       "collectives": "recorded where they happen (the four-step "
                                      "all-to-all), per device"}}


def run_cell(shape_name: str, mesh_name: str) -> dict:
    pod2 = mesh_name == "pod2"
    mctx = make_mesh_ctx(multi_pod=pod2, devices=["meta"] * (512 if pod2 else 256))
    rec = count(shape_name, mctx)
    return {"arch": "sce-ntt", "shape": shape_name, "mesh": mesh_name, "kind": "fhe",
            **rec}
