"""Multi-pod dry run: count every (arch x shape x mesh) cell on the
production mesh on ``meta`` tensors, and record memory, cost and
collectives per device, the port's counterpart of the reference's
``launch/dryrun.py``.

The reference lowers and compiles each cell with XLA and reads the
compiler's analyses; the port has no compiler to ask, so it builds the
model on ``meta`` (shapes and dtypes, no data) over a mesh of the meta
device listed 256 or 512 times and runs the cell's program once under
``runtime.op_cost.OpCounter``.  What each figure is:

  argument / output / alias bytes per device: exact, from each tensor's
    partition spec (``runtime.sharding``) through
    ``NamedSharding.shard_shape``.  Arguments count where the program
    reads them (``jax.jit`` drops the others); the output adds XLA's
    tuple index table (8 bytes a leaf where there is more than one), as
    the reference's figure does; alias is the donated arguments (params
    and optimizer state for train, the cache for decode) that come back
    with the same per-device shape and dtype.
  temp bytes per device: the port's own model, stated in the record's
    ``method``: the meta pass's live-tensor peak at the global shapes,
    split over the batch shards, less the outputs not aliased.
  FLOPs and bytes: the meta count over the devices (``runtime.op_cost``).
  collectives: from the specs by the ring model (``runtime.roofline``)
    plus what the shard branches record; ``method`` lists them.

The shard branches (``models.moe``, ``models.rglru``) run one shard on
``meta``, counted once per device; everything else runs whole, so its
count is the global work.

Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod1|pod2|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --report

Results: experiments/dryrun_torch/<arch>__<shape>__<mesh>.json (existing
files are skipped: the sweep is resumable).  A cell that fails raises
out, with a nonzero exit, after the cells before it have been written;
run again to resume after it.  ``--report`` prints the
dry-run, roofline and pod1-vs-pod2 tables from those files.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import time

import torch

from repro_torch import tree as T
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun_fhe as FHE
from repro_torch.launch.mesh import make_mesh_ctx
from repro_torch.mesh import NamedSharding, P, axis_size
from repro_torch.models.common import SHAPES, ShapeCfg
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import op_cost
from repro_torch.runtime import roofline as RL
from repro_torch.runtime import sharding as SH
from repro_torch.train.step import TrainConfig, init_train_state, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
FHE_SHAPES = ("ntt_batch", "fourstep_16k", "keyswitch_16k")
# a leaf the MoE shard branch gathers itself (its record, not the specs')
_BRANCH_GATHERED = ("w_up", "w_gate", "w_down")

COLLECTIVE_METHOD = (
    "collectives per device, by the ring model: one all-gather over fsdp of "
    "each fsdp-sharded parameter for each use (a stacked leaf's layer slice, "
    "the tied embedding twice), again in the backward under remat 'full'; for "
    "train one reduce-scatter over fsdp of each fsdp-sharded gradient and an "
    "all-reduce of each gradient over the dp axes its spec does not split; "
    "plus what the shard branches record (the MoE expert all-gathers, output "
    "psum over tp and aux pmean over dp; the RG-LRU scan's aggregate "
    "all-gathers)")


# ------------------------------------------------------------ helpers

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeCfg):
    """Meta stand-ins for every model input (no allocation)."""
    B, S = shape.batch, shape.seq
    if shape.kind == "train":
        batch = {"labels": _meta((B, S), torch.int32)}
        if cfg.embeds_input:
            batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        else:
            batch["tokens"] = _meta((B, S), torch.int32)
        return batch
    if shape.kind == "prefill":
        batch = ({"embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
                 if cfg.embeds_input else {"tokens": _meta((B, S), torch.int32)})
        return batch
    # decode: one token against a seq_len cache
    batch = ({"embeds": _meta((B, 1, cfg.d_model), torch.bfloat16)}
             if cfg.embeds_input else {"tokens": _meta((B, 1), torch.int32)})
    return batch


def count_params(shapes_tree, cfg):
    total = active = 0.0
    for path, leaf in T.flatten_with_path(shapes_tree):
        k = ".".join(str(p) for p in path)
        n = float(math.prod(leaf.shape))
        if "embed" in k and not cfg.tie_embeddings:
            continue                       # lookup table, not matmul params
        total += n
        if cfg.moe is not None and "moe" in k and any(
                w in k for w in ("w_up", "w_gate", "w_down")):
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return total, active


def _train_opt_cfg(arch: str) -> AdamWConfig:
    if arch == "kimi-k2-1t-a32b":
        return AdamWConfig(moments_dtype="int8")   # int8 moments, as the reference's
    return AdamWConfig()


def _leaves(tree, specs):
    """(path, leaf, spec) of a tree and its matching tree of specs; a
    cache's ``len`` (a host int in the port) stands as the reference's
    int32 scalar."""
    spec_of = {p: s for p, s in T.flatten_with_path(specs)}
    out = []
    for p, leaf in T.flatten_with_path(tree):
        if not isinstance(leaf, torch.Tensor):
            leaf = _meta((), torch.int32)
        out.append((".".join(map(str, p)), leaf, spec_of[p]))
    return out


def _shards(mesh, leaves) -> dict:
    """path -> (per-device shape, dtype, bytes)."""
    return {p: (NamedSharding(mesh, s).shard_shape(t.shape), t.dtype,
                FHE.shard_bytes(mesh, s, t)) for p, t, s in leaves}


def _spec_collectives(mesh, mctx, cfg, pleaves, kind: str) -> op_cost.Cost:
    """The collectives the parameter specs imply (COLLECTIVE_METHOD)."""
    c = op_cost.Cost()

    def add(op, nbytes, n, times=1):
        if n <= 1 or times == 0:
            return
        c.coll_counts[op] = c.coll_counts.get(op, 0) + times
        c.coll_bytes[op] = c.coll_bytes.get(op, 0) + times * nbytes
        c.coll_traffic += times * RL.ring_traffic(op, nbytes, n)

    fsdp = mctx.fsdp
    n_fsdp = mesh.shape[fsdp]
    passes = 2 if kind == "train" else 1
    for path, leaf, spec in pleaves:
        axes = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
        shard = FHE.shard_bytes(mesh, spec, leaf)
        layers = leaf.shape[0] if path.split(".")[0] in ("blocks", "groups", "tail") else 1
        uses = layers * (2 if path == "embed" and cfg.tie_embeddings else 1)
        if fsdp in axes:
            if not ("moe" in path and path.endswith(_BRANCH_GATHERED)):
                add("all-gather", shard * n_fsdp // layers, n_fsdp, passes * uses)
            if kind == "train":
                add("reduce-scatter", shard // layers, n_fsdp, layers)
        if kind == "train":
            free = [a for a in mctx.dp if a not in axes]
            add("all-reduce", shard, axis_size(mesh, tuple(free)) if free else 1)
    return c


# ---------------------------------------------------------- the cells

def count_cell(arch: str, shape_name: str, mctx, *, shape: ShapeCfg | None = None,
               opt: AdamWConfig | None = None) -> dict:
    """One LM cell counted on ``mctx``'s mesh (of any devices: only its
    shape is read; the model is built on meta, remat "full").  ``shape``
    overrides the named shape's sizes (a one-card check), ``opt`` the
    optimizer."""
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mctx.mesh
    ndev = len(mesh.devices)
    model = build_model(cfg, mctx, device="meta", remat_policy="full")
    params = model.tree()
    pspecs = SH.param_pspecs(params, cfg, mctx)
    total_p, active_p = count_params(params, cfg)
    batch = input_specs(cfg, shape)
    bspecs = SH.batch_pspecs(batch, mctx)
    B, S = shape.batch, shape.seq
    args = {"params": params, "batch": batch}
    specs = {"params": pspecs, "batch": bspecs}
    donated = ()
    if shape.kind == "train":
        tcfg = TrainConfig(opt=opt or _train_opt_cfg(arch), remat_policy="full")
        state = init_train_state(model, params, tcfg)
        args["state"] = state
        specs["state"] = {"opt": SH.opt_pspecs(pspecs, state["opt"], mctx,
                                               tcfg.opt.moments_dtype)}
        step = make_train_step(model, tcfg)
        run = lambda: dict(zip(("state", "metrics"), step(state, batch)),
                           params=params)
        donated = ("params", "state")
        model_flops = 6.0 * active_p * B * S
    elif shape.kind == "prefill":
        run = lambda: dict(zip(("logits", "cache"),
                               model.prefill(dict(batch, max_len=S))))
        model_flops = 2.0 * active_p * B * S
    else:  # decode
        cache = model.init_cache(B, S)
        args["cache"] = cache
        specs["cache"] = SH.cache_pspecs(cache, cfg, mctx)
        run = lambda: dict(zip(("logits", "cache"), model.decode_step(cache, batch)))
        donated = ("cache",)
        model_flops = 2.0 * active_p * B

    arg_leaves = _leaves(args, specs)
    lens = {p for p, _, _ in arg_leaves if p.endswith(".len")}
    t0 = time.time()
    with op_cost.OpCounter({p: t for p, t, _ in arg_leaves if p not in lens}) as c:
        outs = run()
    count_s = time.time() - t0
    arg_shards = _shards(mesh, arg_leaves)
    arg_b = sum(arg_shards[p][2] for p in c.read | lens)

    out_specs = {"params": pspecs, "state": specs.get("state"),
                 "metrics": {k: P() for k in outs.get("metrics", {})}}
    if "logits" in outs:
        out_specs["logits"] = SH.batch_pspecs({"l": outs["logits"]}, mctx)["l"]
        out_specs["cache"] = SH.cache_pspecs(outs["cache"], cfg, mctx)
    out_shards = _shards(mesh, _leaves(outs, {k: out_specs[k] for k in outs}))
    out_b = FHE.output_bytes([b for _, _, b in out_shards.values()])
    alias_b = sum(sh[2] for p, sh in out_shards.items()
                  if p.split(".")[0] in donated and arg_shards.get(p) == sh)

    dp = tuple(mctx.dp)
    dp_split = axis_size(mesh, dp) if B % axis_size(mesh, dp) == 0 else 1
    cost = c.per_device(ndev)
    cost += _spec_collectives(mesh, mctx, cfg, _leaves(params, pspecs), shape.kind)
    rl = RL.roofline_from_counts(cost, model_flops, n_devices=ndev)
    return {"params_total": total_p, "params_active": active_p,
            "count_s": round(count_s, 1),
            "memory": FHE.memory_block(arg_b, out_b, alias_b, c.peak / dp_split),
            "roofline": rl.to_dict(), "kernels": dict(c.kernels),
            "unread": sorted(set(arg_shards) - c.read - lens),
            "method": {"temp": FHE.TEMP_METHOD.replace("over the devices",
                                                       f"over the {dp_split} batch shards")
                       + "; an upper bound where 'model' splits activations",
                       "flops": "products 2*M*N*K (torch.utils.flop_counter's "
                                "registry), elementwise ops one per element; the "
                                "meta count over the devices",
                       "collectives": COLLECTIVE_METHOD}}


def run_cell(arch: str, shape_name: str, mesh_name: str) -> dict:
    if arch == "sce-ntt":
        return FHE.run_cell(shape_name, mesh_name)
    cfg = get_config(arch)
    if shape_name == "long_500k" and not getattr(cfg, "sub_quadratic", False):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": "full-attention arch; long_500k requires "
                           "sub-quadratic attention"}
    pod2 = mesh_name == "pod2"
    mctx = make_mesh_ctx(multi_pod=pod2, devices=["meta"] * (512 if pod2 else 256))
    rec = count_cell(arch, shape_name, mctx)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "kind": SHAPES[shape_name].kind, **rec}


# ------------------------------------------------------------ report

def _fmt_b(b):
    if b >= 2**30:
        return f"{b / 2**30:.2f}Gi"
    if b >= 2**20:
        return f"{b / 2**20:.1f}Mi"
    return f"{b / 2**10:.0f}Ki"


def report(out_dir: str) -> None:
    """The dry-run, roofline and pod1-vs-pod2 tables of the records in
    ``out_dir`` (the reference's experiments/make_report.py, on the
    port's records: the H100's rates, its 80 GB)."""
    recs = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    order = {s: i for i, s in enumerate(list(SHAPES) + list(FHE_SHAPES))}
    recs.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"]))

    print("### Dry-run table (per device, counted on meta)\n")
    print("| arch | shape | mesh | count_s | args/dev | temp/dev | fits 80GB | collectives |")
    print("|---|---|---|---|---|---|---|---|")
    for r in recs:
        if "skipped" in r:
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | — | "
                  f"skip: full-attn |")
            continue
        m = r["memory"]
        cc = r["roofline"]["collective_counts"]
        cstr = " ".join(f"{k.split('-')[-1] if k != 'all-to-all' else 'a2a'}:{int(v)}"
                        for k, v in sorted(cc.items()))
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('count_s', '-')} "
              f"| {_fmt_b(m['argument_bytes_per_device'])} "
              f"| {_fmt_b(m['temp_bytes_per_device'])} "
              f"| {'yes' if m['fits_80gb_hbm'] else 'NO'} | {cstr} |")

    print("\n### Roofline table (single pod 16x16 = 256 H100s; seconds/step/device)\n")
    print("| arch | shape | compute_s | memory_s | collective_s | dominant | "
          "MODEL_FLOPS/dev | counted/model ratio | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        if r["mesh"] != "pod1" or "skipped" in r:
            continue
        rl = r["roofline"]
        dom_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        peak = RL.INT32_OPS_PER_S if r["kind"] == "fhe" else RL.PEAK_FLOPS
        ideal = rl["model_flops"] / peak
        frac = ideal / dom_s if dom_s > 0 else 0.0
        print(f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4g} | "
              f"{rl['memory_s']:.4g} | {rl['collective_s']:.4g} | "
              f"**{rl['dominant']}** | {rl['model_flops']:.3g} | "
              f"{1 / rl['useful_ratio'] if rl['useful_ratio'] else 0:.1f}x | "
              f"{frac * 100:.1f}% |")

    print("\n### Multi-pod delta (pod2 = 2x16x16; cross-pod axis = DP)\n")
    print("| arch | shape | coll_s pod1 | coll_s pod2 | pod2/pod1 |")
    print("|---|---|---|---|---|")
    by_key = {(r["arch"], r["shape"], r["mesh"]): r for r in recs if "skipped" not in r}
    seen = set()
    for (a, s, m), r in sorted(by_key.items()):
        if (a, s) in seen or (a, s, "pod2") not in by_key or (a, s, "pod1") not in by_key:
            continue
        seen.add((a, s))
        c1 = by_key[(a, s, "pod1")]["roofline"]["collective_s"]
        c2 = by_key[(a, s, "pod2")]["roofline"]["collective_s"]
        print(f"| {a} | {s} | {c1:.4g} | {c2:.4g} | {c2 / c1 if c1 else 0:.2f} |")


# -------------------------------------------------------------- main

def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS + ["sce-ntt"], default=None)
    ap.add_argument("--shape", choices=list(SHAPES) + list(FHE_SHAPES), default=None)
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--report", action="store_true",
                    help="print the tables of the records in --out and exit")
    args = ap.parse_args(argv)
    if args.report:
        report(args.out)
        return
    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
        cells += [("sce-ntt", s) for s in FHE_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    for arch, shape in cells:
        for mesh in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
            if os.path.exists(path):
                print(f"[skip-existing] {arch} {shape} {mesh}", flush=True)
                continue
            print(f"[cell] {arch} {shape} {mesh} ...", flush=True)
            rec = run_cell(arch, shape, mesh)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            dom = rec.get("roofline", {}).get("dominant", "-")
            print(f"[ok] {arch} {shape} {mesh} "
                  f"count={rec.get('count_s', '-')}s dominant={dom}", flush=True)
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
