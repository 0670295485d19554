"""Training launcher: pick an assigned architecture and train it with the
fault-tolerant loop (checkpoints/resume/watchdog) on one device — the
card unless ``--device`` names another — or on a production mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --seq 128 --batch 4

``--mesh pod1`` / ``pod2`` trains on the reference's production meshes
(``launch/mesh.py``: 16 x 16, or 2 x 16 x 16) over the visible cards,
or over ``--device`` listed once per shard (the shards then run in turn
on it).  ``main(argv)`` takes the argument list, so a script can call
it in process.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import make_mesh_ctx
from repro_torch.models.common import MeshCtx
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig


def main(argv: list[str] | None = None) -> list[float]:
    """Trains as the arguments say, prints the reference's last line and
    returns the losses of the steps this call ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "linear", "const"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "bf16", "int8_ef"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--mesh", choices=["none", "pod1", "pod2"], default="none")
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the card); with --mesh, "
                         "the device every shard runs on")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.mesh == "none":
        mctx = MeshCtx()
    else:
        multi_pod = args.mesh == "pod2"
        devices = None if args.device is None else [args.device] * (512 if multi_pod else 256)
        mctx = make_mesh_ctx(multi_pod=multi_pod, devices=devices)
    # on a mesh the model lives on its first device
    model = build_model(cfg, mctx, device=None if mctx.mesh else args.device)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, schedule=args.schedule,
                        warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
        microbatches=args.microbatches,
        remat_policy=args.remat,
        grad_compression=args.grad_compression,
    )
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    lcfg = LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir)
    _, _, losses = train_loop(model, tcfg, lcfg, dcfg)
    # a run resumed at its last step trains no step and has no losses
    first, last = (f"{losses[0]:.4f}", f"{losses[-1]:.4f}") if losses else ("-", "-")
    print(f"[train] {args.arch}: loss {first} -> {last} "
          f"({args.steps} steps, {1 if mctx.mesh is None else len(mctx.mesh.devices)} "
          "device(s))")
    return losses


if __name__ == "__main__":
    main()
