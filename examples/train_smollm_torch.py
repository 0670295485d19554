"""End-to-end driver on the PyTorch port: train the full-width
smollm-135m (the ~100M-class assigned arch) for a few hundred steps on
the synthetic-but-structured markov corpus, with WSD schedule, remat,
async checkpointing, resume, and the straggler watchdog — the whole
train substrate in one script.

Runs on the card unless ``--device`` names another device; ``--smoke``
trains the reduced same-family config instead (a CPU run at full width
takes seconds a step).  Loss must decrease.

Run:  PYTHONPATH=src python examples/train_smollm_torch.py --steps 200
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import TrainConfig


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "smollm_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced same-family config")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    cfg = smoke_config("smollm-135m") if args.smoke else get_config("smollm-135m")
    model = build_model(cfg, device=resolve_device(args.device))
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=3e-4, schedule="wsd", warmup_steps=20,
                        total_steps=args.steps),
        remat_policy="full",
    )
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    lcfg = LoopConfig(steps=args.steps, ckpt_every=50, ckpt_dir=args.ckpt_dir)
    params, state, losses = train_loop(model, tcfg, lcfg, dcfg)
    print(f"[done] loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")
    assert losses[-1] < losses[0], "training did not reduce loss"
    return losses


if __name__ == "__main__":
    main()
