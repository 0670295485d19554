"""Batched serving demo on the PyTorch port: prefill + decode with KV
caches through the ServeEngine (slot-based continuous-batching-lite) on
a reduced config.

Runs on the card unless ``--device`` names another device.

Run:  PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.convert import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    cfg = smoke_config("qwen3-32b")            # reduced same-family config
    model = build_model(cfg, device=dev)       # weights drawn from seed 0
    engine = ServeEngine(model, batch_size=4, max_len=96)

    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 12 + i).astype(np.int32),
                    max_new=8) for i in range(6)]
    out = engine.run(reqs)
    for rid in sorted(out):
        print(f"req {rid}: prompt_len={len(reqs[rid].prompt)} -> tokens {out[rid]}")
    assert all(len(v) == 8 for v in out.values())
    print("[ok] 6 requests served in 2 waves of batch 4")
    return out


if __name__ == "__main__":
    main()
