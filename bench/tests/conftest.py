"""CPU tests of the benchmark's harness and reference.  Puts ``bench/``
and ``src/`` on the path; ``tiny_checkout`` builds a checkout whose
``BENCHMARK.json`` holds the real cells and tiny twins of them (n =
1024, a few requests), made only of new files and entries, as a later
cell would be."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

# one thread a test process: the CPU tests run under several workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "bench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# tiny twin -> (configuration, traffic mix, the cell whose metrics it
# reports, configuration changes, traffic changes)
TINY = {
    "tiny-keyswitch": ("ckks-fig22", "keyswitch_backlog", "fig22-keyswitch",
                       {"n": 1024, "levels": 3},
                       {"chunk": 64, "pool": 16, "warm_requests": 16, "profile_s": 0.3,
                        "keep_per_chunk": 32, "sample_per_slot": 1}),
    "tiny-matvec": ("ckks-fig22", "matvec_backlog", "fig22-matvec", {"n": 1024, "levels": 3},
                    {"chunk": 4, "pool": 4, "matrix": [4, 4], "warm_requests": 1,
                     "profile_s": 0.3, "keep_per_chunk": 2, "sample_per_slot": 4}),
    "tiny-ntt": ("ntt128-unit", "ntt_batches", "ntt128-batch", {},
                 {"rows": 1000, "pool": 2, "sample_every": 5, "sample_rows": 16,
                  "profile_s": 0.2}),
}


def make_tiny_checkout(dest: Path) -> Path:
    """A checkout at ``dest``: a copy of ``bench/``, the program linked,
    and ``BENCHMARK.json`` with the tiny twins added."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "src").symlink_to(ROOT / "src")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}
    for name, (config, traffic, like, cfg_upd, mix_upd) in TINY.items():
        cfg_name = f"{config}-{name}"
        cfg = json.loads((ROOT / configs[config]["file"]).read_text())
        cfg.update(cfg_upd, reduced=sorted(cfg_upd))
        (dest / "bench" / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
        mix = json.loads((ROOT / "bench" / "traffic" / f"{traffic}.json").read_text())
        mix.update(mix_upd)
        (dest / "bench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        spec["configs"].append(dict(configs[config], name=cfg_name,
                                    file=f"bench/configs/{cfg_name}.json",
                                    reduced=sorted(cfg_upd)))
        spec["workloads"].append({"name": name, "config": cfg_name, "traffic": name,
                                  "chips": 1, "why": "a tiny twin for the CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory) -> Path:
    return make_tiny_checkout(tmp_path_factory.mktemp("checkout"))
