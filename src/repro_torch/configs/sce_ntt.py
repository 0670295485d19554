"""The paper's own workload config: NTT-128 / four-step 2^14 / CKKS
key-switch batch shapes for the SCE-NTT dry-run cells (see launch/dryrun).
Not an LM; `CONFIG` carries the ring geometry.
Values copied word for word from the reference's
`src/repro/configs/sce_ntt.py:7-18`."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SceNttConfig:
    name: str = "sce-ntt"
    family: str = "fhe"
    ring_n: int = 128            # the fabricated NTT-128 unit
    large_n1: int = 128          # 2^14 = 128 x 128 four-step (paper §IX)
    large_n2: int = 128
    rns_limbs: int = 8           # L+1 = 8 (paper Fig 22)
    batch: int = 4096            # polynomials streamed per step


CONFIG = SceNttConfig()
