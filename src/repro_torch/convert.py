"""Choosing the device an entry point runs on, moving uint32 and uint16
host arrays onto it, and the reference's state across into the port:
integer packs through ``from_reference``, model weights through
``params_from_reference``, a train state through
``train_state_from_reference``.

The lane rule: residues and the full-word constants are stored as
``torch.int32`` tensors that hold the uint32 bit pattern
(``np.uint32 -> .view(np.int32)``).  Residues are below 2^31, so their
int32 value is the residue itself; constants such as Shoup companions
and Barrett mu may use the top bit, and the kernels read them back as
``uint32_t`` (the plain versions widen them with ``& 0xFFFFFFFF``).
The 16-bit lane of small rings (ML-KEM) follows the same rule one size
down: ``np.uint16 -> torch.int16`` bit patterns, read back as
``uint16_t`` by the kernels and with ``& 0xFFFF`` by the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  With no argument and no card this raises; it never
    carries on on the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def u32_to_tensor(a, device) -> torch.Tensor:
    """uint32 array (or any array convertible to one) -> int32 bit-pattern
    tensor on ``device``.  Accepts anything ``np.asarray`` reads, so the
    reference's device arrays convert without importing their framework."""
    arr = np.asarray(a)
    if arr.dtype != np.uint32:
        if arr.dtype.kind not in "iu":
            raise TypeError(f"u32_to_tensor: integer array expected, got {arr.dtype}")
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFFFFFF):
            raise ValueError("u32_to_tensor: values outside the uint32 range")
        arr = arr.astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32).copy()).to(device)


def tensor_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> uint32 numpy array on the host."""
    if t.dtype != torch.int32:
        raise TypeError(f"tensor_to_u32: int32 tensor expected, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def u16_to_tensor(a, device) -> torch.Tensor:
    """uint16 array (or any integer array with values in the uint16
    range) -> int16 bit-pattern tensor on ``device``."""
    arr = np.asarray(a)
    if arr.dtype != np.uint16:
        if arr.dtype.kind not in "iu":
            raise TypeError(f"u16_to_tensor: integer array expected, got {arr.dtype}")
        if arr.size and (arr.min() < 0 or arr.max() > 0xFFFF):
            raise ValueError("u16_to_tensor: values outside the uint16 range")
        arr = arr.astype(np.uint16)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).to(device)


def tensor_to_u16(t: torch.Tensor) -> np.ndarray:
    """int16 bit-pattern tensor -> uint16 numpy array on the host."""
    if t.dtype != torch.int16:
        raise TypeError(f"tensor_to_u16: int16 tensor expected, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint16)


def from_reference(tree, device):
    """The reference's state, carried across: a TablePack / FourStepPack /
    scalar-pack / ring-pack dict, stacked key digits, or ciphertext
    residue stacks — any nest of dicts, lists and tuples of uint32 or
    uint16 arrays — becomes the same nest of bit-pattern tensors on
    ``device``: int16 for a uint16 leaf (the small-ring lane), int32 for
    any other."""
    if isinstance(tree, dict):
        return {k: from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_reference(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.uint16:
        return u16_to_tensor(arr, device)
    return u32_to_tensor(arr, device)


def params_from_reference(tree, device, dtype=None) -> dict[str, torch.Tensor]:
    """The reference's float parameter tree (``Model.init``'s nest of
    dicts, each block leaf stacked over layers, groups or tail) as the
    port's ``models.model.Model`` state: a flat dict keyed by the tree's
    paths joined with dots, for ``Model.load_state_dict``.  Each leaf
    keeps its float dtype (bfloat16 included) unless ``dtype`` names
    another.  Integer leaves are refused: those are ``from_reference``'s."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
            t = t.view(torch.bfloat16)
        elif arr.dtype.kind == "f":
            t = torch.from_numpy(np.ascontiguousarray(arr).copy())
        else:
            raise TypeError(f"params_from_reference: {'.'.join(path)} is "
                            f"{arr.dtype}, not a float array")
        out[".".join(path)] = t.to(device=device, dtype=dtype or t.dtype)

    walk(tree, ())
    return out


def train_state_from_reference(tree, device) -> dict:
    """The reference's train state (``init_train_state``'s or a train
    step's nest of dicts: ``opt`` with ``step``, the moments ``m`` / ``v``
    as float32 arrays or int8 ``{"q", "scale"}``, and ``err`` under
    ``int8_ef``) as the same nest of tensors on ``device``, each leaf
    keeping its dtype (int32, float32, int8), so the port's train step
    continues from it."""
    if isinstance(tree, dict):
        return {k: train_state_from_reference(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype not in (np.float32, np.int32, np.int8):
        raise TypeError(f"train_state_from_reference: a {arr.dtype} leaf; the "
                        "state holds float32, int32 and int8 arrays")
    return torch.from_numpy(np.array(arr, order="C")).to(device)   # 0-d stays 0-d
