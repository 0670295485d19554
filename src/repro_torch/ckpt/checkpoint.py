"""Numpy checkpoints of nests of dicts of tensors, with atomic commit,
async save, an integrity manifest and placement on load: the reference's
layout, so a checkpoint written by either package restores in the other.

Layout:  <dir>/step_000123/  manifest.json + leaf_<i>.npy
The leaves are numbered in sorted-key order and each manifest entry
carries the leaf's ``jax.tree_util.keystr`` path (``['params']['ln_f']
['w']``), its shape, dtype and the first 16 hex digits of the file's
sha256.  Commit protocol: write into ``<dir>/.tmp_<step>`` then
os.rename — a crashed save never shadows the latest valid checkpoint
(restore scans descending and verifies every file's checksum).
``AsyncCheckpointer.save_async`` copies every leaf to host memory before
its thread starts; the thread only writes files.

A bfloat16 leaf: numpy has no bfloat16 of its own, so the port writes
its bit pattern as ``uint16`` and names the dtype ``bfloat16`` in the
manifest; ``restore`` reads it back into ``torch.bfloat16``, from the
port's files and from a reference file whose two-byte elements load as
an unnamed type.  float32, int32 and int8 leaves are the reference's
bytes exactly.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import tree as T


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy, never a view of the
    tensor's storage); bfloat16 as its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _write(ckpt_dir: str, step: int, flat) -> str:
    """Writes [(path, host array, dtype name)] as checkpoint ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, arr, dtype) in enumerate(flat):
        fn = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({
            "key": T.keystr(path),
            "file": fn, "shape": list(arr.shape), "dtype": dtype,
            "sha": _sha(os.path.join(tmp, fn)),
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _snapshot(tree) -> list:
    out = []
    for path, leaf in T.flatten_with_path(tree):
        arr = _host(leaf)
        out.append((path, arr, _dtype_name(leaf, arr)))
    return out


def save(ckpt_dir: str, step: int, tree) -> str:
    return _write(ckpt_dir, step, _snapshot(tree))


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree) -> None:
        self.wait()
        flat = _snapshot(tree)          # on the host before the thread starts

        def run():
            try:
                _write(self.ckpt_dir, step, flat)
                self._gc()
            except BaseException as e:   # re-raised by wait()
                self._error = e
                raise
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Joins the pending save; raises what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            out.append(int(d[5:]))
    return sorted(out)


def _verify(path: str, manifest: dict) -> bool:
    for leaf in manifest["leaves"]:
        fp = os.path.join(path, leaf["file"])
        if not os.path.exists(fp):
            return False
        if _sha(fp) != leaf["sha"]:
            return False
    return True


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.array(arr, order="C")        # a copy; a 0-d leaf stays 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def restore(ckpt_dir: str, target_tree, step: int | None = None, device=None):
    """Restore into the structure of ``target_tree`` -> (step, tree of
    tensors).  Each leaf goes to ``device``, or to its target leaf's
    device where none is given.  Skips corrupt checkpoints (descending) —
    the fault-tolerant resume path — and raises FileNotFoundError where
    none is valid."""
    found = restore_latest(ckpt_dir, target_tree, step, device)
    if found is None:
        raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
    return found


def restore_latest(ckpt_dir: str, target_tree, step: int | None = None, device=None):
    """``restore``, or None where no checkpoint is valid."""
    steps = list_steps(ckpt_dir)
    if step is not None:
        steps = [s for s in steps if s == step]
    flat = T.flatten_with_path(target_tree)
    for s in reversed(steps):
        path = os.path.join(ckpt_dir, f"step_{s:09d}")
        mpath = os.path.join(path, "manifest.json")
        if not os.path.isfile(mpath):
            continue
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except json.JSONDecodeError:
            continue
        if not _verify(path, manifest):
            continue
        by_key = {l["key"]: l for l in manifest["leaves"]}
        if any(T.keystr(p) not in by_key for p, _ in flat):
            continue
        leaves = []
        for p, tgt in flat:
            entry = by_key[T.keystr(p)]
            arr = np.load(os.path.join(path, entry["file"]))
            dev = device if device is not None else getattr(tgt, "device", "cpu")
            leaves.append(_to_tensor(arr, entry["dtype"], dev))
        return s, T.unflatten([p for p, _ in flat], leaves)
    return None
