"""Rules the port keeps: it imports neither JAX nor the reference package,
its entry points default to the card and refuse to run without one, and
each kernel wrapper picks its path from the tensor's device alone — the
plain version for a CPU tensor, the kernel or an exception otherwise,
never a fallback."""
import ast
import pathlib

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.fhe import batched as TB
from repro_torch.fhe import rns
from repro_torch.fhe.ckks import CkksContext
from repro_torch.kernels import build, dyadic_kernel, galois_kernel, ntt_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_handler_swallows_a_failure(path):
    """Every ``except`` re-raises, except the float-range fallback of the
    host decode (``OverflowError``), so no kernel or build failure can be
    turned into a plain-version result or a CPU run."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        reraises = any(isinstance(n, ast.Raise) for n in ast.walk(node))
        caught = ast.unparse(node.type) if node.type is not None else "everything"
        assert reraises or caught == "OverflowError", \
            f"{path.name}:{node.lineno} swallows {caught}"


def test_context_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CkksContext(n=16, levels=1)


N = 16
PRIMES = tuple(rns.make_primes(N, 3))


def _wrapper_calls(device):
    """(kernel name, call) for each wrapper on small tensors on ``device``."""
    t = TB.build_table_pack(PRIMES, N, "cpu")
    t = {k: v.to(device) for k, v in t.items()}
    k = len(PRIMES)
    x = torch.zeros((k, 2, N), dtype=torch.int32, device=device)
    ext = torch.zeros((2, k, 2, N), dtype=torch.int32, device=device)
    evk = torch.zeros((2, k, N), dtype=torch.int32, device=device)
    row = torch.arange(N, dtype=torch.int32, device=device)
    rows = torch.stack([row, row.flip(0)])
    flags = dict(negacyclic=True, lazy=True, reduce_out=True)
    return [
        ("ntt_fwd_banks", lambda: ntt_kernel.ntt_fwd_banks(
            x, t["qs"], t["tw"], t["twp"], t["psi"], t["psip"], **flags)),
        ("ntt_inv_banks", lambda: ntt_kernel.ntt_inv_banks(
            x, t["qs"], t["ninv"], t["ninv_p"], t["itw"], t["itwp"],
            t["ipsin"], t["ipsinp"], **flags)),
        ("twiddle_mul_banks", lambda: ntt_kernel.twiddle_mul_banks(
            x, t["qs"], t["psi"], t["psip"], lazy=True)),
        ("dyadic_inner_banks", lambda: dyadic_kernel.dyadic_inner_banks(
            ext, evk, t["qs"], t["mu"], lazy=True)),
        ("galois_banks", lambda: galois_kernel.galois_banks(x, row)),
        ("galois_banks_multi", lambda: galois_kernel.galois_banks_multi(x, rows)),
        ("galois_digits", lambda: galois_kernel.galois_digits(
            ext[:, :, :1].contiguous(), rows, shared=True)),
    ]


WRAPPERS = range(len(_wrapper_calls("cpu")))


@pytest.mark.parametrize("i", WRAPPERS)
def test_cpu_tensor_takes_the_plain_version(i):
    name, call = _wrapper_calls("cpu")[i]
    K.reset_counts()
    out = call()
    assert out.device.type == "cpu" and out.dtype == torch.int32
    assert K.snapshot()[name] == {"launches": 0, "plain_calls": 1}


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """A builder that finds no nvcc and no library built before."""
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_libs", {})


@pytest.mark.parametrize("i", WRAPPERS)
def test_launch_without_nvcc_raises(no_nvcc, i):
    name, call = _wrapper_calls("meta")[i]
    K.reset_counts()
    with pytest.raises(build.BuildError, match="nvcc not found"):
        call()
    assert K.snapshot()[name] == {"launches": 0, "plain_calls": 0}


class _NoLaunch:
    """A loaded library whose launchers must never be reached."""

    def __getattr__(self, fn):
        raise AssertionError(f"{fn} reached on a tensor the kernel does not take")


@pytest.mark.parametrize("i", WRAPPERS)
def test_non_cuda_tensor_is_refused_not_computed(monkeypatch, i):
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    name, call = _wrapper_calls("meta")[i]
    K.reset_counts()
    with pytest.raises(ValueError, match="CUDA tensors expected"):
        call()
    assert K.snapshot()[name] == {"launches": 0, "plain_calls": 0}


def test_oversized_transform_is_refused(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    n = 2 * ntt_kernel.MAX_N
    x = torch.zeros((1, 1, n), dtype=torch.int32, device="meta")
    tw = torch.zeros((1, n.bit_length() - 1, n // 2), dtype=torch.int32, device="meta")
    row = torch.zeros((1, n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="power of two"):
        ntt_kernel.ntt_fwd_banks(x, row[:, 0], tw, tw, row, row, negacyclic=True,
                                 lazy=True, reduce_out=True)


GATHERS = ["galois_banks", "galois_banks_multi", "galois_digits"]


def _gather_call(which, n):
    x = torch.zeros((1, 2, n), dtype=torch.int32, device="meta")
    rows = torch.zeros((2, n), dtype=torch.int32, device="meta")
    return {"galois_banks": lambda: galois_kernel.galois_banks(x, rows[0]),
            "galois_banks_multi": lambda: galois_kernel.galois_banks_multi(x, rows),
            "galois_digits": lambda: galois_kernel.galois_digits(x[None], rows,
                                                                 shared=False)}[which]


@pytest.mark.parametrize("which", GATHERS)
def test_oversized_gather_row_is_refused(monkeypatch, which):
    """A row longer than one block's shared memory holds is refused, never
    computed another way."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    call = _gather_call(which, galois_kernel.MAX_ROW + 4)
    K.reset_counts()
    with pytest.raises(ValueError, match="shared memory"):
        call()
    assert K.snapshot()[which] == {"launches": 0, "plain_calls": 0}


@pytest.mark.parametrize("which", GATHERS)
def test_gather_row_not_a_multiple_of_4_is_refused(monkeypatch, which):
    """The kernel moves rows only as 16-byte vectors."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    call = _gather_call(which, 18)
    K.reset_counts()
    with pytest.raises(ValueError, match="multiple of 4"):
        call()
    assert K.snapshot()[which] == {"launches": 0, "plain_calls": 0}


def test_unaligned_gather_tensor_is_refused():
    words = torch.zeros(20, dtype=torch.int32)
    galois_kernel.check_aligned("w", x=words[4:])
    with pytest.raises(ValueError, match="16-byte boundary"):
        galois_kernel.check_aligned("w", x=words[4:], idx=words[1:17])


def test_library_is_keyed_by_its_sources():
    a, b = build.library_path("ntt_banks"), build.library_path("dyadic_inner")
    assert a.parent == build.BUILD_DIR and a.name != b.name
    assert a == build.library_path("ntt_banks")
    assert set(build.SIGNATURES) == set(build.SOURCES)
