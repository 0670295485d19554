"""Rules the port keeps: it imports neither JAX nor the reference package,
its entry points default to the card and refuse to run without one, and
each kernel wrapper picks its path from the tensor's device alone — the
plain version for a CPU tensor, the kernel or an exception otherwise,
never a fallback."""
import ast
import pathlib
import re

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.convert import from_reference
from repro_torch.core.params import make_ntt_params
from repro_torch.core.ringspec import MLKEM_RING, ring_table_pack
from repro_torch.fhe import batched as TB
from repro_torch.fhe import rns
from repro_torch.fhe.ckks import CkksContext
from repro_torch.kernels import build, dyadic_kernel, galois_kernel, ntt_kernel, ops

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
    host decode (``OverflowError``) and the tile tuner's skip of a cache
    sidecar that is not JSON (``json.JSONDecodeError``, as the reference
    skips it), so no kernel or build failure can be turned into a
    plain-version result or a CPU run."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        reraises = any(isinstance(n, ast.Raise) for n in ast.walk(node))
        caught = ast.unparse(node.type) if node.type is not None else "everything"
        assert reraises or caught in ("OverflowError", "json.JSONDecodeError"), \
            f"{path.name}:{node.lineno} swallows {caught}"


def test_context_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CkksContext(n=16, levels=1)


N = 16
PRIMES = tuple(rns.make_primes(N, 3))
P1 = make_ntt_params(N)                 # one 30-bit prime: the single-prime ops


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
    r = from_reference(ring_table_pack(MLKEM_RING), device)
    x16 = torch.zeros((1, 3, MLKEM_RING.n), dtype=torch.int16, device=device)
    rflags = dict(negacyclic=False, lazy=True, reduce_out=True)
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
        ("ntt_fwd_banks_u16", lambda: ntt_kernel.ntt_fwd_banks(
            x16, r["qs"], r["tw"], r["twp"], r["psi"], r["psip"], **rflags)),
        ("ntt_inv_banks_u16", lambda: ntt_kernel.ntt_inv_banks(
            x16, r["qs"], r["ninv"], r["ninv_p"], r["itw"], r["itwp"],
            r["ipsin"], r["ipsinp"], **rflags)),
        ("dyadic_basemul_banks", lambda: dyadic_kernel.dyadic_basemul_banks(
            x16, x16, r["qs"], r["mu"], r["gamma"], r["gammap"], lazy=True)),
        *_single_prime_calls(torch.zeros((2, N), dtype=torch.int32, device=device),
                             P1).items(),
    ]


def _single_prime_calls(x, p):
    """The four single-prime wrappers on rows ``x`` of ring ``p``."""
    return {
        "ntt_fwd": lambda: ntt_kernel.ntt_fwd(x, p, negacyclic=True, lazy=True),
        "ntt_inv": lambda: ntt_kernel.ntt_inv(x, p, negacyclic=True, lazy=True),
        "dyadic_mul": lambda: dyadic_kernel.dyadic_mul(x, x, q=p.q, mu=p.barrett_mu,
                                                       lazy=True),
        "dyadic_mac": lambda: dyadic_kernel.dyadic_mac(x, x, x, q=p.q, mu=p.barrett_mu,
                                                       lazy=True),
    }


WRAPPERS = range(len(_wrapper_calls("cpu")))


@pytest.mark.parametrize("i", WRAPPERS)
def test_cpu_tensor_takes_the_plain_version(i):
    name, call = _wrapper_calls("cpu")[i]
    K.reset_counts()
    out = call()
    lane = torch.int16 if name.endswith("_u16") or "basemul" in name else torch.int32
    assert out.device.type == "cpu" and out.dtype == lane
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
    """Above MAX_N = 2^17 the column pass would hold more than 32 words a
    thread: the banks refuse the ring with the limit named."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    n = 2 * ntt_kernel.MAX_N
    x = torch.zeros((1, 1, n), dtype=torch.int32, device="meta")
    tw = torch.zeros((1, n.bit_length() - 1, n // 2), dtype=torch.int32, device="meta")
    row = torch.zeros((1, n), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="power of two in \\[2, 131072\\]"):
        ntt_kernel.ntt_fwd_banks(x, row[:, 0], tw, tw, row, row, negacyclic=True,
                                 lazy=True, reduce_out=True)


@pytest.mark.parametrize("which", ["ntt_fwd_banks", "ntt_inv_banks"])
def test_u16_transform_above_4096_is_refused(monkeypatch, which):
    """No u16 ring has n > 4096 (q < 2^12, 2n/block | q - 1 with block at
    most 2), so the u16 lane refuses it with that reason."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    n = 8192
    x = torch.zeros((1, 1, n), dtype=torch.int16, device="meta")
    tw = torch.zeros((1, 7, n // 2), dtype=torch.int16, device="meta")
    row = torch.zeros((1, n), dtype=torch.int16, device="meta")
    one = row[:, 0]
    call = {"ntt_fwd_banks": lambda: ntt_kernel.ntt_fwd_banks(
                x, one, tw, tw, row, row, negacyclic=False, lazy=True, reduce_out=True),
            "ntt_inv_banks": lambda: ntt_kernel.ntt_inv_banks(
                x, one, one, one, tw, tw, row, row, negacyclic=False, lazy=True,
                reduce_out=True)}[which]
    K.reset_counts()
    with pytest.raises(ValueError, match="u16 lane"):
        call()
    assert all(c == {"launches": 0, "plain_calls": 0} for c in K.snapshot().values())


GATHERS = ["galois_banks", "galois_banks_multi", "galois_digits"]


def _gather_call(which, n):
    x = torch.zeros((1, 2, n), dtype=torch.int32, device="meta")
    rows = torch.zeros((2, n), dtype=torch.int32, device="meta")
    return {"galois_banks": lambda: galois_kernel.galois_banks(x, rows[0]),
            "galois_banks_multi": lambda: galois_kernel.galois_banks_multi(x, rows),
            "galois_digits": lambda: galois_kernel.galois_digits(x[None], rows,
                                                                 shared=False)}[which]


class _FakeCuda(torch.Tensor):
    """A meta tensor that reports a CUDA device, so a wrapper takes its
    kernel path on a machine with no card; every op runs on the meta
    tensor underneath (data pointer 0, so 16-byte aligned) and a tensor
    it returns is one again."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        plain = lambda a: a.as_subclass(torch.Tensor) if isinstance(a, cls) else a
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*map(plain, args), **{k: plain(v) for k, v in (kwargs or {}).items()})
            return out.as_subclass(cls) if type(out) is torch.Tensor else out

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Recorder:
    """A loaded library whose launchers record (name, n) and succeed."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        def launcher(*args):
            self.calls.append((fn, args))
            return 0
        return launcher


@pytest.mark.parametrize("which", GATHERS)
def test_gather_row_above_max_row_reaches_its_launcher(monkeypatch, which):
    """A row longer than one block's shared memory holds (MAX_ROW) passes
    every check of the wrapper and reaches its launcher once (the launcher
    passes it through a ring of pieces, or for galois_banks gives it the
    split-row body): no refusal, no plain version."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(galois_kernel, "stream", lambda: 0)
    n = galois_kernel.MAX_ROW + 4
    fake = lambda shape: torch.zeros(shape, dtype=torch.int32,
                                     device="meta").as_subclass(_FakeCuda)
    x, rows = fake((1, 2, n)), fake((2, n))
    call = {"galois_banks": lambda: galois_kernel.galois_banks(x, fake((n,))),
            "galois_banks_multi": lambda: galois_kernel.galois_banks_multi(x, rows),
            "galois_digits": lambda: galois_kernel.galois_digits(
                fake((1, 1, 2, n)), rows, shared=False)}[which]
    K.reset_counts()
    out = call()
    assert out.shape[-1] == n
    # n is the launcher's sixth argument, the seventh for galois_digits
    launched = [(fn, args[6] if fn == "galois_digits" else args[5])
                for fn, args in lib.calls]
    assert launched == [(which, n)]
    assert K.snapshot()[which] == {"launches": 1, "plain_calls": 0}


def _fake(*shape):
    return torch.zeros(shape, dtype=torch.int32, device="meta").as_subclass(_FakeCuda)


@pytest.mark.parametrize("n", [1 << 14, galois_kernel.MAX_ROW + 4, 1 << 16, 1 << 17])
@pytest.mark.parametrize("mode", ["multi", "digits shared", "digits"])
def test_staged_gathers_hand_their_launcher_the_shape(monkeypatch, mode, n):
    """galois_banks_multi and galois_digits (fan-out and per-row) reach
    their launcher at the path's 2^14 (a whole row staged), past MAX_ROW
    and at 2^16 and 2^17 (the piece ring): no refusal, no plain version,
    one launch, and the launcher gets the tensors' k, B, n (and d and the
    shared flag) after the three pointers."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(galois_kernel, "stream", lambda: 0)
    d, k, b = 2, 3, 8
    rows = _fake(b, n)
    K.reset_counts()
    if mode == "multi":
        out = galois_kernel.galois_banks_multi(_fake(k, b, n), rows)
        want = ("galois_banks_multi", (k, b, n, 0))
    else:
        shared = mode == "digits shared"
        out = galois_kernel.galois_digits(_fake(d, k, 1 if shared else b, n), rows,
                                          shared=shared)
        want = ("galois_digits", (d, k, b, n, int(shared), 0))
    assert out.shape == ((k, b, n) if mode == "multi" else (d, k, b, n))
    assert [(fn, args[3:]) for fn, args in lib.calls] == [want]
    assert K.snapshot()[want[0]] == {"launches": 1, "plain_calls": 0}


@pytest.mark.parametrize("n", [8192, 16384, 1 << 15, 1 << 16, 1 << 17])
def test_banks_transform_above_4096_reaches_its_launcher(monkeypatch, n):
    """The u32 banks transforms take n up to 2^17 (two passes through a
    scratch tensor above 4096 words): the checks pass and each launcher
    is reached once with that n and a scratch tensor's pointer."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(ntt_kernel, "stream", lambda: 0)
    scratch = []
    monkeypatch.setattr(ntt_kernel, "_scratch",
                        lambda x: scratch.append(tuple(x.shape)) or x)
    x, row, one, tw = _fake(2, 3, n), _fake(2, n), _fake(2), _fake(2, 7, n // 2)
    flags = dict(negacyclic=False, lazy=True, reduce_out=True)
    K.reset_counts()
    ntt_kernel.ntt_fwd_banks(x, one, tw, tw, row, row, **flags)
    ntt_kernel.ntt_inv_banks(x, one, one, one, tw, tw, row, row, **flags)
    # n follows the pointers and k, b: argument 9 forward, 11 inverse; the
    # scratch pointer is the launcher's last but one
    assert [(fn, args[9 if "fwd" in fn else 11], len(args)) for fn, args in lib.calls] == [
        ("ntt_fwd_banks", n, 16), ("ntt_inv_banks", n, 18)]
    assert scratch == [(2, 3, n)] * 2
    c = K.snapshot()
    assert c["ntt_fwd_banks"]["launches"] == c["ntt_inv_banks"]["launches"] == 1


def test_banks_scratch_only_above_one_launchs_ring():
    """Up to 4096 words one launch transforms a ring and no scratch is
    allocated; above it the two passes get one of x's shape."""
    assert ntt_kernel._scratch(torch.zeros((1, 2, ntt_kernel.MAX_N_ROW),
                                           dtype=torch.int32)) is None
    x = torch.zeros((1, 2, 2 * ntt_kernel.MAX_N_ROW), dtype=torch.int16)
    s = ntt_kernel._scratch(x)
    assert s.shape == x.shape and s.dtype == x.dtype


@pytest.mark.parametrize("which", GATHERS)
def test_gather_row_not_a_multiple_of_4_reaches_its_launcher(monkeypatch, which):
    """A row of 18 words (not a whole number of 16-byte vectors) passes
    every check of the wrapper and reaches its launcher once, which gives
    it the one-word body: no refusal, no plain version."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(galois_kernel, "stream", lambda: 0)
    n = 18
    x, rows = _fake(1, 2, n), _fake(2, n)
    call = {"galois_banks": lambda: galois_kernel.galois_banks(x, rows[0]),
            "galois_banks_multi": lambda: galois_kernel.galois_banks_multi(x, rows),
            "galois_digits": lambda: galois_kernel.galois_digits(x[None], rows,
                                                                 shared=False)}[which]
    K.reset_counts()
    assert call().shape[-1] == n
    launched = [(fn, args[6] if fn == "galois_digits" else args[5])
                for fn, args in lib.calls]
    assert launched == [(which, n)]
    assert K.snapshot()[which] == {"launches": 1, "plain_calls": 0}


def test_unaligned_gather_views_reach_the_launcher(monkeypatch):
    """x and idx views that start one word past a 16-byte boundary reach
    the launcher as they are (it takes the one-word body for them)."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(galois_kernel, "stream", lambda: 0)
    n = 16
    x = _fake(2 * n + 1)[1:].view(1, 2, n)
    idx = _fake(n + 1)[1:]
    assert x.data_ptr() % 16 and idx.data_ptr() % 16
    K.reset_counts()
    galois_kernel.galois_banks(x, idx)
    ((fn, args),) = lib.calls
    assert fn == "galois_banks" and args[:2] == (x.data_ptr(), idx.data_ptr())
    assert K.snapshot()["galois_banks"] == {"launches": 1, "plain_calls": 0}


@pytest.mark.parametrize("which", ["shared row", "per-batch rows", "digits"])
def test_non_contiguous_gather_idx_is_made_contiguous(monkeypatch, which):
    """ops.galois_banks / galois_digits_banks hand the launcher a contiguous
    copy of an idx that is not (a transposed or strided view), so the card
    takes every idx layout the reference takes."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(galois_kernel, "stream", lambda: 0)
    n, b = 16, 2
    x = _fake(1, b, n)
    call = {"shared row": lambda idx: ops.galois_banks(x, idx[0]),
            "per-batch rows": lambda idx: ops.galois_banks(x, idx),
            "digits": lambda idx: ops.galois_digits_banks(x[None], idx)}[which]
    idx = _fake(n, b).t()                      # (b, n), not contiguous
    assert not idx.is_contiguous() and not idx[0].is_contiguous()
    K.reset_counts()
    call(idx)
    assert len(lib.calls) == 1
    assert sum(c["launches"] for c in K.snapshot().values()) == 1


def test_library_is_keyed_by_its_sources():
    a, b = build.library_path("ntt_banks"), build.library_path("dyadic_inner")
    assert a.parent == build.BUILD_DIR and a.name != b.name
    assert a == build.library_path("ntt_banks")
    assert set(build.SIGNATURES) == set(build.SOURCES)


@pytest.mark.parametrize("source", build.SOURCES)
def test_every_signature_names_a_launcher_of_its_source(source):
    """Each declared C signature is an ``extern "C"`` launcher of its own
    source, and each launcher of the source is declared."""
    text = (build.CSRC / f"{source}.cu").read_text()
    launchers = set(re.findall(r'extern "C" int (\w+)\(', text))
    assert launchers == set(build.SIGNATURES[source])


# a variable a function keeps from one call to the next: `static`, a type,
# a name, its array dimensions, then `=` or `;` (not a function or cast)
STATIC_STATE = re.compile(r"^\s*static\s+(?:const\s+)?[\w:]+\s+(\w+)\s*((?:\[[^\]]*\])*)\s*[=;]",
                          re.M)
CSRC_FILES = sorted(build.CSRC.glob("*.cu")) + sorted(build.CSRC.glob("*.cuh"))


@pytest.mark.parametrize("path", CSRC_FILES, ids=lambda p: p.name)
def test_launchers_keep_no_state_for_the_whole_process(path):
    """What a launcher keeps between launches (the shared-memory opt-in
    above 48 KB, resident blocks a SM, the SM count) holds for one card,
    since cudaFuncSetAttribute and the occupancy and attribute queries act
    on the current device only: every such static is an array indexed
    first by the device, and a source that opts in keeps its flag so."""
    text = path.read_text()
    state = dict(STATIC_STATE.findall(text))
    for name, dims in state.items():
        assert dims.startswith(("[host::kMaxDevices]", "[kMaxDevices]")), (name, dims)
    if "cudaFuncSetAttribute(" in text:
        assert state.get("opted_in", "").startswith("[host::kMaxDevices]")


def test_every_launcher_state_is_seen():
    """The pattern above finds every per-card state of the sources, so the
    per-file rule has something to hold."""
    found = {(f.name, name) for f in CSRC_FILES for name, _ in STATIC_STATE.findall(f.read_text())}
    assert found == {("host.cuh", "sms"), ("galois.cu", "opted_in"), ("ntt.cu", "opted_in"),
                     ("ntt.cu", "per_sm"), ("ntt.cu", "sizes"), ("ntt_banks.cu", "cached_per_sm"),
                     ("ntt_banks.cu", "cached_smem")}


def _mixed_calls(device):
    """Each lane-generic wrapper given an int16 pack and an int32 tensor."""
    r = from_reference(ring_table_pack(MLKEM_RING), device)
    x32 = torch.zeros((1, 3, MLKEM_RING.n), dtype=torch.int32, device=device)
    x16 = x32.to(torch.int16)
    flags = dict(negacyclic=False, lazy=True, reduce_out=True)
    return {
        "ntt_fwd_banks": lambda: ntt_kernel.ntt_fwd_banks(
            x32, r["qs"], r["tw"], r["twp"], r["psi"], r["psip"], **flags),
        "ntt_inv_banks": lambda: ntt_kernel.ntt_inv_banks(
            x32, r["qs"], r["ninv"], r["ninv_p"], r["itw"], r["itwp"],
            r["ipsin"], r["ipsinp"], **flags),
        "dyadic_basemul_banks": lambda: dyadic_kernel.dyadic_basemul_banks(
            x16, x32, r["qs"], r["mu"], r["gamma"], r["gammap"], lazy=True),
    }


@pytest.mark.parametrize("which", ["ntt_fwd_banks", "ntt_inv_banks",
                                   "dyadic_basemul_banks"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_mixed_lanes_are_refused(monkeypatch, which, device):
    """A u16 pack run through the u32 formulas would give wrong numbers
    with no error, so a call mixing int16 and int32 is refused on every
    device, before any kernel or plain version runs."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    call = _mixed_calls(device)[which]
    K.reset_counts()
    with pytest.raises(ValueError, match="every tensor must be int32"):
        call()
    assert all(c == {"launches": 0, "plain_calls": 0} for c in K.snapshot().values())


def test_basemul_refuses_the_u32_lane():
    t = TB.build_table_pack(PRIMES, N, "cpu")
    x = torch.zeros((len(PRIMES), 2, N), dtype=torch.int32)
    g = t["psi"][:, : N // 2].contiguous()
    with pytest.raises(ValueError, match="int16"):
        dyadic_kernel.dyadic_basemul_banks(x, x, t["qs"], t["mu"], g, g, lazy=True)


SINGLE = ["ntt_fwd", "ntt_inv", "dyadic_mul", "dyadic_mac"]


def _fake_single_prime_bank(monkeypatch, p):
    """``single_prime_bank`` returning prime ``p``'s tables as fake CUDA
    tensors, with stand-ins for the thread-major copies the library
    builds on a card."""
    real = dict(ntt_kernel.single_prime_bank(p, "meta"))
    for dst, src in (("twt", "tw"), ("twpt", "twp"), ("itwt", "itw"), ("itwpt", "itwp")):
        real.setdefault(dst, real[src])
    monkeypatch.setattr(ntt_kernel, "single_prime_bank",
                        lambda p, device: {k: v.as_subclass(_FakeCuda)
                                           for k, v in real.items()})


def _banks_route(lib, which, b, n):
    """The one call a single-prime transform on the banks route makes:
    the u32 banks launcher with k = 1 and (B, n), counted there and not
    on the single-prime kernel."""
    bank = "ntt_fwd_banks" if which == "ntt_fwd" else "ntt_inv_banks"
    fn, args = lib.calls[0]
    assert len(lib.calls) == 1 and fn == bank
    kbn = args[7:10] if which == "ntt_fwd" else args[9:12]
    assert tuple(kbn) == (1, b, n)
    c = K.snapshot()
    assert c[bank] == {"launches": 1, "plain_calls": 0}
    assert c[which] == {"launches": 0, "plain_calls": 0}


@pytest.mark.parametrize("n", [8192, 16384, 1 << 15])
@pytest.mark.parametrize("which", ["ntt_fwd", "ntt_inv"])
def test_single_prime_ring_above_4096_reaches_the_banks_launcher(monkeypatch, which, n):
    """Above 4096 words a single-prime transform runs as a one-prime bank:
    one call of the u32 banks launcher with k = 1 and the ring's n,
    counted there and not on the single-prime kernel."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(ntt_kernel, "stream", lambda: 0)
    assert n > ntt_kernel.MAX_N_SINGLE == 4096
    p = make_ntt_params(n)
    _fake_single_prime_bank(monkeypatch, p)
    K.reset_counts()
    out = _single_prime_calls(_fake(3, n), p)[which]()
    assert tuple(out.shape) == (3, n)
    _banks_route(lib, which, 3, n)


@pytest.mark.parametrize("n,offset", [(2, 0), (32, 0), (64, 1), (128, 1), (128, 2),
                                      (4096, 3)])
@pytest.mark.parametrize("which", ["ntt_fwd", "ntt_inv"])
def test_single_prime_ring_below_64_or_unaligned_reaches_the_banks_launcher(
        monkeypatch, which, n, offset):
    """Rings below the row stream's 64 words, and rows that do not start
    on a 16-byte boundary (a view ``offset`` words into its storage), run
    as a one-prime bank on the u32 banks launcher, counted there."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(ntt_kernel, "stream", lambda: 0)
    p = make_ntt_params(n)
    _fake_single_prime_bank(monkeypatch, p)
    x = _fake(3 * n + offset)[offset:].view(3, n)
    assert ntt_kernel.on_banks(x)
    K.reset_counts()
    out = _single_prime_calls(x, p)[which]()
    assert tuple(out.shape) == (3, n)
    _banks_route(lib, which, 3, n)


@pytest.mark.parametrize("n", [64, 128, 1024, 4096])
@pytest.mark.parametrize("which", ["ntt_fwd", "ntt_inv"])
def test_single_prime_ring_up_to_4096_reaches_its_launcher(monkeypatch, which, n):
    """From 64 up to 4096 words, rows on a 16-byte boundary, a
    single-prime transform is one call of its own launcher
    (``csrc/ntt.cu``) with (B, n) and the prime's one-prime bank tables,
    counted on the single-prime kernel."""
    lib = _Recorder()
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(ntt_kernel, "stream", lambda: 0)
    p = make_ntt_params(n)
    _fake_single_prime_bank(monkeypatch, p)
    K.reset_counts()
    out = _single_prime_calls(_fake(5, n), p)[which]()
    assert tuple(out.shape) == (5, n)
    fn, args = lib.calls[0]
    assert len(lib.calls) == 1 and fn == which
    assert len(args) == len(build.SIGNATURES["ntt"][which])
    bn = args[9:11] if which == "ntt_fwd" else args[11:13]
    assert tuple(bn) == (5, n)
    c = K.snapshot()
    assert c[which] == {"launches": 1, "plain_calls": 0}
    assert c["ntt_fwd_banks"]["launches"] == c["ntt_inv_banks"]["launches"] == 0


def test_no_source_includes_the_ping_pong_body():
    """The single-prime transforms left the shared-memory ping-pong body
    (``ntt_block.cuh``) for the row stream; the header is gone and no
    source or header names it."""
    assert not (build.CSRC / "ntt_block.cuh").exists()
    for f in sorted(build.CSRC.glob("*.cu")) + sorted(build.CSRC.glob("*.cuh")):
        assert "ntt_block" not in f.read_text(), f.name


@pytest.mark.parametrize("which", ["ntt_fwd", "ntt_inv"])
def test_single_prime_ring_above_2_17_is_refused(monkeypatch, which):
    """Past the banks' 2^17 a single-prime ring is refused with the limit
    named, before any kernel or plain version runs."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    n = 2 * ntt_kernel.MAX_N

    class Ring:      # the wrapper reads only n before it refuses
        pass
    p = Ring()
    p.n = n
    call = _single_prime_calls(torch.zeros((1, n), dtype=torch.int32, device="meta"),
                               p)[which]
    K.reset_counts()
    with pytest.raises(ValueError, match="power of two in \\[2, 131072\\]"):
        call()
    assert all(c == {"launches": 0, "plain_calls": 0} for c in K.snapshot().values())


@pytest.mark.parametrize("which", SINGLE)
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_single_prime_int16_is_refused(monkeypatch, which, device):
    """The single-prime lane is uint32 only, on every device."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    call = _single_prime_calls(torch.zeros((2, N), dtype=torch.int16, device=device),
                               P1)[which]
    K.reset_counts()
    with pytest.raises(ValueError, match="must be int32"):
        call()
    assert K.snapshot()[which] == {"launches": 0, "plain_calls": 0}


@pytest.mark.parametrize("which", ["dyadic_mul", "dyadic_mac"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_barrett_mu_zero_is_refused(monkeypatch, which, device):
    """make_ntt_params leaves mu at 0 for a modulus outside the Barrett
    window (here 97 < 2^28); the product would be wrong, so both devices
    refuse it (the ops too)."""
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    p = make_ntt_params(N, q=97)
    assert p.barrett_mu == 0
    x = torch.zeros((2, N), dtype=torch.int32, device=device)
    K.reset_counts()
    with pytest.raises(ValueError, match="mu is 0"):
        _single_prime_calls(x, p)[which]()
    op = {"dyadic_mul": lambda: ops.dyadic_mul(x, x, p),
          "dyadic_mac": lambda: ops.dyadic_mac(x, x, x, p)}[which]
    with pytest.raises(ValueError, match="mu is 0"):
        op()
    assert K.snapshot()[which] == {"launches": 0, "plain_calls": 0}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_dyadic_operands_of_other_shapes_are_refused(monkeypatch, device):
    monkeypatch.setattr(build, "load", lambda name: _NoLaunch())
    a = torch.zeros((2, N), dtype=torch.int32, device=device)
    b = torch.zeros((1, N), dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="shapes differ"):
        dyadic_kernel.dyadic_mul(a, b, q=P1.q, mu=P1.barrett_mu, lazy=True)
    with pytest.raises(ValueError, match="shapes differ"):
        dyadic_kernel.dyadic_mac(a, a, b, q=P1.q, mu=P1.barrett_mu, lazy=True)
