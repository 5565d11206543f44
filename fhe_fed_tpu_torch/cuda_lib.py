"""Build, load and call the hand-written Hopper kernels in csrc/.

Each .cu source is compiled by its own nvcc process, all started together,
and the objects are linked into ONE shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <build>/<source>.o csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o <build>/libfhe_fed_kernels.so <build>/*.o

The library is built at first use into build/fhe_fed_tpu_torch/<hash>/
beside the package, keyed by a hash of the sources and the flags, so a
fresh checkout builds it once and an edited source builds anew. Importing
this module compiles and loads nothing.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns cudaGetLastError() after the
launch; `check` raises if that is not 0.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "fhe_fed_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libfhe_fed_kernels.so"

# Launch counts by kernel name. Each wrapper adds one right after its
# kernel launched, and nowhere else.
launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # out, x, w1, w2, mid_pair, limb_consts(host), B, L, n1, n2, forward,
    # stream
    "fhe_ntt_mxu_wg": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # out, x, w1, w2, mid, mid_shoup, limb_consts(host), B, L, n1, n2,
    # forward, stream
    "fhe_ntt_mxu_sync": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # out, x, tw, consts(host), B, L, n, forward, stream
    "fhe_ntt_butterfly": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # out, x, pairs(device or null), block(host), K, live, n, rows, stream
    "fhe_weighted_sum": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # out, x, consts(device), words, live, chunks, n, stream
    "fhe_decode_crt": (_P, _P, _P, _I, _I, _I, _I, _P),
    # out, k1, k2, limb_consts(host), limbs, n, epilogue, nkeys, per, stream
    "fhe_philox_rbg": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _P),
    # out, key, nkeys, num, stream
    "fhe_threefry_split": (_P, _P, _L, _L, _P),
    # enc, table(device), leaves, clients, count, mode, stream
    "fhe_tree_gather": (_P, _P, _I, _I, _L, _I, _P),
    # out, table(device), leaves, clients, count, mode, stream
    "fhe_tree_average": (_P, _P, _I, _I, _L, _I, _P),
    # out, dec, table(device), leaves, clients, count, stream
    "fhe_tree_scatter": (_P, _P, _P, _I, _I, _L, _P),
    # out, values, error(device or null), table(device), moduli(host),
    # limbs, rows, n, scale, stream
    "fhe_encode_pass": (_P, _P, _P, _P, _P, _I, _L, _I, _F, _P),
    # out, a_hat, w_hat, s, s_shoup, moduli(host), limbs, rows, n, c1,
    # stream
    "fhe_encrypt_pass": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P),
    # out, ct, s, s_shoup, moduli(host), live, rows, n, stream
    "fhe_decrypt_pass": (_P, _P, _P, _P, _P, _I, _L, _I, _P),
}


def _sources() -> list[pathlib.Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the output of the first
    that fails."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
             for c in cmds]
    failed = []
    for c, p in procs:
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n"
                          f"{out}\n{err}")
    if failed:
        raise RuntimeError(failed[0])


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the shared library unless a build of the same
    sources and flags exists; returns its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in srcs]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
              for p, o in zip(srcs, objs)])
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(o) for o in objs]]])
    for o in objs:
        o.unlink()
    os.replace(tmp, lib)        # atomic: a concurrent build never sees half
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = cdll
    return _lib


def device(d: torch.device | str = "cuda") -> torch.device:
    """torch.device(d) for an entry point's `device` argument (default the
    card), with the index made explicit ("cuda" -> the current card, as
    its tensors report it). Asking for CUDA where torch sees none raises;
    nothing falls back to the CPU."""
    dev = torch.device(d)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} (the entry points' default)"
                           f" but torch sees no CUDA device: pass "
                           f"device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """The checks every kernel wrapper makes on a tensor it hands to C."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: tensor must be 16-byte aligned")
