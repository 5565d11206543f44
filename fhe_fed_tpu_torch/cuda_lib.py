"""Build, load and call the hand-written Hopper kernels in csrc/.

All .cu sources are compiled by nvcc into ONE shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/libfhe_fed_kernels.so csrc/*.cu

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
LIB_NAME = "libfhe_fed_kernels.so"

# Launch counts by kernel name. Each wrapper adds one right after its
# kernel launched, and nowhere else.
launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # out, x, w1_nk, w2_nk, mid, mid_shoup, limb_consts(host), B, L, n1, n2,
    # forward, stream
    "fhe_ntt_mxu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # out, x, consts(host), K, live, n, per_client, stream
    "fhe_weighted_sum": (_P, _P, _P, _I, _I, _I, _L, _P),
    # out, x, consts(host), chunks, n, stream
    "fhe_decode_crt": (_P, _P, _P, _I, _I, _P),
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
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
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
