"""Paillier over the JAX package's native C++ kernels, as
fhe_fed_tpu.native.paillier.

The C++ source is host bignum code (fixed-limb Montgomery arithmetic with
OpenMP across ciphertexts), not a TPU kernel, so the port keeps no copy:
it compiles fhe_fed_tpu/native/paillier.cpp, read by path, with

    g++ -O2 -fopenmp -shared -fPIC paillier.cpp -o <build>/libpaillier.so

into build/fhe_fed_tpu_torch/paillier-<hash>/ beside the package, keyed by
a hash of the source and the flags, and loads it with ctypes at first
use; importing this module compiles nothing. The build writes to a
temporary name and renames it into place, so processes that build at once
never load half a library.

Only the C++ is shared; this Python wrapper is the port's own copy of
fhe_fed_tpu/native/paillier.py. That module needs only numpy, and loading
it by path would skip fhe_fed_tpu/__init__.py (which imports jax), but the
port executes no Python module of the JAX package: what runs on a GPU host
depends on that package's C++ source only, and the JAX wrapper's own
load_lib builds beside its source with no guard against concurrent builds.
The two copies compute the same Montgomery constants for one C ABI;
tests/test_torch_masking.py holds them together (identical limbs under one
randbelow stream, each decrypting the other's ciphertexts and sums).

Key generation and every constant that needs a division run here in Python
integers (once per key); batch encrypt, the homomorphic sum and decrypt run
in the native kernels. Keys, ciphertext limbs and wire bytes are the JAX
package's, so either package decrypts what the other encrypts.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import pathlib
import secrets
import subprocess
import threading

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = _ROOT / "fhe_fed_tpu" / "native" / "paillier.cpp"
BUILD_ROOT = _ROOT / "build" / "fhe_fed_tpu_torch"
GXX_FLAGS = ("-O2", "-fopenmp", "-shared", "-fPIC")
LIB_NAME = "libpaillier.so"

_lock = threading.Lock()
_lib = None


def build() -> pathlib.Path:
    """Compile the source unless a build of the same source and flags
    exists; returns the library's path. Raises if g++ or OpenMP is
    missing."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / f"paillier-{h.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the Paillier kernels cannot be "
                           "built") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {SRC}:"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)        # atomic: a concurrent build never sees half
    return lib


def load_lib() -> ctypes.CDLL:
    """The loaded native library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            U64P = ctypes.POINTER(ctypes.c_uint64)
            lib.paillier_encrypt_batch.argtypes = [
                U64P, U64P, U64P, U64P, ctypes.c_uint64, ctypes.c_int,
                U64P, U64P, ctypes.c_int, U64P]
            lib.paillier_mul_batch.argtypes = [
                U64P, U64P, ctypes.c_uint64, ctypes.c_int,
                U64P, U64P, ctypes.c_int, U64P]
            lib.paillier_decrypt_batch.argtypes = [
                U64P, U64P, U64P, ctypes.c_uint64,
                U64P, U64P, U64P, ctypes.c_uint64,
                U64P, U64P, U64P, ctypes.c_int, U64P, ctypes.c_int, U64P]
            for name in ("paillier_encrypt_batch", "paillier_mul_batch",
                         "paillier_decrypt_batch"):
                getattr(lib, name).restype = None
            lib.paillier_num_threads.argtypes = []
            lib.paillier_num_threads.restype = ctypes.c_int
            lib.paillier_set_threads.argtypes = [ctypes.c_int]
            lib.paillier_set_threads.restype = None
            _lib = lib
    return _lib


def num_threads() -> int:
    """OpenMP thread count the native kernels will use."""
    return int(load_lib().paillier_num_threads())


def set_threads(n: int) -> None:
    """Pin the native kernels' OpenMP thread count."""
    load_lib().paillier_set_threads(int(n))


# ---------------------------------------------------------------------------
# Limbs: little-endian uint64 words of Python integers
# ---------------------------------------------------------------------------

def _to_limbs(x: int, k: int) -> np.ndarray:
    """x -> (k,) uint64 little-endian limbs; raises if x needs more."""
    return np.frombuffer(int(x).to_bytes(8 * k, "little"), dtype="<u8"
                         ).astype(np.uint64)


def _from_limbs(a: np.ndarray) -> int:
    return int.from_bytes(np.ascontiguousarray(a, dtype="<u8").tobytes(),
                          "little")


def _batch_to_limbs(xs: list[int], k: int) -> np.ndarray:
    raw = b"".join(int(x).to_bytes(8 * k, "little") for x in xs)
    return np.frombuffer(raw, dtype="<u8").astype(np.uint64).reshape(
        len(xs), k)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


# ---------------------------------------------------------------------------
# Key generation (Python ints; once per key)
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
                 59, 61, 67, 71, 73, 79, 83, 89, 97]


def _is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int) -> int:
    while True:
        c = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(c):
            return c


@dataclasses.dataclass
class PaillierPublicKey:
    n: int
    bits: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    def to_hex(self) -> str:
        return format(self.n, "x")

    @classmethod
    def from_hex(cls, h: str, bits: int | None = None):
        n = int(h, 16)
        return cls(n=n, bits=bits or n.bit_length())


@dataclasses.dataclass
class PaillierSecretKey:
    lam: int       # lcm(p-1, q-1)
    mu: int        # lam^-1 mod n (g = n + 1)

    def to_hex(self) -> str:
        return format(self.lam, "x") + ":" + format(self.mu, "x")

    @classmethod
    def from_hex(cls, h: str):
        a, b = h.split(":")
        return cls(lam=int(a, 16), mu=int(b, 16))

    @classmethod
    def from_reference_hex(cls, h: str, n: int):
        """libpaillier's hex private key holds lambda only; with g = n + 1,
        mu = lambda^-1 mod n."""
        lam = int(h.strip(), 16)
        return cls(lam=lam, mu=pow(lam, -1, n))


def keygen(bits: int = 2048) -> tuple[PaillierPublicKey, PaillierSecretKey]:
    """Textbook Paillier keygen with g = n + 1."""
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p != q:
            n = p * q
            if n.bit_length() == bits:
                break
    lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
    return (PaillierPublicKey(n=n, bits=bits),
            PaillierSecretKey(lam=lam, mu=pow(lam, -1, n)))


# ---------------------------------------------------------------------------
# Context: the native kernels' constants
# ---------------------------------------------------------------------------

class PaillierContext:
    """Precomputes every modular constant the C++ kernels need."""

    def __init__(self, pk: PaillierPublicKey,
                 sk: PaillierSecretKey | None = None):
        self.pk = pk
        self.sk = sk
        n = pk.n
        self.k = (pk.bits + 63) // 64
        k, k2 = self.k, 2 * self.k
        n2 = n * n
        R2 = 1 << (64 * k2)
        Rn = 1 << (64 * k)
        self._n = _to_limbs(n, k)
        self._n2 = _to_limbs(n2, k2)
        self._n2_rr = _to_limbs(R2 * R2 % n2, k2)
        self._n2_one = _to_limbs(R2 % n2, k2)
        self._n2_m0inv = ctypes.c_uint64((-pow(n2, -1, 1 << 64)) % (1 << 64))
        self._n_rr = _to_limbs(Rn * Rn % n, k)
        self._n_one = _to_limbs(Rn % n, k)
        self._n_m0inv = ctypes.c_uint64((-pow(n, -1, 1 << 64)) % (1 << 64))
        self._n_hensel = _to_limbs(pow(n, -1, Rn), k)
        if sk is not None:
            self._lambda = _to_limbs(sk.lam, k)
            self._mu = _to_limbs(sk.mu, k)
        self.lib = load_lib()

    def encrypt(self, msgs: list[int], rng=secrets) -> np.ndarray:
        """(count, 2k) uint64 ciphertext limbs. `rng` has `randbelow` (the
        default: the `secrets` module) or is a numpy Generator."""
        n = self.pk.n
        rands = [rng.randbelow(n - 1) + 1 if hasattr(rng, "randbelow")
                 else int(rng.integers(1, n)) for _ in msgs]
        m = _batch_to_limbs(msgs, self.k)
        r = _batch_to_limbs(rands, self.k)
        out = np.zeros((len(msgs), 2 * self.k), dtype=np.uint64)
        self.lib.paillier_encrypt_batch(
            _ptr(self._n), _ptr(self._n2), _ptr(self._n2_rr),
            _ptr(self._n2_one), self._n2_m0inv, self.k,
            _ptr(m), _ptr(r), len(msgs), _ptr(out))
        return out

    def add(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Homomorphic addition: the ciphertext product mod n^2."""
        if a.shape != b.shape or a.shape[-1:] != (2 * self.k,):
            raise ValueError(f"ciphertext shapes {a.shape} and {b.shape} "
                             f"do not match (count, {2 * self.k})")
        a = np.ascontiguousarray(a, dtype=np.uint64)
        b = np.ascontiguousarray(b, dtype=np.uint64)
        out = np.zeros_like(a)
        self.lib.paillier_mul_batch(
            _ptr(self._n2), _ptr(self._n2_rr), self._n2_m0inv, self.k,
            _ptr(a), _ptr(b), a.shape[0], _ptr(out))
        return out

    def decrypt(self, cts: np.ndarray) -> list[int]:
        if self.sk is None:
            raise ValueError("decrypt needs the secret key")
        if cts.ndim != 2 or cts.shape[1] != 2 * self.k:
            raise ValueError(f"ciphertexts {cts.shape} are not "
                             f"(count, {2 * self.k})")
        cts = np.ascontiguousarray(cts, dtype=np.uint64)
        out = np.zeros((cts.shape[0], self.k), dtype=np.uint64)
        self.lib.paillier_decrypt_batch(
            _ptr(self._n), _ptr(self._n_rr), _ptr(self._n_one),
            self._n_m0inv,
            _ptr(self._n2), _ptr(self._n2_rr), _ptr(self._n2_one),
            self._n2_m0inv,
            _ptr(self._n_hensel), _ptr(self._lambda), _ptr(self._mu),
            self.k, _ptr(cts), cts.shape[0], _ptr(out))
        return [_from_limbs(row) for row in out]

    # -- wire bytes: little-endian uint64 limbs ------------------------------

    def ct_to_bytes(self, cts: np.ndarray) -> bytes:
        return cts.astype("<u8").tobytes()

    def ct_from_bytes(self, raw: bytes) -> np.ndarray:
        return np.frombuffer(raw, dtype="<u8").reshape(-1, 2 * self.k).astype(
            np.uint64)
