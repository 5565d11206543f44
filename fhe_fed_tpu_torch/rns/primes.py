"""NTT-friendly primes for the RNS modulus chain (host side, pure Python).

Every q satisfies 2**30 < q < 2**31 and q = 1 (mod 2N), so a primitive
2N-th root of unity exists. Same selection as fhe_fed_tpu.rns.primes, so
both packages build identical moduli for every parameter point.
"""

from __future__ import annotations

import functools

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, valid for all n < 3.3e24."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
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


@functools.lru_cache(maxsize=None)
def ntt_primes(ring_dim: int, count: int, target_bits: int = 31,
               skip: int = 0) -> tuple[int, ...]:
    """`count` distinct primes q = 1 (mod 2*ring_dim), scanning down from
    2**target_bits; the first `skip` primes found are passed over."""
    m = 2 * ring_dim
    out = []
    q = (2 ** target_bits - 1) // m * m + 1
    skipped = 0
    while len(out) < count:
        if q <= 2 ** (target_bits - 1):
            raise ValueError(f"ran out of {target_bits}-bit NTT primes "
                             f"for ring_dim={ring_dim}")
        if is_prime(q):
            if skipped < skip:
                skipped += 1
            else:
                out.append(q)
        q -= m
    return tuple(out)


def primitive_root_2n(q: int, ring_dim: int) -> int:
    """Smallest-found primitive 2N-th root of unity psi mod q
    (psi**N = -1 mod q)."""
    m = 2 * ring_dim
    if (q - 1) % m:
        raise ValueError(f"q={q} is not 1 mod 2N={m}")
    cofactor = (q - 1) // m
    for g in range(2, 1000):
        psi = pow(g, cofactor, q)
        if pow(psi, ring_dim, q) == q - 1:
            return psi
    raise ValueError(f"no primitive 2N-th root found for q={q}")


# Minimum ring dimension for 128-bit classical security at a total modulus
# size (HE security standard, ternary secret).
_HESTD_128_CLASSIC = [
    (27, 1024),
    (54, 2048),
    (109, 4096),
    (218, 8192),
    (438, 16384),
    (881, 32768),
]


def min_ring_dim_128(log_q: float) -> int:
    for max_log_q, n in _HESTD_128_CLASSIC:
        if log_q <= max_log_q:
            return n
    raise ValueError(f"logQ={log_q} too large for 128-bit security table")
