"""Negacyclic NTT / inverse NTT over RNS limbs: the dispatch, and the plain
butterfly network.

Layout: int32 residues (..., L, N); forward output is in bit-reversed
order, as in fhe_fed_tpu.ntt.ntt. The backend follows the tables, then the
tensor's device:

  * tables with a four-step split (`tb.mxu`, N <= 16384): kernel K1
    (ntt/mxu_pallas.py) on a CUDA tensor, its plain version (ntt/mxu.py) on
    a CPU tensor;
  * otherwise: kernel K2 (ntt/pallas_ntt.py) on a CUDA tensor, the plain
    butterfly below on a CPU tensor.

`ntt_butterfly` / `intt_butterfly` are the plain version of K2: the
Cooley-Tukey forward and Gentleman-Sande inverse networks of
fhe_fed_tpu/ntt/ntt.py, one (..., L, m, 2, t) reshape per stage, in int64.
The JAX package's transposed phase B only rearranges the TPU's lanes and is
left out. Every step is exact on canonical residues, so all four
transforms give the same bits.
"""

from __future__ import annotations

import torch

from ..rns.modops import add_mod, sub_mod, mul_mod_shoup
from . import mxu, mxu_pallas, pallas_ntt
from .tables import NttTables


def _check(x: torch.Tensor, tb: NttTables) -> None:
    if x.shape[-1] != tb.ring_dim or x.shape[-2] != tb.num_limbs:
        raise ValueError(f"NTT input {tuple(x.shape)} does not match tables "
                         f"(L={tb.num_limbs}, N={tb.ring_dim})")


def _q(tb: NttTables, device) -> torch.Tensor:
    return torch.as_tensor(tb.q, device=device).view(-1, 1, 1)


def ntt_butterfly(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Forward negacyclic NTT, coefficient -> bit-reversed order (plain)."""
    _check(x, tb)
    n, L = tb.ring_dim, tb.num_limbs
    lead = x.shape[:-2]
    qb = _q(tb, x.device)
    x = x.to(torch.int64)
    m, t = 1, n // 2
    while m < n:
        xs = x.reshape(*lead, L, m, 2, t)
        w = tb.tab[:, m:2 * m].reshape(L, m, 1)
        ws = tb.tab_shoup[:, m:2 * m].reshape(L, m, 1)
        u = xs[..., 0, :]
        v = mul_mod_shoup(xs[..., 1, :], w, ws, qb)
        x = torch.stack([add_mod(u, v, qb), sub_mod(u, v, qb)], dim=-2)
        m, t = 2 * m, t // 2
    return x.reshape(*lead, L, n).to(torch.int32)


def intt_butterfly(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-reversed -> coefficient order, times
    N**-1 (plain)."""
    _check(x, tb)
    n, L = tb.ring_dim, tb.num_limbs
    lead = x.shape[:-2]
    qb = _q(tb, x.device)
    x = x.to(torch.int64)
    h, t = n // 2, 1
    while h >= 1:
        xs = x.reshape(*lead, L, h, 2, t)
        w = tb.itab[:, h:2 * h].reshape(L, h, 1)
        ws = tb.itab_shoup[:, h:2 * h].reshape(L, h, 1)
        x0, x1 = xs[..., 0, :], xs[..., 1, :]
        x = torch.stack([add_mod(x0, x1, qb),
                         mul_mod_shoup(sub_mod(x0, x1, qb), w, ws, qb)],
                        dim=-2)
        h, t = h // 2, 2 * t
    x = x.reshape(*lead, L, n)
    dev = x.device
    return mul_mod_shoup(
        x, torch.as_tensor(tb.ninv, device=dev)[:, None],
        torch.as_tensor(tb.ninv_shoup, device=dev)[:, None],
        qb.view(L, 1)).to(torch.int32)


def _on_cpu(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"no NTT backend for device {x.device}")


def ntt(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Forward negacyclic NTT: coefficient order -> bit-reversed order."""
    cpu = _on_cpu(x)
    if tb.mxu is not None:
        return (mxu.ntt_mxu(x, tb.mxu) if cpu
                else mxu_pallas.ntt_mxu_fused(x, tb.mxu))
    return ntt_butterfly(x, tb) if cpu else pallas_ntt.ntt_fused(x, tb)


def intt(x: torch.Tensor, tb: NttTables) -> torch.Tensor:
    """Inverse negacyclic NTT: bit-reversed order -> coefficient order."""
    cpu = _on_cpu(x)
    if tb.mxu is not None:
        return (mxu.intt_mxu(x, tb.mxu) if cpu
                else mxu_pallas.intt_mxu_fused(x, tb.mxu))
    return intt_butterfly(x, tb) if cpu else pallas_ntt.intt_fused(x, tb)
