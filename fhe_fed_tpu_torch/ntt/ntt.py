"""Negacyclic NTT / inverse NTT over RNS limbs: the dispatch.

Layout: int32 residues (..., L, N); forward output is in bit-reversed
order, as in fhe_fed_tpu.ntt.ntt. The backend follows the tensor's device:
a CUDA tensor runs kernel K1 (ntt/mxu_pallas.py), a CPU tensor its plain
version (ntt/mxu.py). The transform is the four-step digit-plane one for
every ring; a ring without such a split (N >= 32768, where mxu_viable is
false) needs the butterfly kernel K2, which is not ported yet, and raises.
"""

from __future__ import annotations

import torch

from . import mxu, mxu_pallas
from .mxu import MxuNttTables


def _tables(mt: MxuNttTables | None) -> MxuNttTables:
    if mt is None:
        raise NotImplementedError(
            "this ring has no four-step digit-plane NTT split (mxu_viable is "
            "false); it needs kernel K2, the butterfly NTT of "
            "fhe_fed_tpu/ntt/pallas_ntt.py, which is not ported yet "
            "(ROADMAP Queue 2)")
    return mt


def _on_cpu(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"no NTT backend for device {x.device}")


def ntt(x: torch.Tensor, mt: MxuNttTables | None) -> torch.Tensor:
    """Forward negacyclic NTT: coefficient order -> bit-reversed order."""
    mt = _tables(mt)
    return (mxu.ntt_mxu(x, mt) if _on_cpu(x)
            else mxu_pallas.ntt_mxu_fused(x, mt))


def intt(x: torch.Tensor, mt: MxuNttTables | None) -> torch.Tensor:
    """Inverse negacyclic NTT: bit-reversed order -> coefficient order."""
    mt = _tables(mt)
    return (mxu.intt_mxu(x, mt) if _on_cpu(x)
            else mxu_pallas.intt_mxu_fused(x, mt))
