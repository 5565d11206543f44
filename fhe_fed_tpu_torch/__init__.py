"""PyTorch / CUDA port of fhe_fed_tpu for one NVIDIA Hopper GPU.

Ported so far: the drop-in `CKKS` surface (bytes methods, cohort methods,
the streamed `fedavg_round`; options dense_pack, symmetric, seeded_fresh,
packing="slots"; a `device` argument) and the pytree FedAvg with
selective encryption (`fhe_fedavg`, `plain_fedavg`), on the RNS / NTT /
CKKS engine: context and keys, encrypt (secret-key, public-key, seeded),
the weighted sum, decrypt, the fused round, key switching (ct x ct
multiply with relinearisation, Galois rotations, EvalSum), rescale, slot
packing, the FFTC / FFTP / FFTS / FFTK wire formats, the threefry PRNG of
jax.random (utils/threefry.py), so a seed gives the JAX package's bytes,
and its rbg keys (utils/prng.py: JAX's key tree, leaves drawn by the
device's generator), the helpers' default on the card.
The two other secure-aggregation schemes: threshold CKKS (`ThresholdCKKS`,
ckks/threshold.py; no party holds the joint secret key) and the Paillier
masking scheme (`Masking`, fed/masking.py; its offline Paillier runs on the
host in native/paillier.py). The model zoo (models/: the JAX package's 15
models over its parameter trees, built from the same threefry keys), the
synthetic data (data/synth.py), the attack suite (attack/: DLG gradient
inversion, gradient-sensitivity masks, similarity metrics; the first path
with gradients, in full float32, utils/precision.py) and the benchmark
drivers (benchmarks/: model_bench, selective_bench, train_synth,
param_sweep, attack_eval, fedavg_demo, mkhe_bench, masking_bench,
baseline_configs, scaling_virtual, microprof). Multi-device aggregation runs on
torch.distributed, one process a device (parallel/: the clients x chunks
round; ntt/dist.py and ckks/dist_ckks.py: the limb- and
coefficient-sharded NTT and the round in its layout). Module paths mirror
the JAX package's. Residues are
stored as non-negative int32 (every modulus is below 2**31); Shoup
companion words are int64 (rns/modops.py).

A tensor on the CPU takes each kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel (csrc/) or raises.
"""

from .fed.api import CKKS
from .fed.threshold_api import ThresholdCKKS
from .fed.masking import Masking
from .fed.scheme import Scheme, get_scheme, register_scheme
from .fed.fedavg import (fhe_fedavg, plain_fedavg, flatten_params,
                         unflatten_params, SelectivePolicy)
from .ckks.params import make_params, make_context

__all__ = [
    "CKKS", "ThresholdCKKS", "Masking", "Scheme", "get_scheme",
    "register_scheme", "fhe_fedavg", "plain_fedavg", "flatten_params",
    "unflatten_params", "SelectivePolicy", "make_params", "make_context",
]
