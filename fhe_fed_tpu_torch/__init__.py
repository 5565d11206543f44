"""PyTorch / CUDA port of fhe_fed_tpu for one NVIDIA Hopper GPU.

Ported so far: the encrypted FedAvg round (context and keys, encrypt
secret-key and public-key, the weighted sum, decrypt, the fused round, the
FFTC / FFTK wire formats), key generation, key switching (ct x ct
multiply with relinearisation, Galois rotations, EvalSum), rescale and
slot packing. Module paths mirror the
JAX package's. Residues are stored as non-negative int32 (every modulus is
below 2**31); Shoup companion words are int64 (rns/modops.py).

A tensor on the CPU takes each kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel (csrc/) or raises.
"""
