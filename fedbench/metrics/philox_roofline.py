"""The Philox kernel's share of its roofline in a round (%): the bytes of
the draws that the round's encrypts need at the cell's shapes, each
written once as int32, over the HBM rate, against the kernel's device
time per traced round. A secret-key encrypt draws, a client and chunk,
the uniform `a` (a residue per limb and coefficient) and the error (one
per coefficient); a public-key encrypt u, e0 and e1 (one each per
coefficient). A bytes bound."""

from fedbench.peaks import HBM_BYTES_PER_S
from fedbench.rounds import chunks_of
from fedbench.trace import kernel_id

KERNELS = ("philox_kernel",)


def round_bytes(config):
    c = config["crypto"]
    words = c["chain_len"] + 1 if c["symmetric"] else 3
    coeffs = config["clients"] * chunks_of(config) * c["ring_dim"]
    return 4 * coeffs * words


def read(r):
    t = r.trace
    if t is None:
        return None
    us = sum(e.dur for e in t.kernels() if kernel_id(e.name) in KERNELS)
    if not us:
        return None
    return 100.0 * (round_bytes(r.config) / HBM_BYTES_PER_S) / (
        1e-6 * us / t.rounds)
