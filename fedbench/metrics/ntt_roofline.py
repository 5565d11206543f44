"""Kernel K1's share of its roofline in a round (%): the bytes of the
transforms that the round needs at the cell's shapes, over the HBM rate,
against K1's device time per traced round. A round encrypts every
client's chunks once and decrypts the aggregate's once. A secret-key
encrypt needs one forward NTT of m + e a client, chunk and limb; a
public-key encrypt three (u, m + e0, e1); the decrypt one inverse NTT a
chunk and limb. Each int32 residue is read once and written once. A bytes
bound: the data sheet gives no int32 rate."""

from fedbench.peaks import HBM_BYTES_PER_S
from fedbench.rounds import chunks_of
from fedbench.trace import kernel_id

KERNELS = ("ntt_wg_kernel", "ntt_mxu_kernel")


def round_bytes(config):
    c = config["crypto"]
    per_client = 1 if c["symmetric"] else 3
    polys = (per_client * config["clients"] + 1) * chunks_of(config)
    return 2 * 4 * polys * c["chain_len"] * c["ring_dim"]


def read(r):
    t = r.trace
    if t is None:
        return None
    us = sum(e.dur for e in t.kernels() if kernel_id(e.name) in KERNELS)
    if not us:
        return None
    return 100.0 * (round_bytes(r.config) / HBM_BYTES_PER_S) / (
        1e-6 * us / t.rounds)
