"""The tree kernel's share of its roofline in a round (%): the bytes its
three entries need at the cell's layout and rate, over the HBM rate,
against the device time of the kernels whose name starts `tree_`
(csrc/tree_average.cu's gather, average and scatter) per traced round.

Every key of the layout is read as the kernel reads it, so a tied tensor
counts under each of its keys. For K clients, E encrypted values a client
(sum over the keys of ceil(rate * size)) and P plain positions (the rest),
with leaves of b bytes a value (the configuration's `values.dtype`) and
float32 outputs, each input byte read once and each output byte written
once:

    gather   K * E * (b + 4)   the encrypted prefixes, to (K, E) float32
    average  K * P * b + P * 4 the plain remainder, to the output
    scatter  8 * E             the decrypted average into the output

At the Granite stage (K 3, E 305,851,935, P 2,752,666,721, bfloat16)
35.48 GB, 10.59 ms at 3.35 TB/s. A bytes bound: the average's 2K float64
operations a position are far below the card's float64 rate. Without a
trace or such a kernel it reads nothing."""

import fractions
import math

from fedbench.peaks import HBM_BYTES_PER_S
from fedbench.reference import granite_hybrid as model
from fedbench.trace import kernel_id

ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def round_bytes(config):
    rate = fractions.Fraction(str(config["selective"]["rate"]))
    sizes = [math.prod(shape) for _, shape in model.layout(config)]
    enc = sum(math.ceil(rate * n) for n in sizes)
    plain = sum(sizes) - enc
    k, b = config["clients"], ITEM_BYTES[config["values"]["dtype"]]
    return k * enc * (b + 4) + (k * plain * b + plain * 4) + 8 * enc


def read(r):
    t = r.trace
    if t is None:
        return None
    us = sum(e.dur for e in t.kernels()
             if kernel_id(e.name).startswith("tree_"))
    if not us:
        return None
    return 100.0 * (round_bytes(r.config) / HBM_BYTES_PER_S) / (
        1e-6 * us / t.rounds)
