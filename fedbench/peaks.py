"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit). The card's integer rates on the CUDA cores are not published, so
the integer kernels' rooflines are bounded by bytes alone."""

HBM_BYTES_PER_S = 3.35e12
