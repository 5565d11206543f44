"""The port's synthetic data (fhe_fed_tpu_torch.data.synth) against the
JAX package's: the same samples, bit for bit."""

import numpy as np
import pytest
import torch

from fhe_fed_tpu.data import synth as JS
from fhe_fed_tpu_torch.data import synth as TS

torch.set_num_threads(1)


@pytest.mark.parametrize("n,seed", [(1, 0), (64, 0), (257, 3), (1000, 2024)])
def test_make_synth_images_bit_exact(n, seed):
    x, y = TS.make_synth_images(n, seed)
    jx, jy = JS.make_synth_images(n, seed)
    assert x.dtype == jx.dtype == np.float32 and y.dtype == jy.dtype
    assert x.shape == (n, 28, 28) and y.shape == (n,)
    np.testing.assert_array_equal(x.view(np.int32), jx.view(np.int32))
    np.testing.assert_array_equal(y, jy)


def test_prototypes_and_spec_match():
    for k in ("n_classes", "hw", "signal", "noise", "prototype_seed"):
        assert getattr(TS.SynthSpec, k) == getattr(JS.SynthSpec, k)
    np.testing.assert_array_equal(TS._prototypes(), JS._prototypes())
