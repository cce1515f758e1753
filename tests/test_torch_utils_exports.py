"""``spfft_tpu_torch.utils`` re-exports the helpers ``spfft_tpu.utils``
re-exports, under the same names, and they agree with the JAX package's
on host data."""

import numpy as np
import pytest
import torch

import spfft_tpu.utils as jax_utils
import spfft_tpu_torch.utils as port_utils

NAMES = ("as_complex_np", "as_interleaved", "complex_dtype",
         "interleaved_to_complex", "complex_to_interleaved", "real_dtype")


def test_the_same_names():
    jax_names = {n for n in dir(jax_utils) if not n.startswith("_")
                 and callable(getattr(jax_utils, n))}
    assert set(NAMES) <= jax_names
    assert set(NAMES) <= set(port_utils.__all__)


@pytest.mark.parametrize("name", NAMES)
def test_each_name_is_the_dtypes_helper(name):
    from spfft_tpu_torch.utils import dtypes
    assert getattr(port_utils, name) is getattr(dtypes, name)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_host_helpers_agree(precision):
    rng = np.random.default_rng(3)
    z = rng.standard_normal(7) + 1j * rng.standard_normal(7)
    got = port_utils.as_interleaved(z, precision)
    want = jax_utils.as_interleaved(z, precision)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_utils.as_complex_np(got),
                                  jax_utils.as_complex_np(want))
    assert port_utils.real_dtype(precision) == jax_utils.real_dtype(precision)
    assert port_utils.complex_dtype(precision) \
        == jax_utils.complex_dtype(precision)


def test_complex_interleaved_round_trip_on_tensors():
    t = torch.tensor([[1.0, -2.0], [0.5, 3.0]])
    c = port_utils.interleaved_to_complex(t)
    assert torch.equal(c, torch.tensor([1 - 2j, 0.5 + 3j]))
    assert torch.equal(port_utils.complex_to_interleaved(c), t)


def test_from_import():
    from spfft_tpu_torch.utils import as_complex_np
    assert as_complex_np(np.array([[1.0, 2.0]], np.float32))[0] == 1 + 2j
