"""`gather_rows` (kernel K5; on the CPU its plain version) against the
JAX package's row gather (`jnp.take` along rows, the XLA gather of
following.py:275, refpoints.py:1247 and polyline_stages.py:431, which
the Pallas probe's `gather_p` replaces) on the same table and indices.

Exact: a gather copies values.  The kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgegraph3d_tpu_torch.ops.gather import gather_rows


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_gather_rows_matches_jax(dtype):
    rng = np.random.default_rng(3)
    table = rng.normal(0, 100.0, (512, 128)).astype(np.float32)
    rows = rng.integers(0, 512, 2000).astype(dtype)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(rows), axis=0))
    got = gather_rows(torch.as_tensor(table), torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [[0, 10], [3, 11]])
def test_gather_rows_out_of_range_raises_on_cpu(bad):
    """The CPU path is `table[rows]`: an index past the table raises
    IndexError (the card fails a device-side assert instead)."""
    with pytest.raises(IndexError):
        gather_rows(torch.zeros((10, 8)), torch.tensor(bad))
