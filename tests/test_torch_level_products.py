"""The port's K1 level step (plain version, on the CPU) against the JAX
package's CPU reference for the Pallas kernel, ``_einsum_impl``.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.ops.pallas_pruning import _einsum_impl
from hyphy_tpu_torch.ops.level_products import level_products, level_products_reference

torch.set_num_threads(2)


def _inputs(shape, seed=0):
    w, k, p, s = shape
    rng = np.random.default_rng(seed)
    cc = rng.uniform(0.1, 1.0, size=(w, k, p, s))
    cp = rng.uniform(0.0, 0.2, size=(w, k, s, s))
    return cc, cp


@pytest.mark.parametrize(
    "shape, dtype, tol",
    [
        # the shape and tolerance of tests/test_pallas_kernel.py
        ((5, 2, 700, 61), np.float32, dict(atol=1e-6, rtol=0)),
        ((5, 2, 700, 61), np.float64, dict(rtol=1e-12, atol=0)),
        # a trifurcating (K=3) level with a ragged pattern count
        ((3, 3, 1000, 61), np.float64, dict(rtol=1e-12, atol=0)),
    ],
)
def test_plain_matches_jax_reference(shape, dtype, tol):
    cc, cp = (x.astype(dtype) for x in _inputs(shape))
    ours = level_products(torch.from_numpy(cc), torch.from_numpy(cp)).numpy()
    ref = np.asarray(_einsum_impl(jnp.asarray(cc), jnp.asarray(cp)))
    assert ours.dtype == dtype
    np.testing.assert_allclose(ours, ref, **tol)


@pytest.mark.parametrize("shape", [(4, 2, 33, 61), (2, 3, 17, 4)])
def test_gradients_match_jax_vjp(shape):
    cc, cp = _inputs(shape, seed=1)
    g = np.random.default_rng(2).normal(size=(shape[0], shape[2], shape[3]))
    _, vjp = jax.vjp(_einsum_impl, jnp.asarray(cc), jnp.asarray(cp))
    ref_cc, ref_cp = vjp(jnp.asarray(g))
    cc_t = torch.tensor(cc, requires_grad=True)
    cp_t = torch.tensor(cp, requires_grad=True)
    level_products(cc_t, cp_t).backward(torch.from_numpy(g))
    np.testing.assert_allclose(cc_t.grad.numpy(), np.asarray(ref_cc), rtol=1e-10)
    np.testing.assert_allclose(cp_t.grad.numpy(), np.asarray(ref_cp), rtol=1e-10)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    cc, cp = (torch.from_numpy(x) for x in _inputs((2, 2, 9, 5)))
    before = level_products.launches
    out = level_products(cc, cp)
    assert level_products.launches == before
    assert torch.equal(out, level_products_reference(cc, cp))
