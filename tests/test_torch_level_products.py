"""The port's K1 level step (plain version, on the CPU) against the JAX
package's CPU reference for the Pallas kernel, ``_einsum_impl``, and the
kernel's launch plan and input checks.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.ops.pallas_pruning import _einsum_impl
from hyphy_tpu_torch.ops.level_products import (
    _check,
    _launch_plan,
    level_products,
    level_products_reference,
)

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
        # odd P: the kernel's tile starts are misaligned
        ((7, 2, 2047, 61), np.float64, dict(rtol=1e-12, atol=0)),
        # a polytomy at S=4
        ((9, 5, 130, 4), np.float64, dict(rtol=1e-12, atol=0)),
    ],
)
def test_plain_matches_jax_reference(shape, dtype, tol):
    cc, cp = (x.astype(dtype) for x in _inputs(shape))
    ours = level_products(torch.from_numpy(cc), torch.from_numpy(cp)).numpy()
    ref = np.asarray(_einsum_impl(jnp.asarray(cc), jnp.asarray(cp)))
    assert ours.dtype == dtype
    np.testing.assert_allclose(ours, ref, **tol)


@pytest.mark.parametrize(
    "shape, atol",
    [
        ((4, 2, 33, 61), 0.0),
        ((2, 3, 17, 4), 0.0),
        ((7, 2, 2047, 61), 0.0),
        # the cc gradient sums signed terms over i; with four other children
        # its smallest entry cancels to 5e-10 (median 3e-4), where the two
        # summation orders differ by 3e-19
        ((9, 5, 130, 4), 1e-15),
    ],
)
def test_gradients_match_jax_vjp(shape, atol):
    cc, cp = _inputs(shape, seed=1)
    g = np.random.default_rng(2).normal(size=(shape[0], shape[2], shape[3]))
    _, vjp = jax.vjp(_einsum_impl, jnp.asarray(cc), jnp.asarray(cp))
    ref_cc, ref_cp = vjp(jnp.asarray(g))
    cc_t = torch.tensor(cc, requires_grad=True)
    cp_t = torch.tensor(cp, requires_grad=True)
    level_products(cc_t, cp_t).backward(torch.from_numpy(g))
    np.testing.assert_allclose(cc_t.grad.numpy(), np.asarray(ref_cc), rtol=1e-10, atol=atol)
    np.testing.assert_allclose(cp_t.grad.numpy(), np.asarray(ref_cp), rtol=1e-10, atol=atol)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    cc, cp = (torch.from_numpy(x) for x in _inputs((2, 2, 9, 5)))
    before = level_products.launches
    out = level_products(cc, cp)
    assert level_products.launches == before
    assert torch.equal(out, level_products_reference(cc, cp))


_SMEM_LIMIT = 232448   # shared memory a block may use on an H100, after opt-in


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w, p", [(320, 2048), (1, 2048), (7, 2047), (320, 6144), (65535, 1)])
def test_launch_plan_fits_and_covers(dtype, w, p):
    size = dtype.itemsize
    states = 8 if dtype == torch.float32 else 4     # per thread, as the kernel
    for s in range(1, 65):
        for k in range(1, 9):
            sg, rp, tp, smem = _launch_plan(w, k, p, s, dtype)
            assert sg in (1, 2, 4, 8, 16) and states * sg >= s
            assert sg == 1 or states * sg < 2 * s          # the smallest that covers S
            assert tp == rp * 256 // sg
            assert 0 < smem <= _SMEM_LIMIT and smem % 32 == 0
            # two stages, each P's range and the tile's, with room for the
            # alignment shift and the state rows read past S
            assert smem >= 2 * (states * sg * s + tp * s + 2 * (16 // size - 1)) * size
            # one block per tile: the ceil(P / TP) tiles cover P exactly once,
            # and only the last may be ragged
            n_tiles = -(-p // tp)
            assert n_tiles >= 1 and (n_tiles - 1) * tp < p <= n_tiles * tp


def test_launch_plan_at_the_widest_level():
    # (320, 2, 2048, 61) fp32: 8x8 micro-tiles, 256-pattern tiles: 8 x 320
    # blocks for 132 SMs
    assert _launch_plan(320, 2, 2048, 61, torch.float32) == (8, 8, 256, 156224)


@pytest.mark.parametrize(
    "cc, cp, error",
    [
        # more states than the kernel's 64
        (torch.ones(1, 2, 3, 65), torch.ones(1, 2, 65, 65), ValueError),
        (torch.ones(1, 2, 3, 4), torch.ones(1, 2, 4, 4, dtype=torch.float64), TypeError),
        (torch.ones(1, 2, 3, 4, dtype=torch.int32), torch.ones(1, 2, 4, 4, dtype=torch.int32),
         TypeError),
        (torch.ones(1, 2, 4, 3).transpose(2, 3), torch.ones(1, 2, 4, 4), ValueError),
        (torch.ones(1, 2, 3, 4), torch.ones(1, 2, 4, 4).transpose(2, 3), ValueError),
    ],
    ids=["states", "dtype-mismatch", "int", "cc-strided", "cp-strided"],
)
def test_check_rejects(cc, cp, error):
    with pytest.raises(error):
        _check(cc, cp)
