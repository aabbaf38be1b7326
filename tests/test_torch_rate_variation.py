"""The port's rate-variation distributions (``models/rate_variation.py``)
and its differentiable ``gammainc`` against the JAX package's, values and
alpha gradients against ``jax.grad`` (1e-8 relative).

The JAX package's ``discretized_gamma`` raises for every k: its bracket scan
carries a scalar into a step that returns one bound per probability
(ROADMAP 3.25), so its ``discretized_gamma_inv`` does too.  Its
``gamma_quantile`` works one probability at a time, so the reference here
composes the JAX package's ``gamma_quantile`` under ``jax.vmap`` with
``jax.scipy.special.gammainc``, as ``discretized_gamma`` would.  Below
alpha ~0.05 the JAX package's alpha gradient is NaN (its quantiles reach
0), so the alphas held are 0.1 and up."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammainc as jgammainc

from hyphy_tpu.models import rate_variation as jrv
from hyphy_tpu_torch.models import rate_variation as trv

torch.set_num_threads(2)

ALPHAS = [0.1, 0.5, 1.7, 12.0, 99.0]


def _jax_discretized_gamma(alpha, k):
    probs = jnp.arange(1, k, dtype=jnp.float64) / k
    bounds = jax.vmap(lambda p: jrv.gamma_quantile(p, alpha, alpha))(probs)
    dcdf = jgammainc(alpha + 1.0, alpha * bounds)
    dcdf = jnp.concatenate([jnp.zeros(1), dcdf, jnp.ones(1)])
    return (dcdf[1:] - dcdf[:-1]) * k


# the JAX side compiled once per k (the alphas are arguments, not constants)
_JAX_RATES = {k: jax.jit(lambda a, k=k: _jax_discretized_gamma(a, k)) for k in (2, 4, 6)}
_JAX_GRAD = {k: jax.jit(jax.grad(lambda a, k=k: jnp.sum(_jax_discretized_gamma(a, k)
                                                        * jnp.arange(1, k + 1))))
             for k in (2, 4, 6)}


def _jax_gamma_inv(alpha, p_inv, k):
    rates = _jax_discretized_gamma(alpha, k) / jnp.maximum(1.0 - p_inv, 1e-10)
    return jnp.concatenate([jnp.zeros(1), rates])


def test_jax_discretized_gamma_raises():
    with pytest.raises(TypeError):
        jrv.discretized_gamma(jnp.asarray(0.5), 4)


@pytest.mark.parametrize("a, x", [(0.3, 0.01), (0.5, 0.7), (2.0, 1.5), (2.0, 9.0),
                                  (13.0, 11.0), (101.0, 95.0), (101.0, 130.0)])
def test_gammainc_value_and_gradients(a, x):
    at = torch.tensor(a, dtype=torch.float64, requires_grad=True)
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    val = trv.gammainc(at, xt)
    ga, gx = torch.autograd.grad(val, (at, xt))
    jval = float(jgammainc(a, x))
    jga, jgx = jax.grad(lambda u, v: jgammainc(u, v), argnums=(0, 1))(a, x)
    # torch.special.gammainc's value is within 8.5e-10 (relative) of an
    # exact one at a >= 30 (checked with mpmath), the JAX package's within
    # 3e-14; the derivatives are the port's own
    assert float(val.detach()) == pytest.approx(jval, rel=1e-9)
    assert float(ga) == pytest.approx(float(jga), rel=1e-8)
    assert float(gx) == pytest.approx(float(jgx), rel=1e-12)


def _quantiles(p, alpha):
    return jax.vmap(lambda pp: jrv.gamma_quantile(pp, alpha, alpha))(p)


_JAX_QUANTILES = jax.jit(lambda p, a: (_quantiles(p, a), jax.grad(
    lambda b: jnp.sum(_quantiles(p, b)))(a)))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_gamma_quantile_and_gradient(alpha):
    p = np.array([0.1, 0.25, 0.5, 0.9])
    at = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    q = trv.gamma_quantile(torch.tensor(p), at, at)
    g = torch.autograd.grad(q.sum(), at)[0]
    jq, jg = _JAX_QUANTILES(jnp.asarray(p), jnp.asarray(alpha))
    # the quantile carries torch.special.gammainc's value error (above):
    # 4.8e-11 relative at alpha 99
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-10)
    assert float(g) == pytest.approx(float(jg), rel=1e-8)


@pytest.mark.parametrize("k", [2, 4, 6])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_discretized_gamma_values_and_gradient(alpha, k):
    at = torch.tensor(alpha, dtype=torch.float64, requires_grad=True)
    rates, weights = trv.discretized_gamma(at, k)
    probe = torch.arange(1, k + 1, dtype=torch.float64)
    g = torch.autograd.grad((rates * probe).sum(), at)[0]
    jr = _JAX_RATES[k](jnp.asarray(alpha))
    jg = _JAX_GRAD[k](jnp.asarray(alpha))
    np.testing.assert_allclose(rates.detach().numpy(), np.asarray(jr), rtol=1e-10)
    np.testing.assert_allclose(weights.numpy(), np.full(k, 1.0 / k))
    assert float((rates * weights).sum()) == pytest.approx(1.0, abs=1e-10)     # unit mean
    assert float(g) == pytest.approx(float(jg), rel=1e-8)


def test_gamma_inv_and_gdd():
    alpha, p_inv = torch.tensor(0.8, dtype=torch.float64), torch.tensor(0.2, dtype=torch.float64)
    rates, weights = trv.discretized_gamma_inv(alpha, p_inv, 4)
    np.testing.assert_allclose(rates.numpy(), np.asarray(_jax_gamma_inv(0.8, 0.2, 4)), rtol=1e-10)
    np.testing.assert_allclose(weights.numpy(), [0.2, 0.2, 0.2, 0.2, 0.2], rtol=1e-15)
    raw = np.array([0.3, 1.1, 4.0])
    fr = np.array([0.6, 0.3])
    for normalize in (True, False):
        tr_, tw_ = trv.gdd_rates(torch.tensor(raw), torch.tensor(fr), normalize)
        jr_, jw_ = jrv.gdd_rates(jnp.asarray(raw), jnp.asarray(fr), normalize)
        np.testing.assert_allclose(tr_.numpy(), np.asarray(jr_), rtol=1e-15)
        np.testing.assert_allclose(tw_.numpy(), np.asarray(jw_), rtol=1e-15)
    assert trv.gamma_specs() == {"rv_gamma_alpha": trv.ParamSpec(init=0.5, lower=0.01,
                                                                 upper=100.0)}
    j = jrv.gamma_specs()["rv_gamma_alpha"]
    assert (j.init, j.lower, j.upper) == (0.5, 0.01, 100.0)
