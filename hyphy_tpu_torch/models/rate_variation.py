"""Site-to-site rate variation: discretized Gamma, Gamma+Inv, GDD.

Counterpart of ``hyphy_tpu/models/rate_variation.py`` (reference
``libv3/models/rate_variation.bf``): unit-mean distributions discretized
into K equiprobable bins with the MEAN representation (``_CategoryVariable``,
``src/core/category.cpp:1118-1206``):

  * Gamma(alpha, alpha): bin boundaries are quantiles at i/K; the bin mean
    is ``K * (F_{alpha+1}(b_{i+1}) - F_{alpha+1}(b_i))`` by the dCDF
    identity (``rate_variation.bf:104``).
  * GDD: free rates and stick-breaking weights, normalized to unit mean.

Everything is differentiable in alpha, as in the JAX package: the gamma
quantile is a fixed number of bisection and Newton steps on the regularized
incomplete gamma function, differentiated through.  ``torch.special.
gammainc`` has no derivative in its first argument, so :func:`gammainc` is
an autograd function whose backward gives both: ``d/dx P(a, x)`` is the
gamma density, and ``d/da P(a, x)`` is the term-by-term derivative of the
series ``P(a, x) = sum_n e^-x x^(a+n) / Gamma(a+n+1)``,

    d/da P(a, x) = sum_n e^-x x^(a+n) / Gamma(a+n+1) (log x - psi(a+n+1)),

summed in fp64 to past the terms' peak at ``n ~ x - a`` (every term
positive, so the sum is exact to round-off where the quantiles lie).  The
number of terms is read from the largest ``x`` on the host.
"""

from __future__ import annotations

import math

import torch

from hyphy_tpu_torch.models.parameters import ParamSpec, Specs, stick_breaking_weights


def _gammainc_grad_a(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d/da of the regularized lower incomplete gamma function, by the
    series above (fp64 inside whatever the inputs' dtype)."""
    a64, x64 = a.double(), x.double()
    x_max = float(x64.max()) if x64.numel() else 0.0
    a_min = float(a64.min()) if a64.numel() else 0.0
    # past the peak n ~ x - a by 40 standard deviations (sqrt(x)), and 60
    # terms at least: the tail after that is below fp64 round-off
    n_terms = int(min(200000, max(0.0, x_max - a_min) + 40.0 * math.sqrt(max(x_max, 1.0)) + 60))
    n = torch.arange(n_terms, dtype=torch.float64, device=a.device)
    an = a64[..., None] + n                                     # [..., N]
    safe_x = torch.clamp_min(x64, torch.finfo(torch.float64).tiny)[..., None]
    log_x = torch.log(safe_x)
    terms = torch.exp(an * log_x - safe_x - torch.lgamma(an + 1.0))
    grad = torch.sum(terms * (log_x - torch.special.digamma(an + 1.0)), dim=-1)
    return torch.where(x64 > 0, grad, torch.zeros_like(grad)).to(a.dtype)


class _GammaInc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x):
        a_b, x_b = torch.broadcast_tensors(a, x)
        ctx.save_for_backward(a_b, x_b)
        ctx.shapes = (a.shape, x.shape)
        return torch.special.gammainc(a_b, x_b)

    @staticmethod
    def backward(ctx, grad):
        a_b, x_b = ctx.saved_tensors
        a_shape, x_shape = ctx.shapes
        grad_a = grad_x = None
        if ctx.needs_input_grad[0]:
            grad_a = (grad * _gammainc_grad_a(a_b, x_b)).sum_to_size(a_shape)
        if ctx.needs_input_grad[1]:
            safe_x = torch.clamp_min(x_b, torch.finfo(x_b.dtype).tiny)
            density = torch.exp((a_b - 1.0) * torch.log(safe_x) - safe_x - torch.lgamma(a_b))
            density = torch.where(x_b > 0, density, torch.zeros_like(density))
            grad_x = (grad * density).sum_to_size(x_shape)
        return grad_a, grad_x


def gammainc(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Regularized lower incomplete gamma ``P(a, x)``, differentiable in
    both arguments (``jax.scipy.special.gammainc``)."""
    return _GammaInc.apply(a, x)


def gamma_quantile(p: torch.Tensor, shape: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Inverse CDF of Gamma(shape, rate): a bracket grown by doubling (8
    steps), 40 bisection steps, then 15 Newton steps on :func:`gammainc`,
    as the JAX package does it, differentiated through."""
    a = shape
    g = torch.lgamma(a)

    def cdf(x):
        return gammainc(a, x * rate)

    def pdf(x):
        xr = torch.clamp_min(x * rate, 1e-300)
        return torch.exp((a - 1.0) * torch.log(xr) - xr - g) * rate

    hi = (a + 10.0 * torch.sqrt(a) + 10.0) / rate
    for _ in range(8):
        hi = torch.where(cdf(hi) < p, hi * 2.0, hi)
    lo = torch.zeros_like(hi)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    x = 0.5 * (lo + hi)
    for _ in range(15):
        step = (cdf(x) - p) / torch.clamp_min(pdf(x), 1e-300)
        x = torch.clamp(x - step, lo * 0.0, hi * 2.0)
    return x


def discretized_gamma(alpha: torch.Tensor, k: int = 4):
    """(rates [k], weights [k]) for unit-mean Gamma(alpha, alpha)
    discretized into k equiprobable bins, MEAN representation."""
    dtype, device = alpha.dtype, alpha.device
    probs = torch.arange(1, k, dtype=dtype, device=device) / k
    bounds = gamma_quantile(probs, alpha, alpha)               # [k-1]
    # dCDF: F_{alpha+1, alpha}(x) = gammainc(alpha + 1, alpha * x)
    dcdf = gammainc(alpha + 1.0, alpha * bounds)
    dcdf = torch.cat([torch.zeros(1, dtype=dtype, device=device), dcdf,
                      torch.ones(1, dtype=dtype, device=device)])
    rates = (dcdf[1:] - dcdf[:-1]) * k
    weights = torch.full((k,), 1.0 / k, dtype=dtype, device=device)
    return rates, weights


def discretized_gamma_inv(alpha: torch.Tensor, p_inv: torch.Tensor, k: int = 4):
    """Gamma + invariant class (rate_variation.bf:194): class 0 has rate 0
    with weight p_inv; the gamma classes have weight (1 - p_inv)/k and rates
    scaled by 1/(1 - p_inv) to keep the overall mean at 1."""
    rates, _ = discretized_gamma(alpha, k)
    rates = rates / torch.clamp_min(1.0 - p_inv, 1e-10)
    zero = torch.zeros(1, dtype=rates.dtype, device=rates.device)
    all_rates = torch.cat([zero, rates])
    weights = torch.cat([p_inv.reshape(1), torch.ones(k, dtype=rates.dtype,
                                                      device=rates.device) * (1.0 - p_inv) / k])
    return all_rates, weights


def gdd_rates(raw_rates: torch.Tensor, weight_fracs: torch.Tensor, normalize: bool = True):
    """General discrete distribution: K free rates, K-1 stick-breaking
    weight fractions; normalized to unit mean when ``normalize``."""
    weights = stick_breaking_weights(weight_fracs)
    if normalize:
        mean = torch.sum(raw_rates * weights)
        return raw_rates / torch.clamp_min(mean, 1e-30), weights
    return raw_rates, weights


def gamma_specs(prefix: str = "rv_gamma") -> Specs:
    """alpha in [0.01, 100], init 0.5 (rate_variation.bf:84)."""
    return {f"{prefix}_alpha": ParamSpec(init=0.5, lower=0.01, upper=100.0)}
