"""Batched matrix exponentials for transition-probability matrices.

Counterpart of ``hyphy_tpu/ops/expm.py``, in plain PyTorch (no kernel yet):

  * :func:`expm` / :func:`transition_matrix` — batched scaling-and-squaring
    with a fixed Taylor core and a masked squaring ladder, for any square
    matrix (the non-reversible models' propagators);
  * :func:`shared_taylor_propagators` — ``P(t_b) = expm(q t_b)`` for ONE
    generator and many branch times, from shared powers of ``q`` and a
    shared binary squaring ladder (reference semantics of
    ``_Matrix::Exponentiate``, ``src/core/matrix.cpp:5537``);
    :func:`taylor_propagators_batched` — the same for MANY generators, each
    at its own times, in one batched pass (the BS-REL per-branch families).
  * :func:`taylor_action_factors` — the same series for a batch of
    generators (one per site and branch group), as factors that the
    per-site pruning applies to CLV vectors (the fp32 per-site route).
  * :func:`reversible_spectral` / :func:`spectral_propagators` — for a
    reversible ``Q`` with stationary ``pi``, one symmetric eigendecomposition
    (``torch.linalg.eigh``) gives ``P(t)`` for every branch as one matmul.

Every tensor created here takes its dtype and device from the inputs: the
JAX package runs with x64 on, where a bare literal is fp64, while torch's
default is fp32.
"""

from __future__ import annotations

import math

import torch


# enough Taylor terms that a matrix scaled to ||A|| <= 1/2 converges past
# fp64 machine epsilon: 0.5^18/18! ~ 2e-21
_TAYLOR_TERMS = 18
# squaring ladder depth: supports ||Q*t|| up to 2^_MAX_SQUARINGS / 2
_MAX_SQUARINGS = 14


def expm(a: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of ``a`` ([..., n, n]), batched over leading dims
    (the JAX package's ``expm``, ``hyphy_tpu/ops/expm.py:32``).

    Scaling-and-squaring: scale by 2^-s so the scaled inf-norm is <= 1/2,
    run a fixed-length Horner Taylor evaluation, then a masked squaring
    ladder (each batch element squares its own s times, at most 14).  The
    row renormalisation of a transition matrix is the caller's
    (:func:`transition_matrix`): ``expm`` also serves non-generators.
    """
    dtype, n = a.dtype, a.shape[-1]
    norm = torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1)          # [...]
    s = torch.ceil(torch.log2(torch.clamp_min(norm, 1e-30)) + 1.0)
    s = torch.clamp(s, 0, _MAX_SQUARINGS).to(torch.int64)
    scale = torch.exp2(-s.to(dtype))
    a_scaled = a * scale[..., None, None]
    eye = torch.eye(n, dtype=dtype, device=a.device).expand(a.shape)
    # Horner: exp(A) ~ I + A(I + A/2 (I + A/3 (...)))
    acc = eye
    for k in range(_TAYLOR_TERMS, 0, -1):
        acc = eye + (acc @ a_scaled) / k
    for k in range(_MAX_SQUARINGS):
        acc = torch.where((k < s)[..., None, None], acc @ acc, acc)
    return acc


def transition_matrix(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P(t) = expm(Q t) for Q [..., n, n] and t broadcastable to [...],
    made exactly row-stochastic (the non-reversible models' route)."""
    return row_renormalize(expm(q * t[..., None, None]))


def row_renormalize(p: torch.Tensor) -> torch.Tensor:
    """Restore exact row-stochasticity: P_ii += 1 - sum_j P_ij
    (reference: ``matrix.cpp:5837-5852`` diag_populator)."""
    n = p.shape[-1]
    deficit = 1.0 - torch.sum(p, dim=-1)
    return p + deficit[..., None] * torch.eye(n, dtype=p.dtype, device=p.device)


def _clip_negative(p: torch.Tensor) -> torch.Tensor:
    # torch.maximum splits the gradient at ties as jnp.maximum does
    # (clamp_min would pass all of it), so exact zeros match the reference
    return torch.maximum(p, torch.zeros((), dtype=p.dtype, device=p.device))


def ladder_depth(q: torch.Tensor, t: torch.Tensor, minimum: int, radius: float = 1.0,
                 maximum: int = 40) -> int:
    """Squaring-ladder depth at which no time saturates: the Taylor routes
    scale ``t_eff = t * 2^ceil(log2 ||q||)`` (``||q||`` the largest row sum
    of ``|q|`` over the batch ``q [..., S, S]``) and walk ``j = floor(t_eff
    / radius)`` over the ladder's bits, so ``2^depth > j`` needs ``depth =
    floor(log2(t_eff / radius)) + 1``; at least ``minimum``, at most
    ``maximum``.  A saturated time shortens every branch of a generator
    whose fast entries dominate its norm, and makes the likelihood jump
    where ``ceil(log2 ||q||)`` steps (BUSTED's line searches meet such
    jumps of ~0.4 lnL at large thetas and branch lengths; PRIME's rate
    modifier reaches e^9.2).  Reads two scalars on the host."""
    norm = torch.amax(torch.sum(torch.abs(q), dim=-1)).item()
    t_max = torch.amax(t).item() if t.numel() else 0.0
    if not (norm > 0 and t_max > 0):
        return minimum
    if not math.isfinite(norm):
        # an fp32 generator past the range (RELAX's omega^K): the value is
        # non-finite whatever the depth, and the line search backs off
        return maximum
    t_eff = t_max * 2.0 ** math.ceil(math.log2(max(norm, 1e-30)))
    if not math.isfinite(t_eff):
        return maximum
    return min(maximum, max(minimum, math.floor(math.log2(max(t_eff / radius, 1.0))) + 1))


def shared_taylor_propagators(
    q: torch.Tensor,             # [S, S] one shared generator
    t: torch.Tensor,             # [B] per-branch times
    max_squarings: int = 11,
) -> torch.Tensor:
    """P(t_b) = expm(q * t_b) for ONE generator and MANY times.

    The powers q^k are shared by every branch; each branch sums the series
    with its own coefficients (one [B,K]x[K,S^2] contraction) and applies
    the integer part of its scaled time as a binary product against shared
    matrices ``expm(2 qn)^(2^k)``.  Stays at working-precision round-off in
    fp32, so it is the fp32 route for grouped propagators
    (:func:`taylor_propagators_batched` is the same series for many
    generators with their own times).
    """
    dtype, device = q.dtype, q.device
    # series tail after K terms at argument 2: 2^(K+1)/(K+1)!
    # (fp32: 2^17/17! ~ 4e-10 — past fp32 round-off)
    terms = 28 if dtype == torch.float64 else 16
    # ladder/bit depth: supports ||Q t|| up to ~2^(s+1) before the
    # saturation clamp below; depth 11 covers ||Q t|| ~ 4096 (deeper:
    # ``max_squarings = ladder_depth(q, t, 11, radius=2.0)``)
    s_dim = q.shape[-1]
    # normalize the generator to unit inf-norm; fold the factor into t
    norm = torch.clamp_min(torch.max(torch.sum(torch.abs(q), dim=-1)), 1e-30)
    m = torch.ceil(torch.log2(norm))
    qn = q * torch.exp2(-m).to(dtype)
    t_eff = t * torch.exp2(m).to(dtype)
    # saturate beyond the ladder's range: at ||Q t|| ~ 2^(s+1) the chain is
    # essentially mixed (P ~ stationary), and an un-saturated argument would
    # make the truncated series diverge — huge finite "likelihoods" that
    # derail line searches probing large branch lengths
    t_eff = torch.clamp_max(t_eff, 2.0 ** (max_squarings + 1) - 0.01)

    eye = torch.eye(s_dim, dtype=dtype, device=device)
    pows = [eye]
    for _ in range(terms):
        pows.append(pows[-1] @ qn)
    pows = torch.stack(pows)                               # [K+1, S, S]
    ks = torch.arange(1, terms + 1, dtype=dtype, device=device)

    # All P(t) commute (one generator): P(t) = Taylor(r) @ expm(2 qn)^j with
    # t_eff = r + 2j, r in [0, 2).  The integer part is a binary product
    # against SHARED matrices M_k = expm(2 qn)^(2^k): each bit step is one
    # [B*S, S] x [S, S] GEMM.
    # the ladder's bits hold j < 2^s: where 2^(s+1) - 0.01 rounds up to
    # 2^(s+1) (fp32 past s = 16), clamp j (as an integer), and r with it
    j = torch.clamp_max(torch.floor(t_eff * 0.5).to(torch.int64), 2 ** max_squarings - 1)
    r = torch.clamp(t_eff - 2.0 * j.to(dtype), 0.0, 2.0)   # [B], in [0, 2]

    # coef[b, k] = r_b^k / k! via a stable running product
    coef = torch.cumprod(r[:, None] / ks[None, :], dim=1)  # [B, K]
    ones = torch.ones((t.shape[0], 1), dtype=dtype, device=device)
    coef = torch.cat([ones, coef], dim=1)
    p = torch.einsum("bk,kij->bij", coef, pows)

    coef2 = torch.cumprod(2.0 / ks, dim=0)                 # Taylor at r = 2
    coef2 = torch.cat([torch.ones((1,), dtype=dtype, device=device), coef2])
    mk = torch.einsum("k,kij->ij", coef2, pows)            # expm(2 qn)

    for k in range(max_squarings):
        bit = ((j >> k) & 1).to(torch.bool)
        pnew = (p.reshape(-1, s_dim) @ mk).reshape(p.shape)
        p = torch.where(bit[:, None, None], pnew, p)
        mk = _square(mk, k + 1 >= 11)
    return row_renormalize(_clip_negative(p))


def taylor_propagators_batched(
    q: torch.Tensor,             # [F, S, S] one generator per family
    t: torch.Tensor,             # [F] or [C, F] each family's own times
) -> torch.Tensor:
    """``P[.., f] = expm(q_f t[.., f])`` for MANY generators, each with its
    own times: :func:`shared_taylor_propagators` batched over the family
    axis, with each family's own norm scaling, series coefficients and
    squaring ladder (the JAX package's ``jax.vmap(shared_taylor_propagators)``
    over families, ``hyphy_tpu/models/bsrel.py:187-191``, with the times
    diagonal: family f at its own times only).

    The ladder depth is one for the whole batch, the depth at which no time
    saturates (:func:`ladder_depth`'s rule over every family's scaled time,
    at least 11, at most 40), read on the host once; a family whose times
    need fewer bits leaves the extra steps' bits unset.
    Squares past depth 11 are renormalised (:func:`_square`), and beyond 40
    times saturate as in the shared route.  About a hundred launches
    whatever F is.  Returns ``[F, S, S]`` or ``[C, F, S, S]``."""
    dtype, device = q.dtype, q.device
    single = t.dim() == 1
    if single:
        t = t[None]
    terms = 28 if dtype == torch.float64 else 16
    s_dim = q.shape[-1]
    norm = torch.clamp_min(torch.amax(torch.sum(torch.abs(q), dim=-1), dim=-1), 1e-30)   # [F]
    m = torch.ceil(torch.log2(norm))
    qn = q * torch.exp2(-m).to(dtype)[:, None, None]
    t_eff = t * torch.exp2(m).to(dtype)                    # [C, F]
    t_max = float(torch.amax(t_eff.detach())) if t_eff.numel() else 0.0   # the host read
    if not math.isfinite(t_max):
        depth = 40
    elif t_max > 0:
        depth = min(40, max(11, math.floor(math.log2(max(t_max / 2.0, 1.0))) + 1))
    else:
        depth = 11
    t_eff = torch.clamp_max(t_eff, 2.0 ** (depth + 1) - 0.01)

    eye = torch.eye(s_dim, dtype=dtype, device=device).expand(q.shape)
    pows = [eye]
    for _ in range(terms):
        pows.append(pows[-1] @ qn)
    pows = torch.stack(pows, dim=1)                        # [F, K+1, S, S]
    ks = torch.arange(1, terms + 1, dtype=dtype, device=device)
    j = torch.clamp_max(torch.floor(t_eff * 0.5).to(torch.int64), 2 ** depth - 1)
    r = torch.clamp(t_eff - 2.0 * j.to(dtype), 0.0, 2.0)   # [C, F]
    coef = torch.cumprod(r[..., None] / ks, dim=-1)        # [C, F, K]
    coef = torch.cat([torch.ones_like(coef[..., :1]), coef], dim=-1)
    p = torch.einsum("cfk,fkij->cfij", coef, pows)
    coef2 = torch.cumprod(2.0 / ks, dim=0)
    coef2 = torch.cat([torch.ones((1,), dtype=dtype, device=device), coef2])
    mk = torch.einsum("k,fkij->fij", coef2, pows)          # expm(2 qn_f)
    for k in range(depth):
        bit = ((j >> k) & 1).to(torch.bool)
        p = torch.where(bit[..., None, None], p @ mk, p)
        mk = _square(mk, k + 1 >= 11)
    p = row_renormalize(_clip_negative(p))
    return p[0] if single else p


def _square(m: torch.Tensor, renormalise: bool) -> torch.Tensor:
    """``m @ m`` for the squaring ladders.  Past their default depths (11
    and 12, where the JAX package stops) each square is made exactly
    row-stochastic again: a square doubles the row sums' round-off, so 30
    unrenormalised squares of an fp32 propagator (row sums 1 + 1e-7) reach
    row sums of e^100."""
    m = m @ m
    return row_renormalize(_clip_negative(m)) if renormalise else m


def taylor_action_factors(q: torch.Tensor, t: torch.Tensor, max_squarings: int = 12):
    """Factors for applying ``expm(q t_b)`` to VECTORS without ever
    materializing the per-branch matrices, for a batch of generators.

    ``q`` is ``[..., S, S]`` (e.g. ``[sites, groups, S, S]``), ``t`` the
    ``[B]`` per-branch times shared by every generator.  Returns
    ``(qn [..., S, S], m2p [..., L, S, S], r [..., B], j [..., B] int32)``
    with ``P(t_b) = Taylor(r_b qn) @ prod_k (m2p[k])^{bit_k(j_b)}`` (all
    commute: one generator); ``m2p[k] = expm(qn)^(2^k)``.  Applied to a
    vector v: ladder steps ``v <- m2p[k] v`` where bit k of ``j_b`` is set,
    then Horner ``acc <- v + (r_b / k) qn acc``.

    The Horner radius is 1 (``r in [0, 1)``): at radius 1 the fp32 series
    tail closes at 12 terms; the ladder depth 12 covers ``||Q t||`` up to
    ~4096, beyond which ``t_eff`` saturates.  Per generator: ``m = ceil(log2
    (max row-sum |q|))``, ``qn = q 2^-m``, ``t_eff = min(t 2^m, 2^12 -
    0.01)``.
    """
    dtype = q.dtype
    s_dim = q.shape[-1]
    norm = torch.clamp_min(torch.amax(torch.sum(torch.abs(q), dim=-1), dim=-1), 1e-30)
    m = torch.ceil(torch.log2(norm))                      # [...]
    qn = q * torch.exp2(-m).to(dtype)[..., None, None]
    t_eff = t * torch.exp2(m).to(dtype)[..., None]        # [..., B]
    t_eff = torch.clamp_max(t_eff, 2.0 ** max_squarings - 0.01)
    # j < 2^L also where 2^L - 0.01 rounds up to 2^L (fp32 past L = 17);
    # j is int32 as in the JAX package, so L <= 31
    j = torch.clamp_max(torch.floor(t_eff).to(torch.int64), 2 ** max_squarings - 1)
    r = torch.clamp(t_eff - j.to(dtype), 0.0, 1.0)
    j = j.to(torch.int32)

    # expm(qn) via the Taylor series at argument 1
    terms = taylor_action_terms(dtype)
    ks = torch.arange(1, terms + 1, dtype=dtype, device=q.device)
    coef1 = torch.cumprod(1.0 / ks, dim=0)
    pk = torch.eye(s_dim, dtype=dtype, device=q.device).expand(q.shape)
    m1 = pk
    for k in range(terms):
        pk = pk @ qn
        m1 = m1 + coef1[k] * pk
    m2p = [m1]
    for k in range(1, max_squarings):
        m2p.append(_square(m2p[-1], k >= 12))
    return qn, torch.stack(m2p, dim=-3), r, j


def taylor_action_terms(dtype) -> int:
    """The Taylor term count :func:`taylor_action_factors` uses for
    ``dtype``.  Tail bound at the radius-1 Horner argument: 1/(K+1)! * e —
    4e-10 at K=12 (under fp32 eps), 8e-18 at K=19 (under fp64 eps)."""
    return 19 if dtype == torch.float64 else 12


# ---------------------------------------------------------------------------
# reversible fast path

def reversible_spectral(q: torch.Tensor, pi: torch.Tensor):
    """Spectral decomposition of a reversible generator.

    For reversible Q with stationary pi, ``B = D^{1/2} Q D^{-1/2}`` is
    symmetric (D = diag(pi)); then ``expm(Qt) = D^{-1/2} U e^{L t} U^T
    D^{1/2}``.  Returns ``(left [..,n,n], eigenvalues [..,n], right
    [..,n,n])`` with ``P(t) = left @ diag(exp(L t)) @ right``.

    Zero-frequency states are guarded with a floor so absent states stay
    inert rather than producing NaNs.
    """
    tiny = torch.finfo(q.dtype).tiny
    pi_safe = torch.clamp_min(pi.to(q.dtype), tiny)
    sqrt_pi = torch.sqrt(pi_safe)
    b = q * (sqrt_pi[..., :, None] / sqrt_pi[..., None, :])
    b = 0.5 * (b + b.transpose(-1, -2))  # kill asymmetric round-off
    lam, u = torch.linalg.eigh(b)
    left = u / sqrt_pi[..., :, None]
    right = u.transpose(-1, -2) * sqrt_pi[..., None, :]
    return left, lam, right


def settle_zero_modes(lam: torch.Tensor) -> torch.Tensor:
    """A generator's eigenvalues with the round-off taken off its zero
    modes: ``eigh`` returns them at about ``+-eps * ||Q||``, and
    ``exp(lam t)`` turns that into garbage once ``t`` passes ~1 / (eps
    ||Q||): entries far above 1 (a positive mode), or a zero matrix that
    row renormalisation makes the identity (a negative one), where P is
    the stationary rows.  BUSTED's synonymous-rate classes reach such
    times: a class of weight ``w`` normalises to a rate up to ``1/w``.
    Eigenvalues at or above ``-64 eps max|lam|`` are set to 0 (a generator
    has none above 0); the rest are untouched."""
    tol = 64.0 * torch.finfo(lam.dtype).eps * torch.amax(lam.abs(), dim=-1, keepdim=True)
    return torch.where(lam >= -tol, torch.zeros_like(lam), lam)


def spectral_propagators(left, lam, right, t):
    """P(t) for a batch of times from one spectral decomposition.

    ``t[..., None]`` must broadcast against ``lam``: e.g. shared Q
    (lam [n], t [B]) -> [B, n, n]; per-branch Q (lam [B, n], t [B]) ->
    [B, n, n].
    """
    el = torch.exp(lam * t[..., None])
    p = (left * el[..., None, :]) @ right
    # clip tiny negative round-off; renormalize rows exactly
    return row_renormalize(_clip_negative(p))
