"""The port's hidden-Markov rate-class recursions (``ops/hmm.py``) against
the JAX package's on the same lattice: the forward lnL and its gradient,
the Viterbi path and score, and the forward-backward posteriors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu.ops import hmm as jhmm
from hyphy_tpu_torch.ops import hmm

torch.set_num_threads(2)


def _lattice(n_classes, n_patterns, n_sites, seed):
    rng = np.random.default_rng(seed)
    ll = rng.normal(-8.0, 3.0, size=(n_classes, n_patterns))
    dup = rng.integers(0, n_patterns, size=n_sites).astype(np.int32)
    init = rng.dirichlet(np.ones(n_classes))
    return ll, dup, init


def _path_score(path, ll, dup, trans, init):
    """Joint log score of a class path: start, transitions, emissions."""
    score = np.log(init[path[0]]) + ll[path[0], dup[0]]
    for s in range(1, len(path)):
        score += np.log(trans[path[s - 1], path[s]]) + ll[path[s], dup[s]]
    return score


def test_reference_viterbi_path_is_shifted():
    """The reference's path, scored, falls short of its own Viterbi score:
    its traceback drops site 0's state (ROADMAP 3.13)."""
    ll, dup, init = _lattice(3, 17, 60, seed=3)
    jt = jhmm.uniform_switching_matrix(3, jnp.asarray(0.3))
    jpath, jscore = jhmm.viterbi_path(jnp.asarray(ll), dup, jt, jnp.asarray(init))
    assert _path_score(np.asarray(jpath), ll, dup, np.asarray(jt), init) < jscore - 1.0


@pytest.mark.parametrize("n_classes,lam", [(2, 0.05), (3, 0.3), (4, 0.9)])
def test_forward_viterbi_posteriors_match_jax(n_classes, lam):
    ll, dup, init = _lattice(n_classes, 17, 60, seed=n_classes)
    jt = jhmm.uniform_switching_matrix(n_classes, jnp.asarray(lam))
    tt = hmm.uniform_switching_matrix(n_classes, lam)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-15)
    ref = float(jhmm.forward_log_likelihood(jnp.asarray(ll), dup, jt, jnp.asarray(init)))
    got = float(hmm.forward_log_likelihood(torch.tensor(ll), dup, tt, torch.tensor(init)))
    assert abs(got - ref) <= 1e-10 * abs(ref)
    jpath, jscore = jhmm.viterbi_path(jnp.asarray(ll), dup, jt, jnp.asarray(init))
    path, score = hmm.viterbi_path(torch.tensor(ll), dup, tt, torch.tensor(init))
    assert abs(score - jscore) <= 1e-10 * abs(jscore)
    # the port's path scores the Viterbi score; the reference's traceback
    # reports the states of sites 1..n-1 and then the last one again
    # (ROADMAP 3.13), so its path is the port's shifted by one site
    assert abs(_path_score(path, ll, dup, np.asarray(jt), init) - score) <= 1e-9 * abs(score)
    jpath = np.asarray(jpath)
    np.testing.assert_array_equal(path[1:], jpath[:-1])
    assert path[-1] == jpath[-1]
    jpost = np.asarray(jhmm.posterior_class_probabilities(jnp.asarray(ll), dup, jt,
                                                          jnp.asarray(init)))
    post = hmm.posterior_class_probabilities(torch.tensor(ll), dup, tt, torch.tensor(init))
    assert post.shape == (60, n_classes)
    np.testing.assert_allclose(post.numpy(), jpost, rtol=0, atol=1e-10)
    np.testing.assert_allclose(post.numpy().sum(axis=1), 1.0, atol=1e-12)


def test_forward_gradient_matches_jax():
    """d lnL / d (lattice, switching rate, start weights), the gradient
    BUSTED's --srv-hmm fit follows."""
    ll, dup, init = _lattice(3, 11, 40, seed=7)

    def jax_fn(ll_, lam_, init_):
        return jhmm.forward_log_likelihood(ll_, dup, jhmm.uniform_switching_matrix(3, lam_),
                                           init_)

    jg = jax.grad(jax_fn, argnums=(0, 1, 2))(jnp.asarray(ll), jnp.asarray(0.2), jnp.asarray(init))
    t_ll = torch.tensor(ll, requires_grad=True)
    t_lam = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    t_init = torch.tensor(init, requires_grad=True)
    hmm.forward_log_likelihood(t_ll, dup, hmm.uniform_switching_matrix(3, t_lam), t_init).backward()
    for ours, ref in zip((t_ll.grad, t_lam.grad, t_init.grad), jg):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)


def test_single_site_and_one_class_degenerate_cases():
    """One site: the forward lnL is the start-weighted mixture; a chain
    that never switches is the best single class."""
    ll, dup, init = _lattice(3, 5, 1, seed=1)
    got = float(hmm.forward_log_likelihood(torch.tensor(ll), dup, hmm.uniform_switching_matrix(
        3, 0.1), torch.tensor(init)))
    expect = np.log(np.sum(init * np.exp(ll[:, dup[0]])))
    assert abs(got - expect) <= 1e-12
    ll2, dup2, _ = _lattice(2, 6, 30, seed=2)
    path, _ = hmm.viterbi_path(torch.tensor(ll2), dup2, hmm.uniform_switching_matrix(2, 1e-12),
                               torch.tensor([0.5, 0.5]))
    best = int(np.argmax(ll2[:, dup2].sum(axis=1)))
    assert (path == best).all()
