"""The port's host modules against the JAX package's: ``ops/linalg.py``
(equal results, 1e-12), ``utils/random.py`` (the same draws for a seed),
``scfg.py`` (equal inside, outside, CYK and EM on ``tests/test_scfg.py``'s
grammar), ``align.py`` (the native kernels equal to their Python mirror and
to the JAX package's results: scores and strings), and the native
``datapath.cpp`` (TN93 against the NumPy TN93, 1e-12; pattern compression
against ``np.unique``); a failed native build raises with the compiler's
output."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyphy_tpu import align as jalign
from hyphy_tpu import scfg as jscfg
from hyphy_tpu.ops import linalg as jlinalg
from hyphy_tpu.utils import random as jrandom
from hyphy_tpu_torch import align, native, scfg
from hyphy_tpu_torch.ops import cuda_build, linalg
from hyphy_tpu_torch.utils import random as trandom

torch.set_num_threads(2)


# -- linalg ----------------------------------------------------------------


def test_eigensystem_inverse_and_lu_match_jax():
    rng = np.random.default_rng(0)
    sym = rng.normal(size=(6, 6))
    sym = sym + sym.T
    w, v = linalg.eigensystem(torch.tensor(sym))
    jw, jv = jlinalg.eigensystem(sym)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(v.numpy() @ np.diag(w.numpy()) @ v.numpy().T, sym, atol=1e-12)
    gen = rng.normal(size=(5, 5))
    w, v = linalg.eigensystem(gen)
    jw, jv = jlinalg.eigensystem(gen)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12)
    a = rng.normal(size=(5, 5)) + 5 * np.eye(5)
    np.testing.assert_allclose(linalg.inverse(a).numpy(), np.asarray(jlinalg.inverse(a)),
                               rtol=1e-12, atol=1e-14)
    lu, piv = linalg.lu_decompose(torch.tensor(a))
    jlu, jpiv = jlinalg.lu_decompose(a)
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    for b in (rng.normal(size=5), rng.normal(size=(5, 3))):
        x = linalg.lu_solve((lu, piv), b).numpy()
        np.testing.assert_allclose(x, np.asarray(jlinalg.lu_solve((jlu, jpiv), jnp.asarray(b))),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(a @ x, b, atol=1e-12)


def test_simplex_and_fisher_match_jax():
    kw = dict(a_ub=[[1.0, 2.0], [3.0, 1.0]], b_ub=[4.0, 6.0], maximize=True)
    val, x = linalg.simplex_solve([1.0, 1.0], **kw)
    jval, jx = jlinalg.simplex_solve([1.0, 1.0], **kw)
    assert val == jval and np.array_equal(x, jx)
    assert linalg.simplex_solve([1.0], a_ub=[[1.0], [-1.0]], b_ub=[1.0, -2.0]) is None
    table = np.array([[1, 9], [11, 3]])
    assert linalg.fisher_exact(table) == jlinalg.fisher_exact(table)
    big = np.array([[3, 1, 4], [1, 5, 2]])
    assert linalg.fisher_exact(big, n_simulations=400, seed=3) == jlinalg.fisher_exact(
        big, n_simulations=400, seed=3)


# -- random ----------------------------------------------------------------


def test_random_draws_equal_the_jax_packages():
    lo, hi = np.zeros(3), np.array([1.0, 2.0, 5.0])
    np.testing.assert_array_equal(trandom.latin_hypercube(10, lo, hi, seed=1),
                                  jrandom.latin_hypercube(10, lo, hi, seed=1))
    np.testing.assert_array_equal(trandom.dirichlet(np.ones(4), size=3, seed=2),
                                  jrandom.dirichlet(np.ones(4), size=3, seed=2))
    np.testing.assert_array_equal(trandom.gaussian(np.zeros(3), np.eye(3), size=7, seed=4),
                                  jrandom.gaussian(np.zeros(3), np.eye(3), size=7, seed=4))
    scale = np.array([[1.0, 0.3], [0.3, 2.0]])
    np.testing.assert_array_equal(trandom.wishart(50, scale, seed=5),
                                  jrandom.wishart(50, scale, seed=5))
    np.testing.assert_array_equal(trandom.inverse_wishart(9, scale, seed=6),
                                  jrandom.inverse_wishart(9, scale, seed=6))
    np.testing.assert_array_equal(trandom.multinomial(100, np.ones(4) / 4, size=2, seed=7),
                                  jrandom.multinomial(100, np.ones(4) / 4, size=2, seed=7))
    s = trandom.latin_hypercube(10, np.zeros(2), np.ones(2), seed=8)
    for d in range(2):
        assert sorted(np.floor(s[:, d] * 10).astype(int)) == list(range(10))


# -- scfg ------------------------------------------------------------------


def _grammar(module):
    binary = np.zeros((2, 2, 2))
    emission = np.zeros((2, 2))
    binary[0, 0, 0] = 0.3
    binary[0, 1, 1] = 0.1
    emission[0] = [0.4, 0.2]
    binary[1, 1, 1] = 0.2
    emission[1] = [0.3, 0.5]
    return module.SCFG(binary, emission)


def test_scfg_equals_the_jax_packages():
    g, jg = _grammar(scfg), _grammar(jscfg)
    for tokens in [(0,), (0, 1), (1, 0, 0), (0, 1, 1, 0)]:
        beta, jbeta = g.inside(tokens), jg.inside(tokens)
        np.testing.assert_array_equal(beta, jbeta)
        np.testing.assert_array_equal(g.outside(tokens, beta), jg.outside(tokens, jbeta))
        assert g.log_likelihood(tokens) == jg.log_likelihood(tokens)
        assert g.cyk(tokens) == jg.cyk(tokens)
    total = sum(np.exp(g.log_likelihood(s)) for n in (1, 2, 3)
                for s in itertools.product(range(2), repeat=n))
    assert total < 1.0 + 1e-9
    corpus = [(0, 1), (0, 0, 1), (1, 0), (0, 1, 1, 0)]
    fitted, trace = g.fit_em(corpus, max_iterations=25)
    jfitted, jtrace = jg.fit_em(corpus, max_iterations=25)
    np.testing.assert_array_equal(trace, jtrace)
    np.testing.assert_array_equal(fitted.binary, jfitted.binary)
    np.testing.assert_array_equal(fitted.emission, jfitted.emission)
    assert trace[-1] > trace[0]


# -- align -----------------------------------------------------------------


def _random_pairs(rng, n, alphabet, lo, hi):
    return [("".join(rng.choice(list(alphabet), size=rng.integers(lo, hi))),
             "".join(rng.choice(list(alphabet), size=rng.integers(lo, hi)))) for _ in range(n)]


def test_align_sequences_native_equals_mirror_and_jax():
    rng = np.random.default_rng(0)
    pairs = _random_pairs(rng, 6, "ACGT", 5, 30) + [("ACGTACGT", "ACGTACGT"),
                                                    ("TTACGT", "ACGT")]
    for a, b in pairs:
        for local in (False, True):
            got = align.align_sequences(a, b, local=local)
            mirror = align.align_sequences(a, b, local=local, use_native=False)
            ref = jalign.align_sequences(a, b, local=local)
            assert got[0] == mirror[0] == ref[0], (a, b, local)
            assert got == ref, (a, b, local)
            if not local:
                assert got[1].replace("-", "") == a and got[2].replace("-", "") == b
    prot = align.align_sequences("MKLVWAGHK", "MKLWAGK", datatype="protein")
    assert prot == jalign.align_sequences("MKLVWAGHK", "MKLWAGK", datatype="protein")
    assert prot[0] == align.align_sequences("MKLVWAGHK", "MKLWAGK", datatype="protein",
                                            use_native=False)[0]


def test_align_codon_native_equals_mirror_and_jax():
    rng = np.random.default_rng(1)
    cases = [("ATGAAACCCGGG", "ATGCCCGGG"), ("ATGAAACCCGGGTTT", "ATGAACCCGGGTTT"),
             ("ATGAAACCCGGGTTT", "ATGAAAACCCGGGTTT")]
    for _ in range(4):
        ref = "".join(rng.choice(list("ACGT"), size=3 * int(rng.integers(4, 9))))
        qry = list(ref)
        for _ in range(int(rng.integers(1, 3))):
            qry.pop(int(rng.integers(0, len(qry))))
        cases.append((ref, "".join(qry)))
    for ref, qry in cases:
        got = align.align_codon(ref, qry)
        mirror = align.align_codon(ref, qry, use_native=False)
        want = jalign.align_codon(ref, qry)
        assert got[0] == mirror[0] == want[0], (ref, qry)
        assert got == want, (ref, qry)
        assert got[1].replace("-", "") == ref and got[2].replace("-", "") == qry


# -- datapath --------------------------------------------------------------


def test_native_tn93_equals_numpy_and_jax():
    from hyphy_tpu.methods import gard as jgard
    from hyphy_tpu_torch.data.alignment import Alignment
    from hyphy_tpu_torch.data.filter import DataFilter
    from hyphy_tpu_torch.methods import gard

    rng = np.random.default_rng(3)
    base = rng.choice(list("ACGT"), size=300)
    seqs = []
    for i in range(9):
        s = base.copy()
        flip = rng.random(300) < 0.05 * (i + 1)
        s[flip] = rng.choice(list("ACGT"), size=int(flip.sum()))
        s[rng.random(300) < 0.05] = "N"
        seqs.append("".join(s))
    seqs.append("".join(rng.choice(list("ACGT"), size=300)))     # near saturation
    seqs.append("-" * 300)                                        # no overlap
    names = [f"s{i}" for i in range(len(seqs))]
    filt = DataFilter.from_alignment(Alignment(names, seqs), "nucleotide")
    nat = gard.tn93_distance(filt)
    ref = gard.tn93_distance(filt, use_native=False)
    np.testing.assert_allclose(nat, ref, rtol=1e-12, atol=1e-12)
    assert (nat[-1, :-1] == 5.0).all()
    from hyphy_tpu.data.alignment import Alignment as JAlignment
    from hyphy_tpu.data.filter import DataFilter as JDataFilter

    jd = jgard.tn93_distance(JDataFilter.from_alignment(JAlignment(names, seqs), "nucleotide"))
    np.testing.assert_allclose(nat, jd, rtol=1e-12, atol=1e-12)


def test_native_compress_patterns_equals_unique():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 3, size=(5, 400)).astype(np.int32)
    index, first = native.compress_patterns(codes)
    _, first_ref, inverse = np.unique(codes.T, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first_ref, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    np.testing.assert_array_equal(first, np.sort(first_ref))
    np.testing.assert_array_equal(index, rank[inverse.reshape(-1)])
    np.testing.assert_array_equal(codes[:, first][:, index], codes)


def test_failed_native_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    (tmp_path / "broken.cpp").write_text("extern \"C\" int f() { return undefined_name; }\n")
    monkeypatch.setattr(cuda_build, "NATIVE", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undefined_name"):
        cuda_build.load("broken", host=True)
    assert not list((tmp_path / "build").glob("*.so"))
