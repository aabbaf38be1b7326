"""Pairwise sequence alignment (the reference's ``AlignSequences`` HBL
command, ``src/core/alignment.cpp``).

Counterpart of ``hyphy_tpu/align.py``, with its scores, its Python mirrors
and its calling conventions.  Two modes, mirroring the reference:

  * :func:`align_sequences` — affine-gap Gotoh alignment of nucleotide or
    protein strings (global or local).
  * :func:`align_codon` — codon-aware alignment of a coding query against an
    in-frame reference: the reference strand moves in whole codons, the
    query may consume 1..5 nt per step paying a per-nucleotide frameshift
    ("miscall") penalty, as in ``CodonAlignStringsStep``
    (``alignment.cpp:151``; 3x5/3x4/3x2/3x1 partial-codon scoring
    ``alignment.cpp:225-470``).

The DP kernels are host C++ (``native/align.cpp``, built by
``ops/cuda_build.py`` into ``build/hyphy_tpu_torch/`` and loaded with
ctypes); a failed build raises.  The pure-Python mirror runs when the caller
asks for it (``use_native=False``) and is what the tests hold the native
kernels to.  Alignment is irregular, sequential DP: it stays on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from hyphy_tpu_torch import native as _native
from hyphy_tpu_torch.data.genetic_code import GeneticCode

_NUC = "ACGT"
_AA = "ACDEFGHIKLMNPQRSTVWY"

# BLOSUM62 (Henikoff & Henikoff 1992; standard public substitution scores),
# rows/cols in _AA order.
_BLOSUM62 = np.array([
    # A  C  D  E  F  G  H  I  K  L  M  N  P  Q  R  S  T  V  W  Y
    [ 4, 0,-2,-1,-2, 0,-2,-1,-1,-1,-1,-2,-1,-1,-1, 1, 0, 0,-3,-2],  # A
    [ 0, 9,-3,-4,-2,-3,-3,-1,-3,-1,-1,-3,-3,-3,-3,-1,-1,-1,-2,-2],  # C
    [-2,-3, 6, 2,-3,-1,-1,-3,-1,-4,-3, 1,-1, 0,-2, 0,-1,-3,-4,-3],  # D
    [-1,-4, 2, 5,-3,-2, 0,-3, 1,-3,-2, 0,-1, 2, 0, 0,-1,-2,-3,-2],  # E
    [-2,-2,-3,-3, 6,-3,-1, 0,-3, 0, 0,-3,-4,-3,-3,-2,-2,-1, 1, 3],  # F
    [ 0,-3,-1,-2,-3, 6,-2,-4,-2,-4,-3, 0,-2,-2,-2, 0,-2,-3,-2,-3],  # G
    [-2,-3,-1, 0,-1,-2, 8,-3,-1,-3,-2, 1,-2, 0, 0,-1,-2,-3,-2, 2],  # H
    [-1,-1,-3,-3, 0,-4,-3, 4,-3, 2, 1,-3,-3,-3,-3,-2,-1, 3,-3,-1],  # I
    [-1,-3,-1, 1,-3,-2,-1,-3, 5,-2,-1, 0,-1, 1, 2, 0,-1,-2,-3,-2],  # K
    [-1,-1,-4,-3, 0,-4,-3, 2,-2, 4, 2,-3,-3,-2,-2,-2,-1, 1,-2,-1],  # L
    [-1,-1,-3,-2, 0,-3,-2, 1,-1, 2, 5,-2,-2, 0,-1,-1,-1, 1,-1,-1],  # M
    [-2,-3, 1, 0,-3, 0, 1,-3, 0,-3,-2, 6,-2, 0, 0, 1, 0,-3,-4,-2],  # N
    [-1,-3,-1,-1,-4,-2,-2,-3,-1,-3,-2,-2, 7,-1,-2,-1,-1,-2,-4,-3],  # P
    [-1,-3, 0, 2,-3,-2, 0,-3, 1,-2, 0, 0,-1, 5, 1, 0,-1,-2,-2,-1],  # Q
    [-1,-3,-2, 0,-3,-2, 0,-3, 2,-2,-1, 0,-2, 1, 5,-1,-1,-3,-3,-2],  # R
    [ 1,-1, 0, 0,-2, 0,-1,-2, 0,-2,-1, 1,-1, 0,-1, 4, 1,-2,-3,-2],  # S
    [ 0,-1,-1,-1,-2,-2,-2,-1,-1,-1,-1, 0,-1,-1,-1, 1, 5, 0,-2,-2],  # T
    [ 0,-1,-3,-2,-1,-3,-3, 3,-2, 1, 1,-3,-2,-2,-3,-2, 0, 4,-3,-1],  # V
    [-3,-2,-4,-3, 1,-2,-2,-3,-3,-2,-1,-4,-4,-2,-3,-3,-2,-3,11, 2],  # W
    [-2,-2,-3,-2, 3,-3, 2,-1,-2,-1,-1,-2,-3,-1,-2,-2,-2,-1, 2, 7],  # Y
], dtype=np.float64)


def nucleotide_scores(match: float = 5.0, mismatch: float = -4.0) -> np.ndarray:
    s = np.full((4, 4), mismatch, dtype=np.float64)
    np.fill_diagonal(s, match)
    return s


def protein_scores() -> np.ndarray:
    return _BLOSUM62.copy()


def codon_scores(
    gc: Optional[GeneticCode] = None,
    synonymous_bonus: float = 1.0,
    stop_penalty: float = -50.0,
) -> np.ndarray:
    """64x64 codon substitution scores = BLOSUM62 of the encoded amino
    acids, a bonus for synonymous pairs, and a stop penalty (the reference
    builds its codon score matrices the same way from a protein model,
    ``alignment.cpp`` HBL options)."""
    gc = gc or GeneticCode("Universal")
    # codon index n1*16 + n2*4 + n3 over ACGT — same convention as
    # data.genetic_code.codon_index
    aa_of = [gc.translation[cod] for cod in range(64)]
    s = np.zeros((64, 64), dtype=np.float64)
    for a in range(64):
        for b in range(64):
            if aa_of[a] == "*" or aa_of[b] == "*":
                s[a, b] = stop_penalty
            else:
                s[a, b] = _BLOSUM62[_AA.index(aa_of[a]), _AA.index(aa_of[b])]
                if aa_of[a] == aa_of[b]:
                    s[a, b] += synonymous_bonus
    return s


def _encode(seq: str, alphabet: str) -> np.ndarray:
    idx = {c: i for i, c in enumerate(alphabet)}
    return np.array(
        [idx.get(c.upper(), -1) for c in seq], dtype=np.int32
    )


def _decode(path: np.ndarray, seq: str) -> str:
    return "".join("-" if i < 0 else seq[i] for i in path)


# ---------------------------------------------------------------------------
# pure-Python mirrors of native/align.cpp (use_native=False, and the tests' plain version)

_NEG = -1e300


def _gotoh_py(a, b, score, gap_open, gap_extend, local):
    la, lb = len(a), len(b)
    M = np.full((la + 1, lb + 1), _NEG)
    X = np.full((la + 1, lb + 1), _NEG)
    Y = np.full((la + 1, lb + 1), _NEG)
    M[0, 0] = 0.0
    for j in range(1, lb + 1):
        Y[0, j] = max(-gap_open - (j - 1) * gap_extend, 0.0) if local \
            else -gap_open - (j - 1) * gap_extend
    for i in range(1, la + 1):
        X[i, 0] = max(-gap_open - (i - 1) * gap_extend, 0.0) if local \
            else -gap_open - (i - 1) * gap_extend
    ptr_m = np.zeros((la + 1, lb + 1), dtype=np.int8)  # best prev state
    xext = np.zeros((la + 1, lb + 1), dtype=bool)
    yext = np.zeros((la + 1, lb + 1), dtype=bool)
    xext[2:, 0] = True
    yext[0, 2:] = True
    best, bi, bj = 0.0, 0, 0
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            s = score[a[i - 1], b[j - 1]] if a[i - 1] >= 0 and b[j - 1] >= 0 \
                else -gap_open
            prev = (M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1])
            k = int(np.argmax(prev))
            m = prev[k] + s
            if local and m < 0:
                m = 0.0
            M[i, j] = m
            ptr_m[i, j] = k
            xo = max(M[i - 1, j], Y[i - 1, j]) - gap_open
            xe = X[i - 1, j] - gap_extend
            X[i, j] = max(xo, xe)
            xext[i, j] = xe > xo
            yo = max(M[i, j - 1], X[i, j - 1]) - gap_open
            ye = Y[i, j - 1] - gap_extend
            Y[i, j] = max(yo, ye)
            yext[i, j] = ye > yo
            if local:
                cb = max(M[i, j], X[i, j], Y[i, j])
                if cb > best:
                    best, bi, bj = cb, i, j
    i, j = (bi, bj) if local else (la, lb)
    cands = (M[i, j], X[i, j], Y[i, j])
    state = int(np.argmax(cands))
    final = cands[state]
    pa, pb = [], []
    while i > 0 or j > 0:
        if local and max(M[i, j], X[i, j], Y[i, j]) <= 0:
            break
        if state == 0:
            if i == 0 or j == 0:
                break
            pa.append(i - 1)
            pb.append(j - 1)
            prev = (M[i - 1, j - 1], X[i - 1, j - 1], Y[i - 1, j - 1])
            state = int(np.argmax(prev))
            i, j = i - 1, j - 1
        elif state == 1:
            if i == 0:
                break
            pa.append(i - 1)
            pb.append(-1)
            ext = xext[i, j]
            i -= 1
            state = 1 if ext else (0 if M[i, j] >= Y[i, j] else 2)
        else:
            if j == 0:
                break
            pa.append(-1)
            pb.append(j - 1)
            ext = yext[i, j]
            j -= 1
            state = 2 if ext else (0 if M[i, j] >= X[i, j] else 1)
    return final, np.array(pa[::-1], dtype=np.int32), np.array(pb[::-1], dtype=np.int32)


def _codon_align_py(ref, qry, cscore, gap_open, gap_extend,
                    gap_open_q, gap_extend_q, miscall):
    nr, lq = len(ref) // 3, len(qry)
    M = np.full((nr + 1, lq + 1), _NEG)
    X = np.full((nr + 1, lq + 1), _NEG)
    Y = np.full((nr + 1, lq + 1), _NEG)
    move = np.zeros((nr + 1, lq + 1), dtype=np.int8)
    xext = np.zeros((nr + 1, lq + 1), dtype=bool)
    yext = np.zeros((nr + 1, lq + 1), dtype=bool)
    M[0, 0] = 0.0
    for j in range(1, lq + 1):
        Y[0, j] = -gap_open_q - (j - 1) * gap_extend_q
    yext[0, 2:] = True
    for i in range(1, nr + 1):
        X[i, 0] = -gap_open - (i - 1) * gap_extend
    xext[2:, 0] = True

    def step_score(codon_row, q):
        k = len(q)
        row = cscore[codon_row]
        if k == 3:
            if min(q) < 0:
                return 0.0
            return row[q[0] * 16 + q[1] * 4 + q[2]]
        best = _NEG
        if k > 3:
            from itertools import combinations

            for a, b, c in combinations(range(k), 3):
                if q[a] < 0 or q[b] < 0 or q[c] < 0:
                    continue
                best = max(best, row[q[a] * 16 + q[b] * 4 + q[c]])
        else:
            for cod in range(64):
                digs = (cod >> 4, (cod >> 2) & 3, cod & 3)
                if k == 1:
                    ok = q[0] < 0 or q[0] in digs
                else:
                    ok = (q[0] < 0 or q[1] < 0) or \
                        (digs[0] == q[0] and q[1] in (digs[1], digs[2])) or \
                        (digs[1] == q[0] and digs[2] == q[1])
                if ok:
                    best = max(best, row[cod])
        return 0.0 if best <= _NEG else best

    for i in range(1, nr + 1):
        rc = ref[(i - 1) * 3 : i * 3]
        codon_row = rc[0] * 16 + rc[1] * 4 + rc[2] if min(rc) >= 0 else -1
        for j in range(0, lq + 1):
            for k in range(1, 6):
                if j < k:
                    break
                prev = max(M[i - 1, j - k], X[i - 1, j - k], Y[i - 1, j - k])
                if prev <= _NEG:
                    continue
                s = 0.0 if codon_row < 0 else step_score(codon_row, list(qry[j - k : j]))
                s -= miscall * abs(k - 3)
                if prev + s > M[i, j]:
                    M[i, j] = prev + s
                    move[i, j] = k
            xo = max(M[i - 1, j], Y[i - 1, j]) - gap_open
            xe = X[i - 1, j] - gap_extend
            X[i, j] = max(X[i, j], xo, xe)
            xext[i, j] = xe > xo
            if j >= 1:
                yo = max(M[i, j - 1], X[i, j - 1]) - gap_open_q
                ye = Y[i, j - 1] - gap_extend_q
                Y[i, j] = max(Y[i, j], yo, ye)
                yext[i, j] = ye > yo

    i, j = nr, lq
    cands = (M[i, j], X[i, j], Y[i, j])
    state = int(np.argmax(cands))
    final = cands[state]
    rp, qp = [], []
    while i > 0 or j > 0:
        if state == 0:
            k = int(move[i, j])
            if k == 0:
                break
            mlen = max(3, k)
            for t in reversed(range(mlen)):
                rp.append((i - 1) * 3 + t if t < 3 else -1)
                qp.append(j - k + t if t < k else -1)
            prev = (M[i - 1, j - k], X[i - 1, j - k], Y[i - 1, j - k])
            state = int(np.argmax(prev))
            i, j = i - 1, j - k
        elif state == 1:
            if i == 0:
                break
            for t in reversed(range(3)):
                rp.append((i - 1) * 3 + t)
                qp.append(-1)
            ext = xext[i, j]
            i -= 1
            state = 1 if ext else (0 if M[i, j] >= Y[i, j] else 2)
        else:
            if j == 0:
                break
            rp.append(-1)
            qp.append(j - 1)
            ext = yext[i, j]
            j -= 1
            state = 2 if ext else (0 if M[i, j] >= X[i, j] else 1)
    return final, np.array(rp[::-1], dtype=np.int32), np.array(qp[::-1], dtype=np.int32)


# ---------------------------------------------------------------------------
# native dispatch

def _lib():
    return _native.library("align")


def _as_i32p(x):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def align_sequences(
    a: str,
    b: str,
    datatype: str = "nucleotide",
    score_matrix: Optional[np.ndarray] = None,
    gap_open: float = 10.0,
    gap_extend: float = 1.0,
    local: bool = False,
    use_native: bool = True,
) -> Tuple[float, str, str]:
    """Affine-gap pairwise alignment; returns (score, aligned_a, aligned_b).
    Reference: HBL ``AlignSequences`` default (non-codon) mode."""
    alphabet = _NUC if datatype == "nucleotide" else _AA
    score = np.ascontiguousarray(
        score_matrix if score_matrix is not None
        else (nucleotide_scores() if datatype == "nucleotide" else protein_scores()),
        dtype=np.float64,
    )
    ea, eb = _encode(a, alphabet), _encode(b, alphabet)
    if use_native:
        lib = _lib()
        pa = np.empty(len(a) + len(b), dtype=np.int32)
        pb = np.empty(len(a) + len(b), dtype=np.int32)
        n = ctypes.c_int64(0)
        sc = lib.gotoh_align(
            _as_i32p(ea), len(ea), _as_i32p(eb), len(eb),
            score.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            score.shape[0], gap_open, gap_extend, int(local),
            _as_i32p(pa), _as_i32p(pb), ctypes.byref(n),
        )
        pa, pb = pa[: n.value], pb[: n.value]
    else:
        sc, pa, pb = _gotoh_py(ea, eb, score, gap_open, gap_extend, local)
    return float(sc), _decode(pa, a), _decode(pb, b)


def align_codon(
    ref: str,
    query: str,
    genetic_code: Optional[GeneticCode] = None,
    score_matrix: Optional[np.ndarray] = None,
    gap_open: float = 15.0,
    gap_extend: float = 2.0,
    gap_open_query: float = 15.0,
    gap_extend_query: float = 2.0,
    miscall: float = 25.0,
    use_native: bool = True,
) -> Tuple[float, str, str]:
    """Codon-aware alignment of a coding ``query`` against an in-frame
    ``ref`` (reference: codon mode of ``AlignSequences``,
    ``CodonAlignStringsStep`` ``alignment.cpp:151``).  Trailing ref
    nucleotides beyond the last whole codon are ignored (the reference
    requires an in-frame reference too).  Returns (score, aligned_ref,
    aligned_query)."""
    cscore = np.ascontiguousarray(
        score_matrix if score_matrix is not None else codon_scores(genetic_code),
        dtype=np.float64,
    )
    er, eq = _encode(ref, _NUC), _encode(query, _NUC)
    er = er[: (len(er) // 3) * 3]
    if use_native:
        lib = _lib()
        cap = 2 * (len(er) + len(eq)) + 16
        pr = np.empty(cap, dtype=np.int32)
        pq = np.empty(cap, dtype=np.int32)
        n = ctypes.c_int64(0)
        sc = lib.codon_align(
            _as_i32p(er), len(er), _as_i32p(eq), len(eq),
            cscore.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            gap_open, gap_extend, gap_open_query, gap_extend_query, miscall,
            _as_i32p(pr), _as_i32p(pq), ctypes.byref(n),
        )
        pr, pq = pr[: n.value], pq[: n.value]
    else:
        sc, pr, pq = _codon_align_py(
            er, eq, cscore, gap_open, gap_extend,
            gap_open_query, gap_extend_query, miscall,
        )
    return float(sc), _decode(pr, ref), _decode(pq, query)
