"""Data filters: state encoding, ambiguity resolution, site-pattern
compression, and frequency harvesting.

TPU-native counterpart of the reference's ``_DataSetFilter``
(``src/core/dataset_filter.cpp``): instead of per-site character loops the
filter produces dense arrays ready for batched likelihood work:

  * ``leaf_codes  [taxa, patterns] int32`` — index into
  * ``resolution_table [n_codes, states] f64`` — leaf partial-likelihood
    rows (1.0 per compatible state; gaps/missing = all ones, matching the
    reference's ``lNodeFlags``/``lNodeResolutions`` semantics,
    ``tree_evaluator.cpp``),
  * ``pattern_weights [patterns] f64`` — column multiplicities
    (``theFrequencies``), and ``duplicate_map [units] int32`` (site ->
    pattern, ``duplicateMap``).

Ambiguity conventions copied behaviorally from
``src/core/translation_table.cpp:383`` (IUPAC; '-' = gap with zero
resolutions, '?'/N/X = full ambiguity).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence

import numpy as np

from hyphy_tpu_torch.data.alignment import Alignment
from hyphy_tpu_torch.data.genetic_code import AMINO_ACIDS, GeneticCode, NUCLEOTIDES

# ---------------------------------------------------------------------------
# character -> state bitmask tables

def _nuc_masks() -> np.ndarray:
    """256-entry char -> 4-bit state mask (bit i = nucleotide i, ACGT)."""
    table = np.full(256, -1, dtype=np.int32)
    bits = {"A": 1, "C": 2, "G": 4, "T": 8, "U": 8}
    iupac = {
        "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
        "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
    }
    for ch, b in bits.items():
        table[ord(ch)] = b
    for ch, comps in iupac.items():
        table[ord(ch)] = sum(bits[c] for c in comps)
    for ch in "NX?.*":
        table[ord(ch)] = 15
    table[ord("-")] = 0  # gap: zero resolutions (counting); all-ones (likelihood)
    return table


def _protein_masks() -> np.ndarray:
    """256-entry char -> 20-bit state mask over AMINO_ACIDS order."""
    table = np.full(256, -1, dtype=np.int64)
    for i, ch in enumerate(AMINO_ACIDS):
        table[ord(ch)] = 1 << i
    full = (1 << 20) - 1
    table[ord("B")] = (1 << AMINO_ACIDS.index("D")) | (1 << AMINO_ACIDS.index("N"))
    table[ord("Z")] = (1 << AMINO_ACIDS.index("E")) | (1 << AMINO_ACIDS.index("Q"))
    table[ord("J")] = (1 << AMINO_ACIDS.index("I")) | (1 << AMINO_ACIDS.index("L"))
    for ch in "X?.*":
        table[ord(ch)] = full
    table[ord("-")] = 0
    return table


def _binary_masks() -> np.ndarray:
    """256-entry char -> 2-bit state mask for 0/1 characters
    (reference: libv3/models/binary.bf data handling)."""
    table = np.full(256, -1, dtype=np.int32)
    table[ord("0")] = 1
    table[ord("1")] = 2
    for ch in "NX?.*":
        table[ord(ch)] = 3
    table[ord("-")] = 0
    return table


_NUC_MASKS = _nuc_masks()
_PROTEIN_MASKS = _protein_masks()
_BINARY_MASKS = _binary_masks()


def _char_mask_matrix(sequences: Sequence[str], table: np.ndarray, what: str) -> np.ndarray:
    """[taxa, sites] int mask matrix from raw sequences."""
    rows = []
    for seq in sequences:
        codes = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        masks = table[codes]
        if (masks < 0).any():
            bad = sorted({seq[i] for i in np.nonzero(masks < 0)[0][:5]})
            raise ValueError(f"invalid {what} characters: {bad}")
        rows.append(masks)
    return np.stack(rows)


def _mask_to_vector(mask: int, n_states: int) -> np.ndarray:
    if mask == 0:  # gap / fully missing
        return np.ones(n_states)
    return np.array([(mask >> i) & 1 for i in range(n_states)], dtype=np.float64)


# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DataFilter:
    """A likelihood-ready view of an alignment partition."""

    names: List[str]
    n_states: int
    datatype: str                      # 'nucleotide' | 'codon' | 'protein'
    leaf_codes: np.ndarray             # [taxa, patterns] int32
    resolution_table: np.ndarray       # [n_codes, n_states] f64
    pattern_weights: np.ndarray        # [patterns] f64
    duplicate_map: np.ndarray          # [units] int32 (unit-site -> pattern)
    char_masks: np.ndarray             # [taxa, raw_sites] raw char masks
    genetic_code: Optional[GeneticCode] = None
    file_name: Optional[str] = None

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_alignment(
        aln: Alignment,
        datatype: str = "nucleotide",
        genetic_code: Optional[GeneticCode] = None,
        sequences: Optional[Sequence[int]] = None,
        sites: Optional[Sequence[int]] = None,
    ) -> "DataFilter":
        """Build a filter over selected sequences/sites.

        ``sites`` are raw character columns (for codon data they are grouped
        in consecutive triplets after selection, reference unitLength=3).
        """
        names = aln.normalized_names()
        seqs = aln.sequences
        if sequences is not None:
            names = [names[i] for i in sequences]
            seqs = [seqs[i] for i in sequences]

        if datatype == "protein":
            masks = _char_mask_matrix(seqs, _PROTEIN_MASKS, "protein")
        elif datatype == "binary":
            masks = _char_mask_matrix(seqs, _BINARY_MASKS, "binary")
        else:
            masks = _char_mask_matrix(seqs, _NUC_MASKS, "nucleotide")
        if sites is not None:
            masks = masks[:, np.asarray(sites, dtype=np.int64)]

        if datatype == "nucleotide":
            return DataFilter._build_simple(names, masks, 4, datatype, None, aln.file_name)
        if datatype == "protein":
            return DataFilter._build_simple(names, masks, 20, datatype, None, aln.file_name)
        if datatype == "binary":
            return DataFilter._build_simple(names, masks, 2, datatype, None, aln.file_name)
        if datatype == "codon":
            gc = genetic_code or GeneticCode("Universal")
            return DataFilter._build_codon(names, masks, gc, aln.file_name)
        raise ValueError(f"unknown datatype {datatype!r}")

    @staticmethod
    def _build_simple(names, masks, n_states, datatype, gc, file_name) -> "DataFilter":
        code_values, leaf_codes = np.unique(masks, return_inverse=True)
        leaf_codes = leaf_codes.reshape(masks.shape).astype(np.int32)
        table = np.stack([_mask_to_vector(int(m), n_states) for m in code_values])
        filt = DataFilter(
            names=names, n_states=n_states, datatype=datatype,
            leaf_codes=leaf_codes, resolution_table=table,
            pattern_weights=np.array([]), duplicate_map=np.array([]),
            char_masks=masks, genetic_code=gc, file_name=file_name,
        )
        filt._compress_patterns()
        return filt

    @staticmethod
    def _build_codon(names, masks, gc: GeneticCode, file_name) -> "DataFilter":
        n_raw = masks.shape[1]
        n_units = n_raw // 3
        if n_raw % 3:
            warnings.warn(f"codon filter: dropping {n_raw % 3} trailing sites")
            masks = masks[:, : 3 * n_units]
        m = masks.reshape(masks.shape[0], n_units, 3)
        # combine the three 4-bit position masks into a 12-bit key; a gap at
        # any position makes the whole codon ambiguous at that position
        m_eff = np.where(m == 0, 15, m)
        keys = (m_eff[..., 0] << 8) | (m_eff[..., 1] << 4) | m_eff[..., 2]
        code_values, leaf_codes = np.unique(keys, return_inverse=True)
        leaf_codes = leaf_codes.reshape(keys.shape).astype(np.int32)

        sense = gc.sense_codons
        s0, s1, s2 = sense // 16, (sense // 4) % 4, sense % 4
        table = np.zeros((len(code_values), gc.n_states))
        excluded_code = np.zeros(len(code_values), dtype=bool)
        for row, key in enumerate(code_values):
            k0, k1, k2 = (int(key) >> 8) & 15, (int(key) >> 4) & 15, int(key) & 15
            vec = (
                ((k0 >> s0) & 1) * ((k1 >> s1) & 1) * ((k2 >> s2) & 1)
            ).astype(np.float64)
            if vec.sum() == 0:
                # resolves only to excluded (stop) states; columns containing
                # such codons are removed below
                excluded_code[row] = True
                vec = np.ones(gc.n_states)
            table[row] = vec
        # reference semantics: a site pattern where any sequence carries an
        # unambiguously-excluded state is omitted entirely
        # (_DataSetFilter::FilterDeletions, dataset_filter.cpp:594-712)
        bad_cols = excluded_code[leaf_codes].any(axis=0)
        if bad_cols.any():
            warnings.warn(
                f"codon filter: omitting {int(bad_cols.sum())} site(s) "
                "containing stop codons (reference: FilterDeletions)"
            )
            leaf_codes = leaf_codes[:, ~bad_cols]
            masks = masks.reshape(masks.shape[0], n_units, 3)[
                :, ~bad_cols, :
            ].reshape(masks.shape[0], -1)
        filt = DataFilter(
            names=names, n_states=gc.n_states, datatype="codon",
            leaf_codes=leaf_codes, resolution_table=table,
            pattern_weights=np.array([]), duplicate_map=np.array([]),
            char_masks=masks, genetic_code=gc, file_name=file_name,
        )
        filt._compress_patterns()
        return filt

    def _compress_patterns(self):
        """Deduplicate unit columns (reference: theFrequencies/duplicateMap)."""
        cols = self.leaf_codes.T  # [units, taxa]
        _, first_index, inverse, counts = np.unique(
            cols, axis=0, return_index=True, return_inverse=True, return_counts=True
        )
        # keep patterns in order of first occurrence for readability
        order = np.argsort(first_index, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        self.leaf_codes = self.leaf_codes[:, first_index[order]]
        self.pattern_weights = counts[order].astype(np.float64)
        self.duplicate_map = rank[inverse].astype(np.int32)

    # -- properties ---------------------------------------------------------

    @property
    def n_sequences(self) -> int:
        return len(self.names)

    @property
    def n_patterns(self) -> int:
        return self.leaf_codes.shape[1]

    @property
    def n_units(self) -> int:
        return len(self.duplicate_map)

    @property
    def unit_length(self) -> int:
        return 3 if self.datatype == "codon" else 1

    def leaf_partials(self) -> np.ndarray:
        """Dense [taxa, patterns, states] leaf partial likelihoods."""
        return self.resolution_table[self.leaf_codes]

    def subset_sites(self, sites: np.ndarray) -> "DataFilter":
        """New filter over a raw-site subset (reference: CreateFilter with
        a site range — GARD partitions, sliding windows)."""
        masks = self.char_masks[:, np.asarray(sites, dtype=np.int64)]
        if self.datatype == "codon":
            return DataFilter._build_codon(
                self.names, masks, self.genetic_code, self.file_name
            )
        return DataFilter._build_simple(
            self.names, masks, self.n_states, self.datatype,
            self.genetic_code, self.file_name,
        )

    def constant_pattern_mask(self) -> np.ndarray:
        """[patterns] bool: constant-with-matching-ambiguities columns
        (reference: ``alignments.Extract_site_patterns`` is_constant) —
        fully-missing rows excluded; at most one state carries weight."""
        lp = self.leaf_partials()
        sums = lp.sum(-1)
        non_gap = sums < self.n_states
        contrib = np.where(non_gap[..., None], lp / sums[..., None], 0.0)
        counts = contrib.sum(axis=0)  # [patterns, states]
        return (counts > 1e-12).sum(axis=-1) <= 1

    # -- frequency harvesting ----------------------------------------------

    def harvest_frequencies(
        self, unit: int, atom: int, position_specific: bool, count_gaps: bool = False
    ) -> np.ndarray:
        """Empirical character frequencies.

        Behavioral copy of ``_DataSet::HarvestFrequencies``
        (``src/core/dataset.cpp:917``): each (sequence, atom) contributes
        1/k split over its k resolutions; explicit gaps are skipped unless
        ``count_gaps``; columns normalize to 1.

        Returns ``[4**atom, unit//atom]`` if position_specific else
        ``[4**atom, 1]`` (for nucleotide atoms; protein analogous).
        """
        masks = self.char_masks
        n_base = {"protein": 20, "binary": 2}.get(self.datatype, 4)
        positions = unit // atom
        out = np.zeros((n_base**atom, positions if position_specific else 1))
        n_raw = masks.shape[1]
        usable = (n_raw // unit) * unit

        if atom == 1:
            full_mask = (1 << n_base) - 1
            m = masks[:, :usable].reshape(masks.shape[0], -1, unit)
            for value in np.unique(m):
                value = int(value)
                eff = full_mask if (value == 0 and count_gaps) else value
                k = bin(eff).count("1")
                if k == 0:
                    continue
                where = m == value  # [taxa, units, unit]
                per_pos = where.sum(axis=(0, 1)) if position_specific else where.sum()
                for s in range(n_base):
                    if (eff >> s) & 1:
                        if position_specific:
                            out[s, :] += per_pos / k
                        else:
                            out[s, 0] += per_pos / k
        elif atom == unit:
            # codon-level counting (F61-style): resolutions are the product
            # of per-position resolutions
            m = masks[:, :usable].reshape(masks.shape[0], -1, unit)
            full_mask = (1 << n_base) - 1
            keys = np.zeros(m.shape[:2], dtype=np.int64)
            gap_any = np.zeros(m.shape[:2], dtype=bool)
            for p in range(unit):
                mp = m[..., p]
                gap_any |= mp == 0
                keys = keys * (full_mask + 1) + np.where(mp == 0, full_mask, mp)
            for key in np.unique(keys):
                sel = keys == key
                if not count_gaps and (gap_any & sel).any():
                    sel = sel & ~gap_any
                count = sel.sum()
                if count == 0:
                    continue
                # decode per-position masks
                pm = []
                k = int(key)
                for _ in range(unit):
                    pm.append(k & full_mask)
                    k >>= n_base  # full_mask+1 == 1 << n_base for atoms
                pm = pm[::-1]
                states_per_pos = [
                    [s for s in range(n_base) if (mask >> s) & 1] for mask in pm
                ]
                total = int(np.prod([len(s) for s in states_per_pos]))
                if total == 0:
                    continue
                w = count / total
                import itertools as _it
                for combo in _it.product(*states_per_pos):
                    idx = 0
                    for s in combo:
                        idx = idx * n_base + s
                    out[idx, 0] += w
        else:
            raise NotImplementedError("atom must be 1 or == unit")

        sums = out.sum(axis=0, keepdims=True)
        sums[sums == 0] = 1.0
        return out / sums
