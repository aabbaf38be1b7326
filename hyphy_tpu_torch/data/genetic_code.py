"""Genetic codes and codon state spaces.

The reference ships translation tables as ``res/GeneticCodes/*.cod`` plus the
universal code built into ``res/TemplateBatchFiles/TemplateModels/
chooseGeneticCode.def``.  Here the tables are generated from the standard
NCBI ``transl_table`` amino-acid strings (public scientific constants).

Conventions:
  * nucleotides are indexed alphabetically  A=0, C=1, G=2, T=3
    (reference: ``src/core/translation_table.cpp:383``),
  * codon index = 16*n0 + 4*n1 + n2  (AAA=0 ... TTT=63),
  * the *sense* codon state space drops stop codons; for the Universal code
    |states| = 61 (reference: ``_DataSetFilter::GetDimension``).
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

NUCLEOTIDES = "ACGT"
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"  # 20 states, alphabetical (reference order)

# NCBI translation tables. The amino-acid strings are in the canonical NCBI
# ordering (first/second/third codon position each cycling through T,C,A,G,
# first position slowest). '*' = stop.
_NCBI_BASE_ORDER = "TCAG"
_NCBI_TABLES = {
    1: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    2: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
    3: "FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    4: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    5: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
    6: "FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    9: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    10: "FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    12: "FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    13: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
    14: "FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    15: "FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    16: "FFLLSSSSYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    21: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
    22: "FFLLSS*SYY*LCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    23: "FF*LSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    24: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSSKVVVVAAAADDEEGGGG",
    25: "FFLLSSSSYY**CCGWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
}

# HyPhy's method-facing genetic-code names -> NCBI transl_table ids
# (reference: chooseGeneticCode.def `_geneticCodeOptionMatrix`).
GENETIC_CODE_NAMES = {
    "Universal": 1,
    "Vertebrate-mtDNA": 2,
    "Yeast-mtDNA": 3,
    "Mold-Protozoan-mtDNA": 4,
    "Invertebrate-mtDNA": 5,
    "Ciliate-Nuclear": 6,
    "Echinoderm-mtDNA": 9,
    "Euplotid-Nuclear": 10,
    "Alt-Yeast-Nuclear": 12,
    "Ascidian-mtDNA": 13,
    "Flatworm-mtDNA": 14,
    "Blepharisma-Nuclear": 15,
    "Chlorophycean-mtDNA": 16,
    "Trematode-mtDNA": 21,
    "Scenedesmus-obliquus-mtDNA": 22,
    "Thraustochytrium-mtDNA": 23,
    "Pterobranchia-mtDNA": 24,
    "SR1-and-Gracilibacteria": 25,
}


def codon_index(codon: str) -> int:
    """AAA=0 ... TTT=63, alphabetical nucleotide nesting."""
    return (
        16 * NUCLEOTIDES.index(codon[0])
        + 4 * NUCLEOTIDES.index(codon[1])
        + NUCLEOTIDES.index(codon[2])
    )


def codon_string(index: int) -> str:
    return NUCLEOTIDES[index // 16] + NUCLEOTIDES[(index // 4) % 4] + NUCLEOTIDES[index % 4]


ALL_CODONS = ["".join(c) for c in itertools.product(NUCLEOTIDES, repeat=3)]


class GeneticCode:
    """A genetic code: the codon -> amino-acid map plus the derived
    sense-codon state space used by codon substitution models."""

    def __init__(self, name: str = "Universal"):
        if isinstance(name, int):
            table = name
            name = next(
                (k for k, v in GENETIC_CODE_NAMES.items() if v == name), str(name)
            )
        else:
            if name not in GENETIC_CODE_NAMES:
                raise ValueError(
                    f"unknown genetic code {name!r}; options: "
                    f"{sorted(GENETIC_CODE_NAMES)}"
                )
            table = GENETIC_CODE_NAMES[name]
        self.name = name
        self.table_id = table

        ncbi = _NCBI_TABLES[table]
        # remap from NCBI TCAG nesting to our alphabetical ACGT nesting
        self.translation = [""] * 64
        for i, aa in enumerate(ncbi):
            codon = _NCBI_BASE_ORDER[i // 16] + _NCBI_BASE_ORDER[(i // 4) % 4] + _NCBI_BASE_ORDER[i % 4]
            self.translation[codon_index(codon)] = aa
        self.translation = "".join(self.translation)

        self.stop_codons = np.array(
            [i for i in range(64) if self.translation[i] == "*"], dtype=np.int32
        )
        self.sense_codons = np.array(
            [i for i in range(64) if self.translation[i] != "*"], dtype=np.int32
        )
        # 64 -> sense index, -1 for stops
        self.codon_to_sense = np.full(64, -1, dtype=np.int32)
        self.codon_to_sense[self.sense_codons] = np.arange(
            len(self.sense_codons), dtype=np.int32
        )

    @property
    def n_states(self) -> int:
        return len(self.sense_codons)

    def sense_codon_strings(self):
        return [codon_string(int(i)) for i in self.sense_codons]

    def amino_acid_of_sense(self, sense_index: int) -> str:
        return self.translation[int(self.sense_codons[sense_index])]

    @functools.cached_property
    def sense_amino_acids(self) -> np.ndarray:
        """Amino-acid index (into AMINO_ACIDS) per sense codon."""
        return np.array(
            [AMINO_ACIDS.index(self.translation[int(c)]) for c in self.sense_codons],
            dtype=np.int32,
        )

    @functools.cached_property
    def one_step_table(self) -> dict:
        """Single-nucleotide-difference structure of the sense codon space.

        Returns arrays over sense-codon pairs (i, j) that differ at exactly
        one nucleotide position:
          ``pairs [K,2]`` sense indices, ``position [K]`` changed codon
          position (0..2), ``from_nuc [K]``/``to_nuc [K]`` nucleotides,
          ``synonymous [K]`` bool.
        These drive vectorized MG94-family Q construction
        (reference: ``MG_REV.bf:66-105``).
        """
        pairs, position, from_nuc, to_nuc, synonymous = [], [], [], [], []
        sense = self.sense_codons
        n = len(sense)
        for a in range(n):
            ca = int(sense[a])
            na = (ca // 16, (ca // 4) % 4, ca % 4)
            for b in range(n):
                if a == b:
                    continue
                cb = int(sense[b])
                nb = (cb // 16, (cb // 4) % 4, cb % 4)
                diff = [p for p in range(3) if na[p] != nb[p]]
                if len(diff) != 1:
                    continue
                p = diff[0]
                pairs.append((a, b))
                position.append(p)
                from_nuc.append(na[p])
                to_nuc.append(nb[p])
                synonymous.append(self.translation[ca] == self.translation[cb])
        return {
            "pairs": np.array(pairs, dtype=np.int32),
            "position": np.array(position, dtype=np.int32),
            "from_nuc": np.array(from_nuc, dtype=np.int32),
            "to_nuc": np.array(to_nuc, dtype=np.int32),
            "synonymous": np.array(synonymous, dtype=bool),
        }

    def __repr__(self):
        return f"GeneticCode({self.name!r}, states={self.n_states})"


UNIVERSAL = GeneticCode("Universal")
