"""Alignment readers: FASTA, PHYLIP (interleaved/sequential), NEXUS.

Replaces the reference's format-sniffing readers in
``src/core/dataset.cpp:2236-2506`` and the NEXUS block parser in
``src/core/nexus.cpp``.  NEXUS TREES blocks are parsed too, since method
fixtures (e.g. ``tests/hbltests/libv3/data/CD2.nex``) carry their tree in
the same file.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional


@dataclasses.dataclass
class Alignment:
    names: List[str]
    sequences: List[str]  # uppercase, gap '-'
    trees: Dict[str, str] = dataclasses.field(default_factory=dict)
    file_name: Optional[str] = None
    # NEXUS ASSUMPTIONS/SETS CHARSET partitions: name -> 0-based site
    # index list (reference: nexus.cpp ASSUMPTIONS block handling feeding
    # shared-load-file.bf partition definitions)
    charsets: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        lengths = {len(s) for s in self.sequences}
        if len(lengths) > 1:
            raise ValueError(f"ragged alignment: lengths {sorted(lengths)}")

    @property
    def n_sequences(self) -> int:
        return len(self.sequences)

    @property
    def n_sites(self) -> int:
        return len(self.sequences[0]) if self.sequences else 0

    def guess_datatype(self) -> str:
        """'nucleotide' or 'protein', by residue composition."""
        sample = "".join(self.sequences)[:20000].upper()
        nuc = sum(sample.count(c) for c in "ACGTUN-?")
        return "nucleotide" if nuc >= 0.9 * max(len(sample), 1) else "protein"

    def normalized_names(self) -> List[str]:
        """HyPhy-compatible identifier normalization: non-alphanumeric ->
        '_' (reference: alignments.bf name normalization)."""
        return [re.sub(r"[^a-zA-Z0-9]", "_", n) for n in self.names]


def _strip_nexus_comments(text: str) -> str:
    out, depth = [], 0
    for ch in text:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


_NEXUS_TOKEN = re.compile(r"'[^']*'|\"[^\"]*\"|[^\s]+")


def _unquote(tok: str) -> str:
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    return tok


def parse_fasta(text: str) -> Alignment:
    names, seqs, cur = [], [], []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if names:
                seqs.append("".join(cur))
            names.append(line[1:].strip())
            cur = []
        else:
            cur.append(line.replace(" ", ""))
    if names:
        seqs.append("".join(cur))
    return Alignment(names, [s.upper() for s in seqs])


def parse_phylip(text: str) -> Alignment:
    lines = [ln for ln in text.splitlines() if ln.strip()]
    header = lines[0].split()
    n_taxa, n_sites = int(header[0]), int(header[1])
    names: List[str] = []
    chunks: List[List[str]] = []
    body = lines[1:]
    # first block: name + sequence start
    for i in range(n_taxa):
        parts = body[i].split(None, 1)
        names.append(parts[0])
        chunks.append([parts[1].replace(" ", "")] if len(parts) > 1 else [])
    # remaining blocks: interleaved continuation (round-robin) or sequential
    idx = 0
    for ln in body[n_taxa:]:
        chunks[idx % n_taxa].append(ln.replace(" ", ""))
        idx += 1
    seqs = ["".join(c).upper() for c in chunks]
    if any(len(s) != n_sites for s in seqs):
        # sequential layout: names every ceil(n_sites/width) lines — refall
        # back to concatenating everything per taxon in order
        flat = "".join(s for s in seqs)
        if len(flat) == n_taxa * n_sites:
            seqs = [flat[i * n_sites : (i + 1) * n_sites] for i in range(n_taxa)]
        else:
            raise ValueError("could not parse PHYLIP layout")
    return Alignment(names, seqs)


def _parse_charset_ranges(spec: str) -> List[int]:
    """CHARSET value -> 0-based site indices.  Supports ``a-b`` (1-based
    inclusive), bare ``a``, ``a-.`` (to end: caller clips), and the
    step form ``a-b\\3``."""
    sites: List[int] = []
    for tok in spec.replace(",", " ").split():
        step = 1
        if "\\" in tok:
            tok, step_s = tok.split("\\", 1)
            step = int(step_s)
        if "-" in tok[1:]:  # allow leading minus-free split
            a_s, b_s = tok.split("-", 1)
            a = int(a_s)
            b = 10**9 if b_s in (".", "") else int(b_s)
            sites.extend(range(a - 1, b, step))
        else:
            sites.append(int(tok) - 1)
    return sites


def parse_nexus(text: str) -> Alignment:
    stripped = _strip_nexus_comments(text)
    # split into BEGIN <block>; ... END chunks ("END" may lack the
    # trailing ';' — e.g. the reference's partitioned.nex fixture)
    blocks = re.findall(
        r"BEGIN\s+(\w+)\s*;(.*?)\bEND\b\s*;?",
        stripped,
        re.IGNORECASE | re.DOTALL,
    )
    taxlabels: List[str] = []
    names: List[str] = []
    seq_map: Dict[str, List[str]] = {}
    trees: Dict[str, str] = {}
    charsets: Dict[str, List[int]] = {}
    matchchar = None
    gapchar, missingchar = "-", "?"
    for kind, body in blocks:
        kind = kind.upper()
        if kind == "TAXA":
            m = re.search(r"TAXLABELS(.*?);", body, re.IGNORECASE | re.DOTALL)
            if m:
                taxlabels = [_unquote(t) for t in _NEXUS_TOKEN.findall(m.group(1))]
        elif kind in ("CHARACTERS", "DATA"):
            fm = re.search(r"FORMAT(.*?);", body, re.IGNORECASE | re.DOTALL)
            if fm:
                fmt = fm.group(1)
                g = re.search(r"GAP\s*=\s*(\S)", fmt, re.IGNORECASE)
                if g:
                    gapchar = g.group(1)
                mi = re.search(r"MISSING\s*=\s*(\S)", fmt, re.IGNORECASE)
                if mi:
                    missingchar = mi.group(1)
                mc = re.search(r"MATCHCHAR\s*=\s*(\S)", fmt, re.IGNORECASE)
                if mc:
                    matchchar = mc.group(1)
            nolabels = bool(
                re.search(r"\bNOLABELS\b", fm.group(1), re.IGNORECASE)
            ) if fm else False
            mm = re.search(r"MATRIX(.*?);", body, re.IGNORECASE | re.DOTALL)
            if not mm:
                continue
            row = 0
            for line in mm.group(1).splitlines():
                line = line.strip()
                if not line:
                    continue
                toks = _NEXUS_TOKEN.findall(line)
                if nolabels:
                    # unlabeled rows pair with TAXLABELS in order,
                    # wrapping for interleaved matrices
                    if not taxlabels:
                        raise ValueError("NEXUS NOLABELS matrix without TAXLABELS")
                    name = taxlabels[row % len(taxlabels)]
                    row += 1
                    seq = "".join(toks)
                else:
                    name = _unquote(toks[0])
                    seq = "".join(toks[1:])
                if name not in seq_map:
                    seq_map[name] = []
                    names.append(name)
                seq_map[name].append(seq)
        elif kind in ("ASSUMPTIONS", "SETS", "HYPHY"):
            for m in re.finditer(
                r"CHARSET\s+(\S+)\s*=\s*([^;]+);?", body, re.IGNORECASE
            ):
                try:
                    charsets[_unquote(m.group(1))] = _parse_charset_ranges(
                        m.group(2).strip().rstrip(";")
                    )
                except ValueError:
                    continue  # non-numeric charset (e.g. by-name unions)
        elif kind == "TREES":
            for m in re.finditer(
                r"TREE\s+(\S+)\s*=\s*(?:\[[^\]]*\]\s*)?([^;]+?)\s*(?=;|\bTREE\b|\Z)",
                body,
                re.IGNORECASE | re.DOTALL,
            ):
                trees[_unquote(m.group(1))] = m.group(2).strip()

    if not names and taxlabels:
        names = list(taxlabels)
    seqs = ["".join(seq_map[n]).upper() for n in names]
    # resolve matchchar against first sequence
    if matchchar and seqs:
        first = seqs[0]
        mc = matchchar.upper()
        seqs = [
            "".join(first[i] if c == mc else c for i, c in enumerate(s))
            for s in seqs
        ]
    seqs = [
        s.replace(gapchar.upper(), "-").replace(missingchar.upper(), "?") for s in seqs
    ]
    n_sites = len(seqs[0]) if seqs else 0
    charsets = {
        name: [s for s in sites if s < n_sites]
        for name, sites in charsets.items()
    }
    return Alignment(names, seqs, trees=trees, charsets=charsets)


def read_alignment(path_or_text: str, *, is_path: bool = True) -> Alignment:
    """Sniff the format and parse (reference: dataset.cpp ReadDataSetFile)."""
    if is_path:
        with open(path_or_text) as fh:
            text = fh.read()
        file_name = path_or_text
    else:
        text, file_name = path_or_text, None
    head = text.lstrip()[:200]
    if head.upper().startswith("#NEXUS"):
        aln = parse_nexus(text)
    elif head.startswith(">"):
        aln = parse_fasta(text)
    elif head.startswith("#"):
        # legacy hash-mark format (dataset.cpp:2332 '#'-delimited names —
        # FASTA with '#' in place of '>')
        aln = parse_fasta(text.replace("\n#", "\n>").lstrip().replace("#", ">", 1))
    elif re.match(r"^\s*\d+\s+\d+", head):
        aln = parse_phylip(text)
    else:
        raise ValueError("unrecognized alignment format")
    aln.file_name = file_name
    return aln
