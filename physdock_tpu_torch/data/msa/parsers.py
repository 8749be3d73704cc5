"""MSA format parsers: FASTA, Stockholm, A3M.

Equivalent of reference PhysDock/data/tools/parsers.py (fasta/sto/a3m
parsing, sto->a3m conversion, dedup/truncate), numpy-light and
dependency-free.
"""

from __future__ import annotations

import dataclasses
import re
import string
from typing import Dict, List, Optional, Sequence, Tuple

_LOWER = set(string.ascii_lowercase)
_DELETE_LOWER = str.maketrans("", "", string.ascii_lowercase)


@dataclasses.dataclass
class Msa:
    sequences: List[str]  # aligned rows (query coordinates, may contain '-')
    deletion_matrix: List[List[int]]  # per-row deletions before each column
    descriptions: List[str]

    def __len__(self):
        return len(self.sequences)

    def truncate(self, max_seqs: int) -> "Msa":
        return Msa(
            self.sequences[:max_seqs],
            self.deletion_matrix[:max_seqs],
            self.descriptions[:max_seqs],
        )


def parse_fasta(text: str) -> Tuple[List[str], List[str]]:
    """Returns (sequences, descriptions)."""
    seqs, descs = [], []
    cur: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
                cur = []
            descs.append(line[1:])
        elif line:
            cur.append(line)
    if cur:
        seqs.append("".join(cur))
    return seqs, descs


def parse_a3m(text: str) -> Msa:
    """A3M: lowercase letters are insertions relative to the query."""
    seqs, descs = parse_fasta(text)
    sequences, deletions = [], []
    for seq in seqs:
        del_row = []
        count = 0
        for ch in seq:
            if ch.islower():
                count += 1
            else:
                del_row.append(count)
                count = 0
        sequences.append(seq.translate(_DELETE_LOWER))
        deletions.append(del_row)
    return Msa(sequences, deletions, descs)


def parse_stockholm(text: str) -> Msa:
    """Stockholm: columns where the query (first row) has a gap are
    insertions; convert to query coordinates."""
    rows: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "//")):
            continue
        parts = line.split()
        if len(parts) != 2:
            continue
        name, chunk = parts
        rows[name] = rows.get(name, "") + chunk
    if not rows:
        return Msa([], [], [])
    names = list(rows)
    query = rows[names[0]]
    keep = [i for i, c in enumerate(query) if c not in "-."]
    sequences, deletions, descs = [], [], []
    for name in names:
        aligned = rows[name]
        del_row, seq = [], []
        count = 0
        for i, c in enumerate(aligned):
            if query[i] in "-.":
                if c not in "-.":
                    count += 1
            else:
                seq.append("-" if c in "-." else c.upper())
                del_row.append(count)
                count = 0
        sequences.append("".join(seq))
        deletions.append(del_row)
        descs.append(name)
    return Msa(sequences, deletions, descs)


def convert_stockholm_to_a3m(text: str, max_sequences: Optional[int] = None) -> str:
    msa = parse_stockholm(text)
    if max_sequences:
        msa = msa.truncate(max_sequences)
    lines = []
    for seq, desc in zip(msa.sequences, msa.descriptions):
        lines.append(f">{desc}")
        lines.append(seq)
    return "\n".join(lines) + "\n"


def deduplicate(msa: Msa) -> Msa:
    seen = set()
    seqs, dels, descs = [], [], []
    for s, d, n in zip(msa.sequences, msa.deletion_matrix, msa.descriptions):
        if s in seen:
            continue
        seen.add(s)
        seqs.append(s)
        dels.append(d)
        descs.append(n)
    return Msa(seqs, dels, descs)


def merge_msas(msas: Sequence[Msa]) -> Msa:
    out = Msa([], [], [])
    for m in msas:
        out.sequences += m.sequences
        out.deletion_matrix += m.deletion_matrix
        out.descriptions += m.descriptions
    return deduplicate(out)


_UNIPROT_PATTERN = re.compile(
    r"^(?:tr|sp)\|(?P<ac>[A-Za-z0-9]+)\|(?P<id>\S+)"
)
_TAX_PATTERN = re.compile(r"(?:OX=(\d+))|(?:_(\w+))")


def species_from_description(desc: str) -> bytes:
    """Extract a species identifier (mnemonic after '_' in uniprot ids, as
    used for pairing — tools/msa_pairing lineage)."""
    m = _UNIPROT_PATTERN.match(desc)
    name = m.group("id") if m else desc.split()[0] if desc else ""
    if "_" in name:
        return name.rsplit("_", 1)[1].encode()
    ox = re.search(r"OX=(\d+)", desc)
    if ox:
        return ox.group(1).encode()
    return b""
