"""Template-hit machinery: hhr parsing, mmCIF atoms, hit featurization.

Functional subset of the reference's AF2-lineage template stack
(data/tools/templates.py:1070-1259 HhsearchHitFeaturizer,
tools/parsers.py:583 hhr parsing, tools/mmcif_parsing.py:196): parse
hhsearch .hhr hits, pull pseudo-beta coordinates from template mmCIFs, and
emit the 40-channel pair template feature the released model consumes
(39-bin distogram + mask, query-indexed).  The released flow uses the GT
receptor distogram instead (feature_loader.get_template_feat); this module
enables true homolog templates for blind settings.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List

import numpy as np

from physdock_tpu_torch.data.constants.restypes import three_to_one


@dataclasses.dataclass
class TemplateHit:
    index: int
    name: str
    aligned_cols: int
    sum_probs: float
    query: str
    hit_sequence: str
    indices_query: List[int]  # query positions (0-based) per aligned column
    indices_hit: List[int]  # hit positions (0-based) per aligned column


def parse_hhr(text: str) -> List[TemplateHit]:
    """Parse hhsearch/hhblits .hhr output into template hits
    (tools/parsers.py:583-713 lineage)."""
    blocks = text.split("\nNo ")[1:]
    hits = []
    for i, block in enumerate(blocks):
        lines = block.splitlines()
        name = lines[1][1:].strip() if len(lines) > 1 else f"hit{i}"
        m = re.search(r"Aligned_cols=(\d+)", block)
        aligned_cols = int(m.group(1)) if m else 0
        m = re.search(r"Sum_probs=([\d.]+)", block)
        sum_probs = float(m.group(1)) if m else 0.0

        q_seq, t_seq = "", ""
        q_start = t_start = None
        for ln in lines:
            qm = re.match(r"Q\s+(?!ss_|Consensus)\S+\s+(\d+)\s+([A-Z\-]+)\s+\d+", ln)
            if qm:
                if q_start is None:
                    q_start = int(qm.group(1)) - 1
                q_seq += qm.group(2)
            tm = re.match(r"T\s+(?!ss_|Consensus)\S+\s+(\d+)\s+([A-Z\-]+)\s+\d+", ln)
            if tm:
                if t_start is None:
                    t_start = int(tm.group(1)) - 1
                t_seq += tm.group(2)
        if not q_seq or len(q_seq) != len(t_seq):
            continue
        iq, it = [], []
        qpos, tpos = q_start, t_start
        for qc, tc in zip(q_seq, t_seq):
            iq.append(qpos if qc != "-" else -1)
            it.append(tpos if tc != "-" else -1)
            if qc != "-":
                qpos += 1
            if tc != "-":
                tpos += 1
        hits.append(
            TemplateHit(i, name, aligned_cols, sum_probs, q_seq, t_seq, iq, it)
        )
    return hits


def parse_hmmsearch_sto(text: str, query_sequence: str) -> List[TemplateHit]:
    """hmmsearch -A output sto -> template hits aligned to the query
    (reference: tools/parsers.py parse_hmmsearch_sto/convert lineage +
    tools/hmmsearch.py:127-137 get_template_hits).

    hmmsearch -A emits profile-aligned rows: UPPERCASE/'-' are match
    columns (one per profile position, i.e. one per query residue for a
    --hand profile built from the query MSA), lowercase/'.' are insertions
    relative to the profile.  Raw rows are parsed here — NOT via
    parse_stockholm, whose first-row-gap column deletion assumes the first
    row is the query.
    """
    rows: Dict[str, str] = {}
    for ln in text.splitlines():
        ln = ln.rstrip()
        if not ln or ln.startswith(("#", "//")):
            continue
        parts = ln.split()
        if len(parts) != 2:
            continue
        name, chunk = parts
        rows[name] = rows.get(name, "") + chunk
    hits: List[TemplateHit] = []
    for i, (name, seq) in enumerate(rows.items()):
        iq, it = [], []
        qpos = tpos = 0
        for ch in seq:
            if ch in (".",) or ch.islower():
                # insertion vs the profile: consumes hit residue only
                if ch != ".":
                    tpos += 1
                continue
            if qpos >= len(query_sequence):
                break
            if ch == "-":
                iq.append(qpos)
                it.append(-1)
            else:
                iq.append(qpos)
                it.append(tpos)
                tpos += 1
            qpos += 1
        aligned = sum(1 for q, t in zip(iq, it) if q >= 0 and t >= 0)
        hits.append(
            TemplateHit(
                index=i,
                name=name,
                aligned_cols=aligned,
                sum_probs=0.0,
                query=query_sequence[: len(iq)],
                hit_sequence="".join(
                    c.upper() for c in seq if c.isalpha()
                ),
                indices_query=iq,
                indices_hit=it,
            )
        )
    return hits


@dataclasses.dataclass
class MmcifChain:
    chain_id: str
    positions: Dict[int, Dict[str, np.ndarray]]  # seq pos -> atom name -> xyz
    restypes: Dict[int, str]


def parse_mmcif_atoms(text: str) -> Dict[str, MmcifChain]:
    """Minimal mmCIF _atom_site parser (mmcif_parsing.py:196 equivalent):
    per-chain residue atom coordinates keyed by label_seq_id."""
    lines = text.splitlines()
    headers: List[str] = []
    in_loop = False
    chains: Dict[str, MmcifChain] = {}
    for ln in lines:
        if ln.startswith("loop_"):
            in_loop = True
            headers = []
            continue
        if in_loop and ln.startswith("_atom_site."):
            headers.append(ln.strip().split(".")[1])
            continue
        if headers and not ln.startswith(("_", "#", "loop_")) and ln.strip():
            parts = ln.split()
            if len(parts) < len(headers):
                continue
            rec = dict(zip(headers, parts))
            if rec.get("group_PDB") not in ("ATOM", "HETATM"):
                continue
            try:
                seq = int(rec.get("label_seq_id", "."))
            except ValueError:
                continue
            cid = rec.get("auth_asym_id", rec.get("label_asym_id", "A"))
            chain = chains.setdefault(cid, MmcifChain(cid, {}, {}))
            name = rec.get("label_atom_id", "").strip('"')
            xyz = np.array(
                [float(rec["Cartn_x"]), float(rec["Cartn_y"]), float(rec["Cartn_z"])],
                np.float32,
            )
            chain.positions.setdefault(seq, {})[name] = xyz
            chain.restypes[seq] = rec.get("label_comp_id", "UNK")
        elif headers and (ln.startswith("#") or ln.startswith("loop_")):
            headers = []
            in_loop = False
    return chains


def template_pair_features(
    hit: TemplateHit,
    chain: MmcifChain,
    query_length: int,
    min_bin: float = 3.25,
    max_bin: float = 50.75,
    no_bins: int = 39,
) -> np.ndarray:
    """[L, L, 40] pair template feature (39-bin pseudo-beta distogram +
    mask) in query coordinates — the format the released model's
    TemplatePairEmbedder consumes (feature_loader.get_template_feat)."""
    xb = np.zeros((query_length, 3), np.float32)
    mask = np.zeros(query_length, np.float32)
    seqs = sorted(chain.positions)
    for qi, ti in zip(hit.indices_query, hit.indices_hit):
        if qi < 0 or ti < 0 or qi >= query_length or ti >= len(seqs):
            continue
        atoms = chain.positions[seqs[ti]]
        ccd = chain.restypes[seqs[ti]]
        pb_name = "CA" if three_to_one(ccd) == "G" else "CB"
        pos = atoms.get(pb_name, atoms.get("CA"))
        if pos is None:
            continue
        xb[qi] = pos
        mask[qi] = 1.0

    d2 = np.sum((xb[:, None] - xb[None]) ** 2, axis=-1, keepdims=True)
    lower = np.linspace(min_bin, max_bin, no_bins) ** 2
    upper = np.concatenate([lower[1:], [1e16]])
    dgram = ((d2 > lower) & (d2 < upper)).astype(np.float32)
    pair_mask = mask[:, None] * mask[None, :]
    dgram = dgram * pair_mask[..., None]
    return np.concatenate([dgram, pair_mask[..., None]], axis=-1).astype(np.float32)


@dataclasses.dataclass
class TemplateHitFeaturizer:
    """Prefilter + (optionally kalign-realign) + featurize template hits
    (reference: tools/templates.py:1070-1259 HhsearchHitFeaturizer /
    HmmsearchHitFeaturizer and its _assess_hhsearch_hit prefilters).

    mmcif_lookup: hit name prefix (pdb_id) -> mmCIF text.
    release_dates: pdb_id -> ISO date string (optional date prefilter).
    """

    mmcif_lookup: Dict[str, str]
    release_dates: Dict[str, str] = dataclasses.field(default_factory=dict)
    max_template_date: str = "9999-12-31"
    max_hits: int = 4
    min_align_ratio: float = 0.1
    kalign_binary: str = "kalign"

    def _accept(self, hit: TemplateHit, query_sequence: str) -> bool:
        align_ratio = hit.aligned_cols / max(len(query_sequence), 1)
        if align_ratio <= self.min_align_ratio:
            return False
        # near-duplicate of the query (templates.py _assess_hhsearch_hit)
        if hit.hit_sequence == query_sequence:
            return False
        pdb_id = hit.name.split("_")[0].split()[0].lower()
        date = self.release_dates.get(pdb_id)
        if date is not None and date > self.max_template_date:
            return False
        return True

    def _realign(self, hit: TemplateHit, chain: MmcifChain) -> TemplateHit:
        """Re-derive hit indices by kalign-ing the hit sequence against the
        template chain's actual modelled sequence (templates.py kalign
        realign step); falls back to the original indices when kalign is
        unavailable or the alignment fails."""
        from physdock_tpu_torch.data.msa.parsers import parse_fasta
        from physdock_tpu_torch.data.msa.tools import Kalign

        tool = Kalign(self.kalign_binary)
        if not tool.available:
            return hit
        seqs = sorted(chain.positions)
        chain_seq = "".join(
            three_to_one(chain.restypes[s]) for s in seqs
        )
        if not chain_seq or chain_seq == hit.hit_sequence:
            return hit
        try:
            out = tool.align([hit.hit_sequence, chain_seq])
            aligned, _ = parse_fasta(out)
            a_hit, a_chain = aligned[0], aligned[1]
        except Exception:
            return hit
        # map hit positions -> chain positions through the pairwise alignment
        hit_to_chain = {}
        hp = cp = 0
        for hc, cc in zip(a_hit, a_chain):
            if hc != "-" and cc != "-":
                hit_to_chain[hp] = cp
            if hc != "-":
                hp += 1
            if cc != "-":
                cp += 1
        new_it = [
            hit_to_chain.get(t, -1) if t >= 0 else -1
            for t in hit.indices_hit
        ]
        return dataclasses.replace(hit, indices_hit=new_it)

    def featurize(
        self, hits: List[TemplateHit], query_sequence: str
    ) -> List[np.ndarray]:
        """Accepted hits -> list of [L, L, 40] pair template features, best
        (highest sum_probs / aligned_cols) first."""
        ranked = sorted(
            hits, key=lambda h: (h.sum_probs, h.aligned_cols), reverse=True
        )
        out: List[np.ndarray] = []
        for hit in ranked:
            if len(out) >= self.max_hits:
                break
            if not self._accept(hit, query_sequence):
                continue
            pdb_id = hit.name.split("_")[0].split()[0].lower()
            text = self.mmcif_lookup.get(pdb_id)
            if text is None:
                continue
            chains = parse_mmcif_atoms(text)
            chain_id = None
            if "_" in hit.name:
                chain_id = hit.name.split("_")[1].split()[0]
            chain = chains.get(chain_id) or next(iter(chains.values()), None)
            if chain is None:
                continue
            hit = self._realign(hit, chain)
            out.append(
                template_pair_features(hit, chain, len(query_sequence))
            )
        return out
