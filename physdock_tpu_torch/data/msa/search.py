"""Homology search orchestration + MSA feature conversion.

Equivalent of reference alignment_runner_v2.run_homo_search (:263-327) +
DatasetManager.convert_msas_out_to_{msa,uniprot_msa}_features
(tools/dataset_manager.py:167-382): fan fastas over a process pool, run
jackhmmer (uniref90/uniprot/mgnify) + hhblits (bfd+uniclust30) with
idempotent caching by output existence, then parse sto/a3m into int8
msa/deletion features keyed by md5("protein:"+seq).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from physdock_tpu_torch.data.constants.restypes import AA_1TO3, restype_order
from physdock_tpu_torch.data.msa import parsers
from physdock_tpu_torch.data.msa.tools import HHBlits, Hmmalign, Jackhmmer, Nhmmer
from physdock_tpu_torch.utils.io import (
    dump_pkl,
    load_txt,
    protein_msa_key,
    run_pool_tasks,
)

# per-database hit caps (alignment_runner_v2.py:77-127; RNA caps from the
# legacy runner alignment_runner.py:205-249)
DB_CAPS = {
    "uniref90": 10000,
    "uniprot": 50000,
    "mgnify": 5000,
    "bfd": None,
    "rfam": 10000,
    "rnacentral": 10000,
    "nt": 10000,
}
MAX_MSA_SEQS = 16384


@dataclasses.dataclass
class SearchConfig:
    uniref90_path: Optional[str] = None
    uniprot_path: Optional[str] = None
    mgnify_path: Optional[str] = None
    bfd_path: Optional[str] = None
    uniclust30_path: Optional[str] = None
    # RNA databases (legacy runner alignment_runner.py:205-249)
    rfam_path: Optional[str] = None
    rnacentral_path: Optional[str] = None
    nt_path: Optional[str] = None
    n_cpu: int = 8


class AlignmentRunner:
    """Run all searches for one fasta, caching by output existence
    (alignment_runner_v2.py:129-157)."""

    def __init__(self, cfg: SearchConfig):
        self.cfg = cfg

    def run(self, fasta_path: str, out_dir: str) -> Dict[str, str]:
        os.makedirs(out_dir, exist_ok=True)
        produced = {}
        jobs = []
        if self.cfg.uniref90_path:
            jobs.append(("uniref90_hits.sto", Jackhmmer(self.cfg.uniref90_path, n_cpu=self.cfg.n_cpu)))
        if self.cfg.mgnify_path:
            jobs.append(("mgnify_hits.sto", Jackhmmer(self.cfg.mgnify_path, n_cpu=self.cfg.n_cpu)))
        if self.cfg.uniprot_path:
            jobs.append(("uniprot_hits.sto", Jackhmmer(self.cfg.uniprot_path, n_cpu=self.cfg.n_cpu)))
        for name, tool in jobs:
            out = os.path.join(out_dir, name)
            if os.path.exists(out):
                produced[name] = out
                continue
            if not tool.available:
                continue
            try:
                tool.query(fasta_path, out)
                produced[name] = out
            except Exception as e:  # tool failure -> warn, continue
                print(f"[warn] {name} search failed: {e}")
        if self.cfg.bfd_path and self.cfg.uniclust30_path:
            out = os.path.join(out_dir, "bfd_uniclust_hits.a3m")
            tool = HHBlits([self.cfg.bfd_path, self.cfg.uniclust30_path])
            if os.path.exists(out):
                produced["bfd_uniclust_hits.a3m"] = out
            elif tool.available:
                try:
                    tool.query(fasta_path, out)
                    produced["bfd_uniclust_hits.a3m"] = out
                except Exception as e:
                    print(f"[warn] hhblits failed: {e}")
        return produced

    def run_rna(self, fasta_path: str, out_dir: str) -> Dict[str, str]:
        """RNA homology search: nhmmer vs rfam/rnacentral/nt, then realign
        each hit sto against a profile of the query
        (alignment_runner.py:100-249)."""
        os.makedirs(out_dir, exist_ok=True)
        produced = {}
        jobs = []
        if self.cfg.rfam_path:
            jobs.append(("rfam_hits.sto", Nhmmer(self.cfg.rfam_path, n_cpu=self.cfg.n_cpu)))
        if self.cfg.rnacentral_path:
            jobs.append(("rnacentral_hits.sto", Nhmmer(self.cfg.rnacentral_path, n_cpu=self.cfg.n_cpu)))
        if self.cfg.nt_path:
            jobs.append(("nt_hits.sto", Nhmmer(self.cfg.nt_path, n_cpu=self.cfg.n_cpu)))
        realigner = Hmmalign()
        for name, tool in jobs:
            out = os.path.join(out_dir, name)
            realigned = out.replace("_hits.sto", "_realigned.sto")
            if not os.path.exists(out):
                if not tool.available:
                    continue
                try:
                    tool.query(fasta_path, out)
                except Exception as e:
                    print(f"[warn] {name} search failed: {e}")
                    continue
            produced[name] = out
            # empty search output -> empty realign output
            # (alignment_runner.py:110-114)
            if os.path.getsize(out) == 0:
                open(realigned, "w").close()
                produced[os.path.basename(realigned)] = realigned
                continue
            if not os.path.exists(realigned) and realigner.available:
                try:
                    realigner.realign_sto_with_fasta(fasta_path, out, realigned)
                    produced[os.path.basename(realigned)] = realigned
                except Exception as e:
                    print(f"[warn] {name} realign failed: {e}")
        return produced


def msa_to_int8(msa: parsers.Msa) -> Dict[str, np.ndarray]:
    """Aligned rows -> int8 restype arrays in the 32-class alphabet
    ('-' -> GAP=31; tools/parse_msas.py:94 lineage)."""
    if not msa.sequences:
        return {
            "msa": np.zeros((0, 0), np.int8),
            "deletion_matrix": np.zeros((0, 0), np.int8),
        }
    arr = np.full((len(msa.sequences), len(msa.sequences[0])), 31, np.int8)
    for r, seq in enumerate(msa.sequences):
        for c, ch in enumerate(seq):
            if ch == "-":
                continue
            arr[r, c] = restype_order(AA_1TO3.get(ch, "UNK"))
    dele = np.zeros_like(arr)
    for r, row in enumerate(msa.deletion_matrix):
        dele[r, : len(row)] = np.minimum(row, 127)
    return {"msa": arr, "deletion_matrix": dele}


_INT8_TO_AA = "ARNDCQEGHILKMFPSTWYVX"


def int8_to_a3m(msa: np.ndarray, deletions: np.ndarray) -> str:
    """The inverse of `msa_to_int8` for protein rows: A3M text whose
    parse gives back `msa` and `deletions` (each deletion count as that
    many lowercase insertions before its column; classes 0-20 as the
    one-letter code, the gap class 31 as '-'); a negative count, an int8
    that wrapped, writes no insertion."""
    lines = []
    for r, (row, dels) in enumerate(zip(np.asarray(msa), np.asarray(deletions))):
        lines.append(f">seq{r}")
        lines.append("".join("a" * int(d) + ("-" if c == 31 else _INT8_TO_AA[c])
                             for c, d in zip(row, dels)))
    return "\n".join(lines) + "\n"


# RNA one-letter -> padded CCD names in the 32-class alphabet
RNA_1TO3 = {"A": "A  ", "G": "G  ", "C": "C  ", "U": "U  ", "T": "U  "}


def rna_msa_to_int8(msa: parsers.Msa) -> Dict[str, np.ndarray]:
    """RNA MSA rows -> int8 restype arrays (nucleotide classes of the same
    32-class alphabet; dataset_manager.py:383+ lineage)."""
    if not msa.sequences:
        return {
            "msa": np.zeros((0, 0), np.int8),
            "deletion_matrix": np.zeros((0, 0), np.int8),
        }
    arr = np.full((len(msa.sequences), len(msa.sequences[0])), 31, np.int8)
    for r, seq in enumerate(msa.sequences):
        for c, ch in enumerate(seq.upper()):
            if ch == "-":
                continue
            arr[r, c] = restype_order(RNA_1TO3.get(ch, "N  "))
    dele = np.zeros_like(arr)
    for r, row in enumerate(msa.deletion_matrix):
        dele[r, : len(row)] = np.minimum(row, 127)
    return {"msa": arr, "deletion_matrix": dele}


def rna_msa_key(sequence: str) -> str:
    """md5('rna:'+seq) cache key (dataset_manager.py:49)."""
    from physdock_tpu_torch.utils.io import md5_string

    return md5_string("rna:" + sequence)


def convert_rna_search_outputs(
    msas_dir: str, features_dir: str, max_seqs: int = MAX_MSA_SEQS
) -> None:
    """Realigned RNA stos -> {md5('rna:'+seq)}.pkl.gz int8 features
    (dataset_manager.py:383-450)."""
    os.makedirs(features_dir, exist_ok=True)
    for entry in sorted(os.listdir(msas_dir)):
        out_dir = os.path.join(msas_dir, entry)
        if not os.path.isdir(out_dir):
            continue
        msas = []
        for name in (
            "rfam_realigned.sto",
            "rnacentral_realigned.sto",
            "nt_realigned.sto",
        ):
            p = os.path.join(out_dir, name)
            if os.path.exists(p) and os.path.getsize(p) > 0:
                msas.append(
                    parsers.parse_stockholm(open(p).read()).truncate(
                        DB_CAPS.get(name.split("_")[0], None) or max_seqs
                    )
                )
        if not msas:
            continue
        merged = parsers.merge_msas(msas).truncate(max_seqs)
        feats = rna_msa_to_int8(merged)
        query = merged.sequences[0].replace("-", "").upper()
        dump_pkl(
            feats, os.path.join(features_dir, f"{rna_msa_key(query)}.pkl.gz")
        )


def convert_search_outputs(
    msas_dir: str,
    features_dir: str,
    uniprot_features_dir: Optional[str] = None,
    max_seqs: int = MAX_MSA_SEQS,
) -> None:
    """sto/a3m outputs -> {md5}.pkl.gz int8 feature files with md5
    self-check (dataset_manager.py:167-382)."""
    os.makedirs(features_dir, exist_ok=True)
    if uniprot_features_dir:
        os.makedirs(uniprot_features_dir, exist_ok=True)
    for entry in sorted(os.listdir(msas_dir)):
        out_dir = os.path.join(msas_dir, entry)
        if not os.path.isdir(out_dir):
            continue
        msas = []
        for name in ("uniref90_hits.sto", "mgnify_hits.sto"):
            p = os.path.join(out_dir, name)
            if os.path.exists(p):
                msas.append(
                    parsers.parse_stockholm(open(p).read()).truncate(
                        DB_CAPS.get(name.split("_")[0], None) or max_seqs
                    )
                )
        p = os.path.join(out_dir, "bfd_uniclust_hits.a3m")
        if os.path.exists(p):
            msas.append(parsers.parse_a3m(open(p).read()))
        if msas:
            merged = parsers.merge_msas(msas).truncate(max_seqs)
            feats = msa_to_int8(merged)
            query = merged.sequences[0].replace("-", "")
            key = protein_msa_key(query)
            if key != entry:
                print(f"[warn] md5 mismatch for {entry} (query gives {key})")
            feats["msa_species_identifiers"] = np.array(
                [parsers.species_from_description(d) for d in merged.descriptions],
                object,
            )
            dump_pkl(feats, os.path.join(features_dir, f"{entry}.pkl.gz"))

        # uniprot (pairing) features
        p = os.path.join(out_dir, "uniprot_hits.sto")
        if uniprot_features_dir and os.path.exists(p):
            up = parsers.parse_stockholm(open(p).read()).truncate(
                DB_CAPS["uniprot"]
            )
            up = parsers.deduplicate(up)
            f = msa_to_int8(up)
            dump_pkl(
                {
                    "msa_all_seq": f["msa"],
                    "deletion_matrix_all_seq": f["deletion_matrix"],
                    "msa_species_identifiers_all_seq": np.array(
                        [parsers.species_from_description(d) for d in up.descriptions],
                        object,
                    ),
                },
                os.path.join(uniprot_features_dir, f"{entry}.pkl.gz"),
            )


def _search_one(runner: AlignmentRunner, msas_dir: str, fasta: str) -> Dict[str, str]:
    name = os.path.basename(fasta).rsplit(".", 1)[0]
    return runner.run(fasta, os.path.join(msas_dir, name))


def run_homo_search(
    fasta_paths: Sequence[str],
    output_dir: str,
    cfg: SearchConfig,
    num_workers: int = 4,
) -> None:
    """Pool-parallel homology search + feature conversion
    (alignment_runner_v2.py:263-327)."""
    msas_dir = os.path.join(output_dir, "msas")
    # a module-level task: the pool's spawned workers unpickle it (the JAX
    # package passes a closure, which a spawn pool cannot send)
    one = functools.partial(_search_one, AlignmentRunner(cfg), msas_dir)
    run_pool_tasks(one, list(fasta_paths), num_workers=num_workers)
    convert_search_outputs(
        msas_dir,
        os.path.join(output_dir, "msa_features"),
        os.path.join(output_dir, "uniprot_msa_features"),
    )


def find_missing_msa_features(
    fasta_dir: str, features_dir: str
) -> List[str]:
    """Fastas without a corresponding {md5}.pkl.gz feature file
    (dataset_manager.py:452-504 find-missing helpers)."""
    import glob

    missing = []
    for fasta in sorted(glob.glob(os.path.join(fasta_dir, "*.fasta"))):
        lines = load_txt(fasta)
        seq = "".join(l for l in lines if not l.startswith(">"))
        key = protein_msa_key(seq)
        if not os.path.exists(os.path.join(features_dir, f"{key}.pkl.gz")):
            missing.append(fasta)
    return missing
