"""Subprocess wrappers for the homology-search C binaries.

Host-side equivalents of the AlphaFold-lineage tool wrappers
(reference: data/tools/{jackhmmer,hhblits,nhmmer,hmmbuild,hmmalign,
hhsearch,kalign}.py).  Each wrapper builds the CLI, streams stdout/stderr,
and raises with captured logs on failure; binaries resolve via PATH or an
explicit path and are availability-gated (`.available`).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence


class ToolError(RuntimeError):
    pass


def _run(cmd: Sequence[str], cwd: Optional[str] = None) -> str:
    proc = subprocess.run(
        list(cmd), cwd=cwd, capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise ToolError(
            f"{cmd[0]} failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    return proc.stdout


@dataclasses.dataclass
class Jackhmmer:
    """jackhmmer search (reference: tools/jackhmmer.py:98-193 flag surface)."""

    database_path: str
    binary_path: str = "jackhmmer"
    n_cpu: int = 8
    n_iter: int = 1
    e_value: float = 1e-4
    z_value: Optional[int] = None
    filter_f1: float = 5e-4
    filter_f2: float = 5e-5
    filter_f3: float = 5e-7
    max_sequences: Optional[int] = None

    @property
    def available(self) -> bool:
        return shutil.which(self.binary_path) is not None

    def query(self, fasta_path: str, output_sto: str) -> str:
        cmd = [
            self.binary_path,
            "-o", "/dev/null",
            "-A", output_sto,
            "--noali",
            "--F1", str(self.filter_f1),
            "--F2", str(self.filter_f2),
            "--F3", str(self.filter_f3),
            "--incE", str(self.e_value),
            "-E", str(self.e_value),
            "--cpu", str(self.n_cpu),
            "-N", str(self.n_iter),
        ]
        if self.z_value:
            cmd += ["-Z", str(self.z_value)]
        cmd += [fasta_path, self.database_path]
        _run(cmd)
        with open(output_sto) as f:
            return f.read()


@dataclasses.dataclass
class HHBlits:
    """hhblits search vs bfd/uniclust (reference: tools/hhblits.py)."""

    databases: Sequence[str]
    binary_path: str = "hhblits"
    n_cpu: int = 4
    n_iter: int = 3
    e_value: float = 1e-3
    maxseq: int = 1_000_000
    realign_max: int = 100_000
    maxfilt: int = 100_000
    min_prefilter_hits: int = 1000

    @property
    def available(self) -> bool:
        return shutil.which(self.binary_path) is not None

    def query(self, fasta_path: str, output_a3m: str) -> str:
        cmd = [
            self.binary_path,
            "-i", fasta_path,
            "-oa3m", output_a3m,
            "-cpu", str(self.n_cpu),
            "-n", str(self.n_iter),
            "-e", str(self.e_value),
            "-maxseq", str(self.maxseq),
            "-realign_max", str(self.realign_max),
            "-maxfilt", str(self.maxfilt),
            "-min_prefilter_hits", str(self.min_prefilter_hits),
        ]
        for db in self.databases:
            cmd += ["-d", db]
        _run(cmd)
        with open(output_a3m) as f:
            return f.read()


@dataclasses.dataclass
class Nhmmer:
    """nhmmer RNA search (reference: tools/nhmmer.py)."""

    database_path: str
    binary_path: str = "nhmmer"
    n_cpu: int = 4
    e_value: float = 1e-3

    @property
    def available(self) -> bool:
        return shutil.which(self.binary_path) is not None

    def query(self, fasta_path: str, output_sto: str) -> str:
        cmd = [
            self.binary_path,
            "-o", "/dev/null",
            "-A", output_sto,
            "-E", str(self.e_value),
            "--cpu", str(self.n_cpu),
            fasta_path,
            self.database_path,
        ]
        _run(cmd)
        with open(output_sto) as f:
            return f.read()


@dataclasses.dataclass
class Hmmbuild:
    binary_path: str = "hmmbuild"

    @property
    def available(self) -> bool:
        return shutil.which(self.binary_path) is not None

    def build(
        self,
        input_path: str,
        output_hmm: str,
        hand: bool = True,
        alphabet: str = "amino",
    ) -> None:
        """Build a profile from an alignment (sto/fasta).  alphabet:
        amino | rna | dna (reference: tools/hmmbuild.py model_construction +
        build_rna_profile_from_fasta)."""
        cmd = [self.binary_path]
        if hand:
            cmd.append("--hand")
        cmd.append(f"--{alphabet}")
        _run(cmd + [output_hmm, input_path])


@dataclasses.dataclass
class Hmmalign:
    binary_path: str = "hmmalign"
    hmmbuild_binary_path: str = "hmmbuild"

    @property
    def available(self) -> bool:
        return (
            shutil.which(self.binary_path) is not None
            and shutil.which(self.hmmbuild_binary_path) is not None
        )

    def align(self, hmm_path: str, fasta_path: str) -> str:
        return _run([self.binary_path, "--trim", hmm_path, fasta_path])

    def realign_sto_with_fasta(
        self,
        fasta_path: str,
        sto_in_path: str,
        sto_out_path: str,
        rna: bool = True,
    ) -> None:
        """Realign a search sto against a profile built from the query fasta
        (reference: tools/hmmalign.py:29-60, the RNA realign stage of
        alignment_runner.py:100-128)."""
        with tempfile.TemporaryDirectory() as td:
            hmm = os.path.join(td, "query.hmm")
            Hmmbuild(self.hmmbuild_binary_path).build(
                fasta_path, hmm, hand=False, alphabet="rna" if rna else "amino"
            )
            cmd = [self.binary_path]
            if rna:
                cmd.append("--rna")
            cmd += ["--mapali", fasta_path, "-o", sto_out_path, hmm, sto_in_path]
            _run(cmd)


@dataclasses.dataclass
class Hmmsearch:
    """hmmsearch: profile (from an sto MSA) vs a sequence database
    (reference: tools/hmmsearch.py:27-137 incl. its default permissive
    filter/E-value flags)."""

    database_path: str
    binary_path: str = "hmmsearch"
    hmmbuild_binary_path: str = "hmmbuild"
    n_cpu: int = 8
    flags: Sequence[str] = (
        "--F1", "0.1", "--F2", "0.1", "--F3", "0.1",
        "--incE", "100", "-E", "100", "--domE", "100", "--incdomE", "100",
    )

    @property
    def available(self) -> bool:
        return (
            shutil.which(self.binary_path) is not None
            and shutil.which(self.hmmbuild_binary_path) is not None
        )

    def query(self, msa_sto: str, output_sto: str) -> str:
        """Build an hmm from the query MSA (hand construction), search the
        database, return the hit alignment sto."""
        with tempfile.TemporaryDirectory() as td:
            sto_in = os.path.join(td, "query.sto")
            hmm = os.path.join(td, "query.hmm")
            with open(sto_in, "w") as f:
                f.write(msa_sto)
            Hmmbuild(self.hmmbuild_binary_path).build(sto_in, hmm, hand=True)
            cmd = (
                [self.binary_path, "--noali", "--cpu", str(self.n_cpu)]
                + list(self.flags)
                + ["-A", output_sto, hmm, self.database_path]
            )
            _run(cmd)
        with open(output_sto) as f:
            return f.read()


@dataclasses.dataclass
class HHSearch:
    """hhsearch template search vs pdb70 (reference: tools/hhsearch.py)."""

    databases: Sequence[str]
    binary_path: str = "hhsearch"
    n_cpu: int = 4
    maxseq: int = 1_000_000

    @property
    def available(self) -> bool:
        return shutil.which(self.binary_path) is not None

    def query(self, a3m_path: str, output_hhr: str) -> str:
        cmd = [
            self.binary_path,
            "-i", a3m_path,
            "-o", output_hhr,
            "-cpu", str(self.n_cpu),
            "-maxseq", str(self.maxseq),
        ]
        for db in self.databases:
            cmd += ["-d", db]
        _run(cmd)
        with open(output_hhr) as f:
            return f.read()


@dataclasses.dataclass
class Kalign:
    binary_path: str = "kalign"

    @property
    def available(self) -> bool:
        return shutil.which(self.binary_path) is not None

    def align(self, sequences: Sequence[str]) -> str:
        with tempfile.TemporaryDirectory() as td:
            inp = os.path.join(td, "in.fasta")
            out = os.path.join(td, "out.fasta")
            with open(inp, "w") as f:
                for i, s in enumerate(sequences):
                    f.write(f">seq{i}\n{s}\n")
            _run([self.binary_path, "-i", inp, "-o", out, "-format", "fasta"])
            with open(out) as f:
                return f.read()
