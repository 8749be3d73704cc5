"""The port's MSA and template modules (`physdock_tpu_torch/data/msa/`) and
its homology-search CLI against the JAX package's, on inline texts and on
fake search binaries.

All comparisons are exact (text parsing and int8 features): the parsers on
inline FASTA, A3M, Stockholm, HHR and mmCIF text (as tests/test_templates.py
writes them), the int8 conversions, the template pair features. Then
`AlignmentRunner` and `run_homo_search` of both packages run with fake
`jackhmmer` and `hhblits` shell scripts on PATH that write canned
Stockholm and A3M hits built from the query: the same files, keys and
int8 features, and on a second run the same searches skipped (each fake
binary logs its calls). No real search tool and no network are used.
"""

import os
import stat

import numpy as np
import pytest

from physdock_tpu.data.msa import parsers as jparsers
from physdock_tpu.data.msa import search as jsearch
from physdock_tpu.data.msa import templates as jtemplates
from physdock_tpu_torch.cli import run_homo_search as cli
from physdock_tpu_torch.data.msa import parsers, search, templates
from physdock_tpu_torch.utils.io import load_pkl, protein_msa_key

FASTA = """>q1 first
MKVLAAGIC
>q2 second
MKV
LAAGICWW
"""

A3M = """>query
MKV-LAAGIC
>tr|A0A1|A0A1_HUMAN/1-9 insertions
MKvaaV-LAAgGIC
>sp|P12345|ABC_MOUSE
--V-LXAGI-
>UniRef90_X OX=9606
MKVWLAAGICkk
"""

STO = """# STOCKHOLM 1.0
#=GS query DE the query
#=GS tr|B0B1|B0B1_YEAST DE a hit
query              MKV-LA.AGIC
tr|B0B1|B0B1_YEAST MKvaLAaA-IC
hit2               --V.LAgAG--
//
"""

RNA_STO = "# STOCKHOLM 1.0\nq AGCUU\nhit1 AG-UU\nhit2 AGCTU\n//\n"


def _same_msa(a, b):
    assert (a.sequences, a.deletion_matrix, a.descriptions) == (
        b.sequences, b.deletion_matrix, b.descriptions)


def _same_feats(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_parsers_match_jax():
    assert parsers.parse_fasta(FASTA) == jparsers.parse_fasta(FASTA)
    _same_msa(parsers.parse_a3m(A3M), jparsers.parse_a3m(A3M))
    _same_msa(parsers.parse_stockholm(STO), jparsers.parse_stockholm(STO))
    assert parsers.convert_stockholm_to_a3m(STO, 2) == jparsers.convert_stockholm_to_a3m(STO, 2)
    msas = [parsers.parse_a3m(A3M), parsers.parse_stockholm(STO), parsers.parse_a3m(A3M)]
    jmsas = [jparsers.parse_a3m(A3M), jparsers.parse_stockholm(STO), jparsers.parse_a3m(A3M)]
    _same_msa(parsers.merge_msas(msas), jparsers.merge_msas(jmsas))
    _same_msa(parsers.deduplicate(msas[0]).truncate(2), jparsers.deduplicate(jmsas[0]).truncate(2))
    for d in parsers.parse_a3m(A3M).descriptions + ["", "plain name", "x OX=10090 y"]:
        assert parsers.species_from_description(d) == jparsers.species_from_description(d)
    _same_feats(search.msa_to_int8(msas[0]), jsearch.msa_to_int8(jmsas[0]))
    _same_feats(search.msa_to_int8(msas[1]), jsearch.msa_to_int8(jmsas[1]))
    _same_feats(search.rna_msa_to_int8(parsers.parse_stockholm(RNA_STO)),
                jsearch.rna_msa_to_int8(jparsers.parse_stockholm(RNA_STO)))
    assert search.rna_msa_key("AGCU") == jsearch.rna_msa_key("AGCU")
    empty = parsers.Msa([], [], [])
    _same_feats(search.msa_to_int8(empty), jsearch.msa_to_int8(jparsers.Msa([], [], [])))


HHR = """Query q
No 1
>1abc_A tmpl
Probab=99.0 E-value=1e-30 Aligned_cols=5 Identities=40% Similarity=0.6 Sum_probs=4.5

Q q                1 MKVLA    5 (10)
Q Consensus        1 mkvla    5 (10)
T 1abc_A           2 MK-LA    6 (8)
T Consensus        2 mk-la    6 (8)
No 2
>2xyz_B other
Probab=50.0 E-value=0.1 Aligned_cols=3 Identities=30% Similarity=0.2 Sum_probs=1.5

Q q                3 VLA    5 (10)
T 2xyz_B           1 VIA    3 (4)
"""

CIF = """data_test
loop_
_atom_site.group_PDB
_atom_site.label_atom_id
_atom_site.label_comp_id
_atom_site.auth_asym_id
_atom_site.label_seq_id
_atom_site.Cartn_x
_atom_site.Cartn_y
_atom_site.Cartn_z
ATOM CA MET A 1 0.0 0.0 0.0
ATOM CB MET A 1 1.0 0.0 0.0
ATOM CA LYS A 2 3.8 0.0 0.0
ATOM CB LYS A 2 4.5 0.5 0.0
ATOM CA GLY A 3 7.6 0.0 0.0
ATOM CA LEU A 4 11.4 0.0 0.0
ATOM CB LEU A 4 12.0 0.6 0.0
ATOM CA ALA A 5 15.2 0.0 0.0
ATOM CB ALA A 5 15.9 0.4 0.0
ATOM CA VAL B 1 0.0 5.0 0.0
ATOM CB VAL B 1 0.5 5.5 0.0
#
"""


def _mmcif(n_res=5):
    heads = ["group_PDB", "id", "type_symbol", "label_atom_id", "label_alt_id",
             "label_comp_id", "label_asym_id", "label_entity_id", "label_seq_id",
             "pdbx_PDB_ins_code", "Cartn_x", "Cartn_y", "Cartn_z", "occupancy",
             "B_iso_or_equiv", "pdbx_formal_charge", "auth_seq_id", "auth_comp_id",
             "auth_asym_id", "auth_atom_id", "pdbx_PDB_model_num"]
    rows = []
    for seq in range(1, n_res + 1):
        for nm, off in (("N", 0.0), ("CA", 1.0), ("CB", 2.0)):
            rows.append(f"ATOM {len(rows) + 1} C {nm} . MET A 1 {seq} ? "
                        f"{seq * 4.0 + off:.2f} {0.3 * seq:.2f} 0.00 1.0 0.0 ? {seq} MET A {nm} 1")
    return "loop_\n" + "\n".join(f"_atom_site.{h}" for h in heads) + "\n" + "\n".join(rows) + "\n#\n"


def _same_hits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert vars(x) == vars(y)


def test_templates_match_jax():
    hits, jhits = templates.parse_hhr(HHR), jtemplates.parse_hhr(HHR)
    _same_hits(hits, jhits)
    chains, jchains = templates.parse_mmcif_atoms(CIF), jtemplates.parse_mmcif_atoms(CIF)
    assert set(chains) == set(jchains) == {"A", "B"}
    for c in chains:
        a, b = chains[c], jchains[c]
        assert (a.chain_id, a.restypes) == (b.chain_id, b.restypes)
        assert {r: set(x) for r, x in a.positions.items()} == {
            r: set(x) for r, x in b.positions.items()}
        for r, atoms in a.positions.items():
            for name, xyz in atoms.items():
                np.testing.assert_array_equal(xyz, b.positions[r][name])
    for h, jh in zip(hits, jhits):
        np.testing.assert_array_equal(
            templates.template_pair_features(h, chains["A"], query_length=10),
            jtemplates.template_pair_features(jh, jchains["A"], query_length=10))

    query = "MKVLA"
    sto = "# STOCKHOLM 1.0\n#=GS 1abc_A DE test hit\n1abc_A MK-LA\n2def_B MKvVLA\n3ghi_C MKVLA\n//\n"
    hits, jhits = templates.parse_hmmsearch_sto(sto, query), jtemplates.parse_hmmsearch_sto(sto, query)
    _same_hits(hits, jhits)
    kw = dict(mmcif_lookup={"1abc": _mmcif(), "2def": _mmcif(), "3ghi": _mmcif(4)},
              release_dates={"1abc": "2020-01-01", "2def": "2030-01-01", "3ghi": "2019-05-05"},
              max_template_date="2021-06-01", min_align_ratio=0.5)
    got = templates.TemplateHitFeaturizer(**kw).featurize(hits, query)
    want = jtemplates.TemplateHitFeaturizer(**kw).featurize(jhits, query)
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# a fake jackhmmer: `-A OUT ... FASTA DB` -> a Stockholm of the query and two
# hits derived from it; a fake hhblits: `-i FASTA -oa3m OUT` -> an A3M. Each
# call is logged to $FAKE_LOG.
JACKHMMER = r"""#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-A" ] && out="$a"; prev="$a"; done
eval fasta=\${$(($# - 1))}
eval db=\${$#}
echo "jackhmmer $(basename "$db") $(basename "$fasta")" >> "$FAKE_LOG"
seq=$(grep -v '>' "$fasta" | tr -d '\n')
h1=$(echo "$seq" | sed 's/^./A/; s/.$/-/')
h2=$(echo "$seq" | sed 's/^../--/')
tag=$(basename "$db" .db | tr 'a-z' 'A-Z')
{
  echo "# STOCKHOLM 1.0"
  echo "#=GS tr|Q1|Q1_${tag} DE hit one"
  echo "query $seq"
  echo "tr|Q1|Q1_${tag}/1-20 $h1"
  echo "UniRef90_${tag} $h2"
  echo "query2 $seq"
  echo "//"
} > "$out"
"""

HHBLITS = r"""#!/bin/sh
out=""; fasta=""; prev=""
for a in "$@"; do
  [ "$prev" = "-oa3m" ] && out="$a"
  [ "$prev" = "-i" ] && fasta="$a"
  prev="$a"
done
echo "hhblits $(basename "$fasta")" >> "$FAKE_LOG"
seq=$(grep -v '>' "$fasta" | tr -d '\n')
h1=$(echo "$seq" | sed 's/^\(.\)\(.\)/\1kk\2/; s/.$/Y/')
printf '>query\n%s\n>bfd_hit_MOUSE\n%s\n' "$seq" "$h1" > "$out"
"""

SEQS = ("MKVLAAGICWHDEFRST", "GSHMKTAYIAKQRQISFVKSHFSRQ")


@pytest.fixture
def fake_tools(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, text in (("jackhmmer", JACKHMMER), ("hhblits", HHBLITS)):
        p = bin_dir / name
        p.write_text(text)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_LOG", str(log))
    fastas = tmp_path / "fastas"
    fastas.mkdir()
    for seq in SEQS:  # named by their MSA key, as the featurizer looks them up
        (fastas / f"{protein_msa_key(seq)}.fasta").write_text(f">{seq[:4]}\n{seq}\n")
    dbs = {k: str(tmp_path / f"{k}.db") for k in ("uniref90", "uniprot", "mgnify", "bfd",
                                                   "uniclust30")}
    return fastas, dbs, log


def _calls(log):
    return sorted(log.read_text().splitlines()) if log.exists() else []


def test_alignment_runner_matches_jax(fake_tools, tmp_path):
    fastas, dbs, log = fake_tools
    fasta = sorted(fastas.iterdir())[0]
    kw = dict(uniref90_path=dbs["uniref90"], uniprot_path=dbs["uniprot"],
              mgnify_path=dbs["mgnify"], bfd_path=dbs["bfd"], uniclust30_path=dbs["uniclust30"],
              n_cpu=1)
    got = search.AlignmentRunner(search.SearchConfig(**kw)).run(str(fasta), str(tmp_path / "p"))
    calls = _calls(log)
    assert len(calls) == 4
    want = jsearch.AlignmentRunner(jsearch.SearchConfig(**kw)).run(str(fasta), str(tmp_path / "j"))
    assert sorted(got) == sorted(want) == ["bfd_uniclust_hits.a3m", "mgnify_hits.sto",
                                           "uniprot_hits.sto", "uniref90_hits.sto"]
    for name in got:
        assert open(got[name]).read() == open(want[name]).read()
    # cached by output existence: a second run calls no tool
    n = len(_calls(log))
    again = search.AlignmentRunner(search.SearchConfig(**kw)).run(str(fasta), str(tmp_path / "p"))
    assert again == got and len(_calls(log)) == n


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def test_run_homo_search_cli_matches_jax(fake_tools, tmp_path):
    fastas, dbs, log = fake_tools
    flags = ["--uniref90", dbs["uniref90"], "--uniprot", dbs["uniprot"], "--mgnify",
             dbs["mgnify"], "--bfd", dbs["bfd"], "--uniclust30", dbs["uniclust30"],
             "--n_cpu", "1"]
    # the port's pool of two workers (the JAX package's closure cannot go
    # through a spawn pool, so its side runs with one worker)
    cli.main(["-f", str(fastas), "-o", str(tmp_path / "port"), "--num_workers", "2", *flags])
    first = _calls(log)
    assert len(first) == 4 * len(SEQS)
    jsearch.run_homo_search(sorted(str(p) for p in fastas.iterdir()), str(tmp_path / "jax"),
                            jsearch.SearchConfig(
                                uniref90_path=dbs["uniref90"], uniprot_path=dbs["uniprot"],
                                mgnify_path=dbs["mgnify"], bfd_path=dbs["bfd"],
                                uniclust30_path=dbs["uniclust30"], n_cpu=1), num_workers=1)
    port, jax_ = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax_)
    keys = {protein_msa_key(s) for s in SEQS}
    for sub in ("msa_features", "uniprot_msa_features"):
        assert {f.split("/")[-1][: -len(".pkl.gz")] for f in port if f.startswith(sub)} == keys
    for rel, p in port.items():
        if rel.endswith(".pkl.gz"):
            _same_feats(load_pkl(p), load_pkl(jax_[rel]))
        else:
            assert open(p).read() == open(jax_[rel]).read(), rel
    feats = load_pkl(port[f"msa_features/{protein_msa_key(SEQS[0])}.pkl.gz"])
    assert feats["msa"].dtype == np.int8 and feats["msa"].shape[1] == len(SEQS[0])

    # a second run: every search cached, the features written again alike
    n = len(_calls(log))
    cli.main(["-f", str(fastas), "-o", str(tmp_path / "port"), "--num_workers", "1", *flags])
    assert len(_calls(log)) == n
    again = _tree(tmp_path / "port")
    assert sorted(again) == sorted(port)
    missing = search.find_missing_msa_features(str(fastas), str(tmp_path / "port" / "msa_features"))
    assert missing == [] == jsearch.find_missing_msa_features(
        str(fastas), str(tmp_path / "jax" / "msa_features"))
    assert len(search.find_missing_msa_features(str(fastas), str(tmp_path))) == len(SEQS)
