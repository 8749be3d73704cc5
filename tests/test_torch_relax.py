"""Pose checks, charges, relaxation and system preparation in the PyTorch
port against the JAX package (all host NumPy, the pose checks' force-field
terms on CPU tensors):

  * `check_pose` on every decoy of tests/test_check_pose_decoys.py (and
    the collapsed pose of tests/test_infer.py): every boolean and count
    equal, `internal_energy_ok` present (the force-field block ran), and
    `chirality_ok` False on the inverted centre;
  * `gasteiger_charges` and `receptor_partial_charges` on the cases of
    tests/test_charges.py within 1e-6;
  * `relax_complex` on the distorted EJQ pose of tests/test_infer.py and on
    the salt bridge of tests/test_charges.py (the Coulomb term on) within
    1e-4 A;
  * `pad_compact_np` / `pad_compact_msa_np` bitwise on a bucketed demo
    system;
  * `bust_report.json` of the port's redocking CLI equal to the JAX
    `check_pose` on the same poses;
  * `generate_system` on the demo receptor and ligand: the same system
    pkl, and the same features from both featurizers.
"""

import json
import os

import numpy as np
import pytest

from physdock_tpu.data import charges as jcharges
from physdock_tpu.data.mol import read_sdf as jread_sdf
from physdock_tpu.data.smiles import mol_from_smiles as jmol_from_smiles
from physdock_tpu.data.smiles import parse_smiles as jparse_smiles
from physdock_tpu.infer import relax as jrelax
from physdock_tpu.infer.pipeline import _json_safe as j_json_safe
from physdock_tpu_torch.data import charges as tcharges
from physdock_tpu_torch.data.mol import read_sdf as tread_sdf
from physdock_tpu_torch.data.smiles import mol_from_smiles as tmol_from_smiles
from physdock_tpu_torch.data.smiles import parse_smiles as tparse_smiles
from physdock_tpu_torch.infer import relax as trelax
from physdock_tpu_torch.infer.pipeline import _json_safe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREP = os.path.join(REPO, "demo", "system_preparation")
SDF = os.path.join(PREP, "EJQ.sdf")
DEMO = os.path.join(REPO, "demo", "redocking")


def _meta(mol, extra_names=()):
    n = mol.num_atoms
    meta = {"ref_mol": mol, "ligand_atom_idx": np.arange(n)}
    if extra_names:
        meta["atom_names"] = [""] * n + list(extra_names)
    return meta


# ------------------------------------------------------------ pose checks
# each decoy: (x, receptor atom names) built from the EJQ crystal pose, as
# in tests/test_check_pose_decoys.py


def _far_pair(mol):
    gd = mol.shortest_path_matrix()
    a, b = np.unravel_index(np.argmax(gd), gd.shape)
    return int(a), int(b)


def _clean(mol):
    return mol.coords.copy(), ()


def _stretched_bond(mol):
    i, j, _ = mol.bonds[0]
    x = mol.coords.copy()
    x[j] = x[i] + (x[j] - x[i]) * 1.6
    return x, ()


def _buried_internal_clash(mol):
    a, b = _far_pair(mol)
    x = mol.coords.copy()
    x[a] = x[b] + 0.6
    return x, ()


def _moderate_overlap(mol):
    a, b = _far_pair(mol)
    x = mol.coords.copy()
    d = x[b] - x[a]
    x[a] = x[b] - d / np.linalg.norm(d) * 2.0
    return x, ()


def _receptor_clash(mol):
    return np.concatenate([mol.coords, mol.coords[:1] + 0.5]), ("CA",)


def _receptor_contact(mol):
    far = mol.coords[np.argmax(mol.coords[:, 0])] + np.array([3.6, 0.0, 0.0], np.float32)
    return np.concatenate([mol.coords, far[None]]), ("CA",)


def _floating(mol):
    return np.concatenate([mol.coords, mol.coords.mean(0, keepdims=True) + 50.0]), ("CA",)


def _punched_ring(mol):
    arom = mol.aromatic_atoms()
    ring = next(r for r in mol.rings() if len(r) >= 5 and all(arom[a] for a in r))
    x = mol.coords.copy()
    pts = x[ring]
    n_vec = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    n_vec /= np.linalg.norm(n_vec) + 1e-9
    for k, a in enumerate(ring):
        x[a] = x[a] + n_vec * (0.45 if k % 2 == 0 else -0.45)
    return x, ()


def _two_stretched(mol):
    x = mol.coords.copy()
    (i0, j0, _), (i1, j1, _) = mol.bonds[0], mol.bonds[-1]
    x[j0] = x[i0] + (x[j0] - x[i0]) * 1.6
    x[j1] = x[i1] + (x[j1] - x[i1]) * 1.6
    return x, ()


def _collapsed(mol):
    return mol.coords * 0.1, ()


EJQ_DECOYS = {
    "clean": _clean,
    "stretched_bond": _stretched_bond,
    "buried_internal_clash": _buried_internal_clash,
    "moderate_overlap": _moderate_overlap,
    "receptor_buried_clash": _receptor_clash,
    "receptor_healthy_contact": _receptor_contact,
    "floating_ligand": _floating,
    "punched_aromatic_ring": _punched_ring,
    "counts_accumulate": _two_stretched,
    "collapsed": _collapsed,
}


@pytest.fixture(scope="module")
def ejq():
    return jread_sdf(SDF), tread_sdf(SDF)


@pytest.mark.parametrize("decoy", list(EJQ_DECOYS))
def test_check_pose_matches_jax_on_decoys(ejq, decoy):
    jm, tm = ejq
    x, names = EJQ_DECOYS[decoy](jm)
    want = jrelax.check_pose(x, _meta(jm, names))
    got = trelax.check_pose(x, _meta(tm, names))
    # the force-field block ran (its failure would pass the pose silently)
    assert "internal_energy_ok" in got and "chirality_ok" in got
    assert got == want
    assert _json_safe(got) == j_json_safe(want)


def _inverted_alanine(mol_from_smiles):
    mol = mol_from_smiles("C[C@H](N)C(=O)O")
    centre, nbrs = mol.chiral_centers()[0]
    heavy = [a for a in nbrs if a != centre][:3]
    x = mol.coords.copy()
    pts = x[heavy]
    n_vec = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    n_vec /= np.linalg.norm(n_vec) + 1e-9
    v = x[centre] - pts.mean(0)
    x[centre] = pts.mean(0) + v - 2 * np.dot(v, n_vec) * n_vec
    return mol, x


@pytest.mark.parametrize("inverted", [False, True], ids=["clean", "inverted"])
def test_check_pose_matches_jax_on_chiral_centre(inverted):
    jm, jx = _inverted_alanine(jmol_from_smiles)
    tm, tx = _inverted_alanine(tmol_from_smiles)
    np.testing.assert_array_equal(jx, tx)
    x = jx if inverted else jm.coords
    want = jrelax.check_pose(x, _meta(jm))
    got = trelax.check_pose(x, _meta(tm))
    assert "internal_energy_ok" in got
    assert got == want
    assert got["chirality_ok"] is (not inverted)


# ---------------------------------------------------------------- charges

LIGANDS = ["CCO", "c1ccccc1", "CC(=O)NC", "CS(=O)(=O)C", "CC(=O)[O-]", "C[NH3+]", "CC(C)C",
           "CC(=O)C", "CF", "c1ccc2[nH]ccc2c1"]


@pytest.mark.parametrize("smi", LIGANDS)
def test_gasteiger_charges_match_jax(smi):
    want = jcharges.gasteiger_charges(jparse_smiles(smi))
    got = tcharges.gasteiger_charges(tparse_smiles(smi))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


RECEPTORS = [
    (["ASP"] * 4 + ["LYS"] * 3 + ["ALA"] * 3,
     ["CG", "OD1", "OD2", "CB", "NZ", "CE", "CD", "N", "CA", "O"],
     [0, 0, 0, 0, 1, 1, 1, 2, 2, 2]),
    (["ASP", "ASP", "LYS", "SER", "SER", "GLY", "GLY"],
     ["OD1", "OD2", "NZ", "OG", "CB", "N", "O"],
     [0, 0, 1, 2, 2, 3, 3]),
    (["ARG"] * 4 + ["HIS"] * 3 + ["U"] * 3,
     ["CZ", "NH1", "NH2", "CA", "ND1", "NE2", "CE1", "P", "OP1", "O5'"],
     [0, 0, 0, 0, 1, 1, 1, 2, 2, 2]),
]


@pytest.mark.parametrize("case", range(len(RECEPTORS)))
def test_receptor_partial_charges_match_jax(case):
    res, names, rid = RECEPTORS[case]
    want = jcharges.receptor_partial_charges(res, names, rid)
    got = tcharges.receptor_partial_charges(res, names, rid)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------- relaxation


def test_relax_complex_matches_jax_on_distorted_pose(ejq):
    jm, tm = ejq
    rng = np.random.default_rng(3)
    x = jm.coords + rng.normal(0, 0.25, jm.coords.shape).astype(np.float32)
    names = ["C"] * jm.num_atoms
    want = jrelax.relax_complex(x, {**_meta(jm), "atom_names": names}, iters=150)
    got = trelax.relax_complex(x, {**_meta(tm), "atom_names": names}, iters=150)
    assert got.dtype == np.float32
    assert np.abs(got - x).max() > 0.05  # the pose moved
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _salt_bridge(mol_from_smiles, charges):
    mol = mol_from_smiles("CC(=O)[O-]", seed=0)
    lig = mol.coords.copy()
    o_neg = int(np.argmin(charges.gasteiger_charges(mol)))
    nz = lig[o_neg] + np.array([4.5, 0, 0], np.float32)
    ca = lig[o_neg] + np.array([12.0, 0, 0], np.float32)
    x = np.concatenate([np.stack([nz, ca]), lig]).astype(np.float32)
    meta = {"ref_mol": mol, "ligand_atom_idx": np.arange(2, 2 + mol.num_atoms),
            "atom_names": ["NZ", "CA"] + ["C"] * mol.num_atoms, "ccds": ["LYS", "LIG"],
            "chunk_sizes": np.array([2, mol.num_atoms])}
    return x, meta


def test_relax_complex_matches_jax_with_electrostatics():
    jx, jmeta = _salt_bridge(jmol_from_smiles, jcharges)
    tx, tmeta = _salt_bridge(tmol_from_smiles, tcharges)
    np.testing.assert_array_equal(jx, tx)
    want = jrelax.relax_complex(jx, jmeta, iters=150, elec_weight=2.0)
    got = trelax.relax_complex(tx, tmeta, iters=150, elec_weight=2.0)
    assert np.abs(got - jx).max() > 0.01
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------- padding


def test_pad_compact_matches_jax_bitwise():
    from physdock_tpu.model import compact as jcompact
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.model import compact as tcompact

    cfg = PhysDockConfig.named("toy", crop_size=32, atom_crop_size=256,
                               infer_use_pocket=True, infer_use_key_res=True)
    fz = SystemFeaturizer(cfg.data, msa_features_dir=f"{DEMO}/features/msa_features",
                          uniprot_msa_features_dir=f"{DEMO}/features/uniprot_msa_features",
                          inference_mode=True, seed=0)
    feats, meta = fz.load(f"{DEMO}/Posebusters_subset/5SD5_HWI_A_1.pkl.gz", num_msa_rounds=2)
    c = tcompact.compact_batch_np(feats)
    n_tok, n_atom = len(c["s_mask"]) + 16, len(c["a_mask"]) + 128
    want = jcompact.pad_compact_np(c, n_tok, n_atom)
    got = tcompact.pad_compact_np(c, n_tok, n_atom)
    assert set(got) == set(want) and set(got) == set(c)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["s_mask"]) == n_tok and len(got["a_mask"]) == n_atom
    for m in meta["batch_msa_feat"]:
        mc = tcompact.compact_msa_np(m)
        want = jcompact.pad_compact_msa_np(mc, n_tok)
        got = tcompact.pad_compact_msa_np(mc, n_tok)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ bust report


def _as_jax_mol(mol):
    """The port's molecule as the JAX package's class, caches dropped."""
    from physdock_tpu.data.mol import Molecule

    jm = Molecule.__new__(Molecule)
    jm.__dict__.update({k: v for k, v in mol.__dict__.items() if not k.endswith("_cache")})
    jm._rings = None
    return jm


def test_bust_report_of_the_cli_matches_jax_check_pose(tmp_path, monkeypatch):
    import torch

    from physdock_tpu_torch.cli import redocking
    from physdock_tpu_torch.infer import pipeline as tpipe

    torch.set_num_threads(2)
    seen = []

    def recording(x, meta):
        out = trelax.check_pose(x, meta)
        seen.append((np.array(x), meta))
        return out

    monkeypatch.setattr(tpipe, "check_pose", recording)
    out = str(tmp_path / "out")
    (res,) = redocking.main([
        "-i", f"{DEMO}/Posebusters_subset/5SD5_HWI_A_1.pkl.gz", "-o", out,
        "--model_name", "toy", "--params", os.path.join(REPO, "_overfit", "ema_params.npz"),
        "--crop_size", "32", "--atom_crop_size", "256",
        "--msa_features_dir", f"{DEMO}/features/msa_features",
        "--uniprot_msa_features_dir", f"{DEMO}/features/uniprot_msa_features",
        "--steps", "2", "--max_rounds", "1", "--num_samples_per_round", "3",
        "--max_samples", "3", "--num_confs", "4", "--use_pocket", "--use_key_res",
        "--enable_physics_correction", "--enable_ranking", "--device", "cpu",
    ])
    with open(os.path.join(out, "5SD5_HWI_A_1", "bust_report.json")) as f:
        report = json.load(f)
    assert len(report) == len(seen) == res["num_poses"] == 3
    for rank, (entry, (x, meta)) in enumerate(zip(report, seen)):
        jmeta = dict(meta, ref_mol=_as_jax_mol(meta["ref_mol"]))
        want = {"rank": rank, **j_json_safe(jrelax.check_pose(x, jmeta))}
        assert entry == want
        assert "pose_valid" in entry and "internal_energy_ok" in entry


# ------------------------------------------------------- system preparation


def test_prepare_system_matches_jax(tmp_path):
    from physdock_tpu.config import PhysDockConfig as JaxConfig
    from physdock_tpu.data.feature_loader import SystemFeaturizer as JaxFeaturizer
    from physdock_tpu.data.system import generate_system as jgenerate
    from physdock_tpu_torch.cli import prepare_system
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.utils.io import load_pkl

    receptor, ligand = os.path.join(PREP, "receptor.pdb"), SDF
    t_pkl = prepare_system.main(["-r", receptor, "-l", ligand, "-o", str(tmp_path / "t")])
    j_pkl = jgenerate(receptor, ligand, str(tmp_path / "j"))
    assert os.path.basename(t_pkl) == os.path.basename(j_pkl)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    t_sys, j_sys = load_pkl(t_pkl), load_pkl(j_pkl)
    assert list(t_sys) == list(j_sys)
    for chain in j_sys:
        assert t_sys[chain]["ccds"] == j_sys[chain]["ccds"]
        for a, b in zip(t_sys[chain]["all_atom_positions"], j_sys[chain]["all_atom_positions"]):
            np.testing.assert_array_equal(a, b)

    kw = dict(crop_size=64, atom_crop_size=512, infer_use_pocket=True)
    t_feats, t_meta = SystemFeaturizer(PhysDockConfig.named("toy", **kw).data, seed=0).load(t_pkl)
    j_feats, j_meta = JaxFeaturizer(JaxConfig.named("toy", **kw).data, seed=0).load(j_pkl)
    assert set(t_feats) == set(j_feats)
    for k in j_feats:
        np.testing.assert_array_equal(np.asarray(t_feats[k]), np.asarray(j_feats[k]), err_msg=k)
    np.testing.assert_array_equal(t_meta["ligand_atom_idx"], j_meta["ligand_atom_idx"])
    assert int(t_feats["is_ligand"].sum()) == 16
