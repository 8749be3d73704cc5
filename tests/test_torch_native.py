"""The port's native host library (`physdock_tpu_torch/native/`) against
its NumPy versions and the JAX package's library (`physdock_tpu.native`),
on inputs made from a numpy seed and on the demo MSA features.

Tolerances: the A3M parse and the bond pairs (order included) are exact;
the RMSD matrix within rel 1e-5 of NumPy's (the library sums in float64,
NumPy in float32) and the distance banks within rel 1e-6 (float32 both,
another summation order); against the JAX package's library, the same
C++ source, within rel 1e-6 (that build has -march=native, whose fused
multiply-adds may move the last bit). Also: two processes building the
library into one fresh directory at once both load a whole file.
"""

import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from physdock_tpu import native as jax_native
from physdock_tpu_torch import native
from physdock_tpu_torch.data.msa.search import int8_to_a3m
from physdock_tpu_torch.data.smiles import mol_from_smiles
from physdock_tpu_torch.utils.io import load_pkl

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on this host")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSA_FEATS = os.path.join(REPO, "demo", "redocking", "features", "msa_features")
LIGANDS = ["CC(=O)Nc1ccc(O)cc1", "CC(=O)Oc1ccccc1C(=O)O", "c1ccc2c(c1)Cc1ccccc1N2",
           "OC(=O)CCl", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C"]

INLINE_A3M = """>query
MKV-LAAGIC
>hit1 insertions
MKvaaV-LAAgGIC
>hit2
--V-LXAGI-
>hit3
MKVWLAAGICkk
"""


def test_a3m_parse_matches_numpy_and_jax():
    d = load_pkl(sorted(glob.glob(os.path.join(MSA_FEATS, "*.pkl.gz")))[0])
    msa, dele = d["msa"][:600], d["deletion_matrix"][:600]
    for text in (INLINE_A3M, int8_to_a3m(msa, dele)):
        got = native.parse_a3m_int8(text)
        for ref in (native.parse_a3m_int8_np(text), jax_native.parse_a3m_int8(text)):
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype == np.int8
                np.testing.assert_array_equal(a, b)
    got = native.parse_a3m_int8(int8_to_a3m(msa, dele))
    np.testing.assert_array_equal(got[0], msa)
    np.testing.assert_array_equal(got[1], dele)


def test_pairwise_rmsd_and_distance_banks():
    rng = np.random.default_rng(0)
    poses = (rng.normal(size=(20, 37, 3)) * 4).astype(np.float32)
    got = native.pairwise_rmsd(poses)
    np.testing.assert_allclose(got, native.pairwise_rmsd_np(poses), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jax_native.pairwise_rmsd(poses), rtol=1e-6, atol=0)
    assert (np.diag(got) == 0).all() and (got == got.T).all()
    confs = (rng.normal(size=(8, 29, 3)) * 3).astype(np.float32)
    bank = native.conformer_dist_bank(confs)
    np.testing.assert_allclose(bank, native.conformer_dist_bank_np(confs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bank, jax_native.conformer_dist_bank(confs), rtol=1e-6, atol=0)


@pytest.mark.parametrize("smiles", LIGANDS)
def test_perceive_bonds_on_ligands(smiles):
    mol = mol_from_smiles(smiles, embed=True, seed=0)
    pos, z = np.asarray(mol.coords, np.float32), np.asarray(mol.atomic_numbers, np.int32)
    for scale in (1.17, 1.25, 1.3):
        got = native.perceive_bonds(pos, z, scale=scale)
        assert got == native.perceive_bonds_np(pos, z, scale=scale)
        assert got == jax_native.perceive_bonds(pos, z, scale=scale)
    # at molecule_from_positions' scale every bond of the embedded molecule is found
    bonds = {(min(i, j), max(i, j)) for i, j, _ in mol.bonds}
    assert bonds <= set(native.perceive_bonds(pos, z, scale=1.17))


def test_perceive_bonds_floor_and_random_clouds():
    rng = np.random.default_rng(1)
    pos = (rng.random((60, 3)) * 6).astype(np.float32)
    pos[1] = pos[0] + np.float32([0.3, 0.2, 0.0])  # 0.36 A, below the 0.5 A floor
    z = rng.choice([6, 7, 8, 16, 17, 35], size=60).astype(np.int32)
    got = native.perceive_bonds(pos, z)
    assert (0, 1) not in got
    assert got == native.perceive_bonds_np(pos, z) == jax_native.perceive_bonds(pos, z)


_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from physdock_tpu_torch import native
native.build(force=True)
print(native.pairwise_rmsd(np.ones((2, 3, 3), np.float32)).sum())
"""


def test_two_processes_build_into_one_directory_at_once(tmp_path):
    env = dict(os.environ, PHYSDOCK_COMPILE_CACHE=str(tmp_path / "build"))
    code = _CHILD.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip().endswith("0.0") for o in outs), outs
    assert os.listdir(tmp_path / "build") == ["libphysdock_native.so"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(force=True)


def test_compile_cache_points_the_kernel_and_native_builds(tmp_path, monkeypatch):
    from physdock_tpu.utils import compile_cache as jax_cache
    from physdock_tpu_torch.ops import _flash_lib
    from physdock_tpu_torch.utils import compile_cache

    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(_flash_lib, "BUILD_DIR", _flash_lib.BUILD_DIR)
    monkeypatch.delenv("PHYSDOCK_COMPILE_CACHE", raising=False)
    assert compile_cache.env_build_dir() == compile_cache.DEFAULT_DIR
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, "build")
    d = str(tmp_path / "cache")
    assert compile_cache.enable(d) == d == native.BUILD_DIR == _flash_lib.BUILD_DIR
    assert os.environ["PHYSDOCK_COMPILE_CACHE"] == d  # the worker and ranks inherit it
    assert native.lib_path() == os.path.join(d, "libphysdock_native.so")
    monkeypatch.setenv("PHYSDOCK_COMPILE_CACHE", "off")
    # disabled, as in the JAX package: None, and a directory of this process's own
    assert compile_cache.enable() is None is jax_cache.enable("off")
    assert native.BUILD_DIR == _flash_lib.BUILD_DIR != compile_cache.DEFAULT_DIR
    assert os.path.isdir(native.BUILD_DIR)
