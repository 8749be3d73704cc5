"""The port's host featurizer (`physdock_tpu_torch/data/feature_loader.py`)
against the JAX package's on real systems, at crop 64/512 with the same
seed in both packages:

  * the redocking system 5SD5_HWI_A_1 (its MSA features from the demo);
  * one demo SMILES docked into the screening receptor 6kzd (the receptor's
    ligand removed, the ligand built from the SMILES);

each in inference mode (what the CLIs and the train-to-dock gate dock
and train on) and in training mode (what the train CLI and
`MixedBatchSampler` featurize: random crops, pocket and key-residue
draws, augmentations), two loads in a row so that the training mode's
shared generator is followed past its first draw.

Every key of `feats` must be equal: integer and boolean arrays exactly,
floats within 1e-6 abs; of `meta`, every key but `ref_mol` (a `Molecule` of
each package's own class) likewise, and of `ref_mol` its atoms, charges,
bonds and coordinates.
"""

import os

import numpy as np
import pytest

from physdock_tpu.config import DataConfig as JaxDataConfig
from physdock_tpu.data.feature_loader import SystemFeaturizer as JaxFeaturizer
from physdock_tpu_torch.config import DataConfig
from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from test_torch_data_mix import assert_features_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REDOCK = os.path.join(REPO, "demo", "redocking")
SCREEN = os.path.join(REPO, "demo", "screening")
with open(os.path.join(SCREEN, "demo_db.txt")) as f:
    SMILES = f.readline().strip()
CASES = {
    "5SD5_HWI_A_1": (os.path.join(REDOCK, "Posebusters_subset", "5SD5_HWI_A_1.pkl.gz"),
                     os.path.join(REDOCK, "features"), {}),
    "6kzd+smiles": (os.path.join(SCREEN, "6kzd.pkl.gz"), os.path.join(SCREEN, "features"),
                    {"remove_ligand": True, "smi": SMILES}),
}


def _loads(featurizer_cls, config_cls, case, inference_mode):
    path, feats_dir, kw = CASES[case]
    fz = featurizer_cls(config_cls(crop_size=64, atom_crop_size=512),
                        msa_features_dir=os.path.join(feats_dir, "msa_features"),
                        uniprot_msa_features_dir=os.path.join(feats_dir, "uniprot_msa_features"),
                        inference_mode=inference_mode, seed=3)
    return [fz.load(path, **kw)[:2] for _ in range(2)]


@pytest.mark.parametrize("inference_mode", [True, False], ids=["inference", "training"])
@pytest.mark.parametrize("case", list(CASES))
def test_featurizer_matches_jax_on_real_systems(case, inference_mode):
    ref = _loads(JaxFeaturizer, JaxDataConfig, case, inference_mode)
    got = _loads(SystemFeaturizer, DataConfig, case, inference_mode)
    for i, ((rf, rm), (gf, gm)) in enumerate(zip(ref, got)):
        what = f"{case} load {i}"
        assert_features_equal(rf, gf, what)
        assert set(rm) == set(gm), (what, sorted(set(rm) ^ set(gm)))
        for k in rm:
            if k == "ref_mol":
                a, b = rm[k], gm[k]
                np.testing.assert_array_equal(b.atomic_numbers, a.atomic_numbers)
                np.testing.assert_array_equal(b.charges, a.charges)
                assert b.bonds == a.bonds, what
                np.testing.assert_allclose(b.coords, a.coords, rtol=0, atol=1e-6)
            elif isinstance(rm[k], (list, str)):
                assert gm[k] == rm[k], (what, k)
            else:
                assert_features_equal({k: rm[k]}, {k: gm[k]}, f"{what} meta")
