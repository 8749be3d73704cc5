"""A crop that holds no protein token has no pocket frame, in either package.

5SIS_JSM_A_1's ligand has 32 atoms, so at crop 32/256 the featurizer
keeps only ligand tokens: `postprocess_poses` finds no pocket or protein
CA, aligns with zero weights and gets non-finite poses.  The JAX package
then fails in its KMeans ranking (its redocking CLI reports the system
and goes on); the port fails in the SVD of the same alignment (its CLI
ends the run with the error).  At crop 64/512 the crop holds protein and
both packages align to finite poses, the same within 1e-4 A.
"""

import os

import numpy as np
import pytest

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.feature_loader import SystemFeaturizer as JaxFeaturizer
from physdock_tpu.infer import ranking as jranking
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from physdock_tpu_torch.infer import ranking

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "redocking")
SYSTEM = os.path.join(DEMO, "Posebusters_subset", "5SIS_JSM_A_1.pkl.gz")


def _load(featurizer_cls, config_cls, crop, atom_crop):
    cfg = config_cls.named("toy", crop_size=crop, atom_crop_size=atom_crop,
                           infer_use_pocket=True, infer_use_key_res=True)
    fz = featurizer_cls(cfg.data,
                        msa_features_dir=os.path.join(DEMO, "features", "msa_features"),
                        uniprot_msa_features_dir=os.path.join(DEMO, "features",
                                                              "uniprot_msa_features"),
                        inference_mode=True, seed=0)
    return fz.load(SYSTEM, num_msa_rounds=1)


def _postprocess(module, feats, meta, poses):
    return module.postprocess_poses(
        poses, np.asarray(feats["x_gt"]),
        lig_idx=np.asarray(meta["ligand_atom_idx"]),
        centre_ids=np.asarray(feats["token_id_to_centre_atom_id"]),
        pocket_res=np.asarray(feats["pocket_res_feat"]),
        is_protein=np.asarray(feats["is_protein"]),
        s_mask=np.asarray(feats["s_mask"]),
        a_mask=np.asarray(feats["a_mask"]),
        enable_ranking=True, compute_rmsd=True)


@pytest.mark.parametrize("crop,atom_crop", [(32, 256), (64, 512)])
def test_pocket_frame_needs_protein_in_the_crop_in_both_packages(crop, atom_crop):
    feats, meta = _load(SystemFeaturizer, PhysDockConfig, crop, atom_crop)
    jfeats, jmeta = _load(JaxFeaturizer, JaxConfig, crop, atom_crop)
    for k in ("is_protein", "s_mask", "a_mask", "pocket_res_feat", "x_gt"):
        np.testing.assert_array_equal(np.asarray(feats[k]), np.asarray(jfeats[k]), err_msg=k)
    n_protein = int((np.asarray(feats["is_protein"]) * np.asarray(feats["s_mask"])).sum())
    x_gt = np.asarray(feats["x_gt"], np.float32)
    poses = x_gt[None] + np.random.default_rng(0).normal(
        0.0, 0.5, (2,) + x_gt.shape).astype(np.float32)
    if crop == 32:
        assert len(meta["ligand_atom_idx"]) == 32 and n_protein == 0
        with pytest.raises(RuntimeError, match="non-finite"):
            _postprocess(ranking, feats, meta, poses)
        with pytest.raises(ValueError, match="NaN"):
            _postprocess(jranking, jfeats, jmeta, poses)
        return
    assert n_protein > 0
    aligned, order, rmsds = _postprocess(ranking, feats, meta, poses)
    jaligned, jorder, jrmsds = _postprocess(jranking, jfeats, jmeta, poses)
    assert np.isfinite(aligned).all() and order == jorder
    np.testing.assert_allclose(aligned, np.asarray(jaligned), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rmsds, jrmsds, rtol=0, atol=1e-4)
