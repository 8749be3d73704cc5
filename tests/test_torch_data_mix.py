"""The training data mix and the metrics log of the PyTorch port against
the JAX package.

  * `train/sampler.py::MixedBatchSampler`: 12 draws (seed 0: complexes,
    ligand-only and protein-only batches all among them) from the 4 demo
    redocking systems and the demo screening SMILES, featurized in training
    mode at crop 64/512 with the same seeds in both packages: the same
    kinds of load in the same order (recorded at the featurizer), and
    every feature key equal: integer and boolean arrays exactly, floats
    within 1e-6 abs. The protein-only draw of 5SIS_JSM_A_1 crops in a
    modified cysteine (CME) that the CCD library lacks, and both packages
    raise the same KeyError there (their training loops retry such a
    system, `train/sampler.py::batch_iterator`): that draw must give the
    same error text;
  * `train/metrics.py::MetricsLogger`: the same scalars logged at the same
    steps write the same JSONL lines, `time` excepted, flushed at the same
    points.
"""

import glob
import json
import os

import numpy as np

from physdock_tpu.config import DataConfig as JaxDataConfig
from physdock_tpu.data.feature_loader import SystemFeaturizer as JaxFeaturizer
from physdock_tpu.train.metrics import MetricsLogger as JaxMetricsLogger
from physdock_tpu.train.sampler import MixedBatchSampler as JaxMixed
from physdock_tpu.train.sampler import WeightedSystemSampler as JaxWeighted
from physdock_tpu_torch.config import DataConfig
from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from physdock_tpu_torch.train.metrics import MetricsLogger
from physdock_tpu_torch.train.sampler import MixedBatchSampler, WeightedSystemSampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = sorted(glob.glob(os.path.join(REPO, "demo", "redocking", "Posebusters_subset",
                                        "*.pkl.gz")))
FEATS = os.path.join(REPO, "demo", "redocking", "features")
with open(os.path.join(REPO, "demo", "screening", "demo_db.txt")) as f:
    SMILES = [line.strip() for line in f if line.strip()]
N_DRAWS, FLOAT_ATOL = 12, 1e-6


def assert_features_equal(ref, got, what):
    assert set(ref) == set(got), (what, sorted(set(ref) ^ set(got)))
    for k in ref:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert r.shape == g.shape and r.dtype == g.dtype, (what, k, r.shape, g.shape)
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=0, atol=FLOAT_ATOL, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{what} {k}")


def _recording(featurizer, kinds):
    load = featurizer.load

    def recorded(system, **kw):
        if kw.get("remove_receptor"):
            kinds.append(("ligand", kw["ligand_mol"].num_atoms))
        else:
            kinds.append(("protein" if kw.get("remove_ligand") else "complex",
                          os.path.basename(system)))
        return load(system, **kw)

    featurizer.load = recorded
    return featurizer


def _draws(mixed_cls, weighted_cls, featurizer_cls, cfg):
    kinds = []
    fz = _recording(featurizer_cls(cfg, msa_features_dir=f"{FEATS}/msa_features",
                                   uniprot_msa_features_dir=f"{FEATS}/uniprot_msa_features",
                                   inference_mode=False, seed=0), kinds)
    sampler = mixed_cls(weighted_cls(SYSTEMS, seed=0), fz, SMILES, seed=0)
    draws = []
    for _ in range(N_DRAWS):
        try:
            draws.append(sampler.sample())
        except KeyError as e:  # a residue the CCD library lacks, in both packages
            draws.append(str(e))
    return draws, kinds


def test_mixed_batch_sampler_matches_jax_draw_for_draw():
    ref, ref_kinds = _draws(JaxMixed, JaxWeighted, JaxFeaturizer,
                            JaxDataConfig(crop_size=64, atom_crop_size=512))
    got, kinds = _draws(MixedBatchSampler, WeightedSystemSampler, SystemFeaturizer,
                        DataConfig(crop_size=64, atom_crop_size=512))
    assert kinds == ref_kinds
    assert {k for k, _ in kinds} == {"complex", "protein", "ligand"}, kinds
    for i, (r, g) in enumerate(zip(ref, got)):
        if isinstance(r, str) or isinstance(g, str):
            assert g == r, (i, kinds[i])
        else:
            assert_features_equal(r, g, f"draw {i} {kinds[i]}")
    assert sum(isinstance(g, dict) for g in got) >= N_DRAWS - 1


def test_metrics_logger_writes_the_jax_lines(tmp_path):
    rng = np.random.default_rng(0)
    rows = [(step, {"loss": float(rng.normal()), "weighted_mse_loss": float(rng.random()),
                    "distogram_loss": np.float32(rng.random())}) for step in range(1, 6)]
    lines = {}
    for name, cls in (("jax", JaxMetricsLogger), ("port", MetricsLogger)):
        logger = cls(str(tmp_path / name), flush_every=2)
        flushed = []
        for step, scalars in rows:
            logger.log(step, scalars)
            with open(logger.path) as f:
                flushed.append(len(f.readlines()))
        logger.close()
        with open(logger.path) as f:
            lines[name] = [json.loads(line) for line in f]
        lines[name + "_flushed"] = flushed
        assert os.path.basename(logger.path) == "scalars.jsonl"
    for rec in lines["jax"] + lines["port"]:
        assert isinstance(rec.pop("time"), float)
    assert lines["port"] == lines["jax"] and len(lines["port"]) == len(rows)
    assert lines["port_flushed"] == lines["jax_flushed"] == [0, 2, 2, 4, 4]
