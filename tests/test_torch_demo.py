"""The port's self-contained demo builder (`physdock_tpu_torch/data/demo.py`)
against the JAX package's, and a tiny CPU redock of what it builds.

Exact: the receptor PDB and the ligand SDF byte for byte, the helix and
groove geometry, and the prepared system pkl key by key and array by
array, for two seeds and a second ligand. The redock (the committed toy
weights, crop 32/256, 2 sampler steps, one round of 2 poses, 4
conformers, physics correction on; ranking, whose KMeans imports
scikit-learn, is left to the card's demo phase) writes a PDB with chains
A and B and an 11-atom ligand SDF, with finite RMSDs.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from physdock_tpu.data import demo as jdemo
from physdock_tpu_torch.data import demo
from physdock_tpu_torch.utils.io import load_pkl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")


def _same(a, b, path="pkl"):
    """Equal content; an object of a package class (the ligand's Molecule)
    equals its counterpart of the other package field by field."""
    assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
    if hasattr(a, "__dict__") and not isinstance(a, np.ndarray):
        _same(vars(a), vars(b), f"{path}.{type(a).__name__}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_receptor_geometry_matches_jax():
    pdb, frame, xyz = demo.make_demo_receptor()
    jpdb, jframe, jxyz = jdemo.make_demo_receptor()
    assert pdb == jpdb
    np.testing.assert_array_equal(frame, jframe)
    np.testing.assert_array_equal(xyz, jxyz)


@pytest.fixture(scope="module")
def default_demo(tmp_path_factory):
    """The default demo complex of both packages (the port's, the JAX one's)."""
    root = tmp_path_factory.mktemp("demo")
    yield (demo.make_demo_complex(str(root / "port")),
           jdemo.make_demo_complex(str(root / "jax")))
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("kw", [dict(), dict(seed=3, name="SYSB",
                                              smiles="CC(=O)Oc1ccccc1C(=O)O")])
def test_demo_complex_matches_jax_byte_for_byte(default_demo, tmp_path, kw):
    if kw:
        pkl = demo.make_demo_complex(str(tmp_path / "port"), **kw)
        jpkl = jdemo.make_demo_complex(str(tmp_path / "jax"), **kw)
    else:
        pkl, jpkl = default_demo
    pdir, jdir = os.path.dirname(pkl), os.path.dirname(jpkl)
    assert os.path.basename(pkl) == os.path.basename(jpkl)
    name = kw.get("name", "DEMO")
    for f in (f"{name}_receptor.pdb", f"{name}_ligand.sdf"):
        with open(os.path.join(pdir, f), "rb") as a, open(os.path.join(jdir, f), "rb") as b:
            assert a.read() == b.read(), f
    _same(load_pkl(pkl), load_pkl(jpkl))


def test_tiny_cpu_redock_of_the_demo(default_demo, tmp_path):
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.data.mol import read_sdf
    from physdock_tpu_torch.data.parsers import parse_pdb
    from physdock_tpu_torch.infer.pipeline import DockingPipeline, SamplerSettings
    from physdock_tpu_torch.model.physdock import PhysDock
    from physdock_tpu_torch.model.weights import load_jax_params

    torch.set_num_threads(4)
    pkl = default_demo[0]
    cfg = PhysDockConfig.named("toy", crop_size=32, atom_crop_size=256)
    # every parameter comes from the file (load_jax_params is strict): no
    # random init to pay for first
    with torch.device("meta"):
        model = PhysDock(cfg.model)
    model = model.to_empty(device="cpu")
    load_jax_params(model, NPZ)
    pipe = DockingPipeline(
        cfg, model, SystemFeaturizer(cfg.data, seed=0),
        SamplerSettings(max_samples=2, num_samples_per_round=2, max_rounds=1, steps=2,
                        enable_physics_correction=True, num_confs=4, enable_ranking=False),
        device="cpu")
    out = str(tmp_path / "out")
    res = pipe.dock(pkl, out)
    assert res["num_poses"] == 2
    assert all(np.isfinite(r) for r in res["top5_rmsd"])
    chains = parse_pdb(os.path.join(out, "pred_rank0.pdb"))
    assert "A" in chains and "B" in chains
    assert read_sdf(os.path.join(out, "ligand_rank0.sdf")).num_atoms == 11
