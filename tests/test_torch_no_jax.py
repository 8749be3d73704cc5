"""The PyTorch port must run where JAX is not installed.

  * a static scan: no module of `physdock_tpu_torch/` (the confidence
    head, the pose corruption, the reference checkpoint import and the
    metrics log included), and not `chip_smoke.py` or the train-to-dock
    gate `scripts/torch_overfit_gate.py`, imports jax, jaxlib, flax, optax
    or physdock_tpu;
  * a subprocess whose `sys.meta_path` makes those imports raise docks two
    demo systems through `physdock_tpu_torch.cli.redocking.main` on the CPU
    (tiny crop, 2 steps; `dock_many` with the inline featurizer), then the
    same two through `dock_many` with the featurizer worker, whose
    `PYTHONPATH` starts with a shim where `jax` and `physdock_tpu` raise on
    import; the PDB and SDF it writes must parse;
  * the worker alone, under that shim with `torch` raising too, loads a
    demo system and serves a post request;
  * another screens two demo SMILES into the demo receptor through
    `physdock_tpu_torch.cli.screening.main`, batched, on the CPU.
"""

import ast
import glob
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "physdock_tpu")


def _port_sources():
    files = sorted(glob.glob(os.path.join(REPO, "physdock_tpu_torch", "**", "*.py"),
                             recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py"),
                    os.path.join(REPO, "scripts", "torch_overfit_gate.py")]


def test_port_sources_import_nothing_of_jax():
    offenders = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in BLOCKED:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert len(_port_sources()) > 20
    # the confidence slice's new modules are in the scan
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert {"physdock_tpu_torch/nn/confidence.py", "physdock_tpu_torch/train/corrupt.py",
            "physdock_tpu_torch/data/feat_worker.py", "physdock_tpu_torch/infer/relax.py",
            "physdock_tpu_torch/data/charges.py", "physdock_tpu_torch/data/system.py",
            "physdock_tpu_torch/data/parsers.py",
            "physdock_tpu_torch/cli/prepare_system.py",
            "physdock_tpu_torch/model/import_weights.py", "physdock_tpu_torch/train/metrics.py",
            "scripts/torch_overfit_gate.py"} <= scanned
    assert not offenders, offenders


DOCK = textwrap.dedent("""
    import importlib.abc, json, sys

    BLOCKED = {blocked!r}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())
    import torch
    torch.set_num_threads(2)
    from physdock_tpu_torch.cli import redocking

    demo = {repo!r} + "/demo/redocking"
    flags = [
        "--model_name", "toy", "--params", {repo!r} + "/_overfit/ema_params.npz",
        "--crop_size", "32", "--atom_crop_size", "256",
        "--msa_features_dir", demo + "/features/msa_features",
        "--uniprot_msa_features_dir", demo + "/features/uniprot_msa_features",
        "--steps", "2", "--max_rounds", "1", "--num_samples_per_round", "2",
        "--max_samples", "2", "--num_confs", "4", "--use_pocket", "--use_key_res",
        "--enable_physics_correction", "--enable_ranking", "--device", "cpu",
    ]
    res = redocking.main(["-f", {systems!r}, "-o", {out!r}, *flags])

    # the same two systems through dock_many with the worker
    from physdock_tpu_torch.cli.common import add_common_flags, build_pipeline
    from physdock_tpu_torch.data.feat_worker import FeaturizerWorker
    import argparse, glob
    p = argparse.ArgumentParser()
    add_common_flags(p)
    pipe = build_pipeline(p.parse_args(["-o", {out!r} + "_worker", *flags]))
    pipe.featurizer = FeaturizerWorker(pipe.config.data, msa_features_dir=demo + "/features/msa_features",
                                       uniprot_msa_features_dir=demo + "/features/uniprot_msa_features",
                                       inference_mode=True, seed=0)
    try:
        many = pipe.dock_many(sorted(glob.glob({systems!r} + "/*.pkl.gz")), {out!r} + "_worker")
    finally:
        pipe.close()
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("RESULT " + json.dumps(res))
    print("MANY " + json.dumps(many))
""")


def _shim(tmp_path, names=("jax", "physdock_tpu")):
    """A PYTHONPATH entry whose packages `names` raise on import, for
    processes the port starts itself (the featurizer worker)."""
    shim = tmp_path / "shim"
    for name in names:
        (shim / name).mkdir(parents=True)
        (shim / name / "__init__.py").write_text(
            f"raise ModuleNotFoundError('blocked import of {name}')\n")
    return str(shim)


def test_redock_runs_with_jax_blocked(tmp_path):
    out = str(tmp_path / "out")
    systems = tmp_path / "systems"
    systems.mkdir()
    for name in ("5SAK_ZRY_A_1", "5SD5_HWI_A_1"):
        os.symlink(os.path.join(REPO, "demo", "redocking", "Posebusters_subset",
                                f"{name}.pkl.gz"), systems / f"{name}.pkl.gz")
    code = DOCK.format(blocked=BLOCKED, repo=REPO, out=out, systems=str(systems))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_shim(tmp_path), REPO]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=150, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    results = json.loads(line[len("RESULT "):])
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MANY ")][-1]
    many = json.loads(line[len("MANY "):])
    assert [r["system_id"] for r in results] == ["5SAK_ZRY_A_1", "5SD5_HWI_A_1"]
    for i, (r, m) in enumerate(zip(results, many)):
        assert r["rounds"] == 1 and np.all(np.isfinite(r["top5_rmsd"]))
        assert m["system_id"] == r["system_id"] and m["rank_order"] == r["rank_order"]
        np.testing.assert_allclose(m["top5_rmsd"], r["top5_rmsd"], atol=1e-4, rtol=0)
        # the first system is featurized in process, the second by the worker
        assert ("load_detail" in m["timings"]) == (i > 0) and "load_detail" not in r["timings"]
    res = results[1]

    from physdock_tpu.data.mol import read_sdf
    from physdock_tpu.data.parsers import parse_pdb

    sysdir = os.path.join(out, "5SD5_HWI_A_1")
    mol = read_sdf(os.path.join(sysdir, "ligand_rank0.sdf"))
    assert mol.num_atoms > 0 and np.all(np.isfinite(mol.coords))
    with open(os.path.join(sysdir, "pred_rank0.pdb")) as f:
        pdb = parse_pdb(f.read())
    assert len(pdb) > 0


SCREEN = textwrap.dedent("""
    import importlib.abc, json, sys

    BLOCKED = {blocked!r}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())
    import torch
    torch.set_num_threads(2)
    from physdock_tpu_torch.cli import screening

    demo = {repo!r} + "/demo/screening"
    with open(demo + "/demo_db.txt") as f:
        smiles = [ln.strip() for ln in f if ln.strip()][:2]
    with open({out!r} + ".txt", "w") as f:
        f.write(chr(10).join(smiles))
    res = screening.main([
        "-i", demo + "/6kzd.pkl.gz", "-s", {out!r} + ".txt", "-o", {out!r},
        "--model_name", "toy", "--params", {repo!r} + "/_overfit/ema_params.npz",
        "--crop_size", "64", "--atom_crop_size", "512",
        "--msa_features_dir", demo + "/features/msa_features",
        "--uniprot_msa_features_dir", demo + "/features/uniprot_msa_features",
        "--steps", "2", "--max_rounds", "1", "--num_samples_per_round", "2",
        "--max_samples", "2", "--num_confs", "4", "--use_pocket", "--use_key_res",
        "--enable_physics_correction", "--vs_batch_size", "2", "--device", "cpu",
    ])
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("RESULT " + json.dumps(res))
""")


def test_screen_runs_with_jax_blocked(tmp_path):
    out = str(tmp_path / "out")
    code = SCREEN.format(blocked=BLOCKED, repo=REPO, out=out)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    res = json.loads(line[len("RESULT "):])
    assert len(res) == 2
    for r in res:
        assert "error" not in r and r["num_poses"] == 2 and r["vs_batch_size"] == 2
    md5 = json.load(open(os.path.join(out, "smiles_to_md5.json")))
    from physdock_tpu.data.mol import read_sdf

    mol = read_sdf(os.path.join(out, md5[res[0]["smiles"]], "ligand_rank0.sdf"))
    assert mol.num_atoms > 0 and np.all(np.isfinite(mol.coords))


def test_worker_runs_with_jax_blocked(tmp_path, monkeypatch):
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feat_worker import FeaturizerWorker

    # the worker is host work: it runs without torch as well
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [_shim(tmp_path, ("jax", "physdock_tpu", "torch")), REPO]))
    monkeypatch.chdir(tmp_path)  # a `-m` process puts its cwd first on sys.path
    demo = os.path.join(REPO, "demo", "redocking")
    cfg = PhysDockConfig.named("toy", crop_size=32, atom_crop_size=256, infer_use_pocket=True)
    w = FeaturizerWorker(cfg.data, msa_features_dir=demo + "/features/msa_features",
                         uniprot_msa_features_dir=demo + "/features/uniprot_msa_features",
                         inference_mode=True, seed=0)
    try:
        feats, meta, confs = w.load(
            os.path.join(demo, "Posebusters_subset", "5SD5_HWI_A_1.pkl.gz"),
            num_msa_rounds=1, num_confs=2, compact=True)
        assert meta["system_id"] == "5SD5_HWI_A_1" and confs.shape[0] == 2
        rng = np.random.default_rng(0)
        n_atoms = len(feats["a_mask"])
        poses = feats["x_gt"][None] + rng.normal(size=(2, n_atoms, 3)).astype(np.float32)
        lig_idx = np.asarray(meta["ligand_atom_idx"])
        aligned, order, rmsds = w.result(w.submit_post(poses, dict(
            x_gt=np.asarray(feats["x_gt"]), lig_idx=lig_idx,
            centre_ids=feats["token_id_to_centre_atom_id"], pocket_res=feats["pocket_res_feat"],
            is_protein=feats["is_protein"], s_mask=feats["s_mask"], a_mask=feats["a_mask"],
            enable_ranking=True, compute_rmsd=True)))
        assert aligned.shape == poses.shape and sorted(order) == [0, 1]
        assert np.all(np.isfinite(rmsds))
    finally:
        w.stop()


def test_entry_points_never_fall_back_to_the_cpu(tmp_path):
    from physdock_tpu_torch.cli import redocking, screening
    from physdock_tpu_torch.infer.pipeline import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    # system preparation is host work: it never touches a device
    from physdock_tpu_torch.cli import prepare_system

    prep = os.path.join(REPO, "demo", "system_preparation")
    pkl = prepare_system.main(["-r", os.path.join(prep, "receptor.pdb"),
                               "-l", os.path.join(prep, "EJQ.sdf"), "-o", str(tmp_path)])
    assert os.path.exists(pkl) and not torch.cuda.is_initialized()
    # the featurizer worker cannot see the card, and never loads libcuda
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feat_worker import FeaturizerWorker

    w = FeaturizerWorker(PhysDockConfig.named("toy").data, inference_mode=True, seed=0)
    try:
        _, meta, _ = w.load(pkl, num_msa_rounds=1)
        assert meta["system_id"]
        with open(f"/proc/{w.proc.pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
        assert b"CUDA_VISIBLE_DEVICES=" in env
        with open(f"/proc/{w.proc.pid}/maps") as f:
            assert "libcuda.so" not in f.read()
    finally:
        w.stop()
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        redocking.main(["-i", os.path.join(REPO, "demo", "redocking", "Posebusters_subset",
                                           "5SD5_HWI_A_1.pkl.gz"), "-o", "/nonexistent",
                        "--model_name", "toy"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        screening.main(["-i", os.path.join(REPO, "demo", "screening", "6kzd.pkl.gz"),
                        "-s", os.path.join(REPO, "demo", "screening", "demo_db.txt"),
                        "-o", "/nonexistent", "--model_name", "toy"])
