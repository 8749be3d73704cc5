"""The PyTorch port must run where JAX is not installed.

  * a static scan: no module of `physdock_tpu_torch/`, and not
    `chip_smoke.py`, imports jax, jaxlib, flax, optax or physdock_tpu;
  * a subprocess whose `sys.meta_path` makes those imports raise docks one
    demo system through `physdock_tpu_torch.cli.redocking.main` on the CPU
    (tiny crop, 2 steps); the PDB and SDF it writes must parse;
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
    return files + [os.path.join(REPO, "chip_smoke.py")]


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
    res = redocking.main([
        "-i", demo + "/Posebusters_subset/5SD5_HWI_A_1.pkl.gz", "-o", {out!r},
        "--model_name", "toy", "--params", {repo!r} + "/_overfit/ema_params.npz",
        "--crop_size", "32", "--atom_crop_size", "256",
        "--msa_features_dir", demo + "/features/msa_features",
        "--uniprot_msa_features_dir", demo + "/features/uniprot_msa_features",
        "--steps", "2", "--max_rounds", "1", "--num_samples_per_round", "2",
        "--max_samples", "2", "--num_confs", "4", "--use_pocket", "--use_key_res",
        "--enable_physics_correction", "--enable_ranking", "--device", "cpu",
    ])
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("RESULT " + json.dumps(res))
""")


def test_redock_runs_with_jax_blocked(tmp_path):
    out = str(tmp_path / "out")
    code = DOCK.format(blocked=BLOCKED, repo=REPO, out=out)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=90, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    (res,) = json.loads(line[len("RESULT "):])
    assert res["system_id"] == "5SD5_HWI_A_1" and res["rounds"] == 1
    assert np.all(np.isfinite(res["top5_rmsd"]))

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


def test_entry_points_never_fall_back_to_the_cpu():
    from physdock_tpu_torch.cli import redocking, screening
    from physdock_tpu_torch.infer.pipeline import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
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
