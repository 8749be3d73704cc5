"""Reference `params.pt` import of the PyTorch port
(`physdock_tpu_torch/model/import_weights.py`) against the JAX package's
(`physdock_tpu/model/import_weights.py`), and its two entry points.

No released checkpoint is in the repository, so the files are built here
from the committed weights (`_overfit/ema_params.npz` without the
confidence head, `_confidence/ema_params_conf.npz` with it) in the
reference's layout: torch names, `Linear.weight` [out, in], one tensor per
block, the time embedder nested as `time_embedder.timestep_embedder.
linear_{1,2}`, each key prefixed as the reference writes it: a flat
release file (`model.`), a Uni-Core training checkpoint (`{"ema":
{"params": ...}}`, `model.`), and a compiled module's (`_orig_mod.model.`).

  * the port's `import_checkpoint` equals the JAX `import_checkpoint`
    carried through the weight bridge bit for bit (fp32), in every layout,
    with and without the head, and loads into the port's model with every
    key used once (a head file into a model without the head leaves the
    head's keys unused and counted);
  * a missing key and an unexpected key each raise, and a Uni-Core file
    without EMA params raises the JAX package's error text;
  * the redocking CLI gives the same poses, bit for bit, from `--params
    x.pt` as from `--params x.npz` (the CPU smoke dock's size: crop
    32/256, 2 steps, 1 round of 2 poses);
  * the train CLI: `--init_from_ckpt x.pt` of a reference file starts from
    its weights at step 0; a train state of the port's own trainer is
    resumed in full (step, parameters, Adam moments), and `load_model`
    takes its EMA.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from physdock_tpu.model.import_weights import import_checkpoint as jax_import_checkpoint
from physdock_tpu.model.import_weights import load_torch_state_dict as jax_load_torch
from physdock_tpu_torch.cli import redocking
from physdock_tpu_torch.cli.common import load_model
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model import import_weights
from physdock_tpu_torch.model.weights import jax_flat_to_state_dict
from physdock_tpu_torch.train import checkpoint as ckpt_lib
from physdock_tpu_torch.train import optim, train
from physdock_tpu_torch.train.step import init_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
CONF_NPZ = os.path.join(REPO, "_confidence", "ema_params_conf.npz")
SYSTEMS = os.path.join(REPO, "demo", "redocking", "Posebusters_subset")
FEATS = os.path.join(REPO, "demo", "redocking", "features")
LAYOUTS = ("release", "unicore", "compiled")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's tmp_path, removed when the test ends: a train state or a
    checkpoint written here takes hundreds of MB, and pytest keeps the
    directories of its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def reference_layout(sd, layout):
    """A port state_dict as the reference torch model saves it."""
    named = {k.replace("time_embedder.linear_", "time_embedder.timestep_embedder.linear_"): v
             for k, v in sd.items()}
    if layout == "compiled":
        return {"_orig_mod.model." + k: v for k, v in named.items()}
    flat = {"model." + k: v for k, v in named.items()}
    if layout == "unicore":
        return {"ema": {"params": flat}, "optimizer_history": [{"num_updates": 7}]}
    return flat


@pytest.fixture(scope="module")
def ref_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_pt")
    files = {}
    for head, npz in ((False, NPZ), (True, CONF_NPZ)):
        sd = ckpt_lib.load_params_npz(npz)
        for layout in LAYOUTS:
            path = str(root / f"{layout}{'_head' if head else ''}.pt")
            torch.save(reference_layout(sd, layout), path)
            files[(layout, head)] = (path, sd)
    yield files
    shutil.rmtree(root, ignore_errors=True)  # six reference files, ~650 MB


def _via_jax(path):
    tree = jax_import_checkpoint(path)
    return jax_flat_to_state_dict({"/".join(k): np.asarray(v)
                                   for k, v in flatten_dict(tree).items()})


@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_import_equals_jax_import_through_the_bridge(ref_files, layout, head):
    path, sd = ref_files[(layout, head)]
    got = import_weights.import_checkpoint(path)
    ref = _via_jax(path)
    assert set(got) == set(ref) == set(sd)
    for n, t in ref.items():
        assert got[n].dtype == torch.float32 and torch.equal(got[n], t), n
        assert torch.equal(got[n], sd[n]), n
    missing, unexpected, mismatched = import_weights.audit_conversion(
        got, load_model(None, PhysDockConfig.named("toy"), with_confidence=head).state_dict())
    assert (missing, unexpected, mismatched) == ([], [], [])

    for with_head in (False, True) if head else (False,):
        model = load_model(None, PhysDockConfig.named("toy"), with_confidence=with_head)
        counts = import_weights.load_weights(model, path)
        n_head = sum(k.startswith("confidence_module.") for k in sd)
        assert counts["unused_head_keys"] == (n_head if head and not with_head else 0)
        assert counts["keys"] + counts["unused_head_keys"] == len(sd)
        for n, t in model.state_dict().items():
            assert torch.equal(t, sd[n]), n


def test_missing_and_unexpected_keys_raise(ref_files, tmp_path):
    path, sd = ref_files[("release", False)]
    ref = torch.load(path)
    short = dict(ref)
    short.pop("model.dit.time_embedder.timestep_embedder.linear_2.bias")
    extra = dict(ref, **{"model.dit.not_a_module.weight": torch.zeros(3)})
    for name, content in (("short", short), ("extra", extra)):
        p = str(tmp_path / f"{name}.pt")
        torch.save(content, p)
        model = load_model(None, PhysDockConfig.named("toy"))
        with pytest.raises(KeyError, match="weight bridge mismatch"):
            import_weights.load_weights(model, p)
    audit = import_weights.audit_conversion(
        import_weights.import_checkpoint(torch.load(str(tmp_path / "extra.pt"))),
        {k: v[:1] if k == "dit.time_embedder.linear_1.bias" else v for k, v in sd.items()})
    assert audit[0] == [] and audit[1] == ["dit.not_a_module.weight"]
    assert [m[0] for m in audit[2]] == ["dit.time_embedder.linear_1.bias"]


def test_unicore_without_ema_params_raises_the_jax_text(tmp_path):
    p = str(tmp_path / "bad.pt")
    torch.save({"ema": {"decay": 0.999}, "optimizer_history": []}, p)
    with pytest.raises(ValueError) as ours:
        import_weights.load_torch_state_dict(p)
    with pytest.raises(ValueError) as theirs:
        jax_load_torch(p)
    assert str(ours.value) == str(theirs.value)


def _dock(params, out):
    return redocking.main([
        "-i", os.path.join(SYSTEMS, "5SD5_HWI_A_1.pkl.gz"), "-o", out, "--params", params,
        "--model_name", "toy", "--crop_size", "32", "--atom_crop_size", "256",
        "--msa_features_dir", os.path.join(FEATS, "msa_features"),
        "--uniprot_msa_features_dir", os.path.join(FEATS, "uniprot_msa_features"),
        "--steps", "2", "--max_rounds", "1", "--num_samples_per_round", "2", "--max_samples",
        "2", "--num_confs", "4", "--use_pocket", "--use_key_res",
        "--enable_physics_correction", "--enable_ranking", "--device", "cpu"])


def test_cli_params_pt_docks_as_the_npz(ref_files, tmp_path):
    path, _ = ref_files[("unicore", False)]
    a = _dock(NPZ, str(tmp_path / "npz"))
    b = _dock(path, str(tmp_path / "pt"))
    assert len(a) == len(b) == 1
    assert a[0]["all_rmsd"] == b[0]["all_rmsd"] and a[0]["top5_rmsd"] == b[0]["top5_rmsd"]
    with open(tmp_path / "npz" / "summary.json") as f:
        sa = json.load(f)
    with open(tmp_path / "pt" / "summary.json") as f:
        sb = json.load(f)
    assert [r["top5_rmsd"] for r in sa] == [r["top5_rmsd"] for r in sb]


def _train(tmp_path, init, out="ck"):
    data = tmp_path / "data" / "train_val"
    data.mkdir(parents=True, exist_ok=True)
    if not os.listdir(data):
        os.symlink(os.path.join(SYSTEMS, "5SD5_HWI_A_1.pkl.gz"), data / "5SD5_HWI_A_1.pkl.gz")
    return train.main([
        "--dataset_dir", str(tmp_path / "data"), "-o", str(tmp_path / out), "--model_name",
        "toy", "--crop_size", "32", "--atom_crop_size", "256", "--num_augmentation_sample",
        "2", "--total_steps", "0", "--init_from_ckpt", init, "--device", "cpu"])


def test_train_init_from_reference_pt_starts_at_step_0(ref_files, tmp_path):
    path, sd = ref_files[("compiled", False)]
    res = _train(tmp_path, path)
    assert res["start_step"] == 0 and res["state"].step == 0
    assert res["state"].opt_state.count == 0
    for n, t in res["model"].state_dict().items():
        assert torch.equal(t, sd[n]), n
        assert torch.equal(res["state"].ema_params[n], sd[n]), n
        assert float(res["state"].opt_state.mu[n].abs().max()) == 0.0, n


def test_train_state_pt_resumes_in_full_and_loads_its_ema(tmp_path):
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=2)
    model = load_model(None, cfg, seed=3)
    state = init_train_state(model, optim.make_optimizer())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in state.params.items():
            state.opt_state.mu[n].normal_(generator=gen)
            state.ema_params[n].add_(1.0)
    state.step, state.opt_state.count = 5, 5
    path = ckpt_lib.save_train_state(str(tmp_path / "saved"), state)
    assert import_weights.is_train_state(import_weights.read_checkpoint(path))

    res = _train(tmp_path, path)
    assert res["start_step"] == 5 and res["state"].step == 5
    assert res["state"].opt_state.count == 5
    for n, p in state.params.items():
        assert torch.equal(res["state"].params[n].detach(), p.detach()), n
        assert torch.equal(res["state"].opt_state.mu[n], state.opt_state.mu[n]), n
        assert torch.equal(res["state"].ema_params[n], state.ema_params[n]), n

    ema_model = load_model(path, cfg)
    for n, t in ema_model.state_dict().items():
        assert torch.equal(t, state.ema_params[n]), n
