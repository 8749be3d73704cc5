"""Multi-system redocking in the PyTorch port: the featurizer worker,
`DockingPipeline.dock_many` (prefetched and batched) and the redocking
CLI's per-system robustness, on the CPU at crop 32/256, 2 steps, 1 round
(the worker and the pipeline are the port's; each mirrors
tests/test_feat_worker.py of the JAX package):

  * the worker's features and conformer bank equal the inline
    featurizer's; an error in the worker surfaces and the worker goes on;
    an abandoned request is never paired with a later system; a cache hit
    equals the cold load;
  * the worker's code run in process (`load_here`) equals the worker's
    load and shares its disk cache; the process starts at the first
    submit, never for `load_here`;
  * the worker as a pool of 1 and 3 processes: its loads equal
    `load_here`'s bit for bit (features, per-round MSA, conformer bank)
    and come back in submission order, request i from process i mod n;
    a failing system raises in its own place and the later results still
    pair with their systems; `stop` ends every process; the pool's size
    leaves two cores to the card's process;
  * `dock_many` through the worker equals sequential `dock` (rank order
    equal, top-5 RMSD within 1e-4 A): the first system featurized in
    process, the second by the worker (its receive timings in the
    result), the post-processing of both done in the worker;
    `batch_size=2` gives well-formed results from one sampler pass, with
    the loads' fan-out and overlap in its timings; `batch_size=4` through
    the pool gives the poses of in-process loads;
  * `_dock_many_batched`'s group (2 systems re-padded to one bucket, with
    the GT-conformer ablation's `gt_ligs`) equals bit for bit what the JAX
    package's `_dock_many_batched` builds from the same files, and each
    system docked alone at the padded bucket with its slice of the
    group's noise lands within 1e-4 A of its slot in the batched pass;
  * the CLI: a directory with a system that fails (5SIS_JSM_A_1 at crop
    32/256) and one that docks gives one {"system_id", "error"} entry, one
    docked system and summary.json; an error naming CUDA ends the run;
    `--align_mode` is accepted.
"""

import json
import os

import numpy as np
import pytest
import torch

from physdock_tpu_torch.cli import redocking
from physdock_tpu_torch.cli.common import load_model
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data import feat_worker
from physdock_tpu_torch.data.feat_worker import FeaturizerWorker
from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from physdock_tpu_torch.infer.pipeline import DockingPipeline, SamplerSettings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo", "redocking")
SYSTEMS = os.path.join(DEMO, "Posebusters_subset")
PKL = os.path.join(SYSTEMS, "5SAK_ZRY_A_1.pkl.gz")
PKL2 = os.path.join(SYSTEMS, "5SD5_HWI_A_1.pkl.gz")
PKL3 = os.path.join(SYSTEMS, "5SB2_1K2_A_1.pkl.gz")
PKL4 = os.path.join(SYSTEMS, "5SIS_JSM_A_1.pkl.gz")
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
FZ = dict(msa_features_dir=f"{DEMO}/features/msa_features",
          uniprot_msa_features_dir=f"{DEMO}/features/uniprot_msa_features",
          inference_mode=True, seed=0)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg():
    return PhysDockConfig.named("toy", crop_size=32, atom_crop_size=256,
                                infer_use_pocket=True, infer_use_key_res=True)


@pytest.fixture(scope="module")
def worker(cfg):
    w = FeaturizerWorker(cfg.data, **FZ)
    yield w
    w.stop()


@pytest.fixture(scope="module")
def model(cfg):
    return load_model(NPZ, cfg)


def _settings(**kw):
    return SamplerSettings(**{**dict(max_samples=2, num_samples_per_round=2, max_rounds=1,
                                     steps=2, enable_physics_correction=True, num_confs=4,
                                     enable_ranking=True, seed=0), **kw})


def test_worker_matches_inline(cfg, worker):
    from physdock_tpu_torch.data.embed import generate_conformers

    f_in, m_in = SystemFeaturizer(cfg.data, **FZ).load(PKL, num_msa_rounds=2)
    f_wk, m_wk, confs = worker.load(PKL, num_msa_rounds=2, num_confs=4)
    assert set(f_in) == set(f_wk)
    for k in f_in:
        np.testing.assert_array_equal(np.asarray(f_in[k]), np.asarray(f_wk[k]), err_msg=k)
    assert m_wk["system_id"] == m_in["system_id"]
    np.testing.assert_array_equal(m_wk["ligand_atom_idx"], m_in["ligand_atom_idx"])
    for a, b in zip(m_wk["batch_msa_feat"], m_in["batch_msa_feat"]):
        np.testing.assert_array_equal(a, b)
    mol = m_in["ref_mol"]
    ref = generate_conformers(mol, num_confs=4, base_coords=mol.coords,
                              rng=np.random.default_rng(0))
    np.testing.assert_array_equal(confs, ref)


def test_worker_compact_matches_compacted_inline(cfg, worker):
    from physdock_tpu_torch.model.compact import compact_batch_np, compact_msa_np

    f_in, m_in = SystemFeaturizer(cfg.data, **FZ).load(PKL2, num_msa_rounds=2)
    f_wk, m_wk, confs = worker.load(PKL2, num_msa_rounds=2, compact=True)
    want = compact_batch_np(f_in)
    assert confs is None and set(f_wk) == set(want)
    for k in want:
        np.testing.assert_array_equal(f_wk[k], want[k], err_msg=k)
    for a, b in zip(m_wk["batch_msa_feat_c"], m_in["batch_msa_feat"]):
        for k, v in compact_msa_np(b).items():
            np.testing.assert_array_equal(a[k], v)


def test_worker_error_surfaces(cfg, worker):
    with pytest.raises(RuntimeError, match="featurizer worker failed"):
        worker.load("/nonexistent/system.pkl.gz")
    # the worker survives an error and keeps serving
    f, m, _ = worker.load(PKL, num_msa_rounds=1)
    assert "s_mask" in f and m["system_id"] == "5SAK_ZRY_A_1"


def test_abandoned_request_never_pairs_with_wrong_system(cfg):
    w = FeaturizerWorker(cfg.data, **FZ)
    try:
        # a dock_many that died after queueing a load it never drained
        w.submit(PKL, num_msa_rounds=1)
        _, m, _ = w.load(PKL2, num_msa_rounds=1)
        assert m["system_id"] == "5SD5_HWI_A_1"
        with pytest.raises(RuntimeError, match="no pending request"):
            w.result()
        # the same through respawn(): a clean process, request ids reset
        w.submit(PKL, num_msa_rounds=1)
        w.respawn()
        _, m, _ = w.load(PKL2, num_msa_rounds=1)
        assert m["system_id"] == "5SD5_HWI_A_1"
    finally:
        w.stop()
    assert all(p.popen.poll() is not None for p in w.procs)


def test_feat_cache_hit_matches_cold(cfg, tmp_path):
    w = FeaturizerWorker(cfg.data, cache_dir=str(tmp_path), **FZ)
    try:
        f_cold, m_cold, c_cold = w.load(PKL, num_msa_rounds=2, num_confs=4, compact=True)
        assert "_feat_cache" not in m_cold
        f_warm, m_warm, c_warm = w.load(PKL, num_msa_rounds=2, num_confs=4, compact=True)
        assert m_warm["_feat_cache"] == "hit"
        assert set(f_cold) == set(f_warm)
        for k in f_cold:
            np.testing.assert_array_equal(f_cold[k], f_warm[k], err_msg=k)
        np.testing.assert_array_equal(c_cold, c_warm)
        # other load kwargs miss
        _, m3, _ = w.load(PKL, num_msa_rounds=1, num_confs=4, compact=True)
        assert "_feat_cache" not in m3
    finally:
        w.stop()
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".pkl")]) == 2


def test_load_here_matches_the_worker_and_shares_its_cache(cfg, tmp_path):
    w = FeaturizerWorker(cfg.data, cache_dir=str(tmp_path), **FZ)
    try:
        kw = dict(num_msa_rounds=2, num_confs=4, compact=True)
        f_here, m_here, c_here = w.load_here(PKL2, **kw)
        assert not w.procs  # no process for a load in process
        assert "_feat_cache" not in m_here
        f_wk, m_wk, c_wk = w.load(PKL2, **kw)
        assert m_wk["_feat_cache"] == "hit"  # the entry load_here wrote
        (f_cold, m_cold, c_cold), = [w.load(PKL2, num_msa_rounds=2, num_confs=4,
                                            compact=True, remove_ligand=False)]
        assert "_feat_cache" not in m_cold  # other kwargs: the worker's own load
        for other, m_other, c_other in ((f_wk, m_wk, c_wk), (f_cold, m_cold, c_cold)):
            assert set(other) == set(f_here)
            for k in f_here:
                np.testing.assert_array_equal(f_here[k], other[k], err_msg=k)
            np.testing.assert_array_equal(c_here, c_other)
            for a, b in zip(m_here["batch_msa_feat_c"], m_other["batch_msa_feat_c"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    finally:
        w.stop()


def test_dock_many_through_worker_matches_sequential(cfg, model, worker, tmp_path):
    settings = _settings()
    seq = DockingPipeline(cfg, model, SystemFeaturizer(cfg.data, **FZ), settings, device="cpu")
    r_seq = [seq.dock(p, str(tmp_path / f"seq{i}")) for i, p in enumerate([PKL, PKL2])]
    many = DockingPipeline(cfg, model, worker, settings, device="cpu")
    r_many = many.dock_many([PKL, PKL2], str(tmp_path / "many"))
    assert [r["system_id"] for r in r_many] == ["5SAK_ZRY_A_1", "5SD5_HWI_A_1"]
    for i, (a, b) in enumerate(zip(r_seq, r_many)):
        assert a["system_id"] == b["system_id"] and a["rounds"] == b["rounds"]
        assert a["rank_order"] == b["rank_order"]
        np.testing.assert_allclose(a["top5_rmsd"], b["top5_rmsd"], atol=1e-4, rtol=0)
        if i == 0:  # featurized in process while the worker starts
            assert "load_detail" not in b["timings"]
            continue
        # the receive timings of the worker
        detail = b["timings"]["load_detail"]
        assert {"wait_s", "read_s", "mb", "worker_s", "cache"} <= set(detail)
        assert detail["cache"] == "miss" and detail["mb"] > 0
        out = tmp_path / "many" / b["system_id"]
        for f in ("top5_rmsd.json", "bust_report.json", "pred_rank0.pdb", "ligand_rank0.sdf"):
            assert (out / f).exists(), f
        assert json.loads((out / "top5_rmsd.json").read_text())["rank_order"] == b["rank_order"]


def test_dock_many_inline_matches_sequential(cfg, model, tmp_path):
    settings = _settings()
    pipe = DockingPipeline(cfg, model, SystemFeaturizer(cfg.data, **FZ), settings, device="cpu")
    r_seq = pipe.dock(PKL2, str(tmp_path / "seq"), write_outputs=False)
    (r_many,) = pipe.dock_many([PKL2], str(tmp_path / "many"))
    assert r_seq["rank_order"] == r_many["rank_order"]
    np.testing.assert_allclose(r_seq["top5_rmsd"], r_many["top5_rmsd"], atol=1e-4, rtol=0)
    assert (tmp_path / "many" / "5SD5_HWI_A_1" / "bust_report.json").exists()


@pytest.mark.parametrize("featurizer", ["worker", "inline"])
def test_dock_many_batched(cfg, model, worker, tmp_path, featurizer, monkeypatch):
    from physdock_tpu_torch.infer import pipeline as tpipe

    calls = []
    orig = tpipe.DockingPipeline._run_group_batched

    def recording(self, items, *a, **kw):
        calls.append([np.shape(f["a_mask"]) for f, _ in items])
        return orig(self, items, *a, **kw)

    monkeypatch.setattr(tpipe.DockingPipeline, "_run_group_batched", recording)
    fz = worker if featurizer == "worker" else SystemFeaturizer(cfg.data, **FZ)
    pipe = DockingPipeline(cfg, model, fz, _settings(), device="cpu")
    res = pipe.dock_many([PKL, PKL2], str(tmp_path), batch_size=2)
    # one group of two, re-padded to one bucket
    assert len(calls) == 1 and len(calls[0]) == 2 and calls[0][0] == calls[0][1]
    assert {r["system_id"] for r in res} == {"5SAK_ZRY_A_1", "5SD5_HWI_A_1"}
    for r in res:
        assert r["vs_batch_size"] == 2 and r["num_poses"] == 2
        assert all(np.isfinite(v) for v in r["top5_rmsd"])
        assert (tmp_path / r["system_id"] / "bust_report.json").exists()
        # the first system loads here; the worker's one process the second
        assert r["timings"]["load_fanout"] == (2 if featurizer == "worker" else 1)
        assert r["timings"]["load_overlap"] > 0


def test_batched_screen_post_processes_in_the_worker(cfg, model, worker, tmp_path, monkeypatch):
    """A batched screen's group (two SMILES into one receptor, loaded once)
    run through a pipeline whose featurizer is the worker hands each
    ligand-system's poses to the worker's post-processing (`submit_post`);
    its ranks and written poses equal the in-process pipeline's."""
    import copy

    posted = []
    orig = FeaturizerWorker.submit_post

    def recording(self, poses, args):
        posted.append(np.shape(poses))
        return orig(self, poses, args)

    monkeypatch.setattr(FeaturizerWorker, "submit_post", recording)
    smis = ["CC(=O)Nc1ccc(O)cc1", "OC(=O)c1ccccc1O"]
    # no KMeans ranking (its first call imports scikit-learn in the worker)
    # and no guidance (no conformer banks to build): the post is the same
    settings = _settings(enable_ranking=False, enable_physics_correction=False)
    inline = DockingPipeline(cfg, model, SystemFeaturizer(cfg.data, **FZ), settings,
                             device="cpu")
    items = [inline._load(PKL, remove_ligand=True, smi=smi, num_msa_rounds=1) for smi in smis]
    assert np.shape(items[0][0]["a_mask"]) == np.shape(items[1][0]["a_mask"])
    res = {}
    for name, pipe in (("inline", inline),
                       ("worker", DockingPipeline(cfg, model, worker, settings, device="cpu"))):
        res[name] = pipe._run_group_batched(
            copy.deepcopy(items), [str(tmp_path / name / str(i)) for i in range(2)],
            remove_ligand=True, smis=smis, write_outputs=True, t_start=0.0)
    assert len(posted) == 2 and all(p[0] == 2 for p in posted)
    for i, (a, b) in enumerate(zip(res["worker"], res["inline"])):
        assert a["vs_batch_size"] == b["vs_batch_size"] == 2 and a["num_poses"] == 2
        assert a["rank_order"] == b["rank_order"] and a["top5_rmsd"] is b["top5_rmsd"] is None
        for f in ("pred_rank0.pdb", "ligand_rank0.sdf", "ligand_rank1.sdf"):
            assert ((tmp_path / "worker" / str(i) / f).read_bytes()
                    == (tmp_path / "inline" / str(i) / f).read_bytes()), f


LOAD_KW = dict(num_msa_rounds=2, num_confs=4, conf_seed=0, compact=True)


def _assert_same_load(got, want):
    (f, m, c), (fw, mw, cw) = got, want
    assert m["system_id"] == mw["system_id"] and set(f) == set(fw)
    for k in fw:
        np.testing.assert_array_equal(f[k], fw[k], err_msg=k)
        assert f[k].dtype == fw[k].dtype, k
    np.testing.assert_array_equal(m["ligand_atom_idx"], mw["ligand_atom_idx"])
    assert len(m["batch_msa_feat_c"]) == len(mw["batch_msa_feat_c"])
    for a, b in zip(m["batch_msa_feat_c"], mw["batch_msa_feat_c"]):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(c, cw)


@pytest.fixture
def pool_of(cfg, monkeypatch):
    """A FeaturizerWorker whose `start(n)` runs n processes, whatever the
    host's cores (`pool_size` is tested on its own)."""
    monkeypatch.setattr(feat_worker, "pool_size", lambda wanted: wanted)
    made = []

    def make(n):
        w = FeaturizerWorker(cfg.data, **FZ)
        w.start(n)
        made.append(w)
        return w

    yield make
    for w in made:
        w.stop()


@pytest.mark.parametrize("n", [1, 3])
def test_pool_loads_equal_in_process_loads_in_order(pool_of, n):
    w = pool_of(n)
    systems = [PKL, PKL2, PKL3, PKL4, PKL2]
    for s in systems:
        w.submit(s, **LOAD_KW)
    for i, s in enumerate(systems):
        got = w.result()
        assert w.last_recv["worker"] == i % n and w.last_recv["mb"] > 0
        _assert_same_load(got, w.load_here(s, **LOAD_KW))
    assert len(w.procs) == n and all(p.popen.poll() is None for p in w.procs)


@pytest.mark.parametrize("n", [1, 3])
def test_pool_failing_load_raises_in_its_place(pool_of, n):
    w = pool_of(n)
    systems = [PKL, "/nonexistent/system.pkl.gz", PKL2, PKL3]
    for s in systems:
        w.submit(s, num_msa_rounds=1, compact=True)
    got = []
    for s in systems:
        try:
            got.append(w.result()[1]["system_id"])
        except RuntimeError as e:
            assert "featurizer worker failed" in str(e) and "nonexistent" in str(e)
            got.append(None)
    assert got == ["5SAK_ZRY_A_1", None, "5SD5_HWI_A_1", "5SB2_1K2_A_1"]
    with pytest.raises(RuntimeError, match="no pending request"):
        w.result()
    # the pool goes on serving, in order, from every process
    for s in (PKL3, PKL):
        w.submit(s, num_msa_rounds=1, compact=True)
    assert [w.result()[1]["system_id"] for _ in range(2)] == ["5SB2_1K2_A_1", "5SAK_ZRY_A_1"]


def test_pool_stop_ends_every_process(pool_of):
    w = pool_of(3)
    w.submit(PKL, num_msa_rounds=1, compact=True)
    w.submit(PKL2, num_msa_rounds=1, compact=True)  # left undrained
    assert w.result()[1]["system_id"] == "5SAK_ZRY_A_1"
    procs = [p.popen for p in w.procs]
    assert len(procs) == 3 and all(p.poll() is None for p in procs)
    w.stop()
    assert all(p.poll() is not None for p in procs)
    with pytest.raises(RuntimeError, match="no pending request"):
        w.result()
    # a later call starts the processes anew
    w.start(2)
    assert w.load(PKL2, num_msa_rounds=1, compact=True)[1]["system_id"] == "5SD5_HWI_A_1"
    assert [p.popen.poll() is None for p in w.procs[:2]] == [True, True]


@pytest.mark.parametrize("cores,wanted,size", [(8, 3, 3), (8, 1, 1), (8, 10, 6), (4, 3, 2),
                                               (2, 3, 1), (1, 3, 1)])
def test_pool_size_leaves_two_cores(monkeypatch, cores, wanted, size):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
    assert feat_worker.pool_size(wanted) == size


def test_dock_many_batched_through_the_pool_equals_in_process_loads(cfg, model, pool_of,
                                                                     tmp_path):
    systems = [PKL3, PKL, PKL2]
    settings = _settings(max_rounds=2)
    w = pool_of(1)
    res = {}
    for name, fz in (("inline", SystemFeaturizer(cfg.data, **FZ)), ("pool", w)):
        pipe = DockingPipeline(cfg, model, fz, settings, device="cpu")
        res[name] = pipe.dock_many(systems, str(tmp_path / name), batch_size=4)
    assert len(w.procs) == 2  # the call's two systems beyond the first, side by side
    for a, b in zip(res["pool"], res["inline"]):
        assert a["system_id"] == b["system_id"] and a["rounds"] == b["rounds"]
        assert a["rank_order"] == b["rank_order"] and a["all_rmsd"] == b["all_rmsd"]
        assert a["timings"]["load_fanout"] == 3 and b["timings"]["load_fanout"] == 1
        assert a["timings"]["load_overlap"] > 0 and b["timings"]["load_overlap"] > 0
        for f in ("pred_rank0.pdb", "ligand_rank0.sdf", "bust_report.json"):
            assert ((tmp_path / "pool" / a["system_id"] / f).read_bytes()
                    == (tmp_path / "inline" / a["system_id"] / f).read_bytes()), f
    details = [r["timings"].get("load_detail") for r in res["pool"]]
    assert sorted(d["worker"] for d in details if d) == [0, 1]


def _captured_group(pipe, monkeypatch, dock_many):
    """The (items, gt_ligs) that `dock_many` hands `pipe`'s
    `_run_group_batched`, which then docks nothing."""
    seen = []

    def capture(items, out_dirs, **kw):
        seen.append((items, kw["gt_ligs"]))
        return []

    monkeypatch.setattr(pipe, "_run_group_batched", capture)
    dock_many()
    (group,) = seen
    return group


class _JaxWorkerInProcess:
    """What the JAX package's featurizer worker ships for a load (compact
    features, per-round compact MSA, conformer bank), computed in process
    so that the JAX `_dock_many_batched` runs without a subprocess."""

    def __init__(self, fz):
        self.fz, self.queue = fz, []
        self.use_x_gt_ligand_as_ref_pos = fz.use_x_gt_ligand_as_ref_pos

    def submit(self, system, num_confs=None, conf_seed=0, compact=False, **kw):
        self.queue.append((system, kw, num_confs, conf_seed))

    def result(self):
        from physdock_tpu.data.embed import generate_conformers
        from physdock_tpu.model.compact import compact_batch_np, compact_msa_np

        system, kw, num_confs, conf_seed = self.queue.pop(0)
        feats, meta = self.fz.load(system, **kw)
        bm = meta.pop("batch_msa_feat", None)
        if bm is not None:
            meta["batch_msa_feat_c"] = [compact_msa_np(m) for m in bm]
        mol = meta["ref_mol"]
        confs = generate_conformers(mol, num_confs=num_confs, base_coords=mol.coords,
                                    rng=np.random.default_rng(conf_seed))
        return compact_batch_np(feats), meta, confs


def test_batched_group_matches_jax_and_each_slot_docks_alone(model, tmp_path, monkeypatch):
    from physdock_tpu.config import PhysDockConfig as JaxConfig
    from physdock_tpu.data.feature_loader import SystemFeaturizer as JaxFeaturizer
    from physdock_tpu.infer import pipeline as jpipe
    from physdock_tpu_torch.model.diffusion import (
        sample_diffusion,
        sample_diffusion_batched,
        stack_guidances,
        stacked_conditioning,
    )

    # the GT-conformer ablation, so that the group carries gt_ligs too
    kw = dict(crop_size=32, atom_crop_size=256, infer_use_pocket=True, infer_use_key_res=True)
    fz = dict(FZ, use_x_gt_ligand_as_ref_pos=True)
    settings = _settings(max_rounds=2)  # a per-round MSA to re-pad
    pipe = DockingPipeline(PhysDockConfig.named("toy", **kw), model,
                           SystemFeaturizer(PhysDockConfig.named("toy", **kw).data, **fz),
                           settings, device="cpu")
    items, gt_ligs = _captured_group(pipe, monkeypatch, lambda: pipe.dock_many(
        [PKL, PKL2], str(tmp_path / "port"), batch_size=2))
    jax_pipe = jpipe.DockingPipeline(
        JaxConfig.named("toy", **kw), None,
        _JaxWorkerInProcess(JaxFeaturizer(JaxConfig.named("toy", **kw).data, **fz)),
        jpipe.SamplerSettings(**{f: getattr(settings, f) for f in (
            "max_samples", "num_samples_per_round", "max_rounds", "steps",
            "enable_physics_correction", "num_confs", "enable_ranking", "seed")}))
    j_items, j_gt_ligs = _captured_group(jax_pipe, monkeypatch, lambda: jax_pipe._dock_many_batched(
        [PKL, PKL2], str(tmp_path / "jax"), remove_ligand=False, smi=None, ligand_sdf=None,
        write_outputs=False, batch_size=2))

    assert [m["system_id"] for _, m in items] == [m["system_id"] for _, m in j_items] == [
        "5SAK_ZRY_A_1", "5SD5_HWI_A_1"]
    assert len({np.shape(f["a_mask"]) for f, _ in items}) == 1  # one padded bucket
    for (f, m), (jf, jm), g, jg in zip(items, j_items, gt_ligs, j_gt_ligs):
        assert set(f) == set(jf)
        for k in f:
            np.testing.assert_array_equal(f[k], np.asarray(jf[k]), err_msg=k)
            assert np.asarray(f[k]).dtype == np.asarray(jf[k]).dtype, k
        np.testing.assert_array_equal(m["ligand_atom_idx"], jm["ligand_atom_idx"])
        assert len(m["batch_msa_feat_c"]) == len(jm["batch_msa_feat_c"])
        for a, b in zip(m["batch_msa_feat_c"], jm["batch_msa_feat_c"]):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(g, jg)

    # each slot against the system docked alone at the padded bucket
    for f, m in items:
        f.update(m["batch_msa_feat_c"][0])  # round 0's MSA, as the group runner sets it
    l_max = max(len(m["ligand_atom_idx"]) for _, m in items)
    guides = [pipe._build_guidance(f, m, pad_atoms=l_max)[0] for f, m in items]
    batches = [pipe._to_device(f) for f, _ in items]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    rng = np.random.default_rng(0)
    T, S, A = 2, 2, stacked["ref_pos"].shape[-2]
    rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(2 * T * S)])
    noise = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in {
        "x_init_z": rng.normal(size=(2, S, A, 3)), "aug_R": rot.reshape(2, T, S, 3, 3),
        "aug_t": rng.normal(size=(2, T, S, 3)), "churn_z": rng.normal(size=(2, T, S, A, 3)),
    }.items()}
    factors = [settings.eta, 100.0]
    skw = dict(num_sample=S, steps=T, karras_rho=settings.rho, mmff_iters=settings.mmff_iters,
               align_ref_pos=True, return_trajectory=True)
    with torch.no_grad():
        conds = stacked_conditioning(pipe.model, stacked)
        batched = sample_diffusion_batched(
            pipe.model, stacked, guidance=stack_guidances(guides), mmff_gamma_0_factor=factors,
            conditioning=conds, noise_override=noise, **skw)
        for b in range(2):
            alone = sample_diffusion(
                pipe.model, batches[b], guidance=guides[b], mmff_gamma_0_factor=factors[b],
                conditioning=tuple(c[b] for c in conds),
                noise_override={k: v[b] for k, v in noise.items()}, **skw)
            assert torch.isfinite(alone).all()
            err = float((batched[b] - alone).abs().max())
            assert err <= 1e-4, f"system {b}: {err} A between its slot and its dock alone"


def _cli(out, inputs, *extra):
    return redocking.main([
        *inputs, "-o", str(out), "--model_name", "toy", "--params", NPZ,
        "--crop_size", "32", "--atom_crop_size", "256",
        "--msa_features_dir", f"{DEMO}/features/msa_features",
        "--uniprot_msa_features_dir", f"{DEMO}/features/uniprot_msa_features",
        "--steps", "2", "--max_rounds", "1", "--num_samples_per_round", "2",
        "--max_samples", "2", "--num_confs", "4", "--use_pocket", "--use_key_res",
        "--enable_physics_correction", "--enable_ranking", "--device", "cpu", *extra,
    ])


def test_cli_records_a_failing_system_and_goes_on(tmp_path):
    d = tmp_path / "systems"
    d.mkdir()
    for name in ("5SIS_JSM_A_1", "5SD5_HWI_A_1"):
        os.symlink(os.path.join(SYSTEMS, f"{name}.pkl.gz"), d / f"{name}.pkl.gz")
    out = tmp_path / "out"
    res = _cli(out, ["-f", str(d)], "--align_mode", "pocket_ca")
    summary = json.loads((out / "summary.json").read_text())
    assert [r["system_id"] for r in summary] == [r["system_id"] for r in res]
    errors = [r for r in summary if "error" in r]
    docked = [r for r in summary if "error" not in r]
    assert [set(r) for r in errors] == [{"system_id", "error"}]
    assert errors[0]["system_id"] == "5SIS_JSM_A_1"
    assert [r["system_id"] for r in docked] == ["5SD5_HWI_A_1"]
    assert np.all(np.isfinite(docked[0]["top5_rmsd"]))
    assert (out / "5SD5_HWI_A_1" / "bust_report.json").exists()


@pytest.mark.parametrize("route", ["single", "many"])
def test_cli_error_naming_cuda_ends_the_run(tmp_path, monkeypatch, route):
    from physdock_tpu_torch.infer import pipeline as tpipe

    def broken(self, *a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tpipe.DockingPipeline, "dock", broken)
    monkeypatch.setattr(tpipe.DockingPipeline, "dock_many", broken)
    inputs = ["-i", PKL2] if route == "single" else ["-f", SYSTEMS]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _cli(tmp_path, inputs)
    assert not (tmp_path / "summary.json").exists()


def test_cli_card_errors_are_named():
    assert redocking.names_the_card(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert redocking.names_the_card(RuntimeError("CUDA error: device-side assert triggered"))
    assert not redocking.names_the_card(RuntimeError("linalg.svd: non-finite values"))
    assert not redocking.names_the_card(ValueError("CUDA"))
