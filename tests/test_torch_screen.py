"""Virtual screening in the PyTorch port against the JAX package.

  * stacked force fields: `stack_ligand_ffs` equals the JAX one array for
    array; the stacked relaxation equals `jax.vmap(relax_positions)` within
    1e-5 A, the chirality check exactly;
  * the denoiser with a system axis against `jax.vmap` of the JAX
    denoiser, rel 1e-4 of max|JAX| (fp32 on the CPU);
  * the batched sampler: 2 systems with different ligands (padded to the
    larger), 4 guided steps, caller-given noise per system and a different
    adaptive factor each (so one step matches conformers in one system and
    relaxes in the other): against `jax.vmap` of the JAX sampler within
    1e-2 A at every step, and against the port's single-system sampler on
    each system within 1e-4 A;
  * routing: with the wrappers replaced by a recorder, the DiT's calls
    with a system axis reach `flash_sdpa_folded_v3` (atoms, S >= 1024) and
    `flash_sdpa_grouped` (tokens) over the N * Bsys rows, with lead
    Bsys * H and no bias expansion;
  * the screening CLI end to end on the demo receptor (3 SMILES, batched,
    guided, 2 steps, crop 64/512, CPU), and one shard of two.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physdock_tpu.config import PhysDockConfig as JaxConfig
from physdock_tpu.data.synthetic import make_synthetic_batch
from physdock_tpu.model import diffusion as jdiff
from physdock_tpu.model import forcefield as jff
from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
from physdock_tpu.train.checkpoint import load_params_npz
from physdock_tpu_torch.cli import screening
from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model import diffusion as tdiff
from physdock_tpu_torch.model import forcefield as tff
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params
from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.ops import attention as tattn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "_overfit", "ema_params.npz")
STEPS, S, K = 4, 2, 3
FACTORS = (20.0, 400.0)  # thresholds between sigma 311 and 15, and 2560 and 311


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def models():
    jm = JaxPhysDock(cfg=JaxConfig.named("toy").model)
    tm = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(tm, NPZ)
    return jm, load_params_npz(NPZ), tm.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _stack(dicts):
    return {k: np.stack([np.asarray(d[k]) for d in dicts]) for k in dicts[0]}


def _ff_args(n, seed):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=(n, 3)).astype(np.float32) * 1.5
    z = [6, 6, 7, 6, 8, 6, 6, 16, 6, 7][:n]
    bonds = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
    return dict(atomic_numbers=z, bonds=bonds, ref_pos=ref,
                chiral_centers=[(1, (0, 2, 3, 4))], rigid_14=[(0, 3)])


def test_stacked_forcefields_match_jax():
    sizes = (5, 9, 7)
    args = [_ff_args(n, 30 + n) for n in sizes]
    jffs = [jff.build_ligand_ff(**a) for a in args]
    tffs = [tff.build_ligand_ff(**a) for a in args]
    js, ts = jff.stack_ligand_ffs(jffs), tff.stack_ligand_ffs(tffs)
    for f in dataclasses.fields(tff.LigandFF):
        np.testing.assert_array_equal(np.asarray(getattr(js, f.name)),
                                      getattr(ts, f.name).numpy(), err_msg=f.name)
    rng = np.random.default_rng(3)
    pos = np.zeros((3, 4, max(sizes), 3), np.float32)
    for b, (n, a) in enumerate(zip(sizes, args)):
        pos[b, :, :n] = a["ref_pos"][None] + rng.normal(size=(4, n, 3)) * 0.7
    jr = jax.vmap(lambda p, f: jff.relax_positions(p, f, iters=5))(jnp.asarray(pos), js)
    tr = tff.relax_positions(_t(pos), ts, iters=5)
    assert np.abs(np.asarray(jr) - tr.numpy()).max() <= 1e-5
    jok = jax.vmap(jff.chirality_correct)(jnp.asarray(pos), js)
    np.testing.assert_array_equal(np.asarray(jok), tff.chirality_correct(_t(pos), ts).numpy())
    # each system's slice of the stacked field relaxes as its own field
    for b, n in enumerate(sizes):
        one = tff.relax_positions(_t(pos[b, :, :n]), tffs[b], iters=5)
        np.testing.assert_allclose(tr[b, :, :n].numpy(), one.numpy(), atol=1e-6)


def _systems():
    """Two synthetic systems of one shape whose ligands differ (6 and 5
    atoms), their force-field arguments, conformer banks padded to 6
    atoms, and per-system noise."""
    batches, ligs, ffs, banks, noises = [], [], [], [], []
    for n_lig, seed in ((6, 4), (5, 5)):
        batch = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4,
                                     n_ligand_tokens=n_lig, seed=seed)
        atom_tok = np.asarray(batch["atom_id_to_token_id"])
        lig_idx = np.nonzero((np.asarray(batch["is_ligand"])[atom_tok] > 0)
                             & (np.asarray(batch["a_mask"]) > 0))[0]
        L = len(lig_idx)
        rng = np.random.default_rng(20 + seed)
        ref = np.asarray(batch["x_gt"])[lig_idx].astype(np.float32)
        ffs.append(dict(atomic_numbers=[6, 6, 7, 6, 8, 6][:L],
                        bonds=[(i, i + 1) for i in range(L - 1)], ref_pos=ref,
                        chiral_centers=[(1, (0, 2, 3, 4))]))
        conf = np.zeros((K, 6, 3), np.float32)
        conf[:, :L] = ref[None] + rng.normal(size=(K, L, 3)) * 0.5
        banks.append((conf, np.linalg.norm(conf[:, :, None] - conf[:, None], axis=-1),
                      np.array([1, 1, 0], np.float32)))
        idx = np.full(6, 48, np.int64)
        idx[:L] = lig_idx
        mask = np.zeros(6, np.float32)
        mask[:L] = 1.0
        ligs.append((idx, mask))
        rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(STEPS * S)])
        noises.append(dict(
            x_init_z=rng.normal(size=(S, 48, 3)).astype(np.float32),
            aug_R=rot.reshape(STEPS, S, 3, 3).astype(np.float32),
            aug_t=rng.normal(size=(STEPS, S, 3)).astype(np.float32),
            churn_z=rng.normal(size=(STEPS, S, 48, 3)).astype(np.float32)))
        batches.append(batch)
    return batches, ligs, ffs, banks, noises


def _port_guidance(lig, ff_args, bank):
    (idx, mask), (conf, conf_d, conf_m) = lig, bank
    return tdiff.PhysicsGuidance(
        ligand_idx=_t(idx), ligand_mask=_t(mask), conf_pos=_t(conf),
        conf_dists=_t(conf_d.astype(np.float32)), conf_mask=_t(conf_m),
        ff=tff.build_ligand_ff(**ff_args))


def test_batched_sampler_lockstep_with_jax_vmap_and_single(models):
    jm, jparams, tm = models
    batches, ligs, ffs, banks, noises = _systems()
    kw = dict(num_sample=S, steps=STEPS, karras_rho=7.0, mmff_iters=5, align_ref_pos=True,
              return_trajectory=True)

    jg = jdiff.PhysicsGuidance(
        ligand_idx=jnp.asarray(np.stack([i for i, _ in ligs]), jnp.int32),
        ligand_mask=jnp.asarray(np.stack([m for _, m in ligs])),
        conf_pos=jnp.asarray(np.stack([b[0] for b in banks])),
        conf_dists=jnp.asarray(np.stack([b[1] for b in banks]).astype(np.float32)),
        conf_mask=jnp.asarray(np.stack([b[2] for b in banks])),
        ff=jff.stack_ligand_ffs([jff.build_ligand_ff(**a) for a in ffs]))

    def one(batch, key, g, factor, noise):
        return jdiff.sample_diffusion(jm, jparams, batch, key, guidance=g,
                                      mmff_gamma_0_factor=factor, noise_override=noise, **kw)

    jtraj = np.asarray(jax.vmap(one)(
        {k: jnp.asarray(v) for k, v in _stack(batches).items()},
        jax.random.split(jax.random.PRNGKey(0), 2), jg, jnp.asarray(FACTORS),
        {k: jnp.asarray(v) for k, v in _stack(noises).items()}))

    guides = [_port_guidance(lig, a, bank) for lig, a, bank in zip(ligs, ffs, banks)]
    ttraj = tdiff.sample_diffusion_batched(
        tm, {k: _t(v) for k, v in _stack(batches).items()},
        guidance=tdiff.stack_guidances(guides), mmff_gamma_0_factor=FACTORS,
        noise_override={k: _t(v) for k, v in _stack(noises).items()}, **kw).numpy()

    assert jtraj.shape == ttraj.shape == (2, STEPS, S, 48, 3)
    assert np.all(np.isfinite(ttraj))
    for i in range(STEPS):
        err = np.abs(jtraj[:, i] - ttraj[:, i]).max()
        assert err <= 1e-2, f"step {i}: max abs err {err} A against jax.vmap"
    for b in range(2):
        single = tdiff.sample_diffusion(
            tm, {k: _t(v) for k, v in batches[b].items()}, guidance=guides[b],
            mmff_gamma_0_factor=FACTORS[b], noise_override={k: _t(v) for k, v in noises[b].items()},
            **kw).numpy()
        err = np.abs(single - ttraj[b]).max()
        assert err <= 1e-4, f"system {b}: max abs err {err} A against the single-system sampler"


def _rel(ref, out):
    ref, out = np.asarray(ref), np.asarray(out)
    return np.abs(ref - out).max() / np.abs(ref).max()


def test_denoiser_with_a_system_axis_matches_jax_vmap(models):
    jm, jparams, tm = models
    batches = _systems()[0]
    jb = {k: jnp.asarray(v) for k, v in _stack(batches).items()}
    tb = {k: _t(v) for k, v in _stack(batches).items()}
    rng = np.random.default_rng(8)
    x_hat = (rng.normal(size=(2, 3, 48, 3)) * 12).astype(np.float32)
    t_hat = np.array([[0.5, 16.0, 160.0], [2.0, 40.0, 900.0]], np.float32)

    def one(b, x, t):
        cond = jm.apply(jparams, b, method="conditioning")
        cache = jm.apply(jparams, b, cond[1], cond[3], method="denoise_bias_cache")
        return jm.apply(jparams, b, x, t, *cond, cache, method="denoise")

    jd = jax.vmap(one)(jb, jnp.asarray(x_hat), jnp.asarray(t_hat))
    with torch.no_grad():
        a, ap, s, z = tdiff.stacked_conditioning(tm, tb)
        td = tm.denoise(tb, _t(x_hat), _t(t_hat), a, ap, s, z,
                        tm.denoise_bias_cache(tb, ap, z))
    assert td.shape == (2, 3, 48, 3)
    assert _rel(jd, td.numpy()) <= 1e-4


def test_system_axis_routes_to_the_shared_bias_wrappers(models, monkeypatch):
    """The DiT of two systems at 1024 atoms: every attention call reaches a
    shared-bias wrapper over the N * Bsys rows with lead Bsys * H; the
    result equals each system denoised on its own."""
    tm = models[2]
    calls = []

    def recorder(name, fn):
        def wrapped(q, k, v, bias, *h):  # h: the folded wrappers' head count
            heads = h[0] if h else q.shape[1]
            s_q, s_k = (q.shape[1], k.shape[1]) if h else (q.shape[2], k.shape[2])
            _, lead = _flash_lib.shared_bias(bias, q.shape[0], heads, s_q, s_k)
            calls.append((name, q.shape[0], tuple(bias.shape), lead))
            return fn(q, k, v, bias, *h)
        return wrapped

    for name in ("flash_sdpa", "flash_sdpa_folded_v3", "flash_sdpa_grouped",
                 "flash_sdpa_folded_from_split"):
        monkeypatch.setattr(tattn, name, recorder(name, getattr(tattn, name)))
    from physdock_tpu_torch.data.synthetic import make_synthetic_batch as port_batch

    batches = [port_batch(n_tokens=32, n_atoms=1024, n_msa=2, n_ligand_tokens=n, seed=n)
               for n in (8, 5)]
    tb = {k: _t(v) for k, v in _stack(batches).items()}
    c = tm.cfg
    g = torch.Generator().manual_seed(0)
    a = torch.randn((2, 1024, c.c_a), generator=g)
    ap = torch.randn((2, 1024, 1024, c.c_ap), generator=g)
    s = torch.randn((2, 32, c.c_s), generator=g)
    z = torch.randn((2, 32, 32, c.c_z), generator=g)
    x_hat = torch.randn((2, 3, 1024, 3), generator=g) * 10
    t_hat = torch.tensor([[1.0, 10.0, 100.0], [3.0, 30.0, 300.0]])
    _flash_lib.reset_launches()
    with torch.no_grad():
        out = tm.denoise(tb, x_hat, t_hat, a, ap, s, z, tm.denoise_bias_cache(tb, ap, z))
        singles = [tm.denoise({k: v[i] for k, v in tb.items()}, x_hat[i], t_hat[i], a[i], ap[i],
                              s[i], z[i]) for i in range(2)]
    n_atom, n_tok = 2 * c.no_blocks_atom, c.no_blocks_dit
    batched = calls[: n_atom + n_tok]
    h_atom, h_tok = c.c_a // 32, c.c_s // 32
    assert sorted(batched) == sorted(
        [("flash_sdpa_folded_v3", 6, (2, h_atom, 1024, 1024), 2 * h_atom)] * n_atom
        + [("flash_sdpa_grouped", 6, (2, h_tok, 32, 32), 2 * h_tok)] * n_tok)
    assert not any(_flash_lib.BIAS_EXPANSIONS.values())
    for i in range(2):
        assert _rel(singles[i].numpy(), out[i].numpy()) <= 1e-5


def _screen_args(smiles_txt, out, *extra):
    feats = os.path.join(REPO, "demo", "screening", "features")
    return ["-i", os.path.join(REPO, "demo", "screening", "6kzd.pkl.gz"), "-s", smiles_txt,
            "-o", out, "--params", NPZ, "--model_name", "toy", "--crop_size", "64",
            "--atom_crop_size", "512", "--msa_features_dir", os.path.join(feats, "msa_features"),
            "--uniprot_msa_features_dir", os.path.join(feats, "uniprot_msa_features"),
            "--steps", "2", "--max_rounds", "2", "--num_samples_per_round", "2",
            "--max_samples", "2", "--num_confs", "4", "--use_pocket", "--use_key_res",
            "--enable_physics_correction", "--enable_ranking", "--device", "cpu", *extra]


def test_screening_cli_end_to_end(tmp_path):
    with open(os.path.join(REPO, "demo", "screening", "demo_db.txt")) as f:
        smiles = [ln.strip() for ln in f if ln.strip()][:3]
    smi_txt = str(tmp_path / "smi.txt")
    with open(smi_txt, "w") as f:
        f.write("\n".join(smiles) + "\n")
    out = str(tmp_path / "out")
    res = screening.main(_screen_args(smi_txt, out, "--vs_batch_size", "3"))
    assert [r["smiles"] for r in res] == smiles
    md5 = json.load(open(os.path.join(out, "smiles_to_md5.json")))
    assert set(md5) == set(smiles)
    assert json.load(open(os.path.join(out, "screening_results.json"))) == res
    for r in res:
        assert "error" not in r and r["num_poses"] == 2 and r["vs_batch_size"] == 3
        d = os.path.join(out, md5[r["smiles"]])
        for name in ("pred_rank0.pdb", "ligand_rank0.sdf"):
            assert os.path.getsize(os.path.join(d, name)) > 0

    shard = str(tmp_path / "shard")
    res = screening.main(_screen_args(smi_txt, shard, "--num_shards", "2", "--shard_id", "1",
                                      "--max_rounds", "1"))
    assert [r["smiles"] for r in res] == smiles[1::2]
    assert "error" not in res[0] and "vs_batch_size" not in res[0]
    assert json.load(open(os.path.join(shard, "screening_results.shard001.json"))) == res
    assert not os.path.exists(os.path.join(shard, "screening_results.json"))
