"""Rank functions of the distributed CPU tests (tests/test_torch_dp.py,
tests/test_torch_dp_cli.py, tests/test_torch_sharded_infer.py,
tests/test_torch_tp.py).

`physdock_tpu_torch.parallel.launch.run_ranks` runs each in spawned
processes joined in a gloo group; a spawned process imports this module,
which imports nothing of JAX. Inputs arrive as saved files in the test's
tmp_path, and each rank returns CPU tensors.
"""

from __future__ import annotations

import torch

from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.model.weights import load_jax_params
from physdock_tpu_torch.nn import transformers as ttr
from physdock_tpu_torch.parallel.mesh import make_mesh
from physdock_tpu_torch.parallel.tp import gather_rows, reduce_grads, use_tp

# --------------------------------------------------------------- tp stacks


def build_stacks(state_dicts=None):
    """The stacks under test at small widths: Pairformer (c_s 64, c_z 32),
    Evoformer (c_m 64, c_z 32), Triangleformer (c_z 32) and a DiT (c_s
    64, c_z 16), two blocks each."""
    g = torch.Generator().manual_seed(0)
    mods = {"pairformer": ttr.Pairformer(64, 32, 2, generator=g),
            "evoformer": ttr.Evoformer(64, 32, 2, generator=g),
            "triangleformer": ttr.Triangleformer(32, 2, generator=g),
            "dit": ttr.DiT(64, 16, 2, generator=g)}
    for name, mod in mods.items():
        if state_dicts is not None:
            mod.load_state_dict(state_dicts[name], strict=True)
    return mods


def stack_run(mods, x, mesh=None):
    """Every stack's outputs on the inputs `x`, and the gradient of a fixed
    projection of them with respect to every parameter (under tp, each
    rank's shares summed by `reduce_grads`). The DiT's bias cache comes
    back whole (gathered) and as this rank holds it."""
    params = [p for m in mods.values() for p in m.parameters()]
    with use_tp(mesh):
        out = {}
        out["pairformer_s"], out["pairformer_z"] = mods["pairformer"](x["s"], x["z"], x["z_mask"])
        out["evoformer_m"], out["evoformer_z"] = mods["evoformer"](x["m"], x["z"], x["z_mask"])
        out["triangleformer_z"] = mods["triangleformer"](x["z"], x["z_mask"], x["pad_mask"])
        bias = mods["dit"].compute_bias(x["z_dit"], x["z_dit_mask"])
        out["dit_bias"] = gather_rows(bias, -2)
        out["dit_bs"] = mods["dit"](x["bs"], x["t"], bias)
        loss = sum((o.float() * x["w_" + k]).sum() for k, o in out.items())
        grads = [g.clone() for g in torch.autograd.grad(loss, params)]
    reduce_grads(grads, mesh)
    return ({k: v.detach() for k, v in out.items()}, grads, bias.detach())


def tp_stacks(rank, world, path):
    """tp = world: the stacks' outputs, gradients, the z rows each block
    took, the local bias cache and the row-sharded attention's calls."""
    from physdock_tpu_torch.ops import attention

    blob = torch.load(path, weights_only=False)
    mods = build_stacks(blob["state_dicts"])
    z_rows = []
    for name in ("pairformer", "evoformer", "triangleformer"):
        for blk in mods[name].blocks:
            arg = 0 if name == "triangleformer" else 1
            blk.register_forward_pre_hook(
                lambda m, args, i=arg, n=name: z_rows.append((n, args[i].shape[-3])))
    mesh = make_mesh(tp=world)
    attention.TP_FLASH_CALLS[0] = 0
    out, grads, bias = stack_run(mods, blob["inputs"], mesh)
    return {"out": out, "grads": grads, "z_rows": z_rows, "bias_local": bias,
            "tp_flash_calls": attention.TP_FLASH_CALLS[0], "tp_rank": mesh.tp_rank}


# ------------------------------------------------------------------ dp step


def dp_step(rank, world, path):
    """One train step of the toy model at dp = world on this rank's systems
    of the global batch; the state after it. With `draws` in the blob the
    step takes the given draws of the whole global batch, else it draws
    its own systems' from the run's seed."""
    from physdock_tpu_torch.train import optim
    from physdock_tpu_torch.train.step import init_train_state, make_train_step

    blob = torch.load(path, weights_only=False)
    cfg = PhysDockConfig.named("toy", num_augmentation_sample=blob["n_aug"])
    model = PhysDock(cfg.model)
    load_jax_params(model, blob["npz"])
    opt = optim.make_optimizer(**blob["opt"])
    state = init_train_state(model, opt)
    mesh = make_mesh(dp=world)
    step = make_train_step(model, opt, cfg.loss, ema_decay=blob["ema_decay"],
                           sigma_data=cfg.model.sigma_data, mesh=mesh)
    n_local = blob["batch"]["x_gt"].shape[0] // world
    local = {k: v[rank * n_local:(rank + 1) * n_local] for k, v in blob["batch"].items()}
    state, logs = step(state, local, blob["seed"], draws=blob.get("draws"))
    return {"logs": logs, "params": {n: p.detach() for n, p in state.params.items()},
            "mu": state.opt_state.mu, "nu": state.opt_state.nu, "ema": state.ema_params}


# ---------------------------------------------------------- sharded sampler


def sharded_sample(rank, world, path):
    """`sharded_sample_diffusion` of the toy model over dp = world, once
    from a generator seeded alike on every rank and once from the given
    noise; every rank returns all the poses."""
    from physdock_tpu_torch.infer.sharded import sharded_sample_diffusion

    blob = torch.load(path, weights_only=False)
    model = PhysDock(PhysDockConfig.named("toy").model)
    load_jax_params(model, blob["npz"])
    model.eval()
    mesh = make_mesh(dp=world)
    kw = dict(num_sample=blob["num_sample"], steps=blob["steps"])
    drawn = sharded_sample_diffusion(model, blob["batch"], mesh,
                                     generator=torch.Generator().manual_seed(blob["seed"]), **kw)
    given = sharded_sample_diffusion(model, blob["batch"], mesh,
                                     noise_override=blob["noise"], **kw)
    return {"drawn": drawn, "given": given}


# ------------------------------------------------------------------ tp dock


def dock_demo(tp, out):
    """One demo system docked through `DockingPipeline` with
    `SamplerSettings(tp=tp)` at a tiny crop on the CPU; its RMSDs and the
    files this process wrote."""
    import os

    from physdock_tpu_torch.cli.common import load_model
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.infer.pipeline import DockingPipeline, SamplerSettings
    from physdock_tpu_torch.utils.demo_assets import (
        redocking_features_dir,
        redocking_systems_dir,
    )

    feats = redocking_features_dir()
    cfg = PhysDockConfig.named("toy", crop_size=32, atom_crop_size=256, infer_use_pocket=True,
                               infer_use_key_res=True)
    featurizer = SystemFeaturizer(
        cfg.data, msa_features_dir=os.path.join(feats, "msa_features"),
        uniprot_msa_features_dir=os.path.join(feats, "uniprot_msa_features"),
        inference_mode=True, seed=0)
    settings = SamplerSettings(max_samples=2, num_samples_per_round=2, max_rounds=1, steps=2,
                               enable_physics_correction=True, num_confs=4, enable_ranking=True,
                               seed=0, tp=tp)
    npz = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "_overfit", "ema_params.npz")
    pipe = DockingPipeline(cfg, load_model(npz, cfg), featurizer, settings, device="cpu")
    r = pipe.dock(os.path.join(redocking_systems_dir(), "5SD5_HWI_A_1.pkl.gz"), out)
    return {"all_rmsd": r["all_rmsd"], "wrote": sorted(os.listdir(out)) if os.path.isdir(out)
            else []}


def tp_dock(rank, world, tmp):
    return dock_demo(world, f"{tmp}/rank{rank}")
