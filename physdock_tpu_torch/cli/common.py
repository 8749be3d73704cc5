"""Shared CLI plumbing (port of `physdock_tpu/cli/common.py`): the argparse
surface of the reference redocking CLI, plus `--device`; model and
parameter loading through the weight bridge.  On CUDA the pipeline's
featurizer is a `data/feat_worker.FeaturizerWorker`, as the JAX CLI keys
it on the platform: `dock_many` prefetches its later systems in the
worker subprocess, which starts only then; every load the caller waits
for runs in process.  With `--device cpu` the featurizer is in process."""

from __future__ import annotations

import argparse
from typing import Optional

import torch


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--params", default=None,
                   help="weights: a JAX .npz artifact (physdock_tpu/train/checkpoint.py), a "
                        "train-state .pt of the port's trainer (its EMA), or a reference "
                        "params.pt (release, Uni-Core or compiled layout); random weights "
                        "from --seed when absent")
    p.add_argument("--model_name", default="medium",
                   choices=["toy", "tiny", "small", "medium", "full"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU only when asked: --device cpu)")
    p.add_argument("--ccd_blob", default=None,
                   help="external ccd_id_meta_data.pkl.gz (reference-compatible schema) "
                        "for ligand CCD chemistry")
    p.add_argument("--msa_features_dir", default=None)
    p.add_argument("--uniprot_msa_features_dir", default=None)
    p.add_argument("--max_samples", type=int, default=5)
    p.add_argument("--num_samples_per_round", type=int, default=5)
    p.add_argument("--max_rounds", type=int, default=10)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--enable_physics_correction", action="store_true")
    p.add_argument("--mmff_iters", type=int, default=5)
    p.add_argument("--eta", type=float, default=6.0, help="mmff_gamma_0_factor_start")
    p.add_argument("--num_confs", type=int, default=128)
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--atom_crop_size", type=int, default=None)
    p.add_argument("--pocket_type", default="atom", choices=["atom", "ca"])
    p.add_argument("--pocket_cutoff", type=float, default=10.0)
    p.add_argument("--pocket_dist_type", default="ligand", choices=["ligand", "ligand_centre"])
    p.add_argument("--use_pocket", action="store_true")
    p.add_argument("--use_key_res", action="store_true")
    p.add_argument("--key_res_random_mask_ratio", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=1000.0)
    p.add_argument("--enable_ranking", action="store_true")
    p.add_argument("--enable_sidechain_relaxation", action="store_true",
                   help="relax every pose in the receptor's restraint field before ranking "
                        "(infer/relax.py)")
    p.add_argument("--align_mode", default="pocket_ca",
                   help="accepted and stored, as in the JAX CLI; poses align on the pocket CAs")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--feat_cache_dir", default=None,
                   help="disk-cache featurized systems here (keyed by system content hash + "
                        "config; on CUDA, where the featurizer worker's code loads every system)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ebable_x_gt_ligand_as_ref_pos", action="store_true",
                   help="GT-conformer ablation (reference redocking.py:79-82)")
    p.add_argument("--smiles_protonate_ph", type=float, default=-1.0,
                   help="assign physiological-pH formal charges to SMILES ligands "
                        "(e.g. 7.4); <0 = off")
    p.add_argument("--smiles_canonical_tautomer", action="store_true",
                   help="canonicalize SMILES ligand tautomers before embedding")
    p.add_argument("--enable_confidence", action="store_true",
                   help="score poses with the trained confidence head (pLDDT/PAE/pTM/ipTM "
                        "per pose, confidence.json; needs --params trained with the head)")
    p.add_argument("--confidence_ranking", action="store_true",
                   help="rank poses by 0.8*ipTM + 0.2*pTM - has_clash instead of geometric "
                        "KMeans medoids (implies --enable_confidence)")


def build_pipeline(args):
    """The CLI's DockingPipeline."""
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.ccd import CCDLibrary
    from physdock_tpu_torch.data.feat_worker import FeaturizerWorker
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.infer.pipeline import (
        DockingPipeline,
        SamplerSettings,
        resolve_device,
    )

    device = resolve_device(args.device)
    cfg = PhysDockConfig.named(
        args.model_name,
        crop_size=args.crop_size,
        atom_crop_size=args.atom_crop_size or (args.crop_size * 8 if args.crop_size else None),
        bf16=args.bf16,
        infer_pocket_type=args.pocket_type,
        infer_pocket_cutoff=args.pocket_cutoff,
        infer_pocket_dist_type=args.pocket_dist_type,
        infer_use_pocket=args.use_pocket,
        infer_use_key_res=args.use_key_res,
        key_res_random_mask_ratio=args.key_res_random_mask_ratio,
        smiles_protonate_ph=args.smiles_protonate_ph,
        smiles_canonical_tautomer=args.smiles_canonical_tautomer,
    )
    fz_kwargs = dict(
        ccd=CCDLibrary(args.ccd_blob) if args.ccd_blob else None,
        msa_features_dir=args.msa_features_dir,
        uniprot_msa_features_dir=args.uniprot_msa_features_dir,
        inference_mode=True,
        seed=args.seed,
        use_x_gt_ligand_as_ref_pos=args.ebable_x_gt_ligand_as_ref_pos,
    )
    want_confidence = args.enable_confidence or args.confidence_ranking
    if device.type == "cuda":
        # the card's process docks while the worker featurizes the next
        # system and post-processes the last one
        featurizer = FeaturizerWorker(cfg.data, cache_dir=args.feat_cache_dir, **fz_kwargs)
    else:
        featurizer = SystemFeaturizer(cfg.data, **fz_kwargs)
    settings = SamplerSettings(
        max_samples=args.max_samples,
        num_samples_per_round=args.num_samples_per_round,
        max_rounds=args.max_rounds,
        steps=args.steps,
        enable_physics_correction=args.enable_physics_correction,
        mmff_iters=args.mmff_iters,
        eta=args.eta,
        num_confs=args.num_confs,
        rho=args.rho,
        enable_ranking=args.enable_ranking,
        enable_sidechain_relaxation=args.enable_sidechain_relaxation,
        align_mode=args.align_mode,
        seed=args.seed,
        enable_confidence=want_confidence,
        confidence_ranking=args.confidence_ranking,
    )
    model = load_model(args.params, cfg, seed=args.seed, with_confidence=want_confidence)
    return DockingPipeline(cfg, model, featurizer, settings, device=device)


def load_model(path: Optional[str], cfg, seed: int = 0, with_confidence: bool = False,
               ckpt=None):
    """PhysDock in `cfg`'s compute dtype, with the confidence head when
    asked, with weights from `path` (`model/import_weights.load_weights`:
    a JAX `.npz`, the EMA of a train-state `.pt`, or a reference
    `params.pt` in any of its layouts; `ckpt`, the file already read), or
    random weights from `seed` when no path is given. Every key is used
    exactly once; a file's confidence head is left unused, and counted, by
    a model without one, as the JAX CLI allows; a model with the head
    raises ValueError on a file without it."""
    from physdock_tpu_torch.model.import_weights import load_weights
    from physdock_tpu_torch.model.physdock import PhysDock

    gen = torch.Generator().manual_seed(seed)
    model = PhysDock(cfg.model, dtype=cfg.dtypes.compute_dtype, generator=gen,
                     with_confidence=with_confidence)
    if path is not None:
        counts = load_weights(model, path, ckpt)
        if counts["unused_head_keys"]:
            print(f"[params] {path}: {counts['unused_head_keys']} confidence-head arrays "
                  f"({counts['unused_head_params']} parameters) unused: the model has no "
                  f"head (--enable_confidence builds it)", flush=True)
    return model
