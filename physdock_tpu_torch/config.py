"""Configuration for the PyTorch port of PhysDock.

The presets, `ModelConfig`, `DataConfig` and `LossConfig` are the JAX
package's (`physdock_tpu/config.py`) unchanged, so a checkpoint trained
there lines up here; `DTypePolicy` names torch dtypes.  The module imports
torch only when a `DTypePolicy` is made, so the host-only featurizer
worker (`data/feat_worker.py`), which unpickles a `DataConfig`, starts
without it.
"""

from __future__ import annotations

import dataclasses

# Block-count presets: (atom, evoformer, pairformer, dit, heads)
# (reference: PhysDock/configs.py:65-96)
model_presets = {
    "toy": (2, 2, 2, 2, 2),
    "tiny": (2, 2, 8, 4, 2),
    "small": (2, 3, 16, 8, 2),
    "medium": (3, 4, 24, 12, 3),
    "full": (3, 4, 48, 24, 4),
}


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: params are stored in `param_dtype`, matmuls
    run in `compute_dtype`; normalizations, softmax statistics and SVD
    always run in fp32."""

    param_dtype: torch.dtype = None  # None: torch.float32
    compute_dtype: torch.dtype = None

    def __post_init__(self):
        import torch

        for name in ("param_dtype", "compute_dtype"):
            if getattr(self, name) is None:
                object.__setattr__(self, name, torch.float32)

    @classmethod
    def bf16(cls) -> "DTypePolicy":
        import torch

        return cls(param_dtype=torch.float32, compute_dtype=torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference: PhysDock/configs.py:52-148)."""

    # feature dims
    ref_dim: int = 167
    target_dim: int = 65
    msa_dim: int = 34
    templ_dim: int = 40
    # channel dims
    c_m: int = 256
    c_s: int = 512
    c_z: int = 128
    c_a: int = 128
    c_ap: int = 16
    # block counts
    no_blocks_atom: int = 3
    no_blocks_evoformer: int = 4
    no_blocks_pairformer: int = 24
    no_blocks_dit: int = 12
    no_blocks_heads: int = 3
    no_blocks_template: int = 2
    # numerics
    inf: float = 1e9
    eps: float = 1e-8
    sigma_data: float = 16.0
    # diffusion training
    num_augmentation_sample: int = 48
    # distogram head
    no_distogram_bins: int = 39
    # training-era options (reference configs_old.py:4-47; release defaults).
    # configs_old also names atom_attention_type="spatial"/interaction_aware,
    # but the RELEASED reference model contains no code implementing either
    # (grep of PhysDock/models/ finds nothing) — they configure an unshipped
    # training-era architecture, so they are deliberately NOT config surface
    # here (a flag nothing reads is a latent parity bug).
    num_recycles: int = 0
    use_mini_rollout: bool = False
    mini_rollout_steps: int = 12  # train.sh:111

    @classmethod
    def preset(cls, name: str, **overrides) -> "ModelConfig":
        a, e, p, d, h = model_presets[name]
        return cls(
            no_blocks_atom=a,
            no_blocks_evoformer=e,
            no_blocks_pairformer=p,
            no_blocks_dit=d,
            no_blocks_heads=h,
            **overrides,
        )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Featurization config (reference: PhysDock/configs.py:101-111)."""

    crop_size: int = 256
    atom_crop_size: int = 2048
    max_msa_seqs: int = 16384
    max_uniprot_msa_seqs: int = 8192
    interface_threshold: float = 15.0
    token_bond_threshold: float = 2.4
    covalent_bond_threshold: float = 1.8
    max_msa_clusters: int = 128
    resample_msa_in_recycling: bool = True
    key_res_random_mask_ratio: float = 0.5

    # inference pocket conditioning (reference: configs.py:22-27)
    infer_pocket_type: str = "atom"  # "atom" | "ca"
    infer_pocket_cutoff: float = 6.0
    infer_pocket_dist_type: str = "ligand"  # "ligand" | "ligand_centre"
    infer_use_pocket: bool = True
    infer_use_key_res: bool = True

    # training-time augmentation ratios (reference: configs.py:29-44)
    train_pocket_type_atom_ratio: float = 0.5
    train_pocket_cutoff_ligand_min: float = 6.0
    train_pocket_cutoff_ligand_max: float = 12.0
    train_pocket_cutoff_ligand_centre_min: float = 10.0
    train_pocket_cutoff_ligand_centre_max: float = 16.0
    train_pocket_dist_type_ligand_ratio: float = 0.5
    train_use_pocket_ratio: float = 0.5
    train_use_key_res_ratio: float = 0.5
    train_shuffle_sym_id: bool = True
    train_spatial_crop_ligand_ratio: float = 0.2
    train_spatial_crop_interface_ratio: float = 0.4
    train_spatial_crop_interface_threshold: float = 15.0
    train_chirality_augmentation_ratio: float = 0.1
    train_use_template_ratio: float = 0.75
    train_template_mask_max_ratio: float = 0.4

    # SMILES ligand-prep extensions (data/protomers.py). The reference
    # relies on RDKit parse-time sanitization only (tools/rdkit.py:14-28),
    # so both default off; hypervalent charge-separation (the RDKit
    # cleanup equivalent) is always on in the parser.
    smiles_protonate_ph: float = -1.0  # <0 = off; e.g. 7.4
    smiles_canonical_tautomer: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference: PhysDock/configs.py:152-193)."""

    alpha_diffusion: float = 4.0
    alpha_confidence: float = 1e-4
    alpha_bond: float = 0.0
    alpha_distogram: float = 3e-2
    alpha_pae: float = 0.0
    # weighted MSE
    alpha_dna: float = 5.0
    alpha_rna: float = 5.0
    alpha_ligand: float = 10.0
    # smooth lDDT
    max_clamp_distance: float = 15.0
    # distogram bins
    distogram_min_bin: float = 3.25
    distogram_max_bin: float = 50.75
    distogram_no_bins: int = 39
    # confidence bins
    plddt_no_bins: int = 50
    pde_min_bin: float = 0.0
    pde_max_bin: float = 32.0
    pde_no_bins: int = 64
    pae_min_bin: float = 0.0
    pae_max_bin: float = 32.0
    pae_no_bins: int = 64
    eps: float = 1e-9


@dataclasses.dataclass(frozen=True)
class PhysDockConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    dtypes: DTypePolicy = dataclasses.field(default_factory=DTypePolicy)
    inference_mode: bool = True

    @classmethod
    def named(
        cls,
        model_name: str = "medium",
        *,
        crop_size: int = 256,
        atom_crop_size: int = 2048,
        bf16: bool = False,
        inference_mode: bool = True,
        num_augmentation_sample: int = 48,
        **data_overrides,
    ) -> "PhysDockConfig":
        return cls(
            model=ModelConfig.preset(
                model_name, num_augmentation_sample=num_augmentation_sample
            ),
            data=DataConfig(
                crop_size=crop_size, atom_crop_size=atom_crop_size, **data_overrides
            ),
            dtypes=DTypePolicy.bf16() if bf16 else DTypePolicy(),
            inference_mode=inference_mode,
        )

    def replace(self, **kw) -> "PhysDockConfig":
        return dataclasses.replace(self, **kw)
