"""Guided redocking pipeline (port of `physdock_tpu/infer/pipeline.py`:
`DockingPipeline.dock`, `_dock_loaded`, `_build_guidance`, `_postprocess`).

Host-side orchestration around the model on one device: featurize in
process, run the round loop (trunk -> EDM sampler with physics guidance ->
chirality accept/reject, `infer/rounds.RoundProtocol`), then align to the
GT pocket frame, rank and write PDB/SDF.  The round loop calls the trunk
and the sampler directly.  Not ported here: `dock_many`, screening,
confidence scoring, side-chain relaxation and the pose-check report.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data.embed import generate_conformers
from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from physdock_tpu_torch.infer import ranking as ranking_lib
from physdock_tpu_torch.infer import writers
from physdock_tpu_torch.infer.rounds import RoundProtocol, pairwise
from physdock_tpu_torch.model.compact import compact_batch_np, compact_msa_np
from physdock_tpu_torch.model.diffusion import PhysicsGuidance, sample_diffusion
from physdock_tpu_torch.model.forcefield import build_ligand_ff, chirality_correct
from physdock_tpu_torch.model.physdock import PhysDock
from physdock_tpu_torch.utils.io import dump_json


@dataclasses.dataclass
class SamplerSettings:
    """Flag surface of the reference CLIs (redocking.py:460-487)."""

    max_samples: int = 5
    num_samples_per_round: int = 5
    max_rounds: int = 10
    steps: int = 40
    enable_physics_correction: bool = False
    mmff_iters: int = 5
    eta: float = 6.0  # mmff_gamma_0_factor_start
    num_confs: int = 128
    rho: float = 1000.0
    gamma_0: float = 0.8
    gamma_min: float = 1.0
    noise_scale_lambda: float = 1.003
    step_scale_eta: float = 1.5
    enable_ranking: bool = True
    seed: int = 0


def resolve_device(device: Optional[str]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU; raises when CUDA was wanted and there is none."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def arrays_to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host feature arrays as tensors on `device` (float64 narrowed to fp32)."""
    out = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        out[k] = torch.as_tensor(a, device=device)
    return out


class DockingPipeline:
    def __init__(self, config: PhysDockConfig, model: PhysDock, featurizer: SystemFeaturizer,
                 settings: Optional[SamplerSettings] = None, device=None):
        self.config = config
        self.s = settings or SamplerSettings()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.featurizer = featurizer

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return arrays_to_device(arrays, self.device)

    def _build_guidance(self, batch, meta):
        """Returns (PhysicsGuidance template, original conformer bank); the
        guidance's conformer arrays are bank-shaped ([max_samples, L, ...])
        and are swapped per round."""
        mol = meta.get("ref_mol")
        lig_idx = np.asarray(meta["ligand_atom_idx"])
        if mol is None or len(lig_idx) == 0 or mol.num_atoms != len(lig_idx):
            return None, None
        confs = generate_conformers(
            mol, num_confs=self.s.num_confs, base_coords=mol.coords,
            rng=np.random.default_rng(self.s.seed),
        )
        ff = build_ligand_ff(
            mol.atomic_numbers.tolist(),
            [(i, j) for i, j, _ in mol.bonds],
            confs[0],
            chiral_centers=mol.chiral_centers(),
            # E/Z stereo pairs stay rigid through FF relaxation
            rigid_14=[
                (min(a, b), max(a, b))
                for a, _, _, b, _ in getattr(mol, "stereo_bonds", None) or []
            ],
            device=self.device,
        )
        n_atoms = batch["ref_pos"].shape[-2]
        L = mol.num_atoms
        idx = np.full(L, n_atoms, np.int64)  # pad -> out-of-range (dropped)
        idx[: len(lig_idx)] = lig_idx
        K = self.s.max_samples
        dev = self.device
        guidance = PhysicsGuidance(
            ligand_idx=torch.as_tensor(idx, device=dev),
            ligand_mask=torch.ones(L, device=dev),
            conf_pos=torch.zeros((K, L, 3), device=dev),
            conf_dists=torch.zeros((K, L, L), device=dev),
            conf_mask=torch.zeros((K,), device=dev),
            ff=ff,
        )
        return guidance, confs

    def dock(self, system, output_dir: str, remove_ligand: bool = False,
             smi: Optional[str] = None, ligand_sdf: Optional[str] = None,
             write_outputs: bool = True) -> Dict:
        """Dock one system. Returns a result dict with poses' ranking, RMSD
        vs GT and timings."""
        t_start = time.time()
        loaded = self.featurizer.load(
            system, remove_ligand=remove_ligand, smi=smi, ligand_sdf=ligand_sdf,
            num_msa_rounds=max(1, self.s.max_rounds),
        )
        return self._dock_loaded(loaded, output_dir, remove_ligand=remove_ligand, smi=smi,
                                 write_outputs=write_outputs, t_start=t_start)

    @torch.no_grad()
    def _dock_loaded(self, loaded, output_dir: str, *, remove_ligand: bool,
                     smi: Optional[str], write_outputs: bool, t_start: float) -> Dict:
        s = self.s
        feats, meta = loaded
        t_loaded = time.time()
        batch = self._to_device(compact_batch_np(feats))
        batch_msa_feat = meta.pop("batch_msa_feat", None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_upload = time.time()
        guidance, conf_bank = (
            self._build_guidance(batch, meta) if s.enable_physics_correction else (None, None)
        )
        guided = guidance is not None
        lig_idx = np.asarray(meta["ligand_atom_idx"])
        x_gt = np.asarray(feats["x_gt"])
        gen = torch.Generator(device=self.device).manual_seed(s.seed)

        protocol = None
        if guided:
            gt_lig = None
            if self.featurizer.use_x_gt_ligand_as_ref_pos:
                gt_lig = x_gt[lig_idx]
            protocol = RoundProtocol(conf_bank, max_samples=s.max_samples,
                                     num_samples_per_round=s.num_samples_per_round,
                                     eta_start=s.eta, gt_ligand=gt_lig)
        t_feat = time.time() - t_start
        timings = {
            "load_s": round(t_loaded - t_start, 3),
            "upload_s": round(t_upload - t_loaded, 3),
            "guidance_s": round(time.time() - t_upload, 3),
        }
        rounds_run = 0
        x = None
        conditioning = None
        for rnd in range(s.max_rounds if guided else 1):
            rounds_run += 1
            if batch_msa_feat is not None:
                # MSA clusters resampled per round: recompute the trunk
                c = compact_msa_np(batch_msa_feat[rnd % len(batch_msa_feat)])
                batch["msa_tok_c"] = torch.as_tensor(c["msa_tok_c"], device=self.device)
                batch["msa_del_c"] = torch.as_tensor(c["msa_del_c"], device=self.device)
                conditioning = None
            if conditioning is None:
                conditioning = self.model.conditioning(batch)
            # round 0: unguided at high sigma; FF relaxation at low sigma stays on
            bank = protocol.bank(rnd) if guided else None
            if bank is not None:
                pos, mask = bank
                g = dataclasses.replace(
                    guidance,
                    conf_pos=torch.as_tensor(pos, device=self.device),
                    conf_dists=torch.as_tensor(pairwise(pos), device=self.device),
                    conf_mask=torch.as_tensor(mask, device=self.device),
                )
                use_bank = True
            else:
                g, use_bank = guidance, False
            x_t = sample_diffusion(
                self.model, batch, generator=gen, num_sample=s.num_samples_per_round,
                steps=s.steps, gamma_0=s.gamma_0, gamma_min=s.gamma_min,
                noise_scale_lambda=s.noise_scale_lambda, step_scale_eta=s.step_scale_eta,
                karras_rho=s.rho, guidance=g,
                mmff_gamma_0_factor=protocol.factor if guided else s.eta,
                mmff_iters=s.mmff_iters, align_ref_pos=use_bank, conditioning=conditioning,
            )
            if g is not None and g.ff is not None:
                lig = x_t[:, g.ligand_idx.clamp(max=x_t.shape[-2] - 1)]
                ok = chirality_correct(lig, g.ff)
            else:
                ok = torch.ones((x_t.shape[0],), dtype=torch.bool)
            x, ok = x_t.float().cpu().numpy(), ok.cpu().numpy()
            if not guided:
                break
            protocol.update(x, x[:, lig_idx], ok)
            if protocol.done:
                break
        poses = protocol.final_poses() if guided else x[: s.max_samples]
        timings["rounds_s"] = round(time.time() - t_start - t_feat, 3)
        res = self._postprocess(feats, meta, poses, output_dir, remove_ligand=remove_ligand,
                                smi=smi, rounds_run=rounds_run, t_feat=t_feat,
                                t_start=t_start, write_outputs=write_outputs)
        res["timings"] = timings
        return res

    def _postprocess(self, feats, meta, poses: np.ndarray, output_dir: str, *,
                     remove_ligand: bool, smi: Optional[str], rounds_run: int,
                     t_feat: float, t_start: float, write_outputs: bool) -> Dict:
        """Align to the GT pocket-CA frame, rank, score and write outputs
        (redocking.py:341-447)."""
        lig_idx = np.asarray(meta["ligand_atom_idx"])
        x_gt = np.asarray(feats["x_gt"])
        aligned, order, lig_rmsds = ranking_lib.postprocess_poses(
            poses, x_gt,
            lig_idx=lig_idx,
            centre_ids=np.asarray(feats["token_id_to_centre_atom_id"]),
            pocket_res=np.asarray(feats["pocket_res_feat"]),
            is_protein=np.asarray(feats["is_protein"]),
            s_mask=np.asarray(feats["s_mask"]),
            a_mask=np.asarray(feats["a_mask"]),
            enable_ranking=self.s.enable_ranking,
            compute_rmsd=bool(len(lig_idx)) and not remove_ligand and smi is None,
        )
        result = {
            "system_id": meta["system_id"],
            "num_poses": len(aligned),
            "rank_order": order,
            "top5_rmsd": lig_rmsds[:5] if lig_rmsds else None,
            "all_rmsd": lig_rmsds,
            "rounds": rounds_run,
            "feat_time_s": round(t_feat, 3),
            "total_time_s": round(time.time() - t_start, 3),
            "n_atoms_padded": int(np.shape(feats["ref_pos"])[-2]),
            "n_tokens_padded": int(np.shape(feats["s_mask"])[-1]),
        }
        if write_outputs:
            os.makedirs(output_dir, exist_ok=True)
            writers.write_pdb(x_gt, meta, os.path.join(output_dir, "gt.pdb"))
            for rank, idx in enumerate(order[:5]):
                writers.write_pdb(aligned[idx], meta,
                                  os.path.join(output_dir, f"pred_rank{rank}.pdb"))
                if len(lig_idx):
                    writers.write_ligand_sdf(
                        aligned[idx], meta, os.path.join(output_dir, f"ligand_rank{rank}.sdf"),
                        name=f"{meta['system_id']}_rank{rank}")
            if lig_rmsds:
                dump_json({"top5_rmsd": lig_rmsds[:5], "rank_order": order},
                          os.path.join(output_dir, "top5_rmsd.json"))
        return result
