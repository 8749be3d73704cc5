"""System featurization: system pkl -> static-shaped device feature batch.

Re-implementation of the reference's FeatureLoader
(PhysDock/data/feature_loader.py:1004-1173 `load` and its stages), restructured
as a pipeline of pure stage functions over an explicit numpy RNG (the
reference uses global `random`/`np.random` state).  Differences by design:

  * ligand chemistry comes from a CCDLibrary that can be *generated*
    (standard residues, SDF/SMILES ligands, or inline metadata stored in the
    system pkl by our generate_system) instead of the reference's missing
    binary blob;
  * inference batches are ALWAYS padded to a static (crop_size,
    atom_crop_size) bucket — TPU static shapes (the reference pads train
    only, feature_loader.py:913-942);
  * all randomness (pocket sampling, MSA resampling, key-res masking,
    ref-pos augmentation) is driven by a passed-in np.random.Generator.

System pkl schema (generate_system; matches the reference demo files):
  {chain_id: {all_atom_positions: list[[n_i,3] f32], all_atom_mask:
  list[[n_i] i8], ccds: list[str], <6 PLIP channels>: [n_res] i8, optional
  "ligand_meta": CCD entry dict for non-standard single-conformer chains}}
  Digit chain ids are ligands.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from physdock_tpu_torch.config import DataConfig
from physdock_tpu_torch.data import msa_pairing
from physdock_tpu_torch.data.ccd import (
    CCDLibrary,
    assemble_ref_feat,
    assemble_rel_tok_feat,
    entry_from_positions,
    ligand_entry,
)
from physdock_tpu_torch.data.constants import restypes as rc
from physdock_tpu_torch.data.constants.periodic_table import element_symbol
from physdock_tpu_torch.utils.geometry import random_rigid_transform_np
from physdock_tpu_torch.utils.io import load_pkl, protein_msa_key

PLIP_CHANNELS = [
    "salt bridges",
    "pi-cation interactions",
    "hydrophobic interactions",
    "pi-stacking",
    "hydrogen bonds",
    "metal complexes",
]


@dataclasses.dataclass
class ChainData:
    chain_id: str
    chain_class: str  # "protein" | "ligand"
    ccds: List[str]
    x_gt: np.ndarray  # [n_atoms, 3]
    conf_atom_idx: np.ndarray  # [n_atoms] index into CCD entry atoms
    chunk_sizes: np.ndarray  # [n_conf]
    residue_index: np.ndarray  # [n_conf]
    restype: np.ndarray  # [n_conf]
    key_res_feat: np.ndarray  # [n_conf, 7]
    is_key_res: np.ndarray  # [n_conf]
    pocket_res_feat: np.ndarray  # [n_conf]
    is_protein: np.ndarray
    is_ligand: np.ndarray
    is_short_poly: np.ndarray
    msa: np.ndarray  # [N, n_conf]
    deletion_matrix: np.ndarray
    msa_all_seq: Optional[np.ndarray] = None
    deletion_matrix_all_seq: Optional[np.ndarray] = None
    msa_species_identifiers_all_seq: Optional[np.ndarray] = None
    seq3: str = ""
    asym_id: int = 0
    sym_id: int = 0
    entity_id: int = 0


class SystemFeaturizer:
    """Featurize prepared systems for inference or training."""

    def __init__(
        self,
        config: Optional[DataConfig] = None,
        ccd: Optional[CCDLibrary] = None,
        msa_features_dir: Optional[str] = None,
        uniprot_msa_features_dir: Optional[str] = None,
        inference_mode: bool = True,
        seed: Optional[int] = None,
        pad_to_bucket: bool = True,
        use_x_gt_ligand_as_ref_pos: bool = False,
    ):
        self.cfg = config or DataConfig()
        self.ccd = ccd or CCDLibrary()
        self.msa_features_dir = msa_features_dir
        self.uniprot_msa_features_dir = uniprot_msa_features_dir
        self.inference_mode = inference_mode
        self.seed = 0 if seed is None else int(seed)
        self.rng = np.random.default_rng(seed)
        self.pad_to_bucket = pad_to_bucket
        # GT-conformer ablation (reference redocking.py:79-82,
        # feature_loader.py:720-723): ligand ref_pos = centred GT coords
        self.use_x_gt_ligand_as_ref_pos = use_x_gt_ligand_as_ref_pos
        self.missing_msa: List[Tuple[str, str]] = []  # (md5, sequence)

    # ------------------------------------------------------------------ load

    def load(
        self,
        system,  # path to pkl(.gz) or the loaded dict
        remove_ligand: bool = False,
        remove_receptor: bool = False,
        smi: Optional[str] = None,
        ligand_mol=None,
        ligand_sdf: Optional[str] = None,
        rng: Optional[np.random.Generator] = None,
        num_msa_rounds: int = 1,
    ) -> Tuple[Dict[str, np.ndarray], Dict]:
        system_id = "system"
        if isinstance(system, str):
            system_id = os.path.basename(system).replace(".pkl.gz", "").replace(".pkl", "")
            system = load_pkl(system)
        if rng is None:
            if self.inference_mode:
                # INFERENCE IS DETERMINISTIC PER (seed, system): a fresh
                # per-load generator makes features independent of load
                # order / call count, so repeated loads, the worker's disk
                # cache (hit == recompute), and train-then-dock closed
                # loops all see identical draws.  A shared mutable stream
                # here is how the round-3 overfit gate silently evaluated
                # on features the model had never seen.
                h = hashlib.md5(
                    f"{self.seed}:{system_id}".encode()
                ).digest()
                rng = np.random.default_rng(
                    np.frombuffer(h, dtype=np.uint64)
                )
            else:
                # training keeps the persistent stream: every epoch must
                # see fresh crops / MSA resamples / augmentations
                rng = self.rng
        receptor_ids = [c for c in system if not c.isdigit()]
        ligand_ids = [c for c in system if c.isdigit()]

        pocket_cfg = self._sample_pocket_config(rng)

        chains: Dict[str, Dict] = {}
        if not remove_receptor:
            for cid in receptor_ids:
                chain = dict(system[cid])
                chain["pocket_res_feat"] = self._pocket_feature(
                    system, cid, ligand_ids, pocket_cfg
                )
                chains[cid] = chain

        ref_mol = None
        if remove_ligand or ligand_mol is not None or smi is not None or ligand_sdf:
            if smi is not None:
                from physdock_tpu_torch.data.smiles import mol_from_smiles

                ph = getattr(self.cfg, "smiles_protonate_ph", -1.0)
                ligand_mol = mol_from_smiles(
                    smi,
                    protonate_ph=None if ph is None or ph < 0 else ph,
                    canonical_tautomer=getattr(
                        self.cfg, "smiles_canonical_tautomer", False
                    ),
                )
            elif ligand_sdf is not None:
                from physdock_tpu_torch.data.mol import read_sdf

                ligand_mol = read_sdf(ligand_sdf)
            if ligand_mol is not None:
                entry = ligand_entry(ligand_mol)
                self.ccd.register_ligand("XXX", entry)
                ref_mol = ligand_mol
                n = ligand_mol.num_atoms
                x = ligand_mol.coords
                chains["99"] = {
                    "all_atom_positions": [np.asarray(x, np.float32)],
                    "all_atom_mask": [np.ones(n, np.int8)],
                    "ccds": ["XXX"],
                }
        else:
            for cid in ligand_ids:
                chain = dict(system[cid])
                chains[cid] = chain
                # inline ligand metadata (our generate_system) or CCD lookup
                for rid, ccd in enumerate(chain["ccds"]):
                    if rc.is_standard(ccd):
                        continue
                    # Registered generic-code entries (e.g. "LIG") are
                    # scoped by a content hash of the GT coordinates they
                    # belong to: two different ligands sharing a code —
                    # even with the SAME atom count — never reuse each
                    # other's chemistry (ADVICE r4 medium).
                    pos_key = hashlib.md5(
                        np.ascontiguousarray(
                            np.asarray(
                                chain["all_atom_positions"][rid], np.float32
                            )
                        ).tobytes()
                    ).hexdigest()
                    if "ligand_meta" in chain:
                        # Inline meta is authoritative for THIS system:
                        # always (re-)register, stamped with this system's
                        # coordinate hash so later meta-less systems
                        # reusing the code are detected below.
                        entry = dict(chain["ligand_meta"])
                        entry["_pos_key"] = pos_key
                        self.ccd.register_ligand(ccd, entry)
                        continue
                    if self.ccd.is_external(ccd):
                        # authoritative blob entry — never shadow it with
                        # coordinate-perceived chemistry, and drop any
                        # same-code shadow a previous system's inline meta
                        # left behind (ADVICE r4 low)
                        self.ccd.unregister_ligand(ccd)
                        continue
                    if (
                        ccd in self.ccd
                        and self.ccd[ccd].get("_pos_key") != pos_key
                    ):
                        logging.warning(
                            "CCD %r cached for different coordinates — "
                            "re-perceiving (same-code collision across "
                            "systems)",
                            ccd,
                        )
                        entry = entry_from_positions(
                            ccd,
                            np.asarray(
                                chain["all_atom_positions"][rid],
                                np.float32,
                            ),
                            seed=self.seed,
                        )
                        entry["_pos_key"] = pos_key
                        self.ccd.register_ligand(ccd, entry)
                    if ccd not in self.ccd:
                        # reference-prepped pkl whose CCD metadata blob is
                        # unavailable: reconstruct approximate chemistry
                        # from the GT coordinates (data/ccd.py)
                        logging.warning(
                            "CCD %r unknown — perceiving chemistry from "
                            "coordinates (98%% exact bond-order/aromatic/"
                            "chirality round-trip with known elements, "
                            "tests/test_chem_roundtrip.py; element "
                            "inference itself is heuristic — provide "
                            "--ligand_sdf/--ligand_smi/--ccd_blob for "
                            "exact chemistry)",
                            ccd,
                        )
                        entry = entry_from_positions(
                            ccd,
                            np.asarray(
                                chain["all_atom_positions"][rid],
                                np.float32,
                            ),
                            seed=self.seed,
                        )
                        entry["_pos_key"] = pos_key
                        self.ccd.register_ligand(ccd, entry)
                if len(ligand_ids) == 1 and len(chain["ccds"]) == 1:
                    try:
                        ref_mol = self.ccd[chain["ccds"][0]].get("ref_mol")
                    except KeyError:
                        ref_mol = None

        use_pocket, use_key_res = pocket_cfg["use_pocket"], pocket_cfg["use_key_res"]
        chain_data = [
            self._chain_data(cid, chains[cid], use_pocket, use_key_res, rng)
            for cid in chains
        ]
        chain_data = [c for c in chain_data if len(c.ccds) > 0]
        self._assign_assembly(chain_data, rng)

        if self.cfg.crop_size is not None:
            chain_data = self._spatial_crop(chain_data, rng)

        feats, meta = self._merge(chain_data, rng)
        meta["system_id"] = system_id
        meta["ref_mol"] = ref_mol
        feats = self._finalize(feats, rng, num_msa_rounds=num_msa_rounds)
        batch_msa_feat = feats.pop("batch_msa_feat", None)
        if self.pad_to_bucket and self.inference_mode:
            n_tok0 = len(feats["s_mask"])
            feats = self._pad(feats)
            if batch_msa_feat is not None:
                dt = len(feats["s_mask"]) - n_tok0
                if dt:
                    batch_msa_feat = np.pad(
                        batch_msa_feat, ((0, 0), (0, 0), (0, dt), (0, 0))
                    )
        if batch_msa_feat is not None:
            # per-round MSA cluster resampling (redocking.py:187-188);
            # kept in meta (host-side), swapped into the batch each round
            meta["batch_msa_feat"] = batch_msa_feat
        return feats, meta

    # ----------------------------------------------------------- stage: pocket

    def _sample_pocket_config(self, rng) -> Dict:
        c = self.cfg
        if self.inference_mode:
            return dict(
                pocket_type=c.infer_pocket_type,
                cutoff=c.infer_pocket_cutoff,
                dist_type=c.infer_pocket_dist_type,
                use_pocket=c.infer_use_pocket,
                use_key_res=c.infer_use_key_res,
            )
        # training-time sampling (feature_loader.py:1023-1040)
        pocket_type = "atom" if rng.random() < c.train_pocket_type_atom_ratio else "ca"
        dist_type = (
            "ligand"
            if rng.random() < c.train_pocket_dist_type_ligand_ratio
            else "ligand_centre"
        )
        if dist_type == "ligand":
            cutoff = rng.uniform(
                c.train_pocket_cutoff_ligand_min, c.train_pocket_cutoff_ligand_max
            )
        else:
            cutoff = rng.uniform(
                c.train_pocket_cutoff_ligand_centre_min,
                c.train_pocket_cutoff_ligand_centre_max,
            )
        return dict(
            pocket_type=pocket_type,
            cutoff=cutoff,
            dist_type=dist_type,
            use_pocket=rng.random() < c.train_use_pocket_ratio,
            use_key_res=rng.random() < c.train_use_key_res_ratio,
        )

    def _pocket_feature(self, system, receptor_id, ligand_ids, pocket_cfg) -> np.ndarray:
        """Pocket residues from GT receptor-ligand distances
        (feature_loader.py:1066-1110)."""
        chain = system[receptor_id]
        ccds = chain["ccds"]
        out = np.zeros(len(ccds), np.float32)
        if not ligand_ids:
            return out
        rec_xyz, rec_res = [], []
        for rid, (ccd, pos, mask) in enumerate(
            zip(ccds, chain["all_atom_positions"], chain["all_atom_mask"])
        ):
            if not rc.is_standard(ccd):
                continue
            m = np.asarray(mask, bool)
            if len(m) < 2 or not m[1]:  # CA must exist
                continue
            if pocket_cfg["pocket_type"] == "atom":
                rec_xyz.append(np.asarray(pos)[m])
                rec_res += [rid] * int(m.sum())
            else:
                rec_xyz.append(np.asarray(pos)[1][None])
                rec_res.append(rid)
        if not rec_xyz:
            return out
        rec_xyz = np.concatenate(rec_xyz, 0)
        rec_res = np.asarray(rec_res)
        hit = set()
        for lid in ligand_ids:
            lx = np.concatenate(system[lid]["all_atom_positions"], 0)
            lm = np.concatenate(system[lid]["all_atom_mask"], 0).astype(bool)
            lx = lx[lm]
            if pocket_cfg["dist_type"] == "ligand_centre":
                lx = np.min(lx, axis=0, keepdims=True)
            d = np.linalg.norm(rec_xyz[:, None] - lx[None], axis=-1)
            close = np.any(d < pocket_cfg["cutoff"], axis=-1)
            hit.update(rec_res[close].tolist())
        out[sorted(hit)] = 1.0
        return out

    # ------------------------------------------------------------ stage: chain

    def _chain_data(self, chain_id, chain, use_pocket, use_key_res, rng) -> ChainData:
        ccds = list(chain["ccds"])
        chain_class = "ligand" if chain_id.isdigit() else "protein"
        n_res = len(ccds)

        # key-res features: 6 PLIP channels + zero channel, random-masked
        # (feature_loader.py:216-234 — masking applies at inference too)
        if use_key_res and PLIP_CHANNELS[0] in chain:
            kr = np.stack(
                [np.asarray(chain[ch], np.float32) for ch in PLIP_CHANNELS]
                + [np.zeros(n_res, np.float32)],
                axis=-1,
            )
        else:
            kr = np.zeros((n_res, 7), np.float32)
        is_key_res = np.any(kr > 0, axis=-1).astype(np.float32)
        kr = kr * (rng.random((n_res, 7)) > self.cfg.key_res_random_mask_ratio)

        pocket = (
            np.asarray(chain["pocket_res_feat"], np.float32)
            if use_pocket and "pocket_res_feat" in chain
            else np.zeros(n_res, np.float32)
        )

        # MSA
        if chain_class == "protein":
            msa_feats = self._protein_msa(ccds)
        else:
            row = np.array([[rc.restype_order(c) for c in ccds]] * 2, np.int8)
            msa_feats = {"msa": row, "deletion_matrix": np.zeros_like(row)}

        # conformer-exists filtering (feature_loader.py:246-280)
        keep, x_gt, conf_atom_idx, chunk, res_idx, restype, kept_ccds = (
            [],
            [],
            [],
            [],
            [],
            [],
            [],
        )
        for rid, (ccd, pos, mask) in enumerate(
            zip(ccds, chain["all_atom_positions"], chain["all_atom_mask"])
        ):
            mask = np.asarray(mask, bool)
            ok = bool(mask.any())
            if rc.is_standard(ccd):
                ok = ok and len(mask) > 1 and bool(mask[1])
                if ccd != "GLY" and len(mask) > 4:
                    ok = ok and bool(mask[4])
                elif ccd != "GLY":
                    ok = False
            keep.append(ok)
            if not ok:
                continue
            x_gt.append(np.asarray(pos, np.float32)[mask])
            conf_atom_idx.append(np.nonzero(mask)[0].astype(np.int32))
            chunk.append(int(mask.sum()))
            res_idx.append(rid)
            restype.append(rc.restype_order(ccd))
            kept_ccds.append(ccd)
        keep = np.asarray(keep, bool)

        n_kept = len(kept_ccds)
        is_protein = np.full(n_kept, chain_class == "protein", np.float32)
        is_ligand = 1.0 - is_protein
        is_short_poly = np.array(
            [
                chain_class != "protein" and len(kept_ccds) >= 2 and rc.is_standard(c)
                for c in kept_ccds
            ],
            np.float32,
        )

        return ChainData(
            chain_id=chain_id,
            chain_class=chain_class,
            ccds=kept_ccds,
            x_gt=np.concatenate(x_gt, 0) if x_gt else np.zeros((0, 3), np.float32),
            conf_atom_idx=np.concatenate(conf_atom_idx)
            if conf_atom_idx
            else np.zeros(0, np.int32),
            chunk_sizes=np.asarray(chunk, np.int64),
            residue_index=np.asarray(res_idx, np.int64),
            restype=np.asarray(restype, np.int64),
            key_res_feat=kr[keep],
            is_key_res=is_key_res[keep],
            pocket_res_feat=pocket[keep],
            is_protein=is_protein,
            is_ligand=is_ligand,
            is_short_poly=is_short_poly,
            msa=msa_feats["msa"][:, keep],
            deletion_matrix=msa_feats["deletion_matrix"][:, keep],
            msa_all_seq=msa_feats.get("msa_all_seq", None)[:, keep]
            if "msa_all_seq" in msa_feats
            else None,
            deletion_matrix_all_seq=msa_feats.get("deletion_matrix_all_seq", None)[
                :, keep
            ]
            if "deletion_matrix_all_seq" in msa_feats
            else None,
            msa_species_identifiers_all_seq=msa_feats.get(
                "msa_species_identifiers_all_seq"
            ),
            seq3="-".join(ccds),
        )

    def _protein_msa(self, ccds) -> Dict[str, np.ndarray]:
        """Cached MSA lookup by md5("protein:"+seq); falls back to the
        single query sequence (feature_loader.py:181-213)."""
        seq = "".join(rc.three_to_one(c) for c in ccds)
        row = np.array([[rc.restype_order(c) for c in ccds]] * 1, np.int8)
        out = {"msa": row, "deletion_matrix": np.zeros_like(row)}
        key = protein_msa_key(seq)
        if self.msa_features_dir:
            path = os.path.join(self.msa_features_dir, f"{key}.pkl.gz")
            if os.path.exists(path):
                cached = load_pkl(path)
                out["msa"] = np.asarray(cached["msa"], np.int8)
                out["deletion_matrix"] = np.asarray(cached["deletion_matrix"], np.int8)
            else:
                self.missing_msa.append((key, seq))
        if self.uniprot_msa_features_dir:
            path = os.path.join(self.uniprot_msa_features_dir, f"{key}.pkl.gz")
            if os.path.exists(path):
                cached = load_pkl(path)
                out.update(
                    {
                        "msa_all_seq": np.asarray(cached["msa_all_seq"], np.int8),
                        "deletion_matrix_all_seq": np.asarray(
                            cached["deletion_matrix_all_seq"], np.int8
                        ),
                        "msa_species_identifiers_all_seq": cached[
                            "msa_species_identifiers_all_seq"
                        ],
                    }
                )
        if out["msa"].shape[0] > self.cfg.max_msa_seqs:
            out["msa"] = out["msa"][: self.cfg.max_msa_seqs]
            out["deletion_matrix"] = out["deletion_matrix"][: self.cfg.max_msa_seqs]
        return out

    # --------------------------------------------------------- stage: assembly

    def _assign_assembly(self, chains: List[ChainData], rng) -> None:
        """entity/sym/asym ids grouped by identical seq3
        (feature_loader.py:360-387)."""
        entities: Dict[str, List[ChainData]] = {}
        for c in chains:
            entities.setdefault(c.seq3, []).append(c)
        asym = 0
        for entity_id, (seq3, group) in enumerate(entities.items()):
            if not self.inference_mode and self.cfg.train_shuffle_sym_id:
                rng.shuffle(group)
            for sym_id, c in enumerate(group):
                c.entity_id, c.sym_id, c.asym_id = entity_id, sym_id, asym
                asym += 1

    # ------------------------------------------------------------ stage: crop

    def _spatial_crop(self, chains: List[ChainData], rng) -> List[ChainData]:
        """Whole-conformer spatial crop under token+atom budgets
        (feature_loader.py:389-543).  Inference: centre = ligand mean."""
        # flatten token-level info (tokens = conformers for standard,
        # atoms for ligands)
        tok_centre, tok_conf, tok_chunk, tok_is_std, tok_asym = [], [], [], [], []
        conf_chain, conf_local = [], []
        gid = 0
        lig_xyz = []
        for ci, c in enumerate(chains):
            atom_off = 0
            if c.chain_class == "ligand" and len(c.ccds) == 1:
                lig_xyz.append(c.x_gt)
            for li, (ccd, sz) in enumerate(zip(c.ccds, c.chunk_sizes)):
                sz = int(sz)
                xs = c.x_gt[atom_off : atom_off + sz]
                if rc.is_standard(ccd):
                    # centre atom = CA where present, else mean
                    names = [
                        self.ccd[ccd]["ref_atom_name_chars"][k]
                        for k in c.conf_atom_idx[atom_off : atom_off + sz]
                    ]
                    centre = rc.TOKEN_CENTRE_ATOM.get(ccd, "CA")
                    xc = xs[names.index(centre)] if centre in names else xs.mean(0)
                    tok_centre.append(xc)
                    tok_conf.append(gid)
                    tok_chunk.append(sz)
                    tok_is_std.append(True)
                    tok_asym.append(c.asym_id)
                else:
                    for a in range(sz):
                        tok_centre.append(xs[a])
                        tok_conf.append(gid)
                        tok_chunk.append(sz)
                        tok_is_std.append(False)
                        tok_asym.append(c.asym_id)
                conf_chain.append(ci)
                conf_local.append(li)
                atom_off += sz
                gid += 1

        tok_centre = np.asarray(tok_centre, np.float32)
        tok_asym = np.asarray(tok_asym)

        centre = self._crop_centre(tok_centre, tok_asym, lig_xyz, rng)
        dist = np.linalg.norm(tok_centre - centre[None], axis=-1)
        order = np.argsort(dist)

        selected: List[int] = []
        sel_set = set()
        atoms = toks = 0
        for t in order:
            conf = tok_conf[t]
            if conf in sel_set:
                continue
            sz = tok_chunk[t]
            add_tok = 1 if tok_is_std[t] else sz
            if atoms + sz > self.cfg.atom_crop_size:
                break
            if toks + add_tok > self.cfg.crop_size:
                break
            sel_set.add(conf)
            selected.append(conf)
            atoms += sz
            toks += add_tok

        # subset each chain by kept conformers
        out = []
        for ci, c in enumerate(chains):
            local_keep = np.array(
                [
                    (gid in sel_set)
                    for gid, cc in zip(range(len(conf_chain)), conf_chain)
                    if cc == ci
                ],
                bool,
            )
            if not local_keep.any():
                continue
            out.append(_subset_chain(c, local_keep))
        return out

    def _crop_centre(self, tok_centre, tok_asym, lig_xyz, rng) -> np.ndarray:
        c = self.cfg
        if self.inference_mode and len(lig_xyz) == 1:
            return np.concatenate(lig_xyz, 0).mean(0)
        seed = rng.random()
        if lig_xyz and (
            self.inference_mode or seed < c.train_spatial_crop_ligand_ratio
        ):
            allx = np.concatenate(lig_xyz, 0)
            return allx[rng.integers(len(allx))]
        if (
            seed < c.train_spatial_crop_ligand_ratio + c.train_spatial_crop_interface_ratio
            and len(set(tok_asym.tolist())) > 1
        ):
            diff_chain = tok_asym[None] != tok_asym[:, None]
            dist = np.linalg.norm(tok_centre[:, None] - tok_centre[None], axis=-1)
            dist = np.where(diff_chain, dist, np.inf)
            at_interface = np.any(
                dist < c.train_spatial_crop_interface_threshold, axis=-1
            )
            pool = tok_centre[at_interface] if at_interface.any() else tok_centre
            return pool[rng.integers(len(pool))]
        return tok_centre[rng.integers(len(tok_centre))]

    # ----------------------------------------------------------- stage: merge

    def _merge(self, chains: List[ChainData], rng) -> Tuple[Dict, Dict]:
        lengths = [len(c.ccds) for c in chains]
        msa, dele = msa_pairing.merge_msas(
            [
                {
                    "msa": c.msa,
                    "deletion_matrix": c.deletion_matrix,
                    **(
                        {
                            "msa_all_seq": c.msa_all_seq,
                            "deletion_matrix_all_seq": c.deletion_matrix_all_seq,
                            "msa_species_identifiers_all_seq": c.msa_species_identifiers_all_seq,
                        }
                        if c.msa_all_seq is not None
                        else {}
                    ),
                }
                for c in chains
            ],
            lengths,
        )

        feats: Dict[str, np.ndarray] = {}
        cat = lambda key: np.concatenate([getattr(c, key) for c in chains], 0)
        feats["x_gt"] = cat("x_gt")
        conf_feats = {
            "residue_index": cat("residue_index"),
            "restype": cat("restype"),
            "chunk_sizes": cat("chunk_sizes"),
            "is_protein": cat("is_protein"),
            "is_ligand": cat("is_ligand"),
            "is_short_poly": cat("is_short_poly"),
            "key_res_feat": cat("key_res_feat"),
            "is_key_res": cat("is_key_res"),
            "pocket_res_feat": cat("pocket_res_feat"),
            "asym_id": np.concatenate(
                [np.full(len(c.ccds), c.asym_id) for c in chains]
            ),
            "sym_id": np.concatenate(
                [np.full(len(c.ccds), c.sym_id) for c in chains]
            ),
            "entity_id": np.concatenate(
                [np.full(len(c.ccds), c.entity_id) for c in chains]
            ),
        }
        ccds = sum((c.ccds for c in chains), [])
        conf_atom_idx = np.concatenate([c.conf_atom_idx for c in chains])
        profile = msa_pairing.msa_profile(msa)
        del_mean = msa_pairing.deletion_mean(dele)

        # ---------------- index maps (feature_loader.py:545-631) -------------
        atom_tok, atom_conf, ref_feat_rows = [], [], []
        s_mask, tok_conf, tok_chunk, tok_centre_atom, tok_pseudo_beta = (
            [],
            [],
            [],
            [],
            [],
        )
        tok_frame: List[Tuple[int, int, int]] = []
        token_id = 0
        atom_id = 0
        atom_names_flat: List[str] = []
        atom_elements_flat: List[str] = []
        atom_off = 0
        for conf_id, (ccd, sz) in enumerate(zip(ccds, conf_feats["chunk_sizes"])):
            sz = int(sz)
            entry = self.ccd[ccd]
            inner = conf_atom_idx[atom_off : atom_off + sz]
            names = [entry["ref_atom_name_chars"][k] for k in inner]
            atom_names_flat += names
            atom_elements_flat += [
                element_symbol(int(entry["ref_element"][k]) + 1) for k in inner
            ]
            full_ref_feat = assemble_ref_feat(entry)
            if rc.is_unk(ccd) and rc.is_standard(ccd):
                # UNK token: masked, no atoms contribute
                s_mask.append(0)
                tok_conf.append(conf_id)
                tok_chunk.append(0)
                tok_centre_atom.append(0)
                tok_pseudo_beta.append(0)
                tok_frame.append((0, 0, 0))  # degenerate frame
                token_id += 1
                # atoms of UNK still exist in x_gt; map them to this token
                for _ in range(sz):
                    atom_conf.append(conf_id)
                    atom_tok.append(token_id - 1)
                    atom_id += 1
                ref_feat_rows.append(full_ref_feat[inner])
            elif rc.is_standard(ccd):
                ref_feat_rows.append(full_ref_feat[inner])
                s_mask.append(1)
                tok_conf.append(conf_id)
                tok_chunk.append(sz)
                centre_name = rc.TOKEN_CENTRE_ATOM[ccd]
                pb_name = rc.TOKEN_PSEUDO_BETA_ATOM.get(ccd, centre_name)
                c_at = pb_at = atom_id
                # backbone frame (N, CA, C) for PAE/FAPE (AF3 frame
                # convention; the reference's loaders never emitted these —
                # its pae/fape consumed features from older internal code)
                f_at = [atom_id, atom_id, atom_id]
                for k, nm in enumerate(names):
                    if nm == centre_name:
                        c_at = atom_id + k
                    if nm == pb_name:
                        pb_at = atom_id + k
                    if nm == "N":
                        f_at[0] = atom_id + k
                    elif nm == "CA":
                        f_at[1] = atom_id + k
                    elif nm == "C":
                        f_at[2] = atom_id + k
                    atom_conf.append(conf_id)
                    atom_tok.append(token_id)
                tok_centre_atom.append(c_at)
                tok_pseudo_beta.append(pb_at)
                tok_frame.append(tuple(f_at))
                atom_id += sz
                token_id += 1
            else:  # ligand / non-standard: token per atom
                ref_feat_rows.append(full_ref_feat[inner])
                # per-atom frames: (nearest, self, second-nearest) within the
                # conformer by ref-conformer distance (AF3 ligand frames)
                rp = np.asarray(entry["ref_pos"], np.float32)[inner]
                if sz >= 3:
                    dm = np.linalg.norm(rp[:, None] - rp[None], axis=-1)
                    np.fill_diagonal(dm, np.inf)
                    nn2 = np.argsort(dm, axis=-1)[:, :2]
                else:
                    nn2 = np.zeros((sz, 2), np.int64)
                atom_start = atom_id
                for k in range(sz):
                    atom_conf.append(conf_id)
                    atom_tok.append(token_id)
                    s_mask.append(1)
                    tok_conf.append(conf_id)
                    tok_chunk.append(1)
                    tok_centre_atom.append(atom_id)
                    tok_pseudo_beta.append(atom_id)
                    tok_frame.append(
                        (
                            atom_start + int(nn2[k, 0]),
                            atom_id,
                            atom_start + int(nn2[k, 1]),
                        )
                        if sz >= 3
                        else (atom_id, atom_id, atom_id)
                    )
                    atom_id += 1
                    token_id += 1
            atom_off += sz

        feats["ref_feat"] = np.concatenate(ref_feat_rows, 0).astype(np.float32)
        feats["ref_pos"] = feats["ref_feat"][:, :3].copy()
        feats["atom_id_to_token_id"] = np.asarray(atom_tok, np.int64)
        atom_conf = np.asarray(atom_conf, np.int64)
        feats["ref_space_uid"] = atom_conf
        feats["s_mask"] = np.asarray(s_mask, np.float32)
        tok_conf = np.asarray(tok_conf, np.int64)
        feats["token_id_to_chunk_sizes"] = np.asarray(tok_chunk, np.int64)
        feats["token_id_to_centre_atom_id"] = np.asarray(tok_centre_atom, np.int64)
        feats["token_id_to_pseudo_beta_atom_id"] = np.asarray(tok_pseudo_beta, np.int64)
        tok_frame_arr = np.asarray(tok_frame, np.int64).reshape(-1, 3)
        feats["token_id_to_frame_atom_id_0"] = tok_frame_arr[:, 0]
        feats["token_id_to_frame_atom_id_1"] = tok_frame_arr[:, 1]
        feats["token_id_to_frame_atom_id_2"] = tok_frame_arr[:, 2]
        feats["token_index"] = np.arange(token_id, dtype=np.int64)

        # conformer-wise -> token-wise (feature_loader.py:731-739)
        for key in (
            "is_protein",
            "is_short_poly",
            "is_ligand",
            "residue_index",
            "restype",
            "asym_id",
            "entity_id",
            "sym_id",
            "key_res_feat",
            "is_key_res",
            "pocket_res_feat",
        ):
            feats[key] = np.asarray(conf_feats[key])[tok_conf]
        feats["profile"] = profile[tok_conf]
        feats["deletion_mean"] = del_mean[tok_conf]
        msa = msa[:, tok_conf]
        dele = dele[:, tok_conf]
        feats["msa"] = msa
        feats["deletion_matrix"] = dele

        if self.use_x_gt_ligand_as_ref_pos:
            lig_atoms = np.asarray(conf_feats["is_ligand"])[atom_conf] > 0
            if lig_atoms.any():
                lig_gt = feats["x_gt"][lig_atoms]
                feats["ref_pos"][lig_atoms] = lig_gt - lig_gt.mean(0)

        # per-conformer random SE(3) on ref_pos (feature_loader.py:741-743)
        feats["ref_pos"] = _per_conformer_rigid_augment(
            feats["ref_pos"], atom_conf, rng
        )
        feats["ref_feat"][:, :3] = feats["ref_pos"]

        # intra-conformer pair features (feature_loader.py:748-771)
        nt = token_id
        token_bonds = np.zeros((nt, nt), np.float32)
        rel_tok = np.zeros((nt, nt, 42), np.float32)
        tok_off = 0
        atom_off = 0
        for ccd, sz in zip(ccds, conf_feats["chunk_sizes"]):
            sz = int(sz)
            if rc.is_standard(ccd):
                tok_off += 1
            else:
                entry = self.ccd[ccd]
                inner = conf_atom_idx[atom_off : atom_off + sz]
                tb = entry["token_bonds"][np.ix_(inner, inner)]
                token_bonds[tok_off : tok_off + sz, tok_off : tok_off + sz] = tb
                rt = assemble_rel_tok_feat(entry)[np.ix_(inner, inner)]
                rel_tok[tok_off : tok_off + sz, tok_off : tok_off + sz] = rt
                tok_off += sz
            atom_off += sz
        feats["token_bonds"] = token_bonds
        feats["token_bonds_feature"] = token_bonds.copy()
        feats["rel_tok_feat"] = rel_tok

        # chirality-drop augmentation (train; feature_loader.py:774-786)
        if (
            not self.inference_mode
            and rng.random() < self.cfg.train_chirality_augmentation_ratio
        ):
            chir = feats["ref_feat"][:, 158:161]
            unspecified = np.zeros_like(chir)
            unspecified[:, 2] = 1
            lig_atom = feats["is_ligand"][feats["atom_id_to_token_id"]]
            drop = (rng.integers(0, 2, len(lig_atom)) * lig_atom).astype(bool)
            feats["ref_feat"][:, 158:161] = np.where(
                drop[:, None], unspecified, chir
            )

        feats["x_exists"] = np.ones(len(feats["x_gt"]), np.float32)
        feats["a_mask"] = feats["x_exists"].copy()

        meta = {
            "ccds": ccds,
            "conf_atom_idx": conf_atom_idx,
            "chunk_sizes": np.asarray(conf_feats["chunk_sizes"]),
            "residue_index": np.asarray(conf_feats["residue_index"]),
            "asym_id": np.asarray(conf_feats["asym_id"]),
            "chain_class": [
                "ligand" if float(il) > 0 else "protein"
                for il in conf_feats["is_ligand"]
            ],
            "atom_names": atom_names_flat,
            "atom_elements": atom_elements_flat,
            "ligand_atom_idx": np.nonzero(
                np.asarray(conf_feats["is_ligand"])[atom_conf] > 0
            )[0],
        }
        return feats, meta

    # --------------------------------------------------------- stage: finalize

    def _finalize(self, feats: Dict, rng, num_msa_rounds: int = 1) -> Dict:
        # target feat (feature_loader.py:810-815)
        restype_oh = np.eye(32, dtype=np.float32)[feats["restype"]]
        feats["target_feat"] = np.concatenate(
            [restype_oh, feats["profile"], feats["deletion_mean"][..., None]], axis=-1
        ).astype(np.float32)

        feats.update(
            make_msa_feat(
                feats.pop("msa"),
                feats.pop("deletion_matrix"),
                self.cfg.max_msa_clusters,
                rng,
                num_rounds=num_msa_rounds,
            )
        )
        feats.pop("profile")
        feats.pop("deletion_mean")

        feats = self._inter_chain_bonds(feats)

        feats["z_mask"] = feats["s_mask"][None] * feats["s_mask"][:, None]
        feats["ap_mask"] = feats["a_mask"][None] * feats["a_mask"][:, None]
        feats["is_dna"] = np.zeros_like(feats["is_protein"])
        feats["is_rna"] = np.zeros_like(feats["is_protein"])

        feats = self._template_feat(feats, rng)

        # short standard-residue polymers count as protein (transform tail)
        short = feats.pop("is_short_poly")
        feats["is_protein"] = feats["is_protein"] + short
        feats["is_ligand"] = feats["is_ligand"] - short

        for k in ("is_protein", "is_ligand", "s_mask", "x_exists", "a_mask"):
            feats[k] = feats[k].astype(np.float32)
        return feats

    def _inter_chain_bonds(self, feats: Dict) -> Dict:
        """Cross-chain covalent bond detection at the closest atom pair below
        threshold, polymer-ligand / ligand-ligand only
        (feature_loader.py:853-911)."""
        tok = feats["atom_id_to_token_id"]
        asym = feats["asym_id"][tok]
        is_lig = feats["is_ligand"][tok]
        x = feats["x_gt"]
        m = feats["a_mask"]
        chains = []
        for a_id in dict.fromkeys(asym.tolist()):
            idx = np.nonzero(asym == a_id)[0]
            chains.append((a_id, idx, bool(is_lig[idx[0]] > 0)))
        nt = len(feats["asym_id"])
        extra = np.zeros((nt, nt), np.float32)
        for i in range(len(chains) - 1):
            for j in range(i + 1, len(chains)):
                if not chains[i][2] and not chains[j][2]:
                    continue
                ia, ja = chains[i][1], chains[j][1]
                d = np.linalg.norm(x[ia][:, None] - x[ja][None], axis=-1)
                d = d + (1 - m[ia][:, None] * m[ja][None]) * 1000
                if d.min() < self.cfg.token_bond_threshold:
                    ai, aj = np.unravel_index(np.argmin(d), d.shape)
                    ti, tj = tok[ia[ai]], tok[ja[aj]]
                    extra[ti, tj] = extra[tj, ti] = 1.0
        feats["token_bonds"] = feats["token_bonds"] + extra
        return feats

    def _template_feat(self, feats: Dict, rng) -> Dict:
        """GT protein-protein pseudo-beta distogram template, 39+1 channels,
        with train-time bert masking (feature_loader.py:944-968)."""
        xb = feats["x_gt"][feats["token_id_to_pseudo_beta_atom_id"]]
        z_mask = feats["s_mask"][None] * feats["s_mask"][:, None]
        protein2d = feats["is_protein"][None] * feats["is_protein"][:, None]
        chain_same = (feats["asym_id"][None] == feats["asym_id"][:, None]).astype(
            np.float32
        )

        d2 = np.sum((xb[:, None] - xb[None]) ** 2, axis=-1, keepdims=True)
        lower = np.linspace(3.25, 50.75, 39) ** 2
        upper = np.concatenate([lower[1:], [1e16]])
        dgram = ((d2 > lower) & (d2 < upper)).astype(np.float32)
        dgram = dgram * protein2d[..., None] * z_mask[..., None]

        if not self.inference_mode and rng.random() > self.cfg.train_use_template_ratio:
            t_mask = np.float32(1.0)
            bert = rng.random(len(xb)) > rng.random() * (
                1 - self.cfg.train_template_mask_max_ratio
            )
            pb_mask = (bert[None] * bert[:, None]) * z_mask * protein2d
        elif not self.inference_mode:
            t_mask = np.float32(0.0)
            pb_mask = z_mask * protein2d
        else:
            t_mask = np.float32(1.0)
            pb_mask = z_mask * protein2d
        dgram = dgram * pb_mask[..., None]
        feats["templ_feat"] = np.concatenate(
            [dgram, pb_mask[..., None]], axis=-1
        ).astype(np.float32)
        feats["t_mask"] = t_mask
        return feats

    def _pad(self, feats: Dict) -> Dict:
        from physdock_tpu_torch.data.synthetic import pad_batch

        n_tok = len(feats["s_mask"])
        n_atom = len(feats["a_mask"])
        t_bucket = _bucket(n_tok, self.cfg.crop_size)
        a_bucket = _bucket(n_atom, self.cfg.atom_crop_size)
        clean = {k: v for k, v in feats.items() if k in _SCHEMA_KEYS}
        return pad_batch(clean, t_bucket, a_bucket)


from physdock_tpu_torch.data.schema import FEATURE_SCHEMA as _FS  # noqa: E402

_SCHEMA_KEYS = set(_FS.keys())


# no-crop bucket ladder: bounds the number of distinct compiled shapes
# across a heterogeneous system set (BASELINE config 5, blind docking)
_BUCKET_LADDER = (
    128, 256, 384, 512, 640, 768, 1024, 1280, 1536, 2048, 3072, 4096,
    6144, 8192, 12288, 16384,
)


def _bucket(n: int, cap: Optional[int], step: int = 64) -> int:
    if cap:
        return min(((n + step - 1) // step) * step, cap)
    for b in _BUCKET_LADDER:
        if n <= b:
            return b
    return ((n + 1023) // 1024) * 1024


def make_msa_feat(msa, deletion_matrix, max_clusters, rng, num_rounds: int = 1):
    """Resample MSA clusters + build the 34-ch msa_feat
    (feature_loader.py:817-833).  num_rounds>1 returns batch_msa_feat for
    per-round resampling."""
    outs = []
    for _ in range(num_rounds):
        n = msa.shape[0]
        if n > 1:
            perm = rng.permutation(n - 1)[: max_clusters - 1] + 1
            inds = np.concatenate([[0], perm])
        else:
            inds = np.array([0])
        sub = msa[inds].astype(np.int64)
        sub_del = deletion_matrix[inds].astype(np.float32)
        one_hot = np.eye(32, dtype=np.float32)[np.clip(sub, 0, 31)]
        has_del = np.clip(sub_del, 0.0, 1.0)
        del_val = np.arctan(sub_del / 3.0) * (2.0 / np.pi)
        outs.append(
            np.concatenate(
                [one_hot, has_del[..., None], del_val[..., None]], axis=-1
            ).astype(np.float32)
        )
    if num_rounds == 1:
        return {"msa_feat": outs[0]}
    return {"msa_feat": outs[0], "batch_msa_feat": np.stack(outs)}


def _per_conformer_rigid_augment(ref_pos, atom_conf, rng):
    """Independent random rotation+translation per conformer
    (tensor_utils.py:526-533 centre_random_augmentation_np_apply)."""
    out = ref_pos.copy()
    for conf in np.unique(atom_conf):
        m = atom_conf == conf
        out[m] = random_rigid_transform_np(rng, ref_pos[m])
    return out.astype(np.float32)


def _subset_chain(c: ChainData, keep: np.ndarray) -> ChainData:
    atom_keep = np.repeat(keep, c.chunk_sizes.astype(int))
    return ChainData(
        chain_id=c.chain_id,
        chain_class=c.chain_class,
        ccds=[ccd for ccd, k in zip(c.ccds, keep) if k],
        x_gt=c.x_gt[atom_keep],
        conf_atom_idx=c.conf_atom_idx[atom_keep],
        chunk_sizes=c.chunk_sizes[keep],
        residue_index=c.residue_index[keep],
        restype=c.restype[keep],
        key_res_feat=c.key_res_feat[keep],
        is_key_res=c.is_key_res[keep],
        pocket_res_feat=c.pocket_res_feat[keep],
        is_protein=c.is_protein[keep],
        is_ligand=c.is_ligand[keep],
        is_short_poly=c.is_short_poly[keep],
        msa=c.msa[:, keep],
        deletion_matrix=c.deletion_matrix[:, keep],
        msa_all_seq=c.msa_all_seq[:, keep] if c.msa_all_seq is not None else None,
        deletion_matrix_all_seq=c.deletion_matrix_all_seq[:, keep]
        if c.deletion_matrix_all_seq is not None
        else None,
        msa_species_identifiers_all_seq=c.msa_species_identifiers_all_seq,
        seq3=c.seq3,
        asym_id=c.asym_id,
        sym_id=c.sym_id,
        entity_id=c.entity_id,
    )
