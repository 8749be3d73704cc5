"""Guided redocking and virtual screening (port of
`physdock_tpu/infer/pipeline.py`: `DockingPipeline.dock`, `dock_many`,
`_dock_many_batched`, `_load`, `_dock_loaded`, `_build_guidance`,
`_post_args`, `_postprocess`, `screen`, `_dock_ligand_batch`,
`_run_ligand_group`, `_run_group_batched`).

Host-side orchestration around the model on one device: featurize (in
process, or in the `data/feat_worker.FeaturizerWorker` subprocess), run
the round loop (trunk -> EDM sampler with physics guidance -> chirality
accept/reject, `infer/rounds.RoundProtocol`), then align to the GT pocket
frame, optionally relax (`infer/relax.relax_complex`), rank, write
PDB/SDF and the pose-validity report `bust_report.json`
(`infer/relax.check_pose` on the written top 5).  The round loop calls
the trunk and the sampler directly.  `dock_many` docks a list of systems:
with the worker, the first is featurized here while the worker starts,
then system k+1 is featurized and system k-1 post-processed in the
worker while system k's rounds run; with `batch_size` > 1 every system
is featurized before the first pass, the first here and the others side
by side in a pool of worker processes, and systems of one MSA depth are
re-padded to a common bucket and share one sampler pass, whose poses the
worker's processes then post-process (so does a batched screen's
group, when the featurizer is a worker).  Screening docks a SMILES list
into one receptor, one ligand at a time or in groups of same-shaped
ligand-systems that share one sampler pass
(`model/diffusion.sample_diffusion_batched`); the trunk runs once
per system and round.  With `enable_confidence` the confidence head
scores every pose of a dock with the last round's (s, z), one pose at a
time (`_confidence_scores`), into `confidence.json`, and
`confidence_ranking` ranks the poses by its `ranking_confidence`; the
batched paths score no confidence, as in the JAX package.

With `SamplerSettings.tp` > 1 the pipeline shards the pair tensors' rows
over the tp ranks of the process group the caller started (`parallel/
mesh.py::init_distributed`, one process per card): every rank runs the
dock on the same inputs and seed, and rank 0 alone writes the outputs.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from physdock_tpu_torch.config import PhysDockConfig
from physdock_tpu_torch.data.embed import generate_conformers
from physdock_tpu_torch.data.feat_worker import FeaturizerWorker, featurize
from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from physdock_tpu_torch.infer import metrics as metrics_lib
from physdock_tpu_torch.infer import ranking as ranking_lib
from physdock_tpu_torch.infer import writers
from physdock_tpu_torch.infer.relax import check_pose, relax_complex
from physdock_tpu_torch.infer.rounds import RoundProtocol, pairwise
from physdock_tpu_torch.model.compact import pad_compact_msa_np, pad_compact_np
from physdock_tpu_torch.model.diffusion import (
    PhysicsGuidance,
    gather_ligand,
    sample_diffusion,
    sample_diffusion_batched,
    stack_guidances,
    stacked_conditioning,
)
from physdock_tpu_torch.model.forcefield import build_ligand_ff, chirality_correct
from physdock_tpu_torch.model.physdock import PhysDock, prepare_batch
from physdock_tpu_torch.ops import _flash_lib
from physdock_tpu_torch.parallel import mesh as mesh_lib
from physdock_tpu_torch.parallel.tp import enable_tp
from physdock_tpu_torch.utils.io import dump_json, md5_string
from physdock_tpu_torch.utils.profiling import span


def _json_safe(d: Dict) -> Dict:
    """numpy scalars/arrays -> plain python for json dumps."""
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.bool_, bool)):
            out[k] = bool(v)
        elif isinstance(v, (np.integer, int)):
            out[k] = int(v)
        elif isinstance(v, (np.floating, float)):
            out[k] = round(float(v), 4)
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        else:
            out[k] = v
    return out


def _failed(smi: str, e: Exception) -> Dict:
    """A screened ligand's result when docking it raised; the traceback
    goes to stderr."""
    traceback.print_exc(file=sys.stderr)
    return {"smiles": smi, "error": f"{type(e).__name__}: {e}"}


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
    enable_sidechain_relaxation: bool = False
    align_mode: str = "pocket_ca"  # stored, not read, as in the JAX package
    seed: int = 0
    # the confidence head at inference (the model must have it): per-pose
    # pLDDT/PAE/pTM/ipTM metrics, and optionally the poses ranked by
    # 0.8*ipTM + 0.2*pTM - has_clash instead of the geometric KMeans medoids
    enable_confidence: bool = False
    confidence_ranking: bool = False
    # pair-row tensor parallelism over this many ranks of the process group
    # (parallel/tp.py): z and the DiT's bias cache hold S/tp rows per card;
    # tp=1 is the single-card program
    tp: int = 1


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
        self.featurizer = featurizer  # SystemFeaturizer or FeaturizerWorker
        self.writes = True  # this process writes the outputs
        if self.s.tp > 1:
            # process-lifetime: every later trunk and sampler call shards
            self.writes = mesh_lib.rank() == 0
            enable_tp(mesh_lib.make_mesh(tp=self.s.tp))
            if self.device.type == "cuda":
                _flash_lib.build_on_rank0()

    def close(self) -> None:
        """Stop the featurizer worker, if the pipeline has one."""
        if isinstance(self.featurizer, FeaturizerWorker):
            self.featurizer.stop()

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return arrays_to_device(arrays, self.device)

    def _load_kwargs(self, remove_ligand, smi, ligand_sdf) -> Dict:
        return dict(remove_ligand=remove_ligand, smi=smi, ligand_sdf=ligand_sdf,
                    num_msa_rounds=max(1, self.s.max_rounds))

    def _worker_kwargs(self) -> Dict:
        """What the worker computes besides the features: the conformer
        bank when physics correction wants it, and the compact form."""
        want = self.s.enable_physics_correction
        return dict(num_confs=self.s.num_confs if want else None, conf_seed=self.s.seed,
                    compact=True)

    def _post_in_worker(self) -> bool:
        """A batched group's NumPy align/rank/score runs in the worker, as in
        dock_many (relaxation needs the in-process path)."""
        return isinstance(self.featurizer, FeaturizerWorker) and not (
            self.s.enable_sidechain_relaxation)

    @staticmethod
    def _with_bank(payload):
        """(feats, meta) of a worker-code load, the conformer bank in meta."""
        feats, meta, confs = payload
        if confs is not None:
            meta["_conf_bank"] = confs
        return feats, meta

    @span("physdock.load")
    def _load(self, system, **kw):
        """One system's (feats, meta) in the compact transport form, the one
        form the pipeline docks, featurized in this process: a load the
        caller waits for gains nothing from the worker.  With a
        FeaturizerWorker it runs the worker's code here (`load_here`: its
        disk cache, the conformer bank in meta)."""
        if isinstance(self.featurizer, FeaturizerWorker):
            return self._with_bank(
                self.featurizer.load_here(system, **self._worker_kwargs(), **kw))
        return self._with_bank(featurize(self.featurizer, system, kw, compact=True))

    def _loaded_in_order(self, systems, kw, width: int = 1):
        """Yields each system's (feats, meta), compact, in order.  With the
        worker, the first system is featurized here while every later one
        goes to the worker up front, dealt over `width` of its processes.
        One process serves a caller that docks each system as it comes: it
        computes system k+1 while the caller docks system k (the ~64 KB
        pipe bounds how far ahead it runs).  A caller that needs every
        system before its first pass has them featurized side by side.  A
        worker result carries the receive timings (header wait, payload
        read) and the index of the process that served it, beside the
        worker's own seconds and its cache verdict."""
        rest = systems[1:] if isinstance(self.featurizer, FeaturizerWorker) else []
        if rest:
            self.featurizer.start(width)
        for sysp in rest:
            self.featurizer.submit(sysp, **self._worker_kwargs(), **kw)
        for i, sysp in enumerate(systems):
            with span("physdock.load_wait"):
                if i == 0 or not rest:
                    feats, meta = self._load(sysp, **kw)
                else:
                    feats, meta = self._with_bank(self.featurizer.result())
                    meta["_recv_detail"] = dict(self.featurizer.last_recv,
                                                worker_s=meta.get("_worker_time_s"),
                                                cache=meta.get("_feat_cache", "miss"))
            yield feats, meta

    @span("physdock.guidance.build")
    def _build_guidance(self, batch, meta, pad_atoms: Optional[int] = None):
        """Returns (PhysicsGuidance template, original conformer bank); the
        guidance's conformer arrays are bank-shaped ([max_samples, L, ...])
        and are swapped per round. pad_atoms pads the ligand axis to a
        common size for a group of ligands (padded entries: index past the
        end, mask 0)."""
        mol = meta.get("ref_mol")
        lig_idx = np.asarray(meta["ligand_atom_idx"])
        if mol is None or len(lig_idx) == 0 or mol.num_atoms != len(lig_idx):
            return None, None
        confs = meta.get("_conf_bank")
        if confs is None:
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
        L = pad_atoms or mol.num_atoms
        if L < mol.num_atoms:
            raise ValueError(f"pad_atoms {L} < {mol.num_atoms} ligand atoms")
        idx = np.full(L, n_atoms, np.int64)  # pad -> out-of-range (dropped)
        idx[: len(lig_idx)] = lig_idx
        lig_mask = np.zeros(L, np.float32)
        lig_mask[: mol.num_atoms] = 1.0
        K = self.s.max_samples
        dev = self.device
        guidance = PhysicsGuidance(
            ligand_idx=torch.as_tensor(idx, device=dev),
            ligand_mask=torch.as_tensor(lig_mask, device=dev),
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
        loaded = self._load(system, **self._load_kwargs(remove_ligand, smi, ligand_sdf))
        return self._dock_loaded(loaded, output_dir, remove_ligand=remove_ligand, smi=smi,
                                 write_outputs=write_outputs, t_start=t_start)

    def dock_many(self, systems, output_root: str, remove_ligand: bool = False,
                  smi: Optional[str] = None, ligand_sdf: Optional[str] = None,
                  write_outputs: bool = True, batch_size: int = 1,
                  results: Optional[List[Dict]] = None) -> List[Dict]:
        """Dock a list of systems, each into `output_root/<system_id>`.
        With the worker, the first system is featurized here while the
        worker starts, system k+1 (k >= 1) in the worker while system k's
        rounds run, and a docked system's post-processing (align/rank/
        score) runs there too, overlapping the next system's rounds (not
        with relaxation or confidence, which stay in this process); the
        poses equal sequential `dock`'s.  batch_size > 1 stacks systems of
        one MSA depth, re-padded to the chunk's largest bucket, into one
        sampler pass per round (`_dock_many_batched`).
        `results`, when given, receives each system's result as it
        finishes, so a caller keeps the finished systems when a later one
        raises."""
        results = [] if results is None else results
        systems = list(systems)
        kw = self._load_kwargs(remove_ligand, smi, ligand_sdf)
        if batch_size > 1:
            return self._dock_many_batched(systems, output_root, kw, remove_ligand=remove_ligand,
                                           smi=smi, write_outputs=write_outputs,
                                           batch_size=batch_size, results=results)
        offload = isinstance(self.featurizer, FeaturizerWorker) and len(systems) > 1 and not (
            self.s.enable_sidechain_relaxation or self.s.enable_confidence)
        pending = []
        loads = self._loaded_in_order(systems, kw)
        for _ in systems:
            t_start = time.time()
            feats, meta = next(loads)
            out_dir = os.path.join(output_root, str(meta["system_id"]))
            ctx = self._dock_loaded((feats, meta), out_dir, remove_ligand=remove_ligand, smi=smi,
                                    write_outputs=write_outputs, t_start=t_start,
                                    defer_post=offload)
            if offload:
                self.featurizer.submit_post(
                    ctx["poses"], self._post_args(ctx["feats"], ctx["meta"], remove_ligand, smi))
                pending.append((ctx, out_dir))
            else:
                results.append(ctx)
        # FIFO: every load response has drained before the first post one
        for ctx, out_dir in pending:
            with span("physdock.post_wait"):
                post = self.featurizer.result()
            res = self._postprocess(ctx["feats"], ctx["meta"], ctx["poses"], out_dir,
                                    remove_ligand=remove_ligand, smi=smi,
                                    rounds_run=ctx["rounds_run"], t_feat=ctx["t_feat"],
                                    t_start=ctx["t_start"], write_outputs=write_outputs,
                                    post=post)
            res["timings"] = ctx["timings"]
            results.append(res)
        return results

    def _dock_many_batched(self, systems, output_root: str, kw: Dict, *, remove_ligand: bool,
                           smi: Optional[str], write_outputs: bool, batch_size: int,
                           results: List[Dict]) -> List[Dict]:
        """Batched dock_many: load everything before the first pass (the
        first system here, the others side by side in the worker's
        processes: nothing docks meanwhile), group by MSA depth (rows
        cannot be padded without a row mask), re-pad each chunk of <=
        batch_size to its largest token and atom count and dock it in one
        sampler pass per round (`_run_group_batched`); a chunk whose
        guidance cannot be built docks one system at a time.  Each
        result's timings give `load_fanout`, the processes that featurized
        the call's systems, and `load_overlap`, the loads' own seconds over
        the seconds this process waited for them."""
        t_start = time.time()
        width = max(1, len(systems) - 1)  # the first system loads here
        if self._post_in_worker():
            self.featurizer.start(width)  # its start overlaps the loads and rounds
        groups: Dict[int, list] = {}
        own = waited = 0.0
        served = set()
        t0 = time.perf_counter()
        for feats, meta in self._loaded_in_order(systems, kw, width):
            wait = time.perf_counter() - t0
            detail = meta.get("_recv_detail") or {}
            own += detail.get("worker_s", wait)
            served.add(detail.get("worker", "here"))
            waited += wait
            groups.setdefault(np.shape(feats["msa_tok_c"])[0], []).append((feats, meta))
            t0 = time.perf_counter()
        load_stats = {"load_fanout": len(served),
                      "load_overlap": round(own / max(waited, 1e-9), 3)}
        ablate = self.featurizer.use_x_gt_ligand_as_ref_pos
        for group in groups.values():
            for i in range(0, len(group), batch_size):
                chunk = group[i: i + batch_size]
                if len(chunk) > 1:
                    n_tok = max(len(f["s_mask"]) for f, _ in chunk)
                    n_atom = max(len(f["a_mask"]) for f, _ in chunk)
                    for f, m in chunk:
                        if m.get("batch_msa_feat_c") is not None:
                            m["batch_msa_feat_c"] = [pad_compact_msa_np(x, n_tok)
                                                     for x in m["batch_msa_feat_c"]]
                    chunk = [(pad_compact_np(f, n_tok, n_atom), m) for f, m in chunk]
                out_dirs = [os.path.join(output_root, str(m["system_id"])) for _, m in chunk]
                gt_ligs = None
                if ablate:
                    gt_ligs = [np.asarray(f["x_gt"])[np.asarray(m["ligand_atom_idx"])]
                               for f, m in chunk]
                res = self._run_group_batched(chunk, out_dirs, remove_ligand=remove_ligand,
                                              smis=[smi] * len(chunk),
                                              write_outputs=write_outputs, t_start=t_start,
                                              gt_ligs=gt_ligs)
                if res is None:  # unbuildable guidance: one system at a time
                    res = [self._dock_loaded(it, out_dir, remove_ligand=remove_ligand, smi=smi,
                                             write_outputs=write_outputs, t_start=t_start)
                           for it, out_dir in zip(chunk, out_dirs)]
                for r in res:
                    r["timings"].update(load_stats)
                results.extend(res)
        return results

    @torch.no_grad()
    @span("physdock.dock")
    def _dock_loaded(self, loaded, output_dir: str, *, remove_ligand: bool,
                     smi: Optional[str], write_outputs: bool, t_start: float,
                     defer_post: bool = False) -> Dict:
        s = self.s
        feats, meta = loaded
        t_loaded = time.time()
        with span("physdock.upload"):
            batch = self._to_device(feats)
            batch_msa_feat = meta.pop("batch_msa_feat_c", None)
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
        if meta.get("_recv_detail"):
            timings["load_detail"] = meta.pop("_recv_detail")
        rounds_run = 0
        x = None
        conditioning = None
        for rnd in range(s.max_rounds if guided else 1):
            rounds_run += 1
            if batch_msa_feat is not None:
                # MSA clusters resampled per round: recompute the trunk
                c = batch_msa_feat[rnd % len(batch_msa_feat)]
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
            with span("physdock.round_end"):
                if g is not None and g.ff is not None:
                    lig = x_t[:, g.ligand_idx.clamp(max=x_t.shape[-2] - 1)]
                    ok = chirality_correct(lig, g.ff)
                else:
                    ok = torch.ones((x_t.shape[0],), dtype=torch.bool)
                x, ok = x_t.float().cpu().numpy(), ok.cpu().numpy()
                if guided:
                    protocol.update(x, x[:, lig_idx], ok)
            if not guided or protocol.done:
                break
        poses = protocol.final_poses() if guided else x[: s.max_samples]
        conf_metrics = rank_scores = None
        if s.enable_confidence:
            conf_metrics, rank_scores = self._confidence_scores(batch, conditioning, poses, feats)
        timings["rounds_s"] = round(time.time() - t_start - t_feat, 3)
        if defer_post:
            return dict(feats=feats, meta=meta, poses=poses, rounds_run=rounds_run,
                        t_feat=t_feat, t_start=t_start, timings=timings)
        res = self._postprocess(feats, meta, poses, output_dir, remove_ligand=remove_ligand,
                                smi=smi, rounds_run=rounds_run, t_feat=t_feat,
                                t_start=t_start, write_outputs=write_outputs,
                                conf_metrics=conf_metrics,
                                rank_scores=rank_scores if s.confidence_ranking else None)
        res["timings"] = timings
        return res

    def _confidence_scores(self, batch, conditioning, poses: np.ndarray, feats):
        """Per-pose confidence metrics from the head, every pose scored
        with the last round's trunk embeddings (s, z), one pose at a time.
        Returns (metrics list, ranking_confidence array)."""
        if not self.model.with_confidence:
            raise ValueError(
                "enable_confidence requires a model/params built with "
                "with_confidence=True (train with --use_mini_rollout)")
        batch = prepare_batch(batch)
        _, _, s_emb, z_emb = conditioning
        out, scores = [], []
        for i in range(len(poses)):
            x = torch.as_tensor(np.asarray(poses[i: i + 1], np.float32), device=self.device)
            p_pae, _, p_plddt = self.model.confidence(batch, s_emb, z_emb, x)
            m = metrics_lib.get_metrics(p_pae.cpu().numpy(), p_plddt.cpu().numpy(), poses[i],
                                        feats)
            out.append(m)
            scores.append(m["ranking_confidence"])
        return out, np.asarray(scores, np.float32)

    def _post_args(self, feats, meta, remove_ligand, smi) -> Dict:
        """NumPy argument pack for ranking.postprocess_poses."""
        lig_idx = np.asarray(meta["ligand_atom_idx"])
        return dict(
            x_gt=np.asarray(feats["x_gt"]),
            lig_idx=lig_idx,
            centre_ids=np.asarray(feats["token_id_to_centre_atom_id"]),
            pocket_res=np.asarray(feats["pocket_res_feat"]),
            is_protein=np.asarray(feats["is_protein"]),
            s_mask=np.asarray(feats["s_mask"]),
            a_mask=np.asarray(feats["a_mask"]),
            enable_ranking=self.s.enable_ranking,
            compute_rmsd=bool(len(lig_idx)) and not remove_ligand and smi is None,
        )

    @span("physdock.post")
    def _postprocess(self, feats, meta, poses: np.ndarray, output_dir: str, *,
                     remove_ligand: bool, smi: Optional[str], rounds_run: int,
                     t_feat: float, t_start: float, write_outputs: bool, post=None,
                     conf_metrics=None, rank_scores=None) -> Dict:
        """Align to the GT pocket-CA frame, optionally relax, rank (by
        `rank_scores`, higher first, when given), score and write outputs
        (redocking.py:341-447).  `post` short-circuits the NumPy stages
        with a precomputed (aligned, order, rmsds) from the worker."""
        lig_idx = np.asarray(meta["ligand_atom_idx"])
        x_gt = np.asarray(feats["x_gt"])
        if post is None:
            relax_fn = None
            if self.s.enable_sidechain_relaxation:
                # restraint-field relaxation of each pose (replaces the
                # reference OpenMM stage, redocking.py:438-445)
                def relax_fn(aligned):
                    return np.stack([relax_complex(a, meta) for a in aligned])

            args = self._post_args(feats, meta, remove_ligand, smi)
            with span("physdock.post.rank"):
                post = ranking_lib.postprocess_poses(poses, args.pop("x_gt"), relax_fn=relax_fn,
                                                     rank_scores=rank_scores, **args)
        aligned, order, lig_rmsds = post
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
        if conf_metrics is not None:
            # rank-ordered, so confidence[0] belongs to pred_rank0
            result["confidence"] = [conf_metrics[i] for i in order]
        with span("physdock.post.write"):
            if write_outputs and self.writes:
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
                if conf_metrics is not None:
                    dump_json(result["confidence"], os.path.join(output_dir, "confidence.json"))
                if len(lig_idx) and meta.get("ref_mol") is not None:
                    # per-pose validity verdicts for the written top-5, the
                    # native equivalent of the reference's PoseBusters table
                    # (data/relaxation.py:29-50 get_bust_results)
                    report = [{"rank": rank, **_json_safe(check_pose(aligned[idx], meta))}
                              for rank, idx in enumerate(order[:5])]
                    dump_json(report, os.path.join(output_dir, "bust_report.json"))
        return result

    # ------------------------------------------------------------ screening

    def screen(self, system, smiles_list: List[str], output_dir: str,
               write_outputs: bool = True, batch_size: int = 1) -> List[Dict]:
        """Virtual screening: dock each SMILES into the receptor's pocket,
        outputs under `output_dir/md5(smi)`. batch_size > 1 docks that many
        ligands at a time, each group of same-shaped ligand-systems in one
        sampler pass. A ligand that fails gives {"smiles", "error"}."""
        results: List[Dict] = []
        smi_map = {smi: md5_string(smi) for smi in smiles_list}
        if batch_size > 1:
            for i in range(0, len(smiles_list), batch_size):
                results += self._dock_ligand_batch(system, smiles_list[i: i + batch_size],
                                                   output_dir, smi_map, write_outputs)
        else:
            for smi in smiles_list:
                results.append(self._screen_one(system, smi, output_dir, smi_map,
                                                write_outputs))
        if write_outputs and self.writes:
            dump_json(smi_map, os.path.join(output_dir, "smiles_to_md5.json"))
        return results

    def _screen_one(self, system, smi, output_dir, smi_map, write_outputs) -> Dict:
        """Dock one SMILES on its own; its failure is its result, the
        screen goes on."""
        try:
            r = self.dock(system, os.path.join(output_dir, smi_map[smi]), remove_ligand=True,
                          smi=smi, write_outputs=write_outputs)
        except Exception as e:  # one bad ligand must not end the screen
            return _failed(smi, e)
        r["smiles"] = smi
        return r

    def _dock_ligand_batch(self, system, smiles: List[str], output_dir: str,
                           smi_map: Dict[str, str], write_outputs: bool) -> List[Dict]:
        """Featurize a batch of SMILES against one receptor, group them by
        the shapes of their features and dock each group in one pass."""
        t_start = time.time()
        if self._post_in_worker():
            self.featurizer.start()  # its start overlaps the loads and rounds
        results: List[Dict] = []
        groups: Dict[tuple, list] = {}
        for smi in smiles:
            t0 = time.time()
            try:
                feats, meta = self._load(system, remove_ligand=True, smi=smi,
                                         num_msa_rounds=max(1, self.s.max_rounds))
            except Exception as e:  # one bad ligand must not end the screen
                results.append(_failed(smi, e))
                continue
            sig = tuple(sorted((k, np.shape(v)) for k, v in feats.items()))
            groups.setdefault(sig, []).append((smi, feats, meta, time.time() - t0))
        for group in groups.values():
            results += self._run_ligand_group(system, group, output_dir, smi_map,
                                              write_outputs, t_start)
        return results

    def _run_ligand_group(self, system, group, output_dir, smi_map, write_outputs,
                          t_start) -> List[Dict]:
        """Screening over the generic group runner; a group with a ligand
        whose guidance cannot be built docks one ligand at a time."""
        smis = [smi for smi, _, _, _ in group]
        res = self._run_group_batched(
            [(f, m) for _, f, m, _ in group],
            [os.path.join(output_dir, smi_map[smi]) for smi in smis],
            remove_ligand=True, smis=smis, write_outputs=write_outputs, t_start=t_start)
        if res is None:
            return [self._screen_one(system, smi, output_dir, smi_map, write_outputs)
                    for smi in smis]
        for (smi, _, _, load_s), r in zip(group, res):
            r["smiles"] = smi
            r["timings"] = {"load_s": round(load_s, 3), **r["timings"]}
        return res

    @torch.no_grad()
    @span("physdock.dock")
    def _run_group_batched(self, items, out_dirs, *, remove_ligand: bool, smis,
                           write_outputs: bool, t_start: float,
                           gt_ligs=None) -> Optional[List[Dict]]:
        """Dock a group of same-shaped systems (items of (feats, meta)) in
        one sampler pass per round: the systems stacked on a leading axis,
        their ligand force fields and conformer banks padded to the
        group's largest ligand, one RoundProtocol each. The trunk runs per
        system whenever its MSA is resampled. The group stays in the round
        loop until every protocol is done. Returns None when physics
        correction is on and some item's guidance cannot be built."""
        s = self.s
        n = len(items)
        metas = [m for _, m in items]
        batch_msa = [m.pop("batch_msa_feat_c", None) for m in metas]
        lig_idxs = [np.asarray(m["ligand_atom_idx"]) for m in metas]
        guided = s.enable_physics_correction
        t0 = time.time()
        guidance, protocols = None, None
        if guided:
            l_max = max(max(len(ix) for ix in lig_idxs), 1)
            built = [self._build_guidance(f, m, pad_atoms=l_max) for f, m in items]
            if any(g is None for g, _ in built):
                return None
            guidance = stack_guidances([g for g, _ in built])
            protocols = [
                RoundProtocol(confs, max_samples=s.max_samples,
                              num_samples_per_round=s.num_samples_per_round, eta_start=s.eta,
                              gt_ligand=None if gt_ligs is None else gt_ligs[b])
                for b, (_, confs) in enumerate(built)]
        with span("physdock.upload"):
            stacked = self._to_device({k: np.stack([np.asarray(f[k]) for f, _ in items])
                                       for k in items[0][0]})
        gen = torch.Generator(device=self.device).manual_seed(s.seed)
        t_feat = time.time() - t_start
        timings = {"guidance_s": round(time.time() - t0, 3)}
        rounds_run = 0
        x = None
        conds = None
        for rnd in range(s.max_rounds if guided else 1):
            rounds_run += 1
            for b, bm in enumerate(batch_msa):
                if bm is not None:
                    # MSA clusters resampled per round: recompute the trunk
                    c = bm[rnd % len(bm)]
                    for k in ("msa_tok_c", "msa_del_c"):
                        stacked[k][b] = torch.as_tensor(c[k], device=self.device)
                    conds = None
            if conds is None:
                conds = stacked_conditioning(self.model, stacked)
            banks = [p.bank(rnd) for p in protocols] if guided else [None]
            g, use_bank = guidance, all(bank is not None for bank in banks)
            if use_bank:
                pos = np.zeros((n,) + guidance.conf_pos.shape[1:], np.float32)
                mask = np.zeros(guidance.conf_mask.shape, np.float32)
                for b, (pb, mb) in enumerate(banks):
                    pos[b, :, : pb.shape[1]] = pb
                    mask[b] = mb
                g = dataclasses.replace(
                    guidance, conf_pos=torch.as_tensor(pos, device=self.device),
                    conf_dists=torch.as_tensor(pairwise(pos), device=self.device),
                    conf_mask=torch.as_tensor(mask, device=self.device))
            x_t = sample_diffusion_batched(
                self.model, stacked, generator=gen, num_sample=s.num_samples_per_round,
                steps=s.steps, gamma_0=s.gamma_0, gamma_min=s.gamma_min,
                noise_scale_lambda=s.noise_scale_lambda, step_scale_eta=s.step_scale_eta,
                karras_rho=s.rho, guidance=g,
                mmff_gamma_0_factor=[p.factor for p in protocols] if guided else [s.eta] * n,
                mmff_iters=s.mmff_iters, align_ref_pos=use_bank, conditioning=conds)
            with span("physdock.round_end"):
                x = x_t.float().cpu().numpy()  # [n, S, A, 3]
                if guided:
                    ok = chirality_correct(gather_ligand(x_t, guidance),
                                           guidance.ff).cpu().numpy()
                    for b in range(n):
                        protocols[b].update(x[b], x[b][:, lig_idxs[b]], ok[b])
            if not guided or all(p.done for p in protocols):
                break
        timings["rounds_s"] = round(time.time() - t_start - t_feat, 3)
        all_poses = [protocols[b].final_poses() if guided else x[b][: s.max_samples]
                     for b in range(n)]
        posts: List = [None] * n
        if self._post_in_worker():
            for b, (feats, meta) in enumerate(items):
                self.featurizer.submit_post(
                    all_poses[b], self._post_args(feats, meta, remove_ligand, smis[b]))
            with span("physdock.post_wait"):
                posts = [self.featurizer.result() for _ in range(n)]
        out: List[Dict] = []
        for b, (feats, meta) in enumerate(items):
            r = self._postprocess(feats, meta, all_poses[b], out_dirs[b],
                                  remove_ligand=remove_ligand, smi=smis[b],
                                  rounds_run=rounds_run, t_feat=t_feat, t_start=t_start,
                                  write_outputs=write_outputs, post=posts[b])
            r["vs_batch_size"] = n
            r["timings"] = dict(timings)
            if meta.get("_recv_detail"):
                r["timings"]["load_detail"] = meta.pop("_recv_detail")
            out.append(r)
        return out
