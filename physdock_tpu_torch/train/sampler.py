"""Training data sampling and host-side batch assembly (port of
`physdock_tpu/train/sampler.py`, the import prefix changed).

Equivalent of the reference's weighted infinite sampler + retry loop
(tasks/unicore_train/__init__.py:27-65, feature_loader_plinder.py:1134):
fixed (crop_size, atom_crop_size) padded batches stacked along a leading
system axis and prefetched on a background thread.  A featurization that
raises is retried on another system, as in the reference; each retry is
counted on the sampler and printed.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
from physdock_tpu_torch.data.synthetic import pad_batch
from physdock_tpu_torch.utils.io import find_files, load_json
from physdock_tpu_torch.utils.profiling import span


class WeightedSystemSampler:
    """Infinite weighted sampling of system pkls (cluster-weighted in the
    reference, train_val_weights.json)."""

    def __init__(
        self,
        systems: Sequence[str],
        weights: Optional[Sequence[float]] = None,
        seed: int = 0,
    ):
        self.systems = list(systems)
        w = np.asarray(weights if weights is not None else np.ones(len(systems)))
        self.p = w / w.sum()
        self.rng = np.random.default_rng(seed)
        self.retries = 0  # featurizations that raised and were retried

    @classmethod
    def from_dataset_dir(cls, dataset_dir: str, seed: int = 0):
        systems = find_files(os.path.join(dataset_dir, "train_val"), ".pkl.gz")
        if not systems:
            raise FileNotFoundError(f"no .pkl.gz systems under {dataset_dir}/train_val")
        weights = None
        wpath = os.path.join(dataset_dir, "train_val_weights.json")
        if os.path.exists(wpath):
            wmap = load_json(wpath)
            weights = [wmap.get(s, 1.0) for s in systems]
        return cls(systems, weights, seed)

    def __iter__(self) -> Iterator[str]:
        while True:
            yield self.systems[self.rng.choice(len(self.systems), p=self.p)]


def batch_iterator(
    sampler: WeightedSystemSampler,
    featurizer: SystemFeaturizer,
    batch_size: int,
    crop_size: int,
    atom_crop_size: int,
    max_retries: int = 8,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield stacked, padded feature batches [B, ...] (retry-on-exception as
    in the reference dataset, tasks/unicore_train/__init__.py:48-56)."""
    from physdock_tpu_torch.data.schema import FEATURE_SCHEMA

    it = iter(sampler)
    while True:
        with span("physdock.train.batch"):
            systems = []
            while len(systems) < batch_size:
                path = next(it)
                for _ in range(max_retries):
                    try:
                        feats, _ = featurizer.load(path)
                        feats = {k: v for k, v in feats.items() if k in FEATURE_SCHEMA}
                        feats = pad_batch(feats, crop_size, atom_crop_size)
                        systems.append(feats)
                        break
                    except Exception as e:
                        sampler.retries += 1
                        print(f"sampler: featurizing {path} failed ({type(e).__name__}: {e}); "
                              f"retry {sampler.retries} on another system", flush=True)
                        path = next(it)
                else:
                    raise RuntimeError("too many featurization failures")
            batch = {k: np.stack([s[k] for s in systems]) for k in systems[0]}
        yield batch


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (replaces DataLoader workers). An
    exception in the producer is raised in the consumer; closing the
    consumer stops the producer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = threading.Event()
    end = object()

    def put(item) -> bool:
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(end)
        except Exception as e:  # handed to the consumer, raised there
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        done.set()


class MixedBatchSampler:
    """Training data mix (port of `physdock_tpu/train/sampler.py`'s, with
    the same draws in the same order; feature_loader_plinder.py:1-7
    header): ~85% receptor+ligand complexes, ~5% protein-only, ~10%
    ligand-only conformer batches (SMILES chunks standing in for the
    reference's 374-chunk ligand DB).

    The template split follows the release loader's executed behaviour
    (`data/feature_loader.py` `_template_feat`), not the plinder header's
    "0.5 APO / 0.5 HOLO": tune `train_use_template_ratio` to move it."""

    def __init__(
        self,
        complex_sampler: WeightedSystemSampler,
        featurizer: SystemFeaturizer,
        ligand_smiles: Optional[Sequence[str]] = None,
        complex_ratio: float = 0.85,
        protein_only_ratio: float = 0.05,
        seed: int = 0,
    ):
        self.complexes = complex_sampler
        self.featurizer = featurizer
        self.ligand_smiles = list(ligand_smiles or [])
        self.ratios = (complex_ratio, protein_only_ratio)
        self.rng = np.random.default_rng(seed)
        self._complex_iter = iter(complex_sampler)

    def sample(self) -> Dict[str, np.ndarray]:
        r = self.rng.random()
        complex_r, protein_r = self.ratios
        if r < complex_r or not self.ligand_smiles:
            feats, _ = self.featurizer.load(next(self._complex_iter))
        elif r < complex_r + protein_r:
            feats, _ = self.featurizer.load(next(self._complex_iter), remove_ligand=True)
        else:
            from physdock_tpu_torch.data.smiles import mol_from_smiles

            smi = self.ligand_smiles[self.rng.integers(len(self.ligand_smiles))]
            mol = mol_from_smiles(smi, seed=int(self.rng.integers(2**31)))
            feats, _ = self.featurizer.load({}, remove_receptor=True, ligand_mol=mol)
        return feats
