"""Adaptive physics-guidance round protocol (host-side state machine).

Faithful re-derivation of the reference redocking round loop
(reference: redocking.py:165-338):

  * round 0 runs with NO conformer-template guidance at high sigma
    (``align_ref_pos=recycle_id > 0`` — redocking.py:290); the MMFF/
    force-field branch at low sigma is still active (model.py:252);
  * after every round each sample's ligand chirality is checked; passing
    samples are accepted AND their ligand poses become templates
    (redocking.py:312-315); failing samples go to a bounded reject deque
    (``maxlen=max_samples`` — redocking.py:166);
  * the adaptive factor: x1.15 if any sample passed, else x0.7 floored at 1
    (redocking.py:319-322);
  * the conformer bank for the NEXT round = accepted ligand poses +
    epsilon-top-ranked conformers from the ORIGINAL ETKDG bank, ranked by
    the 4-sigmoid distance-matrix mismatch against ALL of this round's
    predicted ligand poses (redocking.py:326-335).  At rebuild time
    ``len(accepted) < max_samples`` always holds (the loop breaks first),
    so the bank has exactly ``max_samples`` entries — a static shape on
    TPU, swapped host-side between rounds with zero recompiles;
  * the loop stops once ``max_samples`` poses are accepted;
  * final poses: accepted, backfilled with rejects when fewer than
    ``num_samples_per_round`` were accepted (redocking.py:337-338),
    truncated to ``max_samples`` (redocking.py:341).

Pure numpy — unit-testable against a literal simulation of the reference
loop without touching the model.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np


def _smooth_epsilon(delta: np.ndarray) -> np.ndarray:
    """4-sigmoid soft penalty (reference: redocking.py:329-330)."""

    def sig(x):
        return 1.0 / (1.0 + np.exp(-x))

    return 0.25 * (
        sig(delta - 0.5) + sig(delta - 1.0) + sig(delta - 2.0) + sig(delta - 4.0)
    )


def pairwise(x: np.ndarray) -> np.ndarray:
    return np.linalg.norm(x[..., :, None, :] - x[..., None, :, :], axis=-1)


class RoundProtocol:
    """Cross-round accept/reject + conformer-bank state for one system."""

    def __init__(
        self,
        conf_bank: np.ndarray,  # [C, L, 3] original ETKDG-style bank
        max_samples: int,
        num_samples_per_round: int,
        eta_start: float,
        gt_ligand: Optional[np.ndarray] = None,  # [L, 3] ablation bank
    ):
        self.conf_bank = np.asarray(conf_bank, np.float32)
        self.conf_dists = pairwise(self.conf_bank)  # [C, L, L]
        self.max_samples = int(max_samples)
        self.num_samples_per_round = int(num_samples_per_round)
        self.factor = float(eta_start)
        self.gt_ligand = gt_ligand
        self.ligand_templates: List[np.ndarray] = []  # accepted ligand poses
        self.reference_templates: List[np.ndarray] = []  # epsilon-top confs
        self.accepted: List[np.ndarray] = []  # full-complex poses
        self.rejects = deque([], maxlen=self.max_samples)
        self.last_samples: Optional[np.ndarray] = None

    # --------------------------------------------------------------- queries

    @property
    def done(self) -> bool:
        return len(self.accepted) >= self.max_samples

    def bank(self, round_id: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Conformer-template bank for `round_id` as a STATIC-shape pair
        (pos [max_samples, L, 3], mask [max_samples]); None for round 0
        (unguided at high sigma, redocking.py:290-295)."""
        if round_id == 0:
            return None
        if self.gt_ligand is not None:  # --ebable_x_gt_ligand_as_ref_pos
            entries = [np.asarray(self.gt_ligand, np.float32)]
        else:
            entries = self.ligand_templates + self.reference_templates
        if not entries:
            return None
        L = entries[0].shape[0]
        pos = np.zeros((self.max_samples, L, 3), np.float32)
        mask = np.zeros((self.max_samples,), np.float32)
        n = min(len(entries), self.max_samples)
        pos[:n] = np.stack(entries[:n])
        mask[:n] = 1.0
        return pos, mask

    # --------------------------------------------------------------- updates

    def update(
        self,
        x_pred: np.ndarray,  # [S, A, 3] this round's full poses
        lig_pred: np.ndarray,  # [S, L, 3] their ligand atoms
        ok: np.ndarray,  # [S] bool chirality pass flags
    ) -> None:
        """Fold one round's samples into the state (redocking.py:302-335)."""
        self.last_samples = np.asarray(x_pred)
        ok = np.asarray(ok, bool)
        for i in range(len(x_pred)):
            if ok[i]:
                self.ligand_templates.append(np.asarray(lig_pred[i], np.float32))
                self.accepted.append(np.asarray(x_pred[i]))
            else:
                self.rejects.append(np.asarray(x_pred[i]))
        # adaptive factor: floor applies only on the shrink path
        # (redocking.py:319-322)
        if ok.any():
            self.factor = self.factor * 1.15
        else:
            self.factor = max(self.factor * 0.7, 1.0)
        if self.done:
            return
        # epsilon-rank the ORIGINAL bank against ALL of this round's ligand
        # poses; refill to max_samples total templates (redocking.py:326-335)
        k = self.max_samples - len(self.ligand_templates)
        lig_d = pairwise(np.asarray(lig_pred, np.float32))  # [S, L, L]
        delta = np.abs(lig_d[:, None] - self.conf_dists[None])  # [S, C, L, L]
        eps = _smooth_epsilon(delta).mean(axis=(0, -1, -2))  # [C]
        order = np.argsort(eps, kind="stable")[: max(k, 0)]
        self.reference_templates = [self.conf_bank[i] for i in order]

    def final_poses(self) -> np.ndarray:
        """Accepted poses, reject-backfilled when too few
        (redocking.py:337-341)."""
        acc = list(self.accepted)
        if len(acc) < self.num_samples_per_round:
            acc = acc + list(self.rejects)
        if not acc and self.last_samples is not None:
            acc = [x for x in self.last_samples]
        return np.stack(acc[: self.max_samples])
