"""Confidence module: the PAE, PDE and pLDDT heads (port of
`physdock_tpu/nn/confidence.py`).

From the trunk's (s, z) and a predicted pose it adds pair updates from s
and from the binned token-centre distances, runs a `Pairformer` over
(s, z), then an `AtomTransformer` over the full atom grid with a pair
input made from all A x A atom distances.  Only sample 0 of `x_pred` is
read.  On CUDA its attention runs through the forward kernels: the
triangle attention on `flash_sdpa_folded` (`flash_fwd_lse` / `flash_bwd`
under grad), the single and the atom attention on `flash_sdpa`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from physdock_tpu_torch.nn.primitives import Linear
from physdock_tpu_torch.nn.transformers import AtomTransformer, Pairformer
from physdock_tpu_torch.utils.geometry import one_hot_nearest

# centre-distance bins of `linear_d` (confidence_module.py of the reference)
DIST_BINS = (3.375, 24.375, 13)


class ConfidenceModule(nn.Module):
    def __init__(self, c_s, c_a, c_ap, c_z, no_blocks_heads, no_blocks_atom=3, c_pae=64,
                 c_pde=64, c_plddt=50, inf=1e9, eps=1e-8, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        skw = dict(inf=inf, eps=eps, dtype=dtype, generator=generator)
        self.dtype = dtype
        self.linear_s_i = Linear(c_s, c_z, **kw)
        self.linear_s_j = Linear(c_s, c_z, **kw)
        self.linear_d = Linear(DIST_BINS[2], c_z, bias=False, **kw)
        self.pairformer = Pairformer(c_s, c_z, no_blocks_heads, **skw)
        self.linear_pae = Linear(c_z, c_pae, **kw)
        self.linear_pde = Linear(c_z, c_pde, **kw)
        self.linear_s_a = Linear(c_s, c_a, **kw)
        self.linear_z_a = Linear(1, c_ap, **kw)
        self.atom_transformer = AtomTransformer(c_a, c_ap, no_blocks_atom, **skw)
        self.linear_plddt = Linear(c_a, c_plddt, **kw)

    def forward(self, batch: Dict[str, torch.Tensor], s, z, x_pred):
        """x_pred: [S, A, 3]; returns fp32 logits (p_pae [T, T, c_pae],
        p_pde [T, T, c_pde], p_plddt [A, c_plddt])."""
        x0 = x_pred[0]
        xc = x0.index_select(-2, batch["token_id_to_centre_atom_id"])
        z = z + self.linear_s_i(s)[..., None, :] + self.linear_s_j(s)[..., None, :, :]
        d = torch.linalg.norm(xc[..., None, :] - xc[..., None, :, :] + 1e-12, dim=-1)
        v_bins = torch.linspace(*DIST_BINS[:2], DIST_BINS[2], dtype=torch.float32,
                                device=d.device)
        z = z + self.linear_d(one_hot_nearest(d, v_bins).to(self.dtype))

        s, z = self.pairformer(s, z, batch["z_mask"])
        z = z + z.transpose(-2, -3)
        p_pae = self.linear_pae(z)
        p_pde = self.linear_pde(z)

        a = self.linear_s_a(s).index_select(-2, batch["atom_id_to_token_id"])
        d_atoms = torch.linalg.norm(x0[None] - x0[:, None] + 1e-12, dim=-1)[..., None]
        ap = self.linear_z_a(d_atoms.to(self.dtype))
        a = a + self.atom_transformer(a, ap, batch["ap_mask"])
        p_plddt = self.linear_plddt(a)
        return p_pae.float(), p_pde.float(), p_plddt.float()
