"""Diffusion conditioning trunk: atom/token/template/relpos embedders (port
of `physdock_tpu/nn/conditioning.py`).

Produces the four conditioning tensors (a, ap, s, z) consumed by the
AF3DiT denoiser; runs once per system and round.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.nn import functional as F

from physdock_tpu_torch.nn.primitives import FeedForward, Linear, RMSNorm
from physdock_tpu_torch.nn.transformers import (
    AtomTransformer,
    Evoformer,
    Pairformer,
    Triangleformer,
    segment_mean_pool,
)
from physdock_tpu_torch.utils.geometry import one_hot_nearest
from physdock_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


class TemplatePairEmbedder(nn.Module):
    """GT-distogram template injection, gated by t_mask and an intra-chain
    mask."""

    def __init__(self, c_z, templ_dim=40, no_blocks=2, inf=1e9, eps=1e-8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.norm_in = RMSNorm(c_z, eps=1e-6, dtype=dtype)
        self.linear_in = Linear(c_z, c_z, bias=False, **kw)
        self.linear_templ_feat = Linear(templ_dim, c_z, bias=False, **kw)
        self.triangleformer = Triangleformer(c_z, no_blocks, inf, eps, dtype, generator)
        self.norm_out = RMSNorm(c_z, eps=eps, dtype=dtype)
        self.linear_out = Linear(c_z, c_z, bias=False, **kw)
        self.dtype = dtype

    def forward(self, z, templ_feat, asym_id, t_mask, z_mask):
        chain_same = (asym_id[None, :] == asym_id[:, None]).to(templ_feat.dtype)
        tz_mask = z_mask * templ_feat[..., 39] * chain_same
        z = self.linear_in(self.norm_in(z)) + self.linear_templ_feat(templ_feat.to(self.dtype))
        z = self.triangleformer(z, tz_mask, pad_mask=z_mask)
        z = self.linear_out(F.relu(self.norm_out(z)))
        return z.float() * t_mask


class RelPosEmbedder(nn.Module):
    """AF3 relative-position features + 42-dim ligand rel_tok_feat
    (c_rel_feat = 66 + 42 + 1 + 6 = 115)."""

    def __init__(self, c_z, r_max=32, s_max=2, dtype=torch.float32, generator=None):
        super().__init__()
        self.r_max, self.s_max = r_max, s_max
        self.dtype = dtype
        self.linear = Linear(2 * r_max + 2 + 42 + 1 + 2 * s_max + 2, c_z, bias=False,
                             dtype=dtype, generator=generator)

    def forward(self, asym_id, sym_id, entity_id, residue_index, rel_tok_feat):
        dev = asym_id.device
        chain_same = asym_id[..., None] == asym_id[..., None, :]
        entity_same = entity_id[..., None] == entity_id[..., None, :]
        offset = residue_index[..., None] - residue_index[..., None, :] + self.r_max
        d_res = torch.where(chain_same, torch.clamp(offset, 0, 2 * self.r_max),
                            torch.full_like(offset, 2 * self.r_max + 1))
        rel_pos = one_hot_nearest(
            d_res.float(), torch.arange(0, 2 * self.r_max + 2, dtype=torch.float32, device=dev))
        c_off = sym_id[..., None] - sym_id[..., None, :] + self.s_max
        d_chain = torch.where(chain_same | ~entity_same,
                              torch.full_like(c_off, 2 * self.s_max + 1),
                              torch.clamp(c_off, 0, 2 * self.s_max))
        rel_chain = one_hot_nearest(
            d_chain.float(), torch.arange(0, 2 * self.s_max + 2, dtype=torch.float32, device=dev))
        rel_feat = torch.cat(
            [rel_pos, rel_tok_feat.float(), entity_same[..., None].float(), rel_chain], dim=-1)
        return self.linear(rel_feat.to(self.dtype))


class AtomEmbedder(nn.Module):
    """Atom-level conditioning from reference-conformer features."""

    def __init__(self, ref_dim, c_a, c_ap, no_blocks_atom, inf=1e9, eps=1e-8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, generator=generator)
        self.dtype = dtype
        self.linear_c = Linear(ref_dim, c_a, **kw)
        self.linear_p = Linear(3, c_ap, **kw)
        self.linear_d = Linear(1, c_ap, **kw)
        self.linear_v = Linear(1, c_ap, **kw)
        self.linear_c_l = Linear(c_a, c_ap, **kw)
        self.linear_c_m = Linear(c_a, c_ap, **kw)
        self.ffn = FeedForward(c_ap, dtype=dtype, generator=generator)
        self.atom_transformer = AtomTransformer(c_a, c_ap, no_blocks_atom, inf, eps, dtype,
                                                generator)

    def forward(self, ref_feat, ref_pos, ref_space_uid, ap_mask):
        d = (ref_pos[:, None, :] - ref_pos[None, :, :]).float()
        v3 = (ref_space_uid[:, None] == ref_space_uid[None, :]).float()[:, :, None]
        a = self.linear_c(ref_feat.to(self.dtype))
        p = self.linear_p(d.to(self.dtype)) * v3
        inv_d = 1.0 / (1.0 + torch.linalg.norm(d, dim=-1)[:, :, None])
        p = p + self.linear_d(inv_d.to(self.dtype)) * v3
        p = p + self.linear_v(v3.to(self.dtype)) * v3
        ra = F.relu(a)
        ap = self.linear_c_l(ra)[:, None, :] + self.linear_c_m(ra)[None, :, :]
        ap = ap + p
        ap = ap + self.ffn(ap)
        a = self.atom_transformer(a, ap, ap_mask)
        return a, ap


class TokenEmbedder(nn.Module):
    """Token-level conditioning: pooled atoms + target/key-res/pocket
    features, pair init + relpos + bonds, MSA -> Evoformer -> template ->
    Pairformer.

    With `num_recycles` > 0 the MSA-to-Pairformer trunk runs
    num_recycles + 1 times over the same modules (the JAX package's
    AF2-style recycle embedder): each pass after the first adds a
    zero-initialised projection of the previous pass's (s, z), detached,
    to (s0, z0), and embeds the MSA again from the same `msa_feat`."""

    def __init__(self, target_dim, msa_dim, c_a, c_s, c_m, c_z, no_blocks_evoformer,
                 no_blocks_pairformer, no_blocks_template=2, num_recycles=0, inf=1e9,
                 eps=1e-8, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        nb = dict(bias=False, **kw)
        skw = dict(inf=inf, eps=eps, dtype=dtype, generator=generator)
        self.dtype = dtype
        self.linear_a = Linear(c_a, c_s, **kw)
        self.linear_target_feat = Linear(target_dim, c_s, **nb)
        self.linear_key_res_feat = Linear(7, c_s, **nb)
        self.linear_pocket_res_feat = Linear(1, c_s, **nb)
        self.linear_s_i = Linear(c_s, c_z, **kw)
        self.linear_s_j = Linear(c_s, c_z, **kw)
        self.rel_pos_embedder = RelPosEmbedder(c_z, **kw)
        self.linear_bonds = Linear(1, c_z, **nb)
        self.linear_msa_feat = Linear(msa_dim, c_m, **nb)
        self.linear_s_input = Linear(c_s, c_m, **kw)
        self.evoformer = Evoformer(c_m, c_z, no_blocks_evoformer, **skw)
        self.template_pair_embedder = TemplatePairEmbedder(
            c_z, no_blocks=no_blocks_template, **skw)
        self.linear_m = Linear(c_m, c_s, **nb)
        self.linear_s = Linear(c_s, c_s, **nb)
        self.pairformer = Pairformer(c_s, c_z, no_blocks_pairformer, **skw)
        self.num_recycles = num_recycles
        if num_recycles:
            # created only with recycling, so files without it load unchanged
            self.recycle_norm_s = RMSNorm(c_s, eps=eps, dtype=dtype)
            self.recycle_linear_s = Linear(c_s, c_s, init="final", **nb)
            self.recycle_norm_z = RMSNorm(c_z, eps=eps, dtype=dtype)
            self.recycle_linear_z = Linear(c_z, c_z, init="final", **nb)

    def forward(self, batch: Batch, a):
        z_mask = batch["z_mask"]
        dt = self.dtype
        pooled = segment_mean_pool(F.silu(self.linear_a(a)), batch["token_id_to_chunk_sizes"])
        s0 = (
            pooled
            + self.linear_target_feat(batch["target_feat"].to(dt))
            + self.linear_key_res_feat(batch["key_res_feat"].to(dt))
            + self.linear_pocket_res_feat(batch["pocket_res_feat"][..., None].to(dt))
        )
        z0 = (
            self.linear_s_i(s0)[:, None, :]
            + self.linear_s_j(s0)[None, :, :]
            + self.rel_pos_embedder(batch["asym_id"], batch["sym_id"], batch["entity_id"],
                                    batch["residue_index"], batch["rel_tok_feat"])
            + self.linear_bonds(batch["token_bonds_feature"][..., None].to(dt))
        )
        msa = batch["msa_feat"].to(dt)
        s_out = z_out = None
        for r in range(self.num_recycles + 1):
            s_in, z_in = s0, z0
            if r:
                s_in = s0 + self.recycle_linear_s(self.recycle_norm_s(s_out.detach()))
                z_in = z0 + self.recycle_linear_z(self.recycle_norm_z(z_out.detach()))
            with span("physdock.trunk.msa"):
                m = self.linear_msa_feat(msa) + self.linear_s_input(s_in)
                m, z = self.evoformer(m, z_in, z_mask)
            with span("physdock.trunk.templates"):
                z = z + self.template_pair_embedder(
                    z, batch["templ_feat"], batch["asym_id"], batch["t_mask"], z_mask)
            with span("physdock.trunk.pairformer"):
                s = self.linear_m(m[0]) + self.linear_s(s_in)
                s_out, z_out = self.pairformer(s, z, z_mask)
        return s_out, z_out


class DiffusionConditioning(nn.Module):
    """Top conditioning module -> (a, ap, s, z)."""

    def __init__(self, ref_dim, target_dim, msa_dim, c_a, c_ap, c_s, c_m, c_z,
                 no_blocks_atom, no_blocks_evoformer, no_blocks_pairformer,
                 no_blocks_template=2, num_recycles=0, inf=1e9, eps=1e-8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        skw = dict(inf=inf, eps=eps, dtype=dtype, generator=generator)
        self.atom_embedder = AtomEmbedder(ref_dim, c_a, c_ap, no_blocks_atom, **skw)
        self.token_embedder = TokenEmbedder(
            target_dim, msa_dim, c_a, c_s, c_m, c_z, no_blocks_evoformer,
            no_blocks_pairformer, no_blocks_template, num_recycles, **skw)
        self.norm_s = RMSNorm(c_s, eps=eps, dtype=dtype)
        self.linear_s = Linear(c_s, c_a, bias=False, dtype=dtype, generator=generator)
        self.norm_z = RMSNorm(c_z, eps=eps, dtype=dtype)
        self.linear_z = Linear(c_z, c_ap, bias=False, dtype=dtype, generator=generator)

    def forward(self, batch: Batch):
        tok = batch["atom_id_to_token_id"]
        with span("physdock.trunk.atoms"):
            a, ap = self.atom_embedder(batch["ref_feat"], batch["ref_pos"],
                                       batch["ref_space_uid"], batch["ap_mask"])
        s, z = self.token_embedder(batch, a)
        a = a + torch.index_select(self.linear_s(self.norm_s(s)), -2, tok)
        zp = self.linear_z(self.norm_z(z))
        ap = ap + zp.index_select(-3, tok).index_select(-2, tok)
        return a, ap, s, z
