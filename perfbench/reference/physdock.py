"""Plain PyTorch reference of the PhysDock model's forward pass: the
conditioning trunk (atom embedder, token embedder with Evoformer, template
embedder and Pairformer) and the AF3DiT denoiser.

Written from the layer equations of PhysDock (`PhysDock/configs.py`
presets, AF3-style trunk and DiT), as functions over a flat weight dict
whose names are those of the measured model's `state_dict()`. No kernel,
no cache, no batching over systems: attention is einsum, an fp32 softmax
and einsum; the DiT's pair biases are computed in every block call. This
module imports only torch, so it can judge the measured program without
sharing any of its code.

`Prec` sets the precision of every matrix product: fp32 (TF32 off); tf32,
each operand rounded to TF32's 10-bit mantissa first; bf16, each operand
rounded to bfloat16 (accumulation in fp32); fp8, each operand rounded to
e4m3 scaled per tensor. The mode a level below a cell's precision is its
control, which the comparison has to fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

C_HIDDEN = 32
INF = 1e9
EPS = 1e-8


class Prec:
    """Precision of the reference's matrix products."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode}")
        self.mode = mode

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32" or not x.is_floating_point():
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        if self.mode == "fp8":  # e4m3, scaled per tensor to its largest value
            scale = x.detach().abs().amax().float().clamp_min(1e-30) / 448.0
            return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
        # round to nearest even at TF32's 10 mantissa bits
        b = x.float().contiguous().view(torch.int32)
        b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
        return b.view(torch.float32)

    def ein(self, eq: str, *ops) -> torch.Tensor:
        return torch.einsum(eq, *[self.r(o) for o in ops])


# ------------------------------------------------------------ parameters


def param_spec(c: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every weight of the model of configuration `c`
    (the keys of `perfbench/configs/*.json`), in the measured model's
    `state_dict()` order."""
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def lin(p, i, o, bias=True):
        out.append((f"{p}.weight", (o, i)))
        if bias:
            out.append((f"{p}.bias", (o,)))

    def norm(p, d, bias=False):
        out.append((f"{p}.weight", (d,)))
        if bias:
            out.append((f"{p}.bias", (d,)))

    def ffn(p, d):
        h = int(2 * 4 * d / 3)
        h = 128 * ((h + 127) // 128)
        lin(f"{p}.w1", d, h, False)
        lin(f"{p}.w3", d, h, False)
        lin(f"{p}.w2", h, d, False)

    def transition(p, d):
        norm(f"{p}.ffn_norm", d)
        ffn(f"{p}.feed_forward", d)

    def qkvg(p, d):
        for n in ("q", "k", "v"):
            lin(f"{p}.linear_{n}", d, d, False)
        lin(f"{p}.linear_g", d, d)

    def pair_attn(p, cs, cz, norm_name="norm_s"):
        norm(f"{p}.{norm_name}", cs)
        norm(f"{p}.norm_z", cz)
        qkvg(p, cs)
        lin(f"{p}.linear_z", cz, cs // C_HIDDEN, False)
        lin(f"{p}.linear_o", cs, cs)

    def tri_update(p, cz):
        norm(f"{p}.norm_in", cz)
        for n in ("qx", "q", "kx", "k"):
            lin(f"{p}.linear_{n}", cz, C_HIDDEN)
        lin(f"{p}.linear_g", cz, cz)
        norm(f"{p}.norm_out", C_HIDDEN)
        lin(f"{p}.linear_z", C_HIDDEN, cz)

    def tri_attn(p, cz):
        norm(f"{p}.norm", cz)
        qkvg(p, cz)
        lin(f"{p}.linear_z", cz, cz // C_HIDDEN, False)
        lin(f"{p}.linear_o", cz, cz)

    def tri_set(p, cz):
        tri_update(f"{p}.triangle_row_update", cz)
        tri_update(f"{p}.triangle_col_update", cz)
        tri_attn(f"{p}.triangle_row_attention", cz)
        tri_attn(f"{p}.triangle_col_attention", cz)

    def dit(p, cs, cz, n):
        for b in range(n):
            q = f"{p}.blocks.{b}"
            lin(f"{q}.attention.norm_s.linear", 256, 3 * cs)
            norm(f"{q}.attention.norm_z", cz, bias=True)
            for x in ("q", "k", "v"):
                lin(f"{q}.attention.linear_{x}", cs, cs, False)
            lin(f"{q}.attention.linear_z", cz, cs // C_HIDDEN, False)
            norm(f"{q}.attention.norm_q", C_HIDDEN)
            norm(f"{q}.attention.norm_k", C_HIDDEN)
            lin(f"{q}.attention.linear_o", cs, cs)
            lin(f"{q}.transition.ffn_norm.linear", 256, 3 * cs)
            ffn(f"{q}.transition.feed_forward", cs)

    ca, cap, cs, cz, cm = c["c_a"], c["c_ap"], c["c_s"], c["c_z"], c["c_m"]
    ae = "diffusion_conditioning.atom_embedder"
    lin(f"{ae}.linear_c", c["ref_dim"], ca, False)
    for n, i in (("p", 3), ("d", 1), ("v", 1)):
        lin(f"{ae}.linear_{n}", i, cap, False)
    lin(f"{ae}.linear_c_l", ca, cap, False)
    lin(f"{ae}.linear_c_m", ca, cap, False)
    ffn(f"{ae}.ffn", cap)
    for b in range(c["no_blocks_atom"]):
        q = f"{ae}.atom_transformer.blocks.{b}"
        pair_attn(f"{q}.attention", ca, cap)
        transition(f"{q}.transition", ca)
    te = "diffusion_conditioning.token_embedder"
    lin(f"{te}.linear_a", ca, cs)
    lin(f"{te}.linear_target_feat", c["target_dim"], cs, False)
    lin(f"{te}.linear_key_res_feat", 7, cs, False)
    lin(f"{te}.linear_pocket_res_feat", 1, cs, False)
    lin(f"{te}.linear_s_i", cs, cz)
    lin(f"{te}.linear_s_j", cs, cz)
    lin(f"{te}.rel_pos_embedder.linear", 2 * 32 + 2 + 42 + 1 + 2 * 2 + 2, cz, False)
    lin(f"{te}.linear_bonds", 1, cz, False)
    lin(f"{te}.linear_msa_feat", c["msa_dim"], cm, False)
    lin(f"{te}.linear_s_input", cs, cm)
    for b in range(c["no_blocks_evoformer"]):
        q = f"{te}.evoformer.blocks.{b}"
        pair_attn(f"{q}.msa_row_attention", cm, cz, "norm_m")
        norm(f"{q}.msa_col_attention.norm_m", cm)
        qkvg(f"{q}.msa_col_attention", cm)
        lin(f"{q}.msa_col_attention.linear_o", cm, cm)
        transition(f"{q}.msa_transition", cm)
        norm(f"{q}.opm.norm_in", cm)
        lin(f"{q}.opm.linear_q", cm, C_HIDDEN)
        lin(f"{q}.opm.linear_k", cm, C_HIDDEN)
        lin(f"{q}.opm.linear_o", C_HIDDEN * C_HIDDEN, cz)
        norm(f"{q}.opm.norm_out", cz)
        tri_set(q, cz)
        transition(f"{q}.pair_transition", cz)
    tp = f"{te}.template_pair_embedder"
    norm(f"{tp}.norm_in", cz)
    lin(f"{tp}.linear_in", cz, cz, False)
    lin(f"{tp}.linear_templ_feat", c["templ_dim"], cz, False)
    for b in range(c["no_blocks_template"]):
        q = f"{tp}.triangleformer.blocks.{b}"
        tri_set(q, cz)
        transition(f"{q}.pair_transition", cz)
    norm(f"{tp}.norm_out", cz)
    lin(f"{tp}.linear_out", cz, cz, False)
    lin(f"{te}.linear_m", cm, cs, False)
    lin(f"{te}.linear_s", cs, cs, False)
    for b in range(c["no_blocks_pairformer"]):
        q = f"{te}.pairformer.blocks.{b}"
        tri_set(q, cz)
        transition(f"{q}.pair_transition", cz)
        pair_attn(f"{q}.attention", cs, cz)
        transition(f"{q}.transition", cs)
    dc = "diffusion_conditioning"
    norm(f"{dc}.norm_s", cs)
    lin(f"{dc}.linear_s", cs, ca, False)
    norm(f"{dc}.norm_z", cz)
    lin(f"{dc}.linear_z", cz, cap, False)
    lin("dit.linear_x", 3, ca)
    lin("dit.linear_downscale", ca, cs)
    lin("dit.linear_upscale", cs, ca)
    lin("dit.time_embedder.linear_1", 256, 256)
    lin("dit.time_embedder.linear_2", 256, 256)
    dit("dit.atom_dit_encoder", ca, cap, c["no_blocks_atom"])
    dit("dit.token_dit", cs, cz, c["no_blocks_dit"])
    dit("dit.atom_dit_decoder", ca, cap, c["no_blocks_atom"])
    norm("dit.norm_r", ca, bias=True)
    lin("dit.linear_r", ca, 3, False)
    lin("linear_distogram", cz, c["no_distogram_bins"])
    return out


# ------------------------------------------------------------ primitives


class Ref:
    """The model's layers over the weight dict `W` at precision `P`. With
    `remat`, each block under autograd keeps only its inputs and runs again
    in the backward pass (memory, not arithmetic)."""

    def __init__(self, W: Dict[str, torch.Tensor], P: Prec, remat: bool = False):
        self.W, self.P, self.remat = W, P, remat

    def block(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def lin(self, p, x):
        y = self.P.ein("...i,oi->...o", x, self.W[p + ".weight"])
        b = self.W.get(p + ".bias")
        return y if b is None else y + b

    def rms(self, p, x, eps=EPS):
        x = x.float()
        return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * self.W[p + ".weight"]

    def ln(self, p, x, eps, affine=True):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.square(x - mean).mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + eps)
        if affine:
            y = y * self.W[p + ".weight"] + self.W[p + ".bias"]
        return y

    def ffn(self, p, x):
        return self.lin(p + ".w2", F.silu(self.lin(p + ".w1", x)) * self.lin(p + ".w3", x))

    def transition(self, p, x):
        return self.ffn(p + ".feed_forward", self.rms(p + ".ffn_norm", x))

    def adaln(self, p, x, t):
        mod = self.lin(p + ".linear", F.silu(t)[..., None, :])
        shift, scale, gate = torch.chunk(mod, 3, dim=-1)
        return self.ln(None, x, EPS, affine=False) * (1 + scale) + shift, gate

    def sdpa(self, q, k, v, bias):
        logits = self.P.ein("...qd,...kd->...qk", q, k) / math.sqrt(q.shape[-1])
        if bias is not None:
            logits = logits + bias
        return self.P.ein("...qk,...kd->...qd", torch.softmax(logits, dim=-1), v)


def _heads(x, h):
    *lead, s, hd = x.shape
    return x.reshape(*lead, s, h, hd // h).transpose(-2, -3)


def _merge(x):
    y = x.transpose(-2, -3)
    return y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])


def _mask_bias(mask, neg=-INF):
    return torch.where(mask == 0, torch.full_like(mask, neg), torch.zeros_like(mask))


# ----------------------------------------------------------- attentions


def pair_attention(R: Ref, p, s, z, z_mask, norm_name="norm_s"):
    """Attention of s (rows [..., S, c]) with a bias from z [S, S, c_z]."""
    h = s.shape[-1] // C_HIDDEN
    sn = R.rms(f"{p}.{norm_name}", s)
    zn = R.rms(f"{p}.norm_z", z)
    q, k, v = (_heads(R.lin(f"{p}.linear_{n}", sn), h) for n in "qkv")
    g = R.lin(f"{p}.linear_g", sn)
    bias = torch.movedim(R.lin(f"{p}.linear_z", zn), -1, -3) + _mask_bias(z_mask.float())[None]
    o = _merge(R.sdpa(q, k, v, bias))
    return R.lin(f"{p}.linear_o", o) * g


def msa_col_attention(R: Ref, p, m):
    m = m.transpose(-2, -3)
    h = m.shape[-1] // C_HIDDEN
    mn = R.rms(f"{p}.norm_m", m)
    q, k, v = (_heads(R.lin(f"{p}.linear_{n}", mn), h) for n in "qkv")
    g = R.lin(f"{p}.linear_g", mn)
    o = R.lin(f"{p}.linear_o", _merge(R.sdpa(q, k, v, None))) * g
    return o.transpose(-2, -3)


def triangle_update(R: Ref, p, z, z_mask, transpose):
    mask = z_mask[..., None].float()
    z = R.rms(f"{p}.norm_in", z)
    a = R.lin(f"{p}.linear_qx", z) * torch.sigmoid(R.lin(f"{p}.linear_q", z)) * mask
    b = R.lin(f"{p}.linear_kx", z) * torch.sigmoid(R.lin(f"{p}.linear_k", z)) * mask
    g = torch.sigmoid(R.lin(f"{p}.linear_g", z))
    if transpose:  # incoming edges: sum over k of b[k, i] a[k, j]
        prod = R.P.ein("jic,jkc->ikc", b, a)
    else:  # outgoing edges: sum over k of a[i, k] b[j, k]
        prod = R.P.ein("ijc,kjc->ikc", a, b)
    return R.lin(f"{p}.linear_z", R.rms(f"{p}.norm_out", prod)) * g


def triangle_attention(R: Ref, p, z, z_mask, transpose, pad_mask=None):
    if transpose:
        z = z.transpose(-2, -3)
        z_mask = z_mask.transpose(-1, -2)
        pad_mask = None if pad_mask is None else pad_mask.transpose(-1, -2)
    h = z.shape[-1] // C_HIDDEN
    zn = R.rms(f"{p}.norm", z)
    q, k, v = (_heads(R.lin(f"{p}.linear_{n}", zn), h) for n in "qkv")
    g = R.lin(f"{p}.linear_g", zn)
    bias = torch.movedim(R.lin(f"{p}.linear_z", zn), -1, -3)
    bias = bias + _mask_bias(z_mask.float())[None]
    if pad_mask is not None:
        bias = bias + _mask_bias(pad_mask.float(), -2.0 * INF)[None]
    o = R.lin(f"{p}.linear_o", _merge(R.sdpa(q, k, v, bias))) * g
    return o.transpose(-2, -3) if transpose else o


def triangle_set(R: Ref, p, z, z_mask, pad_mask=None):
    z = z + triangle_update(R, f"{p}.triangle_row_update", z, z_mask, False)
    z = z + triangle_update(R, f"{p}.triangle_col_update", z, z_mask, True)
    z = z + triangle_attention(R, f"{p}.triangle_row_attention", z, z_mask, False, pad_mask)
    z = z + triangle_attention(R, f"{p}.triangle_col_attention", z, z_mask, True, pad_mask)
    return z


def outer_product_mean(R: Ref, p, m):
    mn = R.rms(f"{p}.norm_in", m)
    a, b = R.lin(f"{p}.linear_q", mn), R.lin(f"{p}.linear_k", mn)
    outer = R.P.ein("bic,bjd->ijcd", a, b)
    outer = outer.reshape(outer.shape[:-2] + (outer.shape[-2] * outer.shape[-1],))
    return R.rms(f"{p}.norm_out", R.lin(f"{p}.linear_o", outer))


# ----------------------------------------------------------------- trunk


def _one_hot(idx, n):
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    return F.one_hot(torch.where(valid, idx, 0), n).float() * valid[..., None].float()


def expand_features(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The model's float features from the int8 transport form the
    featurizer hands over: MSA one-hots and deletions, the token-pair
    relation features and the template distogram, and the pair masks."""
    b = dict(batch)
    if "msa_feat" not in b:
        d = b["msa_del_c"].float() / 255.0
        b["msa_feat"] = torch.cat([_one_hot(b["msa_tok_c"], 32), (d > 0).float()[..., None],
                                   d[..., None]], -1)
    if "rel_tok_feat" not in b:
        fl = b["rel_flags_c"].int()
        b["rel_tok_feat"] = torch.cat([
            _one_hot(b["rel_d_tok_c"], 32), _one_hot(b["rel_bond_type_c"], 5),
            (fl & 1).float()[..., None], (b["rel_as_double_x2_c"].float() / 2.0)[..., None],
            ((fl >> 1) & 1).float()[..., None], ((fl >> 2) & 1).float()[..., None],
            ((fl >> 3) & 1).float()[..., None]], -1)
    if "templ_feat" not in b:
        b["templ_feat"] = torch.cat([_one_hot(b["templ_bins_c"], 39),
                                     b["templ_mask_c"].float()[..., None]], -1)
    s, a = b["s_mask"].float(), b["a_mask"].float()
    b["z_mask"] = s[:, None] * s[None, :]
    b["ap_mask"] = a[:, None] * a[None, :]
    return b


def segment_mean_pool(x, sizes, eps=1e-3):
    """Mean of each token's atoms (atoms ordered by token; sizes [T])."""
    cs = torch.cumsum(x.float(), dim=-2)
    ends = (torch.cumsum(sizes, -1) - 1).clamp_min(0)
    v = cs.index_select(-2, ends)
    tok = torch.cat([v[..., :1, :], torch.diff(v, dim=-2)], dim=-2)
    return tok / (sizes.float()[..., None] + eps)


def relpos(R: Ref, b):
    r_max, s_max = 32, 2
    asym, sym, ent, res = b["asym_id"], b["sym_id"], b["entity_id"], b["residue_index"]
    same_chain = asym[:, None] == asym[None, :]
    same_ent = ent[:, None] == ent[None, :]
    off = res[:, None] - res[None, :] + r_max
    d_res = torch.where(same_chain, off.clamp(0, 2 * r_max), torch.full_like(off, 2 * r_max + 1))
    c_off = sym[:, None] - sym[None, :] + s_max
    d_chain = torch.where(same_chain | ~same_ent, torch.full_like(c_off, 2 * s_max + 1),
                          c_off.clamp(0, 2 * s_max))
    feat = torch.cat([F.one_hot(d_res.long(), 2 * r_max + 2).float(), b["rel_tok_feat"].float(),
                      same_ent[..., None].float(),
                      F.one_hot(d_chain.long(), 2 * s_max + 2).float()], -1)
    return R.lin("diffusion_conditioning.token_embedder.rel_pos_embedder.linear", feat)


def conditioning(R: Ref, c: Dict, batch: Dict[str, torch.Tensor]):
    """The trunk: (a, ap, s, z) of one system's features."""
    b = expand_features(batch)
    ae = "diffusion_conditioning.atom_embedder"
    ref_pos = b["ref_pos"].float()
    d = ref_pos[:, None] - ref_pos[None, :]
    uid = b["ref_space_uid"]
    v3 = (uid[:, None] == uid[None, :]).float()[..., None]
    a = R.lin(f"{ae}.linear_c", b["ref_feat"].float())
    p = R.lin(f"{ae}.linear_p", d) * v3
    p = p + R.lin(f"{ae}.linear_d", 1.0 / (1.0 + torch.linalg.norm(d, dim=-1)[..., None])) * v3
    p = p + R.lin(f"{ae}.linear_v", v3) * v3
    ra = F.relu(a)
    ap = R.lin(f"{ae}.linear_c_l", ra)[:, None] + R.lin(f"{ae}.linear_c_m", ra)[None] + p
    ap = R.block(lambda x: x + R.ffn(f"{ae}.ffn", x), ap)

    def atom_block(q, a, ap):
        a = a + pair_attention(R, f"{q}.attention", a, ap, b["ap_mask"])
        return a + R.transition(f"{q}.transition", a)

    for i in range(c["no_blocks_atom"]):
        a = R.block(atom_block, f"{ae}.atom_transformer.blocks.{i}", a, ap)

    te = "diffusion_conditioning.token_embedder"
    z_mask = b["z_mask"]
    sizes = b["token_id_to_chunk_sizes"]
    s0 = (segment_mean_pool(F.silu(R.lin(f"{te}.linear_a", a)), sizes)
          + R.lin(f"{te}.linear_target_feat", b["target_feat"].float())
          + R.lin(f"{te}.linear_key_res_feat", b["key_res_feat"].float())
          + R.lin(f"{te}.linear_pocket_res_feat", b["pocket_res_feat"].float()[..., None]))
    z = (R.lin(f"{te}.linear_s_i", s0)[:, None] + R.lin(f"{te}.linear_s_j", s0)[None]
         + relpos(R, b) + R.lin(f"{te}.linear_bonds", b["token_bonds_feature"].float()[..., None]))
    m = R.lin(f"{te}.linear_msa_feat", b["msa_feat"].float()) + R.lin(f"{te}.linear_s_input", s0)

    def evo_block(q, m, z):
        m = m + pair_attention(R, f"{q}.msa_row_attention", m, z, z_mask, "norm_m")
        m = m + msa_col_attention(R, f"{q}.msa_col_attention", m)
        m = m + R.transition(f"{q}.msa_transition", m)
        z = z + outer_product_mean(R, f"{q}.opm", m)
        z = triangle_set(R, q, z, z_mask)
        return m, z + R.transition(f"{q}.pair_transition", z)

    for i in range(c["no_blocks_evoformer"]):
        m, z = R.block(evo_block, f"{te}.evoformer.blocks.{i}", m, z)
    # template embedder: distogram features within chains, gated by t_mask
    tp = f"{te}.template_pair_embedder"
    tf = b["templ_feat"].float()
    tz_mask = z_mask * tf[..., 39] * (b["asym_id"][None] == b["asym_id"][:, None]).float()
    t = R.lin(f"{tp}.linear_in", R.rms(f"{tp}.norm_in", z, 1e-6)) + R.lin(f"{tp}.linear_templ_feat", tf)

    def templ_block(q, t):
        t = triangle_set(R, q, t, tz_mask, pad_mask=z_mask)
        return t + R.transition(f"{q}.pair_transition", t)

    for i in range(c["no_blocks_template"]):
        t = R.block(templ_block, f"{tp}.triangleformer.blocks.{i}", t)
    z = z + R.lin(f"{tp}.linear_out", F.relu(R.rms(f"{tp}.norm_out", t))) * b["t_mask"]
    s = R.lin(f"{te}.linear_m", m[0]) + R.lin(f"{te}.linear_s", s0)

    def pair_block(q, s, z):
        z = triangle_set(R, q, z, z_mask)
        z = z + R.transition(f"{q}.pair_transition", z)
        s = s + pair_attention(R, f"{q}.attention", s, z, z_mask)
        return s + R.transition(f"{q}.transition", s), z

    for i in range(c["no_blocks_pairformer"]):
        s, z = R.block(pair_block, f"{te}.pairformer.blocks.{i}", s, z)

    dc = "diffusion_conditioning"
    tok = b["atom_id_to_token_id"].long()
    a = a + R.lin(f"{dc}.linear_s", R.rms(f"{dc}.norm_s", s)).index_select(-2, tok)
    zp = R.lin(f"{dc}.linear_z", R.rms(f"{dc}.norm_z", z))
    ap = ap + zp.index_select(0, tok).index_select(1, tok)
    return a, ap, s, z


# -------------------------------------------------------------- denoiser


def _timestep(R: Ref, t):
    half = 128
    ex = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                     device=t.device) / half)
    e = t.float()[..., None] * ex
    e = torch.cat([torch.sin(e), torch.cos(e)], -1)
    e = torch.cat([e[..., half:], e[..., :half]], -1)
    return R.lin("dit.time_embedder.linear_2", F.silu(R.lin("dit.time_embedder.linear_1", e)))


def _dit_stack(R: Ref, p, n, x, t, pair, pair_mask):
    h = x.shape[-1] // C_HIDDEN

    def dit_block(blk, x, t, pair):
        q = f"{blk}.attention"
        bias = torch.movedim(R.lin(f"{q}.linear_z", R.ln(f"{q}.norm_z", pair, 1e-5)), -1, -3)
        bias = bias + _mask_bias(pair_mask.float())[None]
        xn, gate = R.adaln(f"{q}.norm_s", x, t)
        qq = R.rms(f"{q}.norm_q", _heads(R.lin(f"{q}.linear_q", xn), h))
        kk = R.rms(f"{q}.norm_k", _heads(R.lin(f"{q}.linear_k", xn), h))
        vv = _heads(R.lin(f"{q}.linear_v", xn), h)
        x = x + R.lin(f"{q}.linear_o", _merge(R.sdpa(qq, kk, vv, bias))) * gate
        xn, gate = R.adaln(f"{blk}.transition.ffn_norm", x, t)
        return x + R.ffn(f"{blk}.transition.feed_forward", xn) * gate

    for i in range(n):
        x = R.block(dit_block, f"{p}.blocks.{i}", x, t, pair)
    return x


def denoise(R: Ref, c: Dict, batch: Dict[str, torch.Tensor], x_hat, t_hat, a, ap, s, z):
    """The network output r [N, A, 3] of the EDM-preconditioned denoiser
    for N noised poses x_hat [N, A, 3] at noise levels t_hat [N] (the
    denoised pose is c_skip * x_hat + c_out * r)."""
    b = expand_features(batch)
    sd = c["sigma_data"]
    t_hat = t_hat.float()
    c_in = 1.0 / torch.sqrt(t_hat[:, None, None] ** 2 + sd ** 2)
    t = _timestep(R, t_hat * (torch.log(t_hat / sd) / 4.0))
    x = R.lin("dit.linear_x", x_hat.float() * c_in) + a[None]
    x = _dit_stack(R, "dit.atom_dit_encoder", c["no_blocks_atom"], x, t, ap, b["ap_mask"])
    bs = segment_mean_pool(F.silu(R.lin("dit.linear_downscale", x)),
                           b["token_id_to_chunk_sizes"]) + s[None]
    bs = _dit_stack(R, "dit.token_dit", c["no_blocks_dit"], bs, t, z, b["z_mask"])
    x = x + R.lin("dit.linear_upscale", bs).index_select(-2, b["atom_id_to_token_id"].long())
    x = _dit_stack(R, "dit.atom_dit_decoder", c["no_blocks_atom"], x, t, ap, b["ap_mask"])
    return R.lin("dit.linear_r", R.ln("dit.norm_r", x, EPS))


def edm_parts(t_hat, sigma_data):
    """(c_skip, c_out) of the EDM preconditioning at noise levels t_hat."""
    t = t_hat.double()
    sd = float(sigma_data)
    return sd ** 2 / (sd ** 2 + t ** 2), sd * t / torch.sqrt(sd ** 2 + t ** 2)
