"""Analytic operation counts of PhysDock, and the card's peaks.

FLOPs are counted from the layer equations of the model (the same
equations as `perfbench/reference/physdock.py`): 2 per multiply-add of
every matrix product and einsum contraction, 4·H·S_q·S_k·D per attention
call (QK^T and PV); elementwise work, softmax, norms and reductions are
not counted. The counts take the real token, atom and MSA-row counts of
a system, not its padded crop, so they measure the work a docking job
needs, whatever the program does to serve it. A program change cannot
move them.

A kernel's roofline time is the larger of its operations over the
card's peak and its bytes over the card's bandwidth, each input byte
read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Optional

# dense peaks (NVIDIA data sheets, no sparsity) and HBM bandwidth, by the
# name torch.cuda.get_device_name() gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "fp32": 494.7e12, "bytes_per_s": 3.35e12},
}


def peak(kind: str) -> Optional[Dict[str, float]]:
    for k, v in PEAKS.items():
        if kind.lower().startswith(k.lower()):
            return v
    return None


def peak_flops(kind: str, dtype: str) -> Optional[float]:
    p = peak(kind)
    return None if p is None else p[dtype]


def hidden(d: int) -> int:
    """SwiGLU hidden width: 2/3 of 4d, rounded up to 128."""
    h = int(2 * 4 * d / 3)
    return 128 * ((h + 127) // 128)


def _lin(rows: float, i: int, o: int) -> float:
    return 2.0 * rows * i * o


def _transition(rows: float, d: int) -> float:
    return 3 * _lin(rows, d, hidden(d))


def _triangle_set(n: int, cz: int) -> float:
    upd = 4 * _lin(n * n, cz, 32) + _lin(n * n, cz, cz) + 2.0 * n ** 3 * 32 + _lin(n * n, 32, cz)
    att = 5 * _lin(n * n, cz, cz) + _lin(n * n, cz, cz // 32) + 4.0 * n * n * n * cz
    return 2 * upd + 2 * att


def _pair_attention(rows: float, s: int, w: int, cz: int, bias_rows: float) -> float:
    """Attention over `s` positions of `rows` / s sequences of width w, bias
    from a pair tensor of `bias_rows` entries of width cz."""
    return 5 * _lin(rows, w, w) + _lin(bias_rows, cz, w // 32) + 4.0 * rows * s * w


def trunk_flops(c: Dict, n: int, a: int, m: int) -> float:
    """One trunk pass (conditioning) for n tokens, a atoms, m MSA rows."""
    ca, cap, cs, cz, cm = c["c_a"], c["c_ap"], c["c_s"], c["c_z"], c["c_m"]
    f = _lin(a, c["ref_dim"], ca) + _lin(a * a, 3 + 1 + 1, cap) + 2 * _lin(a, ca, cap)
    f += _transition(a * a, cap)  # the pair FFN has the SwiGLU shape of a transition
    for _ in range(c["no_blocks_atom"]):
        f += _pair_attention(a, a, ca, cap, a * a)
        f += _transition(a, ca)
    f += _lin(a, ca, cs) + _lin(n, c["target_dim"] + 7 + 1, cs) + 2 * _lin(n, cs, cz)
    f += _lin(n * n, 115 + 1, cz) + _lin(m * n, c["msa_dim"], cm) + _lin(n, cs, cm)
    for _ in range(c["no_blocks_evoformer"]):
        f += _pair_attention(m * n, n, cm, cz, n * n)
        f += 5 * _lin(m * n, cm, cm) + 4.0 * n * m * m * cm
        f += _transition(m * n, cm)
        f += 2 * _lin(m * n, cm, 32) + 2.0 * m * n * n * 32 * 32 + _lin(n * n, 1024, cz)
        f += _triangle_set(n, cz) + _transition(n * n, cz)
    f += _lin(n * n, cz, cz) + _lin(n * n, c["templ_dim"], cz) + _lin(n * n, cz, cz)
    f += c["no_blocks_template"] * (_triangle_set(n, cz) + _transition(n * n, cz))
    f += _lin(n, cm, cs) + _lin(n, cs, cs)
    for _ in range(c["no_blocks_pairformer"]):
        f += _triangle_set(n, cz) + _transition(n * n, cz)
        f += _pair_attention(n, n, cs, cz, n * n) + _transition(n, cs)
    f += _lin(n, cs, ca) + _lin(n * n, cz, cap)
    return f


def bias_cache_flops(c: Dict, n: int, a: int) -> float:
    """The DiT's per-block pair biases, once per round."""
    atom = _lin(a * a, c["c_ap"], c["c_a"] // 32)
    return (2 * c["no_blocks_atom"] * atom
            + c["no_blocks_dit"] * _lin(n * n, c["c_z"], c["c_s"] // 32))


def _dit(rows: float, s: int, w: int, samples: int, blocks: int) -> float:
    per = (2 * _lin(samples, 256, 3 * w) + 4 * _lin(rows, w, w) + 4.0 * rows * s * w
           + _transition(rows, w))
    return blocks * per


def denoise_flops(c: Dict, n: int, a: int, samples: int) -> float:
    """One denoiser call on `samples` poses, the biases cached."""
    ca, cs = c["c_a"], c["c_s"]
    f = _lin(samples * a, 3, ca) + 2 * _lin(samples, 256, 256)
    f += 2 * _dit(samples * a, a, ca, samples, c["no_blocks_atom"])
    f += _lin(samples * a, ca, cs) + _dit(samples * n, n, cs, samples, c["no_blocks_dit"])
    f += _lin(samples * n, cs, ca) + _lin(samples * a, ca, 3)
    return f


def redock_system_flops(c: Dict, n: int, a: int, m: int, samples: int, steps: int) -> float:
    """One system and one round of a redocking job: the trunk, the bias
    cache and `steps` denoiser calls on `samples` poses."""
    return (trunk_flops(c, n, a, m) + bias_cache_flops(c, n, a)
            + steps * denoise_flops(c, n, a, samples))


def train_forward_flops(c: Dict, n: int, a: int, m: int, samples: int) -> float:
    """The forward of one training system: the trunk, the DiT's biases,
    one denoiser call on `samples` noised copies and the distogram head."""
    return (trunk_flops(c, n, a, m) + bias_cache_flops(c, n, a)
            + denoise_flops(c, n, a, samples) + _lin(n * n, c["c_z"], c["no_distogram_bins"]))


def attention_roofline_s(b: int, h: int, s_q: int, s_k: int, d: int, elem: int,
                         bias_numel: int, bias_elem: int, kind: str, dtype: str
                         ) -> Optional[float]:
    """Least time of one attention call of batch b (q, k, v, o of `elem`
    bytes, the bias read once) on card `kind` at the peak of `dtype`."""
    p = peak(kind)
    if p is None:
        return None
    ops = 4.0 * b * h * s_q * s_k * d
    byts = elem * b * h * d * (2 * s_q + 2 * s_k) + bias_elem * bias_numel
    return max(ops / p[dtype], byts / p["bytes_per_s"])


def attention_bwd_roofline_s(b: int, h: int, s_q: int, s_k: int, d: int, elem: int,
                             bias_numel: int, bias_elem: int, kind: str, dtype: str
                             ) -> Optional[float]:
    """Least time of one attention backward from the saved row statistics:
    five products (S = QK^T again, dP, dV, dQ, dK); q, k, v, o, dO, the
    bias and the fp32 row statistics read, dq, dk, dv and the fp32 dbias
    written."""
    p = peak(kind)
    if p is None:
        return None
    ops = 10.0 * b * h * s_q * s_k * d
    byts = (elem * b * h * d * (4 * s_q + 4 * s_k) + (bias_elem + 4) * bias_numel
            + 2 * 4 * b * h * s_q)
    return max(ops / p[dtype], byts / p["bytes_per_s"])
