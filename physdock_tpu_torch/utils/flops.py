"""FLOP accounting for the dock's MFU.

The count is `torch.utils.flop_counter.FlopCounterMode` over one trunk
pass and one `num_sample`-pose sampler pass (no guidance) of a model
built on the meta device, at the exact shapes of the dock: no card work
and no host arithmetic, only shapes. The port's forward has no host sync
on this path, so the meta device runs it whole.

What is counted: the matrix products (`mm`, `bmm`, `addmm`, einsum's
products, convolutions), at 2 FLOPs per multiply-add; elementwise work,
softmax and reductions are not. On the meta device the attention ops take
their plain path, whose two products give 4·B·H·S_q·S_k·D per call, so
the count does not depend on which kernel serves a call on the card.
XLA's cost analysis, which the JAX package's count reads, also counts
elementwise work: the two counts differ by a fixed ratio per shape
(`PERF.md`, measured by `tests/test_torch_profiling.py`).

MFU = counted FLOPs per second / the card's peak. The peak table holds
dense bf16 tensor-core peaks from NVIDIA's public spec sheets; an unknown
card gives None rather than a guess.
"""

from __future__ import annotations

from typing import Dict, Optional

# dense bf16 tensor-core FLOP/s per card (NVIDIA spec sheets, no sparsity)
GPU_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756.5e12,
    "NVIDIA H100 NVL": 835.5e12,
    "NVIDIA H200": 989.4e12,
    "NVIDIA GH200": 989.4e12,
    "NVIDIA A100": 312e12,
}


def peak_flops_for(device_kind: str) -> Optional[float]:
    for k, v in GPU_PEAK_FLOPS.items():
        if device_kind.lower().startswith(k.lower()):
            return v
    return None


def count_flops(fn, *args, **kw):
    """(FLOPs of `fn(*args, **kw)` as FlopCounterMode counts them, its
    output)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        out = fn(*args, **kw)
    return float(counter.get_total_flops()), out


def estimate_dock_flops(
    model_name: str,
    crop: int,
    atom_crop: int,
    steps: int,
    num_sample: int,
    n_msa: int = 128,
    bf16: bool = True,
) -> Dict[str, float]:
    """FLOPs of one conditioning pass and one `num_sample`-pose sampler
    pass at the given crop, on the meta device (the keys of the JAX
    package's `estimate_dock_flops`)."""
    import torch

    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.synthetic import make_synthetic_batch
    from physdock_tpu_torch.model.diffusion import sample_diffusion
    from physdock_tpu_torch.model.physdock import PhysDock

    cfg = PhysDockConfig.named(model_name, crop_size=crop, atom_crop_size=atom_crop, bf16=bf16,
                               num_augmentation_sample=2)
    with torch.device("meta"):
        model = PhysDock(cfg.model, dtype=cfg.dtypes.compute_dtype)
    batch_np = make_synthetic_batch(n_tokens=crop, n_atoms=atom_crop, n_msa=n_msa,
                                    n_ligand_tokens=24)
    batch = {k: torch.as_tensor(v).to("meta") for k, v in batch_np.items()}
    f_cond, conditioning = count_flops(model.conditioning, batch)
    f_sample, _ = count_flops(sample_diffusion, model, batch, num_sample=num_sample, steps=steps,
                              karras_rho=1000.0, guidance=None, align_ref_pos=False,
                              conditioning=conditioning)
    return {
        "cond_flops": f_cond,
        "sample_flops": f_sample,
        "flops_per_system_round": f_cond + f_sample,
        "model_name": model_name,
        "crop": crop,
        "atom_crop": atom_crop,
        "steps": steps,
        "num_sample": num_sample,
        "n_msa": n_msa,
    }
