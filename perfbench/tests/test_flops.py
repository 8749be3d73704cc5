"""The analytic FLOP count against `torch.utils.flop_counter.FlopCounterMode`
over the port's trunk, bias cache and denoiser at a small size with no
padding, where both count the same matrix products: the ratio is 1."""

import pytest
import torch

from perfbench import flops

C = {"ref_dim": 167, "target_dim": 65, "msa_dim": 34, "templ_dim": 40, "c_m": 256, "c_s": 512,
     "c_z": 128, "c_a": 128, "c_ap": 16, "no_blocks_atom": 2, "no_blocks_evoformer": 2,
     "no_blocks_pairformer": 2, "no_blocks_dit": 2, "no_blocks_template": 2}


@pytest.mark.parametrize("n,a,m,samples", [(32, 96, 8, 5), (24, 64, 4, 3)])
def test_analytic_count_matches_the_flop_counter(n, a, m, samples):
    from torch.utils.flop_counter import FlopCounterMode

    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.synthetic import make_synthetic_batch
    from physdock_tpu_torch.model.physdock import PhysDock

    torch.manual_seed(0)
    model = PhysDock(PhysDockConfig.named("toy").model).eval()
    b = make_synthetic_batch(n_tokens=n, n_atoms=a, n_msa=m, n_ligand_tokens=6)
    batch = {k: torch.as_tensor(v) for k, v in b.items()}

    def count(fn, *args):
        with FlopCounterMode(display=False) as c, torch.no_grad():
            out = fn(*args)
        return c.get_total_flops(), out

    f_trunk, cond = count(model.conditioning, batch)
    f_bias, bias = count(model.denoise_bias_cache, batch, cond[1], cond[3])
    x, t = torch.randn(samples, a, 3), torch.rand(samples) * 10 + 1
    f_den, _ = count(model.denoise, batch, x, t, *cond, bias)
    assert f_trunk / flops.trunk_flops(C, n, a, m) == pytest.approx(1.0, abs=1e-12)
    assert f_bias / flops.bias_cache_flops(C, n, a) == pytest.approx(1.0, abs=1e-12)
    assert f_den / flops.denoise_flops(C, n, a, samples) == pytest.approx(1.0, abs=1e-12)


def test_roofline_bound_and_peaks():
    kind = "NVIDIA H100 80GB HBM3"
    # compute-bound: ops over the TF32 peak
    t = flops.attention_roofline_s(80, 4, 2048, 2048, 32, 4, 4 * 4 * 2048 * 2048, 4, kind, "fp32")
    assert t == pytest.approx(4.0 * 80 * 4 * 2048 * 2048 * 32 / 494.7e12)
    # memory-bound: a short key axis
    t = flops.attention_roofline_s(1, 1, 4096, 8, 32, 4, 0, 4, kind, "fp32")
    assert t == pytest.approx(4 * 32 * (2 * 4096 + 16) / 3.35e12)
    assert flops.peak("Tesla T4") is None
