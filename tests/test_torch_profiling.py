"""The port's profiling and FLOP-accounting utilities
(`physdock_tpu_torch/utils/{profiling,flops}.py`) on the CPU.

  * `device_trace` writes a Chrome trace of the block's CPU ops and is a
    no-op without a directory (the program's spans:
    `tests/test_torch_tracing.py`).
  * `estimate_dock_flops` (FlopCounterMode on the meta device): one
    attention block (fp32 and bf16) and one transition counted exactly
    against a count by hand; the toy dock at crop 32/256, 2 steps, 2 poses against the
    JAX package's `estimate_dock_flops` (XLA's cost analysis, scans
    unrolled) at the same shapes. XLA counts elementwise work too, so the
    ratio is not 1: it measured 0.98039 (34,087,356,416 against
    34,769,117,184 FLOPs; `PERF.md`), and is pinned within +-2 %.
  * `peak_flops_for` knows the H100 SXM's dense bf16 peak and gives None
    for an unknown card, as the JAX package's does.
"""

import json

import pytest
import torch

from physdock_tpu.utils import flops as jflops
from physdock_tpu_torch.nn.attentions import AttentionWithPairBias
from physdock_tpu_torch.nn.primitives import Transition
from physdock_tpu_torch.utils import flops, profiling

RATIO_TO_JAX = 0.98039  # port / JAX at toy, crop 32/256, 2 steps, 2 poses


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    assert prof is not None
    with open(tmp_path / "trace" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    with profiling.device_trace("") as none:
        (a @ a).sum()
    assert none is None


def test_attention_block_and_transition_counted_by_hand():
    s, c_s, c_z = 48, 64, 16
    h, d = c_s // 32, 32
    with torch.device("meta"):
        att = AttentionWithPairBias(c_s, c_z)
        tr = Transition(c_s)
        x, z, m = torch.empty(s, c_s), torch.empty(s, s, c_z), torch.empty(s, s)
    got, _ = flops.count_flops(att, x, z, m)
    # q, k, v, gate and output projections; the pair-bias projection;
    # q.k^T and p.v over h heads of width d
    want = 5 * 2 * s * c_s * c_s + 2 * s * s * c_z * h + 2 * 2 * h * s * s * d
    assert got == want
    hidden = 128 * -(-int(2 * 4 * c_s / 3) // 128)
    got, _ = flops.count_flops(tr, x)
    assert got == 3 * 2 * s * c_s * hidden
    # shape arithmetic: the same count in bf16
    with torch.device("meta"):
        att16 = AttentionWithPairBias(c_s, c_z, dtype=torch.bfloat16)
        x16, z16 = x.to(torch.bfloat16), z.to(torch.bfloat16)
    assert flops.count_flops(att16, x16, z16, m)[0] == want


def test_dock_flops_against_the_jax_count(monkeypatch):
    args = ("toy", 32, 256, 2, 2)
    port = flops.estimate_dock_flops(*args)
    # XLA counts a scan body once unless the JAX model unrolls it
    monkeypatch.setenv("PHYSDOCK_UNROLL_SCANS", "1")
    jax_ = jflops.estimate_dock_flops(*args)
    assert set(port) == set(jax_)
    for k in ("model_name", "crop", "atom_crop", "steps", "num_sample", "n_msa"):
        assert port[k] == jax_[k]
    assert port["flops_per_system_round"] == port["cond_flops"] + port["sample_flops"] > 0
    ratio = port["flops_per_system_round"] / jax_["flops_per_system_round"]
    assert abs(ratio / RATIO_TO_JAX - 1) <= 0.02, ratio


@pytest.mark.parametrize("kind, peak", [("NVIDIA H100 80GB HBM3", 989.4e12),
                                        ("NVIDIA H100 PCIe", 756.5e12),
                                        ("Some Other Card", None)])
def test_peak_flops_for(kind, peak):
    assert flops.peak_flops_for(kind) == peak
    assert jflops.peak_flops_for(kind) is None  # the JAX table knows TPUs only
