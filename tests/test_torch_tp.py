"""Pair-row tensor parallelism of the PyTorch port (`parallel/tp.py`) on
the CPU: two gloo ranks (`parallel/launch.run_ranks`) against one
process and against the JAX package.

The Pairformer, Evoformer and Triangleformer (two blocks each, pad mask
included) and a DiT's bias cache and forward, at small widths with
seeded random weights (no zero-init projection hides a fault) on 16
tokens with fully masked rows, run at tp 2 and at tp 1 on the same numpy
inputs; the JAX modules run on the same weights through the port's
bridge. Limits: every output at tp 2 within rel 1e-5 (of max|tp 1|) of
tp 1 and of JAX; the gradient of a fixed projection of all outputs with
respect to every parameter within rel 1e-4 of tp 1's by global norm.
Each rank's blocks take z with S/tp rows, its bias cache holds S/tp query
rows, the row-sharded attention route ran, and rows that do not split
over tp raise.  A demo system docked through `DockingPipeline` with
`SamplerSettings(tp=2)` (crop 32/256, 2 steps) gives both ranks the same
poses, within rel 1e-5 of the tp=1 dock's RMSDs, and rank 0 alone writes.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import torch_ranks
from physdock_tpu.nn import transformers as jtr
from physdock_tpu_torch.model.weights import jax_flat_to_state_dict
from physdock_tpu_torch.parallel import tp as tp_lib
from physdock_tpu_torch.parallel.launch import run_ranks
from physdock_tpu_torch.parallel.mesh import Mesh

S, TP = 16, 2
REL_OUT, REL_GRAD = 1e-5, 1e-4


def _inputs():
    rng = np.random.default_rng(13)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    z_mask = (rng.random((S, S)) > 0.2).astype(np.float32)
    z_mask[:2] = 0.0  # fully masked rows
    pad = np.ones((S, S), np.float32)
    pad[:, S - 3:] = 0.0
    pad[S - 3:] = 0.0
    x = {"s": f(S, 64), "z": f(S, S, 32), "m": f(3, S, 64), "z_mask": z_mask, "pad_mask": pad,
         "z_dit": f(S, S, 16), "z_dit_mask": z_mask, "bs": f(2, S, 64), "t": f(2, 256)}
    shapes = {"pairformer_s": (S, 64), "pairformer_z": (S, S, 32), "evoformer_m": (3, S, 64),
              "evoformer_z": (S, S, 32), "triangleformer_z": (S, S, 32),
              "dit_bias": (2, 2, S, S), "dit_bs": (2, S, 64)}
    x.update({"w_" + k: f(*shape) for k, shape in shapes.items()})
    return x


def _randomize(jmod, args, seed):
    """The JAX module's parameters replaced by seeded normals (0.3 scale,
    norm weights around 1), and the port's state_dict of them."""
    variables = jmod.init(jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    flat = flatten_dict(variables["params"], sep="/")
    flat = {k: (rng.normal(size=np.shape(v)) * 0.3 + (1.0 if k.endswith("norm/weight") else 0.0))
            .astype(np.float32) for k, v in flat.items()}
    sd = jax_flat_to_state_dict({"params/" + k: v for k, v in flat.items()})
    return {"params": unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}, sd


def _jax_outputs(x):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    mods = {"pairformer": (jtr.Pairformer(no_blocks=2), (j["s"], j["z"], j["z_mask"])),
            "evoformer": (jtr.Evoformer(c_z=32, no_blocks=2), (j["m"], j["z"], j["z_mask"])),
            "triangleformer": (jtr.Triangleformer(no_blocks=2),
                               (j["z"], j["z_mask"], j["pad_mask"])),
            "dit": (jtr.DiT(c_s=64, c_z=16, no_blocks=2),
                    (j["bs"], j["z_dit"], j["t"], j["z_dit_mask"]))}
    sds, out = {}, {}
    with jax.default_matmul_precision("highest"):
        for i, (name, (jmod, args)) in enumerate(mods.items()):
            variables, sds[name] = _randomize(jmod, args, seed=100 + i)
            if name == "dit":
                bias = jmod.apply(variables, j["z_dit"], j["z_dit_mask"], method="compute_bias")
                out["dit_bias"] = bias
                out["dit_bs"] = jmod.apply(variables, *args, cached_bias=bias)
            elif name == "triangleformer":
                out["triangleformer_z"] = jmod.apply(variables, *args)
            else:
                a, b = jmod.apply(variables, *args)
                first = {"pairformer": "s", "evoformer": "m"}[name]
                out[f"{name}_{first}"], out[f"{name}_z"] = a, b
    return {k: np.asarray(v) for k, v in out.items()}, sds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("tp")
    x = _inputs()
    jax_out, sds = _jax_outputs(x)
    inputs = {k: torch.from_numpy(v) for k, v in x.items()}
    path = os.path.join(tmp, "blob.pt")
    torch.save({"state_dicts": sds, "inputs": inputs}, path)
    ref_out, ref_grads, _ = torch_ranks.stack_run(torch_ranks.build_stacks(sds), inputs)
    ranks = run_ranks(torch_ranks.tp_stacks, TP, args=(path,), rdv_dir=str(tmp / "rdv"))
    yield jax_out, ref_out, ref_grads, ranks
    shutil.rmtree(tmp, ignore_errors=True)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_tp2_stacks_and_bias_cache_match_tp1_and_jax(runs):
    jax_out, ref_out, _, ranks = runs
    for r in ranks:
        for k, ref in ref_out.items():
            got = r["out"][k]
            assert _rel(got, ref) <= REL_OUT, (r["tp_rank"], k, _rel(got, ref))
            assert _rel(got, jax_out[k]) <= REL_OUT, (r["tp_rank"], k, _rel(got, jax_out[k]))
    for k, ref in ref_out.items():  # tp 1 against JAX, the same limit
        assert _rel(ref, jax_out[k]) <= REL_OUT, (k, _rel(ref, jax_out[k]))


def test_tp2_gradients_match_tp1(runs):
    _, _, ref_grads, ranks = runs
    den = np.sqrt(sum(float((g.double() ** 2).sum()) for g in ref_grads))
    for r in ranks:
        num = np.sqrt(sum(float(((g - h).double() ** 2).sum())
                          for g, h in zip(r["grads"], ref_grads)))
        assert num <= REL_GRAD * den, (r["tp_rank"], num / den)
        assert all(torch.isfinite(g).all() for g in r["grads"])


def test_tp2_ranks_hold_their_rows(runs):
    _, ref_out, _, ranks = runs
    for r in ranks:
        seen = {name for name, _ in r["z_rows"]}
        assert seen == {"pairformer", "evoformer", "triangleformer"}
        assert all(rows == S // TP for _, rows in r["z_rows"]), r["z_rows"]
        # the bias cache: [blocks, H, S/tp, S], this rank's query rows
        lo = r["tp_rank"] * S // TP
        assert tuple(r["bias_local"].shape) == (2, 2, S // TP, S)
        assert torch.equal(r["bias_local"], ref_out["dit_bias"][:, :, lo:lo + S // TP])
        # MSA rows, single attention and the DiT took the row-sharded route
        assert r["tp_flash_calls"] > 0


def test_rows_that_do_not_split_over_tp_raise():
    mesh = Mesh(dp=1, tp=2, tp_rank=1)
    with tp_lib.use_tp(mesh):
        assert tuple(tp_lib.shard_rows(torch.zeros(16, 16, 4)).shape) == (8, 16, 4)
        with pytest.raises(ValueError, match="S % tp"):
            tp_lib.shard_rows(torch.zeros(15, 15, 4))
    assert not tp_lib.tp_active()
    x = torch.zeros(15, 15, 4)
    assert tp_lib.shard_rows(x) is x and tp_lib.gather_rows(x) is x


def test_pipeline_tp2_dock_rank0_writes(tmp_path):
    torch.set_num_threads(1)
    one = torch_ranks.dock_demo(1, str(tmp_path / "one"))
    ranks = run_ranks(torch_ranks.tp_dock, TP, args=(str(tmp_path),), rdv_dir=str(tmp_path / "rdv"))
    assert ranks[0]["all_rmsd"] == ranks[1]["all_rmsd"]
    np.testing.assert_allclose(ranks[0]["all_rmsd"], one["all_rmsd"], rtol=1e-5)
    assert "top5_rmsd.json" in ranks[0]["wrote"] and ranks[0]["wrote"] == one["wrote"]
    assert ranks[1]["wrote"] == []
