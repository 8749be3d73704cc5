"""NN blocks, geometry and force field of the PyTorch port against the JAX
package at small widths.

Each JAX module is initialised, its parameters replaced by seeded numpy
values (so zero-init projections do not hide a fault), carried over with
the port's weight bridge, and both run on the same numpy inputs, masks
with fully masked rows included.  Tolerance: max abs error <= 1e-4 +
1e-4 * max|ref| (fp32 on the CPU, two summation orders).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from physdock_tpu.nn import attentions as jatt
from physdock_tpu.nn import primitives as jprim
from physdock_tpu.nn import transformers as jtr
from physdock_tpu_torch.model.weights import jax_flat_to_state_dict
from physdock_tpu_torch.nn import attentions as tatt
from physdock_tpu_torch.nn import primitives as tprim
from physdock_tpu_torch.nn import transformers as ttr


@pytest.fixture(autouse=True)
def _precision():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _close(ref, out, rel=1e-4):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    err = np.abs(ref - out).max()
    assert err <= 1e-4 + rel * np.abs(ref).max(), f"max abs err {err}, max|ref| {np.abs(ref).max()}"


def _bridge(jmod, tmod, args, seed):
    """Init jmod on args, randomise its params, load them into tmod.
    Returns the randomised JAX variables."""
    variables = jmod.init(jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)
    flat = flatten_dict(variables["params"], sep="/")
    flat = {k: (rng.normal(size=np.shape(v)) * 0.3 + (1.0 if k.endswith("norm/weight") else 0.0))
            .astype(np.float32) for k, v in flat.items()}
    sd = jax_flat_to_state_dict({"params/" + k: v for k, v in flat.items()})
    tmod.load_state_dict(sd, strict=True)
    return {"params": unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _mask(rng, n):
    m = (rng.random((n, n)) > 0.2).astype(np.float32)
    m[:2] = 0.0  # fully masked rows
    return m


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _run(jmod, tmod, args, seed=0):
    variables = _bridge(jmod, tmod, [jnp.asarray(a) for a in args], seed)
    ref = jmod.apply(variables, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        out = tmod(*[_t(a) for a in args])
    return ref, out


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    if name == "attention_pair_bias":
        return (jatt.AttentionWithPairBias(), tatt.AttentionWithPairBias(64, 16),
                [f(24, 64), f(24, 24, 16), _mask(rng, 24)])
    if name == "msa_row":
        return (jatt.MSARowAttentionWithPairBias(), tatt.MSARowAttentionWithPairBias(64, 32),
                [f(3, 20, 64), f(20, 20, 32), _mask(rng, 20)])
    if name == "msa_col":
        return jatt.MSAColumnAttention(), tatt.MSAColumnAttention(64), [f(5, 12, 64)]
    if name in ("tri_update_out", "tri_update_in"):
        tr = name.endswith("in")
        return (jatt.TriangleUpdate(transpose=tr), tatt.TriangleUpdate(32, transpose=tr),
                [f(12, 12, 32), _mask(rng, 12)])
    if name in ("tri_attn_start", "tri_attn_end"):
        tr = name.endswith("end")
        pad = np.ones((12, 12), np.float32)
        pad[:, 10:] = 0.0
        pad[10:] = 0.0
        return (jatt.TriangleAttention(transpose=tr), tatt.TriangleAttention(64, transpose=tr),
                [f(12, 12, 64), _mask(rng, 12), pad])
    if name == "transition":
        return jprim.Transition(), tprim.Transition(48), [f(7, 48)]
    if name == "opm":
        return jprim.OuterProductMean(c_z=16), tprim.OuterProductMean(40, 16), [f(3, 9, 40)]
    if name == "atom_transformer":
        return (jtr.AtomTransformer(no_blocks=2), ttr.AtomTransformer(64, 16, 2),
                [f(20, 64), f(20, 20, 16), _mask(rng, 20)])
    if name == "pairformer":
        return (jtr.Pairformer(no_blocks=1), ttr.Pairformer(64, 32, 1),
                [f(10, 64), f(10, 10, 32), _mask(rng, 10)])
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "attention_pair_bias", "msa_row", "msa_col", "tri_update_out", "tri_update_in",
    "tri_attn_start", "tri_attn_end", "transition", "opm", "atom_transformer", "pairformer",
])
def test_block_matches_jax(name):
    jmod, tmod, args = _case(name)
    ref, out = _run(jmod, tmod, args)
    if isinstance(ref, tuple):
        for r, o in zip(ref, out):
            _close(r, o)
    else:
        _close(ref, out)


def test_dit_attention_and_bias_match_jax():
    rng = np.random.default_rng(7)
    bs = rng.normal(size=(2, 24, 64)).astype(np.float32)
    t = rng.normal(size=(2, 256)).astype(np.float32)
    z = rng.normal(size=(24, 24, 16)).astype(np.float32)
    zm = _mask(rng, 24)
    jmod = jatt.DiTAttention(c_s=64, c_z=16)
    tmod = tatt.DiTAttention(64, 16)
    variables = _bridge(jmod, tmod, [jnp.asarray(bs), jnp.asarray(z), jnp.asarray(t),
                                     jnp.asarray(zm)], 8)
    jb = jmod.apply(variables, jnp.asarray(z), jnp.asarray(zm), method="compute_bias")
    ref = jmod.apply(variables, jnp.asarray(bs), None, jnp.asarray(t), None, cached_bias=jb)
    with torch.no_grad():
        tb = tmod.compute_bias(_t(z), _t(zm))
        out = tmod(_t(bs), _t(t), tb)
    _close(jb, tb)
    _close(ref, out)


def test_segment_mean_pool_and_timestep_embedding_match_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 10, 8)).astype(np.float32)
    sizes = np.array([3, 2, 4, 1, 0, 0], np.int32)
    _close(jtr.segment_mean_pool(jnp.asarray(x), jnp.asarray(sizes)),
           ttr.segment_mean_pool(_t(x), _t(sizes).long()))
    ts = np.array([0.1, 3.0, -2.0], np.float32)
    _close(jprim.sinusoidal_timestep_embedding(jnp.asarray(ts)),
           tprim.sinusoidal_timestep_embedding(_t(ts)))


def test_geometry_matches_jax():
    from physdock_tpu.utils import geometry as jg
    from physdock_tpu_torch.utils import geometry as tg

    rng = np.random.default_rng(11)
    xp = rng.normal(size=(3, 30, 3)).astype(np.float32) * 5
    xg = rng.normal(size=(30, 3)).astype(np.float32) * 5
    w = (rng.random(30) > 0.3).astype(np.float32)
    _close(jg.weighted_rigid_align(jnp.asarray(xp), jnp.asarray(xg), jnp.asarray(w)),
           tg.weighted_rigid_align(_t(xp), _t(xg), _t(w)))
    m = _mask(rng, 6)
    np.testing.assert_array_equal(np.asarray(jg.gen_attn_mask(jnp.asarray(m), -1e9)),
                                  tg.gen_attn_mask(_t(m), -1e9).numpy())
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0] for _ in range(3)]).astype(np.float32)
    t = rng.normal(size=(3, 3)).astype(np.float32)
    _close(jg.apply_centre_augmentation(jnp.asarray(xp), jnp.asarray(w), jnp.asarray(R),
                                        jnp.asarray(t)),
           tg.apply_centre_augmentation(_t(xp), _t(w), _t(R), _t(t)))
    p = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(4)]
    _close(jg.signed_volume(*map(jnp.asarray, p)), tg.signed_volume(*map(_t, p)))


def test_forcefield_matches_jax():
    from physdock_tpu.model import forcefield as jff
    from physdock_tpu_torch.model import forcefield as tff

    rng = np.random.default_rng(12)
    n = 9
    ref = rng.normal(size=(n, 3)).astype(np.float32) * 1.5
    bonds = [(i, i + 1) for i in range(n - 1)] + [(0, 5)]
    z = [6, 6, 7, 6, 8, 6, 6, 16, 6]
    chiral = [(1, (0, 2, 3, 5))]
    rigid = [(0, 3)]
    jf = jff.build_ligand_ff(z, bonds, ref, chiral_centers=chiral, rigid_14=rigid)
    tf = tff.build_ligand_ff(z, bonds, ref, chiral_centers=chiral, rigid_14=rigid)
    pos = (ref[None] + rng.normal(size=(4, n, 3)).astype(np.float32) * 0.7)
    _close(jax.vmap(lambda p: jff.ff_energy(p, jf))(jnp.asarray(pos)),
           tff.ff_energy(_t(pos), tf), rel=1e-5)
    _close(jff.relax_positions(jnp.asarray(pos), jf, iters=5),
           tff.relax_positions(_t(pos), tf, iters=5))
    np.testing.assert_array_equal(np.asarray(jff.chirality_correct(jnp.asarray(pos), jf)),
                                  tff.chirality_correct(_t(pos), tf).numpy())
