"""Compare what the port's train-to-dock gate trains on with what the JAX
gate trains on, on the CPU: the inputs of `scripts/torch_overfit_gate.py`
against those of `scripts/overfit_gate.py`.

    python scripts/torch_gate_inputs_check.py [--seed 1]

  * the 4 demo systems featurized as each gate does (crop 128/1024,
    inference mode, 4 MSA rounds; the JAX gate through its
    `FeaturizerWorker`): every feature and every MSA variant, and the
    shape groups the steps rotate over;
  * the draws of a training step, as distributions: 200k uniform
    rotations of each package (trace mean and std: 0 and 1 for a uniform
    rotation), and `augmentation_diffuse`'s t_hat (log t_hat / sigma_data
    ~ N(-1.2, 1.5^2)) and the per-coordinate displacement of x_hat from
    x_gt over 4096 samples of each.

Prints one JSON line. It runs both packages, so it is a comparison tool
like the tests, not part of the port.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--cache", default=None, help="the JAX worker's feature cache dir")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from physdock_tpu.config import PhysDockConfig as JaxConfig
    from physdock_tpu.data.feat_worker import FeaturizerWorker
    from physdock_tpu.data.synthetic import make_synthetic_batch
    from physdock_tpu.model.physdock import PhysDock as JaxPhysDock
    from physdock_tpu.utils.geometry import uniform_random_rotation as jax_rotation
    from physdock_tpu_torch.config import PhysDockConfig
    from physdock_tpu_torch.data.feature_loader import SystemFeaturizer
    from physdock_tpu_torch.model.physdock import PhysDock, prepare_batch
    from physdock_tpu_torch.utils.geometry import uniform_random_rotation

    demo = os.path.join(REPO, "demo", "redocking")
    msa = dict(msa_features_dir=os.path.join(demo, "features", "msa_features"),
               uniprot_msa_features_dir=os.path.join(demo, "features", "uniprot_msa_features"),
               inference_mode=True, seed=args.seed)
    named = dict(crop_size=128, atom_crop_size=1024, infer_use_pocket=True,
                 infer_use_key_res=True, num_augmentation_sample=8)
    systems = sorted(glob.glob(os.path.join(demo, "Posebusters_subset", "*.pkl.gz")))
    worker = FeaturizerWorker(JaxConfig.named("toy", **named).data, cache_dir=args.cache, **msa)
    jax_loads = [worker.load(s, num_msa_rounds=4)[:2] for s in systems]
    worker.stop()
    port = SystemFeaturizer(PhysDockConfig.named("toy", **named).data, **msa)
    report = {"seed": args.seed, "systems": {}}
    groups = {"jax": {}, "port": {}}
    for s, (jf, jmeta) in zip(systems, jax_loads):
        tf, tmeta = port.load(s, num_msa_rounds=4)
        name = os.path.basename(s).replace(".pkl.gz", "")
        same_keys = set(jf) == set(tf)
        feat_err = max(float(np.abs(np.asarray(jf[k], np.float64) - np.asarray(tf[k], np.float64))
                             .max()) for k in jf) if same_keys else None
        jv, tv = jmeta["batch_msa_feat"], tmeta["batch_msa_feat"]
        var_err = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
                      for a, b in zip(jv, tv))
        report["systems"][name] = {"same_keys": same_keys, "feature_max_abs_diff": feat_err,
                                   "msa_variants": [len(jv), len(tv)],
                                   "msa_variant_max_abs_diff": var_err}
        for pkg, f in (("jax", jf), ("port", tf)):
            sig = str(sorted((k, np.shape(v)) for k, v in f.items()))
            groups[pkg].setdefault(sig, []).append(name)
    report["groups"] = {pkg: sorted(g.values()) for pkg, g in groups.items()}

    n = 200_000
    rots = {"jax": np.asarray(jax_rotation(jax.random.PRNGKey(args.seed), (n,))),
            "port": uniform_random_rotation((n,), torch.Generator().manual_seed(args.seed),
                                            "cpu").numpy()}
    report["rotation_trace"] = {k: [float(np.trace(r, axis1=-2, axis2=-1).mean()),
                                    float(np.trace(r, axis1=-2, axis2=-1).std())]
                                for k, r in rots.items()}

    n_aug = 4096
    batch = make_synthetic_batch(n_tokens=16, n_atoms=48, n_msa=4, n_ligand_tokens=6)
    jm = JaxPhysDock(cfg=JaxConfig.named("toy", num_augmentation_sample=n_aug).model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb, jax.random.PRNGKey(1))
    jx, jt = jm.apply(params, jb, jax.random.PRNGKey(args.seed), method="augmentation_diffuse")
    tm = PhysDock(PhysDockConfig.named("toy", num_augmentation_sample=n_aug).model)
    tb = prepare_batch({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    tx, tt = tm.augmentation_diffuse(tb, torch.Generator().manual_seed(args.seed))
    sd = 16.0
    exists = np.asarray(batch["x_exists"]) > 0
    for pkg, x, t in (("jax", np.asarray(jx), np.asarray(jt)), ("port", tx.numpy(), tt.numpy())):
        log_t = np.log(t / sd)
        # x_hat's distance from the centred x_gt grows with t: its spread
        # over the real atoms divided by t is ~ 1 for every sample
        x0 = np.asarray(batch["x_gt"])[exists]
        centred = x[:, exists] - x[:, exists].mean(1, keepdims=True)
        scale = np.sqrt(np.mean(centred ** 2, axis=(1, 2)))
        ref = np.sqrt(np.mean((x0 - x0.mean(0)) ** 2))
        big = t > 50 * ref
        report[f"t_hat_{pkg}"] = {"log_mean": float(log_t.mean()), "log_std": float(log_t.std()),
                                  "spread_over_t_high_noise": float(np.mean(scale[big] / t[big]))}
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
