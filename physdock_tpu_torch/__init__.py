"""PhysDock in PyTorch for NVIDIA Hopper: the port of `physdock_tpu`.

Same layout and module names as the JAX package, in PyTorch's idiom
(`nn.Module`s with a `ModuleList` per stack, explicit devices and
`torch.Generator`s).  The attention hot path runs on hand-written CUDA
kernels (`csrc/flash_fwd.cu`, wrapped in `ops/`); featurization, rounds,
ranking and writers are host-side NumPy copied from the JAX package.
"""

__version__ = "0.1.0"

from physdock_tpu_torch.config import PhysDockConfig, model_presets  # noqa: F401
