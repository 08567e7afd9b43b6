"""Hand-written Hopper kernels: build, wrappers, routing.

- ``build``: compiles ``csrc/*.cu`` with ``nvcc`` at first use into
  shared libraries bound with ``ctypes``;
- ``impls``: each kernel's wrapper (launch counter, input checks) beside its
  plain PyTorch version;
- ``routing``: the forward-pass dispatch behind ``conf.use_kernels`` and
  the capability probe.

Importing this package builds nothing and needs no GPU.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.kernels import build as build  # noqa: F401
from deeplearning4j_tpu_torch.kernels import impls as impls  # noqa: F401
from deeplearning4j_tpu_torch.kernels import routing as routing  # noqa: F401
from deeplearning4j_tpu_torch.kernels.routing import (  # noqa: F401
    capability,
    maybe_forward,
    maybe_vertex_forward,
)
