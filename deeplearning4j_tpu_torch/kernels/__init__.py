"""Hand-written Hopper kernels: build, wrappers, registry, tuner, routing.

- ``build``: compiles ``csrc/*.cu`` with ``nvcc`` at first use into
  shared libraries bound with ``ctypes``;
- ``impls``: each kernel's wrapper (launch counter, input checks, the
  tiling it launches at) beside its plain PyTorch version;
- ``registry``: the five tuned kernels (the JAX package's ids), each with
  its envelope, tiling space, default tiling and plain version;
- ``tuner``: the per-(shape, dtype, backend) autotuner and the
  digest-verified on-disk tuning cache (temp + rename; a corrupt file is a
  named refusal, and the routes run each kernel at its default tiling);
- ``routing``: the forward-pass dispatch behind ``conf.use_kernels``, the
  capability probe, and the envelope planning the tuner runs from.

``cache_tag(conf)``'s ``kern:<id>:<digest>`` tokens are the JAX package's
step-key tokens; eager PyTorch has no executables to key, so the models
report the tag (``_ktag``) and every routed call resolves its tiling
against the tuning cache's epoch.

``DL4J_TORCH_KERNEL_CACHE=<path>`` binds the process-global tuning cache
to a file at import (the JAX package reads its own variable,
``DL4J_TPU_KERNEL_CACHE``: a file shared by both would have each drop the
other's entries on save).

Importing this package builds nothing and needs no GPU.
"""

from __future__ import annotations

import os

from deeplearning4j_tpu_torch.kernels import build as build  # noqa: F401
from deeplearning4j_tpu_torch.kernels import impls as impls  # noqa: F401
from deeplearning4j_tpu_torch.kernels import registry as registry  # noqa: F401
from deeplearning4j_tpu_torch.kernels import routing as routing  # noqa: F401
from deeplearning4j_tpu_torch.kernels import tuner as tuner  # noqa: F401
from deeplearning4j_tpu_torch.kernels.registry import (  # noqa: F401
    REGISTRY,
    AttentionEnvelope,
    Kernel,
    KernelRegistry,
    MatmulEnvelope,
    Selection,
)
from deeplearning4j_tpu_torch.kernels.routing import (  # noqa: F401
    autotune_decoder,
    autotune_model,
    capability,
    decoder_envelopes,
    maybe_decode_attention,
    maybe_flash_attention,
    maybe_forward,
    maybe_vertex_forward,
    plan_envelopes,
    routed_sites,
)
from deeplearning4j_tpu_torch.kernels.tuner import (  # noqa: F401
    TUNING,
    AutotuneResult,
    TuningCache,
    TuningCacheCorruptError,
    autotune,
    set_tuning_cache,
)


def tuning_digest(kernel_id: str) -> str:
    """The registry's current 8-hex tuning digest for one kernel (what the
    ``kern:<id>:<digest>`` tokens carry)."""
    return REGISTRY.tuning_digest(kernel_id)


def cache_tag(conf=None) -> str:
    """The token string for a model conf: empty unless
    ``conf.use_kernels``, else one ``:kern:<id>:<digest>`` token per
    registered kernel. Cheap per call: digests are memoized against the
    tuning-cache epoch."""
    if conf is not None and not getattr(conf, "use_kernels", False):
        return ""
    return REGISTRY.cache_tag()


# opt-in persistent cache via the environment (bound at import, so
# importing the package touches the filesystem only when asked)
_ENV_CACHE = "DL4J_TORCH_KERNEL_CACHE"
if os.environ.get(_ENV_CACHE):
    try:
        set_tuning_cache(os.environ[_ENV_CACHE])
    except TuningCacheCorruptError:
        # refused: the named error already detached the file; every route
        # runs its kernel at the default tiling until a fresh cache is bound
        pass
