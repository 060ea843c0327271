"""Build the kernels ahead of the first frame (the port's counterpart of
`raytracing_tpu.utils.cache.enable_persistent_cache`).

The JAX package pays its compile cost when XLA traces a program and keeps
it in a persistent compilation cache. The port's one compile is the
`nvcc` build of `csrc/*.cu` (`kernels.cuda.build`), already cached by a
hash of the sources and flags in `raytracing_tpu_torch/_build/`. This
module builds or reuses that library and loads it before any frame, so a
first frame's time never includes `nvcc`.
"""

from __future__ import annotations

import torch

from raytracing_tpu_torch.kernels import cuda


def enable_persistent_cache(device="cuda") -> str:
    """Build (or reuse) and load the kernel library when `device` is a
    card; build nothing for the CPU, whose queries run the plain versions.
    Returns the build directory. Raises where the library cannot build."""
    if torch.device(device).type == "cuda":
        cuda.library()
    return cuda.BUILD_DIR
