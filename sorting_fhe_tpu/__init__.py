"""sorting_fhe_tpu: CKKS homomorphic sorting framework in JAX.

A from-scratch JAX rebuild of the capabilities of oksuman/sorting-fhe
(C++/OpenFHE): an RNS-CKKS runtime (uint32 Montgomery RNS, negacyclic NTT,
hybrid key switching, Galois rotations with hoisting, Chebyshev evaluation)
plus the four encrypted-sorting pipelines built on it (direct rank sort,
bitonic, k-way networks, MEHP24 order statistics).

Layout:
  core/      CKKS crypto runtime (the layer the reference gets from OpenFHE)
  ops/       homomorphic primitives: sign, comparison, rotation, coeff gen
  models/    sorting pipelines (direct, hybrid, bitonic, k-way, mehp24)
  parallel/  multi-device sharding (jax.sharding; NCCL over NVLink on GPUs)
  utils/     plaintext oracle context, test vectors, profiling
"""

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ) -> str | None:
    """Directory this package points JAX's persistent compilation cache at:
    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads it itself),
    otherwise the fixed `<checkout>/.jax_cache`.  A fixed path matters:
    the directory is part of every cache key."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


# The op kernels compile once per (operation, limb bucket); caching them
# across processes makes benchmark start-up much faster.
if (_cache_dir := compile_cache_dir()) is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.4)

__version__ = "0.1.0"
