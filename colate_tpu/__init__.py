"""colate_tpu — a coalescence-rate engine in JAX.

A from-scratch reimplementation of the capabilities of leospeidel/Colate
built on JAX/XLA, run on an NVIDIA GPU or the CPU:

- host-side columnar preprocessing of site streams (numpy / C++),
- device-side binning of mutation-age evidence into block histograms,
- a fully vectorized EM over [bootstraps, age_bins, epochs] tensors,
- block-bootstrap as a batched matmul,
- multi-device scaling via ``jax.sharding`` + ``shard_map`` + ``psum``.

The reference implementation is a single-core C++ CLI; nothing here is a
translation of it.  File-format compatibility (``.mut``, ``.colate.in``,
``.coal``, ``.colate_mat``) and numerical parity on its workloads are
preserved so existing Colate users can switch directly.
"""

__version__ = "0.1.0"

import os as _os


# the persistent compile cache's default home: fixed inside the checkout,
# because the directory is part of every cache key
_DEFAULT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes (compiles of the f64
    EM program are expensive; steady-state iteration is microseconds).

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and no other
    directory is set here; otherwise the cache lives in ``.jax_cache``
    at the root of the checkout."""
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def enable_x64() -> None:
    """Enable float64 in JAX (required for reference-parity numerics)."""
    import jax

    jax.config.update("jax_enable_x64", True)
