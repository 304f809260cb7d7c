"""The JAX CLI's ``main`` for the port's tests, without its lasting side
effect: JAX ``cli.main`` turns on JAX's persistent compilation cache
(``jax_compilation_cache_dir`` and a 1 s threshold, JAX cli.py:449-460) for
the rest of its process, and a program the same test worker compiles later
can then round differently.  :func:`jax_cli_main` restores both settings
and resets the cache after the call, so later programs compile as if the
call had not been made."""

import jax
from jax._src import compilation_cache

from opticalimageprocessor_tpu import cli as jcli

_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


def jax_cli_main(argv):
    """JAX ``cli.main(argv)`` with the worker's compile-cache settings kept
    as they were."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    try:
        return jcli.main(argv)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()
