"""Device ops (encode/decode/CRC) and the host bit-I/O oracle.

Importing this package places JAX's persistent compilation cache, so that a
fresh process does not compile the codec's jitted pipelines again.  Where
JAX_COMPILATION_CACHE_DIR (or jax.config) names a cache, JAX uses it and
nothing here changes it; otherwise the cache is <repo>/.jax_cache, a fixed
path inside the checkout that .gitignore lists.
"""

from pathlib import Path

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def _place_compile_cache() -> None:
    import jax

    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))


_place_compile_cache()
