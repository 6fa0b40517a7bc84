"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, bench, chip smoke test, tests):
when `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it and nothing is set
here; otherwise the cache lives at a fixed path inside the checkout,
`<repo>/.jax_cache` (listed in .gitignore). The path is part of the
cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[Path]:
    """The directory this process must configure, or None when the
    environment variable already names one."""
    if environ.get(ENV_VAR):
        return None
    return REPO_CACHE_DIR


def configure_compile_cache() -> Optional[Path]:
    """Apply compile_cache_dir() to jax.config; returns what was set."""
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
