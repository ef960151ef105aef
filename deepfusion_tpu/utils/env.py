"""Environment toggles, the compile cache and the kernels' interpret switch.

Reference parity: ``util/scaffold.cc:56-82`` — ``DEEPFUSION_PROFILE`` enables
per-submit wall-clock reporting, ``DEEPFUSION_DUMP_CODE`` dumps generated JIT
machine code. The analogue of a code dump here is the lowered HLO text
(``DEEPFUSION_DUMP_CODE=1`` writes ``df_dump_<name>.<n>.txt``).
"""
from __future__ import annotations

import os

_TRUTHY = ("1", "true", "yes", "on")
_INTERPRET = False


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in _TRUTHY


def is_profiling() -> bool:
    """Reference: ``utils::is_profiling`` (util/scaffold.cc:56-66)."""
    return _env_flag("DEEPFUSION_PROFILE")


def dump_code() -> bool:
    """Reference: ``utils::jit_dump_code`` (util/scaffold.cc:71-82)."""
    return _env_flag("DEEPFUSION_DUMP_CODE")


def set_interpret_kernels(on: bool) -> None:
    """Run Pallas kernels in the interpreter. Only the CPU test suite turns
    this on; nothing else does, so on a GPU every kernel runs compiled."""
    global _INTERPRET
    _INTERPRET = bool(on)


def interpret_kernels() -> bool:
    return _INTERPRET


def compile_cache_dir() -> str:
    """JAX's persistent compile cache: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it itself), else ``.jax_cache/`` at the checkout root.
    A fixed path, because the path is part of what the cache is keyed
    on."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX at ``compile_cache_dir()``; returns the directory. Sets
    nothing when ``JAX_COMPILATION_CACHE_DIR`` is set."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
