"""Per-op submit profiling + lowered-code dumping.

Reference parity: ``op::submit`` wraps ``infer`` with wall-clock timing when
profiling is on (``src/deepfusion.cc:90-103``); JIT code dump writes
``jit_dump_<name>.N.bin`` (``src/jit_generator.h:261-296``). Here the dump is
the compiled XLA text from ``jax.jit(...).lower().compile().as_text()``.
"""
from __future__ import annotations

import collections
import contextlib
import os
import tempfile

from . import env
from .logger import get_current_ms, info

_dump_counts: dict = collections.defaultdict(int)


@contextlib.contextmanager
def device_trace(log_dir: str = None):
    """Capture a device-level profiler trace (TensorBoard format; default
    directory ``df_trace`` under the temp dir).

    Upgrade of the reference's wall-clock-only profiling (SURVEY.md §5
    tracing row): wraps ``jax.profiler.trace`` so per-kernel device
    timelines are visible, not just host wall-clock.
    """
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "df_trace")
    import jax

    with jax.profiler.trace(log_dir):
        yield
    info("device trace written to %s", log_dir)


@contextlib.contextmanager
def submit_timer(name: str):
    """Time one op submit (reference: src/deepfusion.cc:91-102)."""
    if not env.is_profiling():
        yield
        return
    t0 = get_current_ms()
    yield
    info("%s infer %f ms", name, get_current_ms() - t0)


def maybe_dump_lowered(name: str, jitted, *example_args, **kwargs):
    """Dump compiled text for a jitted callable when DEEPFUSION_DUMP_CODE=1.

    Analogue of the reference's machine-code dump
    (``src/jit_generator.h:261-296``); inspect with a text editor instead of
    ``xed``.
    """
    if not env.dump_code():
        return None
    n = _dump_counts[name]
    _dump_counts[name] += 1
    path = os.path.join(os.getcwd(), f"df_dump_{name}.{n}.txt")
    try:
        txt = jitted.lower(*example_args, **kwargs).compile().as_text()
    except Exception as e:  # pragma: no cover
        txt = f"<lowering failed: {e}>"
    with open(path, "w") as f:
        f.write(txt)
    info("dumped lowered code to %s", path)
    return path
