"""Multi-host runtime init + host-side batch splitting.

The reference has no distributed layer (SURVEY.md §2: collective backend
ABSENT; topology handled by external CPU pinning in run_benchmark.sh:5-17).
This module is the equivalent demanded by BASELINE.md: the jax distributed
runtime connects the host processes, and collectives inside jitted code go
to NCCL.
"""
from __future__ import annotations

import jax

from ..utils.logger import info
from ..utils.mathutil import balance211


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the multi-host runtime (no-op for one process).

    Wraps ``jax.distributed.initialize``. Nothing in the environment
    describes the cluster, so the coordinator address, process count and
    this process's index are required; a failed init raises.
    """
    if num_processes is None or num_processes <= 1:
        info("single process; skipping distributed init")
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    info("distributed runtime up: process %d/%d",
         jax.process_index(), jax.process_count())


def local_batch_slice(global_batch: int):
    """This host's [start, end) slice of the global batch — balance211 over
    processes (the reference's work split, util/deepfusion_utils.h:190-208,
    reused at host granularity)."""
    return balance211(global_batch, jax.process_count(), jax.process_index())


def global_devices_mesh_shape():
    return {"hosts": jax.process_count(),
            "devices_per_host": jax.local_device_count(),
            "total": jax.device_count()}
