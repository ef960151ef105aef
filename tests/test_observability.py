"""Profiling toggle, lowered-code dump, and env-flag tests.

Reference parity: DEEPFUSION_PROFILE per-submit timing
(src/deepfusion.cc:90-103; note the reference's WITH_VERBOSE build is
broken as shipped — SURVEY.md §2 C2), DEEPFUSION_DUMP_CODE JIT dump
(src/jit_generator.h:261-296).
"""
import os

import numpy as np
import pytest

import deepfusion_tpu as df
from deepfusion_tpu.utils import env


def test_env_flags(monkeypatch):
    monkeypatch.setenv("DEEPFUSION_PROFILE", "1")
    assert env.is_profiling()
    monkeypatch.setenv("DEEPFUSION_PROFILE", "0")
    assert not env.is_profiling()
    monkeypatch.setenv("DEEPFUSION_DUMP_CODE", "true")
    assert env.dump_code()
    monkeypatch.delenv("DEEPFUSION_DUMP_CODE")
    assert not env.dump_code()


def test_profile_logs_submit(monkeypatch, caplog, rng):
    monkeypatch.setenv("DEEPFUSION_PROFILE", "1")
    a = df.memory([1, 16, 2, 2], df.format.nhwc, df.s8).fill_random(rng)
    dst = df.memory([1, 16, 2, 2], df.format.nhwc, df.s8)
    op = df.concat([a], dst, post_relu=True)
    import logging
    with caplog.at_level(logging.INFO, logger="deepfusion_tpu"):
        op.submit()
    assert any("infer" in r.message and "ms" in r.message
               for r in caplog.records)


def test_dump_lowered(monkeypatch, tmp_path, rng):
    monkeypatch.setenv("DEEPFUSION_DUMP_CODE", "1")
    monkeypatch.chdir(tmp_path)
    import jax

    from deepfusion_tpu.utils.profiler import maybe_dump_lowered

    f = jax.jit(lambda x: x * 2)
    path = maybe_dump_lowered("scale2", f, np.ones((4, 4), np.float32))
    assert path is not None and os.path.exists(path)
    txt = open(path).read()
    assert len(txt) > 0


def test_device_capabilities():
    caps = df.device_capabilities()
    assert caps["num_devices"] >= 1
    assert caps["platform"] == caps["device_kind"].lower() == "cpu" or \
        caps["platform"] == "gpu"
