"""chip_smoke.py's phases at tiny sizes on the CPU (the rehearsal of the
on-card run), and its refusal to run without a GPU."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

from deepfusion_tpu.models import FusionNet, FusionNetConfig  # noqa: E402

TINY = dict(n=2, hw=8, ic=64, oc=64, oc1=32)


@pytest.fixture(scope="module")
def tiny_net():
    return FusionNet(FusionNetConfig(batch=2, hw=8, in_ch=16, width=32,
                                     num_classes=16))


def test_op_phase_exact():
    res = chip_smoke.op_phase(np.random.default_rng(0), flagship=TINY,
                              small=28, log=lambda *_: None)
    assert len(res) == 7
    assert all(r["max_abs_diff"] == 0 for r in res), res


def test_model_phase_exact(tiny_net):
    res, fwd, x = chip_smoke.model_phase(tiny_net, log=lambda *_: None)
    assert all(r["ok"] for r in res), res
    assert res[0]["max_abs_diff"] == 0


def test_serving_phase_pads_last_flush(tiny_net):
    import jax
    r = chip_smoke.serving_phase(tiny_net, jax.jit(tiny_net.__call__),
                                 n_requests=5, log=lambda *_: None)
    assert r["ok"] and r["padded_rows"] >= 1


def test_timing_phase_runs_both_impls(tiny_net):
    out = chip_smoke.timing_phase(np.random.default_rng(0), tiny_net,
                                  flagship=TINY, n=1, log=lambda *_: None)
    assert set(out) == {"flagship_triton", "flagship_xla",
                        "fusionnet_triton", "fusionnet_xla"}


def test_four_phase_on_virtual_devices():
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    res = chip_smoke.four_phase(np.random.default_rng(0), small=8,
                                log=lambda *_: None)
    assert len(res) == 4
    assert all(r["exact"] for r in res), res
    assert all(len(r["shard_devices"]) > 1 for r in res), res


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_card_info_is_a_string():
    assert isinstance(chip_smoke.card_info(), str)
