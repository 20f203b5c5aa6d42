"""chip_smoke.py on the CPU: it refuses to run without a GPU or outside a
checkout, and each phase passes at a tiny size with the GPU binning route
compared against its reference (the card run uses the full sizes)."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from auromat_tpu.backend import GPU_BIN_METHOD

SMALL = 32  # frame downscale: 133 x 88 pixels
SMALL_GLOBAL = (2, -89.0, 89.0, -179.0, 179.0)
# rows 1121..1361 of the frame straddle the horizon: golden samples on
# both sides of it
CROP = (1121, 0, 240, 1830)


def test_main_exits_nonzero_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_create_mapping_then_resample(capsys):
    mapping = cs.phase_create_mapping(crop=CROP)
    cs.phase_resample(mapping, route=GPU_BIN_METHOD)
    out = capsys.readouterr().out
    assert "NaN masks identical" in out and "counts identical" in out


def test_phase_df64():
    cs.phase_df64(time_scale=SMALL)


def test_phase_fused():
    cs.phase_fused(cs.frame_params(SMALL), route=GPU_BIN_METHOD)


@pytest.mark.parametrize("grid_args", [cs.REGIONAL, SMALL_GLOBAL])
def test_phase_mosaic(grid_args):
    cs.phase_mosaic(cs.frame_params(SMALL), grid_args, n_frames=4, batch=2,
                    route=GPU_BIN_METHOD)


def test_phase_take_best():
    cs.phase_take_best(n_stations=3, size=32)


def test_phase_generic():
    cs.phase_generic(step=128, time_scale=SMALL)


def test_phase_multichip_on_4_virtual_devices(capsys):
    assert len(jax.devices()) >= 4
    cs.phase_multichip(cs.frame_params(SMALL), grid_args=SMALL_GLOBAL,
                       batch=4, route=GPU_BIN_METHOD)
    out = capsys.readouterr().out
    assert out.count("reduce-scatter output") == 2
    rs = [int(line.split("reduce-scatter output ")[1].split()[0])
          for line in out.splitlines() if "reduce-scatter output" in line]
    assert all(b > 0 for b in rs)


def test_parity_check_raises():
    with pytest.raises(cs.ParityError, match="boom"):
        cs.check(False, "boom")
    d, ok = cs.elevation_diff(np.array([1.0, 2.0]), np.array([1.0, 2.5]),
                              np.array([1.0, 1.0]))
    assert d == 0.5 and not ok


@pytest.mark.gpu
def test_phases_on_the_gpu(gpu):
    """The same tiny phases on a card, the device's own route compared
    with the sorted oracle and with the CPU."""
    cs.device_check()
    mapping = cs.phase_create_mapping(crop=CROP)
    cs.phase_resample(mapping)
    cs.phase_df64(time_scale=SMALL)
    cs.phase_fused(cs.frame_params(SMALL))
    cs.phase_mosaic(cs.frame_params(SMALL), SMALL_GLOBAL, n_frames=4,
                    batch=2)
    cs.phase_take_best(n_stations=3, size=32)
    cs.phase_generic(step=128, time_scale=SMALL)
