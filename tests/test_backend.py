"""The backend switch (auromat_tpu.backend): which binning route each
backend takes, that every dispatch site follows it, and the compile-cache
helper."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import auromat_tpu.backend as backend
from auromat_tpu.ops.regrid import fixed_grid


@pytest.fixture
def as_gpu(monkeypatch):
    """Make the default backend read as a GPU (arrays stay on the CPU)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_cpu_takes_the_oracle_route():
    assert not backend.on_gpu()
    assert backend.mean_bin_method() == backend.ORACLE_BIN_METHOD == "sorted"


def test_gpu_takes_the_gpu_route(as_gpu):
    assert backend.on_gpu()
    assert backend.mean_bin_method() == backend.GPU_BIN_METHOD == "scatter"


@pytest.mark.parametrize("grid_args", [
    ((36, 25), 47.0, 62.0, -112.0, -91.0),  # 12 MP regional, 540 x 525
    (20, -89.999, 89.999, -179.999, 179.999),  # 0.05 deg global, 3599 x 7199
])
def test_fused_step_route_for_both_grid_sizes(as_gpu, monkeypatch,
                                              grid_args):
    """Both measured grid sizes take the same GPU route: the fused step
    asks the switch, whatever the grid's cell count."""
    import auromat_tpu.ops.georegrid as georegrid

    seen = []
    monkeypatch.setattr(georegrid, "_georegrid",
                        lambda grid, dyn, img, mask, method: seen.append(
                            (grid.n_lat * grid.n_lon, method)))
    grid = fixed_grid(*grid_args)
    georegrid.georegrid_partial(grid, None, None)
    assert seen == [(grid.n_lat * grid.n_lon, backend.GPU_BIN_METHOD)]


def test_resample_auto_follows_the_switch(as_gpu, monkeypatch):
    import auromat_tpu.resample as resample_mod
    from test_resample import synthetic

    seen = []
    real = resample_mod.bin_mean

    def spy(grid, lats, lons, data, method):
        seen.append(method)
        return real(grid, lats, lons, data, method=method)

    monkeypatch.setattr(resample_mod, "bin_mean", spy)
    m = resample_mod.resample(synthetic(), px_per_deg=2, method="mean")
    assert seen == [backend.GPU_BIN_METHOD]
    m.checkPlateCarree()


def test_cli_refuses_an_unavailable_platform(tmp_path, capsys):
    """--platform gpu on a machine (or process) without a GPU exits
    nonzero instead of converting on another backend."""
    from auromat_tpu.cli import convert

    before = jax.config.jax_platforms
    try:
        rc = convert.main([str(tmp_path), "--platform", "gpu"])
    finally:
        jax.config.update("jax_platforms", before)
    assert rc == 2
    assert "platform 'gpu'" in capsys.readouterr().err


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no other directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        path = backend.enable_compile_cache()
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
