"""The port's grid, acquisition geometry and phantoms equal the JAX
package's (both are numpy; equality is exact)."""

import dataclasses

import numpy as np
import pytest

from waveforminversionust_tpu import AcquisitionConfig as JAcq
from waveforminversionust_tpu.models import acquisition as jacq
from waveforminversionust_tpu.models import phantom as jph
from waveforminversionust_tpu.models.grid import Grid2D as JGrid
from waveforminversionust_tpu_torch.config import AcquisitionConfig as TAcq
from waveforminversionust_tpu_torch.models import acquisition as tacq
from waveforminversionust_tpu_torch.models import phantom as tph
from waveforminversionust_tpu_torch.models.grid import Grid2D as TGrid


def test_grid_matches():
    for args in ((120e-3, 0.8e-3), (44e-3, 1.0e-3, 30e-3, 0.5e-3)):
        j, t = JGrid.centered(*args), TGrid.centered(*args)
        assert dataclasses.astuple(j) == dataclasses.astuple(t)
        assert j.shape == t.shape and j.extent == t.extent
        np.testing.assert_array_equal(j.x, t.x)
        np.testing.assert_array_equal(j.y, t.y)
        assert (j.h, j.aspect, j.diagonal) == (t.h, t.aspect, t.diagonal)
    x, y = np.linspace(-1e-2, 1e-2, 11), np.linspace(-2e-2, 2e-2, 21)
    assert (dataclasses.astuple(JGrid.from_arrays(x, y))
            == dataclasses.astuple(TGrid.from_arrays(x, y)))


@pytest.mark.parametrize(
    "interpolation, tx_downsample, random_amplitudes",
    [pytest.param(i, d, a, id=i if (d, a) == (4, True) else f"{i}-{d}-{a}")
     for i in ("nearest", "bilinear") for d in (4, 1, 8) for a in (True, False)])
def test_ring_acquisition_matches(interpolation, tx_downsample,
                                  random_amplitudes):
    """The reference ring on the 301^2 grid: 193 active receivers. The
    port's source cube, built by one scatter on the device asked for (here
    the CPU), and its numpy wrapper are bit for bit the JAX package's."""
    grid = JGrid.centered(120e-3, 0.8e-3)
    j = jacq.build_ring_acquisition(grid, JAcq(interpolation=interpolation,
                                               tx_downsample=tx_downsample))
    t = tacq.build_ring_acquisition(TGrid.centered(120e-3, 0.8e-3),
                                    TAcq(interpolation=interpolation,
                                         tx_downsample=tx_downsample))
    assert t.num_active_rx == 193 == j.num_active_rx
    for f in dataclasses.fields(j):
        if f.name == "grid":
            continue
        a, b = getattr(j, f.name), getattr(t, f.name)
        if a is None:
            assert b is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    amps = ((np.random.default_rng(3).standard_normal(j.num_tx)
             + 1j).astype(np.complex64) if random_amplitudes else None)
    want = j.source_fields(amplitudes=amps).view(np.uint64)
    cube = t.source_cube(amplitudes=amps, device="cpu")
    assert cube.device.type == "cpu" and cube.shape == (j.num_tx, 301, 301)
    np.testing.assert_array_equal(cube.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(
        t.source_fields(amplitudes=amps).view(np.uint64), want)
    with pytest.raises(ValueError, match="complex64"):
        t.source_fields(np.complex128, amplitudes=amps)
    np.testing.assert_array_equal(jacq.acceptance_mask(256, 31),
                                  tacq.acceptance_mask(256, 31))


def test_phantoms_match():
    grid_j, grid_t = JGrid.centered(60e-3, 0.6e-3), TGrid.centered(60e-3, 0.6e-3)
    np.testing.assert_array_equal(jph.breast_phantom(grid_j, seed=2),
                                  tph.breast_phantom(grid_t, seed=2))
    np.testing.assert_array_equal(
        jph.smooth_blob_phantom(grid_j, radius=8e-3, dc=60.0),
        tph.smooth_blob_phantom(grid_t, radius=8e-3, dc=60.0))
