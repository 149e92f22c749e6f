"""The port's plots render to matplotlib's Agg backend from the port's own
result types (tensors, complex64 fields, the runner's numpy metrics, a
TimeDomainResult), as the JAX package's tests/test_misc.py renders its
own; the live-plot callback through a 2-iteration invert_dataset on the
CPU.
"""

import os

import numpy as np
import torch

from waveforminversionust_tpu_torch import viz
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig)
from waveforminversionust_tpu_torch.data.synthesize import \
    synthesize_ring_dataset
from waveforminversionust_tpu_torch.data.timedomain import \
    simulate_time_domain
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.models.phantom import smooth_blob_phantom

PML = PMLConfig(l_pml=2.4e-3)


def _size(path):
    return os.path.getsize(path)


def test_backend_is_agg():
    import matplotlib
    assert matplotlib.get_backend().lower() == "agg"


def test_field_and_reconstruction_panels(tmp_path):
    """plot_wavefields on complex64 tensors, plot_reconstruction on tensors
    and numpy, plot_convergence on tensors and numpy, imagesc alone."""
    grid = Grid2D.centered(10e-3, 0.5e-3)
    rng = np.random.default_rng(0)
    field = torch.as_tensor((rng.standard_normal((2,) + grid.shape)
                             + 1j * rng.standard_normal((2,) + grid.shape))
                            .astype(np.complex64))
    viz.plot_wavefields(grid, field, field * 2, tx=1,
                        path=str(tmp_path / "wv.png"))
    vel = torch.full(grid.shape, 1500.0)
    viz.plot_reconstruction(grid, vel, search_dir=vel - 1500.0,
                            gradient=torch.ones(grid.shape),
                            true_map=np.full(grid.shape, 1520.0),
                            iteration=3, path=str(tmp_path / "rec.png"))
    viz.plot_convergence({"loss": torch.logspace(0, -3, 10),
                          "grad_norm": np.logspace(1, -2, 10),
                          "step_size": np.ones(10)},
                         path=str(tmp_path / "conv.png"))
    fig = viz.plot_convergence({"loss": np.ones(3)})
    viz.plt.close(fig)
    fig, ax = viz.plt.subplots()
    im = viz.imagesc(ax, grid, vel, viz.SPEED_RANGE, title="t")
    assert im.get_clim() == viz.SPEED_RANGE
    viz.plt.close(fig)
    for f in ("wv.png", "rec.png", "conv.png"):
        assert _size(tmp_path / f) > 10_000, f


def test_time_snapshots_and_animation(tmp_path):
    """The film strip and the GIF from the port's TimeDomainResult (its
    wavefields a complex64 tensor) on a 25^2 grid."""
    grid = Grid2D.centered(12e-3, 1e-3)
    res = simulate_time_domain(np.full(grid.shape, 1500.0, np.float32), grid,
                               element_idx=3, f_low=0.2e6, f_high=0.3e6,
                               df=0.05e6, nt=9, num_elements=16,
                               radius=9e-3, solver=SolverConfig(pml=PML),
                               device="cpu")
    assert isinstance(res.wavefields_t, torch.Tensor)
    viz.plot_time_snapshots(grid, res, n_frames=3,
                            path=str(tmp_path / "snap.png"))
    out = viz.save_time_animation(grid, res, str(tmp_path / "film.gif"),
                                  max_frames=4)
    assert out == str(tmp_path / "film.gif")
    assert _size(tmp_path / "snap.png") > 10_000
    with open(tmp_path / "film.gif", "rb") as fh:
        assert fh.read(6) in (b"GIF89a", b"GIF87a")


def test_live_plot_callback_through_invert_dataset(tmp_path):
    """make_live_plot_callback is the callback invert_dataset calls every
    live_every iterations: a panel each call, kept as a filmstrip."""
    grid = Grid2D.centered(8e-3, 0.8e-3)
    vel = smooth_blob_phantom(grid, radius=2.5e-3, dc=40, c_bkgnd=1500.0)
    acq = AcquisitionConfig(num_elements=8, radius=5e-3,
                            num_excluded_each_side=1)
    ds = synthesize_ring_dataset(vel, grid, acq, f=300e3, seed=1,
                                 solver=SolverConfig(pml=PML), device="cpu")
    outdir = str(tmp_path / "live")
    cb = viz.make_live_plot_callback(outdir, grid, true_map=vel,
                                     true_grid=grid, overwrite=False)
    res = invert_dataset(ds, grid=grid, acquisition=acq,
                         solver=SolverConfig(pml=PML),
                         fwi=FWIConfig(num_iterations=2, c_init=1500.0),
                         live_every=1, live_callback=cb, device="cpu")
    assert np.isfinite(res.metrics["loss"]).all()
    frames = sorted(os.listdir(outdir))
    assert frames and all(f.startswith("live_s00_iter") for f in frames)
    assert "live_s00_iter0002.png" in frames
    assert all(_size(os.path.join(outdir, f)) > 10_000 for f in frames)
