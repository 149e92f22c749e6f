"""Diagnostic plotting (port of ``waveforminversionust_tpu.viz``), mirroring
the reference's figures.

Reference panels: forward/adjoint wavefields (re/im, fwi_script.py:133-183),
true vs estimated sound speed + search direction + negative gradient
(fwi_script.py:186-239, FrequencyDomainFWI.m:176-188), plus the imagesc-style
helper. Every function renders headless (matplotlib's Agg backend) and takes
tensors on any device or numpy arrays, read through :mod:`.utils.host`.
"""

from __future__ import annotations

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .models.grid import Grid2D  # noqa: E402
from .utils.host import fetch  # noqa: E402

SPEED_RANGE = (1400.0, 1600.0)  # reference display range [m/s]


def imagesc(ax, grid: Grid2D, img, rng=None, cmap="gray", title=None,
            colorbar=True):
    """MATLAB imagesc-style panel: physical extent, y down, gray colormap."""
    img = fetch(img)
    xmin, xmax, ymin, ymax = grid.extent
    vmin, vmax = (rng if rng is not None else (None, None))
    im = ax.imshow(img, extent=[xmin, xmax, ymax, ymin], cmap=cmap,
                   origin="upper", vmin=vmin, vmax=vmax)
    ax.set_xlabel("Lateral [m]")
    ax.set_ylabel("Axial [m]")
    if title:
        ax.set_title(title)
    if colorbar:
        plt.colorbar(im, ax=ax)
    return im


def plot_wavefields(grid: Grid2D, wavefield, adjoint_field, tx: int = 0,
                    path: str | None = None):
    """4-panel forward/adjoint wavefield figure (reference:
    fwi_script.py:133-183)."""
    wv = fetch(wavefield)[tx]
    adj = fetch(adjoint_field)[tx]
    fig, axs = plt.subplots(2, 2, figsize=(12, 10))
    scale = max(np.abs(adj).max(), 1e-30)
    imagesc(axs[0, 0], grid, adj.real, (-scale / 10, scale / 10),
            title="Adjoint Wavefield (real)")
    imagesc(axs[0, 1], grid, adj.imag, (-scale / 10, scale / 10),
            title="Adjoint Wavefield (imag)")
    wscale = max(np.abs(wv).max(), 1e-30)
    imagesc(axs[1, 0], grid, wv.real, (-wscale / 10, wscale / 10),
            title="Forward Wavefield (real)")
    imagesc(axs[1, 1], grid, wv.imag, (-wscale / 10, wscale / 10),
            title="Forward Wavefield (imag)")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_reconstruction(grid: Grid2D, velocity, search_dir=None,
                        gradient=None, true_map=None,
                        true_grid: Grid2D | None = None,
                        iteration: int | None = None,
                        path: str | None = None):
    """True-vs-estimated + search direction + negative gradient panels
    (reference: fwi_script.py:186-239)."""
    fig, axs = plt.subplots(2, 2, figsize=(12, 10))
    if true_map is not None:
        imagesc(axs[0, 0], true_grid or grid, fetch(true_map),
                SPEED_RANGE, title="True Sound Speed [m/s]")
    else:
        axs[0, 0].axis("off")
    title = "Estimated Sound Speed"
    if iteration is not None:
        title += f" (iter {iteration})"
    imagesc(axs[0, 1], grid, fetch(velocity), SPEED_RANGE, title=title)
    if search_dir is not None:
        imagesc(axs[1, 0], grid, fetch(search_dir), title="Search Direction")
    else:
        axs[1, 0].axis("off")
    if gradient is not None:
        imagesc(axs[1, 1], grid, -fetch(gradient), title="Negative Gradient")
    else:
        axs[1, 1].axis("off")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_convergence(metrics: dict, path: str | None = None):
    """Loss/grad-norm/step history — the observability the reference lacks
    (SURVEY.md section 5: no loss history is recorded)."""
    keys = [k for k in ("loss", "grad_norm", "step_size", "beta")
            if k in metrics]
    fig, axs = plt.subplots(1, len(keys), figsize=(4.5 * len(keys), 3.6))
    if len(keys) == 1:
        axs = [axs]
    for ax, key in zip(axs, keys):
        vals = fetch(metrics[key])
        if key in ("loss", "grad_norm"):
            ax.semilogy(vals, marker="o", ms=3)
        else:
            ax.plot(vals, marker="o", ms=3)
        ax.set_title(key)
        ax.set_xlabel("iteration")
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def plot_time_snapshots(grid: Grid2D, result, n_frames: int = 6,
                        path: str | None = None):
    """Wavefield-vs-time film strip + channel data (reference:
    TimeDomainSimulation.m:58-91)."""
    nt = result.wavefields_t.shape[0]
    picks = np.linspace(0, nt - 1, n_frames).astype(int)
    fig, axs = plt.subplots(1, n_frames + 1, figsize=(3.2 * (n_frames + 1), 3.2))
    for ax, ti in zip(axs[:-1], picks):
        frame = fetch(result.wavefields_t[ti]).real
        scale = max(np.abs(frame).max(), 1e-30)
        imagesc(ax, grid, frame, (-scale, scale),
                title=f"t = {result.times[ti] * 1e6:.1f} us", colorbar=False)
    cd = np.real(result.channel_data)
    axs[-1].imshow(cd, aspect="auto", cmap="gray",
                   extent=[0, cd.shape[1], result.times[-1] * 1e6, 0])
    axs[-1].set_xlabel("Element")
    axs[-1].set_ylabel("time [us]")
    axs[-1].set_title("Channel Data")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return fig


def save_time_animation(grid: Grid2D, result, path: str, fps: int = 15,
                        max_frames: int = 120):
    """Animated wavefield playback (reference: TimeDomainSimulation.m:58-91
    and SimulateData.m:39-52 render live `imagesc` movies; this writes the
    same film to a GIF so it survives headless runs).

    Per-frame normalization matches the reference's `imagesc(..., [-1 1] *
    max(abs(frame)))` behavior: the propagating front stays visible as the
    field geometrically spreads.

    Args:
        result: a :class:`~.data.timedomain.TimeDomainResult` (its
            wavefields on any device).
        path: output file; ``.gif`` (Pillow writer, always available).
        max_frames: stride long simulations down to this many frames.
    """
    from matplotlib import animation

    nt = result.wavefields_t.shape[0]
    picks = (np.arange(nt) if nt <= max_frames
             else np.linspace(0, nt - 1, max_frames).astype(int))
    frames = [fetch(result.wavefields_t[t]).real for t in picks]

    fig, ax = plt.subplots(figsize=(4.4, 4.2))
    scale0 = max(np.abs(frames[0]).max(), 1e-30)
    im = ax.imshow(frames[0], cmap="gray", vmin=-scale0, vmax=scale0,
                   extent=[grid.x[0] * 1e3, grid.x[-1] * 1e3,
                           grid.y[-1] * 1e3, grid.y[0] * 1e3])
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("y [mm]")
    title = ax.set_title("")

    def draw(i):
        frame = frames[i]
        scale = max(np.abs(frame).max(), 1e-30)
        im.set_data(frame)
        im.set_clim(-scale, scale)
        title.set_text(f"t = {result.times[picks[i]] * 1e6:.1f} us")
        return [im, title]

    anim = animation.FuncAnimation(fig, draw, frames=len(frames), blit=False)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def make_live_plot_callback(outdir: str, grid: Grid2D, true_map=None,
                            true_grid: Grid2D | None = None,
                            overwrite: bool = True):
    """Live reconstruction plotting at the reference's cadence.

    The MATLAB script redraws its diagnostic panel every CG iteration
    (FrequencyDomainFWI.m:176-188). Pass the returned callback to
    ``invert_dataset(live_every=1, live_callback=...)``: every chunk it
    writes ``<outdir>/live.png`` (or ``live_sXX_iterYYYY.png`` with
    ``overwrite=False`` to keep the whole filmstrip) — headless-safe.
    """
    import os

    os.makedirs(outdir, exist_ok=True)

    def callback(stage_idx, frequency, iteration, velocity, chunk_metrics):
        name = ("live.png" if overwrite
                else f"live_s{stage_idx:02d}_iter{iteration:04d}.png")
        plot_reconstruction(grid, velocity, true_map=true_map,
                            true_grid=true_grid, iteration=iteration,
                            path=os.path.join(outdir, name))

    return callback
