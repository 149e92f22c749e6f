"""Procedural sound-speed phantoms (port of
``waveforminversionust_tpu.models.phantom``; numpy, bit-identical)."""

from __future__ import annotations

import numpy as np

from .grid import Grid2D

C_BACKGROUND = 1500.0
C_STD = 90.0


def breast_phantom(grid: Grid2D, c_bkgnd: float = C_BACKGROUND,
                   c_std: float = C_STD, seed: int = 0) -> np.ndarray:
    """Breast-like phantom: an off-center tissue disk with a fast skin rim
    and six random elliptical inclusions (1500 +/- 90 m/s; reference:
    soundSpeedPhantom2D.m:24-26). Returns (ny, nx) float32 m/s."""
    X, Y = grid.meshgrid()
    rng = np.random.default_rng(seed)
    c = np.full(grid.shape, c_bkgnd, dtype=np.float64)

    r_out = 0.35 * min(abs(grid.extent[1]), abs(grid.extent[3])) * 2.0
    cx, cy = 0.06 * r_out, -0.04 * r_out
    rr = ((X - cx) / (1.05 * r_out)) ** 2 + ((Y - cy) / (0.92 * r_out)) ** 2
    tissue = rr <= 1.0
    c[tissue] = c_bkgnd - 0.35 * c_std
    c[(rr <= 1.0) & (rr >= 0.88)] = c_bkgnd + 0.6 * c_std

    for _ in range(6):
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(0.15, 0.6) * r_out
        ex, ey = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
        a = rng.uniform(0.08, 0.22) * r_out
        b = rng.uniform(0.08, 0.22) * r_out
        tilt = rng.uniform(0, np.pi)
        dxr = (X - ex) * np.cos(tilt) + (Y - ey) * np.sin(tilt)
        dyr = -(X - ex) * np.sin(tilt) + (Y - ey) * np.cos(tilt)
        inside = (dxr / a) ** 2 + (dyr / b) ** 2 <= 1.0
        contrast = rng.uniform(-1.0, 1.0) * c_std
        c[inside & tissue] = c_bkgnd + contrast

    return c.astype(np.float32)


def disk_phantom(grid: Grid2D, radius: float, dc: float = 40.0,
                 c_bkgnd: float = C_BACKGROUND, center=(0.0, 0.0)) -> np.ndarray:
    """One homogeneous disk inclusion (the smallest inversion target)."""
    X, Y = grid.meshgrid()
    c = np.full(grid.shape, c_bkgnd, dtype=np.float64)
    inside = (X - center[0]) ** 2 + (Y - center[1]) ** 2 <= radius ** 2
    c[inside] = c_bkgnd + dc
    return c.astype(np.float32)


def smooth_blob_phantom(grid: Grid2D, radius: float, dc: float = 40.0,
                        c_bkgnd: float = C_BACKGROUND,
                        center=(0.0, 0.0)) -> np.ndarray:
    """Smooth Gaussian blob (easy single-frequency FWI target)."""
    X, Y = grid.meshgrid()
    r2 = (X - center[0]) ** 2 + (Y - center[1]) ** 2
    c = c_bkgnd + dc * np.exp(-r2 / (2 * (radius / 2.0) ** 2))
    return c.astype(np.float32)


def phantom_from_image(grid: Grid2D, image: np.ndarray,
                       pixel_size: float = 0.7e-3, threshold: float = 0.04,
                       c_bkgnd: float = C_BACKGROUND, c_std: float = C_STD,
                       rotation: float = 2.85 * np.pi) -> np.ndarray:
    """Sound-speed map from a grayscale image by the reference recipe
    (soundSpeedPhantom2D.m:12-31): normalize, floor values below
    ``threshold`` to the above-threshold mean, de-mean, scale to
    c_bkgnd +/- c_std, rotate, and resample bilinearly onto the grid
    (background outside the image)."""
    img = np.asarray(image, dtype=np.float64)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    img = img / img.max()
    img[img <= threshold] = img[img >= threshold].mean()
    img = img - img.mean()
    img = img / np.abs(img).max()

    ny, nx = img.shape
    x_img = (np.arange(nx) - (nx - 1) / 2) * pixel_size
    y_img = (np.arange(ny) - (ny - 1) / 2) * pixel_size
    c_img = c_bkgnd + c_std * img

    Xi, Yi = grid.meshgrid()
    R = np.hypot(Xi, Yi)
    T = np.arctan2(Yi, Xi) - rotation
    xs, ys = R * np.cos(T), R * np.sin(T)

    fx = (xs - x_img[0]) / pixel_size
    fy = (ys - y_img[0]) / pixel_size
    valid = (fx >= 0) & (fx <= nx - 1) & (fy >= 0) & (fy <= ny - 1)
    fx = np.clip(fx, 0, nx - 1)
    fy = np.clip(fy, 0, ny - 1)
    ix = np.clip(fx.astype(int), 0, nx - 2)
    iy = np.clip(fy.astype(int), 0, ny - 2)
    wx = fx - ix
    wy = fy - iy
    interp = (c_img[iy, ix] * (1 - wx) * (1 - wy)
              + c_img[iy, ix + 1] * wx * (1 - wy)
              + c_img[iy + 1, ix] * (1 - wx) * wy
              + c_img[iy + 1, ix + 1] * wx * wy)
    return np.where(valid, interp, c_bkgnd).astype(np.float32)
