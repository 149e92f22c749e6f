"""Dispersion-minimizing 9-point Helmholtz stencil with PML (port of
``waveforminversionust_tpu.ops.stencil`` and of the coefficient half of
``ops/split_engine.py``).

The operator is nine spatially varying complex coefficient planes,
``(H u)[y, x] = sum_s coeffs[s, y, x] * u[y + dy_s, x + dx_s]``, built here
as one ``torch.complex64`` tensor of shape (9, ny, nx). The JAX package has
two builders (native complex and the split (re, im) form for its TPU
runtime); the port has one, held against both.

Stencil slot order used throughout the package:
    0: C (y, x)   1: L (y, x-1)   2: R (y, x+1)   3: D (y-1, x)   4: U (y+1, x)
    5: DL (y-1, x-1)   6: DR (y-1, x+1)   7: UL (y+1, x-1)   8: UR (y+1, x+1)
"""

from __future__ import annotations

import math

import torch

from ..config import PMLConfig, StencilConfig
from ..models.grid import Grid2D

# (dy, dx) offsets per stencil slot, in the order documented above.
STENCIL_OFFSETS = (
    (0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
    (-1, -1), (-1, 1), (1, -1), (1, 1),
)


def stencil_params(vmin, vmax, f, h: float, g: float,
                   config: StencilConfig = StencilConfig()):
    """Optimal (b, d, e) of the 9-point stencil: a least-squares fit of its
    dispersion relation over angles [0, pi/4] and normalized wavelengths in
    [vmin, vmax]/(f h) (Chen/Cheng/Feng/Wu 2013; solveHelmholtz.m:141-181).

    ``vmin``/``vmax`` are float32 tensors (or floats); returns three float32
    0-d tensors on their device.
    """
    vmin = torch.as_tensor(vmin, dtype=torch.float32)
    vmax = torch.as_tensor(vmax, dtype=torch.float32, device=vmin.device)
    dev = vmin.device
    l, r = config.angular_resolution, config.range_resolution
    g = float(g)
    gmin = vmin / (float(f) * h)
    gmax = vmax / (float(f) * h)

    m = torch.arange(1, l + 1, dtype=torch.float32, device=dev)
    n = torch.arange(1, r + 1, dtype=torch.float32, device=dev)
    theta = (m - 1) * math.pi / (4 * (l - 1))
    G = 1.0 / (1.0 / gmax + (n - 1) / (r - 1) * (1.0 / gmin - 1.0 / gmax))
    GG, TH = torch.meshgrid(G, theta, indexing="ij")

    P = torch.cos(g * 2 * math.pi * torch.cos(TH) / GG)
    Q = torch.cos(2 * math.pi * torch.sin(TH) / GG)
    S1 = (1 + 1 / g ** 2) * GG ** 2 * (1 - P - Q + P * Q)
    S2 = math.pi ** 2 * (2 - P - Q)
    S3 = 2 * math.pi ** 2 * (1 - P * Q)
    S4 = 2 * math.pi ** 2 + GG ** 2 * ((1 + 1 / g ** 2) * P * Q - P - Q / g ** 2)

    if config.fix_b:
        b = torch.tensor(5.0 / 6.0, dtype=torch.float32, device=dev)
        M = torch.stack([S2.ravel(), S3.ravel()], dim=1)
        rhs = S4.ravel() - b * S1.ravel()
    else:
        M = torch.stack([S1.ravel(), S2.ravel(), S3.ravel()], dim=1)
        rhs = S4.ravel()
    # QR least squares: the normal equations square cond(M) (~1.5e3 at the
    # reference ring) and lose ~3e-4 of d and e in FP32; QR keeps ~2e-6.
    params = torch.linalg.lstsq(M, rhs[:, None]).solution[:, 0]
    if config.fix_b:
        return b, params[0], params[1]
    return params[0], params[1], params[2]


def pml_stretch_fields(grid: Grid2D, f, pml: PMLConfig,
                       device=None):
    """Staggered PML fields (A, B, C), complex64 (solveHelmholtz.m:27-39):
    A = ey/ex at (y, x+1/2) -> (ny, nx-1); B = ex/ey at (y+1/2, x) ->
    (ny-1, nx); C = ex*ey at (y, x) -> (ny, nx), with the quadratic profile
    s = 2 pi a0 f ((|r - ctr| - span + L)_+ / L)^2 on the half-step grid."""
    xmin, xmax, ymin, ymax = grid.extent
    f = float(f)
    xe = torch.linspace(xmin, xmax, 2 * (grid.nx - 1) + 1,
                        dtype=torch.float32, device=device)
    ye = torch.linspace(ymin, ymax, 2 * (grid.ny - 1) + 1,
                        dtype=torch.float32, device=device)
    L = pml.l_pml
    amp = 2 * math.pi * pml.a0 * f
    sx = amp * (torch.clamp(torch.abs(xe - (xmin + xmax) / 2)
                            - (xmax - xmin) / 2 + L, min=0.0) / L) ** 2
    sy = amp * (torch.clamp(torch.abs(ye - (ymin + ymax) / 2)
                            - (ymax - ymin) / 2 + L, min=0.0) / L) ** 2
    sgn = _sign(pml.sign_convention)
    ex = torch.complex(torch.ones_like(sx), sx * sgn / (2 * math.pi * f))
    ey = torch.complex(torch.ones_like(sy), sy * sgn / (2 * math.pi * f))
    ex2, ey2 = ex[None, :], ey[:, None]
    A = (ey2 / ex2)[::2, 1::2]
    B = (ex2 / ey2)[1::2, ::2]
    C = (ex2 * ey2)[::2, ::2]
    return A.contiguous(), B.contiguous(), C.contiguous()


def _sign(x) -> float:
    return float((x > 0) - (x < 0))


def dirichlet_scale(grid: Grid2D) -> float:
    """Row scale 1/h^2 of the Dirichlet boundary rows (keeps the system
    balanced; the solver scales the matching RHS entries the same way)."""
    return 1.0 / (grid.h * grid.h)


def boundary_mask(grid: Grid2D, device=None) -> torch.Tensor:
    """(ny, nx) float32 mask: 1 on the outer boundary ring, 0 inside."""
    m = torch.zeros((grid.ny, grid.nx), dtype=torch.float32, device=device)
    m[0, :] = 1.0
    m[-1, :] = 1.0
    m[:, 0] = 1.0
    m[:, -1] = 1.0
    return m


def d_map(grid: Grid2D, device=None) -> torch.Tensor:
    """Boundary row-scale map D = 1 + (scale - 1) * boundary (float32)."""
    scale = dirichlet_scale(grid)
    return 1.0 + (scale - 1.0) * boundary_mask(grid, device)


def helmholtz_coefficients(vel, grid: Grid2D, f, pml: PMLConfig = PMLConfig(),
                           stencil: StencilConfig = StencilConfig(),
                           dirichlet_value: float | None = None,
                           attenuation=None, pml_fields=None) -> torch.Tensor:
    """The nine complex64 coefficient planes (9, ny, nx) of the operator:
    interior entries after solveHelmholtz.m:53-126, and scaled-identity
    Dirichlet rows (value ``dirichlet_value``, default 1/h^2) on the border.

    ``vel``: (ny, nx) float32 tensor [m/s]; the planes land on its device.
    ``attenuation``: optional (ny, nx) alpha map [Np/m]; the wavenumber is
    then k = omega/c + i*sgn*alpha. ``pml_fields``: precomputed
    :func:`pml_stretch_fields` (they depend only on grid, f and pml).
    """
    vel = torch.as_tensor(vel, dtype=torch.float32)
    dev = vel.device
    ny, nx = grid.ny, grid.nx
    h, g = float(grid.h), float(grid.aspect)
    f = float(f)

    kr = 2 * math.pi * f / vel
    if attenuation is None:
        k2 = (kr * kr).to(torch.complex64)
    else:
        sgn = _sign(pml.sign_convention)
        alpha = torch.as_tensor(attenuation, dtype=torch.float32, device=dev)
        k2 = torch.complex(kr * kr - alpha * alpha, 2 * sgn * kr * alpha)

    A, B, C = (pml_fields if pml_fields is not None
               else pml_stretch_fields(grid, f, pml, device=dev))
    b, d, e = stencil_params(vel.min(), vel.max(), f, h, g, stencil)
    g2 = g * g
    h2 = h * h

    def s(arr, ys, xs):
        return arr[ys:ys + ny - 2, xs:xs + nx - 2]

    A_xm, A_xc = s(A, 1, 0), s(A, 1, 1)
    A_ym_xm, A_ym_xc = s(A, 0, 0), s(A, 0, 1)
    A_yp_xm, A_yp_xc = s(A, 2, 0), s(A, 2, 1)
    B_ym, B_yc = s(B, 0, 1), s(B, 1, 1)
    B_ym_xm, B_ym_xp = s(B, 0, 0), s(B, 0, 2)
    B_yc_xm, B_yc_xp = s(B, 1, 0), s(B, 1, 2)

    Ck2 = C * k2
    Ck2_c, Ck2_l, Ck2_r = s(Ck2, 1, 1), s(Ck2, 1, 0), s(Ck2, 1, 2)
    Ck2_d, Ck2_u = s(Ck2, 0, 1), s(Ck2, 2, 1)
    Ck2_dl, Ck2_dr = s(Ck2, 0, 0), s(Ck2, 0, 2)
    Ck2_ul, Ck2_ur = s(Ck2, 2, 0), s(Ck2, 2, 2)

    half = (1 - b) / 2
    val_c = (1 - d - e) * Ck2_c - b * (A_xc + A_xm + (B_yc + B_ym) / g2) / h2
    val_l = (b * A_xm - half * (B_yc_xm + B_ym_xm) / g2) / h2 + (d / 4) * Ck2_l
    val_r = (b * A_xc - half * (B_yc_xp + B_ym_xp) / g2) / h2 + (d / 4) * Ck2_r
    val_d = (b * B_ym / g2 - half * (A_ym_xc + A_ym_xm)) / h2 + (d / 4) * Ck2_d
    val_u = (b * B_yc / g2 - half * (A_yp_xc + A_yp_xm)) / h2 + (d / 4) * Ck2_u
    val_dl = half * (A_ym_xm + B_ym_xm / g2) / h2 + (e / 4) * Ck2_dl
    if stencil.corner_mode == "jax_port":
        # The reference JAX port indexes A/B at the corner node directly,
        # one past the staggered fields' far edge, where its gathers clamp:
        # modeled by edge-duplicated fields (solve_helmholtz.py:224-260).
        A_ext = torch.cat([A, A[:, -1:]], dim=1)
        B_ext = torch.cat([B, B[-1:, :]], dim=0)
        val_dr = half * (s(A_ext, 0, 2) + s(B_ext, 0, 2) / g2) / h2 + (e / 4) * Ck2_dr
        val_ul = half * (s(A_ext, 2, 0) + s(B_ext, 2, 0) / g2) / h2 + (e / 4) * Ck2_ul
        val_ur = half * (s(A_ext, 2, 2) + s(B_ext, 2, 2) / g2) / h2 + (e / 4) * Ck2_ur
    elif stencil.corner_mode == "matlab":
        val_dr = half * (A_ym_xc + B_ym_xp / g2) / h2 + (e / 4) * Ck2_dr
        val_ul = half * (A_yp_xm + B_yc_xm / g2) / h2 + (e / 4) * Ck2_ul
        val_ur = half * (A_yp_xc + B_yc_xp / g2) / h2 + (e / 4) * Ck2_ur
    else:
        raise ValueError(f"unknown corner_mode {stencil.corner_mode!r}")

    coeffs = torch.zeros((9, ny, nx), dtype=torch.complex64, device=dev)
    coeffs[:, 1:-1, 1:-1] = torch.stack(
        [val_c, val_l, val_r, val_d, val_u, val_dl, val_dr, val_ul, val_ur])
    if dirichlet_value is None:
        dirichlet_value = dirichlet_scale(grid)
    coeffs[0] += boundary_mask(grid, dev) * dirichlet_value
    return coeffs


def constant_stencil_symbol_parts(b, d, e, h: float, g: float,
                                  nfy: int, nfx: int):
    """Real decomposition of the constant-coefficient stencil symbol:
    ``symbol(k2) = S0 + k2 * S1`` on an (nfy, nfx) periodic grid, with
    (b, d, e) real. Returns (S0, S1) as float32 tensors on ``b``'s device.
    The DFT angles and their cosines are float32, as in the JAX package."""
    b = torch.as_tensor(b, dtype=torch.float32)
    d = torch.as_tensor(d, dtype=torch.float32, device=b.device)
    e = torch.as_tensor(e, dtype=torch.float32, device=b.device)
    g2 = g * g
    h2 = h * h
    # k2-independent parts of (c0, lr, ud, corner)
    c0_a = -b * (2 + 2 / g2) / h2
    lr_a = (b - (1 - b) / g2) / h2
    ud_a = (b / g2 - (1 - b)) / h2
    co_a = ((1 - b) / 2) * (1 + 1 / g2) / h2
    # coefficients of k2
    c0_k = 1 - d - e
    lr_k = d / 4
    ud_k = d / 4
    co_k = e / 4

    def angles(n):
        return 2 * math.pi * torch.fft.fftfreq(n, dtype=torch.float32,
                                               device=b.device)

    cy = torch.cos(angles(nfy))[:, None]
    cx = torch.cos(angles(nfx))[None, :]

    def combine(c0, lr, ud, co):
        return c0 + 2 * lr * cx + 2 * ud * cy + 4 * co * cx * cy

    return combine(c0_a, lr_a, ud_a, co_a), combine(c0_k, lr_k, ud_k, co_k)


def constant_stencil_symbol(k2_ref, b, d, e, h: float, g: float,
                            nfy: int, nfx: int) -> torch.Tensor:
    """Fourier symbol (nfy, nfx) complex64 of the constant-coefficient
    9-point stencil (A = B = C = 1, constant complex k^2 = ``k2_ref``),
    which the DFT diagonalizes on a periodic grid; used by the
    shifted-Laplacian preconditioner (:mod:`.preconditioner`)."""
    s0, s1 = constant_stencil_symbol_parts(torch.as_tensor(b).real,
                                           torch.as_tensor(d).real,
                                           torch.as_tensor(e).real,
                                           h, g, nfy, nfx)
    k2 = torch.as_tensor(k2_ref, dtype=torch.complex64, device=s0.device)
    return s0 + k2 * s1
