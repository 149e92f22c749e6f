"""The plain reference: what the timed entries must produce, recomputed
from the benchmark's own inputs with plain PyTorch.

It imports nothing of the program and takes nothing the program made. It
follows the upstream MATLAB/Python code (FrequencyDomainFWI.m,
solveHelmholtz.m, SimulateData.m of github.com/Alighieri1231/
WaveformInversionUST) in the formulation the port documents: the
dispersion-minimizing 9-point stencil with a PML, Dirichlet border rows
scaled by 1/h^2 (the balanced operator H_s = D H), a block-Thomas direct
solve over grid rows, and nonlinear CG with per-transmitter source
estimation. Every product is a plain ``torch`` call; the row recurrences
are Python loops.

``precision="tf32"`` is the control: the same arithmetic with every
matrix-product operand and each Schur complement rounded to TF32 (10
mantissa bits, as the tensor cores read FP32), the step a faster factor or
sweep would take. ``dtype=torch.complex128`` runs the generator of the
stored data in double precision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

# (dy, dx) of the nine stencil slots: C, L, R, D, U, DL, DR, UL, UR
OFFSETS = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
           (-1, -1), (-1, 1), (1, -1), (1, 1))


@dataclass(frozen=True)
class Grid:
    """A square grid over [-xmax, xmax]^2 with spacing dx (row-major
    (ny, nx) fields)."""

    xmax: float
    dx: float

    @property
    def n(self) -> int:
        return int(round(2 * self.xmax / self.dx)) + 1

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def x(self) -> np.ndarray:
        return -self.xmax + self.dx * np.arange(self.n, dtype=np.float64)


def grid_of(spec: dict) -> Grid:
    return Grid(float(spec["xmax"]), float(spec["dx"]))


@dataclass(frozen=True)
class Ring:
    """Element pixels of a ring on a grid and, per transmitter, the active
    receivers (all elements but +-``excluded`` around it)."""

    ix: np.ndarray         # (n_elem,) element x index
    iy: np.ndarray         # (n_elem,) element y index
    rx: np.ndarray         # (n_elem, n_active) active receiver element ids


def ring_positions(num_elements: int, radius: float):
    """theta = -pi : 2 pi / N : pi - 2 pi / N (SimulateData.m:17-19)."""
    theta = -np.pi + 2 * np.pi * np.arange(num_elements) / num_elements
    return radius * np.cos(theta), radius * np.sin(theta)


def ring_on(grid: Grid, num_elements: int, radius: float,
            excluded: int) -> Ring:
    """Nearest-pixel element placement (first minimum on ties) and the
    acceptance rule of fwi_script.py:39-44."""
    xe, ye = ring_positions(num_elements, radius)
    x = grid.x
    ix = np.argmin(np.abs(x[None, :] - xe[:, None]), axis=1)
    iy = np.argmin(np.abs(x[None, :] - ye[:, None]), axis=1)
    keep = np.ones((num_elements, num_elements), bool)
    t = np.arange(num_elements)[:, None]
    keep[t, (t + np.arange(-excluded, excluded + 1)[None, :]) % num_elements] = False
    rx = np.stack([np.flatnonzero(r) for r in keep])
    return Ring(ix=ix, iy=iy, rx=rx)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round every float32 component of ``t`` to TF32 (10 mantissa bits,
    to nearest, ties away from zero, as ``cvt.rna.tf32.f32``)."""
    real = torch.view_as_real(t.resolve_conj()) if t.is_complex() else t
    bits = real.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    out = bits.view(torch.float32)
    return torch.view_as_complex(out) if t.is_complex() else out


class Arith:
    """The precision a reference runs in: plain, or with TF32 operands."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return to_tf32(t) if self.tf32 and t.dtype == torch.complex64 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)

    def inv(self, s: torch.Tensor) -> torch.Tensor:
        return torch.linalg.inv(self.r(s))


# ---------------------------------------------------------------------------
# The operator (solveHelmholtz.m:27-181)
# ---------------------------------------------------------------------------

def _real(dtype):
    return torch.float64 if dtype == torch.complex128 else torch.float32


def pml_fields(grid: Grid, f: float, pml: dict, dtype, device):
    """Staggered stretch fields A = ey/ex at (y, x+1/2), B = ex/ey at
    (y+1/2, x), C = ex ey at (y, x): quadratic profile 2 pi a0 f
    ((|r| - xmax + L)_+ / L)^2 on the half-step grid."""
    rdt = _real(dtype)
    n = grid.n
    xe = torch.linspace(-grid.xmax, grid.xmax, 2 * (n - 1) + 1, dtype=rdt,
                        device=device)
    L = float(pml["l_pml"])
    s = 2 * math.pi * float(pml["a0"]) * f * (
        torch.clamp(torch.abs(xe) - grid.xmax + L, min=0.0) / L) ** 2
    sgn = float(np.sign(pml["sign_convention"]))
    e = torch.complex(torch.ones_like(s), s * sgn / (2 * math.pi * f))
    ex, ey = e[None, :], e[:, None]
    return ((ey / ex)[::2, 1::2].contiguous(), (ex / ey)[1::2, ::2].contiguous(),
            (ex * ey)[::2, ::2].contiguous())


def stencil_params(vmin, vmax, f: float, h: float, st: dict):
    """(b, d, e) of the 9-point stencil: least squares over angles in
    [0, pi/4] and wavelengths in [vmin, vmax] / (f h) (Chen et al. 2013),
    b fixed at 5/6 when ``fix_b``."""
    dev, rdt = vmin.device, vmin.dtype
    l, r = int(st["angular_resolution"]), int(st["range_resolution"])
    gmin, gmax = vmin / (f * h), vmax / (f * h)
    theta = torch.arange(l, dtype=rdt, device=dev) * math.pi / (4 * (l - 1))
    G = 1.0 / (1.0 / gmax + torch.arange(r, dtype=rdt, device=dev) / (r - 1)
               * (1.0 / gmin - 1.0 / gmax))
    GG, TH = torch.meshgrid(G, theta, indexing="ij")
    P = torch.cos(2 * math.pi * torch.cos(TH) / GG)
    Q = torch.cos(2 * math.pi * torch.sin(TH) / GG)
    S1 = 2 * GG ** 2 * (1 - P - Q + P * Q)
    S2 = math.pi ** 2 * (2 - P - Q)
    S3 = 2 * math.pi ** 2 * (1 - P * Q)
    S4 = 2 * math.pi ** 2 + GG ** 2 * (2 * P * Q - P - Q)
    if not st["fix_b"]:
        M = torch.stack([S1.ravel(), S2.ravel(), S3.ravel()], dim=1)
        p = torch.linalg.lstsq(M, S4.ravel()[:, None]).solution[:, 0]
        return p[0], p[1], p[2]
    b = torch.tensor(5.0 / 6.0, dtype=rdt, device=dev)
    M = torch.stack([S2.ravel(), S3.ravel()], dim=1)
    p = torch.linalg.lstsq(M, (S4.ravel() - b * S1.ravel())[:, None]).solution[:, 0]
    return b, p[0], p[1]


def coefficients(vel: torch.Tensor, grid: Grid, f: float, pml: dict,
                 st: dict, fields=None) -> torch.Tensor:
    """The nine planes (9, n, n) of the balanced operator H_s: interior
    rows after solveHelmholtz.m:53-126 (MATLAB corner gathers), identity
    rows times 1/h^2 on the border."""
    if st.get("corner_mode", "matlab") != "matlab":
        raise ValueError("the reference follows the MATLAB corner gathers")
    cdt = torch.complex128 if vel.dtype == torch.float64 else torch.complex64
    n, h = grid.n, grid.dx
    A, B, C = fields if fields is not None else pml_fields(grid, f, pml, cdt,
                                                           vel.device)
    k2 = ((2 * math.pi * f / vel) ** 2).to(cdt)
    b, d, e = stencil_params(vel.min(), vel.max(), f, h, st)
    h2, half = h * h, (1 - b) / 2

    def s(a, ys, xs):
        return a[ys:ys + n - 2, xs:xs + n - 2]

    Ax_m, Ax_c = s(A, 1, 0), s(A, 1, 1)
    Aym_m, Aym_c, Ayp_m, Ayp_c = s(A, 0, 0), s(A, 0, 1), s(A, 2, 0), s(A, 2, 1)
    By_m, By_c = s(B, 0, 1), s(B, 1, 1)
    Bym_m, Bym_p, Byc_m, Byc_p = s(B, 0, 0), s(B, 0, 2), s(B, 1, 0), s(B, 1, 2)
    Ck = C * k2
    planes = [
        (1 - d - e) * s(Ck, 1, 1) - b * (Ax_c + Ax_m + By_c + By_m) / h2,
        (b * Ax_m - half * (Byc_m + Bym_m)) / h2 + d / 4 * s(Ck, 1, 0),
        (b * Ax_c - half * (Byc_p + Bym_p)) / h2 + d / 4 * s(Ck, 1, 2),
        (b * By_m - half * (Aym_c + Aym_m)) / h2 + d / 4 * s(Ck, 0, 1),
        (b * By_c - half * (Ayp_c + Ayp_m)) / h2 + d / 4 * s(Ck, 2, 1),
        half * (Aym_m + Bym_m) / h2 + e / 4 * s(Ck, 0, 0),
        half * (Aym_c + Bym_p) / h2 + e / 4 * s(Ck, 0, 2),
        half * (Ayp_m + Byc_m) / h2 + e / 4 * s(Ck, 2, 0),
        half * (Ayp_c + Byc_p) / h2 + e / 4 * s(Ck, 2, 2),
    ]
    out = torch.zeros((9, n, n), dtype=cdt, device=vel.device)
    out[:, 1:-1, 1:-1] = torch.stack(planes)
    border = torch.ones((n, n), dtype=_real(cdt), device=vel.device)
    border[1:-1, 1:-1] = 0
    out[0] += border / h2
    return out


def d_map(grid: Grid, dtype, device) -> torch.Tensor:
    """D: 1/h^2 on the border rows, 1 inside."""
    d = torch.full(grid.shape, 1.0 / grid.dx ** 2, dtype=dtype, device=device)
    d[1:-1, 1:-1] = 1.0
    return d


def _shift(u: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    n = u.shape[-1]
    p = F.pad(u, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + n, 1 + dx:1 + dx + n]


def apply(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """H u for fields (batch, n, n)."""
    out = c[0] * u
    for k in range(1, 9):
        out = out + c[k] * _shift(u, *OFFSETS[k])
    return out


def apply_adjoint(c: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """H^H u (scatter form)."""
    out = torch.conj(c[0]) * u
    for k in range(1, 9):
        dy, dx = OFFSETS[k]
        out = out + _shift(torch.conj(c[k]) * u, -dy, -dx)
    return out


# ---------------------------------------------------------------------------
# Block-Thomas over grid rows
# ---------------------------------------------------------------------------

def _sx(v: torch.Tensor, d: int) -> torch.Tensor:
    """v[..., i + d], zero outside."""
    return F.pad(v[..., d:], (0, d)) if d > 0 else F.pad(v[..., :d], (-d, 0))


def _tri(main, sub, sup, v):
    """T v, T[i,i] = main, T[i,i-1] = sub, T[i,i+1] = sup."""
    return main * v + sub * _sx(v, -1) + sup * _sx(v, 1)


def _tri_h(main, sub, sup, v):
    """T^H v."""
    return (torch.conj(main) * v + _sx(torch.conj(sub) * v, 1)
            + _sx(torch.conj(sup) * v, -1))


def factor(c: torch.Tensor, ar: Arith) -> torch.Tensor:
    """G_i = S_i^-1, S_0 = tri(D_0), S_i = tri(D_i) - tri(L_i) G_{i-1}
    tri(U_{i-1}), with D = (C, L, R), L = (D, DL, DR), U = (U, UL, UR)."""
    n = c.shape[1]
    g = torch.empty((n, n, n), dtype=c.dtype, device=c.device)
    for i in range(n):
        s = (torch.diag(c[0, i]) + torch.diag(c[1, i, 1:], -1)
             + torch.diag(c[2, i, :-1], 1))
        if i:
            gp = g[i - 1]
            # G U: column combinations; then tri(L) (G U): row combinations
            gu = (gp * c[4, i - 1][None, :]
                  + F.pad(gp[:, 1:], (0, 1)) * _sx(c[7, i - 1], 1)[None, :]
                  + F.pad(gp[:, :-1], (1, 0)) * _sx(c[8, i - 1], -1)[None, :])
            lgu = (c[3, i][:, None] * gu
                   + c[5, i][:, None] * F.pad(gu[:-1], (0, 0, 1, 0))
                   + c[6, i][:, None] * F.pad(gu[1:], (0, 0, 0, 1)))
            s = s - lgu
        g[i] = ar.inv(s)
    return g


def solve(g: torch.Tensor, c: torch.Tensor, b: torch.Tensor, adjoint: bool,
          ar: Arith) -> torch.Tensor:
    """H x = b (or H^H x = b) for b (batch, n, n) through G."""
    n = c.shape[1]
    x = torch.empty_like(b)
    if not adjoint:
        z = torch.empty_like(b)
        z[:, 0] = b[:, 0]
        for i in range(1, n):
            w = ar.mm(z[:, i - 1], g[i - 1].T)
            z[:, i] = b[:, i] - _tri(c[3, i], c[5, i], c[6, i], w)
        x[:, -1] = ar.mm(z[:, -1], g[-1].T)
        for i in range(n - 2, -1, -1):
            r = z[:, i] - _tri(c[4, i], c[7, i], c[8, i], x[:, i + 1])
            x[:, i] = ar.mm(r, g[i].T)
        return x
    w = torch.empty_like(b)
    w[:, 0] = ar.mm(b[:, 0], torch.conj(g[0]))
    for i in range(1, n):
        r = b[:, i] - _tri_h(c[4, i - 1], c[7, i - 1], c[8, i - 1], w[:, i - 1])
        w[:, i] = ar.mm(r, torch.conj(g[i]))
    x[:, -1] = w[:, -1]
    for i in range(n - 2, -1, -1):
        v = _tri_h(c[3, i + 1], c[5, i + 1], c[6, i + 1], x[:, i + 1])
        x[:, i] = w[:, i] - ar.mm(v, torch.conj(g[i]))
    return x


# ---------------------------------------------------------------------------
# The two entries the benchmark times
# ---------------------------------------------------------------------------

def _sources(grid: Grid, ring: Ring, amps: torch.Tensor) -> torch.Tensor:
    ntx = amps.shape[0]
    src = torch.zeros((ntx,) + grid.shape, dtype=amps.dtype, device=amps.device)
    idx = torch.arange(ntx, device=amps.device)
    src[idx, torch.as_tensor(ring.iy, device=amps.device),
        torch.as_tensor(ring.ix, device=amps.device)] = amps
    return src


def synthesize(vel: np.ndarray, config: dict, amps: np.ndarray, device,
               precision: str = "fp32", dtype=torch.complex64) -> np.ndarray:
    """Receiver data (n_tx, n_elem) of a ring over ``vel`` on the
    configuration's grid: one transmitter an element with amplitude
    ``amps[t]``, the field sampled at every element pixel
    (SimulateData.m:1-63)."""
    grid, f = grid_of(config["grid"]), float(config["frequency"])
    ring = ring_on(grid, **_ring_args(config))
    ar = Arith(precision)
    v = torch.as_tensor(np.asarray(vel), dtype=_real(dtype), device=device)
    c = coefficients(v, grid, f, config["pml"], config["stencil"])
    g = factor(c, ar)
    src = _sources(grid, ring, torch.as_tensor(amps, dtype=dtype, device=device))
    u = solve(g, c, src * d_map(grid, _real(dtype), device), False, ar)
    del g, src
    iy = torch.as_tensor(ring.iy, device=device)
    ix = torch.as_tensor(ring.ix, device=device)
    return u[:, iy, ix].cpu().numpy()


def _ring_args(config: dict) -> dict:
    r = config["ring"]
    return dict(num_elements=int(r["num_elements"]), radius=float(r["radius"]),
                excluded=int(r["num_excluded_each_side"]))


def reconstruct(rec_data: np.ndarray, config: dict, traffic: dict, device,
                precision: str = "fp32"):
    """Nonlinear CG from ``fwi.c_init`` on the (n_elem, n_elem) recorded
    data (nonlinearcg.py:41-180, FrequencyDomainFWI.m:76-189): each
    iteration a forward solve of every transmitter, per-transmitter source
    estimation, the adjoint solve of the receiver residuals, the
    adjoint-state gradient, Hestenes-Stiefel (or another formula's)
    momentum, the linearized solve of the search direction and the step.
    With ``refactor_every`` K > 1 the factor is rebuilt when it % K == 0
    and reused whole in between (and on the first iteration of each chunk
    of ``live_every``, as the program runs them), the stale forward and
    adjoint solves refined once against the current operator.

    Returns (frames, losses): the velocity after every ``live_every``-th
    iteration and at the end (numpy), and the misfit of each iteration."""
    grid, f = grid_of(config["grid"]), float(config["frequency"])
    fwi = config["fwi"]
    ring = ring_on(grid, **_ring_args(config))
    ar = Arith(precision)
    n_iter = int(traffic["iterations"])
    K = int(traffic.get("refactor_every", 1))
    live = traffic.get("live_every")
    dev = torch.device(device)
    ntx = ring.ix.size
    rx_y = torch.as_tensor(ring.iy[ring.rx], device=dev)
    rx_x = torch.as_tensor(ring.ix[ring.rx], device=dev)
    tx = torch.arange(ntx, device=dev)[:, None]
    rec = np.take_along_axis(np.asarray(rec_data), ring.rx, axis=1)
    obs = torch.as_tensor(rec.astype(np.complex64), device=dev)
    src = _sources(grid, ring, torch.ones(ntx, dtype=torch.complex64,
                                          device=dev))
    dm = d_map(grid, torch.float32, dev)
    fields = pml_fields(grid, f, config["pml"], torch.complex64, dev)
    omega = 2 * math.pi * f
    eps = float(fwi.get("eps_stabilizer", 0.0))

    vel = torch.full(grid.shape, float(fwi["c_init"]), dtype=torch.float32,
                     device=dev)
    slow = 1.0 / vel
    sd = torch.zeros_like(vel)
    gprev = torch.zeros_like(vel)
    # the program runs a chunk of live_every iterations a call and factors
    # on each chunk's first iteration too
    chunk = int(live) if live else n_iter
    g = c_fac = None
    frames, losses = [], []
    for it in range(n_iter):
        c = coefficients(vel, grid, f, config["pml"], config["stencil"], fields)
        stale = K > 1 and it % K != 0 and it % chunk != 0
        if not stale:
            g, c_fac = factor(c, ar), c

        def fsolve(rhs, adjoint=False, refine=False):
            x = solve(g, c_fac, rhs, adjoint, ar)
            if refine:
                op = apply_adjoint if adjoint else apply
                x = x + solve(g, c_fac, rhs - op(c, x), adjoint, ar)
            return x

        wv = fsolve(src * dm, refine=stale)
        sim = wv[tx, rx_y, rx_x]
        if fwi.get("estimate_source_strength", True):
            s_est = (torch.sum(torch.conj(sim) * obs, 1)
                     / torch.clamp(torch.sum(torch.abs(sim) ** 2, 1), min=1e-38))
            wv = wv * s_est[:, None, None]
            sim = sim * s_est[:, None]
        res = sim - obs
        losses.append(float(0.5 * torch.sum(torch.abs(res) ** 2)))
        adj_src = torch.zeros_like(wv)
        adj_src[tx, rx_y, rx_x] = res
        adj = fsolve(adj_src, adjoint=True, refine=stale) * dm
        virt = wv * (2 * omega ** 2 * slow)[None]
        grad = -torch.sum(virt.real * adj.real + virt.imag * adj.imag, 0)
        beta = _momentum(fwi["momentum"], it, grad, gprev, sd, eps)
        sd_new = beta * sd - grad
        pert = fsolve((-virt * sd_new[None]) * dm)
        drec = pert[tx, rx_y, rx_x]
        step = _step(fwi["step_size"], drec, obs, sim, grad, sd_new, eps)
        slow_new = slow + step * sd_new
        vel_new = 1.0 / slow_new
        ok = bool(torch.isfinite(step) & torch.isfinite(beta)
                  & torch.all(torch.isfinite(slow_new)))
        if ok or not fwi.get("reject_nonfinite", True):
            vel, slow, sd = vel_new, slow_new, sd_new
        gprev = grad
        if (live and (it + 1) % int(live) == 0) or it + 1 == n_iter:
            frames.append(vel.cpu().numpy())
    return frames, np.asarray(losses)


def _dot(a, b):
    return torch.sum(a * b)


def _momentum(formula: str, it: int, grad, gprev, sd, eps: float):
    """CG momentum (FrequencyDomainFWI.m:119-148); 0 on the first
    iteration."""
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    if it == 0 or formula == "gradient_descent":
        return zero
    dg = grad - gprev
    if formula == "hestenes_stiefel":
        return _dot(grad, dg) / (_dot(sd, dg) + eps)
    if formula == "fletcher_reeves":
        return _dot(grad, grad) / (_dot(gprev, gprev) + eps)
    if formula == "polak_ribiere":
        return _dot(grad, dg) / (_dot(gprev, gprev) + eps)
    raise ValueError(f"unknown momentum {formula!r}")


def _re(a, b):
    return torch.sum(a.real * b.real + a.imag * b.imag)


def _step(formula: str, drec, obs, sim, grad, sd, eps: float):
    """Linearized step (FrequencyDomainFWI.m:149-172)."""
    den = _re(drec, drec) + eps
    if formula == "residual":
        return _re(drec, obs - sim) / den
    if formula == "gradient":
        return _dot(grad, grad) / den
    if formula == "gradient_sd":
        return -_dot(grad, sd) / den
    raise ValueError(f"unknown step formula {formula!r}")
