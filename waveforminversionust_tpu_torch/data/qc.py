"""Acquisition-data QC (port of ``waveforminversionust_tpu.data.qc``; numpy,
bit-identical): reciprocity checks, element-response calibration and
bad-channel detection on the raw (tx, rx) data matrix.

The Helmholtz operator is complex-symmetric, so the element-to-element
Green's function is symmetric and the recorded matrix satisfies
``M[t, r] == M[r, t]`` up to per-element response factors. With transmit
response ``q_e`` and receive sensitivity ``s_e``,
``M[t, r] = q_t s_r G(t, r)``, and the asymmetry carries exactly the ratios
``c_e = q_e / s_e``: the minimal eigenvector of the Hermitian form
``sum_{t != r} |b_t M[t,r] - b_r M[r,t]|^2`` over ``||b|| = 1`` gives
``b = 1/c`` up to one global complex scale. Dividing row ``t`` by ``c_t``
symmetrizes the matrix.

Host-side preprocessing on the numpy matrix, as in the reference: a few
dense eigendecompositions of the element count's size, not a device
workload.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def _pair_mask(n: int, exclude_each_side: int = 0) -> np.ndarray:
    """(n, n) bool: element pairs used for reciprocity — both orderings
    recorded, self excluded, optionally a ±k ring-neighbor band excluded
    (near-field / crosstalk entries, mirroring the acceptance-angle idea:
    reference fwi_script.py:39)."""
    i = np.arange(n)
    d = np.abs(i[:, None] - i[None, :])
    d = np.minimum(d, n - d)  # circular (ring) angular distance
    mask = d > int(exclude_each_side)
    if not mask.any():
        raise ValueError(
            f"exclude_each_side={exclude_each_side} admits no element pairs "
            f"on an n={n} ring (need exclude_each_side < n/2)")
    return mask


def reciprocity_asymmetry(rec_data, exclude_each_side: int = 0) -> float:
    """Relative reciprocity violation ``||M - M^T||_F / ||M||_F`` over the
    admitted pairs. ~1e-5 for consistent unit-response data; O(1) when
    per-element responses differ."""
    m = np.asarray(rec_data)
    w = _pair_mask(m.shape[0], exclude_each_side)
    num = np.linalg.norm((m - m.T)[w])
    den = np.linalg.norm(m[w])
    return float(num / max(den, 1e-38))


def estimate_element_ratios(rec_data,
                            exclude_each_side: int = 0) -> np.ndarray:
    """Per-element transmit/receive response ratios ``c_e = q_e / s_e`` (up
    to one global complex scale) from the reciprocity asymmetry.

    Returns the minimal eigenvector solution, normalized to unit median
    magnitude with ``c[0]`` real-positive. Dividing transmit row ``t`` of
    the data by ``c_t`` (see :func:`compensate_reciprocity`) restores
    ``M[t, r] == M[r, t]``.
    """
    m = np.asarray(rec_data).astype(np.complex128)
    n = m.shape[0]
    w = _pair_mask(n, exclude_each_side)
    # E(b) = sum_pairs |b_t M_tr - b_r M_rt|^2 = b^H Q b with
    # Q[t, r] = -conj(M_tr) M_rt off-diagonal (NOT its transpose: the
    # conjugated problem has the same magnitudes but conjugated phases —
    # measured before this sign of the cross term was pinned down).
    d = np.sum(w * np.abs(m) ** 2, axis=1)
    q = np.diag(d) - w * (np.conj(m) * m.T)
    q = 0.5 * (q + q.conj().T)
    _, vecs = np.linalg.eigh(q)
    b = vecs[:, 0]
    b = np.where(np.abs(b) < 1e-30, 1e-30, b)
    c = 1.0 / b
    c = c / np.median(np.abs(c))
    phase0 = c[0] / abs(c[0])
    return (c / phase0).astype(np.complex128)


def compensate_reciprocity(rec_data, ratios) -> np.ndarray:
    """Divide each transmit row by its response ratio: with
    ``c = estimate_element_ratios(M)``, ``M / c[:, None]`` is reciprocal
    (symmetric) up to the solve/noise floor.

    Compensation equalizes shot weighting: it helps on noise-free data, and
    it hurts under additive channel noise, where a row recorded through a
    small |q_t| is divided back up with its noise (the JAX package's
    measurement, tests/test_noise.py). Use it when
    ``qc_report(...).asymmetry_compensated`` lands near the solve floor;
    prefer the raw data at a percent-level noise floor."""
    m = np.asarray(rec_data)
    return (m / np.asarray(ratios)[:, None]).astype(m.dtype)


class QCReport(NamedTuple):
    """Outcome of :func:`qc_report`.

    Attributes:
        asymmetry_raw: reciprocity violation of the input matrix.
        asymmetry_compensated: after dividing out the estimated ratios —
            residual inconsistency (noise / channel faults), not response
            imbalance.
        ratios: (n,) estimated per-element response ratios ``q_e/s_e``.
        element_residual: (n,) per-element relative asymmetry AFTER
            compensation — large values mark channels whose data is
            internally inconsistent (not merely mis-scaled).
        element_energy: (n,) relative row energy ``||M[e, :]|| / median`` —
            near-zero marks dead transmit channels.
        bad_elements: indices failing either screen.
    """

    asymmetry_raw: float
    asymmetry_compensated: float
    ratios: np.ndarray
    element_residual: np.ndarray
    element_energy: np.ndarray
    bad_elements: np.ndarray


def qc_report(rec_data, exclude_each_side: int = 0,
              residual_threshold: float = 4.0,
              residual_floor: float = 0.05,
              energy_threshold: float = 0.05) -> QCReport:
    """One-call acquisition QC: estimate response ratios, compensate, and
    screen for bad channels.

    A channel is flagged when its POST-compensation reciprocity residual
    exceeds ``residual_threshold`` times the median residual (its tx and rx
    records disagree in a way no single response factor explains — noise,
    drift, coupling loss; a single corrupted channel raises EVERY partner's
    residual through their shared pairs, so the screen is median-relative,
    with ``residual_floor`` as the absolute minimum so a clean acquisition's
    ~1e-5 noise floor never flags) or when its row energy falls below
    ``energy_threshold`` of the median (dead transmitter). Feed
    ``compensate_reciprocity(rec_data, report.ratios)`` to the inversion
    and drop ``bad_elements`` from the transmit subset
    (``AcquisitionConfig.tx_downsample``-style selection).
    """
    m = np.asarray(rec_data)
    n = m.shape[0]
    w = _pair_mask(n, exclude_each_side)
    ratios = estimate_element_ratios(m, exclude_each_side)
    mc = compensate_reciprocity(m, ratios)
    diff = np.where(w, mc - mc.T, 0.0)
    base = np.where(w, mc, 0.0)
    row_num = np.linalg.norm(diff, axis=1)
    row_den = np.maximum(np.linalg.norm(base, axis=1), 1e-38)
    element_residual = (row_num / row_den).astype(np.float64)
    energy = np.linalg.norm(np.where(w, m, 0.0), axis=1)
    element_energy = energy / max(float(np.median(energy)), 1e-38)
    cut = max(float(residual_floor),
              float(residual_threshold) * float(np.median(element_residual)))
    bad = np.flatnonzero((element_residual > cut)
                         | (element_energy < energy_threshold))
    return QCReport(
        asymmetry_raw=reciprocity_asymmetry(m, exclude_each_side),
        asymmetry_compensated=reciprocity_asymmetry(mc, exclude_each_side),
        ratios=ratios,
        element_residual=element_residual,
        element_energy=element_energy,
        bad_elements=bad,
    )
