"""Lorenz-Mie phase functions (Frisvad/Christensen/Jensen, SIGGRAPH 2007).

Capability analog of the reference's MieScattering R&D tool
(/root/reference/rnd/MieScattering/mie.c): the single-particle phase
function p(theta) for a given wavelength and particle size from the
logarithmic-derivative recurrences (the paper's eqs 11-19), the
scattering amplitudes S1/S2 (eqs 2-3), the cross sections Ct/Cs
(eqs 22-23), the asymmetry parameter g (eq 26), and the milk preset
(ri_mie_compute_phase_function_milk, mie.c:826-841: eta_fat = 1.46 in a
water medium).

The recurrences are sequential in the expansion order n and micro-sized
(M ~ x + 4.3 x^(1/3)), so this is a HOST-side f64 table build — numpy
complex128, vectorized over theta — whose output feeds the device as a
(resolution,) lookup row: `phase_lookup` turns cos(theta) into a phase
value inside any jitted volume/SSS integrand (transport/sss.py's
mie_phase option).
"""

from __future__ import annotations

import numpy as np

THETA_RESOLUTION = 1024  # matches the reference table (mie.h:22)

# milk constituents (mie.c:657-665 / 826-841)
ETA_FAT = 1.46
ETA_WATER = 1.00


def _order_m(x: float) -> int:
    """Truncation order M = ceil(|x| + 4.3 |x|^(1/3) + 1) (eq 19)."""
    ax = abs(x)
    return int(np.ceil(ax + 4.3 * ax ** (1.0 / 3.0) + 1.0))


def _log_derivative_a(z: float, m: int) -> np.ndarray:
    """A_n(z) by downward recurrence (eq 15), A_M = 0.

    Real-valued, matching the reference's non-absorbing-host
    simplification (mie.c:227-250)."""
    A = np.zeros(m + 2)
    for n in range(m - 1, -1, -1):
        k = (n + 1.0) / z + A[n + 1]
        A[n] = (n + 1.0) / z - (1.0 / k if abs(k) > 1e-6 else 1.0)
    return A


def _ricatti_b_exact(A: np.ndarray, z: float, m: int) -> np.ndarray:
    """B_n(z) = A_n(z) + i/(psi_n zeta_n) by forward recurrence
    (eqs 16-17), psi_n zeta_n accumulated alongside, seeded
    (1 - e^{2iz})/2 (mie.c:281-309)."""
    B = np.zeros(m + 2, complex)
    B[0] = 1j
    psi_zeta = 0.5 * (1.0 - np.exp(2j * z))
    for n in range(1, m + 1):
        psi_zeta = psi_zeta * (n / z - A[n - 1]) * (n / z - B[n - 1])
        B[n] = A[n] + 1j / psi_zeta
    return B


def _psi_over_zeta(A: np.ndarray, B: np.ndarray, z: float,
                   m: int) -> np.ndarray:
    """(psi_n/zeta_n)(z) forward recurrence (eq 18), seeded with
    (1 - e^{-2iz})/2 (mie.c:334-335)."""
    r = np.zeros(m + 2, complex)
    cur = 0.5 * (1.0 - np.exp(-2j * z))
    for n in range(1, m + 1):
        cur = cur * (B[n] + n / z) / (A[n] + n / z)
        r[n] = cur
    return r


def lorenz_mie_coefficients(wavelength: float, radius: float, eta: float,
                            eta_med: float = 1.0):
    """Expansion coefficients (a_n, b_n), n = 1..M (eqs 12-13).

    wavelength and radius in the same unit (the reference uses nm)."""
    x = 2.0 * np.pi * radius * eta_med / wavelength
    y = 2.0 * np.pi * radius * eta / wavelength
    m = _order_m(x)
    Ax = _log_derivative_a(x, m)
    Ay = _log_derivative_a(y, m)
    Bx = _ricatti_b_exact(Ax, x, m)
    pz = _psi_over_zeta(Ax, Bx, x, m)
    n = np.arange(1, m + 1)
    a = pz[1 : m + 1] * (eta_med * Ay[1 : m + 1] - eta * Ax[1 : m + 1]) / (
        eta_med * Ay[1 : m + 1] - eta * Bx[1 : m + 1]
    )
    b = pz[1 : m + 1] * (eta * Ay[1 : m + 1] - eta_med * Ax[1 : m + 1]) / (
        eta * Ay[1 : m + 1] - eta_med * Bx[1 : m + 1]
    )
    return a, b, n


def _angular_functions(cos_theta: np.ndarray, m: int):
    """pi_n(cos t) = P_n'(cos t) and tau_n = cos t P_n' - sin^2 t P_n''
    for n = 1..M, by the Legendre-derivative recurrences the reference
    evaluates per term (mie.c Pnd/Pndd) — here built once, vectorized
    over theta."""
    ct = np.clip(cos_theta, -1.0, 1.0)
    pi_n = np.zeros((m + 1,) + ct.shape)
    pdd = np.zeros_like(pi_n)
    pi_n[1] = 1.0
    if m >= 2:
        pdd[2] = 3.0
    # P_n' recurrence: (n stages of the reference's Pnd loop)
    for n in range(2, m + 1):
        pi_n[n] = ((2 * n - 1) * ct * pi_n[n - 1] - n * pi_n[n - 2]) / (
            n - 1
        )
    for n in range(3, m + 1):
        pdd[n] = ((2 * n - 1) * ct * pdd[n - 1] - (n + 1) * pdd[n - 2]) / (
            n - 2
        )
    tau_n = ct * pi_n - (1.0 - ct * ct) * pdd
    return pi_n[1:], tau_n[1:]


def scattering_amplitudes(a, b, n, theta: np.ndarray):
    """S1(theta), S2(theta) (eqs 2-3), vectorized over theta."""
    m = len(n)
    pi_n, tau_n = _angular_functions(np.cos(theta), m)
    k = ((2 * n + 1) / (n * (n + 1)))[:, None]
    S1 = np.sum(k * (a[:, None] * pi_n + b[:, None] * tau_n), axis=0)
    S2 = np.sum(k * (b[:, None] * pi_n + a[:, None] * tau_n), axis=0)
    return S1, S2


def phase_table(wavelength: float, radius: float, eta: float,
                eta_med: float = 1.0,
                resolution: int = THETA_RESOLUTION) -> np.ndarray:
    """p(theta) over `resolution` bins spanning [0, 2 pi) — the exact
    table the reference tool draws (mie.c:805-812), normalized per
    eq 25: p = (|S1|^2 + |S2|^2) / (4 pi sum (2n+1)(|an|^2+|bn|^2))."""
    a, b, n = lorenz_mie_coefficients(wavelength, radius, eta, eta_med)
    theta = np.arange(resolution) / resolution * 2.0 * np.pi
    S1, S2 = scattering_amplitudes(a, b, n, theta)
    denom = 4.0 * np.pi * np.sum(
        (2 * n + 1) * (np.abs(a) ** 2 + np.abs(b) ** 2)
    )
    return (np.abs(S1) ** 2 + np.abs(S2) ** 2) / denom


def cross_sections(wavelength: float, radius: float, eta: float,
                   eta_med: float = 1.0):
    """(Ct, Cs) extinction/scattering cross sections in wavelength^2
    units (eqs 22-23, non-absorbing host: gamma = 1)."""
    a, b, n = lorenz_mie_coefficients(wavelength, radius, eta, eta_med)
    ct = (
        wavelength**2
        / (2.0 * np.pi)
        * np.sum((2 * n + 1) * (a.real + b.real))
        / eta_med**2
    )
    cs = (
        wavelength**2
        / (2.0 * np.pi)
        * np.sum((2 * n + 1) * (np.abs(a) ** 2 + np.abs(b) ** 2))
        / eta_med**2
    )
    return ct, cs


def asymmetry(wavelength: float, radius: float, eta: float,
              eta_med: float = 1.0) -> float:
    """Asymmetry parameter g = <cos theta> (eq 26)."""
    a, b, n = lorenz_mie_coefficients(wavelength, radius, eta, eta_med)
    num = np.sum(
        (n[:-1] * (n[:-1] + 2) / (n[:-1] + 1))
        * (a[:-1] * np.conj(a[1:]) + b[:-1] * np.conj(b[1:])).real
        + ((2 * n[:-1] + 1) / (n[:-1] * (n[:-1] + 1)))
        * (a[:-1] * np.conj(b[:-1])).real
    )
    den = 0.5 * np.sum((2 * n + 1) * (np.abs(a) ** 2 + np.abs(b) ** 2))
    return float(num / den)


def milk_phase_table(wavelength: float = 600.0,
                     particle_size: float = 1000.0,
                     resolution: int = THETA_RESOLUTION) -> np.ndarray:
    """The reference's milk preset (ri_mie_compute_phase_function_milk):
    fat globules (eta 1.46) in water, wavelength/size in nm."""
    return phase_table(wavelength, particle_size, ETA_FAT, ETA_WATER,
                       resolution)


def phase_lookup(table, cos_theta):
    """Jit-safe table lookup: phase value for scattering angle
    cos(theta), interpolating the [0, pi] half of a phase table (the
    table spans [0, 2 pi) like the reference's; physics lives in
    [0, pi])."""
    import jax.numpy as jnp

    table = jnp.asarray(table, jnp.float32)
    res = table.shape[0]
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    f = theta / (2.0 * jnp.pi) * res
    i0 = jnp.clip(f.astype(jnp.int32), 0, res - 2)
    w = f - i0.astype(jnp.float32)
    return table[i0] * (1.0 - w) + table[i0 + 1] * w
