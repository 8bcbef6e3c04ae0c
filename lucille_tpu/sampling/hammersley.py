"""Deterministic sigma-permuted Hammersley subpixel sampling.

Re-implements the semantics of lucille's subpixel sampler
(src/render/render.c:830-917, ``sample_subpixel`` + ``init_sigma``), after
Keller, "Strictly Deterministic Sampling Methods in Computer Graphics",
mental images TR 2001.

For an ``xsamples x ysamples`` grid the sampler produces, per subpixel
(xs, ys), a deterministic jitter inside the pixel footprint plus a QMC
"instance number" used to seed subsequent low-discrepancy dimensions.

All offsets are precomputed on the host (they depend only on the sampling
rate) and uploaded once as small constant arrays — the device kernel then just
adds them to integer pixel coordinates.  This keeps the hot path pure
arithmetic with no tables-in-loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _radical_inverse_perm(period: int) -> np.ndarray:
    """The base-2 bit-reversal permutation used by init_sigma.

    For each i in [0, period): reverse the bits of i with respect to
    halving `digit` from `period` (reference render.c:877-905).  For
    non-power-of-two periods this reproduces the reference's quirky but
    deterministic behavior exactly.
    """
    sigma = np.zeros(period, dtype=np.uint32)
    for i in range(period):
        digit = period
        inverse = 0
        bits = i
        while bits:
            digit >>= 1
            if bits & 1:
                inverse += digit
            bits >>= 1
        sigma[i] = inverse
    return sigma


@dataclass(frozen=True)
class SigmaTable:
    periodx: int
    periody: int
    sigmax: np.ndarray  # (periodx,) uint32
    sigmay: np.ndarray  # (periody,) uint32

    @staticmethod
    def make(xsamples: int, ysamples: int) -> "SigmaTable":
        return SigmaTable(
            periodx=xsamples,
            periody=ysamples,
            sigmax=_radical_inverse_perm(xsamples),
            sigmay=_radical_inverse_perm(ysamples),
        )


def subpixel_samples(xsamples: int, ysamples: int):
    """Return (jitter, instance) for all subpixels of one pixel.

    jitter:   float64 array (ysamples * xsamples, 2) — offsets in [0, 1)^2
              to add to the integer pixel corner, ordered ys-major to match
              the reference's loop nest (render.c:762-764).
    instance: uint32 array (ysamples * xsamples,) — the QMC instance number
              fed to generalized scrambled Hammersley sampling.

    Faithful to sample_subpixel (render.c:830-870) including its quirks:
    the y lookup masks with ``periodx - 1`` (not periody), and a half-stratum
    offset of ``0.5 / s^2`` is added per axis.
    """
    tbl = SigmaTable.make(xsamples, ysamples)
    jitter = np.zeros((ysamples * xsamples, 2), dtype=np.float64)
    instance = np.zeros(ysamples * xsamples, dtype=np.uint32)
    offsetx = 0.5 / (xsamples * xsamples)
    offsety = 0.5 / (ysamples * ysamples)
    idx = 0
    for ys in range(ysamples):
        for xs in range(xsamples):
            j = xs & (tbl.periodx - 1)
            k = ys & (tbl.periodx - 1)  # sic: periodx, as in the reference
            instance[idx] = j * tbl.periodx + tbl.sigmax[k % tbl.periodx]
            jx = (xs + tbl.sigmax[k % tbl.periodx] / tbl.periodx) / xsamples
            jy = (ys + tbl.sigmay[j % tbl.periody] / tbl.periody) / ysamples
            jitter[idx, 0] = jx + offsetx
            jitter[idx, 1] = jy + offsety
            idx += 1
    return jitter, instance
