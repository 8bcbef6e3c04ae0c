"""Environment maps for IBL lights.

The reference keeps the IBL texture on the light (``light->texture``,
light.h:47) and fetches it per gathered direction with the angular-map
projection (texture.c:238 ``ri_texture_ibl_fetch``); lat-long maps go
through the angular->latlong converter (texture.h:100-105).  Here the
map is a device array fetched with vectorized bilinear gathers, and the
per-sampler machinery (lights/ibl.py) consumes it through ``fetch`` /
``importance_table`` / ``sis_samples``.

Mapping selection: the RIB token ``"mapping"`` ("angular" | "latlong")
wins; otherwise square images are treated as Debevec angular maps (the
reference's light-probe convention) and 2:1 images as lat-long.
"""

from __future__ import annotations

import numpy as np


def _np_bilinear(img: np.ndarray, s: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Host-side bilinear fetch, clamp addressing (texture.c:86)."""
    h, w = img.shape[:2]
    x = np.clip(s, 0.0, 1.0) * (w - 1)
    y = np.clip(t, 0.0, 1.0) * (h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def angular_to_latlong(img: np.ndarray, h: int = 0, w: int = 0) -> np.ndarray:
    """Resample a Debevec angular map onto a lat-long grid
    (texture.h:100-105 ``ri_texture_make_longlat_from_angularmap``)."""
    from lucille_tpu.lights.ibl import latlong_directions

    if not h:
        h = img.shape[0] // 2 or 1
    if not w:
        w = 2 * h
    dirs, _ = latlong_directions(h, w)
    d = dirs.reshape(-1, 3)
    # angular map convention: view axis -z, image plane x/y
    denom = np.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    r = np.where(
        denom > 1e-9,
        np.arccos(np.clip(-d[:, 2], -1.0, 1.0)) / (np.pi * np.maximum(denom, 1e-9)),
        0.0,
    )
    s = 0.5 + 0.5 * d[:, 0] * r
    t = 0.5 - 0.5 * d[:, 1] * r
    return _np_bilinear(img, s, t).reshape(h, w, 3).astype(np.float32)


class EnvMap:
    """One light's environment texture + sampler-support tables.

    Identity-hashed (like PreethamSunSky) so LightEntry stays a static
    jit argument; the arrays upload at trace time.
    """

    def __init__(self, image: np.ndarray, mapping: str | None = None,
                 name: str = ""):
        self.image = np.asarray(image, dtype=np.float32)[..., :3]
        h, w = self.image.shape[:2]
        if mapping not in ("angular", "latlong"):
            mapping = "latlong" if w >= 2 * h else "angular"
        self.mapping = mapping
        self.name = name
        self._dev = None
        self._table = None
        self._latlong = None
        self._sis = {}

    # -- device fetch ---------------------------------------------------

    def _device_image(self):
        import jax.numpy as jnp

        if self._dev is None:
            self._dev = jnp.asarray(self.image)
        return self._dev

    def fetch(self, dirs):
        """(B, 3) unit directions -> (B, 3) radiance (texture.c:238)."""
        import jax.numpy as jnp

        img = self._device_image()
        h, w = self.image.shape[:2]
        d = dirs
        if self.mapping == "latlong":
            theta = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0))
            phi = jnp.arctan2(d[..., 2], d[..., 0])
            s = (phi + jnp.pi) / (2.0 * jnp.pi)
            t = theta / jnp.pi
            wrap_x = True
        else:
            denom = jnp.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
            r = jnp.where(
                denom > 1e-9,
                jnp.arccos(jnp.clip(-d[..., 2], -1.0, 1.0))
                / (jnp.pi * jnp.maximum(denom, 1e-9)),
                0.0,
            )
            s = 0.5 + 0.5 * d[..., 0] * r
            t = 0.5 - 0.5 * d[..., 1] * r
            wrap_x = False
        x = jnp.clip(s, 0.0, 1.0) * (w - 1.0)
        y = jnp.clip(t, 0.0, 1.0) * (h - 1.0)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        x1 = jnp.where(x0 + 1 > w - 1, 0 if wrap_x else w - 1, x0 + 1)
        y1 = jnp.minimum(y0 + 1, h - 1)
        fx = (x - x0.astype(jnp.float32))[..., None]
        fy = (y - y0.astype(jnp.float32))[..., None]
        return (
            img[y0, x0] * (1 - fx) * (1 - fy)
            + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy
            + img[y1, x1] * fx * fy
        )

    # -- sampler support ------------------------------------------------

    def latlong_image(self) -> np.ndarray:
        """The map as a lat-long grid (importance tables and SIS assume
        lat-long texel/solid-angle bookkeeping)."""
        if self.mapping == "latlong":
            return self.image
        if self._latlong is None:
            self._latlong = angular_to_latlong(self.image)
        return self._latlong

    @property
    def importance_table(self):
        """Lazy luminance-CDF table for the "importance" sampler."""
        if self._table is None:
            from lucille_tpu.lights.ibl import EnvImportanceTable

            self._table = EnvImportanceTable(self.latlong_image())
        return self._table

    def sis_samples(self, nsamples: int = 64):
        """Structured-importance-sampling directions/weights; generated
        from the map when no sisfile was bound (tools_tpu/sisgen.py is
        the offline path matching reference tools/sis)."""
        if nsamples not in self._sis:
            from tools_tpu.sisgen import generate_sis_samples

            self._sis[nsamples] = generate_sis_samples(
                self.latlong_image(), nsamples=nsamples
            )
        return self._sis[nsamples]

    def load_sis(self, path) -> None:
        """Bind precomputed SIS samples (light->sisfile, light.h:51-52).

        Accepts BOTH the repo's .npz (dirs + rgb) and the reference
        sisgen's text format (tools/sis/sis.c:96-101 writes
        ``N\\nW H\\nx y r g b`` with integer pixel coordinates into the
        angular-map input) — a gensamples.dat produced by the reference
        toolchain loads unchanged.  Pixel coords invert the Debevec
        angular-map parametrization this module fetches with
        (s = .5 + .5*dx*r, view axis -z)."""
        try:
            data = np.load(path)
        except (ValueError, OSError):
            data = None  # not an npz: fall through to gensamples.dat text
        if data is not None:
            try:
                self._sis["file"] = (
                    np.asarray(data["dirs"], np.float32),
                    np.asarray(data["rgb"], np.float32),
                )
            except KeyError as e:
                # a VALID npz missing the expected arrays is a caller
                # error, not a text sisfile — name the missing key
                # instead of parsing zip bytes as text
                raise ValueError(
                    f"{path}: npz sisfile is missing array {e}; expected "
                    "'dirs' (N,3) and 'rgb' (N,3)"
                ) from e
            return
        with open(path) as f:
            tokens = f.read().split()
        n = int(tokens[0])
        w, h = int(tokens[1]), int(tokens[2])
        rows = np.asarray(tokens[3 : 3 + 5 * n], np.float64).reshape(n, 5)
        u = 2.0 * (rows[:, 0] + 0.5) / w - 1.0
        v = 1.0 - 2.0 * (rows[:, 1] + 0.5) / h
        rho = np.sqrt(u * u + v * v)
        theta = np.pi * np.minimum(rho, 1.0)
        s = np.where(rho > 1e-9, np.sin(theta) / np.maximum(rho, 1e-9), 0.0)
        dirs = np.stack(
            [u * s, v * s, -np.cos(theta)], axis=-1
        ).astype(np.float32)
        self._sis["file"] = (dirs, rows[:, 2:5].astype(np.float32))

    @property
    def file_sis(self):
        return self._sis.get("file")

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other
