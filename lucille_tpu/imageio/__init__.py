"""Image IO: Radiance RGBE (.hdr), PFM, PNG preview.

JAX replacement for lucille's src/imageio layer (rgbe.c RGBE codec,
image_loader.c extension dispatch — SURVEY.md section 2.7).
"""

from lucille_tpu.imageio.rgbe import read_hdr, write_hdr
from lucille_tpu.imageio.loader import load_image, save_image

__all__ = ["read_hdr", "write_hdr", "load_image", "save_image"]
