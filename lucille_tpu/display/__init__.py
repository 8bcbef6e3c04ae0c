"""Display drivers: where finished pixels go.

JAX replacement for lucille's display layer (src/display — the
``ri_display_drv_t`` vtable {open, write, close, progress} registered by
name, render.c:224-279): hdr/file (RGBE), framebuffer (falls back to file
when no window system, matching render.c:430-513), socket (rockenfield
protocol), and a null driver for benchmarks.
"""

from lucille_tpu.display.drivers import (
    DisplayDriver,
    FileDriver,
    FramebufferDriver,
    NullDriver,
    get_display_driver,
    register_display_driver,
)

__all__ = [
    "DisplayDriver",
    "FileDriver",
    "FramebufferDriver",
    "NullDriver",
    "get_display_driver",
    "register_display_driver",
]
