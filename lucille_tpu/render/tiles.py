"""Bucket/tile orderings: spiral, scanline, Z-order, Hilbert.

Equivalent capability to the reference's bucket orders
(src/render/spiral.c:42,69 — the default, render.c:198; zorder2d.c:106;
hilbert2d.c) — pure host-side index math.  Here tiles are not a work
queue (no queue exists — SURVEY.md section 2.8): ordering only controls
progressive-display aesthetics and, for multi-device runs, which tiles
land on which device.
"""

from __future__ import annotations


def _spiral_order(nx: int, ny: int):
    """Spiral outward from the center tile (spiral.c semantics)."""
    cx, cy = (nx - 1) / 2.0, (ny - 1) / 2.0
    x, y = int(round(cx)), int(round(cy))
    out = []
    seen = set()

    def visit(i, j):
        if 0 <= i < nx and 0 <= j < ny and (i, j) not in seen:
            seen.add((i, j))
            out.append((i, j))

    visit(x, y)
    step = 1
    dx, dy = 1, 0
    while len(out) < nx * ny:
        for _ in range(2):
            for _ in range(step):
                x, y = x + dx, y + dy
                visit(x, y)
            dx, dy = -dy, dx  # rotate 90°
        step += 1
    return out


def _scanline_order(nx: int, ny: int):
    return [(i, j) for j in range(ny) for i in range(nx)]


def _zorder(nx: int, ny: int):
    """Morton order (zorder2d.c:106)."""

    def interleave(i, j):
        out = 0
        for b in range(16):
            out |= ((i >> b) & 1) << (2 * b) | ((j >> b) & 1) << (2 * b + 1)
        return out

    cells = [(i, j) for j in range(ny) for i in range(nx)]
    return sorted(cells, key=lambda c: interleave(c[0], c[1]))


def _hilbert_d2xy(order: int, d: int):
    """Hilbert curve index -> (x, y) (hilbert2d.c capability)."""
    rx = ry = 0
    x = y = 0
    t = d
    s = 1
    while s < (1 << order):
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        if ry == 0:
            if rx == 1:
                x, y = s - 1 - x, s - 1 - y
            x, y = y, x
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def _hilbert_order(nx: int, ny: int):
    order = 1
    while (1 << order) < max(nx, ny):
        order += 1
    out = []
    for d in range(4**order):
        x, y = _hilbert_d2xy(order, d)
        if x < nx and y < ny:
            out.append((x, y))
    return out


_ORDERS = {
    "spiral": _spiral_order,
    "scanline": _scanline_order,
    "zorder": _zorder,
    "hilbert": _hilbert_order,
}


def tile_list(width: int, height: int, tile_size: int, order: str = "spiral"):
    """Return [(x0, y0, tx, ty), ...] tile origins in the given order.

    The image is conceptually padded up to tile multiples; tiles always
    have the full static size (the renderer crops when accumulating), so
    one compiled kernel serves every tile.
    """
    nx = -(-width // tile_size)
    ny = -(-height // tile_size)
    fn = _ORDERS.get(order, _spiral_order)
    return [
        (i * tile_size, j * tile_size, i, j) for (i, j) in fn(nx, ny)
    ]
