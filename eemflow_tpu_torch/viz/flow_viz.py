"""Flow and event colour codes (counterpart of ``eemflow_tpu/viz/flow_viz.py``;
reference ``utils_luo/flow_viz_util.py``, ``HREM.py:104-126``,
``utils/visualization.py:276``).  Numpy only.

Two colour codes, as the reference uses both:
  * the Middlebury colour wheel (``flow_to_image``, RGB uint8),
  * the HSV direction/magnitude map of the HREM loader
    (``visualize_optical_flow``: hue = direction, value = the normalized
    square root of the magnitude; BGR uint8).  Its HSV→RGB conversion is the
    port's copy of matplotlib's ``hsv_to_rgb``, so the port needs no
    matplotlib and gives the same bytes.
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    """Middlebury colour wheel (55×3, 0..255)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """[H, W, 2] flow → RGB uint8 through the Middlebury colour wheel;
    non-finite vectors are black."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    bad = ~(np.isfinite(u) & np.isfinite(v))
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max_flow if max_flow is not None else max(rad.max(), 1e-8)
    u = u / (maxrad + 1e-8)
    v = v / (maxrad + 1e-8)

    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _COLORWHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    inside = rad <= 1
    for c in range(3):
        col0 = _COLORWHEEL[k0, c] / 255.0
        col1 = _COLORWHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col[inside] = 1 - rad[inside] * (1 - col[inside])
        col[~inside] = col[~inside] * 0.75
        img[..., c] = np.floor(255 * col * ~bad).astype(np.uint8)
    return img


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """[..., 3] HSV in [0, 1] → RGB in [0, 1] (matplotlib's
    ``colors.hsv_to_rgb``, operation for operation)."""
    hsv = np.asarray(hsv, dtype=np.promote_types(np.asarray(hsv).dtype, np.float32))
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    for sector, (rr, gg, bb) in enumerate(((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))):
        idx = i % 6 == 0 if sector == 0 else i == sector
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    grey = s == 0
    r[grey], g[grey], b[grey] = v[grey], v[grey], v[grey]
    return np.stack([r, g, b], axis=-1)


def visualize_optical_flow(flow: np.ndarray) -> np.ndarray:
    """HSV direction/magnitude colouring → BGR uint8 (reference
    ``HREM.py:104-126``, ``train_mvsec.py:153-176``)."""
    flow = np.where(np.isinf(flow), 0, flow)
    hsv = np.zeros(flow.shape[:2] + (3,), float)
    mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2) ** 0.5
    ang = np.arctan2(flow[..., 1], flow[..., 0])
    ang[ang < 0] += 2 * np.pi
    hsv[..., 0] = ang / np.pi / 2.0
    hsv[..., 1] = 1
    rng = mag - mag.min()
    hsv[..., 2] = rng / max(rng.max(), 1e-8)
    rgb = hsv_to_rgb(hsv)
    return (rgb[..., ::-1] * 255).astype(np.uint8)


def events_to_event_image(events: np.ndarray, height: int, width: int) -> np.ndarray:
    """[N, 4] (t, x, y, p) → BGR uint8: positive events red, the others blue,
    on white (reference ``utils/visualization.py:276``)."""
    img = np.full((height, width, 3), 255, np.uint8)
    x = events[:, 1].astype(int)
    y = events[:, 2].astype(int)
    p = events[:, 3]
    inb = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    pos = inb & (p > 0)
    neg = inb & (p <= 0)
    img[y[pos], x[pos]] = (0, 0, 255)
    img[y[neg], x[neg]] = (255, 0, 0)
    return img
