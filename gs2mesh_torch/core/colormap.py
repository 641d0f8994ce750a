"""matplotlib's ``jet`` colormap without matplotlib: its segment data, the
256-entry lookup table that LinearSegmentedColormap builds from it
(matplotlib.colors._create_lookup_table) and the float lookup that
Colormap.__call__ does (index int(x·256), 1.0 mapped to 255)."""

from __future__ import annotations

import functools

import numpy as np

N = 256
JET_DATA = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}


def _channel_lut(data) -> np.ndarray:
    adata = np.array(data, np.float64)
    x, y0, y1 = adata[:, 0] * (N - 1), adata[:, 1], adata[:, 2]
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


@functools.cache
def jet_lut() -> np.ndarray:
    """(256, 3) float64 RGB lookup table of ``jet``."""
    lut = np.stack([_channel_lut(JET_DATA[c])
                    for c in ("red", "green", "blue")], axis=1)
    lut.flags.writeable = False
    return lut


def jet(x: np.ndarray) -> np.ndarray:
    """Float array in [0, 1] -> (..., 3) float64 RGB, as
    ``matplotlib.colormaps["jet"](x)[..., :3]``: the index is x·256 in x's
    own dtype, truncated, with 1.0 taken as 255, below 0 as 0, above 1 as
    255, and NaN black."""
    xa = np.array(x, copy=True)
    xa *= N
    xa[xa == N] = N - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(xa, -1, N).astype(int)
    rgb = jet_lut()[np.clip(idx, 0, N - 1)]
    rgb[bad] = 0.0
    return rgb
