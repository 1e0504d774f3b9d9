"""Figures as PNG files, drawn with numpy and written with zlib and struct.

Port of generative_audio_tpu/utils/plot.py:26-102 (plot_alignment,
plot_spectrogram, plot_waveform, spectrogram_figure) and the pixel layer
the NPPC validators draw their figures with. The card's machine has no
matplotlib and no PIL, so every figure is an RGB array: heatmaps through a
viridis-like ramp (origin lower), panels on a white canvas with gutters,
lines and bars in a fixed palette, without titles, ticks or colorbars.
spectrogram_figure returns the array where the JAX function returns a
matplotlib figure.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["GAP", "heatmap", "png_bytes", "write_png", "compose", "line_plot",
           "bar_chart", "plot_alignment", "plot_spectrogram",
           "plot_waveform", "spectrogram_figure"]

# white gutter between panels (pixels) and a viridis-like colour ramp (five
# stops, dark to light)
GAP = 4
_RAMP = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140], [94, 201, 98],
                  [253, 231, 37]], np.float64)
# line and bar colours
_PALETTE = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                     [214, 39, 40], [148, 103, 189], [140, 86, 75],
                     [227, 119, 194], [127, 127, 127], [188, 189, 34],
                     [23, 190, 207]], np.uint8)


def png_bytes(pixels: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W] (gray) -> the bytes of an 8-bit PNG
    (filter 0 on every row)."""
    h, w = pixels.shape[:2]
    color = 2 if pixels.ndim == 3 else 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(pixels, np.uint8).reshape(h, -1)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray) -> Path:
    """uint8 [H, W, 3] -> an 8-bit RGB PNG file (png_bytes)."""
    Path(path).write_bytes(png_bytes(rgb))
    return Path(path)


def heatmap(values: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """[F, T] -> uint8 [F, T, 3] through the ramp, origin lower; the range
    is [vmin, vmax], each bound the data's own where None."""
    values = np.asarray(values)
    lo = np.min(values) if vmin is None else vmin
    hi = np.max(values) if vmax is None else vmax
    x = np.clip((values - lo) / max(hi - lo, 1e-12), 0.0, 1.0)[::-1]
    stops = np.linspace(0.0, 1.0, len(_RAMP))
    return np.stack([np.interp(x, stops, _RAMP[:, k]) for k in range(3)],
                    axis=-1).round().astype(np.uint8)


def compose(rows: Sequence[Sequence[Optional[np.ndarray]]]) -> np.ndarray:
    """A grid of panels (None leaves a cell empty) on a white canvas, GAP
    pixels apart; each row is as tall and each column as wide as its
    largest panel."""
    n_cols = max(len(r) for r in rows)
    heights = [max((p.shape[0] for p in r if p is not None), default=0)
               for r in rows]
    widths = [max((r[j].shape[1] for r in rows
                   if j < len(r) and r[j] is not None), default=0)
              for j in range(n_cols)]
    canvas = np.full((sum(heights) + GAP * (len(rows) + 1),
                      sum(widths) + GAP * (n_cols + 1), 3), 255, np.uint8)
    y = GAP
    for r, h in zip(rows, heights):
        x = GAP
        for j, w in enumerate(widths):
            if j < len(r) and r[j] is not None:
                ph, pw = r[j].shape[:2]
                canvas[y:y + ph, x:x + pw] = r[j]
            x += w + GAP
        y += h + GAP
    return canvas


def line_plot(series: Sequence[np.ndarray], width: int = 800,
              height: int = 240, x: Optional[Sequence[np.ndarray]] = None,
              ylim=None) -> np.ndarray:
    """Each series a polyline in its palette colour on a white [height,
    width, 3] panel; NaN breaks a line. x (default: the index) and y are
    scaled to the panel over all series (y over ylim where given)."""
    canvas = np.full((height, width, 3), 255, np.uint8)
    xs = [np.arange(len(s), dtype=np.float64) if x is None
          else np.asarray(x[i], np.float64) for i, s in enumerate(series)]
    ys = [np.asarray(s, np.float64) for s in series]
    finite = np.concatenate([y[np.isfinite(y)] for y in ys] + [np.zeros(0)])
    if finite.size == 0:
        return canvas
    lo, hi = ylim if ylim is not None else (finite.min(), finite.max())
    x_lo = min(v.min() for v in xs if v.size)
    x_hi = max(v.max() for v in xs if v.size)
    for i, (xv, yv) in enumerate(zip(xs, ys)):
        colour = _PALETTE[i % len(_PALETTE)]
        px = (xv - x_lo) / max(x_hi - x_lo, 1e-12) * (width - 1)
        py = (height - 1) - (np.clip(yv, lo, hi) - lo) / max(hi - lo, 1e-12) \
            * (height - 1)
        for k in range(len(px) - 1):
            if not (np.isfinite(py[k]) and np.isfinite(py[k + 1])):
                continue
            n = int(max(abs(px[k + 1] - px[k]), abs(py[k + 1] - py[k]))) + 1
            cols = np.linspace(px[k], px[k + 1], n + 1).round().astype(int)
            rows = np.linspace(py[k], py[k + 1], n + 1).round().astype(int)
            canvas[rows, cols] = colour
        single = np.isfinite(py) & ~(np.isfinite(np.roll(py, 1))
                                     | np.isfinite(np.roll(py, -1)))
        canvas[py[single].round().astype(int),
               px[single].round().astype(int)] = colour
    return canvas


def bar_chart(groups: Sequence[Sequence[float]], bar_width: int = 12,
              height: int = 240) -> np.ndarray:
    """Grouped bars: groups[i][j] is bar j of group i (colour j), scaled to
    the largest value; negative and non-finite values draw nothing."""
    values = np.asarray(groups, np.float64)
    n_groups, n_bars = values.shape
    top = np.nanmax(np.where(np.isfinite(values), values, np.nan)) \
        if np.isfinite(values).any() else 0.0
    group_w = n_bars * bar_width + 2 * GAP
    canvas = np.full((height, max(n_groups, 1) * group_w + GAP, 3), 255,
                     np.uint8)
    for i in range(n_groups):
        for j in range(n_bars):
            v = values[i, j]
            if not np.isfinite(v) or v <= 0 or top <= 0:
                continue
            h = int(round(v / top * (height - 1)))
            x0 = GAP + i * group_w + GAP + j * bar_width
            canvas[height - h:, x0:x0 + bar_width - 1] = \
                _PALETTE[j % len(_PALETTE)]
    return canvas


def plot_alignment(alignment: np.ndarray, path) -> Path:
    """An alignment heatmap, values clipped at 1, origin lower."""
    return write_png(path, heatmap(np.minimum(np.asarray(alignment), 1.0)))


def plot_spectrogram(spectrogram: np.ndarray, plot_path,
                     title: str = "mel-spec") -> Path:
    """The spectrogram rotated by 90 degrees over its own range, as the JAX
    function draws it (the title is not drawn)."""
    spectrogram = np.asarray(spectrogram)
    return write_png(plot_path, heatmap(np.rot90(spectrogram)[::-1]))


def _waveform_panel(w: np.ndarray, width: int, height: int) -> np.ndarray:
    """The minimum and maximum of each column's samples in [-1.05, 1.05]."""
    canvas = np.full((height, width, 3), 255, np.uint8)
    w = np.asarray(w, np.float64).reshape(-1)
    if w.size == 0:
        return canvas
    edges = np.linspace(0, w.size, width + 1).astype(int)
    scale = (height - 1) / 2.1
    for col in range(width):
        seg = w[edges[col]:max(edges[col + 1], edges[col] + 1)]
        top = int(round((1.05 - np.clip(seg.max(), -1.05, 1.05)) * scale))
        bottom = int(round((1.05 - np.clip(seg.min(), -1.05, 1.05)) * scale))
        canvas[top:bottom + 1, col] = _PALETTE[0]
    return canvas


def plot_waveform(waveforms: Sequence[np.ndarray], path,
                  labels: Optional[Sequence[str]] = None,
                  sr: int = 16000) -> Path:
    """Stacked waveform panels on one time axis, y in [-1.05, 1.05] (the
    labels are not drawn)."""
    width = 1000
    return write_png(path, compose(
        [[_waveform_panel(w, width, 120)] for w in waveforms]))


def spectrogram_figure(specs: Sequence[np.ndarray],
                       titles: Optional[Sequence[str]] = None,
                       log_scale: bool = True) -> np.ndarray:
    """Stacked spectrogram panels (20 log10 of each where log_scale), origin
    lower, each over its own range -> uint8 [H, W, 3]."""
    panels = []
    for s in specs:
        s = np.asarray(s, np.float64)
        if log_scale:
            s = 20 * np.log10(np.maximum(s, 1e-8))
        panels.append([heatmap(s)])
    return compose(panels)
