"""Self-contained HTML run report (the reference's plotly dashboard analogue).

Port of generative_audio_tpu/utils/report.py (reference: nppc/restoration.py
log_html :803-917): one HTML file with loss curves and a metric table. The
JAX module draws its curves with matplotlib into base64 PNGs; this one draws
each series as an inline SVG polyline in plain Python, so the report needs
numpy alone. Same sections, the same log-y rule and the same (step, value)
pairs for the validation overlay. The image-grid section (img_to_png_base64,
add_image_grid) waits for the image-NPPC line (ROADMAP.md, queue A item 9);
imgs_to_grid, which it tiles with, is here.
"""
from __future__ import annotations

import html
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["imgs_to_grid", "HTMLReport", "write_training_report"]

_COLORS = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
           "#8c564b", "#e377c2", "#7f7f7f")
_WIDTH, _HEIGHT = 700, 320
_LEFT, _RIGHT, _TOP, _BOTTOM = 70, 20, 15, 45


def imgs_to_grid(imgs: np.ndarray, nrow: Optional[int] = None,
                 pad: int = 2, pad_value: float = 1.0) -> np.ndarray:
    """[N, C, H, W] -> [C, H', W'] tiled grid (ref auxil.py:151-178)."""
    imgs = np.asarray(imgs)
    n, c, h, w = imgs.shape
    nrow = nrow or int(np.ceil(np.sqrt(n)))
    ncol = int(np.ceil(n / nrow))
    grid = np.full((c, ncol * (h + pad) + pad, nrow * (w + pad) + pad),
                   pad_value, imgs.dtype)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[:, y:y + h, x:x + w] = imgs[i]
    return grid


def _points(ys) -> Tuple[np.ndarray, np.ndarray]:
    """A series as matplotlib's ax.plot reads it: (step, value) pairs, or
    values at 0, 1, 2, ..."""
    ys = np.asarray(ys, np.float64)
    if ys.ndim == 2 and ys.shape[1] == 2:
        return ys[:, 0], ys[:, 1]
    return np.arange(len(ys), dtype=np.float64), ys.reshape(-1)


def _span(lo: float, hi: float) -> Tuple[float, float]:
    if hi > lo:
        return lo, hi
    return lo - 0.5, hi + 0.5


def _svg_curves(series: Dict[str, Sequence[float]], xlabel: str,
                ylabel: str, logy: bool) -> str:
    """One SVG plot: a polyline per series (non-finite points, and under
    logy non-positive ones, are left out, as matplotlib masks them), the
    axes' end values, the axis labels and a legend."""
    curves: List[Tuple[str, np.ndarray, np.ndarray]] = []
    for label, ys in series.items():
        xs, vs = _points(ys)
        keep = np.isfinite(xs) & np.isfinite(vs)
        if logy:
            keep &= vs > 0
        xs, vs = xs[keep], vs[keep]
        curves.append((label, xs, np.log10(vs) if logy else vs))
    all_x = np.concatenate([c[1] for c in curves] + [np.zeros(0)])
    all_y = np.concatenate([c[2] for c in curves] + [np.zeros(0)])
    x0, x1 = _span(*((all_x.min(), all_x.max()) if all_x.size else (0., 1.)))
    y0, y1 = _span(*((all_y.min(), all_y.max()) if all_y.size else (0., 1.)))
    pw, ph = _WIDTH - _LEFT - _RIGHT, _HEIGHT - _TOP - _BOTTOM

    def px(x):
        return _LEFT + (x - x0) / (x1 - x0) * pw

    def py(y):
        return _TOP + (y1 - y) / (y1 - y0) * ph

    def ylab(y):
        return f"{10 ** y:.4g}" if logy else f"{y:.4g}"

    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{_WIDTH}" '
             f'height="{_HEIGHT}" font-family="sans-serif" font-size="11">',
             f'<rect x="{_LEFT}" y="{_TOP}" width="{pw}" height="{ph}" '
             'fill="white" stroke="#888"/>',
             f'<text x="{_LEFT - 4}" y="{_TOP + 4}" text-anchor="end">'
             f'{ylab(y1)}</text>',
             f'<text x="{_LEFT - 4}" y="{_TOP + ph}" text-anchor="end">'
             f'{ylab(y0)}</text>',
             f'<text x="{_LEFT}" y="{_TOP + ph + 14}" text-anchor="middle">'
             f'{x0:.4g}</text>',
             f'<text x="{_LEFT + pw}" y="{_TOP + ph + 14}" '
             f'text-anchor="middle">{x1:.4g}</text>',
             f'<text x="{_LEFT + pw / 2}" y="{_HEIGHT - 8}" '
             f'text-anchor="middle">{html.escape(xlabel)}</text>',
             f'<text x="14" y="{_TOP + ph / 2}" text-anchor="middle" '
             f'transform="rotate(-90 14 {_TOP + ph / 2})">'
             f'{html.escape(ylabel + (" (log)" if logy else ""))}</text>']
    for i, (label, xs, vs) in enumerate(curves):
        color = _COLORS[i % len(_COLORS)]
        pts = " ".join(f"{px(x):.2f},{py(v):.2f}" for x, v in zip(xs, vs))
        parts.append(f'<polyline class="series" data-label='
                     f'"{html.escape(label)}" points="{pts}" fill="none" '
                     f'stroke="{color}" stroke-width="1.5"/>')
        # a point per value, so that a series of one value shows too
        parts.extend(f'<circle cx="{px(x):.2f}" cy="{py(v):.2f}" r="2" '
                     f'fill="{color}"/>' for x, v in zip(xs, vs))
        ly = _TOP + 14 + 14 * i
        parts.append(f'<line x1="{_LEFT + pw - 90}" y1="{ly - 4}" '
                     f'x2="{_LEFT + pw - 70}" y2="{ly - 4}" stroke="{color}" '
                     'stroke-width="1.5"/>')
        parts.append(f'<text x="{_LEFT + pw - 66}" y="{ly}">'
                     f'{html.escape(label)}</text>')
    parts.append("</svg>")
    return "".join(parts)


class HTMLReport:
    """Accumulate sections, write one self-contained HTML file."""

    def __init__(self, title: str):
        self.title = title
        self._sections = []

    def add_scalars(self, name: str, values: Dict[str, float]):
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td>"
            f"<td>{v:.6g}</td></tr>" if isinstance(v, (int, float))
            else f"<tr><td>{html.escape(str(k))}</td>"
                 f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in values.items())
        self._sections.append(
            f"<h2>{html.escape(name)}</h2><table>{rows}</table>")

    def add_curve(self, name: str, series: Dict[str, Sequence[float]],
                  xlabel: str = "step", ylabel: str = "value",
                  logy: bool = False):
        """A series is a sequence of values (at 0, 1, 2, ...) or of (step,
        value) pairs."""
        self._sections.append(
            f"<h2>{html.escape(name)}</h2>"
            + _svg_curves(series, xlabel, ylabel, logy))

    def add_html(self, fragment: str):
        self._sections.append(fragment)

    def write(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        body = "\n".join(self._sections)
        path.write_text(f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(self.title)}</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; background: #fafafa; }}
 table {{ border-collapse: collapse; }}
 td {{ border: 1px solid #ccc; padding: 4px 10px; }}
 svg {{ max-width: 100%; }}
 h2 {{ border-bottom: 1px solid #ddd; }}
</style></head><body>
<h1>{html.escape(self.title)}</h1>
<p>written {time.strftime('%Y-%m-%d %H:%M:%S')}</p>
{body}
</body></html>
""")
        return path


def write_training_report(path, title: str, loss_history,
                          val_history=None, metrics=None) -> Path:
    """One-call run report: the loss curve (with the validation overlay)
    and a final metric table (nppc/restoration.py:803-917)."""
    rep = HTMLReport(title)
    series = {"train": list(loss_history)}
    if val_history:
        series["validation"] = np.asarray(
            [(s, v) for s, v in val_history], np.float64)
    if loss_history or val_history:
        rep.add_curve("loss", series, logy=bool(
            loss_history and min(loss_history) > 0))
    if metrics:
        rep.add_scalars("final metrics", metrics)
    return rep.write(path)
