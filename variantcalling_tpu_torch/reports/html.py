"""Minimal self-contained HTML report writer, shared by the report tools.

Counterpart of ``variantcalling_tpu/reports/html.py`` without pandas: a
table is a :class:`~variantcalling_tpu_torch.utils.h5_utils.Frame`, rendered
by :func:`frame_to_html` as pandas 3's ``DataFrame.to_html(float_format=...,
border=0)`` renders the same frame (the index column, the header row, floats
through the format or ``NaN``, ints, booleans and strings, ``&<>`` escaped).

:func:`add_figure_safe` keeps the reference's behaviour: where matplotlib
imports, the figure is drawn and embedded as a PNG ``<img>``; where it does
not (the card's machine has none) or drawing fails, the figure is recorded
as skipped through ``utils/degrade`` (point :data:`FIGURE_POINT`), counted
in ``HtmlReport.figures_skipped`` and a warning logged. Figures are
presentation: the document is otherwise the same either way.
"""

from __future__ import annotations

import base64
import html as _html
import io
import logging

import numpy as np

from variantcalling_tpu_torch.utils import degrade
from variantcalling_tpu_torch.utils.h5_utils import Frame

log = logging.getLogger(__name__)

_STYLE = """
body { font-family: -apple-system, Segoe UI, sans-serif; margin: 2em; color: #222; }
h1 { border-bottom: 2px solid #444; padding-bottom: .2em; }
h2 { margin-top: 1.6em; color: #333; }
table { border-collapse: collapse; margin: .8em 0; font-size: .92em; }
th, td { border: 1px solid #bbb; padding: .3em .7em; text-align: right; }
th { background: #f0f0f0; }
td:first-child, th:first-child { text-align: left; }
img { max-width: 100%; }
.param { color: #666; font-size: .9em; }
"""

#: the degradation point of a skipped figure (``utils/degrade``)
FIGURE_POINT = "reports.figure"


def _cell(text: str) -> str:
    """A cell's text as pandas writes it: ``&<>`` escaped, stripped, double spaces as ``&nbsp;``."""
    text = text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;").strip()
    return text.replace("  ", "&nbsp;&nbsp;")


def _missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and v != v)


def _column_texts(col: np.ndarray, float_fmt: str) -> list[str]:
    """Each value's text by its column's kind: floats through ``float_fmt``
    (``NaN`` where missing), ints and booleans as Python prints them,
    objects by ``str`` (``NaN`` for None or a float NaN)."""
    if col.dtype.kind == "f":
        return ["NaN" if v != v else float_fmt.format(v) for v in col.tolist()]
    if col.dtype.kind in "biu":
        return [str(v) for v in col.tolist()]
    return ["NaN" if _missing(v) else str(v) for v in col]


def frame_to_html(frame: Frame, float_fmt: str = "{:,.4g}") -> str:
    """``frame`` as pandas' ``to_html(float_format=float_fmt.format, border=0)``."""
    lines = ['<table class="dataframe">', "  <thead>", '    <tr style="text-align: right;">', "      <th></th>"]
    lines += [f"      <th>{_cell(str(name))}</th>" for name in frame.columns]
    lines += ["    </tr>", "  </thead>", "  <tbody>"]
    n = len(frame)
    index = range(n) if frame.index is None else frame.index
    index_texts = [str(v) for v in (index.tolist() if isinstance(index, np.ndarray) else list(index))]
    cols = [_column_texts(np.asarray(frame[name]), float_fmt) for name in frame.columns]
    for i in range(n):
        lines += ["    <tr>", f"      <th>{_cell(index_texts[i])}</th>"]
        lines += [f"      <td>{_cell(c[i])}</td>" for c in cols]
        lines.append("    </tr>")
    lines += ["  </tbody>", "</table>"]
    return "\n".join(lines)


class HtmlReport:
    def __init__(self, title: str):
        self.title = title
        self.parts: list[str] = []
        self.figures_skipped = 0

    def add_params(self, params: dict) -> None:
        rows = "".join(
            f"<tr><td>{_html.escape(str(k))}</td><td>{_html.escape(str(v))}</td></tr>"
            for k, v in params.items()
        )
        self.parts.append(f'<table class="param"><tr><th>parameter</th><th>value</th></tr>{rows}</table>')

    def add_section(self, heading: str) -> None:
        self.parts.append(f"<h2>{_html.escape(heading)}</h2>")

    def add_table(self, frame: Frame, float_fmt: str = "{:,.4g}") -> None:
        self.parts.append(frame_to_html(frame, float_fmt))

    def add_text(self, text: str) -> None:
        self.parts.append(f"<p>{_html.escape(text)}</p>")

    def add_figure(self, fig) -> None:
        buf = io.BytesIO()
        fig.savefig(buf, format="png", bbox_inches="tight", dpi=110)
        b64 = base64.b64encode(buf.getvalue()).decode()
        self.parts.append(f'<img src="data:image/png;base64,{b64}"/>')

    def write(self, path: str) -> str:
        doc = (
            f"<html><head><meta charset='utf-8'><title>{_html.escape(self.title)}</title>"
            f"<style>{_STYLE}</style></head><body><h1>{_html.escape(self.title)}</h1>"
            + "".join(self.parts)
            + "</body></html>"
        )
        with open(path, "w") as fh:
            fh.write(doc)
        return path


def add_figure_safe(rep: HtmlReport, build, what: str = "figure") -> None:
    """Draw ``build(plt)`` (matplotlib, Agg) and embed it, close it; never raise.

    ``build`` returns the figure, or None to draw nothing. Where matplotlib
    does not import or ``build`` fails, the figure is skipped: recorded at
    :data:`FIGURE_POINT`, counted in ``rep.figures_skipped``, a warning logged."""
    try:
        import matplotlib  # optional: presentation only, absent on the card's machine

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = build(plt)
        if fig is not None:
            rep.add_figure(fig)
            plt.close(fig)
    except Exception as e:  # noqa: BLE001 - figures are presentation only
        rep.figures_skipped += 1
        degrade.record(FIGURE_POINT, e, fallback=f"{what} skipped")
        log.warning("%s skipped: %s", what, e)
