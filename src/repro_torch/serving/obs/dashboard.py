"""Live terminal dashboard and standalone HTML report. Stdlib only (a
copy of ``repro.serving.obs.dashboard``).

The dashboard is the human-facing end of the windows/auditor layers: a
single ANSI frame per refresh showing, for each replica, the windowed
serving signals (ITL/TTFT percentiles, token rate, batch, KV occupancy
sparklines), the memory-gap waste bar (used / block-pad / prefix-held /
free, with the reserved-unused overlay), and per-SLO burn-rate status.
Rendering is a pure function of observability state (``render`` returns
a string; tests assert on it without a terminal), and the live loop is
just "write the frame to a TTY at most every ``interval_s``".

``html_report`` writes the same content as a self-contained HTML file
(inline CSS + SVG polylines, no JavaScript, no external assets) so a CI
run or remote soak leaves a browsable artifact behind.
"""
from __future__ import annotations

import html as _html
import sys
from typing import List, Optional, Sequence, Tuple

from repro_torch.serving.obs.windows import (
    STREAM_BATCH, STREAM_ITL, STREAM_KV, STREAM_TOKENS, STREAM_TTFT)

_SPARK = " ▁▂▃▄▅▆▇█"
_RESET = "\x1b[0m"
_BOLD = "\x1b[1m"
_DIM = "\x1b[2m"
_RED = "\x1b[31m"
_GREEN = "\x1b[32m"
_YELLOW = "\x1b[33m"
_CYAN = "\x1b[36m"
_HOME_CLEAR = "\x1b[H\x1b[2J"

# waste bar segments: (auditor term, glyph, color)
_BAR_SEGMENTS: Sequence[Tuple[str, str, str]] = (
    ("used", "█", _GREEN),
    ("block_pad", "▓", _YELLOW),
    ("prefix_held", "▒", _CYAN),
    ("free", "░", _DIM),
)


def sparkline(values: Sequence[float], width: int = 24) -> str:
    """Last ``width`` values as unicode block heights (min-max scaled)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK[4] * len(vals)
    return "".join(
        _SPARK[1 + int((v - lo) / span * (len(_SPARK) - 2))] for v in vals)


def waste_bar(wb, width: int = 50, color: bool = True) -> str:
    """One-line pool partition bar for a :class:`WasteBreakdown`."""
    pool = max(wb.pool_bytes, 1)
    out, drawn = [], 0
    for term, glyph, col in _BAR_SEGMENTS:
        frac = wb.value(term) / pool
        n = min(int(round(frac * width)), width - drawn)
        if n <= 0:
            continue
        seg = glyph * n
        out.append(col + seg + _RESET if color else seg)
        drawn += n
    if drawn < width:
        pad = "░" * (width - drawn)
        out.append(_DIM + pad + _RESET if color else pad)
    return "".join(out)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024
    return f"{n:.1f}GiB"


def render(obs, t_now: float, *, width: int = 78,
           color: bool = True) -> str:
    """One dashboard frame from an ``Observability`` instance. Pure."""
    def c(code: str, s: str) -> str:
        return code + s + _RESET if color else s

    w = getattr(obs, "windows", None)
    lines: List[str] = []
    lines.append(c(_BOLD, f"serving dashboard  t={t_now:9.3f}s  "
                          f"replicas={len(obs.observers)}"))
    lines.append("─" * width)

    # windowed signals (cluster-wide streams)
    if w is not None:
        for stream, label in ((STREAM_ITL, "itl"), (STREAM_TTFT, "ttft"),
                              (STREAM_TOKENS, "tok/step"),
                              (STREAM_BATCH, "batch"),
                              (STREAM_KV, "kv used")):
            st = w.window(stream, t_now=t_now, span_s=10.0)
            spark = sparkline([v for _, v in w.samples(stream)])
            if st.count:
                lines.append(f"{label:>9s}  n={st.count:<5d} "
                             f"mean={st.mean:<9.4g} p95={st.p95:<9.4g} "
                             f"rate={st.rate:<7.3g}/s {c(_CYAN, spark)}")
            else:
                empty = c(_DIM, "(no samples in window)")
                lines.append(f"{label:>9s}  {empty}")
        lines.append("─" * width)

    # per-replica memory gap bars
    for pid in sorted(obs.observers):
        ob = obs.observers[pid]
        aud = getattr(ob, "auditor", None)
        if aud is None or not aud.steps:
            continue
        wb = aud.steps[-1]
        used_pct = 100.0 * wb.used_bytes / max(wb.pool_bytes, 1)
        lines.append(
            f"replica {pid} pool "
            f"[{waste_bar(wb, width=width - 30, color=color)}] "
            f"{used_pct:5.1f}% used")
        lines.append(
            "  " + c(_DIM,
                     f"used={_fmt_bytes(wb.used_bytes)} "
                     f"blk_pad={_fmt_bytes(wb.block_pad_bytes)} "
                     f"pfx_held={_fmt_bytes(wb.prefix_held_bytes)} "
                     f"free={_fmt_bytes(wb.free_bytes)} | overlays: "
                     f"resv_unused={_fmt_bytes(wb.reserved_unused_bytes)} "
                     f"bucket_pad={_fmt_bytes(wb.bucket_pad_bytes)}"))

    # SLO status
    mon = getattr(obs, "slo", None)
    if mon is not None:
        lines.append("─" * width)
        for row in mon.status(t_now):
            state = c(_RED, "BREACH") if row["breached"] \
                else c(_GREEN, "ok")
            lines.append(
                f"slo {row['name']:<9s} {state:<6s} "
                f"target={row['target'] * 100:.0f}%<="
                f"{row['threshold']:g} "
                f"burn fast={row['burn_fast']:.2f}x "
                f"slow={row['burn_slow']:.2f}x")
        if mon.events:
            lines.append(c(_DIM, f"  last event: {mon.events[-1].row()}"))
    return "\n".join(lines) + "\n"


class Dashboard:
    """Interval-gated live renderer over a shared ``Observability``.

    ``tick(now)`` is called from the serving pump next to the metrics
    emitter; it re-renders at most once per ``interval_s`` on whatever
    clock the pump runs (virtual or wall). ``close()`` draws one final
    frame so short runs still show their end state.
    """

    def __init__(self, obs, *, interval_s: float = 0.5, out=None,
                 width: int = 78, color: Optional[bool] = None):
        self.obs = obs
        self.interval_s = float(interval_s)
        self.out = out if out is not None else sys.stdout
        self.width = width
        self.color = color if color is not None \
            else bool(getattr(self.out, "isatty", lambda: False)())
        self._last = None
        self.frames = 0

    def tick(self, now: float) -> bool:
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self._last = now
        self._draw(now)
        return True

    def close(self, now: Optional[float] = None):
        self._draw(now if now is not None else (self._last or 0.0))

    def _draw(self, now: float):
        frame = render(self.obs, now, width=self.width, color=self.color)
        try:
            self.out.write(_HOME_CLEAR if self.color else "")
            self.out.write(frame)
            self.out.flush()
        except (ValueError, OSError):
            return          # stream closed mid-run; the dashboard is best-effort
        self.frames += 1


# ------------------------------------------------------------- HTML -------

def _svg_polyline(samples: Sequence[Tuple[float, float]], *,
                  w: int = 640, h: int = 120,
                  stroke: str = "#2a7") -> str:
    """Inline SVG line chart of ``(t, value)`` samples (no JS)."""
    if not samples:
        return "<svg width='%d' height='%d'></svg>" % (w, h)
    ts = [t for t, _ in samples]
    vs = [v for _, v in samples]
    t0, t1 = min(ts), max(ts)
    lo, hi = min(vs), max(vs)
    tspan = (t1 - t0) or 1.0
    vspan = (hi - lo) or 1.0
    pts = " ".join(
        f"{(t - t0) / tspan * (w - 10) + 5:.1f},"
        f"{h - 5 - (v - lo) / vspan * (h - 30):.1f}"
        for t, v in samples)
    return (f"<svg width='{w}' height='{h}' "
            f"style='background:#f7f7f7;border:1px solid #ddd'>"
            f"<text x='5' y='12' font-size='10' fill='#666'>"
            f"max={hi:.4g}</text>"
            f"<text x='5' y='{h - 8}' font-size='10' fill='#666'>"
            f"min={lo:.4g}</text>"
            f"<polyline fill='none' stroke='{stroke}' stroke-width='1.5' "
            f"points='{pts}'/></svg>")


def html_report(obs, t_now: float, *, title: str = "serving run") -> str:
    """Self-contained HTML report string (charts, waste, SLO tables)."""
    esc = _html.escape
    parts: List[str] = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{esc(title)}</title>",
        "<style>body{font-family:monospace;margin:2em;color:#222}"
        "table{border-collapse:collapse;margin:1em 0}"
        "td,th{border:1px solid #ccc;padding:3px 9px;text-align:right}"
        "th{background:#eee}td:first-child,th:first-child"
        "{text-align:left}.breach{color:#b00;font-weight:bold}"
        ".ok{color:#080}h2{margin-top:1.6em}</style></head><body>",
        f"<h1>{esc(title)}</h1>",
        f"<p>rendered at t={t_now:.3f}s, "
        f"{len(obs.observers)} replica(s)</p>"]

    w = getattr(obs, "windows", None)
    if w is not None and w.streams():
        parts.append("<h2>Windowed signals</h2>")
        for stream in w.streams():
            st = w.window(stream, t_now=t_now, span_s=10.0)
            parts.append(f"<h3>{esc(stream)}</h3>")
            parts.append(f"<p>{esc(st.row())}</p>")
            parts.append(_svg_polyline(w.samples(stream)))

    any_audit = False
    for pid in sorted(obs.observers):
        aud = getattr(obs.observers[pid], "auditor", None)
        if aud is None or not aud.audits:
            continue
        if not any_audit:
            parts.append("<h2>Memory gap</h2>")
            any_audit = True
        rep = aud.report()
        parts.append(f"<h3>replica {pid}</h3><table>"
                     "<tr><th>term</th><th>mean bytes</th>"
                     "<th>% of pool</th></tr>")
        pool = max(rep["pool_bytes"], 1)
        for term, val in rep["mean_bytes"].items():
            parts.append(f"<tr><td>{esc(term)}</td><td>{val:.0f}</td>"
                         f"<td>{100 * val / pool:.1f}%</td></tr>")
        parts.append("</table>")
        parts.append(
            f"<p>pool={rep['pool_bytes']} B, "
            f"steps={rep['steps_audited']}, "
            f"peak used={rep['peak_used_bytes']} B "
            f"(step {rep['peak_used_step']}, "
            f"{rep['peak_used_tokens_per_req']:.1f} tok/req), "
            f"mean gap={rep['gap_fraction_mean'] * 100:.1f}%, "
            f"worst term=<b>{esc(rep['worst_term'])}</b></p>")
        parts.append(_svg_polyline(
            [(wb.step, wb.used_bytes) for wb in aud.steps],
            stroke="#27a"))

    mon = getattr(obs, "slo", None)
    if mon is not None:
        parts.append("<h2>SLOs</h2><table><tr><th>slo</th><th>state</th>"
                     "<th>target</th><th>threshold</th>"
                     "<th>burn fast</th><th>burn slow</th></tr>")
        for row in mon.status(t_now):
            cls = "breach" if row["breached"] else "ok"
            state = "BREACH" if row["breached"] else "ok"
            parts.append(
                f"<tr><td>{esc(row['name'])}</td>"
                f"<td class='{cls}'>{state}</td>"
                f"<td>{row['target'] * 100:.0f}%</td>"
                f"<td>{row['threshold']:g}</td>"
                f"<td>{row['burn_fast']:.2f}x</td>"
                f"<td>{row['burn_slow']:.2f}x</td></tr>")
        parts.append("</table>")
        if mon.events:
            parts.append("<h3>events</h3><ul>")
            parts.extend(f"<li>{esc(e.row())}</li>" for e in mon.events)
            parts.append("</ul>")

    parts.append("</body></html>")
    return "".join(parts)


def write_html_report(obs, t_now: float, path: str, *,
                      title: str = "serving run") -> str:
    with open(path, "w") as f:
        f.write(html_report(obs, t_now, title=title))
    return path
