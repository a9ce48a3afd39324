"""Training dashboard: static report rendering + live HTTP server.

The counterpart of ``deeplearning4j_tpu/optimize/ui.py``, a copy of its
host code over the port's ``util/httpserve.py`` (reference:
deeplearning4j-ui, ``UIServer.getInstance().attach(storage)`` serving a
live dashboard fed by StatsListener): (a) the StatsListener JSONL stream
(``optimize/listeners.py``; a log written by either package renders),
(b) ``render_report()``, which turns it into one self-contained HTML
report (inline SVG, no external assets), and (c) ``UIServer.start()``, a
stdlib http.server endpoint serving the live report with auto-refresh
plus a JSONL polling route (``/train/updates?since=N``).
"""

from __future__ import annotations

import html
import json
import math
import time
import urllib.parse

from deeplearning4j_tpu_torch.util.httpserve import HttpServerOwner, JsonHandler


def _read_records(logFile):
    recs = []
    with open(logFile) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except ValueError:
                continue  # torn write at the tail of a live file
    return recs


def _svg_line_chart(points, title, width=640, height=220, fmt="{:.4g}"):
    """One series as an inline SVG polyline with min/max axis labels."""
    if len(points) < 2:
        return (f"<div class='chart'><h3>{html.escape(title)}</h3>"
                f"<p class='empty'>not enough data</p></div>")
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    xr = (x1 - x0) or 1.0
    yr = (y1 - y0) or 1.0
    pad, w, h = 8, width, height
    pts = " ".join(
        f"{pad + (x - x0) / xr * (w - 2 * pad):.1f},"
        f"{h - pad - (y - y0) / yr * (h - 2 * pad):.1f}"
        for x, y in points)
    return f"""<div class='chart'><h3>{html.escape(title)}</h3>
<svg viewBox='0 0 {w} {h}' width='{w}' height='{h}'
     style='background:#fafafa;border:1px solid #ddd'>
  <polyline fill='none' stroke='#2b6cb0' stroke-width='1.5' points='{pts}'/>
  <text x='{pad}' y='{h - 2}' font-size='10' fill='#666'>{fmt.format(y0)} … {fmt.format(y1)}</text>
  <text x='{w - 140}' y='{h - 2}' font-size='10' fill='#666'>iter {int(x0)} … {int(x1)}</text>
</svg></div>"""


def render_report(logFile, outFile=None, title="Training report"):
    """StatsListener JSONL -> self-contained HTML. Returns the HTML; if
    outFile is given, also writes it there."""
    recs = _read_records(logFile)
    stats = [r for r in recs if r.get("type") == "stats"
             and r.get("score") is not None]
    epochs = [r for r in recs if r.get("type") == "epochEnd"]

    # A diverged run writes NaN/inf scores — exactly when the report gets
    # read. Non-finite points would poison min/max and every polyline
    # coordinate; drop them and say how many were dropped.
    score_pts = [(r["iteration"], float(r["score"])) for r in stats
                 if math.isfinite(float(r["score"]))]
    dropped = len(stats) - len(score_pts)
    rate_pts = [(r["iteration"], float(r["iterationsPerSec"]))
                for r in stats if "iterationsPerSec" in r
                and math.isfinite(float(r["iterationsPerSec"]))]
    pmean_pts = [(r["iteration"], float(r["paramMeanAbs"]))
                 for r in stats if "paramMeanAbs" in r
                 and math.isfinite(float(r["paramMeanAbs"]))]

    rows = []
    if dropped:
        rows.append(("non-finite scores dropped",
                     f"{dropped} (run diverged?)"))
    if score_pts:
        rows.append(("final score", f"{score_pts[-1][1]:.6g}"))
        rows.append(("best score", f"{min(p[1] for p in score_pts):.6g}"))
        rows.append(("iterations", str(int(score_pts[-1][0]))))
    if rate_pts:
        rows.append(("mean iterations/sec",
                     f"{sum(p[1] for p in rate_pts) / len(rate_pts):.3g}"))
    if epochs:
        rows.append(("epochs", str(len(epochs))))
    if stats and "time" in stats[0] and "time" in stats[-1]:
        rows.append(("wall time",
                     f"{stats[-1]['time'] - stats[0]['time']:.1f} s"))

    table = "".join(f"<tr><td>{html.escape(k)}</td><td>{html.escape(v)}</td></tr>"
                    for k, v in rows)
    charts = _svg_line_chart(score_pts, "score vs iteration")
    if rate_pts:
        charts += _svg_line_chart(rate_pts, "iterations/sec")
    if pmean_pts:
        charts += _svg_line_chart(pmean_pts, "mean |param|")

    doc = f"""<!doctype html><html><head><meta charset='utf-8'>
<title>{html.escape(title)}</title>
<style>body{{font:14px system-ui,sans-serif;margin:2em;color:#222}}
table{{border-collapse:collapse;margin:1em 0}}
td{{border:1px solid #ddd;padding:4px 12px}}
.chart{{margin:1.2em 0}} .empty{{color:#999}}</style></head><body>
<h1>{html.escape(title)}</h1>
<p>generated {time.strftime('%Y-%m-%d %H:%M:%S')} from
{html.escape(str(logFile))} ({len(stats)} stat records)</p>
<table>{table}</table>
{charts}
</body></html>"""
    if outFile is not None:
        with open(outFile, "w") as fh:
            fh.write(doc)
    return doc


class UIServer(HttpServerOwner):
    """The reference's UIServer singleton.

    attach() takes a StatsListener (or a JSONL path); render() produces
    the HTML report for every attached source; start(port) serves the
    live report over HTTP (stdlib http.server — see module docstring):

      GET /                       report for source 0, auto-refreshing
      GET /train/<i>              report for source i
      GET /train/<i>/updates?since=N   JSONL records from line N on,
                                  as {"records": [...], "next": M}
      GET /sources                attached source paths

    The handler re-reads the JSONL on every request, so a dashboard
    open during training updates as the listener appends.
    """

    _instance = None

    @classmethod
    def getInstance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def __init__(self):
        self._sources = []

    def attach(self, source):
        path = getattr(source, "logFile", source)
        if path is None:
            raise ValueError(
                "StatsListener has no logFile — construct it with "
                "StatsListener(logFile=...) to collect a report")
        self._sources.append(str(path))
        return self

    def detach(self, source):
        path = str(getattr(source, "logFile", source))
        self._sources = [s for s in self._sources if s != path]

    def render(self, outFile=None, title="Training report"):
        """Render all attached sources; returns a list of HTML strings
        (or writes `outFile` / numbered siblings when given)."""
        docs = []
        for i, src in enumerate(self._sources):
            out = None
            if outFile is not None:
                out = str(outFile) if len(self._sources) == 1 else \
                    f"{outFile}.{i}.html"
            docs.append(render_report(src, out, title=title))
        return docs

    # ----- live server (reference: UIServer.getInstance() web UI) -----
    def start(self, port=9000, refreshSec=5, requestDeadline=None):
        """Serve the live dashboard on 127.0.0.1:<port>; returns self.
        Daemon-threaded, so it never keeps a training process alive.
        GET /healthz answers readiness; requestDeadline (seconds) turns
        a stuck handler into a 503 instead of a hung client — see
        util.httpserve."""
        ui = self

        class Handler(JsonHandler):
            def handle_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                parts = [p for p in parsed.path.split("/") if p]
                try:
                    if parsed.path == "/sources":
                        return self._json({"sources": list(ui._sources)})
                    if not parts or parts[0] == "train":
                        # /train/updates == /train/0/updates (the docs'
                        # short form for the single-source case)
                        if len(parts) > 1 and parts[1] == "updates":
                            parts = [parts[0], "0"] + parts[1:]
                        idx = int(parts[1]) if len(parts) > 1 else 0
                        if not (0 <= idx < len(ui._sources)):
                            return self._json(
                                {"error": f"no source {idx} attached"}, 404)
                        src = ui._sources[idx]
                        if len(parts) > 2 and parts[2] == "updates":
                            q = urllib.parse.parse_qs(parsed.query)
                            since = int(q.get("since", ["0"])[0])
                            recs = _read_records(src)
                            return self._json({"records": recs[since:],
                                               "next": len(recs)})
                        doc = render_report(src, title=f"Training (live) — {src}")
                        doc = doc.replace(
                            "<meta charset='utf-8'>",
                            "<meta charset='utf-8'>"
                            f"<meta http-equiv='refresh' content='{refreshSec}'>",
                            1)
                        return self._send(200, doc, "text/html")
                    return self._json({"error": "unknown route"}, 404)
                except ValueError as e:
                    # malformed index/since is the CLIENT's error
                    return self._json({"error": f"{type(e).__name__}: {e}"},
                                      400)
                except OSError as e:  # source file unreadable: ours
                    return self._json({"error": f"{type(e).__name__}: {e}"},
                                      500)

        return self._serve(Handler, port, requestDeadline=requestDeadline)
