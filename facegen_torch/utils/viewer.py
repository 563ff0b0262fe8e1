"""Minimal training-dashboard HTTP server (counterpart of
facegen/utils/viewer.py; the standard library only).

The reference pushes six live image windows to a `display`/gfx.js
browser server (README.md:45, 56-57; nn_utils.lua:191-200). Here the
trainer already writes those windows as PNGs under `<save>/viz/` plus
`metrics.jsonl`; this module serves them as an auto-refreshing dashboard
with a zero-dependency stdlib HTTP server:

    python -m facegen_torch.utils.viewer --dir logs --port 8097

Endpoints:
  /            dashboard (auto-refreshing grid of all viz PNGs + the
               latest metrics row)
  /img/<name>  the PNG files under <dir>/viz
  /metrics     metrics.jsonl as JSON array
"""

from __future__ import annotations

import html
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = """<!doctype html>
<html><head><title>facegen dashboard</title>
<meta http-equiv="refresh" content="{refresh}">
<style>
 body {{ background:#111; color:#ddd; font-family:monospace; }}
 .win {{ display:inline-block; margin:8px; vertical-align:top; }}
 .win img {{ image-rendering:pixelated; border:1px solid #444;
             min-width:260px; }}
 .cap {{ font-size:12px; margin:2px; }}
 pre {{ color:#8c8; }}
</style></head><body>
<h3>facegen training dashboard — {dir}</h3>
<pre>{metrics}</pre>
{windows}
</body></html>"""


def _parse_line(line: str):
    """One metrics.jsonl row, or None for blank/torn lines (the trainer
    may be mid-append when we read)."""
    line = line.strip()
    if not line:
        return None
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return None


def _make_handler(base_dir: str, refresh: int):
    viz_dir = os.path.join(base_dir, "viz")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, content, ctype="text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(content)))
            self.end_headers()
            self.wfile.write(content)

        def do_GET(self):
            if self.path.startswith("/img/"):
                # allow nested dirs like netvis/<layer>.png, but pin the
                # resolved path inside viz_dir (".." traversal would
                # otherwise serve any .png on the filesystem)
                rel = self.path[len("/img/"):]
                path = os.path.realpath(os.path.join(viz_dir, *rel.split("/")))
                root = os.path.realpath(viz_dir)
                inside = path == root or path.startswith(root + os.sep)
                if inside and os.path.exists(path) and path.endswith(".png"):
                    with open(path, "rb") as f:
                        self._send(200, f.read(), "image/png")
                else:
                    self._send(404, b"not found", "text/plain")
                return
            if self.path.startswith("/metrics"):
                records = []
                mpath = os.path.join(base_dir, "metrics.jsonl")
                if os.path.exists(mpath):
                    with open(mpath) as f:
                        records = [r for r in map(_parse_line, f)
                                   if r is not None]
                self._send(200, json.dumps(records).encode(),
                           "application/json")
                return
            # dashboard
            windows = []
            if os.path.isdir(viz_dir):
                for root, _, files in sorted(os.walk(viz_dir)):
                    for fname in sorted(files):
                        if not fname.endswith(".png"):
                            continue
                        rel = os.path.relpath(os.path.join(root, fname), viz_dir)
                        windows.append(
                            f'<div class="win"><div class="cap">{html.escape(rel)}'
                            f'</div><img src="/img/{rel}"></div>'
                        )
            last = ""
            mpath = os.path.join(base_dir, "metrics.jsonl")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    rows = [r for r in map(_parse_line, f) if r is not None]
                if rows:
                    last = html.escape(json.dumps(rows[-1], indent=1))
            page = _PAGE.format(refresh=refresh, dir=html.escape(base_dir),
                                metrics=last, windows="\n".join(windows))
            self._send(200, page.encode())

    return Handler


def serve(base_dir: str, port: int = 8097, refresh: int = 5,
          background: bool = False) -> Optional[ThreadingHTTPServer]:
    """Serve the dashboard; background=True returns the server (tests)."""
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(base_dir, refresh))
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    print(f"dashboard: http://localhost:{port}/ (dir {base_dir})")
    httpd.serve_forever()
    return None


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="facegen training dashboard")
    p.add_argument("--dir", default="logs", help="training save dir")
    p.add_argument("--port", type=int, default=8097)
    p.add_argument("--refresh", type=int, default=5, help="page refresh (s)")
    a = p.parse_args(argv)
    serve(a.dir, a.port, a.refresh)


if __name__ == "__main__":
    main()
