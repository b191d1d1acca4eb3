"""Zero-dependency interactive front end (stdlib ``http.server``).

The counterpart of ``light_transport_tpu.gui``, after the reference's
Streamlit GUI (app.py:43-260: widget panel -> scene build -> render ->
image + elapsed/triangle-count readout), with the standard library only:
a form of render controls, a render-on-submit endpoint, and the image +
stats readout.  Images are PNGs from ``utils.png``; renders run on the
card unless the server is given ``--device cpu``.

    python -m light_transport_tpu_torch.gui [--port 8501] [--host 127.0.0.1]
        [--device cuda]

Endpoints:
  GET /                     control panel + last render
  GET /render?preset=&...   run a render with the chosen controls
  GET /img.png              last rendered image (PNG bytes)
  GET /stats.json           the last render's stats

Everything renders through the CLI's ``render_image`` (``api.render``,
and ``render_cv`` for ``cv``); the server is stateless except for the
last-image buffer.
"""

from __future__ import annotations

import dataclasses
import html
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PRESET_NAMES = ("lts", "glass", "mesh", "point")
INTEGRATORS = ("path", "adaptive", "whitted", "bdpt", "cv")
EMISSION_MODES = ("first_hit", "always", "nee", "mis")

_FORM = """<!doctype html>
<html><head><title>light_transport_tpu_torch</title><style>
body {{ font-family: system-ui, sans-serif; margin: 2rem; max-width: 60rem; }}
fieldset {{ border: 1px solid #ccc; margin-bottom: 1rem; }}
label {{ display: inline-block; margin: 0.3rem 1rem 0.3rem 0; }}
img {{ image-rendering: pixelated; border: 1px solid #888; }}
table {{ border-collapse: collapse; }} td, th {{ padding: 0.2rem 0.8rem;
border: 1px solid #ddd; text-align: left; }}
</style></head><body>
<h1>light_transport_tpu_torch</h1>
<form action="/render" method="get">
<fieldset><legend>Scene &amp; integrator</legend>
<label>preset <select name="preset">{presets}</select></label>
<label>integrator <select name="integrator">{integrators}</select></label>
<label>emission <select name="emission_mode">{emissions}</select></label>
</fieldset>
<fieldset><legend>Image</legend>
<label>width <input name="width" type="number" value="{width}" min="8"
 max="1024"></label>
<label>height <input name="height" type="number" value="{height}" min="8"
 max="1024"></label>
<label>spp <input name="spp" type="number" value="{spp}" min="1"
 max="512"></label>
<label>depth <input name="max_depth" type="number" value="{depth}" min="1"
 max="16"></label>
<label>seed <input name="seed" type="number" value="{seed}"></label>
</fieldset>
<button type="submit">Render</button>
</form>
{result}
</body></html>"""


def _options(names, chosen):
    return "".join(
        f'<option value="{n}"{" selected" if n == chosen else ""}>{n}'
        f"</option>" for n in names
    )


class _State:
    png: bytes = b""
    stats: dict = {}


def run_render(params: dict, device="cuda") -> dict:
    """Render with the form parameters on ``device``; returns the stats
    dict and stores the PNG in ``_State`` (separated from the handler for
    direct testing)."""
    from light_transport_tpu_torch.cli import render_image
    from light_transport_tpu_torch.models import presets as P
    from light_transport_tpu_torch.utils.png import encode_png

    preset = params.get("preset", "lts")
    if preset not in PRESET_NAMES:
        raise ValueError(f"unknown preset {preset!r}")
    integrator = params.get("integrator", "path")
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    scene, cfg = P.PRESETS[preset](device=device)
    # server-side clamps (the form's min/max don't bind a raw GET)
    caps = {"width": 1024, "height": 1024, "spp": 512, "max_depth": 16}
    over = {}
    for k, cap in caps.items():
        if params.get(k):
            over[k] = min(cap, max(1, int(params[k])))
    em = params.get("emission_mode")
    if em and em in EMISSION_MODES and integrator in ("path", "adaptive",
                                                      "cv"):
        over["emission_mode"] = em
    if over:
        cfg = dataclasses.replace(cfg, **over)
    seed = int(params.get("seed", 0) or 0)
    t0 = time.time()
    # api.render has no cv branch (render_cv returns a telemetry bundle,
    # not an image): the CLI's render_image routes it
    img = render_image(scene, cfg, seed, integrator).cpu().numpy()
    dt = time.time() - t0
    _State.png = encode_png(img)
    _State.stats = {
        "preset": preset,
        "integrator": integrator,
        "size": f"{cfg.width}x{cfg.height}",
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        "seed": seed,
        "triangles": int(scene.mesh.v0.shape[0]),
        "elapsed_s": round(dt, 2),
        "mean": round(float(img.mean()), 4),
    }
    return _State.stats


def _page(params: dict) -> str:
    stats = _State.stats
    result = ""
    if stats:
        rows = "".join(
            f"<tr><th>{html.escape(str(k))}</th>"
            f"<td>{html.escape(str(v))}</td></tr>"
            for k, v in stats.items()
        )
        # elapsed/triangle-count readout: the reference surfaces the same
        # stats after its render (app.py:253-256)
        result = (f'<h2>Render</h2><img src="/img.png?t={time.time()}" '
                  f'width="384"><table>{rows}</table>')
    return _FORM.format(
        presets=_options(PRESET_NAMES, params.get("preset", "lts")),
        integrators=_options(INTEGRATORS,
                             params.get("integrator", "path")),
        emissions=_options(EMISSION_MODES,
                           params.get("emission_mode", "first_hit")),
        width=params.get("width", 96),
        height=params.get("height", 96),
        spp=params.get("spp", 8),
        depth=params.get("max_depth", 4),
        seed=params.get("seed", 0),
        result=result,
    )


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _send(self, code, body, ctype="text/html; charset=utf-8"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        params = {k: v[0] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        try:
            if parsed.path == "/img.png":
                if not _State.png:
                    self._send(404, b"no render yet",
                               "text/plain; charset=utf-8")
                    return
                self._send(200, _State.png, "image/png")
            elif parsed.path == "/render":
                run_render(params, self.server.device)
                self._send(200, _page(params).encode())
            elif parsed.path == "/stats.json":
                self._send(200, json.dumps(_State.stats).encode(),
                           "application/json")
            else:
                self._send(200, _page(params).encode())
        except Exception as e:  # surface errors in the page, keep serving
            msg = f"<h1>error</h1><pre>{html.escape(repr(e))}</pre>"
            self._send(500, msg.encode())


def serve(port: int = 8501, host: str = "127.0.0.1",
          background: bool = False, device="cuda"):
    """Start the GUI server, rendering on ``device``.  ``background=True``
    returns the server (running on a daemon thread) instead of blocking;
    the caller ends it with ``shutdown()`` and ``server_close()``."""
    srv = ThreadingHTTPServer((host, port), Handler)
    srv.device = device
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv
    print(f"light_transport_tpu_torch GUI on http://{host}:{srv.server_port}/ "
          f"(ctrl-c to stop)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return srv


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="light_transport_tpu_torch.gui")
    ap.add_argument("--port", type=int, default=8501)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    args = ap.parse_args(argv)
    serve(args.port, args.host, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
