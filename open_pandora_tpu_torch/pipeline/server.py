"""Web UI: the reference's gradio app on the stdlib http.server.

Counterpart of open_pandora_tpu/pipeline/server.py (reference
gradio_app.py: port 10041, an image upload, the actions, DDIM steps,
guidance, eta, fs and seed): one page, `GET /health`, and `POST
/generate`, which runs the ChatWM rounds and answers with the mp4.

    python -m open_pandora_tpu_torch.pipeline.server --port 10041 \\
        [--ckpt step_<n>/ or model.ckpt] [--tokenizer DIR] [--debug]
        [--device cuda]

The HTTP layer is model-free: `make_server` takes the `generate_fn` that
answers a request, and `chatwm_generate_fn` makes one from a session
(built by pipeline/cli.build_chat), one request at a time on the one
card. Decoding the upload needs PIL and encoding the mp4 OpenCV, each
imported by that function's call.
"""

from __future__ import annotations

import io
import json
import os
import re
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

PAGE = """<!doctype html>
<html><head><title>Open-Pandora TPU</title><style>
body{font-family:sans-serif;max-width:720px;margin:2em auto}
label{display:block;margin-top:.6em}input,textarea{width:100%%}
button{margin-top:1em;padding:.5em 2em}</style></head><body>
<h2>Open-Pandora TPU &mdash; interactive world model</h2>
<form method="post" action="/generate" enctype="multipart/form-data">
<label>Conditioning image <input type="file" name="image" required></label>
<label>Actions (one per round, up to 5 lines)
<textarea name="actions" rows="5" placeholder="the car moves forward"></textarea></label>
<label>DDIM steps <input type="number" name="ddim_steps" value="50"></label>
<label>Guidance scale <input type="number" step="0.1" name="ugs" value="4.0"></label>
<label>ETA <input type="number" step="0.1" name="eta" value="1.0"></label>
<label>FS <input type="number" name="fs" value="15"></label>
<label>Seed <input type="number" name="seed" value="123"></label>
<button type="submit">Generate</button></form>
<p>POST /generate returns the mp4; GET /health returns JSON.</p>
</body></html>"""


def _parse_multipart(handler: BaseHTTPRequestHandler) -> dict:
    """multipart/form-data fields of the request: {name: bytes}. A part's
    payload loses exactly the CRLF before the next boundary, so a binary
    upload keeps its own trailing bytes."""
    ctype = handler.headers.get("Content-Type", "")
    m = re.search(r"boundary=([^;]+)", ctype)
    if not m:
        raise ValueError("not multipart")
    boundary = m.group(1).strip('"').encode()
    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length)
    fields = {}
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        dm = re.search(rb'name="([^"]+)"', head)
        if dm:
            fields[dm.group(1).decode()] = payload
    return fields


class PandoraHandler(BaseHTTPRequestHandler):
    """`generate_fn(image_bytes, actions, **kw) -> bytes` is bound by
    make_server; an error becomes a JSON 500."""

    generate_fn: Optional[Callable] = None

    def do_GET(self):
        if self.path == "/health":
            self._send(200, b'{"status": "ok"}', "application/json")
        elif self.path in ("/", "/index.html"):
            self._send(200, PAGE.encode(), "text/html")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/generate":
            return self._send(404, b"not found", "text/plain")
        try:
            fields = _parse_multipart(self)
            image = fields["image"]
            actions = [a.strip() for a in
                       fields.get("actions", b"").decode().splitlines()
                       if a.strip()][:5] or ["move"]
            kw = {}
            for k, cast in (("ddim_steps", int), ("ugs", float),
                            ("eta", float), ("fs", int), ("seed", int)):
                if fields.get(k):
                    kw[k] = cast(fields[k].decode())
            out = type(self).generate_fn(image, actions, **kw)
            self._send(200, out, "video/mp4")
        except Exception as e:  # noqa: BLE001
            self._send(500, json.dumps({"error": str(e)}).encode(),
                       "application/json")

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        pass


def make_server(generate_fn: Callable, port: int = 10041,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """A threading HTTP server whose handler calls `generate_fn`; port 0
    takes a free port (`server_address[1]`)."""
    handler = type("BoundHandler", (PandoraHandler,),
                   {"generate_fn": staticmethod(generate_fn)})
    return ThreadingHTTPServer((host, port), handler)


def chatwm_generate_fn(chat, fps: int = 8) -> Callable:
    """The server's generate_fn for a ChatWM session: decode the upload,
    run one round per action, answer with the mp4's bytes; a lock serves
    one request at a time."""
    from open_pandora_tpu_torch.pipeline.cli import decode_image

    lock = threading.Lock()

    def generate(image_bytes: bytes, actions, *, ddim_steps: int = 50,
                 ugs: float = 4.0, eta: float = 1.0, fs: int = 15,
                 seed: int = 123) -> bytes:
        with lock:
            frames = chat.generate_video_multiround(
                decode_image(io.BytesIO(image_bytes)), list(actions),
                ddim_steps=ddim_steps, guidance_scale=ugs, eta=eta, fs=fs,
                seed=seed)
            with tempfile.TemporaryDirectory() as td:
                path = chat.save_video(os.path.join(td, "out.mp4"), frames,
                                       fps=fps)
                with open(path, "rb") as f:
                    return f.read()

    return generate


def main(argv=None):
    import argparse

    from open_pandora_tpu_torch.pipeline import cli

    p = argparse.ArgumentParser("open-pandora-torch-server")
    p.add_argument("--port", type=int, default=10041)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--quantize-llm", nargs="?", const="int8",
                   choices=["int8", "nf4"], default=False)
    p.add_argument("--debug", action="store_true",
                   help="tiny random-weight config (smoke mode)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    base = cli.build_parser().parse_args(["--image", "", "--action", "x"])
    for k in ("ckpt", "tokenizer", "quantize_llm", "debug", "device"):
        setattr(base, k, getattr(args, k))
    srv = make_server(chatwm_generate_fn(cli.build_chat(base)),
                      port=args.port)
    print(f"[server] listening on :{args.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
