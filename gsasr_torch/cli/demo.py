"""Interactive SR demo (counterpart of `gsasr_tpu/cli/demo.py`, the
reference's Gradio `demo_gr.py`): a minimal local HTML form and a POST
endpoint with the same behaviour: upload an image, pick a scale, get the
SR result. Inputs larger than `--tile_threshold` are tiled like the
reference's auto-tiling above 1024 px (`demo_gr.py:117-339`). The model
runs on the CUDA card unless --device cpu is given. Images are PNG only
(`utils/png.py`: the card's machine has neither OpenCV nor PIL); a body
that is not a PNG gets 400.

Usage:
  python -m gsasr_torch.cli.demo --port 7860 \\
      [--enc_ckpt net_g.pth --dec_ckpt net_fea2gs.pth] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import math
from http.server import BaseHTTPRequestHandler, HTTPServer


def parse_multipart(content_type: str, body: bytes) -> dict:
    """Minimal multipart/form-data parser (the stdlib `cgi` module is
    deprecated/removed in new Pythons). Returns {field_name: bytes}."""
    fields = {}
    if "boundary=" not in content_type:
        return fields
    boundary = content_type.split("boundary=")[1].split(";")[0].strip()
    # RFC 2046 allows (and sometimes requires) a quoted boundary parameter
    boundary = boundary.strip('"')
    sep = ("--" + boundary).encode()
    for part in body.split(sep):
        if b"\r\n\r\n" not in part:
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        # the payload is terminated by exactly one CRLF before the next
        # boundary marker; rstrip would eat legitimate trailing image bytes
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        name = None
        for line in head.split(b"\r\n"):
            if not line.lower().startswith(b"content-disposition"):
                continue
            for param in line.split(b";"):
                key, _, val = param.strip().partition(b"=")
                # exact parameter match: 'filename=' also contains 'name='
                if key.strip().lower() == b"name":
                    name = val.strip().strip(b'"')
        if name:
            fields[name.decode()] = payload
    return fields


_FORM = b"""<!doctype html><title>GSASR demo</title>
<h2>GSASR: arbitrary-scale super-resolution</h2>
<form method=post enctype=multipart/form-data action=/sr>
  <p>Image (PNG): <input type=file name=image accept=image/png></p>
  <p>Scale: <input type=number step=0.1 min=1 max=16 value=4 name=scale></p>
  <p><input type=submit value=Upscale></p>
</form>"""


def build_server(argv=None) -> HTTPServer:
    """Parse `argv` (default: the command line), build the models on the
    device and return the server bound to 127.0.0.1:--port (0 takes a free
    port: `server.server_address[1]`), not yet serving."""
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--model", default="EDSR", choices=["EDSR"])
    p.add_argument("--enc_ckpt", default=None)
    p.add_argument("--dec_ckpt", default=None)
    p.add_argument("--dmax", type=float, default=0.1)
    p.add_argument("--tile_threshold", type=int, default=1024)
    p.add_argument("--tile_size", type=int, default=480)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from gsasr_torch.model import DENOMINATORS, make_models, sr_forward
    from gsasr_torch.tiling import split_and_joint_image
    from gsasr_torch.utils.checkpoint import load_torch_checkpoint
    from gsasr_torch.utils.convert import load_params
    from gsasr_torch.utils.png import decode_png, encode_png

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available; pass --device cpu to "
                         "run the plain PyTorch path")
    if (args.enc_ckpt is None) != (args.dec_ckpt is None):
        raise SystemExit("give both --enc_ckpt and --dec_ckpt, or neither")
    enc, dec = make_models(args.model.lower(), device=dev)
    denom = DENOMINATORS[args.model.lower()]
    if args.enc_ckpt:
        load_params(enc, load_torch_checkpoint(args.enc_ckpt, "edsr"))
        load_params(dec, load_torch_checkpoint(args.dec_ckpt, "fea2gs"))
    else:
        print("WARNING: no checkpoint given; seeded init (smoke mode)")

    def run_sr(rgb, scale):
        lq = rgb.astype(np.float32)[None] / 255.0
        h, w = lq.shape[1:3]
        want = (math.floor(h * scale), math.floor(w * scale))
        if max(h, w) > args.tile_threshold:
            canvas = split_and_joint_image(
                lq, scale, args.tile_size, 8, enc, dec, crop_size=4,
                if_dmax=True, dmax=args.dmax, device=dev)
            sr = canvas[0, :want[0], :want[1]]
        else:
            sr = sr_forward(enc, dec, lq, scale, denominator=denom,
                            dmax=args.dmax, device=dev).cpu().numpy()[0]
        return (np.clip(sr, 0, 1) * 255).round().astype(np.uint8)

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(_FORM)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            fields = parse_multipart(self.headers.get("Content-Type", ""),
                                     body)
            data = fields.get("image", b"")
            scale = float(fields.get("scale", b"4").decode() or "4")
            try:
                img = decode_png(data)
            except ValueError:
                self.send_error(400, "could not decode image (PNG only)")
                return
            png = encode_png(run_sr(img, scale))
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

        def log_message(self, *a):
            pass

    return HTTPServer(("127.0.0.1", args.port), Handler)


def main(argv=None):
    server = build_server(argv)
    print(f"demo listening on http://127.0.0.1:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
