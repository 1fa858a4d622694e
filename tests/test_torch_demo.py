"""The port's demo server (`gsasr_torch.cli.demo`) on the CPU, served from a
thread: the form, a PNG at x2 answered with the PNG of `sr_forward`'s
result bit for bit (the seeded full-width paper EDSR + Fea2GS of the smoke
mode), a body that is not a PNG refused with 400; and its multipart
parser on tests/test_demo.py's binary-safety cases."""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gsasr_torch.cli.demo import build_server, parse_multipart


def test_parse_multipart_binary_safety():
    # payload ending in CRLF-ish bytes must survive exactly
    payload = b"\x89PNG\r\n\x1a\n-data-\r\n-"
    boundary = "XBOUND"
    body = (b"--XBOUND\r\n"
            b'Content-Disposition: form-data; name="image"; '
            b'filename="a.png"\r\n'
            b"Content-Type: image/png\r\n\r\n" + payload + b"\r\n"
            b"--XBOUND\r\n"
            b'Content-Disposition: form-data; name="scale"\r\n\r\n'
            b"3.5\r\n"
            b"--XBOUND--\r\n")
    fields = parse_multipart(f"multipart/form-data; boundary={boundary}",
                             body)
    assert fields["image"] == payload
    assert fields["scale"] == b"3.5"
    # RFC 2046 quoted boundary parameter must parse identically
    fields_q = parse_multipart(
        f'multipart/form-data; boundary="{boundary}"', body)
    assert fields_q == fields
    # RFC 7578 does not constrain parameter order: filename before name
    body2 = (b"--XBOUND\r\n"
             b'Content-Disposition: form-data; filename="a.png"; '
             b'name="image"\r\n'
             b"Content-Type: image/png\r\n\r\n" + payload + b"\r\n"
             b"--XBOUND--\r\n")
    fields2 = parse_multipart("multipart/form-data; boundary=XBOUND", body2)
    assert fields2["image"] == payload
    assert parse_multipart("text/plain", body) == {}


def _post(port, image: bytes, scale: bytes):
    boundary = "XTESTBOUND"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="image"; filename="in.png"\r\n'
            f"Content-Type: image/png\r\n\r\n").encode() + image + (
        f"\r\n--{boundary}\r\nContent-Disposition: form-data; "
        f'name="scale"\r\n\r\n').encode() + scale + (
        f"\r\n--{boundary}--\r\n").encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sr", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, e.read()


def test_demo_serves_sr_forward_on_the_cpu(monkeypatch):
    """build_server on port 0, serving from a thread: GET / is the form; a
    12x12 PNG at x2 comes back as the PNG of sr_forward's 24x24 result on
    the same seeded weights, bit for bit; a GIF body gets 400."""
    from gsasr_torch.model import make_models, sr_forward
    from gsasr_torch.utils.png import encode_png

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    server = build_server(["--port", "0", "--device", "cpu"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as r:
            assert b"<form" in r.read()
        img = (np.random.default_rng(0).random((12, 12, 3)) * 255).astype(
            np.uint8)
        status, ctype, png = _post(port, encode_png(img), b"2")
        enc, dec = make_models("edsr", device="cpu")
        sr = sr_forward(enc, dec, img.astype(np.float32)[None] / 255.0, 2.0,
                        device="cpu").numpy()[0]
        want = encode_png((np.clip(sr, 0, 1) * 255).round().astype(np.uint8))
        assert (status, ctype) == (200, "image/png")
        assert png == want
        status, _, _ = _post(port, b"GIF89a\x01\x00", b"2")
        assert status == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        torch.set_num_threads(n)
    assert not thread.is_alive()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        build_server(["--port", "0"])
