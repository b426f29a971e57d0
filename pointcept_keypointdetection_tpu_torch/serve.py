"""HTTP inference server of the PyTorch port.

The contract of ``tools/serve.py:113-167``: ``POST /predict`` with a raw
float32 body of N x ``cols`` values (xyz, then features; ``?cols=`` and
``?method=argmax|weighted`` in the query) answers with the keypoints as raw
float32, K x 3.  Only the ``offset_keypoint`` task is ported; ``keypoint``
and ``pigseg`` raise NotImplementedError.

Usage:
  python -m pointcept_keypointdetection_tpu_torch.serve --task offset_keypoint \
      --config-file configs/my_dataset/offset_keypoint_ptv3.py --port 8000 [--device cuda]

Without ``--weight`` (a ``state_dict`` saved with ``torch.save``, e.g. from
``convert.py``) the weights are seeded (seed 0): the full-width config has no
trained checkpoint.
"""

from __future__ import annotations

import argparse
import json
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .inference.keypoint import OffsetKeypointPredictor
from .utils.config import Config

TASKS = ("keypoint", "offset_keypoint", "pigseg")


def build_predictor(task: str, cfg: Config, state_dict=None, slot_size: int = 8192,
                    device: str = "cuda") -> OffsetKeypointPredictor:
    if task == "offset_keypoint":
        return OffsetKeypointPredictor(dict(cfg.model), state_dict, slot_size, device)
    if task in TASKS:
        raise NotImplementedError(f"task {task!r} is not ported to PyTorch yet")
    raise ValueError(f"unknown task {task!r}")


def make_handler(predictor: OffsetKeypointPredictor, cols: int):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/predict":
                self.send_error(404)
                return
            params = parse_qs(parsed.query)
            ncols = int(params.get("cols", [cols])[0])
            method = params.get("method", ["argmax"])[0]
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if ncols < 3 or len(body) % (4 * ncols):
                self._reply(400, json.dumps({"error": f"body is not float32 N x {ncols}"}).encode(),
                            "application/json")
                return
            raw = np.frombuffer(body, np.float32).reshape(-1, ncols)
            coord = raw[:, :3].copy()
            feat = raw[:, 3:].copy() if ncols > 3 else None
            try:
                result = predictor.predict(coord, feat, method=method)
            except Exception as e:  # the server keeps serving; the client gets the error
                traceback.print_exc()
                self._reply(500, json.dumps({"error": str(e)}).encode(), "application/json")
                return
            self._reply(200, np.asarray(result, np.float32).tobytes(), "application/octet-stream")

        def log_message(self, fmt, *args):
            print("[serve]", fmt % args)

    return Handler


def make_server(predictor: OffsetKeypointPredictor, host: str = "0.0.0.0", port: int = 8000,
                cols: int = 7) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(predictor, cols))


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--task", required=True, choices=TASKS)
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None, help="a state_dict saved with torch.save")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--cols", type=int, default=7)
    parser.add_argument("--slot-size", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config_file)
    state_dict = torch.load(args.weight, map_location="cpu", weights_only=True) if args.weight else None
    predictor = build_predictor(args.task, cfg, state_dict, args.slot_size, args.device)
    server = make_server(predictor, args.host, args.port, args.cols)
    print(f"serving {args.task} on {args.host}:{args.port} (POST /predict, raw float32 Nx{args.cols})")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
