"""HTTP inference server of the PyTorch port.

The contract of ``tools/serve.py:113-167``: ``POST /predict`` with a raw
float32 body of N x ``cols`` values (xyz, then features; ``?cols=`` and
``?method=argmax|weighted`` in the query) answers with raw float32: the
keypoints, K x 3 in the input's units, for ``offset_keypoint`` and for
``keypoint`` (the global-regression heads, ``KeypointPTv3`` and its
aliases, which take no ``method``); one label per input point, N, for
``pigseg`` (``inference/segment.py``).  Without feature columns the normals
and curvature are estimated.

Usage:
  python -m pointcept_keypointdetection_tpu_torch.serve --task offset_keypoint \
      --config-file configs/my_dataset/offset_keypoint_ptv3.py --port 8000 [--device cuda]
  python -m pointcept_keypointdetection_tpu_torch.serve --task keypoint \
      --config-file configs/my_dataset/keypoint_ptv3_plus.py --port 8000 [--device cuda]
  python -m pointcept_keypointdetection_tpu_torch.serve --task pigseg \
      --config-file configs/pigseg/semseg-ptv3-v1m1-0-base.py --slot-size 32768 [--device cuda]

``--weight`` takes a JAX checkpoint (flax msgpack, as ``tools/serve.py``
does, e.g. ``exp/kp_r3/model_params.ckpt`` with
``configs/synthetic/offset-keypoint-r3.py`` and ``--slot-size 4096``), a
checkpoint of the port's trainer (``model_*.pth``) or a bare ``state_dict``
saved with ``torch.save`` (``convert.load_weights`` tells them apart by
content).  Without it the weights are seeded (seed 0).
"""

from __future__ import annotations

import argparse
import inspect
import json
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np

from .convert import load_weights
from .inference.keypoint import KeypointPredictor, OffsetKeypointPredictor
from .inference.segment import SegmentPredictor
from .utils.config import Config

PREDICTORS = {"keypoint": KeypointPredictor, "offset_keypoint": OffsetKeypointPredictor, "pigseg": SegmentPredictor}
TASKS = tuple(PREDICTORS)
Predictor = Union[KeypointPredictor, OffsetKeypointPredictor, SegmentPredictor]


def build_predictor(task: str, cfg: Config, state_dict=None, slot_size: int = 8192,
                    device: str = "cuda") -> Predictor:
    if task not in PREDICTORS:
        raise ValueError(f"unknown task {task!r}")
    return PREDICTORS[task](dict(cfg.model), state_dict, slot_size, device)


def make_handler(predictor: Predictor, cols: int):
    takes_method = "method" in inspect.signature(predictor.predict).parameters

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
                options = {"method": method} if takes_method else {}
                result = predictor.predict(coord, feat, **options)
            except Exception as e:  # the server keeps serving; the client gets the error
                traceback.print_exc()
                self._reply(500, json.dumps({"error": str(e)}).encode(), "application/json")
                return
            self._reply(200, np.asarray(result, np.float32).tobytes(), "application/octet-stream")

        def log_message(self, fmt, *args):
            print("[serve]", fmt % args)

    return Handler


def make_server(predictor: Predictor, host: str = "0.0.0.0", port: int = 8000,
                cols: int = 7) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(predictor, cols))


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--task", required=True, choices=TASKS)
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None,
                        help="a JAX checkpoint (flax msgpack), a port trainer's checkpoint or a state_dict")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--cols", type=int, default=7)
    parser.add_argument("--slot-size", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config_file)
    state_dict = load_weights(args.weight) if args.weight else None
    predictor = build_predictor(args.task, cfg, state_dict, args.slot_size, args.device)
    server = make_server(predictor, args.host, args.port, args.cols)
    print(f"serving {args.task} on {args.host}:{args.port} (POST /predict, raw float32 Nx{args.cols})")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
