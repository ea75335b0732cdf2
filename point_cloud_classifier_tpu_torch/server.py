"""The HTTP scoring endpoint: a finished run served over HTTP, raw showers in,
per-event probabilities out.

Counterpart of ``point_cloud_classifier_tpu/server.py``::

    python -m point_cloud_classifier_tpu_torch serve log/version_0 --port 8000 [--quant int8|auto]

    POST /predict   body = a raw shower HDF5 file's bytes → {"predictions": [...]}
    GET  /health    → {"status": "ok", "model": ..., "dataset": ..., "quant": ...}

- One warm model a process (``factory.get_model`` from the run directory),
  on the card unless ``device`` names another; requests are scored under a
  lock, since one card runs one step at a time.
- The request's bytes go straight to the run's preprocessing
  (``data/inference.inference_loader``, read by ``data/h5lite``: no
  temporary file), with the scalers of dataset creation.
- ``/health`` reports the quantization that actually runs (a layer-norm
  DeepSets asked for int8 stays float).
- Status codes as in the JAX server: 404 for another path, 400 for a bad
  ``Content-Length`` or a body the reader or the preprocessing refuses
  (``ValueError``, ``KeyError``, ``OSError``), 408 for a body that stalls
  past the 60 s socket timeout, 500 for a missing scaler
  (``FileNotFoundError``) or any other fault of the server.
- stdlib ``http.server`` only, a thread a connection, so a health check
  never waits behind a scoring request.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from point_cloud_classifier_tpu_torch.data.inference import inference_loader
from point_cloud_classifier_tpu_torch.factory import apply_quant, get_model, resolve_quant
from point_cloud_classifier_tpu_torch.utils.config import load_config

MAX_BODY = 1 << 30  # refuse absurd uploads before buffering them


class Scorer:
    """A run directory loaded once; raw shower files scored thread-safely."""

    def __init__(self, model_dir: str, quant: str = "none", device: str = None):
        self.config = load_config(os.path.join(model_dir, "config.yaml"))
        self.model_name = self.config["meta"]["model_name"]
        self.dataset_name = self.config["meta"]["dataset_name"]
        # the resolved path ("auto" → int8 or none), so /health never says "auto"
        self.quant = resolve_quant(self.config, self.model_name, quant)
        apply_quant(self.config, self.model_name, self.quant)
        self.model = get_model(self.model_name, self.config, model_dir=model_dir, device=device)
        self._lock = threading.Lock()

    def quant_active(self) -> str:
        """The quantization the eval step runs: ``int8`` asked of a
        layer-norm DeepSets falls back to float inside the model."""
        net = getattr(self.model, "model", None)
        if self.quant != "none" and hasattr(net, "_int8"):
            return self.quant if net._int8(train=False) else "none"
        return self.quant

    def score_bytes(self, data: bytes) -> list:
        """A raw shower file's bytes → ``[{event_id, probability, prediction}]``."""
        loader, event_ids = inference_loader(self.dataset_name, self.config, bytes(data))
        with self._lock:
            _, probs = self.model.predict(loader, return_prob=True)
        probs = np.asarray(probs).reshape(-1)
        return [
            {"event_id": int(ev), "probability": float(p), "prediction": int(p >= 0.5)}
            for ev, p in zip(event_ids, probs)
        ]


class _Handler(BaseHTTPRequestHandler):
    scorer: Scorer = None  # set by make_server
    quiet = True
    # a client that sends fewer bytes than its Content-Length would otherwise
    # park its thread in rfile.read() for good
    timeout = 60

    def _json(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server's names)
        if self.path == "/health":
            self._json(200, {
                "status": "ok",
                "model": self.scorer.model_name,
                "dataset": self.scorer.dataset_name,
                "quant": self.scorer.quant_active(),
            })
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        if self.path != "/predict":
            self._json(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            self._json(400, {"error": "bad Content-Length header"})
            return
        if not 0 < length <= MAX_BODY:
            self._json(400, {"error": f"bad Content-Length {length}"})
            return
        try:
            data = self.rfile.read(length)
        except OSError as exc:  # the client stalled past the socket timeout
            self._json(408, {"error": f"body read failed: {exc}"})
            return
        try:
            predictions = self.scorer.score_bytes(data)
        except FileNotFoundError as exc:
            # the run's scaler missing on the serving host: the server's fault
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        except (ValueError, KeyError, OSError) as exc:
            # a body the reader or the preprocessing refuses: the client's
            self._json(400, {"error": f"{type(exc).__name__}: {exc}"})
            return
        except Exception as exc:
            # anything else is the server's: a 400 would make clients retry
            # a fault of the server and send monitoring after them
            self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._json(200, {"predictions": predictions})

    def log_message(self, fmt, *args):
        if not self.quiet:
            super().log_message(fmt, *args)


def make_server(
    model_dir: str, host: str = "127.0.0.1", port: int = 8000, quant: str = "none",
    quiet: bool = True, device: str = None,
) -> ThreadingHTTPServer:
    """The scoring server, built but not started (``.server_address`` has the
    bound port; ``port=0`` takes a free one)."""
    scorer = Scorer(model_dir, quant=quant, device=device)
    handler = type("Handler", (_Handler,), {"scorer": scorer, "quiet": quiet})
    return ThreadingHTTPServer((host, port), handler)


def serve(model_dir: str, host: str = "127.0.0.1", port: int = 8000, quant: str = "none",
          device: str = None) -> None:
    server = make_server(model_dir, host, port, quant=quant, quiet=False, device=device)
    print(f"Serving {model_dir} on http://{host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
