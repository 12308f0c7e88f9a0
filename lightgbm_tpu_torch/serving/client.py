# Copied from lightgbm_tpu/serving/client.py; its code kept in step with it (docstrings
# and comments aside) by tests/test_torch_obs_serving.py.
"""Minimal stdlib HTTP client for the serving endpoint.

Usage:
    from lightgbm_tpu_torch.serving import ServingClient
    c = ServingClient(port=9109)
    scores = c.predict([[5.1, 3.5, 1.4, 0.2]])
    print(c.stats()["models"]["default"]["latency_ms"]["p99"])
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Dict, List, Optional

import numpy as np


class ServingError(Exception):
    """Non-2xx reply from the server; carries the HTTP status code."""

    def __init__(self, status: int, message: str):
        super().__init__("HTTP %d: %s" % (status, message))
        self.status = status


class ServingClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 9109,
                 timeout: float = 30.0):
        self.base = "http://%s:%d" % (host, port)
        self.timeout = timeout

    def _call(self, path: str, payload: Optional[Dict] = None) -> Dict:
        url = self.base + path
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/json"} if data else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read().decode()).get("error", str(e))
            except Exception:  # noqa: BLE001 — error body is best-effort
                message = str(e)
            raise ServingError(e.code, message) from None

    # -- API ------------------------------------------------------------ #
    def predict(self, rows, model: Optional[str] = None,
                timeout_ms: Optional[float] = None) -> np.ndarray:
        payload: Dict = {"rows": np.asarray(rows, np.float64).tolist()}
        if model is not None:
            payload["model"] = model
        if timeout_ms is not None:
            payload["timeout_ms"] = timeout_ms
        return np.asarray(self._call("/predict", payload)["predictions"])

    def stats(self) -> Dict:
        return self._call("/stats")

    def models(self) -> Dict:
        return self._call("/models")["models"]

    def health(self) -> Dict:
        return self._call("/healthz")

    def load_model(self, name: str, model_file: Optional[str] = None,
                   model_str: Optional[str] = None) -> int:
        """Load or hot-swap a model; returns the new version."""
        payload: Dict = {"name": name}
        if model_file is not None:
            payload["model_file"] = model_file
        if model_str is not None:
            payload["model_str"] = model_str
        return int(self._call("/models/load", payload)["version"])

    def evict_model(self, name: str) -> None:
        self._call("/models/evict", {"name": name})
