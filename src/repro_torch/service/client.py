"""Stdlib client for the semantic query service.

``http.client`` only — the client mirrors the server's no-new-deps
constraint so tests and the CI smoke job can drive a real socket
round-trip anywhere Python runs.  ``query()`` POSTs a plan spec and
parses the NDJSON event stream; on a 429 it honours the server's
``Retry-After`` hint (bounded exponential backoff on top, so a
mis-behaving server cannot park the client forever) and retries within
``max_retries``.

The module is the reference's ``repro/service/client.py`` line for line
(it imports only the standard library).
"""
from __future__ import annotations

import http.client
import json
import time
from typing import Any, Dict, Iterator, List, Optional


class ShedError(RuntimeError):
    """Raised when the retry budget is exhausted on 429s."""

    def __init__(self, verdict: Dict[str, Any]):
        super().__init__(f"query shed after retries: {verdict}")
        self.verdict = verdict


class QueryError(RuntimeError):
    """Terminal server-side query failure (the stream's error event)."""


class ServiceClient:
    def __init__(self, host: str, port: int, *, timeout: float = 120.0,
                 max_retries: int = 5, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s

    def _conn(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _get_json(self, path: str) -> Dict[str, Any]:
        c = self._conn()
        try:
            c.request("GET", path)
            r = c.getresponse()
            return json.loads(r.read())
        finally:
            c.close()

    def _post_json(self, path: str, body: Dict[str, Any]):
        c = self._conn()
        try:
            c.request("POST", path, body=json.dumps(body),
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            return r.status, json.loads(r.read())
        finally:
            c.close()

    # -- queries --------------------------------------------------------
    def iter_query(self, tenant: str,
                   spec: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        """POST the spec and yield the event stream; retries 429s with
        Retry-After-honouring bounded backoff before giving up."""
        verdict: Optional[Dict[str, Any]] = None
        for attempt in range(self.max_retries + 1):
            c = self._conn()
            try:
                c.request("POST", "/query",
                          body=json.dumps({"tenant": tenant,
                                           "spec": spec}),
                          headers={"Content-Type": "application/json"})
                r = c.getresponse()
                if r.status == 429:
                    verdict = json.loads(r.read())
                    c.close()
                    if attempt == self.max_retries:
                        break
                    hint = float(r.headers.get(
                        "Retry-After",
                        verdict.get("retry_after_s", self.backoff_s)))
                    wait = min(self.max_backoff_s,
                               max(hint, self.backoff_s * 2 ** attempt))
                    time.sleep(wait)
                    continue
                if r.status != 200:
                    err = json.loads(r.read())
                    c.close()
                    raise QueryError(f"HTTP {r.status}: {err}")
                for line in r:
                    line = line.strip()
                    if line:
                        yield json.loads(line)
                return
            finally:
                c.close()
        raise ShedError(verdict or {"reason": "unknown"})

    def query(self, tenant: str,
              spec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """The collected result rows, in index order; raises
        ``QueryError`` on a server-side failure event."""
        rows: List[Dict[str, Any]] = []
        for ev in self.iter_query(tenant, spec):
            if ev.get("event") == "row":
                rows.append(ev["row"])
            elif ev.get("event") == "error":
                raise QueryError(f"{ev.get('kind')}: {ev.get('error')}")
        return rows

    # -- control plane --------------------------------------------------
    def healthz(self) -> Dict[str, Any]:
        return self._get_json("/healthz")

    def stats(self) -> Dict[str, Any]:
        return self._get_json("/stats")

    def stats_text(self) -> str:
        c = self._conn()
        try:
            c.request("GET", "/stats?format=text")
            return c.getresponse().read().decode()
        finally:
            c.close()

    def checkpoint(self, ckpt_dir: str) -> Dict[str, Any]:
        status, body = self._post_json("/checkpoint", {"dir": ckpt_dir})
        if status != 200:
            raise QueryError(f"checkpoint failed: HTTP {status} {body}")
        return body

    def shutdown(self) -> None:
        status, _ = self._post_json("/shutdown", {})
        if status != 200:
            raise QueryError(f"shutdown refused: HTTP {status}")
