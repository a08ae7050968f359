"""Client for the resident job service: the small Python API plus the
``python -m map_oxidize_tpu_torch submit`` plumbing.  A copy of the JAX
package's ``serve/client.py`` (``ServeClient`` :30, ``coerce_overrides``
:108).

Stdlib-only (urllib), mirroring the endpoint schemas in
:mod:`map_oxidize_tpu_torch.obs.serve`.  Input/output paths are SERVER-local:
the service is a co-located resident process (same host or shared
filesystem), not a byte-upload gateway.

    from map_oxidize_tpu_torch.serve.client import ServeClient

    c = ServeClient("http://127.0.0.1:8321")
    job = c.submit("wordcount", "/data/corpus.txt",
                   config={"batch_size": 1 << 18})
    done = c.wait(job["id"])
    print(done["state"], done.get("records_in"))
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request


class ServeError(RuntimeError):
    """A request the server refused (HTTP 4xx/5xx), with its reason."""


class ServeClient:
    """Thin HTTP client over the resident server's job endpoints."""

    def __init__(self, url: str, timeout_s: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    # --- transport --------------------------------------------------------

    def _request(self, path: str, body: dict | None = None) -> dict:
        req = urllib.request.Request(
            self.url + path,
            data=(json.dumps(body).encode() if body is not None else None),
            headers={"Content-Type": "application/json"}
            if body is not None else {},
            method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                reason = json.loads(e.read()).get("error", str(e))
            except Exception:
                reason = str(e)
            raise ServeError(f"{path}: {reason}") from e

    # --- job API ----------------------------------------------------------

    def submit(self, workload: str, input_path: str,
               config: dict | None = None, output: str = "",
               deadline_s: float | None = None,
               est_hbm_bytes: int = 0) -> dict:
        """Submit one job; returns its record (check ``state`` — a
        world-state refusal comes back as ``rejected`` with the named
        ``reason``, a malformed request raises :class:`ServeError`)."""
        body: dict = {"workload": workload, "input": input_path}
        if config:
            body["config"] = config
        if output:
            body["output"] = output
        if deadline_s is not None:
            body["deadline_s"] = deadline_s
        if est_hbm_bytes:
            body["est_hbm_bytes"] = est_hbm_bytes
        return self._request("/jobs", body)

    def jobs(self) -> dict:
        return self._request("/jobs")

    def job(self, job_id: str) -> dict:
        return self._request(f"/jobs/{job_id}")

    def cancel(self, job_id: str,
               reason: str = "cancelled_by_client") -> dict:
        return self._request(f"/jobs/{job_id}/cancel", {"reason": reason})

    def shutdown(self, drain: bool = True) -> dict:
        return self._request("/shutdown", {"drain": drain})

    def status(self) -> dict:
        return self._request("/status")

    def wait(self, job_id: str, timeout_s: float | None = None,
             poll_s: float = 0.1) -> dict:
        """Poll until the job reaches a terminal state; returns its final
        record."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while True:
            doc = self.job(job_id)
            if doc["state"] in ("done", "failed", "cancelled", "rejected"):
                return doc
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{job_id} still {doc['state']} after {timeout_s}s")
            time.sleep(poll_s)


def coerce_overrides(pairs: list[str]) -> dict:
    """``--set key=value`` strings -> typed JobConfig overrides, coerced
    by the field's declared type (int/float/bool/str)."""
    import dataclasses

    from map_oxidize_tpu_torch.config import JobConfig

    types = {f.name: f.type for f in dataclasses.fields(JobConfig)}
    out: dict = {}
    for pair in pairs:
        key, sep, raw = pair.partition("=")
        if not sep:
            raise ValueError(f"--set takes key=value, got {pair!r}")
        t = str(types.get(key, "str"))
        if key == "dispatch_batch" and raw == "auto":
            # same spelling as the job CLI's --dispatch-batch {auto,N}:
            # 'auto' is the 0 sentinel (measured auto-pick at job start)
            out[key] = 0
        elif t.startswith("int"):
            out[key] = int(raw, 0)
        elif t.startswith("float"):
            out[key] = float(raw)
        elif t.startswith("bool"):
            out[key] = raw.lower() in ("1", "true", "yes", "on")
        else:
            out[key] = raw
    return out
