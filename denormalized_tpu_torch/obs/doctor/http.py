"""HTTP routing for the doctor — mounted on the Prometheus server.

The stdlib server (``EngineConfig(prometheus_port=...)``) serves, next
to ``/metrics``:

- ``GET /healthz`` — liveness: always 200 while the server is up, with
  running/retained query counts;
- ``GET /queries`` — every registered query (running + the retained
  finished ring);
- ``GET /queries/<id>/plan`` — the full live plan snapshot: per-node
  rows/s, batch-time share, queue depth, watermark lag, plus the ranked
  bottleneck attribution;
- ``GET /queries/<id>/state`` — the state observatory: per-stateful-node
  exact accounting (live bytes/keys, slot occupancy, oldest-retained
  lag), sketch-derived hot keys + skew factor, growth forecasts with
  time-to-budget, and ranked health verdicts;
- ``GET /queries/<id>/lineage[?window_start_ms=&source=]`` — sampled
  record lineage chains (ingest offset → operator hops → emission);
- ``GET|POST /queries/<id>/profile/start[?hz=]`` / ``.../profile/stop``
  — the on-demand sampling profiler; ``GET /queries/<id>/profile``
  returns the folded stacks as text/plain.

Contract: :func:`route` is TOTAL — it never raises.  A scrape racing
operator teardown gets a degraded JSON body, never a 5xx or a hung
socket (pinned by the concurrent-teardown test riding the lock witness).
"""

from __future__ import annotations

import json
from urllib.parse import parse_qs, urlsplit

from denormalized_tpu_torch.obs.doctor import registry as _reg

_JSON = "application/json; charset=utf-8"
_TEXT = "text/plain; charset=utf-8"


def _json_resp(status: int, obj) -> tuple[int, str, bytes]:
    return status, _JSON, json.dumps(obj, default=str).encode()


def healthz() -> tuple[int, str, bytes]:
    running, retained = _reg.counts()
    return _json_resp(200, {
        "status": "ok",
        "queries_running": running,
        "queries_retained": retained,
    })


def _query_row(h) -> dict:
    return {
        "query_id": h.query_id,
        "state": "running" if h.running else "finished",
        "started_unix": h.started_unix,
        "wall_s": round(h.wall_s(), 3),
        "lineage": h.lineage is not None,
        "profiler_running": bool(h.profiler and h.profiler.running),
    }


def route(path: str, method: str = "GET") -> tuple[int, str, bytes] | None:
    """(status, content_type, body) for doctor paths; None when the path
    is not ours (the caller then 404s).  Never raises."""
    try:
        return _route(path, method)
    except Exception as e:  # dnzlint: allow(broad-except) the introspection surface must degrade to an error payload when a snapshot races operator teardown — never a 5xx, never a closed socket mid-scrape
        return _json_resp(200, {"error": f"{type(e).__name__}: {e}"})


def _route(path: str, method: str) -> tuple[int, str, bytes] | None:
    split = urlsplit(path)
    parts = [p for p in split.path.split("/") if p]
    params = parse_qs(split.query)
    if parts == ["healthz"]:
        return healthz()
    if not parts or parts[0] != "queries":
        return None
    if len(parts) == 1:
        return _json_resp(200, {
            "queries": [_query_row(h) for h in _reg.queries()],
        })
    handle = _reg.get_query(parts[1])
    if handle is None:
        return _json_resp(404, {
            "error": f"unknown query {parts[1]!r}",
            "known": [h.query_id for h in _reg.queries()],
        })
    tail = parts[2:]
    if tail == ["plan"] or tail == []:
        return _json_resp(200, handle.snapshot())
    if tail == ["state"]:
        return _json_resp(200, handle.state_snapshot())
    if tail == ["lineage"]:
        if handle.lineage is None:
            return _json_resp(200, {
                "error": "lineage sampling is off for this query — set "
                "EngineConfig(lineage_sample_every=N)",
                "chains": [],
            })
        ws = params.get("window_start_ms", [None])[0]
        src = params.get("source", [None])[0]
        chains = handle.lineage.chains(
            window_start_ms=int(ws) if ws is not None else None,
            source=src,
            # a shared pipeline's tracker serves every member query —
            # filter the view to THIS handle's tagged emissions
            query=handle.query_id if handle.shared is not None else None,
        )
        return _json_resp(200, {
            "sampled_total": handle.lineage.sampled_total,
            "sample_every": handle.lineage.sample_every,
            "chains": chains,
        })
    if tail == ["profile", "start"]:
        hz = params.get("hz", [None])[0]
        # the authoritative finished check happens inside start_profiler
        # under its lock (a bare handle.running pre-check here would
        # race finish() and leak a sampler)
        prof = handle.start_profiler(float(hz) if hz else None)
        if prof is None:
            return _json_resp(404, {"error": "query already finished"})
        return _json_resp(200, {
            "profiling": True, "interval_s": prof.interval_s,
        })
    if tail == ["profile", "stop"]:
        n = handle.stop_profiler()
        return _json_resp(200, {"profiling": False, "samples": n})
    if tail == ["profile"]:
        if handle.profiler is None:
            return _json_resp(200, {
                "error": "profiler never started for this query",
            })
        return 200, _TEXT, handle.profiler.folded().encode()
    return _json_resp(404, {"error": f"unknown doctor path {path!r}"})
