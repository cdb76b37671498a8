"""Read-side helpers for the JSONL telemetry stream — dependency-free; the
port's own copy of ``denormalized_tpu/obs/readers.py``.

This module imports NOTHING from the engine (stdlib only), so a consumer
can load it standalone by file path::

    spec = importlib.util.spec_from_file_location("obs_readers", path)

In-process consumers import the same names via
:mod:`denormalized_tpu_torch.obs.jsonl`, which re-exports them; the histogram
quantile estimator here is also the one the live registry uses
(:mod:`~denormalized_tpu_torch.obs.registry` imports it), so writer and
reader can never disagree about interpolation.
"""

from __future__ import annotations

import json


def quantile_from_buckets(
    bounds, counts, total, q, *, vmin=None, vmax=None
) -> float | None:
    """Interpolated q-quantile (0..1) from exponential bucket counts,
    clamped by the exact observed min/max when known; None when empty."""
    if not total:
        return None
    rank = q * total
    acc = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        lo = bounds[i - 1] if i > 0 else (
            vmin if vmin is not None else 0.0
        )
        hi = bounds[i] if i < len(bounds) else (
            vmax if vmax is not None else bounds[-1]
        )
        # tighten the interpolation edges by the exact observed range:
        # when all mass lands in one bucket (e.g. a replay offset pushing
        # everything past the top bound) this degrades gracefully to a
        # linear min→max estimate instead of saturating at a bucket edge
        if vmin is not None and vmin > lo:
            lo = min(vmin, hi)
        if vmax is not None and vmax < hi:
            hi = max(vmax, lo)
        if acc + c >= rank:
            frac = (rank - acc) / c
            est = lo + (hi - lo) * max(0.0, min(1.0, frac))
            if vmax is not None:
                est = min(est, vmax)
            if vmin is not None:
                est = max(est, vmin)
            return est
        acc += c
    return vmax


def read_stream(path) -> list[dict]:
    """All obs snapshots of one JSONL file, oldest first; torn tail
    lines (SIGKILL mid-write) are skipped."""
    out = []
    try:
        f = open(path)
    except FileNotFoundError:
        return out
    with f:
        for line in f:
            try:
                o = json.loads(line)
            except json.JSONDecodeError:
                continue
            if o.get("event") == "obs":
                out.append(o)
    return out


def last_stats(snapshots: list[dict], series: str):
    """The final value/stats of one series across a snapshot stream."""
    for snap in reversed(snapshots):
        v = snap.get("metrics", {}).get(series)
        if v is not None:
            return v
    return None


def merge_histogram(stats_list: list[dict]) -> dict | None:
    """Merge several processes' final histogram stats (same bucket
    layout) into one: counts/sums add, min/max combine, percentiles
    re-derived over the merged buckets."""
    stats_list = [s for s in stats_list if s and s.get("count")]
    if not stats_list:
        return None
    bounds = stats_list[0]["bounds"]
    counts = [0] * (len(bounds) + 1)
    total, total_sum = 0, 0.0
    vmin, vmax = None, None
    for s in stats_list:
        if s["bounds"] != bounds:
            continue  # layout changed between runs: skip, never mis-merge
        for i, c in enumerate(s["bucket_counts"]):
            counts[i] += c
        total += s["count"]
        total_sum += s["sum"]
        if s["min"] is not None and (vmin is None or s["min"] < vmin):
            vmin = s["min"]
        if s["max"] is not None and (vmax is None or s["max"] > vmax):
            vmax = s["max"]
    if not total:
        return None
    q = lambda p: quantile_from_buckets(  # noqa: E731
        bounds, counts, total, p, vmin=vmin, vmax=vmax
    )
    return {
        "count": total,
        "sum": total_sum,
        "min": vmin,
        "max": vmax,
        "p50": q(0.50),
        "p95": q(0.95),
        "p99": q(0.99),
    }


def linear_forecast(points, budget=None) -> dict | None:
    """Least-squares growth fit over ``[(unix_t, value), ...]`` points —
    the state observatory's time-to-budget projection (stdlib-only so
    the jax-free soak parent can run the same fit over a JSONL snapshot
    history that the live doctor runs over its in-memory ring).

    Returns ``None`` below two distinct-time points; otherwise a dict of
    ``slope_bytes_per_s``, ``current_bytes`` (last observed),
    ``window_s`` (ring span), ``r2`` (fit quality, 0..1), ``samples``,
    and — when ``budget`` is given — ``budget_bytes`` plus
    ``time_to_budget_s``: 0 when already at/over budget, a finite
    projection when growing, ``None`` when flat or shrinking (never
    reaches it on trend)."""
    pts = [(float(t), float(v)) for t, v in points]
    n = len(pts)
    if n < 2 or pts[-1][0] == pts[0][0]:
        return None
    t0 = pts[0][0]
    xs = [t - t0 for t, _v in pts]
    ys = [v for _t, v in pts]
    sx = sum(xs)
    sy = sum(ys)
    sxx = sum(x * x for x in xs)
    sxy = sum(x * y for x, y in zip(xs, ys))
    denom = n * sxx - sx * sx
    if denom == 0:
        return None
    slope = (n * sxy - sx * sy) / denom
    intercept = (sy - slope * sx) / n
    mean = sy / n
    ss_tot = sum((y - mean) ** 2 for y in ys)
    ss_res = sum((y - (intercept + slope * x)) ** 2 for x, y in zip(xs, ys))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    out = {
        "slope_bytes_per_s": round(slope, 3),
        "current_bytes": ys[-1],
        "window_s": round(xs[-1], 3),
        "r2": round(r2, 4),
        "samples": n,
    }
    if budget is not None:
        out["budget_bytes"] = budget
        if ys[-1] >= budget:
            out["time_to_budget_s"] = 0.0
        elif slope > 0:
            out["time_to_budget_s"] = round((budget - ys[-1]) / slope, 1)
        else:
            out["time_to_budget_s"] = None
    return out


def gauge_series(snapshots: list[dict], series: str) -> list[tuple]:
    """``[(t, value), ...]`` of one scalar gauge series across a JSONL
    snapshot stream — the offline feed for :func:`linear_forecast`."""
    out = []
    for snap in snapshots:
        v = snap.get("metrics", {}).get(series)
        t = snap.get("t")
        if t is not None and isinstance(v, (int, float)):
            out.append((t, v))
    return out


def counter_timeline(snapshots: list[dict], prefix: str) -> list[dict]:
    """Per-interval increments of every counter series starting with
    ``prefix``, as ``[{"t": <s>, "series": ..., "delta": n}, ...]`` —
    how the soak report reconstructs the fault-event timeline from the
    cumulative ``dnz_fault_injections_total{site=...}`` counters.

    Call this per PROCESS stream: counters restart at zero with each
    process, so a concatenated multi-segment stream must be split by
    segment first (tools/soak.py does).  A decrease is still treated as
    a reset (delta = new value) rather than dropped, so an unsplit
    stream degrades to undercounting only when a restarted counter
    overtakes its predecessor between snapshots."""
    last: dict[str, float] = {}
    out: list[dict] = []
    for snap in snapshots:
        t = snap.get("t")
        for series, v in snap.get("metrics", {}).items():
            if not series.startswith(prefix) or isinstance(v, dict):
                continue
            prev = last.get(series, 0)
            delta = v if v < prev else v - prev
            if delta > 0:
                out.append({"t": t, "series": series, "delta": delta})
            last[series] = v
    return out


def merge_final_snapshots(paths) -> dict:
    """Merge N processes' JSONL telemetry streams into ONE registry
    view: each file's FINAL value per series, combined across files —
    counters and scalar gauges sum, histograms merge bucket-wise with
    percentiles re-derived over the union (:func:`merge_histogram`).

    This is the user-facing merger for the multi-process-mergeable
    format the registry writes (one cluster worker per file)::

        python -m denormalized_tpu_torch.obs.readers merge out/obs/w*.jsonl

    Returns ``{"files": n, "series": {name: value-or-stats}}``.  A
    series that is a histogram in one file and a scalar in another is
    skipped (layout drift between engine versions — never mis-merged).
    """
    finals: list[dict] = []
    for p in paths:
        snaps = read_stream(p)
        if not snaps:
            continue
        series: dict = {}
        for snap in snaps:  # last value per series wins (cumulative)
            for name, v in snap.get("metrics", {}).items():
                series[name] = v
        finals.append(series)
    names: dict[str, None] = {}
    for s in finals:
        for name in s:
            names.setdefault(name)
    merged: dict = {}
    for name in names:
        vals = [s[name] for s in finals if name in s]
        hists = [v for v in vals if isinstance(v, dict)]
        scalars = [v for v in vals if isinstance(v, (int, float))]
        if hists and scalars:
            continue  # mixed kinds across files: refuse to guess
        if hists:
            m = merge_histogram(hists)
            if m is not None:
                merged[name] = m
        elif scalars:
            total = sum(scalars)
            merged[name] = round(total, 6) if isinstance(total, float) \
                else total
    return {"files": len(finals), "series": merged}


def _merge_cli(argv) -> int:
    import sys

    if not argv or argv[0] != "merge" or len(argv) < 2:
        sys.stderr.write(
            "usage: python -m denormalized_tpu_torch.obs.readers "
            "merge <snap.jsonl> [<snap.jsonl> ...]\n"
        )
        return 2
    out = merge_final_snapshots(argv[1:])
    json.dump(out, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    import sys

    sys.exit(_merge_cli(sys.argv[1:]))
