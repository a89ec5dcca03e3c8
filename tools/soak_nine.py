#!/usr/bin/env python
"""9-client heterogeneous soak with join/leave churn (VERDICT r03 #3).

The reference claims linear scaling to 9+ clients (src/server/render.c:37)
with per-client render threads; here the analog is 9 PRODUCTION clients in
one live server tick, spread over >=3 concurrent RenderGroups (3 geometries
x mixed color modes, a custom palette, and 6 distinct color filters), plus a
churn client that joins and leaves throughout — every join/leave changes the
source layout, forcing group rebuilds (re-traces) exactly like the
reference's client_joined/left re-render path.

Reported (one JSON line on stdout):
- per-client delivery counts + balance ratio (min/max over persistent 9)
- tick cadence, device-tick fraction
- RenderGroup (re)build count — the re-trace/layout-churn signal
- steady-state tick latency p50/p99 vs the 16.67 ms deadline
- RSS samples + post-warmup drift (leak slope)

A death of ANY client — including the churn client — fails the soak, and a
churn cycle only counts when its client actually streamed and exited
cleanly. Harness scaffolding shared with the other soaks: soak_common.py.

Usage: python tools/soak_nine.py [seconds] (defaults 600)
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from soak_common import (  # noqa: E402
    boot_server, device_info, drive_client, lag_sampler, make_client, rss_kib, stop_server,
    warmup_reset,
)


async def main(seconds: float) -> int:
    from asciichat_tpu.render.types import ColorLevel, RenderMode

    server, tcp_srv, port, tick = await boot_server()
    deadline = time.monotonic() + seconds
    warmup_until = time.monotonic() + min(60.0, seconds * 0.25)
    devnull = open(os.devnull, "wb")
    counts: dict[str, int] = {}
    failures: dict[str, str] = {}
    churn_events = 0

    # 9 persistent clients -> at least 4 distinct RenderGroup keys
    # (caps, width, height, palette_custom) x 6 distinct filters, at
    # REFERENCE-SCALE geometry (VERDICT r04 #2: >=80x24, headline 203x64 —
    # the r04 soak's 60x18 cells understated per-tick emit/parse cost ~4x):
    #   group A: 100x30 truecolor half-block  (none / green / rainbow)
    #   group B:  80x24 truecolor foreground  (cyan / magenta)
    #   group C: 203x64 256-color half-block  (none / orange) — the
    #            headline-benchmark geometry (BASELINE.json)
    #   group D: 100x30 truecolor half-block, CUSTOM palette (none / red)
    SPECS = [
        ("a1", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, "", "none"),
        ("a2", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, "", "green"),
        ("a3", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, "", "rainbow"),
        ("b1", 80, 24, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, "", "cyan"),
        ("b2", 80, 24, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, "", "magenta"),
        ("c1", 203, 64, ColorLevel.COLOR_256, RenderMode.HALF_BLOCK, "", "none"),
        ("c2", 203, 64, ColorLevel.COLOR_256, RenderMode.HALF_BLOCK, "", "orange"),
        ("d1", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, " .:#@", "none"),
        ("d2", 100, 30, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, " .:#@", "red"),
    ]

    live: dict[str, object] = {}  # name -> running client (resize churn)

    async def run_client(name, spec, until):
        w, h, color, mode, palette, filt = spec
        c = make_client(port, devnull, w=w, h=h, color=color, mode=mode,
                        palette=palette, filt=filt)
        live[name] = c
        try:
            got, err = await drive_client(c, until)
        finally:
            live.pop(name, None)
        counts[name] = counts.get(name, 0) + got
        if err:
            # keyed failures accumulate — a churn death used to overwrite
            # the count with a string the pass gates never looked at
            failures[f"{name}#{len(failures)}"] = err
        return err is None and got > 0

    async def churner():
        # join/leave loop: a 10th streaming client with its OWN geometry
        # appears for ~15 s then leaves for ~10 s. Every transition changes
        # the source layout (stack shape) AND the group set -> rebuilds.
        nonlocal churn_events
        spec = (90, 28, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, "", "teal")
        while time.monotonic() + 20 < deadline:
            ok = await run_client("churn", spec,
                                  min(deadline, time.monotonic() + 15))
            if ok:  # only a cycle that actually streamed counts as coverage
                churn_events += 1
            await asyncio.sleep(10)

    resize_events = 0

    async def resizer():
        # live mid-session resize churn (SIGWINCH role): every ~20 s one
        # persistent client re-negotiates its dims, flipping between two
        # RenderGroup keys — exercises group re-routing under load, which
        # join/leave churn alone never does
        nonlocal resize_events
        dims = [(80, 24), (100, 30)]
        while time.monotonic() + 15 < deadline:
            await asyncio.sleep(20)
            c = live.get("a1")
            if c is not None:
                c.request_resize(*dims[resize_events % 2])
                resize_events += 1

    rss0 = rss_kib()
    samples: list[int] = []

    async def sampler():
        while time.monotonic() < deadline:
            await asyncio.sleep(max(5.0, seconds / 40))
            samples.append(rss_kib())

    loop_lag: dict = {}
    t0 = time.monotonic()
    results = await asyncio.gather(
        *(run_client(name, spec, deadline) for name, *spec in SPECS),
        churner(),
        resizer(),
        sampler(),
        lag_sampler(deadline, warmup_until, loop_lag),
        warmup_reset(server, warmup_until),
    )
    ticks_w, t_w = results[-1]  # steady-state window start (warmup_reset)
    steady_dt = time.monotonic() - t_w
    steady_ticks = server.ticks - ticks_w
    dt = time.monotonic() - t0
    tick_error = await stop_server(tcp_srv, tick)

    nums = [v for k, v in counts.items() if k != "churn"]
    total = sum(counts.values())
    balance = (min(nums) / max(nums)) if nums and max(nums) > 0 else 0.0
    q = max(1, len(samples) // 4)
    drift = (sum(samples[-q:]) / q - sum(samples[-2 * q: -q]) / q
             if len(samples) >= 4 else 0.0)
    lat = server.tick_latency.stats_ms()
    # per-stage averages (post-warmup: warmup_reset cleared the tracer) —
    # the roofline evidence for where each tick's ms actually go
    stage_avg_ms = {
        k: round(t / max(n, 1) * 1e3, 3)
        for k, (t, n) in sorted(server.tick_tracer.snapshot().items())
    }
    postwarm = samples[2:] if len(samples) > 4 else samples
    result = {
        "soak": "nine_heterogeneous_churn",
        "device": device_info(),
        "seconds": round(dt, 1),
        # honesty: the harness clients share the server's ONE core; their
        # capture rate bounds how much core the tick loop can get (see
        # SOAK_UPLINK_FPS in soak_common.make_client)
        "uplink_fps": float(os.environ.get("SOAK_UPLINK_FPS", "30")),
        "clients": 9,
        "render_groups_concurrent": 4,
        "distinct_filters": 6,
        "frames_delivered": total,
        "per_client": counts,
        "balance_min_over_max": round(balance, 3),
        "churn_joins": churn_events,
        "live_resizes": resize_events,
        "group_rebuilds": server.group_creates,
        "tick_rate": round(server.ticks / dt, 1),
        "tick_rate_steady": round(steady_ticks / steady_dt, 2),
        "ticks": server.ticks,
        "ticks_steady": steady_ticks,
        "layout_replans": server.layout_replans,
        "device_tick_computes": server.tick_compute_count,
        "latency_p50_ms": lat["p50_ms"],
        "latency_p99_ms": lat["p99_ms"],
        "latency_worst_ms": lat["worst_ms"],
        "latency_samples": lat["n"],
        "deadline_ms": 16.67,
        # foreign-work exposure of ANY task on this shared loop (a 5 ms
        # sleep's overshoot, steady window): tick p99 ~= own stages + this
        "loop_lag_ms": loop_lag,
        "stage_avg_ms": stage_avg_ms,
        "rss_start_kib": rss0,
        "rss_peak_kib": max(samples) if samples else rss0,
        "rss_peak_postwarmup_kib": max(postwarm) if postwarm else rss0,
        "rss_samples_kib": samples[:3] + ["..."] + samples[-3:]
        if len(samples) > 6 else samples,
        "rss_postwarmup_drift_kib": round(drift),
    }
    # Liveness gates: every client INCLUDING churn survives, balanced
    # delivery, churn-driven layout replans observed, no leak slope.
    # layout_replans (every join/leave/resize changes the source stack
    # layout), NOT group_creates: group_creates counts compile-cache
    # MISSES, and the LRU + persistent XLA cache reusing a returning churn
    # client's group is the memory-bounding behavior working as designed.
    ok_liveness = (not failures and tick_error is None and total > 0
                   and balance > 0.5 and churn_events >= 3
                   and server.layout_replans >= 2 * churn_events  # join+leave
                   and (resize_events >= 3 or dt < 120)  # resize coverage ran
                   and server.ticks / dt > 3 and drift < 50_000)
    # Cadence gates (VERDICT r04 #2): the reference serves 60 ticks/s with
    # p99 under the 16.67 ms deadline (src/server/render.c:4-7). Measured
    # over the STEADY-STATE window: both this loop and the reference's
    # rate limiter sleep only when ahead of schedule and never burst to
    # catch up, so 60.00/s is a CEILING, not a reachable average — any
    # warmup/compile stall permanently lowers the wall number. The gate is
    # the steady window within 1% of the 60 Hz ceiling (≤1 tick lost per
    # ~100) AND p99 under the reference deadline; the wall-average is
    # still reported unfiltered above.
    ok_cadence = (steady_ticks / steady_dt >= 59.4 and lat["p99_ms"] < 16.67)
    result["ok_liveness"] = ok_liveness
    result["ok_cadence"] = ok_cadence
    ok = ok_liveness and ok_cadence
    result["ok"] = ok
    if failures:
        result["died"] = failures
    if tick_error:
        result["server_tick_error"] = tick_error
    print(json.dumps(result))
    print("RESULT:", "OK" if ok else
          f"FAILED (liveness={ok_liveness}, cadence={ok_cadence} "
          f"[steady {steady_ticks / steady_dt:.2f}/s p99={lat['p99_ms']}ms], "
          f"died={failures}, tick_error={tick_error}, "
          f"balance={balance:.2f}, churn={churn_events}, "
          f"replans={server.layout_replans}, drift={drift:+.0f} KiB)")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 600.0
    rc = asyncio.run(main(secs))
    sys.stdout.flush()
    os._exit(rc)
