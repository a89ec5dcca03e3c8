#!/usr/bin/env python
"""Latency/deadline soak: 3 production clients at the 60 fps serving cadence
on the default device; asserts steady-state p99 tick latency under the 16.67 ms deadline.

The reference is a latency-oriented system (16.67 ms tick deadline,
src/server/render.c:4-7; SLOW_ASCII_CONVERT warnings past 5 ms,
src/server/stream.c:846-850). This artifact is the analog for this repo's
serving path: the in-process server serves 3 REAL clients, jit warmup ticks
are excluded (ALL trackers reset after warmup, including the per-stage
tracer), and the steady-state window's p50/p99/worst tick latency — tick
start (frame pickup) through emit + queue — plus frame age (upload commit ->
tick pickup wait) are reported as one JSON line and asserted against the
deadline. Harness scaffolding shared with the other soaks: soak_common.py.

Usage: python tools/soak_latency.py [seconds] (defaults 60)
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from soak_common import (  # noqa: E402
    boot_server, device_info, drive_client, make_client, stop_server, warmup_reset,
)

WARMUP_FRACTION = 0.25


async def main(seconds: float) -> int:
    from asciichat_tpu.render.types import ColorLevel, RenderMode

    server, tcp_srv, port, tick = await boot_server()
    deadline = time.monotonic() + seconds
    warmup_until = time.monotonic() + max(5.0, seconds * WARMUP_FRACTION)
    devnull = open(os.devnull, "wb")
    counts: dict[str, int] = {}
    failures: dict[str, str] = {}

    async def run_client(name):
        c = make_client(port, devnull, w=60, h=18,
                        color=ColorLevel.TRUECOLOR, mode=RenderMode.FOREGROUND)
        got, err = await drive_client(c, deadline)
        counts[name] = got
        if err:
            failures[name] = err

    t0 = time.monotonic()
    await asyncio.gather(
        run_client("c1"), run_client("c2"), run_client("c3"),
        warmup_reset(server, warmup_until),
    )
    dt = time.monotonic() - t0
    tick_error = await stop_server(tcp_srv, tick)

    lat = server.tick_latency.stats_ms()
    age = server.frame_age.stats_ms()
    total = sum(counts.values())
    tick_rate = server.ticks / dt
    deadline_ms = server._tick_deadline * 1e3
    result = {
        "soak": "latency_3client_60fps",
        "device": device_info(),
        "seconds": round(dt, 1),
        "clients": 3,
        "frames_delivered": total,
        "tick_rate": round(tick_rate, 1),
        "latency_p50_ms": lat["p50_ms"],
        "latency_p90_ms": lat["p90_ms"],
        "latency_p99_ms": lat["p99_ms"],
        "latency_worst_ms": lat["worst_ms"],
        "latency_samples": lat["n"],
        "frame_age_p50_ms": age["p50_ms"],
        "frame_age_p99_ms": age["p99_ms"],
        "deadline_ms": round(deadline_ms, 2),
        # steady-state only: warmup_reset clears the tracer too, so the jit
        # compile spike no longer haunts the stage decomposition
        "stage_avg_ms": {
            k: round(t / max(n, 1) * 1e3, 3)
            for k, (t, n) in server.tick_tracer.snapshot().items()
        },
    }
    ok = (not failures and tick_error is None and total > 0
          and lat["n"] > 50 and lat["p99_ms"] < deadline_ms)
    result["ok"] = ok
    if failures:
        result["died"] = failures
    if tick_error:
        result["server_tick_error"] = tick_error
    print(json.dumps(result))
    print("RESULT:", "OK" if ok else
          f"FAILED (p99 {lat['p99_ms']} ms vs {deadline_ms:.2f} ms deadline, "
          f"died={failures}, tick_error={tick_error})")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 60.0
    rc = asyncio.run(main(secs))
    sys.stdout.flush()
    os._exit(rc)
