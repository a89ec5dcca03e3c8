#!/usr/bin/env python
"""Mixed-transport server soak: TCP + WebSocket + WebRTC clients against
one live server tick for N seconds, watching delivery and RSS.

The reference's stability claims come from long-running multi-client
sessions (README linear-scaling claim, src/server/render.c:37); this is
the measurable analog: every transport the framework serves, driven by
the PRODUCTION client, with the test-pattern source uplinking and frames
flowing back, plus RSS sampled over time so leaks show as a slope.

Usage: python tools/soak_mixed.py [seconds]
The server and its clients share this one process, so the server ticks on
the default device (the GPU where there is one).
"""

from __future__ import annotations

import asyncio
import os
import sys
import time

# runnable as `python tools/soak_mixed.py` without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


from soak_common import rss_kib, stop_server  # noqa: E402


async def main(seconds: float) -> int:
    from asciichat_tpu.utils import jaxcache

    jaxcache.ensure()
    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.apps.server import AsciiChatServer
    from asciichat_tpu.apps.webclient import WebRtcGateway, make_http_handler
    from asciichat_tpu.net import protocol as proto
    from asciichat_tpu.net.transport import serve_tcp
    from asciichat_tpu.net.websocket import serve_ws
    from asciichat_tpu.render.types import (ColorLevel, RenderMode,
                                            TerminalCapabilities)
    from asciichat_tpu.runtime.framesource import open_source

    server = AsciiChatServer()
    gw = WebRtcGateway(server._handle_conn)

    def post(path, body):
        if path.split("?", 1)[0] == "/webrtc/offer":
            return gw.on_offer(body)
        return None

    tcp_srv = await serve_tcp(server._handle_conn, "127.0.0.1", 0)
    tcp_port = tcp_srv.sockets[0].getsockname()[1]
    ws_srv = await serve_ws(server._handle_conn, "127.0.0.1", 0,
                            pages=make_http_handler(), post=post)
    ws_port = ws_srv.sockets[0].getsockname()[1]
    tick = asyncio.get_running_loop().create_task(server._tick_loop())

    counts: dict[str, int] = {}
    failures: dict[str, str] = {}
    deadline = time.monotonic() + seconds

    devnull = open(os.devnull, "wb")

    async def run_client(name, port, **kw):
        caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
        c = AsciiChatClient("127.0.0.1", port, open_source(test_pattern=True),
                            proto.WireCapabilities(caps=caps, width=60,
                                                   height=18),
                            reconnect=False, **kw)
        # 6 clients sharing this process's stdout would interleave ANSI
        # garbage AND stall on the pipe; the soak measures serving, not
        # terminal writes
        from asciichat_tpu.utils import term

        c.display.writer = term.FrameWriter(devnull)
        task = asyncio.create_task(c.run(max_frames=10**9))
        try:
            while time.monotonic() < deadline and not task.done():
                await asyncio.sleep(1.0)
            # frames count and failure are SEPARATE: folding a death into
            # the counts dict as a string hid it from arithmetic gates
            counts[name] = c.frames_received
            if task.done() and task.exception():
                failures[name] = repr(task.exception())
        finally:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    rss0 = rss_kib()
    samples: list[int] = []

    async def sampler():
        while time.monotonic() < deadline:
            await asyncio.sleep(max(5.0, seconds / 20))
            samples.append(rss_kib())

    async def warmup_reset():
        # latency percentiles measure steady state, not jit warmup; also
        # apply the production deadline tuning (server.run() does this)
        await asyncio.sleep(min(30.0, seconds / 4))
        server._tune_latency()
        server.tick_latency.reset()
        server.frame_age.reset()

    t0 = time.monotonic()
    await asyncio.gather(
        run_client("tcp-1", tcp_port), run_client("tcp-2", tcp_port),
        run_client("ws-1", ws_port, use_ws=True),
        run_client("ws-2", ws_port, use_ws=True),
        run_client("rtc-1", ws_port, use_webrtc=True),
        run_client("rtc-2", ws_port, use_webrtc=True),
        sampler(),
        warmup_reset(),
    )
    dt = time.monotonic() - t0
    # observe the tick loop's outcome: a mid-soak crash must be reported,
    # not dropped as an unretrieved task exception
    tick_error = await stop_server(tcp_srv, tick)
    gw.close()
    ws_srv.close()
    total = sum(counts.values())
    died = dict(failures)
    if tick_error:
        died["server_tick"] = tick_error
    # leak signal: post-warmup slope only (jax CPU arena + compile caches
    # grow for the first minute and then plateau; compare the last quarter
    # against the third quarter, not against warmup)
    q = max(1, len(samples) // 4)
    drift = (sum(samples[-q:]) / q - sum(samples[-2 * q : -q]) / q
             if len(samples) >= 4 else 0.0)
    lat = server.tick_latency.stats_ms()
    print(f"soak {dt:.0f}s: {total} frames delivered "
          f"({total / dt:.1f}/s across 6 clients: {counts}), "
          f"server ticks {server.ticks} ({server.ticks / dt:.1f}/s), "
          f"device ticks {server.tick_compute_count}")
    print(f"tick latency (steady state): latency_p50_ms={lat['p50_ms']} "
          f"latency_p99_ms={lat['p99_ms']} worst={lat['worst_ms']} "
          f"deadline=16.67")
    print(f"RSS {rss0} KiB start; samples {samples[:3]}...{samples[-3:]}; "
          f"post-warmup drift (last quarter vs previous) {drift:+.0f} KiB")
    # tick floor is modest: this is 13 actors (server + 6 duplex clients +
    # 6 transports) on whatever cores the host has; 1-core CI sustains
    # ~11/s — the signal is "alive and balanced", not raw cadence
    ok = (not died and total > 0 and server.ticks / dt > 5
          and drift < 50_000)
    print("RESULT:", "OK" if ok else
          f"FAILED ({died or 'low tick rate / RSS drift'})")
    return 0 if ok else 1


if __name__ == "__main__":
    secs = float(sys.argv[1]) if len(sys.argv) > 1 else 300.0
    rc = asyncio.run(main(secs))
    # measurement tool, not a service: skip loop-teardown griefs (a
    # cancelled client's executor thread can stall close()) — results are
    # already printed
    sys.stdout.flush()
    os._exit(rc)
