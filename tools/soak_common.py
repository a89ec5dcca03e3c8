"""Shared soak-harness scaffolding for tools/soak_*.py.

The latency, nine-client, and mixed-transport soaks all boot the same
in-process server + tick loop, drive PRODUCTION clients against it, window
out the jit warmup, and tear down observing failures. Keeping one copy here
means a harness fix (warmup coverage, tick-crash observation, RSS math)
lands in every soak at once instead of drifting per file.
"""

from __future__ import annotations

import asyncio
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def rss_kib() -> int:
    # sysconf, not a hardcoded 4096: on 16K/64K-page kernels (arm64) the
    # resident-pages scaling under-reported RSS 4-16x, passing the leak
    # gates on genuinely leaking builds
    page = os.sysconf("SC_PAGE_SIZE")
    return int(open("/proc/self/statm").read().split()[1]) * page // 1024


def device_info() -> dict:
    """The default device, named in every soak result."""
    from asciichat_tpu.apps.server import device_info

    return device_info()


async def boot_server():
    """Boot the in-process server + tick loop on the default device (the
    GPU where there is one). Returns (server, tcp_srv, port, tick_task)."""
    # Persistent XLA cache, same as the production CLI (apps/main.py): the
    # soak's warmup must measure the serving runtime, not LLVM recompiling
    # group steps a prior run already built (2.6 GB RSS peak when cold).
    from asciichat_tpu.utils import jaxcache

    jaxcache.ensure()
    from asciichat_tpu.apps.server import AsciiChatServer
    from asciichat_tpu.net.transport import serve_tcp

    server = AsciiChatServer()
    tcp_srv = await serve_tcp(server._handle_conn, "127.0.0.1", 0)
    port = tcp_srv.sockets[0].getsockname()[1]
    tick = asyncio.get_running_loop().create_task(server._tick_loop())
    return server, tcp_srv, port, tick


async def stop_server(tcp_srv, tick) -> str | None:
    """Cancel the tick loop and OBSERVE its outcome: a tick-loop crash
    mid-soak must land in the artifact (-> returned repr), not vanish as an
    unretrieved task exception that os._exit never even warns about."""
    tick.cancel()
    err = None
    try:
        await tick
    except asyncio.CancelledError:
        pass
    except Exception as e:  # noqa: BLE001 — the whole point is to report it
        err = repr(e)
    tcp_srv.close()
    return err


def make_client(port, devnull, *, w, h, color, mode, palette="", filt="none"):
    """One PRODUCTION client with a test-pattern source, display devnulled."""
    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.net import protocol as proto
    from asciichat_tpu.ops import filters
    from asciichat_tpu.render.types import TerminalCapabilities
    from asciichat_tpu.runtime.framesource import open_source
    from asciichat_tpu.utils import term

    caps = TerminalCapabilities(color, mode)
    wc = proto.WireCapabilities(
        caps=caps, width=w, height=h, palette_custom=palette,
        palette_type=5 if palette else 0,  # PALETTE_CUSTOM analog
        color_filter=filters.FILTER_NAMES.index(filt),
    )
    # SOAK_UPLINK_FPS throttles the harness clients' capture rate. The
    # roofline measurement behind it: test-pattern gen + pack/CRC costs
    # ~3.5 ms per 480p frame, so 10 in-process clients at 30 fps need
    # ~105% of this box's ONE core before the server renders anything —
    # the cadence ceiling is the harness, not the tick. Throttling the
    # uplink (e.g. to 5 fps) frees the core and lets the run measure the
    # SERVER's actual cadence capacity.
    fps = float(os.environ.get("SOAK_UPLINK_FPS", "30"))
    c = AsciiChatClient("127.0.0.1", port, open_source(test_pattern=True),
                        wc, reconnect=False, capture_fps=fps)
    c.display.writer = term.FrameWriter(devnull)
    return c


async def drive_client(client, until) -> tuple[int, str | None]:
    """Run a client until `until` -> (frames_received, error_repr|None).
    The error is RETURNED, never folded into a counts dict as a string —
    that pattern made a churn-client death invisible to the pass gates."""
    task = asyncio.create_task(client.run(max_frames=10**9))
    try:
        while time.monotonic() < until and not task.done():
            await asyncio.sleep(1.0)
        if task.done() and task.exception():
            return client.frames_received, repr(task.exception())
        return client.frames_received, None
    finally:
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass


async def warmup_reset(server, warmup_until) -> tuple[int, float]:
    """Steady-state window: once warmup expires, apply production latency
    tuning and reset ALL the trackers the artifact reports — including the
    per-stage tick tracer (resetting only the percentile trackers left the
    multi-second jit-compile spike in stage_avg_ms forever, inflating
    'convert' by orders of magnitude next to honest p50/p99 columns).

    Returns (ticks_at_steady, t_at_steady) so callers can compute the
    STEADY-STATE tick rate: the wall-average includes jit warmup stalls,
    and a sleep-only-if-ahead 60 Hz pacer (same rate-limiter discipline as
    the reference, src/server/render.c "sleeps only if ahead of schedule")
    can never average ABOVE 60, so warmup permanently caps the wall number
    below the target no matter how healthy steady state is."""
    while time.monotonic() < warmup_until:
        await asyncio.sleep(0.5)
    server._tune_latency()
    server.tick_latency.reset()
    server.frame_age.reset()
    server.tick_tracer.reset()
    return server.ticks, time.monotonic()


async def lag_sampler(until, warmup_until, out: dict) -> None:
    """Event-loop scheduling-lag sampler (steady-state window only).

    The server's tick latency is measured on a shared asyncio loop: any
    other task's long coroutine step (a client's capture/pack, a conn
    handler's CRC pass) lands INSIDE the tick's wall time. This task sleeps
    5 ms in a loop and records the overshoot — pure foreign-work exposure,
    zero server involvement — so an artifact can attribute tick p99 between
    the server's own stages (tick_tracer) and loop timesharing. Writes
    {"p50_ms", "p99_ms", "worst_ms", "samples"} into `out`."""
    lags: list[float] = []
    while time.monotonic() < until:
        t0 = time.monotonic()
        await asyncio.sleep(0.005)
        lag = (time.monotonic() - t0 - 0.005) * 1e3
        if time.monotonic() >= warmup_until:
            lags.append(lag)
    lags.sort()
    if lags:
        out.update(
            p50_ms=round(lags[len(lags) // 2], 3),
            p99_ms=round(lags[int(len(lags) * 0.99)], 3),
            worst_ms=round(lags[-1], 3),
            samples=len(lags),
        )
