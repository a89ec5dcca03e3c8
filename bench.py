#!/usr/bin/env python
"""Batch benchmark: 1080p -> 203x64 truecolor ASCII conversion on one GPU.

What it runs:
- A batch of B=128 1080p frames made on the device (as in the server, where
  client uploads are staged on-device ahead of the render tick).
- Byte-exactness gate: a slice of the batch goes through the FULL path
  (device records -> host -> native emitter) and must equal the Python
  oracle byte-for-byte; the run fails otherwise.
- The timed device conversion: the fused resize + luma + cell-record step
  with a checksum reduction, in an on-device K-step loop whose per-iteration
  time is the difference of two loop lengths.
- The host emitter alone, then convert, D2H and emit running concurrently
  (runtime/device_stream.OverlappedRenderPipeline).
- The 9-client server tick and the WebRTC DataChannel loopback.

It refuses to run without a GPU. ``ASCIICHAT_BENCH_SMOKE=1`` runs every path
at tiny shapes on the CPU instead, and its JSON says ``"smoke": true``: those
numbers are not device numbers.

Prints ONE JSON line; every number in it names the device it ran on.
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from asciichat_tpu.utils import jaxcache

    jaxcache.ensure()  # reuse any prior process's compiled graphs
    smoke = os.environ.get("ASCIICHAT_BENCH_SMOKE") == "1"
    if smoke:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if not smoke and dev.platform != "gpu":
        log(f"FATAL: no GPU (default device {dev}); "
            "ASCIICHAT_BENCH_SMOKE=1 rehearses on the CPU")
        print(json.dumps({"ok": False, "error": f"no GPU: {dev.platform}"}))
        return 1
    log(f"device: {dev} ({dev.device_kind})" + (" [SMOKE MODE]" if smoke else ""))

    from asciichat_tpu.ops import cells
    from asciichat_tpu.render import emitter, oracle
    from asciichat_tpu.render import palette as pal
    from asciichat_tpu.render.pipeline import plan_render
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

    # Version block: runs are only comparable if the stack is pinned; with
    # a byte-identical timed step (see the HLO fingerprint below) a rate
    # change can only come from the environment.
    import jaxlib

    versions = {"jax": jax.__version__, "jaxlib": jaxlib.version.__version__,
                "platform": dev.platform, "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "platform_version": dev.client.platform_version}
    log(f"versions: {versions}")

    B = 8 if smoke else 128
    SRC_H, SRC_W = (270, 480) if smoke else (1080, 1920)
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    plan = plan_render(SRC_W, SRC_H, 203, 64, caps)
    log(f"plan: {plan}")

    # Deterministic synthetic 1080p content (gradient + structure), built on
    # the device: 800 MB need not cross PCIe.
    def make_frames():
        yy = jnp.arange(SRC_H, dtype=jnp.int32)[:, None]
        xx = jnp.arange(SRC_W, dtype=jnp.int32)[None, :]
        bidx = jnp.arange(B, dtype=jnp.int32)[:, None, None]
        zero = jnp.zeros((B, SRC_H, SRC_W), jnp.int32)
        r = zero + ((xx * 255) // (SRC_W - 1) + bidx * 7) % 256
        g = zero + ((yy * 255) // (SRC_H - 1) + bidx * 13) % 256
        b = zero + (xx + yy + bidx * 29) % 256
        return jnp.stack([r, g, b], axis=-1).astype(jnp.uint8)

    frames = jax.jit(make_frames)()
    jax.block_until_ready(frames)
    ramp = jnp.asarray(pal.char_index_ramp_array(pal.DEFAULT_PALETTE))

    @jax.jit
    def step(frames, ramp):
        records = cells.render_cells(
            frames, ramp, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode
        )
        checks = [jnp.sum(v.astype(jnp.int32)) for v in records.values()]
        return records, jnp.stack(checks)

    # --- byte-exactness gate on a slice of the batch ---------------------
    records, checks = step(frames, ramp)
    host = {k: np.asarray(v[:2]) for k, v in records.items()}
    got = emitter.emit_frames(host, plan.mode, pal.DEFAULT_PALETTE,
                              pad_w=plan.pad_w, pad_h=plan.pad_h)
    frames_h = np.asarray(frames[:2])
    for i in range(2):
        want = oracle.ascii_convert_with_capabilities(frames_h[i], 203, 64, caps)
        if got[i] != want:
            log("FATAL: output not byte-identical to oracle")
            print(json.dumps({"ok": False, "error": "not byte-identical"}))
            return 1
    log(f"byte-exactness gate: OK (frame bytes={len(got[0])})")

    # --- timed device conversion -----------------------------------------
    # On-device K-step loop with a serial dependency through the checksum so
    # XLA can neither hoist nor CSE iterations; per-call dispatch overhead is
    # removed by differencing two loop lengths. Each iteration converts the
    # full B-frame batch.
    def make_step_k(k):
        @jax.jit
        def step_k(frames, ramp):
            def body(i, acc):
                f = frames + (acc & 1).astype(jnp.uint8)
                recs = cells.render_cells(
                    f, ramp, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode
                )
                return acc + sum(jnp.sum(v.astype(jnp.int32)) for v in recs.values())

            return jax.lax.fori_loop(0, k, body, jnp.int32(0), unroll=1)

        return step_k

    k1, k2, reps = 8, 40, 3
    s1, s2 = make_step_k(k1), make_step_k(k2)
    # HLO fingerprint of the timed step: identical hash across runs means
    # any fps delta is environment drift, not an op change.
    import hashlib

    hlo_hash = hashlib.sha256(
        s2.lower(frames, ramp).as_text().encode()).hexdigest()[:16]
    log(f"timed-step HLO fingerprint: {hlo_hash}")
    int(s1(frames, ramp))  # compile
    int(s2(frames, ramp))
    # best-of-reps each loop length INDEPENDENTLY (the bench_server_tick
    # methodology): mean-differencing let a single host stall in the k1
    # phase produce a negative or absurd headline with no invalidation.
    # A corrupted delta retries; if jitter never clears, fall back to the
    # k2 loop's raw rate (includes dispatch overhead -> a LOWER bound,
    # logged as such, never a negative/absurd headline).
    best1 = best2 = float("inf")
    per_iter = None
    for attempt in range(3):
        for _ in range(reps):
            t0 = time.perf_counter()
            int(s1(frames, ramp))  # int() forces synchronous completion
            best1 = min(best1, time.perf_counter() - t0)
            t0 = time.perf_counter()
            int(s2(frames, ramp))
            best2 = min(best2, time.perf_counter() - t0)
        if best2 - best1 > 0:
            per_iter = (best2 - best1) / (k2 - k1)
            break
        log(f"jitter-corrupted differencing pair (k1={best1 * 1e3:.1f}ms >= "
            f"k2={best2 * 1e3:.1f}ms); retrying ({attempt + 1}/3)")
    if per_iter is None:
        per_iter = best2 / k2
        log("WARNING: differencing never converged; reporting the k2 loop's "
            "raw rate (dispatch overhead included -> lower bound)")
    fps = B / per_iter
    log(f"device conversion: {fps:,.0f} frames/s ({per_iter / B * 1e6:.2f} us/frame, "
        f"k1={best1 * 1e3:.1f}ms k2={best2 * 1e3:.1f}ms, best-of-{reps})")

    # --- end-to-end: records -> ANSI bytes (the serving-path bottleneck) --
    # Host emit in isolation first (same worst-case gradient content: color
    # changes every pixel -> SGR every cell), zero-copy views, contiguous
    # staging (non-contiguous views would be re-copied on every call).
    nslice = min(32, B)
    hb = {k: np.ascontiguousarray(np.asarray(v[:nslice])) for k, v in records.items()}
    emit_iters, emit_reps = 8, 5
    emitter.emit_frames(hb, plan.mode, pal.DEFAULT_PALETTE,
                        pad_w=plan.pad_w, pad_h=plan.pad_h, nthreads=1, copy=False)
    best = float("inf")
    for _ in range(emit_reps):  # best-of-reps: shared host cores stall
        t0 = time.perf_counter()
        for _ in range(emit_iters):
            out = emitter.emit_frames(hb, plan.mode, pal.DEFAULT_PALETTE,
                                      pad_w=plan.pad_w, pad_h=plan.pad_h, nthreads=1,
                                      copy=False)
        best = min(best, time.perf_counter() - t0)
    emit_fps = nslice * emit_iters / best
    frame_bytes = sum(len(o) for o in out) // len(out)
    log(f"host emitter (isolated, 1 thread, worst-case content, "
        f"{frame_bytes} B/frame): {emit_fps:,.0f} frames/s")
    # multithreaded emit: byte-identity is test-gated
    # (test_emit_multithreaded_byte_identical); the scaling number is for
    # whatever cores this host has
    nthreads_mt = min(4, max(2, (os.cpu_count() or 1)))
    best_mt = float("inf")
    for _ in range(emit_reps):
        t0 = time.perf_counter()
        for _ in range(emit_iters):
            out_mt = emitter.emit_frames(hb, plan.mode, pal.DEFAULT_PALETTE,
                                         pad_w=plan.pad_w, pad_h=plan.pad_h,
                                         nthreads=nthreads_mt, copy=False)
        best_mt = min(best_mt, time.perf_counter() - t0)
    emit_fps_mt = nslice * emit_iters / best_mt
    log(f"host emitter ({nthreads_mt} threads on {os.cpu_count()} core(s)): "
        f"{emit_fps_mt:,.0f} frames/s ({emit_fps_mt / emit_fps:.2f}x)")

    # --- MEASURED overlapped pipeline (not min-of-stages) -----------------
    # All three serving stages run CONCURRENTLY for several seconds
    # (runtime/device_stream.OverlappedRenderPipeline): device k-step convert
    # loops double-buffered, a saturated D2H record stream, and the native
    # emitter, on the same 1080p batch. emit_under_concurrency_fps is the emit
    # rate under that concurrency — the serving bottleneck stage measured
    # with the other stages live.
    from asciichat_tpu.runtime.device_stream import OverlappedRenderPipeline

    kp = 24

    @jax.jit
    def step_records(frames, ramp):
        def body(i, acc):
            f = frames + (acc & 1).astype(jnp.uint8)
            recs = cells.render_cells(
                f, ramp, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode
            )
            return acc + sum(jnp.sum(v.astype(jnp.int32)) for v in recs.values())

        acc = jax.lax.fori_loop(0, kp - 1, body, jnp.int32(0), unroll=1)
        f = frames + (acc & 1).astype(jnp.uint8)
        recs = cells.render_cells(
            f, ramp, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode
        )
        acc = acc + sum(jnp.sum(v.astype(jnp.int32)) for v in recs.values())
        return recs, acc

    step_records(frames, ramp)[1].block_until_ready()  # compile
    pipe = OverlappedRenderPipeline(
        step_records, frames, ramp,
        lambda host: emitter.emit_frames(
            host, plan.mode, pal.DEFAULT_PALETTE, pad_w=plan.pad_w,
            pad_h=plan.pad_h, nthreads=1, copy=False),
        batch=B, k=kp, fetch_slice=8,
    )
    rates = pipe.run(seconds=6.0, warmup=1.5)
    # The emit loop re-renders the latest fetched slice, so its rate is the
    # emit STAGE under full concurrency, not distinct end-to-end frames;
    # distinct end-to-end frames/s = min of the three concurrent stage rates.
    emit_under_concurrency_fps = rates["emit_fps"]
    end_to_end_onbox_fps = min(rates["convert_fps"], rates["d2h_fps"],
                               rates["emit_fps"])
    log(f"overlapped pipeline ({rates['seconds']:.1f}s steady-state, all 3 "
        f"stages concurrent): convert={rates['convert_fps']:,.0f} fps, "
        f"d2h={rates['d2h_fps']:,.0f} fps ({rates['d2h_mbps']:.1f} MB/s), "
        f"emit={emit_under_concurrency_fps:,.0f} fps")
    log(f"end_to_end (min of concurrent stages): "
        f"{end_to_end_onbox_fps:,.0f} distinct frames/s")

    # --- 9-client server tick ---------------------------------------------
    tick_rate = bench_server_tick()
    log(f"9-client server tick (composite + 9 personalized renders + 9 "
        f"exclusive mixes): {tick_rate:,.0f} ticks/s "
        f"(reference cadence: 60/s)")

    # --- WebRTC DataChannel transport throughput --------------------------
    datachannel_fps = bench_datachannel()
    log(f"WebRTC DataChannel loopback (DTLS 1.2 + SCTP, both endpoints "
        f"this host): {datachannel_fps:,.0f} x 55KB ACIP frames/s "
        f"({datachannel_fps * 55 / 1000:.1f} MB/s)")

    print(json.dumps({
        "ok": True,
        "metric": "1080p_truecolor_ascii_fps",
        "value": round(fps, 1),
        "unit": "frames/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "emit_under_concurrency_fps": round(emit_under_concurrency_fps, 1),
        "end_to_end_fps": round(end_to_end_onbox_fps, 1),
        "host_emit_fps": round(emit_fps, 1),
        "host_emit_fps_mt": round(emit_fps_mt, 1),
        "host_emit_mt_threads": nthreads_mt,
        "pipeline_convert_fps": round(rates["convert_fps"], 1),
        "pipeline_d2h_fps": round(rates["d2h_fps"], 1),
        "pipeline_d2h_mbps": round(rates["d2h_mbps"], 2),
        "hlo_fingerprint": hlo_hash,
        "server_tick_per_s": round(tick_rate, 1),
        "datachannel_fps": round(datachannel_fps, 1),
        "versions": versions,
        **({"smoke": True} if smoke else {}),
    }))
    return 0


def bench_datachannel() -> float:
    """55KB ACIP frames through the full negotiated WebRTC stack (ICE
    nomination -> DTLS 1.2 -> SCTP/DCEP) over loopback, both endpoints in
    this process (so the number is conservative by ~2x vs one endpoint
    per host). The serving transport for browsers and --webrtc clients."""
    import asyncio
    import os as _os

    from asciichat_tpu.net import dtls as dtls_mod

    if not dtls_mod.available():
        raise RuntimeError("OpenSSL 3 not available")

    async def run() -> float:
        from asciichat_tpu.net.webrtc import IceLiteAgent

        a = IceLiteAgent(controlling=True, dtls=True)
        b = IceLiteAgent(controlling=False, dtls=True)
        await a.start("127.0.0.1")
        await b.start("127.0.0.1")
        try:
            b.set_remote(a.local_description())
            a.set_remote(b.local_description())
            ch_a = await (await a.wait_connected(15)).wait_ready(15)
            ch_b = await (await b.wait_connected(15)).wait_ready(15)
            frame = _os.urandom(55_000)
            n = 120

            async def producer():
                for _ in range(n):
                    await ch_a.send(3000, frame)

            t0 = time.perf_counter()
            prod = asyncio.create_task(producer())
            try:
                for _ in range(n):
                    await asyncio.wait_for(ch_b.recv(), 30)
                dt = time.perf_counter() - t0
                return n / dt
            finally:
                # a recv timeout must not abandon the producer mid-send:
                # the agents close underneath it and its exception (which
                # says WHICH side stalled) would be silently dropped
                if not prod.done():
                    prod.cancel()
                try:
                    await prod
                except (asyncio.CancelledError, ConnectionError) as e:
                    log(f"datachannel producer ended: {e!r}")
        finally:
            a.close()
            b.close()

    return asyncio.run(asyncio.wait_for(run(), 60))


def bench_server_tick() -> float:
    """Full 9-client tick rate: composite gather from 9x 800x600 uploads +
    9 personalized half-block renders (per-client color filters) + 9
    exclude-self audio mixes, as ONE jitted step (models/server.py)."""
    import jax
    import jax.numpy as jnp

    from asciichat_tpu.models.server import ServerTick, plan_tick, tick_compute
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

    C = 9
    smoke = os.environ.get("ASCIICHAT_BENCH_SMOKE") == "1"
    src_w, src_h = (160, 120) if smoke else (800, 600)
    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
    plan = plan_tick([(src_w, src_h)] * C, term_w=203, term_h=64, caps=caps)
    rng = np.random.default_rng(0)
    frames = jnp.asarray(rng.integers(0, 256, (C, src_h, src_w, 3), dtype=np.uint8))
    audio = jnp.asarray(rng.normal(0, 0.1, (C, 480)).astype(np.float32))
    active = jnp.ones(C, bool)
    tick = ServerTick(plan, client_filters=["none", "green", "cyan", "none",
                                            "orange", "none", "pink", "none",
                                            "rainbow"])

    def one_tick(f, a, st):
        recs, mixes, st = tick_compute(
            f, a, active, st, *tick.consts,
            mode=plan.render.mode, dst_h=plan.render.dst_h_px,
            dst_w=plan.render.dst_w,
        )
        chk = sum(jnp.sum(v.astype(jnp.int32)) for v in recs.values())
        return chk + jnp.sum(mixes).astype(jnp.int32), st

    @jax.jit
    def ticks_k(frames, audio, state, k):
        def body(i, carry):
            acc, st = carry
            f = frames + (acc & 1).astype(jnp.uint8)
            chk, st = one_tick(f, audio, st)
            return (acc + chk, st)
        return jax.lax.fori_loop(0, k, body, (jnp.int32(0), state))

    st = tick.mixer_state
    int(ticks_k(frames, audio, st, 8)[0])  # compile
    int(ticks_k(frames, audio, st, 40)[0])
    # min() each loop length INDEPENDENTLY: min of the differences would
    # preferentially select a jitter-corrupted pair (inflated baseline ->
    # tiny or negative delta)
    best8 = best40 = float("inf")
    for attempt in range(3):
        for _ in range(3):
            t0 = time.perf_counter()
            int(ticks_k(frames, audio, st, 8)[0])
            best8 = min(best8, time.perf_counter() - t0)
            t0 = time.perf_counter()
            int(ticks_k(frames, audio, st, 40)[0])
            best40 = min(best40, time.perf_counter() - t0)
        if best40 - best8 > 0:
            return 32 / (best40 - best8)
    # jitter never cleared: the 1e-9 floor used to report up to 1e9 ticks/s
    # here — return the k40 loop's raw rate instead (dispatch overhead
    # included -> an honest lower bound)
    log("WARNING: tick differencing never converged; reporting the k40 "
        "loop's raw rate (lower bound)")
    return 40 / best40


if __name__ == "__main__":
    sys.exit(main())
