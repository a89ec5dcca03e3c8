"""Host -> device double-buffered frame staging.

The reference overlaps decode with rendering via its 3-thread pipeline and
bounded queues (src/common/session/pipeline.c, SURVEY §2e.2); the device
equivalent overlaps HOST->DEVICE transfer with device compute: two staging
slots, `stage()` starts an async device_put of the incoming batch (JAX
transfers are asynchronous) and returns the PREVIOUS batch, which is already
resident and ready to feed the render kernels while the new one streams in.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np

from asciichat_tpu.runtime.double_buffer import LatestFrame


class DeviceFrameStager:
    """Two-slot H2D pipeline: upload of batch N overlaps compute on N-1."""

    def __init__(self, device=None, sharding=None):
        self._dst = sharding if sharding is not None else (device or jax.devices()[0])
        self._slots: list[jax.Array | None] = [None, None]
        self._next = 0
        self.staged = 0

    def stage(self, frames: np.ndarray) -> jax.Array | None:
        """Start uploading `frames`; return the previously staged device batch
        (None on the first call, when nothing is resident yet)."""
        slot = self._next
        self._next = 1 - slot
        ready = self._slots[self._next]  # the other slot: previous upload
        self._slots[slot] = jax.device_put(frames, self._dst)  # async
        self.staged += 1
        return ready

    def latest(self) -> jax.Array | None:
        """The most recently staged batch (may still be in flight; consuming
        it in a jit computation synchronizes naturally)."""
        return self._slots[1 - self._next]

    def flush(self) -> None:
        for s in self._slots:
            if s is not None:
                jax.block_until_ready(s)


class OverlappedRenderPipeline:
    """Run the three serving-path stages CONCURRENTLY and measure each:

      device convert  ||  D2H record fetch  ||  host ANSI emit

    This is the reference's 3-thread pipeline shape
    (src/common/session/pipeline.c:206,343 — capture/render/send threads over
    bounded queues) mapped to the device serving path. Three host threads:

    - convert: dispatches jitted k-step conversion loops back-to-back with
      two calls in flight (double-buffering hides the dispatch RTT); each
      call returns the final iteration's on-device records + a checksum that
      serially threads the loop so XLA cannot elide iterations.
    - fetch: continuously copies a slice of the latest completed records to
      host memory (jax.device_get), i.e. a saturated D2H stream.
    - emit: continuously renders ANSI frames from the most recently fetched
      host records with the native emitter (GIL released inside).

    Counters give per-stage sustained rates measured UNDER full concurrency —
    the honest replacement for min-of-isolated-stages estimates.
    """

    def __init__(self, step_k, frames, ramp, emit_fn, *, batch: int, k: int,
                 fetch_slice: int = 8):
        self._step_k = step_k
        self._frames = frames
        self._ramp = ramp
        self._emit_fn = emit_fn
        self._batch = batch
        self._k = k
        self._fetch_slice = fetch_slice
        self._stop = threading.Event()
        # latest-value handoffs between the stages (the same swap the
        # serving path uses — double_buffer.LatestFrame — instead of a
        # hand-rolled lock + field pair per hop)
        self._dev = LatestFrame()  # latest completed device records
        self._host = LatestFrame()  # latest fetched host records
        self.converted = 0  # frames converted on device
        self.fetched = 0  # frames worth of records copied to host
        self.fetched_bytes = 0
        self.emitted = 0  # ANSI frames emitted
        self.errors: list[BaseException] = []
        self._threads: list[threading.Thread] = []

    # -- stage loops -------------------------------------------------------
    def _convert_loop(self) -> None:
        try:
            inflight = []
            while not self._stop.is_set():
                recs, chk = self._step_k(self._frames, self._ramp)
                inflight.append((recs, chk))
                if len(inflight) >= 2:  # double-buffer: wait for the older
                    recs0, chk0 = inflight.pop(0)
                    chk0.block_until_ready()
                    self._dev.commit(recs0)
                    self.converted += self._batch * self._k
            for recs0, chk0 in inflight:
                chk0.block_until_ready()
                self.converted += self._batch * self._k
        except BaseException as e:  # surfaced by run()
            self.errors.append(e)
            self._stop.set()

    def _fetch_loop(self) -> None:
        try:
            n = self._fetch_slice
            while not self._stop.is_set():
                recs, _seq, _ts = self._dev.latest()
                if recs is None:
                    time.sleep(0.002)
                    continue
                host = {
                    k: np.ascontiguousarray(jax.device_get(v[:n]))
                    for k, v in recs.items()
                }
                self._host.commit(host)
                # count ROWS ACTUALLY COPIED: with batch < fetch_slice the
                # [:n] slice clamps, and crediting n would overstate d2h_fps
                self.fetched += min(a.shape[0] for a in host.values())
                self.fetched_bytes += sum(a.nbytes for a in host.values())
        except BaseException as e:
            self.errors.append(e)
            self._stop.set()

    def _emit_loop(self) -> None:
        try:
            while not self._stop.is_set():
                host, _seq, _ts = self._host.latest()
                if host is None:
                    time.sleep(0.002)
                    continue
                out = self._emit_fn(host)
                self.emitted += len(out)
        except BaseException as e:
            self.errors.append(e)
            self._stop.set()

    # -- driver ------------------------------------------------------------
    def run(self, seconds: float, warmup: float = 1.0) -> dict:
        """Run all stages concurrently; return per-stage rates over the
        steady-state window (post-warmup). Reusable: each call starts a
        fresh measurement (a second run on a finished pipeline used to
        observe the stale stop flag and silently report all-zero rates)."""
        stale = [t for t in self._threads if t.is_alive()]
        if stale:
            # a thread from a previous run that outlived its join timeout
            # (e.g. wedged in block_until_ready on a hung device) would wake
            # when _stop clears and double-count into this run's counters
            raise RuntimeError(
                f"previous run's threads still alive: "
                f"{[t.name for t in stale]}")
        self._stop.clear()
        self.errors.clear()
        self._dev = LatestFrame()
        self._host = LatestFrame()
        self._threads = [
            threading.Thread(target=f, daemon=True, name=n)
            for f, n in ((self._convert_loop, "pipeline-convert"),
                         (self._fetch_loop, "pipeline-fetch"),
                         (self._emit_loop, "pipeline-emit"))
        ]
        for t in self._threads:
            t.start()
        deadline = time.monotonic() + warmup
        while time.monotonic() < deadline and not self._stop.is_set():
            time.sleep(0.01)
        c0, f0, e0, b0 = self.converted, self.fetched, self.emitted, self.fetched_bytes
        t0 = time.monotonic()
        deadline = t0 + seconds
        while time.monotonic() < deadline and not self._stop.is_set():
            time.sleep(0.01)
        dt = time.monotonic() - t0
        rates = {
            "convert_fps": (self.converted - c0) / dt,
            "d2h_fps": (self.fetched - f0) / dt,
            "d2h_mbps": (self.fetched_bytes - b0) / dt / 1e6,
            "emit_fps": (self.emitted - e0) / dt,
            "seconds": dt,
        }
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        if self.errors:
            raise self.errors[0]
        return rates
