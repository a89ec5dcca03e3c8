#!/usr/bin/env python
"""Proof that the system runs on the GPU, byte-exact, through its entry points.

    python chip_smoke.py               # one GPU: phases 0-4
    python chip_smoke.py --four-cards  # four GPUs: the meshed room only

Phases (one GPU):
0. What it runs on: devices, JAX versions, the card's name and power limit,
   the compile-cache directory. A child process asks JAX, so that this
   process does not hold the card while the server does.
1. The served room: the CLI server as a child process on the GPU, 9 CLI
   clients pinned to the CPU uplinking seeded 800x600 frames on stdin. Frames
   the clients received are compared byte for byte with the CPU reference
   (composite_reference -> apply_color_filter_reference -> oracle), and the
   server's inspector must show device ticks, no mesh and no host ticks.
2. Every cell-record mode (ops/cells.MODES) at 1080p -> 203x64, B=128 on the
   card; a slice of the records through the native emitter must equal the
   oracle.
3. The 9-client tick (models/server.tick_compute) on the GPU against the
   same step on the CPU: records byte-equal, audio within a stated tolerance.
4. The resize, timed on the card: the gather it serves against the one-hot
   bf16 matrix-product formulation, at the three source shapes the cells use.

With ``--four-cards`` it runs phase 0, then the room with the server seeing
four GPUs (a {'clients': 4} mesh), then tick_compute sharded over the four
GPUs against one GPU, and nothing else.

The last line of stdout is one JSON object: ``{"ok": true, "device": ...}``.
Without a GPU, or outside a checkout of this repository, it exits non-zero
and its last line says ``"ok": false``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# The reference's group call (tools/soak_nine.py) without churn or the
# clock-driven rainbow filter: (name, width, height, color mode, render mode
# 0=foreground 2=half-block, filter). Five geometry groups.
ROOM = (
    ("a1", 100, 30, "truecolor", 2, "none"),
    ("a2", 100, 30, "truecolor", 2, "green"),
    ("a3", 100, 30, "truecolor", 2, "teal"),
    ("b1", 80, 24, "truecolor", 0, "cyan"),
    ("b2", 80, 24, "truecolor", 0, "magenta"),
    ("c1", 203, 64, "256", 2, "none"),
    ("c2", 203, 64, "256", 2, "orange"),
    ("d1", 80, 24, "256", 0, "none"),
    ("d2", 203, 64, "truecolor", 0, "red"),
)
UPLINK_W, UPLINK_H = 800, 600  # capture.c:41-44
BATCH, SRC_H, SRC_W = 128, 1080, 1920  # the batch cell
TERM_W, TERM_H = 203, 64
# The tick's audio is float32 through pow/log10/exp/tanh inside one
# lax.scan. XLA:GPU and XLA:CPU lower those to different polynomial and
# library approximations (a few ulp apart) but keep the scan order, so the
# envelopes drift apart by at most a few ulp per step: 1e-5 relative over
# the 480-sample tick, with an absolute floor for samples near zero.
AUDIO_RTOL, AUDIO_ATOL = 1e-5, 1e-6


def say(*parts) -> None:
    print(*parts, flush=True)


def caps_for(color: str, render_mode: int):
    """The capabilities a piped CLI client reports (no padding: its stdout
    is not a terminal)."""
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

    level = {"truecolor": ColorLevel.TRUECOLOR, "256": ColorLevel.COLOR_256}[color]
    return TerminalCapabilities(level, RenderMode(render_mode), wants_padding=False)


def room_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Seeded uplink frames: a coarse grid of colored blocks (long runs for
    the emitters' run-length paths) over a gradient, with noise, one black
    corner (half-block transparency) per source."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        blocks = rng.integers(0, 256, (6, 8, 3))
        base = blocks[yy * 6 // h, xx * 8 // w].astype(np.int32)
        base[..., 0] += xx * 64 // w
        base[..., 2] += yy * 64 // h
        base += rng.integers(0, 8, (h, w, 3))
        base[: h // 5, : w // 5] = 0
        out[i] = np.clip(base, 0, 255)
    return out


def room_reference(frames: np.ndarray, width: int, height: int, color: str,
                   render_mode: int, filt: str) -> bytes:
    """One receiver's frame computed on the CPU: the logic of the server's
    host path with the scalar oracle as the renderer."""
    from asciichat_tpu.ops import compositor, filters
    from asciichat_tpu.render import oracle

    sizes = [(f.shape[1], f.shape[0]) for f in frames]
    plan = compositor.plan_composite(sizes, width, height)
    composite = compositor.composite_reference(frames, plan)
    composite = filters.apply_color_filter_reference(composite, filt)
    req_h = height * 2 if render_mode == 2 else height  # stream.c:831
    return oracle.ascii_convert_with_capabilities(
        composite, width, req_h, caps_for(color, render_mode))


# ---------------------------------------------------------------------------
# Phase 0


def probe_devices() -> dict:
    """Ask JAX in a child process which devices exist, so that this process
    holds no card while the server runs."""
    code = ("import json, jax, jaxlib; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d), 'devices': [str(x) for x in d], "
            "'jax': jax.__version__, 'jaxlib': jaxlib.version.__version__}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"device probe failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def nvidia_smi() -> list[str]:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# Phase 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inspect(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/state/server",
                                timeout=10) as r:
        return json.loads(r.read())


def _wait(pred, timeout: float, what: str, procs=()) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for p in procs:
            if p.poll() is not None:
                raise RuntimeError(f"{what}: process {p.args[3:5]} exited "
                                   f"with {p.returncode}")
        try:
            if pred():
                return
        except OSError:
            pass
        time.sleep(0.25)
    raise TimeoutError(f"timed out after {timeout:.0f}s waiting for {what}")


def served_room(frames: np.ndarray, workdir: str, *, server_env=None,
                max_frames: int = 90, encrypt: bool = False,
                timeout: float = 600.0) -> dict:
    """Run the CLI server and one CLI client per ROOM entry (plus, with
    ``encrypt``, a view-only encrypted client); return the inspector state
    and each client's stdout. Clients register one at a time, so the
    server's source order is ROOM order, and no client uplinks until all
    are registered, so every client's frames soon show all sources.
    ``server_env`` adds to the server's environment: a rehearsal on the CPU
    passes ``ASCIICHAT_JAX_PLATFORM=cpu`` (and ``ASCIICHAT_FORCE_MESH=4``)."""
    port, insp = _free_port(), _free_port()
    base = {**os.environ, "PYTHONPATH": REPO}
    cli = [sys.executable, "-m", "asciichat_tpu.apps.main"]
    procs: list[subprocess.Popen] = []
    files = []

    def out(name: str, suffix: str):
        f = open(os.path.join(workdir, f"{name}.{suffix}"), "wb")
        files.append(f)
        return f

    try:
        server = subprocess.Popen(
            [*cli, "server", "--port", str(port), "--inspect-port", str(insp),
             "--log-level", "WARNING"],
            env={**base, **(server_env or {})}, cwd=REPO,
            stdout=out("server", "out"), stderr=out("server", "err"))
        procs.append(server)
        _wait(lambda: _inspect(insp) is not None, 300, "server start", [server])
        cenv = {**base, "ASCIICHAT_JAX_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"}
        specs = [(*spec, False) for spec in ROOM]
        if encrypt:
            specs.append(("enc", *ROOM[0][1:], True))
        clients = {}
        for k, (name, w, h, color, mode, filt, enc) in enumerate(specs):
            args = [*cli, "client", "127.0.0.1", "--port", str(port),
                    "--width", str(w), "--height", str(h),
                    "--color-mode", color, "--render-mode", str(mode),
                    "--color-filter", filt, "--no-compress", "--no-reconnect",
                    "--max-frames", str(max_frames), "--log-level", "WARNING"]
            args += (["--encrypt", "--no-media"] if enc else
                     ["--stdin-size", f"{frames.shape[2]}x{frames.shape[1]}"])
            p = subprocess.Popen(args, env=cenv, cwd=REPO,
                                 stdin=None if enc else subprocess.PIPE,
                                 stdout=out(name, "out"), stderr=out(name, "err"))
            procs.append(p)
            clients[name] = p
            _wait(lambda n=k + 1: _inspect(insp)["clients"] >= n, 180,
                  f"client {name} to register", procs)
        for (name, *_), frame in zip(ROOM, frames):
            clients[name].stdin.write(frame.tobytes())
            clients[name].stdin.flush()
        # a client exits after max_frames, but its capture thread is parked
        # in a stdin read: close every uplink once the first client leaves
        _wait(lambda: _inspect(insp)["clients"] < len(specs)
              or any(p.poll() is not None for p in clients.values()),
              timeout, "the clients' frames", [server])
        for p in clients.values():
            if p.stdin:
                p.stdin.close()
        # once the uplinks leave no more frames are rendered, so a client
        # that fell behind (a reader slower than the tick sheds frames) can
        # never reach max_frames: stop it; its frames are checked all the same
        deadline = time.monotonic() + 60
        stopped = []
        for name, p in clients.items():
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.terminate()
                p.wait(timeout=20)
                stopped.append(name)
                err = open(os.path.join(workdir, f"{name}.err"), "rb").read()
                say(f"phase 1: client {name} stopped after the uplinks left; "
                    f"its stderr ends: {err[-600:].decode(errors='replace')!r}")
                continue
            if p.returncode != 0:
                err = open(os.path.join(workdir, f"{name}.err"), "rb").read()
                raise RuntimeError(f"client {name} exited {p.returncode}: "
                                   f"{err[-1500:].decode(errors='replace')}")
        state = _inspect(insp)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    received = {name: open(os.path.join(workdir, f"{name}.out"), "rb").read()
                for name, *_ in specs}
    return {"state": state, "received": received, "encrypt": encrypt,
            "stopped": stopped}


def check_room(result: dict, frames: np.ndarray, mesh,
               platform: str = "gpu") -> list[str]:
    """Byte-compare the frames each client received with the CPU reference;
    check the server's counters. Returns report lines; raises on failure."""
    st = result["state"]
    lines = [f"server device {st['device']}, mesh {st['mesh']}, "
             f"tick_compute {st['tick_compute']}, host_ticks {st['host_ticks']}, "
             f"mesh_collectives {st['mesh_collectives']}, ticks {st['ticks']}"]
    if st["device"]["platform"] != platform:
        raise AssertionError(f"server ran on {st['device']}")
    if st["mesh"] != mesh:
        raise AssertionError(f"mesh {st['mesh']} != {mesh}")
    if st["tick_compute"] <= 0 or st["host_ticks"] != 0:
        raise AssertionError(f"device tick not served: {st}")
    if mesh is not None and st["mesh_collectives"] <= 0:
        raise AssertionError("sharded step compiled no collectives")
    specs = list(ROOM) + ([("enc", *ROOM[0][1:])] if result["encrypt"] else [])
    for name, w, h, color, mode, filt in specs:
        want = room_reference(frames, w, h, color, mode, filt)
        got = result["received"][name]
        hits = got.count(want + b"\n")
        stop = (", stopped after the uplinks left" if name in result["stopped"]
                else "")
        lines.append(f"  {name} {w}x{h} {color} {'half-block' if mode == 2 else 'foreground'} "
                     f"{filt}: {len(got)} B received, {hits} frame(s) byte-equal "
                     f"to the CPU reference ({len(want)} B){stop}")
        if hits < 1:
            raise AssertionError(f"client {name}: no received frame equals the "
                                 "CPU reference")
    return lines


# ---------------------------------------------------------------------------
# Phase 2


def batch_frames(device, b: int, h: int, w: int, seed: int = 0):
    """Seeded synthetic batch made on the device: gradient + noise, a black
    box (half-block transparency) and a band of long horizontal runs."""
    import jax
    import jax.numpy as jnp

    def make():
        yy = jnp.arange(h, dtype=jnp.int32)[:, None]
        xx = jnp.arange(w, dtype=jnp.int32)[None, :]
        bi = jnp.arange(b, dtype=jnp.int32)[:, None, None]
        zero = jnp.zeros((b, h, w), jnp.int32)
        base = jnp.stack([zero + (xx * 255 // max(w - 1, 1) + bi * 7) % 256,
                          zero + (yy * 255 // max(h - 1, 1) + bi * 13) % 256,
                          zero + (xx + yy + bi * 29) % 256], axis=-1)
        noise = jax.random.randint(jax.random.key(seed), (b, h, w, 3), 0, 48)
        img = jnp.clip(base + noise, 0, 255).astype(jnp.uint8)
        box = ((yy < h // 4) & (xx < w // 4))[None, :, :, None]
        img = jnp.where(box, jnp.uint8(0), img)
        r0, r1 = h // 2, h // 2 + max(h // 8, 1)
        return img.at[:, r0:r1].set(jnp.broadcast_to(img[:, r0:r1, :1], (b, r1 - r0, w, 3)))

    with jax.default_device(device):
        return jax.jit(make)()


def check_mode(frames, mode: str, term_w: int, term_h: int,
               idx: tuple[int, ...]) -> str:
    """One cell-record mode on the device the frames live on: compile the
    batched step, fetch a slice of its records, emit it with the native
    emitter and compare with the oracle. Returns a report line."""
    import jax

    from asciichat_tpu.ops import cells
    from asciichat_tpu.render import emitter, oracle
    from asciichat_tpu.render import palette as pal
    from asciichat_tpu.render.pipeline import plan_render
    from asciichat_tpu.render.types import RenderMode, TerminalCapabilities

    b, h, w, _ = frames.shape
    half = mode.startswith("halfblock")
    caps = TerminalCapabilities(render_mode=RenderMode.HALF_BLOCK if half
                                else RenderMode.FOREGROUND)
    plan = plan_render(w, h, term_w, term_h, caps)
    ramp = jax.device_put(pal.char_index_ramp_array(pal.DEFAULT_PALETTE),
                          frames.sharding)
    t0 = time.perf_counter()
    compiled = cells.render_cells.lower(
        frames, ramp, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=mode).compile()
    compile_s = time.perf_counter() - t0
    records = compiled(frames, ramp)
    sel = np.asarray(idx)
    host = {k: np.ascontiguousarray(np.asarray(v[sel])) for k, v in records.items()}
    got = emitter.emit_frames(host, mode, pal.DEFAULT_PALETTE,
                              pad_w=plan.pad_w, pad_h=plan.pad_h)
    src = np.asarray(frames[sel])
    for j, i in enumerate(idx):
        want = oracle.render_mode(oracle.resize_image(src[j], plan.dst_w, plan.dst_h_px),
                                  mode, pal.DEFAULT_PALETTE)
        want = oracle.pad_frame_height(oracle.pad_frame_width(want, plan.pad_w), plan.pad_h)
        if got[j] != want:
            raise AssertionError(f"mode {mode}: frame {i} differs from the oracle")
    ma = compiled.memory_analysis()
    mem = ("memory_analysis: none" if ma is None else
           f"memory_analysis: argument {ma.argument_size_in_bytes} B, output "
           f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
           f"code {ma.generated_code_size_in_bytes} B")
    return (f"{mode:20s} {b}x{h}x{w} -> {plan.dst_w}x{plan.dst_h_px}px: "
            f"frames {list(idx)} byte-equal to the oracle; compile "
            f"{compile_s:.2f} s; {mem}")


# ---------------------------------------------------------------------------
# Phase 3


def room_groups() -> dict:
    """ROOM grouped by geometry the way the server groups receivers."""
    groups: dict[tuple, list[str]] = {}
    for _name, w, h, color, mode, filt in ROOM:
        groups.setdefault((w, h, color, mode), []).append(filt)
    return groups


def tick_args(frames: np.ndarray, w: int, h: int, color: str, mode: int,
              filters_: list[str], seed: int = 0):
    """(numpy args in tick_compute order, static kwargs) for one group."""
    from asciichat_tpu.models.server import plan_tick
    from asciichat_tpu.ops import audio as audio_ops
    from asciichat_tpu.ops import compositor, filters
    from asciichat_tpu.render import palette as pal

    n = len(frames)
    sizes = [(f.shape[1], f.shape[0]) for f in frames]
    plan = plan_tick(sizes, w, h, caps_for(color, mode), num_clients=len(filters_))
    rng = np.random.default_rng(seed)
    audio = rng.normal(0, 0.2, (n, audio_ops.AUDIO_FRAME_SAMPLES)).astype(np.float32)
    state = tuple(np.asarray(x) for x in audio_ops.MixerState.init(n, n).astuple())
    args = (frames, audio, np.ones(n, bool), state,
            pal.char_index_ramp_array(pal.DEFAULT_PALETTE),
            *filters.filter_params(filters_), *compositor.host_maps(plan.composite))
    static = {"mode": plan.render.mode, "dst_h": plan.render.dst_h_px,
              "dst_w": plan.render.dst_w}
    return args, static


def run_tick(args, static, device, ticks: int = 2):
    """``ticks`` consecutive ticks on one device, mixer state carried."""
    import jax

    from asciichat_tpu.models.server import tick_compute

    step = jax.jit(lambda *a: tick_compute(*a, **static))
    frames, audio, active, state, *consts = jax.device_put(args, device)
    mixes = []
    for t in range(ticks):
        records, mix, state = step(frames, audio * (t + 1), active, state, *consts)
        mixes.append(np.asarray(mix))
    return {k: np.asarray(v) for k, v in records.items()}, np.stack(mixes)


def check_tick(frames: np.ndarray, device, ref_device) -> list[str]:
    lines = []
    for (w, h, color, mode), filts in room_groups().items():
        args, static = tick_args(frames, w, h, color, mode, filts)
        got_r, got_m = run_tick(args, static, device)
        want_r, want_m = run_tick(args, static, ref_device)
        for k in want_r:
            np.testing.assert_array_equal(got_r[k], want_r[k],
                                          err_msg=f"record {k!r} {w}x{h}")
        diff = float(np.max(np.abs(got_m - want_m)))
        lines.append(f"  {w}x{h} {color} {static['mode']} x{len(filts)}: records "
                     f"byte-equal {sorted(got_r)}; audio max |diff| {diff:.3g}")
        np.testing.assert_allclose(got_m, want_m, rtol=AUDIO_RTOL, atol=AUDIO_ATOL)
    return lines


# ---------------------------------------------------------------------------
# Phase 4


def resize_onehot(frames, dst_h: int, dst_w: int):
    """The resize as two one-hot bf16 matrix products with float32
    accumulation: exact, since uint8 values are exact in bf16 and each
    output has one non-zero product. Kept here only as the formulation the
    served gather is measured against."""
    import jax.numpy as jnp

    from asciichat_tpu.utils.aspect import resize_indices

    src_h, src_w = frames.shape[-3], frames.shape[-2]
    sy = jnp.zeros((dst_h, src_h), jnp.bfloat16).at[
        np.arange(dst_h), resize_indices(src_h, dst_h)].set(1)
    sx = jnp.zeros((dst_w, src_w), jnp.bfloat16).at[
        np.arange(dst_w), resize_indices(src_w, dst_w)].set(1)
    a = jnp.einsum("yh,...hwc->...ywc", sy, frames.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    out = jnp.einsum("xw,...ywc->...yxc", sx, a.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    return out.astype(frames.dtype)


def resize_shapes(frames_batch, tick_frames, mirror_frames) -> dict:
    """name -> (frames, mode, dst_h_px, dst_w) for the three cells."""
    from asciichat_tpu.render.pipeline import plan_render
    from asciichat_tpu.render.types import RenderMode, TerminalCapabilities

    out = {}
    for name, f, tw, th, rm, mode in (
            ("batch", frames_batch, TERM_W, TERM_H, RenderMode.FOREGROUND, "truecolor_fg"),
            ("tick", tick_frames, TERM_W, TERM_H, RenderMode.HALF_BLOCK, "halfblock_truecolor"),
            ("mirror", mirror_frames, 80, 24, RenderMode.FOREGROUND, "truecolor_fg")):
        plan = plan_render(f.shape[2], f.shape[1], tw, th, TerminalCapabilities(render_mode=rm))
        out[name] = (f, mode, plan.dst_h_px, plan.dst_w)
    return out


def time_resize(shapes: dict, iters: int = 20, reps: int = 5) -> list[str]:
    """Time the jitted render step (resize + cell records) with each resize
    formulation, warm, in alternating turns; check both give equal records."""
    import jax

    from asciichat_tpu.ops import cells, pixel
    from asciichat_tpu.render import palette as pal

    lines = []
    for name, (frames, mode, dh, dw) in shapes.items():
        ramp = jax.device_put(pal.char_index_ramp_array(pal.DEFAULT_PALETTE),
                              frames.sharding)
        steps = {}
        for method, resize in (("gather", pixel.resize_nn), ("onehot", resize_onehot)):
            fn = jax.jit(lambda f, r, resize=resize: cells.records_for_mode(
                resize(f, dh, dw), mode, r))
            steps[method] = fn.lower(frames, ramp).compile()
        outs = {m: jax.block_until_ready(s(frames, ramp)) for m, s in steps.items()}
        for k in outs["gather"]:
            np.testing.assert_array_equal(np.asarray(outs["gather"][k]),
                                          np.asarray(outs["onehot"][k]))
        ms = {m: [] for m in steps}
        for rep in range(reps):
            order = list(steps) if rep % 2 == 0 else list(steps)[::-1]
            for m in order:
                t0 = time.perf_counter()
                for _ in range(iters):
                    r = steps[m](frames, ramp)
                jax.block_until_ready(r)
                ms[m].append((time.perf_counter() - t0) / iters * 1e3)
        desc = " ".join(
            f"{m} median {np.median(v):.4f} ms/step (min {min(v):.4f}, max {max(v):.4f})"
            for m, v in ms.items())
        lines.append(f"  {name} {tuple(frames.shape)} -> {dw}x{dh}px {mode}: {desc}")
    return lines


# ---------------------------------------------------------------------------
# four cards


def sharded_tick_check(frames: np.ndarray, devices, ref_device) -> str:
    """tick_compute over a clients mesh of ``devices`` with the resized
    batch constrained to the mesh (the dry run's resized_hook), against
    one device: records value-exact, audio within AUDIO_* tolerance."""
    import jax

    from asciichat_tpu.models.server import count_collectives, tick_compute
    from asciichat_tpu.parallel import mesh as meshlib

    mesh = meshlib.make_mesh(len(devices), devices=devices)
    shards = len(devices)
    pad = -len(frames) % shards
    frames = np.concatenate([frames, np.zeros((pad, *frames.shape[1:]), np.uint8)])
    w, h, color, mode = 203, 64, "truecolor", 2
    filts = [("none", "green", "cyan", "orange")[i % 4]
             for i in range(shards * max(1, 4 // shards))]
    args, static = tick_args(frames, w, h, color, mode, filts)
    sh_cl, rep = meshlib.client_sharding(mesh), meshlib.replicated(mesh)
    frames_a, audio, active, state, ramp, tint, fg, rb, on, *maps = args
    placed = (jax.device_put(frames_a, sh_cl), jax.device_put(audio, sh_cl),
              jax.device_put(active, sh_cl),
              tuple(jax.device_put(x, sh_cl) for x in state),
              jax.device_put(ramp, rep),
              *(jax.device_put(x, sh_cl) for x in (tint, fg, rb, on)),
              *(jax.device_put(m, rep) for m in maps))
    hook = meshlib.client_space_sharding(mesh)
    step = jax.jit(lambda *a: tick_compute(
        *a, **static,
        resized_hook=lambda r: jax.lax.with_sharding_constraint(r, hook)))
    compiled = step.lower(*placed).compile()
    collectives = count_collectives(compiled.as_text())
    records, mixes, _ = compiled(*placed)
    want_r, want_m = run_tick(args, static, ref_device, ticks=1)
    for k, v in records.items():
        np.testing.assert_array_equal(np.asarray(v), want_r[k],
                                      err_msg=f"sharded record {k!r}")
    np.testing.assert_allclose(np.asarray(mixes), want_m[0],
                               rtol=AUDIO_RTOL, atol=AUDIO_ATOL)
    return (f"sharded tick over mesh {dict(mesh.shape)} ({collectives} collectives) "
            f"== one device: records value-exact {sorted(records)}, audio within "
            f"rtol {AUDIO_RTOL}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="serve the room on a 4-GPU mesh and compare the sharded "
                         "tick with one GPU; nothing else")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    want_cards = 4 if args.four_cards else 1

    sys.path.insert(0, REPO)
    try:
        import asciichat_tpu
    except ImportError:
        asciichat_tpu = None
    if asciichat_tpu is None or not os.path.abspath(asciichat_tpu.__file__).startswith(REPO):
        say(json.dumps({"ok": False, "error": "not in a checkout of the repository"}))
        return 2

    # -- phase 0 ----------------------------------------------------------
    info = probe_devices()
    say(f"phase 0: devices {info['devices']} platform {info['platform']} "
        f"kind {info['kind']} count {info['count']}; jax {info['jax']} "
        f"jaxlib {info['jaxlib']}")
    if info["platform"] != "gpu" or info["count"] < want_cards:
        say(json.dumps({"ok": False, "error": f"need {want_cards} GPU(s), JAX "
                        f"found {info['count']} {info['platform']} device(s)"}))
        return 1
    cards = nvidia_smi()
    for line in cards:
        say(line)
    from asciichat_tpu.utils import jaxcache

    jaxcache.ensure()
    import jax

    say(f"phase 0: compile cache {jax.config.jax_compilation_cache_dir}")

    frames = room_frames(len(ROOM), UPLINK_H, UPLINK_W, args.seed)
    import importlib.util

    have_crypto = importlib.util.find_spec("cryptography") is not None
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        room = served_room(frames, work, encrypt=have_crypto)
    say(f"phase 1: served room, {len(ROOM)} CLI clients on the CPU, server on "
        f"{want_cards} GPU(s) ({time.perf_counter() - t0:.1f} s)")
    if not have_crypto:
        say("phase 1: encrypted client not run: the cryptography package is "
            "not installed")
    for line in check_room(room, frames,
                           {"clients": 4} if args.four_cards else None):
        say("phase 1: " + line)

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    if args.four_cards:
        say("four cards: " + sharded_tick_check(frames, jax.devices()[:4], gpu))
    else:
        t0 = time.perf_counter()
        batch = batch_frames(gpu, BATCH, SRC_H, SRC_W, args.seed)
        idx = (0, 1, BATCH // 2, BATCH - 1)
        from asciichat_tpu.ops import cells

        for mode in cells.MODES:
            say("phase 2: " + check_mode(batch, mode, TERM_W, TERM_H, idx))
        say(f"phase 2: all {len(cells.MODES)} modes byte-equal "
            f"({time.perf_counter() - t0:.1f} s)")

        for line in check_tick(frames, gpu, cpu):
            say("phase 3:" + line)
        say(f"phase 3: tick GPU == CPU; audio rtol {AUDIO_RTOL} atol {AUDIO_ATOL}")

        mirror = batch_frames(gpu, 1, 480, 640, args.seed + 1)
        shapes = resize_shapes(batch, jax.device_put(frames, gpu), mirror)
        say(f"phase 4: resize formulations on {cards[0]}")
        for line in time_resize(shapes):
            say("phase 4:" + line)

    dev = jax.devices()[0]
    say(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                           "kind": dev.device_kind,
                                           "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    code = 1
    try:
        code = main()
    except Exception as e:  # any phase failing fails the run
        import traceback

        traceback.print_exc()
        print(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}), flush=True)
    sys.exit(code)
