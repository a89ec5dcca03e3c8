"""--render-file: offline render of the ASCII stream to a video file.

The reference rasters its terminal output through libvterm + FreeType into
pixels and encodes via libav (lib/media/render/renderer.c:28,
lib/media/ffmpeg_encoder.c). Device reformulation: a GLYPH ATLAS is
rasterized once on the host (PIL's built-in bitmap font — the FreeType-role
dependency this environment has), and per frame ONE fused device kernel
gathers each cell's glyph bitmap from the atlas and colors it with the
cell's fg record — real character shapes, batched on the device, no per-cell
host loops. Half-block cells render their true top/bottom colors (the '▀'
raster IS two color blocks). Frames stream to Y4M (YCbCr 4:4:4, BT.601
full-range) or any container via the ffmpeg CLI when present.
"""

from __future__ import annotations

import functools
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from asciichat_tpu.ops import cells as cells_mod
from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.pipeline import AsciiRenderer, plan_render
from asciichat_tpu.render.types import TerminalCapabilities


@functools.lru_cache(maxsize=1)
def glyph_atlas() -> tuple[np.ndarray, int, int]:
    """-> (atlas uint8 [96, gh, gw] ink coverage for ASCII 32..127, gh, gw).
    Rasterized once with PIL's built-in bitmap font (the FreeType analog)."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    # cell size: the widest/tallest glyph in the printable range
    gw = gh = 0
    for code in range(32, 128):
        box = font.getbbox(chr(code))
        gw = max(gw, box[2])
        gh = max(gh, box[3])
    atlas = np.zeros((96, gh, gw), np.uint8)
    for code in range(32, 128):
        img = Image.new("L", (gw, gh), 0)
        ImageDraw.Draw(img).text((0, 0), chr(code), fill=255, font=font)
        atlas[code - 32] = np.asarray(img, np.uint8)
    return atlas, gh, gw


@jax.jit
def raster_glyphs(fg: jax.Array, glyph_idx: jax.Array, atlas: jax.Array) -> jax.Array:
    """fg uint8 [B,H,W,3] + glyph_idx int32 [B,H,W] (atlas rows) ->
    uint8 [B, H*gh, W*gw, 3]: each cell is its glyph's ink coverage times the
    cell color on black, the terminal-on-black appearance the reference's
    FreeType raster produces."""
    bitmaps = jnp.take(atlas, glyph_idx, axis=0)  # [B,H,W,gh,gw]
    px = (fg.astype(jnp.int32)[:, :, :, None, None, :]
          * bitmaps.astype(jnp.int32)[..., None]) // 255
    b, h, w, gh, gw, _ = px.shape
    return (px.transpose(0, 1, 3, 2, 4, 5)
              .reshape(b, h * gh, w * gw, 3).astype(jnp.uint8))


@functools.lru_cache(maxsize=16)
def _glyph_index_tables(palette: str) -> tuple[np.ndarray, np.ndarray]:
    """Per-palette host tables mapping records to atlas rows:
    luma_to_atlas[256] (truecolor: glyph by luminance) and
    key_to_atlas[64] (mono: glyph by palette run key)."""
    def to_atlas(entry: bytes) -> int:
        ch = entry[1] if entry[0] >= 1 else 0x20  # first byte of the glyph
        return (ch - 32) if 32 <= ch < 128 else 95  # non-ASCII -> block-ish DEL

    luma_tab = pal.luminance_glyph_table(palette)
    mono_tab = pal.mono_glyph_table(palette)
    luma_to_atlas = np.array([to_atlas(bytes(luma_tab[i])) for i in range(256)],
                             np.int32)
    key_to_atlas = np.array([to_atlas(bytes(mono_tab[i])) for i in range(64)],
                            np.int32)
    return luma_to_atlas, key_to_atlas


def _xterm256_rgb() -> np.ndarray:
    """[256, 3] uint8 xterm palette — unpacked from web/ansiparse.xterm256,
    the ONE copy of the cube/gray-ramp formula (a second local copy here
    could silently drift from the parser twin's)."""
    from asciichat_tpu.web.ansiparse import xterm256

    packed = np.array([xterm256(n) for n in range(256)], np.uint32)
    return np.stack([(packed >> 16) & 255, (packed >> 8) & 255, packed & 255],
                    axis=-1).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("mode", "scale", "key_max"))
def cells_to_pixels(records: dict, mode: str, scale: int = 8,
                    key_max: int = 63) -> jax.Array:
    """Block-color fallback: cell records -> uint8 RGB frames. EVERY render
    mode maps here (the common non-truecolor terminals must be able to
    --render-file too): half-block rows are the glyph itself; quantized
    modes resolve their palette index to RGB; glyph modes approximate with
    ink coverage (glyph-accurate rasters live in records_to_pixels)."""
    if mode in ("halfblock_truecolor", "halfblock_mono"):
        top, bot = records["top"].astype(jnp.uint8), records["bot"].astype(jnp.uint8)
        px = jnp.stack([top, bot], axis=2)  # [B, R, 2, W, 3]
        b, r, _, w, _ = px.shape
        px = px.reshape(b, r * 2, w, 3)
    elif mode in ("halfblock_256", "halfblock_16"):
        table = jnp.asarray(_xterm256_rgb())
        top = jnp.take(table, records["fg"].astype(jnp.int32), axis=0)
        bot = jnp.take(table, records["bg"].astype(jnp.int32), axis=0)
        vis = (1 - records["transparent"].astype(jnp.uint8))[..., None]
        px = jnp.stack([top * vis, bot * vis], axis=2).astype(jnp.uint8)
        b, r, _, w, _ = px.shape
        px = px.reshape(b, r * 2, w, 3)
    elif mode in ("truecolor_fg", "truecolor_fg_utf8",
                  "16color_dithered", "16color_dithered_bg"):
        rgb = records["rgb"].astype(jnp.int32)
        cov = records["luma"].astype(jnp.int32)[..., None]
        px = ((rgb * cov) // 255).astype(jnp.uint8)  # ink-coverage approx
    elif mode == "256color":
        table = jnp.asarray(_xterm256_rgb())
        rgb = jnp.take(table, records["color"].astype(jnp.int32), axis=0).astype(jnp.int32)
        cov = records["luma"].astype(jnp.int32)[..., None]
        px = ((rgb * cov) // 255).astype(jnp.uint8)
    elif mode == "16color":
        table = jnp.asarray(_xterm256_rgb())
        rgb = jnp.take(table, records["color"].astype(jnp.int32), axis=0).astype(jnp.int32)
        # key is a PALETTE char index (0..char_count-1, ops/pixel.mono_keys),
        # not a 0..63 luma bucket: //63 capped a pure-white pixel at 35%
        # brightness for the standard palette (key_max = char_count-1)
        cov = jnp.clip(records["key"].astype(jnp.int32) * 255 // key_max,
                       0, 255)[..., None]
        px = ((rgb * cov) // 255).astype(jnp.uint8)
    elif mode == "mono":
        key = records["key"].astype(jnp.int32)
        v = jnp.clip(key * 255 // key_max, 0, 255).astype(jnp.uint8)
        px = jnp.stack([v, v, v], axis=-1)
    else:
        raise ValueError(f"render-file unsupported for mode {mode!r}")
    # nearest upscale so cells are visible blocks; half-block rows are
    # already 2 px per cell, so they take half the vertical repeat (never
    # 0: scale=1 must not produce a zero-height frame)
    vscale = max(1, scale // 2) if mode.startswith("halfblock") else scale
    px = jnp.repeat(jnp.repeat(px, vscale, axis=-3), scale, axis=-2)
    return px


def records_to_pixels(records: dict, mode: str, palette: str,
                      scale: int = 8) -> jax.Array:
    """Glyph-accurate raster for glyph modes (atlas gather on device);
    block colors for half-block modes."""
    if mode in ("truecolor_fg", "mono"):
        atlas, luma_dev, key_dev = _glyph_device_tables(palette)
        if mode == "truecolor_fg":
            gidx = jnp.take(luma_dev, records["luma"].astype(jnp.int32))
            fg = records["rgb"].astype(jnp.uint8)
        else:
            gidx = jnp.take(key_dev, records["key"].astype(jnp.int32))
            fg = jnp.full((*records["key"].shape, 3), 204, jnp.uint8)  # grey text
        return raster_glyphs(fg, gidx, atlas)
    key_max = max(1, pal.get_palette_cache(palette).char_count - 1)
    return cells_to_pixels(records, mode, scale, key_max=key_max)


@functools.lru_cache(maxsize=16)
def _glyph_device_tables(palette: str):
    """Device-resident atlas + index tables, uploaded ONCE per palette —
    the render loop calls records_to_pixels per frame, and re-issuing the
    constant uploads would cost several H2D dispatches per frame."""
    atlas_np, _gh, _gw = glyph_atlas()
    luma_to_atlas, key_to_atlas = _glyph_index_tables(palette)
    return (jnp.asarray(atlas_np), jnp.asarray(luma_to_atlas),
            jnp.asarray(key_to_atlas))


@jax.jit
def rgb_to_ycbcr444(rgb: jax.Array) -> jax.Array:
    """BT.601 full-range integer RGB -> YCbCr (for Y4M C444)."""
    px = rgb.astype(jnp.int32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = jnp.clip(128 + ((-43 * r - 85 * g + 128 * b + 128) >> 8), 0, 255)
    cr = jnp.clip(128 + ((128 * r - 107 * g - 21 * b + 128) >> 8), 0, 255)
    return jnp.stack([y, cb, cr], axis=-1).astype(jnp.uint8)


class NativeRecorder:
    """Container recording on the system libavformat/libavcodec
    (lib/media/ffmpeg_encoder.c analog): RGB frames -> H.265 in any
    container the extension names (.mp4/.mkv/...)."""

    def __init__(self, path: str, width: int, height: int, fps: int = 30,
                 crf: int = 28, audio_rate: int = 0):
        import ctypes

        from asciichat_tpu.runtime import codecs

        self._lib = codecs._avshim()  # raises CodecUnavailable when absent
        c = ctypes
        self._ct = c
        if not hasattr(self._lib, "_rec_decl"):
            self._lib.ac_rec_open.restype = c.c_void_p
            self._lib.ac_rec_open.argtypes = [c.c_char_p] + [c.c_int] * 5
            self._lib.ac_rec_frame.restype = c.c_int
            self._lib.ac_rec_frame.argtypes = [c.c_void_p, c.c_char_p]
            self._lib.ac_rec_audio.restype = c.c_int
            self._lib.ac_rec_audio.argtypes = [c.c_void_p,
                                               c.POINTER(c.c_float), c.c_long]
            self._lib.ac_rec_close.restype = c.c_int
            self._lib.ac_rec_close.argtypes = [c.c_void_p]
            self._lib._rec_decl = True
        self._h = self._lib.ac_rec_open(path.encode(), width, height, fps,
                                        crf, audio_rate)
        if not self._h:
            from asciichat_tpu.runtime.codecs import CodecUnavailable

            raise CodecUnavailable(f"cannot open recorder for {path!r}")
        self.width, self.height = width, height

    def write_rgb(self, frame: np.ndarray) -> None:
        if frame.shape != (self.height, self.width, 3):
            # ac_rec_frame's sws_scale reads width*3 x height bytes
            # unconditionally: a smaller frame (source resolution changed
            # mid-stream) is a native heap over-read, not a Python error
            raise ValueError(
                f"frame {frame.shape} != opened {(self.height, self.width, 3)}")
        if self._lib.ac_rec_frame(
            self._h, np.ascontiguousarray(frame, np.uint8).tobytes()
        ) != 0:
            raise RuntimeError("recorder encode/mux failed")

    def write_audio(self, samples: np.ndarray) -> None:
        """Mono float samples onto the AAC track (ffmpeg_encoder.c audio
        mux role)."""
        buf = np.ascontiguousarray(samples, np.float32)
        if self._lib.ac_rec_audio(
            self._h, buf.ctypes.data_as(self._ct.POINTER(self._ct.c_float)),
            len(buf),
        ) != 0:
            raise RuntimeError("audio encode/mux failed")

    def close(self) -> None:
        if self._h:
            rc = self._lib.ac_rec_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError("recorder flush/trailer failed "
                                   "(container may be truncated)")


class Y4MWriter:
    """Minimal YUV4MPEG2 writer, C444 colorspace."""

    def __init__(self, path: str, width: int, height: int, fps: int = 30):
        self.width, self.height = width, height
        self.f = open(path, "wb")
        # XCOLORRANGE=FULL: rgb_to_ycbcr444 emits full-range BT.601; without
        # the tag every consumer (incl. our own ffmpeg transcode) assumes
        # limited range and crushes blacks / clips whites
        self.f.write(
            f"YUV4MPEG2 W{width} H{height} F{fps}:1 Ip A1:1 C444 "
            f"XCOLORRANGE=FULL\n".encode()
        )

    def write(self, ycbcr: np.ndarray) -> None:
        if ycbcr.shape != (self.height, self.width, 3):
            # raw planes under a fixed-size header: a resized later frame
            # silently desyncs every following frame in the stream
            raise ValueError(
                f"frame {ycbcr.shape} != opened {(self.height, self.width, 3)}")
        self.f.write(b"FRAME\n")
        # planar: all Y, all Cb, all Cr
        self.f.write(np.ascontiguousarray(ycbcr[..., 0]).tobytes())
        self.f.write(np.ascontiguousarray(ycbcr[..., 1]).tobytes())
        self.f.write(np.ascontiguousarray(ycbcr[..., 2]).tobytes())

    def close(self) -> None:
        self.f.close()


def render_to_file(
    source,
    out_path: str,
    caps: TerminalCapabilities,
    width: int,
    height: int,
    palette: str,
    max_frames: int = 300,
    fps: int = 30,
    scale: int = 8,
    audio_source=None,
    audio_rate: int = 48_000,
) -> int:
    """Offline render loop: source frames -> cell records -> glyph-rastered
    pixel frames -> Y4M, or any container via the native libavformat
    recorder (.mp4/.mkv/...; ffmpeg-CLI transcode as the last fallback)."""
    renderer = AsciiRenderer(palette)
    use_native = not out_path.endswith(".y4m")
    recorder = None
    y4m_path = out_path if out_path.endswith(".y4m") else out_path + ".y4m"
    # H.265/mp4 encoders are yuv420p (avshim ac_rec_open): odd glyph-raster
    # dims (font-dependent cell size x caller scale) would fail the encode —
    # after every frame rendered. Pad to even ONCE, for every container path
    # (a .y4m deliverable keeps exact dims; C444 has no evenness rule).
    pad_even = not out_path.endswith(".y4m")

    writer = None
    rendered = 0
    fallback_audio: list[np.ndarray] = []
    try:
        for _ in range(max_frames):
            frame = source.read()
            if frame is None:
                break
            frame = np.asarray(frame)
            plan = plan_render(frame.shape[1], frame.shape[0], width, height, caps)
            records = renderer.cells_for_plan(jnp.asarray(frame[None]), plan)
            px = records_to_pixels(records, plan.mode, palette, scale)
            if pad_even and ((px.shape[1] | px.shape[2]) & 1):
                px = jnp.pad(px, ((0, 0), (0, px.shape[1] & 1),
                                  (0, px.shape[2] & 1), (0, 0)))
            if use_native and writer is None:
                if recorder is None:
                    from asciichat_tpu.runtime.codecs import CodecUnavailable

                    try:
                        recorder = NativeRecorder(
                            out_path, px.shape[2], px.shape[1], fps,
                            audio_rate=audio_rate if audio_source else 0)
                    except CodecUnavailable:
                        use_native = False
                if recorder is not None:
                    np_px = np.asarray(px)[0]
                    recorder.write_rgb(np_px)
                    if audio_source is not None:
                        recorder.write_audio(audio_source.read(audio_rate // fps))
                    rendered += 1
                    continue
            ycbcr = np.asarray(rgb_to_ycbcr444(px))[0]
            if writer is None:
                writer = Y4MWriter(y4m_path, ycbcr.shape[1], ycbcr.shape[0], fps)
            writer.write(ycbcr)
            if audio_source is not None:
                # the fallback container has no audio mux; keep the samples
                # so the ffmpeg-CLI transcode can carry the requested track
                # instead of silently delivering a mute file
                fallback_audio.append(
                    np.asarray(audio_source.read(audio_rate // fps), np.float32))
            rendered += 1
    finally:
        # always flush + write trailers: a mid-render error must not leak
        # the native contexts or leave an unplayable container behind. A
        # close() failure must not MASK an in-flight render error (the root
        # cause) — it only propagates when nothing else is already raising.
        import sys as _sys

        in_flight = _sys.exc_info()[0] is not None
        for closer in (recorder, writer):
            if closer:
                try:
                    closer.close()
                except Exception:
                    if not in_flight:
                        raise
                    from asciichat_tpu.utils.logsys import get_logger

                    get_logger("renderfile").warning(
                        "close failed while handling a render error",
                        exc_info=True)
    if writer and out_path != y4m_path:
        if shutil.which("ffmpeg"):
            cmd = ["ffmpeg", "-y", "-v", "error", "-i", y4m_path]
            wav_path = None
            if fallback_audio:
                wav_path = out_path + ".wav"
                _write_wav(wav_path, np.concatenate(fallback_audio), audio_rate)
                cmd += ["-i", wav_path, "-shortest"]
            subprocess.run(cmd + [out_path], check=True)
            os.remove(y4m_path)  # intermediate, not a deliverable
            if wav_path:
                os.remove(wav_path)
        else:
            # neither libavcodec nor the ffmpeg CLI can produce the asked-for
            # container: FAIL LOUDLY instead of reporting success while
            # out_path does not exist; the raw frames are preserved
            raise RuntimeError(
                f"no encoder available to produce {out_path!r}; raw frames "
                f"kept at {y4m_path!r} (install ffmpeg or libavcodec)")
    elif fallback_audio:
        from asciichat_tpu.utils.logsys import get_logger

        get_logger("renderfile").warning(
            "Y4M carries no audio track: the requested audio was dropped "
            "(ask for .mp4/.mkv to keep it)")
    return rendered


def _write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """Mono float32 [-1,1] -> 16-bit PCM WAV (the transcode side-channel)."""
    import wave

    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
