"""Fused batched frame -> cell-record pipelines (one jitted graph per mode).

The reference renders one frame at a time through scalar/SIMD loops
(lib/video/ascii/ascii.c:194 -> image_print_with_capabilities). Here the whole
batch of frames is pushed through ONE jitted XLA graph per renderer mode:
resize gather + luma + quantize + glyph-key mapping all fuse into a single
memory-bandwidth-bound kernel. The outputs are fixed-shape "cell records" — the
minimal per-cell data the (inherently sequential) ANSI byte grammar needs —
which the host emitter (native/emitter.cpp or render/oracle.py) walks to
produce byte-exact frames.

Record schemas per mode (SURVEY.md A.2 grammars):
  mono:                key u8 [B,H,W]                 (palette run key)
  truecolor_fg:        rgb u8 [B,H,W,3], luma u8      (SGR on change + glyph)
  256color:            color u8, luma u8              (SGR every px)
  16color:             color u8, key u8
  16color_dithered*:   rgb u8 [B,H,W,3], luma u8      (FS dither is sequential
                                                       -> host emitter)
  halfblock_truecolor: top u8 [B,R,W,3], bot u8
  halfblock_256/16:    fg u8 [B,R,W], bg u8, transparent u8 (raw all-black)
  halfblock_mono:      top u8 [B,R,W,3], bot u8       (runs key on exact RGB)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from asciichat_tpu.ops import pixel
from asciichat_tpu.render import palette as pal

RecordDict = dict[str, jax.Array]

MODES = (
    "mono",
    "truecolor_fg",
    "256color",
    "16color",
    "16color_dithered",
    "16color_dithered_bg",
    "halfblock_truecolor",
    "halfblock_256",
    "halfblock_16",
    "halfblock_mono",
)


def records_for_mode(resized: jax.Array, mode: str, ramp: jax.Array) -> RecordDict:
    """resized: uint8 [B, Hpx, W, 3] (already at renderer pixel dims).

    Public: models/server.render_compute builds records from its own
    resized batch (it inserts a sharding hook between resize and here), so
    this is cross-module API, not a private helper."""
    if mode == "mono":
        return {"key": pixel.mono_keys(resized, ramp)}
    if mode == "truecolor_fg":
        return {"rgb": resized, "luma": pixel.luminance(resized).astype(jnp.uint8)}
    if mode == "256color":
        return {
            "color": pixel.quantize_256(resized),
            "luma": pixel.luminance(resized).astype(jnp.uint8),
        }
    if mode == "16color":
        return {"color": pixel.quantize_16(resized), "key": pixel.mono_keys(resized, ramp)}
    if mode in ("16color_dithered", "16color_dithered_bg"):
        # Floyd-Steinberg error diffusion is raster-sequential in both x and y
        # (ansi.c:511-583); device ships resized RGB + luma, host emitter dithers.
        return {"rgb": resized, "luma": pixel.luminance(resized).astype(jnp.uint8)}
    if mode == "halfblock_truecolor" or mode == "halfblock_mono":
        top, bot = pixel.halfblock_split(resized)
        return {"top": top, "bot": bot}
    if mode in ("halfblock_256", "halfblock_16"):
        top, bot = pixel.halfblock_split(resized)
        quant = pixel.quantize_256 if mode == "halfblock_256" else pixel.quantize_16
        transparent = jnp.logical_and(
            jnp.all(top == 0, axis=-1), jnp.all(bot == 0, axis=-1)
        ).astype(jnp.uint8)
        return {"fg": quant(top), "bg": quant(bot), "transparent": transparent}
    raise ValueError(f"unknown mode {mode!r}")


@functools.partial(jax.jit, static_argnames=("dst_h", "dst_w", "mode"))
def render_cells(
    frames: jax.Array, ramp: jax.Array, *, dst_h: int, dst_w: int, mode: str
) -> RecordDict:
    """Batched frames uint8 [B, Hs, Ws, 3] -> cell records at (dst_h px, dst_w).

    dst_h is in PIXEL rows (already doubled for half-block modes, matching
    ascii_convert_with_capabilities, ascii.c:229-232).
    """
    resized = pixel.resize_nn(frames, dst_h, dst_w)
    return records_for_mode(resized, mode, ramp)




def ramp_for_palette(palette: str) -> jax.Array:
    return jnp.asarray(pal.char_index_ramp_array(palette))


def records_to_numpy(records: RecordDict) -> dict[str, np.ndarray]:
    """Device -> host transfer of the record dict (one blocking fetch).

    Forces C-contiguity: a backend may hand back strided views, and a
    non-contiguous record array makes the emitter re-copy it on EVERY emit
    call (~3x slowdown measured at 203x64x32)."""
    return {
        k: np.ascontiguousarray(v) for k, v in jax.device_get(records).items()
    }
