"""Batched per-pixel device ops: resize, luma, quantizers, glyph keys.

These are the device re-expression of the reference's per-frame SIMD kernels
(lib/video/ascii/{scalar,neon,avx2}/*, lib/video/rgba/image.c): instead of
16-pixel vector lanes inside one frame, every op is a fused elementwise map
over a batch ``uint8 [B, H, W, 3]`` resident in device memory, compiled by
XLA. All arithmetic is exact int32 so the resulting cell records reproduce the
C renderers bit-for-bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from asciichat_tpu.utils.aspect import resize_indices

# 16-color ANSI palette (lib/video/terminal/ansi.c:442-459)
ANSI16_RGB = np.array(
    [
        (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
        (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
        (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
        (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
    ],
    dtype=np.int32,
)


def resize_nn(frames: jax.Array, dst_h: int, dst_w: int) -> jax.Array:
    """Fixed-point 16.16 nearest-neighbour resize (image.c:267-328).

    frames: uint8 [..., H, W, C]. Index maps depend only on static shapes and
    are precomputed on host; the resize is two constant-index gathers, which
    XLA fuses into the consumers of the resized batch. A one-hot bf16
    matrix-product formulation (exact, one non-zero product per output) was
    measured against this gather on the H100; see ARCHITECTURE.md.
    """
    src_h, src_w = frames.shape[-3], frames.shape[-2]
    if (src_h, src_w) == (dst_h, dst_w):
        return frames
    sy = jnp.asarray(resize_indices(src_h, dst_h))
    sx = jnp.asarray(resize_indices(src_w, dst_w))
    return jnp.take(jnp.take(frames, sy, axis=-3), sx, axis=-2)


def luminance(frames: jax.Array) -> jax.Array:
    """ITU-R BT.601 integer luma with rounding: (77R+150G+29B+128)>>8,
    clamped to uint8 (scalar/foreground.c:93-96). Returns int32 [..., H, W]."""
    px = frames.astype(jnp.int32)
    y = (77 * px[..., 0] + 150 * px[..., 1] + 29 * px[..., 2] + 128) >> 8
    return jnp.clip(y, 0, 255)


def mono_keys(frames: jax.Array, char_index_ramp: jax.Array) -> jax.Array:
    """Mono run key: char_index_ramp[luma >> 2] (foreground.c:97-98). uint8."""
    return jnp.take(char_index_ramp.astype(jnp.uint8), luminance(frames) >> 2)


def quantize_256(frames: jax.Array) -> jax.Array:
    """6x6x6 cube + grayscale ramp (ansi.c:360-379). uint8 [..., H, W]."""
    px = frames.astype(jnp.int32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    avg = (r + g + b) // 3
    gray_diff = jnp.abs(r - avg) + jnp.abs(g - avg) + jnp.abs(b - avg)
    gray = 232 + (avg * 23) // 255
    cube = 16 + (r * 5 // 255) * 36 + (g * 5 // 255) * 6 + (b * 5 // 255)
    return jnp.where(gray_diff < 30, gray, cube).astype(jnp.uint8)


def quantize_16(frames: jax.Array) -> jax.Array:
    """Nearest of 16 ANSI colors, first-wins ties (ansi.c:437-477). uint8."""
    px = frames.astype(jnp.int32)
    pal = jnp.asarray(ANSI16_RGB)  # [16, 3]
    d = (
        (px[..., None, 0] - pal[:, 0]) ** 2
        + (px[..., None, 1] - pal[:, 1]) ** 2
        + (px[..., None, 2] - pal[:, 2]) ** 2
    )
    return jnp.argmin(d, axis=-1).astype(jnp.uint8)


def halfblock_split(frames: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Pair 2 pixel rows per cell (halfblock.c:71-88): returns (top, bot),
    each [..., ceil(H/2), W, C]; odd height duplicates the last row."""
    h = frames.shape[-3]
    if h % 2:
        frames = jnp.concatenate([frames, frames[..., -1:, :, :]], axis=-3)
    top = frames[..., 0::2, :, :]
    bot = frames[..., 1::2, :, :]
    return top, bot


def flip(frames: jax.Array, flip_x: bool = False, flip_y: bool = False) -> jax.Array:
    """Horizontal/vertical mirror (session display steps, display.c:549-592)."""
    if flip_x:
        frames = jnp.flip(frames, axis=-2)
    if flip_y:
        frames = jnp.flip(frames, axis=-3)
    return frames


@functools.partial(jax.jit, static_argnames=("levels",))
def quantize_color_levels(frames: jax.Array, levels: int) -> jax.Array:
    """quantize_color (foreground.c:141-156): floor to 256/levels steps.

    The reference rejects invalid level counts (foreground.c:141-156);
    levels > 256 would make step 0 and integer division-by-zero on device
    returns implementation-defined garbage SILENTLY, so guard here."""
    if not 0 < levels <= 256:
        raise ValueError(f"levels must be in 1..256, got {levels}")
    step = 256 // levels
    px = frames.astype(jnp.int32)
    return ((px // step) * step).astype(jnp.uint8)


# Bayer 4x4 matrix flattened the way the reference's NEON path consumes it:
# a 16-entry table indexed by the ROW-RELATIVE column & 15 (neon/common.c:371
# with pixel_offset = x from the row loop, neon/color.c) — not a 2-D spatial
# lookup. Kept as numpy: a module-level device array would initialize the
# JAX backend at import time.
_BAYER16 = np.array([0, 8, 2, 10, 12, 4, 14, 6, 3, 11, 1, 9, 15, 7, 13, 5],
                    np.int32)


@functools.partial(jax.jit, static_argnames=("strength",))
def ordered_dither(rgb: jax.Array, strength: int = 0) -> jax.Array:
    """Ordered (Bayer) dithering before 256-color quantization — the exact
    integer semantics of apply_ordered_dither (neon/common.c:369-397):
    channel c at column x gets saturating += (bayer[(x+c)&15] * strength)
    >> 4, identical for every row. The PRODUCTION reference calls this with
    strength=0 (disabled "in speed mode", common.c:400-402), so the
    byte-exact path never applies it; strength>0 reproduces the reference's
    optional longer-run behavior as one fused elementwise op."""
    if strength == 0:
        return rgb
    w = rgb.shape[-2]
    pos = jnp.arange(w, dtype=jnp.int32)[:, None] + jnp.arange(3, dtype=jnp.int32)
    dither = (jnp.asarray(_BAYER16)[pos & 15] * strength) >> 4  # [W, 3]
    return jnp.clip(rgb.astype(jnp.int32) + dither, 0, 255).astype(jnp.uint8)
