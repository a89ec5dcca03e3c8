"""Device-side ANSI byte emission (truecolor FG grammar) — a MEASURED
EXPERIMENT.

Kept out of the serving path: whether it beats the native host emitter on
the GPU is unmeasured (ROADMAP speed item 2). Phase 2 of the compaction
(variable-length per-cell chunks into one byte stream) needs per-element
dynamic addressing (a scatter or a searchsorted gather), the costly part of
any device formulation. A "device
formats, host compacts" split ships n*21 B/frame of chunks (6x the cell
records' D2H) to save host work the emitter does at memcpy speed.
tests/test_device_emit.py checks it byte-exact against the oracle on the CPU
and, under the ``chip`` marker, on the GPU.

The grammar expressed here (render/oracle.render_truecolor_fg; reference
image_print_color, scalar/foreground.c:195-308 + ansi.c:248-311) as a
PARALLEL program:

1. per-cell SGR decision: a cell emits `ESC[38;2;R;G;Bm` iff its color
   differs from the previous cell's in raster order (state crosses row
   boundaries; the first cell always emits) — a shift-compare, no scan
   needed because the decision depends only on the neighbor, not on
   accumulated state;
2. per-cell byte length: 10 + digits(R)+digits(G)+digits(B) for the SGR,
   + 1 glyph byte, + 1 for the row-separating '\n' (all rows but the
   last); lengths prefix-sum into byte offsets;
3. per-cell chunk materialization: each cell's <=21 bytes are computed
   positionally (digit bytes via place-value gathers — no leading zeros);
4. compaction: one vectorized searchsorted-gather places every output
   byte; a virtual trailing cell appends the frame's single `ESC[0m`.

Scope: ASCII (single-byte-glyph) palettes — the multi-byte UTF-8 bypass
(foreground.c:286-296) never triggers for them, which is exactly the
native emitter's all-ASCII specialization. UTF-8 palettes stay on the
host path. Output is a fixed worst-case buffer + actual byte length per
frame (variable-length results from fixed-shape kernels, SURVEY §7
"hard parts").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from asciichat_tpu.render import palette as pal

CMAX = 21  # worst per-cell bytes: ESC[38;2;RRR;GGG;BBBm (19) + glyph + \n
_PREFIX = np.frombuffer(b"\x1b[38;2;", dtype=np.uint8).astype(np.int32)
_RESET = np.frombuffer(b"\x1b[0m", dtype=np.uint8)


def ascii_glyph_table(palette: str = pal.DEFAULT_PALETTE) -> np.ndarray:
    """uint8[256] single-byte glyph per clamped luminance, or ValueError for
    palettes with multi-byte glyphs (those use the host emitter)."""
    tbl = pal.luminance_glyph_table(palette)
    if not (tbl[:, 0] == 1).all() or not (tbl[:, 1] < 128).all():
        raise ValueError(f"palette {palette!r} has multi-byte glyphs; "
                         "device emission supports ASCII palettes only")
    return tbl[:, 1].copy()


def _digits(v: jax.Array) -> jax.Array:
    return 1 + (v >= 10).astype(jnp.int32) + (v >= 100).astype(jnp.int32)


def _emit_one(rgb: jax.Array, luma: jax.Array, glyph_tbl: jax.Array,
              H: int, W: int):
    """One frame: rgb u8 [H,W,3], luma u8 [H,W] -> (bytes u8 [WORST], len)."""
    n = H * W
    px = rgb.reshape(n, 3).astype(jnp.int32)
    r, g, b = px[:, 0], px[:, 1], px[:, 2]
    glyph = jnp.take(glyph_tbl.astype(jnp.int32), luma.reshape(n).astype(jnp.int32))
    idx = jnp.arange(n, dtype=jnp.int32)

    # 1. SGR decision: change vs raster predecessor; first cell always
    changed = jnp.any(px != jnp.roll(px, 1, axis=0), axis=1)
    sgr = jnp.where(idx == 0, True, changed)

    dr, dg, db = _digits(r), _digits(g), _digits(b)
    sgr_len = jnp.where(sgr, 10 + dr + dg + db, 0)
    nl = ((idx + 1) % W == 0) & (idx != n - 1)
    cell_len = sgr_len + 1 + nl.astype(jnp.int32)

    # 2. offsets
    ends = jnp.cumsum(cell_len)  # inclusive
    offs = ends - cell_len  # exclusive
    total = ends[-1]

    # 3. chunk materialization [n, CMAX]
    j = jnp.arange(CMAX, dtype=jnp.int32)[None, :]  # [1, C]
    drc, dgc, dbc = dr[:, None], dg[:, None], db[:, None]
    sgrc = sgr[:, None]
    # place-value digit bytes, no leading zeros: emitted digit k (0-based,
    # most significant first) of a d-digit value v is place (k + 3 - d) of
    # [hundreds, tens, ones]
    D = jnp.stack([px // 100, (px // 10) % 10, px % 10], axis=2)  # [n,3,3]

    def digit_at(comp, start, d):
        k = j - start  # emitted digit index
        place = jnp.clip(k + 3 - d, 0, 2)
        return 48 + jnp.take_along_axis(
            D[:, comp, :], place, axis=1)

    prefix = jnp.asarray(_PREFIX)
    chunk = jnp.zeros((1, CMAX), jnp.int32) + 0
    # build with a reverse cascade of wheres (later conditions win)
    out = jnp.zeros((n, CMAX), jnp.int32)
    out = jnp.where(sgrc & (j < 7), prefix[jnp.clip(j, 0, 6)], out)
    out = jnp.where(sgrc & (j >= 7) & (j < 7 + drc),
                    digit_at(0, 7, drc), out)
    out = jnp.where(sgrc & (j == 7 + drc), 59, out)  # ';'
    out = jnp.where(sgrc & (j >= 8 + drc) & (j < 8 + drc + dgc),
                    digit_at(1, 8 + drc, dgc), out)
    out = jnp.where(sgrc & (j == 8 + drc + dgc), 59, out)
    out = jnp.where(sgrc & (j >= 9 + drc + dgc) & (j < 9 + drc + dgc + dbc),
                    digit_at(2, 9 + drc + dgc, dbc), out)
    out = jnp.where(sgrc & (j == 9 + drc + dgc + dbc), 109, out)  # 'm'
    out = jnp.where(j == sgr_len[:, None], glyph[:, None], out)
    out = jnp.where((j == sgr_len[:, None] + 1) & nl[:, None], 10, out)
    del chunk

    # virtual trailing cell: the frame's single ESC[0m (ansi_rle_finish)
    reset_row = jnp.zeros((1, CMAX), jnp.int32).at[0, :4].set(
        jnp.asarray(_RESET.astype(np.int32)))
    chunk_full = jnp.concatenate([out, reset_row], axis=0)  # [n+1, C]
    len_full = jnp.concatenate([cell_len, jnp.full((1,), 4, jnp.int32)])
    ends_full = jnp.concatenate([ends, (total + 4)[None]])
    total_out = total + 4

    # 4. compaction: out[k] = chunk of the cell whose byte range contains k
    worst = n * (CMAX - 1) + 4  # every cell at max length minus its pad slot
    k = jnp.arange(worst, dtype=jnp.int32)
    cell = jnp.searchsorted(ends_full, k, side="right").astype(jnp.int32)
    cell = jnp.minimum(cell, n)  # k >= total_out clamps into the reset row
    within = k - (ends_full[cell] - len_full[cell])
    within = jnp.clip(within, 0, CMAX - 1)
    flat = chunk_full.reshape(-1)
    data = flat[cell * CMAX + within]
    data = jnp.where(k < total_out, data, 0)
    return data.astype(jnp.uint8), total_out


@functools.partial(jax.jit, static_argnames=("H", "W"))
def emit_truecolor_fg(rgb: jax.Array, luma: jax.Array, glyph_tbl: jax.Array,
                      *, H: int, W: int):
    """Batched: rgb u8 [B,H,W,3], luma u8 [B,H,W], glyph_tbl u8 [256]
    -> (bytes u8 [B, WORST], lengths i32 [B]). bytes[i, :lengths[i]] is the
    byte-exact truecolor-FG frame (pre-padding)."""
    fn = lambda fr, lu: _emit_one(fr, lu, glyph_tbl, H, W)
    return jax.vmap(fn)(rgb, luma)


def emit_frames_device(records: dict, palette: str = pal.DEFAULT_PALETTE):
    """Convenience: truecolor_fg records -> list[bytes] via the device
    emitter (host slicing only). Used by tests and the bench gate."""
    rgb, luma = records["rgb"], records["luma"]
    B, H, W = luma.shape
    tbl = jnp.asarray(ascii_glyph_table(palette))
    data, lens = emit_truecolor_fg(jnp.asarray(rgb), jnp.asarray(luma), tbl,
                                   H=H, W=W)
    data_np = np.asarray(data)
    lens_np = np.asarray(lens)
    return [data_np[i, : lens_np[i]].tobytes() for i in range(B)]
