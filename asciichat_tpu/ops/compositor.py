"""N-client grid compositor: host layout planning + ONE device gather per tick.

Device re-expression of the reference server's per-client render path
(src/server/stream.c): the reference re-resizes and copies every source into
the composite with nested per-pixel C loops on every 60 fps tick per client
(stream.c:664-779). Here the control-flow-heavy part — grid scoring and
CONTAIN fitting — runs on the host ONLY when the layout changes (client
join/leave/resize), producing static gather maps; the per-tick device work is
a single batched gather ``composite[y,x] = frames[cidx[y,x], sy[y,x], sx[y,x]]``
that XLA fuses with the downstream ASCII render kernels.

Semantics ground truth:
- grid scoring:     calculate_optimal_grid_layout, stream.c:523-651
  (skip if empty_cells > cols or cell < 20x10 chars; utilization score with
  visual cell aspect cell_w/(cell_h*2))
- pixel space:      composite is width x (height*2) px — 1 char = 1x2 px for
  half-block vertical resolution (stream.c:673-679)
- CONTAIN fit:      +0.5f rounding, centering (cell-target)/2, cell + composite
  clipping, max 9 sources (stream.c:687-773)
- per-cell resize:  fixed-point 16.16 nearest neighbour (image_resize)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from asciichat_tpu.utils.aspect import CHAR_ASPECT, resize_indices

PIXELS_PER_CHAR_HEIGHT = 2
MAX_COMPOSITE_SOURCES = 9  # stream.c:687


def optimal_grid_layout(
    source_sizes: list[tuple[int, int]], term_w: int, term_h: int
) -> tuple[int, int]:
    """(cols, rows) maximizing utilization (stream.c:523-651). Sizes are (w, h)
    of the active video sources; terminal dims are in characters."""
    n = len(source_sizes)
    if n == 0:
        return 0, 0
    if n == 1:
        return 1, 1

    aspects = [np.float32(w) / np.float32(h) for w, h in source_sizes if h > 0]
    avg_aspect = np.float32(sum(aspects) / len(aspects)) if aspects else np.float32(1.6)

    best_cols, best_rows = 1, n
    best_util = np.float32(0.0)
    for cols in range(1, n + 1):
        rows = (n + cols - 1) // cols
        if cols * rows - n > cols:
            continue
        cell_w = term_w // cols
        cell_h = term_h // rows
        if cell_w < 20 or cell_h < 10:
            continue
        cell_area = cell_w * cell_h
        cell_visual_aspect = np.float32(cell_w) / (np.float32(cell_h) * CHAR_ASPECT)
        # the reference loops over sources here (stream.c:596-628) because
        # it fits each source's own aspect; this port deliberately scores
        # with the average aspect, so every term is identical and the
        # Σ(fw·fh)/(area·n) collapses to one fitted cell over one cell area
        if avg_aspect > cell_visual_aspect:
            fw = cell_w
            fh = int((cell_w / avg_aspect) / CHAR_ASPECT)
        else:
            fh = cell_h
            fw = int(cell_h * CHAR_ASPECT * avg_aspect)
        fw = min(fw, cell_w)
        fh = min(fh, cell_h)
        util = np.float32(fw * fh) / np.float32(cell_area)
        if util > best_util:
            best_util = util
            best_cols, best_rows = cols, rows
    return best_cols, best_rows


@dataclasses.dataclass(frozen=True, eq=False)
class CompositePlan:
    """Static gather maps for one (layout, source sizes, terminal)
    combination. eq=False: the fields are ndarrays, so the generated
    __eq__/__hash__ would raise at first use — identity semantics (plus
    the device_maps cache keyed on the instance) are the intent."""

    width_px: int
    height_px: int
    cols: int
    rows: int
    # gather maps int32 [height_px, width_px]; client -1 = background (black)
    client_idx: np.ndarray
    src_y: np.ndarray
    src_x: np.ndarray


def plan_composite(
    source_sizes: list[tuple[int, int]], term_w: int, term_h: int
) -> CompositePlan:
    """Build the composite gather maps (create_multi_source_composite,
    stream.c:664-779) for active sources with pixel sizes (w, h)."""
    comp_w = term_w
    comp_h = term_h * PIXELS_PER_CHAR_HEIGHT
    cols, rows = optimal_grid_layout(source_sizes, term_w, term_h)
    cidx = np.full((comp_h, comp_w), -1, dtype=np.int32)
    sy = np.zeros((comp_h, comp_w), dtype=np.int32)
    sx = np.zeros((comp_h, comp_w), dtype=np.int32)

    for i, (src_w, src_h) in enumerate(source_sizes[:MAX_COMPOSITE_SOURCES]):
        if cols == 0:
            break
        row = i // cols
        col = i % cols
        cell_w = comp_w // cols
        cell_h = comp_h // rows
        if cell_w <= 0 or cell_h <= 0:
            # degenerate layout (more sources than composite rows on a tiny
            # terminal): there is no pixel to draw this source into — skip
            # it instead of a divide-by-zero + silently all-black frames
            continue
        if src_w <= 0 or src_h <= 0:
            # a (0,0) source made src_aspect NaN and int(NaN) raised out of
            # the library; degenerate sources compose nothing, like the
            # zero-fit cases below
            continue
        src_aspect = np.float32(src_w) / np.float32(src_h)
        cell_aspect = np.float32(cell_w) / np.float32(cell_h)
        if src_aspect > cell_aspect:
            tw = cell_w
            th = int(np.float32(cell_w) / src_aspect + np.float32(0.5))
        else:
            th = cell_h
            tw = int(np.float32(cell_h) * src_aspect + np.float32(0.5))
        if tw <= 0 or th <= 0:
            # CONTAIN parity (stream.c:711): an extreme-aspect source whose
            # fitted extent rounds to 0 px composites NOTHING — clamping to
            # a 1-px strip would draw where the reference draws nothing
            continue

        cell_x0 = col * cell_w
        cell_y0 = row * cell_h
        x_pad = (cell_w - tw) // 2
        y_pad = (cell_h - th) // 2

        ry = resize_indices(src_h, th)
        rx = resize_indices(src_w, tw)

        # destination rect with cell + composite clipping (stream.c:752-773)
        for yy in range(th):
            dy = cell_y0 + y_pad + yy
            if dy < cell_y0 or dy > cell_y0 + cell_h - 1 or dy < 0 or dy >= comp_h:
                continue
            xs = np.arange(tw)
            dxs = cell_x0 + x_pad + xs
            ok = (dxs >= cell_x0) & (dxs <= cell_x0 + cell_w - 1) & (dxs >= 0) & (dxs < comp_w)
            cidx[dy, dxs[ok]] = i
            sy[dy, dxs[ok]] = ry[yy]
            sx[dy, dxs[ok]] = rx[xs[ok]]

    return CompositePlan(comp_w, comp_h, cols, rows, cidx, sy, sx)


def host_maps(plan: CompositePlan) -> tuple[np.ndarray, ...]:
    """Host (numpy) gather maps in device_maps order: (cidx, sy, sx, mask) —
    for callers that place them with their OWN sharding (the mesh path),
    which would otherwise pay a default-device upload plus a blocking D2H
    fetch just to re-upload replicated."""
    return (np.maximum(plan.client_idx, 0), plan.src_y, plan.src_x,
            (plan.client_idx >= 0)[..., None])


def device_maps(plan: CompositePlan) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Cached device copies of the gather maps: (cidx, sy, sx, mask).

    The maps only change on join/leave/resize; without caching every tick
    would re-upload ~4 int32 maps host->device (hundreds of KB at 60 fps).
    The cache lives ON the plan object (a frozen dataclass, so set via
    object.__setattr__) — keying a global dict by id(plan) would serve stale
    maps when CPython reuses the id of a collected plan."""
    cached = getattr(plan, "_device_maps", None)
    if cached is None:
        cached = tuple(jnp.asarray(a) for a in host_maps(plan))
        object.__setattr__(plan, "_device_maps", cached)
    return cached


def composite_gather(frames: jax.Array, plan: CompositePlan) -> jax.Array:
    """Device data plane: frames uint8 [C, H, W, 3] -> composite uint8
    [height_px, width_px, 3]. Background cells are black (image_clear)."""
    cidx, sy, sx, mask = device_maps(plan)
    gathered = frames[cidx, sy, sx]
    return jnp.where(mask, gathered, jnp.zeros_like(gathered))


def composite_reference(frames: np.ndarray, plan: CompositePlan) -> np.ndarray:
    """Host (numpy) reference for tests: same maps applied with numpy."""
    cidx = np.maximum(plan.client_idx, 0)
    out = frames[cidx, plan.src_y, plan.src_x]
    out[plan.client_idx < 0] = 0
    return out
