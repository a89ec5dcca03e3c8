"""The fast conversion pipeline: batched frames -> byte-exact ANSI frames.

Device equivalent of ascii_convert_with_capabilities (ascii.c:194-387):
geometry on host (static per shape), per-pixel math as ONE jitted XLA graph on
device (ops/cells.py), byte grammar on host via the native emitter. Unlike the
reference — which converts one frame per render-thread tick — the unit of work
here is a whole batch of frames (multiple clients x frames in flight), which
is what makes an accelerator's throughput reachable.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from asciichat_tpu.ops import cells
from asciichat_tpu.render import emitter
from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.oracle import compute_render_geometry
from asciichat_tpu.render.types import TerminalCapabilities


@dataclasses.dataclass
class RenderPlan:
    """Static per-(shape, caps) geometry, reused across frames of a stream."""

    mode: str
    dst_w: int
    dst_h_px: int  # pixel rows fed to the renderer (2x cells for half-block)
    pad_w: int
    pad_h: int


def plan_render(
    src_w: int,
    src_h: int,
    width: int,
    height: int,
    caps: TerminalCapabilities,
    use_aspect_ratio: bool = True,
    stretch: bool = False,
) -> RenderPlan:
    rw, rh, pad_w, pad_h = compute_render_geometry(
        src_w, src_h, width, height, caps, use_aspect_ratio, stretch
    )
    return RenderPlan(caps.renderer_key(), rw, rh, pad_w, pad_h)


class AsciiRenderer:
    """Reusable batched renderer for one palette (caches LUTs + jit graphs)."""

    def __init__(self, palette: str = pal.DEFAULT_PALETTE):
        self.palette = palette
        self._ramp = cells.ramp_for_palette(palette)

    def cells_for_plan(self, frames: jax.Array, plan: RenderPlan) -> cells.RecordDict:
        """Device part only: frames uint8 [B,Hs,Ws,3] -> cell records."""
        return cells.render_cells(
            frames, self._ramp, dst_h=plan.dst_h_px, dst_w=plan.dst_w, mode=plan.mode
        )

    def convert_batch(
        self,
        frames: np.ndarray | jax.Array,
        width: int,
        height: int,
        caps: TerminalCapabilities,
        use_aspect_ratio: bool = True,
        stretch: bool = False,
    ) -> list[bytes]:
        """Full conversion for a batch: [B, Hs, Ws, 3] uint8 -> B ANSI frames."""
        frames = jnp.asarray(frames, dtype=jnp.uint8)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            # a single [H,W,3] frame here would silently read W as the
            # height and 3 as the width, and the native emitter would then
            # walk 3x the bytes the records hold (OOB read) — fail loudly
            raise ValueError(
                f"convert_batch expects [B,H,W,3], got {frames.shape}; "
                "use convert() for a single frame")
        src_h, src_w = frames.shape[1], frames.shape[2]
        plan = plan_render(src_w, src_h, width, height, caps, use_aspect_ratio, stretch)
        records = self.cells_for_plan(frames, plan)
        host = cells.records_to_numpy(records)
        return emitter.emit_frames(
            host, plan.mode, self.palette, pad_w=plan.pad_w, pad_h=plan.pad_h
        )

    def convert(
        self,
        frame: np.ndarray,
        width: int,
        height: int,
        caps: TerminalCapabilities,
        use_aspect_ratio: bool = True,
        stretch: bool = False,
    ) -> bytes:
        """Single-frame convenience (matches ascii_convert_with_capabilities)."""
        return self.convert_batch(
            frame[None], width, height, caps, use_aspect_ratio, stretch
        )[0]
