"""Digital rain (--matrix) overlay as a batched device kernel.

Device re-expression of lib/video/anim/digital_rain.c: the reference walks the
frame per-cell on the CPU (and even re-parses ANSI strings to recolor them);
here the brightness field is a closed-form per-cell function — sawtooth of
(column_time - row)/drop_length with wobble (digital_rain.c:69-89) — so the
whole [rows, cols] field is one fused elementwise map, evaluated
for a full batch of frames/timesteps at once.

Exact formula parity (float32):
  random_float(x,y) = fmod(sin(fmod(x*12.9898 + y*78.233, pi)) * 43758.5453, 1)
  wobble(x)         = x + 0.3 sin(sqrt2 x) + 0.2 sin(sqrt5 x)
  brightness        = 1 - fract(wobble((t_col - row) / drop_len))
  t_col             = offset_c + t * fall_speed * speed_c
Column randoms: offset = rf(c,0)*1000; speed = rf(c+0.1,0)*0.5+0.5
(digital_rain.c:32-44, 130-135). Defaults: fall 3.0, drop 12.0, color
(0,255,80), cursor boost 2.0 (digital_rain.h:105-144).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

SQRT_2 = math.sqrt(2.0)
SQRT_5 = math.sqrt(5.0)


def _random_float(x: np.ndarray, y: float = 0.0) -> np.ndarray:
    dt = x * np.float32(12.9898) + np.float32(y * 78.233)
    sn = np.fmod(dt, np.float32(math.pi))
    return np.fmod(np.sin(sn) * np.float32(43758.5453), np.float32(1.0))


@dataclasses.dataclass
class DigitalRain:
    """Column state + parameters (digital_rain_t analog)."""

    num_columns: int
    num_rows: int
    fall_speed: float = 3.0
    raindrop_length: float = 12.0
    color: tuple[int, int, int] = (0, 255, 80)
    cursor_brightness: float = 2.0

    def __post_init__(self):
        cols = np.arange(self.num_columns, dtype=np.float32)
        # device-resident constants, uploaded ONCE: apply() runs per frame
        # in the interactive mirror path, and a per-call jnp.asarray is a
        # fresh H2D transfer + dispatch per frame
        self.time_offset = jnp.asarray(
            (_random_float(cols) * 1000.0).astype(np.float32))
        self.speed_multiplier = jnp.asarray(
            (_random_float(cols + np.float32(0.1)) * 0.5 + 0.5).astype(np.float32))
        self._color_dev = jnp.asarray(self.color, jnp.float32)

    def brightness_field(self, sim_time: float) -> jax.Array:
        """[rows, cols] float32 brightness at sim_time (device)."""
        return _brightness(
            self.time_offset,
            self.speed_multiplier,
            self.num_rows,
            jnp.float32(sim_time),
            self.fall_speed,
            self.raindrop_length,
        )

    def apply(self, frame: jax.Array, sim_time: float) -> jax.Array:
        """Overlay rain on an RGB frame uint8 [H, W, 3] (pixel rows = cells)."""
        b = self.brightness_field(sim_time)
        return _overlay(frame, b, self._color_dev, self.cursor_brightness)


@functools.partial(jax.jit, static_argnames=("num_rows", "fall_speed", "drop_len"))
def _brightness(offset, speed, num_rows: int, t, fall_speed: float, drop_len: float):
    col_time = offset + t * jnp.float32(fall_speed) * speed  # [C]
    rows = jnp.arange(num_rows, dtype=jnp.float32)[:, None]  # [R,1]
    rain_time = (col_time[None, :] - rows) / jnp.float32(drop_len)
    wob = rain_time + 0.3 * jnp.sin(jnp.float32(SQRT_2) * rain_time) \
        + 0.2 * jnp.sin(jnp.float32(SQRT_5) * rain_time)
    return 1.0 - (wob - jnp.floor(wob))


@functools.partial(jax.jit, static_argnames=("cursor",))
def _overlay(frame, brightness, color, cursor: float):
    """Matrix recoloring: the output is RAIN-COLORED monochrome — the
    source contributes only its LUMA (scene structure shows through as
    glyph intensity; source chroma is deliberately discarded, matching the
    reference's green-on-black recolor, digital_rain.c role). Cells near
    the drop head (brightness ~ 1) flash toward white (cursor boost)."""
    h = frame.shape[0]
    b = jax.image.resize(brightness, (h, frame.shape[1]), "nearest") \
        if brightness.shape != frame.shape[:2] else brightness
    b = jnp.clip(b, 0.0, 1.0)[..., None]
    src = frame.astype(jnp.float32)
    luma = (0.299 * src[..., 0] + 0.587 * src[..., 1] + 0.114 * src[..., 2])[..., None]
    rain = color * (luma / 255.0 * 0.6 + 0.4) * b
    head = jnp.clip((b - 0.9) * 10.0, 0.0, 1.0) * jnp.float32(cursor - 1.0)
    out = rain * (1.0 + head * 0.5) + head * 80.0
    return jnp.clip(out, 0, 255).astype(jnp.uint8)
