"""Device ANSI emitter experiment (ops/emit.py): byte-exact vs the oracle.

The module is kept OUT of the serving path (see its docstring), but it must
stay correct: a user who reaches it gets a checked result, on the CPU here
and on the GPU under the ``chip`` marker.
"""

import numpy as np
import pytest

from asciichat_tpu.ops import emit, pixel
from asciichat_tpu.render import oracle
from asciichat_tpu.render import palette as pal


def _records(rgb):
    import jax.numpy as jnp

    luma = np.asarray(pixel.luminance(jnp.asarray(rgb[None]))).astype(np.uint8)
    return {"rgb": rgb[None], "luma": luma}


def test_device_emit_matches_oracle():
    rng = np.random.default_rng(11)
    cases = []
    for h, w in [(12, 17), (1, 5), (3, 1), (24, 40), (2, 2)]:
        cases.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    flat = np.zeros((9, 31, 3), np.uint8)  # long runs: SGR only at starts
    flat[:, :15] = [7, 200, 13]
    cases.append(flat)
    grad = np.stack(np.broadcast_arrays(
        np.arange(20)[:, None] * 12, np.arange(30)[None, :] * 8, 128),
        -1).astype(np.uint8)
    cases.append(grad)
    # single-digit / three-digit color components stress the no-leading-zero
    # digit emission
    cases.append(np.full((4, 6, 3), 9, np.uint8))
    cases.append(np.full((4, 6, 3), 255, np.uint8))
    for rgb in cases:
        got = emit.emit_frames_device(_records(rgb))[0]
        want = oracle.render_truecolor_fg(rgb)
        assert got == want, rgb.shape


def test_device_emit_batched_consistency():
    rng = np.random.default_rng(5)
    import jax.numpy as jnp

    rgb = rng.integers(0, 256, (4, 10, 13, 3), dtype=np.uint8)
    luma = np.asarray(pixel.luminance(jnp.asarray(rgb))).astype(np.uint8)
    outs = emit.emit_frames_device({"rgb": rgb, "luma": luma})
    for i in range(4):
        assert outs[i] == oracle.render_truecolor_fg(rgb[i])


def test_device_emit_rejects_utf8_palettes():
    with pytest.raises(ValueError):
        emit.ascii_glyph_table(pal.BUILTIN_PALETTES["blocks"])


@pytest.mark.chip
def test_device_emit_matches_oracle_on_gpu(gpu):
    """The headline geometry (203x64 truecolor) on the card, batched."""
    import jax

    rng = np.random.default_rng(21)
    rgb = rng.integers(0, 256, (4, 64, 203, 3), dtype=np.uint8)
    rgb[1, :, :100] = rgb[1, :, :1]  # long runs: SGR only at run starts
    luma = np.asarray(pixel.luminance(jax.device_put(rgb, gpu))).astype(np.uint8)
    with jax.default_device(gpu):
        outs = emit.emit_frames_device({"rgb": rgb, "luma": luma})
    for i in range(len(rgb)):
        assert outs[i] == oracle.render_truecolor_fg(rgb[i]), i
