"""The resize must be bit-identical to the fixed-point C semantics
(render/oracle.resize_image, image.c:267-328) at every shape it serves."""

import numpy as np
import pytest

from asciichat_tpu.ops import pixel
from asciichat_tpu.render import oracle

from conftest import synthetic_frame


@pytest.mark.parametrize(
    "src,dst",
    [((48, 64), (12, 40)), ((37, 53), (20, 31)), ((16, 16), (40, 80)), ((240, 320), (57, 203))],
)
def test_gather_matches_oracle(src, dst):
    import jax.numpy as jnp

    frame = synthetic_frame(*src, seed=3)
    want = oracle.resize_image(frame, dst_w=dst[1], dst_h=dst[0])
    got = np.asarray(pixel.resize_nn(jnp.asarray(frame[None]), dst[0], dst[1]))[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "src,dst",
    [
        ((270, 480), (57, 203)),  # batch cell, 1080p -> 203x64 at 1/4 scale
        ((96, 152), (128, 203)),  # tick: composite -> 203x128-px half-block
        ((120, 160), (24, 80)),  # mirror, 640x480 -> 80x24 at 1/4 scale
    ],
    ids=["batch", "tick", "mirror"],
)
def test_resize_matches_oracle_at_cell_shapes(src, dst):
    """Batched, inside jit, as the render steps call it."""
    import jax

    frames = np.stack([synthetic_frame(*src, seed=s) for s in range(3)])
    got = np.asarray(jax.jit(lambda f: pixel.resize_nn(f, *dst))(frames))
    for i, frame in enumerate(frames):
        np.testing.assert_array_equal(
            got[i], oracle.resize_image(frame, dst_w=dst[1], dst_h=dst[0]))
