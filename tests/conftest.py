"""Test config: force an 8-device virtual CPU mesh BEFORE jax import.

Multi-device sharding paths are validated on host CPU devices. With
``ASCIICHAT_TEST_CHIP=1`` the default backend is left alone, so the tests
marked ``chip`` run on the GPU (``ASCIICHAT_TEST_CHIP=1 python -m pytest -m
chip tests/``); without it they skip.
"""

import os

CHIP = os.environ.get("ASCIICHAT_TEST_CHIP") == "1"

if not CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at
    collection, so every xdist worker collects the same tests."""
    if not CHIP:
        pytest.skip("chip test: set ASCIICHAT_TEST_CHIP=1 on a GPU host")
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"chip test: no GPU (default backend is {devices[0].platform})")
    return devices[0]


def synthetic_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Deterministic gradient+noise test pattern (mirrors the reference's
    --test-pattern synthetic webcam, lib/video/webcam/webcam.c:21-27)."""
    gen = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = (xx * 255 // max(w - 1, 1)).astype(np.uint8)
    g = (yy * 255 // max(h - 1, 1)).astype(np.uint8)
    b = ((xx + yy) % 256).astype(np.uint8)
    base = np.stack([r, g, b], axis=-1)
    noise = gen.integers(0, 32, (h, w, 3), dtype=np.uint8)
    return (base.astype(np.int32) + noise).clip(0, 255).astype(np.uint8)


@pytest.fixture
def test_pattern():
    return synthetic_frame
