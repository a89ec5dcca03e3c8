"""The program runs on whatever device it is given, and nothing hides it:
mesh construction refuses too few devices, host-served ticks are counted,
optional packages stay optional, and float32 products ask for full
precision where a GPU would otherwise drop to TF32."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import synthetic_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def caplog(caplog):
    """caplog that also sees the package's loggers, which do not propagate
    to the root logger."""
    import logging

    from asciichat_tpu.utils.logsys import get_logger

    get_logger("test")  # configure first: configure() resets the handlers
    log = logging.getLogger("asciichat")
    log.addHandler(caplog.handler)
    try:
        yield caplog
    finally:
        log.removeHandler(caplog.handler)


# ---- parallel/mesh.py ------------------------------------------------------

@pytest.mark.parametrize("n,space", [(16, 1), (9, 1), (6, 4)],
                         ids=["too-many", "too-many-odd", "space-indivisible"])
def test_make_mesh_refuses(n, space):
    """No quiet swap to other devices: asking the 8-device test pool for
    more than it has, or for a space axis that does not divide, raises."""
    from asciichat_tpu.parallel import mesh as meshlib

    with pytest.raises(ValueError):
        meshlib.make_mesh(n, space=space)


def test_make_mesh_explicit_devices():
    import jax

    from asciichat_tpu.parallel import mesh as meshlib

    mesh = meshlib.make_mesh(4, space=2, devices=jax.devices("cpu"))
    assert dict(mesh.shape) == {"clients": 2, "space": 2}


# ---- optional packages ------------------------------------------------------

_BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("cryptography", "zstandard"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
"""


@pytest.mark.parametrize("module", ["asciichat_tpu.apps.server",
                                    "asciichat_tpu.apps.client"])
def test_imports_without_optional_packages(module):
    """A plaintext, uncompressed session needs neither cryptography nor
    zstandard: the server and client import with both absent."""
    code = _BLOCK + (
        f"import {module}\n"
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('cryptography', 'zstandard')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_plaintext_session_without_optional_packages(tmp_path):
    """The CLI server and client hold a plaintext session with neither
    cryptography nor zstandard importable; the client asks for compressed
    frames and gets them uncompressed."""
    import socket
    import time

    (tmp_path / "sitecustomize.py").write_text(_BLOCK)
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{REPO}",
           "ASCIICHAT_JAX_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    blocked = subprocess.run([sys.executable, "-c", "import zstandard"],
                             env=env, capture_output=True)
    assert blocked.returncode != 0  # the blocker is in force
    cli = [sys.executable, "-m", "asciichat_tpu.apps.main"]
    srv = subprocess.Popen([*cli, "server", "--port", str(port),
                            "--log-level", "WARNING"], cwd=REPO, env=env,
                           stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        time.sleep(4)  # jax import + listen
        assert srv.poll() is None, srv.stderr.read().decode()[-2000:]
        client = subprocess.run(
            [*cli, "client", "127.0.0.1", "--port", str(port), "--test-pattern",
             "--width", "40", "--height", "12", "--color-mode", "truecolor",
             "--max-frames", "3", "--no-reconnect", "--log-level", "WARNING"],
            cwd=REPO, env=env, capture_output=True, timeout=180)
        assert client.returncode == 0, client.stderr.decode()[-2000:]
        assert client.stdout.count(b"\x1b[0m\n") >= 3
    finally:
        srv.terminate()
        srv.wait(timeout=20)
    assert b"ImportError" not in srv.stderr.read()


def test_maybe_compress_without_zstandard(monkeypatch, caplog):
    """Without zstandard frames go uncompressed (the flag is per packet,
    so that is wire-legal) with one log line; a compressed packet that
    arrives is bad data."""
    from asciichat_tpu.net import packet as pkt

    def missing(level=1):
        raise ImportError("zstandard")

    monkeypatch.setattr(pkt, "_zstd", missing)
    monkeypatch.setattr(pkt, "_warned_no_zstd", False)
    frame = bytes(range(256)) * 16
    with caplog.at_level("WARNING"):
        assert pkt.maybe_compress(frame) == (frame, False)
        assert pkt.maybe_compress(frame) == (frame, False)
    assert sum("zstandard" in r.getMessage() for r in caplog.records) == 1
    payload = pkt.pack_ascii_frame(frame, 80, 24, compress=True)
    assert pkt.unpack_ascii_frame(payload)[0] == frame
    with pytest.raises(ValueError):
        pkt.decompress(b"\x28\xb5\x2f\xfd" + b"\0" * 16, 1024)


# ---- apps/server.py host_ticks ----------------------------------------------

class _Transport:
    def __init__(self):
        self.frames = 0
        self.peername = ("127.0.0.1", 0)

    def send_nowait(self, ptype, payload=b"", **kw):
        self.frames += 1
        return True


def _clients(server_mod, n=2):
    from asciichat_tpu.net import protocol as proto

    out = []
    for i in range(n):
        c = server_mod.ClientState(i + 1, _Transport())
        c.wire_caps = proto.WireCapabilities(width=40, height=12)
        c.has_caps = True
        c.video.commit(synthetic_frame(48, 64, seed=i))
        c.streaming = True
        out.append(c)
    return out


def test_host_ticks_count_device_failures(monkeypatch, caplog):
    """A failing device tick is served on the host, and every such tick is
    counted (host_ticks), with an ERROR line the first time."""
    from asciichat_tpu.apps import server as server_mod

    srv = server_mod.AsciiChatServer()
    clients = _clients(server_mod)
    srv._render_tick(clients)
    assert (srv.host_ticks, srv.tick_compute_count) == (0, 1)

    def broken(*a, **kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(srv, "_render_tick_device", broken)
    with caplog.at_level("ERROR"):
        srv._render_tick(clients)
        srv._render_tick(clients)  # inside the backoff: host again
    assert srv.host_ticks == 2
    assert srv._device_failures == 1
    assert any("host_ticks" in r.getMessage() for r in caplog.records)
    assert all(c.transport.frames == 3 for c in clients)  # still served


def test_device_info_names_the_default_device():
    from asciichat_tpu.apps import server as server_mod

    info = server_mod.device_info()
    assert info["platform"] == "cpu" and info["count"] == 8


# ---- ops/audio.py NLMS precision ---------------------------------------------

def _nlms_reference(mic, far, taps, mu, geigel_t, hangover):
    """The echo_cancel recursion in float64 numpy, from zero state."""
    hist = np.concatenate([np.zeros(taps), far.astype(np.float64)])
    w = np.zeros(taps)
    hang = 0
    out = np.empty(len(mic))
    for i in range(len(mic)):
        x = hist[i + 1: i + 1 + taps]
        e = mic[i] - w @ x
        hang = hangover if abs(mic[i]) > geigel_t * np.abs(x).max() else max(hang - 1, 0)
        if hang == 0:
            w = w + mu * e * x / (x @ x + 1e-6)
        out[i] = e
    return out, w


def test_echo_cancel_matches_float64_reference():
    """The NLMS dots run at HIGHEST precision: the canceller's output and
    weights track a float64 reference of the same recursion (a TF32 dot
    would miss by ~1e-3)."""
    from asciichat_tpu.ops import audio as A

    rng = np.random.default_rng(17)
    taps, n = 32, 480
    far = rng.normal(0, 0.3, n).astype(np.float32)
    echo = 0.6 * np.concatenate([np.zeros(5, np.float32), far[:-5]])
    mic = (echo + rng.normal(0, 0.01, n)).astype(np.float32)
    out, w, _tail, _hang, _stats = A.echo_cancel(
        mic, far, np.zeros(taps, np.float32), np.zeros(taps, np.float32),
        np.int32(0), taps=taps, mu=0.5, hangover=64)
    want_out, want_w = _nlms_reference(mic, far, taps, 0.5, 0.5, 64)
    np.testing.assert_allclose(np.asarray(out), want_out, rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(w), want_w, rtol=0, atol=2e-5)
