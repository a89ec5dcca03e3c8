"""chip_smoke.py's phases at tiny shapes on CPU devices, its refusal to run
without a GPU, and the same checks on the card under the ``chip`` marker."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from asciichat_tpu.ops import cells

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cpu_batch():
    import jax

    return cs.batch_frames(jax.devices("cpu")[0], 4, 90, 160, seed=5)


@pytest.mark.parametrize("mode", cells.MODES)
def test_check_mode_on_cpu(cpu_batch, mode):
    line = cs.check_mode(cpu_batch, mode, 51, 16, (0, 3))
    assert "byte-equal to the oracle" in line and "memory_analysis" in line


def test_batch_frames_cover_runs_and_black():
    """The generated batch has what the emitters' special paths need: an
    all-black box and rows of one repeated pixel."""
    import jax

    f = np.asarray(cs.batch_frames(jax.devices("cpu")[0], 2, 64, 96, seed=1))
    assert (f[:, :16, :24] == 0).all()
    assert (f[:, 32:40] == f[:, 32:40, :1]).all()
    assert len(np.unique(f[0].reshape(-1, 3), axis=0)) > 1000


def test_room_reference_is_what_the_server_serves():
    """The CPU reference the served room is held to equals the server's own
    device tick (_render_tick, CPU backend here) for every ROOM receiver."""
    from asciichat_tpu.apps import server as server_mod
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net import protocol as proto

    frames = cs.room_frames(len(cs.ROOM), 60, 80, seed=2)

    class Sink:
        def __init__(self):
            self.frames = []
            self.peername = ("127.0.0.1", 0)

        def send_nowait(self, ptype, payload=b"", **kw):
            if ptype == pkt.PacketType.ASCII_FRAME:
                self.frames.append(pkt.unpack_ascii_frame(bytes(payload))[0])
            return True

    srv = server_mod.AsciiChatServer()
    clients = []
    for i, (_name, w, h, color, mode, filt) in enumerate(cs.ROOM):
        c = server_mod.ClientState(i + 1, Sink())
        c.wire_caps = proto.WireCapabilities(caps=cs.caps_for(color, mode),
                                             width=w, height=h)
        c.has_caps = c.streaming = True
        c.filter_name = filt
        c.video.commit(frames[i])
        clients.append(c)
    srv._render_tick(clients)
    assert srv.host_ticks == 0
    for c, (name, w, h, color, mode, filt) in zip(clients, cs.ROOM):
        assert c.transport.frames == [cs.room_reference(frames, w, h, color, mode, filt)], name


def test_check_tick_between_cpu_devices():
    import jax

    frames = cs.room_frames(len(cs.ROOM), 48, 64, seed=3)
    cpu = jax.devices("cpu")
    lines = cs.check_tick(frames, cpu[0], cpu[1])
    assert len(lines) == len(cs.room_groups()) == 5


def test_resize_formulations_agree_and_time():
    """Phase 4 at tiny shapes: the one-hot matrix-product resize gives the
    gather's records at all three cell shapes, and each gets a timing."""
    import jax

    cpu = jax.devices("cpu")[0]
    shapes = cs.resize_shapes(cs.batch_frames(cpu, 2, 135, 240),
                              jax.device_put(cs.room_frames(9, 30, 40), cpu),
                              cs.batch_frames(cpu, 1, 48, 64, seed=1))
    lines = cs.time_resize(shapes, iters=1, reps=2)
    assert [ln.split()[0] for ln in lines] == ["batch", "tick", "mirror"]
    assert all("gather median" in ln and "onehot median" in ln for ln in lines)


def test_sharded_tick_check_on_four_cpu_devices():
    import jax

    cpu = jax.devices("cpu")
    line = cs.sharded_tick_check(cs.room_frames(9, 48, 64, seed=4), cpu[:4], cpu[4])
    assert "{'clients': 4}" in line and "value-exact" in line


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_main_refuses_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = _run_smoke(REPO, env)
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and "GPU" in last["error"]


def test_main_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run_smoke(tmp_path, env)
    assert r.returncode != 0
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is False


# ---- on the card -------------------------------------------------------------

@pytest.mark.chip
@pytest.mark.parametrize("mode", cells.MODES)
def test_mode_byte_exact_on_gpu(gpu, mode):
    """Every record mode at the headline shape, 1080p -> 203x64, on the
    card; a slice through the native emitter equals the oracle."""
    frames = cs.batch_frames(gpu, 16, cs.SRC_H, cs.SRC_W, seed=7)
    cs.check_mode(frames, mode, cs.TERM_W, cs.TERM_H, (0, 15))


@pytest.mark.chip
def test_tick_gpu_matches_cpu(gpu):
    import jax

    frames = cs.room_frames(len(cs.ROOM), cs.UPLINK_H, cs.UPLINK_W, seed=8)
    cs.check_tick(frames, gpu, jax.devices("cpu")[0])
