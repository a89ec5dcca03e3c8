"""Regression tests for the round-4 adversarial review sweep (VERDICT r03
#8) over runtime/{framesource,webcam}.py and the native emitter/avshim/capi
fixes that are reachable from Python."""

import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_ffmpeg_device_webcam_keeps_partial_frame_across_stall(tmp_path):
    """A stall timeout mid-frame must NOT discard consumed bytes: the
    rawvideo stream has no framing, so dropping k bytes shifts every later
    frame. The fake device emits half a frame, stalls past the timeout,
    then emits the rest — the eventual frame must be correctly aligned."""
    from asciichat_tpu.runtime.webcam import FfmpegDeviceWebcam

    w, h = 16, 8
    half = w * h * 3 // 2
    fake = tmp_path / "ffmpeg"
    fake.write_text(
        "#!/bin/sh\n"
        "python3 -c 'import sys, time\n"
        f"sys.stdout.buffer.write(bytes([7]) * {half})\n"
        "sys.stdout.buffer.flush()\n"
        "time.sleep(1.2)\n"
        f"sys.stdout.buffer.write(bytes([7]) * {half})\n"
        f"sys.stdout.buffer.write(bytes([9]) * {w * h * 3})\n"
        "sys.stdout.buffer.flush()\n"
        "time.sleep(2)'\n"
    )
    fake.chmod(0o755)
    old_path = os.environ["PATH"]
    os.environ["PATH"] = f"{tmp_path}:{old_path}"
    try:
        cam = FfmpegDeviceWebcam("avfoundation", "0", width=w, height=h)
        frames = []
        stalls = 0
        deadline = time.monotonic() + 20
        while len(frames) < 2 and time.monotonic() < deadline:
            f = cam.read(timeout=0.4)  # < the fake's 1.2 s mid-frame stall
            if f is None:
                stalls += 1
                continue
            frames.append(f)
        cam.close()
        assert len(frames) == 2
        assert stalls >= 1, "the mid-frame stall never hit the timeout path"
        # alignment survived: frame 0 all 7s, frame 1 all 9s
        assert np.all(frames[0] == 7)
        assert np.all(frames[1] == 9)
    finally:
        os.environ["PATH"] = old_path


def test_yuyv_matches_nv12_limited_range():
    """The two converters must produce the SAME RGB for the same Y/U/V
    (limited-range BT.601 298/409/516) — the negotiated driver format must
    not change the picture."""
    from asciichat_tpu.runtime.webcam import nv12_to_rgb, yuyv_to_rgb

    w, h = 8, 4
    for yv, uu, vv in [(255, 128, 128), (0, 128, 128), (81, 90, 240),
                       (128, 128, 128), (145, 54, 34), (16, 128, 128)]:
        yuyv = bytes([yv, uu, yv, vv] * (w * h // 2))
        nv12 = bytes([yv] * (w * h)) + bytes([uu, vv] * (w * h // 4))
        a = yuyv_to_rgb(yuyv, w, h)
        b = nv12_to_rgb(nv12, w, h)
        np.testing.assert_array_equal(a, b, err_msg=f"y={yv} u={uu} v={vv}")
    # limited-range anchors: video white saturates, video black floors
    white = yuyv_to_rgb(bytes([235, 128, 235, 128] * (w * h // 2)), w, h)
    assert np.all(white >= 254)
    black = yuyv_to_rgb(bytes([16, 128, 16, 128] * (w * h // 2)), w, h)
    assert np.all(black == 0)


def test_v4l2_destride_drops_row_padding():
    """bytesperline > row_bytes (DMA-aligned drivers) must de-stride, not
    shear: rows are compacted before reshape/convert."""
    from asciichat_tpu.runtime.webcam import V4L2Webcam

    cam = V4L2Webcam.__new__(V4L2Webcam)  # no device in this image
    cam.stride = 40  # 32 payload + 8 pad
    rows = []
    raw = b""
    for r in range(4):
        row = bytes([r] * 32)
        rows.append(row)
        raw += row + b"\xee" * 8
    tight = cam._destride(raw, 32, 4)
    assert tight == b"".join(rows)
    # no stride / already tight / short buffer -> passthrough
    cam.stride = 0
    assert cam._destride(raw, 32, 4) == raw
    cam.stride = 32
    assert cam._destride(raw[:128], 32, 4) == raw[:128]
    cam.stride = 40
    assert cam._destride(raw[:100], 32, 4) == raw[:100]  # truncated: as-is


def test_prefetch_close_joins_producer_before_inner_close():
    """close() must join the decode-ahead thread before closing the inner
    source — closing a native handle mid-read is a use-after-free."""
    from asciichat_tpu.runtime.framesource import FrameSource, PrefetchSource

    events = []

    class Slow(FrameSource):
        width = height = 4
        closed = False

        def read(self):
            events.append("read-start")
            time.sleep(0.3)
            if self.closed:
                events.append("READ-AFTER-CLOSE")
            events.append("read-end")
            return np.zeros((4, 4, 3), np.uint8)

        def close(self):
            self.closed = True
            events.append("close")

    src = Slow()
    p = PrefetchSource(src, depth=2)
    assert p.read() is not None
    p.close()
    assert not p._thread.is_alive(), "producer not joined"
    assert "READ-AFTER-CLOSE" not in events
    assert events[-1] == "close"


def test_native_video_source_read_after_close_returns_none(tmp_path):
    """NativeVideoFileSource.read on a closed handle must return None, not
    hand NULL to the C side."""
    from asciichat_tpu.models.renderfile import NativeRecorder
    from asciichat_tpu.runtime.framesource import NativeVideoFileSource

    # make a tiny video with the recorder if libav is present
    try:
        path = str(tmp_path / "t.mp4")
        rec = NativeRecorder(path, 32, 16, fps=10)
        for _ in range(3):
            rec.write_rgb(np.zeros((16, 32, 3), np.uint8))
        rec.close()
        src = NativeVideoFileSource(path)
    except Exception as e:
        pytest.skip(f"no libav recorder in this env: {e}")
    assert src.read() is not None
    src.close()
    assert src.read() is None  # guarded, no segfault
    src.close()  # idempotent


def test_ffmpeg_file_source_close_reaps_process(tmp_path):
    """close() must kill AND reap the decoder (no zombie, pipe closed).
    No ffmpeg binary exists in this image, so drive the same kill/wait/
    close contract with a fake long-running 'decoder'."""
    import shutil
    import subprocess

    from asciichat_tpu.runtime.framesource import FFmpegFileSource

    if shutil.which("ffmpeg") and shutil.which("ffprobe"):
        pytest.skip("real ffmpeg present; covered by the file-decode tests")
    src = FFmpegFileSource.__new__(FFmpegFileSource)
    src._proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(600)"],
        stdout=subprocess.PIPE)
    src.close()
    assert src._proc.poll() is not None  # reaped, not zombie
    assert src._proc.stdout.closed


def test_animated_gif_routes_to_video_decode(tmp_path):
    """An animated GIF must play as video (the reference decodes --file
    media through libav), not freeze on PIL frame 0; a single-frame GIF
    stays on the cheap still-image path."""
    from PIL import Image

    from asciichat_tpu.runtime import framesource

    anim = tmp_path / "anim.gif"
    frames = [Image.new("RGB", (16, 12), c) for c in ((255, 0, 0), (0, 255, 0))]
    frames[0].save(anim, save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    still = tmp_path / "still.gif"
    frames[0].save(still)

    assert framesource._gif_is_animated(str(anim)) is True
    assert framesource._gif_is_animated(str(still)) is False

    src = framesource.open_source(file=str(still))
    assert isinstance(src, framesource.ImageFileSource)
    try:
        vid = framesource.open_source(file=str(anim), pace=False)
    except RuntimeError:
        pytest.skip("no video decoder available for GIF")
    assert not isinstance(vid, framesource.ImageFileSource)
    f = vid.read()
    assert f is not None and f.shape == (12, 16, 3)
    vid.close()


def test_yt_dlp_timeout_falls_back(monkeypatch, tmp_path):
    """A hung yt-dlp resolver (TimeoutExpired) must fall through to direct
    decode, not crash open_source."""
    import subprocess

    from asciichat_tpu.runtime import framesource

    calls = []

    def fake_which(name):
        return "/usr/bin/yt-dlp" if name == "yt-dlp" else None

    def fake_run(cmd, **kw):
        calls.append(cmd)
        raise subprocess.TimeoutExpired(cmd, kw.get("timeout", 60))

    monkeypatch.setattr(framesource.shutil, "which", fake_which)
    monkeypatch.setattr(framesource.subprocess, "run", fake_run)

    sentinel = object()
    seen = {}

    def fake_video(path):
        seen["path"] = path
        return sentinel

    # _video is a closure; patch at the open_source level by intercepting
    # NativeVideoFileSource + FFmpegFileSource construction instead
    class Boom(RuntimeError):
        pass

    def native_raises(path, loop=False):
        seen["path"] = path
        raise Boom("decoder reached (fallback worked)")

    monkeypatch.setattr(framesource, "NativeVideoFileSource", native_raises)
    monkeypatch.setattr(framesource, "FFmpegFileSource", native_raises)
    with pytest.raises(Boom):
        framesource.open_source(file="https://example.com/clip")
    assert calls, "yt-dlp was never attempted"
    assert seen["path"] == "https://example.com/clip"  # unresolved URL used


# ---- utils/options.py + utils/logsys.py sweep ---------------------------

def test_toml_cli_type_options_convert(tmp_path):
    """Config-file strings take the same cli_type codec as the CLI: a TOML
    stdin-size becomes the (w, h) tuple StdinSource needs, not a raw
    string that explodes as *\"640x480\"."""
    from asciichat_tpu.utils import options as opt

    cfg = tmp_path / "c.toml"
    cfg.write_text('[media]\nstdin-size = "640x480"\n')
    store = opt.OptionsStore(opt.default_registry())
    snap = store.load_toml(str(cfg))
    assert snap["stdin-size"] == (640, 480)
    # invalid strings fail as ValueError on every path (not only argparse)
    with pytest.raises(ValueError):
        store.publish(stdin_size="banana")


def test_publish_none_resets_option():
    """publish(option=None) stores None (unset), never the string 'None'
    or a TypeError from int(None)."""
    from asciichat_tpu.utils import options as opt

    store = opt.OptionsStore(opt.default_registry())
    store.publish(file="clip.mp4", max_frames=100)
    snap = store.publish(file=None, max_frames=None)
    assert snap["file"] is None
    assert snap["max-frames"] is None


def test_toml_unknown_toplevel_key_raises(tmp_path):
    """A typo'd top-level bare key must fail loudly like in-table typos —
    a silently dropped `pasword` means an unauthenticated server."""
    from asciichat_tpu.utils import options as opt

    cfg = tmp_path / "c.toml"
    cfg.write_text('pasword = "hunter2"\n')
    store = opt.OptionsStore(opt.default_registry())
    with pytest.raises(KeyError):
        store.load_toml(str(cfg))


def test_completions_escape_quotes():
    """Help text containing apostrophes (--webrtc: \"the server's\") must
    not break the generated zsh/fish completion syntax."""
    from asciichat_tpu.utils import options as opt

    r = opt.default_registry()
    helps = [d.help for d in r.descriptors()]
    assert any("'" in h for h in helps), "corpus lost its apostrophe case"
    fish = opt.generate_completions(r, "fish")
    for line in fish.splitlines():
        # every -d '...' payload must contain only escaped quotes
        body = line.split(" -d ", 1)[1]
        assert body.startswith("'") and body.endswith("'")
        inner = body[1:-1]
        k = 0
        while k < len(inner):
            assert inner[k] != "'", f"unescaped quote in: {line}"
            k += 2 if inner[k] == "\\" else 1
    zsh = opt.generate_completions(r, "zsh")
    for spec in zsh.splitlines()[1:]:
        s = spec.strip().rstrip("\\").strip()
        if not s.startswith("'"):
            continue
        # inside the single-quoted spec, ' only appears as the '\'' splice
        # and ] only escaped (both would otherwise end the spec early)
        inner = s[1:-1]
        assert "'" not in inner.replace("'\\''", ""), spec
        assert "]" not in inner.replace("\\]", "").replace("'\\''", "")[:-1] \
            or inner.replace("\\]", "").count("]") <= 1, spec


def test_manpage_shows_zero_defaults():
    """Integer default 0 (width/height auto) must not be hidden by the
    0 == False equality."""
    from asciichat_tpu.utils import options as opt

    man = opt.generate_manpage(opt.default_registry())
    at = man.index("\\fB--width\\fR")
    assert "(default: 0)" in man[at:at + 200]


def test_logsys_grep_reset_and_json_exc():
    """configure(grep=...) then configure(grep=None) must clear the ring
    filter (filters stacked forever before); JSON formatter keeps
    tracebacks."""
    import logging

    from asciichat_tpu.utils import logsys

    logsys.configure(grep="only-this")
    logsys.configure()  # no grep: everything must reach the ring again
    assert logsys.ring_log.filters == []
    log = logsys.get_logger("review-test")
    marker = "unfiltered-after-reset-xyz"
    log.info(marker)
    assert any(marker in e[3] for e in logsys.ring_log.tail(10))
    assert logging.getLogger("asciichat").propagate is False

    rec = logging.LogRecord("n", logging.ERROR, "f", 1, "boom", None, None)
    try:
        raise RuntimeError("ka-pow")
    except RuntimeError:
        import sys as _sys

        rec.exc_info = _sys.exc_info()
    import json as _json

    out = _json.loads(logsys.JsonFormatter().format(rec))
    assert "ka-pow" in out["exc"] and "Traceback" in out["exc"]
    logsys.configure()  # leave a clean config for other tests


def test_mmap_ring_tail_truncated_window_drops_partial(tmp_path):
    """A max_bytes window cutting mid-record must drop the partial first
    line even before the ring ever wrapped."""
    from asciichat_tpu.utils.logsys import MmapRingLog

    ring = MmapRingLog(str(tmp_path / "ring.bin"), capacity=4096)
    for i in range(20):
        ring.append(f"record-{i:03d} {'x' * 50}")
    lines = ring.tail(max_bytes=200)  # cuts mid-record, no wrap yet
    assert lines, "window too small"
    for ln in lines:
        assert ln.startswith("record-"), f"partial leaked: {ln!r}"
    # full window still returns everything intact
    assert len(ring.tail()) == 20
    ring.close()


# ---- net/{mdns,upnp,rate_limit}.py sweep --------------------------------

def test_mdns_announcement_carries_lan_address_and_byte_txt():
    """Default announcements must not advertise 127.0.0.1 (remote clients
    would connect to themselves); TXT length prefixes count ENCODED bytes;
    oversized entries truncate instead of raising."""
    from asciichat_tpu.net import mdns

    ann = mdns.MdnsAnnouncer("srv", 27224, {"ver": "1"}).announcement
    svc = mdns.parse_response(ann, "203.0.113.5")
    assert svc is not None
    # loopback A records are rejected in favor of the packet source
    assert svc.address != "127.0.0.1"

    # multibyte TXT value: length prefix = byte count, parse round-trips
    ann = mdns.build_announcement("u", 1000, {"name": "café"}, "192.0.2.1")
    svc = mdns.parse_response(ann, "192.0.2.1")
    assert svc.txt == {"name": "café"}
    # >255-byte entry truncates, does not raise
    big = mdns.build_announcement("u", 1000, {"k": "x" * 400}, "192.0.2.1")
    svc = mdns.parse_response(big, "192.0.2.1")
    assert len(next(iter(svc.txt.values()))) <= 253


def test_mdns_loopback_a_record_falls_back_to_source():
    from asciichat_tpu.net import mdns

    ann = mdns.build_announcement("local", 7000, {}, "127.0.0.1")
    svc = mdns.parse_response(ann, "198.51.100.3")
    assert svc.address == "198.51.100.3"


def test_mdns_multi_question_and_malformed_queries():
    """The responder must answer when the service question is NOT first
    (browsers batch questions) and must survive malformed datagrams."""
    import struct as st

    from asciichat_tpu.net import mdns

    # build a 2-question query with ours second
    q2 = st.pack(">HHHHHH", 0, 0, 2, 0, 0, 0)
    q2 += mdns._encode_name("_other._tcp.local") + st.pack(">HH", 12, 1)
    q2 += mdns._encode_name(mdns.SERVICE) + st.pack(">HH", 12, 1)

    # drive the matching logic the responder loop uses
    def service_queried(buf):
        if len(buf) > 12 and not st.unpack(">H", buf[2:4])[0] & 0x8000:
            qd = st.unpack(">H", buf[4:6])[0]
            off = 12
            for _ in range(min(qd, 32)):
                name, off = mdns._decode_name(buf, off)
                off += 4
                if name == mdns.SERVICE:
                    return True
        return False

    assert service_queried(q2) is True
    assert service_queried(mdns.build_query()) is True
    # malformed: truncated compression pointer at the end — parse_response
    # path must not raise either
    evil = b"\x00" * 12 + b"\xc0"
    assert mdns.parse_response(evil, "1.2.3.4") is None


def test_mdns_instance_dedupe_and_record_name_binding():
    """Full instance names (dots preserved) and per-name record binding:
    an extra unrelated SRV in the packet must not override the service's
    port."""
    import struct as st

    from asciichat_tpu.net import mdns

    ann = mdns.build_announcement("my.server", 4242, {}, "192.0.2.9")
    svc = mdns.parse_response(ann, "192.0.2.9")
    assert svc.instance == "my.server"
    assert svc.port == 4242

    # append an unrelated SRV record with a different name+port
    hdr = st.unpack(">HHHHHH", ann[:12])
    extra = (mdns._encode_name("intruder.local")
             + st.pack(">HHIH", mdns.TYPE_SRV, 1, 120, 6 + len(mdns._encode_name("x.local")))
             + st.pack(">HHH", 0, 0, 9999) + mdns._encode_name("x.local"))
    patched = st.pack(">HHHHHH", hdr[0], hdr[1], hdr[2], hdr[3] + 1,
                      hdr[4], hdr[5]) + ann[12:] + extra
    svc = mdns.parse_response(patched, "192.0.2.9")
    assert svc.port == 4242, "unrelated SRV captured the port"


def test_upnp_soap_escapes_and_rejects_file_location():
    from asciichat_tpu.net import upnp

    captured = {}

    def fake_soap(url, stype, action, args):
        captured.update(args)
        return "<ok/>"

    gw = upnp.UpnpGateway.__new__(upnp.UpnpGateway)
    gw.control_url, gw.service_type = "http://r/ctl", upnp.WAN_SERVICES[0]
    import asciichat_tpu.net.upnp as mod

    orig = mod._soap
    mod._soap = fake_soap
    try:
        gw.add_port_mapping(1, 2, "10.0.0.2", description="Tom & Jerry <chat>")
    finally:
        mod._soap = orig
    # values were escaped by _soap itself in production; here verify the
    # real _soap builds well-formed XML for hostile values
    import xml.dom.minidom

    class FakeResp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return b"<ok/>"

    sent = {}

    def fake_urlopen(req, timeout=None):
        sent["data"] = req.data
        return FakeResp()

    orig_open = mod.urllib.request.urlopen
    mod.urllib.request.urlopen = fake_urlopen
    try:
        mod._soap("http://r/ctl", upnp.WAN_SERVICES[0], "AddPortMapping",
                  {"NewPortMappingDescription": "Tom & Jerry <chat>"})
    finally:
        mod.urllib.request.urlopen = orig_open
    xml.dom.minidom.parseString(sent["data"])  # must be well-formed

    with pytest.raises(upnp.NatError):
        upnp._find_control_url("file:///etc/passwd")


def test_natpmp_oserror_becomes_naterror():
    """ICMP port-unreachable (ConnectionRefusedError) must surface as
    NatError per the open_external_port contract."""
    from asciichat_tpu.net import upnp

    # 127.0.0.1 on a (very likely) closed UDP port: Linux reports the ICMP
    # refusal on the connected-recvfrom path as ConnectionRefusedError
    with pytest.raises(upnp.NatError):
        upnp.natpmp_map("127.0.0.1", 1, 1, timeout=0.5, gateway_port=9)


def test_rate_limiter_windows_are_independent():
    """A short-window action must not purge a long-window action's events
    (the sliding-window bypass)."""
    from asciichat_tpu.net.rate_limit import RateLimiter

    rl = RateLimiter(limits={"reserve": (2, 3600.0), "lookup": (100, 0.01)})
    assert rl.allow("mallory", "reserve")
    assert rl.allow("mallory", "reserve")
    assert not rl.allow("mallory", "reserve")  # exhausted for an hour
    time.sleep(0.05)  # lookup window (10 ms) fully elapses
    for _ in range(3):
        assert rl.allow("mallory", "lookup")
    # the short-window lookups must NOT have purged the hour-window events
    assert not rl.allow("mallory", "reserve"), \
        "short-window action purged the long-window history"
    # and other clients' state is untouched
    assert rl.allow("alice", "reserve")


# ---- round-4 diff self-review findings ----------------------------------

def test_toml_numeric_scalar_takes_cli_type():
    """`color-mode = 16` (bare TOML int) must convert like the string
    \"16\"; already-converted values (enums, tuples) pass through."""
    from asciichat_tpu.render.types import ColorLevel
    from asciichat_tpu.utils import options as opt

    store = opt.OptionsStore(opt.default_registry())
    snap = store.publish(color_mode=16)
    assert snap["color-mode"] == ColorLevel.COLOR_16
    snap = store.publish(color_mode=ColorLevel.TRUECOLOR)  # passthrough
    assert snap["color-mode"] == ColorLevel.TRUECOLOR
    snap = store.publish(stdin_size=(320, 200))  # converted tuple passthrough
    assert snap["stdin-size"] == (320, 200)
    with pytest.raises(ValueError):
        store.publish(color_mode=99)


def test_gateway_stale_task_does_not_unroute_replacement():
    """A retried offer with the same ufrag replaces the agent; the stale
    task's completion must not delete the live replacement's trickle
    route."""
    from asciichat_tpu.apps.webclient import WebRtcGateway
    from asciichat_tpu.net import dtls

    if not dtls.available():
        pytest.skip("no OpenSSL: gateway requires DTLS")
    import asyncio

    from asciichat_tpu.net import sdp
    from asciichat_tpu.net.webrtc import IceLiteAgent

    async def run():
        gw = WebRtcGateway(lambda t: asyncio.sleep(0))
        browser = IceLiteAgent(controlling=True)
        await browser.start("127.0.0.1")
        try:
            offer_desc = browser.local_description()
            offer_desc["candidates"] = []
            offer = sdp.build(offer_desc, setup="actpass",
                              ice_lite=False).encode()
            assert await gw.on_offer(offer) is not None
            first = gw._agents_by_ufrag[browser.ufrag]
            first_task = next(iter(gw._tasks))
            assert await gw.on_offer(offer) is not None  # retry, same ufrag
            second = gw._agents_by_ufrag[browser.ufrag]
            assert second is not first
            first_task.cancel()
            try:
                await first_task
            except (asyncio.CancelledError, Exception):
                pass
            await asyncio.sleep(0)  # let done callbacks run
            assert gw._agents_by_ufrag.get(browser.ufrag) is second, \
                "stale task removed the live agent's trickle route"
        finally:
            browser.close()
            gw.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_mmap_ring_boundary_cut_keeps_complete_record(tmp_path):
    """A max_bytes window landing exactly on a record boundary must keep
    the complete first record (the previous byte in the ring is the '\\n'
    terminator)."""
    from asciichat_tpu.utils.logsys import MmapRingLog

    ring = MmapRingLog(str(tmp_path / "r.bin"), capacity=4096)
    recs = [f"rec-{i:02d}-{'y' * 20}" for i in range(10)]
    for r in recs:
        ring.append(r)
    rec_len = len(recs[0]) + 1  # + newline
    # window covering exactly the last 4 records: cut lands one byte after
    # a '\n', i.e. at a record start
    lines = ring.tail(max_bytes=4 * rec_len)
    assert lines == recs[-4:], lines
    # mid-record cut still drops the partial
    lines = ring.tail(max_bytes=4 * rec_len - 3)
    assert lines == recs[-3:], lines
    ring.close()


def test_pixel_op_guards():
    """quantize_color_levels rejects invalid level counts (device integer
    div-by-zero is silent garbage); convert_batch rejects a single frame
    (would drive a native OOB read); resize_nn on a CPU-committed concrete
    array equals the fixed-point oracle."""
    import jax
    import jax.numpy as jnp

    from asciichat_tpu.ops import pixel
    from asciichat_tpu.render.pipeline import AsciiRenderer
    from asciichat_tpu.render.types import TerminalCapabilities

    frames = jnp.zeros((2, 8, 8, 3), jnp.uint8)
    with pytest.raises(ValueError):
        pixel.quantize_color_levels(frames, 0)
    with pytest.raises(ValueError):
        pixel.quantize_color_levels(frames, 300)
    assert pixel.quantize_color_levels(frames, 8).shape == frames.shape

    r = AsciiRenderer()
    with pytest.raises(ValueError):
        r.convert_batch(np.zeros((8, 8, 3), np.uint8), 10, 5,
                        TerminalCapabilities())

    from asciichat_tpu.render import oracle

    big_np = np.random.default_rng(0).integers(
        0, 256, (1, 300, 300, 3), dtype=np.uint8)
    big = jnp.asarray(big_np, device=jax.devices("cpu")[0])
    out = pixel.resize_nn(big, 64, 64)
    np.testing.assert_array_equal(np.asarray(out)[0],
                                  oracle.resize_image(big_np[0], 64, 64))


# ---- utils/{term,ui}.py + render/validator.py sweep ---------------------

def test_framewriter_keys_tty_to_its_own_stream(monkeypatch):
    """A non-tty sink must get newline-separated frames with no clear/home
    codes even when stdout is a terminal, and a tty-like stream gets the
    cursor protocol even when stdout is redirected."""
    import io

    from asciichat_tpu.utils import term

    class TtyStdout:
        def isatty(self):
            return True

    monkeypatch.setattr(term.sys, "stdout", TtyStdout())
    buf = io.BytesIO()
    w = term.FrameWriter(buf)
    assert w.is_tty is False
    w.write_frame(b"frame1")
    w.write_frame(b"frame2")
    data = buf.getvalue()
    assert b"\x1b[2J" not in data and b"\x1b[H" not in data
    assert b"frame1\n" in data  # newline-separated capture format

    class TtyStream(io.BytesIO):
        def isatty(self):
            return True

    class PlainStdout:
        def isatty(self):
            return False

    monkeypatch.setattr(term.sys, "stdout", PlainStdout())
    t = term.FrameWriter(TtyStream())
    assert t.is_tty is True


def test_splash_reveals_full_banner():
    from asciichat_tpu.utils import ui

    frames = ui.splash_frames(columns=80)
    assert b"tpu" in frames[-1], "banner suffix never revealed"


def test_status_screen_zero_remaining_skips_log_fetch():
    from asciichat_tpu.utils import logsys, ui

    logsys.configure()
    log = logsys.get_logger("statusfill")
    for i in range(50):
        log.info("entry %d", i)
    # header alone exceeds the 1-row height -> remaining <= 0
    scr = ui.StatusScreen("server", lambda: {"clients": 1}, width=40, height=1)
    out = scr.render()
    assert len(out.split(b"\n")) == 1
    assert b"statusfill" not in out  # no log rows leaked into the frame


def test_validator_terminal_semantics():
    from asciichat_tpu.render import validator

    # trailing newline is a terminator, not a phantom row
    rep = validator.validate_frame(b"aa\nbb\n", expect_height=2)
    assert rep.valid and rep.lines == 2
    # REP default parameter is 1 (ECMA-48); zero maps to 1
    assert validator.visual_width(b"X\x1b[b") == 2
    assert validator.visual_width(b"X\x1b[0b") == 2
    assert validator.visual_width(b"X\x1b[5b") == 6
    # bare trailing ESC is invalid and not a visible column
    rep = validator.validate_frame(b"ab\x1b")
    assert not rep.valid and any("bare ESC" in e for e in rep.errors)
    assert validator.visual_width(b"ab\x1b") == 2
    # the asciigrid width is DELIBERATELY reference-byte semantics: REP
    # ignored, bytes counted (ascii.c:527-551) — pin the divergence so a
    # future "unification" cannot silently break grid byte parity
    from asciichat_tpu.render import asciigrid

    assert asciigrid.ansi_visual_width(b"X\x1b[5b") == 1
    assert validator.visual_width("é".encode()) == 1
    assert asciigrid.ansi_visual_width("é".encode()) == 2


# ---- apps/main.py config layering + stun role attrs ---------------------

def test_toml_layering_applies_only_file_keys(tmp_path):
    """Registry defaults in the snapshot must not clobber CLI positionals
    (client address) or per-mode argparse defaults (ACDS port 27225); an
    abbreviation like --wid is rejected rather than dodging the typed-flag
    protection."""
    from asciichat_tpu.apps.main import build_parser
    from asciichat_tpu.utils.options import OptionsStore, default_registry

    cfg = tmp_path / "c.toml"
    cfg.write_text("[display]\nwidth = 120\n")

    store = OptionsStore(default_registry())
    store.load_toml(str(cfg))
    assert store.last_toml_keys == {"width"}

    ap = build_parser()
    args = ap.parse_args(["client", "1.2.3.4", "--config", str(cfg)])
    assert args.address == "1.2.3.4"

    # per-mode default survives a config that doesn't mention it
    args = ap.parse_args(["discovery-service", "--config", str(cfg)])
    assert args.port == 27225

    # abbreviations are rejected outright (allow_abbrev=False)
    with pytest.raises(SystemExit):
        ap.parse_args(["mirror", "--wid", "100"])


def test_main_config_precedence_end_to_end(tmp_path):
    """Through main()'s layering: file fills unset options; explicit CLI
    wins; untouched options keep their argparse defaults."""
    import asyncio

    from asciichat_tpu.apps import main as main_mod

    cfg = tmp_path / "c.toml"
    cfg.write_text("[display]\nwidth = 120\n[network]\nport = 4321\n")
    seen = {}

    async def fake_serve(args):
        seen.update(vars(args))
        return 0

    # ride the server subcommand with a stubbed runner: parse + layering
    # are main()'s, only the server launch is replaced
    import asciichat_tpu.apps.server as server_mod

    orig = server_mod.main

    def fake_main(args):
        seen.update(vars(args))
        return 0

    server_mod.main = fake_main
    try:
        rc = main_mod.main(["server", "--config", str(cfg), "--width", "77"])
    finally:
        server_mod.main = orig
    assert rc == 0
    assert seen["width"] == 77  # CLI beats file
    assert seen["port"] == 4321  # file beats default
    assert seen["height"] == 0  # untouched default intact


def test_stun_requests_carry_session_role_attrs():
    from asciichat_tpu.net import stun

    txid = stun.new_transaction_id()
    req1 = stun.make_binding_request(txid, "a:b", b"pw", controlling=True)
    req2 = stun.make_binding_request(stun.new_transaction_id(), "a:b", b"pw",
                                     controlling=True)
    _, _, attrs1 = stun.parse(req1)
    _, _, attrs2 = stun.parse(req2)
    # constant per-session tie-breaker (RFC 8445 s16.1)
    assert attrs1[stun.ATTR_ICE_CONTROLLING] == attrs2[stun.ATTR_ICE_CONTROLLING]
    assert len(attrs1[stun.ATTR_ICE_CONTROLLING]) == 8
    # controlled side sends ICE-CONTROLLED (s7.1.3), no USE-CANDIDATE
    reqc = stun.make_binding_request(stun.new_transaction_id(), "a:b", b"pw",
                                     controlling=False)
    _, _, attrsc = stun.parse(reqc)
    assert attrsc[stun.ATTR_ICE_CONTROLLED] == attrs1[stun.ATTR_ICE_CONTROLLING]
    assert stun.ATTR_USE_CANDIDATE not in attrsc


# ---- runtime ring/audiodev/native_build + renderfile sweep --------------

def test_audio_ring_write_flattens_and_counts_all_samples():
    from asciichat_tpu.runtime.ringbuffer import AudioRing

    ring = AudioRing(4096)
    wrote = ring.write(np.ones((480, 2), np.float32))
    assert wrote == 960  # len() of a 2-D array would have said 480
    assert len(ring) == 960


def test_server_audio_tick_sheds_backlog():
    """A burst that fills a client's ring must not leave permanent
    latency: the tick discards backlog past ~4 frames before reading."""
    from asciichat_tpu.apps import server as server_mod
    from asciichat_tpu.ops import audio as audio_ops

    srv = server_mod.AsciiChatServer()
    c = server_mod.ClientState(1, type("T", (), {
        "send_nowait": staticmethod(lambda *a, **k: True),
        "peername": ("127.0.0.1", 0)})())
    c.has_caps = True
    n = audio_ops.AUDIO_FRAME_SAMPLES
    # burst: fill way past the backlog cap with a ramp so we can tell
    # WHICH samples survive
    ramp = np.arange(20 * n, dtype=np.float32)
    c.audio.write(ramp)
    srv._audio_tick([c])
    # after one tick the backlog is capped at <= 4n - n consumed
    assert len(c.audio) <= 4 * n
    # and the surviving samples are the NEWEST (oldest were shed)
    leftover = c.audio.read(n)
    assert leftover[0] >= ramp.size - 4 * n - 1


def test_native_build_surfaces_compiler_errors(tmp_path, monkeypatch):
    """A failed compile must raise with the g++ diagnostics, and never
    leave a half-written .so behind."""
    from asciichat_tpu.runtime import native_build as nb

    src = tmp_path / "broken.cpp"
    src.write_text("int main( { this does not compile }")
    out = tmp_path / "libbroken.so"
    with pytest.raises(RuntimeError) as ei:
        nb._compile(src, out)
    assert "error" in str(ei.value).lower()
    assert not out.exists()
    assert not list(tmp_path.glob("*.tmp*"))  # temp cleaned up


def test_renderfile_all_modes_produce_pixels():
    """EVERY render mode must be render-file-able (the common non-truecolor
    terminals included); half-block at scale=1 must not yield zero-height
    frames."""
    import jax.numpy as jnp

    from asciichat_tpu.models.renderfile import cells_to_pixels, records_to_pixels
    from asciichat_tpu.ops import cells
    from asciichat_tpu.render import palette as pal

    rng = np.random.default_rng(5)
    frames = jnp.asarray(rng.integers(0, 256, (1, 16, 20, 3), dtype=np.uint8))
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    for mode in cells.MODES:
        recs = cells.render_cells(frames, ramp, dst_h=16, dst_w=20, mode=mode)
        px = np.asarray(records_to_pixels(recs, mode, pal.DEFAULT_PALETTE))
        assert px.ndim == 4 and px.shape[0] == 1 and px.shape[-1] == 3, mode
        assert px.shape[1] > 0 and px.shape[2] > 0, mode
        # scale=1 half-block: still at least one pixel row per cell row
        px1 = np.asarray(cells_to_pixels(
            {k: v for k, v in recs.items()}, mode, scale=1))
        assert px1.shape[1] > 0, f"{mode} at scale=1 lost all rows"


def test_renderfile_no_encoder_fails_loudly(tmp_path, monkeypatch):
    """Asking for a container no encoder can produce must raise, not print
    success while the file does not exist."""
    import shutil as _sh

    from asciichat_tpu.models import renderfile as rf
    from asciichat_tpu.render.types import TerminalCapabilities
    from asciichat_tpu.runtime.codecs import CodecUnavailable
    from asciichat_tpu.runtime.framesource import TestPatternSource

    class NoRec:
        def __init__(self, *a, **k):
            raise CodecUnavailable("nope")

    monkeypatch.setattr(rf, "NativeRecorder", NoRec)
    monkeypatch.setattr(rf.shutil, "which", lambda n: None)
    out = tmp_path / "clip.mp4"
    with pytest.raises(RuntimeError, match="no encoder"):
        rf.render_to_file(TestPatternSource(64, 48), str(out),
                          TerminalCapabilities(), 20, 8,
                          "   ...',;:clodxkO0KXNWM", max_frames=2, fps=10)
    assert not out.exists()
    assert (tmp_path / "clip.mp4.y4m").exists()  # raw frames preserved


def test_playback_sink_survives_dead_speaker(tmp_path, monkeypatch):
    """aplay dying mid-session must not raise out of write()."""
    import shutil as _sh
    import subprocess

    from asciichat_tpu.runtime import audiodev

    monkeypatch.setattr(audiodev.shutil, "which",
                        lambda n: "/bin/true" if n == "aplay" else None)

    real_popen = subprocess.Popen

    def fake_popen(cmd, **kw):
        # a process that exits immediately: first write hits BrokenPipe
        return real_popen([sys.executable, "-c", "pass"], **kw)

    monkeypatch.setattr(audiodev.subprocess, "Popen", fake_popen)
    sink = audiodev.PlaybackSink()
    import time as _t

    _t.sleep(0.3)  # let the child exit
    for _ in range(3):  # repeated writes: degrade silently, keep counting
        sink.write(np.zeros(480, np.float32))
    assert sink.frames >= 3 if hasattr(sink, "frames") else True
    sink.close()


# ---- net/{packet,transport} + ops/compositor sweep ----------------------

def test_zstd_bomb_rejected():
    """A frame whose zstd header declares a size past the cap must be
    rejected BEFORE decompression — python-zstandard ignores
    max_output_size for declared-size frames, so the old cap allocated and
    filled the attacker-declared size (remote OOM)."""
    import zstandard

    from asciichat_tpu.net import packet as pkt

    bomb = zstandard.ZstdCompressor(level=1).compress(b"\0" * (10 << 20))
    assert len(bomb) < 20_000  # tiny wire bytes, 10 MB declared
    with pytest.raises(ValueError, match="declared size"):
        pkt.decompress(bomb, 1024)
    # corrupt body -> ValueError (the bad-data disconnect contract), not
    # a ZstdError escaping the protocol handlers
    with pytest.raises(ValueError):
        pkt.decompress(b"not zstd at all", 1024)
    # honest frames still round-trip (declared <= cap)
    data = b"x" * 5000
    comp, was = pkt.maybe_compress(data, 1)
    assert was and pkt.decompress(comp, 5000) == data
    # unpack_ascii_frame end-to-end: bomb inside a frame payload
    hdr = pkt.ASCII_FRAME_HDR.pack(10, 10, 1024, len(bomb),
                                   pkt.crc32c(b""), 0)
    with pytest.raises(ValueError):
        pkt.unpack_ascii_frame(hdr + bomb)


def test_transport_full_queue_disconnects_not_blocks():
    """send() on a full queue (stalled peer) must raise ConnectionError —
    blocking would freeze the caller's recv loop; close() with a dead
    sender + full queue must not deadlock."""
    import asyncio

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.transport import Transport

    async def run():
        class DeadWriter:
            def write(self, b):
                pass

            async def drain(self):
                await asyncio.sleep(3600)  # stalled peer: never drains

            def close(self):
                pass

            async def wait_closed(self):
                pass

            def get_extra_info(self, k):
                return ("1.2.3.4", 5)

        t = Transport(None, DeadWriter())
        t.start_sender()
        await asyncio.sleep(0.05)  # sender picks up the first packet
        for _ in range(t._send_queue.maxsize):
            if not t.send_nowait(pkt.PacketType.PING, b"x"):
                break
        assert t._send_queue.full()
        with pytest.raises(ConnectionError):
            await t.send(pkt.PacketType.PING, b"y")
        # close() must return despite the full queue + stalled sender
        await asyncio.wait_for(t.close(), 5)

    asyncio.run(asyncio.wait_for(run(), 30))


def test_compositor_degenerate_layouts_safe():
    """More sources than composite rows on a tiny terminal: no div-zero,
    no crash, overflow sources skipped; a 0-px CONTAIN fit composites
    nothing (stream.c:711 parity), not a 1-px strip."""
    import warnings

    from asciichat_tpu.ops import compositor

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a RuntimeWarning would raise
        plan = compositor.plan_composite([(64, 48)] * 25, 20, 10)
    assert plan.width_px == 20
    # extreme aspect: 800x1 source in a small cell -> fitted height 0 ->
    # drawn NOWHERE
    plan = compositor.plan_composite([(800, 1), (64, 48)], 40, 12)
    assert not (plan.client_idx == 0).any(), \
        "0-px CONTAIN fit drew a visible strip"
    assert (plan.client_idx == 1).any()  # the normal source still renders


# ---- net/discovery session lifecycle sweep ------------------------------

def test_session_lifecycle_end_frees_string_and_participants():
    """Ending a session frees its string immediately (no tombstone PK
    squat) and deletes its participants (no ghost members on reuse)."""
    from asciichat_tpu.net.discovery import SessionDatabase

    db = SessionDatabase()
    info = db.create_session("host-a", "1.2.3.4", 27224)
    s = info.session_string
    db.join(s, "peer-b", "5.6.7.8", 1)
    assert db.end_session(s, "host-a") is True
    assert db.lookup(s) is None
    # the string is reusable NOW, and old participants do not resurface
    info2 = db.create_session("host-c", "9.9.9.9", 27224, session_string=s)
    assert info2.participants == ["host-c"]


def test_session_idle_expiry_and_activity_refresh(monkeypatch):
    """Expiry keys on ACTIVITY (database.c:871 semantics): an old-but-active
    session survives past the idle TTL; an idle one expires with its
    participants."""
    import asciichat_tpu.net.discovery as disc

    db = disc.SessionDatabase()
    t = [1000.0]
    monkeypatch.setattr(disc.time, "time", lambda: t[0])
    info = db.create_session("h", "1.1.1.1", 1)
    s = info.session_string
    # 2x the idle TTL passes, but activity keeps refreshing
    for _ in range(4):
        t[0] += disc.SESSION_IDLE_TTL_S * 0.5
        db.touch(s)
        db._last_expire = 0.0  # defeat the throttle for the test
        assert db.lookup(s) is not None, "active session expired"
    # now it goes idle past the TTL
    t[0] += disc.SESSION_IDLE_TTL_S + 1
    db._last_expire = 0.0
    assert db.lookup(s) is None
    # participants were cleaned with it
    n = db.db.execute("SELECT COUNT(*) FROM participants").fetchone()[0]
    assert n == 0


def test_session_string_validation_and_reservation_safety():
    """create_session validates explicit strings (an arbitrary blob must
    not become a broadcast PK), refuses strings reserved by another owner,
    and consumes the owner's reservation on use."""
    from asciichat_tpu.net.discovery import SessionDatabase

    db = SessionDatabase()
    with pytest.raises(ValueError, match="invalid"):
        db.create_session("h", "1.1.1.1", 1, session_string="A" * 100000)
    assert db.reserve_string("swift-river-oak", "alice")
    with pytest.raises(ValueError, match="reserved"):
        db.create_session("bob", "1.1.1.1", 1,
                          session_string="swift-river-oak")
    info = db.create_session("alice", "1.1.1.1", 1,
                             session_string="swift-river-oak")
    assert info.session_string == "swift-river-oak"
    # reservation consumed: after the session ends, anyone may take it
    db.end_session("swift-river-oak", "alice")
    assert db.reservation_owner("swift-river-oak") is None


def test_reservation_renew_respects_expiry(monkeypatch):
    import asciichat_tpu.net.discovery as disc

    db = disc.SessionDatabase()
    t = [5000.0]
    monkeypatch.setattr(disc.time, "time", lambda: t[0])
    assert db.reserve_string("brave-cloud-fox", "alice")
    t[0] += disc.RESERVATION_TTL_S - 1
    assert db.renew_string("brave-cloud-fox", "alice") is True
    t[0] += disc.RESERVATION_TTL_S + 1
    # lapsed: renew must fail even though no sweep ran in between
    assert db.renew_string("brave-cloud-fox", "alice") is False


# ---- websocket/webclient/ansiparse sweep --------------------------------

def test_ws_transport_full_queue_parity():
    """WebSocketTransport.send mirrors the TCP twin: full queue / dead
    sender -> ConnectionError, never an indefinite block."""
    import asyncio

    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.websocket import WebSocketConnection, WebSocketTransport

    async def run():
        class StallWriter:
            def write(self, b):
                pass

            async def drain(self):
                await asyncio.sleep(3600)

            def close(self):
                pass

            async def wait_closed(self):
                pass

            def get_extra_info(self, k):
                return ("1.2.3.4", 5)

        ws = WebSocketConnection(None, StallWriter(), is_client=False)
        t = WebSocketTransport(ws)
        t.start_sender()
        await asyncio.sleep(0.05)
        while t.send_nowait(pkt.PacketType.PING, b"x"):
            pass
        with pytest.raises(ConnectionError):
            await t.send(pkt.PacketType.PING, b"y")
        await asyncio.wait_for(t.close(), 5)

    asyncio.run(asyncio.wait_for(run(), 30))


def test_ws_reserved_opcode_and_orphan_cont_fail():
    """Reserved opcodes and orphan continuations fail the connection
    (RFC 6455 5.2/5.4) instead of returning partial messages."""
    import asyncio
    import struct as st

    from asciichat_tpu.net.websocket import WebSocketConnection

    async def run(frames: bytes):
        r = asyncio.StreamReader()
        r.feed_data(frames)
        r.feed_eof()
        ws = WebSocketConnection(r, None, is_client=False)
        return await ws.recv_message()

    # TEXT (no FIN) then a reserved-opcode FIN frame
    frag = st.pack(">BB", 0x01, 2) + b"ab" + st.pack(">BB", 0x83, 0)
    with pytest.raises(ValueError, match="reserved"):
        asyncio.run(run(frag))
    # orphan continuation
    orphan = st.pack(">BB", 0x80, 2) + b"xy"
    with pytest.raises(ValueError, match="continuation"):
        asyncio.run(run(orphan))


def test_ws_duplicate_headers_comma_join():
    import asyncio

    from asciichat_tpu.net.websocket import _read_http_headers

    async def run():
        r = asyncio.StreamReader()
        r.feed_data(b"GET / HTTP/1.1\r\n"
                    b"Sec-WebSocket-Extensions: permessage-deflate\r\n"
                    b"Sec-WebSocket-Extensions: other-ext\r\n\r\n")
        r.feed_eof()
        return await _read_http_headers(r)

    _, headers = asyncio.run(run())
    assert headers["sec-websocket-extensions"] == \
        "permessage-deflate, other-ext"


def test_deflate_response_unsupportable_fails_handshake():
    from asciichat_tpu.net.websocket import parse_deflate_response

    ok, w, nc = parse_deflate_response(
        "permessage-deflate; client_max_window_bits=12; "
        "client_no_context_takeover")
    assert (ok, w, nc) == (True, 12, True)
    with pytest.raises(ConnectionError):
        parse_deflate_response("permessage-deflate; client_max_window_bits=8")
    with pytest.raises(ConnectionError):
        parse_deflate_response("permessage-deflate; foo=bar")
    # a server selecting an extension we never OFFERED fails the handshake
    # (RFC 6455 §4.1 / 7692 §7.1) — it would apply framing we can't parse
    with pytest.raises(ConnectionError, match="unoffered"):
        parse_deflate_response("x-unknown-ext")
    with pytest.raises(ConnectionError, match="unoffered"):
        parse_deflate_response("permessage-deflate, x-custom")
    # an EMPTY response still means "not negotiated", no error
    assert parse_deflate_response("")[0] is False


def test_gateway_malformed_offer_is_404():
    """sdp.parse ValueError (a=sctp-port:junk) must yield None (404), not
    escape and kill the HTTP connection."""
    import asyncio

    from asciichat_tpu.apps.webclient import WebRtcGateway

    async def run():
        gw = WebRtcGateway(lambda t: None)
        bad = (b"v=0\r\no=- 1 1 IN IP4 0.0.0.0\r\ns=-\r\n"
               b"m=application 9 UDP/DTLS/SCTP webrtc-datachannel\r\n"
               b"a=ice-ufrag:ab\r\na=ice-pwd:xy\r\n"
               b"a=fingerprint:sha-256 AA:BB\r\na=sctp-port:junk\r\n")
        assert await gw.on_offer(bad) is None
        gw.close()

    asyncio.run(run())


def test_ansiparse_rep_grows_grid_past_initial_capacity():
    """A uniform row emitted as glyph+REP wider than the initial capacity
    must realloc like literal glyphs do, not silently truncate at 256."""
    from asciichat_tpu.web import ansiparse

    wide = 300
    text = "X\x1b[%db" % (wide - 1)
    g = ansiparse.AnsiGrid().parse(text)
    assert g.w == wide, f"REP row truncated at {g.w}"
    for x in range(wide):
        assert g.cell(x, 0)[0] == ord("X"), x
    # flood stays memory-bounded (capacity clamp, not unbounded realloc)
    flood = ansiparse.AnsiGrid().parse("X\x1b[2000000000b")
    assert flood.w <= flood.cap_w <= 16384


def test_jaxcache_repartitions_on_topology_change(monkeypatch, tmp_path):
    """entry() then dryrun_multichip(8) in one process changes the topology
    key; a once-latched cache dir would persist 8-device executables into
    the 1-device partition. ensure() must re-point the dir when the key
    changes, and stay inert under pytest."""
    import jax

    from asciichat_tpu.utils import jaxcache

    old_dir = jax.config.jax_compilation_cache_dir
    old_key = jaxcache._key_applied
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jaxcache, "CACHE_ROOT", str(tmp_path))
        # under pytest (PYTEST_CURRENT_TEST set): hard no-op
        jaxcache._key_applied = None
        jaxcache.ensure()
        assert jax.config.jax_compilation_cache_dir == old_dir
        assert jaxcache._key_applied is None

        # outside pytest: applies, then re-applies on a topology change
        monkeypatch.delenv("PYTEST_CURRENT_TEST")
        monkeypatch.setattr(jaxcache, "_topology_key", lambda: "topoA")
        jaxcache.ensure()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "topoA")
        monkeypatch.setattr(jaxcache, "_topology_key", lambda: "topoB")
        jaxcache.ensure()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "topoB")
    finally:
        jaxcache._key_applied = old_key
        jax.config.update("jax_compilation_cache_dir", old_dir)


def test_jaxcache_env_dir_used_as_given(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is honoured as given: ensure() adds no
    subdirectory and sets nothing."""
    import jax

    from asciichat_tpu.utils import jaxcache

    old_dir = jax.config.jax_compilation_cache_dir
    old_key = jaxcache._key_applied
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        monkeypatch.delenv("PYTEST_CURRENT_TEST")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
        monkeypatch.setattr(jaxcache, "CACHE_ROOT", str(tmp_path / "root"))
        jaxcache._key_applied = None
        jaxcache.ensure()
        assert jax.config.jax_compilation_cache_dir == old_dir
        assert jax.config.jax_persistent_cache_min_compile_time_secs == old_min
        assert not (tmp_path / "root").exists()
    finally:
        jaxcache._key_applied = old_key
        jax.config.update("jax_compilation_cache_dir", old_dir)


def test_jaxcache_default_is_inside_checkout():
    """Without the env var the cache is a fixed path in the checkout, and
    that path is ignored by git."""
    import pathlib

    from asciichat_tpu.utils import jaxcache

    repo = pathlib.Path(__file__).resolve().parents[1]
    root = pathlib.Path(jaxcache.CACHE_ROOT)
    assert root.parent == repo
    assert f"{root.name}/" in (repo / ".gitignore").read_text().split()


# ---- apps/server.py serving-path sweep ----------------------------------


class _FakeServerTransport:
    """Minimal async Transport double for AsciiChatServer tests."""

    def __init__(self, packets=(), block=False):
        self._packets = list(packets)
        self._block = block
        self.sent = []
        self.peername = ("127.0.0.1", 1)

    async def send(self, ptype, payload=b""):
        self.sent.append((int(ptype), payload))

    def send_nowait(self, ptype, payload=b"", **kw):
        self.sent.append((int(ptype), payload))
        return True

    async def recv(self):
        import asyncio

        if self._packets:
            return self._packets.pop(0)
        if self._block:
            await asyncio.Event().wait()  # half-open: never completes
        raise asyncio.IncompleteReadError(b"", 1)

    async def close(self):
        pass


def test_server_cap_counts_pending_handshakes():
    """MAX_CLIENTS must count connections still mid-handshake: the cap
    check was check-then-act across awaits, so a concurrent burst all
    passed while self.clients was still small."""
    import asyncio

    from asciichat_tpu.apps import server as server_mod
    from asciichat_tpu.net import packet as pkt

    srv = server_mod.AsciiChatServer()
    srv._pending_conns = server_mod.MAX_CLIENTS  # a burst mid-handshake
    t = _FakeServerTransport()
    asyncio.run(asyncio.wait_for(srv._handle_conn(t), 10))
    assert not srv.clients
    assert srv._pending_conns == server_mod.MAX_CLIENTS  # reject didn't touch it
    assert t.sent and t.sent[0][0] == int(pkt.PacketType.ERROR_MESSAGE)


def test_server_half_open_handshake_times_out(monkeypatch):
    """A connection that sends nothing is not in self.clients, so the
    keepalive sweep can never reclaim it — the pre-registration phase
    needs its own deadline or fds leak forever."""
    import asyncio

    from asciichat_tpu.apps import server as server_mod

    monkeypatch.setattr(server_mod, "HANDSHAKE_TIMEOUT_S", 0.05)
    srv = server_mod.AsciiChatServer()
    t = _FakeServerTransport(block=True)
    asyncio.run(asyncio.wait_for(srv._handle_conn(t), 10))
    assert not srv.clients
    assert srv._pending_conns == 0  # reservation released on timeout


def test_server_audio_batch_validates_format():
    """AUDIO_BATCH with a non-48k/mono header must be a bad-data
    disconnect, not silently mixed as pitch-shifted/interleaved noise."""
    import asyncio

    from asciichat_tpu.apps import server as server_mod
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.ops import audio as audio_ops

    srv = server_mod.AsciiChatServer()
    body = np.zeros(480, np.float32).tobytes()

    bad = pkt.pack_audio_batch(body, 480, 1, sample_rate=44_100, channels=1)
    c = server_mod.ClientState(
        1, _FakeServerTransport([(int(pkt.PacketType.AUDIO_BATCH), bad)]))
    with pytest.raises(ValueError, match="audio format"):
        asyncio.run(asyncio.wait_for(srv._recv_loop(c), 10))
    assert len(c.audio) == 0  # nothing reached the mixer ring

    stereo = pkt.pack_audio_batch(body, 480, 1,
                                  sample_rate=audio_ops.SAMPLE_RATE, channels=2)
    c2 = server_mod.ClientState(
        2, _FakeServerTransport([(int(pkt.PacketType.AUDIO_BATCH), stereo)]))
    with pytest.raises(ValueError, match="audio format"):
        asyncio.run(asyncio.wait_for(srv._recv_loop(c2), 10))

    good = pkt.pack_audio_batch(body, 480, 1,
                                sample_rate=audio_ops.SAMPLE_RATE, channels=1)
    c3 = server_mod.ClientState(
        3, _FakeServerTransport([(int(pkt.PacketType.AUDIO_BATCH), good)]))
    with pytest.raises(asyncio.IncompleteReadError):  # clean end-of-stream
        asyncio.run(asyncio.wait_for(srv._recv_loop(c3), 10))
    assert len(c3.audio) == 480


def test_frame_age_counts_only_advancing_frames():
    """frame_age re-sampled a STALE frame on every 60 Hz tick, so the
    upload->pickup metric grew with the client's capture cadence (or a
    paused capture), not pickup latency: gate on sequence advance."""
    from asciichat_tpu.apps import server as server_mod

    srv = server_mod.AsciiChatServer()
    c = server_mod.ClientState(1, _FakeServerTransport())
    c.streaming = True  # streaming but has_caps=False: age sampling runs,
    # then the tick returns early at the no-receivers check (no jit work)
    c.video.commit(np.zeros((8, 8, 3), np.uint8))
    srv._render_tick([c])
    srv._render_tick([c])
    srv._render_tick([c])
    assert srv.frame_age.count == 1  # stale frame counted once, not 3x
    c.video.commit(np.zeros((8, 8, 3), np.uint8))
    srv._render_tick([c])
    assert srv.frame_age.count == 2  # advancing seq counts again


def test_desired_fps_pacing_is_sub_tick_only():
    """desired_fps below the 60 Hz tick paces sends; >= tick rate (the
    default 60) is never paced so existing clients see every tick."""
    from asciichat_tpu.apps import server as server_mod

    srv = server_mod.AsciiChatServer()

    slow = server_mod.ClientState(1, _FakeServerTransport())
    slow.wire_caps.desired_fps = 10
    assert not srv._frame_paced_out(slow, 100.0)   # first frame sends
    assert srv._frame_paced_out(slow, 100.02)      # paced out (< 100 ms gap)
    assert srv._frame_paced_out(slow, 100.09)
    assert not srv._frame_paced_out(slow, 100.11)  # next 10 Hz slot
    # ~1 s of 60 Hz ticks delivers ~10 frames, not 60
    sent = sum(
        not srv._frame_paced_out(slow, 101.0 + i / 60.0) for i in range(60)
    )
    assert 9 <= sent <= 11

    default = server_mod.ClientState(2, _FakeServerTransport())
    assert default.wire_caps.desired_fps == 60
    assert all(
        not srv._frame_paced_out(default, 200.0 + i / 60.0) for i in range(10)
    )

    unset = server_mod.ClientState(3, _FakeServerTransport())
    unset.wire_caps.desired_fps = 0  # "no preference" never paces
    assert not srv._frame_paced_out(unset, 300.0)
    assert not srv._frame_paced_out(unset, 300.001)


def test_audio_cadence_survives_slow_render_tick(monkeypatch):
    """The 100 Hz audio tick ran inline after the video render await, so
    a slow render (worst: a first-time RenderGroup jit compile) silenced
    audio for everyone; the audio loop must be an independent task."""
    import asyncio

    from asciichat_tpu.apps import server as server_mod

    srv = server_mod.AsciiChatServer()
    ticks = {"audio": 0}

    def slow_render(snapshot):
        time.sleep(0.25)  # a render tick far past the audio deadline

    def count_audio(snapshot):
        ticks["audio"] += 1

    monkeypatch.setattr(srv, "_render_tick", slow_render)
    monkeypatch.setattr(srv, "_audio_tick", count_audio)

    async def run():
        task = asyncio.get_running_loop().create_task(srv._tick_loop())
        await asyncio.sleep(0.6)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    asyncio.run(asyncio.wait_for(run(), 30))
    # inline cadence got ~2-3 audio ticks behind two 250 ms renders; the
    # dedicated loop gets dozens — assert well above the broken ceiling
    assert ticks["audio"] >= 10


# ---- DTLS/SCTP/DataChannel/SDP sweep ------------------------------------


def _sctp_pair_established():
    """Establish an in-memory SCTP association pair (no DTLS)."""
    from asciichat_tpu.net.sctp import SctpAssociation

    now = [0.0]
    qa, qb = [], []
    a = SctpAssociation(qb.append, client=True, now_fn=lambda: now[0])
    b = SctpAssociation(qa.append, client=False, now_fn=lambda: now[0])

    def pump(iters=100):
        for _ in range(iters):
            moved = False
            while qb:
                b.on_packet(qb.pop(0))
                moved = True
            while qa:
                a.on_packet(qa.pop(0))
                moved = True
            now[0] += 0.05
            a.tick()
            b.tick()
            if not moved and not qa and not qb:
                break

    a.connect()
    pump()
    assert a.state == b.state == "established"
    return a, b, qa, qb, now, pump


def test_sctp_drops_stale_reordered_sack():
    """RFC 9260 §6.2.1: a SACK whose cumulative TSN is OLDER than the
    current ack point (UDP reordering) must be dropped whole — processing
    it overwrote peer_rwnd with stale data (a stale rwnd=0 stalls the
    sender until the next SACK) and re-ran miss counters."""
    import struct

    from asciichat_tpu.net import sctp as sctp_mod

    a, b, qa, qb, now, pump = _sctp_pair_established()
    a.send(0, sctp_mod.PPID_BINARY, b"x" * 100)
    a.send(0, sctp_mod.PPID_BINARY, b"y" * 100)
    pump()
    assert not a._outstanding  # everything acked
    cur = a._cum_acked
    assert cur is not None
    fresh_rwnd = a.peer_rwnd
    # craft a stale SACK: cum one older, advertising rwnd=0
    stale = sctp_mod._SACK_HDR.pack(sctp_mod._u32(cur - 1), 0, 0, 0)
    a._on_sack(stale)
    assert a.peer_rwnd == fresh_rwnd  # stale SACK fully ignored
    assert a._cum_acked == cur
    # an equal-or-newer SACK still processes
    a._on_sack(sctp_mod._SACK_HDR.pack(cur, 12345, 0, 0))
    assert a.peer_rwnd == 12345


def test_sctp_send_raises_during_shutdown():
    """send() in shutdown states must raise, not queue silently: _flush
    never transmits in shutdown-sent/received, so queued data was
    black-holed with a success return."""
    from asciichat_tpu.net import sctp as sctp_mod

    a, b, qa, qb, now, pump = _sctp_pair_established()
    a.shutdown()
    assert a.state == "shutdown-sent"
    with pytest.raises(ConnectionError):
        a.send(0, sctp_mod.PPID_BINARY, b"late")
    # deliver the SHUTDOWN to b: shutdown-received must also reject sends
    while qb:
        b.on_packet(qb.pop(0))
    assert b.state in ("shutdown-received", "done")
    if b.state == "shutdown-received":
        with pytest.raises(ConnectionError):
            b.send(0, sctp_mod.PPID_BINARY, b"late")


def test_dtls_context_shared_per_identity():
    """Each endpoint built its own SSL_CTX and appended a fresh ctypes
    verify callback to a never-pruned list — an unbounded per-connection
    leak. The context is now shared per identity with ONE process-wide
    callback, and the handshake still completes."""
    from asciichat_tpu.net import dtls as dtls_mod

    if not dtls_mod.available():
        pytest.skip("no OpenSSL 3")
    ident = dtls_mod.DtlsIdentity.generate("ctx-share")
    srv = dtls_mod.DtlsEndpoint(ident, server=True)
    cli = dtls_mod.DtlsEndpoint(ident, server=False)
    assert srv._ctx == cli._ctx  # one SSL_CTX per identity
    assert ident._ssl_ctx
    assert not hasattr(dtls_mod, "_verify_cb_refs")  # the leak list is gone
    from tests.test_datachannel import _pump_dtls

    cli.start()
    assert _pump_dtls(cli, srv)
    assert srv.peer_fingerprint == ident.fingerprint
    cli.write(b"ping")
    for dg in cli.outgoing():
        srv.incoming(dg)
    assert srv.read() == [b"ping"]


def test_datachannel_close_sends_farewell_and_peer_detects():
    """Graceful close: (a) the SCTP SHUTDOWN / DTLS close_notify must
    actually reach the wire (self.closed was set BEFORE sctp.shutdown(),
    so _sctp_out dropped the farewell), and (b) the peer must detect the
    clean close (dtls.closed was never observed — recv() blocked forever
    on a dead association with nothing in flight)."""
    import asyncio

    from asciichat_tpu.net import dtls as dtls_mod

    if not dtls_mod.available():
        pytest.skip("no OpenSSL 3")
    from tests.test_datachannel import _mk_agents

    async def run():
        a, b = _mk_agents()
        await a.start("127.0.0.1")
        await b.start("127.0.0.1")
        try:
            b.set_remote(a.local_description())
            a.set_remote(b.local_description())
            ch_a = await (await a.wait_connected(10)).wait_ready(10)
            ch_b = await (await b.wait_connected(10)).wait_ready(10)
            await ch_a.send(3000, b"hello")
            assert (await ch_b.recv())[1] == b"hello"
            # count farewell datagrams leaving a's carrier during close
            sent = []
            real = ch_a._send_datagram
            ch_a._send_datagram = lambda dg: (sent.append(len(dg)),
                                              real(dg))[-1]
            await ch_a.close()
            assert sent, "close() put no farewell datagram on the wire"
            # after a clean local close, send/recv must raise (not hang
            # or silently black-hole)
            with pytest.raises(ConnectionError):
                await ch_a.send(3000, b"late")
            with pytest.raises(ConnectionError):
                await asyncio.wait_for(ch_a.recv(), 5)
            # the peer observes the close: recv() unblocks with an error
            with pytest.raises(ConnectionError):
                await asyncio.wait_for(ch_b.recv(), 10)
            assert ch_b.closed
        finally:
            a.close()
            b.close()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_sdp_bundled_media_offer_answer():
    """A browser sharing one RTCPeerConnection for media + data sends a
    BUNDLE offer with m=audio/m=video/m=application. Parsing line-by-line
    with no m-section awareness took whichever a=mid came last and the
    answer had ONE m-line — JSEP rejects that (m-line count/order must
    match, rejected sections use port 0)."""
    from asciichat_tpu.net import sdp

    offer = "\r\n".join([
        "v=0",
        "o=- 1 2 IN IP4 127.0.0.1",
        "s=-",
        "t=0 0",
        "a=group:BUNDLE 0 1 2",
        "a=msid-semantic: WMS",
        "m=audio 9 UDP/TLS/RTP/SAVPF 111",
        "c=IN IP4 0.0.0.0",
        "a=ice-ufrag:BUNDLEUFRAG",
        "a=ice-pwd:bundlepassword1234567890",
        "a=fingerprint:sha-256 " + ":".join(["AB"] * 32),
        "a=setup:actpass",
        "a=mid:0",
        "a=candidate:1 1 udp 2130706431 192.0.2.7 50000 typ host",
        "m=video 9 UDP/TLS/RTP/SAVPF 96 97",
        "c=IN IP4 0.0.0.0",
        "a=mid:1",
        "m=application 9 UDP/DTLS/SCTP webrtc-datachannel",
        "c=IN IP4 0.0.0.0",
        "a=ice-ufrag:BUNDLEUFRAG",
        "a=ice-pwd:bundlepassword1234567890",
        "a=fingerprint:sha-256 " + ":".join(["AB"] * 32),
        "a=setup:actpass",
        "a=mid:2",
        "a=sctp-port:5000",
        "a=max-message-size:262144",
    ]) + "\r\n"
    info = sdp.parse(offer)
    assert info.mid == "2"  # the APP section's mid, not the last-seen "1"...
    assert info.sctp_port == 5000
    assert info.ufrag == "BUNDLEUFRAG"
    # candidates ride the bundle-tagged (first) section — still collected
    assert info.candidates == [
        {"ip": "192.0.2.7", "port": 50000, "type": "host"}]
    assert [s["kind"] for s in info.msections] == [
        "audio", "video", "application"]

    desc = {"ufrag": "srvfrag", "pwd": "srvpassword1234567890123",
            "dtls_fp": ":".join(["CD"] * 32),
            "candidates": [{"ip": "198.51.100.1", "port": 4000,
                            "type": "host"}]}
    answer = sdp.build(desc, setup="passive", ice_lite=True, mid=info.mid,
                       offer_sections=info.msections)
    mlines = [ln for ln in answer.split("\r\n") if ln.startswith("m=")]
    # JSEP: same count, same order; non-data sections rejected with port 0
    assert len(mlines) == 3
    assert mlines[0].startswith("m=audio 0 UDP/TLS/RTP/SAVPF 111")
    assert mlines[1].startswith("m=video 0 UDP/TLS/RTP/SAVPF 96 97")
    assert mlines[2].startswith("m=application 9 UDP/DTLS/SCTP")
    assert "a=group:BUNDLE 2\r\n" in answer  # only the accepted mid
    assert "a=mid:0\r\n" in answer and "a=mid:1\r\n" in answer
    back = sdp.parse(answer)
    assert back.mid == "2" and back.ufrag == "srvfrag"
    assert back.setup == "passive" and back.sctp_port == 5000

    # single-section offers (native peers) keep the one-m-line shape
    single = sdp.build(desc, setup="actpass", ice_lite=False)
    assert [ln for ln in single.split("\r\n")
            if ln.startswith("m=")] == [
        "m=application 9 UDP/DTLS/SCTP webrtc-datachannel"]


# ---- runtime codecs / device_stream / double_buffer sweep ----------------


def test_h265_encoder_rejects_wrong_shape_frame():
    """The native shim reads height*width*3 bytes via sws_scale with no
    length info: an undersized frame (e.g. 2-D grayscale) was a heap
    overread / SIGSEGV at the ctypes boundary, not a catchable error."""
    from asciichat_tpu.runtime import codecs

    try:
        enc = codecs.NativeH265Encoder(64, 48)
    except codecs.CodecUnavailable:
        pytest.skip("no libavcodec shim")
    try:
        with pytest.raises(ValueError, match="shape"):
            enc.encode(np.zeros((48, 64), np.uint8))  # grayscale, 1/3 bytes
        with pytest.raises(ValueError, match="shape"):
            enc.encode(np.zeros((24, 64, 3), np.uint8))  # undersized
        assert isinstance(enc.encode(np.zeros((48, 64, 3), np.uint8)), list)
    finally:
        enc.close()


def test_h265_decoder_buffer_capped_by_bytes():
    """32 eager frames of headroom at the server's 800x600 upload cap was
    a 44 MB allocation per client on the event-loop thread; headroom is
    now byte-capped (>=8 frames, <=16 MB-ish) without shrinking small
    frames."""
    from asciichat_tpu.runtime import codecs

    try:
        big = codecs.NativeH265Decoder(800, 600)
    except codecs.CodecUnavailable:
        pytest.skip("no libavcodec shim")
    try:
        assert len(big._out) <= 20 << 20  # was 44 MB
        assert len(big._out) >= 8 * big._frame_bytes
        small = codecs.NativeH265Decoder(64, 48)
        assert len(small._out) == 32 * small._frame_bytes
        small.close()
    finally:
        big.close()


def test_opus_ctl_declares_fixed_argtypes():
    """opus_encoder_ctl is variadic: with no argtypes at all, macOS arm64
    passes the value in the wrong place (stack vs register) and bitrate/
    DTX ctls silently set garbage. The fixed params are now declared and
    ctl return codes checked."""
    import ctypes

    from asciichat_tpu.runtime import codecs

    try:
        lib = codecs._load_libopus()
    except codecs.CodecUnavailable:
        pytest.skip("no libopus")
    assert lib.opus_encoder_ctl.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert lib.opus_encoder_ctl.restype == ctypes.c_int
    c = codecs.OpusCodec()  # ctls run in __init__ without error
    try:
        assert len(c.encode(np.zeros(480, np.float32))) > 0
    finally:
        c.close()


def test_ffmpeg_pipe_codec_close_reaps_process():
    """close() killed ffmpeg without a follow-up wait(): the child stayed
    a zombie until Popen GC, and the drain thread was never joined."""
    from asciichat_tpu.runtime import codecs

    try:
        enc = codecs.FFmpegH265Encoder(64, 48)
    except codecs.CodecUnavailable:
        pytest.skip("no ffmpeg")
    enc.encode(np.zeros((48, 64, 3), np.uint8))
    enc.close()
    assert enc._proc.poll() is not None  # reaped, not a zombie
    assert not enc._reader.is_alive()
    # post-close encode surfaces the codec-failure contract, not a raw
    # "write to closed file" ValueError from the pipe internals
    with pytest.raises(ValueError, match="pipe closed"):
        enc.encode(np.zeros((48, 64, 3), np.uint8))


def test_pipeline_run_refuses_stale_threads():
    """run() is reusable, but a thread from a previous run that outlived
    its join timeout would wake when _stop clears and double-count into
    the new run's counters — restarting must refuse instead."""
    import threading

    from asciichat_tpu.runtime.device_stream import OverlappedRenderPipeline

    pipe = OverlappedRenderPipeline(lambda f, r: (None, None), None, None,
                                    lambda h: [], batch=1, k=1)
    gate = threading.Event()
    t = threading.Thread(target=gate.wait, name="stale-convert", daemon=True)
    t.start()
    pipe._threads = [t]
    try:
        with pytest.raises(RuntimeError, match="still alive"):
            pipe.run(0.1, warmup=0.0)
    finally:
        gate.set()


def test_latest_frame_single_read_api():
    """get_latest() was an unused near-duplicate of latest() with a
    different tuple shape (no commit timestamp — callers picking it lose
    the latency tracking input); one read path remains."""
    from asciichat_tpu.runtime.double_buffer import LatestFrame

    assert not hasattr(LatestFrame, "get_latest")
    lf = LatestFrame()
    lf.commit("x")
    frame, seq, ts = lf.latest()
    assert (frame, seq) == ("x", 1) and ts > 0


def test_client_h265_encode_runs_off_event_loop():
    """x265 encode took 5-15 ms per frame INLINE on the client's event
    loop, starving the 10 ms audio capture cadence in the same process —
    on a 1-core host the uplink tone turned to gaps/silence the moment
    --h265 switched on. The encode must run in the executor so other
    tasks keep their cadence."""
    import asyncio

    from asciichat_tpu.apps.client import AsciiChatClient

    class _Src:
        def read(self):
            return np.zeros((48, 64, 3), np.uint8)

    class _T:
        def send_nowait(self, *a, **kw):
            return True

    async def run():
        c = AsciiChatClient("127.0.0.1", 1, source=_Src(), capture_fps=30,
                            reconnect=False)
        c.h265_active = True
        c._send_h265 = lambda t, frame: time.sleep(0.05)  # worst-case encode
        ticks = {"n": 0}

        async def heartbeat():  # the audio task's 10 ms cadence stand-in
            while True:
                ticks["n"] += 1
                await asyncio.sleep(0.01)

        loop = asyncio.get_running_loop()
        hb = loop.create_task(heartbeat())
        cap = loop.create_task(c._capture_task(_T()))
        await asyncio.sleep(1.0)
        c._stop.set()
        for task in (hb, cap):
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        return ticks["n"]

    n = asyncio.run(asyncio.wait_for(run(), 30))
    # inline 50 ms encodes at 30 fps would hold the loop ~60% of the
    # time, capping the 10 ms heartbeat near ~25/s; off-loop it stays
    # close to the full ~95/s
    assert n >= 60, f"event loop starved: {n} heartbeats in 1 s"


# ---- client / session / handshake sweep ----------------------------------


def test_chat_line_strips_c1_controls():
    """The byte-level `b >= 0x80` allowlist passed C1 controls — raw
    0x80-0x9F and UTF-8-encoded U+009B (b'\\xc2\\x9b'), which terminals
    honoring 8-bit controls execute exactly like ESC[ — straight to every
    viewer's terminal. Sanitization must happen at the codepoint level."""
    import io

    from asciichat_tpu.models.session import DisplaySink

    sink = DisplaySink(stream=io.BytesIO())
    out = sink.writer.stream

    sink.chat_line(b"\xc2\x9b31mEVIL")  # UTF-8 U+009B CSI
    data = out.getvalue()
    assert b"\xc2\x9b" not in data and b"\x9b" not in data
    assert b"?31mEVIL" in data

    out.seek(0), out.truncate()
    sink.chat_line(b"\x9d0;title\x07")  # raw 8-bit OSC
    assert b"\x9d" not in out.getvalue()

    out.seek(0), out.truncate()
    sink.chat_line("héllo wörld".encode())  # real UTF-8 passes
    assert "héllo wörld".encode() in out.getvalue()

    out.seek(0), out.truncate()
    sink.chat_line(b"\x1b[31mred")  # C0 ESC still stripped
    assert b"\x1b[31m" not in out.getvalue()[5:]  # (prefix has its own SGR)


def test_secure_channel_rekey_single_start_under_race():
    """send() (loop thread) and send_nowait() (executor threads) both ran
    the needs_rekey/in_progress check-then-start unsynchronized: two
    threads could double-start a rekey, leaving _temp_private holding the
    SECOND ephemeral key while the peer answers the FIRST — the initiator
    commits a key the peer doesn't have and the session dies."""
    import threading
    import types

    from asciichat_tpu.net.handshake import SecureChannel

    class _Ctx:
        session_id = b"\x01" * 16
        previous_session_id = None

        def __init__(self):
            self.rekey = types.SimpleNamespace(in_progress=False)
            self.starts = 0
            self.barrier = threading.Barrier(2)

        def rekey_stalled(self):
            return False

        def abandon_rekey(self):
            pass

        def needs_rekey(self):
            # rendezvous: both threads reach the decision point together
            # (under the fix, the second thread is held out by the lock
            # and the barrier times out harmlessly)
            try:
                self.barrier.wait(timeout=0.3)
            except threading.BrokenBarrierError:
                pass
            return not self.rekey.in_progress

        def start_rekey(self):
            self.starts += 1
            time.sleep(0.02)  # widen the would-be race window
            self.rekey.in_progress = True
            return b"\x02" * 32

        def encrypt(self, inner):
            return b"x" * 64

    class _T:
        def send_nowait(self, *a, **kw):
            return True

    ctx = _Ctx()
    ch = SecureChannel(_T(), ctx, initiator=True)
    threads = [threading.Thread(target=lambda: ch.send_nowait(42, b"p"))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert ctx.starts == 1, f"rekey double-started ({ctx.starts}x)"


class _ScriptedTransport:
    """Yields scripted packets then end-of-stream; records sends."""

    def __init__(self, packets=()):
        self._packets = list(packets)
        self.sent = []
        self.peername = ("127.0.0.1", 9)

    async def send(self, ptype, payload=b""):
        self.sent.append((int(ptype), payload))

    def send_nowait(self, ptype, payload=b"", **kw):
        self.sent.append((int(ptype), payload))
        return True

    async def recv(self):
        import asyncio

        if self._packets:
            return self._packets.pop(0)
        raise asyncio.IncompleteReadError(b"", 1)

    async def close(self):
        pass


def test_client_survives_repeated_h265_refusals():
    """The server re-sends ERROR code 3 for every in-flight H.265 frame
    while its decoder is unavailable; gating the fallback on h265_active
    sent the SECOND error down the fatal branch and killed the client
    mid-fallback. Duplicates must be ignored, and the recv loop must not
    close the encoder (the capture task owns it, possibly mid-encode)."""
    import asyncio

    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net import protocol as proto

    err3 = proto.pack_error(3, "no decoder")
    t = _ScriptedTransport([(int(pkt.PacketType.ERROR_MESSAGE), err3)] * 3)
    c = AsciiChatClient("127.0.0.1", 1, reconnect=False)
    c.h265_active = True

    class _Enc:
        closed = False

        def close(self):
            self.closed = True

    enc = _Enc()
    c._h265_enc = enc
    with pytest.raises(asyncio.IncompleteReadError):
        asyncio.run(asyncio.wait_for(c._recv_loop(t, None), 10))
    assert not c._stop.is_set()  # duplicates did NOT kill the session
    assert not c.h265_active
    assert c._h265_enc is enc and not enc.closed  # capture task's job


def test_client_capture_task_closes_encoder_after_fallback():
    """After the recv loop flips h265_active off, the capture task (the
    encoder's sole owner) closes it between encodes — never the recv
    loop, which could free the native context under a concurrent
    executor encode."""
    import asyncio

    from asciichat_tpu.apps.client import AsciiChatClient

    class _Enc:
        closed = False

        def close(self):
            self.closed = True

    class _Src:
        def __init__(self):
            self.reads = 0

        def read(self):
            self.reads += 1
            return np.zeros((8, 8, 3), np.uint8) if self.reads == 1 else None

    c = AsciiChatClient("127.0.0.1", 1, source=_Src(), reconnect=False)
    enc = _Enc()
    c._h265_enc = enc
    c.h265_active = False  # recv loop already fell back
    asyncio.run(asyncio.wait_for(c._capture_task(_ScriptedTransport()), 10))
    assert enc.closed and c._h265_enc is None


def test_client_h265_fallback_closes_encoder_on_encode_error():
    """The transient-encode-failure fallback dropped the encoder with
    `_h265_enc = None` and no close(): the native context (or the ffmpeg
    child) leaked until interpreter exit."""
    from asciichat_tpu.apps.client import AsciiChatClient

    class _Enc:
        width, height = 8, 8
        closed = False

        def encode(self, frame):
            raise ValueError("avcodec_send_frame -1")

        def close(self):
            self.closed = True

    c = AsciiChatClient("127.0.0.1", 1, reconnect=False)
    enc = _Enc()
    c._h265_enc = enc
    c.h265_active = True
    c._send_h265(_ScriptedTransport(), np.zeros((8, 8, 3), np.uint8))
    assert not c.h265_active
    assert enc.closed and c._h265_enc is None


def test_client_session_resets_dead_link_clock(monkeypatch):
    """_last_rx survived across reconnects: after a silent-death close,
    the NEW session's keepalive compared against the pre-reconnect
    timestamp and could kill the healthy link before the server's first
    packet arrived."""
    import asyncio

    from asciichat_tpu.apps import client as client_mod

    t = _ScriptedTransport()

    async def fake_connect(host, port):
        return t

    monkeypatch.setattr(client_mod, "connect_tcp", fake_connect)
    c = client_mod.AsciiChatClient("127.0.0.1", 1, reconnect=False)
    c._last_rx = time.monotonic() - 100  # stale from a dead previous session
    with pytest.raises(asyncio.IncompleteReadError):  # scripted end-of-stream
        asyncio.run(asyncio.wait_for(c._session(None), 10))
    assert time.monotonic() - c._last_rx < 10  # fresh clock for the session


def test_client_caches_argon2_password_key(monkeypatch):
    """Every reconnect re-ran the full 64 MiB Argon2id derivation for an
    identical deterministic-salt key; it is now derived once per client
    and reused across sessions."""
    import asyncio

    from asciichat_tpu.apps import client as client_mod

    derivations = {"n": 0}

    def fake_set_password(self, password):
        derivations["n"] += 1
        self.password_key = b"k" * 32

    async def fake_handshake(*a, **kw):
        return False  # proceed unencrypted (no SecureChannel needed)

    monkeypatch.setattr(client_mod.CryptoContext, "set_password",
                        fake_set_password)
    monkeypatch.setattr(client_mod, "client_handshake", fake_handshake)

    c = client_mod.AsciiChatClient("127.0.0.1", 1, reconnect=False,
                                   encrypt=True, password="hunter2")

    async def run_twice():
        for _ in range(2):
            t = _ScriptedTransport()

            async def fake_connect(host, port, _t=t):
                return _t

            monkeypatch.setattr(client_mod, "connect_tcp", fake_connect)
            try:
                await c._session(None)
            except asyncio.IncompleteReadError:
                pass  # scripted end-of-stream

    asyncio.run(asyncio.wait_for(run_twice(), 20))
    assert derivations["n"] == 1  # derived once, reused on reconnect


def test_client_quit_key_marshals_to_loop():
    """_on_key runs on the KeyboardReader thread; asyncio.Event.set() is
    not thread-safe, so quit must marshal via call_soon_threadsafe."""
    import asyncio
    import threading

    from asciichat_tpu.apps.client import AsciiChatClient

    async def run():
        c = AsciiChatClient("127.0.0.1", 1, reconnect=False)
        c._loop = asyncio.get_running_loop()
        threading.Thread(target=c._on_key, args=("q",)).start()
        for _ in range(100):
            if c._stop.is_set():
                return True
            await asyncio.sleep(0.01)
        return False

    assert asyncio.run(asyncio.wait_for(run(), 10))


def test_client_default_caps_populate_fps_meta():
    """Display metadata was only set when wire_caps was PASSED; the
    default-caps constructor left the fps status line with an empty
    renderer key and 0x0 size."""
    from asciichat_tpu.apps.client import AsciiChatClient

    c = AsciiChatClient("127.0.0.1", 1, reconnect=False)
    key, size = c.display._meta
    assert key != "" and size != (0, 0)


# ---- ACDS / ring consensus sweep ------------------------------------------


def test_consensus_leader_requires_exact_coverage_to_close():
    """The leader closed the collection loop on a SUBSET of the ring
    (set <= check): a predecessor could strip members and have the leader
    elect from a shrunken electorate — a result every honest member's
    exact-coverage on_election_result then rejects (split-brain the ACDS
    would ratify via the leader's announcement)."""
    from asciichat_tpu.net import consensus as cons

    c = cons.ConsensusParticipant("c")
    c.on_ring_members(["a", "b", "c"])
    assert c.is_leader
    to, msg = c.start_collection()
    # predecessor 'b' returns the loop WITHOUT a's entry
    stripped = {
        "type": "STATS_UPDATE", "round_id": msg["round_id"],
        "metrics": [cons.ParticipantMetrics("c"),
                    cons.ParticipantMetrics("b")],
    }
    assert c.on_stats_update(stripped, sender="b") is None
    assert c.phase == cons.Phase.COLLECTING  # round NOT closed
    # full coverage closes normally
    full = {
        "type": "STATS_UPDATE", "round_id": msg["round_id"],
        "metrics": [cons.ParticipantMetrics("c"),
                    cons.ParticipantMetrics("a"),
                    cons.ParticipantMetrics("b")],
    }
    out = c.on_stats_update(full, sender="b")
    assert out is not None and out[1]["type"] == "RING_ELECTION_RESULT"


def test_consensus_signed_entries_defeat_leader_forgery():
    """With per-entry Ed25519 signatures wired, a malicious leader cannot
    forge OTHER participants' metric values: an entry signed by the wrong
    key (or unsigned with a pinned owner) rejects the whole result."""
    from asciichat_tpu.net import consensus as cons
    from asciichat_tpu.net import identity as ident

    keys = {pid: ident.Identity() for pid in ("a", "b", "c")}
    PT = 6999

    import struct as _struct

    def sign_as(pid, m, rid):
        return keys[pid].sign(PT, _struct.pack(">I", rid) + m.pack())

    def verifier(m, sig, rid):
        if sig is None:
            return False
        try:
            pub, body = ident.open_envelope(PT, sig)
        except ident.SignatureError:
            return False
        return (body == _struct.pack(">I", rid) + m.pack()
                and pub == keys[m.participant_id].public_bytes)

    a = cons.ConsensusParticipant("a", entry_verifier=verifier)
    a.on_ring_members(["a", "b", "c"])
    now_ms = int(time.time() * 1000)
    mk = lambda pid, up: cons.ParticipantMetrics(
        pid, upload_kbps=up, measured_at_ms=now_ms)
    ms = [mk("a", 50_000), mk("b", 20_000), mk("c", 1_000)]
    host, backup = cons.elect(ms)

    good = {"type": "RING_ELECTION_RESULT", "round_id": 1,
            "host_id": host, "backup_id": backup, "metrics": ms,
            "sigs": [sign_as(m.participant_id, m, 1) for m in ms]}
    assert a.on_election_result(good, sender="c")["ack_status"] == "ACCEPTED"

    # leader 'c' forges a's metrics (tanks them so c wins) and signs the
    # forged entry with ITS OWN key
    forged_ms = [mk("a", 1), mk("b", 2), mk("c", 99_000)]
    fh, fb = cons.elect(forged_ms)
    forged = {"type": "RING_ELECTION_RESULT", "round_id": 2,
              "host_id": fh, "backup_id": fb, "metrics": forged_ms,
              "sigs": [sign_as("c", m, 2) for m in forged_ms]}
    assert a.on_election_result(forged, sender="c")["ack_status"] == "REJECTED"

    # unsigned entries with known owners: also rejected
    unsigned = dict(good, round_id=3, sigs=None)
    assert a.on_election_result(unsigned, sender="c")["ack_status"] == "REJECTED"


def test_acds_relay_budget_covers_all_forwarded_types():
    """The bandwidth budget only metered ACIP_WEBRTC_RELAY: colluders
    could tunnel unlimited bulk data through SDP/ICE/RING/SETTINGS
    bodies on the same blind-forward path."""
    import asyncio
    import json

    from asciichat_tpu.apps import acds as acds_mod
    from asciichat_tpu.apps.discovery import DiscoverySession
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.transport import serve_tcp

    async def run():
        acds = acds_mod.AcdsServer("127.0.0.1", 0)
        acds.relay_budget = acds_mod._RelayBudget(
            rate_bps=10.0, burst_bytes=4000.0)  # tiny budget
        srv = await serve_tcp(acds._handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        s1 = DiscoverySession("127.0.0.1", port, participant_id="p-one")
        s2 = DiscoverySession("127.0.0.1", port, participant_id="p-two")
        await s1.connect()
        await s2.connect()
        ss = await s1.create(my_port=15001)
        await s2.join(ss, "127.0.0.1", 15002)
        bulk = "x" * 2000
        for _ in range(10):
            s1._t.send_nowait(pkt.PacketType.ACIP_WEBRTC_SDP, json.dumps({
                "to": "p-two", "from": "p-one", "sdp": bulk}).encode())
        for _ in range(100):
            if acds.relay_dropped > 0:
                break
            await asyncio.sleep(0.05)
        assert acds.relay_dropped > 0, "SDP bulk rode the relay unmetered"
        await s1.leave()
        await s2.leave()
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_acds_non_host_session_end_degrades_to_leave():
    """ACIP_SESSION_END from a non-host deleted nothing in the DB (the
    host-scoped WHERE matched no row) but the handler still wiped the
    session's election metrics and left the sender as a ghost DB member."""
    import asyncio

    from asciichat_tpu.apps.acds import AcdsServer
    from asciichat_tpu.apps.discovery import DiscoverySession
    from asciichat_tpu.net import consensus as cons
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.transport import serve_tcp

    async def run():
        acds = AcdsServer("127.0.0.1", 0)
        srv = await serve_tcp(acds._handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        s1 = DiscoverySession("127.0.0.1", port, participant_id="p-host")
        s2 = DiscoverySession("127.0.0.1", port, participant_id="p-member")
        await s1.connect()
        await s2.connect()
        ss = await s1.create(my_port=15001)
        await s2.join(ss, "127.0.0.1", 15002)
        acds.metrics[ss] = {"p-host": cons.ParticipantMetrics("p-host")}
        # non-host END
        s2._t.send_nowait(pkt.PacketType.ACIP_SESSION_END, b"")
        for _ in range(100):
            info = acds.db.lookup(ss)
            if info and "p-member" not in info.participants:
                break
            await asyncio.sleep(0.05)
        info = acds.db.lookup(ss)
        assert info is not None, "non-host END destroyed the session"
        assert "p-member" not in info.participants  # degraded to LEAVE
        assert "p-host" in info.participants
        assert acds.metrics.get(ss), "non-host END wiped election metrics"
        await s1.leave()
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_acds_stale_binding_cannot_inject_after_session_end():
    """After the host ends the session, a participant whose handler still
    holds the old session_string must not relay into it or inject
    metrics (ghost acting in a recreated/dead session)."""
    import asyncio
    import json

    from asciichat_tpu.apps.acds import AcdsServer
    from asciichat_tpu.apps.discovery import DiscoverySession
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net import consensus as cons
    from asciichat_tpu.net.transport import serve_tcp

    async def run():
        acds = AcdsServer("127.0.0.1", 0)
        srv = await serve_tcp(acds._handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        s1 = DiscoverySession("127.0.0.1", port, participant_id="p-host")
        s2 = DiscoverySession("127.0.0.1", port, participant_id="p-ghost")
        await s1.connect()
        await s2.connect()
        ss = await s1.create(my_port=15001)
        await s2.join(ss, "127.0.0.1", 15002)
        # HOST ends the session; s2's server-side binding goes stale
        s1._t.send_nowait(pkt.PacketType.ACIP_SESSION_END, b"")
        for _ in range(100):
            if acds.db.lookup(ss) is None:
                break
            await asyncio.sleep(0.05)
        assert acds.db.lookup(ss) is None
        # ghost tries to inject metrics + relay into the dead session
        s2._t.send_nowait(pkt.PacketType.ACIP_NETWORK_QUALITY,
                          cons.ParticipantMetrics("p-ghost").pack())
        s2._t.send_nowait(pkt.PacketType.ACIP_WEBRTC_SDP, json.dumps({
            "to": "p-host", "from": "p-ghost", "sdp": "v=0"}).encode())
        await asyncio.sleep(0.5)
        assert "p-ghost" not in acds.metrics.get(ss, {})
        await s2.leave()
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_acds_session_switch_unbinds_previous_membership():
    """Joining a DIFFERENT session under the same participant_id skipped
    _unbind (the guard only fired on re-identification): the old session
    kept a ghost member/host forever."""
    import asyncio

    from asciichat_tpu.apps.acds import AcdsServer
    from asciichat_tpu.apps.discovery import DiscoverySession
    from asciichat_tpu.net.transport import serve_tcp

    async def run():
        acds = AcdsServer("127.0.0.1", 0)
        srv = await serve_tcp(acds._handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        s1 = DiscoverySession("127.0.0.1", port, participant_id="p-move")
        s2 = DiscoverySession("127.0.0.1", port, participant_id="p-anchor")
        await s1.connect()
        await s2.connect()
        ss1 = await s1.create(my_port=15001)
        ss2 = await s2.create(my_port=15002)
        # s1 switches sessions on the SAME connection + same pid
        await s1.join(ss2, "127.0.0.1", 15003)
        info1 = acds.db.lookup(ss1)
        assert info1 is None or "p-move" not in info1.participants, \
            "ghost membership left in the abandoned session"
        info2 = acds.db.lookup(ss2)
        assert "p-move" in info2.participants
        await s1.leave()
        await s2.leave()
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_acds_rejects_oversized_participant_id():
    """participant_id is capped at the 16-byte participant_metrics_t wire
    field: a longer id used to join fine yet was silently excluded from
    every election (its own pack() raises)."""
    import asyncio

    from asciichat_tpu.apps.acds import AcdsServer
    from asciichat_tpu.apps.discovery import DiscoverySession
    from asciichat_tpu.net.transport import serve_tcp

    async def run():
        acds = AcdsServer("127.0.0.1", 0)
        srv = await serve_tcp(acds._handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        s = DiscoverySession("127.0.0.1", port,
                             participant_id="way-too-long-participant-id")
        await s.connect()
        with pytest.raises(Exception):
            await asyncio.wait_for(s.create(my_port=15001), 5)
        assert not acds.clients  # never registered
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_acds_touch_throttled_and_membership_cached():
    """The relay hot path issued 2 SELECTs + an UPDATE/fsync per relayed
    segment; touch is now throttled and membership lookups cached for a
    couple of seconds."""
    from asciichat_tpu.apps.acds import AcdsServer

    acds = AcdsServer("127.0.0.1", 0)
    calls = {"touch": 0, "lookup": 0}
    real_lookup = acds.db.lookup
    acds.db.touch = lambda s: calls.__setitem__("touch", calls["touch"] + 1)
    acds.db.lookup = lambda s: (
        calls.__setitem__("lookup", calls["lookup"] + 1) or real_lookup(s))
    for _ in range(50):
        acds._touch_throttled("some-session")
        acds._session_info_cached("some-session")
    assert calls["touch"] == 1  # throttled
    assert calls["lookup"] == 1  # cached


def test_acds_election_loop_survives_db_error():
    """A transient DB error killed the periodic fallback-election task
    silently for the rest of the server's life."""
    import asyncio

    from asciichat_tpu.apps.acds import AcdsServer

    acds = AcdsServer("127.0.0.1", 0, election_interval=0.05)
    acds.metrics["boom-session"] = {}
    fails = {"n": 0}

    def exploding_lookup(s):
        fails["n"] += 1
        raise RuntimeError("db locked")

    acds.db.lookup = exploding_lookup

    async def run():
        task = asyncio.get_running_loop().create_task(acds._election_loop())
        await asyncio.sleep(0.4)
        alive = not task.done()
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        return alive

    assert asyncio.run(asyncio.wait_for(run(), 10))
    assert fails["n"] >= 2  # kept cycling after the first failure


def test_rate_limiter_gates_host_announce():
    """The empty-body ACIP_HOST_ANNOUNCEMENT fans out to a full election
    per packet; it now has a dedicated rate-limit action."""
    from asciichat_tpu.net.rate_limit import DEFAULT_LIMITS, RateLimiter

    assert "host_announce" in DEFAULT_LIMITS
    rl = RateLimiter()
    limit = DEFAULT_LIMITS["host_announce"][0]
    for _ in range(limit):
        assert rl.allow("1.2.3.4", "host_announce")
    assert not rl.allow("1.2.3.4", "host_announce")


# ---- audio DSP / audio device sweep ---------------------------------------


def test_mixer_exclude_self_crowd_counts_others_only():
    """Reference parity: with A and B both speaking, A's mix contains B at
    crowd gain 1/1^alpha = 1.0 (the listener is masked out BEFORE counting
    speakers, mixer.c:663-665) — the old global 1/sqrt(2) factor made
    every speaker hear the others ~1.5 dB quieter than the C server."""
    import jax.numpy as jnp

    from asciichat_tpu.ops import audio as A

    S, N = 2, 480
    rng = np.random.default_rng(11)
    sig = rng.normal(0, 0.25, (S, N)).astype(np.float32)
    state2 = A.MixerState.init(S, S).astuple()
    both, _ = A.mixer_process(jnp.asarray(sig), jnp.ones(S, bool), state2)

    # same tick with ONLY B active: A's mix of B should carry the SAME
    # crowd factor (count excluding A is 1 either way)
    solo_state = A.MixerState.init(S, S).astuple()
    only_b = sig.copy()
    only_b[0] = 0.0
    solo, _ = A.mixer_process(jnp.asarray(only_b),
                              jnp.asarray([False, True]), solo_state)
    # ducking state differs slightly (A's envelope exists in `both`), so
    # compare energy ratio rather than exact bytes: within a few percent,
    # NOT the sqrt(2) (~29%) gap the old global crowd factor produced
    e_both = float(np.sqrt(np.mean(np.asarray(both)[0] ** 2)))
    e_solo = float(np.sqrt(np.mean(np.asarray(solo)[0] ** 2)))
    assert abs(e_both - e_solo) / e_solo < 0.1, (e_both, e_solo)


def test_mixer_state_frozen_when_all_inactive():
    """mixer.c:509-512 returns silence WITHOUT touching state when no
    source is active; advancing it let compressor/duck gains recover
    during silence, diverging the first ~100 ms after speech resumes."""
    import jax.numpy as jnp

    from asciichat_tpu.ops import audio as A

    S, N = 3, 480
    rng = np.random.default_rng(12)
    loud = rng.normal(0, 0.8, (S, N)).astype(np.float32)
    state = A.MixerState.init(S, S).astuple()
    _, state = A.mixer_process(jnp.asarray(loud), jnp.ones(S, bool), state)
    ref = [np.asarray(s).copy() for s in state]
    # ten silent ticks: state must stay bit-frozen, output silent
    for _ in range(10):
        out, state = A.mixer_process(
            jnp.asarray(loud), jnp.zeros(S, bool), state)
    assert not np.any(np.asarray(out))
    for got, want in zip(state, ref):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_wav_source_malformed_files_raise_unavailable(tmp_path):
    """Malformed WAVs escaped as raw EOFError/ValueError (truncated
    header; data not a multiple of the sample size) instead of the
    AudioSourceUnavailable contract the factory handles."""
    from asciichat_tpu.runtime import audiodev

    truncated = tmp_path / "t.wav"
    truncated.write_bytes(b"RIFF\x10\x00\x00\x00WAVE")  # header only
    with pytest.raises(audiodev.AudioSourceUnavailable):
        audiodev.WavFileSource(str(truncated))

    # IEEE-float WAV (fmt 3, rides the raw RIFF parser) whose data chunk
    # is not a multiple of the 4-byte sample size
    import struct

    odd = tmp_path / "odd.wav"
    fmt = struct.pack("<HHIIHH", 3, 1, 48000, 48000 * 4, 4, 32)
    data = b"\x00" * 10  # 2.5 float32 samples
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    odd.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE"
                    + body)
    with pytest.raises(audiodev.AudioSourceUnavailable):
        audiodev.WavFileSource(str(odd))


def test_client_pipeline_fused_matches_separate_stages():
    """The capture chain now runs as ONE compiled graph (one dispatch +
    one sync per 10 ms frame instead of three dispatches + two syncs);
    output must be identical to composing the stages separately."""
    import jax.numpy as jnp

    from asciichat_tpu.ops import audio as A

    rng = np.random.default_rng(13)
    n = A.AUDIO_FRAME_SAMPLES
    far = rng.normal(0, 0.3, 4 * n).astype(np.float32)
    mic = 0.5 * np.concatenate([np.zeros(40, np.float32),
                                far[: 4 * n - 40]])  # delayed echo
    fused = A.ClientAudioPipeline()
    manual = A.ClientAudioPipeline()

    for i in range(4):
        frame_far = far[i * n:(i + 1) * n]
        frame_mic = mic[i * n:(i + 1) * n]
        fused.add_far(frame_far)
        got = fused.process(frame_mic)

        # the separate-stage composition the pipeline used to run
        manual.add_far(frame_far)
        mfar = manual._take_far(n)
        x = manual.aec.process(jnp.asarray(frame_mic, jnp.float32), mfar)
        x, manual.hp_in, manual.hp_out = A.highpass(
            x, manual.hp_in, manual.hp_out, manual.hp_alpha)
        x, manual.gate_env, manual.gate_open = A.noise_gate(
            x, manual.gate_env, manual.gate_open,
            threshold=manual.gate_threshold)
        want = np.asarray(x, np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert fused.aec.double_talk_frac == manual.aec.double_talk_frac


# ---- SSH/GPG/known-hosts auth sweep ---------------------------------------


def test_known_hosts_corrupt_line_keeps_later_pins(tmp_path):
    """One malformed known_hosts line aborted loading ALL later pins (the
    except wrapped the loop), and the next save rewrote the file without
    them — silently re-opening the TOFU window for those servers."""
    from asciichat_tpu.net.knownhosts import KnownHosts

    kh_path = tmp_path / "known_hosts"
    key_a, key_b = b"\x01" * 32, b"\x02" * 32
    kh_path.write_text(
        f"a:1 ed25519 {key_a.hex()}\n"
        "broken ed25519 zz-not-hex\n"
        f"b:2 ed25519 {key_b.hex()}\n")
    kh = KnownHosts(str(kh_path))
    assert kh.check("a:1", key_a) == "ok"
    assert kh.check("b:2", key_b) == "ok"  # was lost -> 'new' (MITM window)
    # a save must preserve b's pin
    kh.check("c:3", b"\x03" * 32)
    assert f"b:2 ed25519 {key_b.hex()}" in kh_path.read_text()


def test_known_hosts_concurrent_instances_merge_on_save(tmp_path):
    """Two KnownHosts instances that both loaded before either saved used
    to clobber each other (last writer wins, full-file rewrite); saves
    now merge with what's on disk."""
    from asciichat_tpu.net.knownhosts import KnownHosts

    kh_path = str(tmp_path / "known_hosts")
    kh1 = KnownHosts(kh_path)
    kh2 = KnownHosts(kh_path)  # loaded the same (empty) file
    kh1.check("server-one:27224", b"\x0a" * 32)  # pins + saves
    kh2.check("server-two:27224", b"\x0b" * 32)  # used to erase server-one
    kh3 = KnownHosts(kh_path)
    assert kh3.check("server-one:27224", b"\x0a" * 32) == "ok"
    assert kh3.check("server-two:27224", b"\x0b" * 32) == "ok"


def test_identity_raw_sign_api():
    """knownhosts reached into Identity._private; the raw-sign API keeps
    the private key an implementation detail."""
    from asciichat_tpu.net import identity as ident
    from asciichat_tpu.net import knownhosts as kh

    i = ident.Identity()
    proof = kh.sign_host_proof(i, b"c" * 32, b"k" * 32)
    assert kh.verify_host_proof(proof, b"c" * 32, b"k" * 32) == i.public_bytes


def test_ssh_agent_malformed_responses_raise_auth_error(tmp_path):
    """Short agent answers escaped as raw struct.error and a hung agent as
    socket.timeout — neither was the SshAuthError contract the handshake
    executor handles."""
    import socket
    import threading

    from asciichat_tpu.net import sshauth

    sock_path = str(tmp_path / "agent.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(1)

    def agent_short_answer():
        conn, _ = srv.accept()
        conn.recv(4096)
        # IDENTITIES_ANSWER type byte but only 2 payload bytes (< the
        # 4-byte count): used to raise struct.error in list_identities
        conn.sendall(b"\x00\x00\x00\x03" + bytes([12]) + b"\x00\x00")
        conn.close()

    t = threading.Thread(target=agent_short_answer, daemon=True)
    t.start()
    ag = sshauth.SshAgent(sock_path)
    with pytest.raises(sshauth.SshAuthError, match="truncated"):
        ag.list_identities()
    ag.close()
    t.join(timeout=5)
    srv.close()


def test_ssh_key_file_errors_raise_auth_error(tmp_path):
    """A passphrase-protected key (TypeError) or garbage file (ValueError)
    surfaced raw tracebacks at the CLI instead of SshAuthError."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        BestAvailableEncryption,
        Encoding,
        PrivateFormat,
    )

    from asciichat_tpu.net import sshauth

    try:
        import bcrypt  # noqa: F401 — OpenSSH key encryption needs it

        have_bcrypt = True
    except ImportError:
        have_bcrypt = False
    if have_bcrypt:
        protected = tmp_path / "id_ed25519"
        protected.write_bytes(Ed25519PrivateKey.generate().private_bytes(
            Encoding.PEM, PrivateFormat.OpenSSH,
            BestAvailableEncryption(b"hunter2")))
        with pytest.raises(sshauth.SshAuthError, match="passphrase"):
            sshauth.SshIdentity.from_private_key_file(str(protected))
        # right password still works
        ident = sshauth.SshIdentity.from_private_key_file(
            str(protected), password=b"hunter2")
        assert ident.key_blob.startswith(b"\x00\x00\x00\x0bssh-ed25519")

    garbage = tmp_path / "junk"
    garbage.write_bytes(b"not a key at all")
    with pytest.raises(sshauth.SshAuthError, match="cannot load"):
        sshauth.SshIdentity.from_private_key_file(str(garbage))
    with pytest.raises(sshauth.SshAuthError, match="cannot load"):
        sshauth.SshIdentity.from_private_key_file(str(tmp_path / "absent"))


def test_authorized_keys_options_prefix_parsed():
    """Standard authorized_keys entries with an options prefix
    ('restrict,command="..." ssh-ed25519 AAAA...') were silently dropped,
    stranding those clients with no server-side hint."""
    import base64

    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
    )

    from asciichat_tpu.net import sshauth

    blob = sshauth.pubkey_blob(Ed25519PrivateKey.generate().public_key())
    b64 = base64.b64encode(blob).decode()
    text = "\n".join([
        f'restrict,command="echo hi" ssh-ed25519 {b64} alice@host',
        f"no-pty,from=\"10.0.0.0/8\" ssh-ed25519 {b64} bob",
        f"ssh-ed25519 {b64} plain",
        "ssh-rsa AAAAB3NzaC1yc2E= legacy",  # skipped (wrong type), logged
        # a quoted command must not smuggle a fake key
        f'command="ssh-ed25519 {b64}" ssh-rsa AAAA= evil',
    ])
    blobs = sshauth.parse_authorized_keys(text)
    assert blobs == [blob, blob, blob]


def test_gpg_verify_requires_exactly_one_signature(tmp_path):
    """A signature file carrying TWO signatures could couple one key's
    GOODSIG with another's VALIDSIG fingerprint; verification now
    requires exactly one good signature. Also: the signed data (which
    includes the DH session key) now rides stdin, never a disk file."""
    import shutil as _shutil

    from asciichat_tpu.net import gpgauth

    if _shutil.which("gpg") is None:
        pytest.skip("no gpg")
    home = tmp_path / "gnupg"
    home.mkdir(mode=0o700)
    gen = gpgauth._gpg(["--pinentry-mode", "loopback", "--passphrase", "",
                        "--quick-gen-key", "one@test", "ed25519", "sign"],
                       str(home))
    assert gen.returncode == 0, gen.stderr.decode()[-300:]
    ident = gpgauth.GpgIdentity(gnupghome=str(home))
    data = b"challenge" + b"k" * 32
    sig = ident.sign(data)
    ring = gpgauth.GpgKeyring(str(home))
    assert ring.verify(data, sig, ident.fingerprint)
    assert not ring.verify(data, sig + sig, ident.fingerprint)  # two sigs
    assert not ring.verify(b"other data", sig, ident.fingerprint)


# ---- device tick core sweep (models/server.py + ops/{cells,compositor}) ----


def test_render_group_geometry_matches_plan_tick():
    """RenderGroup duplicated plan_tick's HALF_BLOCK height-doubling rule
    (stream.c:831); the two copies could drift. It now derives its geometry
    from plan_tick itself — for every render mode the group's RenderPlan must
    equal the plan the model-level API hands out."""
    from asciichat_tpu.models.server import RenderGroup, plan_tick
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

    sizes = [(32, 24), (48, 36)]
    for mode in (RenderMode.FOREGROUND, RenderMode.BACKGROUND,
                 RenderMode.HALF_BLOCK):
        caps = TerminalCapabilities(ColorLevel.TRUECOLOR, mode)
        grp = RenderGroup(sizes, 64, 20, caps, ["none"])
        plan = plan_tick(sizes, 64, 20, caps, num_clients=1)
        assert grp.render == plan.render, mode


def test_compositor_host_maps_match_device_maps():
    """host_maps (the mesh path's host-side placement source) must stay
    value-identical to device_maps (the single-device cache)."""
    from asciichat_tpu.ops import compositor

    plan = compositor.plan_composite([(32, 24), (40, 30), (24, 18)], 80, 24)
    host = compositor.host_maps(plan)
    dev = compositor.device_maps(plan)
    assert len(host) == len(dev) == 4
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(np.asarray(h), np.asarray(d))


def test_render_group_aot_recompiles_on_receiver_count_change():
    """The mesh path's AOT executable is shape-specialized to the padded
    receiver count. set_filters growing the group past the old padded count
    used to keep serving the stale executable — a signature mismatch at the
    next step. It must be invalidated (and NOT invalidated when the padded
    count is unchanged)."""
    import jax

    from asciichat_tpu.models.server import RenderGroup
    from asciichat_tpu.ops import cells
    from asciichat_tpu.parallel import mesh as meshlib
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
    from conftest import synthetic_frame

    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    sizes = [(32, 24)] * 8
    stack = np.stack([synthetic_frame(24, 32, seed=i) for i in range(8)])
    mesh = meshlib.make_mesh(8)
    frames = jax.device_put(stack, meshlib.client_sharding(mesh))

    grp = RenderGroup(sizes, 64, 20, caps, ["green"], mesh=mesh)
    grp.step(frames)
    first = grp._compiled
    assert first is not None

    # same padded count (3 -> pads to 8): executable survives
    grp.set_filters(["green", "cyan", "none"])
    assert grp._compiled is first

    # crossing the pad boundary (9 -> pads to 16): must drop + recompile
    grp.set_filters(["green"] * 9)
    assert grp._compiled is None
    rec = cells.records_to_numpy(grp.step(frames))
    assert next(iter(rec.values())).shape[0] == 16
    assert grp._compiled is not None and grp._compiled is not first


def test_rainbow_tick_refresh_updates_only_tint():
    """Only the rainbow tint is time-dependent (color_filter.c:169); the
    per-tick refresh must re-upload tint alone — the other three param
    arrays keep their identity — and must match a full set_filters at the
    same timestamp exactly."""
    from asciichat_tpu.models.server import RenderGroup
    from asciichat_tpu.ops import filters
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    grp = RenderGroup([(32, 24)], 64, 20, caps, ["rainbow", "green"])
    fg, isr, on = grp.fg_on_bg, grp.is_rainbow, grp.filter_on
    t0 = np.asarray(grp.tint)

    grp._refresh_rainbow_tint(1.25)
    assert grp.fg_on_bg is fg and grp.is_rainbow is isr and grp.filter_on is on
    want, _, _, _ = filters.filter_params(["rainbow", "green"], 1.25)
    np.testing.assert_array_equal(np.asarray(grp.tint), np.asarray(want))
    assert not np.array_equal(np.asarray(grp.tint), t0)


def test_mesh_collectives_counts_instructions_not_substrings():
    """grp.collectives must count collective INSTRUCTIONS in the compiled
    HLO — the old substring count also hit SSA result names, operand
    references, and both halves of async start/done pairs, overstating the
    inspector's mesh_collectives severalfold."""
    import jax

    from asciichat_tpu.models.server import RenderGroup
    from asciichat_tpu.parallel import mesh as meshlib
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
    from conftest import synthetic_frame

    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    sizes = [(32, 24)] * 8
    stack = np.stack([synthetic_frame(24, 32, seed=i) for i in range(8)])
    mesh = meshlib.make_mesh(8)
    frames = jax.device_put(stack, meshlib.client_sharding(mesh))
    grp = RenderGroup(sizes, 64, 20, caps, ["green"] * 8, mesh=mesh)
    grp.step(frames)

    naive = sum(grp._compiled.as_text().count(op) for op in (
        "all-gather", "all-reduce", "collective-permute", "all-to-all"))
    assert 0 < grp.collectives < naive


# ---- render layer sweep (asciigrid + palette) ------------------------------


def test_grid_multi_source_overflow_drops_line_entirely():
    """SAFE_MEMCPY in the reference grid compositor is all-or-nothing
    (platform_memcpy rejects count > dest_size and copies NOTHING,
    ascii.c:845): a too-long ANSI line near the end of the canvas must
    leave spaces. The Python twin used to clamp to a PARTIAL write,
    emitting a dangling CSI fragment and overwriting the final row's
    newline."""
    from asciichat_tpu.render import asciigrid as ag

    # 21x7 -> 2x2 grid of 10x3 cells. Bottom-right cell's last line lands
    # at byte 143 of a 154-byte canvas; a 25-byte ANSI line can't fit.
    plain = [b"\n".join([c * 10] * 3)
             for c in (b"a", b"b", b"1")]
    ansi_line = b"\x1b[38;2;255;0;0m" + b"Z" * 10
    overflowing = b"\n".join([b"x" * 10, b"y" * 10, ansi_line])
    out = ag.create_grid(plain[:2] + [plain[2], overflowing], 21, 7)

    assert out.endswith(b"\n"), "final row's newline was overwritten"
    rows = out.split(b"\n")[:-1]
    assert len(rows) == 7 and all(len(r) == 21 for r in rows)
    # the overflowing line is dropped whole: spaces, no CSI fragment
    assert b"\x1b" not in out
    assert rows[6] == b"1" * 10 + b"|" + b" " * 10
    # the two earlier (in-bounds) lines of the same source still copied
    assert rows[4][11:] == b"x" * 10 and rows[5][11:] == b"y" * 10


def test_palette_parse_stops_at_embedded_nul():
    """The reference palette parser is NUL-terminated (common.c:394
    `while (*p && char_count < 255)`): an embedded NUL ends the palette.
    Parsing past it built LUTs no C build could ever see — every glyph
    byte diverged from the reference for such palettes."""
    from asciichat_tpu.render import palette as pal

    assert pal.parse_utf8_chars("ab\x00cd") == [b"a", b"b"]
    assert pal.parse_utf8_chars(b"\x00abc") == []
    cache = pal.get_palette_cache("ab\x00cd")
    assert cache.char_count == 2
    assert set(cache.cache256) == {b"a", b"b"}


# ---- query / update_checker / renderfile sweep ------------------------------


def test_renderfile_16color_white_reaches_full_brightness():
    """The 16color/mono block fallback scaled the mono run key by //63, but
    keys are PALETTE char indices (0..char_count-1, max 22 for the standard
    palette): a pure-white input could never exceed ~35% brightness."""
    import jax.numpy as jnp

    from asciichat_tpu.models.renderfile import cells_to_pixels, records_to_pixels
    from asciichat_tpu.ops import cells
    from asciichat_tpu.render import palette as pal

    white = jnp.full((1, 8, 10, 3), 255, jnp.uint8)
    ramp = cells.ramp_for_palette(pal.DEFAULT_PALETTE)
    recs = cells.render_cells(white, ramp, dst_h=8, dst_w=10, mode="16color")
    px = np.asarray(records_to_pixels(recs, "16color", pal.DEFAULT_PALETTE))
    assert px.max() >= 250, f"white capped at {px.max()} (key//63 regression)"
    # mono block fallback with the correct key_max
    recs_m = cells.render_cells(white, ramp, dst_h=8, dst_w=10, mode="mono")
    n = pal.get_palette_cache(pal.DEFAULT_PALETTE).char_count
    px_m = np.asarray(cells_to_pixels(recs_m, "mono", key_max=n - 1))
    assert px_m.max() == 255


def test_renderfile_writers_reject_dimension_changes(tmp_path):
    """ac_rec_frame reads width*3 x height bytes unconditionally (a native
    heap over-read for a smaller frame), and Y4M raw planes under a fixed
    header silently desync: both writers must reject a frame whose shape
    differs from the opened dimensions."""
    from asciichat_tpu.models.renderfile import NativeRecorder, Y4MWriter

    y = Y4MWriter(str(tmp_path / "a.y4m"), 10, 8)
    y.write(np.zeros((8, 10, 3), np.uint8))
    with pytest.raises(ValueError, match="opened"):
        y.write(np.zeros((6, 10, 3), np.uint8))
    y.close()

    from asciichat_tpu.runtime.codecs import CodecUnavailable

    try:
        rec = NativeRecorder(str(tmp_path / "a.mp4"), 64, 64, 30)
    except CodecUnavailable:
        pytest.skip("no libavcodec")
    try:
        with pytest.raises(ValueError, match="opened"):
            rec.write_rgb(np.zeros((32, 64, 3), np.uint8))
        rec.write_rgb(np.zeros((64, 64, 3), np.uint8))
    finally:
        rec.close()


def test_y4m_header_declares_full_range(tmp_path):
    """rgb_to_ycbcr444 emits full-range BT.601; without XCOLORRANGE=FULL
    every consumer assumes limited range and crushes blacks."""
    from asciichat_tpu.models.renderfile import Y4MWriter

    p = tmp_path / "r.y4m"
    w = Y4MWriter(str(p), 4, 2)
    w.close()
    assert b"XCOLORRANGE=FULL" in p.read_bytes().split(b"\n", 1)[0]


def test_renderfile_pads_odd_dims_even(tmp_path, monkeypatch):
    """yuv420p encoders reject odd dimensions — discovered only AFTER the
    full render. Non-.y4m targets pad the raster to even once, for both the
    native and the transcode-intermediate paths."""
    from asciichat_tpu.models import renderfile as rf
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

    opened = {}

    class FakeRecorder:
        def __init__(self, path, w, h, fps, crf=28, audio_rate=0):
            opened["dims"] = (w, h)
            from asciichat_tpu.runtime.codecs import CodecUnavailable

            raise CodecUnavailable("forced fallback")

    monkeypatch.setattr(rf, "NativeRecorder", FakeRecorder)
    monkeypatch.setattr(rf.shutil, "which", lambda *_: None)

    class Src:
        n = 0

        def read(self):
            Src.n += 1
            return None if Src.n > 2 else np.full((12, 16, 3), 200, np.uint8)

    caps = TerminalCapabilities(ColorLevel.COLOR_16, RenderMode.FOREGROUND)
    out = str(tmp_path / "v.mp4")
    # 15x5 cells at scale 3 -> 45x15 px, both odd
    with pytest.raises(RuntimeError, match="no encoder"):
        rf.render_to_file(Src(), out, caps, 15, 5, " .:-=+*#%@",
                          max_frames=2, scale=3)
    assert opened["dims"][0] % 2 == 0 and opened["dims"][1] % 2 == 0
    header = open(out + ".y4m", "rb").readline()
    fields = dict((f[:1], f[1:]) for f in header.split()[1:] if f[:1] in b"WH")
    assert int(fields[b"W"]) % 2 == 0 and int(fields[b"H"]) % 2 == 0


def test_renderfile_fallback_transcode_carries_audio(tmp_path, monkeypatch):
    """--render-file with audio on the ffmpeg-CLI fallback silently dropped
    the requested track (audio_source was only read in the native branch):
    the transcode must now mux the collected samples."""
    from asciichat_tpu.models import renderfile as rf
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities
    from asciichat_tpu.runtime.codecs import CodecUnavailable

    class NoRecorder:
        def __init__(self, *a, **k):
            raise CodecUnavailable("forced fallback")

    calls = {}

    def fake_run(cmd, check):
        calls["cmd"] = cmd
        open(cmd[-1], "wb").write(b"mp4")

        class R:
            returncode = 0

        return R()

    monkeypatch.setattr(rf, "NativeRecorder", NoRecorder)
    monkeypatch.setattr(rf.shutil, "which", lambda *_: "/usr/bin/ffmpeg")
    monkeypatch.setattr(rf.subprocess, "run", fake_run)

    class Src:
        n = 0

        def read(self):
            Src.n += 1
            return None if Src.n > 3 else np.full((12, 16, 3), 128, np.uint8)

    class Tone:
        def read(self, n):
            return np.zeros(n, np.float32) + 0.25

    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    out = str(tmp_path / "v.mp4")
    rendered = rf.render_to_file(Src(), out, caps, 20, 6, " .:@",
                                 max_frames=3, audio_source=Tone())
    assert rendered == 3
    cmd = calls["cmd"]
    assert "-shortest" in cmd and any(str(a).endswith(".wav") for a in cmd)
    # the temp wav was cleaned up after a successful transcode
    assert not list(tmp_path.glob("*.wav")) and not list(tmp_path.glob("*.y4m"))


def test_renderfile_close_failure_does_not_mask_render_error(tmp_path, monkeypatch):
    """A close() failure in the finally block replaced the ORIGINAL
    mid-render exception (the root cause) in the propagated traceback."""
    from asciichat_tpu.models import renderfile as rf
    from asciichat_tpu.render.types import ColorLevel, RenderMode, TerminalCapabilities

    monkeypatch.setattr(rf.Y4MWriter, "close",
                        lambda self: (_ for _ in ()).throw(RuntimeError("trailer")))

    class Src:
        n = 0

        def read(self):
            Src.n += 1
            if Src.n == 2:
                raise ValueError("boom mid-render")
            return np.full((12, 16, 3), 99, np.uint8)

    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
    with pytest.raises(ValueError, match="boom mid-render"):
        rf.render_to_file(Src(), str(tmp_path / "v.y4m"), caps, 20, 6, " .:@",
                          max_frames=5)


def test_xterm256_rgb_matches_parser_twin():
    """_xterm256_rgb now unpacks web/ansiparse.xterm256 (the one formula);
    pin the ANSI16 head and cube/gray spot values."""
    from asciichat_tpu.models.renderfile import _xterm256_rgb
    from asciichat_tpu.ops.pixel import ANSI16_RGB

    t = _xterm256_rgb()
    np.testing.assert_array_equal(t[:16], np.asarray(ANSI16_RGB, np.uint8))
    assert tuple(t[16]) == (0, 0, 0) and tuple(t[231]) == (255, 255, 255)
    assert tuple(t[232]) == (8, 8, 8) and tuple(t[255]) == (238, 238, 238)


def test_query_does_not_signal_foreign_sigusr1_handlers(tmp_path):
    """A mistyped pid that happens to catch SIGUSR1 (nginx/postgres style)
    used to receive the signal from mere inspection, firing its REAL
    handler action. Non-asciichat processes are now skipped unless
    --force."""
    import subprocess
    import sys
    import time

    from asciichat_tpu.apps import query

    marker = tmp_path / "fired"
    child = subprocess.Popen([
        sys.executable, "-u", "-c",
        "import signal, time, sys\n"
        f"signal.signal(signal.SIGUSR1, lambda *a: open({str(marker)!r}, 'w'))\n"
        "print('R', flush=True)\n"
        "time.sleep(30)\n"], stdout=subprocess.PIPE)
    try:
        assert child.stdout.readline().strip() == b"R"
        assert query._catches_sigusr1(child.pid)
        assert not query._looks_like_asciichat(child.pid)
        out = query.python_stacks(child.pid, timeout=0.6)
        assert out == ""
        time.sleep(0.3)
        assert not marker.exists(), "inspection fired a foreign SIGUSR1 handler"
        # --force still signals (the handler fires; no dump file appears)
        query.python_stacks(child.pid, timeout=0.6, force=True)
        deadline = time.monotonic() + 3
        while not marker.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert marker.exists()
    finally:
        child.kill()
        child.wait()


def test_query_dump_path_honors_target_tmpdir(tmp_path):
    """dumps.py resolves the dump file with the TARGET's tempfile rules; a
    target started with its own TMPDIR wrote somewhere the query tool's
    gettempdir() never polled, so its successful dump read as 'no stacks'."""
    import subprocess
    import sys
    import time

    from asciichat_tpu.apps import query

    custom = tmp_path / "owntmp"
    custom.mkdir()
    child = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(30)"],
        env={**__import__('os').environ, "TMPDIR": str(custom)})
    try:
        time.sleep(0.3)
        got = query._target_dump_path(child.pid)
        assert got == str(custom / f"asciichat-dump-{child.pid}.txt")
    finally:
        child.kill()
        child.wait()


def test_update_checker_caps_response_size(tmp_path):
    """fetch_latest read the release body unboundedly; a hijacked endpoint
    streaming forever would OOM startup. The read is now capped (a too-big
    body fails JSON parsing loudly instead)."""
    import http.server
    import threading

    from asciichat_tpu.net.update_checker import UpdateChecker

    class Huge(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = b"[" + b"1," * (1 << 20) + b"1]"  # ~2 MiB valid JSON
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.HTTPServer(("127.0.0.1", 0), Huge)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        uc = UpdateChecker(api_base=f"http://127.0.0.1:{srv.server_address[1]}",
                           cache_path=str(tmp_path / "cache"))
        with pytest.raises(ValueError):  # truncated JSON, not an OOM
            uc.fetch_latest()
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# seventeenth sweep: mirror / transport / handshake / identity


def test_mirror_run_survives_pop_timeout():
    """A source slower than the 1 s pop window (sub-1fps PTS pacing, webcam
    stall, 'q' racing the loop check) must keep polling, not raise
    queue.Empty out of run()."""
    import time as _time

    from asciichat_tpu.models.mirror import MirrorSession
    from asciichat_tpu.render.types import (
        ColorLevel, RenderMode, TerminalCapabilities,
    )

    class SlowSource:
        fps = 30.0

        def __init__(self):
            self.calls = 0

        def read(self):
            self.calls += 1
            _time.sleep(1.3)  # longer than the main loop's pop timeout
            return None  # then EOF

        def close(self):
            pass

    class _NullWriter:
        is_tty = False

        def write_frame(self, b):
            pass

    class _NullDisplay:
        writer = _NullWriter()
        show_help = False

        def setup(self):
            pass

        def teardown(self):
            pass

        def reset(self):
            pass

        def set_meta(self, *a):
            pass

        def write_frame(self, b):
            pass

    m = MirrorSession(SlowSource(),
                      TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND),
                      20, 8, "   .:-=+*#%@")
    m.display = _NullDisplay()
    assert m.run() == 0  # pre-fix: _queue.Empty traceback out of run()


def test_mirror_snapshot_rejects_dead_source():
    """--snapshot on a source with no decodable frame raises a clean MEDIA
    error instead of feeding None into the render pipeline."""
    import pytest as _pytest

    from asciichat_tpu.models.mirror import MirrorSession
    from asciichat_tpu.render.types import (
        ColorLevel, RenderMode, TerminalCapabilities,
    )
    from asciichat_tpu.utils.errors import AsciiChatError

    class DeadSource:
        fps = 30.0

        def read(self):
            return None

        def close(self):
            pass

    m = MirrorSession(DeadSource(),
                      TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND),
                      20, 8, "   .:-=+*#%@")
    with _pytest.raises(AsciiChatError, match="no frame"):
        m.run_snapshot()


def test_transport_close_bounded_when_sender_stalled():
    """close() must not await a sender parked forever in drain() against a
    peer that stopped reading (TCP zero window) — pre-fix, the sentinel
    landed in a non-full queue, the QueueFull->cancel branch was skipped,
    and close() hung, leaking the connection task + Transport + socket."""
    import asyncio
    import socket

    from asciichat_tpu.net.transport import connect_tcp

    async def run():
        accepted = []

        async def on_conn(reader, writer):
            # never read: the client's kernel send buffer fills up
            accepted.append(writer)
            await asyncio.sleep(30)

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        sock = t.writer.get_extra_info("socket")
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
        # enqueue well past the socket buffer so the sender blocks in drain()
        for _ in range(8):
            assert t.send_nowait(9999, b"x" * (1 << 20))
        await asyncio.sleep(0.2)  # sender picks one up and parks in drain()
        await asyncio.wait_for(t.close(), 10)  # pre-fix: TimeoutError here
        server.close()
        for w in accepted:
            w.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_transport_send_nowait_reports_dead_sender():
    """After the peer is gone (sender task exited), send_nowait must report
    False like send() raises — not keep buffering multi-MB frames into a
    queue nobody drains."""
    import asyncio

    from asciichat_tpu.net.transport import connect_tcp

    async def run():
        async def on_conn(reader, writer):
            writer.close()

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        t._sender_task.cancel()
        await asyncio.sleep(0)  # let the cancellation land
        assert t.send_nowait(9999, b"frame") is False
        assert t._send_queue.empty()
        await t.close()
        server.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_stale_rekey_response_rejected_by_echo():
    """A REKEY_RESPONSE answering an ABANDONED request (stall -> abandon ->
    restart) must not be committed: DH(new_priv, old_resp) is a key the
    responder never computed, and committing it MAC-fails every later
    packet. The response's echo of the request pubkey binds it."""
    import pytest as _pytest

    from asciichat_tpu.net import crypto as C

    a, b = C.CryptoContext(), C.CryptoContext()
    a.compute_shared(b.public_key)
    b.compute_shared(a.public_key)
    req1 = a.start_rekey()
    a.abandon_rekey()
    req2 = a.start_rekey()
    stale = b.respond_rekey(req1)
    with _pytest.raises(ValueError, match="stale"):
        a.finish_rekey(stale)
    assert a.rekey.in_progress  # the live rekey is untouched
    fresh = b.respond_rekey(req2)
    a.finish_rekey(fresh)
    # proof-of-possession commits the responder's pending key
    b.decrypt(a.encrypt(b"REKEY-OK"))
    assert a.shared_key == b.shared_key


def test_identity_file_corrupt_and_atomic(tmp_path):
    """A truncated key file (crash/disk-full mid-write) raises a clear
    ValueError naming the file; creation is tmp+rename so the failure can't
    happen again; the caller (apps/server) falls back to ephemeral."""
    import pytest as _pytest

    from asciichat_tpu.net.identity import Identity

    # corrupt: clear, actionable error
    bad = tmp_path / "host_key"
    bad.write_bytes(b"short")
    with _pytest.raises(ValueError, match="host_key"):
        Identity.load_or_create(bad)
    # create + reload roundtrip, no stray tmp files
    good = tmp_path / "fresh" / "host_key"
    i1 = Identity.load_or_create(good)
    i2 = Identity.load_or_create(good)
    assert i1.public_bytes == i2.public_bytes
    assert [p.name for p in good.parent.iterdir()] == ["host_key"]
    assert good.stat().st_size == 32


def test_client_handshake_validates_parameters():
    """A server selecting unsupported algorithms/sizes in CRYPTO_PARAMETERS
    fails the handshake LOUDLY (handshake/client.c validates the negotiated
    parameters) instead of dying later with opaque MAC errors."""
    import asyncio
    import struct as _struct

    from asciichat_tpu.net import crypto as C
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.handshake import (
        PARAMETERS_STRUCT, HandshakeError, client_handshake,
    )
    from asciichat_tpu.net.transport import Transport, connect_tcp

    async def run():
        P = pkt.PacketType

        async def weird_server(t: Transport):
            await t.recv()  # capabilities
            bad = PARAMETERS_STRUCT.pack(0x7F, 0, 0x7F, 0, 16, 0, 0, 16,
                                         12, 8, 32, b"\0\0\0")
            await t.send(P.CRYPTO_PARAMETERS, bad)
            await t.send(P.CRYPTO_KEY_EXCHANGE_INIT, C.CryptoContext().public_key)
            try:
                await t.recv()
            except (ValueError, ConnectionError, asyncio.IncompleteReadError):
                pass

        server = await asyncio.start_server(
            lambda r, w: weird_server(Transport(r, w)), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        with pytest.raises(HandshakeError, match="unsupported crypto parameters"):
            await client_handshake(t, C.CryptoContext())
        await t.close()
        server.close()

        # short payload is equally fatal
        async def short_server(t: Transport):
            await t.recv()
            await t.send(P.CRYPTO_PARAMETERS, b"\x01\x00")

        server = await asyncio.start_server(
            lambda r, w: short_server(Transport(r, w)), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_tcp("127.0.0.1", port)
        with pytest.raises(HandshakeError, match="short CRYPTO_PARAMETERS"):
            await client_handshake(t, C.CryptoContext())
        await t.close()
        server.close()
        _ = _struct  # keep the import local-style consistent

    asyncio.run(asyncio.wait_for(run(), 30))


# ---------------------------------------------------------------------------
# eighteenth sweep: native ring buffer / sodium / filters / mesh


def test_audio_ring_rejects_absurd_capacities():
    """A zero, negative-wrapped, or huge capacity must fail as the wrapper's
    MemoryError — pre-fix the round-up loop hung forever (cap doubling to 0)
    or overflowed cap*sizeof(float) into a tiny allocation that every write
    then corrupted, and malloc/new failures crashed instead of reporting."""
    from asciichat_tpu.runtime.ringbuffer import AudioRing

    for bad in (0, -1, (1 << 62) + 1, 1 << 40):
        with pytest.raises(MemoryError):
            AudioRing(bad)
    ring = AudioRing(1000)  # normal path still rounds up to a power of two
    assert ring.capacity == 1024


def test_rainbow_negative_time_hits_c_default_red():
    """C's truncating `i % 6` on a negative hue segment falls to the switch
    default (red, color_filter.c:220-225); Python's floored % wrapped into a
    valid segment and tinted differently. The compiled-C gate
    (test_reference_c.py) covers this when refc builds; this pins it always."""
    from asciichat_tpu.ops.filters import rainbow_color

    a = rainbow_color(-1.0)
    b = rainbow_color(-99.37)
    assert a == b  # every negative-segment time is the same default red
    assert a[0] == 255 and a[1] == a[2]  # red + equal-channel luminance boost
    # positive times are untouched by the fix (t=0 is also boosted pure red,
    # verified against the compiled reference C in test_reference_c.py)
    assert rainbow_color(0.0) == (255, 21, 21)
    assert rainbow_color(1.0) != a


# ---------------------------------------------------------------------------
# twentieth sweep: protocol / keyboard / discovery reservations / lifecycle


def test_protocol_unpackers_raise_valueerror_on_short_payloads():
    """struct.error is NOT a ValueError: it escaped the server's bad-data
    disconnect and the client's reconnect catch, killing the process on a
    truncated ERROR_MESSAGE/SIZE_MESSAGE/CLIENT_CAPABILITIES."""
    from asciichat_tpu.net import protocol as proto

    for fn, buf in ((proto.unpack_error, b"\x00\x01"),
                    (proto.unpack_size, b"\x00"),
                    (proto.WireCapabilities.unpack, b"x" * 10)):
        with pytest.raises(ValueError):
            fn(buf)
    # wire stability of the shared error vocabulary (client fallback keys
    # off CODEC_UNAVAILABLE == 3)
    assert proto.WireError.SERVER_FULL == 1
    assert proto.WireError.ENCRYPTION_REQUIRED == 2
    assert proto.WireError.CODEC_UNAVAILABLE == 3
    code, msg = proto.unpack_error(
        proto.pack_error(proto.WireError.CODEC_UNAVAILABLE, "no h265"))
    assert (code, msg) == (3, "no h265")


def test_keyboard_reader_eof_and_escape_sequences(monkeypatch):
    """The POSIX reader loop must exit on EOF (an empty read used to spin a
    100% CPU busy loop on this 1-core host), swallow CSI/SS3 escape
    sequences instead of firing letter bindings on their finals, and
    deliver multibyte UTF-8 as ONE key."""
    import sys as _sys
    import threading
    import time as _time

    from asciichat_tpu.utils.keyboard import KeyboardReader

    r_fd, w_fd = os.pipe()

    class FakeStdin:
        def fileno(self):
            return r_fd

        def isatty(self):
            return False

    keys = []
    kr = KeyboardReader(keys.append)
    monkeypatch.setattr(_sys, "stdin", FakeStdin())
    t = threading.Thread(target=kr._loop, daemon=True)
    t.start()
    os.write(w_fd, b"q\x1b[Af" + "é".encode() + b"\x1bOPm")
    _time.sleep(0.4)
    os.close(w_fd)  # EOF: the loop must EXIT, not spin
    t.join(timeout=2.0)
    assert not t.is_alive(), "reader loop still running after EOF"
    os.close(r_fd)
    # arrow (CSI A) and F1 (SS3 P) swallowed; q/f/é/m delivered
    assert keys == ["q", "f", "é", "m"]


def test_reservation_keepalive_and_deterministic_owner_expiry():
    """A same-owner re-reserve refreshes the TTL (it acked success but kept
    the original reserved_at, so the reservation lapsed anyway), and
    reservation_owner enforces expiry in the query instead of trusting the
    throttled sweep (a dead reservation blocked SESSION_CREATE for up to a
    sweep interval)."""
    import time as _time

    from asciichat_tpu.net.discovery import RESERVATION_TTL_S, SessionDatabase

    db = SessionDatabase(":memory:")
    s = "swift-river-mountain"
    assert db.reserve_string(s, "owner-a")
    # backdate close to expiry, then keepalive-re-reserve: must refresh
    db.db.execute("UPDATE reservations SET reserved_at=?",
                  (_time.time() - RESERVATION_TTL_S + 5,))
    db.db.commit()
    assert db.reserve_string(s, "owner-a")  # keepalive
    (at,) = db.db.execute(
        "SELECT reserved_at FROM reservations WHERE session_string=?",
        (s,)).fetchone()
    assert _time.time() - at < 5  # refreshed, not the backdated stamp
    # a DIFFERENT owner is still rejected while live
    assert not db.reserve_string(s, "owner-b")
    # expired reservation: owner() must say None even though the throttled
    # sweep hasn't run (we bypass it by writing the stale stamp directly)
    db.db.execute("UPDATE reservations SET reserved_at=?",
                  (_time.time() - RESERVATION_TTL_S - 1,))
    db.db.commit()
    db._last_expire = _time.time()  # pin the throttle window shut
    assert db.reservation_owner(s) is None


def test_lifecycle_shutdown_runs_hooks_before_clearing():
    """A hook that initializes a dependency mid-teardown must see truthful
    is_initialized() state, and the dependency's own shutdown hook joins
    THIS round instead of being stranded."""
    from asciichat_tpu.utils import lifecycle

    lifecycle.shutdown_all()  # clean slate
    order = []
    lifecycle.init_once("sys-a")

    def teardown_a():
        order.append("a")
        # mid-shutdown: state must still be truthful
        assert lifecycle.is_initialized("sys-a")
        if lifecycle.init_once("dep"):
            lifecycle.on_shutdown("dep", lambda: order.append("dep"))

    lifecycle.on_shutdown("sys-a", teardown_a)
    lifecycle.shutdown_all()
    assert order == ["a", "dep"]  # dep's hook ran in the same round
    assert not lifecycle.is_initialized("sys-a")
    assert not lifecycle.is_initialized("dep")


def test_production_client_live_resize():
    """AsciiChatClient.request_resize (the SIGWINCH surface, also used by
    the soak's resize churn) re-negotiates dims mid-session: the server's
    view of the client's terminal updates and frames keep flowing."""
    import asyncio
    import time as _time

    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.apps.server import AsciiChatServer
    from asciichat_tpu.net import protocol as proto
    from asciichat_tpu.net.transport import serve_tcp
    from asciichat_tpu.render.types import (
        ColorLevel, RenderMode, TerminalCapabilities,
    )
    from asciichat_tpu.runtime.framesource import open_source
    from asciichat_tpu.utils import term

    async def run():
        server = AsciiChatServer()
        srv = await serve_tcp(server._handle_conn, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        tick = asyncio.get_running_loop().create_task(server._tick_loop())
        caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.FOREGROUND)
        c = AsciiChatClient("127.0.0.1", port, open_source(test_pattern=True),
                            proto.WireCapabilities(caps=caps, width=60, height=18),
                            reconnect=False)
        c.display.writer = term.FrameWriter(open(os.devnull, "wb"))
        task = asyncio.create_task(c.run(max_frames=10**9))
        try:
            t0 = _time.monotonic()
            while _time.monotonic() - t0 < 20 and c.frames_received < 5:
                await asyncio.sleep(0.1)
            assert c.frames_received >= 5, "no frames before resize"
            c.request_resize(44, 12)
            t0 = _time.monotonic()
            while _time.monotonic() - t0 < 20:
                st = next(iter(server.clients.values()), None)
                if st is not None and (st.wire_caps.width,
                                       st.wire_caps.height) == (44, 12):
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError("server never saw the new dims")
            before = c.frames_received
            t0 = _time.monotonic()
            while _time.monotonic() - t0 < 20 and c.frames_received < before + 5:
                await asyncio.sleep(0.1)
            assert c.frames_received >= before + 5, "stream stalled after resize"
        finally:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            tick.cancel()
            try:
                await tick
            except asyncio.CancelledError:
                pass
            srv.close()

    asyncio.run(asyncio.wait_for(run(), 90))


# ---------------------------------------------------------------------------
# twenty-first sweep: emitter boundary / resize dispatch / buffer pool


def test_emit_frames_validates_record_shapes():
    """Shape validation at the NATIVE boundary: an unbatched [H,W,3] frame
    used to become b=H, h=W, w=3 and drive ac_emit_* into a 9x out-of-bounds
    heap read; mismatched records and unknown modes now fail loudly."""
    from asciichat_tpu.render import emitter

    rgb = np.zeros((8, 10, 3), np.uint8)  # unbatched
    luma = np.zeros((8, 10), np.uint8)
    with pytest.raises(ValueError, match="unbatched|B,H,W"):
        emitter.emit_frames({"rgb": rgb, "luma": luma}, "truecolor_fg")
    with pytest.raises(ValueError, match="disagrees"):
        emitter.emit_frames({"rgb": np.zeros((2, 8, 10, 3), np.uint8),
                             "luma": np.zeros((2, 4, 10), np.uint8)},
                            "truecolor_fg")
    with pytest.raises(ValueError, match="requires record"):
        emitter.emit_frames({"rgb": np.zeros((2, 8, 10, 3), np.uint8)},
                            "truecolor_fg")
    with pytest.raises(ValueError, match="unknown mode"):
        emitter.emit_frames({"key": np.zeros((1, 2, 2), np.uint8)}, "bogus")


def test_long_palette_renders_color_modes():
    """A 65-255 char palette is valid for the truecolor/256 paths (parse
    clips at 255 like the reference); eagerly building the 64-ramp mono
    table used to raise before ANY mode could render. Mono still rejects."""
    from asciichat_tpu.render.pipeline import AsciiRenderer
    from asciichat_tpu.render.types import (
        ColorLevel, RenderMode, TerminalCapabilities,
    )

    long_pal = " " + "".join(chr(0x21 + i) for i in range(80))  # 81 chars
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    r = AsciiRenderer(long_pal)
    out = r.convert(rgb, 20, 8,
                    TerminalCapabilities(ColorLevel.TRUECOLOR,
                                         RenderMode.FOREGROUND))
    assert out and b"\x1b[38;2;" in out
    with pytest.raises(ValueError, match="64"):
        r.convert(rgb, 20, 8,
                  TerminalCapabilities(ColorLevel.NONE, RenderMode.FOREGROUND))


def test_emitter_buffer_pool_size_classes():
    """Strides in the same 16 KiB class share one pooled buffer (resize
    churn used to allocate — and page-fault — a fresh multi-MB array per
    geometry, and the >8 bound cleared the hot buffer too)."""
    from asciichat_tpu.render.emitter import _out_buffers

    out1, _, cls1 = _out_buffers(4, 20000)
    out2, _, cls2 = _out_buffers(4, 21000)  # same 32 KiB class
    assert cls1 == cls2 and out1 is out2
    out3, _, _ = _out_buffers(4, 40000)  # different class: different buffer
    assert out3 is not out1
    # eviction is per-entry FIFO, not clear(): the most recent stays
    for i in range(12):
        _out_buffers(4, 16384 * (3 + i))
    out2b, _, _ = _out_buffers(4, 16384 * 14)  # still cached (recent)
    assert out2b is not None


def test_resize_auto_lowers_to_gather_on_cpu_inside_jit():
    """The resize lowers to gathers on every platform, even for >=256x256
    sources: no dense one-hot matrix products (visible as dot ops) in the
    lowering."""
    import jax

    from asciichat_tpu.ops import pixel

    big = np.zeros((1, 300, 300, 3), np.uint8)
    txt = jax.jit(lambda f: pixel.resize_nn(f, 64, 64)).lower(big).as_text()
    assert "dot" not in txt  # gather formulation: no matmuls on CPU
    # and value-identical to the fixed-point oracle
    from asciichat_tpu.render import oracle

    rng = np.random.default_rng(3)
    f = rng.integers(0, 256, (1, 300, 300, 3), dtype=np.uint8)
    got = np.asarray(jax.jit(lambda x: pixel.resize_nn(x, 64, 64))(f))
    np.testing.assert_array_equal(got[0], oracle.resize_image(f[0], 64, 64))


# ---------------------------------------------------------------------------
# twenty-second sweep: framefd / aspect / fps / inspector


def test_framefd_survives_short_reads_and_flags_trailing_garbage():
    """POSIX reads return short past the pipe buffer: a fragmented healthy
    frame must reassemble (a single fd_read(total) misdiagnosed it as
    'truncated'), and a body longer than its rows must fail AT the corrupt
    frame, not one frame later as bad-magic."""
    import io
    import struct as _struct

    from asciichat_tpu.utils import framefd

    frame = b"\x1b[38;2;1;2;3m" + b"X" * 150_000 + b"\nrow2"
    buf = io.BytesIO()
    framefd.write_frame(buf.write, frame)
    data = buf.getvalue()

    class Dribble:  # returns at most 1000 bytes per call (pipe-like)
        def __init__(self, raw):
            self.raw, self.at = raw, 0

        def read(self, n):
            chunk = self.raw[self.at : self.at + min(n, 1000)]
            self.at += len(chunk)
            return chunk

    assert framefd.read_frame(Dribble(data).read) == frame
    # trailing garbage: total_len says 100, rows account for 5
    bad = framefd.MAGIC + _struct.pack(">II", 100, 1) + _struct.pack(">I", 5)
    bad += b"hello" + b"\x00" * 91
    with pytest.raises(ValueError, match="trailing"):
        framefd.read_frame(io.BytesIO(bad).read)


def test_aspect_degenerate_dims_match_reference_clamps():
    """C clamps upper-then-lower (aspect_ratio.c:185-193): a 0 max dim
    yields 1, never a 0 that later explodes inside resize_indices — and
    resize_indices itself rejects degenerate dims with ValueError instead
    of OverflowError/ZeroDivisionError."""
    from asciichat_tpu.utils.aspect import fit_dimensions_pixel, resize_indices

    w, h = fit_dimensions_pixel(640, 480, 0, 24)
    assert w == 1 and h >= 1
    w, h = fit_dimensions_pixel(640, 480, 80, 0)
    assert h == 1 and w >= 1
    for src, dst in ((0, 10), (10, 0), (-1, 4)):
        with pytest.raises(ValueError, match="degenerate"):
            resize_indices(src, dst)


def test_fps_counter_matches_reference_window_semantics():
    """lib/ui/fps_counter.c: 30-timestamp circular window, rate =
    (count-1)/elapsed, 0.0 until two ticks — the prior EMA cited the same
    file while converging ~50% slower on rate steps."""
    from asciichat_tpu.utils.fps import FPS_WINDOW_SIZE, FpsCounter

    c = FpsCounter()
    assert c.tick(now=0.0) == 0.0  # <2 ticks -> 0.0 like the C
    assert c.tick(now=1 / 60) == pytest.approx(60.0)
    t = 1 / 60
    for _ in range(60):  # a full window at 60 fps
        t += 1 / 60
        c.tick(now=t)
    assert c.fps == pytest.approx(60.0)
    # step to 30 fps: after one full window the old rate is fully gone
    for _ in range(FPS_WINDOW_SIZE):
        t += 1 / 30
        c.tick(now=t)
    assert c.fps == pytest.approx(30.0)


def test_inspector_duplicate_threads_routing_and_socket_close():
    """Duplicate thread names must BOTH appear in /threads (the dropped one
    could be the deadlocked thread the endpoint exists to find), routes
    strip query strings and %-decode provider names, provider exceptions
    with newlines still produce an HTTP 500, and stop() releases the
    listening socket for immediate rebind."""
    import json as _json
    import threading
    import urllib.error
    import urllib.request

    from asciichat_tpu.runtime.inspector import Inspector

    ins = Inspector()
    ins.register("frame age", lambda: {"ok": 1})
    ins.register("boom", lambda: (_ for _ in ()).throw(
        RuntimeError("line1\nline2 ☃")))
    port = ins.start()

    stop_evt = threading.Event()
    threads = [threading.Thread(target=stop_evt.wait, name="twin", daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                return _json.loads(r.read())

        tmap = get("/threads?verbose=1")  # query string tolerated
        assert sum(1 for k in tmap if k.startswith("twin-")) == 2
        assert get("/state/frame%20age") == {"ok": 1}
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/state/boom")
        assert ei.value.code == 500  # newline/unicode exc still answered
    finally:
        stop_evt.set()
        ins.stop()
    # socket actually closed: immediate rebind of the same port works
    ins2 = Inspector(port=port)
    assert ins2.start() == port
    ins2.stop()


def test_client_initial_dial_retries_briefly():
    """The first dial retries a refused connection a few times even with
    reconnect=False (connection_attempt.c role): --no-reconnect governs
    post-session behavior, not a SYN racing a starved accept loop — this
    was the suite's recurring contention-flake class."""
    import asyncio
    import time as _time

    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.net import protocol as proto
    from asciichat_tpu.net.transport import serve_tcp
    from asciichat_tpu.runtime.framesource import open_source

    async def run():
        # grab a port, then DON'T listen yet
        probe = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
        port = probe.sockets[0].getsockname()[1]
        probe.close()
        await probe.wait_closed()
        seen = asyncio.Event()

        async def handler(t):
            seen.set()
            try:
                while True:
                    await t.recv()
            except (ValueError, ConnectionError, asyncio.IncompleteReadError):
                pass

        c = AsciiChatClient("127.0.0.1", port, open_source(test_pattern=True),
                            proto.WireCapabilities(), reconnect=False)
        c.display.writer = __import__(
            "asciichat_tpu.utils.term", fromlist=["term"]).FrameWriter(
            open(os.devnull, "wb"))
        task = asyncio.create_task(c.run(max_frames=5))
        await asyncio.sleep(0.4)  # first dial refused; ladder is sleeping
        srv = await serve_tcp(handler, "127.0.0.1", port)  # now listen
        try:
            await asyncio.wait_for(seen.wait(), 10)  # second attempt landed
        finally:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
            srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))
    _ = _time


# ---------------------------------------------------------------------------
# twenty-third sweep: websocket RFC conformance + shared sender machinery


def test_ws_control_frame_rules_and_interleave():
    """RFC 6455: control frames are <=125 bytes and never fragmented (a
    5 MB PING used to be accepted AND echoed as a 5 MB PONG — itself a
    violation peers fail on), and a new data frame may not interleave an
    unfinished fragmented message (the partial was silently discarded,
    losing half an ACIP packet and desyncing the deflate window)."""
    import asyncio
    import struct as st

    from asciichat_tpu.net.websocket import WebSocketConnection

    async def run(frames: bytes):
        r = asyncio.StreamReader()
        r.feed_data(frames)
        r.feed_eof()
        ws = WebSocketConnection(r, None, is_client=False)
        return await ws.recv_message()

    # oversized PING (126-byte payload -> extended length)
    big_ping = st.pack(">BBH", 0x89, 126, 300) + b"p" * 300
    with pytest.raises(ValueError, match="control frame"):
        asyncio.run(run(big_ping))
    # fragmented PING (fin=0)
    with pytest.raises(ValueError, match="control frame"):
        asyncio.run(run(st.pack(">BB", 0x09, 1) + b"p"))
    # BINARY(no FIN) then a NEW BINARY start: fail, don't drop the partial
    interleave = (st.pack(">BB", 0x02, 2) + b"ab"
                  + st.pack(">BB", 0x82, 2) + b"cd")
    with pytest.raises(ValueError, match="interleaved"):
        asyncio.run(run(interleave))
    # a small ping between fragments still works mid-message
    ok = (st.pack(">BB", 0x02, 2) + b"ab"
          + st.pack(">BB", 0x80, 2) + b"cd")

    async def run_no_writer(frames):
        r = asyncio.StreamReader()
        r.feed_data(frames)
        r.feed_eof()
        return await WebSocketConnection(r, None, is_client=False).recv_message()

    op, msg = asyncio.run(run_no_writer(ok))
    assert msg == b"abcd"


def test_ws_upgrade_requires_get_and_websocket_header():
    """An h2c probe (or POST) carrying a stray Sec-WebSocket-Key used to be
    answered '101 ... websocket' and handed to the ACIP handler; upgrades
    now require method GET + Upgrade: websocket (RFC 6455 §4.2.1)."""
    import asyncio

    from asciichat_tpu.net.websocket import serve_ws

    async def run():
        async def handler(t):
            raise AssertionError("h2c probe must not reach the WS handler")

        server = await serve_ws(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET / HTTP/1.1\r\nHost: x\r\n"
                     b"Connection: Upgrade\r\nUpgrade: h2c\r\n"
                     b"Sec-WebSocket-Key: aaaabbbbccccdddd\r\n\r\n")
        await writer.drain()
        status = await reader.readline()
        assert b"400" in status or b"404" in status, status
        writer.close()
        server.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_ws_transport_close_bounded_and_dead_sender():
    """The WS transport now shares the TCP twin's sender machinery: close()
    is bounded against a stalled peer (it used to await the parked sender
    forever, leaking the connection on every stalled browser tab) and
    send_nowait reports a dead sender instead of buffering into the void."""
    import asyncio
    import socket

    from asciichat_tpu.net.websocket import connect_ws, serve_ws

    async def run():
        async def handler(t):
            # never read application data: the client's sender will park
            await asyncio.sleep(30)

        server = await serve_ws(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        t = await connect_ws("127.0.0.1", port)
        sock = t.ws.writer.get_extra_info("socket")
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
        for _ in range(8):
            t.send_nowait(9999, os.urandom(1 << 20))  # incompressible
        await asyncio.sleep(0.2)
        await asyncio.wait_for(t.close(), 10)  # pre-fix: hang
        # dead sender: a fresh transport whose sender task is cancelled
        t2 = await connect_ws("127.0.0.1", port)
        t2._sender_task.cancel()
        await asyncio.sleep(0)
        assert t2.send_nowait(9999, b"x") is False
        await t2.close()
        server.close()

    asyncio.run(asyncio.wait_for(run(), 30))


# ---------------------------------------------------------------------------
# twenty-fourth sweep: SCTP shutdown semantics + DTLS lifecycle


def _sctp_pair(now):
    import random as _random

    from asciichat_tpu.net import sctp as sctp_mod

    qa, qb = [], []
    a = sctp_mod.SctpAssociation(qb.append, client=True, now_fn=lambda: now[0])
    b = sctp_mod.SctpAssociation(qa.append, client=False, now_fn=lambda: now[0])

    def pump(loss=0.0, iters=400, seed=3):
        rng = _random.Random(seed)
        for _ in range(iters):
            while qb:
                p = qb.pop(0)
                if rng.random() >= loss:
                    b.on_packet(p)
            while qa:
                p = qa.pop(0)
                if rng.random() >= loss:
                    a.on_packet(p)
            now[0] += 0.1
            a.tick()
            b.tick()

    return a, b, qa, qb, pump


def test_sctp_shutdown_drains_peer_in_flight_data():
    """RFC 9260 §9.2: the SHUTDOWN receiver must deliver ITS outstanding/
    queued DATA before SHUTDOWN_ACK — an immediate ack used to destroy a
    cwnd-limited 5000-byte message entirely (0 bytes delivered)."""
    from asciichat_tpu.net import sctp as sctp_mod

    now = [0.0]
    a, b, qa, qb, pump = _sctp_pair(now)
    got_a = []
    a.on_message = lambda s, p, d: got_a.append(d)
    a.connect()
    pump(iters=50)
    assert a.state == "established"
    msg = bytes(range(256)) * 40  # 10240 bytes: fragments + cwnd-limited
    b.send(0, sctp_mod.PPID_BINARY, msg)
    a.shutdown()  # graceful close races B's in-flight message
    pump(iters=200)
    assert got_a == [msg]  # pre-fix: []
    assert a.state == "done" and b.state == "done"


def test_sctp_lost_shutdown_retransmits_and_converges():
    """A single lost SHUTDOWN/SHUTDOWN_ACK datagram used to wedge BOTH
    endpoints forever (no T2 timer). The shutdown chunks now ride the
    retransmission machinery and the close converges despite 30% loss."""
    now = [0.0]
    a, b, qa, qb, pump = _sctp_pair(now)
    a.connect()
    pump(iters=80)
    assert a.state == "established"
    qb.clear()  # drop everything A says for a moment…
    a.shutdown()
    qb.clear()  # …including the first SHUTDOWN: guaranteed lost
    pump(loss=0.3, iters=600, seed=7)
    assert a.state == "done", a.state
    assert b.state == "done", b.state  # pre-fix: established ghost forever


def test_sctp_rejects_bundled_init_and_post_abort_chunks():
    """INIT must be the sole chunk of a vtag-0 packet (a bundled INIT
    disabled the vtag check, letting a forged INIT+ABORT kill an
    established association), and nothing after an ABORT in the same
    packet may be processed (DATA used to deliver AFTER on_closed)."""
    from asciichat_tpu.net import sctp as sctp_mod

    now = [0.0]
    a, b, qa, qb, pump = _sctp_pair(now)
    events = []
    b.on_message = lambda s, p, d: events.append(("msg", d))
    b.on_closed = lambda r: events.append(("closed", r))
    a.connect()
    pump(iters=50)
    assert b.state == "established"
    import struct as _struct

    # forged INIT+ABORT under a garbage vtag: must be ignored entirely
    forged = sctp_mod.pack_packet(
        5000, 5000, 0xDEADBEEF,
        sctp_mod._chunk(sctp_mod.CT_INIT, 0,
                        _struct.pack(">IIHHI", 1, 1, 1, 1, 1))
        + sctp_mod._chunk(sctp_mod.CT_ABORT, 0, b""))
    b.on_packet(forged)
    assert b.state == "established" and not events
    # ABORT then DATA bundled with the REAL vtag: closed fires, msg does not
    data = sctp_mod._chunk(
        sctp_mod.CT_DATA, 0x03,
        sctp_mod._DATA_HDR.pack(0, 0, 0, sctp_mod.PPID_BINARY) + b"late")
    pkt2 = sctp_mod.pack_packet(5000, 5000, b.my_vtag,
                                sctp_mod._chunk(sctp_mod.CT_ABORT, 0, b"") + data)
    b.on_packet(pkt2)
    assert events == [("closed", "peer abort")]


def test_sctp_cwnd_frozen_during_fast_recovery():
    """cwnd must not grow on pure gap-ack SACKs while the cumulative point
    stalls (RFC 9260 §7.2): each one used to add an MTU, overdriving the
    lossy path through the whole loss episode."""
    from asciichat_tpu.net import sctp as sctp_mod

    now = [0.0]
    a, b, qa, qb, pump = _sctp_pair(now)
    a.connect()
    pump(iters=50)
    for i in range(30):
        a.send(0, sctp_mod.PPID_BINARY, bytes([i]) * 900)
    # drop the first DATA packet A sent; deliver the rest
    dropped = False
    for _ in range(400):
        while qb:
            p = qb.pop(0)
            chunks = sctp_mod.unpack_packet(p)[3]
            if (not dropped
                    and any(c[0] == sctp_mod.CT_DATA for c in chunks)):
                dropped = True
                continue  # lose exactly the first data packet
            b.on_packet(p)
        if a._fr_exit is not None:
            # WHILE in fast recovery, pure SACK progress must not grow
            # cwnd; growth may legally resume once cum passes _fr_exit
            while qa and a._fr_exit is not None:
                before = a.cwnd
                a.on_packet(qa.pop(0))
                if a._fr_exit is not None:
                    assert a.cwnd <= before, "cwnd grew during fast recovery"
            break
        while qa:
            a.on_packet(qa.pop(0))
        now[0] += 0.05
        a.tick()
        b.tick()
    assert dropped


def test_dtls_fatal_alert_marks_endpoint_closed(monkeypatch):
    """A peer dying with a FATAL ALERT / protocol error (SSL_ERROR_SSL,
    not close_notify) must mark the endpoint closed — it used to be
    swallowed, so the datachannel ghost-detection never fired and recv()
    blocked forever. The fatal path is injected at the OpenSSL boundary
    for determinism."""
    from asciichat_tpu.net import dtls as dtls_mod

    if not dtls_mod.available():
        pytest.skip("no OpenSSL 3")
    ida = dtls_mod.DtlsIdentity.generate("peer-a")
    idb = dtls_mod.DtlsIdentity.generate("peer-b")
    a = dtls_mod.DtlsEndpoint(ida, server=False)
    b = dtls_mod.DtlsEndpoint(idb, server=True)
    a.start()
    b.start()
    for _ in range(40):
        for dg in a.outgoing():
            b.incoming(dg)
        for dg in b.outgoing():
            a.incoming(dg)
        if a.handshake_complete and b.handshake_complete:
            break
    assert a.handshake_complete and b.handshake_complete
    monkeypatch.setattr(dtls_mod._ssl, "SSL_read",
                        lambda _s, _b, _n: -1)
    monkeypatch.setattr(dtls_mod._ssl, "SSL_get_error",
                        lambda _s, _rc: 1)  # SSL_ERROR_SSL
    assert a.read() == []
    assert a.closed  # pre-fix: stayed False forever


# ---------------------------------------------------------------------------
# twenty-fifth sweep: ICE agent / STUN second pass


def test_stun_attribute_overrun_raises():
    """An attribute claiming bytes past the declared message end must raise
    StunError (it used to silently truncate the value, deferring the
    failure to a confusing downstream parse)."""
    import struct as _struct

    from asciichat_tpu.net import stun

    txid = stun.new_transaction_id()
    body = _struct.pack(">HH", stun.ATTR_XOR_MAPPED_ADDRESS, 200) + b"\x00" * 4
    msg = stun.HEADER.pack(stun.BINDING_SUCCESS, len(body),
                           stun.MAGIC_COOKIE, txid) + body
    with pytest.raises(stun.StunError, match="overrun"):
        stun.parse(msg)


def test_ice_unsolicited_binding_success_cannot_move_nomination():
    """RFC 5389 §7.3.3: a BINDING_SUCCESS matching no outstanding check or
    consent transaction is discarded. Responses are signed with the static
    ICE password, so one captured response replayed from an attacker
    address used to nominate/move the live channel there (blackhole DoS)."""
    import asyncio

    from asciichat_tpu.net import stun
    from asciichat_tpu.net.webrtc import IceLiteAgent

    async def run():
        a = IceLiteAgent(controlling=True)

        class FakeTx:
            sent = []

            def sendto(self, d, addr):
                self.sent.append((d, addr))

            def get_extra_info(self, *_):
                return ("0.0.0.0", 1)

            def close(self):
                pass

        a.transport = FakeTx()
        peer = IceLiteAgent(controlling=False)
        peer.transport = FakeTx()
        a.set_remote(peer.local_description() | {"candidates": []})
        # a VALID response (signed with the remote pwd) with a txid we
        # never issued — must be ignored, not nominated
        txid = stun.new_transaction_id()
        resp = stun.make_binding_response(
            txid, ("6.6.6.6", 666), peer.local_description()["pwd"].encode())
        a._on_stun(resp, ("6.6.6.6", 666))
        assert a.peer_addr is None and a.channel is None
        # a response matching an outstanding CHECK nominates the pair we
        # CHECKED (not the datagram's source)
        a._check_txids[txid] = ("10.0.0.9", 999)
        a._on_stun(resp, ("6.6.6.6", 666))
        assert a.peer_addr == ("10.0.0.9", 999)
        a.close()
        peer.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_ice_prflx_promotion_survives_full_candidate_list():
    """With >=24 advertised candidates, the prflx bound used to evict the
    candidate that was JUST promoted (the only prflx), making promotion a
    permanent no-op; advertised candidates must never be evicted."""
    import asyncio

    from asciichat_tpu.net import stun
    from asciichat_tpu.net.webrtc import IceLiteAgent

    async def run():
        a = IceLiteAgent(controlling=False)

        class FakeTx:
            def sendto(self, d, addr):
                pass

            def get_extra_info(self, *_):
                return ("0.0.0.0", 1)

            def close(self):
                pass

        a.transport = FakeTx()
        peer = IceLiteAgent(controlling=True)
        peer.transport = FakeTx()
        desc = peer.local_description()
        desc["candidates"] = [{"ip": f"10.0.0.{i}", "port": 1000 + i}
                              for i in range(25)]
        a.set_remote(desc)
        req = stun.make_binding_request(
            stun.new_transaction_id(), "x:y", a.pwd.encode(),
            controlling=True)
        a._on_stun(req, ("198.51.100.7", 40000))
        prflx = [c for c in a.remote["candidates"]
                 if c.get("type") == "prflx"]
        assert prflx == [{"ip": "198.51.100.7", "port": 40000,
                          "type": "prflx"}]
        # advertised entries all survived
        assert len(a.remote["candidates"]) == 26
        a.close()
        peer.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_ice_nomination_before_set_remote_defers_channel():
    """A USE-CANDIDATE landing before set_remote must NOT mint a keyless
    legacy channel (it silently dropped every DTLS datagram and was never
    upgraded): nomination defers and replays once the remote description
    (protocol + key material) is known."""
    import asyncio

    from asciichat_tpu.net.webrtc import IceLiteAgent

    async def run():
        a = IceLiteAgent(controlling=False)

        class FakeTx:
            def sendto(self, d, addr):
                pass

            def get_extra_info(self, *_):
                return ("0.0.0.0", 1)

            def close(self):
                pass

        a.transport = FakeTx()
        a._nominate(("192.0.2.4", 7000))  # before set_remote
        assert a.channel is None and a.peer_addr is None
        assert not a.connected.is_set()
        peer = IceLiteAgent(controlling=True)
        peer.transport = FakeTx()
        a.set_remote(peer.local_description())
        assert a.peer_addr == ("192.0.2.4", 7000)
        assert a.channel is not None and a.connected.is_set()
        a.close()
        peer.close()

    asyncio.run(asyncio.wait_for(run(), 30))


# ---------------------------------------------------------------------------
# twenty-sixth sweep: device tick model second pass


def test_count_collectives_matches_async_tuple_form():
    """On real multi-chip hardware XLA lowers collectives ASYNC with tuple
    result shapes; the old '\\S+' shape token never matched the spaces in
    '(u8[..], u8[..])' so mesh_collectives read 0 there (CPU's sync form
    hid it). Operand references and done-halves still must not count."""
    from asciichat_tpu.models.server import count_collectives

    sync = "  %ag = u8[4,2]{1,0} all-gather(%p0), dimensions={0}\n"
    async_ = ("  %ags = (u8[4]{0}, u8[8]{0}) all-gather-start(%p0), dims={0}\n"
              "  %agd = u8[8]{0} all-gather-done(%ags)\n")
    noise = ("  %not-all-gather-x = u8[2]{0} add(%all-gather-like, %b)\n"
             "  ROOT %r = u8[8]{0} tuple(%agd)\n")
    rs = "  %rs = (f32[2]{0}, f32[1]{0}) reduce-scatter-start(%x), dims={0}\n"
    assert count_collectives(sync) == 1
    assert count_collectives(async_) == 1  # start counts, done doesn't
    assert count_collectives(noise) == 0
    assert count_collectives(rs) == 1
    assert count_collectives(sync + async_ + rs + noise) == 3


def test_servertick_rainbow_cycles_over_time():
    """ServerTick froze the rainbow tint at t=0 forever; the reference
    cycles hue over 3.5 s (color_filter.c:169). step(time_s=...) now
    refreshes the tint like the production RenderGroup does."""
    import jax.numpy as jnp
    import numpy as _np

    from asciichat_tpu.models.server import ServerTick, plan_tick
    from asciichat_tpu.render.types import (
        ColorLevel, RenderMode, TerminalCapabilities,
    )

    caps = TerminalCapabilities(ColorLevel.TRUECOLOR, RenderMode.HALF_BLOCK)
    plan = plan_tick([(32, 24)] * 2, term_w=40, term_h=20, caps=caps)
    tick = ServerTick(plan, client_filters=["rainbow", "none"])
    assert tick.has_rainbow
    rng = _np.random.default_rng(0)
    frames = jnp.asarray(rng.integers(0, 256, (2, 24, 32, 3), dtype=_np.uint8))
    audio = jnp.zeros((2, 480), _np.float32)
    active = jnp.ones(2, bool)
    tick.step(frames, audio, active, time_s=0.0)
    t0 = _np.asarray(tick.tint).copy()
    tick.step(frames, audio, active, time_s=1.2)
    t1 = _np.asarray(tick.tint)
    assert not _np.array_equal(t0[0], t1[0])  # rainbow receiver cycled
    _np.testing.assert_array_equal(t0[1], t1[1])  # 'none' stays put


def test_plan_composite_skips_zero_by_zero_source():
    """A (0,0) source used to make src_aspect NaN and raise ValueError out
    of int(NaN); degenerate sources compose nothing like the other
    zero-fit cases."""
    from asciichat_tpu.ops.compositor import plan_composite

    plan = plan_composite([(0, 0), (32, 24)], 80, 24)
    assert plan is not None  # no crash; the real source still composes
    assert (plan.client_idx == 1).any()
    assert not (plan.client_idx == 0).any()  # the (0,0) source drew nothing


# ---------------------------------------------------------------------------
# twenty-seventh sweep: codec runtime / audio devices second pass


def test_ffmpeg_h265_encoder_rejects_wrong_shape():
    """rawvideo has no framing: one wrong-sized frame permanently desyncs
    every later frame boundary in the pipe with no error — the CLI fallback
    must gate shapes like the native encoder does."""
    import shutil as _shutil

    import numpy as _np

    from asciichat_tpu.runtime.codecs import FFmpegH265Encoder

    if not _shutil.which("ffmpeg"):
        pytest.skip("no ffmpeg CLI")
    enc = FFmpegH265Encoder(64, 48, fps=30)
    try:
        with pytest.raises(ValueError, match="h265 frame must be"):
            enc.encode(_np.zeros((24, 32, 3), _np.uint8))
        enc.encode(_np.zeros((48, 64, 3), _np.uint8))  # right shape still works
    finally:
        enc.close()


def test_opus_encode_rejects_stereo_shape():
    """A (480, 2) stereo array passed the old len() gate and opus consumed
    interleaved L/R as 480 mono samples — corrupted audio, no error."""
    import numpy as _np

    from asciichat_tpu.runtime.codecs import CodecUnavailable, OpusCodec

    try:
        c = OpusCodec()
    except CodecUnavailable:
        pytest.skip("no libopus")
    try:
        with pytest.raises(ValueError, match="shape"):
            c.encode(_np.zeros((480, 2), _np.float32))
        assert c.encode(_np.zeros(480, _np.float32))  # mono still encodes
    finally:
        c.close()


def test_wav_empty_at_foreign_rate_maps_to_unavailable(tmp_path):
    """An empty 44.1 kHz WAV hit np.interp before the emptiness check and
    raised a raw numpy ValueError instead of the class's contract."""
    import wave

    from asciichat_tpu.runtime.audiodev import (
        AudioSourceUnavailable, WavFileSource,
    )

    p = tmp_path / "empty.wav"
    with wave.open(str(p), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(44100)  # != 48000: forces the resample path
    with pytest.raises(AudioSourceUnavailable, match="empty"):
        WavFileSource(str(p))


def test_audiodev_reap_never_raises(tmp_path):
    """Device-process teardown escalates EOF-wait -> terminate -> kill and
    never lets TimeoutExpired escape the client's shutdown path."""
    import subprocess
    import time as _time

    from asciichat_tpu.runtime.audiodev import _reap

    proc = subprocess.Popen(["sleep", "30"])
    t0 = _time.monotonic()
    _reap(proc)  # wait(5) times out -> terminate -> reaped
    assert proc.poll() is not None
    assert _time.monotonic() - t0 < 10


def test_probe_reports_cli_fallback_when_shim_unavailable(monkeypatch):
    """With no buildable avshim but ffmpeg on PATH, H265Encoder() encodes
    via the CLI — the probe must say so instead of advertising h265 with a
    null negotiated encoder."""
    import shutil as _shutil

    from asciichat_tpu.runtime import codecs
    from asciichat_tpu.runtime.codecs import CodecUnavailable

    if not _shutil.which("ffmpeg"):
        pytest.skip("no ffmpeg CLI")

    def no_shim():
        raise CodecUnavailable("avshim unavailable (test)")

    monkeypatch.setattr(codecs, "_avshim", no_shim)
    # unique order tuple -> fresh cache key
    got = codecs.probe_h265_encoder(order=("libx265", "hevc_vaapi"))
    assert got == "libx265/ffmpeg-cli"


# ---------------------------------------------------------------------------
# twenty-eighth sweep: production server second pass


def test_client_palette_resolution_matches_reference_types():
    """palette_type 1-4 select the builtin ramps (initialize_client_palette,
    protocol.c:1670-1719) — only palette_custom was honored, so a reference
    client sending --palette blocks (type=1, empty custom) got standard-
    palette frames."""
    from asciichat_tpu.apps.server import _client_palette
    from asciichat_tpu.net.protocol import WireCapabilities
    from asciichat_tpu.render import palette as pal

    wc = WireCapabilities(palette_type=1, palette_custom="")
    assert _client_palette(wc, pal.DEFAULT_PALETTE) == pal.BUILTIN_PALETTES["blocks"]
    wc = WireCapabilities(palette_type=4, palette_custom="")
    assert _client_palette(wc, pal.DEFAULT_PALETTE) == pal.BUILTIN_PALETTES["cool"]
    # custom wins regardless of type (our JS client sends type 0 + chars)
    wc = WireCapabilities(palette_type=0, palette_custom=" .:#")
    assert _client_palette(wc, pal.DEFAULT_PALETTE) == " .:#"
    # type 0 / out-of-range inherit the server palette
    wc = WireCapabilities(palette_type=0, palette_custom="")
    assert _client_palette(wc, "XYZ") == "XYZ"
    wc = WireCapabilities(palette_type=5, palette_custom="")
    assert _client_palette(wc, "XYZ") == "XYZ"


def test_server_main_forwards_palette(monkeypatch):
    """`server --palette blocks` was accepted and silently ignored — the
    constructor call skipped the palette argument entirely."""
    import asyncio

    from asciichat_tpu.apps import main as main_mod
    from asciichat_tpu.apps import server as server_mod
    from asciichat_tpu.render import palette as pal

    seen = {}

    class FakeServer:
        def __init__(self, *a, **kw):
            seen.update(kw)

        async def run(self):
            return None

    monkeypatch.setattr(server_mod, "AsciiChatServer", FakeServer)
    args = main_mod.build_parser().parse_args(["server", "--palette", "blocks"])
    server_mod.main(args)
    assert seen.get("palette") == pal.BUILTIN_PALETTES["blocks"]
    _ = asyncio  # silence unused-import style


def test_host_render_tick_per_geometry_and_palette(monkeypatch):
    """The host fallback composites per GEOMETRY (one max-dims composite
    rescaled down gave small receivers a letterboxed picture of the large
    receiver's grid layout), honors palette_type, reuses payloads, and its
    renderers commit to the CPU backend (true device independence)."""
    import jax

    from asciichat_tpu.apps.server import AsciiChatServer, ClientState
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.render.types import (
        ColorLevel, RenderMode, TerminalCapabilities,
    )
    from asciichat_tpu.web import ansiparse

    srv = AsciiChatServer()

    class FakeTransport:
        def __init__(self):
            self.sent = []

        def send_nowait(self, ptype, payload, **kw):
            self.sent.append((ptype, payload))
            return True

    def mk(cid, w, h, ptype=0):
        c = ClientState(cid, FakeTransport())
        c.wire_caps.width, c.wire_caps.height = w, h
        c.wire_caps.caps = TerminalCapabilities(ColorLevel.NONE,
                                                RenderMode.FOREGROUND)
        c.wire_caps.palette_type = ptype
        c.has_caps = True
        return c

    small = mk(1, 40, 12)
    big = mk(2, 90, 26)
    blocks = mk(3, 40, 12, ptype=1)  # same geometry as small, blocks ramp
    # BRIGHT content: the ramp maps random-luma frames mostly into the
    # palettes' leading spaces (byte-exact vs the oracle); white pins the
    # top ramp entry so the glyph set is observable
    stack = np.full((1, 48, 64, 3), 255, np.uint8)
    srv._render_tick_host([small, big, blocks], ((64, 48),), stack)
    for c in (small, big, blocks):
        assert c.transport.sent, f"client {c.id} got no frame"
    # per-client dims in the frame header — NOT the max geometry
    for c, (w, h) in ((small, (40, 12)), (big, (90, 26)), (blocks, (40, 12))):
        frame, fw, fh, _ = pkt.unpack_ascii_frame(c.transport.sent[0][1])
        assert (fw, fh) == (w, h)
        grid = ansiparse.AnsiGrid().parse(frame)
        assert (grid.w, grid.h) == (w, h)
    # the blocks-palette receiver renders from the blocks ramp
    # the palette must CHANGE the bytes (glyph identity is governed by the
    # reference's deliberate cache64[char_idx] double-indexing quirk,
    # foreground.c:100-103 — byte-exactness is gated elsewhere; here we
    # pin that palette_type routed a DIFFERENT ramp at all)
    bframe = pkt.unpack_ascii_frame(blocks.transport.sent[0][1])[0]
    sframe = pkt.unpack_ascii_frame(small.transport.sent[0][1])[0]
    assert bframe != sframe
    # renderers committed to CPU (the point of the fallback)
    cpu = jax.devices("cpu")[0]
    for r in srv._renderer_cache.values():
        ramp = r._ramp
        assert set(getattr(ramp, "devices", lambda: {cpu})()) == {cpu}


# ---------------------------------------------------------------------------
# twenty-ninth sweep: production client second pass


def test_client_h265_refusal_latches_against_server_state():
    """A CODEC_UNAVAILABLE refusal must latch: the next SERVER_STATE
    broadcast used to re-enable the uplink, and (the server having latched
    its own refusal) every subsequent H.265 frame streamed into a void —
    viewers saw the last raw frame frozen forever."""
    import asyncio
    import contextlib
    import json as _json

    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net import protocol as proto
    from asciichat_tpu.net.transport import Transport, serve_tcp
    from asciichat_tpu.utils import term

    async def run():
        state = _json.dumps({"clients": 1, "max_clients": 32, "streaming": 0,
                             "codecs": ["raw_rgb24", "h265"]}).encode()

        async def handler(t: Transport):
            # minimal plaintext session: accept anything, drive the script
            await t.recv()  # NO_ENCRYPTION or caps
            with contextlib.suppress(Exception):
                while True:
                    ptype, _ = await t.recv()
                    if ptype == pkt.PacketType.CLIENT_CAPABILITIES:
                        break
            await t.send(pkt.PacketType.SERVER_STATE, state)  # enables h265
            await asyncio.sleep(0.3)
            await t.send(pkt.PacketType.ERROR_MESSAGE,
                         proto.pack_error(proto.WireError.CODEC_UNAVAILABLE,
                                          "no decoder"))
            await asyncio.sleep(0.3)
            await t.send(pkt.PacketType.SERVER_STATE, state)  # re-broadcast
            await asyncio.sleep(1.0)

        srv = await serve_tcp(handler, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        c = AsciiChatClient("127.0.0.1", port, None, proto.WireCapabilities(),
                            reconnect=False, want_h265=True)
        c.display.writer = term.FrameWriter(open(os.devnull, "wb"))
        task = asyncio.create_task(c.run())
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10 and not c.h265_active:
            await asyncio.sleep(0.05)
        assert c.h265_active  # first SERVER_STATE enabled it
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10 and c.h265_active:
            await asyncio.sleep(0.05)
        assert not c.h265_active  # refusal flipped it off
        await asyncio.sleep(1.0)  # the re-broadcast lands in this window
        assert not c.h265_active and not c.want_h265  # LATCHED
        task.cancel()
        with contextlib.suppress(asyncio.CancelledError, Exception):
            await task
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_client_quit_unblocks_halfopen_recv():
    """'q' must end the session even with recv parked on a half-open link —
    setting the stop flag alone never unblocked it and the keepalive task
    exits on the flag before its dead-link close can fire."""
    import asyncio
    import contextlib

    from asciichat_tpu.apps.client import AsciiChatClient
    from asciichat_tpu.net import protocol as proto
    from asciichat_tpu.net.transport import Transport, serve_tcp
    from asciichat_tpu.utils import term

    async def run():
        async def handler(t: Transport):
            with contextlib.suppress(Exception):
                while True:
                    await t.recv()  # accept everything, answer NOTHING

        srv = await serve_tcp(handler, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        c = AsciiChatClient("127.0.0.1", port, None, proto.WireCapabilities(),
                            reconnect=False)
        c.display.writer = term.FrameWriter(open(os.devnull, "wb"))
        task = asyncio.create_task(c.run())
        await asyncio.sleep(1.0)  # connected, recv parked
        c._on_key("q")
        await asyncio.wait_for(task, 10)  # pre-fix: hangs forever
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 30))


def test_client_audio_out_alone_opens_sink(tmp_path, monkeypatch):
    """`client --audio-out file` without a capture source used to be
    silently inert (the sink never opened, received audio discarded)."""
    from asciichat_tpu.apps import client as client_mod
    from asciichat_tpu.apps import main as main_mod

    seen = {}

    class FakeClient:
        def __init__(self, *a, **kw):
            seen.update(kw)

        async def run(self, max_frames=None):
            return None

    monkeypatch.setattr(client_mod, "AsciiChatClient", FakeClient)
    out = tmp_path / "mix.f32"
    args = main_mod.build_parser().parse_args(
        ["client", "127.0.0.1", "--audio-out", str(out)])
    client_mod.main(args)
    assert seen.get("audio_sink") is not None
    assert seen.get("audio_source") is None  # still listen-only
    seen["audio_sink"].close()


# ---------------------------------------------------------------------------
# thirtieth sweep: discovery mode / ring consensus second pass


def test_ring_entry_signatures_bind_round_id():
    """A malicious leader could replay other members' previously-signed
    metric entries under a FRESH round_id (within envelope freshness) and
    get a forged election accepted; entries now sign the round id, and
    stale measured_at timestamps are rejected outright."""
    import dataclasses as _dc
    import time as _time

    from asciichat_tpu.apps.discovery import DiscoverySession, RingRunner
    from asciichat_tpu.net import consensus as cons

    sess = DiscoverySession("127.0.0.1", 1)
    sess.participant_id = "p-aaa"
    runner = RingRunner(sess)
    m = cons.ParticipantMetrics(participant_id="p-aaa", nat_tier=1,
                                upload_kbps=100, rtt_ms=5,
                                stun_success_pct=100, address="127.0.0.1",
                                port=5000,
                                measured_at_ms=int(_time.time() * 1000))
    sig = runner._sign_entry(m, 3)
    assert runner._verify_entry(m, sig, 3)
    assert not runner._verify_entry(m, sig, 4)  # round replay rejected
    stale = _dc.replace(
        m, measured_at_ms=int(_time.time() * 1000)
        - int((runner.ENTRY_MAX_AGE_S + 5) * 1000))
    sig_stale = runner._sign_entry(stale, 3)
    assert not runner._verify_entry(stale, sig_stale, 3)  # aged out
    future = _dc.replace(m, measured_at_ms=int(_time.time() * 1000) + 60_000)
    assert not runner._verify_entry(future, runner._sign_entry(future, 3), 3)


def test_elect_sticky_incumbent_wins_exact_ties():
    """Identical scores used to migrate the host to whichever entry the
    leader collected first — a gratuitous stream interruption one
    collection interval into every session. Exact ties keep the incumbent;
    a genuinely better challenger still wins."""
    from asciichat_tpu.net.consensus import (
        ParticipantMetrics, elect, elect_sticky,
    )

    def m(pid, rtt=20):
        return ParticipantMetrics(participant_id=pid, nat_tier=1,
                                  upload_kbps=1000, rtt_ms=rtt,
                                  stun_success_pct=100, address="h", port=1)

    tie = [m("p-zzz"), m("p-aaa")]  # identical scores, p-zzz collected first
    assert elect(tie)[0] == "p-zzz"  # reference first-wins
    assert elect_sticky(tie, "p-aaa") == ("p-aaa", "p-zzz")  # incumbent holds
    better = [m("p-zzz", rtt=1), m("p-aaa", rtt=500)]
    assert elect_sticky(better, "p-aaa")[0] == "p-zzz"  # real winner unseated
    assert elect_sticky(tie, None)[0] == "p-zzz"  # no incumbent: pure elect


def test_metrics_address_overflow_is_loud():
    """A >64-byte UTF-8 address silently truncated (possibly mid-codepoint:
    every ring message carrying the entry then failed to decode — permanent
    consensus outage) or round-tripped to a nonexistent host."""
    from asciichat_tpu.net.consensus import ParticipantMetrics

    m = ParticipantMetrics(participant_id="p", nat_tier=1, upload_kbps=1,
                           rtt_ms=1, stun_success_pct=1,
                           address="ü" * 40, port=1)  # 80 UTF-8 bytes
    with pytest.raises(ValueError, match="64-byte"):
        m.pack()


def test_discovery_leave_closes_transport_without_session():
    """connect()-then-failed-create used to leak the ACDS connection: leave
    skipped close() whenever session_string was unset."""
    import asyncio

    from asciichat_tpu.apps.discovery import DiscoverySession

    class FakeT:
        def __init__(self):
            self.closed = False

        async def send(self, *a):
            pass

        async def close(self):
            self.closed = True

    async def run():
        sess = DiscoverySession("127.0.0.1", 1)
        sess._t = FakeT()
        assert sess.session_string is None
        await sess.leave()
        assert sess._t.closed

    asyncio.run(asyncio.wait_for(run(), 10))


def test_discovery_join_buffers_pre_ack_broadcasts():
    """A PARTICIPANT_LIST (carrying peers' pubkeys) racing the SESSION_JOINED
    ack used to be silently eaten; it is now buffered for event_loop."""
    import asyncio
    import json as _json

    from asciichat_tpu.apps.discovery import DiscoverySession
    from asciichat_tpu.net import packet as pkt

    plist = _json.dumps({"participants": ["p-x"], "pubkeys": {}}).encode()
    joined = _json.dumps({"host_id": "p-x", "host_address": "1.2.3.4",
                          "host_port": 9}).encode()

    class FakeT:
        def __init__(self):
            self.script = [(int(pkt.PacketType.ACIP_PARTICIPANT_LIST), plist),
                           (int(pkt.PacketType.ACIP_SESSION_JOINED), joined)]

        async def send(self, *a):
            pass

        async def recv(self):
            return self.script.pop(0)

    async def run():
        sess = DiscoverySession("127.0.0.1", 1)
        sess._t = FakeT()
        host, port = await sess.join("swift-river-mountain")
        assert (host, port) == ("1.2.3.4", 9)
        assert len(sess._pre_ack) == 1
        assert sess._pre_ack[0][0] == int(pkt.PacketType.ACIP_PARTICIPANT_LIST)

    asyncio.run(asyncio.wait_for(run(), 10))


# ---------------------------------------------------------------------------
# thirty-first sweep: audio DSP pipeline / frame sources second pass


def test_prefetch_post_eof_read_is_immediate():
    """After the EOF sentinel is consumed, read() must answer at once — the
    blocking get charged every post-EOF read (reconnect loops) 200 ms of
    dead executor wait."""
    import time as _time

    from asciichat_tpu.runtime.framesource import PrefetchSource

    class OneFrame:
        width = height = 4
        fps = 30.0

        def __init__(self):
            self.n = 0

        def read(self):
            self.n += 1
            return np.zeros((4, 4, 3), np.uint8) if self.n == 1 else None

        def close(self):
            pass

    src = PrefetchSource(OneFrame())
    assert src.read() is not None
    assert src.read() is None  # the sentinel
    t0 = _time.monotonic()
    for _ in range(5):
        assert src.read() is None
    assert _time.monotonic() - t0 < 0.5  # pre-fix: ~1 s (5 x 0.2 s waits)
    src.close()


def test_prefetch_close_leaks_not_frees_stuck_native_reader():
    """A producer stuck in a NATIVE read has no process to kill: freeing the
    decoder context under it corrupted the heap — close() now leaks the
    context instead (and says so)."""
    import threading

    from asciichat_tpu.runtime.framesource import PrefetchSource

    release = threading.Event()
    closed = []

    class StuckNative:
        width = height = 4
        fps = 30.0
        _native_ctx = True

        def read(self):
            release.wait(30)  # simulates av_read_frame on a stalled stream
            return None

        def close(self):
            closed.append(True)

    src = PrefetchSource(StuckNative())
    src._thread.join(timeout=0.2)  # let the producer park
    t0 = time.monotonic()
    src.close()  # pre-fix: called inner.close() under the live reader
    assert time.monotonic() - t0 < 10
    assert not closed  # leaked deliberately, never freed in use
    release.set()


def test_far_reference_fifo_drops_oldest_and_bounds():
    """The far-end AEC reference keeps the MOST RECENT second (drop-oldest)
    and pops FIFO without rebuilding the backlog per call."""
    from asciichat_tpu.ops.audio import SAMPLE_RATE, ClientAudioPipeline

    p = ClientAudioPipeline()
    # 2 s of labeled far audio in 480-sample chunks
    for i in range(200):
        p.add_far(np.full(480, float(i), np.float32))
    assert p._far_len <= SAMPLE_RATE + 480  # bounded ~1 s
    head = p._take_far(480)
    assert head[0] >= 100.0  # the oldest second was dropped
    # FIFO continuity across chunk boundaries
    nxt = p._take_far(720)
    assert nxt[0] == head[0] + 1  # next chunk follows in order
    # underrun zero-pads after consuming the remainder
    drained = p._take_far(SAMPLE_RATE * 2)
    assert drained[-1] == 0.0 and p._far_len == 0


# ---------------------------------------------------------------------------
# thirty-second sweep: ACDS server second pass


def test_acds_registration_replay_and_pin_squatting_blocked():
    """Three binding-lifecycle holes: (1) a captured signed JOIN envelope
    replayed on another connection used to rebind the victim's delivery to
    the attacker's transport — the HELLO nonce now channel-binds it; (2) a
    FAILED join used to pin the attacker's key for an arbitrary id forever
    (identity squatting); (3) a stale connection's teardown used to destroy
    a reconnected client's fresh binding."""
    import asyncio
    import json as _json

    from asciichat_tpu.apps.acds import AcdsServer
    from asciichat_tpu.apps.discovery import DiscoverySession
    from asciichat_tpu.net import identity as ident
    from asciichat_tpu.net import packet as pkt
    from asciichat_tpu.net.transport import connect_tcp, serve_tcp

    async def hello(t):
        ptype, payload = await asyncio.wait_for(t.recv(), 5)
        assert ptype == pkt.PacketType.ACIP_ACDS_HELLO
        _pub, body = ident.open_envelope(int(ptype), payload)
        return _json.loads(body)["nonce"]

    async def run():
        acds = AcdsServer("127.0.0.1", 0)
        srv = await serve_tcp(acds._handle, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        creator = DiscoverySession("127.0.0.1", port, participant_id="host")
        await creator.connect()
        session = await creator.create(my_port=15001)

        # (1) REPLAY: a signed JOIN bound to conn A's nonce replayed on B
        victim = ident.Identity()
        a = await connect_tcp("127.0.0.1", port)
        nonce_a = await hello(a)
        join_body = _json.dumps({"participant_id": "vic",
                                 "session_string": session,
                                 "nonce": nonce_a}).encode()
        envelope = victim.sign(int(pkt.PacketType.ACIP_SESSION_JOIN), join_body)
        await a.send(pkt.PacketType.ACIP_SESSION_JOIN, envelope)
        ptype, _ = await asyncio.wait_for(a.recv(), 5)
        assert ptype == pkt.PacketType.ACIP_SESSION_JOINED
        vic_srv_t = acds.clients["vic"][0]  # server-side binding transport
        b = await connect_tcp("127.0.0.1", port)
        await hello(b)
        await b.send(pkt.PacketType.ACIP_SESSION_JOIN, envelope)  # replay
        while True:
            ptype, payload = await asyncio.wait_for(b.recv(), 5)
            if ptype == pkt.PacketType.ERROR_MESSAGE:
                break
            assert ptype != pkt.PacketType.ACIP_SESSION_JOINED
        assert b"replayed" in payload
        assert acds.clients["vic"][0] is vic_srv_t  # binding NOT rebound

        # (2) PIN SQUATTING: attacker fails a join under id 'squat'
        attacker = ident.Identity()
        c = await connect_tcp("127.0.0.1", port)
        nonce_c = await hello(c)
        bad = attacker.sign(int(pkt.PacketType.ACIP_SESSION_JOIN), _json.dumps(
            {"participant_id": "squat", "session_string": "no-such-one",
             "nonce": nonce_c}).encode())
        await c.send(pkt.PacketType.ACIP_SESSION_JOIN, bad)
        ptype, payload = await asyncio.wait_for(c.recv(), 5)
        assert ptype == pkt.PacketType.ERROR_MESSAGE
        assert acds.pins.get("squat") is None  # no pin for a failed join
        # the real 'squat' (different key) can still register
        real = DiscoverySession("127.0.0.1", port, participant_id="squat")
        await real.connect()
        await real.join(session)  # pre-fix: 'identity key mismatch'

        # (3) STALE UNBIND: rebind 'vic' on a new connection, then close the
        # OLD one — the fresh binding must survive
        d = await connect_tcp("127.0.0.1", port)
        nonce_d = await hello(d)
        rejoin = victim.sign(int(pkt.PacketType.ACIP_SESSION_JOIN), _json.dumps(
            {"participant_id": "vic", "session_string": session,
             "nonce": nonce_d}).encode())
        await d.send(pkt.PacketType.ACIP_SESSION_JOIN, rejoin)
        while True:
            ptype, _ = await asyncio.wait_for(d.recv(), 5)
            if ptype == pkt.PacketType.ACIP_SESSION_JOINED:
                break
        rebound_t = acds.clients["vic"][0]
        assert rebound_t is not vic_srv_t  # fresh server-side binding
        await a.close()  # the STALE connection dies
        await asyncio.sleep(0.3)
        assert acds.clients.get("vic", (None,))[0] is rebound_t  # intact
        info = acds.db.lookup(session)
        assert "vic" in info.participants  # still a member

        for t in (b, c, d):
            await t.close()
        await real.leave()
        await creator.leave()
        srv.close()

    asyncio.run(asyncio.wait_for(run(), 60))
