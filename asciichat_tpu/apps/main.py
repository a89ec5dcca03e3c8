"""Unified CLI: one binary, subcommand modes (src/main.c:372-435 pattern).

    python -m asciichat_tpu.apps.main mirror --test-pattern
    python -m asciichat_tpu.apps.main server --port 27224
    python -m asciichat_tpu.apps.main client 127.0.0.1 --test-pattern
    python -m asciichat_tpu.apps.main bench
"""

from __future__ import annotations

import argparse
import os
import sys

from asciichat_tpu.render.types import RenderMode
from asciichat_tpu.utils import logsys
from asciichat_tpu.utils.errors import AsciiChatError
from asciichat_tpu.utils.options import Mode, apply_to_parser, default_registry


def _resolve_palette(name: str) -> str:
    from asciichat_tpu.render.palette import BUILTIN_PALETTES

    return BUILTIN_PALETTES.get(name, name)


def cmd_mirror(args) -> int:
    from asciichat_tpu.models.mirror import MirrorSession
    from asciichat_tpu.runtime.framesource import open_source
    from asciichat_tpu.utils import term

    caps = term.detect_capabilities(RenderMode(args.render_mode), args.color_mode)
    w, h = term.terminal_size(args.width, args.height)
    # offline rendering decodes flat out; live playback is PTS-paced
    source = open_source(test_pattern=args.test_pattern, file=args.file,
                         loop=args.loop, pace=not args.render_file,
                         stdin_size=args.stdin_size)
    if args.render_file:
        from asciichat_tpu.models.renderfile import render_to_file

        audio_source = None
        if args.tone_hz is not None or args.audio_wav:
            from asciichat_tpu.runtime.audiodev import open_audio_source

            audio_source = open_audio_source(tone_hz=args.tone_hz,
                                             wav=args.audio_wav)
        # Y4M headers and the audio frame math need an integer rate >= 1:
        # a legal fractional --fps (0 < fps <= 144) must not truncate to 0
        # (invalid F0:1 header + ZeroDivisionError in the audio mux)
        n = render_to_file(source, args.render_file, caps, w, h,
                           _resolve_palette(args.palette),
                           max_frames=args.max_frames or 300,
                           fps=max(1, round(args.fps)),
                           audio_source=audio_source)
        print(f"rendered {n} frames to {args.render_file}")
        return 0
    session = MirrorSession(
        source, caps, w, h, _resolve_palette(args.palette),
        fps_limit=args.fps, color_filter=args.color_filter,
        flip_x=args.flip_x, flip_y=args.flip_y, stretch=args.stretch, show_fps=args.show_fps,
        matrix=args.matrix,
    )
    if args.snapshot:
        session.run_snapshot()
        return 0
    session.run(max_frames=args.max_frames)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The per-mode argparse surfaces are GENERATED from the options
    registry (utils/options.default_registry — lib/options/builder/ analog),
    so CLI flags, TOML keys, help, and completions share one source of
    truth; tests assert the registry<->parser bijection per mode."""
    class _NoAbbrevParser(argparse.ArgumentParser):
        """allow_abbrev=False everywhere: prefix abbreviations ('--wid')
        would dodge the typed-flag detection in main() and let a TOML value
        override an option the user explicitly passed."""

        def __init__(self, *a, **kw):
            kw.setdefault("allow_abbrev", False)
            super().__init__(*a, **kw)

    def _lazy_main(modname: str):
        # server/client/acds/discovery drag jax + the full render stack —
        # importing them at parser-build time makes `--help`, `strings`,
        # `completions`, and `query` pay seconds of startup for nothing
        def run(a):
            import importlib

            return importlib.import_module(modname).main(a)

        return run

    ap = _NoAbbrevParser(prog="asciichat-tpu",
                         description="terminal video chat on an accelerator")
    sub = ap.add_subparsers(dest="mode", required=True,
                            parser_class=_NoAbbrevParser)
    reg = default_registry()

    m = sub.add_parser("mirror", help="local webcam->ASCII loop, no network")
    apply_to_parser(reg, m, Mode.MIRROR)
    m.set_defaults(fn=cmd_mirror)

    s = sub.add_parser("server", help="multi-client compositing server")
    apply_to_parser(reg, s, Mode.SERVER)
    s.set_defaults(fn=_lazy_main("asciichat_tpu.apps.server"))

    c = sub.add_parser("client", help="connect to a server")
    apply_to_parser(reg, c, Mode.CLIENT)
    c.set_defaults(fn=_lazy_main("asciichat_tpu.apps.client"))

    d = sub.add_parser("discovery-service", help="ACDS rendezvous server")
    apply_to_parser(reg, d, Mode.ACDS, default_overrides={"port": 27225})
    d.set_defaults(fn=_lazy_main("asciichat_tpu.apps.acds"))

    dc = sub.add_parser("discovery", help="P2P session via discovery service")
    apply_to_parser(reg, dc, Mode.DISCOVERY)

    dc.set_defaults(fn=_lazy_main("asciichat_tpu.apps.discovery"))

    def cmd_bench(a) -> int:
        # bench.py lives at the repo root (driver contract), not in the
        # package — load it by path so installed entry points work too
        import importlib.util
        import pathlib

        path = pathlib.Path(__file__).resolve().parents[2] / "bench.py"
        if not path.exists():
            print("bench.py not found (repo checkout required)", file=sys.stderr)
            return 1
        spec = importlib.util.spec_from_file_location("asciichat_bench", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main()

    b = sub.add_parser("bench", help="run the throughput benchmark")
    b.set_defaults(fn=cmd_bench)

    def cmd_strings(a) -> int:
        """Word-list helper (src/strings/main.c analog)."""
        from asciichat_tpu.net.discovery import (
            ADJECTIVES, NOUNS, generate_session_string, validate_session_string,
        )

        if a.validate:
            ok = validate_session_string(a.validate)
            print("valid" if ok else "invalid")
            return 0 if ok else 1
        if a.list_words:
            print("adjectives:", " ".join(ADJECTIVES))
            print("nouns:", " ".join(NOUNS))
            return 0
        for _ in range(a.count):
            print(generate_session_string())
        return 0

    st = sub.add_parser("strings", help="session word-string tool")
    st.add_argument("--count", type=int, default=1)
    st.add_argument("--validate", default=None)
    st.add_argument("--list-words", action="store_true")
    st.set_defaults(fn=cmd_strings, log_level="WARNING")

    def cmd_completions(a) -> int:
        from asciichat_tpu.utils.options import default_registry, generate_completions

        print(generate_completions(default_registry(), a.shell))
        return 0

    def cmd_query(a) -> int:
        """Attach-to-live-PID inspector (ascii-query-server analog)."""
        from asciichat_tpu.apps import query

        return query.main(a)

    q = sub.add_parser(
        "query", help="attach to a RUNNING asciichat pid: /proc state + "
                      "Python stacks (no --inspect-port needed)")
    q.add_argument("pid", type=int)
    q.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve the report over HTTP instead of one-shot")
    q.add_argument("--force", action="store_true",
                   help="signal SIGUSR1 even if the pid doesn't look like "
                        "an asciichat process")
    q.set_defaults(fn=cmd_query, log_level="WARNING")

    comp = sub.add_parser("completions", help="generate shell completions")
    comp.add_argument("shell", choices=["bash", "zsh", "fish", "pwsh"])
    comp.set_defaults(fn=cmd_completions, log_level="WARNING")

    def cmd_manpage(a) -> int:
        from asciichat_tpu.utils.options import default_registry, generate_manpage

        print(generate_manpage(default_registry()))
        return 0

    man = sub.add_parser("manpage", help="generate the troff man page")
    man.set_defaults(fn=cmd_manpage, log_level="WARNING")

    return ap


def main(argv=None) -> int:
    # Explicit device selection: ASCIICHAT_JAX_PLATFORM=cpu pins this
    # process's math to the host CPU. Clients spawned beside a server pin
    # the CPU so that only the server holds the card: a JAX process
    # reserves most of a GPU's memory when it first touches it.
    plat = os.environ.get("ASCIICHAT_JAX_PLATFORM")
    # ASCIICHAT_FORCE_MESH=N: multi-device serving on an N-device virtual CPU
    # pool (parallel/mesh.serving_mesh). The device-count flag must be in the
    # environment BEFORE the first backend touch; it implies the cpu platform
    # unless the user pinned one explicitly.
    force_mesh = os.environ.get("ASCIICHAT_FORCE_MESH", "")
    if force_mesh.isdigit() and int(force_mesh) > 1:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={force_mesh}"
            ).strip()
        plat = plat or "cpu"
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)

    # Persistent XLA compile cache (topology-partitioned). Without this the
    # server recompiles every RenderGroup geometry per PROCESS: the 9-client
    # soak measured a 2.6 GB RSS peak and a minutes-long warmup that were
    # pure LLVM compile arenas — executables any prior run already built
    # (VERDICT r04 #6). Must run after the platform/mesh flags above (the
    # cache directory is keyed by them) and before the first device touch.
    from asciichat_tpu.utils import jaxcache

    jaxcache.ensure()

    args = build_parser().parse_args(argv)

    # TOML config: file values fill in anything the CLI left at its default
    # (config layering, lib/options/config/config.c semantics)
    if getattr(args, "config", None):
        from asciichat_tpu.utils.options import OptionsStore, default_registry

        store = OptionsStore(default_registry())
        snap = store.load_toml(args.config, preset=getattr(args, "preset", None))
        # An option loses to the CLI only when the user actually typed it —
        # argparse defaults cannot distinguish "unset" for non-None defaults.
        typed = set()
        for tok in (argv if argv is not None else sys.argv[1:]):
            if tok.startswith("--"):
                typed.add(tok[2:].split("=", 1)[0])
        # apply ONLY keys the FILE set (store.last_toml_keys): iterating the
        # whole snapshot would push registry defaults over CLI positionals
        # (the client's address) and over per-mode argparse defaults (the
        # ACDS port). Values arrive already converted through each option's
        # cli_type — the snapshot is the same codec the CLI uses.
        vals = snap.as_dict()
        for key in store.last_toml_keys:
            attr = key.replace("-", "_")
            if not hasattr(args, attr) or key in typed or attr in typed:
                continue
            value = vals[key]
            if attr in ("width", "height") and value == 0:
                continue  # registry 0 means auto-detect
            setattr(args, attr, value)

    # SIGUSR1 -> all-thread stack dump, SIGUSR2 -> gc/memory report (the
    # reference's sync-state and leak-report signals, src/main.c:323-338).
    # SIGUSR1 goes through faulthandler into a well-known per-pid file
    # (utils/dumps.py): the dump is written at C signal level WITHOUT the
    # GIL, so `ascii-query` (apps/query.py) can pull Python stacks out of a
    # fully deadlocked process that was never started with --inspect-port.
    import signal

    from asciichat_tpu.utils.dumps import install_dump_handlers

    install_dump_handlers()

    def _dump_memory(*_):
        import gc
        import sys as _sys

        print(f"--- gc: counts={gc.get_count()} objects={len(gc.get_objects())} ---",
              file=_sys.stderr)

    try:
        signal.signal(signal.SIGUSR2, _dump_memory)
    except (ValueError, OSError, AttributeError):
        pass

    # panic reporter (src/tooling/panic analog): unhandled exceptions write a
    # report with traceback + thread stacks before the process dies
    def _panic_hook(exc_type, exc, tb):
        import tempfile
        import traceback

        if issubclass(exc_type, (KeyboardInterrupt, BrokenPipeError)):
            sys.__excepthook__(exc_type, exc, tb)
            return
        try:
            path = os.path.join(tempfile.gettempdir(),
                                f"asciichat-panic-{os.getpid()}.txt")
            with open(path, "w") as f:
                f.write("asciichat-tpu panic report\n\n")
                traceback.print_exception(exc_type, exc, tb, file=f)
                f.write("\n--- threads ---\n")
                import threading

                frames = sys._current_frames()
                for t in threading.enumerate():
                    f.write(f"\n{t.name}:\n")
                    fr = frames.get(t.ident)
                    if fr:
                        traceback.print_stack(fr, file=f)
            print(f"panic report written to {path}", file=sys.stderr)
        except Exception:
            pass
        sys.__excepthook__(exc_type, exc, tb)

    sys.excepthook = _panic_hook

    logsys.configure(
        level=getattr(args, "log_level", "INFO"),
        log_file=getattr(args, "log_file", None),
        grep=getattr(args, "grep", None),
        json_output=getattr(args, "log_json", False),
    )

    # Opt-in update check (update_checker.c + update_banner.c seat): a newer
    # release prints the banner to stderr before the mode starts so it never
    # corrupts a frame stream. Strictly --update-check only; all failures
    # silent (zero-egress environments must not notice).
    if getattr(args, "update_check", False):
        from asciichat_tpu.net.update_checker import UpdateChecker
        from asciichat_tpu.utils import ui

        latest = UpdateChecker().check()
        banner = ui.update_banner(ui.__version__, latest)
        if banner:
            print(banner.decode(), file=sys.stderr)

    try:
        return args.fn(args)
    except AsciiChatError as e:
        # expected operational failures (no frame from source, media open
        # errors) exit with a one-line message, not a panic report
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
