"""Persistent XLA compilation cache.

Every device entry point (the CLI, bench.py, chip_smoke.py, __graft_entry__)
calls `ensure()` once: compiled executables land in an on-disk cache keyed by
(HLO, compiler version, backend), so graphs any prior process compiled (the
server's per-geometry group steps, the bench loops) load instead of
recompiling. A jaxlib or driver upgrade changes the key and simply misses.

Where the cache lives:
- ``JAX_COMPILATION_CACHE_DIR`` set: JAX already reads it; nothing here
  touches it.
- otherwise: ``<checkout>/.jax_cache/<topology key>``, a fixed path inside
  the checkout (listed in .gitignore), so a cache written by one run of a
  checkout is found by the next.
"""

from __future__ import annotations

import os

CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def _topology_key() -> str:
    """Partition the cache by the execution topology knobs this repo
    actually varies. With one shared directory, an executable compiled
    under plain 1-device CPU (tools/soak_mixed.py) was replayed inside the
    test environment's 8-virtual-device CPU mesh and produced silently
    wrong results (an all-zeros audio mix) until the cache was cleared:
    the persistent-cache key does not cover everything these flags change,
    so the directory does."""
    import jax

    plats = str(jax.config.jax_platforms or "default").replace(",", "+")
    hostdev = "1"
    for part in os.environ.get("XLA_FLAGS", "").split():
        if "xla_force_host_platform_device_count=" in part:
            hostdev = part.rsplit("=", 1)[1]
    return f"{plats}-hd{hostdev}-{_machine_key()}"


def _machine_key() -> str:
    """Fingerprint of the HOST CPU features. XLA:CPU persists AOT results
    compiled for the build machine's exact feature set; replayed on a host
    of a different generation they load with a 'could lead to SIGILL'
    warning, so a checkout copied between hosts must not share them."""
    import hashlib
    import platform

    feat = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feat += line
                    break
    except OSError:
        pass
    return hashlib.sha256(feat.encode()).hexdigest()[:10]


_key_applied: str | None = None


def ensure() -> None:
    """Point JAX at the in-checkout cache dir for the CURRENT topology,
    unless ``JAX_COMPILATION_CACHE_DIR`` names one.

    Re-entrant with a topology re-check: entry() then dryrun_multichip(8)
    in ONE process changes platform + device count, and a once-latched
    directory would persist the 8-device executables into the 1-device
    partition — the poisoning the key exists to prevent."""
    global _key_applied
    if "PYTEST_CURRENT_TEST" in os.environ:
        # the CPU test suite stays out entirely: one test calling entry()
        # would otherwise enable the cross-run cache for the whole session,
        # making test results order- and disk-state-dependent
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    key = _topology_key()
    if key == _key_applied:
        return
    path = os.path.join(CACHE_ROOT, key)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # Cache almost everything: the server's per-geometry group steps
    # compile in ~0.1-0.4 s EACH on XLA:CPU, under JAX's 1 s default gate,
    # and a 9-client room compiles dozens of them. Disk I/O for a cache
    # hit is ~1 ms; only sub-10 ms throwaway graphs stay out.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.01)
    _key_applied = key
