"""Batched audio DSP: N-source mixer with ducking/compression/soft-clip,
noise gate, one-pole filters, linear resampler.

Device re-expression of lib/audio/mixer.c. The reference mixes per-client on
dedicated 100 fps render threads, mutating one shared mixer under a rwlock
(mixer.c:491-839); here ONE jitted op produces the mixes for ALL clients per
tick: sources vectorize across vector lanes, time steps run as a lax.scan over
256-sample frames (MIXER_FRAME_SIZE, mixer.h:114) carrying the envelope /
ducking / compressor state. Per-client "exclude self" mixes (mixer.c:636) are
computed as (full weighted sum) - (own contribution) — O(1) per client instead
of the reference's O(C) re-mix loop.

Deliberate divergence from the reference: the C server shares one compressor
state across per-client render threads (call-order dependent); here each
client carries independent compressor state, which is deterministic and
batch-parallel. Envelope/ducking state is shared (per-source), as in C.

All constants match mixer.c: ducking threshold -45 dB / margin 6 dB /
atten -6 dB / attack 10 ms / release 200 ms (mixer.c:121-125); compressor
threshold -10 dB / ratio 4 / knee 2 / attack 10 ms / release 100 ms / makeup 0
(mixer.c:43-61); crowd gain 1/speakers^0.5, base gain 1.0 (mixer.c:328-329);
soft-clip threshold 0.7, steepness 3 (mixer.c:628, 1030-1041).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import math
import jax.numpy as jnp
import numpy as np

MIXER_FRAME_SIZE = 256  # mixer.h:114
SAMPLE_RATE = 48_000  # audio.h:85-91 (48 kHz mono)
AUDIO_FRAME_SAMPLES = 480  # 10 ms ticks


def db_to_linear(db):
    return jnp.power(10.0, db / 20.0)


def linear_to_db(linear):
    return 20.0 * jnp.log10(jnp.maximum(linear, 1e-12))


def _coeff(tau_s: float, sample_rate: float) -> float:
    """exp(-1/(tau*sr + eps)) (mixer.c:64-67, 130-133)."""
    return math.exp(-1.0 / (tau_s * sample_rate + 1e-12))


@dataclasses.dataclass(frozen=True)
class MixerParams:
    sample_rate: int = SAMPLE_RATE
    # ducking (mixer.c:121-125)
    duck_threshold_db: float = -45.0
    duck_margin_db: float = 6.0
    duck_atten_db: float = -6.0
    duck_attack_s: float = 0.010
    duck_release_s: float = 0.200
    # compressor (mixer.c:51, 54-61)
    comp_threshold_db: float = -10.0
    comp_ratio: float = 4.0
    comp_knee_db: float = 2.0
    comp_attack_s: float = 0.010
    comp_release_s: float = 0.100
    comp_makeup_db: float = 0.0
    # bus (mixer.c:328-329)
    crowd_alpha: float = 0.5
    base_gain: float = 1.0
    # soft clip (mixer.c:628)
    clip_threshold: float = 0.7
    clip_steepness: float = 3.0

    @property
    def duck_attack_coeff(self) -> float:
        return _coeff(self.duck_attack_s, self.sample_rate)

    @property
    def duck_release_coeff(self) -> float:
        return _coeff(self.duck_release_s, self.sample_rate)

    @property
    def comp_attack_coeff(self) -> float:
        return _coeff(self.comp_attack_s, self.sample_rate)

    @property
    def comp_release_coeff(self) -> float:
        return _coeff(self.comp_release_s, self.sample_rate)


@dataclasses.dataclass
class MixerState:
    """Carried across ticks. S sources, C output channels (clients)."""

    envelope: jax.Array  # [S] ducking envelope per source
    duck_gain: jax.Array  # [S]
    comp_envelope: jax.Array  # [C]
    comp_gain: jax.Array  # [C]

    @staticmethod
    def init(num_sources: int, num_clients: int) -> "MixerState":
        return MixerState(
            envelope=jnp.zeros((num_sources,), jnp.float32),
            duck_gain=jnp.ones((num_sources,), jnp.float32),
            comp_envelope=jnp.zeros((num_clients,), jnp.float32),
            comp_gain=jnp.ones((num_clients,), jnp.float32),
        )

    def astuple(self):
        return (self.envelope, self.duck_gain, self.comp_envelope, self.comp_gain)


def soft_clip(x, threshold: float, steepness: float):
    """tanh knee above +-threshold (mixer.c:1030-1041).

    KNOWN PARITY DEFECT (deliberate): the negative branch's
    (-1.0 + threshold) coefficient is a sign error faithfully reproduced
    from the reference's soft_clip — it makes the curve NON-MONOTONIC for
    deep negative samples (f(-1.0) folds back toward -threshold). The
    symmetric form would be lo = -t + (1-t)*tanh((x+t)*s). Byte-parity of
    the mixed audio with the reference server is the project contract
    (tests/test_audio.py validates against this exact formula), so the
    defect ships; flip BOTH this line and the test's reference
    implementation if parity with a fixed upstream is ever wanted."""
    hi = threshold + (1.0 - threshold) * jnp.tanh((x - threshold) * steepness)
    lo = -threshold + (-1.0 + threshold) * jnp.tanh((x + threshold) * steepness)
    return jnp.where(x > threshold, hi, jnp.where(x < -threshold, lo, x))


def _compressor_gain_reduction_db(p: MixerParams, level_db):
    """Soft-knee downward compression curve (mixer.c:70-86)."""
    over = level_db - p.comp_threshold_db
    knee = p.comp_knee_db
    slope = 1.0 / p.comp_ratio - 1.0
    x = over + knee * 0.5
    soft = slope * (x * x) / (2.0 * knee)
    return jnp.where(over <= -knee * 0.5, 0.0, jnp.where(over >= knee * 0.5, slope * over, soft))


def _attack_release(value, target, attack_coeff, release_coeff):
    """ENVELOPE smoothing: attack when the level RISES (mixer.c:92-95)."""
    coeff = jnp.where(target > value, attack_coeff, release_coeff)
    return coeff * value + (1.0 - coeff) * target


def _gain_smooth(value, target, attack_coeff, release_coeff):
    """GAIN smoothing: attack when the gain FALLS — reduction engages fast,
    recovery is slow (mixer.c:102-106 compressor, :209-214 ducking)."""
    coeff = jnp.where(target < value, attack_coeff, release_coeff)
    return coeff * value + (1.0 - coeff) * target


@functools.partial(jax.jit, static_argnames=("params", "exclude_self"))
def mixer_process(
    samples: jax.Array,  # float32 [S, N] source audio for this tick
    active: jax.Array,  # bool [S] sources that delivered audio
    state: tuple,  # MixerState.astuple()
    params: MixerParams = MixerParams(),
    exclude_self: bool = True,
) -> tuple[jax.Array, tuple]:
    """One mixer tick -> per-client mixes [C, N] and updated state.

    With exclude_self=True, C == S and output[c] omits source c
    (mixer_process_excluding_source, mixer.c:636). With False, C == 1 and
    output[0] is the full mix (mixer_process, mixer.c:491).
    """
    s_count, n = samples.shape
    p = params
    pad = (-n) % MIXER_FRAME_SIZE
    padded = jnp.pad(samples, ((0, 0), (0, pad)))
    chunks = padded.reshape(s_count, -1, MIXER_FRAME_SIZE).transpose(1, 0, 2)  # [F, S, frame]
    activef = active.astype(jnp.float32)

    def step(carry, chunk):  # chunk [S, frame]
        env, duck_gain, comp_env, comp_gain = carry
        chunk = chunk * activef[:, None]  # inactive sources contribute silence

        # Frame-peak envelope per source; only active sources update (mixer.c:557-580)
        peak = jnp.max(jnp.abs(chunk), axis=1)
        new_env = _attack_release(env, peak, p.duck_attack_coeff, p.duck_release_coeff)
        env = jnp.where(active, new_env, env)

        speaking = jnp.logical_and(active, env > db_to_linear(-60.0))
        speaking_count = jnp.sum(speaking.astype(jnp.float32))

        # Ducking over all slots (ducking_process_frame, mixer.c:185-216)
        env_db = linear_to_db(env)
        max_db = jnp.max(env_db)
        is_speaking = env_db > p.duck_threshold_db
        is_leader = jnp.logical_and(is_speaking, env_db >= max_db - p.duck_margin_db)
        target = jnp.where(jnp.logical_and(is_speaking, ~is_leader), db_to_linear(p.duck_atten_db), 1.0)
        duck_gain = _gain_smooth(duck_gain, target, p.duck_attack_coeff, p.duck_release_coeff)

        # Pre-crowd weighting (duck * active only); crowd/base applied per
        # LISTENER below so the exclude-self path counts speakers the way
        # the reference does.
        weighted0 = chunk * (duck_gain * activef)[:, None]  # [S, frame]
        full0 = jnp.sum(weighted0, axis=0)  # [frame]
        if exclude_self:
            # mixer_process_excluding_source masks the LISTENER out of the
            # active set BEFORE counting speakers (mixer.c:663-665,780-787):
            # listener c's crowd gain is 1/count(speakers != c)^alpha, not
            # the full-mix 1/count^alpha — the old global factor made every
            # speaker hear the others sqrt((k-1)/k) quieter than the C
            # server. (Remaining documented divergence: ducking leadership
            # is computed over ALL sources once per tick, where the
            # reference recomputes it per exclude call over each masked
            # subset, mutating shared envelopes C times per tick.)
            count_excl = speaking_count - speaking.astype(jnp.float32)  # [S]
            crowd = jnp.where(
                count_excl > 0,
                1.0 / jnp.power(jnp.maximum(count_excl, 1.0), p.crowd_alpha),
                1.0)
            mixes = (full0[None, :] - weighted0) * (p.base_gain * crowd)[:, None]
        else:
            crowd = jnp.where(
                speaking_count > 0,
                1.0 / jnp.power(jnp.maximum(speaking_count, 1.0), p.crowd_alpha),
                1.0)
            mixes = full0[None, :] * (p.base_gain * crowd)

        # Per-client frame-peak compression (mixer.c:608-628)
        frame_peak = jnp.max(jnp.abs(mixes), axis=1)  # [C]
        comp_env = _attack_release(comp_env, frame_peak, p.comp_attack_coeff, p.comp_release_coeff)
        gr_db = _compressor_gain_reduction_db(p, linear_to_db(comp_env))
        target_lin = db_to_linear(gr_db + p.comp_makeup_db)
        comp_gain = _gain_smooth(comp_gain, target_lin, p.comp_attack_coeff, p.comp_release_coeff)

        out = soft_clip(mixes * comp_gain[:, None], p.clip_threshold, p.clip_steepness)
        return (env, duck_gain, comp_env, comp_gain), out

    new_state, outs = jax.lax.scan(step, state, chunks)
    out = outs.transpose(1, 0, 2).reshape(outs.shape[1], -1)[:, :n]
    # active_count == 0: the C mixer returns silence WITHOUT touching state
    # (mixer.c:509-512) — advancing it here would let compressor/duck gains
    # recover during a silent stretch, so the first ~100 ms after speech
    # resumes would diverge from the reference's frozen-gain trajectory
    any_active = jnp.any(active)
    out = jnp.where(any_active, out, 0.0)
    new_state = jax.tree_util.tree_map(
        lambda new, old: jnp.where(any_active, new, old), new_state, state)
    return out, new_state


# ---------------------------------------------------------------------------
# Noise gate (mixer.c:846-924): per-buffer peak, hysteresis, one-pole envelope.


@functools.partial(jax.jit, static_argnames=("threshold", "attack_s", "release_s", "hysteresis", "sample_rate"))
def noise_gate(
    buf: jax.Array,  # [..., N]
    envelope: jax.Array,  # [...] carried
    gate_open: jax.Array,  # bool [...]
    threshold: float = 0.01,
    attack_s: float = 0.010,
    release_s: float = 0.050,
    hysteresis: float = 0.9,
    sample_rate: int = SAMPLE_RATE,
):
    attack_c = 1.0 - math.exp(-1.0 / (attack_s * sample_rate + 1e-12))
    release_c = 1.0 - math.exp(-1.0 / (release_s * sample_rate + 1e-12))
    peak = jnp.max(jnp.abs(buf), axis=-1)

    def sample_step(carry, x):
        env, is_open = carry
        thr = jnp.where(is_open, threshold * hysteresis, threshold)
        target = (peak > thr).astype(jnp.float32)
        is_open = target > 0.5
        coeff = jnp.where(target > env, attack_c, release_c)
        env = env + coeff * (target - env)
        return (env, is_open), x * env

    (envelope, gate_open), out = jax.lax.scan(
        sample_step, (envelope, gate_open), jnp.moveaxis(buf, -1, 0)
    )
    return jnp.moveaxis(out, 0, -1), envelope, gate_open


# ---------------------------------------------------------------------------
# One-pole filters (mixer.c:931-1023) as scans (sequential IIR -> lax.scan).


@jax.jit
def highpass(buf: jax.Array, prev_in: jax.Array, prev_out: jax.Array, alpha: float):
    """y[n] = alpha * (y[n-1] + x[n] - x[n-1]) (mixer.c:953-965)."""

    def step(carry, x):
        pin, pout = carry
        y = alpha * (pout + x - pin)
        return (x, y), y

    (prev_in, prev_out), out = jax.lax.scan(step, (prev_in, prev_out), jnp.moveaxis(buf, -1, 0))
    return jnp.moveaxis(out, 0, -1), prev_in, prev_out


@jax.jit
def lowpass(buf: jax.Array, prev_out: jax.Array, alpha: float):
    """y[n] = alpha*x[n] + (1-alpha)*y[n-1] (mixer.c:1004-1013)."""

    def step(pout, x):
        y = alpha * x + (1.0 - alpha) * pout
        return y, y

    prev_out, out = jax.lax.scan(step, prev_out, jnp.moveaxis(buf, -1, 0))
    return jnp.moveaxis(out, 0, -1), prev_out


def highpass_alpha(cutoff_hz: float, sample_rate: float = SAMPLE_RATE) -> float:
    return 1.0 / (1.0 + 2.0 * math.pi * cutoff_hz / sample_rate)


def lowpass_alpha(cutoff_hz: float, sample_rate: float = SAMPLE_RATE) -> float:
    dt = 1.0 / sample_rate
    rc = 1.0 / (2.0 * math.pi * cutoff_hz)
    return dt / (rc + dt)


# ---------------------------------------------------------------------------
# Linear resampler (resample_linear, lib/audio/audio.c:578): batched gather.


@functools.partial(jax.jit, static_argnames=("out_len",))
def resample_linear(buf: jax.Array, out_len: int) -> jax.Array:
    """[..., N] -> [..., out_len] linear interpolation.

    Position mapping matches the C resampler: stride = src/dst sample-count
    ratio (audio.c:586 `ratio = src_rate / dst_rate`, positions `i * ratio`
    with end-clamp) — NOT endpoint-matched (n-1)/(out_len-1), which samples
    different interior source positions than the reference."""
    n = buf.shape[-1]
    ratio = n / max(out_len, 1)
    pos = jnp.arange(out_len, dtype=jnp.float32) * ratio
    i0 = jnp.clip(pos.astype(jnp.int32), 0, n - 1)
    i1 = jnp.clip(i0 + 1, 0, n - 1)
    frac = pos - i0.astype(jnp.float32)
    return jnp.take(buf, i0, axis=-1) * (1.0 - frac) + jnp.take(buf, i1, axis=-1) * frac


# ---------------------------------------------------------------------------
# Audio analysis (lib/audio/analysis.c): RMS / peak / dBFS levels, batched.


@jax.jit
def analyze_levels(buf: jax.Array) -> dict[str, jax.Array]:
    """[..., N] -> {'rms', 'peak', 'rms_db', 'peak_db'} per leading batch dims."""
    rms = jnp.sqrt(jnp.mean(buf * buf, axis=-1))
    peak = jnp.max(jnp.abs(buf), axis=-1)
    return {
        "rms": rms,
        "peak": peak,
        "rms_db": linear_to_db(rms),
        "peak_db": linear_to_db(peak),
    }


# ---------------------------------------------------------------------------
# Acoustic echo cancellation (the reference integrates WebRTC AEC3 via
# lib/audio/client_pipeline.cpp). Device seat: a per-sample NLMS adaptive
# filter — the far-end (speaker) signal is filtered by an adaptive estimate
# of the echo path and subtracted from the near-end (mic) capture; weights
# update inside a lax.scan — protected by the two AEC3-role controls that
# keep NLMS stable in conversation:
#
# - Geigel double-talk detection (per sample): near-end speech is declared
#   when |mic| > geigel_t * max(|far| over the filter window). While
#   declared (plus a hangover tail covering speech decay), ADAPTATION
#   FREEZES — the filter keeps cancelling with its converged weights but
#   stops learning, so simultaneous near+far speech cannot drag the echo
#   model toward cancelling the near-end talker.
# - Divergence control (per frame, in EchoCanceller.process): if the
#   residual energy exceeds the mic energy the filter is ADDING energy
#   (diverged — e.g. an echo-path change while frozen); weights are halved,
#   which bounds output energy while preserving the echo-path shape for
#   fast re-convergence.


@functools.partial(jax.jit, static_argnames=("taps", "mu", "hangover"))
def echo_cancel(
    mic: jax.Array,  # [N] near-end capture (speech + echo)
    far: jax.Array,  # [N] far-end reference (what the speaker played)
    weights: jax.Array,  # [taps] carried filter state
    far_tail: jax.Array,  # [taps] last far-end samples from the previous tick
    hang: jax.Array,  # [] carried double-talk hangover counter (samples)
    taps: int = 256,
    mu: float = 0.5,
    geigel_t: float = 0.5,
    hangover: int = 1440,  # 30 ms at 48 kHz: covers near-speech decay tails
):
    """-> (echo-cancelled mic [N], weights, far_tail, hang, dt_frac).
    NLMS w += mu * e * x / (||x||^2 + eps) with Geigel adaptation freeze;
    dt_frac is the fraction of samples with adaptation frozen (telemetry).
    Both dot products ask for ``Precision.HIGHEST``: on a GPU a float32
    product may otherwise run in TF32 (~3 decimal digits), which the
    per-sample weight recursion would accumulate."""
    far_hist = jnp.concatenate([far_tail, far])  # [taps + N]

    def step(carry, idx):
        w, hang = carry
        # window ENDS at the current far sample (far_hist[idx+taps] == far[idx])
        # so the filter models echo delays 0..taps-1 — a zero-latency speaker
        # path (loopback tests, software mixers) must be cancellable too
        x = jax.lax.dynamic_slice(far_hist, (idx + 1,), (taps,))
        y = jnp.dot(w, x, precision=jax.lax.Precision.HIGHEST)
        e = mic[idx] - y
        # Geigel: |mic| vs the loudest far sample the echo could stem from
        # (assumes the acoustic path attenuates by >= 1/geigel_t, i.e. 6 dB
        # at the 0.5 default — the classical tuning)
        dt = jnp.abs(mic[idx]) > geigel_t * jnp.max(jnp.abs(x))
        hang = jnp.where(dt, jnp.int32(hangover), jnp.maximum(hang - 1, 0))
        adapt = (hang == 0).astype(jnp.float32)
        norm = jnp.dot(x, x, precision=jax.lax.Precision.HIGHEST) + 1e-6
        w = w + (adapt * mu) * e * x / norm
        return (w, hang), (e, 1.0 - adapt)

    (weights, hang), (out, frozen) = jax.lax.scan(
        step, (weights, hang), jnp.arange(mic.shape[0]))
    # telemetry scalars ride ONE stacked array so the host side pays a single
    # fetch per tick (CLAUDE.md: never per-scalar round-trips in interactive
    # paths): [double-talk fraction, residual energy, mic energy]
    stats = jnp.stack([jnp.mean(frozen), jnp.sum(out * out),
                       jnp.sum(mic * mic)])
    return out, weights, far_hist[-taps:], hang, stats


class EchoCanceller:
    """Stateful wrapper for per-tick echo cancellation (client pipeline):
    NLMS + Geigel double-talk freeze (in the scan) + frame-level divergence
    control (here)."""

    def __init__(self, taps: int = 256, mu: float = 0.5,
                 geigel_t: float = 0.5, hangover: int = 1440):
        self.taps = taps
        self.mu = mu
        self.geigel_t = geigel_t
        self.hangover = hangover
        self.weights = jnp.zeros((taps,), jnp.float32)
        self.far_tail = jnp.zeros((taps,), jnp.float32)
        self.hang = jnp.zeros((), jnp.int32)
        self.double_talk_frac = 0.0  # last frame's frozen-sample fraction
        self.divergence_resets = 0

    def process(self, mic, far):
        mic = jnp.asarray(mic, jnp.float32)
        out, self.weights, self.far_tail, self.hang, stats = echo_cancel(
            mic, jnp.asarray(far, jnp.float32),
            self.weights, self.far_tail, self.hang,
            taps=self.taps, mu=self.mu, geigel_t=self.geigel_t,
            hangover=self.hangover,
        )
        # one host fetch for all per-tick telemetry (the energies are
        # computed inside the jitted graph, not as separate dispatches)
        dt_frac, out_e, mic_e = np.asarray(stats)
        self.double_talk_frac = float(dt_frac)
        self.apply_divergence_control(float(out_e), float(mic_e))
        return out

    def apply_divergence_control(self, out_e: float, mic_e: float) -> None:
        """Divergence control, the ONE copy (the fused client pipeline
        calls it too — a duplicated threshold drifted silently otherwise):
        a healthy canceller REMOVES energy; a residual carrying well above
        the mic means the echo model is wrong (path changed / froze
        mid-adaptation) — pull the weights back."""
        if out_e > 2.0 * mic_e + 1e-9:
            self.weights = self.weights * 0.5
            self.divergence_resets += 1


# ---------------------------------------------------------------------------
# Client capture pipeline (lib/audio/client_pipeline.cpp analog): the chain a
# captured mic frame runs before leaving the client — echo cancellation
# against the far-end playback reference, DC-removal highpass, noise gate —
# with all carried DSP state threaded across 10 ms frames.


@functools.partial(jax.jit, static_argnames=(
    "use_aec", "taps", "mu", "geigel_t", "hangover", "gate_threshold"))
def _client_pipeline_step(mic, far, weights, far_tail, hang,
                          hp_in, hp_out, gate_env, gate_open, hp_alpha,
                          *, use_aec, taps, mu, geigel_t, hangover,
                          gate_threshold):
    """The full capture chain (AEC -> highpass -> gate) as ONE compiled
    graph: dispatched separately, each 10 ms frame paid three dispatches
    and two host-device syncs (the AEC stats fetch landed mid-chain) —
    roughly double the per-frame host overhead on a 1-core box."""
    if use_aec:
        x, weights, far_tail, hang, stats = echo_cancel(
            mic, far, weights, far_tail, hang,
            taps=taps, mu=mu, geigel_t=geigel_t, hangover=hangover)
    else:
        x = mic
        stats = jnp.zeros((3,), jnp.float32)
    x, hp_in, hp_out = highpass(x, hp_in, hp_out, hp_alpha)
    x, gate_env, gate_open = noise_gate(x, gate_env, gate_open,
                                        threshold=gate_threshold)
    return x, weights, far_tail, hang, hp_in, hp_out, gate_env, gate_open, stats


class ClientAudioPipeline:
    """Stateful per-client capture chain (src/client/audio.c:276 capture path).

    AEC runs first (the echo estimate must see the raw mic), then the
    highpass, then the gate — matching the reference pipeline ordering
    (client_pipeline.cpp: AEC3 -> filters -> gate)."""

    def __init__(self, use_aec: bool = True, gate_threshold: float = 0.01,
                 highpass_hz: float = 100.0):
        self.aec = EchoCanceller() if use_aec else None
        self.gate_threshold = gate_threshold
        self.hp_alpha = highpass_alpha(highpass_hz)  # (mixer.c:953)
        self.hp_in = jnp.zeros((), jnp.float32)
        self.hp_out = jnp.zeros((), jnp.float32)
        self.gate_env = jnp.zeros((), jnp.float32)
        self.gate_open = jnp.zeros((), bool)
        # chunked FIFO: np.concatenate rebuilt the ENTIRE retained backlog
        # (up to 192 KB) on every 10 ms add_far — pure memmove on the
        # event-loop thread. Whole chunks in a deque keep appends O(1) and
        # the 1 s bound drop-OLDEST (the far reference must stay aligned to
        # the most recent playback).
        import collections as _collections
        import threading as _threading

        self._far_chunks: _collections.deque = _collections.deque()
        self._far_len = 0
        # add_far runs on the receive (event-loop) thread while process runs
        # in the capture executor: unguarded, the consume's two reads race
        # the append and duplicate far-end samples (AEC misalignment)
        self._far_lock = _threading.Lock()

    def add_far(self, buf: np.ndarray) -> None:
        """Feed received playback audio as the AEC far-end reference; bounded
        to 1 s so a stalled playback path cannot grow it without limit."""
        chunk = np.asarray(buf, np.float32).ravel()
        if not len(chunk):
            return
        with self._far_lock:
            self._far_chunks.append(chunk)
            self._far_len += len(chunk)
            while (self._far_chunks
                   and self._far_len - len(self._far_chunks[0]) >= SAMPLE_RATE):
                self._far_len -= len(self._far_chunks.popleft())

    def _take_far(self, n: int) -> np.ndarray:
        """Pop n far-end samples FIFO (zero-padded on underrun — consuming
        what exists keeps the reference causally aligned; see process)."""
        out = np.zeros(n, np.float32)
        at = 0
        with self._far_lock:
            while at < n and self._far_chunks:
                head = self._far_chunks[0]
                take = min(n - at, len(head))
                out[at: at + take] = head[:take]
                at += take
                if take == len(head):
                    self._far_chunks.popleft()
                else:
                    self._far_chunks[0] = head[take:]
                self._far_len -= take
        return out

    def process(self, mic: np.ndarray) -> np.ndarray:
        n = len(mic)
        x = jnp.asarray(mic, jnp.float32)
        aec = self.aec
        if aec is not None:
            # underruns zero-pad AFTER consuming what exists: padding
            # without consuming would permanently shift the far reference
            # one frame behind the mic (a negative filter delay the causal
            # tap window can never represent)
            far = self._take_far(n)
            w, ft, hg = aec.weights, aec.far_tail, aec.hang
            taps, mu, gg, ho = aec.taps, aec.mu, aec.geigel_t, aec.hangover
        else:
            far = np.zeros(0, np.float32)
            w = ft = jnp.zeros((0,), jnp.float32)
            hg = jnp.zeros((), jnp.int32)
            taps, mu, gg, ho = 1, 0.0, 0.0, 0
        (x, w, ft, hg, self.hp_in, self.hp_out, self.gate_env,
         self.gate_open, stats) = _client_pipeline_step(
            x, jnp.asarray(far, jnp.float32), w, ft, hg,
            self.hp_in, self.hp_out, self.gate_env, self.gate_open,
            self.hp_alpha,
            use_aec=aec is not None, taps=taps, mu=mu, geigel_t=gg,
            hangover=ho, gate_threshold=self.gate_threshold)
        out = np.asarray(x, np.float32)  # the single sync point per frame
        if aec is not None:
            aec.weights, aec.far_tail, aec.hang = w, ft, hg
            dt_frac, out_e, mic_e = np.asarray(stats)  # already computed
            aec.double_talk_frac = float(dt_frac)
            aec.apply_divergence_control(float(out_e), float(mic_e))
        return out
