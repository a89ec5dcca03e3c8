"""The flagship "model": the server tick — N clients in, N personalized
ASCII-frame records + N audio mixes out, as ONE jitted step.

Replaces the reference server's 2-threads-per-client render fan-out
(src/server/render.c:340,765 + src/server/stream.c:958): per tick the device
executes composite-gather -> per-client color filter -> batched ASCII cell
render -> batched exclude-self audio mix, all fused by XLA. Multi-chip: the
client axis is sharded over the mesh (parallel/mesh.py); the composite gather
needs every client's frame, so XLA inserts an all-gather there, and
everything downstream stays client-local.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from asciichat_tpu.ops import audio as audio_ops
from asciichat_tpu.ops import cells, compositor, filters, pixel
from asciichat_tpu.render import palette as pal
from asciichat_tpu.render.pipeline import RenderPlan, plan_render
from asciichat_tpu.render.types import RenderMode, TerminalCapabilities


@dataclasses.dataclass(frozen=True)
class ServerTickPlan:
    """Static per-layout plan: recomputed on join/leave/resize, not per tick."""

    composite: compositor.CompositePlan
    render: RenderPlan
    num_clients: int
    audio_samples: int


def plan_tick(
    source_sizes: list[tuple[int, int]],
    term_w: int,
    term_h: int,
    caps: TerminalCapabilities,
    num_clients: int | None = None,
    audio_samples: int = audio_ops.AUDIO_FRAME_SAMPLES,
) -> ServerTickPlan:
    comp = compositor.plan_composite(source_sizes, term_w, term_h)
    # Server raises the height cap x2 for half-block clients (stream.c:831);
    # the convert driver then re-doubles into pixel rows (ascii.c:230).
    req_h = term_h * 2 if caps.render_mode == RenderMode.HALF_BLOCK else term_h
    render = plan_render(comp.width_px, comp.height_px, term_w, req_h, caps)
    # `is not None`, not truthiness: zero receivers with live sources is a
    # valid transient state and must not silently become len(source_sizes)
    n = num_clients if num_clients is not None else len(source_sizes)
    return ServerTickPlan(comp, render, n, audio_samples)


def render_compute(
    frames: jax.Array,  # uint8 [S, H, W, 3] latest frame per SOURCE
    ramp: jax.Array,
    tint: jax.Array,  # [C] per-RECEIVER filter params (C may differ from S)
    fg_on_bg: jax.Array,
    is_rainbow: jax.Array,
    filter_on: jax.Array,
    cidx: jax.Array,
    src_y: jax.Array,
    src_x: jax.Array,
    comp_mask: jax.Array,
    *,
    mode: str,
    dst_h: int,
    dst_w: int,
    resized_hook=None,
) -> cells.RecordDict:
    """Video half of the tick: composite gather -> per-receiver color filter
    -> batched ASCII cell render. The receiver count is tint.shape[0]; in the
    live server sources (clients streaming video) and receivers (clients
    watching) are different sets (src/server/stream.c renders per client from
    the shared source set)."""
    # 1. composite gather (needs all sources -> all-gather when sharded)
    gathered = frames[cidx, src_y, src_x]
    composite = jnp.where(comp_mask, gathered, jnp.zeros_like(gathered))
    # 2. per-receiver personalization: replicate + color filter (data, not branches)
    c = tint.shape[0]
    batch = jnp.broadcast_to(composite, (c, *composite.shape))
    batch = filters.apply_color_filter(batch, tint, fg_on_bg, is_rainbow, filter_on)
    # 3. batched ASCII cell render at the receivers' terminal geometry
    resized = pixel.resize_nn(batch, dst_h, dst_w)
    if resized_hook is not None:
        resized = resized_hook(resized)
    return cells.records_for_mode(resized, mode, ramp)


def tick_compute(
    frames: jax.Array,  # uint8 [C, H, W, 3] latest frame per client
    audio: jax.Array,  # float32 [C, N]
    active: jax.Array,  # bool [C]
    mixer_state: tuple,
    ramp: jax.Array,
    tint: jax.Array,
    fg_on_bg: jax.Array,
    is_rainbow: jax.Array,
    filter_on: jax.Array,
    cidx: jax.Array,
    src_y: jax.Array,
    src_x: jax.Array,
    comp_mask: jax.Array,
    *,
    mode: str,
    dst_h: int,
    dst_w: int,
    resized_hook=None,
):
    """The full tick as a pure jittable function — the single source of truth
    also traced by bench.py's server-tick benchmark and
    __graft_entry__.dryrun_multichip (resized_hook lets the dry run insert a
    sharding constraint on the per-client resized batch)."""
    records = render_compute(
        frames, ramp, tint, fg_on_bg, is_rainbow, filter_on,
        cidx, src_y, src_x, comp_mask,
        mode=mode, dst_h=dst_h, dst_w=dst_w, resized_hook=resized_hook,
    )
    # exclude-self audio mixes (mixer.c:636 semantics, O(1) per client)
    mixes, mixer_state = audio_ops.mixer_process(audio, active, mixer_state)
    return records, mixes, mixer_state


_tick_step = functools.partial(jax.jit, static_argnames=("mode", "dst_h", "dst_w"))(
    tick_compute
)

# Mesh-path AOT executables deduped across RenderGroups (see
# RenderGroup._compile_sharded). Bounded FIFO; entries are (compiled,
# collective_count).
_SHARDED_EXE_CACHE: dict[tuple, tuple] = {}
_SHARDED_EXE_CACHE_MAX = 32

_render_step = functools.partial(jax.jit, static_argnames=("mode", "dst_h", "dst_w"))(
    render_compute
)


class RenderGroup:
    """Live-server render group: the receivers sharing one (caps, size,
    palette) geometry, fed from the shared source stack by ONE jitted
    render_compute call per tick (the production use of the flagship model —
    src/server/stream.c:958 + render.c:340 render per client per thread; here
    the group IS the batch dimension).

    Rebuilt when the source layout or group geometry changes; jit graphs are
    cached by shape, so membership churn only re-traces when shapes change.

    With ``mesh`` set (parallel/mesh.py clients-axis mesh), the receiver batch
    is padded to a multiple of the mesh's client shards and the step is
    AOT-compiled once with a ``NamedSharding`` constraint on the per-receiver
    resized batch — each chip renders its shard of receivers, and the
    composite gather (which needs every source) gets an XLA all-gather.
    ``n_real`` receivers of the padded batch carry real output; the
    padding rows render the disabled-filter composite and are sliced off by
    the caller before emission. Output is value-exact vs the unsharded step
    (tests/test_server_model.py, __graft_entry__.dryrun_multichip).
    """

    def __init__(
        self,
        source_sizes: list[tuple[int, int]],
        term_w: int,
        term_h: int,
        caps: TerminalCapabilities,
        filter_names: list[str],
        palette: str = pal.DEFAULT_PALETTE,
        mesh=None,
    ):
        # ONE geometry source of truth: plan_tick owns the HALF_BLOCK
        # height-doubling rule (stream.c:831) — duplicating it here once
        # let the two copies drift
        plan = plan_tick(source_sizes, term_w, term_h, caps,
                         num_clients=len(filter_names))
        comp = plan.composite
        self.render = plan.render
        self.palette = palette
        self.mesh = mesh
        self.collectives = 0  # collective-op count in the compiled sharded step
        self._compiled = None  # AOT executable (mesh path only)
        self._compiled_c = 0  # padded receiver count it was built for
        if mesh is not None:
            from asciichat_tpu.parallel import mesh as meshlib

            self._n_shards = mesh.shape[meshlib.CLIENTS_AXIS]
            self._sh_cl = meshlib.client_sharding(mesh)
            # the resized batch [C, rows, W, 3] additionally shards its
            # cell-row axis over the space axis when the mesh is 2D
            # (clients×space — SURVEY §5's pixels×clients layout); on a 1D
            # mesh this helper degrades to the plain clients sharding
            self._sh_cl_sp = meshlib.client_space_sharding(mesh)
            self._sh_rep = meshlib.replicated(mesh)
            # constants ride replicated on the mesh (mixing committed
            # sharded params with default-device constants is a placement
            # error); placed straight from the plan's HOST arrays — going
            # through device_maps / ramp_for_palette would pay a
            # default-device upload plus a blocking D2H fetch per group build
            self.ramp = jax.device_put(
                pal.char_index_ramp_array(palette), self._sh_rep)
            self.cidx, self.src_y, self.src_x, self.comp_mask = (
                jax.device_put(a, self._sh_rep)
                for a in compositor.host_maps(comp))
        else:
            self.ramp = cells.ramp_for_palette(palette)
            # ONE source for the background-cell encoding + plan-cached uploads
            self.cidx, self.src_y, self.src_x, self.comp_mask = (
                compositor.device_maps(comp))
        self.filter_names: list[str] = []
        self.n_real = 0
        self.has_rainbow = False
        self.set_filters(filter_names)
        self.ticks = 0

    def set_filters(self, names: list[str], time_s: float = 0.0) -> None:
        """Per-receiver filter params are data: updating them never re-traces.
        Rainbow tints are time-dependent (color_filter.c:169) so rainbow
        groups refresh params every tick."""
        self.filter_names = list(names)
        self.n_real = len(names)
        self.has_rainbow = "rainbow" in names
        padded = list(names)
        if self.mesh is not None:
            # pad the receiver batch to the shard count ("none" filters render
            # the plain composite; rows >= n_real are dropped before emission)
            padded += ["none"] * (-len(names) % self._n_shards)
            if self._compiled is not None and len(padded) != self._compiled_c:
                # the AOT executable is shape-specialized to the padded
                # receiver count: serving it a different batch raises a
                # signature mismatch instead of recompiling
                self._compiled = None
        self._padded_names = padded
        tint, fg_on_bg, is_rainbow, enabled = filters.filter_params(padded, time_s)
        if self.mesh is not None:
            self.tint = jax.device_put(np.asarray(tint), self._sh_cl)
            self.fg_on_bg = jax.device_put(np.asarray(fg_on_bg), self._sh_cl)
            self.is_rainbow = jax.device_put(np.asarray(is_rainbow), self._sh_cl)
            self.filter_on = jax.device_put(np.asarray(enabled), self._sh_cl)
        else:
            self.tint = jnp.asarray(tint)
            self.fg_on_bg = jnp.asarray(fg_on_bg)
            self.is_rainbow = jnp.asarray(is_rainbow)
            self.filter_on = jnp.asarray(enabled)

    def _refresh_rainbow_tint(self, time_s: float) -> None:
        """Per-tick rainbow refresh: only `tint` depends on time
        (color_filter.c:169) — re-uploading all four param arrays per 60 Hz
        tick paid 3 needless sharded H2D dispatches."""
        tint, _, _, _ = filters.filter_params(self._padded_names, time_s)
        if self.mesh is not None:
            self.tint = jax.device_put(np.asarray(tint), self._sh_cl)
        else:
            self.tint = jnp.asarray(tint)

    def _step_args(self, frames):
        return (frames, self.ramp, self.tint, self.fg_on_bg, self.is_rainbow,
                self.filter_on, self.cidx, self.src_y, self.src_x, self.comp_mask)

    def _compile_sharded(self, frames: jax.Array):
        """AOT-compile the sharded step once (shapes are fixed per group) and
        record the collective-op count as wiring evidence (the inspector's
        mesh_collectives field; VERDICT r03 item 1).

        Executables are DEDUPED across RenderGroups through a bounded
        module-level cache keyed by (mesh, arg shapes/dtypes, mode,
        geometry): the compiled code is value-independent (the comp maps and
        filter params are runtime operands), so two groups with the same
        geometry — e.g. a churn client leaving and rejoining — share one
        executable instead of ratcheting the compile-cache footprint
        (VERDICT r04 #6)."""
        sh_cl = self._sh_cl_sp
        mesh_key = (tuple(d.id for d in self.mesh.devices.flat),
                    tuple(sorted(self.mesh.shape.items())))
        arg_key = tuple((tuple(a.shape), str(a.dtype))
                        for a in self._step_args(frames))
        key = (mesh_key, arg_key, self.render.mode,
               self.render.dst_h_px, self.render.dst_w)
        hit = _SHARDED_EXE_CACHE.get(key)
        if hit is not None:
            compiled, self.collectives = hit
            self._compiled_c = self.tint.shape[0]
            return compiled

        def fn(*args):
            return render_compute(
                *args, mode=self.render.mode, dst_h=self.render.dst_h_px,
                dst_w=self.render.dst_w,
                resized_hook=lambda r: jax.lax.with_sharding_constraint(r, sh_cl),
            )

        compiled = jax.jit(fn).lower(*self._step_args(frames)).compile()
        self.collectives = count_collectives(compiled.as_text())
        self._compiled_c = self.tint.shape[0]
        if len(_SHARDED_EXE_CACHE) >= _SHARDED_EXE_CACHE_MAX:
            # FIFO bound: geometry churn must not grow executables unboundedly
            _SHARDED_EXE_CACHE.pop(next(iter(_SHARDED_EXE_CACHE)))
        _SHARDED_EXE_CACHE[key] = (compiled, self.collectives)
        return compiled

    def step(self, frames: jax.Array, time_s: float = 0.0) -> cells.RecordDict:
        """frames uint8 [S, Hmax, Wmax, 3] -> records for the group's receivers.

        Mesh path: S must be a multiple of the client shards (the server pads
        the source stack) and frames must carry the clients-axis sharding."""
        if self.has_rainbow:
            self._refresh_rainbow_tint(time_s)
        if self.mesh is not None:
            if self._compiled is None:
                self._compiled = self._compile_sharded(frames)
            records = self._compiled(*self._step_args(frames))
        else:
            records = _render_step(
                *self._step_args(frames),
                mode=self.render.mode, dst_h=self.render.dst_h_px,
                dst_w=self.render.dst_w,
            )
        self.ticks += 1
        return records


def count_collectives(hlo: str) -> int:
    """Count INSTRUCTIONS whose opcode is a collective. A plain substring
    count also hit SSA result names, operand references, and both halves of
    async start/done pairs (overstating severalfold); and the shape token
    must be '.+?' not '\\S+' — async starts have TUPLE result shapes with
    spaces ('%ags = (u8[..], u8[..]) all-gather-start(') which \\S+ never
    matched, so on real multi-chip hardware (where every collective lowers
    async) the inspector's mesh_collectives read 0."""
    import re

    return len(re.findall(
        r"= .+? (?:all-gather|all-reduce|reduce-scatter"
        r"|collective-permute|all-to-all)(?:-start)?\(", hlo))


class ServerTick:
    """Stateful wrapper owning mixer state + static plan arrays."""

    def __init__(
        self,
        plan: ServerTickPlan,
        palette: str = pal.DEFAULT_PALETTE,
        client_filters: list[str] | None = None,
    ):
        self.plan = plan
        self.palette = palette
        self.ramp = cells.ramp_for_palette(palette)
        c = plan.num_clients
        # `is not None`, not truthiness: an EMPTY list is a valid zero-
        # receiver transient (the falsy-list coercion bug class plan_tick's
        # own comment pins)
        names = client_filters if client_filters is not None else ["none"] * c
        self._names = list(names)
        self.has_rainbow = "rainbow" in names
        tint, fg_on_bg, is_rainbow, enabled = filters.filter_params(names)
        self.tint = jnp.asarray(tint)
        self.fg_on_bg = jnp.asarray(fg_on_bg)
        self.is_rainbow = jnp.asarray(is_rainbow)
        self.filter_on = jnp.asarray(enabled)
        self.cidx, self.src_y, self.src_x, self.comp_mask = (
            compositor.device_maps(plan.composite))
        self.mixer_state = audio_ops.MixerState.init(c, c).astuple()

    @property
    def consts(self) -> tuple:
        """The static per-layout arrays, in tick_compute argument order."""
        return (self.ramp, self.tint, self.fg_on_bg, self.is_rainbow,
                self.filter_on, self.cidx, self.src_y, self.src_x, self.comp_mask)

    def step(self, frames, audio, active, time_s: float = 0.0):
        if self.has_rainbow:
            # only tint is time-dependent (color_filter.c:169 cycles hue
            # over 3.5 s); frozen at t=0, a rainbow receiver rendered the
            # same static red-ish tint forever through this wrapper
            tint, _, _, _ = filters.filter_params(self._names, time_s)
            self.tint = jnp.asarray(tint)
        records, mixes, self.mixer_state = _tick_step(
            frames,
            audio,
            active,
            self.mixer_state,
            self.ramp,
            self.tint,
            self.fg_on_bg,
            self.is_rainbow,
            self.filter_on,
            self.cidx,
            self.src_y,
            self.src_x,
            self.comp_mask,
            mode=self.plan.render.mode,
            dst_h=self.plan.render.dst_h_px,
            dst_w=self.plan.render.dst_w,
        )
        return records, mixes
