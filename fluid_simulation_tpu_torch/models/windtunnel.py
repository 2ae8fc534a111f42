"""The wind-tunnel model (``fluid_simulation_tpu/models/windtunnel.py``).

Time-step composition mirrors ``Simulation::run`` + ``Simulation::step``
(simulation.cpp:49-150):

  per step (run loop, :63-71):  inlet density += 0.001 on the x=1 plane;
                                buffer = dens;            then step():
  step (:96-150):               inlet velocity (speed,0,0) on the x=1 plane;
                                v_prev = v  (pre-diffusion save, :107-110);
                                diffuse vx,vy,vz; project;
                                advect vx,vy,vz from v_prev; project again;
                                density advect from buffer.

The density diffusion of the reference is dead (advection rewrites every
cell from the pre-diffusion ``buffer``), so it is not computed.

Devices. ``WindTunnel`` and ``init_state`` put the state on the card unless
the caller asks for ``device="cpu"``. This module makes every choice of
kernel or plain torch in the step; ``ops/`` is plain torch only. With
``use_pallas`` the solves, projections, split advection, padding,
vorticity confinement and the step's statistics go through the
hand-written kernels' wrappers (``kernels/``), in empty and obstacle
scenes; each wrapper launches on a CUDA tensor and runs its plain version
on the CPU. With rbgs, big grids stream their solves and projections
(``_solve_route``); on the card every ``ops.advect.advect`` call, compat's
four and fast's density, runs whole in one kernel
(``kernels/advect_compat.py::advect_compat``), and fast's shared velocity
backtrace and its three samples in another
(``kernels/advect_fast.py::advect_fast``), whatever the window; split
ignores the window, as in the JAX package. A configuration whose
kernels are not ported yet raises ``NotImplementedError`` instead of
running plain torch. With ``use_pallas=False`` the step is plain torch on
any device.

The step is pure: it returns new tensors and leaves its inputs unchanged
(the pre-diffusion save ``pvx`` and the post-inlet ``buffer`` are read again
after the solves, so no stage may write into its inputs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fluid_simulation_tpu_torch.config import SimParams
from fluid_simulation_tpu_torch.kernels import _build, linsolve_stream
from fluid_simulation_tpu_torch.kernels.advect_compat import advect_compat
from fluid_simulation_tpu_torch.kernels.advect_fast import advect_fast
from fluid_simulation_tpu_torch.kernels.advect_split import (
    advect_split, advect_split_plain)
from fluid_simulation_tpu_torch.kernels.bounds import (
    pad_bounds, pad_bounds_plain)
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve
from fluid_simulation_tpu_torch.kernels.linsolve_stream import (
    rbgs_solve_stream)
from fluid_simulation_tpu_torch.kernels.project import (
    project_empty, project_masked)
from fluid_simulation_tpu_torch.kernels.project_stream import (
    project_stream, project_stream_masked)
from fluid_simulation_tpu_torch.kernels.stats import (
    step_stats, step_stats_plain)
from fluid_simulation_tpu_torch.kernels.vorticity import (
    confinement, confinement_plain)
from fluid_simulation_tpu_torch.ops.advect import advect, backtrace, gather
from fluid_simulation_tpu_torch.ops.linsolve import (
    as_scalar, diffuse, diffusion_coeffs)
from fluid_simulation_tpu_torch.ops.project import project
from fluid_simulation_tpu_torch.scene.masks import SceneMasks, build_masks
from fluid_simulation_tpu_torch.utils.profiling import span, timed_span


class FluidState(NamedTuple):
    """Padded (D+2, H+2, W+2) fields, the reference's member arrays
    (simulation.h:16-27)."""

    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    dens: torch.Tensor


class StepStats(NamedTuple):
    """Per-step scalars (NaN where the matching SimParams flag is off)."""

    density_sum: torch.Tensor
    max_divergence: torch.Tensor


def _dtype(params: SimParams) -> torch.dtype:
    return torch.bfloat16 if params.dtype == "bfloat16" else torch.float32


def init_state(params: SimParams, device="cuda") -> FluidState:
    """All-zero fields, like the ctor fill (simulation.cpp:38-43), on the
    card unless ``device="cpu"``."""
    z = [torch.zeros(params.padded_shape, dtype=_dtype(params), device=device)
         for _ in range(4)]
    return FluidState(*z)


def unported_reason(p: SimParams) -> Optional[str]:
    """What in ``p`` has no kernel on the card yet, with its ROADMAP item,
    or None when the whole step has one."""
    if p.dtype == "bfloat16":
        return "dtype='bfloat16' (ROADMAP A11)"
    if p.batched:
        return "batched design sweeps (ROADMAP A12)"
    return None


def _require_ported(p: SimParams, t: torch.Tensor) -> None:
    if p.use_pallas and _build.on_card(t):
        reason = unported_reason(p)
        if reason:
            raise NotImplementedError(
                f"{reason}: not ported to the card yet; use_pallas=False "
                f"runs the plain torch step")


def _apply_inlets(state: FluidState,
                  params: SimParams) -> Tuple[FluidState, torch.Tensor]:
    """Inlet density (simulation.cpp:64-67) and inlet velocity
    (simulation.cpp:102-105) on the x=1 interior plane; returns the new
    state and the post-inlet density (``buffer = dens``, simulation.cpp:70)."""
    D2, H2, W2 = state.dens.shape
    dev = state.dens.device
    zi = torch.arange(D2, device=dev).reshape(D2, 1, 1)
    yi = torch.arange(H2, device=dev).reshape(1, H2, 1)
    xi = torch.arange(W2, device=dev).reshape(1, 1, W2)
    m = ((xi == 1) & (zi >= 1) & (zi <= D2 - 2) & (yi >= 1) & (yi <= H2 - 2))
    dt = state.dens.dtype
    dens = torch.where(m, state.dens + as_scalar(params.inlet_density, dt),
                       state.dens)
    vx = torch.where(m, as_scalar(params.speed, dt), state.vx)
    vy = torch.where(m, 0.0, state.vy)
    vz = torch.where(m, 0.0, state.vz)
    return FluidState(vx, vy, vz, dens), dens


def _pad_bounds_tail(smp, bs, masks: SceneMasks, p: SimParams):
    """Padded fields + setBounds from advected interior samples ``smp``
    ((len(bs), D, H, W) or (D, H, W)): kernel 4 with ``use_pallas``, its
    plain version otherwise."""
    with span("fst.bounds"):
        kw = {}
        if not p.empty_scene:
            keep = masks.keep_vel if bs[0] in (1, 2, 3) else masks.keep_scalar
            kw = dict(fluid_i=masks.fluid_i, keep_i=keep[1:-1, 1:-1, 1:-1])
        fn = pad_bounds if p.use_pallas else pad_bounds_plain
        return fn(smp, bs, p.wall_mode, **kw)


def _solve_route(shape, p: SimParams) -> str:
    """The route of a phase's rbgs solves: ``"stream"`` on big grids
    (``linsolve_stream.streams``), ``"resident"`` otherwise, both with
    ``use_pallas``; ``"plain"`` for the composable ops (other solvers, or
    the plain path)."""
    if not (p.use_pallas and p.solver == "rbgs"):
        return "plain"
    return "stream" if linsolve_stream.streams(shape) else "resident"


def _diffuse_vel_dispatch(vx, vy, vz, pvx, pvy, pvz, masks: SceneMasks,
                          p: SimParams):
    """The step's three velocity diffusions (simulation.cpp:115-117): the
    streamed or the resident solve (kernel 1), or ``diffuse``."""
    vel_diff = p.visc if p.use_visc_for_velocity else p.diff
    fields = ((1, vx, pvx), (2, vy, pvy), (3, vz, pvz))
    route = _solve_route(vx.shape, p)
    if route == "plain":
        return tuple(diffuse(b, v, pv, masks, p.dt, vel_diff, acc=p.acc,
                             solver=p.solver, wall_mode=p.wall_mode,
                             empty_scene=p.empty_scene)
                     for b, v, pv in fields)
    a, c = diffusion_coeffs(p.width, p.height, p.depth, p.dt, vel_diff)
    keep = None if p.empty_scene else masks.keep_vel
    solve = rbgs_solve_stream if route == "stream" else rbgs_solve
    return tuple(solve(b, v, pv, a, c, acc=p.acc, wall_mode=p.wall_mode,
                       keep=keep) for b, v, pv in fields)


def _project_dispatch(vx, vy, vz, masks: SceneMasks, p: SimParams):
    """Projection: the streamed kernels and the pad_bounds tail, or kernel
    2 for empty scenes and kernel 6 for obstacle scenes, or ``project``.
    Returns (vx, vy, vz)."""
    route = _solve_route(vx.shape, p)
    if route == "stream":
        if p.empty_scene:
            smp = project_stream(vx, vy, vz, acc=p.acc,
                                 wall_mode=p.wall_mode)
        else:
            smp = project_stream_masked(vx, vy, vz, masks.fluid_i,
                                        acc=p.acc, wall_mode=p.wall_mode)
        return _pad_bounds_tail(smp, (1, 2, 3), masks, p)
    if route == "resident":
        if p.empty_scene:
            return project_empty(vx, vy, vz, acc=p.acc, wall_mode=p.wall_mode)
        return project_masked(vx, vy, vz, masks.fluid_i,
                              masks.keep_vel[1:-1, 1:-1, 1:-1], acc=p.acc,
                              wall_mode=p.wall_mode)
    return project(vx, vy, vz, masks, acc=p.acc, solver=p.solver,
                   wall_mode=p.wall_mode, empty_scene=p.empty_scene)[:3]


def _advect_split(prev, vx, vy, vz, p: SimParams):
    fn = advect_split if p.use_pallas else advect_split_plain
    return fn(prev, vx, vy, vz, p.dt)


def simulation_step(state: FluidState, masks: SceneMasks,
                    params: SimParams) -> Tuple[FluidState, StepStats]:
    """Advance one full time step. Pure: returns new tensors. Each phase
    runs in a span (``utils/profiling.span``): ``fst.step`` around
    ``fst.inlets``, ``fst.diffuse``, ``fst.project`` (twice),
    ``fst.advect``, ``fst.confine``, ``fst.advect_density`` and
    ``fst.stats``. Inside the advection phases each trilinear sample of
    compat and fast runs in ``fst.gather`` (4 a step) and each padding or
    ``set_bounds`` in ``fst.bounds``, each backtrace in ``fst.backtrace``:
    compat 4 backtraces and 4 ``set_bounds`` a step, fast 2 and 2 (its
    shared velocity backtrace and padding, density's), split 2 paddings.
    On the card with ``use_pallas`` an ``advect`` call is one kernel
    launch in ``fst.gather`` and opens neither of the others: compat then
    opens no ``fst.backtrace`` or ``fst.bounds``. Fast's velocity is one
    ``fst.backtrace`` around one kernel launch in ``fst.gather``, then its
    padding: fast opens two ``fst.gather`` a step, one of each other."""
    with span("fst.step"):
        return _step(state, masks, params)


def _step(state: FluidState, masks: SceneMasks,
          p: SimParams) -> Tuple[FluidState, StepStats]:
    _require_ported(p, state.vx)

    with span("fst.inlets"):
        state, buffer = _apply_inlets(state, p)
    vx, vy, vz, dens = state
    pvx, pvy, pvz = vx, vy, vz   # pre-diffusion save (simulation.cpp:107-110)

    with span("fst.diffuse"):
        vx, vy, vz = _diffuse_vel_dispatch(vx, vy, vz, pvx, pvy, pvz,
                                           masks, p)
    with span("fst.project"):
        vx, vy, vz = _project_dispatch(vx, vy, vz, masks, p)

    # on the card each advect call is one kernel launch, and so are fast's
    # velocity samples, whatever the window (the plain path takes neither).
    # advect's arguments stay positional (the benchmark's roofline reads the
    # first nine, and wrappers of advect pass *args), and so do backtrace's
    # first three.
    card = p.use_pallas and _build.on_card(vx)
    fused = advect_compat if card else None
    with span("fst.advect"):
        if p.mode == "compat":
            # sequential component advection (simulation.cpp:125-127)
            vx2 = advect(1, pvx, vx, vy, vz, masks, p.dt, p.wall_mode,
                         p.empty_scene, fused)
            vy2 = advect(2, pvy, vx2, vy, vz, masks, p.dt, p.wall_mode,
                         p.empty_scene, fused)
            vz2 = advect(3, pvz, vx2, vy2, vz, masks, p.dt, p.wall_mode,
                         p.empty_scene, fused)
            vx, vy, vz = vx2, vy2, vz2
        elif p.mode == "fast":
            # one shared backtrace through the projected field, three
            # samples of the saves along it: on the card one launch
            inner = (slice(1, -1),) * 3
            args = (vx[inner], vy[inner], vz[inner], p.dt, p.width,
                    p.height, p.depth, vx.dtype)
            saves = (pvx, pvy, pvz)
            if card:
                smp = backtrace(*args, prevs=saves, fused=advect_fast)
            else:
                xb, yb, zb = backtrace(*args)
                smp = torch.stack([gather(prev, xb, yb, zb)
                                   for prev in saves])
            vx, vy, vz = _pad_bounds_tail(smp, (1, 2, 3), masks, p)
        elif p.mode == "split":
            # the three components share one pass pipeline (one coordinate
            # per cell and pass)
            smp = _advect_split(torch.stack([pvx, pvy, pvz]), vx, vy, vz, p)
            vx, vy, vz = _pad_bounds_tail(smp, (1, 2, 3), masks, p)
        else:
            raise ValueError(f"unknown mode {p.mode!r}")

    if p.vorticity:
        with span("fst.confine"):
            fn = confinement if p.use_pallas else confinement_plain
            vx, vy, vz = fn(vx, vy, vz, masks.keep_vel[1:-1, 1:-1, 1:-1],
                            p.vorticity, p.dt)

    with span("fst.project"):
        vx, vy, vz = _project_dispatch(vx, vy, vz, masks, p)

    with span("fst.advect_density"):
        if p.mode == "split":
            dens, = _pad_bounds_tail(_advect_split(buffer, vx, vy, vz, p),
                                     (0,), masks, p)
        else:
            dens = advect(0, buffer, vx, vy, vz, masks, p.dt, p.wall_mode,
                          p.empty_scene, fused)

    with span("fst.stats"):
        on = dict(divergence_on=p.div_stats, density_on=p.step_stats)
        if p.use_pallas:
            density_sum, max_div = step_stats(vx, vy, vz, dens, masks,
                                              p.empty_scene, **on)
        else:
            density_sum, max_div = step_stats_plain(vx, vy, vz, dens, masks,
                                                    **on)
    return (FluidState(vx, vy, vz, dens),
            StepStats(density_sum=density_sum, max_divergence=max_div))


def simulate(state: FluidState, masks: SceneMasks, params: SimParams,
             steps: int, record: bool = False, first=simulation_step):
    """Run ``steps`` steps. Returns ``(final_state, ys)``: ``ys`` is the
    StepStats stacked over steps, or with ``record=True`` the pair
    ``(stats, states)`` with every step's fields stacked on the device
    (the analog of the reference's per-step dump, simulation.cpp:143-147).
    The first step is ``first`` (``simulation_step``, or a tunnel's first
    step, which times itself), the rest ``simulation_step``."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    state, st = first(state, masks, params)
    stats, states = [st], [state] if record else []
    for _ in range(steps - 1):
        state, st = simulation_step(state, masks, params)
        stats.append(st)
        if record:
            states.append(state)
    stacked = StepStats(*(torch.stack(x) for x in zip(*stats)))
    if not record:
        return state, stacked
    return state, (stacked, FluidState(*(torch.stack(x)
                                         for x in zip(*states))))


class WindTunnel:
    """Params + scene masks + state on one device: the equivalent of
    constructing ``Simulation`` and calling ``run()``
    (simulation.cpp:429-451). The device is the card unless the caller
    passes ``device="cpu"``; without a card the default raises.
    ``setup_s`` maps each set-up span to its host seconds: ``fst.setup``
    and its children ``fst.setup.context`` (on the card: the device's CUDA
    context, created there by one call so that the masks' span holds only
    the masks), ``fst.setup.masks`` and ``fst.setup.state``; and, once the
    tunnel has stepped, ``fst.first_step``, its first step from the call to
    its return (no synchronise): the kernel library's load, each entry
    point's first launch, torch's first use of its own kernels and the
    allocator's growth to the step's working set.

    Until that first step ``step`` and ``simulate`` are instance attributes
    that time it; the first step deletes them, so every later step is the
    class's own method and pays for nothing more."""

    def __init__(self, params: SimParams = SimParams(),
                 obstacles: Optional[np.ndarray] = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "WindTunnel: no CUDA device; pass device='cpu' to run the "
                "plain torch step on the host")
        if obstacles is None:
            obstacles = np.zeros(params.padded_shape, np.float32)
        if tuple(obstacles.shape) != params.padded_shape:
            raise ValueError(f"obstacle shape {obstacles.shape} != padded "
                             f"{params.padded_shape}")
        self.setup_s = {}
        with timed_span("fst.setup", self.setup_s):
            self.obstacles = np.array(obstacles, np.float32)
            # empty scenes skip obstacle masking (exact identity); derived
            # from the obstacle field, and an explicit empty_scene=True with
            # solids is rejected (it would silently give wrong physics)
            has_solids = bool((self.obstacles >= 0.5).any())
            if params.empty_scene and has_solids:
                raise ValueError(
                    "SimParams(empty_scene=True) with a non-empty obstacle "
                    "field: empty_scene skips all obstacle masking and must "
                    "only be set for scenes without solids")
            self.params = params.replace(empty_scene=not has_solids)
            if self.device.type == "cuda":
                with timed_span("fst.setup.context", self.setup_s):
                    torch.cuda.synchronize(self.device)
            with timed_span("fst.setup.masks", self.setup_s):
                self.masks = build_masks(self.obstacles,
                                         dtype=_dtype(self.params),
                                         device=self.device)
            with timed_span("fst.setup.state", self.setup_s):
                self.state = init_state(self.params, self.device)
            _require_ported(self.params, self.state.vx)
        self.step, self.simulate = self._first_step, self._first_simulate

    def reset(self) -> FluidState:
        self.state = init_state(self.params, self.device)
        return self.state

    def step(self) -> StepStats:
        self.state, stats = simulation_step(self.state, self.masks,
                                            self.params)
        return stats

    def simulate(self, steps: int, record: bool = False):
        self.state, ys = simulate(self.state, self.masks, self.params,
                                  steps=steps, record=record)
        return self.state, ys

    def _first(self, state, masks, params):
        """The tunnel's first step, in ``fst.first_step``; from here on
        ``step`` and ``simulate`` are the class's."""
        del self.step, self.simulate
        with timed_span("fst.first_step", self.setup_s):
            return simulation_step(state, masks, params)

    def _first_step(self) -> StepStats:
        self.state, stats = self._first(self.state, self.masks, self.params)
        return stats

    def _first_simulate(self, steps: int, record: bool = False):
        self.state, ys = simulate(self.state, self.masks, self.params,
                                  steps=steps, record=record,
                                  first=self._first)
        return self.state, ys

    # -- single-cell edit API (simulation.cpp:155-178) --------------------

    def add_obstacle(self, x: int, y: int, z: int):
        """Mark one interior cell solid (Simulation::addObstacle)."""
        self._check_cell(x, y, z)
        self.obstacles[z, y, x] = 1.0
        self.masks = build_masks(self.obstacles, dtype=_dtype(self.params),
                                 device=self.device)
        self.params = self.params.replace(empty_scene=False)

    def add_density(self, x: int, y: int, z: int, amount: float):
        """Add density to one cell (Simulation::addDensity)."""
        self._check_cell(x, y, z)
        dens = self.state.dens.clone()
        dens[z, y, x] += as_scalar(amount, dens.dtype)
        self.state = self.state._replace(dens=dens)

    def set_velocity(self, x: int, y: int, z: int,
                     vx: float, vy: float, vz: float):
        """Set the velocity of one cell (Simulation::setVelocity)."""
        self._check_cell(x, y, z)
        new = {}
        for key, val in zip(("vx", "vy", "vz"), (vx, vy, vz)):
            f = getattr(self.state, key).clone()
            f[z, y, x] = as_scalar(val, f.dtype)
            new[key] = f
        self.state = self.state._replace(**new)

    def _check_cell(self, x, y, z):
        p = self.params
        if not (1 <= x <= p.width and 1 <= y <= p.height
                and 1 <= z <= p.depth):
            raise ValueError(
                f"cell ({x},{y},{z}) outside interior "
                f"1..{p.width} x 1..{p.height} x 1..{p.depth}")

    def density_sum(self) -> float:
        return float(torch.sum(self.state.dens, dtype=torch.float32))

    def field_ranges(self):
        """Final min/max statistics, like simulation.cpp:81-90."""
        s = self.state
        r = torch.stack([s.dens.min(), s.dens.max(), s.vx.min(), s.vx.max(),
                         s.vy.min(), s.vy.max(), s.vz.min(),
                         s.vz.max()]).to(torch.float32).tolist()
        return {"density": (r[0], r[1]), "vx": (r[2], r[3]),
                "vy": (r[4], r[5]), "vz": (r[6], r[7])}
