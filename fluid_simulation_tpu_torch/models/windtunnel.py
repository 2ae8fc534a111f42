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
the caller asks for ``device="cpu"``. On the CPU every stage is plain torch.
On a CUDA device with ``use_pallas`` the solves, projections, split
advection, padding and vorticity confinement run the hand-written kernels
(``kernels/``), in empty and obstacle scenes; big grids stream their solves
and projections (``kernels/linsolve_stream.py``); compat and fast advection
with ``advect_window > 0`` sample through the trilinear kernel
(``kernels/advect_compat.py``), and split ignores the window, as in the JAX
package; the fused three-field diffusion (``kernels/linsolve.rbgs_solve3``)
is gated off by ``_diffuse3_applicable``, as there. A configuration whose
kernels are not ported yet raises ``NotImplementedError`` instead of running
plain torch. With ``use_pallas=False`` the step is plain torch on any
device.

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
from fluid_simulation_tpu_torch.kernels.advect_compat import (
    trilinear_gather_window)
from fluid_simulation_tpu_torch.kernels.advect_split import (
    advect_split, advect_split_plain)
from fluid_simulation_tpu_torch.kernels.bounds import (
    pad_bounds, pad_bounds_plain)
from fluid_simulation_tpu_torch.kernels.linsolve import rbgs_solve3
from fluid_simulation_tpu_torch.kernels.project import (
    project_empty, project_masked)
from fluid_simulation_tpu_torch.kernels.project_stream import (
    project_stream, project_stream_masked)
from fluid_simulation_tpu_torch.kernels.vorticity import (
    confinement, confinement_plain)
from fluid_simulation_tpu_torch.ops.advect import (
    advect, backtrace, trilinear_gather)
from fluid_simulation_tpu_torch.ops.linsolve import (
    as_scalar, diffuse, diffusion_coeffs)
from fluid_simulation_tpu_torch.ops.project import divergence, grid_h, project
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


def _project_dispatch(vx, vy, vz, masks: SceneMasks, p: SimParams):
    """Projection with rbgs and ``use_pallas``: on big grids
    (``linsolve_stream.streams``) the streamed kernels and the pad_bounds
    tail, else kernel 2 for empty scenes and kernel 6 for obstacle scenes;
    the composable ops otherwise (other solvers, or the plain path).
    Returns (vx, vy, vz)."""
    if p.use_pallas and p.solver == "rbgs":
        if linsolve_stream.streams(vx.shape):
            if p.empty_scene:
                smp = project_stream(vx, vy, vz, acc=p.acc,
                                     wall_mode=p.wall_mode)
            else:
                smp = project_stream_masked(vx, vy, vz, masks.fluid_i,
                                            acc=p.acc, wall_mode=p.wall_mode)
            return _pad_bounds_tail(smp, (1, 2, 3), masks, p)
        if p.empty_scene:
            return project_empty(vx, vy, vz, acc=p.acc, wall_mode=p.wall_mode)
        return project_masked(vx, vy, vz, masks.fluid_i,
                              masks.keep_vel[1:-1, 1:-1, 1:-1], acc=p.acc,
                              wall_mode=p.wall_mode)
    out = project(vx, vy, vz, masks, acc=p.acc, solver=p.solver,
                  wall_mode=p.wall_mode, use_pallas=p.use_pallas,
                  empty_scene=p.empty_scene)
    return out[0], out[1], out[2]


def _diffuse3_applicable(p: SimParams) -> bool:
    """The fused three-field diffusion (``rbgs_solve3``) is off in the
    step, as ``_diffuse3_applicable`` is in the JAX package, which measured
    it neutral on its own hardware. It stays tested, and ``chip_smoke.py``
    times it on the card with this gate forced on."""
    return False


def _diffuse_vel_dispatch(vx, vy, vz, pvx, pvy, pvz, masks: SceneMasks,
                          p: SimParams, vel_diff: float, kw: dict):
    """The step's three velocity diffusions (simulation.cpp:115-117): one
    ``rbgs_solve3`` call where ``_diffuse3_applicable`` allows it (rbgs,
    ``use_pallas``, and the resident route: big grids stream their solves),
    else three ``diffuse`` calls. Both give the same values."""
    if (_diffuse3_applicable(p) and p.use_pallas and p.solver == "rbgs"
            and not linsolve_stream.streams(vx.shape)):
        a, c = diffusion_coeffs(p.width, p.height, p.depth, p.dt, vel_diff)
        keep = None if p.empty_scene else masks.keep_vel
        return rbgs_solve3((1, 2, 3), vx, vy, vz, pvx, pvy, pvz, a, c,
                           acc=p.acc, wall_mode=p.wall_mode, keep=keep)
    return tuple(diffuse(b, v, pv, masks, p.dt, vel_diff, **kw)
                 for b, v, pv in ((1, vx, pvx), (2, vy, pvy), (3, vz, pvz)))


def _advect_split(prev, vx, vy, vz, p: SimParams):
    fn = advect_split if p.use_pallas else advect_split_plain
    return fn(prev, vx, vy, vz, p.dt)


def simulation_step(state: FluidState, masks: SceneMasks,
                    params: SimParams) -> Tuple[FluidState, StepStats]:
    """Advance one full time step. Pure: returns new tensors. Each phase
    runs in a span (``utils/profiling.span``): ``fst.step`` around
    ``fst.inlets``, ``fst.diffuse``, ``fst.project`` (twice),
    ``fst.advect``, ``fst.confine``, ``fst.advect_density`` and
    ``fst.stats``."""
    with span("fst.step"):
        return _step(state, masks, params)


def _step(state: FluidState, masks: SceneMasks,
          p: SimParams) -> Tuple[FluidState, StepStats]:
    _require_ported(p, state.vx)
    kw = dict(acc=p.acc, solver=p.solver, wall_mode=p.wall_mode,
              use_pallas=p.use_pallas, empty_scene=p.empty_scene)

    with span("fst.inlets"):
        state, buffer = _apply_inlets(state, p)
    vx, vy, vz, dens = state
    pvx, pvy, pvz = vx, vy, vz   # pre-diffusion save (simulation.cpp:107-110)

    vel_diff = p.visc if p.use_visc_for_velocity else p.diff
    with span("fst.diffuse"):
        vx, vy, vz = _diffuse_vel_dispatch(vx, vy, vz, pvx, pvy, pvz, masks,
                                           p, vel_diff, kw)
    with span("fst.project"):
        vx, vy, vz = _project_dispatch(vx, vy, vz, masks, p)

    # the trilinear kernel samples compat and fast advection with a window;
    # the plain path never takes it
    window = p.advect_window if p.use_pallas else 0
    with span("fst.advect"):
        if p.mode == "compat":
            # sequential component advection (simulation.cpp:125-127)
            vx2 = advect(1, pvx, vx, vy, vz, masks, p.dt, p.wall_mode,
                         p.empty_scene, window)
            vy2 = advect(2, pvy, vx2, vy, vz, masks, p.dt, p.wall_mode,
                         p.empty_scene, window)
            vz2 = advect(3, pvz, vx2, vy2, vz, masks, p.dt, p.wall_mode,
                         p.empty_scene, window)
            vx, vy, vz = vx2, vy2, vz2
        elif p.mode == "fast":
            # one shared backtrace through the projected field, three
            # gathers
            xb, yb, zb = backtrace(
                vx[1:-1, 1:-1, 1:-1], vy[1:-1, 1:-1, 1:-1],
                vz[1:-1, 1:-1, 1:-1], p.dt, p.width, p.height, p.depth,
                vx.dtype)
            gather = (trilinear_gather_window if window > 0
                      else trilinear_gather)
            smp = torch.stack([gather(prev, xb, yb, zb)
                               for prev in (pvx, pvy, pvz)])
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
                          p.empty_scene, window)

    with span("fst.stats"):
        nan = torch.tensor(float("nan"), dtype=torch.float32,
                           device=vx.device)
        if p.div_stats:
            h = grid_h(p.width, p.height, p.depth)
            max_div = divergence(vx, vy, vz, masks, h).abs().max().to(
                torch.float32)
        else:
            max_div = nan
        density_sum = (torch.sum(dens, dtype=torch.float32)
                       if p.step_stats else nan)
    return (FluidState(vx, vy, vz, dens),
            StepStats(density_sum=density_sum, max_divergence=max_div))


def simulate(state: FluidState, masks: SceneMasks, params: SimParams,
             steps: int, record: bool = False):
    """Run ``steps`` steps. Returns ``(final_state, ys)``: ``ys`` is the
    StepStats stacked over steps, or with ``record=True`` the pair
    ``(stats, states)`` with every step's fields stacked on the device
    (the analog of the reference's per-step dump, simulation.cpp:143-147)."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    stats, states = [], []
    for _ in range(steps):
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
    ``setup_s`` maps each set-up span (``fst.setup`` and its children
    ``fst.setup.masks`` and ``fst.setup.state``) to its host seconds."""

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
            with timed_span("fst.setup.masks", self.setup_s):
                self.masks = build_masks(self.obstacles,
                                         dtype=_dtype(self.params),
                                         device=self.device)
            with timed_span("fst.setup.state", self.setup_s):
                self.state = init_state(self.params, self.device)
            _require_ported(self.params, self.state.vx)

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
