"""Hand-written CUDA kernels for the card, each beside its plain torch version.

Every wrapper runs its plain version for a tensor on the CPU and, for a CUDA
tensor, launches its kernel or raises — never falls back. ``LAUNCHES``
counts wrapper calls that launched a kernel, one per call, so a run can
show which kernels carried it:

- ``rbgs_solve``        (kernels/linsolve.py)     one per empty-scene solve
- ``rbgs_solve_keep``   (kernels/linsolve.py)     one per obstacle-scene solve
- ``project_empty``     (kernels/project.py)      one per empty projection
- ``project_masked``    (kernels/project.py)      one per obstacle projection
- ``advect_split``      (kernels/advect_split.py) one per advected stack
- ``pad_bounds``        (kernels/bounds.py)       one per padded stack
- ``pad_bounds_masked`` (kernels/bounds.py)       one per masked padded stack
- ``confinement``       (kernels/vorticity.py)    one per confinement
- ``rbgs_solve_stream``      (kernels/linsolve_stream.py) one per streamed
  empty-scene solve (big grids)
- ``rbgs_solve_stream_keep`` (kernels/linsolve_stream.py) one per streamed
  obstacle-scene solve
- ``project_stream``         (kernels/project_stream.py)  one per streamed
  empty projection
- ``project_stream_masked``  (kernels/project_stream.py)  one per streamed
  obstacle projection
- ``trilinear_gather``       (kernels/advect_compat.py)   one per trilinear
  sample of compat or fast advection with ``advect_window > 0``
- ``rbgs_solve3``            (kernels/linsolve.py)        one per fused
  three-field diffusion (gated off in the step, as in the JAX package)
- ``rbgs_solve_unpacked``    (kernels/linsolve.py)        one per unpacked
  keep solve (``packed=False``; no route of the step takes it)
- ``advect_split_fused``     (kernels/advect_split.py)    one per advected
  stack through the fused-backtrace entry point (opt-in, no route)
- ``rbgs_sweep_packed``      (kernels/linsolve_sweep.py)  one per packed
  sweep of one rank's slab in the sharded solve (``5·acc·n`` per step)
- ``rbgs_sweep``             (kernels/linsolve_sweep.py)  one per padded
  slab sweep (no route, as in the JAX package)
- ``prestep``                (kernels/prestep.py)         one per fused
  pre-advection block of an empty scene (one cooperative launch; no route)
- ``prestep_masked``         (kernels/prestep.py)         one per fused
  pre-advection block of an obstacle scene
- ``rbgs_solve_blocked``     (kernels/linsolve_blocked.py) one per sweep
  of the z-blocked solve, ``acc`` per call (no route)
- ``rbgs_solve_cpack``       (kernels/linsolve_cpack.py)  one per
  colour-packed solve that sweeps the halves (sweep 1 counts under K1's
  own counter; no route)
- ``rbgs_solve_cpack_stream`` (kernels/linsolve_cpack.py) one per
  colour-packed sweep of the streamed entry point, ``acc - 1`` per call
  (sweep 1 counts under ``rbgs_solve_blocked``; no route)
- ``probe_add1``             (kernels/probe.py)           one per ``o = x + 1``
  of the launch-overhead probe (``tools/exp_overhead.py``; no route)
- ``hbm_stream``             (kernels/hbm.py)             one per z-blocked
  stream of the streaming-ceiling probes (``tools/exp_hbm.py``,
  ``tools/exp_hbm2.py``; no route)
- ``sweepcost_pass``         (kernels/sweepcost.py)       one per pass of a
  sweep-cost variant of the streamed pass kernel
  (``tools/exp_sweepcost.py``; no route)
- ``dma_stream``             (kernels/dma.py)             one per z-blocked
  stream of the DMA-issue probe, either loader (``tools/exp_dma.py``; no
  route)
- ``transpose``              (kernels/transpose.py)       one per batched
  shared-memory transpose (``tools/exp_transpose.py``; no route)
- ``strided_copy``           (kernels/transpose.py)       one per strided
  copy with a scale (``tools/exp_transpose.py``; no route)
- ``lerp_pass``              (kernels/advect_split.py)    one per single
  pass of K3's lerp kernel (``tools/exp_transpose.py``'s boundary rows; no
  route)
- ``rbgs_solve_mxu``         (kernels/linsolve_mxu.py)    one per empty
  b = 0 solve with the x pair on the tensor cores
  (``tools/exp_solve_mxu.py``; no route)
- ``lerpcost_pass``          (kernels/lerpcost.py)        one per degrade
  variant of K3's stacked x pass on an index plane
  (``tools/exp_lerpcost.py``; no route)

These counters are the package's only global state.
"""

LAUNCHES = {"rbgs_solve": 0, "rbgs_solve_keep": 0, "project_empty": 0,
            "project_masked": 0, "advect_split": 0, "pad_bounds": 0,
            "pad_bounds_masked": 0, "confinement": 0,
            "rbgs_solve_stream": 0, "rbgs_solve_stream_keep": 0,
            "project_stream": 0, "project_stream_masked": 0,
            "trilinear_gather": 0, "rbgs_solve3": 0,
            "rbgs_solve_unpacked": 0, "advect_split_fused": 0,
            "rbgs_sweep_packed": 0, "rbgs_sweep": 0, "prestep": 0,
            "prestep_masked": 0, "rbgs_solve_blocked": 0,
            "rbgs_solve_cpack": 0, "rbgs_solve_cpack_stream": 0,
            "probe_add1": 0, "hbm_stream": 0, "sweepcost_pass": 0,
            "dma_stream": 0, "transpose": 0, "strided_copy": 0,
            "lerp_pass": 0, "rbgs_solve_mxu": 0, "lerpcost_pass": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
