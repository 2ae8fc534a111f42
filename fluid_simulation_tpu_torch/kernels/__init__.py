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

These counters are the package's only global state.
"""

LAUNCHES = {"rbgs_solve": 0, "rbgs_solve_keep": 0, "project_empty": 0,
            "project_masked": 0, "advect_split": 0, "pad_bounds": 0,
            "pad_bounds_masked": 0, "confinement": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
