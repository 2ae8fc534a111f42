"""Hand-written CUDA kernels for the card, each beside its plain torch version.

Every wrapper runs its plain version for a tensor on the CPU and, for a CUDA
tensor, launches its kernel or raises — never falls back. ``LAUNCHES``
counts wrapper calls that launched a kernel, one per call, so a run can
show which kernels carried it:

- ``rbgs_solve``    (kernels/linsolve.py)     one per diffusion solve
- ``project_empty`` (kernels/project.py)      one per projection
- ``advect_split``  (kernels/advect_split.py) one per advected stack
- ``pad_bounds``    (kernels/bounds.py)       one per padded stack

These counters are the package's only global state.
"""

LAUNCHES = {"rbgs_solve": 0, "project_empty": 0, "advect_split": 0,
            "pad_bounds": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
