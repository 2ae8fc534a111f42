"""The port's measurement probes, named after the JAX side's ``tools/``
scripts they stand for (ROADMAP B23); ``exp_pass``, which times the
big-grid route's pass kernel in its production forms; and ``breakdown``,
the operator tool that breaks a step down by device operation and by phase.
Each runs as ``python -m fluid_simulation_tpu_torch.tools.<name>``; no
route of the wind tunnel imports them."""
