"""The port's measurement probes, named after the JAX side's ``tools/``
scripts they stand for (ROADMAP B23), and ``exp_pass``, which times the
big-grid route's pass kernel in its production forms. Each runs as
``python -m fluid_simulation_tpu_torch.tools.<name>``; no route of the
wind tunnel imports them."""
