"""context_setup_s: host seconds of the program's own ``fst.setup.context``
span: the card's CUDA context (and torch's lazy CUDA set-up), which
``WindTunnel.__init__`` creates by one call before it builds the masks,
as the tunnel keeps it in ``setup_s``. It is part of ``tunnel_setup_s``.
A system with no such span (a tunnel on the host, or one older than the
span) reads nothing.

Predicted (every cell): 0.3-1.2 s, most of ``tunnel_setup_s`` and most of
its wander."""


def read(run):
    wt = getattr(getattr(run.cell, "system", None), "wt", None)
    return getattr(wt, "setup_s", {}).get("fst.setup.context")
