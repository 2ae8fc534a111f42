"""tunnel_setup_s: host seconds of the program's own ``fst.setup`` span,
``WindTunnel.__init__`` from the obstacle copy to the state on the card
(the masks, where the first allocation on the card lands, and the state),
as the tunnel keeps it in ``setup_s``. It leaves out the benchmark's own
obstacle build and the import, which ``scene_setup_s`` holds. A system
with no such tunnel reads nothing.

Predicted (t512 sphere / t512 empty / t128): 0.4-1.5 / 0.4-1.5 / 0.2-0.7 s,
the first CUDA context in it."""


def read(run):
    wt = getattr(getattr(run.cell, "system", None), "wt", None)
    return getattr(wt, "setup_s", {}).get("fst.setup")
