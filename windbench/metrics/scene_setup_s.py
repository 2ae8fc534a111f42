"""scene_setup_s: host seconds to build the cell's obstacle field and
construct the tunnel (``WindTunnel.__init__``: the masks and the state on
the card), a span of the benchmark's own around those calls."""


def read(run):
    return run.spans["scene_setup_s"]
