"""host_ms_per_step: the host's own work per step in the traced frames: the
time inside each ``WindTunnel.step()`` call (the span ``windbench.step``)
less the time the host spent there blocked on the card (``BLOCKING``: a
stream, device or event synchronise, a synchronous copy). What remains is
what the kernel wrappers and glue ops cost the host to check, allocate and
launch a step, whatever the card's share; the profiler's own cost per
recorded op is in it too."""

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    host = run.profile["host"]
    steps = [(s, e) for n, s, e in host if n == "windbench.step"]
    waits = [(s, e) for n, s, e in host if n in BLOCKING]
    own = 0.0
    for s0, e0 in steps:
        blocked = sum(max(0.0, min(e, e0) - max(s, s0)) for s, e in waits)
        own += (e0 - s0) - blocked
    return own / 1e3 / run.profile["steps"]
