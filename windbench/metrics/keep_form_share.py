"""keep_form_share: the share, in %, of the streamed keep passes' blocks
that ran the keep form, the others running the keep-free form: the
program's own count, ``MARCH_BLOCKS`` in ``fluid_simulation_tpu_torch.
kernels`` (``keep_form``, ``keep_free``), which each keep-pass launch adds
to from its mask's cached table, without a device read. 100 x keep_form /
(keep_form + keep_free) over the process, whose steps all run the same
passes on the same masks. A program without the counter, or a cell that ran
no keep pass (an empty tunnel, the resident route), reads nothing.

Predicted (the four t512 sphere cells): 3-5 %; the bench sphere's tables
flag 39 of 1,024 blocks of ``keep_vel`` and 37 of ``fluid_i`` at nsw 2 and
60 of 2,048 at nsw 1: 1,457 of a step's 39,936 blocks, 3.65 %."""

import sys

KERNELS = "fluid_simulation_tpu_torch.kernels"


def read(run):
    blocks = getattr(sys.modules.get(KERNELS), "MARCH_BLOCKS", None)
    if not blocks:
        return None
    total = blocks.get("keep_form", 0) + blocks.get("keep_free", 0)
    return 100.0 * blocks.get("keep_form", 0) / total if total else None
