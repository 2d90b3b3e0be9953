"""The training step's share of the card's dense bfloat16 peak, in %:
the window's rate of trained tokens (each protein with its BOS and EOS,
pad left out) times the frozen FLOPs per token of the cell's family
(forward and backward, no recompute)."""

from portbench import counts


def read(r):
    rate = r.values.get("tokens_per_s")
    if rate is None:
        return None
    return counts.mfu(r.cell.family.flops_per_token(r.cell.spec), rate,
                      r.values["device_name"])
