"""Scoring's share of the card's dense bfloat16 peak, in %: the window's
tokens a second (each sequence with its BOS and EOS, pad left out)
times the forward's third of the frozen FLOPs per token of the cell's
family."""

from portbench import counts


def read(r):
    rate = r.values.get("tokens_per_s")
    if rate is None:
        return None
    return counts.mfu(r.cell.family.flops_per_token(r.cell.spec) / 3, rate,
                      r.values["device_name"])
