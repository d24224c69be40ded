"""``tp_hop_bytes_per_token``: the bytes a training step's TP hops pack,
per token of the batch: the hops of ``counts.hops_per_step`` times the
residual stream's width times the plan's wire bytes an element (raw bf16
under an identity codec).  A count, from the configuration and the
plan."""
from perfbench import counts


def read(rec):
    return counts.hop_bytes_per_token(rec["config"], rec["traffic"])
