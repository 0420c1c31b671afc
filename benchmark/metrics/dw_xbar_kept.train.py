"""The share of the training steps' weight gradients that took the
forward's own cell means instead of walking the neighbourhood again, in
percent: the op layer's ``DW_XBAR`` counter (``kept``, ``walked``) read in
the run's own process.  As with ``host_syncs.train``, the run zeroes it
(``reset_launches``) when the window starts and nothing of the program
runs after the traced steps, so it holds the window's and the traced
steps' gradients.  None where the program has no such counter or took no
weight gradient."""


def read(rec):
    if rec["kind"] != "train":
        return None
    try:
        from pointwise_torch.ops.pointwise_conv import DW_XBAR as counts
    except ImportError:                  # a program without the counter
        return None
    total = counts["kept"] + counts["walked"]
    return 100.0 * counts["kept"] / total if total else None
