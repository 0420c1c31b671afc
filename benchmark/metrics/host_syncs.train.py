"""The program's calls that blocked the host on the card per training
step, in syncs: the op layer's ``HOST_SYNCS`` counter read in the run's
own process.  The training record holds no program counter but its copy
of ``LAUNCHES``, so the reader takes the counter itself: the run zeroes it
(``reset_launches``) when the window starts, and after the traced steps
nothing of the program runs (the work count and the reference are the
benchmark's own), so it holds the window's and the traced steps' syncs.
A step's count is fixed by its shapes (one per CSR tile list), so the two
share it.  None where the program has no such counter."""


def read(rec):
    if rec["kind"] != "train":
        return None
    from pointwise_torch.kernels import pointwise_conv_cuda as kernels

    syncs = getattr(kernels, "HOST_SYNCS", None)
    n = rec["steps"] + rec.get("trace", {}).get("n", 0)
    if syncs is None or not n:
        return None
    return sum(syncs.values()) / n
