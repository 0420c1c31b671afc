"""Points of all training steps of the window over the window's seconds,
the device synchronised once at its end."""


def read(rec):
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    return rec["steps"] * rec["points_per_step"] / rec["window_s"]
