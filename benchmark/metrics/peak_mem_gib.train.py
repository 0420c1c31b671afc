"""The device memory peak over the window's steps
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
at the window's start), in GiB."""


def read(rec):
    if rec["kind"] != "train" or not rec.get("window_peak_bytes"):
        return None
    return rec["window_peak_bytes"] / 2 ** 30
