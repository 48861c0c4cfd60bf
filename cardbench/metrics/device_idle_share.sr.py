"""The share of the traced window in which no kernel, copy or set ran on
the card (1 - busy_s / window_s, from torch.profiler's CUDA activity), in
a short-read cell."""


def read(rec):
    if rec.get("entry") != "sr_count" or not rec.get("window_s"):
        return None
    return 1.0 - rec["busy_s"] / rec["window_s"]
