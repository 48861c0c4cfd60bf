"""A cell of the benchmark loaded from the manifest and shrunk to a size
the CPU runs in seconds (a 3 Mb genome with as many pasted repeats a base
as at full size, a few hundred reads, a few thousand pairs), with every
width kept."""

from cardbench import run


def small_cell(name: str) -> dict:
    spec = run.load_cell(name)
    cfg = spec["config"]
    full = sum(int(c["length"]) for c in cfg["chromosomes"])
    if len(cfg["chromosomes"]) > 1:
        cfg["chromosomes"] = cfg["chromosomes"][:2]
    else:
        cfg["chromosomes"] = [{"name": cfg["chromosomes"][0]["name"],
                               "length": 3_000_000}]
    # as many pasted repeats a base as at full size
    small = sum(int(c["length"]) for c in cfg["chromosomes"])
    prof = cfg["profile"]
    prof["repeats"] = max(1, round(prof["repeats"] * small / full))
    cfg["reads_per_call"] = 96
    t = spec["traffic"]
    for key, small in (("pool_calls", 2), ("genes_per_call", 6),
                       ("pairs_per_batch", 1500), ("pool_batches", 2)):
        if key in t:
            t[key] = small
    return spec
