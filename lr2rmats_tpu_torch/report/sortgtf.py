"""GTF transcript-block sorter.

Replicates src/sort_gtf.sh (reference sort_gtf.sh:11-29): every
transcript/exon line is tagged with the (chrom-rank, transcript-start,
transcript-end, original-line-number) of its governing `transcript` line,
then stably sorted on that key.  The chromosome rank table is the hardcoded
human chr1..chrM order, extended on the fly for unknown chromosomes in first-
appearance order.

Implemented as a vectorized lexsort over key tensors rather than a shell
pipeline.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

_HUMAN_RANK = {f"chr{i}": i for i in range(1, 23)}
_HUMAN_RANK.update({"chrX": 23, "chrY": 24, "chrM": 25})


def sort_gtf_lines(lines: Iterable[str]) -> List[str]:
    chrom_rank = dict(_HUMAN_RANK)
    next_rank = 25
    kept: List[str] = []
    chr_key: List[int] = []
    start_key: List[int] = []
    end_key: List[int] = []
    cur = (0, 0, 0)
    for line in lines:
        if line.startswith("#"):
            continue
        f = line.split("\t")
        if len(f) < 9:
            continue
        feat = f[2]
        # awk: $3 ~ "transcript" (substring match) || $3 == "exon"
        if "transcript" not in feat and feat != "exon":
            continue
        if feat == "transcript":
            r = chrom_rank.get(f[0])
            if r is None:
                next_rank += 1
                chrom_rank[f[0]] = r = next_rank
            cur = (r, int(f[3]), int(f[4]))
        if not line.endswith("\n"):
            # a final line without its newline would otherwise be glued
            # to whatever line sorts after it
            line += "\n"
        kept.append(line)
        chr_key.append(cur[0])
        start_key.append(cur[1])
        end_key.append(cur[2])

    if not kept:
        return []
    order = np.lexsort((
        np.arange(len(kept)),                 # original line number
        np.asarray(end_key, np.int64),
        np.asarray(start_key, np.int64),
        np.asarray(chr_key, np.int64),
    ))
    return [kept[i] for i in order]


def sort_gtf_file(in_path: str, out_path: str) -> None:
    with open(in_path) as f:
        lines = f.readlines()
    out = sort_gtf_lines(lines)
    with open(out_path, "w") as f:
        f.writelines(out)
