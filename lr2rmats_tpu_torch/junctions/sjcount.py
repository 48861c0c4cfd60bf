"""Short-read junction-support counting with its verify and counts on the
card (the STAR SJ.out.tab role).

`TorchJunctionCounter` is the reference's `JunctionCounter`
(lr2rmats_tpu/junctions/sjcount.py) with the reference's device hooks
filled by the port: seeding, candidate placement, best marking and the
pair gating stay the reference's host code; the Hamming verify runs
csrc/hamming.cu (`TorchHammingVerifier`) and the count scatters run on the
device (`TorchCounts`).  `count_junction_support` is the reference's
one-call entry, its counter chosen by LR2RMATS_DEVICE_SJCOUNT as in the
reference.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from lr2rmats_tpu.io.fasta import Genome
from lr2rmats_tpu.io.sj import SJTable
from lr2rmats_tpu.junctions.sjcount import (JunctionCounter, SJCountParams,
                                            gather_junctions)
from lr2rmats_tpu.transcript.model import Transcripts
from lr2rmats_tpu.utils import log

from .sjcount_device import TorchCounts, TorchHammingVerifier


class TorchJunctionCounter(JunctionCounter):
    """JunctionCounter whose verify and counts run on `device` (the kernel
    on a card, the plain versions on the CPU).  Unlike the reference's
    device backend it has no int32 addressing limit, so it never falls back
    to the host."""

    def __init__(self, genome: Genome, tid: np.ndarray, don: np.ndarray,
                 acc: np.ndarray, is_anno: np.ndarray,
                 params: Optional[SJCountParams] = None, device="cuda"):
        super().__init__(genome, tid, don, acc, is_anno, params,
                         backend="host")
        self._dev_verifier = TorchHammingVerifier(self.buf, device)
        self._dev_counts = TorchCounts(len(tid), device)
        self.backend = "device"


def count_junction_support(genome: Genome, gtf_sets: List[Transcripts],
                           read_sets, params: Optional[SJCountParams] = None,
                           device="cuda") -> SJTable:
    """One-call junction support counting (reference
    junctions/sjcount.py:count_junction_support).  read_sets items are a
    SeqSet (single-end) or a (SeqSet, SeqSet) mate pair.  With
    LR2RMATS_DEVICE_SJCOUNT set the counting runs TorchJunctionCounter on
    `device`, otherwise the reference's host counter."""
    log("sjcount", "building junction contexts ...")
    tid, don, acc, anno = gather_junctions(gtf_sets)
    if os.environ.get("LR2RMATS_DEVICE_SJCOUNT"):
        jc = TorchJunctionCounter(genome, tid, don, acc, anno, params,
                                  device=device)
    else:
        jc = JunctionCounter(genome, tid, don, acc, anno, params,
                             backend="host")
    log("sjcount", "placing %d read sets (%s) ...", len(read_sets),
        jc.backend)
    for rs in read_sets:
        if isinstance(rs, tuple):
            jc.count_pairs_batched(rs[0], rs[1])
        else:
            jc.count_seqset_batched(rs)
    log("sjcount", "junction support counting done.")
    return jc.result()
