"""End-to-end two-pass pipeline of the port (the Snakemake DAG role).

`run_pipeline` is the reference's (lr2rmats_tpu/pipeline/stages.py) with the
port's device layer: the align stage runs `TorchBatchAligner` on `device`
(its junction backend and seed lookup chosen by LR2RMATS_DEVICE_JUNCTIONS
and LR2RMATS_DEVICE_SEED) and the sj_count stage runs the port's
`count_junction_support` (its device counter chosen by
LR2RMATS_DEVICE_SJCOUNT).  The stage graph, the artifact checkpoints
(`_fresh` / `_done`, copied here from the reference) and every host stage
are the port's copies of the reference's functions:

  index        : load the genome
  align        : long-read spliced alignment -> SAM + BED, filter
  sam_novel    : filter + update-gtf pass 1 -> sam_novel.gtf
  new_gtf      : original+novel merge + sort -> new.gtf
  sj_count     : short-read junction support -> STARSJ.out.tab
  gtf_novel    : update-gtf pass 2 (with SJ) -> gtf_novel.gtf + reports
  update       : cross-sample unique-gtf + final merge+sort -> updated.gtf

Under a process group (parallel/distributed.py init_multihost) each
process runs the round-robin shard of samples it owns on its own device,
`cuda:{process_id % device_count}` (or the CPU), with `.p{pid}` suffixes on
its log and index benchmark file; the pass-2 GTFs are all-gathered and
process 0 alone writes config.yaml, the gathered GTFs and updated.gtf,
while the others wait at a barrier; each process keeps one card.

A one-process run takes one card unless `devices` names several: then each
chain launch of the align stage is split over them (align/batch.py), as
the reference shards its chain dispatch over the local devices of its one
process; polish, junctions and sj_count stay on `device`.  The final
merge's unique-gtf runs without the reference's device gather of its
candidates: that gather sends the candidates through the devices and back
unchanged to validate its data plane, so it changes no output.

Left out with respect to the reference: the device-init probe and the link
preflip (they guarded a remote TPU link), the JAX compile cache and the
weather numbers of the align log.
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import sys
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..align.aligner import AlignParams
from ..align.batch import TorchBatchAligner
from ..device import resolve_device
from ..index.minimizer import MinimizerIndex
from ..io.fasta import Genome, read_fasta
from ..io.gtf import ChrNames, read_anno_trans
from ..io.sam import open_alignments, sam_header
from ..io.sj import write_sj_star
from ..junctions.sjcount import count_junction_support
from ..native import get_lib
from ..ops import _build
from ..parallel.distributed import (barrier, gather_indexed_payloads,
                                    multihost_info, owned_indices)
from ..parallel.shard_index import ShardedMinimizerIndex
from ..report.sortgtf import sort_gtf_file
from ..report.summary import _str_blob
from ..transcript.exon_chain import gen_exons
from ..transcript.filter import FilterParams
from ..transcript.model import UpdateGtfParams
from ..utils import Timer, log
from ..utils.log import set_log_stream
from .commands import cmd_filter, cmd_unique_gtf, cmd_update_gtf
from .config import PipelineConfig


def _sig(path: str):
    st = os.stat(path)
    return [st.st_size, st.st_mtime_ns]


def _fresh(out: str, *inputs: str) -> bool:
    """Artifact checkpoint: output exists and its recorded input signatures
    (size + ns mtime, kept in a `<out>.inputs.json` sidecar written by
    _done) still match.  Snakemake-style semantics without the
    second-granularity mtime race of the round-1 `<=` comparison.

    The sidecar is REQUIRED: it is written only after the stage completed,
    so a crash-truncated in-place output (kill -9 / OOM / disk-full
    mid-write) is never accepted as fresh — the old mtime fallback
    accepted exactly those (partial output newer than its inputs).  A
    recorded input that has since been deleted also marks the stage stale
    (the rerun then fails loudly on the missing input, the Snakemake
    behavior being mirrored)."""
    if not os.path.exists(out):
        return False
    side = out + ".inputs.json"
    if not os.path.exists(side):
        return False
    try:
        with open(side) as f:
            rec = json.load(f)
    except Exception:
        return False
    for i in inputs:
        if not os.path.exists(i):
            return False
        if rec.get(i) != _sig(i):
            return False
    return True


def _done(out: str, *inputs: str) -> None:
    """Record input signatures for _fresh."""
    with open(out + ".inputs.json", "w") as f:
        json.dump({i: _sig(i) for i in inputs if os.path.exists(i)}, f)


def _ensure_dirs(out_dir: str) -> None:
    for d in ("alignment", "gtf", "output", "logs", "benchmark"):
        os.makedirs(os.path.join(out_dir, d), exist_ok=True)


def write_bed12_batch(rb, refs, bed_path: str) -> bool:
    """BED12 export straight from the packed RecordBatch — no SAM re-parse
    (that cost ~16 s at 500k reads).  Exon segmentation is the gen_exons
    (min_exon=1, min_intron=1, max_delet=inf) case: only N ops split.
    Returns False (caller falls back to the SAM path) when the native
    formatter is unavailable or a zero-length exon edge case appears."""
    lib = get_lib()
    if lib is None or rb.n == 0:
        return False
    keep = np.nonzero((rb.flag & 0x4) == 0)[0]
    if not len(keep):
        open(bed_path, "w").close()
        return True
    n_all = rb.n
    counts_all = np.diff(rb.cig_offs)
    rep = np.repeat(np.arange(n_all), counts_all)
    op = (rb.cig_buf & 0xF).astype(np.int64)
    ln = (rb.cig_buf >> 4).astype(np.int64)
    refc = np.where((op == 0) | (op == 2) | (op == 3) | (op == 7) |
                    (op == 8), ln, 0)
    cs = np.cumsum(refc)
    base = np.concatenate([[0], cs])[rb.cig_offs[:-1]]
    within_after = cs - base[rep]
    within_before = within_after - refc
    is_n = op == 3
    nN = np.bincount(rep[is_n], minlength=n_all).astype(np.int64)
    # restrict to kept (mapped) rows
    nNk = nN[keep]
    ne = nNk + 1
    eoff = np.zeros(len(keep) + 1, np.int64)
    np.cumsum(ne, out=eoff[1:])
    tot = int(eoff[-1])
    starts_rel = np.zeros(tot, np.int64)
    ends_rel = np.zeros(tot, np.int64)
    # ragged scatter of N-op boundaries (N ops are in record order)
    kept_mask = np.zeros(n_all, bool)
    kept_mask[keep] = True
    kept_row = np.full(n_all, -1, np.int64)
    kept_row[keep] = np.arange(len(keep))
    idxN = np.nonzero(is_n & kept_mask[rep])[0]
    rN_rec = kept_row[rep[idxN]]
    cumN = np.zeros(len(keep), np.int64)
    np.cumsum(nNk, out=cumN[0:])  # cumN[i] = #N in rows 0..i
    startN = cumN - nNk
    rank = np.arange(len(idxN)) - startN[rN_rec]
    starts_rel[eoff[rN_rec] + rank + 1] = within_after[idxN]
    ends_rel[eoff[rN_rec] + rank] = within_before[idxN]
    last_op = rb.cig_offs[1:] - 1
    tot_ref = np.where(counts_all > 0, within_after[np.maximum(last_op, 0)],
                       0)
    ends_rel[eoff[1:] - 1] = tot_ref[keep]
    sizes = ends_rel - starts_rel
    if (sizes <= 0).any():
        return False     # zero-length exon quirk: use the reference path
    nb = _str_blob([rb.qname[i] for i in keep], len(keep))
    cb = _str_blob([r[0] for r in refs], len(refs))
    if nb is None or cb is None:
        return False
    start0 = rb.pos[keep].astype(np.int64)
    end = start0 + tot_ref[keep]
    cap = int(nb[1][-1] + len(keep) * 140 + tot * 26) + 64
    out = np.empty(cap, np.uint8)
    wrote = int(lib.format_bed12_c(
        nb[0], nb[1], cb[0], cb[1],
        np.ascontiguousarray(rb.tid[keep], np.int32),
        np.ascontiguousarray((rb.flag[keep] & 0x10) != 0).view(np.uint8),
        np.ascontiguousarray(rb.mapq[keep], np.int32),
        start0, end, sizes, starts_rel, eoff,
        len(keep), out, cap))
    if wrote < 0:
        return False
    with open(bed_path, "wb") as f:
        f.write(out[:wrote].tobytes())
    return True


def write_bed12(sam_path: str, bed_path: str) -> None:
    """BED12 export of spliced alignments (the `bedtools bamtobed -bed12`
    role, reference Snakefile:63)."""
    refs, _, records = open_alignments(sam_path)
    with open(bed_path, "w") as f:
        for r in records:
            if r.is_unmapped:
                continue
            s, e, _ = gen_exons(r, 1, 1, 1 << 30)  # strand comes from r.is_rev
            chrom = refs[r.tid][0]
            start0 = int(s[0]) - 1
            end = int(e[-1])
            sizes = ",".join(str(int(b - a + 1)) for a, b in zip(s, e)) + ","
            starts = ",".join(str(int(a - 1) - start0) for a in s) + ","
            strand = "-" if r.is_rev else "+"
            f.write(f"{chrom}\t{start0}\t{end}\t{r.qname}\t{r.mapq}\t{strand}"
                    f"\t{start0}\t{end}\t0\t{len(s)}\t{sizes}\t{starts}\n")


class _Tee:
    """Writes to the log file and whatever sys.stderr currently is."""

    def __init__(self, f):
        self.f = f

    def write(self, s):
        sys.stderr.write(s)
        if not self.f.closed:
            self.f.write(s)

    def flush(self):
        sys.stderr.flush()
        if not self.f.closed:
            self.f.flush()


def _concat(paths, out_path: str) -> None:
    with open(out_path, "wb") as out:
        for p in paths:
            with open(p, "rb") as src:
                shutil.copyfileobj(src, out)  # constant-memory


def _write_config(cfg: PipelineConfig, path: str) -> None:
    """The resolved configuration (run_snakemake.py writes config.yaml into
    the out dir); skipped where pyyaml is missing, as in the reference."""
    try:
        import yaml
    except ImportError:
        return
    with open(path, "w") as f:
        yaml.safe_dump({
            "genome": {"fasta": cfg.genome_fasta, "gtf": cfg.gtf},
            "sample": {
                "long_read": {s: r.long_read
                              for s, r in cfg.samples.items()},
                "short_read": {s: {"first": r.short_first,
                                   "second": r.short_second or []}
                               for s, r in cfg.samples.items()},
            },
            "output": {"updated_gtf": cfg.updated_gtf},
            "lr2rmats": {"rm_gtf": cfg.rm_gtf, "aln_cov": cfg.aln_cov,
                         "iden_frac": cfg.iden_frac,
                         "sec_rat": cfg.sec_rat, "sup_cnt": cfg.sup_cnt,
                         "split_trans": "-s" if cfg.split_trans else "",
                         "full_level": cfg.full_level},
        }, f, default_flow_style=False)


def _load_index(genome, cache: str, shared: bool) -> MinimizerIndex:
    """MinimizerIndex.build_or_load; with `shared` (processes of one group
    starting together) under an exclusive lock on `<cache>.lock`, so one
    process builds and writes the cache and the others then load it."""
    if not shared:
        return MinimizerIndex.build_or_load(genome, cache)
    try:
        lock = open(cache + ".lock", "a")
    except OSError:   # read-only directory: no process writes the cache
        return MinimizerIndex.build_or_load(genome, cache)
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return MinimizerIndex.build_or_load(genome, cache)


def _process_device(device, pid: int) -> torch.device:
    """The device of process `pid`: a bare "cuda" becomes
    cuda:{pid % device_count}."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", pid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _local_devices(device: torch.device, devices, nproc: int
                   ) -> List[torch.device]:
    """The devices the chain launches split over: `devices` when given
    (a one-process run only), else [device]."""
    if devices is None:
        return [device]
    if nproc > 1:
        raise ValueError("devices= is for a one-process run; under a "
                         "process group each process takes one card")
    return [resolve_device(d) for d in devices]


def run_pipeline(cfg: PipelineConfig,
                 align_params: Optional[AlignParams] = None,
                 device="cuda", devices: Optional[Sequence] = None) -> str:
    """Run the full two-pass pipeline; returns the updated.gtf path.
    Outputs are byte-identical to the reference's run_pipeline on the same
    inputs, for any number of processes and cards.  `devices`: the cards
    a one-process run splits its chain launches over (default
    [device])."""
    if not cfg.samples:
        raise ValueError("pipeline config has no samples (cfg.samples "
                         "is empty)")
    pid, nproc = multihost_info()
    device = _process_device(device, pid)
    devices = _local_devices(device, devices, nproc)
    out_dir = cfg.out_dir
    _ensure_dirs(out_dir)
    A = lambda *p: os.path.join(out_dir, *p)  # noqa: E731
    psuf = f".p{pid}" if nproc > 1 else ""

    # tee stage logs into logs/pipeline.log (Snakemake `log:` role)
    _logf = open(A("logs", f"pipeline{psuf}.log"), "a")
    set_log_stream(_Tee(_logf))
    filter_pool = None
    try:
        log("pipeline", "process %d/%d on %s", pid, nproc, device)
        if len(devices) > 1:
            log("pipeline", "chain launches split over %s",
                ", ".join(map(str, devices)))
        if pid == 0:   # the out dir may be shared by the group
            _write_config(cfg, A("config.yaml"))

        # ---- stage: genome (the index is built with the aligner)
        with Timer("stage/index", benchmark_file=A(
                "benchmark", f"index{psuf}.benchmark.txt")):
            genome = Genome.load(cfg.genome_fasta)
            aligner: Optional[TorchBatchAligner] = None

        updated_gtf = (cfg.updated_gtf if os.path.isabs(cfg.updated_gtf)
                       else A(cfg.updated_gtf))
        os.makedirs(os.path.dirname(updated_gtf) or ".", exist_ok=True)
        # the sample shard this process owns (round-robin; all of them in
        # a single-process run)
        all_items = list(cfg.samples.items())
        own = owned_indices(len(all_items))
        items = [all_items[i] for i in own]
        # header source for the final unique-gtf: the first sample's SAM,
        # which process 0 writes (it owns sample 0)
        first_sam = A("alignment", f"{all_items[0][0]}.minimap.sam")

        # ---- phase 1: alignment per sample, sequential on the device; the
        # rb-direct filter of sample N runs on a background thread while
        # sample N+1 aligns, and phase 2 joins it first
        filter_pool = ThreadPoolExecutor(1)
        filter_futs: Dict[str, Future] = {}

        def _rb_filter(sample: str, sam_path: str, hdr: bytes, body):
            filtered = A("alignment", f"{sample}.filtered.sam")
            with Timer(f"stage/filter[{sample}]",
                       benchmark_file=A("benchmark",
                                        f"{sample}.novel_gtf.benchmark.txt")):
                cmd_filter(None, filtered,
                           FilterParams(cfg.aln_cov, cfg.iden_frac,
                                        cfg.sec_rat),
                           rm_gtf=cfg.rm_gtf or None, out_format="sam",
                           data=np.concatenate(
                               [np.frombuffer(hdr, np.uint8),
                                np.asarray(body, np.uint8)]))
                _done(filtered, sam_path)

        for sample, reads in items:
            sam_path = A("alignment", f"{sample}.minimap.sam")
            bed_path = A("alignment", f"{sample}.minimap.bed")
            if not _fresh(sam_path, cfg.genome_fasta, reads.long_read):
                with Timer(f"stage/align[{sample}]",
                           benchmark_file=A(
                               "benchmark",
                               f"{sample}.minimap.benchmark.txt")):
                    if aligner is None:
                        if getattr(cfg, "index_shards", 1) > 1:
                            # hash-range-sharded table (host lookups)
                            idx = ShardedMinimizerIndex.build(
                                genome, cfg.index_shards)
                        else:
                            cache = cfg.index_cache or (cfg.genome_fasta +
                                                        ".tmmi.npz")
                            idx = _load_index(genome, cache, nproc > 1)
                        aligner = TorchBatchAligner(genome, align_params,
                                                    index=idx, device=device,
                                                    devices=devices)
                        aligner.warmup_chain_shapes()
                    long_reads = read_fasta(reads.long_read)
                    rb = aligner.align_seqset_packed(long_reads)
                    st = aligner.stats
                    log("align", "%s: phases seed=%.1fs dispatch=%.1fs "
                        "build=%.1fs polish=%.1fs; kernel launches chain=%d"
                        " shift_dp=%d junction=%d; junction gaps on %s: %d "
                        "(%d placed); device seed lookups: %d", sample,
                        st.get("seed_s", 0.0), st.get("dispatch_s", 0.0),
                        st.get("build_s", 0.0), st.get("polish_s", 0.0),
                        st["chain_kernel_launches"],
                        st["shift_dp_kernel_launches"],
                        st["junction_kernel_launches"], device,
                        st["junction_gaps"], st["junction_found"],
                        st["seed_lookup_calls"])
                    hdr = sam_header(aligner.refs).encode()
                    body = rb.emit_sam_array(aligner.refs)
                    with open(sam_path + ".tmp", "wb") as f:
                        f.write(hdr)
                        f.write(memoryview(body))
                    os.replace(sam_path + ".tmp", sam_path)
                    _done(sam_path, cfg.genome_fasta, reads.long_read)
                    log("align", "%s: %d alignment records", sample, rb.n)
                    # rb-direct filter from the in-memory SAM bytes
                    if get_lib() is not None:
                        filter_futs[sample] = filter_pool.submit(
                            _rb_filter, sample, sam_path, hdr, body)
                    del body
                    if not write_bed12_batch(rb, aligner.refs, bed_path):
                        write_bed12(sam_path, bed_path)
                    _done(bed_path, sam_path)
            if not _fresh(bed_path, sam_path):
                write_bed12(sam_path, bed_path)
                _done(bed_path, sam_path)

        # ---- phase 2: per-sample host stages, parallel over samples
        def _sample_stages(sample: str, reads) -> str:
            sam_path = A("alignment", f"{sample}.minimap.sam")
            fut = filter_futs.pop(sample, None)
            if fut is not None:
                fut.result()
            # ---- stage: sam_novel_gtf (filter + pass-1 update-gtf)
            filtered_bam = A("alignment", f"{sample}.filtered.sam")
            sam_novel = A("gtf", f"{sample}_sam_novel.gtf")
            if not _fresh(filtered_bam, sam_path):
                with Timer(f"stage/filter[{sample}]",
                           benchmark_file=A(
                               "benchmark",
                               f"{sample}.novel_gtf.benchmark.txt")):
                    cmd_filter(sam_path, filtered_bam,
                               FilterParams(cfg.aln_cov, cfg.iden_frac,
                                            cfg.sec_rat),
                               rm_gtf=cfg.rm_gtf or None, out_format="sam")
                    _done(filtered_bam, sam_path)
            input_cache: dict = {}
            if not _fresh(sam_novel, filtered_bam, cfg.gtf):
                with Timer(f"stage/update_gtf_pass1[{sample}]",
                           benchmark_file=A(
                               "benchmark",
                               f"{sample}_new_gtf.benchmark.txt")):
                    ugp = UpdateGtfParams(full_level=cfg.full_level)
                    cmd_update_gtf(filtered_bam, cfg.gtf, ugp,
                                   out_path=sam_novel,
                                   input_cache=input_cache)
                    _done(sam_novel, filtered_bam, cfg.gtf)

            # ---- stage: new_gtf (merge + sort)
            new_gtf = A("gtf", f"{sample}_new.gtf")
            if not _fresh(new_gtf, cfg.gtf, sam_novel):
                tmp = A("gtf", f"{sample}_tmp.gtf")
                _concat((cfg.gtf, sam_novel), tmp)
                sort_gtf_file(tmp, new_gtf)
                os.remove(tmp)
                _done(new_gtf, cfg.gtf, sam_novel)

            # ---- stage: sj_count (star_map role)
            sj_tab = A("alignment", f"{sample}.STARSJ.out.tab")
            short_inputs = [p for p in (reads.short_first,
                                        reads.short_second) if p]
            if short_inputs and not _fresh(sj_tab, new_gtf, *short_inputs):
                with Timer(f"stage/sj_count[{sample}]",
                           benchmark_file=A("benchmark",
                                            f"{sample}.star.benchmark.txt")):
                    cname = ChrNames(genome.names)
                    merged = read_anno_trans(new_gtf, cname)
                    if reads.short_first and reads.short_second:
                        read_sets = [(read_fasta(reads.short_first),
                                      read_fasta(reads.short_second))]
                    else:
                        read_sets = [read_fasta(p) for p in short_inputs]
                    sj = count_junction_support(genome, [merged], read_sets,
                                                device=device)
                    with open(sj_tab, "w") as f:
                        write_sj_star(sj, cname, f)
                    _done(sj_tab, new_gtf, *short_inputs)

            # ---- stage: gtf_novel_gtf (pass-2 update-gtf)
            gtf_novel = A("gtf", f"{sample}_gtf_novel.gtf")
            sj_inputs = [sj_tab] if short_inputs else []
            if not _fresh(gtf_novel, filtered_bam, cfg.gtf, *sj_inputs):
                with Timer(f"stage/update_gtf_pass2[{sample}]",
                           benchmark_file=A(
                               "benchmark",
                               f"{sample}_gtf_novel_gtf.benchmark.txt")):
                    ugp = UpdateGtfParams(full_level=cfg.full_level,
                                          split_trans=cfg.split_trans,
                                          min_sj_cnt=cfg.sup_cnt)
                    cmd_update_gtf(
                        filtered_bam, cfg.gtf, ugp,
                        sj_path=sj_tab if short_inputs else None,
                        out_path=gtf_novel,
                        summary=A("output", f"{sample}.summary.txt"),
                        bam_gtf=A("output", f"{sample}.bam.gtf"),
                        bam_detail=A("output", f"{sample}.detail.txt"),
                        known_gtf=A("output", f"{sample}.known.gtf"),
                        novel_gtf=A("output", f"{sample}.novel.gtf"),
                        unrecog_gtf=A("output", f"{sample}.unrecog.gtf"),
                        exon_bed=A("output", f"{sample}.novel_exon.bed"),
                        input_cache=input_cache)
                    _done(gtf_novel, filtered_bam, cfg.gtf, *sj_inputs)
            input_cache.clear()
            return gtf_novel

        if len(items) > 1 and (cfg.jobs or 0) != 1:
            n_jobs = cfg.jobs or min(4, len(items))
            with ThreadPoolExecutor(n_jobs) as pool:
                gtf_novel_paths: List[str] = list(pool.map(
                    lambda sr: _sample_stages(sr[0], sr[1]), items))
        else:
            gtf_novel_paths = [_sample_stages(s, r) for s, r in items]
        filter_pool.shutdown(wait=True)
        log("pipeline", "process %d/%d: kernel launches %s", pid, nproc,
            json.dumps(_build.LAUNCHES, sort_keys=True))

        # ---- cross-process gather: every process contributes its samples'
        # pass-2 GTFs (the reference's shared-filesystem `cat`); process 0
        # then holds all of them in global sample order
        if nproc > 1:
            payloads = []
            for gi, p in zip(own, gtf_novel_paths):
                with open(p, "rb") as f:
                    payloads.append((gi, f.read()))
            t0 = time.perf_counter()
            gathered = gather_indexed_payloads(payloads)
            log("pipeline", "process %d/%d: gathered %d pass-2 GTFs, %d "
                "payload bytes, in %.4f s", pid, nproc, len(gathered),
                sum(len(b) for b in gathered.values()),
                time.perf_counter() - t0)
            if pid != 0:
                barrier("final_merge")
                log("pipeline", "process %d/%d: sample shard done; updated "
                    "GTF written by process 0", pid, nproc)
                return updated_gtf
            gtf_novel_paths = []
            for gi, (sample, _) in enumerate(all_items):
                p = A("gtf", f"{sample}_gtf_novel.gathered.gtf")
                with open(p, "wb") as f:
                    f.write(gathered[gi])
                gtf_novel_paths.append(p)

        # ---- stage: update_gtf (cross-sample merge)
        with Timer("stage/final_merge",
                   benchmark_file=A("benchmark", "update_gtf.benchmark.txt")):
            tmp = A("gtf", "tmp.gtf")
            _concat(gtf_novel_paths, tmp)
            uniq_gtf = A("gtf", "uniq.gtf")
            cmd_unique_gtf(tmp, UpdateGtfParams(input_mode="gtf"),
                           hdr_bam=first_sam, out_path=uniq_gtf)
            _concat((cfg.gtf, uniq_gtf), tmp)
            sort_gtf_file(tmp, updated_gtf)
            os.remove(tmp)
        if nproc > 1:
            barrier("final_merge")
        log("pipeline", "updated GTF written to %s", updated_gtf)
        return updated_gtf
    finally:
        # the log stream is process-global and the rb-filter worker may
        # still be in flight: restore and join even when a stage raises
        if filter_pool is not None:
            filter_pool.shutdown(wait=True)
        set_log_stream(None)
        _logf.close()
