"""End-to-end two-pass pipeline of the port (the Snakemake DAG role).

`run_pipeline` is the reference's (lr2rmats_tpu/pipeline/stages.py) with the
port's device layer: the align stage runs `TorchBatchAligner` on `device`
(its junction backend and seed lookup chosen by LR2RMATS_DEVICE_JUNCTIONS
and LR2RMATS_DEVICE_SEED) and the sj_count stage runs the port's
`count_junction_support` (its device counter chosen by
LR2RMATS_DEVICE_SJCOUNT).  The stage graph, the artifact checkpoints and
every host stage are the reference's own functions:

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
while the others wait at a barrier.  The port keeps one device per
process, so, as in the reference with one local device, unique-gtf runs
without the device gather of its candidates (`device_gather=False`).

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
from typing import Dict, List, Optional

import numpy as np
import torch

from lr2rmats_tpu.align.aligner import AlignParams
from lr2rmats_tpu.index.minimizer import MinimizerIndex
from lr2rmats_tpu.io.fasta import Genome, read_fasta
from lr2rmats_tpu.io.gtf import ChrNames, read_anno_trans
from lr2rmats_tpu.io.sam import sam_header
from lr2rmats_tpu.io.sj import write_sj_star
from lr2rmats_tpu.native import get_lib
from lr2rmats_tpu.pipeline.commands import (cmd_filter, cmd_unique_gtf,
                                            cmd_update_gtf)
from lr2rmats_tpu.pipeline.config import PipelineConfig
from lr2rmats_tpu.pipeline.stages import (_done, _ensure_dirs, _fresh,
                                          write_bed12, write_bed12_batch)
from lr2rmats_tpu.report.sortgtf import sort_gtf_file
from lr2rmats_tpu.transcript.filter import FilterParams
from lr2rmats_tpu.transcript.model import UpdateGtfParams
from lr2rmats_tpu.utils import Timer, log
from lr2rmats_tpu.utils.log import set_log_stream

from ..align.batch import TorchBatchAligner
from ..device import resolve_device
from ..junctions.sjcount import count_junction_support
from ..ops import _build
from ..parallel.distributed import (barrier, gather_indexed_payloads,
                                    multihost_info, owned_indices)
from ..parallel.shard_index import ShardedMinimizerIndex


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


def run_pipeline(cfg: PipelineConfig,
                 align_params: Optional[AlignParams] = None,
                 device="cuda") -> str:
    """Run the full two-pass pipeline; returns the updated.gtf path.
    Outputs are byte-identical to the reference's run_pipeline on the same
    inputs, for any number of processes."""
    if not cfg.samples:
        raise ValueError("pipeline config has no samples (cfg.samples "
                         "is empty)")
    pid, nproc = multihost_info()
    device = _process_device(device, pid)
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
                                                    index=idx, device=device)
                        aligner.warmup_chain_shapes()
                    long_reads = read_fasta(reads.long_read)
                    rb = aligner.align_seqset_packed(long_reads)
                    st = aligner.stats
                    log("align", "%s: phases seed=%.1fs dispatch=%.1fs "
                        "build=%.1fs polish=%.1fs; kernel launches chain=%d"
                        " shift_dp=%d combine=%d; junction gaps on %s: %d "
                        "(%d placed); device seed lookups: %d", sample,
                        st.get("seed_s", 0.0), st.get("dispatch_s", 0.0),
                        st.get("build_s", 0.0), st.get("polish_s", 0.0),
                        st["chain_kernel_launches"],
                        st["shift_dp_kernel_launches"],
                        st["combine_kernel_launches"], device,
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

        # ---- stage: update_gtf (cross-sample merge); one device per
        # process, so no device gather of the candidates
        with Timer("stage/final_merge",
                   benchmark_file=A("benchmark", "update_gtf.benchmark.txt")):
            tmp = A("gtf", "tmp.gtf")
            _concat(gtf_novel_paths, tmp)
            uniq_gtf = A("gtf", "uniq.gtf")
            cmd_unique_gtf(tmp, UpdateGtfParams(input_mode="gtf"),
                           hdr_bam=first_sam, out_path=uniq_gtf,
                           device_gather=False)
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
