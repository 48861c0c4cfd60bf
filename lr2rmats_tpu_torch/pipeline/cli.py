"""Command line of the port: `python -m lr2rmats_tpu_torch <subcommand>`.

The parser is the reference's (lr2rmats_tpu/pipeline/cli.py build_parser),
so every subcommand and option is the same.  Every subcommand but `run` is
host code and is handed to the reference's `main`; `run` drives the port's
pipeline (pipeline/stages.py) on the card, or on the CPU with `--cpu`
(the plain PyTorch versions of the kernels).  The device switches are the
reference's environment variables: LR2RMATS_DEVICE_JUNCTIONS=1,
LR2RMATS_DEVICE_SEED=1, LR2RMATS_DEVICE_SJCOUNT=1.
"""

from __future__ import annotations

import sys

from lr2rmats_tpu import PROG
from lr2rmats_tpu.pipeline.cli import build_parser
from lr2rmats_tpu.pipeline.cli import main as reference_main
from lr2rmats_tpu.pipeline.config import PipelineConfig, SampleReads


def _config(args) -> PipelineConfig:
    """PipelineConfig from the `run` options (reference cli.py:296-319)."""
    if args.config:
        cfg = PipelineConfig.from_yaml(args.config)
    elif args.long_read_list:
        cfg = PipelineConfig.from_read_lists(
            args.genome, args.gtf, args.long_read_list, args.short_read_list)
    else:
        cfg = PipelineConfig(genome_fasta=args.genome, gtf=args.gtf)
        cfg.samples["samp1"] = SampleReads(
            args.long_read, args.short_read_1, args.short_read_2)
    cfg.rm_gtf = args.rm_gtf or cfg.rm_gtf
    # explicit flags win over the config.yaml (or the reference defaults)
    for knob in ("aln_cov", "iden_frac", "sec_rat", "sup_cnt", "split_trans",
                 "full_level"):
        v = getattr(args, knob)
        if v is not None:
            setattr(cfg, knob, v)
    cfg.out_dir = args.out_dir
    cfg.jobs = args.jobs
    cfg.index_shards = args.index_shards
    return cfg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd != "run":
        return reference_main(argv)
    from .stages import run_pipeline
    try:
        if args.num_processes and args.num_processes > 1:
            raise ValueError(
                "--num-processes > 1: lr2rmats_tpu_torch runs one process "
                "on one device; multi-process runs wait for the port's "
                "multi-GPU slice (ROADMAP.md queue 1)")
        run_pipeline(_config(args), device="cpu" if args.cpu else "cuda")
    except FileNotFoundError as e:
        print(f'[{PROG}] Can not open "{e.filename or e}"', file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"[{PROG}] {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
