"""The port's numpy fallbacks: with LR2RMATS_NO_NATIVE=1 the host paths run
without the native library and must give the bytes of the native run.

Each case runs in processes of its own (the loader reads the switch once):
the port with the library, the port without it, and the reference without
it, as the reference's own cases do (tests/test_capabilities.py
`test_native_and_fallback_outputs_identical`, tests/test_pipeline_e2e.py
`test_filter_sam_stdout_convention`).  The port's processes run with jax
and the reference package blocked.  Cases: `update-gtf` with every output,
`filter` to SAM and to BAM, and the SAM of the host BatchAligner.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from lr2rmats_tpu_torch import synth
from lr2rmats_tpu_torch.pipeline.cli import main as port_main

REPO = pathlib.Path(__file__).resolve().parents[1]
SIM = dict(genome_mb=0.3, genes=6, long_reads=80, short_pairs=300)
BLOCK = ("import runpy, sys; sys.modules['jax'] = None; "
         "sys.modules['lr2rmats_tpu'] = None; ")

# arms: (name, package, no_native)
ARMS = (("port native", "lr2rmats_tpu_torch", False),
        ("port fallback", "lr2rmats_tpu_torch", True),
        ("reference fallback", "lr2rmats_tpu", True))

_ALIGN = """
import sys
pkg = sys.argv[1]
if pkg == "lr2rmats_tpu_torch":
    sys.modules["jax"] = None
    sys.modules["lr2rmats_tpu"] = None
    from lr2rmats_tpu_torch.align.batch import BatchAligner
    from lr2rmats_tpu_torch.io.fasta import Genome, read_fasta
    from lr2rmats_tpu_torch.native import have_native
    kw = {}
else:
    from lr2rmats_tpu.align.batch import BatchAligner
    from lr2rmats_tpu.io.fasta import Genome, read_fasta
    from lr2rmats_tpu.native import have_native
    kw = {"backend": "host"}
al = BatchAligner(Genome.load(sys.argv[2]), **kw)
sam = al.align_seqset_packed(read_fasta(sys.argv[3])).emit_sam(al.refs)
open(sys.argv[4], "wb").write(sam)
print("native" if have_native() else "numpy")
"""


def _env(no_native):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    env.pop("LR2RMATS_NO_NATIVE", None)
    if no_native:
        env["LR2RMATS_NO_NATIVE"] = "1"
    return env


def _cli(pkg, no_native, argv):
    """`python -m <pkg> <argv>` in a process of its own."""
    head = BLOCK if pkg == "lr2rmats_tpu_torch" else "import runpy, sys; "
    script = (head + f"sys.argv = ['{pkg}'] + sys.argv[1:]; "
              f"runpy.run_module('{pkg}', run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", script, *argv],
                         cwd=str(REPO), env=_env(no_native),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A small scripts/simulate.py dataset and the port's `run --cpu` of
    it (native): (data dir, run dir)."""
    root = tmp_path_factory.mktemp("fallback")
    d = root / "data"
    synth.simulate_dataset(str(d), **SIM)
    out = root / "run"
    assert port_main(["run", "--cpu", "--genome", f"{d}/genome.fa",
                      "--gtf", f"{d}/anno.gtf", "--long-read",
                      f"{d}/long.fa", "--short-read-1", f"{d}/short_1.fa",
                      "--short-read-2", f"{d}/short_2.fa",
                      "--out-dir", str(out)]) == 0
    return d, out


def _outputs(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _same_in_every_arm(outs):
    (first, want), *rest = outs.items()
    for name, got in rest:
        assert sorted(got) == sorted(want), (name, first)
        for f in want:
            assert got[f] == want[f], (name, first, f)
    assert any(want.values())


def test_update_gtf_fallback_matches_native(data, tmp_path):
    d, run = data
    aln = run / "alignment"
    outs = {}
    for name, pkg, no_native in ARMS:
        o = tmp_path / name.replace(" ", "_")
        o.mkdir()
        _cli(pkg, no_native, [
            "update-gtf", str(aln / "samp1.filtered.sam"), f"{d}/anno.gtf",
            "-j", str(aln / "samp1.STARSJ.out.tab"), "-l", "3", "-s",
            "-o", str(o / "upd.gtf"), "-k", str(o / "known.gtf"),
            "-v", str(o / "novel.gtf"), "-u", str(o / "unrecog.gtf"),
            "-a", str(o / "bam.gtf"), "-A", str(o / "detail.txt"),
            "-y", str(o / "summary.txt"), "-E", str(o / "exon.bed")])
        outs[name] = _outputs(o)
    _same_in_every_arm(outs)
    assert len(outs["port native"]) == 8


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_filter_fallback_matches_native(data, tmp_path, fmt):
    d, run = data
    sam = run / "alignment" / "samp1.minimap.sam"
    outs = {}
    for name, pkg, no_native in ARMS:
        o = tmp_path / name.replace(" ", "_")
        o.mkdir()
        argv = ["filter", str(sam), "-o", str(o / f"f.{fmt}")]
        if fmt == "sam":
            argv.insert(2, "--sam")
        else:
            argv[2:2] = ["-r", f"{d}/anno.gtf"]
        _cli(pkg, no_native, argv)
        outs[name] = _outputs(o)
    _same_in_every_arm(outs)


def test_host_aligner_sam_fallback_matches_native(data, tmp_path):
    d, _ = data
    outs, loaded = {}, {}
    for name, pkg, no_native in ARMS:
        o = tmp_path / name.replace(" ", "_")
        o.mkdir()
        res = subprocess.run(
            [sys.executable, "-c", _ALIGN, pkg, f"{d}/genome.fa",
             f"{d}/long.fa", str(o / "aln.sam")], cwd=str(REPO),
            env=_env(no_native), capture_output=True, text=True,
            timeout=600)
        assert res.returncode == 0, res.stderr[-2000:]
        loaded[name] = res.stdout.split()[-1]
        outs[name] = _outputs(o)
    assert loaded == {"port native": "native", "port fallback": "numpy",
                      "reference fallback": "numpy"}
    _same_in_every_arm(outs)
    assert outs["port native"]["aln.sam"].count(b"\n") >= SIM["long_reads"]
