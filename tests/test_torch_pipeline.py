"""Port pipeline (lr2rmats_tpu_torch/pipeline/) against the reference's on
the CPU: `run_pipeline(device="cpu")` with the three device switches on
gives byte-identical outputs (output/*, the SAM, BED and junction table) to
the reference's `run_pipeline(use_tpu=False)` on a small
scripts/simulate.py dataset, also with jax blocked; the port's CLI runs
and resumes.  The on-card run is in tests/test_torch_kernels.py.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from lr2rmats_tpu.pipeline.config import PipelineConfig
from lr2rmats_tpu.pipeline.stages import run_pipeline as ref_pipeline
from lr2rmats_tpu_torch.pipeline.stages import run_pipeline
from tests.test_torch_chain import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_kernels import (pipeline_config, pipeline_outputs,
                                      sim_dataset)

REPO = pathlib.Path(__file__).resolve().parents[1]
SWITCHES = ("LR2RMATS_DEVICE_JUNCTIONS", "LR2RMATS_DEVICE_SEED",
            "LR2RMATS_DEVICE_SJCOUNT")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The simulated data and the reference pipeline's outputs."""
    root = tmp_path_factory.mktemp("pipe")
    data = sim_dataset(root / "data")
    ref_pipeline(pipeline_config(data, root / "ref"), use_tpu=False)
    return root, data, pipeline_outputs(root / "ref")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env.update({v: "1" for v in SWITCHES})
    return env


def test_pipeline_matches_reference(dataset, monkeypatch):
    root, data, want = dataset
    for var in SWITCHES:
        monkeypatch.setenv(var, "1")
    out = root / "port"
    assert run_pipeline(pipeline_config(data, out), device="cpu") == \
        str(out / "output" / "updated.gtf")
    got = pipeline_outputs(out)
    assert len(got) == 11 and got == want
    assert b"\t" in want["alignment/samp1.STARSJ.out.tab"]
    log = (out / "logs" / "pipeline.log").read_text()
    assert "junction gaps on cpu" in log and "(device)" in log


def test_pipeline_runs_with_jax_blocked(dataset, tmp_path):
    root, data, want = dataset
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        from tests.test_torch_kernels import pipeline_config
        from lr2rmats_tpu_torch.pipeline.stages import run_pipeline
        run_pipeline(pipeline_config({str(data)!r}, {str(tmp_path)!r}),
                     device="cpu")
        assert not [m for m in sys.modules if m.startswith("jax")
                    and sys.modules[m] is not None]
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
    assert pipeline_outputs(tmp_path) == want


def test_cli_runs_and_resumes(dataset, tmp_path):
    _, data, want = dataset
    cmd = [sys.executable, "-m", "lr2rmats_tpu_torch", "run", "--cpu",
           "--genome", f"{data}/genome.fa", "--gtf", f"{data}/anno.gtf",
           "--long-read", f"{data}/long.fa",
           "--short-read-1", f"{data}/short_1.fa",
           "--short-read-2", f"{data}/short_2.fa", "--out-dir", str(tmp_path)]
    runs = [subprocess.run(cmd, cwd=str(REPO), env=_env(),
                           capture_output=True, text=True, timeout=300)
            for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    assert "stage/align" in runs[0].stderr
    assert "stage/align" not in runs[1].stderr
    assert pipeline_outputs(tmp_path) == want


def test_cli_refuses_multi_process(tmp_path, capsys):
    from lr2rmats_tpu_torch.pipeline.cli import main
    rc = main(["run", "--cpu", "--num-processes", "2", "--out-dir",
               str(tmp_path)])
    assert rc == 1
    assert "needs --coordinator and --process-id" in capsys.readouterr().err


def test_cli_delegates_host_subcommands(capsys):
    from lr2rmats_tpu_torch.pipeline.cli import main
    assert main(["version"]) == 0
    assert capsys.readouterr().out.strip()


def test_run_pipeline_needs_samples(tmp_path):
    with pytest.raises(ValueError, match="no samples"):
        run_pipeline(PipelineConfig(out_dir=str(tmp_path)), device="cpu")
