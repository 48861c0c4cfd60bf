"""The port's native loader (lr2rmats_tpu_torch/native/lib.py) and the
device junction backend's need of it.

  * many processes starting the loader at once on an empty build
    directory all load the library: the build is under an flock, to a
    temporary name of each process, and a process that waited loads the
    finished file;
  * junction_backend="device" raises where the library is unavailable,
    instead of running the host extension in its place.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lr2rmats_tpu_torch import synth
from lr2rmats_tpu_torch.align import batch as batch_mod
from lr2rmats_tpu_torch.align.batch import BatchAligner, TorchBatchAligner

REPO = pathlib.Path(__file__).resolve().parents[1]

_LOAD = """
import sys
import lr2rmats_tpu_torch.native.lib as L
L._SO = sys.argv[1]
lib = L.get_lib()
assert lib is not None, "no library"
assert lib.extract_minimizers_batch_c.restype is not None
print("loaded")
"""


def test_six_processes_load_the_library_built_once(tmp_path):
    so = tmp_path / "build" / "liblrio.so"
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(so)],
                              cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err[-2000:]
    # one library, no temporary left behind
    assert sorted(f.name for f in so.parent.iterdir()) == \
        ["liblrio.so", "liblrio.so.lock"]


def test_a_library_older_than_its_source_is_stale(tmp_path):
    """The loader rebuilds a library whose file is older than csrc/lrio.cpp
    (or missing), and keeps one that is newer."""
    from lr2rmats_tpu_torch.native import lib as L
    src = pathlib.Path(L._SRC)
    so = tmp_path / "liblrio.so"
    assert L._stale(str(so), str(src))
    so.write_bytes(b"")
    t = src.stat().st_mtime
    os.utime(so, (t - 10, t - 10))
    assert L._stale(str(so), str(src))
    os.utime(so, (t + 10, t + 10))
    assert not L._stale(str(so), str(src))
    assert L._ensure_built(str(src), str(so))     # up to date: no build


@pytest.fixture
def small_genome():
    return synth.build_genome(200_000, np.random.default_rng(3))


def test_device_junctions_raise_without_native_lib(monkeypatch, small_genome):
    monkeypatch.setattr(batch_mod, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="needs the native library"):
        TorchBatchAligner(small_genome, device="cpu",
                          junction_backend="device")
    # the host junction backend and the host aligner keep their numpy paths
    TorchBatchAligner(small_genome, device="cpu", junction_backend="host")
    BatchAligner(small_genome)


def test_device_junction_build_raises_without_native_lib(monkeypatch,
                                                          small_genome):
    """Where the library goes missing after construction, the build of a
    batch raises rather than extending on the host."""
    al = TorchBatchAligner(small_genome, device="cpu",
                           junction_backend="device")
    monkeypatch.setattr(batch_mod, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="needs the native library"):
        al._build_packed([], [], [], [])


def test_no_native_env_makes_device_junctions_raise(small_genome):
    """LR2RMATS_NO_NATIVE=1 in a fresh process: the real loader answers
    None and the device junction backend refuses to start."""
    script = (
        "import numpy as np\n"
        "from lr2rmats_tpu_torch import synth\n"
        "from lr2rmats_tpu_torch.align.batch import TorchBatchAligner\n"
        "from lr2rmats_tpu_torch.native import get_lib\n"
        "assert get_lib() is None\n"
        "g = synth.build_genome(100_000, np.random.default_rng(0))\n"
        "try:\n"
        "    TorchBatchAligner(g, device='cpu', junction_backend='device')\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                         env={**os.environ, "LR2RMATS_NO_NATIVE": "1"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("raised junction_backend='device' needs")
