"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level module names; a run without a card prints no result."""

import json
import os
import shutil
import subprocess
import sys

from cardbench import run

LOAD_ALL = """
import json, pkgutil, importlib, sys
import cardbench
from cardbench import run
for m in pkgutil.walk_packages(cardbench.__path__, "cardbench."):
    importlib.import_module(m.name)
man = json.load(open("BENCHMARK.json"))
for m in man["end_to_end"] + man["per_layer"]:
    run.reader(m["name"])
for kind in ("align", "sr_count"):
    run.entry_class(kind)
# what the entries import at set-up
import lr2rmats_tpu_torch.align.batch, lr2rmats_tpu_torch.io.fasta
import lr2rmats_tpu_torch.junctions.sjcount, lr2rmats_tpu_torch.ops._build
print(json.dumps({"forbidden": run.forbidden_modules(),
                  "torch_port": "lr2rmats_tpu_torch" in sys.modules}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_fresh_interpreter_loads_nothing_forbidden():
    res = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=run.ROOT,
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"forbidden": [], "torch_port": True}


def test_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        for name in ("lr2rmats_tpu_torch_extra", "jaxlike", "flaxen.x"):
            sys.modules[name] = sys
        assert run.forbidden_modules() == []
        sys.modules["lr2rmats_tpu.ops"] = sys
        assert run.forbidden_modules() == ["lr2rmats_tpu"]
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax", "lr2rmats_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "cardbench.run", "--workload",
         "chr21_ont_deep", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        env=_env(), timeout=300)


def test_no_card_no_result():
    res = _run(run.ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "card" in res.stderr


def test_bare_checkout_no_result(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "cardbench"),
                    tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
