"""Nothing the benchmark runs imports JAX or the JAX package, and the
command refuses to run without a card."""
import json
import os
import subprocess
import sys

import pytest

from portbench import spec

REPO = str(spec.REPO)


def _py(code, **env):
    e = dict(os.environ, **env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_module_after_importing_everything():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import portbench\n"
        "for m in pkgutil.iter_modules(portbench.__path__):\n"
        "    importlib.import_module('portbench.' + m.name)\n"
        "from portbench import spec, harness\n"
        "for f in (spec.HERE / 'metrics').glob('*.py'):\n"
        "    spec.reader(f.stem)\n"
        "from portbench import ics\n"
        "for f in ics.HERE.glob('[!_]*.py'):\n"
        "    ics.builder(f.stem)\n"
        "import sphax_torch.__main__, sphax_torch.problems\n"
        "import sphax_torch.integrate.rungs, sphax_torch.physics.wengine\n"
        "from portbench.run import loaded_forbidden\n"
        "print(json.dumps(loaded_forbidden()))\n")
    out = _py(code)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_check_compares_whole_top_level_names():
    code = ("import sys, types\n"
            "sys.modules['sphax_torch_x'] = types.ModuleType('x')\n"
            "sys.modules['jaxlib.xla'] = types.ModuleType('x')\n"
            "from portbench.run import loaded_forbidden\n"
            "print(loaded_forbidden())\n")
    out = _py(code)
    assert out.stdout.strip() == "['jaxlib']", out.stderr


def test_refuses_without_a_card():
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from portbench import run\n"
            "sys.exit(run.main(['--workload', 'turb256.fixed', '--seed', "
            "'1', '--seconds', '1', '--trace', '0']))\n")
    out = _py(code)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.gpu
def test_a_small_cell_on_the_card():
    """On a card: a small turbulence box through the CUDA kernels comes
    out correct and reports every end-to-end metric of its cell."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench import run

    cell = spec.cell("turb256.fixed")
    res, _ = run.execute(cell, 4242, 1.0, 0, torch.device("cuda"),
                         override=dict(n=48, episode_chunks=1))
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
