"""The port stands alone: importing nngparareal_torch, every module in it,
and chip_smoke.py pulls in neither jax nor nngparareal_tpu, and the CUDA
kernel's module imports on a machine with no card and no nvcc, and on
one with no matplotlib (the GPU machine has none: reporting.py imports it
only inside its plotting functions).

Checked in a fresh interpreter, since this test process has jax loaded.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    if os.environ.get("PROBE_NO_MATPLOTLIB"):
        sys.modules["matplotlib"] = None  # any import of it raises
    import nngparareal_torch
    names = [m.name for m in pkgutil.walk_packages(
        nngparareal_torch.__path__, "nngparareal_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    from nngparareal_torch.ops import rk_cuda
    assert rk_cuda.rk_fanout.launches == 0
    assert {"nngparareal_torch.ops." + m for m in (
        "ds32", "ds_lift", "rk_ds", "rk_cuda_ds")} <= set(names)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "nngparareal_tpu"))
    print(len(names), bad)
""")


def _run(env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(env_extra)
    return subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("env_extra", [
    {},
    # no CUDA toolkit anywhere: nvcc cannot be found, the import still works
    {"PATH": "/usr/bin:/bin", "CUDA_HOME": "/nonexistent"},
    # no matplotlib: every module, the reporting layer's included, imports
    {"PROBE_NO_MATPLOTLIB": "1"},
], ids=["default", "no-nvcc", "no-matplotlib"])
def test_port_imports_without_jax(env_extra):
    proc = _run(env_extra)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 20
    assert bad.strip() == "[]", bad


def test_sources_name_no_jax_import():
    """No import of jax or nngparareal_tpu anywhere in the port's files."""
    roots = [os.path.join(REPO, "nngparareal_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    hits = []
    for root in roots:
        files = ([root] if root.endswith(".py") else
                 [os.path.join(d, f) for d, _, fs in os.walk(root)
                  for f in fs if f.endswith(".py")])
        for path in files:
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    s = line.strip()
                    if s.startswith(("import ", "from ")) and any(
                            w in s.split()[1].split(".")[0]
                            for w in ("jax", "nngparareal_tpu")):
                        hits.append(f"{path}:{i}: {s}")
    assert not hits, hits
