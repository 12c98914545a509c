"""Import guard: the port and chip_smoke.py load neither JAX nor any module
of the JAX package."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

GUARD = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (its main() runs only as a script)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
assert "repro_torch.core.virtualization" in names
assert "repro_torch.kernels.flash_attention" in names
assert "repro_torch.kernels.mamba2_scan" in names
assert "repro_torch.models.mamba2" in names
assert "repro_torch.serving.engine" in names
for name in ("models.layers", "models.moe", "launch.serve", "core.traffic", "core.metrics",
             "tree", "optim.adamw", "optim.adafactor", "optim.schedule",
             "data.pipeline", "checkpoint.manager",
             "distributed.fault_tolerance", "launch.steps", "launch.train",
             "distributed.sharding", "distributed.compression",
             "launch.mesh", "obs", "obs.registry", "obs.selfprof",
             "obs.audit", "obs.probes", "obs.expose",
             "colocate_serve_train"):
    assert "repro_torch." + name in names, name
"""


def test_port_imports_no_jax_and_no_reference():
    code = GUARD.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")
