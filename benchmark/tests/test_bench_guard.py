"""The look for JAX compares whole top-level names: the port passes,
the JAX package and the JAX stack fail; and importing every module of
the benchmark loads none of them."""

import subprocess
import sys

from benchmark.guard import jax_modules

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_compared_whole():
    names = ["octvr_tpu_torch", "octvr_tpu_torch.stitch.mapper", "jaxtyping", "octvr_tpu_tools", "numpy"]
    assert jax_modules(names) == []
    bad = ["octvr_tpu", "octvr_tpu.stitch", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert jax_modules(names + bad) == sorted(bad)


def test_benchmark_modules_load_no_jax():
    code = (
        "import importlib, pkgutil, sys, benchmark, benchmark.reference\n"
        "for pkg in (benchmark, benchmark.reference):\n"
        "    for m in pkgutil.iter_modules(pkg.__path__, pkg.__name__ + '.'):\n"
        "        if not m.name.startswith('benchmark.tests'):\n"
        "            importlib.import_module(m.name)\n"
        "import octvr_tpu_torch.stitch, octvr_tpu_torch.runtime\n"
        "from benchmark.guard import jax_modules\n"
        "print(sorted(n for n in sys.modules if n.startswith('benchmark')))\n"
        "sys.exit(1 if jax_modules() else 0)\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "benchmark.run" in p.stdout and "benchmark.reference.stitch" in p.stdout


def test_reference_imports_nothing_of_the_port():
    code = (
        "import sys, benchmark.reference.stitch, benchmark.reference.offline, benchmark.check\n"
        "sys.exit(1 if [n for n in sys.modules if n.split('.')[0] in ('octvr_tpu', 'octvr_tpu_torch', 'jax')] else 0)\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
