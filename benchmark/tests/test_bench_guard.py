"""The run's check on loaded modules compares whole top-level names, and
a run of the benchmark on the CPU loads none of them."""

import os
import subprocess
import sys

from conftest import BENCH

from harness import guard


def test_whole_top_level_names():
    names = ["genome_assembler_tpu_torch", "genome_assembler_tpu_torch.ops",
             "jax_like", "jaxtyping", "flaxen", "torch", "numpy",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "genome_assembler_tpu", "genome_assembler_tpu.ops.kmer_pallas"]
    assert guard.forbidden_modules(names) == sorted([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "genome_assembler_tpu", "genome_assembler_tpu.ops.kmer_pallas"])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import sys
sys.path[:0] = [{BENCH!r}, {os.path.dirname(BENCH)!r}, {os.path.join(BENCH, 'tests')!r}]
from conftest import tiny_cell
from harness import guard, runner
out, _ = runner.run(tiny_cell(), 12, 0.2, True, "cpu")
assert out["correct"], out
print(guard.forbidden_modules(list(sys.modules)))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
