"""End to end: ``assemble_torch(device="cpu")`` vs ``assemble_tpu`` and
``assemble_oracle`` (contigs bit-equal), the port's independence from
JAX, and no CPU fallback when CUDA is requested. Streaming, checkpoints
and the CLI are in test_torch_streaming.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genome_assembler_tpu.models import pipeline as jax_pipeline
from genome_assembler_tpu.models.oracle import assemble_oracle
from genome_assembler_tpu.utils.config import AssemblyConfig
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch.models import pipeline
from genome_assembler_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# xdist workers share the cores: one intra-op thread each keeps the plain
# versions' many small CPU ops from oversubscribing them
torch.set_num_threads(1)

# name: (genome_len, coverage, k, error_rate, min_count, circular, n_rate)
CASES = {
    "cfg0_scaled": (4000, 100, 25, 0.0, 1, False, 0.0),
    "cfg1_min5": (4000, 100, 31, 0.01, 5, False, 0.0),
    "cfg1_auto": (4000, 100, 31, 0.01, 0, False, 0.0),
    "circular": (1500, 30, 21, 0.0, 1, True, 0.0),
    "n_bases": (3000, 40, 25, 0.0, 1, False, 0.003),
    "even_k": (2000, 30, 24, 0.0, 1, False, 0.0),
    "two_limb_k41": (3000, 40, 41, 0.0, 1, False, 0.0),
}


def _reads(genome_len, coverage, k, error_rate, circular, n_rate, seed=11):
    genome = simulate_genome(genome_len, seed=seed)
    rs = simulate_reads(genome, coverage=coverage, read_len=100,
                        seed=seed + 1, error_rate=error_rate, tile_k=k,
                        circular=circular)
    reads = rs.codes.copy()
    if n_rate:
        reads[np.random.default_rng(seed).random(reads.shape) < n_rate] = 4
    return reads, genome


@pytest.mark.parametrize("emit", ["unitigs", "euler"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_assemble_tpu_and_oracle(case, emit):
    glen, cov, k, err, mc, circ, n_rate = CASES[case]
    reads, _ = _reads(glen, cov, k, err, circ, n_rate)
    cfg = AssemblyConfig(k=k, min_count=mc, read_len=100)
    got = pipeline.assemble_torch(reads, cfg, device="cpu", emit=emit)
    assert got == jax_pipeline.assemble_tpu(reads, cfg, emit=emit)
    assert got == assemble_oracle(reads, cfg, emit=emit)
    assert got


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "from genome_assembler_tpu_torch.models.pipeline import assemble_torch\n"
        "from genome_assembler_tpu_torch import cli, reference\n"
        "from genome_assembler_tpu_torch.host import dbg\n"
        "g = reference.simulate_genome(1500, seed=3)\n"
        "rs = reference.simulate_reads(g, coverage=20, read_len=60, seed=4)\n"
        "cfg = reference.AssemblyConfig(k=21, read_len=60)\n"
        "contigs = assemble_torch(rs.codes, cfg, device='cpu')\n"
        "assert contigs == reference.assemble_oracle(rs.codes, cfg)\n"
        "from genome_assembler_tpu_torch.parallel import mesh, pipeline\n"
        "from genome_assembler_tpu_torch.ops import hash_torch, superkmer_torch\n"
        "m = mesh.build_mesh(4, devices=['cpu'])\n"
        "for mini in (None, 11):\n"
        "    assert pipeline.assemble_distributed(\n"
        "        rs.codes, cfg, m, minimizer_len=mini) == contigs\n"
        "assert pipeline.assemble_distributed_sharded(rs.codes, cfg, m) == contigs\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_request_never_falls_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback path needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    reads, _ = _reads(1500, 20, 21, 0.0, False, 0.0)
    cfg = AssemblyConfig(k=21, read_len=100)
    with pytest.raises(RuntimeError, match="no fallback"):
        pipeline.assemble_torch(reads, cfg, device="cuda")
    out = tmp_path / "c.fa"
    rc = cli.main(["assemble", "--genome-len", "1500", "--coverage", "20",
                   "-k", "21", "--out", str(out)])  # --device defaults to cuda
    assert rc == 2 and not out.exists()
