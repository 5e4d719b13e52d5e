"""The port stands on its own: no file of ``genome_assembler_tpu_torch``
(nor ``chip_smoke.py``) imports ``jax`` or any module of
``genome_assembler_tpu``, at top level or lazily, and a process that
assembles through the port's library and CLI entry points ends with
neither in ``sys.modules``."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "genome_assembler_tpu_torch")
FOREIGN = ("jax", "genome_assembler_tpu")

SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
) + ["chip_smoke.py", "bench_torch.py",
     os.path.join("tools", "run_large_torch.py"),
     os.path.join("tools", "probe_kmer_extract.py"),
     os.path.join("tools", "probe_count_insert.py"),
     os.path.join("tools", "probe_upload.py"),
     os.path.join("tools", "probe_mesh.py")]


def is_foreign(name: str) -> bool:
    """``name`` is jax, the JAX package, or a module inside either.
    (``genome_assembler_tpu_torch`` starts with the same letters and is
    not.)"""
    return any(name == f or name.startswith(f + ".") for f in FOREIGN)


def foreign_imports(path: str) -> list[str]:
    """Every import of a foreign module anywhere in the file's syntax
    tree: module level, inside functions, under ``if`` or ``try``."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [f"{path}:{node.lineno}: {n}" for n in names if is_foreign(n)]
    return found


def test_the_name_test_is_exact():
    assert is_foreign("jax") and is_foreign("jax.numpy")
    assert is_foreign("genome_assembler_tpu")
    assert is_foreign("genome_assembler_tpu.utils.dna")
    assert not is_foreign("genome_assembler_tpu_torch")
    assert not is_foreign("genome_assembler_tpu_torch.utils.dna")
    assert not is_foreign("jaxtyping")


def test_every_port_module_is_walked():
    rel = {s.replace(os.sep, "/") for s in SOURCES}
    for must in ("genome_assembler_tpu_torch/cli.py",
                 "genome_assembler_tpu_torch/host/dbg.py",
                 "genome_assembler_tpu_torch/host/simplify_arrays.py",
                 "genome_assembler_tpu_torch/host/traverse.py",
                 "genome_assembler_tpu_torch/models/oracle.py",
                 "genome_assembler_tpu_torch/models/acceptance.py",
                 "genome_assembler_tpu_torch/verify_reference.py",
                 "genome_assembler_tpu_torch/utils/upload.py",
                 "genome_assembler_tpu_torch/utils/metrics.py",
                 "tools/probe_upload.py",
                 "bench_torch.py",
                 "tools/run_large_torch.py",
                 "tools/probe_mesh.py",
                 "genome_assembler_tpu_torch/parallel/mesh.py",
                 "genome_assembler_tpu_torch/parallel/launch.py",
                 "genome_assembler_tpu_torch/models/acceptance_rank.py",
                 "genome_assembler_tpu_torch/models/pipeline.py",
                 "genome_assembler_tpu_torch/ops/kmer_ref.py",
                 "genome_assembler_tpu_torch/parallel/compress.py",
                 "genome_assembler_tpu_torch/utils/dna.py",
                 "genome_assembler_tpu_torch/utils/simulate.py",
                 "genome_assembler_tpu_torch/utils/io_native.py"):
        assert must in rel


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_nothing_foreign(source):
    assert foreign_imports(os.path.join(REPO, source)) == []


def test_the_walk_finds_a_lazy_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "def f():\n"
        "    try:\n"
        "        from genome_assembler_tpu.utils import dna\n"
        "    except ImportError:\n"
        "        import jax.numpy as jnp\n"
        "    import genome_assembler_tpu_torch.utils.dna\n"
    )
    found = foreign_imports(str(bad))
    assert len(found) == 2
    assert found[0].endswith(":3: genome_assembler_tpu.utils")
    assert found[1].endswith(":5: jax.numpy")


def _run(code: str, cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


CHECK_MODULES = (
    "import sys\n"
    "foreign = sorted(\n"
    "    m for m in sys.modules\n"
    "    if m == 'jax' or m.startswith('jax.')\n"
    "    or m == 'genome_assembler_tpu'\n"
    "    or m.startswith('genome_assembler_tpu.'))\n"
    "assert not foreign, foreign\n"
    "print('ok')\n"
)


def test_library_run_loads_nothing_foreign(tmp_path):
    code = (
        "import genome_assembler_tpu_torch\n"
        "from genome_assembler_tpu_torch.models.oracle import assemble_oracle\n"
        "from genome_assembler_tpu_torch.models.pipeline import assemble_torch\n"
        "from genome_assembler_tpu_torch.host.traverse import contigs_equal\n"
        "from genome_assembler_tpu_torch.utils.config import AssemblyConfig\n"
        "from genome_assembler_tpu_torch.utils.dna import decode_seq\n"
        "from genome_assembler_tpu_torch.utils.simulate import (\n"
        "    simulate_genome, simulate_reads)\n"
        "g = simulate_genome(2000, seed=5)\n"
        "rs = simulate_reads(g, coverage=30, read_len=80, seed=6, tile_k=25)\n"
        "cfg = AssemblyConfig(k=25, read_len=80)\n"
        "contigs = assemble_torch(rs.codes, cfg, device='cpu')\n"
        "assert contigs == assemble_oracle(rs.codes, cfg)\n"
        "assert contigs_equal(contigs, [decode_seq(g)])\n"
    ) + CHECK_MODULES
    proc = _run(code, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_run_loads_nothing_foreign(tmp_path):
    code = (
        "from genome_assembler_tpu_torch import cli\n"
        "rc = cli.main(['assemble', '--device', 'cpu', '--preset', 'toy10k',\n"
        "               '--coverage', '30', '-k', '25', '--out', 'c.fa'])\n"
        "assert rc == 0, rc\n"
        "seqs = cli.read_sequences('c.fa')\n"
        "assert len(seqs) == 1 and len(seqs[0]) == 10000, [len(s) for s in seqs]\n"
        "with open('reads.txt', 'w') as fh:\n"
        "    fh.write('ACGTTGCAAGGCTTAACCGGATCGATCGGATTACA\\n' * 3)\n"
        "rc = cli.main(['assemble', '--device', 'cpu', '--reads', 'reads.txt',\n"
        "               '-k', '21', '--out', 'd.fa'])\n"
        "assert rc == 0, rc\n"
    ) + CHECK_MODULES
    proc = _run(code, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_new_commands_load_nothing_foreign(tmp_path):
    """simulate, assemble with every output and a trace, the oracle
    backend, stats, accept and verify-reference in one process."""
    code = (
        "import os\n"
        "from genome_assembler_tpu_torch import cli\n"
        "run = lambda *a: cli.main(list(a))\n"
        "assert run('simulate', '--genome-len', '2000', '--coverage', '25',\n"
        "           '--out', 'r.txt', '--genome-out', 'g.fa') == 0\n"
        "assert run('-v', 'assemble', '--reads', 'r.txt', '-k', '21',\n"
        "           '--device', 'cpu', '--out', 'c.fa', '--gfa', 'c.gfa',\n"
        "           '--stats', '--metrics-out', 'm.json', '--trace-dir',\n"
        "           'trace') == 0\n"
        "assert os.path.exists('trace/trace.json')\n"
        "assert run('assemble', '--reads', 'r.txt', '-k', '21', '--backend',\n"
        "           'oracle', '--out', 'o.fa') == 0\n"
        "assert cli.read_sequences('o.fa') == cli.read_sequences('c.fa')\n"
        "assert run('stats', 'c.fa') == 0\n"
        "assert run('accept', '0', '--scale', '0.01', '--device', 'cpu') == 0\n"
        "os.mkdir('ref')\n"
        "assert run('verify-reference', 'ref') == 0\n"
    ) + CHECK_MODULES
    proc = _run(code, str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_spawned_ranks_load_nothing_foreign(tmp_path):
    """Two gloo ranks of ``assemble --backend dist --sharded-graph``
    started by ``parallel/launch.py::spawn``: each ends with neither JAX
    nor the JAX package loaded."""
    from genome_assembler_tpu_torch.parallel.launch import spawn

    code = (
        "import sys\n"
        "from genome_assembler_tpu_torch import cli\n"
        "rc = cli.main(['assemble', '--preset', 'toy10k', '--coverage', '12',\n"
        "               '-k', '25', '--backend', 'dist', '--devices', '2',\n"
        "               '--sharded-graph', '--out', 'c.fa'] + sys.argv[1:])\n"
        "assert rc == 0, rc\n"
    ) + CHECK_MODULES
    res = spawn(2, [], device="cpu", timeout_s=300.0, entry=("-c", code),
                cwd=str(tmp_path))
    assert res.ok, res.describe()
    assert [out.strip() for out in res.stdout] == ["ok", "ok"]
    with open(tmp_path / "c.fa") as a, open(tmp_path / "c.fa.rank1") as b:
        assert a.read() == b.read()
