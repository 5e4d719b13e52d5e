"""Start the ranks of a multi-process run on this machine.

The reference has no launcher: JAX's coordinator brings its processes
together. ``torch.distributed`` wants every rank started with torch's
launch variables, which ``torchrun`` does; ``spawn`` does the same for
one machine from Python, so that tests, ``chip_smoke.py`` and the
acceptance runners need no other tool:

    from genome_assembler_tpu_torch.parallel.launch import spawn
    res = spawn(4, ["assemble", "--reads", "reads.txt", "--backend", "dist",
                    "--devices", "4", "--out", "contigs.fa"], device="cuda")

runs ``python -m genome_assembler_tpu_torch.cli assemble ... --device
cuda`` four times with ``RANK`` 0..3, ``LOCAL_RANK`` the same (a card a
rank), ``WORLD_SIZE`` 4, ``MASTER_ADDR`` 127.0.0.1 and a free
``MASTER_PORT``. The same with ``torchrun``:

    torchrun --nproc-per-node 4 -m genome_assembler_tpu_torch.cli assemble ...
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np

CLI_ENTRY = ("-m", "genome_assembler_tpu_torch.cli")
# Launches tried when rank 0's store finds its free port taken meanwhile
# (another socket may grab it between the probe and the rank's start)
PORT_ATTEMPTS = 3


@dataclass
class SpawnResult:
    """What the ranks left: a rank that was killed has a negative code."""

    returncodes: list[int]
    stdout: list[str]
    stderr: list[str]
    timed_out: bool
    seconds: float

    @property
    def ok(self) -> bool:
        return not self.timed_out and all(rc == 0 for rc in self.returncodes)

    def describe(self, tail: int = 2000) -> str:
        """The exit codes, and the end of the error output of every rank
        that did not exit 0: the message of a failed run."""
        lines = [f"exit codes {self.returncodes}"
                 + (" (time limit reached)" if self.timed_out else "")]
        for rank, (rc, err) in enumerate(zip(self.returncodes, self.stderr)):
            if rc != 0:
                lines.append(f"--- rank {rank} (exit {rc}):\n{err[-tail:]}")
        return "\n".join(lines)


def write_reads_lines(path: str, codes) -> None:
    """[B, L] uint8 read codes -> a lines file (one read a line, N for an
    ambiguous base) that every rank loads; written in bulk, so a
    full-size read set takes seconds."""
    codes = np.asarray(codes, dtype=np.uint8)
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
    text = np.empty((codes.shape[0], codes.shape[1] + 1), dtype=np.uint8)
    text[:, :-1] = letters[np.minimum(codes, 4)]
    text[:, -1] = ord("\n")
    text.tofile(path)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(
    world_size: int,
    argv: Sequence[str],
    *,
    device: str,
    timeout_s: float,
    entry: Sequence[str] = CLI_ENTRY,
    cwd: str | None = None,
) -> SpawnResult:
    """Run ``python *entry *argv --device DEVICE`` as ``world_size`` ranks
    and wait for them.

    device: ``"cuda"`` (rank r binds card r, NCCL) or ``"cpu"`` (gloo);
    it is appended to ``argv`` as ``--device``. entry: the interpreter's
    arguments before ``argv`` (default: the ``ga-torch`` command line). On
    the first rank that exits non-zero, or once ``timeout_s`` have passed,
    every rank still running is killed. A launch whose store port was
    taken before rank 0 could listen on it (``EADDRINUSE``) starts again
    on another port, up to PORT_ATTEMPTS launches. Returns the exit codes
    and the outputs; no child is left running.
    """
    if world_size < 1:
        raise ValueError(f"spawn: world_size {world_size}")
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_root] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(WORLD_SIZE=str(world_size), MASTER_ADDR="127.0.0.1")
    if device == "cpu":
        # the ranks share this machine's cores
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // world_size)))
    cmd = [sys.executable, *entry, *argv, "--device", device]
    for _ in range(PORT_ATTEMPTS):
        res = _run_ranks(cmd, dict(env, MASTER_PORT=str(free_port())),
                         world_size, timeout_s, cwd)
        if res.ok or not any("EADDRINUSE" in err for err in res.stderr):
            break
    return res


def _run_ranks(cmd, env, world_size: int, timeout_s: float,
               cwd: str | None) -> SpawnResult:
    """One launch of ``world_size`` ranks of ``cmd`` (see ``spawn``)."""
    t0 = time.perf_counter()
    procs, files = [], []
    timed_out = False
    try:
        for rank in range(world_size):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(
                cmd, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                stdin=subprocess.DEVNULL, stdout=out, stderr=err, cwd=cwd,
            ))
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            if time.perf_counter() - t0 > timeout_s:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    texts = []
    for pair in files:
        both = []
        for fh in pair:
            fh.seek(0)
            both.append(fh.read().decode(errors="replace"))
            fh.close()
        texts.append(both)
    return SpawnResult(
        returncodes=[p.returncode for p in procs],
        stdout=[t[0] for t in texts],
        stderr=[t[1] for t in texts],
        timed_out=timed_out,
        seconds=time.perf_counter() - t0,
    )
