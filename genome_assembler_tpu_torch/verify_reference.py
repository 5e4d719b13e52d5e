"""Reference-parity harness: run the upstream assembler, diff contigs.

The port's copy of the reference package's ``verify_reference.py``, with
the backends ``oracle`` and ``torch``. The upstream assembler's checkout
has been empty so far, so the bar "bit-identical contigs vs the upstream
assembler on its test read sets" (BASELINE.md) cannot be checked yet;
this module is the ready-to-run plumbing for the day it can:

    ga-torch verify-reference PATH                     # autodetect entry
    ga-torch verify-reference PATH \
        --cmd 'python {entry} {reads}' --reads my.txt  # explicit

It locates the upstream entry script, runs it on a read set (supplied or
simulated), parses whatever contigs it prints (FASTA or plain lines), runs
the port's oracle and torch backends on the same reads, and reports
per-backend equality (up to reverse complement and contig order) as JSON.

Nothing here executes unless explicitly invoked with a populated path: the
reference is untrusted input, and running it is the operator's call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile


def find_entry(ref_path: str) -> str | None:
    """Locate the reference's most plausible CLI entry script.

    Preference order: top-level scripts whose name suggests an assembler
    entry, then any top-level script with a __main__ block, then the same
    two passes one directory level down.
    """
    names = ("assembler.py", "assemble.py", "main.py", "genome_assembler.py")

    def score(path: str) -> tuple[int, str]:
        base = os.path.basename(path)
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                text = fh.read()
        except OSError:
            return (99, path)
        has_main = "__main__" in text or "def main" in text
        if base in names:
            return (0 if has_main else 1, path)
        return (2 if has_main else 98, path)

    base_depth = os.path.normpath(ref_path).count(os.sep)
    candidates: list[str] = []
    for root, dirs, files in os.walk(ref_path):
        # true directory depth (walk order is filesystem-dependent)
        depth = os.path.normpath(root).count(os.sep) - base_depth
        if depth >= 2:
            dirs[:] = []
            continue
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        candidates.extend(
            os.path.join(root, f) for f in files if f.endswith(".py")
        )
    scored = sorted(score(c) for c in candidates)
    if not scored or scored[0][0] >= 98:
        return None
    return scored[0][1]


def find_read_sets(ref_path: str) -> list[str]:
    """The reference's bundled test read sets, if any ship with it."""
    exts = (".txt", ".fa", ".fasta", ".fastq", ".fq", ".reads")
    hits: list[str] = []
    for root, dirs, files in os.walk(ref_path):
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        for f in files:
            if f.endswith(exts) and not f.startswith("."):
                p = os.path.join(root, f)
                if 0 < os.path.getsize(p) < (1 << 26):
                    hits.append(p)
    return sorted(hits)


def run_reference(
    entry: str, reads_path: str, cmd: str | None = None, timeout: int = 1800
) -> list[str]:
    """Run the reference assembler on a reads file; return its contigs.

    cmd is a shell template with {entry}/{reads} placeholders; without one,
    tries `python entry reads` then `python entry < reads`. Output parses
    as FASTA when it starts with '>', else as one contig per line (ACGT
    lines only — logging lines are ignored).
    """
    if entry is None and cmd is None:
        raise ValueError("no entry script found and no --cmd supplied")
    attempts = (
        [cmd.format(entry=entry or "", reads=reads_path)]
        if cmd
        else [
            f"{sys.executable} {entry} {reads_path}",
            f"{sys.executable} {entry} < {reads_path}",
        ]
    )
    last_err = ""
    for attempt in attempts:
        proc = subprocess.run(
            attempt,
            shell=True,
            capture_output=True,
            text=True,
            timeout=timeout,
            cwd=(os.path.dirname(entry) or ".") if entry else ".",
        )
        if proc.returncode == 0 and proc.stdout.strip():
            return parse_contig_output(proc.stdout)
        last_err = (proc.stderr or proc.stdout)[-2000:]
    raise RuntimeError(
        f"reference run failed for every invocation form; last stderr:\n"
        f"{last_err}"
    )


def parse_contig_output(text: str) -> list[str]:
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        return []
    if any(ln.startswith(">") for ln in lines):
        contigs: list[str] = []
        current: list[str] = []
        for ln in lines:
            if ln.startswith(">"):
                if current:
                    contigs.append("".join(current))
                    current = []
            else:
                current.append(ln.upper())
        if current:
            contigs.append("".join(current))
        return contigs
    acgt = set("ACGTN")
    return [ln.upper() for ln in lines if set(ln.upper()) <= acgt]


def verify(
    ref_path: str,
    *,
    reads_path: str | None = None,
    cmd: str | None = None,
    k: int = 25,
    ks: tuple[int, ...] | None = None,
    emits: tuple[str, ...] = ("unitigs", "euler"),
    min_count: int = 1,
    backends: tuple[str, ...] = ("oracle", "torch"),
    use_ref_data: bool = False,
    device: str = "cuda",
) -> dict:
    """Full parity check; returns the report dict (also printed by the CLI).

    The reference's contig style and k are unknown a priori (the reference
    spells contigs from ``eulerian_path``, SURVEY.md §3.1/§3.4, but may emit
    unitigs; its default k is unrecorded), so the harness SWEEPS both
    emission modes x a small k set per read set and reports the first
    matching combination per backend (VERDICT r2 item 4: succeed unattended
    on a populated mount, no operator flags). ``k`` is tried first;
    ``ks=None`` defaults to (k, 25, 31, 21) deduplicated. ``device`` is
    where the torch backend runs.
    """
    import numpy as np

    from .cli import read_sequences
    from .host.traverse import canonicalize_contigs, contigs_equal
    from .models.oracle import assemble_from_counts, count_canonical_dict
    from .utils.config import AssemblyConfig
    from .utils.dna import decode_seq, encode_seq
    from .utils.simulate import simulate_genome, simulate_reads

    if not os.path.isdir(ref_path) or not any(os.scandir(ref_path)):
        return {
            "status": "empty",
            "detail": f"{ref_path} is empty or missing: nothing to verify",
        }
    entry = find_entry(ref_path)
    if entry is None and cmd is None:
        return {
            "status": "no-entry",
            "detail": "could not locate a runnable entry script; rerun with "
            "--cmd 'python {entry} {reads}'",
            "read_sets_found": find_read_sets(ref_path),
        }

    read_files: list[str] = []
    tmp = None
    if reads_path:
        read_files = [reads_path]
    elif use_ref_data:
        read_files = find_read_sets(ref_path)
    if not read_files:
        # simulate a CFG-0-shaped set (BASELINE.md config 0)
        genome = simulate_genome(10_000, seed=1010)
        rs = simulate_reads(genome, coverage=100, read_len=100, seed=1011)
        tmp = tempfile.NamedTemporaryFile(
            "w", suffix=".txt", delete=False, prefix="ga_verify_"
        )
        for row in rs.codes:
            tmp.write(decode_seq(row) + "\n")
        tmp.close()
        read_files = [tmp.name]

    if ks is None:
        ks = tuple(dict.fromkeys((k, 25, 31, 21)))

    runs = []
    all_equal = True
    try:
        for rf in read_files:
            ref_contigs = run_reference(entry, rf, cmd)
            seqs = read_sequences(rf)
            lens = {len(s) for s in seqs}
            min_len = min(lens)
            ks_run = [kk for kk in ks if kk < min_len] or [min(ks)]

            # Sweep (k, emit) per backend; first match wins. Per-k state
            # (oracle count dict / torch codes) is computed once and reused
            # across the two emission modes.
            comparison: dict[str, bool] = {}
            matched: dict[str, dict | None] = {}
            n_ours: dict[str, int] = {}
            for name in backends:
                if name == "torch" and len(lens) != 1:
                    continue  # fixed-width batch required
                comparison[name] = False
                matched[name] = None
                for kk in ks_run:
                    cfg = AssemblyConfig(
                        k=kk, min_count=min_count,
                        read_len=len(seqs[0]) if len(lens) == 1 else 100,
                    )
                    if name == "oracle":
                        counts = count_canonical_dict(seqs, kk)
                        candidates = {
                            em: assemble_from_counts(counts, cfg, em)
                            for em in emits
                        }
                    else:
                        from .models.pipeline import assemble_torch

                        codes = np.stack(
                            [encode_seq(s, mask_invalid=True) for s in seqs]
                        )
                        candidates = {
                            em: assemble_torch(codes, cfg, emit=em,
                                               device=device)
                            for em in emits
                        }
                    for em, got in candidates.items():
                        n_ours[name] = len(got)
                        if contigs_equal(ref_contigs, got):
                            comparison[name] = True
                            matched[name] = {"k": kk, "emit": em}
                            n_ours[name] = len(got)
                            break
                    if comparison[name]:
                        break
            all_equal = all_equal and all(comparison.values())
            runs.append(
                {
                    "reads": rf,
                    "n_reads": len(seqs),
                    "ks_swept": ks_run,
                    "emits_swept": list(emits),
                    "reference_contigs": len(ref_contigs),
                    "our_contigs": n_ours,
                    "equal": comparison,
                    "matched": matched,
                    "reference_canonical_lens": [
                        len(c) for c in canonicalize_contigs(ref_contigs)
                    ][:20],
                }
            )
    finally:
        if tmp is not None:
            os.unlink(tmp.name)
    return {
        "status": "pass" if all_equal else "MISMATCH",
        "entry": entry,
        "k": k,
        "runs": runs,
    }


def cmd_verify_reference(args) -> int:
    ks = (
        tuple(int(s) for s in args.ks.split(","))
        if getattr(args, "ks", None)
        else None
    )
    emits = (
        tuple(args.emits.split(","))
        if getattr(args, "emits", None)
        else ("unitigs", "euler")
    )
    report = verify(
        args.path,
        reads_path=args.reads,
        cmd=args.cmd,
        k=args.k,
        ks=ks,
        emits=emits,
        min_count=args.min_count,
        use_ref_data=args.use_ref_data,
        device=getattr(args, "device", "cuda"),
    )
    print(json.dumps(report, indent=2))
    return 0 if report["status"] in ("pass", "empty") else 1
