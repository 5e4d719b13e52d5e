"""The port's ``verify_reference`` harness against a stand-in upstream
assembler written into ``tmp_path`` (the real checkout has been empty so
far), as ``tests/test_verify_reference.py`` does for the JAX package; the
helpers are held equal to the reference's."""

import json
import os
import textwrap

import pytest
import torch

import genome_assembler_tpu.verify_reference as jax_vr
from genome_assembler_tpu_torch import cli
from genome_assembler_tpu_torch import verify_reference as vr
from genome_assembler_tpu.utils.dna import decode_seq
from genome_assembler_tpu.utils.simulate import simulate_genome, simulate_reads
from test_verify_reference import FAKE_REFERENCE

torch.set_num_threads(1)


@pytest.fixture
def fake_reference(tmp_path):
    ref = tmp_path / "reference"
    (ref / "tests" / "data").mkdir(parents=True)
    (ref / "assembler.py").write_text(textwrap.dedent(FAKE_REFERENCE))
    (ref / "README.md").write_text("stand-in\n")
    (ref / "tests" / "data" / "toy.txt").write_text("ACGT\n")
    return str(ref)


@pytest.fixture
def reads_file(tmp_path):
    """A small error-free read set (2 kb, 30x), so a sweep stays short."""
    rs = simulate_reads(simulate_genome(2000, seed=3), coverage=30,
                        read_len=100, seed=4)
    path = tmp_path / "reads.txt"
    path.write_text("\n".join(decode_seq(r) for r in rs.codes) + "\n")
    return str(path)


def test_empty_checkout_reports_empty(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert vr.verify(str(empty))["status"] == "empty"
    assert vr.verify(str(tmp_path / "missing"))["status"] == "empty"


def test_helpers_equal_the_reference(fake_reference):
    assert vr.find_entry(fake_reference) == jax_vr.find_entry(fake_reference)
    assert vr.find_entry(fake_reference).endswith("assembler.py")
    assert vr.find_read_sets(fake_reference) == jax_vr.find_read_sets(
        fake_reference) == [os.path.join(fake_reference, "tests", "data",
                                         "toy.txt")]
    for text in (">a\nACGT\nTTTT\n>b\nGGGG\n", "loading...\nACGT\nGGGG\n", ""):
        assert vr.parse_contig_output(text) == jax_vr.parse_contig_output(text)


def test_verify_parity_against_the_stand_in(fake_reference, reads_file):
    report = vr.verify(fake_reference, reads_path=reads_file, k=25,
                       device="cpu")
    assert report["status"] == "pass", report
    run = report["runs"][0]
    assert run["equal"] == {"oracle": True, "torch": True}
    assert run["matched"]["torch"] == {"k": 25, "emit": "unitigs"}
    assert run["reference_contigs"] >= 1
    # the same stand-in through the JAX package: the same verdict and sweep
    want = jax_vr.verify(fake_reference, reads_path=reads_file, k=25,
                         backends=("oracle",))
    assert want["status"] == "pass"
    for key in ("n_reads", "ks_swept", "emits_swept", "reference_contigs",
                "reference_canonical_lens"):
        assert run[key] == want["runs"][0][key]


def test_verify_detects_mismatch(tmp_path, reads_file):
    ref = tmp_path / "badref"
    ref.mkdir()
    (ref / "assembler.py").write_text("print('>c0')\nprint('ACGT' * 30)\n")
    report = vr.verify(str(ref), reads_path=reads_file, ks=(25, 31),
                       device="cpu")
    assert report["status"] == "MISMATCH"
    assert report["runs"][0]["equal"] == {"oracle": False, "torch": False}


def test_cli_verify_reference(fake_reference, reads_file, tmp_path, capsys):
    assert cli.main(["verify-reference", fake_reference, "--device", "cpu",
                     "--reads", reads_file, "--ks", "25", "--emits",
                     "unitigs"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["status"] == "pass"
    assert report["runs"][0]["ks_swept"] == [25]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main(["verify-reference", str(empty)]) == 0
    assert json.loads(capsys.readouterr().out)["status"] == "empty"


def test_cmd_without_detectable_entry(tmp_path, reads_file):
    ref = tmp_path / "shref"
    ref.mkdir()
    (ref / "run.sh").write_text(f"#!/bin/sh\ncat {ref}/genome.txt\n")
    (ref / "genome.txt").write_text("ACGTACGTACGTACGTACGTACGTACGT\n")
    report = vr.verify(str(ref), cmd=f"sh {ref}/run.sh {{reads}}", k=25,
                       reads_path=reads_file, ks=(25,), backends=("oracle",))
    assert report["status"] in ("pass", "MISMATCH")
    assert report["runs"][0]["reference_contigs"] == 1


def test_default_read_set_is_cfg0_shaped(fake_reference, monkeypatch):
    """Without --reads the harness simulates CFG-0's read set, as the
    reference does (same seeds): the stand-in sees the same file."""
    seen = {}

    def fake_run(entry, reads_path, cmd=None, timeout=1800):
        with open(reads_path) as fh:
            seen["reads"] = fh.read()
        raise RuntimeError("stop here")

    for mod in (vr, jax_vr):
        monkeypatch.setattr(mod, "run_reference", fake_run)
        with pytest.raises(RuntimeError, match="stop here"):
            mod.verify(fake_reference)
        seen[mod.__name__] = seen.pop("reads")
    assert seen[vr.__name__] == seen[jax_vr.__name__]
    assert seen[vr.__name__].count("\n") == 10_000
