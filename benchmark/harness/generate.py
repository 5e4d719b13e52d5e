"""The read generator: one traffic mix on one genome, made from a seed.

The same reads as the port's ``utils/simulate.py`` makes (uniform
starts, a tiling read at a fixed stride so that every k-mer is present,
both strands, a shuffle; on several chromosomes, each at the mix's
coverage), drawn in plain ``torch`` on the card from one
``torch.Generator``, so that a run's set-up pays no host simulation. The
draws differ from the NumPy simulator's; their statistics are the same.

The configuration gives the genome: ``chromosomes``, their lengths, each
a seeded random sequence at ``gc``, and ``repeats``, families of exact
copies of one seeded random sequence (``length``, ``copies``, the last
``reverse`` of them reverse-complemented) written over it at fixed
places, spread evenly over the genome. A mix may add substitutions
(``error_rate``) and N bases (``n_rate``, code 4). The same seed gives
the same reads on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_CODE = 4  # an N base (any code above 3 is one for the port)
CHUNK_READS = 1 << 20  # reads a chunk of the per-base draws takes


def read_count(genome_length: int, coverage: float, read_len: int) -> int:
    """Reads of one chromosome: ceil(coverage x length / read length), the
    tiling reads among them (as ``utils/simulate.py`` counts them)."""
    return int(math.ceil(coverage * genome_length / read_len))


def tile_starts(genome_length: int, read_len: int, k: int) -> torch.Tensor:
    """Starts of the tiling reads: every ``min(read_len // 2, read_len - k
    + 1)`` bases, and one ending on the chromosome's last base, so that no
    k-mer start falls between two tiling reads."""
    stride = max(1, min(read_len // 2, read_len - k + 1))
    last = genome_length - read_len
    starts = torch.arange(0, last + 1, stride, dtype=torch.int64)
    if int(starts[-1]) != last:
        starts = torch.cat([starts, torch.tensor([last])])
    return starts


def random_genome(length: int, gc: float, gen: torch.Generator,
                  device) -> torch.Tensor:
    """[length] uint8 codes, A and T each (1 - gc) / 2, C and G gc / 2."""
    u = torch.rand(length, generator=gen, device=device)
    at = (1 - gc) / 2
    return ((u >= at).to(torch.uint8) + (u >= 0.5).to(torch.uint8)
            + (u >= 1 - at).to(torch.uint8))


def repeat_starts(genome_length: int, length: int, copies: int) -> list[int]:
    """Where a family's copies go: copy i centred on (i + 1/2) / copies of
    the genome."""
    return [int((i + 0.5) * genome_length / copies) - length // 2
            for i in range(copies)]


def make_genome(config: dict, gen: torch.Generator, device):
    """(the chromosomes end to end as [G] uint8 codes, their lengths)."""
    lengths = [int(n) for n in config["chromosomes"]]
    total = sum(lengths)
    gc = float(config.get("gc", 0.5))
    genome = random_genome(total, gc, gen, device)
    ends = np.cumsum(lengths)
    for fam in config.get("repeats", []):
        length, copies = int(fam["length"]), int(fam["copies"])
        seq = random_genome(length, gc, gen, device)
        for i, at in enumerate(repeat_starts(total, length, copies)):
            chrom = int(np.searchsorted(ends, at, side="right"))
            if at < 0 or at + length > ends[chrom]:
                raise ValueError(f"repeat copy at {at} leaves its chromosome")
            rc = i >= copies - int(fam.get("reverse", 0))
            genome[at: at + length] = (3 - seq).flip(0) if rc else seq
    return genome, lengths


def make_reads(config: dict, traffic: dict, seed: int,
               device="cuda") -> np.ndarray:
    """The mix's reads on the configuration's genome: a host [B, L] uint8
    array, as the port takes them."""
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    length, k = int(traffic["read_len"]), int(config["assembly"]["k"])
    genome, lengths = make_genome(config, gen, device)
    parts, offset = [], 0
    for g in lengths:
        if length > g:
            raise ValueError(f"read_len {length} > chromosome length {g}")
        tiles = tile_starts(g, length, k).to(device)
        n_random = max(read_count(g, float(traffic["coverage"]), length)
                       - len(tiles), 0)
        parts += [tiles + offset,
                  torch.randint(0, g - length + 1, (n_random,),
                                generator=gen, device=device) + offset]
        offset += g
    starts = torch.cat(parts)
    reads = genome.unfold(0, length, 1)[starts]
    del genome, starts
    flip = torch.rand(len(reads), generator=gen, device=device) < 0.5
    reads[flip] = (3 - reads[flip]).flip(1)
    del flip
    error_rate = float(traffic.get("error_rate", 0.0))
    n_rate = float(traffic.get("n_rate", 0.0))
    for lo in range(0, len(reads), CHUNK_READS):
        rows = reads[lo: lo + CHUNK_READS]
        if error_rate > 0:
            hit = torch.rand(rows.shape, generator=gen, device=device) < error_rate
            bump = torch.randint(1, 4, rows.shape, generator=gen,
                                 device=device, dtype=torch.uint8)
            rows.copy_(torch.where(hit, (rows + bump) % 4, rows))
        if n_rate > 0:
            hit = torch.rand(rows.shape, generator=gen, device=device) < n_rate
            rows.masked_fill_(hit, N_CODE)
    perm = torch.randperm(len(reads), generator=gen, device=device)
    out = reads[perm].cpu().numpy()
    del reads, perm
    return out
