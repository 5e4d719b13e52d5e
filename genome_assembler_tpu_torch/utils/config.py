"""Assembly configuration (SURVEY.md §5 "Config / flag system").

Capability parity: the reference exposes k and the coverage threshold as CLI
args/constants (SURVEY.md §5; reference mount empty — survey reconstruction).
The TPU build centralises every static-shape capacity knob here because XLA
traces fixed shapes (SURVEY.md §7 "hard parts": capacity-bounded buffers).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    """All tunables of one assembly run.

    Pipeline semantics:
      k:            k-mer length (edges); nodes are (k-1)-mers. Odd k strongly
                    recommended so no k-mer is its own reverse complement.
      min_count:    drop k-mers whose *canonical* multiplicity is < min_count
                    (coverage filter; reference C4). 0 = automatic: pick the
                    valley of the coverage histogram between the error peak
                    (multiplicity 1-2) and the true-coverage peak.
      tip_len:      remove dead-end unitig chains of <= tip_len k-mer edges
                    (spelling tip_len + k - 1 bases; reference C6).
                    Default 2k edges.
      bubble_len:   collapse parallel unitig arms of <= bubble_len k-mer
                    edges (reference C7). Default 2k edges.

    Static-shape capacities (TPU build only):
      read_len:     fixed read length L; every read batch is [B, L] codes.
      batch_reads:  reads per device batch B fed to the extraction kernel.

    Distribution:
      mesh_shape:   logical device mesh, e.g. {'d': 8}. The k-mer table is
                    sharded by hash prefix across the flattened mesh
                    (SURVEY.md §5 long-context design).
    """

    k: int = 31
    min_count: int = 1
    tip_len: int | None = None
    bubble_len: int | None = None
    read_len: int = 100
    batch_reads: int = 262_144
    mesh_shape: tuple[tuple[str, int], ...] = (("d", 1),)

    def __post_init__(self) -> None:
        if not 2 <= self.k <= 63:
            raise ValueError(f"k must be in [2, 63], got {self.k}")
        if self.k >= self.read_len:
            raise ValueError(f"k={self.k} must be < read_len={self.read_len}")
        if self.min_count < 0:
            raise ValueError(
                f"min_count must be >= 1 (or 0 for auto), got {self.min_count}"
            )

    @property
    def resolved_tip_len(self) -> int:
        return self.tip_len if self.tip_len is not None else 2 * self.k

    @property
    def resolved_bubble_len(self) -> int:
        return self.bubble_len if self.bubble_len is not None else 2 * self.k

    @property
    def windows_per_read(self) -> int:
        return self.read_len - self.k + 1

    @property
    def num_devices(self) -> int:
        return math.prod(n for _, n in self.mesh_shape)
