"""Multi-scale training schedule: resolution pyramid, scale sampling, level
unlocking, insert-large episode timing, loss weights.

A copy of msgs/ms/schedule.py (pure Python, no JAX there either), kept
here so the port imports nothing of the JAX package. The logic, and the
order in which `sample_level` consumes its `random.Random`, are the JAX
package's, so the same seed gives the same levels:

  - train scales = [2^i for i ≤ max_reso_pow]
  - sampling: 75% finest scale, else uniform over unlocked levels, preferring
    the least-trained level when insert_large is on
  - unlock schedule (insert_large): base_iter=1000; for max_reso_pow 5/6/7,
    at base+10/20/30 unlock level groups [[2,3],[4,5],[6,7]] and schedule
    insert episodes targeting levels [2,4,6]
  - loss weight 1.0 at level 0, 0.1 otherwise
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional


def train_scales(max_reso_pow: int) -> List[int]:
    return [2 ** i for i in range(max_reso_pow + 1)]


def loss_weight(lvl: int) -> float:
    return 1.0 if lvl == 0 else 0.1


@dataclass
class MsSchedule:
    max_reso_pow: int
    ms_train: bool = False
    insert_large: bool = False
    base_iter: int = 1000
    # Iteration at which multi-scale sampling (and the occ/dc LRs) kick in
    # (reference train.py:62,153,197 — default 1 = from the start).
    ms_from_iter: int = 1
    # Fine-tail: past this iteration, sample ONLY the finest level (0 =
    # never). Framework extension beyond the reference schedule, motivated
    # by the measured ms28k trajectory (BASELINE.md r5): past the
    # densification window, continued 0.1-weighted coarse iterations
    # monotonically trade x1 PSNR for coarse-scale gains; a fine-only tail
    # recovers x1 while filter_large keeps the coarse aggregates untouched
    # by fine renders.
    fine_tail_from: int = 0
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def __post_init__(self):
        self.scales = train_scales(self.max_reso_pow)
        self.reso_lvls = len(self.scales)
        self.reso_iterations = [0] * self.reso_lvls
        # insert_large unlock plan (train.py:92-111).
        self.inc_reso_at: List[int] = []
        self.unlock_groups: List[List[int]] = []
        self.insert_targets: List[int] = []
        if self.insert_large:
            # Exact reference plans (train.py:92-111). Note the quirks kept
            # deliberately: level 1 is never trained under insert_large, and
            # for max_reso_pow=5 the third group [5] is unreachable (only
            # two inc_reso_at entries gate the mask).
            plans = {
                5: ([10, 20], [[2, 3], [4], [5]], [2, 4]),
                6: ([10, 20, 30], [[2, 3], [4, 5], [6]], [2, 4, 6]),
                7: ([10, 20, 30], [[2, 3], [4, 5], [6, 7]], [2, 4, 6]),
            }
            if self.max_reso_pow in plans:
                offs, groups, targets = plans[self.max_reso_pow]
            else:
                offs = [10]
                groups = [[l for l in range(2, self.reso_lvls)]]
                targets = [min(2, self.reso_lvls - 1)]
            self.inc_reso_at = [self.base_iter + o for o in offs]
            self.unlock_groups = groups
            self.insert_targets = targets

    def insert_target_for(self, iteration: int) -> Optional[int]:
        """If this iteration is an insert episode, return its target level
        (train.py:269: `iteration in inc_reso_at`)."""
        if iteration in self.inc_reso_at:
            return self.insert_targets[self.inc_reso_at.index(iteration)]
        return None

    def _unlocked_levels(self, iteration: int) -> List[int]:
        """Level pool for sampling: strict `iteration > inc_reso_at` mask
        accumulates unlock groups onto [0] (train.py:171-176)."""
        lvls = [0]
        for at, group in zip(self.inc_reso_at, self.unlock_groups):
            if iteration > at:
                lvls += [l for l in group if l < self.reso_lvls]
        return lvls

    def sample_level(self, iteration: int) -> int:
        """75% finest; else uniform over unlocked, preferring least-trained
        when insert_large; all levels when plain ms_train (train.py:151-194).
        Called when the viewpoint stack refills (once per level-epoch)."""
        if not self.ms_train or iteration < self.ms_from_iter:
            return 0
        if self.fine_tail_from and iteration >= self.fine_tail_from:
            return 0
        if self.rng.random() < 0.75:
            return 0
        if self.insert_large:
            pool = self._unlocked_levels(iteration)
            min_it = min(self.reso_iterations[l] for l in pool)
            least = [l for l in pool if self.reso_iterations[l] == min_it]
            return self.rng.choice(least)
        return self.rng.randint(0, self.reso_lvls - 1)

    def count_iteration(self, lvl: int):
        self.reso_iterations[lvl] += 1
