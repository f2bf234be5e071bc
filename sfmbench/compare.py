"""Whether the answers of a window are correct: the numbers that a cell's
limits file names, each read by ``checks/<number>.py`` from what the
cell's driver hands over, and each held to its limit.

For the bundle-adjustment traffic the driver hands over a ``BAJudging``:
the window's solves and the plain reference in float64, which works out
again, from the generated problem, the cost of each solve's start and of
the state that the program returned, and solves a sample of the starts,
drawn from the seed, itself.  Its checks:

- ``start_cost_gap``: the program's reported initial cost against the
  reference's cost of the same start (its linearization's cost);
- ``end_cost_gap``: the program's reported final cost against the
  reference's cost of the poses, points and intrinsics that it returned;
- ``solve_excess``: how far the program's answer lies above the
  reference's answer in cost, as a share of the cost that the reference's
  solve removed, (cost(program) - cost(reference)) / (cost(start) -
  cost(reference)); 0 where the two reach the same cost, 1 for an answer no
  better than its start.

Costs are gauge-free, so the answers' poses and points are judged by the
cost that they reach, not coordinate by coordinate: with no camera held,
a solve is free up to a similarity, and points seen twice along a short
baseline are free along their rays to within the noise.  A number that is
not finite reads as infinite.  Each number compared is the largest over
its answers; an answer fails when any of its numbers passes its limit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from .common import STREAM_SAMPLE, load_module, sub_seed
from .reference import ba as ref


def finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def gap(reported: float, truth: float) -> float:
    return finite(abs(reported - truth) / abs(truth))


def sample_indices(seed: int, n: int, m: int) -> list[int]:
    """The m answers (of n) that the reference works out again, drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, STREAM_SAMPLE))
    return sorted(int(i) for i in rng.choice(n, size=min(m, n), replace=False))


@dataclasses.dataclass
class BAJudging:
    """The window's solves and the float64 reference's view of them, each
    reading worked out once, when a check first asks for it."""
    cell: object
    scene: object
    seed: int
    solves: list
    settings: dict
    cam_group: torch.Tensor
    n_groups: int
    start: Callable[[int], dict]
    sample: list[int] | None = None   # solve indices to re-solve; None: drawn from the seed
    _table: object = None
    _costs: dict = dataclasses.field(default_factory=dict)
    _solved: dict = dataclasses.field(default_factory=dict)

    @property
    def delta(self) -> float:
        return float(self.settings["huber_delta"])

    def table(self):
        if self._table is None:
            sc = self.scene
            self._table = ref.make_table(sc.obs_cam, sc.obs_pt, sc.obs_uv, sc.shape[1],
                                         self.cam_group, self.n_groups, torch.float64)
        return self._table

    def costs(self, k: int) -> tuple[float, float]:
        """The reference's cost of solve k's start and of the program's answer."""
        if k not in self._costs:
            st = self.start(k)
            c0 = float(ref.robust_cost(st["intr"], st["cam_rot"], st["cam_t"], st["points"],
                                       self.table(), self.delta))
            intr, rot, t, pts = self.by_k(k).out
            c1 = float(ref.robust_cost(intr, rot, t, pts, self.table(), self.delta))
            self._costs[k] = (c0, finite(c1))
        return self._costs[k]

    def by_k(self, k: int):
        return next(s for s in self.solves if s.k == k)

    def sampled(self) -> list[int]:
        if self.sample is not None:
            return list(self.sample)
        n = int(self.cell.traffic["reference_solves"])
        return [self.solves[i].k for i in sample_indices(self.seed, len(self.solves), n)]

    def reference_cost(self, k: int) -> float:
        """The final cost of the reference's own solve from solve k's start."""
        if k not in self._solved:
            st = self.start(k)
            sc = self.scene
            _, _, _, _, info = ref.solve(st["intr"], st["cam_rot"], st["cam_t"], st["points"],
                                         sc.obs_cam, sc.obs_pt, sc.obs_uv, self.settings,
                                         cam_group=self.cam_group, n_groups=self.n_groups,
                                         dtype=torch.float64)
            self._solved[k] = float(info["final_cost"])
        return self._solved[k]


def readings(cell, judging, names) -> dict:
    """{number: {answer: value}} for each of `names`."""
    return {name: load_module(cell.bench_dir / "checks" / f"{name}.py").read(judging)
            for name in names}


def judge(cell, judging):
    """({number: {"value", "limit"}}, the count of failed answers, and each
    number's three largest readings) for the numbers that the cell's limits
    file names."""
    got = readings(cell, judging, list(cell.limits))
    checks, bad, tails = {}, set(), {}
    for name, limit in cell.limits.items():
        vals = got[name]
        if not vals:
            raise KeyError(f"{name} has a limit but no reading in cell {cell.name}")
        checks[name] = {"value": max(vals.values()), "limit": float(limit)}
        tails[name] = sorted(vals.values(), reverse=True)[:3]
        bad |= {k for k, v in vals.items() if not v <= limit}
    return checks, len(bad), tails
