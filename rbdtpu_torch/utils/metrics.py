"""Run metrics (``rbdtpu.utils.metrics``): the aggregate statistics of a
batch of DDP solves, read from the solver's state once per batch."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SolveMetrics:
    """Aggregated statistics of a batch of DDP solves."""
    n_solves: int
    wall_s: float
    mean_cost: float
    max_cost: float
    frac_improved: float  # solves whose last accepted dJ > 0

    @property
    def solves_per_s(self) -> float:
        return self.n_solves / self.wall_s if self.wall_s > 0 else float("nan")

    @classmethod
    def from_states(cls, states, wall_s: float) -> "SolveMetrics":
        """states: a batched ``DDPState`` (J and dJ of shape (B,))."""
        J = states.J
        return cls(
            n_solves=int(J.shape[0]),
            wall_s=float(wall_s),
            mean_cost=float(J.mean()),
            max_cost=float(J.max()),
            frac_improved=float((states.dJ > 0).float().mean()),
        )

    def json(self) -> dict:
        return {
            "n_solves": self.n_solves,
            "wall_s": round(self.wall_s, 6),
            "solves_per_s": round(self.solves_per_s, 1),
            "mean_cost": self.mean_cost,
            "max_cost": self.max_cost,
            "frac_improved": self.frac_improved,
        }
