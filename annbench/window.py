"""What a traffic driver hands back from the measured window."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Window:
    attempted: int                  # queries sent
    failed: int                     # queries that failed or never came
    completed: int                  # queries answered
    elapsed_s: float                # the window, first send to last answer
    searches: int = 0               # index calls the traffic made itself
    # sampled answers: (pool index, ids (k,), distances (k,))
    answers: List[Tuple[int, np.ndarray, np.ndarray]] = field(
        default_factory=list)
    # the work sent, for the rooflines of a trace: (pool indices of one
    # batch, how many times it ran)
    sent: List[Tuple[np.ndarray, int]] = field(default_factory=list)
