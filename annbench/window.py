"""What a traffic driver hands back from the measured window.

A version is the number of mutations applied to the index before the
search that made an answer: 0 for every answer of a driver that mutates
nothing. `mutations` is the ordered log of those the driver applied,
those of its warm-up first:

- `("push", first, count)`: points `first .. first+count-1` of the run's
  pushed stream (`datagen.pushed`), appended with the next ids;
- `("delete", ids)`: the ids as the index numbered them when the call
  was made (`IVFADCIndex.delete`; the survivors shift down).
"""

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
    # sampled answers: (pool index, ids (k,), distances (k,), version)
    answers: List[Tuple[int, np.ndarray, np.ndarray, int]] = field(
        default_factory=list)
    # the work sent, for the rooflines of a trace: (pool indices of one
    # batch, how many times it ran, version)
    sent: List[Tuple[np.ndarray, int, int]] = field(default_factory=list)
    mutations: List[tuple] = field(default_factory=list)
