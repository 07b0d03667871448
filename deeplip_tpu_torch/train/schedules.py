"""Learning-rate schedules matching the reference recipes.

Counterpart of ``deeplip_tpu/train/schedules.py``.
:func:`cosine_annealing_schedule` is torch ``CosineAnnealingLR(T_max)`` in
closed form; the video trainer steps it per *iteration* (the reference's
``scheduler.step()`` placement, ``train_video.py:140-143``), so ``step`` is
the optimizer step count, and past ``T_max`` it continues periodically.
"""

from __future__ import annotations

import math


def cosine_annealing_schedule(init_lr: float, t_max: int, eta_min: float = 0.0):
    def schedule(step: int) -> float:
        return eta_min + (init_lr - eta_min) * (1.0 + math.cos(math.pi * step / t_max)) / 2.0

    return schedule
