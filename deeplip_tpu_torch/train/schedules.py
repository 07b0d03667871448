"""Learning-rate schedules matching the reference recipes.

Counterpart of ``deeplip_tpu/train/schedules.py``. Both are functions of
the optimizer step count, which the trainers feed into each parameter
group's ``lr`` before every step.

:func:`multistep_schedule` is torch ``MultiStepLR`` stepped per *epoch*
(milestones ``[15, 25]`` x γ=0.1 in the audio recipe), expressed per step
through ``steps_per_epoch``. :func:`cosine_annealing_schedule` is torch
``CosineAnnealingLR(T_max)`` in closed form; the video trainer steps it per
*iteration* (the reference's ``scheduler.step()`` placement,
``train_video.py:140-143``), and past ``T_max`` it continues periodically.
"""

from __future__ import annotations

import math


def multistep_schedule(init_lr: float, milestones_epochs, gamma: float,
                       steps_per_epoch: int):
    boundaries = [int(m) * int(steps_per_epoch) for m in milestones_epochs]

    def schedule(step: int) -> float:
        n_passed = sum(int(step >= b) for b in boundaries)
        return init_lr * (gamma ** n_passed)

    return schedule


def cosine_annealing_schedule(init_lr: float, t_max: int, eta_min: float = 0.0):
    def schedule(step: int) -> float:
        return eta_min + (init_lr - eta_min) * (1.0 + math.cos(math.pi * step / t_max)) / 2.0

    return schedule
