"""Lipreading training: ``VideoTrainer.train_step`` back to back, as
``cli/train_video.py`` drives it, at the traffic's compute type.

One unit of the window is one train step: ``batch`` distinct uint8 clips
taken on the card from a pool, their crop offsets and flips drawn by the
trainer from a seeded host generator. The rate counts clips.

Set-up builds one trainer, loads the benchmark's weights, seeds the card's
generator (the TCN's dropout masks) and drives the trainer through the
first three steps, reading their losses, the first gradient as Adam took
it and the change of every leaf; then one step under the FLOP counter and
one plain step; the window carries on with the same object. ``correct``:
after the window the reference takes the same three batches, draws and
dropout masks from the same weights.
"""

from __future__ import annotations

import torch

from perfbench import compare, traffic, training, weights
from perfbench.metrics import _work

WEIGHTS, POOL, LABELS, ROWS, DRAWS, DROPOUT = range(6)   # seed streams
CHECKED = 3


class Driver:
    PHASES = ("prepare", "checked", "warm")   # set-up, in order

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.t = ctx.cell.traffic
        self.precision = ctx.cell.traffic["precision"]
        self.losses = []

    def _reference_model(self):
        return self.ctx.reference().build(self.config)

    def _state(self, shapes: dict) -> dict:
        return weights.seeded_state(shapes, self.ctx.seed_for(WEIGHTS), self.ctx.device)

    def prepare(self) -> None:
        """The trainer, the benchmark's weights in it, and the traffic."""
        from deeplip_tpu_torch.train.video import VideoTrainer

        ctx, t, dev, train = self.ctx, self.t, self.ctx.device, self.config["train"]
        self.trainer = VideoTrainer(
            self.config["model"], int(self.config["num_classes"]), device=dev,
            lr=float(train["lr"]), weight_decay=float(train["weight_decay"]),
            t_max=int(train["t_max"]), crop_size=(train["crop"], train["crop"]),
            hidden_dim=int(train["hidden_dim"]), trunk_layers=tuple(train["trunk_layers"]),
            compute_dtype="bf16" if self.precision == "bf16" else "float32")
        state = self._state(weights.shapes_of(self._reference_model()))
        self.trainer.model.load_state_dict(state, strict=True)
        self.leaves = training.named_leaves({"": self.trainer.model})
        self.start = {n: state[n] for n in self.leaves}

        self.pool = traffic.clips_u8(t["pool"], t["frames"], t["height"], t["width"],
                                     traffic.generator(dev, ctx.seed_for(POOL)), dev)
        self.pool_labels = torch.randint(0, int(self.config["num_classes"]), (t["pool"],),
                                         device=dev,
                                         generator=traffic.generator(dev, ctx.seed_for(LABELS)))
        self.rows = traffic.distinct_rows(t["max_steps"], t["batch"], t["pool"],
                                          traffic.generator(dev, ctx.seed_for(ROWS)), dev)
        self.lengths = torch.full((t["batch"],), t["frames"], dtype=torch.int64, device=dev)
        self.draws = torch.Generator().manual_seed(ctx.seed_for(DRAWS))

    def checked(self) -> None:
        """The first steps, and what the check reads off them."""
        torch.manual_seed(self.ctx.seed_for(DROPOUT))
        losses = [self._step(0)]
        first = training.first_gradient(self.trainer.optimizer, self.leaves)
        losses += [self._step(i) for i in range(1, CHECKED)]
        self.program = training.readings(losses, first, training.change(self.leaves, self.start))
        del self.leaves, self.start

    def warm(self) -> None:
        """One step under the FLOP counter and one plain step."""
        self.flops = _work.counted_flops(self._step, CHECKED)
        self._step(CHECKED + 1)
        self.base = CHECKED + 2

    def batch(self, i: int):
        j = i % self.rows.shape[0]
        return self.pool[self.rows[j]], self.pool_labels[self.rows[j]]

    def _step(self, i: int):
        clips, labels = self.batch(i)
        return self.trainer.train_step(clips, self.lengths, labels, self.draws)["loss"]

    # ---------------------------------------------------------------- window
    def step(self, i: int) -> float:
        self.losses.append(self._step(self.base + i))
        return float(self.t["batch"])

    def work(self) -> dict:
        n, itemsize = len(self.losses), 2 if self.precision == "bf16" else 4
        t, crop = self.t, int(self.config["train"]["crop"])
        return {"peak": "bf16" if self.precision == "bf16" else "fp32",
                "flops": n * (self.flops or 0.0), "steps": n, "itemsize": itemsize,
                "bn_sites": _work.lipreading_bn_sites(t["batch"], t["frames"], crop),
                "pool_shape": [t["batch"], t["frames"], crop // 2, crop // 2, 64]}

    def finish(self) -> dict:
        finite = torch.isfinite(torch.stack(self.losses)).cpu()
        self.losses = []
        return {"attempted": len(finite), "failed": int((~finite).sum())}

    def release(self) -> None:
        del self.trainer

    # ---------------------------------------------------------------- check
    def check(self) -> list:
        return compare.train_numbers(self.program, self.reference_readings(self.precision))

    def reference_readings(self, precision: str, keep: int | None = None) -> dict:
        """The reference's readings of the checked steps at ``precision``;
        with ``keep``, each step on its first ``keep`` rows alone (the
        half-batch fault)."""
        ref = self.ctx.reference()
        model = self._reference_model().to(self.ctx.device)
        model.load_state_dict(self._state(weights.shapes_of(model)))
        return ref.train_steps(model, [self.batch(i) for i in range(CHECKED)], self.config,
                               precision, torch.Generator().manual_seed(self.ctx.seed_for(DRAWS)),
                               self.ctx.seed_for(DROPOUT), keep)
