"""Audio x-vector training: ``AudioTrainer.train_step`` back to back, as
``cli/train_audio.py`` drives it, with no host pipeline.

One unit of the window is one train step of ``batch`` crops cut on the card
from a pool of voiced utterances; the crop length cycles through the
config's buckets in a fixed order, so every window holds the same mix. The
rate counts crops.

Set-up builds one trainer, loads the benchmark's weights, and drives it
through the first three steps (their losses, the first gradient as SGD
took it, and the change of every leaf are read), then once through every
bucket under the FLOP counter and once plainly; the window carries on from
there with the same object. ``correct``: after the window the reference
takes the same three batches from the same weights.
"""

from __future__ import annotations

import torch

from perfbench import compare, traffic, training, weights
from perfbench.metrics import _work

WEIGHTS, POOL, LABELS, ROWS, OFFSETS = range(5)   # seed streams
CHECKED = 3


class Driver:
    PHASES = ("prepare", "checked", "warm")   # set-up, in order

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = {k: v for k, v in ctx.cell.config.items()
                       if k in ("data", "model", "train", "test")}
        self.t = ctx.cell.traffic
        self.precision = ctx.cell.traffic["precision"]
        self.classes = int(ctx.cell.config["num_classes"])
        self.lengths = traffic.crop_lengths(self.t)
        self.losses = []

    def _reference_model(self):
        return self.ctx.reference().build(self.config, self.classes)

    def _state(self, shapes: dict) -> dict:
        return weights.seeded_state(shapes, self.ctx.seed_for(WEIGHTS), self.ctx.device)

    def prepare(self) -> None:
        """The trainer, the benchmark's weights in it, and the traffic."""
        from deeplip_tpu_torch.train.audio import AudioTrainer

        ctx, t, dev = self.ctx, self.t, self.ctx.device
        self.trainer = AudioTrainer(self.config, device=dev, n_spk=self.classes)
        state = self._state(weights.shapes_of(self._reference_model()))
        self.trainer.model.load_state_dict(
            {k: v for k, v in state.items() if not k.startswith("criterion.")}, strict=True)
        self.trainer.criterion.load_state_dict({"weights": state["criterion.weights"]})
        self.leaves = training.named_leaves({"": self.trainer.model,
                                             "criterion.": self.trainer.criterion})
        self.start = {n: state[n] for n in self.leaves}

        samples = int(round(t["pool_seconds"] * t["rate"]))
        self.pool = traffic.voiced_pcm(t["pool"], samples, {**t["voice"], "rate": t["rate"]},
                                       traffic.generator(dev, ctx.seed_for(POOL)), dev)
        self.pool_labels = torch.randint(0, self.classes, (t["pool"],), device=dev,
                                         generator=traffic.generator(dev, ctx.seed_for(LABELS)))
        self.rows = traffic.distinct_rows(t["max_steps"], t["batch"], t["pool"],
                                          traffic.generator(dev, ctx.seed_for(ROWS)), dev)
        self.offsets = torch.rand((t["max_steps"], t["batch"]), device=dev,
                                  generator=traffic.generator(dev, ctx.seed_for(OFFSETS)))
        self.margin = float(self.config["train"]["margin"][0])

    def checked(self) -> None:
        """The first steps, and what the check reads off them."""
        losses = [self._step(0)]
        first = training.first_gradient(self.trainer.optimizer, self.leaves)
        losses += [self._step(i) for i in range(1, CHECKED)]
        self.program = training.readings(losses, first, training.change(self.leaves, self.start))
        del self.leaves, self.start

    def warm(self) -> None:
        """Every bucket once under the FLOP counter and once plainly."""
        k = len(self.lengths)
        self.flops = {}
        for i in range(CHECKED, CHECKED + k):
            self.flops[self._length(i)] = _work.counted_flops(self._step, i)
        for i in range(CHECKED + k, CHECKED + 2 * k):
            self._step(i)
        self.base = CHECKED + 2 * k
        self.window_lengths = []

    def _length(self, i: int) -> int:
        return self.lengths[i % len(self.lengths)]

    def batch(self, i: int):
        j = i % self.rows.shape[0]
        pcm = traffic.crop_batch(self.pool, self.rows[j], self.offsets[j], self._length(i))
        return pcm, self.pool_labels[self.rows[j]]

    def _step(self, i: int):
        pcm, labels = self.batch(i)
        return self.trainer.train_step(pcm, labels, self.margin)["loss"]

    # ---------------------------------------------------------------- window
    def step(self, i: int) -> float:
        g = self.base + i
        self.losses.append(self._step(g))
        self.window_lengths.append(self._length(g))
        return float(self.t["batch"])

    def work(self) -> dict:
        return {"peak": "bf16" if self.precision == "bf16" else "fp32",
                "flops": sum(self.flops[n] or 0.0 for n in self.window_lengths),
                "feat": _work.feature_settings(self.config),
                "k1_batches": [[int(self.t["batch"]), n, self.window_lengths.count(n)]
                               for n in sorted(set(self.window_lengths))]}

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
        batches = [(pcm[:keep], labels[:keep]) for pcm, labels in
                   (self.batch(i) for i in range(CHECKED))]
        return ref.train_steps(model, batches, self.config, precision)
