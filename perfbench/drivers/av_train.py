"""Audio-visual fusion training: ``FusionTrainer.train_step`` back to back, as
``cli/train_fusion.py`` drives it, with no host pipeline.

One unit of the window is one train step of ``batch`` items, each a crop of
a voiced utterance and that utterance's clip group, taken on the card from
a pool: the frozen E-TDNN embeds every crop, the frozen Lipreading frame
path every clip slot, and SGD steps the head and the classifier. The crop
length cycles through the config's buckets in a fixed order; the rate
counts items, those without clips included (their audio is embedded too).

Set-up builds one trainer, loads the benchmark's weights into both
encoders, the head and the classifier, and drives it through the first
three steps: their losses, the first gradient as SGD took it, the change
of every trained leaf, and the x-vectors and group means that the first
step fed its head (caught on the head's own call) are read. Then one step
under the FLOP counter and one plain step; the window carries on with the
same object. ``correct``: after the window the reference takes the same
three batches from the same weights.
"""

from __future__ import annotations

import torch

from perfbench import compare, traffic, training, weights
from perfbench.metrics import _work

WEIGHTS, PCM, CLIPS, LABELS, GROUPS, LENGTHS, ROWS, OFFSETS = range(8)   # seed streams
CHECKED = 3
# the trainer's modules by the prefix of their names in the reference's state
PARTS = {"audio": "audio_model.", "video": "video_model.", "head": "fusion_head.",
         "criterion": "criterion."}


class Driver:
    PHASES = ("prepare", "checked", "warm")   # set-up, in order

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.t = ctx.cell.traffic
        self.precision = ctx.cell.traffic["precision"]
        self.classes = int(self.config["num_classes"])
        self.lengths = traffic.crop_lengths(self.t)
        self.losses = []

    def _reference_model(self):
        return self.ctx.reference().build(self.config)

    def _state(self, shapes: dict) -> dict:
        return weights.seeded_state(shapes, self.ctx.seed_for(WEIGHTS), self.ctx.device)

    def prepare(self) -> None:
        """The trainer, the benchmark's weights in it, and the traffic."""
        from deeplip_tpu_torch.train.fusion import FusionTrainer

        ctx, t, dev = self.ctx, self.t, self.ctx.device
        model, train, data = self.config["model"], self.config["train"], self.config["data"]
        tcn = model["video_config"]["tcn"]
        keys = ("backbone_type", "relu_type", "tcn_kernel_size", "tcn_num_layers",
                "tcn_dropout", "tcn_dwpw", "tcn_width_mult")
        # the CLI's steps per epoch: the pool's seconds over the mean crop, in batches
        mean_crop = (sum(data["frames"]) / 2 - 1) * t["win_shift"] + t["win_len"]
        epoch = int(t["pool"] * t["pool_seconds"] / mean_crop) // int(t["batch"])
        sgd = train["sgd"]
        self.trainer = FusionTrainer(
            model["audio_config"], {k: tcn[k] for k in keys}, n_spk=self.classes,
            audio_data_opts=data["python_data_config"], device=dev, lr=float(sgd["init_lr"]),
            weight_decay=float(sgd["weight_decay"]), momentum=float(sgd["momentum"]),
            lr_decay_step=train["lr_decay_step"], lr_decay=float(train["lr_decay"]),
            steps_per_epoch=max(epoch, 1), crop_size=(self.config["crop"],) * 2,
            video_hidden_dim=int(self.config["video_hidden_dim"]),
            fusion_head=str(train.get("fusion_head", "lowfer")), loss=str(train["loss"]),
            compute_dtype="float32")
        state = self._state(weights.shapes_of(self._reference_model()))
        self.trainer.load_state_dicts(**{
            part: {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
            for part, prefix in PARTS.items()})
        self.leaves = training.named_leaves({"criterion.": self.trainer.criterion})
        self.start = {n: state[n] for n in self.leaves}
        self.pool_traffic()

    def pool_traffic(self) -> None:
        """The pool on the card: voiced PCM, each utterance's clip group (its
        size fixed by the traffic's shares), clip lengths, labels; the rows
        and crop offsets of every step."""
        ctx, t, dev = self.ctx, self.t, self.ctx.device
        n, g = int(t["pool"]), int(t["max_clips"])
        samples = int(round(t["pool_seconds"] * t["rate"]))
        self.pcm = traffic.voiced_pcm(n, samples, {**t["voice"], "rate": t["rate"]},
                                      traffic.generator(dev, ctx.seed_for(PCM)), dev)
        clips = traffic.clips_u8(n * g, t["clip_frames"], t["height"], t["width"],
                                 traffic.generator(dev, ctx.seed_for(CLIPS)), dev)
        self.labels = torch.randint(0, self.classes, (n,), device=dev,
                                    generator=traffic.generator(dev, ctx.seed_for(LABELS)))
        # group sizes: exact shares of the pool, in a seeded order
        order = torch.randperm(n, device=dev,
                               generator=traffic.generator(dev, ctx.seed_for(GROUPS)))
        self.groups = torch.zeros(n, dtype=torch.int64, device=dev)
        at = 0
        for size in range(g, 0, -1):
            count = int(round(float(t["group_shares"][size]) * n))
            self.groups[order[at:at + count]] = size
            at += count
        # clip lengths: the full clip, or with ``short_share`` odds uniform in ``short_frames``
        gen = traffic.generator(dev, ctx.seed_for(LENGTHS))
        u = torch.rand((2, n, g), device=dev, generator=gen)
        lo, hi = t["short_frames"]
        short = lo + (u[1] * (hi - lo + 1)).long().clamp(max=hi - lo)
        lengths = torch.where(u[0] < float(t["short_share"]), short,
                              torch.full_like(short, int(t["clip_frames"])))
        self.clip_lengths = lengths * (torch.arange(g, device=dev)[None, :] < self.groups[:, None])
        # pad frames and empty slots hold zeros, as the recipe's batches do
        real = torch.arange(t["clip_frames"], device=dev) < self.clip_lengths.reshape(-1, 1)
        self.clips = (clips * real[:, :, None, None]).reshape(
            (n, g, t["clip_frames"], t["height"], t["width"]))
        del clips
        self.rows = traffic.distinct_rows(t["max_steps"], t["batch"], n,
                                          traffic.generator(dev, ctx.seed_for(ROWS)), dev)
        self.offsets = torch.rand((t["max_steps"], t["batch"]), device=dev,
                                  generator=traffic.generator(dev, ctx.seed_for(OFFSETS)))

    def checked(self) -> None:
        """The first steps, and what the check reads off them."""
        kept = []
        hook = self.trainer.fusion_head.register_forward_pre_hook(
            lambda module, args: kept.append([a.detach().clone() for a in args]))
        losses = [self._step(0)]
        hook.remove()
        first = training.first_gradient(self.trainer.optimizer, self.leaves)
        losses += [self._step(i) for i in range(1, CHECKED)]
        self.program = training.readings(losses, first, training.change(self.leaves, self.start))
        self.program["audio_emb"], self.program["video_emb"] = kept[0]
        del self.leaves, self.start

    def warm(self) -> None:
        """One step under the FLOP counter (the cycle's middle crop length,
        whose count is the cycle's mean: the TDNN's work grows linearly with
        the crop) and one plain step; with the checked steps, every length
        once."""
        self.flops = _work.counted_flops(self._step, CHECKED)
        self._step(CHECKED + 1)
        self.base = CHECKED + 2

    def _length(self, i: int) -> int:
        k = len(self.lengths)
        return self.lengths[(i - CHECKED + k // 2) % k]

    def batch(self, i: int):
        """Step ``i``'s float PCM crops, clip groups, clip lengths, group
        sizes and labels."""
        j = i % self.rows.shape[0]
        rows = self.rows[j]
        pcm = traffic.crop_batch(self.pcm, rows, self.offsets[j], self._length(i))
        return (pcm.to(torch.float32) / 32768.0, self.clips[rows], self.clip_lengths[rows],
                self.groups[rows], self.labels[rows])

    def _step(self, i: int):
        return self.trainer.train_step(*self.batch(i))["loss"]

    # ---------------------------------------------------------------- window
    def step(self, i: int) -> float:
        self.losses.append(self._step(self.base + i))
        return float(self.t["batch"])

    def work(self) -> dict:
        n = len(self.losses)
        return {"peak": "fp32", "flops": n * (self.flops or 0.0), "steps": n}

    def finish(self) -> dict:
        finite = torch.isfinite(torch.stack(self.losses)).cpu()
        self.losses = []
        return {"attempted": len(finite), "failed": int((~finite).sum())}

    def release(self) -> None:
        del self.trainer

    # ---------------------------------------------------------------- check
    def check(self) -> list:
        return self.numbers(self.program, self.reference_readings(self.precision))

    @staticmethod
    def numbers(prog: dict, ref: dict) -> list:
        """The training numbers, and ``audio_emb_gap`` and ``video_emb_gap``:
        the largest gap of the first batch's x-vectors and group means over
        the reference's largest entry."""
        out = compare.train_numbers(prog, ref)
        for name in ("audio", "video"):
            p, r = prog[f"{name}_emb"], ref[f"{name}_emb"]
            out.append((f"{name}_emb_gap", compare.max_abs_gap(p, r) / float(r.abs().max())))
        return out

    def reference_readings(self, precision: str, keep: int | None = None) -> dict:
        """The reference's readings of the checked steps at ``precision``;
        with ``keep``, each step on its first ``keep`` rows alone (the
        half-batch fault)."""
        ref = self.ctx.reference()
        system = self._reference_model().to(self.ctx.device)
        system.load_state_dict(self._state(weights.shapes_of(system)))
        return ref.train_steps(system, [self.batch(i) for i in range(CHECKED)], self.config,
                               precision, keep)
