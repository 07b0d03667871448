"""Trial-list scoring with the E-TDNN: ``AudioExtractor.embed`` and
``eval/scoring.py: cosine_scores``, as a verification user runs them.

One unit of the window is one trial list: its ``utterances`` int16 rows,
drawn from the pool on the card, embedded ``batch`` rows at a time, then
its ``trials`` pairs scored by cosine. A list is enqueued without waiting
for the previous one (the closed loop of one user; the queue of launches
bounds how far the host runs ahead). The rate counts trials.

``correct``: after the window, the reference embeds and scores a seeded
sample of the lists that ran, and the largest gaps of the embeddings and of
the scores are held to the cell's limits.
"""

from __future__ import annotations

import random

import torch

from perfbench import compare, traffic, weights
from perfbench.metrics import _work

WEIGHTS, POOL, LISTS, PAIRS, SAMPLE = range(5)   # seed streams


class Driver:
    PHASES = ("prepare", "warm")   # set-up, in order

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = {k: v for k, v in ctx.cell.config.items()
                       if k in ("data", "model", "train", "test")}
        self.t = ctx.cell.traffic
        self.precision = ctx.cell.traffic["precision"]
        self.outputs = []

    # ---------------------------------------------------------------- set-up
    def _reference_shapes(self) -> dict:
        ref = self.ctx.reference()
        return weights.shapes_of(ref.build(self.config, int(self.ctx.cell.config["num_classes"])))

    def prepare(self) -> None:
        """The extractor, the benchmark's weights in it, and the traffic."""
        from deeplip_tpu_torch.eval.scoring import cosine_scores
        from deeplip_tpu_torch.train.audio import AudioExtractor

        ctx, t, dev = self.ctx, self.t, self.ctx.device
        self.cosine_scores = cosine_scores
        self.extractor = AudioExtractor(self.config, device=dev)
        state = weights.seeded_state(self._reference_shapes(), ctx.seed_for(WEIGHTS), dev)
        self.extractor.model.load_state_dict(
            {k: v for k, v in state.items() if not k.startswith("criterion.")}, strict=True)

        self.samples = int(round(t["seconds"] * t["voice"]["rate"]))
        self.pool = traffic.voiced_pcm(t["pool"], self.samples, t["voice"],
                                       traffic.generator(dev, ctx.seed_for(POOL)), dev)
        self.lists = traffic.distinct_rows(t["max_lists"], t["utterances"], t["pool"],
                                           traffic.generator(dev, ctx.seed_for(LISTS)), dev)
        self.pairs = torch.randint(0, t["utterances"], (t["trials"], 2), device=dev,
                                   generator=traffic.generator(dev, ctx.seed_for(PAIRS)))
        feat = self.extractor.eval_feat_cfg
        frames = _work.num_frames(self.samples, feat.frame_len, feat.frame_step)
        b = int(t["batch"])
        self.feat_lengths = torch.full((b,), frames, dtype=torch.int32, device=dev)
        self.sample_lengths = torch.full((b,), self.samples, dtype=torch.int32, device=dev)
        self.batches = [(lo, min(b, t["utterances"] - lo)) for lo in range(0, t["utterances"], b)]

    def warm(self) -> None:
        """The FLOPs of a list, each batch shape counted once under the FLOP
        counter (a whole list under it takes seconds), then one plain list,
        which warms every shape."""
        counts = {}
        for _, n in self.batches:
            counts[n] = counts.get(n, 0) + 1
        self.flops_per_list = sum(k * (_work.counted_flops(self._embed, 0, 0, n) or 0.0)
                                  for n, k in counts.items())
        self._score(0)

    def _embed(self, i: int, lo: int, n: int):
        idx = self.lists[i % self.lists.shape[0]]
        return self.extractor.embed(self.pool[idx[lo:lo + n]], self.feat_lengths[:n],
                                    self.sample_lengths[:n])

    def _score(self, i: int):
        emb = torch.cat([self._embed(i, lo, n) for lo, n in self.batches])
        return emb, self.cosine_scores(emb, self.pairs, normalize=False)

    # ---------------------------------------------------------------- window
    def step(self, i: int) -> float:
        self.outputs.append(self._score(1 + i))
        return float(self.t["trials"])

    def work(self) -> dict:
        n = len(self.outputs)
        return {"peak": "fp32", "flops": n * (self.flops_per_list or 0.0),
                "feat": _work.feature_settings(self.config),
                "k1_batches": [[rows, self.samples, n] for _, rows in self.batches]}

    def finish(self) -> dict:
        n = len(self.outputs)
        finite = torch.stack([torch.isfinite(s).all() for _, s in self.outputs]).cpu()
        rng = random.Random(self.ctx.seed_for(SAMPLE))
        self.sample = sorted(rng.sample(range(n), min(int(self.t["check_lists"]), n)))
        self.kept = {i: self.outputs[i] for i in self.sample}
        self.outputs = []
        return {"attempted": n, "failed": int((~finite).sum())}

    def release(self) -> None:
        del self.extractor

    # ---------------------------------------------------------------- check
    def check(self) -> list:
        return self.numbers(self.kept, self.reference_outputs(self.precision))

    def reference_outputs(self, precision: str, half: bool = False) -> dict:
        """The reference's embeddings and scores of the kept lists at
        ``precision``; with ``half``, each batch's second half of rows left
        out (zero embeddings), the fault the check must catch."""
        ref = self.ctx.reference()
        model = ref.build(self.config, int(self.ctx.cell.config["num_classes"])).to(self.ctx.device)
        model.load_state_dict(weights.seeded_state(weights.shapes_of(model),
                                                   self.ctx.seed_for(WEIGHTS), self.ctx.device))
        feat, b = ref.feature_settings(self.config), int(self.t["batch"])
        out = {}
        for i in self.kept:
            rows = self.pool[self.lists[(1 + i) % self.lists.shape[0]]]
            emb = ref.embed_rows(model, rows, feat, precision, b)
            if half:
                for lo, n in self.batches:
                    emb[lo + n // 2:lo + n] = 0.0
            out[i] = (emb, ref.cosine(emb, self.pairs))
        return out

    @staticmethod
    def numbers(got: dict, want: dict) -> list:
        """``emb_gap`` and ``score_gap``: the largest gaps over the lists."""
        emb_gap = max(compare.max_abs_gap(got[i][0], want[i][0]) for i in want)
        score_gap = max(compare.max_abs_gap(got[i][1], want[i][1]) for i in want)
        return [("emb_gap", emb_gap), ("score_gap", score_gap)]
