"""Synthetic convergence study, audio: the reference recipe's torch replica
against the port's ``AudioTrainer`` over epochs.

Counterpart of ``scripts/convergence_study.py``, with the same corpus, batch
stream, recipe and report. Both sides train a TDNN x-vector system with the
reference audio recipe (the reference's train_audio.py:158-214 and
conf/audio_config.yaml:121-144: LMCL s=30 m=0.2, SGD momentum 0.9 and
weight decay 1e-5, MultiStepLR x0.1 at epoch milestones, speaker-balanced
random crop-and-concat batches) on one shared hard synthetic corpus
(``data.synthetic.make_hard_audio_corpus``: 12 speakers sharing one
resonance stack under strong noise, so the EER lands in a meaningful band).
The batch stream (crop-and-concat PCM, then python_speech_features'
MFCC with CMVN in float64, :func:`~deeplip_tpu_torch.cli.parity_check.numpy_mfcc`)
is drawn once from seed 42 and fed to both, and both start from the
replica's init (the port loads its state dicts), so the comparison isolates
training dynamics. The port steps with ``AudioTrainer.train_step_feats``
and evaluates each epoch through ``extract_embeddings`` over the held-out
utterances, where its front-end runs (on the card, the FFT kernel K1).

Where this differs from the JAX script, and why:

- both sides run on ``--device`` (the card unless ``--device cpu``). The
  JAX script trained the replica on the CPU; at the shipped widths
  (``--arch flagship``) hundreds of replica steps do not fit the card
  machine's eight shared cores. On the card the replica computes in FP32
  with TF32 off and cuDNN deterministic;
- ``--arch study`` (the default) keeps the JAX script's widths, cut for its
  one-core host; ``--arch flagship`` takes conf/audio_config.yaml's E-TDNN
  (hidden 512 x 9 and 1500, embedding 512);
- ``--nudges N`` trains the replica N more times from the same init on its
  MFCC batches nudged elementwise by ``parity_check.NUDGE``, and holds the
  port to ``parity_check.convergence_rule`` against those runs (exit code 3
  where it fails). The JAX script states no bar; with N = 0 none is held;
- the report's port curve is under ``deeplip_tpu_torch``, and the report
  adds ``eval_batches``, ``device``, ``card``, ``launches``, ``seconds``
  and, with nudges, ``nudged``, ``convergence_bars`` and
  ``convergence_rule``. The default
  ``--out`` lies under ``exp/``, never over a file of ``docs/``.

Run: ``python -m deeplip_tpu_torch.cli.convergence_study [--device cpu]
[--arch flagship] [--nudges 3] [--out PREFIX]`` (writes PREFIX.json and
PREFIX.md, and prints one JSON line).
"""

from __future__ import annotations

import copy
import os
import sys
import tempfile
import time

import numpy as np
import torch

from deeplip_tpu_torch.cli import parity_check as PC
from deeplip_tpu_torch.cli.parity_check import (epoch_loss_gap, finish_study, nudge_array,
                                               nudge_rng, nudged_entry, replica_math,
                                               study_parser)
from deeplip_tpu_torch.core.config import Config
from deeplip_tpu_torch.core.device import resolve_device
from deeplip_tpu_torch.data.audio_io import read_wav
from deeplip_tpu_torch.data.audio_pipeline import EvalUtterance, EvalUtteranceSet
from deeplip_tpu_torch.data.prefetch import ThreadedPrefetcher
from deeplip_tpu_torch.data.manifest import SpeakerManifest
from deeplip_tpu_torch.data.synthetic import make_hard_audio_corpus, make_trial_list
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, TrialList, cosine_eer
from deeplip_tpu_torch.interop.torch_import import (import_lmcl_state_dict,
                                                    import_speaker_embnet_state_dict)
from deeplip_tpu_torch.train.audio import AudioTrainer
from deeplip_tpu_torch.train.schedules import multistep_schedule

ARCHES = {
    # the reference 'tdnn' contexts at the JAX script's widths (its 1-core host)
    "study": {"arch": "tdnn",
              "context": [[-2, -1, 0, 1, 2], [-2, 0, 2], [-3, 0, 3], [0], [0]],
              "hidden_dim": [64, 64, 64, 64, 192], "embedding_dim": 64},
    # conf/audio_config.yaml's E-TDNN
    "flagship": {"arch": "etdnn", **PC.ARCHS["etdnn"], "embedding_dim": 512},
}
EPOCHS = 10
STEPS_PER_EPOCH = 30
BS = 32
LR, MOMENTUM, WD = 0.01, 0.9, 1e-5
MILESTONES = [6, 9]  # epochs (reference [15, 25] scaled to the 10-epoch run)
SCALE, MARGIN = 30.0, 0.2
FRAME_RANGE = (200, 400)
N_SPK = 12
MFCC_THREADS = 2    # threads computing the batches' features (numpy releases the GIL)


def batch_stream(manifest, rng, numpy_mfcc, read_wav, steps):
    """Speaker-balanced crop-and-concat batches, reference collate semantics
    (the reference's models/audio_models/datasets.py:112-136): one random
    frame count per batch from an 11-value grid; each item concatenates
    random crops of random utterances of one balanced-sampled speaker;
    features extracted on the concatenation, per-utterance CMVN. Every
    draw is made here, in the JAX script's order; the batches' features are
    computed on :data:`MFCC_THREADS` threads ahead of the reader, which gets
    them in order."""
    pcm_cache = {}
    for s, u in manifest.all_utterances():
        pcm_cache.setdefault(s, []).append(read_wav(u.path)[0])
    n_spk = len(pcm_cache)
    # the JAX side compiles one step per shape; both sides see the same
    # batches, so the grid cannot bias the comparison
    frame_grid = np.linspace(FRAME_RANGE[0], FRAME_RANGE[1], 11).round()
    frame_grid = frame_grid.astype(int)
    plans = []
    for step in range(steps):
        n_frames = int(frame_grid[rng.integers(len(frame_grid))])
        need = (n_frames - 1) * 160 + 400
        items = []
        for i in range(BS):
            spk = int((step * BS + i) % n_spk)  # idx % n_spk balance
            chunks = []
            total = 0
            while total < need:
                y = pcm_cache[spk][int(rng.integers(len(pcm_cache[spk])))]
                crop_len = int(rng.integers(8000, min(len(y), 32000) + 1))
                start = int(rng.integers(0, len(y) - crop_len + 1))
                chunks.append(y[start:start + crop_len])
                total += crop_len
            items.append((spk, chunks))
        plans.append((need, items))

    def assemble(need, items):
        feats = [numpy_mfcc(np.concatenate(chunks)[:need].astype(np.float64))
                 .astype(np.float32) for _, chunks in items]
        return np.stack(feats), np.asarray([spk for spk, _ in items], np.int64)

    return ThreadedPrefetcher(plans, assemble, num_workers=MFCC_THREADS)


def make_batches(manifest, rng, numpy_mfcc, read_wav, steps):
    """:func:`batch_stream`'s batches as a list (the JAX script's function)."""
    return list(batch_stream(manifest, rng, numpy_mfcc, read_wav, steps))


# ---------------------------------------------------------------------------
# the replica and the port

def train_replica(tnet, tcrit, batches, evaluate, epochs: int, device,
                  rng: np.random.Generator | None = None) -> dict:
    """The reference audio recipe's loop (the reference's
    train_audio.py:174-200) with its MultiStepLR stepped per epoch, over
    the ``batches`` in order; ``rng`` nudges each MFCC batch. Returns the
    per-epoch mean losses and EERs."""
    opt = torch.optim.SGD(
        [{"params": tnet.parameters()}, {"params": tcrit.parameters()}],
        lr=LR, momentum=MOMENTUM, weight_decay=WD)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, MILESTONES, gamma=0.1)
    curve = {"loss": [], "eer": []}
    batches = iter(batches)
    tnet.train()
    for e in range(epochs):
        ep_loss = []
        for k in range(STEPS_PER_EPOCH):
            f, y = next(batches)
            if rng is not None:
                f = nudge_array(f, rng)
            opt.zero_grad()
            out = tnet(torch.tensor(np.transpose(f, (0, 2, 1))).to(device))
            loss, _ = tcrit(out, torch.tensor(y).to(device))
            loss.backward()
            opt.step()
            ep_loss.append(loss.detach())
        sched.step()
        curve["loss"].append(float(np.mean([float(v) for v in ep_loss])))
        curve["eer"].append(evaluate(tnet))
        print(f"[torch] epoch {e+1}: loss={curve['loss'][-1]:.4f} "
              f"eer={curve['eer'][-1]*100:.2f}%", file=sys.stderr)
    return curve


def study_config(arch: dict, epochs: int) -> dict:
    """The port's trainer config for the recipe at the widths ``arch``."""
    return {
        "data": {"frames": list(FRAME_RANGE), "python_data_config": PC.AUDIO_DATA},
        "model": {"arch": arch["arch"], arch["arch"]: {
            "input_dim": 24, "hidden_dim": arch["hidden_dim"],
            "context": arch["context"], "tdnn_layers": len(arch["context"]),
            "embedding_dim": arch["embedding_dim"], "pooling": "statistic",
            "attention_hidden_size": 16, "bn_first": True}},
        "train": {"loss": "LMCL", "scale": SCALE, "margin": [MARGIN, MARGIN],
                  "type": "sgd", "bs": BS, "lr_decay": 0.1,
                  "lr_decay_step": MILESTONES, "epoch": epochs,
                  "sgd": {"init_lr": LR, "weight_decay": WD, "momentum": MOMENTUM}},
        "test": {"bucket_frames": 50, "batch_size": 16},
    }


def port_trainer(arch: dict, epochs: int, device, exp_root: str, init_net_sd: dict,
                 init_crit_sd: dict) -> AudioTrainer:
    """The port's ``AudioTrainer`` for the recipe, on the per-epoch milestone
    schedule, from the replica's init (its state dicts)."""
    trainer = AudioTrainer(Config(study_config(arch, epochs)), device=device, n_spk=N_SPK,
                           exp_root=exp_root)
    # the epoch milestones need the real steps an epoch (no manifest here)
    trainer.schedule = multistep_schedule(LR, MILESTONES, 0.1, STEPS_PER_EPOCH)
    trainer.model.load_state_dict(
        import_speaker_embnet_state_dict(init_net_sd, n_blocks=len(arch["context"])),
        strict=True)
    trainer.criterion.load_state_dict(import_lmcl_state_dict(init_crit_sd), strict=True)
    return trainer


def replica_init(arch: dict) -> tuple[torch.nn.Module, torch.nn.Module]:
    """The replica's network and LMCL head at the widths ``arch``, drawn
    from seed 0."""
    torch.manual_seed(0)
    tnet = PC.build_torch_net(torch, arch["context"], [24] + arch["hidden_dim"],
                              arch["embedding_dim"])
    tcrit = PC.build_torch_lmcl(torch, arch["embedding_dim"], N_SPK, SCALE)
    tcrit.margin = MARGIN
    return tnet, tcrit


def main(argv=None) -> dict:
    args = study_parser(__doc__, EPOCHS, "audio").parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    arch = ARCHES[args.arch]
    epochs = args.epochs

    with tempfile.TemporaryDirectory(prefix="converge_") as work:
        print(f"[corpus] {work}", file=sys.stderr)
        make_hard_audio_corpus(work, n_spk=N_SPK, utts_per_spk=12, duration=2.5)
        manifest = SpeakerManifest.load(os.path.join(work, "manifest.csv"))
        # held-out eval: the last 4 utterances of each speaker
        train_manifest = SpeakerManifest([spk[:8] for spk in manifest.speakers])
        test_utts = [(s, u) for s, spk in enumerate(manifest.speakers) for u in spk[8:]]
        trial_path = os.path.join(work, "trials.txt")
        test_manifest = SpeakerManifest(
            [[u for s2, u in test_utts if s2 == s] for s in range(N_SPK)])
        make_trial_list(trial_path, test_manifest, n_trials=2000, balance=0.3)
        trials = TrialList.load(trial_path)

        rng = np.random.default_rng(42)
        print("[batches] generating shared batch stream...", file=sys.stderr)
        stream = batch_stream(train_manifest, rng, PC.numpy_mfcc, read_wav,
                              epochs * STEPS_PER_EPOCH)
        all_batches = []

        def first_pass():
            """The stream's batches as they arrive, kept for the later runs:
            the replica's first epochs overlap the features' computation."""
            for batch in stream:
                all_batches.append(batch)
                yield batch

        names = ["/".join(u.path.split(os.sep)[-2:]) for _, u in test_utts]
        eval_feats = {}
        for name, (_, u) in zip(names, test_utts):
            y, _ = read_wav(u.path)
            eval_feats[name] = PC.numpy_mfcc(y.astype(np.float64)).astype(np.float32)
        t_data = time.perf_counter() - t0

        def replica_eer(tnet):
            tnet.eval()
            store = EmbeddingStore()
            with torch.no_grad():
                for name, f in eval_feats.items():
                    store[name] = tnet.extract(torch.tensor(f.T[None]).to(device))[0]
            tnet.train()
            return float(cosine_eer(trials, store, device=device)[0])

        # ---- the torch replica, then its nudged runs from the same init
        tnet, tcrit = replica_init(arch)
        dims = [24] + arch["hidden_dim"]
        init_net_sd = copy.deepcopy(tnet.state_dict())
        init_crit_sd = copy.deepcopy(tcrit.state_dict())
        print("[torch] training...", file=sys.stderr)
        with replica_math():
            torch_curve = train_replica(tnet.to(device), tcrit.to(device), first_pass(),
                                        replica_eer, epochs, device)
        t_replica = time.perf_counter() - t0 - t_data
        runs = []
        for i in range(args.nudges):
            with torch.random.fork_rng(devices=[]):
                n_net = PC.build_torch_net(torch, arch["context"], dims, arch["embedding_dim"])
                n_crit = PC.build_torch_lmcl(torch, arch["embedding_dim"], N_SPK, SCALE)
            n_net.load_state_dict(init_net_sd)
            n_crit.load_state_dict(init_crit_sd)
            n_crit.margin = MARGIN
            print(f"[torch] nudged run {i + 1}...", file=sys.stderr)
            with replica_math():
                run = train_replica(n_net.to(device), n_crit.to(device), all_batches,
                                    replica_eer, epochs, device, rng=nudge_rng(i))
            runs.append(nudged_entry(torch_curve, run, {"final_eer_abs_gap": "eer"}))
        t_nudged = time.perf_counter() - t0 - t_data - t_replica

        # ---- the port, from the replica's init
        trainer = port_trainer(arch, epochs, device, os.path.join(work, "exp"),
                               init_net_sd, init_crit_sd)
        eval_set = EvalUtteranceSet([EvalUtterance(n, u.path) for n, (_, u)
                                     in zip(names, test_utts)],
                                    batch_size=16, bucket_frames=50, num_workers=2)
        ours_curve = {"loss": [], "eer": []}
        print("[port] training...", file=sys.stderr)
        for e in range(epochs):
            ep_loss = []
            for k in range(STEPS_PER_EPOCH):
                f, y = all_batches[e * STEPS_PER_EPOCH + k]
                metrics = trainer.train_step_feats(torch.from_numpy(f).to(device),
                                                   torch.from_numpy(y).to(device), MARGIN)
                ep_loss.append(metrics["loss"])
            store = trainer.extract_embeddings(eval_set)
            ours_curve["loss"].append(float(np.mean([float(v) for v in ep_loss])))
            ours_curve["eer"].append(float(cosine_eer(trials, store, device=device)[0]))
            print(f"[port] epoch {e+1}: loss={ours_curve['loss'][-1]:.4f} "
                  f"eer={ours_curve['eer'][-1]*100:.2f}%", file=sys.stderr)
        t_port = time.perf_counter() - t0 - t_data - t_replica - t_nudged
        n_target = int(np.sum(trials.labels == 1))
        eer_quantum = 1.0 / min(n_target, len(trials) - n_target)

    # ---- report
    gap = epoch_loss_gap(torch_curve, ours_curve)
    final_eer_gap = abs(torch_curve["eer"][-1] - ours_curve["eer"][-1])
    report = {
        "recipe": {"loss": "LMCL", "scale": SCALE, "margin": MARGIN,
                   "optimizer": f"SGD lr={LR} momentum={MOMENTUM} wd={WD}",
                   "milestones_epochs": MILESTONES, "bs": BS,
                   "epochs": epochs, "steps_per_epoch": STEPS_PER_EPOCH,
                   "arch": {"name": args.arch, **arch}},
        "torch": torch_curve,
        "deeplip_tpu_torch": ours_curve,
        "max_epoch_loss_gap": gap,
        "final_eer_torch": torch_curve["eer"][-1],
        "final_eer_deeplip": ours_curve["eer"][-1],
        "final_eer_abs_gap": final_eer_gap,
        "eval_batches": eval_set.n_batches,   # one extraction's, K1 once each on the card
        # the replica's run overlaps the batches' features
        "seconds_parts": {"data": t_data, "replica_and_features": t_replica, "nudged": t_nudged,
                          "port": t_port},
    }
    if runs:
        report["nudged"] = runs
    lines = [
        "# Convergence study, audio: the reference recipe's torch replica against the "
        "PyTorch port",
        "",
        "One shared hard synthetic corpus (12 speakers sharing one resonance stack, small",
        "per-speaker perturbation, strong noise: `data/synthetic.py:make_hard_audio_corpus`),",
        "one shared speaker-balanced crop-and-concat batch stream (reference collate",
        "semantics, python_speech_features' f64 MFCC with CMVN), one shared init (the",
        "replica's, loaded by the port), the reference LMCL/SGD/MultiStepLR recipe on both",
        f"sides. Widths `{args.arch}`: TDNN {arch['hidden_dim']}, embedding",
        f"{arch['embedding_dim']}; bs {BS}; {epochs} epochs x {STEPS_PER_EPOCH} steps; "
        f"LR {LR} x0.1 at epochs {MILESTONES}.",
        "",
        "| epoch | torch loss | port loss | torch EER | port EER |",
        "|---|---|---|---|---|",
    ]
    for e in range(epochs):
        lines.append(
            f"| {e+1} | {torch_curve['loss'][e]:.4f} | "
            f"{ours_curve['loss'][e]:.4f} | {torch_curve['eer'][e]*100:.2f}% "
            f"| {ours_curve['eer'][e]*100:.2f}% |")
    lines += [
        "",
        f"Max per-epoch mean-loss gap: **{gap:.4f}**; final EER "
        f"torch **{torch_curve['eer'][-1]*100:.2f}%** vs port "
        f"**{ours_curve['eer'][-1]*100:.2f}%** (abs gap {final_eer_gap*100:.2f} pp).",
        "",
        "Identical init, batches and recipe; the residual divergence is f32 noise",
        "amplified by LMCL's scale-30 softmax, so the curves track each other epoch by",
        "epoch and are not expected to be bit-equal.",
    ]
    return finish_study(report, args, device, t0, {"final_eer_abs_gap": final_eer_gap},
                        {"final_eer_abs_gap": eer_quantum},
                        {"final_eer_abs_gap": PC.metric_reach(torch_curve["eer"][-1], 0.5)},
                        lines,
                        {"max_epoch_loss_gap": gap, "final_eer_torch": torch_curve["eer"][-1],
                         "final_eer_deeplip": ours_curve["eer"][-1]})


if __name__ == "__main__":
    main()
