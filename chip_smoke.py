#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository's
``deeplip_tpu_torch`` package beside this script; without a card, or
without the package, it exits non-zero and prints no result. Phases:

1. Device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions. Every number printed after it was taken on that card.
2. Build every kernel from ``deeplip_tpu_torch/csrc`` (one nvcc per source,
   started together) and print ptxas' register/spill report.
3. Each front-end kernel against its plain PyTorch version on the card,
   TF32 off, on raw PCM with and without ragged ``sample_lengths`` (whole,
   cut, short, empty rows): mfcc-24 (energy on and off), fbank-24 and
   logfbank-60 at 24/200/203/299/331 frames, and thirteen configs at other
   rates and FFT sizes (n_fft 64 to 4096 in powers of two; 400 with
   Whisper's logfbank-80, 480, 510, 441 at 44.1 kHz, 768 at 48 kHz, 66
   and 4095), within atol 2e-4 / rtol 1e-3; the per-kernel counters show
   that each case went to the kernel the dispatch rule names (every n_fft
   in [64, 4096] to the FFT route: its power-of-two plan, or its
   mixed-radix and Bluestein plan at any other size); log-mel band 0 of
   the MFCC configs held alone; an empty row equal to the plain guarded
   zero; each route's largest error named and held against the plain
   version in float64, and at 441 with 40 filters (single-bin filters)
   each version's misses of the bar against float64.
   At the 256 x 3 s batch: the FFT kernel, the plain version and the plain
   ``dft='fft'`` front-end (cuFFT) in turns, by CUDA events, beside the
   least time the card could take for the function and the time of the
   kernel's own operations; logfbank-60 on the FFT kernel, with its DC bin
   against float64 beside the plain versions'; at n_fft 400, 480 and 510
   the mixed-radix route, the plain version and ``dft='fft'`` the same way.
4. The main path through the user's entry points at the flagship E-TDNN
   width (seeded random weights, BN statistics calibrated on one batch
   and then perturbed): a ragged
   PCM16 wav corpus → ``EvalUtteranceSet`` (``eval_set_kwargs`` defaults,
   batch 64) → ``AudioExtractor.extract_embeddings`` → ``cosine_eer``. Launch
   counts are read just before and just after: K1 once and T's eval
   apply once a block a batch. Two batches are
   re-embedded with the plain front-end and must agree to 1e-4.
5. A first number for the lomgrid sweep shape: 3,541 x 3 s int16
   utterances staged on the card, batch 256, 20,000 gathered cosine trials,
   by CUDA events after a warm-up sweep; 14 FFT-kernel launches a sweep,
   none of the mixed-radix plan, and T's eval apply once a block a batch.
6. The fused train-mode BN+PReLU kernels (K3 forward, K4 backward) against
   their plain versions at the five activation shapes of a bs 128 x 29-frame
   Lipreading step, in f32 and bf16: y, mean, var and dx within atol/rtol
   1e-5 (f32; y and dx 2e-2 / 1e-2 in bf16), dscale, dbias and dalpha within
   1e-4 of the plain version's largest. Kernel, plain and library
   (``F.batch_norm`` + ``F.prelu``, two calls) times by CUDA events, beside
   the least time the card could take (3|x| bytes forward, 5|x| backward).
7. The video main path through the user's entry points at the flagship
   Lipreading width (``conf/video_config.json``, seeded random weights): a
   synthetic 32-speaker x 8-clip 96x96 uint8 ``.npz`` corpus of 21-29 frames
   → ``scan_clip_dir`` → ``VideoClipBatches`` (batch 128, bucket 8) →
   ``VideoTrainer.train`` (one epoch) → ``extract_clip_embeddings``. K3/K4
   launch counts are read just before training and just after: three
   launches per site and pass (partial, finalize, apply), nine sites, so 27
   forward and 27 backward per step. K3/K4 are then held against their
   plain versions, with the bars of phase 6, at every shape the training
   epoch gave them.
8. One bs 128 x 29 step through the kernels against one through the plain
   BN+PReLU (``plain_bn_prelu``) from the same state, FP32 and cuDNN
   deterministic: loss within 1e-5 relative; the batch mean and variance
   at every fused site within 1e-5 (the mean in sigmas, the variance
   relative); the gradients no further from the plain step's than 3x what
   a 1e-6 relative nudge of the input frames moves the plain step's own
   (their norm over the whole network); K4 alone, on bit-equal
   activations, within 1e-4 of that norm. Planted K3 faults (the batch
   variance off by 1e-6, 1e-5 and 1e-4 relative; the statistics held in
   bf16) run through the same bars, and the last two must fail one of
   them. Then ms per train step and clips/s after
   warm-up, the kernels' share of a step, and one profiled step's device
   time by kernel. The frontend max-pool runs its kernels in these steps
   too (one forward and one backward launch per step, counted in phase 7)
   and is swapped for its plain version in the plain steps.
9. The frontend max-pool kernels (``csrc/maxpool_kernel.cu``) against their
   plain version (``F.max_pool3d``) at the training step's shape
   (128, 29, 44, 44, 64), one serving chunk's (32, 32, 44, 44, 64), an
   odd-sized shape, a batch with tied pad frames and the backward's edges
   (C = 4 and 12, frames of 1 to 3 pixels a side, 70,400 frames, a
   600-pixel width, 4,096 channels), f32 and bf16: y bit-equal; the
   positions and dx bit-equal to ``maxpool_positions_reference`` and
   ``maxpool_backward_reference``; dx within 1e-6 of the plain largest
   (f32), one bf16 step against the f32-computed plain gradient (bf16);
   NaN propagated and its window's gradient routed as the plain versions
   do. Kernel, plain and library times by CUDA events beside the byte
   bounds, and the backward's share of its bound.
10. The audio-visual serving path through the user's entry points at the
   full width of ``conf/fusion_config.yaml`` (flagship E-TDNN and
   Lipreading, 2 clips x 32 frames, 88x88 crop; seeded weights with
   calibrated BN statistics, saved as checkpoints and loaded through the
   config's ``resume`` keys): a synthetic 32-speaker corpus of 1-3 s PCM16
   wavs with two 96x96 uint8 ``.npz`` clips each → ``AVSpeakerVerifier`` →
   ``calibrate`` on a written trial list → ``enroll`` 32 speakers x 2 items
   → ``verify`` and ``identify``, with the concat and with
   ``use_fusion_head``. The front-end and max-pool kernels launch once per
   extraction chunk (counts read before and after); two chunks are
   embedded again through the plain versions of both (parts within 1e-4).
   Then ``SpeakerVerifier`` with an AS-norm cohort behind a
   ``MicroBatcher``: concurrent ``verify`` requests from 16 threads against
   the same requests served directly (decisions equal; the largest
   difference between an embedding served alone and in a batch, bar 1e-5;
   K1 once and T's eval apply once a block an extraction pass), and a
   batch-1 verify's latency with host and with device scoring.

11. Audio x-vector training at the full width of ``conf/audio_config.yaml``
   (loaded from the file, as phase 10 loads ``conf/fusion_config.yaml``)
   (flagship E-TDNN, MFCC-24, LMCL scale 30 / margin 0.2, SGD, bs 256, crops
   of 200-400 frames in 11 buckets, bf16): a synthetic 128-speaker x 8
   PCM16 wav corpus of 2-5 s (and 2 wavs a speaker held out) and its
   manifest (``write_manifest``) →
   ``cli/train_audio.py --mode train`` for 2 epochs (the config's recipe
   with its paths pointed at the corpus) → the average of the 2 epochs'
   checkpoints → extraction of a 256-utterance test set held out of training
   and its cosine EER.
   Front-end launch counts are read just before and just after: one
   FFT-kernel launch per train step and per extraction batch, none of the
   mixed-radix plan. K1 against its plain version on every batch of both epochs
   (CMVN after, atol 2e-4 / rtol 1e-3) with its time at each crop shape.
   One f32 step through K1 against one through the plain front-end from the
   same state (TF32 off, cuDNN deterministic) at bs 256 x 300: loss within
   1e-4 relative, gradients no further than 3x what a 1e-6 elementwise
   relative nudge of the PCM moves the plain step. A bf16 step within 2e-2
   of the f32 step's loss and within 0.25 of its gradients' norm, and
   within 1e-4 of the loss of the same bf16 step with the TDNN blocks'
   eager ops (the recipe T follows; the distance from the f32 step's loss
   depends on the state training reached, 3.4e-5 to 5.2e-4 with the eager
   blocks across corpus seeds, so it takes no bar finer than 2e-2), its
   forward audited (bf16 conv blocks; BN statistics,
   pooling and the cosine logits against float64), and four planted bf16
   faults (BN statistics, pooling, cosines in bf16; cosines in TF32) each
   caught. T's launches: 3 + 4 a block a train step, 1 a block an
   extraction batch. Then ms per step and crops/s at bs 256 x
   200/300/400 in bf16 and f32 by CUDA events, K1's share of a step beside
   its bound, peak memory, and one profiled bf16 step's device time by kind.

12. Fusion training at the full train width of ``conf/fusion_config.yaml``
   (flagship E-TDNN and Lipreading, LowFER, CrossEntropy, SGD lr 0.5, bs 60,
   2 clips x 32 frames, crops of 200-400 frames): a synthetic 64-speaker x 8
   PCM16 wav corpus of 2-5 s with two 96x96 clips an utterance (none for
   every 10th training utterance) and its manifest; encoders with seeded
   weights and calibrated BN saved and named by the config's ``resume``
   keys → ``cli/train_fusion.py --mode train`` for 2 epochs → the average
   of the last 2 → the held-out trial list's EERs. Launch counts read
   before and after: one FFT-kernel and one pool-forward launch per
   train step and per extraction chunk, and T's eval apply once a block of
   the frozen E-TDNN, none of P backward, K3/K4, T's train kernels or the
   mixed-radix plan. LowFER's dead ``U``/``V`` bit-equal before and after. One f32
   step through K1 and P against one through the plain front-end and pool
   from the same state (TF32 off): loss within 1e-5 relative, the head and
   criterion gradients within 3x what a 1e-6 elementwise nudge of the PCM
   and the frames moves the plain step. A bf16 step audited against
   float64 (audio pooling and video group mean >= f32, criterion logits
   f32) with three planted faults (each of those in bf16) that must be
   caught. ms per step and pairs/s at 200/300/400 frames in f32 and bf16,
   the parts' times, each alone (K1, P, the encoders, the head with its
   backward and SGD), P at the
   train shape against its bound and ``F.max_pool3d``, peak memory and one
   profiled f32 step.
13. bf16 video training: phase 7's corpus through ``cli/train_video.py
   --compute-dtype bf16`` at bs 128 for one epoch, then ``--extract-feats``
   from that checkpoint (one ``(1, T, 512)`` f32 npz per clip, equal to
   ``VideoTrainer.extract_clip_features``). K3/K4 27 + 27 and P 1 + 1
   launches per step, K3/K4 held against their plain versions at every
   bf16 shape the epoch gave them (phase 6's bf16 bars). One bs 128 x 29
   bf16 step against an f32 step from one state, the bf16 forward audited
   against float64 (K3 statistics, the trunk's spatial mean, the TCN
   convolutions, the logits) with three planted faults (statistics, trunk
   mean, TCN in bf16) that must be caught; the bf16 and f32 step times in
   turns, K3/K4's bf16 time per step beside its byte bound, one profiled
   bf16 step with the frontend Conv3d's backward.

14. Grouped train-step dispatch (``steps_per_dispatch: K > 1``): K steps
   captured as one CUDA graph and replayed, K1, K3/K4 and P inside it.
   Audio: phase 11's corpus and ``conf/audio_config.yaml`` with K = 4,
   6 epochs, the rate decayed after epoch 2 and the LMCL margin 0.2 -> 0.35
   after epoch 5 (the trainer's own switch); in f32 (TF32 off, cuDNN
   deterministic) at one crop length of 300 frames, so one graph lives
   through the decay and the margin switch: grouped against single steps from one state, each step's loss
   within 1e-5 relative, the final parameters within 3x what a 1e-6 nudge
   of the PCM moves the single run; the rate and the margin frozen at
   capture (planted) are each caught; then the config's bf16 recipe for 3
   epochs (its 11 crop lengths drawn in runs of K, a graph for each length
   drawn) within phase 11's bf16 bar. K1 launches
   once per step, counted over the replays (and once for each of the K
   eager steps that precede a capture). ms per step single and grouped at bs 256 x 300
   in bf16, peak memory both ways, one profiled group's idle share. The
   f32 run's last checkpoint, exported by ``cli/export_torch.py
   --dp-prefix`` as a reference ``.pth``, enrolls through ``cli/verify.py
   --checkpoint`` to the profile the port's own checkpoint gives. Video: a
   32-speaker x 16-clip corpus of 29 frames through ``cli/train_video.py
   --steps-per-dispatch 2`` for 1 epoch at bs 128 (4 steps, two groups on
   one graph, so one replay runs on clips the capture never saw), f32 and
   bf16, against single steps from the same seed (TCN dropout 0.2: the
   replayed masks are the eager ones), with the same bars (bf16: phase
   13's); K3/K4 27 +
   27 and P 1 + 1 per step over the replays; ms per step both ways, peak
   memory, one profiled group. Last, a step that cannot be captured
   raises, no eager step runs in its place, and the card's random-number
   generator is not left capturing (an eager dropout runs after it).

14b. Captures under memory pressure, in a subprocess of their own (run
   right after phase 2, so that it has the card to itself and a cuDNN plan
   taken there for want of memory reaches no other phase): phase 14's f32
   video group, first with nothing held (held to phase 14's bars against
   the process's own single and nudged runs), then with that run's trainer
   and graphs kept alive, with one allocation leaving 30 GB free, with one
   leaving 1.25x the group's peak + 4 GB, and with the memory back. The
   runner must refuse a capture during which an allocation failed (or the
   card ran out of memory) or whose first replay is not bit-equal to the
   K eager steps; every run it does not refuse meets phase 14's f32 bars
   against a single run made right after it with the pressure gone; at
   least one capture must be refused; any other failure fails the phase.

15. The model and front-end variants. (a) ``conf/audio_config.yaml`` with
   ``arch: resnet`` (64/128/256 channels x 3/3/3 BasicBlocks, embedding
   256) on phase 11's corpus through ``cli/train_audio.py``, one epoch in
   f32 and one in bf16: K1 once per step and extraction batch, the held-out
   EER; phase 11's step rule (a K1 step against the plain front-end: loss
   1e-4, gradients 3x a 1e-6 nudge), the bf16 step audited against float64
   (BN statistics and the pooled vector 1e-4, cosines 2e-6) with planted
   faults caught, and its step times at 200/300/400 frames. (b) The flagship
   E-TDNN with each attentive pooling (seeded, calibrated): K1 against the
   plain front-end on a ragged 256 x 1-3 s batch (1e-4), a bf16 train step
   at bs 256 x 300 timed beside the statistics pooling's, and
   ``cli/export_torch.py --pooling`` (attentive statistics, mono-head) read
   back by ``SpeakerVerifier`` to a bit-equal profile. (c)
   ``conf/video_config.json`` with the ShuffleNetV2 trunk (width 1.0) and
   the depthwise-separable TCN on phase 7's corpus through
   ``cli/train_video.py``, one f32 and one bf16 epoch at bs 128 (3 + 3
   K3/K4 and 1 + 1 P launches a step: the 24-channel frontend is the one
   fused site), then ``--extract-feats`` ((1, T, 1024) npz); K3/K4 and P at
   (128, 29, 44, 44, 24) against their plain versions with times and
   bounds; one f32 step against the plain step (phase 8's rule at the one
   site); the bf16 trunk asserted f32; f32 and bf16 step times, peak
   memory, a profiled step of each; a reference ``.pth`` export read back
   to bit-equal frame features. (d) The config's ``stft`` section on a
   ragged 256 x 1-3 s batch against float64 (1e-4), its time beside K1's
   MFCC time, and one E-TDNN extraction batch at 257 features.

16. Kaldi features and host I/O. (a) The native IO library
   (``deeplip_tpu_torch/native/wavio.cpp``, built by g++ beside nvcc in
   phase 2, its wall time logged) reads every wav of phase 11's corpus
   (``read_wav``, ``read_wav_batch_i16``) bit-equal to the stdlib readers
   and every clip of phase 7's (``read_npy_batch``, ``probe_npy_shapes``)
   bit-equal to ``np.load``. (b) One epoch of ``conf/audio_config.yaml``
   with its default ``loader: native``, every batch bit-equal to ``loader:
   python``'s, K1 once a step. (c) MFCC-24 with CMVN over each utterance,
   computed by K1 on the card for the 1,024 training utterances, written
   as a Kaldi ark/scp (``interop/kaldi.py``) and read back bit-equal; the
   config with ``data_format: kaldi`` trained for 2 epochs (128 speakers,
   ``net_1``/``net_2``, finite losses, no front-end launch). From one
   state, f32: a step on a batch of crops' features read back from an ark
   against the PCM step on those crops (loss 1e-5 relative, gradients 3x a
   1e-6 nudge of the PCM); the Kaldi and the PCM bf16 steps timed at bs 256
   x 200/300/400. (d) Each host pipeline alone, in batches/s on the card
   machine's host (median of 3 passes of 8 batches, with the spread), beside
   the rate of the step it feeds: ``AudioTrainPipeline`` with the stdlib and
   the native reader, ``KaldiTrainPipeline``, ``VideoClipBatches`` with the
   native reader and with ``np.load``. (e) FLOPs of the bf16 Kaldi and PCM
   steps at bs 256 x 300 by ``FlopCounterMode``, within 10 % of the hand
   count (``tdnn_train_flops``), their TFLOP/s and MFU against the H100's
   dense bf16 peak (``train/flops.py``). (f) Phase 4's embeddings through
   ``EmbeddingStore.save_kaldi``, ``cli/kaldi_xv.py`` ``from-kaldi`` and
   ``to-kaldi`` and ``load_kaldi``, bit-equal; the Kaldi run's TensorBoard
   file parsed with every record's CRC checked, its losses the JSON
   records'.

17. The process group on the card. An NCCL group of world size 1 joined
   through ``core/distributed.initialize`` on a local ``FileStore`` (no
   network), and the data mesh over it (``core/mesh.make_mesh``). (a) K3/K4
   under the group, where each finalize runs as two passes (chunk totals to
   float64, then statistics) with the all-reduce of the totals between
   them: at the nine sites' shapes of a bs 128 x 29 step in f32 and bf16,
   every output bit-equal to the single-process kernels', 4 launches a call
   (2 of them the split passes), and within phase 6's bars of the plain
   versions under the same group; the split passes timed alone beside their
   plain version, their bound and the all-reduce. (b) One audio bf16 step
   (bs 256 x 300; the TDNN blocks' eager BN on both sides, since T takes
   no group yet), one video f32 step (bs 128 x 29) and one fusion f32 step
   (bs 60 x 300) under the group, each bit-equal (loss, every parameter and
   buffer) to the same step without it from one state, with their launches
   (the video step's K3/K4 36 + 36, 18 + 18 of them the split passes) and
   their ms per step with and without the group, in turns, by CUDA events.
   (c) A grouped audio capture (K = 4, f32) under the group, the all-reduces
   inside the graph, held to phase 14's bars against 4 single steps under
   the group.

18. The mixed-radix route through the user's entry points: the flagship
   E-TDNN (seeded, calibrated) with ``n_fft: 400`` in place of 512 (the
   torchaudio and Whisper size) through ``AudioExtractor.extract_embeddings``
   on a ragged 64-utterance corpus, one launch of the mixed-radix route per
   batch and none of the others (counts read before and after), every
   batch re-embedded through the plain front-end within 1e-4; then one f32
   ``AudioTrainer`` step of ``conf/audio_config.yaml`` at that ``n_fft``
   (bs 256 x 300, TF32 off, cuDNN deterministic) against one through the
   plain front-end from the same state, by phase 11's rule.

19. The repo's verification scripts, the port's own, each in a process of
   its own on the card (``python -m``; a nonzero exit fails the phase):
   ``cli/parity_check.py --full`` (the 20,000-trial protocol: 400
   utterances through K1 and the E-TDNN at full width, embedding 512,
   against the numpy MFCC and the torch replica on the CPU; embeddings
   within 1e-4, the EER bit-equal, K1 launched, T's eval apply once a
   block a batch); ``--train-parity`` (the
   CrossEntropy f32 and LMCL f64 recipes to a final drift of 1e-5, the
   port's steps on the card, T's train kernels launched);
   ``--train-parity-video`` (float32 on the
   card, through K3/K4 and P) and ``--train-parity-fusion`` (float32,
   from raw PCM and clips, through K1, P and T), each held to the f32 step
   rule against three nudged runs of the replica, each kernel launched;
   the video rule run again in this process with K4's dx scaled by 1.01
   (planted), which it must fail by its first-step gradients;
   ``examples/full_pipeline_demo.py`` (audio, video and fusion training,
   the fusion head on the encoders the first two saved, five EERs, each
   stage's seconds, K1, K3/K4, P and T launched); ``examples/verify_demo.py``
   (the serving API, its config written as YAML and read back by the
   port's reader; K1 and T launched); ``cli/prepare_data.py audio --resample
   16000`` on a 44.1 kHz mono and stereo wav tree the phase writes (the
   manifest lists each wav once at 16 kHz, each output
   ``resampled_length`` samples long). Each kernel's launches by script go
   into the ``kernels`` record.

20. The research drivers, the port's own, all four at once, each in a
   process of its own on the card (a nonzero exit fails the phase):
   ``cli/convergence_study.py`` (audio, 10 epochs), ``cli/
   convergence_video_study.py`` (14 epochs) and ``cli/
   convergence_fusion_study.py`` (the JAX study's r05 corpus, 16 epochs),
   each with ``--arch flagship --nudges 3``: every curve finite and as
   long as its epochs, the port held to ``parity_check.convergence_rule``
   against the three nudged replica runs, every kernel's launches exactly
   those that the study's epochs, steps and batches make (K1 once an
   extraction batch in the audio study; K3/K4 27 a step, the max-pool's
   backward once a step and its forward once a step and twice an
   evaluation, the frontend conv's weight gradient once a step, in the
   video study; K1 and the max-pool's forward once a
   step and once an evaluation in the fusion study; T 3 + 4 a block a
   step and 1 a block an extraction batch in the audio study, 1 a block a
   step and an evaluation of the fusion study's frozen E-TDNN; none
   else); and
   ``cli/resample_study.py`` at its defaults: the PCM delta of
   kaiser_best against polyphase within 1e-6 of
   ``docs/resample_r04.json``'s (host arithmetic on the same seeds), the
   loss falling over its 30 steps (its fixed probe's loss after them at
   most ``resample_study.LEARNED_RATIO``, 0.7, of its loss at init), K1
   launched once a step, a probe batch
   and an extraction batch (T 3 + 4 a block a step, 3 a block a probe
   batch, whose forward runs in train mode without a backward, 1 a block
   an extraction batch). Each study's curves, gaps,
   bars and seconds are logged, its report kept under ``exp/studies/``,
   and each kernel's launches by study go into
   the ``kernels`` record.

21. The frontend Conv3d's weight-gradient kernel
   (``csrc/conv3d_wgrad_kernel.cu``) against its plain version in float64,
   within 1e-5 of the float64 result's largest, at (128, 29, 88, 88) x 64
   and x 24, at bands that do not divide the output rows,
   at the video study's 44 x 44 crop, at rows of no multiple of four
   pixels, at one frame and at frames under a band; two runs and two
   CUDA-graph replays bit-equal at the train step's shapes; 32 channels and
   float64 refused; kernel, plain and
   library (``torch.nn.grad.conv3d_weight``, cuDNN's FP32 weight gradient)
   times beside the least time for its FP32 operations. Then the routing:
   the routed frontend forward bit-equal to ``conv_nhwc``'s, its weight
   gradient within the same bar of cuDNN's, one launch a flagship f32 video
   train step and none for f32 extraction or a bf16 step.
   ``python3 chip_smoke.py --conv3d-wgrad`` runs phases 1, 2 and 21 alone
   and prints one JSON line.

22. The TDNN blocks' fused conv bias + BN + LeakyReLU (T,
   ``csrc/tdnn_bn_act_kernel.cu``) at the cells' shapes, (256, 512, 295)
   and (256, 1500, 277): the bf16 train forward and backward against their
   plain versions and the eager bf16 ops whose rounding they follow (phase
   6's bars), bit-equal on a rerun, with each one's distance from float64
   and the conv bias gradient's size beside the eager ops'; the f32 eval
   apply against the eager ops (bit-equal is the aim, 1e-6 of the largest
   the bar); a train step and an eval apply captured in a CUDA graph and
   replayed twice bit-equal; float64 and a non-contiguous activation
   refused; T, plain and eager times beside the bound (each input read
   once, each output written once). Then on ``conf/audio_config.yaml``'s
   E-TDNN at bs 256 x 300: 3 + 4 launches a block in a bf16 train step and
   1 a block in an f32 extraction batch, none with the eager blocks, whose
   output strides T's match; phase 11's step rule (a T step against a step
   through T's plain versions, within 3x a 1e-6 PCM nudge, f32 and bf16);
   the bf16 T step against the eager blocks' bf16 step (loss within 1e-4,
   gradients within the same 3x); its bf16 audit and its four planted
   faults; one profiled bf16 step. ``python3 chip_smoke.py --tdnn-bn-act``
   runs phases 1, 2 and 22 alone and prints one JSON line.

23. The ResNet trunk's BN + PReLU eval apply (``bn_prelu_eval`` in
   ``csrc/bn_prelu_kernel.cu``) at the fusion step's site shapes (3,840
   frames: 44 x 44 x 64, 22 x 22 x 64, 11 x 11 x 128, 6 x 6 x 256,
   3 x 3 x 512) in the forms each takes (plain, identity residual, BN
   residual), f32 and bf16: bit-equal to the eager modules it replaces and
   on a rerun, timed beside them and beside its byte bound (inputs read
   once, y written once), the frontend site at 70 % of that bound or more,
   and the sums over a fusion step's 17 sites; the three forms captured in
   a CUDA graph and replayed twice bit-equal to eager runs; then 17
   launches an eval ``frame_features`` call of the ResNet-18 Lipreading,
   bit-equal to the eager trunk, and none in its train step or in the
   audio ResNet's eval call. ``python3 chip_smoke.py --bn-prelu-eval`` runs
   phases 1, 2 and 23 alone and prints one JSON line.

The phases run in the order 1, 2, 14b, 19, 20, 17, 3-5, 18, 11, 6, 9, 21,
22, 23, 7, 8, 10, 12, 13, 14, 15, 16; each one's wall seconds are logged and
kept in the summary's ``phase_seconds``, and phase 14's by part (corpora, grouped runs,
timing captures, profiled groups, the reference ``.pth``, the failed
capture) in ``phase_14_parts_seconds``. The last line is
``{"ok": true, "device": {...}}``; the line before it is the ``kernels``
JSON record.

    python3 chip_smoke.py --study-faults

runs the video and fusion convergence studies of phase 20, at its size and
flags, once for each planted fault of :data:`STUDY_FAULTS` (K4's dx scaled
by 1.01; the port's learning rate scaled), and prints whether
``convergence_rule`` failed each, with its gaps and bars, as one JSON line.

    python3 chip_smoke.py --k1-against OTHER/deeplip_tpu_torch/csrc/fbank_fft_kernel.cu

holds this checkout's FFT kernel against another checkout's (an earlier
commit's, unpacked by ``git archive``), built with the same nvcc flags:
bit for bit at phase 3's power-of-two cases and at the 256 x 3 s batch
(mfcc-24 and logfbank-60), both timed in turns. Then it forces the
mixed-radix kernel onto the power-of-two plans 512 to 4096, holds it to
the plain version within phase 3's bars and times it in turns against the
FFT kernel at that batch. It prints one JSON line and exits non-zero when
an output differs by a bit or misses a bar.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import gc
import glob
import itertools
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from deeplip_tpu_torch import native  # noqa: E402
from deeplip_tpu_torch.cli import (convergence_fusion_study, convergence_study,  # noqa: E402
                                   convergence_video_study)
from deeplip_tpu_torch.cli import export_torch as export_torch_cli  # noqa: E402
from deeplip_tpu_torch.cli import kaldi_xv as kaldi_xv_cli  # noqa: E402
from deeplip_tpu_torch.cli import parity_check as parity_check_cli  # noqa: E402
from deeplip_tpu_torch.cli import train_audio as train_audio_cli  # noqa: E402
from deeplip_tpu_torch.cli.common import utterances_from_trials  # noqa: E402
from deeplip_tpu_torch.cli import train_fusion as train_fusion_cli  # noqa: E402
from deeplip_tpu_torch.cli import train_video as train_video_cli  # noqa: E402
from deeplip_tpu_torch.cli import verify as verify_cli  # noqa: E402
from deeplip_tpu_torch.cli.train_fusion import build_video_map, make_trainer  # noqa: E402
from deeplip_tpu_torch.core.config import (AUDIO_DATA_OPTS, ETDNN_MODEL_OPTS, Config,  # noqa: E402
                                           load_audio_config, load_fusion_config)
from deeplip_tpu_torch.data.audio_io import (read_wav, read_wav_int16,  # noqa: E402
                                             resampled_length, write_wav)
from deeplip_tpu_torch.data.fusion_pipeline import AVTrainPipeline  # noqa: E402
from deeplip_tpu_torch.data.audio_pipeline import (EvalUtterance,  # noqa: E402
                                                   EvalUtteranceSet,
                                                   eval_set_kwargs)
from deeplip_tpu_torch.data.kaldi_dataset import KaldiTrainPipeline  # noqa: E402
from deeplip_tpu_torch.data.manifest import SpeakerManifest, Utterance, write_manifest  # noqa: E402
from deeplip_tpu_torch.eval.scoring import EmbeddingStore, cosine_scores  # noqa: E402
from deeplip_tpu_torch.interop.kaldi import read_scp, write_ark_scp  # noqa: E402
from deeplip_tpu_torch.losses import softmax as softmax_losses  # noqa: E402
from deeplip_tpu_torch.ops import features as F  # noqa: E402
from deeplip_tpu_torch.data.video_dataset import (VideoClipBatches, load_clip,  # noqa: E402
                                                   scan_clip_dir)
from deeplip_tpu_torch.ops import video as V  # noqa: E402
from deeplip_tpu_torch.ops.cuda import bn_prelu, build, conv3d_wgrad, fbank, maxpool  # noqa: E402,E501
from deeplip_tpu_torch.ops.cuda import launch_counts, tdnn_bn_act  # noqa: E402
from deeplip_tpu_torch.ops.cuda.fbank import (audio_features,  # noqa: E402
                                              audio_features_reference)
from deeplip_tpu_torch.ops.framing import num_frames, samples_for_frames  # noqa: E402
from deeplip_tpu_torch.models.norm import TorchBatchNorm  # noqa: E402
from deeplip_tpu_torch.models import tdnn as tdnn_model  # noqa: E402
from deeplip_tpu_torch.models.lipreading import frontend_conv  # noqa: E402
from deeplip_tpu_torch.models import resnet as resnet_model  # noqa: E402
from deeplip_tpu_torch.models.audio_resnet import AudioResNet  # noqa: E402
from deeplip_tpu_torch.models.lipreading import Lipreading  # noqa: E402
from deeplip_tpu_torch.models.resnet import PReLU, conv_nhwc, eval_bn  # noqa: E402
from deeplip_tpu_torch.serve import AVSpeakerVerifier, MicroBatcher, SpeakerVerifier  # noqa: E402
from deeplip_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from deeplip_tpu_torch.train import dispatch, flops, tb_events  # noqa: E402
from deeplip_tpu_torch.train.audio import (AudioExtractor, AudioTrainer, fp32_math,  # noqa: E402
                                           masked_cmvn)
from deeplip_tpu_torch.train import fusion as fusion_mod  # noqa: E402
from deeplip_tpu_torch.train.fusion import FusionTrainer, embed_av_items  # noqa: E402
from deeplip_tpu_torch.train.video import VideoTrainer  # noqa: E402
from deeplip_tpu_torch.interop import torch_import  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
AUDIO_CONFIG_PATH = os.path.join(REPO, "conf", "audio_config.yaml")
FUSION_CONFIG_PATH = os.path.join(REPO, "conf", "fusion_config.yaml")
ATOL, RTOL = 2e-4, 1e-3          # kernel vs plain (tests/test_pallas_features.py bar)
EMB_TOL = 1e-4                   # kernel-path vs plain-path embeddings
LOMGRID_UTTS, LOMGRID_TRIALS, BATCH, SECONDS, RATE = 3541, 20000, 256, 3.0, 16000

# The published dense peaks of the H100's parts (``train/flops.py``, from
# NVIDIA's data sheets): FP32 on CUDA cores, TF32 on tensor cores, HBM
# bytes/s, at the part's full power limit.
PEAKS = {part: (p["fp32"], p["tf32"], p["hbm"]) for part, p in flops.H100_PEAKS.items()}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> tuple[str, tuple[float, float, float]]:
    part = flops.h100_part(name) or "sxm"
    return part, PEAKS[part]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements outside atol {ATOL} / rtol {RTOL}, "
          f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def fft_flops(n_fft: int) -> float:
    """The function's least work for the complex ``n_fft/2``-point FFT
    inside a real ``n_fft``-point one: the fewer of the route's plan
    (``fbank.fft_flops``) and the usual 5 M log2 M for M = ``n_fft/2``
    points. The plan's count is the smaller at every power of two and at
    400, 480 and 768; 5 M log2 M is the smaller under Bluestein (510: the
    plan does some 4x that, which :func:`kernel_flops` counts) and at an
    odd ``n_fft``, whose plan transforms all ``n_fft`` points."""
    m = n_fft // 2
    return min(float(fbank.fft_flops(n_fft)), 5.0 * m * math.log2(m))


def front_end_work(b: int, s: int, cfg: F.FeatureConfig) -> tuple[float, float]:
    """``(flops, bytes)`` that the front-end function needs for a ``(b, s)``
    batch, whichever kernel computes it: pre-emphasis once a sample (2),
    one real FFT a frame (:func:`fft_flops`), the untangle (12 a bin, the
    two bins of a pair sharing their sums), the power (4 a bin), the mel
    sums over the filterbank's nonzero weights and, for MFCC, the energy
    sum, the DCT and the lifter. Bytes: PCM and lengths in, features out,
    the mel weights, DCT and lifter once."""
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    n = cfg.n_fft // 2
    _, weights = fbank.mel_csr(cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)
    per_frame = fft_flops(cfg.n_fft) + 12 * (n - 1) + 2 + 4 * (n + 1) + 2 * weights.size
    consts = weights.size
    d = cfg.num_bin
    if cfg.feat_type == "mfcc":
        dct_cols = cfg.num_cep - 1 if cfg.energy else cfg.num_cep
        per_frame += 2 * cfg.num_bin * dct_cols + cfg.num_cep + (n if cfg.energy else 0)
        consts += cfg.num_bin * cfg.num_cep + cfg.num_cep
        d = cfg.num_cep
    return (float(2 * b * s + b * t * per_frame),
            float(4 * (b * s + b + b * t * d + consts)))


def kernel_flops(b: int, s: int, cfg: F.FeatureConfig) -> float:
    """Operations that the FFT route's own algorithm does for a ``(b, s)``
    batch, beyond what :func:`front_end_work` counts for the function:
    pre-emphasis of each frame's own samples (2 a sample), the DC bin's sum
    in sample order (3 a sample), the FFT by the route's plan
    (``fbank.fft_flops``), the untangle of both bins of every pair apart (20
    a bin with the power; an odd ``n_fft`` takes the power alone, 3 a bin),
    the mel sums, and for MFCC the energy, the DCT and the lifter."""
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    n = cfg.n_fft // 2
    _, weights = fbank.mel_csr(cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)
    per_frame = (5 * cfg.frame_len + fbank.fft_flops(cfg.n_fft)
                 + (20 if cfg.n_fft % 2 == 0 else 3) * (n + 1))
    per_frame += 2 * weights.size
    if cfg.feat_type == "mfcc":
        dct_cols = cfg.num_cep - 1 if cfg.energy else cfg.num_cep
        per_frame += 2 * cfg.num_bin * dct_cols + cfg.num_cep + (n + 1 if cfg.energy else 0)
    return float(b * t * per_frame)


def bound(work: tuple[float, float], peaks) -> tuple[float, str]:
    """The least time in ms for ``(flops, bytes)`` at the FP32 and HBM
    peaks, and which of the two sets it."""
    ops_ms, bytes_ms = work[0] / peaks[0] * 1e3, work[1] / peaks[2] * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


# launch_counts() keys by kernel family: the front-end's two plans, the
# video kernels (K3/K4 and the max-pool), T, and K3/K4's split finalize
FBANK = ("fft", "mixed")
VIDEO = ("bn_prelu_fwd", "bn_prelu_bwd", "maxpool_fwd", "maxpool_bwd")
TDNN = ("tdnn_fwd", "tdnn_bwd", "tdnn_eval")
TOTALS = ("bn_totals_fwd", "bn_totals_bwd")


def launches_since(before: dict, keys: tuple) -> dict:
    """The launches of ``keys`` since ``before``, an earlier reading of
    ``launch_counts()``."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in keys}


@contextlib.contextmanager
def plain_front_end():
    """Route ``extract_features``' mel front-end through the kernels' plain
    version (on the same device) for an A/B check; launches nothing."""
    kernel = fbank.audio_features
    fbank.audio_features = audio_features_reference
    try:
        yield
    finally:
        fbank.audio_features = kernel


# ---------------------------------------------------------------- phase 1
def device_phase() -> dict:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(smi.splitlines()[0] if smi else name)
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    return {"name": name, "smi": smi.splitlines()[0] if smi else name}


# ---------------------------------------------------------------- phase 2
def build_phase() -> float:
    """Build the kernels and, beside them, the native IO library
    (``deeplip_tpu_torch/native/wavio.cpp``, g++); returns the native
    build's wall seconds."""
    def build_native():
        t0 = time.perf_counter()
        native.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(build_native)
        reports = build.build()
        native_s = native_build.result()
    log(f"build: {sorted(reports) or 'cached'} in {time.perf_counter() - t0:.1f} s; the "
        f"native IO library ({native.library_path().name}) in {native_s:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return native_s


# ---------------------------------------------------------------- phase 3
KERNEL_CONFIGS = [
    ("mfcc", {"num_bin": 26, "num_cep": 24, "energy": True}),
    ("mfcc", {"num_bin": 26, "num_cep": 24, "energy": False}),
    ("fbank", {"num_bin": 24}),
    ("logfbank", {"num_bin": 60}),
]
KERNEL_FRAMES = [24, 200, 203, 299, 331]
# other rates, hops and FFT sizes: a frame length and hop that are not
# multiples of 4 (22.05 kHz); the FFT kernel's two smallest sizes (64 and
# 128 points at 8 kHz: 128 and 64 frames a block) and 256 points; a
# 2048-point frame; its largest size (4096 points at 48 kHz, where the tile
# shrinks to fit shared memory). Then sizes that are no power of two, on
# the mixed-radix route: Whisper's log-mel (80 filters, some of them empty,
# n_fft 400 = 2 x 8 x 5 x 5, hop 160), a 30 ms frame (480 = 2 x 16 x 3 x 5),
# 510 (N = 255 = 3 x 5 x 17: Bluestein, M = 512), a 10 ms frame at 44.1 kHz
# (441 = 3^2 x 7^2, odd: the full complex DFT, hop 441, the 4-byte copies),
# a 16 ms frame at 48 kHz (768 = 2 x 16 x 8 x 3, the size the TPU's v2
# kernel takes), the smallest Bluestein size (66: N = 33, M = 128) and the
# largest (4095, odd: M = 8192, one frame a block)
OTHER_CONFIGS = [
    ("mfcc", {"rate": 22050, "n_fft": 1024, "num_bin": 40, "num_cep": 13}),
    ("mfcc", {"rate": 8000, "n_fft": 64, "win_len": 0.008, "win_shift": 0.004,
              "num_bin": 16, "num_cep": 12}),
    ("logfbank", {"rate": 8000, "n_fft": 128, "win_len": 0.016, "win_shift": 0.008,
                  "num_bin": 20}),
    ("logfbank", {"rate": 8000, "n_fft": 256, "num_bin": 23}),
    ("fbank", {"n_fft": 2048, "num_bin": 40, "win_len": 0.128}),
    ("logfbank", {"rate": 48000, "n_fft": 4096, "win_len": 0.085, "num_bin": 80}),
    ("logfbank", {"n_fft": 400, "num_bin": 80}),
    ("mfcc", {"n_fft": 480, "win_len": 0.03}),
    ("mfcc", {"n_fft": 510}),
    ("mfcc", {"rate": 44100, "n_fft": 441, "win_len": 0.01}),
    ("logfbank", {"rate": 48000, "n_fft": 768, "win_len": 0.016, "num_bin": 40}),
    ("mfcc", {"rate": 8000, "n_fft": 66, "win_len": 0.008, "win_shift": 0.004,
              "num_bin": 12, "num_cep": 10}),
    ("logfbank", {"rate": 48000, "n_fft": 4095, "win_len": 0.085, "num_bin": 64}),
]
# 40 filters at 441 points and 44.1 kHz: the lowest filters hold one bin
# each (or none), so a log-mel band is the log of one bin's power, which in
# f32 neither route nor the plain version gives within the bar of float64
# in every frame (ill_conditioned_witness)
ILL_CONDITIONED = ("mfcc", {"rate": 44100, "n_fft": 441, "win_len": 0.01, "num_bin": 40,
                            "num_cep": 13})
MIXED_TIMED = (400, 480, 510)     # n_fft of the mixed-radix route timed at 256 x 3 s
OTHER_FRAMES = [24, 203]


def ragged_lengths(n: int) -> torch.Tensor:
    """Four rows: whole, cut inside a frame, short, and empty."""
    return torch.tensor([n, n - 1 - n // 3, n // 5 + 3, 0], dtype=torch.int32, device="cuda")


def launch_one(cfg: F.FeatureConfig, x: torch.Tensor, lengths, what: str) -> torch.Tensor:
    """``audio_features`` once, checking from the counters that it went to
    the kernel the dispatch rule names, and to it alone."""
    kind = fbank.front_end_kernel(cfg)
    before = launch_counts()
    got = audio_features(x, cfg, lengths)
    moved = launches_since(before, FBANK)
    check(moved == {k: int(k == kind) for k in FBANK},
          f"{what}: launches moved {moved}, not one of the {kind} kernel")
    return got


def f64_reference(x: torch.Tensor, cfg: F.FeatureConfig, lengths) -> torch.Tensor:
    """The plain version in float64 on the same f32 PCM, pre-emphasised by
    the f32-rounded coefficient that the kernels and the f32 plain version
    multiply by: the value both f32 versions approximate."""
    cfg64 = dataclasses.replace(cfg, preemph=float(np.float32(cfg.preemph)))
    return audio_features_reference(x.double(), cfg64, lengths)


def explain_worst(worst: dict) -> dict:
    """A route's largest error against the f32 plain version, held
    against float64: the three values there, and in that frame the log-mel
    band furthest from float64 in the kernel, with the plain version's
    error in that band and the band's share of the frame's mel power."""
    cfg, x, lengths, (r, t, c) = worst["cfg"], worst["x"], worst["lengths"], worst["at"]
    ref = float(f64_reference(x, cfg, lengths)[r, t, c])
    lm = dataclasses.replace(cfg, feat_type="logfbank")
    k_lm = audio_features(x, lm, lengths)[r, t].double()
    p_lm = audio_features_reference(x, lm, lengths)[r, t].double()
    r_lm = f64_reference(x, lm, lengths)[r, t]
    band = int((k_lm - r_lm).abs().argmax())
    power = r_lm.exp()
    out = {"case": worst["what"], "row": r, "frame": t, "coef": c, "err": worst["err"],
           "kernel": worst["got"], "plain": worst["want"], "float64": ref,
           "band": band, "band_kernel_err": float(k_lm[band] - r_lm[band]),
           "band_plain_err": float(p_lm[band] - r_lm[band]),
           "band_power_share": float(power[band] / power.sum())}
    out["route"] = worst["route"]
    log(f"{worst['route']} route's largest error {out['err']:.3e}: {out['case']}, row {r}, "
        f"frame {t}, "
        f"coefficient {c}: kernel {out['kernel']:.6f}, plain {out['plain']:.6f}, float64 "
        f"{ref:.6f} (kernel {out['kernel'] - ref:+.2e}, plain {out['plain'] - ref:+.2e} from "
        f"float64); in that frame log-mel band {band} is the kernel's furthest from float64 "
        f"({out['band_kernel_err']:+.2e}; plain {out['band_plain_err']:+.2e}), "
        f"{out['band_power_share']:.2e} of the frame's mel power")
    return out


def dc_witness(pcm: torch.Tensor, lengths, cfg: F.FeatureConfig, got: torch.Tensor) -> dict:
    """Log-mel band 0 of logfbank-60 holds the DC bin alone, so |X[0]| =
    sqrt(n_fft exp(band 0)). Its error against float64, over every frame of
    the batch, for the FFT kernel (X[0] summed in sample order), the plain
    version (cuBLAS) and the plain ``dft='fft'`` (cuFFT, a packed FFT); and
    how many of each one's band-0 logs miss the kernel bar against float64."""
    idx, _ = fbank.mel_csr(cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)
    check(idx[0, 0] == 0 and idx[1, 0] == 1, f"band 0 of {cfg.num_bin} is not the DC bin alone")
    ref = f64_reference(pcm, cfg, lengths)[..., 0]
    x0 = lambda band: (band.double().exp() * cfg.n_fft).sqrt()
    want = x0(ref)
    bands = {"fft_kernel": got[..., 0],
             "plain": audio_features_reference(pcm, cfg, lengths)[..., 0],
             "plain_cufft": audio_features_reference(
                 pcm, dataclasses.replace(cfg, dft="fft"), lengths)[..., 0]}
    out = {"x0_rms": float(want.square().mean().sqrt()), "x0_min": float(want.min())}
    for name, band in bands.items():
        err = (x0(band) - want).abs()
        log_err = (band.double() - ref).abs()
        out[name] = {"x0_rms_err": float(err.square().mean().sqrt()),
                     "x0_max_err": float(err.max()), "log_max_err": float(log_err.max()),
                     "log_misses": int((log_err > ATOL + RTOL * ref.abs()).sum())}
    log(f"DC bin against float64 over {ref.numel()} frames (|X[0]| rms {out['x0_rms']:.4f}, "
        f"least {out['x0_min']:.3e}): " + "; ".join(
            f"{name} |X[0]| err rms {o['x0_rms_err']:.3e} max {o['x0_max_err']:.3e}, log-mel "
            f"band 0 max {o['log_max_err']:.3e}, {o['log_misses']} outside the bar"
            for name, o in ((n, out[n]) for n in bands)))
    return out


def ill_conditioned_witness() -> dict:
    """:data:`ILL_CONDITIONED` at 203 frames, whole and ragged rows: how
    many values of the mixed-radix route miss the kernel bar against the
    plain version, and how many of each miss it against float64. Logged,
    not barred: single-bin filters put f32 rounding of one bin straight
    into a log-mel band (the lowest filters of this config)."""
    feat_type, kw = ILL_CONDITIONED
    cfg = F.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
    idx, _ = fbank.mel_csr(cfg.num_bin, cfg.n_fft, cfg.rate, cfg.low_freq, cfg.high_freq)
    rng = np.random.default_rng(7)
    n = samples_for_frames(203, cfg.win_len, cfg.win_shift, cfg.rate)
    misses = lambda got, want: int((got.double() - want.double()).abs().gt(
        ATOL + RTOL * want.double().abs()).sum())
    out = {"config": f"{feat_type} {kw}", "filters_of_one_bin": int((idx[1] == 1).sum()),
           "empty_filters": int((idx[1] == 0).sum()), "values": 0,
           "kernel_vs_plain": 0, "kernel_vs_float64": 0, "plain_vs_float64": 0}
    for _ in range(4):
        x = torch.from_numpy((rng.standard_normal((4, n)) * 0.1).astype(np.float32)).cuda()
        for lengths in (None, ragged_lengths(n)):
            got = launch_one(cfg, x, lengths, "ill-conditioned witness")
            want = audio_features_reference(x, cfg, lengths)
            ref = f64_reference(x, cfg, lengths)
            out["values"] += got.numel()
            out["kernel_vs_plain"] += misses(got, want)
            out["kernel_vs_float64"] += misses(got, ref)
            out["plain_vs_float64"] += misses(want, ref)
    log(f"ill-conditioned config {out['config']} ({out['filters_of_one_bin']} filters of one "
        f"bin, {out['empty_filters']} empty), {out['values']} values: outside atol {ATOL} / "
        f"rtol {RTOL} the mixed-radix route against the plain version {out['kernel_vs_plain']}, "
        f"against float64 {out['kernel_vs_float64']}; the plain version against float64 "
        f"{out['plain_vs_float64']} (logged, not barred)")
    return out


def mixed_timing(pcm: torch.Tensor, lengths, cfg: F.FeatureConfig, what: str, peaks) -> dict:
    """At the 256 x 3 s batch and ``cfg`` at each ``n_fft`` of
    :data:`MIXED_TIMED`: the mixed-radix route held to the plain version,
    then it, the plain version and the plain ``dft='fft'`` in turns by CUDA
    events, beside the function's bound and the route's own operations. The
    route must beat ``dft='fft'``."""
    b, s = pcm.shape
    rows = {}
    for n_fft in MIXED_TIMED:
        c = dataclasses.replace(cfg, n_fft=n_fft)
        c_fft = dataclasses.replace(c, dft="fft")
        fns = {"mixed": lambda: audio_features(pcm, c, lengths),
               "plain": lambda: audio_features_reference(pcm, c, lengths),
               "cufft": lambda: audio_features_reference(pcm, c_fft, lengths)}
        want = fns["plain"]()
        err = {"mixed": compare(launch_one(c, pcm, lengths, f"{what}, n_fft {n_fft}"), want,
                                f"{what}, n_fft {n_fft}")}
        del want
        order = ["plain", "mixed", "cufft", "mixed", "cufft", "plain"]
        runs = [(name, time_ms(fns[name])) for name in order]
        ms = {name: sum(t for q, t in runs if q == name) / 2 for name in fns}
        fn_bound, fn_by = bound(front_end_work(b, s, c), peaks)
        rows[n_fft] = {"ms": ms, "runs_ms": runs, "max_abs_err": err, "bound_ms": fn_bound,
                       "bound_by": fn_by, "plan": [r for r, _ in fbank.fft_plan(n_fft).passes],
                       "bluestein": fbank.fft_plan(n_fft).bluestein,
                       "algorithm_ops_ms": kernel_flops(b, s, c) / peaks[0] * 1e3}
        r = rows[n_fft]
        log(f"{what}, mfcc-24 at n_fft {n_fft} (plan {r['plan']}"
            f"{', Bluestein' if r['bluestein'] else ''}; plain, mixed, dft='fft', mixed, "
            f"dft='fft', plain: {', '.join(f'{t:.4f}' for _, t in runs)} ms): mixed-radix "
            f"route {ms['mixed']:.4f} ms, plain {ms['plain']:.4f} ms, plain dft='fft' "
            f"{ms['cufft']:.4f} ms; the function's bound {fn_bound:.4f} ms ({fn_by}): "
            f"{fn_bound / ms['mixed']:.1%} of it; the route's own operations "
            f"{r['algorithm_ops_ms']:.4f} ms; max abs err {err['mixed']:.3e}")
        check(ms["mixed"] < ms["cufft"],
              f"n_fft {n_fft}: the mixed-radix route ({ms['mixed']:.4f} ms) is not faster than "
              f"dft='fft' ({ms['cufft']:.4f})")
    return rows


def kernel_phase(peaks) -> dict:
    rng = np.random.default_rng(0)
    max_err = dict.fromkeys(FBANK, 0.0)
    worst = {"fft": {"err": -1.0}, "mixed": {"err": -1.0}}
    band0_err = 0.0
    cases = ([(c, KERNEL_FRAMES) for c in KERNEL_CONFIGS]
             + [(c, OTHER_FRAMES) for c in OTHER_CONFIGS])
    n_cases = 0
    with fp32_math():
        for (feat_type, kw), frame_counts in cases:
            cfg = F.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
            kind = fbank.front_end_kernel(cfg)
            check(kind != "plain", f"{feat_type} {kw}: phase 3's configs all take the FFT route")
            for frames in frame_counts:
                n = samples_for_frames(frames, cfg.win_len, cfg.win_shift, cfg.rate)
                x = torch.from_numpy((rng.standard_normal((4, n)) * 0.1).astype(np.float32)).cuda()
                for lengths in (None, ragged_lengths(n)):
                    what = f"{feat_type} {kw} {frames} frames, lengths {lengths is not None}"
                    got = launch_one(cfg, x, lengths, what)
                    check(got.shape[1] == frames, f"{what}: {got.shape[1]} frames")
                    want = audio_features_reference(x, cfg, lengths)
                    err = compare(got, want, what)
                    max_err[kind] = max(max_err[kind], err)
                    if err > worst[kind]["err"]:
                        at = tuple(int(i) for i in np.unravel_index(
                            int((got - want).abs().argmax()), got.shape))
                        worst[kind] = {"err": err, "what": what, "cfg": cfg, "x": x,
                                       "lengths": lengths, "at": at, "route": kind,
                                       "got": float(got[at]), "want": float(want[at])}
                    n_cases += 1
                    if lengths is not None and feat_type != "mfcc":
                        # the empty row: every frame the guarded zero, eps or
                        # log(eps) = -36.04 (a residue of 1e-30 would give -69)
                        gap = float((got[3] - want[3]).abs().max())
                        check(gap <= 4e-6 and bool((want[3] == want[3][0, 0]).all()),
                              f"{what}: the empty row is {gap:.3e} from the guarded zero")
                    if feat_type == "mfcc" and cfg.n_fft == 512:
                        # mel band 0, where the sums cancel next to DC
                        lm = dataclasses.replace(cfg, feat_type="logfbank")
                        got0 = launch_one(lm, x, lengths, what + ", log-mel")[..., 0]
                        band0_err = max(band0_err, compare(
                            got0, audio_features_reference(x, lm, lengths)[..., 0],
                            what + ", log-mel band 0"))
        log(f"kernel vs plain: {n_cases} cases, max abs err FFT kernel {max_err['fft']:.3e}, "
            f"its mixed-radix route {max_err['mixed']:.3e}; log-mel band 0 of the MFCC configs "
            f"{band0_err:.3e}")
        worst = {k: explain_worst(w) for k, w in worst.items()}
        ill = ill_conditioned_witness()

        # the lomgrid batch, with the sweep's sample_lengths
        cfg = dataclasses.replace(F.FeatureConfig.from_config(AUDIO_DATA_OPTS),
                                  normalize=False)
        s = int(SECONDS * RATE)
        pcm = torch.from_numpy(rng.integers(-8000, 8000, (BATCH, s), dtype=np.int16))
        pcm = (pcm.cuda().float() / 32768.0).contiguous()
        lengths = torch.full((BATCH,), s, dtype=torch.int32, device="cuda")
        cfg_cufft = dataclasses.replace(cfg, dft="fft")
        fft_k = lambda: audio_features(pcm, cfg, lengths)
        plain = lambda: audio_features_reference(pcm, cfg, lengths)
        cufft = lambda: audio_features_reference(pcm, cfg_cufft, lengths)
        check(fbank.front_end_kernel(cfg) == "fft",
              "the lomgrid config does not go to the FFT kernel")
        want = plain()
        what = f"lomgrid batch {BATCH}x{s}"
        err = {"fft": compare(fft_k(), want, what + ", FFT kernel"),
               "cufft": compare(cufft(), want, what + ", plain dft='fft'")}
        max_err["fft"] = max(max_err["fft"], err["fft"])
        torch.cuda.synchronize()
        order = [("plain", plain), ("fft", fft_k), ("cufft", cufft),
                 ("fft", fft_k), ("cufft", cufft), ("plain", plain)]
        runs = [(name, time_ms(fn)) for name, fn in order]
        ms = {name: sum(t for n, t in runs if n == name) / 2 for name in dict(order)}

        # the configs the TPU's v2 kernel refuses and its v1 kernel serves
        # (logfbank-60): the FFT kernel, held and timed at that batch, and
        # its DC bin held against float64
        cfg_v1 = F.FeatureConfig(feat_type="logfbank", num_bin=60, normalize=False)
        got_v1 = audio_features(pcm, cfg_v1, lengths)
        v1 = {"max_abs_err": compare(got_v1, audio_features_reference(pcm, cfg_v1, lengths),
                                     what + ", logfbank-60"),
              "plain_ms": time_ms(lambda: audio_features_reference(pcm, cfg_v1, lengths)),
              "kernel_ms": time_ms(lambda: audio_features(pcm, cfg_v1, lengths))}
        dc = dc_witness(pcm, lengths, cfg_v1, got_v1)
        del got_v1
        # the mixed-radix route at 400, 480 and 510
        mixed = mixed_timing(pcm, lengths, cfg, what, peaks)
        for row in mixed.values():
            max_err["mixed"] = max(max_err["mixed"], row["max_abs_err"]["mixed"])
    flops, nbytes = front_end_work(BATCH, s, cfg)
    fn_bound, fn_by = bound((flops, nbytes), peaks)
    algo_ms = kernel_flops(BATCH, s, cfg) / peaks[0] * 1e3
    log(f"{what}, mfcc-24 (plain, FFT, plain dft='fft', FFT, dft='fft', plain: "
        f"{', '.join(f'{t:.4f}' for _, t in runs)} ms): FFT kernel {ms['fft']:.4f} ms, "
        f"against the function's bound {fn_bound:.4f} ms ({fn_by}; {flops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB): {fn_bound / ms['fft']:.1%} of it; its own algorithm's "
        f"operations alone take {algo_ms:.4f} ms; plain {ms['plain']:.4f} ms; plain "
        f"dft='fft' (cuFFT + mel/DCT products) {ms['cufft']:.4f} ms; max abs err FFT "
        f"{err['fft']:.3e}, dft='fft' {err['cufft']:.3e}")
    v1["bound_ms"], v1["bound_by"] = bound(front_end_work(BATCH, s, cfg_v1), peaks)
    v1["algorithm_ops_ms"] = kernel_flops(BATCH, s, cfg_v1) / peaks[0] * 1e3
    log(f"logfbank-60 at that batch: FFT kernel {v1['kernel_ms']:.4f} ms, plain "
        f"{v1['plain_ms']:.4f} ms, bound {v1['bound_ms']:.4f} ms ({v1['bound_by']}; the "
        f"kernel's own operations {v1['algorithm_ops_ms']:.4f} ms)")
    return {"max_abs_err": max_err, "band0_err": band0_err, "err_lomgrid": err, "ms": ms,
            "runs_ms": runs, "bound_ms": fn_bound, "bound_by": fn_by, "algorithm_ops_ms": algo_ms,
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "v1": v1, "mixed": mixed,
            "worst": worst, "dc_witness": dc, "ill_conditioned": ill}


# ------------------------------------- the FFT kernel against another's
MIXED_AT_POWERS = (512, 1024, 2048, 4096)   # power-of-two plans the mixed kernel is timed at


def other_fft_kernel(source: str) -> tuple:
    """Another checkout's ``fbank_fft_kernel.cu``, built with the port's
    nvcc flags into ``_build/other/``: its ``fbank_fft_features`` as a
    launch entry, typed and counted as this checkout's."""
    out = build.BUILD_ROOT / "other" / "libfbank_fft_kernel.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o",
                           str(out), os.path.abspath(source)], capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    keys, argtypes = fbank._SIGNATURES["fbank_fft_features"]
    fn = ctypes.CDLL(str(out)).fbank_fft_features
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, keys


def fft_kernel_with(entry: tuple, pcm: torch.Tensor, cfg: F.FeatureConfig,
                    lengths) -> torch.Tensor:
    """``fbank.fft_audio_features`` launching ``entry`` as its kernel."""
    saved = fbank._entry
    fbank._entry = lambda name: entry
    try:
        return fbank.fft_audio_features(pcm, cfg, lengths)
    finally:
        fbank._entry = saved


def mixed_kernel_forced(pcm: torch.Tensor, cfg: F.FeatureConfig, lengths) -> torch.Tensor:
    """The mixed-radix kernel at ``cfg``'s plan, a power of two included,
    which its wrapper refuses: the wrapper with the dispatch rule set to
    name it."""
    saved = fbank.front_end_kernel
    fbank.front_end_kernel = lambda _: "mixed"
    try:
        return fbank.mixed_fft_audio_features(pcm, cfg, lengths)
    finally:
        fbank.front_end_kernel = saved


def in_turns(fns: dict, order: list) -> tuple[dict, list]:
    """Each of ``fns`` timed by :func:`time_ms` in ``order``; the mean of
    each one's runs, and the runs."""
    runs = [(name, time_ms(fns[name])) for name in order]
    return {name: sum(t for q, t in runs if q == name) / order.count(name)
            for name in fns}, runs


def k1_against(source: str) -> int:
    """``--k1-against SOURCE``: see the module docstring."""
    dev = device_phase()
    build.build(["fbank_fft_kernel"])
    ours, other = fbank._entry("fbank_fft_features"), other_fft_kernel(source)
    rng = np.random.default_rng(0)
    cases = ([(c, KERNEL_FRAMES) for c in KERNEL_CONFIGS]
             + [(c, OTHER_FRAMES) for c in OTHER_CONFIGS])
    n_cases, differ = 0, []
    out = {"card": dev["smi"], "source": source}
    with fp32_math():
        for (feat_type, kw), frame_counts in cases:
            cfg = F.FeatureConfig(feat_type=feat_type, normalize=False, **kw)
            for frames in frame_counts:
                # phase 3's inputs: one draw a case, on either route
                n = samples_for_frames(frames, cfg.win_len, cfg.win_shift, cfg.rate)
                x = torch.from_numpy((rng.standard_normal((4, n)) * 0.1).astype(np.float32)).cuda()
                if fbank.front_end_kernel(cfg) != "fft":
                    continue
                for lengths in (None, ragged_lengths(n)):
                    n_cases += 1
                    if not bit_equal(fft_kernel_with(ours, x, cfg, lengths),
                                     fft_kernel_with(other, x, cfg, lengths)):
                        differ.append(f"{feat_type} {kw} {frames} frames, lengths "
                                      f"{lengths is not None}")
        s = int(SECONDS * RATE)
        pcm = torch.from_numpy(rng.integers(-8000, 8000, (BATCH, s), dtype=np.int16))
        pcm = (pcm.cuda().float() / 32768.0).contiguous()
        lengths = torch.full((BATCH,), s, dtype=torch.int32, device="cuda")
        mfcc = dataclasses.replace(F.FeatureConfig.from_config(AUDIO_DATA_OPTS), normalize=False)
        batch = {}
        for name, cfg in (("mfcc-24", mfcc), ("logfbank-60", F.FeatureConfig(
                feat_type="logfbank", num_bin=60, normalize=False))):
            n_cases += 1
            if not bit_equal(fft_kernel_with(ours, pcm, cfg, lengths),
                             fft_kernel_with(other, pcm, cfg, lengths)):
                differ.append(f"{BATCH} x {s}, {name}")
            ms, runs = in_turns({"this": lambda: fft_kernel_with(ours, pcm, cfg, lengths),
                                 "other": lambda: fft_kernel_with(other, pcm, cfg, lengths)},
                                ["this", "other", "other", "this"])
            batch[name] = {"ms": ms, "runs_ms": runs}
            log(f"FFT kernel at {BATCH} x {s}, {name}: this checkout {ms['this']:.4f} ms, the "
                f"other {ms['other']:.4f} ms ({ms['this'] / ms['other'] - 1:+.2%}) [{dev['smi']}]")
        out.update(cases=n_cases, differ=differ, batch=batch)
        log(f"FFT kernel against {source}: {n_cases - len(differ)} of {n_cases} cases bit-equal"
            + (f"; differ: {differ}" if differ else ""))

        mixed, misses = {}, []
        for n_fft in MIXED_AT_POWERS:
            cfg = dataclasses.replace(mfcc, n_fft=n_fft)
            want = audio_features_reference(pcm, cfg, lengths)
            what = f"mixed-radix kernel forced at n_fft {n_fft}"
            try:
                err = compare(mixed_kernel_forced(pcm, cfg, lengths), want, what)
            except SmokeFailure as e:
                misses.append(str(e))
                continue
            del want
            ms, runs = in_turns({"fft": lambda: fft_kernel_with(ours, pcm, cfg, lengths),
                                 "mixed": lambda: mixed_kernel_forced(pcm, cfg, lengths)},
                                ["fft", "mixed", "mixed", "fft"])
            mixed[n_fft] = {"ms": ms, "runs_ms": runs, "max_abs_err": err,
                            "plan": [r for r, _ in fbank.fft_plan(n_fft).passes]}
            log(f"{what} (plan {mixed[n_fft]['plan']}), mfcc-24 at {BATCH} x {s}: "
                f"{ms['mixed']:.4f} ms against the FFT kernel's {ms['fft']:.4f} ms "
                f"({ms['mixed'] / ms['fft'] - 1:+.2%}); max abs err {err:.3e} [{dev['smi']}]")
        out.update(mixed_at_powers=mixed, mixed_misses=misses)
    print(json.dumps({"k1_against": out}), flush=True)
    return 1 if differ or misses else 0


# ---------------------------------------------------------------- phase 4
def flagship_config(batch_size: int) -> Config:
    return Config({"data": {"python_data_config": AUDIO_DATA_OPTS},
                   "model": ETDNN_MODEL_OPTS,
                   "train": {"loss": "LMCL"},
                   "test": {"batch_size": batch_size}})


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Random weights from a torch.Generator: He-scaled conv/linear weights
    and BN affine parameters near (1, 0). The running statistics keep their
    defaults until :func:`calibrate_bn` sets them."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            out[k] = v.clone()
            continue
        z = torch.randn(v.shape, generator=g)
        if ".bn." in k or k.startswith(("bn1.", "bn2.")):
            out[k] = (1.0 + 0.1 * z) if k.endswith("weight") else 0.1 * z
        elif k.startswith("pooling."):
            # an attentive pooling's W, b, v, k: unit-scale scores
            out[k] = z / math.sqrt(v.shape[-1])
        elif k.endswith("weight"):
            out[k] = z * math.sqrt(2.0 / v[0].numel())
        else:
            out[k] = 0.01 * z
    return out


@torch.no_grad()
def calibrate_bn(extractor: AudioExtractor, batch: dict, seed: int) -> None:
    """Set each BN's running statistics near the batch statistics of its
    input on one real batch, each mean shifted by 0.1 sigma and each
    variance scaled by U(0.5, 2): activations stay on a unit scale through
    the ten blocks, so embeddings differ across utterances and the 1e-4
    kernel-vs-plain embedding check is a sensitive one."""
    g = torch.Generator().manual_seed(seed)
    model, dev = extractor.model, extractor.device
    pcm, lengths, slen = (torch.from_numpy(batch[k]).to(dev)
                          for k in ("pcm", "feat_lengths", "sample_lengths"))

    def set_stats(bn, y):
        flat = y.reshape(-1, y.shape[-1])
        mean, var = flat.mean(0), flat.var(0)
        z = torch.randn(mean.shape, generator=g).to(dev)
        u = torch.rand(mean.shape, generator=g).to(dev)
        bn.running_mean.copy_(mean + 0.1 * var.sqrt() * z)
        bn.running_var.copy_(var * (0.5 + 1.5 * u))

    with fp32_math():
        x = F.extract_features(pcm.float() / 32768.0, extractor.eval_feat_cfg,
                               sample_lengths=slen)
        x = masked_cmvn(x, lengths)
        for blk in model.tdnn:
            set_stats(blk.bn, blk.context_layer(x.transpose(1, 2)).transpose(1, 2))
            x = blk(x)
        x_a = model.fc1(model.pooling(x, lengths=model.valid_lengths(lengths)))
        set_stats(model.bn1, x_a)
        xv = model.fc2(torch.nn.functional.leaky_relu(model.bn1(x_a), 0.2))
        set_stats(model.bn2, xv)


def harmonic_wave(rng, f0: float, res: float, n: int) -> np.ndarray:
    """``n`` samples of a harmonic source near pitch ``f0`` through a
    resonance at ``res`` Hz, plus noise."""
    t = np.arange(n) / RATE
    f = f0 * (1.0 + 0.03 * rng.standard_normal())
    y = sum(np.sin(2 * np.pi * h * f * t) / h
            * np.exp(-((h * f - res) / 600.0) ** 2) for h in range(1, 20))
    y = 0.3 * y / np.abs(y).max() + 0.02 * rng.standard_normal(n)
    return y.astype(np.float32)


def speaker_wave(rng, spk: int) -> np.ndarray:
    """1-3 s of a harmonic source at the speaker's pitch through the
    speaker's resonance, plus noise."""
    n = int(rng.integers(RATE, 3 * RATE + 1))
    return harmonic_wave(rng, 90.0 + 12.0 * spk, 400.0 + 150.0 * spk, n)


def write_corpus(root: str, n_spk: int = 16, per_spk: int = 16,
                 n_trials: int = 4000, seed: int = 0) -> tuple[list[str], str]:
    """Ragged 1–3 s PCM16 wavs (:func:`speaker_wave`) and a half-target
    trial list over them."""
    rng = np.random.default_rng(seed)
    names = []
    for spk in range(n_spk):
        os.makedirs(os.path.join(root, f"s{spk:02d}"), exist_ok=True)
        for u in range(per_spk):
            name = f"s{spk:02d}/u{u:02d}.wav"
            write_wav(os.path.join(root, name), speaker_wave(rng, spk), RATE)
            names.append(name)
    trial_path = os.path.join(root, "trials.txt")
    with open(trial_path, "w") as fh:
        for i in range(n_trials):
            a = int(rng.integers(len(names)))
            if i % 2 == 0:
                same = [j for j in range(len(names))
                        if names[j][:3] == names[a][:3] and j != a]
                b = int(rng.choice(same))
            else:
                b = int(rng.integers(len(names)))
            label = int(names[a][:3] == names[b][:3])
            fh.write(f"{label} {names[a]} {names[b]}\n")
    return names, trial_path


def main_path_phase() -> dict:
    cfg = flagship_config(batch_size=64)
    extractor = AudioExtractor(cfg)
    extractor.load_state_dict(seeded_state_dict(extractor.model, seed=0))
    with tempfile.TemporaryDirectory() as root:
        names, trial_path = write_corpus(root)
        utts = [EvalUtterance(n, os.path.join(root, n)) for n in names]
        eval_set = EvalUtteranceSet(utts, **eval_set_kwargs(extractor.feat_cfg, cfg.test))
        host_batches = list(eval_set.batches())
        check(eval_set._resolved_transport == "int16", "PCM16 corpus did not resolve to int16")
        calibrate_bn(extractor, host_batches[len(host_batches) // 2], seed=1)

        before = launch_counts()
        t0 = time.perf_counter()
        store = extractor.extract_embeddings(eval_set)
        eer, threshold = extractor.evaluate(trial_path, store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, tdnn = launches_since(before, FBANK), launches_since(before, TDNN)
        launches = {"fused_fbank": counts["fft"], "tdnn_eval": tdnn["tdnn_eval"]}

    check(counts == {"fft": len(host_batches), "mixed": 0},
          f"front-end launches {counts} for {len(host_batches)} batches")
    check(tdnn == tdnn_want(evals=len(host_batches)),
          f"T launches {tdnn} for {len(host_batches)} extraction batches")
    check(len(store) == len(names), f"{len(store)} embeddings for {len(names)} utterances")
    emb = store.matrix(names)
    check(emb.device.type == "cuda", f"embeddings live on {emb.device}, not cuda")
    check(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    norms = torch.linalg.vector_norm(emb, dim=-1)
    check(float((norms - 1).abs().max()) < 1e-4, "embeddings are not unit-norm")
    check(math.isfinite(eer) and 0.0 <= eer <= 1.0, f"EER {eer} not finite in [0, 1]")
    log(f"main path: {len(names)} utts in {len(host_batches)} batches "
        f"(shapes {sorted({b['pcm'].shape for b in host_batches})}), "
        f"{launches['fused_fbank']} front-end launches, EER {eer:.4f} "
        f"(threshold {threshold:.4f}), {wall:.2f} s wall incl. header scan and decode")

    # the same batches through the plain front-end on the card
    emb_err = feat_err = 0.0
    for batch in (host_batches[0], host_batches[-1]):
        args = [torch.from_numpy(batch[k]).cuda()
                for k in ("pcm", "feat_lengths", "sample_lengths")]
        with plain_front_end():
            e_plain = extractor.embed(*args)
        e_kernel = torch.stack([store[n] for n in batch["names"]])
        emb_err = max(emb_err, float((e_plain - e_kernel).abs().max()))
        with fp32_math():
            pcm = args[0].float() / 32768.0
            f_kernel = F.extract_features(pcm, extractor.eval_feat_cfg, sample_lengths=args[2])
            with plain_front_end():
                f_plain = F.extract_features(pcm, extractor.eval_feat_cfg,
                                             sample_lengths=args[2])
        feat_err = max(feat_err, compare(f_kernel, f_plain, f"main-path batch {tuple(pcm.shape)}"))
    check(emb_err <= EMB_TOL, f"kernel-path embeddings {emb_err:.3e} from the plain path")
    log(f"plain front-end re-embed: max abs err {emb_err:.3e} (bar {EMB_TOL}); "
        f"features {feat_err:.3e}")
    return {"launches": launches, "emb_err": emb_err, "feat_err": feat_err,
            "eer": eer, "extractor": extractor, "store": store}


# ---------------------------------------------------------------- phase 5
def tdnn_flops(model, batch: int, frames: int) -> float:
    """Multiply-adds x 2 of the E-TDNN's convolutions and FC head for one
    batch of ``frames``-frame inputs (VALID convs shrink T block by block)."""
    total, t = 0.0, frames
    for blk in model.tdnn:
        conv = blk.context_layer
        t -= (conv.kernel_size[0] - 1) * conv.dilation[0]
        total += 2.0 * batch * t * conv.in_channels * conv.out_channels * conv.kernel_size[0]
    for fc in (model.fc1, model.fc2):
        total += 2.0 * batch * fc.in_features * fc.out_features
    return total


def sweep_phase(extractor: AudioExtractor) -> dict:
    rng = np.random.default_rng(1)
    s = int(SECONDS * RATE)
    pcm = torch.from_numpy(
        rng.integers(-8000, 8000, (LOMGRID_UTTS, s), dtype=np.int16)).cuda()
    pairs = torch.from_numpy(rng.integers(0, LOMGRID_UTTS, (LOMGRID_TRIALS, 2))).cuda()
    cfg = extractor.eval_feat_cfg
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    feat_lengths = torch.full((BATCH,), t, dtype=torch.int32, device="cuda")
    sample_lengths = torch.full((BATCH,), s, dtype=torch.int32, device="cuda")

    def sweep():
        embs = []
        for i in range(0, LOMGRID_UTTS, BATCH):
            x = pcm[i:i + BATCH]
            n = x.shape[0]
            embs.append(extractor.embed(x, feat_lengths[:n], sample_lengths[:n]))
        return cosine_scores(torch.cat(embs), pairs, normalize=False)

    before = launch_counts()
    scores = sweep()
    launches, tdnn = launches_since(before, FBANK), launches_since(before, TDNN)
    n_batches = -(-LOMGRID_UTTS // BATCH)
    check(launches == {"fft": n_batches, "mixed": 0},
          f"front-end launches {launches} for a sweep of {n_batches} batches")
    check(tdnn == tdnn_want(evals=n_batches),
          f"T launches {tdnn} for a sweep of {n_batches} batches")
    launches = {**launches, "tdnn_eval": tdnn["tdnn_eval"]}
    check(bool(torch.isfinite(scores).all()), "non-finite sweep scores")
    sweep_ms = sorted(time_ms(sweep, iters=1, warmup=0) for _ in range(3))
    ms = sweep_ms[1]

    # per-batch split at one full batch
    x = pcm[:BATCH]
    with torch.no_grad(), fp32_math():
        pcm_f = x.float() / 32768.0
        feats = F.extract_features(pcm_f, cfg, sample_lengths=sample_lengths)
        front_ms = time_ms(lambda: F.extract_features(pcm_f, cfg, sample_lengths=sample_lengths),
                           iters=10)
        normed = masked_cmvn(feats, feat_lengths)
        tdnn_ms = time_ms(lambda: extractor.model.extract_embedding(normed, lengths=feat_lengths),
                          iters=10)
    tps = LOMGRID_TRIALS / (ms / 1e3)
    flops = tdnn_flops(extractor.model, BATCH, t)
    log(f"TDNN per batch: {flops / 1e9:.1f} GFLOP in {tdnn_ms:.3f} ms = "
        f"{flops / tdnn_ms / 1e9:.2f} TFLOP/s (FP32, TF32 off)")
    log(f"lomgrid sweep: {LOMGRID_UTTS} x {SECONDS:g} s, batch {BATCH}, {LOMGRID_TRIALS} "
        f"trials: {ms:.1f} ms median of 3 ({', '.join(f'{v:.1f}' for v in sweep_ms)}), "
        f"{tps:.1f} trials/s; front-end launches per sweep {launches}; per batch: "
        f"front-end (the kernel, pre-emphasis and mask inside) {front_ms:.3f} ms, TDNN "
        f"{tdnn_ms:.3f} ms")
    return {"trials_per_sec": tps, "sweep_ms": ms, "front_ms": front_ms, "tdnn_ms": tdnn_ms,
            "tdnn_gflop": flops / 1e9, "launches": launches}


# ---------------------------------------------------------------- phase 18
ENTRY_N_FFT = 400                 # torchaudio's default and Whisper's size: the mixed-radix route
ENTRY_SPEAKERS, ENTRY_UTTS = 8, 8


def with_n_fft(data_opts: dict, n_fft: int) -> dict:
    """A ``python_data_config`` with ``n_fft`` in each of its mel sections."""
    data = copy.deepcopy(data_opts)
    for key in ("mfcc", "fbank", "logfbank"):
        if key in data:
            data[key]["n_fft"] = n_fft
    return data


def front_end_step_check(trainer: AudioTrainer, pcm: torch.Tensor, labels: torch.Tensor,
                         what: str) -> dict:
    """Phase 11's f32 rule for one step of ``trainer`` on float ``pcm``: the
    step through the front-end kernels against the step through the plain
    front-end from the same state (loss within 1e-4 relative, gradients no
    further than 3x what a 1e-6 elementwise nudge of the PCM moves the
    plain step); the state is put back after each step."""
    margin, dev = trainer.init_margin, trainer.device
    params = [(f"model.{n}", p) for n, p in trainer.model.named_parameters()] + [
        (f"criterion.{n}", p) for n, p in trainer.criterion.named_parameters()]
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.criterion.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)

    def step(x):
        loss = float(trainer.train_step(x, labels, margin)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in params}
        trainer.model.load_state_dict(state[0])
        trainer.criterion.load_state_dict(state[1])
        trainer.optimizer.load_state_dict(state[2])
        trainer.step = state[3]
        return loss, grads

    gen = torch.Generator(device=dev).manual_seed(3)
    nudged = pcm * (1.0 + NUDGE * torch.randn(pcm.shape, generator=gen, device=dev))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        before = launch_counts()
        loss_k, grads_k = step(pcm)
        launches = launches_since(before, FBANK)
        with plain_front_end():
            loss_p, grads_p = step(pcm)
            loss_n, grads_n = step(nudged)
        check(launches_since(before, FBANK) == launches,
              f"{what}: the plain steps launched a kernel")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    d_kp, d_np = grad_distance(grads_k, grads_p), grad_distance(grads_n, grads_p)
    log(f"{what}: loss {loss_k:.8f} vs plain {loss_p:.8f} ({loss_rel:.2e} relative, bar "
        f"{AUDIO_STEP_LOSS_RTOL}); gradient distance from the plain step {d_kp:.3e}, the plain "
        f"step with the PCM nudged by {NUDGE} {d_np:.3e} (ratio {d_kp / d_np:.2f}, bar "
        f"{NUDGE_FACTOR}); launches {launches}")
    check(loss_rel <= AUDIO_STEP_LOSS_RTOL, f"{what}: loss {loss_k} vs plain {loss_p}, "
          f"{loss_rel:.3e} relative, bar {AUDIO_STEP_LOSS_RTOL}")
    check(d_kp <= NUDGE_FACTOR * d_np, f"{what}: gradients {d_kp:.3e} of the plain norm from "
          f"the plain step; a {NUDGE} nudge of the PCM moves them {d_np:.3e}; bar "
          f"{NUDGE_FACTOR} x that")
    return {"loss_rel": loss_rel, "grad_distance": d_kp, "nudge_distance": d_np,
            "launches": launches}


def mixed_entry_phase(smi: str) -> dict:
    """Phase 18: the flagship E-TDNN at ``n_fft`` 400 through
    ``AudioExtractor.extract_embeddings`` and one f32 ``AudioTrainer`` step."""
    data = with_n_fft(AUDIO_DATA_OPTS, ENTRY_N_FFT)
    cfg = Config({**flagship_config(batch_size=64).to_dict(),
                  "data": {"python_data_config": data}})
    extractor = AudioExtractor(cfg)
    check(fbank.front_end_kernel(extractor.eval_feat_cfg) == "mixed",
          f"n_fft {ENTRY_N_FFT} does not take the mixed-radix route")
    extractor.load_state_dict(seeded_state_dict(extractor.model, seed=0))
    with tempfile.TemporaryDirectory() as root:
        names, _ = write_corpus(root, ENTRY_SPEAKERS, ENTRY_UTTS, n_trials=8, seed=2)
        eval_set = EvalUtteranceSet([EvalUtterance(n, os.path.join(root, n)) for n in names],
                                    **eval_set_kwargs(extractor.feat_cfg, cfg.test))
        host_batches = list(eval_set.batches())
        calibrate_bn(extractor, host_batches[0], seed=1)
        before = launch_counts()
        store = extractor.extract_embeddings(eval_set)
        torch.cuda.synchronize()
        counts = launches_since(before, FBANK)
    check(counts == {"fft": 0, "mixed": len(host_batches)},
          f"n_fft {ENTRY_N_FFT}: front-end launches {counts} for {len(host_batches)} batches")
    emb = store.matrix(names)
    check(len(store) == len(names) and bool(torch.isfinite(emb).all()),
          f"n_fft {ENTRY_N_FFT}: {len(store)} embeddings for {len(names)} utterances, finite "
          f"{bool(torch.isfinite(emb).all())}")
    emb_err = 0.0
    for batch in host_batches:
        args = [torch.from_numpy(batch[k]).cuda()
                for k in ("pcm", "feat_lengths", "sample_lengths")]
        with plain_front_end():
            e_plain = extractor.embed(*args)
        e_kernel = torch.stack([store[n] for n in batch["names"]])
        emb_err = max(emb_err, float((e_plain - e_kernel).abs().max()))
    log(f"n_fft {ENTRY_N_FFT} through AudioExtractor.extract_embeddings (flagship E-TDNN): "
        f"{len(names)} utts in {len(host_batches)} batches, launches {counts}; plain "
        f"front-end re-embed max abs err {emb_err:.3e} (bar {EMB_TOL}) [{smi}]")
    check(emb_err <= EMB_TOL, f"n_fft {ENTRY_N_FFT}: kernel-path embeddings {emb_err:.3e} "
          f"from the plain path")
    del extractor, store, emb
    torch.cuda.empty_cache()

    train_cfg = load_audio_config(AUDIO_CONFIG_PATH).to_dict()
    train_cfg["data"]["train_manifest"] = None
    train_cfg["data"]["python_data_config"] = with_n_fft(
        train_cfg["data"]["python_data_config"], ENTRY_N_FFT)
    train_cfg["train"].update(compute_dtype="float32", steps_per_dispatch=1)
    with tempfile.TemporaryDirectory() as root:
        trainer = AudioTrainer(Config(train_cfg), n_spk=TRAIN_SPEAKERS,
                               exp_root=os.path.join(root, "exp"), log_time="n_fft_400")
        check(fbank.front_end_kernel(trainer.feat_cfg) == "mixed",
              f"the trainer's n_fft {trainer.feat_cfg.n_fft} is not on the mixed-radix route")
        pcm16, labels = group_audio_batch(1, 23, trainer.device)
        step = front_end_step_check(
            trainer, pcm16[0].float() / 32768.0, labels[0],
            f"audio f32 step at n_fft {ENTRY_N_FFT}, bs {BATCH} x {GROUP_FRAMES} [{smi}]")
        del trainer
    check(step["launches"] == {"fft": 0, "mixed": 1},
          f"n_fft {ENTRY_N_FFT}: a train step launched {step['launches']}")
    release()
    return {"launches": {"extraction": counts["mixed"], "train_step": step["launches"]["mixed"]},
            "batches": len(host_batches), "emb_err": emb_err, "step": step}


# ---------------------------------------------------------------- phase 11
TRAIN_SPEAKERS, TRAIN_UTTS, TRAIN_EPOCHS = 128, 8, 2
# per speaker: the utterances of the trial list, written beside the 8 of
# the manifest and held out of training
TRAIN_TEST_UTTS = (8, 9)
AUDIO_STEP_LOSS_RTOL = 1e-4       # a K1 step vs a plain-front-end step, f32
# A bf16 step against the f32 step from the same state: the loss within
# BF16_LOSS_RTOL, the gradients within BF16_GRAD_BAR of the f32 step's norm
# (sound 0.171): every planted fault reads within 10 % of sound there, so it
# catches only gross faults. The loss's distance from the f32 step's follows
# the state that training reached (on an H100 with the TDNN blocks' eager
# ops: 6.07e-5 and 3.4e-5 on phase 11's corpus, 1.4e-4 to 5.2e-4 on corpus
# seeds 1-4, PERF.md), so the finer bar, BF16_LOSS_BAR, holds the bf16 step
# to the same bf16 step with the blocks' eager ops, the recipe whose
# rounding T follows; a planted fault's loss is read against that step too.
# The recipe itself is audited in the bf16 forward (bf16_audit) to the bars
# below, and every planted fault must be caught.
BF16_LOSS_RTOL = 2e-2
BF16_LOSS_BAR = 1e-4
BF16_GRAD_BAR = 0.25
BF16_STAT_RTOL = 1e-4   # a BN's batch mean (in sigmas) and variance vs float64
BF16_POOL_RTOL = 1e-4   # the pooled statistics vs float64 pooling of the same input
BF16_HEAD_ATOL = 2e-6   # the cosine logits vs float64
BF16_FAULTS = ("bn_stats_bf16", "pool_bf16", "head_bf16", "head_tf32")
STEP_FRAMES = (200, 300, 400)     # the timed crop lengths
# device kernels of an audio train step by kind, first match wins: the FFT
# front-end kernel, torch's SGD (foreach kernels), cuDNN/cuBLAS
# (the convolutions and the FC head), the rest of PyTorch's own
AUDIO_KINDS = [
    ("K1 (fbank_fft_kernel.cu)", re.compile(r"fbank_fft_kernel")),
    ("T (tdnn_bn_act_kernel.cu)", re.compile(r"::tdnn_\w+_kernel\b")),
    ("optimizer (SGD)", re.compile(r"multi_tensor_apply|sgd", re.I)),
    ("cuDNN/cuBLAS", re.compile(r"cudnn|xmma|cublas|gemm|cutlass|wgrad|dgrad|fprop|conv", re.I)),
    ("other PyTorch", re.compile(r"")),
]


def training_wave(rng, spk: int) -> np.ndarray:
    """2-5 s of :func:`harmonic_wave` at one of 128 pitches and resonances
    inside the band."""
    n = int(rng.integers(2 * RATE, 5 * RATE + 1))
    return harmonic_wave(rng, 90.0 + 1.5 * spk, 400.0 + 25.0 * spk, n)


def write_train_corpus(root: str, seed: int = 0) -> tuple[str, str]:
    """128 speakers x 10 PCM16 wavs of 2-5 s: the manifest over the first 8
    of each speaker (``write_manifest``), and a half-target trial list over
    the 2 held out (``TRAIN_TEST_UTTS``). Returns the manifest's and the
    trial list's paths."""
    def speaker(spk):
        rng = np.random.default_rng((seed, spk))
        os.makedirs(os.path.join(root, f"s{spk:03d}"), exist_ok=True)
        utts = []
        for u in range(TRAIN_UTTS + len(TRAIN_TEST_UTTS)):
            path = os.path.join(root, f"s{spk:03d}", f"u{u}.wav")
            y = training_wave(rng, spk)
            write_wav(path, y, RATE)
            utts.append(Utterance(path, len(y) / RATE, RATE))
        return utts[:TRAIN_UTTS]

    with ThreadPoolExecutor(8) as pool:
        speakers = list(pool.map(speaker, range(TRAIN_SPEAKERS)))
    manifest = os.path.join(root, "manifest.csv")
    write_manifest(manifest, speakers)
    names = [f"s{spk:03d}/u{u}.wav" for spk in range(TRAIN_SPEAKERS) for u in TRAIN_TEST_UTTS]
    rng = np.random.default_rng(seed)
    trials = os.path.join(root, "trials.txt")
    with open(trials, "w") as fh:
        for i in range(4000):
            a = int(rng.integers(len(names)))
            b = a ^ 1 if i % 2 == 0 else int(rng.integers(len(names)))
            fh.write(f"{int(names[a][:4] == names[b][:4])} {names[a]} {names[b]}\n")
    return manifest, trials


def audio_train_config(root: str, manifest: str, trials: str) -> str:
    """``conf/audio_config.yaml`` with its manifest and trial list in
    ``root`` and ``TRAIN_EPOCHS`` epochs, written as JSON; returns its path."""
    cfg = load_audio_config(AUDIO_CONFIG_PATH).to_dict()
    cfg["data"].update(train_manifest=manifest, test_root=root, trial_grid=trials)
    cfg["train"]["epoch"] = TRAIN_EPOCHS
    path = os.path.join(root, "audio_config.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def k1_training_shapes(trainer, peaks) -> list:
    """K1 against its plain version on the training epochs' own batches (raw
    f32 PCM, CMVN after both, as the train step applies it), and K1's time
    and bound at each crop shape."""
    cfg, rows = trainer.feat_cfg, {}
    # every batch assembled first: the pipeline's threads would compete with
    # the timed launches for the host
    batches = [b for e in range(1, TRAIN_EPOCHS + 1) for b in trainer.pipeline.epoch(e)]
    for batch in batches:
        x = torch.from_numpy(batch["pcm"]).to(trainer.device).float() / 32768.0
        with torch.no_grad(), fp32_math():
            got = F.cmvn(audio_features(x, cfg))
            want = F.cmvn(audio_features_reference(x, cfg))
            err = compare(got, want, f"K1 at training crop {tuple(x.shape)}")
            row = rows.get(x.shape[1])
            if row is None:
                ms = time_ms(lambda: audio_features(x, cfg), iters=20)
                b_ms, by = bound(front_end_work(*x.shape, cfg), peaks)
                row = rows[x.shape[1]] = {"shape": list(x.shape), "n_frames": batch["n_frames"],
                                          "batches": 0, "max_abs_err": 0.0, "ms": ms,
                                          "bound_ms": b_ms, "bound_by": by}
        row["batches"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return sorted(rows.values(), key=lambda r: r["n_frames"])


def _unit64(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().double()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


@contextlib.contextmanager
def bf16_audit(model, criterion, record: dict):
    """Hold a bf16 forward to the recipe, filling ``record`` with the worst
    reading of each rule: every conv block computes in bf16
    (``blocks_bf16``); every BN takes its batch statistics in >= f32
    (``stat_err``: against float64 statistics of its input, the mean in
    units of the standard deviation, the variance relative, both with the
    BN's eps); the pooled statistics are >= f32 (``pool_err``: against the
    same pooling in float64, relative to its largest value); the cosine
    logits are FP32 (``head_err``: against float64)."""
    record.update(blocks_bf16=True, stat_err=0.0, pool_err=0.0, head_err=0.0)
    inputs: dict = {}

    def block_out(mod, args, out):
        record["blocks_bf16"] &= out.dtype == torch.bfloat16

    def bn_in(mod, args):
        inputs[mod] = args[0].detach()

    fused = tdnn_model.bn_leaky_ncw

    def fused_in(bn, y, conv_bias):
        # a TDNN block's BN on the card: T's fused op on the (B, C, T) conv
        # output, whose bias it adds
        inputs[bn] = (y + conv_bias.to(y.dtype)[:, None]).detach().movedim(1, -1)
        return fused(bn, y, conv_bias)

    def pool_out(mod, args, kwargs, out):
        want = type(mod).forward(mod, args[0].detach().double(), *args[1:], **kwargs)
        err = float((out.detach().double() - want).abs().max() / want.abs().max())
        record["pool_err"] = max(record["pool_err"], err)

    def head_out(mod, args, kwargs, out):
        emb = args[0] if args else kwargs["embeddings"]
        want = _unit64(emb) @ _unit64(mod.weights).T
        record["head_err"] = max(record["head_err"],
                                 float((out[1].detach().double() - want).abs().max()))

    update = TorchBatchNorm.update_running

    def audited_update(self, mean, var, n):
        x = inputs.pop(self).double()
        x = x.reshape(-1, x.shape[-1])
        m, v = x.mean(0), x.var(0, unbiased=False)
        sd = (v + self.eps).sqrt()
        err = max(float(((mean.detach().double() - m).abs() / sd).max()),
                  float(((var.detach().double() - v).abs() / sd ** 2).max()))
        record["stat_err"] = max(record["stat_err"], err)
        return update(self, mean, var, n)

    blocks = model.tdnn if hasattr(model, "tdnn") else model.blocks()
    hooks = [blk.register_forward_hook(block_out) for blk in blocks]
    hooks += [m.register_forward_pre_hook(bn_in) for m in model.modules()
              if isinstance(m, TorchBatchNorm)]
    hooks.append(model.pooling.register_forward_hook(pool_out, with_kwargs=True))
    hooks.append(criterion.register_forward_hook(head_out, with_kwargs=True))
    TorchBatchNorm.update_running = audited_update
    tdnn_model.bn_leaky_ncw = fused_in
    try:
        yield record
    finally:
        TorchBatchNorm.update_running = update
        tdnn_model.bn_leaky_ncw = fused
        for h in hooks:
            h.remove()


def bf16_audit_failures(record: dict) -> list:
    """The rules of :func:`bf16_audit` that ``record`` breaks."""
    return [name for name, hit in (
        ("blocks_bf16", not record["blocks_bf16"]),
        ("stat_err", record["stat_err"] > BF16_STAT_RTOL),
        ("pool_err", record["pool_err"] > BF16_POOL_RTOL),
        ("head_err", record["head_err"] > BF16_HEAD_ATOL)) if hit]


def _bn_stats_in_bf16(self, x):
    """TorchBatchNorm's forward with a bf16 input's statistics taken in bf16."""
    if not (self.training and x.dtype == torch.bfloat16):
        return _bn_forward(self, x)
    red = tuple(range(x.ndim - 1))
    mean = x.mean(red)
    var = ((x - mean) ** 2).mean(red)
    self.update_running(mean.float(), var.float(), x.numel() // x.shape[-1])
    y = (x - mean) * torch.rsqrt(var.float() + self.eps).to(x.dtype)
    return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


_bn_forward = TorchBatchNorm.forward
_bn_leaky_ncw = tdnn_model.bn_leaky_ncw


def _fused_stats_in_bf16(bn, y, conv_bias):
    """A TDNN block's fused conv bias + BN + LeakyReLU with a bf16 input's
    statistics taken in bf16 (:func:`_bn_stats_in_bf16` on the ``(B, T, C)``
    view)."""
    out = _bn_stats_in_bf16(bn, (y + conv_bias.to(y.dtype)[:, None]).transpose(1, 2))
    return torch.nn.functional.leaky_relu(out, 0.2).transpose(1, 2)


@contextlib.contextmanager
def planted_bf16_fault(fault: str, model):
    """One way for the bf16 recipe to go wrong, for the bf16 bars to catch:
    BN statistics taken in bf16, statistics pooling in bf16, or the cosine
    logits in bf16 or in TF32."""
    cosines = softmax_losses._CosineHead.cosines

    def tf32_cosines(self, emb):
        matmul = torch.backends.cuda.matmul
        saved, matmul.allow_tf32 = matmul.allow_tf32, True
        try:
            return cosines(self, emb)
        finally:
            matmul.allow_tf32 = saved

    def bf16_cosines(self, emb):
        return torch.matmul(softmax_losses._unit(emb).bfloat16(),
                            softmax_losses._unit(self.weights).bfloat16().T).float()

    pool = model.pooling.forward
    if fault == "bn_stats_bf16":
        TorchBatchNorm.forward = _bn_stats_in_bf16
        tdnn_model.bn_leaky_ncw = _fused_stats_in_bf16
    elif fault == "pool_bf16":
        model.pooling.forward = lambda x, lengths=None: pool(x.bfloat16(), lengths).float()
    elif fault in ("head_bf16", "head_tf32"):
        softmax_losses._CosineHead.cosines = (bf16_cosines if fault == "head_bf16"
                                              else tf32_cosines)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        TorchBatchNorm.forward = _bn_forward
        tdnn_model.bn_leaky_ncw = _bn_leaky_ncw
        softmax_losses._CosineHead.cosines = cosines
        model.pooling.__dict__.pop("forward", None)


def audio_step_phase(trainer, smi: str, peaks, faults=BF16_FAULTS,
                     bf16_bars: bool = True) -> dict:
    """A K1 step against a plain-front-end step and a bf16 step from one
    state, the bf16 step again with the TDNN blocks' eager ops, ``faults``
    planted in the bf16 step (``bf16_bars``: the bf16 loss and gradients
    held to phase 11's bars, else reported); then ms per
    step at bs 256 x ``STEP_FRAMES``, in bf16 and f32, K1's share, peak
    memory and one profiled bf16 step."""
    cfg, margin, dev = trainer.feat_cfg, trainer.init_margin, trainer.device
    sids = next(trainer.pipeline.sampler.epoch(1))[0]
    batches = {n: trainer.pipeline._assemble(sids, n, (7, n)) for n in STEP_FRAMES}
    labels = torch.from_numpy(batches[300]["labels"]).to(dev)
    step, restore = state_stepper(trainer, labels, margin)
    blocks = sum(isinstance(m, tdnn_model.TDNNBlock) and m.bn_first
                 for m in trainer.model.modules())

    pcm = torch.from_numpy(batches[300]["pcm"]).to(dev).float() / 32768.0
    # an elementwise relative nudge: a common scale of the PCM would vanish
    # in the log-mel's CMVN
    gen = torch.Generator(device=dev).manual_seed(3)
    nudged = pcm * (1.0 + NUDGE * torch.randn(pcm.shape, generator=gen, device=dev))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        before = launch_counts()
        loss_k, grads_k = step(pcm, None)
        fb, tdnn = launches_since(before, FBANK), launches_since(before, TDNN)
        check(fb == {"fft": 1, "mixed": 0},
              f"a kernel step launched {fb}: one FFT-kernel launch expected")
        check(tdnn == tdnn_want(steps=1, blocks=blocks), f"a kernel step launched T "
              f"{tdnn}, expected {tdnn_want(steps=1, blocks=blocks)}")
        with plain_front_end():
            loss_p, grads_p = step(pcm, None)
            loss_n, grads_n = step(nudged, None)
        check(launches_since(before, FBANK) == {"fft": 1, "mixed": 0},
              "the plain steps launched a kernel")
        audit: dict = {}
        with bf16_audit(trainer.model, trainer.criterion, audit):
            loss_b, grads_b = step(pcm, torch.bfloat16)
        with eager_tdnn_blocks():
            loss_e, _ = step(pcm, torch.bfloat16)
        planted = {}
        for fault in faults:
            record: dict = {}
            with planted_bf16_fault(fault, trainer.model), \
                    bf16_audit(trainer.model, trainer.criterion, record):
                loss_f, grads_f = step(pcm, torch.bfloat16)
            rel = abs(loss_f - loss_e) / abs(loss_e)
            planted[fault] = {"loss_rel": rel, "grad_distance": grad_distance(grads_f, grads_k),
                              "audit": record, "caught_by": bf16_audit_failures(record)
                              + (["loss"] if bf16_bars and rel > BF16_LOSS_BAR else [])}
            del grads_f
    loss_rel, bf16_rel = abs(loss_k - loss_p) / abs(loss_p), abs(loss_b - loss_k) / abs(loss_k)
    eager_rel = abs(loss_b - loss_e) / abs(loss_e)
    d_kp, d_np = grad_distance(grads_k, grads_p), grad_distance(grads_n, grads_p)
    d_bf16 = grad_distance(grads_b, grads_k)
    worst = {k: worst_tensor(g, grads_p) for k, g in (("kernel", grads_k), ("nudge", grads_n))}
    del grads_k, grads_p, grads_n, grads_b
    log(f"audio step, K1 vs plain front-end at bs {BATCH} x 300 (f32, TF32 off, cuDNN "
        f"deterministic): loss {loss_k:.8f} vs {loss_p:.8f} ({loss_rel:.2e} relative, bar "
        f"{AUDIO_STEP_LOSS_RTOL}; nudged PCM {loss_n:.8f}); gradient distance from the plain "
        f"step: K1 {d_kp:.3e}, plain with the PCM nudged by {NUDGE} {d_np:.3e} (ratio "
        f"{d_kp / d_np:.2f}, bar {NUDGE_FACTOR}); worst tensor, of its plain largest: "
        + ", ".join(f"{k} {v:.2e} ({n})" for k, (v, n) in worst.items())
        + f"; bf16 step loss {loss_b:.6f}, {bf16_rel:.2e} from the f32 step (bar "
        f"{BF16_LOSS_RTOL}), {eager_rel:.2e} from the bf16 step with the TDNN blocks' eager "
        f"ops ({loss_e:.6f}; bar {BF16_LOSS_BAR}), gradient distance {d_bf16:.3e} (bar "
        f"{BF16_GRAD_BAR}), audit "
        + json.dumps(audit))
    for fault, r in planted.items():
        log(f"  planted bf16 fault {fault}: loss {r['loss_rel']:.2e} from the eager-blocks "
            f"bf16 step, gradient distance {r['grad_distance']:.3e} from the f32 step, audit "
            f"{json.dumps(r['audit'])}; "
            f"caught by {r['caught_by']}")
    check(loss_rel <= AUDIO_STEP_LOSS_RTOL, f"K1-step loss {loss_k} vs plain {loss_p}: "
          f"{loss_rel:.3e} relative, bar {AUDIO_STEP_LOSS_RTOL}")
    check(d_kp <= NUDGE_FACTOR * d_np, f"K1-step gradients {d_kp:.3e} of the plain norm from "
          f"the plain step; a {NUDGE} nudge of the PCM moves them {d_np:.3e}; bar "
          f"{NUDGE_FACTOR} x that")
    check(not bf16_bars or bf16_rel <= BF16_LOSS_RTOL,
          f"bf16 step loss {loss_b} vs f32 {loss_k}: {bf16_rel:.3e} relative, bar "
          f"{BF16_LOSS_RTOL}")
    check(not bf16_bars or eager_rel <= BF16_LOSS_BAR,
          f"bf16 step loss {loss_b} vs {loss_e} with the TDNN blocks' eager ops: "
          f"{eager_rel:.3e} relative, bar {BF16_LOSS_BAR}")
    check(not bf16_bars or d_bf16 <= BF16_GRAD_BAR, f"bf16 step gradients {d_bf16:.3e} of "
          f"the f32 norm from the f32 step, bar {BF16_GRAD_BAR}")
    check(not bf16_audit_failures(audit), f"the bf16 step breaks its recipe: {audit}")
    check(all(r["caught_by"] for r in planted.values()),
          "planted bf16 faults passed every bar: "
          + ", ".join(f for f, r in planted.items() if not r["caught_by"]))

    rows = []
    torch.cuda.reset_peak_memory_stats()
    for n in STEP_FRAMES:
        pcm16 = torch.from_numpy(batches[n]["pcm"]).to(dev)
        x = pcm16.float() / 32768.0
        k1_ms = time_ms(lambda: audio_features(x, cfg), iters=20)
        k1_bound, by = bound(front_end_work(*x.shape, cfg), peaks)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            trainer.compute_dtype = dtype
            ms = time_ms(lambda: trainer.train_step(pcm16, labels, margin), iters=5, warmup=2)
            rows.append({"n_frames": n, "dtype": name, "step_ms": ms,
                         "crops_per_sec": BATCH / ms * 1e3, "k1_ms": k1_ms,
                         "k1_share": k1_ms / ms, "k1_bound_ms": k1_bound, "k1_bound_by": by})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in rows:
        log(f"audio train step, bs {BATCH} x {r['n_frames']} {r['dtype']}: {r['step_ms']:.2f} "
            f"ms, {r['crops_per_sec']:.1f} crops/s; K1 {r['k1_ms']:.4f} ms = {r['k1_share']:.2%} "
            f"of the step (the function's bound {r['k1_bound_ms']:.4f} ms, {r['k1_bound_by']}) "
            f"[{smi}]")
    log(f"audio train steps: peak {peak_gb:.2f} GB allocated [{smi}]")

    prof = profiled_audio_step(trainer, torch.from_numpy(batches[300]["pcm"]).to(dev), labels,
                               margin, smi)
    restore()
    return {"loss_rel": loss_rel, "grad_distance": d_kp, "nudge_distance": d_np,
            "bf16_loss_rel": bf16_rel, "bf16_eager_loss_rel": eager_rel,
            "bf16_grad_distance": d_bf16, "bf16_audit": audit,
            "bf16_planted": planted, "step_losses": {"kernel": loss_k, "plain": loss_p,
                                                       "nudged": loss_n, "bf16": loss_b,
                                                       "bf16_eager_blocks": loss_e},
            "worst_tensor": {k: list(v) for k, v in worst.items()}, "timings": rows,
            "peak_gb": peak_gb, **prof}


def state_stepper(trainer, labels: torch.Tensor, margin):
    """``(step, restore)``: ``step(pcm, dtype) -> (loss, grads)`` is one
    train step of ``trainer`` at compute type ``dtype`` from its state as it
    is now, which ``restore()`` puts back, with the compute type, after each
    step."""
    configured = trainer.compute_dtype
    params = [(f"model.{n}", p) for n, p in trainer.model.named_parameters()] + [
        (f"criterion.{n}", p) for n, p in trainer.criterion.named_parameters()]
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.criterion.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)

    def restore():
        trainer.model.load_state_dict(state[0])
        trainer.criterion.load_state_dict(state[1])
        trainer.optimizer.load_state_dict(state[2])
        trainer.step = state[3]
        trainer.compute_dtype = configured

    def step(pcm, dtype):
        trainer.compute_dtype = dtype
        loss = float(trainer.train_step(pcm, labels, margin)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in params}
        restore()
        return loss, grads

    return step, restore


def profiled_audio_step(trainer, pcm16: torch.Tensor, labels: torch.Tensor, margin,
                        smi: str) -> dict:
    """One profiled bf16 step of ``trainer`` (after one unprofiled): device
    time by kind (``AUDIO_KINDS``), the top kernels and the operators that
    launched them; the trainer's state and compute type are put back."""
    _, restore = state_stepper(trainer, labels, margin)
    trainer.compute_dtype = torch.bfloat16
    trainer.train_step(pcm16, labels, margin)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_step(pcm16, labels, margin)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels, kinds = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        # the program's spans (deeplip.*) mirror on the device's timeline: no kernels
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.key.startswith("deeplip.")):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
            kind = next(k for k, pat in AUDIO_KINDS if pat.search(ev.key))
            kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3
    # the operators that launched them, by their own kernels' device time
    ops = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count)
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CPU
                  and (getattr(ev, "self_device_time_total", 0) or 0) > 0),
                 key=lambda t: -t[0])[:12]
    busy = sum(kernels.values())
    restore()
    if busy > 0:
        log(f"profiled bf16 audio step at bs {pcm16.shape[0]} x {pcm16.shape[1]} samples: "
            f"{prof_wall:.2f} ms wall, {busy:.2f} ms of device kernels ({busy / prof_wall:.1%} "
            f"busy, {1 - busy / prof_wall:.1%} idle); by kind: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f" [{smi}]")
        log("  top kernels:")
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
            log(f"  {ms:9.3f} ms  {name[:150]}")
        log("  top operators (their own kernels' device time, calls):")
        for ms, name, count in ops:
            log(f"  {ms:9.3f} ms  {name} x{count}")
    else:
        log("profiled audio step: the profiler saw no device time (not measured)")
    return {"profiled_wall_ms": prof_wall, "profiled_busy_ms": busy,
            "profiled_by_kind_ms": kinds,
            "profiled_top_ops_ms": [[name, ms, count] for ms, name, count in ops]}


def audio_train_phase(smi: str, peaks) -> dict:
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        manifest, trials = write_train_corpus(root)
        corpus_s = time.perf_counter() - t0
        cfg_path = audio_train_config(root, manifest, trials)
        before = launch_counts()
        t0 = time.perf_counter()
        trainer, out = train_audio_cli.main(["--config", cfg_path, "--mode", "train",
                                             "--exp-root", os.path.join(root, "exp"),
                                             "--log-time", "run"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_since(before, FBANK + TDNN)
        eval_set = EvalUtteranceSet(utterances_from_trials(trials, root),
                                    **eval_set_kwargs(trainer.feat_cfg, trainer.test_opts))
        n_eval = sum(1 for _ in eval_set.batches())
        steps, bpe = trainer.step, trainer.pipeline.batches_per_epoch()
        lengths = [n for e in range(1, TRAIN_EPOCHS + 1)
                   for _, n in trainer.pipeline.sampler.epoch(e)]
        check(trainer.compute_dtype == torch.bfloat16 and trainer.batch_size == BATCH
              and len(trainer.pipeline.sampler.buckets) == 11
              and trainer.pipeline._resolve_transport() == "int16",
              "the trainer did not take conf/audio_config.yaml's recipe")
        check(steps == TRAIN_EPOCHS * bpe, f"{steps} steps for {TRAIN_EPOCHS} x {bpe} batches")
        check(counts == {"fft": steps + n_eval, "mixed": 0,
                         **tdnn_want(steps=steps, evals=n_eval)},
              f"front-end and T launches {counts} for {steps} train steps and {n_eval} "
              "extraction batches")
        losses = out["losses"]
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"train losses {losses}")
        for tag in [f"net_{e}" for e in range(1, TRAIN_EPOCHS + 1)] + ["net_avg"]:
            check(os.path.exists(os.path.join(trainer.exp_dir, tag)), f"no {tag} written")
        check(math.isfinite(out["eer"]) and 0.0 <= out["eer"] <= 1.0, f"EER {out['eer']}")
        log(f"audio training through cli/train_audio.py (conf/audio_config.yaml: flagship "
            f"E-TDNN, LMCL, SGD, bf16, bs {BATCH}): {TRAIN_SPEAKERS} speakers x {TRAIN_UTTS} "
            f"training wavs (and {len(TRAIN_TEST_UTTS)} held out for the trial list) written "
            f"in {corpus_s:.1f} s; {TRAIN_EPOCHS} epochs x {bpe} steps, crop "
            f"lengths {lengths}, losses {', '.join(f'{v:.4f}' for v in losses)}; averaged "
            f"net_1..net_{TRAIN_EPOCHS} into net_avg; {n_eval} extraction batches; EER "
            f"{out['eer']:.4f} (held-out utterances); front-end and T launches {counts}; "
            f"{wall:.1f} s wall [{smi}]")
        shapes = k1_training_shapes(trainer, peaks)
        log("K1 at the training crop shapes (CMVN after, atol 2e-4 / rtol 1e-3): " + ", ".join(
            f"{r['shape']} x{r['batches']}: err {r['max_abs_err']:.2e}, {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f}, {r['bound_by']})" for r in shapes) + f" [{smi}]")
        step = audio_step_phase(trainer, smi, peaks)
    return {"launches": counts, "steps": steps, "batches_per_epoch": bpe,
            "extraction_batches": n_eval, "crop_lengths": lengths, "losses": losses,
            "eer": out["eer"], "wall_s": wall, "k1_shapes": shapes, **step}


# ---------------------------------------------------------------- phase 6
def bn_site_shapes(b: int, t: int) -> list:
    """(shape, sites per train step) of the nine BN+PReLU sites of a
    Lipreading step on a (b, t)-frame batch at the 88x88 crop: the frontend,
    then two bn1 sites per trunk stage (time folded into the batch)."""
    n = b * t
    return [((b, t, 44, 44, 64), 1), ((n, 22, 22, 64), 2), ((n, 11, 11, 128), 2),
            ((n, 6, 6, 256), 2), ((n, 3, 3, 512), 2)]


BN_SHAPES = bn_site_shapes(128, 29)
BN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}  # y, dx: atol, rtol
STAT_TOL = (1e-5, 1e-5)          # mean, var in both types: f32 statistics
PARAM_GRAD_RTOL = 1e-4           # dscale, dbias, dalpha vs the plain largest
# flops per element, counted from the kernels' arithmetic: forward 3 for the
# sums + 6 to apply; backward 11 for the sums + 11 to apply
BN_FLOPS = {"fwd": 9, "bwd": 22}
BN_BYTES = {"fwd": 3, "bwd": 5}  # |x| multiples: the least traffic for exact batch statistics


def compare_tol(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float,
                what: str) -> float:
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements outside atol {atol} / "
          f"rtol {rtol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def bn_bound_ms(n: int, itemsize: int, peaks, kind: str) -> tuple[float, str]:
    fp32, _, bw = peaks
    bytes_ms = BN_BYTES[kind] * n * itemsize / bw * 1e3
    ops_ms = BN_FLOPS[kind] * n / fp32 * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def library_bn_prelu_ms(x, dy, scale, bias, alpha, eps) -> dict:
    """The library yardstick: ``F.batch_norm(training=True)`` then
    ``F.prelu`` (two calls; no single PyTorch call fuses them) on the
    channels-last activation, and their autograd backward."""
    lib_x = x.movedim(-1, 1).detach().requires_grad_(True)
    lib_p = [t.detach().clone().requires_grad_(True) for t in (scale, bias, alpha)]

    def fwd():
        z = torch.nn.functional.batch_norm(lib_x, None, None, lib_p[0], lib_p[1], True, 0.1, eps)
        return torch.nn.functional.prelu(z, lib_p[2])

    out, dy_nc = fwd(), dy.movedim(-1, 1)
    return {"fwd_library": time_ms(fwd),
            "bwd_library": time_ms(lambda: torch.autograd.grad(
                out, [lib_x, *lib_p], dy_nc, retain_graph=True))}


def bn_inputs(shape, dtype, seed: int):
    """Seeded ``(x, dy, scale, bias, alpha)`` on the card: conv outputs
    shifted by 1.5 sigma (the single-pass variance's cancellation case the
    JAX package guards), scale in [0.5, 1.5), alpha 0.25."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device="cuda") + 1.5).to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    scale = 0.5 + torch.rand(c, generator=g, device="cuda")
    bias = 0.3 * torch.randn(c, generator=g, device="cuda")
    return x, dy, scale, bias, torch.full((c,), 0.25, device="cuda")


def bn_prelu_check(x, dy, scale, bias, alpha, eps: float, what: str):
    """K3 and K4 against their plain versions on one input, and K3's
    statistics bit-equal on a rerun. Returns the errors and the forward's
    ``(mean, inv)``."""
    atol, rtol = BN_TOL[x.dtype]
    y, mean, var, inv = bn_prelu.bn_prelu_forward(x, scale, bias, alpha, eps)
    y_p, mean_p, var_p = bn_prelu.bn_prelu_reference(x, scale, bias, alpha, eps)
    err = {"y": compare_tol(y, y_p, atol, rtol, what + " y"),
           "mean": compare_tol(mean, mean_p, *STAT_TOL, what + " mean"),
           "var": compare_tol(var, var_p, *STAT_TOL, what + " var")}
    again = bn_prelu.bn_prelu_forward(x, scale, bias, alpha, eps)
    check(torch.equal(again[1], mean) and torch.equal(again[2], var)
          and torch.equal(again[0], y), f"{what}: statistics not bit-equal on a rerun")
    del y, y_p, again
    grads = bn_prelu.bn_prelu_backward(x, dy, mean, inv, scale, bias, alpha)
    grads_p = bn_prelu.bn_prelu_backward_reference(x, dy, mean, inv, scale, bias, alpha)
    err["dx"] = compare_tol(grads[0], grads_p[0], atol, rtol, what + " dx")
    for name, got, want in zip(("dscale", "dbias", "dalpha"), grads[1:], grads_p[1:]):
        big = float(want.abs().max())
        rel = float((got - want).abs().max()) / big
        check(rel <= PARAM_GRAD_RTOL, f"{what} {name}: {rel:.3e} of the plain "
              f"largest ({big:.3e}), bar {PARAM_GRAD_RTOL}")
        err[name] = rel
    return err, (mean, inv)


def bn_prelu_phase(peaks, shapes=BN_SHAPES) -> dict:
    """K3/K4 against their plain versions at ``(shape, sites per step)``,
    f32 and bf16, with kernel, plain and library times and the bounds."""
    rows, eps = [], 1e-5
    with fp32_math():
        for i, (shape, sites) in enumerate(shapes):
            for dtype in (torch.float32, torch.bfloat16):
                x, dy, scale, bias, alpha = bn_inputs(shape, dtype, 100 + i)
                what = f"bn_prelu {shape} {str(dtype)[6:]}"
                err, (mean, inv) = bn_prelu_check(x, dy, scale, bias, alpha, eps, what)

                times = {
                    "fwd": time_ms(lambda: bn_prelu.bn_prelu_forward(x, scale, bias, alpha, eps)),
                    "fwd_plain": time_ms(lambda: bn_prelu.bn_prelu_reference(
                        x, scale, bias, alpha, eps), iters=5),
                    "bwd": time_ms(lambda: bn_prelu.bn_prelu_backward(
                        x, dy, mean, inv, scale, bias, alpha)),
                    "bwd_plain": time_ms(lambda: bn_prelu.bn_prelu_backward_reference(
                        x, dy, mean, inv, scale, bias, alpha), iters=5),
                }
                if dtype == torch.float32:
                    times.update(library_bn_prelu_ms(x, dy, scale, bias, alpha, eps))
                del x, dy
                torch.cuda.empty_cache()
                n = math.prod(shape)
                for kind in ("fwd", "bwd"):
                    times[f"{kind}_bound"], times[f"{kind}_bound_by"] = bn_bound_ms(
                        n, dtype.itemsize, peaks, kind)
                row = {"shape": list(shape), "dtype": str(dtype)[6:], "sites": sites,
                       **{f"err_{k}": v for k, v in err.items()}, **times}
                rows.append(row)
                log(f"{what}: errs " + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
                    + "; ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()
                                          if not k.endswith("_by")))
    f32 = [r for r in rows if r["dtype"] == "float32"]
    per_step = {k: sum(r["sites"] * r[k] for r in f32) for k in (
        "fwd", "fwd_plain", "fwd_library", "fwd_bound", "bwd", "bwd_plain", "bwd_library",
        "bwd_bound")}
    log(f"bn_prelu per step ({sum(r['sites'] for r in f32)} sites of {shapes[0][0][:2]}, "
        "f32): " + ", ".join(f"{k} {v:.4f} ms" for k, v in per_step.items()))
    return {"rows": rows, "per_step": per_step}


# ---------------------------------------------------------------- max-pool
# (shape, what): the training step's frontend activation, one serving chunk
# (16 items x 2 clips x 32 frames), an odd-sized frame, a batch with tied pad
# frames; then the backward's edges: C = 4 and 12 (bf16 takes 4 channels a
# thread when C % 8 == 4; rows that are not whole 16-byte lines, staged by
# the threads), frames of 1 to 3 pixels a side, more frames than a grid
# axis holds (the backward loops over frames past 65,535), and rows too
# wide (600 pixels) and windows too deep (4,096 channels) for the stage to
# hold two whole window rows, which it tiles by columns and by channels
POOL_SHAPES = [((128, 29, 44, 44, 64), "train step"), ((32, 32, 44, 44, 64), "serving chunk"),
               ((3, 5, 43, 45, 8), "odd sizes"), ((8, 29, 44, 44, 64), "tied pad frames"),
               ((4, 6, 44, 44, 4), "4 channels"), ((4, 6, 43, 45, 12), "12 channels")]
POOL_SHAPES += [((16, 8, h, w, 12), f"{h}x{w} frames") for h in (1, 2, 3) for w in (1, 2, 3)]
POOL_SHAPES += [((1100, 64, 3, 2, 4), "70,400 frames"), ((2, 3, 9, 600, 64), "wide frames"),
                ((2, 2, 5, 6, 4096), "4096 channels")]
POOL_DX_RTOL = 1e-6                      # f32 dx, of the plain version's largest
POOL_DX_BF16 = (1e-6, 2.0 ** -7)         # bf16 dx: atol, rtol (one bf16 step)


def pool_inputs(shape, what: str, dtype, seed: int):
    """Seeded ``(x, dy)`` on the card: PReLU-like outputs centred below zero
    (so a zero-padded pool would be wrong), values rounded to a grid of 1/8
    so that windows hold repeated maxima; for the tied case, frames past
    each row's length are one constant per channel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") - 0.5
    x = torch.where(torch.rand(shape, generator=g, device="cuda") < 0.5,
                    torch.round(x * 8) / 8, x)
    if what == "tied pad frames":
        lengths = torch.randint(12, shape[1], (shape[0],), generator=g, device="cuda")
        pad = torch.arange(shape[1], device="cuda")[None, :] >= lengths[:, None]
        const = torch.randn(shape[-1], generator=g, device="cuda")
        x = torch.where(pad[:, :, None, None, None], const.expand(shape), x)
    n, t, h, w, c = shape
    dy = torch.randn((n, t, maxpool.pooled_size(h), maxpool.pooled_size(w), c),
                     generator=g, device="cuda")
    return x.to(dtype).contiguous(), dy.to(dtype)


def pool_plain_backward(x: torch.Tensor, dy: torch.Tensor):
    """The plain version's ``(y, dx)`` through autograd. For bf16 it works
    in f32 and rounds once, as the kernel does and as the other plain
    versions do: autograd in bf16 rounds after each of a pixel's up to four
    additions."""
    xr = x.detach().float().requires_grad_(True)
    y = maxpool.maxpool_frontend_reference(xr)
    (dx,) = torch.autograd.grad(y, xr, dy.float())
    return y.detach().to(x.dtype), dx.to(x.dtype)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (-0.0 is not 0.0, and a NaN equals its own bits)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints.get(a.dtype, a.dtype)), b.view(ints.get(b.dtype, b.dtype))))


def pool_check(x: torch.Tensor, dy: torch.Tensor, what: str) -> float:
    """Forward bit-equal (with and without the saved positions), positions
    and dx bit-equal to their plain versions, dx within its bar of
    ``F.max_pool3d``'s autograd, the autograd op equal to the two wrappers.
    Returns the backward's largest error against the autograd."""
    y, pos = maxpool.maxpool_forward(x, with_pos=True)
    y_only, none = maxpool.maxpool_forward(x)
    y_p, dx_p = pool_plain_backward(x, dy)
    check(none is None and torch.equal(y, y_only), f"{what}: y differs with the positions saved")
    check(y.shape == y_p.shape and torch.equal(y, y_p), f"{what}: y is not bit-equal to "
          f"F.max_pool3d ({int((y != y_p).sum())} elements differ)")
    pos_p = maxpool.maxpool_positions_reference(x)
    check(torch.equal(pos, pos_p), f"{what}: pos is not bit-equal to its plain version "
          f"({int((pos != pos_p).sum())} elements differ)")
    dx = maxpool.maxpool_backward(dy, pos, x.shape)
    dx_r = maxpool.maxpool_backward_reference(dy, pos, x.shape)
    check(bit_equal(dx, dx_r), f"{what}: dx is not bit-equal to maxpool_backward_reference "
          f"(largest difference {float((dx.float() - dx_r.float()).abs().max()):.3e})")
    del pos_p, dx_r
    if x.dtype == torch.float32:
        big = float(dx_p.abs().max())
        err = float((dx - dx_p).abs().max())
        check(err <= POOL_DX_RTOL * big, f"{what}: dx {err:.3e} from the plain version's, "
              f"bar {POOL_DX_RTOL} of its largest ({big:.3e})")
    else:
        err = compare_tol(dx, dx_p, *POOL_DX_BF16, what + " dx")
    xr = x.detach().clone().requires_grad_(True)
    y_op = maxpool.maxpool_frontend(xr)
    (dx_op,) = torch.autograd.grad(y_op, xr, dy)
    check(torch.equal(y_op, y) and torch.equal(dx_op, dx), f"{what}: the autograd op differs "
          "from its two kernels")
    return err


def pool_nan_check() -> None:
    """A NaN tap is the window's maximum, as in ``F.max_pool3d``, and its
    window's gradient goes to the last NaN, as in the plain versions."""
    x, dy = pool_inputs((2, 3, 12, 12, 8), "nan", torch.float32, 7)
    x[0, 1, 5, 5, 3] = float("nan")
    x[0, 1, 5, 6, 3] = float("nan")
    x[1, 2, 0, 11, 0] = float("nan")
    for dtype in (torch.float32, torch.bfloat16):
        xd, dyd = x.to(dtype), dy.to(dtype)
        y, pos = maxpool.maxpool_forward(xd, with_pos=True)
        y_p = maxpool.maxpool_frontend_reference(xd)
        check(int(torch.isnan(y_p).sum()) >= 3, "the plain pool dropped the planted NaN")
        check(torch.equal(torch.isnan(y), torch.isnan(y_p))
              and torch.equal(torch.nan_to_num(y), torch.nan_to_num(y_p)),
              "the max-pool kernel does not propagate NaN as F.max_pool3d does")
        check(torch.equal(pos, maxpool.maxpool_positions_reference(xd))
              and bit_equal(maxpool.maxpool_backward(dyd, pos, xd.shape),
                            maxpool.maxpool_backward_reference(dyd, pos, xd.shape)),
              f"the max-pool kernels route NaN windows apart from their plain versions "
              f"({str(dtype)[6:]})")


def pool_bounds_ms(shape, itemsize: int, peaks) -> dict:
    """Least times for the bytes each pass must move: forward x in and y
    out (plus one byte per output element when the positions are saved);
    backward dy and the positions in and dx out. Nine compares per output
    element never bound it."""
    fp32, _, bw = peaks
    n_in = math.prod(shape)
    n_out = n_in // (shape[2] * shape[3]) * maxpool.pooled_size(shape[2]) * maxpool.pooled_size(shape[3])
    ops_ms = 9 * n_out / fp32 * 1e3
    out = {"fwd_bound": (n_in + n_out) * itemsize / bw * 1e3,
           "fwd_pos_bound": ((n_in + n_out) * itemsize + n_out) / bw * 1e3,
           "bwd_bound": ((n_in + n_out) * itemsize + n_out) / bw * 1e3}
    check(all(v >= ops_ms for v in out.values()), "the max-pool bound is not the bytes'")
    return out


def maxpool_phase(peaks, shapes=POOL_SHAPES) -> dict:
    """P against its plain version at each ``(shape, what)``, f32 and bf16,
    timed at the train-step and serving-chunk shapes."""
    pool_nan_check()
    rows = []
    for i, (shape, what) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = pool_inputs(shape, what, dtype, 300 + i)
            label = f"maxpool {shape} {str(dtype)[6:]} ({what})"
            err = pool_check(x, dy, label)
            times = {}
            if what in ("train step", "serving chunk"):
                _, pos = maxpool.maxpool_forward(x, with_pos=True)
                xr = x.detach().clone().requires_grad_(True)
                y_p = maxpool.maxpool_frontend_reference(xr)
                x_ncdhw = x.movedim(-1, 1).contiguous()
                pool = lambda t: torch.nn.functional.max_pool3d(t, (1, 3, 3), (1, 2, 2), (0, 1, 1))
                times = {
                    "fwd": time_ms(lambda: maxpool.maxpool_forward(x)),
                    "fwd_pos": time_ms(lambda: maxpool.maxpool_forward(x, with_pos=True)),
                    # the plain version is the library call on the channels-last view
                    "fwd_plain": time_ms(lambda: maxpool.maxpool_frontend_reference(x)),
                    "fwd_library_contiguous": time_ms(lambda: pool(x_ncdhw)),
                    "bwd": time_ms(lambda: maxpool.maxpool_backward(dy, pos, x.shape)),
                    "bwd_plain": time_ms(lambda: torch.autograd.grad(
                        y_p, xr, dy, retain_graph=True)),
                }
                del pos, xr, y_p, x_ncdhw
                times.update(pool_bounds_ms(shape, dtype.itemsize, peaks))
                times["bwd_bound_share"] = times["bwd_bound"] / times["bwd"]
            del x, dy
            torch.cuda.empty_cache()
            rows.append({"shape": list(shape), "dtype": str(dtype)[6:], "what": what,
                         "err_dx": err, **times})
            log(f"{label}: y, pos and dx bit-equal to the plain versions, dx err {err:.2e}"
                + ("; ms " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()
                                       if k != "bwd_bound_share")
                   + f"; bwd at {times['bwd_bound_share']:.1%} of its bound" if times else ""))
    return {"rows": rows}



# ---------------------------------------------------------------- phase 21
# ((B, T, H, W), C, what): the train step's clip at both frontend widths,
# then bands that do not divide Ho (21), the video study's 44 x 44 crop (Wo
# no multiple of four), rows of no multiple of four pixels, one frame, and
# frames under a band
WGRAD_SHAPES = [((128, 29, 88, 88), 64, "train step"), ((128, 29, 88, 88), 24, "train step"),
                ((3, 7, 42, 40), 64, "odd bands"), ((3, 7, 42, 40), 24, "odd bands"),
                ((4, 10, 44, 44), 64, "44 x 44 crop"), ((2, 5, 43, 45), 24, "odd frames"),
                ((2, 1, 88, 88), 64, "one frame"), ((2, 3, 5, 7), 24, "small frames")]
# |dW - dW in float64| over the float64 dW's largest: f32 sums of 7.2 M
# products in another order sit near 1e-7; a wrong tap or band reads O(1)
WGRAD_RTOL = 1e-5


def wgrad_error(got: torch.Tensor, want64: torch.Tensor) -> float:
    return float((got.double() - want64).abs().max() / want64.abs().max())


def wgrad_library(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The library yardstick, cuDNN's FP32 weight gradient as the f32 step
    took it before the kernel: ``convolution_backward`` for the weight alone
    on the channels-last views, TF32 off."""
    with fp32_math():
        return torch.nn.grad.conv3d_weight(x[:, None], (dy.shape[-1], 1, *conv3d_wgrad.KERNEL),
                                           dy.movedim(-1, 1), conv3d_wgrad.STRIDE,
                                           conv3d_wgrad.PADDING)


def wgrad_replay_equal(dy: torch.Tensor, x: torch.Tensor, want: torch.Tensor) -> bool:
    """The op captured in a CUDA graph, replayed twice: bit-equal to ``want``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv3d_wgrad.conv3d_wgrad(dy, x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv3d_wgrad.conv3d_wgrad(dy, x)
    equal = []
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        equal.append(bit_equal(out, want))
    del graph
    return all(equal)


def wgrad_route_check() -> dict:
    """The frontend conv on the card: the routed forward bit-equal to
    ``conv_nhwc``'s, its weight gradient beside cuDNN's, and the kernel's
    launches in f32 train steps (one a step), f32 extraction, and bf16 steps
    (none)."""
    gen = torch.Generator(device="cuda").manual_seed(2150)
    clips = torch.randint(0, 256, (16, 29, 96, 96), dtype=torch.uint8, device="cuda",
                          generator=gen)
    lengths = torch.full((16,), 29, dtype=torch.int64, device="cuda")
    labels = torch.randint(0, VIDEO_SPEAKERS, (16,), device="cuda", generator=gen)
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        trainer = VideoTrainer(video_config(), num_classes=VIDEO_SPEAKERS, exp_root=root)
        conv = trainer.model.frontend3D[0]
        x = torch.randn((16, 29, 88, 88, 1), device="cuda", generator=gen)
        dy = torch.randn((16, 29, 44, 44, 64), device="cuda", generator=gen)
        wgrad = lambda before: launches_since(before, ("conv3d_wgrad",))["conv3d_wgrad"]
        with fp32_math():
            before = launch_counts()
            routed = frontend_conv(conv, x)
            plain = conv_nhwc(conv, x)
            check(bit_equal(routed, plain), "the routed frontend forward differs from conv_nhwc's")
            (dw_kernel,) = torch.autograd.grad(routed, conv.weight, dy)
            (dw_cudnn,) = torch.autograd.grad(plain, conv.weight, dy)
            check(wgrad(before) == 1, "the routed backward did not launch the kernel once")
        grad_err = float((dw_kernel - dw_cudnn).abs().max() / dw_cudnn.abs().max())
        check(grad_err <= WGRAD_RTOL, f"the routed weight gradient is {grad_err:.2e} from cuDNN's")
        draws = torch.Generator().manual_seed(0)
        before = launch_counts()
        losses = [float(trainer.train_step(clips, lengths, labels, draws)["loss"])
                  for _ in range(3)]
        launches["f32_steps"] = wgrad(before)
        check(launches["f32_steps"] == 3, f"3 f32 video steps launched the kernel "
              f"{launches['f32_steps']} times")
        check(all(math.isfinite(v) for v in losses), f"non-finite f32 losses {losses}")
        before = launch_counts()
        trainer.frame_features(clips, lengths)
        launches["f32_extraction"] = wgrad(before)
        del trainer
        bf16 = VideoTrainer(video_config(), num_classes=VIDEO_SPEAKERS, exp_root=root,
                            compute_dtype="bf16")
        bf16.train_step(clips, lengths, labels, draws)
        launches["bf16_step"] = wgrad(before)
        del bf16
    check(launches["f32_extraction"] == launches["bf16_step"] == 0,
          f"extraction or a bf16 step launched the kernel: {launches}")
    release()
    return {"launches": launches, "routed_vs_cudnn_grad": grad_err, "f32_losses": losses}


def conv3d_wgrad_phase(peaks) -> dict:
    """Phase 21: the frontend Conv3d's weight-gradient kernel against its
    plain version in float64 at each of :data:`WGRAD_SHAPES`, bit-equal
    over two runs and, at the train step's shape, over CUDA-graph replays;
    refusals; kernel, plain and library times beside the bound at the train
    step's shape; then the frontend's routing on the card."""
    rows = []
    for i, (shape, c, what) in enumerate(WGRAD_SHAPES):
        b, t, h, w = shape
        gen = torch.Generator(device="cuda").manual_seed(2100 + i)
        x = torch.randn(shape, device="cuda", generator=gen)
        dy = torch.randn((b, t, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c), device="cuda",
                         generator=gen)
        got = conv3d_wgrad.conv3d_wgrad(dy, x)
        again = conv3d_wgrad.conv3d_wgrad(dy, x)
        torch.cuda.synchronize()
        check(bit_equal(got, again), f"conv3d_wgrad {shape} x {c}: two runs differ")
        want = conv3d_wgrad.conv3d_wgrad_reference(dy.double(), x.double())
        row = {"shape": list(shape), "channels": c, "what": what, "err": wgrad_error(got, want)}
        check(row["err"] <= WGRAD_RTOL, f"conv3d_wgrad {shape} x {c} ({what}): {row['err']:.2e} "
              f"from float64, bar {WGRAD_RTOL}")
        if what == "train step":
            check(wgrad_replay_equal(dy, x, got), f"conv3d_wgrad {shape} x {c}: a graph replay "
                  "differs from the eager run")
            row["err_plain"] = wgrad_error(conv3d_wgrad.conv3d_wgrad_reference(dy, x), want)
            row["err_library"] = wgrad_error(wgrad_library(dy, x), want)
            del want
            torch.cuda.empty_cache()
            row["ms"] = time_ms(lambda: conv3d_wgrad.conv3d_wgrad(dy, x))
            row["plain_ms"] = time_ms(lambda: conv3d_wgrad.conv3d_wgrad_reference(dy, x),
                                      iters=5, warmup=1)
            row["library_ms"] = time_ms(lambda: wgrad_library(dy, x), iters=3, warmup=1)
            row["bound_ms"] = 2e3 * c * 245 * dy[..., 0].numel() / peaks[0]
            row["bound_share"] = row["bound_ms"] / row["ms"]
        del x, dy, got, again
        torch.cuda.empty_cache()
        rows.append(row)
        log(f"conv3d_wgrad {shape} x {c} ({what}): " + ", ".join(
            f"{k} {v:.4g}" for k, v in row.items() if isinstance(v, float)))
    for c, dtype, error in ((32, torch.float32, ValueError), (64, torch.float64, TypeError)):
        try:
            conv3d_wgrad.conv3d_wgrad(torch.zeros((2, 3, 44, 44, c), device="cuda", dtype=dtype),
                                      torch.zeros((2, 3, 88, 88), device="cuda", dtype=dtype))
            refused = False
        except error:
            refused = True
        check(refused, f"conv3d_wgrad took {c} channels in {dtype}")
    return {"rows": rows, "route": wgrad_route_check()}


def conv3d_wgrad_only() -> int:
    """``--conv3d-wgrad``: phases 1, 2 and 21 alone, one JSON line."""
    dev = device_phase()
    _, peaks = card_peaks(dev["name"])
    build_phase()
    out = conv3d_wgrad_phase(peaks)
    print(json.dumps({"card": dev["smi"], "conv3d_wgrad": out,
                      "kernel": conv3d_wgrad_entry(out, None)}), flush=True)
    return 0

# ---------------------------------------------------------------- phase 22
# (B, C, T) of the E-TDNN blocks' conv outputs at the cells' crops: blocks 1
# and 2 (512 channels) and block 10 (1,500 channels)
TDNN_SHAPES = [(256, 512, 295), (256, 1500, 277)]
# |x| multiples of T's least traffic: each input read once, each output written once
TDNN_BYTES = {"fwd": 2, "bwd": 3, "eval": 2}
TDNN_BLOCKS = 10                  # conf/audio_config.yaml's E-TDNN
TDNN_REPLAY_SHAPE = (64, 512, 295)
TDNN_SLOPE, TDNN_EPS = 0.2, 1e-5
TDNN_EVAL_RTOL = 1e-6             # f32 eval against the eager ops, of the largest |y|
TDNN_BF16_SUM_RTOL = 2 ** -7      # dscale, dbias: sums rounded to bf16, two roundings apart


def tdnn_inputs(shape, dtype, seed: int):
    """Seeded ``(x, dy, conv_bias, scale, bias)`` on the card: a conv output
    without its bias with a per-channel spread, the conv bias, scale in
    [0.5, 1.5)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device="cuda")
         * (0.5 + torch.rand((1, c, 1), generator=g, device="cuda"))).to(dtype)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    conv_bias = torch.randn(c, generator=g, device="cuda")
    scale = 0.5 + torch.rand(c, generator=g, device="cuda")
    bias = 0.3 * torch.randn(c, generator=g, device="cuda")
    return x, dy, conv_bias, scale, bias


def eager_bn_leaky(bn: TorchBatchNorm, x: torch.Tensor, conv_bias: torch.Tensor) -> torch.Tensor:
    """A block's conv bias add, BN and LeakyReLU as eager ops, as the blocks
    ran before T, on the ``(B, C, T)`` conv output without its bias: the
    library yardstick."""
    y = x + conv_bias.to(x.dtype)[:, None]
    return torch.nn.functional.leaky_relu(bn(y.transpose(1, 2)), TDNN_SLOPE).transpose(1, 2)


def tdnn_bn(scale: torch.Tensor, bias: torch.Tensor) -> TorchBatchNorm:
    bn = TorchBatchNorm(scale.shape[0]).cuda()
    with torch.no_grad():
        bn.weight.copy_(scale)
        bn.bias.copy_(bias)
    return bn


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def tdnn_bound_ms(n: int, itemsize: int, peaks, kind: str) -> float:
    return TDNN_BYTES[kind] * n * itemsize / peaks[2] * 1e3


def tdnn_train_check(shape, peaks, seed: int) -> dict:
    """T's train forward and backward in bf16 against their plain versions
    (bit-equal on a rerun) and the eager ops whose rounding they follow,
    against float64 beside the eager ops, and timed beside the plain
    versions and the eager ops."""
    x, dy, cb, scale, bias = tdnn_inputs(shape, torch.bfloat16, seed)
    what = f"T train {shape} bf16"
    atol, rtol = BN_TOL[torch.bfloat16]
    args = (TDNN_EPS, TDNN_SLOPE)
    out = tdnn_bn_act.tdnn_bn_act_forward(x, cb, scale, bias, *args)
    again = tdnn_bn_act.tdnn_bn_act_forward(x, cb, scale, bias, *args)
    check(all(bit_equal(a, b) for a, b in zip(out, again)), f"{what}: the forward is not "
          "bit-equal on a rerun")
    y, mean, var, inv = out
    y_p, mean_p, var_p = tdnn_bn_act.tdnn_bn_act_reference(x, cb, scale, bias, *args)
    err = {"y": compare_tol(y, y_p, atol, rtol, what + " y"),
           "mean": compare_tol(mean, mean_p, *STAT_TOL, what + " mean"),
           "var": compare_tol(var, var_p, *STAT_TOL, what + " var")}
    del again, y_p
    grads = tdnn_bn_act.tdnn_bn_act_backward(x, dy, cb, mean, inv, scale, bias, TDNN_SLOPE)
    again = tdnn_bn_act.tdnn_bn_act_backward(x, dy, cb, mean, inv, scale, bias, TDNN_SLOPE)
    check(all(bit_equal(a, b) for a, b in zip(grads, again)), f"{what}: the backward is not "
          "bit-equal on a rerun")
    grads_p = tdnn_bn_act.tdnn_bn_act_backward_reference(x, dy, cb, mean, inv, scale, bias,
                                                         TDNN_SLOPE, TDNN_EPS)
    err["dx"] = compare_tol(grads[0], grads_p[0], atol, rtol, what + " dx")
    # the conv bias's gradient sums dx: zero in exact arithmetic, its size is the recipe's
    # rounding noise, read beside the plain version's and the eager ops'
    err["dconv_bias_norm"] = float(grads[1].norm())
    err["dconv_bias_norm_plain"] = float(grads_p[1].norm())
    for name, got, want in zip(("dscale", "dbias"), grads[2:], grads_p[2:]):
        # both are sums rounded to bf16, as the gradients of the parameters' bf16 casts
        err[name] = rel_max(got, want)
        check(err[name] <= TDNN_BF16_SUM_RTOL, f"{what} {name}: {err[name]:.3e} of the plain "
              f"largest, bar {TDNN_BF16_SUM_RTOL}")
    del again, grads_p
    # the eager bf16 ops, whose rounding T follows, and float64 beside both
    bn = tdnn_bn(scale, bias)
    xe, cbe = x.detach().requires_grad_(True), cb.detach().requires_grad_(True)
    ye = eager_bn_leaky(bn, xe, cbe)
    dxe, dcbe = torch.autograd.grad(ye, (xe, cbe), dy, retain_graph=True)
    err["y_eager"] = compare_tol(y, ye, atol, rtol, what + " y against the eager ops")
    err["dx_eager"] = compare_tol(grads[0], dxe, atol, rtol, what + " dx against the eager ops")
    err["dconv_bias_norm_eager"] = float(dcbe.norm())
    y64, mean64, var64 = tdnn_bn_act.tdnn_bn_act_reference(x.double(), cb.double(),
                                                           scale.double(), bias.double(), *args)
    f64 = {"y": rel_max(y, y64), "y_eager": rel_max(ye, y64)}
    del y64
    dx64 = tdnn_bn_act.tdnn_bn_act_backward_reference(
        x.double(), dy.double(), cb.double(), mean64, torch.rsqrt(var64 + TDNN_EPS),
        scale.double(), bias.double(), TDNN_SLOPE, TDNN_EPS)[0]
    f64.update(dx=rel_max(grads[0], dx64), dx_eager=rel_max(dxe, dx64))
    del dx64, dxe
    torch.cuda.empty_cache()
    eager_params = (xe, cbe, bn.weight, bn.bias)
    times = {
        "fwd": time_ms(lambda: tdnn_bn_act.tdnn_bn_act_forward(x, cb, scale, bias, *args)),
        "bwd": time_ms(lambda: tdnn_bn_act.tdnn_bn_act_backward(x, dy, cb, mean, inv, scale,
                                                                bias, TDNN_SLOPE)),
        "fwd_plain": time_ms(lambda: tdnn_bn_act.tdnn_bn_act_reference(x, cb, scale, bias,
                                                                       *args), iters=5),
        "bwd_plain": time_ms(lambda: tdnn_bn_act.tdnn_bn_act_backward_reference(
            x, dy, cb, mean, inv, scale, bias, TDNN_SLOPE, TDNN_EPS), iters=5),
        "fwd_eager": time_ms(lambda: eager_bn_leaky(bn, xe, cbe), iters=5),
        "bwd_eager": time_ms(lambda: torch.autograd.grad(ye, eager_params, dy,
                                                         retain_graph=True), iters=5),
    }
    n = math.prod(shape)
    for kind in ("fwd", "bwd"):
        times[f"{kind}_bound"] = tdnn_bound_ms(n, 2, peaks, kind)
    del x, dy, xe, ye, grads
    torch.cuda.empty_cache()
    return {"shape": list(shape), "dtype": "bfloat16", "err": err, "err_vs_float64": f64,
            **times}


def tdnn_eval_check(shape, peaks, seed: int) -> dict:
    """T's eval apply in f32 against the eager ops and its plain version
    (the same op order: bit-equal is the aim, ``TDNN_EVAL_RTOL`` the bar),
    bit-equal on a rerun, and timed beside both."""
    x, _, cb, scale, bias = tdnn_inputs(shape, torch.float32, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    c = shape[1]
    bn = tdnn_bn(scale, bias).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g, device="cuda"))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=g, device="cuda"))
    what = f"T eval {shape} f32"
    ev = (cb, bn.running_mean, bn.running_var, scale, bias, TDNN_EPS, TDNN_SLOPE)
    y = tdnn_bn_act.tdnn_bn_act_eval(x, *ev)
    check(bit_equal(y, tdnn_bn_act.tdnn_bn_act_eval(x, *ev)), f"{what}: not bit-equal on a rerun")
    with torch.no_grad(), fp32_math():
        ye = eager_bn_leaky(bn, x, cb)
        y_p = tdnn_bn_act.tdnn_bn_act_eval_reference(x, *ev)
    row = {"shape": list(shape), "dtype": "float32",
           "bit_equal_eager": bit_equal(y, ye.contiguous()),
           "bit_equal_plain": bit_equal(y, y_p), "err_eager": rel_max(y, ye),
           "err_plain": rel_max(y, y_p)}
    check(row["err_eager"] <= TDNN_EVAL_RTOL, f"{what}: {row['err_eager']:.3e} from the eager "
          f"ops, bar {TDNN_EVAL_RTOL}")
    del ye, y_p
    with torch.no_grad():
        row.update(eval=time_ms(lambda: tdnn_bn_act.tdnn_bn_act_eval(x, *ev)),
                   eval_plain=time_ms(lambda: tdnn_bn_act.tdnn_bn_act_eval_reference(x, *ev),
                                      iters=5),
                   eval_eager=time_ms(lambda: eager_bn_leaky(bn, x, cb), iters=5),
                   eval_bound=tdnn_bound_ms(math.prod(shape), 4, peaks, "eval"))
    del x, y
    torch.cuda.empty_cache()
    return row


def tdnn_replay_equal() -> bool:
    """A bf16 train forward and backward and an eval apply captured in one
    CUDA graph and replayed twice: bit-equal to the same calls run eagerly."""
    x, dy, cb, scale, bias = tdnn_inputs(TDNN_REPLAY_SHAPE, torch.bfloat16, 2230)
    x.requires_grad_(True)
    cb.requires_grad_(True)

    def calls():
        y, mean, var = tdnn_bn_act.tdnn_bn_act_train(x, cb, scale, bias, TDNN_EPS, TDNN_SLOPE)
        dx, dcb = torch.autograd.grad(y, (x, cb), dy)
        return (y.detach(), mean, var, dx, dcb, tdnn_bn_act.tdnn_bn_act_eval(
            x.detach(), cb.detach(), mean, var, scale, bias, TDNN_EPS, TDNN_SLOPE))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = [t.clone() for t in calls()]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = calls()
    equal = []
    for _ in range(2):
        for o in out:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        equal.append(all(bit_equal(o, w) for o, w in zip(out, want)))
    del graph
    return all(equal)


def tdnn_want(steps: int = 0, probes: int = 0, evals: int = 0,
              blocks: int = TDNN_BLOCKS) -> dict:
    """T's launches for ``steps`` train steps, ``probes`` train-mode
    forwards without a backward and ``evals`` eval forwards of an E-TDNN of
    ``blocks`` blocks: 3 + 4 a block a step, 3 a block a probe, 1 a block an
    eval forward."""
    return {"tdnn_fwd": 3 * blocks * (steps + probes), "tdnn_bwd": 4 * blocks * steps,
            "tdnn_eval": blocks * evals}


def tdnn_plain_forward(x, conv_bias, scale, bias, eps=TDNN_EPS, slope=TDNN_SLOPE):
    y, mean, var = tdnn_bn_act.tdnn_bn_act_reference(x, conv_bias, scale, bias, eps, slope)
    return y, mean, var, torch.rsqrt(var + eps)



@contextlib.contextmanager
def plain_tdnn_bn_act():
    """Route T's three wrappers through their plain versions on the same
    device and inside the same autograd op."""
    kernels = (tdnn_bn_act.tdnn_bn_act_forward, tdnn_bn_act.tdnn_bn_act_backward,
               tdnn_bn_act.tdnn_bn_act_eval)
    tdnn_bn_act.tdnn_bn_act_forward = tdnn_plain_forward
    tdnn_bn_act.tdnn_bn_act_backward = tdnn_bn_act.tdnn_bn_act_backward_reference
    tdnn_bn_act.tdnn_bn_act_eval = tdnn_bn_act.tdnn_bn_act_eval_reference
    try:
        yield
    finally:
        (tdnn_bn_act.tdnn_bn_act_forward, tdnn_bn_act.tdnn_bn_act_backward,
         tdnn_bn_act.tdnn_bn_act_eval) = kernels


@contextlib.contextmanager
def eager_tdnn_blocks():
    """The TDNN blocks' BN + LeakyReLU as eager ops on the card, as before T."""
    route = tdnn_model.TDNNBlock.fused
    tdnn_model.TDNNBlock.fused = lambda self, x: False
    try:
        yield
    finally:
        tdnn_model.TDNNBlock.fused = route


def harmonic_train_batch(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A bs ``BATCH`` x ``GROUP_FRAMES`` int16 batch on the card of phase 11's
    speakers (:func:`training_wave`'s pitches and resonances), row i of
    speaker i mod ``TRAIN_SPEAKERS``, and its labels."""
    s = samples_for_frames(GROUP_FRAMES, 0.025, 0.01, RATE)
    spk = np.arange(BATCH) % TRAIN_SPEAKERS
    rows = [harmonic_wave(np.random.default_rng((seed, i)), 90.0 + 1.5 * k, 400.0 + 25.0 * k, s)
            for i, k in enumerate(spk)]
    pcm = np.round(np.clip(np.stack(rows), -1.0, 1.0) * 32767.0).astype(np.int16)
    return torch.from_numpy(pcm).cuda(), torch.from_numpy(spk.astype(np.int64)).cuda()


def tdnn_route_check(trainer: AudioTrainer, pcm: torch.Tensor, labels: torch.Tensor) -> dict:
    """T's launches in a bf16 train step (3 + 4 a block) and an f32
    extraction batch (1 a block), and the blocks' output strides against
    the eager blocks': the conv's ``(B, C, T)`` memory seen as ``(B, T, C)``."""
    strides = {}

    def record(tag):
        def hook(mod, args, out):
            strides.setdefault(tag, []).append(tuple(out.stride()))
        return hook

    extractor = trainer.extractor
    feat_lengths = torch.full((pcm.shape[0],), num_frames(pcm.shape[1], 400, 160),
                              dtype=torch.int32, device=pcm.device)
    sample_lengths = torch.full((pcm.shape[0],), pcm.shape[1], dtype=torch.int32,
                                device=pcm.device)
    launches = {}
    for tag, ctx in (("fused", contextlib.nullcontext), ("eager", eager_tdnn_blocks)):
        hooks = [blk.register_forward_hook(record(tag)) for blk in trainer.model.tdnn]
        with ctx():
            before = launch_counts()
            trainer.train_step(pcm, labels, trainer.init_margin)
            torch.cuda.synchronize()
            launches[f"{tag}_train_step"] = launches_since(before, TDNN)
            before = launch_counts()
            extractor.embed(pcm, feat_lengths, sample_lengths)
            torch.cuda.synchronize()
            launches[f"{tag}_extraction_batch"] = launches_since(before, TDNN)
        for h in hooks:
            h.remove()
    want = {"fused_train_step": {"tdnn_fwd": 3 * TDNN_BLOCKS, "tdnn_bwd": 4 * TDNN_BLOCKS,
                                 "tdnn_eval": 0},
            "fused_extraction_batch": {"tdnn_fwd": 0, "tdnn_bwd": 0, "tdnn_eval": TDNN_BLOCKS},
            "eager_train_step": dict.fromkeys(TDNN, 0),
            "eager_extraction_batch": dict.fromkeys(TDNN, 0)}
    check(launches == want, f"T launches {launches}, expected {want}")
    check(strides["fused"] == strides["eager"], f"the fused blocks hand on strides "
          f"{strides['fused']}, the eager blocks {strides['eager']}")
    return {"launches": launches, "strides": strides["fused"]}


def tdnn_step_check(trainer: AudioTrainer, pcm: torch.Tensor, labels: torch.Tensor,
                    smi: str) -> dict:
    """Phase 11's step rule with T in place of K1: from one state, a step
    through T against the same step through T's plain versions, held to
    3x what a 1e-6 nudge of the PCM moves the plain step, in f32 and in
    bf16. The bf16 step through T against the bf16 step with the blocks'
    eager ops, whose recipe T follows: the loss within ``BF16_LOSS_BAR``,
    the gradients within the same 3x nudge. The bf16 step's recipe audited
    and the four planted bf16 faults caught (by the audit, or by a loss
    further than ``BF16_LOSS_BAR`` from the eager bf16 step's); then one
    profiled bf16 step."""
    margin, dev = trainer.init_margin, trainer.device
    step, _ = state_stepper(trainer, labels, margin)
    x = pcm.float() / 32768.0
    gen = torch.Generator(device=dev).manual_seed(2231)
    nudged = x * (1.0 + NUDGE * torch.randn(x.shape, generator=gen, device=dev))
    rules, planted = {}, {}
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            loss_k, grads_k = step(x, dtype)
            with plain_tdnn_bn_act():
                loss_p, grads_p = step(x, dtype)
                loss_n, grads_n = step(nudged, dtype)
            rules[name] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                           "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
                           "grad_distance": grad_distance(grads_k, grads_p),
                           "nudge_distance": grad_distance(grads_n, grads_p),
                           "worst_tensor": list(worst_tensor(grads_k, grads_p))}
            if name == "f32":
                loss_f32 = loss_k
            del grads_k, grads_p, grads_n
        with eager_tdnn_blocks():
            loss_e, grads_e = step(x, torch.bfloat16)
        audit: dict = {}
        with bf16_audit(trainer.model, trainer.criterion, audit):
            loss_b, grads_b = step(x, torch.bfloat16)
        for fault in BF16_FAULTS:
            record: dict = {}
            with planted_bf16_fault(fault, trainer.model), \
                    bf16_audit(trainer.model, trainer.criterion, record):
                loss_f, _ = step(x, torch.bfloat16)
            rel = abs(loss_f - loss_e) / abs(loss_e)
            planted[fault] = {"loss_rel": rel, "audit": record,
                              "caught_by": bf16_audit_failures(record)
                              + (["loss"] if rel > BF16_LOSS_BAR else [])}
    recipe = {"loss_eager": loss_e, "loss_kernel": loss_b,
              "loss_rel": abs(loss_b - loss_e) / abs(loss_e),
              "grad_distance": grad_distance(grads_b, grads_e),
              "bar": NUDGE_FACTOR * rules["bf16"]["nudge_distance"],
              "kernel_from_f32": abs(loss_b - loss_f32) / abs(loss_f32),
              "eager_from_f32": abs(loss_e - loss_f32) / abs(loss_f32)}
    del grads_b, grads_e
    for name, r in rules.items():
        log(f"T step rule, {name} at bs {BATCH} x {GROUP_FRAMES} (TF32 off, cuDNN deterministic): "
            f"loss {r['loss_kernel']:.8f} vs plain {r['loss_plain']:.8f} ({r['loss_rel']:.2e}, "
            f"bar {AUDIO_STEP_LOSS_RTOL}); gradient distance {r['grad_distance']:.3e}, a "
            f"{NUDGE} nudge of the PCM {r['nudge_distance']:.3e} (bar {NUDGE_FACTOR} x); worst "
            f"tensor {r['worst_tensor'][0]:.2e} ({r['worst_tensor'][1]}) [{smi}]")
        check(r["loss_rel"] <= AUDIO_STEP_LOSS_RTOL, f"T {name} step loss {r['loss_rel']:.3e} "
              f"from the plain step's, bar {AUDIO_STEP_LOSS_RTOL}")
        check(r["grad_distance"] <= NUDGE_FACTOR * r["nudge_distance"],
              f"T {name} step gradients {r['grad_distance']:.3e} from the plain step's; a "
              f"{NUDGE} nudge moves them {r['nudge_distance']:.3e}; bar {NUDGE_FACTOR} x that")
    log(f"T bf16 step against the eager blocks' bf16 step: loss {loss_b:.6f} vs "
        f"{loss_e:.6f} ({recipe['loss_rel']:.2e}, bar {BF16_LOSS_BAR}), gradient distance "
        f"{recipe['grad_distance']:.3e} (bar {recipe['bar']:.3e}); from the f32 step T "
        f"{recipe['kernel_from_f32']:.2e}, eager {recipe['eager_from_f32']:.2e}; audit "
        f"{json.dumps(audit)} [{smi}]")
    for fault, r in planted.items():
        log(f"  planted bf16 fault {fault}: loss {r['loss_rel']:.2e} from the eager bf16 step, "
            f"audit {json.dumps(r['audit'])}; caught by {r['caught_by']}")
    check(recipe["loss_rel"] <= BF16_LOSS_BAR, f"T bf16 step loss {recipe['loss_rel']:.3e} from "
          f"the eager blocks' bf16 step, bar {BF16_LOSS_BAR}")
    check(recipe["grad_distance"] <= recipe["bar"], f"T bf16 step gradients "
          f"{recipe['grad_distance']:.3e} from the eager blocks' bf16 step, bar "
          f"{recipe['bar']:.3e}")
    check(not bf16_audit_failures(audit), f"the T bf16 step breaks its recipe: {audit}")
    check(all(r["caught_by"] for r in planted.values()), "planted bf16 faults passed every "
          "bar: " + ", ".join(f for f, r in planted.items() if not r["caught_by"]))
    return {"rules": rules, "recipe": recipe, "bf16_audit": audit, "bf16_planted": planted,
            "profile": profiled_audio_step(trainer, pcm, labels, margin, smi)}


def tdnn_bn_act_phase(peaks, smi: str) -> dict:
    """Phase 22: T against its plain versions and the eager ops at the
    cells' shapes (bf16 train, f32 eval), bit-equal on reruns and CUDA-graph
    replays, times beside its bound; its launches and strides on the audio
    paths; and phase 11's step rule, audit and planted faults for it."""
    train = [tdnn_train_check(s, peaks, 2200 + i) for i, s in enumerate(TDNN_SHAPES)]
    evals = [tdnn_eval_check(s, peaks, 2210 + i) for i, s in enumerate(TDNN_SHAPES)]
    for r in train + evals:
        log(f"T {r['shape']} {r['dtype']}: " + json.dumps(
            {k: v for k, v in r.items() if k not in ("shape", "dtype")}) + f" [{smi}]")
    replay = tdnn_replay_equal()
    check(replay, "T: a CUDA-graph replay differs from the eager calls")
    refused = []
    for x, error in ((torch.zeros((2, 8, 5), device="cuda", dtype=torch.float64), TypeError),
                     (torch.zeros((2, 5, 8), device="cuda").transpose(1, 2), ValueError)):
        try:
            tdnn_bn_act.tdnn_bn_act_forward(x, torch.zeros(8, device="cuda"),
                                            torch.ones(8, device="cuda"),
                                            torch.zeros(8, device="cuda"))
        except error:
            refused.append(True)
    check(refused == [True, True], "T took a float64 or a non-contiguous activation")
    release()
    pcm, labels = harmonic_train_batch(2232)
    with tempfile.TemporaryDirectory() as root:
        trainer = AudioTrainer(group_audio_config("bf16"), n_spk=TRAIN_SPEAKERS,
                               exp_root=os.path.join(root, "exp"), log_time="tdnn")
        route = tdnn_route_check(trainer, pcm, labels)
        log(f"T launches {route['launches']}; block strides {route['strides']} [{smi}]")
        step = tdnn_step_check(trainer, pcm, labels, smi)
        del trainer
    release()
    return {"train": train, "eval": evals, "graph_replay_bit_equal": replay, "route": route,
            "step": step}


def tdnn_bn_act_only() -> int:
    """``--tdnn-bn-act``: phases 1, 2 and 22 alone, one JSON line."""
    dev = device_phase()
    _, peaks = card_peaks(dev["name"])
    build_phase()
    out = tdnn_bn_act_phase(peaks, dev["smi"])
    print(json.dumps({"card": dev["smi"], "tdnn_bn_act": out}), flush=True)
    return 0


# ---------------------------------------------------------------- phase 23
# The eval apply's sites in a fusion step: (frames, H, W, C) of the frozen
# Lipreading frame path over 60 items x 2 clip slots x 32 frames at crop 88,
# and how many sites of each form a step has at that shape
EVAL_FRAMES = 60 * 2 * 32
EVAL_SITES = [((EVAL_FRAMES, 44, 44, 64), {"plain": 1}),
              ((EVAL_FRAMES, 22, 22, 64), {"plain": 2, "identity": 2}),
              ((EVAL_FRAMES, 11, 11, 128), {"plain": 2, "identity": 1, "bn_residual": 1}),
              ((EVAL_FRAMES, 6, 6, 256), {"plain": 2, "identity": 1, "bn_residual": 1}),
              ((EVAL_FRAMES, 3, 3, 512), {"plain": 2, "identity": 1, "bn_residual": 1})]
# |x| multiples of the least traffic: each input read once, y written once
EVAL_BYTES = {"plain": 2, "identity": 3, "bn_residual": 3}


def video_eval_launches(trunk_layers=(2, 2, 2, 2)) -> int:
    """The eval apply's launches in an eval ``frame_features`` call of a
    PReLU ResNet Lipreading: the frontend site and two a block."""
    return 1 + 2 * sum(trunk_layers)


VIDEO_EVAL_LAUNCHES = video_eval_launches()   # ResNet-18
EVAL_BOUND_SHARE = 0.70           # the frontend site's least share of its bound
EVAL_REPLAY_SHAPE = (64, 11, 11, 128)


def eval_site(shape, form: str, dtype, seed: int) -> tuple:
    """Seeded ``(x, residual, bn, residual_bn, act)`` of one eval site on the
    card: activations with a per-channel spread, eval-mode BNs with random
    running statistics and affine parameters, a PReLU with random slopes;
    ``residual`` and ``residual_bn`` are None below their form."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    rand = lambda: torch.rand(c, generator=g, device="cuda")

    def act_in():
        return (torch.randn(shape, generator=g, device="cuda") * (0.5 + 2 * rand())).to(dtype)

    def bn():
        m = TorchBatchNorm(c).cuda().eval()
        with torch.no_grad():
            m.weight.copy_(0.5 + rand())
            m.bias.copy_(rand() - 0.5)
            m.running_mean.copy_(rand() - 0.5)
            m.running_var.copy_(0.5 + 2 * rand())
        return m

    act = PReLU(c).cuda()
    with torch.no_grad():
        act.weight.copy_(0.1 + 0.3 * rand())
    x, norm = act_in(), bn()
    residual = None if form == "plain" else act_in()
    return x, residual, norm, bn() if form == "bn_residual" else None, act


def eval_apply(x, residual, bn, residual_bn, act) -> torch.Tensor:
    return bn_prelu.bn_prelu_eval(x, eval_bn(bn), act.weight, residual,
                                  None if residual_bn is None else eval_bn(residual_bn))


def eval_eager(x, residual, bn, residual_bn, act) -> torch.Tensor:
    """The eager modules the eval apply replaces: the library yardstick."""
    z = bn(x)
    if residual is not None:
        z = z + (residual if residual_bn is None else residual_bn(residual))
    return act(z)


def bn_prelu_eval_check(shape, form: str, dtype, peaks, seed: int) -> dict:
    """The eval apply at one site against the eager modules (bit-equal),
    bit-equal on a rerun, and timed beside them and its byte bound."""
    site = eval_site(shape, form, dtype, seed)
    what = f"eval apply {shape} {form} {str(dtype)[6:]}"
    with torch.no_grad():
        y, again, ye = eval_apply(*site), eval_apply(*site), eval_eager(*site)
        row = {"shape": list(shape), "form": form, "dtype": str(dtype)[6:],
               "bit_equal_eager": bit_equal(y, ye)}
        check(bit_equal(y, again), f"{what}: not bit-equal on a rerun")
        check(row["bit_equal_eager"], f"{what}: {rel_max(y, ye):.3e} from the eager modules")
        del y, again, ye
        row.update(ms=time_ms(lambda: eval_apply(*site)),
                   eager_ms=time_ms(lambda: eval_eager(*site), iters=5),
                   bound_ms=EVAL_BYTES[form] * math.prod(shape) * site[0].element_size()
                   / peaks[2] * 1e3)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    del site
    torch.cuda.empty_cache()
    return row


def eval_replay_equal() -> bool:
    """The three forms in f32 and bf16 captured in one CUDA graph and
    replayed twice: bit-equal to the same calls run eagerly."""
    sites = [eval_site(EVAL_REPLAY_SHAPE, form, dtype, 2300 + i)
             for i, (form, dtype) in enumerate(itertools.product(
                 ("plain", "identity", "bn_residual"), (torch.float32, torch.bfloat16)))]

    def calls():
        return [eval_apply(*site) for site in sites]

    with torch.no_grad():
        want = calls()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            calls()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = calls()
    equal = []
    for _ in range(2):
        for o in out:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        equal.append(all(bit_equal(o, w) for o, w in zip(out, want)))
    del graph
    return all(equal)


def randomised_bns(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random running statistics, affine parameters and PReLU slopes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TorchBatchNorm):
                c = m.weight.shape[0]
                m.weight.copy_(0.5 + torch.rand(c, generator=g, device="cuda"))
                m.bias.copy_(torch.rand(c, generator=g, device="cuda") - 0.5)
                m.running_mean.copy_(torch.rand(c, generator=g, device="cuda") - 0.5)
                m.running_var.copy_(0.5 + torch.rand(c, generator=g, device="cuda"))
            elif isinstance(m, PReLU):
                m.weight.copy_(0.1 + 0.3 * torch.rand(m.weight.shape, generator=g,
                                                      device="cuda"))
    return module


def eval_route_check() -> dict:
    """The eval apply's launches on the model paths: an eval
    ``frame_features`` call of the ResNet-18 Lipreading (bit-equal to the
    eager trunk's), its train step, and an eval call of the audio ResNet."""
    net = randomised_bns(Lipreading(num_classes=57).cuda(), 2320)
    clips = torch.rand((2, 8, 88, 88, 1), generator=torch.Generator(device="cuda")
                       .manual_seed(2321), device="cuda")
    launches = {}
    with torch.no_grad(), fp32_math():
        before = launch_counts()
        got = net.eval().frame_features(clips)
        launches["eval_frame_features"] = launches_since(before, ("bn_prelu_eval",))
        kernel_takes = resnet_model.eval_kernel_takes
        resnet_model.eval_kernel_takes = lambda *args: False
        try:
            want = net.frame_features(clips)
        finally:
            resnet_model.eval_kernel_takes = kernel_takes
        audio = randomised_bns(AudioResNet().cuda(), 2322).eval()
        before = launch_counts()
        audio.extract_embedding(torch.randn((4, 200, 24), device="cuda"))
        launches["audio_resnet_eval"] = launches_since(before, ("bn_prelu_eval",))
    before = launch_counts()
    net.train().frame_features(clips).square().mean().backward()
    launches["train_step"] = launches_since(before, ("bn_prelu_eval",))
    check(bit_equal(got, want), "an eval frame_features call through the eval apply is "
          f"{rel_max(got, want):.3e} from the eager trunk")
    want_launches = {"eval_frame_features": {"bn_prelu_eval": VIDEO_EVAL_LAUNCHES},
                     "audio_resnet_eval": {"bn_prelu_eval": 0},
                     "train_step": {"bn_prelu_eval": 0}}
    check(launches == want_launches, f"eval apply launches {launches}, expected {want_launches}")
    del net, audio
    torch.cuda.empty_cache()
    return {k: v["bn_prelu_eval"] for k, v in launches.items()}


def bn_prelu_eval_phase(peaks, smi: str) -> dict:
    """Phase 23: the eval apply at the fusion step's sites, its graph replay,
    what it refuses, and its route."""
    rows = [bn_prelu_eval_check(shape, form, dtype, peaks, 2310 + i)
            for i, (dtype, (shape, forms)) in enumerate(
                itertools.product((torch.float32, torch.bfloat16), EVAL_SITES))
            for form in forms]
    for r in rows:
        log(f"eval apply {r['shape']} {r['form']} {r['dtype']}: " + json.dumps(
            {k: v for k, v in r.items() if k not in ("shape", "form", "dtype")}) + f" [{smi}]")
    front = rows[0]
    check(front["share_of_bound"] >= EVAL_BOUND_SHARE,
          f"the eval apply at the frontend site reads {front['share_of_bound']:.1%} of its "
          f"bound, bar {EVAL_BOUND_SHARE:.0%}")
    step = {}
    for dtype in ("float32", "bfloat16"):
        counts = {(tuple(shape), form): n for shape, forms in EVAL_SITES
                  for form, n in forms.items()}
        step[dtype] = {key: sum(counts[(tuple(r["shape"]), r["form"])] * r[key] for r in rows
                                if r["dtype"] == dtype) for key in ("ms", "eager_ms", "bound_ms")}
    check(sum(sum(f.values()) for _, f in EVAL_SITES) == VIDEO_EVAL_LAUNCHES,
          "the fusion step's sites do not add up to a frame_features call's")
    replay = eval_replay_equal()
    check(replay, "eval apply: a CUDA-graph replay differs from the eager calls")
    refused = []
    for x, error in ((torch.zeros((4, 8), device="cuda").t(), ValueError),
                     (torch.zeros((4, 6), device="cuda"), ValueError),
                     (torch.zeros((4, 8), device="cuda", dtype=torch.float16), TypeError)):
        p = torch.ones(x.shape[-1], device="cuda")
        try:
            bn_prelu.bn_prelu_eval(x, bn_prelu.EvalBN(p, p, p, p, 1e-5), p)
        except error:
            refused.append(True)
    check(refused == [True] * 3,
          "the eval apply took a non-contiguous, a C = 6 or an fp16 activation")
    route = eval_route_check()
    log(f"eval apply, a fusion step's 17 sites (ms): {json.dumps(step)}; graph replay "
        f"bit-equal {replay}; launches {route} [{smi}]")
    release()
    return {"sites": rows, "fusion_step_ms": step, "graph_replay_bit_equal": replay,
            "launches": route}


def bn_prelu_eval_only() -> int:
    """``--bn-prelu-eval``: phases 1, 2 and 23 alone, one JSON line."""
    dev = device_phase()
    _, peaks = card_peaks(dev["name"])
    build_phase()
    out = bn_prelu_eval_phase(peaks, dev["smi"])
    print(json.dumps({"card": dev["smi"], "bn_prelu_eval": out}), flush=True)
    return 0


# ---------------------------------------------------------------- phase 7
VIDEO_SPEAKERS, VIDEO_CLIPS, VIDEO_BATCH = 32, 8, 128


def video_config() -> dict:
    with open(os.path.join(REPO, "conf", "video_config.json")) as fh:
        return json.load(fh)


def speaker_clip(rng, spk: int, t: int) -> np.ndarray:
    """``(t, 96, 96)`` uint8: a grating at the speaker's spatial frequency
    and orientation that drifts at the speaker's rate, plus noise."""
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float32) / 96.0
    freq, theta, rate = 2.0 + 0.25 * spk, np.pi * spk / VIDEO_SPEAKERS, 0.05 + 0.01 * spk
    plane = freq * (np.cos(theta) * xx + np.sin(theta) * yy)
    phase = rate * np.arange(t, dtype=np.float32)[:, None, None] + rng.random()
    frames = 128 + 80 * np.sin(2 * np.pi * (plane[None] + phase))
    frames += rng.normal(0, 12, frames.shape)
    return np.clip(frames, 0, 255).astype(np.uint8)


def write_clip_corpus(root: str, seed: int = 0) -> None:
    """32 speakers x 8 clips of 21-29 frames (:func:`speaker_clip`)."""
    rng = np.random.default_rng(seed)
    for spk in range(VIDEO_SPEAKERS):
        os.makedirs(os.path.join(root, f"s{spk:02d}"), exist_ok=True)
        for c in range(VIDEO_CLIPS):
            np.savez(os.path.join(root, f"s{spk:02d}", f"c{c}.npz"),
                     data=speaker_clip(rng, spk, int(rng.integers(21, 30))))


def full_clip_batch(clips) -> dict:
    """One bs 128 x 29-frame batch of the corpus: four clips of each
    speaker, zero-padded to 29 frames, with their lengths and labels."""
    chosen = [c for c in clips if int(c.name[-1]) < VIDEO_BATCH // VIDEO_SPEAKERS]
    batch = {"clips": np.zeros((len(chosen), 29, 96, 96), np.uint8),
             "lengths": np.zeros(len(chosen), np.int32),
             "labels": np.array([c.label for c in chosen], np.int64)}
    for row, clip in enumerate(chosen):
        data = load_clip(clip.path)
        batch["clips"][row, :len(data)] = data
        batch["lengths"][row] = len(data)
    check(len(chosen) == VIDEO_BATCH, f"{len(chosen)} clips in the full batch")
    return batch


@contextlib.contextmanager
def recording_bn_calls(record: list):
    """Append ``(shape, dtype, mean, var)`` of every call of the fused
    BN+PReLU op (through K3 or whatever stands in for it) to ``record``."""
    inner = bn_prelu.bn_prelu_train

    def recorded(x, *args):
        y, mean, var = inner(x, *args)
        record.append((tuple(x.shape), x.dtype, mean.clone(), var.clone()))
        return y, mean, var

    bn_prelu.bn_prelu_train = recorded
    try:
        yield
    finally:
        bn_prelu.bn_prelu_train = inner


def bn_prelu_path_check(seen: set) -> dict:
    """K3/K4 against their plain versions at every shape the main path gave
    them (the bars of phase 6). Returns the largest y and dx errors."""
    worst = {"y": 0.0, "dx": 0.0}
    with fp32_math():
        for i, (shape, dtype) in enumerate(sorted(seen, key=str)):
            inputs = bn_inputs(shape, dtype, 200 + i)
            err, _ = bn_prelu_check(*inputs, 1e-5, f"bn_prelu main-path {shape} "
                                                   f"{str(dtype)[6:]}")
            worst = {k: max(v, err[k]) for k, v in worst.items()}
            del inputs
            torch.cuda.empty_cache()
    return worst


def video_main_path_phase() -> dict:
    with tempfile.TemporaryDirectory() as root:
        write_clip_corpus(os.path.join(root, "clips"))
        clips = scan_clip_dir(os.path.join(root, "clips"))
        check(len(clips) == VIDEO_SPEAKERS * VIDEO_CLIPS, f"{len(clips)} clips scanned")
        trainer = VideoTrainer(video_config(), num_classes=VIDEO_SPEAKERS,
                               exp_root=os.path.join(root, "exp"))
        batches = VideoClipBatches(clips, batch_size=VIDEO_BATCH, bucket_t=8, seed=0)
        shapes = [b["clips"].shape for b in batches.epoch(1)]

        calls: list = []
        with recording_bn_calls(calls):
            before = launch_counts()
            t0 = time.perf_counter()
            losses = trainer.train(batches, epochs=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launches_since(before, VIDEO)

        check(len(losses) == len(shapes) == trainer.step, f"{len(losses)} losses for "
              f"{len(shapes)} batches, step {trainer.step}")
        check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
        per_step = 3 * 9  # partial, finalize, apply at each of the nine sites
        for name, n in launches.items():
            # the max-pool: one forward and one backward kernel per step
            want = per_step if name.startswith("bn_prelu") else 1
            check(n == want * len(losses), f"{name}: {n} launches for {len(losses)} "
                  f"steps, {want} expected per step")
        check(os.path.exists(os.path.join(trainer.exp_dir, "net_1")), "no net_1 checkpoint")
        # the kernels saw the sites' shapes of each bucketed batch, and hold
        # against their plain versions at every one of them
        check(len(calls) == 9 * len(losses), f"{len(calls)} fused BN+PReLU calls for "
              f"{len(losses)} steps")
        seen = {(shape, dtype) for shape, dtype, _, _ in calls}
        want = {(s, torch.float32) for b in shapes for s, _ in bn_site_shapes(b[0], b[1])}
        check(seen == want, f"the main path gave K3 the shapes {sorted(seen, key=str)}, "
              f"expected {sorted(want, key=str)}")
        path_err = bn_prelu_path_check(seen)

        full_batch = full_clip_batch(clips)
        eval_batches = VideoClipBatches(clips, batch_size=VIDEO_BATCH, bucket_t=8,
                                        shuffle=False, pre_crop=(88, 88))
        t0 = time.perf_counter()
        emb = trainer.extract_clip_embeddings(eval_batches)
        torch.cuda.synchronize()
        emb_wall = time.perf_counter() - t0
    check(len(emb) == len(clips), f"{len(emb)} embeddings for {len(clips)} clips")
    mat = torch.stack(list(emb.values()))
    check(mat.device.type == "cuda" and tuple(mat.shape[1:]) == (512,),
          f"embeddings {tuple(mat.shape)} on {mat.device}")
    check(bool(torch.isfinite(mat).all()), "non-finite clip embeddings")
    log(f"video main path: {len(clips)} clips, batches {shapes}, losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; launches {launches} "
        f"(BN+PReLU {per_step}, max-pool 1 per step and pass); train {wall:.2f} s wall incl. header scan, "
        f"decode and cuDNN's first calls; K3/K4 vs plain at its {len(seen)} site shapes: "
        f"max err y {path_err['y']:.2e}, dx {path_err['dx']:.2e}; {len(emb)} embeddings {tuple(mat.shape[1:])} in "
        f"{emb_wall:.2f} s")
    return {"trainer": trainer, "full_batch": full_batch, "launches": launches, "losses": losses,
            "path_err": path_err, "batches": [list(b) for b in shapes]}


# ---------------------------------------------------------------- phase 8
# device kernels by kind, first match wins: the six kernels of
# csrc/bn_prelu_kernel.cu and the two of csrc/maxpool_kernel.cu as the
# profiler names them, cuDNN/cuBLAS (the
# convolutions, the TCN and the classifier), Adam, the rest of PyTorch's own
KERNEL_KINDS = [
    ("K3/K4 (bn_prelu_kernel.cu)", re.compile(
        r"::(stats_partial|stats_finalize|stats_totals|stats_from_totals|apply|bwd_partial|"
        r"bwd_finalize|bwd_totals|bwd_from_totals|bwd_apply)_kernel\b")),
    ("max-pool (maxpool_kernel.cu)", re.compile(r"::maxpool_(fwd|bwd)_kernel\b")),
    ("cuDNN/cuBLAS", re.compile(r"cudnn|xmma|cublas|gemm|wgrad|dgrad|fprop|fft", re.I)),
    ("Adam", re.compile(r"multi_tensor_apply|adam", re.I)),
    ("other PyTorch", re.compile(r"")),
]
def plain_bn_prelu_forward(x, scale, bias, alpha, eps, group=None):
    y, mean, var = bn_prelu.bn_prelu_reference(x, scale, bias, alpha, eps, group)
    return y, mean, var, torch.rsqrt(var + eps)


def faulty_bn_prelu_forward(fault):
    """A K3 with a planted fault, for the step bars to catch: the plain
    forward with the batch variance scaled by ``1 + fault``, or, for
    ``fault == "bf16"``, with the mean and variance held in bf16."""
    def forward(x, scale, bias, alpha, eps, group=None):
        _, mean, var = bn_prelu.bn_prelu_reference(x, scale, bias, alpha, eps, group)
        if fault == "bf16":
            mean, var = mean.bfloat16().float(), var.bfloat16().float()
        else:
            var = var * (1.0 + fault)
        inv = torch.rsqrt(var + eps)
        z = ((x - mean) * inv) * scale + bias
        return torch.where(z >= 0, z, alpha * z), mean, var, inv
    return forward


@contextlib.contextmanager
def plain_bn_prelu(forward=plain_bn_prelu_forward,
                   backward=bn_prelu.bn_prelu_backward_reference):
    """Route the fused BN+PReLU op's forward (K3) and backward (K4) through
    the given functions, by default their plain versions, on the same
    device and inside the same autograd op; ``None`` keeps that kernel."""
    kernels = bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward
    bn_prelu.bn_prelu_forward = forward or kernels[0]
    bn_prelu.bn_prelu_backward = backward or kernels[1]
    try:
        yield
    finally:
        bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward = kernels


@contextlib.contextmanager
def plain_maxpool():
    """Route the frontend max-pool through its plain version
    (``F.max_pool3d`` and its autograd) on the same device."""
    kernel = maxpool.maxpool_frontend
    maxpool.maxpool_frontend = maxpool.maxpool_frontend_reference
    try:
        yield
    finally:
        maxpool.maxpool_frontend = kernel


STEP_LOSS_RTOL = 1e-5
STEP_STAT_RTOL = 1e-5  # every site's batch mean (in sigmas) and variance (relative)
NUDGE = 1e-6           # relative nudge of the input frames: the plain path's own sensitivity
NUDGE_FACTOR = 3.0     # the kernel path may move the gradients this many times as far
K4_GRAD_RTOL = 1e-4    # K4 alone (same forward): gradient norm, relative
# planted K3 faults: the batch variance off by this much (relative), or the
# statistics held in bf16. 1e-5 equals the statistics bar of phase 6 and of
# the step, so it and 1e-6 are reported only; the others must be rejected
PLANTED_FAULTS = (1e-6, 1e-5, 1e-4, "bf16")
MUST_CATCH = (1e-4, "bf16")


def grad_distance(a: dict, b: dict) -> float:
    """``|a - b| / |b|`` over every gradient of the network at once."""
    num = sum(float(((a[n] - b[n]).double() ** 2).sum()) for n in b)
    return math.sqrt(num / sum(float((v.double() ** 2).sum()) for v in b.values()))


def stat_distance(a: list, b: list, sites: int = 9) -> tuple[float, int]:
    """The largest gap between two steps' batch statistics at the fused
    sites, in forward order: a mean's in units of ``b``'s standard
    deviation, a variance's relative to ``b``'s. Returns it and its site."""
    check(len(a) == len(b) == sites,
          f"{len(a)} and {len(b)} fused sites recorded, {sites} expected")
    return max((max(float(((ma - mb).abs() / vb.sqrt()).max()),
                    float(((va - vb).abs() / vb).max())), site)
               for site, ((_, _, ma, va), (_, _, mb, vb)) in enumerate(zip(a, b)))


def worst_tensor(a: dict, b: dict) -> tuple[float, str]:
    """The largest ``max|a - b|`` of a tensor over its ``max|b|``, among the
    tensors whose gradient is not zero in exact arithmetic (the biases of
    the TCN convolutions feeding a train-mode BN hold rounding noise below
    1e-3 of the network's largest gradient)."""
    top = max(float(v.abs().max()) for v in b.values())
    return max((float((a[n] - b[n]).abs().max()) / float(b[n].abs().max()), n)
               for n in b if float(b[n].abs().max()) >= 1e-3 * top)


def video_step_phase(trainer: VideoTrainer, batch: dict, bn: dict) -> dict:
    clips, lengths, labels = (torch.from_numpy(batch[k]).cuda()
                              for k in ("clips", "lengths", "labels"))
    x = V.train_transform(clips, torch.Generator().manual_seed(1))[..., None]
    x = V.mask_pad_frames(x, lengths)
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)

    def step(frames):
        """One step from ``state``: its loss, gradients and batch statistics
        at the fused sites; the state is restored after it."""
        torch.manual_seed(0)   # the same dropout masks in every run
        stats: list = []
        with recording_bn_calls(stats):
            loss = float(trainer.train_step_frames(frames, lengths, labels)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
        trainer.model.load_state_dict(state[0])
        trainer.optimizer.load_state_dict(state[1])
        trainer.step = state[2]
        return loss, grads, stats

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        before = launch_counts()
        loss_k, grads_k, stats_k = step(x)
        video = launches_since(before, VIDEO)
        check(video == {"bn_prelu_fwd": 27, "bn_prelu_bwd": 27, "maxpool_fwd": 1,
                        "maxpool_bwd": 1},
              f"kernel step launched {video}: 27 BN+PReLU and 1 max-pool kernel "
              "expected per pass")
        before = launch_counts()
        # every other step of this phase pools through the plain version, so
        # that its bars measure K3 and K4 alone; the pool's forward is exact
        # and its backward is held in phase 9
        with plain_maxpool():
            with plain_bn_prelu():
                loss_p, grads_p, stats_p = step(x)
                loss_n, grads_n, stats_n = step(x * (1.0 + NUDGE))
            check(not any(launches_since(before, VIDEO).values()),
                  "the plain steps launched the kernels")
            # K4 alone: both runs of this comparison see bit-equal activations
            with plain_bn_prelu(backward=None):
                loss_h, grads_h, _ = step(x)
            # The step's gradients are sums that cancel: a 1e-6 relative nudge
            # of the input frames moves the plain path's own gradients by ~1e-3
            # of their norm. The kernel path's gradients are held to that
            # sensitivity, measured in this run; its forward, through the batch
            # statistics of every fused site (averages, which do not cancel), to
            # a fixed bar; K4 alone, on bit-equal activations, to a fixed bar.
            # Planted K3 faults show what the bars reject.
            d_np = grad_distance(grads_n, grads_p)
            planted = {}
            for fault in PLANTED_FAULTS:
                with plain_bn_prelu(forward=faulty_bn_prelu_forward(fault)):
                    loss_f, grads_f, stats_f = step(x)
                rel, dist = abs(loss_f - loss_p) / abs(loss_p), grad_distance(grads_f, grads_p)
                stat = stat_distance(stats_f, stats_p)[0]
                planted[str(fault)] = {
                    "loss_rel": rel, "grad_distance": dist, "nudge_ratio": dist / d_np,
                    "stat_distance": stat,
                    "caught_by": [name for name, hit in (
                        ("loss", rel > STEP_LOSS_RTOL), ("gradients", dist > NUDGE_FACTOR * d_np),
                        ("statistics", stat > STEP_STAT_RTOL)) if hit]}
                del grads_f
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    d_kp, d_hp = (grad_distance(g, grads_p) for g in (grads_k, grads_h))
    (s_kp, s_site), s_np = stat_distance(stats_k, stats_p), stat_distance(stats_n, stats_p)[0]
    worst = {k: worst_tensor(g, grads_p) for k, g in (("kernel", grads_k), ("nudge", grads_n),
                                                       ("k4", grads_h))}
    log(f"kernel vs plain step at bs {VIDEO_BATCH} x 29 (corpus clips, speaker labels): loss "
        f"{loss_k:.8f} vs {loss_p:.8f} ({loss_rel:.2e} relative; nudged input {loss_n:.8f}, "
        f"K4 alone {loss_h:.8f}); batch statistics of the fused sites: kernel path "
        f"{s_kp:.2e} from the plain path (site {s_site}; bar {STEP_STAT_RTOL}), nudged input "
        f"{s_np:.2e}; gradient distance from the plain path: kernel path "
        f"{d_kp:.3e}, plain path with the input nudged by {NUDGE} {d_np:.3e} (ratio "
        f"{d_kp / d_np:.2f}, bar {NUDGE_FACTOR}), K4 alone {d_hp:.3e} (bar {K4_GRAD_RTOL}); "
        "worst tensor, of its plain largest: " + ", ".join(
            f"{k} {v:.2e} ({n})" for k, (v, n) in worst.items()))
    log("planted K3 faults against the step bars (loss relative, statistics, gradient "
        "distance, its ratio to the nudge's): " + "; ".join(
            f"{k}: {v['loss_rel']:.2e}, {v['stat_distance']:.2e}, {v['grad_distance']:.3e}, "
            f"{v['nudge_ratio']:.2f} (caught by {', '.join(v['caught_by']) or 'none'})"
            for k, v in planted.items()))
    del grads_k, grads_p, grads_n, grads_h, x
    check(loss_rel <= STEP_LOSS_RTOL, f"kernel-path loss {loss_k} vs plain {loss_p}: "
          f"{loss_rel:.3e} relative, bar {STEP_LOSS_RTOL}")
    check(s_kp <= STEP_STAT_RTOL, f"kernel-path batch statistics {s_kp:.3e} from the plain "
          f"path's at site {s_site}, bar {STEP_STAT_RTOL}")
    check(d_kp <= NUDGE_FACTOR * d_np, f"kernel-path gradients {d_kp:.3e} of the plain norm "
          f"from the plain path; a {NUDGE} nudge of the input moves them {d_np:.3e}; bar "
          f"{NUDGE_FACTOR} x that")
    check(d_hp <= K4_GRAD_RTOL, f"K4 alone: gradients {d_hp:.3e} of the plain norm from "
          f"the plain path, bar {K4_GRAD_RTOL}")
    for fault in MUST_CATCH:
        check(planted[str(fault)]["caught_by"], f"a planted K3 fault ({fault}) passed the "
              "step bars")

    gen = torch.Generator().manual_seed(2)
    for _ in range(2):
        trainer.train_step(clips, lengths, labels, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        trainer.train_step(clips, lengths, labels, gen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sorted(walls)[2]
    kernel_ms = bn["per_step"]["fwd"] + bn["per_step"]["bwd"]
    log(f"video train step at bs {VIDEO_BATCH} x 29 (FP32): {step_ms:.1f} ms median of 5 "
        f"({', '.join(f'{w:.1f}' for w in walls)}), {VIDEO_BATCH / step_ms * 1e3:.1f} clips/s, "
        f"peak {peak_gb:.1f} GB; K3+K4 at their measured times {kernel_ms:.3f} ms = "
        f"{kernel_ms / step_ms:.1%} of the step")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        trainer.train_step(clips, lengths, labels, gen)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels, layers = {}, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
            kind = next(k for k, pat in KERNEL_KINDS if pat.search(ev.key))
            layers[kind] = layers.get(kind, 0.0) + dev_us / 1e3
    # device time of each convolution call, forward and backward, by shape
    convs = sorted(((getattr(ev, "device_time_total", 0) / 1e3, ev.key, ev.input_shapes[:2])
                    for ev in prof.key_averages(group_by_input_shape=True)
                    if ev.key in ("aten::cudnn_convolution", "aten::convolution_backward")),
                   key=lambda t: -t[0])[:8]
    busy = sum(kernels.values())
    ours = layers.get("K3/K4 (bn_prelu_kernel.cu)", 0.0)
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    if busy > 0:
        log(f"profiled step: {prof_wall:.1f} ms wall, {busy:.1f} ms of device kernels "
            f"({busy / prof_wall:.1%} busy, {1 - busy / prof_wall:.1%} idle), K3+K4 {ours:.3f} ms "
            f"({ours / busy:.1%} of device time); by kind: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in sorted(layers.items(), key=lambda kv: -kv[1])))
        log("  top kernels:")
        for name, ms in top_k:
            log(f"  {ms:9.3f} ms  {name[:150]}")
        log("  top convolution calls (device time incl. their kernels; input shapes):")
        for ms, name, shapes in convs:
            log(f"  {ms:9.3f} ms  {name} {shapes}")
    else:
        log("profiled step: the profiler saw no device time (not measured)")
    return {"step_ms": step_ms, "step_walls": walls, "clips_per_sec": VIDEO_BATCH / step_ms * 1e3,
            "kernel_share": kernel_ms / step_ms, "peak_gb": peak_gb, "loss_rel": loss_rel,
            "stat_distance": s_kp, "grad_distance": d_kp, "nudge_distance": d_np,
            "k4_distance": d_hp,
            "planted_faults": planted, "worst_tensor": {k: list(v) for k, v in worst.items()}, "profiled_busy_ms": busy,
            "profiled_wall_ms": prof_wall, "profiled_bn_prelu_ms": ours,
            "profiled_by_kind_ms": layers}


# ---------------------------------------------------------------- phase 10
AV_SPEAKERS, AV_UTTS = 32, 4     # per speaker: utterances 0-1 enrol, 2-3 probe and calibrate
AV_PART_TOL = 1e-4               # kernel-path vs plain-path parts
BATCHED_TOL = 1e-5               # an embedding served alone vs in a micro-batch


def write_av_corpus(root: str, seed: int = 0) -> dict:
    """32 speakers x 4 utterances: ``audio/sNN/uK.wav`` (1-3 s PCM16) and two
    clips ``video/sNN/uK_{0,1}.npz`` (96x96 uint8, 21-32 frames) each; a
    half-target trial list over the probe utterances (2 and 3 of each
    speaker). Returns ``{speaker: [(wav, [clip, clip]), ...]}``."""
    rng = np.random.default_rng(seed)
    items: dict = {}
    for spk in range(AV_SPEAKERS):
        name = f"s{spk:02d}"
        for sub in ("audio", "video"):
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
        for u in range(AV_UTTS):
            wav = os.path.join(root, "audio", name, f"u{u}.wav")
            write_wav(wav, speaker_wave(rng, spk), RATE)
            clips = []
            for c in range(2):
                clips.append(os.path.join(root, "video", name, f"u{u}_{c}.npz"))
                np.savez(clips[-1], data=speaker_clip(rng, spk, int(rng.integers(21, 33))))
            items.setdefault(name, []).append((wav, clips))
    probes = [f"s{spk:02d}/u{u}.wav" for spk in range(AV_SPEAKERS) for u in (2, 3)]
    with open(os.path.join(root, "trials.txt"), "w") as fh:
        for i in range(2000):
            a = int(rng.integers(len(probes)))
            b = a ^ 1 if i % 2 == 0 else int(rng.integers(len(probes)))
            fh.write(f"{int(probes[a][:3] == probes[b][:3])} {probes[a]} {probes[b]}\n")
    return items


def fusion_config(root: str, resume: dict, use_fusion_head: bool) -> str:
    """``conf/fusion_config.yaml`` with the corpus's paths in ``root``, the
    checkpoints of ``resume``, its speaker count and ``use_fusion_head``,
    written as JSON; returns its path."""
    cfg = load_fusion_config(FUSION_CONFIG_PATH).to_dict()
    cfg["data"].update(video_root=os.path.join(root, "video"),
                       test_root=os.path.join(root, "audio"),
                       trial_grid=os.path.join(root, "trials.txt"),
                       train_manifest=os.path.join(root, "no_manifest.csv"))
    cfg["train"].update(n_spk=AV_SPEAKERS, resume=resume.get("head", "None"))
    cfg["train"]["audio_config"]["resume"] = resume.get("audio", "None")
    cfg["train"]["video_config"]["resume"] = resume.get("video", "None")
    cfg["test"].update(use_fusion_head=use_fusion_head, batch_size=64)
    path = os.path.join(root, f"fusion_{'head' if use_fusion_head else 'concat'}_"
                              f"{'resumed' if resume else 'fresh'}.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


@torch.no_grad()
def calibrate_video_bn(model, clips_u8: torch.Tensor, lengths: torch.Tensor) -> None:
    """Set every BN of the frontend and trunk to the batch statistics of one
    real batch: a train-mode pass with the running averages' memory switched
    off. The model is left in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, TorchBatchNorm)]
    saved = [bn.momentum for bn in bns]
    for bn in bns:
        bn.momentum = 0.0
    with fp32_math():
        x = V.mask_pad_frames(V.eval_transform(clips_u8, (88, 88))[..., None], lengths)
        model.train().frame_features(x)
    for bn, m in zip(bns, saved):
        bn.momentum = m
    model.eval()


def prepare_av_checkpoints(root: str, items: dict, device=None) -> dict:
    """Seeded encoders and head with calibrated BN statistics, saved as the
    checkpoints that the fusion config then names."""
    cfg = load_fusion_config(fusion_config(root, {}, False))
    trainer = make_trainer(cfg, os.path.join(root, "exp"), "prep", mode="av_test",
                           device=device)
    enrol = [it for its in items.values() for it in its[:2]]
    utts = [EvalUtterance(w, w) for w, _ in enrol]
    batch = next(iter(EvalUtteranceSet(utts, **eval_set_kwargs(
        trainer.feat_cfg, {"batch_size": 64, "n_buckets": 1})).batches()))
    calibrate_bn(types.SimpleNamespace(model=trainer.audio_model, device=trainer.device,
                                       eval_feat_cfg=trainer.raw_feat_cfg), batch, seed=1)
    loaded = [load_clip(c)[:29] for _, cs in enrol[:8] for c in cs]
    clips = np.zeros((len(loaded), 29, 96, 96), np.uint8)
    for i, d in enumerate(loaded):
        clips[i, :len(d)] = d
    calibrate_video_bn(trainer.video_model, torch.from_numpy(clips).to(trainer.device),
                       torch.tensor([len(d) for d in loaded], device=trainer.device))
    return {name: ckpt.save_checkpoint(os.path.join(root, "ckpt"), f"net_{name}",
                                       {"epoch": 0, "state_dict": module.state_dict()})
            for name, module in (("audio", trainer.audio_model), ("video", trainer.video_model),
                                 ("head", trainer.fusion_head))}


@contextlib.contextmanager
def counting_calls(obj, name: str, counter: list):
    """Count the calls of ``obj.name`` in ``counter[0]``."""
    inner = getattr(obj, name)

    def counted(*args, **kw):
        counter[0] += 1
        return inner(*args, **kw)

    setattr(obj, name, counted)
    try:
        yield
    finally:
        setattr(obj, name, inner)


def median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def timed(fn):
    """``(fn(), host ms)`` with the device's work waited for."""
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def av_verifier_run(cfg_path: str, root: str, items: dict, identify: bool,
                    device=None) -> dict:
    """One ``AVSpeakerVerifier`` through calibrate, enroll, verify and
    identify; returns what it measured and the verifier."""
    v = AVSpeakerVerifier(cfg_path, exp_root=os.path.join(root, "exp"), log_time="serve",
                          device=device)
    chunks = [0]
    with counting_calls(v.trainer, "extract_pair_embedding", chunks):
        (eer, thr), cal_ms = timed(lambda: v.calibrate(os.path.join(root, "trials.txt")))
        n_cal = chunks[0]
        for spk, its in items.items():
            profile = v.enroll(spk, its[:2])
        check(isinstance(profile, np.ndarray) and abs(np.linalg.norm(profile) - 1) < 1e-5,
              "a profile is not a unit numpy vector")
        speakers = list(items)
        # the same requests twice when asked to identify too: every probe's
        # audio length is a convolution shape of its own, new to cuDNN the
        # first time and known the second
        pass_ms = []
        for _ in range(2 if identify else 1):
            results, lat = [], []
            for i, spk in enumerate(speakers):
                for claimed, probe in ((spk, items[spk][2]),
                                       (speakers[(i + 1) % len(speakers)], items[spk][3])):
                    r, ms = timed(lambda: v.verify(claimed, probe))
                    check(math.isfinite(r.score) and r.accept == (r.score >= thr),
                          f"verify({claimed}) gave {r}")
                    results.append((claimed == spk, r.score, r.accept))
                    lat.append(ms)
            pass_ms.append(median(lat))
        ranks = []
        if identify:
            for spk in speakers[:16]:
                ranks.append(v.identify(items[spk][2], top_k=3)[0][0] == spk)
            # a single-utterance profile scores its own utterance 1.0
            v.enroll("probe_self", items[speakers[0]][3])
            self_score = v.score("probe_self", items[speakers[0]][3])
            check(abs(self_score - 1.0) < 1e-5, f"self score {self_score}")
            del v.profiles["probe_self"]
    check(math.isfinite(eer) and 0.0 <= eer <= 1.0 and math.isfinite(thr),
          f"calibrate gave EER {eer}, threshold {thr}")
    dim = len(next(iter(v.profiles.values())))
    target = [s for t, s, _ in results if t]
    impostor = [s for t, s, _ in results if not t]
    return {"verifier": v, "chunks": chunks[0], "calibration_chunks": n_cal, "eer": eer,
            "threshold": thr, "dim": dim, "calibration_ms": cal_ms,
            "pairs_per_sec": 2 * AV_SPEAKERS / cal_ms * 1e3,
            "verify_ms": pass_ms[0], "verify_again_ms": pass_ms[-1] if identify else None,
            "requests": len(results) * len(pass_ms) + len(ranks),
            "target_accepts": sum(a for t, _, a in results if t) / len(target),
            "impostor_accepts": sum(a for t, _, a in results if not t) / len(impostor),
            "target_mean": float(np.mean(target)), "impostor_mean": float(np.mean(impostor)),
            "identify_top1": float(np.mean(ranks)) if ranks else None}


def microbatch_run(root: str, items: dict, audio_ckpt: str, device=None) -> dict:
    """``SpeakerVerifier`` with an AS-norm cohort: requests served directly,
    then the same requests from 16 threads through a ``MicroBatcher``."""
    cfg = Config({"data": {"python_data_config": AUDIO_DATA_OPTS}, "model": ETDNN_MODEL_OPTS,
                  "train": {"loss": "LMCL"}, "test": {"batch_size": 64}})
    v = SpeakerVerifier(cfg, checkpoint=audio_ckpt, device=device)
    passes = [0]
    before = launch_counts()
    with counting_calls(v.extractor, "embed", passes):
        v.set_cohort_files([its[3][0] for its in items.values()], top_k=20)
        eer, thr = v.calibrate(os.path.join(root, "trials.txt"), os.path.join(root, "audio"))
        for spk, its in items.items():
            v.enroll(spk, [w for w, _ in its[:2]])
        speakers = list(items)
        requests = []
        for i, spk in enumerate(speakers):
            pcm = read_wav(items[spk][2][0])[0]
            requests += [(spk, pcm), (speakers[(i + 1) % len(speakers)], pcm)]
        direct = [v.verify(spk, pcm) for spk, pcm in requests]
        # batch-1 latency with host and with device scoring, on the same 16
        # requests (their shapes now known to cuDNN), in turns
        lat, dev_gap = {"host": [], "device": []}, 0.0
        for mode in ("host", "device", "device", "host"):
            v.host_score_macs = 0 if mode == "device" else type(v).host_score_macs
            for (spk, pcm), want in list(zip(requests, direct))[:16]:
                r, ms = timed(lambda: v.verify(spk, pcm))
                lat[mode].append(ms)
                if mode == "device":
                    dev_gap = max(dev_gap, abs(r.score - want.score))
        del v.host_score_macs           # back to the class default
        # each probe served alone, at the batcher's own bucketing
        alone = {i: v.embed_pcm({"_": pcm}, set_overrides={"n_buckets": 0})["_"].cpu().numpy()
                 for i, (_, pcm) in enumerate(requests[::2])}
        with MicroBatcher(v, max_batch=32, max_wait_ms=20.0) as mb:
            with ThreadPoolExecutor(max_workers=16) as pool:
                (batched, wall_ms) = timed(lambda: list(pool.map(
                    lambda sp: mb.verify(sp[0], sp[1]), requests)))
                embedded = list(pool.map(lambda sp: mb.embed(sp[1]), requests[::2]))
            counts = {"requests": mb.n_requests, "batches": mb.n_batches, "slots": mb.n_slots,
                      "pad_slots": mb.n_pad_slots, "mean_batch_slots": mb.mean_batch_slots}
        check(not mb._thread.is_alive(), "the collector thread outlived close()")
    fb, tdnn = launches_since(before, FBANK + ("maxpool_fwd",)), launches_since(before, TDNN)
    check(fb == {"fft": passes[0], "mixed": 0, "maxpool_fwd": 0},
          f"front-end launches {fb} for {passes[0]} extraction passes")
    check(tdnn == tdnn_want(evals=passes[0]),
          f"T launches {tdnn} for {passes[0]} extraction passes")
    check(counts["batches"] < counts["requests"], f"no batch formed: {counts}")
    score_gap = max(abs(b.score - d.score) for b, d in zip(batched, direct))
    check(all(b.accept == d.accept for b, d in zip(batched, direct)),
          "a micro-batched decision differs from the direct one")
    emb_gap = max(float(np.abs(e - alone[i]).max()) for i, e in enumerate(embedded))
    check(emb_gap <= BATCHED_TOL, f"an embedding served in a batch is {emb_gap:.3e} from the "
          f"same request served alone, bar {BATCHED_TOL}")
    check(dev_gap <= 1e-4, f"device scoring {dev_gap:.3e} from host scoring")
    return {**counts, "launches": fb["fft"], "eer": eer, "threshold": thr,
            "alone_vs_batched": emb_gap, "score_gap": score_gap,
            "accepts": sum(d.accept for d in direct),
            "verify_host_ms": median(lat["host"]), "verify_device_ms": median(lat["device"]),
            "host_vs_device_score": dev_gap, "batched_wall_ms": wall_ms,
            "batched_requests_per_sec": len(requests) / wall_ms * 1e3}


def av_serving_phase(device=None) -> dict:
    """``device`` is for rehearsing the phase's control flow on the CPU at a
    small size; the card check passes none."""
    with tempfile.TemporaryDirectory() as root:
        items = write_av_corpus(root)
        resume = prepare_av_checkpoints(root, items, device)

        before = launch_counts()
        concat = av_verifier_run(fusion_config(root, resume, False), root, items, True, device)
        head = av_verifier_run(fusion_config(root, resume, True), root, items, False, device)
        fb = launches_since(before, FBANK)
        launches = {"fused_fbank": fb["fft"],
                    **launches_since(before, ("maxpool_fwd", "bn_prelu_eval"))}
        chunks = concat["chunks"] + head["chunks"]
        check(fb == {"fft": chunks, "mixed": 0} and launches["maxpool_fwd"] == chunks > 0
              and launches["bn_prelu_eval"] == VIDEO_EVAL_LAUNCHES * chunks,
              f"{launches} for {chunks} extraction chunks")
        check(concat["dim"] == 1024 and head["dim"] == 3 * 512,
              f"fused dims {concat['dim']} (concat) and {head['dim']} (head)")
        v = concat.pop("verifier")
        head.pop("verifier")
        # the loaded weights are the calibrated ones
        saved = torch.load(resume["video"], map_location=v.trainer.device,
                           weights_only=True)["state_dict"]
        check(all(torch.equal(t, saved[k]) for k, t in v.trainer.video_model.state_dict().items()),
              "the video checkpoint did not load")

        # two chunks again, through the plain versions of both kernels
        two = [(f"{spk}/{i}", w, c) for spk, its in list(items.items())[:8]
               for i, (w, c) in enumerate(its)]
        kw = dict(max_clips=2, clip_frames=32, return_parts=True)
        (k_audio, k_video), chunk_ms = timed(lambda: embed_av_items(v.trainer, two, **kw))
        with plain_front_end(), plain_maxpool():
            before = launch_counts()
            p_audio, p_video = embed_av_items(v.trainer, two, **kw)
            check(not any(launches_since(before, FBANK + ("maxpool_fwd",)).values()),
                  "the plain path launched a kernel")
        part_err = {"audio": 0.0, "video": 0.0}
        for name, _, _ in two:
            for key, k, pl in (("audio", k_audio, p_audio), ("video", k_video, p_video)):
                check(bool(torch.isfinite(k[name]).all()), f"non-finite {key} part of {name}")
                part_err[key] = max(part_err[key], float((k[name] - pl[name]).abs().max()))
        check(max(part_err.values()) <= AV_PART_TOL, f"kernel-path parts {part_err} from the "
              f"plain path's, bar {AV_PART_TOL}")

        # where a full chunk's time goes (16 items x 2 clips x 32 frames)
        tr = v.trainer
        on = dict(device=tr.device)
        clips = torch.zeros((16, 2, 32, 88, 88), dtype=torch.uint8, **on).random_(0, 256)
        lengths = torch.full((16, 2), 32, dtype=torch.int32, **on)
        sizes = torch.full((16,), 2, dtype=torch.int32, **on)
        pcm = torch.randn((16, 3 * RATE), **on) * 0.1
        t_feat = num_frames(3 * RATE, tr.feat_cfg.frame_len, tr.feat_cfg.frame_step)
        flen = torch.full((16,), t_feat, dtype=torch.int32, **on)
        slen = torch.full((16,), 3 * RATE, dtype=torch.int32, **on)
        with torch.no_grad(), fp32_math():
            x = V.mask_pad_frames(V.eval_transform(clips.reshape(32, 32, 88, 88))[..., None],
                                  lengths.reshape(32))
            conv, bn, act = tr.video_model.frontend3D
            pre_pool = act(bn(conv(x.movedim(-1, 1)).movedim(1, -1)))
            check(pre_pool.is_contiguous() and tuple(pre_pool.shape) == (32, 32, 44, 44, 64),
                  f"the serving chunk hands the pool {tuple(pre_pool.shape)} "
                  f"strides {pre_pool.stride()}")
            split = {
                "whole chunk": time_ms(lambda: tr.extract_pair_embedding(
                    pcm, flen, clips, lengths, sizes, sample_lengths=slen), iters=5),
                "video encoder": time_ms(lambda: tr._video_group_embed(clips, lengths, sizes),
                                         iters=5),
                "frontend conv+BN+PReLU": time_ms(
                    lambda: act(bn(conv(x.movedim(-1, 1)).movedim(1, -1))), iters=5),
                "max-pool kernel": time_ms(lambda: maxpool.maxpool_frontend(pre_pool)),
                "audio front-end (K1)": time_ms(lambda: F.extract_features(
                    pcm, tr.raw_feat_cfg, sample_lengths=slen)),
            }
        del clips, x, pre_pool
        mb = microbatch_run(root, items, resume["audio"], device)
    log(f"AV serving path: {chunks} extraction chunks, launches {launches}; concat: EER "
        f"{concat['eer']:.4f}, threshold {concat['threshold']:.4f}, dim {concat['dim']}, "
        f"target/impostor accepts {concat['target_accepts']:.2f}/{concat['impostor_accepts']:.2f}"
        f" (mean scores {concat['target_mean']:.3f}/{concat['impostor_mean']:.3f}), identify "
        f"top-1 {concat['identify_top1']:.2f}, batch-1 verify {concat['verify_ms']:.2f} ms "
        f"median ({concat['verify_again_ms']:.2f} ms for the same requests again), calibration sweep {concat['pairs_per_sec']:.1f} utterance pairs/s "
        f"({concat['calibration_ms']:.0f} ms incl. decode); head: EER {head['eer']:.4f}, dim "
        f"{head['dim']}, accepts {head['target_accepts']:.2f}/{head['impostor_accepts']:.2f}, "
        f"verify {head['verify_ms']:.2f} ms; kernel-path parts from the plain path's: "
        f"audio {part_err['audio']:.2e}, video {part_err['video']:.2e} (bar {AV_PART_TOL}); "
        f"two chunks of 16 in {chunk_ms:.1f} ms incl. decode")
    log("one full chunk (16 items x 2 clips x 32 frames, 3 s audio), device ms: "
        + ", ".join(f"{k} {t:.3f}" for k, t in split.items()))
    log(f"micro-batching: {mb['requests']} requests in {mb['batches']} batches "
        f"({mb['mean_batch_slots']:.1f} real slots per batch, {mb['pad_slots']} pad slots), "
        f"{mb['launches']} front-end launches; decisions equal to the direct calls' "
        f"({mb['accepts']} accepts of {len(items) * 2}), largest AS-normed score gap "
        f"{mb['score_gap']:.2e}; served alone vs in a batch: {mb['alone_vs_batched']:.3e} (bar "
        f"{BATCHED_TOL}); batch-1 verify {mb['verify_host_ms']:.2f} ms with host scoring, "
        f"{mb['verify_device_ms']:.2f} ms with device scoring (scores {mb['host_vs_device_score']:.1e}"
        f" apart); {mb['batched_requests_per_sec']:.1f} requests/s from 16 threads")
    return {"launches": launches, "chunks": chunks, "concat": concat, "head": head,
            "part_err": part_err, "chunk_split_ms": split, "microbatch": mb}


# ---------------------------------------------------------------- phase 12
FUSION_SPEAKERS, FUSION_UTTS, FUSION_EPOCHS = 64, 6, 2
# per speaker: the utterances of the trial list, beside the 6 of the
# manifest and held out of training; each has its two clips
FUSION_TEST_UTTS = (6, 7)
FUSION_NO_CLIP = 10               # every 10th training utterance has no clip
FUSION_BATCH, FUSION_CLIPS, FUSION_CLIP_FRAMES = 60, 2, 32
FUSION_STEP_LOSS_RTOL = 1e-5      # a K1 + P step vs a plain step, f32
# The bf16 fusion step audited against float64 (fusion_bf16_audit): the
# audio pooling and the video group mean in >= f32 (relative to their
# largest value), the criterion's logits in f32 (relative to their largest).
# Its loss is reported beside the f32 step's and held to be finite only:
# the head takes bf16-rounded embeddings by design, and a trained
# criterion's logits scale that rounding (6e-2 of the loss in a CPU
# rehearsal at bs 4), so the loss does not tell a sound step from a fault.
FUSION_AUDIT_BARS = {"audio_pool_err": 1e-4, "video_mean_err": 1e-4, "criterion_err": 1e-5}
FUSION_FAULTS = ("audio_pool_bf16", "video_mean_bf16", "criterion_bf16")
FUSION_KINDS = [
    ("K1 (fbank_fft_kernel.cu)", re.compile(r"fbank_fft_kernel")),
    ("max-pool (maxpool_kernel.cu)", re.compile(r"::maxpool_(fwd|bwd)_kernel\b")),
    ("optimizer (SGD)", re.compile(r"multi_tensor_apply|sgd", re.I)),
    ("cuDNN/cuBLAS", re.compile(r"cudnn|xmma|cublas|gemm|cutlass|wgrad|dgrad|fprop|conv", re.I)),
    ("other PyTorch", re.compile(r"")),
]
_MASKED_MEAN = fusion_mod._masked_mean


def write_fusion_corpus(root: str, seed: int = 0) -> tuple[str, str, dict]:
    """64 speakers x 8 PCM16 wavs of 2-5 s (``audio/sNN/uK.wav``), each with
    two 96x96 uint8 clips of 24-32 frames (``video/sNN/uK_{0,1}.npz``),
    except every ``FUSION_NO_CLIP``-th training utterance; the manifest over
    the first 6 of each speaker and a half-target trial list over the 2
    held out. Returns the manifest's and the trial list's paths and
    ``{speaker: [(wav, clips), ...]}``."""
    def speaker(spk):
        rng = np.random.default_rng((seed, spk))
        name = f"s{spk:02d}"
        for sub in ("audio", "video"):
            os.makedirs(os.path.join(root, sub, name), exist_ok=True)
        utts, items = [], []
        for u in range(FUSION_UTTS + len(FUSION_TEST_UTTS)):
            wav = os.path.join(root, "audio", name, f"u{u}.wav")
            y = training_wave(rng, spk)
            write_wav(wav, y, RATE)
            clips = []
            if u >= FUSION_UTTS or (spk * FUSION_UTTS + u) % FUSION_NO_CLIP != 3:
                for c in range(FUSION_CLIPS):
                    clips.append(os.path.join(root, "video", name, f"u{u}_{c}.npz"))
                    np.savez(clips[-1], data=speaker_clip(rng, spk, int(rng.integers(24, 33))))
            utts.append(Utterance(wav, len(y) / RATE, RATE))
            items.append((wav, clips))
        return utts[:FUSION_UTTS], items

    with ThreadPoolExecutor(8) as pool:
        done = list(pool.map(speaker, range(FUSION_SPEAKERS)))
    manifest = os.path.join(root, "manifest.csv")
    write_manifest(manifest, [utts for utts, _ in done])
    names = [f"s{spk:02d}/u{u}.wav" for spk in range(FUSION_SPEAKERS) for u in FUSION_TEST_UTTS]
    rng = np.random.default_rng(seed)
    trials = os.path.join(root, "trials.txt")
    with open(trials, "w") as fh:
        for i in range(2000):
            a = int(rng.integers(len(names)))
            b = a ^ 1 if i % 2 == 0 else int(rng.integers(len(names)))
            fh.write(f"{int(names[a][:3] == names[b][:3])} {names[a]} {names[b]}\n")
    return manifest, trials, {f"s{spk:02d}": items for spk, (_, items) in enumerate(done)}


def fusion_train_config(root: str, manifest: str, trials: str, resume: dict) -> str:
    """``conf/fusion_config.yaml`` with the corpus's paths in ``root``, the
    encoders of ``resume`` and ``FUSION_EPOCHS`` epochs, written as JSON;
    returns its path."""
    cfg = load_fusion_config(FUSION_CONFIG_PATH).to_dict()
    cfg["data"].update(train_manifest=manifest, video_root=os.path.join(root, "video"),
                       test_root=os.path.join(root, "audio"), trial_grid=trials,
                       trial_lomgrid=trials)
    cfg["train"]["epoch"] = FUSION_EPOCHS
    cfg["train"]["audio_config"]["resume"] = resume["audio"]
    cfg["train"]["video_config"]["resume"] = resume["video"]
    path = os.path.join(root, "fusion_train.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.detach().double()
    return float((got.detach().double() - want).abs().max() / want.abs().max().clamp(min=1e-30))


@contextlib.contextmanager
def fusion_bf16_audit(trainer, record: dict):
    """Hold a bf16 fusion step to its recipe, filling ``record`` with the
    worst reading of each rule: the E-TDNN blocks and the video trunk's
    blocks compute in bf16 (``blocks_bf16``); the audio statistics pooling
    is >= f32 (``audio_pool_err``: against the same pooling of its input in
    float64), so are the video clip and group means (``video_mean_err``),
    and the criterion's logits are f32 (``criterion_err``: against float64
    logits of the same input)."""
    record.update(blocks_bf16=True, audio_pool_err=0.0, video_mean_err=0.0, criterion_err=0.0)

    def block_out(mod, args, out):
        record["blocks_bf16"] &= out.dtype == torch.bfloat16

    def pool_out(mod, args, kwargs, out):
        want = type(mod).forward(mod, args[0].detach().double(), *args[1:], **kwargs)
        record["audio_pool_err"] = max(record["audio_pool_err"], _rel_err(out, want))

    def crit_out(mod, args, kwargs, out):
        emb = args[0].detach().double()
        if hasattr(mod, "fc"):
            want = emb @ mod.fc.weight.double().T + mod.fc.bias.double()
        else:
            want = _unit64(emb) @ _unit64(mod.weights).T
        record["criterion_err"] = max(record["criterion_err"], _rel_err(out[1], want))

    inner = fusion_mod._masked_mean

    def audited_mean(x, lengths):
        out = inner(x, lengths)
        record["video_mean_err"] = max(record["video_mean_err"],
                                       _rel_err(out, _MASKED_MEAN(x.detach().double(), lengths)))
        return out

    blocks = list(trainer.audio_model.tdnn) + [
        m for m in trainer.video_model.trunk.modules() if type(m).__name__ == "BasicBlock"]
    hooks = [b.register_forward_hook(block_out) for b in blocks]
    hooks.append(trainer.audio_model.pooling.register_forward_hook(pool_out, with_kwargs=True))
    hooks.append(trainer.criterion.register_forward_hook(crit_out, with_kwargs=True))
    fusion_mod._masked_mean = audited_mean
    try:
        yield record
    finally:
        fusion_mod._masked_mean = inner
        for h in hooks:
            h.remove()


def fusion_audit_failures(record: dict) -> list:
    return (["blocks_bf16"] if not record["blocks_bf16"] else []) + [
        k for k, bar in FUSION_AUDIT_BARS.items() if record[k] > bar]


@contextlib.contextmanager
def planted_fusion_fault(fault: str, trainer):
    """One way for the bf16 fusion recipe to go wrong: the audio statistics
    pooling, the video clip and group means, or the criterion in bf16."""
    pool = trainer.audio_model.pooling.forward
    mean = fusion_mod._masked_mean
    fc = getattr(trainer.criterion, "fc", None)
    if fault == "audio_pool_bf16":
        trainer.audio_model.pooling.forward = (
            lambda x, lengths=None: pool(x.bfloat16(), lengths).float())
    elif fault == "video_mean_bf16":
        fusion_mod._masked_mean = lambda x, lengths: mean(x.bfloat16(), lengths).float()
    elif fault == "criterion_bf16":
        fc.forward = lambda x: torch.nn.functional.linear(
            x.bfloat16(), fc.weight.bfloat16(), fc.bias.bfloat16()).float()
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        trainer.audio_model.pooling.__dict__.pop("forward", None)
        fusion_mod._masked_mean = mean
        if fc is not None:
            fc.__dict__.pop("forward", None)


@contextlib.contextmanager
def nudged_frames(gen: torch.Generator):
    """The video transform's frames times ``1 + NUDGE * N(0, 1)``, elementwise."""
    transform = V.eval_transform

    def nudged(clips, crop):
        x = transform(clips, crop)
        return x * (1.0 + NUDGE * torch.randn(x.shape, generator=gen, device=x.device))

    V.eval_transform = nudged
    try:
        yield
    finally:
        V.eval_transform = transform


def fusion_step_phase(trainer, root: str, smi: str, peaks) -> dict:
    """A K1 + P step against a plain step and a bf16 step (audited, with
    planted faults) from one state; then ms per step and pairs/s at bs 60 x
    200/300/400 frames in f32 and bf16, the parts' times, P at the train
    shape, peak memory and one profiled f32 step."""
    dev = trainer.device
    pipe = AVTrainPipeline(trainer.manifest, build_video_map(trainer.manifest,
                                                             os.path.join(root, "video")),
                           FUSION_BATCH, max_clips=FUSION_CLIPS, clip_frames=FUSION_CLIP_FRAMES)
    sids = next(pipe.sampler.epoch(1))[0]
    keys = ("pcm", "clips", "clip_lengths", "group_sizes", "labels")
    batches = {n: [torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in (
        pipe._assemble(sids, n, (7, n))[k] for k in keys)] for n in STEP_FRAMES}
    check(all(int((b[3] == 0).sum()) < FUSION_BATCH for b in batches.values()),
          "a timing batch has no clip at all")
    live = [(f"criterion.{n}", p) for n, p in trainer.criterion.named_parameters()] + [
        (f"head.{n}", p) for n, p in trainer.fusion_head.named_parameters()
        if any(p is q for g in trainer.optimizer.param_groups for q in g["params"])]
    state = (copy.deepcopy(trainer.fusion_head.state_dict()),
             copy.deepcopy(trainer.criterion.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step, trainer.compute_dtype)

    def restore():
        trainer.fusion_head.load_state_dict(state[0])
        trainer.criterion.load_state_dict(state[1])
        trainer.optimizer.load_state_dict(state[2])
        trainer.step, trainer.compute_dtype = state[3], state[4]

    def step(batch, dtype):
        trainer.compute_dtype = dtype
        loss = float(trainer.train_step(*batch)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in live}
        restore()
        return loss, grads

    b300 = batches[300]
    gen = torch.Generator(device=dev).manual_seed(3)
    nudged = [b300[0] * (1.0 + NUDGE * torch.randn(b300[0].shape, generator=gen, device=dev)),
              *b300[1:]]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        before = launch_counts()
        loss_k, grads_k = step(b300, None)
        counts, tdnn = launches_since(before, FBANK + VIDEO), launches_since(before, TDNN)
        check(tdnn == tdnn_want(evals=1), f"a fusion step launched T "
              f"{tdnn}: one eval apply a block of the frozen E-TDNN expected")
        check(counts == {"fft": 1, "mixed": 0, "bn_prelu_fwd": 0, "bn_prelu_bwd": 0,
                         "maxpool_fwd": 1, "maxpool_bwd": 0},
              f"a fusion step launched {counts}: one FFT-kernel and one pool-forward launch "
              "expected")
        with plain_front_end(), plain_maxpool():
            loss_p, grads_p = step(b300, None)
            with nudged_frames(torch.Generator(device=dev).manual_seed(4)):
                loss_n, grads_n = step(nudged, None)
        check(launches_since(before, FBANK + VIDEO) == counts,
              "the plain steps launched a kernel")
        audit: dict = {}
        with fusion_bf16_audit(trainer, audit):
            loss_b, _ = step(b300, torch.bfloat16)
        planted = {}
        for fault in FUSION_FAULTS:
            record: dict = {}
            with planted_fusion_fault(fault, trainer), fusion_bf16_audit(trainer, record):
                loss_f, _ = step(b300, torch.bfloat16)
            planted[fault] = {"loss_rel": abs(loss_f - loss_k) / abs(loss_k), "audit": record,
                              "caught_by": fusion_audit_failures(record)}
    loss_rel, bf16_rel = abs(loss_k - loss_p) / abs(loss_p), abs(loss_b - loss_k) / abs(loss_k)
    d_kp, d_np = grad_distance(grads_k, grads_p), grad_distance(grads_n, grads_p)
    log(f"fusion step, K1 + P vs the plain front-end and pool at bs {FUSION_BATCH} x 300 "
        f"(f32, TF32 off, cuDNN deterministic): loss {loss_k:.8f} vs {loss_p:.8f} "
        f"({loss_rel:.2e} relative, bar {FUSION_STEP_LOSS_RTOL}; nudged {loss_n:.8f}); head "
        f"and criterion gradients from the plain step's: kernels {d_kp:.3e}, plain with the "
        f"PCM and frames nudged by {NUDGE} {d_np:.3e} (ratio {d_kp / max(d_np, 1e-30):.2f}, bar "
        f"{NUDGE_FACTOR}); bf16 step loss {loss_b:.6f}, {bf16_rel:.2e} from the f32 step "
        f"audit {json.dumps(audit)} [{smi}]")
    for fault, r in planted.items():
        log(f"  planted bf16 fusion fault {fault}: loss {r['loss_rel']:.2e} from the f32 step, "
            f"audit {json.dumps(r['audit'])}; caught by {r['caught_by']}")
    check(loss_rel <= FUSION_STEP_LOSS_RTOL, f"fusion kernel-step loss {loss_k} vs plain "
          f"{loss_p}: {loss_rel:.3e} relative, bar {FUSION_STEP_LOSS_RTOL}")
    check(d_kp <= NUDGE_FACTOR * d_np, f"fusion kernel-step gradients {d_kp:.3e} from the "
          f"plain step's; the nudge moves them {d_np:.3e}; bar {NUDGE_FACTOR} x that")
    check(math.isfinite(loss_b), f"bf16 fusion step loss {loss_b}")
    check(not fusion_audit_failures(audit), f"the bf16 fusion step breaks its recipe: {audit}")
    check(all(r["caught_by"] for r in planted.values()), "planted bf16 fusion faults passed "
          "the audit: " + ", ".join(f for f, r in planted.items() if not r["caught_by"]))
    del grads_k, grads_p, grads_n

    rows = []
    torch.cuda.reset_peak_memory_stats()
    cfg = trainer.feat_cfg
    for n in STEP_FRAMES:
        batch = batches[n]
        for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
            trainer.compute_dtype = dtype
            ms = time_ms(lambda: trainer.train_step(*batch), iters=5, warmup=2)
            rows.append({"n_frames": n, "dtype": name, "step_ms": ms,
                         "pairs_per_sec": FUSION_BATCH / ms * 1e3})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    restore()
    parts = {}
    pcm, clips, lengths, sizes, _ = b300
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        with torch.no_grad(), fp32_math():
            pre = trainer.video_model
            b, g, t = clips.shape[:3]
            x = V.mask_pad_frames(V.eval_transform(
                clips.reshape((b * g, t) + clips.shape[3:]), trainer.crop_size)[..., None],
                lengths.reshape(b * g)).to(dtype or torch.float32)
            conv, bn, act = pre.frontend3D
            pre_pool = act(bn(conv_nhwc(conv, x))).contiguous()
            trainer.compute_dtype = dtype
            xv, em = trainer._audio_embed(pcm), trainer._video_group_embed(
                clips, lengths, sizes, dtype)
            p = {"K1": time_ms(lambda: audio_features(pcm.float(), cfg)),
                 "P": time_ms(lambda: maxpool.maxpool_forward(pre_pool)),
                 "P_library": time_ms(lambda: maxpool.maxpool_frontend_reference(pre_pool)),
                 "video encoder": time_ms(lambda: trainer._video_group_embed(
                     clips, lengths, sizes, dtype), iters=5),
                 "audio encoder": time_ms(lambda: trainer._audio_embed(pcm), iters=5)}
        p["head + SGD"] = time_ms(lambda: trainer.head_step(xv, em, sizes, b300[4]), iters=5)
        p.update(pool_bounds_ms(tuple(pre_pool.shape), pre_pool.element_size(), peaks))
        p["shape"] = list(pre_pool.shape)
        parts[name] = p
        del x, pre_pool, xv, em
    restore()
    for r in rows:
        log(f"fusion train step, bs {FUSION_BATCH} x {r['n_frames']} {r['dtype']}: "
            f"{r['step_ms']:.2f} ms, {r['pairs_per_sec']:.1f} pairs/s [{smi}]")
    for name, p in parts.items():
        step_ms = next(r["step_ms"] for r in rows if r["n_frames"] == 300 and r["dtype"] == name)
        log(f"fusion step parts at 300 frames, {name} (device ms, share of the {step_ms:.2f} ms "
            "step): " + ", ".join(f"{k} {v:.4f} ({v / step_ms:.1%})" for k, v in p.items()
                                 if k in ("K1", "P", "video encoder", "audio encoder",
                                          "head + SGD"))
            + f"; P at {p['shape']}: {p['P']:.4f} ms vs bound {p['fwd_bound']:.4f} ms and "
            f"F.max_pool3d {p['P_library']:.4f} ms [{smi}]")
    log(f"fusion train steps: peak {peak_gb:.2f} GB allocated [{smi}]")

    trainer.train_step(*b300)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_step(*b300)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kinds, busy = profile_kinds(prof, FUSION_KINDS)
    restore()
    if busy > 0:
        log(f"profiled f32 fusion step at bs {FUSION_BATCH} x 300: {prof_wall:.2f} ms wall, "
            f"{busy:.2f} ms of device kernels ({busy / prof_wall:.1%} busy, "
            f"{1 - busy / prof_wall:.1%} idle); by kind: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f" [{smi}]")
    else:
        log("profiled fusion step: the profiler saw no device time (not measured)")
    return {"loss_rel": loss_rel, "grad_distance": d_kp, "nudge_distance": d_np,
            "bf16_loss_rel": bf16_rel, "bf16_audit": audit, "bf16_planted": planted,
            "step_losses": {"kernel": loss_k, "plain": loss_p, "nudged": loss_n, "bf16": loss_b},
            "timings": rows, "parts_300": parts, "peak_gb": peak_gb,
            "profiled_wall_ms": prof_wall, "profiled_busy_ms": busy, "profiled_by_kind_ms": kinds}


def profile_kinds(prof, kinds_table) -> tuple[dict, float]:
    """Device time by kind (first match wins) and in all, from a profile."""
    kinds, busy = {}, 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kind = next(k for k, pat in kinds_table if pat.search(ev.key))
            kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3
            busy += dev_us / 1e3
    return kinds, busy


def fusion_train_phase(smi: str, peaks, device=None) -> dict:
    """``device`` is for rehearsing the phase on the CPU at a small size;
    the card check passes none."""
    dev_args = ["--device", device] if device else []
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        manifest, trials, items = write_fusion_corpus(root)
        corpus_s = time.perf_counter() - t0
        resume = prepare_av_checkpoints(root, items, device)
        cfg_path = fusion_train_config(root, manifest, trials, resume)
        start: dict = {}
        train = FusionTrainer.train

        def recording_train(self, *args, **kw):
            start.update(U=self.fusion_head.U.detach().clone(),
                         V=self.fusion_head.V.detach().clone())
            return train(self, *args, **kw)

        chunks = [0]
        before = launch_counts()
        FusionTrainer.train = recording_train
        try:
            with counting_calls(FusionTrainer, "extract_pair_embedding", chunks):
                t0 = time.perf_counter()
                trainer, out = train_fusion_cli.main(
                    ["--config", cfg_path, "--mode", "train", "--exp-root",
                     os.path.join(root, "exp"), "--log-time", "run"] + dev_args)
                if trainer.device.type == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            FusionTrainer.train = train
        counts = launches_since(before, FBANK + VIDEO + TDNN + ("bn_prelu_eval",))
        bpe = AVTrainPipeline(trainer.manifest, {}, FUSION_BATCH).batches_per_epoch()
        steps, losses = trainer.step, out["losses"]
        group = trainer.optimizer.param_groups[0]
        check(trainer.fusion_head_name == "lowfer" and trainer.loss_name == "CrossEntropy"
              and trainer.compute_dtype is None and trainer.schedule(0) == 0.5
              and group["momentum"] == 0.9 and group["weight_decay"] == 1e-5
              and trainer.n_spk == FUSION_SPEAKERS,
              "the trainer did not take conf/fusion_config.yaml's recipe")
        check(steps == FUSION_EPOCHS * bpe and bpe >= 4 and len(losses) == steps
              and all(math.isfinite(v) for v in losses),
              f"{steps} steps for {FUSION_EPOCHS} x {bpe} batches, losses {losses}")
        want = {"fft": steps + chunks[0], "mixed": 0, "bn_prelu_fwd": 0, "bn_prelu_bwd": 0,
                "maxpool_fwd": steps + chunks[0], "maxpool_bwd": 0,
                **tdnn_want(evals=steps + chunks[0]),
                "bn_prelu_eval": VIDEO_EVAL_LAUNCHES * (steps + chunks[0])}
        check(counts == want, f"launches {counts} for {steps} train steps and {chunks[0]} "
              f"extraction chunks; expected {want}")
        drift = {k: float((getattr(trainer.fusion_head, k).detach() - start[k]).abs().max())
                 for k in ("U", "V")}
        for tag in [f"net_{e}" for e in range(1, FUSION_EPOCHS + 1)] + ["net_avg"]:
            path = os.path.join(trainer.exp_dir, tag)
            check(os.path.exists(path), f"no {tag} written")
            saved = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
            for k in ("U", "V"):
                drift[k] = max(drift[k], float((saved[k].to(start[k].device)
                                                - start[k]).abs().max()))
        check(drift == {"U": 0.0, "V": 0.0}, f"LowFER's dead U/V moved: {drift}")
        eers = {k: v for k, v in out.items() if k.endswith("_eer")}
        check(len(eers) == 2 and all(0.0 <= v <= 1.0 for v in eers.values()), f"EERs {eers}")
        lengths = [n for e in range(1, FUSION_EPOCHS + 1) for _, n in
                   AVTrainPipeline(trainer.manifest, {}, FUSION_BATCH).sampler.epoch(e)]
        log(f"fusion training through cli/train_fusion.py (conf/fusion_config.yaml: flagship "
            f"E-TDNN and Lipreading, LowFER, CE, SGD 0.5, bs {FUSION_BATCH}, {FUSION_CLIPS} clips x "
            f"{FUSION_CLIP_FRAMES} frames): {FUSION_SPEAKERS} speakers x {FUSION_UTTS} training wavs (and "
            f"{len(FUSION_TEST_UTTS)} held out) with their clips written in {corpus_s:.1f} s; "
            f"{FUSION_EPOCHS} epochs x {bpe} steps, crop lengths {lengths}, losses "
            f"{', '.join(f'{v:.4f}' for v in losses)}; averaged net_1..net_{FUSION_EPOCHS}; "
            f"{chunks[0]} extraction chunks; EERs {eers}; launches {counts}; U/V drift "
            f"{drift}; {wall:.1f} s wall [{smi}]")
        step = fusion_step_phase(trainer, root, smi, peaks)
    return {"launches": counts, "steps": steps, "batches_per_epoch": bpe,
            "extraction_chunks": chunks[0], "crop_lengths": lengths, "losses": losses,
            "eers": eers, "dead_param_drift": drift, "wall_s": wall, **step}


# ---------------------------------------------------------------- phase 13
VIDEO_BF16_LOSS_RTOL = 2e-2       # a bf16 step vs the f32 step from one state
# the bf16 video step audited against float64 (video_bf16_audit): K3's
# batch statistics (mean in sigmas, variance relative), the trunk's spatial
# mean, each TCN convolution and the logits (relative to their largest)
VIDEO_AUDIT_BARS = {"stat_err": 1e-4, "trunk_mean_err": 1e-4, "tcn_err": 1e-4,
                    "logits_err": 1e-5}
VIDEO_FAULTS = ("stats_bf16", "trunk_mean_bf16", "tcn_bf16")


@contextlib.contextmanager
def video_bf16_audit(model, record: dict):
    """Hold a bf16 Lipreading train step to its recipe, filling ``record``
    with the worst reading of each rule: the trunk's blocks compute in bf16
    (``blocks_bf16``); every fused BN+PReLU site takes its batch statistics
    in f32 (``stat_err``, against float64 statistics of its input); the
    trunk's spatial mean (``trunk_mean_err``), each TCN convolution
    (``tcn_err``) and the classifier (``logits_err``) are >= f32, against
    float64 on the same inputs."""
    record.update(blocks_bf16=True, stat_err=0.0, trunk_mean_err=0.0, tcn_err=0.0,
                  logits_err=0.0)
    inner = bn_prelu.bn_prelu_train

    def audited_bn(x, scale, bias, alpha, eps, group=None):
        y, mean, var = inner(x, scale, bias, alpha, eps, group)
        xd = x.detach().double().reshape(-1, x.shape[-1])
        m, v = xd.mean(0), xd.var(0, unbiased=False)
        sd = (v + eps).sqrt()
        record["stat_err"] = max(record["stat_err"],
                                 float(((mean.detach().double() - m).abs() / sd).max()),
                                 float(((var.detach().double() - v).abs() / sd ** 2).max()))
        return y, mean, var

    def block_out(mod, args, out):
        record["blocks_bf16"] &= out.dtype == torch.bfloat16

    last: dict = {}

    def trunk_last(mod, args, out):
        # the trunk's last block output, before the spatial mean
        last["x"] = out.detach()

    def trunk_out(mod, args, out):
        want = last.pop("x").double().mean(dim=(1, 2))
        record["trunk_mean_err"] = max(record["trunk_mean_err"], _rel_err(out, want))

    def conv_out(mod, args, out):
        want = torch.nn.functional.conv1d(
            args[0].detach().double(), mod.weight.double(),
            None if mod.bias is None else mod.bias.double(), mod.stride, mod.padding,
            mod.dilation, mod.groups)
        record["tcn_err"] = max(record["tcn_err"], _rel_err(out, want))

    def logits_out(mod, args, out):
        want = args[0].detach().double() @ mod.weight.double().T + mod.bias.double()
        record["logits_err"] = max(record["logits_err"], _rel_err(out, want))

    trunk = model.trunk
    blocks = [m for m in trunk.modules() if type(m).__name__ == "BasicBlock"]
    hooks = [b.register_forward_hook(block_out) for b in blocks]
    hooks.append(blocks[-1].register_forward_hook(trunk_last))
    hooks.append(trunk.register_forward_hook(trunk_out))
    hooks += [m.register_forward_hook(conv_out) for m in model.tcn.modules()
              if isinstance(m, torch.nn.Conv1d)]
    hooks.append(model.tcn.tcn_output.register_forward_hook(logits_out))
    bn_prelu.bn_prelu_train = audited_bn
    try:
        yield record
    finally:
        bn_prelu.bn_prelu_train = inner
        for h in hooks:
            h.remove()


def video_audit_failures(record: dict) -> list:
    return (["blocks_bf16"] if not record["blocks_bf16"] else []) + [
        k for k, bar in VIDEO_AUDIT_BARS.items() if record[k] > bar]


@contextlib.contextmanager
def planted_video_fault(fault: str, model):
    """One way for the bf16 video recipe to go wrong: the fused sites'
    statistics in bf16 (phase 8's fault), the trunk's spatial mean in bf16,
    or the TCN's convolutions in bf16."""
    convs = [m for m in model.tcn.modules() if isinstance(m, torch.nn.Conv1d)]
    forward, backward = bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward

    def bf16_mean_trunk(self, x):
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return x.mean(dim=(1, 2)).float()

    def bf16_stats_forward(x, *args):
        y, mean, var, inv = faulty_bn_prelu_forward("bf16")(x, *args)
        return y.to(x.dtype), mean, var, inv

    if fault == "stats_bf16":
        bn_prelu.bn_prelu_forward = bf16_stats_forward
        bn_prelu.bn_prelu_backward = bn_prelu.bn_prelu_backward_reference
    elif fault == "trunk_mean_bf16":
        model.trunk.forward = types.MethodType(bf16_mean_trunk, model.trunk)
    elif fault == "tcn_bf16":
        for m in convs:
            m.forward = types.MethodType(lambda self, x: torch.nn.functional.conv1d(
                x.bfloat16(), self.weight.bfloat16(), self.bias.bfloat16(), self.stride,
                self.padding, self.dilation, self.groups).float(), m)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward = forward, backward
        model.trunk.__dict__.pop("forward", None)
        for m in convs:
            m.__dict__.pop("forward", None)


def video_bf16_phase(bn: dict, smi: str, device=None) -> dict:
    """``device`` is for rehearsing the phase on the CPU at a small size;
    the card check passes none."""
    dev_args = ["--device", device] if device else []
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "clips")
        write_clip_corpus(data)
        cfg_path = os.path.join(REPO, "conf", "video_config.json")
        calls: list = []
        with recording_bn_calls(calls):
            before = launch_counts()
            t0 = time.perf_counter()
            trainer, out = train_video_cli.main(
                ["--config-path", cfg_path, "--data-dir", data, "--compute-dtype", "bf16",
                 "--batch-size", str(VIDEO_BATCH), "--epochs", "1", "--exp-root",
                 os.path.join(root, "exp"), "--log-time", "bf16"] + dev_args)
            wall = time.perf_counter() - t0
            launches = launches_since(before, VIDEO)
        losses, steps = out["losses"], trainer.step
        check(trainer.compute_dtype is torch.bfloat16 and steps >= 2 and len(losses) == steps
              and all(math.isfinite(v) for v in losses), f"bf16 video epoch: {steps} steps, "
              f"losses {losses}")
        want = {"bn_prelu_fwd": 27 * steps, "bn_prelu_bwd": 27 * steps,
                "maxpool_fwd": steps, "maxpool_bwd": steps}
        check(launches == want, f"bf16 video launches {launches}, expected {want}")
        seen = {(shape, dtype) for shape, dtype, _, _ in calls}
        check(len(calls) == 9 * steps and {d for _, d in seen} == {torch.bfloat16},
              f"{len(calls)} fused calls in {sorted({d for _, d in seen}, key=str)} for "
              f"{steps} bf16 steps")
        path_err = bn_prelu_path_check(seen)

        net1 = os.path.join(trainer.exp_dir, "net_1")
        emb_root = os.path.join(root, "embedding")
        before = launch_counts()
        _, ext = train_video_cli.main(
            ["--config-path", cfg_path, "--data-dir", data, "--extract-feats",
             "--batch-size", str(VIDEO_BATCH), "--model-path", net1,
             "--mouth-embedding-out-path", emb_root] + dev_args)
        extract_launches = launches_since(before, VIDEO)
        written = {}
        for d, _, files in os.walk(emb_root):
            for f in files:
                written[os.path.relpath(os.path.join(d, f), emb_root)[:-4]] = np.load(
                    os.path.join(d, f))["data"]
        direct = VideoTrainer(video_config(), trainer.num_classes, device=device)
        direct.load(net1)
        clips = scan_clip_dir(data)
        want_feats = direct.extract_clip_features(VideoClipBatches(
            clips, batch_size=VIDEO_BATCH, bucket_t=8, shuffle=False, pre_crop=(88, 88)))
        check(sorted(written) == sorted(want_feats) == sorted(c.name for c in clips),
              f"{len(written)} npz written for {len(clips)} clips")
        ext_err = max(float(np.abs(written[n][0] - f).max()) for n, f in want_feats.items())
        check(all(written[n].shape == (1, len(f), 512) and written[n].dtype == np.float32
                  for n, f in want_feats.items()) and ext_err <= 1e-5,
              f"--extract-feats npz differ from extract_clip_features by {ext_err:.3e}")
        full_batch = full_clip_batch(clips)
    log(f"bf16 video training through cli/train_video.py --compute-dtype bf16 (flagship "
        f"Lipreading, bs {VIDEO_BATCH}): {steps} steps, losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; launches {launches} (27 K3 and 27 K4, "
        f"1 + 1 pool per step); K3/K4 vs plain at its {len(seen)} bf16 site shapes: max err "
        f"y {path_err['y']:.2e}, dx {path_err['dx']:.2e}; {wall:.2f} s wall; --extract-feats: "
        f"{len(written)} (1, T, 512) f32 npz, {ext_err:.1e} from extract_clip_features, "
        f"launches {extract_launches} [{smi}]")
    step = video_bf16_step_phase(direct, full_batch, bn, smi)
    return {"launches": launches, "steps": steps, "losses": losses, "path_err": path_err,
            "extract_err": ext_err, "extract_launches": extract_launches, "wall_s": wall,
            **step}


def video_bf16_step_phase(trainer: VideoTrainer, batch: dict, bn: dict, smi: str) -> dict:
    """A bs 128 x 29 bf16 step against an f32 step from one state, its
    forward audited against float64 with planted faults; the steps' times,
    K3/K4's bf16 time per step, and one profiled bf16 step."""
    dev = trainer.device
    clips, lengths, labels = (torch.from_numpy(batch[k]).to(dev)
                              for k in ("clips", "lengths", "labels"))
    x = V.mask_pad_frames(V.train_transform(clips, torch.Generator().manual_seed(1))[..., None],
                          lengths)
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)

    def step(dtype):
        trainer.compute_dtype = dtype
        torch.manual_seed(0)   # the same dropout masks in every run
        loss = float(trainer.train_step_frames(x, lengths, labels)["loss"])
        trainer.model.load_state_dict(state[0])
        trainer.optimizer.load_state_dict(state[1])
        trainer.step = state[2]
        return loss

    loss_f = step(None)
    audit: dict = {}
    with video_bf16_audit(trainer.model, audit):
        loss_b = step(torch.bfloat16)
    planted = {}
    for fault in VIDEO_FAULTS:
        record: dict = {}
        with planted_video_fault(fault, trainer.model), video_bf16_audit(trainer.model, record):
            loss_x = step(torch.bfloat16)
        planted[fault] = {"loss_rel": abs(loss_x - loss_f) / abs(loss_f), "audit": record,
                          "caught_by": video_audit_failures(record)}
    bf16_rel = abs(loss_b - loss_f) / abs(loss_f)
    log(f"bf16 video step vs f32 step at bs {VIDEO_BATCH} x 29: loss {loss_b:.6f} vs "
        f"{loss_f:.6f} ({bf16_rel:.2e} relative, bar {VIDEO_BF16_LOSS_RTOL}); audit "
        f"{json.dumps(audit)} [{smi}]")
    for fault, r in planted.items():
        log(f"  planted bf16 video fault {fault}: loss {r['loss_rel']:.2e} from the f32 step, "
            f"audit {json.dumps(r['audit'])}; caught by {r['caught_by']}")
    check(bf16_rel <= VIDEO_BF16_LOSS_RTOL, f"bf16 video step loss {loss_b} vs f32 {loss_f}")
    check(not video_audit_failures(audit), f"the bf16 video step breaks its recipe: {audit}")
    check(all(r["caught_by"] for r in planted.values()), "planted bf16 video faults passed "
          "the audit: " + ", ".join(f for f, r in planted.items() if not r["caught_by"]))

    gen = torch.Generator().manual_seed(2)
    walls = {"bf16": [], "f32": []}
    for name in ("bf16", "f32", "f32", "bf16"):
        trainer.compute_dtype = torch.bfloat16 if name == "bf16" else None
        trainer.train_step(clips, lengths, labels, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for _ in range(3):
            t0 = time.perf_counter()
            trainer.train_step(clips, lengths, labels, gen)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    bf16_rows = [r for r in bn["rows"] if r["dtype"] == "bfloat16"]
    k34 = {k: sum(r["sites"] * r[k] for r in bf16_rows)
           for k in ("fwd", "bwd", "fwd_bound", "bwd_bound", "fwd_plain", "bwd_plain")}
    log(f"video train step at bs {VIDEO_BATCH} x 29: bf16 {ms['bf16']:.1f} ms "
        f"({VIDEO_BATCH / ms['bf16'] * 1e3:.1f} clips/s), f32 {ms['f32']:.1f} ms "
        f"({VIDEO_BATCH / ms['f32'] * 1e3:.1f} clips/s), median of 6 each in turns; K3/K4 "
        f"in bf16 per step {k34['fwd']:.3f} / {k34['bwd']:.3f} ms against the bf16 byte "
        f"bounds {k34['fwd_bound']:.3f} / {k34['bwd_bound']:.3f} ms [{smi}]")

    trainer.compute_dtype = torch.bfloat16
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        trainer.train_step(clips, lengths, labels, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kinds, busy = profile_kinds(prof, KERNEL_KINDS)
    convs = sorted(((getattr(ev, "device_time_total", 0) / 1e3, ev.key, ev.input_shapes[:2])
                    for ev in prof.key_averages(group_by_input_shape=True)
                    if ev.key in ("aten::cudnn_convolution", "aten::convolution_backward")),
                   key=lambda t: -t[0])[:6]
    frontend_wgrad = next((t for t, k, s in convs if k == "aten::convolution_backward"
                           and s and len(s[0]) == 5), None)
    if busy > 0:
        log(f"profiled bf16 video step: {prof_wall:.1f} ms wall, {busy:.1f} ms of device "
            f"kernels ({1 - busy / prof_wall:.1%} idle); by kind: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
            + f"; the frontend Conv3d's backward {frontend_wgrad} ms [{smi}]")
        for t, k, s in convs:
            log(f"  {t:9.3f} ms  {k} {s}")
    else:
        log("profiled bf16 video step: the profiler saw no device time (not measured)")
    return {"bf16_loss_rel": bf16_rel, "step_losses": {"f32": loss_f, "bf16": loss_b},
            "bf16_audit": audit, "bf16_planted": planted, "step_ms": ms, "step_walls_ms": walls,
            "clips_per_sec": {k: VIDEO_BATCH / v * 1e3 for k, v in ms.items()},
            "k3_k4_bf16_per_step": k34, "profiled_wall_ms": prof_wall,
            "profiled_busy_ms": busy, "profiled_by_kind_ms": kinds,
            "frontend_conv_bwd_ms": frontend_wgrad,
            "top_convs": [[k, t, s] for t, k, s in convs]}


# ---------------------------------------------------------------- phase 14
GROUPED_EPOCHS = 6                # the rate decays after epoch 2; the trainer switches the
                                  # margin after epoch 5, so epoch 6 replays it
GROUPED_BF16_EPOCHS = 3           # bf16: a graph for each crop length the 3 epochs draw
GROUPED_DECAY, GROUPED_MARGIN = [2], [0.2, 0.35]
GROUPED_K_AUDIO, GROUPED_K_VIDEO = 4, 2
GROUPED_FRAMES = 300              # f32: one crop length, so one graph lives through all epochs
                                  # (4 steps, one group, an epoch of phase 11's corpus)
GROUPED_LOSS_RTOL = 1e-5          # each step's loss, grouped vs single, f32
GROUPED_FAULTS = ("rate", "margin")
# 32 speakers x 16 clips at bs 128, one epoch: 4 steps, two groups on one graph, so
# one replay after the first fills the graph's buffers with new clips
GROUPED_VIDEO_CLIPS, GROUPED_VIDEO_FRAMES, GROUPED_VIDEO_EPOCHS = 16, 29, 1
PRESSURE_VIDEO_CLIPS = 8          # phase 14b: 2 steps, one group (its first capture is the case)


def floating_state(*modules) -> dict:
    """A copy of the modules' floating parameters and buffers, by name."""
    return {f"{i}.{n}": v.detach().clone() for i, m in enumerate(modules)
            for n, v in m.state_dict().items() if v.is_floating_point()}


def loss_rel(got: list, want: list) -> float:
    check(len(got) == len(want), f"{len(got)} grouped losses for {len(want)} single ones")
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


@contextlib.contextmanager
def frozen_at_capture(name: str):
    """Plant a fault: the per-step scalar ``name`` keeps, in every replay,
    the value it had when its graph was captured (as a rate or margin read
    as a Python number would)."""
    fill = dispatch.GroupedSteps._fill

    def frozen(entry, inputs, scalars):
        if entry.graph is not None:
            scalars = {n: v for n, v in scalars.items() if n != name}
        fill(entry, inputs, scalars)

    dispatch.GroupedSteps._fill = staticmethod(frozen)
    try:
        yield
    finally:
        dispatch.GroupedSteps._fill = staticmethod(fill)


class NudgedAudio:
    """The pipeline's batches with the PCM (as f32) nudged elementwise by
    ``NUDGE``, relative: the single run's own sensitivity."""

    def __init__(self, pipeline, seed: int = 5):
        self.pipeline, self.seed = pipeline, seed

    def __getattr__(self, name):
        return getattr(self.pipeline, name)

    def epoch(self, epoch: int):
        rng = np.random.default_rng((self.seed, epoch))
        for batch in self.pipeline.epoch(epoch):
            pcm = batch["pcm"].astype(np.float32) / 32768.0
            yield {**batch, "pcm": (pcm * (1.0 + NUDGE * rng.standard_normal(pcm.shape))
                                    ).astype(np.float32)}


def grouped_audio_config(root: str, manifest: str, trials: str, dtype: str,
                         frames: int | None, epochs: int = GROUPED_EPOCHS) -> dict:
    """``conf/audio_config.yaml`` for phase 14: K = 4, ``epochs`` epochs, the
    rate decayed after epoch 2 and the margin switched after epoch 5."""
    cfg = load_audio_config(AUDIO_CONFIG_PATH).to_dict()
    cfg["data"].update(train_manifest=manifest, test_root=root, trial_grid=trials)
    if frames:
        cfg["data"]["frames"] = [frames, frames]
    cfg["train"].update(epoch=epochs, lr_decay_step=GROUPED_DECAY,
                        margin=GROUPED_MARGIN, steps_per_dispatch=GROUPED_K_AUDIO,
                        compute_dtype=dtype)
    return cfg


def release() -> None:
    """Free what dropped trainers held on the card (a dropped trainer frees
    its runner, graphs and pool at once; the collector takes any other
    cycle) and hand the cached memory back to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def timed_part(parts: dict | None, name: str):
    """Add the block's wall seconds to ``parts[name]`` (phase 14's split)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if parts is not None:
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0


def grouped_audio_run(cfg: dict, root: str, tag: str, grouped: bool, nudged: bool = False,
                      device=None, keep: bool = False) -> dict:
    """Train ``cfg`` from the seeded init; ``grouped=False`` runs the same
    batches (the sampler's runs of K) as single steps. The trainer is
    returned with ``keep``, else released."""
    trainer = AudioTrainer(Config(cfg), device=device, exp_root=os.path.join(root, "exp"),
                           log_time=tag)
    if not grouped:
        trainer.steps_per_dispatch = 1
    if nudged:
        trainer.pipeline = NudgedAudio(trainer.pipeline)
    before = launch_counts()
    t0 = time.perf_counter()
    losses = trainer.train()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runner = trainer.grouped
    run = {"losses": losses, "wall_s": wall, "launches": launches_since(before, FBANK),
           "state": floating_state(trainer.model, trainer.criterion),
           "warmups": runner.warmup_steps, "graphs": len(runner.graphs),
           "replays": sum(e.replays for e in runner.graphs.values()),
           "steps": trainer.step, "batches_per_epoch": trainer.pipeline.batches_per_epoch(),
           "crop_lengths": sorted({n for e in range(1, trainer.current_epoch + 1)
                                   for _, n in trainer.pipeline.sampler.epoch(e)})}
    if keep:
        run["trainer"] = trainer
    else:
        del trainer, runner
        release()
    return run


def grouped_launch_check(run: dict, steps: int, what: str, want) -> None:
    runs = steps + run["warmups"]
    check(run["launches"] == want(runs), f"{what}: launches {run['launches']} for {steps} "
          f"steps and {run['warmups']} warm-up steps, expected {want(runs)}")


def grouped_audio_phase(smi: str, root: str, device=None, parts: dict | None = None) -> dict:
    """Phase 14, audio: grouped against single in f32 across the rate decay
    and the margin switch, the planted faults, the bf16 recipe, step times
    and one profiled group; then a reference .pth through cli/verify.py.
    ``parts`` takes the seconds of its parts (:func:`timed_part`)."""
    with timed_part(parts, "corpus"):
        manifest, trials = write_train_corpus(os.path.join(root, "audio"))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False), \
            timed_part(parts, "grouped_runs"):
        f32 = grouped_audio_config(root, manifest, trials, "float32", GROUPED_FRAMES)
        single = grouped_audio_run(f32, root, "single", grouped=False, device=device)
        grouped = grouped_audio_run(f32, root, "grouped", grouped=True, device=device,
                                    keep=True)
        nudged = grouped_audio_run(f32, root, "nudged", grouped=False, nudged=True,
                                   device=device)
        faults = {}
        for name in GROUPED_FAULTS:
            with frozen_at_capture(name):
                run = grouped_audio_run(f32, root, f"fault_{name}", grouped=True, device=device)
            faults[name] = {"loss_rel": loss_rel(run["losses"], single["losses"]),
                            "distance": grad_distance(run["state"], single["state"])}
            del run
    steps, bpe = single["steps"], single["batches_per_epoch"]
    rel = loss_rel(grouped["losses"], single["losses"])
    d_group = grad_distance(grouped["state"], single["state"])
    d_nudge = grad_distance(nudged["state"], single["state"])
    bar = NUDGE_FACTOR * d_nudge
    for f in faults.values():
        f["caught_by"] = ((["loss"] if f["loss_rel"] > GROUPED_LOSS_RTOL else [])
                          + (["parameters"] if f["distance"] > bar else []))
    log(f"grouped audio training (conf/audio_config.yaml, f32, TF32 off, cuDNN deterministic, "
        f"bs {BATCH} x {GROUPED_FRAMES}, K = {GROUPED_K_AUDIO}): {GROUPED_EPOCHS} epochs x "
        f"{bpe} steps, the rate decayed after epoch {GROUPED_DECAY[0]} and the margin "
        f"{GROUPED_MARGIN[0]} -> {GROUPED_MARGIN[1]} after epoch 5; {grouped['graphs']} graph, "
        f"{grouped['replays']} replays, {grouped['warmups']} eager warm-up steps; each step's loss "
        f"within {rel:.2e} of the single run's (bar {GROUPED_LOSS_RTOL}); final parameters "
        f"{d_group:.3e} of their norm from the single run's, a {NUDGE} nudge of the PCM moves "
        f"them {d_nudge:.3e} (bar {NUDGE_FACTOR} x); walls grouped {grouped['wall_s']:.1f} s, "
        f"single {single['wall_s']:.1f} s [{smi}]")
    for name, f in faults.items():
        log(f"  planted fault, the {name} frozen at capture: loss {f['loss_rel']:.2e}, "
            f"parameters {f['distance']:.3e}; caught by {f['caught_by']}")
    groups = GROUPED_EPOCHS * (bpe // GROUPED_K_AUDIO)
    check(grouped["graphs"] == 1 and grouped["replays"] == groups,
          f"{grouped['graphs']} graphs and {grouped['replays']} replays for {groups} groups")
    check(rel <= GROUPED_LOSS_RTOL, f"grouped audio losses {rel:.3e} from the single run's")
    check(0 < d_nudge and d_group <= bar, f"grouped audio parameters {d_group:.3e} from the "
          f"single run's, bar {bar:.3e}")
    check(all(f["caught_by"] for f in faults.values()),
          f"planted grouped faults passed every bar: {faults}")
    grouped_launch_check(grouped, steps, "grouped f32 audio",
                         lambda n: {"fft": n, "mixed": 0})
    with timed_part(parts, "reference_pth"):
        interop = reference_pth_check(grouped.pop("trainer"), root, smi, device)
        release()

    bf16 = grouped_audio_config(root, manifest, trials, "bf16", None, GROUPED_BF16_EPOCHS)
    with timed_part(parts, "grouped_runs"):
        bf16_single = grouped_audio_run(bf16, root, "bf16_single", grouped=False,
                                        device=device)
        bf16_grouped = grouped_audio_run(bf16, root, "bf16_grouped", grouped=True,
                                         device=device, keep=True)
    bf16_rel = loss_rel(bf16_grouped["losses"], bf16_single["losses"])
    lengths = bf16_grouped["crop_lengths"]
    log(f"grouped bf16 audio training (the config's recipe, crop lengths {lengths}): "
        f"{bf16_grouped['graphs']} graphs, {bf16_grouped['replays']} replays, "
        f"{bf16_grouped['warmups']} warm-up steps; losses within {bf16_rel:.2e} of the single "
        f"run's (bar {BF16_LOSS_BAR}); launches {bf16_grouped['launches']} [{smi}]")
    check(bf16_rel <= BF16_LOSS_BAR, f"grouped bf16 audio losses {bf16_rel:.3e} from single")
    grouped_launch_check(bf16_grouped, bf16_single["steps"], "grouped bf16 audio",
                         lambda n: {"fft": n, "mixed": 0})
    timing = grouped_audio_timing(bf16_grouped.pop("trainer"), smi, parts)
    release()
    return {"steps": steps, "loss_rel": rel, "distance": d_group, "nudge_distance": d_nudge,
            "faults": faults, "graphs": grouped["graphs"], "replays": grouped["replays"],
            "warmups": grouped["warmups"], "launches": grouped["launches"],
            "walls_s": {"grouped": grouped["wall_s"], "single": single["wall_s"]},
            "bf16": {"loss_rel": bf16_rel, "graphs": bf16_grouped["graphs"],
                     "replays": bf16_grouped["replays"], "warmups": bf16_grouped["warmups"],
                     "launches": bf16_grouped["launches"], "crop_lengths": lengths,
                     "walls_s": {"grouped": bf16_grouped["wall_s"],
                                 "single": bf16_single["wall_s"]}},
            **timing, "reference_pth": interop}


def group_timing(single_step, group_step, k: int, sync) -> dict:
    """ms per step of K single steps and of one K-step group, in turns
    (single, grouped, grouped, single), each the median of three; the peak
    memory each way, from before its first call (a group's first call may
    capture its graph: the pool's memory is allocated then, and a replay
    allocates nothing)."""
    walls = {"single": [], "grouped": []}
    peaks = {}
    for name in ("single", "grouped", "grouped", "single"):
        fn = single_step if name == "single" else group_step
        if torch.cuda.is_available() and name not in peaks:
            torch.cuda.reset_peak_memory_stats()
        fn()
        sync()
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            sync()
            walls[name].append((time.perf_counter() - t0) * 1e3 / k)
        if torch.cuda.is_available():
            peaks[name] = max(peaks.get(name, 0.0), torch.cuda.max_memory_allocated() / 1e9)
    return {"ms": {n: sorted(v)[len(v) // 2] for n, v in walls.items()}, "walls_ms": walls,
            "peak_gb": peaks}


def profiled_idle(fn, sync, kinds_table) -> dict:
    """One profiled call of ``fn``: wall, device busy time, idle share."""
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    kinds, busy = profile_kinds(prof, kinds_table)
    return {"wall_ms": wall, "busy_ms": busy,
            "idle": (1 - busy / wall) if busy > 0 else None, "by_kind_ms": kinds}


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def grouped_audio_timing(trainer: AudioTrainer, smi: str, parts: dict | None = None) -> dict:
    """bf16 at bs 256 x 300: ms per step of 4 single steps against one
    group of 4, peak memory both ways, and one profiled group and one
    profiled run of 4 single steps with their idle shares."""
    k, dev = GROUPED_K_AUDIO, trainer.device
    sids = next(trainer.pipeline.sampler.epoch(1))[0]
    batches = [trainer.pipeline._assemble(sids, GROUPED_FRAMES, (9, i)) for i in range(k)]
    pcm = torch.from_numpy(np.stack([b["pcm"] for b in batches])).to(dev)
    labels = torch.from_numpy(np.stack([b["labels"] for b in batches])).to(dev)
    margin = trainer.end_margin

    def singles():
        for i in range(k):
            trainer.train_step(pcm[i], labels[i], margin)

    def group():
        trainer.train_group(pcm, labels, margin)

    with timed_part(parts, "timing_captures"):
        times = group_timing(singles, group, k, _sync)
    with timed_part(parts, "profiled_group"):
        prof = {"grouped": profiled_idle(group, _sync, AUDIO_KINDS),
                "single": profiled_idle(singles, _sync, AUDIO_KINDS)}
    log(f"audio bf16 at bs {BATCH} x {GROUPED_FRAMES}: {times['ms']['single']:.2f} ms a single "
        f"step, {times['ms']['grouped']:.2f} ms a step in a group of {k} (median of 3 each, in "
        f"turns); peak {times['peak_gb']} GB; profiled: " + "; ".join(
            f"{n} {p['wall_ms']:.1f} ms wall, {p['busy_ms']:.1f} ms busy, idle "
            + (f"{p['idle']:.1%}" if p["idle"] is not None else "not measured")
            for n, p in prof.items()) + f" [{smi}]")
    return {"timing_bf16_300": times, "profiled_bf16_300": prof}


def reference_pth_check(trainer: AudioTrainer, root: str, smi: str, device=None) -> dict:
    """The trainer's last checkpoint exported by ``cli/export_torch.py
    --dp-prefix`` as a reference ``.pth``, served by ``cli/verify.py
    --checkpoint``: its embeddings equal those of the port's own checkpoint."""
    own = os.path.join(trainer.exp_dir, f"net_{trainer.current_epoch}")
    ref = export_torch_cli.main(["audio", "--checkpoint", own, "--out",
                                 os.path.join(root, "reference.pth"), "--dp-prefix"])
    keys = list(torch.load(ref, weights_only=True)["state_dict"])
    check(keys and all(k.startswith("module.") for k in keys), "the export has no module. keys")
    cfg_path = os.path.join(root, "verify_config.json")
    with open(cfg_path, "w") as fh:
        json.dump(trainer.cfg.to_dict(), fh)
    wavs = sorted(glob.glob(os.path.join(root, "audio", "s00*", "u8.wav")))[:1] + sorted(
        glob.glob(os.path.join(root, "audio", "s001", "u*.wav")))[:2]
    dev_args = ["--device", device] if device else []
    profiles = {}
    for tag, ckpt_path in (("reference", ref), ("own", own)):
        prof = os.path.join(root, f"profiles_{tag}")
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            verify_cli.main(["enroll", "-c", cfg_path, "-p", prof, "--checkpoint", ckpt_path,
                             *dev_args, "spk", *wavs])
        profiles[tag] = np.load(os.path.join(prof, "spk.npy"))
    equal = bool(np.array_equal(profiles["reference"], profiles["own"]))
    log(f"reference .pth: {os.path.basename(own)} exported with --dp-prefix ({len(keys)} "
        f"module. keys) and enrolled through cli/verify.py --checkpoint: profile "
        f"{'bit-equal to' if equal else 'differs from'} the port's own checkpoint's [{smi}]")
    check(equal, "the reference .pth serves other embeddings than the port's checkpoint")
    return {"keys": len(keys), "profile_equal": equal}


def write_grouped_clip_corpus(root: str, clips: int = GROUPED_VIDEO_CLIPS,
                              seed: int = 1) -> None:
    """32 speakers x ``clips`` clips of 29 frames (:func:`speaker_clip`)."""
    rng = np.random.default_rng(seed)
    for spk in range(VIDEO_SPEAKERS):
        os.makedirs(os.path.join(root, f"s{spk:02d}"), exist_ok=True)
        for c in range(clips):
            np.savez(os.path.join(root, f"s{spk:02d}", f"c{c:02d}.npz"),
                     data=speaker_clip(rng, spk, GROUPED_VIDEO_FRAMES))


@contextlib.contextmanager
def nudged_video_frames(seed: int = 11):
    """The train frames nudged elementwise by ``NUDGE``, relative, from a
    generator of their own (the dropout masks stay the run's)."""
    inner = VideoTrainer._train_frames
    gens = {}

    def nudged(self, *args):
        x = inner(self, *args)
        gen = gens.setdefault(x.device, torch.Generator(device=x.device).manual_seed(seed))
        return x * (1.0 + NUDGE * torch.randn(x.shape, generator=gen, device=x.device,
                                               dtype=x.dtype))

    VideoTrainer._train_frames = nudged
    try:
        yield
    finally:
        VideoTrainer._train_frames = inner


def grouped_video_run(data: str, root: str, tag: str, dtype: str, k: int,
                      device=None, keep: bool = False) -> dict:
    dev_args = ["--device", device] if device else []
    torch.manual_seed(0)   # the dropout masks of every run start from one state
    before = launch_counts()
    t0 = time.perf_counter()
    trainer, out = train_video_cli.main(
        ["--config-path", os.path.join(REPO, "conf", "video_config.json"), "--data-dir", data,
         "--batch-size", str(VIDEO_BATCH), "--epochs", str(GROUPED_VIDEO_EPOCHS),
         "--compute-dtype", dtype, "--steps-per-dispatch", str(k), "--exp-root",
         os.path.join(root, "exp"), "--log-time", tag] + dev_args)
    _sync()
    wall = time.perf_counter() - t0
    run = {"losses": out["losses"], "wall_s": wall, "launches": launches_since(before, VIDEO),
           "launches_wgrad": launches_since(before, ("conv3d_wgrad",))["conv3d_wgrad"],
           "state": floating_state(trainer.model), "steps": trainer.step,
           "warmups": trainer.grouped.warmup_steps, "graphs": len(trainer.grouped.graphs),
           "replays": sum(e.replays for e in trainer.grouped.graphs.values())}
    if keep:
        run["trainer"] = trainer
    else:
        del trainer
        release()
    return run


def grouped_video_phase(smi: str, root: str, device=None, parts: dict | None = None) -> dict:
    """Phase 14, video: cli/train_video.py --steps-per-dispatch 2 against
    single steps, f32 and bf16, one epoch; step times and one profiled
    group. ``parts`` takes the seconds of its parts (:func:`timed_part`)."""
    data = os.path.join(root, "clips")
    with timed_part(parts, "corpus"):
        write_grouped_clip_corpus(data)
    per_step = lambda n: {"bn_prelu_fwd": 27 * n, "bn_prelu_bwd": 27 * n,  # noqa: E731
                          "maxpool_fwd": n, "maxpool_bwd": n}
    out = {}
    cudnn = torch.backends.cudnn
    for dtype in ("float32", "bf16"):
        with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False), \
                timed_part(parts, "grouped_runs"):
            single = grouped_video_run(data, root, f"{dtype}_single", dtype, 1, device)
            grouped = grouped_video_run(data, root, f"{dtype}_grouped", dtype, GROUPED_K_VIDEO,
                                        device, keep=True)
            nudged = None
            if dtype == "float32":
                with nudged_video_frames():
                    nudged = grouped_video_run(data, root, "nudged", dtype, 1, device)
        steps = single["steps"]
        rel = loss_rel(grouped["losses"], single["losses"])
        d_group = grad_distance(grouped["state"], single["state"])
        row = {"steps": steps, "loss_rel": rel, "distance": d_group,
               "replays": grouped["replays"], "warmups": grouped["warmups"],
               "launches": grouped["launches"], "launches_wgrad": grouped["launches_wgrad"],
               "walls_s": {"grouped": grouped["wall_s"], "single": single["wall_s"]}}
        if nudged is not None:
            row["nudge_distance"] = grad_distance(nudged["state"], single["state"])
        log(f"grouped video training through cli/train_video.py --steps-per-dispatch "
            f"{GROUPED_K_VIDEO} ({dtype}, bs {VIDEO_BATCH} x {GROUPED_VIDEO_FRAMES}, TCN "
            f"dropout {video_config()['tcn_dropout']}): {steps} steps, {grouped['replays']} "
            f"replays, {grouped['warmups']} eager warm-up steps; losses within {rel:.2e} of "
            f"the single run's; final parameters {d_group:.3e} of their norm from the single run's"
            + (f", a {NUDGE} nudge of the frames moves them {row['nudge_distance']:.3e}"
               if nudged else "") + f"; launches {grouped['launches']} [{smi}]")
        if dtype == "float32":
            check(rel <= GROUPED_LOSS_RTOL, f"grouped video losses {rel:.3e} from single")
            check(0 < row["nudge_distance"] and d_group <= NUDGE_FACTOR * row["nudge_distance"],
                  f"grouped video parameters {d_group:.3e} from the single run's")
        else:
            check(rel <= VIDEO_BF16_LOSS_RTOL, f"grouped bf16 video losses {rel:.3e}")
        groups = GROUPED_VIDEO_EPOCHS * (steps // GROUPED_VIDEO_EPOCHS // GROUPED_K_VIDEO)
        # a replay after the first one holds the graph on new clips against single steps
        check(grouped["graphs"] == 1 and grouped["replays"] == groups >= 2,
              f"{grouped['graphs']} graphs and {grouped['replays']} replays for {groups} groups")
        grouped_launch_check(grouped, steps, f"grouped {dtype} video", per_step)
        row.update(grouped_video_timing(grouped.pop("trainer"), smi, parts))
        out[dtype] = row
        del single, grouped, nudged
        release()
    return out


PRESSURE_HEADROOM_GB = 4.0        # free memory left beside 1.25x the grouped run's peak
PRESSURE_TIGHT_GB = 30.0          # free memory at which the f32 video step's cuDNN workspace
                                  # allocations fail (read off a sweep of 23-36 GB)
PRESSURE_TIMEOUT_S = 600          # the subprocess's whole run
PRESSURE_MARK = "capture pressure result: "
REFUSALS = ("failed while warming up and capturing", "is not bit-equal to the same steps")


def _failed_allocations() -> int:
    """The caching allocator's count of failed allocations so far."""
    return torch.cuda.memory_stats().get("num_ooms", 0) if torch.cuda.is_available() else 0


def _free_gb() -> float:
    return torch.cuda.mem_get_info()[0] / 1e9


def grouped_video_under_pressure(data: str, root: str, smi: str, device=None) -> dict:
    """The condition under which a grouped capture once computed other
    numbers than the eager steps, in a process of its own: phase 14's f32 grouped video run (cli/train_video.py
    --steps-per-dispatch 2) captured while the card's memory is held (a) by
    an earlier grouped run's trainer and its graphs, kept alive, (b) by one
    allocation that leaves ``PRESSURE_TIGHT_GB`` free, (c) by one that
    leaves 1.25x the grouped run's peak plus ``PRESSURE_HEADROOM_GB``, and
    (d) with the memory back. When a cuDNN workspace cannot be allocated,
    the convolution runs another algorithm and cuDNN keeps that plan for
    the shape, for the rest of the process, so the runner
    (``train/dispatch.py``) must refuse a capture during which an
    allocation failed, or whose first replay is not bit-equal to the eager
    steps. Each attempt is either refused by the runner, or meets phase
    14's f32 bars against a single run made right after it with the
    pressure gone (with the plans the process holds by then); any other
    failure, running out of memory outside the runner included, fails the
    phase, and so does a run of cases in which no capture was refused.
    Phase 14's bars are read here from the process's own single and nudged
    runs, made first."""
    single = grouped_video_run(data, root, "single", "float32", 1, device)
    with nudged_video_frames():
        nudged = grouped_video_run(data, root, "nudged", "float32", 1, device)
    nudge = grad_distance(nudged["state"], single["state"])
    torch.cuda.reset_peak_memory_stats()
    holder = [grouped_video_run(data, root, "held", "float32", GROUPED_K_VIDEO, device,
                                keep=True)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    first = holder[0]
    out = {"nudge_distance": nudge, "peak_gb": peak_gb,
           "held_run": {"loss_rel": loss_rel(first["losses"], single["losses"]),
                        "distance": grad_distance(first["state"], single["state"])},
           "failed_allocations_before": _failed_allocations()}
    check(out["held_run"]["loss_rel"] <= GROUPED_LOSS_RTOL
          and out["held_run"]["distance"] <= NUDGE_FACTOR * nudge,
          f"grouped f32 video before any pressure: {out['held_run']} from the single run's")
    del single, nudged, first

    def attempt(tag: str, relieve) -> dict:
        r = {"free_gb_at_start": _free_gb()}
        before = _failed_allocations()
        try:
            grouped, error = grouped_video_run(data, root, tag, "float32", GROUPED_K_VIDEO,
                                               device), None
        except RuntimeError as exc:
            grouped, error = None, str(exc).splitlines()[0][:300]
        r["failed_allocations"] = _failed_allocations() - before
        relieve()
        release()
        if error is not None:
            check(any(text in error for text in REFUSALS),
                  f"grouped f32 video under pressure ({tag}) failed outside the runner's "
                  f"refusal: {error}")
            return {**r, "fit": False, "error": error}
        before = _failed_allocations()
        one = grouped_video_run(data, root, tag + "_single", "float32", 1, device)
        r.update(fit=True, single_failed_allocations=_failed_allocations() - before,
                 loss_rel=loss_rel(grouped["losses"], one["losses"]),
                 distance=grad_distance(grouped["state"], one["state"]))
        return r

    out["graphs_held"] = attempt("graphs_held", holder.clear)
    for name, keep_gb in (("tight", PRESSURE_TIGHT_GB),
                          ("ballast", 1.25 * peak_gb + PRESSURE_HEADROOM_GB)):
        free = torch.cuda.mem_get_info()[0]
        ballast = [torch.empty(max(free - int(keep_gb * 1e9), 0), dtype=torch.uint8,
                               device="cuda")]
        held_gb = ballast[0].numel() / 1e9
        out[name] = {**attempt(name, ballast.clear), "held_gb": held_gb}
    out["after"] = attempt("after", lambda: None)
    cases = ("graphs_held", "tight", "ballast", "after")
    log(f"grouped f32 video before any pressure ({GROUPED_K_VIDEO} steps a group, peak "
        f"{peak_gb:.1f} GB): losses within {out['held_run']['loss_rel']:.2e} of the single "
        f"run's, parameters {out['held_run']['distance']:.3e} of their norm [{smi}]")
    for name in cases:
        r = out[name]
        log(f"grouped f32 video ({name}, {r['free_gb_at_start']:.1f} GB free at the start, "
            f"{r['failed_allocations']} failed allocations): "
            + (f"losses within {r['loss_rel']:.2e} of a single run's made right after "
               f"({r['single_failed_allocations']} failed allocations in it), parameters "
               f"{r['distance']:.3e} of their norm (bars {GROUPED_LOSS_RTOL:g} and "
               f"{NUDGE_FACTOR:g} x {nudge:.3e})" if r["fit"] else
               "refused by the runner: " + r["error"]) + f" [{smi}]")
    for name in (n for n in cases if out[n]["fit"]):
        r = out[name]
        check(r["loss_rel"] <= GROUPED_LOSS_RTOL and r["distance"] <= NUDGE_FACTOR * nudge,
              f"grouped f32 video ({name}) not refused and off the single run made right "
              f"after it: losses {r['loss_rel']:.3e}, parameters {r['distance']:.3e}")
    check(any(not out[name]["fit"] for name in cases),
          "no grouped capture under memory pressure was refused")
    return out


def capture_pressure_child(smi: str) -> int:
    """``chip_smoke.py --capture-pressure SMI``: :func:`grouped_video_under_pressure`
    on a fresh card, its result printed after ``PRESSURE_MARK``."""
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "clips")
        write_grouped_clip_corpus(data, PRESSURE_VIDEO_CLIPS)
        t0 = time.perf_counter()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            out = grouped_video_under_pressure(data, root, smi)
        out["wall_s"] = time.perf_counter() - t0
    print(PRESSURE_MARK + json.dumps(out), flush=True)
    return 0


def capture_pressure_phase(smi: str) -> dict:
    """Phase 14b: :func:`grouped_video_under_pressure` in a subprocess, so
    that it has the card to itself and a convolution plan cuDNN takes there
    for want of memory reaches no other phase. Run before the other phases
    allocate; fails when the subprocess fails or outlives its time."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--capture-pressure", smi],
                          cwd=REPO, stdout=subprocess.PIPE, text=True,
                          timeout=PRESSURE_TIMEOUT_S)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(PRESSURE_MARK):
            result = json.loads(line[len(PRESSURE_MARK):])
        else:
            log("  pressure: " + line)
    check(proc.returncode == 0 and result is not None,
          f"the capture-pressure subprocess exited {proc.returncode}")
    result["process_s"] = time.perf_counter() - t0
    log(f"phase 14b (capture pressure, own process): {result['process_s']:.1f} s")
    return result


def grouped_video_timing(trainer: VideoTrainer, smi: str, parts: dict | None = None) -> dict:
    """ms per step of two single steps against one group of two at bs 128 x
    29, peak memory both ways, and one profiled group's idle share."""
    k, dev = GROUPED_K_VIDEO, trainer.device
    # the timed group captures its own graph: drop the training run's first,
    # so that its warm-up and capture are not short of memory beside it
    trainer.grouped.graphs.clear()
    release()
    rng = np.random.default_rng(3)
    clips = torch.from_numpy(rng.integers(0, 256, (k, VIDEO_BATCH, GROUPED_VIDEO_FRAMES, 96, 96),
                                          dtype=np.uint8)).to(dev)
    lengths = torch.full((k, VIDEO_BATCH), GROUPED_VIDEO_FRAMES, dtype=torch.int32, device=dev)
    labels = torch.from_numpy(rng.integers(0, VIDEO_SPEAKERS, (k, VIDEO_BATCH))).to(dev)
    gen = torch.Generator().manual_seed(4)
    draws = {"dh": torch.randint(0, 9, (k, VIDEO_BATCH), generator=gen),
             "dw": torch.randint(0, 9, (k, VIDEO_BATCH), generator=gen),
             "flip": torch.rand((k, VIDEO_BATCH), generator=gen) < 0.5}

    def singles():
        for i in range(k):
            trainer.train_step(clips[i], lengths[i], labels[i], gen)

    def group():
        trainer.train_group(clips, lengths, labels, draws)

    with timed_part(parts, "timing_captures"):
        times = group_timing(singles, group, k, _sync)
    with timed_part(parts, "profiled_group"):
        prof = {"grouped": profiled_idle(group, _sync, KERNEL_KINDS),
                "single": profiled_idle(singles, _sync, KERNEL_KINDS)}
    dtype = "bf16" if trainer.compute_dtype is torch.bfloat16 else "f32"
    log(f"video {dtype} at bs {VIDEO_BATCH} x {GROUPED_VIDEO_FRAMES}: "
        f"{times['ms']['single']:.1f} ms a single step, {times['ms']['grouped']:.1f} ms a step "
        f"in a group of {k}; peak {times['peak_gb']} GB; profiled: " + "; ".join(
            f"{n} {p['wall_ms']:.1f} ms wall, {p['busy_ms']:.1f} ms busy, idle "
            + (f"{p['idle']:.1%}" if p["idle"] is not None else "not measured")
            for n, p in prof.items()) + f" [{smi}]")
    return {"timing": times, "profiled": prof}


def failed_capture_check() -> dict:
    """A step that reads a number on the host cannot be captured: the
    runner raises, and nothing runs in its place. It runs in a thread of
    its own: the current stream is per thread, so a capture cut short
    leaves the main thread's stream as it was."""
    x = torch.ones(4, device="cuda")

    def body(i, inputs, scalars):
        return {"loss": torch.full((), float(inputs["x"][i].sum()), device="cuda")}

    runner = dispatch.GroupedSteps(body, lambda: [x], torch.device("cuda"))

    def attempt():
        try:
            runner.run({"x": torch.ones(2, 4, device="cuda")},
                       {"rate": torch.zeros(2, dtype=torch.float64)})
        except RuntimeError as exc:
            return f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
        return None

    with ThreadPoolExecutor(1) as pool:
        raised = pool.submit(attempt).result()
    torch.cuda.synchronize()
    # the card's generator is not left capturing: an eager dropout runs
    kept = torch.nn.functional.dropout(torch.ones(1024, device="cuda"), 0.5, training=True)
    log(f"a capture that fails (a host read inside the step): raised {raised!r}; "
        f"{len(runner.graphs)} graphs kept; the card still runs, eager dropout included "
        f"({int((kept > 0).sum())} of 1024 kept)")
    check(raised is not None and not runner.graphs, "a failed capture did not raise")
    return {"raised": raised}


def grouped_dispatch_phase(smi: str) -> dict:
    """Phase 14, its parts timed: the corpora's writing, the grouped and
    single runs, the timing captures, the profiled groups, the reference
    .pth check and the failed capture (``parts_s``)."""
    parts = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        audio = grouped_audio_phase(smi, root, parts=parts)
        torch.cuda.empty_cache()
        video = grouped_video_phase(smi, root, parts=parts)
        with timed_part(parts, "failed_capture"):
            failed = failed_capture_check()
        wall = time.perf_counter() - t0
    parts["rest"] = wall - sum(parts.values())
    log(f"phase 14: {wall:.1f} s; by part: " + ", ".join(f"{k} {v:.1f} s"
                                                          for k, v in parts.items()))
    return {"audio": audio, "video": video, "failed_capture": failed, "wall_s": wall,
            "parts_s": parts}


# ---------------------------------------------------------------- phase 15
ATTENTIVE_POOLINGS = ("attentive_statistic", "mono_head_attention", "multi_head_attention")
RESNET_FAULTS = ("bn_stats_bf16", "head_bf16", "head_tf32")   # the pool is f32 by type
VARIANT_SPEAKERS = 128            # the criterion's classes in the attentive steps
SHUFFLENET = {"backbone_type": "shufflenet", "width_mult": 1.0, "tcn_dwpw": True}
C24_SHAPE = (128, 29, 44, 44, 24)  # the ShuffleNet frontend's BN+PReLU and pool input
STFT_TOL = 1e-4                   # the stft front-end in f32 vs float64


def ragged_pcm_batch(n: int, seed: int):
    """``n`` speaker waves of 1-3 s (:func:`speaker_wave`) zero-padded into
    one int16 batch: ``(pcm, feat_lengths, sample_lengths)`` as numpy."""
    rng = np.random.default_rng(seed)
    waves = [speaker_wave(rng, i % 16) for i in range(n)]
    width = max(len(w) for w in waves)
    pcm = np.zeros((n, width), np.int16)
    for i, w in enumerate(waves):
        pcm[i, :len(w)] = np.clip(np.round(w * 32768.0), -32768, 32767)
    lens = np.array([len(w) for w in waves], np.int32)
    feat = np.array([num_frames(int(m), 400, 160) for m in lens], np.int32)
    return pcm, feat, lens


def pooling_config(pooling: str, batch_size: int = 64) -> Config:
    cfg = flagship_config(batch_size).to_dict()
    cfg["model"]["etdnn"]["pooling"] = pooling
    cfg["train"] = {"loss": "LMCL", "bs": BATCH, "compute_dtype": "bf16"}
    return Config(cfg)


def resnet_phase(root: str, manifest: str, trials: str, smi: str, peaks,
                 device=None) -> dict:
    """(a) ``arch: resnet`` through ``cli/train_audio.py``, one epoch in f32
    and one in the config's bf16, then phase 11's step rule and timings."""
    dev_args = ["--device", device] if device else []
    runs, trainer = {}, None
    for dtype in ("float32", "bf16"):
        cfg = load_audio_config(AUDIO_CONFIG_PATH).to_dict()
        cfg["model"]["arch"] = "resnet"
        cfg["data"].update(train_manifest=manifest, test_root=root, trial_grid=trials)
        cfg["train"].update(epoch=1, compute_dtype=dtype)
        path = os.path.join(root, f"resnet_{dtype}.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        before = launch_counts()
        t0 = time.perf_counter()
        trainer, out = train_audio_cli.main(["--config", path, "--mode", "train",
                                             "--exp-root", os.path.join(root, "exp"),
                                             "--log-time", f"resnet_{dtype}"] + dev_args)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_since(before, FBANK)
        n_eval = sum(1 for _ in EvalUtteranceSet(
            utterances_from_trials(trials, root),
            **eval_set_kwargs(trainer.feat_cfg, trainer.test_opts)).batches())
        losses = out["losses"]
        check(type(trainer.model).__name__ == "AudioResNet"
              and trainer.model.fc2.out_features == 256, "the resnet arch was not built")
        check(counts == {"fft": trainer.step + n_eval, "mixed": 0}, f"resnet {dtype}: front-end "
              f"launches {counts} for {trainer.step} steps and {n_eval} extraction batches")
        check(len(losses) == trainer.step and all(math.isfinite(v) for v in losses),
              f"resnet {dtype} losses {losses}")
        check(math.isfinite(out["eer"]) and 0.0 <= out["eer"] <= 1.0, f"EER {out['eer']}")
        runs[dtype] = {"steps": trainer.step, "losses": losses, "eer": out["eer"],
                       "launches": counts, "extraction_batches": n_eval, "wall_s": wall}
        widths = cfg["model"]["resnet"]
        log(f"resnet audio training through cli/train_audio.py (conf/audio_config.yaml, "
            f"arch resnet {widths['hidden_dim']} x {widths['residual_block_layers']}, "
            f"embedding {widths['embedding_dim']}, {dtype}, bs {trainer.batch_size}): "
            f"{trainer.step} steps, losses {', '.join(f'{v:.4f}' for v in losses)}; "
            f"{n_eval} extraction batches; EER {out['eer']:.4f}; front-end launches "
            f"{counts}; {wall:.1f} s wall [{smi}]")
    step = audio_step_phase(trainer, smi, peaks, faults=RESNET_FAULTS, bf16_bars=False)
    return {"runs": runs, **step}


def attentive_phase(root: str, smi: str, device=None) -> dict:
    """(b) The flagship E-TDNN with each attentive pooling: K1 against the
    plain front-end on a ragged batch, a bf16 train step timed beside the
    statistics pooling's, and the reference ``.pth`` layouts through
    ``cli/export_torch.py --pooling`` and ``SpeakerVerifier``."""
    pcm, feat, lens = ragged_pcm_batch(BATCH, seed=21)
    batch = {"pcm": pcm, "feat_lengths": feat, "sample_lengths": lens}
    rng = np.random.default_rng(22)
    s300 = samples_for_frames(300, 0.025, 0.01, RATE)
    crops = torch.from_numpy(rng.integers(-8000, 8000, (BATCH, s300)).astype(np.int16))
    labels = torch.from_numpy(rng.integers(0, VARIANT_SPEAKERS, BATCH).astype(np.int64))
    rows, extractors = {}, {}
    for pooling in ("statistic",) + ATTENTIVE_POOLINGS:
        cfg = pooling_config(pooling)
        ext = AudioExtractor(cfg, device=device)
        ext.load_state_dict(seeded_state_dict(ext.model, seed=0))
        calibrate_bn(ext, batch, seed=1)
        args = [torch.from_numpy(batch[k]).to(ext.device)
                for k in ("pcm", "feat_lengths", "sample_lengths")]
        before = launch_counts()
        e_k = ext.embed(*args)
        launches = launches_since(before, FBANK)
        with plain_front_end():
            e_p = ext.embed(*args)
        err = float((e_k - e_p).abs().max())
        check(launches == {"fft": 1, "mixed": 0}, f"{pooling}: an extraction batch launched "
              f"{launches}")
        check(bool(torch.isfinite(e_k).all()) and err <= EMB_TOL, f"{pooling}: kernel-path "
              f"embeddings {err:.3e} from the plain path, bar {EMB_TOL}")
        trainer = AudioTrainer(cfg, device=device, n_spk=VARIANT_SPEAKERS,
                               exp_root=os.path.join(root, "exp"))
        trainer.model.load_state_dict(ext.model.state_dict())
        check(trainer.compute_dtype is torch.bfloat16, "the attentive step is not bf16")
        x, y = crops.to(trainer.device), labels.to(trainer.device)
        loss = float(trainer.train_step(x, y, 0.2)["loss"])
        check(math.isfinite(loss), f"{pooling}: bf16 step loss {loss}")
        ms = time_ms(lambda: trainer.train_step(x, y, 0.2), iters=5, warmup=2)
        rows[pooling] = {"emb_err": err, "launches": launches, "bf16_loss": loss,
                         "bf16_step_ms": ms, "crops_per_sec": BATCH / ms * 1e3}
        extractors[pooling] = ext
        del trainer
        log(f"E-TDNN with {pooling} pooling: K1 vs plain embeddings of a ragged {BATCH} x "
            f"1-3 s batch {err:.2e} (bar {EMB_TOL}); bf16 train step at bs {BATCH} x 300 "
            f"loss {loss:.4f}, {ms:.2f} ms ({BATCH / ms * 1e3:.1f} crops/s) [{smi}]")
    exports = {}
    waves = [pcm[i, :lens[i]].astype(np.float32) / 32768.0 for i in range(3)]
    for layout in ("attentive_statistic", "mono_head_attention"):
        ext = extractors[layout]
        own = os.path.join(root, f"net_{layout}")
        torch.save({"epoch": 1, "state_dict": ext.model.state_dict()}, own)
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            ref = export_torch_cli.main(["audio", "--checkpoint", own, "--out",
                                         os.path.join(root, f"{layout}.pth"),
                                         "--pooling", layout])
        w_shape = tuple(torch.load(ref, weights_only=True)["state_dict"]["pooling.W"].shape)
        check(len(w_shape) == (3 if layout == "mono_head_attention" else 2),
              f"{layout}: the export's pooling.W has shape {w_shape}")
        profiles = {tag: SpeakerVerifier(pooling_config(layout), checkpoint=path,
                                         device=device).enroll("spk", waves)
                    for tag, path in (("reference", ref), ("own", own))}
        equal = bool(np.array_equal(profiles["reference"], profiles["own"]))
        check(equal, f"{layout}: the reference .pth enrolls another profile")
        exports[layout] = {"pooling_W_shape": list(w_shape), "profile_equal": equal}
    log(f"attentive exports through cli/export_torch.py --pooling, read back by "
        f"SpeakerVerifier: {json.dumps(exports)}")
    return {"poolings": rows, "exports": exports}


@contextlib.contextmanager
def trunk_dtypes(trunk, record: set):
    """Add the type of every ShuffleNet unit's input and output to ``record``."""
    def hook(mod, args, out):
        record.update({args[0].dtype, out.dtype})

    hooks = [unit.register_forward_hook(hook) for unit in trunk[0]]
    try:
        yield record
    finally:
        for h in hooks:
            h.remove()


def c24_kernel_rows(peaks) -> dict:
    """K3/K4 and P at the ShuffleNet frontend's (128, 29, 44, 44, 24), f32
    and bf16, against their plain versions (phase 6's and phase 9's bars),
    with their times and bounds."""
    return {"bn_prelu": bn_prelu_phase(peaks, [(C24_SHAPE, 1)])["rows"],
            "maxpool": maxpool_phase(peaks, [(C24_SHAPE, "train step")])["rows"]}


def shufflenet_step_check(trainer: VideoTrainer, batch: dict, smi: str) -> dict:
    """One f32 bs 128 x 29 step through K3/K4 and P against the plain step
    from the same state (phase 8's rule at the one fused site); then the
    bf16 step's types, f32 and bf16 step times in turns, peak memory and
    one profiled step of each."""
    dev = trainer.device
    clips, lengths, labels = (torch.from_numpy(batch[k]).to(dev)
                              for k in ("clips", "lengths", "labels"))
    x = V.mask_pad_frames(V.train_transform(clips, torch.Generator().manual_seed(1))[..., None],
                          lengths)
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)

    def step(frames, dtype=None):
        trainer.compute_dtype = dtype
        torch.manual_seed(0)   # the same dropout masks in every run
        stats: list = []
        with recording_bn_calls(stats):
            loss = float(trainer.train_step_frames(frames, lengths, labels)["loss"])
        grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
        trainer.model.load_state_dict(state[0])
        trainer.optimizer.load_state_dict(state[1])
        trainer.step = state[2]
        return loss, grads, stats

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        before = launch_counts()
        loss_k, grads_k, stats_k = step(x)
        launches = launches_since(before, VIDEO)
        check(launches == {"bn_prelu_fwd": 3, "bn_prelu_bwd": 3, "maxpool_fwd": 1,
                           "maxpool_bwd": 1}, f"a ShuffleNet kernel step launched {launches}: "
              "3 + 3 BN+PReLU (one site) and 1 + 1 max-pool expected")
        check(len(stats_k) == 1 and stats_k[0][0] == (VIDEO_BATCH, 29, 44, 44, 24),
              f"fused sites {[s[0] for s in stats_k]}: the 24-channel frontend alone expected")
        before = launch_counts()
        with plain_maxpool(), plain_bn_prelu():
            loss_p, grads_p, stats_p = step(x)
            loss_n, grads_n, stats_n = step(x * (1.0 + NUDGE))
        check(not any(launches_since(before, VIDEO).values()),
              "the plain steps launched the kernels")
        seen: set = set()
        with trunk_dtypes(trainer.model.trunk, seen):
            loss_b, _, _ = step(x, torch.bfloat16)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    d_kp, d_np = grad_distance(grads_k, grads_p), grad_distance(grads_n, grads_p)
    s_kp = stat_distance(stats_k, stats_p, sites=1)[0]
    s_np = stat_distance(stats_n, stats_p, sites=1)[0]
    del grads_k, grads_p, grads_n
    log(f"ShuffleNet kernel vs plain step at bs {VIDEO_BATCH} x 29 (f32, cuDNN deterministic): "
        f"loss {loss_k:.8f} vs {loss_p:.8f} ({loss_rel:.2e} relative, bar {STEP_LOSS_RTOL}); "
        f"frontend batch statistics {s_kp:.2e} (bar {STEP_STAT_RTOL}; nudged {s_np:.2e}); "
        f"gradient distance {d_kp:.3e}, nudge {d_np:.3e} (ratio {d_kp / d_np:.2f}, bar "
        f"{NUDGE_FACTOR}); bf16 step loss {loss_b:.6f}, trunk unit types "
        f"{sorted(str(d)[6:] for d in seen)} [{smi}]")
    check(loss_rel <= STEP_LOSS_RTOL, f"ShuffleNet kernel-step loss {loss_rel:.3e} relative")
    check(s_kp <= STEP_STAT_RTOL, f"ShuffleNet frontend statistics {s_kp:.3e} from the plain")
    check(d_kp <= NUDGE_FACTOR * d_np, f"ShuffleNet kernel-step gradients {d_kp:.3e} from the "
          f"plain step; the nudge moves them {d_np:.3e}")
    check(seen == {torch.float32} and math.isfinite(loss_b),
          f"the bf16 ShuffleNet trunk ran in {seen}, float32 expected; loss {loss_b}")

    gen = torch.Generator().manual_seed(2)
    walls = {"bf16": [], "f32": []}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for name in ("f32", "bf16", "bf16", "f32"):
        trainer.compute_dtype = torch.bfloat16 if name == "bf16" else None
        trainer.train_step(clips, lengths, labels, gen)
        sync()
        for _ in range(2):
            t0 = time.perf_counter()
            trainer.train_step(clips, lengths, labels, gen)
            sync()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    ms = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    profiled = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name in ("f32", "bf16"):
        trainer.compute_dtype = torch.bfloat16 if name == "bf16" else None
        with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
            t0 = time.perf_counter()
            trainer.train_step(clips, lengths, labels, gen)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        kinds, busy = profile_kinds(prof, KERNEL_KINDS)
        top = sorted(((ev.self_device_time_total / 1e3, ev.key) for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA
                      and (getattr(ev, "self_device_time_total", 0) or 0) > 0),
                     key=lambda t: -t[0])[:6]
        convs = sorted(((getattr(ev, "device_time_total", 0) / 1e3, ev.key, ev.input_shapes[:2])
                        for ev in prof.key_averages(group_by_input_shape=True)
                        if ev.key in ("aten::cudnn_convolution", "aten::convolution_backward")),
                       key=lambda t: -t[0])[:4]
        profiled[name] = {"wall_ms": wall, "busy_ms": busy, "by_kind_ms": kinds,
                          "top_convs": [[k, t, str(sh)] for t, k, sh in convs],
                          "top_kernels": [[k[:120], t] for t, k in top]}
        log(f"profiled ShuffleNet {name} step: {wall:.1f} ms wall, {busy:.1f} ms of device "
            f"kernels; by kind: " + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
                kinds.items(), key=lambda kv: -kv[1]))
            + "; top convolutions " + "; ".join(f"{k} {t:.1f} ms {sh}" for t, k, sh in convs)
            + f" [{smi}]")
        for t, k in top:
            log(f"  {t:9.3f} ms  {k[:150]}")
    log(f"ShuffleNet Lipreading train step at bs {VIDEO_BATCH} x 29: f32 {ms['f32']:.1f} ms "
        f"({VIDEO_BATCH / ms['f32'] * 1e3:.1f} clips/s), bf16 {ms['bf16']:.1f} ms "
        f"({VIDEO_BATCH / ms['bf16'] * 1e3:.1f} clips/s), median of 4 each in turns; peak "
        f"{peak_gb} GB [{smi}]")
    trainer.compute_dtype = None
    return {"loss_rel": loss_rel, "stat_distance": s_kp, "grad_distance": d_kp,
            "nudge_distance": d_np, "step_launches": launches, "bf16_loss": loss_b,
            "trunk_dtypes": sorted(str(d) for d in seen), "step_ms": ms, "step_walls_ms": walls,
            "clips_per_sec": {k: VIDEO_BATCH / v * 1e3 for k, v in ms.items()},
            "peak_gb": peak_gb, "profiled": profiled}


def shufflenet_phase(root: str, smi: str, peaks, device=None) -> dict:
    """(c) ``conf/video_config.json`` with the ShuffleNetV2 trunk and the
    depthwise-separable TCN through ``cli/train_video.py``: one f32 and one
    bf16 epoch on phase 7's corpus, ``--extract-feats``, the step rule, the
    24-channel kernels and the reference ``.pth``."""
    dev_args = ["--device", device] if device else []
    data = os.path.join(root, "clips")
    write_clip_corpus(data)
    cfg = {**video_config(), **SHUFFLENET}
    cfg_path = os.path.join(root, "shufflenet.json")
    with open(cfg_path, "w") as fh:
        json.dump(cfg, fh)
    runs, trainer = {}, None
    for dtype in ("float32", "bf16"):
        calls: list = []
        with recording_bn_calls(calls):
            before = launch_counts()
            t0 = time.perf_counter()
            trainer, out = train_video_cli.main(
                ["--config-path", cfg_path, "--data-dir", data, "--compute-dtype", dtype,
                 "--batch-size", str(VIDEO_BATCH), "--epochs", "1", "--exp-root",
                 os.path.join(root, "exp"), "--log-time", f"shufflenet_{dtype}"] + dev_args)
            wall = time.perf_counter() - t0
            launches = launches_since(before, VIDEO)
        steps, losses = trainer.step, out["losses"]
        want = {"bn_prelu_fwd": 3 * steps, "bn_prelu_bwd": 3 * steps, "maxpool_fwd": steps,
                "maxpool_bwd": steps}
        check(launches == want, f"ShuffleNet {dtype} launches {launches}, expected {want}")
        check(steps >= 3 and all(math.isfinite(v) for v in losses),
              f"ShuffleNet {dtype}: {steps} steps, losses {losses}")
        check(trainer.model.backend_out == 1024
              and {s[-1] for s, _, _, _ in calls} == {24}, "not the 24-channel ShuffleNet")
        runs[dtype] = {"steps": steps, "losses": losses, "launches": launches, "wall_s": wall,
                       "shapes": sorted({shape for shape, _, _, _ in calls})}
        log(f"ShuffleNet Lipreading (width {cfg['width_mult']}, dwpw TCN) through "
            f"cli/train_video.py "
            f"--compute-dtype {dtype}, bs {VIDEO_BATCH}: {steps} steps, losses "
            f"{', '.join(f'{v:.4f}' for v in losses)}; launches {launches}; {wall:.1f} s wall "
            f"[{smi}]")
    net1 = os.path.join(trainer.exp_dir, "net_1")
    emb_root = os.path.join(root, "embedding")
    before = launch_counts()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        train_video_cli.main(["--config-path", cfg_path, "--data-dir", data, "--extract-feats",
                              "--batch-size", str(VIDEO_BATCH), "--model-path", net1,
                              "--mouth-embedding-out-path", emb_root] + dev_args)
    extract_launches = launches_since(before, VIDEO)
    written = {os.path.relpath(os.path.join(d, f), emb_root)[:-4]: np.load(os.path.join(d, f))
               ["data"] for d, _, files in os.walk(emb_root) for f in files}
    clips = scan_clip_dir(data)
    direct = VideoTrainer(cfg, trainer.num_classes, device=device)
    direct.load(net1)
    eval_batches = VideoClipBatches(clips, batch_size=VIDEO_BATCH, bucket_t=8, shuffle=False,
                                    pre_crop=(88, 88))
    want_feats = direct.extract_clip_features(eval_batches)
    ext_err = max(float(np.abs(written[n][0] - f).max()) for n, f in want_feats.items())
    check(sorted(written) == sorted(want_feats) and all(
        written[n].shape == (1, len(f), 1024) for n, f in want_feats.items())
        and ext_err <= 1e-5, f"--extract-feats npz differ from extract_clip_features by "
        f"{ext_err:.3e}")
    # the reference .pth: exported, read back into a fresh network, frame
    # features bit-equal
    ref = os.path.join(root, "shufflenet.pt")
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        export_torch_cli.main(["video", "--checkpoint", net1, "--out", ref])
    again = VideoTrainer(cfg, trainer.num_classes, device=device)
    again.model.load_state_dict(torch_import.load_reference_video_checkpoint(
        ref, again.model.state_dict()), strict=True)
    again_feats = again.extract_clip_features(eval_batches)
    pth_equal = all(np.array_equal(again_feats[n], f) for n, f in want_feats.items())
    check(pth_equal, "the ShuffleNet reference .pth extracts other frame features")
    log(f"ShuffleNet --extract-feats: {len(written)} (1, T, 1024) f32 npz, {ext_err:.1e} from "
        f"extract_clip_features, launches {extract_launches}; reference .pth round trip: frame "
        f"features bit-equal [{smi}]")
    rows = c24_kernel_rows(peaks)
    step = shufflenet_step_check(direct, full_clip_batch(clips), smi)
    return {"runs": runs, "extract_err": ext_err, "extract_launches": extract_launches,
            "pth_frame_features_equal": pth_equal, "c24": rows, **step}


def stft_phase(smi: str, device=None) -> dict:
    """(d) The config's ``stft`` section on a ragged 256 x 1-3 s batch with
    ``sample_lengths`` against float64, its time beside K1's MFCC time on
    the same batch, and one E-TDNN extraction batch at the ``stft`` width."""
    dev = torch.device(device or "cuda")
    opts = load_audio_config(AUDIO_CONFIG_PATH).to_dict()["data"]["python_data_config"]
    cfg = F.FeatureConfig.from_config({**opts, "feat_type": "stft"})
    raw = dataclasses.replace(cfg, normalize=False)
    mfcc = F.FeatureConfig.from_config(opts)
    pcm16, feat, lens = ragged_pcm_batch(BATCH, seed=31)
    pcm = torch.from_numpy(pcm16).to(dev).float() / 32768.0
    slen = torch.from_numpy(lens).to(dev)
    with fp32_math():
        got = F.stft_features(pcm, raw, sample_lengths=slen)
        want = F.stft_features(pcm.double(), raw, sample_lengths=slen)
        err = float((got.double() - want).abs().max())
        ms = time_ms(lambda: F.stft_features(pcm, raw, sample_lengths=slen), iters=10)
        k1_ms = time_ms(lambda: audio_features(pcm, mfcc, slen), iters=10)
    check(bool(torch.isfinite(got).all()) and err <= STFT_TOL,
          f"stft front-end {err:.3e} from float64, bar {STFT_TOL}")
    model = Config({"data": {"python_data_config": {**opts, "feat_type": "stft"}},
                    "model": ETDNN_MODEL_OPTS, "train": {"loss": "LMCL"}, "test": {}})
    ext = AudioExtractor(model, device=device)
    ext.load_state_dict(seeded_state_dict(ext.model, seed=0))
    before = launch_counts()
    emb = ext.embed(torch.from_numpy(pcm16).to(dev), torch.from_numpy(feat).to(dev), slen)
    launches = launches_since(before, FBANK)
    check(ext.model.tdnn[0].context_layer.in_channels == 257 and tuple(emb.shape) == (BATCH, 512)
          and bool(torch.isfinite(emb).all()) and launches == {"fft": 0, "mixed": 0},
          f"stft extraction: {tuple(emb.shape)}, launches {launches}")
    log(f"stft front-end (n_fft 512, 257 bins, librosa framing) on a ragged {BATCH} x 1-3 s "
        f"batch: {err:.2e} from float64 (bar {STFT_TOL}); {ms:.4f} ms, K1's MFCC on the same "
        f"batch {k1_ms:.4f} ms; one E-TDNN extraction batch at 257 features: "
        f"{tuple(emb.shape)}, front-end kernel launches {launches} [{smi}]")
    return {"err": err, "ms": ms, "k1_mfcc_ms": k1_ms, "extraction_launches": launches,
            "shape": list(pcm.shape)}


def variants_phase(smi: str, peaks, device=None) -> dict:
    """Phase 15; ``device`` is for rehearsing it on the CPU at a small size."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        manifest, trials = write_train_corpus(os.path.join(root, "audio"))
        resnet = resnet_phase(os.path.join(root, "audio"), manifest, trials, smi, peaks, device)
        release()
        attentive = attentive_phase(root, smi, device)
        release()
        shufflenet = shufflenet_phase(root, smi, peaks, device)
        release()
        stft = stft_phase(smi, device)
    wall = time.perf_counter() - t0
    log(f"phase 15: {wall:.1f} s")
    return {"resnet": resnet, "attentive": attentive, "shufflenet": shufflenet, "stft": stft,
            "wall_s": wall}


# ---------------------------------------------------------------- phase 16
KALDI_EPOCHS = 2
KALDI_LOG_EVERY = 2               # the Kaldi run logs every 2nd step: its TensorBoard file holds losses
KALDI_STEP_LOSS_RTOL = 1e-5       # a Kaldi-feature step vs the PCM step on the same crops, f32
MFU_FLOPS_RTOL = 0.10             # FlopCounterMode's count vs the hand count
HOST_PASSES = 3                   # passes of each host pipeline, timed alone
HOST_BATCHES = 8                  # batches a pass


def tdnn_train_flops(model, batch: int, frames: int) -> float:
    """Hand count of one E-TDNN train step's matrix work: the forward
    (:func:`tdnn_flops`), the weight gradients and the input gradients (each
    as large as the forward), less the first layer's input gradient, which
    no step needs (its input, the features, takes no gradient)."""
    conv = model.tdnn[0].context_layer
    t = frames - (conv.kernel_size[0] - 1) * conv.dilation[0]
    first = 2.0 * batch * t * conv.in_channels * conv.out_channels * conv.kernel_size[0]
    return 3.0 * tdnn_flops(model, batch, frames) - first


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, i


def _proto_fields(buf: bytes):
    """``(field, wire type, value)`` of a serialised protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        wire = key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise SmokeFailure(f"protobuf wire type {wire} in an event record")
        yield key >> 3, wire, value


def read_tb_scalars(path: str) -> list:
    """Every record of a TensorBoard event file, each length's and payload's
    masked CRC32C checked: ``(step, {tag: value})`` per event."""
    with open(path, "rb") as fh:
        data = fh.read()
    out, i = [], 0
    while i < len(data):
        check(len(data) - i >= 16, f"{path}: a record cut short at byte {i}")
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        check(struct.unpack("<I", data[i + 8:i + 12])[0] == tb_events._masked_crc(header),
              f"{path}: the length CRC of the record at byte {i}")
        payload = data[i + 12:i + 12 + n]
        check(len(payload) == n and data[i + 12 + n:i + 16 + n]
              == struct.pack("<I", tb_events._masked_crc(payload)),
              f"{path}: the payload CRC of the record at byte {i}")
        i += 16 + n
        step, scalars = 0, {}
        for num, wire, value in _proto_fields(payload):
            if num == 2 and wire == 0:
                step = value
            elif num == 5 and wire == 2:
                for _, _, entry in _proto_fields(value):
                    fields = {f: v for f, _, v in _proto_fields(entry)}
                    scalars[fields[1].decode()] = struct.unpack("<f", fields[2])[0]
        out.append((step, scalars))
    return out


def native_parity(root: str, clip_root: str) -> dict:
    """The native readers against the stdlib and ``np.load``, bit for bit,
    on every wav of phase 11's corpus and every clip of phase 7's."""
    check(native.available() and native.npy_available(),
          "the native IO library did not build (deeplip_tpu_torch/native/wavio.cpp)")
    paths = sorted(glob.glob(os.path.join(root, "s*", "*.wav")))
    for p in paths:
        got, rate = native.read_wav(p)
        want, want_rate = read_wav(p)
        check(rate == want_rate and got.dtype == want.dtype and np.array_equal(got, want),
              f"native.read_wav({p}) differs from the stdlib reader")
    lengths = [native.wav_info(p)[2] for p in paths]
    flat, offsets, wrote, _ = native.read_wav_batch_i16(paths, [0] * len(paths), lengths,
                                                        lengths, n_threads=8)
    for p, off, n in zip(paths, offsets, wrote):
        want, _ = read_wav_int16(p)
        check(n == len(want) and np.array_equal(flat[off:off + n], want),
              f"read_wav_batch_i16 differs from read_wav_int16 on {p}")
    clips = sorted(glob.glob(os.path.join(clip_root, "*", "*.npz")))
    arrays = native.read_npy_batch(clips, n_threads=8)
    shapes = native.probe_npy_shapes(clips, n_threads=8)
    for p, got, (shape, dtype) in zip(clips, arrays, shapes, strict=True):
        want = np.load(p)["data"]
        check(got.dtype == want.dtype == dtype and got.shape == want.shape == shape
              and np.array_equal(got, want), f"read_npy_batch differs from np.load on {p}")
    return {"wavs": len(paths), "wav_samples": int(sum(lengths)), "clips": len(clips)}


def native_loader_epoch(root: str, manifest: str, trials: str, device=None) -> dict:
    """One epoch of ``conf/audio_config.yaml`` with the default ``loader:
    native``, its batches bit-equal to ``loader: python``'s; K1 once a step."""
    cfg = load_audio_config(AUDIO_CONFIG_PATH).to_dict()
    cfg["data"].update(train_manifest=manifest, test_root=root, trial_grid=trials)
    check("loader" not in cfg["train"], "the shipped config names a loader")
    trainer = AudioTrainer(Config(cfg), device=device, exp_root=os.path.join(root, "exp"),
                           log_time="native")
    cfg["train"]["loader"] = "python"
    stdlib = AudioTrainer(Config(cfg), device=device, exp_root=os.path.join(root, "exp"),
                          log_time="python")
    check(trainer.pipeline.reader is native.read_wav and stdlib.pipeline.reader is read_wav,
          "loader: native did not pick the native reader")
    check(trainer.compute_dtype == torch.bfloat16 and trainer.batch_size == BATCH
          and len(trainer.pipeline.sampler.buckets) == 11
          and trainer.pipeline._resolve_transport() == "int16",
          "the trainer did not take conf/audio_config.yaml's recipe")
    batches = 0
    for a, b in zip(trainer.pipeline.epoch(1), stdlib.pipeline.epoch(1), strict=True):
        check(a["n_frames"] == b["n_frames"] and a["pcm"].dtype == b["pcm"].dtype
              and np.array_equal(a["pcm"], b["pcm"]) and np.array_equal(a["labels"], b["labels"]),
              f"batch {batches}: loader native and loader python differ")
        batches += 1
    before = launch_counts()
    t0 = time.perf_counter()
    losses = trainer.train(epochs=1)
    _sync()
    wall = time.perf_counter() - t0
    counts = launches_since(before, FBANK)
    check(trainer.step == batches and counts == {"fft": batches, "mixed": 0},
          f"front-end launches {counts} for {trainer.step} native-loader steps")
    check(all(math.isfinite(v) for v in losses), f"native-loader losses {losses}")
    return {"steps": trainer.step, "batches_equal": batches, "launches": counts,
            "losses": losses, "wall_s": wall, "trainer": trainer, "stdlib": stdlib}


def write_kaldi_features(root: str, manifest: str, feat_cfg, device) -> tuple[str, str, int]:
    """MFCC-24 of every training utterance by the port's front-end (K1 on
    the card) with CMVN over each utterance, written by ``interop.kaldi``
    as one ark/scp with a spk2utt, and read back bit-equal. Returns the
    spk2utt's and the scp's paths and the front-end launches."""
    speakers = SpeakerManifest.load(manifest).speakers
    items = [(f"s{s:03d}-u{u}", utt.path) for s, spk in enumerate(speakers)
             for u, utt in enumerate(spk)]
    cfg = dataclasses.replace(feat_cfg, normalize=False, delta=False)
    before = launch_counts()
    table = {}
    for i in range(0, len(items), 64):
        chunk = items[i:i + 64]
        pcms = [read_wav_int16(path)[0] for _, path in chunk]
        pcm = np.zeros((len(pcms), max(map(len, pcms))), np.int16)
        for row, y in enumerate(pcms):
            pcm[row, :len(y)] = y
        slen = torch.tensor([len(y) for y in pcms], dtype=torch.int32, device=device)
        flen = torch.tensor([num_frames(len(y), cfg.frame_len, cfg.frame_step) for y in pcms],
                            dtype=torch.int32, device=device)
        with torch.no_grad(), fp32_math():
            x = torch.from_numpy(pcm).to(device).float() / 32768.0
            feats = masked_cmvn(F.extract_features(x, cfg, sample_lengths=slen), flen)
        feats = feats.cpu().numpy()
        for row, (name, _) in enumerate(chunk):
            table[name] = feats[row, :int(flen[row])]
    launches = launches_since(before, FBANK)
    ark, scp = os.path.join(root, "feats.ark"), os.path.join(root, "feats.scp")
    write_ark_scp(table, ark, scp)
    spk2utt = os.path.join(root, "spk2utt")
    with open(spk2utt, "w") as fh:
        for s, spk in enumerate(speakers):
            fh.write(f"spk{s:03d} " + " ".join(f"s{s:03d}-u{u}" for u in range(len(spk))) + "\n")
    back = list(read_scp(scp))
    check([u for u, _ in back] == list(table)
          and all(np.array_equal(a, table[u]) for u, a in back),
          "the ark's features do not read back bit-equal")
    check(launches == {"fft": -(-len(items) // 64), "mixed": 0},
          f"front-end launches {launches} for the ark's {len(items)} utterances")
    return spk2utt, scp, launches["fft"]


def kaldi_train(root: str, spk2utt: str, scp: str, device=None) -> dict:
    """``conf/audio_config.yaml`` with ``data_format: kaldi`` for
    ``KALDI_EPOCHS`` epochs: no front-end launch."""
    cfg = load_audio_config(AUDIO_CONFIG_PATH).to_dict()
    cfg["data"].update(data_format="kaldi", kaldi_data_config={
        "trainset": {"nn_spk2utt": spk2utt, "nn_feat_scp": scp}})
    cfg["train"].update(epoch=KALDI_EPOCHS, log_every=KALDI_LOG_EVERY)
    trainer = AudioTrainer(Config(cfg), device=device, exp_root=os.path.join(root, "exp"),
                           log_time="kaldi")
    check(trainer.n_spk == TRAIN_SPEAKERS and trainer.manifest is None
          and isinstance(trainer.pipeline, KaldiTrainPipeline)
          and trainer.compute_dtype == torch.bfloat16 and trainer.batch_size == BATCH,
          f"the Kaldi trainer: {trainer.n_spk} speakers, pipeline {type(trainer.pipeline)}")
    before = launch_counts()
    t0 = time.perf_counter()
    losses = trainer.train()
    _sync()
    wall = time.perf_counter() - t0
    counts = launches_since(before, FBANK)
    bpe = trainer.pipeline.batches_per_epoch()
    check(counts == {"fft": 0, "mixed": 0}, f"the Kaldi steps launched the front-end: {counts}")
    check(trainer.step == len(losses) == KALDI_EPOCHS * bpe
          and all(math.isfinite(v) for v in losses), f"Kaldi losses {losses}")
    for tag in (f"net_{e}" for e in range(1, KALDI_EPOCHS + 1)):
        check(os.path.exists(os.path.join(trainer.exp_dir, tag)), f"no {tag} written")
    return {"trainer": trainer, "steps": trainer.step, "batches_per_epoch": bpe,
            "launches": counts, "losses": losses, "wall_s": wall}


def kaldi_step_check(trainer, pcm_pipeline, root: str, smi: str) -> dict:
    """From one state, f32: a step on a batch of crops' features read back
    from an ark against the PCM step on the same crops (loss
    ``KALDI_STEP_LOSS_RTOL``, gradients within ``NUDGE_FACTOR`` x what a
    ``NUDGE`` of the PCM moves the PCM step); then the bf16 steps of both
    kinds timed at ``STEP_FRAMES``, and their FLOPs counted at 300 frames."""
    dev, margin, cfg = trainer.device, trainer.init_margin, trainer.feat_cfg
    sids = next(pcm_pipeline.sampler.epoch(1))[0]
    batches = {n: pcm_pipeline._assemble(sids, n, (7, n)) for n in STEP_FRAMES}
    labels = torch.from_numpy(batches[300]["labels"]).to(dev)
    params = [(f"model.{n}", p) for n, p in trainer.model.named_parameters()] + [
        (f"criterion.{n}", p) for n, p in trainer.criterion.named_parameters()]
    state = (copy.deepcopy(trainer.model.state_dict()),
             copy.deepcopy(trainer.criterion.state_dict()),
             copy.deepcopy(trainer.optimizer.state_dict()), trainer.step)
    configured = trainer.compute_dtype

    def restore():
        trainer.model.load_state_dict(state[0])
        trainer.criterion.load_state_dict(state[1])
        trainer.optimizer.load_state_dict(state[2])
        trainer.step = state[3]
        trainer.compute_dtype = configured

    def step(fn):
        """One f32 step from ``state``: its loss and gradients."""
        trainer.compute_dtype = None
        loss = float(fn()["loss"])
        grads = {n: p.grad.detach().clone() for n, p in params}
        restore()
        return loss, grads

    def crop_features(pcm16):
        # the PCM step's own features: K1, then CMVN over each crop
        with torch.no_grad(), fp32_math():
            return F.extract_features(pcm16.float() / 32768.0, cfg)

    pcm16 = {n: torch.from_numpy(b["pcm"]).to(dev) for n, b in batches.items()}
    feats = crop_features(pcm16[300])
    ark, scp = os.path.join(root, "crops.ark"), os.path.join(root, "crops.scp")
    host = feats.cpu().numpy()
    write_ark_scp({f"crop{i}": host[i] for i in range(len(host))}, ark, scp)
    back = np.stack([a for _, a in read_scp(scp)])
    check(np.array_equal(back, host), "the crops' features do not read back bit-equal")
    feats_back = torch.from_numpy(back).to(dev)
    pcm = pcm16[300].float() / 32768.0
    gen = torch.Generator(device=dev).manual_seed(3)
    nudged = pcm * (1.0 + NUDGE * torch.randn(pcm.shape, generator=gen, device=dev))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        loss_p, grads_p = step(lambda: trainer.train_step(pcm, labels, margin))
        loss_f, grads_f = step(lambda: trainer.train_step_feats(feats_back, labels, margin))
        loss_n, grads_n = step(lambda: trainer.train_step(nudged, labels, margin))
    rel = abs(loss_f - loss_p) / abs(loss_p)
    d_fp, d_np = grad_distance(grads_f, grads_p), grad_distance(grads_n, grads_p)
    del grads_p, grads_f, grads_n
    log(f"Kaldi step vs PCM step at bs {BATCH} x 300 (f32, TF32 off, cuDNN deterministic; "
        f"the crops' features through an ark and back): loss {loss_f:.8f} vs {loss_p:.8f} "
        f"({rel:.2e} relative, bar {KALDI_STEP_LOSS_RTOL}); gradient distance {d_fp:.3e}, "
        f"the PCM nudged by {NUDGE} {d_np:.3e} (bar {NUDGE_FACTOR} x that)")
    check(rel <= KALDI_STEP_LOSS_RTOL, f"Kaldi-step loss {loss_f} vs PCM step {loss_p}: "
          f"{rel:.3e} relative, bar {KALDI_STEP_LOSS_RTOL}")
    check(d_fp <= NUDGE_FACTOR * d_np, f"Kaldi-step gradients {d_fp:.3e} from the PCM step; "
          f"a {NUDGE} nudge moves them {d_np:.3e}; bar {NUDGE_FACTOR} x that")

    rows = []
    for n in STEP_FRAMES:
        x = crop_features(pcm16[n])
        for kind, fn in (("kaldi", lambda: trainer.train_step_feats(x, labels, margin)),
                         ("pcm", lambda: trainer.train_step(pcm16[n], labels, margin))):
            trainer.compute_dtype = torch.bfloat16
            ms = time_ms(fn, iters=5, warmup=2)
            rows.append({"n_frames": n, "kind": kind, "dtype": "bf16", "step_ms": ms,
                         "crops_per_sec": BATCH / ms * 1e3})
        restore()
    for n in STEP_FRAMES:
        k, p = (next(r for r in rows if r["n_frames"] == n and r["kind"] == kind)
                for kind in ("kaldi", "pcm"))
        log(f"bf16 train step at bs {BATCH} x {n}: Kaldi features {k['step_ms']:.2f} ms "
            f"({k['crops_per_sec']:.1f} crops/s), PCM with K1 {p['step_ms']:.2f} ms "
            f"({p['crops_per_sec']:.1f} crops/s) [{smi}]")

    hand = tdnn_train_flops(trainer.model, BATCH, 300)
    mfu = {}
    x = crop_features(pcm16[300])
    for kind, fn in (("kaldi", lambda: trainer.train_step_feats(x, labels, margin)),
                     ("pcm", lambda: trainer.train_step(pcm16[300], labels, margin))):
        trainer.compute_dtype = torch.bfloat16
        counted = flops.counted_flops(fn)
        restore()
        ms = next(r["step_ms"] for r in rows if r["n_frames"] == 300 and r["kind"] == kind)
        gap = abs(counted - hand) / hand
        mfu[kind] = {"flops": counted, "hand_flops": hand, "flops_gap": gap, "step_ms": ms,
                     **flops.mfu_fields(counted, 1e3 / ms, device=dev)}
        check(gap <= MFU_FLOPS_RTOL, f"{kind} step: FlopCounterMode counts {counted:.4e}, the "
              f"hand count {hand:.4e} ({gap:.2%} apart, bar {MFU_FLOPS_RTOL:.0%})")
    log(f"MFU at bs {BATCH} x 300, bf16, against the dense bf16 peak of "
        f"{flops.peak_flops_per_sec(dev)} FLOP/s: " + ", ".join(
            f"{k} {v['flops'] / 1e9:.1f} GFLOP a step (hand count {v['hand_flops'] / 1e9:.1f}, "
            f"{v['flops_gap']:.2%} apart) in {v['step_ms']:.2f} ms = "
            f"{v.get('tflops_per_sec')} TFLOP/s, MFU {v.get('mfu')}" for k, v in mfu.items())
        + f" [{smi}]")
    return {"loss_rel": rel, "grad_distance": d_fp, "nudge_distance": d_np,
            "losses": {"pcm": loss_p, "kaldi": loss_f, "nudged": loss_n},
            "timings": rows, "mfu": mfu}


@contextlib.contextmanager
def numpy_clip_reader():
    """Clips read by ``np.load``, as on a host without the native library."""
    available = native.npy_available
    native.npy_available = lambda: False
    try:
        yield
    finally:
        native.npy_available = available


def host_rate(batches) -> dict:
    """Batches/s of a host pipeline alone: ``HOST_PASSES`` passes of
    ``HOST_BATCHES`` batches from ``batches()`` (an iterator over epochs),
    each timed on the host's clock; the median and the spread."""
    rates = []
    for _ in range(HOST_PASSES):
        t0 = time.perf_counter()
        n = sum(1 for _ in itertools.islice(batches(), HOST_BATCHES))
        rates.append(n / (time.perf_counter() - t0))
    return {"batches_per_sec": median(rates), "min": min(rates), "max": max(rates),
            "passes": rates, "batches": n}


def epochs_of(pipeline, first: int = 1):
    return lambda: itertools.chain.from_iterable(pipeline.epoch(e) for e in itertools.count(first))


def host_rates(loader: dict, kaldi, clip_root: str, step_ms: dict, smi: str) -> dict:
    """Each host pipeline alone, in batches/s on the card machine's host,
    beside the rate of the step it feeds (1 / step time); a pipeline slower
    than its step bounds the trainer."""
    clips = scan_clip_dir(clip_root)
    video = VideoClipBatches(clips, batch_size=VIDEO_BATCH, bucket_t=8, shuffle=True)
    rows = {}
    for name, batches, feeds in (
            ("audio_stdlib", epochs_of(loader["stdlib"].pipeline), "audio_bf16_300"),
            ("audio_native", epochs_of(loader["trainer"].pipeline), "audio_bf16_300"),
            ("kaldi", epochs_of(kaldi.pipeline), "kaldi_bf16_300"),
            ("video_native", epochs_of(video, 0), "video_bf16")):
        rows[name] = {**host_rate(batches), "feeds": feeds}
    with numpy_clip_reader():
        rows["video_np_load"] = {**host_rate(epochs_of(video, 0)), "feeds": "video_bf16"}
    for name, row in rows.items():
        row["step_ms"] = step_ms[row["feeds"]]
        row["step_batches_per_sec"] = 1e3 / row["step_ms"]
        row["bounds_the_trainer"] = row["batches_per_sec"] < row["step_batches_per_sec"]
        log(f"host pipeline {name}: {row['batches_per_sec']:.2f} batches/s median of "
            f"{HOST_PASSES} x {row['batches']} batches (spread {row['min']:.2f}-{row['max']:.2f})"
            f", the {row['feeds']} step it feeds takes {row['step_ms']:.2f} ms = "
            f"{row['step_batches_per_sec']:.2f} batches/s"
            + ("; the pipeline bounds the trainer" if row["bounds_the_trainer"] else "")
            + f" [host of {smi}]")
    return rows


def kaldi_xv_round_trip(store: EmbeddingStore, root: str) -> dict:
    """Phase 4's embeddings through ``EmbeddingStore.save_kaldi``, the
    ``kaldi_xv`` CLI's ``from-kaldi`` and ``to-kaldi``, and ``load_kaldi``:
    every vector and the ark's bytes unchanged."""
    ark, scp = os.path.join(root, "xvector.ark"), os.path.join(root, "xvector.scp")
    store.save_kaldi(ark, scp)
    tree, prefix = os.path.join(root, "xv_tree"), os.path.join(root, "back")
    kaldi_xv_cli.main(["from-kaldi", "--scp", scp, "--out-dir", tree])
    kaldi_xv_cli.main(["to-kaldi", "--scp", scp, "--xv-root", tree, "--out-prefix", prefix])
    back = EmbeddingStore.load_kaldi(prefix + "_xvector.scp")
    check(list(back.table) == list(store.table)
          and all(torch.equal(back[u], store[u].cpu()) for u in store.table),
          "x-vectors changed on the Kaldi round trip")
    with open(ark, "rb") as a, open(prefix + "_xvector.ark", "rb") as b:
        check(a.read() == b.read(), "the round trip's ark differs from the first ark")
    return {"vectors": len(back)}


def tb_check(exp_dir: str) -> dict:
    """The run's TensorBoard file parses, every record's CRC checked, and
    holds the losses the JSON records hold."""
    files = glob.glob(os.path.join(exp_dir, "tb", "events.out.tfevents.*"))
    check(len(files) == 1, f"{len(files)} event files in {exp_dir}/tb")
    records = read_tb_scalars(files[0])
    tb_losses = {step: s["train/loss"] for step, s in records if "train/loss" in s}
    with open(os.path.join(exp_dir, "train_metrics.jsonl")) as fh:
        want = {r["step"]: float(np.float32(r["loss"])) for r in map(json.loads, fh)}
    check(len(want) >= 1 and tb_losses == want,
          f"TensorBoard losses {tb_losses} vs the JSON records' {want}")
    return {"records": len(records), "losses": len(tb_losses)}


def kaldi_host_io_phase(smi: str, store: EmbeddingStore, video_step_ms: dict,
                        native_build_s: float, device=None) -> dict:
    """Phase 16; ``device`` is for rehearsing it on the CPU at a small size."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        audio, clip_root = os.path.join(root, "audio"), os.path.join(root, "clips")
        manifest, trials = write_train_corpus(audio)
        write_clip_corpus(clip_root)
        parity = native_parity(audio, clip_root)
        log(f"native IO library: built in {native_build_s:.2f} s (phase 2); "
            f"{parity['wavs']} wavs ({parity['wav_samples']} samples) by read_wav and "
            f"read_wav_batch_i16 bit-equal to the stdlib, {parity['clips']} clips by "
            f"read_npy_batch and probe_npy_shapes bit-equal to np.load")
        loader = native_loader_epoch(audio, manifest, trials, device)
        log(f"loader: native epoch of conf/audio_config.yaml: {loader['batches_equal']} batches "
            f"bit-equal to loader: python; {loader['steps']} steps, front-end launches "
            f"{loader['launches']}, losses {', '.join(f'{v:.4f}' for v in loader['losses'])}, "
            f"{loader['wall_s']:.2f} s wall [{smi}]")
        spk2utt, scp, feature_launches = write_kaldi_features(
            audio, manifest, loader["trainer"].feat_cfg, loader["trainer"].device)
        kaldi = kaldi_train(audio, spk2utt, scp, device)
        log(f"Kaldi training (conf/audio_config.yaml, data_format: kaldi, MFCC-24 + CMVN over "
            f"each utterance by K1 in {feature_launches} launches, through an ark): "
            f"{TRAIN_SPEAKERS} speakers, {KALDI_EPOCHS} epochs x {kaldi['batches_per_epoch']} "
            f"steps, losses {', '.join(f'{v:.4f}' for v in kaldi['losses'])}, front-end "
            f"launches {kaldi['launches']}, {kaldi['wall_s']:.2f} s wall [{smi}]")
        trainer = kaldi.pop("trainer")
        steps = kaldi_step_check(trainer, loader["trainer"].pipeline, audio, smi)
        tb = tb_check(trainer.exp_dir)
        step_ms = {f"{r['kind'] if r['kind'] == 'kaldi' else 'audio'}_bf16_{r['n_frames']}":
                   r["step_ms"] for r in steps["timings"]}
        step_ms["video_bf16"] = video_step_ms["bf16"]
        rates = host_rates(loader, trainer, clip_root, step_ms, smi)
        xv = kaldi_xv_round_trip(store, root)
        log(f"kaldi_xv: {xv['vectors']} x-vectors through save_kaldi, from-kaldi, to-kaldi and "
            f"load_kaldi bit-equal; TensorBoard file: {tb['records']} records, every CRC "
            f"checked, {tb['losses']} losses equal to the JSON records'")
        loader = {k: v for k, v in loader.items() if k not in ("trainer", "stdlib")}
    wall = time.perf_counter() - t0
    log(f"phase 16: {wall:.1f} s")
    return {"native_build_s": native_build_s, "native_parity": parity, "native_loader": loader,
            "kaldi_feature_launches": feature_launches, "kaldi_train": kaldi,
            "kaldi_steps": steps, "host_rates": rates, "kaldi_xv": xv, "tensorboard": tb,
            "wall_s": wall}


# ---------------------------------------------------------------- phase 17
GROUP_FRAMES = 300                # the audio steps' crop length
GROUP_AUDIO_K = 4                 # the grouped capture under the group
GROUP_TIMING_ITERS = {"audio": 10, "video": 2, "fusion": 5}
TOTALS_BYTES = {"fwd": (2, 2 + 2, 3), "bwd": (3, 3 + 2, 3 + 2)}  # see totals_bound_ms
VIDEO_BN_SITES = 9                # fused BN+PReLU sites of the ResNet Lipreading


def nccl_group(root: str):
    """A process group of world size 1 on the card (NCCL, a ``FileStore``
    under ``root``; no network), joined through the port's
    ``core.distributed.initialize``, and the data mesh over it."""
    from deeplip_tpu_torch.core.distributed import initialize
    from deeplip_tpu_torch.core.mesh import make_mesh

    check(torch.distributed.is_nccl_available(), "this torch build has no NCCL")
    check(initialize(f"file://{root}/nccl_store", num_processes=1, process_id=0),
          "no process group was created")
    check(torch.distributed.get_backend() == "nccl",
          f"the group's backend is {torch.distributed.get_backend()}, not nccl")
    mesh = make_mesh()
    check(mesh.data_group is not None and mesh.data_size == 1, "the data mesh has no group")
    return mesh


def totals_bound_ms(chunks: int, c: int, peaks, kind: str) -> tuple[float, str]:
    """The least time of a split finalize (both passes): it reads the
    ``(chunks, k, C)`` f32 partials once, writes and reads the ``(k, C)``
    float64 totals, and writes the statistics (fwd: mean, var, inv; bwd: the
    f32 sums and two means), adding the partials in double. The adds are
    counted at the FP32 rate: the guide's table has no FP64 rate."""
    fp32, _, bw = peaks
    k, tot, out = TOTALS_BYTES[kind]
    nbytes = 4 * chunks * k * c + 8 * tot * c + 4 * out * c
    bytes_ms, ops_ms = nbytes / bw * 1e3, chunks * k * c / fp32 * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def totals_pass_times(x, dy, mean, inv, scale, bias, alpha, eps, group, peaks) -> dict:
    """The split finalize passes alone (totals, then statistics), timed on
    partials the partial passes wrote, beside their plain version (a float64
    sum of the partials and the statistics in torch), their bound and the
    world-size-1 all-reduce of the totals between them."""
    c = x.shape[-1]
    rows = x.numel() // c
    per, chunks = bn_prelu._chunking(rows, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    is_bf16, stream = bn_prelu._device_args(x)
    ptrs = (mean.data_ptr(), inv.data_ptr(), scale.data_ptr(), bias.data_ptr(), alpha.data_ptr())
    fwd_partial, bwd_partial = torch.empty((chunks, 2, c), **f32), torch.empty((chunks, 3, c), **f32)
    launch = lambda name, *args: build.launch(bn_prelu._entry(name), *args)  # noqa: E731
    launch("bn_stats_partial", x.data_ptr(), is_bf16, fwd_partial.data_ptr(), rows, c, per,
           chunks, stream)
    launch("bn_prelu_bwd_partial", x.data_ptr(), dy.data_ptr(), is_bf16, *ptrs,
           bwd_partial.data_ptr(), rows, c, per, chunks, stream)
    fwd_totals = torch.empty((2, c), dtype=torch.float64, device=x.device)
    bwd_totals = torch.empty((3, c), dtype=torch.float64, device=x.device)
    stats, sums, means = torch.empty((3, c), **f32), torch.empty((3, c), **f32), \
        torch.empty((2, c), **f32)

    def fwd():
        launch("bn_stats_totals", fwd_partial.data_ptr(), chunks, c, fwd_totals.data_ptr(),
               stream)
        launch("bn_stats_from_totals", fwd_totals.data_ptr(), c, rows, eps, stats[0].data_ptr(),
               stats[1].data_ptr(), stats[2].data_ptr(), stream)

    def fwd_plain():
        t = fwd_partial.double().sum(0)
        m = t[0] / rows
        v = torch.clamp(t[1] / rows - m * m, min=0.0)
        return m.float(), v.float(), torch.rsqrt(v + eps).float()

    def bwd():
        launch("bn_prelu_bwd_totals", bwd_partial.data_ptr(), chunks, c, bwd_totals.data_ptr(),
               sums.data_ptr(), stream)
        launch("bn_prelu_bwd_from_totals", bwd_totals.data_ptr(), c, rows, means.data_ptr(),
               stream)

    def bwd_plain():
        t = bwd_partial.double().sum(0)
        return t.float(), (t[:2] / rows).float()

    with torch.cuda.device(x.device):
        times = {"fwd": time_ms(fwd), "fwd_plain": time_ms(fwd_plain), "bwd": time_ms(bwd),
                 "bwd_plain": time_ms(bwd_plain),
                 "all_reduce_fwd": time_ms(lambda: torch.distributed.all_reduce(
                     fwd_totals, group=group)),
                 "all_reduce_bwd": time_ms(lambda: torch.distributed.all_reduce(
                     bwd_totals, group=group))}
    for kind in ("fwd", "bwd"):
        times[f"{kind}_bound"], times[f"{kind}_bound_by"] = totals_bound_ms(chunks, c, peaks, kind)
    times["chunks"] = chunks
    return times


def totals_check(mesh, peaks) -> dict:
    """K3/K4 under the group (the split finalize and the all-reduce of the
    float64 totals between its passes) at the nine sites' shapes of a bs 128
    x 29 step, f32 and bf16: every output bit-equal to the single-process
    kernels' (and the group's launches 4 a call, 2 of them the split
    passes); against their plain versions under the same group with phase
    6's bars; the split passes timed alone."""
    group, eps, rows = mesh.data_group, 1e-5, []
    fwd, bwd = bn_prelu.bn_prelu_forward, bn_prelu.bn_prelu_backward
    with fp32_math():
        for i, (shape, sites) in enumerate(BN_SHAPES):
            for dtype in (torch.float32, torch.bfloat16):
                x, dy, scale, bias, alpha = bn_inputs(shape, dtype, 100 + i)
                what = f"bn_prelu under the group {shape} {str(dtype)[6:]}"
                atol, rtol = BN_TOL[dtype]
                single = fwd(x, scale, bias, alpha, eps)
                before = launch_counts()
                grouped = fwd(x, scale, bias, alpha, eps, group=group)
                moved = launches_since(before, ("bn_prelu_fwd", "bn_totals_fwd"))
                check(tuple(moved.values()) == (4, 2),
                      f"{what}: K3 under a group launched {moved} kernels")
                check(all(bit_equal(a, b) for a, b in zip(grouped, single)),
                      f"{what}: K3's split finalize is not bit-equal to its finalize")
                y_p, mean_p, var_p = bn_prelu.bn_prelu_reference(x, scale, bias, alpha, eps,
                                                                 group=group)
                err = {"y": compare_tol(grouped[0], y_p, atol, rtol, what + " y"),
                       "mean": compare_tol(grouped[1], mean_p, *STAT_TOL, what + " mean"),
                       "var": compare_tol(grouped[2], var_p, *STAT_TOL, what + " var")}
                mean, inv = single[1], single[3]
                del single, grouped, y_p
                g_single = bwd(x, dy, mean, inv, scale, bias, alpha)
                before = launch_counts()
                g_group = bwd(x, dy, mean, inv, scale, bias, alpha, group=group)
                moved = launches_since(before, ("bn_prelu_bwd", "bn_totals_bwd"))
                check(tuple(moved.values()) == (4, 2),
                      f"{what}: K4 under a group launched {moved} kernels")
                check(all(bit_equal(a, b) for a, b in zip(g_group, g_single)),
                      f"{what}: K4's split finalize is not bit-equal to its finalize")
                g_plain = bn_prelu.bn_prelu_backward_reference(x, dy, mean, inv, scale, bias,
                                                               alpha, group=group)
                err["dx"] = compare_tol(g_group[0], g_plain[0], atol, rtol, what + " dx")
                for name, got, want in zip(("dscale", "dbias", "dalpha"), g_group[1:],
                                           g_plain[1:]):
                    rel = float((got - want).abs().max()) / float(want.abs().max())
                    check(rel <= PARAM_GRAD_RTOL, f"{what} {name}: {rel:.3e} of the plain "
                          f"largest, bar {PARAM_GRAD_RTOL}")
                    err[name] = rel
                del g_single, g_group, g_plain
                times = totals_pass_times(x, dy, mean, inv, scale, bias, alpha, eps, group,
                                          peaks)
                del x, dy
                torch.cuda.empty_cache()
                rows.append({"shape": list(shape), "dtype": str(dtype)[6:], "sites": sites,
                             "bit_equal": True, **{f"err_{k}": v for k, v in err.items()},
                             **times})
                log(f"{what}: bit-equal to the single-process kernels; vs plain "
                    + ", ".join(f"{k} {v:.2e}" for k, v in err.items()) + "; split passes ms "
                    + ", ".join(f"{k} {v:.4f}" for k, v in times.items()
                                if not k.endswith("_by") and k != "chunks"))
    f32 = [r for r in rows if r["dtype"] == "float32"]
    per_step = {k: sum(r["sites"] * r[k] for r in f32) for k in (
        "fwd", "fwd_plain", "fwd_bound", "bwd", "bwd_plain", "bwd_bound", "all_reduce_fwd",
        "all_reduce_bwd")}
    log("split finalize per bs 128 x 29 step (9 sites, f32): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in per_step.items()))
    return {"rows": rows, "per_step": per_step}


def trainer_state(*modules) -> dict:
    """Every floating parameter and buffer of the modules, by name."""
    return {f"{i}.{n}": v.detach().clone() for i, m in enumerate(modules)
            for n, v in m.state_dict().items() if v.is_floating_point()}


def paired_step(what: str, trainers: dict, step, modules, keys: tuple, smi: str) -> dict:
    """One step of the trainer without a group and of the one under the
    world-size-1 group, from one state (the same seeded init, the same
    inputs, the card's generator reseeded): loss and every floating
    parameter and buffer bit-equal, and each step's launches of ``keys``
    and of the split finalize. Then ms per step of each, in turns (plain,
    group, group, plain), by CUDA events."""
    states = {k: trainer_state(*modules(t)) for k, t in trainers.items()}
    check(all(bit_equal(states["plain"][n], v) for n, v in states["group"].items()),
          f"{what}: the two trainers do not start from one state")
    losses, launches = {}, {}
    for name in ("plain", "group"):
        before = launch_counts()
        torch.manual_seed(0)
        losses[name] = step(trainers[name])["loss"]
        _sync()
        launches[name] = launches_since(before, keys + TOTALS)
    after = {k: trainer_state(*modules(t)) for k, t in trainers.items()}
    equal = bit_equal(losses["plain"], losses["group"]) and all(
        bit_equal(after["plain"][n], v) for n, v in after["group"].items())
    iters = GROUP_TIMING_ITERS[what.split()[0]]
    ms = {"plain": [], "group": []}
    for name in ("plain", "group", "group", "plain"):
        ms[name].append(time_ms(lambda: step(trainers[name]), iters=iters, warmup=1))
    out = {"loss": float(losses["plain"]), "bit_equal": equal, "launches": launches,
           "ms": {k: sum(v) / len(v) for k, v in ms.items()}, "ms_turns": ms}
    out["group_cost"] = out["ms"]["group"] / out["ms"]["plain"] - 1.0
    log(f"{what} step under an NCCL group of world size 1: loss and every parameter and "
        f"buffer {'bit-equal to' if equal else 'DIFFER from'} the step without it; "
        f"{out['ms']['plain']:.2f} ms without, {out['ms']['group']:.2f} ms with the group "
        f"({out['group_cost']:+.2%}); launches {launches} [{smi}]")
    check(equal, f"{what}: the step under the group is not bit-equal to the step without it")
    return out


def group_audio_config(dtype: str, k: int = 1) -> Config:
    cfg = load_audio_config(AUDIO_CONFIG_PATH).to_dict()
    cfg["data"]["train_manifest"] = None
    cfg["train"].update(compute_dtype=dtype, steps_per_dispatch=k)
    return Config(cfg)


def group_audio_batch(k: int, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    s = samples_for_frames(GROUP_FRAMES, 0.025, 0.01, RATE)
    pcm = rng.integers(-8000, 8000, (k, BATCH, s)).astype(np.int16)
    labels = rng.integers(0, TRAIN_SPEAKERS, (k, BATCH)).astype(np.int64)
    return torch.from_numpy(pcm).to(dev), torch.from_numpy(labels).to(dev)


def group_steps(mesh, root: str, smi: str, device=None) -> dict:
    """One audio bf16, one video f32 and one fusion f32 step under the group
    against the same step without it (:func:`paired_step`)."""
    out, dev = {}, torch.device(device or "cuda")
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        # audio: conf/audio_config.yaml's bf16 recipe at bs 256 x 300
        pcm, labels = group_audio_batch(1, 21, dev)
        audio = {name: AudioTrainer(group_audio_config("bf16"), device=device,
                                    n_spk=TRAIN_SPEAKERS, exp_root=os.path.join(root, "exp"),
                                    log_time=f"a_{name}", mesh=m)
                 for name, m in (("plain", None), ("group", mesh))}
        # T takes no group's statistics yet, so the step under the group keeps
        # the TDNN blocks' eager ops: both steps take them here
        with eager_tdnn_blocks():
            out["audio"] = paired_step(
                "audio bf16 (bs 256 x 300)", audio,
                lambda t: t.train_step(pcm[0], labels[0], t.init_margin),
                lambda t: (t.model, t.criterion), FBANK, smi)
        check(out["audio"]["launches"]["group"]["fft"] == 1, "the audio step skipped K1")
        del audio, pcm, labels
        release()
        # video: conf/video_config.json at bs 128 x 29, f32
        rng = np.random.default_rng(22)
        clips = torch.from_numpy(rng.integers(0, 256, (VIDEO_BATCH, 29, 96, 96), dtype=np.uint8))
        lengths = torch.from_numpy(rng.integers(21, 30, VIDEO_BATCH).astype(np.int32))
        vlabels = torch.from_numpy(rng.integers(0, VIDEO_SPEAKERS, VIDEO_BATCH))
        batch = [t.to(dev) for t in (clips, lengths, vlabels)]
        video = {name: VideoTrainer(video_config(), VIDEO_SPEAKERS, device=device,
                                    exp_root=os.path.join(root, "exp"), log_time=f"v_{name}",
                                    mesh=m) for name, m in (("plain", None), ("group", mesh))}
        out["video"] = paired_step(
            "video f32 (bs 128 x 29)", video,
            lambda t: t.train_step(*batch, torch.Generator().manual_seed(5)),
            lambda t: (t.model,), VIDEO, smi)
        sites = VIDEO_BN_SITES
        want = {name: {"bn_prelu_fwd": per * sites, "bn_prelu_bwd": per * sites,
                       "bn_totals_fwd": split * sites, "bn_totals_bwd": split * sites,
                       "maxpool_fwd": 1, "maxpool_bwd": 1}
                for name, per, split in (("plain", 3, 0), ("group", 4, 2))}
        check(out["video"]["launches"] == want,
              f"video launches {out['video']['launches']}, expected {want}")
        del video, batch
        release()
        # fusion: conf/fusion_config.yaml's train width at bs 60 x 300, f32
        cfg = load_fusion_config(FUSION_CONFIG_PATH)
        cfg.data["train_manifest"] = None
        cfg.train["n_spk"] = FUSION_SPEAKERS
        for key in ("audio_config", "video_config"):
            cfg.train[key]["resume"] = None
        fusion = {name: make_trainer(cfg, os.path.join(root, "exp"), f"f_{name}",
                                     device=device, mesh=m)
                  for name, m in (("plain", None), ("group", mesh))}
        rng = np.random.default_rng(23)
        s = samples_for_frames(GROUP_FRAMES, 0.025, 0.01, RATE)
        fb = [torch.from_numpy(a).to(dev) for a in (
            rng.standard_normal((FUSION_BATCH, s)).astype(np.float32) * 0.1,
            rng.integers(0, 256, (FUSION_BATCH, FUSION_CLIPS, FUSION_CLIP_FRAMES, 96, 96),
                         dtype=np.uint8),
            np.full((FUSION_BATCH, FUSION_CLIPS), FUSION_CLIP_FRAMES, np.int32),
            (np.arange(FUSION_BATCH) % FUSION_NO_CLIP != 0).astype(np.int32) * FUSION_CLIPS,
            rng.integers(0, FUSION_SPEAKERS, FUSION_BATCH).astype(np.int64))]
        out["fusion"] = paired_step(
            "fusion f32 (bs 60 x 300)", fusion, lambda t: t.train_step(*fb),
            lambda t: (t.fusion_head, t.criterion), FBANK + VIDEO, smi)
        del fusion, fb
        release()
    return out


def group_capture(mesh, root: str, smi: str, device=None) -> dict:
    """A grouped audio capture (K = 4, f32 at bs 256 x 300) under the group:
    the gradient, BN and metric all-reduces inside the CUDA graph. Held to
    phase 14's bars against 4 single steps under the same group from one
    state: each loss within 1e-5 relative, the final parameters no further
    than 3x what a 1e-6 nudge of the PCM moves the single run."""
    dev = torch.device(device or "cuda")
    pcm, labels = group_audio_batch(GROUP_AUDIO_K, 24, dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    pcm_f = pcm.float() / 32768.0
    nudged = pcm_f * (1.0 + NUDGE * torch.randn(pcm_f.shape, generator=gen, device=dev))
    runs = {}
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for name in ("grouped", "single", "nudged"):
            trainer = AudioTrainer(group_audio_config("float32", GROUP_AUDIO_K), device=device,
                                   n_spk=TRAIN_SPEAKERS, exp_root=os.path.join(root, "exp"),
                                   log_time=f"g_{name}", mesh=mesh)
            margin = trainer.init_margin
            before = launch_counts()
            if name == "grouped":
                losses = [float(v) for v in trainer.train_group(pcm, labels, margin)["loss"]]
                runner = trainer.grouped
                extra = {"graphs": len(runner.graphs), "warmups": runner.warmup_steps,
                         "replays": sum(e.replays for e in runner.graphs.values())}
            else:
                source = nudged if name == "nudged" else pcm
                losses = [float(trainer.train_step(source[i], labels[i], margin)["loss"])
                          for i in range(GROUP_AUDIO_K)]
                extra = {}
            _sync()
            runs[name] = {"losses": losses, "launches": launches_since(before, FBANK),
                          "state": floating_state(trainer.model, trainer.criterion), **extra}
            del trainer
            release()
    rel = loss_rel(runs["grouped"]["losses"], runs["single"]["losses"])
    d_group = grad_distance(runs["grouped"]["state"], runs["single"]["state"])
    d_nudge = grad_distance(runs["nudged"]["state"], runs["single"]["state"])
    g = runs["grouped"]
    log(f"grouped audio capture under the group (K = {GROUP_AUDIO_K}, f32, bs {BATCH} x "
        f"{GROUP_FRAMES}): {g['graphs']} graph, {g['replays']} replay, {g['warmups']} eager "
        f"warm-up steps; losses within {rel:.2e} of the single steps'; parameters "
        f"{d_group:.3e} of their norm from theirs, a {NUDGE} nudge moves them {d_nudge:.3e}; K1 launches "
        f"{g['launches']} [{smi}]")
    check(g["graphs"] == 1 and g["replays"] == 1, "the group was not captured and replayed")
    check(g["launches"] == {"fft": GROUP_AUDIO_K + g["warmups"], "mixed": 0},
          f"the grouped capture launched {g['launches']}")
    check(rel <= GROUPED_LOSS_RTOL, f"grouped losses under the group {rel:.3e} from single")
    check(0 < d_nudge and d_group <= NUDGE_FACTOR * d_nudge,
          f"grouped parameters under the group {d_group:.3e} from the single run's")
    return {"loss_rel": rel, "distance": d_group, "nudge_distance": d_nudge,
            **{k: g[k] for k in ("graphs", "replays", "warmups", "launches")}}


def process_group_phase(smi: str, peaks) -> dict:
    """Phase 17: an NCCL process group of world size 1 on the card."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        mesh = nccl_group(root)
        try:
            totals = totals_check(mesh, peaks)
            steps = group_steps(mesh, root, smi)
            capture = group_capture(mesh, root, smi)
        finally:
            torch.distributed.destroy_process_group()
    wall = time.perf_counter() - t0
    log(f"phase 17: {wall:.1f} s")
    return {"totals": totals, "steps": steps, "grouped_capture": capture, "wall_s": wall}


# ---------------------------------------------------------------- phase 19
TOOL_TIMEOUT_S = 600            # each verification subprocess's whole run
PREP_SPEAKERS, PREP_UTTS, PREP_RATE = 4, 3, 44100   # the 44.1 kHz tree prepare_data resamples


# CPU threads of each verification process: the protocol's, and each of the two
# lanes that run beside it, share the card machine's 8 cores
FULL_THREADS, LANE_THREADS = 4, 2


def start_tool(module: str, args: list, root: str, tag: str,
                 threads: int = LANE_THREADS) -> dict:
    """Start ``python -m deeplip_tpu_torch.<module> ARGS`` in a process of
    its own, on the card (no ``--device``), with ``threads`` CPU threads,
    its output into files under ``root``."""
    out, err = (open(os.path.join(root, f"{tag}.{k}"), "w+") for k in ("out", "err"))
    env = {**os.environ, "OMP_NUM_THREADS": str(threads)}
    proc = subprocess.Popen([sys.executable, "-m", f"deeplip_tpu_torch.{module}", *args],
                            cwd=REPO, stdout=out, stderr=err, text=True, env=env)
    return {"proc": proc, "out": out, "err": err, "t0": time.perf_counter()}


def finish_tool(run: dict, what: str, report: str | None = None) -> dict:
    """Wait for a :func:`start_tool` process. A nonzero exit fails the
    phase. Returns its JSON report (the ``--report`` file, else the last
    line of its output) with its wall seconds under ``"process_s"``."""
    try:
        rc = run["proc"].wait(timeout=TOOL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        run["proc"].kill()
        run["proc"].wait()
        raise
    seconds = time.perf_counter() - run["t0"]
    stdout, stderr = (run[k].seek(0) or run[k].read() for k in ("out", "err"))
    run["out"].close()
    run["err"].close()
    for line in stderr.splitlines()[-6:]:
        log(f"  {what}: {line}")
    check(rc == 0, f"{what} exited {rc}: {stdout[-1500:]} {stderr[-1500:]}")
    if report is not None:
        with open(report) as fh:
            out = json.load(fh)
    else:
        out = json.loads(stdout.strip().splitlines()[-1])
    out["process_s"] = seconds
    return out


def run_tool(module: str, args: list, what: str, root: str,
               report: str | None = None) -> dict:
    """:func:`start_tool`, then :func:`finish_tool`."""
    return finish_tool(start_tool(module, args, root, module.split(".")[-1]), what, report)


def write_prep_tree(root: str, seed: int = 0) -> dict:
    """A 44.1 kHz PCM16 wav tree (``<spk>/[take2/]u<i>.wav``, mono and
    stereo) for ``prepare_data audio``; returns each wav's samples by its
    path under ``root``."""
    rng = np.random.default_rng(seed)
    lengths = {}
    for spk in range(PREP_SPEAKERS):
        for u in range(PREP_UTTS):
            rel = os.path.join(f"s{spk:02d}", "take2" if u == 2 else "", f"u{u}.wav")
            path = os.path.join(root, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            n = int(rng.integers(PREP_RATE, 2 * PREP_RATE))
            y = 0.3 * rng.standard_normal((n, 2) if u == 1 else n)
            write_wav(path, y.astype(np.float32), PREP_RATE)
            lengths[os.path.normpath(rel)] = n
    return lengths


def prepare_data_check(root: str) -> dict:
    """``prepare_data audio --resample 16000`` on :func:`write_prep_tree`:
    the manifest lists every wav once, by speaker, at 16 kHz, and each
    output has ``resampled_length`` samples."""
    src, dst = os.path.join(root, "wav44k"), os.path.join(root, "wav16k")
    lengths = write_prep_tree(src)
    manifest = os.path.join(root, "manifest", "train.csv")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deeplip_tpu_torch.cli.prepare_data", "audio",
                           "--root", src, "--out", manifest, "--resample", "16000",
                           "--resampled-root", dst], cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=TOOL_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"prepare_data exited {proc.returncode}: {proc.stderr[-1500:]}")
    rows = SpeakerManifest.load(manifest)
    got = {}
    for sid, utt in rows.all_utterances():
        rel = os.path.relpath(utt.path, dst)
        y, rate = read_wav(utt.path)
        want = resampled_length(lengths[rel], PREP_RATE, 16000)
        check(rate == 16000 == utt.rate and len(y) == want
              and abs(utt.duration - want / 16000) < 1e-9 and rel.startswith(f"s{sid:02d}"),
              f"prepare_data: {rel} has {len(y)} samples at {rate} Hz, the manifest "
              f"{utt.duration} s at {utt.rate} Hz; {want} samples expected")
        got[rel] = len(y)
    check(sorted(got) == sorted(lengths), f"prepare_data listed {sorted(got)}, the tree holds "
          f"{sorted(lengths)}")
    log(f"prepare_data audio --resample 16000: {len(got)} wavs of {PREP_SPEAKERS} speakers, "
        f"44.1 kHz mono and stereo -> 16 kHz, every length resampled_length's; {seconds:.1f} s")
    return {"wavs": len(got), "speakers": rows.n_spk, "process_s": seconds,
            "stdout": proc.stdout.strip()}


def parity_tools(root: str, smi: str, out: dict) -> None:
    """Phase 19's train-parity modes, one after another, their reports into
    ``out``."""
    report = lambda name: os.path.join(root, name + ".json")  # noqa: E731
    audio = run_tool("cli.parity_check", ["--train-parity", "--report", report("tp")],
                       "parity_check --train-parity", root, report("tp"))
    for case in ("CrossEntropy_float32", "LMCL_float64", "LMCL_float32"):
        r = audio[case]
        log(f"parity_check --train-parity {case} ({'held' if r['enforced'] else 'reported'}; "
            f"the port on {r['device']}): final parameter drift "
            f"{r['final_param_max_drift']:.3e}, BN statistics "
            f"{r['final_batch_stats_max_drift']:.3e}, losses within "
            f"{r['max_loss_abs_diff']:.3e} (bar 1e-5 where held)")
        check(not r["enforced"] or r["param_drift_bar_1e-5"], f"{case}: {r}")
    log(f"parity_check --train-parity: T launches "
        f"{ {k: audio['launches'][k] for k in ('tdnn_fwd', 'tdnn_bwd', 'tdnn_eval')} } [{smi}]")
    check(audio["launches"]["tdnn_fwd"] > 0 and audio["launches"]["tdnn_bwd"] > 0,
          f"parity_check --train-parity: T's train kernels never ran: {audio['launches']}")
    out["train_parity"] = audio

    for kind, kernels in (("video", ("bn_prelu_fwd", "bn_prelu_bwd", "maxpool_fwd",
                                     "maxpool_bwd")),
                          ("fusion", ("fft", "maxpool_fwd", "tdnn_eval"))):
        r = run_tool("cli.parity_check", [f"--train-parity-{kind}", "--report", report(kind)],
                       f"parity_check --train-parity-{kind}", root, report(kind))
        log(f"parity_check --train-parity-{kind} (float32, the port on the card, "
            f"{r['steps']} steps): " + step_rule_text(r)
            + f"; launches { {k: r['launches'][k] for k in kernels} } [{smi}]")
        check(r["f32_step_rule"] and all(r["launches"][k] > 0 for k in kernels),
              f"parity_check --train-parity-{kind}: {r}")
        out[f"train_parity_{kind}"] = r
    out["train_parity_video_planted_k4"] = planted_k4_parity(smi)


def step_rule_text(r: dict) -> str:
    """The f32 step rule's numbers in a report of ``cli/parity_check.py``."""
    nums = lambda key: ", ".join(f"{v:.2e}" for v in r[key])  # noqa: E731
    grads = (f", first-step gradients {r['first_grad_distance']:.3e} of their norm from the "
             f"replica's (bar {r['grad_distance_bar']:.3e}; nudged "
             f"{nums('nudge_grad_distances')})" if "first_grad_distance" in r else "")
    return (f"first loss {r['first_loss_rel_diff']:.2e} relative (bar 1e-5), every loss within "
            f"{r['max_loss_rel_diff']:.3e} (bar {r['loss_rel_bar']:.3e}; the nudged replicas "
            f"{nums('nudge_max_loss_rel_diffs')})" + grads + f", final parameters "
            f"{r['final_param_distance']:.3e} of their norm from the replica's (bar "
            f"{r['param_distance_bar']:.3e}; nudged {nums('nudge_param_distances')})")


def k4_dx_scaled(factor: float):
    """K4 with its dx scaled by ``factor``, a planted fault (the kernel still
    launches, and is counted)."""
    k4 = bn_prelu.bn_prelu_backward

    def faulty(*args, **kwargs):
        dx, *rest = k4(*args, **kwargs)
        return (dx * factor, *rest)
    return faulty


def planted_k4_parity(smi: str) -> dict:
    """The video train parity of ``cli/parity_check.py`` on the card, as
    ``--train-parity-video`` runs it, with a planted fault: K4's dx scaled
    by 1.01 (the kernel still launches). Adam is nearly blind to it in the
    losses and the parameters, so the f32 step rule must fail it by the
    first-step gradients."""
    threads = torch.get_num_threads()
    torch.set_num_threads(LANE_THREADS)   # the replica's CPU runs share the lane's cores
    try:
        with plain_bn_prelu(forward=None, backward=k4_dx_scaled(1.01)):
            r = parity_check_cli.run_video_train_parity(
                dtype="float32", device="cuda", seed=parity_check_cli.VIDEO_F32_SEED)
    finally:
        torch.set_num_threads(threads)
    log(f"parity_check's video f32 step rule with K4's dx scaled by 1.01 (planted): "
        + step_rule_text(r) + f"; {'passed' if r['f32_step_rule'] else 'failed'} [{smi}]")
    check(not r["f32_step_rule"] and r["first_grad_distance"] > r["grad_distance_bar"],
          f"the f32 step rule passed a planted K4 fault: {r}")
    return r


def demo_tools(root: str, smi: str, out: dict) -> None:
    """Phase 19's demos and data preparation, one after another, their
    reports into ``out``."""
    demo = run_tool("examples.full_pipeline_demo", ["--workdir", os.path.join(root, "demo")],
                      "full_pipeline_demo", root)
    kernels = ("fft", "bn_prelu_fwd", "bn_prelu_bwd", "maxpool_fwd", "maxpool_bwd", "tdnn_fwd",
               "tdnn_bwd", "tdnn_eval")
    log("full_pipeline_demo on the card: EERs " + ", ".join(
        f"{k} {v:.4f}" for k, v in demo["eers"].items()) + "; seconds " + ", ".join(
        f"{k} {v:.1f}" for k, v in demo["seconds"].items())
        + f"; launches { {k: demo['launches'][k] for k in kernels} } [{smi}]")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in demo["eers"].values())
          and len(demo["eers"]) == 5 and all(demo["launches"][k] > 0 for k in kernels),
          f"full_pipeline_demo: {demo}")
    out["full_pipeline_demo"] = demo

    serve = run_tool("examples.verify_demo", [], "verify_demo", root)
    log(f"verify_demo on the card: EER {serve['eer']:.4f}, threshold "
        f"{serve['threshold']:.4f}, {serve['enrolled']} enrolled, identify "
        f"{serve['identify']}; K1 launches {serve['launches']['fft']}, T "
        f"{serve['launches']['tdnn_eval']} [{smi}]")
    check(serve["enrolled"] == 4 and serve["launches"]["fft"] > 0
          and serve["launches"]["tdnn_eval"] > 0, f"verify_demo: {serve}")
    out["verify_demo"] = serve
    out["prepare_data"] = prepare_data_check(root)


def tools_phase(smi: str) -> dict:
    """Phase 19: the repo's verification scripts, the port's own, each in a
    process of its own on the card, in three lanes at once: ``--full``
    (whose reference pipeline runs on the CPU), the train-parity modes, and
    the demos with the data preparation."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "full.json")
        full_run = start_tool("cli.parity_check", ["--full", "--report", path], root, "full",
                                FULL_THREADS)
        try:
            with ThreadPoolExecutor(2) as lanes:
                for lane in [lanes.submit(f, root, smi, out)
                             for f in (parity_tools, demo_tools)]:
                    lane.result()
            full = finish_tool(full_run, "parity_check --full", path)
        finally:   # a failed script stops the protocol's process too
            if full_run["proc"].poll() is None:
                full_run["proc"].kill()
                full_run["proc"].wait()
    log(f"parity_check --full (the port on the card, K1 then the E-TDNN at full width, "
        f"embedding 512, against the numpy MFCC and the torch replica on the CPU): "
        f"{full['n_utterances']} utterances, {full['n_trials']} trials; largest embedding "
        f"difference {full['max_embedding_abs_diff']:.3e} (bar 1e-4), largest score "
        f"difference {full['max_trial_score_abs_diff']:.3e}; EER reference "
        f"{full['eer_reference_torch']!r}, port {full['eer_deeplip_tpu']!r} (bit-equal "
        f"{full['eer_bit_equal']}), {full['order_flips']['count']} target/non-target orders "
        f"flipped; K1 launches {full['launches']['fft']}, T {full['launches']['tdnn_eval']} "
        f"(one a block a batch); {full['process_s']:.1f} s [{smi}]")
    check(full["embedding_parity_bar_1e-4"] and full["eer_bit_equal"]
          and full["launches"]["fft"] > 0
          and full["launches"]["tdnn_eval"] == TDNN_BLOCKS * full["launches"]["fft"],
          f"parity_check --full: {full}")
    out["full"] = full
    out["launches"] = {name: dict(out[key]["launches"]) for name, key in (
        ("parity_full", "full"), ("train_parity", "train_parity"),
        ("train_parity_video", "train_parity_video"),
        ("train_parity_fusion", "train_parity_fusion"),
        ("full_pipeline_demo", "full_pipeline_demo"), ("verify_demo", "verify_demo"))}
    return out


# ---------------------------------------------------------------- phase 20
STUDY_NUDGES = 3                 # nudged replica runs each convergence study holds the port to
FUSION_R05 = ["--n-spk", "24", "--separation", "0.03", "--video-band", "0.4",
              "--video-noise", "0.5"]
# study: (module, arguments, epochs)
STUDIES = {
    "audio": ("cli.convergence_study", [], 10),
    "video": ("cli.convergence_video_study", [], 14),
    "fusion": ("cli.convergence_fusion_study", FUSION_R05, 16),
}
# K3 and K4 each launch three kernels (partial, finalize, apply) at each of
# the flagship trunk's nine BN+PReLU sites in a train step
VIDEO_BN_LAUNCHES_PER_STEP = 3 * 9
RESAMPLE_REFERENCE = os.path.join(REPO, "docs", "resample_r04.json")
RESAMPLE_PCM_TOL = 1e-6          # the PCM delta is host arithmetic on the JAX script's seeds
STUDY_OUT = os.path.join(REPO, "exp", "studies")   # the reports, kept after the run


def study_launches(name: str, epochs: int, report: dict) -> dict:
    """Every kernel's launches that a study's port side must make, from its
    epochs, its module's ``STEPS_PER_EPOCH`` and (audio) its extraction
    batches: the audio study launches K1 once an extraction batch (its steps
    take the shared features); the video study K3/K4 at every site of every
    step, P's backward once a step and its forward once a step and twice an
    evaluation (logits, trunk features), the frontend conv's weight gradient
    once a step (f32), and the eval apply at every site of each
    evaluation's two forwards; the fusion study K1, P's forward and the eval
    apply at every site of its frozen trunk once a step and once an
    evaluation. T at every block of the audio study's E-TDNN in every step
    and extraction batch, and of the fusion study's frozen one in every
    step and evaluation."""
    want = dict.fromkeys(report["launches"], 0)
    if name == "audio":
        steps = epochs * convergence_study.STEPS_PER_EPOCH
        want["fft"] = epochs * report["eval_batches"]
        want.update(tdnn_want(steps=steps, evals=epochs * report["eval_batches"],
                              blocks=len(report["recipe"]["arch"]["context"])))
    elif name == "video":
        steps = epochs * convergence_video_study.STEPS_PER_EPOCH
        want.update(bn_prelu_fwd=VIDEO_BN_LAUNCHES_PER_STEP * steps,
                    bn_prelu_bwd=VIDEO_BN_LAUNCHES_PER_STEP * steps,
                    maxpool_fwd=steps + 2 * epochs, maxpool_bwd=steps, conv3d_wgrad=steps,
                    bn_prelu_eval=video_eval_launches(report["recipe"]["arch"]["trunk_layers"])
                    * 2 * epochs)
    else:
        steps = epochs * convergence_fusion_study.STEPS_PER_EPOCH
        arch = report["recipe"]["arch"]
        want.update(fft=steps + epochs, maxpool_fwd=steps + epochs,
                    bn_prelu_eval=video_eval_launches(arch["video"]["trunk_layers"])
                    * (steps + epochs),
                    **tdnn_want(evals=steps + epochs,
                                blocks=len(arch["audio"]["context"])))
    return want


def study_text(name: str, r: dict) -> str:
    """A convergence study's curves, gaps and bars in one line."""
    curves = "; ".join(f"{side} " + ", ".join(f"{k} [" + " ".join(f"{v:.4g}" for v in c[k])
                                                     + "]" for k in c)
                       for side, c in (("replica", r["torch"]),
                                       ("port", r["deeplip_tpu_torch"])))
    bars = r["convergence_bars"]
    return (f"{curves}; loss gap {bars['max_epoch_loss_gap']:.4g} (bar "
            f"{bars['loss_gap_bar']:.4g}, nudged " + ", ".join(
                f"{n['max_epoch_loss_gap']:.4g}" for n in r["nudged"]) + "); " + "; ".join(
                f"{m} {b['gap']:.4g} (bar {b['bar']:.4g}, quantum {b['quantum']:.4g}, "
                f"reach {b['reach']:.4g}" + ("" if b["informative"] else ": could not fail")
                + ")" for m, b in bars["metrics"].items())
            + f"; rule {'held' if r['convergence_rule'] else 'FAILED'}")


def studies_phase(smi: str) -> dict:
    """Phase 20: the research drivers of the port on the card, each in a
    process of its own, all four at once: the audio, video and fusion
    convergence studies at the shipped widths (``--arch flagship``) with
    nudged replica runs, and the resample study at its defaults. Their
    reports are kept under ``exp/studies``."""
    out, runs = {}, {}
    os.makedirs(STUDY_OUT, exist_ok=True)
    with open(RESAMPLE_REFERENCE) as fh:
        reference = json.load(fh)
    with tempfile.TemporaryDirectory() as root:
        try:
            for name, (module, extra, epochs) in STUDIES.items():
                prefix = os.path.join(root, name)
                args = ["--arch", "flagship", "--nudges", str(STUDY_NUDGES), "--epochs",
                        str(epochs), "--out", prefix] + extra
                runs[name] = (start_tool(module, args, root, name), prefix + ".json")
            resample_path = os.path.join(root, "resample.json")
            runs["resample"] = (start_tool("cli.resample_study", ["--out", resample_path],
                                           root, "resample"), resample_path)
            # waited for side by side, so that each one's process_s is its own
            with ThreadPoolExecutor(len(runs)) as pool:
                done = {name: pool.submit(finish_tool, run, f"phase 20 {name} study", report)
                        for name, (run, report) in runs.items()}
                out.update((name, f.result()) for name, f in done.items())
        finally:   # a failed study stops the others too
            for run, _ in runs.values():
                if run["proc"].poll() is None:
                    run["proc"].kill()
                    run["proc"].wait()
        for name in STUDIES:
            for ext in (".json", ".md"):
                shutil.copy(os.path.join(root, name + ext),
                            os.path.join(STUDY_OUT, f"torch_convergence_{name}{ext}"))
        shutil.copy(resample_path, os.path.join(STUDY_OUT, "torch_resample.json"))

    for name, (module, _, epochs) in STUDIES.items():
        r = out[name]
        want = study_launches(name, epochs, r)
        log(f"phase 20 {module} --arch flagship --nudges {STUDY_NUDGES}, {epochs} epochs: "
            + study_text(name, r) + f"; launches {r['launches']} (expected {want}); "
            f"{r['seconds']:.1f} s in the study (" + ", ".join(
                f"{k} {v:.1f}" for k, v in r["seconds_parts"].items())
            + f"), {r['process_s']:.1f} s the process [{smi}]")
        curves = [c for side in ("torch", "deeplip_tpu_torch") for c in r[side].values()]
        check(all(len(c) == epochs and all(math.isfinite(v) for v in c) for c in curves),
              f"{name} study: a curve not finite or not {epochs} epochs long: {r}")
        check(r["convergence_rule"], f"{name} study: the convergence rule failed: "
              f"{r['convergence_bars']}")
        check(r["launches"] == want, f"{name} study: launches {r['launches']}, expected "
              f"{want}")
    res = out["resample"]
    delta = abs(res["pcm_max_abs_delta"] - reference["pcm_max_abs_delta"])
    probe_before, probe_after = res["probe_loss_before_after"]
    res_want = dict.fromkeys(res["launches"], 0)
    # K1 once a step, once a probe batch before and after, once an
    # extraction batch of each resampler
    res_want["fft"] = (res["steps_trained"] + 2 * res["probe_batches"]
                       + 2 * res["eval_batches"])
    # T: the same, the probes' forwards in train mode without a backward
    res_want.update(tdnn_want(steps=res["steps_trained"], probes=2 * res["probe_batches"],
                              evals=2 * res["eval_batches"]))
    log(f"phase 20 resample study ({res['steps_trained']} steps, {res['n_utts']} utterances): "
        f"probe loss {probe_before:.4f} -> {probe_after:.4f} (ratio "
        f"{probe_after / probe_before:.4f}, bar {res['probe_ratio_bar']}; "
        f"{res['probe_batches']} batches); steps' loss {res['loss_first_last'][0]:.4f} -> "
        f"{res['loss_first_last'][1]:.4f} (every step: "
        + " ".join(f"{v:.3f}" for v in res["losses"]) + f"); PCM delta "
        f"{res['pcm_max_abs_delta']!r} ({delta:.2e} from the JAX study's, bar "
        f"{RESAMPLE_PCM_TOL}); embeddings {res['embedding_max_abs_delta']:.3e} max, "
        f"{res['embedding_p50_abs_delta']:.3e} median (the JAX study's "
        f"{reference['embedding_max_abs_delta']:.3e}, {reference['embedding_p50_abs_delta']:.3e}); "
        f"trial scores {res['trial_score_max_abs_delta']:.3e} max; K1 launches "
        f"{res['launches']['fft']} (expected {res_want['fft']}); {res['seconds']:.1f} s "
        f"[{smi}]")
    check(delta <= RESAMPLE_PCM_TOL, f"resample study: PCM delta {res['pcm_max_abs_delta']!r}, "
          f"the JAX study's {reference['pcm_max_abs_delta']!r}")
    check(res["learned"] and probe_after <= res["probe_ratio_bar"] * probe_before,
          f"resample study: the loss did not fall: the probe's {probe_before:.4f} at init, "
          f"{probe_after:.4f} after {res['steps_trained']} steps")
    check(res["launches"] == res_want, f"resample study: launches {res['launches']}, "
          f"expected {res_want}")
    out["launches"] = {name: dict(r["launches"]) for name, r in out.items()}
    return out


@contextlib.contextmanager
def port_lr_scaled(module, name: str, factor: float):
    """A planted fault in a convergence study: the port's trainer class
    (``module.<name>``) built with its learning rate scaled by ``factor``;
    the replica keeps the recipe's."""
    cls = getattr(module, name)

    def build(*args, lr, **kwargs):
        return cls(*args, lr=lr * factor, **kwargs)
    setattr(module, name, build)
    try:
        yield
    finally:
        setattr(module, name, cls)


# study: {fault: a context that plants it}, each run at phase 20's size and flags
STUDY_FAULTS = {
    "video": {
        "k4_dx_x1.01": lambda: plain_bn_prelu(forward=None, backward=k4_dx_scaled(1.01)),
        "lr_x1.25": lambda: port_lr_scaled(convergence_video_study, "VideoTrainer", 1.25),
    },
    "fusion": {
        "lr_x1.1": lambda: port_lr_scaled(convergence_fusion_study, "FusionTrainer", 1.1),
        "lr_x1.25": lambda: port_lr_scaled(convergence_fusion_study, "FusionTrainer", 1.25),
    },
}


def study_faults() -> int:
    """``--study-faults``: phase 20's video and fusion studies in this
    process, once for each fault of :data:`STUDY_FAULTS`; logs and prints
    whether ``convergence_rule`` failed each. Exit code 0 when every run
    ended (a failed rule is the finding, not an error)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    smi = device_phase()["smi"]
    modules = {"video": convergence_video_study, "fusion": convergence_fusion_study}
    out = {"card": smi}
    with tempfile.TemporaryDirectory() as root:
        for name, faults in STUDY_FAULTS.items():
            _, extra, epochs = STUDIES[name]
            for fault, plant in faults.items():
                prefix = os.path.join(root, f"{name}_{fault}")
                args = ["--arch", "flagship", "--nudges", str(STUDY_NUDGES), "--epochs",
                        str(epochs), "--out", prefix] + extra
                t0 = time.perf_counter()
                with plant():
                    try:
                        modules[name].main(args)
                    except SystemExit as exc:
                        check(exc.code == 3, f"{name} study with {fault}: exit {exc.code}")
                with open(prefix + ".json") as fh:
                    r = json.load(fh)
                log(f"{name} study, planted {fault}: " + study_text(name, r)
                    + f"; {time.perf_counter() - t0:.1f} s [{smi}]")
                out[f"{name}_{fault}"] = {
                    "failed": not r["convergence_rule"], "bars": r["convergence_bars"],
                    "port": r["deeplip_tpu_torch"], "replica": r["torch"],
                    "launches": r["launches"], "seconds": r["seconds"]}
    print(json.dumps(out), flush=True)
    return 0


BN_REPLACES = {"fwd": ("deeplip_tpu/ops/pallas/bn_prelu_kernel.py:56",
                       "deeplip_tpu/ops/pallas/bn_prelu_kernel.py:70"),
               "bwd": ("deeplip_tpu/ops/pallas/bn_prelu_kernel.py:80",
                       "deeplip_tpu/ops/pallas/bn_prelu_kernel.py:102")}


def bn_entry(name: str, kind: str, bn: dict, video: dict) -> dict:
    """A K3 or K4 line of the ``kernels`` record: times summed over the nine
    sites of one bs 128 x 29 train step in f32, with each shape beside."""
    err = "y" if kind == "fwd" else "dx"
    per_step = bn["per_step"]
    return {
        "name": name,
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/bn_prelu_kernel.cu",
        "replaces": BN_REPLACES[kind][0],
        "also_replaces": BN_REPLACES[kind][1],
        "launches": video["launches"][name],
        "max_abs_err": max([r["err_" + err] for r in bn["rows"] if r["dtype"] == "float32"]
                           + [video["path_err"][err]]),
        "max_abs_err_bf16": max(r["err_" + err] for r in bn["rows"] if r["dtype"] == "bfloat16"),
        "ms": per_step[kind],
        "kernel_ms": per_step[kind],
        "plain_ms": per_step[f"{kind}_plain"],
        "bound_ms": per_step[f"{kind}_bound"],
        "bound_by": bn["rows"][0][f"{kind}_bound_by"],
        "library_ms": None,
        "library_two_calls_ms": per_step[f"{kind}_library"],
        "library_note": "no single PyTorch call computes it; library_two_calls_ms times "
                        "F.batch_norm(training=True) then F.prelu" + (
                            "" if kind == "fwd" else ", their autograd backward"),
        "per": "one bs 128 x 29 Lipreading train step: 9 sites, f32",
        "shapes": [{k: r[k] for k in ("shape", "dtype", "sites", kind, f"{kind}_plain",
                                      f"{kind}_bound") + ((f"{kind}_library",)
                                                          if f"{kind}_library" in r else ())}
                   for r in bn["rows"]],
    }


def totals_entry(name: str, kind: str, group: dict) -> dict:
    """A line of the ``kernels`` record for K3's or K4's finalize split in
    two (totals, then statistics) under a process group: the two passes
    summed over the nine sites of one bs 128 x 29 step in f32, their
    launches in phase 17's video step under the group."""
    rows, per_step = group["totals"]["rows"], group["totals"]["per_step"]
    errs = ("err_mean", "err_var") if kind == "fwd" else ("err_dx",)
    return {
        "name": name,
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/bn_prelu_kernel.cu",
        "replaces": BN_REPLACES[kind][0],
        "also_replaces": BN_REPLACES[kind][1],
        "launches": group["steps"]["video"]["launches"]["group"][f"bn_totals_{kind}"],
        "max_abs_err": max(r[e] for r in rows if r["dtype"] == "float32" for e in errs),
        "max_abs_err_bf16": max(r[e] for r in rows if r["dtype"] == "bfloat16" for e in errs),
        "bit_equal_to_single_process": all(r["bit_equal"] for r in rows),
        "ms": per_step[kind],
        "plain_ms": per_step[f"{kind}_plain"],
        "bound_ms": per_step[f"{kind}_bound"],
        "bound_by": rows[0][f"{kind}_bound_by"],
        "library_ms": None,
        "library_note": "no PyTorch call computes it; plain_ms is a float64 sum of the "
                        "partials and the statistics in torch",
        "all_reduce_ms": per_step[f"all_reduce_{kind}"],
        "per": "one bs 128 x 29 Lipreading train step under a process group: 9 sites, f32, "
               "the two split passes (the NCCL all-reduce between them beside)",
        "shapes": [{k: r[k] for k in ("shape", "dtype", "sites", "chunks", kind,
                                      f"{kind}_plain", f"{kind}_bound",
                                      f"all_reduce_{kind}")} for r in rows],
    }


def pool_entry(pool: dict, av: dict, video: dict) -> dict:
    """The max-pool line of the ``kernels`` record: the forward at one
    serving chunk's shape in f32 (what the AV path launches), with the
    backward and every other timed shape beside it."""
    rows = [r for r in pool["rows"] if "fwd" in r]
    serve = next(r for r in rows if r["what"] == "serving chunk" and r["dtype"] == "float32")
    backward = {r["dtype"]: {
        "shape": r["shape"], "ms": r["bwd"], "plain_ms": r["bwd_plain"], "bound_ms": r["bwd_bound"],
        "bound_by": "bytes", "bound_share": r["bwd_bound_share"]}
        for r in rows if r["what"] == "train step"}
    return {
        "name": "maxpool_frontend",
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/maxpool_kernel.cu",
        "replaces": "benchmarks/pool_mosaic_probe.py:43",
        "launches": av["launches"]["maxpool_fwd"],
        "launches_video_train": {k: video["launches"][k] for k in ("maxpool_fwd", "maxpool_bwd")},
        "max_abs_err": 0.0,   # y is bit-equal at every shape, or the run has failed
        "max_abs_err_dx": max(r["err_dx"] for r in pool["rows"] if r["dtype"] == "float32"),
        "max_abs_err_dx_bf16": max(r["err_dx"] for r in pool["rows"]
                                   if r["dtype"] == "bfloat16"),
        "ms": serve["fwd"],
        "plain_ms": serve["fwd_plain"],
        "bound_ms": serve["fwd_bound"],
        "bound_by": "bytes",
        "library_ms": serve["fwd_plain"],
        "library_note": "F.max_pool3d on the channels-last view, which is also the plain "
                        "version; fwd_library_contiguous is the same call on a contiguous "
                        "NCDHW copy; bwd_plain is its autograd backward",
        "per": "one AV serving chunk: 16 items x 2 clips x 32 frames, f32, forward only",
        "backward_train_step": backward,
        "backward_note": "the backward at the training step's shape; plain_ms is "
                         "F.max_pool3d's autograd backward, the one library call for it",
        "shapes": rows,
    }


def conv3d_wgrad_entry(wgrad: dict, video_g: dict | None) -> dict:
    """The frontend Conv3d weight gradient's line of the ``kernels`` record:
    the kernel at the train step's shape (64 channels), 24 channels beside,
    and its launches on the main paths."""
    train = {r["channels"]: r for r in wgrad["rows"] if r["what"] == "train step"}
    main = train[64]
    entry = {
        "name": "conv3d_wgrad",
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/conv3d_wgrad_kernel.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the JAX package leaves the frontend conv to XLA "
                         "(ops/video.py: frontend_conv3d_s2d); on the card cuDNN's FP32 "
                         "weight gradient took 55 % of the f32 Lipreading step",
        "launches_route": wgrad["route"]["launches"],
        "max_rel_err": max(r["err"] for r in wgrad["rows"]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "FP32 operations",
        "library_ms": main["library_ms"],
        "library_note": "torch.nn.grad.conv3d_weight under fp32_math: cuDNN's FP32 weight "
                        "gradient, the f32 step's path before the kernel",
        "per": "one bs 128 x 29 x 88 x 88 f32 Lipreading step's frontend weight gradient",
        "shape_24_channels": {k: train[24][k] for k in ("ms", "plain_ms", "library_ms",
                                                        "bound_ms", "err")},
        "shapes": wgrad["rows"],
    }
    if video_g is not None:
        entry["launches_grouped_video"] = {
            dtype: {"launches": row["launches_wgrad"], "steps": row["steps"],
                    "warmup_steps": row["warmups"],
                    "note": "the steps and the eager warm-up steps: the runner adds each "
                            "replay's launches"}
            for dtype, row in video_g.items()}
    return entry


def tdnn_entry(tdnn: dict) -> dict:
    """T's line of the ``kernels`` record: per train step and per extraction
    batch at the 300-frame shapes (nine 512-channel blocks and one of 1,500
    taken as the two timed shapes), and its launches on the audio paths."""
    t512, t1500 = tdnn["train"]
    e512, e1500 = tdnn["eval"]

    def step(key: str) -> float:
        return 9 * t512[key] + t1500[key]

    def batch(key: str) -> float:
        return 9 * e512[key] + e1500[key]

    return {
        "name": "tdnn_bn_act",
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/tdnn_bn_act_kernel.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: XLA fuses the TDNN blocks' BN and LeakyReLU on the "
                         "TPU; on the card they ran as eager passes",
        "launches_route": tdnn["route"]["launches"],
        "max_err": {r["dtype"] + str(r["shape"]): r["err"] for r in tdnn["train"]},
        "eval_bit_equal_eager": [r["bit_equal_eager"] for r in tdnn["eval"]],
        "graph_replay_bit_equal": tdnn["graph_replay_bit_equal"],
        "per_train_step_bf16_ms": {k: step(k) for k in (
            "fwd", "bwd", "fwd_bound", "bwd_bound", "fwd_plain", "bwd_plain", "fwd_eager",
            "bwd_eager")},
        "per_extraction_batch_f32_ms": {k: batch(k) for k in (
            "eval", "eval_bound", "eval_plain", "eval_eager")},
        "bound_by": "bytes (each input read once, each output written once)",
        "library_note": "the eager ops the blocks ran before T: TorchBatchNorm and "
                        "F.leaky_relu on the (B, T, C) view, and their autograd backward",
    }


def bn_prelu_eval_entry(bn_eval: dict, fusion: dict, av: dict) -> dict:
    """The kernels record's entry for the eval apply (phase 23), with its
    launches on the fusion training and AV serving paths."""
    return {
        "name": "bn_prelu_eval",
        "route": "cuda",
        "source": "deeplip_tpu_torch/csrc/bn_prelu_kernel.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: XLA fuses the eval-mode trunk's BN, PReLU and "
                         "residual add on the TPU; on the card they ran as eager passes",
        "launches_route": bn_eval["launches"],
        "launches_fusion_train": fusion["launches"]["bn_prelu_eval"],
        "launches_av_serving": av["launches"]["bn_prelu_eval"],
        "bit_equal_eager": all(r["bit_equal_eager"] for r in bn_eval["sites"]),
        "graph_replay_bit_equal": bn_eval["graph_replay_bit_equal"],
        "per_fusion_step_ms": bn_eval["fusion_step_ms"],
        "sites": bn_eval["sites"],
        "bound_by": "bytes (each input read once, y written once)",
        "library_note": "the eager modules the trunk ran before: TorchBatchNorm in eval "
                        "mode, the residual add and PReLU",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    seconds = {}

    def phase(name: str, fn, *args):
        """``fn(*args)``, its wall seconds logged and kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    dev = phase("1", device_phase)
    part, peaks = card_peaks(dev["name"])
    native_build_s = phase("2", build_phase)
    pressure = phase("14b", capture_pressure_phase, dev["smi"])
    # the verification scripts run in processes of their own while the card is clean
    tools = phase("19", tools_phase, dev["smi"])
    studies = phase("20", studies_phase, dev["smi"])
    # phase 17 runs while the card is clean: its grouped capture needs free
    # device memory for its graph's pool, which the earlier phases' cached
    # and fragmented segments leave too little of by the end of the script
    group = phase("17", process_group_phase, dev["smi"], peaks)
    release()
    kern = phase("3", kernel_phase, peaks)
    main_path = phase("4", main_path_phase)
    sweep = phase("5", sweep_phase, main_path["extractor"])
    del main_path["extractor"]
    torch.cuda.empty_cache()
    entry = phase("18", mixed_entry_phase, dev["smi"])
    audio_train = phase("11", audio_train_phase, dev["smi"], peaks)
    torch.cuda.empty_cache()
    bn = phase("6", bn_prelu_phase, peaks)
    pool = phase("9", maxpool_phase, peaks)
    wgrad = phase("21", conv3d_wgrad_phase, peaks)
    tdnn = phase("22", tdnn_bn_act_phase, peaks, dev["smi"])
    bn_eval = phase("23", bn_prelu_eval_phase, peaks, dev["smi"])
    video = phase("7", video_main_path_phase)
    step = phase("8", video_step_phase, video.pop("trainer"), video.pop("full_batch"), bn)
    torch.cuda.empty_cache()
    av = phase("10", av_serving_phase)
    torch.cuda.empty_cache()
    fusion = phase("12", fusion_train_phase, dev["smi"], peaks)
    torch.cuda.empty_cache()
    video_bf16 = phase("13", video_bf16_phase, bn, dev["smi"])
    torch.cuda.empty_cache()
    grouped = phase("14", grouped_dispatch_phase, dev["smi"])
    release()
    variants = phase("15", variants_phase, dev["smi"], peaks)
    release()
    kaldi_io = phase("16", kaldi_host_io_phase, dev["smi"], main_path.pop("store"),
                     video_bf16["step_ms"], native_build_s)
    release()
    launches = {
        "launches": main_path["launches"]["fused_fbank"],
        "launches_sweep": sweep["launches"]["fft"],
        "launches_av_serving": av["launches"]["fused_fbank"],
        "launches_microbatch": av["microbatch"]["launches"],
        "launches_audio_train": audio_train["launches"]["fft"],
    }
    fbank_common = {
        "route": "cuda",
        "bound_note": "bound_ms is the front-end function's own work (pre-emphasis, one "
                      "real FFT a frame, untangle, power, mel sums over nonzero weights, "
                      "DCT), whichever kernel runs it; algorithm_ops_ms is the time of the "
                      "operations this kernel's algorithm does, at the FP32 peak",
        "library_ms": None,
        "library_note": "no single PyTorch call computes framed rDFT power -> mel "
                        "-> log -> DCT; cufft_composite_ms is the plain front-end with "
                        "dft='fft' (torch.fft.rfft, then the mel and DCT products)",
        "shape": [BATCH, int(SECONDS * RATE)],
    }
    fft_source = {"source": "deeplip_tpu_torch/csrc/fbank_fft_kernel.cu", **fbank_common}
    kernels = {"kernels": [{
        "name": "fused_fbank",
        "replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:241",
        **launches,
        "max_abs_err": kern["max_abs_err"]["fft"],
        "max_abs_err_mel_band0": kern["band0_err"],
        "max_abs_err_audio_train": max(r["max_abs_err"] for r in audio_train["k1_shapes"]),
        "audio_train_note": "launches_audio_train: one a train step plus one an extraction "
                            "batch; audio_train_shapes: K1 at each crop shape of the epochs, "
                            "CMVN after, with its time and the function's bound",
        "audio_train_shapes": audio_train["k1_shapes"],
        "largest_error": kern["worst"]["fft"],
        "dc_bin_vs_float64": kern["dc_witness"],
        "ms": kern["ms"]["fft"],
        "plain_ms": kern["ms"]["plain"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "algorithm_ops_ms": kern["algorithm_ops_ms"],
        "cufft_composite_ms": kern["ms"]["cufft"],
        "config": "mfcc-24, n_fft 512",
        **fft_source,
    }, {
        # the TPU's v1 kernel serves the configs its v2 kernel refuses; here
        # the FFT kernel serves both, so this entry is that kernel at a v1
        # config (logfbank-60), with the same launch counts
        "name": "fused_fbank_v1_configs",
        "replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:109",
        **launches,
        "max_abs_err": kern["v1"]["max_abs_err"],
        "ms": kern["v1"]["kernel_ms"],
        "plain_ms": kern["v1"]["plain_ms"],
        "bound_ms": kern["v1"]["bound_ms"],
        "bound_by": kern["v1"]["bound_by"],
        "algorithm_ops_ms": kern["v1"]["algorithm_ops_ms"],
        "config": "logfbank, 60 filters",
        **fft_source,
    }, {
        # both TPU kernels at an n_fft in [64, 4096] that is no power of two:
        # the FFT kernel's mixed-radix and Bluestein route, on phase 18's path
        "name": "fused_fbank_mixed_fft",
        "replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:241",
        "also_replaces": "deeplip_tpu/ops/pallas/fbank_kernel.py:109",
        "launches": sum(entry["launches"].values()),
        "launches_n_fft_400_path": entry["launches"],
        "launches_sweep": sweep["launches"]["mixed"],
        "launches_audio_train": audio_train["launches"]["mixed"],
        "max_abs_err": kern["max_abs_err"]["mixed"],
        "largest_error": kern["worst"]["mixed"],
        "ill_conditioned": kern["ill_conditioned"],
        **{key: kern["mixed"][ENTRY_N_FFT]["ms"][k] for key, k in (
            ("ms", "mixed"), ("plain_ms", "plain"), ("cufft_composite_ms", "cufft"))},
        "bound_ms": kern["mixed"][ENTRY_N_FFT]["bound_ms"],
        "bound_by": kern["mixed"][ENTRY_N_FFT]["bound_by"],
        "algorithm_ops_ms": kern["mixed"][ENTRY_N_FFT]["algorithm_ops_ms"],
        "by_n_fft": {n: {"plan": r["plan"], "bluestein": r["bluestein"], "ms": r["ms"]["mixed"],
                         "plain_ms": r["ms"]["plain"], "cufft_composite_ms": r["ms"]["cufft"],
                         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                         "algorithm_ops_ms": r["algorithm_ops_ms"],
                         "max_abs_err": r["max_abs_err"]["mixed"]}
                     for n, r in kern["mixed"].items()},
        "config": f"mfcc-24, n_fft {ENTRY_N_FFT}",
        **fft_source,
    }, bn_entry("bn_prelu_fwd", "fwd", bn, video), bn_entry("bn_prelu_bwd", "bwd", bn, video),
        pool_entry(pool, av, video), totals_entry("bn_prelu_fwd_totals", "fwd", group),
        totals_entry("bn_prelu_bwd_totals", "bwd", group)]}
    kernels["kernels"].append(conv3d_wgrad_entry(wgrad, grouped["video"]))
    kernels["kernels"].append(tdnn_entry(tdnn))
    kernels["kernels"].append(bn_prelu_eval_entry(bn_eval, fusion, av))
    by_name = {e["name"]: e for e in kernels["kernels"]}
    for name in ("fused_fbank", "fused_fbank_v1_configs"):
        by_name[name]["launches_fusion_train"] = fusion["launches"]["fft"]
    by_name["fused_fbank_mixed_fft"]["launches_fusion_train"] = fusion["launches"]["mixed"]
    for name, kind in (("bn_prelu_fwd", "fwd"), ("bn_prelu_bwd", "bwd")):
        by_name[name].update(
            launches_fusion_train=fusion["launches"][name],
            launches_video_bf16=video_bf16["launches"][name],
            max_abs_err_bf16=max(by_name[name]["max_abs_err_bf16"],
                                 video_bf16["path_err"]["y" if kind == "fwd" else "dx"]),
            ms_bf16_per_step=video_bf16["k3_k4_bf16_per_step"][kind],
            bound_ms_bf16_per_step=video_bf16["k3_k4_bf16_per_step"][f"{kind}_bound"])
    # phase 14: the launches of the grouped runs, counted over the graph
    # replays, with the eager warm-up steps that preceded each capture
    audio_g, video_g = grouped["audio"], grouped["video"]
    for name in ("fused_fbank", "fused_fbank_v1_configs"):
        by_name[name]["launches_grouped_audio"] = {
            "f32": audio_g["launches"]["fft"], "bf16": audio_g["bf16"]["launches"]["fft"],
            "steps": audio_g["steps"], "warmup_steps": {
                "f32": audio_g["warmups"], "bf16": audio_g["bf16"]["warmups"]}}
    by_name["fused_fbank_mixed_fft"]["launches_grouped_audio"] = audio_g["launches"]["mixed"]
    for name, key in (("bn_prelu_fwd", "bn_prelu_fwd"), ("bn_prelu_bwd", "bn_prelu_bwd"),
                      ("maxpool_frontend", "maxpool_fwd")):
        by_name[name]["launches_grouped_video"] = {
            dtype: {"launches": row["launches"][key], "steps": row["steps"],
                    "warmup_steps": row["warmups"]} for dtype, row in video_g.items()}
    by_name["maxpool_frontend"]["launches_grouped_video_bwd"] = {
        dtype: row["launches"]["maxpool_bwd"] for dtype, row in video_g.items()}
    by_name["maxpool_frontend"].update(
        launches_fusion_train=fusion["launches"]["maxpool_fwd"],
        launches_video_bf16={k: video_bf16["launches"][k] for k in ("maxpool_fwd",
                                                                    "maxpool_bwd")},
        fusion_train_shape={name: {k: p[k] for k in ("shape", "P", "P_library", "fwd_bound")}
                            for name, p in fusion["parts_300"].items()})
    # phase 15: the variants' launches, and K3/K4 and P at 24 channels
    resnet_runs, shuffle = variants["resnet"]["runs"], variants["shufflenet"]
    route = {"fused_fbank": "fft", "fused_fbank_v1_configs": "fft",
             "fused_fbank_mixed_fft": "mixed"}
    for name, kernel in route.items():
        by_name[name]["launches_variants"] = {
            **{f"resnet_train_{k}": run["launches"][kernel] for k, run in resnet_runs.items()},
            "resnet_steps": {k: run["steps"] for k, run in resnet_runs.items()},
            "attentive_extraction_batch": {p: r["launches"][kernel] for p, r in
                                           variants["attentive"]["poolings"].items()},
            "stft_extraction_batch": variants["stft"]["extraction_launches"][kernel]}
    for name, kind, err in (("bn_prelu_fwd", "fwd", "err_y"), ("bn_prelu_bwd", "bwd", "err_dx")):
        by_name[name]["launches_shufflenet_train"] = {
            k: run["launches"][name] for k, run in shuffle["runs"].items()}
        by_name[name]["shape_24_channels"] = {
            r["dtype"]: {"shape": r["shape"], "max_abs_err": r[err], "ms": r[kind],
                         "plain_ms": r[f"{kind}_plain"], "bound_ms": r[f"{kind}_bound"],
                         "bound_by": r[f"{kind}_bound_by"],
                         "library_two_calls_ms": r.get(f"{kind}_library")}
            for r in shuffle["c24"]["bn_prelu"]}
    by_name["maxpool_frontend"]["launches_shufflenet_train"] = {
        k: {p: run["launches"][p] for p in ("maxpool_fwd", "maxpool_bwd")}
        for k, run in shuffle["runs"].items()}
    by_name["maxpool_frontend"]["shape_24_channels"] = {
        r["dtype"]: {k: v for k, v in r.items() if k not in ("dtype", "what")}
        for r in shuffle["c24"]["maxpool"]}
    # phase 16: the native-loader epoch runs K1 once a step, the Kaldi steps never
    for name, kernel in route.items():
        by_name[name].update(
            launches_native_loader_epoch=kaldi_io["native_loader"]["launches"][kernel],
            launches_kaldi_train=kaldi_io["kaldi_train"]["launches"][kernel],
            launches_kaldi_ark_features=kaldi_io["kaldi_feature_launches"] if kernel == "fft"
            else 0)
    # phase 17: K3/K4 under the world-size-1 group launch 4 a call
    for name, kind in (("bn_prelu_fwd", "fwd"), ("bn_prelu_bwd", "bwd")):
        by_name[name]["launches_process_group_video_step"] = {
            k: v[name] for k, v in group["steps"]["video"]["launches"].items()}
    for name in ("fused_fbank", "fused_fbank_v1_configs"):
        by_name[name]["launches_process_group"] = {
            "audio_step": group["steps"]["audio"]["launches"]["group"]["fft"],
            "fusion_step": group["steps"]["fusion"]["launches"]["group"]["fft"],
            "grouped_capture": group["grouped_capture"]["launches"]["fft"]}
    # phase 19: the verification scripts' processes, each kernel's launches by script
    drv = tools["launches"]
    for name, kernel in (("fused_fbank", "fft"), ("fused_fbank_mixed_fft", "mixed"),
                         ("bn_prelu_fwd", "bn_prelu_fwd"), ("bn_prelu_bwd", "bn_prelu_bwd"),
                         ("maxpool_frontend", "maxpool_fwd")):
        by_name[name]["launches_verification"] = {d: c.get(kernel, 0) for d, c in drv.items()}
    # K2's counts share K1's counter; the scripts run MFCC-24, no hop-blocked config
    by_name["fused_fbank_v1_configs"]["launches_verification"] = {d: 0 for d in drv}
    by_name["fused_fbank_v1_configs"]["launches_verification_note"] = (
        "the verification scripts run MFCC-24 only, through K1")
    by_name["maxpool_frontend"]["launches_verification_bwd"] = {
        d: c.get("maxpool_bwd", 0) for d, c in drv.items()}
    # phase 20: the research drivers' processes, each kernel's launches by study
    for name, kernel in (("fused_fbank", "fft"), ("fused_fbank_mixed_fft", "mixed"),
                         ("bn_prelu_fwd", "bn_prelu_fwd"), ("bn_prelu_bwd", "bn_prelu_bwd"),
                         ("maxpool_frontend", "maxpool_fwd")):
        by_name[name]["launches_studies"] = {d: c[kernel] for d, c in studies["launches"].items()}
    by_name["fused_fbank_v1_configs"]["launches_studies"] = {d: 0 for d in studies["launches"]}
    by_name["fused_fbank_v1_configs"]["launches_studies_note"] = (
        "the research drivers run MFCC-24 only, through K1")
    by_name["maxpool_frontend"]["launches_studies_bwd"] = {
        d: c["maxpool_bwd"] for d, c in studies["launches"].items()}
    summary = {
        "card": dev["smi"],
        "peaks_part": part,
        "main_path_emb_err": main_path["emb_err"],
        "main_path_eer": main_path["eer"],
        "lomgrid_trials_per_sec": sweep["trials_per_sec"],
        "lomgrid_sweep_ms": sweep["sweep_ms"],
        "lomgrid_front_end_ms": sweep["front_ms"],
        "lomgrid_front_end_launches": sweep["launches"],
        "lomgrid_tdnn_ms": sweep["tdnn_ms"],
        "lomgrid_tdnn_gflop": sweep["tdnn_gflop"],
        "video_losses": video["losses"],
        "video_batches": video["batches"],
        "video_path_bn_prelu_err": video["path_err"],
        "video_step_ms": step["step_ms"],
        "video_step_walls_ms": step["step_walls"],
        "video_clips_per_sec": step["clips_per_sec"],
        "video_peak_gb": step["peak_gb"],
        "video_bn_prelu_share": step["kernel_share"],
        "video_kernel_vs_plain_loss_rel": step["loss_rel"],
        "video_kernel_vs_plain_stat_distance": step["stat_distance"],
        "video_kernel_vs_plain_grad_distance": step["grad_distance"],
        "video_nudged_plain_grad_distance": step["nudge_distance"],
        "video_k4_alone_grad_distance": step["k4_distance"],
        "video_planted_k3_faults": step["planted_faults"],
        "video_worst_tensor": step["worst_tensor"],
        "video_profiled_wall_ms": step["profiled_wall_ms"],
        "video_profiled_busy_ms": step["profiled_busy_ms"],
        "video_profiled_bn_prelu_ms": step["profiled_bn_prelu_ms"],
        "video_profiled_by_kind_ms": step["profiled_by_kind_ms"],
        "video_launches": video["launches"],
        "av_chunks": av["chunks"],
        "av_launches": av["launches"],
        "av_concat": av["concat"],
        "av_head": av["head"],
        "av_kernel_vs_plain_parts": av["part_err"],
        "av_chunk_split_ms": av["chunk_split_ms"],
        "microbatch": av["microbatch"],
        "audio_train": {k: v for k, v in audio_train.items() if k != "k1_shapes"},
        "n_fft_400_path": entry,
        "fusion_train": fusion,
        "video_bf16": video_bf16,
        "conv3d_wgrad": wgrad,
        "tdnn_bn_act": tdnn,
        "bn_prelu_eval": bn_eval,
        "grouped_dispatch": grouped,
        "variants": variants,
        "kaldi_host_io": kaldi_io,
        "process_group": group,
        "capture_pressure": pressure,
        "verification": tools,
        "studies": studies,
        "phase_seconds": seconds,
        "phase_14_parts_seconds": grouped["parts_s"],
    }
    print(json.dumps(summary), flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--capture-pressure"]:
        sys.exit(capture_pressure_child(sys.argv[2]))
    if sys.argv[1:2] == ["--study-faults"]:
        sys.exit(study_faults())
    if sys.argv[1:2] == ["--k1-against"]:
        sys.exit(k1_against(sys.argv[2]))
    if sys.argv[1:2] == ["--conv3d-wgrad"]:
        sys.exit(conv3d_wgrad_only())
    if sys.argv[1:2] == ["--tdnn-bn-act"]:
        sys.exit(tdnn_bn_act_only())
    if sys.argv[1:2] == ["--bn-prelu-eval"]:
        sys.exit(bn_prelu_eval_only())
    sys.exit(main())
