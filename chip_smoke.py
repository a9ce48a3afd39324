#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero before the result line):

1. device — the card's name and power limit (nvidia-smi), TF32 off for
   matmul and cuDNN; no CUDA means exit 2 with no result.
2. build — every kernel source in deeplearning4j_tpu_torch/csrc (the paged
   and the flash attention kernels), one nvcc for sm_90a per source, all
   started together; each build's seconds.
3. kernels — K4 (paged decode: split kernel + combine) and K5 (chunked
   prefill: split kernel + combine) against their plain PyTorch version
   at the served shapes (H 12, Dh 64, page 16, MP 64), f32 and bf16:
   pool pages scattered by a permuted block table, ragged lengths incl.
   0, 1, 16, 17 and 1024, the split plan's span boundaries (63, 64, 65
   and 129 keys: a span is SPLIT_PAGES = 4 pages), decode at S 1 (777;
   1024) and 8, prefill at t0 0, 16, 496 with tail chunks and 1008 (L
   1024, the most spans). Tolerances: f32 rtol 1e-5 / atol 1e-6, bf16
   at most 1 bf16 ulp, lse rtol/atol 1e-5, exact zeros and the 1e30 lse
   sentinel at length 0. Then, over 24 input seeds, f32 and bf16, K4 at
   the S 8 lengths and K5 at t0 496 and 1008 against an f64 answer: no
   value may be more than one step further from it than the plain
   version's (a bf16 ulp, with values below 1/256 of the max-abs taken
   at that floor; in f32 1e-6 + 1e-5 |value|). The 1-ulp check holds
   input by input for any kernel that sums in another order than the
   plain version; this one separates such a kernel from a wrong one
   whatever the seed. Times (CUDA events, L2 flushed and a spin
   kernel queued before every launch, so the events see device work, not
   the host's launch path; median of 50 for the kernel and the
   yardstick, 5 for the plain version) for the kernel, the plain version
   and gather + scaled_dot_product_attention (a yardstick the port never
   calls), beside the bound: bytes the call must move over 3.35 TB/s;
   K4 at S 1 length 1024 and K5 at t0 1008 are timed too.
4. serve — GPT-2-small widths (vocab 50257, d 768, 12 heads, 12 layers,
   d_ff 3072, context 1024, page 16, bf16, random weights from seed 0)
   behind ModelHost + InferenceServer; 8 concurrent HTTP :generate
   requests with 64..512-token prompts and maxNewTokens 32. Every answer
   must be 200 with 32 tokens, both kernels must have launched and the
   plain version not at all. Reports time to first token and decode
   tokens/s. Then one bucket-8 decode_paged step at the burst's lengths,
   timed two ways (median of 5): host wall time to a synchronize, and
   device time: CUDA events around the step queued behind a spin
   kernel, so its kernels run back to back with no host gap between
   them; beside it K4 at that step's lengths x 12 layers.
5. correct — (a) one served prompt's logits against an f32 full causal
   forward of the same parameters (no cache, no kernels); (b) paged
   generation at a fixed bucket bitwise equal to the port's dense serial
   trajectory.
6. flash kernels — K1 (forward: o and lse), K2 (dq) and K3 (dk, dv)
   against their plain PyTorch versions, f32 and bf16, at the training
   shapes (B 8, H 12, T 512, D 64) non-causal and causal, at a padded T
   (500) and at cross lengths (Tq 24, Tk 56, D 16); the forward and the
   backward twice each, bitwise equal. Tolerances: f32 within 1e-4 of
   each tensor's max-abs (the kernels take 32-row tiles where the plain
   version takes one 512-row block, so every sum runs in another order,
   and their products in 3xTF32); bf16 o within 2 ulp (the
   ulp of values below 1/256 of o's max-abs taken at that floor: a
   cancelling weighted mean turns a 1e-7 f32 difference into many ulps of
   a tiny value) and the gradients within a relative L2 of 1e-2; lse
   rtol/atol 1e-5. Times (as in phase 3) of each kernel, its plain
   version and scaled_dot_product_attention (forward; forward +
   torch.autograd.grad for the backward; a yardstick the port never
   calls), beside the bound (f32 work at the 3xTF32 rate, 495/3
   TFLOP/s: PEAK_F32_OPS says why); flash_bwd whole (delta + K2 + K3)
   beside SDPA's backward, and their ratio. Then a seed-independent
   gate, f32 and bf16, non-causal and causal: over 8 input seeds at B 2,
   H 12, T 512, D 64, no value of K1's o and lse or K2/K3's dq, dk, dv
   more than one step (excess_over_plain, phase 3's; the f32 step for
   the lse, which is f32 in both) further from an f64 answer (the plain
   version on f64 copies of the same inputs) than the plain version's.
   It separates the kernels' 3xTF32 products, which pass, from a single
   TF32 pass, which fails (tests/test_torch_flash_tf32.py).
7. train — a transformer encoder at BERT-base widths (Google Research's
   bert uncased_L-12_H-768_A-12/bert_config.json: hidden 768, 12 heads,
   intermediate 3072, 12 layers, sequence 512, gelu, weights from
   N(0, 0.02^2) after initializer_range; whole depth) built
   with the port's graphBuilder(): per block AttentionVertex(hasBias) ->
   add -> Dense(3072, gelu) -> Dense(768) -> FeedForwardToRnn -> add; avg
   pooling and a 2-class softmax/MCXENT head; Adam(1e-4), f32, seed 0,
   batch 8 x 512, random features and a learnable label rule from seed 0.
   (a) one computeGradientAndScore against an f32 reference forward and
   backward written here (materialised-score softmax attention, autograd,
   no kernel, no port module): loss rel 1e-5, each gradient rel L2 1e-3
   (the key bias, whose gradient is 0 in exact arithmetic, to an absolute
   L2 of 1e-4 of the whole gradient's); (b) 20 fit steps: K1, K2 and K3 at
   12 launches a step each, their plain versions at 0, every loss finite,
   the last below the first; (c) median step ms over steps 3-20,
   sequences/s, tokens/s and peak device memory.

8. lenet — zoo LeNet (1x28x28, 10 classes, Adam(1e-3), f32, TF32 off,
   seed 0) through MultiLayerNetwork, batch 64 of seeded uniform pixels
   labelled by a seeded linear rule: (a) the first step's loss and
   gradients on the card
   against the port on the CPU from the same weights (carried with
   params_to_reference / load_reference_params): loss rel 1e-5, each
   gradient rel L2 1e-4; (b) fit(DataSetIterator(256 examples, shuffle))
   for 5 epochs, 20 steps: every loss finite, the last epoch's mean loss
   below the first's; median step ms of steps 3-20 and images/s.
9. resnet — zoo ResNet50 through ComputationGraph. (a) parity at
   tests/test_torch_zoo_resnet.py's shape (8 classes, 3x64x64, batch 4)
   and bars, from the same weights: f64 on the card against f64 on the
   CPU (loss rel 1e-10, each gradient rel L2 1e-9; after one fit step BN
   running statistics rel 1e-6 and the Nesterovs-updated params within
   1e-10), f32 with TF32 and cudnn.benchmark off against the f64 answer
   (loss rel 1e-5; each gradient no further from it than 1.25x the
   CPU f32's worst distance, or the reference's own 2.6e-2 where larger,
   + 1e-3: this network's f32 gradient is not reproducible beyond ~1e-2,
   see the test) and the eval output within 1e-4 of the CPU's. (b) the reference's headline configuration (bench.py
   _measure_resnet50): 224x224, 1000 classes, DataType.BFLOAT16,
   dataFormat NHWC, Nesterovs(0.1, 0.9), batch 128, one fixed seeded
   batch (RandomState(0) uniform pixels, random labels) resident on the
   card, cuDNN's heuristic algorithm choice with deterministic algorithms
   (cudnn.benchmark off: at lr 0.1 the trajectory is chaotic, and
   benchmark's timed choice made its 20th loss differ run to run, above
   the 1st in 2 of 13 runs; PERF.md §5); 20 fit steps: losses finite and
   the 20th below the 1st; median step ms of steps 3-20, images/s, peak device
   memory and the share of the 989 TFLOP/s bf16 dense peak at 3x the
   forward FLOPs counted from the conv and dense shapes. (c) a
   torch.profiler trace of 3 more steps (tracing off for (b)): device
   time per step split into convolutions (forward, dgrad, wgrad), BN
   forward and backward, other elementwise work (relu, add), pooling,
   max pooling, global pooling, the dense layer and the loss, the
   Nesterovs update, the bf16 casts of the fp32 master weights (and of
   their gradients back) and the rest, by a profiler scope the smoke
   opens around each layer kind's forward, the loss and the update, and
   by the autograd node of each backward kernel; the device's busy time
   (the union of its kernels and copies) and its idle share of the
   untraced step of (b) and of the traced wall, which the profiler's own
   host work stretches.

10. nd4j — the ND4J array layer on the card (Nd4j factories with no
   device land there): (a) value semantics, as the CPU tests check them:
   in-place ops on views (getRow, getColumn, get with NDArrayIndex,
   __getitem__, INDArray(a), transpose, slice) leave the parent as it
   was, and the parent's leave the views; (b) out-of-range getDouble,
   get (point and index array), putScalar and an index-array
   __getitem__ raise IndexError before any launch, and the context stays
   usable (a synchronize and a later read); (c) Nd4j.rand/randn with a
   seed repeat on the card, and from setSeed; at 2^24 draws their mean
   and std within 5 sigma of the distribution's; (d) Nd4j.gemm(alpha
   0.5, beta 2, transposeA and transposeB) at 4096^2 f32, TF32 off,
   within a relative L2 of 1e-5 of float64 numpy, and its time (CUDA
   events, median of 5 after one); (e) on a 25,557,032-element f32
   vector (ResNet-50's parameter count) from Nd4j.randn(seed 0): the
   THRESHOLD codec (tau 2.5) and its decode, the INT8 codec, and
   threshold_encode_fixed (tau 1, capacity 1 %, a stable sort on the
   card, ties in index order) each exactly numpy's answer: indices,
   signs, scale, values, dense message and residual.
11. samediff — (a) BASELINE config 2 (bench.py bench_samediff_mlp: B
   256, 784 -> 256 relu -> 10, softmaxCrossEntropy, Adam(1e-3), f32,
   RandomState(7) data) on the card against the same graph on the CPU:
   first-step loss and gradients rel 1e-5, the 20-step fit trajectory
   within the CPU test's band (rel 1e-5), fitSteps(20) ending where 20
   fit calls do; steps/s of fit (a loss fetch a step) and fitSteps(20)
   (one), and a torch.profiler trace of 20 fit steps: the device's busy
   share of the traced wall (phase 9(c)'s method); save, load onto the
   card, outputs bitwise equal. (b) a SameDiff encoder at phase 7's
   widths, whole depth: per block multiHeadDotProductAttention (768, 12
   heads, no bias: the op's form) -> add -> linear 3072 + gelu ->
   linear 768 -> add; mean over T -> linear 2 -> softmaxCrossEntropy; B
   8 x 512, f32, weights N(0, 0.02^2) from Nd4j.randn seeds, Adam(1e-4),
   phase 7's batch (transposed to [B, T, E]). The first step's loss and
   every gradient against the same graph with flash_attention routed to
   the plain versions on the card (phase 7's bars: loss rel 1e-5, each
   gradient rel L2 1e-3); 20 fit steps with K1, K2 and K3 at exactly 12
   launches a step each and the plain versions at 0; the losses finite
   and falling; the median step of steps 3-20, tokens/s and peak
   memory, printed beside phase 7's ComputationGraph step. (c) save, load
   onto the card, outputs bitwise equal.

12. char-rnn — BASELINE config 3 (bench.py bench_lstm_tbptt outside
   SMOKE: GravesLSTM(256) -> GravesLSTM(256) -> RnnOutputLayer(77,
   softmax, MCXENT), InputType.recurrent(77, 80), tBPTT 20, Adam(2e-3),
   seed 12, batch 32 x 80 RandomState(0) one-hot ids, labels rolled by
   -1). (a) The first tBPTT window in f32, TF32 and reduced-precision bf16
   reductions off, on the card against the same network on the CPU from
   the same weights: loss rel 1e-5, each gradient rel L2 1e-4, the carries
   handed to window 2 rel L2 1e-5; then bf16 on the card may be at most
   1.5x as far (rel L2 over all gradients, and over the carries) from an
   f64 CPU run of those weights as bf16 on the CPU is. (b) 20 fit calls in
   bf16 (fp32 masters), 80 windows: losses finite and the last below the
   first, no carry left after fit; the median fit of calls 3-20 and
   chars/s = 32 x 80 / median, peak memory; one torch.profiler-traced fit:
   kernels a window and the device's busy share of the traced wall (phase
   11(a)'s method). (c) The trained net behind ModelHost.register_sequence
   (the carry-slot SequenceScheduler, buckets 1, 2, 4, 8, greedy one-hot
   feedback) and InferenceServer: 8 concurrent :generate requests with
   "steps" prompts of 5-40 one-hot rows and extraSteps 32; every answer
   200 with T + 32 rows, each within 1 bf16 ulp of the same prompt stepped
   one row at a time through rnnTimeStep on the card (the serving
   contract, serving/sequence.py); the live slot-steps exactly the rows
   served. TTFT p50 and max, rows/s (live slot-steps over the steps'
   time), one bucket-8 rnnStepBatched step's host and device ms (phase 4's
   method), and "step" vs "gang" admission on the mix [24, 2, 2, 2, 2, 2]
   x 8 (bench.py:1590): gang at least 2x the dispatches, refills only
   under step, outputs within 1 ulp of each other. K1-K5 launch no time in
   this phase: no TPU kernel lies on the recurrent path.
13. data-parallel — BASELINE config 5 (the reference's "Spark
   SharedTrainingMaster gradient-sharing ResNet-50"): zoo ResNet50 at
   phase 9(b)'s settings (224^2, 1000 classes, bf16 over fp32 masters,
   NHWC, Nesterovs(0.1, 0.9), deterministic cuDNN), batch 128 a rank,
   through deeplearning4j_tpu_torch.parallel. (a) A real NCCL process
   group (FileStore rendezvous) over the cards this process sees as one
   rank: world 1 on a one-card machine, so every collective is NCCL's
   world-1 kernel. SharedTrainingMaster in each mode, "int8" (its
   default), None (dense), "block_int8" and "threshold" (tau 1e-3,
   encodingCapacity 0.125), 20 steps on phase 9(b)'s batch: median step
   ms of steps 3-20, images/s, peak memory, collectives and bytes a step
   (payload and ring wire bytes) beside compressed_wire_bytes' bill, the
   step against phase 9(b)'s. Checks: dense's 20 losses bitwise equal to
   phase 9(b)'s ComputationGraph.fit trajectory (one rank's all-reduce is
   a copy); each compressed mode's first exchange held to the port's
   exchange functions run on the CPU on the card's own first gradient
   (int8 lanes bitwise, the dequantized mean within 1 f32 ulp; threshold
   mean and residual bitwise); every loss finite. (b) two ranks on the
   one card over gloo (NCCL refuses two ranks on one device; gloo stages
   CUDA tensors through the host, the backend's own staging, asked for
   here): first an all-reduce of a CUDA tensor, which must succeed; then
   parallel.dryrun.sync_bn_leg (a small BN CNN, f32): dense dp 2 with BN
   synchronised over the ranks within SYNC_BN_F32_ATOL of fit on the
   combined batch, and an int8 step's exchange within its grid (|mean -
   exact mean| <= scale/254) of the exact mean of the ranks' gradients.
   Threshold is not in this leg: gloo has no all-gather of CUDA tensors.
   (c) with two or more cards only: (a)'s four modes at dp =
   min(cards, 4) on NCCL ranks, images/s a rank and the scaling against
   (a); on one card the line says it did not run. K1-K5 launch no time
   in this phase.

14. training runtime — (a) BASELINE config 4 (phase 9(b)'s ResNet-50,
   bf16 NHWC, Nesterovs(0.1, 0.9), batch 128, deterministic cuDNN) over
   an ExistingDataSetIterator of 9 pre-built batches (0.7 GB on the
   host): ComputationGraph.fitDataSet(stepsPerSync=4) (two blocks and a
   one-batch tail, 3 syncs) with every block issued under
   torch.cuda.set_sync_debug_mode("error"), its 9 losses and its params,
   BN statistics and momentum bitwise equal to fit over the same
   iterator from the same start; the block driver's spans (data wait,
   staging, dispatch, sync wait), ms a step against fit(iterator) and
   phase 9(b); the device's idle share of one traced block beside phase
   9(c)'s; TrainingCheckpoint.save after step 4, load into a fresh net,
   5 more steps: the losses and the state bitwise the uninterrupted
   run's (file bytes, save and load seconds); evaluate on 2 held-out
   batches (the confusion total must be 256). (b) BASELINE config 1:
   zoo LeNet (f32, Adam(1e-3), batch 64) on MnistDataSetIterator's
   60,000 / 10,000 examples (synthetic and flagged where no idx files
   are on the machine) through NormalizerStandardize:
   EarlyStoppingTrainer (3 epochs, DataSetLossCalculator on the test
   split, LocalFileModelSaver) whose best model restores onto the card
   and scores >= 0.9 accuracy on the test split; ResilientFit
   (saveEveryNIterations 200) with a NaN-poisoned step 100 that is
   skipped (the params across it equal) and a preemption after step 500,
   then a new ResilientFit on the same directory resumes at the step-400
   checkpoint and its losses and final state equal the uninterrupted
   run's bitwise; images/s of fit against fitDataSet(stepsPerSync=16)
   over one epoch (bitwise equal results). (c) phase 7's encoder through
   ComputationGraph.fitDataSet(stepsPerSync=4) over 8 batches under the
   sync check: losses and state bitwise fit's, K1-K3 12 launches a step
   each, counted over this run alone.

15. the CNN zoo — (a) AlexNet (with LRN, 67x67) and VGG16 (32x32), 5
   classes, batch 4, dropout off: 3 steps, each step's loss and
   gradients on the card in f64 and f32 against the same net on the CPU
   in f64 (params copied; f64 loss rel 1e-10, gradients rel L2 1e-9; f32
   loss 1e-5 from f64, gradients 1e-2: a relu output near 0 that changes
   sign between summation orders moves a gradient by ~7e-3). (b) VGG16
   at 224^2, 1000 classes, bf16 NHWC, the zoo's Nesterovs(1e-2, 0.9),
   batch 64, dropout 0.5 on, deterministic cuDNN: 20 steps on one
   resident batch (the loss must fall): the median step of steps 3-20,
   images/s, peak memory, share of the bf16 peak (3 x the forward's conv
   + dense FLOPs / step / 989 TFLOP/s), and a torch.profiler split of 3
   more steps by kind (conv, dense, pool, relu, dropout, loss, update,
   casts; a backward kernel goes to the kind of the forward op that made
   its autograd node). (c) AlexNet the same at batch 128, LRN and
   dropout on (LRN's share in the split). (d) UNet at its zoo default
   128^2, numClasses 1 (sigmoid + XENT through CnnLossLayer), bf16 NHWC,
   Adam(1e-3), batch 32: step ms, images/s, peak memory. (e) ResNet-50's
   space-to-depth stem: an s2d net built from a standard net's
   parameters through stem_weights_to_s2d, its global-pool features and
   logits in f32 eval mode within rel L2 1e-4 of the standard net's;
   then 6 steps of the s2d net at 9(b)'s settings beside 9(b)'s step.
   (f) 9(b)'s net for 5 steps without and with
   checkpointPolicy="save_conv_outputs": losses and final state bitwise
   equal; peak memory and step ms of each. (g) zoo SimpleCNN (its
   DropoutLayer on, f32) over 9 batches: fitDataSet(stepsPerSync=4)
   under the sync check against fit, losses and state bitwise equal.
16. the rest of the layer catalogue — (a) every class of port PR 12 at
   cut sizes (embeddings, the mask layers, the time vertices with masks,
   the CNN <-> RNN preprocessors, constraints, weight noise and a
   biasUpdater together, FrozenLayerWithBackprop, the 1-d and locally
   connected layers, PReLU, RepeatVector, capsules, the center-loss and
   OC-NN heads, the SameDiff layers, VAE and AutoEncoder pretraining), one
   net each on the card in f64 and f32 against the CPU in f64 from the
   same weights, the random draws made once on the CPU: 3 steps, f64
   loss rel 1e-12 and gradients rel L2 1e-11, f32 within each case's band
   (loss 1e-5, gradients 1e-4; 1e-3 through the capsule routing);
   SpaceToBatch's forward bitwise. (b) the masked sequence classifier at
   dl4j-examples ImdbReviewClassificationRNN widths (a trainable
   EmbeddingSequenceLayer 20,000 x 300 -> LSTM(256, tanh) ->
   RnnOutputLayer(2), Adam(5e-3), l2 1e-5, element-wise clip 1.0,
   Xavier, f32) over 8 resident batches of 64 reviews cut to 256 tokens,
   lengths uniform in 32-256, the labels mask on each review's last
   step: 20 steps (median of 3-20, valid tokens/s, peak memory; the mean
   loss of the last 8 below the first 8's), kernels a step and the busy
   share of 3 traced steps, fitDataSet(4) bitwise fit over the 8, and two
   identical steps from one saved state bitwise equal (the embedding's
   gradient). (c) its ComputationGraph form through LastTimeStepVertex:
   under (b)'s initial weights, logits within 1e-6 of (b)'s per-step
   logits at each review's last valid step; under its trained weights,
   the vertex's output bitwise (b)'s LSTM output there (the logits then
   differ by the rounding of two product shapes, ~1 ulp of their
   magnitude, recorded); then 3 fit steps. (d) the VAE at VaeMNIST2dPlots widths
   (784 -> encoder 256, 256 -> 2 -> decoder 256, 256, leaky relu,
   Bernoulli, RmsProp(1e-3), l2 1e-4, batch 128): one epoch of pretrain
   over the flagged synthetic 60,000-digit MNIST (steps/s, the negative
   ELBO of the first and last 20 batches must fall), then 20 fit steps
   of a softmax head over it (its loss must fall).
17. the data and fine-tuning runtime — (a) 14(a)'s 9 batches of config 4
   through AsyncDataSetIterator(queueSize 4) over the native ring (the
   Python ring fails the phase): fit and fitDataSet(4) over it beside the
   unwrapped iterator's, each twice (in order, then in reverse), all
   from one start, the losses and the final params, BN statistics and
   momentum bitwise equal; ms a step (host wall / 9, 14(a)'s method;
   both readings, and the lesser) beside 14(a)'s, the fitDataSet spans,
   a traced prefetched block's idle share; the ring's kind, slot bytes
   and host copies a batch. (b) 14(b)'s 60,000 / 10,000 (synthetic,
   flagged) MNIST digits written as CSVs of 785 integer columns;
   CSVRecordReader through the native parser (its matrix equal to the
   rows written; MB/s), a TransformProcess over 785 columns (a
   ConditionFilter on the label, a label conversion there and back; its
   JSON round-trips), RecordReaderDataSetIterator(64, labelIndex 784, 10
   classes), NormalizerStandardize, AsyncDataSetIterator, one epoch of
   zoo LeNet, bitwise the same epoch over the unwrapped iterator: images/s
   of both beside 14(b)'s fit, test accuracy >= 0.9.
   (c) ImageAugmentationPreProcessor(Flip(0.5), RandomCrop(224, pad 16),
   Rotate(15)) on the card: preProcess of a DataSet of config 4's 128 x
   224^2 host f32 features (the card's tensor out) and run on the bf16
   batch already there, ms (phase 3's method: CUDA events, L2 flushed,
   median); on 16 host f32 images under the card's draws replayed on the
   CPU, flip and crop exactly equal, the whole pipeline within 1e-5;
   MFCCTransform(13) on the card over the numpy of 32 seeded one-second
   16 kHz clips written with the wave module and read by
   WavFileRecordReader, ms, within 1e-5 of the max-abs of the CPU's. (d) dl4j-examples EditLastLayerOthersFrozen on zoo VGG16 (224^2,
   f32, random weights): frozen through fc2 (layer 19), a 5-class XAVIER
   head, FineTuneConfiguration(Nesterovs(5e-5), seed 12345), batch 15, 20
   steps: the loss falls, every frozen parameter bitwise unchanged, step
   ms beside 15(b)'s; TransferLearningHelper featurize + 20
   fitFeaturized land on the same head (rel L2 1e-5). (e) phase 7's
   encoder through TransferLearning.GraphBuilder.setFeatureExtractor at
   the sixth block's output: 5 steps with K1 at 12 launches a step and K2
   and K3 at 6 (the frozen blocks run no backward), frozen params bitwise
   unchanged, step ms beside phase 7's. (f) config 2's MLP (784 -> 256
   -> 10, batch 256, f32) under LBFGS, CONJUGATE_GRADIENT and
   LINE_GRADIENT_DESCENT, 20 steps each: steps/s, the loss must fall;
   Newton-CG on tests/test_solvers.py's regression subject below 5e-3
   after 40 steps and below fixed-step SGD. (g) config 4's ResNet-50 (bf16
   NHWC, batch 128): int8_infer_fn against the bf16 forward (ms by CUDA
   events, median of 20, L2 flushed), the dequantize alone (ms; and its
   launches and device ms against a traced int8 call's: the call writes
   every weight in bf16 before the forward reads it), param bytes,
   max-abs logit difference, top-1 agreement; the card's q equal to the CPU's and its
   int8 logits within rel L2 1e-5 of the CPU's (f64, 4 rows: the f32
   forward itself differs by ~1.5e-5 across the two). (h) render_report over (a)'s StatsListener
   log; UIServer's page and its JSON route answer 200 on localhost.

The last stdout line is {"ok": true, "device": {...}}; before it come the
nvidia-smi line and one JSON line {"kernels": [...]} (K1-K5; K1-K3's
launches are phase 7's plus phase 11's plus phase 14(c)'s plus phase
17(e)'s; phases 8-10, 12, 13, 14(a), 14(b), 15, 16 and 17 but (e) run no
hand-written kernel: conv, dense and the recurrent products are
cuDNN/cuBLAS calls, as the reference leaves them to XLA, LRN, dropout
and the shape layers are torch tensor ops, and the data-parallel
exchange is NCCL's or gloo's collectives).
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
PEAK_BF16_OPS = 989e12               # dense bf16 tensor-core peak
H, DH, PAGE, MP, P = 12, 64, 16, 64, 513
#: GPT-2 small (OpenAI's 124M config.json), whole depth, random weights
GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_context=1024, page_size=16,
                  dtype="bfloat16", seed=SEED)
# the bound a bf16 serving logit may differ from the f32 reference by:
# logits here are ~N(0, 0.6); bf16 keeps 8 bits, and the residual stream,
# K/V and every projection output are rounded to it through 12 layers
LOGIT_ATOL = 0.1


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def need(cond, what):
    if not cond:
        raise SmokeFailure(what)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------

def ulps(a, b):
    """Distance in bf16 steps between two bf16 tensors."""
    import torch

    def ordered(x):
        bits = x.contiguous().view(torch.int16).long() & 0xFFFF
        return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def close_enough(got, want):
    import torch
    if got.dtype == torch.bfloat16:
        return int(ulps(got, want).max()) <= 1
    return bool(torch.allclose(got, want, rtol=1e-5, atol=1e-6))


def bf16_close(got, want, n):
    """Every bf16 value within `n` ulps of the reference, the ulp of
    values below 1/256 of the reference's max-abs taken at that floor."""
    import torch
    w = want.float()
    floor = w.abs().max().clamp_min(1e-30) / 256
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(w.abs(), floor)))
                     - 7)
    return bool(((got.float() - w).abs() <= n * ulp).all())


def exact_decode(q, kp, vp, bt, sl):
    """f64 softmax attention of each slot's query over its first
    seq_lens keys; a zero row at length 0."""
    import torch
    S, Hq, D = q.shape
    T = bt.shape[1] * kp.shape[1]
    k = kp[bt.long()].reshape(S, T, Hq, D).double()
    v = vp[bt.long()].reshape(S, T, Hq, D).double()
    s = torch.einsum("shd,sthd->sht", q.double(), k) / math.sqrt(D)
    valid = (torch.arange(T, device=q.device)[None]
             < sl.long()[:, None])[:, None]
    p = torch.softmax(s.masked_fill(~valid, -math.inf), -1).nan_to_num(0.0)
    return torch.einsum("sht,sthd->shd", p, v)


def exact_prefill(qc, kp, vp, bt1, t0, n_valid):
    """f64 causal softmax attention of a chunk at offset t0 over the
    table's first t0 + n_valid keys."""
    import torch
    C, Hq, D = qc.shape
    L = t0 + n_valid
    k = kp[bt1.long()].reshape(-1, Hq, D)[:L].double()
    v = vp[bt1.long()].reshape(-1, Hq, D)[:L].double()
    s = torch.einsum("rhd,thd->rht", qc.double(), k) / math.sqrt(D)
    valid = ((t0 + torch.arange(C, device=qc.device))[:, None]
             >= torch.arange(L, device=qc.device)[None])[:, None]
    return torch.einsum("rht,thd->rhd",
                        torch.softmax(s.masked_fill(~valid, -math.inf), -1),
                        v)


def excess_over_plain(got, plain, exact):
    """How much further each value of `got` is from the f64 answer than
    the plain version's value, in steps of one bf16 ulp (the ulp of
    values below 1/256 of the answer's max-abs taken at that floor) or,
    in f32, of 1e-6 + 1e-5 |value| (phase 3's f32 tolerance); the worst
    value. At most 1 separates a sum taken in another order from a wrong
    kernel whatever the inputs, where "1 ulp of the plain version" holds
    input by input."""
    import torch
    e = exact.double()
    if got.dtype == torch.bfloat16:
        floor = e.abs().max().clamp_min(1e-30) / 256
        step = torch.exp2(torch.floor(torch.log2(torch.maximum(e.abs(),
                                                               floor))) - 7)
    else:
        step = 1e-6 + 1e-5 * e.abs()
    return float((((got.double() - e).abs() - (plain.double() - e).abs())
                  / step).max())


#: input seeds of phase 3's comparison with an f64 answer
F64_SEEDS = 24


def seed_sweep(tpa, dev, dtype, seeds=F64_SEEDS):
    """K4 at the S 8 batch and K5 at t0 496 and 1008 over `seeds` input
    seeds (phase 3's shapes): per case the worst excess_over_plain and,
    in bf16, the largest ulp distance to the plain version and the seeds
    where it exceeds 1."""
    import torch
    res = {}
    for seed in range(seeds):
        rng = np.random.default_rng(seed)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype)

        kp, vp = randn(P, PAGE, H, DH), randn(P, PAGE, H, DH)
        lens = [0, 1, 16, 17, 1024, 300, 511, 64]
        bts = torch.from_numpy(tables(rng, lens)).to(dev)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = randn(len(lens), H, DH)
        cases = {"K4 S8": (tpa.paged_flash_decode(q, kp, vp, bts, sl),
                           tpa.paged_decode_plain(q, kp, vp, bts, sl),
                           exact_decode(q, kp, vp, bts, sl))}
        bt = torch.from_numpy(tables(rng, [MP * PAGE])[0]).to(dev)
        for t0, n in ((496, 9), (1008, 16)):
            qc = randn(PAGE, H, DH)
            cases[f"K5 t0 {t0}"] = (
                tpa.paged_flash_prefill(qc, kp, vp, bt, t0, n)[:n],
                tpa.paged_prefill_plain(qc, kp, vp, bt, t0, n)[:n],
                exact_prefill(qc, kp, vp, bt, t0, n)[:n])
        for key, (got, plain, ex) in cases.items():
            r = res.setdefault(key, {"excess_vs_f64": -math.inf})
            r["excess_vs_f64"] = max(r["excess_vs_f64"],
                                     excess_over_plain(got, plain, ex))
            if dtype == torch.bfloat16:
                d = int(ulps(got, plain).max())
                r["ulps_vs_plain"] = max(r.get("ulps_vs_plain", 0), d)
                r["seeds_over_1_ulp"] = r.get("seeds_over_1_ulp", 0) + (d > 1)
    return res


def rel_l2(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-300))


#: cycles of the spin kernel queued before each timed launch (~0.5 ms)
LAUNCH_SPIN_CYCLES = 1_000_000


def time_ms(fn, reps, flush):
    """Median ms of `fn` over `reps` launches, each timed alone by CUDA
    events after zeroing a buffer larger than the 50 MB L2, so every
    launch reads its inputs from device memory as a serving step does.
    A short spin kernel runs between the flush and the first event, so
    the host has queued `fn`'s launches before the device reaches them:
    the events time the device's work, not the host's launch path (a
    call whose host path outlasts the spin, like the plain versions',
    still includes it)."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(LAUNCH_SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def tables(rng, lens):
    """Block tables for slots of these lengths over pages drawn from a
    permutation of 1..P-1: physical order != logical order."""
    order = rng.permutation(np.arange(1, P))
    bts = np.zeros((len(lens), MP), np.int32)
    k = 0
    for s, n in enumerate(lens):
        for j in range(-(-n // PAGE)):
            bts[s, j] = order[k]
            k += 1
    return bts


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

def decode_timing(tpa, q, kp, vp, bt, sl, lens, err, flush):
    """Phase 3's timing row of K4 at these inputs."""
    import torch
    import torch.nn.functional as F
    S, item = len(lens), q.element_size()
    live = sum(lens)
    need_bytes = (2 * S * H * DH * item + 4 * S
                  + 4 * sum(-(-n // PAGE) for n in lens)
                  + 2 * live * H * DH * item)
    bmem = need_bytes / HBM_BYTES_PER_S * 1e3
    peak = PEAK_BF16_OPS if item == 2 else PEAK_F32_OPS
    bops = 4 * live * H * DH / peak * 1e3
    T = MP * PAGE
    mask = (torch.arange(T, device=q.device)[None, :]
            < sl[:, None])[:, None, None, :]

    def library():
        kg = kp[bt.long()].reshape(S, T, H, DH).transpose(1, 2)
        vg = vp[bt.long()].reshape(S, T, H, DH).transpose(1, 2)
        return F.scaled_dot_product_attention(q[:, :, None, :], kg, vg,
                                              attn_mask=mask)

    return {"max_abs_err": err,
            "ms": time_ms(lambda: tpa.paged_flash_decode(q, kp, vp, bt, sl),
                          50, flush),
            "plain_ms": time_ms(lambda: tpa.paged_decode_plain(
                q, kp, vp, bt, sl), 5, flush),
            "library_ms": time_ms(library, 50, flush),
            "bound_ms": max(bmem, bops),
            "bound_by": "bytes" if bmem >= bops else "operations"}


def prefill_timing(tpa, qc, kp, vp, bt1, t0, n_valid, err, flush):
    """Phase 3's timing row of K5 at these inputs."""
    import torch
    import torch.nn.functional as F
    item = qc.element_size()
    L = t0 + n_valid
    need_bytes = (2 * PAGE * H * DH * item + 4 * -(-L // PAGE)
                  + 2 * L * H * DH * item)
    ops = 4 * H * DH * sum(t0 + r + 1 for r in range(n_valid))
    bmem = need_bytes / HBM_BYTES_PER_S * 1e3
    bops = ops / (PEAK_BF16_OPS if item == 2 else PEAK_F32_OPS) * 1e3
    T = MP * PAGE
    kpos = torch.arange(T, device=qc.device)
    qpos = t0 + torch.arange(PAGE, device=qc.device)
    mask = ((kpos[None, :] < L) & (qpos[:, None] >= kpos[None, :]))[None,
                                                                    None]

    def library():
        kg = kp[bt1.long()].reshape(T, H, DH).transpose(0, 1)
        vg = vp[bt1.long()].reshape(T, H, DH).transpose(0, 1)
        return F.scaled_dot_product_attention(
            qc.transpose(0, 1)[None], kg[None], vg[None], attn_mask=mask)

    return {"max_abs_err": err,
            "ms": time_ms(lambda: tpa.paged_flash_prefill(
                qc, kp, vp, bt1, t0, n_valid), 50, flush),
            "plain_ms": time_ms(lambda: tpa.paged_prefill_plain(
                qc, kp, vp, bt1, t0, n_valid), 5, flush),
            "library_ms": time_ms(library, 50, flush),
            "bound_ms": max(bmem, bops),
            "bound_by": "bytes" if bmem >= bops else "operations"}


def check_kernels(dev):
    import torch

    from deeplearning4j_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(SEED)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    span = tpa.SPLIT_PAGES * PAGE
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype)

        kp, vp = randn(P, PAGE, H, DH), randn(P, PAGE, H, DH)
        for lens in ([777], [MP * PAGE], [0, 1, 16, 17, 1024, 300, 511, 64],
                     [span - 1, span, span + 1, 2 * span + 1]):
            S = len(lens)
            bt = torch.from_numpy(tables(rng, lens)).to(dev)
            sl = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = randn(S, H, DH)
            out, lse = tpa.paged_flash_decode(q, kp, vp, bt, sl,
                                              need_lse=True)
            ref, ref_lse = tpa.paged_decode_plain(q, kp, vp, bt, sl,
                                                  need_lse=True)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            need(close_enough(out, ref),
                 f"K4 {name} lens={lens} disagrees with plain: max err {err}")
            need(bool(torch.allclose(lse, ref_lse, rtol=1e-5, atol=1e-5)),
                 f"K4 {name} lens={lens} lse disagrees with plain")
            for s, n in enumerate(lens):
                if n == 0:
                    need(bool(torch.all(out[s] == 0))
                         and bool(torch.all(lse[s] == tpa.LSE_EMPTY)),
                         f"K4 {name}: length-0 slot not exact zeros + "
                         "sentinel")
            log(f"K4 {name} S={S} lens={lens}: max_abs_err {err:.3e} ok")
            if name == "bfloat16" and S == 8:
                rows["decode"] = decode_timing(tpa, q, kp, vp, bt, sl, lens,
                                               err, flush)
            elif name == "bfloat16" and lens == [MP * PAGE]:
                rows["decode S1 L1024"] = decode_timing(
                    tpa, q, kp, vp, bt, sl, lens, err, flush)
        bt1 = torch.from_numpy(tables(rng, [MP * PAGE])[0]).to(dev)
        for t0, n_valid in ((0, 16), (16, 7), (496, 9), (MP * PAGE - PAGE,
                                                         PAGE)):
            qc = randn(PAGE, H, DH)
            got = tpa.paged_flash_prefill(qc, kp, vp, bt1, t0, n_valid)
            want = tpa.paged_prefill_plain(qc, kp, vp, bt1, t0, n_valid)
            torch.cuda.synchronize()
            err = float((got[:n_valid].float()
                         - want[:n_valid].float()).abs().max())
            need(close_enough(got[:n_valid], want[:n_valid]),
                 f"K5 {name} t0={t0} disagrees with plain: max err {err}")
            log(f"K5 {name} t0={t0} n_valid={n_valid}: max_abs_err "
                f"{err:.3e} ok")
            if name == "bfloat16" and t0 == 496:
                rows["prefill"] = prefill_timing(tpa, qc, kp, vp, bt1, t0,
                                                 n_valid, err, flush)
            elif name == "bfloat16" and t0 == MP * PAGE - PAGE:
                rows["prefill t0 1008"] = prefill_timing(
                    tpa, qc, kp, vp, bt1, t0, n_valid, err, flush)
    for dtype in (torch.float32, torch.bfloat16):
        sweep = seed_sweep(tpa, dev, dtype)
        log(f"{F64_SEEDS} seeds, {dtype}: " + json.dumps(sweep))
        for key, r in sweep.items():
            need(r["excess_vs_f64"] <= 1,
                 f"{key} {dtype}: further from the f64 answer than the "
                 f"plain version by {r['excess_vs_f64']:.2f} steps")
    del flush
    for k, r in rows.items():
        log(f"{k} bf16 timing: kernel_ms {r['ms']:.5f} plain_ms "
            f"{r['plain_ms']:.5f} library_ms {r['library_ms']:.5f} "
            f"bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    return rows


# ----------------------------------------------------------------------
# phases 4-5: serve GPT-2-small widths, then check the output
# ----------------------------------------------------------------------

def http(port, path, body=None, timeout=600):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def reference_logits(lm, ids):
    """f32 full causal forward of the model's parameters, no cache and
    no kernels: logits [T, V] for the token ids [T]."""
    import torch
    import torch.nn.functional as F

    p = {k: v.float() for k, v in lm.state_dict().items()}
    T = ids.shape[0]
    nh, hd = lm.n_heads, lm.head_dim

    def rms(x, g):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * g

    h = p["emb"][ids] + p["pos"][:T]
    causal = torch.ones((T, T), dtype=torch.bool, device=ids.device).tril()
    for i in range(lm.n_layers):
        w = {k: p[f"layers.{i}.{k}"] for k in
             ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")}
        x = rms(h, w["ln1"])
        q, k, v = ((x @ w[n]).view(T, nh, hd).transpose(0, 1)
                   for n in ("wq", "wk", "wv"))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        h = h + (a @ v).transpose(0, 1).reshape(T, -1) @ w["wo"]
        x = rms(h, w["ln2"])
        h = h + F.gelu(x @ w["w1"], approximate="tanh") @ w["w2"]
    return rms(h, p["lnf"]) @ p["emb"].T


def serve_and_check(dev, cfg):
    """Phases 4 and 5 for the model config `cfg` on `dev`."""
    import torch

    from deeplearning4j_tpu_torch.nn.transformer import (
        CausalTransformerLM, dense_serial_trajectory,
    )
    from deeplearning4j_tpu_torch.ops import paged_attention as tpa
    from deeplearning4j_tpu_torch.runtime import telemetry
    from deeplearning4j_tpu_torch.serving import (
        InferenceServer, ManualClock, ModelHost, PagedSequenceScheduler,
        greedy_sampler, stream_rng,
    )

    t = time.perf_counter()
    lm = CausalTransformerLM(device=dev, **cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"model: {sum(x.numel() for x in lm.parameters())} params "
        f"{lm.dtype_name} on {lm.device}, built in "
        f"{time.perf_counter() - t:.2f} s: {json.dumps(cfg)}")
    host = ModelHost()
    t = time.perf_counter()
    rep = host.register_sequence("gpt2s", lm, numPages=513,
                                 slotBuckets=(1, 2, 4, 8))
    log(f"register_sequence (warm) {time.perf_counter() - t:.2f} s: "
        + json.dumps({str(k): round(v, 4) for k, v in rep["warm"].items()}))
    srv = InferenceServer(host).start(port=0)
    result = {}
    try:
        deadline = time.monotonic() + 300
        while http(srv.port, "/healthz", timeout=10)[0] != 200:
            need(time.monotonic() < deadline, "/healthz never turned 200")
            time.sleep(0.1)
        rng = np.random.default_rng(SEED)
        lens = rng.integers(64, min(513, lm.max_context - 31), size=8)
        prompts = [rng.integers(0, lm.vocab, size=int(n)).tolist()
                   for n in lens]
        reg = telemetry.get_registry()
        reg.trace.clear()
        answers = [None] * 8

        def fire(i):
            answers[i] = http(srv.port, "/v1/models/gpt2s:generate",
                              {"tokens": prompts[i], "maxNewTokens": 32})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(8)]
        tpa.reset_launches()                 # counts of the main path only
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t
        launches = {"decode": tpa.paged_flash_decode.launches,
                    "prefill": tpa.paged_flash_prefill.launches,
                    "plain": tpa.paged_attend.launches}
        for i, ans in enumerate(answers):
            need(ans is not None, f"request {i} never answered")
            need(ans[0] == 200, f"request {i}: HTTP {ans[0]} {ans[1][:300]}")
            toks = json.loads(ans[1])["tokens"]
            need(len(toks) == 32, f"request {i}: {len(toks)} tokens")
            need(all(0 <= x < lm.vocab for x in toks),
                 f"request {i}: token out of range")
        need(launches["decode"] > 0 and launches["prefill"] > 0,
             f"a kernel was never launched on the served path: {launches}")
        need(launches["plain"] == 0,
             f"the plain version served on the card: {launches}")
        ttft = reg.get("dl4j_seq_ttft_seconds").labels(model="gpt2s:v1")
        steps = [s for s in reg.trace.spans() if s["name"] == "sequence.step"]
        dec_tokens = sum(s["args"]["slots"] for s in steps)
        dec_s = sum(s["dur"] for s in steps)
        prefill_chunks = sum(1 for s in reg.trace.spans()
                             if s["name"] == "sequence.prefill")
        result["serve"] = {
            "requests": 8, "prompt_tokens": int(lens.sum()),
            "generated_tokens": 8 * 32, "wall_s": wall,
            "ttft_p50_s": ttft.percentile(50), "ttft_max_s":
                ttft.percentile(100), "decode_steps": len(steps),
            "decode_tokens": dec_tokens,
            "decode_tok_per_s": dec_tokens / dec_s,
            "burst_generated_tok_per_s": 8 * 32 / wall,
            "prefill_chunks": prefill_chunks, "launches": launches,
            "k4_launches_per_decode_token": launches["decode"] / dec_tokens,
            "k5_launches_per_prompt_token":
                launches["prefill"] / int(lens.sum()),
        }
        log("serve: " + json.dumps(result["serve"]))

        # 5a: served logits against the f32 full causal forward
        prompt = rng.integers(0, lm.vocab,
                              size=min(200, lm.max_context - 32)).tolist()
        req = host.generate("gpt2s", prompt, max_new_tokens=32, wait=False)
        out = req.wait(600)
        ids = torch.tensor(prompt + out.tolist()[:-1], device=dev)
        with torch.inference_mode():
            ref = reference_logits(lm, ids)[len(prompt) - 1:].cpu().numpy()
        served = req.logits
        need(served.shape == ref.shape == (32, lm.vocab),
             f"logits shapes {served.shape} vs {ref.shape}")
        need(bool(np.isfinite(served).all()), "non-finite served logits")
        err = float(np.abs(served - ref).max())
        rel = float(np.linalg.norm(served - ref) / np.linalg.norm(ref))
        log(f"correct (a): served bf16 vs f32 reference over 32 positions: "
            f"max_abs_err {err:.4e} (atol {LOGIT_ATOL}), rel_l2 {rel:.4e}, "
            f"max|ref| {float(np.abs(ref).max()):.4f}")
        need(err <= LOGIT_ATOL, f"served logits off the f32 reference: {err}")
        result["correct_a"] = {"max_abs_err": err, "rel_l2": rel}
    finally:
        srv.stop()
        host.close(drain=False)

    # 4, continued: where a bucket-8 decode step's time goes
    result["decode_step"] = time_decode_step(
        lm, dev, [int(n) + 16 for n in lens])

    # 5b: paged bitwise == dense serial trajectory at a fixed bucket
    s = PagedSequenceScheduler(lm, num_pages=129, slot_buckets=(4,),
                               clock=ManualClock(), start_thread=False,
                               name="bitwise")
    prompts = [rng.integers(0, lm.vocab,
                            size=min(n, lm.max_context - 16)).tolist()
               for n in (40, 97, 130)]
    reqs = [s.submit(p, max_new_tokens=16, wait=False) for p in prompts]
    s.drain()
    for i, p in enumerate(prompts):
        toks, logits = dense_serial_trajectory(
            lm, p, 16, greedy_sampler(), stream_rng(0, i), bucket=4)
        need(reqs[i].wait(1.0).tolist() == toks,
             f"bitwise: prompt {i} tokens differ from the dense trajectory")
        need(np.array_equal(reqs[i].logits.view(np.uint8),
                            logits.view(np.uint8)),
             f"bitwise: prompt {i} logits differ from the dense trajectory")
    s.close()
    log("correct (b): paged generation bitwise == dense serial trajectory "
        "(3 prompts x 16 tokens, bucket 4)")
    return result


#: cycles the spin kernel holds the card while a step is queued behind it
#: (~50 ms at the H100's 1.98 GHz boost clock; a step queues in ~10 ms)
SPIN_CYCLES = 100_000_000


def time_decode_step(lm, dev, lens):
    """One bucket-8 ``decode_paged`` step at these slot lengths (median of
    5): host wall time to a synchronize; device time, CUDA events around
    the step queued behind a spin kernel, so its kernels run back to back
    with no host gap; and K4 alone at the step's shapes (L2 flushed), which
    the step launches once per layer."""
    import torch

    from deeplearning4j_tpu_torch.ops import paged_attention as tpa

    S = len(lens)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (lm.n_layers, P, lm.page_size, lm.n_heads, lm.head_dim)
    kps, vps = (torch.randn(shape, generator=gen, device=dev,
                            dtype=lm.emb.dtype) for _ in range(2))
    bt = torch.from_numpy(tables(np.random.default_rng(SEED),
                                 [n + 1 for n in lens])).to(dev)
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    tokens = torch.zeros(S, dtype=torch.int64, device=dev)

    def step():
        return lm.decode_paged(tokens, kps, vps, bt, sl)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        step()
        b.record()
        need(not a.query(), "decode step: the spin ended before the step "
             "was queued, so its device time would hold host gaps")
        b.synchronize()
        device.append(a.elapsed_time(b))
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    q = torch.randn((S, lm.n_heads, lm.head_dim), generator=gen, device=dev,
                    dtype=lm.emb.dtype)
    k4 = time_ms(lambda: tpa.paged_flash_decode(q, kps[0], vps[0], bt,
                                                sl + 1), 50, flush)
    del flush, kps, vps
    res = {"slots": S, "lens": lens, "host_ms": float(np.median(host)),
           "device_ms": float(np.median(device)), "host_ms_all": host,
           "device_ms_all": device, "k4_ms": k4,
           "k4_ms_x_layers": k4 * lm.n_layers}
    res["device_share"] = res["device_ms"] / res["host_ms"]
    log("decode step (bucket 8): " + json.dumps(res))
    return res


# ----------------------------------------------------------------------
# phase 6: the flash kernels against their plain versions
# ----------------------------------------------------------------------

#: the least time for f32 work is at the card's fastest fp32-accurate
#: rate: 3xTF32 on the tensor cores, three TF32 products (495 TFLOP/s) per
#: fp32 product. It is PyTorch's own route for f32 attention: its
#: memory-efficient kernels take OpMultiplyAddFastF32, CUTLASS's 3xTF32
#: operator, for f32 on sm80 and later (torch/include/ATen/native/
#: transformers/cuda/mem_eff_attention/gemm_kernel_utils.h, whatever
#: allow_tf32 says), not the 67 TFLOP/s of the CUDA cores
PEAK_F32_OPS = 495e12 / 3
#: (name, B, H, Tq, Tk, D, causal); "train" is the main path's shape
FLASH_CASES = [("train", 8, 12, 512, 512, 64, False),
               ("train-causal", 8, 12, 512, 512, 64, True),
               ("padded", 2, 12, 500, 500, 64, True),
               ("cross", 2, 4, 24, 56, 16, False)]
#: input seeds and (B, H, T, D) of phase 6's comparison with an f64 answer
FLASH_F64_SEEDS = 8
FLASH_F64_SHAPE = (2, 12, 512, 64)


def flash_bounds(B, H, Tq, Tk, D, causal, item):
    """(K1, K2, K3, bwd) bound_ms and what bounds each: the operations
    each does on the (row, key) pairs these shapes need over the peak of
    their type, against the bytes it must move (each input read once,
    each output written once) over 3.35 TB/s. "bwd" is flash_bwd whole:
    delta = rowsum(do*o), then K2 and K3."""
    pairs = (sum(min(r + 1, Tk) for r in range(Tq)) if causal
             else Tq * Tk) * B * H
    peak = PEAK_BF16_OPS if item == 2 else PEAK_F32_OPS
    nq, nk, rows = B * H * Tq * D * item, B * H * Tk * D * item, B * H * Tq
    work = {"K1": (4 * pairs * D, 2 * nq + 2 * nk + 4 * rows),
            "K2": (6 * pairs * D, 3 * nq + 2 * nk + 8 * rows),
            "K3": (8 * pairs * D, 2 * nq + 4 * nk + 8 * rows),
            "bwd": (14 * pairs * D + 2 * rows * D, 4 * nq + 4 * nk + 4 * rows)}
    out = {}
    for k, (ops, nbytes) in work.items():
        t_ops, t_mem = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[k] = (max(t_ops, t_mem), "operations" if t_ops >= t_mem
                  else "bytes")
    return out


def flash_inputs(rng, dev, dtype, B, H, Tq, Tk, D):
    """q, k, v, do [B, H, T, D] from N(0, 1) in `dtype`."""
    import torch

    def randn(T):
        return torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(
            np.float32)).to(dev, dtype)
    return randn(Tq), randn(Tk), randn(Tk), randn(Tq)


def flash_plain(tfa, q, k, v, do, lse, delta, causal):
    """K1-K3's plain versions on these inputs: {"o", "lse", "dq", "dk",
    "dv"}, the backward from this lse and delta."""
    o, lse_out = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
    dk, dv = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    return {"o": o, "lse": lse_out,
            "dq": tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            "dk": dk, "dv": dv}


def flash_excess(tfa, q, k, v, do, lse, delta, causal, got):
    """excess_over_plain of each tensor of `got` (some of "o", "lse",
    "dq", "dk", "dv": K1's outputs and K2/K3's gradients at these inputs,
    the backward fed this lse and delta): the f64 answer is the plain
    version on f64 copies of the same inputs, lse and delta included."""
    plain = flash_plain(tfa, q, k, v, do, lse, delta, causal)
    exact = flash_plain(tfa, *(t.double() for t in (q, k, v, do, lse,
                                                     delta)), causal)
    return {w: excess_over_plain(x, plain[w], exact[w])
            for w, x in got.items()}


def flash_seed_sweep(tfa, dev, dtype, causal, seeds=FLASH_F64_SEEDS,
                     shape=FLASH_F64_SHAPE):
    """Phase 6's f64 gate: over `seeds` input seeds at `shape` (B, H, T,
    D), K1's o and lse and K2/K3's dq, dk and dv (fed the plain forward's
    lse and delta, as the checks against the plain version are) against
    the f64 answer; the worst flash_excess of each tensor."""
    B, Hh, T, D = shape
    worst = {}
    for seed in range(seeds):
        rng = np.random.default_rng(1000 + seed)
        q, k, v, do = flash_inputs(rng, dev, dtype, B, Hh, T, T, D)
        o_ref, lse = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
        delta = tfa._delta(do, o_ref)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        o, lse_k = tfa.flash_fwd(q, k, v, causal, need_lse=True)
        got = {"o": o, "lse": lse_k,
               "dq": tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
               "dk": dk, "dv": dv}
        for w, x in flash_excess(tfa, q, k, v, do, lse, delta, causal,
                                 got).items():
            worst[w] = max(worst.get(w, -math.inf), x)
    return worst


def flash_errors(tfa, q, k, v, do, causal):
    """K1-K3 against their plain versions at these inputs (the backward
    fed the plain forward's lse and delta): ({tensor: max abs error},
    {tensor: within phase 6's tolerance}, lse within rtol/atol 1e-5)."""
    import torch
    o, lse = tfa.flash_fwd(q, k, v, causal, need_lse=True)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, need_lse=True)
    delta = tfa._delta(do, o_ref)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    want = flash_plain(tfa, q, k, v, do, lse_ref, delta, causal)
    torch.cuda.synchronize()
    errs, oks = {}, {}
    for what, got in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        ref = want[what]
        errs[what] = float((got.float() - ref.float()).abs().max())
        if got.dtype == torch.float32:
            oks[what] = errs[what] <= 1e-4 * float(ref.abs().max())
        elif what == "o":
            oks[what] = bf16_close(got, ref, 2)
        else:
            oks[what] = rel_l2(got, ref) <= 1e-2
    return errs, oks, bool(torch.allclose(lse, lse_ref, rtol=1e-5,
                                          atol=1e-5))


def flash_timing(tfa, q, k, v, do, causal, errs, flush):
    """Phase 6's timing rows at these inputs: K1, K2, K3 and flash_bwd
    whole ("bwd": delta + K2 + K3), each beside its plain version,
    scaled_dot_product_attention's forward (K1) or whole backward (the
    others; a yardstick the port never calls) and its bound."""
    import torch
    import torch.nn.functional as F

    B, Hh, Tq, D = q.shape
    o, lse = tfa.flash_fwd(q, k, v, causal, need_lse=True)
    delta = tfa._delta(do, o)
    bounds = flash_bounds(B, Hh, Tq, k.shape[2], D, causal,
                          q.element_size())
    qs, ks, vs = (t.detach().clone().requires_grad_(True)
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                   retain_graph=True)

    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal), 20, flush)
    lib_bwd = time_ms(sdpa_bwd, 20, flush)
    timed = {
        "K1": (lambda: tfa.flash_fwd(q, k, v, causal, need_lse=True),
               lambda: tfa.flash_fwd_plain(q, k, v, causal, need_lse=True),
               lib_fwd, errs["o"]),
        "K2": (lambda: tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
               lambda: tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                              causal),
               lib_bwd, errs["dq"]),
        "K3": (lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
               lambda: tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               causal),
               lib_bwd, max(errs["dk"], errs["dv"])),
        "bwd": (lambda: tfa.flash_bwd(q, k, v, o, lse, do, causal),
                lambda: tfa.flash_bwd_plain(q, k, v, o, lse, do, causal),
                lib_bwd, max(errs["dq"], errs["dk"], errs["dv"])),
    }
    rows = {}
    for kname, (kern, plain, lib, err) in timed.items():
        rows[kname] = {
            "max_abs_err": err, "ms": time_ms(kern, 20, flush),
            "plain_ms": time_ms(plain, 5, flush), "library_ms": lib,
            "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1]}
    return rows


def check_flash(dev):
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    rng = np.random.default_rng(SEED)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "bfloat16" if dtype == torch.bfloat16 else "float32"
        for case, B, Hh, Tq, Tk, D, causal in FLASH_CASES:
            q, k, v, do = flash_inputs(rng, dev, dtype, B, Hh, Tq, Tk, D)
            errs, oks, lse_ok = flash_errors(tfa, q, k, v, do, causal)
            for what, ok in oks.items():
                need(ok, f"flash {what} {name} {case}: disagrees with the "
                     f"plain version, max err {errs[what]:.3e}")
            need(lse_ok, f"flash lse {name} {case}: disagrees with the "
                 "plain version")
            o, lse = tfa.flash_fwd(q, k, v, causal, need_lse=True)
            o2, lse2 = tfa.flash_fwd(q, k, v, causal, need_lse=True)
            need(torch.equal(o, o2) and torch.equal(lse, lse2),
                 f"flash forward {name} {case}: two runs differ")
            first = tfa.flash_bwd(q, k, v, o, lse, do, causal)
            second = tfa.flash_bwd(q, k, v, o, lse, do, causal)
            need(all(torch.equal(a, b) for a, b in zip(first, second)),
                 f"flash backward {name} {case}: two runs differ")
            log(f"flash {name} {case} (B {B} H {Hh} Tq {Tq} Tk {Tk} D {D} "
                f"causal {causal}): max_abs_err "
                + " ".join(f"{w} {e:.3e}" for w, e in errs.items())
                + "; forward and backward bitwise repeatable")
            if case == "train":
                for kname, r in flash_timing(tfa, q, k, v, do, causal, errs,
                                             flush).items():
                    rows[(kname, name)] = r
        for causal in (False, True):
            worst = flash_seed_sweep(tfa, dev, dtype, causal)
            log(f"flash f64 gate {name} causal {causal} ({FLASH_F64_SEEDS} "
                f"seeds, B H T D {FLASH_F64_SHAPE}): worst excess over the "
                "plain version, in steps: " + json.dumps(worst))
            for what, x in worst.items():
                need(x <= 1, f"flash {what} {name} causal {causal}: further "
                     f"from the f64 answer than the plain version by "
                     f"{x:.2f} steps")
    del flush
    for (kname, name), r in sorted(rows.items()):
        log(f"{kname} {name} train-shape timing: kernel_ms {r['ms']:.5f} "
            f"plain_ms {r['plain_ms']:.5f} library_ms {r['library_ms']:.5f}"
            f" bound_ms {r['bound_ms']:.6f} ({r['bound_by']})")
    for name in ("float32", "bfloat16"):
        r = rows[("bwd", name)]
        log(f"flash_bwd {name} (delta + K2 + K3) {r['ms']:.5f} ms against "
            f"SDPA's backward {r['library_ms']:.5f} ms: ratio "
            f"{r['ms'] / r['library_ms']:.3f}")
    return rows


# ----------------------------------------------------------------------
# phase 7: train the encoder at BERT-base widths
# ----------------------------------------------------------------------

#: Google Research bert, uncased_L-12_H-768_A-12/bert_config.json, whole
#: depth; batch 8 x max_position_embeddings
BERT_BASE = dict(hidden=768, heads=12, intermediate=3072, layers=12,
                 seq=512, initializer_range=0.02, batch=8)
TRAIN_STEPS = 20


def bert_encoder_conf(cfg):
    from deeplearning4j_tpu_torch.nn import (
        Adam, AttentionVertex, DataType, DenseLayer, ElementWiseVertex,
        FeedForwardToRnnPreProcessor, GlobalPoolingLayer, InputType,
        NeuralNetConfiguration, OutputLayer, PreprocessorVertex,
    )
    from deeplearning4j_tpu_torch.nn.weights import NormalDistribution

    F = cfg["hidden"]
    # weights from N(0, initializer_range^2), the published config's
    # init: with the default Xavier and no LayerNorm the residual stream
    # grows block by block until the last blocks' softmax saturates, and
    # the f32 loss and gradients stop being reproducible (check (a) then
    # fails against any f32 reference, this one included)
    b = (NeuralNetConfiguration.Builder().seed(SEED).updater(Adam(1e-4))
         .dist(NormalDistribution(0.0, cfg["initializer_range"]))
         .dataType(DataType.FLOAT).graphBuilder().addInputs("in"))
    prev = "in"
    for i in range(cfg["layers"]):
        b = (b.addVertex(f"attn{i}", AttentionVertex(
                nOut=F, nHeads=cfg["heads"], hasBias=True), prev)
             .addVertex(f"res1_{i}", ElementWiseVertex("add"), prev,
                        f"attn{i}")
             .addLayer(f"ffn1_{i}", DenseLayer(nOut=cfg["intermediate"],
                                               activation="gelu"),
                       f"res1_{i}")
             .addLayer(f"ffn2_{i}", DenseLayer(nOut=F, activation="identity"),
                       f"ffn1_{i}")
             .addVertex(f"seq{i}", PreprocessorVertex(
                 FeedForwardToRnnPreProcessor()), f"ffn2_{i}")
             .addVertex(f"res2_{i}", ElementWiseVertex("add"), f"res1_{i}",
                        f"seq{i}"))
        prev = f"res2_{i}"
    return (b.addLayer("gp", GlobalPoolingLayer(poolingType="avg"), prev)
            .addLayer("out", OutputLayer(nOut=2, activation="softmax",
                                         lossFunction="mcxent"), "gp")
            .setOutputs("out")
            .setInputTypes(InputType.recurrent(F, cfg["seq"])).build())


def reference_loss(params, x, y, cfg):
    """The encoder's f32 loss from its parameters in plain torch:
    materialised-score softmax attention, no kernel, no port module."""
    import torch
    import torch.nn.functional as F

    B, Fh, T = x.shape
    nh = cfg["heads"]
    dh = Fh // nh
    h = x
    for i in range(cfg["layers"]):
        a = params[f"attn{i}"]
        xt = h.transpose(1, 2)                            # [B, T, F]
        q, k, v = ((xt @ a[f"W{n}"] + a[f"b{n}"]).view(B, T, nh, dh)
                   .transpose(1, 2) for n in "qkv")
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1)
        att = (p @ v).transpose(1, 2).reshape(B, T, Fh) @ a["Wo"] + a["bo"]
        h = h + att.transpose(1, 2)
        f1, f2 = params[f"ffn1_{i}"], params[f"ffn2_{i}"]
        flat = h.transpose(1, 2).reshape(B * T, Fh)
        z = F.gelu(flat @ f1["W"] + f1["b"], approximate="tanh")
        z = z @ f2["W"] + f2["b"]
        h = h + z.reshape(B, T, Fh).transpose(1, 2)
    logits = h.mean(dim=2) @ params["out"]["W"] + params["out"]["b"]
    return -(y * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def encoder_batch(cfg, dev):
    """Phase 7's batch: random features [batch, hidden, seq] from seed 0
    and one-hot labels from a learnable rule (the sign of the first 64
    features' mean)."""
    import torch
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((cfg["batch"], cfg["hidden"], cfg["seq"])
                            ).astype(np.float32)
    cls = (x[:, :64].mean(axis=(1, 2)) > 0).astype(int)
    y = np.eye(2, dtype=np.float32)[cls]
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def fit_timed(net, x, y, steps, trainer=None):
    """`steps` fit steps of `trainer` (default `net`): (losses, host
    seconds of each step); each step ends in the loss fetch, which syncs
    the device."""
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        (trainer or net).fit(x, y)
        losses.append(net.score())
        step_s.append(time.perf_counter() - t)
    return losses, step_s


def train_and_check(dev, cfg):
    import torch

    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    t = time.perf_counter()
    net = ComputationGraph(bert_encoder_conf(cfg)).init()
    torch.cuda.synchronize()
    log(f"encoder: {net.numParams()} params on {net.device}, built in "
        f"{time.perf_counter() - t:.2f} s: {json.dumps(cfg)}")
    B, T = cfg["batch"], cfg["seq"]
    x, y = encoder_batch(cfg, dev)

    # 7a: one gradient against the smoke's own f32 reference
    grads, score = net.computeGradientAndScore(x, y)
    ref_params = {n: {k: t.detach().clone().requires_grad_(True)
                      for k, t in p.items()} for n, p in net._params.items()}
    ref = reference_loss(ref_params, x, y, cfg)
    flat = [(n, k, t) for n, p in ref_params.items() for k, t in p.items()]
    ref_grads = torch.autograd.grad(ref, [t for _, _, t in flat])
    ref_loss = float(ref.detach())
    loss_rel = abs(score - ref_loss) / abs(ref_loss)
    whole = math.sqrt(sum(float(g.double().square().sum())
                          for g in ref_grads))
    worst, worst_bk = 0.0, 0.0
    for (n, k, _), g in zip(flat, ref_grads):
        if k == "bk":
            err = float((grads[n][k].double() - g.double()).norm()) / whole
            worst_bk = max(worst_bk, err)
            need(err <= 1e-4, f"train (a): {n}.{k} gradient off the "
                 f"reference by {err:.3e} of the whole gradient")
        else:
            err = rel_l2(grads[n][k], g)
            worst = max(worst, err)
            need(err <= 1e-3, f"train (a): {n}.{k} gradient rel L2 "
                 f"{err:.3e} against the reference")
    need(loss_rel <= 1e-5, f"train (a): loss {score} vs reference "
         f"{ref_loss} (rel {loss_rel:.3e})")
    log(f"train (a): loss {score:.7f} vs f32 reference {ref_loss:.7f} "
        f"(rel {loss_rel:.3e}); worst gradient rel L2 {worst:.3e} over "
        f"{len(flat)} tensors; key-bias gradients (0 in exact arithmetic) "
        f"within {worst_bk:.3e} of the whole gradient's L2 {whole:.4e}")
    del grads, ref_params, ref, ref_grads

    # 7b: the main path, counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tfa.reset_launches()
    losses, step_s = fit_timed(net, x, y, TRAIN_STEPS)
    launches = {"K1": tfa.flash_fwd.launches, "K2": tfa.flash_bwd_dq.launches,
                "K3": tfa.flash_bwd_dkv.launches,
                "plain": tfa.flash_fwd_plain.launches
                + tfa.flash_bwd_dq_plain.launches
                + tfa.flash_bwd_dkv_plain.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_att = cfg["layers"] * TRAIN_STEPS
    need(launches["K1"] == n_att and launches["K2"] == n_att
         and launches["K3"] == n_att,
         f"train (b): kernel launches {launches}, expected {n_att} each")
    need(launches["plain"] == 0,
         f"train (b): a plain version ran on the card: {launches}")
    need(all(math.isfinite(v) for v in losses),
         f"train (b): non-finite loss: {losses}")
    need(losses[-1] < losses[0],
         f"train (b): loss did not fall: {losses[0]} -> {losses[-1]}")
    med = float(np.median(step_s[2:]))
    result = {"steps": TRAIN_STEPS, "losses": losses,
              "step_ms_median_3_to_20": med * 1e3,
              "step_ms_all": [s * 1e3 for s in step_s],
              "sequences_per_s": B / med, "tokens_per_s": B * T / med,
              "max_memory_allocated_bytes": peak, "launches": launches,
              "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                    for k in ("K1", "K2", "K3")}}
    log("train (b, c): " + json.dumps(result))
    return result


# ----------------------------------------------------------------------
# phase 8: zoo LeNet through MultiLayerNetwork
# ----------------------------------------------------------------------

#: zoo LeNet at its defaults (1x28x28, 10 classes, Adam(1e-3)), f32
LENET = dict(batch=64, examples=256, epochs=5, classes=10)


class TimedIterator:
    """Wraps a DataSetIterator: at each ``next`` it records the host time
    and the network's score (the loss of the step before it; the score
    fetch synchronises the device)."""

    def __init__(self, it, net):
        self.it, self.net = it, net
        self.times, self.scores = [], []

    def reset(self):
        self.it.reset()

    def hasNext(self):
        return self.it.hasNext()

    def next(self):
        self.scores.append(self.net.score())
        self.times.append(time.perf_counter())
        return self.it.next()


def grads_against(got, want):
    """The worst gradient rel L2 of `got` against `want` (same-structured
    dicts or lists of dicts of tensors)."""
    pairs = (zip(got, want) if isinstance(got, list)
             else ((got[n], want[n]) for n in want))
    worst = 0.0
    for g, w in pairs:
        for k in w:
            worst = max(worst, rel_l2(g[k].cpu(), w[k].cpu()))
    return worst


def lenet_and_check(dev, cfg):
    """Phase 8: the first step's loss and gradients on the card against
    the port on the CPU from the same weights; then fit(DataSetIterator)
    for epochs x examples/batch steps on the same data."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference
    from deeplearning4j_tpu_torch.zoo import LeNet

    rng = np.random.default_rng(SEED)
    x = rng.random((cfg["examples"], 784), dtype=np.float32)
    rule = rng.standard_normal((784, cfg["classes"]))   # a learnable label
    y = np.eye(cfg["classes"], dtype=np.float32)[(x @ rule).argmax(1)]
    net = LeNet(numClasses=cfg["classes"], seed=SEED, device=dev).init()
    cpu = LeNet(numClasses=cfg["classes"], seed=SEED, device="cpu").init()
    cpu.load_reference_params(params_to_reference(net.layers, net._params),
                              params_to_reference(net.layers, net._states))
    B = cfg["batch"]
    g_card, l_card = net.computeGradientAndScore(x[:B], y[:B])
    g_cpu, l_cpu = cpu.computeGradientAndScore(x[:B], y[:B])
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst = grads_against(g_card, g_cpu)
    need(loss_rel <= 1e-5, f"lenet: loss {l_card} on the card vs {l_cpu} "
         f"on the CPU (rel {loss_rel:.3e})")
    need(worst <= 1e-4, f"lenet: a gradient rel L2 {worst:.3e} against "
         "the CPU's")
    log(f"lenet (a): {net.numParams()} params; first-step loss {l_card:.7f} "
        f"vs the CPU's {l_cpu:.7f} (rel {loss_rel:.3e}); worst gradient "
        f"rel L2 {worst:.3e}")
    it = TimedIterator(DataSetIterator(x, y, B, shuffle=True, seed=SEED),
                       net)
    torch.cuda.synchronize()
    net.fit(it, epochs=cfg["epochs"])
    t_end = time.perf_counter()
    losses = it.scores[1:] + [net.score()]
    step_s = np.diff(it.times + [t_end])
    steps = cfg["epochs"] * cfg["examples"] // B
    need(len(losses) == steps and net.getIterationCount() == steps,
         f"lenet (b): {len(losses)} steps, expected {steps}")
    need(all(math.isfinite(v) for v in losses),
         f"lenet (b): non-finite loss: {losses}")
    per_epoch = steps // cfg["epochs"]
    first, last = np.mean(losses[:per_epoch]), np.mean(losses[-per_epoch:])
    need(last < first, f"lenet (b): the mean loss of an epoch did not fall: "
         f"{first} -> {last}")
    med = float(np.median(step_s[2:]))
    result = {"steps": steps, "losses": losses,
              "epoch_mean_loss_first": first, "epoch_mean_loss_last": last,
              "step_ms_median_3_on": med * 1e3,
              "images_per_s": B / med}
    log("lenet (b): " + json.dumps(result))
    return result


# ----------------------------------------------------------------------
# phase 9: zoo ResNet50 through ComputationGraph
# ----------------------------------------------------------------------

#: 9(a): the parity shape of tests/test_torch_zoo_resnet.py
RESNET_PARITY = dict(batch=4, image=64, classes=8)
#: how far the reference's own f32 gradient lies from its f64 gradient at
#: that shape (tests/test_torch_zoo_resnet.py: up to 2.6e-2 rel L2, from
#: relu outputs that change sign between summation orders)
REF_F32_GRAD_TO_F64 = 2.6e-2
#: 9(b): the reference's headline settings (bench.py _measure_resnet50)
RESNET_TIMED = dict(batch=128, image=224, classes=1000, steps=20,
                    traced_steps=3)


def resnet_net(dev, cfg, dtype="FLOAT", **kw):
    from deeplearning4j_tpu_torch.nn import DataType
    from deeplearning4j_tpu_torch.zoo import ResNet50

    return ResNet50(numClasses=cfg["classes"], seed=SEED,
                    inputShape=(3, cfg["image"], cfg["image"]),
                    dataType=getattr(DataType, dtype), device=dev,
                    **kw).init()


def resnet_parity(dev, cfg):
    """Phase 9(a): f32 with TF32 off and cudnn.benchmark off, and f64,
    on the card against the port on the CPU from the same weights, with
    tests/test_torch_zoo_resnet.py's bars: f64 loss rel 1e-10, each
    gradient rel L2 1e-9, BN running statistics after one fit step rel
    1e-6, params after that Nesterovs step within 1e-10 of each tensor's
    max-abs; f32 loss within 1e-5 of the f64 loss, each f32 gradient no
    further from the f64 gradient than 1.25x the worst of the CPU's f32
    gradients (or the reference's own worst f32 distance,
    REF_F32_GRAD_TO_F64, where larger: which relu outputs change sign
    differs between summation orders) plus 1e-3, eval output max abs
    1e-4."""
    import torch

    from deeplearning4j_tpu_torch.nn.graph import params_to_reference

    torch.backends.cudnn.benchmark = False
    card32 = resnet_net(dev, cfg)
    params = params_to_reference(card32.conf, card32._params)
    states = params_to_reference(card32.conf, card32._states)

    def carried(d, dtype):
        return resnet_net(d, cfg, dtype).load_reference_params(params,
                                                               states)

    cpu32, cpu64, card64 = (carried("cpu", "FLOAT"), carried("cpu", "DOUBLE"),
                            carried(dev, "DOUBLE"))
    rng = np.random.default_rng(SEED)
    B, n = cfg["batch"], cfg["image"]
    x = rng.standard_normal((B, 3, n, n)).astype(np.float32)
    y = np.eye(cfg["classes"], dtype=np.float32)[
        rng.integers(0, cfg["classes"], B)]
    res = {}
    for name, net in (("card32", card32), ("cpu32", cpu32),
                      ("cpu64", cpu64), ("card64", card64)):
        res[name] = net.computeGradientAndScore(x, y)
    g64, l64 = res["cpu64"]
    rel64 = abs(res["card64"][1] - l64) / abs(l64)
    worst64 = grads_against(res["card64"][0], g64)
    need(rel64 <= 1e-10 and worst64 <= 1e-9,
         f"resnet (a): f64 loss rel {rel64:.3e}, worst gradient "
         f"{worst64:.3e} on the card against the CPU")
    rel32 = abs(res["card32"][1] - l64) / abs(l64)
    need(rel32 <= 1e-5, f"resnet (a): f32 loss {res['card32'][1]} vs the "
         f"f64 loss {l64} (rel {rel32:.3e})")
    worst32 = grads_against(res["card32"][0], g64)
    bar = 1.25 * max(grads_against(res["cpu32"][0], g64),
                     REF_F32_GRAD_TO_F64) + 1e-3
    need(worst32 <= bar, f"resnet (a): an f32 gradient on the card is "
         f"{worst32:.3e} from f64, past {bar:.3e}")
    out_err = float(np.abs(card32.output(x).toNumpy()
                           - cpu32.output(x).toNumpy()).max())
    need(out_err <= 1e-4, f"resnet (a): eval output max abs {out_err:.3e}")
    for net in (cpu64, card64):
        net.fit(x, y)
    worst_state = max(rel_l2(card64._states[n][k].cpu(), w)
                      for n, st in cpu64._states.items()
                      for k, w in st.items())
    with torch.no_grad():
        worst_step = max(float((card64._params[n][k].cpu() - w).abs().max()
                               / w.abs().max().clamp_min(1e-300))
                         for n, p in cpu64._params.items()
                         for k, w in p.items())
    need(worst_state <= 1e-6 and worst_step <= 1e-10,
         f"resnet (a): after one f64 fit step, BN statistics rel "
         f"{worst_state:.3e}, params {worst_step:.3e}")
    result = {"f64_loss_rel": rel64, "f64_worst_grad_rel_l2": worst64,
              "f32_loss_rel_to_f64": rel32,
              "f32_worst_grad_rel_l2_to_f64": worst32,
              "eval_output_max_abs": out_err,
              "bn_stats_rel_after_step": worst_state,
              "params_rel_after_nesterovs_step": worst_step}
    log("resnet (a): " + json.dumps(result))
    return result


def resnet_forward_flops(conf, batch):
    """Multiply-adds x 2 of the forward's convolutions and dense layers,
    from the conf's shapes."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    total = 0
    for name in conf.topoOrder:
        node = conf.nodes[name]
        layer = node.payload
        if node.kind != "layer":
            continue
        if isinstance(layer, L.ConvolutionLayer):
            out = layer.getOutputType(node.layerInputType)
            kh, kw = layer.kernelSize
            total += 2 * batch * out.height * out.width * out.channels \
                * layer.nIn * kh * kw
        elif isinstance(layer, L.FeedForwardLayer):
            total += 2 * batch * layer.nIn * layer.nOut
    return total


def resnet_batch(dev, cfg, rows):
    """Phase 9(b)'s seeded NHWC bf16 batch (`rows` rows) and one-hot
    labels, on `dev`."""
    import torch

    n = cfg["image"]
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.rand(rows, n, n, 3).astype(np.float32)).to(
        dev, torch.bfloat16)
    y = torch.from_numpy(np.eye(cfg["classes"], dtype=np.float32)[
        rng.randint(0, cfg["classes"], rows)]).to(dev)
    return x, y


def resnet_timed(dev, cfg):
    """Phase 9(b): the reference's headline configuration, one fixed
    seeded batch resident on the card, cfg["steps"] fit steps."""
    import torch

    from deeplearning4j_tpu_torch.nn import Nesterovs

    # a repeatable trajectory: the heuristic's algorithms, deterministic
    # ones (module docstring, phase 9(b))
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t = time.perf_counter()
    net = resnet_net(dev, cfg, "BFLOAT16", dataFormat="NHWC",
                     updater=Nesterovs(0.1, 0.9))
    torch.cuda.synchronize()
    B = cfg["batch"]
    x, y = resnet_batch(dev, cfg, B)
    log(f"resnet (b): {net.numParams()} params on {net.device}, built in "
        f"{time.perf_counter() - t:.2f} s; NHWC bf16 batch {tuple(x.shape)} "
        "resident on the card; cudnn.benchmark off, deterministic "
        "algorithms, TF32 off (bf16 convs "
        "and matmuls run on the tensor cores)")
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = fit_timed(net, x, y, cfg["steps"])
    peak = torch.cuda.max_memory_allocated(dev)
    need(all(math.isfinite(v) for v in losses),
         f"resnet (b): non-finite loss: {losses}")
    need(losses[-1] < losses[0],
         f"resnet (b): loss did not fall: {losses[0]} -> {losses[-1]}")
    med = float(np.median(step_s[2:]))
    flops = 3 * resnet_forward_flops(net.conf, B)
    result = {"steps": cfg["steps"], "loss_step1": losses[0],
              f"loss_step{cfg['steps']}": losses[-1], "losses": losses,
              "step_ms_median_3_on": med * 1e3,
              "step_ms_all": [s * 1e3 for s in step_s],
              "images_per_s": B / med, "max_memory_allocated_bytes": peak,
              "train_flops_per_step": flops,
              "share_of_bf16_dense_peak": flops / med / PEAK_BF16_OPS,
              "cudnn_benchmark": False, "cudnn_deterministic": True}
    log("resnet (b): " + json.dumps(result))
    return net, x, y, result


#: phase 9(c)'s categories: forward scopes the smoke opens around each
#: layer kind, and the autograd nodes of the backward
TRACE_FORWARD = {"ConvolutionLayer": "conv", "BatchNormalization": "bn",
                 "SubsamplingLayer": "max_pool",
                 "GlobalPoolingLayer": "global_pool",
                 "ActivationLayer": "elementwise",
                 "ElementWiseVertex": "elementwise",
                 "dense": "dense_and_loss", "loss": "dense_and_loss",
                 "update": "update"}
TRACE_BACKWARD = (("Convolution", "conv"), ("BNTrainFn", "bn"),
                  ("BNActTrainFn", "bn"), ("BNActAddTrainFn", "bn"),
                  ("MaxPool", "max_pool"), ("MeanBackward1", "global_pool"),
                  ("Relu", "elementwise"), ("Threshold", "elementwise"),
                  ("AddBackward", "elementwise"), ("Mm", "dense_and_loss"),
                  ("Addmm", "dense_and_loss"),
                  ("LogSoftmax", "dense_and_loss"),
                  ("MulBackward", "dense_and_loss"),
                  ("NegBackward", "dense_and_loss"),
                  ("SumBackward", "dense_and_loss"),
                  ("MeanBackward0", "dense_and_loss"),
                  ("DivBackward", "dense_and_loss"),
                  ("SubBackward", "dense_and_loss"),
                  ("AmaxBackward", "dense_and_loss"),
                  ("ExpBackward", "dense_and_loss"),
                  ("LogBackward", "dense_and_loss"),
                  ("ToCopyBackward", "casts"))


def _scoped(fn, name):
    import torch

    def wrapped(*a, **kw):
        with torch.profiler.record_function("smoke:" + name):
            return fn(*a, **kw)
    return wrapped


def trace_scopes():
    """[(owner, attribute, original)] after wrapping each layer kind's
    forward, the vertex add, the loss and the updater step in a named
    profiler scope (the trace's forward attribution)."""
    from deeplearning4j_tpu_torch.nn import graph, multilayer
    from deeplearning4j_tpu_torch.nn.conf import graph as G
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    targets = [(getattr(L, n), "forward", n) for n in (
        "ConvolutionLayer", "BatchNormalization", "SubsamplingLayer",
        "GlobalPoolingLayer", "ActivationLayer")]
    # both networks step each layer through multilayer.update_layer
    targets += [(G.ElementWiseVertex, "apply", "ElementWiseVertex"),
                (L.BaseOutputLayer, "preoutput", "dense"),
                (graph.ComputationGraph, "_loss", "loss"),
                (multilayer, "default_param_update", "update")]
    saved = []
    for owner, attr, name in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, _scoped(fn, name))
    return saved


def classify(evt):
    """The category of the kernels a CPU event launched, from its own
    name and its ancestors': a smoke scope, else an autograd node."""
    e = evt
    while e is not None:
        if e.name.startswith("smoke:"):
            return TRACE_FORWARD[e.name[6:]]
        e = e.cpu_parent
    e = evt
    while e is not None:
        if e.name.startswith("autograd::engine::evaluate_function: "):
            node = e.name.split(": ", 1)[1]
            for key, cat in TRACE_BACKWARD:
                if key in node:
                    return cat
            return "other:" + node
        e = e.cpu_parent
    e = evt
    while e is not None:
        if e.name == "aten::_to_copy":   # the bf16 casts of the params
            return "casts"
        e = e.cpu_parent
    return "other:" + evt.name


def device_busy_us(events, t0, t1):
    """The device's busy time within [t0, t1] (us): the union of its
    kernels' and copies' spans in a profiler trace, the profiler's own
    GPU annotations left out."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.time_range.end > t0 and e.time_range.start < t1)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        s, e = max(s, t0), min(e, t1)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def resnet_trace(net, x, y, steps, untraced_step_ms):
    """Phase 9(c): a torch.profiler trace of `steps` fit steps: device
    time by category, and the device's idle share: of the traced wall
    time (which the profiler itself stretches) and of the untraced step,
    `untraced_step_ms` (9(b)'s median) less the traced busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = trace_scopes()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                with record_function("smoke.step"):
                    net.fit(x, y)
                    net.score()
            torch.cuda.synchronize()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    events = prof.events()
    by_cat, other, bn_ops, launches = {}, {}, {}, 0
    for evt in events:
        for k in evt.kernels:
            launches += 1
            cat = classify(evt)
            if cat.startswith("other:"):
                other[cat[6:]] = other.get(cat[6:], 0.0) + k.duration
                cat = "other"
            elif cat == "bn":
                bn_ops[evt.name] = bn_ops.get(evt.name, 0.0) + k.duration
            by_cat[cat] = by_cat.get(cat, 0.0) + k.duration
    step_evts = [e for e in events if e.name == "smoke.step"
                 and e.device_type == torch.autograd.DeviceType.CPU]
    need(len(step_evts) == steps, f"resnet (c): {len(step_evts)} step "
         f"scopes in the trace, expected {steps}")
    t0 = min(e.time_range.start for e in step_evts)
    t1 = max(e.time_range.end for e in step_evts)
    busy = device_busy_us(events, t0, t1)
    device_us = sum(by_cat.values())
    need(device_us > 0, "resnet (c): the profiler saw no device time")
    wall_us = t1 - t0
    result = {"steps": steps,
              "wall_ms_per_step": wall_us / 1e3 / steps,
              "device_ms_per_step": {c: v / 1e3 / steps
                                     for c, v in sorted(by_cat.items())},
              "device_share": {c: v / device_us
                               for c, v in sorted(by_cat.items())},
              "device_busy_ms_per_step": busy / 1e3 / steps,
              "device_idle_share_of_traced_wall": 1 - busy / wall_us,
              "device_idle_share_of_untraced_step":
                  1 - busy / 1e3 / steps / untraced_step_ms,
              "kernel_launches_per_step": launches / steps,
              "bn_ms_per_step_by_op": sorted(((v / 1e3 / steps, n)
                                              for n, v in bn_ops.items()),
                                             reverse=True)[:10],
              "other_top": sorted(((v / 1e3 / steps, n)
                                   for n, v in other.items()),
                                  reverse=True)[:8]}
    log("resnet (c): " + json.dumps(result))
    return result


# ----------------------------------------------------------------------
# phase 10: the ND4J array layer on the card
# ----------------------------------------------------------------------

#: ResNet-50's parameter count: the length of phase 10's gradient-sized
#: vector for the codecs
COMPRESS_N = 25_557_032
RNG_DRAWS = 1 << 24
GEMM_N = 4096


def _moments_ok(t, mean, sd, kurtosis, what):
    """The sample mean and std of `t` within 5 sigma of their expected
    values (the std's sigma from the distribution's kurtosis)."""
    n = t.numel()
    td = t.double()
    m, s = float(td.mean()), float(td.std())
    se_m, se_s = sd / math.sqrt(n), sd * math.sqrt((kurtosis - 1) / (4 * n))
    need(abs(m - mean) <= 5 * se_m and abs(s - sd) <= 5 * se_s,
         f"nd4j (c): {what} mean {m} (want {mean} +- {5 * se_m:.2e}), std "
         f"{s} (want {sd} +- {5 * se_s:.2e})")
    return {"mean": m, "std": s, "mean_sigmas": (m - mean) / se_m,
            "std_sigmas": (s - sd) / se_s}


def nd4j_and_check(dev):
    """Phase 10: value semantics, host-side bounds, the seeded RNG,
    gemm and the codecs, on arrays the factories put on the card."""
    import torch

    from deeplearning4j_tpu_torch.ndarray import INDArray, Nd4j
    from deeplearning4j_tpu_torch.ndarray import NDArrayIndex as I
    from deeplearning4j_tpu_torch.ndarray import compression as C

    # (a) value semantics: nothing aliases
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    a = Nd4j.create(base)                 # no device asked for: the card
    need(a.tensor().is_cuda, f"nd4j (a): Nd4j.create landed on {a.device}")
    views = (lambda t: t.getRow(0), lambda t: t.getColumn(1),
             lambda t: t.get(I.interval(0, 2), I.all()), lambda t: t[0],
             lambda t: INDArray(t), lambda t: t.transpose(),
             lambda t: t.slice(1))
    mutations = (lambda v: v.addi(1.0), lambda v: v.assign(7.0),
                 lambda v: v.putScalar(0, 99.0),
                 lambda v: v.__setitem__(0, -5.0), lambda v: v.negi())
    for view in views:
        for mutate in mutations:
            mutate(view(a))
    need(np.array_equal(a.toNumpy(), base),
         "nd4j (a): a view's in-place op changed its parent")
    row, shared = a.getRow(0), INDArray(a)
    a.addi(1.0).putScalar(0, 0, 50.0)
    a[1] = 0.0
    need(np.array_equal(row.toNumpy(), base[0])
         and np.array_equal(shared.toNumpy(), base),
         "nd4j (a): a parent's in-place op changed a view")

    # (b) bounds on the host: IndexError, no device assert
    a = Nd4j.create(base)
    calls = (("getDouble", lambda: a.getDouble(3, 0)),
             ("getDouble linear", lambda: a.getDouble(12)),
             ("get indices", lambda: a.get(I.indices(0, 3))),
             ("get point", lambda: a.get(I.point(3))),
             ("putScalar", lambda: a.putScalar(0, 4, 1.0)),
             ("getitem array", lambda: a[[0, 5]]))
    raised = []
    for name, call in calls:
        try:
            call()
        except IndexError:
            raised.append(name)
    need(len(raised) == len(calls), f"nd4j (b): only {raised} raised "
         "IndexError")
    torch.cuda.synchronize()    # a device-side assert would surface here
    need(np.array_equal(a.toNumpy(), base) and float(a.sum()) == 66.0,
         "nd4j (b): the array or the context changed")

    # (c) seeded draws repeat on the card; moments at 2^24 draws
    n = RNG_DRAWS
    rng_stats = {}
    for name, draw, mean, sd, kurt in (
            ("rand", Nd4j.rand, 0.5, 1 / math.sqrt(12), 1.8),
            ("randn", Nd4j.randn, 0.0, 1.0, 3.0)):
        x1, x2 = draw(n, seed=1234), draw(n, seed=1234)
        need(x1.tensor().is_cuda and torch.equal(x1.tensor(), x2.tensor()),
             f"nd4j (c): {name}(seed=1234) did not repeat on the card")
        Nd4j.getRandom().setSeed(99)
        g1 = draw(n)
        Nd4j.getRandom().setSeed(99)
        g2 = draw(n)
        need(torch.equal(g1.tensor(), g2.tensor())
             and not torch.equal(g1.tensor(), x1.tensor()),
             f"nd4j (c): {name}'s global stream did not repeat from setSeed")
        rng_stats[name] = _moments_ok(x1.tensor(), mean, sd, kurt, name)
        del x1, x2, g1, g2

    # (d) gemm at 4096^2 f32 (TF32 off) against float64 numpy
    A, Bm, Cm = (Nd4j.randn(GEMM_N, GEMM_N, seed=s) for s in (1, 2, 3))
    got = Nd4j.gemm(A, Bm, transposeA=True, transposeB=True, alpha=0.5,
                    beta=2.0, c=Cm)
    An, Bn, Cn = (t.toNumpy().astype(np.float64) for t in (A, Bm, Cm))
    want = 0.5 * (An.T @ Bn.T) + 2.0 * Cn
    gemm_err = float(np.linalg.norm(got.toNumpy() - want)
                     / np.linalg.norm(want))
    need(gemm_err <= 1e-5, f"nd4j (d): gemm rel L2 {gemm_err:.3e} against "
         "float64")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    times = []
    for _ in range(6):
        ev[0].record()
        Nd4j.gemm(A, Bm, transposeA=True, transposeB=True, alpha=0.5,
                  beta=2.0, c=Cm)
        ev[1].record()
        ev[1].synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    gemm_ms = float(np.median(times[1:]))
    del A, Bm, Cm, got, An, Bn, Cn, want

    # (e) the codecs on a gradient-sized vector, exactly numpy's answer
    v = Nd4j.randn(COMPRESS_N, seed=SEED)
    vn = v.toNumpy()
    comp = Nd4j.getCompressor()
    tau = 2.5
    ca = comp.compress(v, "THRESHOLD", threshold=tau)
    idx = np.flatnonzero(np.abs(vn) >= tau).astype(np.int32)
    need(np.array_equal(ca.extra["indices"], idx)
         and np.array_equal(ca.payload, np.sign(vn[idx]).astype(np.int8))
         and ca.extra["threshold"] == np.float32(tau),
         "nd4j (e): THRESHOLD payload differs from numpy's")
    dense = np.zeros_like(vn)
    dense[idx] = np.sign(vn[idx]) * np.float32(tau)
    back = comp.decompress(ca)
    need(back.tensor().is_cuda and np.array_equal(back.toNumpy(), dense),
         "nd4j (e): THRESHOLD decode differs from numpy's")
    ci = comp.compress(v, "INT8")
    scale = float(np.max(np.abs(vn))) / 127.0
    q = np.clip(np.round(vn / scale), -127, 127).astype(np.int8)
    need(np.array_equal(ci.payload, q) and ci.extra == np.float32(scale),
         "nd4j (e): INT8 payload differs from numpy's")
    cap = C.threshold_cap(COMPRESS_N, 0.01)
    ti, tv, td, tr = C.threshold_encode_fixed(v.tensor(), 1.0, cap)
    order = np.argsort(-np.abs(vn), kind="stable")[:cap]
    cand = vn[order]
    val = np.where(np.abs(cand) >= np.float32(1.0),
                   np.sign(cand) * np.float32(1.0), np.float32(0.0))
    ndense = np.zeros_like(vn)
    ndense[order] = val
    n_ties = int(np.sum(np.diff(np.abs(vn[order])) == 0))
    need(ti.is_cuda and np.array_equal(ti.cpu().numpy(),
                                       order.astype(np.int32))
         and np.array_equal(tv.cpu().numpy(), val)
         and np.array_equal(td.cpu().numpy(), ndense)
         and np.array_equal(tr.cpu().numpy(), vn - ndense),
         "nd4j (e): threshold_encode_fixed differs from numpy's")
    result = {"value_semantics": "ok", "index_errors": raised,
              "rng": rng_stats, "gemm_rel_l2_to_f64": gemm_err,
              "gemm_4096_ms": gemm_ms,
              "gemm_tflops": 2 * GEMM_N ** 3 / gemm_ms / 1e9,
              "threshold_indices": int(idx.size), "int8_scale": scale,
              "encode_fixed_cap": cap, "encode_fixed_tied_pairs": n_ties}
    log("nd4j: " + json.dumps(result))
    return result


# ----------------------------------------------------------------------
# phase 11: SameDiff on the card
# ----------------------------------------------------------------------

#: BASELINE config 2 (bench.py bench_samediff_mlp): 784 -> 256 relu ->
#: 10, softmaxCrossEntropy, Adam(1e-3), f32, RandomState(7) data
SD_MLP = dict(batch=256, inputs=784, hidden=256, classes=10, seed=7,
              lr=1e-3, steps=20)
#: the CPU test's trajectory band (tests/test_torch_samediff.py)
SD_TRAJ_RTOL = 1e-5
#: the f32 band where the first step's relu took the other side on the
#: card for a pre-activation within f32 rounding of 0: that unit's column
#: of w1 and b1 then moves by ~3e-3 of its norm, and Adam carries it to
#: ~7e-4 of the loss over 20 steps (H100, port PR 7); the f64 trajectory
#: holds the port to the CPU at 1e-10 all the same
SD_TRAJ_FLIP_RTOL = 1e-3


def sd_mlp(device, cfg, dtype="float32"):
    """bench.py's graph and data (drawn in float32, then cast to
    `dtype`) on `device` (None: the card)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.nn import Adam

    rs = np.random.RandomState(cfg["seed"])
    B, F, H, O = cfg["batch"], cfg["inputs"], cfg["hidden"], cfg["classes"]
    X = rs.rand(B, F).astype("float32").astype(dtype)
    Y = np.eye(O, dtype=dtype)[rs.randint(0, O, B)]
    sd = SameDiff.create(device=device)
    x = sd.placeHolder("x", dtype, B, F)
    y = sd.placeHolder("y", dtype, B, O)
    w1 = sd.var("w1", (rs.randn(F, H) * 0.05).astype("float32").astype(dtype))
    b1 = sd.var("b1", np.zeros(H, dtype=dtype))
    w2 = sd.var("w2", (rs.randn(H, O) * 0.05).astype("float32").astype(dtype))
    b2 = sd.var("b2", np.zeros(O, dtype=dtype))
    h = sd.nn.relu(sd.nn.linear(x, w1, b1), name="h")
    logits = sd.nn.linear(h, w2, b2, name="logits")
    sd.loss.softmaxCrossEntropy(y, logits, name="loss")
    sd.setTrainingConfig(TrainingConfig.Builder()
                         .updater(Adam(learningRate=cfg["lr"]))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    return sd, X, Y


def grads_rel(got, want, cols=None):
    """The worst rel L2 over {name: INDArray} gradients; `cols`, a bool
    mask over the hidden units, keeps only those columns of w1 and b1."""
    worst = 0.0
    for n in want:
        a, b = got[n].toNumpy().astype(np.float64), want[n].toNumpy()
        if cols is not None and n in ("w1", "b1"):
            a, b = a[..., cols], b[..., cols]
        worst = max(worst, float(np.linalg.norm(a - b)
                                 / max(np.linalg.norm(b), 1e-30)))
    return worst


def samediff_mlp(dev, cfg):
    """Phase 11(a): the first step against the CPU port, the fit
    trajectory, steps/s of fit and fitSteps, the device's busy share."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from deeplearning4j_tpu_torch.autodiff import SameDiff

    wrt = ("w1", "b1", "w2", "b2")
    # f64: the same graph on the card and on the CPU
    c64, X64, Y64 = sd_mlp(None, cfg, "float64")
    p64, _, _ = sd_mlp("cpu", cfg, "float64")
    f64 = {"x": X64, "y": Y64}
    l64 = [float(g.output(f64, ["loss"])["loss"].toNumpy())
           for g in (c64, p64)]
    rel64 = abs(l64[0] - l64[1]) / abs(l64[1])
    g64 = grads_rel(c64.calculateGradients(f64, *wrt),
                    p64.calculateGradients(f64, *wrt))
    need(rel64 <= 1e-10 and g64 <= 1e-10, f"sd mlp: f64 on the card vs "
         f"the CPU: loss rel {rel64:.3e}, gradient rel {g64:.3e}")
    steps = cfg["steps"]
    h64 = c64.fit(features=X64, labels=Y64, epochs=steps)
    hp64 = p64.fit(features=X64, labels=Y64, epochs=steps)
    traj64 = max(abs(a - b) / abs(b) for a, b in zip(h64, hp64))
    need(traj64 <= 1e-10, f"sd mlp: the f64 {steps}-step trajectory on the "
         f"card is off the CPU's by rel {traj64:.3e}")
    del c64, p64
    # f32: the loss, and the gradients of every hidden unit whose relu
    # took the same side on both devices (a pre-activation within f32
    # rounding of 0 may flip, and moves its column of w1 and b1 by
    # ~1e-3 of their norm: the problem's conditioning, not the port's)
    card, X, Y = sd_mlp(None, cfg)          # None: the card
    cpu, _, _ = sd_mlp("cpu", cfg)
    need(card.device.type == "cuda", f"sd mlp: graph on {card.device}")
    feed = {"x": X, "y": Y}
    lc = float(card.output(feed, ["loss"])["loss"].toNumpy())
    lp = float(cpu.output(feed, ["loss"])["loss"].toNumpy())
    hc = card.output(feed, ["h"])["h"].toNumpy() > 0
    hp = cpu.output(feed, ["h"])["h"].toNumpy() > 0
    flips = int((hc != hp).sum())
    same_side = ~(hc != hp).any(0)
    gc = card.calculateGradients(feed, *wrt)
    gp = cpu.calculateGradients(feed, *wrt)
    gworst = grads_rel(gc, gp, same_side)
    gall = grads_rel(gc, gp)
    loss_rel = abs(lc - lp) / abs(lp)
    need(loss_rel <= 1e-5 and gworst <= 1e-5 and flips <= 2,
         f"sd mlp: first step on the card vs the CPU: loss rel "
         f"{loss_rel:.3e}, gradient rel {gworst:.3e} over the units "
         f"whose relu agrees ({flips} relu flips)")
    hc = card.fit(features=X, labels=Y, epochs=steps)
    hp = cpu.fit(features=X, labels=Y, epochs=steps)
    traj = max(abs(a - b) / abs(b) for a, b in zip(hc, hp))
    traj_c64 = max(abs(a - b) / abs(b) for a, b in zip(hc, h64))
    traj_p64 = max(abs(a - b) / abs(b) for a, b in zip(hp, h64))
    band = SD_TRAJ_RTOL if flips == 0 else SD_TRAJ_FLIP_RTOL
    need(max(traj, traj_c64) <= band and hc[-1] < hc[0], f"sd mlp: the f32 "
         f"{steps}-step trajectory on the card is off the CPU's by rel "
         f"{traj:.3e} and off the f64 one by {traj_c64:.3e} (band {band}, "
         f"{flips} relu flips at step 1): {hc} vs {hp}")
    again, _, _ = sd_mlp(None, cfg)
    fs = again.fitSteps(X, Y, numSteps=steps)
    need(abs(fs - hc[-1]) <= 1e-6 * abs(hc[-1]), f"sd mlp: fitSteps({steps})"
         f" ended at {fs}, {steps} fit calls at {hc[-1]}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    card.fit(features=X, labels=Y, epochs=steps)
    fit_s = time.perf_counter() - t
    t = time.perf_counter()
    card.fitSteps(X, Y, numSteps=steps)
    fs_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function("smoke.sd_step"):
                card.fit(features=X, labels=Y)
        torch.cuda.synchronize()
    events = prof.events()
    step_evts = [e for e in events if e.name == "smoke.sd_step"
                 and e.device_type == torch.autograd.DeviceType.CPU]
    t0 = min(e.time_range.start for e in step_evts)
    t1 = max(e.time_range.end for e in step_evts)
    busy = device_busy_us(events, t0, t1)
    n_kernels = sum(len(e.kernels) for e in events)
    need(busy > 0, "sd mlp: the profiler saw no device time")
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/mlp.zip"
        card.save(path)
        back = SameDiff.load(path)
        a = card.output(feed, ["logits"])["logits"].tensor()
        b = back.output(feed, ["logits"])["logits"].tensor()
        need(back.device.type == "cuda" and torch.equal(a, b),
             "sd mlp (c): the loaded graph's output differs")
    result = {"f64_loss_rel": rel64, "f64_worst_grad_rel_l2": g64,
              "first_step_loss_rel": loss_rel,
              "first_step_worst_grad_rel_l2_same_relu_side": gworst,
              "first_step_worst_grad_rel_l2_all": gall,
              "relu_flips": flips,
              "f64_trajectory_worst_rel": traj64,
              "f32_trajectory_worst_rel_to_cpu": traj,
              "f32_trajectory_worst_rel_to_f64": traj_c64,
              "cpu_f32_trajectory_worst_rel_to_f64": traj_p64,
              "losses": hc,
              "fit_steps_per_s": steps / fit_s,
              "fitSteps_steps_per_s": steps / fs_s,
              "traced_wall_ms_per_step": (t1 - t0) / 1e3 / steps,
              "device_busy_ms_per_step": busy / 1e3 / steps,
              "device_busy_share_of_traced_wall": busy / (t1 - t0),
              "kernels_per_step": n_kernels / steps,
              "save_load": "bitwise"}
    log("sd mlp: " + json.dumps(result))
    return result


class _PlainFlash:
    """Routes ``flash_attention`` to the kernels' plain versions on the
    card for the length of a ``with`` (phase 11(b)'s comparison): K1's
    plain forward with its lse, then the plain backward."""

    def __enter__(self):
        import torch

        from deeplearning4j_tpu_torch.ops import flash_attention as tfa

        class Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal):
                o, lse = tfa.flash_fwd_plain(q, k, v, causal=causal,
                                             need_lse=True)
                ctx.causal = causal
                ctx.save_for_backward(q, k, v, o, lse)
                return o

            @staticmethod
            def backward(ctx, do):
                q, k, v, o, lse = ctx.saved_tensors
                return (*tfa.flash_bwd_plain(q, k, v, o, lse, do,
                                             causal=ctx.causal), None)

        self.tfa, self.saved = tfa, tfa.flash_attention
        tfa.flash_attention = lambda q, k, v, causal=False, **_: \
            Plain.apply(q, k, v, bool(causal))
        return self

    def __exit__(self, *exc):
        self.tfa.flash_attention = self.saved
        return False


def sd_encoder(cfg, seed=SEED):
    """Phase 11(b)'s graph on the card: per block
    multiHeadDotProductAttention (no bias) -> add -> linear 3072 + gelu
    -> linear 768 -> add; mean over T -> linear 2 ->
    softmaxCrossEntropy; weights N(0, 0.02^2) from Nd4j.randn seeds,
    biases 0, Adam(1e-4)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.ndarray import Nd4j
    from deeplearning4j_tpu_torch.nn import Adam

    E, nh, F3 = cfg["hidden"], cfg["heads"], cfg["intermediate"]
    B, T = cfg["batch"], cfg["seq"]
    sd = SameDiff.create()
    x = sd.placeHolder("x", "float32", B, T, E)
    y = sd.placeHolder("y", "float32", B, 2)
    count = [0]

    def w(name, *shape):
        count[0] += 1
        return sd.var(name, Nd4j.randn(*shape, seed=seed * 1000 + count[0])
                      .mul(cfg["initializer_range"]))

    def zero(name, n):
        return sd.var(name, Nd4j.zeros(n))

    h = x
    for i in range(cfg["layers"]):
        a = sd.nn.multiHeadDotProductAttention(
            h, w(f"wq{i}", E, E), w(f"wk{i}", E, E), w(f"wv{i}", E, E),
            w(f"wo{i}", E, E), nh, name=f"attn{i}")
        h = sd.math.add(h, a, name=f"res1_{i}")
        f = sd.nn.gelu(sd.nn.linear(h, w(f"w1_{i}", E, F3),
                                    zero(f"b1_{i}", F3)), name=f"ffn1_{i}")
        f = sd.nn.linear(f, w(f"w2_{i}", F3, E), zero(f"b2_{i}", E),
                         name=f"ffn2_{i}")
        h = sd.math.add(h, f, name=f"res2_{i}")
    logits = sd.nn.linear(h.mean(1), w("wout", E, 2), zero("bout", 2),
                          name="logits")
    sd.loss.softmaxCrossEntropy(y, logits, name="loss")
    sd.setTrainingConfig(TrainingConfig.Builder().updater(Adam(1e-4))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    return sd


def samediff_encoder(dev, cfg, phase7):
    """Phase 11(b)-(c): the first step against the plain-route graph,
    20 counted and timed fit steps, then save/load."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    t = time.perf_counter()
    sd = sd_encoder(cfg)
    n_params = sum(int(np.prod(sd._arrays[v.name].shape))
                   for v in sd.variables())
    torch.cuda.synchronize()
    log(f"sd encoder: {n_params} params, {len(sd._ops)} ops on "
        f"{sd.device}, built in {time.perf_counter() - t:.2f} s")
    xb, y = encoder_batch(cfg, dev)
    x = xb.transpose(1, 2).contiguous()          # [B, T, E]
    feed = {"x": x, "y": y}
    wrt = [v.name for v in sd.variables()]
    loss = float(sd.output(feed, ["loss"])["loss"].toNumpy())
    grads = sd.calculateGradients(feed, *wrt)
    with _PlainFlash():
        tfa.reset_launches()
        ploss = float(sd.output(feed, ["loss"])["loss"].toNumpy())
        pgrads = sd.calculateGradients(feed, *wrt)
        need(tfa.flash_fwd.launches == 0 and tfa.flash_fwd_plain.launches
             == 2 * cfg["layers"], "sd encoder (b): the plain route ran "
             f"K1 {tfa.flash_fwd.launches} times")
    loss_rel = abs(loss - ploss) / abs(ploss)
    worst = 0.0
    for n in wrt:
        err = rel_l2(grads[n].tensor(), pgrads[n].tensor())
        worst = max(worst, err)
        need(err <= 1e-3, f"sd encoder (b): {n} gradient rel L2 {err:.3e} "
             "against the plain route")
    need(loss_rel <= 1e-5, f"sd encoder (b): loss {loss} vs the plain "
         f"route's {ploss} (rel {loss_rel:.3e})")
    log(f"sd encoder (b): first-step loss {loss:.7f} vs the plain route "
        f"{ploss:.7f} (rel {loss_rel:.3e}); worst gradient rel L2 "
        f"{worst:.3e} over {len(wrt)} tensors")
    del grads, pgrads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tfa.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        losses += sd.fit(features=x, labels=y)       # fetches the loss
        step_s.append(time.perf_counter() - t)
    launches = {"K1": tfa.flash_fwd.launches, "K2": tfa.flash_bwd_dq.launches,
                "K3": tfa.flash_bwd_dkv.launches,
                "plain": tfa.flash_fwd_plain.launches
                + tfa.flash_bwd_dq_plain.launches
                + tfa.flash_bwd_dkv_plain.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_att = cfg["layers"] * TRAIN_STEPS
    need(all(launches[k] == n_att for k in ("K1", "K2", "K3")),
         f"sd encoder (b): kernel launches {launches}, expected {n_att} "
         "each")
    need(launches["plain"] == 0,
         f"sd encoder (b): a plain version ran on the card: {launches}")
    need(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
         f"sd encoder (b): losses {losses}")
    med = float(np.median(step_s[2:]))
    B, T = cfg["batch"], cfg["seq"]

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/encoder.zip"
        t = time.perf_counter()
        sd.save(path)
        back = SameDiff.load(path)
        io_s = time.perf_counter() - t
        a = sd.output({"x": x}, ["logits"])["logits"].tensor()
        b = back.output({"x": x}, ["logits"])["logits"].tensor()
        need(back.device.type == "cuda" and torch.equal(a, b),
             "sd encoder (c): the loaded graph's output differs")
        del back
    result = {"params": n_params, "steps": TRAIN_STEPS, "losses": losses,
              "first_step_loss_rel_to_plain": loss_rel,
              "first_step_worst_grad_rel_l2_to_plain": worst,
              "step_ms_median_3_to_20": med * 1e3,
              "step_ms_all": [s * 1e3 for s in step_s],
              "tokens_per_s": B * T / med,
              "max_memory_allocated_bytes": peak,
              "launches": launches,
              "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                    for k in ("K1", "K2", "K3")},
              "phase7_step_ms_median_3_to_20":
                  phase7["step_ms_median_3_to_20"],
              "phase7_tokens_per_s": phase7["tokens_per_s"],
              "phase7_max_memory_allocated_bytes":
                  phase7["max_memory_allocated_bytes"],
              "save_load_seconds": io_s, "save_load": "bitwise"}
    log("sd encoder (b, c): " + json.dumps(result))
    return result


# ----------------------------------------------------------------------
# phase 12: the recurrent family: config 3 trains by truncated BPTT, the
# carry-slot scheduler serves it over :generate
# ----------------------------------------------------------------------

#: BASELINE config 3 as bench.py bench_lstm_tbptt builds it outside SMOKE
CHAR_RNN = dict(vocab=77, batch=32, seq=80, tbptt=20, hidden=256, seed=12,
                lr=2e-3, fits=20)
#: 12(c): the HTTP burst, and the admission A/B's mix (bench.py:1590)
CHAR_SERVE = dict(requests=8, prompt_min=5, prompt_max=40, extra=32,
                  buckets=(1, 2, 4, 8), mix=[24, 2, 2, 2, 2, 2] * 8)


def char_rnn(device, cfg, dtype):
    """Config 3: GravesLSTM(256) -> GravesLSTM(256) -> RnnOutputLayer(77,
    softmax, MCXENT), tBPTT 20, Adam(2e-3), seed 12, on `device` in the
    DataType named `dtype`."""
    import deeplearning4j_tpu_torch.nn as P

    conf = (P.NeuralNetConfiguration.Builder()
            .seed(cfg["seed"]).updater(P.Adam(cfg["lr"]))
            .dataType(getattr(P.DataType, dtype)).list()
            .layer(P.GravesLSTM(nOut=cfg["hidden"]))
            .layer(P.GravesLSTM(nOut=cfg["hidden"]))
            .layer(P.RnnOutputLayer(nOut=cfg["vocab"], activation="softmax",
                                    lossFunction="mcxent"))
            .setInputType(P.InputType.recurrent(cfg["vocab"], cfg["seq"]))
            .backpropType(P.BackpropType.TruncatedBPTT)
            .tBPTTLength(cfg["tbptt"]).build())
    return P.MultiLayerNetwork(conf, device=device).init()


def char_rnn_data(cfg):
    """bench.py's batch: RandomState(0) ids [B, T], one-hot [B, V, T],
    labels the ids rolled by -1."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]))
    eye = np.eye(cfg["vocab"], dtype=np.float32)
    return (eye[ids].transpose(0, 2, 1),
            eye[np.roll(ids, -1, 1)].transpose(0, 2, 1))


def first_window(net, x, y, L):
    """The first tBPTT window's loss, gradients (per layer, CPU) and the
    carries it hands to window 2 ([h, c] of each LSTM, CPU)."""
    import torch

    loss, states = net._loss_fn(net._params, net._states, x[:, :, :L],
                                y[:, :, :L], None, None)
    flat = [t for p in net._params for t in p.values()]
    gs = iter(torch.autograd.grad(loss, flat))
    grads = [{k: next(gs).cpu() for k in p} for p in net._params]
    carries = [states[i][k].detach().cpu() for i in (0, 1)
               for k in ("h", "c")]
    return float(loss.detach()), grads, carries


def _vec(tensors):
    import torch
    return torch.cat([t.double().reshape(-1) for t in tensors])


def _grad_vec(grads):
    return _vec([g[k] for g in grads for k in sorted(g)])


def char_rnn_parity(dev, cfg):
    """Phase 12(a): the first window on the card against the port on the
    CPU from the same weights, f32 with TF32 and reduced-precision bf16
    reductions off; then bf16 held to an f64 CPU run."""
    import torch

    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

    x, y = char_rnn_data(cfg)
    L = cfg["tbptt"]
    card = char_rnn(dev, cfg, "FLOAT")
    weights = params_to_reference(card.layers, card._params)

    def carried(device, dtype):
        return char_rnn(device, cfg, dtype).load_reference_params(weights)

    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        l_c, g_c, c_c = first_window(card, x, y, L)
        l_p, g_p, c_p = first_window(carried("cpu", "FLOAT"), x, y, L)
        loss_rel = abs(l_c - l_p) / abs(l_p)
        g_worst = grads_against(g_c, g_p)
        c_worst = max(rel_l2(a, b) for a, b in zip(c_c, c_p))
        need(loss_rel <= 1e-5 and g_worst <= 1e-4 and c_worst <= 1e-5,
             f"char-rnn (a): first window on the card vs the CPU: loss rel "
             f"{loss_rel:.3e} (1e-5), worst gradient rel L2 {g_worst:.3e} "
             f"(1e-4), worst carry rel L2 {c_worst:.3e} (1e-5)")
        l64, g64, c64 = first_window(carried("cpu", "DOUBLE"), x, y, L)
        lb_p, gb_p, cb_p = first_window(carried("cpu", "BFLOAT16"), x, y, L)
        lb_c, gb_c, cb_c = first_window(carried(dev, "BFLOAT16"), x, y, L)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = saved
    g64v, c64v = _grad_vec(g64), _vec(c64)
    dist = {"card_grad": rel_l2(_grad_vec(gb_c), g64v),
            "cpu_grad": rel_l2(_grad_vec(gb_p), g64v),
            "card_carry": rel_l2(_vec(cb_c), c64v),
            "cpu_carry": rel_l2(_vec(cb_p), c64v),
            "card_loss": abs(lb_c - l64) / abs(l64),
            "cpu_loss": abs(lb_p - l64) / abs(l64)}
    need(dist["card_grad"] <= 1.5 * dist["cpu_grad"]
         and dist["card_carry"] <= 1.5 * dist["cpu_carry"],
         f"char-rnn (a): bf16 on the card further from f64 than 1.5x the "
         f"CPU's bf16: {dist}")
    result = {"params": card.numParams(), "f32_loss": l_c,
              "f32_loss_rel_to_cpu": loss_rel,
              "f32_worst_grad_rel_l2_to_cpu": g_worst,
              "f32_worst_carry_rel_l2_to_cpu": c_worst,
              "bf16_distance_to_f64": dist}
    log("char-rnn (a): " + json.dumps(result))
    return result


def char_rnn_train(dev, cfg):
    """Phase 12(b): 20 fit calls of config 3 in bf16 (fp32 masters), the
    batch resident on the card; then one traced fit."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    net = char_rnn(dev, cfg, "BFLOAT16")
    x, y = (torch.from_numpy(a).to(dev) for a in char_rnn_data(cfg))
    windows = math.ceil(cfg["seq"] / cfg["tbptt"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()    # the net, its batch, and
    torch.cuda.reset_peak_memory_stats()    # what earlier phases keep
    losses, fit_s = fit_timed(net, x, y, cfg["fits"])
    peak = torch.cuda.max_memory_allocated()
    need(net.getIterationCount() == cfg["fits"] * windows,
         f"char-rnn (b): {net.getIterationCount()} windows, expected "
         f"{cfg['fits'] * windows}")
    need(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
         f"char-rnn (b): losses not finite and falling: {losses}")
    need(all("h" not in s and "c" not in s for s in net._states),
         "char-rnn (b): a carry outlived fit")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.fit"):
            net.fit(x, y)
        torch.cuda.synchronize()
    events = prof.events()
    fit_evt = [e for e in events if e.name == "smoke.fit"
               and e.device_type == torch.autograd.DeviceType.CPU]
    need(len(fit_evt) == 1, "char-rnn (b): no fit scope in the trace")
    t0, t1 = fit_evt[0].time_range.start, fit_evt[0].time_range.end
    busy = device_busy_us(events, t0, t1)
    kernels = sum(len(e.kernels) for e in events)
    need(busy > 0 and kernels > 0, "char-rnn (b): the profiler saw no "
         "device work")
    med = float(np.median(fit_s[2:]))
    result = {"fits": cfg["fits"], "windows": cfg["fits"] * windows,
              "losses": losses, "fit_ms_median_3_to_20": med * 1e3,
              "chars_per_s": cfg["batch"] * cfg["seq"] / med,
              "max_memory_allocated_bytes": peak,
              "allocated_before_fit_bytes": held,
              "peak_over_before_fit_bytes": peak - held,
              "traced_fit_wall_ms": (t1 - t0) / 1e3,
              "traced_device_busy_ms": busy / 1e3,
              "device_busy_share_of_traced_wall": busy / (t1 - t0),
              "kernels_per_window": kernels / windows}
    log("char-rnn (b): " + json.dumps(result))
    return net, result


def serial_generation(net, prompt, extra):
    """The serial oracle: `prompt` [T, V] stepped one row at a time
    through rnnTimeStep on the card, then `extra` greedy one-hot steps.
    Returns the [T + extra, V] output rows (compute dtype, on the card)."""
    import torch

    net.rnnClearPreviousState()
    eye = torch.eye(prompt.shape[1], device=net.device)
    rows, x = [], torch.from_numpy(prompt[:1]).to(net.device)
    for t in range(prompt.shape[0] + extra):
        y = net.rnnTimeStep(x).tensor()
        rows.append(y[0])
        nxt = t + 1
        x = (torch.from_numpy(prompt[nxt:nxt + 1]).to(net.device)
             if nxt < prompt.shape[0] else eye[int(y[0].argmax())][None])
    net.rnnClearPreviousState()
    return torch.stack(rows)


def time_rnn_step(net, dev, S):
    """One bucket-S rnnStepBatched step (median of 5): host wall time to
    a synchronize, and device time by CUDA events around the step queued
    behind a spin kernel (phase 4's method)."""
    import torch

    x = torch.zeros((S, net.conf.inputType.size), device=dev)
    x[:, 0] = 1.0
    carries = net.rnnCarryZeros(S)

    def step():
        return net.rnnStepBatched(x, carries)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        step()
        b.record()
        need(not a.query(), "rnn step: the spin ended before the step was "
             "queued, so its device time would hold host gaps")
        b.synchronize()
        device.append(a.elapsed_time(b))
    res = {"slots": S, "host_ms": float(np.median(host)),
           "device_ms": float(np.median(device)), "host_ms_all": host,
           "device_ms_all": device}
    res["device_share"] = res["device_ms"] / res["host_ms"]
    return res


def admission_ab(net, cfg, scfg):
    """Dispatches, refills and host-timed slot-steps/s of "step" vs "gang"
    admission on the mixed lengths, one-hot rows from a seed."""
    from deeplearning4j_tpu_torch.serving import (
        ManualClock, SequenceScheduler,
    )

    rng = np.random.RandomState(SEED)
    eye = np.eye(cfg["vocab"], dtype=np.float32)
    seqs = [eye[rng.randint(0, cfg["vocab"], t)] for t in scfg["mix"]]
    res, outs = {}, {}
    for mode in ("step", "gang"):
        s = SequenceScheduler(net, slot_buckets=(8,), queue_limit=64,
                              admission=mode, clock=ManualClock(),
                              start_thread=False, name=f"ab-{mode}")
        s.warm()
        t = time.perf_counter()
        reqs = [s.submit(q, wait=False) for q in seqs]
        s.drain()
        wall = time.perf_counter() - t
        st = s.stats
        s.close()
        need(all(r.error is None for r in reqs), f"admission {mode}: a "
             "sequence failed")
        outs[mode] = [r.result for r in reqs]
        res[mode] = {"dispatches": st["dispatches"],
                     "refills": st["refills"],
                     "slot_steps": st["slot_steps"],
                     "slot_steps_per_s": st["slot_steps"] / wall}
    need(res["step"]["slot_steps"] == res["gang"]["slot_steps"]
         == sum(scfg["mix"]), f"admission A/B: slot steps {res}")
    need(res["gang"]["dispatches"] >= 2 * res["step"]["dispatches"]
         and res["step"]["refills"] > 0 and res["gang"]["refills"] == 0,
         f"admission A/B: gang needs >= 2x step's dispatches: {res}")
    worst = 0
    for a, b in zip(outs["step"], outs["gang"]):
        worst = max(worst, int(ulps(_bf16(a), _bf16(b)).max()))
    need(worst <= 1, f"admission A/B: step vs gang outputs {worst} bf16 "
         "ulps apart")
    res["step_vs_gang_max_ulps"] = worst
    res["throughput_ratio"] = (res["step"]["slot_steps_per_s"]
                               / res["gang"]["slot_steps_per_s"])
    return res


def _bf16(a):
    """Float32 numpy holding bf16 values as a bf16 tensor (exact)."""
    import torch
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def char_rnn_serve(dev, net, cfg, scfg):
    """Phase 12(c): the trained bf16 net behind ModelHost + InferenceServer;
    8 concurrent :generate requests with ragged one-hot prompts and
    extraSteps 32, each held to the serial rnnTimeStep oracle on the card;
    one bucket-8 step's host vs device ms; the admission A/B."""
    from deeplearning4j_tpu_torch.runtime import telemetry
    from deeplearning4j_tpu_torch.serving import (
        InferenceServer, ModelHost, greedy_onehot_feedback,
    )

    V, n, extra = cfg["vocab"], scfg["requests"], scfg["extra"]
    reg = telemetry.get_registry()
    host = ModelHost()
    t = time.perf_counter()
    rep = host.register_sequence("char-rnn", net,
                                 slotBuckets=scfg["buckets"],
                                 feedback=greedy_onehot_feedback(V))
    log(f"char-rnn (c): register_sequence (warm) "
        f"{time.perf_counter() - t:.2f} s: "
        + json.dumps({str(k): round(v, 4) for k, v in rep["warm"].items()}))
    sched = host.sequence_model("char-rnn").scheduler
    srv = InferenceServer(host).start(port=0)
    try:
        deadline = time.monotonic() + 120
        while http(srv.port, "/healthz", timeout=10)[0] != 200:
            need(time.monotonic() < deadline, "/healthz never turned 200")
            time.sleep(0.1)
        rng = np.random.RandomState(SEED)
        lens = rng.randint(scfg["prompt_min"], scfg["prompt_max"] + 1, n)
        lens[0], lens[1] = scfg["prompt_min"], scfg["prompt_max"]
        eye = np.eye(V, dtype=np.float32)
        prompts = [eye[rng.randint(0, V, int(t))] for t in lens]
        answers = [None] * n

        def fire(i):
            answers[i] = http(srv.port, "/v1/models/char-rnn:generate",
                              {"steps": prompts[i].tolist(),
                               "extraSteps": extra})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(n)]
        reg.trace.clear()
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t
        ttft = reg.get("dl4j_seq_ttft_seconds").labels(model="char-rnn:v1")
        ttft = (ttft.percentile(50), ttft.percentile(100))
        steps = [s for s in reg.trace.spans()
                 if s["name"] == "sequence.step"
                 and s["args"]["model"] == "char-rnn:v1"]
    finally:
        srv.stop()
        host.close(drain=False)
    worst = 0
    for i, ans in enumerate(answers):
        need(ans is not None, f"char-rnn (c): request {i} never answered")
        need(ans[0] == 200, f"char-rnn (c): request {i}: HTTP {ans[0]} "
             f"{ans[1][:300]}")
        out = np.asarray(json.loads(ans[1])["outputs"], np.float32)
        need(out.shape == (lens[i] + extra, V), f"char-rnn (c): request "
             f"{i} answered {out.shape}, expected {(lens[i] + extra, V)}")
        need(bool(np.isfinite(out).all()), f"char-rnn (c): request {i} "
             "has non-finite rows")
        want = serial_generation(net, prompts[i], extra).cpu()
        d = int(ulps(_bf16(out), want).max())
        worst = max(worst, d)
        need(d <= 1, f"char-rnn (c): request {i} is {d} bf16 ulps from "
             "the serial rnnTimeStep oracle (contract: 1)")
    live = sum(s["args"]["slots"] for s in steps)
    need(live == int(lens.sum()) + n * extra
         and live == sum(k for k, _ in sched.occupancy),
         f"char-rnn (c): {live} live slot-steps, expected "
         f"{int(lens.sum()) + n * extra}")
    result = {"requests": n, "prompt_rows": int(lens.sum()),
              "generated_rows": n * extra, "wall_s": wall,
              "ttft_p50_s": ttft[0], "ttft_max_s": ttft[1],
              "steps": len(steps),
              "rows_per_s": live / sum(s["dur"] for s in steps),
              "max_ulps_to_serial_oracle": worst}
    result["step_bucket8"] = time_rnn_step(net, dev, 8)
    result["admission"] = admission_ab(net, cfg, scfg)
    log("char-rnn (c): " + json.dumps(result))
    return result


# ----------------------------------------------------------------------
# phase 13: BASELINE config 5, data-parallel ResNet-50 through NCCL
# ----------------------------------------------------------------------

#: SharedTrainingMaster's modes in the order phase 13 runs them ("int8"
#: first: the master's default)
DP_MODES = ("int8", None, "block_int8", "threshold")
#: config 5's encoder knobs (bench.py's gradient-sharing defaults)
DP_TAU, DP_CAPACITY = 1e-3, 0.125


def dp_master(net, group, mode):
    """SharedTrainingMaster over `group` in `mode`, as a user builds it."""
    from deeplearning4j_tpu_torch.parallel import (
        FixedThresholdAlgorithm, SharedTrainingMaster,
    )

    if mode == "int8":
        return SharedTrainingMaster(net, mesh=group)
    if mode == "threshold":
        return SharedTrainingMaster(
            net, mesh=group, encodingCapacity=DP_CAPACITY,
            thresholdAlgorithm=FixedThresholdAlgorithm(DP_TAU))
    return SharedTrainingMaster(net, mesh=group, gradient_compression=mode)


def first_exchange(master):
    """Wrap `master`'s gradient exchange so its first call keeps a copy
    of its input and output leaves; returns the dict they land in."""
    from deeplearning4j_tpu_torch.parallel.trainer import _leaves

    seen = {}
    exchange = master._exchange_grads

    def spy(grads):
        out = exchange(grads)
        seen["in"] = [t.detach().clone() for t in _leaves(grads)]
        seen["out"] = [t.detach().clone() for t in _leaves(out)]
        if master._ef is not None:
            seen["res"] = master._ef.clone()
        del master._exchange_grads     # the class's method from step 2 on
        return out

    master._exchange_grads = spy
    return seen


def f32_ulps(got, want):
    """The largest distance of f32 `got` from `want` in units of want's
    f32 ulp (the spacing at each |want|)."""
    import torch

    gap = torch.nextafter(want.abs(), torch.tensor(float("inf")))
    return float(((got - want).abs() / (gap - want.abs())).max())


def plain_exchange(master, mode, seen):
    """The mode's exchange functions on the CPU, on the card's first
    gradient, against what the card's exchange gave (world 1 here: the
    exchange is the plain arithmetic of one rank). Returns the checked
    numbers; raises on a mismatch."""
    import torch

    from deeplearning4j_tpu_torch.parallel import DataGroup
    from deeplearning4j_tpu_torch.parallel import sharding as sh

    local = DataGroup()
    cpu_in = [t.cpu() for t in seen["in"]]
    card_out = [t.cpu() for t in seen["out"]]
    if mode == "threshold":
        zeros = torch.zeros(sum(t.numel() for t in cpu_in))
        tau = torch.tensor(DP_TAU, dtype=torch.float32)
        means, res, sent = sh.threshold_psum_mean(cpu_in, zeros, tau,
                                                  DP_CAPACITY, local)
        need(all(torch.equal(a, b) for a, b in zip(means, card_out))
             and torch.equal(res, seen["res"].cpu()),
             "dp threshold: the card's first exchange (mean or residual) "
             "differs from the CPU's")
        return {"mean_bitwise": True, "residual_bitwise": True,
                "sent": int(sent),
                "sent_share": int(sent) / sum(t.numel() for t in cpu_in)}
    block = sh.DEFAULT_COMPRESSION_BLOCK
    q_cpu, _, _ = sh._quantize(cpu_in, local, mode, block)
    q_card, _, _ = sh._quantize(seen["in"], local, mode, block)
    lanes_off = int((q_cpu != q_card.cpu()).sum())
    need(lanes_off == 0, f"dp {mode}: {lanes_off} int8 lanes differ "
         "between the card and the CPU")
    means = sh.quantized_psum_mean(cpu_in, local, mode, block)
    worst = max(f32_ulps(b.float(), a.float())
                for a, b in zip(means, card_out))
    need(worst <= 1.0, f"dp {mode}: the dequantized mean is {worst} ulps "
         "from the CPU's")
    return {"lanes": q_cpu.numel(), "lanes_off": 0, "mean_max_ulps": worst}


def dp_train(dev, cfg, group, x, y, mode, plain_ms=None, check=True):
    """One mode of phase 13 on this rank: a fresh config-5 net, 20 steps
    through SharedTrainingMaster on the global batch (x, y); the first
    exchange held to its plain version when `check`. Returns the
    measurements (images/s of the global batch, and a rank's share)."""
    import torch

    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.parallel import compressed_wire_bytes

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    net = resnet_net(dev, cfg, "BFLOAT16", dataFormat="NHWC",
                     updater=Nesterovs(0.1, 0.9))
    master = dp_master(net, group, mode)
    seen = first_exchange(master) if check and mode is not None else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = fit_timed(net, x, y, cfg["steps"], trainer=master)
    peak = torch.cuda.max_memory_allocated(dev)
    name = mode or "dense"
    need(all(math.isfinite(v) for v in losses),
         f"dp {name}: non-finite loss: {losses}")
    med = float(np.median(step_s[2:]))
    grad_bytes = 4 * net.numParams()
    bill = compressed_wire_bytes(grad_bytes, group.size, mode,
                                 capacity=DP_CAPACITY)
    out = {"mode": name, "world": group.size, "losses": losses,
           "step_ms_median_3_on": med * 1e3,
           "images_per_s": x.shape[0] / med,
           "images_per_s_per_rank": x.shape[0] / group.size / med,
           "max_memory_allocated_bytes": peak,
           "collectives_per_step": master.last_step["collectives"],
           "payload_bytes_per_step": master.last_step["payload_bytes"],
           "wire_bytes_per_step": master.last_step["wire_bytes"],
           "bill_wire_bytes": bill["wire_bytes"],
           "bill_dense_wire_bytes": bill["dense_wire_bytes"]}
    if plain_ms is not None:
        out["step_over_phase9b"] = med * 1e3 / plain_ms
    if seen is not None:
        out["first_exchange"] = plain_exchange(master, mode, seen)
    del net, master, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_nccl_rank(rank, world, device, cfg):
    """Phase 13(c)'s rank body (launched): every mode at dp `world`."""
    from deeplearning4j_tpu_torch.parallel import data_parallel_mesh

    group = data_parallel_mesh()
    x, y = resnet_batch(device, cfg, cfg["batch"] * world)
    return [dp_train(device, cfg, group, x, y, mode, check=False)
            for mode in DP_MODES]


def gloo_card_rank(rank, world, device):
    """Phase 13(b)'s rank body: gloo must take a CUDA tensor, then the
    sync-BN leg on the card."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.dryrun import sync_bn_leg

    t = torch.full((4,), float(rank + 1), device=device)
    try:
        dist.all_reduce(t)
    except RuntimeError as e:
        raise SmokeFailure(f"gloo rejected an all-reduce of a CUDA tensor "
                           f"({torch.__version__}): {e}") from e
    need(float(t[0]) == world * (world + 1) / 2,
         f"gloo's CUDA all-reduce gave {t.tolist()}")
    out = sync_bn_leg(rank, world, device, "FLOAT", steps=3)
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in out.items()}


def data_parallel_phase(dev, cfg, phase9b):
    """Phase 13: (a) config 5 through NCCL at the world this process
    sees, (b) two gloo ranks on one card, (c) dp over several cards."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import initializeMultiHost, launch
    from deeplearning4j_tpu_torch.parallel.dryrun import SYNC_BN_F32_ATOL

    before = kernel_launches()
    tmp = tempfile.mkdtemp(prefix="dl4j_smoke_")
    group = initializeMultiHost(init_method=f"file://{tmp}/store",
                                num_processes=1, process_id=0,
                                device=dev, timeout=600)
    need(group.backend == "nccl" and group.pg is not None,
         f"phase 13 (a) needs a NCCL process group, got {group}")
    log(f"dp (a): NCCL process group, world {group.size} (this process is "
        f"one rank on {group.device}; {torch.cuda.device_count()} card(s) "
        "visible)")
    x, y = resnet_batch(dev, cfg, cfg["batch"])
    modes = {}
    try:
        for mode in DP_MODES:
            r = dp_train(dev, cfg, group, x, y, mode,
                         plain_ms=phase9b["step_ms_median_3_on"])
            modes[r["mode"]] = r
            log(f"dp (a) {r['mode']}: " + json.dumps(
                {k: v for k, v in r.items() if k != "losses"}))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    dense = modes["dense"]["losses"]
    need(dense == phase9b["losses"],
         "dp (a): dense at world 1 is not bitwise ComputationGraph.fit: "
         f"{dense} vs {phase9b['losses']}")
    del x, y
    torch.cuda.empty_cache()

    t = time.perf_counter()
    one_card = torch.device("cuda", torch.cuda.current_device())
    ranks = launch(gloo_card_rank, 2, device=one_card, backend="gloo",
                   timeout=600)
    r0 = ranks[0]
    gap = float(np.abs(np.asarray(r0["dense"])
                       - np.asarray(r0["single"])).max())
    excess = max(r["int8_grid_excess"] for r in ranks)
    need(gap <= SYNC_BN_F32_ATOL and all(r["replicated"] for r in ranks),
         f"dp (b): dense dp 2 on one card {gap:.3e} from fit (bar "
         f"{SYNC_BN_F32_ATOL}), replicated {[r['replicated'] for r in ranks]}")
    need(excess <= 1e-5, f"dp (b): int8 exchange {excess:.3e} past its grid")
    need(all(math.isfinite(v) for r in ranks
             for v in r["dense_losses"] + [r["int8_loss"]]),
         "dp (b): non-finite loss")
    gloo = {"seconds": time.perf_counter() - t,
            "dense_max_abs_vs_fit": gap, "bar": SYNC_BN_F32_ATOL,
            "int8_grid_excess": excess, "dense_losses": r0["dense_losses"],
            "single_losses": r0["single_losses"],
            "collectives_per_dense_step": r0["comm"]["collectives"]}
    log("dp (b): two ranks on one card over gloo (gloo stages CUDA tensors "
        "through the host: the backend's own staging, asked for here; "
        "threshold mode left out: gloo has no CUDA all-gather): "
        + json.dumps(gloo))

    cards = torch.cuda.device_count()
    multi = None
    if cards >= 2:
        dp = min(cards, 4)
        res = launch(dp_nccl_rank, dp, device=dev, timeout=900,
                     args=(cfg,))
        multi = {}
        for i, mode in enumerate(DP_MODES):
            r = res[0][i]
            need(all(math.isfinite(v) for rr in res for v in rr[i]["losses"]),
                 f"dp (c) {r['mode']}: non-finite loss")
            r["scaling_vs_world1"] = (r["images_per_s"]
                                      / modes[r["mode"]]["images_per_s"])
            multi[r["mode"]] = {k: v for k, v in r.items() if k != "losses"}
        log(f"dp (c): dp {dp} over {cards} cards: " + json.dumps(multi))
    else:
        log(f"dp (c): not run: {cards} card visible (needs two or more)")
    need(kernel_launches() == before, "dp: a hand-written kernel launched: "
         f"{before} -> {kernel_launches()}")
    return {"modes": modes, "gloo": gloo, "multi": multi}


# ----------------------------------------------------------------------
# phase 14: the training runtime (fitDataSet blocks, iterators,
# normalizers, evaluation, listeners, early stopping, files, ResilientFit)
# ----------------------------------------------------------------------

#: 14(a): BASELINE config 4 (phase 9(b)'s net) over 9 pre-built batches
RUNTIME_RESNET = dict(batches=9, k=4, ckpt_after=4, held_out=2)
#: 14(b): BASELINE config 1, zoo LeNet on (synthetic) MNIST at full size
RUNTIME_LENET = dict(batch=64, train=60000, test=10000, epochs=3,
                     save_every=200, poison=100, kill_after=500, k=16,
                     min_accuracy=0.9)
#: 14(c): phase 7's encoder over 8 batches
RUNTIME_ENCODER = dict(batches=8, k=4)


def block_spans(reg):
    """The fitDataSet spans in the registry's trace: {name: [ms, ...]}."""
    out = {}
    for s in reg.trace.spans():
        if s["name"].startswith("fit_dataset."):
            out.setdefault(s["name"][len("fit_dataset."):], []).append(
                s["dur"] * 1e3)
    return out


def state_equal(a, b):
    """Params, layer states and updater state of two nets bit for bit."""
    import torch

    from deeplearning4j_tpu_torch.nn.multilayer import tree_leaves

    la = tree_leaves([a._params, a._states, a._upd_states])
    lb = tree_leaves([b._params, b._states, b._upd_states])
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def traced_device_work(fn):
    """Run `fn` once under torch.profiler: (its device kernels and
    copies, their busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.call"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    scope = [e for e in events if e.name == "smoke.call"
             and e.device_type == torch.autograd.DeviceType.CPU]
    need(len(scope) == 1, f"trace: {len(scope)} traced scopes")
    t0, t1 = scope[0].time_range.start, scope[0].time_range.end
    work = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation
            and e.time_range.end > t0 and e.time_range.start < t1]
    need(len(work) > 0, "trace: the profiler saw no device work")
    return len(work), device_busy_us(events, t0, t1) / 1e3


def traced_busy_share(fn):
    """Run `fn` under torch.profiler: (the device's busy share of the
    call's wall time, the wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.block"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    scope = [e for e in events if e.name == "smoke.block"
             and e.device_type == torch.autograd.DeviceType.CPU]
    need(len(scope) == 1, f"runtime: {len(scope)} traced scopes")
    t0, t1 = scope[0].time_range.start, scope[0].time_range.end
    busy = device_busy_us(events, t0, t1)
    need(busy > 0, "runtime: the profiler saw no device time")
    return busy / (t1 - t0), (t1 - t0) / 1e3


def runtime_images(rng, rows):
    """14(a)'s config 4 batches from `rng`: NHWC uniform pixels at 9(b)'s
    size and one-hot labels over its classes (17(a) draws them again)."""
    B, n, C = RESNET_TIMED["batch"], RESNET_TIMED["image"], \
        RESNET_TIMED["classes"]
    x = np.empty((rows, n, n, 3), np.float32)
    for i in range(0, rows, B):
        x[i:i + B] = rng.rand(min(B, rows - i), n, n, 3)
    return x, np.eye(C, dtype=np.float32)[rng.randint(0, C, rows)]


def runtime_resnet(dev, cfg, phase9b, phase9c):
    """Phase 14(a): fitDataSet(stepsPerSync=k) on config 4 against fit,
    bitwise, with every block issued under the sync check; a traced
    block's idle share; a mid-run TrainingCheckpoint; evaluate."""
    import os
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.data import (
        DataSet, ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.nn.multilayer import sync_free_blocks
    from deeplearning4j_tpu_torch.optimize import CollectScoresListener
    from deeplearning4j_tpu_torch.runtime import telemetry
    from deeplearning4j_tpu_torch.util.serializer import TrainingCheckpoint

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    B = RESNET_TIMED["batch"]
    nb, k = cfg["batches"], cfg["k"]
    rng = np.random.RandomState(SEED + 14)
    t = time.perf_counter()
    x, y = runtime_images(rng, nb * B)
    xe, ye = runtime_images(rng, cfg["held_out"] * B)
    data_s = time.perf_counter() - t

    def batches(lo=0, hi=nb):
        return ExistingDataSetIterator(DataSet(x[lo * B:hi * B],
                                               y[lo * B:hi * B]), B)

    fit_net = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                         updater=Nesterovs(0.1, 0.9))
    blk, ck_net = fit_net.clone(), fit_net.clone()
    log(f"runtime (a): {nb} batches of {B} NHWC images ({x.nbytes / 2**30:.2f}"
        f" GiB on the host, made in {data_s:.2f} s), held-out "
        f"{cfg['held_out']}; three nets from one start")

    # the uninterrupted trajectory: fit over the iterator (it also warms
    # cuDNN and cuBLAS up before the sync check)
    sf, sb = CollectScoresListener(), CollectScoresListener()
    fit_net.setListeners(sf)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit_net.fit(batches())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t

    reg = telemetry.get_registry()
    reg.trace.clear()
    blk.setListeners(sb)
    t = time.perf_counter()
    with sync_free_blocks():
        blk.fitDataSet(batches(), stepsPerSync=k)
    torch.cuda.synchronize()
    fd_s = time.perf_counter() - t
    spans = block_spans(reg)
    need(sb.scores == sf.scores, f"runtime (a): fitDataSet losses "
         f"{sb.scores} vs fit's {sf.scores}")
    need(state_equal(blk, fit_net), "runtime (a): fitDataSet's params, BN "
         "statistics or momentum differ from fit's")
    syncs = blk._fit_dataset_syncs
    need(syncs == nb // k + nb % k, f"runtime (a): {syncs} syncs")
    need(all(math.isfinite(v) for v in sf.scores),
         f"runtime (a): non-finite loss {sf.scores}")

    # one traced block: the device's idle share
    busy, traced_ms = traced_busy_share(
        lambda: blk.fitDataSet(batches(0, k), stepsPerSync=k))

    # a checkpoint after step `ckpt_after`, loaded into a fresh net
    m = cfg["ckpt_after"]
    s1 = CollectScoresListener()
    ck_net.setListeners(s1)
    ck_net.fit(batches(0, m))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "resnet50.npz")
        t = time.perf_counter()
        TrainingCheckpoint.save(ck_net, path, extra={"batch": m})
        save_s = time.perf_counter() - t
        size = os.path.getsize(path)
        t = time.perf_counter()
        resumed, _, extra = TrainingCheckpoint.load(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    need(extra == {"batch": m} and resumed.getIterationCount() == m,
         f"runtime (a): checkpoint extra {extra}, iteration "
         f"{resumed.getIterationCount()}")
    s2 = CollectScoresListener()
    resumed.setListeners(s2)
    resumed.fit(batches(m, nb))
    need(s1.scores + s2.scores == sf.scores, "runtime (a): the resumed "
         f"losses {s1.scores + s2.scores} differ from the uninterrupted "
         f"run's {sf.scores}")
    need(state_equal(resumed, fit_net), "runtime (a): the resumed state "
         "differs from the uninterrupted run's")
    del ck_net, resumed

    ev = blk.evaluate(ExistingDataSetIterator(DataSet(xe, ye), B))
    total = int(ev.getConfusionMatrix().sum())
    need(total == cfg["held_out"] * B, f"runtime (a): evaluate counted "
         f"{total} examples")
    result = {
        "losses": sf.scores, "syncs": syncs,
        "fit_ms_per_step": fit_s * 1e3 / nb,
        "fit_dataset_ms_per_step": fd_s * 1e3 / nb,
        "phase9b_ms_per_step": phase9b["step_ms_median_3_on"],
        "spans_ms": spans,
        "traced_block_ms": traced_ms,
        "traced_block_device_idle_share": 1 - busy,
        "phase9c_device_idle_share_of_traced_wall":
            phase9c["device_idle_share_of_traced_wall"],
        "checkpoint_bytes": size, "checkpoint_save_s": save_s,
        "checkpoint_load_s": load_s,
        "eval_accuracy": ev.accuracy(), "eval_confusion_total": total}
    log("runtime (a): " + json.dumps(result))
    del x, y, xe, ye, fit_net, blk
    return result


def runtime_lenet(dev, cfg):
    """Phase 14(b): BASELINE config 1 through the runtime: MNIST
    iterators and NormalizerStandardize, EarlyStoppingTrainer with a
    LocalFileModelSaver, ResilientFit with a poisoned step and a
    preemption, fit against fitDataSet(stepsPerSync=k)."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.data import (
        DataSetIterator, MnistDataSetIterator, NormalizerStandardize,
    )
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresListener, DataSetLossCalculator,
        EarlyStoppingConfiguration, EarlyStoppingTrainer,
        LocalFileModelSaver, MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.runtime.resilience import (
        FaultInjector, Preemption, ResilientFit,
    )
    from deeplearning4j_tpu_torch.util import sharded_checkpoint as ck
    from deeplearning4j_tpu_torch.zoo import LeNet

    B = cfg["batch"]
    t = time.perf_counter()
    train = MnistDataSetIterator(B, train=True, numExamples=cfg["train"],
                                 reshapeToCnn=True)
    test = MnistDataSetIterator(B, train=False, numExamples=cfg["test"],
                                reshapeToCnn=True)
    norm = NormalizerStandardize().fit(train)
    data_s = time.perf_counter() - t

    def fresh():
        it = DataSetIterator(train._f, train._l, B, shuffle=True,
                             seed=123)
        it.setPreProcessor(norm)
        return it

    test.setPreProcessor(norm)
    steps = -(-cfg["train"] // B)
    start = LeNet(numClasses=10, seed=SEED, device=dev).init()
    log(f"runtime (b): MNIST train {train.totalExamples()} / test "
        f"{test.totalExamples()} examples, synthetic {train.isSynthetic} "
        f"/ {test.isSynthetic}, normalized (made in {data_s:.2f} s); "
        f"{steps} steps an epoch")

    with tempfile.TemporaryDirectory() as d:
        # early stopping over up to `epochs` epochs
        net = start.clone()
        es = (EarlyStoppingConfiguration.Builder()
              .epochTerminationConditions(
                  MaxEpochsTerminationCondition(cfg["epochs"]))
              .scoreCalculator(DataSetLossCalculator(test))
              .modelSaver(LocalFileModelSaver(f"{d}/es")).build())
        t = time.perf_counter()
        res = EarlyStoppingTrainer(es, net, fresh()).fit()
        es_s = time.perf_counter() - t
        best = res.getBestModel()
        need(best is not None and best.device == start.device,
             "runtime (b): the best model did not restore onto the card")
        acc = best.evaluate(test).accuracy()
        need(acc >= cfg["min_accuracy"], f"runtime (b): best model's test "
             f"accuracy {acc} < {cfg['min_accuracy']}")

        # ResilientFit: the uninterrupted run, a poisoned step in it
        snaps = {}
        p = cfg["poison"]

        class Grab:
            def iterationDone(self, model, iteration, epoch):
                if iteration in (p, p + 1):
                    snaps[iteration] = model.params().tensor().clone()

        u = start.clone()
        cu = CollectScoresListener()
        u.setListeners(cu, Grab())
        rf = ResilientFit(u, f"{d}/u", saveEveryNIterations=cfg["save_every"],
                          injector=FaultInjector().poisonStep(p))
        t = time.perf_counter()
        rf.fit(fresh(), epochs=1)
        rf_s = time.perf_counter() - t
        need(rf.skippedSteps == 1 and not math.isfinite(cu.scores[p]),
             f"runtime (b): {rf.skippedSteps} skipped steps, loss at the "
             f"poisoned step {cu.scores[p]}")
        need(torch.equal(snaps[p], snaps[p + 1]), "runtime (b): the "
             "skipped step changed the params")
        # killed after `kill_after` steps, then resumed from the directory
        v = start.clone()
        inj = FaultInjector().poisonStep(p).killAfterStep(cfg["kill_after"])
        try:
            ResilientFit(v, f"{d}/v", saveEveryNIterations=cfg["save_every"],
                         injector=inj).fit(fresh(), epochs=1)
            need(False, "runtime (b): the preemption did not fire")
        except Preemption:
            pass
        latest = ck.latest_step(f"{d}/v")
        w = start.clone()
        cw = CollectScoresListener()
        w.setListeners(cw)
        ResilientFit(w, f"{d}/v", saveEveryNIterations=cfg["save_every"],
                     injector=FaultInjector().poisonStep(p)).fit(fresh(),
                                                                 epochs=1)
        need(cw.iterations[0] == latest + 1
             and cw.scores == cu.scores[latest:],
             f"runtime (b): resumed at {cw.iterations[:1]} (latest "
             f"checkpoint {latest}); its losses {cw.scores[:4]} differ "
             f"from the uninterrupted run's {cu.scores[latest:latest + 4]}")
        need(state_equal(w, u), "runtime (b): the resumed state differs")

    # fit against fitDataSet(stepsPerSync=k), one epoch each
    a, b = start.clone(), start.clone()
    torch.cuda.synchronize()
    t = time.perf_counter()
    a.fit(fresh())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    t = time.perf_counter()
    b.fitDataSet(fresh(), stepsPerSync=cfg["k"])
    torch.cuda.synchronize()
    fd_s = time.perf_counter() - t
    need(state_equal(a, b) and a.score() == b.score(),
         "runtime (b): fitDataSet's epoch differs from fit's")
    result = {"steps_per_epoch": steps, "synthetic": train.isSynthetic,
              "early_stopping_epochs": res.totalEpochs,
              "early_stopping_best_epoch": res.bestModelEpoch,
              "early_stopping_s": es_s, "test_accuracy": acc,
              "resilient_epoch_s": rf_s, "resumed_from": latest,
              "fit_images_per_s": cfg["train"] / fit_s,
              "fit_dataset_images_per_s": cfg["train"] / fd_s,
              "fit_dataset_syncs": b._fit_dataset_syncs}
    log("runtime (b): " + json.dumps(result))
    return result


def runtime_encoder(dev, cfg, phase7):
    """Phase 14(c): phase 7's encoder through ComputationGraph.fitDataSet
    (stepsPerSync=k) against fit, bitwise, blocks under the sync check;
    K1-K3 counted over the fitDataSet run alone."""
    import torch

    from deeplearning4j_tpu_torch.data import (
        DataSet, ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import sync_free_blocks
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa
    from deeplearning4j_tpu_torch.optimize import CollectScoresListener

    bc = BERT_BASE
    nb, k, B = cfg["batches"], cfg["k"], bc["batch"]
    rng = np.random.default_rng(SEED + 14)
    x = rng.standard_normal((nb * B, bc["hidden"], bc["seq"])).astype(
        np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, :64].mean(axis=(1, 2)) > 0)
                                    .astype(int)]

    def it():
        return ExistingDataSetIterator(DataSet(x, y), B)

    ref = ComputationGraph(bert_encoder_conf(bc)).init()
    net = ref.clone()
    sr, sn = CollectScoresListener(), CollectScoresListener()
    ref.setListeners(sr)
    net.setListeners(sn)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref.fit(it())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    tfa.reset_launches()
    t = time.perf_counter()
    with sync_free_blocks():
        net.fitDataSet(it(), stepsPerSync=k)
    torch.cuda.synchronize()
    fd_s = time.perf_counter() - t
    launches = {"K1": tfa.flash_fwd.launches, "K2": tfa.flash_bwd_dq.launches,
                "K3": tfa.flash_bwd_dkv.launches,
                "plain": tfa.flash_fwd_plain.launches
                + tfa.flash_bwd_dq_plain.launches
                + tfa.flash_bwd_dkv_plain.launches}
    want = bc["layers"] * nb
    need(all(launches[n] == want for n in ("K1", "K2", "K3"))
         and launches["plain"] == 0,
         f"runtime (c): launches {launches}, expected {want} each")
    need(sn.scores == sr.scores, f"runtime (c): fitDataSet losses "
         f"{sn.scores} vs fit's {sr.scores}")
    need(state_equal(net, ref), "runtime (c): fitDataSet's state differs "
         "from fit's")
    result = {"losses": sr.scores, "launches": launches,
              "syncs": net._fit_dataset_syncs,
              "fit_ms_per_step": fit_s * 1e3 / nb,
              "fit_dataset_ms_per_step": fd_s * 1e3 / nb,
              "phase7_ms_per_step": phase7["step_ms_median_3_to_20"]}
    log("runtime (c): " + json.dumps(result))
    return result


def runtime_phase(dev, phase7, phase9b, phase9c):
    """Phase 14: (a) config 4, (b) config 1, (c) the encoder."""
    import torch

    a = runtime_resnet(dev, RUNTIME_RESNET, phase9b, phase9c)
    torch.cuda.empty_cache()
    b = runtime_lenet(dev, RUNTIME_LENET)
    torch.cuda.empty_cache()
    c = runtime_encoder(dev, RUNTIME_ENCODER, phase7)
    torch.cuda.empty_cache()
    return {"resnet": a, "lenet": b, "encoder": c}


# ----------------------------------------------------------------------
# phase 15: the CNN zoo on the card (dropout, LRN, the 2-d shape layers
# and vertices, the s2d stem, the save_conv_outputs policy)
# ----------------------------------------------------------------------

#: 15(a): the cut sizes of tests/test_torch_zoo_cnns.py (AlexNet's 67x67
#: is the smallest its three pools take), dropout off, 3 steps
ZOO_PARITY = dict(steps=3, batch=4, classes=5,
                  models={"AlexNet": 67, "VGG16": 32})
#: the f64 band (card vs CPU) and the f32 band (card vs the CPU's f64).
#: The f32 gradients are held to 1e-2: a relu output near 0 that changes
#: sign between summation orders moves a whole gradient (VGG16's third
#: step on the card: layer 0's W 6.6e-3 from f64 while its loss stays
#: within 2e-6; which outputs flip depends on the order)
ZOO_F64_LOSS, ZOO_F64_GRAD = 1e-10, 1e-9
ZOO_F32_LOSS, ZOO_F32_GRAD = 1e-5, 1e-2
#: 15(b)-(d): the zoo defaults at full width
ZOO_VGG = dict(model="VGG16", batch=64, image=224, classes=1000,
               steps=20, traced_steps=3)
ZOO_ALEXNET = dict(model="AlexNet", batch=128, image=224, classes=1000,
                   steps=20, traced_steps=3)
ZOO_UNET = dict(batch=32, image=128, classes=1, steps=20)
#: 15(e): the s2d stem against the standard one (f32, eval mode) and its
#: timed steps at 9(b)'s settings; the logits' band
S2D_CHECK = dict(batch=8, steps=6)
S2D_LOGIT_REL = 1e-4
#: 15(f): 9(b)'s net, with and without the remat policy
REMAT_STEPS = 5
#: 15(g): SimpleCNN (its zoo default 3x48x48, dropout on)
ZOO_SIMPLE = dict(batch=64, batches=9, k=4, classes=10)


def layer_inputs(conf):
    """(layer, its input type) of a MultiLayerConfiguration or a
    ComputationGraphConfiguration, in order."""
    if hasattr(conf, "layers"):
        return list(zip(conf.layers, conf.layerInputTypes))
    return [(conf.nodes[n].payload, conf.nodes[n].layerInputType)
            for n in conf.topoOrder if conf.nodes[n].kind == "layer"]


def forward_flops(conf, batch):
    """Multiply-adds x 2 of the forward's convolutions and dense
    products, from the conf's shapes (phase 9(b)'s count, for either
    network type)."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    total = 0
    for layer, it in layer_inputs(conf):
        if isinstance(layer, L.ConvolutionLayer):
            out = layer.getOutputType(it)
            kh, kw = layer.kernelSize
            total += 2 * batch * out.height * out.width * out.channels \
                * layer.nIn * kh * kw
        elif isinstance(layer, L.FeedForwardLayer):
            total += 2 * batch * layer.nIn * layer.nOut
    return total


def zoo_scopes():
    """[(owner, attribute, original)] after wrapping the zoo's layer
    kinds, relu, dropout, the loss and the updater step in named
    profiler scopes (15(b)-(c)'s forward attribution; the innermost
    scope names a kernel)."""
    from deeplearning4j_tpu_torch.nn import activations as A
    from deeplearning4j_tpu_torch.nn import graph, multilayer
    from deeplearning4j_tpu_torch.nn.conf import dropout as D
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    targets = [(L.ConvolutionLayer, "forward", "conv"),
               (L.DenseLayer, "forward", "dense"),
               (L.BaseOutputLayer, "preoutput", "dense"),
               (L.SubsamplingLayer, "forward", "pool"),
               (L.GlobalPoolingLayer, "forward", "pool"),
               (L.LocalResponseNormalization, "forward", "lrn"),
               (L.BatchNormalization, "forward", "bn"),
               (D.Dropout, "apply", "dropout"),
               (multilayer.MultiLayerNetwork, "_loss_from_preact", "loss"),
               (graph.ComputationGraph, "_loss", "loss"),
               (multilayer, "default_param_update", "update")]
    saved = [(A.ACTIVATIONS, "relu", A.ACTIVATIONS["relu"])]
    A.ACTIVATIONS["relu"] = _scoped(A.ACTIVATIONS["relu"], "relu")
    for owner, attr, name in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))
        setattr(owner, attr, _scoped(fn, name))
    return saved


def unscope(saved):
    for owner, attr, fn in reversed(saved):
        if isinstance(owner, dict):
            owner[attr] = fn
        else:
            setattr(owner, attr, fn)


def _scope_of(evt):
    """The innermost smoke scope over a forward event, else "casts" for
    the params' bf16 copies, else None."""
    e = evt
    while e is not None:
        if e.name.startswith("smoke:"):
            return e.name[6:]
        e = e.cpu_parent
    e = evt
    while e is not None:
        if e.name == "aten::_to_copy":
            return "casts"
        e = e.cpu_parent
    return None


def split_by_kind(events):
    """Device microseconds by kind: a forward kernel goes to its
    innermost smoke scope; a backward kernel to the scope of the forward
    op that made its autograd node (matched by sequence number), gradient
    accumulation to "update"; anything else to "other:<op>"."""
    fwd = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::") \
                and e.sequence_nr not in fwd:
            kind = _scope_of(e)
            if kind is not None:
                fwd[e.sequence_nr] = kind
    out = {}
    for evt in events:
        if not evt.kernels:
            continue
        kind, e = None, evt
        while e is not None:
            if e.name.startswith("autograd::engine::evaluate_function: "):
                kind = ("update" if "AccumulateGrad" in e.name
                        else fwd.get(e.sequence_nr,
                                     "other:" + e.name.split(": ", 1)[1]))
                break
            e = e.cpu_parent
        if kind is None:
            kind = _scope_of(evt) or "other:" + evt.name
        out[kind] = out.get(kind, 0.0) + sum(k.duration for k in evt.kernels)
    return out


def traced_split(net, x, y, steps, what):
    """A torch.profiler trace of `steps` fit steps under zoo_scopes:
    device ms a step by kind and each kind's share, the device's busy
    and idle share of the traced wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = zoo_scopes()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                with record_function("smoke.step"):
                    net.fit(x, y)
                    net.score()
            torch.cuda.synchronize()
    finally:
        unscope(saved)
    events = prof.events()
    by = split_by_kind(events)
    total = sum(by.values())
    need(total > 0, f"{what}: the profiler saw no device time")
    other = {k[6:]: v for k, v in by.items() if k.startswith("other:")}
    kinds = {k: v for k, v in by.items() if not k.startswith("other:")}
    kinds["other"] = sum(other.values())
    step_evts = [e for e in events if e.name == "smoke.step"
                 and e.device_type == torch.autograd.DeviceType.CPU]
    t0 = min(e.time_range.start for e in step_evts)
    t1 = max(e.time_range.end for e in step_evts)
    busy = device_busy_us(events, t0, t1)
    return {"device_ms_per_step": {k: v / 1e3 / steps
                                   for k, v in sorted(kinds.items())},
            "device_share": {k: v / total for k, v in sorted(kinds.items())},
            "device_idle_share_of_traced_wall": 1 - busy / (t1 - t0),
            "other_top": sorted(((v / 1e3 / steps, n)
                                 for n, v in other.items()),
                                reverse=True)[:6]}


def _no_dropout(conf):
    for layer, _ in layer_inputs(conf):
        layer.dropOut = None
    return conf


def zoo_parity(dev, cfg):
    """Phase 15(a): AlexNet (LRN) and VGG16 at cut sizes, dropout off,
    params copied from the card's f32 net: 3 steps on the card against
    the same net on the CPU in f64. Each step: f64 card vs f64 CPU, loss
    rel ZOO_F64_LOSS and each gradient rel L2 ZOO_F64_GRAD; f32 card vs
    the f64 CPU, ZOO_F32_LOSS and ZOO_F32_GRAD; then a fit step each."""
    import torch

    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import (
        DataType, MultiLayerNetwork, Nesterovs,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

    torch.backends.cudnn.benchmark = False
    out = {}
    for name, n in cfg["models"].items():
        def build(device, dtype):
            conf = getattr(zoo, name)(
                numClasses=cfg["classes"], seed=SEED,
                inputShape=(3, n, n), updater=Nesterovs(1e-3, 0.9),
                dataType=getattr(DataType, dtype)).conf()
            return MultiLayerNetwork(_no_dropout(conf), device=device).init()

        card32 = build(dev, "FLOAT")
        params = params_to_reference(card32.layers, card32._params)
        nets = {"card32": card32}
        for key, d, dt in (("card64", dev, "DOUBLE"),
                           ("cpu64", "cpu", "DOUBLE")):
            nets[key] = build(d, dt)
            nets[key].load_reference_params(params)
        rng = np.random.default_rng(SEED + 15)
        x = rng.standard_normal((cfg["batch"], 3, n, n)).astype(np.float32)
        y = np.eye(cfg["classes"], dtype=np.float32)[
            rng.integers(0, cfg["classes"], cfg["batch"])]
        worst = {"f64_loss": 0.0, "f64_grad": 0.0, "f32_loss": 0.0,
                 "f32_grad": 0.0}
        losses = []
        for step in range(cfg["steps"]):
            res = {k: net.computeGradientAndScore(x, y)
                   for k, net in nets.items()}
            g64, l64 = res["cpu64"]
            f = {"f64_loss": abs(res["card64"][1] - l64) / abs(l64),
                 "f64_grad": grads_against(res["card64"][0], g64),
                 "f32_loss": abs(res["card32"][1] - l64) / abs(l64),
                 "f32_grad": grads_against(res["card32"][0], g64)}
            worst = {k: max(worst[k], v) for k, v in f.items()}
            losses.append(l64)
            for net in nets.values():
                net.fit(x, y)
        need(worst["f64_loss"] <= ZOO_F64_LOSS
             and worst["f64_grad"] <= ZOO_F64_GRAD,
             f"zoo (a): {name} f64 on the card vs the CPU: {worst}")
        need(worst["f32_loss"] <= ZOO_F32_LOSS
             and worst["f32_grad"] <= ZOO_F32_GRAD,
             f"zoo (a): {name} f32 on the card vs the CPU's f64: {worst}")
        out[name] = dict(worst, input=n, losses_f64=losses)
        del nets
    log("zoo (a): " + json.dumps(out))
    return out


def zoo_batch(dev, cfg, rows, channels=3, seg=False):
    """A seeded NHWC bf16 batch resident on the card with one-hot labels
    (or, for a segmentation net, a binary [B, H, W, C] mask)."""
    import torch

    n = cfg["image"]
    rng = np.random.RandomState(SEED + 15)
    x = torch.from_numpy(rng.rand(rows, n, n, channels).astype(
        np.float32)).to(dev, torch.bfloat16)
    if seg:
        y = (rng.rand(rows, n, n, cfg["classes"]) > 0.5).astype(np.float32)
    else:
        y = np.eye(cfg["classes"], dtype=np.float32)[
            rng.randint(0, cfg["classes"], rows)]
    return x, torch.from_numpy(y).to(dev)


def zoo_timed(dev, cfg, net, x, y, what, traced_steps=0):
    """`cfg["steps"]` fit steps on one resident batch: the median step
    of steps 3..n, images/s, peak memory, share of the bf16 peak (3 x the
    forward's conv + dense FLOPs over 989 TFLOP/s), the loss must fall;
    then, with `traced_steps`, the profiler split by kind."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = fit_timed(net, x, y, cfg["steps"])
    peak = torch.cuda.max_memory_allocated(dev)
    need(all(math.isfinite(v) for v in losses),
         f"{what}: non-finite loss: {losses}")
    need(losses[-1] < losses[0],
         f"{what}: loss did not fall: {losses[0]} -> {losses[-1]}")
    med = float(np.median(step_s[2:]))
    B = x.shape[0]
    flops = 3 * forward_flops(net.conf, B)
    out = {"params": net.numParams(), "batch": B,
           "loss_step1": losses[0], f"loss_step{cfg['steps']}": losses[-1],
           "step_ms_median_3_on": med * 1e3,
           "step_ms_first": step_s[0] * 1e3, "images_per_s": B / med,
           "max_memory_allocated_bytes": peak,
           "train_flops_per_step": flops,
           "share_of_bf16_dense_peak": flops / med / PEAK_BF16_OPS}
    if traced_steps:
        out["trace"] = traced_split(net, x, y, traced_steps, what)
    log(f"{what}: " + json.dumps(out))
    return out


def zoo_classifier(dev, cfg):
    """Phase 15(b)/(c): VGG16 / AlexNet at 224^2, 1000 classes, bf16
    over fp32 masters, NHWC, dropout 0.5 on, the zoo's Nesterovs(1e-2,
    0.9), deterministic cuDNN."""
    import torch

    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import DataType

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    n = cfg["image"]
    net = getattr(zoo, cfg["model"])(
        numClasses=cfg["classes"], seed=SEED, inputShape=(3, n, n),
        dataType=DataType.BFLOAT16, dataFormat="NHWC", device=dev).init()
    x, y = zoo_batch(dev, cfg, cfg["batch"])
    what = f"zoo ({'b' if cfg['model'] == 'VGG16' else 'c'}) {cfg['model']}"
    out = zoo_timed(dev, cfg, net, x, y, what, cfg["traced_steps"])
    del net, x, y
    torch.cuda.empty_cache()
    return out


def zoo_unet(dev, cfg):
    """Phase 15(d): UNet at its zoo default 128^2, binary segmentation
    (numClasses 1: sigmoid + XENT through CnnLossLayer), bf16, NHWC,
    Adam(1e-3)."""
    import torch

    from deeplearning4j_tpu_torch.nn import Adam, DataType
    from deeplearning4j_tpu_torch.zoo import UNet

    n = cfg["image"]
    net = UNet(numClasses=cfg["classes"], seed=SEED, inputShape=(3, n, n),
               updater=Adam(1e-3), dataType=DataType.BFLOAT16,
               dataFormat="NHWC", device=dev).init()
    x, y = zoo_batch(dev, cfg, cfg["batch"], seg=True)
    out = zoo_timed(dev, cfg, net, x, y, "zoo (d) UNet")
    del net, x, y
    torch.cuda.empty_cache()
    return out


def s2d_stem(dev, cfg, phase9b):
    """Phase 15(e): an s2d ResNet-50 built from a standard net's
    parameters, its stem through stem_weights_to_s2d (the reference's
    HWIO arrays) and setParamTable: the global-pool features and the
    logits (features x fc) in f32, eval mode, TF32 off, against the
    standard net's, rel L2 within S2D_LOGIT_REL; then timed steps of the
    s2d net at 9(b)'s settings beside 9(b)'s step."""
    import torch

    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.zoo import ResNet50

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    std = resnet_net(dev, RESNET_TIMED)
    s2d = resnet_net(dev, RESNET_TIMED, stemMode="space_to_depth")
    table = {k: v.toNumpy() for k, v in std.paramTable().items()}
    table["conv1_W"] = ResNet50.stem_weights_to_s2d(table["conv1_W"])
    s2d.setParamTable(table)
    n = RESNET_TIMED["image"]
    rng = np.random.default_rng(SEED + 16)
    x = rng.standard_normal((cfg["batch"], 3, n, n)).astype(np.float32)
    fa, fb = std.feedForward(x)["gap"].tensor(), \
        s2d.feedForward(x)["gap"].tensor()
    W, b = std._params["fc"]["W"].detach(), std._params["fc"]["b"].detach()
    logits_a, logits_b = fa @ W + b, fb @ W + b
    feat_rel, logit_rel = rel_l2(fb, fa), rel_l2(logits_b, logits_a)
    need(logit_rel <= S2D_LOGIT_REL and feat_rel <= S2D_LOGIT_REL,
         f"zoo (e): s2d features rel {feat_rel:.3e}, logits rel "
         f"{logit_rel:.3e} against the standard stem")
    del std, s2d
    torch.cuda.empty_cache()
    net = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                     updater=Nesterovs(0.1, 0.9), stemMode="space_to_depth")
    xb, yb = resnet_batch(dev, RESNET_TIMED, RESNET_TIMED["batch"])
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = fit_timed(net, xb, yb, cfg["steps"])
    need(all(math.isfinite(v) for v in losses),
         f"zoo (e): non-finite s2d loss: {losses}")
    med = float(np.median(step_s[2:])) * 1e3
    out = {"features_rel_l2": feat_rel, "logits_rel_l2": logit_rel,
           "step_ms_median_3_on": med,
           "step_ms_all": [s * 1e3 for s in step_s],
           "images_per_s": RESNET_TIMED["batch"] / med * 1e3,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(
               dev),
           "phase9b_step_ms_median_3_on": phase9b["step_ms_median_3_on"]}
    log("zoo (e): " + json.dumps(out))
    del net, xb, yb
    torch.cuda.empty_cache()
    return out


def remat_ab(dev):
    """Phase 15(f): 9(b)'s ResNet-50 (bf16 NHWC, Nesterovs(0.1, 0.9),
    batch 128, deterministic cuDNN) for REMAT_STEPS fit steps without and
    with checkpointPolicy="save_conv_outputs" from the same weights: the
    losses and the final params, BN statistics and momentum bitwise
    equal; each run's peak memory and step ms."""
    import torch

    from deeplearning4j_tpu_torch.nn import Nesterovs

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    x, y = resnet_batch(dev, RESNET_TIMED, RESNET_TIMED["batch"])
    runs, nets = {}, {}
    for policy in (None, "save_conv_outputs"):
        net = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                         updater=Nesterovs(0.1, 0.9), checkpointPolicy=policy)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        losses, step_s = fit_timed(net, x, y, REMAT_STEPS)
        key = policy or "stock"
        runs[key] = {"losses": losses,
                     "step_ms_median_3_on": float(np.median(step_s[2:]))
                     * 1e3,
                     "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated(dev),
                     "peak_over_resident_bytes":
                         torch.cuda.max_memory_allocated(dev) - base}
        nets[key] = net
    stock, remat = nets["stock"], nets["save_conv_outputs"]
    need(runs["stock"]["losses"] == runs["save_conv_outputs"]["losses"],
         f"zoo (f): remat losses {runs['save_conv_outputs']['losses']} vs "
         f"stock {runs['stock']['losses']}")
    need(state_equal(stock, remat),
         "zoo (f): remat's final state is not stock's bit for bit")
    out = dict(runs, peak_ratio=runs["save_conv_outputs"][
        "max_memory_allocated_bytes"] / runs["stock"][
        "max_memory_allocated_bytes"])
    log("zoo (f): " + json.dumps(out))
    del nets, stock, remat, x, y
    torch.cuda.empty_cache()
    return out


def simple_cnn_blocks(dev, cfg):
    """Phase 15(g): SimpleCNN (3x48x48, its DropoutLayer on, f32) over an
    ExistingDataSetIterator of `batches` batches: fitDataSet(stepsPerSync
    = k) with every block under the sync check against fit from the same
    start, the losses and the state bitwise equal."""
    import torch

    from deeplearning4j_tpu_torch.data import (
        DataSet, ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import sync_free_blocks
    from deeplearning4j_tpu_torch.optimize import CollectScoresListener
    from deeplearning4j_tpu_torch.zoo import SimpleCNN

    B, nb = cfg["batch"], cfg["batches"]
    rng = np.random.RandomState(SEED + 17)
    x = rng.rand(nb * B, 3, 48, 48).astype(np.float32)
    y = np.eye(cfg["classes"], dtype=np.float32)[
        rng.randint(0, cfg["classes"], nb * B)]

    def run(blocks):
        net = SimpleCNN(numClasses=cfg["classes"], seed=SEED,
                        device=dev).init()
        scores = CollectScoresListener()
        net.setListeners(scores)
        it = ExistingDataSetIterator(DataSet(x, y), B)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if blocks:
            with sync_free_blocks():
                net.fitDataSet(it, stepsPerSync=cfg["k"])
        else:
            net.fit(it)
        torch.cuda.synchronize()
        return net, scores.scores, (time.perf_counter() - t) / nb * 1e3

    a, la, ms_fit = run(False)
    b, lb, ms_blocks = run(True)
    need(la == lb and len(la) == nb,
         f"zoo (g): fitDataSet losses {lb} vs fit {la}")
    need(state_equal(a, b), "zoo (g): fitDataSet's state is not fit's")
    need(b._fit_dataset_syncs == nb // cfg["k"] + nb % cfg["k"],
         f"zoo (g): {b._fit_dataset_syncs} syncs")
    out = {"losses": la, "fit_ms_per_step": ms_fit,
           "fit_dataset_ms_per_step": ms_blocks,
           "syncs": b._fit_dataset_syncs}
    log("zoo (g): " + json.dumps(out))
    return out


def cnn_zoo_phase(dev, phase9b):
    """Phase 15: (a) parity, (b) VGG16, (c) AlexNet, (d) UNet, (e) the
    s2d stem, (f) the remat policy, (g) dropout inside blocks; K1-K5
    launch no time."""
    import torch

    before = kernel_launches()
    out = {"parity": zoo_parity(dev, ZOO_PARITY)}
    torch.cuda.empty_cache()
    out["vgg16"] = zoo_classifier(dev, ZOO_VGG)
    out["alexnet"] = zoo_classifier(dev, ZOO_ALEXNET)
    out["unet"] = zoo_unet(dev, ZOO_UNET)
    out["s2d"] = s2d_stem(dev, S2D_CHECK, phase9b)
    out["remat"] = remat_ab(dev)
    out["blocks"] = simple_cnn_blocks(dev, ZOO_SIMPLE)
    need(kernel_launches() == before, "cnn zoo: a hand-written kernel "
         f"launched: {before} -> {kernel_launches()}")
    return out


# ----------------------------------------------------------------------
# phase 16: the rest of the layer catalogue (port PR 12)
# ----------------------------------------------------------------------

#: 16(a)'s bands: f64 on the card against f64 on the CPU
CAT_F64_LOSS = 1e-12
CAT_F64_GRAD = 1e-11
CAT_STEPS = 3
#: dl4j-examples' ImdbReviewClassificationRNN widths: 300-d word inputs,
#: LSTM(256, tanh), RnnOutputLayer(2); the 300-d pretrained vectors are a
#: trainable EmbeddingSequenceLayer over Keras imdb_lstm.py's 20,000-word
#: vocabulary (PERF.md section 4); reviews cut to 256 tokens
IMDB = dict(vocab=20000, embed=300, hidden=256, classes=2, batch=64,
            seq=256, min_len=32, lr=5e-3, l2=1e-5, clip=1.0, steps=20,
            batches=8, traced_steps=3, k=4, graph_steps=3, markers=200,
            marker_share=0.1)
#: dl4j-examples' VaeMNIST2dPlots widths
VAE_MNIST = dict(inputs=784, encoder=(256, 256), decoder=(256, 256),
                 latent=2, batch=128, lr=1e-3, l2=1e-4, train=60000,
                 window=20, head_steps=20)
GRAPH_LOGIT_ATOL = 1e-6


def _cat_confs():
    """16(a)'s cases at cut sizes: (name, conf(M, dtype), data(rng),
    graph?, pretrain layer or None, the f32 band (loss rel, gradient
    rel L2) against the CPU's f64)."""
    from deeplearning4j_tpu_torch import nn as M
    from deeplearning4j_tpu_torch.nn.conf import preprocessors as PP

    V, T = 17, 6

    def builder(dtype, seed, updater=None):
        return (M.NeuralNetConfiguration.Builder().seed(seed)
                .updater(updater or M.Adam(1e-2)).dataType(dtype))

    def tokens(rng, b=4):
        x = rng.integers(0, V, (b, T)).astype(np.float32)
        lens = rng.integers(2, T + 1, b)
        lens[-1] = T
        fm = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        lm = np.zeros_like(fm)
        lm[np.arange(b), lens - 1] = 1.0
        y = np.zeros((b, 2, T), np.float32)
        y[np.arange(b), rng.integers(0, 2, b), :] = 1.0
        return x, y, fm, lm

    def onehot(rng, b, n):
        return np.eye(n, dtype=np.float32)[rng.integers(0, n, b)]

    def seq_labels(b, n, t):
        y = np.zeros((b, n, t), np.float32)
        y[:, 0, ::2] = 1.0
        y[:, 1, 1::2] = 1.0
        return y

    class CustomDense(M.SameDiffLayer):
        def __init__(self, nOut, **kw):
            super().__init__(**kw)
            self.nOut = nOut

        def defineParameters(self, inputType):
            return {"W": (inputType.size, self.nOut), "b": (self.nOut,)}

        def defineLayer(self, sd, x, p):
            return sd.math.tanh(sd.nn.linear(x, p["W"], p["b"]))

    cases = []

    def case(name, conf, data, graph=False, pretrain=None,
             band=(1e-5, 1e-4)):
        cases.append((name, conf, data, graph, pretrain, band))

    case("embedding", lambda dt: (
        builder(dt, 1, M.Sgd(0.1)).list()
        .layer(M.EmbeddingLayer(nIn=V, nOut=5, activation="tanh",
                                hasBias=True))
        .layer(M.OutputLayer(nOut=3, activation="softmax"))
        .setInputType(M.InputType.feedForward(1)).build()),
        lambda rng: (rng.integers(0, V, (5, 1)).astype(np.float32),
                     onehot(rng, 5, 3), None, None))
    case("sequence_masks", lambda dt: (
        builder(dt, 2).l2(1e-5).gradientNormalization(
            M.GradientNormalization.ClipElementWiseAbsoluteValue).list()
        .layer(M.EmbeddingSequenceLayer(nIn=V, nOut=5))
        .layer(M.MaskZeroLayer(M.LSTM(nOut=4)))
        .layer(M.MaskLayer())
        .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                lossFunction="mcxent"))
        .setInputType(M.InputType.recurrent(1, T)).build()), tokens)
    case("time_vertices", lambda dt: (
        builder(dt, 3).graphBuilder().addInputs("in")
        .addLayer("emb", M.EmbeddingSequenceLayer(nIn=V, nOut=5), "in")
        .addLayer("enc", M.LSTM(nOut=4), "emb")
        .addVertex("rev", M.ReverseTimeSeriesVertex(), "enc")
        .addVertex("last", M.LastTimeStepVertex(), "rev")
        .addVertex("dup", M.DuplicateToTimeSeriesVertex(), "last", "emb")
        .addLayer("dec", M.LSTM(nOut=4), "dup")
        .addLayer("out", M.RnnOutputLayer(nOut=2, activation="softmax",
                                          lossFunction="mcxent"), "dec")
        .setOutputs("out").setInputTypes(M.InputType.recurrent(1, T))
        .build()), tokens, graph=True)
    case("cnn_rnn", lambda dt: (
        builder(dt, 4).list()
        .inputPreProcessor(0, PP.RnnToCnnPreProcessor(5, 5, 2))
        .layer(M.ConvolutionLayer(nOut=3, kernelSize=(3, 3),
                                  activation="relu"))
        .layer(M.LSTM(nOut=4))
        .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                lossFunction="mcxent"))
        .setInputType(M.InputType.recurrent(50, T)).build()),
        lambda rng: (rng.standard_normal((3, 50, T)).astype(np.float32),
                     seq_labels(3, 2, T), None, None))
    case("constraints_noise_bias", lambda dt: (
        builder(dt, 5).biasUpdater(M.Sgd(0.05))
        .weightNoise(M.DropConnect(0.8))
        .constrainWeights(M.MaxNormConstraint(maxNorm=0.6))
        .constrainBias(M.NonNegativeConstraint()).list()
        .layer(M.Convolution1DLayer(nOut=4, kernelSize=3,
                                    activation="tanh"))
        .layer(M.GlobalPoolingLayer(poolingType="avg"))
        .layer(M.DenseLayer(nOut=5, activation="relu"))
        .layer(M.OutputLayer(nOut=3, activation="softmax"))
        .setInputType(M.InputType.recurrent(3, 8)).build()),
        lambda rng: (rng.standard_normal((4, 3, 8)).astype(np.float32),
                     onehot(rng, 4, 3), None, None))
    case("frozen_with_backprop", lambda dt: (
        builder(dt, 6).list()
        .layer(M.FrozenLayerWithBackprop(M.DenseLayer(nOut=6,
                                                      activation="tanh")))
        .layer(M.ElementWiseMultiplicationLayer(activation="tanh"))
        .layer(M.PReLULayer(alphaInit=0.2))
        .layer(M.OutputLayer(nOut=2, activation="softmax"))
        .setInputType(M.InputType.feedForward(4)).build()),
        lambda rng: (rng.standard_normal((6, 4)).astype(np.float32),
                     onehot(rng, 6, 2), None, None))
    case("layers_1d", lambda dt: (
        builder(dt, 7).list()
        .layer(M.Convolution1DLayer(nOut=4, kernelSize=3, padding=1,
                                    activation="tanh"))
        .layer(M.Subsampling1DLayer(poolingType="max", kernelSize=2,
                                    stride=1))
        .layer(M.Upsampling1D(size=2))
        .layer(M.Cropping1D(cropping=(1, 2)))
        .layer(M.ZeroPadding1DLayer(padding=(2, 1)))
        .layer(M.LocallyConnected1D(nOut=3, kernelSize=3, stride=2,
                                    activation="tanh"))
        .layer(M.GlobalPoolingLayer(poolingType="max"))
        .layer(M.OutputLayer(nOut=3, activation="softmax"))
        .setInputType(M.InputType.recurrent(2, 9)).build()),
        lambda rng: (rng.standard_normal((4, 2, 9)).astype(np.float32),
                     onehot(rng, 4, 3), None, None))
    case("repeat_vector", lambda dt: (
        builder(dt, 8).list()
        .layer(M.DenseLayer(nOut=4, activation="tanh"))
        .layer(M.RepeatVector(n=5))
        .layer(M.LSTM(nOut=3))
        .layer(M.RnnOutputLayer(nOut=2, activation="softmax",
                                lossFunction="mcxent"))
        .setInputType(M.InputType.feedForward(3)).build()),
        lambda rng: (rng.standard_normal((4, 3)).astype(np.float32),
                     seq_labels(4, 2, 5), None, None))
    case("layers_2d_misc", lambda dt: (
        builder(dt, 9).list()
        .layer(M.LocallyConnected2D(nOut=3, kernelSize=(2, 2),
                                    activation="tanh"))
        .layer(M.PReLULayer(sharedAxes=(2, 3), alphaInit=0.1))
        .layer(M.OutputLayer(nOut=2, activation="softmax"))
        .setInputType(M.InputType.convolutional(5, 4, 2)).build()),
        lambda rng: (rng.standard_normal((3, 2, 5, 4)).astype(np.float32),
                     onehot(rng, 3, 2), None, None))
    case("capsules", lambda dt: (
        builder(dt, 10).list()
        .layer(M.ConvolutionLayer(nOut=6, kernelSize=(3, 3),
                                  activation="relu"))
        .layer(M.PrimaryCapsules(capsules=3, capsuleDimensions=4,
                                 kernelSize=(3, 3), stride=(2, 2)))
        .layer(M.CapsuleLayer(capsules=3, capsuleDimensions=5,
                              routings=3))
        .layer(M.CapsuleStrengthLayer())
        .layer(M.LossLayer(lossFunction="mcxent", activation="softmax"))
        .setInputType(M.InputType.convolutional(10, 9, 2)).build()),
        lambda rng: (rng.random((3, 2, 10, 9)).astype(np.float32),
                     onehot(rng, 3, 3), None, None), band=(1e-5, 1e-3))
    case("center_loss", lambda dt: (
        builder(dt, 11).list()
        .layer(M.DenseLayer(nOut=5, activation="tanh"))
        .layer(M.CenterLossOutputLayer(nOut=3, activation="softmax",
                                       lossFunction="mcxent", lambda_=0.5))
        .setInputType(M.InputType.feedForward(4)).build()),
        lambda rng: (rng.standard_normal((8, 4)).astype(np.float32),
                     onehot(rng, 8, 3), None, None))
    case("ocnn", lambda dt: (
        builder(dt, 12).list()
        .layer(M.DenseLayer(nOut=8, activation="tanh"))
        .layer(M.OCNNOutputLayer(hiddenSize=6, nu=0.1,
                                 activation="sigmoid"))
        .setInputType(M.InputType.feedForward(4)).build()),
        lambda rng: (rng.standard_normal((20, 4)).astype(np.float32),
                     np.zeros((20, 1), np.float32), None, None))
    case("samediff", lambda dt: (
        builder(dt, 13).list()
        .layer(CustomDense(nOut=6))
        .layer(M.SameDiffLambdaLayer(
            lambdaFn=lambda sd, x: sd.math.mul(x, sd.nn.sigmoid(x))))
        .layer(M.OutputLayer(nOut=2, activation="softmax"))
        .setInputType(M.InputType.feedForward(4)).build()),
        lambda rng: (rng.standard_normal((6, 4)).astype(np.float32),
                     onehot(rng, 6, 2), None, None))
    case("vae", lambda dt: (
        builder(dt, 14, M.RmsProp(1e-2)).list()
        .layer(M.VariationalAutoencoder(
            nOut=2, encoderLayerSizes=(6, 5), decoderLayerSizes=(5,),
            activation="leakyrelu", reconstructionDistribution="bernoulli",
            numSamples=2))
        .layer(M.OutputLayer(nOut=2, activation="softmax"))
        .setInputType(M.InputType.feedForward(8)).build()),
        lambda rng: ((rng.random((6, 8)) > 0.5).astype(np.float32),
                     onehot(rng, 6, 2), None, None), pretrain=0)
    case("autoencoder", lambda dt: (
        builder(dt, 15, M.Sgd(0.1)).list()
        .layer(M.AutoEncoder(nOut=3, corruptionLevel=0.3,
                             activation="sigmoid"))
        .layer(M.OutputLayer(nOut=2, activation="softmax"))
        .setInputType(M.InputType.feedForward(6)).build()),
        lambda rng: (rng.random((6, 6)).astype(np.float32),
                     onehot(rng, 6, 2), None, None), pretrain=0)
    return cases


def _draw_on_cpu(net):
    """Weight noise, VAE samples and AutoEncoder corruption drawn on the
    CPU and moved to the net's device, so the card and the CPU see one
    draw (Philox streams differ by device)."""
    layers = net.layers if hasattr(net, "layers") else [
        net.conf.nodes[n].payload for n in net._layer_names]
    for layer in layers:
        wn = getattr(layer, "weightNoise", None)
        if wn is not None and not hasattr(wn, "_cpu_draw"):
            wn._cpu_draw = wn.draw
            wn.draw = lambda v, key, f=wn._cpu_draw: f(
                v.detach().cpu(), key).to(v.device)
        if hasattr(layer, "draw_eps"):
            f = layer.draw_eps
            layer.draw_eps = lambda key, shape, device, dtype, n, f=f: [
                e.to(device) for e in f(key, shape, "cpu", dtype, n)]
        if hasattr(layer, "draw_keep"):
            f = layer.draw_keep
            layer.draw_keep = lambda x, key, f=f: f(
                x.detach().cpu(), key).to(x.device)


def _loss_grads(net, x, y, fm, lm, graph, pretrain):
    """The training loss (no dropout key) or a pretrain step's loss, and
    every gradient {(layer, name): CPU tensor}."""
    import torch

    from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey
    from deeplearning4j_tpu_torch.nn.multilayer import cast_params

    dev = net.device

    def t(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    keys = net._unit_keys()
    if pretrain is not None:
        layer = net._unit_layer(pretrain)
        p = net._params[pretrain]
        loss = layer.pretrain_loss(
            cast_params(p, net._compute_dtype, net._param_dtype),
            net._frozen_feed(pretrain, x), StepKey(41, net._iteration))
        keys = [pretrain]
    elif graph:
        name = net.conf.networkInputs[0]
        loss, _ = net._loss_fn(
            net._params, net._states, {name: t(x)}, [t(y)],
            None if fm is None else {name: t(fm)},
            None if lm is None else [t(lm)])
    else:
        loss, _ = net._loss_fn(net._params, net._states, t(x), t(y), t(fm),
                               t(lm))
    names = [(k, n) for k in keys for n in net._params[k]]
    gs = torch.autograd.grad(loss, [net._params[k][n] for k, n in names],
                             allow_unused=True)
    return float(loss.detach()), {
        kn: (torch.zeros_like(net._params[kn[0]][kn[1]]) if g is None
             else g).detach().cpu() for kn, g in zip(names, gs)}


def catalogue_parity(dev, steps=CAT_STEPS):
    """Phase 16(a): every class ported in PR 12 at cut sizes, one net each
    on the card in f64 and f32 and on the CPU in f64 from the same
    weights; the weight noise, VAE samples and corruption drawn once on
    the CPU. Each of `steps` steps: f64 card vs f64 CPU, the loss rel
    CAT_F64_LOSS and every gradient rel L2 CAT_F64_GRAD; f32 card vs f64
    CPU within the case's band; then a fit (or pretrain) step each, with
    the masks. SpaceToBatch, which changes the batch, is held as a
    forward alone."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import (
        ComputationGraph, DataType, MultiLayerNetwork, SpaceToBatch,
    )
    from deeplearning4j_tpu_torch.nn.graph import \
        params_to_reference as g_to_ref
    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

    out = {}
    for name, conf, data, graph, pretrain, band in _cat_confs():
        cls = ComputationGraph if graph else MultiLayerNetwork
        card32 = cls(conf(DataType.FLOAT), device=dev).init()
        ref = (g_to_ref(card32.conf, card32._params) if graph
               else params_to_reference(card32.layers, card32._params))
        nets = {"card32": card32}
        for key, d in (("card64", dev), ("cpu64", "cpu")):
            nets[key] = cls(conf(DataType.DOUBLE), device=d).init()
            nets[key].load_reference_params(ref)
        for net in nets.values():
            _draw_on_cpu(net)
        rng = np.random.default_rng(SEED + 16)
        x, y, fm, lm = data(rng)
        worst = {"f64_loss": 0.0, "f64_grad": 0.0, "f32_loss": 0.0,
                 "f32_grad": 0.0}
        for _ in range(steps):
            res = {k: _loss_grads(n, x, y, fm, lm, graph, pretrain)
                   for k, n in nets.items()}
            l64, g64 = res["cpu64"]
            f = {"f64_loss": abs(res["card64"][0] - l64) / abs(l64),
                 "f64_grad": max(rel_l2(res["card64"][1][k], g)
                                 for k, g in g64.items()),
                 "f32_loss": abs(res["card32"][0] - l64) / abs(l64),
                 "f32_grad": max(rel_l2(res["card32"][1][k], g)
                                 for k, g in g64.items())}
            worst = {k: max(worst[k], v) for k, v in f.items()}
            for n in nets.values():
                if pretrain is not None:
                    n.pretrainLayer(pretrain, x)
                else:
                    n.fit(DataSet(x, y, fm, lm))
        need(worst["f64_loss"] <= CAT_F64_LOSS
             and worst["f64_grad"] <= CAT_F64_GRAD,
             f"catalogue (a): {name} f64 on the card vs the CPU: {worst}")
        need(worst["f32_loss"] <= band[0] and worst["f32_grad"] <= band[1],
             f"catalogue (a): {name} f32 on the card vs the CPU's f64 "
             f"beyond {band}: {worst}")
        out[name] = dict(worst, f32_band=list(band))
        del nets
    x = np.random.default_rng(SEED).standard_normal((2, 3, 6, 4))
    layer = SpaceToBatch(blocks=2, padding=((1, 1), (0, 2)))
    got = layer.forward({}, {}, torch.from_numpy(x).to(dev), False, None)[0]
    want = layer.forward({}, {}, torch.from_numpy(x), False, None)[0]
    need(torch.equal(got.cpu(), want), "catalogue (a): SpaceToBatch on the "
         "card differs from the CPU")
    log("catalogue (a): " + json.dumps(out))
    return out


def imdb_conf(cfg, graph=False):
    """16(b)'s sequence classifier (the MultiLayerNetwork), or 16(c)'s
    graph form through LastTimeStepVertex, at the configuration's
    widths."""
    from deeplearning4j_tpu_torch import nn as M

    b = (M.NeuralNetConfiguration.Builder().seed(SEED)
         .updater(M.Adam(cfg["lr"])).l2(cfg["l2"])
         .weightInit(M.WeightInit.XAVIER)
         .gradientNormalization(
             M.GradientNormalization.ClipElementWiseAbsoluteValue)
         .gradientNormalizationThreshold(cfg["clip"]))
    emb = M.EmbeddingSequenceLayer(nIn=cfg["vocab"], nOut=cfg["embed"])
    lstm = M.LSTM(nOut=cfg["hidden"], activation="tanh")
    it = M.InputType.recurrent(1, cfg["seq"])
    if not graph:
        return (b.list().layer(emb).layer(lstm)
                .layer(M.RnnOutputLayer(nOut=cfg["classes"],
                                        activation="softmax",
                                        lossFunction="mcxent"))
                .setInputType(it).build())
    return (b.graphBuilder().addInputs("tokens")
            .addLayer("emb", emb, "tokens").addLayer("lstm", lstm, "emb")
            .addVertex("last", M.LastTimeStepVertex(), "lstm")
            .addLayer("out", M.OutputLayer(nOut=cfg["classes"],
                                           activation="softmax",
                                           lossFunction="mcxent"), "last")
            .setOutputs("out").setInputTypes(it).build())


def imdb_batches(cfg, n, seed=SEED):
    """`n` seeded batches of ragged reviews: token ids over the
    vocabulary, lengths uniform in [min_len, seq]; a share of each
    review's tokens comes from its class's marker words, so the loss can
    fall. The features mask covers each review; the labels mask marks
    its last valid step, as the example's iterator does. Returns
    DataSets (features [B, T], labels [B, 2, T], both masks [B, T])."""
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.default_rng(seed)
    B, T, V = cfg["batch"], cfg["seq"], cfg["vocab"]
    out = []
    for _ in range(n):
        cls = rng.integers(0, cfg["classes"], B)
        x = rng.integers(2 * cfg["markers"], V, (B, T))
        mark = rng.random((B, T)) < cfg["marker_share"]
        words = cls[:, None] * cfg["markers"] + rng.integers(
            0, cfg["markers"], (B, T))
        x = np.where(mark, words, x).astype(np.float32)
        lens = rng.integers(cfg["min_len"], T + 1, B)
        fm = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        lm = np.zeros_like(fm)
        lm[np.arange(B), lens - 1] = 1.0
        y = np.zeros((B, cfg["classes"], T), np.float32)
        y[np.arange(B), cls, :] = 1.0
        out.append(DataSet(x, y, fm, lm))
    return out


class _ListIterator:
    """A DataSetIterator over resident DataSets (masks included)."""

    def __init__(self, batches):
        self.batches = batches
        self.reset()

    def reset(self):
        self.i = 0

    def hasNext(self):
        return self.i < len(self.batches)

    def next(self):
        self.i += 1
        return self.batches[self.i - 1]


def traced_steps(fn, steps):
    """`steps` calls of `fn` under torch.profiler: (device kernels a call,
    the device's busy share of the traced wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("smoke.steps"):
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    scope = [e for e in events if e.name == "smoke.steps"
             and e.device_type == torch.autograd.DeviceType.CPU]
    need(len(scope) == 1, f"trace: {len(scope)} traced scopes")
    t0, t1 = scope[0].time_range.start, scope[0].time_range.end
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation
               and t0 <= e.time_range.start <= t1]
    busy = device_busy_us(events, t0, t1)
    need(busy > 0 and kernels, "trace: the profiler saw no device time")
    return len(kernels) / steps, busy / (t1 - t0)


def imdb_classifier(dev, cfg):
    """Phase 16(b): the masked sequence classifier at full width through
    MultiLayerNetwork.fit: `steps` steps over `batches` resident batches
    in turn (median step of 3..n, valid tokens/s, peak memory, the loss
    must fall), a traced window of kernels a step and busy share,
    fitDataSet(k) bitwise fit over the batches, and two identical steps
    from one saved state bitwise equal (the embedding's gradient is a
    deterministic sort-and-segment-sum on the card)."""
    import torch

    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

    from deeplearning4j_tpu_torch.data import DataSet

    net = MultiLayerNetwork(imdb_conf(cfg), device=dev).init()
    batches = imdb_batches(cfg, cfg["batches"])
    on_card = [DataSet(*(torch.from_numpy(a).to(dev) for a in (
        ds.getFeatures(), ds.getLabels(), ds.getFeaturesMaskArray(),
        ds.getLabelsMaskArray()))) for ds in batches]
    start = net.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = [], []
    for i in range(cfg["steps"]):
        t = time.perf_counter()
        net.fit(on_card[i % len(on_card)])
        losses.append(net.score())
        step_s.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated(dev)
    need(all(math.isfinite(v) for v in losses),
         f"imdb (b): non-finite loss {losses}")
    n = len(on_card)
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    need(last < first, f"imdb (b): the loss did not fall: {losses}")
    med = float(np.median(step_s[2:]))
    valid = float(np.mean([ds.getFeaturesMaskArray().sum()
                           for ds in batches]))
    kernels, busy = traced_steps(lambda: net.fit(on_card[0]),
                                 cfg["traced_steps"])
    # fitDataSet(k) bitwise fit over the batches, from one saved state
    a, b = start.clone(), start.clone()
    a.fit(_ListIterator(batches))
    b.fitDataSet(_ListIterator(batches), stepsPerSync=cfg["k"])
    need(state_equal(a, b), "imdb (b): fitDataSet(k) differs from fit")
    # two identical steps from one state: the table bitwise
    c, d = start.clone(), start.clone()
    c.fit(batches[0])
    d.fit(batches[0])
    need(torch.equal(c._params[0]["W"], d._params[0]["W"])
         and state_equal(c, d),
         "imdb (b): two identical steps differ (embedding gradient)")
    del a, b, c, d
    out = {"params": net.numParams(), "batch": cfg["batch"],
           "seq": cfg["seq"], "loss_first_mean": first,
           "loss_last_mean": last, "losses": losses,
           "step_ms_median_3_to_20": med * 1e3,
           "step_ms_first": step_s[0] * 1e3,
           "valid_tokens_per_step": valid,
           "valid_tokens_per_s": valid / med,
           "max_memory_allocated_bytes": peak,
           "kernels_per_step": kernels,
           "device_busy_share_of_traced_wall": busy,
           "fit_dataset_bitwise_fit": True,
           "identical_steps_bitwise": True}
    log("imdb (b): " + json.dumps(out))
    return net, start, batches, out


def _graph_from(cg, mln):
    cg.setParamTable({
        "emb_W": mln.getParam("0_W"), "lstm_W": mln.getParam("1_W"),
        "lstm_RW": mln.getParam("1_RW"), "lstm_b": mln.getParam("1_b"),
        "out_W": mln.getParam("2_W"), "out_b": mln.getParam("2_b")})
    return cg


def _last_step(mln, cg, x, fm):
    """(the MLN's per-step logits and LSTM output at each review's last
    valid step; the graph's logits and LastTimeStepVertex output)."""
    import torch

    with torch.no_grad():
        h = mln._entry(x)
        feats = []
        for i, layer in enumerate(mln.layers[:2]):
            h, _ = layer.forward(mln._params[i], mln._states[i], h, False,
                                 None, fm)
            feats.append(h)
        seq, _ = mln._run_layers(mln._params, mln._states, x, False, fm)
        acts, pre, _ = cg._run_graph(cg._params, cg._states, {"tokens": x},
                                     False, None, {"tokens": fm})
    rows = torch.arange(x.shape[0], device=x.device)
    last = fm.sum(1).long() - 1
    return (seq[rows, :, last], feats[1][rows, :, last], pre["out"],
            acts["last"])


def imdb_graph(dev, cfg, mln, start, batches):
    """Phase 16(c): the graph form through LastTimeStepVertex. Under (b)'s
    initial weights its logits equal (b)'s per-step logits at each
    review's last valid step (f32, GRAPH_LOGIT_ATOL); under (b)'s trained
    weights the vertex's output equals (b)'s LSTM output there bit for bit
    (the logits then differ by the rounding of two product shapes,
    recorded). Then a few fit steps."""
    import torch

    from deeplearning4j_tpu_torch.nn import ComputationGraph

    ds = batches[0]
    x = torch.as_tensor(np.asarray(ds.getFeatures())).to(dev)
    fm = torch.as_tensor(np.asarray(ds.getFeaturesMaskArray())).to(dev)
    cg = _graph_from(ComputationGraph(imdb_conf(cfg, graph=True),
                                      device=dev).init(), start)
    want, _, got, _ = _last_step(start, cg, x, fm)
    err = float((got - want).abs().max())
    need(err <= GRAPH_LOGIT_ATOL,
         f"imdb (c): graph logits differ from the MLN's by {err}")
    want_t, feat, got_t, vert = _last_step(mln, _graph_from(cg, mln), x, fm)
    need(torch.equal(vert, feat), "imdb (c): LastTimeStepVertex differs "
         "from the MLN's LSTM output at the last valid step")
    y = torch.as_tensor(np.asarray(ds.getLabels())[:, :, 0]).to(dev)
    losses = []
    for _ in range(cfg["graph_steps"]):
        cg._fit_batch({"tokens": x}, [y], {"tokens": fm}, None)
        losses.append(cg.score())
    need(all(math.isfinite(v) for v in losses),
         f"imdb (c): non-finite graph loss {losses}")
    out = {"logits_max_abs_vs_mln": err,
           "logits_max_abs": float(want.abs().max()),
           "trained_logits_max_abs_vs_mln": float(
               (got_t - want_t).abs().max()),
           "trained_logits_max_abs": float(want_t.abs().max()),
           "trained_last_step_bitwise": True, "graph_losses": losses}
    log("imdb (c): " + json.dumps(out))
    return out


def vae_mnist(dev, cfg):
    """Phase 16(d): the VAE at VaeMNIST2dPlots widths pretrained for one
    epoch over the flagged synthetic 60,000-digit MNIST (pretrain steps/s,
    the negative ELBO of the first and last `window` batches, which must
    fall), then the VAE as the feature layer under a supervised head that
    fits (its loss must fall)."""
    import torch

    from deeplearning4j_tpu_torch import nn as M
    from deeplearning4j_tpu_torch.data.iterators import MnistDataSetIterator

    conf = (M.NeuralNetConfiguration.Builder().seed(SEED)
            .updater(M.RmsProp(cfg["lr"])).l2(cfg["l2"])
            .weightInit(M.WeightInit.XAVIER).list()
            .layer(M.VariationalAutoencoder(
                nOut=cfg["latent"], encoderLayerSizes=cfg["encoder"],
                decoderLayerSizes=cfg["decoder"], activation="leakyrelu",
                pzxActivationFunction="identity",
                reconstructionDistribution="bernoulli"))
            .layer(M.OutputLayer(nOut=10, activation="softmax",
                                 lossFunction="mcxent"))
            .setInputType(M.InputType.feedForward(cfg["inputs"])).build())
    net = M.MultiLayerNetwork(conf, device=dev).init()
    it = MnistDataSetIterator(cfg["batch"], train=True, seed=SEED,
                              numExamples=cfg["train"])
    need(it.isSynthetic, "vae (d): expected the flagged synthetic MNIST")
    torch.cuda.synchronize()
    t = time.perf_counter()
    net.pretrain(it, epochs=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    elbo = [float(v) for v in torch.stack(net._pretrain_losses).cpu()]
    w = cfg["window"]
    first, last = float(np.mean(elbo[:w])), float(np.mean(elbo[-w:]))
    need(all(math.isfinite(v) for v in elbo) and last < first,
         f"vae (d): the negative ELBO did not fall: {first} -> {last}")
    it.reset()
    head = []
    for _ in range(cfg["head_steps"]):
        net.fit(it.next())
        head.append(net.score())
    need(np.mean(head[-5:]) < np.mean(head[:5]),
         f"vae (d): the supervised head did not fit: {head}")
    out = {"params": net.numParams(), "batches": len(elbo),
           "pretrain_s": dt, "pretrain_steps_per_s": len(elbo) / dt,
           "neg_elbo_first20_mean": first, "neg_elbo_last20_mean": last,
           "head_loss_first": head[0], "head_loss_last": head[-1]}
    log("vae (d): " + json.dumps(out))
    return out


def catalogue_phase(dev):
    """Phase 16: (a) catalogue parity, (b) the sequence classifier,
    (c) its graph form, (d) VAE pretraining; K1-K5 launch no time."""
    import torch

    before = kernel_launches()
    parity = catalogue_parity(dev)
    torch.cuda.empty_cache()
    net, start, batches, imdb = imdb_classifier(dev, IMDB)
    graph = imdb_graph(dev, IMDB, net, start, batches)
    del net, start, batches
    torch.cuda.empty_cache()
    vae = vae_mnist(dev, VAE_MNIST)
    need(kernel_launches() == before, "catalogue: a hand-written kernel "
         f"launched: {before} -> {kernel_launches()}")
    return {"parity": parity, "imdb": imdb, "graph": graph, "vae": vae}


# ----------------------------------------------------------------------
# phase 17: the data and fine-tuning runtime
# ----------------------------------------------------------------------

#: 17(a): 14(a)'s 9 batches of config 4 behind the native ring
PREFETCH = dict(queue=4)
#: 17(b): config 1 through records: 14(b)'s MNIST as CSV files
RECORDS = dict(batch=64, train=60000, test=10000, epochs=1,
               min_accuracy=0.9, queue=4)
#: 17(c): config 4's batch augmented; 32 one-second 16 kHz clips
AUGMENT = dict(pad=16, angle=15, reps=10, check_rows=16)
AUDIO = dict(clips=32, rate=16000, seconds=1, coeffs=13, reps=10)
#: 17(d): dl4j-examples EditLastLayerOthersFrozen on zoo VGG16 ("fc2" is
#: layer 19: 13 convolutions and 5 pools, then fc1, fc2, predictions)
VGG_TRANSFER = dict(batch=15, image=224, classes=5, steps=20, frozen_till=19,
                    lr=5e-5, seed=12345)
#: 17(e): phase 7's encoder frozen through the sixth block's output
ENCODER_TRANSFER = dict(steps=5, cut="res2_5", trainable_blocks=6)
#: 17(f): config 2's MLP under each line-search solver
SOLVERS = dict(steps=20, newton_steps=40, newton_bar=5e-3)
#: 17(g): config 4's ResNet-50 inference, int8 weights against bf16
INT8 = dict(reps=20, check_rows=4)
#: the CPU tests' bands (tests/test_torch_augment_audio.py,
#: tests/test_torch_quantize.py, tests/test_torch_transfer.py)
ROTATE_ATOL = 1e-5
AUDIO_REL_MAX = 1e-5
INT8_REL_L2 = 1e-5
TRANSFER_RTOL = 1e-5


def prefetch_spans(reg):
    """The prefetch spans in the registry's trace: {name: [count, median
    ms]} (the producer's next, pack and push; the consumer's pop and
    stage)."""
    got = {}
    for s in reg.trace.spans():
        if s["name"].startswith("prefetch."):
            got.setdefault(s["name"][len("prefetch."):], []).append(
                s["dur"] * 1e3)
    return {n: [len(v), float(np.median(v))] for n, v in got.items()}


def prefetch_leg(dev, cfg, phase14a, stats_log):
    """17(a): config 4 fed through AsyncDataSetIterator over the native
    ring: fit and fitDataSet(k) beside the unwrapped iterator's, bitwise
    equal; the block spans and a traced block's idle share."""
    import torch

    from deeplearning4j_tpu_torch.data import (
        DataSet, ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresListener, StatsListener,
    )
    from deeplearning4j_tpu_torch.runtime import (
        AsyncDataSetIterator, telemetry,
    )
    from deeplearning4j_tpu_torch.runtime.async_iterator import HOST_COPIES

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    B = RESNET_TIMED["batch"]
    nb, k = RUNTIME_RESNET["batches"], RUNTIME_RESNET["k"]
    x, y = runtime_images(np.random.RandomState(SEED + 14), nb * B)

    def base(lo=0, hi=nb):
        return ExistingDataSetIterator(DataSet(x[lo * B:hi * B],
                                               y[lo * B:hi * B]), B)

    def prefetched(lo=0, hi=nb):
        it = AsyncDataSetIterator(base(lo, hi), queueSize=cfg["queue"],
                                  device=dev)
        need(it.ring.kind == "native", f"prefetch (a): the {it.ring.kind}"
             " ring ran, not the native one")
        return it

    start = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                       updater=Nesterovs(0.1, 0.9))
    start.fit(base(0, 1))          # warm cuDNN and cuBLAS up off the clock
    names = ["fit", "fit_async", "fit_dataset", "fit_dataset_async"]
    reg = telemetry.get_registry()
    ms = {n: [] for n in names}
    runs, spans, pspans = {}, {}, {}
    # each way twice, in order and then in reverse, each from a clone of
    # one start: no way is timed only first (page faults, allocator)
    for order in (names, names[::-1]):
        for name in order:
            net = start.clone()
            it = prefetched() if name.endswith("async") else base()
            scores = CollectScoresListener()
            extra = [StatsListener(logFile=stats_log, frequency=1)] \
                if name == "fit_async" and order is names else []
            net.setListeners(scores, *extra)
            reg.trace.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name.startswith("fit_dataset"):
                net.fitDataSet(it, stepsPerSync=k)
            else:
                net.fit(it)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3 / nb)
            if name.startswith("fit_dataset"):
                spans.setdefault(name, []).append(block_spans(reg))
            if name.endswith("async"):
                pspans.setdefault(name, []).append(prefetch_spans(reg))
                ring = {"kind": it.ring.kind,
                        "slot_bytes": it.ring.slot_bytes,
                        "queue": cfg["queue"],
                        "host_copies_a_batch": HOST_COPIES}
                it.close()
            del it
            if name in runs:
                need(scores.scores == runs[name][0] and state_equal(
                    net, runs[name][1]), f"prefetch (a): {name}'s second "
                    "run differs from its first")
            else:
                runs[name] = (scores.scores, net)
    del start
    for name in names[1:]:
        need(runs[name][0] == runs["fit"][0],
             f"prefetch (a): {name}'s losses {runs[name][0]} vs "
             f"fit's {runs['fit'][0]}")
        need(state_equal(runs[name][1], runs["fit"][1]), f"prefetch (a): "
             f"{name}'s params, BN statistics or momentum differ from fit's")
    nets = {n: r[1] for n, r in runs.items()}
    it4 = prefetched(0, k)
    busy, traced_ms = traced_busy_share(
        lambda: nets["fit_dataset_async"].fitDataSet(it4, stepsPerSync=k))
    it4.close()
    result = {
        "ring": ring,
        "ms_per_step": {n: min(v) for n, v in ms.items()},
        "ms_per_step_in_order_and_reversed": ms,
        "phase14a_ms_per_step": {
            "fit": phase14a["fit_ms_per_step"],
            "fit_dataset": phase14a["fit_dataset_ms_per_step"]},
        "spans_ms": spans, "prefetch_spans_median_ms": pspans,
        "losses": runs["fit"][0],
        "traced_block_ms": traced_ms,
        "traced_block_device_idle_share": 1 - busy,
        "phase14a_traced_block_device_idle_share":
            phase14a["traced_block_device_idle_share"]}
    log("fine-tune (a) prefetch: " + json.dumps(result))
    del nets, x, y
    return result


def _mnist_csv(it, path):
    """An MNIST iterator's examples as a CSV of 785 integer columns (the
    idx bytes of the 784 pixels, then the label); returns the rows."""
    pix = np.rint(it._f.reshape(len(it._f), -1) * 255).astype(np.int64)
    rows = np.concatenate([pix, it._l.argmax(1)[:, None]], 1)
    digits = [str(i) for i in range(256)]
    with open(path, "w") as fh:
        for r in rows.tolist():
            fh.write(",".join([digits[v] for v in r]))
            fh.write("\n")
    return rows


def records_leg(dev, cfg, phase14b):
    """17(b): config 1 at full size through CSV records: the native
    parser, a TransformProcess (a column filter, a conversion, its JSON
    round trip), RecordReaderDataSetIterator, NormalizerStandardize and
    AsyncDataSetIterator feeding zoo LeNet."""
    import os
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.data import (
        CSVRecordReader, CollectionRecordReader, ConditionFilter,
        ConditionOp, IntegerColumnCondition, MnistDataSetIterator,
        NormalizerStandardize, RecordReaderDataSetIterator, Schema,
        TransformProcess,
    )
    from deeplearning4j_tpu_torch.runtime import (
        AsyncDataSetIterator, textparse,
    )
    from deeplearning4j_tpu_torch.zoo import LeNet

    B = cfg["batch"]
    schema = (Schema.Builder()
              .addColumnsDouble(*[f"pixel{i}" for i in range(784)])
              .addColumnInteger("label").build())
    tp = (TransformProcess.Builder(schema)
          .filter(ConditionFilter(IntegerColumnCondition(
              "label", ConditionOp.GreaterThan, 9)))
          .integerToCategorical("label", [str(i) for i in range(10)])
          .categoricalToInteger("label").build())
    text = tp.toJson()
    tp = TransformProcess.fromJson(text)
    need(tp.toJson() == text, "records (b): the TransformProcess JSON did "
         "not round-trip")
    textparse.native_lib()          # raises when the parser cannot build
    out = {"parser": "native (csrc/textparse.cpp)"}
    with tempfile.TemporaryDirectory() as d:
        iters = {}
        for split, n in (("train", cfg["train"]), ("test", cfg["test"])):
            src = MnistDataSetIterator(B, train=split == "train",
                                       numExamples=n)
            path = os.path.join(d, f"{split}.csv")
            t = time.perf_counter()
            rows = _mnist_csv(src, path)
            write_s = time.perf_counter() - t
            rr = CSVRecordReader().initialize(path)
            t = time.perf_counter()
            m = rr.asMatrix()
            parse_s = time.perf_counter() - t
            need(m is not None and np.array_equal(m, rows),
                 f"records (b): the native parser's {split} matrix differs "
                 "from the rows written")
            t = time.perf_counter()
            recs = m.tolist()
            for r in recs:
                r[784] = int(r[784])
            recs = tp.execute(recs)
            tp_s = time.perf_counter() - t
            need(len(recs) == n, f"records (b): the filter kept "
                 f"{len(recs)} of {n} {split} records")
            t = time.perf_counter()
            # in the CSV's order (the generator's, classes mixed): the
            # two fits below see the same batches whatever their resets
            iters[split] = RecordReaderDataSetIterator(
                CollectionRecordReader(recs), B, labelIndex=784,
                numPossibleLabels=10)
            batch_s = time.perf_counter() - t
            mb = os.path.getsize(path) / 1e6
            out[split] = {"examples": n, "csv_mb": mb, "write_s": write_s,
                          "parse_s": parse_s, "parse_mb_per_s": mb / parse_s,
                          "transform_s": tp_s, "batching_s": batch_s,
                          "synthetic": bool(src.isSynthetic)}
            del m, recs, rows
    norm = NormalizerStandardize().fit(iters["train"])
    for it in iters.values():
        it.setPreProcessor(norm)
    start = LeNet(numClasses=10, seed=SEED, device=dev).init()
    start.fit(iters["train"].next())        # warm up off the clock
    nets, fit_s = {"fit": start.clone(), "fit_async": start.clone()}, {}
    for name, net in nets.items():
        it = iters["train"]
        if name == "fit_async":
            it = AsyncDataSetIterator(it, queueSize=cfg["queue"],
                                      device=dev)
            need(it.ring.kind == "native", "records (b): the native ring "
                 "did not run")
        torch.cuda.synchronize()
        t = time.perf_counter()
        net.fit(it, epochs=cfg["epochs"])
        torch.cuda.synchronize()
        fit_s[name] = time.perf_counter() - t
    it.close()
    need(state_equal(nets["fit"], nets["fit_async"])
         and nets["fit"].score() == nets["fit_async"].score(),
         "records (b): fit through the ring differs from fit through the "
         "records' iterator")
    acc = nets["fit_async"].evaluate(iters["test"]).accuracy()
    need(acc >= cfg["min_accuracy"], f"records (b): test accuracy {acc} < "
         f"{cfg['min_accuracy']}")
    out.update({"epochs": cfg["epochs"],
                "fit_images_per_s": cfg["epochs"] * cfg["train"]
                / fit_s["fit_async"],
                "fit_unwrapped_images_per_s": cfg["epochs"] * cfg["train"]
                / fit_s["fit"],
                "phase14b_fit_images_per_s": phase14b["fit_images_per_s"],
                "test_accuracy": acc})
    log("fine-tune (b) records: " + json.dumps(out))
    return out


def _write_wavs(root, cfg):
    """`clips` seeded one-second tones with noise, as 16-bit WAV files
    under root/<label>/ (the stdlib wave module)."""
    import os
    import wave

    rng = np.random.RandomState(SEED + 17)
    n = cfg["rate"] * cfg["seconds"]
    t = np.arange(n) / cfg["rate"]
    for i in range(cfg["clips"]):
        label = "hi" if i % 2 else "lo"
        os.makedirs(os.path.join(root, label), exist_ok=True)
        f0 = rng.uniform(1500, 4000) if i % 2 else rng.uniform(100, 800)
        sig = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(n)
        with wave.open(os.path.join(root, label, f"{i:02d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(cfg["rate"])
            w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2")
                          .tobytes())


def augment_audio_leg(dev, acfg, ucfg):
    """17(c): the augmentation pipeline as an iterator's preprocessor
    runs it (a DataSet of host f32 features in, the card's tensor out)
    and on config 4's bf16 batch already on the card, timed; under the
    card's draws replayed on the CPU, equal to the CPU's; MFCCs of the
    numpy clips WavFileRecordReader reads, on the card, timed, against
    the CPU."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.data import (
        DataSet, FlipImageTransform, ImageAugmentationPreProcessor,
        MFCCTransform, PipelineImageTransform, RandomCropTransform,
        RotateImageTransform, WavFileRecordReader,
    )

    n, B = RESNET_TIMED["image"], RESNET_TIMED["batch"]
    x = np.random.RandomState(SEED).rand(B, 3, n, n).astype(np.float32)
    labels = np.zeros((B, RESNET_TIMED["classes"]), np.float32)

    def pre(device):
        return ImageAugmentationPreProcessor(PipelineImageTransform(
            FlipImageTransform(0.5),
            RandomCropTransform(n, n, pad=acfg["pad"]),
            RotateImageTransform(acfg["angle"])), seed=SEED, device=device)

    card = pre(dev)
    out = card.preProcess(DataSet(x, labels)).getFeatures()
    need(out.device.type == "cuda" and out.shape == (B, 3, n, n),
         f"augment (c): preProcess of host features gave "
         f"{tuple(out.shape)} on {out.device}, not the card")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    host_ms = time_ms(lambda: card.preProcess(DataSet(x, labels)),
                      acfg["reps"], flush)
    xb = torch.from_numpy(x).to(dev, torch.bfloat16)
    aug_ms = time_ms(lambda: card.run(xb), acfg["reps"], flush)
    rows = acfg["check_rows"]
    xs = x[:rows]
    got = card.preProcess(DataSet(xs, labels[:rows])).getFeatures()
    draws = [tuple(t.cpu() for t in d) if isinstance(d, tuple) else d.cpu()
             for d in card.lastDraws]
    want = pre("cpu").run(xs, draws=draws)
    nhwc = torch.from_numpy(xs).permute(0, 2, 3, 1)
    t0, t1 = card.transform.transforms[:2]
    fc_card = t1.applyDrawn(t0.applyDrawn(nhwc.to(dev), card.lastDraws[0]),
                            card.lastDraws[1])
    fc_cpu = t1.applyDrawn(t0.applyDrawn(nhwc, draws[0]), draws[1])
    need(torch.equal(fc_card.cpu(), fc_cpu), "augment (c): flip and crop "
         "on the card differ from the CPU under the same draws")
    rot_err = float((got.cpu() - want).abs().max())
    need(rot_err <= ROTATE_ATOL, f"augment (c): the pipeline on the card is "
         f"{rot_err:.3e} from the CPU's (band {ROTATE_ATOL})")
    with tempfile.TemporaryDirectory() as d:
        _write_wavs(d, ucfg)
        rr = WavFileRecordReader(length=ucfg["rate"] * ucfg["seconds"])
        rr.initialize(d)
        clips = []
        while rr.hasNext():
            clips.append(rr.next()[0])
    wav = np.stack(clips)
    mfcc = MFCCTransform(numCoeffs=ucfg["coeffs"], sampleRate=ucfg["rate"],
                         device=dev)
    mfcc_ms = time_ms(lambda: mfcc.apply(wav), ucfg["reps"], flush)
    del flush
    m_card = mfcc.apply(wav)
    need(m_card.device.type == "cuda", f"audio (c): MFCCs of the reader's "
         f"clips landed on {m_card.device}, not the card")
    m_cpu = MFCCTransform(numCoeffs=ucfg["coeffs"], sampleRate=ucfg["rate"],
                          device="cpu").apply(wav)
    m_card = m_card.cpu()
    m_err = float((m_card - m_cpu).abs().max() / m_cpu.abs().max())
    need(m_err <= AUDIO_REL_MAX, f"audio (c): MFCCs on the card are "
         f"{m_err:.3e} of the max-abs from the CPU's (band {AUDIO_REL_MAX})")
    out = {"augment_ms_a_batch": aug_ms, "augment_batch": list(xb.shape),
           "preprocess_host_f32_ms_a_batch": host_ms,
           "augment_rotation_max_abs_vs_cpu": rot_err,
           "mfcc_ms": mfcc_ms, "mfcc_shape": list(m_card.shape),
           "mfcc_rel_max_abs_vs_cpu": m_err, "clips": len(clips),
           "sample_rate": rr.sampleRate}
    log("fine-tune (c) augmentation and audio: " + json.dumps(out))
    return out


def transfer_leg(dev, cfg, phase15b):
    """17(d): EditLastLayerOthersFrozen on zoo VGG16: freeze through fc2,
    a new 5-class XAVIER head under FineTuneConfiguration, 20 steps; the
    frozen params bitwise unchanged; TransferLearningHelper's featurized
    fit lands on the same head."""
    import torch

    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import (
        DenseLayer, FineTuneConfiguration, Nesterovs, OutputLayer,
        TransferLearning, TransferLearningHelper, WeightInit,
    )
    from deeplearning4j_tpu_torch.zoo import VGG16

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    n, B, C = cfg["image"], cfg["batch"], cfg["classes"]
    cut = cfg["frozen_till"]
    t = time.perf_counter()
    orig = VGG16(numClasses=1000, seed=SEED, inputShape=(3, n, n),
                 device=dev).init()
    need(isinstance(orig.layers[cut], DenseLayer)
         and orig.layers[cut].nOut == 4096
         and isinstance(orig.layers[cut + 1], OutputLayer),
         f"transfer (d): layer {cut} is not fc2")
    ftc = (FineTuneConfiguration.Builder().updater(Nesterovs(cfg["lr"]))
           .seed(cfg["seed"]).build())
    net = (TransferLearning.Builder(orig).fineTuneConfiguration(ftc)
           .setFeatureExtractor(cut)
           .nOutReplace(cut + 1, C, WeightInit.XAVIER).build())
    del orig
    build_s = time.perf_counter() - t
    helper_net = net.clone()
    rng = np.random.RandomState(SEED + 4)
    x = torch.from_numpy(rng.rand(B, 3, n, n).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.eye(C, dtype=np.float32)[
        rng.randint(0, C, B)]).to(dev)
    frozen = [{k: t.detach().clone() for k, t in p.items()}
              for p in net._params[:cut + 1]]
    losses, step_s = fit_timed(net, x, y, cfg["steps"])
    need(losses[-1] < losses[0], f"transfer (d): loss did not fall: "
         f"{losses[0]} -> {losses[-1]}")
    need(all(torch.equal(t, net._params[i][k])
             for i, p in enumerate(frozen) for k, t in p.items()),
         "transfer (d): a frozen parameter moved")
    helper = TransferLearningHelper(helper_net, frozenTill=cut)
    feat = helper.featurize(DataSet(x, y))
    for _ in range(cfg["steps"]):
        helper.fitFeaturized(feat)
    head = {k: rel_l2(helper_net._params[cut + 1][k].detach(),
                      net._params[cut + 1][k].detach())
            for k in net._params[cut + 1]}
    need(max(head.values()) <= TRANSFER_RTOL, f"transfer (d): the "
         f"featurized fit's head is {head} from the frozen fit's")
    med = float(np.median(step_s[2:]))
    out = {"build_s": build_s, "losses": losses,
           "step_ms_median_3_on": med * 1e3, "images_per_s": B / med,
           "phase15b_vgg16_bf16_b64_step_ms": phase15b[
               "step_ms_median_3_on"],
           "featurized_head_rel_l2": head,
           "trainable_params": sum(t.numel()
                                   for t in net._params[cut + 1].values()),
           "frozen_params": sum(t.numel() for p in frozen
                                for t in p.values())}
    log("fine-tune (d) VGG16 transfer: " + json.dumps(out))
    del net, helper_net, helper, frozen
    return out


def graph_transfer_leg(dev, cfg, phase7):
    """17(e): phase 7's encoder through TransferLearning.GraphBuilder with
    the lower six blocks frozen: K1 12 launches a step, K2 and K3 six; the
    frozen params bitwise unchanged."""
    import torch

    from deeplearning4j_tpu_torch.nn import ComputationGraph, TransferLearning
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    orig = ComputationGraph(bert_encoder_conf(BERT_BASE), device=dev).init()
    net = (TransferLearning.GraphBuilder(orig)
           .setFeatureExtractor(cfg["cut"]).build())
    del orig
    frozen = {n: {k: t.detach().clone() for k, t in net._params[n].items()}
              for n in net._layer_names
              if getattr(net.conf.nodes[n].payload, "frozen", False)}
    x, y = encoder_batch(BERT_BASE, dev)
    need(not x.requires_grad, "graph transfer (e): the input requires grad")
    fit_timed(net, x, y, 1)                  # warm up outside the count
    torch.cuda.synchronize()
    tfa.reset_launches()
    losses, step_s = fit_timed(net, x, y, cfg["steps"])
    launches = {"K1": tfa.flash_fwd.launches, "K2": tfa.flash_bwd_dq.launches,
                "K3": tfa.flash_bwd_dkv.launches,
                "plain": tfa.flash_fwd_plain.launches
                + tfa.flash_bwd_dq_plain.launches
                + tfa.flash_bwd_dkv_plain.launches}
    L, s = BERT_BASE["layers"], cfg["steps"]
    want = {"K1": L * s, "K2": cfg["trainable_blocks"] * s,
            "K3": cfg["trainable_blocks"] * s, "plain": 0}
    need(launches == want, f"graph transfer (e): launches {launches}, "
         f"expected {want}")
    need(all(torch.equal(t, net._params[n][k]) for n, p in frozen.items()
             for k, t in p.items()), "graph transfer (e): a frozen "
         "parameter moved")
    need(all(math.isfinite(v) for v in losses),
         f"graph transfer (e): non-finite loss {losses}")
    med = float(np.median(step_s[1:]))
    out = {"launches": launches,
           "launches_per_step": {k: v / s for k, v in launches.items()},
           "losses": losses, "step_ms_median_2_on": med * 1e3,
           "phase7_step_ms": phase7["step_ms_median_3_to_20"],
           "frozen_layers": len(frozen)}
    log("fine-tune (e) encoder transfer: " + json.dumps(out))
    del net, frozen
    return out


def solvers_leg(dev, cfg):
    """17(f): config 2's MLP under LBFGS, CONJUGATE_GRADIENT and
    LINE_GRADIENT_DESCENT (the loss must fall); Newton-CG held to the
    reference test's bar on its regression subject."""
    import torch

    from deeplearning4j_tpu_torch.nn import (
        DenseLayer, MultiLayerNetwork, NeuralNetConfiguration, OutputLayer,
        Sgd,
    )

    c = SD_MLP
    rs = np.random.RandomState(c["seed"])
    x = torch.from_numpy(rs.rand(c["batch"], c["inputs"])
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(np.eye(c["classes"], dtype=np.float32)[
        rs.randint(0, c["classes"], c["batch"])]).to(dev)
    out = {}
    for algo in ("LBFGS", "CONJUGATE_GRADIENT", "LINE_GRADIENT_DESCENT"):
        conf = (NeuralNetConfiguration.Builder().seed(SEED)
                .optimizationAlgo(algo).list()
                .layer(DenseLayer(nIn=c["inputs"], nOut=c["hidden"],
                                  activation="relu"))
                .layer(OutputLayer(nOut=c["classes"], activation="softmax",
                                   lossFunction="MCXENT")).build())
        net = MultiLayerNetwork(conf, device=dev).init()
        losses, step_s = fit_timed(net, x, y, cfg["steps"])
        need(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
             f"solvers (f): {algo}'s loss did not fall: {losses}")
        out[algo] = {"losses": losses,
                     "steps_per_s": 1.0 / float(np.median(step_s[2:]))}

    rng = np.random.RandomState(1)                 # _lsq_data(seed=1)
    X = rng.randn(64, 5).astype("float32")
    W = rng.randn(5, 2).astype("float32")
    Y = X @ W + 0.01 * rng.randn(64, 2).astype("float32")
    Xd, Yd = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)

    def regression(algo):
        b = NeuralNetConfiguration.Builder().seed(3).updater(Sgd(0.1))
        if algo is not None:
            b = b.optimizationAlgo(algo)
        net = MultiLayerNetwork(
            b.list().layer(DenseLayer(nIn=5, nOut=2, activation="identity"))
            .layer(OutputLayer(nOut=2, activation="identity",
                               lossFunction="MSE")).build(),
            device=dev).init()
        for _ in range(cfg["newton_steps"]):
            net.fit(Xd, Yd)
        return net.score()

    cg, sgd = regression("CONJUGATE_GRADIENT"), regression(None)
    need(cg < cfg["newton_bar"] and cg < sgd, f"solvers (f): Newton-CG "
         f"{cg} after {cfg['newton_steps']} steps (bar {cfg['newton_bar']}, "
         f"fixed-step SGD {sgd})")
    out["newton_cg_lsq"] = {"loss": cg, "sgd_loss": sgd,
                            "steps": cfg["newton_steps"]}
    log("fine-tune (f) solvers: " + json.dumps(out))
    return out


def graph_logits(net, params, x):
    """A one-output graph's logits (its output layer's pre-activation)
    under `params`, in inference mode, as f64."""
    import torch

    from deeplearning4j_tpu_torch.nn.multilayer import strip_carries

    with torch.no_grad():
        _, pre, _ = net._run_graph(params, strip_carries(net._states),
                                   net._coerce_inputs(x), False, None, None)
    return pre[net.conf.networkOutputs[0]].double()


def int8_leg(dev, cfg):
    """17(g): config 4's ResNet-50 inference with int8 weights against
    its bf16 forward; the int8 logits on the card against the CPU's."""
    import torch

    from deeplearning4j_tpu_torch.nn.quantize import (
        dequantize_params, int8_infer_fn, param_bytes,
    )

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    net = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC")
    x, _ = resnet_batch(dev, RESNET_TIMED, RESNET_TIMED["batch"])
    infer, qp, sc = int8_infer_fn(net)
    o16 = graph_logits(net, net._params, x)
    o8 = graph_logits(net, dequantize_params(qp, sc, torch.bfloat16), x)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    bf16_ms = time_ms(lambda: net._forward_infer(net._params, x),
                      cfg["reps"], flush)
    int8_ms = time_ms(lambda: infer(qp, sc, x), cfg["reps"], flush)
    deq_ms = time_ms(lambda: dequantize_params(qp, sc, torch.bfloat16),
                     cfg["reps"], flush)
    del flush
    # the int8 call's device work, and the dequantize's alone, traced:
    # the call writes every weight out in bf16 before the forward reads it
    deq_launches, deq_busy = traced_device_work(
        lambda: dequantize_params(qp, sc, torch.bfloat16))
    call_launches, call_busy = traced_device_work(lambda: infer(qp, sc, x))
    bf16_params = [{k: t.to(torch.bfloat16) for k, t in p.items()}
                   for p in net._params.values()]
    top1 = float((o8.argmax(1) == o16.argmax(1)).float().mean())
    diff = float((o8 - o16).abs().max())
    need(math.isfinite(diff), "int8 (g): non-finite logits")
    int8_bytes = param_bytes(qp)
    del net, qp, sc, x
    torch.cuda.empty_cache()
    # the card's int8 forward against the CPU's on a few rows, in f64:
    # ResNet-50's f32 forward itself differs across the two by ~1.5e-5
    # (rel L2 of the logits), so f32 would test the convolutions' sums
    rows = cfg["check_rows"]
    card = resnet_net(dev, RESNET_TIMED, "DOUBLE", dataFormat="NHWC")
    cpu = resnet_net("cpu", RESNET_TIMED, "DOUBLE", dataFormat="NHWC")
    xs = torch.from_numpy(np.random.RandomState(SEED).rand(
        rows, RESNET_TIMED["image"], RESNET_TIMED["image"], 3))
    _, cq, cs = int8_infer_fn(card)
    _, pq_, ps = int8_infer_fn(cpu)
    need(all(torch.equal(a.cpu(), b) for p, q in zip(cq.values(),
                                                     pq_.values())
             for a, b in zip(p.values(), q.values())),
         "int8 (g): the card's q differs from the CPU's")
    got = graph_logits(card, dequantize_params(cq, cs, torch.float64),
                       xs.to(dev)).cpu()
    want = graph_logits(cpu, dequantize_params(pq_, ps, torch.float64), xs)
    err = rel_l2(got, want)
    need(err <= INT8_REL_L2, f"int8 (g): the card's int8 logits are "
         f"{err:.3e} (rel L2) from the CPU's (band {INT8_REL_L2})")
    out = {"batch": RESNET_TIMED["batch"], "int8_ms": int8_ms,
           "bf16_ms": bf16_ms, "int8_param_bytes": int8_bytes,
           "bf16_param_bytes": param_bytes(bf16_params),
           "dequantize_ms": deq_ms,
           "traced": {"int8_call_launches": call_launches,
                      "int8_call_device_ms": call_busy,
                      "dequantize_launches": deq_launches,
                      "dequantize_device_ms": deq_busy,
                      "dequantize_share_of_int8_call":
                          deq_busy / call_busy},
           "logits_max_abs_diff_vs_bf16": diff,
           "logits_max_abs_bf16": float(o16.abs().max()),
           "top1_agreement": top1,
           "card_vs_cpu_int8_rel_l2_f64": err}
    log("fine-tune (g) int8: " + json.dumps(out))
    del card, cpu
    return out


def report_leg(stats_log):
    """17(h): render_report over (a)'s StatsListener log, and UIServer's
    page and JSON on localhost."""
    from deeplearning4j_tpu_torch.optimize import UIServer, render_report

    doc = render_report(stats_log)
    need("score vs iteration" in doc and "<polyline" in doc,
         "report (h): the report has no score chart")
    ui = UIServer().attach(stats_log).start(port=0)
    try:
        codes = {}
        for route in ("/", "/train/0/updates?since=0"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ui.port}{route}", timeout=30) as r:
                codes[route] = r.status
                body = r.read()
        records = json.loads(body)["records"]
    finally:
        ui.stop()
    need(all(c == 200 for c in codes.values()), f"report (h): {codes}")
    need(len(records) > 0, "report (h): the updates route returned nothing")
    out = {"codes": codes, "report_bytes": len(doc),
           "records": len(records)}
    log("fine-tune (h) report: " + json.dumps(out))
    return out


def fine_tune_phase(dev, phase7, runtime, zoo):
    """Phase 17: the data and fine-tuning runtime, legs (a)-(h)."""
    import os
    import tempfile

    import torch

    t = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        stats_log = os.path.join(d, "stats.jsonl")
        out["prefetch"] = prefetch_leg(dev, PREFETCH, runtime["resnet"],
                                       stats_log)
        gc.collect()
        torch.cuda.empty_cache()
        out["records"] = records_leg(dev, RECORDS, runtime["lenet"])
        out["augment_audio"] = augment_audio_leg(dev, AUGMENT, AUDIO)
        gc.collect()
        torch.cuda.empty_cache()
        out["transfer"] = transfer_leg(dev, VGG_TRANSFER, zoo["vgg16"])
        gc.collect()
        torch.cuda.empty_cache()
        out["graph_transfer"] = graph_transfer_leg(dev, ENCODER_TRANSFER,
                                                   phase7)
        gc.collect()
        torch.cuda.empty_cache()
        out["solvers"] = solvers_leg(dev, SOLVERS)
        out["int8"] = int8_leg(dev, INT8)
        gc.collect()
        torch.cuda.empty_cache()
        out["report"] = report_leg(stats_log)
    out["seconds"] = time.perf_counter() - t
    log(f"phase 17: {out['seconds']:.1f} s")
    return out


def kernel_launches():
    """The launch counts of K1-K5 (phase 12 must add none)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa
    from deeplearning4j_tpu_torch.ops import paged_attention as tpa

    return {"K1": tfa.flash_fwd.launches, "K2": tfa.flash_bwd_dq.launches,
            "K3": tfa.flash_bwd_dkv.launches,
            "K4": tpa.paged_flash_decode.launches,
            "K5": tpa.paged_flash_prefill.launches}


def char_rnn_phase(dev):
    """Phase 12: (a) parity, (b) train, (c) serve; K1-K5 launch no time."""
    before = kernel_launches()
    parity = char_rnn_parity(dev, CHAR_RNN)
    net, train = char_rnn_train(dev, CHAR_RNN)
    serve = char_rnn_serve(dev, net, CHAR_RNN, CHAR_SERVE)
    need(kernel_launches() == before, "char-rnn: a hand-written kernel "
         f"launched: {before} -> {kernel_launches()}")
    return {"parity": parity, "train": train, "serve": serve}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.ops import _kernels  # the checkout's port

    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"device: {kind} ({torch.cuda.device_count()} visible), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t = time.perf_counter()
    _kernels.library()
    log(f"build: {time.perf_counter() - t:.2f} s in all, one nvcc per "
        "source started together (sm_90a): " + ", ".join(
            f"{n} {s:.2f} s" for n, s in sorted(_kernels.BUILD_SECONDS.items())))

    rows = check_kernels(dev)
    result = serve_and_check(dev, GPT2_SMALL)
    flash_rows = check_flash(dev)
    train = train_and_check(dev, BERT_BASE)
    torch.cuda.empty_cache()
    lenet = lenet_and_check(dev, LENET)
    parity = resnet_parity(dev, RESNET_PARITY)
    net, x, y, timed = resnet_timed(dev, RESNET_TIMED)
    trace = resnet_trace(net, x, y, RESNET_TIMED["traced_steps"],
                         timed["step_ms_median_3_on"])
    del net, x, y
    torch.cuda.empty_cache()
    nd4j = nd4j_and_check(dev)
    torch.cuda.empty_cache()
    sd_mlp_res = samediff_mlp(dev, SD_MLP)
    sd_enc = samediff_encoder(dev, BERT_BASE, train)
    torch.cuda.empty_cache()
    rnn = char_rnn_phase(dev)
    torch.cuda.empty_cache()
    dp = data_parallel_phase(dev, RESNET_TIMED, timed)
    torch.cuda.empty_cache()
    runtime = runtime_phase(dev, train, timed, trace)
    zoo = cnn_zoo_phase(dev, timed)
    torch.cuda.empty_cache()
    catalogue = catalogue_phase(dev)
    torch.cuda.empty_cache()
    fine = fine_tune_phase(dev, train, runtime, zoo)
    launches = result["serve"]["launches"]
    kernels = []
    for key, name, line in (("decode", "paged_flash_decode", 465),
                            ("prefill", "paged_flash_prefill", 580)):
        r = rows[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"deeplearning4j_tpu/ops/pallas_attention.py:{line}",
            "launches": launches[key], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    split = result["decode_step"]
    log(f"decode step: host {split['host_ms']:.3f} ms, device "
        f"{split['device_ms']:.3f} ms ({100 * split['device_share']:.1f} % "
        f"of the host time); K4 x {GPT2_SMALL['n_layers']} layers "
        f"{split['k4_ms_x_layers']:.3f} ms at the step's lengths, "
        f"{rows['decode']['ms'] * GPT2_SMALL['n_layers']:.3f} ms at "
        "phase 3's")
    step_ms = train["step_ms_median_3_to_20"]
    attention_ms = 0.0
    for key, name, line in (("K1", "flash_fwd", 48),
                            ("K2", "flash_bwd_dq", 107),
                            ("K3", "flash_bwd_dkv", 151)):
        r = flash_rows[(key, "float32")]   # the trainer runs f32
        attention_ms += r["ms"] * train["launches_per_step"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"deeplearning4j_tpu/ops/pallas_attention.py:{line}",
            "launches": train["launches"][key] + sd_enc["launches"][key]
            + runtime["encoder"]["launches"][key]
            + fine["graph_transfer"]["launches"][key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"train step {step_ms:.2f} ms median; K1-K3 at their L2-cold "
        f"times x launches per step = {attention_ms:.2f} ms "
        f"({100 * attention_ms / step_ms:.1f} % of the step)")
    split = ", ".join(f"{c} {100 * v:.1f} %"
                      for c, v in trace["device_share"].items())
    log(f"CNNs on {card}: LeNet b{LENET['batch']} f32 "
        f"{lenet['images_per_s']:.0f} images/s; ResNet-50 f32 parity "
        f"worst gradient {parity['f32_worst_grad_rel_l2_to_f64']:.2e} from "
        f"f64; ResNet-50 bf16 NHWC b{RESNET_TIMED['batch']} "
        f"{timed['step_ms_median_3_on']:.2f} ms a step, "
        f"{timed['images_per_s']:.1f} images/s, "
        f"{timed['max_memory_allocated_bytes'] / 2**30:.2f} GiB peak, "
        f"{100 * timed['share_of_bf16_dense_peak']:.2f} % of the bf16 "
        f"dense peak; traced device time: {split}; device idle "
        f"{100 * trace['device_idle_share_of_untraced_step']:.1f} % of "
        f"an untraced step ({100 * trace['device_idle_share_of_traced_wall']:.1f}"
        " % of the traced wall)")
    log(f"ND4J and SameDiff on {card}: gemm {GEMM_N}^2 f32 "
        f"{nd4j['gemm_4096_ms']:.3f} ms ({nd4j['gemm_tflops']:.1f} TFLOP/s); "
        f"SameDiff MLP b{SD_MLP['batch']} fit "
        f"{sd_mlp_res['fit_steps_per_s']:.0f} steps/s, fitSteps("
        f"{SD_MLP['steps']}) {sd_mlp_res['fitSteps_steps_per_s']:.0f} "
        f"steps/s, device busy "
        f"{100 * sd_mlp_res['device_busy_share_of_traced_wall']:.1f} % of a "
        f"traced step; SameDiff encoder "
        f"{sd_enc['step_ms_median_3_to_20']:.2f} ms a step, "
        f"{sd_enc['tokens_per_s']:.0f} tokens/s, "
        f"{sd_enc['max_memory_allocated_bytes'] / 2**30:.2f} GiB peak, "
        f"beside phase 7's ComputationGraph {step_ms:.2f} ms, "
        f"{train['tokens_per_s']:.0f} tokens/s, "
        f"{train['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    rt, rs = rnn["train"], rnn["serve"]
    ab = rs["admission"]
    log(f"char-RNN (config 3) on {card}: bf16 b{CHAR_RNN['batch']} x "
        f"{CHAR_RNN['seq']} chars, tBPTT {CHAR_RNN['tbptt']}: fit "
        f"{rt['fit_ms_median_3_to_20']:.2f} ms median, "
        f"{rt['chars_per_s']:.0f} chars/s, "
        f"{rt['max_memory_allocated_bytes'] / 2**20:.1f} MiB peak "
        f"({rt['peak_over_before_fit_bytes'] / 2**20:.1f} MiB over what "
        "was allocated before the fits), "
        f"{rt['kernels_per_window']:.0f} kernels a window, device busy "
        f"{100 * rt['device_busy_share_of_traced_wall']:.1f} % of a traced "
        f"fit; served over :generate: TTFT p50 "
        f"{1e3 * rs['ttft_p50_s']:.2f} ms, max {1e3 * rs['ttft_max_s']:.2f} "
        f"ms, {rs['rows_per_s']:.0f} rows/s, bucket-8 step host "
        f"{rs['step_bucket8']['host_ms']:.3f} ms / device "
        f"{rs['step_bucket8']['device_ms']:.3f} ms; dispatches step "
        f"{ab['step']['dispatches']} vs gang {ab['gang']['dispatches']} "
        f"(refills {ab['step']['refills']} vs {ab['gang']['refills']})")
    log(f"data-parallel (config 5) on {card}: ResNet-50 bf16 NHWC b"
        f"{RESNET_TIMED['batch']} a rank through SharedTrainingMaster, "
        f"NCCL world {dp['modes']['dense']['world']}: " + "; ".join(
            f"{m} {r['step_ms_median_3_on']:.2f} ms a step "
            f"({r['step_over_phase9b']:.3f}x phase 9(b)), "
            f"{r['images_per_s']:.1f} images/s, "
            f"{r['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
            f"{r['collectives_per_step']} collectives and "
            f"{r['payload_bytes_per_step']} payload / "
            f"{r['wire_bytes_per_step']} wire bytes a step (bill "
            f"{r['bill_wire_bytes']})" for m, r in dp["modes"].items())
        + f"; two gloo ranks on the card: dense {dp['gloo']['dense_max_abs_vs_fit']:.2e}"
        f" from fit, int8 grid excess {dp['gloo']['int8_grid_excess']:.3f}")
    ra, rb, rc = (runtime["resnet"], runtime["lenet"],
                  runtime["encoder"])
    sp = {n: float(np.median(v)) for n, v in ra["spans_ms"].items()}
    log(f"training runtime on {card}: config 4 fitDataSet(k="
        f"{RUNTIME_RESNET['k']}) {ra['fit_dataset_ms_per_step']:.2f} ms a "
        f"step vs fit(iterator) {ra['fit_ms_per_step']:.2f} ms and phase "
        f"9(b)'s resident batch {ra['phase9b_ms_per_step']:.2f} ms; spans "
        "(median ms) " + ", ".join(f"{n} {v:.2f}" for n, v in sorted(
            sp.items())) + f"; traced block idle "
        f"{100 * ra['traced_block_device_idle_share']:.1f} % (phase 9(c) "
        f"{100 * ra['phase9c_device_idle_share_of_traced_wall']:.1f} %); "
        f"checkpoint {ra['checkpoint_bytes'] / 2**20:.1f} MiB, save "
        f"{ra['checkpoint_save_s']:.2f} s, load "
        f"{ra['checkpoint_load_s']:.2f} s; config 1 LeNet early stopping "
        f"{rb['early_stopping_epochs']} epochs, test accuracy "
        f"{rb['test_accuracy']:.4f}, fit {rb['fit_images_per_s']:.0f} vs "
        f"fitDataSet(k={RUNTIME_LENET['k']}) "
        f"{rb['fit_dataset_images_per_s']:.0f} images/s; encoder "
        f"fitDataSet(k={RUNTIME_ENCODER['k']}) "
        f"{rc['fit_dataset_ms_per_step']:.2f} ms a step vs fit "
        f"{rc['fit_ms_per_step']:.2f} ms (phase 7 "
        f"{rc['phase7_ms_per_step']:.2f} ms)")
    zp, zv, za, zu, zs, zr, zg = (zoo[k] for k in (
        "parity", "vgg16", "alexnet", "unet", "s2d", "remat", "blocks"))

    def split(r):
        return ", ".join(f"{k} {100 * v:.1f} %" for k, v in
                         r["trace"]["device_share"].items())

    log(f"CNN zoo on {card}: parity f64 card/CPU worst gradient "
        + ", ".join(f"{m} {v['f64_grad']:.2e}" for m, v in zp.items())
        + "; " + "; ".join(
            f"{m} bf16 NHWC b{r['batch']} {r['step_ms_median_3_on']:.2f} ms "
            f"a step, {r['images_per_s']:.1f} images/s, "
            f"{r['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
            f"{100 * r['share_of_bf16_dense_peak']:.2f} % of the bf16 peak "
            f"(device: {split(r)})" for m, r in (("VGG16", zv),
                                                 ("AlexNet", za)))
        + f"; UNet b{ZOO_UNET['batch']} {zu['step_ms_median_3_on']:.2f} ms, "
        f"{zu['images_per_s']:.1f} images/s, "
        f"{zu['max_memory_allocated_bytes'] / 2**30:.2f} GiB; s2d stem "
        f"logits rel {zs['logits_rel_l2']:.2e}, "
        f"{zs['step_ms_median_3_on']:.2f} ms a step vs 9(b) "
        f"{zs['phase9b_step_ms_median_3_on']:.2f}; save_conv_outputs "
        f"{zr['save_conv_outputs']['step_ms_median_3_on']:.2f} ms, "
        f"{zr['save_conv_outputs']['max_memory_allocated_bytes'] / 2**30:.2f}"
        f" GiB vs stock {zr['stock']['step_ms_median_3_on']:.2f} ms, "
        f"{zr['stock']['max_memory_allocated_bytes'] / 2**30:.2f} GiB "
        "(bitwise); SimpleCNN fitDataSet(4) "
        f"{zg['fit_dataset_ms_per_step']:.2f} ms a step vs fit "
        f"{zg['fit_ms_per_step']:.2f} (bitwise)")
    cp, ci, cg, cv = (catalogue[k] for k in ("parity", "imdb", "graph",
                                             "vae"))
    log(f"layer catalogue on {card}: parity f64 card/CPU worst gradient "
        f"{max(v['f64_grad'] for v in cp.values()):.2e} over {len(cp)} "
        f"cases; sequence classifier b{IMDB['batch']} x {IMDB['seq']} "
        f"{ci['step_ms_median_3_to_20']:.2f} ms a step, "
        f"{ci['valid_tokens_per_s']:.0f} valid tokens/s, "
        f"{ci['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
        f"{ci['kernels_per_step']:.0f} kernels a step, device busy "
        f"{100 * ci['device_busy_share_of_traced_wall']:.1f} %, loss "
        f"{ci['loss_first_mean']:.4f} -> {ci['loss_last_mean']:.4f}, "
        "fitDataSet(4) and the embedding gradient bitwise; graph logits "
        f"{cg['logits_max_abs_vs_mln']:.2e} from the MLN's; VAE pretrain "
        f"{cv['pretrain_steps_per_s']:.0f} steps/s, negative ELBO "
        f"{cv['neg_elbo_first20_mean']:.2f} -> "
        f"{cv['neg_elbo_last20_mean']:.2f}")
    fa, fb, fc, fd, fe, ff, fg = (fine[k] for k in (
        "prefetch", "records", "augment_audio", "transfer",
        "graph_transfer", "solvers", "int8"))
    ms = fa["ms_per_step"]
    log(f"data and fine-tuning runtime on {card}: (a) config 4 through the "
        f"{fa['ring']['kind']} ring (queue {fa['ring']['queue']}, slot "
        f"{fa['ring']['slot_bytes']} bytes, {fa['ring']['host_copies_a_batch']}"
        f" host copies a batch): fit {ms['fit_async']:.2f} ms a step vs "
        f"unwrapped {ms['fit']:.2f}, fitDataSet(4) "
        f"{ms['fit_dataset_async']:.2f} vs unwrapped "
        f"{ms['fit_dataset']:.2f} (phase 14(a): fit "
        f"{fa['phase14a_ms_per_step']['fit']:.2f}, fitDataSet(4) "
        f"{fa['phase14a_ms_per_step']['fit_dataset']:.2f}), bitwise; a "
        f"traced prefetched block idle "
        f"{100 * fa['traced_block_device_idle_share']:.1f} % (14(a) "
        f"{100 * fa['phase14a_traced_block_device_idle_share']:.1f} %); "
        f"(b) config 1 from CSV: {fb['parser']} parse "
        f"{fb['train']['parse_mb_per_s']:.1f} MB/s, fit "
        f"{fb['fit_images_per_s']:.0f} images/s through the ring vs "
        f"{fb['fit_unwrapped_images_per_s']:.0f} unwrapped (14(b) "
        f"{fb['phase14b_fit_images_per_s']:.0f}), test accuracy "
        f"{fb['test_accuracy']:.4f}; (c) augmentation "
        f"{fc['augment_ms_a_batch']:.3f} ms a b{RESNET_TIMED['batch']} bf16 "
        f"batch on the card, {fc['preprocess_host_f32_ms_a_batch']:.3f} ms "
        f"a host f32 batch through preProcess, MFCC {fc['mfcc_ms']:.3f} ms for {fc['clips']} clips; (d) "
        f"VGG16 frozen through fc2 {fd['step_ms_median_3_on']:.2f} ms a "
        f"b{VGG_TRANSFER['batch']} f32 step (15(b) whole bf16 b64 "
        f"{fd['phase15b_vgg16_bf16_b64_step_ms']:.2f}); (e) encoder, six "
        f"blocks frozen, {fe['step_ms_median_2_on']:.2f} ms a step (phase 7 "
        f"{fe['phase7_step_ms']:.2f}), K1/K2/K3 a step "
        + "/".join(f"{fe['launches_per_step'][k]:.0f}"
                   for k in ("K1", "K2", "K3"))
        + "; (f) " + ", ".join(f"{a} {ff[a]['steps_per_s']:.1f} steps/s"
                                for a in ("LBFGS", "CONJUGATE_GRADIENT",
                                          "LINE_GRADIENT_DESCENT"))
        + f", Newton-CG lsq {ff['newton_cg_lsq']['loss']:.2e}; (g) int8 "
        f"{fg['int8_ms']:.2f} ms vs bf16 {fg['bf16_ms']:.2f} ms, the "
        f"dequantize {fg['dequantize_ms']:.2f} ms of it ("
        f"{100 * fg['traced']['dequantize_share_of_int8_call']:.1f} % of "
        f"a traced call's device time), "
        f"{fg['int8_param_bytes']} vs {fg['bf16_param_bytes']} bytes, top-1 "
        f"agreement {fg['top1_agreement']:.3f}; phase 17 "
        f"{fine['seconds']:.1f} s")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
