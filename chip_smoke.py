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
   plain version not at all (the scheduler replays one captured decode
   graph per bucket; prefill stays eager). Reports time
   to first token and decode tokens/s. Then one bucket-8 decode_paged step at the burst's lengths,
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
   sequences/s, tokens/s and peak device memory; (d) the same encoder
   with activationCheckpointing(True) from (b)'s initial weights, 20
   steps: K1 24 launches a step (each block's forward again in the
   backward), K2 and K3 12, the losses within REMAT_LOSS_REL of (b)'s
   (bitwise expected; the line says which), step ms and peak memory
   beside (b)'s.

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
   mean and residual bitwise); every loss finite. Then the ZeRO legs,
   weight_update="sharded" dense and int8: losses and final params
   bitwise the replicated run of their mode (at world 1 the flat view is
   a reshape and Nesterovs elementwise), and one more recorded step's
   reduce-scatter and all-gather wire bytes equal to
   dp_weight_update_bytes' collective_wire_bytes over the eligible
   leaves (dense) or its whole exchange to the port's wire bill (int8),
   the updater state a rank holds. (b) two ranks on the
   one card over gloo (NCCL refuses two ranks on one device; gloo stages
   CUDA tensors through the host, the backend's own staging, asked for
   here): first an all-reduce of a CUDA tensor, which must succeed; then
   parallel.dryrun.sync_bn_leg (a small BN CNN, f32): dense dp 2 with BN
   synchronised over the ranks within SYNC_BN_F32_ATOL of fit on the
   combined batch, and an int8 step's exchange within its grid (|mean -
   exact mean| <= scale/254) of the exact mean of the ranks' gradients.
   Threshold is not in this leg.
   A probe of gloo's reduce-scatter and all-gather of CUDA tensors: when
   both run, the sharded dense leg (bn_cnn, 3 steps) within
   SYNC_BN_F32_ATOL of the replicated one, then four gloo ranks on the
   card run the hierarchical exchange (node groups of 2, both hop-1
   encodings, 3 steps): every rank's params equal, the losses finite,
   the last step's exchange wire bytes equal to the port's bill; when
   not, the line says which was refused and why. (c) with two or more cards only: (a)'s four modes
   and the two sharded legs at dp = min(cards, 4) on NCCL ranks, and with
   four the hierarchical exchange (node groups of 2), images/s a rank
   and the scaling against (a); on one card the line says it did not
   run. K1-K5 launch no time in this phase.

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
   EarlyStoppingTrainer (2 epochs, DataSetLossCalculator on the test
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
   (f) 9(b)'s net for 5 steps stock, with
   checkpointPolicy="save_conv_outputs" and with
   activationCheckpointing(True): losses and final state bitwise equal;
   peak memory and step ms of each, the peak ratios; PAR06's prediction
   for the per-layer net over its measured peak (24(b)'s measure: from
   before the build, the batch added) within PAR06_BAND. (g) zoo SimpleCNN (its
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
   and host copies a batch. (b) the first 20,000 of 14(b)'s 60,000
   training digits and its 10,000 test digits (synthetic, flagged),
   written as CSVs of 785 integer columns;
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
18. one-shot serving and the fleet — zoo ResNet50 at phase 9(b)'s widths
   (224^2 NHWC, 1000 classes, bf16 over f32 masters, random weights from
   seed 0, eval mode). (a) ModelHost.register with batch buckets 1, 8,
   32, 128, queueLimit 1024, maxWaitMs 2: one warm forward a bucket
   (seconds each). (b) request sizes (3, 5, 2, 7, 4, 1, 6) and (3, 2, 1,
   2) coalesced by a thread-less MicroBatcher into one dispatch each
   (buckets 32 and 8), in order and reversed: every answer bitwise
   ParallelInference.output of the same rows padded to the same bucket;
   each row alone at bucket 1 against it (max-abs, bf16 steps floored
   at 1/256 of the max, top-1) and its logits at bucket 1 against those
   at the coalesced bucket (max-abs over their max-abs, top-1), held to
   CROSS_BUCKET_ULPS / CROSS_BUCKET_LOGIT_REL / CROSS_BUCKET_TOP1: a
   stated deviation, cuDNN choosing its algorithms by batch size. (c)
   InferenceServer
   on localhost: 4 concurrent :predict requests of 1-2 images answer 200
   with [n, 1000]; an unknown name 404, a body without "instances" 400;
   a queueLimit=1 LeNet whose dispatch a chaos wedge holds: deadlineMs
   1 answers 504, the next request 429, the wedged one 200 once
   released. (d) in process through host.submit: the serial rate (a
   bucket-(1,) ParallelInference under a lock, 24 requests), then
   loadgen.run_open_loop of 512 one-image requests at max(200, 8 x
   serial) req/s and 16 clients, serial and batched: req/s, p50/p99 ms,
   occupancy, the speedup; zero errors, zero cold dispatches, batched
   not below serial; the host split of one bucket-128 dispatch
   (assemble, copy in, forward, copy out; median of 5). (e) the net
   registered int8: top-1 against bf16 on 256 rows (bar 0.99), weight
   bytes, ms a bucket-128 dispatch beside bf16 (median of 5). (f) two
   rolling swaps (to seed 1's weights and back) during an open loop of
   256 requests: zero errors and cold dispatches, every answer bitwise
   one of the versions' oracles at a bucket. (g) two ModelHost replicas
   behind FleetRouter serving ResNet-50 and zoo LeNet: the hot-model skew
   scenario at 80/20 (256 requests); a chaos plan wedges r0's dispatch
   (4 serial requests route around it to r1), then raises on r0's next
   two (two failovers, r0's breaker opens and no request reaches it);
   quarantine and three probes readmit r0; no client error; swap_all
   under an open loop of 128 requests with zero errors and cold
   dispatches; config 3's char-RNN through register_sequence and
   swap_all (every answer changes with the weights).
19. the rest of SameDiff and ONNX import — f32, TF32 off, cuDNN
   deterministic. (a) zoo ResNet50 (224^2, 1000 classes, seed 0, BN
   running statistics drawn from seed 0, eval mode) written as an NCHW
   ONNX model by tests/_torch_onnx_models.py through the port's wire
   codec (Conv, BatchNormalization, Relu, Add, MaxPool,
   GlobalAveragePool, Flatten, Gemm, Softmax), read by
   OnnxGraphMapper.importGraph into a SameDiff on the card;
   validate_samediff reports no error; output at batch 32 against the
   net's own eval-mode logits within ONNX_LOGIT_REL of their max-abs,
   top-1 equal; the model's bytes, the import seconds, and the imported
   and native forwards' median ms (host wall to a synchronize, 10) and
   kernels a forward (torch.profiler). (b) config 1's LeNet (B 64,
   28^2x1 NHWC, conv 5x5 20 -> max-pool 2 -> conv 5x5 50 -> max-pool 2
   -> dense 500 relu -> dense 10, softmax cross-entropy, Adam(1e-3), on
   seeded synthetic digits) as a SameDiff through sd.cnn with the zoo
   LeNet's weights: the first step's loss (rel 1e-5) and gradients (rel
   L2 1e-4) against the MultiLayerNetwork, neither regularised; 20 fit
   steps (steps/s, kernels a step); 5 steps + save(saveUpdaterState) +
   load(loadUpdaterState) + 5 steps bitwise 10 unbroken steps. (c) a
   bounded whileLoop trains under fitSteps with no predicate fetch (a
   step also under set_sync_debug_mode("error")); an unbounded loop's
   trip count and fetches; each ifCond branch; all within 1e-5 of the
   CPU's max-abs; a dropout body draws anew each iteration. (d) every op
   of SameDiff's rest once on the card against the port on the CPU:
   cnn, rnn (lstmLayer at config 3's widths, 77 -> 256, B 32, T 20, with
   its gradient), image and segment ops within rtol 1e-5 and an atol of
   1e-6 of each tensor's max-abs;
   linalg by reconstructions and invariants within 1e-4; fft within
   1e-5 of the max-abs; NMS and bitwise (uint16/uint32 widened, uint64
   and/or/xor) exactly; betainc within 1e-5 + 1e-5 |value| of scipy on
   the host and rtol 1e-5 of the CPU's f32.
20. detection, the rest of the zoo, the 3-d CNNs and model import —
   TF32 off, cuDNN deterministic. (a) zoo YOLO2 at its COCO defaults
   (416^2, 80 classes, 5 COCO anchors, Adam(1e-3)): the first step at
   batch 2 on the card against the CPU in f64 (loss 1e-10, gradients
   1e-9 rel L2) and in f32 against the CPU's f64 (PARITY_F32_*); the f64
   nets' detections (YoloUtils, threshold 0.5, NMS 0.4) equal on 4
   images; then bf16 NHWC b16 on synthetic boxes (flagged; 1-8 an
   image): 20 fit steps (median ms of 3-20, images/s, peak memory, the
   loss falls), kernels a step and the traced split by kind (conv, BN,
   leaky relu, pooling, s2d/merge, the Yolo2 loss, update, casts); save
   (no updater state), restore and output bitwise. (b) Darknet19,
   TinyYOLO, SqueezeNet, Xception, InceptionResNetV1, FaceNetNN4Small2
   and NASNet at their default inputs, bf16 NHWC, b32 (b16 for Xception
   and NASNet), 5 steps; the first step's f32 loss at b2 against the
   CPU's f64. (c) C3D at its published widths (8 3x3x3 convs 64-512, 5
   max pools, fc 4096 x 2, 101 classes), 3x16x112^2 clips, bf16, b8, 10
   steps (clips/s, peak memory, kernels a step); then each 3-d layer
   alone (Deconvolution3D, Upsampling3D, Cropping3D, ZeroPadding3D, avg
   pooling with explicit pads and "same", GlobalPoolingLayer, PReLULayer)
   in f32 with its gradients against the CPU within rtol 1e-5 and an
   atol of 1e-6 of each tensor's max-abs. (d) from
   tests/_torch_keras_models.py, with no h5py and no tensorflow: (i)
   keras.applications.ResNet50's config (224^2, 1000 classes) imported
   with seeded weights, its b32 eval logits against zoo ResNet50 holding
   the same arrays through the pretrained mapping within
   IMPORT_LOGIT_REL of their max-abs, top-1 equal; (ii) a 2-block
   MultiHeadAttention encoder at BERT-base widths (768, 12 x 64, T 512,
   B 8): K1 launches once a block and its plain version never; the
   output against the same import on the CPU within IMPORT_LOGIT_REL.
   (e) phase 19(a)'s ResNet-50 as a frozen GraphDef written by
   tests/_torch_tf_models.py through tf_wire, imported by importFrozenTF
   into a SameDiff on the card: b32 logits within IMPORT_LOGIT_REL of
   the native net's, top-1 equal; the graph's bytes, import seconds, ms
   and kernels a forward beside 19(a)'s.
21. word vectors and nearest neighbours — f32, TF32 off, over a seeded
   topic-structured Zipf corpus (synthetic, standing in for text8: the
   71,290 words text8 keeps at -min-count 5, 4 M of its 17 M tokens).
   Every card-vs-CPU check takes the same steps under one set of draws
   (recorded on the CPU, replayed on the card) and holds the tables
   within W2V_PARITY_REL of their max-abs. (a) Word2Vec CBOW at
   word2vec.c's demo-word.sh text8 widths (200-d, window 8, negative 25;
   batch 1024, one epoch): scan s, words/s, steps/s, kernels a step and
   the busy share of 20 traced steps, peak memory; the loss falls; the
   probe words' 10 neighbours in their topic at a stated share; 3 steps
   card vs CPU. (b) skip-gram NS, skip-gram and CBOW HS (code length),
   PV-DBOW, PV-DM and inferVector on a 150,000-token prefix: steps/s and
   3 steps (50 for inferVector) card vs CPU. (c) FastText at the
   skipgram CLI's defaults (100-d, ws 5, neg 5, n-grams 3-6, 2,000,000
   buckets, lr 0.05), one epoch on a prefix, and supervised at
   wordNgrams 2: steps/s, peak memory, 3 steps card vs CPU. (d) GloVe at
   Pennington et al.'s settings (300-d, window 10, xMax 100, alpha 0.75,
   AdaGrad 0.05) on a prefix: co-occurrence s and entries, steps/s, the
   loss falls, 3 steps card vs CPU. (e) (a)'s model through
   WordVectorSerializer (binary exact, text within %.6g), into
   WeightInitEmbedding (bitwise) and through CnnSentenceDataSetIterator
   into a Kim (2014) CNN at DL4J's CnnSentenceClassificationExample
   widths (3/4/5 x 100 maps, max over time, dropout 0.5, 2 classes, 256
   words, b32): 20 ComputationGraph.fit steps, ms and sentences/s, the
   loss falls. (f) over (a)'s 71,290 x 200 vectors: k-means (k 100,
   100 iterations at most: iterations, host flag reads, ms, inertia;
   assignments equal the CPU's under its first centre), LSH (index ms,
   recall@10 against brute force), a VPTree over 20,000 of them (kNN
   equal to brute force) and NearestNeighborsServer over HTTP (/status,
   20 /knn and 20 /knnnew equal to brute force, a 400, a 404, p50 ms).
   (g) DeepWalk on a seeded graph at BlogCatalog's size (10,312
   vertices, 333,983 edges; 128-d, window 10, walks of 40, 1 a vertex):
   walk s, words/s; t-SNE (tiled) of (a)'s 10,000 most frequent words,
   perplexity 30, 1,000 iterations, lr 200: ms an iteration, the KL
   falls; exact vs tiled (knnK N-1) and card vs CPU at N 2,000 within
   TSNE_GATE_REL of the max-abs after 10 iterations, reported after 50.
   No hand-written kernel launches.
22. RL, search and the profiler (f32, TF32 off). (a) The Nature DQN
   (Mnih et al. 2015: 84x84x4, conv 32 8x8/4, 64 4x4/2, 64 3x3/1, dense
   512, 6 actions, RMSProp 2.5e-4, b32, gamma 0.99, frame skip 4, TD
   error clipped to 1, double DQN) through QLearningDiscreteConv on a
   seeded 84x84 catch game written here (ALE does not ship), replay
   5,000, learning from step 500, target sync every 1,000, 1,000 steps
   (cut from 3,000, then 2,000, to keep the whole smoke near 850 s):
   env steps/s, learn steps/s and the median learn step, kernels a learn
   step and the busy share of a traced block, host->device copies and
   bytes and device->host copies a learn step (from (e)'s trace), peak
   memory; card vs CPU from the same weights, replay and RandomState
   draws: Q-values, the first TD targets and gradients within
   RL_PARITY_REL of each tensor's max-abs, the parameters after 3
   RMSProp steps reported. (b) A3C and async n-step Q on CartPole-v1
   dynamics written here (Barto, Sutton & Anderson 1983) at the
   reference's defaults (hidden 32, 8 environments, nStep 8), A3C also
   at 64: rollouts/s, env steps/s, ms an update, kernels a rollout and
   its update, the busy share; one update from one fixed rollout card
   vs CPU from the card's parameters and Adam state, within
   RL_PARITY_REL. (c) The reference tests' ChainMDP(5) policies (dense
   DQN 2,500 steps, A3C and n-step Q 12,000) score 10.0 in play. (d)
   Arbiter over LeNet at DL4J's LeNetMNIST widths on seeded synthetic
   28x28 digits (6,000 / 1,000, b64, one epoch a candidate): random
   search (6), a 2x2 grid (dense 250/500 x conv 20/32), genetic search
   (population 6, 2 generations), a ComputationGraphSpace search and a
   MaxTimeCondition stop: seconds a candidate, the best score; every
   candidate completes but one made invalid on purpose (a 5x5 kernel
   over a 2x2 input), whose error must be the convolution's shape check.
   (e) On (a)'s trainer: OpProfiler sections (first call, steady) beside
   CUDA-event time, a section under set_enabled(False) records nothing,
   trace() writes a file with kernels and the annotate region,
   compiled_cost of the b32 Q forward equals the analytic 598,147,072
   flops, mfu of the learn step, the spans exported as Chrome trace and
   JSONL read back. No hand-written kernel launches.
23. capture, warm start and tuning (runtime.aot's CUDA graphs, TF32
   off). (a) Phase 4's model (GPT-2-small widths, page 16, bf16, 513
   pages): warm() captures one decode graph per slot bucket (1/2/4/8);
   the 8-request burst served eager and replayed (TTFT, decode tokens/s,
   K4 12 launches a decode step in both, zero captures and uncaptured
   dispatches in the burst by CompileWatch); a swap_sequence re-captures
   one graph a bucket, counted; the bucket-8 decode_paged step captured
   and timed both ways by phase 4's method (host wall to a synchronize,
   device by CUDA events behind a spin kernel), the replayed logits
   bitwise the eager ones and a replay adding K4 once a layer; phase
   12(c)'s carry-slot bucket-8 step the same way (config 3's widths,
   random weights). (b) Phase 18's
   ResNet-50 bf16 eval behind ParallelInference at buckets 1/8/32/128,
   precompiled (one graph a bucket): b1 and b128 output() host ms eager
   vs replayed (median of 10), outputs bitwise within a bucket, zero
   cold dispatches. (c) Eager against captured training (precompile,
   then fit), losses and final parameters and state bitwise, step ms,
   rate and peak memory of each: (i) phase 9(b)'s ResNet-50 (224^2, 1000
   classes, bf16, NHWC, Nesterovs(0.1, 0.9), b128; the features fed as
   f32) 20 steps, (ii) phase 8's LeNet with Adam on a step schedule
   (device-scalar hyperparameters) 20 steps, (iii) phase 7's encoder 20
   steps with K1-K3 replayed 12 times a step each, (iv) VGG16 bf16 b64
   with dropout on, 5 steps (the replayed masks are the eager ones), (v)
   (i)'s net with activationCheckpointing(True), 5 steps (the per-layer
   recomputes inside the graph), no capture after warm().
   (d) autotune of LeNet b64 (the bf16 subject) and ResNet-50 b128,
   scored by the captured step's CUDA-event wall: each candidate's
   bytes, wall and verdict, the skipped ("identical") knobs, the
   winners; a second process's autotune and warm_start from the
   persisted record sweep nothing and capture nothing. (e) ResNet-50
   b128 bf16: train_step_floor, the counted bytes (compiled_cost's rule,
   op by op), their ratio, the bins summing to the count,
   static_memory_terms against max_memory_allocated; the dtype audit
   clean under the compute tail and flagging the wide one.
24. the static analysis tier (analysis/): (a) validate_or_raise on every
   zoo model at the card's total memory: 0 errors, its seconds, and not
   one byte allocated on the card; (b) PAR06's predicted high-water
   mark beside torch.cuda.max_memory_allocated for 9(b)'s ResNet-50
   bf16 b128 and YOLO2 bf16 b16 at 416^2, over 3 eager fit steps and
   over a capture plus 3 replayed steps, and SimpleCNN f32 b64 at 64²
   eager (TF32 off: PAR06 counts its convolutions' cuDNN workspaces):
   the prediction within
   PAR06_BAND of the measurement (never more than 10 % below it), and a
   batch PAR06 says will not fit raising ConfigValidationError at
   init(validate=True, hbm_gb=...) before any allocation; (c)
   init(validate=True) then 3 LeNet fit steps bitwise the losses and
   parameters of init(); (d) a seeded chaos soak over the paged
   :generate path (K4/K5, counts reset before it) and the one-shot
   :predict tier, one fault of each kind on each serving seam (corrupt
   at sequence.step included) and raises and a corrupt path on the
   aot.disk_* seams, every failed request classified (a 500 names the
   injected raise that failed it, no raise fails more requests than
   share its work, a 400 is the prompt the corrupt fault pushed out of
   the vocabulary, a failed fleet.submit raised ChaosError, every answer
   well formed), then a counting soak with no fault armed whose requests
   all answer 200, whose rows equal the network's own output and whose
   tokens are the f32 reference's greedy choices, whose coverage_gaps
   over the serving seams are empty, and torch.cuda.synchronize() after;
   (e) the collective signatures of a dense and an int8 step on two gloo
   ranks on the card, against compression_contract, the port's wire
   bill and the bytes the trainer reports, the record-only step leaving
   the params as they were and equal on both ranks (over NCCL too with
   2 or more cards).
25. mesh axes — the model, sequence and pipeline axes through
   deeplearning4j_tpu_torch.parallel, ranks launched on the card under
   gloo. A probe checks the values gloo's ppermute (batch_isend_irecv)
   of CUDA tensors returns, on two ranks of their own (its failure may
   close the connection or abort a rank: an abort counts as a refusal
   only when the rank's error output shows gloo's transport error);
   the two ranks of (a), (b) and (d) first check gloo's all-reduce,
   all-gather and all-to-all of CUDA tensors likewise. Each outcome is
   logged. A leg whose collective came back wrong, or raised, is named
   NOT RUN with the probe's words and runs over NCCL with two (four)
   cards instead; a probe whose ranks die otherwise, or time out,
   fails the phase; the port never stages a collective through the
   host itself. (a) zoo ResNet-50 at 224², 1000 classes, bf16 NHWC over
   f32 masters, Nesterovs(0.1, 0.9), shard_params(min_shard_size=4096)
   on {data: 1, model: 2}, batch 32 (9(b)'s 128 cut: each rank carries
   the whole batch's activations plus the gathered blocks), 3 steps,
   TF32 off, deterministic cuDNN, timed; then the same net at batch 4
   in f64 and in f32, 3 steps each. Held: the replicated leaves and BN
   running statistics bitwise equal on the two ranks in every run, the
   placed net's whole params at the start bitwise one rank's, and in
   f64, after steps 1 and 3, the sharded and the replicated leaves
   within MESH_TP_F64_BAND of the update from one rank's same steps;
   read: the same distances in f32 and in bf16, and a control (one
   rank's bf16 steps under cuDNN's benchmarked algorithms against its
   deterministic ones); collectives and bytes a step from recording(),
   step ms, peak memory a rank, one rank's step ms. (b) phase 7's
   encoder at BERT-base widths on {model: 2} (min_shard_size 512, so
   the biases shard too), 3 steps: K1/K2/K3 12 launches a step a rank,
   each K1 on 6 heads, the losses within MESH_TP_BERT_BAND of 7(b)'s.
   (c) dryrun_multichip(4, legs=("tp",)) on four ranks on the card.
   (d) ring_attention (causal and not) and ulysses_attention on
   {seq: 2} at B 2, H 12, T 8192, D 64 f32, forward and backward, and
   the ring on {seq: 1} in this process, each against one-rank
   dot_product_attention at rtol 2e-4, atol 2e-5. (e) PipelineParallel
   on {pipe: 4}: Dense(1024 -> 4096), 8 x Dense(4096, tanh), a 1000-way
   softmax head, Sgd(0.05), batch 512 in 8 microbatches, 3 steps, the
   params within rtol 1e-4, atol 1e-5 of 3 steps of fit on one rank;
   the bubble as (S - 1) x the median forward tick over the step.
26. distributed linear algebra (deeplearning4j_tpu_torch.linalg), TF32
   off, f32: (a) at world 1 the reference's CANONICAL_LINALG_PLANS at
   their widths: gemm_32k (32768^3, 2-D SUMMA on {data: 1, model: 1},
   the blocks the operands themselves) with 256 sampled rows of C
   against f64, its event time (median of 2) and TFLOP/s beside the
   67 TFLOP/s bound; then one 2^23 x 1024 matrix (34.4 GB) from a
   seeded generator on the card: gram_tall against a chunked f64 Gram,
   lstsq_tall (b = A x + noise) against the f64 normal-equation solve
   and converged; its columns scaled in place by powers of two (8, 4, 2,
   1 for 16 columns each, then 1/16: exact), rsvd_tall (rank 64,
   oversample 8) and pca on its first 2^21 rows against the top 64 of
   the f64 Gram's / covariance's eigendecomposition (values and
   projector). Each routine's measured peak (max_memory_allocated over
   what was allocated before it, plus the inputs its bill counts) over
   linalg/plan.py's world-1 bill within LINALG_PEAK_BAND, each bar
   (LINALG_BARS) stated before the first run. (b) over NCCL, one rank a
   card: with 4 cards the 2-D SUMMA on {data: 2, model: 2}, with 2 or
   more the 1-D ring and the tall family (at 2^23 x 1024, each rank
   generating its rows) on {data: cards}: the same oracles (f64
   partials all-reduced), each routine run under verify_program
   (executed: COL01 across the ranks, COL06 on the ring) against its
   linalg_contract, the recorded wire bytes equal to the plan's, the
   GEMMs' record-only counts equal to the executed ones; with fewer
   cards a line names the legs not run and the cards they need. (c) at
   world 1 sharded k-means (2^18 x 32, k 8), LSH's distributed
   projection (2^16 x 64, 16 bits x 8 tables) and DeepWalk's mesh Gram
   and similarity products (1024 vertices, 128 wide), each against its
   unsharded path. No hand-written kernel runs in phase 26.

The last stdout line is {"ok": true, "device": {...}}; before it come the
nvidia-smi line and one JSON line {"kernels": [...]} (K1-K5; K1-K3's
launches are phase 7's plus phase 11's plus phase 14(c)'s plus phase
17(e)'s plus phase 23(c)(iii)'s replays plus both ranks' of phase
25(b), and K1's plus phase 20(d)(ii)'s; K4's phase 4's plus phase 23(a)'s two bursts, replays
included, plus phase 24(d)'s soak, and K5's phase 4's plus 24(d)'s;
phases 8-10, 12, 13, 14(a),
14(b), 15, 16, 17 but (e), 18, 19, 20 but (d)(ii), 21, 22, 25 but
(b) and 26 run no hand-written kernel: conv, dense and the recurrent products
are cuDNN/cuBLAS calls, as the reference leaves them to XLA, LRN,
dropout, the shape layers, the word-vector, k-means and t-SNE steps,
the actor-critic trunks and ring and Ulysses attention (the reference's
are plain XLA too) are torch tensor ops, and the parallel exchanges are
NCCL's or gloo's collectives).
"""

from __future__ import annotations

import gc
import json
import math
import os
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
    del net
    gc.collect()
    torch.cuda.empty_cache()
    result["remat"] = encoder_remat(dev, cfg, x, y, result)
    return result


#: 7(d): the remat leg's losses against 7(b)'s, relative (bitwise is
#: expected: K1's recompute is deterministic; the leg reports which)
REMAT_LOSS_REL = 1e-6


def encoder_remat(dev, cfg, x, y, stock):
    """7(d): phase 7's encoder with activationCheckpointing(True), from
    7(b)'s initial weights (the same seed), TRAIN_STEPS fit steps: the
    losses against 7(b)'s, K1 launched twice a step a block (its forward
    again in the backward), K2 and K3 once; step ms and peak memory
    beside 7(b)'s."""
    import torch

    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    conf = bert_encoder_conf(cfg)
    conf.activationCheckpointing = True
    net = ComputationGraph(conf).init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tfa.reset_launches()
    losses, step_s = fit_timed(net, x, y, TRAIN_STEPS)
    launches = {"K1": tfa.flash_fwd.launches, "K2": tfa.flash_bwd_dq.launches,
                "K3": tfa.flash_bwd_dkv.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    n_att = cfg["layers"] * TRAIN_STEPS
    need(launches == {"K1": 2 * n_att, "K2": n_att, "K3": n_att},
         f"train (d): remat launches {launches}, expected K1 {2 * n_att}, "
         f"K2 and K3 {n_att}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, stock["losses"]))
    need(rel <= REMAT_LOSS_REL, f"train (d): remat losses {rel:.3e} (rel) "
         f"from 7(b)'s, bar {REMAT_LOSS_REL}")
    med = float(np.median(step_s[2:]))
    out = {"losses": losses, "bitwise_7b": losses == stock["losses"],
           "max_rel_to_7b": rel, "step_ms_median_3_to_20": med * 1e3,
           "step_over_7b": med * 1e3 / stock["step_ms_median_3_to_20"],
           "max_memory_allocated_bytes": peak,
           "peak_over_7b": peak / stock["max_memory_allocated_bytes"],
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items()}}
    log("train (d) remat: " + json.dumps(out))
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def resnet_net(dev, cfg, dtype="FLOAT", seed=SEED, **kw):
    from deeplearning4j_tpu_torch.nn import DataType
    from deeplearning4j_tpu_torch.zoo import ResNet50

    return ResNet50(numClasses=cfg["classes"], seed=seed,
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


#: 13(a)/(c): the ZeRO legs, (gradient_compression, weight_update), held
#: to the replicated run of their mode
DP_SHARDED = ((None, "sharded"), ("int8", "sharded"))
#: 13(c) with four or more cards: the hierarchical leg (node groups of 2)
DP_HIER_GROUP = 2


def dp_master(net, group, mode, weight_update="replicated"):
    """SharedTrainingMaster over `group` in `mode`, as a user builds it."""
    from deeplearning4j_tpu_torch.parallel import (
        FixedThresholdAlgorithm, SharedTrainingMaster,
    )

    if mode == "int8":
        return SharedTrainingMaster(net, mesh=group,
                                    weight_update=weight_update)
    if mode == "threshold":
        return SharedTrainingMaster(
            net, mesh=group, encodingCapacity=DP_CAPACITY,
            thresholdAlgorithm=FixedThresholdAlgorithm(DP_TAU))
    if mode == "hierarchical":
        return SharedTrainingMaster(
            net, mesh=group, encodingCapacity=DP_CAPACITY,
            compressionGroupSize=DP_HIER_GROUP,
            thresholdAlgorithm=FixedThresholdAlgorithm(DP_TAU))
    return SharedTrainingMaster(net, mesh=group, gradient_compression=mode,
                                weight_update=weight_update)


def zero_bytes(master, sites):
    """A sharded step's recorded ZeRO collectives against their bills:
    the reduce-scatter and all-gather wire bytes against
    dp_weight_update_bytes' collective_wire_bytes over the eligible
    leaves (dense), the whole gradient exchange's (its max all-reduces
    of the scales, the lanes and the all-gather) against the port's
    wire bill (int8); payloads beside them."""
    from deeplearning4j_tpu_torch.analysis.collectives import port_wire_bill
    from deeplearning4j_tpu_torch.parallel import dp_weight_update_bytes

    z, net = master._zero, master.net
    sizes = [t.numel() for p in net._params for t in p.values()] \
        if isinstance(net._params, list) else \
        [t.numel() for p in net._params.values() for t in p.values()]
    elig = sum(n for n in sizes if z.eligible(n))
    zero = [s for s in sites if s.op in ("reduce_scatter", "all_gather",
                                         "int8_lane_scatter")]
    out = {"eligible_bytes": 4 * elig,
           "sites": {s.op: {"payload": s.payload_bytes, "wire": s.wire_bytes}
                     for s in zero}}
    if z.compression is None:
        bill = dp_weight_update_bytes(4 * elig, z.dp, sharded=True)
        got = sum(s.wire_bytes for s in zero)
        need(got == bill["collective_wire_bytes"]
             and out["sites"]["reduce_scatter"]["payload"] == 4 * elig,
             f"dp sharded: wire {got} B vs the bill "
             f"{bill['collective_wire_bytes']} B, payload "
             f"{out['sites']['reduce_scatter']['payload']} vs {4 * elig}")
        out["bill_collective_wire_bytes"] = bill["collective_wire_bytes"]
    else:
        grad = [s for s in sites if s.op in ("int8_lane_scatter",
                                             "int8_lane_sum", "all_gather")
                or (s.op == "all_reduce" and s.reduce == "max")]
        got = sum(s.wire_bytes for s in grad)
        bill = port_wire_bill(z.compression, sizes, z.dp, sharded=True,
                              min_shard_size=z.min_shard_size)
        need(got == bill, f"dp {z.compression} sharded: wire {got} B vs "
             f"the port's bill {bill} B")
        out["bill_wire_bytes"] = bill
    out["wire_bytes"] = got
    return out


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


def dp_train(dev, cfg, group, x, y, mode, plain_ms=None, check=True,
             weight_update="replicated"):
    """One mode of phase 13 on this rank: a fresh config-5 net, 20 steps
    through SharedTrainingMaster on the global batch (x, y); the first
    exchange held to its plain version when `check`. Returns the
    measurements (images/s of the global batch, and a rank's share); a
    sharded leg adds one recorded step's ZeRO bytes against the bill
    and the final params' digest."""
    import hashlib

    import torch

    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.parallel import collectives as coll
    from deeplearning4j_tpu_torch.parallel import compressed_wire_bytes

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    net = resnet_net(dev, cfg, "BFLOAT16", dataFormat="NHWC",
                     updater=Nesterovs(0.1, 0.9))
    master = dp_master(net, group, mode, weight_update)
    sharded = weight_update == "sharded"
    seen = first_exchange(master) \
        if check and mode is not None and not sharded else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = fit_timed(net, x, y, cfg["steps"], trainer=master)
    peak = torch.cuda.max_memory_allocated(dev)
    digest = hashlib.sha256(net.params().tensor().cpu().numpy().tobytes()
                            ).hexdigest()
    zero = None
    if sharded:
        with coll.recording() as rec:
            master.fit(x, y)
        zero = zero_bytes(master, rec.sites)
    name = (mode or "dense") + ("+sharded" if sharded else "")
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
           "bill_dense_wire_bytes": bill["dense_wire_bytes"],
           "params_sha256": digest}
    if zero is not None:
        out["zero"] = zero
        out["updater_state_bytes_per_rank"] = \
            master._zero.per_rank_state_bytes(net._upd_states)
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
    legs = [(mode, "replicated") for mode in DP_MODES] + list(DP_SHARDED)
    if world >= 2 * DP_HIER_GROUP:
        legs.append(("hierarchical", "replicated"))
    return [dp_train(device, cfg, group, x, y, mode, check=False,
                     weight_update=wu) for mode, wu in legs]


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
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
           for k, v in out.items()}
    # the ZeRO update needs a reduce-scatter and an all-gather of CUDA
    # tensors; the port never stages them through the host itself
    probe = {}
    for op, call in (("reduce_scatter", lambda: dist.reduce_scatter_tensor(
                          torch.empty(2, device=device),
                          torch.ones(2 * world, device=device))),
                     ("all_gather", lambda: dist.all_gather(
                          [torch.empty(2, device=device)
                           for _ in range(world)],
                          torch.ones(2, device=device)))):
        try:
            call()
            probe[op] = "ok"
        except (RuntimeError, ValueError) as e:
            probe[op] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    out["zero_probe"] = probe
    if all(v == "ok" for v in probe.values()):
        out["sharded"] = gloo_sharded_leg(rank, world, device)
    return out


def gloo_hier_rank(rank, world, device, steps=3):
    """13(b)'s hierarchical leg (launched: four gloo ranks on the one
    card): parallel.dryrun's bn_cnn in node groups of 2, both hop-1
    encodings, `steps` steps, the last recorded: the params' digest (every
    rank's must agree), the losses, and the step's exchange wire bytes
    (its intra and group sites) beside the port's bill."""
    import hashlib

    from deeplearning4j_tpu_torch.analysis.collectives import port_wire_bill
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel import collectives as coll
    from deeplearning4j_tpu_torch.parallel.dryrun import (
        bn_cnn, bn_cnn_batch, params_vector,
    )
    from deeplearning4j_tpu_torch.parallel.trainer import _leaves

    x, y = bn_cnn_batch(8 * world)
    out = {}
    for intra in ("block_int8", None):
        net = bn_cnn(device, "FLOAT", lr=0.05)
        pw = ParallelWrapper(net, gradient_compression="hierarchical",
                             compressionGroupSize=DP_HIER_GROUP,
                             intraGroupCompression=intra, threshold=1e-3,
                             encodingCapacity=1.0)
        losses = []
        for i in range(steps):
            if i == steps - 1:
                with coll.recording() as rec:
                    pw.fit(x, y)
            else:
                pw.fit(x, y)
            losses.append(net.score())
        sizes = [t.numel() for t in _leaves(net._params)]
        out[intra or "dense"] = {
            "losses": losses,
            "params_sha256": hashlib.sha256(
                params_vector(net).tobytes()).hexdigest(),
            "wire_bytes": sum(s.wire_bytes for s in rec.sites
                              if s.axes != ("data",)),
            "bill": port_wire_bill("hierarchical", sizes, world,
                                   capacity=1.0, group_size=DP_HIER_GROUP,
                                   intra_mode=intra)}
    return out


def gloo_sharded_leg(rank, world, device, steps=3):
    """13(b)'s sharded dense leg, when gloo takes both collectives of
    CUDA tensors: parallel.dryrun's bn_cnn, dense, replicated and
    sharded (every leaf of 64 elements or more), `steps` steps each: the
    largest |difference| of the params."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.dryrun import (
        bn_cnn, bn_cnn_batch, params_vector,
    )

    x, y = bn_cnn_batch(8 * world)
    params = {}
    for wu in ("replicated", "sharded"):
        net = bn_cnn(device, "FLOAT", lr=0.05)
        pw = ParallelWrapper(net, weight_update=wu, min_shard_size=64)
        for _ in range(steps):
            pw.fit(x, y)
        params[wu] = params_vector(net)
    return {"max_abs": float(np.abs(params["sharded"]
                                    - params["replicated"]).max())}


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
        for mode, wu in [(m, "replicated") for m in DP_MODES] \
                + list(DP_SHARDED):
            r = dp_train(dev, cfg, group, x, y, mode,
                         plain_ms=phase9b["step_ms_median_3_on"],
                         weight_update=wu)
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
    for mode, _ in DP_SHARDED:
        rep, sh = modes[mode or "dense"], modes[(mode or "dense")
                                                + "+sharded"]
        need(sh["losses"] == rep["losses"]
             and sh["params_sha256"] == rep["params_sha256"],
             f"dp (a) {sh['mode']}: not bitwise the replicated run at "
             f"world 1: losses {sh['losses'][:3]} vs {rep['losses'][:3]}")
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
            "collectives_per_dense_step": r0["comm"]["collectives"],
            "zero_probe": r0["zero_probe"]}
    if "sharded" in r0:
        worst = max(r["sharded"]["max_abs"] for r in ranks)
        need(worst <= SYNC_BN_F32_ATOL, f"dp (b): sharded dense dp 2 "
             f"{worst:.3e} from replicated (bar {SYNC_BN_F32_ATOL})")
        gloo["sharded_max_abs_vs_replicated"] = worst
        # the 2-hop exchange needs four ranks: node groups of 2
        t4 = time.perf_counter()
        hier = launch(gloo_hier_rank, 2 * DP_HIER_GROUP, device=one_card,
                      backend="gloo", timeout=600)
        for intra, h in hier[0].items():
            need(all(r[intra]["params_sha256"] == h["params_sha256"]
                     for r in hier), f"dp (b) hierarchical {intra}: the "
                 "ranks' params differ")
            need(all(math.isfinite(v) for r in hier
                     for v in r[intra]["losses"]),
                 f"dp (b) hierarchical {intra}: non-finite loss")
            need(all(r[intra]["wire_bytes"] == r[intra]["bill"]
                     for r in hier), f"dp (b) hierarchical {intra}: wire "
                 f"{h['wire_bytes']} B vs the port's bill {h['bill']} B")
        gloo["hierarchical"] = {k: {kk: vv for kk, vv in v.items()
                                    if kk != "params_sha256"}
                                for k, v in hier[0].items()}
        gloo["hierarchical_seconds"] = time.perf_counter() - t4
        zero_note = ("the sharded dense leg and, on four ranks, the "
                     "hierarchical leg ran")
    else:
        zero_note = ("the sharded and hierarchical legs left out: gloo "
                     "refused " + "; ".join(
                         f"{k} ({v})" for k, v in r0["zero_probe"].items()
                         if v != "ok")
                     + " of CUDA tensors, and the port never stages a "
                     "collective through the host itself")
    log("dp (b): ranks on one card over gloo (gloo stages CUDA tensors "
        "through the host: the backend's own staging, asked for here; "
        f"threshold mode left out of this leg; {zero_note}): "
        + json.dumps(gloo))

    cards = torch.cuda.device_count()
    multi = None
    if cards >= 2:
        dp = min(cards, 4)
        res = launch(dp_nccl_rank, dp, device=dev, timeout=900,
                     args=(cfg,))
        multi = {}
        for i, r in enumerate(res[0]):
            need(all(math.isfinite(v) for rr in res for v in rr[i]["losses"]),
                 f"dp (c) {r['mode']}: non-finite loss")
            if r["mode"] in modes:
                r["scaling_vs_world1"] = (r["images_per_s"]
                                          / modes[r["mode"]]["images_per_s"])
            multi[r["mode"]] = {k: v for k, v in r.items() if k != "losses"}
        log(f"dp (c): dp {dp} over {cards} cards (the hierarchical leg "
            f"{'ran' if dp >= 2 * DP_HIER_GROUP else 'needs four cards'}): "
            + json.dumps(multi))
    else:
        log(f"dp (c): not run: {cards} card visible (needs two or more: "
            "NCCL takes one rank a card; the sharded and hierarchical "
            "legs ran over gloo in (b))")
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
RUNTIME_LENET = dict(batch=64, train=60000, test=10000, epochs=2,
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
    kinds, relu and leaky relu, dropout, space-to-depth and merges, the
    loss and the updater step in named profiler scopes (15(b)-(c)'s and
    20(a)'s forward attribution; the innermost scope names a kernel)."""
    from deeplearning4j_tpu_torch.nn import activations as A
    from deeplearning4j_tpu_torch.nn import graph, multilayer
    from deeplearning4j_tpu_torch.nn.conf import dropout as D
    from deeplearning4j_tpu_torch.nn.conf import graph as G
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
               (L.SpaceToDepth, "forward", "s2d_merge"),
               (G.MergeVertex, "apply", "s2d_merge"),
               (multilayer, "default_param_update", "update")]
    saved = []
    for act in ("relu", "leakyrelu"):
        saved.append((A.ACTIVATIONS, act, A.ACTIVATIONS[act]))
        A.ACTIVATIONS[act] = _scoped(A.ACTIVATIONS[act], act)
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
    batch 128, deterministic cuDNN) for REMAT_STEPS fit steps stock, with
    checkpointPolicy="save_conv_outputs" and with
    activationCheckpointing(True), from the same weights: the losses and
    the final params, BN statistics and momentum bitwise equal; each
    run's peak memory and step ms; PAR06's prediction for the per-layer
    run over its measured peak, within PAR06_BAND."""
    import torch

    from deeplearning4j_tpu_torch.analysis import validate_plan
    from deeplearning4j_tpu_torch.nn import DataType, Nesterovs
    from deeplearning4j_tpu_torch.zoo import ResNet50

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    x, y = resnet_batch(dev, RESNET_TIMED, RESNET_TIMED["batch"])
    runs, nets = {}, {}
    for key, policy in (("stock", None),
                        ("save_conv_outputs", "save_conv_outputs"),
                        ("per_layer", None)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        built_from = torch.cuda.memory_allocated(dev)
        net = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                         updater=Nesterovs(0.1, 0.9), checkpointPolicy=policy)
        net.conf.activationCheckpointing = key == "per_layer"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        losses, step_s = fit_timed(net, x, y, REMAT_STEPS)
        peak = torch.cuda.max_memory_allocated(dev)
        runs[key] = {"losses": losses,
                     "step_ms_median_3_on": float(np.median(step_s[2:]))
                     * 1e3,
                     "max_memory_allocated_bytes": peak,
                     "peak_over_resident_bytes": peak - base,
                     # the net's own high-water mark and its batch, as
                     # PAR06 predicts it (24(b)'s measure)
                     "net_peak_bytes": peak - built_from + x.nbytes
                     + y.nbytes}
        nets[key] = net
        if key == "stock":
            continue
        need(runs[key]["losses"] == runs["stock"]["losses"],
             f"zoo (f): {key} losses {runs[key]['losses']} vs stock "
             f"{runs['stock']['losses']}")
        need(state_equal(nets["stock"], net),
             f"zoo (f): {key}'s final state is not stock's bit for bit")
        del nets[key]
    conf = ResNet50(numClasses=RESNET_TIMED["classes"], seed=SEED,
                    inputShape=(3, RESNET_TIMED["image"],
                                RESNET_TIMED["image"]),
                    dataType=DataType.BFLOAT16, dataFormat="NHWC",
                    updater=Nesterovs(0.1, 0.9)).conf()
    conf.activationCheckpointing = True
    pred = validate_plan(conf, {"data": 1}, batchSize=RESNET_TIMED["batch"]
                         ).plan["memory"]["total_bytes"]
    ratio = pred / runs["per_layer"]["net_peak_bytes"]
    need(PAR06_BAND[0] <= ratio <= PAR06_BAND[1],
         f"zoo (f): PAR06 predicts {pred} B for the per-layer run, "
         f"measured {runs['per_layer']['net_peak_bytes']} B, ratio "
         f"{ratio:.3f} outside {PAR06_BAND}")
    peak = {k: v["max_memory_allocated_bytes"] for k, v in runs.items()}
    ms = {k: v["step_ms_median_3_on"] for k, v in runs.items()}
    out = dict(runs, peak_ratio=peak["save_conv_outputs"] / peak["stock"],
               per_layer_peak_ratio=peak["per_layer"] / peak["stock"],
               per_layer_over_policy_peak=peak["per_layer"]
               / peak["save_conv_outputs"],
               per_layer_step_over_stock=ms["per_layer"] / ms["stock"],
               per_layer_par06_predicted_bytes=pred,
               per_layer_par06_ratio=ratio)
    log("zoo (f): " + json.dumps(out))
    del nets, net, x, y
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
#: 17(b): config 1 through records: 14(b)'s MNIST as CSV files, the
#: first 20,000 of its 60,000 training digits (cut to keep the whole
#: smoke near 850 s) and its 10,000 test digits
RECORDS = dict(batch=64, train=20000, test=10000, epochs=1,
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


# ----------------------------------------------------------------------
# phase 18: one-shot serving and the fleet
# ----------------------------------------------------------------------

#: phase 9(b)'s widths served: 224^2 NHWC, 1000 classes, bf16 over f32
#: masters, eval mode (BN's running statistics), random weights
SERVE = dict(buckets=(1, 8, 32, 128), queue_limit=1024, max_wait_ms=2.0,
             images=32)
#: (b): request sizes coalesced into one dispatch (28 rows -> bucket 32,
#: 8 rows -> bucket 8), submitted in this order and reversed
SERVE_PARITY = ((3, 5, 2, 7, 4, 1, 6), (3, 2, 1, 2))
#: (b): the band of a row's bucket-1 answer against its coalesced one
#: (a stated deviation, ROADMAP Queue 3): cuDNN picks its convolution
#: algorithms by batch size, so the bf16 sums round apart. The served
#: softmax saturates (one class near 1.0), so the band is also held on
#: the logits: max-abs over the logits' max-abs
CROSS_BUCKET_ULPS = 1.0
CROSS_BUCKET_LOGIT_REL = 2e-2
CROSS_BUCKET_TOP1 = 1.0
#: (c): the HTTP burst
SERVE_HTTP = dict(requests=(1, 2, 1, 2))
#: (d): the serial rate's requests, then the open loop's
SERVE_LOAD = dict(serial=24, requests=512, clients=16, min_rate=200.0,
                  x_serial=8.0, split_reps=5)
#: (e): int8 against bf16 on `rows` rows; top-1 must agree on `top1` of
#: them (int8 weights move near-tied logits)
SERVE_INT8 = dict(rows=256, top1=0.99, reps=5)
#: (f): two swaps during an open loop of `requests`, after the given
#: numbers of completed requests; 2,048 at 200/s (~10 s) hold both: a
#: captured version's warm takes ~1.7 s, but a first, cold one took
#: 1.95-4.69 s on the H100, and 1,024 (~5 s) once ended before it served
SERVE_SWAP = dict(requests=2048, images=8, swap_after=(64, 160))
#: (g): the fleet
SERVE_FLEET = dict(replicas=2, skew_requests=256, hot=0.8,
                   wedged_requests=4, swap_requests=128, seq_requests=4,
                   seq_steps=12, slot_buckets=(1, 2, 4))


def serve_images(n, seed=SEED):
    """n seeded uniform NHWC images [n, 224, 224, 3], float32 on the
    host (the request payload)."""
    s = RESNET_TIMED["image"]
    return np.random.RandomState(seed).rand(n, s, s, 3).astype(np.float32)


def serve_resnet(dev, seed=SEED):
    return resnet_net(dev, RESNET_TIMED, "BFLOAT16", seed=seed,
                      dataFormat="NHWC")


def floored_ulps(got, want):
    """Largest distance in bf16 steps of `want`'s magnitude, the step of
    values below 1/256 of want's max-abs taken at that floor (the
    measure of bf16_close)."""
    w = np.abs(np.asarray(want, np.float64))
    floor = max(float(w.max()), 1e-30) / 256
    step = np.exp2(np.floor(np.log2(np.maximum(w, floor))) - 7)
    return float((np.abs(np.asarray(got, np.float64) - want) / step).max())


def serving_warm(dev, net):
    """18(a): ModelHost.register warms every bucket."""
    from deeplearning4j_tpu_torch.serving import ModelHost

    host = ModelHost()
    t = time.perf_counter()
    rep = host.register("resnet50", net, batchBuckets=SERVE["buckets"],
                        queueLimit=SERVE["queue_limit"],
                        maxWaitMs=SERVE["max_wait_ms"])
    out = {"register_s": time.perf_counter() - t,
           "bucket_seconds": {str(b): r["seconds"]
                              for b, r in rep["warm"].items()},
           "status": {str(b): r["status"] for b, r in rep["warm"].items()}}
    need(set(rep["warm"]) == set(SERVE["buckets"]),
         f"serving (a): warmed {sorted(rep['warm'])}")
    log("serving (a) warm: " + json.dumps(out))
    return host, out


def serving_parity(dev, net, images):
    """18(b): coalesced answers bitwise the same rows' ParallelInference
    output padded to the same bucket, whatever shares the dispatch and
    wherever the row sits; the bucket-1 answer against it, and the
    logits at bucket 1 against those at the coalesced bucket, in a
    band."""
    import torch

    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import ManualClock, MicroBatcher

    def logits(x, bucket):
        xp = np.concatenate([x, np.zeros((bucket - len(x),) + x.shape[1:],
                                          x.dtype)])
        return graph_logits(net, net._params,
                            torch.from_numpy(xp).to(dev))[:len(x)].cpu()

    pi = ParallelInference(net, batchBuckets=SERVE["buckets"])
    pi.precompile()
    alone = ParallelInference(net, batchBuckets=(1,))
    alone.precompile()
    coalesced, single, lg_coal, lg_one = [], [], [], []
    dispatches = []
    for sizes in SERVE_PARITY:
        offs = np.cumsum((0,) + sizes)
        reqs = [images[offs[i]:offs[i + 1]] for i in range(len(sizes))]
        bucket = pi._target_batch(int(offs[-1]))
        oracle = ParallelInference(net, batchBuckets=(bucket,))
        want = [oracle.output(r).toNumpy() for r in reqs]
        for order in (list(range(len(reqs))),
                      list(reversed(range(len(reqs))))):
            mb = MicroBatcher(pi._dispatch_coalesced, max_rows=max(
                SERVE["buckets"]), bucket_for=pi._target_batch,
                clock=ManualClock(), start_thread=False)
            handles = {i: mb.submit(reqs[i], wait=False) for i in order}
            mb.flush()
            need(mb.occupancy == [(int(offs[-1]), bucket)],
                 f"serving (b): dispatches {mb.occupancy}")
            dispatches += mb.occupancy
            for i in order:
                got = handles[i].wait(0)
                need(np.array_equal(got, want[i]),
                     f"serving (b): request {i} of {sizes} (order {order}) "
                     f"differs from its bucket-{bucket} oracle by "
                     f"{np.abs(got - want[i]).max():.3e}")
            mb.close()
        coalesced += want
        single += [np.concatenate([alone.output(r[j:j + 1]).toNumpy()
                                   for j in range(len(r))]) for r in reqs]
        rows = np.concatenate(reqs)
        lg_coal.append(logits(rows, bucket))
        lg_one += [logits(rows[j:j + 1], 1) for j in range(len(rows))]
        oracle.close()
    got = np.concatenate(coalesced)
    one = np.concatenate(single)
    lc, lo = torch.cat(lg_coal), torch.cat(lg_one)
    diff = float(np.abs(got - one).max())
    u = floored_ulps(one, got)
    lrel = float((lo - lc).abs().max() / lc.abs().max())
    top1 = float((got.argmax(1) == one.argmax(1)).mean())
    ltop1 = float((lo.argmax(1) == lc.argmax(1)).float().mean())
    need(pi.cold_dispatches == 0 and alone.cold_dispatches == 0,
         f"serving (b): cold dispatches {pi.cold_dispatches}, "
         f"{alone.cold_dispatches}")
    out = {"rows": int(got.shape[0]), "dispatches": dispatches,
           "same_bucket_bitwise": True,
           "bucket1_vs_coalesced_max_abs": diff,
           "bucket1_vs_coalesced_floored_bf16_ulps": u,
           "bucket1_vs_coalesced_bitwise": bool(np.array_equal(got, one)),
           "bucket1_vs_coalesced_top1": top1,
           "output_max": float(got.max()),
           "logits_bucket1_vs_coalesced_rel_max_abs": lrel,
           "logits_max_abs": float(lc.abs().max()),
           "logits_top1": ltop1}
    log("serving (b) parity: " + json.dumps(out))
    need(u <= CROSS_BUCKET_ULPS and lrel <= CROSS_BUCKET_LOGIT_REL
         and min(top1, ltop1) >= CROSS_BUCKET_TOP1,
         f"serving (b): bucket 1 vs coalesced {u:.2f} floored ulps, logits "
         f"{lrel:.3e} of their max-abs, top-1 {top1:.3f} / {ltop1:.3f} "
         f"(band {CROSS_BUCKET_ULPS}, {CROSS_BUCKET_LOGIT_REL}, "
         f"{CROSS_BUCKET_TOP1})")
    return out


def serving_http(dev, host, images):
    """18(c): :predict over localhost: 200s of the right shape, 404, 400,
    and behind a chaos wedge of a queueLimit=1 LeNet: 504 and 429."""
    from deeplearning4j_tpu_torch.runtime.chaos import ChaosPlan
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.zoo import LeNet

    host.register("lenet-q1", LeNet(numClasses=10, seed=SEED,
                                    device=dev).init(),
                  batchBuckets=(1,), queueLimit=1, maxWaitMs=1.0)
    srv = InferenceServer(host).start(port=0)
    codes = {}
    try:
        deadline = time.monotonic() + 120
        while http(srv.port, "/healthz", timeout=10)[0] != 200:
            need(time.monotonic() < deadline, "/healthz never turned 200")
            time.sleep(0.1)
        offs = np.cumsum((0,) + SERVE_HTTP["requests"])
        answers = [None] * len(SERVE_HTTP["requests"])

        def fire(i):
            answers[i] = http(srv.port, "/v1/models/resnet50:predict",
                              {"instances":
                               images[offs[i]:offs[i + 1]].tolist()})

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(answers))]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        wall = time.perf_counter() - t
        for i, (code, body) in enumerate(answers):
            need(code == 200, f"serving (c): :predict {i} answered {code}: "
                 f"{body[:200]!r}")
            rec = json.loads(body)
            preds = np.asarray(rec["predictions"], np.float32)
            n = SERVE_HTTP["requests"][i]
            need(preds.shape == (n, RESNET_TIMED["classes"])
                 and rec["rows"] == n and rec["model"] == "resnet50",
                 f"serving (c): answer {i} {preds.shape}, {rec['rows']}")
            need(np.isfinite(preds).all(), "serving (c): non-finite answer")
        codes["predict"] = [a[0] for a in answers]
        codes["unknown"] = http(srv.port, "/v1/models/ghost:predict",
                                {"instances": images[:1].tolist()})[0]
        codes["no_instances"] = http(srv.port,
                                     "/v1/models/resnet50:predict", {})[0]
        # behind a wedged dispatcher: A sits in the dispatch, B's 1 ms
        # deadline passes in the queue (504), C finds the queue full (429)
        release = threading.Event()
        digit = np.random.RandomState(SEED).rand(1, 1, 28, 28).astype(
            np.float32).tolist()
        held = {}
        plan = ChaosPlan(seed=SEED).wedge("queue.dispatch", 120.0, at=0,
                                          release=release)
        q1 = host.model("lenet-q1").batcher
        with plan:
            wedged = threading.Thread(target=lambda: held.update(
                a=http(srv.port, "/v1/models/lenet-q1:predict",
                       {"instances": digit})))
            wedged.start()
            deadline = time.monotonic() + 60
            while plan.fired("queue.dispatch") < 1:
                need(time.monotonic() < deadline, "serving (c): the wedge "
                     "never fired")
                time.sleep(0.01)
            codes["deadline_1ms"] = http(
                srv.port, "/v1/models/lenet-q1:predict",
                {"instances": digit, "deadlineMs": 1})[0]
            need(q1.depth == 1, f"serving (c): lenet-q1 depth {q1.depth}")
            codes["queue_full"] = http(srv.port,
                                       "/v1/models/lenet-q1:predict",
                                       {"instances": digit})[0]
            release.set()
            wedged.join(120)
        codes["wedged"] = held["a"][0]
    finally:
        srv.stop()
    want = {"predict": [200] * len(answers), "unknown": 404,
            "no_instances": 400, "deadline_1ms": 504, "queue_full": 429,
            "wedged": 200}
    need(codes == want, f"serving (c): codes {codes}, want {want}")
    out = {"codes": codes, "burst_wall_s": wall}
    log("serving (c) http: " + json.dumps(out))
    return out


def cold_total(*pis):
    return sum(pi.cold_dispatches for pi in pis)


def serving_load(dev, host, net, images):
    """18(d): serial rate, then open-loop load serial and batched; the
    host split of one bucket-128 dispatch."""
    import torch

    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import loadgen
    from deeplearning4j_tpu_torch.serving.queue import (
        occupancy_summary_from,
    )

    cfg = SERVE_LOAD
    pi_serial = ParallelInference(net, batchBuckets=(1,))
    pi_serial.precompile()
    lock = threading.Lock()

    def serial_submit(x):
        with lock:                   # one dispatch per request
            return pi_serial.output(x)

    def one(i):
        return images[i % len(images)][None]

    sm = host.model("resnet50")
    serial_submit(one(0))
    host.submit("resnet50", one(0))
    t = time.perf_counter()
    for i in range(cfg["serial"]):
        serial_submit(one(i))
    serial_rps = cfg["serial"] / (time.perf_counter() - t)
    rate = max(cfg["min_rate"], cfg["x_serial"] * serial_rps)
    rs = loadgen.run_open_loop(serial_submit, one, rate=rate,
                               n_requests=cfg["requests"], seed=SEED,
                               max_clients=cfg["clients"])
    n0 = len(sm.batcher.occupancy)
    rb = loadgen.run_open_loop(lambda x: host.submit("resnet50", x), one,
                               rate=rate, n_requests=cfg["requests"],
                               seed=SEED + 1, max_clients=cfg["clients"])
    occ = occupancy_summary_from(sm.batcher.occupancy[n0:],
                                 "mean_rows_per_dispatch")
    cold = cold_total(sm.pi, pi_serial)
    need(rs["errors"] == {} and rb["errors"] == {},
         f"serving (d): errors serial {rs['errors']}, batched "
         f"{rb['errors']}")
    need(cold == 0, f"serving (d): {cold} cold dispatches")
    need(rb["requests_per_sec"] >= rs["requests_per_sec"],
         f"serving (d): batched {rb['requests_per_sec']} req/s below "
         f"serial {rs['requests_per_sec']}")
    # the host split of one bucket-128 dispatch (median of split_reps):
    # assemble (128 one-image requests concatenated and padded), the copy
    # to the card, the forward, the copy back
    reqs = [one(i) for i in range(128)]
    split = {"assemble": [], "h2d": [], "forward": [], "d2h": []}
    for _ in range(cfg["split_reps"]):
        t0 = time.perf_counter()
        x = sm.pi._pad(np.concatenate(reqs), 128)
        t1 = time.perf_counter()
        xd = torch.from_numpy(x).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            o = net._forward_infer(net._params, xd)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        o.float().cpu().numpy()
        t4 = time.perf_counter()
        for k, a, b in (("assemble", t0, t1), ("h2d", t1, t2),
                        ("forward", t2, t3), ("d2h", t3, t4)):
            split[k].append(1e3 * (b - a))
    split = {k: float(np.median(v)) for k, v in split.items()}
    keep = ("requests_per_sec", "p50_ms", "p99_ms", "completed", "errors")
    out = {"serial_rps_24": serial_rps, "rate": rate,
           "serial": {k: rs[k] for k in keep},
           "batched": {k: rb[k] for k in keep},
           "speedup": rb["requests_per_sec"] / rs["requests_per_sec"],
           "occupancy": occ, "cold_dispatches": cold,
           "bucket128_split_ms": split}
    log("serving (d) load: " + json.dumps(out))
    pi_serial.close()
    return out


def serving_int8(host, net, images):
    """18(e): the net registered int8: top-1 against bf16 on the rows,
    resident weight bytes, ms per bucket-128 dispatch beside bf16."""
    import torch

    from deeplearning4j_tpu_torch.nn.quantize import param_bytes

    cfg = SERVE_INT8
    rep = host.register("resnet50-int8", net,
                        batchBuckets=SERVE["buckets"],
                        queueLimit=SERVE["queue_limit"],
                        maxWaitMs=SERVE["max_wait_ms"], int8=True)
    q8, b16 = host.model("resnet50-int8"), host.model("resnet50")
    rows = np.concatenate([images] * (cfg["rows"] // len(images)))
    got, want = [], []
    for s in range(0, cfg["rows"], 128):
        got.append(host.submit("resnet50-int8", rows[s:s + 128]))
        want.append(host.submit("resnet50", rows[s:s + 128]))
    got, want = np.concatenate(got), np.concatenate(want)
    top1 = float((got.argmax(1) == want.argmax(1)).mean())
    x = rows[:128]

    def dispatch_ms(sm):
        times = []
        for _ in range(cfg["reps"] + 1):
            t = time.perf_counter()
            sm.pi._dispatch_coalesced(x)
            times.append(1e3 * (time.perf_counter() - t))
        return float(np.median(times[1:]))

    bf16_params = [{k: t.to(torch.bfloat16) for k, t in p.items()}
                   for p in net._params.values()]
    out = {"warm_seconds": {str(b): r["seconds"]
                            for b, r in rep["warm"].items()},
           "rows": cfg["rows"], "top1_agreement": top1,
           "int8_weight_bytes": param_bytes(q8.pi._qp),
           "bf16_weight_bytes": param_bytes(bf16_params),
           "f32_master_bytes": param_bytes(net._params),
           "int8_ms_b128": dispatch_ms(q8), "bf16_ms_b128": dispatch_ms(b16),
           "cold_dispatches": q8.pi.cold_dispatches}
    log("serving (e) int8: " + json.dumps(out))
    need(np.isfinite(got).all(), "serving (e): non-finite int8 answers")
    need(top1 >= cfg["top1"], f"serving (e): int8 top-1 agreement {top1} "
         f"below {cfg['top1']}")
    need(out["cold_dispatches"] == 0, "serving (e): a cold dispatch")
    return out


def serving_swap(dev, host, net, images):
    """18(f): two rolling swaps during an open loop: zero errors, zero
    cold dispatches, every answer bitwise one of the two versions'
    same-bucket oracles."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving import loadgen

    cfg = SERVE_SWAP
    net2 = serve_resnet(dev, seed=SEED + 1)
    pool = images[:cfg["images"]]
    oracles = []             # (version net, bucket) -> [images, classes]
    for v in (net, net2):
        for b in SERVE["buckets"]:
            pi = ParallelInference(v, batchBuckets=(b,))
            if b == 1:
                o = np.concatenate([pi.output(pool[i:i + 1]).toNumpy()
                                    for i in range(len(pool))])
            else:
                o = pi.output(pool).toNumpy()
            oracles.append((1 if v is net else 2, b, o))
    versions = [host.model("resnet50")]
    done = [0]
    lock = threading.Lock()
    wrong, seen = [], set()

    def submit(i):
        try:
            got = host.submit("resnet50", pool[i][None])
        finally:
            with lock:
                done[0] += 1
        hit = [v for v, _, o in oracles if np.array_equal(got[0], o[i])]
        with lock:
            if hit:
                seen.add(hit[0])
            else:
                wrong.append(i)

    swaps = []

    finished = threading.Event()

    def swapper():
        # the second swap waits for an answer of the second version
        for after, to, need_v in zip(cfg["swap_after"], (net2, net),
                                     (1, 2)):
            while done[0] < after or need_v not in seen:
                if finished.wait(0.002):
                    return
            swaps.append(host.swap("resnet50", to))
            versions.append(host.model("resnet50"))

    sw = threading.Thread(target=swapper)
    sw.start()
    rec = loadgen.run_open_loop(submit, lambda i: i % len(pool),
                                rate=SERVE_LOAD["min_rate"],
                                n_requests=cfg["requests"], seed=SEED + 2,
                                max_clients=SERVE_LOAD["clients"])
    finished.set()
    sw.join(300)
    cold = cold_total(*(v.pi for v in versions))
    out = {"errors": rec["errors"], "completed": rec["completed"],
           "requests_per_sec": rec["requests_per_sec"],
           "p99_ms": rec["p99_ms"],
           "versions": [s["version"] for s in swaps],
           "swap_warm_s": [s["warm_s"] for s in swaps],
           "swap_status": [sorted({r["status"] for r in s["warm"].values()})
                           for s in swaps],
           "versions_seen": sorted(seen), "not_an_oracle": len(wrong),
           "cold_dispatches": cold}
    log("serving (f) swap: " + json.dumps(out))
    need(rec["errors"] == {} and rec["completed"] == cfg["requests"],
         f"serving (f): {rec['errors']}, {rec['completed']} completed")
    need(len(swaps) == 2 and not wrong,
         f"serving (f): {len(swaps)} swaps, {len(wrong)} answers match no "
         "oracle")
    need(cold == 0, f"serving (f): {cold} cold dispatches")
    need(seen == {1, 2}, f"serving (f): versions seen {seen}")
    del net2
    return out


def serving_fleet(dev, net, images):
    """18(g): two ModelHost replicas on the card behind FleetRouter:
    ResNet-50 and LeNet at an 80/20 skew; a chaos wedge, then raises on
    one replica (failover, its breaker opens, quarantine, the probe
    readmits it); swap_all under load; config 3's char-RNN through
    register_sequence and swap_all."""
    from deeplearning4j_tpu_torch.runtime.chaos import ChaosPlan
    from deeplearning4j_tpu_torch.serving import (
        FleetRouter, ModelHost, loadgen,
    )
    from deeplearning4j_tpu_torch.serving.fleet import (
        scenario_hot_model_skew,
    )
    from deeplearning4j_tpu_torch.zoo import LeNet

    cfg = SERVE_FLEET
    fleet = FleetRouter(breaker=dict(window=4, failure_ratio=0.5,
                                     min_samples=2, open_for_s=600.0))
    rids = [fleet.add_replica(ModelHost(), replica_id=f"r{i}")
            for i in range(cfg["replicas"])]
    out = {}
    try:
        lenet = LeNet(numClasses=10, seed=SEED, device=dev).init()
        fleet.register("resnet50", net, batchBuckets=SERVE["buckets"],
                       queueLimit=SERVE["queue_limit"],
                       maxWaitMs=SERVE["max_wait_ms"])
        fleet.register("lenet", lenet, batchBuckets=(1, 8, 32),
                       queueLimit=SERVE["queue_limit"],
                       maxWaitMs=SERVE["max_wait_ms"])
        digits = np.random.RandomState(SEED).rand(
            len(images), 1, 28, 28).astype(np.float32)
        feeds = {"resnet50": images, "lenet": digits}

        def submit_for(name):
            return lambda i: fleet.submit(
                name, feeds[name][i % len(images)][None])

        rec = scenario_hot_model_skew(
            submit_for, lambda i: i, models=["resnet50", "lenet"],
            hot_fraction=cfg["hot"], rate=SERVE_LOAD["min_rate"] * 2,
            n_requests=cfg["skew_requests"], seed=SEED)
        need(rec["errors"] == {}, f"fleet (g): skew errors {rec['errors']}")
        out["skew"] = {k: rec[k] for k in ("requests_per_sec", "p50_ms",
                                           "p99_ms", "completed")}
        out["skew"]["per_model"] = rec["per_model"]

        # the chaos leg, serial so every ordinal is fixed: request w0
        # wedges r0's dispatch (ordinal 0); the next W requests route
        # around it to r1 (ordinals 1..W); once w0 is released, r0 ranks
        # first again (ties go by replica id) and its next two dispatches
        # raise (ordinals W+1 and W+3; r1 answers W+2 and W+4): two
        # failovers, and r0's breaker opens (2 of its last 4 outcomes
        # failed); then traffic avoids r0 until it is quarantined and
        # three probes readmit it
        W = cfg["wedged_requests"]
        release = threading.Event()
        plan = (ChaosPlan(seed=SEED)
                .wedge("queue.dispatch", 300.0, at=0, release=release)
                .raise_n("queue.dispatch", at=W + 1)
                .raise_n("queue.dispatch", at=W + 3))
        hosts = dict(fleet._hosts())
        hits = {r: 0 for r in rids}
        for r, h in hosts.items():
            b = h.model("resnet50").batcher

            def counted(f, _r=r, _orig=b._dispatch):
                hits[_r] += 1
                return _orig(f)

            b._dispatch = counted
        client_errors = []

        def settle(wedged=0):
            # a reply wakes its client just before its dispatch stops
            # counting as load: wait for that, so each serial request
            # ranks the replicas as the ordinals above assume
            limit = time.monotonic() + 60
            while hosts["r0"].queued_work("resnet50") > wedged \
                    or hosts["r1"].queued_work("resnet50") > 0:
                need(time.monotonic() < limit, "fleet (g): never idle")
                time.sleep(0.001)

        def call(i, wedged=0):
            settle(wedged)
            try:
                return fleet.submit("resnet50",
                                    images[i % len(images)][None])
            except Exception as e:   # the gate counts them
                client_errors.append(repr(e))

        fo = fleet._m_failover.labels(model="resnet50", error="ChaosError")
        fo0 = fo.value
        with plan:
            w0 = threading.Thread(target=call, args=(0,))
            w0.start()
            deadline = time.monotonic() + 60
            while plan.fired("queue.dispatch") < 1:
                need(time.monotonic() < deadline, "fleet (g): no wedge")
                time.sleep(0.005)
            around = dict(hits)
            for i in range(W):
                call(i + 1, wedged=1)
            around = {r: hits[r] - around[r] for r in rids}
            release.set()
            w0.join(300)
            for i in range(2):
                call(W + 1 + i)
            opened = fleet.health("r0").breaker.state
            before = dict(hits)
            for i in range(4):
                call(W + 3 + i)
            avoided = hits["r0"] - before["r0"]
        fleet.quarantine("r0")
        fleet.set_probe("resnet50", images[:1])
        probes = [fleet.probe_tick() for _ in range(3)]
        readmitted = [p[0]["readmitted"] for p in probes if p]
        out["chaos"] = {"fired": plan.events,
                        "routed_around_wedge": around,
                        "chaos_failovers": fo.value - fo0,
                        "breaker_after_raises": opened,
                        "r0_dispatches_while_open": avoided,
                        "probes_readmitted": readmitted,
                        "breaker_after_probes":
                            fleet.health("r0").breaker.state,
                        "client_errors": client_errors}
        log("fleet (g) chaos: " + json.dumps(out["chaos"]))
        need(not client_errors, f"fleet (g): client errors {client_errors}")
        need(around["r0"] == 0 and around["r1"] == W,
             f"fleet (g): around the wedge {around}")
        need(fo.value - fo0 == 2 and opened == "open" and avoided == 0,
             f"fleet (g): failovers {fo.value - fo0}, breaker {opened}, "
             f"{avoided} dispatches on the open replica")
        need(readmitted == [False, False, True]
             and not fleet.health("r0").quarantined,
             f"fleet (g): probes {probes}")

        # swap_all under load
        net2 = serve_resnet(dev, seed=SEED + 1)
        sw = {}
        th = threading.Thread(target=lambda: sw.update(
            rep=fleet.swap_all("resnet50", net2)))
        olds = [h.model("resnet50") for h in hosts.values()]

        def start_swap(i):
            if i == cfg["swap_requests"] // 4:
                th.start()
            return i

        rec = loadgen.run_open_loop(
            lambda i: fleet.submit("resnet50",
                                   images[i % len(images)][None]),
            start_swap, rate=SERVE_LOAD["min_rate"],
            n_requests=cfg["swap_requests"], seed=SEED + 3,
            max_clients=SERVE_LOAD["clients"])
        th.join(300)
        news = [h.model("resnet50") for h in hosts.values()]
        cold = cold_total(*(sm.pi for sm in olds + news))
        out["swap_all"] = {"errors": rec["errors"],
                           "completed": rec["completed"],
                           "versions": sorted(r["version"] for r in
                                              sw["rep"].values()),
                           "cold_dispatches": cold}
        need(rec["errors"] == {} and cold == 0
             and out["swap_all"]["versions"] == [2] * len(rids),
             f"fleet (g): swap_all {out['swap_all']}")
        del net2

        # config 3's char-RNN as a fleet sequence model
        V = CHAR_RNN["vocab"]
        rnn1 = char_rnn(dev, CHAR_RNN, "BFLOAT16")
        fleet.register_sequence("char-rnn", rnn1,
                                slotBuckets=cfg["slot_buckets"])
        eye = np.eye(V, dtype=np.float32)
        rng = np.random.RandomState(SEED)
        prompts = [eye[rng.randint(0, V, cfg["seq_steps"])]
                   for _ in range(cfg["seq_requests"])]
        before = [fleet.submit_sequence("char-rnn", p) for p in prompts]
        rnn2 = char_rnn(dev, dict(CHAR_RNN, seed=CHAR_RNN["seed"] + 1),
                        "BFLOAT16")
        rep = fleet.swap_all("char-rnn", rnn2)
        after = [fleet.submit_sequence("char-rnn", p) for p in prompts]
        out["char_rnn"] = {
            "versions": sorted(r["version"] for r in rep.values()),
            "shapes": [list(np.asarray(a).shape) for a in after],
            "changed": sum(not np.array_equal(a, b)
                           for a, b in zip(before, after))}
        need(out["char_rnn"]["versions"] == [2] * len(rids)
             and out["char_rnn"]["changed"] == len(prompts)
             and all(np.isfinite(np.asarray(a)).all() for a in after),
             f"fleet (g): char-RNN {out['char_rnn']}")
        snap = fleet.metrics_snapshot()
        out["models"] = snap["models"]
    finally:
        fleet.close()
    log("fleet (g): " + json.dumps({k: v for k, v in out.items()
                                     if k != "chaos"}))
    return out


def serving_phase(dev):
    """Phase 18: one-shot serving of phase 9(b)'s ResNet-50, (a)-(g)."""
    import torch

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t = time.perf_counter()
    before = kernel_launches()
    images = serve_images(SERVE["images"])
    net = serve_resnet(dev)
    host, warm = serving_warm(dev, net)
    out = {"warm": warm}
    try:
        out["parity"] = serving_parity(dev, net, images)
        out["http"] = serving_http(dev, host, images)
        out["load"] = serving_load(dev, host, net, images)
        out["int8"] = serving_int8(host, net, images)
        out["swap"] = serving_swap(dev, host, net, images)
    finally:
        host.close()
    gc.collect()
    torch.cuda.empty_cache()
    out["fleet"] = serving_fleet(dev, net, images)
    need(kernel_launches() == before, "serving: a hand-written kernel "
         f"launched: {before} -> {kernel_launches()}")
    del net
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    log(f"phase 18: {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------------
# phase 19: the rest of SameDiff and ONNX import
# ----------------------------------------------------------------------

#: 19(a): the zoo ResNet50 written to ONNX and imported, at full width
ONNX_RESNET = dict(batch=32, image=224, classes=1000, reps=10)
ONNX_LOGIT_REL = 1e-4     # imported vs native logits, of their max-abs
#: 19(b): config 1's LeNet widths as a SameDiff graph through sd.cnn
SD_LENET = dict(batch=64, classes=10, steps=20, resume_at=5, resume_to=10)
#: 19(c): control flow on the card against the same graph on the CPU
CF_REL = 1e-5
CF_STEPS = 5
#: 19(d): lstmLayer at config 3's widths (77 -> 256, B 32, T 20)
SD_LSTM = dict(inputs=77, hidden=256, batch=32, seq=20)
#: 19(d) cnn/rnn/image/segment ops, card vs CPU: rtol, and atol as a
#: share of each tensor's max-abs (ROADMAP.md Queue 3)
SWEEP_RTOL, SWEEP_ATOL = 1e-5, 1e-6
LINALG_REL = 1e-4
FFT_REL = 1e-5
#: betainc f32 against scipy: the reference's own f32 continued fraction
#: lies up to 1.8e-5 (relative) and 5.5e-6 (absolute) from scipy at these
#: draws, so the bar carries an absolute term (ROADMAP.md Queue 3;
#: tests/test_torch_samediff_namespaces.py pins the reach)
BETAINC_RTOL, BETAINC_ATOL = 1e-5, 1e-5


def _test_helper(name):
    """tests/_torch_<name>_models.py of this checkout, loaded by path (it
    imports no jax, tensorflow or h5py)."""
    import importlib.util

    mod_name = f"_torch_{name}_models"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        mod_name + ".py")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_resnet(dev, cfg):
    """The zoo ResNet50 (f32, seed 0) with its BN running statistics
    drawn from seed 0, as 19(a) and 20(e) import it."""
    import torch

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    S = cfg["image"]
    net = ComputationGraph(_test_helper("onnx").resnet50_conf(
        numClasses=cfg["classes"], inputShape=(3, S, S), seed=SEED),
        device=dev).init()
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for st in net._states.values():
            if st:
                st["mean"].copy_(0.1 * torch.randn(st["mean"].shape,
                                                   generator=g))
                st["var"].copy_(0.5 + torch.rand(st["var"].shape,
                                                 generator=g))
    return net


def eval_logits(net, x, head):
    """The eval-mode preoutput of output layer `head` (the logits)."""
    import torch

    from deeplearning4j_tpu_torch.nn.multilayer import strip_carries

    with torch.no_grad():
        _, pre, _ = net._run_graph(net._params, strip_carries(net._states),
                                   net._coerce_inputs(x), False, None, None)
    return pre[head]


def wall_ms(fn, reps):
    """Median host wall ms of `fn` to a synchronize, after one warm
    call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def onnx_resnet(dev, cfg):
    """19(a): the zoo ResNet50 (seeded weights, seeded BN running
    statistics) written as ONNX by tests/_torch_onnx_models.py, read by
    OnnxGraphMapper.importGraph into a SameDiff on the card, validated,
    and held to the net's own eval-mode forward at batch 32."""
    import torch

    from deeplearning4j_tpu_torch.analysis import validate_samediff
    from deeplearning4j_tpu_torch.modelimport import (
        OnnxGraphMapper, onnx_wire,
    )

    om = _test_helper("onnx")
    B, S = cfg["batch"], cfg["image"]
    net = seeded_resnet(dev, cfg)
    t = time.perf_counter()
    data = onnx_wire.encode(om.resnet_onnx(net, B))
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    sd = OnnxGraphMapper.importGraph(data, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t
    lv, pv = sd._onnx_vars["logits"], sd._onnx_vars["probs"]
    report = validate_samediff(sd, placeholders=["input"], outputs=[pv])
    need(report.ok, "19(a): the validator on the imported graph: "
         + report.format())
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (B, 3, S, S), dtype=np.float32)).to(dev)

    def imported():
        return sd.output({"input": x}, [lv.name, pv.name])

    def native_logits():
        return eval_logits(net, x, "fc")

    out = imported()
    got, probs = out[lv.name].tensor(), out[pv.name].tensor()
    want = native_logits()
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(1) == want.argmax(1)).double().mean())
    probs_err = float((probs - net.output(x).tensor()).abs().max())
    need(rel <= ONNX_LOGIT_REL and top1 == 1.0,
         f"19(a): imported logits {rel:.3e} of the max-abs from the native "
         f"net's (bar {ONNX_LOGIT_REL}), top-1 agreement {top1}")
    res = {"model_bytes": len(data), "write_s": write_s,
           "import_s": import_s, "ops": len(sd._ops),
           "permutes": sum(o.opName == "permute" for o in sd._ops),
           "logits_rel_max_abs": rel, "top1_agreement": top1,
           "probs_max_abs": probs_err,
           "validator": report.codes(),
           "imported_ms": wall_ms(imported, cfg["reps"]),
           "native_ms": wall_ms(lambda: net.output(x), cfg["reps"])}
    res["imported_kernels"], res["imported_busy_ms"] = \
        traced_device_work(imported)
    res["native_kernels"], res["native_busy_ms"] = \
        traced_device_work(lambda: net.output(x))
    log("19(a) onnx resnet-50: " + json.dumps(res))
    del sd, net, data
    return res


def sd_lenet(dev, ref, cfg):
    """Config 1's LeNet as a SameDiff graph over NHWC images: conv 5x5
    20 -> max-pool 2 -> conv 5x5 50 -> max-pool 2 -> dense 500 relu ->
    dense 10, softmax cross-entropy, Adam(1e-3) (the zoo net's
    updater), from the reference-layout weights `ref` of the zoo
    LeNet's six layers."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    B, C = cfg["batch"], cfg["classes"]
    sd = SameDiff.create(dev)
    x = sd.placeHolder("x", "float32", B, 28, 28, 1)
    y = sd.placeHolder("y", "float32", B, C)
    c1, c2, d, o = (ref[i] for i in (0, 2, 4, 5))
    h = sd.nn.relu(sd.cnn.conv2d(x, sd.var("c1W", c1["W"]),
                                 sd.var("c1b", c1["b"])))
    h = sd.cnn.maxPooling2d(h, (2, 2))
    h = sd.nn.relu(sd.cnn.conv2d(h, sd.var("c2W", c2["W"]),
                                 sd.var("c2b", c2["b"])))
    h = sd.cnn.maxPooling2d(h, (2, 2))
    # the reference's flatten order is (c, h, w)
    h = sd.math.reshape(sd.math.permute(h, 0, 3, 1, 2), [B, 800])
    h = sd.nn.relu(sd.nn.linear(h, sd.var("dW", d["W"]),
                                sd.var("db", d["b"])))
    logits = sd.nn.linear(h, sd.var("oW", o["W"]), sd.var("ob", o["b"]),
                          name="logits")
    sd.loss.softmaxCrossEntropy(y, logits, name="loss")
    sd.setTrainingConfig(TrainingConfig.Builder().updater(Adam(1e-3))
                         .dataSetFeatureMapping("x")
                         .dataSetLabelMapping("y").build())
    return sd


_SD_LENET_PARAMS = {"c1W": (0, "W"), "c1b": (0, "b"), "c2W": (2, "W"),
                    "c2b": (2, "b"), "dW": (4, "W"), "db": (4, "b"),
                    "oW": (5, "W"), "ob": (5, "b")}


def samediff_lenet(dev, cfg):
    """19(b): the SameDiff LeNet's first step against the zoo LeNet's
    MultiLayerNetwork (no regularisation on either side), 20 fit steps
    (steps/s, kernels a step), and 5 steps + save(saveUpdaterState) +
    load(loadUpdaterState) + 5 steps bitwise 10 unbroken steps."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference
    from deeplearning4j_tpu_torch.zoo import LeNet

    B, C = cfg["batch"], cfg["classes"]
    rng = np.random.default_rng(SEED)
    n = B * cfg["resume_to"]
    xs = rng.random((n, 784), dtype=np.float32)   # synthetic digits
    rule = rng.standard_normal((784, C))
    ys = np.eye(C, dtype=np.float32)[(xs @ rule).argmax(1)]
    mln = LeNet(numClasses=C, seed=SEED, device=dev).init()
    ref = params_to_reference(mln.layers, mln._params)
    sd = sd_lenet(dev, ref, cfg)
    feed = {"x": xs[:B].reshape(B, 28, 28, 1), "y": ys[:B]}
    g_mln, l_mln = mln.computeGradientAndScore(xs[:B], ys[:B])
    g_mln = params_to_reference(mln.layers, g_mln)
    l_sd = float(sd.output(feed, ["loss"])["loss"].toNumpy())
    g_sd = sd.calculateGradients(feed, *_SD_LENET_PARAMS)
    loss_rel = abs(l_sd - l_mln) / abs(l_mln)
    worst = max(rel_l2(g_sd[n].tensor().cpu(),
                       torch.as_tensor(g_mln[i][k]))
                for n, (i, k) in _SD_LENET_PARAMS.items())
    need(loss_rel <= 1e-5 and worst <= 1e-4,
         f"19(b): SameDiff LeNet loss {l_sd} vs the MLN's {l_mln} (rel "
         f"{loss_rel:.3e}), worst gradient rel L2 {worst:.3e}")
    steps = []
    for i in range(cfg["steps"]):
        t = time.perf_counter()
        sd.fit(features=feed["x"], labels=feed["y"])
        steps.append(time.perf_counter() - t)
    med = float(np.median(steps[2:]))
    kernels, busy = traced_device_work(
        lambda: sd.fit(features=feed["x"], labels=feed["y"]))
    # the resume: fresh graphs from the same weights, batch i at step i
    batches = [(xs[i * B:(i + 1) * B].reshape(B, 28, 28, 1),
                ys[i * B:(i + 1) * B]) for i in range(cfg["resume_to"])]
    whole = sd_lenet(dev, ref, cfg)
    want = [whole.fit(features=bx, labels=by)[0] for bx, by in batches]
    part = sd_lenet(dev, ref, cfg)
    k = cfg["resume_at"]
    got = [part.fit(features=bx, labels=by)[0] for bx, by in batches[:k]]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lenet.zip")
        part.save(path, saveUpdaterState=True)
        nbytes = os.path.getsize(path)
        back = SameDiff.load(path, loadUpdaterState=True, device=dev)
    back.setTrainingConfig(part._tc)
    got += [back.fit(features=bx, labels=by)[0] for bx, by in batches[k:]]
    same_w = all(torch.equal(back._arrays[n], whole._arrays[n])
                 for n in _SD_LENET_PARAMS)
    need(got == want and same_w, "19(b): 5 steps + save/load + 5 steps "
         f"are not bitwise 10 unbroken steps: {got} vs {want}, weights "
         f"equal {same_w}")
    res = {"first_step_loss": l_sd, "mln_loss": l_mln,
           "loss_rel": loss_rel, "worst_grad_rel_l2": worst,
           "fit_step_ms_median_3_on": med * 1e3,
           "fit_steps_per_s": 1.0 / med, "kernels_per_step": kernels,
           "busy_ms_per_step": busy, "resume_bitwise": True,
           "file_bytes": nbytes, "losses": want}
    log("19(b) samediff lenet: " + json.dumps(res))
    return res


def _cf_pair(build, dev):
    """The graph `build(sd)` on the card and on the CPU."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff

    out = []
    for d in (dev, "cpu"):
        sd = SameDiff.create(d)
        out.append((sd, build(sd)))
    return out


def _rel_to(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-300))


def control_flow_card(dev):
    """19(c): a bounded whileLoop trains under fitSteps with no host sync
    of its own (its steps also run under the sync-debug "error" mode);
    an unbounded loop's trip count and each ifCond branch; all against
    the same graph on the CPU; a dropout body draws anew each
    iteration."""
    import torch

    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    F32 = np.float32
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((64, 32), dtype=np.float32)
    Y = rng.standard_normal((64, 32), dtype=np.float32)
    W = (rng.standard_normal((32, 32)) * 0.2).astype(np.float32)

    def bounded(sd):
        x = sd.placeHolder("x", "float32", 64, 32)
        y = sd.placeHolder("y", "float32", 64, 32)
        w = sd.var("w", W)
        h, _, _ = sd.whileLoop(
            lambda s, a, c, ww: s.math.lt(c, s.constant(F32(3.0))),
            lambda s, a, c, ww: (s.math.tanh(s.linalg.mmul(a, ww)),
                                 c + s.constant(F32(1.0)), ww),
            [x, sd.constant(F32(0.0)), w], maxIterations=4)
        sd.loss.meanSquaredError(y, h, name="loss")
        sd.setTrainingConfig(TrainingConfig.Builder().updater(Adam(1e-2))
                             .dataSetFeatureMapping("x")
                             .dataSetLabelMapping("y").build())

    (card, _), (cpu, _) = _cf_pair(bounded, dev)
    losses = [g.fitSteps(features=X, labels=Y, numSteps=CF_STEPS)
              for g in (card, cpu)]
    need(card._control_syncs == 0, "19(c): a bounded loop fetched its "
         f"predicate {card._control_syncs} times")
    tc, names, params, state = card._fit_setup()
    phs = {"x": torch.from_numpy(X).to(dev), "y": torch.from_numpy(Y).to(dev)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, card._train_state = card._step(tc, names, params, state, phs,
                                          card._iteration)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    card._iteration += 1
    cpu.fitSteps(features=X, labels=Y, numSteps=1)
    w_rel = _rel_to(card._arrays["w"], cpu._arrays["w"])
    need(w_rel <= CF_REL and abs(losses[0] - losses[1]) <= CF_REL * abs(
        losses[1]), f"19(c): the bounded loop's training: weights "
         f"{w_rel:.3e} of the max-abs from the CPU's, losses {losses}")

    def unbounded(sd):
        x = sd.placeHolder("x", "float32", 256)
        return sd.whileLoop(
            lambda s, a, c: s.math.lt(s.math.sum(s.math.abs(a)),
                                      s.constant(F32(1e4))),
            lambda s, a, c: (s.math.mul(a, s.constant(F32(1.7))),
                             c + s.constant(F32(1.0))),
            [x, sd.constant(F32(0.0))])

    xv = rng.standard_normal(256).astype(np.float32)
    (gc_, (a_c, n_c)), (gp, (a_p, n_p)) = _cf_pair(unbounded, dev)
    s0 = gc_._control_syncs
    rc = gc_.output({"x": xv}, [a_c, n_c])
    rp = gp.output({"x": xv}, [a_p, n_p])
    trips = int(rc[n_c.name].toNumpy())
    need(trips == int(rp[n_p.name].toNumpy()) and trips > 3
         and gc_._control_syncs - s0 == trips + 1
         and _rel_to(rc[a_c.name].tensor(), rp[a_p.name].tensor())
         <= CF_REL, f"19(c): the unbounded loop: {trips} trips on the card "
         f"vs {int(rp[n_p.name].toNumpy())}, "
         f"{gc_._control_syncs - s0} fetches")

    def branches(sd):
        x = sd.placeHolder("x", "float32", 128, 64)
        w = sd.constant(W[:, :16].repeat(2, 0), name="wb")
        return sd.ifCond(sd.math.gt(sd.math.sum(x), sd.constant(F32(0.0))),
                         lambda s, a, ww: s.math.tanh(s.linalg.mmul(a, ww)),
                         lambda s, a, ww: s.nn.sigmoid(s.math.neg(
                             s.linalg.mmul(a, ww))),
                         inputs=[x, w], name="branch")

    (gc_, _), (gp, _) = _cf_pair(branches, dev)
    branch_rel = []
    for sign in (1.0, -1.0):
        xb = np.abs(rng.standard_normal((128, 64), dtype=np.float32)) * sign
        s0 = gc_._control_syncs
        a = gc_.output({"x": xb}, ["branch"])["branch"].tensor()
        b = gp.output({"x": xb}, ["branch"])["branch"].tensor()
        branch_rel.append(_rel_to(a, b))
        need(gc_._control_syncs - s0 == 1 and branch_rel[-1] <= CF_REL,
             f"19(c): ifCond branch {sign}: {branch_rel[-1]:.3e}")

    def dropped(sd):
        x = sd.placeHolder("x", "float32", 4096)
        return sd.whileLoop(
            lambda s, a, m, c: s.math.lt(c, s.constant(F32(2.0))),
            lambda s, a, m, c: (s.nn.dropout(s.math.identity(m), 0.5), a,
                                c + s.constant(F32(1.0))),
            [x, x, sd.constant(F32(0.0))], maxIterations=2)

    (gd, outs), _ = _cf_pair(dropped, dev)
    env = dict(gd._base_env(), x=torch.ones(4096, device=dev))
    two = gd._run_graph(dict(env), [outs[0].name], train=True,
                        stream=1)[outs[0].name]
    (g1, outs1), _ = _cf_pair(lambda sd: sd.whileLoop(
        lambda s, a, m, c: s.math.lt(c, s.constant(F32(1.0))),
        lambda s, a, m, c: (s.nn.dropout(s.math.identity(m), 0.5), a,
                            c + s.constant(F32(1.0))),
        [sd.placeHolder("x", "float32", 4096)] * 2
        + [sd.constant(F32(0.0))], maxIterations=1), dev)
    env1 = dict(g1._base_env(), x=torch.ones(4096, device=dev))
    one = g1._run_graph(dict(env1), [outs1[0].name], train=True,
                        stream=1)[outs1[0].name]
    kept = float((two != 0).float().mean())
    need(not torch.equal(one, two) and 0.45 < kept < 0.55,
         "19(c): a dropout body replayed iteration 0's mask, or kept "
         f"{kept}")
    res = {"bounded_fit_steps_losses": losses, "bounded_weights_rel": w_rel,
           "unbounded_trips": trips, "branch_rel": branch_rel,
           "dropout_kept": kept}
    log("19(c) control flow: " + json.dumps(res))
    return res


def _sweep_cases(draws):
    """(op, class, build) for every op of SameDiff's rest; `build(sd)`
    returns the output variables and the names of the variables whose
    gradient is checked. Inputs come from ``draws["rng"]``, which the
    caller reseeds before each build, so the card and the CPU see the
    same ones."""
    F32 = np.float32

    def r(*s, scale=1.0):
        return (draws["rng"].standard_normal(s) * scale).astype(F32)

    def u(*s, lo=0.0, hi=1.0):
        return draws["rng"].uniform(lo, hi, s).astype(F32)

    draws["rng"] = np.random.default_rng(SEED)

    x4, img = r(8, 32, 32, 16), u(4, 24, 32, 3)
    spd = (lambda m: (m @ m.T / 64 + np.eye(64)).astype(F32))(r(64, 64))
    tall = r(96, 64)
    # rank 8 of 64, in f64: in f32 its numerically-zero singular values
    # sit at the cut eps*max(M, N)*s_max itself
    rank_def = r(96, 8).astype(np.float64) @ r(8, 64).astype(np.float64)
    corner = u(512, 2, hi=10.0)
    boxes = np.concatenate([corner, corner + u(512, 2, lo=0.5, hi=3.0)], 1)
    ints = draws["rng"].integers(-2 ** 20, 2 ** 20, (1024,)).astype(
        np.int32)
    shifts = draws["rng"].integers(0, 31, (1024,)).astype(np.int32)
    sig = draws["rng"].integers(0, 84, (4096,)).astype(np.int32)
    L = SD_LSTM
    cases = [
        ("conv2d", "cnn", lambda sd: ([sd.cnn.conv2d(
            sd.constant(x4), sd.constant(r(3, 3, 16, 32, scale=0.2)),
            sd.constant(r(32)), stride=(1, 2), padding=((1, 1), (1, 0)))],
            ())),
        ("conv1d", "cnn", lambda sd: ([sd.cnn.conv1d(
            sd.constant(r(8, 128, 16)), sd.constant(r(5, 16, 32, scale=0.2)),
            stride=2, padding=((2, 2),))], ())),
        ("conv3d", "cnn", lambda sd: ([sd.cnn.conv3d(
            sd.constant(r(2, 8, 16, 16, 4)),
            sd.constant(r(3, 3, 3, 4, 8, scale=0.2)),
            padding=((1, 1), (1, 1), (1, 1)))], ())),
        ("deconv2d", "cnn", lambda sd: ([sd.cnn.deconv2d(
            sd.constant(x4), sd.constant(r(3, 3, 16, 8, scale=0.2)),
            stride=(2, 2), padding=((1, 2), (1, 2)))], ())),
        ("maxPooling2d", "cnn", lambda sd: ([sd.cnn.maxPooling2d(
            sd.constant(x4), (3, 3), (2, 2), padding=((1, 1), (1, 1)))],
            ())),
        ("avgPooling2d", "cnn", lambda sd: ([sd.cnn.avgPooling2d(
            sd.constant(x4), (3, 3), (2, 2), padding=((1, 1), (1, 1)),
            count_include_pad=False)], ())),
        ("upsampling2d", "cnn", lambda sd: ([sd.cnn.upsampling2d(
            sd.constant(x4), (2, 2))], ())),
        ("im2col", "cnn", lambda sd: ([sd.cnn.im2col(
            sd.constant(x4), (3, 3), (2, 2), padding=((1, 1), (1, 1)))],
            ())),
        ("spaceToBatch", "cnn", lambda sd: ([sd.cnn.batchToSpace(
            sd.cnn.spaceToBatch(sd.constant(x4), 2), 2), sd.cnn.spaceToBatch(
                sd.constant(x4), 2, padding=((2, 0), (0, 2)))], ())),
        ("lstmLayer", "rnn", lambda sd: (list(sd.rnn.lstmLayer(
            sd.var("x", r(L["seq"], L["batch"], L["inputs"])),
            sd.var("w", r(L["inputs"], 4 * L["hidden"], scale=0.1)),
            sd.var("u", r(L["hidden"], 4 * L["hidden"], scale=0.05)),
            sd.var("b", r(4 * L["hidden"], scale=0.1)))),
            ("x", "w", "u", "b"))),
        ("gru", "rnn", lambda sd: ([sd.rnn.gru(
            sd.constant(r(20, 32, 77)), sd.constant(r(77, 768, scale=0.1)),
            sd.constant(r(256, 768, scale=0.05)),
            sd.constant(r(768, scale=0.1)))], ())),
        ("simpleRnn", "rnn", lambda sd: ([sd.rnn.simpleRnn(
            sd.constant(r(20, 32, 77)), sd.constant(r(77, 256, scale=0.1)),
            sd.constant(r(256, 256, scale=0.05)),
            sd.constant(r(256, scale=0.1)))], ())),
        ("resizeBilinear", "image", lambda sd: ([sd.image.resizeBilinear(
            sd.constant(img), 56, 40), sd.image.resizeBilinear(
                sd.constant(img), 10, 13)], ())),
        ("resizeNearest", "image", lambda sd: ([sd.image.resizeNearest(
            sd.constant(img), 56, 40), sd.image.resizeNearest(
                sd.constant(img), 10, 13)], ())),
        ("cropAndResize", "image", lambda sd: ([sd.image.cropAndResize(
            sd.constant(img), sd.constant(np.array(
                [[0.1, 0.2, 0.77, 0.71], [0.03, 0.02, 0.97, 0.99]], F32)),
            sd.constant(np.array([3, 0], np.int32)), 17, 9)], ())),
        ("adjustContrast", "image", lambda sd: ([sd.image.adjustContrast(
            sd.constant(img), 1.7)], ())),
        ("hsvToRgb", "image", lambda sd: ([sd.image.hsvToRgb(
            sd.constant(img))], ())),
        ("rgbToHsv", "image", lambda sd: ([sd.image.rgbToHsv(
            sd.constant(img))], ())),
        ("nonMaxSuppression", "exact", lambda sd: ([
            sd.image.nonMaxSuppression(sd.constant(boxes),
                                       sd.constant(u(512)),
                                       maxOutputSize=64, iouThreshold=0.5,
                                       scoreThreshold=0.05)], ())),
        ("segment", "seg", lambda sd: ([getattr(sd.math, op)(
            sd.constant(r(4096, 8)), sd.constant(sig), numSegments=80)
            for op in ("segmentSum", "segmentMax", "segmentMin",
                       "segmentMean", "segmentProd")], ())),
        ("bitwise", "exact", lambda sd: ([
            getattr(sd.bitwise, op)(sd.constant(ints), sd.constant(shifts))
            for op in ("leftShift", "rightShift", "bitwiseAnd", "bitwiseOr",
                       "bitwiseXor")] + [sd.bitwise.bitwiseNot(
                           sd.constant(ints))] + [
            getattr(sd.bitwise, op)(sd.constant(ints.astype(dt)),
                                    sd.constant(shifts.astype(dt)))
            for dt in (np.uint8, np.uint16, np.uint32)
            for op in ("leftShift", "rightShift", "bitwiseXor")] + [
            getattr(sd.bitwise, op)(sd.constant(ints.astype(np.uint64)),
                                    sd.constant(shifts.astype(np.uint64)))
            for op in ("bitwiseAnd", "bitwiseOr", "bitwiseXor")], ())),
        ("fft", "fft", lambda sd: ([
            sd.fft.fft(sd.constant(r(16, 256))),
            sd.fft.ifft(sd.fft.fft(sd.constant(r(16, 256)), numPoints=300)),
            sd.fft.rfft(sd.constant(r(16, 256)), dimension=0),
            sd.fft.irfft(sd.fft.rfft(sd.constant(r(16, 256))),
                         numPoints=256),
            sd.fft.fft2(sd.constant(r(4, 64, 64))),
            sd.fft.ifft2(sd.constant(r(4, 64, 64)))] + [
            getattr(sd.fft, p)(sd.fft.toComplex(sd.constant(r(64)),
                                                sd.constant(r(64))))
            for p in ("real", "imag", "conj", "angle")], ())),
        ("betainc", "betainc", lambda sd: (lambda a, b, x: (
            [sd.math.betainc(a, b, x), a, b, x], ()))(
            sd.constant(u(64, 64, lo=0.5, hi=5.0)),
            sd.constant(u(64, 64, lo=0.5, hi=5.0)),
            sd.constant(u(64, 64, lo=0.05, hi=0.95)))),
        ("cholesky", "linalg", lambda sd: ([sd.linalg.cholesky(
            sd.constant(spd)), sd.constant(spd)], ())),
        ("inv", "linalg", lambda sd: ([sd.linalg.inv(sd.constant(spd)),
                                       sd.constant(spd)], ())),
        ("det", "linalg", lambda sd: ([sd.linalg.det(sd.constant(
            spd[:8, :8]))], ())),
        ("solve", "linalg", lambda sd: ([sd.linalg.solve(
            sd.constant(spd), sd.constant(tall[:64, :8])), sd.constant(spd),
            sd.constant(tall[:64, :8])], ())),
        ("lstsq", "linalg", lambda sd: ([sd.linalg.lstsq(
            sd.constant(rank_def), sd.constant(
                tall[:, :4].astype(np.float64)))], ())),
        ("lu", "linalg", lambda sd: (list(sd.linalg.lu(sd.constant(tall[:64])))
                                     + [sd.constant(tall[:64])], ())),
        ("eigh", "linalg", lambda sd: (list(sd.linalg.eigh(sd.constant(spd)))
                                       + [sd.constant(spd)], ())),
        ("svd", "linalg", lambda sd: (list(sd.linalg.svd(sd.constant(tall)))
                                      + [sd.constant(tall)], ())),
        ("qr", "linalg", lambda sd: (list(sd.linalg.qr(sd.constant(tall)))
                                     + [sd.constant(tall)], ())),
    ]
    return cases


def _linalg_check(op, card, cpu):
    """Sign-, phase- and pivot-free checks of a decomposition on the card:
    its reconstruction, and its invariants against the CPU's."""
    import torch

    c = [t.double().cpu() for t in card]
    p = [t.double().cpu() for t in cpu]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    if op == "cholesky":
        return max(rel(c[0] @ c[0].T, c[1]), rel(c[0], p[0]))
    if op == "inv":
        return rel(c[1] @ c[0], torch.eye(c[1].shape[0], dtype=c[0].dtype))
    if op in ("det", "lstsq"):
        return rel(c[0], p[0])
    if op == "solve":
        return rel(c[1] @ c[0], c[2])
    if op == "lu":
        return rel(c[0] @ c[1] @ c[2], c[3])
    if op == "eigh":
        return max(rel(c[1] @ torch.diag(c[0]) @ c[1].T, c[2]),
                   rel(c[0], p[0]))
    if op == "svd":
        k = c[1].shape[0]
        return max(rel(c[0][:, :k] * c[1] @ c[2][:k], c[3]), rel(c[1], p[1]))
    if op == "qr":
        return max(rel(c[0] @ c[1], c[2]),
                   rel(c[1].diagonal().abs(), p[1].diagonal().abs()))
    raise ValueError(op)


def namespace_sweep(dev):
    """19(d): every op of SameDiff's rest once on the card against the
    port on the CPU (the same seeded inputs): elementwise, cnn and rnn
    within rtol 1e-5 / atol 1e-6 (lstmLayer at config 3's widths with its
    gradient); linalg through reconstructions and invariants (1e-4
    relative); fft within 1e-5 of the max-abs; NMS and bitwise exactly;
    betainc against scipy on the host (rtol 1e-5, f32)."""
    import scipy.special as sp
    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff

    worst = {}
    ran, failed = [], []
    draws = {}
    for i, (op, kind, build) in enumerate(_sweep_cases(draws)):
        outs = {}
        for d in (dev, "cpu"):
            draws["rng"] = np.random.default_rng(SEED + 1 + i)
            sd = SameDiff.create(d)
            vs, wrt = build(sd)
            got = sd.output({}, vs)
            vals = [got[v.name].tensor() for v in vs]
            grads = []
            if wrt:
                sd.setLossVariables(sd.math.sum(sd.math.square(vs[0]),
                                                name="sq").name)
                g = sd.calculateGradients({}, *wrt)
                grads = [g[n].tensor() for n in wrt]
            outs[d if d == "cpu" else "card"] = (vals, grads)
        (cv, cg), (pv, pg) = outs["card"], outs["cpu"]
        need(all(a.device.type == torch.device(dev).type for a in cv),
             f"19(d) {op}: an output left the card")
        if kind == "linalg":
            err = _linalg_check(op, cv, pv)
            ok = err <= LINALG_REL
        elif kind == "exact":
            err = float(sum(not torch.equal(a.cpu(), b)
                            for a, b in zip(cv, pv)))
            ok = err == 0 and all(a.dtype == b.dtype for a, b in zip(cv, pv))
        elif kind == "fft":
            err = max(_rel_to(a if not a.is_complex() else
                              torch.view_as_real(a), b if not b.is_complex()
                              else torch.view_as_real(b))
                      for a, b in zip(cv, pv))
            ok = err <= FFT_REL and all(a.dtype == b.dtype
                                        for a, b in zip(cv, pv))
        elif kind == "betainc":
            want = sp.betainc(*(t.double().numpy() for t in pv[1:4]))
            got = cv[0].cpu().double().numpy()
            err = float(np.max(np.abs(got - want)
                               / (BETAINC_ATOL + BETAINC_RTOL * np.abs(want))))
            ok = err <= 1.0 and cv[0].dtype == torch.float32 and \
                torch.allclose(cv[0].cpu(), pv[0], rtol=SWEEP_RTOL,
                               atol=SWEEP_ATOL)
        else:
            # |card - cpu| <= atol * max|cpu| + rtol * |cpu|, per tensor:
            # the sums run in other orders (cuDNN's algorithms), so the
            # absolute term scales with the tensor's magnitude
            err = 0.0
            for a, b in zip(cv + cg, pv + pg):
                a, b = a.cpu().double(), b.double()
                lim = SWEEP_ATOL * b.abs().max() + SWEEP_RTOL * b.abs()
                err = max(err, float(((a - b).abs() / lim).nan_to_num(
                    0.0).max()))
            ok = err <= 1.0
        worst[op] = err
        ran.append(op)
        if not ok:
            failed.append(f"{op} ({kind}): {err:.3e}")
    log("19(d) namespace sweep: " + json.dumps(worst))
    need(not failed, "19(d) against the CPU: " + "; ".join(failed))
    return {"ops": ran, "worst": worst}


def samediff_rest_phase(dev):
    """Phase 19: (a) ResNet-50 from ONNX, (b) a SameDiff LeNet through
    sd.cnn with updater state in its file, (c) control flow on the card,
    (d) the namespace sweep; f32, TF32 off; no hand-written kernel."""
    import torch

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t = time.perf_counter()
    before = kernel_launches()
    out = {"onnx": onnx_resnet(dev, ONNX_RESNET)}
    gc.collect()
    torch.cuda.empty_cache()
    out["lenet"] = samediff_lenet(dev, SD_LENET)
    out["control"] = control_flow_card(dev)
    out["sweep"] = namespace_sweep(dev)
    need(kernel_launches() == before, "phase 19: a hand-written kernel "
         f"launched: {before} -> {kernel_launches()}")
    out["seconds"] = time.perf_counter() - t
    log(f"phase 19: {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------------
# phase 20: detection, the rest of the zoo, the 3-d CNNs, Keras and TF
# import
# ----------------------------------------------------------------------

#: 20(a): zoo YOLO2 at the reference's COCO defaults (416^2, 80 classes,
#: 5 COCO anchors, Adam(1e-3)), bf16 over f32 masters, NHWC; labels are
#: synthetic (flagged): 1-8 boxes an image, in grid units
YOLO_MAIN = dict(batch=16, image=416, classes=80, steps=20, traced_steps=3,
                 parity_batch=2, boxes=(1, 8))
#: 20(b): the rest of the 2-d zoo at each model's default input:
#: model -> (image, classes, batch)
ZOO_REST = {"Darknet19": (224, 1000, 32), "TinyYOLO": (416, 20, 32),
            "SqueezeNet": (224, 1000, 32), "Xception": (299, 1000, 16),
            "InceptionResNetV1": (160, 1001, 32),
            "FaceNetNN4Small2": (96, 5749, 32), "NASNet": (224, 1000, 16)}
ZOO_REST_STEPS = 5
#: 20(c): C3D's published widths (Tran et al., ICCV 2015, Fig. 3): UCF101
#: clips of 16 frames at 112^2, bf16, momentum SGD as the paper's; at the
#: paper's rate (3e-3, batch 30) b8 from He init diverged in 8 steps (measured
#: on one H100), so the rate is 1e-4
C3D = dict(batch=8, frames=16, image=112, classes=101, steps=10, lr=1e-4,
           convs=(64, 128, 256, 256, 512, 512, 512, 512), fc=4096)
#: 20(d): Keras configs written by tests/_torch_keras_models.py
KERAS_RESNET = dict(batch=32, image=224, classes=1000, reps=10)
KERAS_MHA = dict(seq=512, dim=768, heads=12, key_dim=64, blocks=2, batch=8,
                 classes=10)
#: 20(e): zoo ResNet-50 as a frozen GraphDef (tests/_torch_tf_models.py)
TF_RESNET = dict(batch=32, image=224, classes=1000, reps=10)
#: parity bands. f64 card vs f64 CPU: phase 15's. f32 card (TF32 off) vs
#: the CPU's f64: the loss within 5e-5 and each gradient within 5e-2 rel
#: L2. The CPU's own f32 sits 6.1e-6 (loss) and up to 1.2e-2 (gradients)
#: from its f64 for YOLO2 at 416^2 b2, 2.8e-5 and 2.4e-2 at 64^2 (measured
#: on the CPU): near-zero pre-activations change side between summation orders
#: and move whole gradients through the BN layers
PARITY_F32_LOSS, PARITY_F32_GRAD = 5e-5, 5e-2
#: a detection's box and confidence, f64 card vs f64 CPU
DETECT_ATOL = 1e-9
#: 20(c) each 3-d layer alone, f32, card vs CPU: rtol, and atol as a
#: share of each tensor's max-abs (19(d)'s band)
LAYER3D_RTOL, LAYER3D_ATOL = 1e-5, 1e-6
#: 20(d)-(e): imported vs native logits, of their max-abs; 20(d)(ii)
#: card vs CPU, phase 6's f32 band
IMPORT_LOGIT_REL = 1e-4


def yolo_labels(rows, grid, classes, boxes, seed, nhwc):
    """Synthetic (flagged) YOLO labels [B, 4+C, grid, grid] (NHWC when
    `nhwc`): 1-8 boxes an image, corners in grid units, each in the cell
    of its center with a one-hot class."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((rows, 4 + classes, grid, grid), np.float32)
    for b in range(rows):
        for _ in range(rng.integers(boxes[0], boxes[1] + 1)):
            w, h = rng.uniform(0.5, 5.0, 2)
            cx, cy = rng.uniform(0.5, grid - 0.5, 2)
            gx, gy = int(cx), int(cy)
            lab[b, :, gy, gx] = 0.0
            lab[b, 0:4, gy, gx] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                   cy + h / 2)
            lab[b, 4 + rng.integers(0, classes), gy, gx] = 1.0
    return lab.transpose(0, 2, 3, 1).copy() if nhwc else lab


def zoo_net(name, dev, cfg, dtype, nhwc=True, **kw):
    """The zoo model `name` at `cfg`'s (image, classes), seed 0."""
    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import DataType

    image, classes = cfg[:2]
    return getattr(zoo, name)(
        numClasses=classes, seed=SEED, inputShape=(3, image, image),
        dataType=getattr(DataType, dtype), device=dev,
        dataFormat="NHWC" if nhwc else "NCHW", **kw).init()


def carry_to(net, other):
    """`other` (same conf) takes `net`'s params and states."""
    from deeplearning4j_tpu_torch.nn import graph, multilayer

    if hasattr(net.conf, "nodes"):
        p = graph.params_to_reference(net.conf, net._params)
        s = graph.params_to_reference(net.conf, net._states)
    else:
        p = multilayer.params_to_reference(net.layers, net._params)
        s = multilayer.params_to_reference(net.layers, net._states)
    other.load_reference_params(p, s)
    return other


def f64_and_f32_parity(name, dev, cfg, x, y, what):
    """The first step on the card against the CPU from the same f64
    weights: f64 card vs f64 CPU (loss ZOO_F64_LOSS, gradients
    ZOO_F64_GRAD rel L2) and f32 card vs the CPU's f64 (PARITY_F32_*).
    Returns the worst of each and the f64 nets."""
    cpu64 = zoo_net(name, "cpu", cfg, "DOUBLE", nhwc=False)
    card64 = carry_to(cpu64, zoo_net(name, dev, cfg, "DOUBLE", nhwc=False))
    card32 = carry_to(cpu64, zoo_net(name, dev, cfg, "FLOAT", nhwc=False))
    g64, l64 = cpu64.computeGradientAndScore(x, y)
    out = {}
    for key, net, loss_bar, grad_bar in (
            ("f64", card64, ZOO_F64_LOSS, ZOO_F64_GRAD),
            ("f32", card32, PARITY_F32_LOSS, PARITY_F32_GRAD)):
        g, loss = net.computeGradientAndScore(x, y)
        out[f"{key}_loss_rel"] = abs(loss - l64) / abs(l64)
        out[f"{key}_worst_grad_rel_l2"] = grads_against(g, g64)
        need(out[f"{key}_loss_rel"] <= loss_bar
             and out[f"{key}_worst_grad_rel_l2"] <= grad_bar,
             f"{what}: {key} on the card vs the CPU's f64: {out}")
    out["loss_f64"] = l64
    del card32
    return out, cpu64, card64


def yolo_main(dev, cfg):
    """20(a): YOLO2 trains at full width on one card; parity, the
    detections, and a save/restore/output round trip."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.nn.objdetect import YoloUtils
    from deeplearning4j_tpu_torch.util.serializer import ModelSerializer

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    grid = cfg["image"] // 32
    zcfg = (cfg["image"], cfg["classes"])
    rng = np.random.default_rng(SEED + 20)
    xb = 2 * cfg["parity_batch"]
    xp = rng.random((xb, 3, cfg["image"], cfg["image"]), dtype=np.float32)
    yp = yolo_labels(xb, grid, cfg["classes"], cfg["boxes"], SEED + 21,
                     nhwc=False)
    parity, cpu64, card64 = f64_and_f32_parity(
        "YOLO2", dev, zcfg, xp[:cfg["parity_batch"]],
        yp[:cfg["parity_batch"]], "20(a) YOLO2")
    # the detections of the f64 nets' outputs (eval mode), NHWC maps
    layer = card64.conf.nodes["out"].payload
    maps = [n.output(xp).toNumpy().transpose(0, 2, 3, 1)
            for n in (card64, cpu64)]
    dets = [YoloUtils.getPredictedObjects(layer, m, 0.5, 0.4) for m in maps]
    key = lambda d: (d.exampleNumber, d.predictedClass, -d.confidence)
    got, want = (sorted(d, key=key) for d in dets)
    need(len(got) == len(want) and all(
        a.exampleNumber == b.exampleNumber
        and a.predictedClass == b.predictedClass
        and max(abs(a.centerX - b.centerX), abs(a.centerY - b.centerY),
                abs(a.width - b.width), abs(a.height - b.height),
                abs(a.confidence - b.confidence)) <= DETECT_ATOL
        for a, b in zip(got, want)),
        f"20(a): detections card {len(got)} vs CPU {len(want)}")
    parity["detections"] = len(got)
    del cpu64, card64
    gc.collect()
    torch.cuda.empty_cache()
    net = zoo_net("YOLO2", dev, zcfg, "BFLOAT16")
    x = torch.from_numpy(rng.random(
        (cfg["batch"], cfg["image"], cfg["image"], 3),
        dtype=np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(yolo_labels(cfg["batch"], grid, cfg["classes"],
                                     cfg["boxes"], SEED + 22,
                                     nhwc=True)).to(dev)
    out = zoo_timed(dev, cfg, net, x, y, "20(a) YOLO2", cfg["traced_steps"])
    out["kernels_per_step"], out["device_busy_ms_per_step"] = \
        traced_device_work(lambda: (net.fit(x, y), net.score()))
    out["parity"] = parity
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "yolo2.npz")
        t = time.perf_counter()
        ModelSerializer.writeModel(net, path, saveUpdater=False)
        out["save_s"] = time.perf_counter() - t
        back = ModelSerializer.restoreComputationGraph(path, device=dev)
        out["file_bytes"] = os.path.getsize(path)
    a, b = net.output(x[:4]).tensor(), back.output(x[:4]).tensor()
    need(torch.equal(a, b), "20(a): the restored YOLO2's output differs")
    log("20(a) YOLO2 parity, kernels, file: " + json.dumps(
        {k: out[k] for k in ("parity", "kernels_per_step",
                             "device_busy_ms_per_step", "save_s",
                             "file_bytes")}))
    del net, back, x, y
    return out


def zoo_rest(dev, models, steps):
    """20(b): each model at its default input, bf16 NHWC: `steps` fit
    steps (median ms of steps 3 on, images/s, peak memory), and the first
    step's f32 loss at batch 2 against the CPU's f64."""
    import torch

    out = {}
    for name, cfg in models.items():
        image, classes, batch = cfg
        rng = np.random.default_rng(SEED + 23)
        if name == "TinyYOLO":
            y2 = yolo_labels(2, image // 32, classes, (1, 8), SEED + 24,
                             nhwc=False)
            yb = yolo_labels(batch, image // 32, classes, (1, 8), SEED + 25,
                             nhwc=True)
        else:
            y2 = np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                                2)]
            yb = np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                                batch)]
        x2 = rng.random((2, 3, image, image), dtype=np.float32)
        cpu64 = zoo_net(name, "cpu", cfg, "DOUBLE", nhwc=False)
        _, l64 = cpu64.computeGradientAndScore(x2, y2)
        card32 = carry_to(cpu64, zoo_net(name, dev, cfg, "FLOAT",
                                         nhwc=False))
        _, l32 = card32.computeGradientAndScore(x2, y2)
        rel = abs(l32 - l64) / abs(l64)
        need(rel <= PARITY_F32_LOSS, f"20(b) {name}: f32 loss {l32} vs "
             f"the CPU's f64 {l64} (rel {rel:.2e})")
        del cpu64, card32
        net = zoo_net(name, dev, cfg, "BFLOAT16")
        x = torch.from_numpy(rng.random((batch, image, image, 3),
                                        dtype=np.float32)).to(
            dev, torch.bfloat16)
        y = torch.from_numpy(yb).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_s = fit_timed(net, x, y, steps)
        need(all(math.isfinite(v) for v in losses),
             f"20(b) {name}: non-finite loss {losses}")
        med = float(np.median(step_s[2:]))
        out[name] = {"image": image, "classes": classes, "batch": batch,
                     "params": net.numParams(), "f32_loss_rel": rel,
                     "step_ms_median_3_on": med * 1e3,
                     "images_per_s": batch / med,
                     "max_memory_allocated_bytes":
                         torch.cuda.max_memory_allocated(dev),
                     "losses": losses}
        log(f"20(b) {name}: " + json.dumps(out[name]))
        del net, x, y
        gc.collect()
        torch.cuda.empty_cache()
    return out


def c3d_conf(cfg, dtype):
    """C3D (Tran et al. 2015, Fig. 3): eight 3x3x3 convolutions, five max
    pools (pool1 1x2x2, pool5 padded), two dense 4096 with dropout 0.5,
    softmax over the classes; NCDHW clips."""
    from deeplearning4j_tpu_torch.nn import (
        Convolution3D, DataType, DenseLayer, InputType, Nesterovs,
        NeuralNetConfiguration, OutputLayer, Subsampling3DLayer,
        WeightInit,
    )

    lb = (NeuralNetConfiguration.Builder().seed(SEED)
          .updater(Nesterovs(cfg["lr"], 0.9)).weightInit(WeightInit.RELU)
          .dataType(getattr(DataType, dtype)).list())

    def conv(n):
        lb.layer(Convolution3D(nOut=n, kernelSize=3, padding=1,
                               activation="relu"))

    def pool(k=(2, 2, 2), pad=(0, 0, 0)):
        lb.layer(Subsampling3DLayer(poolingType="max", kernelSize=k,
                                    stride=k, padding=pad))

    c = cfg["convs"]
    conv(c[0])
    pool((1, 2, 2))
    conv(c[1])
    pool()
    for i in (2, 4, 6):
        conv(c[i])
        conv(c[i + 1])
        pool(pad=(0, 1, 1) if i == 6 else (0, 0, 0))
    for _ in range(2):
        lb.layer(DenseLayer(nOut=cfg["fc"], activation="relu", dropOut=0.5))
    lb.layer(OutputLayer(nOut=cfg["classes"], activation="softmax"))
    n = cfg["image"]
    return lb.setInputType(InputType.convolutional3D(cfg["frames"], n, n,
                                                     3)).build()


def layer3d_cases():
    """20(c)'s layers alone: (name, layer, input shape NCDHW). The shapes
    keep each weight gradient's sum to a few thousand terms: over 25,088
    (B 4, 8 x 28 x 28) cuDNN's order took Deconvolution3D's to 1.23 of
    the band (measured on one H100)."""
    from deeplearning4j_tpu_torch.nn import (
        Cropping3D, Deconvolution3D, GlobalPoolingLayer, PReLULayer,
        Subsampling3DLayer, Upsampling3D, ZeroPadding3D,
    )

    shape = (2, 32, 6, 14, 14)
    return [
        ("Deconvolution3D", Deconvolution3D(nOut=32, kernelSize=(3, 3, 3),
                                            stride=2, padding=1), shape),
        ("Upsampling3D", Upsampling3D((2, 2, 2)), shape),
        ("Cropping3D", Cropping3D((1, 0, 2, 1, 0, 3)), shape),
        ("ZeroPadding3D", ZeroPadding3D(((1, 0), (2, 1), (0, 3))), shape),
        ("avg_pool3d_include_pad", Subsampling3DLayer(
            poolingType="avg", kernelSize=(3, 3, 3), stride=2,
            padding=(1, 1, 1)), shape),
        ("avg_pool3d_same", Subsampling3DLayer(
            poolingType="avg", kernelSize=(3, 3, 3), stride=2,
            convolutionMode="same"), (2, 32, 7, 13, 13)),
        ("GlobalPoolingLayer", GlobalPoolingLayer(poolingType="avg"), shape),
        ("PReLULayer", PReLULayer(alphaInit=0.25), shape),
    ]


def layers3d_card(dev):
    """Each 3-d layer once, f32: its output and the gradients of a seeded
    cotangent into its input and params on the card against the CPU."""
    import torch

    from deeplearning4j_tpu_torch.nn import InputType

    worst = {}
    for name, layer, shape in layer3d_cases():
        layer.mergeGlobals({})
        it = InputType.convolutional3D(*shape[2:], shape[1])
        g = torch.Generator().manual_seed(SEED)
        params, _ = layer.initialize(g, it, torch.float32, "cpu")
        params = {k: v + 0.1 * torch.randn(v.shape, generator=g)
                  for k, v in params.items()}
        x = torch.randn(shape, generator=g)
        res = {}
        for d in ("cpu", dev):
            xi = x.to(d).requires_grad_(True)
            pi = {k: v.to(d).requires_grad_(True) for k, v in params.items()}
            y, _ = layer.forward(pi, {}, xi, True, None)
            ct = torch.randn(y.shape, generator=torch.Generator().manual_seed(
                SEED + 1)).to(d)
            grads = torch.autograd.grad(y, [xi, *pi.values()], ct)
            res[str(d)] = [y.detach().cpu(), *(t.cpu() for t in grads)]
        shares = []
        for got, want in zip(res[str(dev)], res["cpu"]):
            bar = LAYER3D_RTOL * want.abs() + LAYER3D_ATOL * want.abs().max()
            shares.append(float(((got - want).abs() / bar).max()))
        worst[name] = max(shares)
        need(worst[name] <= 1.0, f"20(c) {name}: (output, input and param "
             f"gradients) at {shares} of the band")
    return worst


def c3d_phase(dev, cfg):
    """20(c): C3D at its published widths, bf16, `steps` fit steps; then
    each 3-d layer alone against the CPU."""
    import torch

    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

    torch.backends.cudnn.benchmark = False
    net = MultiLayerNetwork(c3d_conf(cfg, "BFLOAT16"), device=dev).init()
    rng = np.random.default_rng(SEED + 26)
    n, B = cfg["image"], cfg["batch"]
    x = torch.from_numpy(rng.random((B, 3, cfg["frames"], n, n),
                                    dtype=np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(np.eye(cfg["classes"], dtype=np.float32)[
        rng.integers(0, cfg["classes"], B)]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s = fit_timed(net, x, y, cfg["steps"])
    need(all(math.isfinite(v) for v in losses),
         f"20(c) C3D: non-finite loss {losses}")
    med = float(np.median(step_s[2:]))
    out = {"params": net.numParams(), "batch": B,
           "step_ms_median_3_on": med * 1e3, "clips_per_s": B / med,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
           "losses": losses}
    out["kernels_per_step"], out["device_busy_ms_per_step"] = \
        traced_device_work(lambda: (net.fit(x, y), net.score()))
    log("20(c) C3D: " + json.dumps(out))
    del net, x, y
    torch.cuda.empty_cache()
    out["layers_share_of_band"] = layers3d_card(dev)
    log("20(c) 3-d layers, share of the band: "
        + json.dumps(out["layers_share_of_band"]))
    return out


def keras_resnet(dev, cfg):
    """20(d)(i): keras.applications.ResNet50's config and seeded weights
    (tests/_torch_keras_models.py, no h5py, no tensorflow) imported on
    the card, against zoo ResNet50 holding the same arrays through the
    pretrained mapping: eval logits at batch 32, f32."""
    import torch

    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.zoo import ResNet50
    from deeplearning4j_tpu_torch.zoo.pretrained import _map_keras_weights

    km = _test_helper("keras")
    S = cfg["image"]
    config = km.resnet50_config(S, cfg["classes"])
    weights = km.resnet50_weights(config, seed=SEED)
    t = time.perf_counter()
    imported = KerasModelImport.importKerasModelAndWeights(
        config, weights=weights, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t
    model = ResNet50(numClasses=cfg["classes"], inputShape=(3, S, S),
                     seed=SEED, device=dev)
    zoo = _map_keras_weights(model, model.init(), weights)
    x = torch.from_numpy(np.random.default_rng(SEED + 27).standard_normal(
        (cfg["batch"], 3, S, S), dtype=np.float32)).to(dev)
    got = eval_logits(imported, x, "predictions")
    want = eval_logits(zoo, x, "fc")
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(1) == want.argmax(1)).double().mean())
    need(rel <= IMPORT_LOGIT_REL and top1 == 1.0,
         f"20(d)(i): imported logits {rel:.3e} of the max-abs from the zoo "
         f"net's (bar {IMPORT_LOGIT_REL}), top-1 {top1}")
    out = {"import_s": import_s, "logits_rel_max_abs": rel,
           "top1_agreement": top1,
           "imported_ms": wall_ms(lambda: imported.output(x), cfg["reps"]),
           "zoo_ms": wall_ms(lambda: zoo.output(x), cfg["reps"])}
    out["imported_kernels"], out["imported_busy_ms"] = \
        traced_device_work(lambda: imported.output(x))
    log("20(d)(i) Keras ResNet-50: " + json.dumps(out))
    del imported, zoo, x
    return out


def keras_mha(dev, cfg):
    """20(d)(ii): a MultiHeadAttention encoder at BERT-base widths from a
    Keras config: K1 launches on the card and its plain version does
    not; the output against the same import on the CPU."""
    import torch

    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    km = _test_helper("keras")
    config = km.mha_encoder_config(cfg["seq"], cfg["dim"], cfg["heads"],
                                   cfg["key_dim"], cfg["blocks"],
                                   cfg["classes"])
    weights = km.mha_encoder_weights(config, seed=SEED)
    nets = {d: KerasModelImport.importKerasModelAndWeights(
        config, weights=weights, device=d) for d in ("cpu", dev)}
    x = np.random.default_rng(SEED + 28).standard_normal(
        (cfg["batch"], cfg["dim"], cfg["seq"]), dtype=np.float32)
    want = nets["cpu"].output(x).toNumpy()
    tfa.flash_fwd.launches = tfa.flash_fwd_plain.launches = 0
    got = nets[dev].output(x).toNumpy()
    launches = {"K1": tfa.flash_fwd.launches,
                "plain": tfa.flash_fwd_plain.launches}
    need(launches["K1"] == cfg["blocks"] and launches["plain"] == 0,
         f"20(d)(ii): attention launches {launches}")
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    need(rel <= IMPORT_LOGIT_REL, f"20(d)(ii): card vs CPU {rel:.3e} of "
         f"the max-abs (bar {IMPORT_LOGIT_REL})")
    out = {"launches": launches, "output_rel_max_abs": rel}
    log("20(d)(ii) Keras MultiHeadAttention encoder: " + json.dumps(out))
    del nets
    return out


def tf_resnet(dev, cfg, onnx):
    """20(e): zoo ResNet-50 written as a frozen GraphDef by
    tests/_torch_tf_models.py through tf_wire, imported by importFrozenTF
    into a SameDiff on the card, against the net's own eval logits at
    batch 32; its forward beside 19(a)'s."""
    import torch

    from deeplearning4j_tpu_torch.modelimport import (
        TFGraphMapper, importFrozenTF, tf_wire,
    )

    B, S = cfg["batch"], cfg["image"]
    net = seeded_resnet(dev, cfg)
    data = tf_wire.encode(_test_helper("tf").resnet_graphdef(net, B))
    t = time.perf_counter()
    sd = importFrozenTF(data, device=dev)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t
    lv = TFGraphMapper.outputVariable(sd, "logits")
    xn = np.random.default_rng(SEED).standard_normal((B, 3, S, S),
                                                     dtype=np.float32)
    feed = {"input": torch.from_numpy(xn.transpose(0, 2, 3, 1).copy()).to(
        dev)}

    def imported():
        return sd.output(feed, [lv.name])[lv.name].tensor()

    got = imported()
    want = eval_logits(net, torch.from_numpy(xn).to(dev), "fc")
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got.argmax(1) == want.argmax(1)).double().mean())
    need(rel <= IMPORT_LOGIT_REL and top1 == 1.0,
         f"20(e): imported logits {rel:.3e} of the max-abs from the native "
         f"net's (bar {IMPORT_LOGIT_REL}), top-1 {top1}")
    out = {"graph_bytes": len(data), "import_s": import_s,
           "ops": len(sd._ops), "logits_rel_max_abs": rel,
           "top1_agreement": top1,
           "imported_ms": wall_ms(imported, cfg["reps"]),
           "phase19a_onnx_ms": onnx["imported_ms"],
           "phase19a_native_ms": onnx["native_ms"]}
    out["imported_kernels"], out["imported_busy_ms"] = \
        traced_device_work(imported)
    out["phase19a_onnx_kernels"] = onnx["imported_kernels"]
    log("20(e) TF ResNet-50: " + json.dumps(out))
    del sd, net, data
    return out


def detection_import_phase(dev, onnx):
    """Phase 20: (a) YOLO2 trains at 416^2, (b) the rest of the 2-d zoo,
    (c) C3D and the 3-d layers, (d) Keras import with no h5py and no
    tensorflow, (e) TF frozen-graph import; f32 parity with TF32 off.
    K1 launches in (d)(ii) only."""
    import torch

    t = time.perf_counter()
    before = kernel_launches()
    out = {"yolo2": yolo_main(dev, YOLO_MAIN)}
    gc.collect()
    torch.cuda.empty_cache()
    out["zoo"] = zoo_rest(dev, ZOO_REST, ZOO_REST_STEPS)
    out["c3d"] = c3d_phase(dev, C3D)
    gc.collect()
    torch.cuda.empty_cache()
    need(kernel_launches() == before, "phase 20: a hand-written kernel "
         f"launched in (a)-(c): {before} -> {kernel_launches()}")
    out["keras_resnet"] = keras_resnet(dev, KERAS_RESNET)
    gc.collect()
    torch.cuda.empty_cache()
    out["keras_mha"] = keras_mha(dev, KERAS_MHA)
    out["tf_resnet"] = tf_resnet(dev, TF_RESNET, onnx)
    out["seconds"] = time.perf_counter() - t
    log(f"phase 20: {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------------------
# phase 21: word vectors and nearest neighbours
# ----------------------------------------------------------------------

#: text8 at word2vec.c's -min-count 5 keeps 71,290 words; the corpus is
#: synthetic (flagged), Zipf-distributed and topic-structured, 4 M tokens
#: of text8's 17 M
TEXT8 = dict(vocab=71_290, tokens=4_000_000, topics=100, function_words=50,
             sentence=20, min_count=5, seed=SEED)


def synthetic_text8(cfg):
    """A seeded topic-structured Zipf corpus (synthetic, standing in for
    text8): word "w<r>" has rank r and count max(5, A / (r + 1)) with A
    set so the counts sum to `tokens`; every word of rank >= function_words
    belongs to topic r % topics and its tokens fill sentences of that
    topic only; the function words' tokens fall into random sentences.
    -> (sentences, topic of each rank (-1: function word), counts)"""
    rng = np.random.default_rng(cfg["seed"])
    V = cfg["vocab"]
    r = np.arange(V)
    lo, hi = 1.0, 1e12
    for _ in range(100):
        mid = (lo + hi) / 2
        if np.maximum(cfg["min_count"], (mid / (r + 1)).astype(np.int64)
                      ).sum() >= cfg["tokens"]:
            hi = mid
        else:
            lo = mid
    counts = np.maximum(cfg["min_count"], (hi / (r + 1)).astype(np.int64))
    topic = np.where(r < cfg["function_words"], -1, r % cfg["topics"])
    tok = np.repeat(r, counts)
    fn = topic[tok] < 0
    tt = tok[~fn]
    tt = tt[np.lexsort((rng.random(tt.size), topic[tt]))]
    sizes = np.bincount(topic[tt], minlength=cfg["topics"])
    starts = np.cumsum(sizes) - sizes
    pos = np.arange(tt.size) - np.repeat(starts, sizes)
    per = -(-sizes // cfg["sentence"])
    sid = np.repeat(np.cumsum(per) - per, sizes) + pos // cfg["sentence"]
    sid = rng.permutation(int(per.sum()))[sid]     # sentences in random order
    ft = tok[fn]
    all_t = np.concatenate([tt, ft])
    all_s = np.concatenate([sid, rng.integers(0, int(per.sum()), ft.size)])
    order = np.lexsort((rng.random(all_t.size), all_s))
    all_t, all_s = all_t[order], all_s[order]
    cuts = np.flatnonzero(np.diff(all_s)) + 1
    words = np.array([f"w{i}" for i in range(V)], dtype=object)
    sents = [" ".join(chunk) for chunk in np.split(words[all_t], cuts)]
    return sents, topic, counts


def topic_share(model, topic, probes, n=10):
    """Mean share of each probe word's n nearest words in its topic."""
    shares = []
    for w in probes:
        near = model.wordsNearest(w, n)
        shares.append(np.mean([topic[int(x[1:])] == topic[int(w[1:])]
                               for x in near]))
    return float(np.mean(shares)), [float(x) for x in shares]


#: (a) word2vec.c's demo-word.sh at text8: CBOW, -size 200, -window 8,
#: -negative 25; batch 1024, one epoch (-iter 15 and -sample 1e-4 cut).
#: The step is the reference's mean over the batch, so the rate is not
#: word2vec.c's per-pair 0.05: scripts/w2v_rate_sweep.py on the card gave
#: the probe share 0.005, 0.025, 1.0, 1.0 and 1.0 at 0.025, 1, 4, 10 and
#: 20, and a NaN loss at 50
W2V_TEXT8 = dict(layer=200, window=8, negative=25, batch=1024, lr=10.0,
                 epochs=1, probe_ranks=(50, 2050, 100), share_bar=0.8,
                 traced_steps=20, parity_steps=3)
#: (b) the other modes at (a)'s widths on a prefix of the corpus; a
#: skip-gram step moves a centre row by each of its pairs, undivided by
#: the window, so (a)'s rate diverges there within 20 steps
W2V_MODES = dict(prefix=150_000, lr=1.0, timed_steps=200, parity_steps=3,
                 infer_steps=50)
#: (c) the `fasttext skipgram` CLI defaults (Bojanowski et al. 2017), one
#: epoch of 5 on a prefix; supervised at wordNgrams 2
FASTTEXT_CLI = dict(dim=100, ws=5, neg=5, minn=3, maxn=6, bucket=2_000_000,
                    lr=0.05, min_count=5, epochs=1, prefix=100_000,
                    sup_sentences=20_000, word_ngrams=2, sup_lr=0.5,
                    parity_steps=3)
#: (d) Pennington et al. 2014: 300-d, window 10, xMax 100, alpha 0.75,
#: AdaGrad 0.05, on a prefix
GLOVE_PAPER = dict(dim=300, window=10, xmax=100.0, alpha=0.75, lr=0.05,
                   batch=4096, epochs=1, prefix=300_000, parity_steps=3)
#: (e) DL4J's CnnSentenceClassificationExample (Kim 2014) at (a)'s 200-d
#: vectors in place of Google News' 300-d
KIM_CNN = dict(widths=(3, 4, 5), maps=100, dropout=0.5, classes=2,
               maxlen=256, batch=32, steps=20, lr=1e-2)
#: (f) nearest neighbours over (a)'s vectors
NEIGHBOURS = dict(k=100, max_iter=100, hash_length=12, tables=32,
                  recall_queries=100, topk=10, vp_points=20_000,
                  server_queries=20)
#: (g) DeepWalk at BlogCatalog's widths (Perozzi et al. 2014: 10,312
#: vertices, 333,983 edges, 39 groups; d 128, window 10, walks of 40; 1
#: walk a vertex of the paper's 80) and t-SNE of (a)'s 10,000 most
#: frequent words
BLOGCATALOG = dict(vertices=10_312, edges=333_983, groups=39, within=0.8,
                   dim=128, window=10, walk=40, walks_per_vertex=1,
                   lr=1.0)
TSNE_WORDS = dict(points=10_000, perplexity=30.0, iters=1000, lr=200.0,
                  tile=2048, exact_n=2000, gate_iters=10, long_iters=50)
W2V_PARITY_REL = 1e-5      # card vs CPU tables, of their max-abs
TSNE_GATE_REL = 1e-4       # t-SNE pairs after gate_iters, of the max-abs


def _prefix(sents, tokens):
    """The first sentences holding at least `tokens` tokens."""
    n = np.cumsum([s.count(" ") + 1 for s in sents])
    return sents[:int(np.searchsorted(n, tokens)) + 1]


def _rel_to(got, want):
    import torch

    g = torch.as_tensor(np.asarray(got.detach().cpu() if torch.is_tensor(
        got) else got, np.float64))
    w = torch.as_tensor(np.asarray(want.detach().cpu() if torch.is_tensor(
        want) else want, np.float64))
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def card_vs_cpu(dev, make, tables, steps, what):
    """`steps` steps of make() on the CPU under recorded draws, then on
    the card under the same draws: the tables' max-abs rel each."""
    from deeplearning4j_tpu_torch.util.draws import Draws, ReplayDraws

    rec = Draws(SEED, "cpu", record=True)
    cpu = make().fit(device="cpu", draws=rec, steps=steps)
    card = make().fit(device=dev, draws=ReplayDraws(rec.log, dev),
                      steps=steps)
    out = {t: _rel_to(getattr(card, t), getattr(cpu, t)) for t in tables}
    need(all(v < W2V_PARITY_REL for v in out.values()),
         f"{what}: card vs CPU after {steps} steps {out} (bar "
         f"{W2V_PARITY_REL})")
    return out, cpu, card


def _timed_log(log):
    return {"steps": log.steps, "train_s": log.seconds,
            "steps_per_s": log.steps / log.seconds,
            "loss_first": log.first, "loss_last": log.last}


def word2vec_text8(dev, corpus, cfg):
    """21(a): CBOW at demo-word.sh's widths over the whole corpus."""
    import torch
    from deeplearning4j_tpu_torch.nlp import (CollectionSentenceIterator,
                                              Word2Vec)

    sents, topic, _ = corpus

    def builder():
        return (Word2Vec.Builder().minWordFrequency(TEXT8["min_count"])
                .layerSize(cfg["layer"]).windowSize(cfg["window"])
                .negativeSample(cfg["negative"]).batchSize(cfg["batch"])
                .learningRate(cfg["lr"]).iterations(cfg["epochs"])
                .seed(SEED).elementsLearningAlgorithm("cbow")
                .iterate(CollectionSentenceIterator(sents)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = builder().device(dev).build()
    t = time.perf_counter()
    m.fit()
    out = {"fit_s": time.perf_counter() - t, "scan_s": m.scanSeconds,
           "vocab": len(m.vocab)}
    out.update(_timed_log(m.trainLog))
    words = sum(len(i) for i in m._ids)
    out["words"] = words
    out["words_per_s"] = words * cfg["epochs"] / m.trainLog.seconds
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    need(out["vocab"] == TEXT8["vocab"], f"21(a): vocabulary {out['vocab']}")
    need(np.isfinite(out["loss_last"]) and
         out["loss_last"] < out["loss_first"],
         f"21(a): loss {out['loss_first']} -> {out['loss_last']}")
    probes = [f"w{r}" for r in range(*cfg["probe_ranks"])]
    out["topic_share"], out["topic_share_each"] = topic_share(m, topic,
                                                              probes)
    need(out["topic_share"] >= cfg["share_bar"],
         f"21(a): {out['topic_share']:.3f} of the probes' 10 neighbours in "
         f"their topic (bar {cfg['share_bar']})")
    par, _, _ = card_vs_cpu(dev, lambda: builder().vocabCache(m).build(),
                            ("_W", "_C"), cfg["parity_steps"], "21(a)")
    out["parity_rel"] = par
    idx = torch.arange(cfg["batch"], device=dev)
    out["kernels_per_step"], out["device_busy_share_of_traced_wall"] = \
        traced_steps(lambda: m.trainLog.step(idx, 0, 0),
                     cfg["traced_steps"])
    log("21(a) Word2Vec CBOW text8 widths: " + json.dumps(
        {k: v for k, v in out.items() if k != "topic_share_each"}))
    return m, out


def word2vec_modes(dev, corpus, cfg, wcfg):
    """21(b): skip-gram NS, skip-gram and CBOW HS, PV-DBOW, PV-DM and
    inferVector at (a)'s widths on a corpus prefix."""
    from deeplearning4j_tpu_torch.nlp import (CollectionSentenceIterator,
                                              ParagraphVectors, Word2Vec)
    from deeplearning4j_tpu_torch.util.draws import Draws, ReplayDraws

    sents = _prefix(corpus[0], cfg["prefix"])
    base = []

    def builder(cls, **kw):
        b = (cls.Builder().minWordFrequency(TEXT8["min_count"])
             .layerSize(wcfg["layer"]).windowSize(wcfg["window"])
             .negativeSample(wcfg["negative"]).batchSize(wcfg["batch"])
             .learningRate(cfg["lr"]).seed(SEED)
             .iterate(CollectionSentenceIterator(sents)))
        for k, v in kw.items():
            getattr(b, k)(v)
        if base:
            b.vocabCache(base[0])
        return b

    out = {"sentences": len(sents)}
    modes = {"skipgram_ns": (Word2Vec, dict(elementsLearningAlgorithm=
                                             "skipgram")),
             "skipgram_hs": (Word2Vec, dict(elementsLearningAlgorithm=
                                             "skipgram",
                                             useHierarchicSoftmax=True)),
             "cbow_hs": (Word2Vec, dict(elementsLearningAlgorithm="cbow",
                                        useHierarchicSoftmax=True)),
             "pv_dbow": (ParagraphVectors, dict()),
             "pv_dm": (ParagraphVectors, dict(
                 sequenceLearningAlgorithm="DM"))}
    for name, (cls, kw) in modes.items():
        m = builder(cls, **kw).device(dev).build()
        m.fit(steps=cfg["timed_steps"])
        base.append(m)
        r = _timed_log(m.trainLog)
        if getattr(m, "docTrainLog", None) is not None:
            r["doc"] = _timed_log(m.docTrainLog)
        if m.useHierarchicSoftmax:
            r["huffman_code_length"] = m.huffmanCodeLength
        tables = ("_W", "_C", "_D") if cls is ParagraphVectors \
            else ("_W", "_C")
        r["parity_rel"], cpu, card = card_vs_cpu(
            dev, lambda: builder(cls, **kw).build(), tables,
            cfg["parity_steps"], f"21(b) {name}")
        if cls is ParagraphVectors:
            text = sents[7]
            rec = Draws(SEED, "cpu", record=True)
            a = cpu.inferVector(text, steps=cfg["infer_steps"], draws=rec)
            t = time.perf_counter()
            b = card.inferVector(text, steps=cfg["infer_steps"],
                                 draws=ReplayDraws(rec.log, dev))
            r["infer_ms"] = 1e3 * (time.perf_counter() - t)
            r["infer_rel"] = _rel_to(b, a)
            need(r["infer_rel"] < W2V_PARITY_REL,
                 f"21(b) {name} inferVector card vs CPU {r['infer_rel']}")
        out[name] = r
    log("21(b) the other modes: " + json.dumps(out))
    return out


def _sentence_topics(sents, topic):
    """Each sentence's topic: its commonest non-function word topic."""
    out = []
    for s in sents:
        t = topic[[int(w[1:]) for w in s.split()]]
        t = t[t >= 0]
        out.append(int(np.bincount(t).argmax()) if t.size else 0)
    return np.asarray(out)


def fasttext_cli(dev, corpus, cfg):
    """21(c): FastText skip-gram at the CLI defaults, then supervised."""
    import torch
    from deeplearning4j_tpu_torch.nlp import (CollectionSentenceIterator,
                                              FastText)

    sents, topic, _ = corpus
    pre = _prefix(sents, cfg["prefix"])

    def builder(data, sup):
        return (FastText.Builder().supervised(sup).dim(cfg["dim"])
                .contextWindow(cfg["ws"]).negativeSamples(cfg["neg"])
                .minNgramLength(cfg["minn"]).maxNgramLength(cfg["maxn"])
                .bucket(cfg["bucket"]).minCount(cfg["min_count"])
                .wordNgrams(cfg["word_ngrams"] if sup else 1)
                .learningRate(cfg["sup_lr"] if sup else cfg["lr"])
                .epochs(cfg["epochs"]).seed(SEED)
                .iterate(CollectionSentenceIterator(data)))

    out = {}
    sup_sents = sents[-cfg["sup_sentences"]:]
    labels = _sentence_topics(sup_sents, topic) < TEXT8["topics"] // 2
    labelled = [("__label__a " if a else "__label__b ") + s
                for a, s in zip(labels, sup_sents)]
    for name, data, sup, tables in (
            ("skipgram", pre, False, ("_Win", "_G", "_C", "_W")),
            ("supervised", labelled, True, ("_E", "_L", "_b"))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m = builder(data, sup).device(dev).build()
        t = time.perf_counter()
        m.fit()
        r = {"fit_s": time.perf_counter() - t, "vocab": len(m.vocab)}
        r.update(_timed_log(m.trainLog))
        r["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        need(np.isfinite(r["loss_last"]), f"21(c) {name}: loss {r}")
        if sup:
            guess = [m.predict(s.split(" ", 1)[1]) for s in labelled[:500]]
            r["train_accuracy_500"] = float(np.mean(
                [g == ("a" if a else "b") for g, a in zip(guess,
                                                          labels[:500])]))
        else:
            r["words_per_s"] = sum(len(s) for s in m._sents) \
                / m.trainLog.seconds
        del m
        r["parity_rel"], _, _ = card_vs_cpu(
            dev, lambda: builder(data, sup).build(), tables,
            cfg["parity_steps"], f"21(c) {name}")
        out[name] = r
    log("21(c) FastText CLI widths: " + json.dumps(out))
    return out


def glove_objective(m, p, cfg):
    """GloVe's weighted least squares, mean over every entry."""
    import torch
    from deeplearning4j_tpu_torch.nlp.glove import cooccurrences

    ii, jj, xx = cooccurrences(m._ids, cfg["window"])
    dev = p["W"].device
    i = torch.as_tensor(ii, dtype=torch.int64, device=dev)
    j = torch.as_tensor(jj, dtype=torch.int64, device=dev)
    x = torch.as_tensor(xx, device=dev)
    f = torch.clamp((x / cfg["xmax"]) ** cfg["alpha"], max=1.0)
    with torch.no_grad():
        err = ((p["W"][i] * p["Wt"][j]).sum(-1) + p["b"][i] + p["bt"][j]
               - torch.log(x))
        return float((f * err * err).mean())


def glove_paper(dev, corpus, cfg):
    """21(d): GloVe at the paper's settings on a prefix."""
    import torch
    from deeplearning4j_tpu_torch.nlp import CollectionSentenceIterator, Glove
    from deeplearning4j_tpu_torch.util.draws import Draws

    pre = _prefix(corpus[0], cfg["prefix"])

    def builder():
        return (Glove.Builder().minWordFrequency(TEXT8["min_count"])
                .layerSize(cfg["dim"]).windowSize(cfg["window"])
                .xMax(cfg["xmax"]).alpha(cfg["alpha"])
                .learningRate(cfg["lr"]).batchSize(cfg["batch"])
                .epochs(cfg["epochs"]).seed(SEED)
                .iterate(CollectionSentenceIterator(pre)))

    m = builder().device(dev).build()
    t = time.perf_counter()
    m.fit()
    out = {"fit_s": time.perf_counter() - t, "vocab": len(m.vocab),
           "cooccurrence_s": m.cooccurrenceSeconds,
           "entries": m.cooccurrenceEntries}
    out.update(_timed_log(m.trainLog))
    # the objective over every entry, at the start (the same first draws)
    # and after the epoch
    V, D = len(m.vocab), cfg["dim"]
    start = Draws(SEED, dev)
    scale = np.float32(0.5 / D)
    p0 = {k: start.uniform(f"glove.{k}", (V, D)) * (2 * scale) - scale
          for k in ("W", "Wt")}
    p0["b"] = p0["bt"] = torch.zeros(V, device=dev)
    out["objective_start"] = glove_objective(m, p0, cfg)
    out["objective_end"] = glove_objective(m, m._params, cfg)
    need(out["objective_end"] < out["objective_start"],
         f"21(d): objective {out['objective_start']} -> "
         f"{out['objective_end']}")
    out["parity_rel"], _, _ = card_vs_cpu(
        dev, lambda: builder().vocabCache(m).build(), ("_W", "_C"),
        cfg["parity_steps"], "21(d)")
    log("21(d) GloVe paper settings: " + json.dumps(out))
    return out


def kim_cnn_conf(cfg, D):
    from deeplearning4j_tpu_torch import nn as M

    g = (M.NeuralNetConfiguration.Builder().seed(SEED)
         .updater(M.Adam(cfg["lr"])).weightInit(M.WeightInit.RELU)
         .graphBuilder().addInputs("input"))
    names = []
    for w in cfg["widths"]:
        g = g.addLayer(f"cnn{w}", M.ConvolutionLayer(
            nOut=cfg["maps"], kernelSize=(w, D), stride=(1, D),
            convolutionMode="same", activation="relu"), "input")
        names.append(f"cnn{w}")
    return (g.addVertex("merge", M.MergeVertex(), *names)
            .addLayer("pool", M.GlobalPoolingLayer(poolingType="max"),
                      "merge")
            .addLayer("drop", M.DropoutLayer(cfg["dropout"]), "pool")
            .addLayer("out", M.OutputLayer(nOut=cfg["classes"],
                                           activation="softmax",
                                           lossFunction="mcxent"), "drop")
            .setOutputs("out")
            .setInputTypes(M.InputType.convolutional(cfg["maxlen"], D, 1))
            .build())


def into_the_stack(dev, corpus, m, cfg):
    """21(e): serializer round trips, WeightInitEmbedding, and a Kim CNN
    sentence classifier fed by CnnSentenceDataSetIterator."""
    import tempfile

    import torch
    from deeplearning4j_tpu_torch import nn as M
    from deeplearning4j_tpu_torch.nlp import (
        CnnSentenceDataSetIterator, CollectionLabeledSentenceProvider,
        WordVectorSerializer)

    W = m._matrix()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, write, read in (
                ("binary", WordVectorSerializer.writeBinaryModel,
                 WordVectorSerializer.readBinaryModel),
                ("text", WordVectorSerializer.writeWordVectors,
                 WordVectorSerializer.loadTxtVectors)):
            path = os.path.join(tmp, "vectors." + fmt)
            t = time.perf_counter()
            write(m, path)
            tw = time.perf_counter() - t
            t = time.perf_counter()
            back = read(path)
            tr = time.perf_counter() - t
            need(back._ivocab == m._ivocab, f"21(e) {fmt}: vocabulary")
            if fmt == "binary":
                need(np.array_equal(back._W, W), "21(e) binary not exact")
            else:
                # %.6g: 5e-6 of the value, then the f32 parse
                need(np.allclose(back._W, W, rtol=5.1e-6, atol=0),
                     "21(e) text beyond its printed digits")
            out[fmt] = {"bytes": os.path.getsize(path), "write_s": tw,
                        "read_s": tr}
    V, D = W.shape
    conf = (M.NeuralNetConfiguration.Builder().seed(SEED).list()
            .layer(M.EmbeddingSequenceLayer(
                nIn=V, nOut=D, weightInit=M.WeightInitEmbedding(m)))
            .layer(M.GlobalPoolingLayer(poolingType="avg"))
            .layer(M.OutputLayer(nOut=2, activation="softmax"))
            .setInputType(M.InputType.recurrent(1, 16)).build())
    net = M.MultiLayerNetwork(conf, device=dev).init()
    need(np.array_equal(net.getParam("0_W").toNumpy(), W),
         "21(e): WeightInitEmbedding's table is not the model's W")
    out["embedding_table_bitwise"] = True
    del net
    sents, topic, _ = corpus
    n = cfg["batch"] * cfg["steps"]
    pick = sents[:n]
    labels = ["a" if t < TEXT8["topics"] // 2 else "b"
              for t in _sentence_topics(pick, topic)]
    t = time.perf_counter()
    it = (CnnSentenceDataSetIterator.Builder()
          .sentenceProvider(CollectionLabeledSentenceProvider(pick, labels))
          .wordVectors(m).maxSentenceLength(cfg["maxlen"])
          .minibatchSize(cfg["batch"]).format("CNN").build())
    out["iterator_s"] = time.perf_counter() - t
    cg = M.ComputationGraph(kim_cnn_conf(cfg, D), device=dev).init()
    ms, losses = [], []
    for ds in it:
        torch.cuda.synchronize()
        t = time.perf_counter()
        cg.fit(ds)
        losses.append(float(cg.score()))
        ms.append(1e3 * (time.perf_counter() - t))
    need(len(losses) == cfg["steps"], f"21(e): {len(losses)} steps")
    need(all(np.isfinite(losses)) and np.mean(losses[-5:])
         < np.mean(losses[:5]), f"21(e): Kim CNN loss {losses}")
    step = float(np.median(ms[2:]))
    out["kim_cnn"] = {"step_ms_median_3_on": step,
                      "sentences_per_s": cfg["batch"] * 1e3 / step,
                      "loss_first5": float(np.mean(losses[:5])),
                      "loss_last5": float(np.mean(losses[-5:]))}
    log("21(e) word vectors into the stack: " + json.dumps(out))
    return out


def nearest_neighbours(dev, m, cfg):
    """21(f): k-means, LSH, VPTree and NearestNeighborsServer over (a)'s
    vectors."""
    import torch
    from deeplearning4j_tpu_torch.clustering import (
        KMeansClustering, NearestNeighbors, NearestNeighborsServer,
        RandomProjectionLSH, VPTree)
    from deeplearning4j_tpu_torch.util.draws import Draws, ReplayDraws

    X = m._matrix()
    out = {}
    rec = Draws(SEED, "cpu", record=True)
    cpu = KMeansClustering.setup(cfg["k"], cfg["max_iter"]).applyTo(
        X, device="cpu", draws=rec)
    km = KMeansClustering.setup(cfg["k"], cfg["max_iter"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = km.applyTo(X, device=dev, draws=ReplayDraws(rec.log, "cpu"))
    out["kmeans"] = {"ms": 1e3 * (time.perf_counter() - t),
                     "iterations": km.iterations,
                     "host_flag_reads": km.hostFlagReads,
                     "inertia": card.inertia, "inertia_cpu": cpu.inertia,
                     "assignments_differ": int(np.sum(
                         card.getAssignments() != cpu.getAssignments()))}
    need(out["kmeans"]["assignments_differ"] == 0,
         f"21(f): k-means assignments card vs CPU {out['kmeans']}")
    lsh = RandomProjectionLSH(cfg["hash_length"], cfg["tables"], X.shape[1])
    torch.cuda.synchronize()
    t = time.perf_counter()
    lsh.index(X, device=dev)
    idx_ms = 1e3 * (time.perf_counter() - t)
    q = X[np.linspace(0, X.shape[0] - 1, cfg["recall_queries"]).astype(int)]
    brute, _ = NearestNeighbors(X, device=dev).search(q, cfg["topk"])
    hits, cand = [], []
    for row, want in zip(q, brute):
        got, _ = lsh.search(row, cfg["topk"])
        hits.append(len(set(got.tolist()) & set(want.tolist())))
        cand.append(lsh.bucket(row).size)
    out["lsh"] = {"index_ms": idx_ms, "hash_length": cfg["hash_length"],
                  "tables": cfg["tables"],
                  "recall_at_10": float(np.mean(hits)) / cfg["topk"],
                  "mean_candidates": float(np.mean(cand))}
    sub = X[:cfg["vp_points"]].astype(np.float64)
    t = time.perf_counter()
    vp = VPTree(sub)
    build_s = time.perf_counter() - t
    rs = np.random.RandomState(SEED)
    for i in rs.choice(sub.shape[0], 20, replace=False):
        got, _ = vp.search(sub[i] + 1e-3, cfg["topk"])
        d = np.linalg.norm(sub - (sub[i] + 1e-3), axis=1)
        need(got.tolist() == np.argsort(d, kind="stable")[:cfg["topk"]]
             .tolist(), "21(f): VPTree kNN differs from brute force")
    out["vptree"] = {"points": sub.shape[0], "build_s": build_s}
    srv = NearestNeighborsServer(points=sub).start(port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        code, raw = http(srv.port, "/status")
        st = json.loads(raw)
        need(code == 200 and st == {"numPoints": sub.shape[0],
                                    "dims": sub.shape[1], "index": "VPTree"},
             f"21(f): /status {code} {st}")
        lat = []
        for i in rs.choice(sub.shape[0], cfg["server_queries"],
                           replace=False):
            for route, body, target, drop in (
                    ("/knn", {"index": int(i), "k": cfg["topk"]}, sub[i],
                     True),
                    ("/knnnew", {"point": (sub[i] + 0.01).tolist(),
                                 "k": cfg["topk"]}, sub[i] + 0.01, False)):
                t = time.perf_counter()
                code, raw = http(srv.port, route, body)
                lat.append(1e3 * (time.perf_counter() - t))
                resp = json.loads(raw)
                d = np.linalg.norm(sub - target, axis=1)
                want = [j for j in np.argsort(d, kind="stable")
                        if not (drop and j == i)][:cfg["topk"]]
                need(code == 200 and [r["index"] for r in resp["results"]]
                     == [int(j) for j in want],
                     f"21(f): {route} {i} differs from brute force")
        code_400, _ = http(srv.port, "/knnnew", {"point": [1.0], "k": 3})
        code_404, _ = http(srv.port, "/nope", {})
        need((code_400, code_404) == (400, 404),
             f"21(f): error codes {code_400}, {code_404}")
        out["server"] = {"queries": len(lat), "p50_ms": float(
            np.median(lat)), "max_ms": float(np.max(lat)),
            "codes": [200, code_400, code_404], "url": base}
    finally:
        srv.stop()
    log("21(f) nearest neighbours: " + json.dumps(out))
    return out


def blogcatalog_graph(cfg):
    """A seeded graph at BlogCatalog's size (synthetic): 39 groups,
    a share `within` of each edge's ends in one group."""
    from deeplearning4j_tpu_torch.graph import Graph

    rng = np.random.default_rng(SEED)
    n, E = cfg["vertices"], cfg["edges"]
    group = rng.integers(0, cfg["groups"], n)
    members = [np.flatnonzero(group == g) for g in range(cfg["groups"])]
    seen, edges = set(), []
    while len(edges) < E:
        a = rng.integers(0, n, 2 * E)
        same = rng.random(2 * E) < cfg["within"]
        b = rng.integers(0, n, 2 * E)
        for x, y, s in zip(a.tolist(), b.tolist(), same.tolist()):
            if s:
                mem = members[group[x]]
                y = int(mem[y % mem.size])
            key = (min(x, y), max(x, y))
            if x == y or key in seen:
                continue
            seen.add(key)
            edges.append(key)
            if len(edges) == E:
                break
    g = Graph(n)
    for x, y in edges:
        g.addEdge(x, y)
    return g


def tsne_kl(Y, rows, cols, vals):
    """KL(P || Q) of a sparse P at the embedding Y (Q over all pairs)."""
    import torch

    with torch.no_grad():
        sq = (Y * Y).sum(1)
        num = 1.0 / (1.0 + torch.clamp(sq[:, None] + sq[None, :]
                                       - 2.0 * Y @ Y.T, min=0.0))
        num.fill_diagonal_(0.0)
        S = num.sum()
        r = torch.as_tensor(rows, device=Y.device, dtype=torch.int64)
        c = torch.as_tensor(cols, device=Y.device, dtype=torch.int64)
        p = torch.as_tensor(vals, device=Y.device)
        q = num[r, c] / S
        return float((p * (torch.log(p) - torch.log(q))).sum())


def graph_and_tsne(dev, m, gcfg, tcfg):
    """21(g): DeepWalk at BlogCatalog's widths; t-SNE of (a)'s words."""
    import torch
    from deeplearning4j_tpu_torch.graph import DeepWalk
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne
    from deeplearning4j_tpu_torch.util.draws import Draws, ReplayDraws

    out = {}
    t = time.perf_counter()
    g = blogcatalog_graph(gcfg)
    graph_s = time.perf_counter() - t
    dw = (DeepWalk.Builder().vectorSize(gcfg["dim"])
          .windowSize(gcfg["window"]).learningRate(gcfg["lr"]).seed(SEED)
          .device(dev).build())
    t = time.perf_counter()
    dw.fit(g, walkLength=gcfg["walk"],
           walksPerVertex=gcfg["walks_per_vertex"], iterations=1)
    w2v = dw._w2v
    words = sum(len(i) for i in w2v._ids)
    out["deepwalk"] = {"graph_s": graph_s, "walk_s": dw.walkSeconds,
                       "fit_s": time.perf_counter() - t, "words": words,
                       "words_per_s": words / w2v.trainLog.seconds}
    out["deepwalk"].update(_timed_log(w2v.trainLog))
    need(np.isfinite(out["deepwalk"]["loss_last"]),
         f"21(g) DeepWalk loss {out['deepwalk']}")
    X = m._matrix()[:tcfg["points"]]
    ts = (BarnesHutTsne.Builder().setMaxIter(tcfg["iters"])
          .perplexity(tcfg["perplexity"]).learningRate(tcfg["lr"])
          .tileSize(tcfg["tile"]).seed(SEED).device(dev).build())
    torch.cuda.synchronize()
    t = time.perf_counter()
    ts.fit(X)
    fit_s = time.perf_counter() - t
    rows, cols, vals = ts._P_sparse
    y0 = 1e-4 * Draws(SEED, dev).normal("tsne.Y0", (X.shape[0], 2))
    out["tsne"] = {"method": ts.usedMethod, "points": X.shape[0],
                   "affinity_s": ts.affinitySeconds,
                   "ms_per_iteration": 1e3 * (fit_s - ts.affinitySeconds)
                   / tcfg["iters"],
                   "kl_start": tsne_kl(y0, rows, cols, vals),
                   "kl_end": tsne_kl(torch.as_tensor(ts.getData(),
                                                     device=dev),
                                     rows, cols, vals)}
    need(ts.usedMethod == "tiled" and
         out["tsne"]["kl_end"] < out["tsne"]["kl_start"],
         f"21(g) t-SNE {out['tsne']}")
    X2 = X[:tcfg["exact_n"]]
    n2 = X2.shape[0]

    def run(method, iters, device, draws=None, **kw):
        b = (BarnesHutTsne.Builder().setMaxIter(iters)
             .perplexity(tcfg["perplexity"]).learningRate(tcfg["lr"])
             .seed(SEED).method(method))
        for k, v in kw.items():
            getattr(b, k)(v)
        return b.build().fit(X2, device=device, draws=draws).getData()

    for iters in (tcfg["gate_iters"], tcfg["long_iters"]):
        ex = run("exact", iters, dev)
        ti = run("tiled", iters, dev, knnK=n2 - 1, tileSize=tcfg["tile"])
        out["tsne"][f"exact_vs_tiled_rel_{iters}"] = _rel_to(ti, ex)
        rec = Draws(SEED, "cpu", record=True)
        cpu = run("exact", iters, "cpu", rec)
        card = run("exact", iters, dev, ReplayDraws(rec.log, dev))
        out["tsne"][f"card_vs_cpu_rel_{iters}"] = _rel_to(card, cpu)
    gi = tcfg["gate_iters"]
    need(out["tsne"][f"exact_vs_tiled_rel_{gi}"] < TSNE_GATE_REL
         and out["tsne"][f"card_vs_cpu_rel_{gi}"] < TSNE_GATE_REL,
         f"21(g) t-SNE after {gi} iterations {out['tsne']}")
    log("21(g) DeepWalk and t-SNE: " + json.dumps(out))
    return out


def word_vectors_phase(dev):
    """Phase 21: (a)-(g). No hand-written kernel launches."""
    import torch

    t = time.perf_counter()
    before = kernel_launches()
    corpus = synthetic_text8(TEXT8)
    out = {"corpus": {"sentences": len(corpus[0]),
                      "tokens": int(corpus[2].sum()),
                      "seconds": time.perf_counter() - t}}
    log("21 corpus (synthetic, seeded): " + json.dumps(out["corpus"]))
    legs = {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        legs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return r

    m, out["word2vec"] = leg("a", word2vec_text8, dev, corpus, W2V_TEXT8)
    out["modes"] = leg("b", word2vec_modes, dev, corpus, W2V_MODES,
                       W2V_TEXT8)
    out["fasttext"] = leg("c", fasttext_cli, dev, corpus, FASTTEXT_CLI)
    out["glove"] = leg("d", glove_paper, dev, corpus, GLOVE_PAPER)
    out["stack"] = leg("e", into_the_stack, dev, corpus, m, KIM_CNN)
    out["neighbours"] = leg("f", nearest_neighbours, dev, m, NEIGHBOURS)
    out["graph_tsne"] = leg("g", graph_and_tsne, dev, m, BLOGCATALOG,
                            TSNE_WORDS)
    out["leg_seconds"] = legs
    need(kernel_launches() == before, "phase 21: a hand-written kernel "
         f"launched: {before} -> {kernel_launches()}")
    out["seconds"] = time.perf_counter() - t
    log(f"phase 21: {out['seconds']:.1f} s (legs " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()) + ")")
    return out


# ----------------------------------------------------------------------
# phase 22: reinforcement learning, hyperparameter search, the profiler
# ----------------------------------------------------------------------

#: 22(a): the Nature DQN (Mnih et al. 2015, "Human-level control through
#: deep reinforcement learning", Methods): 84x84 frames, 4 stacked, conv
#: 32 8x8/4 -> 64 4x4/2 -> 64 3x3/1 -> dense 512, relu, one identity
#: output an action (6), RMSProp at 2.5e-4, batch 32, gamma 0.99, frame
#: skip 4, the TD error clipped to 1, double DQN. Cut: the replay (1 M ->
#: 5,000 transitions), the start of learning (50,000 -> 500 steps), the
#: target sync (10,000 -> 1,000 steps), the run (50 M frames -> 1,000
#: steps) and epsilon's anneal (1 M frames -> 1,000 steps, to 0.1)
NATURE_DQN = dict(image=84, history=4, skip=4, actions=6, batch=32,
                  gamma=0.99, lr=2.5e-4, replay=5000, update_start=500,
                  target_every=1000, steps=1000, epsilon_steps=1000,
                  min_epsilon=0.1, balls=5, traced_steps=5,
                  profiled_steps=20, parity_replay=256, parity_steps=3,
                  seed=SEED)
#: one image's multiply-adds through NATURE_DQN's products: the convs
#: (20x20x32 x 8x8x4, 9x9x64 x 4x4x32, 7x7x64 x 3x3x64), dense, output
NATURE_DQN_MACS = 3_276_800 + 2_654_208 + 1_806_336 + 1_605_632 + 3_072
#: 22(a) and (b) card vs CPU, of each tensor's max-abs
RL_PARITY_REL = 1e-5
#: 22(b): A3C and n-step Q at the reference's defaults (hidden 32, 8
#: environments, nStep 8) on CartPole-v1 dynamics, and A3C at 64
CARTPOLE = dict(hidden=32, envs=8, wide_envs=64, nstep=8, updates=300,
                wide_updates=100, traced=3, episode=500, seed=SEED)
#: 22(c): the reference tests' chain task and budgets
#: (tests/test_rl.py:74, tests/test_rl_breadth.py:113, :154)
CHAIN = dict(n=5, dqn_steps=2500, ac_steps=12_000)
#: 22(d): Arbiter over LeNet at DL4J's LeNetMNIST widths (conv 20 and 50
#: 5x5, max pooling 2x2, dense 500), seeded synthetic 28x28 digits
ARBITER_LENET = dict(train=6000, test=1000, batch=64, classes=10,
                     random=6, population=6, generations=2, graph=2,
                     time_budget=3.0, seed=SEED)


class CatchMDP:
    """A seeded 84x84 "catch" game for 22(a) (ALE does not ship on the
    card's machine): a 2x2 ball falls 2 rows a frame from a random column
    of the top row; an 8-pixel paddle on the bottom two rows moves 2
    pixels a frame right (actions 2, 4), left (3, 5) or not (0, 1); +1
    when the ball reaches the bottom over the paddle, -1 when it does not;
    an episode is `balls` balls."""

    PADDLE = 8

    def __init__(self, cfg, seed):
        self.n, self.balls, self.actions = (cfg["image"], cfg["balls"],
                                            cfg["actions"])
        self._rng = np.random.RandomState(seed)
        self.frames = 0

    def obsSize(self):
        return self.n * self.n

    def numActions(self):
        return self.actions

    def _new_ball(self):
        self.by, self.bx = 0, int(self._rng.randint(0, self.n - 1))

    def _frame(self):
        f = np.zeros((self.n, self.n), np.float32)
        f[self.by:self.by + 2, self.bx:self.bx + 2] = 1.0
        f[self.n - 2:, self.px:self.px + self.PADDLE] = 1.0
        return f

    def reset(self):
        self.px = (self.n - self.PADDLE) // 2
        self.left = self.balls
        self._new_ball()
        return self._frame()

    def step(self, action):
        move = (0, 0, 2, -2, 2, -2)[int(action)]
        self.px = min(max(self.px + move, 0), self.n - self.PADDLE)
        self.by += 2
        self.frames += 1
        reward, done = 0.0, False
        if self.by >= self.n - 2:
            caught = self.px - 1 <= self.bx <= self.px + self.PADDLE - 1
            reward = 1.0 if caught else -1.0
            self.left -= 1
            done = self.left == 0
            self._new_ball()
        return self._frame(), reward, done


def nature_dqn_net(device, cfg):
    from deeplearning4j_tpu_torch.nn import (ConvolutionLayer, DenseLayer,
                                             InputType, MultiLayerNetwork,
                                             NeuralNetConfiguration,
                                             OutputLayer, RmsProp)

    conf = (NeuralNetConfiguration.Builder().seed(cfg["seed"])
            .updater(RmsProp(cfg["lr"])).list()
            .layer(ConvolutionLayer(nOut=32, kernelSize=(8, 8),
                                    stride=(4, 4), activation="relu"))
            .layer(ConvolutionLayer(nOut=64, kernelSize=(4, 4),
                                    stride=(2, 2), activation="relu"))
            .layer(ConvolutionLayer(nOut=64, kernelSize=(3, 3),
                                    stride=(1, 1), activation="relu"))
            .layer(DenseLayer(nOut=512, activation="relu"))
            .layer(OutputLayer(nOut=cfg["actions"], activation="identity",
                               lossFunction="mse"))
            .setInputType(InputType.convolutional(
                cfg["image"], cfg["image"], cfg["history"])).build())
    return MultiLayerNetwork(conf, device=device).init()


def nature_dqn_trainer(net, cfg):
    from deeplearning4j_tpu_torch.rl import (HistoryProcessorConfiguration,
                                             QLearningConfiguration,
                                             QLearningDiscreteConv)

    conf = QLearningConfiguration(
        seed=cfg["seed"], gamma=cfg["gamma"], batchSize=cfg["batch"],
        expRepMaxSize=cfg["replay"], targetDqnUpdateFreq=cfg["target_every"],
        updateStart=cfg["update_start"], minEpsilon=cfg["min_epsilon"],
        epsilonNbStep=cfg["epsilon_steps"], maxEpochStep=200,
        doubleDQN=True, errorClamp=1.0)
    hp = HistoryProcessorConfiguration(historyLength=cfg["history"],
                                       skipFrame=cfg["skip"])
    return QLearningDiscreteConv(CatchMDP(cfg, cfg["seed"]), net, hp, conf)


def random_play(trainer, n, seed):
    """`n` transitions of uniformly random play through the trainer's
    frame ring, in its replay's form."""
    rng = np.random.RandomState(seed)
    items, obs = [], trainer._reset_env()
    while len(items) < n:
        a = int(rng.randint(trainer.mdp.numActions()))
        obs2, r, done = trainer._step_env(a)
        items.append((obs, a, float(r), obs2, float(done)))
        obs = trainer._reset_env() if done else obs2
    return items


def max_rel(got, want):
    """The worst max-abs rel over same-structured lists of tensor dicts."""
    return max(_rel_to(g[k], w[k]) for g, w in zip(got, want) for k in w)


def dqn_parity(dev, cfg):
    """22(a) parity: the card and the CPU from the same weights, replay
    and RandomState draws: Q-values, the first learn step's TD targets
    and gradients, and the parameters after `parity_steps` learn steps."""
    from deeplearning4j_tpu_torch.nn.multilayer import params_to_reference

    net, cpu = nature_dqn_net(dev, cfg), nature_dqn_net("cpu", cfg)
    cpu.load_reference_params(params_to_reference(net.layers, net._params),
                              params_to_reference(net.layers, net._states))
    card_t, cpu_t = nature_dqn_trainer(net, cfg), nature_dqn_trainer(cpu, cfg)
    replay = random_play(cpu_t, cfg["parity_replay"], cfg["seed"] + 1)
    card_t._replay, cpu_t._replay = list(replay), list(replay)
    s = np.stack([it[0] for it in replay[:cfg["batch"]]])
    q_rel = _rel_to(card_t._q(net._params, s), cpu_t._q(cpu._params, s))
    first = {}

    def record(t, key):
        fit = t.net.fit

        def rec(x, y):
            if key not in first:
                first[key] = (np.array(y),
                              t.net.computeGradientAndScore(x, y)[0])
            return fit(x, y)

        t.net.fit = rec

    record(card_t, "card")
    record(cpu_t, "cpu")
    for _ in range(cfg["parity_steps"]):
        card_t._learn_batch()
        cpu_t._learn_batch()
    out = {"q_rel": q_rel,
           "td_targets_rel": _rel_to(first["card"][0], first["cpu"][0]),
           "first_grads_rel": max_rel(first["card"][1], first["cpu"][1]),
           "rmsprop_steps": cfg["parity_steps"],
           "params_rel_after_rmsprop_steps": max_rel(net._params,
                                                     cpu._params)}
    need(max(out["q_rel"], out["td_targets_rel"], out["first_grads_rel"])
         <= RL_PARITY_REL, f"22(a) parity: {out} (bar {RL_PARITY_REL} of "
         "the max-abs)")
    return out


def copy_traffic(fn, steps):
    """`steps` calls of `fn` under a TorchDispatchMode that sees every
    aten copy as it runs: (host->device copies, their bytes, device->host
    reads: copies to the host and scalar reads) a call."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    n = {"h2d_copies": 0, "h2d_bytes": 0, "d2h_reads": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._local_scalar_dense.default:
                n["d2h_reads"] += args[0].device.type == "cuda"
            elif func in (aten._to_copy.default, aten.copy_.default):
                src, dst = ((args[1], args[0]) if func is aten.copy_.default
                            else (args[0], out))
                way = (src.device.type, dst.device.type)
                if way == ("cpu", "cuda"):
                    n["h2d_copies"] += 1
                    n["h2d_bytes"] += src.numel() * src.element_size()
                elif way == ("cuda", "cpu"):
                    n["d2h_reads"] += 1
            return out

    with Count():
        for _ in range(steps):
            fn()
    return {k: v / steps for k, v in n.items()}


def learn_host_split(dqn, dev, reps):
    """A learn step's batch handling alone, median ms over `reps`: the
    two np.stack calls of 32 sampled observations each, and the four
    unpinned copies of them to the card (s' twice, s twice) to a
    synchronize."""
    import torch

    rng = np.random.RandomState(1)
    stack, h2d = [], []
    for _ in range(reps):
        idx = rng.randint(len(dqn._replay), size=dqn.conf.batchSize)
        t0 = time.perf_counter()
        s = np.stack([dqn._replay[i][0] for i in idx])
        s2 = np.stack([dqn._replay[i][3] for i in idx])
        t1 = time.perf_counter()
        for a in (s2, s2, s, s):
            torch.from_numpy(a).to(dev)
        torch.cuda.synchronize()
        stack.append(t1 - t0)
        h2d.append(time.perf_counter() - t1)
    return {"stack_ms": float(np.median(stack)) * 1e3,
            "h2d_ms": float(np.median(h2d)) * 1e3}


def nature_dqn(dev, cfg):
    """22(a): the Nature DQN trains `steps` steps of catch on the card:
    env steps/s, learn steps/s, the median learn step, kernels a learn
    step and the busy share of a traced block, peak memory; parity."""
    import torch

    t0 = time.perf_counter()
    parity = dqn_parity(dev, cfg)
    parity["seconds"] = time.perf_counter() - t0
    log("22(a) parity: " + json.dumps(parity))
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dqn = nature_dqn_trainer(nature_dqn_net(dev, cfg), cfg)
    learn_s = []
    learn = dqn._learn_batch

    def timed():
        t0 = time.perf_counter()
        learn()
        learn_s.append(time.perf_counter() - t0)

    dqn._learn_batch = timed
    t0 = time.perf_counter()
    dqn.train(maxSteps=cfg["steps"])
    wall = time.perf_counter() - t0
    del dqn._learn_batch
    n_learn = len(learn_s)
    need(n_learn == cfg["steps"] - max(cfg["update_start"],
                                       cfg["batch"]) + 1,
         f"22(a): {n_learn} learn steps in {cfg['steps']} steps")
    t0 = time.perf_counter()
    kernels, busy = traced_steps(dqn._learn_batch, cfg["traced_steps"])
    traced_s = time.perf_counter() - t0
    traffic = copy_traffic(dqn._learn_batch, cfg["traced_steps"])
    B, img = cfg["batch"], cfg["history"] * cfg["image"] ** 2 * 4
    # s' twice and s twice (the three Q reads and fit), then the targets
    want = 4 * B * img + B * cfg["actions"] * 4
    need(traffic["h2d_bytes"] == want, f"22(a): {traffic} host->device "
         f"a learn step, {want} bytes from the shapes")
    unique = {id(a): a.nbytes for it in dqn._replay for a in (it[0], it[3])}
    score = dqn.getPolicy().play(CatchMDP(cfg, cfg["seed"] + 7),
                                 maxSteps=1000)
    out = {"parity": parity, "steps": cfg["steps"],
           "frames": dqn.mdp.frames, "learn_steps": n_learn,
           "wall_s": wall, "env_steps_per_s": cfg["steps"] / wall,
           "env_steps_per_s_outside_learning":
               cfg["steps"] / (wall - sum(learn_s)),
           "learn_steps_per_s": n_learn / sum(learn_s),
           "learn_ms_median": float(np.median(learn_s)) * 1e3,
           "kernels_per_learn_step": kernels,
           "device_busy_share_of_traced_wall": busy,
           "replay_transitions": len(dqn._replay),
           "replay_bytes_referenced": 2 * len(dqn._replay)
           * dqn._replay[0][0].nbytes,
           "replay_bytes_unique": sum(unique.values()),
           "greedy_play_score": score, "traced_s": traced_s,
           "copy_traffic_per_learn_step": traffic,
           "host_split": learn_host_split(dqn, dev, cfg["traced_steps"]),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "peak_over_before_bytes":
               torch.cuda.max_memory_allocated() - before}
    log("22(a): " + json.dumps(out))
    return dqn, out


def trace_events(fn):
    """Run `fn` (which takes a directory) and read back the one Chrome
    trace it writes there."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        fn(d)
        names = os.listdir(d)
        need(len(names) == 1, f"trace: {names} in the log directory")
        with open(os.path.join(d, names[0])) as fh:
            return json.load(fh)["traceEvents"]


def profiler_leg(dev, dqn, cfg, a):
    """22(e): OpProfiler sections over (a)'s learn step (first call and
    steady, beside CUDA-event time), the kill switch, a trace() file with
    kernels and an annotate region, compiled_cost of the b32 Q forward
    against the analytic count, mfu of the learn step at (a)'s median
    (`a`), the spans exported and read back."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.runtime import telemetry
    from deeplearning4j_tpu_torch.runtime.telemetry import MetricsRegistry
    from deeplearning4j_tpu_torch.util.profiler import (OpProfiler,
                                                        annotate,
                                                        compiled_cost,
                                                        device_peak_flops,
                                                        mfu, trace)

    reg = MetricsRegistry()
    prof = OpProfiler(registry=reg)
    marks = []
    for _ in range(cfg["profiled_steps"]):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        with reg.span("rl.learn", "rl"), prof.section("dqn.learn"):
            dqn._learn_batch()
        e1.record()
        marks.append((e0, e1))
    torch.cuda.synchronize()
    event_ms = [e0.elapsed_time(e1) for e0, e1 in marks]
    n = cfg["profiled_steps"]
    need(prof.invocations("dqn.learn") == n, "22(e): section count")
    sections = {"first_call_ms": prof.compileTime("dqn.learn") * 1e3,
                "steady_avg_ms": prof.averageTime("dqn.learn") * 1e3,
                "first_event_ms": event_ms[0],
                "steady_event_ms_mean": float(np.mean(event_ms[1:]))}
    telemetry.set_enabled(False)
    try:
        with prof.section("dqn.off"):
            dqn._learn_batch()
    finally:
        telemetry.set_enabled(True)
    need(prof.invocations("dqn.off") == 0
         and prof.timeSpent("dqn.off") == 0.0,
         "22(e): a section recorded while telemetry was off")

    def traced(d):
        with trace(d):
            for _ in range(2):
                with annotate("dqn.learn"):
                    dqn._learn_batch()

    events = trace_events(traced)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    regions = [e for e in events if e.get("name") == "dqn.learn"]
    need(kernels and regions, f"22(e): the trace holds {len(kernels)} "
         f"kernels and {len(regions)} annotate regions")
    B = cfg["batch"]
    x = torch.from_numpy(np.stack([dqn._replay[i][0] for i in range(B)]))
    cost = compiled_cost(dqn.net._forward_infer, dqn.net._params, x.to(dev))
    need(cost["flops"] == 2 * NATURE_DQN_MACS * B,
         f"22(e): compiled_cost {cost['flops']} flops vs the analytic "
         f"{2 * NATURE_DQN_MACS * B}")
    step_cost = compiled_cost(dqn._learn_batch)
    learn_s = a["learn_ms_median"] / 1e3
    with tempfile.TemporaryDirectory() as d:
        with open(reg.export_chrome_trace(os.path.join(d, "t.json"))) as fh:
            chrome = json.load(fh)["traceEvents"]
        with open(reg.export_jsonl(os.path.join(d, "t.jsonl"))) as fh:
            lines = [json.loads(line) for line in fh]
    need(len(chrome) == len(lines) == 2 * n,
         f"22(e): {len(chrome)} Chrome events, {len(lines)} JSONL spans, "
         f"expected {2 * n}")
    out = {"sections": sections, "trace_kernels": len(kernels),
           "trace_regions": len(regions),
           "q_forward_b32_flops": cost["flops"],
           "q_forward_b32_bytes_accessed": cost["bytes_accessed"],
           "learn_step_flops": step_cost["flops"],
           "learn_step_bytes_accessed": step_cost["bytes_accessed"],
           "peak_flops": device_peak_flops(dev),
           "learn_step_mfu": mfu(step_cost["flops"], learn_s, dev),
           "exported_spans": len(lines)}
    log("22(e): " + json.dumps(out))
    return out


class CartPoleMDP:
    """Barto, Sutton & Anderson (1983) cart-pole with gym's CartPole-v1
    constants: gravity 9.8, cart 1.0 kg, pole 0.1 kg, half-length 0.5 m,
    force 10 N, tau 0.02 s, Euler steps; done past 12 degrees or 2.4 m;
    reward 1 a step; reset uniform in +-0.05 from its own seed."""

    def __init__(self, seed):
        self._rng = np.random.RandomState(seed)
        self.state = None

    def obsSize(self):
        return 4

    def numActions(self):
        return 2

    def reset(self):
        self.state = self._rng.uniform(-0.05, 0.05, 4)
        return self.state.astype(np.float32)

    def step(self, action):
        x, x_dot, th, th_dot = self.state
        force = 10.0 if int(action) == 1 else -10.0
        cos, sin = math.cos(th), math.sin(th)
        temp = (force + 0.05 * th_dot * th_dot * sin) / 1.1
        th_acc = (9.8 * sin - cos * temp) / (
            0.5 * (4.0 / 3.0 - 0.1 * cos * cos / 1.1))
        x_acc = temp - 0.05 * th_acc * cos / 1.1
        self.state = np.array([x + 0.02 * x_dot, x_dot + 0.02 * x_acc,
                               th + 0.02 * th_dot, th_dot + 0.02 * th_acc])
        done = abs(self.state[0]) > 2.4 or \
            abs(self.state[2]) > 12 * 2 * math.pi / 360
        return self.state.astype(np.float32), 1.0, bool(done)


def cartpole_trainer(kind, device, cfg, envs):
    from deeplearning4j_tpu_torch.rl import (
        A3CConfiguration, A3CDiscreteDense, AsyncNStepQLConfiguration,
        AsyncNStepQLearningDiscreteDense)

    seeds = iter(range(cfg["seed"], cfg["seed"] + envs))
    factory = lambda: CartPoleMDP(next(seeds))   # noqa: E731
    if kind == "a3c":
        conf = A3CConfiguration(seed=cfg["seed"], nStep=cfg["nstep"],
                                numThreads=envs,
                                maxEpochStep=cfg["episode"])
        return A3CDiscreteDense(factory, conf, cfg["hidden"], device)
    conf = AsyncNStepQLConfiguration(seed=cfg["seed"], nStep=cfg["nstep"],
                                     numThreads=envs,
                                     maxEpochStep=cfg["episode"])
    return AsyncNStepQLearningDiscreteDense(factory, conf, cfg["hidden"],
                                            device)


def host_tree(tree):
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def cartpole_run(dev, cfg, kind, envs, updates):
    """Train `updates` rollouts (after two to warm up): rollouts/s, env
    steps/s, ms an update (to its result on the host), kernels a rollout
    and its update, the busy share of a traced block."""
    import torch

    t = cartpole_trainer(kind, dev, cfg, envs)
    per = envs * cfg["nstep"]
    t.train(maxSteps=2 * per)
    upd_s = []
    update = t._update

    def timed(*args):
        t0 = time.perf_counter()
        r = update(*args)
        torch.cuda.synchronize()
        upd_s.append(time.perf_counter() - t0)
        return r

    t._update = timed
    t0 = time.perf_counter()
    t.train(maxSteps=t._step + updates * per)
    wall = time.perf_counter() - t0
    del t._update
    kernels, busy = traced_steps(lambda: t.train(maxSteps=t._step + per),
                                 cfg["traced"])
    return {"envs": envs, "updates": updates,
            "rollouts_per_s": updates / wall,
            "env_steps_per_s": updates * per / wall,
            "update_ms_median": float(np.median(upd_s)) * 1e3,
            "kernels_per_rollout_and_update": kernels,
            "device_busy_share_of_traced_wall": busy}


def cartpole_parity(dev, cfg, kind):
    """One update from one fixed rollout, card vs CPU, from the card's
    parameters and Adam state after five rollouts."""
    card = cartpole_trainer(kind, dev, cfg, cfg["envs"])
    card.train(maxSteps=5 * cfg["envs"] * cfg["nstep"])
    cpu = cartpole_trainer(kind, "cpu", cfg, cfg["envs"])
    cpu.load_reference_params(host_tree(card.params),
                              host_tree(card._upd_state))
    cpu._iteration = card._iteration
    rng = np.random.RandomState(cfg["seed"] + 3)
    N = cfg["envs"] * cfg["nstep"]
    rollout = (rng.uniform(-0.2, 0.2, (N, 4)).astype(np.float32),
               rng.randint(0, 2, N), rng.uniform(0, 20, N).astype(np.float32))
    losses = [r if isinstance(r, tuple) else (r,)   # A3C: (pg, v)
              for r in (card._update(*rollout), cpu._update(*rollout))]
    out = {"params_rel": max(_rel_to(card.params[k], cpu.params[k])
                             for k in cpu.params),
           "adam_rel": max(_rel_to(card._upd_state[m][k],
                                   cpu._upd_state[m][k])
                           for m in ("m", "v") for k in cpu.params),
           "loss_rel": max(_rel_to(c.reshape(1), p.reshape(1))
                           for c, p in zip(*losses))}
    need(max(out.values()) <= RL_PARITY_REL,
         f"22(b) {kind} parity: {out} (bar {RL_PARITY_REL})")
    return out


def actor_critic(dev, cfg):
    """22(b): A3C and async n-step Q on CartPole dynamics."""
    out = {"a3c": cartpole_run(dev, cfg, "a3c", cfg["envs"],
                               cfg["updates"]),
           "a3c_wide": cartpole_run(dev, cfg, "a3c", cfg["wide_envs"],
                                    cfg["wide_updates"]),
           "nstep": cartpole_run(dev, cfg, "nstep", cfg["envs"],
                                 cfg["updates"]),
           "parity": {k: cartpole_parity(dev, cfg, k)
                      for k in ("a3c", "nstep")}}
    log("22(b): " + json.dumps(out))
    return out


class ChainMDP:
    """tests/test_rl.py's chain: states 0..n-1 one-hot; action 1 moves
    right (10.0 at the end, which ends the episode), action 0 left (0.2
    at state 0)."""

    def __init__(self, n=5):
        self.n, self.s = n, 0

    def obsSize(self):
        return self.n

    def numActions(self):
        return 2

    def _obs(self):
        o = np.zeros(self.n, "float32")
        o[self.s] = 1.0
        return o

    def reset(self):
        self.s = 0
        return self._obs()

    def step(self, action):
        if action == 1:
            self.s += 1
            if self.s >= self.n - 1:
                return self._obs(), 10.0, True
            return self._obs(), 0.0, False
        self.s = max(0, self.s - 1)
        return self._obs(), (0.2 if self.s == 0 else 0.0), False


def chain_tasks(dev, cfg):
    """22(c): the reference tests' chain policies trained on the card
    score 10.0 in play (dense DQN, A3C, n-step Q)."""
    from deeplearning4j_tpu_torch.nn import (Adam, DenseLayer, InputType,
                                             MultiLayerNetwork,
                                             NeuralNetConfiguration,
                                             OutputLayer)
    from deeplearning4j_tpu_torch.rl import (
        A3CConfiguration, A3CDiscreteDense, AsyncNStepQLConfiguration,
        AsyncNStepQLearningDiscreteDense, QLearningConfiguration,
        QLearningDiscreteDense)

    n = cfg["n"]
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(5e-3))
            .list().layer(DenseLayer(nOut=24, activation="tanh"))
            .layer(OutputLayer(nOut=2, activation="identity",
                               lossFunction="mse"))
            .setInputType(InputType.feedForward(n)).build())
    runs = {
        "dqn": lambda: QLearningDiscreteDense(
            ChainMDP(n), MultiLayerNetwork(conf, device=dev).init(),
            QLearningConfiguration(
                seed=7, gamma=0.9, batchSize=32, expRepMaxSize=2000,
                targetDqnUpdateFreq=100, updateStart=64, minEpsilon=0.05,
                epsilonNbStep=1200, maxEpochStep=30, doubleDQN=True))
        .train(maxSteps=cfg["dqn_steps"]),
        "a3c": lambda: A3CDiscreteDense(
            lambda: ChainMDP(n), A3CConfiguration(
                seed=5, gamma=0.9, nStep=10, numThreads=8,
                learningRate=3e-3, entropyCoef=0.01, valueCoef=0.5,
                maxEpochStep=30), 32, dev).train(maxSteps=cfg["ac_steps"]),
        "nstep": lambda: AsyncNStepQLearningDiscreteDense(
            lambda: ChainMDP(n), AsyncNStepQLConfiguration(
                seed=11, gamma=0.9, nStep=10, numThreads=8,
                learningRate=3e-3, targetDqnUpdateFreq=20, minEpsilon=0.05,
                epsilonNbStep=6000, maxEpochStep=30), 32, dev)
        .train(maxSteps=cfg["ac_steps"])}
    out = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        score = run().getPolicy().play(ChainMDP(n), maxSteps=20)
        out[name] = {"play_score": score,
                     "train_s": time.perf_counter() - t0}
    need(all(v["play_score"] == 10.0 for v in out.values()),
         f"22(c): chain play scores {out} (bar 10.0)")
    log("22(c): " + json.dumps(out))
    return out


def synthetic_digits(cfg):
    """Seeded 28x28x1 images in `classes` classes: a random sparse
    stroke pattern a class, blended with uniform noise."""
    rng = np.random.RandomState(cfg["seed"])
    protos = (rng.rand(cfg["classes"], 1, 28, 28) > 0.75).astype(np.float32)
    n = cfg["train"] + cfg["test"]
    y = rng.randint(0, cfg["classes"], n)
    x = (0.5 * protos[y] + 0.5 * rng.rand(n, 1, 28, 28)).astype(np.float32)
    onehot = np.eye(cfg["classes"], dtype=np.float32)[y]
    cut = cfg["train"]
    return (x[:cut], onehot[:cut]), (x[cut:], onehot[cut:])


def lenet_space(dev, cfg, lr, dense, conv1):
    from deeplearning4j_tpu_torch.arbiter import (ConvolutionLayerSpace,
                                                  DenseLayerSpace, LayerSpace,
                                                  MultiLayerSpace,
                                                  OutputLayerSpace)
    from deeplearning4j_tpu_torch.nn import InputType, SubsamplingLayer

    pool = dict(poolingType="max", kernelSize=(2, 2), stride=(2, 2))
    return (MultiLayerSpace.Builder().seed(cfg["seed"]).device(dev)
            .learningRate(lr)
            .addLayer(ConvolutionLayerSpace(nOut=conv1, kernelSize=(5, 5),
                                            activation="identity"))
            .addLayer(LayerSpace(SubsamplingLayer, **pool))
            .addLayer(ConvolutionLayerSpace(nOut=50, kernelSize=(5, 5),
                                            activation="identity"))
            .addLayer(LayerSpace(SubsamplingLayer, **pool))
            .addLayer(DenseLayerSpace(nOut=dense, activation="relu"))
            .addLayer(OutputLayerSpace(nOut=cfg["classes"],
                                       activation="softmax",
                                       lossFunction="mcxent"))
            .setInputType(InputType.convolutional(28, 28, 1)).build())


def lenet_graph_space(dev, cfg, dense):
    from deeplearning4j_tpu_torch.arbiter import (ComputationGraphSpace,
                                                  ConvolutionLayerSpace,
                                                  DenseLayerSpace, LayerSpace,
                                                  OutputLayerSpace)
    from deeplearning4j_tpu_torch.nn import InputType, SubsamplingLayer

    pool = dict(poolingType="max", kernelSize=(2, 2), stride=(2, 2))
    return (ComputationGraphSpace.Builder().seed(cfg["seed"]).device(dev)
            .learningRate(1e-3).addInputs("in")
            .addLayer("c1", ConvolutionLayerSpace(
                nOut=20, kernelSize=(5, 5), activation="identity"), "in")
            .addLayer("p1", LayerSpace(SubsamplingLayer, **pool), "c1")
            .addLayer("c2", ConvolutionLayerSpace(
                nOut=50, kernelSize=(5, 5), activation="identity"), "p1")
            .addLayer("p2", LayerSpace(SubsamplingLayer, **pool), "c2")
            .addLayer("d", DenseLayerSpace(nOut=dense, activation="relu"),
                      "p2")
            .addLayer("out", OutputLayerSpace(
                nOut=cfg["classes"], activation="softmax",
                lossFunction="mcxent"), "d")
            .setOutputs("out")
            .setInputTypes(InputType.convolutional(28, 28, 1)).build())


def arbiter_lenet(dev, cfg):
    """22(d): random, grid and genetic search over LeNet, a graph-space
    search, a MaxTimeCondition stop and one candidate invalid on purpose
    (a 5x5 kernel over a 2x2 input). Every other candidate must
    complete."""
    from deeplearning4j_tpu_torch.arbiter import (
        ContinuousParameterSpace, ConvolutionLayerSpace,
        DiscreteParameterSpace, EvaluationScoreFunction,
        GeneticSearchCandidateGenerator, GridSearchCandidateGenerator,
        LayerSpace, LocalOptimizationRunner, MaxCandidatesCondition,
        MaxTimeCondition, MultiLayerSpace, OptimizationConfiguration,
        OutputLayerSpace, RandomSearchGenerator, TestSetLossScoreFunction)
    from deeplearning4j_tpu_torch.data import DataSetIterator
    from deeplearning4j_tpu_torch.nn import GlobalPoolingLayer, InputType

    (xt, yt), (xv, yv) = synthetic_digits(cfg)
    B = cfg["batch"]
    train = DataSetIterator(xt, yt, B)
    test = DataSetIterator(xv, yv, B)
    lr = ContinuousParameterSpace(1e-4, 1e-1, log=True)
    dense = DiscreteParameterSpace(250, 500)
    conv1 = DiscreteParameterSpace(20, 32)
    space = lenet_space(dev, cfg, lr, dense, conv1)

    def search(gen, score, builder, *conds):
        conf = (OptimizationConfiguration.Builder().candidateGenerator(gen)
                .scoreFunction(score).terminationConditions(*conds)
                .epochsPerCandidate(1).build())
        t0 = time.perf_counter()
        res = LocalOptimizationRunner(conf, builder, train).execute()
        wall = time.perf_counter() - t0
        return res, {"candidates": len(res.results), "wall_s": wall,
                     "s_per_candidate": wall / max(len(res.results), 1),
                     "best_score": res.bestScore(),
                     "best": res.bestCandidate()}

    def completed(res, what):
        bad = [(r.candidate, repr(r.error)) for r in res.results
               if r.error is not None]
        need(not bad, f"22(d) {what}: failed candidates {bad}")

    out = {}
    acc = EvaluationScoreFunction(test)
    res, out["random"] = search(
        RandomSearchGenerator(space.parameterSpaces(), seed=cfg["seed"]),
        acc, space.modelBuilder, MaxCandidatesCondition(cfg["random"]))
    completed(res, "random")
    grid_space = lenet_space(dev, cfg, 1e-3, dense, conv1)
    res, out["grid"] = search(
        GridSearchCandidateGenerator(grid_space.parameterSpaces()), acc,
        grid_space.modelBuilder, MaxCandidatesCondition(100))
    completed(res, "grid")
    need(out["grid"]["candidates"] == 4, f"22(d) grid: {out['grid']}")
    gen = GeneticSearchCandidateGenerator(
        space.parameterSpaces(), populationSize=cfg["population"],
        seed=cfg["seed"])
    res, out["genetic"] = search(
        gen, acc, space.modelBuilder,
        MaxCandidatesCondition(cfg["population"] * cfg["generations"]))
    completed(res, "genetic")
    out["genetic"]["generation"] = gen.generation
    graph_space = lenet_graph_space(dev, cfg, dense)
    res, out["graph"] = search(
        RandomSearchGenerator(graph_space.parameterSpaces(),
                              seed=cfg["seed"]),
        TestSetLossScoreFunction(test), graph_space.modelBuilder,
        MaxCandidatesCondition(cfg["graph"]))
    completed(res, "graph")
    budget = cfg["time_budget"] * out["random"]["s_per_candidate"]
    res, out["max_time"] = search(
        RandomSearchGenerator(space.parameterSpaces(),
                              seed=cfg["seed"] + 1),
        acc, space.modelBuilder, MaxCandidatesCondition(100),
        MaxTimeCondition(budget))
    completed(res, "max_time")
    out["max_time"]["budget_s"] = budget
    need(1 <= out["max_time"]["candidates"] < 100
         and out["max_time"]["wall_s"] >= budget,
         f"22(d): the time condition did not stop the search: "
         f"{out['max_time']}")
    tiny = (MultiLayerSpace.Builder().seed(cfg["seed"]).device(dev)
            .learningRate(1e-2)
            .addLayer(ConvolutionLayerSpace(
                nOut=4, kernelSize=DiscreteParameterSpace((1, 1), (5, 5)),
                activation="relu"))
            .addLayer(LayerSpace(GlobalPoolingLayer, poolingType="avg"))
            .addLayer(OutputLayerSpace(nOut=2, activation="softmax"))
            .setInputType(InputType.convolutional(2, 2, 1)).build())
    rng = np.random.RandomState(cfg["seed"])
    small = DataSetIterator(rng.rand(8, 1, 2, 2).astype(np.float32),
                            np.eye(2, dtype=np.float32)[
                                rng.randint(0, 2, 8)], 4)
    conf = (OptimizationConfiguration.Builder()
            .candidateGenerator(GridSearchCandidateGenerator(
                tiny.parameterSpaces()))
            .scoreFunction(TestSetLossScoreFunction(small))
            .terminationConditions(MaxCandidatesCondition(10)).build())
    res = LocalOptimizationRunner(conf, tiny.modelBuilder, small).execute()
    errs = [r.error for r in res.results]
    need(len(errs) == 2 and errs[0] is None
         and "Kernel size" in str(errs[1]),
         f"22(d): the invalid candidate's errors {errs}")
    out["invalid"] = {"error": str(errs[1])}
    log("22(d): " + json.dumps(out))
    return out


def rl_search_profiler_phase(dev):
    """Phase 22: (a), (e) on (a)'s trainer, then (b)-(d). No
    hand-written kernel launches."""
    import torch

    t = time.perf_counter()
    before = kernel_launches()
    legs, out = {}, {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        legs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return r

    dqn, out["dqn"] = leg("a", nature_dqn, dev, NATURE_DQN)
    out["profiler"] = leg("e", profiler_leg, dev, dqn, NATURE_DQN,
                          out["dqn"])
    del dqn
    out["actor_critic"] = leg("b", actor_critic, dev, CARTPOLE)
    out["chain"] = leg("c", chain_tasks, dev, CHAIN)
    out["arbiter"] = leg("d", arbiter_lenet, dev, ARBITER_LENET)
    out["leg_seconds"] = legs
    need(kernel_launches() == before, "phase 22: a hand-written kernel "
         f"launched: {before} -> {kernel_launches()}")
    out["seconds"] = time.perf_counter() - t
    log(f"phase 22: {out['seconds']:.1f} s (legs " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()) + ")")
    return out


# ----------------------------------------------------------------------
# phase 23: capture, warm start and tuning
# ----------------------------------------------------------------------

#: 23(a): phase 4's model and burst; the decode step at bucket 8
CAPTURE_DECODE = dict(requests=8, new_tokens=32, buckets=(1, 2, 4, 8),
                      pages=513)
#: 23(c): steps of each eager/captured pair (VGG16 5: dropout's masks)
CAPTURE_TRAIN = dict(resnet=20, lenet=20, encoder=20, vgg=5, vgg_batch=64,
                     resnet_remat=5)
#: 23(d): the sweeps' proving steps and timed replays a candidate
CAPTURE_TUNE = dict(steps=2, reps=5, lenet_batch=64)


def both_step_times(steps, reps=5):
    """Phase 4's method for each {name: step}: host wall to a synchronize
    (median of `reps`) and device time by CUDA events behind a spin
    kernel (median of `reps`)."""
    import torch

    out = {}
    for name, step in steps.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        host, device = [], []
        for _ in range(reps):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            a.record()
            step()
            b.record()
            need(not a.query(), f"capture: {name}'s spin ended before the "
                 "step was queued")
            b.synchronize()
            device.append(a.elapsed_time(b))
        out[name] = {"host_ms": float(np.median(host)),
                     "device_ms": float(np.median(device)),
                     "host_ms_all": host, "device_ms_all": device}
    return out


def _bitwise(a, b, what):
    """Two tensors (or lists of them) equal bit for bit."""
    import torch

    a = a if isinstance(a, (list, tuple)) else [a]
    b = b if isinstance(b, (list, tuple)) else [b]
    need(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} tensors")
    for i, (u, v) in enumerate(zip(a, b)):
        need(u.shape == v.shape and torch.equal(u, v),
             f"{what}: tensor {i} differs")


def capture_decode(dev, cfg):
    """23(a): one captured decode graph per slot bucket, the burst served
    replayed and eager, the bucket-8 step both ways, the swap."""
    import torch

    from deeplearning4j_tpu_torch.nn.transformer import CausalTransformerLM
    from deeplearning4j_tpu_torch.ops import paged_attention as tpa
    from deeplearning4j_tpu_torch.runtime import aot, telemetry
    from deeplearning4j_tpu_torch.serving import ModelHost

    lm = CausalTransformerLM(device=dev, **GPT2_SMALL)
    rng = np.random.default_rng(SEED + 23)
    lens = rng.integers(64, 513, size=cfg["requests"])
    prompts = [rng.integers(0, lm.vocab, size=int(n)).tolist()
               for n in lens]
    reg = telemetry.get_registry()
    cache = aot.session_cache() or aot.enable()
    host = ModelHost()
    out = {}
    try:
        for name, capture in (("eager", False), ("graphs", True)):
            c0 = dict(cache.stats)
            rep = host.register_sequence(
                name, lm, numPages=cfg["pages"],
                slotBuckets=cfg["buckets"], precompile=capture)
            if not capture:
                # the eager baseline: the scheduler's own device step
                sm = host._sequences[name]
                sm.scheduler._step_capture = None
                rep["warm"] = sm.warm()
            captured = cache.stats["captures"] - c0["captures"]
            need(captured == (len(cfg["buckets"]) if capture else 0),
                 f"capture (a): warm() of {name} captured {captured}")
            reg.trace.clear()
            tpa.reset_launches()
            with aot.CompileWatch(cache) as watch:
                t = time.perf_counter()
                reqs = [host.generate(name, p, max_new_tokens=cfg[
                    "new_tokens"], wait=False) for p in prompts]
                toks = [r.wait(600) for r in reqs]
                wall = time.perf_counter() - t
            watch.assert_no_compiles(f"capture (a): {name}'s burst")
            need(all(len(x) == cfg["new_tokens"] for x in toks),
                 f"capture (a): {name}: a request came back short")
            steps = [s for s in reg.trace.spans()
                     if s["name"] == "sequence.step"
                     and s["args"]["model"] == f"{name}:v1"]
            dec = sum(s["args"]["slots"] for s in steps)
            k4 = tpa.paged_flash_decode.launches
            need(k4 == len(steps) * lm.n_layers, f"capture (a): {name}: K4 "
                 f"{k4} launches for {len(steps)} decode steps")
            ttft = reg.get("dl4j_seq_ttft_seconds").labels(
                model=f"{name}:v1")
            out[name] = {"warm_s": {str(k): v for k, v in
                                    rep["warm"].items()},
                         "ttft_p50_s": ttft.percentile(50),
                         "ttft_max_s": ttft.percentile(100),
                         "decode_steps": len(steps),
                         "decode_tok_per_s": dec / sum(s["dur"]
                                                       for s in steps),
                         "burst_wall_s": wall, "k4_launches": k4,
                         "k4_per_step": k4 / max(1, len(steps))}
        c0 = cache.stats["captures"]
        host.swap_sequence("graphs", lm)
        recaptured = cache.stats["captures"] - c0
        need(recaptured == len(cfg["buckets"]), f"capture (a): the swap "
             f"re-captured {recaptured}, one a bucket expected")
        out["swap_recaptures"] = recaptured
    finally:
        host.close(drain=False)

    # the bucket-8 step as phase 4 times it, eager and replayed
    S = cfg["buckets"][-1]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shape = (lm.n_layers, P, lm.page_size, lm.n_heads, lm.head_dim)
    kps, vps = (torch.randn(shape, generator=gen, device=dev,
                            dtype=lm.emb.dtype) for _ in range(2))
    sl_list = [int(n) + 16 for n in lens]
    bt = torch.from_numpy(tables(np.random.default_rng(SEED),
                                 [n + 1 for n in sl_list])).to(dev)
    sl = torch.tensor(sl_list, dtype=torch.int32, device=dev)
    tokens = torch.zeros(S, dtype=torch.int64, device=dev)

    def eager():
        return lm.decode_paged(tokens, kps, vps, bt, sl)[0]

    step = aot.CapturedStep(lambda t: lm.decode_paged(t, kps, vps, bt,
                                                      sl)[0],
                            entry="smoke.decode_step",
                            fingerprint="smoke.decode_step")
    step.capture((tokens,))
    _bitwise(eager(), step(tokens).clone(),
             "capture (a): replayed vs eager decode logits")
    k0 = tpa.paged_flash_decode.launches
    step(tokens)
    need(tpa.paged_flash_decode.launches - k0 == lm.n_layers,
         "capture (a): a replayed decode step does not add K4 once a layer")
    out["decode_step"] = both_step_times(
        {"eager": eager, "replayed": lambda: step(tokens)})
    del step, kps, vps
    out["carry_slot_step"] = capture_carry_step(dev)
    log("capture (a): " + json.dumps(out))
    return out


def capture_carry_step(dev):
    """23(a): phase 12(c)'s carry-slot bucket-8 step, eager and replayed
    (config 3's widths, bf16, random weights)."""
    import torch

    from deeplearning4j_tpu_torch.runtime import aot

    net = char_rnn(dev, CHAR_RNN, "BFLOAT16")
    S = 8
    x = torch.zeros((S, net.conf.inputType.size), device=dev)
    x[:, 0] = 1.0
    carries = net.rnnCarryZeros(S)

    def eager():
        return net.rnnStepBatched(x, carries)[0]

    step = aot.CapturedStep(lambda xx: net.rnnStepBatched(xx, carries)[0],
                            entry="smoke.carry_step",
                            fingerprint="smoke.carry_step")
    step.capture((x,))
    _bitwise(eager(), step(x).clone(),
             "capture (a): replayed vs eager carry-slot outputs")
    return both_step_times({"eager": eager, "replayed": lambda: step(x)})


def capture_oneshot(dev):
    """23(b): phase 18's ResNet-50 bf16 eval behind ParallelInference,
    buckets 1/8/32/128: b1 and b128 host ms eager vs replayed, outputs
    bitwise within a bucket, no cold dispatch."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = serve_resnet(dev)
    images = serve_images(128, seed=SEED + 23)
    eager = ParallelInference(net, batchBuckets=SERVE["buckets"])
    graphs = ParallelInference(net, batchBuckets=SERVE["buckets"])
    t = time.perf_counter()
    rep = graphs.precompile()
    capture_s = time.perf_counter() - t
    out = {"capture_s": capture_s,
           "bucket_capture_s": {str(b): r["seconds"]
                                for b, r in rep.items()}}
    for rows in (1, 128):
        x = images[:rows]
        a = eager.output(x).toNumpy()        # warms the eager bucket
        b = graphs.output(x).toNumpy()
        need(np.array_equal(a.view(np.uint32), b.view(np.uint32)),
             f"capture (b): replayed b{rows} outputs differ from eager")
        for name, pi in (("eager", eager), ("replayed", graphs)):
            ms = []
            for _ in range(10):
                t = time.perf_counter()
                pi.output(x)
                ms.append((time.perf_counter() - t) * 1e3)
            out[f"b{rows}_{name}_host_ms"] = float(np.median(ms))
            out[f"b{rows}_{name}_host_ms_all"] = ms
    need(graphs.cold_dispatches == 0,
         f"capture (b): {graphs.cold_dispatches} cold dispatches")
    out["cold_dispatches"] = graphs.cold_dispatches
    log("capture (b): " + json.dumps(out))
    return out


def _train_pair(build, x, y, steps, what, precompile):
    """`steps` fit steps of an eager net and of a captured one built the
    same way (one at a time: a captured step keeps its pool): losses and
    final parameters bitwise; step ms, rate and peak memory of each."""
    import torch

    res = {}
    finals = {}
    for name in ("eager", "captured"):
        gc.collect()
        torch.cuda.empty_cache()
        net = build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(net.device)
        base = torch.cuda.memory_reserved(net.device)
        if name == "captured":
            t = time.perf_counter()
            rep = precompile(net)
            res["capture_s"] = time.perf_counter() - t
            res["capture_report"] = {k: v["status"] for k, v in rep.items()}
            warm = net._captured.captures
        losses, step_s = fit_timed(net, x, y, steps)
        med = float(np.median(step_s[2:])) if steps > 3 \
            else float(np.median(step_s))
        # the peak from before the capture (its warm-up included); the
        # graph's pool is reserved, not allocated, between replays
        res[name] = {"step_ms": med * 1e3, "per_s": x.shape[0] / med,
                     "peak_bytes": torch.cuda.max_memory_allocated(
                         net.device),
                     "reserved_growth_bytes": torch.cuda.max_memory_reserved(
                         net.device) - base, "losses": losses}
        if name == "captured":
            cap = net._captured
            need(cap.uncaptured == 0 and cap.replays == steps,
                 f"{what}: {cap.replays} replays, {cap.uncaptured} "
                 f"uncaptured of {steps} steps")
            res["captures_after_warm"] = cap.captures - warm
        finals[name] = [t.detach().cpu() for t in net._step_state()]
        del net
    need(res["eager"]["losses"] == res["captured"]["losses"],
         f"{what}: captured losses differ from eager: "
         f"{res['eager']['losses'][:3]} vs {res['captured']['losses'][:3]}")
    _bitwise(finals["eager"], finals["captured"],
             f"{what}: final parameters and state")
    return res


def capture_training(dev, cfg):
    """23(c): each pair bitwise, eager against captured."""
    import torch

    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.nn import Adam, DataType, Nesterovs
    from deeplearning4j_tpu_torch.nn.schedules import StepSchedule
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    out = {}
    # (i) 9(b)'s configuration; the features fed as f32, the signature
    # precompile captures (the network casts to bf16 on the card)
    x, y = resnet_batch(dev, RESNET_TIMED, RESNET_TIMED["batch"])
    x = x.float()
    out["resnet50"] = _train_pair(
        lambda: resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                           updater=Nesterovs(0.1, 0.9)),
        x, y, cfg["resnet"], "capture (c)(i) ResNet-50",
        lambda n: n.precompile(batchSize=RESNET_TIMED["batch"],
                               entries=("train",)))
    # (v) the same net under activationCheckpointing: the per-layer
    # regions' recomputes inside the captured step
    def remat_net():
        n = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                       updater=Nesterovs(0.1, 0.9))
        n.conf.activationCheckpointing = True
        return n

    out["resnet50_remat"] = _train_pair(
        remat_net, x, y, cfg["resnet_remat"],
        "capture (c)(v) ResNet-50 activationCheckpointing",
        lambda n: n.precompile(batchSize=RESNET_TIMED["batch"],
                               entries=("train",)))
    need(out["resnet50_remat"]["captures_after_warm"] == 0,
         "capture (c)(v): the remat step was captured again after warm(): "
         f"{out['resnet50_remat']['captures_after_warm']}")
    del x, y
    # (ii) phase 8's LeNet, Adam on a step schedule
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.random((LENET["batch"], 1, 28, 28),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, LENET["batch"])]).to(dev)
    out["lenet"] = _train_pair(
        lambda: zoo.LeNet(numClasses=10, seed=SEED, device=dev,
                          updater=Adam(StepSchedule("ITERATION", 1e-3, 0.5,
                                                    5))).init(),
        x, y, cfg["lenet"], "capture (c)(ii) LeNet",
        lambda n: n.precompile(batchSize=LENET["batch"], entries=("train",)))
    # (iii) phase 7's encoder: K1-K3 replayed, 12 a step each
    from deeplearning4j_tpu_torch.nn import ComputationGraph

    x, y = encoder_batch(BERT_BASE, dev)

    def encoder_pre(n):
        rep = n.precompile(batchSize=BERT_BASE["batch"], entries=("train",))
        tfa.reset_launches()
        return rep

    out["encoder"] = _train_pair(
        lambda: ComputationGraph(bert_encoder_conf(BERT_BASE)).init(),
        x, y, cfg["encoder"], "capture (c)(iii) encoder", encoder_pre)
    launches = {"K1": tfa.flash_fwd.launches, "K2": tfa.flash_bwd_dq.launches,
                "K3": tfa.flash_bwd_dkv.launches}
    want = BERT_BASE["layers"] * cfg["encoder"]
    need(all(v == want for v in launches.values()), f"capture (c)(iii): "
         f"replayed launches {launches}, {want} each expected")
    out["encoder"]["launches"] = launches
    del x, y
    # (iv) VGG16 bf16 with dropout on: the replayed masks are the eager
    vcfg = dict(ZOO_VGG, batch=cfg["vgg_batch"])
    x, y = zoo_batch(dev, vcfg, vcfg["batch"])
    x = x.float()
    out["vgg16_dropout"] = _train_pair(
        lambda: zoo.VGG16(numClasses=1000, seed=SEED, inputShape=(3, 224,
                                                                  224),
                          dataType=DataType.BFLOAT16, dataFormat="NHWC",
                          device=dev).init(),
        x, y, cfg["vgg"], "capture (c)(iv) VGG16 dropout",
        lambda n: n.precompile(batchSize=vcfg["batch"], entries=("train",)))
    del x, y
    log("capture (c): " + json.dumps(
        {k: {kk: vv for kk, vv in v.items()
             if kk not in ("eager", "captured")} | {
            "eager_step_ms": v["eager"]["step_ms"],
            "captured_step_ms": v["captured"]["step_ms"],
            "eager_peak": v["eager"]["peak_bytes"],
            "captured_peak": v["captured"]["peak_bytes"],
            "eager_reserved_growth": v["eager"]["reserved_growth_bytes"],
            "captured_reserved_growth":
                v["captured"]["reserved_growth_bytes"]}
         for k, v in out.items()}))
    return out


def capture_autotune(dev, cfg):
    """23(d): sweeps of LeNet b64 and ResNet-50 b128 (scored by the
    captured step's CUDA-event wall), persisted; a second process's
    warm_start applies them with no sweep and no capture."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.runtime import aot
    from deeplearning4j_tpu_torch.runtime import autotune as at

    d = tempfile.mkdtemp(prefix="dl4j_tune_")
    out = {}
    try:
        st = at.TuningStore(d)
        before = at.current_knobs()
        lenet = at.autotune_subject("lenet", batch_size=cfg["lenet_batch"],
                                    device=dev, store_=st,
                                    steps=cfg["steps"])
        rnet = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                          updater=Nesterovs(0.1, 0.9))
        shape = (RESNET_TIMED["batch"], RESNET_TIMED["image"],
                 RESNET_TIMED["image"], 3)
        res = at.autotune(rnet, shape, store_=st, steps=cfg["steps"])
        need(at.current_knobs() == before,
             "capture (d): a sweep left the knobs moved")
        for name, r in (("lenet", lenet), ("resnet50", res)):
            need(r.swept, f"capture (d): {name} did not sweep")
            out[name] = {"knobs": r.knobs, "per_knob": r.per_knob,
                         "wall": r.wall, "baseline_bytes": r.baseline_bytes,
                         "tuned_bytes": r.tuned_bytes,
                         "skipped": [p["knob"] for p in r.per_knob
                                     if p["verdict"] == "identical"]}
        # the second process: a fresh store on the directory
        cache = aot.session_cache() or aot.enable()
        st2 = at.TuningStore(d)
        with aot.CompileWatch(cache) as watch:
            again = at.autotune(rnet, shape, store_=st2)
            installed = at.warm_start(rnet, store_=st2)
        watch.assert_no_compiles("capture (d): the second warm_start")
        at.install(before)
        need(not again.swept and installed == res.knobs,
             "capture (d): the second process swept or installed another "
             "record")
        out["second_warm_start"] = {"swept": again.swept,
                                    "installed": installed,
                                    "captures": watch.captures}
        del rnet
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log("capture (d): " + json.dumps(out))
    return out


def capture_ledger(dev):
    """23(e): ResNet-50 b128 bf16: the floor, the counted bytes, their
    ratio, the bins (summing to the count), residency against the peak,
    the dtype audit clean under the compute tail and flagging the wide
    one."""
    import torch

    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.ops import norm as tnorm
    from deeplearning4j_tpu_torch.util import hbm_ledger as H

    net = resnet_net(dev, RESNET_TIMED, "BFLOAT16", dataFormat="NHWC",
                     updater=Nesterovs(0.1, 0.9))
    shape = (RESNET_TIMED["batch"], RESNET_TIMED["image"],
             RESNET_TIMED["image"], 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rows = H.record_step(net, shape)
    rec = H.attribute_ledger(net, shape, rows=rows)
    need(sum(rec["bins"].values()) == rec["ledger_total_bytes"],
         "capture (e): the bins do not sum to the count")
    res = H.residency(net, shape)
    audit = H.audit_activation_dtypes(net, shape, rows=rows)
    need(audit == [], f"capture (e): the compute tail's audit flagged "
         f"{audit[:3]}")
    old, tnorm._TAIL_MODE = tnorm._TAIL_MODE, "wide"
    try:
        wide = H.audit_activation_dtypes(net, shape)
    finally:
        tnorm._TAIL_MODE = old
    need(len(wide) > 0, "capture (e): the wide tail's audit is clean")
    out = {"floor_bytes": rec["floor_bytes"],
           "counted_bytes": rec["ledger_total_bytes"],
           "ratio_to_floor": rec["ratio_to_floor"], "bins": rec["bins"],
           "static": res["static"],
           "max_allocated_bytes": res["max_allocated_bytes"],
           "wide_tail_offenders": len(wide),
           "wide_tail_offender_bytes": sum(r["bytes"] for r in wide)}
    del net, rows
    log("capture (e): " + json.dumps(out))
    return out


def capture_phase(dev):
    """Phase 23: (a) decode graphs, (b) one-shot buckets, (c) captured
    training, (d) autotune, (e) the ledger."""
    import torch

    t = time.perf_counter()
    legs, out = {}, {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        legs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return r

    out["decode"] = leg("a", capture_decode, dev, CAPTURE_DECODE)
    out["oneshot"] = leg("b", capture_oneshot, dev)
    out["training"] = leg("c", capture_training, dev, CAPTURE_TRAIN)
    out["autotune"] = leg("d", capture_autotune, dev, CAPTURE_TUNE)
    out["ledger"] = leg("e", capture_ledger, dev)
    out["leg_seconds"] = legs
    out["seconds"] = time.perf_counter() - t
    log(f"phase 23: {out['seconds']:.1f} s (legs " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()) + ")")
    return out


# ----------------------------------------------------------------------
# phase 24: the static analysis tier
# ----------------------------------------------------------------------

#: 24(b): the band predicted/measured must lie in (written in PERF.md
#: before the first run on the card): never more than 10 % under, at
#: most 30 % over
PAR06_BAND = (0.90, 1.30)
#: 24(b): the configurations: 9(b)'s ResNet-50 and 20(a)'s YOLO2
PAR06_CASES = (("ResNet50", 224, 1000, 128), ("YOLO2", 416, 80, 16))
#: 24(d): the soak's LM (paged, K4/K5) and its requests
SOAK_LM = dict(vocab=512, d_model=256, n_heads=4, n_layers=2,
               max_context=256, page_size=16, seed=SEED)
SOAK = dict(generate=12, predict=12, new_tokens=8, prompt=(20, 60))


def analysis_zoo(dev):
    """24(a): validate_or_raise on every zoo model at the card's memory;
    the card allocates nothing."""
    import torch

    from deeplearning4j_tpu_torch.analysis import (
        validate_or_raise, zoo_corpus,
    )

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    hbm = torch.cuda.get_device_properties(dev).total_memory / 1e9
    t = time.perf_counter()
    reports = {}
    for name, model in zoo_corpus():
        rep = validate_or_raise(model, batchSize=32, hbm_gb=hbm)
        need(rep.ok and not rep.errors, f"24(a) {name}: {rep.format()}")
        reports[name] = rep.plan["memory"]["total_bytes"]
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(dev)
    need(after == before, f"24(a): the pass allocated {after - before} "
         "bytes on the card")
    out = {"models": len(reports), "errors": 0, "seconds": secs,
           "allocated_delta_bytes": after - before, "hbm_gb": hbm,
           "predicted_total_bytes_b32": reports}
    log("24(a): " + json.dumps(out))
    return out


def _par06_batch(dev, image, classes, rows, yolo):
    import torch

    rng = np.random.default_rng(SEED + 24)
    x = torch.from_numpy(rng.random((rows, image, image, 3),
                                    dtype=np.float32)).to(dev)
    if yolo:
        y = yolo_labels(rows, image // 32, classes, (1, 8), SEED + 25,
                        nhwc=True)
    else:
        y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                           rows)]
    return x, torch.from_numpy(y).to(dev)


def _measured_peak(dev, make, steps, capture):
    """max_memory_allocated over building the net, (capturing it) and
    `steps` fit steps, over what was allocated before: the net's own
    high-water mark."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    net, x, y = make()
    if capture:
        net.precompile(batchSize=x.shape[0], featuresShape=tuple(x.shape),
                       labelsShape=tuple(y.shape), entries=("train",))
    losses = []
    for _ in range(steps):
        net.fit(x, y)
        losses.append(net.score())
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    need(all(math.isfinite(v) for v in losses), f"24(b): losses {losses}")
    del net, x, y
    return peak


def analysis_par06(dev):
    """24(b): the port's PAR06 prediction against the card, eager and
    captured; an over-budget batch raises before any allocation."""
    import torch

    from deeplearning4j_tpu_torch import zoo
    from deeplearning4j_tpu_torch.analysis import (
        ConfigValidationError, validate_plan,
    )
    from deeplearning4j_tpu_torch.analysis.partitioning import \
        step_high_water
    from deeplearning4j_tpu_torch.nn import DataType, Nesterovs
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    total = torch.cuda.get_device_properties(dev).total_memory
    out = {}
    for name, image, classes, rows in PAR06_CASES:
        def model(**more):
            # a fresh updater each time: a trained net's is not reused
            kw = dict(numClasses=classes, seed=SEED,
                      inputShape=(3, image, image),
                      dataType=DataType.BFLOAT16, dataFormat="NHWC")
            if name == "ResNet50":
                kw["updater"] = Nesterovs(0.1, 0.9)
            return getattr(zoo, name)(**kw, **more)

        conf = model().conf()
        t = time.perf_counter()
        rep = validate_plan(conf, {"data": 1}, batchSize=rows,
                            hbm_gb=total / 1e9)
        pred_s = time.perf_counter() - t
        mem = rep.plan["memory"]
        need(rep.ok and mem is not None,
             f"24(b) {name}: no prediction: {rep.format()}")

        def make():
            net = model(device=dev).init()
            x, y = _par06_batch(dev, image, classes, rows,
                                name == "YOLO2")
            return net, x, y

        row = {"batch": rows, "predict_s": pred_s,
               "predicted_eager_bytes": mem["total_bytes"],
               "predicted_captured_bytes": mem["captured_total_bytes"],
               "terms": {k: v for k, v in mem.items()
                         if k.endswith("_bytes")}}
        for mode, capture in (("eager", False), ("captured", True)):
            peak = _measured_peak(dev, make, 3, capture)
            key = "predicted_eager_bytes" if mode == "eager" \
                else "predicted_captured_bytes"
            ratio = row[key] / peak
            row[f"{mode}_measured_bytes"] = peak
            row[f"{mode}_ratio"] = ratio
            need(PAR06_BAND[0] <= ratio <= PAR06_BAND[1],
                 f"24(b) {name} {mode}: predicted {row[key]} B, measured "
                 f"{peak} B, ratio {ratio:.3f} outside {PAR06_BAND}")
        # a batch PAR06 says will not fit: refused before any allocation
        big = rows * int(math.ceil(1.25 * total / mem["step_peak_bytes"]))
        over = validate_plan(model().conf(), {"data": 1}, batchSize=big,
                             hbm_gb=total / 1e9)
        need("PAR06" in over.codes(), f"24(b) {name} b{big}: PAR06 does "
             f"not refuse it: {over.format()}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        net = ComputationGraph(model().conf(), dev)
        try:
            net.init(validate=True, hbm_gb=total / 1e9, batchSize=big)
            need(False, f"24(b) {name} b{big}: init(validate=True) passed "
                 "a batch PAR06 says will not fit")
        except ConfigValidationError as e:
            need("PAR06" in e.report.codes(), f"24(b) {name}: {e}")
        torch.cuda.synchronize()
        need(net._params is None and torch.cuda.memory_allocated(dev)
             == before, f"24(b) {name}: the refused init allocated")
        row["refused_batch"] = big
        out[name] = row
        gc.collect()
        torch.cuda.empty_cache()
    # an f32 convolutional step under the smoke's cuDNN settings (TF32
    # off, deterministic), where PAR06 counts the workspaces
    conf = zoo.SimpleCNN(numClasses=10, inputShape=(3, 64, 64)).conf()
    mem = validate_plan(conf, {"data": 1}, batchSize=64).plan["memory"]

    def make_simple():
        rng = np.random.default_rng(SEED + 24)
        x = torch.from_numpy(rng.random((64, 3, 64, 64),
                                        dtype=np.float32)).to(dev)
        y = torch.from_numpy(np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, 64)]).to(dev)
        return zoo.SimpleCNN(numClasses=10, inputShape=(3, 64, 64),
                             seed=SEED, device=dev).init(), x, y

    peak = _measured_peak(dev, make_simple, 3, False)
    ratio = mem["total_bytes"] / peak
    need(PAR06_BAND[0] <= ratio <= PAR06_BAND[1],
         f"24(b) SimpleCNN f32: predicted {mem['total_bytes']} B, measured "
         f"{peak} B, ratio {ratio:.3f} outside {PAR06_BAND}")
    out["SimpleCNN_f32"] = {
        "batch": 64, "predicted_eager_bytes": mem["total_bytes"],
        "eager_measured_bytes": peak, "eager_ratio": ratio,
        "conv_workspace_bytes": step_high_water(conf, 64)[
            "conv_workspace_bytes"]}
    gc.collect()
    torch.cuda.empty_cache()
    log("24(b): " + json.dumps(out))
    return out


def analysis_init_bitwise(dev):
    """24(c): init(validate=True) + 3 LeNet fit steps bitwise init()'s."""
    import torch

    from deeplearning4j_tpu_torch.zoo import LeNet

    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(SEED + 26)
    x = torch.from_numpy(rng.random((64, 1, 28, 28),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, 64)]).to(dev)
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork

    runs = []
    for kw in (dict(validate=True, hbm_gb=80, batchSize=64), {}):
        conf = LeNet(numClasses=10, seed=SEED).conf()
        net = MultiLayerNetwork(conf, dev).init(**kw)
        losses = []
        for _ in range(3):
            net.fit(x, y)
            losses.append(net.score())
        runs.append((losses, [t.detach().clone() for p in net._params
                              for t in p.values()]))
    need(runs[0][0] == runs[1][0], f"24(c): losses {runs[0][0]} vs "
         f"{runs[1][0]}")
    need(all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])),
         "24(c): parameters after 3 steps differ")
    out = {"losses": runs[0][0], "bitwise": True}
    log("24(c): " + json.dumps(out))
    return out


def _soak_traffic(port, gens, preds, rng):
    """Concurrent :generate and :predict requests, their payloads drawn
    before any thread starts; returns one (kind, payload, HTTP code,
    decoded body) a request, in submission order."""
    payloads = []
    for _ in range(gens):
        n = int(rng.integers(*SOAK["prompt"]))
        payloads.append(("generate", rng.integers(
            0, SOAK_LM["vocab"], size=n).tolist()))
    for _ in range(preds):
        payloads.append(("predict", rng.random((2, 1, 28, 28))
                         .astype(np.float32)))
    out = [None] * len(payloads)

    def send(i):
        kind, p = payloads[i]
        if kind == "generate":
            code, body = http(port, "/v1/models/lm:generate",
                              {"tokens": p,
                               "maxNewTokens": SOAK["new_tokens"]},
                              timeout=120)
        else:
            code, body = http(port, "/v1/models/cnn:predict",
                              {"instances": p.tolist()}, timeout=120)
        out[i] = (kind, p, code, json.loads(body))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(payloads))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    need(all(r is not None for r in out),
         "24(d): a soak request never answered")
    return out


#: 24(d): the most requests one injected raise at a seam may fail: the
#: requests sharing the failed work (a decode step's 4 slots, a
#: prefill chunk's or a page allocation's step, a predict batch's 8 rows
#: = 4 requests of 2 rows), else the one request
SOAK_RAISE_CAP = {"sequence.step": 4, "sequence.prefill": 4,
                  "kv.page_alloc": 4, "queue.dispatch": 4}


def _classify_soak(plan, rows, fleet_errors):
    """24(d): every failed request is an injected fault, and no more
    fail than the faults fired could fail: a 500 names the raise that
    failed it (``chaos[seam#n]``), no raise fails more requests than
    share its work (SOAK_RAISE_CAP), a 400 is a prompt the corrupt fault
    at host.submit_sequence pushed out of the vocabulary (no more of
    them than that fault fired), a fleet.submit that fails raised
    ChaosError, and every answer is well formed (non-finite predictions
    only as many as corrupt faults fired on the predict path)."""
    import re

    from deeplearning4j_tpu_torch.runtime.chaos import ChaosError

    raised = {f"{s}#{n}" for s, k, n in plan.events if k == "raise"}
    corrupt = {}
    for s, k, _ in plan.events:
        if k == "corrupt":
            corrupt[s] = corrupt.get(s, 0) + 1
    blamed, bad_tokens, nonfinite, codes = {}, 0, 0, {}
    for kind, _, code, body in rows:
        codes[str(code)] = codes.get(str(code), 0) + 1
        if code == 200:
            if kind == "generate":
                toks = body["tokens"]
                need(len(toks) == SOAK["new_tokens"] and all(
                    0 <= t < SOAK_LM["vocab"] for t in toks),
                    f"24(d): a malformed :generate answer {toks}")
            else:
                pr = np.asarray(body["predictions"], dtype=np.float64)
                need(pr.shape == (2, 10), f"24(d): predictions {pr.shape}")
                nonfinite += int(not np.isfinite(pr).all())
            continue
        err = body.get("error", "")
        if code == 400:
            need("prompt token ids must be in" in err,
                 f"24(d): a 400 no fault explains: {err}")
            bad_tokens += 1
            continue
        m = re.search(r"chaos\[([a-z_.]+#\d+)\]", err)
        need(code == 500 and m is not None and m.group(1) in raised,
             f"24(d): a {code} no injected raise explains: {err}")
        blamed[m.group(1)] = blamed.get(m.group(1), 0) + 1
    for fault, n in blamed.items():
        cap = SOAK_RAISE_CAP.get(fault.split("#")[0], 1)
        need(n <= cap, f"24(d): the raise {fault} failed {n} requests "
             f"(at most {cap} share its work)")
    need(bad_tokens <= corrupt.get("host.submit_sequence", 0),
         f"24(d): {bad_tokens} prompts refused, "
         f"{corrupt.get('host.submit_sequence', 0)} corrupted")
    need(nonfinite <= corrupt.get("host.submit", 0)
         + corrupt.get("queue.dispatch", 0),
         f"24(d): {nonfinite} non-finite :predict answers")
    for e in fleet_errors:
        need(isinstance(e, ChaosError),
             f"24(d): fleet.submit failed with {type(e).__name__}: {e}")
    return {"http_codes": codes, "failed_by_raise": blamed,
            "refused_prompts": bad_tokens,
            "nonfinite_predictions": nonfinite,
            "fleet_errors": len(fleet_errors)}


def _check_clean_answers(rows, lm, cnn):
    """24(d): the coverage soak (no fault armed): every request answers
    200; each :predict row equals the network's own output on the same
    instances (1e-4), and each :generate token is the greedy choice of
    the f32 full causal forward fed the prompt and the served tokens
    before it (within 1e-3 of the largest logit)."""
    import torch

    worst_row = worst_tok = 0.0
    for kind, p, code, body in rows:
        need(code == 200, f"24(d): a clean {kind} answered {code}: {body}")
        if kind == "predict":
            want = cnn.output(p).tensor().float().cpu().numpy()
            got = np.asarray(body["predictions"], dtype=np.float32)
            worst_row = max(worst_row, float(np.abs(got - want).max()))
            continue
        toks = body["tokens"]
        ids = torch.tensor(p + toks[:-1], device=lm.emb.device)
        with torch.inference_mode():
            ref = reference_logits(lm, ids)[len(p) - 1:].cpu().numpy()
        gap = ref.max(axis=1) - ref[np.arange(len(toks)), toks]
        worst_tok = max(worst_tok, float(gap.max()))
    need(worst_row <= 1e-4, f"24(d): served rows off the net's own "
         f"output by {worst_row}")
    need(worst_tok <= 1e-3, f"24(d): a served token {worst_tok} below "
         "the reference's greedy choice")
    return {"max_row_err": worst_row, "max_token_logit_gap": worst_tok}


def analysis_chaos_soak(dev):
    """24(d): the chaos soak over the paged and one-shot tiers."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.analysis import coverage_gaps, \
        seam_coverage
    from deeplearning4j_tpu_torch.nn.transformer import CausalTransformerLM
    from deeplearning4j_tpu_torch.ops import paged_attention as tpa
    from deeplearning4j_tpu_torch.runtime import aot
    from deeplearning4j_tpu_torch.runtime.chaos import ChaosPlan
    from deeplearning4j_tpu_torch.serving import (
        FleetRouter, InferenceServer, ModelHost,
    )
    from deeplearning4j_tpu_torch.zoo import LeNet

    serving = ("host.submit", "host.submit_sequence", "queue.dispatch",
               "sequence.step", "fleet.dispatch", "server.request",
               "kv.page_alloc", "sequence.prefill")
    host = ModelHost()
    lm = CausalTransformerLM(device=dev, **SOAK_LM)
    cnn = LeNet(numClasses=10, seed=SEED, device=dev).init()
    host.register_sequence("lm", lm, slotBuckets=(4,), numPages=96)
    host.register("cnn", cnn, batchBuckets=(8,), maxWaitMs=1.0)
    fleet = FleetRouter()
    for _ in range(2):
        fleet.add_replica(ModelHost())
    fleet_cnn = LeNet(numClasses=10, seed=SEED, device=dev).init()
    fleet.register("cnn", fleet_cnn, batchBuckets=(8,), maxWaitMs=1.0)
    srv = InferenceServer(host).start(port=0)
    out = {}
    try:
        deadline = time.monotonic() + 120
        while http(srv.port, "/healthz", timeout=10)[0] != 200:
            need(time.monotonic() < deadline, "/healthz never turned 200")
            time.sleep(0.1)
        rng = np.random.default_rng(SEED + 27)
        release = threading.Event()
        release.set()
        plan = ChaosPlan(seed=SEED)
        for i, seam in enumerate(serving):
            plan.raise_n(seam, at=0)
            plan.slow(seam, 0.01, at=1)
            plan.wedge(seam, 0.05, at=2, release=release)
            plan.corrupt(seam, at=3)
        plan.raise_n("aot.disk_read", at=0).corrupt("aot.disk_read", at=1)
        plan.raise_n("aot.disk_write", at=0)
        fleet_errors = []
        d = tempfile.mkdtemp(prefix="dl4j_soak_")
        cache = aot.ExecutableCache(d)

        class _Owner:
            pass

        owner, entry = _Owner(), _Owner()
        tpa.reset_launches()
        t = time.perf_counter()
        feats = rng.random((4, 1, 28, 28)).astype(np.float32)
        with plan:
            rows = _soak_traffic(srv.port, SOAK["generate"],
                                 SOAK["predict"], rng)
            for _ in range(6):
                try:
                    fleet.submit("cnn", feats)
                except Exception as e:  # classified: ChaosError only
                    fleet_errors.append(e)
            for k in range(3):
                cache.put(f"{k:016d}", entry, owner=owner,
                          record={"entry": "soak"})
                cache.record(f"{k:016d}")
        out["fault_soak_s"] = time.perf_counter() - t
        torch.cuda.synchronize()
        out["fired"] = len(plan.events)
        out["fired_by_kind"] = {k: sum(1 for e in plan.events if e[1] == k)
                                for k in ("raise", "wedge", "slow",
                                          "corrupt")}
        out.update(_classify_soak(plan, rows, fleet_errors))
        out["failed_requests"] = sum(v for c, v in out["http_codes"].items()
                                     if c != "200") + len(fleet_errors)
        out["aot_stats"] = dict(cache.stats)
        need(cache.stats["store_errors"] == 1
             and cache.stats["corrupt"] >= 2,
             f"24(d): aot seams not absorbed: {cache.stats}")
        missed = [s for s in serving if plan.fired(s) < 4]
        need(not missed, f"24(d): faults never fired at {missed}")
        out["k4_launches"] = tpa.paged_flash_decode.launches
        out["k5_launches"] = tpa.paged_flash_prefill.launches
        need(out["k4_launches"] > 0 and out["k5_launches"] > 0,
             f"24(d): K4/K5 launched {out['k4_launches']}/"
             f"{out['k5_launches']} times under the soak")

        clean = []

        def counted():
            clean.extend(_soak_traffic(srv.port, 4, 4, rng))
            clean.append(("fleet", feats, 200,
                          fleet.submit("cnn", feats)))
            cache.put("f" * 16, entry, owner=owner, record={"e": 1})
            cache.record("f" * 16)

        k4 = tpa.paged_flash_decode.launches
        k5 = tpa.paged_flash_prefill.launches
        counts = seam_coverage(counted, seams=serving
                               + ("aot.disk_read", "aot.disk_write"))
        out["k4_launches"] += tpa.paged_flash_decode.launches - k4
        out["k5_launches"] += tpa.paged_flash_prefill.launches - k5
        out["coverage"] = counts
        gaps = coverage_gaps(counts)
        need(gaps == [], f"24(d): seams never fired: {gaps}")
        _, fx, _, got = clean.pop()
        want = fleet_cnn.output(fx).tensor().float().cpu().numpy()
        got = np.asarray(got.tensor().float().cpu().numpy()
                         if hasattr(got, "tensor") else got)
        need(float(np.abs(got - want).max()) <= 1e-4,
             "24(d): the fleet's clean answer is off the net's output")
        out["clean"] = _check_clean_answers(clean, lm, cnn)
        torch.cuda.synchronize()
        out["context_alive"] = True
    finally:
        srv.stop()
        host.close(drain=True)
        fleet.close()
    log("24(d): " + json.dumps(out))
    return out


def analysis_collectives(dev):
    """24(e): the collective signature of a dense and an int8 step on
    two gloo ranks on this card (and over NCCL with 2+ cards)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import launch
    from deeplearning4j_tpu_torch.parallel.dryrun import signature_legs

    out = {}
    runs = [("gloo", "gloo")]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", "nccl"))
    for name, backend in runs:
        res = launch(signature_legs, 2, device="cuda", backend=backend,
                     timeout=300, args=((None, "int8"),))
        for rank, legs in enumerate(res):
            for r in legs:
                need(r["codes"] == [], f"24(e) {name} rank {rank} "
                     f"{r['mode']}: {r['errors']}")
                need(r["held"] and r["replicated"], f"24(e) {name} rank "
                     f"{rank} {r['mode']}: the record-only step left the "
                     "params changed or the replicas unequal")
        for a, b in zip(res[0], res[1]):
            need(a["executed"] == b["executed"],
                 f"24(e) {name} {a['mode']}: the ranks' signatures differ")
        out[name] = [{k: r[k] for k in ("mode", "counts", "wire_bytes",
                                        "recorded_wire_bytes",
                                        "exchange_wire_bytes", "bill",
                                        "lanes")} for r in res[0]]
    log("24(e): " + json.dumps(out))
    return out


def analysis_phase(dev):
    """Phase 24: (a) the zoo corpus, (b) PAR06 against the card, (c)
    validation changes nothing, (d) the chaos soak, (e) collectives."""
    import torch

    t = time.perf_counter()
    legs, out = {}, {}

    def leg(name, fn, *args):
        t0 = time.perf_counter()
        r = fn(*args)
        legs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return r

    out["zoo"] = leg("a", analysis_zoo, dev)
    out["par06"] = leg("b", analysis_par06, dev)
    out["init"] = leg("c", analysis_init_bitwise, dev)
    out["soak"] = leg("d", analysis_chaos_soak, dev)
    out["collectives"] = leg("e", analysis_collectives, dev)
    out["leg_seconds"] = legs
    out["seconds"] = time.perf_counter() - t
    log(f"phase 24: {out['seconds']:.1f} s (legs " + ", ".join(
        f"{k} {v:.1f}" for k, v in legs.items()) + ")")
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


# ----------------------------------------------------------------------
# phase 25: the model, sequence and pipeline mesh axes
# ----------------------------------------------------------------------

#: 25(a): zoo ResNet-50 at phase 9(b)'s widths and settings, tensor
#: parallel over two ranks on the card; batch 32 (9(b) takes 128): each
#: rank carries the whole batch's activations plus the gathered blocks
MESH_TP_RESNET = dict(RESNET_TIMED, batch=32, steps=3, min_shard=4096)
#: 25(a)'s parity runs: the same net at its published widths, 224^2 and
#: 1000 classes, at batch 4, in f64 and in f32 (TF32 off, deterministic
#: cuDNN), 3 Nesterovs steps each, every leaf held to the same steps of
#: one unsharded net on one rank: |tp - one| / |one - start|, over the
#: sharded and the replicated leaves apart, after steps 1 and 3. f64 is
#: held to MESH_TP_F64_BAND (an update left out reads 1.0; on the CPU at
#: 64^2, b4 the reading is 6e-10); f32 and the published bf16 run are
#: read, not held: this net's update carries each rounding difference
#: far (one rank's bf16 update lies 1.43x its norm from its f32 one on
#: the CPU), and a control (one rank's bf16 steps again under cuDNN's
#: benchmarked algorithms) reads how far a change of convolution
#: algorithm alone moves it
MESH_TP_PARITY = dict(MESH_TP_RESNET, batch=4)
MESH_TP_F64_BAND = 1e-6
#: 25(b): phase 7's encoder on {model: 2}; biases shard too (768, 3072
#: >= 512), so every projection and FFN layer runs column-parallel
MESH_TP_BERT = dict(steps=3, min_shard=512)
#: 25(b)'s band: the 3 losses relative to phase 7(b)'s first three
MESH_TP_BERT_BAND = 1e-4
#: 25(d): T 8192 over {seq: 2} (and {seq: 1}), the reference test's bars
MESH_SEQ = dict(B=2, H=12, T=8192, D=64, rtol=2e-4, atol=2e-5)
#: 25(e): a 1024 -> 4096 prologue, 8 x Dense(4096, tanh), a 1000-way
#: softmax head; 4 stages of 2 layers, 8 microbatches of 64
MESH_PIPE = dict(nin=1024, width=4096, body=8, classes=1000, batch=512,
                 micro=8, stages=4, steps=3, lr=0.05, rtol=1e-4, atol=1e-5)


def _allclose_excess(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)): <= 0 inside the bar."""
    return float(((got.double() - want.double()).abs()
                  - (atol + rtol * want.double().abs())).max())


def mesh_probe_rank(rank, world, device, ops, err_dir=None):
    """25's probe: gloo's ppermute (batch_isend_irecv) and all-to-all of
    CUDA tensors, and the all-gather and all-reduce the tensor-parallel
    legs need (those of `ops`), each checked by the values it returns.
    With `err_dir` the rank's error output goes to a file there, so that
    a rank gloo aborts leaves its words behind."""
    import torch

    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel import mesh as M

    if err_dir is not None:
        sys.stderr.flush()
        fd = os.open(os.path.join(err_dir, f"rank{rank}.err"),
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
        os.dup2(fd, 2)
        os.close(fd)
    g = M.build_mesh({"seq": world}).group("seq")
    out = {}

    def check(op, fn):
        try:
            ok, got = fn()
            out[op] = "ok" if ok else f"wrong values: {got}"
        except Exception as e:   # the probe reports any refusal
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0]}"

    base = torch.arange(6, dtype=torch.float32, device=device) + 100 * rank

    def pp():
        r = C.ppermute(base, g, 1)
        want = torch.arange(6., device=device) + 100 * ((rank - 1) % world)
        return bool(torch.equal(r, want)), r.tolist()

    def a2a():
        x = base.reshape(1, world, -1)
        r = C.all_to_all(x, g, 1, 2)
        want = torch.cat([(torch.arange(6., device=device) + 100 * j)
                          .reshape(world, -1)[rank] for j in range(world)])
        return bool(torch.equal(r.reshape(-1), want)), r.tolist()

    def ag():
        r = C.all_gather(base, g)
        return bool(all(torch.equal(r[j], torch.arange(6., device=device)
                                    + 100 * j) for j in range(world))), \
            r.tolist()

    def ar():
        r = C.all_reduce(base.clone(), g)
        want = torch.arange(6., device=device) * world \
            + 100 * sum(range(world))
        return bool(torch.equal(r, want)), r.tolist()

    calls = {"all_reduce": ar, "all_gather": ag, "all_to_all": a2a,
             "ppermute": pp}
    for op in ops:
        check(op, calls[op])
    torch.cuda.synchronize()
    return out


def _tp_replicated_digest(net):
    """sha256 of the leaves shard_params left whole and of the layer
    states (BN running statistics)."""
    import hashlib

    from deeplearning4j_tpu_torch.nn.multilayer import strip_carries
    from deeplearning4j_tpu_torch.parallel.trainer import _leaves

    h = hashlib.sha256()
    tp = net._tp
    for k in net._unit_keys():
        for n, t in net._params[k].items():
            if n not in tp.sharded.get(k, {}):
                h.update(t.detach().float().cpu().numpy().tobytes())
    for t in _leaves(strip_carries(net._states)):
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _whole_leaves(net, keep=True):
    """Every leaf of `net` whole, on the host (a tensor-parallel net's
    sharded leaves gathered: every rank of its model group calls this;
    None where `keep` is False)."""
    tp = net._tp
    out = {}
    for k in net._unit_keys():
        for n, t in net._params[k].items():
            w = t.detach() if tp is None else tp.whole(k, n, t.detach())
            if keep:
                out[(k, n)] = w.to("cpu", copy=True)
    return out if keep else None


def _over_update(a, b, start, keys):
    """|a - b| / |b - start| over the leaves `keys` (f64)."""
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in keys)
    den = sum(float((b[k].double() - start[k].double()).square().sum())
              for k in keys)
    return math.sqrt(num / den)


def _steps_with_snaps(net, x, y, steps, snap, first=None):
    """`steps` fit steps of `net`: losses, host seconds of each (the
    first under `first`, a context, when given) and `snap(net)` at the
    start and after steps 1 and `steps` (outside the timed spans)."""
    import contextlib

    import torch

    snaps = [snap(net)]
    losses, step_s = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with (first if i == 0 and first is not None
              else contextlib.nullcontext()):
            net.fit(x, y)
        losses.append(float(net.score()))
        step_s.append(time.perf_counter() - t)
        if i in (0, steps - 1):
            snaps.append(snap(net))
    return losses, step_s, snaps


def tp_resnet_leg(rank, world, dev, cfg, pcfg):
    """25(a) on one rank: the tensor-parallel bf16 steps at `cfg` (the
    first recorded, all timed), then `pcfg`'s f64 and f32 steps; rank 0
    then runs the same steps of one unsharded net alone (bf16 twice,
    the second under cuDNN's benchmarked algorithms, f64, f32) while
    rank 1 waits, and reads each run's distance from its own."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn import Nesterovs
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel import build_mesh, shard_params

    mesh = build_mesh({"data": 1, "model": world})
    keep = rank == 0
    x, y = resnet_batch(dev, cfg, cfg["batch"])
    b = pcfg["batch"]
    feeds = {"BFLOAT16": (cfg, x, y), "DOUBLE": (pcfg, x[:b].double(), y[:b]),
             "FLOAT": (pcfg, x[:b].float(), y[:b])}

    def build(dtype):
        return resnet_net(dev, feeds[dtype][0], dtype, dataFormat="NHWC",
                          updater=Nesterovs(0.1, 0.9))

    runs, out = {}, {}
    for dtype in ("BFLOAT16", "DOUBLE", "FLOAT"):
        net = build(dtype)
        shard_params(net, mesh, min_shard_size=cfg["min_shard"])
        c, xx, yy = feeds[dtype]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        rec = C.recording()
        losses, step_s, snaps = _steps_with_snaps(
            net, xx, yy, cfg["steps"], lambda n: _whole_leaves(n, keep),
            first=rec if dtype == "BFLOAT16" else None)
        runs[dtype] = snaps
        out[dtype] = {"losses": losses, "step_ms": [1e3 * t for t in step_s],
                      "peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "digest": _tp_replicated_digest(net),
                      "layer_calls": dict(net._tp.calls)}
        if dtype == "BFLOAT16":
            out[dtype].update(
                collectives_per_step=len(rec.sites),
                wire_bytes_per_step=sum(t.wire_bytes for t in rec.sites),
                recorded_ops=sorted({t.op for t in rec.sites}))
            sharded = [(k, n) for k in net._unit_keys()
                       for n in net._params[k]
                       if n in net._tp.sharded.get(k, {})]
        del net
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        keys = list(runs["BFLOAT16"][0])
        groups = {"sharded": sharded,
                  "replicated": [k for k in keys if k not in set(sharded)],
                  "all": keys}
        one = {}
        for name, dtype, bench in (("bf16", "BFLOAT16", False),
                                   ("bf16_benchmark", "BFLOAT16", True),
                                   ("f64", "DOUBLE", False),
                                   ("f32", "FLOAT", False)):
            torch.backends.cudnn.benchmark = bench
            torch.backends.cudnn.deterministic = not bench
            try:
                net = build(dtype)
                _, xx, yy = feeds[dtype]
                losses, step_s, snaps = _steps_with_snaps(
                    net, xx, yy, cfg["steps"], _whole_leaves)
            finally:
                torch.backends.cudnn.benchmark = False
                torch.backends.cudnn.deterministic = True
            one[name] = (losses, step_s, snaps)
            del net
            gc.collect()
            torch.cuda.empty_cache()
        read = {}
        for name, dtype in (("bf16", "BFLOAT16"), ("f64", "DOUBLE"),
                            ("f32", "FLOAT")):
            tp_s, one_s = runs[dtype], one[name][2]
            read[name] = {
                "start_equal": all(torch.equal(tp_s[0][k], one_s[0][k])
                                   for k in keys),
                "one_rank_losses": one[name][0]}
            for i, tag in ((1, "step1"), (2, f"step{cfg['steps']}")):
                read[name][tag] = {g: _over_update(tp_s[i], one_s[i],
                                                   one_s[0], ks)
                                   for g, ks in groups.items()}
        ctl = one["bf16_benchmark"][2]
        read["bf16_control"] = {
            tag: _over_update(ctl[i], one["bf16"][2][i], one["bf16"][2][0],
                              keys)
            for i, tag in ((1, "step1"), (2, f"step{cfg['steps']}"))}
        out["read"] = read
        out["one_rank_step_ms"] = [1e3 * t for t in one["bf16"][1]]
    dist.barrier()
    return out


def tp_bert_leg(rank, world, dev, cfg):
    """25(b) on one rank: phase 7's encoder on {model: 2}, K1-K3 counted
    and their head count read at each K1 launch."""
    import torch

    from deeplearning4j_tpu_torch.nn import ComputationGraph
    from deeplearning4j_tpu_torch.ops import flash_attention as tfa
    from deeplearning4j_tpu_torch.parallel import build_mesh, shard_params

    mesh = build_mesh({"model": world})
    net = ComputationGraph(bert_encoder_conf(BERT_BASE), device=dev).init()
    shard_params(net, mesh, min_shard_size=cfg["min_shard"])
    x, y = encoder_batch(BERT_BASE, dev)
    heads = []
    real = tfa.flash_fwd

    def seen(q, *a, **kw):
        heads.append(int(q.shape[1]))
        return real(q, *a, **kw)

    seen.launches = 0
    tfa.reset_launches()
    tfa.flash_fwd = seen
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_s = fit_timed(net, x, y, cfg["steps"])
    finally:
        tfa.flash_fwd = real
    # the wrapper counts its launches under its module name, which was
    # `seen` while it ran
    launches = {"K1": seen.launches + real.launches,
                "K2": tfa.flash_bwd_dq.launches,
                "K3": tfa.flash_bwd_dkv.launches,
                "plain": tfa.flash_fwd_plain.launches
                + tfa.flash_bwd_dq_plain.launches
                + tfa.flash_bwd_dkv_plain.launches}
    return {"losses": losses, "step_ms": [1e3 * s for s in step_s],
            "launches": launches, "heads": sorted(set(heads)),
            "layer_calls": dict(net._tp.calls),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "digest": _tp_replicated_digest(net)}


def seq_leg(rank, world, dev, cfg, run_ring=True, run_ulysses=True):
    """25(d) on one rank of {seq: world}: ring (causal and not) and
    Ulysses attention, forward and backward (a seeded cotangent), held to
    one-rank dot_product_attention on the whole T for this rank's rows."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
    from deeplearning4j_tpu_torch.parallel import (
        build_mesh, ring_attention, ulysses_attention,
    )

    mesh = build_mesh({"seq": world})
    B, H, T, D = cfg["B"], cfg["H"], cfg["T"], cfg["D"]
    rng = np.random.RandomState(SEED)
    q, k, v, gout = (torch.from_numpy(rng.randn(B, H, T, D).astype(
        np.float32)).to(dev) for _ in range(4))
    Tl = T // world
    sl = slice(rank * Tl, (rank + 1) * Tl)
    out = {}
    variants = ([("ring", False), ("ring_causal", True)] if run_ring
                else []) + ([("ulysses", False)] if run_ulysses else [])
    for name, causal in variants:
        # the whole-T answer, one rank at a time (its scores take 6 GB)
        for turn in range(world):
            dist.barrier()
            if turn != rank:
                continue
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = dot_product_attention(*leaves, causal=causal)
            o.backward(gout)
            torch.cuda.synchronize()
            one_ms = 1e3 * (time.perf_counter() - t0)
            want = [o.detach()[:, :, sl].clone()] + [
                t.grad[:, :, sl].clone() for t in leaves]
            del o, leaves
            torch.cuda.empty_cache()
        dist.barrier()
        loc = [t[:, :, sl].clone().requires_grad_(True) for t in (q, k, v)]
        fn = ring_attention if name.startswith("ring") else ulysses_attention
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = fn(*loc, mesh, causal=causal)
        o.backward(gout[:, :, sl])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        got = [o.detach()] + [t.grad for t in loc]
        out[name] = {
            "excess": max(_allclose_excess(g, w, cfg["rtol"], cfg["atol"])
                          for g, w in zip(got, want)),
            "max_abs": max(float((g - w).abs().max())
                           for g, w in zip(got, want)),
            "ms_fwd_bwd": ms, "one_rank_ms_fwd_bwd": one_ms}
        del o, loc, got, want
        torch.cuda.empty_cache()
    return out


def mesh_pair_rank(rank, world, device, gloo, ppermute_ok,
                   legs=("a", "b", "d")):
    """25(a), (b) and (d) on one of two ranks: gloo ranks on the card
    (`gloo`: first the probe of all-reduce, all-gather and all-to-all,
    its outcome the same on both ranks, then each leg only when the
    collectives it needs came back right; the ring only when
    `ppermute_ok`) or NCCL ranks a card each (no probe)."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    ops = ("all_reduce", "all_gather", "all_to_all")
    if gloo:
        mine = mesh_probe_rank(rank, world, device, ops)
        every = [None] * world
        dist.all_gather_object(every, mine)
        probe = {op: "ok" if all(p[op] == "ok" for p in every) else
                 "; ".join(f"rank {r}: {p[op]}" for r, p in enumerate(every)
                           if p[op] != "ok") for op in ops}
    else:
        probe = dict.fromkeys(ops, "ok")
    out = {"probe": probe}
    if probe["all_gather"] == "ok" and probe["all_reduce"] == "ok":
        if "a" in legs:
            out["a"] = tp_resnet_leg(rank, world, device, MESH_TP_RESNET,
                                     MESH_TP_PARITY)
            gc.collect()
            torch.cuda.empty_cache()
        if "b" in legs:
            out["b"] = tp_bert_leg(rank, world, device, MESH_TP_BERT)
            gc.collect()
            torch.cuda.empty_cache()
    ring, uly = ppermute_ok, probe["all_to_all"] == "ok"
    if "d" in legs and (ring or uly):
        out["d"] = seq_leg(rank, world, device, MESH_SEQ, ring, uly)
    return out


def pipe_conf(cfg):
    from deeplearning4j_tpu_torch.nn import (
        DenseLayer, InputType, NeuralNetConfiguration, OutputLayer, Sgd,
    )

    b = (NeuralNetConfiguration.Builder().seed(SEED).updater(Sgd(cfg["lr"]))
         .activation("tanh").list().layer(DenseLayer(nOut=cfg["width"])))
    for _ in range(cfg["body"]):
        b = b.layer(DenseLayer(nOut=cfg["width"]))
    return (b.layer(OutputLayer(nOut=cfg["classes"], activation="softmax"))
            .setInputType(InputType.feedForward(cfg["nin"])).build())


def pipe_rank(rank, world, device, cfg):
    """25(e) on one of four gloo ranks: PipelineParallel on {pipe: 4};
    rank 0 then runs the same steps of fit on its own and holds the
    params to them."""
    import torch

    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (
        PipelineParallel, build_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    x = torch.from_numpy(rng.randn(cfg["batch"], cfg["nin"]).astype(
        np.float32)).to(device)
    y = torch.from_numpy(np.eye(cfg["classes"], dtype=np.float32)[
        rng.randint(0, cfg["classes"], cfg["batch"])]).to(device)
    mesh = build_mesh({"pipe": cfg["stages"]})
    net = MultiLayerNetwork(pipe_conf(cfg), device=device).init()
    pp = PipelineParallel(net, mesh, n_microbatches=cfg["micro"])
    losses, step_ms, tick_ms, wall_ms = [], [], [], []
    for _ in range(cfg["steps"]):
        t = time.perf_counter()
        pp.fit(x, y)
        losses.append(net.score())
        wall_ms.append(1e3 * (time.perf_counter() - t))
        step_ms.append(1e3 * pp.last_step["step_s"])
        tick_ms.append([1e3 * s for s in pp.last_step["tick_s"]])
    out = {"losses": losses, "step_ms": step_ms, "tick_ms": tick_ms,
           "wall_ms_with_sync": wall_ms,
           "collectives_per_step": pp.last_step["collectives"],
           "wire_bytes_per_step": pp.last_step["wire_bytes"],
           "peak_bytes": torch.cuda.max_memory_allocated(device)}
    if rank == 0:
        one = MultiLayerNetwork(pipe_conf(cfg), device=device).init()
        one_ms = []
        for _ in range(cfg["steps"]):
            t = time.perf_counter()
            one.fit(x, y)
            float(one.score())
            one_ms.append(1e3 * (time.perf_counter() - t))
        got = net.params().toNumpy().astype(np.float64)
        want = one.params().toNumpy().astype(np.float64)
        out["excess"] = float((np.abs(got - want) - (
            cfg["atol"] + cfg["rtol"] * np.abs(want))).max())
        out["max_abs"] = float(np.abs(got - want).max())
        out["one_rank_losses"] = [float(one.score())]
        out["one_rank_step_ms"] = one_ms
    return out


def seq_one(dev, cfg):
    """25(d) on {seq: 1} in this process: the same code with no
    exchange, against dot_product_attention."""
    import torch

    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
    from deeplearning4j_tpu_torch.parallel import build_mesh, ring_attention

    mesh = build_mesh({"seq": 1})
    B, H, T, D = cfg["B"], cfg["H"], cfg["T"], cfg["D"]
    rng = np.random.RandomState(SEED)
    q, k, v, gout = (torch.from_numpy(rng.randn(B, H, T, D).astype(
        np.float32)).to(dev) for _ in range(4))
    out = {}
    for causal in (False, True):
        res = []
        for fn in (lambda a, b, c: ring_attention(a, b, c, mesh,
                                                  causal=causal),
                   lambda a, b, c: dot_product_attention(a, b, c,
                                                         causal=causal)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            o = fn(*leaves)
            o.backward(gout)
            res.append([o.detach()] + [t.grad for t in leaves])
            del o, leaves
        out["causal" if causal else "full"] = max(
            _allclose_excess(g, w, cfg["rtol"], cfg["atol"])
            for g, w in zip(*res))
        del res
        torch.cuda.empty_cache()
    return out


def ppermute_probe(one_card):
    """25's ppermute probe on two gloo ranks of its own: "ok", or the
    refusal's words (wrong values, gloo's exception, or gloo's abort of
    a rank, read from the rank's error output). Any other death of its
    ranks, or a timeout, fails the phase."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.parallel import launch

    err_dir = tempfile.mkdtemp(prefix="mesh_probe_")
    try:
        try:
            res = launch(mesh_probe_rank, 2, device=one_card,
                         backend="gloo", timeout=60,
                         args=(("ppermute",), err_dir))
        except RuntimeError as e:
            words = {}
            for r in range(2):
                path = os.path.join(err_dir, f"rank{r}.err")
                text = open(path).read() if os.path.exists(path) else ""
                lines = [ln for ln in text.splitlines()
                         if "gloo::IoException" in ln or "what():" in ln]
                if "gloo::IoException" in text:
                    words[r] = " ".join(ln.strip() for ln in lines)
            need(str(e).startswith("rank ") and "exit code -6" in str(e)
                 and words, "mesh (probe): the ppermute probe's ranks "
                 f"failed, and not by gloo's refusal: {e}")
            return "; ".join(f"rank {r} aborted by gloo: {w}"
                             for r, w in words.items())
        return "ok" if all(p["ppermute"] == "ok" for p in res) else \
            "; ".join(f"rank {r}: {p['ppermute']}" for r, p in
                      enumerate(res) if p["ppermute"] != "ok")
    finally:
        shutil.rmtree(err_dir, ignore_errors=True)


def _mesh_a(pair, where):
    """25(a)'s gates over the two ranks' results; its line."""
    a0, a1 = pair[0]["a"], pair[1]["a"]
    steps = MESH_TP_RESNET["steps"]
    for dtype in ("BFLOAT16", "DOUBLE", "FLOAT"):
        need(a0[dtype]["digest"] == a1[dtype]["digest"], f"mesh (a) "
             f"{dtype}: the replicated leaves or BN running statistics "
             "differ between the ranks")
        need(all(math.isfinite(v) for r in (a0, a1)
                 for v in r[dtype]["losses"]),
             f"mesh (a) {dtype}: non-finite loss {a0[dtype]['losses']}")
        need(a0[dtype]["layer_calls"]["column"] > 0
             and a0[dtype]["layer_calls"]["gather"] == 0,
             f"mesh (a) {dtype}: layer paths {a0[dtype]['layer_calls']}")
    read = a0["read"]
    for name in ("bf16", "f64", "f32"):
        need(read[name]["start_equal"], f"mesh (a) {name}: the placed "
             "net's whole params at the start differ from one rank's")
    for tag in ("step1", f"step{steps}"):
        need(all(read["f64"][tag][g] <= MESH_TP_F64_BAND
                 for g in ("sharded", "replicated")),
             f"mesh (a) f64 {tag}: the tensor-parallel params lie "
             f"{read['f64'][tag]} of the update from one rank's (band "
             f"{MESH_TP_F64_BAND})")
    bf = a0["BFLOAT16"]
    res = {"where": where, "losses": bf["losses"], "step_ms": bf["step_ms"],
           "one_rank_step_ms": a0["one_rank_step_ms"],
           "one_rank_losses": read["bf16"]["one_rank_losses"],
           "peak_bytes_per_rank": [a0["BFLOAT16"]["peak_bytes"],
                                   a1["BFLOAT16"]["peak_bytes"]],
           "collectives_per_step": bf["collectives_per_step"],
           "wire_bytes_per_step": bf["wire_bytes_per_step"],
           "recorded_ops": bf["recorded_ops"],
           "layer_calls_3_steps": bf["layer_calls"],
           "parity_batch": MESH_TP_PARITY["batch"],
           "f64_band": MESH_TP_F64_BAND,
           "over_update": {n: {t: read[n][t] for t in read[n]
                               if t.startswith("step")}
                           for n in ("f64", "f32", "bf16")},
           "bf16_control_over_update": read["bf16_control"],
           "parity_losses": {d: a0[d]["losses"] for d in ("DOUBLE",
                                                          "FLOAT")},
           "parity_one_rank_losses": {n: read[n]["one_rank_losses"]
                                      for n in ("f64", "f32")},
           "parity_step_ms": {d: a0[d]["step_ms"] for d in ("DOUBLE",
                                                            "FLOAT")},
           "replicated_bitwise": True}
    log("mesh (a): tp ResNet-50 at 224^2, 1000 classes, bf16 NHWC over f32 "
        f"masters, batch {MESH_TP_RESNET['batch']} (9(b): 128), {{data: 1, "
        f"model: 2}} ({where}); f64/f32 parity at batch "
        f"{MESH_TP_PARITY['batch']}; distances over one rank's update: "
        + json.dumps(res))
    return res


def _mesh_b(pair, where, train):
    """25(b)'s gates over the two ranks' results; its line."""
    b0, b1 = pair[0]["b"], pair[1]["b"]
    want = train["losses"][:MESH_TP_BERT["steps"]]
    rel = max(abs(g - w) / abs(w) for r in (b0, b1)
              for g, w in zip(r["losses"], want))
    steps = MESH_TP_BERT["steps"]
    L = BERT_BASE["layers"]
    for r in (b0, b1):
        need(all(r["launches"][k] == L * steps for k in ("K1", "K2", "K3"))
             and r["launches"]["plain"] == 0,
             f"mesh (b): kernel launches {r['launches']}, expected "
             f"{L * steps} each")
        need(r["heads"] == [BERT_BASE["heads"] // 2],
             f"mesh (b): K1 ran on {r['heads']} heads a rank")
    need(b0["digest"] == b1["digest"], "mesh (b): the replicated "
         "leaves differ between the ranks")
    need(rel <= MESH_TP_BERT_BAND, f"mesh (b): losses {b0['losses']} "
         f"vs phase 7(b)'s {want} (rel {rel:.3e}, band "
         f"{MESH_TP_BERT_BAND})")
    res = {"where": where, "losses": b0["losses"], "phase7_losses": want,
           "loss_rel": rel, "band": MESH_TP_BERT_BAND,
           "step_ms": b0["step_ms"],
           "launches_per_rank": b0["launches"],
           "launches_per_step_per_rank": {
               k: b0["launches"][k] / steps for k in ("K1", "K2", "K3")},
           "launches_both_ranks": {
               k: b0["launches"][k] + b1["launches"][k]
               for k in ("K1", "K2", "K3")},
           "heads_per_rank": b0["heads"],
           "layer_calls_3_steps": b0["layer_calls"],
           "peak_bytes_per_rank": [b0["peak_bytes"], b1["peak_bytes"]],
           "phase7_step_ms_median": train["step_ms_median_3_to_20"]}
    log(f"mesh (b): tp encoder at BERT-base widths on {{model: 2}} ({where}): "
        + json.dumps(res))
    return res


def mesh_axes_phase(dev, train):
    """Phase 25: the model, sequence and pipeline mesh axes on the card
    (module docstring); `train` is phase 7's result."""
    import torch

    from deeplearning4j_tpu_torch.parallel import launch
    from deeplearning4j_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    one_card = torch.device("cuda", torch.cuda.current_device())
    cards = torch.cuda.device_count()
    out, not_run = {}, {}
    host = ("; the port never stages a collective through the host "
            "itself")
    t = time.perf_counter()
    pp_probe = ppermute_probe(one_card)
    out["probe_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pair = launch(mesh_pair_rank, 2, device=one_card, backend="gloo",
                  timeout=600, args=(True, pp_probe == "ok"))
    out["pair_s"] = time.perf_counter() - t
    probe = dict(pair[0]["probe"], ppermute=pp_probe)
    out["probe"] = probe
    log("mesh (probe): gloo on CUDA tensors, two ranks on the card, each "
        "op checked by its values: " + json.dumps(probe))
    tp_ok = probe["all_gather"] == "ok" and probe["all_reduce"] == "ok"
    refused = "refused by the probe: " + "; ".join(
        f"{op} ({probe[op]})" for op in ("all_gather", "all_reduce")
        if probe[op] != "ok")
    ab, where = pair, "two gloo ranks on the card"
    if not tp_ok and cards >= 2:
        ab = launch(mesh_pair_rank, 2, device="cuda", backend="nccl",
                    timeout=600, args=(False, True, ("a", "b")))
        where = f"two NCCL ranks on two cards (gloo {refused})"
    if tp_ok or cards >= 2:
        out["a"] = _mesh_a(ab, where)
        out["b"] = _mesh_b(ab, where, train)
    else:
        not_run["a"] = not_run["b"] = (
            f"{refused}; runs under NCCL with two or more cards, {cards} "
            f"visible{host}")

    t = time.perf_counter()
    if tp_ok or cards >= 4:
        c = dryrun_multichip(4, device=one_card if tp_ok else "cuda",
                             legs=("tp",), backend="gloo" if tp_ok
                             else "nccl", timeout=600)["tp"]
        out["c"] = {"loss": c["loss"], "replicated": c["replicated"],
                    "comm": c["comm"], "seconds": time.perf_counter() - t}
        log("mesh (c): dryrun_multichip(4, legs=('tp',)) on four "
            + ("gloo ranks on the card" if tp_ok else "NCCL ranks on four "
               f"cards (gloo {refused})") + " ({data: 2, model: 2}): "
            + json.dumps(out["c"]))
    else:
        not_run["c"] = (f"{refused}; runs under NCCL with four cards, "
                        f"{cards} visible{host}")

    if "d" in pair[0]:
        d = {}
        for name in pair[0]["d"]:
            rs = [r["d"][name] for r in pair]
            ex = max(r["excess"] for r in rs)
            need(ex <= 0, f"mesh (d) {name}: outside rtol "
                 f"{MESH_SEQ['rtol']} atol {MESH_SEQ['atol']} by {ex:.3e}")
            d[name] = {"max_abs": max(r["max_abs"] for r in rs),
                       "ms_fwd_bwd": rs[0]["ms_fwd_bwd"],
                       "one_rank_ms_fwd_bwd": rs[0]["one_rank_ms_fwd_bwd"]}
        out["d"] = d
    for name, op in (("ring", "ppermute"), ("ulysses", "all_to_all")):
        if probe[op] != "ok":
            not_run[f"d {name}"] = (
                f"{op} of CUDA tensors refused by gloo's probe ({probe[op]});"
                f" runs under NCCL with two or more cards, {cards} visible"
                + host)
    if cards >= 2 and any(k.startswith("d ") for k in not_run):
        res = launch(seq_rank_nccl, 2, device="cuda", timeout=600)
        out["d_nccl"] = {name: {"max_abs": max(rr[name]["max_abs"]
                                               for rr in res),
                                "ms_fwd_bwd": r["ms_fwd_bwd"],
                                "one_rank_ms_fwd_bwd":
                                    r["one_rank_ms_fwd_bwd"]}
                         for name, r in res[0].items()}
        for name in res[0]:
            ex = max(rr[name]["excess"] for rr in res)
            need(ex <= 0, f"mesh (d) {name} over NCCL: outside the bar by "
                 f"{ex:.3e}")
        for k in [k for k in not_run if k.startswith("d ")]:
            log(f"mesh ({k}): over NCCL on two cards (gloo: {not_run[k]})")
            del not_run[k]
    one = seq_one(dev, MESH_SEQ)
    need(max(one.values()) <= 0, f"mesh (d) seq 1: outside the bar: {one}")
    out["d_seq1_excess"] = one
    log(f"mesh (d): sequence parallel at B {MESH_SEQ['B']}, H "
        f"{MESH_SEQ['H']}, T {MESH_SEQ['T']}, D {MESH_SEQ['D']} f32, fwd "
        f"and bwd against one-rank dot_product_attention (rtol "
        f"{MESH_SEQ['rtol']}, atol {MESH_SEQ['atol']}): "
        + json.dumps({"seq2": out.get("d"), "seq2_nccl": out.get("d_nccl"),
                      "seq1_excess": one}))

    gloo_pipe = probe["ppermute"] == "ok" and probe["all_gather"] == "ok"
    if gloo_pipe or cards >= MESH_PIPE["stages"]:
        t = time.perf_counter()
        res = launch(pipe_rank, MESH_PIPE["stages"],
                     device=one_card if gloo_pipe else "cuda",
                     backend="gloo" if gloo_pipe else "nccl", timeout=600,
                     args=(MESH_PIPE,))
        r0 = res[0]
        need(r0["excess"] <= 0, f"mesh (e): params outside rtol "
             f"{MESH_PIPE['rtol']} atol {MESH_PIPE['atol']} of fit's by "
             f"{r0['excess']:.3e} (max abs {r0['max_abs']:.3e})")
        need(all(math.isfinite(v) for v in r0["losses"]),
             f"mesh (e): non-finite loss {r0['losses']}")
        S, M = MESH_PIPE["stages"], MESH_PIPE["micro"]
        step = float(np.median(r0["step_ms"]))
        tick = float(np.median([tm for ticks in r0["tick_ms"]
                                for tm in ticks]))
        out["e"] = {"losses": r0["losses"],
                    "one_rank_losses": r0["one_rank_losses"],
                    "max_abs_vs_fit": r0["max_abs"],
                    "step_ms": r0["step_ms"],
                    "wall_ms_with_sync": r0["wall_ms_with_sync"],
                    "tick_ms_median": tick,
                    "bubble_share": (S - 1) * tick / step,
                    "one_rank_step_ms": r0["one_rank_step_ms"],
                    "collectives_per_step": r0["collectives_per_step"],
                    "wire_bytes_per_step": r0["wire_bytes_per_step"],
                    "peak_bytes_per_rank": [r["peak_bytes"] for r in res],
                    "seconds": time.perf_counter() - t}
        where = "four gloo ranks on the card" if gloo_pipe \
            else f"four NCCL ranks on {S} cards"
        log(f"mesh (e): PipelineParallel on {{pipe: {S}}} ({where}), {M} "
            "microbatches of "
            f"{MESH_PIPE['batch'] // M}, {MESH_PIPE['steps']} steps, held "
            f"to fit at rtol {MESH_PIPE['rtol']} atol {MESH_PIPE['atol']}; "
            "bubble = (S-1) x the median forward tick over the step: "
            + json.dumps(out["e"]))
    else:
        not_run["e"] = (f"ppermute of CUDA tensors refused by gloo's probe "
                        f"({probe['ppermute']}); runs under NCCL with "
                        f"{MESH_PIPE['stages']} cards, {cards} visible; the "
                        "port never stages a collective through the host "
                        "itself")
        log(f"mesh (e): not run: {not_run['e']}")
    for leg, why in not_run.items():
        log(f"mesh ({leg}): NOT RUN: {why}")
    out["not_run"] = not_run
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 25: {out['seconds']:.1f} s")
    return out


def seq_rank_nccl(rank, world, device):
    """25(d) over NCCL, one rank a card (two or more cards)."""
    return seq_leg(rank, world, device, MESH_SEQ)


# ----------------------------------------------------------------------
# phase 26: the distributed linear algebra tier
# ----------------------------------------------------------------------

#: 26(a): the reference's CANONICAL_LINALG_PLANS at world 1: gemm_32k
#: (32768^3), and gram_tall / lstsq_tall / rsvd_tall on one 2^23 x 1024
#: f32 matrix (34.4 GB) built on the card from a seeded generator; pca on
#: its first 2^21 rows. f64 oracles are computed on the card in row
#: chunks (an f64 copy of the tall matrix would not fit beside it)
LINALG_GEMM = dict(n=32768, sample_rows=256, timed=2, seed=26)
LINALG_TALL = dict(n=2 ** 23, d=1024, rank=64, oversample=8, n_iter=4,
                   chunk=2 ** 19, pca_rows=2 ** 21, seed=26)
#: the bars, stated before the first run on the card (f32 with TF32 off
#: against f64 oracles; the model: a sum of k f32 terms drifts by about
#: u sqrt(k / 6) relative for zero-mean terms and u sqrt(k) / 3 for
#: positive ones, u = 2^-24; each bar is that with room to spare):
#: GEMM rel Frobenius over the sampled rows and max-abs over max |C|;
#: Gram rel Frobenius; lstsq rel error of x; rsvd and pca the top-64
#: values' max rel error and the Frobenius distance of the projectors.
#: The reference's shifted CholeskyQR2 shifts its second round's Gram
#: (trace about l) by u l trace, which shrinks every singular value by
#: about u l^2 / 2 = 3.1e-4 relative in f32 at l = 72 (6.2e-4 for the
#: variances): the port keeps the algorithm, and the rsvd and pca bars
#: sit above that bias
LINALG_BARS = {"gemm_rel_fro": 2e-5, "gemm_max_abs_rel": 1e-4,
               "gram_rel_fro": 3e-4, "lstsq_rel": 1e-3,
               "rsvd_s_rel": 1e-3, "rsvd_projector": 1e-2,
               "pca_ev_rel": 2e-3, "pca_projector": 1e-2,
               "pca_mean_abs": 1e-4}
#: measured peak memory of one routine over linalg/plan.py's world-1
#: bill (the routine's own buffers; cuBLAS's workspace is unbilled)
LINALG_PEAK_BAND = (0.995, 1.01)
#: H100 SXM data-sheet peaks the bounds use (dense f32, HBM3)
F32_PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12
#: 26(b) over NCCL: GEMM at 16384^3 (2-D on {data: 2, model: 2} with 4
#: cards, 1-D on {data: cards}); the tall family at the canonical
#: 2^23 x 1024 split over {data: cards}
LINALG_MULTI = dict(gemm=16384, sample_rows=64, n=2 ** 23, d=1024,
                    rank=64, chunk=2 ** 19, seed=26)
#: 26(c): the consumers at world 1 on the card, each against its
#: unsharded path
LINALG_CONSUMERS = dict(kmeans_n=2 ** 18, kmeans_d=32, k=8, lsh_n=2 ** 16,
                        lsh_d=64, hash_length=16, tables=8,
                        dw_vertices=1024, dw_dim=128)


def _f64_gram(x, chunk):
    """x^T x in f64, x read in row chunks."""
    import torch

    g = torch.zeros(x.shape[1], x.shape[1], dtype=torch.float64,
                    device=x.device)
    for i in range(0, x.shape[0], chunk):
        c = x[i:i + chunk].double()
        g.addmm_(c.T, c)
    return g


def _f64_atb(x, b, chunk):
    """x^T b in f64 (b a vector), x read in row chunks."""
    import torch

    out = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        out += x[i:i + chunk].double().T @ b[i:i + chunk].double()
    return out


def _f64_colsum(x, chunk):
    out = 0
    for i in range(0, x.shape[0], chunk):
        out = out + x[i:i + chunk].double().sum(0)
    return out


def _measured(fn, input_bytes):
    """(fn(), seconds to a synchronize, peak bytes): the peak the call
    reached over what was allocated before it, plus `input_bytes` (the
    inputs the bill counts)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, torch.cuda.max_memory_allocated() - before \
        + input_bytes


def _top_spectrum(gram64, k):
    """The top-k eigenvalues (descending) of a symmetric f64 matrix and
    the projector onto their eigenvectors."""
    import torch

    evals, evecs = torch.linalg.eigh(gram64)
    vals, vecs = evals.flip(0)[:k], evecs.flip(1)[:, :k]
    return vals, vecs @ vecs.T


def _peak_row(name, secs, peak, bill):
    ratio = peak / bill
    lo, hi = LINALG_PEAK_BAND
    need(lo <= ratio <= hi,
         f"linalg (a) {name}: measured peak {peak} B over the bill "
         f"{bill} B = {ratio:.4f}, outside [{lo}, {hi}]")
    return {"seconds": secs, "peak_bytes": peak, "bill_bytes": bill,
            "peak_over_bill": ratio}


def _held(name, row, ok):
    """Log a routine's row as it completes, then hold it to its bars."""
    log(f"linalg (a) {name}: {row}")
    need(ok, f"linalg (a) {name}: outside its bars (LINALG_BARS): {row}")


def linalg_gemm(dev, cfg):
    """26(a) gemm_32k: 2-D SUMMA at world 1 ({data: 1, model: 1}), the
    blocks the operands themselves; 256 sampled rows of C against f64."""
    import torch

    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.linalg.plan import matmul_plan
    from deeplearning4j_tpu_torch.parallel import build_mesh

    n = cfg["n"]
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"])
    mesh = build_mesh({"data": 1, "model": 1})
    A = torch.randn(n, n, generator=g, device=dev)
    B = torch.randn(n, n, generator=g, device=dev)
    dA = linalg.DistributedMatrix(A, mesh, "data", "model")
    dB = linalg.DistributedMatrix(B, mesh, "data", "model")
    need(dA.tensor().data_ptr() == A.data_ptr(),
         "linalg (a) gemm: the block must be the operand, not a copy")
    C, secs, peak = _measured(lambda: linalg.matmul(dA, dB),
                              2 * A.numel() * 4)
    out = {"peak": _peak_row("gemm_32k", secs, peak, matmul_plan(
        n, n, n, mesh.shape)["per_chip_bytes"])}
    rows = torch.randperm(n, generator=g, device=dev)[:cfg["sample_rows"]]
    ref = A[rows].double() @ B.double()
    got = C.tensor()[rows].double()
    del C
    out["rel_fro"] = float((got - ref).norm() / ref.norm())
    out["max_abs_rel"] = float((got - ref).abs().max() / ref.abs().max())
    del ref, got
    _held("gemm_32k", out, out["rel_fro"] <= LINALG_BARS["gemm_rel_fro"]
          and out["max_abs_rel"] <= LINALG_BARS["gemm_max_abs_rel"])
    times = []
    for _ in range(cfg["timed"]):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        C = linalg.matmul(dA, dB)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
        del C
    out["ms"] = float(np.median(times))
    out["tflops"] = 2 * n ** 3 / (out["ms"] / 1e3) / 1e12
    out["bound_ms"] = 1e3 * max(2 * n ** 3 / F32_PEAK_FLOPS,
                                3 * n * n * 4 / HBM_BYTES_PER_S)
    return out


def linalg_tall(dev, cfg):
    """26(a) gram_tall, lstsq_tall, rsvd_tall (and pca on the first
    pca_rows rows) on one n x d matrix at world 1. Gram and lstsq run on
    the Gaussian matrix; its columns are then scaled in place by powers
    of two (exactly: 8, 4, 2, 1 for 16 columns each, then 1/16), so the
    rsvd's and pca's top 64 are separated from the rest by a factor of
    16 and their f64 oracle is D G D of the Gram's."""
    import torch

    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.linalg.plan import (gram_plan,
                                                      lstsq_plan, rsvd_plan)
    from deeplearning4j_tpu_torch.parallel import build_mesh

    n, d, k, ch = cfg["n"], cfg["d"], cfg["rank"], cfg["chunk"]
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"])
    mesh = build_mesh({"data": 1})
    X = torch.randn(n, d, generator=g, device=dev)
    xbytes = X.numel() * 4
    dX = linalg.DistributedMatrix(X, mesh)
    out = {}

    G, secs, peak = _measured(lambda: linalg.gram(dX), xbytes)
    out["gram"] = _peak_row("gram_tall", secs, peak,
                            gram_plan(n, d, mesh.shape)["per_chip_bytes"])
    G64 = _f64_gram(X, ch)
    out["gram"]["rel_fro"] = float((G.tensor().double() - G64).norm()
                                   / G64.norm())
    out["gram"]["tflops"] = 2 * n * d * d / secs / 1e12
    _held("gram_tall", out["gram"],
          out["gram"]["rel_fro"] <= LINALG_BARS["gram_rel_fro"])
    del G

    x_true = torch.randn(d, generator=g, device=dev)
    b = X @ x_true + torch.randn(n, generator=g, device=dev)
    res, secs, peak = _measured(lambda: linalg.lstsq(dX, b),
                                xbytes + b.numel() * 4)
    out["lstsq"] = _peak_row("lstsq_tall", secs, peak,
                             lstsq_plan(n, d, mesh.shape)["per_chip_bytes"])
    x64 = torch.linalg.solve(G64, _f64_atb(X, b, ch))
    out["lstsq"].update(
        rel=float((res.x.double() - x64).norm() / x64.norm()),
        iterations=res.iterations, converged=res.converged,
        residual_norm=res.residual_norm)
    _held("lstsq_tall", out["lstsq"], res.converged
          and out["lstsq"]["rel"] <= LINALG_BARS["lstsq_rel"])
    del res, b, x_true, x64

    scale = torch.full((d,), 2.0 ** -4, device=dev)
    scale[:64] = 2.0 ** (3 - torch.arange(64, device=dev) // 16)
    X.mul_(scale)                                   # exact in f32
    s64 = scale.double()
    (U, s, Vt), secs, peak = _measured(
        lambda: linalg.rsvd(dX, k, oversample=cfg["oversample"],
                            n_iter=cfg["n_iter"], seed=cfg["seed"]), xbytes)
    out["rsvd"] = _peak_row("rsvd_tall", secs, peak, rsvd_plan(
        n, d, k, mesh.shape, oversample=cfg["oversample"],
        n_iter=cfg["n_iter"])["per_chip_bytes"])
    vals, proj = _top_spectrum(G64 * s64[:, None] * s64[None, :], k)
    top = vals.sqrt()
    Vt64 = Vt.double()
    out["rsvd"].update(
        s_rel=float(((s.double() - top).abs() / top).max()),
        projector=float((Vt64.T @ Vt64 - proj).norm()),
        u_orthonormal=float((U.tensor().T @ U.tensor()
                             - torch.eye(k, device=dev)).abs().max()))
    _held("rsvd_tall", out["rsvd"],
          out["rsvd"]["s_rel"] <= LINALG_BARS["rsvd_s_rel"]
          and out["rsvd"]["projector"] <= LINALG_BARS["rsvd_projector"])
    del U, s, Vt, G64

    m = cfg["pca_rows"]
    dS = linalg.DistributedMatrix(X[:m], mesh)
    need(dS.tensor().data_ptr() == X.data_ptr(),
         "linalg (a) pca: the block must be a view of the matrix")
    (comps, ev, mu), secs, peak = _measured(
        lambda: linalg.pca(dS, k, oversample=cfg["oversample"],
                           n_iter=cfg["n_iter"], seed=cfg["seed"]),
        m * d * 4)
    out["pca"] = _peak_row("pca", secs, peak, rsvd_plan(
        m, d, k, mesh.shape, oversample=cfg["oversample"],
        n_iter=cfg["n_iter"], center=True)["per_chip_bytes"])
    mu64 = _f64_colsum(X[:m], ch) / m
    cov = (_f64_gram(X[:m], ch) - m * torch.outer(mu64, mu64)) / (m - 1)
    vals, proj = _top_spectrum(cov, k)
    c64 = comps.double()
    out["pca"].update(
        ev_rel=float(((ev.double() - vals).abs() / vals).max()),
        projector=float((c64.T @ c64 - proj).norm()),
        mean_abs=float((mu.double() - mu64).abs().max()))
    _held("pca", out["pca"],
          out["pca"]["ev_rel"] <= LINALG_BARS["pca_ev_rel"]
          and out["pca"]["projector"] <= LINALG_BARS["pca_projector"]
          and out["pca"]["mean_abs"] <= LINALG_BARS["pca_mean_abs"])
    return out


def _gather_rows_of(t, group):
    """`t`'s rows from every rank of `group`, concatenated."""
    from deeplearning4j_tpu_torch.parallel import collectives as coll

    return coll.all_gather(t.contiguous(), group).reshape(-1, t.shape[1])


def _gather_cols_of(t, group):
    from deeplearning4j_tpu_torch.parallel import collectives as coll

    return coll._gather_dim(t.contiguous(), group, 1)


def _multi_gemm(mesh, dev, cfg, two_d):
    """One GEMM leg of 26(b): the contract, the wire bytes against the
    plan, sampled rows of this rank's C block against f64, and the
    event time of a second product."""
    import torch

    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.analysis import collectives as colan
    from deeplearning4j_tpu_torch.linalg.plan import matmul_plan
    from deeplearning4j_tpu_torch.parallel import data_parallel_mesh
    from deeplearning4j_tpu_torch.parallel.mesh import axis_group

    N = cfg["gemm"]
    rows_g = axis_group(mesh, "data")
    cols_g = axis_group(mesh, "model") if two_d else None
    R, C = rows_g.size, (cols_g.size if two_d else 1)
    i, j = rows_g.rank, (cols_g.rank if two_d else 0)
    g = torch.Generator(device=dev)

    def block(which):
        g.manual_seed(cfg["seed"] * 1000 + 100 * which + 10 * i + j)
        return torch.randn(N // R, N // C, generator=g, device=dev)

    Ab, Bb = block(0), block(1)
    col = "model" if two_d else None
    dA = linalg.DistributedMatrix.from_local(Ab, mesh, "data", col)
    dB = linalg.DistributedMatrix.from_local(Bb, mesh, "data", col)
    got = {}
    ring = C if two_d else R
    op = "matmul2d" if two_d else "matmul1d"
    rep = colan.verify_program(
        lambda: got.__setitem__("C", linalg.matmul(dA, dB)),
        mesh=mesh.shape, group=data_parallel_mesh(), execute=True,
        contract=colan.linalg_contract(op, ring=ring), subject=op)
    need(rep.ok, f"linalg (b) {op}: {rep.format()}")
    plan = matmul_plan(N, N, N, mesh.shape, col_axis=col)
    wire = rep.signature.wire_bytes()
    need(wire == plan["ring_wire_bytes"] + plan["gather_wire_bytes"],
         f"linalg (b) {op}: wire {wire} B, plan "
         f"{plan['ring_wire_bytes'] + plan['gather_wire_bytes']} B")
    counts = linalg.collective_counts(lambda: linalg.matmul(dA, dB))
    need(counts == rep.signature.counts(),
         f"linalg (b) {op}: record-only {counts} vs executed "
         f"{rep.signature.counts()}")
    sample = torch.arange(0, N // R, (N // R) // cfg["sample_rows"],
                          device=dev)
    a_rows = Ab[sample]
    if two_d:       # this row block's sampled rows, all of k
        a_rows = _gather_cols_of(a_rows, cols_g)
        b_cols = _gather_rows_of(Bb, rows_g)           # [k, n / C]
    else:
        b_cols = _gather_rows_of(Bb, rows_g)           # [k, n]
    ref = a_rows.double() @ b_cols.double()
    mine = got["C"].tensor()[sample].double()
    rel = float((mine - ref).norm() / ref.norm())
    need(rel <= LINALG_BARS["gemm_rel_fro"],
         f"linalg (b) {op}: sampled rows rel {rel:.3e}")
    del ref, mine, b_cols, got
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    linalg.matmul(dA, dB)
    e1.record()
    e1.synchronize()
    return {"rel_fro": rel, "ms": e0.elapsed_time(e1), "counts": counts,
            "wire_bytes": wire, "mesh": mesh.shape}


def _multi_tall(mesh, dev, cfg):
    """The tall family of 26(b) on {data: R}: each rank generates its own
    rows; the f64 oracles are all-reduced from the ranks' chunked
    partials."""
    import torch

    from deeplearning4j_tpu_torch import linalg
    from deeplearning4j_tpu_torch.analysis import collectives as colan
    from deeplearning4j_tpu_torch.linalg.plan import (gram_plan,
                                                      lstsq_plan, rsvd_plan)
    from deeplearning4j_tpu_torch.parallel import collectives as coll

    n, d, k, ch = cfg["n"], cfg["d"], cfg["rank"], cfg["chunk"]
    R = mesh.size
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["seed"] * 1000 + mesh.rank)
    Xb = torch.randn(n // R, d, generator=g, device=dev)
    dX = linalg.DistributedMatrix.from_local(Xb, mesh)
    out, got = {}, {}

    def run(name, fn, contract):
        rep = colan.verify_program(
            lambda: got.__setitem__(name, fn()), mesh=mesh.shape,
            group=mesh, execute=True, subject=name)
        pin = contract(got[name])
        if pin is not None:
            rep.extend(pin.check(rep.signature))
        need(rep.ok, f"linalg (b) {name}: {rep.format()}")
        return rep.signature

    sig = run("gram", lambda: linalg.gram(dX),
              lambda _: colan.linalg_contract("gram"))
    G64 = coll.all_reduce(_f64_gram(Xb, ch), mesh)
    rel = float((got["gram"].tensor().double() - G64).norm() / G64.norm())
    need(rel <= LINALG_BARS["gram_rel_fro"]
         and sig.wire_bytes() == gram_plan(n, d, mesh.shape)[
             "ring_wire_bytes"], f"linalg (b) gram: rel {rel:.3e}, wire "
         f"{sig.wire_bytes()}")
    out["gram"] = {"rel_fro": rel, "wire_bytes": sig.wire_bytes()}

    gx = torch.Generator(device=dev)
    gx.manual_seed(cfg["seed"])
    x_true = torch.randn(d, generator=gx, device=dev)
    bb = Xb @ x_true + torch.randn(n // R, generator=g, device=dev)
    b = _gather_rows_of(bb[:, None], mesh)[:, 0]
    sig = run("lstsq", lambda: linalg.lstsq(dX, b),
              lambda r: colan.linalg_contract("lstsq",
                                              iterations=r.iterations))
    res = got["lstsq"]
    x64 = torch.linalg.solve(G64, coll.all_reduce(_f64_atb(Xb, bb, ch),
                                                  mesh))
    rel = float((res.x.double() - x64).norm() / x64.norm())
    plan = lstsq_plan(n, d, mesh.shape)
    want = plan["setup_wire_bytes"] \
        + res.iterations * plan["ring_wire_bytes_per_iter"]
    need(res.converged and rel <= LINALG_BARS["lstsq_rel"]
         and sig.wire_bytes() == want,
         f"linalg (b) lstsq: rel {rel:.3e}, {res.iterations} iterations, "
         f"wire {sig.wire_bytes()} vs {want}")
    out["lstsq"] = {"rel": rel, "iterations": res.iterations,
                    "wire_bytes": sig.wire_bytes()}
    del b, bb, res

    scale = torch.full((d,), 2.0 ** -4, device=dev)
    scale[:64] = 2.0 ** (3 - torch.arange(64, device=dev) // 16)
    Xb.mul_(scale)
    s64 = scale.double()
    sig = run("rsvd", lambda: linalg.rsvd(dX, k, seed=cfg["seed"]),
              lambda _: None)
    U, s, Vt = got["rsvd"]
    vals, proj = _top_spectrum(G64 * s64[:, None] * s64[None, :], k)
    s_rel = float(((s.double() - vals.sqrt()).abs() / vals.sqrt()).max())
    pj = float((Vt.double().T @ Vt.double() - proj).norm())
    wire = rsvd_plan(n, d, k, mesh.shape)["wire_bytes"]
    need(s_rel <= LINALG_BARS["rsvd_s_rel"]
         and pj <= LINALG_BARS["rsvd_projector"]
         and sig.wire_bytes() == wire,
         f"linalg (b) rsvd: s rel {s_rel:.3e}, projector {pj:.3e}, wire "
         f"{sig.wire_bytes()} vs {wire}")
    out["rsvd"] = {"s_rel": s_rel, "projector": pj,
                   "wire_bytes": sig.wire_bytes()}
    return out


def linalg_multi_rank(rank, world, device, cfg):
    """26(b) on one of `world` NCCL ranks (one card each)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    out = {}
    if world == 4:
        out["gemm2d"] = _multi_gemm(
            build_mesh({"data": 2, "model": 2}), dev, cfg, True)
        torch.cuda.empty_cache()
    mesh = build_mesh({"data": world})
    out["gemm1d"] = _multi_gemm(mesh, dev, cfg, False)
    torch.cuda.empty_cache()
    out["tall"] = _multi_tall(mesh, dev, cfg)
    return out


def linalg_consumers(dev, cfg):
    """26(c): sharded k-means, LSH's distributed projection and
    DeepWalk's mesh products on a one-rank mesh on the card, each against
    its unsharded path."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering.lsh import RandomProjectionLSH
    from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, Graph
    from deeplearning4j_tpu_torch.parallel import build_mesh

    mesh = build_mesh()
    rng = np.random.RandomState(26)
    out = {}
    t = time.perf_counter()
    centres = 20.0 * rng.randn(cfg["k"], cfg["kmeans_d"])
    X = (centres[rng.randint(0, cfg["k"], cfg["kmeans_n"])]
         + rng.randn(cfg["kmeans_n"], cfg["kmeans_d"])).astype(np.float32)
    local = KMeansClustering.setup(cfg["k"], seed=1).applyTo(X, device=dev)
    shard = KMeansClustering.setup(cfg["k"], seed=1, mesh=mesh).applyTo(
        X, device=dev)
    need((local.getAssignments() == shard.getAssignments()).all()
         and abs(shard.inertia - local.inertia) <= 1e-5 * local.inertia,
         f"linalg (c) k-means: sharded inertia {shard.inertia} vs "
         f"{local.inertia}")
    out["kmeans_s"] = time.perf_counter() - t
    t = time.perf_counter()
    L = rng.randn(cfg["lsh_n"], cfg["lsh_d"]).astype(np.float32)
    args = (cfg["hash_length"], cfg["tables"], cfg["lsh_d"])
    a = RandomProjectionLSH(*args, seed=2).index(L, device=dev)
    b = RandomProjectionLSH(*args, seed=2, mesh=mesh).index(L, device=dev)
    need([sorted(x) for x in a._tables] == [sorted(x) for x in b._tables],
         "linalg (c) LSH: the distributed projection's tables differ")
    ia, da = a.search(L[7], 10)
    ib, db = b.search(L[7], 10)
    need((ia == ib).all() and np.allclose(da, db, rtol=1e-6),
         "linalg (c) LSH: searches differ")
    out["lsh_s"] = time.perf_counter() - t
    t = time.perf_counter()
    gr = Graph(cfg["dw_vertices"])
    for v in range(cfg["dw_vertices"]):
        gr.addEdge(v, (v + 1) % cfg["dw_vertices"])
        gr.addEdge(v, int(rng.randint(cfg["dw_vertices"])))
    dw = DeepWalk.Builder().vectorSize(cfg["dw_dim"]).windowSize(4) \
        .seed(1).build()
    dw.fit(gr, walkLength=10, walksPerVertex=2, iterations=1, device=dev)
    G0, Gm = dw.embeddingGram(), dw.embeddingGram(mesh=mesh)
    S0, Sm = dw.similarityMatrix(), dw.similarityMatrix(mesh=mesh)
    out["deepwalk_gram_rel"] = float(np.abs(Gm - G0).max()
                                     / np.abs(G0).max())
    out["deepwalk_sim_abs"] = float(np.abs(Sm - S0).max())
    need(out["deepwalk_gram_rel"] <= 1e-5
         and out["deepwalk_sim_abs"] <= 1e-5,
         f"linalg (c) DeepWalk: mesh products off the local: {out}")
    out["deepwalk_s"] = time.perf_counter() - t
    return out


def linalg_phase(dev):
    """Phase 26: the distributed linear algebra tier (module docstring)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import launch

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    out, laps = {}, {}
    t = time.perf_counter()
    out["gemm"] = linalg_gemm(dev, LINALG_GEMM)
    gc.collect()
    torch.cuda.empty_cache()
    laps["a_gemm"] = time.perf_counter() - t
    t = time.perf_counter()
    out["tall"] = linalg_tall(dev, LINALG_TALL)
    gc.collect()
    torch.cuda.empty_cache()
    laps["a_tall"] = time.perf_counter() - t
    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else (2 if cards >= 2 else 0)
    not_run = []
    if world < 4:
        not_run.append("the 2-D SUMMA on {data: 2, model: 2} and the tall "
                       "family on {data: 4} (need 4 cards)")
    if world < 2:
        not_run.append("the 1-D ring and the tall family on {data: 2} "
                       "(need 2 cards)")
    t = time.perf_counter()
    if world:
        out["multi"] = launch(linalg_multi_rank, world, device=None,
                              timeout=600, args=(LINALG_MULTI,))
    laps["b"] = time.perf_counter() - t
    t = time.perf_counter()
    out["consumers"] = linalg_consumers(dev, LINALG_CONSUMERS)
    laps["c"] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t_phase
    out["laps"] = laps
    gm = out["gemm"]
    log(f"linalg (a) gemm_32k: {gm['ms']:.1f} ms ({gm['tflops']:.2f} "
        f"TFLOP/s f32, bound {gm['bound_ms']:.1f} ms), peak over the bill "
        f"{gm['peak']['peak_over_bill']:.4f}")
    if "multi" in out:
        for leg, r in out["multi"][0].items():
            log(f"linalg (b) rank 0 over NCCL, world {world}, {leg}: {r}")
    if not_run:
        log(f"linalg (b) NOT RUN: {'; '.join(not_run)}; {cards} card(s) "
            "visible")
    log(f"linalg (c) consumers: {out['consumers']}")
    log(f"phase 26 {out['seconds']:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in laps.items()))
    return out


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

    laps, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """The seconds since the last lap, under the phase's name."""
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    rows = check_kernels(dev)
    lap("3")
    result = serve_and_check(dev, GPT2_SMALL)
    lap("4-5")
    flash_rows = check_flash(dev)
    lap("6")
    train = train_and_check(dev, BERT_BASE)
    lap("7")
    torch.cuda.empty_cache()
    lenet = lenet_and_check(dev, LENET)
    lap("8")
    parity = resnet_parity(dev, RESNET_PARITY)
    net, x, y, timed = resnet_timed(dev, RESNET_TIMED)
    trace = resnet_trace(net, x, y, RESNET_TIMED["traced_steps"],
                         timed["step_ms_median_3_on"])
    lap("9")
    del net, x, y
    torch.cuda.empty_cache()
    nd4j = nd4j_and_check(dev)
    lap("10")
    torch.cuda.empty_cache()
    sd_mlp_res = samediff_mlp(dev, SD_MLP)
    sd_enc = samediff_encoder(dev, BERT_BASE, train)
    lap("11")
    torch.cuda.empty_cache()
    rnn = char_rnn_phase(dev)
    lap("12")
    torch.cuda.empty_cache()
    dp = data_parallel_phase(dev, RESNET_TIMED, timed)
    lap("13")
    torch.cuda.empty_cache()
    runtime = runtime_phase(dev, train, timed, trace)
    lap("14")
    zoo = cnn_zoo_phase(dev, timed)
    lap("15")
    torch.cuda.empty_cache()
    catalogue = catalogue_phase(dev)
    lap("16")
    torch.cuda.empty_cache()
    fine = fine_tune_phase(dev, train, runtime, zoo)
    lap("17")
    gc.collect()
    torch.cuda.empty_cache()
    serving = serving_phase(dev)
    lap("18")
    gc.collect()
    torch.cuda.empty_cache()
    sdx = samediff_rest_phase(dev)
    lap("19")
    gc.collect()
    torch.cuda.empty_cache()
    det = detection_import_phase(dev, sdx["onnx"])
    lap("20")
    gc.collect()
    torch.cuda.empty_cache()
    wv = word_vectors_phase(dev)
    lap("21")
    gc.collect()
    torch.cuda.empty_cache()
    rl = rl_search_profiler_phase(dev)
    lap("22")
    gc.collect()
    torch.cuda.empty_cache()
    cap = capture_phase(dev)
    lap("23")
    gc.collect()
    torch.cuda.empty_cache()
    ana = analysis_phase(dev)
    lap("24")
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_axes_phase(dev, train)
    lap("25")
    gc.collect()
    torch.cuda.empty_cache()
    linalg_phase(dev)
    lap("26")
    launches = dict(result["serve"]["launches"])
    launches["decode"] += sum(cap["decode"][k]["k4_launches"]
                              for k in ("eager", "graphs"))
    launches["decode"] += ana["soak"]["k4_launches"]
    launches["prefill"] += ana["soak"]["k5_launches"]
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
            "launches": train["launches"][key]
            + train["remat"]["launches"][key] + sd_enc["launches"][key]
            + runtime["encoder"]["launches"][key]
            + fine["graph_transfer"]["launches"][key]
            + det["keras_mha"]["launches"].get(key, 0)
            + cap["training"]["encoder"]["launches"][key]
            + (mesh["b"]["launches_both_ranks"][key] if "b" in mesh else 0),
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
    sw, sp, sh, sl, s8, ss, sg = (serving[k] for k in (
        "warm", "parity", "http", "load", "int8", "swap", "fleet"))
    log(f"one-shot serving on {card}: ResNet-50 bf16 NHWC 224^2 behind "
        "ModelHost, warm " + ", ".join(
            f"b{b} {v:.3f} s" for b, v in sw["bucket_seconds"].items())
        + f"; same-bucket coalescing bitwise, bucket 1 vs coalesced "
        f"{sp['bucket1_vs_coalesced_max_abs']:.3e} max-abs "
        f"({sp['bucket1_vs_coalesced_floored_bf16_ulps']:.2f} floored bf16 "
        f"ulps), logits {sp['logits_bucket1_vs_coalesced_rel_max_abs']:.3e}"
        f" of their max-abs, top-1 {sp['bucket1_vs_coalesced_top1']:.3f}; "
        f"HTTP codes {sh['codes']}; "
        f"open loop at {sl['rate']:.0f} req/s: serial "
        f"{sl['serial']['requests_per_sec']} req/s (p50 "
        f"{sl['serial']['p50_ms']} / p99 {sl['serial']['p99_ms']} ms), "
        f"batched {sl['batched']['requests_per_sec']} req/s (p50 "
        f"{sl['batched']['p50_ms']} / p99 {sl['batched']['p99_ms']} ms), "
        f"{sl['speedup']:.2f}x, occupancy "
        f"{sl['occupancy']['mean_occupancy']} ({sl['occupancy']['histogram']}"
        f"), cold dispatches {sl['cold_dispatches']}; bucket-128 dispatch "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sl["bucket128_split_ms"].items())
        + f" ms; int8 {s8['int8_ms_b128']:.2f} vs bf16 "
        f"{s8['bf16_ms_b128']:.2f} ms a b128 dispatch, "
        f"{s8['int8_weight_bytes']} vs {s8['bf16_weight_bytes']} weight "
        f"bytes, top-1 {s8['top1_agreement']:.4f}; two swaps under load: "
        f"errors {ss['errors']}, cold {ss['cold_dispatches']}; fleet skew "
        f"{sg['skew']['requests_per_sec']} req/s, chaos failovers "
        f"{sg['chaos']['chaos_failovers']:.0f}, swap_all errors "
        f"{sg['swap_all']['errors']}; phase 18 {serving['seconds']:.1f} s")
    xa, xb, xc, xd = (sdx[k] for k in ("onnx", "lenet", "control",
                                       "sweep"))
    log(f"SameDiff rest and ONNX import on {card}: ResNet-50 from ONNX "
        f"({xa['model_bytes']} bytes, {xa['ops']} ops of which "
        f"{xa['permutes']} permutes, imported in {xa['import_s']:.2f} s) "
        f"logits {xa['logits_rel_max_abs']:.2e} of the max-abs from the "
        f"native net's, top-1 {xa['top1_agreement']:.3f}; b"
        f"{ONNX_RESNET['batch']} forward imported {xa['imported_ms']:.2f} "
        f"ms / {xa['imported_kernels']} kernels vs native "
        f"{xa['native_ms']:.2f} ms / {xa['native_kernels']} kernels; "
        f"SameDiff LeNet loss rel {xb['loss_rel']:.2e}, gradients "
        f"{xb['worst_grad_rel_l2']:.2e}, fit "
        f"{xb['fit_steps_per_s']:.0f} steps/s, {xb['kernels_per_step']} "
        f"kernels a step, resume bitwise; control flow: unbounded "
        f"{xc['unbounded_trips']} trips, bounded weights "
        f"{xc['bounded_weights_rel']:.2e} from the CPU's; "
        f"{len(xd['ops'])} sweep cases; phase 19 {sdx['seconds']:.1f} s")
    da, dz, dc = det["yolo2"], det["zoo"], det["c3d"]
    dk, dm, dt = det["keras_resnet"], det["keras_mha"], det["tf_resnet"]
    log(f"detection, zoo, 3-d and import on {card}: YOLO2 bf16 NHWC b"
        f"{YOLO_MAIN['batch']} at {YOLO_MAIN['image']}^2 "
        f"{da['step_ms_median_3_on']:.2f} ms a step, "
        f"{da['images_per_s']:.1f} images/s, "
        f"{da['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
        f"{da['kernels_per_step']} kernels a step (device: " + ", ".join(
            f"{k} {100 * v:.1f} %"
            for k, v in da["trace"]["device_share"].items())
        + f"), f32 loss {da['parity']['f32_loss_rel']:.2e} / gradients "
        f"{da['parity']['f32_worst_grad_rel_l2']:.2e} from the CPU's f64, "
        f"{da['parity']['detections']} detections equal; " + "; ".join(
            f"{m} b{r['batch']} {r['step_ms_median_3_on']:.2f} ms, "
            f"{r['images_per_s']:.1f} images/s, "
            f"{r['max_memory_allocated_bytes'] / 2**30:.2f} GiB"
            for m, r in dz.items())
        + f"; C3D b{C3D['batch']} {dc['step_ms_median_3_on']:.2f} ms a step, "
        f"{dc['clips_per_s']:.1f} clips/s, "
        f"{dc['max_memory_allocated_bytes'] / 2**30:.2f} GiB; Keras "
        f"ResNet-50 logits {dk['logits_rel_max_abs']:.2e} from the zoo "
        f"net's, imported in {dk['import_s']:.2f} s, b"
        f"{KERAS_RESNET['batch']} {dk['imported_ms']:.2f} ms / "
        f"{dk['imported_kernels']} kernels; Keras MHA K1 "
        f"{dm['launches']['K1']} launches, {dm['output_rel_max_abs']:.2e} "
        f"from the CPU; TF ResNet-50 ({dt['graph_bytes']} bytes, imported "
        f"in {dt['import_s']:.2f} s) logits {dt['logits_rel_max_abs']:.2e}, "
        f"b{TF_RESNET['batch']} {dt['imported_ms']:.2f} ms / "
        f"{dt['imported_kernels']} kernels beside 19(a)'s ONNX "
        f"{dt['phase19a_onnx_ms']:.2f} ms / {dt['phase19a_onnx_kernels']}; "
        f"phase 20 {det['seconds']:.1f} s")
    wa, wb, wc, wd, we, wf, wg = (wv[k] for k in (
        "word2vec", "modes", "fasttext", "glove", "stack", "neighbours",
        "graph_tsne"))
    log(f"word vectors and nearest neighbours on {card}: (a) CBOW "
        f"{wa['vocab']} x {W2V_TEXT8['layer']} over {wa['words']} words, "
        f"scan {wa['scan_s']:.2f} s, {wa['words_per_s']:.0f} words/s, "
        f"{wa['steps_per_s']:.0f} steps/s, {wa['kernels_per_step']:.0f} "
        f"kernels a step, busy {100 * wa['device_busy_share_of_traced_wall']:.1f}"
        f" %, {wa['max_memory_allocated_bytes'] / 2**30:.2f} GiB, loss "
        f"{wa['loss_first']:.4f} -> {wa['loss_last']:.4f}, topic share "
        f"{wa['topic_share']:.3f}, card vs CPU "
        f"{max(wa['parity_rel'].values()):.2e}; (b) steps/s " + ", ".join(
            f"{k} {v['steps_per_s']:.0f}" for k, v in wb.items()
            if isinstance(v, dict))
        + f", Huffman code length {wb['cbow_hs']['huffman_code_length']}; "
        f"(c) FastText skipgram {wc['skipgram']['steps_per_s']:.0f} steps/s"
        f", {wc['skipgram']['max_memory_allocated_bytes'] / 2**30:.2f} GiB, "
        f"supervised {wc['supervised']['steps_per_s']:.0f} steps/s, "
        f"{wc['supervised']['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
        f"(d) GloVe {wd['entries']} entries in {wd['cooccurrence_s']:.2f} s, "
        f"{wd['steps_per_s']:.0f} steps/s; (e) binary "
        f"{we['binary']['bytes']} bytes {we['binary']['write_s']:.2f} s, text "
        f"{we['text']['bytes']} bytes {we['text']['write_s']:.2f} s, Kim CNN "
        f"{we['kim_cnn']['step_ms_median_3_on']:.2f} ms a step, "
        f"{we['kim_cnn']['sentences_per_s']:.0f} sentences/s; (f) k-means "
        f"{wf['kmeans']['iterations']} iterations, "
        f"{wf['kmeans']['host_flag_reads']} flag reads, "
        f"{wf['kmeans']['ms']:.1f} ms; LSH recall@10 "
        f"{wf['lsh']['recall_at_10']:.3f}, index {wf['lsh']['index_ms']:.1f} "
        f"ms; server p50 {wf['server']['p50_ms']:.2f} ms; (g) DeepWalk walks "
        f"{wg['deepwalk']['walk_s']:.2f} s, "
        f"{wg['deepwalk']['words_per_s']:.0f} words/s; t-SNE "
        f"{wg['tsne']['ms_per_iteration']:.3f} ms an iteration, KL "
        f"{wg['tsne']['kl_start']:.3f} -> {wg['tsne']['kl_end']:.3f}; phase "
        f"21 {wv['seconds']:.1f} s")
    ra, rp, rb, rc, rd = (rl[k] for k in ("dqn", "profiler",
                                          "actor_critic", "chain",
                                          "arbiter"))
    rt = ra["copy_traffic_per_learn_step"]
    log(f"RL, search and the profiler on {card}: (a) Nature DQN "
        f"b{NATURE_DQN['batch']} {ra['steps']} steps ({ra['frames']} "
        f"frames), {ra['env_steps_per_s']:.0f} env steps/s, "
        f"{ra['learn_steps_per_s']:.0f} learn steps/s, learn step "
        f"{ra['learn_ms_median']:.2f} ms median, "
        f"{ra['kernels_per_learn_step']:.0f} kernels, "
        f"{rt['h2d_copies']:.0f} host->device copies of "
        f"{rt['h2d_bytes']:.0f} bytes and {rt['d2h_reads']:.0f} "
        f"device->host reads a learn step (np.stack "
        f"{ra['host_split']['stack_ms']:.2f} ms, the copies "
        f"{ra['host_split']['h2d_ms']:.2f} ms), busy "
        f"{100 * ra['device_busy_share_of_traced_wall']:.1f} %, "
        f"{ra['peak_over_before_bytes'] / 2**30:.2f} GiB peak over what was "
        "allocated before, replay "
        f"{ra['replay_bytes_unique'] / 2**30:.2f} GiB, card vs CPU Q "
        f"{ra['parity']['q_rel']:.2e}, gradients "
        f"{ra['parity']['first_grads_rel']:.2e}, params after "
        f"{NATURE_DQN['parity_steps']} RMSProp steps "
        f"{ra['parity']['params_rel_after_rmsprop_steps']:.2e}"
        + "; (b) " + "; ".join(
            f"{k} ({v['envs']} envs) {v['rollouts_per_s']:.0f} rollouts/s, "
                    f"{v['env_steps_per_s']:.0f} env steps/s, update "
                    f"{v['update_ms_median']:.2f} ms, "
                    f"{v['kernels_per_rollout_and_update']:.0f} kernels a "
                    f"rollout, busy "
                    f"{100 * v['device_busy_share_of_traced_wall']:.1f} %"
                    for k, v in rb.items() if k != "parity")
        + f"; (c) chain scores " + ", ".join(
            f"{k} {v['play_score']}" for k, v in rc.items())
        + "; (d) " + ", ".join(
            f"{k} {v['candidates']} x {v['s_per_candidate']:.2f} s, best "
            f"{v['best_score']:.4f}" for k, v in rd.items()
            if k != "invalid")
        + f"; (e) section first {rp['sections']['first_call_ms']:.2f} ms, "
        f"steady {rp['sections']['steady_avg_ms']:.2f} ms vs CUDA events "
        f"{rp['sections']['steady_event_ms_mean']:.2f} ms, Q forward "
        f"{rp['q_forward_b32_flops']:.0f} flops, learn step mfu "
        f"{rp['learn_step_mfu']:.2e}; phase 22 {rl['seconds']:.1f} s")
    cd, ct = cap["decode"], cap["training"]
    co = cap["oneshot"]
    log(f"capture on {card}: bucket-8 decode step host "
        f"{cd['decode_step']['eager']['host_ms']:.3f} -> "
        f"{cd['decode_step']['replayed']['host_ms']:.3f} ms, device "
        f"{cd['decode_step']['eager']['device_ms']:.3f} -> "
        f"{cd['decode_step']['replayed']['device_ms']:.3f} ms; carry-slot "
        f"step host {cd['carry_slot_step']['eager']['host_ms']:.3f} -> "
        f"{cd['carry_slot_step']['replayed']['host_ms']:.3f} ms; burst TTFT "
        f"p50 {cd['eager']['ttft_p50_s']:.4f} -> "
        f"{cd['graphs']['ttft_p50_s']:.4f} s, decode "
        f"{cd['eager']['decode_tok_per_s']:.0f} -> "
        f"{cd['graphs']['decode_tok_per_s']:.0f} tokens/s; one-shot b1 "
        f"{co['b1_eager_host_ms']:.2f} -> {co['b1_replayed_host_ms']:.2f} "
        f"ms, b128 {co['b128_eager_host_ms']:.2f} -> "
        f"{co['b128_replayed_host_ms']:.2f} ms; training step ms (eager -> "
        "captured): " + ", ".join(
            f"{k} {v['eager']['step_ms']:.2f} -> {v['captured']['step_ms']:.2f}"
            for k, v in ct.items()) + f"; autotune winners "
        f"{cap['autotune']['resnet50']['knobs']}; ledger ratio "
        f"{cap['ledger']['ratio_to_floor']:.3f}; phase 23 "
        f"{cap['seconds']:.1f} s")
    ab, az = ana["par06"], ana["zoo"]
    log(f"analysis on {card}: {az['models']} zoo models validated in "
        f"{az['seconds']:.2f} s, {az['allocated_delta_bytes']} bytes on the "
        "card; PAR06 predicted/measured: " + ", ".join(
            f"{k} b{v['batch']} eager {v['eager_ratio']:.3f} "
            f"({v['predicted_eager_bytes'] / 1e9:.2f}/"
            f"{v['eager_measured_bytes'] / 1e9:.2f} GB)" + (
                f", captured {v['captured_ratio']:.3f} "
                f"({v['predicted_captured_bytes'] / 1e9:.2f}/"
                f"{v['captured_measured_bytes'] / 1e9:.2f} GB), b"
                f"{v['refused_batch']} refused"
                if "captured_ratio" in v else "") for k, v in ab.items())
        + f"; soak K4 {ana['soak']['k4_launches']}, K5 "
        f"{ana['soak']['k5_launches']}, {ana['soak']['fired']} faults, "
        f"coverage {ana['soak']['coverage']}; phase 24 "
        f"{ana['seconds']:.1f} s")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in laps.items()))
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
