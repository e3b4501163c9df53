#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all at once) and report the time, the libraries and ptxas's
   register, shared-memory and spill lines.
2. kernels: hold each kernel against its plain PyTorch version on the card
   and time kernel, plain version and a library yardstick: flash attention
   B1 (causal and not, head dim 64 and 128, bf16 and f32), then its
   backward B2 (dK, dV) and B3 (dQ) at the training shape (4 x 1024, 16
   heads of 64, bf16, causal) and five more; B1, B2 and B3 at a
   tensor-parallel 1.3B rank's (2 x 1024, 8 heads of 128, bf16, causal)
   and B1 at its prefill's (4 x 512); B1, B2 and B3 at a 1.3B pipeline
   rank's micro-batch (1 x 1024, 8 heads of 128, bf16, causal); the
   layouts' (a ring rank's 1 x 4096 causal and not, a micro-batch's 1 x
   1024, 16 heads of 128); B1, B2 and B3 at a moe_ep rank's (2 x 1024, 16
   heads of 64, bf16, non-causal); B1, B2 and B3 at a ps trainer's (4 x
   512, 12 heads of 64, bf16, non-causal) and B1 at the FleetExecutor's
   micro-batch (2 x 512); B1 at translate's encoder
   shape (8 x 256, 8 heads of 64, bf16, non-causal); last B1, B2 and B3
   at BERT's shape (8 x 512, 12 heads of 64, bf16, non-causal, q, k and
   v three contiguous tensors). bf16 runs the tensor-core
   variants, f32 the CUDA-core (SIMT) ones; each row names the variant
   that ran. At the bf16 causal shapes and at BERT's the wrapper's whole
   backward (bwd_delta, B2 and B3) is also timed against the library's,
   with bwd_delta's own share. "ms" is device time (the kernels' summed
   duration under torch.profiler, per call; a profile that lost kernels
   is taken again, and after three such tries the time comes from CUDA
   events around calls queued behind a spin kernel, with a
   timing_fallback line); "wall_ms" is CUDA-event time over back-to-back
   calls, which includes the host's launch cost where the host is slower
   than the kernel.
3. reference: a small GPT on the card is held against the same model on
   the host (whose math path the host tests hold against paddle_tpu):
   greedy decode, and 3 AdamW training steps in f32.
4. serve: GPT-medium at full width (vocab 32000, hidden 1024, 12 of its
   24 layers, as in every GPT-medium lane here,
   16 heads, random weights from --seed) serves 4 x 512-token prompts and
   64 greedy KV-cached decode steps in bf16 through the port's entry point,
   with the launch counts reset just before and read just after. The
   kernel path is then compared with the math path (use_flash_attention
   off) in bf16 and, at full width, in f32, where the greedy tokens must
   be identical. The bf16 model is then profiled (torch.profiler) over one
   prefill and 16 decode steps: device time by kernel and busy share.
5. train: GPT-medium at full width in bf16 with AdamW(multi_precision)
   trains on bench.py's permutation stream, batch 4 x 1024, through
   ``jit.to_static`` on the eager path (FLAGS_compiled_step=0): 4 warm-up
   steps, then 16 timed steps with the launch counts reset just before
   and read just after (12 launches each of B1, B2 and B3 per step, all
   on the tensor cores). Then one bf16 step is profiled, bwd_delta's
   kernels summed apart; one f32 step at full width holds the kernel
   path's loss and grads against the math path's (the SIMT variants), and
   the same weights cast to bf16 hold the tensor-core path's grads against
   the f32 math path's, no further from it than twice the bf16 math path.
6. compiled_train: the same cell with the step captured as one CUDA graph
   (``CompiledTrainStep`` over ``to_static``), the same weights and
   batches: 1 compile in the 4 warm-up steps, 0 compiles and 16 cache
   hits in the 16 timed steps, the loss curve within 2e-2 of the eager
   run's step by step, step time, tokens/s and peak memory beside the
   eager run's, and one replayed step profiled (one graph launch; B1, B2
   and B3 12 times each, counted by kernel name, since a replay does not
   pass through the wrappers' Python counts).
7. amp_train: GPT-medium with f32 parameters under auto_cast(bf16),
   recompute, AdamW + ClipGradByGlobalNorm(1.0) + LinearWarmup, captured
   and driven through run_steps (K = 4, three executions, the scheduler
   stepping between them): the lr read back at each step equals the
   scheduler's, the last execution's mean loss is below the first's; the
   second execution is profiled (B1 24 times a step, B2 and B3 12).
8. to_static_grad: the captured step's repaired faults on BERT-base in
   f32 at 4 x 256 (B1, B2 and B3 in its graphs): a forward-only ``to_static(model)`` under an outer
   backward gives eager's grads on its calls 1-3 (its forward and backward
   captured as two graphs), differentiating a self-backward step's output
   raises the reference's error, and an optimizer built on host
   parameters, the model then moved to the card, reads its scheduler's lr
   at every replay.
9. bert_train, ernie_train: bench.py's BERT lane (bench_bert): BERT-base
   (then ERNIE-base) with dropout 0 in bf16, AdamW(1e-4,
   multi_precision), the parity-label stream at 16 x 128, the step
   captured and driven through run_steps with 64 steps an execution, 192
   recorded steps, once for each of three weight draws (seeds
   --seed, +1, +2) on the one data stream; the median of their last-32
   means below bench's chance floor 0.62; each run 1 compile in the
   warm-up, 0 timed, and a replay profiled.
10. bert_flash: BERT-base at 8 x 512 with no mask, where attention takes
   B1, B2 and B3 non-causal: one f32 step (kernel path against math
   path), the same weights in bf16 against the f32 truth, eval logits and
   latencies of both paths, and a captured bf16 step on each path (B1, B2
   and B3 12 times each per replay, by kernel name).
11. vision_reference: a ResNet-18 (10 classes, NHWC, the space-to-depth
   stem, fused conv + BN) at 2 x 3 x 64 x 64 and a LeNet on the card are
   held against the same models on the host in f32 (TF32 off): one
   Momentum step's loss, grads and moved running statistics, then the
   eval logits.
12. resnet_train: bench.py's ResNet-50 lane (bench_resnet50) at full width
   and depth: bf16, batch 128 at 224 x 224, NHWC, the space-to-depth stem,
   fused conv + BN, Momentum(0.1, 0.9), the step captured and driven by
   run_steps K = 32, 2 warm-up + 12 timed executions over 3 staged stacks
   of bench's prototype stream (made on the card): 448 recorded steps, the
   last-32 mean below bench's chance floor 6.71, 1 compile in the warm-up
   and none timed, running statistics that move; step ms, images/s, MFU,
   peak memory and a replay's profile by kernel class.
13. resnet_fused: ResNet-50 fused against unfused conv + BN: one f32 step
   at 32 x 224 x 224 (loss and every grad), and a bf16 eager step at batch
   128 (peak memory over what the step starts with, step ms).
14. resnet_eval: the trained ResNet-50 in eval mode, bf16, on the fused
   op's folded-statistics path against BatchNorm in eval, both held to the
   f32 unfused logits, at batch 128 and 1; latency and device time.
15. lenet_train: bench.py's LeNet lane (bench_lenet): f32, Adam(1e-3),
   batch 256, run_steps K = 32, 2 warm-up + 1 timed executions, the
   last-32 mean below bench's floor 1.80; images/s.
None of the conv net paths runs B1, B2 or B3: each counts 0 launches of
them, and the kernels line says so.
16. serving (``--phases serving``): the serving stack through its entry
   points. (a) BERT-base sequence classification at full width in bf16
   behind ``inference.Config`` + ``serving.InferenceServer`` (2 replicas
   sharing one CUDA graph per bucket 1, 2, 4, 8, all captured in warm-up,
   started threaded): 4 client threads send 64 requests of one 512-token
   row; every reply within 2^-7 relative L2 of a bf16 eager forward of
   its row, and no further from the f32 one than twice that forward's own
   gap + 2^-7, no shed or failure, no compile after warm-up, B1 12 times (tc_bf16) in a
   profiled replay of the bucket-8 graph and no softmax kernel; latency
   p50/p99, requests/s, occupancy, device ms per batch, peak memory,
   hedges. (b) The decode engine attached to that server: 8 prompts, the
   known stream of [1, 2, 3, 4, 5], identical prompts identical, compiles
   within the backend's buckets, the KV pool back to full, TTFT and TPOT.
   (c) ResNet-50 eval (NHWC, space-to-depth stem, fused) in bf16 behind
   the same server, 16 requests of one 224 x 224 f32 image (cast to bf16
   per call): replies held as (a), no B1.

17. hapi (``--phases hapi``): the high-level training API through its
   entry points (``io.DataLoader`` or a dataset handed to ``fit``, then
   ``Model``, ``prepare``, ``fit``, ``evaluate``, ``predict``, ``save``,
   ``load``). (a) hapi_lenet: LeNet f32 on synthetic MNIST, one epoch
   from the spawn pool with eval_data and ModelCheckpoint; the same
   weights with steps_per_execution=4 (equal losses); predict, save and
   load into a fresh Model (equal state and evaluation); 8 steps card
   against host within 2e-5; accuracy above 0.5 on a held-in slice.
   (b) hapi_resnet50: ResNet-50 f32 on Flowers behind RandomResizedCrop
   (224), a flip and Normalize, batch 64, 4 spawned workers, Momentum
   under a cosine schedule the LRScheduler callback steps; images/s, the
   StepTimer's phases and the card's busy share over 4 timed steps
   with cuDNN's default algorithms, a hand captured step's time beside
   fit's, and a deterministic fit of 2 steps against a hand-written
   captured loop on the same batches (within 1e-4). (c) hapi_bert:
   BERT-base bf16 at 8 x 512 through fit with steps_per_execution=4,
   every loss within 1e-3 of a hand-written CompiledTrainStep loop, one
   capture in the warm-up and none timed, and B1, B2 and B3 12 times
   each in a profiled replay of fit's compiled step.

18. optim (``--phases optim``): the script surface. (a) optim_bert:
   bert_flash's cell (BERT-base bf16, 8 x 512, B1-B3 non-causal) under
   each optimizer of the reference's __all__ (LarsMomentum is Lars) and
   two script-shaped runs (PaddleClas's Momentum + L2Decay(1e-4),
   PaddleNLP's AdamW without decay on biases and norms and with a
   layer-wise lr_ratio), each captured: discovery and capture, 3 timed
   replays, a profiled replay (B1/B2/B3 12 each); the first update
   (the discovery pass's, on the card) equals the same optimizer's on
   the host from the card's parameters and grads (f32 relative L2 1e-6,
   bf16 one ulp of the operands); step ms, device ms and kernels a replay, its
   multi-tensor kernels and the optimizer's own kernels in an eager
   step. (b) optim_sparse: GPT-medium's word table (32000 x 1024 f32)
   with sparse gradients, 4 eager steps of 4 x 1024 ids: one gradient
   row per id, untouched rows bitwise, SGD sparse = dense within 1e-6,
   lazy Adam = the host within 1e-6; step ms and gradient bytes. (c)
   tensor_api: every case of tests/test_torch_tensor_cases.py on the
   card against the host (f32 1e-6, integers and bools exact). (d)
   recompute_dropout: BERT-base f32 4 x 256 with dropout 0.1 and every
   encoder layer recomputed, captured: each replay's loss and grads
   equal the plain captured step's (1e-5), new masks each replay. The
   captured GPT-medium, BERT-base and ResNet-50 lanes also print their
   replay's multi-tensor kernels and the optimizer's own kernels.

19. surface (``--phases surface``): the common surface. (a) nn_cases:
   every case of tests/test_torch_nn_cases.py (activations, the common
   functions, initializers, activation/common/container layers) on the
   card against the host (f32 1e-6, interpolate and fold 1e-5, integers
   and bools exact). (b) mobilenet_train, the slice's full-width path:
   MobileNetV2 (scale 1.0, 1000 classes) built on the host with
   KaimingNormal through set_global_initializer, saved as .pdparams and
   loaded into the card's model by set_state_dict(paddle.load(path)),
   bf16, NHWC, batch 128 at 224 x 224 of bench's prototype stream,
   Momentum(0.9) + L2Decay(4e-5) under CosineAnnealingDecay from 0.045,
   captured, run_steps K = 32, 2 warm-up + 4 timed executions: losses
   finite and falling (last 32 below first 32), 1 compile in the warm-up
   and none timed; step ms, images/s, peak memory, a replay's device time
   by kernel class, launches and busy share; then one epoch (96 steps) of
   the same stream through Model.fit with steps_per_execution=4, its step
   time over the captured step's. (c) mobile_nets_small: MobileNetV1/V2
   (scale 0.25) and ShuffleNetV2 x0.25 at 2 x 64 x 64 in f32, one
   Momentum + L2Decay step card against host (loss 2e-5, grads 1e-4 plus
   4 x the host's own f32 noise, eval logits 1e-4). (d) mobilenet_eval:
   the trained MobileNetV2 in bf16 eval, BN folded into the convs against
   BN eval, both held to f32 BN eval; latency at batch 128 and 1. (e)
   state_guard: the degenerate-weight guard (ROADMAP C3) through a
   captured fused_residual_ln step: a set_state_dict or an in-place
   zero_ that changes the verdict builds a new program and gives plain
   autograd's dw; one that keeps it builds none. None of these lanes
   launches B1, B2 or B3 (``launches_surface`` on the kernels line).

20. nn_rest (``--phases nn_rest``): the rest of nn. (a) nn_rest_cases:
   every case of tests/test_torch_nn_rest_cases.py (1-D, 3-D and
   transposed convs, poolings with masks and unpooling, the group,
   instance, local-response and spectral norms, nn.utils, vision.py's
   samplers, sparse_attention, gather_tree) on the card against the host
   (f32 1e-6, the transposed convs and samplers 1e-5, integers and bools
   exact). (b) rnn_small: LSTM, GRU and SimpleRNN (tanh, relu), 2 layers,
   bidirectional, 3 x 7 x 16, f32 card against host (outputs 1e-5, grads
   1e-4; the tanh SimpleRNN 2e-5 and 5e-4, cuDNN's tanh cell being less
   accurate than the host's), and BeamSearchDecoder over a GRUCell with finished beams
   (tokens and parents identical). (c) translate, a full-width path:
   Transformer-base (nn.Transformer's defaults) with a shared
   37000-token embedding, bf16, 8 sources of 256 tokens encoded (B1 6
   times, tc_bf16, non-causal, at (8, 256, 8, 64)) and decoded with beam 4
   through TransformerBeamSearchDecoder + dynamic_decode (at most 128
   steps); beam 1 equals a greedy loop over the same cell; encode ms,
   time to the first token, step ms p50/p99, decoded tokens/s, kernels a
   step, busy share, peak memory. (d) lstm_lm, a full-width path: the
   PTB "medium" LSTM LM (vocab 10000, 2 x LSTM(650), dropout 0.5, SGD(1.0)
   + ClipGradByGlobalNorm(5.0), f32, 20 x 35, truncated BPTT) captured by
   to_static, 2 + 256 steps on a Markov stream made on the card, the
   loss finite and falling; step ms, tokens/s, device time by class,
   busy share, peak memory.

21. zoo (``--phases zoo``): the rest of paddle.vision and paddle.text.
   (a) vision_zoo_small: every family of tests/test_torch_zoo_stages.py
   (AlexNet, VGG-11 with and without BN, SqueezeNet 1.0 and 1.1,
   GoogLeNet, InceptionV3, DenseNet-121, ResNeXt-50 32x4d fused and
   unfused), 10 classes, f32, card against host: eval logits and loss
   2e-5, grads 1e-4 + 4 x the host's own f32 noise, the families that
   are ill-conditioned as a whole held block by block. (b)
   densenet_train, the slice's full-width training path: DenseNet-121
   bf16 NHWC, batch 128 x 224 x 224 of bench's prototype stream,
   Momentum(0.1, 0.9, Nesterov) + L2Decay(1e-4), captured, run_steps K =
   4, 4 warm-up and 64 timed steps: the first 8 losses within 2e-2 of an
   eager run's, 1 compile in the warm-up and none timed; step ms,
   images/s, MFU, peak memory, a replay by kernel class (concat and
   layout copies apart), busy share. (c) zoo_eval: AlexNet, VGG-16,
   SqueezeNet 1.1, GoogLeNet, InceptionV3 (299), DenseNet-121 and
   ResNeXt-50 at 1000 classes, bf16 NHWC, batch 64, through
   inference.Predictor (one CUDA graph): every row within 2^-7 of a bf16
   eager forward; warm-up s, replay ms p50, images/s, kernels a replay.
   (d) vision_ops: every op of vision.ops and viterbi_decode at the
   detectors' sizes (Faster R-CNN FPN's RoIAlign/RoIPool, R-FCN's
   PSRoIPool, DCN v1/v2, an RPN's NMS, a class-aware fixed-size NMS, then
   captured as a CUDA graph, YOLOv3's three heads and loss, a CRF's
   Viterbi) card against host (1e-5; indices and paths identical);
   device ms and launches. (e) tokenize_bert: raw documents longer than
   512 wordpieces -> FasterTokenizer -> BERT-base bf16 through
   inference.Predictor with no mask (B1 12 times a replay, tc_bf16), ids
   on the card equal to the host's, rows within 2^-7 of a bf16 eager
   forward; tokenizer, predictor, device and end-to-end ms, documents/s,
   busy share; then short pairs padded to 128 with a mask (the math
   path, 0 B1 launches).
22. dist_tune (``--phases dist_tune``): the autotuner, the fusion policy
   and data parallelism, with a fresh autotune cache. (a) autotune: every
   tile of B1, B2 and B3 at GPT's (4, 1024, 16, 64) causal, one dp_gpt
   rank's (2, 1024, 16, 64), BERT's (8, 512, 12, 64) and head dim 128:
   ptxas's registers and spills, relative L2 to the plain version under
   the 2^-7 gate, device ms and bound; the tuner's search and its winner
   at each shape; then a second process over the same cache makes the
   same decisions with 0 searches. (b) fusion_policy: each fused op
   against its unfused form at GPT-medium's and ResNet-50's shapes, and
   flash attention against the math path at GPT's and BERT's, forward and
   backward in bf16: both ms, the factor, the auto decision (the table)
   and the searched one (a tuner with fusion_search); then policy_steps:
   GPT-medium's step eager and captured with the fused forms everywhere,
   under auto (the table) and under the searched auto. (c) dp_gpt:
   GPT-medium bf16 (AdamW mp) under DataParallel at 2 ranks, two
   processes on the card (gloo over CUDA tensors), each with 2 x 1024 of
   bench's 4 x 1024 batch: the first step's reduced gradients bitwise
   equal on both ranks and their norm within DP_GRAD_RTOL of this
   process's serial step on the whole batch from the same weights, the
   first 3 global losses within DP_LOSS_RTOL of its losses, the weights
   after the steps bitwise equal on both ranks; step ms, buckets, flushes
   and ``step/collective_wait`` a step, B1-B3 launches a step per rank
   (12 each) and their tiles, busy share and peak memory; neither rank
   searches (the autotune lane's cache holds a rank's shape). (d)
   dp_fit: LeNet through Model.fit at world size 2 against one process's
   fit on the same global batches. (e) collectives:
   all_reduce (sum, max, bf16), broadcast, all_gather, reduce_scatter and
   alltoall on CUDA tensors over the 2 gloo ranks, and every collective
   over a one-rank NCCL group, against numpy.
23. hybrid (``--phases hybrid``): fleet's hybrid parallelism, rank
   processes on the one card over gloo (NCCL refuses two ranks a
   device), every TP all-reduce through the host (the surface group's
   phases run on this process beside tp_gpt's ranks). (a) tp_gpt: GPT-3 1.3B
   (GPTConfig.gpt3_1p3b, vocab 50304, hidden 2048, 16 heads of 128) at
   full width and 6 of its 24 layers through ``fleet.init`` (mp 2),
   ``distributed_model`` and ``distributed_optimizer``: each rank draws
   the full weights from a CUDA generator and keeps its shard
   (``load_numpy_state_dict``); greedy decode of 4 x 512 plus 8 cached
   steps in f32 against this process's serial model (a random 1.3B's top
   two logits sit within bf16's rounding); a bf16 prefill (B1 6 times,
   at (4, 512, 8, 128)); then 3 eager bf16 steps, AdamW(multi_precision,
   1e-4), bench's 1.3B batch 2 x 1024 from its permutation stream: the
   3 losses within 2 x the serial bf16 run's relative gap to its
   f32 run + 1e-3 of the serial bf16 run (both run here first, from the
   same weights, and freed before the ranks start), the replicated
   parameters bitwise equal across the ranks after every step, B1-B3 6
   times a step a rank (tc_bf16, at (2, 1024, 8, 128)); step ms,
   tokens/s, ``step/collective_wait``, the all-reduces and their bytes a
   step, busy share, peak memory, the tiles. (b) zero_gpt: GPT-medium
   bf16 under ZeRO-1 (sharding 2), bench's 4 x 1024 split 2 x 1024 a
   rank: weights bitwise equal across ranks after every step, the first
   3 losses within 1e-3 of the serial run, each rank's optimizer-state
   bytes and peak. (c) hybrid_geometry: the 1.3B layer geometry at 2
   layers in f32, SGD, dp 2 x mp 2 on 4 processes, 4 x 256 (B1-B3 on
   their f32 variants): 2 losses within 5e-4 of the serial run.

24. pipeline (``--phases pipeline``): the 1F1B pipeline and the hybrid
   checkpoint, rank processes on the one card over gloo (the bert
   group's phases run on this process beside pp_gpt's ranks: their
   captured replays share the card with the ranks' steps). (a) pp_gpt:
   GPT-3 1.3B at full width and 6 of its 24 layers as a PipelineLayer
   (the token table shared with the head through SharedLayerDesc,
   positions, the 6 GPT blocks on (x, pending), the final LayerNorm,
   ParallelCrossEntropy) at pp 2 x mp 2 on 4 processes, each rank
   holding its stage's 3 blocks
   with 8 heads of 128, bf16, AdamW(multi_precision, 1e-4), bench's 1.3B
   batch 2 x 1024 in 2 micro-batches of 1 x 1024, 3 steps: the 3
   losses within hybrid's tp_gpt bf16 rule of the serial 1.3B (the same
   weights and data), the replicated parameters bitwise equal across
   each stage's model ranks and the tied table's two copies bitwise
   equal across the stages after every step, B1 12 and B2, B3 6 times a
   step a rank (tc_bf16, at (1, 1024, 8, 128); the forward and its
   recompute), by wrapper and by kernel name in a profiled step; step
   ms, tokens/s, the point-to-point wait apart from the tensor-parallel
   all-reduces' (``step/collective_wait``), the bytes of each, busy
   share, peak memory, tiles. (b) pp_compiled: GPT-medium at pp 2 on 2
   processes, bench's 4 x 1024 in 4 micro-batches, 3 steps eager and 3
   with each stage's directions captured (CompiledStageProgram): the
   losses equal within 1e-5, no compile in the steps after the first,
   both stages captured, the losses within 1e-3 of the serial GPT-medium
   run; step ms of both and graph replays a step. (c) hybrid_ckpt: the
   1.3B layers at 2 of 24, bf16, AdamW with f32 masters, pp 2 x mp 2: 2
   steps, save_hybrid_checkpoint, 2 more steps; then fleet.init at dp 2 x
   mp 2, load_hybrid_checkpoint into the model built whole and 2 steps:
   the gathered weights and masters after the load equal those saved
   (sha256), the resumed losses within 1e-3 of the uninterrupted ones,
   a flipped byte raises CorruptCheckpointError; the file's bytes and the
   save's and load's seconds.

25. layouts (``--phases layouts``): the declarative layouts, ring
   sequence parallelism and the SPMD pipeline, 2 rank processes on the
   one card over gloo (one spawn, the lanes in turn; the optim group's
   phases run on this process beside them). (a) zero3_gpt:
   bench's GPT-3 1.3B slice (4 of its 6 layers, hidden 2048, 16 heads of 128,
   vocab 50304, batch 2 x 1024) in bf16, AdamW(multi_precision), trained
   through Model.prepare(spec_layout=SpecLayout(shard_params=True)) on
   {"sharding": 2}, 1 + 2 steps: the losses within hybrid's bf16 rule of
   the serial slice, half the parameter and optimizer-state bytes a rank
   (within 1 %), B1, B2 and B3 6 times a step a rank, by wrapper and by
   kernel name; step ms, the gathers and gradient reductions a step and
   their bytes, ``step/collective_wait``, busy share, peak against the
   serial slice's and fleet's ZeRO-1's (2 steps); the slice at 1 layer
   saved at sharding 2 and loaded into the serial slice gives back the
   same weights and f32 masters (sha256). (b) ring_attn: ring_attention
   on {"sep": 2} at (1, 8192, 16, 128) bf16, causal, (1, 4096, 16, 128)
   a rank, forward and backward: B1, B2 and B3 once on rank 0 and twice
   on rank 1, the gathered output and grads within relative L2 2^-7 of
   one rank's B1, B2 and B3 over the whole sequence, an f32 run at (1,
   2048, 4, 64), causal and not, within 1e-5 of the plain version; the
   ring's ms, p2p bytes and wait, device ms by kernel. (c) spmd_pipe: a
   PipelineStageStack of 2 stages of 3 of the 1.3B's blocks on {"pipe":
   2}, the tables, final LN and tied head replicated, bf16, AdamW mp,
   4 x 1024 in 4 micro-batches, 3 steps: the losses within the bf16 rule
   of the sequential stack (the same weights), the replicated
   parameters bitwise equal across the stages after every step, B1, B2
   and B3 12 times a step a rank, 4 ticks run and 1 bubble tick skipped
   a step; p2p bytes and wait, step ms, busy share, peak.

26. auto_moe (``--phases auto_moe``; it runs right after the kernels
   phase): auto_parallel and incubate, 2 rank processes on the one card
   over gloo (one spawn; the serial Engines, incubate_cases and the hapi
   group on this process meanwhile). (a) auto_engine: bench's
   GPT-3 1.3B slice in bf16, AdamW(multi_precision), through
   ``auto_parallel.Engine`` under ProcessMesh([0, 1], dim_names=["dp"])
   with amp (bf16, O1), gradient merge (k 2, avg) and sharding at stage 3,
   then at stage 1: 2 micro-steps of 2 x 1024 (1 x 1024 a rank), then
   evaluate over 2 batches and predict over 1: the losses, the eval loss
   and the predicted logits within the bf16 rule of the serial Engine at
   world size 1 (the step captured through to_static; bf16 and f32 runs),
   stage 3 half the parameter and optimizer-state bytes a rank (within 1
   %), B1, B2 and B3 4 times a micro-step a rank by wrapper and by kernel
   name; step ms, ``collective_wait``, busy share, peak. (b) moe_ep: a
   user model of 4 blocks of FusedMultiHeadAttention(1024, 16), a
   LayerNorm and an incubate.MoELayer(1024, 4096, 8 experts, top 2,
   capacity factor 1.25, expert_axis "ep") with a residual, GPT-medium's
   tied token table, bf16 under amp, AdamW mp, on {"ep": 2}: 2 x 1024
   tokens and 4 experts a rank, 3 steps, held to the same model whole on
   the whole 4 x 1024 batch: the first step's last-block output and the
   gradients of each rank's expert slices, the gates and an attention
   weight within relative L2 2^-7, the dropped tokens equal, the losses
   within the bf16 rule; B1, B2 and B3 4 times a step a rank (non-causal,
   (2, 1024, 16, 64)); the exchange's all-to-alls, bytes and wait a step.
   (c) incubate_cases: segment_*, softmax_mask_fuse and its upper
   triangle, LookAhead and ModelAverage (6 SGD steps) card against host
   within 1e-5; 12 FusedTransformerEncoderLayers at BERT-base's width in
   f32 at 1 x 256 card against host within 1e-4 (B1-B3 on their f32
   variants, 12 each), and in bf16 at 8 x 512, 3 AdamW mp steps, B1, B2
   and B3 12 times a step by wrapper and by kernel name.

27. elastic (``--phases elastic``; it runs right after auto_moe, and the
   vision group's phases run on this process beside its launches: their
   captured replays share the card with the launches' steps): launch
   and in-job recovery. GPT-medium bf16 (AdamW mp, 6 of its 24 layers)
   under DataParallel over 2 ranks on the card (gloo), each rank in a
   RecoveryManager with an ElasticManager on a FileStore, started by
   ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
   --max_restarts 1``: 4 steps of 2 x 1024 a rank of bench's 4 x 1024
   stream, a hybrid checkpoint after every second step. Two launches
   side by side (for the script's time; each one's step times carry the
   other's load): an uninterrupted one, with the other ranks' tools after
   its steps
   (p2p's group_all_reduce, group_all_gather, group_broadcast and
   group_barrier on tensors from the card against numpy; fleet.metrics'
   acc, auc, rmse and sum over both ranks' statistics against numpy on
   their sum; an abort: rank 1 fails inside an all_reduce through an
   injected fault while rank 0 waits in it, and rank 0 must raise the
   PeerAbort naming rank 1 within ELASTIC_ABORT_S), and the recovered
   one, while this process runs elastic_lenet
   (incubate.checkpoint.train_epoch_range with LeNet: a crash after epoch
   1 of 3, the resumed weights equal to an uninterrupted run's). In the
   recovered launch rank 1 dies at step 3
   by os._exit through a fault site of its first incarnation, the
   launcher relaunches it (PADDLE_TPU_GENERATION 1), the survivor tears
   its group down, both meet at generation 2 and restore the step-2
   checkpoint: the 4 losses equal the uninterrupted launch's to the bit,
   the journal names the launcher's worker_restart (rank 1, exit 9,
   generation 1) and the survivor's restart (its cause, generation 2, np
   2), B1, B2 and B3 run 6 times a step on every rank before and after
   the restart (by wrapper). Recorded: the seconds from the death to the
   survivor's error and to its first resumed step, the checkpoint's
   bytes and its save and load seconds, step ms and collective_wait
   before and after the restart, the group's seconds.

28. ps (``--phases ps``; it runs right after elastic, alone): the
   parameter server. (a) ps: BERT-base (bert_flash's configuration, f32
   parameters under amp O1 bf16, its word embedding a sparse table)
   through DistributeTranspiler over two PsServers, each a host process
   of its own (the card hidden from it), and two trainer processes on the
   card, each reading 4 x 512 of cls_stream's 8 x 512 batch through
   InMemoryDataset.batches(worker_id, 2): the init step (rank 0 seeds the
   dense tables) and 3 sync steps of TheOnePSRuntime with server SGD
   (B1, B2 and B3 tc_bf16 non-causal at (4, 512, 12, 64), 12 times a step
   on each trainer). Held to a serial BERT-base on this process with the
   same weights, its word rows those of the tables' first pulls
   (ROADMAP C-ref-29), doing the trainers' arithmetic: at each step the
   gradients of both trainers' 4 x 512 halves at the same parameters,
   then p -= lr * g with each half's in turn, as a pserver applies each
   push (the word rows by their merged sparse gradients). The mean of
   the trainers' losses at each step within the bf16 rule of the serial
   bf16 run (2 x its relative gap to the serial f32 run + 1e-3), and
   each dense table's update after the 3 steps (table - initial value)
   within the same rule of the serial bf16 run's update. Then 2 async
   steps through the Communicator leave every table on both pservers
   moved (C-ref-28); the sparse rows are no more than the distinct ids
   sent. Recorded: each step's ms split into pull, compute, push and
   barriers, the bytes pulled and pushed, peak memory, the group's
   seconds. (b) ps_fleet_executor, on this process while the trainers
   start: BERT-base bf16 eval as a three-stage FleetExecutor in one
   Carrier (the embeddings; layers 0-5; layers 6-11, the pooler and the
   classifier), 4 micro-batches of 2 x 512 as CUDA tensors, buffer_size
   2: each micro-batch's logits equal the whole model's to the bit, B1
   12 times a micro-batch.

Five groups whose ranks keep this process waiting each host groups of
this process's (GUESTS), in turn: hapi beside auto_moe, vision beside
elastic, surface and to_static_grad beside hybrid, bert beside pipeline,
optim and nn_rest beside layouts, when both run; the guests' captured
replays share the card with the ranks' steps, so the times of both carry
the other's load. Some rank sets run
side by side too: hybrid_geometry's beside tp_gpt's, pp_compiled's
beside pp_gpt's once the bert group is done.

``--phases`` runs only the named phases (comma-separated: build,
kernels, auto_moe, elastic, ps, reference, serve, train, to_static_grad,
bert, vision, serving, hapi, optim, surface, nn_rest, zoo, dist_tune,
hybrid, pipeline, layouts); the kernels
line needs every phase and is printed only when all run. Every phase
runs under the defaults: FLAGS_fusion_policy=auto (the table this card
measured, which keeps flash attention, fused conv + BN and the fused
residual LN, and routes the bf16 FFN's training call unfused) and the
tile search on.

Then it prints the kernels line ({"kernels": [...]}, with each kernel's
launches on the main path, error, times and bound), the card's name and
power limit from nvidia-smi, and last {"ok": true, "device": {...}}.
Any failed check raises, so the exit code is not 0 and no ok line is
printed. It needs a CUDA card and the repository checkout it lies in.
"""
import argparse
import contextlib
import faulthandler
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

# H100 SXM dense peaks (NVIDIA data sheet) for the roofline bound and MFU
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

PROMPTS, PROMPT_LEN, DECODE_STEPS = 4, 512, 64
# bench.py's GPT training lane: batch 4 x 1024, AdamW lr 1e-4, a 512-token
# permutation stream, 4 warm-up steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 1024, 4, 16
# GPT-medium's layers in every lane that builds it: 12 of its 24, at full
# width (cut from 24 for the script's time, PERF.md section 4)
GPT_LAYERS = 12
# bench.py's BERT lane (bench_bert): batch 16 x 128, run_steps with 64
# steps per execution, 2 warm-up executions; its chance-floor gate: the
# mean loss of the last 32 recorded steps below 0.62 (ln 2 = 0.693 is
# chance), judged on at least 512 recorded steps for BERT and 256 for
# ERNIE (bench.py:1241-1242)
CLS_BATCH, CLS_SEQ, CLS_SPE, CLS_FLOOR, CLS_WINDOW = 16, 128, 64, 0.62, 32
CLS_STEPS = {"bert": 192, "ernie": 192}
# the floor is judged on the median of the last-32 means of this many
# weight draws (seeds --seed, --seed + 1, ...) on the one data stream: one
# fine-tuning run from one draw can stay at chance, as ERNIE-base from
# seed 0 does (PERF.md section 6)
CLS_WEIGHT_DRAWS = 3
# BERT-base on the flash kernels: (batch, seq, heads, head dim) at s = 512,
# where the selection rule takes B1, B2 and B3 (non-causal)
BERT_FLASH_SHAPE = (8, 512, 12, 64)
# translate's encoder self-attention: Transformer-base at 8 x 256
TRANSLATE_FLASH_SHAPE = (8, 256, 8, 64)
# a tensor-parallel rank of GPT-3 1.3B (mp 2: 8 of its 16 heads of 128):
# the training step's (bench's 2 x 1024) and the prefill's (4 x 512)
TP_RANK_SHAPE, TP_PREFILL_SHAPE = (2, 1024, 8, 128), (4, 512, 8, 128)
# a dp 2 x mp 2 rank of hybrid_geometry (f32): 2 of its 4 x 256 rows, 8 heads
GEOM_RANK_SHAPE = (2, 256, 8, 128)
# a pipeline rank's micro-batch of the 1.3B at pp 2 x mp 2 (pp_gpt)
PP_RANK_SHAPE = (1, 1024, 8, 128)
BERT_FLASH_REPLAYS = 16
# eval-mode f32 logits, kernel path against math path (summation order)
BERT_LOGIT_TOL = 1e-3
# forward-only to_static under an outer backward against eager, f32
OUTER_GRAD_RTOL = 1e-5
# the key projections' bias grads are zero in exact arithmetic; each
# path's must stay below this share of its weight grad's norm, by dtype
# (bf16 rounds dK before the bias sums it over every key). Sound readings
# at BERT-base 8 x 512: f32 1.3e-7 (math) and 5.1e-7 (kernel); bf16
# 9.5e-5 (math) and 1.7e-4 (kernel). A bf16 backward that took D from the
# bf16 O read 1.6e-3 (PERF.md section 6).
KEY_BIAS = "self_attn.k_proj.bias"
KEY_BIAS_TOL = {"float32": 1e-5, "bfloat16": 5e-4}
# bench.py's ResNet-50 lane (bench_resnet50, bench.py:828-912): batch 128
# at 224 x 224, NHWC, the space-to-depth stem, run_steps with 32 steps an
# execution, 2 warm-up + 12 timed executions (384 timed steps, 448
# recorded) rotating over 3 staged stacks (96 distinct batches) of 1000
# class prototypes at scale 2.0 plus unit noise; its chance floor: the
# last-32 mean below 6.71 at 448 recorded steps (ln 1000 = 6.908;
# bench.py:1244-1248). A training step is 3 x 4.09 GFLOP an image at 224
# (bench.py:903-904).
RESNET_BATCH, RESNET_HW, RESNET_SPE, RESNET_STACKS = 128, 224, 32, 3
RESNET_WARMUP_EXEC, RESNET_TIMED_EXEC, RESNET_RECORDED = 2, 12, 448
RESNET_FLOOR, RESNET_WINDOW, RESNET_PROTO_SCALE = 6.71, 32, 2.0
RESNET_TRAIN_FLOP = 3 * 4.09e9
# bench.py's LeNet lane (bench_lenet, bench.py:1004-1042): batch 256, 32
# steps an execution, each on a distinct stack; floor 1.80 on the last 32
# of 96 recorded steps (ln 10 = 2.303; bench.py:1243)
LENET_BATCH, LENET_SPE, LENET_FLOOR, LENET_WINDOW = 256, 32, 1.80, 32
# the serving lanes: BERT-base (bench's BERT model at full width) and
# ResNet-50 eval behind InferenceServer, bf16, 2 replicas sharing one
# CUDA graph per bucket (1, 2, 4, 8), requests of one 512-token row (no
# mask, so B1 non-causal) or one 224 x 224 image, a burst from each of 4
# client threads. Each reply (a row of logits) is held to the eager
# forwards of its row: within relative L2 SERVE_TOL of a bf16 copy of the
# model (the same arithmetic: the graph, the cast weights, the per-call
# input cast, padding and batching add no error of their own), and no
# further from the f32 forward than SERVE_FACTOR x that bf16 copy's own
# gap + SERVE_TOL. A flat 2^-7 to f32 per reply is not sound: bf16
# (unit roundoff 2^-9 per rounding) through 12 encoder layers puts BERT-
# base's 2-logit rows a median 1.3e-2 and at worst 0.11 from f32 (PERF.md
# section 6)
SERVE_BATCH, SERVE_SEQ, SERVE_REPLICAS, SERVE_CLIENTS = 8, 512, 2, 4
SERVE_REQUESTS, SERVE_RESNET_REQUESTS = 64, 16
SERVE_TOL, SERVE_FACTOR = 2 ** -7, 2.0
# the decode lane: 8 prompts through the continuous-batching engine; the
# verify skill's known stream (the toy stepper at max_new_tokens=6)
DECODE_PROMPTS = 8
DECODE_ORACLE = ([1, 2, 3, 4, 5], [30, 66, 139, 286, 581, 1172])
# the training API lanes (hapi): hapi_lenet drives one epoch of LeNet on
# synthetic MNIST through fit (batch 64, Adam 1e-3, the spawn pool), then
# the same weights with steps_per_execution=HAPI_LENET_SPE, then
# HAPI_PARITY_STEPS steps card against host (held to VISION_TOL["loss"]);
# its accuracy gate is the reference's own bar (tests/test_components.py)
HAPI_LENET_BATCH, HAPI_LENET_SPE, HAPI_PARITY_STEPS = 64, 4, 8
HAPI_ACC_BAR = 0.5
# hapi_resnet50: ResNet-50 f32 on Flowers (3 x 96 x 96, 102 classes)
# through RandomResizedCrop(224), a flip and Normalize, 4 spawned workers,
# Momentum(0.9) under a cosine schedule the LRScheduler callback steps;
# warm-up, timed and profiled steps with cuDNN's defaults; a
# deterministic fit of HAPI_HAND_STEPS against a hand-written captured loop
# on the same collated batches
HAPI_RESNET_BATCH, HAPI_RESNET_WORKERS = 64, 4
HAPI_RESNET_WARMUP, HAPI_RESNET_TIMED, HAPI_RESNET_PROFILED = 4, 2, 2
HAPI_RESNET_LR, HAPI_HAND_STEPS, HAPI_HAND_TIMED = 0.005, 2, 2
HAPI_RESNET_RTOL = 1e-4
# hapi_bert: BERT-base bf16 at 8 x 512 through fit with
# steps_per_execution=4: 2 warm-up and 4 timed executions, every step's
# loss against a hand-written CompiledTrainStep loop (the same weights,
# batches and loss layer); bert_flash's captured step at this shape for
# comparison (PERF.md section 6)
HAPI_BERT_SPE, HAPI_BERT_WARMUP_EXEC, HAPI_BERT_TIMED_EXEC = 4, 2, 4
HAPI_BERT_RTOL = 1e-3
# vision_reference, card (cuDNN, f32, TF32 off) against host (f32): the
# loss's relative gap, each grad's relative L2 gap, each running
# statistic's and the eval logits' max gap over the max magnitude. Sound
# readings (ResNet-18 at 2 x 64 x 64, PERF.md section 6): loss 3.3e-6,
# grads 1.7e-5, statistics 5.3e-6, logits 2.3e-5; LeNet below 1.3e-6
VISION_TOL = {"loss": 2e-5, "grad": 1e-4, "stats": 2e-5, "logits": 1e-4}
# resnet_fused (a): ResNet-50 f32 at 32 x 224, fused against unfused conv
# + BN: the same forward association, so the loss differs only where
# cuDNN's algorithm does; grads by the backward's order of sums. Sound
# reading: loss equal to the bit, worst grad 4.8e-5 (bn1.bias), median
# 2.0e-6 (PERF.md section 6)
FUSED_F32_BATCH, FUSED_LOSS_RTOL, FUSED_GRAD_RTOL = 32, 1e-5, 2e-4
# resnet_eval: each bf16 path's logits against the f32 unfused ones; the
# fused path (an f32 scale/shift epilogue) within EVAL_FACTOR x the
# unfused path's (bf16 BatchNorm) gap + EVAL_SLACK
EVAL_FACTOR, EVAL_SLACK, EVAL_CALLS = 2.0, 2 ** -8, 20
# max |O - plain O| and |LSE - plain LSE| allowed, kernel vs plain on the
# card. bf16 (tensor cores, also held to the relative-L2 rule below): P is
# rounded to bf16 before P.V and O to bf16, a few bf16 ulps at |O| < 2;
# LSE is f32 in both; f32: sums in another order over at most 1024 terms.
KERNEL_TOL = {"bfloat16": (2e-2, 1e-3), "float32": (2e-5, 1e-4)}
# max |logits| gap between the kernel path and the math path at full width:
# bf16 runs round the attention output differently (the math path rounds
# probabilities and scores to bf16) and 24 layers carry the difference
# into logits of magnitude ~3, where a bf16 ulp is 2^-6; f32 differs only
# by summation order.
LOGIT_TOL = {"bfloat16": 0.25, "float32": 1e-3}
# the f32 backward (the SIMT B2 and B3) against the plain backward,
# elementwise |kernel - plain| <= atol + rtol * |plain|; atol covers values
# near zero
BWD_RTOL, BWD_ATOL = 1e-4, 1e-4
BWD_TOL_REASON = ("f32 sums in another order over up to 1024 terms, with "
                  "cancellation in dS")
# the tensor-core outputs (bf16 O of B1, dK and dV of B2, dQ of B3) against
# the f32 plain version: relative L2 gap <= TC_REL_L2, and <= TC_SDPA_FACTOR
# x the library's own relative L2 gap to the same plain version +
# TC_SDPA_SLACK.
# An elementwise bound is not sound once P and dS round before the product:
# sums with cancellation land near zero.
TC_REL_L2, TC_SDPA_FACTOR, TC_SDPA_SLACK = 2 ** -7, 2.0, 2 ** -10
TC_TOL_REASON = ("P and dS are rounded to bf16 as mma operands (unit "
                 "roundoff 2^-9 per term) and the output to bf16 (2^-9 "
                 "relative); the library rounds at the same places, so the "
                 "kernel is held to no worse than twice its gap")
# bf16 training step at full width: each grad's (and the loss's) relative
# gap to the f32 math path, kernel path <= factor x bf16 math path + slack
BF16_GRAD_FACTOR, BF16_GRAD_SLACK = 2.0, 1e-3
# the f32 training step at full width, kernel path against math path:
# loss relative gap, and each parameter's grad relative L2 gap (summation
# order only, carried through 24 layers)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
# a small GPT's 3 f32 AdamW steps, card (kernels) against host (math path)
SMALL_LOSS_TOL, SMALL_GRAD_RTOL = 1e-4, 1e-4


def _json_scalar(value):
    """numpy scalars (a metric's float32 accuracy) as Python numbers."""
    if isinstance(value, np.generic):
        return value.item()
    raise TypeError(f"{type(value).__name__} is not JSON serializable")


def emit(obj):
    print(json.dumps(obj, default=_json_scalar), flush=True)


def cuda_time_ms(torch, fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def is_kernel(e):
    """A device kernel's record in a profile (ranges marked by
    record_function are not kernels)."""
    return str(getattr(e, "device_type", "")).endswith("CUDA") \
        and not getattr(e, "is_user_annotation", False)


def kernel_times(prof, after=None):
    """(us, count, name) of each device kernel in a profile, longest
    first; with ``after`` (us, the profile's clock), only the kernels that
    start at or after it."""
    if after is None:
        events = [(getattr(e, "self_device_time_total", None), e.count,
                   e.key, e) for e in prof.key_averages() if is_kernel(e)]
    else:
        totals = {}
        for e in prof.events():
            if is_kernel(e) and e.time_range.start >= after:
                us, n = totals.get(e.name, (0.0, 0))
                totals[e.name] = (us + e.self_device_time_total, n + 1)
        events = [(us, n, name, None) for name, (us, n) in totals.items()]
    kernels = []
    for us, count, key, e in events:
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((us, count, key))
    return sorted(kernels, reverse=True)


# how each device time was taken: a profile that recorded every call's
# kernels, a profile retried after it recorded none or only some of them,
# or queued CUDA events after every try failed (queued_event_ms)
TIMING = {"profiler": 0, "profiler_retries": 0, "queued_events": []}
# a spin of 2^27 clock cycles holds the stream ~70 ms at the H100's
# 1.98 GHz boost clock while the host queues the timed calls
SPIN_CYCLES = 1 << 27


def queued_event_ms(torch, fn, reps=20, warmup=3):
    """Device time (ms) of one call of ``fn`` from CUDA events, for when
    the profiler records no kernels: a spin kernel (torch.cuda._sleep)
    holds the stream while the host queues all ``reps`` calls, so the
    events bracket back-to-back device work and not the host's launch
    cost. If the spin ended before the host had queued them all, the spin
    is doubled and the calls timed again (up to 4 times). Returns the
    time and whether the queue held."""
    for _ in range(warmup):
        fn()
    spin = SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            break
        spin *= 2
    return start.elapsed_time(end) / reps, held


def device_profile(torch, fn, reps=20, warmup=3, tries=3):
    """Device time (ms) and kernel launches of one call of ``fn``: the
    summed duration and number of the kernels it launches
    (torch.profiler), averaged over ``reps`` calls. The time leaves out
    the host's launch cost, which CUDA events over back-to-back calls
    (cuda_time_ms) include when the host is the slower side.

    ``fn`` launches the same kernels on every call, so a profile whose
    launch count is zero or not a multiple of ``reps`` lost kernels: it is
    taken again, up to ``tries`` times, and then the time comes from
    queued CUDA events (queued_event_ms) with the launches unknown (None).
    Every time returned is above zero."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = kernel_times(prof)
        launches = sum(k[1] for k in kernels)
        if launches and launches % reps == 0:
            TIMING["profiler"] += 1
            TIMING["profiler_retries"] += attempt
            return sum(k[0] for k in kernels) / 1e3 / reps, launches / reps
    ms, held = queued_event_ms(torch, fn, reps, warmup=0)
    record = {"fn": getattr(fn, "__qualname__", repr(fn)),
              "profiled_launches_last_try": launches, "reps": reps,
              "ms": ms, "queue_held": held}
    TIMING["queued_events"].append(record)
    emit({"phase": "timing_fallback", **record})
    assert ms > 0, record
    return ms, None


def device_ms(torch, fn, reps=20, warmup=3):
    """Device time of one call of ``fn`` (device_profile)."""
    return device_profile(torch, fn, reps, warmup)[0]


def rel_l2(a, b):
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def tc_gate(got, want, library):
    """The tensor-core tolerance rule for one output: its relative L2 gap
    to the plain version, the library's gap, the bound, and whether it
    holds."""
    gap, lib_gap = rel_l2(got, want), rel_l2(library, want)
    bound = min(TC_REL_L2, TC_SDPA_FACTOR * lib_gap + TC_SDPA_SLACK)
    return {"rel_l2": gap, "library_rel_l2": lib_gap, "bound": bound,
            "ok": gap <= bound}


def flash_bound(b, s, h, d, dtype_name, causal, f32_out=False):
    """Least time (ms) for B1's work and what bounds it: q, k, v read once,
    O and LSE written once (and O in f32 too with ``f32_out``, as the
    training path asks of the tensor-core B1); 4*B*H*S^2*D flops, halved
    when causal."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4
    if f32_out:
        nbytes += 4 * b * s * h * d
    flops = 4 * b * h * s * s * d * (0.5 if causal else 1.0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# (B, S, H, D) inputs, outputs, flops / (B*H*S^2*D) and (B, H, S) f32
# vectors read of B2, B3 and the wrapper's whole backward (which reads O in
# place of D and does B2's and B3's products)
BWD_WORK = {"dkv": (4, 2, 8, 2), "dq": (4, 1, 6, 2), "whole": (5, 3, 14, 1)}


def flash_bwd_bound(b, s, h, d, dtype_name, causal, kernel):
    """Least time (ms) for B2's ("dkv"), B3's ("dq") or the whole
    backward's ("whole") work and what bounds it: each input read once,
    each output written once (BWD_WORK); the flops halved when causal."""
    elt = 2 if dtype_name == "bfloat16" else 4
    n = b * s * h * d
    inputs, outputs, coef, vectors = BWD_WORK[kernel]
    nbytes = (inputs + outputs) * n * elt + vectors * b * h * s * 4
    flops = coef * b * h * s * s * d * (0.5 if causal else 1.0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_build():
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    libraries = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libraries})


def qkv_views(torch, b, s, h, d, dtype, gen):
    """q, k, v as the model hands them to the kernel: at BERT's shape three
    contiguous tensors (MultiHeadAttention's separate projections), else
    the strided views of one fused projection (GPTAttention)."""
    if (b, s, h, d) == BERT_FLASH_SHAPE:
        return [torch.randn((b, s, h, d), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype) for _ in range(3)]
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)
    return qkv.unbind(dim=2)


def launched_variant(fa, launch_counts, kernels, fn):
    """Run ``fn`` and return the variant that it launched once for each
    of ``kernels``: each must advance exactly one of its variant counters
    by one, and all the same variant."""
    keys = [f"{k}.{v}" for k in kernels for v in (fa.TC, fa.SIMT)]
    before = [launch_counts[k] for k in keys]
    result = fn()
    moved = [k for k, c in zip(keys, before) if launch_counts[k] == c + 1]
    kinds = {k.split(".", 1)[1] for k in moved}
    assert len(moved) == len(kernels) and len(kinds) == 1, (kernels, moved)
    return kinds.pop(), result


def phase_kernels(torch, seed):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(4, 512, 16, 64, torch.bfloat16, True),
             (4, 512, 16, 64, torch.bfloat16, False),
             (4, 1024, 16, 64, torch.bfloat16, True),
             (4, 1024, 16, 64, torch.bfloat16, False),
             (2, 1024, 16, 128, torch.bfloat16, True),
             (2, 1024, 16, 128, torch.bfloat16, False),
             (4, 512, 16, 64, torch.float32, True),
             (2, 512, 16, 128, torch.float32, False),
             (*TP_RANK_SHAPE, torch.bfloat16, True),
             (*TP_PREFILL_SHAPE, torch.bfloat16, True),
             (*TP_PREFILL_SHAPE, torch.float32, True),
             (*GEOM_RANK_SHAPE, torch.float32, True),
             (*PP_RANK_SHAPE, torch.bfloat16, True),
             (*RING_RANK_SHAPE, torch.bfloat16, True),
             (*RING_RANK_SHAPE, torch.bfloat16, False),
             (*SP_RANK_SHAPE, torch.bfloat16, True),
             (*MOE_RANK_SHAPE, torch.bfloat16, False),
             (*ELASTIC_RANK_SHAPE, torch.bfloat16, True),
             (*PS_RANK_SHAPE, torch.bfloat16, False),
             (*FE_SHAPE, torch.bfloat16, False),
             (*TRANSLATE_FLASH_SHAPE, torch.bfloat16, False),
             (*BERT_FLASH_SHAPE, torch.bfloat16, False)]
    rows = []
    for b, s, h, d, dtype, causal in cases:
        dname = str(dtype).split(".")[-1]
        q, k, v = qkv_views(torch, b, s, h, d, dtype, gen)
        scale = 1.0 / d ** 0.5
        kind, (out, lse) = launched_variant(
            fa, launch_counts, (fa.KERNEL_NAME,),
            lambda: fa.flash_attention_fwd(q, k, v, causal, scale))
        assert kind == fa.variant(dtype), (kind, dname)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                            scale)
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_l = (lse - ref_lse).abs().max().item()
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
        tol_o, tol_l = KERNEL_TOL[dname]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale)
        gate = None
        if kind == fa.TC:
            gate = tc_gate(out, ref_out, sdpa().transpose(1, 2))

        def kernel():
            return fa.flash_attention_fwd(q, k, v, causal, scale)

        def plain():
            return fa.flash_attention_fwd_reference(q, k, v, causal, scale)
        ms = device_ms(torch, kernel)
        library_ms = device_ms(torch, sdpa)
        bound_ms, bound_by = flash_bound(b, s, h, d, dname, causal)
        f32_out = {}
        if kind == fa.TC:
            # the training path's launch: O also written unrounded in f32,
            # which must round to the same bf16 O
            out_g, lse_g, out32 = fa.flash_attention_fwd_for_grad(
                q, k, v, causal, scale)
            f32_bound, f32_bound_by = flash_bound(b, s, h, d, dname, causal,
                                                  f32_out=True)
            f32_out = {
                "ms_with_f32_out": device_ms(
                    torch, lambda: fa.flash_attention_fwd_for_grad(
                        q, k, v, causal, scale)),
                "bound_us_with_f32_out": f32_bound * 1e3,
                "bound_by_with_f32_out": f32_bound_by,
                "f32_out_rounds_to_out": bool(
                    torch.equal(out_g, out) and torch.equal(lse_g, lse)
                    and torch.equal(out32.to(dtype), out))}
            del out_g, lse_g, out32
        row = {"shape": [b, s, h, d], "dtype": dname, "causal": causal,
               "variant": kind,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
               "tol_o": tol_o, "tol_lse": tol_l,
               "rel_l2_o": gate and gate["rel_l2"],
               "sdpa_rel_l2_o": gate and gate["library_rel_l2"],
               "rel_l2_bound": gate and gate["bound"],
               "tol_reason": TC_TOL_REASON if gate else None,
               "ms": ms, "wall_ms": cuda_time_ms(torch, kernel),
               "plain_ms": device_ms(torch, plain, reps=5, warmup=1),
               "library_ms": library_ms,
               "library_wall_ms": cuda_time_ms(torch, sdpa),
               "bound_us": bound_ms * 1e3, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms,
               "factor_vs_library": ms / library_ms, **f32_out}
        emit({"phase": "kernels", "kernel": fa.KERNEL_NAME, **row})
        assert err_o <= tol_o and err_l <= tol_l, row
        assert not f32_out or f32_out["f32_out_rounds_to_out"], row
        assert gate is None or gate["ok"], row
        rows.append(row)
    return rows


def sdpa_bwd(torch, q, k, v, do, causal, scale):
    """The library yardstick for the backward: PyTorch's own fused
    attention (scaled_dot_product_attention), the gradient of a retained
    graph for dq, dk and dv together. Returns its device time and its
    CUDA-event time (ms) and its grads (B, S, H, D). Run here only; the
    port never calls it."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale)
    g = do.transpose(1, 2)

    def grad():
        return torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True)
    grads = grad()
    return (device_ms(torch, grad), cuda_time_ms(torch, grad),
            [t.transpose(1, 2) for t in grads])


def phase_kernels_bwd(torch, seed):
    """B2 and B3 against the plain backward on the card, each timed alone
    (its launcher, on a precomputed D), beside the plain backward and the
    library's backward (both compute dq, dk and dv together). bf16 grads
    (the tensor-core B2 and B3) are held to the relative-L2 rule, f32
    grads elementwise. At the bf16 causal shapes the wrapper's whole
    backward is timed against the library's backward, and bwd_delta (D =
    rowsum(dO * O)) alone beside it."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cases = [(4, 1024, 16, 64, torch.bfloat16, True),    # the training shape
             (4, 512, 16, 64, torch.bfloat16, True),
             (4, 512, 16, 64, torch.bfloat16, False),
             (2, 1024, 16, 128, torch.bfloat16, True),
             (4, 512, 16, 64, torch.float32, True),
             (2, 512, 16, 128, torch.float32, False),
             (*TP_RANK_SHAPE, torch.bfloat16, True),
             (*GEOM_RANK_SHAPE, torch.float32, True),
             (*PP_RANK_SHAPE, torch.bfloat16, True),
             (*RING_RANK_SHAPE, torch.bfloat16, True),
             (*RING_RANK_SHAPE, torch.bfloat16, False),
             (*SP_RANK_SHAPE, torch.bfloat16, True),
             (*MOE_RANK_SHAPE, torch.bfloat16, False),
             (*ELASTIC_RANK_SHAPE, torch.bfloat16, True),
             (*PS_RANK_SHAPE, torch.bfloat16, False),
             (*BERT_FLASH_SHAPE, torch.bfloat16, False)]
    rows = {"dkv": [], "dq": [], "whole": []}
    for b, s, h, d, dtype, causal in cases:
        dname = str(dtype).split(".")[-1]
        q, k, v = qkv_views(torch, b, s, h, d, dtype, gen)
        do = torch.randn((b, s, h, d), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        scale = 1.0 / d ** 0.5
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        kind, got = launched_variant(
            fa, launch_counts, (fa.DKV_KERNEL, fa.DQ_KERNEL),
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                           scale))
        assert kind == fa.variant(dtype), (kind, dname)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                causal, scale)
        library_ms, library_wall_ms, lib = sdpa_bwd(torch, q, k, v, do,
                                                    causal, scale)
        err, share_of_tol, info, gates = {}, {}, {}, {}
        for name, g, w, x in zip(("dq", "dk", "dv"), got, want, lib):
            assert torch.isfinite(g.float()).all(), name
            diff = (g.float() - w.float()).abs()
            err[name] = diff.max().item()
            # the kernel may agree with the plain version to the bit; the
            # size of the values and the gap to the library's independent
            # backward show the comparison is not empty
            info[name] = {"max_abs_plain": w.float().abs().max().item(),
                          "max_abs_gap_vs_library":
                              (g.float() - x.float()).abs().max().item()}
            if kind == fa.TC:
                gates[name] = tc_gate(g, w, x)
            else:
                share_of_tol[name] = (
                    diff / (BWD_ATOL + BWD_RTOL * w.float().abs())
                ).max().item()
        del got, want, lib
        delta = fa.bwd_delta(out, do)

        def dkv():
            return fa.launch_dkv(q, k, v, do, lse, delta, causal, scale)

        def dq():
            return fa.launch_dq(q, k, v, do, lse, delta, causal, scale)
        # the queued-event time is device_profile's fallback, measured here
        # on every run so that it stays checked against the profiler
        times = {"dkv": (device_ms(torch, dkv), cuda_time_ms(torch, dkv),
                         queued_event_ms(torch, dkv)[0]),
                 "dq": (device_ms(torch, dq), cuda_time_ms(torch, dq),
                        queued_event_ms(torch, dq)[0])}
        plain_ms = device_ms(torch, lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal, scale), reps=3, warmup=1)
        if kind == fa.TC and (causal or (b, s, h, d) == BERT_FLASH_SHAPE):
            rows["whole"].append(whole_backward(
                torch, fa, (q, k, v, out, lse, do), causal, scale, kind,
                library_ms))
        for kernel, name, outs in (("dkv", fa.DKV_KERNEL, ("dk", "dv")),
                                   ("dq", fa.DQ_KERNEL, ("dq",))):
            bound_ms, bound_by = flash_bwd_bound(b, s, h, d, dname, causal,
                                                 kernel)
            ms, wall_ms, queued_ms = times[kernel]
            elementwise = [o for o in outs if o in share_of_tol]
            row = {"shape": [b, s, h, d], "dtype": dname, "causal": causal,
                   "variant": kind,
                   "max_abs_err": max(err[o] for o in outs),
                   "max_abs_err_by_output": {o: err[o] for o in outs},
                   "sanity_by_output": {o: info[o] for o in outs},
                   "ms": ms, "wall_ms": wall_ms,
                   "queued_event_ms": queued_ms, "plain_ms": plain_ms,
                   "plain_scope": "dq, dk and dv together",
                   "library_ms": library_ms,
                   "library_wall_ms": library_wall_ms,
                   "library_scope": "SDPA backward, dq, dk and dv together",
                   "bound_us": bound_ms * 1e3, "bound_by": bound_by,
                   "share_of_bound": bound_ms / ms,
                   "factor_vs_library": ms / library_ms}
            if elementwise:
                row.update(rtol=BWD_RTOL, atol=BWD_ATOL,
                           tol_reason=BWD_TOL_REASON,
                           worst_share_of_tol=max(share_of_tol[o]
                                                  for o in elementwise))
            else:
                row.update(rel_l2_by_output={o: gates[o] for o in outs},
                           tol_reason=TC_TOL_REASON)
            emit({"phase": "kernels", "kernel": name, **row})
            rows[kernel].append(row)
        assert max(share_of_tol.values(), default=0.0) <= 1.0, \
            (dname, causal, err)
        assert all(gt["ok"] for gt in gates.values()), (dname, causal, gates)
        del out, lse, delta, q, k, v, do
        torch.cuda.empty_cache()
    return rows


def whole_backward(torch, fa, inputs, causal, scale, kind, library_ms):
    """The wrapper's whole backward (bwd_delta, B2 and B3) against the
    library's backward, both as device time, and bwd_delta alone: its
    device time and kernel launches per call."""
    q, k, v, out, lse, do = inputs
    b, s, h, d = q.shape
    dname = str(q.dtype).split(".")[-1]
    ms, launches = device_profile(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal, scale))
    delta_ms, delta_launches = device_profile(
        torch, lambda: fa.bwd_delta(out, do))
    bound_ms, bound_by = flash_bwd_bound(b, s, h, d, dname, causal, "whole")
    row = {"phase": "kernels", "kernel": "flash_attention_bwd",
          "scope": "the wrapper's whole backward: bwd_delta, B2, B3",
          "shape": [b, s, h, d], "dtype": dname, "causal": causal,
          "variant": kind, "ms": ms, "launches_per_call": launches,
          "library_ms": library_ms,
          "library_scope": "SDPA backward, dq, dk and dv together",
          "factor_vs_library": ms / library_ms,
          "bwd_delta_ms": delta_ms,
          "bwd_delta_launches_per_call": delta_launches,
          "bwd_delta_share": delta_ms / ms,
          "bound_us": bound_ms * 1e3, "bound_by": bound_by,
          "share_of_bound": bound_ms / ms}
    emit(row)
    return row


def greedy(torch, model, ids, steps):
    """Batched prefill, then ``steps`` KV-cached greedy decode steps.
    Returns tokens (b, steps + 1), prefill logits, TTFT s, decode s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model(ids, caches=model.gpt.init_decode_caches())
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = [tok]
    for _ in range(steps):
        step_logits, caches = model(tok, caches=caches)
        tok = step_logits[:, -1].argmax(dim=-1, keepdim=True)
        toks.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return torch.cat(toks, dim=1), logits, t1 - t0, t2 - t1


def set_flash(model, on):
    for block in model.gpt.h:
        block.attn.use_flash = on


def phase_reference(torch, seed):
    """A small f32 GPT built from the seed on the card and on the host
    (same weights: both draw from a CPU generator). The card's kernel path
    must agree with the host's math path, which tests/test_torch_gpt.py
    holds against paddle_tpu: logits within 1e-4, identical tokens."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=512, dropout=0.0)
    ids = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(seed + 1))
    out = {}
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(seed))
        with torch.inference_mode():
            out[dev] = greedy(torch, model.eval(), ids.to(dev), 8)
    gap = (out["cuda"][1].cpu() - out["cpu"][1]).abs().max().item()
    same = torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
    emit({"phase": "reference", "config": "GPT v256 h128 L2 a2 d64 f32",
          "prompt": [2, 256], "decode_steps": 8,
          "logits_max_abs_gap_card_vs_host": gap, "tol": 1e-4,
          "greedy_tokens_identical": same})
    assert gap <= 1e-4 and same


def phase_serve(torch, seed):
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import (KERNEL_NAME,
                                                           variant_counter)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    ids = torch.randint(0, cfg.vocab_size, (PROMPTS, PROMPT_LEN),
                        generator=torch.Generator().manual_seed(seed + 1))
    ids = ids.to("cuda")
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        model = GPTForCausalLM(cfg, device="cuda", dtype=dtype,
                               generator=torch.Generator().manual_seed(seed))
        model.eval()
        build_s = time.perf_counter() - t0
        with torch.inference_mode():
            greedy(torch, model, ids, 2)                 # warm-up
            torch.cuda.reset_peak_memory_stats()
            launch_counts.clear()
            toks, logits, ttft, decode_s = greedy(torch, model, ids,
                                                  DECODE_STEPS)
            launches = launch_counts[KERNEL_NAME]
            variant = variant_counter(KERNEL_NAME, dtype)
            variant_launches = launch_counts[variant]
            peak = torch.cuda.max_memory_allocated()
            assert launches == cfg.num_layers, (launches, cfg.num_layers)
            assert variant_launches == launches, (variant, dict(launch_counts))
            assert toks.shape == (PROMPTS, DECODE_STEPS + 1)
            assert logits.shape == (PROMPTS, PROMPT_LEN, cfg.vocab_size)
            assert torch.isfinite(logits.float()).all()
            set_flash(model, False)
            launch_counts.clear()
            m_toks, m_logits, m_ttft, m_decode_s = greedy(torch, model, ids,
                                                          DECODE_STEPS)
            assert launch_counts[KERNEL_NAME] == 0
            set_flash(model, True)
            if dtype == torch.bfloat16:
                profile_windows(torch, model, ids)
        gap = (logits.float() - m_logits.float()).abs().max().item()
        agree = int((toks == m_toks).sum().item())
        row = {"phase": "serve", "dtype": dname,
               "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64",
               "prompts": PROMPTS, "prompt_len": PROMPT_LEN,
               "decode_steps": DECODE_STEPS, "model_build_s": build_s,
               "ttft_ms": ttft * 1e3,
               "tpot_ms": decode_s / DECODE_STEPS * 1e3,
               "decode_tokens_per_s": PROMPTS * DECODE_STEPS / decode_s,
               "peak_mem_bytes": peak, "flash_launches": launches,
               "flash_variant": variant,
               "flash_variant_launches": variant_launches,
               "prefill_forwards": 1, "math_path_ttft_ms": m_ttft * 1e3,
               "math_path_tpot_ms": m_decode_s / DECODE_STEPS * 1e3,
               "logits_max_abs_gap_vs_math": gap,
               "logits_tol": LOGIT_TOL[dname],
               "greedy_tokens_agree": agree, "greedy_tokens": toks.numel()}
        emit(row)
        assert gap <= LOGIT_TOL[dname], row
        if dtype == torch.float32:
            assert torch.equal(toks, m_toks), "f32 greedy tokens differ"
        result[dname] = row
        del model, logits, m_logits
        torch.cuda.empty_cache()
    return result


def profile_windows(torch, model, ids, decode_steps=16):
    """Device time by kernel over one warm prefill and over
    ``decode_steps`` cached decode steps (torch.profiler), beside the
    host-clock wall time of the same window: the busy share is the summed
    kernel time over the wall time (kernels on one stream do not overlap;
    the profiler's own host overhead stretches the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        torch.cuda.synchronize()
        windows = {}
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = model(ids, caches=model.gpt.init_decode_caches())
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            windows["prefill"] = (prof, time.perf_counter() - t0)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(decode_steps):
                step_logits, caches = model(tok, caches=caches)
                tok = step_logits[:, -1].argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            windows["decode"] = (prof, time.perf_counter() - t0)
    for name, (prof, wall_s) in windows.items():
        emit_profile(prof, wall_s, name,
                     1 if name == "prefill" else decode_steps)


def emit_profile(prof, wall_s, window, steps, top=12, after=None,
                 **extra):
    """Device time by kernel of a profiled window (from ``after`` on, as
    in kernel_times), and the busy share: the summed kernel time over the
    host-clock wall time of the window. The port's flash kernels are
    listed by name whatever their rank."""
    kernels = kernel_times(prof, after)
    device_us = sum(k[0] for k in kernels)
    row = {"phase": "profile", "window": window, "steps": steps,
           "wall_ms": wall_s * 1e3, "device_ms": device_us / 1e3,
           "busy_share": device_us / 1e3 / (wall_s * 1e3),
           "kernel_launches": sum(k[1] for k in kernels),
           "flash_kernels": {m.group(0): {"ms": k[0] / 1e3, "count": k[1]}
                             for k in kernels
                             for m in [re.search(r"flash_\w+<[^>]*>", k[2])]
                             if m},
           "top": [{"kernel": k[2][:90], "ms": k[0] / 1e3,
                    "count": k[1]} for k in kernels[:top]], **extra}
    emit(row)
    return row


def annotated_kernels(prof, name):
    """(device ms, kernel launches, calls) of the kernels launched under
    the host ranges called ``name`` (torch.profiler.record_function) in a
    profile."""
    def launches(e):
        return len(e.kernels) + sum(launches(c) for c in e.cpu_children)
    ranges = [e for e in prof.events() if e.name == name
              and str(e.device_type).endswith("CPU")]
    return (sum(e.device_time_total for e in ranges) / 1e3,
            sum(launches(e) for e in ranges), len(ranges))


def bench_stream(seed, steps, batch, seq, sub=512):
    """bench.py's learnable stream: a fixed random permutation over a
    512-token sub-vocabulary drives next-token generation, x[t+1] =
    perm[x[t]]. Returns int32 inputs and int64 labels, (steps, batch,
    seq) each."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(sub)
    ids = np.empty((steps, batch, seq + 1), np.int64)
    ids[:, :, 0] = rng.randint(0, sub, (steps, batch))
    for t in range(seq):
        ids[:, :, t + 1] = perm[ids[:, :, t]]
    return ids[:, :, :-1].astype("int32"), ids[:, :, 1:]


def train_step_fn(model, opt):
    """The training step as bench.py writes it, through the port."""
    import paddle_tpu_torch as pt

    @pt.jit.to_static
    def step(x, y):
        loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float()
    return step


def loss_and_grads(model, x, y):
    """Forward and backward of the training loss: (loss, {name: grad})."""
    loss = model(x, labels=y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def grad_gaps(torch, grads, ref):
    """Each parameter's relative L2 gap, worst first (name, gap)."""
    gaps = [(n, ((g.float().cpu() - ref[n].float().cpu()).norm()
                 / ref[n].float().cpu().norm().clamp_min(1e-30)).item())
            for n, g in grads.items()]
    return sorted(gaps, key=lambda t: -t[1])


def phase_reference_train(torch, seed):
    """A small f32 GPT takes 3 AdamW steps on the card (kernel path, B1/B2/
    B3 launched) and on the host (math path, which tests/test_torch_training
    holds against paddle_tpu): losses within 1e-4, first-step grads within
    1e-4 relative L2 (summation order only)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=512, dropout=0.0)
    xs, ys = bench_stream(seed + 3, 3, 2, 256, sub=64)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(seed))
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        launch_counts.clear()
        losses, first_grads = [], None
        for x, y in zip(xs, ys):
            x = torch.from_numpy(x).to(dev)
            y = torch.from_numpy(y).to(dev)
            if first_grads is None:
                loss, first_grads = loss_and_grads(model, x, y)
            loss = model(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs[dev] = (losses, first_grads,
                     {n: launch_counts[n] for n in KERNEL_NAMES})
    gaps = grad_gaps(torch, runs["cuda"][1], runs["cpu"][1])
    loss_gap = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                              runs["cpu"][0]))
    # 4 training forwards (one for the grads, then 3 steps) of 2 layers
    want = {n: 0 for n in KERNEL_NAMES}
    emit({"phase": "reference", "config": "GPT v256 h128 L2 a2 d64 f32",
          "train_batch": [2, 256], "adamw_steps": 3,
          "losses_card": runs["cuda"][0], "losses_host": runs["cpu"][0],
          "loss_max_abs_gap": loss_gap, "loss_tol": SMALL_LOSS_TOL,
          "first_step_grad_rel_l2_worst": gaps[0],
          "grad_rel_l2_tol": SMALL_GRAD_RTOL,
          "card_launches": runs["cuda"][2]})
    assert runs["cpu"][2] == want
    assert all(c == 4 * cfg.num_layers for c in runs["cuda"][2].values())
    assert loss_gap <= SMALL_LOSS_TOL and gaps[0][1] <= SMALL_GRAD_RTOL


def phase_train(torch, seed):
    """GPT-medium at full width trains in bf16 through the port's entry
    points (bench.py's step); then a profiled step and the f32 check."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    from torch.profiler import ProfilerActivity, profile, record_function
    # the counters of each kernel's variant for each dtype
    variants = {dt: [fa.variant_counter(n, dt) for n in KERNEL_NAMES]
                for dt in (torch.bfloat16, torch.float32)}
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    total = TRAIN_WARMUP + TRAIN_STEPS + 1
    xs, ys = bench_stream(seed, total, TRAIN_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    step = train_step_fn(model, opt)
    # the eager path: every call runs the Python body (the compiled_train
    # phase captures the same step)
    pt.set_flags({"FLAGS_compiled_step": False})
    losses = [step(xs[i], ys[i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    per_step = []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        before = [launch_counts[n] for n in KERNEL_NAMES]
        losses.append(step(xs[i], ys[i]))
        per_step.append([launch_counts[n] - c
                         for n, c in zip(KERNEL_NAMES, before)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: launch_counts[n]
                for n in (*KERNEL_NAMES, *variants[torch.bfloat16],
                          *variants[torch.float32])}
    peak = torch.cuda.max_memory_allocated()
    losses = [loss.item() for loss in losses]
    row = {"phase": "train", "dtype": "bfloat16",
           "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64",
           "optimizer": "AdamW lr 1e-4 multi_precision (f32 masters)",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "warmup_steps": TRAIN_WARMUP,
           "timed_steps": TRAIN_STEPS,
           "step_ms": seconds / TRAIN_STEPS * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / seconds,
           "peak_mem_bytes": peak, "losses": losses,
           "launches": launches,
           "launches_per_step": dict(zip(KERNEL_NAMES, per_step[0]))}
    emit(row)
    assert all(c == [cfg.num_layers] * len(KERNEL_NAMES) for c in per_step), \
        per_step
    # B1, B2 and B3 ran their tensor-core variants, every launch
    assert all(launches[n] == cfg.num_layers * TRAIN_STEPS
               for n in variants[torch.bfloat16]), launches
    assert all(launches[n] == 0 for n in variants[torch.float32]), launches
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    # bwd_delta's kernels are generic elementwise and reduction kernels:
    # a host range around each call tells them apart in the profile
    def annotated_delta(out, do):
        with record_function("flash_bwd_delta"):
            return plain_delta(out, do)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    plain_delta, fa.bwd_delta = fa.bwd_delta, annotated_delta
    try:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(xs[-1], ys[-1])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        fa.bwd_delta = plain_delta
        pt.set_flags({"FLAGS_compiled_step": True})
    delta_ms, delta_launches, delta_calls = annotated_kernels(
        prof, "flash_bwd_delta")
    row["profile"] = emit_profile(
        prof, wall_s, "train_step", 1, top=16,
        bwd_delta={"ms": delta_ms, "launches": delta_launches,
                   "calls": delta_calls})
    assert delta_calls == cfg.num_layers, delta_calls
    del model, opt, step, prof
    torch.cuda.empty_cache()

    # f32 at full width: one step's loss and grads, kernel path against the
    # math path (use_flash_attention off), from the same weights and batch
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    launch_counts.clear()
    k_loss, k_grads = loss_and_grads(model, xs[0], ys[0])
    f32_launches = {n: launch_counts[n] for n in KERNEL_NAMES}
    f32_variants = {n: launch_counts[n]
                    for n in (*variants[torch.float32],
                              *variants[torch.bfloat16])}
    set_flash(model, False)
    m_loss, m_grads = loss_and_grads(model, xs[0], ys[0])
    gaps = grad_gaps(torch, k_grads, m_grads)
    check = {"phase": "train_check", "dtype": "float32",
             "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64 "
                       f"(full width)",
             "batch": [TRAIN_BATCH, TRAIN_SEQ],
             "loss_kernel_path": k_loss, "loss_math_path": m_loss,
             "loss_rel_gap": abs(k_loss - m_loss) / abs(m_loss),
             "loss_rtol": TRAIN_LOSS_RTOL,
             "grad_rel_l2_worst": gaps[:3],
             "grad_rel_l2_median": gaps[len(gaps) // 2][1],
             "grad_rel_l2_tol": TRAIN_GRAD_RTOL,
             "kernel_path_launches": f32_launches,
             "kernel_path_variant_launches": f32_variants,
             "math_path_launches": {n: launch_counts[n] - f32_launches[n]
                                    for n in KERNEL_NAMES}}
    emit(check)
    assert all(c == cfg.num_layers for c in f32_launches.values())
    assert all(f32_variants[n] == cfg.num_layers
               for n in variants[torch.float32]), f32_variants
    assert all(f32_variants[n] == 0 for n in variants[torch.bfloat16])
    assert all(c == 0 for c in check["math_path_launches"].values())
    assert check["loss_rel_gap"] <= TRAIN_LOSS_RTOL, check
    assert gaps[0][1] <= TRAIN_GRAD_RTOL, check
    row["f32_launches"] = f32_variants
    del k_grads
    bf16_check(torch, model, xs[0], ys[0], m_loss, m_grads, variants)
    del model, m_grads
    torch.cuda.empty_cache()
    return row


def bf16_check(torch, model, x, y, f32_loss, f32_grads, variants,
               path=set_flash, n_layers=None,
               config=f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64 "
                      f"(full width)",
               gaps=grad_gaps, zero_share=None):
    """One bf16 step at full width from the f32 check's weights cast to
    bf16, on the kernel path (tensor-core B1, B2 and B3) and on the math
    path. The f32 math path's loss and grads are the truth: the
    kernel path's relative gap to it must be no more than BF16_GRAD_FACTOR
    times the bf16 math path's + BF16_GRAD_SLACK, for the loss and for
    every parameter's grad (relative L2, as ``gaps`` measures it).
    ``path(model, on)`` switches the model between the two paths;
    ``zero_share(grads)``, where given, holds the grads that ``gaps``
    leaves out (KEY_BIAS_TOL in bf16)."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    model.to(torch.bfloat16)
    path(model, True)
    launch_counts.clear()
    k_loss, k_grads = loss_and_grads(model, x, y)
    k_launches = dict(launch_counts)
    path(model, False)
    launch_counts.clear()
    m_loss, m_grads = loss_and_grads(model, x, y)
    m_launches = sum(launch_counts[n] for n in KERNEL_NAMES)
    k_gap = dict(gaps(torch, k_grads, f32_grads))
    m_gap = dict(gaps(torch, m_grads, f32_grads))
    share = {n: k_gap[n] / (BF16_GRAD_FACTOR * m_gap[n] + BF16_GRAD_SLACK)
             for n in k_gap}
    worst = sorted(share, key=lambda n: -share[n])[:3]
    loss_gap = {"kernel": abs(k_loss - f32_loss) / abs(f32_loss),
                "math": abs(m_loss - f32_loss) / abs(f32_loss)}
    check = {"phase": "train_check", "dtype": "bfloat16",
             "config": config,
             "batch": list(x.shape), "truth": "f32 math path",
             "loss_kernel_path": k_loss, "loss_math_path": m_loss,
             "loss_f32": f32_loss, "loss_rel_gap": loss_gap,
             "rule": f"kernel gap <= {BF16_GRAD_FACTOR} x bf16 math-path "
                     f"gap + {BF16_GRAD_SLACK}",
             "worst_params": [{"param": n, "kernel_rel_l2": k_gap[n],
                               "math_rel_l2": m_gap[n],
                               "share_of_bound": share[n]} for n in worst],
             "kernel_rel_l2_median": sorted(k_gap.values())[len(k_gap) // 2],
             "math_rel_l2_median": sorted(m_gap.values())[len(m_gap) // 2],
             "kernel_path_launches": k_launches,
             "math_path_launches": m_launches}
    if zero_share is not None:
        check["key_bias_share"] = {"kernel": zero_share(k_grads),
                                   "math": zero_share(m_grads),
                                   "tol": KEY_BIAS_TOL["bfloat16"]}
    emit(check)
    n_layers = n_layers or model.config.num_layers
    if zero_share is not None:
        assert all(check["key_bias_share"][p][1] <= KEY_BIAS_TOL["bfloat16"]
                   for p in ("kernel", "math")), check
    assert all(k_launches.get(n, 0) == n_layers
               for n in (*KERNEL_NAMES, *variants[torch.bfloat16])), k_launches
    assert m_launches == 0
    assert loss_gap["kernel"] <= (BF16_GRAD_FACTOR * loss_gap["math"]
                                  + BF16_GRAD_SLACK), check
    assert share[worst[0]] <= 1.0, check
    del k_grads, m_grads
    return check


# the tensor-core kernels of a step, by the names of their __global__
# functions: a replayed graph launches them without passing through the
# wrappers, whose Python counts therefore do not move
TC_KERNEL_NAMES = {"flash_attn_fwd": "flash_fwd_tc_kernel",
                   "flash_attn_bwd_dkv": "flash_bwd_dkv_tc_kernel",
                   "flash_attn_bwd_dq": "flash_bwd_dq_tc_kernel"}
# eager and captured bf16 loss curves, step by step (the same kernels on
# the same batches; bf16 rounding differs between two runs only where the
# order of reductions does)
CURVE_RTOL = 2e-2


def profiled(torch, fn, steps, expect=None, tries=3, lead=None):
    """Profile ``fn`` (which runs ``steps`` training steps): the profile,
    its host-clock wall seconds, its result, and per step the kernels'
    device ms, kernel launches, host graph launches and B1/B2/B3 launches
    counted by kernel name.

    A replayed graph launches the same kernels every time, so a profile
    whose B1/B2/B3 counts fall short of ``expect`` ({kernel: launches per
    step}) lost records: ``fn`` then runs again under a new profile, up to
    ``tries`` times, and ``profile_tries`` says how many it took.

    ``lead``, where given, runs first in each window and absorbs the
    records a profile loses at its start; a spin kernel (torch.cuda._sleep)
    then marks where ``fn`` begins (a profile that lost the spin too is
    taken again, within ``tries``). Only kernels that start after the spin
    ends and graph launches made inside ``fn`` count, and the wall time is
    ``fn``'s alone. ``lead_kernel_launches`` is what the lead recorded and
    ``after_us`` the spin's end, on the profile's clock (the return's
    fourth item); pass it to emit_profile."""
    from torch.profiler import ProfilerActivity, profile, record_function
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if lead is not None:
                lead()
                torch.cuda._sleep(1 << 20)
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function("profiled_fn"):
                out = fn()
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        events = prof.events()
        after, lead_kernels = None, None
        if lead is not None:
            spins = [e for e in events
                     if is_kernel(e) and "spin_kernel" in e.name]
            if not spins and attempt < tries:
                # the lead-in was too short to absorb what the profile lost
                continue
            assert len(spins) == 1, ("the marking spin kernel is not in "
                                     "the profile", len(spins))
            after = spins[0].time_range.end
            lead_kernels = sum(1 for e in events if is_kernel(e)
                               and e.time_range.end
                               <= spins[0].time_range.start)
        fn_range = [e.time_range for e in events
                    if e.name == "profiled_fn"
                    and str(e.device_type).endswith("CPU")]
        assert len(fn_range) == 1, len(fn_range)
        kernels = kernel_times(prof, after)
        graph_launches = sum(
            1 for e in events if e.name.startswith("cudaGraphLaunch")
            and fn_range[0].start <= e.time_range.start <= fn_range[0].end)
        per_step = {
            "device_ms": sum(k[0] for k in kernels) / 1e3 / steps,
            "kernel_launches": sum(k[1] for k in kernels) / steps,
            "graph_launches": graph_launches / steps,
            "flash_launches": {n: sum(k[1] for k in kernels if tc in k[2])
                               / steps for n, tc in TC_KERNEL_NAMES.items()},
            "profile_tries": attempt}
        if lead is not None:
            per_step.update(lead_kernel_launches=lead_kernels,
                            after_us=after)
        if expect is None or per_step["flash_launches"] == expect:
            break
    return prof, wall_s, out, per_step


def phase_compiled_train(torch, seed, eager):
    """The train phase's cell with its step captured: GPT-medium bf16,
    AdamW(multi_precision), the same weights and batches, the step under
    ``jit.to_static`` wrapped in ``CompiledTrainStep``, so that it becomes
    one CUDA graph (jit/to_static.py). 4 warm-up steps (a discovery pass,
    the capture and its replay, two replays), then 16 timed replays, held
    against the train phase's eager run (``eager``): compile counters, the
    loss curves step by step, step time, tokens/s, peak memory; then one
    replayed step profiled (device time, busy share, graph launches,
    kernels per replay and B1/B2/B3 by kernel name)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    total = TRAIN_WARMUP + TRAIN_STEPS + 1
    xs, ys = bench_stream(seed, total, TRAIN_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    step = CompiledTrainStep(train_step_fn(model, opt), label="gpt_medium")
    reset_compile_stats()
    t0 = time.perf_counter()
    losses = [step(xs[i], ys[i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    warm = compile_stats()
    reset_compile_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        losses.append(step(xs[i], ys[i]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timed = compile_stats()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    losses = [loss.item() for loss in losses]
    # a replay of an earlier batch leads in (profiled's ``lead``)
    trace, wall_s, _, prof = profiled(torch, lambda: step(xs[-1], ys[-1]),
                                      1, expect={k: cfg.num_layers
                                                 for k in TC_KERNEL_NAMES},
                                      lead=lambda: step(xs[-2], ys[-2]))
    step_ms = seconds / TRAIN_STEPS * 1e3
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, eager["losses"])]
    row = {"phase": "compiled_train", "dtype": "bfloat16",
           "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64",
           "optimizer": "AdamW lr 1e-4 multi_precision (f32 masters)",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "warmup_steps": TRAIN_WARMUP,
           "timed_steps": TRAIN_STEPS,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "warmup_s": warmup_s,
           "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / seconds,
           "eager_step_ms": eager["step_ms"],
           "eager_tokens_per_s": eager["tokens_per_s"],
           "speedup_vs_eager": eager["step_ms"] / step_ms,
           "peak_mem_bytes": peak, "reserved_bytes_end": reserved,
           "eager_peak_mem_bytes": eager["peak_mem_bytes"],
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": prof["device_ms"]
                              / (wall_s * 1e3)},
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "eager_profile": {k: eager["profile"][k] for k in (
               "device_ms", "wall_ms", "busy_share", "kernel_launches")},
           "losses": losses, "eager_losses": eager["losses"],
           "curve_rel_gap_max": max(gaps), "curve_rtol": CURVE_RTOL,
           "replay_foreach_kernels": foreach_kernels(trace,
                                                     prof["after_us"]),
           # after every gated number: one more (zero-grad) update
           "optimizer_eager_step": optimizer_profile(torch, opt,
                                                     prof["device_ms"])}
    emit(row)
    n = cfg.num_layers
    assert warm == {"compiles": 1, "cache_hits": 2,
                    "retrace_warnings": 0}, warm
    assert timed == {"compiles": 0, "cache_hits": TRAIN_STEPS,
                     "retrace_warnings": 0}, timed
    assert prof["flash_launches"] == {k: n for k in TC_KERNEL_NAMES}, prof
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert max(gaps) <= CURVE_RTOL, gaps
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def phase_amp_train(torch, seed):
    """bench.py's GPT lane with BENCH_DTYPE=amp and BENCH_GPT_RECOMPUTE=1,
    a global-norm clip and a warm-up schedule: GPT-medium with f32
    parameters, the forward under ``amp.auto_cast(dtype="bfloat16")``,
    ``recompute=True``, AdamW + ClipGradByGlobalNorm(1.0) + LinearWarmup,
    the step captured and driven through ``run_steps`` with K = 4, three
    times (12 steps; single-batch losses spike early in training, so the
    gate compares the mean loss of the last execution with the first's);
    the scheduler steps between executions. The step returns the lr tensor
    beside the loss, so each step's lr is read back. The first execution
    holds the discovery pass and the capture, the second is profiled (B1
    runs twice a layer a step, the forward and its rerun in the backward;
    B2 and B3 once), the third is timed unprofiled."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    k_steps, executions = 4, 3
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0,
                    recompute=True)
    xs, ys = bench_stream(seed, k_steps * executions, TRAIN_BATCH,
                          TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    sched = pt.optimizer.lr.LinearWarmup(learning_rate=1e-4, warmup_steps=2,
                                         start_lr=5e-5, end_lr=1e-4)
    opt = pt.optimizer.AdamW(learning_rate=sched,
                             parameters=model.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))

    def train_step(x, y):
        with pt.amp.auto_cast(dtype="bfloat16"):
            loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float(), opt._learning_rate
    step = CompiledTrainStep(pt.jit.to_static(train_step),
                             label="gpt_medium_amp")
    reset_compile_stats()
    losses, lrs, want_lrs, stats, times, prof = [], [], [], [], [], None
    for e in range(executions):
        sl = slice(e * k_steps, (e + 1) * k_steps)
        want_lrs += [float(np.float32(sched()))] * k_steps

        def run():
            return step.run_steps(xs[sl], ys[sl])
        if e == 1:
            # tiny kernels lead into the window and absorb the records a
            # profile loses at its start (a second process on one machine
            # lost one B1 in all three tries without them, PR 21)
            pad = torch.zeros(1, device="cuda")

            def lead():
                for _ in range(OPS_LEAD_KERNELS):
                    pad.zero_()
            _, wall_s, out, prof = profiled(
                torch, run, k_steps,
                expect={"flash_attn_fwd": 2 * cfg.num_layers,
                        "flash_attn_bwd_dkv": cfg.num_layers,
                        "flash_attn_bwd_dq": cfg.num_layers}, lead=lead)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        times.append(wall_s / k_steps * 1e3)
        stats.append(compile_stats())
        reset_compile_stats()
        losses += out[0].tolist()
        lrs += out[1].tolist()
        sched.step()
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": "amp_train",
           "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64, "
                     f"f32 params, "
                     "auto_cast bf16 (O1), recompute",
           "optimizer": "AdamW + ClipGradByGlobalNorm(1.0) + LinearWarmup "
                        "(5e-5 -> 1e-4 over 2 executions)",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "k_steps": k_steps,
           "executions": executions, "compile_stats": stats,
           "step_ms_by_execution": times,
           "step_ms": times[2],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / times[2] * 1e3,
           "replay_profile": {**prof, "busy_share": prof["device_ms"]
                              / times[1]},
           "peak_mem_bytes": peak,
           "losses": losses, "lrs": lrs, "scheduler_lrs": want_lrs,
           "mean_loss_by_execution": [float(np.mean(losses[i:i + k_steps]))
                                      for i in range(0, len(losses),
                                                     k_steps)]}
    emit(row)
    n = cfg.num_layers
    # the profiled execution runs once more for each profile retaken
    runs = [1, prof["profile_tries"], 1]
    assert stats[0]["compiles"] == 1 and all(st == {
        "compiles": 0, "cache_hits": k_steps * r, "retrace_warnings": 0}
        for st, r in zip(stats[1:], runs[1:])), stats
    assert prof["flash_launches"] == {"flash_attn_fwd": 2 * n,
                                      "flash_attn_bwd_dkv": n,
                                      "flash_attn_bwd_dq": n}, prof
    assert lrs == want_lrs, (lrs, want_lrs)
    means = row["mean_loss_by_execution"]
    assert all(np.isfinite(losses)) and means[-1] < means[0], losses
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def cls_stream(seed, stacks, spe, batch, seq, vocab):
    """bench.py's parity-label stream (bench_bert's data): random ids,
    except that positions 0-7 carry tokens of a 16-token sub-vocabulary
    whose parity is the label, so the label is learnable from any of
    eight embeddings. One (ids, labels) pair of (spe, batch, seq) int64
    and (spe, batch) int64 per execution, drawn in bench's order from
    RandomState(seed)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(stacks):
        ids = rng.randint(0, vocab, (spe, batch, seq))
        labels = rng.randint(0, 2, (spe, batch)).astype("int64")
        ids[:, :, :8] = (2 * rng.randint(0, 8, (spe, batch, 8))
                         + labels[..., None])
        out.append((ids.astype("int64"), labels))
    return out


def bert_grad_gaps(torch, grads, ref):
    """grad_gaps for an encoder with separate key projections, without the
    key projections' biases: their grad is zero in exact arithmetic (the
    softmax over the keys ignores a shift common to one query's logits),
    so a relative gap there compares rounding noise with rounding noise.
    ``key_bias_share`` holds them instead."""
    keep = {n: g for n, g in grads.items() if not n.endswith(KEY_BIAS)}
    return grad_gaps(torch, keep, ref)


def key_bias_share(grads):
    """(name, share) of the key-projection bias whose grad norm is the
    largest share of its projection weight's grad norm: zero in exact
    arithmetic, a small share of it in floating point."""
    shares = [(n, (grads[n].float().norm() / grads[
        n[:-len("bias")] + "weight"].float().norm().clamp_min(1e-30)).item())
        for n in grads if n.endswith(KEY_BIAS)]
    return max(shares, key=lambda t: t[1])


def set_bert_flash(model, on):
    for layer in model.bert.encoder.layers:
        layer.self_attn.use_flash_attention = on


def bert_model(torch, cfg, seed, device="cuda", arch="bert"):
    """A sequence classifier (2 classes) with random weights from the
    seed, drawn on the host so that every device gets the same ones."""
    from paddle_tpu_torch.text.models import (BertForSequenceClassification,
                                              ErnieForSequenceClassification)
    cls = (ErnieForSequenceClassification if arch == "ernie"
           else BertForSequenceClassification)
    return cls(cfg, num_classes=2, device=device,
               generator=torch.Generator().manual_seed(seed))


def phase_to_static_grad(torch, seed):
    """The repaired faults of the captured step, on the card, with
    BERT-base in f32 at 4 x 256 (so B1, B2 and B3 run, SIMT, in its
    graphs, 12 layers' activations saved between them): a forward-only ``to_static(model)`` under an outer backward, called 3
    times (discovery, the capture of forward and backward, a replay), gives
    eager's grads; a train step that runs its own backward refuses to be
    differentiated; an optimizer built on host parameters, then the model
    moved to the card, reads its LinearWarmup scheduler's lr at every
    replay."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    (xs, ys), = cls_stream(seed + 7, 1, 5, 4, 256, cfg.vocab_size)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    eager = bert_model(torch, cfg, seed).train()
    static = pt.jit.to_static(bert_model(torch, cfg, seed).train())
    worst, zero_grads = [], []
    for i in range(3):
        want_loss, want = loss_and_grads(eager, xs[i], ys[i])
        got_loss, got = loss_and_grads(static, xs[i], ys[i])
        gaps = bert_grad_gaps(torch, got, want)
        worst.append({"call": i + 1, "loss": got_loss,
                      "eager_loss": want_loss, "worst": gaps[0],
                      "key_bias_share": key_bias_share(got)})
        zero_grads += [(i + 1, n) for n, g in got.items()
                       if not n.endswith(KEY_BIAS) and not g.any()]
    prog, = static.forward.programs.values()
    graphed = prog.graph is not None and prog.bwd_graph is not None

    model = bert_model(torch, cfg, seed).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = train_step_fn(model, opt)
    refused, message = [], None
    for i in range(3):
        loss = step(xs[i], ys[i])
        try:
            (2.0 * loss).backward()
            refused.append(False)
        except RuntimeError as err:
            message = str(err)
            refused.append("runs its own backward" in message)

    host = bert_model(torch, cfg, seed, device="cpu").train()
    sched = pt.optimizer.lr.LinearWarmup(learning_rate=1e-4, warmup_steps=3,
                                         start_lr=2e-5, end_lr=1e-4)
    opt = pt.optimizer.AdamW(learning_rate=sched,
                             parameters=host.parameters())
    host.to("cuda")
    lr_device_before = str(opt._learning_rate.device)

    @pt.jit.to_static
    def lr_step(x, y):
        loss = host(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float(), opt._learning_rate * 1.0
    lrs, want_lrs = [], []
    for i in range(5):
        want_lrs.append(float(np.float32(sched())))
        lrs.append(lr_step(xs[i], ys[i])[1].item())
        sched.step()
    lr_prog, = lr_step.programs.values()
    row = {"phase": "to_static_grad",
           "config": "BERT-base v30522 h768 L12 a12 d64 f32, batch 4 x 256",
           "forward_only": {"calls": worst, "rel_l2_tol": OUTER_GRAD_RTOL,
                            "zero_grads": zero_grads,
                            "forward_and_backward_captured": graphed},
           "self_backward_step_refused": refused,
           "refusal": message,
           "lr": {"device_at_build": lr_device_before,
                  "device_after": str(opt._learning_rate.device),
                  "read_back": lrs, "scheduler": want_lrs,
                  "captured": lr_prog.graph is not None}}
    emit(row)
    assert all(w["worst"][1] <= OUTER_GRAD_RTOL
               and w["key_bias_share"][1] <= KEY_BIAS_TOL["float32"]
               for w in worst), \
        worst
    assert not zero_grads and graphed, row
    assert refused == [True] * 3, (refused, message)
    assert lrs == want_lrs and lr_prog.graph is not None, row
    assert lr_device_before == "cpu" and opt._learning_rate.is_cuda
    del eager, static, model, host, opt, step, lr_step
    torch.cuda.empty_cache()
    return row


def phase_cls_train(torch, seed, arch):
    """bench.py's BERT (or ERNIE) lane: the base model (12 layers, hidden
    768, 12 heads) with dropout 0 in bf16, AdamW(1e-4, multi_precision),
    the parity-label stream at 16 x 128 from ``seed``, the step under
    ``to_static`` returning the f32 loss, driven by ``run_steps`` with 64
    steps an execution: 2 warm-up executions, then timed ones up to
    bench's recorded budget (512 steps for BERT, 256 for ERNIE). At s =
    128 attention takes the math path with no mask, as bench's. It runs
    once for each of CLS_WEIGHT_DRAWS weight seeds (``seed``, ``seed`` +
    1, ...) on the same batches; each run's replayed step is profiled.
    Gates: each run one compile in the warm-up, none timed, finite
    losses; the median of the runs' last-32 means below bench's chance
    floor 0.62."""
    from paddle_tpu_torch.text.models import BertConfig, ErnieConfig
    cfg = ErnieConfig() if arch == "ernie" else BertConfig.base()
    cfg.dropout = 0.0
    n_exec = CLS_STEPS[arch] // CLS_SPE
    stacks = [tuple(torch.from_numpy(a).cuda() for a in st)
              for st in cls_stream(seed, n_exec, CLS_SPE, CLS_BATCH, CLS_SEQ,
                                   cfg.vocab_size)]
    rows = [cls_run(torch, arch, cfg, stacks, seed, w)
            for w in range(seed, seed + CLS_WEIGHT_DRAWS)]
    means = [r[f"last{CLS_WINDOW}_mean"] for r in rows]
    median = float(np.median(means))
    emit({"phase": f"{arch}_floor", "data_seed": seed,
          "weight_seeds": [r["weight_seed"] for r in rows],
          f"last{CLS_WINDOW}_means": means, "median": median,
          "chance_floor": CLS_FLOOR})
    assert median < CLS_FLOOR, means
    del stacks
    torch.cuda.empty_cache()
    return rows


def cls_run(torch, arch, cfg, stacks, seed, weight_seed):
    """One run of the BERT (or ERNIE) lane from the weights of
    ``weight_seed`` on ``stacks`` (one (ids, labels) pair an execution),
    with its per-run gates; its row carries the last-32 mean."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    steps = CLS_STEPS[arch]
    n_exec = len(stacks)
    # an earlier model in a reference cycle (to_static(layer) binds the
    # layer's forward to a program that holds the layer) keeps its device
    # memory until the cycle collector runs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = bert_model(torch, cfg, weight_seed, arch=arch)
    model.bfloat16()
    model.train()
    build_s = time.perf_counter() - t0
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    step = CompiledTrainStep(train_step_fn(model, opt), label=f"{arch}_base")
    launch_counts.clear()
    reset_compile_stats()
    curve = []
    t0 = time.perf_counter()
    for e in range(2):
        curve.append(step.run_steps(*stacks[e]))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    warm = compile_stats()
    reset_compile_stats()
    t0 = time.perf_counter()
    for e in range(2, n_exec):
        curve.append(step.run_steps(*stacks[e]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timed = compile_stats()
    flash = {n: launch_counts[n] for n in KERNEL_NAMES}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(curve).tolist()
    timed_steps = (n_exec - 2) * CLS_SPE
    step_ms = seconds / timed_steps * 1e3
    x, y = stacks[-1][0][-1], stacks[-1][1][-1]
    trace, wall_s, _, prof = profiled(torch, lambda: step(x, y), 1)
    emit_profile(trace, wall_s, f"{arch}_train_replay", 1, top=10)
    last = float(np.mean(losses[-CLS_WINDOW:]))
    name = "ERNIE-base v18000" if arch == "ernie" else "BERT-base v30522"
    row = {"phase": f"{arch}_train", "dtype": "bfloat16",
           "config": f"{name} h768 L12 a12 d64, 2 classes, dropout 0",
           "optimizer": "AdamW lr 1e-4 multi_precision (f32 masters)",
           "data_seed": seed, "weight_seed": weight_seed,
           "batch": [CLS_BATCH, CLS_SEQ], "steps_per_execution": CLS_SPE,
           "executions": n_exec, "recorded_steps": len(losses),
           "timed_steps": timed_steps, "model_build_s": build_s,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "warmup_s": warmup_s, "step_ms": step_ms,
           "tokens_per_s": CLS_BATCH * CLS_SEQ * timed_steps / seconds,
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": prof["device_ms"]
                              / (wall_s * 1e3)},
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "peak_mem_bytes": peak, "flash_launches": flash,
           "attention_path": "math (s = 128 < 256)",
           "loss_first": losses[0], "loss_every_16th": losses[::16],
           f"last{CLS_WINDOW}_mean": last, "chance_floor": CLS_FLOOR,
           "replay_foreach_kernels": foreach_kernels(trace)}
    if arch == "bert" and weight_seed == seed:
        # after every gated number: one more (zero-grad) update
        row["optimizer_eager_step"] = optimizer_profile(torch, opt,
                                                        prof["device_ms"])
    emit(row)
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": timed_steps, "retrace_warnings": 0}, \
        (warm, timed)
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert all(c == 0 for c in flash.values()), flash
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def phase_bert_flash(torch, seed):
    """BERT-base at 8 x 512, dropout 0, no mask, where attention takes B1,
    B2 and B3 non-causal: (a) one f32 training step, kernel path (the SIMT
    variants) against the math path; (b) the same weights in bf16, the
    tensor-core kernel path against the f32 truth, no further from it than
    twice the bf16 math path; (c) eval-mode f32 logits of a few batches,
    kernel path against math path, and each path's latency in f32 and
    bf16; (d) a captured bf16 training step, 16 timed replays on each
    path, one replay of each profiled (B1, B2 and B3 counted by kernel
    name: 12 each on the kernel path)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import CompiledTrainStep
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    b, s = BERT_FLASH_SHAPE[:2]
    n = cfg.num_layers
    variants = {dt: [fa.variant_counter(k, dt) for k in KERNEL_NAMES]
                for dt in (torch.bfloat16, torch.float32)}
    warmup = 3
    (xs, ys), = cls_stream(seed + 5, 1, warmup + BERT_FLASH_REPLAYS + 1, b,
                           s, cfg.vocab_size)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    config = f"BERT-base v30522 h768 L12 a12 d64, batch {b} x {s}"
    torch.cuda.empty_cache()

    # (a) f32, kernel path against math path
    model = bert_model(torch, cfg, seed).train()
    launch_counts.clear()
    k_loss, k_grads = loss_and_grads(model, xs[0], ys[0])
    f32_launches = {k: launch_counts[k]
                    for k in (*variants[torch.float32],
                              *variants[torch.bfloat16])}
    set_bert_flash(model, False)
    launch_counts.clear()
    m_loss, m_grads = loss_and_grads(model, xs[0], ys[0])
    m_launches = sum(launch_counts[k] for k in KERNEL_NAMES)
    gaps = bert_grad_gaps(torch, k_grads, m_grads)
    check = {"phase": "bert_flash", "part": "f32 step", "config": config,
             "loss_kernel_path": k_loss, "loss_math_path": m_loss,
             "loss_rel_gap": abs(k_loss - m_loss) / abs(m_loss),
             "loss_rtol": TRAIN_LOSS_RTOL, "grad_rel_l2_worst": gaps[:3],
             "grad_rel_l2_median": gaps[len(gaps) // 2][1],
             "grad_rel_l2_tol": TRAIN_GRAD_RTOL,
             "kernel_path_variant_launches": f32_launches,
             "math_path_launches": m_launches,
             "key_bias_share": {"kernel": key_bias_share(k_grads),
                                "math": key_bias_share(m_grads),
                                "tol": KEY_BIAS_TOL["float32"]}}
    emit(check)
    assert all(check["key_bias_share"][p][1] <= KEY_BIAS_TOL["float32"]
               for p in ("kernel", "math")), check
    assert all(f32_launches[k] == n for k in variants[torch.float32])
    assert all(f32_launches[k] == 0 for k in variants[torch.bfloat16])
    assert m_launches == 0
    assert check["loss_rel_gap"] <= TRAIN_LOSS_RTOL, check
    assert gaps[0][1] <= TRAIN_GRAD_RTOL, check
    del k_grads

    # (c) eval-mode logits and latency, f32 and then bf16
    def infer(on):
        """The logits of 4 batches and their host-clock ms per batch."""
        set_bert_flash(model, on)
        with torch.inference_mode():
            model(xs[1])                                # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [model(xs[i]) for i in range(1, 5)]
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / 4 * 1e3
    model.eval()
    infer_row = {"phase": "bert_flash", "part": "inference",
                 "config": config, "batches": 4, "logits_tol": BERT_LOGIT_TOL}
    k_logits, infer_row["f32_kernel_ms"] = infer(True)
    m_logits, infer_row["f32_math_ms"] = infer(False)
    infer_row["f32_logits_max_abs_gap"] = max(
        (a - c).abs().max().item() for a, c in zip(k_logits, m_logits))

    # (b) the same weights in bf16 against the f32 truth
    model.train()
    bf16 = bf16_check(torch, model, xs[0], ys[0], m_loss, m_grads, variants,
                      path=set_bert_flash, n_layers=n,
                      config=config + " (bert_flash)", gaps=bert_grad_gaps,
                      zero_share=key_bias_share)
    model.eval()
    k_logits, infer_row["bf16_kernel_ms"] = infer(True)
    m_logits, infer_row["bf16_math_ms"] = infer(False)
    infer_row["bf16_logits_max_abs_gap"] = max(
        (a.float() - c.float()).abs().max().item()
        for a, c in zip(k_logits, m_logits))
    emit(infer_row)
    assert infer_row["f32_logits_max_abs_gap"] <= BERT_LOGIT_TOL, infer_row
    del model, m_grads, k_logits, m_logits
    torch.cuda.empty_cache()

    # (d) the captured bf16 step on each path, from the same weights
    steps = {}
    for on in (True, False):
        model = bert_model(torch, cfg, seed)
        model.bfloat16()
        model.train()
        set_bert_flash(model, on)
        opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                                 parameters=model.parameters())
        step = CompiledTrainStep(train_step_fn(model, opt),
                                 label=f"bert_flash_{on}")
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        losses = [step(xs[i], ys[i]) for i in range(warmup)]
        capture_launches = {k: launch_counts[k]
                            for k in variants[torch.bfloat16]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(warmup, warmup + BERT_FLASH_REPLAYS):
            losses.append(step(xs[i], ys[i]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        i = warmup + BERT_FLASH_REPLAYS
        # a replay of the last timed batch leads in (profiled's ``lead``)
        trace, wall_s, _, prof = profiled(
            torch, lambda: step(xs[i], ys[i]), 1,
            expect={k: n if on else 0 for k in TC_KERNEL_NAMES},
            lead=lambda: step(xs[i - 1], ys[i - 1]))
        emit_profile(trace, wall_s, "bert_flash_replay_"
                     + ("kernel_path" if on else "math_path"), 1, top=8,
                     after=prof["after_us"])
        step_ms = seconds / BERT_FLASH_REPLAYS * 1e3
        steps[on] = {"step_ms": step_ms,
                     "tokens_per_s": b * s * BERT_FLASH_REPLAYS / seconds,
                     "capture_launches": capture_launches,
                     "replay_profile": {**prof, "wall_ms": wall_s * 1e3},
                     "unprofiled_busy_share": prof["device_ms"] / step_ms,
                     "peak_mem_bytes": peak,
                     "losses": [loss.item() for loss in losses]}
        del model, opt, step
        torch.cuda.empty_cache()
    kernel, math = steps[True], steps[False]
    row = {"phase": "bert_flash", "part": "captured bf16 step",
           "config": config, "replays_timed": BERT_FLASH_REPLAYS,
           "kernel_path": kernel, "math_path": math,
           "speedup_vs_math": math["step_ms"] / kernel["step_ms"]}
    emit(row)
    per_replay = kernel["replay_profile"]["flash_launches"]
    assert per_replay == {k: n for k in TC_KERNEL_NAMES}, per_replay
    assert all(c == 0 for c in
               math["replay_profile"]["flash_launches"].values()), math
    # the capture passes through the wrappers once: discovery + capture
    assert all(c == 2 * n for c in kernel["capture_launches"].values())
    for path in (kernel, math):
        assert all(np.isfinite(path["losses"])), path["losses"]
    return {"f32": check, "bf16": bf16, "inference": infer_row,
            "captured": row,
            "launches": {k: bf16["kernel_path_launches"].get(k, 0)
                         for k in variants[torch.bfloat16]}}


# --- the conv net slice: ResNet and LeNet --------------------------------

def vision_pair(torch, make, seed):
    """The same model (``make(device)``, weights from ``seed``) on the card
    and on the host: the port's layers draw on the generator's device (the
    host), so both get the same weights."""
    import paddle_tpu_torch as pt
    card = make("cuda", pt.make_generator(seed))
    host = make("cpu", pt.make_generator(seed))
    return card, host


def step_state(torch, model, opt, x, y):
    """One training step of ``model``: the f32 loss, every grad and every
    running statistic after the forward, then the optimizer's update."""
    import paddle_tpu_torch.nn.functional as F
    loss = F.cross_entropy(model(x).float(), y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    opt.step()
    opt.clear_grad()
    return loss.item(), grads, stats


def max_rel_gap(a, b):
    """max |a - b| / max |b| over two tensors, in f32 on the host."""
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def phase_vision_reference(torch, seed):
    """A ResNet-18 (10 classes, NHWC, the space-to-depth stem, fused conv
    + BN) at 2 x 3 x 64 x 64 and a LeNet at 8 x 1 x 28 x 28 on the card
    are held against the same models on the host (whose path the host
    tests hold against paddle_tpu), in f32 with TF32 off: one Momentum
    step (the loss, every grad, the running statistics the forward moved)
    and then the eval logits of the updated weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import LeNet, resnet18
    rng = np.random.RandomState(seed + 11)
    cases = {
        "resnet18": (lambda d, g: resnet18(
            num_classes=10, data_format="NHWC", stem="space_to_depth",
            device=d, generator=g),
            rng.randn(2, 64, 64, 3).astype("float32"),
            rng.randint(0, 10, (2,))),
        "lenet": (lambda d, g: LeNet(device=d, generator=g),
                  rng.randn(8, 1, 28, 28).astype("float32"),
                  rng.randint(0, 10, (8,))),
    }
    rows = {}
    for name, (make, x, y) in cases.items():
        card, host = vision_pair(torch, make, seed)
        got, want = [], []
        for model, dev, out in ((card, "cuda", got), (host, "cpu", want)):
            model.train()
            opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=model.parameters())
            xt = torch.tensor(x, device=dev)
            out.extend(step_state(torch, model, opt, xt,
                                  torch.tensor(y, device=dev)))
            model.eval()
            with torch.no_grad():
                out.append(model(xt))
        grads = grad_gaps(torch, got[1], want[1])
        stats = sorted(((n, max_rel_gap(got[2][n], want[2][n]))
                        for n in want[2]), key=lambda t: -t[1])
        row = {"phase": "vision_reference", "model": name,
               "loss": got[0], "host_loss": want[0],
               "loss_rel_gap": abs(got[0] - want[0]) / abs(want[0]),
               "worst_grads": grads[:3], "grads": len(grads),
               "worst_stats": stats[:3], "stats": len(stats),
               "eval_logits_gap": max_rel_gap(got[3], want[3]),
               "tol": VISION_TOL}
        emit(row)
        assert row["loss_rel_gap"] <= VISION_TOL["loss"], row
        assert grads[0][1] <= VISION_TOL["grad"], row
        assert not stats or stats[0][1] <= VISION_TOL["stats"], row
        assert row["eval_logits_gap"] <= VISION_TOL["logits"], row
        rows[name] = row
    return rows


def image_stream(torch, seed, stacks, spe, batch, shape, classes, scale,
                 noise, dtype):
    """bench.py's class-prototype stream (bench_resnet50, bench_lenet),
    made on the card from a seeded CUDA generator: ``classes`` prototype
    images of ``shape`` from N(0, 1), and each batch's image = ``scale`` *
    prototype[label] + ``noise`` * N(0, 1), labels uniform. Returns
    ``stacks`` (images, labels) pairs with a leading axis of ``spe``
    batches."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    protos = torch.randn((classes, *shape), generator=g, device="cuda")
    out = []
    for _ in range(stacks):
        ys = torch.randint(0, classes, (spe, batch), generator=g,
                           device="cuda")
        xs = torch.empty((spe, batch, *shape), dtype=dtype, device="cuda")
        for i in range(spe):
            xs[i] = scale * protos[ys[i]] + noise * torch.randn(
                (batch, *shape), generator=g, device="cuda")
        out.append((xs, ys))
    del protos
    return out


def conv_step_fn(model, opt):
    """bench.py's conv net step through the port: the f32 cross-entropy of
    the logits, backward, the optimizer's update."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F

    @pt.jit.to_static
    def step(x, y):
        loss = F.cross_entropy(model(x).float(), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def host_top(prof, top=8):
    """The host ops of a profile that took the most host time (self CPU
    ms, calls), for where the host bounds a path."""
    ops = sorted((e for e in prof.key_averages()
                  if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)
    return [{"op": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "calls": e.count} for e in ops[:top]]


def kernel_classes(prof):
    """Device ms and launches of a profile's kernels by kind: cuDNN's and
    CUTLASS's convolutions, torch.cat's kernels, copies (each copy kernel
    listed), reductions, the other elementwise kernels (BatchNorm's among
    them)."""
    classes, copies = {}, []
    for us, count, name in kernel_times(prof):
        low = name.lower()
        if any(k in low for k in ("conv", "cudnn", "xmma", "cutlass",
                                  "wgrad", "dgrad", "implicit", "gemm")):
            kind = "conv_gemm"
        elif "catarray" in low:
            kind = "concat"
        elif "copy" in low or "memcpy" in low:
            kind = "copy"
            copies.append({"kernel": name[:150], "ms": us / 1e3,
                           "count": count})
        elif "reduce" in low:
            kind = "reduce"
        else:
            kind = "elementwise_other"
        ms, n = classes.get(kind, (0.0, 0))
        classes[kind] = (ms + us / 1e3, n + count)
    return {**{k: {"ms": ms, "launches": n}
               for k, (ms, n) in classes.items()}, "copy_kernels": copies}


def train_lane(torch, label, model, opt, stacks, warmup_exec, timed_exec,
               watch, after_exec=None):
    """Drive a captured conv net step through ``run_steps``, one staged
    stack per execution (rotating): ``warmup_exec`` executions, then
    ``timed_exec`` timed ones, with the launch counts reset just before
    and read just after, and the compile counters of each window;
    ``after_exec``, where given, runs after each execution (a scheduler's
    step). The buffers named in ``watch`` are read before and after the
    timed window. Returns (losses, seconds, warm, timed, flash launches,
    watched (before, after), the step)."""
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    step = CompiledTrainStep(conv_step_fn(model, opt), label=label)
    buffers = dict(model.named_buffers())
    launch_counts.clear()
    reset_compile_stats()
    curve = []
    for e in range(warmup_exec):
        curve.append(step.run_steps(*stacks[e % len(stacks)]))
        if after_exec is not None:
            after_exec()
    torch.cuda.synchronize()
    warm = compile_stats()
    reset_compile_stats()
    before = {n: buffers[n].float().clone() for n in watch}
    t0 = time.perf_counter()
    for e in range(warmup_exec, warmup_exec + timed_exec):
        curve.append(step.run_steps(*stacks[e % len(stacks)]))
        if after_exec is not None:
            after_exec()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timed = compile_stats()
    after = {n: buffers[n].float().clone() for n in watch}
    flash = {n: launch_counts[n] for n in KERNEL_NAMES}
    return (torch.cat(curve).tolist(), seconds, warm, timed, flash,
            (before, after), step)


def phase_resnet_train(torch, seed):
    """bench.py's ResNet-50 lane (bench_resnet50) at full width and depth:
    ResNet-50 (1000 classes) with bf16 parameters and buffers, NHWC, the
    space-to-depth stem, fused conv + BN, Momentum(0.1, 0.9), batch 128 at
    224 x 224 from bench's prototype stream (made on the card), the step
    captured and driven by run_steps K = 32: 2 warm-up and 12 timed
    executions over 3 staged stacks (96 distinct batches), 448 recorded
    steps. Gates: last-32 mean below bench's chance floor 6.71, 1 compile
    in the warm-up and none timed, the running statistics moved over the
    timed window, no flash kernel launched. Prints step ms, images/s, MFU
    (3 x 4.09 GFLOP an image, bench.py:903-904, against the dense bf16
    peak), peak memory and one replay's profile."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import resnet50
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stacks = image_stream(torch, seed, RESNET_STACKS, RESNET_SPE,
                          RESNET_BATCH, (RESNET_HW, RESNET_HW, 3), 1000,
                          RESNET_PROTO_SCALE, 1.0, torch.bfloat16)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    model = resnet50(data_format="NHWC", stem="space_to_depth",
                     device="cuda", generator=pt.make_generator(seed))
    model.bfloat16()
    model.train()
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                parameters=model.parameters())
    watch = ("bn1._mean", "layer4.2.bn3._variance")
    losses, seconds, warm, timed, flash, (before, after), step = train_lane(
        torch, "resnet50", model, opt, stacks, RESNET_WARMUP_EXEC,
        RESNET_TIMED_EXEC, watch)
    peak = torch.cuda.max_memory_allocated()
    timed_steps = RESNET_TIMED_EXEC * RESNET_SPE
    step_ms = seconds / timed_steps * 1e3
    ips = RESNET_BATCH * timed_steps / seconds
    moved = {n: (after[n] - before[n]).abs().max().item() for n in watch}
    x, y = stacks[-1][0][-1], stacks[-1][1][-1]
    trace, wall_s, _, prof = profiled(torch, lambda: step(x, y), 1)
    emit_profile(trace, wall_s, "resnet50_train_replay", 1, top=15,
                 by_class=kernel_classes(trace))
    last = float(np.mean(losses[-RESNET_WINDOW:]))
    n_params = sum(1 for _ in model.parameters())
    row = {"phase": "resnet_train", "dtype": "bfloat16",
           "config": "ResNet-50 1000 classes, NHWC, space-to-depth stem, "
                     "fused conv+BN", "parameters": n_params,
           "optimizer": "Momentum lr 0.1 momentum 0.9",
           "batch": [RESNET_BATCH, RESNET_HW, RESNET_HW, 3],
           "steps_per_execution": RESNET_SPE,
           "executions": RESNET_WARMUP_EXEC + RESNET_TIMED_EXEC,
           "distinct_batches": RESNET_SPE * RESNET_STACKS,
           "recorded_steps": len(losses), "timed_steps": timed_steps,
           "data": "prototype stream made on the card (torch CUDA "
                   "generator)", "data_s": data_s,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "step_ms": step_ms, "images_per_s": ips,
           "mfu": ips * RESNET_TRAIN_FLOP / PEAK_FLOPS["bfloat16"],
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": prof["device_ms"]
                              / (wall_s * 1e3)},
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "peak_mem_bytes": peak, "flash_launches": flash,
           "running_stats_moved": moved,
           "loss_first": losses[0], "loss_every_32nd": losses[::32],
           f"last{RESNET_WINDOW}_mean": last, "chance_floor": RESNET_FLOOR,
           "replay_foreach_kernels": foreach_kernels(trace)}
    emit(row)
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": timed_steps, "retrace_warnings": 0}, \
        (warm, timed)
    assert len(losses) == RESNET_RECORDED and all(np.isfinite(losses))
    assert last < RESNET_FLOOR, row
    assert all(v > 0 for v in moved.values()), moved
    assert all(c == 0 for c in flash.values()), flash
    # the optimizer's own kernels, from an extra (zero-grad) update that
    # resnet_eval must not see: the trained weights are put back
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    row["optimizer_eager_step"] = optimizer_profile(torch, opt,
                                                    prof["device_ms"])
    model.load_state_dict(saved)
    emit({"phase": "resnet_train", "part": "optimizer",
          "optimizer_eager_step": row["optimizer_eager_step"]})
    del stacks, step, opt, saved
    gc.collect()
    torch.cuda.empty_cache()
    return row, model


def one_step(torch, model, x, y):
    """Eager forward and backward of the f32 loss: (loss, {name: grad})."""
    import paddle_tpu_torch.nn.functional as F
    loss = F.cross_entropy(model(x).float(), y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_resnet_fused(torch, seed):
    """The fused conv + BN op on the card. (a) One f32 step (TF32 off) of
    ResNet-50 at 32 x 224 x 224, NHWC, the space-to-depth stem, fused
    against unfused (``fused_conv_bn=False``) on the same weights and
    batch: the loss within FUSED_LOSS_RTOL, every grad within
    FUSED_GRAD_RTOL relative L2. (b) bf16 at batch 128, fused against
    unfused: the peak memory of an eager step over the memory held before
    it, and the eager step's time (3 steps after a warm-up one)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import resnet50

    def build(fused, dtype):
        m = resnet50(data_format="NHWC", stem="space_to_depth",
                     fused_conv_bn=fused, device="cuda",
                     generator=pt.make_generator(seed))
        return (m.bfloat16() if dtype == torch.bfloat16 else m).train()

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    x = torch.randn((FUSED_F32_BATCH, RESNET_HW, RESNET_HW, 3), generator=g,
                    device="cuda")
    y = torch.randint(0, 1000, (FUSED_F32_BATCH,), generator=g,
                      device="cuda")
    res = {}
    for fused in (True, False):
        model = build(fused, torch.float32)
        res[fused] = one_step(torch, model, x, y)
        del model
    gaps = grad_gaps(torch, res[True][1], res[False][1])
    loss_gap = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    del res
    gc.collect()
    torch.cuda.empty_cache()

    xb = torch.randn((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), generator=g,
                     device="cuda").to(torch.bfloat16)
    yb = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device="cuda")
    mem = {}
    for fused in (True, False):
        model = build(fused, torch.bfloat16)
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
        step = conv_step_fn(model, opt)
        pt.set_flags({"FLAGS_compiled_step": 0})
        try:
            step(xb, yb)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(xb, yb)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            t0 = time.perf_counter()
            for _ in range(3):
                step(xb, yb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
        finally:
            pt.set_flags({"FLAGS_compiled_step": 1})
        mem["fused" if fused else "unfused"] = {
            "step_peak_over_held_bytes": peak, "held_bytes": held,
            "eager_step_ms": ms}
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    row = {"phase": "resnet_fused",
           "f32_step": {"batch": [FUSED_F32_BATCH, RESNET_HW, RESNET_HW, 3],
                        "loss_rel_gap": loss_gap,
                        "loss_rtol": FUSED_LOSS_RTOL,
                        "worst_grads": gaps[:5],
                        "median_grad_gap": float(np.median(
                            [gap for _, gap in gaps])),
                        "grad_rtol": FUSED_GRAD_RTOL},
           "bf16_b128": mem,
           "residual_bytes_saved": mem["unfused"]["step_peak_over_held_bytes"]
           - mem["fused"]["step_peak_over_held_bytes"]}
    emit(row)
    assert loss_gap <= FUSED_LOSS_RTOL, row
    assert gaps[0][1] <= FUSED_GRAD_RTOL, row
    return row


def phase_resnet_eval(torch, seed, trained):
    """ResNet-50 in eval mode, bf16, on the weights and running statistics
    the resnet_train phase left: the fused path (fused_conv_bn's folded-
    statistics branch) against the unfused path (BatchNorm in eval), at
    batch 128 and at batch 1. Both are held to the same weights in f32 on
    the unfused path: the fused path's relative L2 gap at most
    EVAL_FACTOR x the unfused path's + EVAL_SLACK. Latency (host clock
    ending in a synchronize, mean of EVAL_CALLS calls), device time (None
    where the profiler lost kernels and queued events could not stand in)
    and the host ops that took the most host time."""
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.vision.models import resnet50
    state = trained.state_dict()
    paths = {"fused": trained.eval()}
    for name, fused, dtype in (("unfused", False, torch.bfloat16),
                               ("unfused_f32", False, torch.float32)):
        m = resnet50(data_format="NHWC", stem="space_to_depth",
                     fused_conv_bn=fused, device="cuda")
        if dtype == torch.bfloat16:
            m.bfloat16()
        pt.load_numpy_state_dict(m, state)
        paths[name] = m.eval()
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    x = torch.randn((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), generator=g,
                    device="cuda").to(torch.bfloat16)
    rows = []
    launch_counts.clear()
    with torch.no_grad():
        for batch in (RESNET_BATCH, 1):
            xb = x[:batch]
            out = {k: m(xb if k != "unfused_f32" else xb.float()).float()
                   for k, m in paths.items()}
            truth = out["unfused_f32"]
            gap = {k: rel_l2(out[k], truth) for k in ("fused", "unfused")}
            row = {"phase": "resnet_eval", "batch": batch,
                   "dtype": "bfloat16",
                   "rel_l2_to_f32": gap,
                   "fused_vs_unfused_rel_l2": rel_l2(out["fused"],
                                                     out["unfused"]),
                   "argmax_agree": (out["fused"].argmax(-1)
                                    == out["unfused"].argmax(-1))
                   .float().mean().item(),
                   "tol": {"factor": EVAL_FACTOR, "slack": EVAL_SLACK}}
            for k in ("fused", "unfused"):
                m = paths[k]
                for _ in range(3):
                    m(xb)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EVAL_CALLS):
                    m(xb)
                torch.cuda.synchronize()
                latency = (time.perf_counter() - t0) / EVAL_CALLS * 1e3
                dev, launches = device_profile(torch, lambda: m(xb), reps=2,
                                               warmup=1)
                if launches is None and \
                        not TIMING["queued_events"][-1]["queue_held"]:
                    # the profiles lost kernels and the host did not stay
                    # ahead of the queued calls: no device time
                    dev = None
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    m(xb)
                    torch.cuda.synchronize()
                row[k] = {"latency_ms": latency, "device_ms": dev,
                          "kernels": launches, "host_top": host_top(prof)}
            row["latency_ms"] = row["fused"]["latency_ms"]
            row["images_per_s"] = batch / row["latency_ms"] * 1e3
            emit(row)
            assert gap["fused"] <= EVAL_FACTOR * gap["unfused"] \
                + EVAL_SLACK, row
            rows.append(row)
    flash = {n: launch_counts[n] for n in KERNEL_NAMES}
    assert all(c == 0 for c in flash.values()), flash
    del paths, trained
    gc.collect()
    torch.cuda.empty_cache()
    return rows, flash


def phase_lenet_train(torch, seed):
    """bench.py's LeNet lane (bench_lenet): LeNet in f32, Adam(1e-3),
    batch 256 of 1 x 28 x 28 prototype images (10 classes, noise 0.3,
    made on the card), the step captured and driven by run_steps K = 32:
    2 warm-up executions and 1 timed, each on its own stack (96 distinct
    batches, 96 recorded steps). Gates: last-32 mean below bench's floor
    1.80, 1 compile in the warm-up and none timed, no flash kernel."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import LeNet
    stacks = image_stream(torch, seed, 3, LENET_SPE, LENET_BATCH,
                          (1, 28, 28), 10, 1.0, 0.3, torch.float32)
    model = LeNet(device="cuda", generator=pt.make_generator(seed)).train()
    opt = pt.optimizer.Adam(learning_rate=1e-3,
                            parameters=model.parameters())
    losses, seconds, warm, timed, flash, _, _ = train_lane(
        torch, "lenet", model, opt, stacks, 2, 1, ())
    last = float(np.mean(losses[-LENET_WINDOW:]))
    row = {"phase": "lenet_train", "dtype": "float32",
           "optimizer": "Adam lr 1e-3", "batch": [LENET_BATCH, 1, 28, 28],
           "steps_per_execution": LENET_SPE, "recorded_steps": len(losses),
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "step_ms": seconds / LENET_SPE * 1e3,
           "images_per_s": LENET_BATCH * LENET_SPE / seconds,
           "flash_launches": flash, "loss_first": losses[0],
           "loss_every_8th": losses[::8],
           f"last{LENET_WINDOW}_mean": last, "chance_floor": LENET_FLOOR}
    emit(row)
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": LENET_SPE, "retrace_warnings": 0}, \
        (warm, timed)
    assert len(losses) == 3 * LENET_SPE and all(np.isfinite(losses))
    assert last < LENET_FLOOR, row
    assert all(c == 0 for c in flash.values()), flash
    del stacks, model, opt
    torch.cuda.empty_cache()
    return row



def serve_burst(torch, srv, rows, clients):
    """``clients`` threads each submit their share of ``rows`` (one row per
    request) at once, then wait for every reply. Returns each request in
    row order, each one's latency (s, submit to reply on the host clock)
    and the burst's wall seconds."""
    import threading
    reqs, lat = [None] * len(rows), [None] * len(rows)
    errors = []

    def client(k):
        try:
            mine = []
            for i in range(k, len(rows), clients):
                mine.append((i, time.perf_counter(),
                             srv.submit([rows[i:i + 1]], timeout=120.0)))
            for i, t0, req in mine:
                req.wait(120.0)
                lat[i] = time.perf_counter() - t0
                reqs[i] = req
        except Exception as e:     # reported below, never swallowed
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall_s = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    assert not errors, errors
    return reqs, lat, wall_s


def row_gaps(got, want):
    """Each row's relative L2 gap of ``got`` to ``want``, in f64."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    return np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)


def eager_forwards(torch, model, x, batch):
    """The f32 eager forward of ``x`` (a host array) and that of a bf16
    copy of ``model`` (parameters and buffers cast, float inputs cast),
    in batches of ``batch`` rows, both as f32 host arrays."""
    import copy
    twin = copy.deepcopy(model).bfloat16().eval()
    out = {"f32": [], "bf16": []}
    with torch.no_grad():
        for i in range(0, len(x), batch):
            xb = torch.from_numpy(x[i:i + batch]).cuda()
            out["f32"].append(model(xb).float().cpu())
            if xb.is_floating_point():
                xb = xb.to(torch.bfloat16)
            out["bf16"].append(twin(xb).float().cpu())
    del twin
    return {k: torch.cat(v).numpy() for k, v in out.items()}


def reply_check(reqs, eager):
    """Each reply against the eager forwards of its row: its relative L2
    gap to the bf16 eager forward (the same arithmetic: at most
    SERVE_TOL), and its gap to the f32 eager forward against the bf16
    eager forward's own (at most SERVE_FACTOR x it + SERVE_TOL). Returns
    the summary and whether every row passed."""
    for i, req in enumerate(reqs):
        assert req is not None and req.error is None, (i, req and req.error)
    got = np.stack([np.asarray(r.result[0][0], np.float32) for r in reqs])
    to_f32, to_bf16 = row_gaps(got, eager["f32"]), row_gaps(got,
                                                            eager["bf16"])
    bf16_to_f32 = row_gaps(eager["bf16"], eager["f32"])
    ok = bool(np.all(to_bf16 <= SERVE_TOL) and np.all(
        to_f32 <= SERVE_FACTOR * bf16_to_f32 + SERVE_TOL))
    summary = {
        "reply_to_f32_rel_l2": {"worst": float(to_f32.max()),
                                "median": float(np.median(to_f32)),
                                "all_rows": float(np.linalg.norm(
                                    got - eager["f32"]) / np.linalg.norm(
                                    eager["f32"]))},
        "bf16_eager_to_f32_rel_l2": {"worst": float(bf16_to_f32.max()),
                                     "median": float(np.median(
                                         bf16_to_f32))},
        "reply_to_bf16_eager_rel_l2": {"worst": float(to_bf16.max()),
                                       "median": float(np.median(to_bf16)),
                                       "rows_equal_to_the_bit": int(
                                           np.sum(to_bf16 == 0))},
        "tol": {"to_bf16_eager": SERVE_TOL, "factor": SERVE_FACTOR,
                "slack": SERVE_TOL}}
    return summary, ok


def server_summary(stats, lat, wall_s, n):
    """The lane's end-to-end numbers: host-clock latency of each request
    (submit to reply), the server's own percentiles, requests/s over the
    burst, batches, occupancy, sheds, failures, hedges and retries, and
    each batch's dispatch time on the host clock (the always-on
    ``serving.batch_exec_ms`` histogram, reset before the lane)."""
    from paddle_tpu_torch.profiler.metrics import get_registry
    exec_ms = get_registry().histogram_summary("serving.batch_exec_ms")
    return {"requests": n, "wall_s": wall_s, "requests_per_s": n / wall_s,
            "batch_exec_ms": {k: exec_ms[k] for k in ("count", "p50",
                                                      "p99")},
            "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "server_latency_p50_ms": stats["latency_p50"] * 1e3,
            "server_latency_p99_ms": stats["latency_p99"] * 1e3,
            "batches": stats["batches"],
            "batch_occupancy": stats["batch_occupancy"],
            "shed": stats["shed"], "failed": stats["failed"],
            "hedges": stats["hedges"], "hedge_wins": stats["hedge_wins"],
            "retries": stats["retries"]}


# the device symbols of the CUDA-core variants (TC_KERNEL_NAMES holds the
# tensor-core ones); neither name is a substring of the other
SIMT_KERNEL_NAMES = {"flash_attn_fwd": "flash_fwd_kernel",
                     "flash_attn_bwd_dkv": "flash_bwd_dkv_kernel",
                     "flash_attn_bwd_dq": "flash_bwd_dq_kernel"}


def replay_profile(torch, graph, replays=5):
    """Device time and kernels per replay of one predictor graph (replayed
    under its lock), B1-B3 counted by kernel name (each variant apart,
    ``flash_variant_launches``), and the softmax kernels that ran (the
    math attention path's), if any. One replay leads in (profiled's
    ``lead``), so the records a profile loses at its start are its."""
    def replay(n):
        with graph.lock:
            for _ in range(n):
                graph.graph.replay()
    prof, _, _, per = profiled(torch, lambda: replay(replays), replays,
                               lead=lambda: replay(1))
    kernels = kernel_times(prof, per["after_us"])
    per["top_kernels"] = [(name[:70], us / 1e3 / replays, count / replays)
                          for us, count, name in kernels[:6]]
    per["flash_variant_launches"] = {
        f"{k}.{kind}": sum(c for _, c, name in kernels if sym in name)
        / replays
        for kind, names in (("tc_bf16", TC_KERNEL_NAMES),
                            ("simt_f32", SIMT_KERNEL_NAMES))
        for k, sym in names.items()}
    softmax = sorted({k[2] for k in kernels if "softmax" in k[2].lower()})
    return per, softmax


def predictor_run_ms(pred, batch, calls=10):
    """Host-clock ms of one ``Predictor.run`` on a bucket's batch: the
    copy into the graph's buffers, the replay and the copy of the outputs
    back (the predictor's share of a dispatch)."""
    pred.run([batch])
    t0 = time.perf_counter()
    for _ in range(calls):
        pred.run([batch])
    return (time.perf_counter() - t0) / calls * 1e3


def phase_serving_bert(torch, seed):
    """BERT-base sequence classification (2 classes, full width, random
    weights from the seed) served in bf16 through the port's entry points:
    ``inference.Config().set_layer(model)`` +
    ``enable_low_precision(BFLOAT16)``, then ``InferenceServer`` with
    ServingConfig(max_batch_size=8, replicas=2, warmup_signatures=[512
    int64 ids]) (buckets 1, 2, 4, 8, every one captured before start()),
    started threaded; SERVE_CLIENTS threads submit SERVE_REQUESTS
    512-token requests with no mask, a burst each. Gates: every reply
    held to the eager forwards of its row on the card (reply_check), no
    shed and no failure, each replica at most 4 compiles and none
    after warm-up, and in a profiled replay of the bucket-8 graph B1 12
    times (tc_bf16, non-causal) and no softmax kernel. Returns its row and
    the started server, which the decode lane reuses."""
    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import (KERNEL_NAMES,
                                                           variant_counter)
    from paddle_tpu_torch.profiler.metrics import reset_registry
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig
    from paddle_tpu_torch.text.models import BertConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = BertConfig.base()
    model = bert_model(torch, cfg, seed).eval()
    rows = np.random.RandomState(seed + 21).randint(
        0, cfg.vocab_size, (SERVE_REQUESTS, SERVE_SEQ)).astype("int64")
    eager = eager_forwards(torch, model, rows, SERVE_BATCH)
    icfg = infer.Config()
    icfg.set_layer(model)
    icfg.enable_low_precision(infer.DataType.BFLOAT16)
    scfg = ServingConfig(max_batch_size=SERVE_BATCH, replicas=SERVE_REPLICAS,
                         warmup_signatures=[(((SERVE_SEQ,), "int64"),)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_registry()
    launch_counts.clear()
    t0 = time.perf_counter()
    srv = InferenceServer(icfg, scfg)
    warmup_s = time.perf_counter() - t0
    warm = [r.compile_count for r in srv.scheduler.replicas]
    srv.start()
    reqs, lat, wall_s = serve_burst(torch, srv, rows, SERVE_CLIENTS)
    stats = srv.stats()
    peak = torch.cuda.max_memory_allocated()
    counts = {k: launch_counts[k] for k in KERNEL_NAMES}
    variants = {variant_counter(k, dt): launch_counts[variant_counter(k, dt)]
                for k in KERNEL_NAMES
                for dt in (torch.bfloat16, torch.float32)}
    tc = variant_counter(KERNEL_NAMES[0], torch.bfloat16)
    tc_launches = launch_counts[tc]
    compiles = [r.compile_count for r in srv.scheduler.replicas]
    pred = srv.scheduler.replicas[0].executor.predictor
    prog = pred._jit_cache[(((SERVE_BATCH, SERVE_SEQ), "int64"),)]
    per, softmax = replay_profile(torch, prog.graph)
    per["predictor_run_ms"] = predictor_run_ms(pred, rows[:SERVE_BATCH])
    replies, replies_ok = reply_check(reqs, eager)
    row = {"phase": "serving", "lane": "bert_server",
           "config": f"BERT-base v30522 h768 L12 a12 d64 bf16, requests of "
                     f"1 x {SERVE_SEQ} ids, buckets {srv.config.buckets}, "
                     f"{SERVE_REPLICAS} replicas, {SERVE_CLIENTS} clients",
           **server_summary(stats, lat, wall_s, SERVE_REQUESTS),
           "warmup_s": warmup_s, "compiles_after_warmup": warm,
           "compiles_after_serving": compiles, "peak_mem_bytes": peak,
           "flash_launches_warmup_and_capture": counts,
           "flash_variant_launches_warmup_and_capture": variants,
           "bucket8_replay": per, "softmax_kernels": softmax, **replies}
    emit(row)
    n = cfg.num_layers
    assert replies_ok, row
    assert stats["completed"] == SERVE_REQUESTS and not stats["shed"] \
        and not stats["failed"], row
    assert all(c <= len(srv.config.buckets) for c in warm), row
    assert compiles == warm, row
    # warm-up: each bucket's graph runs once eagerly, then is captured;
    # replays pass no Python wrapper
    assert counts == {KERNEL_NAMES[0]: 2 * n * len(srv.config.buckets),
                      KERNEL_NAMES[1]: 0, KERNEL_NAMES[2]: 0}, row
    assert tc_launches == counts[KERNEL_NAMES[0]], row
    assert per["flash_launches"] == {KERNEL_NAMES[0]: n, KERNEL_NAMES[1]: 0,
                                     KERNEL_NAMES[2]: 0}, row
    assert per["flash_variant_launches"] == {
        v: (n if v == tc else 0) for v in variants}, row
    assert not softmax, row
    return row, srv


def phase_serving_decode(torch, srv):
    """The continuous-batching decode engine on the started BERT server:
    ``attach_decode(CompiledDecodeBackend(max_running=4),
    DecodeConfig(max_running=4, max_new_tokens=6))`` (the backend's step a
    CUDA graph per (bucket, signature)), then ``submit_generate`` of
    DECODE_PROMPTS prompts in waves of the running-set cap (the engine
    must not run more streams than the backend's largest bucket: ROADMAP
    C-ref-6). Gates: the verify skill's prompt streams its known six
    tokens, identical prompts stream identical tokens, compiles at most
    the backend's buckets, each a captured graph, the KV pool back to
    full, no B1-B3 launch. Stops the server."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.serving.decode import (CompiledDecodeBackend,
                                                 DecodeConfig)
    launch_counts.clear()
    backend = CompiledDecodeBackend(max_running=4)
    eng = srv.attach_decode(backend, DecodeConfig(max_running=4,
                                                  max_new_tokens=6))
    prompt, known = DECODE_ORACLE
    prompts = [list(prompt), [3, 1, 4, 1, 5, 9, 2, 6], list(range(40)),
               list(prompt), [7] * 17, [2, 7, 1, 8], list(range(60, 0, -1)),
               [3, 1, 4, 1, 5, 9, 2, 6]][:DECODE_PROMPTS]
    streams = []
    t0 = time.perf_counter()
    for i in range(0, len(prompts), 4):
        wave = [srv.submit_generate(p, timeout=60.0)
                for p in prompts[i:i + 4]]
        for s in wave:
            assert s.wait(60.0), s.describe()
        streams += wave
    wall_s = time.perf_counter() - t0
    stats = srv.stats()["decode"]
    flash = {k: launch_counts[k] for k in KERNEL_NAMES}
    srv.stop()
    tokens = [list(s.tokens) for s in streams]
    row = {"phase": "serving", "lane": "decode",
           "config": "CompiledDecodeBackend toy stepper, KV row width 8, "
                     f"buckets {backend.buckets}, on the started BERT "
                     "server",
           "prompts": len(prompts), "wall_s": wall_s,
           "tokens_per_s": sum(map(len, tokens)) / wall_s,
           "tokens": tokens,
           "errors": [repr(s.error) for s in streams if s.error],
           "compiles": backend.step.compile_count,
           "cache_hits": backend.step.cache_hits,
           "graphs_captured": sum(p is not None for p in
                                  backend.step._programs.values()),
           "kv_blocks_free": stats["kv_blocks_free"],
           "kv_blocks": eng.pool.num_blocks,
           **{k: stats[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                    "tpot_p50_ms", "tpot_p99_ms")},
           "flash_launches": flash}
    emit(row)
    assert not row["errors"], row
    assert tokens[0] == known and tokens[3] == tokens[0], row
    assert tokens[1] == tokens[7], row
    assert 1 <= backend.step.compile_count <= len(backend.buckets), row
    assert row["graphs_captured"] == backend.step.compile_count, row
    assert stats["kv_blocks_free"] == eng.pool.num_blocks, row
    assert all(c == 0 for c in flash.values()), row
    return row


def phase_serving_resnet(torch, seed):
    """ResNet-50 eval served in bf16 (NHWC, the space-to-depth stem, fused
    conv + BN on folded statistics, random weights from the seed, running
    statistics moved by two training-mode forwards) behind the same
    server: ServingConfig(max_batch_size=8, replicas=2), warm-up of one
    224 x 224 x 3 float32 image, SERVE_RESNET_REQUESTS requests of one
    image from SERVE_CLIENTS threads. Float inputs: each call casts them
    to bf16 on the copy into the graph's buffer. Gates: every reply held
    to the eager forwards of its row (reply_check), no shed or failure,
    compiles only in warm-up, no B1-B3 launch."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.profiler.metrics import reset_registry
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig
    from paddle_tpu_torch.vision.models import resnet50
    gc.collect()
    torch.cuda.empty_cache()
    model = resnet50(data_format="NHWC", stem="space_to_depth",
                     fused_conv_bn=True, device="cuda",
                     generator=pt.make_generator(seed + 3))
    images = np.random.RandomState(seed + 23).randn(
        SERVE_RESNET_REQUESTS, RESNET_HW, RESNET_HW, 3).astype("float32")
    with torch.no_grad():
        model.train()
        for _ in range(2):
            model(torch.from_numpy(images).cuda())
        model.eval()
    eager = eager_forwards(torch, model, images, SERVE_BATCH)
    icfg = infer.Config()
    icfg.set_layer(model)
    icfg.enable_low_precision(infer.DataType.BFLOAT16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_registry()
    launch_counts.clear()
    t0 = time.perf_counter()
    srv = InferenceServer(icfg, ServingConfig(
        max_batch_size=SERVE_BATCH, replicas=SERVE_REPLICAS,
        warmup_signatures=[(((RESNET_HW, RESNET_HW, 3), "float32"),)]))
    warmup_s = time.perf_counter() - t0
    warm = [r.compile_count for r in srv.scheduler.replicas]
    srv.start()
    reqs, lat, wall_s = serve_burst(torch, srv, images, SERVE_CLIENTS)
    stats = srv.stats()
    srv.stop()
    peak = torch.cuda.max_memory_allocated()
    compiles = [r.compile_count for r in srv.scheduler.replicas]
    flash = {k: launch_counts[k] for k in KERNEL_NAMES}
    pred = srv.scheduler.replicas[0].executor.predictor
    prog = pred._jit_cache[(((SERVE_BATCH, RESNET_HW, RESNET_HW, 3),
                             "float32"),)]
    per, _ = replay_profile(torch, prog.graph)
    per["predictor_run_ms"] = predictor_run_ms(pred, images[:SERVE_BATCH])
    replies, replies_ok = reply_check(reqs, eager)
    row = {"phase": "serving", "lane": "resnet_server",
           "config": "ResNet-50 NHWC s2d fused bf16, requests of one "
                     f"{RESNET_HW}x{RESNET_HW}x3 f32 image, buckets "
                     f"{srv.config.buckets}, {SERVE_REPLICAS} replicas, "
                     f"{SERVE_CLIENTS} clients",
           **server_summary(stats, lat, wall_s, SERVE_RESNET_REQUESTS),
           "warmup_s": warmup_s, "compiles_after_warmup": warm,
           "compiles_after_serving": compiles, "peak_mem_bytes": peak,
           "input_buffer_dtype": str(prog.graph.static_in[0].dtype),
           "bucket8_replay": per, "flash_launches": flash, **replies}
    emit(row)
    assert replies_ok, row
    assert stats["completed"] == SERVE_RESNET_REQUESTS \
        and not stats["shed"] and not stats["failed"], row
    assert compiles == warm and all(c <= len(srv.config.buckets)
                                    for c in warm), row
    assert row["input_buffer_dtype"] == "torch.bfloat16", row
    assert all(c == 0 for c in flash.values()), row
    assert not any(per["flash_variant_launches"].values()), row
    del srv, pred, prog, model
    gc.collect()
    torch.cuda.empty_cache()
    return row


# --- the training API slice: hapi.Model over io.DataLoader ------------------

def loss_log(pt, marks=(), on_mark=None):
    """A callback that records every step's loss and, at the end of the
    n-th step for each n in ``marks`` (counted over the whole fit), the
    host clock, then calls ``on_mark(n)``. Losses reach a callback after
    ``train_batch`` read them back, so a mark follows the step's work."""
    class LossLog(pt.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.t = [], {}

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))
            n = len(self.losses)
            if n in marks:
                self.t[n] = time.perf_counter()
                if on_mark is not None:
                    on_mark(n)
    return LossLog()


def rel_gaps(a, b):
    """The largest relative gap between two loss curves, step by step."""
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN held to its deterministic algorithms for the block: two runs
    of the same steps then give the same bits."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def hapi_lenet_model(pt, seed, device):
    """LeNet (weights from ``seed``, drawn on the host, so every device
    gets the same ones) under Model.prepare(Adam(1e-3),
    CrossEntropyLoss(), Accuracy())."""
    from paddle_tpu_torch.vision.models import LeNet
    net = LeNet(device=device, generator=pt.make_generator(seed))
    return pt.Model(net).prepare(
        pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters()),
        pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())


def phase_hapi_lenet(torch, seed):
    """The whole training API on LeNet: (a) one epoch of synthetic MNIST
    (4096 samples, Normalize) through ``fit`` from a DataLoader on the
    spawn pool (2 workers, shuffled), with ``eval_data`` and
    ModelCheckpoint; (b) the same weights and order with
    steps_per_execution=4, whose losses must equal (a)'s; (c)
    ``predict(stack_outputs=True)``, ``save`` and ``load`` into a fresh
    Model: parameters and optimizer state equal, ``evaluate`` equal; (d)
    8 steps card against host, the same weights and batches
    (shuffle=False), within VISION_TOL["loss"]. The synthetic MNIST test
    split draws other class means than the train split (ROADMAP C-ref-8),
    so the accuracy gate reads a held-in slice of the train split; the
    test split's accuracy is printed beside it. It runs under
    ``cudnn_deterministic``, so (a) and (b) can be compared step by
    step."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.transforms import Normalize
    t_lane = time.perf_counter()
    norm = Normalize(mean=[0.5], std=[0.5])
    train = MNIST(mode="train", transform=norm)
    held_in = pt.io.Subset(train, list(range(0, len(train), 4)))
    ckdir = tempfile.mkdtemp(prefix="hapi_lenet_")

    def loader():
        np.random.seed(seed)
        return pt.io.DataLoader(train, batch_size=HAPI_LENET_BATCH,
                                shuffle=True, num_workers=2,
                                use_multiprocess=True)
    try:
        # (a) one epoch through fit, the spawn pool and the callbacks
        m1 = hapi_lenet_model(pt, seed, "cuda")
        log1 = loss_log(pt)
        launch_counts.clear()
        t0 = time.perf_counter()
        m1.fit(loader(), eval_data=MNIST(mode="test", transform=norm),
               batch_size=HAPI_LENET_BATCH, epochs=1, verbose=0,
               callbacks=[log1, pt.callbacks.ModelCheckpoint(
                   save_dir=ckdir)])
        fit_s = time.perf_counter() - t0
        flash = {k: launch_counts[k] for k in KERNEL_NAMES}
        acc_held_in = m1.evaluate(held_in, batch_size=256, verbose=0)
        acc_test = m1.evaluate(MNIST(mode="test"), batch_size=256,
                               verbose=0)
        tags = sorted(f[:-len(".pdparams")] for f in os.listdir(ckdir)
                      if f.endswith(".pdparams"))
        # (b) the same weights and order, 4 steps a run_steps call
        m2 = hapi_lenet_model(pt, seed, "cuda")
        log2 = loss_log(pt)
        t0 = time.perf_counter()
        m2.fit(loader(), batch_size=HAPI_LENET_BATCH, epochs=1, verbose=0,
               callbacks=[log2], steps_per_execution=HAPI_LENET_SPE)
        spe_s = time.perf_counter() - t0
        # (c) predict, save, load into a fresh Model
        preds = m1.predict(held_in, batch_size=256, stack_outputs=True)
        path = os.path.join(ckdir, "saved", "lenet")
        m1.save(path)
        m3 = hapi_lenet_model(pt, seed + 1, "cuda")
        m3.load(path)
        params_equal = all(
            torch.equal(a, b) for a, b in zip(
                m1.network.state_dict().values(),
                m3.network.state_dict().values()))
        s1, s3 = m1._optimizer.state_dict(), m3._optimizer.state_dict()
        opt_equal = sorted(s1) == sorted(s3) and all(
            torch.equal(s1[k].reshape(-1), s3[k].reshape(-1).to(s1[k]))
            if isinstance(s1[k], torch.Tensor) else s1[k] == s3[k]
            for k in s1)
        eval_loaded = m3.evaluate(held_in, batch_size=256, verbose=0)
        # (d) card against host on the same weights and batches
        curves = {}
        for device in ("cuda", "cpu"):
            m = hapi_lenet_model(pt, seed, device)
            log = loss_log(pt)
            m.fit(train, batch_size=HAPI_LENET_BATCH, shuffle=False,
                  num_iters=HAPI_PARITY_STEPS, verbose=0, callbacks=[log])
            curves[device] = log.losses
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    row = {"phase": "hapi_lenet", "dtype": "float32",
           "optimizer": "Adam lr 1e-3", "batch": HAPI_LENET_BATCH,
           "steps": len(log1.losses), "loader": "DataLoader(MNIST train, "
           "shuffle, num_workers=2, use_multiprocess=True)",
           "fit_epoch_s": fit_s, "fit_epoch_spe4_s": spe_s,
           "loss_first": log1.losses[0], "loss_last": log1.losses[-1],
           "spe4_max_rel_gap": rel_gaps(log2.losses, log1.losses),
           "spe4_bitwise_equal": log2.losses == log1.losses,
           "acc_held_in": acc_held_in["acc"],
           "acc_test_split": acc_test["acc"], "acc_bar": HAPI_ACC_BAR,
           "checkpoint_tags": tags, "predict_shape": list(preds[0].shape),
           "loaded_params_equal": params_equal,
           "loaded_optimizer_equal": opt_equal,
           "eval_after_load": eval_loaded, "eval_before_save": acc_held_in,
           "card_vs_host_max_rel_gap": rel_gaps(curves["cuda"],
                                               curves["cpu"]),
           "card_vs_host_tol": VISION_TOL["loss"],
           "flash_launches": flash,
           "seconds": time.perf_counter() - t_lane}
    emit(row)
    assert len(log1.losses) == len(log2.losses) == len(train) // \
        HAPI_LENET_BATCH and all(np.isfinite(log1.losses)), row
    assert row["spe4_max_rel_gap"] <= 1e-6, row
    assert acc_held_in["acc"] > HAPI_ACC_BAR, row
    assert tags == ["0", "final"], row
    assert preds[0].shape == (len(held_in), 10) and \
        np.isfinite(preds[0]).all(), row
    assert params_equal and opt_equal and eval_loaded == acc_held_in, row
    assert row["card_vs_host_max_rel_gap"] <= VISION_TOL["loss"], row
    assert all(c == 0 for c in flash.values()), flash
    del m1, m2, m3
    gc.collect()
    torch.cuda.empty_cache()
    return row


def device_busy(prof):
    """The union of the device intervals of a profile's kernels and
    copies, in ms (what a busy share divides by the window)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
        and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def phase_hapi_resnet50(torch, seed):
    """The input pipeline at full size, PaddleClas's quick-start shape:
    ResNet-50 (102 classes) in f32 (TF32 as the script set it) trains
    through ``fit`` on Flowers (synthetic 3 x 96 x 96) behind
    ``Compose([RandomResizedCrop(224), RandomHorizontalFlip(),
    Normalize(...)])``, batch 64, 4 spawned workers, drop_last, Momentum
    (0.9) under CosineAnnealingDecay stepped by the LRScheduler callback.
    Two fits from the seed's weights in the seed's shuffled order (the
    spawned workers draw their own crops):

    (a) under ``cudnn_deterministic``, HAPI_HAND_STEPS steps, whose
        collated batches a collate_fn keeps; a hand-written captured loop
        (CompiledTrainStep), deterministic too, runs them from the same
        weights, its losses within HAPI_RESNET_RTOL of fit's: the
        comparison reads the API, not the order of atomic sums;
    (b) with cuDNN's default algorithms, as a PaddleClas run has them:
        4 warm-up steps, 4 timed on the host clock (images/s, the
        StepTimer's phases), then 2 under torch.profiler. Every step
        replays one graph, so the device ms a profiled step takes over
        the timed steps' ms is the card's busy share over the timed
        window (the profiler stays out of the timing). A hand captured
        step, with the defaults too, then replays the kept batches
        HAPI_HAND_TIMED times: chip_smoke's own captured step at this
        shape, so fit over hand is what the loader and fit cost.

    Gates: finite losses, (b)'s last 4 below its first 4 on average, one
    capture in warm-up and none timed, no flash kernel."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.io import default_collate_fn
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.profiler import steptimer
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.datasets import Flowers
    from paddle_tpu_torch.vision.models import resnet50
    from torch.profiler import ProfilerActivity, profile
    t_lane = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    timed_end = HAPI_RESNET_WARMUP + HAPI_RESNET_TIMED
    n_steps = timed_end + HAPI_RESNET_PROFILED
    tf = T.Compose([T.RandomResizedCrop(224), T.RandomHorizontalFlip(),
                    T.Normalize(mean=[0.485, 0.456, 0.406],
                                std=[0.229, 0.224, 0.225])])

    def build():
        net = resnet50(num_classes=102, device="cuda",
                       generator=pt.make_generator(seed))
        sched = pt.optimizer.lr.CosineAnnealingDecay(
            learning_rate=HAPI_RESNET_LR, T_max=n_steps)
        opt = pt.optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                    parameters=net.parameters())
        return net, opt, sched

    def run_fit(num_iters, log, collate=default_collate_fn):
        """``fit`` from the seed's weights in the seed's shuffled order;
        returns its seconds."""
        net, opt, _ = build()
        model = pt.Model(net).prepare(opt, pt.nn.CrossEntropyLoss())
        np.random.seed(seed)
        loader = pt.io.DataLoader(
            Flowers(mode="train", transform=tf),
            batch_size=HAPI_RESNET_BATCH, shuffle=True, drop_last=True,
            num_workers=HAPI_RESNET_WORKERS, use_multiprocess=True,
            collate_fn=collate)
        t0 = time.perf_counter()
        model.fit(loader, epochs=1, num_iters=num_iters, verbose=0,
                  callbacks=[log, pt.callbacks.LRScheduler()])
        fit_s = time.perf_counter() - t0
        del model, net, opt, loader
        gc.collect()
        torch.cuda.empty_cache()
        return fit_s

    def hand_loop(batches, timed):
        """The hand-written captured loop: each batch once (its loss),
        then ``timed`` replays over them (ms a step)."""
        net, opt, sched = build()
        loss_fn = pt.nn.CrossEntropyLoss()

        def hand_step(x, y):
            loss = loss_fn(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        step = CompiledTrainStep(hand_step, label="hapi_resnet50_hand")
        losses = []
        for x, y in batches:
            losses.append(step(x, y).item())
            sched.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(timed):
            step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / max(timed, 1) * 1e3
        del net, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return losses, ms

    # (a) fit against the hand loop, both deterministic
    kept = []

    def keep(samples):
        out = default_collate_fn(samples)
        if len(kept) < HAPI_HAND_STEPS:
            kept.append([t.clone() for t in out])
        return out
    det_log = loss_log(pt)
    with cudnn_deterministic(torch):
        run_fit(HAPI_HAND_STEPS, det_log, keep)
        batches = [(x.cuda(), y.cuda()) for x, y in kept]
        hand, _ = hand_loop(batches, 0)
    del kept

    # (b) the timed fit, with cuDNN's defaults
    window = {}
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])

    def on_mark(n):
        if n == HAPI_RESNET_WARMUP:
            window["warm"] = compile_stats()
            reset_compile_stats()
            steptimer.get_steptimer().reset()
        elif n == timed_end:
            window["timed"] = compile_stats()
            window["phases"] = steptimer.get_steptimer().breakdown()
            torch.cuda.synchronize()
            window["t_prof"] = time.perf_counter()
            prof.__enter__()
        elif n == n_steps:
            torch.cuda.synchronize()
            window["prof_s"] = time.perf_counter() - window["t_prof"]
            prof.__exit__(None, None, None)

    log = loss_log(pt, marks=(HAPI_RESNET_WARMUP, timed_end, n_steps),
                   on_mark=on_mark)
    steptimer.reset_steptimer()
    pt.profiler.metrics.reset_registry()
    reset_compile_stats()
    launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    deterministic = torch.backends.cudnn.deterministic
    fit_s = run_fit(n_steps, log)
    flash = {k: launch_counts[k] for k in KERNEL_NAMES}
    peak = torch.cuda.max_memory_allocated()
    timed_s = log.t[timed_end] - log.t[HAPI_RESNET_WARMUP]
    reg = pt.profiler.get_registry()
    io_ms = {name: {k: v for k, v in reg.histogram_summary(name).items()
                    if k in ("count", "p50", "p99", "max")}
             for name in ("io.worker_fetch_ms", "io.prefetch_stage_ms")}
    busy_ms = device_busy(prof)
    kernel_ms = sum(k[0] for k in kernel_times(prof)) / 1e3
    flash_profiled = {n: sum(c for _, c, name in kernel_times(prof)
                             if sym in name)
                      for n, sym in TC_KERNEL_NAMES.items()}
    del prof
    _, hand_ms = hand_loop(batches, HAPI_HAND_TIMED)
    del batches
    fit_ms = timed_s / HAPI_RESNET_TIMED * 1e3
    losses = log.losses
    phases = window["phases"]
    row = {"phase": "hapi_resnet50", "dtype": "float32",
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "cudnn_deterministic": {"compared_steps": True,
                                   "timed_steps": deterministic},
           "batch": [HAPI_RESNET_BATCH, 3, 224, 224],
           "loader": f"DataLoader(Flowers train + RandomResizedCrop(224), "
                     f"flip, Normalize; num_workers={HAPI_RESNET_WORKERS}, "
                     f"use_multiprocess=True, drop_last=True)",
           "host_cpu_count": os.cpu_count(),
           "optimizer": f"Momentum(0.9), CosineAnnealingDecay("
                        f"{HAPI_RESNET_LR}, T_max={n_steps}) by LRScheduler",
           "fit_s": fit_s, "fit_step_ms": fit_ms,
           "images_per_s": HAPI_RESNET_BATCH * HAPI_RESNET_TIMED / timed_s,
           "hand_captured_step_ms": hand_ms,
           "fit_over_hand": fit_ms / hand_ms,
           "steptimer_phase_ms_per_step": {
               k: v / HAPI_RESNET_TIMED
               for k, v in phases["phase_ms"].items()},
           "steptimer_synced_steps": phases["synced_steps"],
           "io_ms": io_ms,
           "device_ms_per_profiled_step": kernel_ms / HAPI_RESNET_PROFILED,
           "busy_share_timed": kernel_ms / HAPI_RESNET_PROFILED / (
               timed_s / HAPI_RESNET_TIMED * 1e3),
           "busy_share_profiled": busy_ms / (window["prof_s"] * 1e3),
           "profiled_steps": HAPI_RESNET_PROFILED,
           "compile_stats_warmup": window["warm"],
           "compile_stats_timed": window["timed"],
           "peak_mem_bytes": peak, "losses": losses,
           "deterministic_losses": det_log.losses,
           "hand_losses": hand,
           "hand_max_rel_gap": rel_gaps(det_log.losses, hand),
           "hand_rtol": HAPI_RESNET_RTOL,
           "first4_mean": float(np.mean(losses[:4])),
           "last4_mean": float(np.mean(losses[-4:])),
           "flash_launches": flash, "flash_launches_profiled": flash_profiled,
           "seconds": time.perf_counter() - t_lane}
    emit(row)
    assert len(losses) == n_steps and all(np.isfinite(losses)), row
    assert len(hand) == len(det_log.losses) == HAPI_HAND_STEPS and \
        all(np.isfinite(det_log.losses)), row
    assert row["hand_max_rel_gap"] <= HAPI_RESNET_RTOL, row
    assert row["last4_mean"] < row["first4_mean"], row
    assert window["warm"]["compiles"] == 1 and \
        window["timed"]["compiles"] == 0, row
    assert all(c == 0 for c in flash.values()) and \
        all(c == 0 for c in flash_profiled.values()), row
    return row


def phase_hapi_bert(torch, seed):
    """The TPU kernels through ``fit``: BERT-base (bf16, dropout 0, the
    weights bert_model draws from the seed) under
    AdamW(1e-4, multi_precision) and CrossEntropyLoss, a TensorDataset of
    24 x 8 rows of 512 tokens with no mask (cls_stream's ids and labels),
    batch 8, steps_per_execution=4: 2 warm-up executions, then 4 timed.
    Gates: every step's loss within HAPI_BERT_RTOL of a hand-written
    CompiledTrainStep loop (the same weights, batches and loss layer,
    one call a step); one capture in the warm-up and none timed; B1, B2
    and B3 through their wrappers in the run (discovery and capture),
    and 12 times each in a profiled replay of fit's own compiled step
    (two more steps through it, the first leading in), counted by kernel
    name."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.text.models import BertConfig
    t_lane = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    b, s = BERT_FLASH_SHAPE[:2]
    n = cfg.num_layers
    spe = HAPI_BERT_SPE
    warm_steps = HAPI_BERT_WARMUP_EXEC * spe
    n_steps = warm_steps + HAPI_BERT_TIMED_EXEC * spe
    (ids, labels), = cls_stream(seed + 9, 1, n_steps + spe, b, s,
                                cfg.vocab_size)
    ds = pt.io.TensorDataset([ids[:n_steps].reshape(-1, s),
                              labels[:n_steps].reshape(-1)])
    variants = [fa.variant_counter(k, dt) for k in fa.KERNEL_NAMES
                for dt in (torch.bfloat16, torch.float32)]

    def build():
        model = bert_model(torch, cfg, seed)
        model.bfloat16()
        model.train()
        opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                                 parameters=model.parameters())
        return model, opt

    model, opt = build()
    m = pt.Model(model).prepare(opt, pt.nn.CrossEntropyLoss())
    window = {}

    def on_mark(k):
        if k == warm_steps:
            window["warm"] = compile_stats()
            reset_compile_stats()

    log = loss_log(pt, marks=(warm_steps, n_steps), on_mark=on_mark)
    reset_compile_stats()
    launch_counts.clear()
    torch.cuda.reset_peak_memory_stats()
    m.fit(ds, batch_size=b, shuffle=False, drop_last=True, epochs=1,
          verbose=0, callbacks=[log], steps_per_execution=spe)
    timed = compile_stats()
    launches = {k: launch_counts[k] for k in variants}
    fit_s = log.t[n_steps] - log.t[warm_steps]
    peak = torch.cuda.max_memory_allocated()
    # two more steps through fit's own compiled step, profiled: replays of
    # the program run_steps replays (a step's signature). Late in a long
    # process a window's first records go missing (~26 kernels of a
    # ~8.1k-kernel replay, the first B1 among them, on every try), so the
    # first step leads in and only the second counts
    extra = [(torch.from_numpy(ids[n_steps + i]).cuda(),
              torch.from_numpy(labels[n_steps + i]).cuda()) for i in (0, 1)]
    trace, wall_s, _, prof = profiled(
        torch, lambda: m._compiled_train_step([extra[1][0]], [extra[1][1]]),
        1, expect={k: n for k in TC_KERNEL_NAMES},
        lead=lambda: m._compiled_train_step([extra[0][0]], [extra[0][1]]))
    replayed = compile_stats()["compiles"] == timed["compiles"]
    emit_profile(trace, wall_s, "hapi_bert_replay", 1, top=8,
                 after=prof["after_us"])
    del m, model, opt, trace
    gc.collect()
    torch.cuda.empty_cache()

    # the hand-written CompiledTrainStep loop, one call a step
    model, opt = build()
    loss_fn = pt.nn.CrossEntropyLoss()

    def hand_step(x, y):
        loss = loss_fn(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    step = CompiledTrainStep(hand_step, label="hapi_bert_hand")
    xs, ys = torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda()
    hand = [step(xs[i], ys[i]) for i in range(warm_steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hand += [step(xs[i], ys[i]) for i in range(warm_steps, n_steps)]
    torch.cuda.synchronize()
    hand_s = time.perf_counter() - t0
    hand = [x.item() for x in hand]
    del model, opt, step, xs, ys
    gc.collect()
    torch.cuda.empty_cache()
    timed_steps = n_steps - warm_steps
    fit_ms = fit_s / timed_steps * 1e3
    row = {"phase": "hapi_bert", "dtype": "bfloat16",
           "config": f"BERT-base v30522 h768 L12 a12 d64, batch {b} x {s}",
           "optimizer": "AdamW lr 1e-4 multi_precision",
           "steps_per_execution": spe, "steps": len(log.losses),
           "fit_step_ms": fit_ms,
           "tokens_per_s": b * s * timed_steps / fit_s,
           "hand_step_ms": hand_s / timed_steps * 1e3,
           "fit_over_hand": fit_s / hand_s,
           "bert_flash_step_ms_in_perf_md": 32.60,
           "compile_stats_warmup": window["warm"],
           "compile_stats_timed": timed,
           "wrapper_launches": launches,
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3},
           "peak_mem_bytes": peak, "losses": log.losses, "hand_losses": hand,
           "hand_max_rel_gap": rel_gaps(log.losses, hand),
           "hand_rtol": HAPI_BERT_RTOL,
           "seconds": time.perf_counter() - t_lane}
    emit(row)
    assert len(log.losses) == n_steps and all(np.isfinite(log.losses)), row
    assert row["hand_max_rel_gap"] <= HAPI_BERT_RTOL, row
    assert window["warm"]["compiles"] == 1 and timed["compiles"] == 0 \
        and timed["cache_hits"] == timed_steps, row
    # discovery and capture pass through the wrappers once each, all on
    # the tensor cores
    assert all(c == (2 * n if fa.TC in k else 0)
               for k, c in launches.items()), launches
    assert replayed and prof["graph_launches"] == 1, prof
    assert prof["flash_launches"] == {k: n for k in TC_KERNEL_NAMES}, prof
    per_step = {f"{k}.{fa.TC}": c for k, c in prof["flash_launches"].items()}
    per_step.update({k: c for k, c in launches.items() if fa.SIMT in k})
    return {**row, "launches_per_step": per_step}


# --- the script surface (PR 10): every optimizer, sparse grads, the tensor
# API, recompute with dropout under capture ------------------------------

FOREACH_KERNEL = "multi_tensor_apply"
# parameters whose first update is recomputed on the host (the optimizer
# rules are per parameter, so a subset checks the rule; the word table
# alone would make the host step slow)
HOST_CHECK_PREFIXES = ("bert.embeddings.layer_norm.", "bert.encoder.layers.0.",
                       "bert.encoder.layers.11.", "bert.pooler.",
                       "classifier.")
OPTIM_TIMED = 2
# the first update, card against host: f32 tensors by relative L2, bf16
# ones elementwise within one bf16 ulp of the operands (close_enough)
OPTIM_F32_RTOL = 1e-6
OPTIM_BF16_ULP = 2 ** -7
RECOMPUTE_GRAD_RTOL = 1e-5
SPARSE_SHAPE = (32000, 1024)
SPARSE_STEPS = 4
TENSOR_TOL = {"rtol": 1e-6, "atol": 1e-6}


def optim_runs(pt):
    """The optimizer runs of optim_bert: each class of the reference's
    __all__ (LarsMomentum is Lars), then two script-shaped variants:
    PaddleClas's Momentum + L2Decay(1e-4) and PaddleNLP's fine-tuning
    AdamW (no decay on biases and norms, a layer-wise lr_ratio)."""
    from paddle_tpu_torch.regularizer import L2Decay

    def no_bias_or_norm(name):
        return not any(k in name for k in ("bias", "norm"))

    def layerwise(p):
        m = re.search(r"encoder\.layers\.(\d+)\.", p.name)
        if m:
            return 0.8 ** (12 - int(m.group(1)))
        return 0.8 ** 13 if "embeddings" in p.name else 1.0
    mp = dict(multi_precision=True)
    return {
        "SGD": (pt.optimizer.SGD, dict(learning_rate=1e-3)),
        "Momentum": (pt.optimizer.Momentum,
                     dict(learning_rate=1e-3, momentum=0.9, **mp)),
        "Adam": (pt.optimizer.Adam, dict(learning_rate=1e-4, **mp)),
        "AdamW": (pt.optimizer.AdamW, dict(learning_rate=1e-4, **mp)),
        "Adagrad": (pt.optimizer.Adagrad, dict(learning_rate=1e-3)),
        "Adadelta": (pt.optimizer.Adadelta, dict(learning_rate=1.0)),
        "Adamax": (pt.optimizer.Adamax, dict(learning_rate=1e-4)),
        "RMSProp": (pt.optimizer.RMSProp, dict(learning_rate=1e-4,
                                               momentum=0.9, centered=True)),
        "Lamb": (pt.optimizer.Lamb, dict(learning_rate=1e-4)),
        "Lars": (pt.optimizer.Lars, dict(learning_rate=1e-3)),
        "LarsMomentum": (pt.optimizer.LarsMomentum,
                         dict(learning_rate=1e-3, momentum=0.8)),
        "Ftrl": (pt.optimizer.Ftrl, dict(learning_rate=1e-2, l1=1e-4,
                                         l2=1e-4)),
        "Momentum+L2Decay (PaddleClas)": (
            pt.optimizer.Momentum, dict(learning_rate=0.1, momentum=0.9,
                                        weight_decay=L2Decay(1e-4), **mp)),
        "AdamW fine-tune (PaddleNLP)": (
            pt.optimizer.AdamW, dict(learning_rate=5e-5, weight_decay=0.01,
                                     apply_decay_param_fun=no_bias_or_norm,
                                     lr_ratio=layerwise, **mp)),
    }


def range_kernels(prof, name):
    """The kernels launched under the host ranges called ``name``
    (record_function): [(name, device us)]."""
    out = []

    def walk(e):
        out.extend((k.name, k.duration) for k in e.kernels)
        for c in e.cpu_children:
            walk(c)
    for e in prof.events():
        if e.name == name and str(e.device_type).endswith("CPU"):
            walk(e)
    return out


def foreach_kernels(prof, after=None):
    """Device ms and launches of a profile's multi-tensor kernels (the
    torch._foreach_* passes: the optimizer's, in a replayed step)."""
    ks = [k for k in kernel_times(prof, after) if FOREACH_KERNEL in k[2]]
    return {"ms": sum(k[0] for k in ks) / 1e3,
            "launches": sum(k[1] for k in ks)}


def optimizer_profile(torch, opt, replay_device_ms):
    """The optimizer's own kernels: one eager step on zero grads under a
    record_function range, after a lead-in step in the same profile (a
    profile loses its first records), run after the lane's gates: device
    ms, launches, how many are multi-tensor passes, its share of a
    replayed step's device time, and its largest kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function
    params = [p for p in opt._parameter_list if p.requires_grad]

    def zero_grads():
        for p in params:
            p.grad = torch.zeros_like(p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        zero_grads()
        opt.step()
        zero_grads()
        torch.cuda.synchronize()
        with record_function("optimizer.step"):
            opt.step()
        torch.cuda.synchronize()
    opt.clear_grad()
    ks = range_kernels(prof, "optimizer.step")
    by_name = {}
    for name, us in ks:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, n + 1)
    ms = sum(us for _, us in ks) / 1e3
    return {"device_ms": ms, "kernel_launches": len(ks),
            "foreach_launches": sum(1 for n, _ in ks if FOREACH_KERNEL in n),
            "share_of_replay_device_ms": ms / replay_device_ms,
            "parameters": len(params),
            "top": [{"kernel": n[:90], "ms": t / 1e3, "count": c}
                    for n, (t, c) in sorted(by_name.items(),
                                            key=lambda kv: -kv[1][0])[:5]]}


def close_enough(torch, got, want, before=None):
    """(ok, gap, gap as a share of its tolerance) of the first update's
    tensors, card against host: relative L2 for f32; for bf16 the largest
    elementwise difference in bf16 ulps of the operands (2^-7 of the
    larger of the two results and the value before the update: where
    p - u cancels, one ulp of u is many ulps of the small result)."""
    if want.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        scale = torch.maximum(g.abs(), w.abs())
        if before is not None:
            scale = torch.maximum(scale, before.float().abs())
        gap = ((g - w).abs() / (OPTIM_BF16_ULP * scale.clamp_min(1e-30))) \
            .max().item()
        return gap <= 1.0, gap, gap
    gap = rel_l2(got.reshape(-1), want.reshape(-1))
    return gap <= OPTIM_F32_RTOL, gap, gap / OPTIM_F32_RTOL


def record_first_update(torch, opt, picked):
    """Wrap ``opt.step`` so that its first call saves, on the host, the
    picked parameters and grads before and the parameters and
    accumulators after; later calls are the optimizer's own."""
    rec = {}
    real = opt.step

    def step():
        del opt.step                       # the class's own from now on
        def host(t):
            return t.detach().to("cpu", copy=True)
        rec["before"] = {n: host(p) for n, p in picked}
        rec["grads"] = {n: host(p.grad) for n, p in picked}
        real()
        rec["after"] = {n: host(p) for n, p in picked}
        names = {n for n, _ in picked}
        rec["state"] = {k: host(v)
                        for k, v in opt.state_dict().items()
                        if isinstance(v, torch.Tensor)
                        and k.rsplit("__", 1)[0] in names}
    opt.step = step
    return rec


def host_first_update(torch, pt, cls, kw, rec):
    """The same optimizer's first update on the host from the card's
    parameters and grads: [(tensor name, ok, gap)], worst first."""
    params = []
    for n, v in rec["before"].items():
        p = pt.Parameter(v.clone())
        p.name = n
        p.grad = rec["grads"][n].clone()
        params.append(p)
    opt = cls(parameters=params, **kw)
    opt.step()
    gaps = [(n, *close_enough(torch, rec["after"][n], p.detach(),
                              rec["before"][n]))
            for n, p in zip(rec["before"], params)]
    host_state = opt.state_dict()
    assert sorted(host_state) == sorted(rec["state"]), (
        sorted(host_state)[:4], sorted(rec["state"])[:4])
    gaps += [(k, *close_enough(torch, rec["state"][k], v.detach()))
             for k, v in host_state.items()]
    return sorted(gaps, key=lambda g: -g[3])


def phase_optim_bert(torch, seed):
    """optim_bert: bert_flash's cell (BERT-base bf16, 8 x 512, dropout 0,
    no mask: B1, B2 and B3 non-causal, 12 of each a step) under each
    optimizer run of ``optim_runs``, from the same weights: the step
    captured through CompiledTrainStep, the discovery pass and the
    capture (warm-up), 3 timed replays, a profiled replay after a lead-in
    one. Gates per run: the first update (the discovery pass's, eager on
    the card) equals the same optimizer's on the host from the card's
    parameters and grads (HOST_CHECK_PREFIXES), f32 relative L2 1e-6 and
    bf16 one ulp; finite losses; no compile timed; B1/B2/B3 12 each per
    replay. Prints step ms, device ms and kernels a replay, the
    multi-tensor kernels in the replay and the optimizer's own kernels
    in an eager step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    b, s = BERT_FLASH_SHAPE[:2]
    n = cfg.num_layers
    calls = 2 + OPTIM_TIMED + 2
    (xs, ys), = cls_stream(seed + 5, 1, calls, b, s, cfg.vocab_size)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    gc.collect()
    torch.cuda.empty_cache()
    model = bert_model(torch, cfg, seed)
    model.bfloat16()
    model.train()
    for name, p in model.named_parameters():
        p.name = name
    init = {k: v.clone() for k, v in model.state_dict().items()}
    picked = [(name, p) for name, p in model.named_parameters()
              if name.startswith(HOST_CHECK_PREFIXES)]
    assert pt.optimizer.LarsMomentum is pt.optimizer.Lars
    rows, per_replay = [], []
    t_phase = time.perf_counter()
    for label, (cls, kw) in optim_runs(pt).items():
        model.load_state_dict(init)
        opt = cls(parameters=model.parameters(), **kw)
        rec = record_first_update(torch, opt, picked)
        step = CompiledTrainStep(train_step_fn(model, opt),
                                 label=f"optim_{cls.__name__}")
        reset_compile_stats()
        losses = [step(xs[i], ys[i]) for i in range(2)]
        torch.cuda.synchronize()
        warm = compile_stats()
        reset_compile_stats()
        t0 = time.perf_counter()
        for i in range(2, 2 + OPTIM_TIMED):
            losses.append(step(xs[i], ys[i]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        timed = compile_stats()
        i = 2 + OPTIM_TIMED
        trace, wall_s, _, prof = profiled(
            torch, lambda: step(xs[i + 1], ys[i + 1]), 1,
            expect={k: n for k in TC_KERNEL_NAMES},
            lead=lambda: step(xs[i], ys[i]))
        foreach = foreach_kernels(trace, prof["after_us"])
        eager_opt = optimizer_profile(torch, opt, prof["device_ms"])
        gaps = host_first_update(torch, pt, cls, kw, rec)
        losses = [loss.item() for loss in losses]
        row = {"phase": "optim_bert", "optimizer": label,
               "class": cls.__name__,
               "config": "BERT-base v30522 h768 L12 a12 d64 bf16, batch "
                         f"{b} x {s}, B1-B3 non-causal",
               "step_ms": seconds / OPTIM_TIMED * 1e3,
               "tokens_per_s": b * s * OPTIM_TIMED / seconds,
               "compile_stats_warmup": warm, "compile_stats_timed": timed,
               "replay_device_ms": prof["device_ms"],
               "replay_kernel_launches": prof["kernel_launches"],
               "replay_graph_launches": prof["graph_launches"],
               "flash_launches_per_replay": prof["flash_launches"],
               "replay_foreach_kernels": foreach,
               "optimizer_eager_step": eager_opt,
               "first_update_host_check": {
                   "tensors": len(gaps), "worst": gaps[:3],
                   "f32_rel_l2_tol": OPTIM_F32_RTOL,
                   "bf16_ulp_tol": OPTIM_BF16_ULP},
               "losses": losses}
        emit(row)
        assert all(g[1] for g in gaps), (label, gaps[:5])
        assert all(np.isfinite(losses)), (label, losses)
        assert timed == {"compiles": 0, "cache_hits": OPTIM_TIMED,
                         "retrace_warnings": 0}, (label, timed)
        assert prof["flash_launches"] == {k: n for k in TC_KERNEL_NAMES}, \
            (label, prof["flash_launches"])
        rows.append(row)
        per_replay.append(prof["flash_launches"])
        del step, opt, rec
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "optim_bert", "part": "summary",
          "seconds": time.perf_counter() - t_phase,
          "step_ms": {r["optimizer"]: r["step_ms"] for r in rows},
          "optimizer_eager_device_ms": {
              r["optimizer"]: r["optimizer_eager_step"]["device_ms"]
              for r in rows}})
    del model, init
    gc.collect()
    torch.cuda.empty_cache()
    return {f"{k}.{fa.TC}": min(c[k] for c in per_replay)
            for k in TC_KERNEL_NAMES}


def phase_optim_sparse(torch, seed):
    """optim_sparse: GPT-medium's word embedding (32000 x 1024, f32) with
    sparse=True, trained eagerly for 4 steps on 4 x 1024-token batches of
    bench's stream, loss the mean square of the looked-up rows; with SGD
    against the same table and batches with sparse=False, and with
    Adam(lazy_mode=True) against the same run on the host. Gates: each
    gradient is sparse with one row per token; rows (and Adam's moments)
    that no id touched stay bitwise; SGD's sparse table equals its dense
    one within 1e-6; lazy Adam's table and moments equal the host's
    within 1e-6. Prints the sparse and dense step ms and the gradient's
    bytes against the dense table's."""
    import paddle_tpu_torch as pt
    vocab, dim = SPARSE_SHAPE
    xs, _ = bench_stream(seed, SPARSE_STEPS, 4, 1024, sub=vocab)
    touched = np.zeros(vocab, bool)
    touched[np.unique(xs)] = True

    def run(opt_name, sparse, device, **kw):
        emb = pt.nn.Embedding(vocab, dim, sparse=sparse, device=device,
                              generator=pt.make_generator(seed))
        w0 = emb.weight.detach().clone()
        opt = getattr(pt.optimizer, opt_name)(parameters=emb.parameters(),
                                              **kw)
        times, nnz, grad_bytes = [], [], 0
        for x in xs:
            ids = torch.from_numpy(x).to(device)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = (emb(ids) ** 2).mean()
            loss.backward()
            g = emb.weight.grad
            if sparse:
                assert g.is_sparse, "the embedding's gradient is dense"
                nnz.append(int(g._values().shape[0]))
                grad_bytes = g._values().nbytes + g._indices().nbytes
            else:
                grad_bytes = g.nbytes
            opt.step()
            opt.clear_grad()
            if device == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return emb.weight.detach(), w0, opt, times, nnz, grad_bytes
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    sgd_s, w0, _, sgd_s_ms, nnz, sparse_bytes = run("SGD", True, "cuda",
                                                    learning_rate=0.5)
    sgd_d, _, _, sgd_d_ms, _, dense_bytes = run("SGD", False, "cuda",
                                                learning_rate=0.5)
    untouched = torch.from_numpy(~touched).cuda()
    out["sgd"] = {"sparse_step_ms": sgd_s_ms, "dense_step_ms": sgd_d_ms,
                  "nnz_rows": nnz, "tokens_per_batch": xs[0].size,
                  "sparse_vs_dense_max_abs": (sgd_s - sgd_d).abs().max()
                  .item(),
                  "untouched_rows_bitwise": bool(torch.equal(
                      sgd_s[untouched], w0[untouched]))}
    adam_kw = dict(learning_rate=1e-3, lazy_mode=True)
    ad, w0, opt, ad_ms, nnz_a, _ = run("Adam", True, "cuda", **adam_kw)
    m = opt._accumulators["moment1"][id(opt._parameter_list[0])]
    host, _, hopt, _, _, _ = run("Adam", True, "cpu", **adam_kw)
    hm = hopt._accumulators["moment1"][id(hopt._parameter_list[0])]
    out["adam_lazy"] = {
        "step_ms": ad_ms, "nnz_rows": nnz_a,
        "card_vs_host_rel_l2": rel_l2(ad.cpu(), host),
        "moment1_card_vs_host_rel_l2": rel_l2(m.cpu(), hm),
        "untouched_rows_bitwise": bool(torch.equal(ad[untouched],
                                                   w0[untouched])),
        "untouched_moments_zero": bool((m[untouched] == 0).all())}
    row = {"phase": "optim_sparse", "table": list(SPARSE_SHAPE),
           "dtype": "float32", "steps": SPARSE_STEPS, "batch": [4, 1024],
           "touched_rows": int(touched.sum()),
           "grad_bytes_sparse": sparse_bytes, "grad_bytes_dense": dense_bytes,
           "grad_bytes_ratio": sparse_bytes / dense_bytes, **out}
    emit(row)
    assert all(c == xs[0].size for c in nnz + nnz_a), (nnz, nnz_a)
    assert out["sgd"]["untouched_rows_bitwise"], out["sgd"]
    assert out["sgd"]["sparse_vs_dense_max_abs"] <= 1e-6, out["sgd"]
    a = out["adam_lazy"]
    assert a["untouched_rows_bitwise"] and a["untouched_moments_zero"], a
    assert a["card_vs_host_rel_l2"] <= 1e-6, a
    assert a["moment1_card_vs_host_rel_l2"] <= 1e-6, a
    return row


def cases_on_card(torch, module, phase):
    """Every case of tests/<module>.py (a host parity file's cases)
    through the port on the card, held against the same case through the
    port on the host: floats within TENSOR_TOL (or the case's own host
    tolerance where larger), integers and bools exactly, random draws by
    shape, dtype and what their distribution guarantees. Emits the row;
    fails on any case."""
    import importlib

    import paddle_tpu_torch as pt
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    cases = importlib.import_module(module).CASES

    def numpy(out):
        if isinstance(out, (list, tuple)):
            return [numpy(o) for o in out]
        if isinstance(out, torch.Tensor):
            t = out.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return np.asarray(out)

    def run(c, device):
        pt.set_device(device)
        pt.seed(0)
        out = numpy(c.fn(pt, *[pt.to_tensor(a) for a in c.arrays]))
        return c.post(c.arrays, out) if c.post is not None else out

    def same(a, b, tol):
        if isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(same(x, y, tol)
                                            for x, y in zip(a, b))
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype.kind in "fc":
            return bool(np.allclose(a, b, equal_nan=True, **tol))
        return bool(np.array_equal(a, b))
    def gap(a, b):
        # the largest float gap of a failed case (shape or dtype apart: inf)
        if isinstance(b, (list, tuple)):
            return max([gap(x, y) for x, y in zip(a, b)] or [0.0])
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if a.dtype.kind in "fc":
            return float(np.nanmax(np.abs(a - b), initial=0.0))
        return float(not np.array_equal(a, b))
    t0 = time.perf_counter()
    failed, gaps, functions = [], {}, set()
    before = pt.get_device()
    try:
        for c in cases:
            tol = {k: max(v, c.tol.get(k, 0.0)) for k, v in TENSOR_TOL.items()}
            card, host = run(c, "gpu"), run(c, "cpu")
            if not same(card, host, tol):
                failed.append(c.id)
                gaps[c.id] = gap(card, host)
            functions.add(c.function)
    finally:
        pt.set_device(before)
    row = {"phase": phase, "cases": len(cases),
           "functions": len(functions), "failed": failed,
           "failed_max_abs_gap": gaps,
           "tolerance": TENSOR_TOL, "seconds": time.perf_counter() - t0}
    emit(row)
    assert not failed, failed
    return row


def phase_tensor_api(torch):
    """tensor_api: every case of tests/test_torch_tensor_cases.py on the
    card against the host (cases_on_card; a decomposition or solve within
    its own host tolerance, 1e-4 / 1e-5)."""
    return cases_on_card(torch, "test_torch_tensor_cases", "tensor_api")


def phase_recompute_dropout(torch, seed):
    """recompute_dropout: BERT-base f32 at 4 x 256 with hidden and
    attention dropout 0.1 drawn from one CUDA generator, every encoder
    layer under fleet.utils.recompute, the forward-and-backward step
    captured through to_static; against the same step without recompute
    from the same generator state. Gates: the first replay's loss and
    grads equal the plain step's (grads within relative L2 1e-5); so do
    the second replay's, on the same batch, whose loss differs from the
    first's (new masks); no compile in the replays after the capture."""
    import functools
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.1
    (xs, ys), = cls_stream(seed + 9, 1, 1, 4, 256, cfg.vocab_size)
    x, y = torch.from_numpy(xs[0]).cuda(), torch.from_numpy(ys[0]).cuda()
    runs = {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        model = bert_model(torch, cfg, seed).train()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for m in model.modules():
            if hasattr(m, "_generator"):
                m._generator = gen
        if remat:
            for layer in model.bert.encoder.layers:
                layer.forward = functools.partial(recompute, layer.forward)
        params = [p for p in model.parameters() if p.requires_grad]

        @pt.jit.to_static
        def step_fn(x, y):
            for p in params:
                if p.grad is not None:
                    p.grad.zero_()
            loss = model(x, labels=y)
            loss.backward()
            return loss.float()
        step = CompiledTrainStep(step_fn, label=f"recompute_{remat}")
        step(x, y)                                   # discovery
        reset_compile_stats()
        first = step(x, y).item()                    # capture + replay 1
        grads1 = {n: p.grad.detach().clone()
                  for n, p in model.named_parameters()}
        warm = compile_stats()
        reset_compile_stats()
        second = step(x, y).item()                   # replay 2
        grads2 = {n: p.grad.detach().clone()
                  for n, p in model.named_parameters()}
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
        runs[remat] = {"losses": [first, second], "grads": [grads1, grads2],
                       "compile_stats_capture": warm,
                       "compile_stats_replays": compile_stats()}
        del model, step, step_fn, params
    plain, remat = runs[False], runs[True]
    gaps = [max(rel_l2(remat["grads"][k][n], g) for n, g in
                plain["grads"][k].items()) for k in (0, 1)]
    row = {"phase": "recompute_dropout",
           "config": "BERT-base f32 v30522 h768 L12 a12, 4 x 256, hidden "
                     "and attention dropout 0.1, recompute on every "
                     "encoder layer, captured",
           "losses_recompute": remat["losses"],
           "losses_plain": plain["losses"],
           "grad_rel_l2_worst_replay1": gaps[0],
           "grad_rel_l2_worst_replay2": gaps[1],
           "grad_rtol": RECOMPUTE_GRAD_RTOL,
           "compile_stats_replays": remat["compile_stats_replays"]}
    emit(row)
    assert remat["compile_stats_replays"]["compiles"] == 0, row
    assert remat["losses"][0] != remat["losses"][1], row
    assert max(gaps) <= RECOMPUTE_GRAD_RTOL, row
    for k in (0, 1):
        assert abs(remat["losses"][k] - plain["losses"][k]) \
            <= 1e-5 * abs(plain["losses"][k]), row
    return row


# --- the common surface: the nn cases on the card, MobileNetV2 at
# full width, the three mobile nets card against host, the degenerate-
# weight guard after a load ---------------------------------------------

# MobileNetV2 (scale 1.0, 1000 classes) in bf16, NHWC, batch 128 at 224 x
# 224 of bench's prototype stream (as resnet_train), run_steps K = 32: 2
# warm-up + 4 timed executions over 3 staged stacks (192 recorded steps;
# 8 timed, 320 steps, until the pipeline group needed the script's time);
# Momentum(0.9) with L2Decay(4e-5) under CosineAnnealingDecay from 0.045
# (the MobileNetV2 paper's rate and decay, as PaddleClas's ImageNet recipe
# takes them). The cosine spans a whole training, MOBILE_T_MAX steps (240
# epochs of ImageNet-1k's 1,281,167 images at batch 128), of which the
# lane runs the first 192: the scheduler advances 32 steps after each
# execution, and the rate stays 0.045 within 1e-5 relative
MOBILE_BATCH, MOBILE_HW, MOBILE_SPE, MOBILE_STACKS = 128, 224, 32, 3
MOBILE_WARMUP_EXEC, MOBILE_TIMED_EXEC, MOBILE_WINDOW = 2, 2, 32
MOBILE_LR, MOBILE_MOMENTUM, MOBILE_DECAY = 0.045, 0.9, 4e-5
MOBILE_T_MAX = 240 * (1281167 // 128)
MOBILE_FIT_SPE = 4
# mobile_nets_small: f32 at 2 x 64 x 64 (the reference test's size), card
# against host. The deep BatchNorms normalise over 8 to 32 values a
# channel, and a BN bias that feeds a conv and another BN has an exact
# gradient of 0, so a flat relative bound on every grad cannot hold in
# f32 (tests/test_torch_mobile_nets.py): each grad is held to
# VISION_TOL["grad"] + MOBILE_NOISE_FACTOR x the host's own f32 noise on
# it (its f32 grad against the same step in f64)
MOBILE_SMALL = (("mobilenet_v1", {"scale": 0.25}),
                ("mobilenet_v2", {"scale": 0.25}),
                ("shufflenet_v2_x0_25", {}))
MOBILE_NOISE_FACTOR = 4.0
# state_guard: a LayerNorm weight of width 768 (BERT-base's) whose
# channel GUARD_CHANNEL is zeroed after the captured step is warm; dw
# against plain autograd within GUARD_TOL
GUARD_WIDTH, GUARD_CHANNEL, GUARD_TOL = 768, 3, 1e-5


def phase_nn_cases(torch):
    """nn_cases: every case of tests/test_torch_nn_cases.py (activations,
    common functions, initializers and layers) on the card against the
    host (cases_on_card; interpolate and fold within their host
    tolerance, 1e-5)."""
    return cases_on_card(torch, "test_torch_nn_cases", "nn_cases")


def _f32_logits(pt, net):
    """``net`` behind a layer that returns its logits in f32 (the loss of
    a bf16 network is taken in f32, as the captured step does)."""
    class F32Logits(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x).float()
    return F32Logits()


def phase_mobilenet_train(torch, seed):
    """The slice's full-width path: MobileNetV2 (scale 1.0, 1000 classes)
    built on the host with KaimingNormal through set_global_initializer
    (from --seed), saved as .pdparams, loaded into the card's model with
    set_state_dict(paddle.load(path)), cast to bf16, NHWC (channels-
    last); Momentum(0.9) + L2Decay(4e-5) under CosineAnnealingDecay from
    0.045 (the schedule of a whole training, of which the lane runs the
    start); batch 128 at 224 x 224 of bench's prototype stream (made on
    the card); the step captured and driven by run_steps K = 32 (2
    warm-up and 4 timed executions over 3 staged stacks). Gates: the load reports no
    missing or unexpected key and gives the host's values, every loss
    finite, the last-32 mean below the first-32 mean, 1 compile in the
    warm-up and none timed, no flash kernel launched. Reported: step ms,
    images/s, peak memory, a replay's device time by kernel class,
    launches and busy share, whether the last-32 mean clears bench's
    chance floor (information, not a gate). Then one epoch of the same
    stream (96 batches) through Model.fit with steps_per_execution=4: its
    step time over the captured step's (2 warm-up executions untimed).
    Returns (the row, the trained model)."""
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.vision.models import mobilenet_v2
    init = pt.nn.initializer
    t_lane = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    init.set_global_initializer(init.KaimingNormal(), init.Constant(0.0))
    try:
        host = mobilenet_v2(scale=1.0, num_classes=1000, device="cpu",
                            generator=pt.make_generator(seed))
    finally:
        init.set_global_initializer(None, None)
    torch.cuda.reset_peak_memory_stats()
    model = mobilenet_v2(scale=1.0, num_classes=1000, data_format="NHWC",
                         device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mobilenet_v2.pdparams")
        pt.save(host.state_dict(), path)
        load_t0 = time.perf_counter()
        keys = model.set_state_dict(pt.load(path))
        load_s = time.perf_counter() - load_t0
        size = os.path.getsize(path)
    loaded = all(torch.equal(model.state_dict()[k].cpu(), v)
                 for k, v in host.state_dict().items())
    n_bn = sum(isinstance(m, pt.nn.BatchNorm2D) for m in model.modules())
    n_params = sum(p.numel() for p in model.parameters())
    del host
    model.bfloat16()
    model.train()
    total_exec = MOBILE_WARMUP_EXEC + MOBILE_TIMED_EXEC
    sched = pt.optimizer.lr.CosineAnnealingDecay(learning_rate=MOBILE_LR,
                                                 T_max=MOBILE_T_MAX)
    opt = pt.optimizer.Momentum(
        learning_rate=sched, momentum=MOBILE_MOMENTUM,
        parameters=model.parameters(),
        weight_decay=pt.regularizer.L2Decay(MOBILE_DECAY))
    t0 = time.perf_counter()
    stacks = image_stream(torch, seed, MOBILE_STACKS, MOBILE_SPE,
                          MOBILE_BATCH, (MOBILE_HW, MOBILE_HW, 3), 1000,
                          RESNET_PROTO_SCALE, 1.0, torch.bfloat16)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    lrs = []
    watch = ("features.0.1._mean", "features.18.1._variance")
    losses, seconds, warm, timed, flash, (before, after), step = train_lane(
        torch, "mobilenet_v2", model, opt, stacks, MOBILE_WARMUP_EXEC,
        MOBILE_TIMED_EXEC, watch,
        after_exec=lambda: (lrs.append(opt.get_lr()),
                            sched.step(sched.last_epoch + MOBILE_SPE)))
    peak = torch.cuda.max_memory_allocated()
    timed_steps = MOBILE_TIMED_EXEC * MOBILE_SPE
    step_ms = seconds / timed_steps * 1e3
    x, y = stacks[-1][0][-1], stacks[-1][1][-1]
    trace, wall_s, _, prof = profiled(torch, lambda: step(x, y), 1)
    by_class = kernel_classes(trace)
    emit_profile(trace, wall_s, "mobilenet_v2_train_replay", 1, top=15,
                 by_class=by_class)
    first = float(np.mean(losses[:MOBILE_WINDOW]))
    last = float(np.mean(losses[-MOBILE_WINDOW:]))
    moved = {n: (after[n] - before[n]).abs().max().item() for n in watch}
    row = {"phase": "mobilenet_train", "dtype": "bfloat16",
           "config": "MobileNetV2 scale 1.0, 1000 classes, NHWC "
                     "(channels-last), KaimingNormal via "
                     "set_global_initializer",
           "parameters": n_params, "batch_norms": n_bn,
           "pdparams_bytes": size, "set_state_dict_s": load_s,
           "set_state_dict_keys": keys, "loaded_equals_host": loaded,
           "optimizer": f"Momentum {MOBILE_MOMENTUM} + L2Decay "
                        f"{MOBILE_DECAY}, CosineAnnealingDecay from "
                        f"{MOBILE_LR}, T_max {MOBILE_T_MAX} steps",
           "lr_per_execution": lrs,
           "batch": [MOBILE_BATCH, MOBILE_HW, MOBILE_HW, 3],
           "steps_per_execution": MOBILE_SPE, "executions": total_exec,
           "recorded_steps": len(losses), "timed_steps": timed_steps,
           "data": "prototype stream made on the card", "data_s": data_s,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "step_ms": step_ms,
           "images_per_s": MOBILE_BATCH * timed_steps / seconds,
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": prof["device_ms"]
                              / (wall_s * 1e3)},
           "device_ms_by_class": {k: v for k, v in by_class.items()
                                  if k != "copy_kernels"},
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "peak_mem_bytes": peak, "flash_launches": flash,
           "running_stats_moved": moved, "loss_first": losses[0],
           "loss_every_16th": losses[::16],
           f"first{MOBILE_WINDOW}_mean": first,
           f"last{MOBILE_WINDOW}_mean": last,
           "chance_floor": RESNET_FLOOR,
           "clears_chance_floor": last < RESNET_FLOOR}
    emit(row)
    assert keys == ([], []) and loaded, row
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": timed_steps, "retrace_warnings": 0}, \
        (warm, timed)
    assert all(np.isfinite(losses)) and last < first, row
    assert all(v > 0 for v in moved.values()), moved
    assert all(c == 0 for c in flash.values()), flash
    del step, opt, trace
    gc.collect()
    torch.cuda.empty_cache()

    # one epoch of the same stream through Model.fit
    xs = torch.cat([s[0].reshape(-1, MOBILE_HW, MOBILE_HW, 3)
                    for s in stacks])
    ys = torch.cat([s[1].reshape(-1) for s in stacks])
    del stacks
    ds = pt.io.TensorDataset([xs, ys])
    n_steps = MOBILE_STACKS * MOBILE_SPE
    warm_steps = 2 * MOBILE_FIT_SPE
    window = {}

    def on_mark(k):
        if k == warm_steps:
            window["warm"] = compile_stats()
            reset_compile_stats()

    fit_opt = pt.optimizer.Momentum(
        learning_rate=MOBILE_LR, momentum=MOBILE_MOMENTUM,
        parameters=model.parameters(),
        weight_decay=pt.regularizer.L2Decay(MOBILE_DECAY))
    m = pt.Model(_f32_logits(pt, model)).prepare(fit_opt,
                                                  pt.nn.CrossEntropyLoss())
    log = loss_log(pt, marks=(warm_steps, n_steps), on_mark=on_mark)
    reset_compile_stats()
    m.fit(ds, batch_size=MOBILE_BATCH, shuffle=False, drop_last=True,
          epochs=1, verbose=0, callbacks=[log],
          steps_per_execution=MOBILE_FIT_SPE)
    fit_timed = compile_stats()
    fit_ms = (log.t[n_steps] - log.t[warm_steps]) \
        / (n_steps - warm_steps) * 1e3
    fit_row = {"phase": "mobilenet_train", "part": "fit",
               "steps": len(log.losses),
               "steps_per_execution": MOBILE_FIT_SPE,
               "fit_step_ms": fit_ms, "captured_step_ms": step_ms,
               "fit_over_captured": fit_ms / step_ms,
               "compile_stats_warmup": window["warm"],
               "compile_stats_timed": fit_timed,
               "loss_first": log.losses[0], "loss_last": log.losses[-1],
               "seconds": time.perf_counter() - t_lane}
    emit(fit_row)
    assert len(log.losses) == n_steps and all(np.isfinite(log.losses)), \
        fit_row
    assert fit_timed["compiles"] == 0, fit_row
    row.update(fit=fit_row, seconds=fit_row["seconds"])
    del m, fit_opt, ds, xs, ys
    gc.collect()
    torch.cuda.empty_cache()
    return row, model


def small_step(torch, pt, model, x, y):
    """One Momentum(0.05, 0.9) + L2Decay(4e-5) step of ``model``: the loss,
    every grad, then the eval logits of the updated weights."""
    opt = pt.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, parameters=model.parameters(),
        weight_decay=pt.regularizer.L2Decay(4e-5))
    model.train()
    loss, grads, _ = step_state(torch, model, opt, x, y)
    model.eval()
    with torch.no_grad():
        logits = model(x)
    return loss, grads, logits


def phase_mobile_nets_small(torch, seed):
    """MobileNetV1 (scale 0.25), MobileNetV2 (scale 0.25, classifier
    dropout 0) and ShuffleNetV2 x0.25, 10 classes, at 2 x 3 x 64 x 64 in
    f32 (TF32 off), the same weights on the card and the host: one
    Momentum + L2Decay step's loss (within VISION_TOL["loss"]), every grad
    (within VISION_TOL["grad"] + MOBILE_NOISE_FACTOR x the host's f32
    noise on it, from the host's f64 step) and the eval logits after the
    step (VISION_TOL["logits"])."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import vision
    rng = np.random.RandomState(seed + 13)
    x = rng.randn(2, 3, 64, 64).astype("float32")
    y = rng.randint(0, 10, (2,))
    rows = []
    for name, kw in MOBILE_SMALL:
        def make(device, gen, name=name, kw=kw):
            return getattr(vision.models, name)(num_classes=10, device=device,
                                                generator=gen, **kw)
        card, host = vision_pair(torch, make, seed)
        exact = copy.deepcopy(host).to(dtype=torch.float64)
        for m in (card, host, exact):
            if name == "mobilenet_v2":
                m.classifier[0].p = 0.0
        got = small_step(torch, pt, card, torch.tensor(x, device="cuda"),
                         torch.tensor(y, device="cuda"))
        want = small_step(torch, pt, host, torch.tensor(x), torch.tensor(y))
        truth = small_step(torch, pt, exact,
                           torch.tensor(x, dtype=torch.float64),
                           torch.tensor(y))
        worst = []
        for n, g in want[1].items():
            noise = rel_l2(g, truth[1][n])
            gap = rel_l2(got[1][n].cpu(), g)
            worst.append((gap / (MOBILE_NOISE_FACTOR * noise
                                 + VISION_TOL["grad"]), n, gap, noise))
        worst.sort(reverse=True)
        row = {"phase": "mobile_nets_small", "model": name,
               "loss": got[0], "host_loss": want[0],
               "loss_rel_gap": abs(got[0] - want[0]) / abs(want[0]),
               "grads": len(worst),
               "worst_grads": [{"name": n, "gap": gap, "host_noise": nz,
                                "share_of_bound": r}
                               for r, n, gap, nz in worst[:3]],
               "eval_logits_gap": max_rel_gap(got[2], want[2]),
               "tol": VISION_TOL, "noise_factor": MOBILE_NOISE_FACTOR}
        emit(row)
        assert row["loss_rel_gap"] <= VISION_TOL["loss"], row
        assert worst[0][0] <= 1.0, row
        assert row["eval_logits_gap"] <= VISION_TOL["logits"], row
        rows.append(row)
    return rows


def fold_bn(torch, pt, model):
    """A copy of ``model`` in which every Conv2D followed by a BatchNorm2D
    in a Sequential takes the BN's eval statistics: weight w * s and bias
    beta - mean * s, s = gamma / sqrt(var + eps) (computed in f32, stored
    in the model's dtype and layout), the BN replaced by Identity. Returns
    (the copy, how many BNs were folded)."""
    import copy
    folded = copy.deepcopy(model)
    n = 0
    for seq in folded.modules():
        if not isinstance(seq, torch.nn.Sequential):
            continue
        names = list(seq._modules)
        for a, b in zip(names, names[1:]):
            conv, bn = seq._modules[a], seq._modules[b]
            if not (isinstance(conv, pt.nn.Conv2D)
                    and isinstance(bn, pt.nn.BatchNorm2D)):
                continue
            s = bn.weight.float() * torch.rsqrt(bn._variance.float()
                                                + bn._epsilon)
            shift = bn.bias.float() - bn._mean.float() * s
            if conv.bias is not None:
                shift = shift + conv.bias.float() * s
            with torch.no_grad():
                conv.weight.copy_(conv.weight.float() * s.view(-1, 1, 1, 1))
            conv.bias = pt.Parameter(shift.to(conv.weight.dtype).detach())
            seq._modules[b] = pt.nn.Identity()
            n += 1
    return folded, n


def phase_mobilenet_eval(torch, seed, trained):
    """MobileNetV2 in eval mode, bf16, on the weights and running
    statistics mobilenet_train left: BN folded into the convs (fold_bn)
    against BatchNorm in eval, both held to the same weights in f32 with
    BN eval: the folded path's relative L2 gap at most EVAL_FACTOR x the
    BN path's + EVAL_SLACK, at batch 128 and at batch 1. Latency (host
    clock ending in a synchronize, mean of EVAL_CALLS calls) and device
    time of each path."""
    import copy

    import paddle_tpu_torch as pt
    trained.eval()
    folded, n = fold_bn(torch, pt, trained)
    truth_model = copy.deepcopy(trained).float()
    paths = {"bn_eval": trained, "folded": folded.eval()}
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    x = torch.randn((MOBILE_BATCH, MOBILE_HW, MOBILE_HW, 3), generator=g,
                    device="cuda").to(torch.bfloat16)
    rows = []
    with torch.no_grad():
        for batch in (MOBILE_BATCH, 1):
            xb = x[:batch]
            truth = truth_model(xb.float()).float()
            out = {k: m(xb).float() for k, m in paths.items()}
            gap = {k: rel_l2(o, truth) for k, o in out.items()}
            row = {"phase": "mobilenet_eval", "batch": batch,
                   "dtype": "bfloat16", "folded_batch_norms": n,
                   "rel_l2_to_f32": gap,
                   "argmax_agree": (out["folded"].argmax(-1)
                                    == out["bn_eval"].argmax(-1))
                   .float().mean().item(),
                   "tol": {"factor": EVAL_FACTOR, "slack": EVAL_SLACK}}
            for k, m in paths.items():
                for _ in range(3):
                    m(xb)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EVAL_CALLS):
                    m(xb)
                torch.cuda.synchronize()
                latency = (time.perf_counter() - t0) / EVAL_CALLS * 1e3
                dev, launches = device_profile(torch, lambda: m(xb), reps=2,
                                               warmup=1)
                row[k] = {"latency_ms": latency, "device_ms": dev,
                          "kernels": launches,
                          "images_per_s": batch / latency * 1e3}
            emit(row)
            assert gap["folded"] <= EVAL_FACTOR * gap["bn_eval"] \
                + EVAL_SLACK, row
            rows.append(row)
    del paths, folded, truth_model
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_state_guard(torch, seed):
    """C3 on the card: a step through fused_residual_ln (LayerNorm width
    768, 8 x 128 tokens, f32), captured by to_static and warm with an all-
    ones weight; then (a) set_state_dict loads a weight whose channel 3
    is 0, (b) set_state_dict restores ones, (c) an in-place zero_ of
    channel 3. Each load that changes the guard's verdict must make the
    next call build a new program, the one that keeps it must not; after
    each write the replay's output (which reads the weight) and dw equal
    plain autograd's within GUARD_TOL, so a load reaches a captured
    graph's parameter in place; after (a) and (c) dw is not 0 at
    channel 3."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import fused_residual_ln as rln
    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    shape = (8, 128, GUARD_WIDTH)
    x, y, ct = (torch.randn(shape, generator=g, device="cuda")
                for _ in range(3))

    class Block(pt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = pt.nn.LayerNorm(GUARD_WIDTH, device="cuda")

        def forward(self, a, b):
            return rln.fused_residual_ln(a, b, self.ln.weight, self.ln.bias)
    block = Block()

    @pt.jit.to_static
    def step(a, b, c):
        out = block(a, b)
        out.backward(c)
        dw = block.ln.weight.grad
        block.ln.weight.grad = None
        return dw, out.detach()

    def plain():
        w = block.ln.weight.detach().clone().requires_grad_()
        z = x + y
        out = (z - z.mean(-1, keepdim=True)) * torch.rsqrt(
            z.var(-1, correction=0, keepdim=True) + 1e-5) * w \
            + block.ln.bias.detach()
        out.backward(ct)
        return w.grad, out.detach()

    def zeroed():
        w = torch.ones(GUARD_WIDTH, device="cuda")
        w[GUARD_CHANNEL] = 0.0
        return w

    for _ in range(3):
        step(x, y, ct)
    rows = []
    for label, write, changes in (
            ("set_state_dict_zero_channel",
             lambda: block.set_state_dict({"ln.weight": zeroed()}), True),
            ("set_state_dict_ones",
             lambda: block.set_state_dict(
                 {"ln.weight": torch.ones(GUARD_WIDTH)}), True),
            ("set_state_dict_same_verdict",
             lambda: block.set_state_dict(
                 {"ln.weight": torch.full((GUARD_WIDTH,), 2.0)}), False),
            ("inplace_zero_", lambda: block.ln.weight[GUARD_CHANNEL]
             .detach().zero_(), True)):
        n0 = len(step.programs)
        write()
        dw, out = [step(x, y, ct) for _ in range(3)][-1]
        torch.cuda.synchronize()
        want_dw, want_out = plain()
        gap = (dw - want_dw).abs().max().item()
        out_gap = (out - want_out).abs().max().item()
        row = {"phase": "state_guard", "write": label,
               "programs_before": n0, "programs_after": len(step.programs),
               "verdict": block.ln.weight._degen_cache[1],
               "dw_max_abs_gap_to_plain": gap,
               "out_max_abs_gap_to_plain": out_gap,
               "dw_at_channel": dw[GUARD_CHANNEL].item(),
               "plain_dw_at_channel": want_dw[GUARD_CHANNEL].item(),
               "tol": GUARD_TOL}
        emit(row)
        assert len(step.programs) == n0 + (1 if changes else 0), row
        assert gap <= GUARD_TOL * max(1.0, want_dw.abs().max().item()), row
        assert out_gap <= GUARD_TOL * max(1.0, want_out.abs().max().item()),\
            row
        if row["verdict"]:
            assert abs(row["dw_at_channel"]) > 1e-3, row
        rows.append(row)
    return rows


# -- the rest of nn (nn_rest group) -------------------------------------------
# rnn_small: f32 card against host
RNN_SMALL = {"batch": 3, "steps": 7, "width": 16, "layers": 2}
RNN_OUT_TOL, RNN_GRAD_TOL = 1e-5, 1e-4
# cuDNN's tanh RNN cell is ~50x less accurate than the host's f32: on an
# H100 its outputs sit 8-9.6e-6 and its grads 0.7-1.4e-4 (relative to 1 +
# |grad|) from the f64 truth, where the host's sit 2e-7 and 2-3e-6
TANH_RNN_OUT_TOL, TANH_RNN_GRAD_TOL = 2e-5, 5e-4
# translate: Transformer-base (Vaswani et al. 2017, Table 3 "base") with a
# shared 37000-token embedding, beam 4 (their section 6.1)
TRANSLATE = {"vocab": 37000, "d_model": 512, "batch": 8, "src_len": 256,
             "beam": 4, "max_steps": 128, "greedy_steps": 32, "bos": 1,
             "eos": 2, "encode_reps": 5}
# lstm_lm: the PTB "medium" LSTM of Zaremba et al. 2014 (section 4.1) as
# PaddlePaddle's ptb_lm example trains it
LSTM_LM = {"vocab": 10000, "width": 650, "layers": 2, "dropout": 0.5,
           "num_steps": 35, "batch": 20, "lr": 1.0, "clip": 5.0,
           "init_scale": 0.05, "warmup": 2, "timed": 256, "window": 32,
           "markov_ids": 2000, "markov_fanout": 17, "markov_mult": 31}


def phase_nn_rest_cases(torch):
    """nn_rest_cases: every case of tests/test_torch_nn_rest_cases.py
    (1-D, 3-D and transposed convs, every pooling with masks and
    unpooling, the group/instance/LRN/spectral norms, nn.utils, vision.py,
    sparse_attention, gather_tree) on the card against the host
    (cases_on_card, TF32 off; transposed convs and the samplers within
    their host tolerance, 1e-5)."""
    return cases_on_card(torch, "test_torch_nn_rest_cases", "nn_rest_cases")


def phase_rnn_small(torch, seed):
    """rnn_small: LSTM, GRU and SimpleRNN (tanh and relu), 2 layers,
    bidirectional, batch 3 x 7 steps, width 16, f32 on the card (cuDNN's
    RNN, one call per layer) against the same weights on the host: outputs
    and final states within RNN_OUT_TOL, the input's and every weight's
    grad (of a fixed random weighting of all outputs) within RNN_GRAD_TOL
    (the tanh SimpleRNN within TANH_RNN_OUT_TOL and TANH_RNN_GRAD_TOL).
    Then BeamSearchDecoder (beam 3) over a GRUCell, an embedding and a
    projection whose bias favours the end token, 6 steps on the card and
    on the host: tokens, parents, lengths and finished flags identical,
    with at least one beam finished."""
    import paddle_tpu_torch as pt
    b, t, w, nl = (RNN_SMALL[k] for k in ("batch", "steps", "width",
                                          "layers"))
    g = torch.Generator().manual_seed(seed + 31)
    x = torch.randn(b, t, w, generator=g)
    rows = []
    for name, kw in (("LSTM", {}), ("GRU", {}), ("SimpleRNN", {}),
                     ("SimpleRNN", {"activation": "relu"})):
        cls = getattr(pt.nn, name)

        def run(device, state=None):
            layer = cls(w, w, num_layers=nl, direction="bidirect",
                        device=device, generator=pt.make_generator(seed), **kw)
            if state is not None:
                layer.set_state_dict(state)
            xi = x.detach().to(device).requires_grad_()
            out, final = layer(xi)
            outs = [out] + list(final if isinstance(final, tuple)
                                else (final,))
            weights = [torch.randn(o.shape, generator=torch.Generator()
                                   .manual_seed(seed + i)).to(device)
                       for i, o in enumerate(outs)]
            sum((o * wt).sum() for o, wt in zip(outs, weights)).backward()
            grads = {n: p.grad.cpu() for n, p in layer.named_parameters()}
            grads["input"] = xi.grad.cpu()
            return [o.detach().cpu() for o in outs], grads, layer.state_dict()
        host_out, host_grads, state = run("cpu")
        card_out, card_grads, _ = run("cuda", state)
        out_gap = max((a - h).abs().max().item()
                      for a, h in zip(card_out, host_out))
        grad_gap = max(((card_grads[n] - host_grads[n]).abs()
                        / (1.0 + host_grads[n].abs())).max().item()
                       for n in host_grads)
        tanh = name == "SimpleRNN" and not kw
        tol = {"out": TANH_RNN_OUT_TOL if tanh else RNN_OUT_TOL,
               "grad": TANH_RNN_GRAD_TOL if tanh else RNN_GRAD_TOL}
        row = {"phase": "rnn_small", "layer": name, **kw, "layers": nl,
               "direction": "bidirect", "shape": [b, t, w],
               "out_max_abs_gap": out_gap, "grad_max_rel_gap": grad_gap,
               "tol": tol}
        emit(row)
        assert out_gap <= tol["out"] and grad_gap <= tol["grad"], row
        rows.append(row)

    vocab, beam = 6, 3

    def decode(device):
        gen = pt.make_generator(seed + 32)
        emb = pt.nn.Embedding(vocab, w, device=device, generator=gen)
        cell = pt.nn.GRUCell(w, w, device=device, generator=gen)
        proj = pt.nn.Linear(w, vocab, device=device, generator=gen)
        with torch.no_grad():
            proj.bias[0] += 0.6
        dec = pt.nn.BeamSearchDecoder(cell, 1, 0, beam, embedding_fn=emb,
                                      output_fn=proj)
        init = torch.randn(2, w, generator=torch.Generator().manual_seed(
            seed + 33)).to(device)
        inputs, states = dec.initialize(init)
        toks, parents = [], []
        with torch.no_grad():
            for step in range(6):
                out, states, inputs, _ = dec.step(step, inputs, states)
                toks.append(out[0].cpu())
                parents.append(out[1].cpu())
        return (torch.stack(toks), torch.stack(parents),
                states["lengths"].cpu(), states["finished"].cpu())
    card, host = decode("cuda"), decode("cpu")
    same = all(torch.equal(a, h) for a, h in zip(card, host))
    row = {"phase": "rnn_small", "decoder": "BeamSearchDecoder over GRUCell",
           "beam": beam, "vocab": vocab, "steps": 6, "identical": same,
           "finished_beams": int(card[3].sum()),
           "tokens_batch0": card[0][:, 0].tolist()}
    emit(row)
    assert same and row["finished_beams"] > 0, row
    rows.append(row)
    return rows


def translate_model(torch, pt, seed):
    """Transformer-base with a shared source/target/output embedding and
    sinusoidal positions, random weights from ``seed``, bf16, eval."""
    cfg = TRANSLATE
    d, vocab = cfg["d_model"], cfg["vocab"]
    max_len = cfg["src_len"] + cfg["max_steps"]

    class Translator(pt.nn.Layer):
        def __init__(self):
            super().__init__(device="cuda",
                             generator=pt.make_generator(seed))
            fk = self.factory_kwargs()
            self.embedding = pt.nn.Embedding(vocab, d, **fk)
            self.transformer = pt.nn.Transformer(**fk)
            pos = torch.arange(max_len, dtype=torch.float32)[:, None]
            freq = 10000.0 ** (torch.arange(0, d, 2) / d)
            pe = torch.zeros(max_len, d)
            pe[:, 0::2] = torch.sin(pos / freq)
            pe[:, 1::2] = torch.cos(pos / freq)
            self.register_buffer("pe", pe.to("cuda"))

        def embed(self, ids, start):
            return (self.embedding(ids) * d ** 0.5
                    + self.pe[start:start + ids.shape[1]])

        def encode(self, src):
            return self.transformer.encoder(self.embed(src, 0))

        def cell(self, memory):
            """The decode step over ``memory``: (ids, caches) -> (logits
            through the shared embedding, new caches); the position is the
            self-attention cache's length."""
            def step(ids, caches):
                x = self.embed(ids[:, None], caches[0][0].k.shape[1])
                out, new = self.transformer.decoder(x, memory, cache=caches)
                return out[:, 0] @ self.embedding.weight.T, new
            return step
    model = Translator()
    model.bfloat16()
    model.eval()
    return model


class _StepClock:
    """A decoder whose steps are timed on the host: the time between one
    step's start and the next's includes dynamic_decode's per-step sync."""

    def __init__(self, decoder):
        self.decoder, self.starts = decoder, []

    def __getattr__(self, name):
        return getattr(self.decoder, name)

    def step(self, *args, **kwargs):
        self.starts.append(time.perf_counter())
        return self.decoder.step(*args, **kwargs)


def phase_translate(torch, seed):
    """translate, the first full-width path: Transformer-base (d_model
    512, 8 heads, 6 + 6 layers, FFN 2048, ReLU; nn.Transformer's
    defaults) with a shared 37000-token embedding, bf16, eval, random
    weights from --seed; 8 sources of 256 tokens (no padding, so no mask:
    the encoder's self-attention takes B1, tc_bf16, at (8, 256, 8, 64));
    beam 4 through TransformerBeamSearchDecoder + dynamic_decode, the
    memory tiled by tile_beam_merge_with_batch and the caches from
    gen_cache, at most 128 steps (no length penalty: the reference's
    decoder has none). Gates: output (8, T, 4); B1 launched exactly 6
    times in the encode+decode (the wrappers' counts, reset just before);
    every final log-prob finite; beam 1 (32 steps) equals a greedy loop
    over the same cell. Reported: encode ms (wall, median of 5, and device
    from a profile), time to the first decoded token, decode step ms
    p50/p99, steps, decoded tokens/s (batch x beam a step), kernels a
    step and the busy share (a profiled 8-step decode), peak memory."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAME, TC
    cfg = TRANSLATE
    t_lane = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model = translate_model(torch, pt, seed)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    src = torch.randint(3, cfg["vocab"], (cfg["batch"], cfg["src_len"]),
                        generator=gen, device="cuda")
    beam = cfg["beam"]
    tile = pt.nn.BeamSearchDecoder.tile_beam_merge_with_batch

    def decode(memory, beam_size, max_steps, clock=None):
        if beam_size > 1:
            memory = tile(memory, beam_size)
        dec = pt.nn.TransformerBeamSearchDecoder(
            model.cell(memory), cfg["bos"], cfg["eos"], beam_size)
        if clock is not None:
            clock.decoder = dec
            dec = clock
        return pt.nn.dynamic_decode(
            dec, inits=model.transformer.decoder.gen_cache(memory),
            max_step_num=max_steps)

    with torch.no_grad():
        decode(model.encode(src), beam, 2)      # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(cfg["encode_reps"]):
            t0 = time.perf_counter()
            model.encode(src)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        trace, _, _, enc_prof = profiled(torch, lambda: model.encode(src), 1)
        torch.cuda.reset_peak_memory_stats()
        clock = _StepClock(None)
        launch_counts.clear()
        t0 = time.perf_counter()
        preds, states = decode(model.encode(src), beam, cfg["max_steps"],
                               clock)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        b1 = launch_counts[f"{KERNEL_NAME}.{TC}"]
        flash = dict(launch_counts)
        peak = torch.cuda.max_memory_allocated()
        ends = clock.starts[1:] + [t_end]
        step_ms = [(e - s) * 1e3 for s, e in zip(clock.starts, ends)]
        steps = len(step_ms)
        first_token_ms = (ends[0] - t0) * 1e3
        decode_s = t_end - clock.starts[0]
        finite = bool(torch.isfinite(states["log_probs"]).all())
        # beam 1 against a greedy loop over the same cell
        memory = model.encode(src)
        greedy_preds, _ = decode(memory, 1, cfg["greedy_steps"])
        cell = model.cell(memory)
        caches = model.transformer.decoder.gen_cache(memory)
        tok = torch.full((cfg["batch"],), cfg["bos"], dtype=torch.int32,
                         device="cuda")
        done = torch.zeros(cfg["batch"], dtype=torch.bool, device="cuda")
        greedy = []
        for _ in range(greedy_preds.shape[1]):
            logits, caches = cell(tok, caches)
            nxt = torch.log_softmax(logits.float(), -1).argmax(-1)
            tok = torch.where(done, cfg["eos"], nxt).to(torch.int32)
            greedy.append(tok)
            done = done | (tok == cfg["eos"])
        beam1_equal = torch.equal(greedy_preds[:, :, 0],
                                  torch.stack(greedy, dim=1))
        # kernels a step and the busy share over 8 decode steps
        prof_trace, prof_wall_s, _, _ = profiled(
            torch, lambda: decode(memory, beam, 8), 1)
    kernels = kernel_times(prof_trace)
    row = {"phase": "translate", "dtype": "bfloat16",
           "config": "Transformer-base: d_model 512, 8 heads, 6 + 6 layers, "
                     "FFN 2048, ReLU; shared 37000-token embedding, "
                     "sinusoidal positions",
           "parameters": n_params, "sources": [cfg["batch"], cfg["src_len"]],
           "beam": beam, "max_step_num": cfg["max_steps"],
           "output_shape": list(preds.shape), "decode_steps": steps,
           "encode_wall_ms_median": float(np.median(walls)),
           "encode_wall_ms": walls,
           "encode_device_ms": enc_prof["device_ms"],
           "encode_kernels": enc_prof["kernel_launches"],
           "time_to_first_token_ms": first_token_ms,
           "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
           "decode_step_ms_p99": float(np.percentile(step_ms, 99)),
           "decode_s": decode_s,
           "decoded_tokens_per_s": cfg["batch"] * beam * steps / decode_s,
           "profiled_decode": {
               "steps": 8, "wall_ms": prof_wall_s * 1e3,
               "kernels_per_step": sum(k[1] for k in kernels) / 8,
               "device_ms": sum(k[0] for k in kernels) / 1e3,
               "busy_share": device_busy(prof_trace) / (prof_wall_s * 1e3)},
           "peak_mem_bytes": peak, "b1_launches": b1,
           "flash_launch_counts": flash, "log_probs_finite": finite,
           "beam1_equals_greedy": beam1_equal,
           "greedy_steps": greedy_preds.shape[1],
           "tokens_source0_beam0": preds[0, :16, 0].tolist(),
           "seconds": time.perf_counter() - t_lane}
    emit(row)
    emit_profile(prof_trace, prof_wall_s, "translate_decode_8_steps", 8,
                 top=12)
    assert list(preds.shape) == [cfg["batch"], steps, beam], row
    assert b1 == 6, row
    assert finite and beam1_equal, row
    del model, trace, prof_trace
    gc.collect()
    torch.cuda.empty_cache()
    return row


def markov_stream(torch, seed, n, ids):
    """n tokens of s[i] = (31 s[i-1] + r_i) mod ids, r_i uniform in [0,
    17), s[0] = 0 (paddle_tpu/text/datasets.py's Imikolov stream, whose
    chain runs over 2000 ids), made on the card from ``seed``: the affine
    maps x -> a x + b are composed by a Hillis-Steele scan, so no step
    waits on the one before it."""
    cfg = LSTM_LM
    g = torch.Generator(device="cuda").manual_seed(seed + 51)
    b = torch.randint(0, cfg["markov_fanout"], (n,), generator=g,
                      device="cuda", dtype=torch.int64)
    b[0] = 0
    a = torch.full((n,), cfg["markov_mult"], device="cuda",
                   dtype=torch.int64)
    shift = 1
    while shift < n:
        a2, b2 = a.clone(), b.clone()
        b2[shift:] = (a[shift:] * b[:-shift] + b[shift:]) % ids
        a2[shift:] = (a[shift:] * a[:-shift]) % ids
        a, b, shift = a2, b2, shift * 2
    return b


def lstm_classes(prof):
    """Device ms and launches of an LSTM step's kernels by class: cuDNN's
    RNN kernels, GEMMs, reductions, copies, the other elementwise ones."""
    classes = {}
    for us, count, name in kernel_times(prof):
        low = name.lower()
        if any(k in low for k in ("rnn", "lstm", "cudnn")):
            kind = "rnn"
        elif any(k in low for k in ("gemm", "xmma", "cutlass", "sm90_",
                                    "sm80_", "ampere")):
            kind = "gemm"
        elif "reduce" in low:
            kind = "reduction"
        elif "copy" in low or "memcpy" in low or "memset" in low:
            kind = "copy"
        else:
            kind = "elementwise"
        ms, n = classes.get(kind, (0.0, 0))
        classes[kind] = (ms + us / 1e3, n + count)
    return {k: {"ms": ms, "launches": n} for k, (ms, n) in classes.items()}


def phase_lstm_lm(torch, seed):
    """lstm_lm, the second full-width path: the PTB "medium" LSTM
    language model (Zaremba et al. 2014, section 4.1; PaddlePaddle's
    ptb_lm example): vocab 10000, embedding 650, nn.LSTM(650, 650,
    num_layers=2, dropout=0.5) (cuDNN, one call per layer), dropout 0.5
    on its input and output, Linear(650, 10000), every weight
    Uniform(-0.05, 0.05) through ParamAttr; 35 unrolled steps, batch 20;
    SGD(1.0) with ClipGradByGlobalNorm(5.0), f32; (h, c) carried across
    steps in buffers, detached (truncated BPTT); the step captured by
    to_static (CompiledTrainStep): 2 warm-up steps (discovery, capture),
    then 256 timed ones over Imikolov's Markov stream (its chain over
    2000 of the 10000 ids, as PTB's text uses a skewed part of its
    vocabulary; over all 10000 the unigram is uniform and 256 steps
    learn nothing measurable) made on the card. Gates:
    every loss finite, the last-32 mean below the first-32 mean, 1
    compile in the warm-up and none timed. Reported: step ms, tokens/s
    (700 a step), a replay's kernels, device time by class and busy
    share, peak memory, captured."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    cfg = LSTM_LM
    v, h, nl = cfg["vocab"], cfg["width"], cfg["layers"]
    bsz, nsteps = cfg["batch"], cfg["num_steps"]
    t_lane = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init = pt.nn.initializer.Uniform(-cfg["init_scale"], cfg["init_scale"])

    class PTBModel(pt.nn.Layer):
        def __init__(self):
            super().__init__(device="cuda", generator=pt.make_generator(
                seed, "cuda"))
            fk = self.factory_kwargs()
            attr = pt.ParamAttr(initializer=init)
            self.embedding = pt.nn.Embedding(v, h, weight_attr=attr, **fk)
            self.lstm = pt.nn.LSTM(h, h, num_layers=nl,
                                   dropout=cfg["dropout"],
                                   weight_ih_attr=attr, weight_hh_attr=attr,
                                   bias_ih_attr=attr, bias_hh_attr=attr,
                                   **fk)
            self.dropout = pt.nn.Dropout(cfg["dropout"], **fk)
            self.proj = pt.nn.Linear(h, v, weight_attr=attr, bias_attr=attr,
                                     **fk)
            self.register_buffer("h", torch.zeros(nl, bsz, h,
                                                  device="cuda"))
            self.register_buffer("c", torch.zeros(nl, bsz, h,
                                                  device="cuda"))

        def forward(self, x):
            out, (hn, cn) = self.lstm(self.dropout(self.embedding(x)),
                                      (self.h, self.c))
            return self.proj(self.dropout(out)), hn, cn
    model = PTBModel()
    model.train()
    opt = pt.optimizer.SGD(learning_rate=cfg["lr"],
                           parameters=model.parameters(),
                           grad_clip=pt.nn.ClipGradByGlobalNorm(cfg["clip"]))

    @pt.jit.to_static
    def train_step(x, y):
        logits, hn, cn = model(x)
        loss = pt.nn.functional.cross_entropy(logits.reshape([-1, v]),
                                              y.reshape([-1]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        # truncated BPTT: the next step starts from these states, detached
        with torch.no_grad():
            model.h.copy_(hn)
            model.c.copy_(cn)
        return loss
    step = CompiledTrainStep(train_step, label="lstm_lm")
    total = cfg["warmup"] + cfg["timed"]
    t0 = time.perf_counter()
    stream = markov_stream(torch, seed, bsz * (total * nsteps + 1),
                           cfg["markov_ids"])
    data = stream.reshape(bsz, -1)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0

    def batch(k):
        seg = data[:, k * nsteps:(k + 1) * nsteps + 1]
        return seg[:, :-1].contiguous(), seg[:, 1:].contiguous()
    losses = []
    reset_compile_stats()
    for k in range(cfg["warmup"]):
        losses.append(step(*batch(k)))
    torch.cuda.synchronize()
    warm = compile_stats()
    reset_compile_stats()
    batches = [batch(k) for k in range(cfg["warmup"], total)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in batches:
        losses.append(step(x, y))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timed = compile_stats()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().tolist()
    step_ms = seconds / cfg["timed"] * 1e3
    x, y = batches[-1]
    trace, wall_s, _, prof = profiled(torch, lambda: step(x, y), 1)
    win = cfg["window"]
    first, last = (float(np.mean(losses[:win])),
                   float(np.mean(losses[-win:])))
    n_params = sum(p.numel() for p in model.parameters())
    programs = step.static_function._programs.values()
    captured = bool(programs) and all(p.graph is not None for p in programs)
    row = {"phase": "lstm_lm", "dtype": "float32",
           "config": "PTB medium LSTM: vocab 10000, embedding 650, 2 x "
                     "LSTM(650), dropout 0.5, Linear(650, 10000), "
                     "Uniform(-0.05, 0.05)",
           "parameters": n_params, "batch": [bsz, nsteps],
           "optimizer": "SGD(1.0) + ClipGradByGlobalNorm(5.0)",
           "data": f"Imikolov's Markov stream (31 s + U[0, 17)) mod "
                   f"{cfg['markov_ids']} made on the card", "data_s": data_s,
           "warmup_steps": cfg["warmup"], "timed_steps": cfg["timed"],
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "captured": captured, "step_ms": step_ms,
           "tokens_per_s": bsz * nsteps / (step_ms / 1e3),
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": device_busy(trace)
                              / (wall_s * 1e3)},
           "device_ms_by_class": lstm_classes(trace),
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "peak_mem_bytes": peak, "loss_first": losses[0],
           "loss_every_16th": losses[::16], f"first{win}_mean": first,
           f"last{win}_mean": last,
           "seconds": time.perf_counter() - t_lane}
    emit(row)
    emit_profile(trace, wall_s, "lstm_lm_replay", 1, top=12)
    assert all(np.isfinite(losses)) and last < first, row
    assert warm["compiles"] == 1 and timed["compiles"] == 0, (warm, timed)
    assert captured, row
    del model, opt, step, train_step, trace
    gc.collect()
    torch.cuda.empty_cache()
    return row


# --- the rest of paddle.vision and paddle.text (zoo) --------------------------

# vision_zoo_small, card (cuDNN, TF32 off) against host: the eval
# logits' relative L2 gap in f32; then each family's blocks
# (tests/test_torch_zoo_stages.py) one at a time on the host's f64
# inputs and output gradients, in f64 and in f32 on both sides. In f64
# each block's output and input gradient on the card are within
# ZOO_F64_TOL of the host's (relative L2), and each parameter grad within
# ZOO_F64_TOL of the block's grad norm (the same function); in f32 within
# ZOO_TOL + ZOO_NOISE_FACTOR x the f32 noise of both sides on that tensor
# (each side's f32 against its own f64), as mobile_nets_small holds
# MobileNet's grads with the host's noise; and the loss of the heads'
# outputs within ZOO_TOL["loss"]. The card's own noise counts: a grad
# that is 0 in exact arithmetic (a BN bias feeding a conv and another BN)
# or a sum with heavy cancellation lands further from it through cuDNN's
# f32 algorithms than through the host's (InceptionV3's first block at 2
# x 128 x 128: BN grads 0.9 % from the host's, whose own noise is
# 1.5e-7, on an H100 80GB HBM3). A whole-model f32 step is no sound gate
# either: a max-pool window whose two largest values lie within rounding
# sends the gradient to either (VGG-11-BN at 2 x 32 x 32:
# features.1.weight's grad 1.8 % apart, the host's noise 2.7e-6), and a
# BatchNorm over a few values amplifies rounding
ZOO_TOL = {"logits": 2e-5, "loss": 2e-5, "grad": 1e-4}
ZOO_NOISE_FACTOR, ZOO_F64_TOL = 4.0, 1e-9
# densenet_train: DenseNet-121 at full width and depth (Huang et al. 2017,
# Table 1) on bench.py's ResNet-50 image stream, bf16, NHWC; the paper's
# ImageNet recipe (section 4.2: SGD, Nesterov momentum 0.9, weight decay
# 1e-4, lr 0.1) at batch 128 (the paper's 256 halved, as resnet_train and
# mobilenet_train run 128); the step captured and driven by run_steps K =
# 4: 1 warm-up execution (4 steps) and 16 timed (64 steps) over 4 staged
# stacks; the first DENSE_PARITY captured losses within DENSE_LOSS_RTOL
# of an eager run's from the same weights and batches
DENSE_BATCH, DENSE_HW, DENSE_SPE, DENSE_STACKS = 128, 224, 4, 4
DENSE_WARMUP_EXEC, DENSE_TIMED_EXEC, DENSE_PARITY = 1, 4, 8
DENSE_LR, DENSE_MOMENTUM, DENSE_DECAY = 0.1, 0.9, 1e-4
DENSE_LOSS_RTOL = 2e-2
# zoo_eval: each family served by inference.Predictor at 1000 classes,
# bf16, NHWC, batch 64 (one CUDA graph); InceptionV3 at 299 x 299
ZOO_EVAL = (("alexnet", 224), ("vgg16", 224), ("squeezenet1_1", 224),
            ("googlenet", 224), ("inception_v3", 299), ("densenet121", 224),
            ("resnext50_32x4d", 224))
ZOO_EVAL_BATCH, ZOO_EVAL_REPLAYS = 64, 5
# vision_ops: the detectors' sizes. Faster R-CNN with an FPN on an 800 x
# 1344 input: the stride-4 map is 200 x 336 with 256 channels, 512 RoIs
# an image, 7 x 7 bins; R-FCN: 7 x 7 x 21 classes on the stride-16 map
# (50 x 84), 300 RoIs an image; DCN: 3 x 3 deformable convs on (2, 256,
# 50, 84); an RPN's NMS over 1000 boxes at 0.7; a class-aware fixed-size
# NMS over 1000 boxes of 80 classes; YOLOv3 at 608 x 608: heads of 19,
# 38 and 76 cells, 3 anchors each, 80 classes, the loss on the 19 x 19
# head with 50 ground-truth boxes; a CRF's Viterbi decode at B 64, S 128,
# T 32
OPS_TOL, OPS_CALLS, OPS_LEAD_KERNELS = 1e-5, 3, 256
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = ((19, 32, [6, 7, 8]), (38, 16, [3, 4, 5]), (76, 8, [0, 1, 2]))
# tokenize_bert: raw documents -> FasterTokenizer(max_seq_len=512) ->
# BERT-base bf16 through inference.Predictor, no mask (B1 non-causal at
# (8, 512, 12, 64)); then short pairs padded to 128 with a mask (the
# math path)
TOKEN_VOCAB, TOKEN_DOCS, TOKEN_SEQ, TOKEN_PAIR_SEQ = 30522, 8, 512, 128
TOKEN_BATCHES = 5


def zoo_stages():
    """tests/test_torch_zoo_stages.py (no JAX)."""
    import importlib
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    return importlib.import_module("test_torch_zoo_stages")


def zoo_step(pt, zs, model, x, y):
    """One Momentum(0.05, 0.9) + L2Decay(4e-5) training step: its loss."""
    opt = pt.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, parameters=model.parameters(),
        weight_decay=pt.regularizer.L2Decay(4e-5))
    model.train()
    loss = zs.loss_of(pt, model(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.item()


def zoo_blocks(torch, pt, zs, stages, heads, models, x, y):
    """Every stage alone on the f64 host model's inputs and output
    gradients (tests/test_torch_zoo_cases.py's ZooBlocks), in the card's
    and the host's models in f32 and in f64 (models: card, host, card
    f64, host f64, each with its initial weights). Returns the worst f32
    entries (share of bound, stage, what, gap, host noise, card noise),
    the worst f64 gap (gap, stage, what) and the loss of the heads' f32
    outputs on the card and the host."""
    card, host, card64, exact = models
    for m in models:
        m.train()
    acts = {None: torch.tensor(x, dtype=torch.float64)}
    for name, fn, src in stages(exact):
        acts[name] = fn(exact, acts[src])
        acts[name].retain_grad()
    zs.loss_of(pt, tuple(acts[h] for h in heads), torch.tensor(y)).backward()
    cots = {k: v.grad for k, v in acts.items() if k is not None}
    acts = {k: v.detach() for k, v in acts.items()}
    exact.zero_grad(set_to_none=True)

    def run(m, fn, a, c, device, dtype):
        xt = a.to(device, dtype).clone().requires_grad_()
        out = fn(m, xt)
        (out * c.to(device, dtype)).sum().backward()
        grads = {n: p.grad.detach().cpu()
                 for n, p in m.named_parameters() if p.grad is not None}
        m.zero_grad(set_to_none=True)
        return {"out": out.detach().cpu(), "dx": xt.grad.cpu(), **grads}
    worst, f64_worst, outs = [], (0.0, None, None), {"card": {}, "host": {}}
    for name, fn, src in stages(card):
        a, c = acts[src], cots[name]
        got = run(card, fn, a, c, "cuda", torch.float32)
        want = run(host, fn, a, c, "cpu", torch.float32)
        got64 = run(card64, fn, a, c, "cuda", torch.float64)
        truth = run(exact, fn, a, c, "cpu", torch.float64)
        outs["card"][name], outs["host"][name] = got["out"], want["out"]
        assert sorted(got) == sorted(want) == sorted(truth), name
        # in f64 a parameter's grad is held relative to the block's grad
        # norm: a grad that is 0 in exact arithmetic is rounding noise on
        # both sides, whatever its own norm
        params = [k for k in truth if k not in ("out", "dx")]
        scale = float(np.sqrt(sum(float(truth[k].norm()) ** 2
                                  for k in params))) if params else 0.0
        for what in got:
            tol = ZOO_TOL["logits"] if what == "out" else ZOO_TOL["grad"]
            diff = float((got64[what] - truth[what]).norm())
            f64_gap = diff / max(scale if what in params
                                 else float(truth[what].norm()), 1e-300)
            if f64_gap > f64_worst[0]:
                f64_worst = (f64_gap, name, what)
            noise = (rel_l2(want[what], truth[what]),
                     rel_l2(got[what], got64[what]))
            gap = rel_l2(got[what], want[what])
            worst.append((gap / (ZOO_NOISE_FACTOR * sum(noise) + tol), name,
                          what, gap, *noise))
    worst.sort(key=lambda r: -r[0])
    loss = {k: zs.loss_of(pt, tuple(v[h].float() for h in heads),
                          torch.tensor(y)).item() for k, v in outs.items()}
    return worst, f64_worst, loss


def phase_vision_zoo_small(torch, seed):
    """Every family of tests/test_torch_zoo_stages.py (AlexNet, VGG-11
    with and without BatchNorm, SqueezeNet 1.0 and 1.1, GoogLeNet,
    InceptionV3, DenseNet-121, ResNeXt-50 32x4d fused and unfused), 10
    classes, at its host test's size, in f32 (TF32 off), the same weights
    on the card and the host (every dropout at p = 0): the eval logits
    (each of GoogLeNet's three); the training step's blocks one at a time
    (zoo_blocks: outputs, input gradients and grads in f64 within
    ZOO_F64_TOL, in f32 within ZOO_TOL and ZOO_NOISE_FACTOR x both sides'
    noise; the loss of the heads' outputs); then one whole Momentum +
    L2Decay step on each side in f32, whose losses are reported and must
    be finite."""
    import copy

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import vision
    zs = zoo_stages()
    rows = []
    for fam, (ctor, kw, hw, batch, stages, heads, _) in \
            zs.FAMILIES.items():
        variants = ([{"fused_conv_bn": True}, {"fused_conv_bn": False}]
                    if fam.startswith("resnext") else [{}])
        rng = np.random.RandomState(seed + 31)
        x = rng.randn(batch, 3, hw, hw).astype("float32")
        y = rng.randint(0, 10, (batch,)).astype("int64")
        for vkw in variants:
            t0 = time.perf_counter()

            def make(device, gen):
                m = getattr(vision.models, ctor)(
                    num_classes=10, device=device, generator=gen, **kw,
                    **vkw)
                zs.no_dropout(m, pt)
                return m
            card, host = vision_pair(torch, make, seed)
            exact = copy.deepcopy(host).to(dtype=torch.float64)
            for m in (card, host):
                m.eval()
            with torch.no_grad():
                got = zs.outputs(card(torch.tensor(x, device="cuda")))
                want = zs.outputs(host(torch.tensor(x)))
            logits_gap = max(rel_l2(g.cpu(), w) for g, w in zip(got, want))
            row = {"phase": "vision_zoo_small", "model": fam, **vkw,
                   "input": [batch, 3, hw, hw], "outputs": len(got),
                   "eval_logits_rel_l2": logits_gap}
            models = [copy.deepcopy(m) for m in (card, host)] + [
                copy.deepcopy(card).to(dtype=torch.float64),
                copy.deepcopy(exact)]
            worst, f64_gap, loss = zoo_blocks(torch, pt, zs, stages, heads,
                                              models, x, y)
            row["f64_blocks_worst"] = dict(zip(("gap", "at", "what"),
                                               f64_gap))
            row["blocks"] = len(stages(card))
            row["loss"], row["host_loss"] = loss["card"], loss["host"]
            row["step_loss"] = {
                k: zoo_step(pt, zs, m, torch.tensor(x, device=d),
                            torch.tensor(y, device=d))
                for k, m, d in (("card", card, "cuda"), ("host", host, "cpu"))}
            row.update(
                loss_rel_gap=abs(row["loss"] - row["host_loss"])
                / abs(row["host_loss"]),
                checked=len(worst),
                worst=[{"at": n, "what": w, "gap": gap, "host_noise": hn,
                        "card_noise": cn, "share_of_bound": r}
                       for r, n, w, gap, hn, cn in worst[:3]],
                tol=ZOO_TOL, noise_factor=ZOO_NOISE_FACTOR,
                f64_tol=ZOO_F64_TOL,
                seconds=time.perf_counter() - t0)
            emit(row)
            assert logits_gap <= ZOO_TOL["logits"], row
            assert f64_gap[0] <= ZOO_F64_TOL, row
            assert row["loss_rel_gap"] <= ZOO_TOL["loss"], row
            assert worst[0][0] <= 1.0, row
            assert all(np.isfinite(v) for v in row["step_loss"].values()), \
                row
            rows.append(row)
            del card, host, exact
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def forward_flop(torch, pt, model, shape):
    """Multiply-adds x 2 of one forward of one input of ``shape`` through
    ``model``'s Conv2D and Linear layers, counted from the shapes their
    forward hooks see."""
    total = [0]

    def conv(m, inp, out):
        total[0] += 2 * out[0].numel() * m.weight[0].numel()

    def linear(m, inp, out):
        total[0] += 2 * m.weight.numel()
    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, pt.nn.Conv2D)]
    hooks += [m.register_forward_hook(linear) for m in model.modules()
              if isinstance(m, pt.nn.Linear)]
    was = model.training
    model.eval()
    with torch.no_grad():
        model(torch.zeros((1, *shape), device="cuda",
                          dtype=next(model.parameters()).dtype))
    model.train(was)
    for h in hooks:
        h.remove()
    return total[0]


def phase_densenet_train(torch, seed):
    """DenseNet-121 at full width and depth trains (DENSE_* above): bf16
    parameters, NHWC, 1000 classes, batch 128 x 224 x 224 of bench's
    prototype stream (made on the card), Momentum(0.1, 0.9, Nesterov) +
    L2Decay(1e-4), the step captured through to_static and driven by
    run_steps. First DENSE_PARITY eager steps from a copy of the same
    weights on the same batches. Gates: every loss finite, the first
    DENSE_PARITY captured losses within DENSE_LOSS_RTOL of the eager
    run's, 1 compile in the warm-up and none timed, no flash kernel.
    Reported: step ms, images/s, MFU (3 x the forward's FLOPs an image,
    from the layer shapes, over the bf16 peak), peak memory, a replay's
    device time by kernel class (conv/GEMM, BN and elementwise, reduce,
    copy, concat) and its layout copies, and the busy share."""
    import copy

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision.models import densenet121
    gc.collect()
    torch.cuda.empty_cache()
    model = densenet121(num_classes=1000, data_format="NHWC",
                        device="cuda", generator=pt.make_generator(seed))
    model.bfloat16()
    model.train()
    n_bn = sum(isinstance(m, pt.nn.BatchNorm2D) for m in model.modules())
    n_params = sum(p.numel() for p in model.parameters())
    flop = forward_flop(torch, pt, model, (DENSE_HW, DENSE_HW, 3))
    stacks = image_stream(torch, seed, DENSE_STACKS, DENSE_SPE, DENSE_BATCH,
                          (DENSE_HW, DENSE_HW, 3), 1000, RESNET_PROTO_SCALE,
                          1.0, torch.bfloat16)

    def optimizer(m):
        return pt.optimizer.Momentum(
            learning_rate=DENSE_LR, momentum=DENSE_MOMENTUM,
            use_nesterov=True, parameters=m.parameters(),
            weight_decay=pt.regularizer.L2Decay(DENSE_DECAY))
    eager_model = copy.deepcopy(model)
    eager_opt = optimizer(eager_model)
    eager = []
    for i in range(DENSE_PARITY):
        xs, ys = stacks[(i // DENSE_SPE) % DENSE_STACKS]
        loss = F.cross_entropy(eager_model(xs[i % DENSE_SPE]).float(),
                               ys[i % DENSE_SPE])
        loss.backward()
        eager_opt.step()
        eager_opt.clear_grad()
        eager.append(loss.item())
    del eager_model, eager_opt
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = optimizer(model)
    losses, seconds, warm, timed, flash, _, step = train_lane(
        torch, "densenet121", model, opt, stacks, DENSE_WARMUP_EXEC,
        DENSE_TIMED_EXEC, ())
    peak = torch.cuda.max_memory_allocated()
    timed_steps = DENSE_TIMED_EXEC * DENSE_SPE
    step_ms = seconds / timed_steps * 1e3
    x, y = stacks[-1][0][-1], stacks[-1][1][-1]
    trace, wall_s, _, prof = profiled(torch, lambda: step(x, y), 1)
    by_class = kernel_classes(trace)
    emit_profile(trace, wall_s, "densenet121_train_replay", 1, top=15,
                 by_class=by_class)
    images_per_s = DENSE_BATCH * timed_steps / seconds
    parity = rel_gaps(losses[:DENSE_PARITY], eager)
    row = {"phase": "densenet_train", "dtype": "bfloat16",
           "config": "DenseNet-121 (growth 32, blocks 6/12/24/16, 64 "
                     "initial features), 1000 classes, NHWC",
           "parameters": n_params, "batch_norms": n_bn,
           "forward_flop_per_image": flop,
           "optimizer": f"Momentum {DENSE_MOMENTUM} Nesterov + L2Decay "
                        f"{DENSE_DECAY}, lr {DENSE_LR}",
           "batch": [DENSE_BATCH, DENSE_HW, DENSE_HW, 3],
           "steps_per_execution": DENSE_SPE,
           "warmup_steps": DENSE_WARMUP_EXEC * DENSE_SPE,
           "timed_steps": timed_steps,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "eager_losses": eager, "captured_losses_first": losses[
               :DENSE_PARITY], "eager_parity_rel_gap": parity,
           "step_ms": step_ms, "images_per_s": images_per_s,
           "mfu": 3 * flop * images_per_s / PEAK_FLOPS["bfloat16"],
           "peak_mem_bytes": peak,
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": device_busy(trace)
                              / (wall_s * 1e3)},
           "device_ms_by_class": {k: v for k, v in by_class.items()
                                  if k != "copy_kernels"},
           "layout_copies_per_step": by_class.get("copy", {}).get(
               "launches", 0),
           "copy_kernels": by_class["copy_kernels"][:6],
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "flash_launches": flash, "loss_first": losses[0],
           "loss_last": losses[-1], "loss_every_8th": losses[::8]}
    emit(row)
    assert all(np.isfinite(losses)) and all(np.isfinite(eager)), row
    assert parity <= DENSE_LOSS_RTOL, row
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": timed_steps, "retrace_warnings": 0}, \
        (warm, timed)
    assert all(c == 0 for c in flash.values()), flash
    del step, opt, trace, stacks, model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def move_stats(torch, model, shape, seed):
    """Two training-mode forwards of a small seeded batch, so that eval
    runs on running statistics that moved from their initial values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((8, *shape), generator=g, device="cuda")
    with torch.no_grad():
        model.train()
        for _ in range(2):
            model(x)
    model.eval()


def phase_zoo_eval(torch, seed):
    """Each family of ZOO_EVAL served by ``inference.Predictor`` (Config +
    set_layer + enable_low_precision(BFLOAT16)): 1000 classes, NHWC,
    batch 64 of one float32 host array (cast to bf16 on the copy into the
    graph's buffer), running statistics moved by two training-mode
    forwards. Gate: every output row of the replayed graph within
    relative L2 SERVE_TOL of a bf16 eager forward of the same model.
    Reported: warm-up seconds (the first run: an eager call and the
    capture), the replay's device ms (p50 of ZOO_EVAL_REPLAYS, CUDA
    events), Predictor.run's host ms (p50: copies in and out included),
    images/s, kernels and device ms of a profiled replay, no flash
    kernel."""
    import copy

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch import vision
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    zs = zoo_stages()
    rows = []
    for name, hw in ZOO_EVAL:
        gc.collect()
        torch.cuda.empty_cache()
        launch_counts.clear()
        model = getattr(vision.models, name)(
            num_classes=1000, data_format="NHWC", device="cuda",
            generator=pt.make_generator(seed))
        move_stats(torch, model, (hw, hw, 3), seed + 5)
        images = np.random.RandomState(seed + 41).randn(
            ZOO_EVAL_BATCH, hw, hw, 3).astype("float32")
        twin = copy.deepcopy(model).bfloat16().eval()
        with torch.no_grad():
            eager = [o.float().cpu().numpy() for o in zs.outputs(twin(
                torch.from_numpy(images).cuda().to(torch.bfloat16)))]
        del twin
        icfg = infer.Config()
        icfg.set_layer(model)
        icfg.enable_low_precision(infer.DataType.BFLOAT16)
        pred = infer.create_predictor(icfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = pred.run([images])
        warmup_s = time.perf_counter() - t0
        prog = pred._jit_cache[(((ZOO_EVAL_BATCH, hw, hw, 3), "float32"),)]
        graph = prog.graph.graph
        replay = []
        for _ in range(ZOO_EVAL_REPLAYS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            replay.append(start.elapsed_time(end))
        run_ms = []
        for _ in range(ZOO_EVAL_REPLAYS):
            t1 = time.perf_counter()
            pred.run([images])
            run_ms.append((time.perf_counter() - t1) * 1e3)
        per, _ = replay_profile(torch, prog.graph)
        gaps = [row_gaps(g, e) for g, e in zip(got, eager)]
        p50 = float(np.median(replay))
        row = {"phase": "zoo_eval", "model": name, "dtype": "bfloat16",
               "input": [ZOO_EVAL_BATCH, hw, hw, 3], "outputs": len(got),
               "warmup_s": warmup_s, "replay_ms_p50": p50,
               "replay_ms_min": float(min(replay)),
               "predictor_run_ms_p50": float(np.median(run_ms)),
               "images_per_s": ZOO_EVAL_BATCH / p50 * 1e3,
               "kernels_per_replay": per["kernel_launches"],
               "device_ms_per_replay": per["device_ms"],
               "top_kernels": per["top_kernels"],
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "to_bf16_eager_rel_l2_worst": max(float(g.max())
                                                 for g in gaps),
               "tol": SERVE_TOL,
               "flash_launches": {k: launch_counts[k] for k in KERNEL_NAMES},
               "flash_variant_launches": per["flash_variant_launches"]}
        emit(row)
        assert all(np.all(g <= SERVE_TOL) for g in gaps), row
        assert all(np.isfinite(g).all() for g in got), row
        assert not any(row["flash_launches"].values()), row
        assert not any(per["flash_variant_launches"].values()), row
        rows.append(row)
        del pred, prog, graph, model, icfg
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def ops_case(torch, name, fn, args, ints=()):
    """``fn`` on the card's copies of ``args`` against ``fn`` on the host's:
    float outputs within OPS_TOL (max gap over the largest magnitude),
    integer outputs identical (``ints``: the output positions); device ms
    and kernel launches of one call (a profile of OPS_CALLS calls after a
    lead-in) and its host-clock ms. Returns the row."""
    outputs = zoo_stages().outputs
    card = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
    got = outputs(fn(*card))
    want = outputs(fn(*args))
    gaps, equal = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        if i in ints or not w.is_floating_point():
            equal.append(bool(torch.equal(g.cpu(), w)))
        else:
            gaps.append(max_rel_gap(g, w))
    pad = torch.zeros(1, device="cuda")

    def calls():
        for _ in range(OPS_CALLS):
            fn(*card)

    def lead():
        # the op's calls, then OPS_LEAD_KERNELS tiny kernels: an op that
        # launches few (nms's host loop) leaves too few records to absorb
        # what a profile loses at its start late in a long process
        calls()
        for _ in range(OPS_LEAD_KERNELS):
            pad.zero_()
    _, wall_s, _, per = profiled(torch, calls, OPS_CALLS, lead=lead)
    ms, launches = per["device_ms"], per["kernel_launches"]
    row = {"phase": "vision_ops", "op": name,
           "shapes": [list(a.shape) for a in args
                      if isinstance(a, torch.Tensor)],
           "max_rel_gap": max(gaps) if gaps else None,
           "integers_equal": equal, "ms": ms, "launches": launches,
           "wall_ms": wall_s / OPS_CALLS * 1e3, "tol": OPS_TOL}
    emit(row)
    assert all(g <= OPS_TOL for g in gaps), row
    assert all(equal), row
    return row


def rois(rng, n_img, per_img, img_hw, lo, hi):
    """Random xyxy boxes inside an image of ``img_hw``, sides from lo to hi
    pixels, stacked image after image (float32), and the count an image
    (int32)."""
    h, w = img_hw
    side = rng.uniform(lo, hi, (n_img * per_img, 2))
    x1 = rng.uniform(0, w - side[:, 0])
    y1 = rng.uniform(0, h - side[:, 1])
    boxes = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], 1)
    return (boxes.astype("float32"),
            np.full((n_img,), per_img, dtype="int32"))


def phase_vision_ops(torch, seed):
    """Every op of paddle_tpu_torch.vision.ops and viterbi_decode on the
    card against the same op on the host (f32), at the detectors' sizes
    above: gathers, pools and losses within OPS_TOL, indices, counts and
    Viterbi paths identical; device ms and kernel launches of one call.
    nms_padded is then captured as one CUDA graph (it reads nothing on the
    host), its replay equal to the eager call: ``captured`` says so."""
    from paddle_tpu_torch.text import viterbi_decode
    from paddle_tpu_torch.vision import ops

    def torch_f32(a):
        return torch.tensor(np.asarray(a, dtype="float32"))
    rng = np.random.RandomState(seed + 51)
    rows = []
    feat = torch_f32(rng.randn(2, 256, 200, 336))
    boxes, num = rois(rng, 2, 512, (800, 1344), 32, 224)
    boxes, num = torch.tensor(boxes), torch.tensor(num)
    rows.append(ops_case(torch, "roi_align", lambda x, b, n: ops.roi_align(
        x, b, n, 7, spatial_scale=0.25, sampling_ratio=-1, aligned=True),
        [feat, boxes, num]))
    rows.append(ops_case(torch, "roi_pool", lambda x, b, n: ops.roi_pool(
        x, b, n, 7, spatial_scale=0.25), [feat, boxes, num]))
    del feat
    ps_feat = torch_f32(rng.randn(2, 21 * 49, 50, 84))
    ps_boxes, ps_num = rois(rng, 2, 300, (800, 1344), 32, 512)
    rows.append(ops_case(torch, "psroi_pool",
                         lambda x, b, n: ops.psroi_pool(x, b, n, 7, 1 / 16),
                         [ps_feat, torch.tensor(ps_boxes),
                          torch.tensor(ps_num)]))
    del ps_feat
    x = torch_f32(rng.randn(2, 256, 50, 84))
    w = torch_f32(rng.randn(256, 256, 3, 3) * 0.02)
    bias = torch_f32(rng.randn(256))
    for dg in (1, 4):
        off = torch_f32(rng.randn(2, 2 * dg * 9, 50, 84) * 2.0)
        mask = torch_f32(rng.uniform(0, 1, (2, dg * 9, 50, 84)))
        rows.append(ops_case(
            torch, f"deform_conv2d_v1_dg{dg}",
            lambda x, o, w, b, dg=dg: ops.deform_conv2d(
                x, o, w, b, padding=1, deformable_groups=dg),
            [x, off, w, bias]))
        rows.append(ops_case(
            torch, f"deform_conv2d_v2_dg{dg}",
            lambda x, o, w, b, m, dg=dg: ops.deform_conv2d(
                x, o, w, b, padding=1, deformable_groups=dg, mask=m),
            [x, off, w, bias, mask]))
    nb = torch.tensor(rois(rng, 1, 1000, (800, 1344), 16, 256)[0])
    scores = torch_f32(rng.permutation(1000) / 1000.0)
    rows.append(ops_case(torch, "nms",
                         lambda b, s: ops.nms(b, 0.7, s), [nb, scores]))
    cats = torch.tensor(rng.randint(0, 80, 1000))
    rows.append(ops_case(
        torch, "nms_padded",
        lambda b, s, c: ops.nms_padded(b, s, 0.5, 100, category_idxs=c),
        [nb, scores, cats]))
    # nms_padded captured: it reads nothing on the host
    args = [nb.cuda(), scores.cuda(), cats.cuda()]
    eager = ops.nms_padded(args[0], args[1], 0.5, 100, category_idxs=args[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        ops.nms_padded(args[0], args[1], 0.5, 100, category_idxs=args[2])
    with torch.cuda.graph(graph, stream=side):
        captured = ops.nms_padded(args[0], args[1], 0.5, 100,
                                  category_idxs=args[2])
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(captured, eager))
    replay_ms = cuda_time_ms(torch, graph.replay, reps=10, warmup=2)
    rows.append({"phase": "vision_ops", "op": "nms_padded_graph",
                 "captured": True, "replay_equals_eager": same,
                 "replay_ms": replay_ms,
                 "eager_device_ms": rows[-1]["ms"],
                 "eager_wall_ms": rows[-1]["wall_ms"],
                 "eager_launches": rows[-1]["launches"]})
    emit(rows[-1])
    assert same, rows[-1]
    del graph
    n_img = 8
    img = torch.tensor(np.full((n_img, 2), 608, dtype="int32"))
    for cells, stride, mask in YOLO_HEADS:
        head = torch_f32(rng.randn(n_img, 3 * 85, cells, cells))
        anchors = [YOLO_ANCHORS[2 * i + k] for i in mask for k in (0, 1)]
        rows.append(ops_case(
            torch, f"yolo_box_{cells}",
            lambda h, s, a=anchors, st=stride: ops.yolo_box(
                h, s, a, 80, conf_thresh=0.005, downsample_ratio=st),
            [head, img]))
    cells, stride, mask = YOLO_HEADS[0]
    head = torch_f32(rng.randn(n_img, 3 * 85, cells, cells))
    # 50 boxes an image in distinct cells (a cell's targets are written
    # once), sides up to half the image
    gt = np.zeros((n_img, 50, 4), "float32")
    for i in range(n_img):
        where = rng.choice(cells * cells, 50, replace=False)
        gt[i, :, 0] = (where % cells + rng.uniform(0.1, 0.9, 50)) / cells
        gt[i, :, 1] = (where // cells + rng.uniform(0.1, 0.9, 50)) / cells
        gt[i, :, 2:] = rng.uniform(0.02, 0.5, (50, 2))
    rows.append(ops_case(
        torch, "yolo_loss_19",
        lambda h, b, lab, s: ops.yolo_loss(
            h, b, lab, YOLO_ANCHORS, mask, 80, ignore_thresh=0.7,
            downsample_ratio=stride, gt_score=s, use_label_smooth=True),
        [head, torch_f32(gt), torch.tensor(rng.randint(0, 80, (n_img, 50))),
         torch_f32(rng.uniform(0.5, 1, (n_img, 50)))]))
    B, S, T = 64, 128, 32
    rows.append(ops_case(
        torch, "viterbi_decode", viterbi_decode,
        [torch_f32(rng.randn(B, S, T)), torch_f32(rng.randn(T, T)),
         torch.tensor(rng.randint(1, S + 1, B))], ints=(1,)))
    return rows


def synthetic_vocab(rng):
    """A BERT vocabulary of TOKEN_VOCAB entries from ``rng``: the special
    tokens, every lower-case letter and CJK character of a block whole
    and as a ``##`` piece (so any word of them tokenizes), punctuation,
    then whole words and ``##`` pieces of 2 to 7 letters."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    cjk = [chr(0x4E00 + i) for i in range(400)]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += list(letters) + ["##" + c for c in letters] + cjk
    vocab += list(".,;:!?()'\"-")
    seen = set(vocab)
    while len(vocab) < TOKEN_VOCAB:
        word = "".join(rng.choice(list(letters), rng.randint(2, 8)))
        if rng.rand() < 0.4:
            word = "##" + word
        if word not in seen:
            seen.add(word)
            vocab.append(word)
    return vocab


def synthetic_documents(rng, vocab, n, words):
    """``n`` documents of ``words`` words each, drawn from the vocabulary's
    whole words, with capitals, accented vowels (stripped by the
    tokenizer), punctuation and CJK characters mixed in."""
    whole = [w for w in vocab[5:] if not w.startswith("##") and w.isalpha()
             and len(w) > 1]
    accents = {"a": "á", "e": "é", "i": "ï", "o": "ô", "u": "ü"}
    docs = []
    for _ in range(n):
        out = []
        for _ in range(words):
            w = whole[rng.randint(len(whole))]
            r = rng.rand()
            if r < 0.1:
                w = w.capitalize()
            elif r < 0.2:
                w = "".join(accents.get(c, c) for c in w)
            elif r < 0.25:
                w = "".join(chr(0x4E00 + rng.randint(400))
                            for _ in range(2))
            out.append(w + (rng.choice(list(".,;!?")) if rng.rand() < 0.1
                            else ""))
        docs.append(" ".join(out))
    return docs


def phase_tokenize_bert(torch, seed):
    """Raw text through FasterTokenizer into BERT-base bf16 served by
    inference.Predictor (TOKEN_* above), random weights from the seed.
    Documents longer than 512 wordpieces are truncated to 512 with no
    padding, so no mask is given and every encoder layer's attention takes
    B1 non-causal at (8, 512, 12, 64). Gates: the ids and segment ids the
    tokenizer lands on the card equal those it computes for the host;
    every row of the replayed graph within relative L2 SERVE_TOL of a
    bf16 eager forward; B1 launched 12 times (tc_bf16) in a profiled
    replay, counted by kernel name. Then a batch of short pairs padded to
    TOKEN_PAIR_SEQ with an attention mask: the math path, 0 B1 launches
    in its replay, rows held the same way. Reported: the tokenizer's host
    ms a batch, Predictor.run's ms, the replay's device ms, end-to-end ms
    and documents/s over TOKEN_BATCHES batches, the busy share."""
    import copy

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.text import FasterTokenizer, Vocab
    from paddle_tpu_torch.text.models import BertConfig
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed + 61)
    words = synthetic_vocab(rng)
    vocab = Vocab.from_dict({w: i for i, w in enumerate(words)})
    tok = FasterTokenizer(vocab)
    docs = synthetic_documents(rng, words, TOKEN_DOCS, 700)
    before = pt.get_device()
    pt.set_device("cpu")
    try:
        host_ids = tok(docs, max_seq_len=TOKEN_SEQ)
        pieces = [tok(d)[0].shape[1] - 2 for d in docs]
    finally:
        pt.set_device(before)
    ids, seg = tok(docs, max_seq_len=TOKEN_SEQ)
    ids_equal = (ids.is_cuda and torch.equal(ids.cpu(), host_ids[0])
                 and torch.equal(seg.cpu(), host_ids[1]))
    unk = int((ids == vocab[vocab.unk_token]).sum())
    cfg = BertConfig.base()
    model = bert_model(torch, cfg, seed).eval()
    twin = copy.deepcopy(model).bfloat16().eval()
    with torch.no_grad():
        eager = twin(ids, seg).float().cpu().numpy()
    icfg = infer.Config()
    icfg.set_layer(model)
    icfg.enable_low_precision(infer.DataType.BFLOAT16)
    pred = infer.create_predictor(icfg)
    launch_counts.clear()
    t0 = time.perf_counter()
    got = pred.run([ids.cpu().numpy(), seg.cpu().numpy()])[0]
    warmup_s = time.perf_counter() - t0
    capture_counts = {k: launch_counts[k] for k in KERNEL_NAMES}
    prog = pred._jit_cache[(((TOKEN_DOCS, TOKEN_SEQ), "int64"),) * 2]
    per, softmax = replay_profile(torch, prog.graph)
    gaps = row_gaps(got, eager)
    tok_ms, run_ms, e2e_ms = [], [], []
    for _ in range(TOKEN_BATCHES):
        t1 = time.perf_counter()
        b_ids, b_seg = tok(docs, max_seq_len=TOKEN_SEQ)
        t2 = time.perf_counter()
        pred.run([b_ids.cpu().numpy(), b_seg.cpu().numpy()])
        t3 = time.perf_counter()
        tok_ms.append((t2 - t1) * 1e3)
        run_ms.append((t3 - t2) * 1e3)
        e2e_ms.append((t3 - t1) * 1e3)
    e2e = float(np.median(e2e_ms))
    tc = f"{KERNEL_NAMES[0]}.tc_bf16"
    row = {"phase": "tokenize_bert", "dtype": "bfloat16",
           "config": "BERT-base v30522 h768 L12 a12 d64, raw text -> "
                     "FasterTokenizer(max_seq_len=512), no mask",
           "vocab": len(vocab), "documents": TOKEN_DOCS,
           "wordpieces_per_document": pieces, "unk_ids": unk,
           "ids_shape": list(ids.shape), "ids_on_card_equal_host": ids_equal,
           "warmup_s": warmup_s, "flash_launches_warmup_and_capture":
               capture_counts,
           "replay": per, "softmax_kernels": softmax,
           "tokenizer_ms_p50": float(np.median(tok_ms)),
           "predictor_run_ms_p50": float(np.median(run_ms)),
           "replay_device_ms": per["device_ms"], "e2e_ms_p50": e2e,
           "documents_per_s": TOKEN_DOCS / e2e * 1e3,
           "busy_share": per["device_ms"] / e2e,
           "tokenizer_share": float(np.median(tok_ms)) / e2e,
           "to_bf16_eager_rel_l2_worst": float(gaps.max()),
           "tol": SERVE_TOL}
    emit(row)
    assert ids_equal and min(pieces) > TOKEN_SEQ, row
    assert tuple(ids.shape) == (TOKEN_DOCS, TOKEN_SEQ) and not bool(
        (ids == vocab[vocab.pad_token]).any()), row
    assert np.all(gaps <= SERVE_TOL), row
    assert per["flash_variant_launches"][tc] == cfg.num_layers, row
    assert per["flash_launches"][KERNEL_NAMES[0]] == cfg.num_layers, row
    assert not softmax, row

    # short pairs, padded to TOKEN_PAIR_SEQ, with the mask: the math path
    halves = [d.split() for d in docs]
    first = [" ".join(h[:20]) for h in halves]
    second = [" ".join(h[20:20 + 10 * (i + 1)]) for i, h in
              enumerate(halves)]
    p_ids, p_seg = tok(first, text_pair=second, max_seq_len=TOKEN_PAIR_SEQ,
                       pad_to_max_seq_len=True)
    p_mask = (p_ids != vocab[vocab.pad_token]).to(torch.int64)
    with torch.no_grad():
        p_eager = twin(p_ids, p_seg, p_mask).float().cpu().numpy()
    launch_counts.clear()
    arrays = [t.cpu().numpy() for t in (p_ids, p_seg, p_mask)]
    p_got = pred.run(arrays)[0]
    p_prog = pred._jit_cache[(((TOKEN_DOCS, TOKEN_PAIR_SEQ), "int64"),) * 3]
    p_per, p_softmax = replay_profile(torch, p_prog.graph)
    p_gaps = row_gaps(p_got, p_eager)
    masked = {"phase": "tokenize_bert", "part": "masked_pairs",
              "ids_shape": list(p_ids.shape),
              "padding_share": float((p_mask == 0).float().mean()),
              "flash_launches_warmup_and_capture": {
                  k: launch_counts[k] for k in KERNEL_NAMES},
              "replay": p_per, "softmax_kernels": p_softmax,
              "to_bf16_eager_rel_l2_worst": float(p_gaps.max())}
    emit(masked)
    assert np.all(p_gaps <= SERVE_TOL), masked
    assert not any(p_per["flash_variant_launches"].values()), masked
    assert not any(masked["flash_launches_warmup_and_capture"].values()), \
        masked
    assert p_softmax, masked
    row["masked"] = masked
    del pred, prog, p_prog, model, twin
    gc.collect()
    torch.cuda.empty_cache()
    return row


# -- dist_tune: the autotuner, the fusion policy and data parallelism --------

# the shapes whose tiles the autotune lane prints: (label, (B, S, H, D),
# causal), GPT-medium's training shape, BERT's, and head dim 128
TUNE_SHAPES = (("gpt", (4, 1024, 16, 64), True),
               ("bert", BERT_FLASH_SHAPE, False),
               ("d128", (2, 1024, 16, 128), True),
               ("gpt_dp_rank", (2, 1024, 16, 64), True))
# dp_gpt: ranks on the one card, steps (the first DP_CHECKED held to the
# serial step's losses), and the steps timed after the first
DIST_WORLD, DP_STEPS, DP_CHECKED = 2, 3, 3
# dp_gpt's bounds against the serial step from the same weights: the
# first step's reduced gradient norm, and each of the first DP_CHECKED
# losses (relative). The losses' worst gap measured 1.7e-5 on an H100
# 80GB HBM3 at 700 W; a sum where the mean belongs doubles the norm
DP_GRAD_RTOL, DP_LOSS_RTOL = 1e-3, 1e-3
# dp_fit: LeNet through Model.fit at world size 2, global batch and steps;
# the losses held to one process's fit on the same global batches (f32,
# cuDNN deterministic; the sums run over other batch splits)
DP_FIT_BATCH, DP_FIT_STEPS, DP_FIT_RTOL = 64, 16, 1e-4
# the ResNet-50 layer the fusion lane times fused_conv_bn at: the first
# bottleneck's 3x3 conv, bf16 NHWC at batch 128
CONV_BN_SHAPE = (128, 56, 56, 64)
FUSION_REPS, FUSION_ROUNDS = 10, 6


def autotune_cache_dir():
    """A fresh autotune cache inside the build directory (git-ignored)."""
    from paddle_tpu_torch.ops.cuda import _build
    path = _build.BUILD_DIR / f"autotune-{os.getpid()}-{time.time_ns()}"
    path.mkdir(parents=True)
    return str(path)


def phase_autotune(torch, seed, cache_dir):
    """Every tile of B1, B2 and B3 at TUNE_SHAPES: ptxas's registers and
    spills, its relative L2 to the plain version (the 2^-7 gate) and its
    device ms; then the tuner's search and its winner; then a second
    process over the same cache makes the same decisions with 0 searches
    and at least one disk hit."""
    from paddle_tpu_torch.ops import autotune
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = cache_dir
    autotune.set_tuner(autotune.Autotuner())
    autotune.reset_counters()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, winners = [], {}
    for label, (b, s, h, d), causal in TUNE_SHAPES:
        scale = 1.0 / d ** 0.5
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                                   dtype=torch.float32).to(torch.bfloat16)
                       for _ in range(4))
        out32, lse = fa._fwd_plain(q, k, v, causal, scale)
        want_fwd = out32
        want_bwd = fa.flash_attention_bwd_reference(q, k, v, out32, lse, do,
                                                    causal, scale)
        lse = lse.contiguous()
        delta = fa.bwd_delta(out32, do)
        for kernel in fa.KERNEL_NAMES:
            source, function = fa._TC_FUNCTION[kernel]
            report = _build.kernel_resources(source)
            kept, dropped = fa.tile_candidates(kernel, d)
            for tile in fa.TILES:
                res = report.get((function, (d, tile)), {})
                row = {"phase": "autotune", "shape_label": label,
                       "shape": [b, s, h, d], "causal": causal,
                       "kernel": kernel, "tile": tile, **res,
                       "kept": tile in kept,
                       "dropped_because": dropped.get(tile)}
                if tile in kept:
                    if kernel == fa.KERNEL_NAME:
                        def call(t=tile):
                            return fa._launch(q, k, v, causal, scale,
                                              tile=t)[0]
                        gaps = {"o": rel_l2(call(), want_fwd)}
                        bound = flash_bound(b, s, h, d, "bfloat16", causal)
                    elif kernel == fa.DKV_KERNEL:
                        def call(t=tile):
                            return fa.launch_dkv(q, k, v, do, lse, delta,
                                                 causal, scale, tile=t)
                        dk, dv = call()
                        gaps = {"dk": rel_l2(dk, want_bwd[1]),
                                "dv": rel_l2(dv, want_bwd[2])}
                        bound = flash_bwd_bound(b, s, h, d, "bfloat16",
                                                causal, "dkv")
                    else:
                        def call(t=tile):
                            return fa.launch_dq(q, k, v, do, lse, delta,
                                                causal, scale, tile=t)
                        gaps = {"dq": rel_l2(call(), want_bwd[0])}
                        bound = flash_bwd_bound(b, s, h, d, "bfloat16",
                                                causal, "dq")
                    row.update(rel_l2=gaps, gate=fa.TILE_GATE,
                               ms=device_ms(torch, call),
                               bound_ms=bound[0], bound_by=bound[1])
                    assert all(g <= fa.TILE_GATE for g in gaps.values()), row
                rows.append(row)
        dev = q.device
        fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, causal,
                                   dev)
        bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, causal,
                                   dev)
        winners[label] = {fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
                          fa.DQ_KERNEL: bwd[2], "fwd_blocks": list(fwd),
                          "bwd_blocks": list(bwd)}
        for row in rows:
            if row["shape_label"] == label:
                row["winner"] = row["tile"] == winners[label][row["kernel"]]
                emit(row)
        del q, k, v, do, out32, lse, delta, want_bwd
    first = autotune.counters()
    tuner = autotune.get_tuner()
    # a second process, the same cache: the same answers, no search
    code = ("import json, sys, torch\n"
            "sys.path.insert(0, '.')\n"
            "from paddle_tpu_torch.ops import autotune\n"
            "from paddle_tpu_torch.ops.cuda import flash_attention as fa\n"
            "out = {}\n"
            f"for label, (b, s, h, d), causal in {TUNE_SHAPES!r}:\n"
            "    dev = torch.device('cuda')\n"
            "    f = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16,"
            " causal, dev)\n"
            "    g = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16,"
            " causal, dev)\n"
            "    out[label] = [list(f), list(g)]\n"
            "print(json.dumps({'decisions': out,"
            " 'counters': autotune.counters()}))\n")
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", code], cwd=here,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ,
                               "PADDLE_TPU_AUTOTUNE_CACHE": cache_dir})
    assert proc.returncode == 0, proc.stderr[-3000:]
    second = json.loads(proc.stdout.strip().splitlines()[-1])
    row = {"phase": "autotune_summary", "winners": winners,
           "counters_first_process": first,
           "candidate_errors": tuner.errors,
           "second_process": second}
    emit(row)
    assert first["searches"] >= 1, first
    assert second["counters"]["searches"] == 0, second
    assert second["counters"]["disk_hits"] >= 1, second
    for label, (f, g) in second["decisions"].items():
        assert f == winners[label]["fwd_blocks"] \
            and g == winners[label]["bwd_blocks"], (label, f, g, winners)
    return {"rows": rows, "winners": winners}


def fusion_cases(torch, pt, seed):
    """(op, label, fused fn, unfused fn, operands) at the shapes the models
    call each op with."""
    from paddle_tpu_torch.nn.functional.conv import conv_args, nchw_view
    from paddle_tpu_torch.ops import attention, fused_conv_bn, fused_ffn
    from paddle_tpu_torch.ops import fused_residual_ln as frl
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)
    b, s, hid = TRAIN_BATCH, TRAIN_SEQ, 1024
    eps = 1e-5
    ln = (rand(b, s, hid), rand(b, s, hid), 1.0 + rand(hid, scale=0.1),
          rand(hid, scale=0.1))
    ffn = (rand(b, s, hid), rand(hid, 4 * hid, scale=0.02),
           rand(4 * hid, scale=0.02), rand(4 * hid, hid, scale=0.02),
           rand(hid, scale=0.02))
    n, hh, ww, c = CONV_BN_SHAPE
    x = rand(n, hh, ww, c)
    w = rand(c, c, 3, 3, scale=(2.0 / (9 * c)) ** 0.5)
    xc = nchw_view(x, "NHWC")
    stride, sym, pre, dil = conv_args(xc, w, 1, 1, 1)
    cfg = (stride, sym, pre, dil, 1, True, True)
    conv = (xc, w.contiguous(memory_format=torch.channels_last),
            1.0 + rand(c, scale=0.1), rand(c, scale=0.1))
    cases = [
        ("fused_residual_ln", "gpt_medium",
         lambda *a: frl._FusedResidualLNFn.apply(*a, eps, True),
         lambda *a: frl._fwd_impl(*a, eps)[:2], ln),
        ("fused_ffn", "gpt_medium",
         lambda *a: fused_ffn._FusedFFNFn.apply(*a, "gelu_tanh"),
         lambda *a: fused_ffn._plain(*a, "gelu_tanh"), ffn),
        ("fused_conv_bn", "resnet50_layer1_3x3",
         lambda *a: fused_conv_bn._FusedConvBNFn.apply(*a, cfg, eps)[0],
         lambda *a: fused_conv_bn._fwd_impl(*a, cfg, eps)[0], conv)]
    for label, (bb, ss, h, d), causal in TUNE_SHAPES[:2]:
        qkv = tuple(rand(bb, ss, h, d) for _ in range(3))
        scale = 1.0 / d ** 0.5
        cases.append((
            "flash_attention", label,
            lambda q, k, v, c=causal, sc=scale: attention._flash(q, k, v, c,
                                                                 sc),
            lambda q, k, v, c=causal, sc=scale: attention._math_attention(
                q, k, v, None, sc, c, 0.0, None), qkv))
    return cases


def phase_fusion_policy(torch, seed, cache_dir):
    """Each fused op against its unfused form at the models' shapes, in
    each direction where the forms differ (the three fused ops share one
    forward, so only fwd_bwd; flash against the math path both ways):
    fused and unfused ms (``autotune.measure``: the best of FUSION_REPS
    replays of a captured window of calls after a warm-up, FUSION_ROUNDS
    rounds in alternating order, the median and every round), the factor unfused / fused, the auto decision (the table
    ``_POLICY_FALLBACK``) and the decision of a fresh tuner's search
    (``Autotuner(fusion_search=True)``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import autotune
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = cache_dir
    autotune.set_tuner(autotune.Autotuner())
    searcher = autotune.Autotuner(fusion_search=True)
    rows = []
    for op, label, fused, unfused, args in fusion_cases(torch, pt, seed):
        directions = ("fwd", "fwd_bwd") if op == "flash_attention" \
            else ("fwd_bwd",)
        for direction in directions:
            probe = autotune._grad_probe if direction == "fwd_bwd" \
                else autotune._no_grad_probe
            # alternating rounds (fused, unfused, unfused, fused, ...): the
            # median of each form's rounds, and their spread
            samples = {"fused": [], "unfused": []}
            forms = (("fused", fused), ("unfused", unfused))
            for i in range(FUSION_ROUNDS):
                for name, fn in forms if i % 2 == 0 else forms[::-1]:
                    samples[name].append(autotune.measure(
                        probe(fn), args, warmup=3, reps=FUSION_REPS))
            ms = {k: float(np.median(v)) for k, v in samples.items()}
            factors = [u / f for f, u in zip(samples["fused"],
                                             samples["unfused"])]
            prev = autotune._FORCE_DIRECTION[0]
            autotune._FORCE_DIRECTION[0] = direction
            tuner = autotune.get_tuner()
            try:
                _, choice = autotune.choose_fused(op, fused, unfused, args)
                autotune.set_tuner(searcher)
                _, searched = autotune.choose_fused(op, fused, unfused,
                                                    args)
            finally:
                autotune._FORCE_DIRECTION[0] = prev
                autotune.set_tuner(tuner)
            dt = autotune.short_dtype(args[0].dtype)
            row = {"phase": "fusion_policy", "op": op, "shape_label": label,
                   "shape": list(args[0].shape), "dtype": dt,
                   "direction": direction, "fused_ms": ms["fused"],
                   "unfused_ms": ms["unfused"],
                   "factor_unfused_over_fused": ms["unfused"] / ms["fused"],
                   "factor_rounds": factors,
                   "fused_ms_rounds": samples["fused"],
                   "unfused_ms_rounds": samples["unfused"],
                   "measured_winner": autotune.auto_winner(ms["fused"],
                                                           ms["unfused"]),
                   "auto_decision": choice, "searched_decision": searched}
            emit(row)
            assert choice == autotune.policy_table_choice(op, dt,
                                                          direction), row
            rows.append(row)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# policy_steps: the settings GPT-medium's step is timed under, each as
# (label, FLAGS_fusion_policy, whether the tuner times the fused forms)
POLICY_SETTINGS = (
    ("fused", "always", False),
    ("auto", "auto", False),
    ("searched", "auto", True))
# timed steps a setting and mode (10 until the pipeline group, 5 until
# the layouts group needed the script's time)
POLICY_STEPS, POLICY_WARMUP = 2, 2


def phase_policy_steps(torch, seed):
    """GPT-medium's bf16 training step (bench's 4 x 1024, AdamW mp) under
    each of POLICY_SETTINGS: the fused forms everywhere, auto (the
    table's answers) and the searched auto; POLICY_STEPS eager and
    POLICY_STEPS captured steps after POLICY_WARMUP of warm-up each (the
    second captures), every step's ms
    (the eager step is host-bound, so its spread is shown), the peak of
    the eager steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import autotune
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    xs, ys = bench_stream(seed, 1, TRAIN_BATCH, TRAIN_SEQ)
    x, y = torch.from_numpy(xs[0]).cuda(), torch.from_numpy(ys[0]).cuda()
    flags = pt.get_flags(["FLAGS_fusion_policy", "FLAGS_compiled_step"])
    base = autotune.get_tuner()
    searcher = autotune.Autotuner(fusion_search=True)
    rows = []
    try:
        for label, policy, search in POLICY_SETTINGS:
            pt.set_flags({"FLAGS_fusion_policy": policy})
            autotune.set_tuner(searcher if search else base)
            autotune.reset_counters()
            row = {"phase": "policy_steps", "setting": label}
            for captured in (False, True):
                model = GPTForCausalLM(
                    cfg, device="cuda", dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(seed))
                model.train()
                opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                         multi_precision=True,
                                         parameters=model.parameters())
                pt.set_flags({"FLAGS_compiled_step": captured})
                step = train_step_fn(model, opt)
                for _ in range(POLICY_WARMUP):
                    step(x, y)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms, losses = [], []
                for _ in range(POLICY_STEPS):
                    t0 = time.perf_counter()
                    losses.append(step(x, y))
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                kind = "captured" if captured else "eager"
                row[kind + "_ms_median"] = float(np.median(ms))
                row[kind + "_ms"] = ms
                row[kind + "_peak_mem_bytes"] = \
                    torch.cuda.max_memory_allocated()
                assert all(np.isfinite([v.item() for v in losses])), row
                del model, opt, step
                gc.collect()
                torch.cuda.empty_cache()
            c = autotune.counters()
            row["decisions"] = {k: c[k] for k in ("policy_fused",
                                                  "policy_unfused",
                                                  "searches")}
            emit(row)
            rows.append(row)
    finally:
        pt.set_flags(flags)
        autotune.set_tuner(base)
    return rows


def grad_fingerprint(torch, model):
    """The norm (float64) of every parameter's gradient together, and a
    SHA-1 of their bytes in parameter order."""
    import hashlib
    h = hashlib.sha1()
    total = torch.zeros((), dtype=torch.float64, device="cuda")
    for _, p in sorted(model.named_parameters()):
        g = p.grad.detach()
        total += g.double().pow(2).sum()
        h.update(g.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return {"grad_norm": total.sqrt().item(), "grad_sha": h.hexdigest()}


def param_sha(torch, model):
    import hashlib
    h = hashlib.sha1()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def serial_steps(torch, model, make_opt, xs, ys, first_grads=None):
    """Eager steps of ``model`` on the batches (numpy, one a step) under
    ``make_opt(parameters=...)``: the serial reference that the
    data-parallel and hybrid lanes are held to. Returns the losses, step
    ms and, where ``first_grads`` is given, what it returns on the first
    step's gradients."""
    opt = make_opt(parameters=model.parameters())
    losses, step_ms, first = [], [], None
    for i, (x, y) in enumerate(zip(xs, ys)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(torch.from_numpy(x).cuda(),
                     labels=torch.from_numpy(y).cuda())
        loss.backward()
        if i == 0 and first_grads is not None:
            first = first_grads(model)
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": step_ms, "first_grads": first}


@functools.lru_cache(maxsize=None)
def serial_gpt_losses(torch, seed):
    """GPT-medium bf16, AdamW(multi_precision), the whole 4 x 1024 batch
    of bench's stream, DP_CHECKED eager steps on this process: the losses
    and the first step's gradient norm the data-parallel run is held
    to. Run once a seed: dp_gpt, zero_gpt and pp_compiled share it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    xs, ys = bench_stream(seed, DP_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    run = serial_steps(
        torch, model.train(), functools.partial(
            pt.optimizer.AdamW, learning_rate=1e-4, multi_precision=True),
        xs[:DP_CHECKED], ys[:DP_CHECKED],
        lambda m: grad_fingerprint(torch, m)["grad_norm"])
    del model
    free_cuda(torch)
    return {"losses": run["losses"], "grad_norm": run["first_grads"]}


def rank_collectives(torch, dist, rank, world):
    """The collectives on CUDA tensors over the gloo group of the ranks on
    one card (all_reduce and broadcast take them as they are; the others
    are staged through the host)."""
    cuda = torch.device("cuda")
    res = {}
    t = torch.arange(6, dtype=torch.float32, device=cuda).reshape(2, 3) \
        * (rank + 1)
    res["all_reduce_sum"] = dist.all_reduce(t).tolist()
    t = torch.full((4,), float(rank), device=cuda)
    res["all_reduce_max"] = dist.all_reduce(
        t, op=dist.ReduceOp.MAX).tolist()
    t = torch.full((8,), float(rank + 1), device=cuda, dtype=torch.bfloat16)
    res["all_reduce_bf16"] = dist.all_reduce(t).float().tolist()
    t = torch.full((3,), float(rank * 10 + 7), device=cuda)
    res["broadcast"] = dist.broadcast(t, src=1).tolist()
    lst = []
    dist.all_gather(lst, torch.full((2,), float(rank), device=cuda))
    res["all_gather"] = [x.tolist() for x in lst]
    t = torch.arange(2 * world, dtype=torch.float32, device=cuda) + rank
    res["reduce_scatter"] = dist.reduce_scatter(t).tolist()
    t = torch.tensor([[rank * 10.0 + i] for i in range(world)], device=cuda)
    res["alltoall"] = dist.alltoall(t).reshape(-1).tolist()
    res["devices"] = sorted({str(x.device) for x in lst})
    return res


def rank_dp_gpt(torch, pt, dist, seed, rank, world):
    """GPT-medium bf16 under DataParallel: this rank's rows of bench's
    4 x 1024 batch, AdamW(multi_precision), DP_STEPS eager steps (the
    Reducer's collectives cannot be captured). Returns the global losses
    (the ranks' mean), the first step's reduced gradients' norm and SHA-1,
    the weights' SHA-1 after the steps, step ms, buckets, collective_wait,
    B1-B3 launches and their tiles, peak memory and the busy share of one
    profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    per = TRAIN_BATCH // world
    xs, ys = bench_stream(seed, DP_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    xs = torch.from_numpy(xs[:, rank * per:(rank + 1) * per]).cuda()
    ys = torch.from_numpy(ys[:, rank * per:(rank + 1) * per]).cuda()
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    dp = pt.DataParallel(model)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    reducer = dp._reducer

    first = {}

    def step(i):
        loss = dp(xs[i], labels=ys[i])
        loss.backward()
        if not first:
            first.update(grad_fingerprint(torch, model))
        opt.step()
        opt.clear_grad()
        g = loss.detach().float().reshape(1).clone()
        return dist.all_reduce(g, op=dist.ReduceOp.AVG).item()

    losses, step_ms, launches, flushes = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(DP_STEPS):
        if i == 1:
            steptimer.reset_steptimer()
        launch_counts.clear()
        f0 = reducer.flushes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(i))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: launch_counts[k] for k in launch_counts
                         if k.split(".")[0] in fa.KERNEL_NAMES})
        flushes.append(reducer.flushes - f0)
    weights = param_sha(torch, model)
    timed = DP_STEPS - 1
    wait_ms = steptimer.get_steptimer().breakdown()["phase_ms"].get(
        "collective_wait", 0.0) / timed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    b, s, h, d = per, TRAIN_SEQ, cfg.num_heads, cfg.hidden_size \
        // cfg.num_heads
    dev = torch.device("cuda")
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    return {"losses": losses, **first, "param_sha": weights,
            "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms[1:])),
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
            / (float(np.median(step_ms[1:])) / 1e3),
            "buckets": len(reducer.buckets),
            "bucket_flushes_per_step": flushes,
            "collective_wait_ms_per_step": wait_ms,
            "launches_per_step": launches,
            "tiles": {fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
                      fa.DQ_KERNEL: bwd[2]},
            "profiled_step_ms": wall,
            "busy_share": device_busy(prof) / wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def rank_dp_fit(torch, pt, seed, rank, world):
    """LeNet through Model.fit at world size 2: each rank's loader takes
    its shard of the global batches (DistributedBatchSampler); returns the
    global loss of each step (the ranks' mean) and the device launches of
    the flash kernels (none)."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.vision.datasets import MNIST
    data = pt.io.Subset(MNIST(mode="train"),
                        list(range(DP_FIT_BATCH * DP_FIT_STEPS)))
    model = hapi_lenet_model(pt, seed, "cuda")
    log = loss_log(pt)
    launch_counts.clear()
    with cudnn_deterministic(torch):
        model.fit(data, batch_size=DP_FIT_BATCH // world, epochs=1,
                  shuffle=False, verbose=0, callbacks=[log])
    local = torch.tensor(log.losses, device="cuda")
    pt.distributed.all_reduce(local, op=pt.distributed.ReduceOp.AVG)
    return {"losses": local.tolist(), "wrapped":
            type(model.network).__name__,
            "launches": {k: launch_counts[k] for k in KERNEL_NAMES}}


def dist_rank_main(torch, args):
    """One rank of the dist_tune group's data-parallel lanes (a child
    process of phase_dist): the collectives, dp_gpt and dp_fit, written
    to ``args.dist_out`` as JSON."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env as denv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "world": world, "backend": denv.backend(),
           "device": str(denv.device())}
    out["collectives"] = rank_collectives(torch, dist, rank, world)
    out["dp_gpt"] = rank_dp_gpt(torch, pt, dist, args.seed, rank, world)
    gc.collect()
    torch.cuda.empty_cache()
    out["dp_fit"] = rank_dp_fit(torch, pt, args.seed, rank, world)
    from paddle_tpu_torch.ops import autotune
    out["autotune_counters"] = autotune.counters()
    with open(args.dist_out, "w") as f:
        json.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist(torch, seed, cache_dir):
    """dp_gpt, dp_fit and the gloo collectives: DIST_WORLD rank processes
    on the one card (gloo over CUDA tensors: NCCL refuses two ranks on one
    device), each running dist_rank_main, held to this process's serial
    runs; their tiles come from the autotune lane's cache, their fusion
    decisions from the table. The ranks start first, the serial runs
    follow on this process while they run."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.datasets import MNIST
    here = os.path.dirname(os.path.abspath(__file__))
    addr = f"localhost:{free_port()}"
    outs = [os.path.join(cache_dir, f"rank{r}.json")
            for r in range(DIST_WORLD)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(DIST_WORLD):
            env = {**os.environ, "PADDLE_TRAINER_ID": str(r),
                   "PADDLE_TRAINERS_NUM": str(DIST_WORLD),
                   "PADDLE_COORDINATOR_ADDR": addr,
                   "PADDLE_TPU_AUTOTUNE_CACHE": cache_dir}
            with open(rank_log(outs[r]), "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--seed",
                     str(seed), "--dist-rank", str(r), "--dist-out",
                     outs[r]], cwd=here, env=env, stdout=f,
                    stderr=subprocess.STDOUT, text=True))
        # the serial runs on this process while the ranks run
        serial = serial_gpt_losses(torch, seed)
        # one process's fit on the same global batches
        data = pt.io.Subset(MNIST(mode="train"),
                            list(range(DP_FIT_BATCH * DP_FIT_STEPS)))
        model = hapi_lenet_model(pt, seed, "cuda")
        log = loss_log(pt)
        with cudnn_deterministic(torch):
            model.fit(data, batch_size=DP_FIT_BATCH, epochs=1,
                      shuffle=False, verbose=0, callbacks=[log])
        serial_fit = log.losses
        del model
        # a rank that fails ends the others (they would wait on it)
        deadline = time.perf_counter() + 600
        while any(p.poll() is None for p in procs) and \
                not any(p.poll() for p in procs) and \
                time.perf_counter() < deadline:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(rank_log(outs[r])) as f:
                raise AssertionError((r, p.returncode, f.read()[-4000:]))
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return serial, serial_fit, ranks, seconds


def check_dist(serial, serial_fit, ranks, seconds):
    """The dist lanes' rows and gates: collectives against numpy; dp_gpt's
    reduced gradients and weights the same on both ranks, its gradient
    norm and losses against the serial step's, B1-B3 once a layer a step
    on every rank; dp_fit against the serial fit."""
    world = len(ranks)
    base = np.arange(6, dtype="float32").reshape(2, 3)
    want = {
        "all_reduce_sum": sum(base * (r + 1) for r in range(world)).tolist(),
        "all_reduce_max": [world - 1.0] * 4,
        "all_reduce_bf16": [world * (world + 1) / 2.0] * 8,
        "broadcast": [17.0] * 3,
        "all_gather": [[float(i)] * 2 for i in range(world)]}
    full = sum(np.arange(2 * world, dtype="float32") + j
               for j in range(world))
    for r, res in enumerate(ranks):
        got = res["collectives"]
        row = {"phase": "collectives", "backend": res["backend"],
               "rank": r, "device": res["device"], **got}
        emit(row)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=k)
        np.testing.assert_allclose(got["reduce_scatter"],
                                   full[r * 2:(r + 1) * 2])
        np.testing.assert_allclose(got["alltoall"],
                                   [j * 10.0 + r for j in range(world)])
        assert res["backend"] == "gloo" and res["device"].startswith(
            "cuda"), res
    dp = [res["dp_gpt"] for res in ranks]
    gaps = [abs(a - b) / abs(b)
            for a, b in zip(dp[0]["losses"], serial["losses"])]
    grad_gap = abs(dp[0]["grad_norm"] - serial["grad_norm"]) \
        / serial["grad_norm"]
    row = {"phase": "dp_gpt", "world": world, "backend": ranks[0]["backend"],
           "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64 bf16, "
                     f"AdamW mp",
           "global_batch": [TRAIN_BATCH, TRAIN_SEQ],
           "serial_losses": serial["losses"], "dp_losses": dp[0]["losses"],
           "loss_rel_gaps": gaps, "loss_rtol": DP_LOSS_RTOL,
           "serial_grad_norm": serial["grad_norm"],
           "grad_norm_rel_gap": grad_gap, "grad_rtol": DP_GRAD_RTOL,
           "seconds_ranks": seconds,
           **{f"rank{r}": d for r, d in enumerate(dp)},
           "autotune_counters": [res["autotune_counters"] for res in ranks]}
    emit(row)
    # every rank applies the same reduced gradients, so the ranks' weights
    # stay equal to the bit; a rank that skipped a reduce breaks both
    assert dp[0]["grad_sha"] == dp[1]["grad_sha"], "reduced grads differ"
    assert dp[0]["param_sha"] == dp[1]["param_sha"], "weights differ"
    assert grad_gap <= DP_GRAD_RTOL, grad_gap
    assert max(gaps) <= DP_LOSS_RTOL, gaps
    for d in dp:
        for counts in d["launches_per_step"]:
            for kernel in ("flash_attn_fwd", "flash_attn_bwd_dkv",
                           "flash_attn_bwd_dq"):
                assert counts.get(f"{kernel}.tc_bf16", 0) == GPT_LAYERS, \
                    counts
        assert d["tiles"] == dp[0]["tiles"], (d["tiles"], dp[0]["tiles"])
    # the autotune lane's cache answered every rank's tiles
    for res in ranks:
        assert res["autotune_counters"]["searches"] == 0, res
        assert res["autotune_counters"]["disk_hits"] >= 1, res
    fit = [res["dp_fit"] for res in ranks]
    fit_gaps = [abs(a - b) / abs(b)
                for a, b in zip(fit[0]["losses"], serial_fit)]
    row = {"phase": "dp_fit", "world": world, "model": "LeNet",
           "global_batch": DP_FIT_BATCH, "steps": DP_FIT_STEPS,
           "serial_losses": serial_fit, "dp_losses": fit[0]["losses"],
           "loss_rel_gaps": fit_gaps, "loss_rtol": DP_FIT_RTOL,
           "wrapped": fit[0]["wrapped"], "launches": fit[0]["launches"]}
    emit(row)
    assert len(fit[0]["losses"]) == DP_FIT_STEPS == len(serial_fit), row
    assert max(fit_gaps) <= DP_FIT_RTOL, fit_gaps
    assert fit[0]["wrapped"] == "DataParallel", fit[0]
    return dp, fit


def phase_nccl_single(torch):
    """Every collective over a one-rank NCCL group on this card, against
    numpy: the NCCL backend runs (at world size 1 each result is the
    input, or its one chunk)."""
    import torch.distributed as tdist

    import paddle_tpu_torch.distributed as dist
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:"
                             f"{free_port()}", world_size=1, rank=0)
    try:
        cuda = torch.device("cuda")
        x = torch.arange(6, dtype=torch.float32, device=cuda).reshape(2, 3)
        res = {"backend": tdist.get_backend()}
        res["all_reduce"] = dist.all_reduce(x.clone()).tolist()
        res["all_reduce_max"] = dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX).tolist()
        res["broadcast"] = dist.broadcast(x.clone(), src=0).tolist()
        lst = []
        dist.all_gather(lst, x.clone())
        res["all_gather"] = [t.tolist() for t in lst]
        res["reduce"] = dist.reduce(x.clone(), dst=0).tolist()
        res["reduce_scatter"] = dist.reduce_scatter(x.clone()).tolist()
        res["alltoall"] = dist.alltoall(x.clone()[None]).tolist()
        out = torch.empty_like(x)
        res["scatter"] = dist.scatter(out, [x.clone()], src=0).tolist()
        dist.barrier()
        emit({"phase": "collectives_nccl", **res})
        want = x.tolist()
        for k in ("all_reduce", "all_reduce_max", "broadcast", "reduce",
                  "reduce_scatter", "scatter"):
            assert res[k] == want, (k, res[k])
        assert res["all_gather"] == [want] and res["alltoall"] == [want]
        assert res["backend"] == "nccl", res
    finally:
        tdist.destroy_process_group()


# -- hybrid: fleet's tensor parallelism and ZeRO-1 -----------------------------

# tp_gpt: GPT-3 1.3B (GPTConfig.gpt3_1p3b) at mp 2 over HYBRID_WORLD rank
# processes on the one card (gloo over CUDA tensors), bench's 1.3B batch
# (bench.py:929-934, 2 x 1024), TP_STEPS steps (the first TP_CHECKED held
# to the serial run's); greedy decode of PROMPTS x PROMPT_LEN plus
# TP_DECODE_STEPS cached steps in f32, where a random 1.3B's top two
# logits sit closer than bf16's rounding of 24 layers
HYBRID_WORLD, TP_STEPS, TP_CHECKED, TP_BATCH = 2, 3, 3, 2
TP_DECODE_STEPS = 8
# tp_gpt, pp_gpt and their serial runs take the 1.3B at HYBRID_LAYERS of
# its 24 layers, at full width (cut from 24, then 12, for the script's
# time, PERF.md section 4)
HYBRID_LAYERS = 6
# hybrid_geometry: the 1.3B layer geometry at GEOM_LAYERS layers in f32,
# SGD, dp 2 x mp 2 on GEOM_WORLD processes against the serial steps
# (__graft_entry__.py:160-216, 5e-4 relative); its batch takes B1-B3
GEOM_WORLD, GEOM_LAYERS, GEOM_BATCH, GEOM_SEQ = 4, 2, 4, 256
GEOM_STEPS, GEOM_RTOL, GEOM_LR = 2, 5e-4, 1e-3
# zero_gpt: GPT-medium (the dp_gpt lane's model) at sharding_degree
# HYBRID_WORLD, bench's 4 x 1024 split 2 x 1024 a rank, DP_STEPS steps; the
# first DP_CHECKED losses within DP_LOSS_RTOL of the serial run


def fleet_init(hybrid, micro=1):
    """fleet.init with ``hybrid`` over the strategy's hybrid_configs and
    ``micro`` micro-batches a pipeline batch; returns (fleet, the hybrid
    communicate group)."""
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {**strategy.hybrid_configs, **hybrid}
    strategy.pipeline_configs = {"accumulate_steps": micro}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet, fleet.get_hybrid_communicate_group()


def gpt_1p3b(torch, dtype, seed=None, tp=False, layers=HYBRID_LAYERS):
    """GPT-3 1.3B (vocab 50304, hidden 2048, 16 heads of 128) at ``layers``
    of its 24 layers and bench's 1024 positions; ``seed`` draws the
    weights from a CUDA
    generator (the same numbers in every process), None from torch's
    default one (a TP model whose shards are loaded next)."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.gpt3_1p3b(dropout=0.0, max_position_embeddings=TRAIN_SEQ,
                              tensor_parallel=tp)
    cfg.num_layers = layers
    gen = None if seed is None else \
        torch.Generator(device="cuda").manual_seed(seed)
    return GPTForCausalLM(cfg, device="cuda", dtype=dtype, generator=gen)


def prompt_ids(torch, seed, vocab):
    return torch.randint(0, vocab, (PROMPTS, PROMPT_LEN),
                         generator=torch.Generator().manual_seed(seed + 1)
                         ).to("cuda")


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


def serial_1p3b(torch, seed):
    """The serial runs tp_gpt is held to, on this process from the same
    weights: greedy tokens in f32; TP_CHECKED eager steps of bf16 with
    AdamW(multi_precision) and of f32 with AdamW on bench's stream."""
    import paddle_tpu_torch as pt
    full = gpt_1p3b(torch, torch.float32, seed).eval()
    with torch.inference_mode():
        tokens = greedy(torch, full, prompt_ids(torch, seed, 50304),
                        TP_DECODE_STEPS)[0].tolist()
    model = gpt_1p3b(torch, torch.bfloat16).train()
    pt.load_numpy_state_dict(model, full.state_dict())
    xs, ys = bench_stream(seed, TP_CHECKED, TP_BATCH, TRAIN_SEQ)
    adamw = functools.partial(pt.optimizer.AdamW, learning_rate=1e-4)
    out = {"tokens": tokens,
           "bfloat16": serial_steps(torch, model, functools.partial(
               adamw, multi_precision=True), xs, ys)}
    del model
    free_cuda(torch)
    out["float32"] = serial_steps(torch, full.train(), adamw, xs, ys)
    del full
    free_cuda(torch)
    return out


def serial_geometry(torch, seed):
    """The serial f32 SGD steps hybrid_geometry is held to."""
    import paddle_tpu_torch as pt
    model = gpt_1p3b(torch, torch.float32, seed, layers=GEOM_LAYERS).train()
    xs, ys = bench_stream(seed, GEOM_STEPS, GEOM_BATCH, GEOM_SEQ)
    run = serial_steps(torch, model, functools.partial(
        pt.optimizer.SGD, learning_rate=GEOM_LR), xs, ys)
    del model
    free_cuda(torch)
    return run["losses"]


def replicated_sha(torch, model):
    """SHA-1 of the parameters every model rank holds whole."""
    import hashlib
    h = hashlib.sha1()
    for _, p in sorted(model.named_parameters()):
        if getattr(p, "tp_split", None) is None:
            h.update(p.detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


def collective_tally(entries):
    """{op: [count, bytes]} of the flight recorder's entries."""
    sizes = {"torch.bfloat16": 2, "torch.float16": 2, "torch.float32": 4,
             "torch.int64": 8, "torch.int32": 4}
    out = {}
    for e in entries:
        n = sum(int(np.prod(s)) * sizes.get(d, 4)
                for s, d in zip(e["shapes"] or (), e["dtypes"] or ()))
        tally = out.setdefault(e["op"], [0, 0])
        tally[0] += 1
        tally[1] += n
    return out


def flash_launches(fa, launch_counts):
    return {k: launch_counts[k] for k in launch_counts
            if k.split(".")[0] in fa.KERNEL_NAMES}


def rank_tp_gpt(torch, seed):
    """tp_gpt on this rank: the full f32 weights drawn and sharded, greedy
    decode in f32, a bf16 prefill, then TP_STEPS eager bf16 steps through
    fleet.distributed_model / distributed_optimizer (AdamW mp, lr 1e-4).
    Returns the tokens, the losses, the replicated parameters' SHA-1
    after each step, step ms, step/collective_wait a step, the
    collectives a step (count and bytes), B1-B3 launches a step and
    their tiles, peak memory, busy share of one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    from paddle_tpu_torch.resilience.recorder import get_recorder
    fleet, hcg = fleet_init({"mp_degree": HYBRID_WORLD})
    full = gpt_1p3b(torch, torch.float32, seed)
    tp32 = gpt_1p3b(torch, torch.float32, tp=True).eval()
    pt.load_numpy_state_dict(tp32, full.state_dict())
    del full
    free_cuda(torch)
    ids = prompt_ids(torch, seed, 50304)
    launch_counts.clear()
    with torch.inference_mode():
        toks, _, ttft, decode_s = greedy(torch, tp32, ids, TP_DECODE_STEPS)
    greedy_f32_launches = flash_launches(fa, launch_counts)
    model = gpt_1p3b(torch, torch.bfloat16, tp=True).eval()
    pt.load_numpy_state_dict(model, tp32.state_dict())
    del tp32
    free_cuda(torch)
    with torch.inference_mode():
        model(ids, caches=model.gpt.init_decode_caches())     # warm-up
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(ids, caches=model.gpt.init_decode_caches())
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = flash_launches(fa, launch_counts)
    model.train()
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, multi_precision=True,
        parameters=model.parameters()))
    xs, ys = bench_stream(seed, TP_STEPS, TP_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    rec = get_recorder()
    losses, shas, step_ms, launches, comms = [], [], [], [], []
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for i in range(TP_STEPS):
        if i == 1:
            steptimer.reset_steptimer()
        launch_counts.clear()
        rec.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = dist_model(xs[i], labels=ys[i])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_launches(fa, launch_counts))
        comms.append(collective_tally(rec.entries()))
        shas.append(replicated_sha(torch, model))
    peak = torch.cuda.max_memory_allocated()
    wait_ms = steptimer.get_steptimer().breakdown()["phase_ms"].get(
        "collective_wait", 0.0) / (TP_STEPS - 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dist_model(xs[0], labels=ys[0]).backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {k: sum(1 for e in prof.events()
                      if is_kernel(e) and name in e.name)
               for k, name in TC_KERNEL_NAMES.items()}
    b, s, h, d = TP_BATCH, TRAIN_SEQ, 16 // HYBRID_WORLD, 128
    dev = torch.device("cuda")
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    inner = opt._inner
    local = sum(p.numel() for p in model.parameters())
    state = sum(t.numel() * t.element_size()
                for accs in inner._accumulators.values()
                for t in accs.values())
    return {"tokens": toks.tolist(), "ttft_s": ttft,
            "decode_step_ms": decode_s / TP_DECODE_STEPS * 1e3,
            "prefill_bf16_ms": prefill_ms,
            "prefill_launches": prefill_launches,
            "greedy_f32_launches": greedy_f32_launches,
            "losses": losses, "replicated_sha": shas, "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms[1:])),
            "tokens_per_s": TP_BATCH * TRAIN_SEQ
            / (float(np.median(step_ms[1:])) / 1e3),
            "collective_wait_ms_per_step": wait_ms,
            "collectives_per_step": comms, "launches_per_step": launches,
            "tiles": {fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
                      fa.DQ_KERNEL: bwd[2]},
            "local_params": local, "optimizer_state_bytes": state,
            "profiled_step_ms": wall,
            "profiled_tc_launches_by_kernel_name": by_name,
            "busy_share": device_busy(prof) / wall,
            "peak_mem_bytes": peak,
            "wrapped": [type(dist_model).__name__, type(opt).__name__]}


def rank_zero_gpt(torch, seed):
    """zero_gpt on this rank: GPT-medium bf16 under ZeRO-1 (sharding
    degree HYBRID_WORLD, AdamW mp), this rank's 2 x 1024 of bench's
    4 x 1024; global losses, the weights' SHA-1 after each step, step ms,
    optimizer-state bytes, parameters owned, peak memory."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    fleet, hcg = fleet_init({"sharding_degree": HYBRID_WORLD})
    rank, world = hcg.get_sharding_parallel_rank(), HYBRID_WORLD
    per = TRAIN_BATCH // world
    xs, ys = bench_stream(seed, DP_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    xs = torch.from_numpy(xs[:, rank * per:(rank + 1) * per]).cuda()
    ys = torch.from_numpy(ys[:, rank * per:(rank + 1) * per]).cuda()
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, multi_precision=True,
        parameters=model.parameters()))
    group = hcg.get_dp_sharding_parallel_group()
    losses, shas, step_ms, launches = [], [], [], []
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for i in range(DP_STEPS):
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = dist_model(xs[i], labels=ys[i])
        loss.backward()
        opt.step()
        opt.clear_grad()
        g = loss.detach().float().reshape(1).clone()
        losses.append(dist.all_reduce(g, op=dist.ReduceOp.AVG,
                                      group=group).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_launches(fa, launch_counts))
        shas.append(param_sha(torch, model))
    inner = opt._inner._inner
    state = sum(t.numel() * t.element_size()
                for accs in inner._accumulators.values()
                for t in accs.values())
    owned = opt._inner.owned_parameters
    return {"losses": losses, "param_sha": shas, "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms[1:])),
            "launches_per_step": launches,
            "optimizer_state_bytes": state,
            "owned_params": len(owned),
            "owned_elements": sum(p.numel() for p in owned),
            "all_elements": sum(p.numel() for p in model.parameters()),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "wrapped": [type(dist_model).__name__, type(opt).__name__,
                        type(opt._inner).__name__]}


def rank_geometry(torch, seed):
    """hybrid_geometry on this rank: the 1.3B geometry at GEOM_LAYERS
    layers, f32, SGD, dp 2 x mp 2, this data rank's rows; the global
    losses and the flash launches of the first step."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    fleet, hcg = fleet_init({"dp_degree": 2, "mp_degree": 2})
    full = gpt_1p3b(torch, torch.float32, seed, layers=GEOM_LAYERS)
    model = gpt_1p3b(torch, torch.float32, tp=True, layers=GEOM_LAYERS)
    pt.load_numpy_state_dict(model, full.state_dict())
    del full
    free_cuda(torch)
    model.train()
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=GEOM_LR, parameters=model.parameters()))
    d, per = hcg.get_data_parallel_rank(), GEOM_BATCH // 2
    xs, ys = bench_stream(seed, GEOM_STEPS, GEOM_BATCH, GEOM_SEQ)
    losses, launches = [], []
    for i in range(GEOM_STEPS):
        launch_counts.clear()
        loss = dist_model(torch.from_numpy(xs[i, d * per:(d + 1) * per])
                          .cuda(), labels=torch.from_numpy(
                              ys[i, d * per:(d + 1) * per]).cuda())
        loss.backward()
        opt.step()
        opt.clear_grad()
        g = loss.detach().reshape(1).clone()
        losses.append(dist.all_reduce(
            g, op=dist.ReduceOp.AVG,
            group=hcg.get_data_parallel_group()).item())
        launches.append(flash_launches(fa, launch_counts))
    return {"losses": losses, "launches_per_step": launches,
            "coords": [hcg.get_data_parallel_rank(),
                       hcg.get_model_parallel_rank()],
            "wrapped": [type(dist_model).__name__, type(opt).__name__]}


def hybrid_rank_main(torch, args):
    """One rank of the hybrid, pipeline, layouts and auto_moe groups'
    lanes (a child process of phase_hybrid, phase_pipeline, phase_layouts
    or phase_auto_moe): tp_gpt then zero_gpt, hybrid_geometry, pp_gpt then
    hybrid_ckpt, pp_compiled, zero3_gpt, ring_attn and spmd_pipe, or
    auto_engine and moe_ep, written to ``args.dist_out`` as JSON."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.ops import autotune
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank that hangs in a collective shows where, in its log
    faulthandler.dump_traceback_later(RANK_STACK_DUMP_S, repeat=True)
    dist.init_parallel_env()
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": denv.backend(), "device": str(denv.device())}
    if args.hybrid_lane == "tp_zero":
        out["tp_gpt"] = rank_tp_gpt(torch, args.seed)
        free_cuda(torch)
        out["zero_gpt"] = rank_zero_gpt(torch, args.seed)
    elif args.hybrid_lane == "geometry":
        out["geometry"] = rank_geometry(torch, args.seed)
    elif args.hybrid_lane == "pp_ckpt":
        out["pp_gpt"] = rank_pp_gpt(torch, args.seed)
        free_cuda(torch)
        out["hybrid_ckpt"] = rank_hybrid_ckpt(
            torch, args.seed, os.environ["PADDLE_TPU_AUTOTUNE_CACHE"])
    elif args.hybrid_lane == "auto_moe":
        out.update(rank_auto_moe(torch, args.seed,
                                 os.environ["PADDLE_TPU_AUTOTUNE_CACHE"]))
    elif args.hybrid_lane == "layouts":
        out["zero3_gpt"] = rank_zero3_gpt(
            torch, args.seed, os.environ["PADDLE_TPU_AUTOTUNE_CACHE"])
        free_cuda(torch)
        out["ring_attn"] = rank_ring_attn(torch, args.seed)
        free_cuda(torch)
        out["spmd_pipe"] = rank_spmd_pipe(torch, args.seed)
    else:
        out["pp_compiled"] = rank_pp_compiled(torch, args.seed)
    out["autotune_counters"] = autotune.counters()
    with open(args.dist_out, "w") as f:
        json.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


RANK_STACK_DUMP_S, STACK_DUMP_S = 120, 1140


def start_ranks(world, seed, lane, cache_dir):
    """``world`` rank processes of this script on the card (gloo over
    CUDA tensors), each running hybrid_rank_main's ``lane``: started, not
    waited for (join_ranks), each writing its output to a log file beside
    its result."""
    here = os.path.dirname(os.path.abspath(__file__))
    addr = f"localhost:{free_port()}"
    outs = [os.path.join(cache_dir, f"{lane}-rank{r}.json")
            for r in range(world)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            env = {**os.environ, "PADDLE_TRAINER_ID": str(r),
                   "PADDLE_TRAINERS_NUM": str(world),
                   "PADDLE_COORDINATOR_ADDR": addr,
                   "PADDLE_TPU_AUTOTUNE_CACHE": cache_dir}
            with open(rank_log(outs[r]), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--seed",
                     str(seed), "--hybrid-lane", lane, "--dist-out",
                     outs[r]], cwd=here, env=env, stdout=log,
                    stderr=subprocess.STDOUT, text=True))
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return procs, outs, t0


def rank_log(out_path):
    return out_path[:-len(".json")] + ".log"


def end_ranks(*starts):
    """Kill the processes of started rank sets that still run."""
    for procs, _, _ in starts:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def join_together(starts, timeout=900):
    """join_ranks over rank sets started to run side by side, in turn; a
    failure of one (or its timeout) ends the others too. Returns each
    set's (results, seconds): a set's seconds run from its start to its
    join, so a set that ends before the one joined first reads that
    one's end."""
    done = []
    try:
        for started in starts:
            done.append(join_ranks(started, timeout))
    except BaseException:
        end_ranks(*starts)
        raise
    return done


def join_ranks(started, timeout=900):
    """start_ranks' second half: wait for the processes and read their
    results. A rank that fails ends the others at once (they would wait
    on it in a collective), as does the timeout; the failure names each
    rank's exit code and the tail of its log."""
    procs, outs, t0 = started
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p in procs) and \
                not any(p.poll() for p in procs) and \
                time.perf_counter() < deadline:
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    failed = []
    for r, (p, path) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            with open(rank_log(path)) as f:
                failed.append((r, p.returncode, f.read()[-4000:]))
    assert not failed, failed
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks, seconds


def phase_hybrid(torch, seed, beside=None):
    """tp_gpt, zero_gpt and hybrid_geometry: the serial runs on this
    process, freed before the rank processes start: HYBRID_WORLD ranks
    for tp_gpt then zero_gpt and, beside them, GEOM_WORLD for
    hybrid_geometry, with ``beside()`` (the surface group) on this
    process while they run."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    seconds = {}
    t0 = time.perf_counter()
    serial = {"tp": serial_1p3b(torch, seed),
              "zero": serial_gpt_losses(torch, seed),
              "geometry": serial_geometry(torch, seed)}
    seconds["serial"] = time.perf_counter() - t0
    cache_dir = autotune_cache_dir()
    started = start_ranks(HYBRID_WORLD, seed, "tp_zero", cache_dir)
    geo_started = start_ranks(GEOM_WORLD, seed, "geometry", cache_dir)
    besides, seconds["beside"] = run_beside(beside, started, geo_started)
    (ranks, seconds["tp_gpt_zero_gpt"]), \
        (geometry, seconds["hybrid_geometry"]) = join_together(
            [started, geo_started])
    tp = [r["tp_gpt"] for r in ranks]
    sb, sf = serial["tp"]["bfloat16"], serial["tp"]["float32"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(tp[0]["losses"],
                                                sb["losses"])]
    bounds = [BF16_GRAD_FACTOR * abs(b - f) / abs(f) + BF16_GRAD_SLACK
              for b, f in zip(sb["losses"], sf["losses"])]
    kernels = (fa.KERNEL_NAME, fa.DKV_KERNEL, fa.DQ_KERNEL)
    row = {"phase": "tp_gpt", "world": HYBRID_WORLD,
           "backend": ranks[0]["backend"],
           "config": f"GPT-3 1.3B v50304 h2048 L{HYBRID_LAYERS} of 24 a16 "
                     f"d128 bf16, AdamW mp, mp 2 (8 heads a rank)",
           "global_batch": [TP_BATCH, TRAIN_SEQ],
           "serial_bf16_losses": sb["losses"],
           "serial_f32_losses": sf["losses"],
           "serial_bf16_step_ms": sb["step_ms"],
           "tp_losses": tp[0]["losses"], "loss_rel_gaps": gaps,
           "loss_bounds": bounds, "serial_tokens": serial["tp"]["tokens"],
           "seconds": seconds,
           **{f"rank{r}": {k: v for k, v in d.items() if k != "tokens"}
              for r, d in enumerate(tp)},
           "autotune_counters": [r["autotune_counters"] for r in ranks]}
    emit(row)
    for d in tp:
        assert d["wrapped"] == ["TensorParallel", "HybridParallelOptimizer"]
        assert d["tokens"] == serial["tp"]["tokens"], "greedy tokens differ"
        assert d["losses"][:TP_CHECKED] == tp[0]["losses"][:TP_CHECKED]
        for counts in d["launches_per_step"]:
            for kernel in kernels:
                assert counts.get(f"{kernel}.{fa.TC}", 0) == HYBRID_LAYERS, \
                    counts
        assert d["prefill_launches"].get(f"{fa.KERNEL_NAME}.{fa.TC}") == \
            HYBRID_LAYERS
        assert d["greedy_f32_launches"].get(
            f"{fa.KERNEL_NAME}.{fa.SIMT}", 0) >= HYBRID_LAYERS, \
            d["greedy_f32_launches"]
    # the replicated parameters see the same summed gradients on every
    # rank, so they stay equal to the bit after every step
    assert tp[0]["replicated_sha"] == tp[1]["replicated_sha"], \
        "replicated parameters differ across ranks"
    assert all(g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)

    zero = [r["zero_gpt"] for r in ranks]
    zgaps = [abs(a - b) / abs(b) for a, b in zip(zero[0]["losses"],
                                                 serial["zero"]["losses"])]
    row = {"phase": "zero_gpt", "world": HYBRID_WORLD,
           "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64 bf16, AdamW mp, "
                     "sharding 2 (ZeRO-1)",
           "global_batch": [TRAIN_BATCH, TRAIN_SEQ],
           "serial_losses": serial["zero"]["losses"],
           "zero_losses": zero[0]["losses"], "loss_rel_gaps": zgaps,
           "loss_rtol": DP_LOSS_RTOL, "dp_gpt_peak_gb_pr14": 9.49,
           **{f"rank{r}": {k: v for k, v in d.items() if k != "param_sha"}
              for r, d in enumerate(zero)}}
    emit(row)
    for d in zero:
        assert d["wrapped"] == ["ShardingParallel",
                                "HybridParallelOptimizer",
                                "ShardingOptimizerWrapper"], d["wrapped"]
        for counts in d["launches_per_step"]:
            for kernel in kernels:
                assert counts.get(f"{kernel}.{fa.TC}", 0) == GPT_LAYERS, \
                    counts
    assert zero[0]["param_sha"] == zero[1]["param_sha"], "weights differ"
    assert sum(d["owned_elements"] for d in zero) == zero[0]["all_elements"]
    assert max(zgaps) <= DP_LOSS_RTOL, zgaps

    geo = [r["geometry"] for r in geometry]
    ggaps = [abs(a - b) / abs(b) for a, b in zip(geo[0]["losses"],
                                                 serial["geometry"])]
    row = {"phase": "hybrid_geometry", "world": GEOM_WORLD,
           "config": f"GPT-3 1.3B geometry, {GEOM_LAYERS} layers, f32, SGD "
                     f"{GEOM_LR}, dp 2 x mp 2",
           "global_batch": [GEOM_BATCH, GEOM_SEQ],
           "serial_losses": serial["geometry"],
           "hybrid_losses": [g["losses"] for g in geo],
           "loss_rel_gaps": ggaps, "loss_rtol": GEOM_RTOL,
           "coords": [g["coords"] for g in geo],
           "launches_per_step_rank0": geo[0]["launches_per_step"]}
    emit(row)
    for g in geo:
        assert g["wrapped"] == ["TensorParallel", "HybridParallelOptimizer"]
        assert g["losses"] == geo[0]["losses"], [x["losses"] for x in geo]
        for counts in g["launches_per_step"]:
            for kernel in kernels:
                assert counts.get(f"{kernel}.{fa.SIMT}", 0) == GEOM_LAYERS, \
                    counts
    assert len(ggaps) == GEOM_STEPS and max(ggaps) <= GEOM_RTOL, ggaps
    return {"tp_gpt_per_step_rank0": tp[0]["launches_per_step"][-1],
            "tp_gpt_per_step_rank1": tp[1]["launches_per_step"][-1],
            "tp_prefill_rank0": tp[0]["prefill_launches"],
            "tp_greedy_f32_rank0": tp[0]["greedy_f32_launches"],
            "zero_gpt_per_step_rank0": zero[0]["launches_per_step"][-1],
            "zero_gpt_per_step_rank1": zero[1]["launches_per_step"][-1],
            "hybrid_geometry_per_step_rank0":
                geo[0]["launches_per_step"][-1],
            "tp_gpt_tiles": tp[0]["tiles"], "seconds": seconds,
            "beside": besides,
            "serial": {"tp": serial["tp"], "zero": serial["zero"]}}


# the pipeline group: pp_gpt (GPT-3 1.3B at pp 2 x mp 2), pp_compiled
# (GPT-medium at pp 2, its stages captured) and hybrid_ckpt (the 1.3B
# layers at 2 of 24, saved at pp 2 x mp 2 and resumed at dp 2 x mp 2)
PP_WORLD, PP_STEPS, PP_MICRO = 4, 3, 2
PPC_WORLD, PPC_STEPS, PPC_MICRO, PPC_RTOL = 2, 3, 4, 1e-5
CKPT_LAYERS, CKPT_STEPS, CKPT_RTOL = 2, 2, BF16_GRAD_SLACK


def gpt_pipeline_descs(cfg, dtype):
    """GPT as pipeline descriptions built from the port's GPT modules: the
    token table (shared with the head, whose call multiplies by it), the
    positions, the blocks on (x, pending), the final LayerNorm. Under mp
    the table is vocabulary-parallel and the head's input goes through
    ``_c_identity``, as GPTForCausalLM's TP head does."""
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.collective import _c_identity
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.fused_residual_ln import fused_residual_ln
    from paddle_tpu_torch.text.models.gpt import GPTBlock

    class Positions(nn.Embedding):
        def forward(self, x):
            pos = torch.arange(x.shape[1], device=x.device)[None, :]
            return x + super().forward(pos), None

    class Block(GPTBlock):
        def forward(self, xp):
            return super().forward(*xp)

    class Final(nn.LayerNorm):
        def forward(self, xp):
            x, pending = xp
            if pending is None:
                return super().forward(x)
            return fused_residual_ln(x, pending, self.weight, self.bias,
                                     epsilon=self._epsilon)

    def head(table, h):
        group = mpu._model_group()
        if mpu._degree(group) > 1:
            h = _c_identity(h, group)
        return F.linear(h, table.weight.t())
    kw = {"device": "cuda", "dtype": dtype}
    table = mpu.VocabParallelEmbedding if cfg.tensor_parallel \
        else nn.Embedding
    return ([mpu.SharedLayerDesc("wte", table, None, "weight",
                                 cfg.vocab_size, cfg.hidden_size, **kw),
             mpu.LayerDesc(Positions, cfg.max_position_embeddings,
                           cfg.hidden_size, **kw)]
            + [mpu.LayerDesc(Block, cfg, **kw)
               for _ in range(cfg.num_layers)]
            + [mpu.LayerDesc(Final, cfg.hidden_size, **kw),
               mpu.SharedLayerDesc("wte", table, head, "weight",
                                   cfg.vocab_size, cfg.hidden_size, **kw)])


def gpt_pipeline_names(state, layers):
    """A GPTForCausalLM state under the pipeline descriptions' names."""
    out = {}
    for k, v in state.items():
        if k == "gpt.wte.weight":
            out["run_function.0.weight"] = v
        elif k == "gpt.wpe.weight":
            out["run_function.1.weight"] = v
        elif k.startswith("gpt.h."):
            i, rest = k[len("gpt.h."):].split(".", 1)
            out[f"run_function.{2 + int(i)}.{rest}"] = v
        elif k.startswith("gpt.ln_f."):
            out[f"run_function.{2 + layers}.{k[len('gpt.ln_f.'):]}"] = v
    return out


def gpt_pipeline_loss():
    """The mean f32 softmax cross-entropy of the (local) logits, as
    GPTForCausalLM's loss."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        ParallelCrossEntropy
    ce = ParallelCrossEntropy()
    return lambda logits, y: ce(logits.float(), y).mean()


def gpt_pipeline(torch, cfg, full, stages, dtype=None):
    """The PipelineLayer of ``cfg`` (this rank's stage where the pipe axis
    has ``stages`` ranks) holding ``full``'s weights (a GPTForCausalLM
    state), each rank its shard."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    pl = PipelineLayer(gpt_pipeline_descs(cfg, dtype or torch.bfloat16),
                       num_stages=stages, loss_fn=gpt_pipeline_loss())
    names = gpt_pipeline_names(full, cfg.num_layers)
    pt.load_numpy_state_dict(pl, {k: names[k] for k in pl.state_dict()})
    return pl


def tied_sha(torch, pl):
    import hashlib
    return hashlib.sha1(pl.run_function[0].weight.detach().contiguous()
                        .view(torch.uint8).cpu().numpy().tobytes()
                        ).hexdigest()


def rank_pp_gpt(torch, seed):
    """pp_gpt on this rank: every rank draws the full f32 1.3B (as
    tp_gpt's ranks do) and keeps its stage's shard; PP_STEPS eager 1F1B
    bf16 steps through fleet.distributed_model / distributed_optimizer
    (AdamW mp, 1e-4) on bench's 2 x 1024 in PP_MICRO micro-batches.
    Returns the losses, the replicated parameters' and the tied table's
    SHA-1 after each step, step ms, the point-to-point wait and bytes and
    the all-reduces' wait and bytes a step, B1-B3 launches a step and in
    a profiled step by kernel name, tiles, busy share, peak memory."""
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    from paddle_tpu_torch.resilience.recorder import get_recorder
    from paddle_tpu_torch.text.models.gpt import GPTConfig
    fleet, hcg = fleet_init({"pp_degree": 2, "mp_degree": 2}, PP_MICRO)
    cfg = GPTConfig.gpt3_1p3b(dropout=0.0, max_position_embeddings=TRAIN_SEQ,
                              tensor_parallel=True)
    cfg.num_layers = HYBRID_LAYERS
    full = gpt_1p3b(torch, torch.float32, seed)
    pl = gpt_pipeline(torch, cfg, full.state_dict(), 2)
    del full
    free_cuda(torch)
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, multi_precision=True,
        parameters=pl.parameters()))
    engine = model._engine
    xs, ys = bench_stream(seed, PP_STEPS, TP_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    rec = get_recorder()
    losses, shas, tied, step_ms, launches, comms, p2p = ([] for _ in
                                                          range(7))
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for i in range(PP_STEPS):
        if i == 1:
            steptimer.reset_steptimer()
        launch_counts.clear()
        rec.clear()
        engine.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.train_batch((xs[i], ys[i]), opt)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_launches(fa, launch_counts))
        comms.append(collective_tally(rec.entries()))
        st = engine.stats()
        p2p.append({"wait_ms": st["p2p_wait_s"] * 1e3,
                    "bytes_sent": st["p2p_bytes_sent"]})
        shas.append(replicated_sha(torch, pl))
        tied.append(tied_sha(torch, pl))
    peak = torch.cuda.max_memory_allocated()
    wait_ms = steptimer.get_steptimer().breakdown()["phase_ms"].get(
        "collective_wait", 0.0) / (PP_STEPS - 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_batch((xs[0], ys[0]), opt)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {k: sum(1 for e in prof.events()
                      if is_kernel(e) and name in e.name)
               for k, name in TC_KERNEL_NAMES.items()}
    b, s, h, d = PP_RANK_SHAPE
    dev = torch.device("cuda")
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    st = engine.stats()
    return {"coords": [hcg.get_stage_id(), hcg.get_model_parallel_rank()],
            "losses": losses, "replicated_sha": shas, "tied_sha": tied,
            "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms[1:])),
            "tokens_per_s": TP_BATCH * TRAIN_SEQ
            / (float(np.median(step_ms[1:])) / 1e3),
            "collective_wait_ms_per_step": wait_ms,
            "collectives_per_step": comms, "p2p_per_step": p2p,
            "launches_per_step": launches,
            "profiled_step_ms": wall,
            "profiled_tc_launches_by_kernel_name": by_name,
            "busy_share": device_busy(prof) / wall,
            "tiles": {fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
                      fa.DQ_KERNEL: bwd[2]},
            "local_params": sum(p.numel() for p in pl.parameters()),
            "compiled_stages": st["compiled_stages"],
            "eager_reason": st["eager_reason"],
            "max_stashed": st["max_stashed"],
            "peak_mem_bytes": peak,
            "wrapped": [type(model).__name__, type(opt).__name__]}


def rank_pp_compiled(torch, seed):
    """pp_compiled on this rank: GPT-medium (the serial lane's weights) at
    pp 2, PPC_STEPS steps with eager stages, then PPC_STEPS from the same
    weights with every stage direction a CompiledStageProgram (a CUDA
    graph per signature): the losses, step ms, compiles after the first
    step, graph replays a step, the stages captured."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import compile_stats
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    fleet, hcg = fleet_init({"pp_degree": 2}, PPC_MICRO)
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=GPT_LAYERS,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    full = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(seed))
    state = {k: v.detach().clone() for k, v in full.state_dict().items()}
    del full
    xs, ys = bench_stream(seed, PPC_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    out = {"stage": hcg.get_stage_id()}
    for mode in ("eager", "compiled"):
        pt.set_flags({"FLAGS_compiled_step": mode == "compiled"})
        pl = gpt_pipeline(torch, cfg, state, 2)
        model = fleet.distributed_model(pl)
        opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=1e-4, multi_precision=True,
            parameters=pl.parameters()))
        engine = model._engine
        losses, step_ms, compiles, replays, launches = [], [], [], [], []
        for i in range(PPC_STEPS):
            c0 = compile_stats()["compiles"]
            r0 = sum(p["hits"] for p in engine.stats()["programs"].values())
            launch_counts.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(model.train_batch((xs[i], ys[i]), opt).item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            compiles.append(compile_stats()["compiles"] - c0)
            replays.append(sum(p["hits"] for p in engine.stats()[
                "programs"].values()) - r0)
            launches.append(flash_launches(fa, launch_counts))
        st = engine.stats()
        out[mode] = {"losses": losses, "step_ms": step_ms,
                     "step_ms_median": float(np.median(step_ms[1:])),
                     "compiles_per_step": compiles,
                     "graph_replays_per_step": replays,
                     "launches_per_step": launches,
                     "compiled_stages": st["compiled_stages"],
                     "programs": st["programs"]}
        del model, opt, pl, engine
        free_cuda(torch)
    pt.set_flags({"FLAGS_compiled_step": True})
    return out


def rank_hybrid_ckpt(torch, seed, cache_dir):
    """hybrid_ckpt on this rank: the 1.3B layers at CKPT_LAYERS of 24,
    bf16, AdamW with f32 masters, pp 2 x mp 2: CKPT_STEPS steps, the
    hybrid save, CKPT_STEPS more; then fleet.init at dp 2 x mp 2, the
    model built whole, the load and CKPT_STEPS steps (each data rank its
    row). Returns both runs' losses, the sha256 of the gathered weights
    and masters at the save and after the load (rank 0), the file's
    bytes, the seconds of the save and the load, and the corrupted
    file's outcome."""
    import hashlib

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    def digest(model, opt):
        state = ckpt.gather_hybrid_state(model, opt)
        if state is None:
            return None
        h = hashlib.sha256()
        arrays = list(state[0].items()) + sorted(
            (k, v) for k, v in state[1].items()
            if k.endswith("__master_weight"))
        for k, v in arrays:
            h.update(k.encode())
            h.update(np.ascontiguousarray(v).view(np.uint8).tobytes())
        return h.hexdigest()
    fleet, hcg = fleet_init({"pp_degree": 2, "mp_degree": 2}, 2)
    cfg = GPTConfig.gpt3_1p3b(dropout=0.0, max_position_embeddings=TRAIN_SEQ,
                              tensor_parallel=True)
    cfg.num_layers = CKPT_LAYERS
    full = gpt_1p3b(torch, torch.float32, seed, layers=CKPT_LAYERS)
    state = full.state_dict()
    pl = gpt_pipeline(torch, cfg, state, 2)
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, multi_precision=True,
        parameters=pl.parameters()))
    xs, ys = bench_stream(seed, 2 * CKPT_STEPS, TP_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    launch_counts.clear()
    losses = [model.train_batch((xs[i], ys[i]), opt).item()
              for i in range(CKPT_STEPS)]
    launches = flash_launches(fa, launch_counts)
    path = os.path.join(cache_dir, "hybrid_ckpt.pdparams")
    saved = digest(model, opt)
    t0 = time.perf_counter()
    dist.save_hybrid_checkpoint(path, model, opt, meta={"step": CKPT_STEPS})
    save_s = time.perf_counter() - t0
    straight = [model.train_batch((xs[i], ys[i]), opt).item()
                for i in range(CKPT_STEPS, 2 * CKPT_STEPS)]
    del model, opt, pl
    free_cuda(torch)
    fleet, hcg = fleet_init({"dp_degree": 2, "mp_degree": 2})
    pl = gpt_pipeline(torch, cfg, state, 1)     # whole: no pipe axis
    del full, state
    free_cuda(torch)
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, multi_precision=True,
        parameters=pl.parameters()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = dist.load_hybrid_checkpoint(path, model, opt)
    load_s = time.perf_counter() - t0
    loaded = digest(model, opt)
    d = hcg.get_data_parallel_rank()
    resumed = []
    for i in range(CKPT_STEPS, 2 * CKPT_STEPS):
        loss = pl.loss_fn(model(xs[i, d:d + 1]), ys[i, d:d + 1])
        loss.backward()
        opt.step()
        opt.clear_grad()
        g = loss.detach().float().reshape(1).clone()
        resumed.append(dist.all_reduce(
            g, op=dist.ReduceOp.AVG,
            group=hcg.get_data_parallel_group()).item())
    out = {"losses": losses, "straight": straight, "resumed": resumed,
           "meta_step": meta.get("step"), "launches_first_steps": launches,
           "saved_sha": saved, "loaded_sha": loaded, "save_s": save_s,
           "load_s": load_s, "wrapped": [type(model).__name__,
                                         type(opt).__name__]}
    dist.barrier()
    if dist.get_rank() == 0:
        out["file_bytes"] = os.path.getsize(path)
        with open(path, "r+b") as f:      # one flipped byte, no .old
            f.seek(out["file_bytes"] // 2)
            b = f.read(1)
            f.seek(out["file_bytes"] // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        try:
            dist.load_hybrid_checkpoint(path, model, opt)
            out["corrupt"] = "loaded"
        except ckpt.CorruptCheckpointError as e:
            out["corrupt"] = f"CorruptCheckpointError: {e}"
        for f in (path, path + ".sha256"):
            os.remove(f)
    dist.barrier()
    return out


def phase_pipeline(torch, seed, serial=None, beside=None):
    """pp_gpt, pp_compiled and hybrid_ckpt: the serial runs (the hybrid
    group's, or run here first), then PP_WORLD rank processes for pp_gpt
    and then hybrid_ckpt, with ``beside()`` (the bert group) on this
    process while they run, and PPC_WORLD for pp_compiled, started when
    ``beside()`` returns, beside them. Returns each lane's B1-B3 launches
    a step and what ``beside`` returned."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    seconds = {}
    t0 = time.perf_counter()
    if serial is None:
        serial = {"tp": serial_1p3b(torch, seed),
                  "zero": serial_gpt_losses(torch, seed)}
        seconds["serial"] = time.perf_counter() - t0
    cache_dir = autotune_cache_dir()
    started = start_ranks(PP_WORLD, seed, "pp_ckpt", cache_dir)
    besides, seconds["beside"] = run_beside(beside, started)
    # pp_compiled's ranks start when the guest is done, beside pp_gpt's
    ppc_started = start_ranks(PPC_WORLD, seed, "pp_compiled", cache_dir)
    (ranks, seconds["pp_gpt_hybrid_ckpt"]), \
        (ppc, seconds["pp_compiled"]) = join_together(
            [started, ppc_started], timeout=600)
    kernels = (fa.KERNEL_NAME, fa.DKV_KERNEL, fa.DQ_KERNEL)
    # a stage's layers x PP_MICRO micro-batches, B1 twice (the recompute)
    per_layer = HYBRID_LAYERS // 2 * PP_MICRO
    per_step = {fa.KERNEL_NAME: 2 * per_layer, fa.DKV_KERNEL: per_layer,
                fa.DQ_KERNEL: per_layer}

    pp = [r["pp_gpt"] for r in ranks]
    by = {tuple(r["coords"]): r for r in pp}
    sb, sf = serial["tp"]["bfloat16"], serial["tp"]["float32"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(pp[0]["losses"],
                                                sb["losses"])]
    bounds = [BF16_GRAD_FACTOR * abs(b - f) / abs(f) + BF16_GRAD_SLACK
              for b, f in zip(sb["losses"], sf["losses"])]
    row = {"phase": "pp_gpt", "world": PP_WORLD,
           "config": f"GPT-3 1.3B v50304 h2048 L{HYBRID_LAYERS} of 24 a16 "
                     f"d128 bf16, AdamW mp, pp 2 x mp 2 "
                     f"({HYBRID_LAYERS // 2} blocks, 8 heads a rank), 1F1B",
           "global_batch": [TP_BATCH, TRAIN_SEQ], "micro_batches": PP_MICRO,
           "serial_bf16_losses": sb["losses"],
           "serial_f32_losses": sf["losses"],
           "pp_losses": pp[0]["losses"], "loss_rel_gaps": gaps,
           "loss_bounds": bounds, "seconds": seconds,
           **{f"rank{r}": {k: v for k, v in d.items()
                           if k not in ("replicated_sha", "tied_sha")}
              for r, d in enumerate(pp)}}
    emit(row)
    for d in pp:
        assert d["wrapped"] == ["PipelineParallel",
                                "HybridParallelOptimizer"], d["wrapped"]
        assert d["losses"] == pp[0]["losses"], [x["losses"] for x in pp]
        assert d["compiled_stages"] == [] and "mp_degree 2" in \
            d["eager_reason"], d["eager_reason"]
        for counts in d["launches_per_step"]:
            for kernel in kernels:
                assert counts.get(f"{kernel}.{fa.TC}", 0) == \
                    per_step[kernel], counts
        assert d["profiled_tc_launches_by_kernel_name"] == {
            k: per_step[k] for k in kernels}, \
            d["profiled_tc_launches_by_kernel_name"]
        assert d["max_stashed"] <= 2 - d["coords"][0]
    for s in range(2):
        assert by[s, 0]["replicated_sha"] == by[s, 1]["replicated_sha"], \
            f"replicated parameters differ across stage {s}'s model ranks"
    for m in range(2):
        assert by[0, m]["tied_sha"] == by[1, m]["tied_sha"], \
            f"the tied table's two copies differ (model rank {m})"
    assert len(gaps) == TP_CHECKED and all(
        g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)

    ppc = [r["pp_compiled"] for r in ppc]
    ref = serial["zero"]["losses"]
    eager, comp = ppc[0]["eager"], ppc[0]["compiled"]
    cgaps = [abs(a - b) / abs(b) for a, b in zip(comp["losses"],
                                                 eager["losses"])]
    sgaps = [abs(a - b) / abs(b) for a, b in zip(comp["losses"], ref)]
    row = {"phase": "pp_compiled", "world": PPC_WORLD,
           "config": f"GPT-medium v32000 h1024 L{GPT_LAYERS} a16 d64 bf16, AdamW mp, "
                     f"pp 2 ({GPT_LAYERS // 2} blocks a stage), stages "
                     f"captured",
           "global_batch": [TRAIN_BATCH, TRAIN_SEQ],
           "micro_batches": PPC_MICRO, "serial_losses": ref,
           "compiled_vs_eager_rel_gaps": cgaps, "rtol": PPC_RTOL,
           "compiled_vs_serial_rel_gaps": sgaps,
           "serial_rtol": DP_LOSS_RTOL,
           **{f"rank{r}": d for r, d in enumerate(ppc)}}
    emit(row)
    for d in ppc:
        c = d["compiled"]
        assert c["compiled_stages"] == [0, 1], c["compiled_stages"]
        assert all(p["captured"] >= 1 for k, p in c["programs"].items()
                   if k != "fwd_out"), c["programs"]
        assert sum(c["compiles_per_step"][1:]) == 0, c["compiles_per_step"]
        assert d["eager"]["compiled_stages"] == []
    assert max(cgaps) <= PPC_RTOL, cgaps
    assert len(sgaps) == DP_CHECKED and max(sgaps) <= DP_LOSS_RTOL, sgaps

    ck = [r["hybrid_ckpt"] for r in ranks]
    c0 = ck[0]
    rgaps = [abs(a - b) / abs(b) for a, b in zip(c0["resumed"],
                                                 c0["straight"])]
    row = {"phase": "hybrid_ckpt", "world": PP_WORLD,
           "config": f"GPT-3 1.3B layers at {CKPT_LAYERS} of 24, bf16, "
                     f"AdamW mp, saved at pp 2 x mp 2, resumed at dp 2 x mp 2",
           "losses": c0["losses"], "uninterrupted": c0["straight"],
           "resumed": c0["resumed"], "resumed_rel_gaps": rgaps,
           "rtol": CKPT_RTOL, "file_bytes": c0["file_bytes"],
           "save_s": [d["save_s"] for d in ck],
           "load_s": [d["load_s"] for d in ck],
           "saved_sha": c0["saved_sha"], "loaded_sha": c0["loaded_sha"],
           "corrupt": c0["corrupt"],
           "launches_first_steps_rank0": c0["launches_first_steps"]}
    emit(row)
    assert c0["saved_sha"] is not None and \
        c0["saved_sha"] == c0["loaded_sha"], (c0["saved_sha"],
                                              c0["loaded_sha"])
    assert c0["corrupt"].startswith("CorruptCheckpointError"), c0["corrupt"]
    for d in ck:
        assert d["meta_step"] == CKPT_STEPS
        assert d["resumed"] == c0["resumed"]
        assert d["wrapped"] == ["TensorParallel", "HybridParallelOptimizer"]
    assert max(rgaps) <= CKPT_RTOL, rgaps
    return {"pp_gpt_per_step_rank0": pp[0]["launches_per_step"][-1],
            "pp_gpt_per_step_rank3": pp[-1]["launches_per_step"][-1],
            "pp_compiled_per_step_rank0":
                ppc[0]["compiled"]["launches_per_step"][0],
            "hybrid_ckpt_first_steps_rank0": c0["launches_first_steps"],
            "pp_gpt_tiles": pp[0]["tiles"], "seconds": seconds,
            "beside": besides}


# the layouts group (rank processes on the one card over gloo, one spawn of
# LAYOUT_WORLD): zero3_gpt, bench's GPT-3 1.3B slice (bench.py:929-954: 6
# layers, hidden 2048, vocab 50304, batch 2 x 1024) in bf16 under
# Model.prepare(spec_layout=SpecLayout(shard_params=True)) on {"sharding":
# 2}, 1 warm-up and Z3_STEPS timed steps, then its ZeRO-1 peak over
# Z1_STEPS steps and a checkpoint of the slice cut to Z3_CKPT_LAYERS layers;
# ring_attn at the 1.3B's heads, (1, 8192, 16, 128) on {"sep": 2}; spmd_pipe,
# 2 stages of 3 of the 1.3B's blocks on {"pipe": 2}, 4 x 1024 in 4
# micro-batches, SP_STEPS steps
LAYOUT_WORLD = 2
Z3_LAYERS, Z3_BATCH, Z3_STEPS, Z1_STEPS, Z3_CKPT_LAYERS = 4, 2, 2, 1, 1
RING_SHAPE = (1, 8192, 16, 128)
RING_RANK_SHAPE = (1, 4096, 16, 128)
RING_F32_SHAPE, RING_F32_RTOL = (1, 2048, 4, 64), 1e-5
RING_REPS = 1
SP_BLOCKS, SP_BATCH, SP_MICRO, SP_STEPS = 3, 4, 4, 3
SP_RANK_SHAPE = (1, 1024, 16, 128)


def slice_1p3b(torch, dtype, seed=None, layers=Z3_LAYERS):
    """bench's GPT-3 1.3B slice: gpt_1p3b at ``layers`` layers."""
    return gpt_1p3b(torch, dtype, seed, layers=layers)


def state_bytes(opt):
    """The bytes of an optimizer's accumulators (moments, masters, beta
    powers) under any wrappers."""
    while hasattr(opt, "_inner"):
        opt = opt._inner
    return sum(t.numel() * t.element_size()
               for accs in opt._accumulators.values() for t in accs.values())


def param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def serial_slice(torch, seed):
    """The serial runs zero3_gpt is held to: the slice in bf16 (AdamW mp)
    and in f32 (AdamW), 1 + Z3_STEPS eager steps on bench's stream at
    Z3_BATCH x 1024; the bf16 run's peak (over what this process held
    before it), parameter and optimizer-state bytes."""
    import paddle_tpu_torch as pt
    free_cuda(torch)
    before = torch.cuda.memory_allocated()
    full = slice_1p3b(torch, torch.float32, seed)
    model = slice_1p3b(torch, torch.bfloat16).train()
    pt.load_numpy_state_dict(model, full.state_dict())
    del full
    xs, ys = bench_stream(seed, 1 + Z3_STEPS, Z3_BATCH, TRAIN_SEQ)
    adamw = functools.partial(pt.optimizer.AdamW, learning_rate=1e-4)
    opts = []

    def make_mp(**kw):
        opts.append(adamw(multi_precision=True, **kw))
        return opts[-1]
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    out = {"bfloat16": serial_steps(torch, model, make_mp, xs, ys),
           "peak_mem_bytes": torch.cuda.max_memory_allocated() - before,
           "param_bytes": param_bytes(model),
           "optimizer_state_bytes": state_bytes(opts[0]),
           "params": sum(p.numel() for p in model.parameters())}
    del model, opts
    free_cuda(torch)
    # the same weights drawn again, for the f32 run
    full = slice_1p3b(torch, torch.float32, seed).train()
    out["float32"] = serial_steps(torch, full, adamw, xs, ys)
    del full
    free_cuda(torch)
    return out


def pipe_gpt(torch, dtype, seed):
    """The spmd_pipe model: the 1.3B's token and position tables, a
    PipelineStageStack of 2 stages of SP_BLOCKS blocks over the "pipe"
    axis (the stages in turn where it has degree 1), the final LayerNorm
    and the head tied to the table; the weights drawn in f32 from a CUDA
    generator in one order (the same numbers in every process), then
    cast to ``dtype``."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed.fleet.spmd_pipeline import \
        PipelineStageStack
    from paddle_tpu_torch.text.models.gpt import GPTBlock, GPTConfig

    class GPTStage(nn.Layer):
        """SP_BLOCKS of the 1.3B's blocks, x -> x: the blocks' carried
        residual added back at the end."""

        def __init__(self, cfg, **factory):
            super().__init__(**factory)
            self.h = nn.LayerList([GPTBlock(cfg, **factory)
                                   for _ in range(SP_BLOCKS)])

        def forward(self, x):
            pending = None
            for block in self.h:
                x, pending = block(x, pending)
            return x if pending is None else x + pending

    class PipeGPT(nn.Layer):
        def __init__(self, dt, gen):
            super().__init__(device="cuda", dtype=dt, generator=gen)
            cfg = GPTConfig.gpt3_1p3b(dropout=0.0,
                                      max_position_embeddings=TRAIN_SEQ)
            fk = self.factory_kwargs()
            init = nn.initializer.Normal(0.0, 0.02)
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                    weight_attr=init, **fk)
            self.wpe = nn.Embedding(TRAIN_SEQ, cfg.hidden_size,
                                    weight_attr=init, **fk)
            self.stack = PipelineStageStack(
                lambda: GPTStage(cfg, **fk), num_stages=2,
                num_microbatches=SP_MICRO)
            self.ln_f = nn.LayerNorm(cfg.hidden_size, **fk)
            self.vocab = cfg.vocab_size

        def forward(self, ids, labels):
            pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
            h = self.ln_f(self.stack(self.wte(ids) + self.wpe(pos)))
            logits = F.linear(h, self.wte.weight.t())
            return F.cross_entropy(logits.reshape(-1, self.vocab).float(),
                                   labels.reshape(-1))
    full = PipeGPT(torch.float32,
                   torch.Generator(device="cuda").manual_seed(seed + 17))
    if dtype == torch.float32:
        return full
    model = PipeGPT(dtype, None)
    pt.load_numpy_state_dict(model, full.state_dict())
    del full
    return model


def serial_pipe(torch, seed):
    """The sequential stack spmd_pipe is held to (pipe degree 1, the same
    weights): SP_STEPS eager steps in bf16 (AdamW mp) and in f32."""
    import paddle_tpu_torch as pt
    xs, ys = bench_stream(seed + 3, SP_STEPS, SP_BATCH, TRAIN_SEQ)
    adamw = functools.partial(pt.optimizer.AdamW, learning_rate=1e-4)
    out = {}
    for dtype, make in ((torch.bfloat16, functools.partial(
            adamw, multi_precision=True)), (torch.float32, adamw)):
        model = pipe_gpt(torch, dtype, seed).train()
        out[str(dtype).split(".")[-1]] = serial_steps(torch, model, make,
                                                      xs, ys)
        del model
        free_cuda(torch)
    return out


def profiled_step(torch, fn, expect, lead=None):
    """One call of ``fn`` under the profiler, through ``profiled`` (a
    lead-in absorbs what a profile loses at its start, ``lead`` or one
    small kernel; a window short of ``expect``, {kernel: launches}, is
    taken again): its ms, the share of it the device spent in kernels,
    and the tensor-core flash kernels launched and their device ms, by
    kernel name."""
    prof, wall_s, _, per = profiled(
        torch, fn, 1, expect=expect,
        lead=lead or (lambda: torch.ones(1, device="cuda").add_(1)))
    kernels = kernel_times(prof, per["after_us"])
    wall = wall_s * 1e3
    return {"profiled_step_ms": wall, "busy_share": per["device_ms"] / wall,
            "profiled_tc_launches_by_kernel_name": {
                k: int(v) for k, v in per["flash_launches"].items()},
            "profiled_device_ms_by_kernel": {
                n: sum(k[0] for k in kernels if tc in k[2]) / 1e3
                for n, tc in TC_KERNEL_NAMES.items()},
            "profile_tries": per["profile_tries"]}


def rank_zero3_gpt(torch, seed, cache_dir):
    """zero3_gpt on this rank: the slice trained through
    Model.prepare(spec_layout=SpecLayout(shard_params=True)) on
    {"sharding": 2}; then fleet's ZeRO-1 on the same slice for its peak;
    then the checkpoint of the slice at Z3_CKPT_LAYERS layers, saved at
    sharding 2 and loaded on rank 0 into the serial slice."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import spec_layout
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    from paddle_tpu_torch.resilience.recorder import get_recorder
    build_mesh({"sharding": LAYOUT_WORLD})
    full = slice_1p3b(torch, torch.float32, seed)
    model = slice_1p3b(torch, torch.bfloat16).train()
    pt.load_numpy_state_dict(model, full.state_dict())
    del full
    free_cuda(torch)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    m = pt.Model(model)
    m.prepare(opt, loss=lambda loss: loss,
              spec_layout=dist.SpecLayout(shard_params=True))
    xs, ys = bench_stream(seed, 1 + Z3_STEPS, Z3_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    rec = get_recorder()
    losses, step_ms, launches, comms, collectives = [], [], [], [], []
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + Z3_STEPS):
        if i == 1:
            steptimer.reset_steptimer()
        launch_counts.clear()
        spec_layout.reset_stats()
        rec.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(m.train_batch([xs[i], ys[i]])[0])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_launches(fa, launch_counts))
        comms.append(spec_layout.stats())
        collectives.append(collective_tally(rec.entries()))
    peak = torch.cuda.max_memory_allocated()
    wait_ms = steptimer.get_steptimer().breakdown()["phase_ms"].get(
        "collective_wait", 0.0) / Z3_STEPS
    prof = profiled_step(torch, lambda: m.train_batch([xs[1], ys[1]]),
                         {k: float(Z3_LAYERS) for k in TC_KERNEL_NAMES})
    dev = torch.device("cuda")
    b, s, h, d = Z3_BATCH, TRAIN_SEQ, 16, 128
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    out = {"losses": losses, "step_ms": step_ms,
           "step_ms_median": float(np.median(step_ms[1:])),
           "tokens_per_s": Z3_BATCH * TRAIN_SEQ
           / (float(np.median(step_ms[1:])) / 1e3),
           "collective_wait_ms_per_step": wait_ms,
           "zero3_collectives_per_step": comms,
           "collectives_per_step": collectives,
           "launches_per_step": launches,
           "tiles": {fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
                     fa.DQ_KERNEL: bwd[2]},
           "local_params": sum(p.numel() for p in model.parameters()),
           "param_bytes": param_bytes(model),
           "optimizer_state_bytes": state_bytes(opt),
           "peak_mem_bytes": peak, **prof,
           "sharded": sum(1 for p in model.parameters()
                          if getattr(p, "fsdp_split", None) is not None),
           "captures": m._captures(),
           "wrapped": type(m.network).__name__}
    del m, model, opt
    free_cuda(torch)
    # fleet's ZeRO-1 on the same slice and batch: its peak a rank
    fleet, hcg = fleet_init({"sharding_degree": LAYOUT_WORLD})
    before = torch.cuda.memory_allocated()
    model = slice_1p3b(torch, torch.bfloat16, seed).train()
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, multi_precision=True,
        parameters=model.parameters()))
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    z1_ms = []
    for i in range(Z1_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist_model(xs[i], labels=ys[i]).backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        z1_ms.append((time.perf_counter() - t0) * 1e3)
    out["zero1"] = {"peak_mem_bytes": torch.cuda.max_memory_allocated()
                    - before,
                    "optimizer_state_bytes": state_bytes(opt),
                    "step_ms": z1_ms}
    del dist_model, model, opt
    free_cuda(torch)
    out["checkpoint"] = zero3_checkpoint(torch, seed, cache_dir, xs, ys)
    return out


def zero3_checkpoint(torch, seed, cache_dir, xs, ys):
    """The slice at Z3_CKPT_LAYERS layers under ZeRO-3 (shard_params on
    {"sharding": 2}), one step, save_hybrid_checkpoint; rank 0 loads it
    into the serial slice and its optimizer. The sha256 of the gathered
    weights and f32 masters at the save and of the serial ones after the
    load, the file's bytes, the seconds of each."""
    import hashlib

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.framework.io_utils import (full_state_dict,
                                                     param_split, unshard)

    def digest(named, masters):
        h = hashlib.sha256()
        for k, v in named:
            h.update(k.encode())
            h.update(v.detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
        for v in masters:
            h.update(v.detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
        return h.hexdigest()

    def masters(model, opt):
        accs = opt._accumulators["master_weight"]
        out = []
        for p in model.parameters():
            t = accs[id(p)]
            split = param_split(p)
            out.append(unshard(t, split) if split is not None else t)
        return out
    build_mesh({"sharding": LAYOUT_WORLD})
    model = slice_1p3b(torch, torch.bfloat16, seed,
                       layers=Z3_CKPT_LAYERS).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    dist.shard_params(model, dist.SpecLayout(shard_params=True))
    model(xs[0], labels=ys[0]).backward()
    opt.step()
    opt.clear_grad()
    saved = digest(sorted(full_state_dict(model).items()),
                   masters(model, opt))
    path = os.path.join(cache_dir, "zero3.pdckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.save_hybrid_checkpoint(path, model, opt, meta={"step": 1})
    save_s = time.perf_counter() - t0
    del model, opt
    free_cuda(torch)
    out = {"saved_sha": saved, "save_s": save_s, "layers": Z3_CKPT_LAYERS}
    if dist.get_rank() == 0:
        out["file_bytes"] = os.path.getsize(path)
        serial = slice_1p3b(torch, torch.bfloat16,
                            layers=Z3_CKPT_LAYERS).train()
        sopt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                                  parameters=serial.parameters())
        t0 = time.perf_counter()
        meta = dist.load_hybrid_checkpoint(path, serial, sopt)
        out["load_s"] = time.perf_counter() - t0
        out["meta_step"] = meta.get("step")
        out["loaded_sha"] = digest(sorted(serial.state_dict().items()),
                                   masters(serial, sopt))
        del serial, sopt
    dist.barrier()
    if dist.get_rank() == 0:
        for f in (path, path + ".sha256"):
            if os.path.exists(f):
                os.remove(f)
    free_cuda(torch)
    return out


def rel_l2_t(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def rank_ring_attn(torch, seed):
    """ring_attn on this rank: {"sep": 2}, its (1, 4096, 16, 128) bf16
    slice of (1, 8192, 16, 128), causal, forward and backward; the
    gathered output and grads against one rank's B1, B2 and B3 over the
    whole sequence; then an f32 run at RING_F32_SHAPE, causal and not,
    against the plain version."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import sequence_parallel as sp
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    build_mesh({"sep": LAYOUT_WORLD})
    rank = dist.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)

    def whole(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype)
                for _ in range(4)]
    q, k, v, do = whole(RING_SHAPE, torch.bfloat16)
    scale = 1.0 / RING_SHAPE[-1] ** 0.5

    def local():
        return [sp.split_sequence(t).clone().requires_grad_()
                for t in (q, k, v)]
    do_l = sp.split_sequence(do).contiguous()

    def ring():
        ts = local()
        o = sp.ring_attention(*ts, is_causal=True)
        o.backward(do_l)
        return o, ts
    ring()                               # warm-up: the tile search
    launch_counts.clear()
    sp.reset_stats()
    paths = dict(attention.block_paths)
    ts = local()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = sp.ring_attention(*ts, is_causal=True)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_launches = flash_launches(fa, launch_counts)
    fwd_stats = sp.stats()
    launch_counts.clear()
    t0 = time.perf_counter()
    o.backward(do_l)
    torch.cuda.synchronize()
    bwd_ms = (time.perf_counter() - t0) * 1e3
    bwd_launches = flash_launches(fa, launch_counts)
    stats = sp.stats()
    block_paths = {k: attention.block_paths[k] - paths[k] for k in paths}
    times = []
    for _ in range(RING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profiled_step(torch, ring,
                         {k: float(rank + 1) for k in TC_KERNEL_NAMES},
                         lead=ring)
    gathered = sp.gather_sequence(o.detach())
    grads = [sp.gather_sequence(t.grad) for t in ts]
    # B1, B2 and B3 over the whole sequence, on the 64-row tiles: a tile
    # search at the whole sequence would gate its candidates on the
    # plain versions' score matrices (16 GiB at s = 16384)
    _, lse, out32 = fa._launch(q, k, v, True, scale, keep_f32=True, tile=64)
    ref_o = out32.to(q.dtype)
    delta = fa.bwd_delta(out32, do)
    dk, dv = fa.launch_dkv(q, k, v, do, lse, delta, True, scale, tile=64)
    ref_g = (fa.launch_dq(q, k, v, do, lse, delta, True, scale, tile=64),
             dk, dv)
    gaps = {"out": rel_l2_t(gathered, ref_o),
            **{f"d{n}": rel_l2_t(g, w)
               for n, g, w in zip("qkv", grads, ref_g)}}
    del q, k, v, do, do_l, ts, o, gathered, grads, ref_o, ref_g, out32, lse
    del delta, dk, dv
    free_cuda(torch)
    f32 = {}
    for causal in (True, False):
        q, k, v, do = whole(RING_F32_SHAPE, torch.float32)
        ts = [sp.split_sequence(t).clone().requires_grad_()
              for t in (q, k, v)]
        o = sp.ring_attention(*ts, is_causal=causal)
        o.backward(sp.split_sequence(do).contiguous())
        s32 = 1.0 / RING_F32_SHAPE[-1] ** 0.5
        ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                          s32)
        ref_g = fa.flash_attention_bwd_reference(q, k, v, ref_o, ref_lse,
                                                 do, causal, s32)
        f32[f"causal={causal}"] = {
            "out": rel_l2_t(sp.gather_sequence(o.detach()), ref_o),
            **{f"d{n}": rel_l2_t(sp.gather_sequence(t.grad), w)
               for n, t, w in zip("qkv", ts, ref_g)}}
    return {"rank": rank, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
            "ring_ms": times, "fwd_launches": fwd_launches,
            "bwd_launches": bwd_launches, "block_paths": block_paths,
            "fwd_p2p_bytes": fwd_stats["p2p_bytes"],
            "p2p_bytes": stats["p2p_bytes"],
            "bwd_p2p_bytes": stats["p2p_bytes"] - fwd_stats["p2p_bytes"],
            "fwd_p2p_wait_ms": fwd_stats["p2p_wait_s"] * 1e3,
            "p2p_wait_ms": stats["p2p_wait_s"] * 1e3,
            "blocks": stats["blocks"], "skipped": stats["skipped_blocks"],
            "eager_reason": stats["eager_reason"], **prof,
            "gaps_bf16": gaps,
            "gaps_f32": f32}


def rank_spmd_pipe(torch, seed):
    """spmd_pipe on this rank: the PipeGPT of pipe_gpt on {"pipe": 2},
    bf16, AdamW mp, SP_STEPS steps on bench's stream at SP_BATCH x 1024
    in SP_MICRO micro-batches: losses, the replicated parameters' SHA-1
    after each step, B1-B3 a step, p2p bytes and wait, step ms, busy
    share, peak."""
    import hashlib

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    build_mesh({"pipe": LAYOUT_WORLD})
    model = pipe_gpt(torch, torch.bfloat16, seed).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    xs, ys = bench_stream(seed + 3, SP_STEPS, SP_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    replicated = [p for n, p in sorted(model.named_parameters())
                  if not n.startswith("stack.")]
    losses, step_ms, launches, shas, p2p = [], [], [], [], []
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    for i in range(SP_STEPS):
        if i == 1:
            steptimer.reset_steptimer()
        launch_counts.clear()
        before = dict(model.stack.stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(xs[i], ys[i])
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_launches(fa, launch_counts))
        st = model.stack.stats()
        p2p.append({k: st[k] - before[k] for k in ("ticks",
                    "bubble_ticks_skipped", "p2p_bytes", "p2p_wait_s")})
        h = hashlib.sha1()
        for p in replicated:
            h.update(p.detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
        shas.append(h.hexdigest())
    peak = torch.cuda.max_memory_allocated()
    wait_ms = steptimer.get_steptimer().breakdown()["phase_ms"].get(
        "collective_wait", 0.0) / (SP_STEPS - 1)

    def step():
        model(xs[0], ys[0]).backward()
        opt.clear_grad()
    prof = profiled_step(torch, step, {k: float(SP_MICRO * SP_BLOCKS)
                                       for k in TC_KERNEL_NAMES}, lead=step)
    return {"losses": losses, "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms[1:])),
            "tokens_per_s": SP_BATCH * TRAIN_SEQ
            / (float(np.median(step_ms[1:])) / 1e3),
            "launches_per_step": launches, "p2p_per_step": p2p,
            "collective_wait_ms_per_step": wait_ms,
            "replicated_sha": shas, "peak_mem_bytes": peak,
            "local_params": sum(p.numel() for p in model.parameters()),
            **prof}


def phase_layouts(torch, seed, beside=None):
    """zero3_gpt, ring_attn and spmd_pipe: the LAYOUT_WORLD rank processes
    (one spawn, the three lanes in turn) started, then the serial runs on
    this process while the ranks import, then ``beside()`` (the optim
    group) while they run. Returns each lane's B1-B3 launches, the
    seconds and what ``beside`` returned."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    seconds = {}
    # the ranks read the tile answers this process found (the kernels
    # phase's, at the ring's and the micro-batch's shapes); they start
    # first and import while this process runs the serial references
    # (whose step times the imports' host load may stretch)
    started = start_ranks(LAYOUT_WORLD, seed, "layouts",
                          os.environ["PADDLE_TPU_AUTOTUNE_CACHE"])
    try:
        t0 = time.perf_counter()
        serial = {"zero3": serial_slice(torch, seed),
                  "pipe": serial_pipe(torch, seed)}
        seconds["serial"] = time.perf_counter() - t0
    except BaseException:
        for p in started[0]:
            p.kill()
            p.communicate()
        raise
    besides, seconds["beside"] = run_beside(beside, started)
    ranks, seconds["serial_and_ranks"] = join_ranks(started, timeout=600)
    kernels = (fa.KERNEL_NAME, fa.DKV_KERNEL, fa.DQ_KERNEL)
    tc = fa.TC

    def bf16_rule(got, ser):
        sb, sf = ser["bfloat16"]["losses"], ser["float32"]["losses"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(got, sb)]
        bounds = [BF16_GRAD_FACTOR * abs(b - f) / abs(f) + BF16_GRAD_SLACK
                  for b, f in zip(sb, sf)]
        return gaps, bounds

    z3 = [r["zero3_gpt"] for r in ranks]
    ser = serial["zero3"]
    gaps, bounds = bf16_rule(z3[0]["losses"], ser)
    ck = z3[0]["checkpoint"]
    row = {"phase": "zero3_gpt", "world": LAYOUT_WORLD,
           "config": f"GPT-3 1.3B slice v50304 h2048 L{Z3_LAYERS} a16 d128 "
                     f"bf16, AdamW mp, Model.prepare(spec_layout="
                     f"SpecLayout(shard_params=True)), sharding 2",
           "global_batch": [Z3_BATCH, TRAIN_SEQ],
           "serial_bf16_losses": ser["bfloat16"]["losses"],
           "serial_f32_losses": ser["float32"]["losses"],
           "serial_bf16_step_ms": ser["bfloat16"]["step_ms"],
           "serial_peak_mem_bytes": ser["peak_mem_bytes"],
           "serial_param_bytes": ser["param_bytes"],
           "serial_optimizer_state_bytes": ser["optimizer_state_bytes"],
           "serial_params": ser["params"],
           "zero3_losses": z3[0]["losses"], "loss_rel_gaps": gaps,
           "loss_bounds": bounds,
           "param_bytes_share": [d["param_bytes"] / ser["param_bytes"]
                                 for d in z3],
           "state_bytes_share": [d["optimizer_state_bytes"]
                                 / ser["optimizer_state_bytes"] for d in z3],
           **{f"rank{r}": d for r, d in enumerate(z3)}}
    emit(row)
    for d in z3:
        assert d["wrapped"] != "DataParallel" and not d["captures"], d
        assert d["losses"] == z3[0]["losses"], [x["losses"] for x in z3]
        for counts in d["launches_per_step"]:
            for kernel in kernels:
                assert counts.get(f"{kernel}.{tc}", 0) == Z3_LAYERS, counts
        assert d["profiled_tc_launches_by_kernel_name"] == {
            k: Z3_LAYERS for k in kernels}, \
            d["profiled_tc_launches_by_kernel_name"]
    assert sum(d["local_params"] for d in z3) == ser["params"]
    assert all(abs(s - 0.5) <= 0.01 for s in row["param_bytes_share"]), row
    assert all(abs(s - 0.5) <= 0.01 for s in row["state_bytes_share"]), row
    assert len(gaps) == 1 + Z3_STEPS and all(
        g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)
    assert ck["saved_sha"] == ck["loaded_sha"] and ck["meta_step"] == 1, ck

    ring = sorted((r["ring_attn"] for r in ranks), key=lambda d: d["rank"])
    row = {"phase": "ring_attn", "world": LAYOUT_WORLD,
           "config": f"ring_attention on {{'sep': 2}}, {RING_SHAPE} "
                     f"bf16 causal, {RING_RANK_SHAPE} a rank",
           "rel_l2_bound": 2.0 ** -7, "f32_rtol": RING_F32_RTOL,
           **{f"rank{d['rank']}": d for d in ring}}
    emit(row)
    for d in ring:
        r = d["rank"]
        for kernel in kernels:
            assert d["fwd_launches" if kernel == fa.KERNEL_NAME
                     else "bwd_launches"].get(f"{kernel}.{tc}", 0) == r + 1, d
        assert d["block_paths"] == {"kernel": 2 * (r + 1), "math": 0}, d
        assert all(g <= 2.0 ** -7 for g in d["gaps_bf16"].values()), d
        for gaps32 in d["gaps_f32"].values():
            assert all(g <= RING_F32_RTOL for g in gaps32.values()), d
        assert d["profiled_tc_launches_by_kernel_name"] == {
            k: r + 1 for k in kernels}, d

    pipe = [r["spmd_pipe"] for r in ranks]
    gaps, bounds = bf16_rule(pipe[0]["losses"], serial["pipe"])
    row = {"phase": "spmd_pipe", "world": LAYOUT_WORLD,
           "config": "PipelineStageStack of 2 stages of 3 GPT-3 1.3B blocks "
                     "(h2048, 16 heads of 128) bf16 on {'pipe': 2}, tables, "
                     "final LN and tied head replicated, AdamW mp",
           "global_batch": [SP_BATCH, TRAIN_SEQ], "micro_batches": SP_MICRO,
           "serial_bf16_losses": serial["pipe"]["bfloat16"]["losses"],
           "serial_f32_losses": serial["pipe"]["float32"]["losses"],
           "serial_bf16_step_ms": serial["pipe"]["bfloat16"]["step_ms"],
           "pipe_losses": pipe[0]["losses"], "loss_rel_gaps": gaps,
           "loss_bounds": bounds,
           **{f"rank{r}": {k: v for k, v in d.items()
                           if k != "replicated_sha"}
              for r, d in enumerate(pipe)}}
    emit(row)
    for d in pipe:
        assert d["losses"] == pipe[0]["losses"], [x["losses"] for x in pipe]
        assert d["replicated_sha"] == pipe[0]["replicated_sha"], \
            "replicated parameters differ across the stages"
        for counts in d["launches_per_step"]:
            for kernel in kernels:
                assert counts.get(f"{kernel}.{tc}", 0) == \
                    SP_MICRO * SP_BLOCKS, counts
        for st in d["p2p_per_step"]:
            assert st["ticks"] == SP_MICRO and \
                st["bubble_ticks_skipped"] == 1, st
    assert len(gaps) == SP_STEPS and all(
        g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)
    return {"zero3_gpt_per_step_rank0": z3[0]["launches_per_step"][-1],
            "zero3_gpt_per_step_rank1": z3[1]["launches_per_step"][-1],
            "ring_attn_fwd_rank0": ring[0]["fwd_launches"],
            "ring_attn_fwd_rank1": ring[1]["fwd_launches"],
            "ring_attn_bwd_rank0": ring[0]["bwd_launches"],
            "ring_attn_bwd_rank1": ring[1]["bwd_launches"],
            "spmd_pipe_per_step_rank0": pipe[0]["launches_per_step"][-1],
            "spmd_pipe_per_step_rank1": pipe[1]["launches_per_step"][-1],
            "zero3_gpt_tiles": z3[0]["tiles"], "seconds": seconds,
            "beside": besides}


def layout_entries(fa, entry, rows, bwd_rows, layouts, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 at the layouts
    group's shapes: a ring rank's (1, 4096, 16, 128), causal and not, with
    their launches in one ring call on rank 1 (its diagonal block causal,
    the one below it full), zero3_gpt's (2, 1024, 16, 128) with its launches a step,
    and spmd_pipe's micro-batch (1, 1024, 16, 128) with its launches a
    step, all causal. Each forward writes O in f32 too: its time and
    bound are those."""
    tc = fa.TC

    def at(found, shape, causal=True):
        return next(r for r in found if r["shape"] == list(shape)
                    and r["dtype"] == "bfloat16" and r["causal"] == causal)

    def at_full(found, shape):
        return at(found, shape, causal=False)

    def fwd_entry(suffix, row, launches, main):
        return entry(f"{fa.KERNEL_NAME}.{tc}.{suffix}",
                     "flash_attn_fwd_tc.cu", 114, row, launches,
                     row["max_abs_err_o"], rel_l2=row["rel_l2_o"],
                     main_path=main, ms=row["ms_with_f32_out"],
                     bound_ms=row["bound_us_with_f32_out"] / 1e3,
                     bound_by=row["bound_by_with_f32_out"],
                     share_of_bound=row["bound_us_with_f32_out"] / 1e3
                     / row["ms_with_f32_out"],
                     factor_vs_library=row["ms_with_f32_out"]
                     / row["library_ms"], ms_without_f32_out=row["ms"])

    def bwd_entries(suffix, shape, counts, main, causal=True):
        out = []
        for kernel, source, line in ((fa.DKV_KERNEL, "flash_attn_dkv_tc.cu",
                                      200),
                                     (fa.DQ_KERNEL, "flash_attn_dq_tc.cu",
                                      247)):
            key = "dkv" if kernel == fa.DKV_KERNEL else "dq"
            row = at(bwd_rows[key], shape, causal)
            out.append(entry(f"{kernel}.{tc}.{suffix}", source, line, row,
                             counts.get(f"{kernel}.{tc}", 0),
                             row["max_abs_err"],
                             rel_l2={o: g["rel_l2"] for o, g in
                                     row["rel_l2_by_output"].items()},
                             main_path=main, **scope))
        return out
    ring_main = ("ring_attention bf16 causal on {'sep': 2}, a rank's "
                 "(1, 4096, 16, 128) slice of (1, 8192, 16, 128) "
                 "(ring_attn, rank 1)")
    z3_main = ("GPT-3 1.3B 6-layer slice bf16 step under ZeRO-3 "
               "(sharding 2), a rank's (2, 1024, 16, 128) (zero3_gpt)")
    sp_main = ("GPT-3 1.3B blocks in a PipelineStageStack on {'pipe': 2}, "
               "a micro-batch (1, 1024, 16, 128) (spmd_pipe)")
    z3_step = layouts["zero3_gpt_per_step_rank0"]
    sp_step = layouts["spmd_pipe_per_step_rank0"]
    # rank 1 runs one causal block (its diagonal) and the rest full
    fwd1 = layouts["ring_attn_fwd_rank1"]
    bwd1 = layouts["ring_attn_bwd_rank1"]
    diag = {k: min(v, 1) for k, v in {**fwd1, **bwd1}.items()}
    full = {k: v - min(v, 1) for k, v in {**fwd1, **bwd1}.items()}
    full_main = ring_main.replace("(ring_attn, rank 1)",
                                  "its full block below the diagonal "
                                  "(ring_attn, rank 1)")
    return [
        fwd_entry("ring", at(rows, RING_RANK_SHAPE),
                  diag[f"{fa.KERNEL_NAME}.{tc}"], ring_main),
        *bwd_entries("ring", RING_RANK_SHAPE, diag, ring_main),
        fwd_entry("ring_full", at_full(rows, RING_RANK_SHAPE),
                  full[f"{fa.KERNEL_NAME}.{tc}"], full_main),
        *bwd_entries("ring_full", RING_RANK_SHAPE, full, full_main,
                     causal=False),
        fwd_entry("zero3", at(rows, (Z3_BATCH, TRAIN_SEQ, 16, 128)),
                  z3_step[f"{fa.KERNEL_NAME}.{tc}"], z3_main),
        *bwd_entries("zero3", (Z3_BATCH, TRAIN_SEQ, 16, 128), z3_step,
                     z3_main),
        fwd_entry("spmd_pipe", at(rows, SP_RANK_SHAPE),
                  sp_step[f"{fa.KERNEL_NAME}.{tc}"], sp_main),
        *bwd_entries("spmd_pipe", SP_RANK_SHAPE, sp_step, sp_main)]


def kernel_entries(fa, rows, bwd_rows, serve, train, compiled, amp, bert,
                   vision, serving, hapi, optim, surface, nn_rest, zoo,
                   dist_tune, hybrid, pipeline, layouts, auto_moe, elastic,
                   ps):
    """The kernels line: each kernel variant at the shape of the main path
    that runs it, with its launches on that path. bf16 (tensor cores):
    B1 at the prefill shape (and its training-shape time), B2 and B3 at
    the training shape, each with its launches per replayed step of the
    captured step (compiled_train) and of the amp + recompute step
    (amp_train), counted by kernel name; f32 (SIMT): the f32 correctness
    runs at full width, timed at (4, 512, 16, 64) causal; then B1, B2 and
    B3 tc_bf16 again, non-causal at BERT's shape (8, 512, 12, 64), with
    their launches in a bf16 BERT-base step (bert_flash) and per replay
    of its captured step. Every entry also carries its launches on the
    conv net paths (``vision``: {path: {kernel: launches}}), all 0, and on
    the serving lanes (``serving``), for its own variant: per BERT-base
    batch (by kernel name in a replay of the server's bucket-8 graph), in
    the BERT server's warm-up and captures (the wrappers' counts), and in
    the ResNet-50 and decode lanes; and on the training API's lanes
    (``hapi``), per step: by kernel name in a replay of hapi_bert's
    captured step for the tensor-core variants (the wrappers' counts for
    the SIMT ones), the wrappers' counts over the whole lane for
    hapi_lenet and hapi_resnet50; on the script surface's lanes
    (``optim``) and on the common surface's (``surface``: nn_cases,
    mobilenet_train, mobile_nets_small, mobilenet_eval, state_guard, all
    0), the wrappers' counts over each lane; and on the rest of nn's
    (``nn_rest``): the wrappers' counts over the translate path's encode
    and beam search (B1 tc_bf16 6, the encoder's six layers) and over
    each other lane (all 0); and on the zoo group's (``zoo``): the
    wrappers' counts over each vision lane (all 0) and, for tokenize_bert,
    the launches in a replay of its graph by kernel name (B1 tc_bf16 12 a
    batch without a mask, 0 in the masked batch). B1 tc_bf16 has a row of
    its own at translate's encoder shape (8, 256, 8, 64), with its
    launches there. And on the dist_tune group's (``launches_dist_tune``):
    per step on each rank of dp_gpt (GPT-medium bf16 under DataParallel at
    2 ranks on the card), with the tile each kernel ran at, and over
    dp_fit and the NCCL collectives (0). And on the hybrid group's
    (``launches_hybrid``): per step on each rank of tp_gpt (GPT-3 1.3B
    bf16 at mp 2), in its bf16 prefill, per step on each rank of zero_gpt
    and on rank 0 of hybrid_geometry (f32), with tp_gpt's tiles; B1, B2
    and B3 tc_bf16 have rows of their own at a TP rank's training shape
    (2, 1024, 8, 128) and B1 at its prefill's (4, 512, 8, 128), causal,
    with their launches there; B1 simt_f32 at the prefill's shape (tp_gpt's
    f32 greedy decode) and B1, B2 and B3 simt_f32 at a hybrid_geometry
    rank's (2, 256, 8, 128), causal, likewise. And on the pipeline group's
    (``launches_pipeline``): per step on ranks 0 and 3 of pp_gpt (GPT-3
    1.3B bf16 at pp 2 x mp 2), per step (the first, eager discovery and
    capture) on rank 0 of pp_compiled, and over the first steps of
    hybrid_ckpt, with pp_gpt's tiles; B1, B2 and B3 tc_bf16 have rows of
    their own at a pp_gpt rank's micro-batch (1, 1024, 8, 128), causal,
    with their launches a step there. And on the layouts group's
    (``launches_layouts``): per step on each rank of zero3_gpt and of
    spmd_pipe, and in one ring_attention forward and backward on each
    rank of ring_attn, with zero3_gpt's tiles; B1, B2 and B3 tc_bf16 have
    rows of their own at a ring rank's (1, 4096, 16, 128), causal (its
    diagonal block) and not (the block below it), at zero3_gpt's (2,
    1024, 16, 128) and at spmd_pipe's micro-batch (1, 1024, 16, 128)
    (``layout_entries``)."""
    src = "paddle_tpu_torch/csrc/"
    ref = "paddle_tpu/ops/pallas/flash_attention.py:"
    keys = ("ms", "wall_ms", "plain_ms", "library_ms", "library_wall_ms",
            "bound_by", "shape", "dtype", "causal", "variant",
            "share_of_bound", "factor_vs_library")

    def entry(name, source, line, row, launches, err, **extra):
        kernel = name.split(".")[0]
        variant = ".".join(name.split(".")[:2])
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": ref + str(line), "launches": launches,
                "max_abs_err": err, "bound_ms": row["bound_us"] / 1e3,
                **{k: row[k] for k in keys},
                "launches_conv_nets": {path: counts[kernel]
                                       for path, counts in vision.items()},
                "launches_serving": {
                    lane: counts.get(variant, counts.get(kernel, 0))
                    for lane, counts in serving.items()},
                "launches_hapi": {
                    lane: counts.get(variant, counts.get(kernel, 0))
                    for lane, counts in hapi.items()},
                "launches_optim": {
                    lane: counts.get(variant, 0)
                    for lane, counts in optim.items()},
                "launches_surface": {
                    lane: counts.get(variant, 0)
                    for lane, counts in surface.items()},
                "launches_nn_rest": {
                    lane: counts.get(variant, 0)
                    for lane, counts in nn_rest.items()},
                "launches_zoo": {
                    lane: counts.get(variant, 0)
                    for lane, counts in zoo.items()},
                "launches_dist_tune": {
                    **{lane: dist_tune[lane].get(variant, 0)
                       for lane in ("dp_gpt_per_step_rank0",
                                    "dp_gpt_per_step_rank1",
                                    "collectives_nccl")},
                    "dp_fit": dist_tune["dp_fit"][kernel],
                    "dp_gpt_tile": dist_tune["dp_gpt_tiles"][kernel]
                    if variant.endswith(fa.TC) else None},
                "launches_hybrid": {
                    **{lane: counts.get(variant, 0)
                       for lane, counts in hybrid.items()
                       if lane != "tp_gpt_tiles"},
                    "tp_gpt_tile": hybrid["tp_gpt_tiles"][kernel]
                    if variant.endswith(fa.TC) else None},
                "launches_pipeline": {
                    **{lane: counts.get(variant, 0)
                       for lane, counts in pipeline.items()
                       if lane != "pp_gpt_tiles"},
                    "pp_gpt_tile": pipeline["pp_gpt_tiles"][kernel]
                    if variant.endswith(fa.TC) else None},
                "launches_layouts": {
                    **{lane: counts.get(variant, 0)
                       for lane, counts in layouts.items()
                       if lane != "zero3_gpt_tiles"},
                    "zero3_gpt_tile": layouts["zero3_gpt_tiles"][kernel]
                    if variant.endswith(fa.TC) else None},
                "launches_auto_moe": {
                    **{lane: counts.get(variant, 0)
                       for lane, counts in auto_moe.items()
                       if not lane.endswith("_tiles")},
                    **{lane: auto_moe[lane][kernel]
                       if variant.endswith(fa.TC) else None
                       for lane in ("auto_engine_tiles", "moe_ep_tiles")}},
                "launches_elastic": {
                    **{lane: counts.get(variant, 0)
                       for lane, counts in elastic.items()
                       if not lane.endswith("_tiles")},
                    "elastic_tile": elastic["elastic_tiles"][kernel]
                    if variant.endswith(fa.TC) else None},
                **extra}
    fwd_tc, fwd_train, fwd_simt = rows[0], rows[2], rows[6]
    dkv_tc, dkv_simt = bwd_rows["dkv"][0], bwd_rows["dkv"][4]
    dq_tc, dq_simt = bwd_rows["dq"][0], bwd_rows["dq"][4]
    tc, simt = fa.TC, fa.SIMT
    scope = {"plain_scope": dkv_tc["plain_scope"],
             "library_scope": dkv_tc["library_scope"]}

    def captured(name):
        return {"launches_per_replay_compiled_train":
                    compiled["replay_profile"]["flash_launches"][name],
                "launches_per_step_amp_train":
                    amp["replay_profile"]["flash_launches"][name]}
    return [
        entry(f"{fa.KERNEL_NAME}.{tc}", "flash_attn_fwd_tc.cu", 114, fwd_tc,
              serve["bfloat16"]["flash_variant_launches"],
              fwd_tc["max_abs_err_o"], rel_l2=fwd_tc["rel_l2_o"],
              main_path="bf16 prefill (serve)",
              launches_train=train["launches"][f"{fa.KERNEL_NAME}.{tc}"],
              train_shape_ms=fwd_train["ms"],
              train_shape_ms_with_f32_out=fwd_train["ms_with_f32_out"],
              train_shape_library_ms=fwd_train["library_ms"],
              **captured(fa.KERNEL_NAME)),
        entry(f"{fa.KERNEL_NAME}.{simt}", "flash_attn_fwd.cu", 114, fwd_simt,
              serve["float32"]["flash_variant_launches"],
              fwd_simt["max_abs_err_o"],
              main_path="f32 prefill (serve, correctness run)"),
        entry(f"{fa.DKV_KERNEL}.{tc}", "flash_attn_dkv_tc.cu", 200, dkv_tc,
              train["launches"][f"{fa.DKV_KERNEL}.{tc}"],
              dkv_tc["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dkv_tc["rel_l2_by_output"].items()},
              main_path="bf16 training step (train)",
              launches_per_step=train["launches_per_step"][fa.DKV_KERNEL],
              **captured(fa.DKV_KERNEL), **scope),
        entry(f"{fa.DKV_KERNEL}.{simt}", "flash_attn_bwd.cu", 200, dkv_simt,
              train["f32_launches"][f"{fa.DKV_KERNEL}.{simt}"],
              dkv_simt["max_abs_err"],
              main_path="f32 training step (train_check, correctness run)",
              **scope),
        entry(f"{fa.DQ_KERNEL}.{tc}", "flash_attn_dq_tc.cu", 247, dq_tc,
              train["launches"][f"{fa.DQ_KERNEL}.{tc}"],
              dq_tc["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dq_tc["rel_l2_by_output"].items()},
              main_path="bf16 training step (train)",
              launches_per_step=train["launches_per_step"][fa.DQ_KERNEL],
              **captured(fa.DQ_KERNEL), **scope),
        entry(f"{fa.DQ_KERNEL}.{simt}", "flash_attn_bwd.cu", 247, dq_simt,
              train["f32_launches"][f"{fa.DQ_KERNEL}.{simt}"],
              dq_simt["max_abs_err"],
              main_path="f32 training step (train_check, correctness run)",
              **scope),
        entry(f"{fa.KERNEL_NAME}.{tc}.translate", "flash_attn_fwd_tc.cu",
              114, rows[-2], nn_rest["translate"][f"{fa.KERNEL_NAME}.{tc}"],
              rows[-2]["max_abs_err_o"], rel_l2=rows[-2]["rel_l2_o"],
              main_path="Transformer-base bf16 encode at 8 x 256, "
                        "non-causal (translate)"),
        *bert_entries(fa, entry, rows[-1], bwd_rows, bert, scope),
        *tp_entries(fa, entry, rows, bwd_rows, hybrid, scope),
        *pp_entries(fa, entry, rows, bwd_rows, pipeline, scope),
        *layout_entries(fa, entry, rows, bwd_rows, layouts, scope),
        *auto_moe_entries(fa, entry, rows, bwd_rows, auto_moe, scope),
        *elastic_entries(fa, entry, rows, bwd_rows, elastic, scope),
        *ps_entries(fa, entry, rows, bwd_rows, ps, scope)]


def pp_entries(fa, entry, rows, bwd_rows, pipeline, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 at a pp_gpt rank's
    micro-batch (1, 1024, 8, 128), causal, with their launches a step
    (rank 0). The recompute's B1 also writes O in f32; the forward's does
    not, and both are half of B1's launches: the row times the one with
    the f32 O, beside the other."""
    def at(found):
        return next(r for r in found if r["shape"] == list(PP_RANK_SHAPE)
                    and r["dtype"] == "bfloat16" and r["causal"])
    fwd, dkv, dq = at(rows), at(bwd_rows["dkv"]), at(bwd_rows["dq"])
    step = pipeline["pp_gpt_per_step_rank0"]
    tc = fa.TC
    main = ("GPT-3 1.3B bf16 1F1B step at pp 2 x mp 2, a rank's micro-batch "
            "(1, 1024, 8, 128), causal (pp_gpt)")
    return [
        entry(f"{fa.KERNEL_NAME}.{tc}.pp", "flash_attn_fwd_tc.cu", 114, fwd,
              step[f"{fa.KERNEL_NAME}.{tc}"], fwd["max_abs_err_o"],
              rel_l2=fwd["rel_l2_o"], main_path=main,
              ms=fwd["ms_with_f32_out"],
              bound_ms=fwd["bound_us_with_f32_out"] / 1e3,
              bound_by=fwd["bound_by_with_f32_out"],
              share_of_bound=fwd["bound_us_with_f32_out"] / 1e3
              / fwd["ms_with_f32_out"],
              factor_vs_library=fwd["ms_with_f32_out"] / fwd["library_ms"],
              ms_without_f32_out=fwd["ms"]),
        entry(f"{fa.DKV_KERNEL}.{tc}.pp", "flash_attn_dkv_tc.cu", 200, dkv,
              step[f"{fa.DKV_KERNEL}.{tc}"], dkv["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dkv["rel_l2_by_output"].items()},
              main_path=main, **scope),
        entry(f"{fa.DQ_KERNEL}.{tc}.pp", "flash_attn_dq_tc.cu", 247, dq,
              step[f"{fa.DQ_KERNEL}.{tc}"], dq["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dq["rel_l2_by_output"].items()},
              main_path=main, **scope)]


def tp_entries(fa, entry, rows, bwd_rows, hybrid, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 at a TP rank's
    training shape and B1 at its prefill's, with their launches a step
    (tp_gpt rank 0) and in the prefill; the training step's B1 also
    writes O in f32, so its time and bound are those. Then the f32 (SIMT)
    rows: B1 at the prefill's shape, with its launches in tp_gpt's f32
    greedy decode, and B1, B2 and B3 at a hybrid_geometry rank's
    (2, 256, 8, 128), with their launches a step there."""
    tc, simt = fa.TC, fa.SIMT

    def at(found, shape, dtype="bfloat16"):
        return next(r for r in found if r["shape"] == list(shape)
                    and r["dtype"] == dtype and r["causal"])
    fwd, pre = at(rows, TP_RANK_SHAPE), at(rows, TP_PREFILL_SHAPE)
    dkv, dq = at(bwd_rows["dkv"], TP_RANK_SHAPE), \
        at(bwd_rows["dq"], TP_RANK_SHAPE)
    pre32 = at(rows, TP_PREFILL_SHAPE, "float32")
    geo = {"fwd": at(rows, GEOM_RANK_SHAPE, "float32"),
           "dkv": at(bwd_rows["dkv"], GEOM_RANK_SHAPE, "float32"),
           "dq": at(bwd_rows["dq"], GEOM_RANK_SHAPE, "float32")}
    geo_step = hybrid["hybrid_geometry_per_step_rank0"]
    geo_main = ("GPT-3 1.3B geometry f32 training step at dp 2 x mp 2, a "
                "rank's (2, 256, 8, 128), causal (hybrid_geometry)")
    step = hybrid["tp_gpt_per_step_rank0"]
    main = ("GPT-3 1.3B bf16 training step at mp 2, a rank's "
            "(2, 1024, 8, 128), causal (tp_gpt)")
    return [
        entry(f"{fa.KERNEL_NAME}.{tc}.tp", "flash_attn_fwd_tc.cu", 114, fwd,
              step[f"{fa.KERNEL_NAME}.{tc}"], fwd["max_abs_err_o"],
              rel_l2=fwd["rel_l2_o"], main_path=main,
              ms=fwd["ms_with_f32_out"],
              bound_ms=fwd["bound_us_with_f32_out"] / 1e3,
              bound_by=fwd["bound_by_with_f32_out"],
              share_of_bound=fwd["bound_us_with_f32_out"] / 1e3
              / fwd["ms_with_f32_out"],
              factor_vs_library=fwd["ms_with_f32_out"] / fwd["library_ms"],
              ms_without_f32_out=fwd["ms"]),
        entry(f"{fa.KERNEL_NAME}.{tc}.tp_prefill", "flash_attn_fwd_tc.cu",
              114, pre,
              hybrid["tp_prefill_rank0"][f"{fa.KERNEL_NAME}.{tc}"],
              pre["max_abs_err_o"], rel_l2=pre["rel_l2_o"],
              main_path="GPT-3 1.3B bf16 prefill at mp 2, a rank's "
                        "(4, 512, 8, 128), causal (tp_gpt)"),
        entry(f"{fa.DKV_KERNEL}.{tc}.tp", "flash_attn_dkv_tc.cu", 200, dkv,
              step[f"{fa.DKV_KERNEL}.{tc}"], dkv["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dkv["rel_l2_by_output"].items()},
              main_path=main, **scope),
        entry(f"{fa.DQ_KERNEL}.{tc}.tp", "flash_attn_dq_tc.cu", 247, dq,
              step[f"{fa.DQ_KERNEL}.{tc}"], dq["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dq["rel_l2_by_output"].items()},
              main_path=main, **scope),
        entry(f"{fa.KERNEL_NAME}.{simt}.tp_prefill", "flash_attn_fwd.cu",
              114, pre32,
              hybrid["tp_greedy_f32_rank0"][f"{fa.KERNEL_NAME}.{simt}"],
              pre32["max_abs_err_o"],
              main_path="GPT-3 1.3B f32 greedy decode at mp 2, a rank's "
                        "(4, 512, 8, 128) prefill, causal (tp_gpt)"),
        entry(f"{fa.KERNEL_NAME}.{simt}.geometry", "flash_attn_fwd.cu", 114,
              geo["fwd"], geo_step[f"{fa.KERNEL_NAME}.{simt}"],
              geo["fwd"]["max_abs_err_o"], main_path=geo_main),
        entry(f"{fa.DKV_KERNEL}.{simt}.geometry", "flash_attn_bwd.cu", 200,
              geo["dkv"], geo_step[f"{fa.DKV_KERNEL}.{simt}"],
              geo["dkv"]["max_abs_err"], main_path=geo_main, **scope),
        entry(f"{fa.DQ_KERNEL}.{simt}.geometry", "flash_attn_bwd.cu", 247,
              geo["dq"], geo_step[f"{fa.DQ_KERNEL}.{simt}"],
              geo["dq"]["max_abs_err"], main_path=geo_main, **scope)]


def bert_entries(fa, entry, fwd, bwd_rows, bert, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 at BERT's shape,
    non-causal."""
    replay = bert["captured"]["kernel_path"]["replay_profile"]
    tc = fa.TC

    def one(kernel, source, line, row, err, **extra):
        return entry(f"{kernel}.{tc}.bert", source, line, row,
                     bert["launches"][f"{kernel}.{tc}"], err,
                     main_path="BERT-base bf16 training step at 8 x 512, "
                               "non-causal (bert_flash)",
                     launches_per_replay_bert_flash=replay[
                         "flash_launches"][kernel], **extra)
    dkv, dq = bwd_rows["dkv"][-1], bwd_rows["dq"][-1]
    whole = bwd_rows["whole"][-1]
    return [
        # the training step's B1 also writes O in f32: its time and bound
        one(fa.KERNEL_NAME, "flash_attn_fwd_tc.cu", 114, fwd,
            fwd["max_abs_err_o"], rel_l2=fwd["rel_l2_o"],
            ms=fwd["ms_with_f32_out"],
            bound_ms=fwd["bound_us_with_f32_out"] / 1e3,
            bound_by=fwd["bound_by_with_f32_out"],
            share_of_bound=fwd["bound_us_with_f32_out"] / 1e3
            / fwd["ms_with_f32_out"],
            factor_vs_library=fwd["ms_with_f32_out"] / fwd["library_ms"],
            ms_without_f32_out=fwd["ms"]),
        one(fa.DKV_KERNEL, "flash_attn_dkv_tc.cu", 200, dkv,
            dkv["max_abs_err"],
            rel_l2={o: g["rel_l2"]
                    for o, g in dkv["rel_l2_by_output"].items()},
            whole_backward_ms=whole["ms"],
            whole_backward_bound_ms=whole["bound_us"] / 1e3, **scope),
        one(fa.DQ_KERNEL, "flash_attn_dq_tc.cu", 247, dq, dq["max_abs_err"],
            rel_l2={o: g["rel_l2"]
                    for o, g in dq["rel_l2_by_output"].items()},
            whole_backward_ms=whole["ms"],
            whole_backward_bound_ms=whole["bound_us"] / 1e3, **scope)]


# the auto_moe group (rank processes on the one card over gloo, one spawn of
# AUTO_WORLD; the serial Engine and incubate_cases on this process while the
# ranks run): auto_engine, auto_parallel's Engine on bench's GPT-3 1.3B slice
# (bench.py:929-954) under ProcessMesh([0, 1], dim_names=["dp"]) with amp
# (bf16, O1), sharding at stage 3 then at stage 1 (degree 2) and gradient
# merge (k 2, avg): AE_MICRO micro-steps of AE_BATCH x 1024 (1 x 1024 a
# rank), then evaluate over AE_EVAL batches and predict over one; moe_ep, a
# user model of MOE_BLOCKS blocks at GPT-medium's width (FusedMultiHeadAttention
# (1024, 16), a LayerNorm, an incubate.MoELayer(1024, 4096, 8 experts, top 2,
# capacity factor 1.25, expert_axis "ep") with a residual), bf16 under amp,
# AdamW mp, on {"ep": 2}: 2 x 1024 tokens and 4 of the 8 experts a rank,
# MOE_STEPS steps; incubate_cases, the incubate ops card against host and a
# stack of ENC_LAYERS FusedTransformerEncoderLayers at BERT-base's width
AUTO_WORLD = 2
AE_BATCH, AE_MICRO, AE_MERGE, AE_EVAL = 2, 2, 2, 2
AE_RANK_SHAPE = (1, 1024, 16, 128)
AE_PREDICT_COLS = 4096
MOE_BLOCKS, MOE_D, MOE_HEADS, MOE_FF = 4, 1024, 16, 4096
MOE_EXPERTS, MOE_TOPK, MOE_CF, MOE_VOCAB = 8, 2, 1.25, 32000
MOE_RANK_BATCH, MOE_STEPS, MOE_AUX = 2, 3, 0.01
MOE_RANK_SHAPE = (2, 1024, 16, 64)
MOE_RTOL = 2.0 ** -7
ENC_LAYERS, ENC_D, ENC_HEADS, ENC_FF = 12, 768, 12, 3072
ENC_BATCH, ENC_SEQ, ENC_STEPS = 8, 512, 3
ENC_HOST_SHAPE, ENC_HOST_RTOL = (1, 256), 1e-4
CASE_RTOL = 1e-5


def bf16_bounds(got, bf16, f32):
    """The layouts group's bf16 rule: each value's relative gap to the
    serial bf16 run within twice that run's own gap to the serial f32 run
    + BF16_GRAD_SLACK. Returns (gaps, bounds)."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, bf16)]
    bounds = [BF16_GRAD_FACTOR * abs(b - f) / abs(f) + BF16_GRAD_SLACK
              for b, f in zip(bf16, f32)]
    return gaps, bounds


def rel_l2_np(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def gpt_loss(logits, labels):
    """The mean f32 softmax cross-entropy GPTForCausalLM computes with
    labels, as the Engine's loss of the logits."""
    import paddle_tpu_torch.nn.functional as F
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1))


def auto_strategy(pt, stage, amp_on):
    s = pt.distributed.auto_parallel.Strategy()
    s.amp.enable, s.amp.dtype, s.amp.level = amp_on, "bfloat16", "O1"
    if stage is not None:
        s.sharding.enable, s.sharding.degree = True, AUTO_WORLD
        s.sharding.stage = stage
    s.gradient_merge.enable = True
    s.gradient_merge.k_steps, s.gradient_merge.avg = AE_MERGE, True
    return s


def auto_streams(seed):
    """The micro-batches, the eval batches and the predict batch (the
    first eval batch's inputs), numpy, AE_BATCH x 1024 each."""
    xs, ys = bench_stream(seed + 5, AE_MICRO, AE_BATCH, TRAIN_SEQ)
    xe, ye = bench_stream(seed + 6, AE_EVAL, AE_BATCH, TRAIN_SEQ)
    return xs, ys, xe, ye


def auto_engine_run(torch, engine, seed, profile=False):
    """AE_MICRO micro-steps of ``engine.fit`` (one a call, the merge
    counter running across them), each timed with its B1-B3 launches,
    ZeRO-3 gathers and collectives; then evaluate and predict (the first
    AE_PREDICT_COLS logits of each position, f32, on the host); then,
    with ``profile``, one more micro-step under the profiler (it
    accumulates and does not step: the weights stay)."""
    from paddle_tpu_torch.distributed import spec_layout
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    from paddle_tpu_torch.resilience.recorder import get_recorder
    xs, ys, xe, ye = auto_streams(seed)
    rec = get_recorder()
    out = {"losses": [], "step_ms": [], "launches_per_micro_step": [],
           "zero3_collectives": [], "collectives": []}
    free_cuda(torch)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(AE_MICRO):
        if i == 1:
            steptimer.reset_steptimer()
        launch_counts.clear()
        spec_layout.reset_stats()
        rec.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["losses"].append(engine.fit([(xs[i], ys[i])])["loss"][0])
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches_per_micro_step"].append(flash_launches(fa,
                                                             launch_counts))
        out["zero3_collectives"].append(spec_layout.stats())
        out["collectives"].append(collective_tally(rec.entries()))
    out["collective_wait_ms_per_micro_step"] = steptimer.get_steptimer() \
        .breakdown()["phase_ms"].get("collective_wait", 0.0) / (AE_MICRO - 1)
    t0 = time.perf_counter()
    out["eval_loss"] = engine.evaluate(
        [(xe[j], ye[j]) for j in range(AE_EVAL)])["eval_loss"]
    out["eval_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits = engine.predict([xe[0]])[0]
    out["predict_s"] = time.perf_counter() - t0
    out["predict_shape"] = list(logits.shape)
    out["predict_finite"] = bool(torch.isfinite(logits).all())
    out["predict_cols"] = logits[..., :AE_PREDICT_COLS].float().cpu().numpy()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - before
    out["param_bytes"] = param_bytes(engine.model)
    out["optimizer_state_bytes"] = state_bytes(engine.optimizer)
    out["params"] = sum(p.numel() for p in engine.model.parameters())
    if profile:
        out.update(profiled_step(
            torch, lambda: engine.fit([(xs[0], ys[0])]),
            {k: float(Z3_LAYERS) for k in TC_KERNEL_NAMES}))
    return out


def auto_engine(torch, pt, seed, dtype, stage, amp_on, pm=None):
    """auto_parallel's Engine over bench's 1.3B slice in ``dtype`` (AdamW,
    multi_precision in bf16), lr 1e-4, the weights from the same CUDA
    generator in every process."""
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    model = slice_1p3b(torch, dtype, seed).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             multi_precision=dtype == torch.bfloat16,
                             parameters=model.parameters())
    return Engine(model, loss=gpt_loss, optimizer=opt,
                  strategy=auto_strategy(pt, stage, amp_on), process_mesh=pm)


def serial_auto_engine(torch, seed):
    """The serial Engines auto_engine is held to, at world size 1 on this
    process (the step captured through to_static): bf16 under amp with
    AdamW mp, and f32 without amp with AdamW, the same micro-batches,
    gradient merge, evaluate and predict."""
    import paddle_tpu_torch as pt
    out = {}
    for dtype, amp_on in ((torch.bfloat16, True), (torch.float32, False)):
        engine = auto_engine(torch, pt, seed, dtype, None, amp_on)
        out[str(dtype).split(".")[-1]] = auto_engine_run(torch, engine,
                                                         seed)
        del engine
        free_cuda(torch)
    return out


def rank_auto_engine(torch, seed, stage, cache_dir):
    """auto_engine on this rank at sharding ``stage``: the run (the
    predict logits' columns written to ``cache_dir`` by rank 0 for the
    parent), the tiles and the layout's facts."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    from paddle_tpu_torch.distributed.parallel import DataParallel
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    pm = ProcessMesh([0, 1], dim_names=["dp"])
    engine = auto_engine(torch, pt, seed, torch.bfloat16, stage, True, pm)
    out = auto_engine_run(torch, engine, seed, profile=True)
    cols = out.pop("predict_cols")
    if dist.get_rank() == 0:
        np.save(os.path.join(cache_dir, f"auto_engine_stage{stage}.npy"),
                cols)
    dev = torch.device("cuda")
    b, s, h, d = AE_RANK_SHAPE
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    out.update(
        tiles={fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
               fa.DQ_KERNEL: bwd[2]},
        sharded=sum(1 for p in engine.model.parameters()
                    if getattr(p, "fsdp_split", None) is not None),
        owned=len(getattr(engine.optimizer, "owned_parameters", ())),
        data_parallel=isinstance(engine._network, DataParallel),
        wrapped=type(engine.optimizer).__name__)
    del engine
    free_cuda(torch)
    return out


def moe_lm(torch, dtype, seed, expert_axis):
    """The moe_ep model, user code over public API: GPT-medium's token
    table (vocab 32000, width 1024), MOE_BLOCKS blocks (post-LN
    FusedMultiHeadAttention, a LayerNorm, the MoE layer on the norm's
    output in the stream's dtype, a residual), a final LayerNorm, the head
    tied to the table, the f32 cross-entropy plus MOE_AUX x the blocks'
    aux losses. The weights are drawn in f32 from a CUDA generator (the
    same numbers in every process), whole, then cast and loaded by name:
    an expert-parallel layer keeps its slice."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn as nn
    import paddle_tpu_torch.nn.functional as F

    class MoEBlock(nn.Layer):
        def __init__(self, axis, **factory):
            super().__init__(**factory)
            fk = self.factory_kwargs()
            self.attn = pt.incubate.nn.FusedMultiHeadAttention(
                MOE_D, MOE_HEADS, **fk)
            self.norm = nn.LayerNorm(MOE_D, **fk)
            self.moe = pt.incubate.MoELayer(
                MOE_D, MOE_FF, num_experts=MOE_EXPERTS, top_k=MOE_TOPK,
                capacity_factor=MOE_CF, expert_axis=axis, **fk)

        def forward(self, x):
            # under amp the post-LN attention and the norm return f32: the
            # MoE computes (and exchanges) in the layers' dtype
            h = self.attn(x)
            return h + self.moe(self.norm(h).to(self._dtype)).to(h.dtype)

    class MoELM(nn.Layer):
        def __init__(self, axis, dt, gen):
            super().__init__(device="cuda", dtype=dt, generator=gen)
            fk = self.factory_kwargs()
            self.wte = nn.Embedding(MOE_VOCAB, MOE_D, weight_attr=nn
                                    .initializer.Normal(0.0, 0.02), **fk)
            self.blocks = nn.LayerList([MoEBlock(axis, **fk)
                                        for _ in range(MOE_BLOCKS)])
            self.ln_f = nn.LayerNorm(MOE_D, **fk)
            self.hidden = None

        def forward(self, ids, labels):
            h = self.wte(ids)
            for block in self.blocks:
                h = block(h)
            self.hidden = h.detach()
            logits = F.linear(self.ln_f(h), self.wte.weight.t())
            aux = sum(b.moe.aux_loss for b in self.blocks)
            return F.cross_entropy(logits.reshape(-1, MOE_VOCAB).float(),
                                   labels.reshape(-1)) + MOE_AUX * aux
    full = MoELM(None, torch.float32,
                 torch.Generator(device="cuda").manual_seed(seed + 23))
    if dtype == torch.float32 and expert_axis is None:
        return full
    model = MoELM(expert_axis, dtype, None)
    pt.load_numpy_state_dict(model, full.state_dict())
    del full
    return model


def moe_dropped(model):
    return [b.moe.dropped_tokens.tolist() for b in model.blocks]


def moe_watched(model, rank):
    """(name, this rank's slice of the parameter's gradient) of the
    gradients the lane holds: each block's expert weights (the slice rank
    ``rank`` owns), its gate, and block 0's qkv weight."""
    out = {}
    for i, b in enumerate(model.blocks):
        for n in ("w1", "b1", "w2", "b2"):
            g = getattr(b.moe, n).grad
            if getattr(getattr(b.moe, n), "ep_split", None) is None:
                g = g.chunk(AUTO_WORLD, 0)[rank]
            out[f"blocks.{i}.moe.{n}"] = g.detach().float().clone()
        out[f"blocks.{i}.moe.gate.weight"] = \
            b.moe.gate.weight.grad.detach().float().clone()
    out["blocks.0.attn.qkv.weight"] = \
        model.blocks[0].attn.qkv.weight.grad.detach().float().clone()
    return out


def moe_serial(torch, seed, dtype, rank, ids, labels):
    """The moe_ep model whole on this rank over the whole batch, MOE_STEPS
    steps: the losses and dropped tokens, and at the first step this
    rank's half of the last block's output and the watched gradients."""
    import paddle_tpu_torch as pt
    model = moe_lm(torch, dtype, seed, None).train()
    bf16 = dtype == torch.bfloat16
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=bf16,
                             parameters=model.parameters())
    out = {"losses": [], "dropped": []}
    half = MOE_RANK_BATCH
    for i in range(MOE_STEPS):
        with pt.amp.auto_cast(enable=bf16, dtype="bfloat16"):
            loss = model(ids[i], labels[i])
        loss.backward()
        out["dropped"].append(moe_dropped(model))
        if i == 0:
            out["hidden"] = model.hidden[rank * half:(rank + 1) * half] \
                .float().clone()
            out["grads"] = moe_watched(model, rank)
        opt.step()
        opt.clear_grad()
        out["losses"].append(loss.item())
    del model, opt
    free_cuda(torch)
    return out


def rank_moe_ep(torch, seed):
    """moe_ep on this rank: the serial model (all experts, the whole 4 x
    1024 batch) in bf16 first, and on rank 0 in f32; then the
    expert-parallel model on {"ep": 2} under DataParallel, this rank's 2 x
    1024, MOE_STEPS steps and one profiled: the first step's output, dropped
    tokens and watched gradients held to the serial run's, the losses (the
    ranks' mean), the exchange's bytes and wait, B1-B3 a step."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import utils as dutils
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    rank = dist.get_rank()
    xs, ys = bench_stream(seed + 9, MOE_STEPS + 1,
                          AUTO_WORLD * MOE_RANK_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(xs).cuda()
    labels = torch.from_numpy(ys).cuda()
    serial = moe_serial(torch, seed, torch.bfloat16, rank, ids, labels)
    out = {"serial_bf16_losses": serial["losses"]}
    if rank == 0:
        out["serial_f32_losses"] = moe_serial(
            torch, seed, torch.float32, rank, ids, labels)["losses"]
    dist.barrier()
    build_mesh({"ep": AUTO_WORLD})
    model = moe_lm(torch, torch.bfloat16, seed, "ep").train()
    net = pt.DataParallel(model)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    mine = slice(rank * MOE_RANK_BATCH, (rank + 1) * MOE_RANK_BATCH)

    def step(i):
        with pt.amp.auto_cast(dtype="bfloat16"):
            loss = net(ids[i, mine], labels[i, mine])
        loss.backward()
        return loss

    def finish(loss):
        opt.step()
        opt.clear_grad()
        return dist.all_reduce(loss.detach().clone(),
                               op=dist.ReduceOp.AVG).item()
    losses, step_ms, launches, exchange, dropped, aux = [], [], [], [], [], []
    free_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    for i in range(MOE_STEPS):
        if i == 1:
            steptimer.reset_steptimer()
        launch_counts.clear()
        dutils.reset_exchange_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(i)
        if i == 0:
            gaps = {n: rel_l2_t(g, serial["grads"][n])
                    for n, g in moe_watched(model, rank).items()}
            out["first_step_output_rel_l2"] = rel_l2_t(
                model.hidden.float(), serial["hidden"])
        losses.append(finish(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_launches(fa, launch_counts))
        exchange.append(dutils.exchange_stats())
        dropped.append(moe_dropped(model))
        aux.append(float(sum(b.moe.aux_loss for b in model.blocks)))
    prof = profiled_step(torch, lambda: finish(step(MOE_STEPS)),
                         {k: float(MOE_BLOCKS) for k in TC_KERNEL_NAMES})
    dev = torch.device("cuda")
    b, s, h, d = MOE_RANK_SHAPE
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, False, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, False, dev)
    out.update(
        losses=losses, step_ms=step_ms,
        step_ms_median=float(np.median(step_ms[1:])),
        collective_wait_ms_per_step=steptimer.get_steptimer().breakdown()[
            "phase_ms"].get("collective_wait", 0.0) / (MOE_STEPS - 1),
        launches_per_step=launches, exchange_per_step=exchange,
        dropped_per_step=dropped, serial_dropped_per_step=serial["dropped"],
        aux_loss_per_step=aux, first_step_grad_rel_l2=gaps,
        peak_mem_bytes=torch.cuda.max_memory_allocated() - before,
        param_bytes=param_bytes(model),
        expert_slices=sum(1 for p in model.parameters()
                          if getattr(p, "ep_split", None) is not None),
        tiles={fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
               fa.DQ_KERNEL: bwd[2]}, **prof)
    del net, model, opt
    free_cuda(torch)
    return out


def rank_auto_moe(torch, seed, cache_dir):
    out = {}
    for stage in (3, 1):
        out[f"auto_engine_stage{stage}"] = rank_auto_engine(torch, seed,
                                                            stage, cache_dir)
    out["moe_ep"] = rank_moe_ep(torch, seed)
    return out


def encoder_stack(torch, pt, dtype, device, gen):
    import paddle_tpu_torch.nn as nn
    return nn.LayerList([pt.incubate.nn.FusedTransformerEncoderLayer(
        ENC_D, ENC_HEADS, ENC_FF, dropout_rate=0.0, activation="gelu",
        device=device, dtype=dtype, generator=gen)
        for _ in range(ENC_LAYERS)])


def run_stack(stack, x):
    for layer in stack:
        x = layer(x)
    return x


def phase_incubate_cases(torch, seed):
    """The incubate ops on the card against the port's host run (TF32
    off): segment_* (with an empty segment), softmax_mask_fuse and its
    upper triangle, LookAhead and ModelAverage around SGD over 6 steps;
    then the stack of ENC_LAYERS FusedTransformerEncoderLayers at BERT-base's
    width: in f32 at ENC_HOST_SHAPE card (B1-B3 on their f32 variants)
    against host (the math path), and in bf16 at 8 x 512 with AdamW mp,
    ENC_STEPS steps and one profiled, B1-B3 ENC_LAYERS times a step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    rng = np.random.RandomState(seed + 31)
    out = {"gaps": {}}

    def both(fn, *arrays):
        host = fn(*[torch.from_numpy(a) for a in arrays])
        card = fn(*[torch.from_numpy(a).cuda() for a in arrays])
        return card.cpu(), host

    def gap(card, host):
        card, host = card.double(), host.double()
        fin = torch.isfinite(host)
        assert torch.equal(fin, torch.isfinite(card))
        return float((card[fin] - host[fin]).norm()
                     / host[fin].norm().clamp_min(1e-30))
    data = rng.randn(4096, 64).astype("float32")
    ids = np.sort(rng.randint(0, 300, 4096))
    ids[ids == 7] = 8   # an empty segment
    for mode in ("sum", "mean", "max", "min"):
        fn = getattr(pt.incubate, f"segment_{mode}")
        out["gaps"][f"segment_{mode}"] = gap(*both(fn, data, ids))
    x = rng.randn(2, 12, 512, 512).astype("float32")
    mask = np.where(rng.rand(2, 1, 512, 512) < 0.2, -1e4, 0.0).astype("f")
    out["gaps"]["softmax_mask_fuse"] = gap(*both(
        pt.incubate.softmax_mask_fuse, x, mask))
    out["gaps"]["softmax_mask_fuse_upper_triangle"] = gap(*both(
        pt.incubate.softmax_mask_fuse_upper_triangle, x))
    w = rng.randn(256, 256).astype("float32") / 16
    xb = rng.randn(64, 256).astype("float32")
    for name in ("LookAhead", "ModelAverage"):
        finals = []
        for device in ("cuda", "cpu"):
            p = torch.nn.Parameter(torch.from_numpy(w).to(device))
            inner = pt.optimizer.SGD(learning_rate=0.1, parameters=[p])
            avg = pt.incubate.ModelAverage(parameters=[p]) \
                if name == "ModelAverage" else None
            opt = pt.incubate.LookAhead(inner, alpha=0.5, k=3) \
                if avg is None else inner
            xt = torch.from_numpy(xb).to(device)
            for _ in range(6):
                loss = ((xt @ p).tanh() ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                if avg is not None:
                    avg.step()
            if avg is not None:
                avg.apply()
            finals.append(p.detach().cpu())
        out["gaps"][name] = gap(*finals)
    # the fused encoder stack, f32, card against host
    gen = torch.Generator(device="cuda").manual_seed(seed + 41)
    card = encoder_stack(torch, pt, torch.float32, "cuda", gen)
    host = encoder_stack(torch, pt, torch.float32, "cpu", None)
    pt.load_numpy_state_dict(host, card.state_dict())
    xh = rng.randn(*ENC_HOST_SHAPE, ENC_D).astype("float32")
    # a fixed cotangent: the mean square of a post-LN output is ~1 whatever
    # the input, so its gradients would be rounding noise
    gh = rng.randn(*ENC_HOST_SHAPE, ENC_D).astype("float32")
    grads = []
    for stack, device in ((card, "cuda"), (host, "cpu")):
        launch_counts.clear()
        xt = torch.from_numpy(xh).to(device).requires_grad_()
        y = run_stack(stack, xt)
        (y * torch.from_numpy(gh).to(device)).sum().backward()
        grads.append([y.detach().cpu(), xt.grad.cpu()]
                     + [p.grad.cpu() for p in stack.parameters()])
        if device == "cuda":
            out["f32_launches"] = flash_launches(fa, launch_counts)
    out["stack_f32_gaps"] = {
        "output": gap(grads[0][0], grads[1][0]),
        "input_grad": gap(grads[0][1], grads[1][1]),
        "worst_param_grad": max(gap(a, b) for a, b in
                                zip(grads[0][2:], grads[1][2:]))}
    del card, host, grads
    free_cuda(torch)
    # the fused encoder stack, bf16, 8 x 512, AdamW mp
    stack = encoder_stack(torch, pt, torch.bfloat16, "cuda", gen).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=stack.parameters())
    xs = torch.randn(ENC_STEPS + 1, ENC_BATCH, ENC_SEQ, ENC_D,
                     generator=gen, device="cuda").to(torch.bfloat16)
    target = torch.randn(ENC_BATCH, ENC_SEQ, ENC_D, generator=gen,
                         device="cuda")

    def step(x):
        loss = ((run_stack(stack, x).float() - target) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    losses, step_ms, launches = [], [], []
    for i in range(ENC_STEPS):
        launch_counts.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(xs[i]).item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(flash_launches(fa, launch_counts))
    def lead():
        # a long process's profile loses its window's first records: a
        # forward of the stack absorbs them
        with torch.no_grad():
            run_stack(stack, xs[0])
    out.update(losses=losses, step_ms=step_ms, launches_per_step=launches,
               **profiled_step(torch, lambda: step(xs[ENC_STEPS]),
                               {k: float(ENC_LAYERS)
                                for k in TC_KERNEL_NAMES}, lead=lead))
    del stack, opt
    free_cuda(torch)
    return out


def phase_auto_moe(torch, seed, beside=None):
    """auto_engine, moe_ep and incubate_cases: the AUTO_WORLD rank
    processes started, then the serial Engines, incubate_cases and
    ``beside()`` (the hapi group) on this process while they run. Returns
    each lane's B1-B3 launches, the seconds and what ``beside``
    returned."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    cache_dir = os.environ["PADDLE_TPU_AUTOTUNE_CACHE"]
    seconds = {}
    free_cuda(torch)
    # what this process holds while the ranks share the card
    emit({"phase": "auto_moe_start",
          "parent_allocated_bytes": torch.cuda.memory_allocated(),
          "parent_reserved_bytes": torch.cuda.memory_reserved()})
    started = start_ranks(AUTO_WORLD, seed, "auto_moe", cache_dir)
    try:
        t0 = time.perf_counter()
        serial = serial_auto_engine(torch, seed)
        seconds["serial_engine"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cases = phase_incubate_cases(torch, seed)
        seconds["incubate_cases"] = time.perf_counter() - t0
    except BaseException:
        end_ranks(started)
        raise
    besides, seconds["beside"] = run_beside(beside, started)
    ranks, seconds["serial_cases_and_ranks"] = join_ranks(started,
                                                          timeout=300)
    kernels = (fa.KERNEL_NAME, fa.DKV_KERNEL, fa.DQ_KERNEL)
    tc = fa.TC
    sb, sf = serial["bfloat16"], serial["float32"]
    for stage in (3, 1):
        ae = [r[f"auto_engine_stage{stage}"] for r in ranks]
        gaps, bounds = bf16_bounds(ae[0]["losses"], sb["losses"],
                                   sf["losses"])
        egap, ebound = bf16_bounds([ae[0]["eval_loss"]], [sb["eval_loss"]],
                                   [sf["eval_loss"]])
        cols = np.load(os.path.join(cache_dir,
                                    f"auto_engine_stage{stage}.npy"))
        os.remove(os.path.join(cache_dir, f"auto_engine_stage{stage}.npy"))
        pred_gap = rel_l2_np(cols, sb["predict_cols"])
        pred_bound = BF16_GRAD_FACTOR * rel_l2_np(sb["predict_cols"],
                                                  sf["predict_cols"]) \
            + BF16_GRAD_SLACK
        row = {"phase": "auto_engine", "stage": stage, "world": AUTO_WORLD,
               "config": f"GPT-3 1.3B slice v50304 h2048 L{Z3_LAYERS} a16 "
                         f"d128 bf16, AdamW mp, auto_parallel.Engine on "
                         f"ProcessMesh([0, 1], ['dp']), amp bf16 O1, "
                         f"sharding stage {stage} degree 2, gradient_merge "
                         f"k {AE_MERGE} avg",
               "micro_batch": [AE_BATCH, TRAIN_SEQ],
               "micro_steps": AE_MICRO,
               "serial_bf16_losses": sb["losses"],
               "serial_f32_losses": sf["losses"],
               "serial_bf16_step_ms": sb["step_ms"],
               "serial_peak_mem_bytes": sb["peak_mem_bytes"],
               "serial_param_bytes": sb["param_bytes"],
               "serial_optimizer_state_bytes": sb["optimizer_state_bytes"],
               "losses": ae[0]["losses"], "loss_rel_gaps": gaps,
               "loss_bounds": bounds, "eval_loss": ae[0]["eval_loss"],
               "serial_eval_loss": [sb["eval_loss"], sf["eval_loss"]],
               "eval_rel_gap": egap[0], "eval_bound": ebound[0],
               "predict_rel_l2": pred_gap, "predict_bound": pred_bound,
               "param_bytes_share": [d["param_bytes"] / sb["param_bytes"]
                                     for d in ae],
               "state_bytes_share": [d["optimizer_state_bytes"]
                                     / sb["optimizer_state_bytes"]
                                     for d in ae],
               **{f"rank{r}": d for r, d in enumerate(ae)}}
        emit(row)
        for d in ae:
            assert d["data_parallel"] and d["wrapped"] == \
                "ShardingOptimizerWrapper", d
            assert d["losses"] == ae[0]["losses"], [x["losses"] for x in ae]
            assert d["predict_shape"] == sb["predict_shape"] and \
                d["predict_finite"], d
            for counts in d["launches_per_micro_step"]:
                for kernel in kernels:
                    assert counts.get(f"{kernel}.{tc}", 0) == Z3_LAYERS, \
                        counts
            assert d["profiled_tc_launches_by_kernel_name"] == {
                k: Z3_LAYERS for k in kernels}, \
                d["profiled_tc_launches_by_kernel_name"]
        if stage == 3:
            # every parameter split in two: half the bytes of each kind
            assert sum(d["params"] for d in ae) == sb["params"], ae
            assert all(abs(s - 0.5) <= 0.01 for s in
                       row["param_bytes_share"] + row["state_bytes_share"]), \
                row
            assert all(d["sharded"] > 0 for d in ae), ae
        else:
            # whole parameters; the state of each rank's greedy part
            assert all(d["params"] == sb["params"] for d in ae), ae
            assert all(s == 1.0 for s in row["param_bytes_share"]), row
            assert all(d["sharded"] == 0 for d in ae), ae
            assert abs(sum(row["state_bytes_share"]) - 1.0) <= 0.01, row
        assert len(gaps) == AE_MICRO and all(
            g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)
        assert egap[0] <= ebound[0], (egap, ebound)
        assert pred_gap <= pred_bound, (pred_gap, pred_bound)

    moe = [r["moe_ep"] for r in ranks]
    gaps, bounds = bf16_bounds(moe[0]["losses"], moe[0]["serial_bf16_losses"],
                               moe[0]["serial_f32_losses"])
    row = {"phase": "moe_ep", "world": AUTO_WORLD,
           "config": f"{MOE_BLOCKS} blocks of FusedMultiHeadAttention("
                     f"{MOE_D}, {MOE_HEADS}) post-LN, LayerNorm, MoELayer("
                     f"{MOE_D}, {MOE_FF}, num_experts={MOE_EXPERTS}, "
                     f"top_k={MOE_TOPK}, capacity_factor={MOE_CF}, "
                     f"expert_axis='ep') with a residual; vocab "
                     f"{MOE_VOCAB} tied; bf16 amp O1, AdamW mp; {{'ep': 2}}",
           "global_batch": [AUTO_WORLD * MOE_RANK_BATCH, TRAIN_SEQ],
           "capacity": max(1, int(MOE_TOPK * AUTO_WORLD * MOE_RANK_BATCH
                                  * TRAIN_SEQ / MOE_EXPERTS * MOE_CF)),
           "losses": moe[0]["losses"], "loss_rel_gaps": gaps,
           "loss_bounds": bounds, "rel_l2_bound": MOE_RTOL,
           **{f"rank{r}": d for r, d in enumerate(moe)}}
    emit(row)
    for d in moe:
        assert d["losses"] == moe[0]["losses"], [x["losses"] for x in moe]
        assert d["expert_slices"] == 4 * MOE_BLOCKS, d["expert_slices"]
        assert d["first_step_output_rel_l2"] <= MOE_RTOL, d
        assert all(g <= MOE_RTOL
                   for g in d["first_step_grad_rel_l2"].values()), d
        # the same weights at the first step: the same tokens dropped
        # (later steps' weights differ by bf16 rounding; both are reported)
        assert d["dropped_per_step"][0] == d["serial_dropped_per_step"][0], d
        for counts in d["launches_per_step"]:
            for kernel in kernels:
                assert counts.get(f"{kernel}.{tc}", 0) == MOE_BLOCKS, counts
        assert d["profiled_tc_launches_by_kernel_name"] == {
            k: MOE_BLOCKS for k in kernels}, \
            d["profiled_tc_launches_by_kernel_name"]
        assert all(e["exchanges"] == 4 * MOE_TOPK * MOE_BLOCKS
                   for e in d["exchange_per_step"]), d["exchange_per_step"]
    assert len(gaps) == MOE_STEPS and all(
        g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)

    emit({"phase": "incubate_cases", **cases})
    assert all(g <= CASE_RTOL for g in cases["gaps"].values()), cases["gaps"]
    assert all(g <= ENC_HOST_RTOL for g in cases["stack_f32_gaps"].values()), \
        cases["stack_f32_gaps"]
    for kernel in kernels:
        assert cases["f32_launches"].get(f"{kernel}.{fa.SIMT}", 0) == \
            ENC_LAYERS, cases["f32_launches"]
    for counts in cases["launches_per_step"]:
        for kernel in kernels:
            assert counts.get(f"{kernel}.{tc}", 0) == ENC_LAYERS, counts
    assert cases["profiled_tc_launches_by_kernel_name"] == {
        k: ENC_LAYERS for k in kernels}, cases
    assert all(np.isfinite(cases["losses"])), cases["losses"]
    return {"auto_engine_stage3_per_micro_step_rank0":
                ranks[0]["auto_engine_stage3"]["launches_per_micro_step"][-1],
            "auto_engine_stage1_per_micro_step_rank0":
                ranks[0]["auto_engine_stage1"]["launches_per_micro_step"][-1],
            "moe_ep_per_step_rank0": moe[0]["launches_per_step"][-1],
            "moe_ep_per_step_rank1": moe[1]["launches_per_step"][-1],
            "fused_encoder_per_step": cases["launches_per_step"][-1],
            "fused_encoder_f32": cases["f32_launches"],
            "auto_engine_tiles":
                ranks[0]["auto_engine_stage3"]["tiles"],
            "moe_ep_tiles": moe[0]["tiles"], "seconds": seconds,
            "beside": besides}


def auto_moe_entries(fa, entry, rows, bwd_rows, auto_moe, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 on the auto_moe
    group's paths: an auto_engine rank's micro-batch (1, 1024, 16, 128),
    causal, with its launches a micro-step (stage 3, rank 0); a moe_ep
    rank's (2, 1024, 16, 64), non-causal, with its launches a step (rank
    0); the fused encoder stack's (8, 512, 12, 64), non-causal (BERT's
    rows), with its launches a step. Each forward writes O in f32 too:
    its time and bound are those."""
    tc = fa.TC

    def at(found, shape, causal):
        return next(r for r in found if r["shape"] == list(shape)
                    and r["dtype"] == "bfloat16" and r["causal"] == causal)

    def lane(suffix, shape, causal, counts, main):
        fwd = at(rows, shape, causal)
        out = [entry(f"{fa.KERNEL_NAME}.{tc}.{suffix}",
                     "flash_attn_fwd_tc.cu", 114, fwd,
                     counts.get(f"{fa.KERNEL_NAME}.{tc}", 0),
                     fwd["max_abs_err_o"], rel_l2=fwd["rel_l2_o"],
                     main_path=main, ms=fwd["ms_with_f32_out"],
                     bound_ms=fwd["bound_us_with_f32_out"] / 1e3,
                     bound_by=fwd["bound_by_with_f32_out"],
                     share_of_bound=fwd["bound_us_with_f32_out"] / 1e3
                     / fwd["ms_with_f32_out"],
                     factor_vs_library=fwd["ms_with_f32_out"]
                     / fwd["library_ms"], ms_without_f32_out=fwd["ms"])]
        for kernel, source, line in ((fa.DKV_KERNEL, "flash_attn_dkv_tc.cu",
                                      200),
                                     (fa.DQ_KERNEL, "flash_attn_dq_tc.cu",
                                      247)):
            row = at(bwd_rows["dkv" if kernel == fa.DKV_KERNEL else "dq"],
                     shape, causal)
            out.append(entry(f"{kernel}.{tc}.{suffix}", source, line, row,
                             counts.get(f"{kernel}.{tc}", 0),
                             row["max_abs_err"],
                             rel_l2={o: g["rel_l2"] for o, g in
                                     row["rel_l2_by_output"].items()},
                             main_path=main, **scope))
        return out
    return [
        *lane("auto_engine", AE_RANK_SHAPE, True,
              auto_moe["auto_engine_stage3_per_micro_step_rank0"],
              "GPT-3 1.3B 6-layer slice bf16 through auto_parallel.Engine "
              "(amp, ZeRO-3 over 'dp', gradient merge 2), a rank's "
              "micro-batch (1, 1024, 16, 128), causal (auto_engine)"),
        *lane("moe_ep", MOE_RANK_SHAPE, False,
              auto_moe["moe_ep_per_step_rank0"],
              "4 FusedMultiHeadAttention + MoELayer blocks at width 1024, "
              "bf16, expert-parallel on {'ep': 2}, a rank's (2, 1024, 16, "
              "64), non-causal (moe_ep)"),
        *lane("fused_encoder", BERT_FLASH_SHAPE, False,
              auto_moe["fused_encoder_per_step"],
              "12 FusedTransformerEncoderLayers at BERT-base's width, bf16 "
              "training step at 8 x 512, non-causal (incubate_cases)")]


# -- elastic: launch and in-job recovery (the launcher, the wire and p2p,
# ElasticManager, RecoveryManager and its journal, incubate.checkpoint) ----

# 4 steps: rank 1 dies in the last, the run resumes from step 2's
# checkpoint (6 before PR 21's cut for the script's time)
ELASTIC_WORLD, ELASTIC_STEPS, ELASTIC_CKPT_EVERY = 2, 4, 2
# GPT-medium's layers in the elastic launches: 6 of its 24 (12 before the
# ps group came, cut for the script's time, PERF.md section 4)
ELASTIC_LAYERS = 6
# rank 1 of the recovered launch dies at this step of its first
# incarnation, with this exit code
ELASTIC_KILL_RANK, ELASTIC_KILL_STEP, ELASTIC_KILLED = 1, 3, 9
ELASTIC_RANK_SHAPE = (2, 1024, 16, 64)
# the blocked rank must hear the abort in seconds (the group's own
# deadline is FLAGS_collective_timeout, 300 s)
ELASTIC_ABORT_S = 10.0
ELASTIC_LAUNCH_TIMEOUT = 300
# the first run of elastic_lenet crashes inside epoch 1 (0-based)
ELASTIC_LENET = {"epochs": 3, "crash_after": 1, "batches": 8, "batch": 64}


def elastic_stats(rank):
    """fleet.metrics' inputs on each rank: AUC histograms, the counts
    and errors (acc, rmse) and a vector (sum)."""
    rng = np.random.RandomState(70 + rank)
    return {"pos": rng.randint(0, 50, 64).astype("float64"),
            "neg": rng.randint(0, 50, 64).astype("float64"),
            "sqrerr": rng.rand(256), "n": np.array([256.0]),
            "correct": np.array([float(rng.randint(100, 256))]),
            "v": rng.randn(8)}


def elastic_tools(torch, rank, out):
    """The other ranks' tools over the 2 launched ranks: p2p's group
    collectives on tensors from the card, fleet.metrics over both ranks'
    statistics, then an abort: rank 1 fails inside an all_reduce through
    an injected fault while rank 0 waits in the same all_reduce."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import p2p
    from paddle_tpu_torch.distributed.fleet import metrics
    from paddle_tpu_torch.resilience import faults
    ranks = list(range(ELASTIC_WORLD))
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4) \
        * (rank + 1)
    t0 = time.perf_counter()
    out["p2p"] = {
        "all_reduce": p2p.group_all_reduce(x, ranks).tolist(),
        "all_reduce_max": p2p.group_all_reduce(x, ranks, op="max").tolist(),
        "all_gather": p2p.group_all_gather(x, ranks).tolist(),
        "broadcast": p2p.group_broadcast(x, ranks, src=1).tolist()}
    p2p.group_barrier(ranks)
    out["p2p"]["seconds"] = time.perf_counter() - t0
    s = elastic_stats(rank)
    out["metrics"] = {
        "acc": metrics.acc(torch.tensor(s["correct"], device="cuda"),
                           s["n"]),
        "auc": metrics.auc(torch.tensor(s["pos"], device="cuda"),
                           s["neg"]),
        "rmse": metrics.rmse(s["sqrerr"].sum(), s["n"]),
        "sum": metrics.sum(s["v"]).tolist()}
    t = torch.ones(1 << 20, device="cuda")
    if rank == 1:
        time.sleep(1.0)   # rank 0 waits in the all_reduce by now
        faults.configure("collective.all_reduce:#1")
    t_enter = time.time()
    t0 = time.monotonic()
    try:
        dist.all_reduce(t)
        out["abort"] = {"raised": None}
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        out["abort"] = {"raised": type(e).__name__, "message": str(e)[:400],
                        "src": getattr(e, "src", None),
                        "section": getattr(e, "section", None),
                        "t_enter": t_enter, "t_error": time.time(),
                        "seconds": time.monotonic() - t0}


def elastic_job_main(torch, args):
    """One rank of the elastic group's launches (started by ``python -m
    paddle_tpu_torch.distributed.launch``): GPT-medium bf16 under
    DataParallel, this rank's 2 x 1024 of bench's 4 x 1024 stream,
    AdamW(multi_precision), ELASTIC_STEPS steps under a RecoveryManager
    with an ElasticManager on a FileStore in the job's directory, a
    hybrid checkpoint after every second step. With ``--elastic-kill R``
    rank R dies at ELASTIC_KILL_STEP through a fault site of its first
    incarnation (PADDLE_TPU_GENERATION unset), by os._exit. Each step
    records its global loss, ms, collective_wait, the generation and the
    B1-B3 launches; with ``--elastic-tools`` the tools follow. Writes
    ``rank<r>.inc<incarnation>.json`` in the job's directory."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import p2p
    from paddle_tpu_torch.distributed.checkpoint import (
        load_hybrid_checkpoint, save_hybrid_checkpoint)
    from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                           FileStore)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.profiler import steptimer
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.recovery import (RECOVERABLE,
                                                      RecoveryManager,
                                                      current_generation)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faulthandler.dump_traceback_later(RANK_STACK_DUMP_S, repeat=True)
    job = args.elastic_job
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    incarnation = int(os.environ.get("PADDLE_TPU_GENERATION", "0") or 0)
    pt.set_flags({"FLAGS_recovery_backoff_base": 0.0})
    if rank == args.elastic_kill and incarnation == 0:
        faults.configure(f"elastic.kill:#{ELASTIC_KILL_STEP + 1}")
    t_start = time.time()
    em = ElasticManager(FileStore(os.path.join(job, "store")), "elastic",
                        np_min=ELASTIC_WORLD, np_max=ELASTIC_WORLD,
                        rank=rank,
                        endpoint=os.environ["PADDLE_CURRENT_ENDPOINT"])
    em.register()
    gen0, _ = em.rendezvous(timeout=ELASTIC_LAUNCH_TIMEOUT)
    dist.init_parallel_env()
    p2p.connect()
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024,
                    num_layers=ELASTIC_LAYERS, num_heads=16,
                    max_position_embeddings=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(args.seed))
    model.train()
    dp = pt.DataParallel(model)
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    per = TRAIN_BATCH // ELASTIC_WORLD
    xs, ys = bench_stream(args.seed, ELASTIC_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    xs = torch.from_numpy(xs[:, rank * per:(rank + 1) * per]).cuda()
    ys = torch.from_numpy(ys[:, rank * per:(rank + 1) * per]).cuda()
    ckpt = os.path.join(job, "gpt.pdparams")
    out = {"rank": rank, "incarnation": incarnation,
           "ready_s": time.time() - t_start, "steps": {}, "saves": [],
           "loads": [], "errors": []}

    def restore(gen):
        p2p.connect()
        opt.clear_grad()   # a step cut short leaves its local gradients
        if not os.path.exists(ckpt):
            return {"step": 0}
        t0 = time.perf_counter()
        meta = load_hybrid_checkpoint(ckpt, dp, opt)
        torch.cuda.synchronize()
        out["loads"].append({"generation": gen, "step": meta["step"],
                             "seconds": time.perf_counter() - t0,
                             "bytes": os.path.getsize(ckpt),
                             "t_done": time.time()})
        return meta

    def train(resume):
        start = (resume or restore(gen0))["step"]
        for step in range(start, ELASTIC_STEPS):
            if faults.should_inject("elastic.kill"):
                with open(os.path.join(job, "death.json"), "w") as f:
                    json.dump({"rank": rank, "step": step,
                               "t": time.time()}, f)
                os._exit(ELASTIC_KILLED)
            launch_counts.clear()
            steptimer.reset_steptimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = dp(xs[step], labels=ys[step])
            loss.backward()
            opt.step()
            opt.clear_grad()
            g = loss.detach().float().reshape(1).clone()
            glob = dist.all_reduce(g, op=dist.ReduceOp.AVG).item()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out["steps"][str(step)] = {
                "loss": glob, "ms": ms, "generation": current_generation(),
                "collective_wait_ms": steptimer.get_steptimer().breakdown()[
                    "phase_ms"].get("collective_wait", 0.0),
                "launches": {k: launch_counts[k] for k in launch_counts
                             if k.split(".")[0] in fa.KERNEL_NAMES},
                "t_end": time.time()}
            if (step + 1) % ELASTIC_CKPT_EVERY == 0:
                t0 = time.perf_counter()
                save_hybrid_checkpoint(ckpt, dp, opt, meta={"step": step + 1})
                out["saves"].append({"step": step + 1,
                                     "seconds": time.perf_counter() - t0,
                                     "bytes": os.path.getsize(ckpt)})
        return start

    def watched(resume):
        try:
            return train(resume)
        except RECOVERABLE as e:
            out["errors"].append({"type": type(e).__name__,
                                  "message": str(e)[:400],
                                  "t": time.time()})
            raise

    rm = RecoveryManager(em, restore=restore, max_restarts=1,
                         rendezvous_timeout=ELASTIC_LAUNCH_TIMEOUT)
    out["start"] = rm.run(watched)
    out["restarts"] = rm.restarts
    out["generation"] = current_generation()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    b, s, h, d = per, TRAIN_SEQ, cfg.num_heads, cfg.hidden_size \
        // cfg.num_heads
    dev = torch.device("cuda")
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    out["tiles"] = {fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
                    fa.DQ_KERNEL: bwd[2]}
    del model, dp, opt
    free_cuda(torch)
    if args.elastic_tools:
        elastic_tools(torch, rank, out)
    out["t_exit"] = time.time()
    with open(os.path.join(job, f"rank{rank}.inc{incarnation}.json"),
              "w") as f:
        json.dump(out, f)
    p2p.shutdown()
    dist.env.teardown()


def elastic_launch(seed, job, kill=-1, tools=False):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
    --max_restarts 1 --log_dir <job>/logs`` over this script's
    elastic_job_main, in a session of its own (so a timeout ends its
    ranks too)."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(job, exist_ok=True)
    # the abort's connect budget to a peer that died: 2 s, not 5
    env = {**os.environ, "PADDLE_TPU_ARTIFACTS_DIR":
           os.path.join(job, "artifacts"), "PADDLE_JOB_ID": "elastic",
           "PYTHONPATH": here, "PADDLE_TPU_P2P_CONNECT_TIMEOUT": "2"}
    env.pop("PADDLE_TPU_WIRE_SECRET", None)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(ELASTIC_WORLD), "--max_restarts", "1",
           "--log_dir", os.path.join(job, "logs"),
           os.path.abspath(__file__), "--seed", str(seed),
           "--elastic-job", job, "--elastic-kill", str(kill)]
    if tools:
        cmd.append("--elastic-tools")
    t_start = time.time()
    with open(os.path.join(job, "launcher.log"), "w") as log:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    with open(os.path.join(job, "t_start.json"), "w") as f:
        json.dump(t_start, f)
    return proc, time.perf_counter()


def elastic_join(started, job):
    """Wait for a launch; a failed one (the launcher ends the others when
    a rank fails past its budget) or one past the time limit fails with
    the tail of every workerlog. Returns the seconds it took."""
    import signal
    proc, t0 = started
    try:
        proc.wait(timeout=ELASTIC_LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tails = []
        for name in ["launcher.log"] + sorted(
                os.listdir(os.path.join(job, "logs"))
                if os.path.isdir(os.path.join(job, "logs")) else []):
            path = os.path.join(job, name) if name == "launcher.log" \
                else os.path.join(job, "logs", name)
            with open(path, errors="replace") as f:
                tails.append((name, f.read()[-4000:]))
        raise AssertionError(f"launch in {job} exited {proc.returncode} "
                             f"after {seconds:.1f} s: {tails}")
    return seconds


def elastic_rank(job, rank, incarnation):
    with open(os.path.join(job, f"rank{rank}.inc{incarnation}.json")) as f:
        return json.load(f)


def phase_elastic_lenet(torch, seed, root):
    """incubate.checkpoint.train_epoch_range with LeNet on the card: a run
    that crashes inside its second epoch, after the first epoch's
    snapshot, and its relaunch (fresh objects, resuming at the second
    epoch) against an uninterrupted run of 3 epochs, cuDNN deterministic:
    the resumed weights must equal the uninterrupted ones."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.incubate import checkpoint as acp
    from paddle_tpu_torch.vision.models import LeNet
    cfg = ELASTIC_LENET
    rng = np.random.RandomState(seed + 5)
    xs = torch.from_numpy(rng.randn(cfg["epochs"], cfg["batches"],
                                    cfg["batch"], 1, 28, 28)
                          .astype("float32")).cuda()
    ys = torch.from_numpy(rng.randint(0, 10, (cfg["epochs"], cfg["batches"],
                                              cfg["batch"]))).cuda()

    def make():
        net = LeNet(device="cuda", generator=pt.make_generator(seed))
        return net, pt.optimizer.Adam(learning_rate=1e-3,
                                      parameters=net.parameters())

    def epoch(net, opt, e):
        for i in range(cfg["batches"]):
            loss = pt.nn.functional.cross_entropy(net(xs[e, i]), ys[e, i])
            loss.backward()
            opt.step()
            opt.clear_grad()

    path = os.path.join(root, "lenet_ckpt")
    t0 = time.perf_counter()
    with cudnn_deterministic(torch):
        whole, whole_opt = make()
        for e in range(cfg["epochs"]):
            epoch(whole, whole_opt, e)
        net, opt = make()
        acp.register(net, opt)
        seen = []
        try:
            for e in acp.train_epoch_range(cfg["epochs"],
                                           checkpoint_path=path,
                                           name="lenet"):
                epoch(net, opt, e)
                seen.append(e)
                if e == cfg["crash_after"]:
                    raise RuntimeError("simulated crash")
        except RuntimeError as err:
            assert "simulated crash" in str(err), err
        net, opt = make()
        acp.register(net, opt)
        resumed = []
        for e in acp.train_epoch_range(cfg["epochs"], checkpoint_path=path,
                                       name="lenet"):
            epoch(net, opt, e)
            resumed.append(e)
        acp.register()
    torch.cuda.synchronize()
    gaps = {k: (v - whole.state_dict()[k]).abs().max().item()
            for k, v in net.state_dict().items()}
    row = {"phase": "elastic_lenet", "epochs": cfg["epochs"],
           "batches_per_epoch": cfg["batches"], "batch": cfg["batch"],
           "first_run_epochs": seen, "resumed_epochs": resumed,
           "max_abs_gap_to_uninterrupted": max(gaps.values()),
           "seconds": time.perf_counter() - t0}
    emit(row)
    assert seen == list(range(cfg["crash_after"] + 1)), seen
    assert resumed == list(range(cfg["crash_after"], cfg["epochs"])), resumed
    assert all(g == 0.0 for g in gaps.values()), gaps
    return row


def phase_elastic(torch, seed, beside=None):
    """The elastic group: the recovered launch (rank 1 killed at
    ELASTIC_KILL_STEP) and the uninterrupted one (with the tools after its
    steps) side by side, for the script's time (so each launch's step
    times carry the other's load), while this process runs elastic_lenet
    and then ``beside()`` (the vision group, whose captured replays share
    the card with the launches' steps). Checks the losses, the journal,
    the launches, the tools' results; records the times. Returns the
    B1-B3 launches a step, the seconds and what ``beside`` returned."""
    import shutil

    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.resilience.recovery import RecoveryJournal
    cache_dir = os.environ["PADDLE_TPU_AUTOTUNE_CACHE"]
    root = os.path.join(cache_dir, "elastic")
    seconds = {}
    free_cuda(torch)
    # the tiles of a rank's shape, searched once here: every rank of both
    # launches then reads the same ones from the cache
    b, s, h, d = ELASTIC_RANK_SHAPE
    dev = torch.device("cuda")
    fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, True, dev)
    whole_dir = os.path.join(root, "whole")
    rec_dir = os.path.join(root, "recover")
    launches = [elastic_launch(seed, rec_dir, kill=ELASTIC_KILL_RANK),
                elastic_launch(seed, whole_dir, tools=True)]
    besides = None
    try:
        lenet = phase_elastic_lenet(torch, seed, root)
        seconds["elastic_lenet"] = lenet["seconds"]
        if beside is not None:
            t0 = time.perf_counter()
            besides = beside()
            seconds["beside"] = time.perf_counter() - t0
        seconds["recovered_launch"] = elastic_join(launches[0], rec_dir)
        seconds["whole_launch"] = elastic_join(launches[1], whole_dir)
    finally:
        for proc, _ in launches:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()

    kernels = (fa.KERNEL_NAME, fa.DKV_KERNEL, fa.DQ_KERNEL)
    tc = fa.TC
    whole = [elastic_rank(whole_dir, r, 0) for r in range(ELASTIC_WORLD)]
    survivor = elastic_rank(rec_dir, 0, 0)
    replacement = elastic_rank(rec_dir, ELASTIC_KILL_RANK, 1)
    assert not os.path.exists(os.path.join(
        rec_dir, f"rank{ELASTIC_KILL_RANK}.inc0.json"))
    with open(os.path.join(rec_dir, "death.json")) as f:
        death = json.load(f)
    journal = RecoveryJournal(
        "elastic", dir=os.path.join(rec_dir, "artifacts")).entries()
    losses = [whole[0]["steps"][str(i)]["loss"]
              for i in range(ELASTIC_STEPS)]
    rec_losses = [survivor["steps"][str(i)]["loss"]
                  for i in range(ELASTIC_STEPS)]
    repl_losses = [replacement["steps"][str(i)]["loss"]
                   for i in range(replacement["start"], ELASTIC_STEPS)]
    restart = [e for e in journal if e["event"] == "restart"]
    worker = [e for e in journal if e["event"] == "worker_restart"]
    error = survivor["errors"][0] if survivor["errors"] else {}
    after = [survivor["steps"][str(i)] for i in
             range(replacement["start"], ELASTIC_STEPS)]
    before = [survivor["steps"][str(i)] for i in range(replacement["start"])]
    first_resumed = survivor["steps"][str(replacement["start"])]
    # each launch's own wall: from its start to its last rank's exit
    for name, job, res in (("recovered", rec_dir, [survivor, replacement]),
                           ("whole", whole_dir, whole)):
        with open(os.path.join(job, "t_start.json")) as f:
            seconds[f"{name}_launch_wall"] = max(
                r["t_exit"] for r in res) - json.load(f)
    saves = [sv for sv in whole[0]["saves"]]
    loads = survivor["loads"] + replacement["loads"]
    row = {"phase": "elastic", "world": ELASTIC_WORLD,
           "config": f"GPT-medium v32000 h1024 L{ELASTIC_LAYERS} a16 d64 "
                     f"bf16, "
                     f"AdamW mp, DataParallel over 2 ranks on one card "
                     f"(gloo), each under RecoveryManager with an "
                     f"ElasticManager on a FileStore, started by python -m "
                     f"paddle_tpu_torch.distributed.launch --nproc_per_node "
                     f"2 --max_restarts 1",
           "rank_batch": [TRAIN_BATCH // ELASTIC_WORLD, TRAIN_SEQ],
           "steps": ELASTIC_STEPS, "checkpoint_every": ELASTIC_CKPT_EVERY,
           "killed": {"rank": ELASTIC_KILL_RANK, "step": death["step"],
                      "exit_code": ELASTIC_KILLED},
           "losses_uninterrupted": losses, "losses_recovered": rec_losses,
           "losses_replacement": repl_losses,
           "generations": {"uninterrupted": whole[0]["generation"],
                           "survivor": survivor["generation"],
                           "replacement": replacement["generation"]},
           "journal": [{k: e.get(k) for k in ("event", "rank", "code",
                                              "generation", "cause", "np",
                                              "restart", "flight_tail")}
                       for e in journal],
           "survivor_error": error,
           "death_to_error_s": error.get("t", float("nan")) - death["t"],
           "death_to_first_resumed_step_s": first_resumed["t_end"]
           - death["t"],
           "replacement_ready_s": replacement["ready_s"],
           "checkpoint_bytes": saves[-1]["bytes"],
           "save_s": [sv["seconds"] for sv in saves],
           "load_s": [ld["seconds"] for ld in loads],
           "step_ms_before": [st["ms"] for st in before],
           "step_ms_after": [st["ms"] for st in after],
           "replacement_step_ms": [replacement["steps"][str(i)]["ms"]
                                   for i in range(replacement["start"],
                                                  ELASTIC_STEPS)],
           "uninterrupted_step_ms": [whole[0]["steps"][str(i)]["ms"]
                                     for i in range(ELASTIC_STEPS)],
           "collective_wait_ms_before": [st["collective_wait_ms"]
                                         for st in before],
           "collective_wait_ms_after": [st["collective_wait_ms"]
                                        for st in after],
           "peak_mem_bytes": [w["peak_mem_bytes"] for w in whole],
           "tiles": whole[0]["tiles"], "seconds": seconds}
    emit(row)
    tools = {"p2p": [w["p2p"] for w in whole],
             "metrics": [w["metrics"] for w in whole],
             "abort": [w["abort"] for w in whole]}
    # rank 1's fault fires as it enters the all_reduce
    tools["abort_to_peer_error_s"] = tools["abort"][0]["t_error"] \
        - tools["abort"][1]["t_enter"]
    emit({"phase": "elastic_tools", **tools})

    # the recovered run: the uninterrupted losses, to the bit
    assert rec_losses == losses, (rec_losses, losses)
    assert repl_losses == losses[replacement["start"]:], repl_losses
    assert whole[1]["steps"]["0"]["loss"] == losses[0]
    assert all(np.isfinite(losses)), losses
    assert replacement["start"] == ELASTIC_CKPT_EVERY * (
        ELASTIC_KILL_STEP // ELASTIC_CKPT_EVERY), replacement["start"]
    assert death["step"] == ELASTIC_KILL_STEP, death
    # the journal: the launcher's relaunch and the survivor's restart
    assert len(worker) == 1 and worker[0]["rank"] == ELASTIC_KILL_RANK and \
        worker[0]["code"] == ELASTIC_KILLED and worker[0]["generation"] == 1, \
        journal
    assert len(restart) == 1 and restart[0]["generation"] == 2 and \
        restart[0]["np"] == ELASTIC_WORLD and \
        restart[0]["cause"] in ("ConnectionError", "PeerAbort"), journal
    assert whole[0]["generation"] == 1 and survivor["generation"] == \
        replacement["generation"] == 2
    assert survivor["restarts"] == 1 and whole[0]["restarts"] == 0
    # B1-B3 once a layer a step on each rank, before and after the restart
    for res in whole + [survivor, replacement]:
        for st in res["steps"].values():
            for kernel in kernels:
                assert st["launches"].get(f"{kernel}.{tc}", 0) == \
                    ELASTIC_LAYERS, st["launches"]
    # the tools: p2p and the metrics against numpy, the abort in seconds
    xs = [np.arange(12, dtype="float32").reshape(3, 4) * (r + 1)
          for r in range(ELASTIC_WORLD)]
    for p in tools["p2p"]:
        assert p["all_reduce"] == (xs[0] + xs[1]).tolist(), p
        assert p["all_reduce_max"] == np.maximum(*xs).tolist(), p
        assert p["all_gather"] == np.stack(xs).tolist(), p
        assert p["broadcast"] == xs[1].tolist(), p
    st = [elastic_stats(r) for r in range(ELASTIC_WORLD)]
    tot = {k: sum(x[k] for x in st) for k in st[0]}
    tp = tn = area = 0.0
    for i in range(len(tot["pos"]) - 1, -1, -1):
        area += tot["neg"][i] * (2 * tp + tot["pos"][i]) / 2.0
        tp, tn = tp + tot["pos"][i], tn + tot["neg"][i]
    want = {"acc": tot["correct"].sum() / tot["n"].sum(),
            "auc": area / (tp * tn),
            "rmse": float(np.sqrt(tot["sqrerr"].sum() / tot["n"].sum())),
            "sum": tot["v"].tolist()}
    for m in tools["metrics"]:
        for k, v in want.items():
            np.testing.assert_allclose(m[k], v, rtol=1e-12, err_msg=k)
    assert tools["abort"][1]["raised"] == "FaultInjected", tools["abort"]
    a0 = tools["abort"][0]
    assert a0["raised"] == "PeerAbort" and a0["src"] == 1 and \
        a0["section"] == "collective.all_reduce", a0
    assert a0["seconds"] < ELASTIC_ABORT_S, a0
    shutil.rmtree(root, ignore_errors=True)
    last = str(ELASTIC_STEPS - 1)
    return {"whole_per_step_rank0": whole[0]["steps"][last]["launches"],
            "whole_per_step_rank1": whole[1]["steps"][last]["launches"],
            "survivor_per_step_before_restart":
                survivor["steps"]["0"]["launches"],
            "survivor_per_step_after_restart":
                survivor["steps"][last]["launches"],
            "replacement_per_step": replacement["steps"][last]["launches"],
            "elastic_tiles": whole[0]["tiles"], "seconds": seconds,
            "beside": besides}


# -- ps: the parameter server (ps tables, service, communicator,
# TheOnePSRuntime, DistributeTranspiler, fleet datasets, FleetExecutor) ----

# BERT-base (bert_flash's configuration) through two pservers: two trainer
# processes on the card, each reading 4 x 512 of cls_stream's 8 x 512
# batch through InMemoryDataset.batches(worker_id, 2); 1 init step
# (rank 0 seeds the dense tables) and PS_STEPS sync steps, then PS_ASYNC
# steps through the Communicator; server SGD at PS_LR (at 1e-2 SGD
# overshoots from BERT-base's random draw: the loss 0.77 -> 3.20 in one
# step, PERF.md section 6)
PS_SERVERS, PS_TRAINERS, PS_STEPS, PS_ASYNC, PS_LR = 2, 2, 3, 2, 1e-3
PS_RANK_SHAPE = (4, 512, 12, 64)
# FleetExecutor: a three-stage forward of BERT-base, 4 micro-batches of
# 2 x 512, buffer_size 2
FE_MICRO, FE_SHAPE, FE_BUFFER = 4, (2, 512, 12, 64), 2
# the sync gate on the dense tables: each table's update after the sync
# steps, (table - initial value), against the serial bf16 run's (which
# does the trainers' arithmetic: ps_serial) by relative L2, within the
# bf16 rule of the training checks: no further than twice the serial bf16
# run's own update from the serial f32 run's + BF16_GRAD_SLACK
# (bf16_bounds; PERF.md section 6)
# BERT-base's dense tables: its 201 parameters but the word embedding
PS_DENSE_TABLES = 200
PS_TIMEOUT = 300


def ps_job_env(job):
    with open(os.path.join(job, "endpoints.json")) as f:
        return json.load(f)


def ps_bert_cfg():
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    return cfg


def ps_wait_servers(job, deadline_s=PS_TIMEOUT):
    t0 = time.perf_counter()
    while not all(os.path.exists(os.path.join(job, f"server{i}.ready"))
                  for i in range(PS_SERVERS)):
        if time.perf_counter() - t0 > deadline_s:
            raise TimeoutError(f"pservers not ready in {deadline_s} s")
        time.sleep(0.1)


def ps_server_main(args):
    """One pserver (a host process; the card is hidden from it): the
    DistributeTranspiler's tables for its endpoint, from BERT-base's
    layout on the meta device, served until the parent's stop file."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.text.models import BertForSequenceClassification
    faulthandler.dump_traceback_later(RANK_STACK_DUMP_S, repeat=True)
    job, index = args.ps_job, args.ps_index
    eps = ps_job_env(job)
    model = BertForSequenceClassification(ps_bert_cfg(), num_classes=2,
                                          device="meta")
    model.bert.embeddings.word_embeddings._sparse = True
    t = dist.transpiler.DistributeTranspiler()
    t.transpile(trainer_id=0, pservers=",".join(eps), trainers=PS_TRAINERS,
                model=model)
    tables = t.get_pserver_program(eps[index], lr=PS_LR)
    host, port = eps[index].rsplit(":", 1)
    srv = dist.ps.PsServer(tables, host=host, port=int(port)).start()
    with open(os.path.join(job, f"server{index}.ready"), "w") as f:
        json.dump({"tables": [tb.table_id for tb in tables]}, f)
    parent, t0 = os.getppid(), time.perf_counter()
    try:
        while not os.path.exists(os.path.join(job, "stop")):
            if os.getppid() != parent or \
                    time.perf_counter() - t0 > 2 * PS_TIMEOUT:
                sys.exit("pserver: the parent is gone or the job outlived "
                         "its limit")
            time.sleep(0.1)
    finally:
        srv.stop()


def ps_feeds(seed, cfg):
    """cls_stream's 8 x 512 batches of the sync steps as a sample list."""
    (ids, labels), = cls_stream(seed + 21, 1, PS_STEPS, 2 * PS_RANK_SHAPE[0],
                                PS_RANK_SHAPE[1], cfg.vocab_size)
    return ids, labels, [(ids[t, i], labels[t, i])
                         for t in range(PS_STEPS) for i in range(ids.shape[1])]


def ps_trainer_main(torch, args):
    """One trainer of the ps group on the card: BERT-base f32 under amp O1
    bf16, its word embedding a sparse table, through the
    DistributeTranspiler's TheOnePSRuntime over both pservers: the init
    step, PS_STEPS sync steps (each step's time split into pull, compute,
    push and barriers, its bytes, B1-B3 launches, and the rows of its
    first pull); then PS_ASYNC steps through the Communicator, rank 0
    holding each table before them (saving the dense ones: the sync
    steps' result) and after."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faulthandler.dump_traceback_later(RANK_STACK_DUMP_S, repeat=True)
    job, rank = args.ps_job, int(os.environ["PADDLE_TRAINER_ID"])
    t_start = time.time()
    cfg = ps_bert_cfg()
    model = bert_model(torch, cfg, args.seed).train()
    assert next(model.parameters()).is_cuda, "a trainer runs on the card"
    word = model.bert.embeddings.word_embeddings
    word._sparse = True
    eps = ps_job_env(job)
    ps_wait_servers(job)
    t = dist.transpiler.DistributeTranspiler()
    t.transpile(trainer_id=rank, pservers=",".join(eps),
                trainers=PS_TRAINERS, model=model)
    rt = t.get_trainer_program(lr=PS_LR)
    ds = dist.InMemoryDataset()
    ds.set_batch_size(PS_RANK_SHAPE[0])
    ds.set_use_var(["ids", "labels"])
    ds.set_sample_list(ps_feeds(args.seed, cfg)[2])
    feeds = list(ds.batches(rank, PS_TRAINERS))
    assert len(feeds) == PS_STEPS, len(feeds)
    out = {"rank": rank, "ready_s": time.time() - t_start, "steps": []}
    t0 = time.perf_counter()
    rt.init_params()
    out["init_s"] = time.perf_counter() - t0
    rows = {}

    def step(rt, feed, record):
        ids = torch.from_numpy(feed["ids"]).cuda()
        labels = torch.from_numpy(feed["labels"]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.step_begin(sparse_ids={"word_embeddings": feed["ids"]})
        if record is not None:
            uniq = np.unique(feed["ids"])
            record[f"ids{len(record) // 2}"] = uniq
            record[f"rows{len(record) // 2}"] = word.weight.detach()[
                torch.from_numpy(uniq).cuda()].cpu().numpy()
        launch_counts.clear()
        t1 = time.perf_counter()
        with pt.amp.auto_cast(dtype="bfloat16"):
            loss = model(ids, labels=labels)
        loss.backward()
        value = loss.item()
        t2 = time.perf_counter()
        launches = {k: launch_counts[k] for k in launch_counts
                    if k.split(".")[0] in fa.KERNEL_NAMES}
        rt.step_end()
        for p in model.parameters():
            p.grad = None
        t3 = time.perf_counter()
        part = rt.last_step
        return {"loss": value, "ms": (t3 - t0) * 1e3,
                "pull_ms": part["pull_s"] * 1e3,
                "compute_ms": (t2 - t1) * 1e3,
                "push_ms": part["push_s"] * 1e3,
                "barrier_ms": (part["pull_barrier_s"]
                               + part["push_barrier_s"]) * 1e3,
                "pulled_bytes": part["pulled_bytes"],
                "pushed_bytes": part["pushed_bytes"], "launches": launches}

    for feed in feeds:
        out["steps"].append(step(rt, feed, rows))
    np.savez(os.path.join(job, f"rows{rank}.npz"), **rows)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    b, s, h, d = PS_RANK_SHAPE
    dev = torch.device("cuda")
    fwd = fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, False, dev)
    bwd = fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, False, dev)
    out["tiles"] = {fa.KERNEL_NAME: fwd[0], fa.DKV_KERNEL: bwd[1],
                    fa.DQ_KERNEL: bwd[2]}
    # async: the Communicator pushes in the background, each table to its
    # own pserver (C-ref-28)
    art = t.get_trainer_program(lr=PS_LR, mode="async")
    sparse_id = art._sparse[0][0]
    async_ids = np.unique(np.concatenate(
        [f["ids"].ravel() for f in feeds[:PS_ASYNC]]))

    def snapshot():
        snap = {tid: art.client.pull_dense(tid, server=art._server(tid))
                for tid, _ in art._dense}
        snap[sparse_id] = art.client.pull_sparse(
            sparse_id, async_ids, server=art._server(sparse_id))
        return snap
    # every trainer has pushed its last sync step (the step barrier)
    art.client.barrier("async_begin", PS_TRAINERS)
    before = None
    if rank == 0:
        before = snapshot()     # the tables after the sync steps
        names = [n for n, p in model.named_parameters()
                 if p is not word.weight]
        np.savez(os.path.join(job, "tables.npz"),
                 **{n: before[tid] for n, (tid, _) in zip(names, art._dense)})
    art.client.barrier("async_snapshot", PS_TRAINERS)
    t0 = time.perf_counter()
    out["async_steps"] = [step(art, feed, None) for feed in
                          feeds[:PS_ASYNC]]
    art.flush()
    out["async_s"] = time.perf_counter() - t0
    art.client.barrier("async_done", PS_TRAINERS)
    if rank == 0:
        after = snapshot()
        out["async_moved"] = {tid: not np.array_equal(after[tid], v)
                              for tid, v in before.items()}
        out["async_servers"] = sorted(set(art._assignment.values()))
        del before, after
    out["stat_after_async"] = [art.client.stat(server=i)
                               for i in range(PS_SERVERS)]
    art.stop()
    art.client.close()
    rt.client.close()
    with open(os.path.join(job, f"trainer{rank}.json"), "w") as f:
        json.dump(out, f)


def ps_start(seed, job):
    """The pserver processes (the card hidden from them) and the trainer
    processes of this script, each logging beside its result."""
    here = os.path.dirname(os.path.abspath(__file__))
    eps = [f"127.0.0.1:{free_port()}" for _ in range(PS_SERVERS)]
    with open(os.path.join(job, "endpoints.json"), "w") as f:
        json.dump(eps, f)
    procs = {}
    try:
        for i in range(PS_SERVERS):
            env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
            with open(os.path.join(job, f"server{i}.log"), "w") as log:
                procs[f"server{i}"] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--seed",
                     str(seed), "--ps-role", "server", "--ps-index", str(i),
                     "--ps-job", job], cwd=here, env=env, stdout=log,
                    stderr=subprocess.STDOUT)
        for r in range(PS_TRAINERS):
            env = {**os.environ, "PADDLE_TRAINER_ID": str(r),
                   "PADDLE_TRAINERS_NUM": str(PS_TRAINERS),
                   "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(eps)}
            with open(os.path.join(job, f"trainer{r}.log"), "w") as log:
                procs[f"trainer{r}"] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--seed",
                     str(seed), "--ps-role", "trainer", "--ps-job", job],
                    cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT)
    except BaseException:
        ps_stop(procs, job)
        raise
    return procs, time.perf_counter()


def ps_stop(procs, job):
    with open(os.path.join(job, "stop"), "w"):
        pass
    deadline = time.perf_counter() + 10
    for p in procs.values():
        try:
            p.wait(timeout=max(deadline - time.perf_counter(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def ps_join(started, job):
    """Wait for the trainers; a trainer or a pserver that dies (or the
    time limit) ends every process and fails with each log's tail. The
    pservers are then stopped. Returns the trainers' results and the
    seconds."""
    procs, t0 = started
    deadline = t0 + PS_TIMEOUT
    trainers = [procs[f"trainer{r}"] for r in range(PS_TRAINERS)]
    try:
        while any(p.poll() is None for p in trainers) and \
                not any(p.poll() for p in procs.values()) and \
                not any(procs[f"server{i}"].poll() is not None
                        for i in range(PS_SERVERS)) and \
                time.perf_counter() < deadline:
            time.sleep(0.2)
        seconds = time.perf_counter() - t0
        failed = [name for name, p in procs.items()
                  if (p.poll() is not None and p.returncode != 0)
                  or (name.startswith("server") and p.poll() is not None)
                  or (name.startswith("trainer") and p.poll() is None)]
    finally:
        ps_stop(procs, job)
    if failed:
        tails = []
        for name in sorted(procs):
            with open(os.path.join(job, f"{name}.log"), errors="replace") as f:
                tails.append((name, procs[name].returncode, f.read()[-4000:]))
        raise AssertionError(f"ps: {failed} failed or outlived "
                             f"{PS_TIMEOUT} s: {tails}")
    res = []
    for r in range(PS_TRAINERS):
        with open(os.path.join(job, f"trainer{r}.json")) as f:
            res.append(json.load(f))
    return res, seconds


def ps_fleet_executor(torch, seed):
    """BERT-base bf16 in eval as a three-stage FleetExecutor in one
    Carrier (the embeddings; layers 0-5; layers 6-11, the pooler and the
    classifier), FE_MICRO micro-batches of 2 x 512 as CUDA tensors,
    buffer_size FE_BUFFER: each micro-batch's logits equal the whole
    model's to the bit, B1 12 times a micro-batch."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed.fleet_executor import (FleetExecutor,
                                                             TaskNode)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    cfg = ps_bert_cfg()
    model = bert_model(torch, cfg, seed).to(dtype=torch.bfloat16).eval()
    layers = model.bert.encoder.layers
    half = len(layers) // 2
    b, s = FE_SHAPE[:2]
    (ids, _), = cls_stream(seed + 22, 1, 1, FE_MICRO * b, s, cfg.vocab_size)
    micro = list(torch.from_numpy(ids[0]).cuda().split(b))

    def embed(x):
        with torch.no_grad():
            return model.bert.embeddings(x)

    def encode(lo, hi):
        def run(h):
            with torch.no_grad():
                for layer in layers[lo:hi]:
                    h = layer(h, None)
                return h
        return run

    def head(h):
        with torch.no_grad():
            h = encode(half, len(layers))(h)
            pooled = F.tanh(model.bert.pooler(h[:, 0]))
            return model.classifier(model.dropout(pooled))
    with torch.no_grad():
        model(micro[0])     # the tile search, on this thread
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = [model(x) for x in micro]
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
    nodes = [TaskNode("embeddings", fn=embed, buffer_size=FE_BUFFER),
             TaskNode("layers0_5", fn=encode(0, half), buffer_size=FE_BUFFER),
             TaskNode("layers6_11_head", fn=head, buffer_size=FE_BUFFER)]
    for a, c in zip(nodes, nodes[1:]):
        a.add_downstream_task(c.task_id)
        c.add_upstream_task(a.task_id)
    fe = FleetExecutor(nodes)
    launch_counts.clear()
    t0 = time.perf_counter()
    got = fe.run(micro, timeout=120)
    torch.cuda.synchronize()
    fe_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: launch_counts[k] for k in launch_counts
                if k.split(".")[0] in fa.KERNEL_NAMES}
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, whole)]
    row = {"phase": "ps_fleet_executor",
           "config": f"BERT-base v30522 h768 L12 a12 d64 bf16 eval, 3 "
                     f"stages (embeddings; layers 0-{half - 1}; layers "
                     f"{half}-{len(layers) - 1} + pooler + classifier) in "
                     f"one Carrier, buffer_size {FE_BUFFER}",
           "micro_batches": FE_MICRO, "micro_batch": [b, s],
           "outputs": len(got), "equal_to_whole_model": equal,
           "max_abs_logit": max(w.float().abs().max().item() for w in whole),
           "launches": launches, "executor_ms": fe_ms,
           "whole_model_ms": whole_ms}
    emit(row)
    assert len(got) == FE_MICRO and all(equal), row
    assert launches.get(f"{fa.KERNEL_NAME}.{fa.TC}", 0) == \
        cfg.num_layers * FE_MICRO, launches
    del model, whole, got
    free_cuda(torch)
    return row


def ps_serial(torch, seed, cfg, rows, ids, labels):
    """Serial BERT-base doing the two sync trainers' arithmetic in plain
    PyTorch: at each step each trainer's 4 rows of the 8 x 512 batch (the
    batches InMemoryDataset deals them) through forward and backward at
    the same parameters, then each half's gradient applied in turn,
    ``p -= PS_LR * g``, as a pserver's SGD applies each push; the word
    embedding's gradient sparse, merged (coalesce) and applied to its rows
    likewise. Its word rows start from the tables' first pulls
    (C-ref-29). In f32 and under amp O1 bf16: each run's losses (the
    halves' mean) and final parameters, and for the bf16 run the part of
    each dense parameter's update that the second half's pushes made."""
    import paddle_tpu_torch as pt
    model = bert_model(torch, cfg, seed).train()
    word = model.bert.embeddings.word_embeddings
    word._sparse = True
    with torch.no_grad():
        word.weight[torch.from_numpy(rows[0]).cuda()] = torch.from_numpy(
            rows[1]).cuda()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    dense = [(n, p) for n, p in model.named_parameters()
             if p is not word.weight]
    xs, ys = torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda()
    half = PS_RANK_SHAPE[0]
    out = {"init": init}
    for dtype in ("float32", "bfloat16"):
        model.set_state_dict(init)
        second = {n: torch.zeros_like(p) for n, p in dense}
        losses = []
        t0 = time.perf_counter()
        for t in range(PS_STEPS):
            pushes, halves = [], []
            for r in range(PS_TRAINERS):
                rows_r = slice(r * half, (r + 1) * half)
                with pt.amp.auto_cast(enable=dtype == "bfloat16",
                                      dtype="bfloat16"):
                    loss = model(xs[t, rows_r], labels=ys[t, rows_r])
                loss.backward()
                halves.append(loss.item())
                g = word.weight.grad.coalesce()
                pushes.append(([p.grad for _, p in dense], g.indices()[0],
                               g.values()))
                for p in model.parameters():
                    p.grad = None
            with torch.no_grad():
                for r, (grads, wid, wgrad) in enumerate(pushes):
                    for (n, p), g in zip(dense, grads):
                        upd = PS_LR * g
                        p.sub_(upd)
                        if r == PS_TRAINERS - 1:
                            second[n].add_(upd)
                    word.weight.index_copy_(
                        0, wid, word.weight[wid] - PS_LR * wgrad)
            del pushes
            losses.append(float(np.mean(halves)))
        out[dtype] = {"losses": losses,
                      "seconds": time.perf_counter() - t0,
                      "params": {n: p.detach().float().cpu().numpy()
                                 for n, p in dense},
                      "second": {n: v.cpu().numpy()
                                 for n, v in second.items()}}
        del second
    del model
    free_cuda(torch)
    return out


def ps_first_rows(job):
    """Each id's row at its first pull (the earliest step it appears in,
    pulled by either trainer before any push of that step): (ids, rows)."""
    first = {}
    for step in range(PS_STEPS):
        for r in range(PS_TRAINERS):
            with np.load(os.path.join(job, f"rows{r}.npz")) as z:
                for i, row in zip(z[f"ids{step}"], z[f"rows{step}"]):
                    i = int(i)
                    if i not in first:
                        first[i] = (step, row)
                    elif first[i][0] == step:
                        assert np.array_equal(first[i][1], row), i
    ids = np.array(sorted(first), dtype=np.int64)
    return ids, np.stack([first[i][1] for i in ids])


def phase_ps(torch, seed):
    """The ps group: the pservers and the trainers started (the
    FleetExecutor forward on this process meanwhile), then the serial
    runs held against the trainers' sync steps, the async run's tables and
    the sparse rows. Returns B1-B3's launches a step (rank 0) and in the
    executor's run, and the seconds."""
    import shutil

    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    cache_dir = os.environ["PADDLE_TPU_AUTOTUNE_CACHE"]
    job = os.path.join(cache_dir, "ps")
    shutil.rmtree(job, ignore_errors=True)
    os.makedirs(job)
    seconds = {}
    free_cuda(torch)
    # the tiles of a trainer's shape, searched once here: both trainers
    # then read them from the cache
    b, s, h, d = PS_RANK_SHAPE
    dev = torch.device("cuda")
    fa._tuned_fwd_blocks(b * h, s, s, d, torch.bfloat16, False, dev)
    fa._tuned_bwd_blocks(b * h, s, s, d, torch.bfloat16, False, dev)
    cfg = ps_bert_cfg()
    ids, labels, _ = ps_feeds(seed, cfg)
    started = ps_start(seed, job)
    try:
        t0 = time.perf_counter()
        fe = ps_fleet_executor(torch, seed)
        seconds["fleet_executor"] = time.perf_counter() - t0
    except BaseException:
        ps_stop(started[0], job)
        raise
    ranks, seconds["servers_and_trainers"] = ps_join(started, job)
    # the serial run takes each trainer's rows as InMemoryDataset dealt them
    half = PS_RANK_SHAPE[0]
    for r in range(PS_TRAINERS):
        with np.load(os.path.join(job, f"rows{r}.npz")) as z:
            for t in range(PS_STEPS):
                assert np.array_equal(z[f"ids{t}"], np.unique(
                    ids[t, r * half:(r + 1) * half])), (r, t)
    t0 = time.perf_counter()
    first = ps_first_rows(job)
    serial = ps_serial(torch, seed, cfg, first, ids, labels)
    seconds["serial"] = time.perf_counter() - t0
    sb, sf = serial["bfloat16"], serial["float32"]
    mean = [float(np.mean([r["steps"][t]["loss"] for r in ranks]))
            for t in range(PS_STEPS)]
    gaps, bounds = bf16_bounds(mean, sb["losses"], sf["losses"])
    init = {n: v.float().cpu().numpy().astype(np.float64)
            for n, v in serial["init"].items()}
    # each table's update: (gap to the serial bf16 run's, the bf16 rule's
    # bound, what the gap would read had the second trainer's pushes been
    # dropped); a dropped push of every trainer reads 1
    updates = {}
    with np.load(os.path.join(job, "tables.npz")) as z:
        for n in z.files:
            got, want, truth = (v.astype(np.float64) - init[n] for v in (
                z[n], sb["params"][n], sf["params"][n]))
            updates[n] = (rel_l2_np(got, want),
                          BF16_GRAD_FACTOR * rel_l2_np(want, truth)
                          + BF16_GRAD_SLACK,
                          rel_l2_np(want - sb["second"][n], want))
    worst = sorted(updates.items(), key=lambda kv: -kv[1][0] / kv[1][1])
    sent = np.unique(ids)
    stat = ranks[0]["stat_after_async"]
    sparse_rows = sum(v for st in stat for v in st.values() if v is not None)
    kernels = (fa.KERNEL_NAME, fa.DKV_KERNEL, fa.DQ_KERNEL)
    tc = fa.TC
    steps = [r["steps"] for r in ranks]
    row = {"phase": "ps", "servers": PS_SERVERS, "trainers": PS_TRAINERS,
           "config": f"BERT-base v30522 h768 L12 a12 d64 f32 under amp O1 "
                     f"bf16, the word embedding a sparse table, "
                     f"DistributeTranspiler over {PS_SERVERS} pservers "
                     f"(host processes), sync, server SGD lr {PS_LR}",
           "rank_batch": list(PS_RANK_SHAPE[:2]), "steps": PS_STEPS,
           "losses": [[st["loss"] for st in r] for r in steps],
           "mean_losses": mean, "serial_bf16_losses": sb["losses"],
           "serial_f32_losses": sf["losses"], "loss_rel_gaps": gaps,
           "loss_bounds": bounds,
           "update_rel_l2_worst": worst[:3],
           "update_rel_l2_median": float(np.median(
               [g for g, _, _ in updates.values()])),
           "update_bound_median": float(np.median(
               [b for _, b, _ in updates.values()])),
           "tables_catching_dropped_pushes": sum(
               b < 1.0 for _, b, _ in updates.values()),
           "tables_catching_dropped_second_trainer": sum(
               b < d for _, b, d in updates.values()),
           "dropped_second_trainer_min_reading": min(
               d for _, _, d in updates.values()),
           "tables_bound_at_least_1": sorted(
               n for n, (_, b, _) in updates.items() if b >= 1.0),
           "step_ms": [[st["ms"] for st in r] for r in steps],
           "pull_ms": [[st["pull_ms"] for st in r] for r in steps],
           "compute_ms": [[st["compute_ms"] for st in r] for r in steps],
           "push_ms": [[st["push_ms"] for st in r] for r in steps],
           "barrier_ms": [[st["barrier_ms"] for st in r] for r in steps],
           "pulled_bytes_per_step": [r[-1]["pulled_bytes"] for r in steps],
           "pushed_bytes_per_step": [r[-1]["pushed_bytes"] for r in steps],
           "init_s": [r["init_s"] for r in ranks],
           "ready_s": [r["ready_s"] for r in ranks],
           "sparse_rows": sparse_rows, "distinct_ids_sent": int(sent.size),
           "async_steps": PS_ASYNC, "async_s": [r["async_s"] for r in ranks],
           "async_losses": [[st["loss"] for st in r["async_steps"]]
                            for r in ranks],
           "async_moved": sum(ranks[0]["async_moved"].values()),
           "async_tables": len(ranks[0]["async_moved"]),
           "async_servers": ranks[0]["async_servers"],
           "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
           "tiles": ranks[0]["tiles"], "serial_s": [sf["seconds"],
                                                    sb["seconds"]],
           "seconds": seconds}
    emit(row)
    # the sync gate: the trainers' arithmetic done serially
    assert all(np.isfinite(mean)), mean
    assert all(g <= bd for g, bd in zip(gaps, bounds)), (gaps, bounds)
    assert len(updates) == PS_DENSE_TABLES and \
        worst[0][1][0] <= worst[0][1][1], worst[:3]
    # the async run moved every table, on both pservers (C-ref-28)
    assert all(ranks[0]["async_moved"].values()), ranks[0]["async_moved"]
    assert ranks[0]["async_servers"] == list(range(PS_SERVERS))
    # the sparse rows: no more than the distinct ids sent
    assert sparse_rows <= sent.size, (sparse_rows, sent.size)
    # B1-B3 once a layer a step on each trainer, sync and async
    for r in ranks:
        for st in r["steps"] + r["async_steps"]:
            for kernel in kernels:
                assert st["launches"].get(f"{kernel}.{tc}", 0) == \
                    cfg.num_layers, st["launches"]
    shutil.rmtree(job, ignore_errors=True)
    return {"per_step_rank0": ranks[0]["steps"][-1]["launches"],
            "per_step_rank1": ranks[1]["steps"][-1]["launches"],
            "fleet_executor": fe["launches"], "tiles": ranks[0]["tiles"],
            "seconds": seconds}


def ps_entries(fa, entry, rows, bwd_rows, ps, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 on the ps group's
    path: a trainer's (4, 512, 12, 64), non-causal, with the launches a
    step on trainer 0 (each forward writes O in f32 too: its time and
    bound are those); and B1 at the FleetExecutor's micro-batch (2, 512,
    12, 64), with its launches over the executor's run."""
    tc = fa.TC

    def at(found, shape):
        return next(r for r in found if r["shape"] == list(shape)
                    and r["dtype"] == "bfloat16" and not r["causal"])
    counts = ps["per_step_rank0"]
    main = ("BERT-base f32 under amp bf16 through 2 pservers, a sync "
            "trainer's (4, 512, 12, 64), non-causal (ps)")
    fwd = at(rows, PS_RANK_SHAPE)
    out = [entry(f"{fa.KERNEL_NAME}.{tc}.ps", "flash_attn_fwd_tc.cu", 114,
                 fwd, counts.get(f"{fa.KERNEL_NAME}.{tc}", 0),
                 fwd["max_abs_err_o"], rel_l2=fwd["rel_l2_o"],
                 main_path=main, ms=fwd["ms_with_f32_out"],
                 bound_ms=fwd["bound_us_with_f32_out"] / 1e3,
                 bound_by=fwd["bound_by_with_f32_out"],
                 share_of_bound=fwd["bound_us_with_f32_out"] / 1e3
                 / fwd["ms_with_f32_out"],
                 factor_vs_library=fwd["ms_with_f32_out"]
                 / fwd["library_ms"], ms_without_f32_out=fwd["ms"])]
    for kernel, source, line, key in (
            (fa.DKV_KERNEL, "flash_attn_dkv_tc.cu", 200, "dkv"),
            (fa.DQ_KERNEL, "flash_attn_dq_tc.cu", 247, "dq")):
        row = at(bwd_rows[key], PS_RANK_SHAPE)
        out.append(entry(f"{kernel}.{tc}.ps", source, line, row,
                         counts.get(f"{kernel}.{tc}", 0), row["max_abs_err"],
                         rel_l2={o: g["rel_l2"] for o, g in
                                 row["rel_l2_by_output"].items()},
                         main_path=main, **scope))
    fe = at(rows, FE_SHAPE)
    out.append(entry(f"{fa.KERNEL_NAME}.{tc}.fleet_executor",
                     "flash_attn_fwd_tc.cu", 114, fe,
                     ps["fleet_executor"].get(f"{fa.KERNEL_NAME}.{tc}", 0),
                     fe["max_abs_err_o"], rel_l2=fe["rel_l2_o"],
                     main_path="BERT-base bf16 eval as a three-stage "
                               "FleetExecutor, 4 micro-batches of 2 x 512, "
                               "non-causal (ps)"))
    return out


def phase_optim(torch, seed):
    """The optim group: optim_bert, then optim_sparse, tensor_api and
    recompute_dropout, each with the launch counts reset just before it;
    returns each lane's B1-B3 launches."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    t_group = time.perf_counter()
    lanes = {}
    launch_counts.clear()
    lanes["optim_bert"] = phase_optim_bert(torch, seed)
    for lane, fn in (("optim_sparse", phase_optim_sparse),
                     ("tensor_api", lambda t, _: phase_tensor_api(t)),
                     ("recompute_dropout", phase_recompute_dropout)):
        launch_counts.clear()
        fn(torch, seed)
        lanes[lane] = {k: launch_counts[k] for k in launch_counts
                       if k.split(".")[0] in KERNEL_NAMES}
        assert not any(lanes[lane].values()), (lane, lanes[lane])
    emit({"phase": "optim", "seconds": time.perf_counter() - t_group})
    return lanes


def phase_surface(torch, seed):
    """The surface group: nn_cases, mobilenet_train, mobile_nets_small,
    mobilenet_eval and state_guard, each with the launch counts reset
    just before it; returns each lane's B1-B3 launches (none)."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    t_group = time.perf_counter()
    lanes, seconds, trained = {}, {}, []

    def train(t, sd):
        row, model = phase_mobilenet_train(t, sd)
        trained.append(model)
        return row

    def evaluate(t, sd):
        rows = phase_mobilenet_eval(t, sd, trained.pop())
        gc.collect()
        t.cuda.empty_cache()
        return rows
    for lane, fn in (("nn_cases", lambda t, _: phase_nn_cases(t)),
                     ("mobilenet_train", train),
                     ("mobile_nets_small", phase_mobile_nets_small),
                     ("mobilenet_eval", evaluate),
                     ("state_guard", phase_state_guard)):
        launch_counts.clear()
        t_lane = time.perf_counter()
        fn(torch, seed)
        seconds[lane] = time.perf_counter() - t_lane
        lanes[lane] = {k: launch_counts[k] for k in launch_counts
                       if k.split(".")[0] in KERNEL_NAMES}
        assert not any(lanes[lane].values()), (lane, lanes[lane])
    emit({"phase": "surface", "seconds": time.perf_counter() - t_group,
          "lane_seconds": seconds})
    return lanes


def run_beside(beside, *starts):
    """``beside()`` on this process while the started rank sets run (they
    are ended if it fails); returns its result and seconds."""
    if beside is None:
        return None, 0.0
    t0 = time.perf_counter()
    try:
        return beside(), time.perf_counter() - t0
    except BaseException:
        end_ranks(*starts)
        raise


def phase_bert(torch, seed):
    """The bert group: bert_train, ernie_train and bert_flash; returns
    bert_flash's B1-B3 launches."""
    phase_cls_train(torch, seed, "bert")
    phase_cls_train(torch, seed, "ernie")
    return phase_bert_flash(torch, seed)


def phase_nn_rest(torch, seed):
    """The nn_rest group: nn_rest_cases, rnn_small, translate and lstm_lm;
    returns each lane's B1-B3 launches (translate's over its encode and
    beam search, the others' over the lane, none)."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    t_group = time.perf_counter()
    lanes, seconds = {}, {}
    for lane, fn in (
            ("nn_rest_cases", lambda t, _: phase_nn_rest_cases(t)),
            ("rnn_small", phase_rnn_small),
            ("translate", phase_translate),
            ("lstm_lm", phase_lstm_lm)):
        launch_counts.clear()
        t_lane = time.perf_counter()
        row = fn(torch, seed)
        seconds[lane] = time.perf_counter() - t_lane
        if lane == "translate":
            # the path's own window: the counts reset just before its
            # encode and beam search and read just after
            lanes[lane] = row["flash_launch_counts"]
        else:
            lanes[lane] = {k: launch_counts[k] for k in launch_counts
                           if k.split(".")[0] in KERNEL_NAMES}
            assert not any(lanes[lane].values()), (lane, lanes[lane])
    emit({"phase": "nn_rest", "seconds": time.perf_counter() - t_group,
          "lane_seconds": seconds})
    return lanes


def phase_hapi(torch, seed):
    """The hapi group: hapi_lenet (under cudnn_deterministic),
    hapi_resnet50 and hapi_bert; returns their B1-B3 launches."""
    with cudnn_deterministic(torch):
        lenet_row = phase_hapi_lenet(torch, seed)
    resnet_row = phase_hapi_resnet50(torch, seed)
    bert_row = phase_hapi_bert(torch, seed)
    emit({"phase": "hapi", "seconds": {
        r["phase"]: r["seconds"] for r in (lenet_row, resnet_row, bert_row)}})
    return {"hapi_lenet": lenet_row["flash_launches"],
            "hapi_resnet50": resnet_row["flash_launches"],
            "hapi_bert": bert_row["launches_per_step"]}


def phase_vision(torch, seed):
    """The vision group: vision_reference, resnet_train, resnet_fused,
    resnet_eval and lenet_train; returns their B1-B3 launches (none)."""
    phase_vision_reference(torch, seed)
    resnet, trained = phase_resnet_train(torch, seed)
    phase_resnet_fused(torch, seed)
    _, eval_flash = phase_resnet_eval(torch, seed, trained)
    del trained
    lenet = phase_lenet_train(torch, seed)
    return {"resnet50_train": resnet["flash_launches"],
            "resnet50_eval": eval_flash,
            "lenet_train": lenet["flash_launches"]}


def elastic_entries(fa, entry, rows, bwd_rows, elastic, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 on the elastic
    group's path: a rank's (2, 1024, 16, 64), causal, with the launches a
    step on the recovered launch's survivor after its restart. Each
    forward writes O in f32 too: its time and bound are those."""
    tc = fa.TC

    def at(found):
        return next(r for r in found if r["shape"] == list(ELASTIC_RANK_SHAPE)
                    and r["dtype"] == "bfloat16" and r["causal"])
    counts = elastic["survivor_per_step_after_restart"]
    main = ("GPT-medium bf16 under DataParallel at 2 ranks, launched and "
            "recovered after a rank was killed, a rank's (2, 1024, 16, 64), "
            "causal (elastic)")
    fwd = at(rows)
    out = [entry(f"{fa.KERNEL_NAME}.{tc}.elastic", "flash_attn_fwd_tc.cu",
                 114, fwd, counts.get(f"{fa.KERNEL_NAME}.{tc}", 0),
                 fwd["max_abs_err_o"], rel_l2=fwd["rel_l2_o"],
                 main_path=main, ms=fwd["ms_with_f32_out"],
                 bound_ms=fwd["bound_us_with_f32_out"] / 1e3,
                 bound_by=fwd["bound_by_with_f32_out"],
                 share_of_bound=fwd["bound_us_with_f32_out"] / 1e3
                 / fwd["ms_with_f32_out"],
                 factor_vs_library=fwd["ms_with_f32_out"]
                 / fwd["library_ms"], ms_without_f32_out=fwd["ms"])]
    for kernel, source, line, key in (
            (fa.DKV_KERNEL, "flash_attn_dkv_tc.cu", 200, "dkv"),
            (fa.DQ_KERNEL, "flash_attn_dq_tc.cu", 247, "dq")):
        row = at(bwd_rows[key])
        out.append(entry(f"{kernel}.{tc}.elastic", source, line, row,
                         counts.get(f"{kernel}.{tc}", 0), row["max_abs_err"],
                         rel_l2={o: g["rel_l2"] for o, g in
                                 row["rel_l2_by_output"].items()},
                         main_path=main, **scope))
    return out


# a group (key) whose parent waits on its rank processes hosts a guest
# group on this process meanwhile: the guest's captured replays share the
# card with the ranks' steps, and the host is little used by either
GUESTS = {"auto_moe": (("hapi", phase_hapi),),
          "elastic": (("vision", phase_vision),),
          "hybrid": (("surface", phase_surface),
                     ("to_static_grad", phase_to_static_grad)),
          "pipeline": (("bert", phase_bert),),
          "layouts": (("optim", phase_optim), ("nn_rest", phase_nn_rest))}

PHASE_GROUPS = ("build", "kernels", "auto_moe", "elastic", "ps",
                "reference",
                "serve", "train", "to_static_grad", "bert", "vision",
                "serving",
                "hapi", "optim", "surface", "nn_rest", "zoo", "dist_tune",
                "hybrid", "pipeline", "layouts")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASE_GROUPS),
                    help="comma-separated phase groups to run (default: "
                         "all); the kernels line needs all of them")
    # one rank of the dist_tune group's data-parallel lanes, started by
    # phase_dist (with PADDLE_TRAINER_ID and the coordinator's address)
    ap.add_argument("--dist-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dist-out", default=None, help=argparse.SUPPRESS)
    # one rank of the hybrid group's lanes, started by phase_hybrid
    ap.add_argument("--hybrid-lane", default=None, help=argparse.SUPPRESS)
    # one rank of the elastic group's launches, started by the launcher
    ap.add_argument("--elastic-job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--elastic-kill", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--elastic-tools", action="store_true",
                    help=argparse.SUPPRESS)
    # a pserver or a trainer of the ps group, started by phase_ps
    ap.add_argument("--ps-role", choices=("server", "trainer"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ps-index", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ps-job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    run = set(args.phases.split(","))
    unknown = run - set(PHASE_GROUPS)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from "
                 f"{PHASE_GROUPS}")

    import torch
    if args.ps_role == "server":
        # a host process: the card is hidden from it
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        ps_server_main(args)
        return
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible; this script runs the "
                 "port on the card and has no host fallback")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        sys.exit("chip_smoke: paddle_tpu_torch/ not found beside this "
                 "script; run it from a checkout of the repository")
    sys.path.insert(0, here)
    if args.dist_rank is not None:
        dist_rank_main(torch, args)
        return
    if args.hybrid_lane is not None:
        hybrid_rank_main(torch, args)
        return
    if args.elastic_job is not None:
        elastic_job_main(torch, args)
        return
    if args.ps_role == "trainer":
        ps_trainer_main(torch, args)
        return
    # a run still going near the time limit shows where it is
    faulthandler.dump_traceback_later(STACK_DUMP_S)
    # the tuner's answers stay inside the checkout (the build directory)
    os.environ["PADDLE_TPU_AUTOTUNE_CACHE"] = autotune_cache_dir()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN picks its algorithms by heuristics: no autotuning runs, inside
    # a capture or out of it
    torch.backends.cudnn.benchmark = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "phases": sorted(run)})

    t0 = time.perf_counter()
    out = {}
    group_seconds, last = {}, [t0]

    def hosting(host, run_host):
        """Group ``host`` through ``run_host(beside)``, with its guest
        groups (GUESTS) that run, in turn, on this process beside its rank
        processes; each guest's seconds are its own, the host's exclude
        them (clock)."""
        guests = [(g, fn) for g, fn in GUESTS[host] if g in run]
        t_group = time.perf_counter()

        def beside():
            done = {}
            for g, fn in guests:
                t0 = time.perf_counter()
                done[g] = (fn(torch, args.seed), time.perf_counter() - t0)
            return done
        res = run_host(beside if guests else None)
        lanes = res.pop("seconds")
        hosted = res.pop("beside")
        for g, _ in guests:
            out[g], group_seconds[g] = hosted[g]
        host_guests[host] = [g for g, _ in guests]
        emit({"phase": host, "seconds": time.perf_counter() - t_group,
              "lane_seconds": lanes})
        return res
    host_guests = {}

    def clock(group):
        """The seconds since the previous group ended, for ``group``, less
        those of the guest groups it hosted (one that ran beside another
        is counted already)."""
        now = time.perf_counter()
        if group in run and group not in group_seconds:
            group_seconds[group] = now - last[0] - sum(
                group_seconds[g] for g in host_guests.get(group, ()))
        last[0] = now
    if "build" in run:
        phase_build()
    clock("build")
    if "kernels" in run:
        out["rows"] = phase_kernels(torch, args.seed)
        out["bwd_rows"] = phase_kernels_bwd(torch, args.seed)
    clock("kernels")
    # auto_parallel and incubate run early, in a process that has driven
    # little else yet; the hapi group follows them beside the ranks
    if "auto_moe" in run:
        out["auto_moe"] = hosting("auto_moe", lambda b: phase_auto_moe(
            torch, args.seed, b))

    clock("auto_moe")
    if "elastic" in run:
        out["elastic"] = hosting("elastic", lambda b: phase_elastic(
            torch, args.seed, b))
    clock("elastic")
    if "ps" in run:
        t_group = time.perf_counter()
        out["ps"] = phase_ps(torch, args.seed)
        emit({"phase": "ps", "seconds": time.perf_counter() - t_group,
              "lane_seconds": out["ps"].pop("seconds")})
    clock("ps")
    # every phase runs under the defaults: FLAGS_fusion_policy auto (the
    # measured table) and the tile search on
    if "reference" in run:
        phase_reference(torch, args.seed)
        phase_reference_train(torch, args.seed)
    clock("reference")
    if "serve" in run:
        out["serve"] = phase_serve(torch, args.seed)
    clock("serve")
    if "train" in run:
        out["train"] = phase_train(torch, args.seed)
        out["compiled"] = phase_compiled_train(torch, args.seed,
                                               out["train"])
        out["amp"] = phase_amp_train(torch, args.seed)
    clock("train")
    if "to_static_grad" in run and "hybrid" not in run:
        phase_to_static_grad(torch, args.seed)
    clock("to_static_grad")
    if "bert" in run and "pipeline" not in run:
        out["bert"] = phase_bert(torch, args.seed)
    clock("bert")
    if "vision" in run and "vision" not in out:
        out["vision"] = phase_vision(torch, args.seed)
    clock("vision")
    if "serving" in run:
        bert_row, srv = phase_serving_bert(torch, args.seed)
        decode_row = phase_serving_decode(torch, srv)
        del srv
        resnet_row = phase_serving_resnet(torch, args.seed)
        out["serving"] = {
            "bert_server_per_batch": bert_row["bucket8_replay"][
                "flash_variant_launches"],
            "bert_server_warmup_and_capture": bert_row[
                "flash_variant_launches_warmup_and_capture"],
            "resnet_server": resnet_row["flash_launches"],
            "decode": decode_row["flash_launches"]}
    clock("serving")
    if "hapi" in run and "auto_moe" not in run:
        out["hapi"] = phase_hapi(torch, args.seed)
    clock("hapi")
    if "optim" in run and "layouts" not in run:
        out["optim"] = phase_optim(torch, args.seed)

    clock("optim")
    if "surface" in run and "hybrid" not in run:
        out["surface"] = phase_surface(torch, args.seed)

    clock("surface")
    if "nn_rest" in run and "layouts" not in run:
        out["nn_rest"] = phase_nn_rest(torch, args.seed)

    clock("nn_rest")
    if "zoo" in run:
        from paddle_tpu_torch.ops.cuda import launch_counts
        from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
        t_group = time.perf_counter()
        lanes, seconds = {}, {}
        for lane, fn in (("vision_zoo_small", phase_vision_zoo_small),
                         ("densenet_train", phase_densenet_train),
                         ("zoo_eval", phase_zoo_eval),
                         ("vision_ops", phase_vision_ops),
                         ("tokenize_bert", phase_tokenize_bert)):
            launch_counts.clear()
            t_lane = time.perf_counter()
            row = fn(torch, args.seed)
            seconds[lane] = time.perf_counter() - t_lane
            if lane == "tokenize_bert":
                # a batch is one graph replay: its launches by kernel name
                lanes[lane] = row["replay"]["flash_variant_launches"]
                lanes["tokenize_bert_masked"] = row["masked"]["replay"][
                    "flash_variant_launches"]
            else:
                lanes[lane] = {k: launch_counts[k] for k in launch_counts
                               if k.split(".")[0] in KERNEL_NAMES}
                assert not any(lanes[lane].values()), (lane, lanes[lane])
        out["zoo"] = lanes
        emit({"phase": "zoo", "seconds": time.perf_counter() - t_group,
              "lane_seconds": seconds})

    clock("zoo")
    if "dist_tune" in run:
        from paddle_tpu_torch.ops.cuda import launch_counts
        from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
        t_group = time.perf_counter()
        seconds = {}
        cache_dir = autotune_cache_dir()
        t_lane = time.perf_counter()
        tune = phase_autotune(torch, args.seed, cache_dir)
        seconds["autotune"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()
        phase_fusion_policy(torch, args.seed, cache_dir)
        seconds["fusion_policy"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()
        phase_policy_steps(torch, args.seed)
        seconds["policy_steps"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()
        dp, fit = check_dist(*phase_dist(torch, args.seed, cache_dir))
        seconds["dp_gpt_dp_fit_collectives"] = time.perf_counter() - t_lane
        t_lane = time.perf_counter()
        launch_counts.clear()
        phase_nccl_single(torch)
        seconds["collectives_nccl"] = time.perf_counter() - t_lane
        nccl = {k: launch_counts[k] for k in launch_counts
                if k.split(".")[0] in KERNEL_NAMES}
        assert not any(nccl.values()), nccl
        # each path's own window: a rank's counts reset before each step
        # and read after it (the last timed step)
        out["dist_tune"] = {
            "dp_gpt_per_step_rank0": dp[0]["launches_per_step"][-1],
            "dp_gpt_per_step_rank1": dp[1]["launches_per_step"][-1],
            "dp_gpt_tiles": dp[0]["tiles"],
            "dp_fit": fit[0]["launches"], "collectives_nccl": nccl,
            "winners": tune["winners"]}
        emit({"phase": "dist_tune", "seconds": time.perf_counter() - t_group,
              "lane_seconds": seconds})

    serial = None
    clock("dist_tune")
    if "hybrid" in run:
        out["hybrid"] = hosting("hybrid", lambda b: phase_hybrid(
            torch, args.seed, b))
        serial = out["hybrid"].pop("serial")

    clock("hybrid")
    if "pipeline" in run:
        # pp_gpt and pp_compiled are held to the hybrid group's serial runs
        out["pipeline"] = hosting("pipeline", lambda b: phase_pipeline(
            torch, args.seed, serial, b))
    clock("pipeline")
    if "layouts" in run:
        out["layouts"] = hosting("layouts", lambda b: phase_layouts(
            torch, args.seed, b))

    clock("layouts")
    if run == set(PHASE_GROUPS):
        from paddle_tpu_torch.ops.cuda import flash_attention as fa
        emit({"kernels": kernel_entries(
            fa, out["rows"], out["bwd_rows"], out["serve"], out["train"],
            out["compiled"], out["amp"], out["bert"], out["vision"],
            out["serving"], out["hapi"], out["optim"], out["surface"],
            out["nn_rest"], out["zoo"], out["dist_tune"], out["hybrid"],
            out["pipeline"], out["layouts"], out["auto_moe"],
            out["elastic"], out["ps"])})
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "group_seconds": group_seconds, "timing": TIMING})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
