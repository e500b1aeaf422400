#!/usr/bin/env python3
"""Prove the PyTorch port builds, is right, serves and trains on one card.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, started together), print ``tools/torch_ptxas_report.py
   fused_conv_tc conv_bwd_tc flash_fwd_tc flash_bwd_tc flash_bwd_f32
   flash_fwd_f32 conv_bwd_f32`` (registers, spills, and the HGMMA and
   UTMALDG instructions in the SASS of the bf16 tensor-core K1/K2/K3 and
   K4/K5/K6: both must be there; the fp32 K5/K6 of ``flash_bwd_f32``, K4
   of ``flash_fwd_f32`` and K2 of ``conv_bwd_f32`` run on the FP32 pipes
   and load by TMA: UTMALDG and no HGMMA; no kernel spills), and compile
   the rtc kernels of ``csrc/rtc/`` with NVRTC;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the shapes the serving and training paths give it, in fp32 and bf16
   (TF32 off), with its device time (CUDA-graph replay, inputs warm in L2),
   its time as an eager call (host work included), the plain version's and
   one PyTorch library call's device time (timed here only, never used by
   the port) and the least time the card could take for the same work.
   The forward kernel (K4) first, on its own cases, one on the GPT's own
   operands (views of one fused QKV projection) and ``BWD_CASES``; each
   row names its route (``flash_attention.flash_fwd_route``): a decode
   step (Tq = 1) must take the split kernels
   (``csrc/flash_fwd_split.cu``), the other bf16 rows the tensor-core
   kernel (``csrc/flash_fwd_tc.cu``), the other fp32 rows from
   ``FWD_F32_MIN_TQ`` query rows the register micro-tile kernel
   (``csrc/flash_fwd_f32.cu``, its output and lse bit-equal to a second
   launch's), the rest the SIMT kernel (``csrc/flash_fwd.cu``); a row not
   on the SIMT route also runs the SIMT kernel on the same inputs, holds
   it against the plain version as well and times it (``simt_ms``, and a
   SIMT row of its own), and causal square rows time SDPA with
   ``is_causal`` beside its boolean mask. Then the two
   backward kernels (K5 dq, K6 dk/dv) on ``BWD_CASES``; each backward row
   names its route (``flash_attention.flash_bwd_route``): every bf16 row
   must take the tensor-core kernels (``csrc/flash_bwd_tc.cu``), every
   fp32 row the register micro-tile kernels (``csrc/flash_bwd_f32.cu``,
   each output bit-equal to a second launch's); each row also runs the
   SIMT kernels (``csrc/flash_bwd.cu``) on the same inputs, holds them to
   the same tolerance and times them (``simt_ms``);
4. serving phase: greedy KV-cache decode of ``gpt_decoder_117m`` (12
   layers, 768 units, 12 heads, vocab 50257; weights drawn from ``--seed``)
   through ``serving.DecodeSession`` with 8 slots and a 512-token cache, 12
   prompts of 5 to 250 tokens, 32 new tokens each. Three streams are held
   token for token against the full-forward greedy oracle (``net(tokens)``
   re-run per token), and K4's launch count shows the path went through it:
   every decode step on the split route, every prefill on the route of its
   bucket's length (``decode_routes``: f32 from ``FWD_F32_MIN_TQ`` rows,
   SIMT below). The decode step is one captured CUDA graph (its capture
   records 12 split-route launches, which each replay counts);
   ``decode_step_times`` then holds the graph's next tokens against the
   same step run eagerly, times both (host ms and device time a step),
   and checks the split kernels' launches a step as the graph steps
   counted them and as the profiler saw them. Prefill is one CUDA graph a
   prompt bucket (the session's ``BucketedExecutorCache``, the true
   length a static device scalar; its capture records 12 K4 on the
   bucket's route, which each replay counts): ``prefill_times`` holds each
   bucket's graph against the eager prefill bit for bit (the first token
   and the K/V planes) at two true lengths of the bucket, and times both
   (host ms a prefill and device time); TTFT p50/p90 is printed beside
   the eager prefill's that ``PERF.md`` holds;
5. training phase: ``gpt_decoder_117m`` with ``max_length`` 256 and
   dropout 0 at B=8, T=256: the fp32 gradient of every parameter through
   the kernels against the same model with its attention swapped for the
   autograd of the plain versions (the swap is made here, for this oracle
   only); a learning check (fp32 ``SPMDTrainer``, the loss on one repeated
   batch falls over 10 steps); train -> decode (the trained weights served
   through ``DecodeSession`` and held against the full-forward oracle); two
   eager ``gluon.Trainer`` steps; the bf16 gradient gate (the net cast to
   bf16: one step's gradients through the tensor-core K5/K6 against the
   same step with ``flash_attention_bwd`` swapped for its plain version,
   ``gpt_bf16_gate``); the bench row (``SPMDTrainer`` SGD lr 1e-4
   momentum 0.9), timed; and a ``torch.profiler`` breakdown of one bf16
   step. K4, K5 and K6 each launch exactly 12 times per training pass
   (counted over the training steps alone; train -> decode and the bf16
   gate are counted on their own), K4, K5 and K6 of every fp32 pass on
   the f32 route, of every bf16 pass on the tensor-core route;
6. BERT phase: ``bert_12_768_12`` (12 layers, 768 units, 12 heads of 64,
   vocab 30522, ``max_length`` 512, dropout 0, ``attention_impl="pallas"``:
   K4-K6 with no causal mask and per-sample key lengths) at B=8, T=128,
   segments mixed, ``valid_length`` drawn from the seed (1 and 128 among
   them): the fp32 gradient of all 207 parameter tensors of the
   pretraining loss (MLM plus NSP cross entropy) against the attention
   swapped for the autograd of the plain versions; eval against the plain
   versions, a float32 ``valid_length`` bit-equal to the int32 one, and
   padding independence (every token at or beyond a sample's length
   changed: ``seq_out`` at the valid positions bit for bit); a learning
   check (fp32 ``SPMDTrainer``); two eager ``gluon.Trainer`` steps;
   ``mx.nd.invoke_op("flash_attention", q, k, v, lengths)`` bit-equal to
   the direct call; the bf16 gradient gate; then bench.py's bert row
   (bf16, B=24, T=128, ``SPMDTrainer`` SGD lr 1e-4 momentum 0.9) with
   ``attention_impl="pallas"``, with ``"xla"`` (the dense chain) and with
   pallas on seeded mixed lengths, each timed and profiled (the share of
   cuBLAS's unaligned GEMMs, the MLM head's). K4, K5 and K6 launch 12 times a pass,
   fp32 passes on f32, bf16 on tc, the xla row none. Then the mx.nd 1.x
   phase on the same net, in fp32 and drawn again from the seed
   (``nd1x_phase``), on the phase's batch (B=8, T=128, mixed segments and
   lengths): ``nd_bert_step``, the forward written the
   GluonNLP 1.x way in ``mx.nd`` ops alone (time-major layers, the query,
   key and value weights interleaved per head into one
   ``FullyConnected``, ``interleaved_matmul_selfatt_qk``, a key mask from
   ``arange_like``/``broadcast_like`` under ``masked_softmax``,
   ``interleaved_matmul_selfatt_valatt``), its loss and 207 gradients
   against the gluon pass through K4-K6 (relative L2 <= GRAD_RTOL; K4, K5
   and K6 12 times on f32 in the gluon pass, none in the 1.x steps) and
   against the same pass in fp64 (the 1.x step within GRAD_RTOL); the
   1.x update (``multi_sum_sq`` global norm, ``adamw_update(out=w)``)
   seen by the gluon forward; 10 steps lowering the loss by 5%; the 1.x
   step's host ms beside the gluon step's with "pallas" and "xla" and the
   device times; then every op of ``MORE_CASES`` and ``UPDATE_CASES`` (the
   JAX package's ``ops/more.py``, ``ops/random_ops.py`` and
   ``ops/optimizer_ops.py``) on the card against the CPU, the update
   wrappers' in-place rule, every sampler by its statistics at 2^20 draws,
   and ``mx.random.set_state`` replaying on the card. Then the sparse
   phase on the same net, drawn again from the seed (``sparse_phase``):
   (a) ``word_embed`` replaced by ``Embedding(30522, 768,
   sparse_grad=True)`` holding the same weight, beside a copy of the net
   with its dense embedding, 3 ``gluon.Trainer`` steps of each (sgd,
   momentum 0.9, wd 1e-4, ``lazy_update``) on fresh batches (B=8, T=128,
   mixed lengths): the row-sparse gradient on the card with the batch's
   sorted distinct tokens as int32 indices, its rows and every other
   gradient against the dense run's (GRAD_RTOL), the table and momentum
   after each step against the lazy rule written out in plain PyTorch
   (1e-6), untouched rows bit-equal, the FusedStep's "row-sparse
   gradient" fallback, the loss falling, K4-K6 12 a pass on f32, and the
   lazy update's device ms beside dense SGD over the table; (b) a csr
   linear classifier at 1,000,000 features (8192 rows, 15 nonzeros a
   row, MXNet's LibSVM linear classification): ``sparse.dot`` forward,
   ``SigmoidBinaryCrossEntropyLoss``, ``sparse.dot(transpose_a=True)``
   gradient, 5 SGD steps, both products against ``scipy.sparse`` in
   float64 (1e-5), a row slice and a ``cast_storage`` round trip, device
   ms beside ``torch.sparse.mm``; (c) ``SPARSE_CASES``, ``LAYER_CASES``,
   ``LOSS_CASES`` and ``REPAIR_CASES`` on the card against the CPU, and
   the data-sized sparse ops refused inside a CUDA graph capture;
7. conv kernel phase: the fused conv + BatchNorm kernels (K1 forward, K2
   input gradient, K3 weight gradient) against their plain versions in
   fp32 and bf16 at ResNet-50's shapes at B=32 and one shape off the
   model's path, with the same timings; the library call is cuDNN
   (``F.conv2d`` on channels-last tensors, and
   ``aten.convolution_backward`` for the input and the weight gradient),
   then K1 alone at the serving shapes (``SERVING_CONV_CASES``: the head
   case and the last stage at B=1, the ModelServer's smallest bucket).
   Each row names its route (``fused_conv.conv_route``): every bf16 row
   must take the tensor-core kernels (``csrc/fused_conv_tc.cu``,
   ``csrc/conv_bwd_tc.cu``), every fp32 row (widths multiples of 4) the
   register micro-tile kernels (``csrc/fused_conv_f32.cu``,
   ``csrc/conv_bwd_f32.cu``, their outputs bit-equal to a second
   launch's, and K1's to the SIMT K1's); a row not on the SIMT route also
   times the SIMT kernel
   (``csrc/fused_conv.cu``, ``csrc/conv_bwd.cu``) on the same inputs
   (``simt_ms``; in fp32 also held to the plain version, a SIMT row of its
   own). At the head case the
   tensor-core K1's per-channel sums and sums of squares lie within
   ``K1_SUMS_RTOL`` (relative L2) of an fp64 evaluation on the same bf16
   inputs (``k1_sums_fp64``);
8. ResNet phase: ``fused_resnet50_v1`` (1000 classes, 224x224 inputs,
   weights drawn from ``--seed``): the fp32 oracle of one training step at
   B=8 (loss and the 106 running statistics against the model with
   ``fused_conv_bn`` swapped for the autograd of its plain versions; the
   gradients of all 161 trainable tensors against the plain backward run
   on K1's forward values, see ``resnet_oracle``); the bf16 forward gate
   at the net as drawn (cast to bf16 for it and restored after: one
   training-mode forward at B=8 through the tensor-core K1 and through the
   SIMT K1, each against an fp32 forward (the f32 K1) on the same
   bf16-rounded weights and input, the tensor-core one no farther,
   ``resnet_bf16_forward_gate``); a learning check (fp32
   ``SPMDTrainer``, SGD, one repeated batch); two eager ``gluon.Trainer``
   steps; eval logits at B=32, with the running statistics set to that
   batch's, against the plain swap and the training-mode forward; then,
   the net cast to bf16, the bf16 gradient gate (one step at B=8, the 161
   gradients through the tensor-core K2/K3 against their plain versions
   on K1's forward, ``resnet_bf16_gate``), a bf16 learning check, and the
   bench row
   (B=128, ``SPMDTrainer`` SGD lr 0.1 momentum 0.9), timed, with a
   ``torch.profiler`` breakdown of one step. K1 launches exactly 52 times
   per forward, K2 and K3 52 times per backward: in every fp32 pass (the
   oracle, the forward gate's fp32 forward, the learning check, the eager
   steps, eval) on the f32 route, every bf16 one on the tensor-core
   route;
9. ModelServer phase: ``fused_resnet50_v1`` (weights drawn from
   ``--seed``, the running statistics set from one batch as the ResNet
   phase sets them for eval) behind ``serving.ModelServer(net,
   buckets=(1, 2, 4, 8, 16, 32), max_wait_ms=2)``, one CUDA graph a
   bucket, captured by ``warmup((3, 224, 224), "float32")`` (the graphs'
   memory printed, in one shared pool and with a pool each). fp32: each
   bucket's replay bit-equal to the eager eval forward of the same padded
   batch; 64 single-image requests from 8 client threads, each row within
   ``SERVER_ROW_RTOL`` (relative L2) of its image's own B=1 eager forward
   and all within 1e-4 of the forward with ``fused_conv_bn`` swapped for
   its plain versions; K1 exactly 52 times an executed batch on the f32
   route (each capture recorded 52); six signatures after warm-up and no
   capture from traffic; a 32-request burst into ``max_queue=4`` meets
   ``QueueFullError``; ``healthz`` flips at ``drain``. bf16 (the net
   cast; warm-up on a fresh thread): K1 52 times a batch on the
   tensor-core route; the served logits no farther from an fp32 forward on
   the same bf16-rounded weights and inputs than the eager forward through
   the SIMT K1 (``FWD_GATE_SLACK``, as ``resnet_bf16_forward_gate``).
   Then, in each type, every bucket's batch through its graph beside the
   eager forward (host ms, device time), and open-loop Poisson traffic at
   ``SERVER_RATES`` (the JAX package's ``serving_bench.open_loop``,
   copied): requests/s, latency p50/p99, mean batch occupancy, refusals,
   beside the same traffic unbatched (``Unbatched``: one eager B=1
   forward a request);
10. registry phase (``serving.ModelRegistry``): three models at full width,
   weights drawn from ``--seed``: ``fused_resnet50_v1`` fp32 behind a
   ``ModelServer`` (buckets 1-32), a second instance cast to bf16, and
   ``gpt_decoder_117m`` behind a ``DecodeSession`` (8 slots, 512-token
   cache); each builder makes its block, so an eviction frees it. A
   first registry learns each model's ``resident_bytes`` (parameters, KV
   cache and graph memory) and its first rows; the budget then fits any
   two and not three. Admitting the third evicts the least recently used
   idle model, whose eviction gives back the ``memory_allocated`` its
   admission took within ``EVICT_SLACK``; with the GPT in flight and the
   least recently used, admitting the fp32 server evicts the bf16 one;
   the fp32 re-admission takes its kernel libraries from the artifact
   store (no build) and serves rows bit-equal to its first residency.
   K1 52 a batch on f32 and tc, K4 12 a decode step on split (prefills
   by bucket). Hot-swap under load: open-loop traffic at
   ``REGISTRY_RATE`` while weight version 1 (``--seed + 1``) is
   published: no request fails, every executed batch bit-equal to the
   eager forward of exactly one version, every request submitted after
   ``publish_weights`` returned on version 1, each bucket's replay after
   the swap bit-equal to the eager forward on the new weights (what a
   rebound parameter would break); the publish seconds, the ms the commit
   held the replay lock, p99 in the swap window beside p99 without a
   swap. Decode swap: a stream before the flip equals version 0's oracle,
   one after it version 1's, one in flight across it finishes. A publish
   to the evicted bf16 model lands at its next admission. Artifact warm
   start: the fp32 server started in new processes (``--warm-start-child``)
   with an empty kernel build directory, cold (empty store: ``nvcc``
   runs, the store fills) and warm (no ``nvcc``), each bit-equal to this
   process's rows, beside a recapture-only start here;
11. unfused ResNet phase: ``get_model("resnet50_v1", classes=1000)``, the
   gluon layer set (NCHW, cuDNN and cuBLAS; no hand-written kernel:
   the JAX package leaves these convs to XLA), ``initialize("xavier")``
   and one forward that fills its deferred shapes; its inventory
   (25,610,152 values with the running statistics: 161 trainable tensors,
   106 running statistics, 53 convs); one fp32 training step at B=8
   against ``fused_resnet50_v1`` with the same weights (OIHW -> HWIO,
   ``zoo_to_fused``): the loss and the 106 running statistics within
   ``UNFUSED_TOL``, the 161 gradients within ``UNFUSED_GRAD_RTOL``
   relative L2, then the eval logits; an fp32 learning check through
   ``gluon.Trainer(..., kvstore="device")``; then bench.py's resnet50 row
   (bf16, B=128, ``SPMDTrainer`` SGD lr 0.1 momentum 0.9, 5 steps after
   2 warmup, a ``torch.profiler`` breakdown and the idle share), in NCHW
   and with the activations and conv weights in ``torch.channels_last``
   memory format. K1, K2 and K3 launch 0 times over every unfused pass;
12. vision phase (``vision_main``): eight models of the zoo at ImageNet
   width, classes=1000 (``VISION_MODELS``: ``alexnet``, ``vgg16_bn``,
   ``squeezenet1.1``, ``densenet121``, ``inceptionv3`` at 299x299,
   ``mobilenet1.0``, ``mobilenetv2_1.0``, ``mobilenetv3_large``; NCHW,
   cuDNN, cuBLAS and ATen, no hand-written kernel), xavier on the card,
   the deferred shapes filled by one forward: each one's inventory
   against the JAX package's (pinned); the eval logits and a training
   pass at B=2 against a copy on the port's CPU path with the same values
   (every Dropout rate at 0 for the pass; past ``GRAD_RTOL``, each side
   within it of the exact backward of its own forward,
   ``hold_gradients``); the learning check (fp32 ``gluon.Trainer`` sgd,
   momentum 0.9, ``kvstore="device"``, B=32, the batch loaded by
   ``gluon.utils.split_and_load`` and the gradients clipped by
   ``gluon.utils.clip_global_norm(grads, 10)`` before each step; the loss
   falls 5% in 6 steps, rates ``VISION_LR``); the step's host ms, images/s,
   device ms, idle share, peak memory and top kernels. Then
   ``gpt_decoder_117m`` (fp32, B=8, T=256, dropout 0) takes 3 adam steps
   with ``split_and_load`` and ``clip_global_norm(max_norm=1)`` before
   each, beside a copy stepped on the plain version's clipping: the norm,
   the scaling and the parameters after each step within 1e-6, one
   synchronizing read a call, NaN and inf as the reference, K4-K6 12 a
   pass on f32; the call's device ms beside the reference's loop of one
   host float an array. Then ``VISION_CASES`` (all 36 names at
   classes=10), ``UTILS_CASES`` and ``CONTRIB_CASES`` on the card against
   the CPU;
13. MLP phase: bench.py's mlp row (``Dense(512, activation="relu")``
   twice and ``Dense(10)``, no ``in_units``; xavier, bf16, B=8192,
   ``SPMDTrainer`` SGD lr 0.1 momentum 0.9): the loss falls by 5% over
   20 steps on one batch, then the step is timed;
14. graph phase (``parallel/superstep.py``): the MLP row (K=20), the GPT
   bf16 row (``gpt_decoder_117m``, B=8, T=256, dropout 0.1 as built,
   K=10), the BERT bf16 row (``bert_12_768_12``, B=24, T=128, dropout 0.1,
   K=5, each batch's mixed segments and ``valid_length`` in the window),
   the fused and the unfused (channels-last) ResNet-50 bf16 rows
   (B=128, K=5), each through ``SPMDTrainer.run_superstep`` over windows
   of K distinct batches drawn from ``--seed``: one window's [K] losses
   and every parameter and running statistic bit-equal to K eager
   ``step()`` calls from the same state and seed; the launch counters of
   the eager steps (GPT and BERT: 12 K4, K5 and K6 a step on the tensor
   cores; fused ResNet: 52 K1, K2 and K3 a pass; the others none), of the
   capture's recording (K steps) and of every graph call, measured around
   it (K steps a window, K + 1 for the first: its warm-up step ran), and
   the profiler's own count of each kernel's CUDA function in K eager
   steps and in a graph window (K a step: the kernels ran on the card);
   then host ms a step of the eager step beside the graph path (the
   median of alternating turns), device time and idle share
   (``torch.profiler``), peak memory, and the SM clock and power draw of
   each kind of turn (``nvidia-smi`` sampling, ``ClockSampler``)
   (``graph_row``); the gluon ``SuperStep`` on the MLP (sgd, momentum)
   against its eager path bit for bit; K3 and K1 captured on a thread
   that never ran an encode, bit-equal to the eager calls
   (``fresh_thread_capture``);
15. imperative phase (``mx.nd``, ``mx.operator``, ``mx.rtc``): the rtc
   kernels (K7, ``csrc/rtc/*.cu``, compiled by NVRTC in the build step)
   run an ``mx.rtc`` program (``scale`` and ``saxpy`` over 163,037,184
   floats, ``first_row`` of a (50257, 768) embedding) held bit for bit
   against their plain versions; then ``gpt_decoder_117m`` at
   ``max_length`` 256, B=8, fp32 trains imperatively: ``autograd.record``
   -> ``net(mx.nd.array(tokens))`` -> ``mx.nd.Custom(logits, labels,
   op_type="softmax_ce_rtc")`` (softmax forward and cross-entropy
   gradient backward, two runtime-compiled kernels) -> ``backward`` ->
   ``gluon.Trainer.step``: its 149 gradients against the plain loss's
   (``SoftmaxCrossEntropyLoss``, summed; relative L2 <= 1e-4), a learning
   check, the step's time and peak memory. softmax_ce_fwd/bwd launch once
   per step and K4-K6 12 times per pass, all three on the f32 route
   (counted over this main path alone). Then each rtc kernel
   against its plain version at the path's shapes (softmax_ce_fwd within
   1e-5 of each probability, relative; the
   rest bit for bit), timed (CUDA-graph replay) beside its plain version,
   a library call and its byte bound, ``first_row`` beside the graph
   replay of an empty kernel (the launch floor); K7's cases beside the
   path
   (``rtc_cases``: softmax_ce_fwd over rows longer than the resident limit,
   (256, 100003), and over (5, 7) and (3, 4099), each with its plan,
   resident or streamed, printed, and with req="add" at the path's shape;
   scale over 163,037,181 floats on views at offsets of 1 and 3 floats,
   into a new array and into a view at x's offset; saxpy over the same
   views, a at the offset with b and out aligned, and all three at the
   offset), held and timed the same way; and ``mx.nd.flash_attention`` and
   ``invoke_op("fused_conv_bn")`` with gradients, equal to the direct
   calls bit for bit. ``first_row`` is also timed in ``FIRST_ROW_TURNS``
   turns interleaved with ``torch.clone`` of row 0 and the empty kernel;
16. mx.nd phase: ``gpt_decoder_117m`` at ``max_length`` 256, B=8, fp32,
   trained through ``nd_gpt_step``, its forward written only in ``mx.nd``
   ops (token and position ``Embedding``, ``LayerNorm``,
   ``FullyConnected``, ``split`` of the fused QKV, ``reshape``/
   ``transpose`` to (B, H, T, D), ``flash_attention(causal=True)``,
   ``gelu``, ``Dropout``, the residual adds, the head) and its loss
   ``SoftmaxOutput(normalization="valid")`` on the net's own parameters:
   the loss and its 149 gradients against the gluon forward with
   ``SoftmaxCrossEntropyLoss`` (mean; relative L2 <= 1e-4), a learning
   check with dropout 0.1 (5 ``gluon.Trainer`` adam steps, the loss falls
   5%), K4-K6 12 times a pass on the f32 route over those 7 passes; the
   step's host ms beside the gluon step's (median of alternating turns)
   and a profile; then every case of ``ND_CASES`` (the ops of the JAX
   package's ``ops/tensor.py``, ``ops/nn.py``, ``ops/misc.py`` and the
   alias block, at the CPU tests' shapes) on the card against the same
   call on the CPU, forward and gradients (``ND_TOL``, or the case's own;
   indices, ties and the index and sequence ops bit for bit), one line an
   op family, and ``mx.nd.Dropout``'s statistics on the card. Then the
   mx.np phase on the same net: ``np_gpt_step``, the forward in ``mx.np``/
   ``mx.npx`` names (``np.einsum`` for every dense layer and the head,
   ``npx.layer_norm``, ``npx.gelu``, ``npx.embedding``, ``np.split``/
   ``reshape``/``transpose``) with ``mx.nd.flash_attention(causal=True)``,
   the loss ``-np.mean(np.take_along_axis(npx.log_softmax(logits), ...))``:
   the loss and its 149 gradients against the gluon pass (``GRAD_RTOL``),
   ``mx.nd.clip_by_global_norm`` over the gradients, a learning check (5
   adam steps, the loss falls 5%), K4-K6 12 times a pass on the f32 route
   over those 6 passes, the step's host ms and device ms beside the gluon
   step's; then every case of ``NP_CASES`` (``ops/numpy_ops.py``,
   ``ops/fft_ops.py``, ``ops/linalg.py`` and the ``mx.np`` shims, at the
   CPU tests' shapes) on the card against the CPU (``ND_TOL``, or the
   case's own: ``LINALG_TOL`` through a factorization, ``fft_tol(n)``;
   vectors unique up to sign by their invariants), and the dynamic-shape
   ops' results on the card, each refused inside a CUDA graph capture;
17. hybrid phase (``hybrid_main``): ``gpt_decoder_117m`` (``max_length``
   256, dropout 0, B=8, T=256) hybridized, in fp32 then bf16: the
   inference forward one CUDA graph (one capture, replayed) against the
   eager forward of the same net (``HYBRID_RTOL``), K4's launches of a
   replay equal to an eager call's route by route; the recorded step
   (forward and backward captured as one pair of graphs, K4-K6 12 each)
   with every gradient against the eager step's; in fp32 a
   ``gluon.Trainer(net.collect_params(), "adam")`` step over the
   ParameterDict, after which the forward graph captured before it
   replays the updated weights; eager and hybridized forward times. The
   zoo ``resnet50_v1`` (1000 classes, 224x224, B=8, fp32; 3 SGD steps move
   its 106 running statistics) exported and imported by
   ``SymbolBlock.imports`` (``EXPORT_RTOL``, the statistics as auxiliary
   states), then ``export_for_serving(buckets=(1, 2, 4, 8))`` and
   ``ModelServer.from_exported``: 32 requests from 8 threads, each row
   against ``net(x)`` (``SERVE_RTOL``), one graph a bucket. An attention
   block at GPT-117M width (a QKV ``Dense(2304)`` and ``flash_attention``
   over (8, 12, 256, 64)) exported and imported: the SymbolBlock launches
   K4 and equals the block. ``foreach`` (256 steps of a ``Dense(768)``
   +tanh cell at B=8), ``while_loop`` (``max_iterations`` 16) and ``cond``
   (with ``inputs``) against their unrolled forms, values and gradients
   (``CONTROL_RTOL``);
18. AMP, optimizers and SSD phase (``ssd_amp_main``): the fp16 K4, K5 and
   K6 (``fp16_flash_checks``: the tensor-core route at GPT's shape and at
   BERT's with key lengths, the split route at a decode step) against
   their plain versions (``TOLS[fp16]``), timed beside SDPA in fp16;
   ``gpt_decoder_117m`` from fp32 weights under ``amp.init("bfloat16")``
   (``gpt_amp_part``): one step's loss and 149 gradients against the same
   AMP step on the CPU (B=1, ``BF16_GRAD_RTOL``), 3 Adam steps through
   ``gluon.Trainer`` with ``init_trainer``/``scale_loss`` (the bf16
   tensor-core K4-K6 12 a step each, counted under
   ``launches_by_path["amp"]``; the loss falls), an fp16 AMP step (the
   fp16 K4-K6, the kernels line's ``*_tc_fp16`` entries) and an injected
   overflow (the update skipped, the scale halved); the same net in bf16
   with ``multi_precision`` Adam and LAMB (every fp32 master against an
   fp32 update of the same gradients, ``MASTER_RTOL``); the nine
   optimizers against the CPU (``OPT_RTOL``) and SGLD's noise moments;
   ``SPMDTrainer`` lamb/rmsprop/adagrad, ``run_superstep`` bit-equal to
   eager steps; SSD-300 VOC as bench.py's row (``ssd_part``: B=16, bf16,
   SGD, ``MultiBoxTarget`` inside the loss): K eager steps, the graph path
   bit-equal to them, one step under ``torch.cuda.set_sync_debug_mode(
   "error")``, host and device ms and images/s eager and on graphs, the
   AMP route from fp32 weights with a falling loss, ``multibox_detection``
   on the trained net (timed; two images against the CPU),
   ``multibox_target`` at the step's shapes and the 14 detection ops
   against the CPU (``detection_checks``, ``DET_TOLS``).

The third line from the end (``rows: {...}``) gives the bench rows: the
fused and unfused ResNet-50, the MLP and BERT (pallas, xla and mixed
lengths), bf16, step ms and images/s or sequences/s, and
the graph phase's rows and the decode step, eager beside graph, the
prefill buckets, graph beside eager, and TTFT, the ModelServer's
graph memory, warm-up, bucket times and open-loop rows, and the
registry's sizes, budget, evictions, hot-swap and warm-start numbers, and
the mx.nd GPT step's ms beside the gluon step's, its device ms and the
mx.nd phase's seconds, the mx.np GPT step's (``np_gpt_fp32``) likewise,
and the mx.nd 1.x BERT step's beside the gluon
BERT step's (pallas and xla), and the vision phase's models
(``vision_fp32``) and clipped GPT step (``gpt_clip_fp32``), and the
hybrid phase's rows (``hybrid_gpt``, ``hybrid_export``), and the
AMP GPT step, the masters, the optimizers and the SSD-300 rows
(``amp_gpt_bf16``, ``multi_precision``, ``optimizers``,
``ssd300_bf16``). The
line before the last is the kernels' JSON record (K1 to K7; K1 to K6
once per route, ``flash_fwd``/``fused_conv``/``conv_bwd_dx``/
``conv_bwd_dw``/``flash_bwd_dq``/``flash_bwd_dkv`` the SIMT kernels at the
fp32 head case, ``flash_fwd_f32``/``fused_conv_f32``/``conv_bwd_dx_f32``/
``conv_bwd_dw_f32``/``flash_bwd_dq_f32``/``flash_bwd_dkv_f32`` the fp32
micro-tile kernels there (a conv record also names its CUDA function,
``kernel``), ``flash_fwd_tc``/``fused_conv_tc``/
``conv_bwd_dx_tc``/``conv_bwd_dw_tc``/``flash_bwd_dq_tc``/
``flash_bwd_dkv_tc`` the tensor-core kernels at the bf16 head case,
``flash_fwd_split`` the split kernels at the fp32 decode case;
``flash_fwd_tc_fp16``/``flash_bwd_dq_tc_fp16``/``flash_bwd_dkv_tc_fp16``
the tensor-core kernels in fp16 at the GPT training case); the last
line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or run alone without
the repository beside it (the port does not import), the script exits 2
before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import functools
import gc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the
# FLOP/s of the type the kernel's inputs come in.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
# fp16 keeps 3 more mantissa bits than bf16: half its tolerance
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
# fp32 training gradients, kernels vs plain versions: relative L2 error per
# parameter tensor (both fp32, TF32 off; only the order of sums differs)
GRAD_RTOL = 1e-3
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16",
               torch.float16: "fp16"}
# the routes of each conv kernel K1-K3: "tc" the bf16 tensor-core
# kernels, "f32" the fp32 register micro-tiles, "simt" the others (K4 has
# four, ``FWD_ROUTES``; K5/K6 three, ``BWD_ROUTES``)
CONV_ROUTES = {"fused_conv": ("tc", "f32", "simt"),
               "conv_bwd_dx": ("tc", "f32", "simt"),
               "conv_bwd_dw": ("tc", "f32", "simt")}


def _param_tensors(net):
    """``net``'s parameter tensors by structural name (the port's
    ``parallel.collect_params``)."""
    from incubator_mxnet_tpu_torch import parallel

    return parallel.collect_params(net)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters=50, warmup=5) -> float:
    """Mean time per call of ``fn`` called back to back, host overhead
    included (CUDA events on the current stream)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_side_stream = None


def device_ms(fn, per_graph=20, replays=10) -> float:
    """Mean device time per call of ``fn``: ``per_graph`` calls captured
    in one CUDA graph and replayed, so no host work sits between them.
    Inputs stay the same across calls, so they are warm in L2. One side
    stream serves every capture: PyTorch keeps a cuBLAS workspace per
    stream for the life of the process."""
    global _side_stream
    if _side_stream is None:
        _side_stream = torch.cuda.Stream()
    side = _side_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------
def _valid_mask(b, tq, tk, lengths, causal, cache_offset, device):
    """(B, 1, Tq, Tk) bool: which (query, key) pairs the call attends."""
    rows = torch.arange(tq, device=device).view(1, 1, tq, 1)
    cols = torch.arange(tk, device=device).view(1, 1, 1, tk)
    lens = torch.full((b,), tk, device=device) if lengths is None \
        else lengths.to(device).long()
    lens = lens.view(b, 1, 1, 1)
    valid = cols < lens
    if causal:
        off = (lens - tq) if cache_offset else (tk - tq)
        valid = valid & (cols <= rows + off)
    return valid


def attention_bound(b, h, tq, tk, d, dtype, valid, return_lse):
    """Least time (ms) for the call and what bounds it: each input byte
    read once and each output written once, with K/V counted only for the
    keys this data reaches; 4*D FLOPs per attended (query, key) pair."""
    esize = torch.tensor([], dtype=dtype).element_size()
    keys = valid.any(dim=2).sum().item()               # per batch, per key
    nbytes = (b * h * tq * d * 2 + keys * h * d * 2) * esize
    if return_lse:
        nbytes += b * h * tq * 4
    flops = 4.0 * d * h * valid.sum().item()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bwd_bound(kernel, b, h, tq, tk, d, dtype, valid):
    """Least time (ms) of one backward kernel and what bounds it. Inputs
    are read once where the data reaches them (query rows that attend a
    key: q, g and the fp32 lse and delta; keys some query attends: k, v),
    outputs written once in full (``dq``: dq; ``dkv``: dk and dv). FLOPs
    per attended (query, key) pair: 6*D for dq (s, dP, dS.K), 8*D for dk/dv
    (s, dP, P^T.dO, dS^T.Q)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    valid = valid.expand(b, 1, tq, tk)
    pairs = valid.sum().item() * h
    rows = valid.any(dim=3).sum().item() * h
    keys = valid.any(dim=2).sum().item() * h
    nbytes = (rows + keys) * d * 2 * esize + rows * 2 * 4
    if kernel == "dq":
        nbytes += b * h * tq * d * esize
        flops = 6.0 * d * pairs
    else:
        nbytes += 2 * b * h * tk * d * esize
        flops = 8.0 * d * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# (name, b, tq, tk, d, causal, cache_offset, lengths, want_lse) of the
# forward's own cases, H = 12; lengths "decode" are drawn from the seed
FWD_CASES = [
    # prefill at the largest and the smallest bucket: B=1, causal
    ("prefill_causal_B1_T256", 1, 256, 256, 64, True, False, None, False),
    ("prefill_causal_B1_T16", 1, 16, 16, 64, True, False, None, False),
    # a decode step: 8 slots against the 512-token cache, ragged fill
    ("decode_cache_offset_S8_Tk512", 8, 1, 512, 64, True, True, "decode",
     False),
    # non-causal key lengths (one empty row set) with the lse output
    ("lengths_lse_B4_T128x384", 4, 128, 384, 64, False, False,
     (384, 200, 17, 0), True),
    # the training forward: B=8, T=256, causal, with the lse the backward
    # needs
    ("train_causal_lse_B8_T256", 8, 256, 256, 64, True, False, None, True),
    # BERT-base's training forward (bench.py's bert row): B=24, T=128, no
    # causal mask, key lengths "bert" drawn from the seed, with the lse
    ("bert_lengths_lse_B24_T128", 24, 128, 128, 64, False, False, "bert",
     True),
]
# the training forward on the GPT's own operands: q, k, v views of one
# fused (B, T, 3, H, D) projection, o into a (B, T, H, D) buffer
GPT_VIEWS = "gpt_qkv_views_B8_T256"
FWD_HEAD = "train_causal_lse_B8_T256"
FWD_DECODE = "decode_cache_offset_S8_Tk512"
# the lse against the plain version's, absolute (-inf rows identical)
LSE_TOL = 1e-3
FWD_ROUTES = ("tc", "f32", "split", "simt")


def bert_lengths(seed, b, t):
    """BERT's per-sample ``valid_length``: ``b`` lengths drawn from
    ``seed`` in [1, t], with t and 1 both among them (int32)."""
    lens = np.random.RandomState(seed + 91).randint(1, t + 1, size=b)
    lens[:2] = (t, 1)[:b]
    return lens.astype(np.int32)


def fwd_cases():
    """The forward's cases, the GPT-views case, then each of ``BWD_CASES``
    whose shape is not among them (with the lse): D=128, Tq=16 with cache
    offset, Tq > Tk."""
    cases = list(FWD_CASES)
    cases.append((GPT_VIEWS, *next(c for c in FWD_CASES
                                   if c[0] == FWD_HEAD)[1:]))
    seen = {c[1:8] for c in cases}
    cases += [(*c, True) for c in BWD_CASES if c[1:] not in seen]
    return cases


def fwd_route_expected(tq, d, dtype):
    """The route ``flash_fwd_route`` gives a call with aligned operands:
    one query row the split kernels; D 64 or 128 in bf16 the tensor-core
    kernel, in fp32 from ``FWD_F32_MIN_TQ`` query rows the f32 kernel;
    the rest SIMT."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    if tq == 1:
        return "split"
    if d in (64, 128) and dtype == torch.bfloat16:
        return "tc"
    if d in (64, 128) and tq >= fa.FWD_F32_MIN_TQ:
        return "f32"
    return "simt"


def _fwd_route_counts(fa):
    return {r: getattr(fa, f"flash_fwd_{r}_launches") for r in FWD_ROUTES}


def _check_fwd_route(label, before, now, expect):
    """One forward call since ``before``, on ``expect``."""
    taken = [r for r in FWD_ROUTES if now[r] - before[r] == 1]
    if taken != [expect] or sum(now.values()) - sum(before.values()) != 1:
        raise AssertionError(f"flash_fwd {label} took {taken}, not "
                             f"{expect}")


def _check_fwd_out(label, got, want, dtype):
    """(o's max abs err, the lse's) of a forward ``(o, lse)`` against the
    plain version's: o within ``TOLS``, the lse within ``LSE_TOL`` (fp32:
    ``TOLS``) with its -inf rows identical, and no NaN in either."""
    if torch.isnan(got[0]).any() or torch.isnan(got[1]).any():
        raise AssertionError(f"flash_fwd {label}: NaN")
    err = (got[0].float() - want[0].float()).abs().max().item()
    g_inf, w_inf = torch.isinf(got[1]), torch.isinf(want[1])
    if not torch.equal(g_inf, w_inf):
        raise AssertionError(f"flash_fwd {label}: lse -inf rows differ")
    fin = ~w_inf
    lse_err = (got[1][fin] - want[1][fin]).abs().max().item() \
        if fin.any() else 0.0
    tol = TOLS[dtype]
    lse_tol = min(tol, LSE_TOL)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"flash_fwd {label}: max abs err {err} > {tol}")
    if not math.isfinite(lse_err) or lse_err > lse_tol:
        raise AssertionError(f"flash_fwd {label}: lse max abs err "
                             f"{lse_err} > {lse_tol}")
    return err, lse_err


def kernel_phase(seed, dev=None, cases=None, h=12):
    """K4 against its plain version on ``fwd_cases()`` in fp32 and bf16.
    Each row names its route (``flash_attention.flash_fwd_route``) and must
    take the one the rule gives its shape; a row not on the SIMT route
    also runs the SIMT kernel on the same inputs, held to the same
    tolerances, and times it (``simt_ms``; the SIMT numbers also make a
    row of their own, route "simt"); an f32 row's output and lse equal a
    second launch's bit for bit. The
    library call is SDPA under the same boolean mask and, for causal rows
    with Tq == Tk and no lengths (where its top-left causal mask is the
    same one), with ``is_causal=True`` (``library_causal_ms``). o is held
    to ``TOLS``, the lse to ``LSE_TOL`` (fp32: ``TOLS``) with its -inf rows
    identical, and neither holds a NaN."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0) if dev is None else dev
    rs = np.random.RandomState(seed)
    decode_lens = np.sort(rs.randint(1, 513, size=8))
    results = []
    for name, b, tq, tk, d, causal, cache_offset, lengths, want_lse in \
            (fwd_cases() if cases is None else cases):
        if isinstance(lengths, str):
            lengths = decode_lens if lengths == "decode" else \
                bert_lengths(seed, b, tk)
        for dtype in (torch.float32, torch.bfloat16):
            if name == GPT_VIEWS:
                qkv = torch.from_numpy(rs.randn(b, tq, 3, h, d).astype(
                    np.float32)).to(dev, dtype)
                q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            else:
                q, k, v = (torch.from_numpy(rs.randn(b, h, t, d).astype(
                    np.float32)).to(dev, dtype) for t in (tq, tk, tk))
            lens = None if lengths is None else \
                torch.tensor(np.asarray(lengths, np.int32), device=dev)
            kw = dict(causal=causal, cache_offset=cache_offset,
                      return_lse=True)
            expect = fwd_route_expected(tq, d, dtype)
            before = _fwd_route_counts(fa)
            got = fa.flash_attention(q, k, v, lens, **kw)
            label = f"{name} {DTYPE_NAMES[dtype]}"
            _check_fwd_route(label, before, _fwd_route_counts(fa), expect)
            want = fa.flash_attention_reference(q, k, v, lens, **kw)
            err, lse_err = _check_fwd_out(label, got, want, dtype)
            simt_err = simt_lse_err = None
            if expect != "simt":
                simt_err, simt_lse_err = _check_fwd_out(
                    f"{label} simt", fa.flash_attention(q, k, v, lens,
                                                        route="simt", **kw),
                    want, dtype)
            if expect == "f32":
                again = fa.flash_attention(q, k, v, lens, **kw)
                if not (torch.equal(again[0], got[0])
                        and torch.equal(again[1], got[1])):
                    raise AssertionError(f"flash_fwd {label}: a second "
                                         "launch differs")
                del again
            tol = TOLS[dtype]
            lse_tol = min(tol, LSE_TOL)
            valid = _valid_mask(b, tq, tk, lens, causal, cache_offset, dev)
            kw["return_lse"] = want_lse

            def kernel(route=None):
                return fa.flash_attention(q, k, v, lens, route=route, **kw)

            ms = device_ms(kernel)
            wrapper_ms = call_ms(kernel)
            plain_ms = device_ms(
                lambda: fa.flash_attention_reference(q, k, v, lens, **kw))
            simt_ms = device_ms(lambda: kernel("simt")) \
                if expect != "simt" else None
            library_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=valid))
            library_causal_ms = device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True)) \
                if causal and lens is None and tq == tk else None
            bound_ms, bound_by = attention_bound(b, h, tq, tk, d, dtype,
                                                 valid, want_lse)
            r = dict(kernel="flash_fwd", case=name, dtype=DTYPE_NAMES[dtype],
                     route=expect, max_abs_err=err, lse_err=lse_err,
                     simt_max_abs_err=simt_err, tol=tol,
                     lse_tol=lse_tol, ms=ms, wrapper_ms=wrapper_ms,
                     plain_ms=plain_ms, simt_ms=simt_ms,
                     library_ms=library_ms,
                     library_causal_ms=library_causal_ms,
                     bound_ms=bound_ms, bound_by=bound_by)
            results.append(r)
            if simt_ms is not None:
                results.append(dict(
                    r, route="simt", max_abs_err=simt_err,
                    lse_err=simt_lse_err, simt_max_abs_err=None,
                    ms=simt_ms, wrapper_ms=call_ms(lambda: kernel("simt")),
                    simt_ms=None))
            also = "" if simt_ms is None else \
                (f" simt_ms={simt_ms:.5f} (SIMT kernel, max_abs_err="
                 f"{simt_err:.3e})")
            if library_causal_ms is not None:
                also += (f" library_causal_ms={library_causal_ms:.5f} (SDPA,"
                         " is_causal)")
            print(f"kernel flash_fwd {label} route {expect}: max_abs_err="
                  f"{err:.3e} (tol {tol:g}) lse_err={lse_err:.3e} (tol "
                  f"{lse_tol:g}) ms={ms:.5f} (device, CUDA graph) "
                  f"wrapper_ms={wrapper_ms:.5f} (eager call, host included)"
                  f" plain_ms={plain_ms:.5f}{also} library_ms="
                  f"{library_ms:.5f} (SDPA, boolean mask) bound_ms="
                  f"{bound_ms:.5f} ({bound_by})", flush=True)
    slower = [f"{r['case']} {r['dtype']} ({r['route']} {r['ms']:.5f} >= "
              f"simt {r['simt_ms']:.5f})" for r in results
              if r["simt_ms"] is not None and r["ms"] >= r["simt_ms"]]
    print("flash_fwd: the tc, f32 and split routes against the SIMT kernel "
          "on the same inputs: " + ("faster in every row" if not slower else
                                    "not faster in " + "; ".join(slower)),
          flush=True)
    return results


def _sdpa_bwd_ms(q, k, v, g, valid, causal=False):
    """Device ms of ``scaled_dot_product_attention``'s backward under the
    same boolean mask (``causal``: with ``is_causal=True`` and no mask,
    which lets it take its flash backend): a CUDA graph of forward +
    ``autograd.grad`` less a graph of the forward alone (grad enabled in
    both, so the forward saves what its backward needs). A yardstick only;
    fully masked rows give NaN there and are not compared."""
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    kw = dict(is_causal=True) if causal else dict(attn_mask=valid)

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, **kw)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qg, kg, vg), g)

    return device_ms(fwd_bwd) - device_ms(fwd)


def _zero_where_unreached(name, dq, dk, dv, valid):
    """Rows that see no key get dq == 0, keys no row sees get dk == dv ==
    0, exactly (no NaN anywhere)."""
    dead_rows = ~valid.any(dim=3)                      # (B, 1, Tq)
    dead_keys = ~valid.any(dim=2)                      # (B, 1, Tk)
    for label, x, dead in (("dq", dq, dead_rows), ("dk", dk, dead_keys),
                           ("dv", dv, dead_keys)):
        if torch.isnan(x).any():
            raise AssertionError(f"{name}: NaN in {label}")
        mask = dead.unsqueeze(-1).expand_as(x)
        if mask.any() and x[mask].abs().max().item() != 0:
            raise AssertionError(f"{name}: {label} not 0 where no pair "
                                 "reaches it")


# (name, b, tq, tk, d, causal, cache_offset, lengths) of the backward
# kernel phase, H = 12
BWD_CASES = [
    # the training shape: B=8, H=12, T=256, causal
    ("train_causal_B8_T256", 8, 256, 256, 64, True, False, None),
    # non-causal key lengths with a length-0 entry
    ("lengths_lse_B4_T128x384", 4, 128, 384, 64, False, False,
     (384, 200, 17, 0)),
    # cache offset: the diagonal aligned to each entry's fill
    ("cache_offset_B4_T16x512", 4, 16, 512, 64, True, True,
     (512, 300, 64, 16)),
    # Tq > Tk causal: the first 192 rows of each head see no key
    ("tq_gt_tk_causal_B2_T256x64", 2, 256, 64, 64, True, False, None),
    # D=128: two 64-column boxes a row on the tensor-core route
    ("causal_D128_B2_T512", 2, 512, 512, 128, True, False, None),
    # BERT-base's training shape: no causal mask, key lengths "bert" drawn
    # from the seed (one sample of 1 key, one of all 128)
    ("bert_lengths_B24_T128", 24, 128, 128, 64, False, False, "bert"),
]
BWD_HEAD = "train_causal_B8_T256"


# the backward's routes (``flash_attention.flash_bwd_route``): "tc" the
# bf16 tensor-core kernels, "f32" the fp32 register micro-tile kernels,
# "simt" the others
BWD_ROUTES = ("tc", "f32", "simt")
# the flash kernels' launches by route: the backward's, then the
# forward's (``FWD_ROUTES``)
ROUTE_COUNTERS = tuple(f"{k}_{r}" for k in ("flash_bwd_dq", "flash_bwd_dkv")
                       for r in BWD_ROUTES) + tuple(f"flash_fwd_{r}"
                                                    for r in FWD_ROUTES)


def _read_routes(fa):
    return {name: getattr(fa, name + "_launches") for name in ROUTE_COUNTERS}


def bwd_route_expected(d, dtype):
    """The route ``flash_bwd_route`` gives a call with aligned operands."""
    if d not in (64, 128):
        return "simt"
    return "tc" if dtype == torch.bfloat16 else "f32"


def _check_bwd_route(label, before, now, expect):
    """One launch of each backward kernel since ``before``, on ``expect``."""
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        taken = [r for r in BWD_ROUTES if now[f"{kernel}_{r}"]
                 - before[f"{kernel}_{r}"] == 1]
        if taken != [expect] or sum(
                now[f"{kernel}_{r}"] - before[f"{kernel}_{r}"]
                for r in BWD_ROUTES) != 1:
            raise AssertionError(f"{kernel} {label} took {taken}, not "
                                 f"{expect}")


def _bwd_errs(label, got, want, valid, tol):
    """{dq, dk, dv: (max abs err, err / max|plain|)} of a backward against
    the plain version's, each within ``tol`` of max|plain|, with no NaN and
    exact zeros where no pair reaches."""
    _zero_where_unreached(label, *got, valid)
    errs = {}
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err = (x.float() - y.float()).abs().max().item()
        # relative to max|plain|: the bf16 kernels round p and dS to bf16
        # before their products (as the TPU kernels do), the plain version
        # keeps them in fp32; in fp32 only the order of sums differs
        ref = max(1.0, y.float().abs().max().item())
        if not math.isfinite(err) or err > tol * ref:
            raise AssertionError(f"flash_bwd {label} {name}: max abs err "
                                 f"{err} > {tol} x {ref}")
        errs[name] = (err, err / ref)
    return errs


def backward_kernel_phase(seed, dev=None, cases=None, h=12):
    """K5 and K6 against their plain versions on ``BWD_CASES`` (or
    ``cases``) in fp32 and bf16. Each row names its route
    (``flash_attention.flash_bwd_route``) and must take the one the rule
    gives it (``_check_bwd_route``): with D 64 or 128, bf16 the
    tensor-core kernels (``csrc/flash_bwd_tc.cu``) and fp32 the register
    micro-tile kernels (``csrc/flash_bwd_f32.cu``); D = 32 the SIMT kernels
    (``csrc/flash_bwd.cu``). A row not on the SIMT route also runs the
    SIMT kernels on the same inputs, held to the same tolerance and timed
    (``simt_ms``; the SIMT numbers also make a row of their own, route
    "simt"); every f32 output equals a second launch's bit for bit. The
    library call is SDPA's whole backward under the same boolean mask and,
    for causal rows with Tq == Tk and no lengths (where its top-left
    causal mask is the same one), with ``is_causal=True``
    (``library_causal_ms``). ``delta_ms`` is the row statistic ``delta =
    sum(g * o)`` as ``FlashAttentionFunction`` computes it before the two
    kernels (ATen), so that dq + dk/dv + delta is the port's whole
    backward beside SDPA's."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0) if dev is None else dev
    rs = np.random.RandomState(seed + 7)
    results = []
    for name, b, tq, tk, d, causal, cache_offset, lengths in \
            (BWD_CASES if cases is None else cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.from_numpy(rs.randn(b, h, t, d).astype(
                np.float32)).to(dev, dtype) for t in (tq, tk, tk, tq))
            if isinstance(lengths, str):
                lengths = bert_lengths(seed, b, tk)
            lens = None if lengths is None else \
                torch.tensor(lengths, dtype=torch.int32, device=dev)
            kw = dict(causal=causal, cache_offset=cache_offset)
            out, lse = fa.flash_attention(q, k, v, lens, return_lse=True,
                                          **kw)
            delta = (g.float() * out.float()).sum(-1)
            args = (q, k, v, lens, lse, delta, g)
            label = f"{name} {DTYPE_NAMES[dtype]}"
            expect = bwd_route_expected(d, dtype)
            before = _read_routes(fa)
            got = (fa.flash_bwd_dq(*args, **kw), *fa.flash_bwd_dkv(*args,
                                                                   **kw))
            want = (fa.flash_bwd_dq_reference(*args, **kw),
                    *fa.flash_bwd_dkv_reference(*args, **kw))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _check_bwd_route(label, before, _read_routes(fa), expect)
            valid = _valid_mask(b, tq, tk, lens, causal, cache_offset, dev)
            tol = TOLS[dtype]
            errs = _bwd_errs(label, got, want, valid, tol)
            simt_errs = None
            if expect != "simt":
                simt_errs = _bwd_errs(f"{label} simt", fa.flash_attention_bwd(
                    *args, route="simt", **kw), want, valid, tol)
            if expect == "f32":
                again = fa.flash_attention_bwd(*args, **kw)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"flash_bwd {label}: a second "
                                         "launch differs")
                del again
            library_ms = _sdpa_bwd_ms(q, k, v, g, valid)
            library_causal_ms = _sdpa_bwd_ms(q, k, v, g, valid, causal=True) \
                if causal and lens is None and tq == tk else None
            delta_ms = device_ms(lambda: (g.float() * out.float()).sum(-1))
            for kernel, labels, launch, plain in (
                    ("dq", ("dq",), fa.flash_bwd_dq,
                     fa.flash_bwd_dq_reference),
                    ("dkv", ("dk", "dv"), fa.flash_bwd_dkv,
                     fa.flash_bwd_dkv_reference)):
                plain_ms = device_ms(lambda: plain(*args, **kw))
                bound_ms, bound_by = attention_bwd_bound(
                    kernel, b, h, tq, tk, d, dtype, valid)
                common = dict(kernel=f"flash_bwd_{kernel}", case=name,
                              dtype=DTYPE_NAMES[dtype], tol=tol,
                              plain_ms=plain_ms, library_ms=library_ms,
                              library_causal_ms=library_causal_ms,
                              delta_ms=delta_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
                rows = [(expect, errs)]
                if simt_errs is not None:
                    rows.append(("simt", simt_errs))
                simt_ms = None
                for route, e in reversed(rows):   # the SIMT row first
                    ms = device_ms(lambda: launch(*args, route=route, **kw))
                    wrapper_ms = call_ms(lambda: launch(*args, route=route,
                                                        **kw))
                    err = max(e[x][0] for x in labels)
                    rel = max(e[x][1] for x in labels)
                    r = dict(common, route=route, max_abs_err=err,
                             err_over_max_ref=rel, ms=ms,
                             wrapper_ms=wrapper_ms,
                             simt_ms=simt_ms if route == expect else None)
                    results.append(r)
                    also = "" if r["simt_ms"] is None else \
                        f" simt_ms={simt_ms:.5f} (SIMT kernel)"
                    if library_causal_ms is not None:
                        also += (f" library_causal_ms={library_causal_ms:.5f}"
                                 " (SDPA whole backward, is_causal)")
                    also += f" delta_ms={delta_ms:.5f} (ATen)"
                    print(f"kernel flash_bwd_{kernel} {label} route {route}:"
                          f" max_abs_err={err:.3e} ({rel:.2e} of max|plain|,"
                          f" tol {tol:g}) ms={ms:.5f} (device, CUDA graph) "
                          f"wrapper_ms={wrapper_ms:.5f} (eager call) "
                          f"plain_ms={plain_ms:.5f} library_ms="
                          f"{library_ms:.5f} (SDPA whole backward, boolean "
                          f"mask){also} bound_ms={bound_ms:.5f} ({bound_by})",
                          flush=True)
                    if route == "simt":
                        simt_ms = ms
            del q, k, v, g, out, lse, delta, args, got, want
            gc.collect()
    slower = [f"{r['kernel']} {r['case']} {r['dtype']} ({r['route']} "
              f"{r['ms']:.5f} >= simt {r['simt_ms']:.5f})" for r in results
              if r["simt_ms"] is not None and r["ms"] >= r["simt_ms"]]
    print("flash_bwd: the tc and f32 routes against the SIMT kernels on the "
          "same inputs: " + ("faster in every row" if not slower else
                             "not faster in " + "; ".join(slower)),
          flush=True)
    return results


# ---------------------------------------------------------------------------
# serving phase
# ---------------------------------------------------------------------------
def oracle_check(net, prompt, stream, dev):
    """Hold ``stream`` against the full-forward greedy oracle; returns the
    number of tokens checked. A mismatch fails unless the oracle's two
    best logits there differ by less than 1e-4 (a near tie that summation
    order may flip); then the position is printed and the check of this
    stream ends there (the two continuations differ from then on)."""
    seq = [int(t) for t in prompt]
    with torch.no_grad():
        for i, tok in enumerate(stream):
            logits = net(torch.tensor([seq], device=dev))[0, -1]
            if not torch.isfinite(logits).all():
                raise AssertionError("oracle logits not finite")
            top = torch.topk(logits, 2)
            want = int(top.indices[0])
            if want != tok:
                gap = float(top.values[0] - top.values[1])
                if gap >= 1e-4:
                    raise AssertionError(
                        f"decode stream diverged from the oracle at token "
                        f"{i}: got {tok}, oracle {want} (top-2 gap {gap})")
                print(f"near tie at token {i} (top-2 gap {gap:.2e}): "
                      f"stream {tok}, oracle {want}; check ends here")
                return i
            seq.append(tok)
    return len(stream)


def decode_routes(buckets, prompt_lens, steps):
    """The forward launches by route of fp32 decode serving: 12 a decode
    step (Tq = 1: split) and 12 a prefill, whose Tq is its prompt's
    bucket (fp32: simt)."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    want = dict.fromkeys(FWD_ROUTES, 0)
    want["split"] += 12 * steps
    for n in prompt_lens:
        bucket = min(bk for bk in buckets if bk >= n)
        want[fwd_route_expected(bucket, 64, torch.float32)] += 12
    return want


def slice_phase(seed, card=None):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    ctx = mx.gpu(0)
    t0 = time.perf_counter()
    mx.random.seed(seed)
    net = get_gpt("gpt_decoder_117m", dropout=0.0).initialize("xavier",
                                                              ctx=ctx)
    nparams = sum(p.numel() for p in net.parameters())
    print(f"model gpt_decoder_117m: {nparams} parameters "
          f"({nparams * 4 / 1e6:.1f} MB fp32), drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    sess = serving.DecodeSession(net, ctx=ctx, max_slots=8, max_len=512,
                                 name="gpt117m")
    try:
        t0 = time.perf_counter()
        sess.warmup()
        print(f"warmup: {time.perf_counter() - t0:.2f} s, buckets "
              f"{sess.prefill_buckets}", flush=True)
        rs = np.random.RandomState(seed + 1)
        lengths = [5, 250, 17, 96, 33, 180, 8, 64, 128, 240, 12, 45]
        prompts = [rs.randint(0, net.vocab_size, (n,)).astype(np.int32)
                   for n in lengths]
        new_tokens = 32
        # free what earlier phases left (CUDA-graph pools sit in
        # reference cycles) so the peak belongs to the serving run
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches(fa)
        t0 = time.perf_counter()
        handles = [sess.submit(p, max_new_tokens=new_tokens)
                   for p in prompts]
        streams = [h.result(600) for h in handles]
        wall = time.perf_counter() - t0
        launches = fa.flash_fwd_launches
        routes = _fwd_route_counts(fa)
        stats = sess.stats()
        peak = torch.cuda.max_memory_allocated(dev)
        step_times = decode_step_times(sess, card or card_line(),
                                        net.vocab_size)
        prefill = prefill_times(sess, card or card_line(), net.vocab_size)
        if not sess.drain(60):
            raise AssertionError("decode session did not drain")
    finally:
        sess.close()

    for s in streams:
        if len(s) != new_tokens or min(s) < 0 or max(s) >= net.vocab_size:
            raise AssertionError(f"bad stream {s}")
    steps, prefills = stats["steps"], stats["prefills"]
    tokens = sum(len(s) for s in streams)
    decode_tok_s = (tokens - prefills) / stats["decode_seconds"]
    print(f"serve: {len(prompts)} requests, {tokens} tokens in {wall:.3f} s "
          f"= {tokens / wall:.1f} tokens/s end to end; decode steps "
          f"{steps}, mean step {stats['decode_seconds'] / steps * 1e3:.3f} "
          f"ms, {decode_tok_s:.1f} decode tokens/s; mean occupancy "
          f"{stats['mean_step_occupancy']:.2f} of 8; TTFT p50 "
          f"{stats['ttft_ms']['p50']:.2f} ms p90 "
          f"{stats['ttft_ms']['p90']:.2f} ms (with an eager prefill "
          f"PERF.md section 5 holds 197.60 / 269.56 and 33.85 / 99.66); "
          f"prefill share "
          f"{stats['prefill_frac']:.3f}; peak memory {peak / 2**20:.1f} MiB "
          f"(allocated before serving, weights and KV cache: "
          f"{base / 2**20:.1f} MiB)", flush=True)
    print(f"flash_fwd launches on the main path: {launches} "
          f"(>= 12 x {steps} decode steps = {12 * steps}; 12 x ({steps} "
          f"steps + {prefills} prefills) = {12 * (steps + prefills)})",
          flush=True)
    if launches < 12 * steps:
        raise AssertionError("the decode path did not go through the "
                             "flash_fwd kernel")
    want_routes = decode_routes(sess.prefill_buckets, lengths, steps)
    print(f"flash_fwd launches by route: {routes} (want {want_routes}: the "
          f"{steps} decode steps on split)", flush=True)
    if routes != want_routes or prefills != len(prompts):
        raise AssertionError(f"serving launched flash_fwd by route {routes}"
                             f", not {want_routes}")

    order = np.argsort(lengths)
    checked = [int(order[0]), int(order[len(order) // 2]), int(order[-1])]
    for i in checked:
        n = oracle_check(net, prompts[i], streams[i], dev)
        print(f"oracle: request {i} (prompt {lengths[i]} tokens) matched "
              f"{n} of {len(streams[i])} tokens", flush=True)
    return dict(launches=launches, routes=routes, steps=steps,
                prefills=prefills, tokens=tokens, wall_s=wall, stats=stats,
                peak_bytes=peak, step_times=step_times, prefill=prefill)


def prefill_times(sess, card, vocab, reps=5):
    """Each prompt bucket's prefill as its captured CUDA graph (one replay
    through the session's prefill cache) and eagerly (``_prefill_apply``
    on the same padded tokens and true length): the first token and the
    K/V planes bit-equal for two true lengths in the bucket (one graph
    serves both); the launches each graph's capture recorded (12 K4 on
    its bucket's route, ``fwd_route_expected``); host ms a prefill (the
    prompt's copy to the card and the first token's back included; the
    median of ``reps`` alternating turns) and device time
    (``torch.profiler``) of each."""
    dev = sess.device
    cache = sess._prefill_cache
    rs = np.random.RandomState(9)
    rows = {}
    for b in sess.prefill_buckets:
        for n in sorted({b // 2 + 1, b}):
            prompt = rs.randint(0, vocab, (n,)).astype(np.int32)
            padded = np.zeros((b,), np.int32)
            padded[:n] = prompt
            tokens = torch.from_numpy(padded).to(dev)
            count = torch.tensor(n, dtype=torch.int32, device=dev)
            with sess._exec_lock:
                got = [t.clone() for t in sess._prefill(prompt)]
            want = sess._prefill_apply(tokens, count)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"prefill bucket {b}, {n} tokens: the "
                                     "graph's first token or K/V planes "
                                     "differ from the eager prefill")

        def graph_call():
            with sess._exec_lock:
                return int(sess._prefill(prompt)[0])

        def eager_call():
            return int(sess._prefill_apply(
                torch.from_numpy(padded).to(dev),
                torch.tensor(n, dtype=torch.int32, device=dev))[0])

        host = _median_turns({"graph": graph_call, "eager": eager_call},
                             reps)
        ex = cache._execs[(b, (), "int32")]
        recorded = _counts_by_name(ex.graph.counted) \
            if hasattr(ex, "graph") else {}
        route = fwd_route_expected(b, 64, torch.float32)
        want_rec = {"flash_fwd": 12, f"flash_fwd_{route}": 12} \
            if dev.type == "cuda" else {}
        if {k: v for k, v in recorded.items()
                if k.startswith("flash_fwd")} != want_rec:
            raise AssertionError(f"prefill bucket {b}: the capture recorded"
                                 f" {recorded}, not {want_rec}")
        rows[b] = dict(graph_ms=host["graph"], eager_ms=host["eager"],
                       graph_device_ms=_kernel_ms(graph_call),
                       eager_device_ms=_kernel_ms(eager_call),
                       route=route, recorded=recorded)
        r = rows[b]
        print(f"prefill bucket {b} ({card}): captured graph "
              f"{r['graph_ms']:.4f} ms, eager {r['eager_ms']:.4f} ms a "
              f"prefill (host clock, median of {reps} turns); device time "
              f"{r['graph_device_ms']:.4f} / {r['eager_device_ms']:.4f} ms;"
              f" K4 on {route}, the capture recorded {recorded}; first "
              f"token and K/V planes bit-equal to eager at "
              f"{sorted({b // 2 + 1, b})} tokens", flush=True)
    return rows


def decode_step_times(sess, card, vocab, steps=20):
    """The decode step of ``sess`` (all slots free: its sequences are
    done) as the captured graph (one replay) and eagerly (the same body
    launched from the host), on the same inputs (8 slots at cache lengths
    48 to 360): the next tokens equal, host ms a step including the
    next-token copy to the host (two alternating turns each), device time
    (``torch.profiler``), and K4's split-route launches: 12 a step
    recorded by the capture, counted by every graph step (measured over
    the graph turns) and seen by the profiler in a graph step and an
    eager one."""
    from incubator_mxnet_tpu_torch.ops import launches

    rs = np.random.RandomState(5)
    cl = np.linspace(48, 360, sess.max_slots).astype(np.int32)
    tk = rs.randint(0, vocab, (sess.max_slots,)).astype(np.int32)
    dev = sess.device

    def graph_step(c, t):
        return sess._decode(c, t).cpu()

    def eager_step(c, t):
        return sess._decode_step(torch.from_numpy(t).to(dev),
                                 torch.from_numpy(c).to(dev)).cpu()

    out = {}
    measured = {}
    with sess._exec_lock:
        got = {name: fn(cl, tk) for name, fn in (("graph", graph_step),
                                                 ("eager", eager_step))}
        if not torch.equal(got["graph"], got["eager"]):
            raise AssertionError(f"decode graph tokens {got['graph']} != "
                                 f"eager {got['eager']}")
        for name, fn in (("graph", graph_step), ("eager", eager_step),
                         ("graph", graph_step), ("eager", eager_step)):
            torch.cuda.synchronize()
            c0 = launches.snapshot()
            t0 = time.perf_counter()
            for _ in range(steps):
                fn(cl, tk)
            out[name] = (time.perf_counter() - t0) * 1e3 / steps
            if name == "graph":
                for n, v in _launch_delta(c0).items():
                    measured[n] = measured.get(n, 0) + v
        prof = {}
        for name, fn in (("graph", graph_step), ("eager", eager_step)):
            rows = _profile_step(fn, cl, tk, card, out[name],
                                 tags=FLASH_TAGS[3:5], top=4,
                                 what=f"decode step ({name})")
            _check_profiled(f"decode step ({name})", rows,
                            {"flash_fwd_split_kernel": 12,
                             "flash_fwd_merge_kernel": 12}, 1)
            prof[name] = sum(r[0] for r in rows)
    (graph,) = sess._graphs.graphs()
    counted = _counts_by_name(graph.counted)
    want = {"flash_fwd": 12, "flash_fwd_split": 12}
    print(f"decode step ({card}; 8 slots at 48-360 of 512): captured "
          f"graph {out['graph']:.4f} ms, eager {out['eager']:.4f} ms a step "
          f"(host clock, {steps} steps each, second turn); device time "
          f"{prof['graph']:.4f} / {prof['eager']:.4f} ms; the capture "
          f"recorded {counted}, {2 * steps} graph steps counted {measured}; "
          f"next tokens equal", flush=True)
    if counted != want or measured != {n: v * 2 * steps
                                       for n, v in want.items()}:
        raise AssertionError(f"the decode capture recorded {counted} and "
                             f"{2 * steps} graph steps counted {measured},"
                             f" not {want} a step")
    return dict(graph_ms=out["graph"], eager_ms=out["eager"],
                graph_device_ms=prof["graph"], eager_device_ms=prof["eager"],
                per_replay=counted, launches=measured)


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------
COUNTERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# bf16 training gradients, tensor-core K5/K6 vs their plain version on the
# same forward: relative L2 error per parameter tensor (the kernels round
# p and dS to bf16 before their products, the plain version does not)
BF16_GRAD_RTOL = 2e-2


def _reset_launches(fa):
    for name in COUNTERS + ROUTE_COUNTERS:
        setattr(fa, name + "_launches", 0)


def _read_launches(fa):
    return {name: getattr(fa, name + "_launches") for name in COUNTERS}


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _grads(net, loss_fn, x, y):
    """fp32 loss and the gradient of every trainable parameter, eager
    (record). ``x``/``y``: a tensor or a list of them (the net's inputs,
    the labels after its outputs in ``loss_fn``'s arguments)."""
    import incubator_mxnet_tpu_torch as mx

    params = [p for p in net.parameters() if p.requires_grad]
    with mx.autograd.record():
        loss = loss_fn(*_as_list(net(*_as_list(x))), *_as_list(y))
    return loss.detach(), torch.autograd.grad(loss, params)


class swap_attention:
    """``flash_attention`` of ``module`` (the model's module, which
    imported it) swapped for the plain forward, whose autograd is the
    plain backward, inside the block: for an oracle only."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        from incubator_mxnet_tpu_torch.ops import flash_attention as fa

        self.kernel = self.module.flash_attention
        self.module.flash_attention = fa.flash_attention_reference
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.kernel
        return False


# the key projection's bias of an attention with separate projections
# (BERT's) gets no gradient in exact arithmetic: it adds one constant to a
# row of scores, which the softmax drops
KEY_BIAS = ("attention.key.bias",)


def _worst_grad(label, names, grads, ref_grads, tol):
    """The worst relative L2 error ``||g - r|| / ||r||`` over the tensors,
    each within ``tol``. A tensor named by ``KEY_BIAS`` has a gradient of 0
    in exact arithmetic, so both sides carry rounding noise there: its
    error is held against the norm of the same layer's weight gradient
    instead."""
    ref = dict(zip(names, ref_grads))
    worst = (0.0, "")
    for name, g, r in zip(names, grads, ref_grads):
        scale = ref[name[:-len("bias")] + "weight"] \
            if name.endswith(KEY_BIAS) else r
        den = scale.float().norm().item()
        err = (g.float() - r.float()).norm().item()
        rel = err / den if den > 0 else err
        if not math.isfinite(rel) or rel > tol:
            raise AssertionError(f"{label}: {name} relative L2 error {rel} "
                                 f"> {tol}")
        worst = max(worst, (rel, name))
    return worst


def gradient_oracle(net, loss_fn, x, y, module=None):
    """Gradients through the kernels against the same model with its
    attention swapped for the autograd of the plain forward (dense, fp32;
    ``swap_attention`` of ``module``, the GPT's by default): relative L2
    error per parameter tensor <= GRAD_RTOL (``_worst_grad``)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import gpt as gpt_mod

    loss, grads = _grads(net, loss_fn, x, y)
    with swap_attention(gpt_mod if module is None else module):
        ref_loss, ref_grads = _grads(net, loss_fn, x, y)
    if not torch.isfinite(loss) or abs(float(loss - ref_loss)) > \
            1e-5 * abs(float(ref_loss)):
        raise AssertionError(f"oracle loss {float(loss)} != plain "
                             f"{float(ref_loss)}")
    names = [n for n, _ in net.named_parameters()]
    worst = _worst_grad("gradient oracle", names, grads, ref_grads,
                        GRAD_RTOL)
    print(f"gradient oracle (fp32, {len(names)} parameter tensors): loss "
          f"{float(loss):.6f} vs plain {float(ref_loss):.6f}; worst relative "
          f"L2 error {worst[0]:.3e} ({worst[1]}), tolerance {GRAD_RTOL:g}",
          flush=True)
    return worst[0]


def gpt_bf16_gate(net, loss_fn, x, y):
    """One bf16 step's gradients through the tensor-core K5/K6 against the
    same step with ``flash_attention_bwd`` swapped for its plain version
    (made here, for this gate only; the forward is the same K4 in both):
    relative L2 error per parameter tensor <= BF16_GRAD_RTOL
    (``_worst_grad``)."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    loss, grads = _grads(net, loss_fn, x, y)
    kernel_bwd = fa.flash_attention_bwd
    fa.flash_attention_bwd = fa.flash_attention_bwd_reference
    try:
        ref_loss, ref_grads = _grads(net, loss_fn, x, y)
    finally:
        fa.flash_attention_bwd = kernel_bwd
    if not torch.isfinite(loss) or not torch.equal(loss, ref_loss):
        raise AssertionError(f"bf16 gate: loss {float(loss)} != "
                             f"{float(ref_loss)} (the same forward)")
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    worst = _worst_grad("bf16 gradient gate", names, grads, ref_grads,
                        BF16_GRAD_RTOL)
    print(f"bf16 gradient gate ({len(names)} parameter tensors, tensor-core "
          f"K5/K6 vs their plain version on the same forward): worst "
          f"relative L2 error {worst[0]:.3e} ({worst[1]}), tolerance "
          f"{BF16_GRAD_RTOL:g}", flush=True)
    return worst[0]


FLASH_TAGS = ("flash_fwd_kernel", "flash_fwd_tc_kernel",
              "flash_fwd_f32_kernel",
              "flash_fwd_split_kernel", "flash_fwd_merge_kernel",
              "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
              "flash_bwd_dq_f32_kernel", "flash_bwd_dkv_f32_kernel")


# idle host time inside the profiler's window before and after the
# profiled call: the profiler drops kernels whose device timestamps fall
# outside its window, and the card's timestamps can lie milliseconds from
# the host's (tools/torch_profiler_window.py: with the window tight around
# a CUDA graph replay, the first kernels went missing in some profiles;
# a whole BERT step's K4-K6 once)
PROFILE_MARGIN_S = 0.1


def _kernel_rows(fn, *args):
    """``(rows, wall ms)`` of one call of ``fn(*args)`` under
    ``torch.profiler``: ``(device ms, launches, CUDA function)`` per
    kernel, largest first (kernel events only, so no time is counted
    twice). On a card the window holds ``PROFILE_MARGIN_S`` of idle time
    on each side of the call; the wall time is the call's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    margin = PROFILE_MARGIN_S if torch.cuda.is_available() else 0.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin)
    rows = []
    for e in prof.key_averages():
        # kernels only: no CPU op and no user range (which would count
        # its kernels a second time)
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows, wall_ms


def _kernel_ms(fn, *args):
    """Device time (ms) of one call of ``fn(*args)``: its kernels' sum
    under ``torch.profiler`` (0 where it reports none: not measured)."""
    return sum(r[0] for r in _kernel_rows(fn, *args)[0])


def _median_turns(fns, reps):
    """Host ms a call of each of ``fns`` (name -> function), the median
    of ``reps`` alternating turns, each ending in a synchronize."""
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(v)) for name, v in times.items()}


def _profile_step(step, x, y, card, step_ms, tags=FLASH_TAGS, top=14,
                  what="bf16 training step"):
    """Device time per kernel of one training step (``torch.profiler``;
    kernel events only, so no time is counted twice), printed largest
    first, with the device's idle share of an unprofiled step of
    ``step_ms`` and the share of the kernels named by ``tags``; returns
    the rows."""
    rows, wall_ms = _kernel_rows(step, x, y)
    total = sum(r[0] for r in rows)
    print(f"profile of one {what} ({card}): device time "
          f"{total:.3f} ms in {sum(r[1] for r in rows)} kernel launches "
          f"(step wall {wall_ms:.3f} ms under the profiler); against the "
          f"unprofiled {step_ms:.3f} ms step the device idles "
          f"{100 * max(0.0, 1 - total / step_ms):.1f}% of it", flush=True)
    if total == 0:
        print("profile: the profiler reported no device time (not "
              "measured)", flush=True)
        return rows
    for ms, count, key in rows[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<4d} "
              f"{key[:100]}", flush=True)
    for tag in tags:
        hit = [r for r in rows if tag in r[2]]
        ms = sum(r[0] for r in hit)
        print(f"  {tag}: {ms:.3f} ms ({100 * ms / total:.1f}% of device "
              f"time) in {sum(r[1] for r in hit)} launches", flush=True)
    return rows


def training_routes(fp32_passes, bf16_passes, layers=12, t=256, d=64):
    """The flash launches by route of ``fp32_passes`` and ``bf16_passes``
    training passes of a GPT of ``layers`` layers at sequence length ``t``
    and head dim ``d``: each kernel once a layer a pass, K4 of fp32 passes
    where ``fwd_route_expected`` sends them (f32 at T=256), K5/K6 of fp32
    passes on f32, every bf16 pass on tc."""
    want = dict.fromkeys(ROUTE_COUNTERS, 0)
    want["flash_fwd_" + fwd_route_expected(t, d, torch.float32)] = \
        layers * fp32_passes
    want["flash_fwd_tc"] = layers * bf16_passes
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        want[f"{kernel}_f32"] = layers * fp32_passes
        want[f"{kernel}_tc"] = layers * bf16_passes
    return want


def train_phase(seed, card):
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel, serving
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    ctx = mx.gpu(0)
    b, t, vocab = 8, 256, 50257
    mx.random.seed(seed)
    net = get_gpt("gpt_decoder_117m", vocab_size=vocab, dropout=0.0,
                  max_length=t).initialize("xavier", ctx=ctx)
    rs = np.random.RandomState(seed + 3)
    x = torch.from_numpy(rs.randint(0, vocab, (b, t)).astype(np.int32))
    y = torch.from_numpy(rs.randint(0, vocab, (b, t)).astype(np.float32))
    x, y = x.to(dev), y.to(dev)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    def lm_loss(logits, labels):
        return ce(logits, labels).mean()

    # the training launches are read in two windows, each with the counts
    # set to 0 just before its first step and read just after its last;
    # train -> decode between them is read on its own
    _reset_launches(fa)
    worst = gradient_oracle(net, lm_loss, x, y)

    # learning check: the loss on one repeated batch falls
    st = parallel.SPMDTrainer(net, lm_loss, "adam", {"learning_rate": 3e-4})
    losses = [float(st.step(x, y)) for _ in range(10)]
    launches = _read_launches(fa)
    routes = _read_routes(fa)
    backward_passes = fp32_passes = 1 + 10
    print(f"learning check (fp32 SPMDTrainer, adam lr 3e-4, one batch "
          f"repeated): losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("the loss did not fall by 5% over 10 steps")
    st.sync_to_net()
    del st

    # train -> decode: serve the trained weights
    prompt = rs.randint(0, vocab, (24,)).astype(np.int32)
    _reset_launches(fa)
    with serving.DecodeSession(net, ctx=ctx, max_slots=2, max_len=t,
                               name="trained") as sess:
        stream = sess.generate(prompt, max_new_tokens=16)
        stats = sess.stats()
    decode_launches = _read_launches(fa)
    decode_routes_got = _fwd_route_counts(fa)
    n = oracle_check(net, prompt, stream, dev)
    steps, prefills = stats["steps"], stats["prefills"]
    print(f"train -> decode: the trained weights served {len(stream)} "
          f"tokens; {n} matched the full-forward oracle; launches "
          f"{decode_launches} in {steps} decode steps and {prefills} "
          f"prefills (flash_fwd >= 12 x {steps} = {12 * steps})", flush=True)
    if decode_launches["flash_fwd"] < 12 * steps \
            or decode_launches["flash_bwd_dq"] \
            or decode_launches["flash_bwd_dkv"]:
        raise AssertionError("train -> decode: the decode path did not go "
                             "through flash_fwd alone")
    # the session was not warmed up: its first decode step captured the
    # step's graph, whose warm-up ran the step once more on the card, and
    # its prefill captured the prompt's bucket, whose warm-up ran the
    # prefill once more
    want_routes = decode_routes(sess.prefill_buckets, [len(prompt)] * 2,
                                steps + 1)
    if decode_routes_got != want_routes or prefills != 1:
        raise AssertionError(f"train -> decode launched flash_fwd by route "
                             f"{decode_routes_got}, not {want_routes}")

    _reset_launches(fa)
    # the eager entry point: record -> backward -> step
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1e-4, "momentum": 0.9})
    eager = []
    for _ in range(2):
        with mx.autograd.record():
            per_sample = ce(net(x), y)
        mx.autograd.backward(per_sample)
        trainer.step(b)
        eager.append(float(per_sample.detach().mean()))
    backward_passes += 2
    fp32_passes += 2
    if not all(math.isfinite(v) for v in eager):
        raise AssertionError(f"gluon.Trainer losses not finite: {eager}")
    print(f"gluon.Trainer (fp32, sgd lr 1e-4 momentum 0.9): 2 steps, "
          f"losses {eager}", flush=True)
    window = _read_launches(fa)
    launches = {name: launches[name] + window[name] for name in COUNTERS}
    window = _read_routes(fa)
    routes = {name: routes[name] + window[name] for name in ROUTE_COUNTERS}

    # the bf16 gradient gate, read on its own: one pass through the
    # tensor-core K5/K6, one through their plain version (K4 in both)
    net.cast("bfloat16")
    _reset_launches(fa)
    bf16_worst = gpt_bf16_gate(net, lm_loss, x, y)
    gate = {**_read_launches(fa), **_read_routes(fa)}
    want_gate = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                 "flash_bwd_dq_tc": 12, "flash_bwd_dkv_tc": 12,
                 "flash_bwd_dq_f32": 0, "flash_bwd_dkv_f32": 0,
                 "flash_bwd_dq_simt": 0, "flash_bwd_dkv_simt": 0,
                 "flash_fwd_tc": 24, "flash_fwd_f32": 0,
                 "flash_fwd_split": 0, "flash_fwd_simt": 0}
    if gate != want_gate:
        raise AssertionError(f"bf16 gate launches {gate}, not {want_gate}")

    # the bench row: bf16 net, SPMDTrainer SGD lr 1e-4 momentum 0.9
    _reset_launches(fa)
    st = parallel.SPMDTrainer(net, lm_loss, "sgd",
                              {"learning_rate": 1e-4, "momentum": 0.9})
    for _ in range(3):
        st.step(x, y)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = 10
    t0 = time.perf_counter()
    bf16_losses = [st.step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(dev)
    backward_passes += 3 + steps
    if not all(torch.isfinite(v) for v in bf16_losses):
        raise AssertionError("bf16 SPMDTrainer loss not finite")
    tokens_s = b * t / (step_ms / 1e3)
    print(f"bf16 SPMDTrainer step (B={b}, T={t}, sgd lr 1e-4 momentum 0.9; "
          f"{card}): {step_ms:.3f} ms per step (host clock, {steps} steps "
          f"after 3 warmup), {tokens_s:.1f} tokens/s, peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    rows = _profile_step(st.step, x, y, card, step_ms)
    backward_passes += 1
    bf16_passes = backward_passes - fp32_passes
    window = _read_launches(fa)
    launches = {name: launches[name] + window[name] for name in COUNTERS}
    window = _read_routes(fa)
    routes = {name: routes[name] + window[name] for name in ROUTE_COUNTERS}

    # one forward and one backward per pass, each through the 12 layers;
    # every fp32 pass on the f32 K4, K5 and K6, every bf16 pass on the
    # tensor-core ones
    want = 12 * backward_passes
    print(f"launches on the training path: {launches} over "
          f"{backward_passes} backward passes (12 x {backward_passes} = "
          f"{want} each); by route {routes} ({fp32_passes} fp32 passes "
          f"on f32 K4/K5/K6, {bf16_passes} bf16 on tc)",
          flush=True)
    for name in COUNTERS:
        if launches[name] != want:
            raise AssertionError(f"training launched {name} "
                                 f"{launches[name]} times, not {want}")
    want_routes = training_routes(fp32_passes, bf16_passes, t=t)
    if routes != want_routes:
        raise AssertionError(f"training launched by route {routes}, not "
                             f"{want_routes}")
    return dict(launches=launches, routes=routes, gate_launches=gate,
                decode_launches=decode_launches,
                decode_routes=decode_routes_got,
                backward_passes=backward_passes, grad_worst_rel=worst,
                bf16_grad_worst_rel=bf16_worst,
                learning_losses=losses, step_ms=step_ms, tokens_s=tokens_s,
                peak_bytes=peak, profile=rows[:14])

# ---------------------------------------------------------------------------
# BERT phase: BERT-base pretraining (bench.py's bert row), the path through
# K4-K6 with no causal mask and per-sample key lengths
# ---------------------------------------------------------------------------
# (oracle B, T, bench B) of the phase: the oracle and checks at B=8, the
# bench rows at bench.py's B=24, T=128
BERT_SIZES = (8, 128, 24)
# eval outputs through the kernels against the plain versions' (fp32):
# relative L2 per output (only the order of sums differs)
BERT_EVAL_RTOL = 1e-4
BERT_OUTPUTS = ("seq", "pooled", "mlm", "nsp")


def bert_pretrain_loss(ce):
    """bench.py's BERT objective (``bench.py:471-473``): MLM cross entropy
    plus NSP cross entropy, each a mean."""
    def loss(seq, pooled, mlm_scores, nsp_scores, mlm_y, nsp_y):
        return ce(mlm_scores, mlm_y).mean() + ce(nsp_scores, nsp_y).mean()

    return loss


def bert_batch(rs, b, t, vocab, dev, lengths, mixed_segments=True):
    """``([tokens, segments, valid_length], [mlm labels, nsp labels])`` on
    ``dev``: segments 0 then 1 from a point drawn per sample (zeros unless
    ``mixed_segments``), ``lengths`` as given."""
    tok = rs.randint(0, vocab, (b, t)).astype(np.int32)
    split = rs.randint(1, t, (b, 1)) if mixed_segments else t
    seg = (np.arange(t)[None, :] >= split).astype(np.int32)
    mlm = rs.randint(0, vocab, (b, t)).astype(np.float32)
    nsp = rs.randint(0, 2, (b,)).astype(np.float32)
    to = functools.partial(torch.as_tensor, device=dev)
    return ([to(tok), to(seg), to(np.asarray(lengths, np.int32))],
            [to(mlm), to(nsp)])


def set_attention_impl(net, impl):
    """Every ``MultiHeadAttention`` of ``net`` on ``impl`` ("pallas": K4-K6,
    "xla": the dense chain), the weights kept."""
    from incubator_mxnet_tpu_torch.models import MultiHeadAttention

    for m in net.modules():
        if isinstance(m, MultiHeadAttention):
            m._impl = impl


def _check_flash_launches(label, launches, routes, want, want_routes):
    """The flash counters of a window: ``want`` by kernel, ``want_routes``
    by route."""
    print(f"launches on {label}: {launches}; by route {routes}", flush=True)
    if launches != want or routes != want_routes:
        raise AssertionError(f"{label} launched {launches} by route "
                             f"{routes}, not {want} by route {want_routes}")


def bert_phase(seed, card, net, ctx, sizes=BERT_SIZES):
    """The BERT phase on ``net`` (a ``BERTModel`` with its four heads,
    ``attention_impl="pallas"``, dropout 0, fp32, initialized on ``ctx``):
    the fp32 gradient oracle (every trainable tensor through K4-K6 against
    the autograd of the plain forward), eval against the plain versions,
    float ``valid_length`` bit-equal to int32, padding independence, a
    learning check (fp32 ``SPMDTrainer``), two eager ``gluon.Trainer``
    steps, ``mx.nd.invoke_op("flash_attention", ...)`` with lengths, the
    bf16 gradient gate (tensor-core K5/K6 against their plain version),
    then bench.py's bert row in bf16 (``SPMDTrainer`` SGD lr 1e-4
    momentum 0.9, ``valid_length`` = T) with ``attention_impl="pallas"``,
    with ``"xla"`` (the dense chain) and with pallas on the seeded mixed
    lengths, each timed and profiled. K4, K5 and K6 launch once a layer a
    pass: fp32 passes on f32, bf16 on tc, none on SIMT; the xla row none."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.models import MultiHeadAttention
    from incubator_mxnet_tpu_torch.models import transformer
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    b, t, b_bench = sizes
    dev = ctx.torch_device()
    vocab = net.word_embed.weight.shape[0]
    cells = [m for m in net.modules() if isinstance(m, MultiHeadAttention)]
    layers, h = len(cells), cells[0]._heads
    d = cells[0]._units // h
    loss = bert_pretrain_loss(gluon.loss.SoftmaxCrossEntropyLoss())
    lens = bert_lengths(seed, b, t)
    data, labels = bert_batch(np.random.RandomState(seed + 97), b, t, vocab,
                              dev, lens)
    tok, seg, vl = data
    print(f"BERT phase: {layers} layers, {len(list(net.parameters()))} "
          f"parameter tensors, B={b}, T={t}, valid_length "
          f"{lens.tolist()}", flush=True)

    # the fp32 window: counts set to 0 just before the oracle and read just
    # after the eager steps
    _reset_launches(fa)
    worst = gradient_oracle(net, loss, data, labels, module=transformer)
    fp32_passes, fwd_only = 1, 0

    # eval: the kernels against the plain versions; a float valid_length;
    # every token at or beyond a sample's length changed
    pad = torch.arange(t, device=dev)[None, :] >= vl[:, None].long()
    with torch.no_grad():
        got = net(*data)
        with swap_attention(transformer):
            want = net(*data)
        as_float = net(tok, seg, vl.float())
        padded = net(torch.where(pad, (tok + 1) % vocab, tok),
                     torch.where(pad, 1 - seg, seg), vl)
    fwd_only += 3
    eval_worst = _worst_rel(zip(BERT_OUTPUTS, got, want))
    float_equal = all(torch.equal(x, y) for x, y in zip(got, as_float))
    keep = ~pad
    pad_equal = torch.equal(got[0][keep], padded[0][keep])
    print(f"BERT eval (fp32, no_grad): outputs {BERT_OUTPUTS} against the "
          f"plain versions, worst relative L2 {eval_worst[0]:.3e} "
          f"({eval_worst[1]}), tolerance {BERT_EVAL_RTOL:g}; float32 "
          f"valid_length {'bit-equal' if float_equal else 'NOT equal'} to "
          f"int32; padding changed: seq_out at the {int(keep.sum())} valid "
          f"positions {'bit-equal' if pad_equal else 'CHANGED'}", flush=True)
    if not eval_worst[0] <= BERT_EVAL_RTOL:
        raise AssertionError(f"BERT eval: {eval_worst}")
    if not float_equal:
        raise AssertionError("BERT: a float32 valid_length differs from the "
                             "int32 one")
    if not pad_equal:
        raise AssertionError("BERT: padding reached the valid positions")
    del got, want, as_float, padded

    # learning check: the loss on one repeated batch falls; adam at BERT's
    # published peak rate, 1e-4 (at 3e-4 the post-norm net's first steps
    # overshoot: over seeds 0-2 the loss fell 2.8-15% in 10 steps, at 1e-4
    # 6.8-13.9%, PERF.md)
    st = parallel.SPMDTrainer(net, loss, "adam", {"learning_rate": 1e-4})
    losses = [float(st.step(data, labels)) for _ in range(10)]
    fp32_passes += 10
    print(f"BERT learning check (fp32 SPMDTrainer, adam lr 1e-4, one batch "
          f"repeated): losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("the BERT loss did not fall by 5% over 10 "
                             "steps")
    st.sync_to_net()
    del st

    # the eager entry point: record -> backward -> step
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 1e-4, "momentum": 0.9})
    eager = []
    for _ in range(2):
        with mx.autograd.record():
            step_loss = loss(*net(*data), *labels)
        mx.autograd.backward(step_loss)
        trainer.step(1)
        eager.append(float(step_loss.detach()))
    fp32_passes += 2
    if not all(math.isfinite(v) for v in eager):
        raise AssertionError(f"BERT gluon.Trainer losses not finite: {eager}")
    print(f"BERT gluon.Trainer (fp32, sgd lr 1e-4 momentum 0.9): 2 steps, "
          f"losses {eager}", flush=True)
    launches, routes = _read_launches(fa), _read_routes(fa)
    want_routes = training_routes(fp32_passes, 0, layers, t, d)
    want_routes["flash_fwd_" + fwd_route_expected(t, d, torch.float32)] += \
        layers * fwd_only
    _check_flash_launches(
        f"the BERT fp32 path ({fp32_passes} training passes, {fwd_only} "
        f"forwards)", launches, routes,
        {"flash_fwd": layers * (fp32_passes + fwd_only),
         "flash_bwd_dq": layers * fp32_passes,
         "flash_bwd_dkv": layers * fp32_passes}, want_routes)

    # mx.nd's string dispatch with lengths, int32 and float32, bit-equal to
    # the direct call (launches read on their own)
    qkv = [mx.nd.NDArray(torch.randn(b, h, t, d, device=dev))
           for _ in range(3)]
    before = fa.flash_fwd_launches
    for lengths in (vl, vl.float()):
        nd_out = mx.nd.invoke_op("flash_attention", *qkv,
                                 mx.nd.NDArray(lengths))
        direct = fa.flash_attention(*(a._data for a in qkv), vl)
        if not torch.equal(nd_out._data, direct):
            raise AssertionError(f"invoke_op('flash_attention') with "
                                 f"{lengths.dtype} lengths differs from the "
                                 "direct call")
    invoke_launches = fa.flash_fwd_launches - before
    if dev.type == "cuda" and invoke_launches != 4:
        raise AssertionError(f"invoke_op with lengths: {invoke_launches} "
                             "K4 launches, not 4")
    print(f"mx.nd.invoke_op('flash_attention', q, k, v, lengths) with int32 "
          f"and float32 lengths: bit-equal to the direct call, "
          f"{invoke_launches} K4 launches (2 through mx.nd)", flush=True)
    del qkv, nd_out, direct

    # the bf16 gradient gate, read on its own: one pass through the
    # tensor-core K5/K6, one through their plain version (K4 in both)
    net.cast("bfloat16")
    _reset_launches(fa)
    bf16_worst = gpt_bf16_gate(net, loss, data, labels)
    gate, gate_routes = _read_launches(fa), _read_routes(fa)
    want_gate_routes = training_routes(0, 1, layers, t, d)
    want_gate_routes["flash_fwd_tc"] = 2 * layers
    _check_flash_launches("the BERT bf16 gate", gate, gate_routes,
                          {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
                           "flash_bwd_dkv": layers}, want_gate_routes)

    # bench.py's bert row: bf16, B=24, T=128, segments 0, valid_length = T,
    # SGD lr 1e-4 momentum 0.9; pallas (K4-K6), xla (the dense chain), and
    # pallas on the seeded mixed lengths
    full = np.full((b_bench,), t, np.int32)
    rows = {}
    for row, impl, lengths in (
            ("pallas", "pallas", full), ("xla", "xla", full),
            ("pallas_mixed_lengths", "pallas",
             bert_lengths(seed, b_bench, t))):
        bdata, blabels = bert_batch(np.random.RandomState(seed + 98),
                                    b_bench, t, vocab, dev, lengths,
                                    mixed_segments=False)
        set_attention_impl(net, impl)
        _reset_launches(fa)
        st = parallel.SPMDTrainer(net, loss, "sgd",
                                  {"learning_rate": 1e-4, "momentum": 0.9})
        step_ms, peak, blosses = _bench_steps(st, bdata, blabels, steps=10,
                                              warmup=3)
        seq_s = b_bench / step_ms * 1e3
        print(f"BERT bf16 SPMDTrainer step, {row} (B={b_bench}, T={t}, sgd "
              f"lr 1e-4 momentum 0.9; {card}): {step_ms:.4f} ms per step "
              f"(host clock, 10 steps after 3 warmup), {seq_s:.1f} "
              f"sequences/s, peak memory {peak / 2**20:.1f} MiB", flush=True)
        prof = _profile_step(st.step, bdata, blabels, card, step_ms,
                             top=14 if row == "pallas" else 6,
                             what=f"BERT bf16 step ({row})")
        device = sum(r[0] for r in prof)
        # cuBLAS's GEMMs on vectors of 1, 2 or 4 elements (CUTLASS names
        # them align1/2/4): the MLM head's, whose vocabulary is not a
        # multiple of 8
        unaligned = sum(r[0] for r in prof
                        if re.search(r"_align[124]\b", r[2]))
        if device:
            print(f"  cuBLAS GEMMs on unaligned vectors (align1/2/4; the MLM "
                  f"head's vocabulary {vocab} is not a multiple of 8): "
                  f"{unaligned:.3f} ms, {100 * unaligned / device:.1f}% of "
                  f"device time", flush=True)
        passes = 3 + 10 + 1
        per_pass = 0 if impl == "xla" else layers
        window, window_routes = _read_launches(fa), _read_routes(fa)
        _check_flash_launches(
            f"the BERT {row} row ({passes} bf16 passes)", window,
            window_routes, dict.fromkeys(COUNTERS, per_pass * passes),
            training_routes(0, passes, per_pass, t, d))
        launches = {n: launches[n] + window[n] for n in COUNTERS}
        routes = {n: routes[n] + window_routes[n] for n in ROUTE_COUNTERS}
        rows[row] = dict(batch=b_bench, t=t, step_ms=step_ms,
                         sequences_s=seq_s, peak_bytes=peak,
                         idle=_idle(prof, step_ms), device_ms=device,
                         unaligned_gemm_ms=unaligned, losses=blosses,
                         valid_length=lengths.tolist(), profile=prof[:14])
        del st, bdata, blabels
        gc.collect()
    set_attention_impl(net, "pallas")
    return dict(launches=launches, routes=routes,
                gate_launches={**gate, **gate_routes}, layers=layers,
                grad_worst_rel=worst, eval_worst_rel=eval_worst[0],
                float_lengths_equal=float_equal, padding_equal=pad_equal,
                learning_losses=losses, bf16_grad_worst_rel=bf16_worst,
                rows=rows, invoke_launches=invoke_launches)


def bert_main(seed, card):
    """The BERT phase on ``get_bert("bert_12_768_12", vocab_size=30522,
    max_length=512, attention_impl="pallas")``, dropout 0: 207 parameter
    tensors, 133,547,324 values; then the mx.nd 1.x phase on the same net,
    in fp32 and drawn again from the seed (its result under
    ``"nd1x"``), and the sparse phase, drawn again (under
    ``"sparse"``)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.models import get_bert

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    t0 = time.perf_counter()
    net = get_bert("bert_12_768_12", vocab_size=30522, max_length=512,
                   dropout=0.0, attention_impl="pallas").initialize(
                       "xavier", ctx=ctx)
    counts = (len(list(net.parameters())),
              sum(p.numel() for p in net.parameters()))
    print(f"model bert_12_768_12: {counts[0]} parameter tensors, "
          f"{counts[1]} values, drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if counts != (207, 133_547_324):
        raise AssertionError(f"bert_12_768_12's inventory {counts}")
    out = bert_phase(seed, card, net, ctx)
    gc.collect()
    # the same net drawn again from the seed, in fp32: after the phase's
    # training its top layers' query and key gradients lie below fp32's
    # noise (every fp32 path far from an fp64 pass), so the oracle starts
    # where the BERT phase's does
    mx.random.seed(seed)
    net.cast("float32").initialize("xavier", ctx=ctx, force_reinit=True)
    out["nd1x"] = nd1x_phase(seed, card, net, ctx)
    if out["nd1x"]["n_params"] != 207:
        raise AssertionError("bert_12_768_12 has 207 trainable tensors")
    gc.collect()
    # drawn again from the seed for the sparse phase (its word embedding
    # row-sparse)
    mx.random.seed(seed)
    net.initialize("xavier", ctx=ctx, force_reinit=True)
    out["sparse"] = sparse_phase(seed, card, net, ctx)
    return out


# ---------------------------------------------------------------------------
# conv kernel phase
# ---------------------------------------------------------------------------
# (name, n, h, w, ci, co, k, stride, pad, kind): kind "plain" has no
# prologue, "pro" the BatchNorm prologue + ReLU, "res" also the residual
# join and the emitted activation. The first six are ResNet-50's at B=32;
# the last lies off the model's path (5x5, odd H, widths not multiples of
# 8 or 16).
CONV_CASES = [
    ("1x1_64to64_56_plain", 32, 56, 56, 64, 64, 1, 1, 0, "plain"),
    ("3x3_64to64_56_pro", 32, 56, 56, 64, 64, 3, 1, 1, "pro"),
    ("3x3_s2_128_56to28_pro", 32, 56, 56, 128, 128, 3, 2, 1, "pro"),
    ("1x1_256to64_56_join_emit", 32, 56, 56, 256, 64, 1, 1, 0, "res"),
    ("1x1_s2_512to1024_28to14_plain", 32, 28, 28, 512, 1024, 1, 2, 0,
     "plain"),
    ("3x3_512to512_7_pro", 32, 7, 7, 512, 512, 3, 1, 1, "pro"),
    ("5x5_s2_24to40_15_res_emit", 32, 15, 15, 24, 40, 5, 2, 2, "res"),
]
CONV_HEAD = "3x3_64to64_56_pro"
# K1 alone at the serving shapes: ResNet-50's eval forward behind the
# ModelServer at its smallest bucket, B=1 (B=32, its largest, is above), at
# the head case and the last stage (7x7: 49 rows a launch at B=1)
SERVING_CONV_CASES = [
    ("3x3_64to64_56_pro_B1", 1, 56, 56, 64, 64, 3, 1, 1, "pro"),
    ("3x3_512to512_7_pro_B1", 1, 7, 7, 512, 512, 3, 1, 1, "pro"),
]
CONV_KERNELS = ("fused_conv", "conv_bwd_dx", "conv_bwd_dw")
# the conv kernels' routes (ops/fused_conv.conv_route): "tc" the bf16
# tensor-core kernels (csrc/fused_conv_tc.cu, csrc/conv_bwd_tc.cu), "f32"
# the fp32 micro-tile kernels (csrc/fused_conv_f32.cu,
# csrc/conv_bwd_f32.cu), "simt" csrc/fused_conv.cu and csrc/conv_bwd.cu
ROUTED = ("fused_conv", "conv_bwd_dx", "conv_bwd_dw")
# fp32 per-channel sums and dW: relative L2 error, kernels vs plain
CONV_L2_TOL = 1e-4
# the tensor-core K1's per-channel sums and sums of squares at the head
# case: relative L2 error from an fp64 evaluation on the same bf16 inputs
# (the port holds its fp32 running statistics to the JAX package's at
# 1e-5; the tensor cores' fp32 accumulation leans about 5e-7 there)
K1_SUMS_RTOL = 1e-5


def _conv_dims(case):
    _, n, h, w, ci, co, k, stride, pad, kind = case
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return n, h, w, ci, co, k, stride, pad, kind, ho, wo


def conv_bound(kernel, case, dtype):
    """Least time (ms) of one conv kernel call and what bounds it: 2 FLOPs
    per multiply-add (2*N*Ho*Wo*Ci*Co*kh*kw, the same for all three) at
    the peak of the inputs' type; each input read once and each output
    written once (activations and weights in the type, per-channel
    vectors fp32)."""
    n, h, w, ci, co, k, _, _, kind, ho, wo = _conv_dims(case)
    es = torch.tensor([], dtype=dtype).element_size()
    xb, yb, wb = n * h * w * ci * es, n * ho * wo * co * es, k * k * ci * co * es
    pro, res = kind != "plain", kind == "res"
    if kernel == "fused_conv":      # x [r] w a b [ar br] -> y s ss [xp]
        nbytes = xb * (1 + 2 * res) + wb + yb + 8 * co + 8 * ci * (pro + res)
    elif kernel == "conv_bwd_dx":   # dy y x w ds dss a b [r ar br g] -> dx da db [dr dar]
        nbytes = 2 * yb + 2 * xb + wb + 8 * co + 16 * ci * pro \
            + xb * 3 * res + 12 * ci * res
    else:                           # x [r] dy y ds dss a b [ar br] -> dw
        nbytes = xb * (1 + res) + 2 * yb + wb + 8 * co + 8 * ci * (pro + res)
    flops = 2.0 * n * ho * wo * ci * co * k * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _conv_inputs(case, dtype, dev, gen):
    n, h, w, ci, co, k, _, _, kind, ho, wo = _conv_dims(case)

    def rnd(*shape, scale=1.0, shift=0.0, uniform=False):
        t = torch.rand(shape, generator=gen, device=dev) if uniform else \
            torch.randn(shape, generator=gen, device=dev)
        return t * scale + shift

    t = dict(x=rnd(n, h, w, ci).to(dtype),
             w=rnd(k, k, ci, co, scale=1 / math.sqrt(k * k * ci)).to(dtype),
             dy=rnd(n, ho, wo, co).to(dtype), ds=rnd(co, scale=0.1),
             dss=rnd(co, scale=0.01))
    if kind != "plain":
        t.update(a=rnd(ci, shift=0.5, uniform=True), b=rnd(ci, scale=0.5))
    if kind == "res":
        t.update(r=rnd(n, h, w, ci).to(dtype),
                 ar=rnd(ci, shift=0.5, uniform=True), br=rnd(ci, scale=0.5),
                 g=rnd(n, h, w, ci).to(dtype))
    return t


def _conv_errs(names, got, want, dtype):
    """Max abs error over max(1, max|plain|) of each output (and, fp32,
    the relative L2 error of the per-channel sums and dW); raises past
    the tolerances. Returns (max abs error, worst relative error)."""
    worst_abs, worst_rel = 0.0, 0.0
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: shape {tuple(g.shape)} or "
                                 "non-finite values")
        err = (g - w).abs().max().item()
        rel = err / max(1.0, w.abs().max().item())
        if rel > TOLS[dtype]:
            raise AssertionError(f"{name} {DTYPE_NAMES[dtype]}: max abs err "
                                 f"{err} > {TOLS[dtype]} x max(1, max|plain|)")
        if dtype == torch.float32 and (w.dim() == 1 or name == "dw"):
            l2 = (g - w).norm().item() / max(w.norm().item(), 1e-30)
            if l2 > CONV_L2_TOL:
                raise AssertionError(f"{name}: relative L2 {l2} > "
                                     f"{CONV_L2_TOL}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


def _route_launches():
    """{(kernel, route): launches} of the three conv kernels."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    return {(k, r): getattr(fc, f"{k}_{r}_launches") for k in ROUTED
            for r in CONV_ROUTES[k]}


def conv_routes_expected(dtype):
    """{kernel: route} of ResNet-50's convs in ``dtype``, as
    ``fused_conv.conv_route`` gives them for its widths (multiples of 8)
    and the model's operands (16-byte aligned): bf16 every kernel on the
    tensor cores, fp32 every kernel on f32."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    return {kernel: fc.conv_route(dtype, 64, 64, kernel)
            for kernel in ROUTED}


def _route_taken(before, kernel):
    """The route ``kernel`` took since ``before`` (one launch)."""
    now = _route_launches()
    taken = [r for r in CONV_ROUTES[kernel]
             if now[kernel, r] - before[kernel, r] == 1]
    if len(taken) != 1:
        raise AssertionError(f"{kernel}: launches by route {now} after "
                             f"{before}: not one launch")
    return taken[0]


def k1_sums_fp64(x, w, a=None, b=None, stride=1, pad=0, relu=True, r=None,
                 ar=None, br=None):
    """K1's per-channel sum and sum of squares as the plain version takes
    them, with the prologue output rounded to the input type as the kernels
    round it, and the conv and the sums in fp64."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    xp = fc.apply_prologue(x, a, b, r, ar, br, relu)
    acc = fc._nhwc(F.conv2d(fc._nchw(xp.double()), fc._oihw(w.double()),
                            stride=stride, padding=pad))
    return acc.sum(dim=(0, 1, 2)), (acc * acc).sum(dim=(0, 1, 2))


def conv_kernel_phase(seed):
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    results = []
    for case, kernels in [(c, CONV_KERNELS) for c in CONV_CASES] \
            + [(c, ("fused_conv",)) for c in SERVING_CONV_CASES]:
        name = case[0]
        n, h, w, ci, co, k, stride, pad, kind, ho, wo = _conv_dims(case)
        res = kind == "res"
        for dtype in (torch.float32, torch.bfloat16):
            t = _conv_inputs(case, dtype, dev, gen)
            rkw = dict(r=t.get("r"), ar=t.get("ar"), br=t.get("br"))
            fargs = (t["x"], t["w"], t.get("a"), t.get("b"), stride, pad,
                     True)
            want_f = fc.fused_conv_reference(*fargs, emit=res, **rkw)
            bargs = fargs[:4] + (want_f[0], t["dy"], t["ds"], t["dss"],
                                 stride, pad, True)
            calls = {
                "fused_conv": (
                    lambda: fc.fused_conv(*fargs, emit=res, **rkw),
                    lambda: fc.fused_conv_reference(*fargs, emit=res,
                                                    **rkw),
                    ("y", "sum", "sumsq", "emitted")),
                "conv_bwd_dx": (
                    lambda: fc.conv_bwd_dx(*bargs, g=t.get("g"), **rkw),
                    lambda: fc.conv_bwd_dx_reference(*bargs, g=t.get("g"),
                                                     **rkw),
                    ("dx", "da", "db", "dr", "dar")),
                "conv_bwd_dw": (
                    lambda: (fc.conv_bwd_dw(*bargs, **rkw),),
                    lambda: (fc.conv_bwd_dw_reference(*bargs, **rkw),),
                    ("dw",)),
            }
            # cuDNN on channels-last tensors: timed only, never used by
            # the port
            x_cl, dy_cl = t["x"].permute(0, 3, 1, 2), t["dy"].permute(
                0, 3, 1, 2)
            w_cl = t["w"].permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            conv_args = ([stride] * 2, [pad] * 2, [1, 1], False, [0, 0], 1)
            library = {
                "fused_conv": lambda: F.conv2d(x_cl, w_cl, stride=stride,
                                               padding=pad),
                "conv_bwd_dx": lambda: torch.ops.aten.convolution_backward(
                    dy_cl, x_cl, w_cl, None, *conv_args,
                    [True, False, False]),
                "conv_bwd_dw": lambda: torch.ops.aten.convolution_backward(
                    dy_cl, x_cl, w_cl, None, *conv_args,
                    [False, True, False]),
            }
            # the SIMT kernels on the same inputs, timed beside the
            # route the rule takes
            simt = {
                "fused_conv": lambda: fc.fused_conv(
                    *fargs, emit=res, route="simt", **rkw),
                "conv_bwd_dx": lambda: fc.conv_bwd_dx(
                    *bargs, g=t.get("g"), route="simt", **rkw),
                "conv_bwd_dw": lambda: (fc.conv_bwd_dw(*bargs, route="simt",
                                                       **rkw),),
            }
            for kernel in kernels:
                launch, plain, names = calls[kernel]
                before = _route_launches()
                got, want = launch(), plain()
                torch.cuda.synchronize()
                route = None
                if kernel in ROUTED:
                    route = _route_taken(before, kernel)
                    expect = fc.conv_route(dtype, ci, co, kernel)
                    if route != expect:
                        raise AssertionError(f"{kernel} {name} "
                                             f"{DTYPE_NAMES[dtype]} took "
                                             f"{route}, not {expect}")
                err, rel = _conv_errs(names, got, want, dtype)
                sums_l2 = None
                if kernel == "fused_conv" and route == "tc" \
                        and name == CONV_HEAD:
                    exact = k1_sums_fp64(*fargs, **rkw)
                    sums_l2 = [((g.double() - e).norm() / e.norm()).item()
                               for g, e in zip(got[1:3], exact)]
                    print(f"K1 sums guard {name} bf16 route tc: relative L2 "
                          f"from fp64 sum {sums_l2[0]:.3e}, sumsq "
                          f"{sums_l2[1]:.3e} (tol {K1_SUMS_RTOL:g})",
                          flush=True)
                    if not all(math.isfinite(v) and v <= K1_SUMS_RTOL
                               for v in sums_l2):
                        raise AssertionError(f"K1 sums guard: {sums_l2} > "
                                             f"{K1_SUMS_RTOL}")
                simt_err = None
                if route == "f32":
                    again, by_simt = launch(), simt[kernel]()
                    if not all(a is None and b is None or torch.equal(a, b)
                               for a, b in zip(got, again)):
                        raise AssertionError(f"{kernel} {name} f32: a "
                                             "second launch differs")
                    # the f32 K1 gives the SIMT K1's bits (y and the sums)
                    if kernel == "fused_conv" and not all(
                            torch.equal(a, b) for a, b in zip(got, by_simt)):
                        raise AssertionError(f"fused_conv {name} f32: not "
                                             "the SIMT kernel's bits")
                    simt_err = _conv_errs(names, by_simt, want, dtype)
                    del again, by_simt
                ms = device_ms(launch)
                plain_ms = device_ms(plain)
                library_ms = device_ms(library[kernel])
                simt_ms = device_ms(simt[kernel]) if route != "simt" \
                    else None
                bound_ms, bound_by = conv_bound(kernel, case, dtype)
                r = dict(kernel=kernel, case=name, dtype=DTYPE_NAMES[dtype],
                         route=route, max_abs_err=err, err_over_max_ref=rel,
                         tol=TOLS[dtype], ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, simt_ms=simt_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
                if sums_l2 is not None:
                    r["sums_rel_l2_fp64"] = sums_l2
                results.append(r)
                if simt_err is not None:    # the SIMT K2: a row of its own
                    results.append(dict(r, route="simt", ms=simt_ms,
                                        max_abs_err=simt_err[0],
                                        err_over_max_ref=simt_err[1],
                                        simt_ms=None))
                also = "" if simt_ms is None else \
                    f" simt_ms={simt_ms:.5f} (SIMT kernel)"
                print(f"kernel {kernel} {name} {r['dtype']}"
                      f"{'' if route is None else ' route ' + route}: "
                      f"max_abs_err={err:.3e} ({rel:.2e} of max|plain|, tol "
                      f"{TOLS[dtype]:g}) ms={ms:.5f} (device, CUDA graph) "
                      f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f}"
                      f" (cuDNN){also} bound_ms={bound_ms:.5f} "
                      f"({bound_by})", flush=True)
            del t, want_f, calls, library, simt
            gc.collect()
    return results


# ---------------------------------------------------------------------------
# ResNet phase
# ---------------------------------------------------------------------------
def _plain_fused_conv_bn(x, w, a=None, b=None, stride=1, pad=0, relu=True,
                         resid=None, resid_scale=None, resid_shift=None,
                         emit_act=False):
    """``fused_conv_bn`` through the autograd of the plain forward (dense
    PyTorch, fp32 inside), with its argument defaults: the oracle."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    if resid is not None:
        a, b, resid_scale, resid_shift = fc.join_defaults(
            x, a, b, resid_scale, resid_shift)
    return fc.fused_conv_reference(x, w, a, b, stride, pad, relu, resid,
                                   resid_scale, resid_shift, emit=emit_act)


class _PlainBackward(torch.autograd.Function):
    """K1's forward values with the autograd of the plain forward as their
    gradient: the gradient oracle's reference, which follows the kernels'
    forward trajectory (the same ReLU masks and batch statistics), so the
    comparison sees K2, K3 and the autograd wiring and nothing else."""

    @staticmethod
    def forward(ctx, x, w, a, b, r, ar, br, stride, pad, relu, emit):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        ctx.save_for_backward(x, w, a, b, r, ar, br)
        ctx.conf = (stride, pad, relu, emit)
        return fc.fused_conv(x, w, a, b, stride, pad, relu, r, ar, br, emit)

    @staticmethod
    def backward(ctx, *cts):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        stride, pad, relu, emit = ctx.conf
        ins = [None if t is None else t.detach().requires_grad_(True)
               for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = fc.fused_conv_reference(*ins[:4], stride, pad, relu,
                                           *ins[4:], emit)
        grads = iter(torch.autograd.grad(
            outs, [t for t in ins if t is not None], cts, allow_unused=True))
        return tuple(None if t is None else next(grads) for t in ins) \
            + (None,) * 4


def _pinned_fused_conv_bn(x, w, a=None, b=None, stride=1, pad=0, relu=True,
                          resid=None, resid_scale=None, resid_shift=None,
                          emit_act=False):
    """``fused_conv_bn`` with K1's values and the plain backward."""
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    if resid is not None:
        a, b, resid_scale, resid_shift = fc.join_defaults(
            x, a, b, resid_scale, resid_shift)
    return _PlainBackward.apply(x, w, a, b, resid, resid_scale, resid_shift,
                                stride, pad, relu, emit_act)


class swap_convs:
    """``with swap_convs(fn):`` the fused ResNet calls ``fn`` in place of
    ``fused_conv_bn`` (the swap is made here, for the oracles only)."""

    def __init__(self, fn):
        self._fn = fn

    def __enter__(self):
        from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
            fused_resnet
        self._mod = fused_resnet
        self._saved = fused_resnet.fused_conv_bn
        fused_resnet.fused_conv_bn = self._fn
        return self

    def __exit__(self, *exc):
        self._mod.fused_conv_bn = self._saved


def _conv_launches():
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    return {k: getattr(fc, k + "_launches") for k in CONV_KERNELS}


def _reset_conv_launches():
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    for k in CONV_KERNELS:
        setattr(fc, k + "_launches", 0)
    for k in ROUTED:
        for r in CONV_ROUTES[k]:
            setattr(fc, f"{k}_{r}_launches", 0)


def _check_launches(label, got, per_pass, forwards, backwards, routes=None,
                    route=None):
    """The window's launches against ``per_pass`` per forward and per
    backward; with ``route`` (one route, or {kernel: route}), every launch
    in ``routes`` (from ``_route_launches``) took that route."""
    want = {"fused_conv": per_pass * forwards,
            "conv_bwd_dx": per_pass * backwards,
            "conv_bwd_dw": per_pass * backwards}
    print(f"{label}: launches {got} over {forwards} forwards and "
          f"{backwards} backwards ({per_pass} each per pass: {want})"
          + ("" if route is None else f", by route {routes}"), flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")
    if route is not None:
        if isinstance(route, str):
            route = dict.fromkeys(ROUTED, route)
        want_r = {(k, r): want[k] if r == route[k] else 0 for k in ROUTED
                  for r in CONV_ROUTES[k]}
        if routes != want_r:
            raise AssertionError(f"{label}: launches by route {routes} != "
                                 f"{want_r}")


def convs_per_pass(net):
    """Fused convs in one forward: three per bottleneck, one more per
    downsample projection (52 for ResNet-50)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        FusedBottleneckV1

    blocks = [m for m in net.modules() if isinstance(m, FusedBottleneckV1)]
    return sum(3 + (b.bnd is not None) for b in blocks)


def _frozen(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()
            if not p.requires_grad}


def resnet_oracle(net, ce, x, y):
    """The fp32 oracle of one training step from one state, three runs:
    the kernels; the model with ``fused_conv_bn`` swapped for the autograd
    of its plain versions (loss and the running statistics after the
    forward: 1e-5); and the plain backward on K1's forward values (every
    trainable tensor's gradient: relative L2 <= GRAD_RTOL). The kernels'
    gradients against the fully plain run's are printed, not held: the two
    forwards sum in other orders, and this fp32 network at its initial
    weights turns such differences into percents of the gradients of the
    early layers."""
    def loss_fn(logits, labels):
        return ce(logits, labels).mean()

    start = _frozen(net)

    def run(fn):
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n in start:
                    p.copy_(start[n])
        if fn is None:
            return _grads(net, loss_fn, x, y), _frozen(net)
        with swap_convs(fn):
            return _grads(net, loss_fn, x, y), _frozen(net)

    _reset_conv_launches()
    (loss, grads), stats = run(None)
    launches, routes = _conv_launches(), _route_launches()
    (ref_loss, plain_grads), ref_stats = run(_plain_fused_conv_bn)
    (_, ref_grads), _ = run(_pinned_fused_conv_bn)
    _check_launches("gradient oracle (kernel run)", launches,
                    convs_per_pass(net), 1, 1, routes,
                    conv_routes_expected(torch.float32))
    if not torch.isfinite(loss) or abs(float(loss - ref_loss)) > \
            1e-5 * abs(float(ref_loss)):
        raise AssertionError(f"oracle loss {float(loss)} != plain "
                             f"{float(ref_loss)}")
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    worst, worst_plain = (0.0, ""), (0.0, "")
    for name, g, r, q in zip(names, grads, ref_grads, plain_grads):
        rel = _rel_l2(g, r)
        if not math.isfinite(rel) or rel > GRAD_RTOL:
            raise AssertionError(f"gradient oracle: {name} relative L2 "
                                 f"error {rel} > {GRAD_RTOL}")
        worst = max(worst, (rel, name))
        worst_plain = max(worst_plain, (_rel_l2(g, q), name))
    worst_stat = (0.0, "")
    for name, v in stats.items():
        r = ref_stats[name]
        err = (v - r).abs().max().item() / max(1.0, r.abs().max().item())
        if not err <= 1e-5:
            raise AssertionError(f"running statistic {name}: error {err}")
        worst_stat = max(worst_stat, (err, name))
    print(f"gradient oracle (fp32, B={x.shape[0]}, {len(names)} trainable "
          f"tensors, {len(stats)} running statistics): loss "
          f"{float(loss):.6f} vs plain {float(ref_loss):.6f}; worst "
          f"relative L2 error against the plain backward on K1's forward "
          f"{worst[0]:.3e} ({worst[1]}), tolerance {GRAD_RTOL:g}; against "
          f"the fully plain run {worst_plain[0]:.3e} ({worst_plain[1]}, "
          f"not held); worst running statistic {worst_stat[0]:.3e} "
          f"({worst_stat[1]}), tolerance 1e-05", flush=True)
    return dict(worst=worst[0], worst_plain=worst_plain[0],
                worst_stat=worst_stat[0], n_trainable=len(names),
                n_running_stats=len(stats))


# bf16 gradients of one step, K2/K3 against their plain versions in the
# same backward on K1's forward values: relative L2 error per trainable
# tensor. Both fold and round where the TPU kernels do; they differ in the
# order of fp32 sums, which flips a bf16 rounding of dx now and then
# (2^-9 of an element), carried down the 52 convs of the backward. 2e-2
# is the loosest the port allows itself.
BF16_GRAD_RTOL = 2e-2


class plain_conv_backward:
    """``with plain_conv_backward():`` the fused conv's autograd Functions
    call the plain versions of K2 and K3 (the swap is made here, for the
    bf16 gate only); K1 still computes the forward. cuDNN runs its
    deterministic algorithms meanwhile: the plain versions' convolution
    gradients otherwise differ from run to run in the last fp32 bits, which
    the bf16 network carries to percents in the stem's gradients (measured
    on an H100), while the kernels repeat bit for bit."""

    def __enter__(self):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        self._saved = (fc.conv_bwd_dx, fc.conv_bwd_dw,
                       torch.backends.cudnn.deterministic)
        fc.conv_bwd_dx = fc.conv_bwd_dx_reference
        fc.conv_bwd_dw = fc.conv_bwd_dw_reference
        torch.backends.cudnn.deterministic = True
        return self

    def __exit__(self, *exc):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        fc.conv_bwd_dx, fc.conv_bwd_dw, det = self._saved
        torch.backends.cudnn.deterministic = det


def resnet_bf16_gate(net, ce, x, y):
    """One bf16 training step from one state, three times: through K2/K3
    (the tensor-core route); through their plain versions
    (``plain_conv_backward``): every trainable tensor's gradient within
    ``BF16_GRAD_RTOL`` relative L2; and through the autograd of the plain
    forward on K1's forward values (``_pinned_fused_conv_bn``), printed,
    not held: that backward keeps dy_t in fp32 and differentiates the fp32
    accumulator where the kernels (and the TPU's) round to bf16. Returns
    the worst errors."""
    def loss_fn(logits, labels):
        return ce(logits, labels).mean()

    start = _frozen(net)

    def run(fn):
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n in start:
                    p.copy_(start[n])
        if fn is None:
            return _grads(net, loss_fn, x, y)
        with swap_convs(fn):
            return _grads(net, loss_fn, x, y)

    _reset_conv_launches()
    loss, grads = run(None)
    launches, routes = _conv_launches(), _route_launches()
    with plain_conv_backward():
        ref_loss, ref_grads = run(None)
    _, auto_grads = run(_pinned_fused_conv_bn)
    _check_launches("bf16 gradient gate (kernel run)", launches,
                    convs_per_pass(net), 1, 1, routes, "tc")
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    worst, worst_auto = (0.0, ""), (0.0, "")
    for name, g, r, q in zip(names, grads, ref_grads, auto_grads):
        rel = _rel_l2(g.float(), r.float())
        if not math.isfinite(rel) or rel > BF16_GRAD_RTOL:
            raise AssertionError(f"bf16 gradient gate: {name} relative L2 "
                                 f"error {rel} > {BF16_GRAD_RTOL}")
        worst = max(worst, (rel, name))
        worst_auto = max(worst_auto, (_rel_l2(g.float(), q.float()), name))
    print(f"bf16 gradient gate (B={x.shape[0]}, {len(names)} trainable "
          f"tensors): loss {float(loss):.6f} vs {float(ref_loss):.6f}; "
          f"worst relative L2 error against the plain K2/K3 on K1's "
          f"forward {worst[0]:.3e} ({worst[1]}), tolerance "
          f"{BF16_GRAD_RTOL:g}; against the autograd of the plain forward "
          f"{worst_auto[0]:.3e} ({worst_auto[1]}, not held)", flush=True)
    return dict(worst=worst[0], worst_name=worst[1],
                worst_autograd=worst_auto[0], n_trainable=len(names))


# The bf16 forward gate: the tensor-core K1's distance from the fp32
# forward over the SIMT K1's, held for the logits (relative L2) and the
# running statistics (worst), each at most 1 + FWD_GATE_SLACK. Both kernels
# round x_pro and y to bf16 at the same places and differ in how their fp32
# sums round, which flips a bf16 rounding now and then; 52 layers carry
# the flips on. At the net as drawn the logits' ratio lay in 0.984-1.005
# over eleven batches on an H100 and the statistics' at 1.000, while a
# kernel that lost precision or summed the wrong rows would be farther by
# multiples. After fp32 training steps the same ratio spread over
# 0.91-1.22 (six batches), too wide to hold anything by, so the gate runs
# at the net as drawn. The loss is printed, not held: one scalar whose two
# distances differ by a ratio of 0.16 to 2.95 between batches.
FWD_GATE_HELD = ("logits", "stats")
FWD_GATE_SLACK = 0.05


class force_conv_route:
    """``with force_conv_route(route):`` every ``fused_conv`` call (K1)
    names ``route`` (None: the rule's); the swap is made here, for the
    forward gate only."""

    def __init__(self, route):
        self._route = route

    def __enter__(self):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        self._saved = fc.fused_conv
        if self._route is not None:
            fc.fused_conv = functools.partial(self._saved, route=self._route)
        return self

    def __exit__(self, *exc):
        from incubator_mxnet_tpu_torch.ops import fused_conv as fc

        fc.fused_conv = self._saved


def bf16_forward_distances(net, ce, x, y):
    """One training-mode forward of the bf16 net (batch statistics; the
    running statistics move) from one state, three times: through the
    tensor-core K1 (the route the rule takes); through the SIMT K1
    (``route="simt"``) on the same inputs; and in fp32, the net cast up
    (the same bf16-rounded weights, running statistics and input; the f32
    K1). Each bf16 forward's distance from the fp32 one: the loss
    (relative), the logits (relative L2) and the running statistics after
    the forward (the worst max abs error over max(1, max|fp32|)). The state
    is restored after each run. Returns ``{"tc": {...}, "simt": {...}}``
    and the number of running statistics."""
    import incubator_mxnet_tpu_torch as mx

    per_pass = convs_per_pass(net)
    start = _frozen(net)

    def run(label, route=None, fp32=False):
        with torch.no_grad():
            for n, p in net.named_parameters():
                if n in start:
                    p.copy_(start[n])
        _reset_conv_launches()
        if fp32:
            net.cast("float32")
        try:
            with torch.no_grad(), mx.autograd.train_mode(), \
                    force_conv_route(route):
                logits = net(x.float() if fp32 else x).float()
                loss = float(ce(logits, y).mean())
            stats = {n: v.float() for n, v in _frozen(net).items()}
        finally:
            if fp32:
                net.cast("bfloat16")
        _check_launches(f"bf16 forward gate ({label})", _conv_launches(),
                        per_pass, 1, 0, _route_launches(),
                        conv_routes_expected(torch.float32) if fp32
                        else "simt" if route == "simt" else "tc")
        return loss, logits, stats

    ref_loss, ref_logits, ref_stats = run("fp32", fp32=True)
    dist = {}
    for route in ("tc", "simt"):
        loss, logits, stats = run(route, None if route == "tc" else route)
        worst_stat = max(
            (v - ref_stats[n]).abs().max().item()
            / max(1.0, ref_stats[n].abs().max().item())
            for n, v in stats.items())
        dist[route] = dict(loss=abs(loss - ref_loss) / abs(ref_loss),
                           logits=_rel_l2(logits, ref_logits),
                           stats=worst_stat)
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n in start:
                p.copy_(start[n])
    return dist, len(ref_stats)


def resnet_bf16_forward_gate(net, ce, x, y):
    """The bf16 forward gate: ``bf16_forward_distances`` on one batch; the
    tensor-core K1's distances over the SIMT K1's are printed and held as
    ``FWD_GATE_HELD`` and ``FWD_GATE_SLACK`` say. Returns both distances
    and the ratios."""
    dist, n_stats = bf16_forward_distances(net, ce, x, y)
    ratio = {k: dist["tc"][k] / max(dist["simt"][k], 1e-30)
             for k in dist["tc"]}
    held = {k: ratio[k] for k in FWD_GATE_HELD}
    print(f"bf16 forward gate (B={x.shape[0]}, training mode, "
          f"{n_stats} running statistics): distance from the fp32 "
          f"forward on the same bf16-rounded inputs, tensor-core K1 "
          + ", ".join(f"{k} {v:.4e}" for k, v in dist["tc"].items())
          + "; the SIMT K1 "
          + ", ".join(f"{k} {v:.4e}" for k, v in dist["simt"].items())
          + "; ratio " + ", ".join(f"{k} {v:.4f}" for k, v in ratio.items())
          + f" (held: {', '.join(FWD_GATE_HELD)} <= "
          f"{1 + FWD_GATE_SLACK:g}; the loss printed)", flush=True)
    if not all(math.isfinite(v) and v <= 1 + FWD_GATE_SLACK
               for v in held.values()):
        raise AssertionError(f"bf16 forward gate: the tensor-core K1 is "
                             f"farther from the fp32 forward than the SIMT "
                             f"K1: ratios {held}")
    return dict(tc=dist["tc"], simt=dist["simt"], ratio=ratio,
                n_running_stats=n_stats)


CONV_TAGS = ("fused_conv_fwd_kernel", "fused_conv_tc_kernel",
             "fused_conv_f32_kernel", "conv_bwd_dx_kernel",
             "conv_bwd_dw_kernel", "conv_bwd_dx_f32_kernel",
             "conv_bwd_dw_f32_kernel",
             "conv_bwd_dx_tc_kernel", "conv_bwd_dw_tc_kernel",
             "column_sum_kernel", "column_sums_kernel", "split_sum_kernel",
             "split_finish_kernel", "join_emit_kernel")


# batch sizes of the ResNet phase: eval, gradient oracle, learning check
# and eager steps, bench row (then its fallback)
RESNET_BATCHES = (32, 8, 16, (128, 64))


def set_eval_statistics(net, x):
    """One training-mode forward of ``x`` (no grad) with every BatchNorm
    momentum at 0: each running statistic becomes this batch's, so an eval
    forward of ``x`` folds the statistics that forward used. Returns its
    logits."""
    import incubator_mxnet_tpu_torch as mx

    momenta = {m: m._momentum for m in net.modules()
               if hasattr(m, "_momentum")}
    try:
        for m in momenta:
            m._momentum = 0.0
        with torch.no_grad(), mx.autograd.train_mode():
            return net(x)
    finally:
        for m, v in momenta.items():
            m._momentum = v


def resnet_phase(seed, card, net, ctx, hw=224, batches=RESNET_BATCHES):
    """Drive ``net`` (``fused_resnet50_v1`` from ``main``; initialized on
    ``ctx``) through eval, the gradient oracle and the training entry
    points on ``hw`` x ``hw`` images, as the module docstring says."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel

    dev = ctx.torch_device()
    per_pass = convs_per_pass(net)
    classes = net.output.weight.shape[0]
    b_eval, b_oracle, b_train, b_bench = batches
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)

    def batch(b):
        x = torch.rand((b, 3, hw, hw), generator=gen, device=dev)
        y = torch.randint(0, classes, (b,), generator=gen, device=dev)
        return x, y.float()

    ce = gluon.loss.SoftmaxCrossEntropyLoss()

    # the fp32 gradient oracle
    x, y = batch(b_oracle)
    oracle = resnet_oracle(net, ce, x, y)

    # the bf16 forward gate, at the net as drawn (see FWD_GATE_SLACK): the
    # net cast to bf16 for it, then cast back and its fp32 values restored;
    # its batch comes from a generator of its own, so nothing after it moves
    fp32_values = {n: p.detach().clone() for n, p in net.named_parameters()}
    net.cast("bfloat16")
    gate_gen = torch.Generator(device=dev)
    gate_gen.manual_seed(seed + 41)
    xg = torch.rand((b_oracle, 3, hw, hw), generator=gate_gen, device=dev)
    yg = torch.randint(0, classes, (b_oracle,), generator=gate_gen,
                       device=dev)
    fwd_gate = resnet_bf16_forward_gate(net, ce, xg.to(torch.bfloat16),
                                        yg.float())
    net.cast("float32")
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(fp32_values[n])
    del fp32_values, xg, yg

    # the training path, counted in two windows (the eval check between
    # them is counted on its own)
    _reset_conv_launches()
    passes = 0
    x, y = batch(b_train)
    st = parallel.SPMDTrainer(net, ce, "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
    losses = [float(st.step(x, y)) for _ in range(10)]
    passes += 10
    print(f"learning check (fp32 SPMDTrainer, B={b_train}, sgd lr 0.05 "
          f"momentum 0.9, one batch repeated): losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("the loss did not fall by 5% over 10 steps")
    st.sync_to_net()
    del st

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9})
    eager = []
    for _ in range(2):
        with mx.autograd.record():
            per_sample = ce(net(x), y)
        mx.autograd.backward(per_sample)
        trainer.step(x.shape[0])
        eager.append(float(per_sample.detach().mean()))
    passes += 2
    if not all(math.isfinite(v) for v in eager):
        raise AssertionError(f"gluon.Trainer losses not finite: {eager}")
    print(f"gluon.Trainer (fp32, B={b_train}, sgd lr 0.01 momentum 0.9): 2 "
          f"steps, losses {eager}", flush=True)
    del trainer
    first, first_routes = _conv_launches(), _route_launches()

    # eval logits. One training-mode forward of the eval batch (no grad)
    # with the BatchNorm momentum at 0 sets every running statistic to this
    # batch's statistics; the eval forward of the same batch must then give
    # that forward's logits (the same folded BatchNorm), and the logits of
    # the model with fused_conv_bn swapped for the plain versions
    x, _ = batch(b_eval)
    _reset_conv_launches()
    train_logits = set_eval_statistics(net, x)
    with mx.autograd.pause():
        logits = net(x)
    eval_launches, eval_routes = _conv_launches(), _route_launches()
    with mx.autograd.pause(), swap_convs(_plain_fused_conv_bn):
        want = net(x)
    torch.cuda.synchronize()
    eval_err = _rel_l2(logits, want)
    self_err = _rel_l2(logits, train_logits)
    print(f"eval logits (fp32, B={b_eval}, running statistics of this "
          f"batch): shape {tuple(logits.shape)}, max |logit| "
          f"{want.abs().max().item():.4g}; relative L2 error against the "
          f"plain swap {eval_err:.3e}, against the training-mode forward "
          f"{self_err:.3e} (tol {TOLS[torch.float32]:g} each)", flush=True)
    if logits.shape != want.shape or not torch.isfinite(logits).all() \
            or max(eval_err, self_err) > TOLS[torch.float32]:
        raise AssertionError("eval logits disagree with the plain path or "
                             "with the training-mode forward")
    _check_launches("eval", eval_launches, per_pass, 2, 0, eval_routes,
                    conv_routes_expected(torch.float32))
    _check_launches("fp32 training path (SPMDTrainer, gluon.Trainer)",
                    first, per_pass, passes, passes, first_routes,
                    conv_routes_expected(torch.float32))

    # bf16: the gradient gate, a learning check, then (e) the bench row:
    # B=128, SPMDTrainer SGD lr 0.1 momentum 0.9; K2/K3 on the tensor cores
    net.cast("bfloat16")
    gc.collect()
    x, y = batch(b_oracle)
    bf16_gate = resnet_bf16_gate(net, ce, x.to(torch.bfloat16), y)
    _reset_conv_launches()
    bf16_passes = 0
    x, y = batch(b_train)
    x = x.to(torch.bfloat16)
    st = parallel.SPMDTrainer(net, ce, "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
    bf16_learning = [float(st.step(x, y)) for _ in range(10)]
    bf16_passes += 10
    print(f"bf16 learning check (SPMDTrainer, B={b_train}, sgd lr 0.05 "
          f"momentum 0.9, one batch repeated): losses "
          f"{[round(v, 4) for v in bf16_learning]}", flush=True)
    if not all(math.isfinite(v) for v in bf16_learning) \
            or not bf16_learning[-1] < 0.95 * bf16_learning[0]:
        raise AssertionError("the bf16 loss did not fall by 5% over 10 "
                             "steps")
    st.sync_to_net()
    del st
    gc.collect()
    bench = None
    for b in b_bench:
        xb, yb = batch(b)
        xb = xb.to(torch.bfloat16)
        st = parallel.SPMDTrainer(net, ce, "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
        for _ in range(2):
            st.step(xb, yb)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        bf16_losses = [st.step(xb, yb) for _ in range(5)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        peak = torch.cuda.max_memory_allocated(dev)
        bf16_passes += 7
        if not all(torch.isfinite(v) for v in bf16_losses):
            raise AssertionError("bf16 SPMDTrainer loss not finite")
        print(f"bf16 SPMDTrainer step (B={b}, sgd lr 0.1 "
              f"momentum 0.9; {card}): {step_ms:.3f} ms per step (host "
              f"clock, 5 steps after 2 warmup), {b / step_ms * 1e3:.1f} "
              f"images/s, peak memory {peak / 2**20:.1f} MiB", flush=True)
        bench = dict(batch=b, step_ms=step_ms, images_s=b / step_ms * 1e3,
                     peak_bytes=peak)
        if step_ms <= 2000.0 or b == b_bench[-1]:   # the last one stays
            break
        print(f"the B={b} step took over 2 s: the row drops to the next "
              "batch size", flush=True)
        del st
    rows = _profile_step(st.step, xb, yb, card, bench["step_ms"],
                         tags=CONV_TAGS, top=16)
    bf16_passes += 1
    second, second_routes = _conv_launches(), _route_launches()
    _check_launches("bf16 training path (learning check, bench row)",
                    second, per_pass, bf16_passes, bf16_passes,
                    second_routes, "tc")
    launches = {k: first[k] + second[k] for k in CONV_KERNELS}
    routes = {k: first_routes[k] + second_routes[k] for k in first_routes}
    return dict(launches=launches, routes=routes,
                eval_launches=eval_launches, eval_routes=eval_routes,
                per_pass=per_pass,
                passes=passes + bf16_passes, bf16_passes=bf16_passes,
                oracle=oracle, learning_losses=losses, eval_err=eval_err,
                bf16_fwd_gate=fwd_gate, bf16_gate=bf16_gate,
                bf16_learning_losses=bf16_learning,
                bench=bench, profile=rows[:16])



def resnet_main(seed, card):
    """The ResNet phase on ``fused_resnet50_v1``: 1000 classes, 224x224,
    52 fused convs per pass, 161 trainable tensors, 106 running
    statistics."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    t0 = time.perf_counter()
    net = get_model("fused_resnet50_v1", classes=1000).initialize(
        "xavier", ctx=ctx)
    nparams = sum(p.numel() for p in net.parameters())
    print(f"model fused_resnet50_v1: {nparams} parameters, drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = resnet_phase(seed, card, net, ctx)
    if (out["per_pass"], out["oracle"]["n_trainable"],
            out["oracle"]["n_running_stats"]) != (52, 161, 106):
        raise AssertionError("fused_resnet50_v1 runs 52 fused convs per "
                             "pass and has 161 trainable tensors and 106 "
                             "running statistics")
    return out


# ---------------------------------------------------------------------------
# ModelServer phase: fused_resnet50_v1 behind serving.ModelServer, one CUDA
# graph a batch bucket
# ---------------------------------------------------------------------------
SERVER_BUCKETS = (1, 2, 4, 8, 16, 32)
# single-image requests and the client threads that send them
SERVER_REQUESTS = 64
SERVER_CLIENTS = 8
# a served row against the same image's own B=1 eager forward, relative
# L2: not bit-equal, since the Dense head may take another cuBLAS
# algorithm at M=1 than at M=32 (a graph against eager on one batch is)
SERVER_ROW_RTOL = 1e-5
# open-loop Poisson traffic: the offered rates (requests/s) and seconds a
# rate, per dtype
SERVER_RATES = {"fp32": (100.0, 400.0, 1600.0),
                "bf16": (200.0, 800.0, 3200.0)}
SERVER_RATE_S = 3.0


def open_loop(fire, rate_rps, duration_s, seed=0, join_timeout=120.0):
    """Open-loop (Poisson) load: the harness of the JAX package's
    ``benchmark/serving_bench.py`` (``open_loop``), copied. ``fire(i)``
    starts request ``i`` and returns its Future; completion latency is
    recorded from the Future's own done-callback (no waiter thread a
    request). A backpressure refusal raises ``QueueFullError`` from
    ``fire``. Returns offered/completed counts, rejected/shed/error counts
    and the completed requests' latencies."""
    import threading

    from incubator_mxnet_tpu_torch.serving import (DeadlineExceededError,
                                                   QueueFullError)

    rs = np.random.RandomState(seed)
    cv = threading.Condition()
    lats, counts = [], {"rejected": 0, "shed": 0, "errors": 0}
    outstanding = [0]

    def record(obj, ts):
        dt = time.perf_counter() - ts
        try:
            exc = obj.exception(0)         # done: never blocks
        except Exception:                  # noqa: BLE001 — cancelled etc.
            exc = RuntimeError("unresolved")
        with cv:
            if exc is None:
                lats.append(dt)
            elif isinstance(exc, DeadlineExceededError):
                counts["shed"] += 1
            else:
                counts["errors"] += 1
            outstanding[0] -= 1
            cv.notify_all()

    offered = 0
    t0 = time.perf_counter()
    next_t = rs.exponential(1.0 / rate_rps)
    while True:
        now = time.perf_counter() - t0
        if now >= duration_s:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.005))
            continue
        next_t += rs.exponential(1.0 / rate_rps)
        offered += 1
        t_sub = time.perf_counter()
        try:
            obj = fire(offered - 1)
        except QueueFullError:
            counts["rejected"] += 1
            continue
        except DeadlineExceededError:
            counts["shed"] += 1
            continue
        with cv:
            outstanding[0] += 1
        obj.add_done_callback(lambda o, ts=t_sub: record(o, ts))
    deadline = time.perf_counter() + join_timeout
    with cv:
        while outstanding[0] > 0 and time.perf_counter() < deadline:
            cv.wait(timeout=0.1)
    wall = time.perf_counter() - t0
    return {"offered": offered, "completed": len(lats),
            "offered_rps": offered / duration_s,
            "achieved_rps": len(lats) / wall, "lats": lats,
            "duration_s": duration_s, **counts}


def _pctl_ms(lats, p):
    """The reference harness's percentile (``pctl``), in ms."""
    if not lats:
        return 0.0
    return sorted(lats)[min(len(lats) - 1, int(p / 100.0 * len(lats)))] * 1e3


class Unbatched:
    """The same traffic without a server: one eager B=1 forward a request,
    one at a time on one worker thread, behind a queue bounded as the
    server's (``QueueFullError`` past ``max_queue``)."""

    def __init__(self, forward, max_queue):
        import threading
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1)
        self._forward = forward
        self._max = max_queue
        self._waiting = 0
        self._lock = threading.Lock()

    def submit(self, x):
        from incubator_mxnet_tpu_torch.serving import QueueFullError

        with self._lock:
            if self._waiting >= self._max:
                raise QueueFullError("unbatched queue full", retry_after=0.0)
            self._waiting += 1
        fut = self._pool.submit(self._forward, x)
        fut.add_done_callback(self._done)
        return fut

    def _done(self, _):
        with self._lock:
            self._waiting -= 1

    def close(self):
        self._pool.shutdown(wait=True)


def _eager_rows(net, x, dev):
    """``net``'s eval forward of the host batch ``x`` (cast to the net's
    type, as the server's runner casts it), back on the host in fp32."""
    import incubator_mxnet_tpu_torch as mx

    dtype = next(net.parameters()).dtype
    with torch.no_grad(), mx.autograd.pause():
        return net(torch.as_tensor(x).to(dev, dtype)).float().cpu()


def _memory_mark(dev):
    """What is allocated and reserved now (after a collection and an
    ``empty_cache``), the peak reset: the base of :func:`_memory_since`."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)


def _memory_since(dev, mark):
    """Bytes allocated and reserved above ``mark``, and the peak
    allocation above it (a warm-up's graphs: their pools keep the
    activations reserved)."""
    torch.cuda.synchronize()
    a0, r0 = mark
    return dict(allocated=torch.cuda.memory_allocated(dev) - a0,
                reserved=torch.cuda.memory_reserved(dev) - r0,
                peak=torch.cuda.max_memory_allocated(dev) - a0)


def _mib(mem):
    return (f"{mem['reserved'] / 2**20:.1f} MiB reserved, "
            f"{mem['allocated'] / 2**20:.1f} MiB allocated, peak "
            f"{mem['peak'] / 2**20:.1f} MiB")


def _check_server_launches(label, got, per_pass, batches, routes, route):
    """K1 ``per_pass`` times an executed batch, all on ``route``, K2/K3
    never (the server runs the eval forward)."""
    _check_launches(label, got, per_pass, batches, 0, routes,
                    {"fused_conv": route, "conv_bwd_dx": route,
                     "conv_bwd_dw": route})


def _serve_rows(srv, images, clients):
    """``images`` as single-image requests from ``clients`` threads: the
    rows in order, the batches and requests they took, host seconds."""
    from concurrent.futures import ThreadPoolExecutor

    m = srv.metrics
    b0, q0 = m.batches, m.requests
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        futs = list(pool.map(srv.submit, images))
    rows = np.stack([f.result(300) for f in futs])
    return rows, m.batches - b0, m.requests - q0, time.perf_counter() - t0


def _bucket_times(cache, net, dev, images, reps=5):
    """Each bucket's full batch through its graph (the cache call: staging,
    copy, replay, rows back) beside the eager eval forward of the same
    batch (copy, forward, rows back): host ms (median of ``reps``
    alternating turns) and device time (``torch.profiler``)."""
    out = {}
    for b in cache.buckets:
        x = np.resize(images, (b,) + images.shape[1:])
        fns = {"graph": lambda: cache(x),
               "eager": lambda: _eager_rows(net, x, dev)}
        host = _median_turns(fns, reps)
        out[b] = dict(graph_ms=host["graph"], eager_ms=host["eager"],
                      graph_device_ms=_kernel_ms(fns["graph"]),
                      eager_device_ms=_kernel_ms(fns["eager"]))
    return out


def _open_loop_rows(cache, net, dev, images, rates, seconds, buckets, label):
    """Open-loop Poisson traffic at each offered rate through a fresh
    ``ModelServer`` over ``cache`` (a clean queue a rate; max_wait 2 ms,
    the queue bounded at 4 x the largest bucket), then the same traffic
    unbatched (``Unbatched``): requests/s, latency p50/p99, mean batch
    occupancy, refusals."""
    from incubator_mxnet_tpu_torch import serving

    rows = []
    for i, rate in enumerate(rates):
        row = {"rate": rate}
        srv = serving.ModelServer(cache, max_wait_ms=2.0,
                                  max_queue=4 * buckets[-1],
                                  name=f"{label}_r{i}")
        b0, q0 = srv.metrics.batches, srv.metrics.requests
        try:
            res = open_loop(lambda j: srv.submit(images[j % len(images)]),
                            rate, seconds, seed=i)
        finally:
            srv.drain(60)
            srv.close()
        batches = srv.metrics.batches - b0
        row["batched"] = dict(
            offered_rps=res["offered_rps"], achieved_rps=res["achieved_rps"],
            p50_ms=_pctl_ms(res["lats"], 50), p99_ms=_pctl_ms(res["lats"], 99),
            occupancy=(srv.metrics.requests - q0) / max(1, batches),
            completed=res["completed"], rejected=res["rejected"],
            errors=res["errors"])
        unb = Unbatched(lambda x: _eager_rows(net, x[None], dev)[0],
                        4 * buckets[-1])
        try:
            res = open_loop(lambda j: unb.submit(images[j % len(images)]),
                            rate, seconds, seed=i)
        finally:
            unb.close()
        row["unbatched"] = dict(
            offered_rps=res["offered_rps"], achieved_rps=res["achieved_rps"],
            p50_ms=_pctl_ms(res["lats"], 50), p99_ms=_pctl_ms(res["lats"], 99),
            completed=res["completed"], rejected=res["rejected"],
            errors=res["errors"])
        if row["batched"]["errors"] or row["unbatched"]["errors"]:
            raise AssertionError(f"open loop {label} at {rate} requests/s: "
                                 f"errors {row}")
        rows.append(row)
        bt, ub = row["batched"], row["unbatched"]
        print(f"open loop {label} at {rate:g} requests/s offered "
              f"({seconds:g} s, Poisson): ModelServer {bt['achieved_rps']:.1f}"
              f" requests/s, p50 {bt['p50_ms']:.3f} ms, p99 "
              f"{bt['p99_ms']:.3f} ms, occupancy {bt['occupancy']:.2f}, "
              f"refused {bt['rejected']} of {bt['completed'] + bt['rejected']}"
              f"; unbatched (eager B=1) {ub['achieved_rps']:.1f} requests/s,"
              f" p50 {ub['p50_ms']:.3f} ms, p99 {ub['p99_ms']:.3f} ms, "
              f"refused {ub['rejected']} of "
              f"{ub['completed'] + ub['rejected']}", flush=True)
    return rows


def model_server_phase(seed, card, net, ctx, hw=224,
                       buckets=SERVER_BUCKETS, requests=SERVER_REQUESTS,
                       clients=SERVER_CLIENTS, rates=SERVER_RATES,
                       rate_s=SERVER_RATE_S):
    """Serve ``net`` (``fused_resnet50_v1`` from ``main``, initialized on
    ``ctx``) through ``serving.ModelServer``, as the module docstring's
    ModelServer phase says; returns its numbers."""
    import threading

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving

    dev = ctx.torch_device()
    per_pass = convs_per_pass(net)
    feat = (3, hw, hw)
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 51)
    set_eval_statistics(net, torch.rand((buckets[-1],) + feat,
                                        generator=gen, device=dev))
    rs = np.random.RandomState(seed + 52)
    images = rs.rand(requests, *feat).astype(np.float32)
    out = {"per_pass": per_pass}

    # -- fp32 -----------------------------------------------------------------
    route = conv_routes_expected(torch.float32)["fused_conv"]
    # the six graphs with a memory pool each, for the footprint only
    mark = _memory_mark(dev)
    own = serving.BucketedExecutorCache.from_block(
        net, ctx=ctx, buckets=buckets, share_pool=False)
    own.warmup(feat, "float32")
    own_mem = _memory_since(dev, mark)
    del own
    mark = _memory_mark(dev)
    srv = serving.ModelServer(net, buckets=buckets, max_wait_ms=2.0,
                              ctx=ctx, name="resnet50_fp32")
    t0 = time.perf_counter()
    srv.warmup(feat, "float32")
    warm_s = time.perf_counter() - t0
    shared_mem = _memory_since(dev, mark)
    cache = srv._cache
    want_captures = len(buckets) if on_card else 0
    sigs = srv.compiled_signatures()
    print(f"ModelServer fp32 ({card}): warm-up captured "
          f"{srv.metrics.captures} graphs in {warm_s:.2f} s ({sigs}); the "
          f"graphs hold {_mib(shared_mem)} in one shared pool; "
          f"{_mib(own_mem)} with a pool a graph", flush=True)
    if sigs != [(b, feat, "float32") for b in buckets] \
            or srv.metrics.captures != want_captures:
        raise AssertionError(f"warm-up: signatures {sigs}, "
                             f"{srv.metrics.captures} captures")
    want_rec = {"fused_conv": per_pass, f"fused_conv_{route}": per_pass}
    for key, ex in cache._execs.items():
        rec = _counts_by_name(ex.graph.counted) if on_card else want_rec
        if rec != want_rec:
            raise AssertionError(f"bucket {key}: the capture recorded {rec},"
                                 f" not {want_rec}")

    # each bucket's replay against the eager forward of the same padded
    # batch, bit for bit (b // 2 + 1 rows, the fewest the bucket takes:
    # its padding rides)
    for b in buckets:
        n = b // 2 + 1 if b > 1 else 1
        x = images[:n] if n <= requests else np.resize(images, (n,) + feat)
        padded = np.zeros((b,) + feat, np.float32)
        padded[:n] = x
        got = torch.from_numpy(cache(x))
        want = _eager_rows(net, padded, dev)[:n]
        if not torch.equal(got, want):
            raise AssertionError(f"bucket {b}: the graph's rows differ from "
                                 f"the eager forward (max "
                                 f"{(got - want).abs().max().item():.3e})")
    print(f"ModelServer fp32: each bucket's replay bit-equal to the eager "
          f"eval forward of the same padded batch ({list(buckets)})",
          flush=True)

    # traffic: single-image requests from client threads
    _reset_conv_launches()
    rows, batches, served, wall = _serve_rows(srv, images, clients)
    launches, routes = _conv_launches(), _route_launches()
    _check_server_launches("ModelServer fp32 traffic", launches, per_pass,
                           batches, routes, route)
    one = torch.cat([_eager_rows(net, x[None], dev) for x in images])
    row_err = max(_rel_l2(torch.from_numpy(r), o) for r, o in zip(rows, one))
    with mx.autograd.pause(), swap_convs(_plain_fused_conv_bn):
        plain = torch.cat([_eager_rows(net, images[i:i + buckets[-1]], dev)
                           for i in range(0, requests, buckets[-1])])
    plain_err = _rel_l2(torch.from_numpy(rows), plain)
    print(f"ModelServer fp32 traffic: {served} requests from {clients} "
          f"threads in {batches} batches (occupancy "
          f"{served / max(1, batches):.2f}) in {wall:.3f} s; worst row "
          f"against its B=1 eager forward {row_err:.3e} (tol "
          f"{SERVER_ROW_RTOL:g}), rows against the plain versions "
          f"{plain_err:.3e} (tol {TOLS[torch.float32]:g}); captures after "
          f"traffic {srv.metrics.captures}", flush=True)
    if rows.shape != (requests, net.output.weight.shape[0]) \
            or not np.isfinite(rows).all() or served != requests \
            or row_err > SERVER_ROW_RTOL or plain_err > TOLS[torch.float32] \
            or srv.metrics.captures != want_captures:
        raise AssertionError("ModelServer fp32: rows, counts or captures "
                             "wrong")

    # backpressure and drain, through a second server over the same graphs
    small = serving.ModelServer(cache, max_wait_ms=2.0, max_queue=4,
                                name="resnet50_small_queue")
    futs, refused = [], 0
    for x in np.resize(images, (32,) + feat):
        try:
            futs.append(small.submit(x))
        except serving.QueueFullError as e:
            refused += 1
            retry_after = e.retry_after
    ready = small.healthz()["ready"]
    drained = small.drain(60)
    after = small.healthz()
    small.close()
    print(f"backpressure: a 32-request burst into max_queue=4: "
          f"{refused} refused (QueueFullError, retry_after "
          f"{retry_after if refused else 0:.4f} s), {len(futs)} answered; "
          f"healthz ready {ready} before drain, {after['ready']} "
          f"({after['state']}) after; clean drain {drained}", flush=True)
    if not refused or not ready or after["ready"] or not drained \
            or not all(f.done() and f.exception() is None for f in futs):
        raise AssertionError("ModelServer: backpressure or drain wrong")

    out["fp32"] = dict(memory=dict(shared=shared_mem, own=own_mem),
                       warmup_s=warm_s,
                       launches=launches, routes=routes, batches=batches,
                       row_err=row_err, plain_err=plain_err,
                       captures=srv.metrics.captures,
                       bucket_ms=_bucket_times(cache, net, dev, images),
                       open_loop=_open_loop_rows(
                           cache, net, dev, images, rates["fp32"], rate_s,
                           buckets, "fp32"))
    srv.drain(60)
    srv.close()
    del srv, cache, small
    gc.collect()

    # -- bf16 -----------------------------------------------------------------
    # the fp32 forward on the bf16-rounded weights and inputs, then the net
    # in bf16 (its graphs captured on a thread that never ran a kernel)
    route = conv_routes_expected(torch.bfloat16)["fused_conv"]
    net.cast("bfloat16").cast("float32")
    images16 = torch.from_numpy(images).bfloat16().float().numpy()
    ref = torch.cat([_eager_rows(net, images16[i:i + buckets[-1]], dev)
                     for i in range(0, requests, buckets[-1])])
    net.cast("bfloat16")
    mark = _memory_mark(dev)
    srv = serving.ModelServer(net, buckets=buckets, max_wait_ms=2.0,
                              ctx=ctx, name="resnet50_bf16")
    err = []
    t0 = time.perf_counter()
    warm = threading.Thread(target=lambda: err.append(
        _capture_or_error(srv, feat)))
    warm.start()
    warm.join()
    if err[0] is not None:
        raise AssertionError(f"bf16 warm-up on a fresh thread: {err[0]}")
    warm_s = time.perf_counter() - t0
    mem16 = _memory_since(dev, mark)
    cache = srv._cache
    want_rec = {"fused_conv": per_pass, f"fused_conv_{route}": per_pass}
    for key, ex in cache._execs.items():
        rec = _counts_by_name(ex.graph.counted) if on_card else want_rec
        if rec != want_rec:
            raise AssertionError(f"bf16 bucket {key}: the capture recorded "
                                 f"{rec}, not {want_rec}")
    _reset_conv_launches()
    rows, batches, served, wall = _serve_rows(srv, images16, clients)
    launches, routes = _conv_launches(), _route_launches()
    _check_server_launches("ModelServer bf16 traffic", launches, per_pass,
                           batches, routes, route)
    # held as resnet_bf16_forward_gate holds the bf16 forward: the served
    # logits (the tensor-core K1) no farther from the fp32 forward than the
    # same eager forward through the SIMT K1
    gate = _rel_l2(torch.from_numpy(rows), ref)
    with force_conv_route("simt"):
        simt = torch.cat([_eager_rows(net, images16[i:i + buckets[-1]], dev)
                          for i in range(0, requests, buckets[-1])])
    simt_gate = _rel_l2(simt, ref)
    ratio = gate / max(simt_gate, 1e-30)
    print(f"ModelServer bf16 ({card}): warm-up {warm_s:.2f} s on a fresh "
          f"thread, {srv.metrics.captures} captures, the graphs hold "
          f"{_mib(mem16)} in one shared pool; {served} requests in "
          f"{batches} batches; relative L2 from the fp32 forward on the "
          f"same bf16-rounded weights and inputs: served (tensor-core K1) "
          f"{gate:.4e}, eager through the SIMT K1 {simt_gate:.4e}, ratio "
          f"{ratio:.4f} (held <= {1 + FWD_GATE_SLACK:g})", flush=True)
    if not np.isfinite(rows).all() or not math.isfinite(ratio) \
            or ratio > 1 + FWD_GATE_SLACK \
            or srv.metrics.captures != want_captures:
        raise AssertionError("ModelServer bf16: logits or captures wrong")
    out["bf16"] = dict(memory=dict(shared=mem16), warmup_s=warm_s,
                       launches=launches, routes=routes, batches=batches,
                       gate=gate, simt_gate=simt_gate, ratio=ratio, captures=srv.metrics.captures,
                       bucket_ms=_bucket_times(cache, net, dev, images16),
                       open_loop=_open_loop_rows(
                           cache, net, dev, images16, rates["bf16"], rate_s,
                           buckets, "bf16"))
    srv.drain(60)
    srv.close()
    for dt in ("fp32", "bf16"):
        for b, r in out[dt]["bucket_ms"].items():
            print(f"ModelServer {dt} bucket {b} ({card}): graph "
                  f"{r['graph_ms']:.4f} ms, eager {r['eager_ms']:.4f} ms a "
                  f"batch (host clock, rows back on the host); device time "
                  f"{r['graph_device_ms']:.4f} / {r['eager_device_ms']:.4f} "
                  f"ms", flush=True)
    return out


def _capture_or_error(srv, feat):
    """``srv.warmup`` (the caller runs it on a fresh thread); the error, or
    None."""
    try:
        srv.warmup(feat, "float32")
    except Exception as e:   # noqa: BLE001 — raised on the caller's thread
        return e
    return None


def model_server_main(seed, card):
    """The ModelServer phase on ``fused_resnet50_v1``: 1000 classes,
    224x224, weights drawn from ``seed``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    net = get_model("fused_resnet50_v1", classes=1000).initialize(
        "xavier", ctx=ctx)
    out = model_server_phase(seed, card, net, ctx)
    if out["per_pass"] != 52:
        raise AssertionError("fused_resnet50_v1 runs 52 fused convs a pass")
    return out


# ---------------------------------------------------------------------------
# registry phase: three full-width models behind one ModelRegistry and one
# memory budget, weight hot-swap under load, the artifact warm start
# ---------------------------------------------------------------------------
# open-loop Poisson traffic during the hot-swap (the ModelServer phase's
# middle fp32 rate)
REGISTRY_RATE = 400.0
REGISTRY_RATE_S = 2.0
REGISTRY_IMAGES = 64
REGISTRY_GPT = dict(max_slots=8, max_len=512)
# the decode streams' prompt lengths and new tokens; the in-flight request's
REGISTRY_PROMPTS = (9, 40, 200)
REGISTRY_NEW = 24
REGISTRY_LONG = 400
# an eviction gives back what the model's admission took, within this share
EVICT_SLACK = 0.05


def _allocated(dev):
    """Bytes allocated on the card after a collection (0 on the CPU)."""
    gc.collect()
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def _memory_hooks(reg, dev, log):
    """Record around each admission and eviction of ``reg`` what the card
    has allocated: ``log["admit"][name]`` the bytes the latest admission
    took, ``log["evict"]`` ``(name, bytes given back, models in flight)``
    in order."""
    admit, evict = reg._admit, reg._evict_locked

    def hooked_admit(entry):
        a0 = _allocated(dev)
        admit(entry)
        log["admit"][entry.name] = _allocated(dev) - a0

    def hooked_evict(entry):
        busy = sorted(e.name for e in reg._entries.values()
                      if e.in_flight > 0)
        a0 = _allocated(dev)
        evict(entry)
        log["evict"].append((entry.name, a0 - _allocated(dev), busy))

    reg._admit, reg._evict_locked = hooked_admit, hooked_evict


def _register_models(reg, seed, ctx, feat, buckets, make_resnet, make_gpt,
                     gpt_kw):
    """The three models; each builder makes its block from ``seed``, so an
    eviction frees the parameters too and a re-admission draws the same
    weights."""
    from incubator_mxnet_tpu_torch import serving

    def server(name, cast=None):
        def build(ad):
            net = make_resnet(seed)
            if cast is not None:
                net.cast(cast)
            srv = serving.ModelServer(net, buckets=buckets, max_wait_ms=2.0,
                                      max_queue=4 * buckets[-1], ctx=ctx,
                                      artifact_dir=ad, name=name)
            srv.block = net               # for the eager references here
            return srv
        return build

    warm = lambda srv: srv.warmup(feat, "float32")   # noqa: E731
    reg.register("resnet_fp32", server("resnet_fp32"), warmup=warm)
    reg.register("resnet_bf16", server("resnet_bf16", "bfloat16"),
                 warmup=warm)
    reg.register("gpt", lambda ad: serving.DecodeSession(
        make_gpt(seed), ctx=ctx, artifact_dir=ad, name="gpt", **gpt_kw),
        kind="decode", warmup=lambda s: s.warmup())


def _check_eviction(label, log, name, footprint):
    """The latest eviction of ``name`` gave back what its admission took,
    within ``EVICT_SLACK``."""
    back = [b for n, b, _ in log["evict"] if n == name][-1]
    print(f"{label}: evicting {name} gave back {back / 2**20:.1f} MiB of "
          f"the {footprint / 2**20:.1f} MiB its admission took "
          f"(memory_allocated)", flush=True)
    if abs(back - footprint) > EVICT_SLACK * footprint:
        raise AssertionError(f"{label}: eviction of {name} gave back {back} "
                             f"bytes, its admission took {footprint}")


def _serve_via(reg, model, images, clients):
    """``images`` as single-image requests through ``reg`` from
    ``clients`` threads: the rows in order and the batches they took."""
    from concurrent.futures import ThreadPoolExecutor

    m = reg.server(model).metrics
    b0 = m.batches
    with ThreadPoolExecutor(max_workers=clients) as pool:
        futs = list(pool.map(lambda x: reg.submit(model, x), images))
    rows = np.stack([f.result(300) for f in futs])
    return rows, m.batches - b0


def _swap_under_load(reg, srv, images, rate, seconds, new, seed):
    """Open-loop traffic at ``rate`` through ``reg`` while another thread
    publishes ``new`` into ``srv`` (resident in ``reg``) at 40% of the run.
    Every executed batch is logged (its images by index, its rows); each
    accepted request keeps its submit time and future. Returns the log,
    the requests, the publish's times and stats, the run's result."""
    import threading

    # a row is known by its first pixels (the images are random): a key
    # this cheap keeps the logging off the worker's time
    def key(row):
        return row.reshape(-1)[:8].tobytes()

    index = {key(images[i]): i for i in range(len(images))}
    if len(index) != len(images):
        raise AssertionError("two images share their first pixels")
    cache, log = srv._cache, []

    def logged(batch):
        out = cache(batch)
        log.append(([index[key(r)] for r in batch], out))
        return out

    requests, pub = [], {}

    def fire(i):
        t = time.perf_counter()
        fut = reg.submit("resnet_fp32", images[i % len(images)])
        req = [i % len(images), t, fut, None]
        requests.append(req)
        fut.add_done_callback(
            lambda f, r=req: r.__setitem__(3, time.perf_counter()))
        return fut

    def publish():
        time.sleep(0.4 * seconds)
        pub["t0"] = time.perf_counter()
        pub["stats"] = reg.publish_weights("resnet_fp32", new)
        pub["t1"] = time.perf_counter()

    srv._batcher._runner = logged
    try:
        t = threading.Thread(target=publish)
        t.start()
        res = open_loop(fire, rate, seconds, seed=seed)
        t.join(60)
    finally:
        srv._batcher._runner = cache
    return log, requests, pub, res


def _versions_of_batches(log, net_v0, net_v1, images, dev, buckets):
    """Each logged batch's rows against the eager forward of the same padded
    batch under version 0 and version 1, bit for bit: the version it
    equals (0 or 1); a batch equal to neither raises (a mix, or a wrong
    row)."""
    seen, versions = {}, []
    for idx, rows in log:
        key = tuple(idx)
        if key not in seen:
            b = min(bk for bk in buckets if bk >= len(idx))
            padded = np.zeros((b,) + images.shape[1:], np.float32)
            padded[:len(idx)] = images[list(idx)]
            seen[key] = [_eager_rows(net, padded, dev)[:len(idx)]
                         for net in (net_v0, net_v1)]
        got = torch.from_numpy(rows)
        match = [v for v, want in enumerate(seen[key])
                 if torch.equal(got, want)]
        if len(match) != 1:
            raise AssertionError(f"a batch of {len(idx)} served rows equal "
                                 f"to versions {match} of its eager forward")
        versions.append(match[0])
    return versions


def registry_phase(seed, card, ctx, make_resnet, make_gpt, hw=224,
                   buckets=SERVER_BUCKETS, rate=REGISTRY_RATE,
                   rate_s=REGISTRY_RATE_S, n_images=REGISTRY_IMAGES,
                   gpt_kw=REGISTRY_GPT, prompt_lens=REGISTRY_PROMPTS,
                   new_tokens=REGISTRY_NEW, long_tokens=REGISTRY_LONG,
                   clients=SERVER_CLIENTS, warm_start=True):
    """Three models behind one ``serving.ModelRegistry``, as the module
    docstring's registry phase says: ``make_resnet(seed)`` makes the fused
    ResNet (fp32, on ``ctx``; one instance is cast to bf16),
    ``make_gpt(seed)`` the GPT. Returns the phase's numbers."""
    import os
    import tempfile

    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = ctx.torch_device()
    on_card = dev.type == "cuda"
    feat = (3, hw, hw)
    rs = np.random.RandomState(seed + 61)
    images = rs.rand(n_images, *feat).astype(np.float32)
    xb = images[:min(8, buckets[-1])]
    tmp = tempfile.TemporaryDirectory(prefix="mxtpu_registry_")
    art = os.path.join(tmp.name, "artifacts")
    out = {}

    # -- first residency of each model: its size and reference outputs -------
    log = {"admit": {}, "evict": []}
    with serving.ModelRegistry(artifact_dir=art, name="probe") as reg:
        _register_models(reg, seed, ctx, feat, buckets, make_resnet,
                         make_gpt, gpt_kw)
        _memory_hooks(reg, dev, log)
        ref32 = reg.server("resnet_fp32")._cache(xb)
        ref16 = reg.server("resnet_bf16")._cache(xb)
        vocab = reg.server("gpt")._block.vocab_size
        sizes = {n: e.bytes for n, e in reg._entries.items()}
    first = dict(log["admit"])
    prompts = [rs.randint(0, vocab, (n,)).astype(np.int32)
               for n in prompt_lens]
    budget = sum(sizes.values()) - min(sizes.values()) // 2
    print(f"registry ({card}): resident_bytes (parameters, KV cache, graph "
          f"memory) {({n: round(b / 2**20, 1) for n, b in sizes.items()})} "
          f"MiB; allocated by each admission "
          f"{({n: round(b / 2**20, 1) for n, b in first.items()})} MiB; "
          f"budget {budget / 2**20:.1f} MiB (any two fit, not three)",
          flush=True)

    log = {"admit": {}, "evict": []}
    reg = serving.ModelRegistry(budget_bytes=budget, artifact_dir=art,
                                name="lru")
    try:
        _register_models(reg, seed, ctx, feat, buckets, make_resnet,
                         make_gpt, gpt_kw)
        _memory_hooks(reg, dev, log)
        # -- fp32 traffic: K1 52 a batch on f32 ---------------------------
        route32 = conv_routes_expected(torch.float32)["fused_conv"]
        srv = reg.server("resnet_fp32")
        per_pass = convs_per_pass(srv.block)
        if not torch.equal(torch.from_numpy(srv._cache(xb)),
                           torch.from_numpy(ref32)):
            raise AssertionError("fp32: a second residency serves other "
                                 "rows than the first")
        _reset_conv_launches()
        rows, batches32 = _serve_via(reg, "resnet_fp32", images, clients)
        launches32, routes32 = _conv_launches(), _route_launches()
        _check_server_launches("registry fp32 traffic", launches32,
                               per_pass, batches32, routes32, route32)
        if not np.isfinite(rows).all():
            raise AssertionError("registry fp32 rows not finite")
        del srv          # a server the caller holds keeps its model's memory
        # -- gpt: K4 12 a decode step on split ----------------------------
        sess = reg.server("gpt")
        steps0 = sess.stats()["steps"]
        _reset_launches(fa)
        streams = [h.result(600) for h in
                   [reg.submit("gpt", p, max_new_tokens=new_tokens)
                    for p in prompts]]
        steps = sess.stats()["steps"] - steps0
        fwd_routes = _fwd_route_counts(fa)
        want_routes = decode_routes(sess.prefill_buckets, prompt_lens, steps)
        print(f"registry gpt: {len(prompts)} streams, {steps} decode steps; "
              f"flash_fwd launches by route {fwd_routes} (want "
              f"{want_routes}: 12 a step on split)", flush=True)
        if on_card and fwd_routes != want_routes:
            raise AssertionError("registry gpt: K4 launches by route "
                                 f"{fwd_routes} != {want_routes}")
        block = sess._block
        for p, s in zip(prompts, streams):
            n = oracle_check(block, p, s, dev)
            print(f"registry gpt oracle: prompt {len(p)} tokens matched {n} "
                  f"of {len(s)}", flush=True)
        # -- bf16: the third model evicts the LRU idle one (fp32) --------
        route16 = conv_routes_expected(torch.bfloat16)["fused_conv"]
        reg.server("resnet_bf16")      # the admission (its warm-ups count)
        _reset_conv_launches()
        rows16, batches16 = _serve_via(reg, "resnet_bf16", images, clients)
        launches16, routes16 = _conv_launches(), _route_launches()
        _check_server_launches("registry bf16 traffic", launches16,
                               per_pass, batches16, routes16, route16)
        resident = sorted(reg.resident_models())
        print(f"registry: admitting resnet_bf16 left {resident} resident "
              f"({reg.resident_bytes() / 2**20:.1f} MiB of "
              f"{budget / 2**20:.1f}); evictions {reg.metrics.evictions}; "
              f"bf16 rows equal to the first residency's "
              f"{bool(np.array_equal(reg.server('resnet_bf16')._cache(xb), ref16))}",
              flush=True)
        if resident != ["gpt", "resnet_bf16"] or reg.metrics.evictions != 1 \
                or not np.isfinite(rows16).all():
            raise AssertionError("registry: the LRU idle model was not the "
                                 "one evicted")
        _check_eviction("registry", log, "resnet_fp32",
                        log["admit"]["resnet_fp32"])
        # -- a model in flight is never evicted, even the LRU one ---------
        h = reg.submit("gpt", prompts[0], max_new_tokens=long_tokens)
        next(iter(h))
        reg.predict("resnet_bf16", images[0])          # gpt is the LRU now
        t0 = time.perf_counter()
        srv = reg.server("resnet_fp32")                 # re-admission
        readmit_s = time.perf_counter() - t0
        victim, _, busy = log["evict"][-1]
        streamed = len(h.result(600))
        hits, builds = srv.metrics.artifact_hits, srv.metrics.compiles
        print(f"registry: re-admitting resnet_fp32 ({readmit_s:.2f} s, "
              f"{hits} signatures from the artifact store, {builds} kernel "
              f"builds, {srv.metrics.captures} captures) evicted {victim} "
              f"while {busy} was in flight (the least recently used); the "
              f"in-flight stream finished with {streamed} tokens",
              flush=True)
        if victim != "resnet_bf16" or busy != ["gpt"] \
                or streamed != long_tokens or builds:
            raise AssertionError("registry: in-flight eviction check failed")
        _check_eviction("registry", log, "resnet_bf16",
                        log["admit"]["resnet_bf16"])
        if not torch.equal(torch.from_numpy(srv._cache(xb)),
                           torch.from_numpy(ref32)):
            raise AssertionError("fp32: the re-admission serves other rows "
                                 "than the first residency")
        print("registry: resnet_fp32's re-admission serves rows bit-equal "
              "to its first residency", flush=True)

        # -- hot-swap under load ------------------------------------------
        net_v0 = make_resnet(seed)
        net_v1 = make_resnet(seed + 1)
        new = {n: p.detach() for n, p in net_v1.named_parameters()}
        base = open_loop(lambda i: reg.submit("resnet_fp32",
                                              images[i % n_images]),
                         rate, rate_s, seed=seed)
        _reset_conv_launches()
        b0 = srv.metrics.batches
        swap_log, requests, pub, res = _swap_under_load(
            reg, srv, images, rate, rate_s, new, seed + 1)
        swap_batches = srv.metrics.batches - b0
        launches_swap, routes_swap = _conv_launches(), _route_launches()
        _check_server_launches("registry fp32 swap traffic", launches_swap,
                               per_pass, swap_batches, routes_swap, route32)
        versions = _versions_of_batches(swap_log, net_v0, net_v1, images,
                                        dev, buckets)
        order = [i for idx, _ in swap_log for i in idx]
        per_request = [v for (idx, _), v in zip(swap_log, versions)
                       for _ in idx]
        if order != [r[0] for r in requests] or res["errors"] \
                or res["rejected"] or res["shed"]:
            raise AssertionError(f"hot-swap: requests {len(requests)}, rows "
                                 f"{len(order)}, {res['errors']} errors, "
                                 f"{res['rejected']} refused")
        flat = [row for _, rows_ in swap_log for row in rows_]
        for (k, t, fut, _), v, row in zip(requests, per_request, flat):
            if not np.array_equal(fut.result(0), row):
                raise AssertionError("hot-swap: a response differs from its "
                                     "batch's row")
            if t > pub["t1"] and v != 1:
                raise AssertionError("hot-swap: a request submitted after "
                                     "publish_weights returned got version 0")
        # the swap window: from the publish's start to 0.25 s after it
        # returned
        swap_lats = [done - t for _, t, _, done in requests
                     if pub["t0"] <= t <= pub["t1"] + 0.25]
        n1 = sum(per_request)
        stats = pub["stats"]
        commit_ms = srv._cache.last_commit_ms
        p99_swap = _pctl_ms(swap_lats, 99)
        p99_base = _pctl_ms(base["lats"], 99)
        print(f"hot-swap under load ({card}): {res['completed']} requests at "
              f"{rate:g} requests/s offered ({rate_s:g} s, Poisson), 0 "
              f"failed, {len(swap_log)} batches each bit-equal to one "
              f"version's eager forward ({len(order) - n1} rows version 0, "
              f"{n1} version 1; every request submitted after the publish "
              f"returned: version 1); publish {stats['seconds']:.4f} s "
              f"(updated {stats['updated']}, aliased {stats['aliased']}, "
              f"carried {stats['carried']} of {stats['params']}), the "
              f"commit held the replay lock {commit_ms:.3f} ms; p99 in the "
              f"swap window {p99_swap:.3f} ms ({len(swap_lats)} requests) "
              f"beside p99 {p99_base:.3f} ms without a swap, p50 "
              f"{_pctl_ms(base['lats'], 50):.3f} ms", flush=True)
        for b in buckets:
            x = np.resize(images, (b,) + feat)
            if not torch.equal(torch.from_numpy(srv._cache(x)),
                               _eager_rows(srv.block, x, dev)):
                raise AssertionError(f"bucket {b}: the replay after the swap "
                                     "differs from the eager forward on the "
                                     "new weights")
        if not torch.equal(torch.from_numpy(srv._cache(xb)),
                           _eager_rows(net_v1, xb, dev)):
            raise AssertionError("the served weights are not version 1's")
        print("hot-swap: every bucket's replay after the swap bit-equal to "
              "the eager forward on the new weights (no parameter rebound)",
              flush=True)
        del net_v0, net_v1, new, srv

        # -- decode swap: streams per version against their oracles -------
        sess = reg.server("gpt")
        p = prompts[1]
        s0 = reg.generate("gpt", p, max_new_tokens=new_tokens)
        m0 = oracle_check(sess._block, p, s0, dev)
        h = reg.submit("gpt", prompts[0], max_new_tokens=64)
        next(iter(h))
        gpt_v1 = make_gpt(seed + 1)
        dstats = reg.publish_weights(
            "gpt", {n: q.detach() for n, q in gpt_v1.named_parameters()})
        del gpt_v1
        crossed = len(h.result(600))
        s1 = reg.generate("gpt", p, max_new_tokens=new_tokens)
        m1 = oracle_check(sess._block, p, s1, dev)
        print(f"decode swap: version 0 stream matched its oracle for {m0} "
              f"of {len(s0)} tokens, version 1 (admitted after the flip) "
              f"{m1} of {len(s1)}; streams differ {s0 != s1}; the sequence "
              f"in flight across the flip finished ({crossed} tokens); "
              f"publish {dstats['seconds']:.4f} s, weights_version "
              f"{sess.weights_version}", flush=True)
        if crossed != 64 or sess.weights_version != 1:
            raise AssertionError("decode swap failed")

        # -- deferred publish: applied at the next admission --------------
        if "resnet_bf16" in reg.resident_models():
            reg.evict("resnet_bf16")
        net16 = make_resnet(seed + 1).cast("bfloat16")
        new16 = {n: q.detach() for n, q in net16.named_parameters()}
        deferred = reg.publish_weights("resnet_bf16", new16)
        srv16 = reg.server("resnet_bf16")
        blk16 = srv16.block
        same = all(torch.equal(q, new16[n])
                   for n, q in blk16.named_parameters())
        x = np.resize(images, (buckets[-1],) + feat)
        replay_ok = torch.equal(torch.from_numpy(srv16._cache(x)),
                                _eager_rows(net16, x, dev))
        print(f"deferred publish: {deferred} while resnet_bf16 was evicted; "
              f"its next admission serves weights_version "
              f"{srv16.weights_version}, every parameter equal to version 1 "
              f"{same}, a replay bit-equal to version 1's eager forward "
              f"{replay_ok}", flush=True)
        if not deferred.get("deferred") or srv16.weights_version != 1 \
                or not same or not replay_ok:
            raise AssertionError("deferred publish failed")
        del net16, new16, blk16, srv16
        out["stats"] = reg.stats()
        print(f"registry stats: "
              f"{ {k: v for k, v in out['stats'].items() if k != 'models'} }",
              flush=True)
    finally:
        reg.close()
    del sess, block

    out.update(
        sizes=sizes, budget=budget, admit_bytes=first,
        evictions=list(log["evict"]),
        conv_launches={"fp32": launches32, "bf16": launches16,
                       "swap": launches_swap},
        conv_routes={k: sum(r[k] for r in (routes32, routes16, routes_swap))
                     for k in routes32},
        fwd_routes=fwd_routes, decode_steps=steps,
        swap=dict(publish_s=stats["seconds"], commit_ms=commit_ms,
                  p99_swap_ms=p99_swap, p99_base_ms=p99_base,
                  requests=res["completed"], batches=len(swap_log),
                  v1_rows=n1, readmit_s=readmit_s))
    if warm_start:
        out["warm_start"] = artifact_warm_start(seed, card, ctx, make_resnet,
                                                hw, buckets, ref32, xb, tmp)
    tmp.cleanup()
    return out


def _run_child(mode, seed, artifact_dir, kernel_dir, out_path):
    """``chip_smoke.py --warm-start-child`` in a fresh process with its own
    (empty) kernel build directory: (its JSON report, wall seconds)."""
    import os

    env = dict(os.environ, MXTPU_KERNEL_BUILD_DIR=kernel_dir)
    cmd = [sys.executable, str(Path(__file__).resolve()),
           "--warm-start-child", mode, "--artifact-dir", artifact_dir,
           "--out", out_path, "--seed", str(seed)]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"warm-start child ({mode}) exited "
                             f"{done.returncode}:\n{done.stdout[-3000:]}\n"
                             f"{done.stderr[-3000:]}")
    line = [ln for ln in done.stdout.splitlines()
            if ln.startswith('{"warm_start"')][-1]
    return json.loads(line)["warm_start"], wall


def artifact_warm_start(seed, card, ctx, make_resnet, hw, buckets, ref, xb,
                        tmp):
    """The fp32 ResNet's replica start three ways: cold (a new process, an
    empty kernel build directory and an empty artifact store: ``nvcc``
    builds what the graphs launch, and the store is filled), warm (a new
    process, another empty build directory, the store filled: the
    libraries are installed, no ``nvcc`` runs) and recapture-only (this
    process, every library loaded: the captures alone). Both children's
    rows bit-equal to ``ref``, this process's first residency."""
    import os

    from incubator_mxnet_tpu_torch import serving

    store = os.path.join(tmp.name, "replica_store")
    report = {}
    for mode in ("cold", "warm"):
        out_path = os.path.join(tmp.name, f"{mode}.npy")
        rep, wall = _run_child(mode, seed, store,
                               os.path.join(tmp.name, f"kernels_{mode}"),
                               out_path)
        rows = np.load(out_path)
        rep.update(wall_s=wall, bit_equal=bool(np.array_equal(rows, ref)))
        report[mode] = rep
        print(f"artifact {mode} start ({card}): process wall {wall:.2f} s, "
              f"ModelServer ready {rep['ready_s']:.2f} s after the script's "
              f"start (warm-up {rep['warmup_s']:.2f} s); nvcc builds "
              f"{rep['nvcc_builds']} ({rep['build_seconds']:.2f} s), "
              f"signatures from the store {rep['artifact_hits']}, captures "
              f"{rep['captures']}, libraries {rep['libraries']}; rows "
              f"bit-equal to this process's {rep['bit_equal']}", flush=True)
        if not rep["bit_equal"]:
            raise AssertionError(f"artifact {mode} start: rows differ")
    if report["warm"]["nvcc_builds"] or report["warm"]["compiles"] \
            or report["warm"]["artifact_hits"] != len(buckets) \
            or not report["cold"]["nvcc_builds"]:
        raise AssertionError(f"artifact warm start: {report}")
    net = make_resnet(seed)
    t0 = time.perf_counter()
    srv = serving.ModelServer(net, buckets=buckets, ctx=ctx,
                              artifact_dir="", name="recapture")
    srv.warmup((3, hw, hw), "float32")
    report["recapture_s"] = time.perf_counter() - t0
    same = np.array_equal(srv._cache(xb), ref)
    srv.close()
    srv.release()
    del srv, net
    print(f"recapture-only start ({card}): {report['recapture_s']:.2f} s "
          f"for {len(buckets)} captures with every library loaded; rows "
          f"bit-equal {same}", flush=True)
    if not same:
        raise AssertionError("recapture-only start: rows differ")
    return report


def warm_start_child(seed, mode, artifact_dir, out_path):
    """One replica start (``--warm-start-child``): the fp32 fused ResNet-50
    behind a ``ModelServer`` on ``artifact_dir``, warmed, its rows of the
    registry phase's first images saved to ``out_path``; prints one
    ``{"warm_start": {...}}`` line."""
    t0 = time.perf_counter()
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import serving
    from incubator_mxnet_tpu_torch.ops import _build

    ctx = mx.gpu(0)
    net = _fused_resnet_maker(ctx)(seed)
    images = np.random.RandomState(seed + 61).rand(
        8, 3, 224, 224).astype(np.float32)
    srv = serving.ModelServer(net, buckets=SERVER_BUCKETS, ctx=ctx,
                              artifact_dir=artifact_dir, name="resnet_fp32")
    t1 = time.perf_counter()
    with _build.recorded() as rec:
        srv.warmup((3, 224, 224), "float32")
    t2 = time.perf_counter()
    np.save(out_path, srv._cache(images))
    m = srv.metrics
    srv.close()
    print(json.dumps({"warm_start": {
        "mode": mode, "ready_s": t2 - t0, "warmup_s": t2 - t1,
        "nvcc_builds": _build.builds, "build_seconds": rec["build_seconds"],
        "compiles": m.compiles, "captures": m.captures,
        "artifact_hits": m.artifact_hits,
        "artifact_misses": m.artifact_misses,
        "libraries": sorted(rec["loaded"])}}), flush=True)
    return 0


def _fused_resnet_maker(ctx, classes=1000):
    """``make(seed)``: ``fused_resnet50_v1`` drawn from ``seed`` on
    ``ctx``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    def make(seed):
        mx.random.seed(seed)
        return get_model("fused_resnet50_v1", classes=classes).initialize(
            "xavier", ctx=ctx)

    return make


def registry_main(seed, card):
    """The registry phase at full width: ``fused_resnet50_v1`` (1000
    classes, 224x224) in fp32 and in bf16, ``gpt_decoder_117m`` with 8
    slots and a 512-token cache; weights drawn from ``seed`` (version 1
    from ``seed + 1``)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    ctx = mx.gpu(0)

    def make_gpt(s):
        mx.random.seed(s)
        return get_gpt("gpt_decoder_117m", dropout=0.0).initialize(
            "xavier", ctx=ctx)

    return registry_phase(seed, card, ctx, _fused_resnet_maker(ctx),
                          make_gpt)


# ---------------------------------------------------------------------------
# unfused ResNet phase: the zoo resnet50_v1 of the gluon layer set (bench.py's
# resnet50 row), and the MLP phase (bench.py's mlp row)
# ---------------------------------------------------------------------------
# the unfused model against the fused one, fp32, same weights: eval logits,
# the training loss and the running statistics (relative), each gradient
# (relative L2: the JAX package's own bound between the two models on a
# chip, tests/test_fused_resnet.py)
UNFUSED_TOL = 1e-4
UNFUSED_GRAD_RTOL = 5e-2
# batch sizes of the unfused phase: the parity check, the learning check,
# the bench row
UNFUSED_BATCHES = (8, 16, 128)


def zoo_to_fused(zoo, fused):
    """Set ``fused``'s parameters (NHWC/HWIO) to ``zoo``'s (NCHW/OIHW), on
    the device, as the JAX package's ``tests/test_fused_resnet.py``
    ``_build_pair`` maps them: the two inventories in order, conv weights
    OIHW -> HWIO. Returns the pairs of names."""
    zp = list(_param_tensors(zoo).items())
    fp = list(_param_tensors(fused).items())
    if len(zp) != len(fp):
        raise AssertionError(f"{len(zp)} zoo tensors against {len(fp)} "
                             "fused ones")
    with torch.no_grad():
        for (zn, z), (fn, f) in zip(zp, fp):
            v = z.detach().permute(2, 3, 1, 0) if z.dim() == 4 \
                else z.detach()
            if tuple(v.shape) != tuple(f.shape):
                raise AssertionError(f"{zn} {tuple(z.shape)} does not map "
                                     f"to {fn} {tuple(f.shape)}")
            fused.set_param(fn, v.contiguous().clone())
    return [(zn, fn) for (zn, _), (fn, _) in zip(zp, fp)]


def unfused_parity(zoo, fused, ce, x, y):
    """One fp32 training step of ``zoo`` and of ``fused`` (its weights
    mapped from ``zoo``'s) from the same state: the loss and every running
    statistic within ``UNFUSED_TOL`` (largest difference over the largest
    value), every gradient within ``UNFUSED_GRAD_RTOL`` relative L2; then
    a training-mode forward of each at BatchNorm momentum 0 (the running
    statistics become this batch's) and the eval logits within
    ``UNFUSED_TOL`` relative L2. The zoo model's passes launch no fused conv kernel.
    Returns the worst distances."""
    import incubator_mxnet_tpu_torch as mx

    pairs = zoo_to_fused(zoo, fused)
    zps, fps = _param_tensors(zoo), _param_tensors(fused)
    out = {}
    _reset_conv_launches()
    for net in (zoo, fused):
        with mx.autograd.record():
            loss = ce(net(x), y).mean()
        loss.backward()
        out[net] = loss.item()
        if net is zoo:
            zoo_launches = _conv_launches()
    loss_err = abs(out[zoo] - out[fused]) / abs(out[fused])
    stats, grads = (0.0, ""), (0.0, "")
    n_stats = n_grads = 0
    for zn, fn in pairs:
        z, f = zps[zn], fps[fn]
        if z.requires_grad:
            g = f.grad.permute(3, 2, 0, 1) if f.dim() == 4 else f.grad
            grads = max(grads, (_rel_l2(z.grad, g), zn))
            n_grads += 1
        else:
            stats = max(stats, (_rel_l2(z.detach(), f.detach()), zn))
            n_stats += 1
    momenta = {m: m._momentum for net in (zoo, fused)
               for m in net.modules() if hasattr(m, "_momentum")}
    try:
        for m in momenta:
            m._momentum = 0.0
        with torch.no_grad(), mx.autograd.train_mode():
            zoo(x), fused(x)
    finally:
        for m, v in momenta.items():
            m._momentum = v
    with mx.autograd.pause():
        logits_err = _rel_l2(zoo(x), fused(x))
    res = dict(loss=out[zoo], fused_loss=out[fused], loss_err=loss_err,
               stats_worst=stats[0], stats_worst_name=stats[1],
               grad_worst=grads[0], grad_worst_name=grads[1],
               eval_logits_err=logits_err, n_trainable=n_grads,
               n_running_stats=n_stats, zoo_launches=zoo_launches)
    print(f"unfused vs fused (fp32, B={x.shape[0]}, same weights): loss "
          f"{out[zoo]:.6f} vs {out[fused]:.6f} (relative {loss_err:.3e}); "
          f"worst of the {n_stats} running statistics {stats[0]:.3e} "
          f"relative L2 ({stats[1]}), tol {UNFUSED_TOL:g}; worst of the "
          f"{n_grads} "
          f"gradients {grads[0]:.3e} relative L2 ({grads[1]}), tol "
          f"{UNFUSED_GRAD_RTOL:g}; eval logits {logits_err:.3e} relative "
          f"L2, tol "
          f"{UNFUSED_TOL:g}; fused conv launches over the unfused passes "
          f"{zoo_launches}", flush=True)
    if not (loss_err <= UNFUSED_TOL and stats[0] <= UNFUSED_TOL
            and logits_err <= UNFUSED_TOL and grads[0] <= UNFUSED_GRAD_RTOL
            and math.isfinite(out[zoo])):
        raise AssertionError("the unfused ResNet disagrees with the fused "
                             "one")
    if any(zoo_launches.values()):
        raise AssertionError("the unfused ResNet launched a fused conv "
                             f"kernel: {zoo_launches}")
    for net in (zoo, fused):
        for p in net.parameters():
            p.grad = None
    return res


def _bench_steps(st, x, y, steps=5, warmup=2):
    """Host-clock ms per ``st.step`` over ``steps`` after ``warmup``, and
    the peak memory of those steps."""
    for _ in range(warmup):
        st.step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [st.step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not all(torch.isfinite(v) for v in losses):
        raise AssertionError("bench row: loss not finite")
    return step_ms, torch.cuda.max_memory_allocated(), \
        [float(v) for v in losses]


def _idle(rows, step_ms):
    total = sum(r[0] for r in rows)
    return None if total == 0 else max(0.0, 1 - total / step_ms)


def unfused_resnet_phase(seed, card, net, fused, ctx, hw=224,
                         batches=UNFUSED_BATCHES):
    """Drive ``net`` (the zoo ``resnet50_v1`` from ``unfused_resnet_main``,
    initialized on ``ctx``, deferred shapes filled) as the module
    docstring says: the parity check against ``fused`` (a fused ResNet of
    the same architecture), the fp32 learning check through
    ``gluon.Trainer(..., kvstore="device")``, then bench.py's resnet50 row
    in bf16 (NCHW, then the activations and conv weights in
    ``torch.channels_last`` memory format). No fused conv kernel may
    launch on the unfused passes."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel

    dev = ctx.torch_device()
    b_parity, b_train, b_bench = batches
    classes = net.output.weight.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 53)

    def batch(b):
        x = torch.rand((b, 3, hw, hw), generator=gen, device=dev)
        y = torch.randint(0, classes, (b,), generator=gen, device=dev)
        return x, y.float()

    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    parity = unfused_parity(net, fused, ce, *batch(b_parity))

    # the fp32 learning check: eager record -> backward -> gluon.Trainer
    _reset_conv_launches()
    x, y = batch(b_train)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9},
                            kvstore="device")
    losses = []
    for _ in range(6):
        with mx.autograd.record():
            per_sample = ce(net(x), y)
        mx.autograd.backward(per_sample)
        trainer.step(x.shape[0])
        losses.append(float(per_sample.detach().mean()))
    print(f"unfused learning check (fp32 gluon.Trainer kvstore='device', "
          f"B={b_train}, sgd lr 0.01 momentum 0.9, one batch repeated): "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("the unfused loss did not fall by 5% over 5 "
                             "steps")
    del trainer
    _check_launches("unfused fp32 learning check", _conv_launches(), 0, 6,
                    6, _route_launches(), "f32")

    # bench.py's resnet50 row: bf16, SPMDTrainer SGD lr 0.1 momentum 0.9
    net.cast("bfloat16")
    gc.collect()
    x, y = batch(b_bench)
    x = x.to(torch.bfloat16)
    rows = {}
    _reset_conv_launches()
    for layout in ("nchw", "channels_last"):
        if layout == "channels_last":
            with torch.no_grad():
                for p in net.parameters():
                    if p.dim() == 4:
                        p.data = p.data.contiguous(
                            memory_format=torch.channels_last)
            x = x.contiguous(memory_format=torch.channels_last)
        st = parallel.SPMDTrainer(net, ce, "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9})
        step_ms, peak, bench_losses = _bench_steps(st, x, y)
        prof = _profile_step(st.step, x, y, card, step_ms, tags=(),
                             top=12, what=f"unfused bf16 step ({layout})")
        rows[layout] = dict(batch=b_bench, step_ms=step_ms,
                            images_s=b_bench / step_ms * 1e3,
                            peak_bytes=peak, idle=_idle(prof, step_ms),
                            device_ms=sum(r[0] for r in prof),
                            losses=bench_losses, profile=prof[:12])
        print(f"unfused bf16 SPMDTrainer step ({layout}, B={b_bench}, sgd "
              f"lr 0.1 momentum 0.9; {card}): {step_ms:.3f} ms per step "
              f"(host clock, 5 steps after 2 warmup), "
              f"{rows[layout]['images_s']:.1f} images/s, peak memory "
              f"{peak / 2**20:.1f} MiB", flush=True)
        del st
        gc.collect()
    _check_launches("unfused bf16 bench row (both layouts)", _conv_launches(),
                    0, 16, 16, _route_launches(), "tc")
    return dict(parity=parity, learning_losses=losses, bench=rows)


def unfused_resnet_main(seed, card):
    """The unfused phase on ``get_model("resnet50_v1", classes=1000)``,
    held against ``fused_resnet50_v1`` with the same weights."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_model

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    net = get_model("resnet50_v1", classes=1000).initialize("xavier",
                                                           ctx=ctx)
    with mx.autograd.pause():              # fills the deferred shapes
        net(torch.zeros(2, 3, 224, 224, device=ctx.torch_device()))
    ps = _param_tensors(net)
    counts = (sum(p.numel() for p in ps.values()),
              sum(p.requires_grad for p in ps.values()),
              sum(not p.requires_grad for p in ps.values()),
              sum(p.dim() == 4 for p in ps.values()))
    print(f"model resnet50_v1 (unfused, NCHW): {counts[0]} parameters "
          f"with the running statistics, {counts[1]} trainable tensors, "
          f"{counts[2]} running statistics, {counts[3]} convs", flush=True)
    if counts != (25_610_152, 161, 106, 53):
        raise AssertionError(f"resnet50_v1's inventory {counts}")
    fused = get_model("fused_resnet50_v1", classes=1000).initialize(
        "xavier", ctx=ctx)
    out = unfused_resnet_phase(seed, card, net, fused, ctx)
    out["inventory"] = counts
    return out


# bench.py's mlp row: B=8192, 784 -> 512 -> 512 -> 10
MLP_BATCH = 8192


def mlp_phase(seed, card, ctx, b=MLP_BATCH, steps=20):
    """bench.py's mlp row at one card: ``HybridSequential`` of
    ``Dense(512, activation="relu")`` twice and ``Dense(10)`` (no
    ``in_units``), ``initialize("xavier")``, ``cast("bfloat16")``, one
    forward of zeros that fills the deferred shapes, then
    ``SPMDTrainer`` SGD lr 0.1 momentum 0.9 on one batch of ``b`` uniform
    images whose labels a fixed random linear map of the image picks (a
    task the net can learn; the row's random labels fall under 5% in
    tens of steps): the loss must fall by 5% over ``steps`` steps; then
    timed (5 steps after 2 warmup)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.gluon import nn

    dev = ctx.torch_device()
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(512, activation="relu"),
            nn.Dense(512, activation="relu"), nn.Dense(10))
    net.initialize("xavier", ctx=ctx)
    net.cast("bfloat16")
    net(torch.zeros(2, 784, dtype=torch.bfloat16, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 61)
    x = torch.rand((b, 784), generator=gen, device=dev)
    proj = torch.randn((784, 10), generator=gen, device=dev)
    y = ((x - 0.5) @ proj).argmax(1).float()
    x = x.to(torch.bfloat16)
    st = parallel.SPMDTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              "sgd", {"learning_rate": 0.1, "momentum": 0.9})
    losses = [float(st.step(x, y)) for _ in range(steps)]
    print(f"MLP learning check (bf16 SPMDTrainer, B={b}, sgd lr 0.1 "
          f"momentum 0.9, one batch repeated): losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError(f"the MLP loss did not fall by 5% over "
                             f"{steps} steps")
    step_ms, peak, _ = _bench_steps(st, x, y)
    print(f"MLP bf16 SPMDTrainer step (B={b}, 784-512-512-10; {card}): "
          f"{step_ms:.4f} ms per step (host clock, 5 steps after 2 warmup), "
          f"{b / step_ms * 1e3:.1f} images/s, peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    prof = _profile_step(st.step, x, y, card, step_ms, tags=(), top=8,
                         what="MLP bf16 step")
    return dict(batch=b, learning_losses=losses, step_ms=step_ms,
                images_s=b / step_ms * 1e3, peak_bytes=peak,
                idle=_idle(prof, step_ms),
                device_ms=sum(r[0] for r in prof))


# ---------------------------------------------------------------------------
# graph phase: the step engines on CUDA graphs (parallel/superstep.py)
# ---------------------------------------------------------------------------
# window K of each row
GRAPH_K = {"mlp": 20, "gpt": 10, "bert": 5, "resnet50_fused": 5,
           "resnet50_unfused": 5}
# windows a row times after the one that captures
GRAPH_TIMED = 2


def _counts_by_name(counts):
    """``ops.launches`` counts keyed by counter name (``flash_fwd_tc``,
    ``conv_bwd_dw``, ...; ``rtc:<kernel>``), zeros left out."""
    return {(f"rtc:{name}" if mod == "rtc"
             else name[:-len("_launches")]): n
            for (mod, name), n in sorted(counts.items()) if n}


def _launch_delta(before):
    from incubator_mxnet_tpu_torch.ops import launches

    return _counts_by_name(launches.delta(before, launches.snapshot()))


def _worst_rel(pairs):
    """The largest relative L2 distance over ``(name, got, want)``."""
    worst = (0.0, "")
    for name, got, want in pairs:
        got, want = got.float(), want.float()
        den = want.norm().item()
        rel = (got - want).norm().item() / (den if den > 0 else 1.0)
        worst = max(worst, (rel, name))
    return worst


def _replay_span_ms(fn, *args):
    """Device time from the first to the last kernel of ``fn(*args)``
    (CUDA events on the current stream; the host waits after)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _check_graph_launches(label, per_step, expect):
    """Each counter of ``expect`` launched exactly so often a step."""
    for name, want in expect.items():
        if per_step.get(name, 0) != want:
            raise AssertionError(f"graph {label}: {name} launched "
                                 f"{per_step.get(name, 0)} times a "
                                 f"step, not {want}")


def _kernel_counts(rows, symbols):
    """Launches by CUDA function in ``_profile_step``'s rows (the
    profiler's own count: the kernels that ran on the card, inside a
    graph replay too), for each name of ``symbols``."""
    out = {}
    for sym in symbols:
        pat = re.compile(rf"(?<![\w]){re.escape(sym)}(?![\w])")
        out[sym] = sum(count for _, count, key in rows if pat.search(key))
    return out


def _check_profiled(label, rows, kernels, steps):
    """The profiler saw each CUDA function of ``kernels`` (name ->
    launches a step) launched exactly ``steps`` times as often."""
    got = _kernel_counts(rows, kernels)
    want = {sym: n * steps for sym, n in kernels.items()}
    print(f"profiled launches of {label}: {got} (want {want})", flush=True)
    if got != want:
        raise AssertionError(f"{label}: the profiler saw {got}, not {want}")


class ClockSampler:
    """The card's SM clock and power draw, sampled every ``ms`` by
    ``nvidia-smi`` in the background while the block runs; ``between(t0,
    t1)`` gives the median of the samples in a window of ``time.time()``
    (the timestamps are nvidia-smi's own, on the same clock). Without
    ``nvidia-smi`` there are no samples ("not measured")."""

    def __init__(self, ms=20):
        self.ms = ms
        self.samples = []
        self._proc = None

    def __enter__(self):
        import threading
        from datetime import datetime

        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", f"--loop-ms={self.ms}",
                 "-i", "0"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self

        def read():
            for line in self._proc.stdout:
                try:
                    ts, clk, watts = (f.strip() for f in line.split(","))
                    t = datetime.strptime(ts, "%Y/%m/%d %H:%M:%S.%f")
                    self.samples.append((t.timestamp(), float(clk),
                                         float(watts)))
                except ValueError:
                    continue

        self._reader = threading.Thread(target=read, daemon=True)
        self._reader.start()
        time.sleep(0.3)                 # nvidia-smi's first sample
        return self

    def __exit__(self, *exc):
        if self._proc is not None:
            time.sleep(2 * self.ms / 1e3)
            self._proc.terminate()
            try:
                self._proc.wait(5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._reader.join(5)
        return False

    def between(self, windows):
        """``(median SM MHz, median W, samples)`` over the samples inside
        any of ``windows`` (``(t0, t1)`` pairs), or None."""
        got = [(c, w) for t, c, w in self.samples
               if any(t0 <= t <= t1 for t0, t1 in windows)]
        if not got:
            return None
        return (float(np.median([c for c, _ in got])),
                float(np.median([w for _, w in got])), len(got))


def _clock_text(reading):
    if reading is None:
        return "SM clock not measured"
    mhz, watts, n = reading
    return f"SM clock {mhz:.0f} MHz at {watts:.1f} W (median of {n})"


# alternating eager and graph turns a row times, after the first window
GRAPH_ROUNDS = 5


def _batch_of(window, i):
    """Batch ``i`` of a stacked window: a tensor, or a list of them."""
    if isinstance(window, (list, tuple)):
        return [w[i] for w in window]
    return window[i]


def graph_row(label, make, wins, card, seed, expect, kernels=None,
              tags=()):
    """One row of the graph phase. ``make()`` gives a fresh
    ``SPMDTrainer`` (the same start state each call), ``wins`` at least
    ``1 + GRAPH_TIMED`` windows ``(data, labels)`` of K batches on the
    device (each a stacked tensor or a list of them); ``expect``: launch
    counter name -> launches a step;
    ``kernels``: CUDA function -> launches a step.

    From the same state and seed, K eager ``step()`` calls and one
    ``run_superstep`` (warm-up step, capture, one replay) on the first
    window: the [K] losses and every parameter and running statistic bit
    for bit. The launch counters: the K eager steps count ``expect`` a
    step; the capture records K steps' worth and counts nothing; the first
    ``run_superstep`` counts K + 1 steps (the warm-up ran), every later
    one K (each graph call's own counter change, measured around it and
    summed into ``launches``). Then ``GRAPH_ROUNDS`` alternating turns
    (K eager steps, one graph window) on the next windows give host ms a
    step, the median of each; the peak memory above what the row held
    before (the eager turn of the first round; the graph's first call);
    a profile (``torch.profiler``) of K eager steps and of one graph
    window: device time a step, idle share against the medians, and the
    profiler's own launch count of each of ``kernels`` (K a step in both:
    the kernels ran on the card); the SM clock and power of each kind of
    turn and profile (``ClockSampler``); the device span of a replay
    (CUDA events)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import launches

    kernels = kernels or {}
    x0, y0 = wins[0]
    k = int(_as_list(x0)[0].shape[0])
    eager = make()
    mx.random.seed(seed)
    c0 = launches.snapshot()
    ref = torch.stack([eager.step(_batch_of(x0, i), _batch_of(y0, i))
                       for i in range(k)])
    eager_counts = _launch_delta(c0)
    per_step = {n: c // k for n, c in eager_counts.items()}
    if any(c % k for c in eager_counts.values()):
        raise AssertionError(f"graph {label}: K={k} eager steps launched "
                             f"{eager_counts}, not K times a step's")
    _check_graph_launches(label, per_step, expect)

    graph = make()
    mx.random.seed(seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    total = {}

    def graph_call(fn, *args, windows=1, warm=0):
        """``fn(*args)``, its own launch counts gated (``windows`` graph
        windows and ``warm`` eager warm-up steps) and summed into
        ``total``."""
        c = launches.snapshot()
        out = fn(*args)
        got = _launch_delta(c)
        want = {n: v * (k * windows + warm) for n, v in per_step.items()}
        if got != want:
            raise AssertionError(f"graph {label}: a call of {windows} "
                                 f"window(s) and {warm} warm-up step(s) "
                                 f"launched {got}, not {want}")
        for n, v in got.items():
            total[n] = total.get(n, 0) + v
        return out

    t0 = time.perf_counter()
    got = graph_call(graph.run_superstep, x0, y0, warm=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated() - base
    entries = graph._graphs.graphs()
    capture_counts = _counts_by_name(entries[0].counted) if entries \
        else {}
    if entries and capture_counts != {n: v * k for n, v in
                                      per_step.items()}:
        raise AssertionError(f"graph {label}: the capture recorded "
                             f"{capture_counts}, not K={k} steps of "
                             f"{per_step}")

    equal = torch.equal(ref, got) and all(
        torch.equal(eager.params[n], graph.params[n]) for n in eager.params)
    worst = _worst_rel([("losses", got, ref)] + [
        (n, graph.params[n], eager.params[n]) for n in eager.params])
    print(f"graph {label}: K={k}, one run_superstep (warm-up, capture, one "
          f"replay) in {first_s:.2f} s; [K] losses and "
          f"{len(eager.params)} parameter tensors against K eager step() "
          f"calls: {'bit-equal' if equal else 'NOT bit-equal'} (worst "
          f"relative L2 {worst[0]:.3e}, {worst[1] or '-'}); launches a "
          f"step {per_step}, recorded by the capture {capture_counts}",
          flush=True)
    if not equal:
        raise AssertionError(f"graph {label}: the graph path is not "
                             f"bit-equal to K eager steps ({worst})")

    timed = wins[1:1 + GRAPH_TIMED]
    turns = {"eager": [], "graph": []}
    spans = {"eager": [], "graph": [], "eager_profile": [],
             "graph_profile": []}
    eager_peak = 0
    with ClockSampler() as clocks:
        for r in range(GRAPH_ROUNDS):
            x, y = timed[r % len(timed)]
            torch.cuda.synchronize()
            if r == 0:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            w0, t0 = time.time(), time.perf_counter()
            for i in range(k):
                eager.step(_batch_of(x, i), _batch_of(y, i))
            torch.cuda.synchronize()
            turns["eager"].append((time.perf_counter() - t0) * 1e3 / k)
            spans["eager"].append((w0, time.time()))
            if r == 0:
                eager_peak = torch.cuda.max_memory_allocated() - base
            w0, t0 = time.time(), time.perf_counter()
            losses = graph_call(graph.run_superstep, x, y)
            torch.cuda.synchronize()
            turns["graph"].append((time.perf_counter() - t0) * 1e3 / k)
            spans["graph"].append((w0, time.time()))
        eager_ms = float(np.median(turns["eager"]))
        graph_ms = float(np.median(turns["graph"]))
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"graph {label}: a loss is not finite")
        x1, y1 = timed[0]
        span_ms = _replay_span_ms(graph_call, graph.run_superstep, x1, y1)

        def eager_window(x, y):
            for i in range(k):
                eager.step(_batch_of(x, i), _batch_of(y, i))

        w0 = time.time()
        prof_e = _profile_step(eager_window, x1, y1, card, eager_ms * k,
                               tags=tags, top=6,
                               what=f"{label} eager window (K={k})")
        spans["eager_profile"].append((w0, time.time()))
        w0 = time.time()
        prof_g = _profile_step(
            lambda x, y: graph_call(graph.run_superstep, x, y), x1, y1,
            card, graph_ms * k, tags=tags, top=6,
            what=f"{label} graph window (K={k})")
        spans["graph_profile"].append((w0, time.time()))
    clock = {kind: clocks.between(w) for kind, w in spans.items()}
    if kernels:
        _check_profiled(f"{label} eager window", prof_e, kernels, k)
        _check_profiled(f"{label} graph window", prof_g, kernels, k)
    dev_e = sum(r[0] for r in prof_e) / k
    dev_g = sum(r[0] for r in prof_g) / k
    print(f"graph {label} ({card}): eager step() {eager_ms:.4f} ms per "
          f"step, graph path {graph_ms:.4f} ms per step (host clock, "
          f"median of {GRAPH_ROUNDS} alternating turns of {k} steps: eager "
          f"{[round(t, 4) for t in turns['eager']]}, graph "
          f"{[round(t, 4) for t in turns['graph']]}); device time "
          f"{dev_e:.4f} ms a step eager (idle "
          f"{100 * (_idle(prof_e, eager_ms * k) or 0):.1f}%), {dev_g:.4f} "
          f"ms a step in the graph (idle "
          f"{100 * (_idle(prof_g, graph_ms * k) or 0):.1f}%), a replay's "
          f"device span {span_ms / k:.4f} ms a step; peak memory above the "
          f"row's baseline: eager {eager_peak / 2**20:.1f} MiB, graph "
          f"(warm-up, capture, replay) {graph_peak / 2**20:.1f} MiB; "
          f"eager turns {_clock_text(clock['eager'])}, graph turns "
          f"{_clock_text(clock['graph'])}, eager profile "
          f"{_clock_text(clock['eager_profile'])}, graph profile "
          f"{_clock_text(clock['graph_profile'])}; launches on the graph "
          f"path (every graph call of the row, measured) {total}",
          flush=True)
    return dict(k=k, eager_ms=eager_ms, graph_ms=graph_ms,
                eager_turns_ms=turns["eager"], graph_turns_ms=turns["graph"],
                eager_device_ms=dev_e, graph_device_ms=dev_g,
                eager_idle=_idle(prof_e, eager_ms * k),
                graph_idle=_idle(prof_g, graph_ms * k),
                replay_span_ms=span_ms / k, eager_peak_bytes=eager_peak,
                graph_peak_bytes=graph_peak, first_call_s=first_s,
                per_step=per_step, per_capture=capture_counts,
                clocks=clock, launches=total)


def _windows(n, make_batch):
    """``n`` windows, each a stacked ``(data, labels)`` of K batches."""
    out = []
    for _ in range(n):
        xs, ys = zip(*make_batch())
        out.append((torch.stack(xs), torch.stack(ys)))
    return out


def gluon_superstep_row(seed, card, net, wins):
    """The gluon SuperStep (``Trainer.superstep``) on ``net`` with sgd and
    momentum: the fused path (one replay a window on the card) against
    its eager path (``MXTPU_SUPERSTEP=0``: forward, backward,
    ``Trainer.step(1)``) from the same weights and seed over the first
    window, bit for bit, then host ms a step of each over the others."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.config import config

    start = {n: p.detach().clone() for n, p in net.named_parameters()}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for mode, knob in (("graph", "auto"), ("eager", "0")):
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(start[n])
        config.set("MXTPU_SUPERSTEP", knob)
        try:
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
            eng = tr.superstep(net, ce, window=int(wins[0][0].shape[0]))
            mx.random.seed(seed)
            first = eng.run_window(*wins[0])
            params = {n: p.detach().clone()
                      for n, p in net.named_parameters()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, y in wins[1:]:
                last = eng.run_window(x, y)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / sum(
                int(x.shape[0]) for x, _ in wins[1:])
        finally:
            config.unset("MXTPU_SUPERSTEP")
        if not bool(torch.isfinite(last).all()):
            raise AssertionError("gluon superstep: a loss is not finite")
        out[mode] = dict(first=first, params=params, ms=ms,
                         dispatches=eng.dispatch_count,
                         fallback=eng.last_fallback)
    g, e = out["graph"], out["eager"]
    equal = torch.equal(g["first"], e["first"]) and all(
        torch.equal(g["params"][n], e["params"][n]) for n in g["params"])
    print(f"gluon SuperStep (MLP, sgd lr 0.1 momentum 0.9, K="
          f"{wins[0][0].shape[0]}; {card}): fused {g['ms']:.4f} ms per step "
          f"({g['dispatches']} dispatches), eager path {e['ms']:.4f} ms per "
          f"step ({e['fallback']}); first window "
          f"{'bit-equal' if equal else 'NOT bit-equal'}", flush=True)
    if not equal or g["dispatches"] != len(wins) or e["dispatches"] != 0 \
            or g["fallback"] is not None:
        raise AssertionError(f"gluon superstep: fused against eager "
                             f"{equal}, dispatches {g['dispatches']}/"
                             f"{e['dispatches']}, {g['fallback']}")
    return dict(graph_ms=g["ms"], eager_ms=e["ms"], k=int(wins[0][0].shape[0]))


def fresh_thread_capture(dev, n=32, h=56, c=64):
    """K3 (the weight gradient, TMA-fed) and K1 captured in a CUDA graph on
    a thread that never ran an encode, at ResNet-50's 3x3 64->64 56x56
    shape, fp32 and bf16: the replay equals the eager calls bit for bit
    (the encoder binds the thread's context with libcuda calls, which a
    capture allows)."""
    import threading

    from incubator_mxnet_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, h, h, c, generator=gen, device=dev).to(dtype)
        w = (torch.randn(3, 3, c, c, generator=gen, device=dev) / 24
             ).to(dtype)
        a = torch.rand(c, generator=gen, device=dev) + 0.5
        b = torch.randn(c, generator=gen, device=dev) * 0.5
        y = fc.fused_conv(x, w, a, b, 1, 1, True)[0]
        dy = torch.randn(y.shape, generator=gen, device=dev).to(dtype)
        z = torch.zeros(c, device=dev)
        args = (x, w, a, b, y, dy, z, z, 1, 1, True)
        want = (fc.conv_bwd_dw(*args), fc.fused_conv(x, w, a, b, 1, 1,
                                                     True)[0])
        torch.cuda.synchronize()
        res = {}

        def run():
            try:
                side = torch.cuda.Stream()
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, stream=side):
                    got = (fc.conv_bwd_dw(*args),
                           fc.fused_conv(x, w, a, b, 1, 1, True)[0])
                g.replay()
                torch.cuda.synchronize()
                res["got"] = got
            except Exception as e:  # re-raised on this thread
                res["err"] = e

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "err" in res:
            raise AssertionError(f"capture on a fresh thread failed "
                                 f"({DTYPE_NAMES[dtype]}): {res['err']}")
        ok = all(torch.equal(g, r) for g, r in zip(res["got"], want))
        out[DTYPE_NAMES[dtype]] = ok
        if not ok:
            raise AssertionError(f"the fresh-thread capture of K3/K1 "
                                 f"({DTYPE_NAMES[dtype]}) differs from the "
                                 f"eager calls")
    print(f"fresh-thread capture: K3 and K1 at B={n}, {h}x{h}, {c}->{c} "
          f"captured on a new thread and replayed, bit-equal to the eager "
          f"calls in fp32 and bf16", flush=True)
    return out


def graph_phase(seed, card, ctx, mlp_b=MLP_BATCH, gpt=("gpt_decoder_117m",
                50257, 8, 256, {}), bert=("bert_12_768_12", 30522, 24, 128,
                                          {}), resnet_b=128, hw=224,
                resnet_layers=None, k=None):
    """The graph phase (the module docstring's phase 12): each row's
    ``SPMDTrainer.run_superstep`` over windows of distinct synthetic
    batches drawn from ``seed`` against K eager steps (``graph_row``), the
    gluon SuperStep on the MLP, and the fresh-thread capture. Sizes are
    the rows' own unless a test passes small ones (``gpt`` and ``bert``:
    spec name, vocab, B, T, extra spec keys; ``resnet_layers``: (layers,
    channels) of a small ResNet of both kinds; ``k``: window K for every
    row)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.model_zoo import (get_gpt,
                                                          get_model, vision)
    from incubator_mxnet_tpu_torch.models import get_bert

    dev = ctx.torch_device()
    gk = {row: (k or kk) for row, kk in GRAPH_K.items()}
    n_win = 1 + GRAPH_TIMED
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 71)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    rows = {}

    # the MLP row (bench.py's mlp: bf16, B=8192, 784-512-512-10)
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(512, activation="relu"),
            nn.Dense(512, activation="relu"), nn.Dense(10))
    net.initialize("xavier", ctx=ctx)
    net.cast("bfloat16")
    net(torch.zeros(2, 784, dtype=torch.bfloat16, device=dev))

    def mlp_batch():
        return [(torch.rand((mlp_b, 784), generator=gen, device=dev).to(
            torch.bfloat16), torch.randint(0, 10, (mlp_b,), generator=gen,
                                           device=dev).float())
                for _ in range(gk["mlp"])]

    wins = _windows(n_win, mlp_batch)
    rows["mlp"] = graph_row(
        "mlp", lambda: parallel.SPMDTrainer(
            net, ce, "sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        wins, card, seed, expect={})
    rows["mlp_gluon_superstep"] = gluon_superstep_row(seed, card, net, wins)
    del net, wins
    gc.collect()

    # the GPT bf16 row: dropout as built
    name, vocab, b, t, spec = gpt
    mx.random.seed(seed)
    net = get_gpt(name, vocab_size=vocab, max_length=t, **spec).initialize(
        "xavier", ctx=ctx)
    net.cast("bfloat16")
    layers = net.num_layers

    def lm_loss(logits, labels):
        return ce(logits, labels).mean()

    def gpt_batch():
        return [(torch.randint(0, vocab, (b, t), generator=gen, device=dev,
                               dtype=torch.int32),
                 torch.randint(0, vocab, (b, t), generator=gen,
                               device=dev).float())
                for _ in range(gk["gpt"])]

    rows["gpt"] = graph_row(
        "gpt", lambda: parallel.SPMDTrainer(
            net, lm_loss, "sgd", {"learning_rate": 1e-4, "momentum": 0.9}),
        _windows(n_win, gpt_batch), card, seed,
        expect={f"{kern}{route}": layers for kern in COUNTERS
                for route in ("", "_tc")},
        kernels={f"{kern}_tc_kernel": layers for kern in COUNTERS},
        tags=FLASH_TAGS)
    del net
    gc.collect()

    # the BERT bf16 row (bench.py's bert shape): dropout 0.1 as built,
    # attention on K4-K6; each batch of a window has its own mixed segments
    # and valid_length, a (K, B) device tensor, so each step of a replay
    # reads its own lengths
    name, vocab, b, t, spec = bert
    mx.random.seed(seed)
    net = get_bert(name, vocab_size=vocab, max_length=512,
                   attention_impl="pallas", **spec).initialize("xavier",
                                                               ctx=ctx)
    net.cast("bfloat16")
    layers = len(net.encoder._modules)
    kb = gk["bert"]

    def bert_window():
        split = torch.randint(1, t, (kb, b, 1), generator=gen, device=dev)
        data = [torch.randint(0, vocab, (kb, b, t), generator=gen,
                              device=dev, dtype=torch.int32),
                (torch.arange(t, device=dev) >= split).to(torch.int32),
                torch.randint(1, t + 1, (kb, b), generator=gen, device=dev,
                              dtype=torch.int32)]
        labels = [torch.randint(0, vocab, (kb, b, t), generator=gen,
                                device=dev).float(),
                  torch.randint(0, 2, (kb, b), generator=gen,
                                device=dev).float()]
        return data, labels

    rows["bert"] = graph_row(
        "bert", lambda: parallel.SPMDTrainer(
            net, bert_pretrain_loss(ce), "sgd",
            {"learning_rate": 1e-4, "momentum": 0.9}),
        [bert_window() for _ in range(n_win)], card, seed,
        expect={f"{kern}{route}": layers for kern in COUNTERS
                for route in ("", "_tc")},
        kernels={f"{kern}_tc_kernel": layers for kern in COUNTERS},
        tags=FLASH_TAGS)
    del net
    gc.collect()

    # the fused and unfused ResNet-50 rows (bf16, B=128; unfused in
    # channels-last memory format)
    if resnet_layers is None:
        fused = get_model("fused_resnet50_v1", classes=1000)
        zoo = get_model("resnet50_v1", classes=1000)
    else:
        lay, chans = resnet_layers
        fused = vision.FusedResNetV1(lay, chans, classes=10)
        zoo = vision.ResNetV1(vision.BottleneckV1, lay, chans, classes=10)
    for row, net in (("resnet50_fused", fused), ("resnet50_unfused", zoo)):
        mx.random.seed(seed)
        net.initialize("xavier", ctx=ctx)
        with mx.autograd.pause():             # fills deferred shapes
            net(torch.zeros(2, 3, hw, hw, device=dev))
        net.cast("bfloat16")
        classes = net.output.weight.shape[0]
        channels_last = row == "resnet50_unfused"
        if channels_last:
            with torch.no_grad():
                for p in net.parameters():
                    if p.dim() == 4:
                        p.data = p.data.contiguous(
                            memory_format=torch.channels_last)

        def resnet_batch(k_row=gk[row], cl=channels_last, nc=classes):
            out = []
            for _ in range(k_row):
                x = torch.rand((resnet_b, 3, hw, hw), generator=gen,
                               device=dev).to(torch.bfloat16)
                y = torch.randint(0, nc, (resnet_b,), generator=gen,
                                  device=dev).float()
                out.append((x, y))
            return out

        wins = _windows(n_win, resnet_batch)
        if channels_last:       # each batch of the window channels-last
            wins = [(x.permute(0, 1, 3, 4, 2).contiguous().permute(
                0, 1, 4, 2, 3), y) for x, y in wins]
        per_pass = convs_per_pass(net) if row == "resnet50_fused" else 0
        expect = {f"{kern}_tc": per_pass for kern in CONV_KERNELS} \
            if per_pass else {}
        expect.update({kern: per_pass for kern in CONV_KERNELS})
        rows[row] = graph_row(
            row, lambda n=net: parallel.SPMDTrainer(
                n, ce, "sgd", {"learning_rate": 0.1, "momentum": 0.9}),
            wins, card, seed, expect=expect,
            kernels={f"{kern}_tc_kernel": per_pass
                     for kern in CONV_KERNELS} if per_pass else None,
            tags=CONV_TAGS if per_pass else ())
        rows[row]["per_pass"] = per_pass
        del wins
        gc.collect()
    del fused, zoo
    gc.collect()
    rows["fresh_thread"] = fresh_thread_capture(dev) \
        if dev.type == "cuda" else None
    return rows


# ---------------------------------------------------------------------------
# imperative phase: mx.nd, mx.operator and mx.rtc (K7)
# ---------------------------------------------------------------------------
RTC_KERNELS = ("scale", "saxpy", "first_row", "softmax_ce_fwd",
               "softmax_ce_bwd")
# gpt_decoder_117m's parameter count at max_length 1024: the flat vector
# scale and saxpy run over
RTC_FLAT = 163_037_184
RTC_HEAD = "softmax_ce_fwd"
# softmax_ce_fwd: probabilities, a sum of exponentials in another order;
# held elementwise relative to the plain version's, since most of them are
# far below any absolute bound worth holding (median 1e-8 at 4*randn logits)
RTC_FWD_RTOL = 1e-5
# the imperative step's gradients against the plain loss's: relative L2
IMPERATIVE_GRAD_RTOL = 1e-4
# K7's cases beside the path's own shapes: softmax_ce_fwd over a row longer
# than the resident limit (streamed) and over small odd rows (and, with
# req="add", at the path's shape); scale over a flat vector less 3 floats
# on views at these float offsets of a larger buffer
RTC_SOFTMAX_SHAPES = ((256, 100003), (5, 7), (3, 4099))
RTC_SCALE_OFFSETS = (1, 3)
# turns of first_row beside torch.clone of row 0 and an empty kernel
FIRST_ROW_TURNS = 7


def _rtc_counts(reset=False):
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    out = {}
    for name in RTC_KERNELS:
        key = rk.KERNELS[name].lookup
        out[name] = rtc.launches[key]
        if reset:
            rtc.launches[key] = 0
    return out


def rtc_bound(name, shape, req="write"):
    """Least time (ms) of one rtc kernel call and what bounds it: each
    input read once, each output written once (fp32; int32 labels), and
    the fp32 operations at 67 TFLOP/s (scale 1, saxpy 2, softmax_ce_fwd 5
    per element: max, subtract, exp, sum, divide; softmax_ce_bwd 1).
    ``req="add"`` (softmax_ce_fwd) also reads the output and adds."""
    if name == "first_row":
        nbytes, flops = 2 * shape[1] * 4, 0          # one row in, one out
    else:
        n = math.prod(shape)
        nbytes, flops = {"scale": (2 * n * 4, n),
                         "saxpy": (3 * n * 4, 2 * n),
                         "softmax_ce_fwd": (2 * n * 4, 5 * n),
                         "softmax_ce_bwd": (2 * n * 4 + shape[0] * 4, n)}[name]
        if req == "add":
            nbytes, flops = nbytes + n * 4, flops + n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _max_rel_err(got, want):
    """Largest ``|got - want| / |want|``; 0 where both are 0, inf where
    only ``want`` is."""
    rel = (got - want).abs() / want.abs()
    return torch.nan_to_num(rel, nan=0.0, posinf=math.inf).max().item()


def _ce_bwd_ms(logits, labels):
    """Device ms of ``F.cross_entropy``'s backward (sum): a CUDA graph of
    forward + ``autograd.grad`` less a graph of the forward alone."""
    import torch.nn.functional as F

    lg = logits.detach().requires_grad_(True)
    lab = labels.long()

    def fwd():
        return F.cross_entropy(lg, lab, reduction="sum")

    def fwd_bwd():
        return torch.autograd.grad(fwd(), lg)

    both = device_ms(fwd_bwd)
    return both - device_ms(fwd), both


def _plan_text(plan):
    return (f"{'resident' if plan.resident else 'streamed'}: "
            f"{plan.threads} threads, {plan.shared_bytes} bytes of shared "
            "memory")


def rtc_cases(gen, dev, path_shape, flat, softmax_shapes=RTC_SOFTMAX_SHAPES,
              offsets=RTC_SCALE_OFFSETS):
    """K7's cases beside the path, each held against its plain version
    (softmax_ce_fwd 1e-5 relative, scale and saxpy bit for bit) and timed
    beside its plain version, one library call (none for req="add") and
    its bound:
    softmax_ce_fwd at each of ``softmax_shapes`` and, with req="add", at
    ``path_shape``, each with its plan (resident or streamed); scale over
    ``flat - 3`` floats on views of a larger buffer at each of ``offsets``,
    into a new array (x and y at two alignment phases: single floats) and
    into a view at x's offset (one phase: a head, 16-byte quads, a
    tail); saxpy over the same views, a at each offset with b and out
    aligned (three pointers at two phases: single floats) and all three at
    the offset into a view (a head, quads, a tail). Launches made here are
    not counted. Any failure raises."""
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    limit = rk.smem_optin(dev)
    cases = []

    def check(case, name, shape, got, want, tol, call, plain, library,
              bound, **extra):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = _max_rel_err(got, want)
        if got.shape != want.shape or not math.isfinite(err) or rel > tol:
            raise AssertionError(f"rtc {case}: max relative err {rel} > "
                                 f"{tol}")
        ms, plain_ms = device_ms(call), device_ms(plain)
        library_ms = device_ms(library) if library else None
        lib_txt = "none" if library_ms is None else f"{library_ms:.5f}"
        bound_ms, bound_by = bound
        print(f"kernel rtc case {case} {name} {tuple(shape)} fp32: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol:g} "
              f"relative) ms={ms:.5f} (device, CUDA graph) "
              f"plain_ms={plain_ms:.5f} library_ms={lib_txt} "
              f"bound_ms={bound_ms:.5f} ({bound_by})"
              + "".join(f"; {k} {v}" for k, v in extra.items()
                        if k != "plan"), flush=True)
        cases.append(dict(case=case, name=name, shape=list(shape),
                          max_abs_err=err, max_rel_err=rel, rel_tol=tol,
                          ms=ms, timing="cuda_graph", plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, **extra))

    for shape, req in ([(sh, "write") for sh in softmax_shapes]
                       + [(tuple(path_shape), "add")]):
        x = NDArray(4 * torch.randn(shape, generator=gen, device=dev))
        y0 = torch.rand(shape, generator=gen, device=dev) if req == "add" \
            else torch.zeros(shape, device=dev)
        y = NDArray(y0.clone())
        plan = rk.softmax_ce_fwd_plan(shape[1], limit)
        print(f"softmax_ce_fwd plan {shape} (req {req}): "
              f"{_plan_text(plan)}", flush=True)
        rk.softmax_ce_fwd(x, y, req)
        want = rk.softmax_ce_fwd_reference(x.as_torch())
        if req == "add":
            want = y0 + want
        check(f"softmax_ce_fwd_{req}_{shape[0]}x{shape[1]}",
              "softmax_ce_fwd", shape, y.as_torch(), want, RTC_FWD_RTOL,
              lambda: rk.softmax_ce_fwd(x, y, req),
              (lambda: rk.softmax_ce_fwd_reference(x.as_torch()))
              if req == "write" else
              (lambda: y0 + rk.softmax_ce_fwd_reference(x.as_torch())),
              (lambda: torch.softmax(x.as_torch(), -1))
              if req == "write" else None,
              rtc_bound("softmax_ce_fwd", shape, req), req=req,
              plan=plan._asdict())
        del x, y, y0, want
    n = flat - 3
    buf = torch.randn(flat + 1, generator=gen, device=dev)
    out = torch.zeros(flat + 1, device=dev)
    for off in offsets:
        x = NDArray(buf[off:off + n])
        want = rk.scale_reference(x.as_torch(), 0.5)
        y = rk.scale(x, 0.5)
        check(f"scale_view{off}_new_out", "scale", (n,), y.as_torch(), want,
              0.0, lambda: rk.scale(x, 0.5),
              lambda: rk.scale_reference(x.as_torch(), 0.5),
              lambda: torch.mul(x.as_torch(), 0.5), rtc_bound("scale", (n,)),
              offset_x=off, offset_y=0)
        y = NDArray(out[off:off + n])

        def into_view():                # the kernel itself: x's phase
            if x.ctx.device_type == "cpu":  # the CPU rehearsal
                y.as_torch().copy_(rk.scale_reference(x.as_torch(), 0.5))
            else:
                rk.kernel("scale").launch([x, y, 0.5, n], x.ctx,
                                          *rk.scale_plan(n))
        into_view()
        check(f"scale_view{off}_view_out", "scale", (n,), y.as_torch(),
              want, 0.0, into_view,
              lambda: rk.scale_reference(x.as_torch(), 0.5),
              lambda: torch.mul(x.as_torch(), 0.5, out=y.as_torch()),
              rtc_bound("scale", (n,)), offset_x=off, offset_y=off)
        del x, y, want
    # saxpy over the same views: a at the offset with b and out aligned
    # (several phases: single floats), and all three at the offset into a
    # view (one phase: a head, 16-byte quads, a tail)
    bbuf = torch.randn(flat + 1, generator=gen, device=dev)
    for off in offsets:
        a = NDArray(buf[off:off + n])
        for label, b, y in (
                ("mixed", NDArray(bbuf[:n]), NDArray(out[:n])),
                ("view_out", NDArray(bbuf[off:off + n]),
                 NDArray(out[off:off + n]))):
            want = rk.saxpy_reference(a.as_torch(), b.as_torch(), 2.0)

            def launch(a=a, b=b, y=y):      # the kernel itself, into y
                if a.ctx.device_type == "cpu":  # the CPU rehearsal
                    y.as_torch().copy_(rk.saxpy_reference(
                        a.as_torch(), b.as_torch(), 2.0))
                else:
                    rk.kernel("saxpy").launch([a, b, y, 2.0, n], a.ctx,
                                              *rk.saxpy_plan(n))
            launch()
            check(f"saxpy_view{off}_{label}", "saxpy", (n,), y.as_torch(),
                  want, 0.0, launch,
                  lambda a=a, b=b: rk.saxpy_reference(a.as_torch(),
                                                      b.as_torch(), 2.0),
                  lambda a=a, b=b, y=y: torch.add(
                      b.as_torch(), a.as_torch(), alpha=2.0,
                      out=y.as_torch()),
                  rtc_bound("saxpy", (n,)), offset_a=off,
                  offset_b=0 if label == "mixed" else off,
                  offset_out=0 if label == "mixed" else off)
            del b, y, want
        del a
    del buf, bbuf, out
    gc.collect()
    return cases


def _check_imperative_launches(rtc_got, rtc_want, flash_got, flash_want,
                               routes_got, routes_want):
    print(f"launches on the imperative path: rtc {rtc_got} (want "
          f"{rtc_want}); flash {flash_got} (want {flash_want} each); by "
          f"route {routes_got} (want {routes_want})", flush=True)
    if rtc_got != rtc_want or any(v != flash_want
                                  for v in flash_got.values()) \
            or routes_got != routes_want:
        raise AssertionError("imperative path: launch counts differ")


def imperative_phase(seed, card, net, ctx, b=8, flat=RTC_FLAT, lr=3e-4,
                     conv_case=None, softmax_shapes=RTC_SOFTMAX_SHAPES):
    """The imperative front door on a GPT decoder ``net`` (dropout 0) at
    B=``b`` and T=its ``max_length``: the main path (an mx.rtc program of
    scale/saxpy/first_row over a ``flat``-element vector and the size of
    the net's embedding, then the imperative training step whose loss is
    the ``softmax_ce_rtc`` custom op, with its gradient oracle, learning
    check and timing), counted; then (a) the five rtc kernels against
    their plain versions and timed, (b) K7's cases beside the path
    (``rtc_cases``, with ``softmax_shapes``), (c) the registered kernel
    ops through ``invoke`` against the direct calls, bit for bit
    (``conv_case``: a ``CONV_CASES`` entry, default the conv kernel
    phase's head case)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    dev = ctx.torch_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    t, vocab = net.max_length, net.vocab_size
    heads, head_dim = net.num_heads, net.head_dim
    units, n_rows = heads * head_dim, b * net.max_length
    params = [p for p in net.parameters() if p.requires_grad]
    names = [n for n, p in net.named_parameters() if p.requires_grad]
    rs = np.random.RandomState(seed + 5)
    tokens = mx.nd.array(rs.randint(0, vocab, (b, t)), ctx=ctx)
    labels = mx.nd.array(rs.randint(0, vocab, (n_rows,)), ctx=ctx)
    lab = labels.as_torch().long()
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})

    def rtc_inputs():
        def randn(*shape):
            return NDArray(torch.randn(shape, generator=gen, device=dev))
        return randn(flat), randn(flat), randn(vocab, units)

    def rtc_program(x, y, emb):
        """The user program of mx.rtc kernels: scale, saxpy, first_row."""
        out = dict(scale=rk.scale(x, 0.5))
        out["saxpy"] = rk.saxpy(out["scale"], y, 2.0)
        out["first_row"] = rk.first_row(emb)
        return out

    def rtc_step():
        """record -> net(NDArray) -> Custom(softmax_ce_rtc) -> backward;
        returns the mean cross entropy of this forward."""
        with mx.autograd.record():
            logits = net(tokens)
            probs = mx.nd.Custom(logits.reshape((-1, vocab)), labels,
                                 op_type="softmax_ce_rtc")
        probs.backward()
        p = probs.as_torch()
        return -torch.log(p[torch.arange(n_rows, device=dev), lab]).mean()

    # the main path, counted: every count set to 0 just before and read
    # just after. The mx.rtc program, its results held against the plain
    # versions; then the plain loss's step (the oracle's reference) and
    # the imperative steps: the oracle's, 5 learning steps, 3 timed steps
    torch.cuda.synchronize()
    _rtc_counts(reset=True)
    _reset_launches(fa)
    x, y, emb = rtc_inputs()
    program = rtc_program(x, y, emb)
    for name, want_t in (
            ("scale", rk.scale_reference(x.as_torch(), 0.5)),
            ("saxpy", rk.saxpy_reference(program["scale"].as_torch(),
                                         y.as_torch(), 2.0)),
            ("first_row", rk.first_row_reference(emb.as_torch()))):
        if not torch.equal(program[name].as_torch(), want_t):
            raise AssertionError(f"rtc program: {name} differs from its "
                                 "plain version")
        del want_t
    print(f"rtc program (scale, saxpy over {flat} fp32, first_row of "
          f"({vocab}, {units})): equal to the plain versions bit for bit",
          flush=True)
    del x, y, emb, program
    gc.collect()
    with mx.autograd.record():
        plain = ce(net(tokens).reshape((-1, vocab)), labels)
    plain.backward()                       # head of ones: the summed loss
    plain_loss = plain.as_torch().detach().mean().item()
    plain_grads = [p.grad.clone() for p in params]
    del plain
    loss0 = rtc_step()
    rtc_steps, passes = 1, 2
    worst = (0.0, "")
    for name, g, p in zip(names, plain_grads, params):
        rel = _rel_l2(p.grad, g)
        if not math.isfinite(rel) or rel > IMPERATIVE_GRAD_RTOL:
            raise AssertionError(f"imperative step: {name} gradient "
                                 f"relative L2 error {rel} > "
                                 f"{IMPERATIVE_GRAD_RTOL} against the plain "
                                 "loss")
        worst = max(worst, (rel, name))
    print(f"imperative step oracle (fp32, {len(names)} parameter tensors): "
          f"mean cross entropy {loss0.item():.6f} (softmax_ce_rtc) vs "
          f"{plain_loss:.6f} (SoftmaxCrossEntropyLoss, summed); worst "
          f"gradient relative L2 error {worst[0]:.3e} ({worst[1]}), "
          f"tolerance {IMPERATIVE_GRAD_RTOL:g}", flush=True)
    if abs(loss0.item() - plain_loss) > 1e-5 * abs(plain_loss):
        raise AssertionError("imperative step: the loss differs from the "
                             "plain loss's")
    del plain_grads
    # learning: the same step with gluon.Trainer (adam), one batch
    losses = [loss0.item()]
    trainer.step(n_rows)
    for _ in range(5):
        losses.append(rtc_step().item())
        trainer.step(n_rows)
    rtc_steps += 5
    passes += 5
    print(f"imperative learning check (fp32, gluon.Trainer adam lr {lr:g}, "
          f"one batch repeated): mean cross entropy "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("imperative step: the loss did not fall by 5% "
                             "over 5 steps")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        rtc_step()
        trainer.step(n_rows)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = torch.cuda.max_memory_allocated(dev)
    rtc_steps += 3
    passes += 3
    launches = _rtc_counts()
    flash = _read_launches(fa)
    flash_routes = _read_routes(fa)
    print(f"imperative step (fp32, B={b}, T={t}, record -> net -> "
          f"Custom(softmax_ce_rtc) -> backward -> gluon.Trainer adam; "
          f"{card}): {step_ms:.3f} ms per step (host clock, 3 steps), peak "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    # every pass fp32: K4 where the rule sends T (f32 at 256), K5/K6 on
    # f32, 12 a pass each
    _check_imperative_launches(
        launches, dict(scale=1, saxpy=1, first_row=1,
                       softmax_ce_fwd=rtc_steps, softmax_ce_bwd=rtc_steps),
        flash, net.num_layers * passes, flash_routes,
        training_routes(passes, 0, net.num_layers, t, head_dim))

    # beside it (not counted): the same step on tensors with the plain loss,
    # and a profile of one imperative step
    x_t, y_t = tokens.as_torch(), labels.as_torch()

    def tensor_step(*_):
        with mx.autograd.record():
            loss = ce(net(x_t).reshape(-1, vocab), y_t)
        mx.autograd.backward(loss)
        trainer.step(n_rows)

    tensor_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        tensor_step()
    torch.cuda.synchronize()
    tensor_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"the same step on tensors with SoftmaxCrossEntropyLoss (fp32; "
          f"{card}): {tensor_ms:.3f} ms per step (host clock, 3 steps after "
          f"1 warmup) against {step_ms:.3f} ms imperative", flush=True)
    profile = _profile_step(lambda *_: (rtc_step(), trainer.step(n_rows)),
                            None, None, card, step_ms,
                            tags=("softmax_ce_fwd", "softmax_ce_bwd")
                            + FLASH_TAGS, top=12,
                            what="fp32 imperative step")

    # (a) each rtc kernel against its plain version, then timed (launches
    # made here are not counted)
    x, y, emb = rtc_inputs()
    program = rtc_program(x, y, emb)
    logits = NDArray(4 * torch.randn(n_rows, vocab, generator=gen,
                                     device=dev))
    probs = NDArray(torch.zeros_like(logits.as_torch()))
    dx = NDArray(torch.zeros_like(logits.as_torch()))
    rk.softmax_ce_fwd(logits, probs)
    rk.softmax_ce_bwd(labels, probs, dx)
    got = dict(program, softmax_ce_fwd=probs, softmax_ce_bwd=dx)
    plain = {
        "scale": lambda: rk.scale_reference(x.as_torch(), 0.5),
        "saxpy": lambda: rk.saxpy_reference(program["scale"].as_torch(),
                                            y.as_torch(), 2.0),
        "first_row": lambda: rk.first_row_reference(emb.as_torch()),
        "softmax_ce_fwd": lambda: rk.softmax_ce_fwd_reference(
            logits.as_torch()),
        "softmax_ce_bwd": lambda: rk.softmax_ce_bwd_reference(
            labels.as_torch(), probs.as_torch()),
    }
    calls = {"scale": lambda: rk.scale(x, 0.5),
             "saxpy": lambda: rk.saxpy(program["scale"], y, 2.0),
             "first_row": lambda: rk.first_row(emb),
             "softmax_ce_fwd": lambda: rk.softmax_ce_fwd(logits, probs),
             "softmax_ce_bwd": lambda: rk.softmax_ce_bwd(labels, probs, dx)}
    # one PyTorch call computing the same function, timed only
    library = {
        "scale": lambda: torch.mul(x.as_torch(), 0.5),
        "saxpy": lambda: torch.add(y.as_torch(), program["scale"].as_torch(),
                                   alpha=2.0),
        "first_row": lambda: torch.clone(emb.as_torch()[0]),
        "softmax_ce_fwd": lambda: torch.softmax(logits.as_torch(), -1),
    }
    shapes = {"scale": (flat,), "saxpy": (flat,), "first_row": (vocab, units),
              "softmax_ce_fwd": (n_rows, vocab),
              "softmax_ce_bwd": (n_rows, vocab)}
    rows = {}
    for name in RTC_KERNELS:
        want_t = plain[name]()
        got_t = got[name].as_torch()
        torch.cuda.synchronize()
        err = (got_t - want_t).abs().max().item()
        rel = _max_rel_err(got_t, want_t)
        # softmax_ce_fwd relative to the plain version, the rest bit for bit
        tol = RTC_FWD_RTOL if name == "softmax_ce_fwd" else 0.0
        if got_t.shape != want_t.shape or not math.isfinite(err) \
                or rel > tol:
            raise AssertionError(f"rtc {name}: max relative err {rel} > "
                                 f"{tol}")
        del want_t
        ms = device_ms(calls[name])
        plain_ms = device_ms(plain[name])
        ce_both = None
        if name == "softmax_ce_bwd":
            library_ms, ce_both = _ce_bwd_ms(logits.as_torch(),
                                             labels.as_torch())
        else:
            library_ms = device_ms(library[name])
        bound_ms, bound_by = rtc_bound(name, shapes[name])
        rows[name] = dict(
            name=name, source="incubator_mxnet_tpu_torch/csrc/rtc/"
            + rk.KERNELS[name].source + ".cu",
            lookup=rk.KERNELS[name].lookup, shape=list(shapes[name]),
            launches=launches[name], max_abs_err=err, max_rel_err=rel,
            rel_tol=tol, ms=ms, timing="cuda_graph", plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        lib_txt = f"{library_ms:.5f}"
        if ce_both is not None:
            lib_txt += (f" (F.cross_entropy backward; forward + backward "
                        f"{ce_both:.5f})")
        print(f"kernel rtc {name} {shapes[name]} fp32: max_abs_err="
              f"{err:.3e} max_rel_err={rel:.3e} (tol {tol:g} relative) "
              f"ms={ms:.5f} (device, CUDA graph) "
              f"plain_ms={plain_ms:.5f} library_ms={lib_txt} bound_ms="
              f"{bound_ms:.5f} ({bound_by}); launches on the path "
              f"{launches[name]}", flush=True)
    if dev.type == "cuda":
        # first_row's floor: the graph replay of a launch that does nothing
        empty = mx.rtc.CudaModule(
            'extern "C" __global__ void empty_kernel(int n) {}').get_kernel(
                "empty_kernel", "int n")
        empty_ms = device_ms(lambda: empty.launch([0], ctx, (1, 1, 1),
                                                  (32, 1, 1)))
        rows["first_row"]["empty_kernel_ms"] = empty_ms
        print(f"an empty kernel (launch floor): ms={empty_ms:.5f} (device, "
              f"CUDA graph) beside first_row's "
              f"{rows['first_row']['ms']:.5f}", flush=True)
        # first_row, torch.clone of row 0 and the empty kernel in turns,
        # so the gap between the three is read within one stretch of time
        turns = {"first_row": calls["first_row"],
                 "clone": library["first_row"],
                 "empty": lambda: empty.launch([0], ctx, (1, 1, 1),
                                               (32, 1, 1))}
        turn_ms = {k: [] for k in turns}
        for _ in range(FIRST_ROW_TURNS):
            for k, fn in turns.items():
                turn_ms[k].append(device_ms(fn))
        rows["first_row"]["turns_ms"] = turn_ms
        print(f"first_row, torch.clone of row 0 and an empty kernel in "
              f"{FIRST_ROW_TURNS} interleaved turns (device ms, CUDA graph; "
              "median [min, max]): " + "; ".join(
                  f"{k} {np.median(v):.6f} [{min(v):.6f}, {max(v):.6f}]"
                  for k, v in turn_ms.items()), flush=True)
    plan = rk.softmax_ce_fwd_plan(vocab, rk.smem_optin(dev))
    print(f"softmax_ce_fwd plan {shapes['softmax_ce_fwd']} (the path's): "
          f"{_plan_text(plan)}", flush=True)
    rows["softmax_ce_fwd"]["plan"] = plan._asdict()
    del x, y, emb, program, got, plain, calls, library, logits, probs, dx
    gc.collect()

    # (b) K7's cases beside the path
    cases = rtc_cases(gen, dev, (n_rows, vocab), flat, softmax_shapes)

    # (c) the registered kernel ops through invoke equal the direct calls
    q, k, v, g = (torch.randn(b, heads, t, head_dim, generator=gen,
                              device=dev) for _ in range(4))
    direct = [z.clone().requires_grad_(True) for z in (q, k, v)]
    out = fa.flash_attention(*direct, causal=True)
    torch.autograd.backward(out, g)
    nds = [NDArray(z.clone()) for z in (q, k, v)]
    for z in nds:
        z.attach_grad()
    with mx.autograd.record():
        out_nd = mx.nd.flash_attention(*nds, causal=True)
    out_nd.backward(NDArray(g))
    same_fa = torch.equal(out_nd.as_torch(), out.detach()) and all(
        torch.equal(z.grad.as_torch(), w.grad) for z, w in zip(nds, direct))
    case = conv_case or next(c for c in CONV_CASES if c[0] == CONV_HEAD)
    stride, pad = _conv_dims(case)[6:8]
    ti = _conv_inputs(case, torch.float32, dev, gen)
    ins = [ti[key] for key in ("x", "w", "a", "b")]
    heads_g = [ti["dy"], ti["ds"], ti["dss"]]
    direct = [z.clone().requires_grad_(True) for z in ins]
    outs = fc.fused_conv_bn(*direct, stride=stride, pad=pad, relu=True)
    torch.autograd.backward(outs, heads_g)
    nds = [NDArray(z.clone()) for z in ins]
    for z in nds:
        z.attach_grad()
    with mx.autograd.record():
        outs_nd = mx.nd.invoke_op("fused_conv_bn", *nds, stride=stride,
                                  pad=pad, relu=True)
    mx.autograd.backward(list(outs_nd), [NDArray(h) for h in heads_g])
    same_conv = all(torch.equal(a.as_torch(), o.detach())
                    for a, o in zip(outs_nd, outs)) and all(
        torch.equal(z.grad.as_torch(), w.grad) for z, w in zip(nds, direct))
    print(f"registered kernel ops through invoke: mx.nd.flash_attention "
          f"(B={b}, H={heads}, T={t}, D={head_dim}, causal; output and dq, "
          f"dk, dv) {'equal' if same_fa else 'DIFFER from'} the direct call "
          f"bit for bit; invoke_op('fused_conv_bn') at {case[0]} (y, sum, "
          f"sumsq and dx, dw, da, db) "
          f"{'equal' if same_conv else 'DIFFER from'} the direct call bit "
          "for bit", flush=True)
    if not (same_fa and same_conv):
        raise AssertionError("a registered kernel op through invoke differs "
                             "from its direct call")
    return dict(rows=rows, rtc_cases=cases, launches=launches,
                flash_launches=flash, flash_routes=flash_routes,
                passes=passes, rtc_steps=rtc_steps, n_params=len(names),
                grad_worst_rel=worst[0], learning_losses=losses,
                step_ms=step_ms, tensor_step_ms=tensor_ms, peak_bytes=peak,
                profile=profile[:12])


def imperative_main(seed, card):
    """The imperative phase on ``gpt_decoder_117m`` at ``max_length`` 256
    (12 layers, 768 units, vocab 50257; 149 trainable tensors)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    net = get_gpt("gpt_decoder_117m", vocab_size=50257, dropout=0.0,
                  max_length=256).initialize("xavier", ctx=ctx)
    out = imperative_phase(seed, card, net, ctx)
    if out["n_params"] != 149:
        raise AssertionError("gpt_decoder_117m has 149 trainable tensors")
    return out


# ---------------------------------------------------------------------------
# mx.nd phase: the everyday ops, and a GPT step written in them alone
# ---------------------------------------------------------------------------
def _nd_rand(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _f32(values):
    return np.asarray(values, np.float32)


#: one op call of the mx.nd and mx.np phases: ``name`` is an ``mx.nd``
#: attribute (dotted through ``image`` or ``contrib``), ``"np:<dotted>"``
#: for an ``mx.np`` attribute (through ``linalg``, ``fft``), or
#: ``"op:<registered name>"`` for ``invoke_op``; ``arrays`` (numpy) are its
#: array arguments (any other value goes in positionally as it is) and a
#: numpy value among ``kwargs`` goes in as an array; ``grad`` the positions
#: of the arrays whose gradient of the seeded head (``_head_terms``) is
#: held too; ``tol`` the float tolerance (None: ``ND_TOL``); ``exact``
#: holds every value bit for bit; ``post`` maps the outputs (numpy) to the
#: values compared, for a result unique only up to signs (its invariants:
#: sign-fixed vectors and the reconstruction); ``sq`` the outputs that
#: enter the head squared (a loss that a vector's sign does not change)
NdCase = collections.namedtuple(
    "NdCase", "family id name arrays kwargs grad tol exact post sq",
    defaults=({}, (), None, False, None, ()))
# fp32 results of the same formula in another order of operations
ND_TOL = dict(rtol=1e-5, atol=1e-6)
# the special functions and sums over windows: each library's own series
# or summation order (lgamma, digamma, erfinv, the transposed convolution,
# group statistics)
ND_LOOSE = dict(rtol=1e-4, atol=1e-5)

_X = _nd_rand(0, 3, 4)
_XNZ = np.where(_X >= 0, _X + 0.2, _X - 0.2).astype(np.float32)
_POS = _nd_rand(2, 3, 4, lo=0.2, hi=2.0)
_UNIT = _nd_rand(3, 3, 4, lo=-0.9, hi=0.9)
_ROUNDS = _nd_rand(5, 3, 4, lo=-3.0, hi=3.0)
_HALVES = _f32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
_TIES = _f32([1, 3, 3, 2, 3])
_IMG = _nd_rand(6, 2, 4, 4, 6)
_SEQ = _nd_rand(7, 5, 3, 2)
_LENS = _f32([2, 5, 3])


def _unary(name, x, tol=None, grad=(0,)):
    return NdCase("unary", name, name, [x], {}, grad, tol)


ND_CASES = [
    *[_unary(n, _ROUNDS) for n in ("rint", "ceil", "floor", "trunc", "fix",
                                   "round")],
    # jnp's rule, half to even ([0.5, 1.5, 2.5] -> [0, 2, 2]): MXNet's own
    # round went half away from zero
    NdCase("unary", "rint_half_to_even", "rint", [_HALVES], exact=True),
    NdCase("unary", "round_half_to_even", "round", [_HALVES], exact=True),
    _unary("rsqrt", _POS), _unary("cbrt", _XNZ), _unary("rcbrt", _XNZ),
    _unary("log10", _POS), _unary("log2", _POS), _unary("log1p", _POS),
    _unary("expm1", _X), _unary("reciprocal", _XNZ),
    *[_unary(n, _X) for n in ("sin", "cos", "tan", "arctan", "sinh", "cosh",
                              "arcsinh", "erf", "erfc", "degrees", "radians",
                              "log_sigmoid")],
    *[_unary(n, _UNIT) for n in ("arcsin", "arccos", "arctanh")],
    _unary("arccosh", _nd_rand(4, 3, 4, lo=1.1, hi=3.0)),
    _unary("erfinv", _UNIT, ND_LOOSE), _unary("gamma", _POS, ND_LOOSE),
    _unary("gammaln", _POS, ND_LOOSE), _unary("digamma", _POS, ND_LOOSE),
    # exp(gammaln(x)): the sign of Γ(x) < 0 is lost; digamma(0) is NaN
    NdCase("unary", "gamma_loses_the_sign", "gamma",
           [_f32([-0.5, -1.5, 2.5])], tol=ND_LOOSE),
    NdCase("unary", "digamma_at_0_is_nan", "digamma",
           [_f32([0.0, 1.0, 2.5])], tol=ND_LOOSE),
    *[NdCase("unary", n, n, [_f32([0.0, np.nan, np.inf, -np.inf, 1.5])],
             exact=True) for n in ("isnan", "isinf", "isfinite")],
    NdCase("unary", "logical_not", "logical_not",
           [_f32([0.0, 1.5, -2.0, 0.0])]),
    # an integer input gives float32
    NdCase("unary", "logical_not_int", "logical_not",
           [np.array([0, 1, -2, 0], np.int32)], exact=True),
    NdCase("products", "matmul", "matmul",
           [_nd_rand(10, 2, 3, 4), _nd_rand(11, 2, 4, 5)], grad=(0, 1)),
    NdCase("products", "linalg_gemm2", "linalg_gemm2",
           [_nd_rand(12, 2, 4, 3), _nd_rand(13, 2, 4, 5)],
           dict(transpose_a=True, alpha=0.5), (0, 1)),
    NdCase("products", "khatri_rao", "khatri_rao",
           [_nd_rand(14, 2, 3), _nd_rand(15, 4, 3), _nd_rand(16, 3, 3)],
           grad=(0, 1, 2)),
    NdCase("shape", "flip", "flip", [_IMG], dict(axis=1), (0,)),
    NdCase("shape", "flip_axes", "flip", [_IMG], dict(axis=(0, 2)), (0,)),
    NdCase("shape", "reverse", "reverse", [_X], dict(axis=0), (0,)),
    NdCase("shape", "tile", "tile", [_X], dict(reps=(2, 1, 3)), (0,)),
    NdCase("shape", "repeat", "repeat", [_X], dict(repeats=2, axis=1),
           (0,)),
    NdCase("shape", "repeat_flat", "repeat", [_X], dict(repeats=3), (0,)),
    *[NdCase("shape", f"pad_{mode}", "pad", [_IMG[:1]],
             dict(pad_width=((0, 0), (0, 0), (1, 2), (2, 3)), mode=mode,
                  constant_value=0.5), (0,))
      for mode in ("constant", "edge", "reflect")],
    NdCase("shape", "Pad", "Pad", [_IMG[:1]],
           dict(pad_width=((0, 0), (1, 0), (1, 1), (0, 2)),
                mode="constant"), (0,)),
    NdCase("shape", "depth_to_space", "depth_to_space",
           [_nd_rand(17, 1, 8, 2, 3)], dict(block_size=2), (0,)),
    NdCase("shape", "space_to_depth", "space_to_depth",
           [_nd_rand(18, 1, 2, 4, 6)], dict(block_size=2), (0,)),
    NdCase("shape", "concat", "concat", [_X, _nd_rand(19, 3, 2)], {},
           (0, 1)),
    NdCase("shape", "concat_axis", "concat", [_X, _nd_rand(19, 2, 4)],
           dict(axis=0), (0, 1)),
    NdCase("shape", "concatenate", "concatenate", [_X, _X], dict(axis=-1),
           (0, 1)),
    NdCase("shape", "Concat", "Concat", [_X, _X, _POS], dict(dim=0),
           (0, 1, 2)),
    NdCase("shape", "stack", "stack", [_X, _POS, _UNIT], dict(axis=1),
           (0, 1, 2)),
    NdCase("shape", "split", "split", [_nd_rand(20, 2, 6)],
           dict(num_outputs=3, axis=1), (0,)),
    NdCase("shape", "split_squeeze", "split", [_IMG[:, :3]],
           dict(num_outputs=3, axis=1, squeeze_axis=True), (0,)),
    NdCase("shape", "SliceChannel", "SliceChannel", [_IMG],
           dict(num_outputs=2), (0,)),
    NdCase("shape", "slice_channel", "slice_channel", [_IMG],
           dict(num_outputs=2, axis=-1), (0,)),
    NdCase("shape", "broadcast_axis", "broadcast_axis",
           [_nd_rand(21, 1, 2, 1)], dict(axis=(0, 2), size=(3, 4)), (0,)),
    NdCase("shape", "broadcast_axes", "broadcast_axes",
           [_nd_rand(21, 1, 2, 1)], dict(axis=0, size=3), (0,)),
    NdCase("shape", "diag", "diag", [_X], dict(k=1), (0,)),
    NdCase("shape", "diag_vector", "diag", [_f32([1, 2, 3])], dict(k=-1),
           (0,)),
    NdCase("shape", "diag_batched", "diag", [_IMG[0]], {}, (0,)),
    NdCase("shape", "zeros_like", "zeros_like", [_X], exact=True),
    NdCase("shape", "ones_like", "ones_like", [_X], exact=True),
    NdCase("shape", "shape_array", "shape_array", [_IMG], exact=True),
    NdCase("shape", "size_array", "size_array", [_IMG], exact=True),
    NdCase("indexing", "gather_nd", "gather_nd",
           [_nd_rand(22, 3, 4, 2), _f32([[0, 2, -1, 5], [1, -5, 3, 0]])],
           grad=(0,), exact=True),
    # index (0, 1) written twice: the last write wins; (5, 0) is out of
    # range and writes nothing
    NdCase("indexing", "scatter_nd_repeated", "scatter_nd",
           [_nd_rand(23, 5, 2), _f32([[0, 2, 0, 1, 5], [1, 3, 1, 0, 0]])],
           dict(shape=(3, 4, 2)), (0,), exact=True),
    NdCase("indexing", "where", "where",
           [_f32([[1, 0, 2, 0], [0, 0, 1, 1], [3, 0, 0, 1]]), _X, _POS],
           grad=(1, 2), exact=True),
    NdCase("indexing", "boolean_mask", "boolean_mask",
           [_nd_rand(24, 4, 3), _f32([1, 0, 1, 1])], exact=True),
    NdCase("indexing", "slice_like", "slice_like",
           [_nd_rand(25, 3, 4, 5), _nd_rand(26, 2, 4, 3)],
           dict(axes=(0, 2)), (0,), exact=True),
    NdCase("indexing", "batch_take", "batch_take",
           [_nd_rand(27, 4, 5), _f32([0, 4, -1, 7])], grad=(0,),
           exact=True),
    NdCase("indexing", "ravel_multi_index", "ravel_multi_index",
           [_f32([[0, 1, 2], [3, 0, 4]])], dict(shape=(3, 5)), exact=True),
    NdCase("indexing", "unravel_index", "unravel_index",
           [_f32([7, 0, 14, 22])], dict(shape=(3, 5)), exact=True),
    NdCase("indexing", "index_array", "index_array", [_IMG[0]],
           exact=True),
    NdCase("indexing", "index_array_axes", "index_array", [_IMG[0]],
           dict(axes=(0, 2)), exact=True),
    *[NdCase("sequence", f"{name}_{tag}", name, [data, _LENS],
             dict(axis=axis, **extra), (0,), exact=True)
      for name in ("sequence_mask", "sequence_last", "sequence_reverse")
      for tag, data, axis, extra in (
          ("seq_major", _SEQ, 0, {}),
          ("batch_major", np.ascontiguousarray(_SEQ.transpose(1, 0, 2)), 1,
           {}))],
    NdCase("sequence", "sequence_mask_value", "sequence_mask",
           [_SEQ, _LENS], dict(value=-1.0), (0,), exact=True),
    *[NdCase("sequence", f"{name}_no_lengths", name, [_SEQ],
             dict(use_sequence_length=False), (0,), exact=True)
      for name in ("sequence_last", "sequence_reverse")],
    *[NdCase("sequence", name, name, [_SEQ, _LENS],
             dict(use_sequence_length=True), (0,), exact=True)
      for name in ("SequenceMask", "SequenceLast", "SequenceReverse")],
    NdCase("ordering", "sort", "sort", [_X], {}, (0,)),
    NdCase("ordering", "sort_descending", "sort", [_X],
           dict(axis=0, is_ascend=False), (0,)),
    NdCase("ordering", "sort_ties_descending", "sort", [_TIES],
           dict(is_ascend=False), (0,)),
    NdCase("ordering", "argsort", "argsort", [_X], exact=True),
    # [1, 3, 3, 2, 3] -> [4, 2, 1, 3, 0]: the flip of a stable ascending
    # sort, ties latest index first
    NdCase("ordering", "argsort_descending_ties", "argsort", [_TIES],
           dict(is_ascend=False), exact=True),
    NdCase("ordering", "argsort_int32", "argsort", [_X],
           dict(axis=0, dtype="int32"), exact=True),
    # lax.top_k: ties to the lower index ([1, 2]; ascending [0, 3])
    NdCase("ordering", "topk_ties", "topk", [_TIES], dict(k=2), exact=True),
    NdCase("ordering", "topk_ties_ascending", "topk", [_TIES],
           dict(k=2, is_ascend=True), exact=True),
    NdCase("ordering", "topk_value", "topk", [_X],
           dict(k=3, ret_typ="value"), exact=True),
    NdCase("ordering", "topk_both", "topk", [_X],
           dict(k=2, axis=0, ret_typ="both", dtype="int32"), exact=True),
    # over two axes jnp's 2-norm is the largest singular value (MXNet:
    # the Frobenius norm); [0.8266, 2.2403, 3.7144] on this input
    NdCase("reductions", "norm_two_axes",
           "norm", [(np.arange(60, dtype=np.float32) / 60).reshape(3, 4, 5)],
           dict(axis=(1, 2)), (0,)),
    NdCase("reductions", "norm_two_axes_fro", "norm", [_IMG],
           dict(ord="fro", axis=(0, 2), keepdims=True), (0,)),
    NdCase("reductions", "norm_two_axes_ord1", "norm", [_IMG],
           dict(ord=1, axis=(-1, 1)), (0,)),
    NdCase("reductions", "moments", "moments", [_IMG],
           dict(axes=(0, 2), keepdims=True), (0,)),
    *[NdCase("activations", n, n, [_X * 2], {}, (0,))
      for n in ("softsign", "softrelu", "gelu", "silu", "mish",
                "hard_sigmoid")],
    NdCase("activations", "gelu_exact", "gelu", [_X * 2],
           dict(approximate=False), (0,)),
    NdCase("activations", "activation", "activation", [_X],
           dict(act_type="softsign"), (0,)),
    *[NdCase("activations", f"LeakyReLU_{act}", "LeakyReLU", [_X * 2],
             dict(act_type=act, slope=0.1), (0,))
      for act in ("leaky", "elu", "selu", "gelu")],
    NdCase("activations", "LeakyReLU_prelu", "LeakyReLU",
           [_IMG, _f32([0.1, 0.2, 0.3, 0.4])], dict(act_type="prelu"),
           (0, 1)),
    NdCase("norms", "LayerNorm", "LayerNorm",
           [_IMG, _nd_rand(30, 6, lo=0.5, hi=1.5), _nd_rand(31, 6)], {},
           (0, 1, 2)),
    NdCase("norms", "LayerNorm_axis1", "LayerNorm",
           [_IMG, _nd_rand(30, 4, lo=0.5, hi=1.5), _nd_rand(31, 4)],
           dict(axis=1, eps=1e-3), (0, 1, 2)),
    NdCase("norms", "InstanceNorm", "InstanceNorm",
           [_IMG, _nd_rand(32, 4, lo=0.5, hi=1.5), _nd_rand(33, 4)], {},
           (0, 1, 2)),
    NdCase("norms", "GroupNorm", "GroupNorm",
           [_IMG, _nd_rand(32, 4, lo=0.5, hi=1.5), _nd_rand(33, 4)],
           dict(num_groups=2), (0, 1, 2), ND_LOOSE),
    NdCase("norms", "rms_norm", "rms_norm",
           [_IMG, _nd_rand(34, 6, lo=0.5, hi=1.5)], {}, (0, 1)),
    *[NdCase("norms", f"L2Normalization_{mode}", "L2Normalization", [_IMG],
             dict(mode=mode), (0,))
      for mode in ("instance", "channel", "spatial")],
    NdCase("norms", "l2_normalization", "l2_normalization", [_IMG], {},
           (0,)),
    NdCase("norms", "adaptive_avg_pool2d", "adaptive_avg_pool2d", [_IMG],
           dict(output_size=2), (0,)),
    NdCase("norms", "BatchNorm_v1", "BatchNorm_v1",
           [_IMG, _nd_rand(35, 4, lo=0.5, hi=1.5), _nd_rand(36, 4),
            _nd_rand(37, 4), _nd_rand(38, 4, lo=0.5, hi=2.0)], {},
           (0, 1, 2)),
    # the positions at or past each row's length get 0 (the reference's
    # mx.nd.softmax refuses an array keyword: its op function takes it)
    NdCase("softmax", "softmax_length", "softmax", [_nd_rand(40, 3, 6)],
           dict(length=_f32([6, 2, 4])), (0,)),
    NdCase("softmax", "SoftmaxActivation", "SoftmaxActivation", [_IMG],
           dict(mode="channel"), (0,)),
    NdCase("softmax", "softmax_cross_entropy", "softmax_cross_entropy",
           [_nd_rand(41, 4, 5) * 3, _f32([0, 4, 2, 1])], grad=(0,)),
    *[NdCase("softmax", f"SoftmaxOutput_{tag}", "SoftmaxOutput",
             [_nd_rand(42, 4, 5) * 3, _f32([0, 3, 2, 3])], kw, (0,))
      for tag, kw in (("null", dict(grad_scale=2.0)),
                      ("batch", dict(normalization="batch")),
                      ("valid", dict(normalization="valid")),
                      ("ignore_valid", dict(use_ignore=True, ignore_label=3,
                                            normalization="valid")),
                      ("ignore_null", dict(use_ignore=True,
                                           ignore_label=2)))],
    NdCase("softmax", "SoftmaxOutput_multi_output", "SoftmaxOutput",
           [_nd_rand(43, 2, 3, 4) * 3, _f32([[0, 2, 1, 1], [2, 2, 0, 1]])],
           dict(multi_output=True, normalization="batch"), (0,)),
    NdCase("softmax", "softmax_output", "softmax_output",
           [_nd_rand(42, 4, 5), _f32([0, 3, 2, 3])], {}, (0,)),
    NdCase("softmax", "Softmax", "op:Softmax",
           [_nd_rand(42, 4, 5), _f32([0, 3, 2, 3])], {}, (0,)),
    *[NdCase("losses", name, name, [_X, _nd_rand(44, 12)],
             dict(grad_scale=2.0), (0,))
      for name in ("LinearRegressionOutput", "MAERegressionOutput",
                   "LogisticRegressionOutput")],
    NdCase("losses", "MakeLoss", "MakeLoss", [_X], dict(grad_scale=3.0),
           (0,)),
    NdCase("losses", "make_loss", "make_loss", [_X], {}, (0,)),
    # normalization and valid_thresh (the JAX package's mx.nd.MakeLoss is
    # ops/more.py's, which reads grad_scale alone: held against
    # ops/misc.py's op)
    NdCase("losses", "make_loss_batch", "make_loss", [_IMG],
           dict(grad_scale=2.0, normalization="batch"), (0,)),
    NdCase("losses", "make_loss_valid", "make_loss", [_X],
           dict(normalization="valid", valid_thresh=0.1), (0,)),
    NdCase("embedding", "Embedding", "Embedding",
           [_f32([[0, 3, -1], [10, 2, -11]]), _nd_rand(45, 10, 4)],
           dict(input_dim=10, output_dim=4), (1,)),
    NdCase("embedding", "embedding", "embedding",
           [_f32([1, 2, 9]), _nd_rand(45, 10, 4)], {}, (1,)),
    *[NdCase("embedding", name, "op:" + name,
             [_f32([1, 0, 9]), _nd_rand(45, 10, 4)], {}, (1,))
      for name in ("SparseEmbedding", "contrib_SparseEmbedding")],
    NdCase("conv", "Deconvolution_1d", "Deconvolution",
           [_nd_rand(50, 2, 3, 7), _nd_rand(51, 3, 2, 3),
            _nd_rand(52, 2)], dict(stride=2, pad=1, adj=1, dilate=1),
           (0, 1, 2),
           ND_LOOSE),
    NdCase("conv", "Deconvolution_groups_dilate", "Deconvolution",
           [_nd_rand(53, 2, 4, 5, 5), _nd_rand(54, 4, 3, 3, 3)],
           dict(kernel=(3, 3), stride=(2, 1), pad=(1, 2), dilate=(1, 2),
                num_group=2), (0, 1), ND_LOOSE),
    NdCase("conv", "Deconvolution_3d", "Deconvolution",
           [_nd_rand(55, 1, 2, 3, 3, 3), _nd_rand(56, 2, 2, 2, 2, 2)],
           dict(stride=2, pad=0, adj=0, dilate=1), (0, 1), ND_LOOSE),
    # adj at or above the stride, which PyTorch's output_padding refuses:
    # 3x3 at stride 2 on 4x4 with adj 2 gives 11x11
    NdCase("conv", "Deconvolution_adj_at_stride", "Deconvolution",
           [_nd_rand(57, 1, 1, 4, 4), _nd_rand(58, 1, 1, 3, 3)],
           dict(stride=(2, 2), adj=(2, 2)), (0, 1), ND_LOOSE),
    NdCase("conv", "Deconvolution_adj_above_stride_pad", "Deconvolution",
           [_nd_rand(57, 1, 1, 4, 4), _nd_rand(58, 1, 1, 3, 3)],
           dict(stride=2, pad=1, adj=3), (0, 1), ND_LOOSE),
    NdCase("conv", "Convolution_v1", "op:Convolution_v1",
           [_nd_rand(59, 1, 2, 5, 5), _nd_rand(60, 3, 2, 3, 3),
            _nd_rand(61, 3)], dict(kernel=(3, 3), pad=(1, 1)), (0, 1, 2),
           ND_LOOSE),
    NdCase("conv", "Pooling_v1", "Pooling_v1", [_IMG],
           dict(kernel=(2, 2), pool_type="avg"), (0,)),
    NdCase("spatial", "UpSampling_nearest", "UpSampling", [_IMG],
           dict(scale=2), (0,)),
    NdCase("spatial", "UpSampling_bilinear", "UpSampling", [_IMG],
           dict(scale=2, sample_type="bilinear"), (0,)),
    NdCase("spatial", "BilinearResize2D", "BilinearResize2D", [_IMG],
           dict(height=5, width=9), (0,)),
    NdCase("spatial", "BilinearResize2D_half_pixel", "BilinearResize2D",
           [_IMG], dict(scale_height=2.0, scale_width=0.5,
                        align_corners=False), (0,)),
    NdCase("spatial", "GridGenerator_affine", "GridGenerator",
           [_nd_rand(62, 2, 6)], dict(target_shape=(3, 4)), (0,)),
    NdCase("spatial", "GridGenerator_warp", "GridGenerator",
           [_nd_rand(63, 2, 2, 3, 4)], dict(transform_type="warp"), (0,)),
    NdCase("spatial", "BilinearSampler", "BilinearSampler",
           [_IMG, _nd_rand(64, 2, 2, 3, 5, lo=-1.2, hi=1.2)], {}, (0, 1)),
    NdCase("spatial", "SpatialTransformer", "SpatialTransformer",
           [_IMG, _f32([1, 0, 0, 0, 1, 0]) + 0.2 * _nd_rand(65, 2, 6)],
           dict(target_shape=(3, 5)), (0, 1)),
    # corners at .5 round half to even (jnp.round)
    NdCase("roi", "ROIPooling", "ROIPooling",
           [_nd_rand(66, 2, 3, 8, 8), _f32([[0, 1.5, 2.5, 6.5, 7.0],
                                            [1, 0, 0, 3.2, 4.6],
                                            [0, 2.5, 0.5, 2.5, 4.5]])],
           dict(pooled_size=(2, 3)), (0,)),
    NdCase("roi", "ROIPooling_scaled", "ROIPooling",
           [_nd_rand(66, 2, 3, 8, 8), _f32([[1, 3, 1, 13, 11],
                                            [0, 5, 5, 9, 15]])],
           dict(pooled_size=(3, 2), spatial_scale=0.5), (0,)),
    NdCase("roi", "ROIAlign", "ROIAlign",
           [_nd_rand(66, 2, 3, 8, 8), _f32([[0, 1.5, 2.5, 6.5, 7.0],
                                            [1, 0, 0, 3.2, 4.6]])],
           dict(pooled_size=(2, 2)), (0,)),
    NdCase("roi", "ROIAlign_aligned", "ROIAlign",
           [_nd_rand(66, 2, 3, 8, 8), _f32([[1, 3, 1, 13, 11],
                                            [0, 5, 5, 9, 15]])],
           dict(pooled_size=(2, 3), spatial_scale=0.5, sample_ratio=3,
                aligned=True), (0,)),
    NdCase("aliases", "broadcast_minus", "broadcast_minus",
           [_X, _nd_rand(67, 1, 4)], {}, (0, 1)),
    NdCase("aliases", "broadcast_plus", "broadcast_plus",
           [_X, _nd_rand(67, 1, 4)], {}, (0, 1)),
]


def _nd_fn(pkg, name):
    """``pkg.nd.<name>`` (dotted through ``random``/``image``/``contrib``),
    ``pkg.np.<dotted>`` for ``"np:<dotted>"``, or ``invoke_op`` of
    ``"op:<registered name>"``."""
    if name.startswith("op:"):
        return functools.partial(pkg.nd.invoke_op, name[3:])
    if name.startswith("np:"):
        return functools.reduce(getattr, name[3:].split("."), pkg.np)
    return functools.reduce(getattr, name.split("."), pkg.nd)


def _head_terms(nd, outs, sq, ctx):
    """``sum(out * w)`` over the float outputs, ``w`` drawn from a seed;
    a complex output by its real and imaginary parts; an output in ``sq``
    squared first."""
    head = None
    for i, o in enumerate(outs):
        dt = np.dtype(o.dtype)
        if not np.issubdtype(dt, np.inexact):
            continue
        parts = [nd.real(o), nd.imag(o)] if np.issubdtype(
            dt, np.complexfloating) else [o]
        for j, p in enumerate(parts):
            if i in sq:
                p = p * p
            term = (p * nd.array(_nd_rand(99 + i + 50 * j, *p.shape),
                                 ctx=ctx)).sum()
            head = term if head is None else head + term
    return head


def run_nd_case(pkg, case, ctx=None, raw_array_kwargs=False):
    """``case`` through ``pkg`` (either package's ``mx``) on ``ctx`` (also
    the default context of the call, for the creators): its outputs (after
    ``case.post``), then the gradients of ``_head_terms`` at ``case.grad``,
    as numpy arrays. ``raw_array_kwargs`` passes an array keyword as the
    package's own array (the JAX package's op functions take one; its
    ``mx.nd`` does not unwrap an NDArray keyword)."""
    nd = pkg.nd
    with ctx if ctx is not None else contextlib.nullcontext():
        xs = [nd.array(a, ctx=ctx, dtype=a.dtype)
              if isinstance(a, np.ndarray) else a for a in case.arrays]
        kwargs = {}
        for key, v in case.kwargs.items():
            if isinstance(v, np.ndarray):
                v = nd.array(v, ctx=ctx, dtype=v.dtype)
                v = v._data if raw_array_kwargs else v
            kwargs[key] = v
        fn = _nd_fn(pkg, case.name)
        for i in case.grad:
            xs[i].attach_grad()
        # recorded only for gradients: the JAX package's tape would
        # differentiate ops that have no rule (nextafter)
        with pkg.autograd.record() if case.grad \
                else contextlib.nullcontext():
            if case.name in NP_SEQUENCE_ARGS:
                out = fn(xs, **kwargs)
            else:
                out = fn(*xs, **kwargs)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            head = _head_terms(nd, outs, case.sq, ctx) if case.grad else None
        if case.grad:
            head.backward()
        got = [o.asnumpy() for o in outs]
    if case.post is not None:
        got = list(case.post(got))
    return got + [xs[i].grad.asnumpy() for i in case.grad]


def check_nd_case(case, got, want):
    """``got`` against ``want`` (``run_nd_case`` results): the same
    shapes and types, values bit for bit where ``case.exact`` or integer,
    else (real or complex) within ``case.tol``; returns the largest
    absolute error."""
    if len(got) != len(want):
        raise AssertionError(f"{case.id}: {len(got)} results, want "
                             f"{len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        label = f"{case.id} result {i}"
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label}: {g.dtype}{g.shape}, want "
                                 f"{w.dtype}{w.shape}")
        if case.exact or not np.issubdtype(w.dtype, np.inexact):
            np.testing.assert_array_equal(g, w, err_msg=label)
            continue
        np.testing.assert_allclose(g, w, err_msg=label,
                                   **(case.tol or ND_TOL))
        both = np.isfinite(g) & np.isfinite(w)
        if both.any():
            worst = max(worst, float(np.abs(g[both] - w[both]).max()))
    return worst


#: ``mx.np`` functions that take their arrays as one sequence
NP_SEQUENCE_ARGS = ("np:concatenate", "np:linalg.multi_dot")


def nd_dropout_checks(mx, ctx, n=200_000, p=0.3, sigmas=4.0):
    """``mx.nd.Dropout`` by its statistics (its mask is the port's
    generator's draw, so no draw is compared): the kept share of ``n``
    ones within ``sigmas`` standard deviations of 1 - ``p``, each kept
    value 1 / (1 - p), one draw along ``axes`` (the mask broadcast), the
    identity when not training, and ``training`` read from
    ``autograd.is_training()`` by default (on inside ``record()``). Returns
    the kept share."""
    nd = mx.nd
    ones = nd.ones((n,), ctx=ctx)
    out = nd.Dropout(ones, p=p, training=True).asnumpy()
    kept = out != 0
    share = float(kept.mean())
    sd = math.sqrt(p * (1 - p) / n)
    if abs(share - (1 - p)) > sigmas * sd:
        raise AssertionError(f"Dropout keeps {share} of {n}, want "
                             f"{1 - p} within {sigmas} x {sd:.2e}")
    if not np.allclose(out[kept], 1 / (1 - p), rtol=1e-6, atol=0):
        raise AssertionError("Dropout: a kept value is not 1 / (1 - p)")
    cube = nd.Dropout(nd.ones((64, 8, 32), ctx=ctx), p=p, axes=(1,),
                      training=True).asnumpy()
    if not (cube == cube[:, :1, :]).all() or not (cube == 0).any():
        raise AssertionError("Dropout(axes=(1,)): the mask is not one draw "
                             "along axis 1")
    x = nd.array(_nd_rand(70, 4, 5), ctx=ctx)
    if not np.array_equal(nd.Dropout(x, p=p).asnumpy(), x.asnumpy()) \
            or not np.array_equal(nd.Dropout(x, p=p, training=False)
                                  .asnumpy(), x.asnumpy()):
        raise AssertionError("Dropout is not the identity outside training")
    with mx.autograd.record():
        recorded = nd.Dropout(nd.ones((1000,), ctx=ctx), p=p).asnumpy()
    if (recorded != 0).all():
        raise AssertionError("mx.nd.Dropout inside record() dropped nothing")
    return share


def nd_cases_phase(mx, dev_ctx, cases=ND_CASES):
    """Every case of ``cases`` on the card against the same call on the
    CPU in the port (held to the JAX package by the CPU tests), with
    gradients: one line an op family; raises on the first difference.
    Then Dropout's statistics on the card."""
    families = _check_cases(mx, dev_ctx, cases, run_nd_case, check_nd_case)
    for name, fam in families.items():
        print(f"mx.nd ops on {dev_ctx} vs the CPU, {name}: {fam['cases']} "
              f"cases equal (largest float difference {fam['worst']:.3e})",
              flush=True)
    share = nd_dropout_checks(mx, dev_ctx)
    print(f"mx.nd.Dropout on {dev_ctx}: kept share {share:.5f} (p 0.3), "
          "axes broadcast, identity outside training, training read from "
          "autograd", flush=True)
    return families


def nd_gpt_logits(nd, params, tokens, num_layers, num_heads, dropout=0.0):
    """The GPT decoder's forward (``gluon.model_zoo.gpt.GPTDecoder``)
    written in ``mx.nd`` ops alone, for either package: ``tokens`` (B, T)
    -> logits (B*T, V). ``params``: NDArrays by the decoder's parameter
    names."""
    b, t = tokens.shape
    vocab, units = params["head.weight"].shape
    d = units // num_heads

    def ln(x, name):
        return nd.LayerNorm(x, params[name + ".gamma"], params[name + ".beta"],
                            axis=-1, eps=1e-5)

    def dense(x, name, width, bias=True):
        return nd.FullyConnected(x, params[name + ".weight"],
                                 params[name + ".bias"] if bias else None,
                                 num_hidden=width, flatten=False)

    def heads(x):
        return nd.transpose(nd.reshape(x, shape=(b, t, num_heads, d)),
                            axes=(0, 2, 1, 3))

    pos = nd.arange(t, ctx=tokens.context)
    x = nd.broadcast_add(nd.Embedding(tokens, params["word_embed.weight"]),
                         nd.Embedding(pos, params["position_embed.weight"]))
    x = nd.Dropout(x, p=dropout)
    for i in range(num_layers):
        pre = f"layer{i}."
        q, k, v = nd.split(dense(ln(x, pre + "ln1"), pre + "attn.qkv",
                                 3 * units), num_outputs=3, axis=-1)
        a = nd.flash_attention(heads(q), heads(k), heads(v), causal=True)
        a = nd.reshape(nd.transpose(a, axes=(0, 2, 1, 3)),
                       shape=(b, t, units))
        x = x + nd.Dropout(dense(a, pre + "attn.proj", units), p=dropout)
        f = nd.gelu(dense(ln(x, pre + "ln2"), pre + "ffn1", 4 * units))
        x = x + nd.Dropout(dense(f, pre + "ffn2", units), p=dropout)
    logits = dense(ln(x, "ln_f"), "head", vocab, bias=False)
    return nd.reshape(logits, shape=(b * t, vocab))


def nd_gpt_step(mx, params, tokens, labels, num_layers, num_heads,
                dropout=0.0):
    """One training step of ``nd_gpt_logits`` with the loss of
    ``mx.nd.SoftmaxOutput(normalization="valid")``: records, runs the
    backward (the gradients land in ``params``), and returns the mean
    cross entropy of ``labels`` (B*T,)."""
    nd = mx.nd
    with mx.autograd.record():
        probs = nd.SoftmaxOutput(nd_gpt_logits(nd, params, tokens,
                                               num_layers, num_heads,
                                               dropout),
                                 labels, normalization="valid")
    probs.backward()
    return float(-nd.log(nd.pick(probs, labels)).mean().asscalar())


def _check_nd_launches(flash, routes, want, want_routes):
    if flash != want or routes != want_routes:
        raise AssertionError(f"mx.nd GPT step: flash launches {flash} by "
                             f"route {routes}, want {want} by route "
                             f"{want_routes}")


def nd_phase(seed, card, net, ctx, b=8, lr=3e-4, dropout=0.1,
             cases=ND_CASES, reps=5):
    """The mx.nd phase on a GPT decoder ``net`` (dropout 0) at B=``b``,
    T=its ``max_length``: (a) ``nd_gpt_step`` on the net's own parameters,
    its loss and every gradient against the gluon forward's with
    ``SoftmaxCrossEntropyLoss`` (mean), a learning check with ``dropout``
    (5 ``gluon.Trainer`` adam steps), the flash launches by route of those
    steps, then the step timed beside the gluon step (dropout 0 in both)
    and profiled; (b) ``nd_cases_phase`` on ``cases``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    t0_phase = time.perf_counter()
    t, vocab = net.max_length, net.vocab_size
    layers, heads = net.num_layers, net.num_heads
    n_rows = b * t
    rs = np.random.RandomState(seed + 7)
    tokens = mx.nd.array(rs.randint(0, vocab, (b, t)), ctx=ctx)
    labels = mx.nd.array(rs.randint(0, vocab, (n_rows,)), ctx=ctx)
    named = [(n, p) for n, p in _param_tensors(net).items()
             if p.requires_grad]
    names = [n for n, _ in named]
    params = {n: NDArray(p) for n, p in named}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})

    def gluon_step():
        with mx.autograd.record():
            loss = ce(net(tokens).reshape((-1, vocab)), labels).mean()
        loss.backward()
        return loss.asscalar()

    def nd_step(p=0.0):
        return nd_gpt_step(mx, params, tokens, labels, layers, heads, p)

    ref_loss = float(gluon_step())
    ref_grads = [p.grad.clone() for _, p in named]
    torch.cuda.synchronize()
    _reset_launches(fa)
    loss0 = nd_step()
    grads = [p.grad for _, p in named]
    worst = _worst_grad("mx.nd GPT step", names, grads, ref_grads,
                        IMPERATIVE_GRAD_RTOL)
    print(f"mx.nd GPT step oracle (fp32, B={b}, T={t}, {len(names)} "
          f"parameter tensors): mean cross entropy {loss0:.6f} "
          f"(SoftmaxOutput) vs {ref_loss:.6f} (gluon, "
          f"SoftmaxCrossEntropyLoss); worst gradient relative L2 error "
          f"{worst[0]:.3e} ({worst[1]}), tolerance {IMPERATIVE_GRAD_RTOL:g}",
          flush=True)
    if not abs(loss0 - ref_loss) <= 1e-5 * abs(ref_loss):
        raise AssertionError("mx.nd GPT step: the loss differs from the "
                             "gluon step's")
    del ref_grads
    losses = [nd_step(dropout)]
    trainer.step(1)                 # SoftmaxOutput("valid"): a mean already
    for _ in range(5):
        losses.append(nd_step(dropout))
        trainer.step(1)
    passes = 7
    flash = _read_launches(fa)
    routes = _read_routes(fa)
    print(f"mx.nd GPT learning check (dropout {dropout}, gluon.Trainer adam "
          f"lr {lr:g}, one batch): mean cross entropy "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("mx.nd GPT step: the loss did not fall by 5% "
                             "over 5 steps")
    print(f"mx.nd GPT step launches over {passes} passes: {flash}; by route "
          f"{ {k: v for k, v in routes.items() if v} }", flush=True)
    _check_nd_launches(flash, routes, {k: layers * passes for k in COUNTERS},
                       training_routes(passes, 0, layers, t, net.head_dim))

    def nd_train():
        nd_step()
        trainer.step(1)

    def gluon_train():
        gluon_step()
        trainer.step(1)

    gc.collect()
    times = _median_turns({"nd": nd_train, "gluon": gluon_train}, reps)
    print(f"mx.nd GPT step (fp32, B={b}, T={t}, dropout 0; {card}): "
          f"{times['nd']:.3f} ms a step beside the gluon step's "
          f"{times['gluon']:.3f} (host clock, median of {reps} alternating "
          "turns, each with its gluon.Trainer adam step)", flush=True)
    profile = _profile_step(lambda *_: nd_train(), None, None, card,
                            times["nd"], top=12, what="fp32 mx.nd GPT step")
    device_ms = sum(r[0] for r in profile)
    gluon_device_ms = _kernel_ms(gluon_train)
    print(f"device time a step: mx.nd {device_ms:.3f} ms, gluon "
          f"{gluon_device_ms:.3f} ms (torch.profiler)", flush=True)
    gc.collect()
    families = nd_cases_phase(mx, ctx, cases)
    seconds = time.perf_counter() - t0_phase
    print(f"mx.nd phase: {seconds:.1f} s", flush=True)
    return dict(n_params=len(names), grad_worst_rel=worst[0], loss=loss0,
                ref_loss=ref_loss, learning_losses=losses, passes=passes,
                flash_launches=flash, flash_routes=routes,
                step_ms=times["nd"], gluon_step_ms=times["gluon"],
                device_ms=device_ms, gluon_device_ms=gluon_device_ms,
                families=families, seconds=seconds)


def nd_main(seed, card):
    """The mx.nd phase, then the mx.np phase, on ``gpt_decoder_117m`` at
    ``max_length`` 256 (12 layers, 768 units, vocab 50257; 149 trainable
    tensors)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    net = get_gpt("gpt_decoder_117m", vocab_size=50257, dropout=0.0,
                  max_length=256).initialize("xavier", ctx=ctx)
    out = nd_phase(seed, card, net, ctx)
    if out["n_params"] != 149:
        raise AssertionError("gpt_decoder_117m has 149 trainable tensors")
    gc.collect()
    out["np"] = np_phase(seed, card, net, ctx)
    return out


# ---------------------------------------------------------------------------
# mx.nd 1.x phase: ops/more.py, ops/random_ops.py and ops/optimizer_ops.py,
# and a GluonNLP-1.x-style BERT step written in them
# ---------------------------------------------------------------------------
_NCHW = _nd_rand(80, 2, 6, 5, 5)
_HWC = _nd_rand(81, 8, 8, 3, lo=0.0, hi=1.0)
_NHWC = _nd_rand(82, 2, 5, 7, 3, lo=0.0, hi=1.0)
_QKV = _nd_rand(83, 5, 2, 3 * 2 * 4)            # (T, N, 3*H*D), H=2, D=4
_Q = _nd_rand(84, 3, 2, 2 * 4)                  # (Tq, N, H*D)
_KV = _nd_rand(85, 5, 2, 2 * 2 * 4)             # (Tk, N, 2*H*D)
_ATT = _nd_rand(86, 4, 5, 5, lo=0.0, hi=0.4)    # (N*H, T, T)
_ATT_DEC = _nd_rand(87, 4, 3, 5, lo=0.0, hi=0.4)
_INTS = np.random.RandomState(88).randint(-4, 5, (2, 3, 6, 5)).astype(
    np.float32)
# a mask with a row of no valid position (row 1) and a partial row
_MASK = _f32([[1, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 0]])
_MASK0 = _f32([[1, 0, 1, 1], [0, 0, 1, 0], [1, 0, 1, 0]])
# (T, N, C) = (6, 3, 5) activations; labels padded with -1; sample 2 asks
# for 5 labels, with a repeat, of 6 frames (2 of them cut by its length):
# an alignment that cannot be made
_CTC = _nd_rand(89, 6, 3, 5, lo=-2.0, hi=2.0)
_CTC_LABELS = _f32([[1, 2, -1, -1, -1], [3, 3, 1, -1, -1],
                    [2, 2, 2, 2, 4]])
_CTC_BLANK_LAST = _f32([[0, 1, -1, -1, -1], [2, 2, 0, -1, -1],
                        [1, 3, 3, -1, -1]])
#: the tolerance of a CTC gradient through path costs near 1e5
CTC_FAR = dict(rtol=1e-5, atol=5e-3)
_OFFSETS = _nd_rand(90, 2, 2 * 9 * 2, 3, 3, lo=-1.5, hi=1.5)
_POS_S = _nd_rand(91, 3, 4, lo=0.2, hi=3.0)
_PROB = _nd_rand(92, 3, 4, lo=0.1, hi=0.9)
_COUNTS = np.random.RandomState(93).randint(0, 6, (3, 4)).astype(
    np.float32)
_DIR = np.random.RandomState(94).dirichlet([1.0, 2.0, 3.0], 4).astype(
    np.float32)

MORE_CASES = [
    # image ops: HWC and NHWC
    NdCase("image", "to_tensor", "image.to_tensor",
           [np.random.RandomState(95).randint(0, 256, (4, 5, 3)).astype(
               np.uint8)]),
    NdCase("image", "to_tensor_batch", "image.to_tensor",
           [np.random.RandomState(96).randint(0, 256, (2, 4, 5, 3)).astype(
               np.uint8)]),
    NdCase("image", "normalize", "image.normalize", [_NCHW[0, :3]],
           dict(mean=(0.1, 0.2, 0.3), std=(0.5, 1.5, 2.0)), (0,)),
    NdCase("image", "normalize_batch", "image.normalize", [_NCHW[:, :3]],
           dict(mean=(0.1, 0.2, 0.3), std=(0.5, 1.5, 2.0)), (0,)),
    # jax.image.resize antialiases a downscale (F.interpolate's default
    # does not: 0.14 apart on 8x8 -> 4x4, 0.32 on 3x5)
    NdCase("image", "resize_down_antialiased", "image.resize", [_HWC],
           dict(size=4), (0,)),
    NdCase("image", "resize_down_3x5", "image.resize", [_HWC],
           dict(size=(5, 3)), (0,)),
    NdCase("image", "resize_up_batch", "image.resize", [_NHWC],
           dict(size=(9, 8)), (0,)),
    NdCase("image", "resize_nearest", "image.resize", [_NHWC],
           dict(size=(4, 3), interp=0), (0,)),
    # an integer image resizes to float32
    NdCase("image", "resize_uint8", "image.resize",
           [np.random.RandomState(95).randint(0, 256, (6, 5, 3)).astype(
               np.uint8)], dict(size=(3, 4))),
    NdCase("image", "crop", "image.crop", [_HWC],
           dict(x0=1, y0=2, width=4, height=3), (0,), exact=True),
    NdCase("image", "crop_batch", "image.crop", [_NHWC],
           dict(x0=2, y0=1, width=3, height=2), (0,), exact=True),
    NdCase("image", "flip_left_right", "image.flip_left_right", [_NHWC],
           {}, (0,), exact=True),
    NdCase("image", "flip_top_bottom", "image.flip_top_bottom", [_HWC],
           {}, (0,), exact=True),
    # classic NN stragglers
    NdCase("nn", "LRN", "LRN", [_NCHW], dict(nsize=3, alpha=0.01), (0,)),
    NdCase("nn", "lrn", "op:lrn", [_NCHW], dict(beta=0.5, knorm=1.0), (0,)),
    NdCase("nn", "softmin", "softmin", [_X], dict(axis=0), (0,)),
    # a row with no valid position: 0 forward (log: -inf) and a 0 gradient
    NdCase("nn", "masked_softmax_empty_row", "masked_softmax",
           [_X, _MASK], {}, (0,)),
    NdCase("nn", "masked_softmax_temperature", "masked_softmax",
           [_X, _MASK0], dict(axis=0, temperature=0.5), (0,)),
    NdCase("nn", "masked_log_softmax_empty_row", "masked_log_softmax",
           [_X, _MASK], {}, (0,)),
    NdCase("nn", "identity", "identity", [_X], {}, (0,), exact=True),
    NdCase("nn", "_copy", "op:_copy", [_X], exact=True),
    NdCase("nn", "stop_gradient_op", "stop_gradient_op", [_X], exact=True),
    NdCase("nn", "BlockGrad_op", "op:BlockGrad", [_X], exact=True),
    NdCase("nn", "add_n", "add_n", [_X, _POS, _UNIT], {}, (0, 1, 2)),
    NdCase("nn", "ElementWiseSum", "ElementWiseSum", [_X, _POS], {},
           (0, 1)),
    NdCase("nn", "argmax_channel", "argmax_channel", [_NCHW], exact=True),
    # Crop (NCHW): like another array, at an offset, centred, by h_w
    NdCase("layout", "Crop_like", "Crop", [_NCHW, _IMG[:1, :1, :3, :2]],
           dict(offset=(1, 2)), exact=True),
    NdCase("layout", "Crop_center", "Crop", [_NCHW],
           dict(h_w=(2, 3), center_crop=True), exact=True),
    NdCase("layout", "crop_like", "op:crop_like", [_NCHW],
           dict(h_w=(3, 2), offset=(2, 1)), exact=True),
    NdCase("layout", "im2col", "im2col", [_NCHW],
           dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2), pad=(1, 1)),
           (0,)),
    NdCase("layout", "im2col_ints", "im2col", [_INTS],
           dict(kernel=(2, 3), pad=(1, 0)), exact=True),
    NdCase("layout", "col2im", "col2im", [_nd_rand(97, 2, 6 * 6, 15)],
           dict(output_size=(5, 5), kernel=(3, 2), stride=(2, 1),
                dilate=(1, 2), pad=(1, 1)), (0,)),
    # overlaps sum: integer values sum exactly
    NdCase("layout", "col2im_ints", "col2im",
           [np.random.RandomState(98).randint(-4, 5, (2, 18, 21)).astype(
               np.float32)],
           dict(output_size=(6, 5), kernel=(2, 3), pad=(1, 0)), exact=True),
    # the FlowNet fast path: kernel_size and stride1 are not read
    NdCase("vision", "Correlation", "Correlation", [_NCHW, _NCHW[::-1]],
           dict(max_displacement=2, stride2=2, pad_size=1), (0, 1)),
    NdCase("vision", "Correlation_ignores_kernel_size", "Correlation",
           [_NCHW, _NCHW[::-1]],
           dict(kernel_size=3, stride1=2, max_displacement=1), (0, 1)),
    NdCase("vision", "Correlation_abs", "Correlation", [_NCHW, _NCHW[::-1]],
           dict(max_displacement=1, is_multiply=False), (0, 1)),
    NdCase("vision", "DeformableConvolution", "DeformableConvolution",
           [_NCHW[:, :4], _OFFSETS, _nd_rand(99, 3, 4, 3, 3),
            _nd_rand(100, 3)],
           dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                num_deformable_group=2, num_filter=3), (0, 1, 2, 3)),
    NdCase("vision", "DeformableConvolution_no_bias",
           "contrib.DeformableConvolution",
           [_NCHW[:, :4], _OFFSETS[:, :18], _nd_rand(99, 3, 4, 3, 3)],
           dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), stride=(2, 2),
                num_filter=3), (0, 1, 2)),
    # CTC: optax's lattice, labels padded with -1 or cut by lengths
    NdCase("ctc", "CTCLoss", "CTCLoss", [_CTC[:, :2], _CTC_LABELS[:2]], {},
           (0,)),
    NdCase("ctc", "ctc_loss_lengths", "ctc_loss",
           [_CTC, _CTC_LABELS, _f32([6, 5, 6]), _f32([2, 3, 1])], {}, (0,)),
    NdCase("ctc", "ctc_loss_blank_last", "contrib.ctc_loss",
           [_CTC, _CTC_BLANK_LAST], dict(blank_label="last"), (0,)),
    # sample 2 cannot align: about 1e5 (log 0 is -1e5), finite. Its
    # gradient is a difference of path costs near 1e5, where fp32 keeps
    # steps of 0.0078, so either side carries ~1e-3 of rounding there
    NdCase("ctc", "CTCLoss_impossible", "CTCLoss",
           [_CTC, _CTC_LABELS, _f32([6, 6, 4])], {}, (0,), CTC_FAR),
    # the fused transformer matmuls: (T, N, H, 3, D) interleaved
    NdCase("attention", "selfatt_qk", "interleaved_matmul_selfatt_qk",
           [_QKV], dict(heads=2), (0,)),
    NdCase("attention", "selfatt_valatt",
           "interleaved_matmul_selfatt_valatt", [_QKV, _ATT], dict(heads=2),
           (0, 1)),
    NdCase("attention", "encdec_qk", "interleaved_matmul_encdec_qk",
           [_Q, _KV], dict(heads=2), (0, 1)),
    NdCase("attention", "encdec_valatt", "interleaved_matmul_encdec_valatt",
           [_KV, _ATT_DEC], dict(heads=2), (0, 1)),
    NdCase("attention", "div_sqrt_dim", "contrib.div_sqrt_dim", [_IMG], {},
           (0,)),
    # shape-derived and indexing stragglers
    NdCase("shape", "arange_like", "arange_like", [_IMG],
           dict(start=1.5, step=0.5, repeat=2), exact=True),
    NdCase("shape", "arange_like_axis", "contrib.arange_like", [_IMG],
           dict(axis=2), exact=True),
    NdCase("shape", "broadcast_like", "broadcast_like",
           [_nd_rand(101, 3, 1), _X], {}, (0,)),
    NdCase("shape", "broadcast_like_axes", "broadcast_like",
           [_nd_rand(102, 1, 4, 1), _IMG], dict(lhs_axes=(0, 2),
                                                rhs_axes=(0, 1)), (0,)),
    NdCase("shape", "reshape_like", "reshape_like",
           [_X, np.zeros((2, 6), np.float32)], {}, (0,)),
    NdCase("shape", "nan_to_num", "nan_to_num",
           [_f32([np.nan, np.inf, -np.inf, 1.5])],
           dict(nan=-1.0, posinf=9.0), exact=True),
    NdCase("shape", "nan_to_num_defaults", "nan_to_num",
           [_f32([np.nan, np.inf, -np.inf, -2.5])], exact=True),
    NdCase("shape", "choose_element_0index", "choose_element_0index",
           [_X, _f32([3, 0, 2])], exact=True),
    NdCase("shape", "fill_element_0index", "fill_element_0index",
           [_X, _f32([7, 8, 9]), _f32([1, 3, 0])], exact=True),
    NdCase("shape", "index_copy", "contrib.index_copy",
           [_nd_rand(103, 5, 3), _f32([4, 0]), _nd_rand(104, 2, 3)],
           exact=True),
    NdCase("shape", "sparse_retain_rows", "sparse_retain_rows",
           [_nd_rand(105, 5, 2), _f32([3, 0])], exact=True),
    # the loss and contrib ops; SVMOutput's and gradientmultiplier's own
    # backwards
    NdCase("contrib", "SVMOutput", "SVMOutput", [_X, _f32([1, 3, 0])],
           dict(margin=0.5, regularization_coefficient=2.0), (0,)),
    NdCase("contrib", "quadratic", "contrib.quadratic", [_X],
           dict(a=0.5, b=-2.0, c=1.5), (0,)),
    NdCase("contrib", "gradientmultiplier", "contrib.gradientmultiplier",
           [_X], dict(scalar=-0.5), (0,)),
    NdCase("contrib", "AdaptiveAvgPooling2D",
           "contrib.AdaptiveAvgPooling2D", [_NCHW[:, :, :, :4]],
           dict(output_size=(2, 3)), (0,)),
    NdCase("contrib", "AdaptiveAvgPooling2D_op", "op:adaptive_avg_pooling2d",
           [_NCHW], dict(output_size=3), (0,)),
    NdCase("contrib", "BatchNormWithReLU", "contrib.BatchNormWithReLU",
           [_NCHW, _nd_rand(106, 6, lo=0.5, hi=1.5), _nd_rand(107, 6),
            _nd_rand(108, 6), _nd_rand(109, 6, lo=0.5, hi=1.5)], {},
           (0, 1, 2)),
    # in training the batch statistics come back, and carry a gradient
    NdCase("contrib", "BatchNormWithReLU_training",
           "contrib.BatchNormWithReLU",
           [_NCHW, _nd_rand(106, 6, lo=0.5, hi=1.5), _nd_rand(107, 6),
            _nd_rand(108, 6), _nd_rand(109, 6, lo=0.5, hi=1.5)],
           dict(training=True), (0, 1, 2)),
    NdCase("contrib", "BatchNorm_training", "BatchNorm",
           [_NCHW, _nd_rand(106, 6, lo=0.5, hi=1.5), _nd_rand(107, 6),
            _nd_rand(108, 6), _nd_rand(109, 6, lo=0.5, hi=1.5)],
           dict(training=True), (0, 1, 2)),
    NdCase("contrib", "requantize", "contrib.requantize",
           [np.random.RandomState(110).randint(-2**20, 2**20, (3, 4)).astype(
               np.int32), _f32([-8.0]), _f32([6.0])], exact=True),
    NdCase("contrib", "requantize_calibrated", "contrib.requantize",
           [np.random.RandomState(110).randint(-2**20, 2**20, (3, 4)).astype(
               np.int32), _f32([-8.0]), _f32([6.0])],
           dict(min_calib_range=-0.002, max_calib_range=0.003), exact=True),
    # the pdfs, is_log and gradients
    NdCase("pdf", "uniform", "random_pdf_uniform",
           [_nd_rand(111, 3, 4, lo=-1.0, hi=2.0), _f32([[-0.5]] * 3),
            _f32([[1.5]] * 3)], {}, (0, 2)),
    NdCase("pdf", "normal_log", "random_pdf_normal",
           [_X, _nd_rand(112, 3, 4), _POS], dict(is_log=True), (0, 1, 2)),
    NdCase("pdf", "normal", "random_pdf_normal", [_X, _nd_rand(112, 3, 4),
                                                  _POS], {}, (0, 1, 2)),
    NdCase("pdf", "gamma", "random_pdf_gamma", [_POS, _POS_S, _POS[::-1]],
           {}, (0, 1, 2), ND_LOOSE),
    NdCase("pdf", "exponential_log", "random_pdf_exponential", [_POS, _POS_S],
           dict(is_log=True), (0, 1)),
    NdCase("pdf", "poisson", "random_pdf_poisson", [_COUNTS, _POS_S], {},
           (1,), ND_LOOSE),
    NdCase("pdf", "negative_binomial", "random_pdf_negative_binomial",
           [_COUNTS, _POS_S, _PROB], {}, (1, 2), ND_LOOSE),
    NdCase("pdf", "generalized_negative_binomial_log",
           "random_pdf_generalized_negative_binomial",
           [_COUNTS, _POS_S, _PROB], dict(is_log=True), (1, 2), ND_LOOSE),
    NdCase("pdf", "dirichlet", "random_pdf_dirichlet",
           [_DIR, _nd_rand(113, 4, 3, lo=0.5, hi=3.0)], {}, (0, 1),
           ND_LOOSE),
    # the AMP ops and the multi-tensor reductions
    NdCase("amp", "amp_cast", "amp_cast", [_X], exact=True),
    NdCase("amp", "amp_cast_float32", "amp_cast", [_X.astype(np.float16)],
           dict(dtype="float32"), exact=True),
    NdCase("amp", "amp_multicast", "amp_multicast",
           [_X.astype(np.float16), _POS], dict(num_outputs=2), exact=True),
    NdCase("amp", "amp_multicast_narrow", "amp_multicast",
           [_X.astype(np.float16), _POS], dict(num_outputs=2,
                                               cast_narrow=True), exact=True),
    NdCase("amp", "all_finite", "all_finite", [_X], exact=True),
    NdCase("amp", "all_finite_inf", "all_finite",
           [_f32([1.0, np.inf, 2.0])], exact=True),
    NdCase("amp", "multi_all_finite", "multi_all_finite",
           [_X, _f32([np.nan]), _POS], dict(num_arrays=3), exact=True),
    NdCase("amp", "multi_sum_sq", "multi_sum_sq", [_X, _POS, _IMG],
           dict(num_arrays=3)),
    NdCase("amp", "multi_lars", "op:multi_lars",
           [_f32([0.1, 0.2, 0.3]), _f32([4.0, 0.0, 9.0]),
            _f32([1.0, 2.0, 0.25]), _f32([0.01, 0.0, 0.1])],
           dict(eta=0.01, rescale_grad=0.5)),
]

#: one chain of an update op: ``name`` (an ``mx.nd`` update wrapper, run
#: with ``out=`` the weight so its in-place rule carries the state, or
#: ``"op:<name>"`` run functionally, its outputs fed back by ``feeds``:
#: output i -> argument feeds[i]); ``arrays`` the first step's arguments,
#: ``grads`` the argument positions that take the next of ``GRADS`` at
#: each of the three steps; float results within ``tol`` (None: ND_TOL)
UpdCase = collections.namedtuple(
    "UpdCase", "id name arrays kwargs grads feeds tol",
    defaults=({}, (1,), (), None))
_W = _nd_rand(120, 3, 4)
_GRADS = [_nd_rand(121 + i, 3, 4, lo=-2.0, hi=2.0) for i in range(3)]
_OPT = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.6)
_MOM = _nd_rand(124, 3, 4, lo=-0.1, hi=0.1)
_VAR = _nd_rand(125, 3, 4, lo=0.0, hi=0.2)
_Z = np.zeros((3, 4), np.float32)

UPDATE_CASES = [
    UpdCase("sgd_update", "sgd_update", [_W, _Z], dict(lr=0.1, **_OPT)),
    UpdCase("sgd_mom_update", "sgd_mom_update", [_W, _Z, _MOM],
            dict(lr=0.1, momentum=0.9, **_OPT)),
    UpdCase("mp_sgd_update", "mp_sgd_update", [_W, _Z, _W],
            dict(lr=0.1, **_OPT)),
    UpdCase("mp_sgd_mom_update", "mp_sgd_mom_update", [_W, _Z, _MOM, _W],
            dict(lr=0.1, momentum=0.9, **_OPT)),
    UpdCase("nag_mom_update", "nag_mom_update", [_W, _Z, _MOM],
            dict(lr=0.1, momentum=0.9, **_OPT)),
    UpdCase("mp_nag_mom_update", "mp_nag_mom_update", [_W, _Z, _MOM, _W],
            dict(lr=0.1, momentum=0.9, **_OPT)),
    UpdCase("adam_update", "adam_update", [_W, _Z, _MOM, _VAR],
            dict(lr=0.01, **_OPT)),
    UpdCase("adamw_update", "adamw_update", [_W, _Z, _MOM, _VAR],
            dict(lr=0.01, eta=0.7, **_OPT)),
    UpdCase("rmsprop_update", "rmsprop_update", [_W, _Z, _VAR],
            dict(lr=0.01, clip_weights=0.8, **_OPT)),
    UpdCase("rmspropalex_update", "rmspropalex_update",
            [_W, _Z, _VAR + 0.5, _MOM, _MOM], dict(lr=0.01, **_OPT)),
    UpdCase("ftrl_update", "ftrl_update", [_W, _Z, _MOM, _VAR],
            dict(lr=0.1, lamda1=0.05, **_OPT)),
    UpdCase("ftml_update", "ftml_update", [_W, _Z, _VAR, _VAR, _MOM],
            dict(lr=0.1, t=2, wd=0.01, rescale_grad=0.5, clip_grad=0.6)),
    UpdCase("signsgd_update", "signsgd_update", [_W, _Z],
            dict(lr=0.1, **_OPT)),
    UpdCase("signum_update", "signum_update", [_W, _Z, _MOM],
            dict(lr=0.1, momentum=0.9, wd_lh=0.02, **_OPT)),
    UpdCase("lamb_update_phase1", "lamb_update_phase1",
            [_W, _Z, _MOM, _VAR], dict(t=3, **_OPT), feeds=(None, 2, 3)),
    UpdCase("lamb_update_phase1_uncorrected", "lamb_update_phase1",
            [_W, _Z, _MOM, _VAR], dict(bias_correction=False, **_OPT),
            feeds=(None, 2, 3)),
    UpdCase("lamb_update_phase2", "lamb_update_phase2",
            [_W, _Z, _f32([2.0]), _f32([0.5])],
            dict(lr=0.1, lower_bound=0.5, upper_bound=3.0), feeds=(0,)),
    UpdCase("mp_lamb_update_phase1", "op:mp_lamb_update_phase1",
            [_W, _Z, _MOM, _VAR, _W], dict(t=2, wd=0.01, rescale_grad=0.5),
            feeds=(None, 2, 3)),
    UpdCase("mp_lamb_update_phase2", "op:mp_lamb_update_phase2",
            [_W, _Z, _f32([2.0]), _f32([0.5]), _W], dict(lr=0.1),
            feeds=(0, 4)),
    UpdCase("multi_sgd_update", "multi_sgd_update", [_W, _Z, _POS, _Z],
            dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), rescale_grad=0.5,
                 clip_gradient=0.6, num_weights=2), (1, 3), (0, 2)),
    UpdCase("multi_sgd_mom_update", "multi_sgd_mom_update",
            [_W, _Z, _MOM, _POS, _Z, _MOM],
            dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), momentum=0.9,
                 num_weights=2), (1, 4), (0, 2, 3, 5)),
    UpdCase("multi_mp_sgd_update", "op:multi_mp_sgd_update",
            [_W, _Z, _W, _POS, _Z, _POS],
            dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), clip_gradient=0.6,
                 num_weights=2), (1, 4), (0, 2, 3, 5)),
    UpdCase("multi_mp_sgd_mom_update", "op:multi_mp_sgd_mom_update",
            [_W, _Z, _MOM, _W, _POS, _Z, _MOM, _POS],
            dict(lrs=(0.1, 0.2), wds=(0.0, 0.01), momentum=0.9,
                 num_weights=2), (1, 5), (0, 2, 3, 4, 6, 7)),
    # lrs and wds as the last two (device) arrays
    UpdCase("preloaded_multi_sgd_update", "op:preloaded_multi_sgd_update",
            [_W, _Z, _POS, _Z, _f32([0.1, 0.2]), _f32([0.0, 0.01])],
            dict(rescale_grad=0.5), (1, 3), (0, 2)),
    UpdCase("preloaded_multi_sgd_mom_update",
            "op:preloaded_multi_sgd_mom_update",
            [_W, _Z, _MOM, _POS, _Z, _MOM, _f32([0.1, 0.2]),
             _f32([0.0, 0.01])],
            dict(momentum=0.9, clip_gradient=0.6), (1, 4), (0, 2, 3, 5)),
    UpdCase("preloaded_multi_mp_sgd_update",
            "op:preloaded_multi_mp_sgd_update",
            [_W, _Z, _W, _POS, _Z, _POS, _f32([0.1, 0.2]),
             _f32([0.0, 0.01])], {}, (1, 4), (0, 2, 3, 5)),
    UpdCase("preloaded_multi_mp_sgd_mom_update",
            "op:preloaded_multi_mp_sgd_mom_update",
            [_W, _Z, _MOM, _W, _POS, _Z, _MOM, _POS, _f32([0.1, 0.2]),
             _f32([0.0, 0.01])], dict(momentum=0.9, rescale_grad=0.5),
            (1, 5), (0, 2, 3, 4, 6, 7)),
]
#: the ``mx.nd`` update wrappers with the reference's in-place rule: name
#: -> (array arguments, trailing state arrays written in place)
UPDATE_WRAPPERS = {
    "sgd_update": (2, 0), "sgd_mom_update": (3, 1), "mp_sgd_update": (3, 1),
    "mp_sgd_mom_update": (4, 2), "nag_mom_update": (3, 1),
    "adam_update": (4, 2), "adamw_update": (4, 2), "rmsprop_update": (3, 1),
    "rmspropalex_update": (5, 3), "ftrl_update": (4, 2),
    "signsgd_update": (2, 0), "signum_update": (3, 1),
    "ftml_update": (5, 3), "mp_nag_mom_update": (4, 2)}


def run_update_case(pkg, case, ctx=None):
    """Three chained steps of ``case`` through ``pkg.nd`` on ``ctx``, the
    gradients of ``_GRADS`` (scaled per weight); every argument and
    result of the last step as numpy arrays. A wrapper with the in-place
    rule runs with ``out=`` its weight; an op runs functionally, its
    results fed back."""
    nd = pkg.nd
    xs = [nd.array(a, ctx=ctx, dtype=a.dtype) for a in case.arrays]
    fn = _nd_fn(pkg, case.name)
    for step in range(3):
        for j, pos in enumerate(case.grads):
            xs[pos] = nd.array(_GRADS[step] * (1 + j), ctx=ctx)
        if case.name in UPDATE_WRAPPERS:
            res = fn(*xs, out=xs[0], **case.kwargs)
        else:
            res = fn(*xs, **case.kwargs)
            outs = list(res) if isinstance(res, (tuple, list)) else [res]
            feeds = case.feeds or tuple(range(len(outs)))
            for o, pos in zip(outs, feeds):
                if pos is not None:
                    xs[pos] = o
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    return [x.asnumpy() for x in xs + res]


def check_update_case(case, got, want):
    """``got`` against ``want`` (``run_update_case`` results): types and
    shapes equal, floats within ``case.tol``; the largest absolute
    error."""
    return check_nd_case(NdCase("update", case.id, case.name, [],
                                tol=case.tol), got, want)


def update_inplace_checks(mx, ctx):
    """The in-place rule of every update wrapper of ``mx.nd`` (either
    package's ``mx``) on ``ctx``: without ``out=`` the weight keeps its
    value; with ``out=`` it takes the returned weight (in the port, in its
    own tensor); the trailing states always take the returned states, bit
    for bit; the gradient and any other argument never change.
    ``reset_arrays`` zeroes its arguments; ``multi_sgd_update`` writes
    nothing. Returns the number of wrappers checked."""
    nd = mx.nd
    cases = {c.name: c for c in UPDATE_CASES}
    for name, (narr, n_state) in UPDATE_WRAPPERS.items():
        case = cases[name]
        for use_out in (False, True):
            xs = [nd.array(a, ctx=ctx, dtype=a.dtype) for a in case.arrays]
            xs[1] = nd.array(_GRADS[0], ctx=ctx)
            before = [x.asnumpy() for x in xs]
            own = xs[0]._data
            kw = dict(case.kwargs, out=xs[0]) if use_out else case.kwargs
            res = getattr(nd, name)(*xs, **kw)
            res = list(res) if isinstance(res, (tuple, list)) else [res]
            after = [x.asnumpy() for x in xs]
            label = f"{name}{' out=w' if use_out else ''}"
            want_w = res[0].asnumpy() if use_out else before[0]
            if not np.array_equal(after[0], want_w):
                raise AssertionError(f"{label}: the weight")
            if torch.is_tensor(own) and use_out and xs[0]._data is not own:
                raise AssertionError(f"{label}: out= rebound the weight")
            if not np.array_equal(after[1], before[1]):
                raise AssertionError(f"{label}: the gradient changed")
            for k in range(n_state):
                pos = narr - n_state + k
                if not np.array_equal(after[pos], res[1 + k].asnumpy()):
                    raise AssertionError(f"{label}: state {pos} not written")
            for pos in range(2, narr - n_state):
                if not np.array_equal(after[pos], before[pos]):
                    raise AssertionError(f"{label}: argument {pos} changed")
    xs = [nd.array(_W, ctx=ctx), nd.array(_POS, ctx=ctx)]
    zeros = nd.reset_arrays(*xs, num_arrays=2)
    if any(x.asnumpy().any() for x in xs) or len(zeros) != 2:
        raise AssertionError("reset_arrays did not zero its arguments")
    xs = [nd.array(a, ctx=ctx) for a in (_W, _GRADS[0], _POS, _GRADS[1])]
    before = [x.asnumpy() for x in xs]
    nd.multi_sgd_update(*xs, lrs=(0.1, 0.1), wds=(0.0, 0.0), num_weights=2)
    if not all(np.array_equal(x.asnumpy(), b) for x, b in zip(xs, before)):
        raise AssertionError("multi_sgd_update wrote an argument")
    return len(UPDATE_WRAPPERS)


def _moment_check(label, x, mean, var, mu4, sigmas):
    """The sample mean and variance of ``x`` (float64) within ``sigmas``
    standard errors of ``mean``/``var`` (``mu4`` the fourth central
    moment); returns the larger of the two in standard errors."""
    n = x.size
    m = float(x.mean())
    v = float(x.var())
    z_mean = abs(m - mean) / math.sqrt(var / n)
    z_var = abs(v - var) / math.sqrt(max(mu4 - var * var, 1e-30) / n)
    if not (z_mean <= sigmas and z_var <= sigmas):
        raise AssertionError(f"{label}: mean {m} (want {mean}), variance {v} "
                             f"(want {var}): {z_mean:.2f} and {z_var:.2f} "
                             f"standard errors, limit {sigmas}")
    return max(z_mean, z_var)


def sampler_checks(pkg, ctx=None, n=2**20, sigmas=5.0):
    """Every sampler of ``pkg.nd`` (either package's ``mx``) by its
    statistics on ``ctx``: ``n`` draws of each, mean and variance within
    ``sigmas`` standard errors, the support, the dtype and the shape;
    ``randint`` covering [low, high), ``shuffle`` a permutation along axis
    0, ``multinomial``'s frequencies by chi-squared, and
    ``image.random_flip_left_right`` flipping the whole batch or none of
    it, one coin a call. Returns name -> (dtype, shape, the larger
    distance in standard errors; for ``multinomial`` the chi-squared's
    above its mean, the flip count's from half)."""
    nd = pkg.nd
    r = nd.random
    on = {} if ctx is None else {"ctx": ctx}
    out = {}

    def draws(label, x, dtype, shape, mean, var, mu4, lo=None, hi=None):
        a = x.asnumpy()
        if str(a.dtype) != dtype or a.shape != shape:
            raise AssertionError(f"{label}: {a.dtype}{a.shape}, want "
                                 f"{dtype}{shape}")
        a = a.astype(np.float64).ravel()
        if (lo is not None and a.min() < lo) or (hi is not None
                                                 and a.max() > hi):
            raise AssertionError(f"{label}: draws outside [{lo}, {hi}]")
        out[label] = (dtype, shape, _moment_check(label, a, mean, var, mu4,
                                                  sigmas))

    def gamma_moments(k, theta):
        var = k * theta * theta
        return k * theta, var, (3 + 6 / k) * var * var

    def nb_moments(k, p):
        mean, var = k * (1 - p) / p, k * (1 - p) / p ** 2
        return mean, var, (3 + 6 / k + p * p / (k * (1 - p))) * var * var

    draws("uniform", r.uniform(-1.0, 3.0, shape=(n,), **on), "float32",
          (n,), 1.0, 16 / 12, 4 ** 4 / 80, -1.0, 3.0)
    draws("normal", r.normal(0.5, 2.0, shape=(n,), **on), "float32", (n,),
          0.5, 4.0, 3 * 16.0)
    draws("gamma", r.gamma(2.5, 0.5, shape=(n,), **on), "float32", (n,),
          *gamma_moments(2.5, 0.5), 0.0)
    draws("exponential", r.exponential(4.0, shape=(n,), **on), "float32",
          (n,), 0.25, 1 / 16, 9 / 256, 0.0)
    draws("poisson", r.poisson(3.5, shape=(n,), **on), "float32", (n,),
          3.5, 3.5, 3 * 3.5 ** 2 + 3.5, 0.0)
    draws("bernoulli", r.bernoulli(0.3, shape=(n,), **on), "float32", (n,),
          0.3, 0.21, 0.21 * (1 - 3 * 0.21), 0.0, 1.0)
    ints = r.randint(-3, 5, shape=(n,), **on)
    k2 = 8 ** 2                     # 8 values, each of probability 1/8
    var = (k2 - 1) / 12
    draws("randint", ints, "int32", (n,), 0.5, var,
          (3 - 6 * (k2 + 1) / (5 * (k2 - 1))) * var * var, -3, 4)
    if set(np.unique(ints.asnumpy()).tolist()) != set(range(-3, 5)):
        raise AssertionError("randint does not cover [-3, 5)")
    draws("negative_binomial",
          _nb_draws(nd, "random_negative_binomial",
                    dict(k=3, p=0.4, shape=(n,)), ctx),
          "float32", (n,), *nb_moments(3.0, 0.4), 0.0)
    kg = 1 / 0.5
    draws("generalized_negative_binomial",
          _nb_draws(nd, "random_generalized_negative_binomial",
                    dict(mu=2.0, alpha=0.5, shape=(n,)), ctx),
          "float32", (n,), *nb_moments(kg, kg / (kg + 2.0)), 0.0)
    # the per-parameter samplers: a row of draws per parameter element
    m = n // 2
    lows = nd.array(_f32([-1.0, 2.0]), ctx=ctx)
    highs = nd.array(_f32([1.0, 6.0]), ctx=ctx)
    both = nd.sample_uniform(lows, highs, shape=m)
    for i, (lo, hi) in enumerate(((-1.0, 1.0), (2.0, 6.0))):
        draws(f"sample_uniform[{i}]", both[i], "float32", (m,),
              (lo + hi) / 2, (hi - lo) ** 2 / 12, (hi - lo) ** 4 / 80, lo,
              hi)
    mus, sds = nd.array(_f32([0.0, -3.0]), ctx=ctx), \
        nd.array(_f32([1.0, 0.5]), ctx=ctx)
    both = nd.sample_normal(mus, sds, shape=(m,))
    for i, (mu, sd) in enumerate(((0.0, 1.0), (-3.0, 0.5))):
        draws(f"sample_normal[{i}]", both[i], "float32", (m,), mu, sd * sd,
              3 * sd ** 4)
    both = nd.sample_gamma(nd.array(_f32([0.5, 4.0]), ctx=ctx),
                           nd.array(_f32([2.0, 0.25]), ctx=ctx), shape=(m,))
    for i, (a, b) in enumerate(((0.5, 2.0), (4.0, 0.25))):
        draws(f"sample_gamma[{i}]", both[i], "float32", (m,),
              *gamma_moments(a, b), 0.0)
    both = nd.sample_exponential(nd.array(_f32([0.5, 5.0]), ctx=ctx),
                                 shape=(m,))
    for i, lam in enumerate((0.5, 5.0)):
        draws(f"sample_exponential[{i}]", both[i], "float32", (m,),
              1 / lam, 1 / lam ** 2, 9 / lam ** 4, 0.0)
    both = nd.sample_poisson(nd.array(_f32([0.7, 12.0]), ctx=ctx),
                             shape=(m,))
    for i, lam in enumerate((0.7, 12.0)):
        draws(f"sample_poisson[{i}]", both[i], "float32", (m,), lam, lam,
              3 * lam * lam + lam, 0.0)
    both = nd.sample_negative_binomial(nd.array(_f32([2.0, 5.0]), ctx=ctx),
                                       nd.array(_f32([0.3, 0.7]), ctx=ctx),
                                       shape=(m,))
    for i, (kk, p) in enumerate(((2.0, 0.3), (5.0, 0.7))):
        draws(f"sample_negative_binomial[{i}]", both[i], "float32", (m,),
              *nb_moments(kk, p), 0.0)
    # multinomial: rows need not sum to 1; chi-squared of the frequencies
    probs = _f32([[0.1, 0.2, 0.3, 0.4], [2.0, 0.0, 1.0, 1.0]])
    idx = r.multinomial(nd.array(probs, ctx=ctx), shape=m)
    got = idx.asnumpy()
    if got.dtype != np.int32 or got.shape != (2, m):
        raise AssertionError(f"multinomial: {got.dtype}{got.shape}")
    chi = 0.0
    for row, p in zip(got, probs):
        p = p / p.sum()
        seen = np.bincount(row, minlength=4)
        if seen[p == 0].any():
            raise AssertionError("multinomial drew a category of weight 0")
        want = p[p > 0] * m
        chi = max(chi, float(((seen[p > 0] - want) ** 2 / want).sum()))
    dof = 3
    if chi > dof + sigmas * math.sqrt(2 * dof):
        raise AssertionError(f"multinomial: chi-squared {chi} over {dof} "
                             "degrees of freedom")
    out["multinomial"] = ("int32", (2, m), (chi - dof) / math.sqrt(2 * dof))
    cat = r.categorical(nd.array(probs[0], ctx=ctx)).asnumpy()
    if cat.shape != () or not 0 <= int(cat) < 4:
        raise AssertionError(f"categorical: {cat}")
    rows = nd.array(np.arange(4096 * 3, dtype=np.float32).reshape(4096, 3),
                    ctx=ctx)
    perm = r.shuffle(rows).asnumpy()
    if not np.array_equal(np.sort(perm[:, 0]), rows.asnumpy()[:, 0]) \
            or not np.array_equal(perm[:, 1] - perm[:, 0], np.ones(4096)) \
            or np.array_equal(perm, rows.asnumpy()):
        raise AssertionError("shuffle is not a permutation of the rows")
    # one coin for the whole batch: every call flips all images or none
    imgs = nd.array(_NHWC, ctx=ctx)
    flips, calls = 0, 400
    for _ in range(calls):
        got = nd.image.random_flip_left_right(imgs).asnumpy()
        if np.array_equal(got, _NHWC[:, :, ::-1]):
            flips += 1
        elif not np.array_equal(got, _NHWC):
            raise AssertionError("random_flip_left_right flipped part of "
                                 "the batch")
    z = abs(flips - calls / 2) / math.sqrt(calls / 4)
    if z > sigmas:
        raise AssertionError(f"random_flip_left_right flipped {flips} of "
                             f"{calls} batches")
    out["random_flip_left_right"] = ("float32", _NHWC.shape, z)
    return out


def _nb_draws(nd, name, kwargs, ctx):
    """A sampler with no ``mx.nd.random`` wrapper, by name on ``ctx``."""
    if ctx is None:
        return nd.invoke_op(name, **kwargs)
    with ctx:
        return nd.invoke_op(name, **kwargs)


def state_replay_check(mx, ctx, n=4096):
    """``mx.random.get_state``/``set_state`` on ``ctx``: a restored state
    replays the same draws (a scalar sampler, a per-parameter one and a
    shuffle), and the draws after it differ."""
    nd = mx.nd

    def draw():
        return [nd.random.normal(shape=(n,), ctx=ctx).asnumpy(),
                nd.sample_gamma(nd.ones((2,), ctx=ctx),
                                nd.ones((2,), ctx=ctx), shape=n).asnumpy(),
                nd.random.shuffle(nd.arange(n, ctx=ctx)).asnumpy()]

    state = mx.random.get_state()
    first = draw()
    mx.random.set_state(state)
    again = draw()
    later = draw()
    if not all(np.array_equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("set_state did not replay the draws")
    if any(np.array_equal(a, b) for a, b in zip(first, later)):
        raise AssertionError("the draws after the replay repeat it")
    return len(first)


def captured_sampler_check(mx, ctx, n=4096):
    """A sampler inside a CUDA graph (``superstep.capture_steps``) on the
    card ``ctx``: each replay draws afresh from the generator the graph
    registered (``random.generators_of``), and ``rollback_keys`` after a
    replay makes the next replay draw the same values again."""
    from incubator_mxnet_tpu_torch import random as _random
    from incubator_mxnet_tpu_torch.parallel import superstep

    dev = ctx.torch_device()
    with superstep.dispatch(dev):
        graph = superstep.capture_steps(
            lambda i: mx.nd.random.uniform(shape=(n,), ctx=ctx).as_torch(),
            1, [], dev)
        first = graph.replay()[0].clone()
        reserved = _random.reserve_keys(dev)
        second = graph.replay()[0].clone()
        _random.rollback_keys(reserved)
        again = graph.replay()[0].clone()
    if torch.equal(first, second) or not torch.equal(second, again):
        raise AssertionError("a captured sampler does not draw afresh on "
                             "each replay, or rollback_keys does not hold")
    return float(second.mean())


def _check_cases(mx, ctx, cases, run, check):
    """Each case run on the CPU and on ``ctx``; family -> (cases, worst
    float difference)."""
    families = {}
    for case in cases:
        want = run(mx, case, mx.cpu())
        got = run(mx, case, ctx)
        worst = check(case, got, want)
        fam = families.setdefault(getattr(case, "family", "update"),
                                  dict(cases=0, worst=0.0))
        fam["cases"] += 1
        fam["worst"] = max(fam["worst"], worst)
    return families


def nd1x_cases_phase(mx, ctx, n_draws=2**20):
    """Every op of the slice on ``ctx`` against the port on the CPU (held
    to the JAX package by the CPU tests): ``MORE_CASES`` with gradients,
    ``UPDATE_CASES`` over three chained steps, the update wrappers'
    in-place rule on ``ctx``; the samplers by their statistics at
    ``n_draws`` draws; ``set_state`` replaying on ``ctx``; on the card a
    sampler captured in a CUDA graph (``captured_sampler_check``). One
    line an op family; raises on the first failure."""
    families = _check_cases(mx, ctx, MORE_CASES, run_nd_case, check_nd_case)
    families.update(_check_cases(mx, ctx, UPDATE_CASES, run_update_case,
                                 check_update_case))
    for name, fam in families.items():
        print(f"mx.nd 1.x ops on {ctx} vs the CPU, {name}: {fam['cases']} "
              f"cases equal (largest float difference {fam['worst']:.3e})",
              flush=True)
    wrappers = update_inplace_checks(mx, ctx)
    print(f"update wrappers on {ctx}: the in-place rule of {wrappers} "
          "wrappers (out= writes the weight's own tensor, the states always "
          "written, bit-equal to the returned values), reset_arrays, "
          "multi_* writing nothing", flush=True)
    stats = sampler_checks(mx, ctx, n_draws)
    worst = max(stats.items(), key=lambda kv: kv[1][2])
    print(f"samplers on {ctx}: {len(stats)} checks of {n_draws} draws (a "
          f"per-parameter row {n_draws // 2}), mean and variance within 5 "
          f"standard errors, support, dtype and shape; largest "
          f"{worst[1][2]:.2f} ({worst[0]}); multinomial by chi-squared, "
          "shuffle a permutation, "
          "random_flip_left_right all or none", flush=True)
    replayed = state_replay_check(mx, ctx)
    print(f"mx.random.set_state on {ctx}: {replayed} draws replayed bit for "
          "bit", flush=True)
    if ctx.device_type == "gpu":
        mean = captured_sampler_check(mx, ctx)
        print(f"a sampler captured in a CUDA graph on {ctx}: fresh draws "
              f"each replay (mean {mean:.4f}), rollback_keys replays the "
              "last one", flush=True)
    return dict(families=families, wrappers=wrappers, samplers=stats)


def nd_bert_forward(nd, params, tokens, segments, valid_length, num_layers,
                    num_heads):
    """``BERTModel``'s forward (``models.get_bert``, post-norm, the four
    outputs) written the GluonNLP 1.x way in ``mx.nd`` ops alone, for
    either package: time-major (T, B, C) layers whose query, key and value
    weights are interleaved per head into one ``FullyConnected`` of
    (H, 3, D, C) rows, scores by ``interleaved_matmul_selfatt_qk``, a key
    mask from ``valid_length`` (``arange_like``, ``broadcast_like``,
    repeated per head) under ``masked_softmax``, and
    ``interleaved_matmul_selfatt_valatt``. Returns (seq (B, T, C), pooled
    (B, C), mlm scores (B, T, V), nsp scores (B, 2))."""
    p = params
    b, t = tokens.shape
    vocab, units = p["word_embed.weight"].shape
    d = units // num_heads

    def ln(x, name):
        return nd.LayerNorm(x, p[name + ".gamma"], p[name + ".beta"],
                            axis=-1, eps=1e-5)

    def dense(x, name, width):
        return nd.FullyConnected(x, p[name + ".weight"], p[name + ".bias"],
                                 num_hidden=width, flatten=False)

    def interleaved(prefix, part, shape):
        return nd.reshape(nd.stack(*[
            nd.reshape(p[f"{prefix}{n}.{part}"], shape=shape)
            for n in ("query", "key", "value")], axis=1), shape=(-1,)
            + shape[2:])

    pos = nd.Embedding(nd.arange(t, ctx=tokens.context),
                       p["position_embed.weight"])
    x = nd.broadcast_add(nd.Embedding(tokens, p["word_embed.weight"]), pos) \
        + nd.Embedding(segments, p["token_type_embed.weight"])
    x = nd.transpose(ln(x, "embed_ln"), axes=(1, 0, 2))     # (T, B, C)
    keys = nd.broadcast_lesser(
        nd.reshape(nd.arange_like(tokens, axis=1), shape=(1, 1, t)),
        nd.reshape(nd.cast(valid_length, dtype="float32"), shape=(b, 1, 1)))
    mask = nd.repeat(nd.broadcast_like(keys, tokens, lhs_axes=(1,),
                                       rhs_axes=(1,)),
                     repeats=num_heads, axis=0)             # (B*H, T, T)
    hidden = p["encoder.layer0.ffn.ffn1.weight"].shape[0]
    for i in range(num_layers):
        pre = f"encoder.layer{i}."
        att = pre + "attention."
        qkv = nd.FullyConnected(
            x, interleaved(att, "weight", (num_heads, d, units)),
            interleaved(att, "bias", (num_heads, d)),
            num_hidden=3 * units, flatten=False)            # (T, B, 3C)
        scores = nd.interleaved_matmul_selfatt_qk(qkv, heads=num_heads)
        probs = nd.masked_softmax(scores, mask)
        ctx_v = nd.interleaved_matmul_selfatt_valatt(qkv, probs,
                                                     heads=num_heads)
        x = ln(x + dense(ctx_v, att + "proj", units), pre + "ln1")
        f = dense(nd.gelu(dense(x, pre + "ffn.ffn1", hidden)),
                  pre + "ffn.ffn2", units)
        x = ln(x + f, pre + "ln2")
    seq = nd.transpose(x, axes=(1, 0, 2))
    first = nd.reshape(nd.slice_axis(seq, axis=1, begin=0, end=1),
                       shape=(b, units))
    pooled = nd.tanh(nd.FullyConnected(first, p["pooler.weight"],
                                       p["pooler.bias"], num_hidden=units))
    mlm = dense(ln(nd.gelu(dense(seq, "mlm_decoder.0", units)),
                   "mlm_decoder.1"), "mlm_decoder.2", vocab)
    nsp = nd.FullyConnected(pooled, p["nsp_classifier.weight"],
                            p["nsp_classifier.bias"], num_hidden=2)
    return seq, pooled, mlm, nsp


def nd_bert_loss(nd, mlm, nsp, mlm_y, nsp_y):
    """``bert_pretrain_loss``'s objective in ``mx.nd`` ops: the mean MLM
    cross entropy plus the mean NSP cross entropy."""
    vocab = mlm.shape[-1]
    mlm_ce = nd.pick(nd.log_softmax(nd.reshape(mlm, shape=(-1, vocab))),
                     nd.reshape(mlm_y, shape=(-1,))).mean()
    nsp_ce = nd.pick(nd.log_softmax(nsp), nsp_y).mean()
    return -(mlm_ce + nsp_ce)


def nd_bert_step(mx, params, data, labels, num_layers, num_heads):
    """Forward and backward of ``nd_bert_forward`` with ``nd_bert_loss``
    under ``autograd.record()``: the gradients land in ``params``; returns
    the loss. ``data`` = (tokens, segments, valid_length), ``labels`` =
    (MLM labels (B, T), NSP labels (B,)), all NDArrays."""
    nd = mx.nd
    with mx.autograd.record():
        _, _, mlm, nsp = nd_bert_forward(nd, params, *data, num_layers,
                                         num_heads)
        loss = nd_bert_loss(nd, mlm, nsp, *labels)
    loss.backward()
    return float(loss.asscalar())


def nd_bert_update(nd, params, grads, states, lr=1e-4, wd=0.01):
    """The 1.x update: ``multi_sum_sq`` over the gradients gives the
    global norm, the clip factor ``min(1, 1/norm)`` is read once as a
    float (the reference's ``rescale_grad``), then ``adamw_update(w, g,
    mean, var, out=w)`` per parameter. Returns the norm."""
    names = list(params)
    sq = nd.multi_sum_sq(*[grads[n] for n in names], num_arrays=len(names))
    norm = math.sqrt(float(sq.sum().asscalar()))
    clip = min(1.0, 1.0 / norm) if norm > 0 else 1.0
    for n in names:
        mean, var = states[n]
        nd.adamw_update(params[n], grads[n], mean, var, lr=lr, wd=wd,
                        rescale_grad=clip, out=params[n])
    return norm


#: the learning check of the 1.x step: AdamW at BERT's published peak rate
ND1X_LR = 1e-4


def fp64_referee(net, loss_fn, data, labels, module, candidates):
    """Each gradient list of ``candidates`` (label -> gradients of
    ``net``'s trainable parameters, in ``collect_params`` order) against
    the same pass in fp64 through the plain attention (``swap_attention``
    of ``module``) on a copy of ``net``: label -> (worst relative L2
    error, its tensor), ``_worst_grad``'s measure."""
    import incubator_mxnet_tpu_torch as mx

    net64 = copy.deepcopy(net).cast("float64")
    named = [(n, p) for n, p in _param_tensors(net64).items()
             if p.requires_grad]
    with swap_attention(module), mx.autograd.record():
        loss = loss_fn(*net64(*data), *labels)
    ref = torch.autograd.grad(loss, [p for _, p in named])
    del net64, loss
    names = [n for n, _ in named]
    return {label: _worst_grad(f"{label} against fp64", names,
                               [g.double() for g in grads], ref, math.inf)
            for label, grads in candidates.items()}


def nd1x_phase(seed, card, net, ctx, sizes=BERT_SIZES[:2], steps=10, reps=5,
               n_draws=2**20):
    """The mx.nd 1.x phase on ``net`` (a fp32 ``BERTModel`` with its four
    heads, ``attention_impl="pallas"``, dropout 0) at B, T = ``sizes``
    with ``bert_batch`` and ``bert_lengths`` (mixed segments; the BERT
    phase's batch): (a) the
    gluon forward and backward through K4-K6 (counted: a launch of each a
    layer, f32), then ``nd_bert_step`` on the net's own parameters, its
    loss and every gradient against the gluon pass's (relative L2 <=
    GRAD_RTOL), both against the same pass in fp64 (``fp64_referee``: the
    1.x step within GRAD_RTOL, the flash pass's error printed),
    ``nd_bert_update`` (adamw with ``out=``) seen by the gluon forward
    (counted: a K4 a layer), ``steps`` 1.x steps lowering the loss by 5% on
    one batch (the 1.x steps and updates counted: no flash launch), then
    the 1.x step timed beside the gluon step with "pallas" and with "xla"
    (each with the same 1.x update) and profiled; (b)
    ``nd1x_cases_phase``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.models import MultiHeadAttention
    from incubator_mxnet_tpu_torch.models import transformer
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    t0_phase = time.perf_counter()
    b, t = sizes
    dev = ctx.torch_device()
    cells = [m for m in net.modules() if isinstance(m, MultiHeadAttention)]
    layers, heads = len(cells), cells[0]._heads
    d = cells[0]._units // heads
    vocab = net.word_embed.weight.shape[0]
    lens = bert_lengths(seed, b, t)
    # the BERT phase's batch, the one its gradient oracle holds K4-K6 on
    data, labels = bert_batch(np.random.RandomState(seed + 97), b, t, vocab,
                              dev, lens)
    nd_data = [NDArray(x) for x in data]
    nd_labels = [NDArray(y) for y in labels]
    named = [(n, p) for n, p in _param_tensors(net).items()
             if p.requires_grad]
    names = [n for n, _ in named]
    params = {n: NDArray(p) for n, p in named}
    loss_fn = bert_pretrain_loss(gluon.loss.SoftmaxCrossEntropyLoss())

    # (a) the gluon pass through K4-K6, its launches read on their own
    _reset_launches(fa)
    with mx.autograd.record():
        ref = loss_fn(*net(*data), *labels)
    ref_grads = torch.autograd.grad(ref, [p for _, p in named])
    ref_loss = float(ref.detach())
    del ref
    torch.cuda.synchronize()
    gluon_launches, gluon_routes = _read_launches(fa), _read_routes(fa)
    _check_flash_launches(
        "the gluon BERT pass beside the 1.x step (1 fp32 pass)",
        gluon_launches, gluon_routes, dict.fromkeys(COUNTERS, layers),
        training_routes(1, 0, layers, t, d))
    # the 1.x steps and updates: the dense masked softmax, no flash kernel
    # (their window holds them alone)
    _reset_launches(fa)
    loss0 = nd_bert_step(mx, params, nd_data, nd_labels, layers, heads)
    grads = [p.grad for _, p in named]
    worst = _worst_grad("mx.nd 1.x BERT step", names, grads, ref_grads,
                        math.inf)
    referee = fp64_referee(net, loss_fn, data, labels, transformer,
                           {"K4-K6": ref_grads, "1.x": grads})
    print(f"mx.nd 1.x BERT step oracle (fp32, B={b}, T={t}, valid_length "
          f"{lens.tolist()}, {len(names)} parameter tensors): loss "
          f"{loss0:.6f} (interleaved matmuls, masked_softmax) vs "
          f"{ref_loss:.6f} (gluon, K4-K6 with key lengths); worst gradient "
          f"relative L2 error {worst[0]:.3e} ({worst[1]}), tolerance "
          f"{GRAD_RTOL:g}", flush=True)
    print(f"fp64 referee (the same pass in fp64 through the plain "
          f"attention): worst relative L2 error of the gluon pass through "
          f"K4-K6 {referee['K4-K6'][0]:.3e} ({referee['K4-K6'][1]}), of the "
          f"1.x step {referee['1.x'][0]:.3e} ({referee['1.x'][1]}), "
          f"tolerance {GRAD_RTOL:g}", flush=True)
    if not abs(loss0 - ref_loss) <= BERT_EVAL_RTOL * abs(ref_loss):
        raise AssertionError("mx.nd 1.x BERT step: the loss differs from "
                             "the gluon pass's")
    if not worst[0] <= GRAD_RTOL or not referee["1.x"][0] <= GRAD_RTOL:
        raise AssertionError(f"mx.nd 1.x BERT step: worst gradient "
                             f"{worst} against the gluon pass, {referee} "
                             "against fp64")
    del ref_grads, grads
    states = {n: (mx.nd.zeros(p.shape, ctx=ctx), mx.nd.zeros(p.shape,
                                                             ctx=ctx))
              for n, p in named}

    def nd_grads():
        return {n: NDArray(p.grad) for n, p in named}

    # the update writes into the parameters' own tensors: the gluon
    # forward sees it
    ptrs = [p.data_ptr() for _, p in named]
    before = [p.detach().clone() for _, p in named]
    norm0 = nd_bert_update(mx.nd, params, nd_grads(), states, ND1X_LR)
    nd_launches = _read_launches(fa)
    moved = sum(not torch.equal(p, w) for (_, p), w in zip(named, before))
    _reset_launches(fa)
    with torch.no_grad():
        seen = float(loss_fn(*net(*data), *labels))
    seen_launches, seen_routes = _read_launches(fa), _read_routes(fa)
    want_seen = training_routes(0, 0, layers, t, d)
    want_seen["flash_fwd_" + fwd_route_expected(t, d, torch.float32)] = \
        layers
    _check_flash_launches("the gluon forward after the update",
                          seen_launches, seen_routes,
                          {"flash_fwd": layers, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}, want_seen)
    gluon_launches = {k: gluon_launches[k] + seen_launches[k]
                      for k in COUNTERS}
    gluon_routes = {k: gluon_routes[k] + seen_routes[k]
                    for k in ROUTE_COUNTERS}
    with mx.autograd.pause():
        _, _, mlm, nsp = nd_bert_forward(mx.nd, params, *nd_data, layers,
                                         heads)
        nd_seen = float(nd_bert_loss(mx.nd, mlm, nsp, *nd_labels)
                        .asscalar())
    del before, mlm, nsp
    print(f"mx.nd 1.x update (multi_sum_sq global norm {norm0:.4f}, "
          f"adamw_update(out=w) lr {ND1X_LR:g} wd 0.01 rescale_grad "
          f"{min(1.0, 1 / norm0):.4f}): {moved} of {len(names)} parameter "
          f"tensors written in place; the gluon forward's loss {seen:.6f} "
          f"(before {ref_loss:.6f}), the 1.x forward's {nd_seen:.6f}",
          flush=True)
    if [p.data_ptr() for _, p in named] != ptrs or moved != len(names):
        raise AssertionError("adamw_update(out=w) did not write into every "
                             "parameter's own tensor")
    if not abs(seen - nd_seen) <= BERT_EVAL_RTOL * abs(nd_seen) \
            or seen == ref_loss:
        raise AssertionError("the gluon forward does not see the weights "
                             "adamw_update wrote")
    _reset_launches(fa)
    losses = [loss0]
    for _ in range(steps - 1):
        losses.append(nd_bert_step(mx, params, nd_data, nd_labels, layers,
                                   heads))
        nd_bert_update(mx.nd, params, nd_grads(), states, ND1X_LR)
    nd_launches = {k: nd_launches[k] + v
                   for k, v in _read_launches(fa).items()}
    print(f"mx.nd 1.x BERT learning check ({steps} steps on one batch, "
          f"adamw_update lr {ND1X_LR:g} wd 0.01, global-norm clip): losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("mx.nd 1.x BERT step: the loss did not fall by "
                             f"5% over {steps} steps")
    _check_flash_launches(f"the mx.nd 1.x BERT steps ({steps} passes)",
                          nd_launches, {}, dict.fromkeys(COUNTERS, 0), {})

    def nd_train():
        nd_bert_step(mx, params, nd_data, nd_labels, layers, heads)
        nd_bert_update(mx.nd, params, nd_grads(), states, ND1X_LR)

    def gluon_train(impl):
        def step():
            set_attention_impl(net, impl)
            with mx.autograd.record():
                loss = loss_fn(*net(*data), *labels)
            mx.autograd.backward(loss)
            nd_bert_update(mx.nd, params, nd_grads(), states, ND1X_LR)
        return step

    gc.collect()
    times = _median_turns({"nd": nd_train, "pallas": gluon_train("pallas"),
                           "xla": gluon_train("xla")}, reps)
    set_attention_impl(net, "pallas")
    print(f"mx.nd 1.x BERT step (fp32, B={b}, T={t}, mixed lengths; {card}): "
          f"{times['nd']:.3f} ms a step beside the gluon step's "
          f"{times['pallas']:.3f} (pallas, K4-K6) and {times['xla']:.3f} "
          f"(xla, the dense chain) (host clock, median of {reps} alternating "
          "turns, each with the 1.x update)", flush=True)
    profile = _profile_step(lambda *_: nd_train(), None, None, card,
                            times["nd"], top=12,
                            what="fp32 mx.nd 1.x BERT step")
    device_ms = sum(r[0] for r in profile)
    pallas_device_ms = _kernel_ms(gluon_train("pallas"))
    xla_device_ms = _kernel_ms(gluon_train("xla"))
    set_attention_impl(net, "pallas")
    print(f"device time a step: mx.nd 1.x {device_ms:.3f} ms, gluon pallas "
          f"{pallas_device_ms:.3f} ms, gluon xla {xla_device_ms:.3f} ms "
          "(torch.profiler)", flush=True)
    del states, params
    gc.collect()
    cases = nd1x_cases_phase(mx, ctx, n_draws)
    seconds = time.perf_counter() - t0_phase
    print(f"mx.nd 1.x phase: {seconds:.1f} s", flush=True)
    return dict(n_params=len(names), grad_worst_rel=worst[0], loss=loss0,
                ref_loss=ref_loss, learning_losses=losses,
                fp64_worst_rel={k: v[0] for k, v in referee.items()},
                flash_launches=gluon_launches, flash_routes=gluon_routes,
                nd_launches=nd_launches, step_ms=times["nd"],
                pallas_step_ms=times["pallas"], xla_step_ms=times["xla"],
                device_ms=device_ms, pallas_device_ms=pallas_device_ms,
                xla_device_ms=xla_device_ms, seconds=seconds, **cases)


# ---------------------------------------------------------------------------
# mx.np phase: ops/numpy_ops.py, ops/fft_ops.py, ops/linalg.py and the
# mx.np/mx.npx front, and a GPT step written in mx.np names
# ---------------------------------------------------------------------------
#: the factorizations (QR, SVD, eigh, least squares, the pseudo-inverse):
#: LAPACK's and cuSOLVER's iterations round in another order than jnp's
LINALG_TOL = dict(rtol=1e-4, atol=1e-5)
def fft_tol(n):
    """An FFT of ``n`` points: fp32 rounding grows with log2(n)."""
    g = max(1.0, math.log2(n))
    return dict(rtol=1e-5 * g, atol=1e-6 * g)


def _flip_cols(m):
    """Each column of ``m`` (..., r, c) signed so that its entry of the
    largest magnitude is positive."""
    i = np.abs(m).argmax(-2)[..., None, :]
    return m * np.where(np.take_along_axis(m, i, -2) < 0, -1, 1)


def _flip_rows(m):
    return np.swapaxes(_flip_cols(np.swapaxes(m, -1, -2)), -1, -2)


def _diag_signs(m):
    d = np.diagonal(m, axis1=-2, axis2=-1)
    return np.where(d < 0, -1, 1).astype(m.dtype)


def post_eigh(outs):
    """(w, v): w, v's columns sign-fixed, and v diag(w) vᵀ."""
    w, v = outs
    return [w, _flip_cols(v), (v * w[..., None, :]) @ np.swapaxes(v, -1, -2)]


def post_syevd(outs):
    """(U, L) with eigenvectors as U's rows: U sign-fixed, L, Uᵀ diag(L)
    U."""
    u, w = outs
    return [_flip_rows(u), w, (np.swapaxes(u, -1, -2) * w[..., None, :]) @ u]


def post_svd(outs):
    """(u, s, vh) reduced: s, u's columns and vh's rows sign-fixed, and u
    diag(s) vh."""
    u, s, vh = outs
    return [s, _flip_cols(u), _flip_rows(vh), (u * s[..., None, :]) @ vh]


def post_qr(outs):
    """(q, r): r with a non-negative diagonal and q to match, and q r."""
    q, r = outs
    d = _diag_signs(r)
    return [q * d[..., None, :], r * d[..., :, None], q @ r]


def post_qr_r(outs):
    return [outs[0] * _diag_signs(outs[0])[..., :, None]]


def post_gelqf(outs):
    """(Q, L) with A = L Q: L with a non-negative diagonal, Q to match,
    and L Q."""
    q, low = outs
    d = _diag_signs(low)
    return [q * d[..., :, None], low * d[..., None, :], low @ q]


def _spd(seed, *batch, n=3):
    a = _nd_rand(seed, *batch, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _sym(seed, n=4):
    a = _nd_rand(seed, n, n)
    return ((a + a.T) / 2 + np.diag(np.arange(n) * 1.5)).astype(np.float32)


def _cplx(seed, *shape):
    return (_nd_rand(seed, *shape) + 1j * _nd_rand(seed + 1, *shape)).astype(
        np.complex64)


_V = _nd_rand(140, 8)
_M = _nd_rand(141, 3, 4)
_M2 = _nd_rand(142, 3, 4)
_EVEN = _nd_rand(143, 4, 6)
_NANS = _M.copy()
_NANS[0, 1] = _NANS[1, 3] = np.nan
_NANS[2, :] = np.nan                      # an all-NaN row
_INTS = np.array([[3, 0, 5, 12], [1, 7, 2, 0]], np.int32)
_SHIFTS = np.array([[1, 2, 0, 3], [4, 1, 2, 5]], np.int32)
_BYTES = np.random.RandomState(144).randint(0, 3, (2, 11)).astype(np.uint8)
_PART = _f32([5, 1, 4, 1, 3, 2, 9])
_SQ = (_nd_rand(145, 3, 3) + 3 * np.eye(3)).astype(np.float32)
_SQB = (_nd_rand(146, 2, 3, 3) + 3 * np.eye(3)).astype(np.float32)
_TALL = _nd_rand(147, 5, 3)
_WIDE = _nd_rand(148, 2, 3, 5)
_DEFICIENT = np.concatenate([_TALL[:, :2], _TALL[:, :1] + _TALL[:, 1:2]],
                            1).astype(np.float32)
_SPDB = _spd(150, 2)
_LOW = np.linalg.cholesky(_SPDB).astype(np.float32)
_SYM4 = _sym(151)
_C8 = _cplx(152, 8)
_C25 = _cplx(154, 2, 5)
_GRID = _nd_rand(156, 2, 3, 4)
_SEQ8 = np.cumsum(_nd_rand(157, 10, lo=-2.5, hi=2.5)).astype(np.float32)
_SORTED = np.sort(_nd_rand(158, 6, lo=-2.0, hi=2.0))
_TENSOR_A = (np.eye(6) + 0.1 * _nd_rand(159, 6, 6)).astype(np.float32)
_DUPS = _f32([[3, 1, 2, 3], [1, 5, 2, 2]])
_EDGES = _f32(np.arange(11))                # values on every bin edge


def _np(name, arrays, kwargs=None, grad=(), tol=None, family="numpy",
        **kw):
    return NdCase(family, kw.pop("id", name.replace("np:", "np.")), name,
                  arrays, kwargs or {}, grad, tol, **kw)


def _unique_ids(cases):
    """``cases`` with the second and later of a repeated id numbered."""
    seen = collections.Counter()
    out = []
    for c in cases:
        seen[c.id] += 1
        out.append(c if seen[c.id] == 1 else c._replace(
            id=f"{c.id}_{seen[c.id]}"))
    return out


NP_CASES = _unique_ids([
    # elementwise
    _np("exp2", [_M], grad=(0,)), _np("sinc", [_M], grad=(0,)),
    _np("i0", [_M], grad=(0,)), _np("fabs", [_M], grad=(0,)),
    _np("signbit", [_f32([-0.0, 0.0, -1.5, 2.0])], exact=True),
    _np("relu6", [_M * 8], grad=(0,)), _np("hard_swish", [_M * 4],
                                           grad=(0,)),
    _np("hardswish", [_M * 4], id="hardswish_alias"),
    _np("logaddexp", [_M, _M2], grad=(0, 1)),
    _np("logaddexp2", [_M, _M2], grad=(0, 1)),
    _np("copysign", [_M, _M2], grad=(0,)),
    _np("heaviside", [_f32([-1.5, 0.0, 2.0, 0.0]), _f32([0.5, 0.5, 3, 1])]),
    _np("ldexp", [_M, _SHIFTS[:, :4].repeat(2, 0)[:3].astype(np.float32)],
        grad=(0,)),
    _np("float_power", [_nd_rand(160, 3, 4, lo=0.5, hi=2.0), _M2],
        grad=(0, 1)),
    _np("fmod", [_M * 5, _M2 + 1.5], grad=(0,)),
    _np("nextafter", [_M, _M2], exact=True),
    _np("floor_divide", [_M * 5, _M2 + 1.5]),
    _np("op:broadcast_floor_divide", [_INTS, _SHIFTS + 1],
        id="floor_divide_int"),
    _np("invert", [_INTS]), _np("bitwise_not", [_f32([1.7, -2.2, 0.0])],
                                id="bitwise_not_of_floats"),
    _np("bitwise_and", [_INTS, _SHIFTS]), _np("bitwise_or", [_INTS, _SHIFTS]),
    _np("bitwise_xor", [_INTS, _SHIFTS]),
    _np("left_shift", [_INTS, _SHIFTS]), _np("right_shift",
                                             [_INTS * 40, _SHIFTS]),
    _np("fmax", [_NANS, _M2], grad=(0, 1)), _np("fmin", [_NANS, _M2]),
    _np("isclose", [_M, _M + _f32([0, 1e-6, 1e-3, 0])]),
    _np("allclose", [_M, _M + 1e-7]),
    _np("array_equal", [_INTS, _INTS]),
    # reductions and statistics
    _np("std", [_M], dict(axis=1, ddof=1), (0,)),
    _np("var", [_M], dict(axis=0, keepdims=True), (0,)),
    _np("average", [_M], dict(axis=1, weights=_f32([1, 2, 3, 4])), (0,)),
    _np("median", [_EVEN], dict(axis=1), (0,), id="median_even_count"),
    _np("median", [_M], {}, (0,), id="median_all"),
    _np("quantile", [_EVEN], dict(q=_f32([0.1, 0.5, 0.9]), axis=0),
        (0,)),
    _np("percentile", [_EVEN], dict(q=30.0, axis=(0, 1), keepdims=True),
        (0,)),
    _np("ptp", [_M], dict(axis=1), (0,)),
    _np("nanmax", [_NANS], dict(axis=1), (0,)),
    _np("nanmin", [_NANS], dict(axis=0)),
    _np("nanmean", [_NANS], dict(axis=1), (0,)),
    _np("nanstd", [_NANS], dict(axis=1, ddof=1)),
    _np("nanvar", [_NANS], dict(axis=0), (0,)),
    _np("nanargmax", [_NANS], dict(axis=1)),
    _np("nanargmin", [_NANS], dict(axis=1)),
    _np("nancumsum", [_NANS], dict(axis=1), (0,)),
    _np("nancumprod", [_NANS], dict(axis=0)),
    _np("cumprod", [_M], dict(axis=1), (0,)),
    _np("count_nonzero", [_INTS], dict(axis=0)),
    _np("nanmedian", [_NANS], dict(axis=1)),
    _np("nanquantile", [_NANS], dict(q=0.25, axis=1)),
    _np("nanpercentile", [_NANS], dict(q=75.0)),
    _np("cov", [_M], {}, (0,)), _np("cov", [_M], dict(rowvar=False, ddof=0),
                                    id="cov_columns"),
    _np("corrcoef", [_M], {}, (0,)),
    # shape and joining
    _np("roll", [_M], dict(shift=2, axis=1), (0,)),
    _np("roll", [_M], dict(shift=-3), id="roll_flat"),
    _np("rot90", [_GRID], dict(k=3, axes=(1, 2)), (0,)),
    _np("tril", [_M], dict(k=1), (0,)), _np("triu", [_M], dict(k=-1)),
    _np("trace_op", [_GRID], dict(offset=1, axis1=1, axis2=2), (0,)),
    _np("trace", [_INTS], id="trace_int"),
    _np("flipud", [_M], grad=(0,)), _np("fliplr", [_M]),
    _np("moveaxis", [_GRID], dict(source=0, destination=2), (0,)),
    _np("rollaxis", [_GRID], dict(axis=2, start=0)),
    _np("diff", [_GRID], dict(n=2, axis=2), (0,)),
    _np("ediff1d", [_M], grad=(0,)),
    _np("hstack", [_M, _M2], grad=(0, 1)), _np("vstack", [_V, _V]),
    _np("dstack", [_M, _M2]), _np("column_stack", [_V, _V]),
    _np("meshgrid", [_V[:3], _V[:2]], grad=(0, 1)),
    _np("meshgrid", [_V[:3], _V[:2]], dict(indexing="ij"),
        id="meshgrid_ij"),
    _np("broadcast_arrays", [_M, _V[:4]], grad=(0, 1)),
    _np("atleast_2d", [_V]), _np("atleast_3d", [_M]),
    _np("resize_op", [_M], dict(new_shape=(5, 3)), (0,)),
    _np("np_resize", [_V], dict(new_shape=(3, 5)), id="np_resize_tiles"),
    # products
    _np("kron", [_M[:2, :2], _M2[:2]], grad=(0, 1)),
    _np("outer", [_V[:3], _M], grad=(0, 1)),
    _np("inner", [_M, _M2], grad=(0, 1)), _np("vdot", [_M, _M2], grad=(0,)),
    _np("vdot", [_C25, _C25 * 2], id="vdot_complex"),
    _np("tensordot", [_GRID, _nd_rand(161, 3, 4, 2)],
        dict(axes=((1, 2), (0, 1))), (0, 1)),
    _np("einsum", [_GRID, _M], dict(subscripts="bij,ij->bi"), (0, 1)),
    _np("cross", [_nd_rand(162, 4, 3), _nd_rand(163, 4, 3)], grad=(0, 1)),
    _np("cross", [_nd_rand(164, 3, 2), _nd_rand(165, 3, 2)],
        id="cross_2d"),
    _np("vander", [_V[:4]], dict(n=5), (0,)),
    _np("vander", [_V[:4]], dict(increasing=True), id="vander_increasing"),
    _np("polyval", [_f32([2, -1, 0.5]), _M], grad=(0, 1)),
    _np("trapz", [_M], grad=(0,)),
    _np("trapz", [_M, _SORTED[:4]], grad=(0,), id="trapz_x"),
    *[_np("convolve", [_V, _V[:3] * 2], dict(mode=m), (0, 1),
          id=f"convolve_{m}") for m in ("full", "same", "valid")],
    _np("correlate", [_V, _V[:3] * 2], grad=(0, 1)),
    _np("correlate", [_V[:3], _V], dict(mode="full"), (0, 1),
        id="correlate_swapped"),
    _np("correlate", [_C8, _C8[:3]], dict(mode="same"),
        id="correlate_complex_conjugates"),
    # searching and sorting
    _np("searchsorted", [_SORTED, _M]),
    _np("searchsorted", [_f32([1, 2, 2, 3]), _f32([2, 2.5])],
        dict(side="right"), id="searchsorted_right"),
    _np("digitize", [_M, _SORTED]),
    _np("digitize", [_M, _SORTED[::-1].copy()], dict(right=True),
        id="digitize_falling"),
    _np("lexsort", [_DUPS]),
    _np("partition_op", [_PART], dict(kth=2), exact=True,
        id="partition_fixed_order"),
    _np("argpartition", [_PART], dict(kth=2), id="argpartition_fixed"),
    _np("np_partition", [_EVEN], dict(kth=3, axis=0), exact=True),
    _np("argpartition", [_EVEN], dict(kth=1, axis=1), id="argpartition_2d"),
    # dynamic shapes
    _np("unique", [_DUPS], dict(return_index=True, return_inverse=True,
                                return_counts=True)),
    _np("unique", [_INTS], id="unique_plain"),
    _np("nonzero", [_INTS]), _np("flatnonzero", [_INTS]),
    _np("argwhere", [_INTS]),
    _np("bincount", [_f32([0, 1, 1, 3, 6])], dict(minlength=8)),
    _np("bincount", [_f32([0, 1, 1, 3])], dict(weights=_f32([.5, 1, 2,
                                                             3])),
        id="bincount_weights"),
    _np("histogram", [_M], dict(bins=4)),
    _np("histogram", [_EDGES], dict(bins=5, range=(0.0, 10.0)),
        id="histogram_on_the_edges"),
    _np("histogram", [_EDGES], dict(bins=_f32([0, 2.5, 3, 10])),
        id="histogram_edges_given"),
    _np("histogram", [_INTS], dict(bins=3), id="histogram_ints"),
    _np("setdiff1d", [_DUPS, _f32([2, 7])]),
    _np("intersect1d", [_DUPS, _f32([2, 5, 7])]),
    _np("union1d", [_DUPS, _f32([2, 7])]),
    _np("isin", [_DUPS, _f32([2, 5])]),
    _np("compress_op", [_f32([1, 0, 1]), _M], dict(axis=0), id="compress"),
    _np("np_compress", [_f32([0, 1, 1, 0, 1]), _M], id="compress_flat"),
    _np("extract", [(_M > 0).astype(np.float32), _M]),
    _np("interp", [_f32([-3, -1.5, 0.1, 0.7, 2.2, 9]), _SORTED,
                   _SORTED ** 2], grad=(0, 2)),
    # the rest
    _np("clip_by_global_norm", [_M, _M2 * 3, _V], dict(max_norm=1.5),
        (0, 1, 2)),
    _np("take_along_axis", [_M, _f32([[0, 3], [1, 1], [2, 0]])],
        dict(axis=1), (0,)),
    _np("put_along_axis", [_M, _f32([[0, 3], [1, -1], [2, 0]]),
                           _f32([[9, 8], [7, 6], [5, 4]])], dict(axis=1)),
    _np("select", [np.stack([_M > 0.5, _M < -0.5]).astype(np.float32),
                   np.stack([_M * 10, _M2])], dict(default=-1.0), (1,)),
    _np("unwrap", [_SEQ8], grad=(0,)),
    _np("gradient_op", [_GRID], {}, (0,)),
    _np("np_gradient", [_GRID], dict(axis=1), (0,), id="gradient_axis"),
    _np("packbits", [_BYTES], dict(axis=1)),
    _np("packbits", [_BYTES], id="packbits_flat"),
    _np("unpackbits", [_BYTES * 60], dict(axis=0, count=3)),
    _np("unpackbits", [_BYTES * 60], id="unpackbits_flat"),
    # mx.np's numpy signatures
    *[_np(f"np:{n}", arrays, kwargs, grad, family="np")
      for n, arrays, kwargs, grad in [
          ("reshape", [_GRID, (4, 6)], {}, ()),
          ("transpose", [_GRID], dict(axes=(2, 0, 1)), (0,)),
          ("expand_dims", [_M, 1], {}, ()),
          ("squeeze", [_M[:1]], {}, ()),
          ("clip", [_M, -0.3, 0.4], {}, (0,)),
          ("roll", [_M, 1], dict(axis=0), ()),
          ("rot90", [_M], {}, ()),
          ("moveaxis", [_GRID, 0, -1], {}, ()),
          ("rollaxis", [_GRID, 2], {}, ()),
          ("repeat", [_M, 2], dict(axis=0), (0,)),
          ("tile", [_M, (2, 1)], {}, ()),
          ("flip", [_M], dict(axis=1), ()),
          ("split", [_EVEN, 3], dict(axis=1), (0,)),
          ("split", [_EVEN, [1, 4]], dict(axis=1), ()),
          ("take", [_M, _f32([0, 5, 11])], {}, (0,)),
          ("quantile", [_EVEN, 0.3], dict(axis=1), (0,)),
          ("percentile", [_EVEN, 90.0], {}, ()),
          ("tensordot", [_M, _M2.T.copy()], dict(axes=1), ()),
          ("partition", [_PART, 3], {}, ()),
          ("argpartition", [_PART, 4], {}, ()),
          ("resize", [_M, (2, 2)], {}, ()),
          ("cumsum", [_M], dict(axis=0), (0,)),
          ("cumprod", [_M], {}, ()),
          ("diff", [_M], dict(n=1, axis=0), ()),
          ("tril", [_M], {}, ()), ("triu", [_M], dict(k=1), ()),
          ("trace", [_M], {}, (0,)),
          ("searchsorted", [_SORTED, _V], {}, ()),
          ("take_along_axis", [_M, _f32([[1], [0], [3]])],
           dict(axis=1), (0,)),
          ("put_along_axis", [_M, _f32([[1], [0], [3]]), _f32([[1], [2],
                                                              [3]])],
           dict(axis=1), ()),
          ("einsum", ["ij,kj->ik", _M, _M2], {}, (1, 2)),
          ("concatenate", [_M, _M2], dict(axis=0), (0, 1)),
          ("append", [_M, _M2], {}, ()),
          ("append", [_M, _M2], dict(axis=1), ()),
          ("absolute", [_M], {}, ()), ("true_divide", [_M, _M2], {}, ()),
          ("amax", [_M], {}, ()), ("deg2rad", [_M], {}, ()),
          ("remainder", [_M, _M2 + 1.5], {}, ()),
          ("full_like", [_M, 2.5], {}, ()),
          ("empty_like", [_INTS], {}, ()),
          ("asarray", [_M], {}, ()),
      ]],
    *[_np(f"np:{n}", [], kwargs, family="np_creators")
      for n, kwargs in [
          ("linspace", dict(start=-1.0, stop=2.0, num=7)),
          ("linspace", dict(start=0, stop=1, num=5, endpoint=False)),
          ("logspace", dict(start=0.0, stop=2.0, num=5)),
          ("geomspace", dict(start=1.0, stop=1000.0, num=4)),
          ("identity", dict(n=3)),
      ]],
    # the FFTs, through mx.np.fft
    _np("np:fft.fft", [_V], {}, (0,), fft_tol(8), family="fft"),
    _np("np:fft.fft", [_V], dict(n=6, norm="ortho"), (0,), fft_tol(6),
        family="fft", id="fft_cut"),
    _np("np:fft.fft", [_M], dict(n=12, axis=0, norm="forward"), (0,),
        fft_tol(12), family="fft", id="fft_padded_axis0"),
    _np("np:fft.fft", [_C8], {}, (), fft_tol(8), family="fft",
        id="fft_complex"),
    _np("np:fft.ifft", [_C25], dict(norm="forward"), (), fft_tol(5),
        family="fft"),
    _np("np:fft.ifft", [_M], {}, (0,), fft_tol(4), family="fft",
        id="ifft_real"),
    _np("np:fft.rfft", [_V], {}, (0,), fft_tol(8), family="fft"),
    _np("np:fft.rfft", [_M], dict(n=10, axis=0), (0,), fft_tol(10),
        family="fft", id="rfft_padded"),
    _np("np:fft.irfft", [_C25], {}, (), fft_tol(8), family="fft"),
    _np("np:fft.irfft", [_C25], dict(n=9, norm="ortho"), (), fft_tol(9),
        family="fft", id="irfft_n"),
    _np("np:fft.fft2", [_M], {}, (0,), fft_tol(12), family="fft"),
    _np("np:fft.fft2", [_GRID], dict(s=(2, 6), axes=(0, 2)), (0,),
        fft_tol(12), family="fft", id="fft2_s_axes"),
    _np("np:fft.ifft2", [_C25], {}, (), fft_tol(10), family="fft"),
    _np("np:fft.fftn", [_GRID], {}, (0,), fft_tol(24), family="fft"),
    _np("np:fft.fftn", [_GRID], dict(s=(4, 2), axes=(2, 0)), (0,),
        fft_tol(8), family="fft", id="fftn_s_axes"),
    _np("np:fft.ifftn", [_C25], dict(norm="ortho"), (), fft_tol(10),
        family="fft"),
    _np("np:fft.fftshift", [_GRID], {}, (0,), family="fft"),
    _np("np:fft.ifftshift", [_GRID], dict(axes=(1,)), (0,), family="fft"),
    *[_np(n, [_C25], family="complex", id=f"{n}_complex")
      for n in ("real", "imag", "conj", "angle", "op:absolute_complex")],
    _np("op:complex_abs", [_C8], family="complex", id="complex_abs_alias"),
    *[_np(n, [_M], {}, (0,) if n != "imag" else (), family="complex",
          id=f"{n}_of_reals") for n in ("real", "imag", "conj", "angle",
                                        "op:absolute_complex")],
    # np.linalg (ops/fft_ops.py), through mx.np.linalg
    *[_np("np:linalg.norm", [x], kw, (0,), LINALG_TOL, family="np_linalg",
          id=f"norm_{i}")
      for i, (x, kw) in enumerate([
          (_GRID, {}), (_M, dict(ord="fro")), (_M, dict(ord=2)),
          (_M, dict(ord="nuc")), (_M, dict(ord=1)),
          (_M, dict(ord=-np.inf, axis=1)), (_V, dict(ord=3)),
          (_GRID, dict(axis=(1, 2), keepdims=True)),
          (_GRID, dict(keepdims=True))])],
    _np("np:linalg.solve", [_SQ, _V[:3]], {}, (0, 1), LINALG_TOL,
        family="np_linalg"),
    _np("np:linalg.solve", [_SQB, _nd_rand(166, 2, 3, 2)], {}, (0, 1),
        LINALG_TOL, family="np_linalg", id="solve_batched"),
    # torch would read this b as a batch of vectors, numpy 2 as a matrix
    _np("np:linalg.solve", [_SQB.repeat(2, 0)[:3], _nd_rand(167, 3, 3)], {},
        (0, 1), LINALG_TOL, family="np_linalg", id="solve_b_as_matrix"),
    _np("np:linalg.lstsq", [_TALL, _V[:5]], {}, (), LINALG_TOL,
        family="np_linalg"),
    _np("np:linalg.lstsq", [_DEFICIENT, _M.T[:, :2].copy()[:3]
                            .repeat(2, 0)[:5]], {}, (), LINALG_TOL,
        family="np_linalg", id="lstsq_rank_deficient"),
    _np("np:linalg.qr", [_TALL], {}, (), LINALG_TOL, family="np_linalg",
        post=post_qr),
    _np("np:linalg.qr", [_SQB], dict(mode="complete"), (0,), LINALG_TOL,
        family="np_linalg", post=post_qr, sq=(0, 1), id="qr_complete"),
    _np("np:linalg.qr", [_TALL], dict(mode="r"), (), LINALG_TOL,
        family="np_linalg", post=post_qr_r, id="qr_r"),
    _np("np:linalg.svd", [_TALL], dict(full_matrices=False), (0,),
        LINALG_TOL, family="np_linalg", post=post_svd, sq=(0, 2)),
    _np("np:linalg.svd", [_WIDE], dict(compute_uv=False), (0,), LINALG_TOL,
        family="np_linalg", id="svd_values"),
    _np("np:linalg.eigh", [_SYM4], {}, (0,), LINALG_TOL,
        family="np_linalg", post=post_eigh, sq=(1,)),
    _np("np:linalg.eigh", [_M[:, :3] + np.eye(3, dtype=np.float32) * 2],
        dict(UPLO="U"), (), LINALG_TOL, family="np_linalg", post=post_eigh,
        id="eigh_upper"),
    _np("np:linalg.eigvalsh", [_SYM4], {}, (0,), LINALG_TOL,
        family="np_linalg"),
    _np("np:linalg.cholesky", [_SPDB], {}, (0,), LINALG_TOL,
        family="np_linalg"),
    _np("np:linalg.inv", [_SQB], {}, (0,), LINALG_TOL, family="np_linalg"),
    _np("np:linalg.det", [_SQB], {}, (0,), LINALG_TOL, family="np_linalg"),
    _np("np:linalg.slogdet", [_SQ * _f32([[-1], [1], [1]])], {}, (0,),
        LINALG_TOL, family="np_linalg"),
    _np("np:linalg.pinv", [_TALL], {}, (0,), LINALG_TOL, family="np_linalg"),
    _np("np:linalg.pinv", [_DEFICIENT], {}, (), LINALG_TOL,
        family="np_linalg", id="pinv_rank_deficient"),
    _np("np:linalg.matrix_rank", [_TALL], family="np_linalg"),
    _np("np:linalg.matrix_rank", [_DEFICIENT], family="np_linalg",
        id="matrix_rank_deficient"),
    _np("np:linalg.matrix_rank", [_TALL], dict(tol=0.5), family="np_linalg",
        id="matrix_rank_tol"),
    _np("np:linalg.matrix_power", [_SQ, 3], {}, (0,), LINALG_TOL,
        family="np_linalg"),
    _np("np:linalg.matrix_power", [_SQ, -2], {}, (), LINALG_TOL,
        family="np_linalg", id="matrix_power_inverse"),
    _np("np:linalg.matrix_power", [_SQ, 0], family="np_linalg",
        id="matrix_power_0"),
    _np("np:linalg.multi_dot", [_V[:3], _M, _M2.T.copy(), _V[:3]], {},
        (0, 1, 2, 3), LINALG_TOL, family="np_linalg"),
    *[_np("np:linalg.cond", [_SQB], dict(p=p) if p else {}, (), LINALG_TOL,
          family="np_linalg", id=f"cond_{p}")
      for p in (None, "fro", 1, -2)],
    _np("np:linalg.tensorsolve", [_TENSOR_A.reshape(2, 3, 6),
                                  _nd_rand(168, 2, 3)], {}, (0, 1),
        LINALG_TOL, family="np_linalg"),
    _np("np:linalg.tensorinv", [_TENSOR_A.reshape(6, 2, 3)], dict(ind=1),
        (0,), LINALG_TOL, family="np_linalg"),
    # la_op (ops/linalg.py), through mx.nd.linalg
    _np("linalg.gemm", [_WIDE[:, :, :3], _M2[None].repeat(2, 0)[:, :3],
                        _nd_rand(169, 2, 3, 4)],
        dict(alpha=0.5, beta=2.0), (0, 1, 2), family="la_op"),
    _np("linalg.gemm", [_WIDE, _WIDE, _nd_rand(170, 2, 5, 5)],
        dict(transpose_a=True), (0, 1), family="la_op", id="gemm_ta"),
    _np("linalg.gemm2", [_WIDE, _WIDE], dict(transpose_b=True, alpha=2.0),
        (0, 1), family="la_op"),
    _np("linalg.syrk", [_WIDE], dict(alpha=1.5), (0,), family="la_op"),
    _np("linalg.syrk", [_WIDE], dict(transpose=True), (0,), family="la_op",
        id="syrk_t"),
    _np("linalg.potrf", [_SPDB], {}, (0,), LINALG_TOL, family="la_op"),
    _np("linalg.potri", [_LOW], {}, (0,), LINALG_TOL, family="la_op"),
    *[_np("linalg.trmm", [_SQB, _nd_rand(171, 2, 3, 3)], kw, (0, 1),
          family="la_op", id=f"trmm_{i}")
      for i, kw in enumerate([{}, dict(transpose=True, alpha=2.0),
                              dict(rightside=True, lower=False)])],
    *[_np("linalg.trsm", [_SQB, _nd_rand(172, 2, 3, 3)], kw, (0, 1),
          LINALG_TOL, family="la_op", id=f"trsm_{i}")
      for i, kw in enumerate([{}, dict(transpose=True, alpha=-0.5),
                              dict(rightside=True, lower=False),
                              dict(rightside=True, transpose=True)])],
    _np("linalg.sumlogdiag", [_LOW], {}, (0,), family="la_op"),
    _np("linalg.gelqf", [_WIDE], {}, (), LINALG_TOL, family="la_op",
        post=post_gelqf),
    _np("linalg.syevd", [_SYM4], {}, (), LINALG_TOL, family="la_op",
        post=post_syevd),
    _np("linalg.inverse", [_SQB], {}, (0,), LINALG_TOL, family="la_op"),
    _np("linalg.det", [_SQB], {}, (0,), LINALG_TOL, family="la_op"),
    _np("linalg.slogdet", [_SQB], {}, (0,), LINALG_TOL, family="la_op"),
    _np("linalg.extractdiag", [_GRID[:, :, :3]], dict(offset=1), (0,),
        family="la_op"),
    _np("linalg.makediag", [_M], dict(offset=-1), (0,), family="la_op"),
    *[_np("linalg.extracttrian", [_SQB], kw, (0,), family="la_op",
          id=f"extracttrian_{i}")
      for i, kw in enumerate([{}, dict(offset=-1),
                              dict(offset=1, lower=False)])],
    *[_np("linalg.maketrian", [_nd_rand(173, 2, n)], kw, (0,),
          family="la_op", id=f"maketrian_{i}")
      for i, (n, kw) in enumerate([(6, {}), (3, dict(offset=-1)),
                                   (3, dict(offset=1, lower=False))])],
    _np("op:inverse", [_SQ], family="la_op", id="inverse_alias"),
    _np("op:det", [_SQ], family="la_op", id="det_alias"),
    _np("op:slogdet", [_SQ], family="la_op", id="slogdet_alias"),
])


#: the dynamic-shape ops, each with its arrays: their results stay on the
#: operand's device
NP_DYNAMIC = [("unique", [_DUPS], dict(return_index=True,
                                       return_inverse=True,
                                       return_counts=True)),
              ("nonzero", [_INTS], {}), ("flatnonzero", [_INTS], {}),
              ("argwhere", [_INTS], {}), ("bincount", [_f32([0, 2])], {}),
              ("histogram", [_M], {}), ("setdiff1d", [_DUPS, _V], {}),
              ("intersect1d", [_DUPS, _V], {}),
              ("union1d", [_DUPS, _V], {}),
              ("compress_op", [_f32([1, 0, 1]), _M], dict(axis=0)),
              ("extract", [_M > 0, _M], {})]


def np_dynamic_checks(mx, ctx):
    """Each dynamic-shape op on ``ctx``: every result on ``ctx``; on the
    card, each raises ``MXTPUError`` inside a CUDA graph capture. Returns
    the count of ops."""
    nd = mx.nd
    for name, arrays, kwargs in NP_DYNAMIC:
        xs = [nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
        out = getattr(nd, name)(*xs, **kwargs)
        for o in out if isinstance(out, tuple) else (out,):
            if o.ctx != ctx:
                raise AssertionError(f"{name}: a result on {o.ctx}, its "
                                     f"operands on {ctx}")
        if ctx.device_type != "gpu":
            continue
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        torch.cuda.synchronize()
        try:
            with torch.cuda.stream(stream), torch.cuda.graph(graph):
                getattr(nd, name)(*xs, **kwargs)
        except mx.MXTPUError:
            pass
        else:
            raise AssertionError(f"{name} inside a CUDA graph capture "
                                 "raised nothing")
    return len(NP_DYNAMIC)


def np_cases_phase(mx, dev_ctx, cases=NP_CASES):
    """Every case of ``cases`` on the card against the same call on the CPU
    in the port (held to the JAX package by the CPU tests), with
    gradients: one line an op family; then the dynamic-shape ops' device
    and capture checks."""
    families = _check_cases(mx, dev_ctx, cases, run_nd_case, check_nd_case)
    for name, fam in families.items():
        print(f"mx.np ops on {dev_ctx} vs the CPU, {name}: {fam['cases']} "
              f"cases equal (largest float difference {fam['worst']:.3e})",
              flush=True)
    n = np_dynamic_checks(mx, dev_ctx)
    print(f"dynamic-shape ops on {dev_ctx}: {n} ops, every result on "
          f"{dev_ctx}" + (", each refused inside a CUDA graph capture"
                          if dev_ctx.device_type == "gpu" else ""),
          flush=True)
    return families


def np_gpt_logits(mx, params, tokens, num_layers, num_heads):
    """The GPT decoder's forward (``gluon.model_zoo.gpt.GPTDecoder``, no
    dropout) written in ``mx.np``/``mx.npx`` names, for either package:
    ``np.einsum`` for every dense layer and the head, ``npx.layer_norm``,
    ``npx.gelu``, ``npx.embedding``, ``np.split``/``reshape``/
    ``transpose``, and ``mx.nd.flash_attention(causal=True)`` (``mx.npx``
    has no attention): ``tokens`` (B, T) -> logits (B, T, V)."""
    np_, npx = mx.np, mx.npx
    b, t = tokens.shape
    vocab, units = params["head.weight"].shape
    d = units // num_heads

    def ln(x, name):
        return npx.layer_norm(x, params[name + ".gamma"],
                              params[name + ".beta"], axis=-1, eps=1e-5)

    def dense(x, name, bias=True):
        y = np_.einsum("btc,oc->bto", x, params[name + ".weight"])
        return np_.add(y, params[name + ".bias"]) if bias else y

    def heads(x):
        return np_.transpose(np_.reshape(x, (b, t, num_heads, d)),
                             (0, 2, 1, 3))

    pos = np_.arange(t, ctx=tokens.context)
    x = np_.add(npx.embedding(tokens, params["word_embed.weight"]),
                npx.embedding(pos, params["position_embed.weight"]))
    for i in range(num_layers):
        pre = f"layer{i}."
        q, k, v = np_.split(dense(ln(x, pre + "ln1"), pre + "attn.qkv"), 3,
                            axis=-1)
        a = mx.nd.flash_attention(heads(q), heads(k), heads(v), causal=True)
        a = np_.reshape(np_.transpose(a, (0, 2, 1, 3)), (b, t, units))
        x = np_.add(x, dense(a, pre + "attn.proj"))
        f = npx.gelu(dense(ln(x, pre + "ln2"), pre + "ffn1"))
        x = np_.add(x, dense(f, pre + "ffn2"))
    return dense(ln(x, "ln_f"), "head", bias=False)


def np_gpt_step(mx, params, tokens, labels, num_layers, num_heads):
    """One training step of ``np_gpt_logits``: the mean cross entropy of
    ``labels`` (B, T) as ``-mean(take_along_axis(log_softmax(logits)))``,
    recorded and run backward (the gradients land in ``params``); returns
    the loss."""
    np_, npx = mx.np, mx.npx
    with mx.autograd.record():
        logp = npx.log_softmax(np_gpt_logits(mx, params, tokens, num_layers,
                                             num_heads))
        loss = -np_.mean(np_.take_along_axis(
            logp, np_.expand_dims(labels, -1), axis=-1))
    loss.backward()
    return float(loss.asscalar())


def np_phase(seed, card, net, ctx, b=8, lr=3e-4, cases=NP_CASES, reps=5):
    """The mx.np phase on a GPT decoder ``net`` (dropout 0) at B=``b``,
    T=its ``max_length``: ``np_gpt_step`` on the net's own parameters, its
    loss and every gradient against the gluon forward's with
    ``SoftmaxCrossEntropyLoss`` (mean; ``GRAD_RTOL``);
    ``mx.nd.clip_by_global_norm`` over the gradients, with ``max_norm``
    half their global norm, against the same scaling in torch; a learning
    check (5 ``gluon.Trainer`` adam steps, the loss falls 5%); the flash
    launches by route of those 6 passes; the step timed beside the gluon
    step and both profiled (device ms and launches a step); then
    ``np_cases_phase`` on ``cases``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.ndarray import NDArray
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    t0_phase = time.perf_counter()
    t, vocab = net.max_length, net.vocab_size
    layers, heads = net.num_layers, net.num_heads
    rs = np.random.RandomState(seed + 11)
    tokens = mx.nd.array(rs.randint(0, vocab, (b, t)), ctx=ctx)
    labels = mx.nd.array(rs.randint(0, vocab, (b, t)), ctx=ctx,
                         dtype="int32")
    flat_labels = labels.reshape(-1)
    named = [(n, p) for n, p in _param_tensors(net).items()
             if p.requires_grad]
    names = [n for n, _ in named]
    params = {n: NDArray(p) for n, p in named}
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": lr})

    def gluon_step():
        with mx.autograd.record():
            loss = ce(net(tokens).reshape((-1, vocab)), flat_labels).mean()
        loss.backward()
        return loss.asscalar()

    def np_step():
        return np_gpt_step(mx, params, tokens, labels, layers, heads)

    ref_loss = float(gluon_step())
    ref_grads = [p.grad.clone() for _, p in named]
    torch.cuda.synchronize()
    _reset_launches(fa)
    loss0 = np_step()
    grads = [p.grad for _, p in named]
    worst = _worst_grad("mx.np GPT step", names, grads, ref_grads, GRAD_RTOL)
    print(f"mx.np GPT step oracle (fp32, B={b}, T={t}, {len(names)} "
          f"parameter tensors): mean cross entropy {loss0:.6f} "
          f"(np.take_along_axis of npx.log_softmax) vs {ref_loss:.6f} "
          f"(gluon, SoftmaxCrossEntropyLoss); worst gradient relative L2 "
          f"error {worst[0]:.3e} ({worst[1]}), tolerance {GRAD_RTOL:g}",
          flush=True)
    if not abs(loss0 - ref_loss) <= 1e-5 * abs(ref_loss):
        raise AssertionError("mx.np GPT step: the loss differs from the "
                             "gluon step's")
    del ref_grads
    total = float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                 for g in grads)))
    # half the norm, so that the op scales (at or under it, it returns its
    # inputs)
    max_norm = 0.5 * total
    scale = min(1.0, max_norm / max(total, 1e-12))
    if not 0.0 < scale < 1.0:
        raise AssertionError(f"clip_by_global_norm check: scale {scale}, "
                             f"the gradients' global norm {total}")
    clipped = mx.nd.clip_by_global_norm(*[NDArray(g) for g in grads],
                                        max_norm=max_norm)
    clip_err = max(float((c.as_torch() - g * scale).abs().max())
                   for c, g in zip(clipped, grads))
    print(f"mx.nd.clip_by_global_norm over the {len(grads)} gradients: "
          f"global norm {total:.6f}, max_norm {max_norm:.6f}, scale "
          f"{scale:.6f}, largest difference from the fp64 scaling "
          f"{clip_err:.3e}", flush=True)
    if len(clipped) != len(grads) or not clip_err <= 1e-6 * max(
            float(g.abs().max()) for g in grads):
        raise AssertionError("clip_by_global_norm over the gradients "
                             "differs from the scaling")
    del clipped
    trainer.step(1)
    losses = [loss0]
    for _ in range(5):
        losses.append(np_step())
        trainer.step(1)
    passes = 6
    flash = _read_launches(fa)
    routes = _read_routes(fa)
    print(f"mx.np GPT learning check (gluon.Trainer adam lr {lr:g}, one "
          f"batch): mean cross entropy {[round(v, 4) for v in losses]}",
          flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError("mx.np GPT step: the loss did not fall by 5% "
                             "over 5 steps")
    _check_flash_launches(f"the mx.np GPT step's {passes} passes", flash,
                          routes, {k: layers * passes for k in COUNTERS},
                          training_routes(passes, 0, layers, t,
                                          net.head_dim))

    def np_train():
        np_step()
        trainer.step(1)

    def gluon_train():
        gluon_step()
        trainer.step(1)

    gc.collect()
    times = _median_turns({"np": np_train, "gluon": gluon_train}, reps)
    print(f"mx.np GPT step (fp32, B={b}, T={t}; {card}): {times['np']:.3f} "
          f"ms a step beside the gluon step's {times['gluon']:.3f} (host "
          f"clock, median of {reps} alternating turns, each with its "
          "gluon.Trainer adam step)", flush=True)
    profile = _profile_step(lambda *_: np_train(), None, None, card,
                            times["np"], top=12, what="fp32 mx.np GPT step")
    gluon_profile = _kernel_rows(gluon_train)[0]
    device_ms, gluon_device_ms = (sum(r[0] for r in rows)
                                  for rows in (profile, gluon_profile))
    launches, gluon_launches = (sum(r[1] for r in rows)
                                for rows in (profile, gluon_profile))
    print(f"device time a step: mx.np {device_ms:.3f} ms in {launches} "
          f"launches, gluon {gluon_device_ms:.3f} ms in {gluon_launches} "
          "(torch.profiler)", flush=True)
    gc.collect()
    families = np_cases_phase(mx, ctx, cases)
    seconds = time.perf_counter() - t0_phase
    print(f"mx.np phase: {seconds:.1f} s", flush=True)
    return dict(n_params=len(names), grad_worst_rel=worst[0], loss=loss0,
                ref_loss=ref_loss, learning_losses=losses, passes=passes,
                flash_launches=flash, flash_routes=routes,
                clip_err=clip_err, step_ms=times["np"],
                gluon_step_ms=times["gluon"], device_ms=device_ms,
                gluon_device_ms=gluon_device_ms, launches=launches,
                gluon_launches=gluon_launches, families=families,
                seconds=seconds)



# ---------------------------------------------------------------------------
# sparse phase: ndarray/sparse.py, row-sparse gradients, the sparse-gradient
# Embedding and lazy SGD, the gluon layers and losses of slice 21 and the
# repairs of queue 3's faults
# ---------------------------------------------------------------------------
#: one call of the sparse phase's case tables: ``fn(mx, ctx)`` runs it in
#: the port with ``ctx`` the default context and returns its results as
#: numpy arrays; integers (indices, indptr) are held bit for bit, floats
#: within ``tol`` (None: ND_TOL), everything where ``exact``
FnCase = collections.namedtuple("FnCase", "family id fn tol exact",
                                defaults=(None, False))


def run_fn_case(mx, case, ctx):
    with ctx:
        return [np.asarray(r) for r in case.fn(mx, ctx)]


def check_fn_case(case, got, want):
    return check_nd_case(NdCase(case.family, case.id, case.id, [],
                                tol=case.tol, exact=case.exact), got, want)


def _rsp_out(r):
    return [r.indices.asnumpy(), r.data.asnumpy(), r.asnumpy()]


def _csr_out(c):
    return [c.indices.asnumpy(), c.indptr.asnumpy(), c.data.asnumpy(),
            c.asnumpy()]


def _sparse_rows(seed, shape, rows):
    a = np.zeros(shape, np.float32)
    a[list(rows)] = _nd_rand(seed, len(rows), *shape[1:])
    return a


_SP_ROWS = _sparse_rows(160, (6, 4), (1, 4))
_SP_ROWS_B = _sparse_rows(161, (6, 4), (0, 4, 5))
_SP_CSR = np.where(np.abs(_nd_rand(162, 6, 8)) > 0.5, _nd_rand(162, 6, 8),
                   0).astype(np.float32)
_SP_RHS = _nd_rand(163, 8, 5)
_SP_RHS_T = _nd_rand(164, 6, 3)
_SP_TABLE = _nd_rand(165, 10, 3)
_SP_IDS = np.array([[1, 3, -1], [3, 7, 12]], np.int32)


def _rows_op(mx, rows, shape):
    """A custom op ``x -> x[rows]`` whose backward returns a row-sparse
    gradient."""
    nd = mx.nd

    class Rows(mx.autograd.Function):
        def forward(self, x):
            return x[nd.array(rows, dtype="int32")]

        def backward(self, dy):
            return nd.sparse.row_sparse_array((dy, rows), shape=shape)

    return Rows()


def _grads_into(mx, stype, req, rows_seq):
    """``x``'s gradient buffer of ``stype`` after one backward of a
    row-sparse cotangent (``_rows_op``) for each of ``rows_seq``."""
    x = mx.nd.array(_SP_ROWS_B)
    x.attach_grad(grad_req=req, stype=stype)
    for i, rows in enumerate(rows_seq):
        with mx.autograd.record():
            y = _rows_op(mx, rows, x.shape)(x)
        y.backward(mx.nd.array(_nd_rand(166 + i, len(rows), 4)))
    return _rsp_out(x.grad) if stype == "row_sparse" else [x.grad.asnumpy()]


def _dense_into_rsp(mx, ctx):
    x = mx.nd.array(_SP_ROWS_B)
    x.attach_grad(stype="row_sparse")
    with mx.autograd.record():
        y = (x * mx.nd.array(_f32([[1], [0], [1], [0], [1], [0]]))).sum()
    y.backward()
    return _rsp_out(x.grad)


def _interior_dense(mx, ctx):
    x = mx.nd.array(_SP_TABLE)
    x.attach_grad()
    with mx.autograd.record():
        y = (_rows_op(mx, [3, 0], x.shape)(x * 2.0) * 3.0).sum()
    y.backward()
    return [x.grad.asnumpy()]


def _grad_returns_rsp(mx, ctx):
    x = mx.nd.array(_SP_TABLE)
    x.attach_grad()
    with mx.autograd.record():
        y = (_rows_op(mx, [7, 2], x.shape)(x) ** 2).sum()
    (g,) = mx.autograd.grad([y], [x])
    if not isinstance(g, mx.nd.RowSparseNDArray):
        raise AssertionError(f"autograd.grad gave {type(g).__name__}")
    return _rsp_out(g)


def _dot_off_tape(mx, ctx):
    w = mx.nd.array(_SP_RHS)
    w.attach_grad()
    with mx.autograd.record():
        out = mx.nd.sparse.dot(mx.nd.sparse.csr_matrix(_SP_CSR), w)
    if out.as_torch().requires_grad:
        raise AssertionError("sparse.dot recorded a tape node")
    return [out.asnumpy()]


def _embedding_grad(mx, ctx, ids=_SP_IDS):
    """The sparse-gradient Embedding's output and row-sparse weight
    gradient (ids with the padding id -1 and one outside [-n, n))."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

    emb = mx.gluon.nn.Embedding(10, 3, sparse_grad=True)
    load_jax_params(emb, {"weight": _SP_TABLE}, ctx=ctx)
    with mx.autograd.record():
        out = emb(mx.nd.array(ids, dtype="int32"))
        head = (out * out).sum()
    head.backward()
    g = mx.nd.sparse.RowSparseNDArray.from_torch(emb.weight.grad)
    return [out.asnumpy()] + _rsp_out(g)


def _embedding_trained(mx, ctx, opt, kw, steps=3):
    """The sparse-gradient Embedding's table (and momentum) after
    ``steps`` trainer steps on seeded batches."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

    emb = mx.gluon.nn.Embedding(10, 3, sparse_grad=True)
    load_jax_params(emb, {"weight": _SP_TABLE}, ctx=ctx)
    tr = mx.gluon.Trainer(emb.collect_params(), opt, kw)
    for i in range(steps):
        ids = np.random.RandomState(167 + i).randint(0, 10, (2, 3))
        with mx.autograd.record():
            head = (emb(mx.nd.array(ids, dtype="int32")) ** 2).sum()
        head.backward()
        tr.step(2)
    if tr._fused.last_fallback != "row-sparse gradient":
        raise AssertionError(f"FusedStep: {tr._fused.last_fallback}")
    states = tr._updater.states.get(0)
    states = () if states is None else (
        states if isinstance(states, tuple) else (states,))
    return [emb.weight.detach().cpu().numpy()] + [
        s.detach().cpu().numpy() for s in states]


_SGD_LAZY = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2,
             "clip_gradient": 0.5}
SPARSE_CASES = [
    FnCase("storage", "cast_storage_row_sparse", lambda mx, ctx: _rsp_out(
        mx.nd.array(_SP_ROWS).tostype("row_sparse"))),
    FnCase("storage", "cast_storage_csr", lambda mx, ctx: _csr_out(
        mx.nd.cast_storage(mx.nd.array(_SP_CSR), "csr"))),
    FnCase("storage", "tostype_default", lambda mx, ctx: [
        mx.nd.sparse.csr_matrix(_SP_CSR).tostype("default").asnumpy(),
        mx.nd.sparse.row_sparse_array(_SP_ROWS).tostype(
            "default").asnumpy()]),
    # duplicates kept, so the dense view (which of two writes wins) is
    # left out
    FnCase("storage", "row_sparse_array_sorts", lambda mx, ctx: _rsp_out(
        mx.nd.sparse.row_sparse_array((_SP_RHS[:3], [5, 1, 5]),
                                      shape=(8, 5)))[:2]),
    FnCase("storage", "csr_matrix_parts", lambda mx, ctx: _csr_out(
        mx.nd.sparse.csr_matrix((_f32([1, 2, 3]), [0, 2, 1], [0, 2, 2, 3]),
                                shape=(3, 3)))),
    FnCase("storage", "csr_slices", lambda mx, ctx: [
        a for key in (slice(1, 4), slice(0, 1), slice(5, 5), slice(None))
        for a in _csr_out(mx.nd.sparse.csr_matrix(_SP_CSR)[key])]),
    FnCase("storage", "zeros", lambda mx, ctx: _rsp_out(
        mx.nd.sparse.zeros("row_sparse", (4, 3))) + _csr_out(
        mx.nd.sparse.zeros("csr", (4, 3)))),
    FnCase("storage", "retain", lambda mx, ctx: _rsp_out(
        mx.nd.sparse.retain(mx.nd.sparse.row_sparse_array(_SP_ROWS_B),
                            mx.nd.array([0, 5, 2])))),
    FnCase("arith", "add_row_sparse", lambda mx, ctx: _rsp_out(
        mx.nd.sparse.add(mx.nd.sparse.row_sparse_array(_SP_ROWS),
                         mx.nd.sparse.row_sparse_array(_SP_ROWS_B)))),
    FnCase("arith", "elemwise_add", lambda mx, ctx: _rsp_out(
        mx.nd.sparse.elemwise_add(mx.nd.sparse.row_sparse_array(_SP_ROWS),
                                  mx.nd.sparse.row_sparse_array(
                                      _SP_ROWS_B)))),
    FnCase("arith", "add_densifies", lambda mx, ctx: [
        (mx.nd.sparse.row_sparse_array(_SP_ROWS)
         + mx.nd.array(_SP_ROWS_B)).asnumpy(),
        mx.nd.sparse.add(mx.nd.array(_SP_ROWS_B[:, :4]),
                         mx.nd.sparse.csr_matrix(_SP_ROWS)).asnumpy()]),
    FnCase("dot", "csr_dense", lambda mx, ctx: [mx.nd.sparse.dot(
        mx.nd.sparse.csr_matrix(_SP_CSR), mx.nd.array(_SP_RHS)).asnumpy()]),
    FnCase("dot", "csr_t_dense", lambda mx, ctx: [mx.nd.sparse.dot(
        mx.nd.sparse.csr_matrix(_SP_CSR), mx.nd.array(_SP_RHS_T),
        transpose_a=True).asnumpy()]),
    FnCase("dot", "row_sparse_dense", lambda mx, ctx: [mx.nd.sparse.dot(
        mx.nd.sparse.row_sparse_array(_SP_ROWS), mx.nd.array(_SP_RHS[:4]))
        .asnumpy()]),
    FnCase("dot", "off_the_tape", _dot_off_tape),
    FnCase("autograd", "row_sparse_into_row_sparse_write",
             lambda mx, ctx: _grads_into(mx, "row_sparse", "write",
                                         ([4, 1], [2, 4]))),
    FnCase("autograd", "row_sparse_into_row_sparse_add",
             lambda mx, ctx: _grads_into(mx, "row_sparse", "add",
                                         ([4, 1], [2, 4]))),
    FnCase("autograd", "row_sparse_into_dense",
             lambda mx, ctx: _grads_into(mx, "default", "add",
                                         ([4, 1], [2, 4]))),
    FnCase("autograd", "dense_into_row_sparse", _dense_into_rsp),
    FnCase("autograd", "interior_nodes_dense", _interior_dense),
    FnCase("autograd", "grad_returns_row_sparse", _grad_returns_rsp),
    FnCase("embedding", "sparse_grad", _embedding_grad),
    FnCase("optimizer", "lazy_sgd_3_steps", lambda mx, ctx:
             _embedding_trained(mx, ctx, "sgd", _SGD_LAZY)),
    FnCase("optimizer", "sgd_not_lazy_densifies", lambda mx, ctx:
             _embedding_trained(mx, ctx, "sgd", dict(_SGD_LAZY,
                                                     lazy_update=False))),
    FnCase("optimizer", "adam_densifies", lambda mx, ctx:
             _embedding_trained(mx, ctx, "adam", {"learning_rate": 0.01,
                                                  "wd": 1e-2})),
]


def _layer_case(name, cls, kwargs, shape, tol=None):
    """A layer's output, input gradient and parameter gradients of
    ``sum(out * g)``; its parameters (drawn after a first forward fills
    the deferred shapes) set from a seed."""
    def fn(mx, ctx):
        net = getattr(mx.gluon.nn, cls)(**kwargs)
        net.initialize(ctx=ctx)
        x = mx.nd.array(_nd_rand(171, *shape))
        with torch.no_grad():
            net(x)
        named = sorted(net.named_parameters())
        with torch.no_grad():
            for i, (_, p) in enumerate(named):
                p.copy_(torch.from_numpy(_nd_rand(172 + i, *p.shape)))
        x.attach_grad()
        with mx.autograd.record():
            out = net(x)
            head = (out * mx.nd.array(_nd_rand(180, *out.shape))).sum()
        head.backward()
        return [out.asnumpy(), x.grad.asnumpy()] + [
            p.grad.cpu().numpy() for _, p in named]

    return FnCase("layers", name, fn, tol)


LAYER_CASES = [
    _layer_case("LeakyReLU", "LeakyReLU", dict(alpha=0.1), (3, 7)),
    _layer_case("PReLU", "PReLU", dict(in_channels=3), (2, 3, 4, 4)),
    _layer_case("ELU", "ELU", dict(alpha=0.5), (3, 7)),
    _layer_case("SELU", "SELU", {}, (3, 7)),
    _layer_case("GELU", "GELU", {}, (3, 7)),
    _layer_case("GELU_erf", "GELU", dict(approximate=False), (3, 7)),
    _layer_case("SiLU", "SiLU", {}, (3, 7)),
    _layer_case("Lambda", "Lambda", dict(function="tanh"), (3, 4)),
    _layer_case("HybridLambda", "HybridLambda", dict(function="relu"),
                (3, 4)),
    _layer_case("GroupNorm", "GroupNorm", dict(num_groups=2), (2, 4, 3, 3),
                ND_LOOSE),
    _layer_case("InstanceNorm", "InstanceNorm", {}, (2, 3, 4, 4), ND_LOOSE),
    _layer_case("RMSNorm", "RMSNorm", dict(epsilon=1e-5), (2, 5, 6)),
    _layer_case("Conv1DTranspose", "Conv1DTranspose",
                dict(channels=4, kernel_size=3, strides=2, padding=1,
                     output_padding=1, use_bias=False, in_channels=3),
                (2, 3, 7), ND_LOOSE),
    _layer_case("Conv2DTranspose", "Conv2DTranspose",
                dict(channels=6, kernel_size=3, strides=(2, 1),
                     padding=(1, 0), output_padding=(1, 0),
                     dilation=(1, 2), groups=2, activation="relu"),
                (2, 4, 5, 5), ND_LOOSE),
    _layer_case("ReflectionPad2D", "ReflectionPad2D", dict(padding=(1, 2)),
                (2, 3, 5, 6)),
]

_L_P = _nd_rand(190, 4, 3, lo=-3.0, hi=3.0)
_L_PROB = _nd_rand(191, 4, 3, lo=0.05, hi=0.95)
_L_Y01 = (_nd_rand(192, 4, 3) > 0).astype(np.float32)
_L_SIGNED = np.where(_nd_rand(193, 4, 3) > 0, 1.0, -1.0).astype(np.float32)
_L_SW = _nd_rand(194, 4, 1, lo=0.2, hi=1.0)
_L_LOGP = np.log(np.random.RandomState(195).dirichlet(np.ones(5), 4)).astype(
    np.float32)
_L_Q = np.random.RandomState(196).dirichlet(np.ones(5), 4).astype(np.float32)
_L_A, _L_POS, _L_NEG = (_nd_rand(197 + i, 4, 2, 3) for i in range(3))
_L_COUNTS = np.random.RandomState(200).poisson(2.0, (4, 3)).astype(
    np.float32)
_L_CTC = _nd_rand(201, 3, 6, 5, lo=-2.0, hi=2.0)
_L_CTC_LABELS = _f32([[1, 2, -1], [3, 3, 1], [4, -1, -1]])


def _loss_case(name, cls, kwargs, arrays, grads=(0,), tol=None):
    """A loss's per-sample values and the gradients of ``sum(loss * g)``
    with respect to ``arrays[grads]`` (None: an argument left out)."""
    def fn(mx, ctx):
        xs = [None if a is None else mx.nd.array(a) for a in arrays]
        for i in grads:
            xs[i].attach_grad()
        with mx.autograd.record():
            out = getattr(mx.gluon.loss, cls)(**kwargs)(*xs)
            head = (out * mx.nd.array(_nd_rand(202, *out.shape, lo=0.5,
                                               hi=1.5))).sum()
        head.backward()
        return [out.asnumpy()] + [xs[i].grad.asnumpy() for i in grads]

    return FnCase("losses", name, fn, tol)


LOSS_CASES = [
    _loss_case("sigmoid_bce", "SigmoidBinaryCrossEntropyLoss",
               dict(weight=0.5), [_L_P, _L_Y01, _L_SW]),
    _loss_case("sigmoid_bce_from_sigmoid", "SigmoidBinaryCrossEntropyLoss",
               dict(from_sigmoid=True, batch_axis=1), [_L_PROB, _L_Y01]),
    _loss_case("sigmoid_bce_pos_weight", "SigmoidBinaryCrossEntropyLoss",
               {}, [_L_P, _L_Y01, None, _nd_rand(203, 1, 3, lo=0.5,
                                                 hi=3.0)]),
    _loss_case("kldiv", "KLDivLoss", dict(from_logits=False, weight=2.0),
               [_L_LOGP * 3, _L_Q]),
    _loss_case("huber", "HuberLoss", dict(rho=0.5), [_L_P, _L_P * 0.5
                                                     + _L_PROB, _L_SW],
               (0, 1)),
    _loss_case("hinge", "HingeLoss", dict(margin=2.0, batch_axis=1),
               [_L_P, _L_SIGNED]),
    _loss_case("squared_hinge", "SquaredHingeLoss", dict(weight=0.3),
               [_L_P, _L_SIGNED, _L_SW]),
    _loss_case("logistic_signed", "LogisticLoss", {}, [_L_P, _L_SIGNED]),
    _loss_case("logistic_binary", "LogisticLoss",
               dict(label_format="binary"), [_L_P, _L_Y01]),
    _loss_case("triplet", "TripletLoss", dict(margin=0.5),
               [_L_A, _L_POS, _L_NEG], (0, 1, 2)),
    _loss_case("cosine", "CosineEmbeddingLoss", dict(margin=0.2),
               [_L_A, _L_POS, _L_SIGNED[:, 0].copy()], (0, 1)),
    _loss_case("poisson_full", "PoissonNLLLoss",
               dict(from_logits=False, compute_full=True),
               [_L_PROB * 3, _L_COUNTS, _L_SW]),
    _loss_case("ctc_lengths", "CTCLoss", dict(layout="NTC"),
               [_L_CTC, _L_CTC_LABELS, _f32([6, 4, 5]), _f32([2, 3, 1])]),
    _loss_case("ctc_tnc", "CTCLoss", dict(layout="TNC", weight=0.5),
               [_L_CTC.transpose(1, 0, 2).copy(), _L_CTC_LABELS]),
    _loss_case("sdml", "SDMLLoss", dict(smoothing_parameter=0.1),
               [_nd_rand(204, 4, 6), _nd_rand(205, 4, 6)], (0, 1)),
]

_SATURATE = _f32([-300.7, -100.2, 200.3, 300.6, 1e10, -1e10, np.nan,
                  np.inf, -np.inf])
_DIVIDEND = np.array([5, -5, 0, 7, -7, 6, -6, 0], np.int32)
_DIVISOR = np.array([0, 0, 0, 3, 2, -4, 4, -3], np.int32)
_DIVISIONS = {
    "operator": lambda mx, a, b: a % b,
    "broadcast_mod": lambda mx, a, b: mx.nd.broadcast_mod(a, b),
    "scalar": lambda mx, a, b: a % 0,
    "reversed_scalar": lambda mx, a, b: -7 % b,
    "nd_floor_divide": lambda mx, a, b: mx.nd.floor_divide(a, b),
    "np_mod": lambda mx, a, b: mx.np.mod(a, b),
    "np_remainder": lambda mx, a, b: mx.np.remainder(a, b),
    "np_fmod": lambda mx, a, b: mx.np.fmod(a, b),
    "np_floor_divide": lambda mx, a, b: mx.np.floor_divide(a, b)}


def _division_case(name):
    def fn(mx, ctx):
        a = mx.nd.array(_DIVIDEND, dtype="int32")
        b = mx.nd.array(_DIVISOR, dtype="int32")
        return [_DIVISIONS[name](mx, a, b).asnumpy()]

    return FnCase("repairs", f"division_by_zero_{name}", fn, exact=True)


def _null_head(mx, ctx):
    """``backward`` of a head recorded from an input with ``grad_req=
    "null"``: returns, every gradient as it was."""
    x = mx.nd.array(_f32([1, 2, 3, 4]))
    x.attach_grad(grad_req="null")
    y = mx.nd.array(_f32([1, 1, 1, 1]))
    y.attach_grad()
    y.grad[:] = 7.0
    with mx.autograd.record():
        head = (x * x).sum()
    head.backward()
    return [x.grad.asnumpy(), y.grad.asnumpy()]


def _second_backward(mx, ctx):
    """A second ``backward`` through a freed graph raises, naming
    ``retain_graph=True``; the gradient of the first stays."""
    x = mx.nd.array(_f32([1, 2, 3]))
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    try:
        y.backward()
    except RuntimeError as e:
        if "you need to pass retain_graph=True to backward" not in str(e):
            raise
        return [x.grad.asnumpy()]
    raise AssertionError("a second backward through a freed graph raised "
                         "nothing")


REPAIR_CASES = [
    FnCase("repairs", f"astype_{dt}", functools.partial(
        lambda dt, mx, ctx: [mx.nd.array(_SATURATE).astype(dt).asnumpy(),
                             mx.nd.cast(mx.nd.array(_SATURATE),
                                        dtype=dt).asnumpy()], dt),
        exact=True) for dt in ("int8", "uint8", "int32", "int64")
] + [_division_case(name) for name in _DIVISIONS] + [
    FnCase("repairs", "recorded_head_with_no_gradient", _null_head,
           exact=True),
    FnCase("repairs", "second_backward_names_retain_graph",
           _second_backward, exact=True)]


def _sparse_capture_checks(mx, ctx):
    """On the card, each sparse op whose output size depends on the data
    raises ``MXTPUError`` inside a CUDA graph capture; returns the count
    of ops."""
    sp = mx.nd.sparse
    with ctx:
        rsp = sp.row_sparse_array(_SP_ROWS)
        csr = sp.csr_matrix(_SP_CSR)
        dense = mx.nd.array(_SP_ROWS)
        emb = mx.gluon.nn.Embedding(10, 3, sparse_grad=True)
        emb.initialize(ctx=ctx)
        ids = mx.nd.array(_SP_IDS, dtype="int32")

        def embedding_backward():
            with mx.autograd.record():
                head = emb(ids).sum()
            head.backward()

        ops = {"cast_storage": lambda: dense.tostype("row_sparse"),
               "retain": lambda: rsp.retain([1]),
               "row_sparse add": lambda: rsp + rsp,
               "csr slice": lambda: csr[1:3],
               "Embedding(sparse_grad=True) backward": embedding_backward}
        for name, op in ops.items():
            graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
            torch.cuda.synchronize()
            try:
                with torch.cuda.stream(stream), torch.cuda.graph(graph):
                    op()
            except mx.MXTPUError:
                continue
            raise AssertionError(f"{name} inside a CUDA graph capture "
                                 "raised nothing")
    return len(ops)


def sparse_cases_phase(mx, ctx, tables=None):
    """Every case of ``SPARSE_CASES``, ``LAYER_CASES``, ``LOSS_CASES`` and
    ``REPAIR_CASES`` (or ``tables``) on ``ctx`` against the port on the CPU
    (held to the JAX package by the CPU tests): one line a family; then on
    the card the sparse ops refused inside a CUDA graph capture."""
    cases = [c for table in (tables or (SPARSE_CASES, LAYER_CASES,
                                        LOSS_CASES, REPAIR_CASES))
             for c in table]
    families = _check_cases(mx, ctx, cases, run_fn_case, check_fn_case)
    for name, fam in families.items():
        print(f"slice 21 on {ctx} vs the CPU, {name}: {fam['cases']} cases "
              f"equal (largest float difference {fam['worst']:.3e})",
              flush=True)
    if ctx.device_type == "gpu":
        n = _sparse_capture_checks(mx, ctx)
        print(f"sparse ops on {ctx}: {n} data-sized ops each refused inside "
              "a CUDA graph capture", flush=True)
    return families


SPARSE_LR = 3e-5
SPARSE_WD = 1e-4
#: the lazy update against its plain version (the same rule written out
#: over the dense gradient): relative L2 of the table and the momentum
LAZY_RTOL = 1e-6
#: the csr products against scipy in float64 (relative L2)
CSR_RTOL = 1e-5
CSR_FIELDS = 15


def _as_double(a, device=None):
    a = a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))
    return a.detach().to(device or a.device, torch.float64)


def _l2(a):
    """``||a||`` in float64 (a tensor or numpy)."""
    return _as_double(a).norm().item()


def _rel_l2(got, want):
    """``||got - want|| / ||want||`` in float64 (``||got - want||`` where
    ``want`` is 0), on ``got``'s device: tensors (on any devices) or
    numpy."""
    got = _as_double(got)
    want = _as_double(want, got.device)
    den, err = want.norm().item(), (got - want).norm().item()
    return err / den if den > 0 else err


def _lazy_plain(table, mom, dense_grad, ids, lr, wd, momentum):
    """The lazy SGD rule written out in plain PyTorch over the dense
    gradient and the batch's distinct ids: ``(table, momentum)`` after
    the step (copies)."""
    g = dense_grad[ids] + wd * table[ids]
    m = momentum * mom[ids] - lr * g
    new_table, new_mom = table.clone(), mom.clone()
    new_table[ids] = table[ids] + m
    new_mom[ids] = m
    return new_table, new_mom


def sparse_bert(seed, card, net, ctx, sizes=BERT_SIZES[:2], steps=3,
                lr=SPARSE_LR):
    """(a) of the sparse phase on ``net`` (a fp32 ``BERTModel``,
    ``attention_impl="pallas"``, dropout 0): ``word_embed`` replaced by
    ``Embedding(vocab, units, sparse_grad=True)`` holding the same weight,
    beside a copy of the net with its dense embedding; ``steps`` steps of
    both through ``gluon.Trainer`` (sgd, momentum 0.9, wd ``SPARSE_WD``,
    ``lazy_update``), a fresh batch each (``bert_batch`` with
    ``bert_lengths``). Each step: the row-sparse gradient on the device,
    its indices the batch's sorted distinct tokens (int32), its rows the
    dense run's within GRAD_RTOL (every other gradient too at the first
    step); after the update every other parameter the dense run's within
    GRAD_RTOL, the table and the momentum against ``_lazy_plain`` within
    ``LAZY_RTOL``. Then: rows no batch touched
    bit-equal to their start, ``last_fallback``, each step lowering its
    batch's loss (a forward after the update), K4-K6 a layer a pass on
    f32 (the training passes and those forwards), and the device ms of the
    lazy update beside a dense SGD over the whole table."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, optimizer
    from incubator_mxnet_tpu_torch.models import MultiHeadAttention
    from incubator_mxnet_tpu_torch.ndarray import sparse
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    b, t = sizes
    dev = ctx.torch_device()
    set_attention_impl(net, "pallas")
    cells = [m for m in net.modules() if isinstance(m, MultiHeadAttention)]
    layers, heads = len(cells), cells[0]._heads
    d = cells[0]._units // heads
    vocab, units = net.word_embed.weight.shape
    dense_net = copy.deepcopy(net)
    emb = gluon.nn.Embedding(vocab, units, sparse_grad=True)
    emb.weight = net.word_embed.weight
    net.word_embed = emb
    table = emb.weight
    loss_fn = bert_pretrain_loss(gluon.loss.SoftmaxCrossEntropyLoss())
    kw = {"learning_rate": lr, "momentum": 0.9, "wd": SPARSE_WD,
          "lazy_update": True}
    tr = gluon.Trainer(net.collect_params(), "sgd", kw)
    dtr = gluon.Trainer(dense_net.collect_params(), "sgd", kw)
    names = [n for n, p in _param_tensors(net).items()
             if p.requires_grad and n != "word_embed.weight"]
    params = dict(_param_tensors(net))
    dparams = dict(_param_tensors(dense_net))
    slot = tr._param2idx[id(table)]
    start = table.detach().clone()
    lens = bert_lengths(seed, b, t)
    rs = np.random.RandomState(seed + 131)
    touched = torch.zeros(vocab, dtype=torch.bool, device=dev)
    losses, after = [], []
    worst_rows, worst_other, worst_plain = 0.0, (0.0, ""), 0.0
    worst_grad = (0.0, "")
    _reset_launches(fa)
    for step in range(steps):
        data, labels = bert_batch(rs, b, t, vocab, dev, lens)
        with mx.autograd.record():
            loss = loss_fn(*net(*data), *labels)
        mx.autograd.backward(loss)
        with mx.autograd.record():
            dloss = loss_fn(*dense_net(*data), *labels)
        mx.autograd.backward(dloss)
        losses.append(float(loss.detach()))
        g = table.grad
        if not (g.is_sparse and g.is_cuda == (dev.type == "cuda")):
            raise AssertionError(f"word_embed's gradient: sparse "
                                 f"{g.is_sparse} on {g.device}")
        rsp = sparse.RowSparseNDArray.from_torch(g)
        ids = torch.unique(data[0].long())
        if rsp._indices.dtype != torch.int32 \
                or not torch.equal(rsp._indices.long(), ids):
            raise AssertionError("word_embed's gradient: its indices are "
                                 "not the batch's sorted distinct tokens")
        dense_g = dense_net.word_embed.weight.grad
        worst_rows = max(worst_rows, _rel_l2(rsp._data, dense_g[ids]))
        if step == 0:
            # the same weights and batch: every other gradient the dense
            # run's (later steps start from weights the two rules moved
            # apart, and the top layers' query and key gradients in fp32
            # amplify any difference: ROADMAP.md queue 2, item 6)
            worst_grad = _worst_grad(
                "sparse BERT's first step", names,
                [params[n].grad for n in names],
                [dparams[n].grad for n in names], GRAD_RTOL)
        before = table.detach().clone()
        mom = tr._updater.states.get(slot)
        mom = torch.zeros_like(before) if mom is None else mom.clone()
        tr.step(1)
        dtr.step(1)
        worst_other = max(worst_other, _worst_grad(
            f"sparse BERT step {step}'s parameters", names,
            [params[n] for n in names], [dparams[n] for n in names],
            GRAD_RTOL))
        want_table, want_mom = _lazy_plain(before, mom, g.to_dense(), ids,
                                           lr, SPARSE_WD, 0.9)
        worst_plain = max(worst_plain, _rel_l2(table, want_table),
                          _rel_l2(tr._updater.states[slot], want_mom))
        touched[ids] = True
        # the step's own batch after its update: a descent step lowers it
        with torch.no_grad():
            after.append(float(loss_fn(*net(*data), *labels)))
    torch.cuda.synchronize()
    launches, routes = _read_launches(fa), _read_routes(fa)
    want_routes = training_routes(2 * steps, 0, layers, t, d)
    want_routes["flash_fwd_" + fwd_route_expected(t, d, torch.float32)] \
        += layers * steps
    _check_flash_launches(f"the sparse BERT steps ({2 * steps} passes and "
                          f"{steps} forwards)", launches, routes,
                          {"flash_fwd": layers * 3 * steps,
                           "flash_bwd_dq": layers * 2 * steps,
                           "flash_bwd_dkv": layers * 2 * steps},
                          want_routes)
    untouched = ~touched
    kept = bool(torch.equal(table.detach()[untouched], start[untouched]))
    print(f"sparse BERT (fp32, B={b}, T={t}, word_embed "
          f"Embedding({vocab}, {units}, sparse_grad=True), sgd lr {lr:g} "
          f"momentum 0.9 wd {SPARSE_WD:g} lazy_update; {card}): losses "
          f"{[round(v, 4) for v in losses]}, each batch's after its step "
          f"{[round(v, 4) for v in after]}; row-sparse gradient rows against "
          f"the dense run's: worst relative L2 {worst_rows:.3e}; every other "
          f"gradient of the first step {worst_grad[0]:.3e} "
          f"({worst_grad[1]}), every other parameter after each step "
          f"{worst_other[0]:.3e} ({worst_other[1]}), tolerance "
          f"{GRAD_RTOL:g}; table and momentum against the plain lazy rule "
          f"{worst_plain:.3e} (tolerance {LAZY_RTOL:g}); "
          f"{int(untouched.sum())} untouched rows bit-equal: {kept}; "
          f"FusedStep fallback: {tr._fused.last_fallback!r}", flush=True)
    if not worst_rows <= GRAD_RTOL or not worst_plain <= LAZY_RTOL:
        raise AssertionError("sparse BERT: the row-sparse gradient or the "
                             "lazy update differs")
    if not kept or tr._fused.last_fallback != "row-sparse gradient":
        raise AssertionError("sparse BERT: an untouched row moved, or the "
                             "FusedStep did not fall back")
    if not all(math.isfinite(v) and a < v for v, a in zip(losses, after)):
        raise AssertionError("sparse BERT: a step did not lower its batch's "
                             "loss")
    # the update alone, on copies: the lazy rule against dense SGD over
    # the whole table (device ms, the mean of 10 calls)
    sgd = optimizer.create("sgd", learning_rate=lr, momentum=0.9,
                           wd=SPARSE_WD)
    w, m = table.detach().clone(), tr._updater.states[slot].clone()
    dense_grad = g.to_dense()
    reps = 10
    lazy_ms = _kernel_ms(lambda: [sgd.update(0, w, g, m)
                                  for _ in range(reps)]) / reps
    dense_ms = _kernel_ms(lambda: [sgd.update(1, w, dense_grad, m)
                                   for _ in range(reps)]) / reps
    print(f"word_embed's update ({card}): lazy {lazy_ms:.5f} ms over "
          f"{rsp.nnz} rows, dense SGD over the {vocab}x{units} table "
          f"{dense_ms:.5f} ms (device time, torch.profiler, mean of {reps})",
          flush=True)
    del dense_net, dtr
    return dict(losses=losses, losses_after=after,
                grad_rows_worst_rel=worst_rows,
                grad_worst_rel=worst_grad[0],
                param_worst_rel=worst_other[0], lazy_worst_rel=worst_plain,
                untouched_rows=int(untouched.sum()), rows=rsp.nnz,
                lazy_update_ms=lazy_ms, dense_update_ms=dense_ms,
                flash_launches=launches, flash_routes=routes)


def csr_linear(seed, card, ctx, rows=8192, features=1_000_000,
               fields=CSR_FIELDS, steps=5, lr=0.1):
    """(b) of the sparse phase: a LibSVM-style linear classifier (MXNet's
    ``example/sparse/linear_classification``) on synthetic csr data drawn
    from ``seed``: ``rows`` rows of ``features`` features, one nonzero
    (1.0) in each of ``fields`` field blocks, labels from a hidden weight.
    ``steps`` SGD steps of ``sparse.dot(X, w)`` + bias through
    ``SigmoidBinaryCrossEntropyLoss`` (summed over the rows; the bias
    takes the mean gradient), the weight gradient
    ``sparse.dot(X, dy, transpose_a=True)``: both products each step
    against ``scipy.sparse`` in float64 within ``CSR_RTOL``, the loss
    falling; ``X[0:rows // 2]`` and a ``cast_storage`` round trip of 64
    rows against scipy; the products' device ms beside
    ``torch.sparse.mm`` on the same csr."""
    import scipy.sparse as ssp

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, optimizer
    from incubator_mxnet_tpu_torch.ndarray import NDArray, sparse

    dev = ctx.torch_device()
    rs = np.random.RandomState(seed + 211)
    edges = np.linspace(0, features, fields + 1).astype(np.int64)
    cols = (edges[:-1] + rs.randint(0, np.diff(edges), (rows, fields))
            ).astype(np.int32).ravel()
    vals = np.ones(cols.size, np.float32)
    indptr = np.arange(0, cols.size + 1, fields, dtype=np.int32)
    host = ssp.csr_matrix((vals, cols, indptr), shape=(rows, features))
    hidden = rs.randn(features)
    y = (host @ hidden > 0).astype(np.float32).reshape(rows, 1)
    X = sparse.csr_matrix((vals, cols, indptr), shape=(rows, features),
                          ctx=ctx)
    yt = torch.as_tensor(y, device=dev)
    w = torch.zeros((features, 1), device=dev)
    bias = torch.zeros((1,), device=dev)
    sgd = optimizer.create("sgd", learning_rate=lr)
    upd = optimizer.get_updater(sgd)
    loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()
    losses, worst = [], 0.0
    for _ in range(steps):
        prod = sparse.dot(X, NDArray(w)).as_torch()
        z = (prod + bias).requires_grad_()
        with mx.autograd.record():
            loss = loss_fn(z, yt).sum()
        (dy,) = torch.autograd.grad(loss, z)
        gw = sparse.dot(X, NDArray(dy), transpose_a=True).as_torch()
        worst = max(worst,
                    _rel_l2(prod.cpu().numpy(),
                            host @ w.double().cpu().numpy()),
                    _rel_l2(gw.cpu().numpy(),
                            host.T @ dy.double().cpu().numpy()))
        losses.append(float(loss.detach()) / rows)
        upd(0, gw, w)
        # the bias, which every row shares, steps by the mean gradient; a
        # weight, which sits in few rows, by the summed one
        upd(1, dy.mean(0), bias)
    half = X[0:rows // 2]
    part = X[64:128]
    back = part.tostype("default").tostype("csr")
    for got, want in ((half, host[0:rows // 2]), (back, host[64:128])):
        want = want.tocsr()
        for name, ref in (("indptr", want.indptr), ("indices", want.indices),
                          ("data", want.data)):
            arr = getattr(got, name).asnumpy()
            if arr.shape != ref.shape or not np.array_equal(arr, ref):
                raise AssertionError(f"csr slice/round trip: {name} differs "
                                     "from scipy's")
    print(f"csr linear classifier ({rows} rows, {features} features, "
          f"{fields} nonzeros a row, sgd lr {lr:g}; {card}): losses "
          f"{[round(v, 5) for v in losses]}; both products against scipy "
          f"(float64) worst relative L2 {worst:.3e} (tolerance "
          f"{CSR_RTOL:g}); X[0:{rows // 2}] and a cast_storage round trip "
          "of 64 rows equal scipy's", flush=True)
    if not worst <= CSR_RTOL:
        raise AssertionError("csr linear classifier: a product differs from "
                             "scipy's")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] \
            < losses[0]:
        raise AssertionError("csr linear classifier: the loss did not fall")
    # device ms: the port's products beside torch.sparse.mm on the same
    # csr (X^T handed to the library in csr form, built on the host)
    reps = 10
    dy = NDArray(dy)
    lib = torch.sparse_csr_tensor(X._indptr.long(), X._indices.long(),
                                  X._data, (rows, features),
                                  check_invariants=False)
    host_t = host.T.tocsr()
    lib_t = torch.sparse_csr_tensor(
        torch.as_tensor(host_t.indptr, dtype=torch.int64, device=dev),
        torch.as_tensor(host_t.indices, dtype=torch.int64, device=dev),
        torch.as_tensor(host_t.data, device=dev), (features, rows),
        check_invariants=False)
    times = {
        "dot_ms": lambda: sparse.dot(X, NDArray(w)),
        "dot_t_ms": lambda: sparse.dot(X, dy, transpose_a=True),
        "library_dot_ms": lambda: torch.sparse.mm(lib, w),
        "library_dot_t_ms": lambda: torch.sparse.mm(lib_t, dy.as_torch())}
    times = {k: _kernel_ms(lambda fn=fn: [fn() for _ in range(reps)]) / reps
             for k, fn in times.items()}
    print(f"csr products ({card}; device time, torch.profiler, mean of "
          f"{reps}): X.w {times['dot_ms']:.5f} ms (torch.sparse.mm "
          f"{times['library_dot_ms']:.5f}), X^T.dy {times['dot_t_ms']:.5f} ms "
          f"(torch.sparse.mm {times['library_dot_t_ms']:.5f})", flush=True)
    return dict(losses=losses, products_worst_rel=worst, rows=rows,
                features=features, nnz=int(cols.size), **times)


def sparse_phase(seed, card, net, ctx, sizes=BERT_SIZES[:2],
                 csr_rows=8192, csr_features=1_000_000):
    """The sparse phase: ``sparse_bert`` on ``net``, ``csr_linear`` at
    ``csr_rows`` x ``csr_features``, then ``sparse_cases_phase``."""
    import incubator_mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    out = dict(bert=sparse_bert(seed, card, net, ctx, sizes))
    gc.collect()
    out["csr"] = csr_linear(seed, card, ctx, csr_rows, csr_features)
    out["families"] = sparse_cases_phase(mx, ctx)
    out["seconds"] = time.perf_counter() - t0
    print(f"sparse phase: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# vision phase: the rest of the vision zoo (gluon/model_zoo/vision), with
# gluon.contrib.nn, and gluon/utils.py on the GPT-117M step
# ---------------------------------------------------------------------------
#: the vision phase's models at ImageNet width: image size and the
#: inventory the JAX package gives at classes=1000 once its first forward
#: filled the deferred shapes (values with the running statistics,
#: trainable tensors, running statistics, convs)
VISION_MODELS = {
    "alexnet": (224, (61_100_840, 16, 0, 5)),
    "vgg16_bn": (224, (138_374_440, 58, 26, 13)),
    "squeezenet1.1": (224, (1_235_496, 52, 0, 26)),
    "densenet121": (224, (8_062_504, 364, 242, 120)),
    "inceptionv3": (299, (23_869_000, 284, 188, 94)),
    "mobilenet1.0": (224, (4_253_864, 83, 54, 27)),
    "mobilenetv2_1.0": (224, (3_539_136, 160, 106, 54)),
    "mobilenetv3_large": (224, (5_505_598, 174, 92, 62)),
}
#: sgd learning rates of the learning check (momentum 0.9) where they are
#: not VISION_LR_DEFAULT: the smallest rate of
#: tools/torch_vision_lr_sweep.py's (0.01 to 3) that lowered the loss by
#: 10% (twice the gate) over the 6 steps on the card; SqueezeNet's, where
#: none did and 3 diverged, the one that lowered it most (7.4%)
VISION_LR = {"alexnet": 0.03, "squeezenet1.1": 1.0, "inceptionv3": 0.3,
             "mobilenet1.0": 0.1, "mobilenetv2_1.0": 0.1}
VISION_LR_DEFAULT = 0.01
VISION_CLIP = 10.0
VISION_BATCHES = (2, 32)             # the parity check, the learning check
VISION_STEPS = 6
#: the eval logits, card against the CPU (relative L2)
VISION_EVAL_RTOL = 1e-4
#: a deep net's training-mode forward amplifies its rounding: its logits
#: are held to be no farther from its fp64 model's than this times the CPU
#: copy's distance from its own (``vision_parity``)
COND_SLACK = 2.0
#: the kernels on the profile of a vision step worth naming: the depthwise
#: and grouped convs
VISION_TAGS = ("depthwise", "group")
GPT_CLIP = 1.0
#: clip_global_norm against its plain version: the norm, the scaled
#: gradients and the parameters after each step (relative)
CLIP_RTOL = 1e-6


def inventory(net):
    """(values with the running statistics, trainable tensors, running
    statistics, convs) of ``net``."""
    ps = list(_param_tensors(net).values())
    return (sum(p.numel() for p in ps), sum(p.requires_grad for p in ps),
            sum(not p.requires_grad for p in ps),
            sum(p.dim() == 4 for p in ps))


@contextlib.contextmanager
def no_dropout(*nets):
    """Every ``Dropout`` rate of ``nets`` at 0 inside the block (the rate
    is an attribute: no code changes), restored after."""
    from incubator_mxnet_tpu_torch.gluon.nn import Dropout

    drops = [m for net in nets for m in net.modules()
             if isinstance(m, Dropout)]
    rates = [m._rate for m in drops]
    try:
        for m in drops:
            m._rate = 0.0
        yield len(drops)
    finally:
        for m, r in zip(drops, rates):
            m._rate = r


def _leaves(net):
    return {n: m for n, m in net.named_modules() if not list(m.children())}


def train_grads(net, x, y, seen=None):
    """One training pass of ``net`` (record, mean softmax cross entropy,
    backward): the logits and the loss, and every trainable parameter's
    gradient by name (a copy, on its device). With ``seen`` (a dict) every
    leaf module's output of the pass lands in it by name."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon

    hooks = [] if seen is None else [
        m.register_forward_hook(
            lambda m, i, o, n=n: seen.__setitem__(n, o.detach()))
        for n, m in _leaves(net).items()]
    for p in net.parameters():
        p.grad = None
    try:
        with mx.autograd.record():
            logits = net(x)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(logits, y).mean()
        loss.backward()
    finally:
        for h in hooks:
            h.remove()
    grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()
             if p.requires_grad}
    for p in net.parameters():
        p.grad = None
    return logits.detach(), loss.detach(), grads


def replayed_grads(net64, x, y, seen):
    """The gradients of ``net64`` (an fp64 copy) at the fp32 pass whose
    leaf outputs are ``seen`` (``train_grads``): every leaf module's output
    replaced by the fp32 one in value, its fp64 graph kept, so each ReLU,
    clip and max pool decides on the fp32 values. The exact backward of
    that fp32 forward: it differs from the fp32 gradients only by the
    backward's rounding."""
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: o + (seen[n].to(o.dtype) - o).detach())
        for n, m in _leaves(net64).items()]
    try:
        return train_grads(net64, x.double(), y)[2]
    finally:
        for h in hooks:
            h.remove()


def _sibling(name):
    """The tensor whose gradient sets the scale of a BatchNorm's or a
    bias's: a beta's gamma, a gamma's beta, a bias's weight (None for a
    weight)."""
    stem, _, leaf = name.rpartition(".")
    sib = {"beta": "gamma", "gamma": "beta", "bias": "weight"}.get(leaf)
    return sib and f"{stem}.{sib}"


def hold_gradients(label, got, want, tol, replay, ref_replay):
    """Every gradient of ``got`` within ``tol`` (relative L2) of ``want``'s
    (by name; tensors or numpy). Past it, a gradient is held if each side
    is within ``tol`` of the exact backward of its own forward, ``got`` of
    ``replay()`` and ``want`` of ``ref_replay()`` (the port's fp64 model
    fed that side's every leaf output, ``replayed_grads``), on the scale of
    the larger of that exact gradient's norm and its sibling's
    (``_sibling``); else raise.

    Deep nets' fp32 forwards drift apart by 1e-5 relative, and an
    activation that close to a ReLU's or a clip's kink takes the other side
    in one of them: the gradients upstream of it then differ by percents
    between any two fp32 evaluations, each the exact backward of its own
    forward. ``want``'s side ties the rule to the reference: its gradient
    must be what the port's backward gives at its forward, so an error of
    the port's backward shared by its fp32 and fp64 graphs fails. The
    sibling's scale covers the shifts whose gradient is 0 in exact
    arithmetic (a bias or a beta that a training-mode BatchNorm takes out
    as a constant: both sides round noise) and the sums that cancel (the
    stem BatchNorm's gamma at 224x224 rounds 1e-2 from its exact value on
    any device): their rounding follows the terms of the sum, of the
    sibling's size.

    ``replay`` and ``ref_replay`` are called once each, and only when a
    gradient is past ``tol``. Returns ``(worst direct relative error and
    its name, {"replay": names held on their own scale, "sibling": names
    held on their sibling's})``."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: gradients of {sorted(got)[:4]}... "
                             f"against {sorted(want)[:4]}...")
    errs = {n: _rel_l2(got[n], want[n]) for n in want}
    past = sorted(n for n, e in errs.items() if not e <= tol)
    held = dict(replay=[], sibling=[])
    exact = (replay(), ref_replay()) if past else ()
    for n in past:
        sib = _sibling(n)
        dists = []
        for side, ex in zip((got, want), exact):
            g = _as_double(side[n])
            e = _as_double(ex[n], g.device)
            own = e.norm().item()
            scale = max(own, _l2(ex[sib]) if sib in ex else 0.0)
            dists.append(((g - e).norm().item(), scale, own))
        if not all(d <= tol * s for d, s, _ in dists):
            raise AssertionError(
                f"{label}: gradient {n} relative L2 error {errs[n]} against "
                "the reference; from the exact backward of its own forward "
                f"{dists[0][0] / dists[0][1]}, the reference's "
                f"{dists[1][0] / dists[1][1]}, of the larger of its norm "
                f"and {sib}'s (tolerance {tol})")
        held["sibling" if any(s > o for _, s, o in dists)
             else "replay"].append(n)
    worst = max(((e, n) for n, e in errs.items() if n not in past),
                default=(0.0, ""))
    return worst, held


def vision_net(name, ctx, hw, classes, params=None, init="xavier"):
    """``get_model(name, classes=classes)`` on ``ctx``: ``params`` (name
    -> array, every shape given) carried in; without them drawn by
    ``init`` from the package's seed, the deferred shapes filled by one
    forward at ``hw``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import (get_model,
                                                           load_jax_params)

    net = get_model(name, classes=classes)
    if params is not None:
        return load_jax_params(net, params, ctx=ctx)
    net.initialize(init, ctx=ctx)
    with mx.autograd.pause(), torch.no_grad():
        net(torch.zeros(1, 3, hw, hw, device=ctx.torch_device()))
    return net


def net_values(net):
    return {n: p.detach().cpu().numpy() for n, p in
            _param_tensors(net).items()}


def vision_parity(label, name, net, hw, classes, x, y, ctx):
    """``net`` (``name`` on ``ctx``) against a copy on the port's CPU path
    with the same values: eval logits within ``VISION_EVAL_RTOL`` (relative
    L2), then a training pass with every Dropout rate at 0: the training
    logits within ``VISION_EVAL_RTOL`` (or, a deep net's training-mode
    forward amplifying its rounding, no farther from the fp64 model's than
    ``COND_SLACK`` times the copy's distance from its own fp64 model's, the
    two fp64 models' within ``VISION_EVAL_RTOL``), every gradient
    held by ``hold_gradients`` at ``GRAD_RTOL``, the exact backward of
    either side's forward from the fp64 model on ``ctx``: the copy's
    gradients ask the card's backward, in fp64, to give them at the copy's
    forward. Returns the distances."""
    import incubator_mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    values = net_values(net)
    ref = vision_net(name, mx.cpu(), hw, classes, values)
    xc, yc = x.cpu(), y.cpu()
    with mx.autograd.pause():
        eval_err = _rel_l2(net(x), ref(xc))
    seen, ref_seen = {}, {}
    with no_dropout(net, ref) as drops:
        logits, loss, got = train_grads(net, x, y, seen)
        ref_logits, ref_loss, want = train_grads(ref, xc, yc, ref_seen)
    train_err = _rel_l2(logits, ref_logits)
    del ref
    cache = {}

    def net64():
        if "net" not in cache:
            cache["net"] = vision_net(name, ctx, hw, classes, values).cast(
                "float64")
        return cache["net"]

    def replay_of(leaf_outputs):
        def run():
            with no_dropout(net64()):
                return replayed_grads(net64(), x, y, leaf_outputs())
        return run

    worst, held = hold_gradients(
        label, got, want, GRAD_RTOL, replay_of(lambda: seen),
        replay_of(lambda: {n: v.to(x.device) for n, v in ref_seen.items()}))
    train_f64 = None
    if not train_err <= VISION_EVAL_RTOL:
        ref64 = vision_net(name, mx.cpu(), hw, classes, values).cast(
            "float64")
        with no_dropout(net64(), ref64), mx.autograd.pause(True), \
                torch.no_grad():
            f64, ref_f64 = net64()(x.double()), ref64(xc.double())
        train_f64 = (_rel_l2(logits, f64), _rel_l2(ref_logits, ref_f64),
                     _rel_l2(f64, ref_f64))
    cache.clear()
    if not (eval_err <= VISION_EVAL_RTOL and math.isfinite(float(loss))
            and (train_f64 is None
                 or (train_f64[0] <= COND_SLACK * train_f64[1]
                     and train_f64[2] <= VISION_EVAL_RTOL))):
        raise AssertionError(f"{label}: eval logits {eval_err}, training "
                             f"logits {train_err} from the CPU copy's "
                             f"(tolerance {VISION_EVAL_RTOL}); the card's "
                             "from its fp64 model's, the copy's from its "
                             "own, and the two fp64 models' apart: "
                             f"{train_f64}")
    return dict(eval_err=eval_err, train_err=train_err, train_f64=train_f64,
                grad_worst=worst[0], grad_worst_name=worst[1],
                n_grads=len(got), dropouts=drops,
                held={k: len(v) for k, v in held.items()},
                held_names={k: v[:4] for k, v in held.items() if v},
                seconds=time.perf_counter() - t0)


def vision_batches(seed, hw, classes, dev, batches=VISION_BATCHES):
    """The vision phase's batches of a model, one of each size in
    ``batches`` (images in [0, 1), labels as floats), drawn on ``dev``
    from ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 97)
    return [(torch.rand((b, 3, hw, hw), generator=gen, device=dev),
             torch.randint(0, classes, (b,), generator=gen,
                           device=dev).float()) for b in batches]


def vision_step(net, x, y, ctx, lr):
    """A training step of the learning check on the batch ``x``, ``y``
    (numpy): ``gluon.utils.split_and_load`` onto ``ctx``, the mean softmax
    cross entropy, ``gluon.utils.clip_global_norm(grads, VISION_CLIP)``,
    then ``gluon.Trainer(..., "sgd", momentum 0.9, kvstore="device")``'s
    step. Returns the step (which returns the loss) and the list it
    appends each norm to."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon

    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr, "momentum": 0.9},
                            kvstore="device")
    trainable = [p for p in net.parameters() if p.requires_grad]
    norms = []

    def step():
        data = gluon.utils.split_and_load(x, [ctx])[0]
        label = gluon.utils.split_and_load(y, [ctx])[0]
        with mx.autograd.record():
            loss = ce(net(data), label).mean()
        loss.backward()
        norms.append(gluon.utils.clip_global_norm(
            [p.grad for p in trainable], VISION_CLIP))
        trainer.step(1)
        return loss

    return step, norms


def vision_model_phase(seed, card, name, ctx, hw, pinned, classes=1000,
                       batches=VISION_BATCHES, steps=VISION_STEPS):
    """One model of the vision phase at ``hw``: its inventory against
    ``pinned``, ``vision_parity`` at B=``batches[0]``, the learning check
    (fp32 ``gluon.Trainer`` sgd, momentum 0.9, ``kvstore="device"``, on one
    batch of ``batches[1]`` repeated: each step loads it with
    ``gluon.utils.split_and_load`` and clips with
    ``gluon.utils.clip_global_norm(grads, VISION_CLIP)`` before
    ``trainer.step``; the loss falls by 5% over ``steps`` steps), then the
    step timed (host ms, median of 5 after 2 warm-ups), its peak memory and
    a ``torch.profiler`` breakdown."""
    import incubator_mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    dev = ctx.torch_device()
    mx.random.seed(seed)
    net = vision_net(name, ctx, hw, classes)
    counts = inventory(net)
    print(f"model {name} ({hw}x{hw}, NCHW): {counts[0]} parameters with the "
          f"running statistics, {counts[1]} trainable tensors, {counts[2]} "
          f"running statistics, {counts[3]} convs", flush=True)
    if pinned is not None and counts != tuple(pinned):
        raise AssertionError(f"{name}'s inventory {counts}, the JAX "
                             f"package's {pinned}")
    (xp, yp), (x, y) = vision_batches(seed, hw, classes, dev, batches)
    parity = vision_parity(name, name, net, hw, classes, xp, yp, ctx)
    print(f"{name} on the card vs the CPU (fp32, B={batches[0]}, same "
          f"values): eval logits {parity['eval_err']:.3e}, training logits "
          f"{parity['train_err']:.3e} relative L2 (tol "
          f"{VISION_EVAL_RTOL:g}); worst direct gradient "
          f"{parity['grad_worst']:.3e} ({parity['grad_worst_name']}) of "
          f"{parity['n_grads']}, tol {GRAD_RTOL:g}; held past it: "
          f"{parity['held']} {parity['held_names']}; "
          f"{parity['seconds']:.1f} s", flush=True)
    gc.collect()

    lr = VISION_LR.get(name, VISION_LR_DEFAULT)
    step, norms = vision_step(net, x.cpu().numpy(), y.cpu().numpy(), ctx,
                              lr)
    losses = [float(step().asscalar()) for _ in range(steps)]
    print(f"{name} learning check (fp32 gluon.Trainer kvstore='device', "
          f"B={batches[1]}, sgd lr {lr:g} momentum 0.9, clip_global_norm "
          f"{VISION_CLIP:g}, one batch repeated): losses "
          f"{[round(v, 4) for v in losses]}, gradient norms "
          f"{[round(v, 3) for v in norms]}", flush=True)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < 0.95 * losses[0]:
        raise AssertionError(f"{name}: the loss did not fall by 5% over "
                             f"{steps} steps")
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    step_ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_step(lambda *_: step(), None, None, card, step_ms,
                         tags=VISION_TAGS, top=8,
                         what=f"fp32 {name} step (B={batches[1]})")
    device_ms = sum(r[0] for r in prof)
    row = dict(batch=batches[1], lr=lr, step_ms=step_ms,
               images_s=batches[1] / step_ms * 1e3, peak_bytes=peak,
               device_ms=device_ms, idle=_idle(prof, step_ms),
               launches=sum(r[1] for r in prof), losses=losses,
               top=[(round(ms, 4), n, k[:80]) for ms, n, k in prof[:5]],
               depthwise_ms=sum(r[0] for r in prof
                                if any(t in r[2] for t in VISION_TAGS)),
               inventory=counts, parity=parity,
               seconds=time.perf_counter() - t0)
    print(f"{name} fp32 step (B={batches[1]}; {card}): {step_ms:.3f} ms "
          f"(host clock, median of 5 after 2 warm-ups), "
          f"{row['images_s']:.1f} images/s, device {device_ms:.3f} ms, "
          f"idle {100 * (row['idle'] or 0):.1f}%, peak memory "
          f"{peak / 2**20:.1f} MiB; {row['seconds']:.1f} s", flush=True)
    del step, net
    gc.collect()
    return row


def plain_clip(arrays, max_norm):
    """The reference's ``clip_global_norm`` loop in plain PyTorch: one
    host float an array, then each scaled."""
    total = sum(float((a * a).sum()) for a in arrays)
    norm = math.sqrt(total)
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a.mul_(scale)
    return norm


def _syncs_of(fn, *args):
    """``fn(*args)`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result, the file and line of each synchronizing read it made, and the
    other warnings."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            if torch.cuda.is_available():
                torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice when it is first switched on is no read
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    return out, [f"{Path(w.filename).name}:{w.lineno}" for w in syncs], [
        str(w.message) for w in caught if w not in syncs]


def clip_checks(grads, syncs):
    """``gluon.utils.clip_global_norm`` on copies of ``grads``: at half
    their norm every array scaled as the plain version scales it (fp64
    norm; ``CLIP_RTOL``) in ``syncs`` synchronizing reads; a NaN in one
    warns and scales nothing, an inf warns and scales by 0 (inf * 0 is
    NaN), as the reference; a norm at or under ``max_norm`` leaves the
    arrays as they were. Returns the scaled arrays' worst distance."""
    from incubator_mxnet_tpu_torch import gluon

    arrays = [g.clone() for g in grads]
    want = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    norm, reads, _ = _syncs_of(gluon.utils.clip_global_norm, arrays,
                               0.5 * want)
    scale = 0.5 * want / (want + 1e-8)
    worst = max(_rel_l2(a, g * scale) for a, g in zip(arrays, grads))
    if not (abs(norm - want) <= CLIP_RTOL * want and worst <= CLIP_RTOL
            and len(reads) == syncs):
        raise AssertionError(f"clip_global_norm at half the norm: {norm} "
                             f"against {want}, arrays {worst} from the plain "
                             f"scaling, synchronizing reads at {reads}")

    for bad in (math.nan, math.inf):
        arrays = [g.clone() for g in grads]
        arrays[0].view(-1)[0] = bad
        before = [a.clone() for a in arrays]
        norm, _, warned = _syncs_of(gluon.utils.clip_global_norm, arrays,
                                    GPT_CLIP)
        if not any("nan or inf in clip_global_norm" in w for w in warned) \
                or math.isfinite(norm):
            raise AssertionError(f"clip_global_norm with a {bad}: norm "
                                 f"{norm}, warnings {warned}")
        want = before if math.isnan(bad) else [b * 0.0 for b in before]
        for a, w in zip(arrays, want):
            if not torch.equal(a.isnan(), w.isnan()) or not torch.equal(
                    a.nan_to_num(), w.nan_to_num()):
                raise AssertionError(f"clip_global_norm with a {bad}: the "
                                     "arrays differ from the reference's "
                                     "scaling")
    arrays = [g.clone() for g in grads]
    gluon.utils.clip_global_norm(arrays, 1e30)
    if not all(torch.equal(a, g) for a, g in zip(arrays, grads)):
        raise AssertionError("clip_global_norm scaled under max_norm")
    return worst


def gpt_clip_phase(seed, card, net, ctx, b=8, steps=3, lr=3e-4, reps=5):
    """gluon.utils on ``net`` (``gpt_decoder_117m``, fp32, dropout 0, the
    "pallas" attention: K4-K6) at B=``b``, T=its ``max_length``: ``steps``
    ``gluon.Trainer`` adam steps, each batch loaded with ``split_and_load``
    and every gradient clipped with ``clip_global_norm(max_norm=GPT_CLIP)``
    before ``trainer.step``, beside a copy of the net whose trainer steps
    on the same gradients clipped by the plain version (their fp64 norm,
    taken before the call). Each call: the norm within ``CLIP_RTOL`` of the
    fp64 one, every gradient within ``CLIP_RTOL`` of the plain scaling,
    exactly one synchronizing read (``set_sync_debug_mode("warn")``), and
    the parameters after each step within ``CLIP_RTOL`` of the copy's;
    ``clip_checks`` (NaN, inf, no scaling); K4, K5 and K6 12 times a pass
    on f32; the call's device ms beside ``plain_clip``'s."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    t, vocab = net.max_length, net.vocab_size
    layers = net.num_layers
    plain_net = copy.deepcopy(net)
    rs = np.random.RandomState(seed + 23)
    tokens = rs.randint(0, vocab, (b, t)).astype(np.int32)
    labels = rs.randint(0, vocab, (b * t,)).astype(np.float32)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainers = [gluon.Trainer(n.collect_params(), "adam",
                              {"learning_rate": lr})
                for n in (net, plain_net)]
    params = [p for p in net.parameters() if p.requires_grad]
    plain_params = [p for p in plain_net.parameters() if p.requires_grad]
    rows = []
    torch.cuda.synchronize()
    _reset_launches(fa)
    for _ in range(steps):
        data = gluon.utils.split_and_load(tokens, [ctx])[0]
        label = gluon.utils.split_and_load(labels, [ctx])[0]
        with mx.autograd.record():
            loss = ce(net(data).reshape((-1, vocab)), label).mean()
        loss.backward()
        grads = [p.grad for p in params]
        raw = [g.clone() for g in grads]
        want = math.sqrt(sum(float((g.double() ** 2).sum()) for g in raw))
        norm, reads, _ = _syncs_of(gluon.utils.clip_global_norm, grads,
                                   GPT_CLIP)
        scale = GPT_CLIP / (want + 1e-8)
        plain = [g * scale for g in raw] if scale < 1.0 else raw
        grad_err = max(_rel_l2(g, w) for g, w in zip(grads, plain))
        for p, g in zip(plain_params, plain):
            p.grad = g
        for tr in trainers:
            tr.step(1)
        param_err = max(_rel_l2(p, q) for p, q in zip(params, plain_params))
        rows.append(dict(loss=float(loss.asscalar()), norm=norm,
                         plain_norm=want, scale=min(1.0, scale),
                         norm_err=abs(norm - want) / want, syncs=len(reads),
                         sync_sites=reads, grad_err=grad_err,
                         param_err=param_err))
        print(f"clipped GPT-117M step (fp32, B={b}, T={t}, "
              f"{len(grads)} gradients): loss {rows[-1]['loss']:.6f}; "
              f"clip_global_norm {norm:.6f} against the fp64 "
              f"{want:.6f} (relative {rows[-1]['norm_err']:.3e}), scale "
              f"{rows[-1]['scale']:.6f}, {len(reads)} synchronizing "
              f"read(s) {reads}; "
              f"gradients {grad_err:.3e} and parameters after the step "
              f"{param_err:.3e} from the plain version's (relative L2)",
              flush=True)
        # one read back on the card; the CPU has no stream to wait for
        if not (rows[-1]["norm_err"] <= CLIP_RTOL
                and len(reads) == (ctx.device_type == "gpu")
                and grad_err <= CLIP_RTOL and param_err <= CLIP_RTOL):
            raise AssertionError("clip_global_norm differs from its plain "
                                 f"version: {rows[-1]}")
    flash, routes = _read_launches(fa), _read_routes(fa)
    _check_flash_launches(f"the clipped GPT-117M steps' {steps} passes",
                          flash, routes, {k: layers * steps
                                          for k in COUNTERS},
                          training_routes(steps, 0, layers, t,
                                          net.head_dim))
    grads = [p.grad for p in params]
    half_err = clip_checks(grads, int(ctx.device_type == "gpu"))
    # each timed call halves its own copy of the gradients, so that every
    # call scales
    total = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    state = {fn: [[g.clone() for g in grads], total]
             for fn in (gluon.utils.clip_global_norm, plain_clip)}

    def halve(fn):
        arrays, norm = state[fn]
        state[fn][1] = 0.5 * fn(arrays, 0.5 * norm)

    def utility():
        halve(gluon.utils.clip_global_norm)

    def reference():
        halve(plain_clip)

    device = _kernel_rows(utility)[0]
    ref_rows = _kernel_rows(reference)[0]
    device_ms, ref_device_ms = (sum(r[0] for r in rs_) for rs_ in
                                (device, ref_rows))
    launches, ref_launches = (sum(r[1] for r in rs_) for rs_ in
                              (device, ref_rows))
    times = _median_turns({"utils": utility, "plain": reference}, reps)
    print(f"clip_global_norm over {len(grads)} gradients ({card}): "
          f"device {device_ms:.4f} ms in {launches} launches, host "
          f"{times['utils']:.3f} ms; the reference's loop of one host float "
          f"an array in plain PyTorch: device {ref_device_ms:.4f} ms in "
          f"{ref_launches} launches, host {times['plain']:.3f} ms (median "
          f"of {reps} alternating turns)", flush=True)
    del plain_net, trainers
    gc.collect()
    return dict(steps=rows, half_norm_err=half_err, flash_launches=flash,
                flash_routes=routes,
                n_grads=len(grads), device_ms=device_ms,
                plain_device_ms=ref_device_ms, launches=launches,
                plain_launches=ref_launches, host_ms=times["utils"],
                plain_host_ms=times["plain"],
                seconds=time.perf_counter() - t0)


#: every name of the reference's vision ``get_model`` at classes=10: the
#: image size and the batch (Inception takes 299x299, the size its closing
#: 8x8 pool needs)
VISION_CASES = [
    (name, 299 if name == "inceptionv3" else 64,
     1 if name == "inceptionv3" else 2)
    for name in (
        [f"resnet{d}_v{v}" for d in (18, 34, 50, 101, 152) for v in (1, 2)]
        + [f"vgg{d}{bn}" for d in (11, 13, 16, 19) for bn in ("", "_bn")]
        + ["alexnet"] + [f"densenet{d}" for d in (121, 161, 169, 201)]
        + ["squeezenet1.0", "squeezenet1.1", "inceptionv3"]
        + [f"mobilenet{m}" for m in ("1.0", "0.75", "0.5", "0.25")]
        + [f"mobilenetv2_{m}" for m in ("1.0", "0.75", "0.5", "0.25")]
        + ["mobilenetv3_large", "mobilenetv3_small"])]


def vision_cases_phase(mx, ctx, cases=VISION_CASES, seed=0):
    """Each case of ``cases`` at classes=10 on ``ctx`` against the port on
    the CPU, its values drawn on ``ctx`` from ``seed`` (weights N(0,
    0.1^2), gammas and running variances |N(0, 0.1^2)| + 0.5): the eval
    logits and a training pass with every Dropout rate at 0, held by
    ``vision_parity``. Returns the worst distances."""
    out = dict(cases=0, eval_worst=0.0, train_worst=0.0, grad_worst=0.0,
               held=dict(replay=0, sibling=0),
               seconds={})
    dev = ctx.torch_device()
    for i, (name, hw, b) in enumerate(cases):
        t0 = time.perf_counter()
        net = vision_net(name, ctx, hw, 10, init="zeros")
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + i)
        with torch.no_grad():
            for n, p in _param_tensors(net).items():
                v = torch.randn(p.shape, generator=gen, device=dev) * 0.1
                p.copy_(v.abs() + 0.5 if n.endswith(("running_var", "gamma"))
                        else v)
        x = torch.rand((b, 3, hw, hw), generator=gen, device=dev)
        y = torch.randint(0, 10, (b,), generator=gen, device=dev).float()
        res = vision_parity(f"vision case {name}", name, net, hw, 10, x, y,
                            ctx)
        del net
        out["cases"] += 1
        out["eval_worst"] = max(out["eval_worst"], res["eval_err"])
        out["train_worst"] = max(out["train_worst"], res["train_err"])
        out["grad_worst"] = max(out["grad_worst"], res["grad_worst"])
        for k, v in res["held"].items():
            out["held"][k] += v
        out["seconds"][name] = round(time.perf_counter() - t0, 2)
    print(f"slice 22 on {ctx} vs the CPU, vision: {out['cases']} models "
          f"equal (eval logits within {out['eval_worst']:.3e}, training "
          f"logits {out['train_worst']:.3e}, gradients within "
          f"{out['grad_worst']:.3e} directly; held past GRAD_RTOL: "
          f"{out['held']}); seconds by model {out['seconds']}", flush=True)
    return out


def _utils_split(mx, ctx):
    from incubator_mxnet_tpu_torch.gluon import utils

    x = _nd_rand(210, 10, 3)
    even = utils.split_data(mx.nd.array(x, ctx=ctx), 5)
    rest = utils.split_data(mx.nd.array(x, ctx=ctx), 4, even_split=False)
    if any(s.as_torch().device != ctx.torch_device() for s in even + rest):
        raise AssertionError("split_data: a slice left the operand's device")
    try:
        utils.split_data(mx.nd.array(x, ctx=ctx), 3)
    except ValueError as e:
        if str(e) != "batch size 10 not divisible by num_slice 3":
            raise
    else:
        raise AssertionError("split_data: no ValueError for 10 into 3")
    return [s.asnumpy() for s in even + rest]


def _utils_load(mx, ctx):
    from incubator_mxnet_tpu_torch.gluon import utils

    x = _nd_rand(211, 6, 4)
    out = []
    for src in (x, mx.nd.array(x, ctx=ctx),
                torch.from_numpy(x).to(ctx.torch_device())):
        for ctxs in ([ctx], [ctx, ctx], [ctx] * 3):
            parts = utils.split_and_load(src, ctxs)
            if any(p.ctx != ctx for p in parts):
                raise AssertionError("split_and_load: a slice off its "
                                     "context")
            out += [p.asnumpy() for p in parts]
    return out


def _utils_clip(max_norm, bad=None):
    def fn(mx, ctx):
        from incubator_mxnet_tpu_torch.gluon import utils

        arrays = [torch.from_numpy(_nd_rand(212 + i, *s)).to(
            ctx.torch_device()) for i, s in enumerate(((3, 4), (7,),
                                                       (2, 3, 5)))]
        if bad is not None:
            arrays[1][2] = bad
        norm, _, warned = _syncs_of(utils.clip_global_norm, arrays,
                                    max_norm)
        if (bad is not None) != any("nan or inf" in w for w in warned):
            raise AssertionError(f"clip_global_norm warned {warned}")
        return [np.array([norm])] + [a.cpu().numpy() for a in arrays]

    return fn


def _utils_files(mx, ctx):
    import hashlib
    import tempfile

    from incubator_mxnet_tpu_torch.gluon import utils

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "weights.params"
        path.write_bytes(bytes(range(256)) * 300)
        digest = hashlib.sha1(path.read_bytes()).hexdigest()
        url = "https://example.com/weights.params"
        ok = [utils.check_sha1(str(path), digest),
              not utils.check_sha1(str(path), "0" * 40),
              utils.download(url, path=d) == str(path),
              utils.download(url, path=str(path), sha1_hash=digest)
              == str(path)]
        for kw in (dict(path=str(path), overwrite=True),
                   dict(path=str(Path(d) / "missing"))):
            try:
                utils.download(url, **kw)
                ok.append(False)
            except RuntimeError as e:
                ok.append("no network egress" in str(e))
    if not all(ok):
        raise AssertionError(f"check_sha1/download: {ok}")
    return [np.array(ok)]


UTILS_CASES = [
    FnCase("utils", "split_data", _utils_split),
    FnCase("utils", "split_and_load", _utils_load),
    FnCase("utils", "clip_global_norm_scales", _utils_clip(0.5)),
    FnCase("utils", "clip_global_norm_under", _utils_clip(100.0)),
    FnCase("utils", "clip_global_norm_nan", _utils_clip(1.0, math.nan)),
    FnCase("utils", "clip_global_norm_inf", _utils_clip(1.0, math.inf)),
    FnCase("utils", "check_sha1_download", _utils_files, exact=True),
]


def _concurrent_case(axis):
    def fn(mx, ctx):
        from incubator_mxnet_tpu_torch.gluon import contrib, nn

        net = contrib.nn.HybridConcurrent(axis=axis)
        inner = nn.HybridSequential()
        inner.add(nn.Conv2D(5, 1), nn.Activation("relu"))
        nested = contrib.nn.Concurrent(axis=axis)
        nested.add(nn.Conv2D(5, 1, in_channels=5),
                   nn.BatchNorm(in_channels=5))
        net.add(nn.Conv2D(5, 3, padding=1), inner, nested)
        return _block_case(mx, ctx, net, (2, 5, 4, 4), 220)

    return fn


def _block_case(mx, ctx, net, shape, seed):
    """``net``'s output, input gradient and parameter gradients of
    ``sum(out * g)`` in training mode, its values drawn from ``seed``
    after a first forward, and its running statistics after the pass."""
    net.initialize(ctx=ctx)
    x = mx.nd.array(_nd_rand(seed, *shape), ctx=ctx)
    with torch.no_grad():
        net(x)
    named = list(net.named_parameters())
    with torch.no_grad():
        for i, (n, p) in enumerate(named):
            v = _nd_rand(seed + 1 + i, *p.shape)
            p.copy_(torch.from_numpy(np.abs(v) + 0.5 if n.endswith(
                ("gamma", "running_var")) else v))
    x.attach_grad()
    with mx.autograd.record():
        out = net(x)
        head = (out * mx.nd.array(_nd_rand(seed + 50, *out.shape),
                                  ctx=ctx)).sum()
    head.backward()
    return [out.asnumpy(), x.grad.asnumpy()] + [
        p.grad.cpu().numpy() if p.requires_grad else p.detach().cpu().numpy()
        for _, p in named]


def _sync_bn_case(mx, ctx):
    from incubator_mxnet_tpu_torch.gluon import contrib, nn

    got = _block_case(mx, ctx, contrib.nn.SyncBatchNorm(num_devices=4,
                                                        momentum=0.8),
                      (4, 3, 5, 5), 230)
    want = _block_case(mx, ctx, nn.BatchNorm(momentum=0.8), (4, 3, 5, 5),
                       230)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


CONTRIB_CASES = [
    FnCase("contrib", "HybridConcurrent_axis1", _concurrent_case(1),
           ND_LOOSE),
    FnCase("contrib", "HybridConcurrent_axis-1", _concurrent_case(-1),
           ND_LOOSE),
    FnCase("contrib", "SyncBatchNorm", _sync_bn_case, ND_LOOSE),
]


def vision_phase(seed, card, ctx, models=None, gpt=None, cases=None,
                 batches=VISION_BATCHES, gpt_b=8):
    """The vision phase: ``vision_model_phase`` on each of ``models``
    (name -> (image size, pinned inventory); ``VISION_MODELS``), then
    ``gpt_clip_phase`` on ``gpt`` (a GPT decoder), then the cases of
    ``cases`` (default ``VISION_CASES``, ``UTILS_CASES`` and
    ``CONTRIB_CASES``: vision by ``vision_cases_phase``, the others by
    ``_check_cases``) on ``ctx`` against the CPU."""
    import incubator_mxnet_tpu_torch as mx

    t0 = time.perf_counter()
    rows = {}
    for name, (hw, pinned) in (models or VISION_MODELS).items():
        rows[name] = vision_model_phase(seed, card, name, ctx, hw, pinned,
                                        batches=batches)
        gc.collect()
    clip = gpt_clip_phase(seed, card, gpt, ctx, b=gpt_b) \
        if gpt is not None else None
    gc.collect()
    vision_cases, fn_cases = cases if cases is not None else (
        VISION_CASES, UTILS_CASES + CONTRIB_CASES)
    vision = vision_cases_phase(mx, ctx, vision_cases, seed)
    families = _check_cases(mx, ctx, fn_cases, run_fn_case, check_fn_case)
    for name, fam in families.items():
        print(f"slice 22 on {ctx} vs the CPU, {name}: {fam['cases']} cases "
              f"equal (largest float difference {fam['worst']:.3e})",
              flush=True)
    seconds = time.perf_counter() - t0
    print(f"vision phase: {seconds:.1f} s", flush=True)
    return dict(models=rows, clip=clip, vision_cases=vision,
                families=families, seconds=seconds)


def vision_main(seed, card):
    """The vision phase on the eight ``VISION_MODELS`` at classes=1000 and
    ``gpt_decoder_117m`` at ``max_length`` 256 (fp32, dropout 0)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    gpt = get_gpt("gpt_decoder_117m", vocab_size=50257, dropout=0.0,
                  max_length=256).initialize("xavier", ctx=ctx)
    return vision_phase(seed, card, ctx, gpt=gpt)


def _entry(name, source, replaces, launches, cases, head_case,
           dtype="fp32"):
    """A kernel's record: its numbers at ``head_case`` in ``dtype``, and
    (an fp32 head) the bf16 head case's under ``"bf16"``."""
    def head_of(dt):
        return next((r for r in cases if r["case"] == head_case
                     and r["dtype"] == dt), None)

    head = head_of(dtype)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in cases
                                if r["dtype"] == dtype),
             "ms": head["ms"], "plain_ms": head["plain_ms"],
             "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
             "library_ms": head["library_ms"], "shape": head_case,
             "dtype": dtype, "cases": cases}
    bf16 = head_of("bf16") if dtype == "fp32" else None
    if bf16 is not None:
        entry["bf16"] = {k: bf16[k] for k in ("ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")}
    return entry


# the bf16 conv and flash kernels, which must run on the tensor cores and
# load through TMA, and their sources
TC_KERNELS = ("fused_conv_tc_kernel", "conv_bwd_dx_tc_kernel",
              "conv_bwd_dw_tc_kernel", "flash_fwd_tc_kernel",
              "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")
TC_SOURCES = ("fused_conv_tc", "conv_bwd_tc", "flash_fwd_tc",
              "flash_bwd_tc")
# the fp32 kernels on the FP32 pipes (no HGMMA, tiles by TMA), with their
# instantiations: the flash backward and forward (D 64 and 128), the conv
# forward, input gradient and weight gradient (one tap or a row of 3 taps
# a block); their sources
F32_KERNELS = {"flash_bwd_dq_f32_kernel": 2, "flash_bwd_dkv_f32_kernel": 2,
               "flash_fwd_f32_kernel": 2, "fused_conv_f32_kernel": 1,
               "conv_bwd_dx_f32_kernel": 1, "conv_bwd_dw_f32_kernel": 2}
F32_SOURCES = ("flash_bwd_f32", "flash_fwd_f32", "fused_conv_f32",
               "conv_bwd_f32")


def kernel_sass():
    """``tools/torch_ptxas_report.py fused_conv_tc conv_bwd_tc flash_fwd_tc
    flash_bwd_tc flash_bwd_f32 flash_fwd_f32 fused_conv_f32 conv_bwd_f32``,
    printed:
    registers, spills, and the HGMMA (wgmma) and UTMALDG (TMA)
    instructions in each kernel's SASS; raises unless every tensor-core
    instantiation has both, every instantiation of the fp32 kernels
    (``F32_KERNELS``, as many instantiations as it names) has UTMALDG and no
    HGMMA, and none spills."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "tools"
                             / "torch_ptxas_report.py"), *TC_SOURCES,
         *F32_SOURCES],
        capture_output=True, text=True, timeout=300, check=True).stdout
    print(out.rstrip(), flush=True)
    rows = [ln for ln in out.splitlines()
            if any(k in ln for k in TC_KERNELS) and "Used" in ln]
    if {k for k in TC_KERNELS if any(k in ln for ln in rows)} \
            != set(TC_KERNELS) or any(" HGMMA 0" in ln or "UTMALDG 0" in ln
                                      or "SASS" not in ln for ln in rows):
        raise AssertionError("a tensor-core kernel without HGMMA or "
                             "UTMALDG in its SASS")
    f32 = [ln for ln in out.splitlines()
           if any(k in ln for k in F32_KERNELS) and "Used" in ln]
    if len(f32) != sum(F32_KERNELS.values()) \
            or {k for k in F32_KERNELS if any(k in ln for ln in f32)} \
            != set(F32_KERNELS) \
            or any(" HGMMA 0," not in ln or "UTMALDG 0" in ln for ln in f32):
        raise AssertionError(f"the fp32 kernels' SASS: {f32}")
    spills = [ln for ln in out.splitlines()
              if any(k in ln for k in TC_KERNELS + tuple(F32_KERNELS))
              and "spill" in ln
              and not re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", ln)]
    if spills:
        raise AssertionError(f"kernels spill: {spills}")
    print(f"SASS: {len(rows)} tensor-core kernels with HGMMA and UTMALDG, "
          f"{len(f32)} fp32 kernels on the FP32 pipes with UTMALDG, no spills "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


# ---------------------------------------------------------------------------
# hybrid phase: hybridize (CachedOp on CUDA graphs), export, SymbolBlock,
# ModelServer.from_exported and the control-flow ops
# ---------------------------------------------------------------------------
#: a hybridized pass against the eager pass of the same net (relative L2 of
#: the logits, of each gradient): a replay runs the kernels the eager call
#: launched, on the same inputs, so bit-equality is what is expected; the
#: bound only leaves room for a library (cuBLAS) that picks another
#: algorithm on the capture's side stream
HYBRID_RTOL = {"fp32": 1e-6, "bf16": 1e-3}
#: an exported graph run again by a SymbolBlock against the block (the same
#: registered ops on the same inputs)
EXPORT_RTOL = 1e-6
#: a served row (its bucket's batch) against the row of ``net(x)`` over
#: all the requests at once: another batch size may take another cuDNN
#: algorithm, whose fp32 sums round differently
SERVE_RTOL = 1e-4
#: the control-flow constructs against their unrolled forms: the same ops
CONTROL_RTOL = 1e-6


def _graph_device_ms(step_graph, iters=20):
    """Device ms a replay of a captured graph (CUDA events around
    ``iters`` back-to-back replays)."""
    step_graph.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step_graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_block(gluon, nn, units, heads):
    """A QKV ``Dense`` split into heads and ``mx.nd.flash_attention``
    (the GPT's attention, as a user writes it with ``hybrid_forward``)."""

    class Attention(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="attention_")
            with self.name_scope():
                self.qkv = nn.Dense(3 * units, flatten=False, in_units=units)

        def hybrid_forward(self, F, x):
            b, t, _ = x.shape
            d = units // heads
            qkv = self.qkv(x).reshape(b, t, 3, heads, d)
            q, k, v = [qkv.slice_axis(axis=2, begin=i, end=i + 1)
                       .reshape(b, t, heads, d).transpose((0, 2, 1, 3))
                       for i in range(3)]
            o = F.flash_attention(q, k, v, causal=True)
            return o.transpose((0, 2, 1, 3)).reshape(b, t, units)

    return Attention()


def _hold(label, got, want, rtol):
    """``got`` within ``rtol`` (relative L2) of ``want``; returns the
    error and whether the two are bit-equal."""
    got = got._data if hasattr(got, "_data") else got
    want = want._data if hasattr(want, "_data") else want
    err = _rel_l2(got, want)
    same = bool(torch.equal(got, want))
    if not (err <= rtol) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: relative L2 {err:.3e} > {rtol}")
    return err, same


def hybrid_gpt_part(seed, card, net, ctx, dtype, b, t, steps=1, lr=1e-4,
                    timed=True):
    """``net`` (a GPT, dropout 0) hybridized in ``dtype``: the inference
    forward captured once and replayed, against the eager forward of the
    same net (``HYBRID_RTOL``), K4's launches of a replay equal to an eager
    call's, route by route; the recorded step (forward and backward
    captured as a pair of graphs) with every gradient against the eager
    step's; in fp32 ``steps`` ``gluon.Trainer`` adam steps over
    ``net.collect_params()`` (the ParameterDict), after which the replay of
    the forward captured before them equals the eager forward of the
    updated weights (the graphs read the parameters in place). On the CPU
    the hybridized block runs eagerly and captures nothing."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.gluon import block as gblock
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    on_card = ctx.device_type == "gpu"
    name = DTYPE_NAMES[dtype]
    rtol = HYBRID_RTOL[name]
    vocab, layers = net.vocab_size, net.num_layers
    rs = np.random.RandomState(seed + 29)
    x = mx.nd.array(rs.randint(0, vocab, (b, t)), ctx=ctx, dtype="int32")
    y = mx.nd.array(rs.randint(0, vocab, (b * t,)).astype(np.float32),
                    ctx=ctx)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    trainable = [(n, p) for n, p in net.named_parameters()
                 if p.requires_grad]

    def forward():
        with mx.autograd.pause():
            return net(x)

    def step():
        for _, p in trainable:
            p.grad = None
        with mx.autograd.record():
            loss = ce(net(x).reshape((-1, vocab)), y).mean()
        loss.backward()
        return loss, {n: p.grad.clone() for n, p in trainable}

    def launches_of(fn):
        _sync(ctx)
        _reset_launches(fa)
        out = fn()
        _sync(ctx)
        return out, _read_routes(fa)

    net.hybridize(False)
    eager, eager_routes = launches_of(forward)
    times = {}
    if timed:
        times["eager_call_ms"] = call_ms(forward, iters=10, warmup=2)
        times["eager_device_ms"] = device_ms(forward, per_graph=5,
                                             replays=4)
    net.hybridize()
    first, _ = launches_of(forward)            # the capture
    hybrid, replay_routes = launches_of(forward)
    cop = net._cached_op
    if on_card:
        if not (cop is not None and cop.captures == 1 and cop.replays == 2):
            raise AssertionError(f"GPT {name}: the forward was not one "
                                 f"capture replayed twice: {cop}")
        if replay_routes != eager_routes or eager_routes[
                "flash_fwd_" + fwd_route_expected(t, net.head_dim,
                                                  dtype)] != layers:
            raise AssertionError(f"GPT {name}: K4 by route on a replay "
                                 f"{replay_routes}, eager {eager_routes}")
    elif cop is not None:
        raise AssertionError("the CPU captured a graph")
    err, same = _hold(f"hybridized GPT {name} forward", hybrid, eager, rtol)
    _hold(f"hybridized GPT {name} capture call", first, eager, rtol)
    if timed and on_card:
        times["hybrid_call_ms"] = call_ms(forward, iters=10, warmup=2)
        times["hybrid_device_ms"] = _graph_device_ms(
            cop._graphs.graphs()[-1])
    print(f"hybridized GPT-117M forward ({name}, B={b}, T={t}, {card}): "
          f"captures {cop.captures if cop else 0}, replays "
          f"{cop.replays if cop else 0}; against eager: relative L2 "
          f"{err:.3e}, bit-equal {same}; K4 a replay {replay_routes} = "
          f"eager {eager_routes}; times {times}", flush=True)

    # the recorded step: forward and backward as a pair of graphs
    _, _ = step()                                 # the pair's capture
    (loss, grads), step_routes = launches_of(step)
    want_routes = training_routes(int(dtype == torch.float32),
                                  int(dtype == torch.bfloat16), layers, t,
                                  net.head_dim)
    if on_card and step_routes != want_routes:
        raise AssertionError(f"GPT {name} recorded step launched "
                             f"{step_routes}, not {want_routes}")
    pairs = sum(len(v) for v in cop._pairs.values()) if cop else 0
    net.hybridize(False)
    eager_loss, eager_grads = step()
    worst, equal = 0.0, 0
    for n, g in grads.items():
        e, s = _hold(f"hybridized GPT {name} gradient {n}", g,
                     eager_grads[n], rtol)
        worst, equal = max(worst, e), equal + s
    _hold(f"hybridized GPT {name} loss", loss.reshape(1),
          eager_loss.reshape(1), rtol)
    print(f"hybridized GPT-117M recorded step ({name}): loss "
          f"{float(loss.asscalar()):.6f} (eager "
          f"{float(eager_loss.asscalar()):.6f}); {len(grads)} gradients, "
          f"worst relative L2 {worst:.3e}, {equal} bit-equal; "
          f"{pairs} pair(s) of graphs; launches {step_routes}", flush=True)
    out = dict(dtype=name, captures=cop.captures if cop else 0,
               replays=cop.replays if cop else 0, pairs=pairs,
               forward_err=err, forward_bit_equal=same, grad_worst=worst,
               grads_bit_equal=equal, n_grads=len(grads),
               eager_routes=eager_routes, replay_routes=replay_routes,
               step_routes=step_routes, **times)
    if dtype != torch.float32:
        return out
    # a Trainer over the ParameterDict; the forward graph captured before
    # its steps reads the updated weights in place
    net.hybridize()
    forward()                                     # capture
    tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": lr})
    losses = []
    for _ in range(steps):
        loss, _ = step()
        tr.step(1)
        losses.append(float(loss.asscalar()))
    before = gblock.cached_op_counts["captures"]
    after = forward()
    recaptured = gblock.cached_op_counts["captures"] - before
    if on_card and recaptured:
        raise AssertionError("the trainer's in-place update made the "
                             "forward capture again")
    net.hybridize(False)
    err_after, same_after = _hold("hybridized GPT forward after the "
                                  "trainer's steps", after, forward(), rtol)
    print(f"gluon.Trainer(net.collect_params(), 'adam') over the "
          f"ParameterDict ({len(tr._params)} parameters): {steps} step(s), "
          f"losses {losses}; the replay after it against eager: relative "
          f"L2 {err_after:.3e}, bit-equal {same_after}", flush=True)
    out.update(trainer_losses=losses, after_err=err_after,
               after_bit_equal=same_after, trainer_params=len(tr._params))
    return out


def export_resnet_part(seed, card, net, ctx, hw, b, buckets, requests,
                       threads, train_steps=3):
    """``net`` (the zoo ``resnet50_v1``, fp32, drawn): ``train_steps`` SGD
    steps move its running statistics; ``export`` then
    ``SymbolBlock.imports`` on ``ctx``: the logits against the block's
    (``EXPORT_RTOL``), the 106 statistics imported as auxiliary states;
    ``export_for_serving(buckets)`` and ``ModelServer.from_exported``:
    ``requests`` rows from ``threads`` threads, each against the row of
    ``net(x)`` (``SERVE_RTOL``), one graph a bucket on the card."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.serving import ModelServer

    on_card = ctx.device_type == "gpu"
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed + 31)
    x = mx.nd.array(rs.rand(b, 3, hw, hw).astype(np.float32), ctx=ctx)
    y = mx.nd.array(rs.randint(0, 10, (b,)).astype(np.float32), ctx=ctx)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01})
    stats = [p for n, p in net.named_parameters() if "running" in n]
    before = [s.detach().clone() for s in stats]
    for _ in range(train_steps):
        with mx.autograd.record():
            loss = ce(net(x), y).mean()
        loss.backward()
        tr.step(b)
    moved = sum(not torch.equal(s, p) for s, p in zip(stats, before))
    if moved != len(stats):
        raise AssertionError(f"{len(stats) - moved} running statistics "
                             "did not move")
    with mx.autograd.pause():
        want = net(x)
    with tempfile.TemporaryDirectory(prefix="mxtpu_export_") as d:
        sj, pp = net.export(os.path.join(d, "resnet50"))
        blk = gluon.SymbolBlock.imports(sj, "data", pp, ctx=ctx)
        with mx.autograd.pause():
            got = blk(x)
        err, same = _hold("exported resnet50_v1 logits", got, want,
                          EXPORT_RTOL)
        if len(blk._sym_aux_names) != len(stats) or not all(
                "running" in n for n in blk._sym_aux_names):
            raise AssertionError(f"{len(blk._sym_aux_names)} auxiliary "
                                 f"states imported, not {len(stats)}")
        nodes = len(blk._sym_outputs._topo_nodes())
        prefix = os.path.join(d, "served")
        net.export_for_serving(prefix, buckets=buckets)
        srv = ModelServer.from_exported(prefix, ctx=ctx, max_wait_ms=2.0)
        try:
            xs = rs.rand(requests, 3, hw, hw).astype(np.float32)
            with ThreadPoolExecutor(threads) as pool:
                futs = list(pool.map(srv.submit, xs))
            rows = np.stack([f.result(300) for f in futs])
            snap = srv.stats()
            srv.drain(60)
        finally:
            srv.close()
    with mx.autograd.pause():
        full = net(mx.nd.array(xs, ctx=ctx)).asnumpy()
    row_err = max(_rel_l2(r, w) for r, w in zip(rows, full))
    captures = snap["executor_cache"]["captures"]
    signatures = sorted(k[0] for k in snap["compiled"])
    if row_err > SERVE_RTOL or signatures != sorted(buckets) or (
            on_card and captures != len(buckets)):
        raise AssertionError(
            f"from_exported: worst row {row_err:.3e}, buckets "
            f"{signatures}, captures {captures}")
    seconds = time.perf_counter() - t0
    print(f"resnet50_v1 export (B={b}, {hw}x{hw}, fp32, {card}): "
          f"{nodes} nodes, {len(blk._sym_aux_names)} auxiliary states; "
          f"SymbolBlock logits against the block's: relative L2 {err:.3e}, "
          f"bit-equal {same}; from_exported: {requests} requests from "
          f"{threads} threads, worst row {row_err:.3e}, {captures} "
          f"captures for buckets {signatures}, occupancy "
          f"{snap['batch_occupancy']}; {seconds:.1f} s", flush=True)
    return dict(logits_err=err, logits_bit_equal=same, nodes=nodes,
                aux=len(blk._sym_aux_names), row_err=row_err,
                captures=captures, buckets=signatures,
                occupancy=snap["batch_occupancy"],
                latency_ms=snap["latency_ms"], seconds=seconds)


def export_attention_part(seed, card, ctx, b, t, units, heads):
    """The attention block at ``units`` and ``heads`` over (``b``, ``t``):
    exported and imported; the SymbolBlock's forward launches K4 (once, on
    the route of the shape) and equals the block's output."""
    import tempfile

    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    on_card = ctx.device_type == "gpu"
    blk = _attention_block(gluon, nn, units, heads)
    blk.initialize("xavier", ctx=ctx)
    rs = np.random.RandomState(seed + 37)
    x = mx.nd.array(rs.randn(b, t, units).astype(np.float32), ctx=ctx)
    with mx.autograd.pause():
        want = blk(x)
    with tempfile.TemporaryDirectory(prefix="mxtpu_export_") as d:
        sj, pp = blk.export(os.path.join(d, "attention"))
        ops = [n["op"] for n in json.load(open(sj))["nodes"]
               if n["op"] != "null"]
        sym = gluon.SymbolBlock.imports(sj, "data", pp, ctx=ctx)
    _sync(ctx)
    _reset_launches(fa)
    with mx.autograd.pause():
        got = sym(x)
    _sync(ctx)
    routes = _read_routes(fa)
    route = "flash_fwd_" + fwd_route_expected(t, units // heads,
                                              torch.float32)
    if on_card and routes != {**dict.fromkeys(ROUTE_COUNTERS, 0),
                              route: 1}:
        raise AssertionError(f"the SymbolBlock launched {routes}, not K4 "
                             f"once on {route}")
    err, same = _hold("the exported attention block", got, want,
                      EXPORT_RTOL)
    print(f"attention block export ({b}x{heads}x{t}x{units // heads}, "
          f"fp32, {card}): ops {ops}; the SymbolBlock's K4 launches "
          f"{routes[route]} on {route}; against the block: relative L2 "
          f"{err:.3e}, bit-equal {same}", flush=True)
    return dict(ops=ops, routes=routes, err=err, bit_equal=same)


def control_flow_part(seed, card, ctx, b, units, steps, max_iterations,
                      stop):
    """``foreach`` over ``steps`` steps of a ``Dense(units)``+tanh cell at
    B=``b``, ``while_loop`` with ``max_iterations`` (its condition false
    after ``stop`` steps) and ``cond`` with ``inputs``, each against its
    unrolled or explicit form on the same inputs: the values and the
    gradients of the inputs and the cell's parameters (``CONTROL_RTOL``);
    the rows of ``while_loop`` after the last active step are zeros."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import contrib
    from incubator_mxnet_tpu_torch.gluon import nn

    mx.random.seed(seed + 41)
    cx = nn.Dense(units, flatten=False, in_units=units).initialize(
        "xavier", ctx=ctx)
    ch = nn.Dense(units, flatten=False, in_units=units,
                  use_bias=False).initialize("xavier", ctx=ctx)
    params = [p for c in (cx, ch) for p in c.parameters()]
    rs = np.random.RandomState(seed + 43)
    xs_np = (0.5 * rs.randn(steps, b, units)).astype(np.float32)
    h0_np = (0.5 * rs.randn(b, units)).astype(np.float32)

    def cell(x_t, h):
        return (cx(x_t) + ch(h)).tanh()

    def run(fn):
        xs = mx.nd.array(xs_np, ctx=ctx)
        h0 = mx.nd.array(h0_np, ctx=ctx)
        for v in (xs, h0):
            v.attach_grad()
        for p in params:
            p.grad = None
        with mx.autograd.record():
            outs = fn(xs, h0)
            loss = sum((o ** 2).sum() for o in outs)
        loss.backward()
        return ([o._data.detach().clone() for o in outs],
                [xs.grad._data, h0.grad._data]
                + [p.grad.clone() for p in params])

    def foreach(xs, h0):
        outs, h = contrib.foreach(lambda x, h: (cell(x, h),) * 2, xs, h0)
        return [outs, h]

    def unrolled(xs, h0):
        rows, h = [], h0
        for i in range(steps):
            h = cell(xs[i], h)
            rows.append(h)
        return [mx.nd.stack(*rows, axis=0), h]

    def while_loop(xs, h0):
        i0 = mx.nd.zeros((1,), ctx=ctx)
        outs, (i, h) = contrib.while_loop(
            lambda i, h: i < stop,
            lambda i, h: (cell(xs[0], h), (i + 1, cell(xs[0], h))),
            (i0, h0), max_iterations=max_iterations)
        return [outs, h]

    def explicit_while(xs, h0):
        rows, h = [], h0
        for _ in range(min(stop, max_iterations)):
            rows.append(cell(xs[0], h))
            h = cell(xs[0], h)
        rows += [mx.nd.zeros_like(h)] * (max_iterations - len(rows))
        return [mx.nd.stack(*rows, axis=0), h]

    def cond(xs, h0):
        return [contrib.cond(lambda x, h: (x.sum() > 0),
                             lambda x, h: cell(x, h),
                             lambda x, h: cell(-x, h) * 0.5,
                             [xs[0], h0])]

    def explicit_cond(xs, h0):
        taken = float(xs[0].sum().asscalar()) > 0
        return [cell(xs[0], h0) if taken else cell(-xs[0], h0) * 0.5]

    out = {}
    for name, fn, ref in (("foreach", foreach, unrolled),
                          ("while_loop", while_loop, explicit_while),
                          ("cond", cond, explicit_cond)):
        t0 = time.perf_counter()
        got, got_g = run(fn)
        _sync(ctx)
        seconds = time.perf_counter() - t0
        want, want_g = run(ref)
        errs = [_hold(f"{name} value {i}", g, w, CONTROL_RTOL)[0]
                for i, (g, w) in enumerate(zip(got, want))]
        gerrs = [_hold(f"{name} gradient {i}", g, w, CONTROL_RTOL)[0]
                 for i, (g, w) in enumerate(zip(got_g, want_g))]
        out[name] = dict(value_err=max(errs), grad_err=max(gerrs),
                         seconds=seconds)
        if name == "while_loop":
            tail = got[0][min(stop, max_iterations):]
            if tail.numel() and tail.abs().max().item() != 0:
                raise AssertionError("while_loop rows after the last "
                                     "active step are not zeros")
        print(f"{name} ({card}; B={b}, {units} units, "
              f"{steps if name == 'foreach' else max_iterations} steps): "
              f"values {max(errs):.3e}, {len(gerrs)} gradients "
              f"{max(gerrs):.3e} from the unrolled form (relative L2); "
              f"{seconds:.3f} s", flush=True)
    return out


def _sync(ctx):
    if ctx.device_type == "gpu":
        torch.cuda.synchronize()


def hybrid_phase(seed, card, ctx, gpt, resnet, hw=224, b=8, t=256,
                 attention=(8, 256, 768, 12), control=(8, 768, 256, 16, 11),
                 buckets=(1, 2, 4, 8), requests=32, threads=8, timed=True):
    """The hybrid phase on ``ctx``: ``gpt`` hybridized in fp32 then bf16
    (``hybrid_gpt_part``), ``resnet`` exported and served
    (``export_resnet_part``), the attention block exported
    (``export_attention_part``) and the control flow
    (``control_flow_part``). Returns each part's record and the flash
    launches by route of the main paths (the hybridized passes' replays
    and the SymbolBlock's forward)."""
    from incubator_mxnet_tpu_torch.gluon import block as gblock

    t0 = time.perf_counter()
    out = {"gpt": {}}
    routes = dict.fromkeys(ROUTE_COUNTERS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        if dtype != torch.float32:
            gpt.cast("bfloat16")
        row = hybrid_gpt_part(seed, card, gpt, ctx, dtype, b, t,
                              timed=timed)
        out["gpt"][row["dtype"]] = row
        for r in ROUTE_COUNTERS:
            routes[r] += row["replay_routes"][r] + row["step_routes"][r]
    out["resnet"] = export_resnet_part(seed, card, resnet, ctx, hw, b,
                                       buckets, requests, threads)
    out["attention"] = export_attention_part(seed, card, ctx, *attention)
    for r in ROUTE_COUNTERS:
        routes[r] += out["attention"]["routes"][r]
    out["control"] = control_flow_part(seed, card, ctx, *control)
    out["flash_routes"] = routes
    out["cached_op_counts"] = dict(gblock.cached_op_counts)
    out["seconds"] = time.perf_counter() - t0
    print(f"hybrid phase ({card}): CachedOp captures and replays "
          f"{out['cached_op_counts']}; flash launches of its main paths "
          f"{routes}; {out['seconds']:.1f} s", flush=True)
    return out


def hybrid_main(seed, card):
    """The hybrid phase at full width on the card: ``gpt_decoder_117m``
    (max_length 256, dropout 0, B=8, T=256) and the zoo ``resnet50_v1``
    (1000 classes, 224x224, B=8), both drawn from ``seed``."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt, vision

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    gpt = get_gpt("gpt_decoder_117m", vocab_size=50257, dropout=0.0,
                  max_length=256).initialize("xavier", ctx=ctx)
    resnet = vision.resnet50_v1(classes=1000)
    resnet.initialize("xavier", ctx=ctx)
    with mx.autograd.pause():
        resnet(mx.nd.zeros((1, 3, 224, 224), ctx=ctx))   # deferred shapes
    out = hybrid_phase(seed, card, ctx, gpt, resnet)
    del gpt, resnet
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 24: AMP, the optimizers, multi_precision, SSD-300 and detection
# ---------------------------------------------------------------------------
# (name, b, tq, tk, d, causal, cache_offset, lengths) of the fp16 flash
# checks, H = 12: the GPT training shape, BERT's with key lengths, and a
# decode step (the split kernels; forward only)
FP16_CASES = [
    ("train_causal_B8_T256", 8, 256, 256, 64, True, False, None),
    ("bert_lengths_B24_T128", 24, 128, 128, 64, False, False, "bert"),
    ("decode_cache_offset_S8_Tk512", 8, 1, 512, 64, True, True, "decode"),
]
FP16_HEAD = "train_causal_B8_T256"
# the nine optimizers the slice added (RMSProp twice: plain and centered),
# each with its hyperparameters, held card against CPU
OPT_RULES = [
    ("adagrad", {"learning_rate": 0.1}),
    ("adadelta", {"rho": 0.9}),
    ("rmsprop", {"learning_rate": 0.01, "clip_weights": 2.0}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("ftrl", {"learning_rate": 0.1}),
    ("lamb", {"learning_rate": 0.01}),
    ("lars", {"learning_rate": 0.1, "momentum": 0.9}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9}),
    ("sgld", {"learning_rate": 0.01}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}),
]
# card against CPU, fp32 elementwise rules (LAMB and LARS: norms summed in
# another order): relative to max|CPU|
OPT_RTOL = 1e-5
# the fp32 master weights of a multi_precision step against an fp32
# update of the same gradients (the same arithmetic: bit-equal expected)
MASTER_RTOL = 1e-6
# detection ops card against CPU: floating outputs (fp32, other order of
# operations), index outputs and masks equal. RROIAlign: the card's and
# the CPU's fp32 sin/cos differ in their last bits, which sample
# coordinates of magnitude ~10 carry into the bilinear weights (an image's
# neighbours differ by O(1)): 1e-4 there
DET_RTOL, DET_ATOL = 1e-5, 1e-6
DET_TOLS = {"RROIAlign": (1e-4, 1e-4)}


def fp16_flash_checks(seed, dev=None, cases=None, h=12):
    """The fp16 repair on the card: K4 (tensor-core route; split for the
    decode step), K5 and K6 (tensor-core) in fp16 against their plain
    versions (fp32 sums, fp16 results) at ``FP16_CASES``, each route named
    and checked; timed beside SDPA in fp16 under the same boolean mask.
    o within ``TOLS[fp16]``, the lse within ``LSE_TOL``, each gradient
    within ``TOLS[fp16]`` of max|plain| (``_bwd_errs``). On a CPU tensor
    the wrappers take the plain versions and no route is counted."""
    import torch.nn.functional as F

    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0) if dev is None else dev
    on_card = dev.type == "cuda"
    dt = torch.float16
    tol = TOLS[dt]
    rs = np.random.RandomState(seed + 24)
    decode_lens = np.sort(rs.randint(1, 513, size=8))
    rows = []
    for name, b, tq, tk, d, causal, co, lengths in \
            (FP16_CASES if cases is None else cases):
        if isinstance(lengths, str):
            lengths = decode_lens if lengths == "decode" else \
                bert_lengths(seed, b, tk)
        q, k, v = (torch.from_numpy(rs.randn(b, h, t, d).astype(
            np.float32)).to(dev, dt) for t in (tq, tk, tk))
        lens = None if lengths is None else \
            torch.tensor(np.asarray(lengths, np.int32), device=dev)
        kw = dict(causal=causal, cache_offset=co)
        label = f"{name} fp16"
        expect = "split" if tq == 1 else "tc"
        before = _fwd_route_counts(fa)
        got = fa.flash_attention(q, k, v, lens, return_lse=True, **kw)
        if on_card:
            _check_fwd_route(label, before, _fwd_route_counts(fa), expect)
        want = fa.flash_attention_reference(q, k, v, lens, return_lse=True,
                                            **kw)
        err, lse_err = _check_fwd_out(label, got, want, dt)
        valid = _valid_mask(b, tq, tk, lens, causal, co, dev)
        with_lse = tq > 1
        ms = device_ms(lambda: fa.flash_attention(
            q, k, v, lens, return_lse=with_lse, **kw))
        plain_ms = device_ms(lambda: fa.flash_attention_reference(
            q, k, v, lens, return_lse=with_lse, **kw))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=valid))
        bound_ms, bound_by = attention_bound(b, h, tq, tk, d, dt, valid,
                                             with_lse)
        rows.append(dict(kernel="flash_fwd", case=name, dtype="fp16",
                         route=expect, max_abs_err=err, lse_err=lse_err,
                         tol=tol, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"fp16 flash_fwd {name} route {expect}: max_abs_err={err:.3e}"
              f" (tol {tol:g}) lse_err={lse_err:.3e} ms={ms:.5f} plain_ms="
              f"{plain_ms:.5f} library_ms={library_ms:.5f} (SDPA fp16, "
              f"boolean mask) bound_ms={bound_ms:.5f} ({bound_by})",
              flush=True)
        if tq == 1:
            continue
        g = torch.from_numpy(rs.randn(b, h, tq, d).astype(np.float32)).to(
            dev, dt)
        out, lse = got
        delta = (g.float() * out.float()).sum(-1)
        args = (q, k, v, lens, lse, delta, g)
        before = _read_routes(fa)
        got_b = fa.flash_attention_bwd(*args, **kw)
        if on_card:
            _check_bwd_route(label, before, _read_routes(fa), "tc")
        errs = _bwd_errs(label, got_b, fa.flash_attention_bwd_reference(
            *args, **kw), valid, tol)
        library_ms = _sdpa_bwd_ms(q, k, v, g, valid)
        for kernel, labels, launch, plain in (
                ("dq", ("dq",), fa.flash_bwd_dq, fa.flash_bwd_dq_reference),
                ("dkv", ("dk", "dv"), fa.flash_bwd_dkv,
                 fa.flash_bwd_dkv_reference)):
            ms = device_ms(lambda: launch(*args, **kw))
            plain_ms = device_ms(lambda: plain(*args, **kw))
            bound_ms, bound_by = attention_bwd_bound(kernel, b, h, tq, tk,
                                                     d, dt, valid)
            err = max(errs[x][0] for x in labels)
            rows.append(dict(kernel=f"flash_bwd_{kernel}", case=name,
                             dtype="fp16", route="tc", max_abs_err=err,
                             tol=tol, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
            print(f"fp16 flash_bwd_{kernel} {name} route tc: max_abs_err="
                  f"{err:.3e} (tol {tol:g} x max|plain|) ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                  f"(SDPA fp16 backward, both gradients) bound_ms="
                  f"{bound_ms:.5f} ({bound_by})", flush=True)
    return rows


def _lm_batch(seed, b, t, vocab, dev):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randint(0, vocab, (b, t)).astype(
        np.int32)).to(dev), torch.from_numpy(rs.randint(
            0, vocab, (b, t)).astype(np.float32)).to(dev))


def _flash_tc_counts(fa):
    return {n: getattr(fa, n + "_launches") for n in
            ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")}


def _since(before, now):
    return {n: now[n] - before[n] for n in now}


def _amp_step(mx, amp, net, tr, ce, x, y):
    """One AMP step through ``gluon.Trainer``: the scaled backward inside
    record() (the reference's usage), then ``step(1)`` (the loss is a
    mean). Returns the fp32 loss and the logits' type."""
    with mx.autograd.record():
        logits = net(x)
        loss = ce(logits, y).mean()
        with amp.scale_loss(loss, tr) as scaled:
            mx.autograd.backward(scaled)
    tr.step(1)
    return loss.detach().float(), logits.dtype


def _gpt_like(net, ctx):
    """A copy of the GPT decoder ``net`` (dropout 0) on ``ctx`` with its
    weights in fp32."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params

    other = type(net)(vocab_size=net._vocab, units=net._units,
                      num_layers=net._layers, num_heads=net._heads,
                      max_length=net._max_length, dropout=0.0)
    return load_jax_params(other, {n: p.detach().float().cpu().numpy()
                                   for n, p in net.named_parameters()},
                           ctx=ctx)


def gpt_amp_part(seed, card, net, ctx, b=8, t=256, cmp_b=1, steps=3,
                 lr=1e-3, timed=True):
    """GPT under AMP from fp32 weights: ``amp.init("bfloat16")`` (the LM
    head's logits bf16), one step's gradients on ``ctx`` against the same
    AMP step on the CPU (B=``cmp_b``, the same weights and batch: loss to
    ``BF16_GRAD_RTOL`` relative, every gradient tensor to
    ``BF16_GRAD_RTOL`` relative L2, ``_worst_grad``), then ``steps`` Adam
    steps through ``gluon.Trainer`` with ``init_trainer``/``scale_loss``
    (the main path: the tensor-core K4/K5/K6 launched 12 times a step each,
    counted; the loss falls), then an fp16 AMP step with the scaler (the
    fp16 tensor-core K4/K5/K6, counted) and an injected overflow (the
    update skipped, the scale halved)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, gluon
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa

    dev = next(net.parameters()).device
    on_card = dev.type == "cuda"
    vocab, layers = net._vocab, net._layers
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    try:
        amp.init("bfloat16")
        # the card's AMP gradients against the CPU's (same weights, batch)
        x1, y1 = _lm_batch(seed + 1, cmp_b, t, vocab, dev)
        cpu_net = _gpt_like(net, mx.cpu())

        def loss_fn(logits, y):
            if logits.dtype != torch.bfloat16:
                raise AssertionError(f"amp: logits {logits.dtype}, not "
                                     "bfloat16 (the LM head is a target op)")
            return ce(logits, y).mean()

        loss, grads = _grads(net, loss_fn, x1, y1)
        ref_loss, ref_grads = _grads(cpu_net, loss_fn, x1.cpu(), y1.cpu())
        del cpu_net
        names = [n for n, p in net.named_parameters() if p.requires_grad]
        if not math.isfinite(float(loss)) or abs(
                float(loss) - float(ref_loss)) > BF16_GRAD_RTOL * abs(
                    float(ref_loss)):
            raise AssertionError(f"amp: loss {float(loss)} on {card} vs "
                                 f"{float(ref_loss)} on the CPU")
        worst = _worst_grad("amp card vs CPU", names,
                            [g.float().cpu() for g in grads],
                            [g.float() for g in ref_grads], BF16_GRAD_RTOL)
        out["cpu_loss_rel"] = abs(float(loss) - float(ref_loss)) / abs(
            float(ref_loss))
        out["cpu_grad_worst"] = worst
        print(f"amp bf16 step: loss {float(loss):.6f} ({card}) vs "
              f"{float(ref_loss):.6f} (CPU); worst gradient relative L2 "
              f"{worst[0]:.3e} ({worst[1]}) over {len(names)} tensors, "
              f"tolerance {BF16_GRAD_RTOL:g}", flush=True)
        del grads, ref_grads
        # the main path: Adam steps through gluon.Trainer under AMP
        x, y = _lm_batch(seed, b, t, vocab, dev)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": lr})
        scaler = amp.init_trainer(tr)
        before = _flash_tc_counts(fa)
        losses = []
        for _ in range(steps):
            loss, ldt = _amp_step(mx, amp, net, tr, ce, x, y)
            losses.append(float(loss))
        routes = _since(before, _flash_tc_counts(fa))
        if ldt != torch.bfloat16:
            raise AssertionError(f"amp: logits {ldt}, not bfloat16")
        if on_card and any(c != layers * steps for c in routes.values()):
            raise AssertionError(f"amp: {steps} bf16 steps launched "
                                 f"{routes}, not {layers} a step each")
        if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
            raise AssertionError(f"amp: losses {losses} do not fall")
        out.update(losses=losses, routes=routes,
                   scale=scaler.loss_scale)
        if timed:
            out["step_ms"] = _median_turns(
                {"amp": lambda: _amp_step(mx, amp, net, tr, ce, x, y)},
                3)["amp"]
            out["tokens_s"] = b * t / out["step_ms"] * 1e3
            out["device_ms"] = _kernel_ms(
                lambda: _amp_step(mx, amp, net, tr, ce, x, y))
        print(f"amp bf16 GPT (B={b}, T={t}, Adam lr {lr}) on {card}: losses"
              f" {[round(v, 5) for v in losses]}; tensor-core launches "
              f"{routes}; step_ms={out.get('step_ms')} device_ms="
              f"{out.get('device_ms')}", flush=True)
        # an fp16 step with the scaler, then an injected overflow
        amp.deinit()
        amp.init("float16")
        tr16 = gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 1e-4})
        scaler16 = amp.init_trainer(tr16)
        before = _flash_tc_counts(fa)
        loss16, ldt = _amp_step(mx, amp, net, tr16, ce, x, y)
        out["fp16_routes"] = _since(before, _flash_tc_counts(fa))
        if ldt != torch.float16 or not math.isfinite(float(loss16)):
            raise AssertionError(f"amp fp16: logits {ldt}, loss "
                                 f"{float(loss16)}")
        if on_card and any(c != layers for c in out["fp16_routes"].values()):
            raise AssertionError(f"amp fp16: one step launched "
                                 f"{out['fp16_routes']}, not {layers} each")
        if any(not torch.isfinite(p).all() for p in net.parameters()):
            raise AssertionError("amp fp16: a parameter is not finite")
        scale0 = scaler16.loss_scale
        w = next(p for p in net.parameters() if p.requires_grad)
        w0 = w.detach().clone()
        with mx.autograd.record():
            loss = ce(net(x), y).mean()
            with amp.scale_loss(loss, tr16) as scaled:
                mx.autograd.backward(scaled)
        w.grad.view(-1)[0] = float("inf")
        tr16.step(1)
        if not torch.equal(w.detach(), w0) \
                or scaler16.loss_scale != scale0 / 2:
            raise AssertionError("amp overflow: the update ran or the "
                                 f"scale went {scale0} -> "
                                 f"{scaler16.loss_scale}")
        out.update(fp16_loss=float(loss16), fp16_scale=scale0,
                   overflow_scale=scaler16.loss_scale)
        print(f"amp fp16 step: loss {float(loss16):.6f}, tensor-core "
              f"launches {out['fp16_routes']}; injected overflow: update "
              f"skipped, scale {scale0:g} -> {scaler16.loss_scale:g}",
              flush=True)
    finally:
        amp.deinit()
    return out


def multi_precision_part(seed, card, net, ctx, b=8, t=256, rules=("adam",
                                                                  "lamb")):
    """``net`` cast to bf16 takes one step of each rule through
    ``gluon.Trainer`` with ``multi_precision=True`` (FusedStep falls back
    to the per-parameter path): every fp32 master weight against the same
    rule's fp32 update of the same gradients from the same fp32 start
    (``MASTER_RTOL`` of max|expected|), and every weight the cast of its
    master."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, optimizer

    dev = next(net.parameters()).device
    net.cast("bfloat16")
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = _lm_batch(seed + 2, b, t, net._vocab, dev)
    out = {}
    for rule in rules:
        hyper = {"learning_rate": 1e-4, "wd": 1e-4}
        tr = gluon.Trainer(net.collect_params(), rule,
                           dict(hyper, multi_precision=True))
        with mx.autograd.record():
            loss = ce(net(x), y).mean()
        mx.autograd.backward(loss)
        params = tr._params
        grads = [p.grad.detach().clone() for p in params]
        starts = [p.detach().float() for p in params]
        tr.step(1)
        if tr._fused.last_fallback != "multi_precision master weights":
            raise AssertionError(f"multi_precision {rule}: FusedStep ran "
                                 f"({tr._fused.last_fallback})")
        ref = optimizer.create(rule, **hyper)
        worst = 0.0
        for i, (p, g, w32) in enumerate(zip(params, grads, starts)):
            master, _ = tr._updater.states[i]
            st = ref.create_state(i, w32)
            ref.update(i, w32, g.float(), st)
            err = (master - w32).abs().max().item() / max(
                1e-30, w32.abs().max().item())
            worst = max(worst, err)
            if err > MASTER_RTOL or not torch.equal(p.detach(),
                                                    master.bfloat16()):
                raise AssertionError(
                    f"multi_precision {rule}: parameter {i} master off by "
                    f"{err:.3e} or the weight is not its cast")
        out[rule] = {"loss": loss.item(), "master_worst": worst,
                     "params": len(params)}
        print(f"multi_precision {rule} (bf16 GPT, fp32 masters, "
              f"{len(params)} parameters): worst master error {worst:.3e} "
              f"(tol {MASTER_RTOL:g}) against an fp32 update of the same "
              "gradients; every weight the cast of its master", flush=True)
    return out


def optimizer_checks(seed, dev, shapes=((1024, 1024), (4096,)), steps=3,
                     n_noise=2 ** 20):
    """Each of ``OPT_RULES`` on ``dev`` against the CPU on the same
    tensors for ``steps`` steps (wd, clipping and a rescale on): weights
    and states within ``OPT_RTOL`` of max|CPU| (SGLD with its noise taken
    out); then SGLD's noise on ``dev`` against N(0, lr) by its mean and
    variance over ``n_noise`` draws (6 standard errors)."""
    from incubator_mxnet_tpu_torch import optimizer as opt

    rs = np.random.RandomState(seed + 7)
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rs.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(steps)]
    cpu = torch.device("cpu")
    out = {}
    noise = opt.SGLD.__dict__["_noise"]        # the staticmethod itself
    opt.SGLD._noise = staticmethod(lambda w, lr: torch.zeros_like(w))
    try:
        for name, kw in OPT_RULES:
            label = name + ("_centered" if kw.get("centered") else "")
            res = {}
            for where in (cpu, dev):
                o = opt.create(name, wd=1e-4, clip_gradient=1.0,
                               rescale_grad=0.5, **kw)
                u = opt.get_updater(o)
                # copies: on the CPU .to() would hand back the numpy
                # arrays' own memory, which the update writes
                w = [torch.tensor(a, device=where) for a in ws]
                for step in gs:
                    for i, g in enumerate(step):
                        u(i, torch.from_numpy(g).to(where), w[i])
                states = [x for i in range(len(ws)) for x in
                          _state_tensors(u.states[i])]
                res[where.type] = [x.detach().cpu() for x in w + states]
            worst = max((a - b).abs().max().item() / max(
                1e-30, b.abs().max().item()) for a, b in zip(
                    res[dev.type], res["cpu"]))
            if not math.isfinite(worst) or worst > OPT_RTOL:
                raise AssertionError(f"optimizer {label}: {dev} vs CPU off "
                                     f"by {worst:.3e} > {OPT_RTOL:g}")
            out[label] = worst
    finally:
        opt.SGLD._noise = noise
    lr = 0.04
    o = opt.create("sgld", learning_rate=lr)
    w = torch.zeros(n_noise, device=dev)
    opt.get_updater(o)(0, torch.zeros(n_noise, device=dev), w)
    mean, var = w.mean().item(), w.var().item()
    if abs(mean) > 6 * math.sqrt(lr / n_noise) or \
            abs(var - lr) > 6 * lr * math.sqrt(2.0 / n_noise):
        raise AssertionError(f"sgld noise: mean {mean}, var {var}, not "
                             f"N(0, {lr})")
    out["sgld_noise"] = (mean, var)
    print(f"optimizers on {dev} vs CPU ({steps} steps, shapes {shapes}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in out.items()
                      if k != "sgld_noise")
          + f" (tol {OPT_RTOL:g}); SGLD noise mean {mean:.3e} var "
          f"{var:.5f} (N(0, {lr}))", flush=True)
    return out


def _state_tensors(state):
    """Every tensor of an optimizer state (None, a tensor or tuples)."""
    if state is None:
        return []
    if isinstance(state, tuple):
        return [x for s in state for x in _state_tensors(s)]
    return [state]


def spmd_optax_checks(seed, ctx, b=64, units=256, k=4):
    """``SPMDTrainer`` with lamb, rmsprop and adagrad (``OptaxRule``) on an
    MLP: ``run_superstep`` over a window of K batches (one CUDA graph on
    the card) against K eager ``step`` calls from the same start: the K
    losses and every parameter bit for bit."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import gluon, parallel

    mx.random.seed(seed)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(units, activation="relu", in_units=units),
            gluon.nn.Dense(10, in_units=units))
    net.initialize("xavier", ctx=ctx)
    dev = next(net.parameters()).device
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(seed + 3)
    xs = torch.from_numpy(rs.randn(k, b, units).astype(np.float32)).to(dev)
    ys = torch.from_numpy(rs.randint(0, 10, (k, b)).astype(
        np.float32)).to(dev)
    out = {}
    for name, hyper in (("lamb", {"learning_rate": 1e-3, "wd": 1e-4}),
                        ("rmsprop", {"learning_rate": 1e-3}),
                        ("adagrad", {"learning_rate": 1e-2})):
        eager = parallel.SPMDTrainer(net, lambda o, l: ce(o, l), name,
                                     dict(hyper))
        ref = torch.stack([eager.step(xs[i], ys[i]) for i in range(k)])
        graph = parallel.SPMDTrainer(net, lambda o, l: ce(o, l), name,
                                     dict(hyper))
        got = graph.run_superstep(xs, ys)
        same = torch.equal(got, ref) and all(
            torch.equal(graph.params[n], eager.params[n])
            for n in eager.params)
        if not same:
            raise AssertionError(f"SPMDTrainer {name}: the graph path "
                                 "differs from K eager steps")
        out[name] = [float(v) for v in got]
    print(f"SPMDTrainer lamb/rmsprop/adagrad: run_superstep (K={k}, "
          f"{parallel.superstep.step_path(dev)}) bit-equal to {k} eager "
          f"steps: "
          f"{out}", flush=True)
    return out


def ssd_batch(i, b, hw=300):
    """bench.py's SSD row batch ``i``: images (B, 3, hw, hw) in [0, 1),
    one box a image in 4 label slots ([cls, corners], -1 padding)."""
    rs = np.random.RandomState(i)
    img = rs.rand(b, 3, hw, hw).astype(np.float32)
    label = np.full((b, 4, 5), -1.0, np.float32)
    for j in range(b):
        cx, cy = rs.uniform(0.3, 0.7, 2)
        w, h = rs.uniform(0.2, 0.4, 2)
        label[j, 0] = [rs.randint(20), cx - w / 2, cy - h / 2, cx + w / 2,
                       cy + h / 2]
    return img, label


def ssd_loss_fn():
    """bench.py's SSD loss: ``MultiBoxTarget(negative_mining_ratio=3,
    ignore_label=-1)`` on fp32 anchors and predictions, then
    ``SSDMultiBoxLoss``."""
    from incubator_mxnet_tpu_torch.models import SSDMultiBoxLoss
    from incubator_mxnet_tpu_torch.ops import detection as det

    box_loss = SSDMultiBoxLoss()

    def ssd_loss(cls_pred, loc_pred, anchors, label):
        bt, bm, ct = det.multibox_target(
            anchors.float(), label, cls_pred.transpose(1, 2).float(),
            negative_mining_ratio=3.0, ignore_label=-1)
        return box_loss(cls_pred.float(), loc_pred.float(), ct, bt, bm)

    return ssd_loss


def _det_inputs(seed):
    """Small inputs of the 14 detection ops (ties and invalid rows
    among them): name -> (op function name, args, kwargs)."""
    from incubator_mxnet_tpu_torch.ops import detection as det

    rs = np.random.RandomState(seed + 11)

    def boxes(*shape, hi=1.0):
        a = rs.uniform(0, hi, shape + (2, 2)).astype(np.float32)
        a.sort(axis=-2)
        return np.concatenate([a[..., 0, :], a[..., 1, :]], -1)

    t = torch.from_numpy
    anchor = det.multibox_prior(torch.zeros(1, 1, 8, 8), sizes=(0.2, 0.3),
                                ratios=(1.0, 2.0))
    n = anchor.shape[1]
    label = np.full((4, 4, 5), -1.0, np.float32)
    for j in range(4):
        for m in range(j % 3 + 1):
            c = rs.uniform(0.3, 0.7, 2)
            wh = rs.uniform(0.1, 0.4, 2)
            label[j, m] = [rs.randint(5), *(c - wh / 2), *(c + wh / 2)]
    pred = rs.randn(4, 6, n).astype(np.float32)
    pred[:, 1:, :4] = 3.0
    rec = np.zeros((2, 64, 6), np.float32)
    rec[..., 0] = rs.randint(0, 3, (2, 64))
    rec[..., 1] = rs.uniform(-0.2, 1.0, (2, 64))
    rec[..., 2:] = boxes(2, 64, hi=0.6)
    rec[:, 5, 1] = rec[:, 9, 1]
    prob = np.exp(pred) / np.exp(pred).sum(1, keepdims=True)
    a = 6
    rpn_cls = rs.uniform(0, 1, (2, 2 * a, 6, 8)).astype(np.float32)
    rpn_box = (rs.randn(2, 4 * a, 6, 8) * 0.2).astype(np.float32)
    info = np.array([[96, 128, 1.0], [80, 112, 1.5]], np.float32)
    rpn_kw = dict(feature_stride=16, scales=(2, 4, 8), ratios=(0.5, 1.0),
                  rpn_pre_nms_top_n=80, rpn_post_nms_top_n=16,
                  threshold=0.6, rpn_min_size=4)
    fm = rs.randn(2, 2 * 9, 12, 14).astype(np.float32)
    x0 = rs.uniform(0, 80, 5)
    y0 = rs.uniform(0, 70, 5)
    rois = np.stack([rs.randint(0, 2, 5), x0, y0, x0 + rs.uniform(8, 30, 5),
                     y0 + rs.uniform(8, 30, 5)], 1).astype(np.float32)
    rrois = np.stack([rs.randint(0, 2, 5), rs.uniform(10, 90, 5),
                      rs.uniform(10, 80, 5), rs.uniform(8, 40, 5),
                      rs.uniform(8, 30, 5), rs.uniform(-90, 90, 5)],
                     1).astype(np.float32)
    trans = (rs.randn(5, 2, 3, 3) * 0.5).astype(np.float32)
    ps_kw = dict(spatial_scale=0.125, output_dim=2, pooled_size=3)
    return {
        "smooth_l1": ("smooth_l1", [t(rs.randn(6, 7).astype(np.float32))],
                      {"scalar": 2.0}),
        "box_iou": ("box_iou", [t(boxes(2, 9)), t(boxes(2, 5))], {}),
        "box_encode": ("box_encode", [
            t(rs.choice([-1.0, 0.0, 1.0], (2, 9)).astype(np.float32)),
            t(rs.randint(0, 5, (2, 9)).astype(np.float32)),
            t(boxes(2, 9)), t(boxes(2, 5))], {}),
        "box_decode": ("box_decode", [
            t((rs.randn(2, 9, 4) * 0.3).astype(np.float32)),
            t(boxes(1, 9))], {"std0": 0.1, "std1": 0.1, "std2": 0.2,
                              "std3": 0.2, "clip": 0.5}),
        "bipartite_matching": ("bipartite_matching", [
            t(np.round(rs.uniform(0, 1, (2, 7, 5)), 1).astype(
                np.float32))], {"threshold": 0.2}),
        "box_nms": ("box_nms", [t(rec)], {"id_index": 0, "topk": 40,
                                          "overlap_thresh": 0.4}),
        "multibox_prior": ("multibox_prior", [torch.zeros(1, 1, 5, 7)],
                           {"sizes": (0.1, 0.141),
                            "ratios": (1.0, 2.0, 0.5)}),
        "multibox_target": ("multibox_target", [anchor, t(label), t(pred)],
                            {"negative_mining_ratio": 3.0,
                             "ignore_label": -1}),
        "multibox_detection": ("multibox_detection", [
            t(prob.astype(np.float32)),
            t((rs.randn(4, n * 4) * 0.3).astype(np.float32)), anchor],
            {"nms_topk": 100}),
        "Proposal": ("proposal", [t(rpn_cls), t(rpn_box), t(info)],
                     rpn_kw),
        "MultiProposal": ("multi_proposal", [t(rpn_cls), t(rpn_box),
                                             t(info)],
                          dict(rpn_kw, output_score=True)),
        "PSROIPooling": ("psroi_pooling", [t(fm), t(rois)], ps_kw),
        "DeformablePSROIPooling": ("deformable_psroi_pooling", [
            t(fm), t(rois), t(trans)], dict(ps_kw, sample_per_part=2,
                                            trans_std=0.2)),
        "RROIAlign": ("rroi_align", [t(fm), t(rrois)],
                      {"pooled_size": (3, 4), "spatial_scale": 0.125}),
    }


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def detection_checks(seed, dev):
    """The 14 detection ops on ``dev`` against the CPU on the same inputs
    (``_det_inputs``): floating outputs within ``DET_RTOL``/``DET_ATOL``,
    NMS and matching outputs (index columns, -1 rows) equal. The ops are
    looked up on ``ops.detection`` at call time."""
    from incubator_mxnet_tpu_torch.ops import detection as det

    out = {}
    for name, (fname, args, kw) in _det_inputs(seed).items():
        fn = getattr(det, fname)
        got = _outs(fn(*[a.to(dev) for a in args], **kw))
        want = _outs(fn(*args, **kw))
        worst = 0.0
        rtol, atol = DET_TOLS.get(name, (DET_RTOL, DET_ATOL))
        for g, w in zip(got, want):
            g = g.detach().float().cpu()
            w = w.detach().float()
            if g.shape != w.shape or not torch.allclose(
                    g, w, rtol=rtol, atol=atol):
                raise AssertionError(f"detection {name}: {dev} differs "
                                     "from the CPU")
            worst = max(worst, (g - w).abs().max().item() if g.numel()
                        else 0.0)
        out[name] = worst
    print(f"detection ops on {dev} vs CPU: all {len(out)} within "
          f"{DET_RTOL:g}/{DET_ATOL:g}: " + ", ".join(
              f"{k} {v:.1e}" for k, v in out.items()), flush=True)
    return out


def ssd_part(seed, card, ctx, b=16, hw=300, k=3, amp_steps=4, timed=True):
    """SSD-300 VOC as bench.py's row runs it: B=``b`` images of hw x hw,
    21 classes, 8732 anchors, the net cast to bf16, ``SPMDTrainer`` SGD (lr
    1e-3, momentum 0.9) over ``ssd_loss_fn``. K eager steps, then
    ``run_superstep`` over the same K batches (one CUDA graph on the card)
    bit-equal to them (losses and parameters; cuDNN held to deterministic
    algorithms for the phase, so that two runs of one step agree); one
    step under ``torch.cuda.set_sync_debug_mode("error")`` (no host read);
    timed eager and on graphs (host ms a step, images/s, device ms a step
    and its leading kernels). Then the AMP route: the fp32 weights,
    ``amp.init("bfloat16")``, ``gluon.Trainer`` with ``init_trainer`` and
    ``scale_loss``, ``amp_steps`` steps on one batch with a falling loss;
    ``multibox_detection`` on that net (timed, image 0 and 1 held against
    the CPU); ``multibox_target`` at the step's shapes held against the
    CPU; ``box_nms`` over 8732 records timed."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import amp, gluon, models, parallel
    from incubator_mxnet_tpu_torch.gluon.model_zoo import load_jax_params
    from incubator_mxnet_tpu_torch.ops import detection as det

    on_card = ctx.device_type == "gpu"
    mx.random.seed(seed)
    net = models.get_ssd(num_classes=20)
    net.initialize("xavier", ctx=ctx)
    dev = next(net.parameters()).device
    with mx.autograd.pause():
        net(mx.nd.zeros((1, 3, hw, hw), ctx=ctx))
    fp32 = {n: p.detach().float().cpu().numpy()
            for n, p in net.named_parameters()}
    net.cast("bfloat16")
    ssd_loss = ssd_loss_fn()
    batches = [ssd_batch(i, b, hw) for i in range(k)]
    xs = torch.from_numpy(np.stack([x for x, _ in batches])).to(
        dev, torch.bfloat16)
    ys = torch.from_numpy(np.stack([y for _, y in batches])).to(dev)
    hyper = {"learning_rate": 1e-3, "momentum": 0.9}
    out = {"batch": b, "anchors": None}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = parallel.SPMDTrainer(net, ssd_loss, "sgd", dict(hyper))
        ref = torch.stack([eager.step(xs[i], ys[i]) for i in range(k)])
        graph = parallel.SPMDTrainer(net, ssd_loss, "sgd", dict(hyper))
        got = graph.run_superstep(xs, ys)
        if not (torch.equal(got, ref) and all(
                torch.equal(graph.params[n], eager.params[n])
                for n in eager.params)):
            raise AssertionError(f"ssd: the graph path ({got.tolist()}) "
                                 f"differs from {k} eager steps "
                                 f"({ref.tolist()})")
        if not torch.isfinite(ref).all():
            raise AssertionError(f"ssd: losses {ref.tolist()}")
        out["losses"] = [float(v) for v in ref]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager.step(xs[0], ys[0])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out["sync_free"] = True
        if timed:
            turns = _median_turns({
                "eager": lambda: [eager.step(xs[i], ys[i])
                                  for i in range(k)],
                "graph": lambda: graph.run_superstep(xs, ys)}, 3)
            erows, _ = _kernel_rows(lambda: eager.step(xs[0], ys[0]))
            grows, _ = _kernel_rows(lambda: graph.run_superstep(xs, ys))
            out["eager_ms"] = turns["eager"] / k
            out["graph_ms"] = turns["graph"] / k
            out["eager_images_s"] = b / out["eager_ms"] * 1e3
            out["graph_images_s"] = b / out["graph_ms"] * 1e3
            out["eager_device_ms"] = sum(r[0] for r in erows)
            out["graph_device_ms"] = sum(r[0] for r in grows) / k
            out["top_kernels"] = [(round(r[0], 4), r[1], r[2][:80])
                                  for r in erows[:6]]
        print(f"ssd300 bf16 SPMDTrainer SGD (B={b}) on {card}: eager losses "
              f"{out['losses']}, graph path bit-equal; sync-free step "
              f"{out.get('sync_free')}; eager_ms={out.get('eager_ms')} "
              f"graph_ms={out.get('graph_ms')} images/s eager "
              f"{out.get('eager_images_s')} graph "
              f"{out.get('graph_images_s')}; device ms a step eager "
              f"{out.get('eager_device_ms')} graph "
              f"{out.get('graph_device_ms')}; top kernels "
              f"{out.get('top_kernels')}", flush=True)
        # multibox_target at the step's shapes, card against CPU
        with mx.autograd.pause():
            cls_pred, loc_pred, anchors = eager.net(xs[0])
        out["anchors"] = int(anchors.shape[1])
        tgt = det.multibox_target(anchors.float(), ys[0],
                                  cls_pred.transpose(1, 2).float(),
                                  negative_mining_ratio=3.0,
                                  ignore_label=-1)
        tgt_cpu = det.multibox_target(
            anchors.float().cpu(), ys[0].cpu(),
            cls_pred.transpose(1, 2).float().cpu(),
            negative_mining_ratio=3.0, ignore_label=-1)
        for name, g, w in zip(("box_target", "box_mask", "cls_target"),
                              tgt, tgt_cpu):
            if not torch.allclose(g.cpu(), w, rtol=DET_RTOL, atol=DET_ATOL) \
                    or (name != "box_target" and not torch.equal(g.cpu(), w)):
                raise AssertionError(f"ssd multibox_target {name}: {dev} "
                                     "differs from the CPU")
        del eager, graph
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # the AMP route from the fp32 weights
    net32 = load_jax_params(models.get_ssd(num_classes=20), fp32, ctx=ctx)
    x32 = xs[0].float()
    amp.init("bfloat16")
    try:
        tr = gluon.Trainer(net32.collect_params(), "sgd", dict(hyper))
        amp.init_trainer(tr)
        amp_losses = []
        for _ in range(amp_steps):
            with mx.autograd.record():
                cls_pred, loc_pred, anchors = net32(x32)
                loss = ssd_loss(cls_pred, loc_pred, anchors, ys[0]).mean()
                with amp.scale_loss(loss, tr) as scaled:
                    mx.autograd.backward(scaled)
            tr.step(1)
            amp_losses.append(loss.item())
        if cls_pred.dtype != torch.bfloat16:
            raise AssertionError(f"ssd amp: class predictions "
                                 f"{cls_pred.dtype}, not bfloat16")
        if not all(map(math.isfinite, amp_losses)) \
                or amp_losses[-1] >= amp_losses[0]:
            raise AssertionError(f"ssd amp: losses {amp_losses} do not "
                                 "fall")
        out["amp_losses"] = amp_losses
        print(f"ssd300 AMP (fp32 weights, bf16 convolutions) on {card}: "
              f"losses {amp_losses}", flush=True)
    finally:
        amp.deinit()
    # detection on the trained net
    with mx.autograd.pause():
        cls_pred, loc_pred, anchors = net32(x32)
    prob = torch.softmax(cls_pred.float(), -1).transpose(1, 2).contiguous()
    loc_pred, anchors = loc_pred.float(), anchors.float()

    def detect():
        return det.multibox_detection(prob, loc_pred, anchors)

    found = detect()
    if found.shape != (b, anchors.shape[1], 6) or not torch.isfinite(
            found).all():
        raise AssertionError(f"ssd detection: {tuple(found.shape)}")
    # the kept rows of each image, in the output's (score) order
    kept = found[..., 0] >= 0
    ordered = all(bool((s[1:] <= s[:-1]).all()) for s in (
        found[i, kept[i], 1] for i in range(b)))
    if not ordered or not kept.any() or (found[..., 0][kept] >= 20).any():
        raise AssertionError("ssd detection: rows not sorted by score, "
                             "none kept, or a class out of range")
    want = det.multibox_detection(prob[:2].cpu(), loc_pred[:2].cpu(),
                                  anchors.cpu())
    if not torch.allclose(found[:2].cpu(), want, rtol=DET_RTOL,
                          atol=DET_ATOL):
        raise AssertionError(f"ssd detection: {dev} differs from the CPU")
    out["detections_kept"] = int(kept.sum())
    records = found[:, :, :].clone()
    if timed:
        out["detection_ms"] = _median_turns({"d": detect}, 3)["d"]
        out["box_nms_ms"] = _median_turns({"n": lambda: det.box_nms(
            records, id_index=0)}, 3)["n"]
    print(f"ssd300 multibox_detection (B={b}, {anchors.shape[1]} anchors, "
          f"NMS over all of them): {out['detections_kept']} kept; "
          f"detection_ms={out.get('detection_ms')} box_nms_ms="
          f"{out.get('box_nms_ms')} (host clock, one call, B={b})",
          flush=True)
    del net, net32
    return out


def ssd_amp_phase(seed, card, ctx, gpt, gpt_b=8, gpt_t=256, cmp_b=1,
                  ssd_b=16, ssd_k=3, fp16_cases=None, timed=True):
    """Slice 24's phase on ``ctx``: the fp16 flash checks, the AMP GPT
    (``gpt_amp_part``), ``multi_precision`` on the same GPT cast to bf16,
    the optimizers card against CPU and the SPMDTrainer optax rules on
    the graph path, SSD-300 (``ssd_part``) and the 14 detection ops card
    against CPU. Returns each part's record."""
    t0 = time.perf_counter()
    dev = next(gpt.parameters()).device
    out = {"fp16": fp16_flash_checks(seed, dev, fp16_cases)}
    out["amp"] = gpt_amp_part(seed, card, gpt, ctx, gpt_b, gpt_t, cmp_b,
                              timed=timed)
    out["multi_precision"] = multi_precision_part(seed, card, gpt, ctx,
                                                  gpt_b, gpt_t)
    out["optimizers"] = optimizer_checks(seed, dev)
    out["spmd_optax"] = spmd_optax_checks(seed, ctx)
    out["ssd"] = ssd_part(seed, card, ctx, ssd_b, k=ssd_k, timed=timed)
    out["detection"] = detection_checks(seed, dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"ssd_amp phase ({card}): {out['seconds']:.1f} s", flush=True)
    return out


def ssd_amp_main(seed, card):
    """The phase at full width on the card: ``gpt_decoder_117m`` (vocab
    50257, max_length 256, dropout 0, fp32 weights from ``seed``) at
    B=8, T=256, and SSD-300 VOC at B=16, 3x300x300."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.gluon.model_zoo import get_gpt

    ctx = mx.gpu(0)
    mx.random.seed(seed)
    gpt = get_gpt("gpt_decoder_117m", vocab_size=50257, dropout=0.0,
                  max_length=256).initialize("xavier", ctx=ctx)
    out = ssd_amp_phase(seed, card, ctx, gpt)
    del gpt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    # one replica start of the registry phase's artifact check (the script
    # runs itself in a new process with these)
    ap.add_argument("--warm-start-child", choices=("cold", "warm"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--artifact-dir", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if importlib.util.find_spec("incubator_mxnet_tpu_torch") is None:
        # the script alone, without the repository beside it
        print("chip_smoke: the port (incubator_mxnet_tpu_torch) is not "
              "importable: run the script from the root of the repository",
              file=sys.stderr)
        return 2
    if args.warm_start_child:
        return warm_start_child(args.seed, args.warm_start_child,
                                args.artifact_dir, args.out)
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import _build
    from incubator_mxnet_tpu_torch.ops import rtc_kernels as rk

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {list(_build.SOURCES)} in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    kernel_sass()
    t0 = time.perf_counter()
    for name in RTC_KERNELS:                 # NVRTC, or the cubin cache
        rk.kernel(name)
    print(f"build: the rtc kernels {list(RTC_KERNELS)} (NVRTC, sm_90a "
          f"cubins) in {time.perf_counter() - t0:.1f} s", flush=True)

    kernel = kernel_phase(args.seed)
    bwd = backward_kernel_phase(args.seed)
    conv = conv_kernel_phase(args.seed)
    served = slice_phase(args.seed, card)
    gc.collect()
    trained = train_phase(args.seed, card)
    gc.collect()
    bert = bert_main(args.seed, card)
    gc.collect()
    resnet = resnet_main(args.seed, card)
    gc.collect()
    server = model_server_main(args.seed, card)
    gc.collect()
    registry = registry_main(args.seed, card)
    gc.collect()
    unfused = unfused_resnet_main(args.seed, card)
    gc.collect()
    vision = vision_main(args.seed, card)
    gc.collect()
    mlp = mlp_phase(args.seed, card, mx.gpu(0))
    gc.collect()
    graph = graph_phase(args.seed, card, mx.gpu(0))
    gc.collect()
    imperative = imperative_main(args.seed, card)
    gc.collect()
    nd = nd_main(args.seed, card)
    gc.collect()
    hybrid = hybrid_main(args.seed, card)
    gc.collect()
    ssd_amp = ssd_amp_main(args.seed, card)

    src = "incubator_mxnet_tpu_torch/csrc/"
    ref = "incubator_mxnet_tpu/ops/pallas_attention.py:"
    train_case = BWD_HEAD
    # K4 by route: the f32 kernel carries fp32 training, the imperative
    # step and the longer fp32 prefills, the SIMT kernel the prefills of 32
    # rows or fewer, the tensor-core kernel bf16 training (the bench rows;
    # the gates), the split kernels the decode steps; launches: the sum over
    # the main paths (serving, GPT and BERT training, the imperative step,
    # the graph rows), each read in its own windows; the gates and train ->
    # decode stand in launches_by_path alone
    record = {"kernels": []}
    sparse_bert_routes = bert["sparse"]["bert"]["flash_routes"]
    utils_routes = vision["clip"]["flash_routes"]
    for route, source, head, dtype in (
            ("simt", "flash_fwd.cu", FWD_HEAD, "fp32"),
            ("f32", "flash_fwd_f32.cu", FWD_HEAD, "fp32"),
            ("tc", "flash_fwd_tc.cu", FWD_HEAD, "bf16"),
            ("split", "flash_fwd_split.cu", FWD_DECODE, "fp32")):
        name = "flash_fwd" if route == "simt" else f"flash_fwd_{route}"
        by_path = {
            "decode": served["routes"][route],
            "train": trained["routes"][f"flash_fwd_{route}"],
            "imperative": imperative["flash_routes"][f"flash_fwd_{route}"],
            "gpt_graph": graph["gpt"]["launches"].get(f"flash_fwd_{route}",
                                                      0),
            "bert_train": bert["routes"][f"flash_fwd_{route}"],
            "bert_graph": graph["bert"]["launches"].get(
                f"flash_fwd_{route}", 0),
            "registry": registry["fwd_routes"][route],
            "nd": nd["flash_routes"][f"flash_fwd_{route}"],
            "nd1x": bert["nd1x"]["flash_routes"][f"flash_fwd_{route}"],
            "np": nd["np"]["flash_routes"][f"flash_fwd_{route}"],
            "sparse": sparse_bert_routes[f"flash_fwd_{route}"],
            "utils": utils_routes[f"flash_fwd_{route}"],
            "hybrid": hybrid["flash_routes"][f"flash_fwd_{route}"],
            "amp": ssd_amp["amp"]["routes"].get(f"flash_fwd_{route}", 0)}
        main_paths = sum(by_path.values())
        by_path["train_to_decode"] = trained["decode_routes"][route]
        if route == "tc":
            by_path["bf16_gate"] = trained["gate_launches"]["flash_fwd_tc"]
            by_path["bert_bf16_gate"] = bert["gate_launches"]["flash_fwd_tc"]
        entry = _entry(name, src + source, ref + "54", main_paths,
                       [r for r in kernel if r["route"] == route], head,
                       dtype)
        row = next(r for r in entry["cases"] if r["case"] == head
                   and r["dtype"] == dtype)
        entry["library_causal_ms"] = row["library_causal_ms"]
        entry["simt_ms"] = row["simt_ms"]
        entry["launches_by_path"] = by_path
        record["kernels"].append(entry)
    # K5 and K6 by route: the f32 kernels carry fp32 (the oracle, the fp32
    # training steps, the imperative step), the tensor-core kernels bf16
    # (the gate, the bench row); the SIMT kernels, which no main path
    # launches any more, timed on the same inputs through route="simt"
    for name, line in (("flash_bwd_dq", "209"), ("flash_bwd_dkv", "267")):
        for route, source, dtype in (("simt", "flash_bwd.cu", "fp32"),
                                     ("f32", "flash_bwd_f32.cu", "fp32"),
                                     ("tc", "flash_bwd_tc.cu", "bf16")):
            in_graph = graph["gpt"]["launches"].get(f"{name}_{route}", 0)
            bert_graph = graph["bert"]["launches"].get(f"{name}_{route}", 0)
            entry = _entry(name if route == "simt" else f"{name}_{route}",
                           src + source, ref + line,
                           trained["routes"][f"{name}_{route}"]
                           + imperative["flash_routes"][f"{name}_{route}"]
                           + in_graph + bert["routes"][f"{name}_{route}"]
                           + bert_graph + nd["flash_routes"][
                               f"{name}_{route}"]
                           + bert["nd1x"]["flash_routes"][f"{name}_{route}"]
                           + nd["np"]["flash_routes"][f"{name}_{route}"]
                           + sparse_bert_routes[f"{name}_{route}"]
                           + utils_routes[f"{name}_{route}"]
                           + hybrid["flash_routes"][f"{name}_{route}"]
                           + ssd_amp["amp"]["routes"].get(
                               f"{name}_{route}", 0),
                           [r for r in bwd if r["kernel"] == name
                            and r["route"] == route], train_case, dtype)
            head = next(r for r in entry["cases"] if r["case"] == train_case
                        and r["dtype"] == dtype)
            entry["library_causal_ms"] = head["library_causal_ms"]
            entry["simt_ms"] = head["simt_ms"]
            entry["launches_by_path"] = {
                "train": trained["routes"][f"{name}_{route}"],
                "imperative": imperative["flash_routes"][f"{name}_{route}"],
                "gpt_graph": in_graph,
                "bert_train": bert["routes"][f"{name}_{route}"],
                "bert_graph": bert_graph,
                "nd": nd["flash_routes"][f"{name}_{route}"],
                "nd1x": bert["nd1x"]["flash_routes"][f"{name}_{route}"],
                "np": nd["np"]["flash_routes"][f"{name}_{route}"],
                "sparse": sparse_bert_routes[f"{name}_{route}"],
                "utils": utils_routes[f"{name}_{route}"],
                "hybrid": hybrid["flash_routes"][f"{name}_{route}"],
                "amp": ssd_amp["amp"]["routes"].get(f"{name}_{route}", 0)}
            if route == "tc":
                entry["launches_by_path"]["bf16_gate"] = \
                    trained["gate_launches"][f"{name}_tc"]
                entry["launches_by_path"]["bert_bf16_gate"] = \
                    bert["gate_launches"][f"{name}_tc"]
            record["kernels"].append(entry)
    # K4/K5/K6 in fp16 on the tensor cores (the fp16 repair): launches from
    # the fp16 AMP step of the GPT, numbers at the GPT training shape
    for name, source, line in (("flash_fwd", "flash_fwd_tc.cu", "54"),
                               ("flash_bwd_dq", "flash_bwd_tc.cu", "209"),
                               ("flash_bwd_dkv", "flash_bwd_tc.cu", "267")):
        cases = [r for r in ssd_amp["fp16"] if r["kernel"] == name]
        head = next(r for r in cases if r["case"] == FP16_HEAD)
        launched = ssd_amp["amp"]["fp16_routes"][f"{name}_tc"]
        record["kernels"].append({
            "name": f"{name}_tc_fp16", "route": "cuda",
            "source": src + source, "replaces": ref + line,
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": FP16_HEAD,
            "dtype": "fp16", "cases": cases,
            "launches_by_path": {"amp": launched}})
    conv_ref = "incubator_mxnet_tpu/ops/pallas_conv.py:"
    # K1, K2 and K3 by route: fp32 (the oracle, the fp32 training steps,
    # eval) on the f32 kernels; bf16 (the gates, the bf16 learning check
    # and the bench row) on the tensor cores; the SIMT kernels, which no
    # main path launches any more, timed on the same inputs through
    # route="simt"
    for name, line, cuda_fns, sources in (
            ("fused_conv", "222", ("fused_conv_fwd_kernel",
                                   "fused_conv_tc_kernel",
                                   "fused_conv_f32_kernel"),
             ("fused_conv.cu", "fused_conv_tc.cu", "fused_conv_f32.cu")),
            ("conv_bwd_dx", "553", ("conv_bwd_dx_kernel",
                                    "conv_bwd_dx_tc_kernel",
                                    "conv_bwd_dx_f32_kernel"),
             ("conv_bwd.cu", "conv_bwd_tc.cu", "conv_bwd_f32.cu")),
            ("conv_bwd_dw", "780", ("conv_bwd_dw_kernel",
                                    "conv_bwd_dw_tc_kernel",
                                    "conv_bwd_dw_f32_kernel"),
             ("conv_bwd.cu", "conv_bwd_tc.cu", "conv_bwd_f32.cu"))):
        for route, fn, source, dtype in zip(("simt", "tc", "f32"), cuda_fns,
                                            sources, ("fp32", "bf16",
                                                      "fp32")):
            in_graph = graph["resnet50_fused"]["launches"].get(
                f"{name}_{route}", 0)
            served_by = sum(server[dt]["routes"][name, route]
                            for dt in ("fp32", "bf16"))
            registry_by = registry["conv_routes"][name, route]
            entry = _entry(name if route == "simt" else f"{name}_{route}",
                           src + source, conv_ref + line,
                           resnet["routes"][name, route] + in_graph
                           + served_by + registry_by,
                           [r for r in conv if r["kernel"] == name
                            and r["route"] == route], CONV_HEAD, dtype)
            entry["kernel"] = fn
            if route != "simt":
                entry["simt_ms"] = next(
                    r["simt_ms"] for r in entry["cases"]
                    if r["case"] == CONV_HEAD)
            entry["launches_by_path"] = {"resnet_train":
                                         resnet["routes"][name, route],
                                         "resnet_graph": in_graph}
            if name == "fused_conv":
                entry["launches_by_path"]["resnet_eval"] = \
                    resnet["eval_routes"][name, route]
                entry["launches_by_path"]["model_server"] = served_by
                entry["launches_by_path"]["registry"] = registry_by
            record["kernels"].append(entry)
    rows = imperative["rows"]
    head = rows[RTC_HEAD]
    cases = list(rows.values()) + imperative["rtc_cases"]
    record["kernels"].append({
        "name": "rtc_cuda_module", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/rtc.py",
        "replaces": "incubator_mxnet_tpu/rtc.py:66",
        "launches": sum(r["launches"] for r in rows.values()),
        "max_abs_err": max(r["max_abs_err"] for r in cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": RTC_HEAD,
        "cases": cases})
    bench = unfused["bench"]
    print("rows: " + json.dumps({
        "resnet50_fused_bf16": {k: resnet["bench"][k]
                                for k in ("batch", "step_ms", "images_s")},
        "resnet50_unfused_bf16": {
            layout: {k: row[k] for k in ("batch", "step_ms", "images_s",
                                         "peak_bytes", "idle")}
            for layout, row in bench.items()},
        "mlp_bf16": {k: mlp[k] for k in ("batch", "step_ms", "images_s",
                                         "peak_bytes", "idle")},
        "bert_bf16": {row: {k: r[k] for k in (
            "batch", "t", "step_ms", "sequences_s", "peak_bytes", "idle",
            "device_ms", "unaligned_gemm_ms")}
            for row, r in bert["rows"].items()},
        "graph": {row: {k: v for k, v in r.items()
                        if k in ("k", "eager_ms", "graph_ms",
                                 "eager_device_ms", "graph_device_ms",
                                 "eager_idle", "graph_idle",
                                 "replay_span_ms", "eager_peak_bytes",
                                 "graph_peak_bytes")}
                  for row, r in graph.items() if isinstance(r, dict)
                  and "graph_ms" in r},
        "decode_step": {k: served["step_times"][k] for k in (
            "graph_ms", "eager_ms", "graph_device_ms", "eager_device_ms")},
        "prefill": {b: {k: r[k] for k in ("graph_ms", "eager_ms",
                                          "graph_device_ms",
                                          "eager_device_ms")}
                    for b, r in served["prefill"].items()},
        "ttft_ms": served["stats"]["ttft_ms"],
        "model_server": {dt: {k: server[dt][k] for k in (
            "memory", "warmup_s", "bucket_ms", "open_loop")}
            for dt in ("fp32", "bf16")},
        "registry": {k: registry[k] for k in (
            "sizes", "budget", "admit_bytes", "evictions", "swap",
            "warm_start")},
        "nd_gpt_fp32": {k: nd[k] for k in (
            "step_ms", "gluon_step_ms", "device_ms", "gluon_device_ms",
            "seconds")},
        "np_gpt_fp32": {k: nd["np"][k] for k in (
            "step_ms", "gluon_step_ms", "device_ms", "gluon_device_ms",
            "launches", "gluon_launches", "grad_worst_rel", "seconds")},
        "nd1x_bert_fp32": {k: bert["nd1x"][k] for k in (
            "step_ms", "pallas_step_ms", "xla_step_ms", "device_ms",
            "pallas_device_ms", "xla_device_ms", "grad_worst_rel",
            "seconds")},
        "bert_sparse_emb_fp32": {k: bert["sparse"]["bert"][k] for k in (
            "losses", "losses_after", "rows", "untouched_rows",
            "grad_rows_worst_rel", "grad_worst_rel", "param_worst_rel",
            "lazy_worst_rel",
            "lazy_update_ms", "dense_update_ms")},
        "csr_linear_1m": {k: bert["sparse"]["csr"][k] for k in (
            "rows", "features", "nnz", "losses", "products_worst_rel",
            "dot_ms", "dot_t_ms", "library_dot_ms", "library_dot_t_ms")},
        "sparse_phase_s": bert["sparse"]["seconds"],
        "vision_fp32": {name: {k: r[k] for k in (
            "batch", "lr", "step_ms", "images_s", "device_ms", "idle",
            "peak_bytes", "launches", "depthwise_ms", "losses", "top",
            "inventory", "seconds")} | {"parity": {
                k: r["parity"][k] for k in ("eval_err", "train_err",
                                            "grad_worst", "held",
                                            "seconds")}}
            for name, r in vision["models"].items()},
        "gpt_clip_fp32": {k: vision["clip"][k] for k in (
            "steps", "n_grads", "device_ms", "plain_device_ms", "launches",
            "plain_launches", "host_ms", "plain_host_ms", "seconds")},
        "vision_cases": vision["vision_cases"],
        "vision_phase_s": vision["seconds"],
        "hybrid_gpt": {name: {k: v for k, v in row.items()
                              if not k.endswith("routes")}
                       for name, row in hybrid["gpt"].items()},
        "hybrid_export": {k: hybrid[k] for k in ("resnet", "control")}
        | {"attention": {k: v for k, v in hybrid["attention"].items()
                         if k != "routes"}},
        "hybrid_phase_s": hybrid["seconds"],
        "amp_gpt_bf16": {k: ssd_amp["amp"].get(k) for k in (
            "losses", "step_ms", "tokens_s", "device_ms", "cpu_loss_rel",
            "cpu_grad_worst", "fp16_loss", "fp16_scale",
            "overflow_scale")},
        "multi_precision": ssd_amp["multi_precision"],
        "optimizers": ssd_amp["optimizers"],
        "ssd300_bf16": {k: ssd_amp["ssd"].get(k) for k in (
            "batch", "anchors", "losses", "eager_ms", "graph_ms",
            "eager_images_s", "graph_images_s", "eager_device_ms",
            "graph_device_ms", "top_kernels", "amp_losses",
            "detections_kept", "detection_ms", "box_nms_ms")},
        "ssd_amp_phase_s": ssd_amp["seconds"]}),
        flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
