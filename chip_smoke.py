#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``iseg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --profile  # and torch.profiler tables of the resident ResNet step and
                                     # its input stage, of the MobileNetV2, Swin,
                                     # InternImage and HRNet train steps and of Gemma's
                                     # beam-4 decode steps (phase 12 always prints its
                                     # ViT-L and EVA02-L steps' tables)
    python3 chip_smoke.py --ab OLD   # OLD's kernels and this tree's, timed in turns

Drives the port's main paths at full width, with random weights from
seed 0. Four train and serve a segmentation model on one fixed synthetic
batch each (the ResNet one also through the training system, from shards
on the card: phase 5b; the MobileNetV2 one also through the example
scripts: phase 5c):

* ResNet: bench.py's headline training configuration, ResNet-50 (output
  stride 16, deep stem, slim stacks, multi-grid) + ASPP(256), 21 classes,
  512x512, batch 16;
* Swin: ``swin_large`` + ``SemanticFPN(256)``, 19 classes, 512x512, batch 8,
  default drop-path rate, then served multi-scale + flip + sliding window;
* InternImage: ``intern_image_tiny`` (DCNv3, ``dcn_sampling="auto"``, no
  remat) + ASPP(256), 19 classes, 512x512, batch 8, default drop-path rate,
  then served the same way;
* MobileNetV2: BASELINE config #1, ``mobilenetv2`` (width 1.0, output
  stride 16, the 1280-wide top conv) + ``SimpleDecoder(256, 48)``, 21
  classes, 512x512, batch 8, its logits at output stride 4;
* HRNet: BASELINE config #3, ``hrnet_w48`` + ``JPU(512)`` (the os8, os16
  and os32 branches), 19 classes, 512x512, batch 8, its logits at the JPU's
  output stride 8 (phase 11);
* ViT-L: BASELINE config #4's ``vit_large_patch16`` (24 blocks, width 1024,
  16 heads, 1025 tokens at 512x512, the pos-embed resampled 24 -> 32) +
  ASPP(256), 19 classes, batch 8, its logits at the patch's os16 (phase 12);
* ConvNeXt-L + FaPN: ``convnext_large`` (os32, drop-path rate 0.4) +
  ``FAPN()``, 19 classes, Cityscapes' 512x1024 crops, batch 8, its logits at
  os4, and its 1024x2048 sliding-window eval (phase 13, with one train step
  each of Xception-65, EfficientNet-B7 + NAS-FPN, MOAT-4, MLP-Mixer-L/16
  and ConvNeXt-V2-L);

all under bf16 autocast with fp32 params, SGD (momentum 0.9, poly decay),
the loss taken by the fused upsample + CE CUDA kernels, Swin's window
attention by the window-attention CUDA kernels and DCNv3's sampling by the
dense-local CUDA kernels; Swin also trains in fp32 (phase 6b), its window
attention then on the split-TF32 kernels. BASELINE config #5,
``eva02_large_patch16_512_coco`` (ViT-L with 2-D RoPE, SwiGLU and q/v
biases) + ASPP(256), 150 classes, batch 4, trains with AdamW and layerwise
LR decay; above 64 classes its loss is the unfused resize + CE (phase 12).
Global attention (no TPU kernel computes it in the JAX package) that records
a gradient, as in the ViT-L, EVA02-L and MOAT train steps, runs in bf16 (or
fp32, in split TF32: phase 12.4, F1) without a mask on the global-attention
kernel pair
(``csrc/global_attention.cu``: blocks over query and key tiles, a
split fixed-order backward), with MOAT's relative bias on its bias form
(dbias summed over the batch rows in a fixed order); where none is
recorded (serving) it is ``F.scaled_dot_product_attention``. Another path serves a language model:

* Gemma: ``gemma_2b_en`` at its full width (hidden 2048, 8 heads over 1 KV
  head, head dim 256, FFN 16384, vocabulary 256000) with its depth cut from
  18 to 6 layers (1.185 B parameters), bf16 parameters and KV cache, built on
  the card;
  ``GemmaCausalLM.generate`` at batch 8, prompt 128, ``max_length`` 384,
  ``segment_len`` 256, with the beam search's per-step cache reorder by the
  cache-gather CUDA kernel.

Phases, by number; any failure raises and the script exits non-zero. They
run in this order: 1, 3-5, 5b, 5c, 1b, 2, then 6 onwards. Phases 3-5, 5b,
5c, 11 and 13 take cuDNN's heuristic conv algorithms (``cudnn.benchmark``
off: autotuning took 25-33 s of each of these models' few steps); the
others autotune.

1. device: require CUDA; print the card, its power limit, the torch and
   CUDA versions; in a clean build directory, start ``window_attention.cu``'s
   and ``global_attention.cu``'s nvcc (the longest builds) on a thread of
   their own, then build the other three kernel sources of
   ``iseg_tpu_torch/csrc`` (one nvcc each, started together) and print
   their build times and ptxas reports; phases 3-5c, which launch no
   window-attention or global-attention kernel, run while those build;
1b. wait for the ``window_attention.cu`` and ``global_attention.cu`` builds
   and print their times and ptxas reports;
2. kernels vs their plain versions at the main paths' shapes, with median
   CUDA-event times (the host's dispatch of a call is in them where the
   device waits for it), each kernel's bound on this card, and for window
   attention ``F.scaled_dot_product_attention`` as a yardstick (timed here,
   used nowhere in the port); beside the window-attention, dense-local and
   upsample + CE rows and SDPA's, ``device_ms``: torch.profiler's device time
   per call over the same reps, the device's work alone (where the profiler
   records no device activity, CUDA events around calls queued behind a
   device hold; ``device_timer`` in the kernels line names the timer; that
   second timer, ``held_ms``, runs beside it on every window-attention
   forward, dense-local backward and upsample + CE row). Upsample + CE at
   [16,32,32,21] -> [16,512,512], [8,128,128,19] -> [8,512,512],
   [8,16,16,19] -> [8,512,512], [8,128,128,21] -> [8,512,512], [8,64,64,19] -> [8,512,512]
   (HRNet + JPU), [8,32,32,19] -> [8,512,512] (ViT-L), [8,128,256,19] -> [8,512,1024]
   (ConvNeXt-L + FaPN) and [16,32,32,21] -> [16,512,512] again (Xception-65 + ASPP),
   with the forward's two kernels' and the backward kernel's own device time (``kernel_device_ms``) and the unfused pair ``F.interpolate`` +
   ``F.cross_entropy`` timed beside it (``library_pair_ms``: two calls, so
   ``library_ms`` stays null), and fused against unfused printed at each
   shape; window attention forward and backward at Swin-L's four stage
   shapes, shifted and unshifted, f32 and bf16 (bf16 forward and backward on
   the tensor cores, f32 on the tensor cores in split TF32; the route of each
   is checked), and at window 12 (N = 144: ``swin_large_384``'s four stage
   shapes at the same input; the f32 backward there is the split-TF32 kernel
   that forms each warp's query rows, then its keys, from the forward's
   lse), the streaming kernels (every f32 and bf16 shape with D <= 128 that
   the tensor-core routes do not take) at window 12 with 64-wide heads in f32
   (behind the N > 64 split-TF32 forward) and bf16 (behind the tensor-core
   forward), bf16 D = 128 there, f32 D = 36 there (no multiple of 8), window
   16 (N = 256: phase 6d's stage 0 and 2 shapes) in both types and bf16
   window 7 with D = 24, each route asserted and each run repeated bit for
   bit, and the CUDA-core forward and backward at heads wider than 128 (D =
   136, N = 49), the shapes they keep (every f32 row bound at the split-TF32
   rate); SDPA at ViT-L's shape under
   ``torch.use_deterministic_algorithms(True)`` (whether its backward runs
   there and repeats bit for bit: a yardstick); the global-attention kernel
   pair (the route of global attention with a gradient and without a mask)
   at ViT-L's [8,16,1025,64], EVA02-L's patch-dropped [4,16,769,64] and
   MOAT-4's stage 2 [2,32,1024,32] in bf16 and in fp32 (its split-TF32
   form; MOAT-4's fp32 row with the relative bias only), and its bias form
   at MOAT-4 stage 2 with the relative bias in both types (dbias to 1e-3 in
   bf16, 1e-4 in fp32), on [B, T, H, D] views of the packed projection,
   against its plain version, each run repeated bit for bit, with SDPA
   beside each (in the row's type; the bias as its additive mask), SDPA
   under deterministic algorithms beside the bf16 rows and, beside the
   biased and fp32 rows, the streaming window-attention pair (built with
   both operands, zero ones standing in: where such a call went before;
   device time, yardsticks); dense-local sampling forward and all four
   gradients at InternImage-T's four stage shapes, in f32 and in the
   autocast type mix (bf16 values on a transposed view, fp32 offsets, bf16
   modulation), with offsets drawn beyond the clamp, and the backward's
   map-gradient kernel alone beside its own bound (``maps_kernel``); the
   beam cache gather,
   bitwise, at the Gemma path's active-cache shapes [8, nb, 6, 2, W, 1, 256]
   bf16 and at Gemma-2B's full depth [8, nb, 18, 2, W, 1, 256] (nb 4 and 2, W
   256 and 512) and at one odd f32 slab, with the
   advanced-indexing gather (its plain version), ``torch.take_along_dim``,
   ``torch.index_select`` of whole rows and ``out.copy_(cache)`` timed
   beside it (the kernel, ``index_select`` and ``copy_`` also by the
   profiler's device time, without the host's dispatch);
3. ResNet train: 2 warm-up + 3 timed fused steps; losses finite, exactly
   one forward and one backward loss-kernel launch per step;
4. ResNet fused vs unfused: one unfused step from the same initial weights
   and dropout draw gives the fused first step's loss; then its ms/step;
5. ResNet serve: single-scale inference with the trained weights agrees
   with the fused model's low-resolution logits;
5b. system: the ResNet configuration trained as a user of the library
   trains it. ``write_shards`` writes 96 synthetic samples at 640x640 (21
   classes, 157 MB of uint8), ``DeviceResidentDataset`` uploads them, and
   ``CoreTrain`` trains 3 epochs x 3 steps from them, each step a gather of
   the batch on the card, the device augment (scale 0.5-2.0 in steps of
   0.25, 512x512 crop, flip, then the zero-mean normalization) and the
   step, with ``ModelHelper(max_to_keep=2)`` and a scalar log: exactly 1 + 1
   loss-kernel launches a step, finite losses, checkpoints at steps 6 and 9
   only, the event file read back; ms/step and img/s after the first epoch
   against phase 3's fixed batch, checkpoint save and restore seconds, peak
   memory. A fresh trainer restores step 9 with every param, BN statistic
   and momentum buffer equal bit for bit. A run from scratch sends itself
   SIGTERM before its 5th batch, stops with a checkpoint at step 5, and a
   fresh trainer resumes it to step 9 on the uninterrupted run's index
   vectors, exactly, with its losses (rtol 1e-3). The shards streamed from
   the host (``make_shard_dataset_fn`` + ``device_prefetch``) and the
   resident path, both without augment, give the same first-step loss
   (rtol 1e-5). ``evaluate`` over 16 samples at 640x640, batch 2, scales
   (0.75, 1.0) + flip + 512x512 sliding window, with the variables
   restored by ``restore_latest_variables``: its confusion matrix counts
   every labelled pixel, and its mIoU, per-class IoU and confusion matrix
   equal ``MeanIoU`` over ``SegBase.inference`` logits of the same batches;
   ms per eval batch;
5c. examples: (1) the MobileNetV2 step on a fixed batch, 2 warm-up + 5
   timed fused steps: exactly 1 + 1 loss-kernel launches a step, finite
   losses, the first step's loss against an unfused step from the same
   weights (rtol 1e-4), ms/step, img/s, peak memory (``--profile``: device
   time by kernel class and busy share); (2) ``train_seg.main`` in this
   process on its synthetic data (config #1, fused loss, 2 epochs x 4
   steps, eval at (0.75, 1.0) + flip), then rerun to 3 epochs: it resumes
   at step 8 and ends at 12 with checkpoints 8 and 12, 1 + 1 launches a
   step, finite losses and mIoU, and its ms/step (host augment included)
   beside (1)'s; (3) config #2 through the same script (ResNet-50 + ASPP,
   ``--ohem --fused_loss``, batch 16, 3 steps): no fused-loss launch (OHEM
   gates the kernels off), finite losses; then each OHEM selector's valid,
   hard and kept pixels at the seed-0 model's logits (step 1), and on a
   fixed batch where the selectors choose (at ``min_kept`` 100000 and
   2000000) its loss on the card against the CPU port's on the same logits
   and labels (rtol 1e-5); (4) ``evaluate`` of (2)'s checkpoint over eight VOC-like images
   (500x375, 375x500, 500x333, 480x360, two each; batch 1,
   ``bucket_multiple`` 32, scales (0.75, 1.0) + flip) and over one
   1024x2048 image (scales (0.75, 1.0, 1.25) + flip, 512x512 sliding
   window), each with ``use_cpu_cache`` off and on: equal confusion
   matrices (or a parted argmax only on a near-tie), ``last_num_programs``
   equal to ``bucket_stats``' count, ms per image and peak device memory of
   each way; (5) ``default_image_predict`` over a bucketed batch equals the
   argmax of ``SegBase.inference``, and ``predict_with_dir`` over a
   directory of 3 seeded 375x500 PNGs writes label PNGs that, read back,
   equal ``default_image_predict``'s argmax of the same padded batch (where
   PIL imports; else one line says it did not run); (6) ``verify_drive.main(["--device",
   "cuda"])``: mIoU > 0.7 and a fresh trainer restores step 100. Steps
   (2)-(6) meet many input shapes and run on cuDNN's heuristics
   (``cudnn.benchmark`` off, restored after);
6. Swin train: 2 warm-up + 5 timed steps; losses finite; per step exactly
   24 tensor-core window-attention forward and 24 tensor-core backward
   launches (none of the CUDA-core kernels: autocast gives bf16 q, k, v) and
   1 + 1 loss kernel launches; ms/step, img/s, peak memory;
6b. Swin train in fp32: the same model, batch and data with
   ``compute_dtype=torch.float32`` (no autocast, fp32 parameters, TF32 off),
   2 warm-up + 3 timed steps; losses finite; in every step exactly 24
   split-TF32 window-attention forward and 24 backward launches (none of
   the CUDA-core or bf16 kernels) and 1 + 1 loss kernel launches; the first
   step's loss within rtol 1e-4 of the same model, weights and drop-path
   draws on the plain window attention; ms/step, img/s, peak memory;
6c. ``swin_large_384`` (window 12, N = 144) + ``SemanticFPN(256)`` trained in
   fp32 as 6b, the same batch and data: in every step exactly 24 split-TF32
   window-attention forward and 24 backward launches (the backward the
   window-12 kernel), none of the CUDA-core or bf16 kernels, 1 + 1 loss
   kernel launches; the first step's loss within rtol 1e-4 of the same model,
   weights and drop-path draws on the plain window attention; ms/step, img/s,
   peak memory (``--ab OLD --only wa12`` times the step and its window
   attention against OLD's);
6d. Swin-L's widths (192, depths (2, 2, 18, 2), heads (6, 12, 24, 48)) at
   window 16 (N = 256, D = 32: Swin V2's window) + ``SemanticFPN(256)``, the
   Swin path's batch, data and bf16 autocast, SGD poly: one eval-mode bf16
   forward at batch 2 on the streaming kernels within max(2 x the bf16 plain
   run's distance, 2e-2) of max |logit| of the same weights in fp32 on the
   plain window attention; 2 warm-up + 3 timed steps with exactly 24
   streaming forward and 24 streaming backward launches in every step (no
   other window-attention kernel) and 1 + 1 loss launches; ms/step, peak
   memory, and one profiled step: the streaming kernels' device ms and
   share;
7. Swin serve, batch 2, trained weights: the bf16 single-scale logits with
   the kernels lie within max(2 x the bf16 network's own distance, 2e-2) of
   max |logit| from the same weights served in fp32 on the plain versions
   (TF32 off; the bf16 serve on the plain versions gives the noise), and a
   planted fault (the kernels' forward with the shift mask dropped) lies
   beyond that bound; the distance of the kernel run repeated, of the plain
   run on cuDNN's heuristics and the trained weights' sums are printed
   beside it (fault F2: what spreads the distance between calls); multi-scale
   (0.75, 1.0) + flip + sliding window (384x384 crops) gives finite fp32
   [2,512,512,19] logits; window batch 1 and 2 agree; confusion matrix and
   mIoU against the synthetic labels count every pixel; tensor-core forward
   launches are 24 per model call, and no other window-attention kernel is
   launched;
8. InternImage train: 2 warm-up + 5 timed steps; losses finite and falling
   on the fixed batch; per step exactly 30 dense-local forward and 30
   backward launches and 1 + 1 loss kernel launches; ms/step, img/s, peak
   memory;
9. InternImage serve, batch 2, trained weights: as phase 7, with 30
   dense-local forward launches per model call and no backward launch; the
   planted fault there (and in 14.4's serve): the kernels' offsets with
   their two axes swapped;
10. Gemma serve: (a) a SentencePiece vocabulary built in memory (specials,
    byte pieces, a few words, unused pieces up to 256000) -> ``GemmaTokenizer``
    -> ``GemmaCausalLMPreprocessor`` -> ragged prompts -> greedy ``generate``
    -> ``generate_postprocess`` gives strings that start with their prompts;
    (b) greedy, beam 2, beam 4 and contrastive (k = 5) requests at the
    geometry above, one warm-up call each (the contrastive one 8 steps
    long), then timed: prompts preserved,
    ids in range, tok/s, ms/step, peak memory; exactly ``max_length - start``
    = 256 cache-gather launches per beam request and none on the others;
    (c) beam 4 with the gather's plain version swapped in gives the kernel
    run's tokens exactly; the context-segment decode and the monolithic
    decode, fed the segmented search's tokens over all 256 steps (the active
    cache growing from 256 to 512 slots on the way), give logits within 2e-2
    of max |logit|; beam 4 on the monolithic cache (plain gather of the
    whole cache, no launch) selects the segmented search's continuations
    step by step until a bf16 near-tie falls the other way: the step is
    named and the tie held to 1e-2 of max |logit| in nats, and rows that
    never part return equal tokens; (d) beam 1 returns greedy's tokens, or
    parts from them at a near-tie held the same way;
11. HRNet (BASELINE config #3): (1) the fixed-batch step as in 5c.1 (SGD
    poly, 2 warm-up + 5 timed steps, exactly 1 + 1 loss-kernel launches a
    step, the first step's loss against an unfused step from the same
    weights at rtol 1e-4, ms/step, img/s, peak memory; ``--profile``: device
    time by kernel class and busy share); (2) the same model with an aux
    logits conv on the os32 branch (rate 0.4) through ``CoreTrain``:
    ``with_grad_accum(get_optimizer(..., "adamw", decay_strategy="cosine",
    warmup_steps=2, weight_decay=1e-4), every=2)``, EMA 0.999, batch 4 a
    micro-step, 8 micro-steps: exactly 2 + 2 loss-kernel launches in every
    micro-step (main output at os8, aux at os32), finite losses, params and
    EMA kept on the odd micro-steps, the params moved on the even ones
    (but the first real update, which optax's warmup gives LR 0) and the
    EMA decayed there by its rule; a run stopped by SIGTERM after
    micro-step 3 (the accumulator half full) and resumed by a fresh
    trainer to micro-step 8 equals the uninterrupted run in every param,
    EMA, BN statistic, accumulator and Adam moment (bit for bit, or rtol
    1e-5 where cuDNN picked other algorithms, which is then printed); (3)
    ``train_seg.main`` with ``--backbone hrnet_w48 --head jpu --optimizer
    adamw --fused_loss``, 1 epoch x 3 steps, eval at scale 1.0: finite loss
    and mIoU, 1 + 1 launches a step; (4) the sliding-window serve of
    ``bench.py``'s ``sliding_hrnet`` with (1)'s weights: one 1024x2048 image,
    512x512 windows at stride 2/3 (18 model calls), bf16, one warm-up then 3
    timed calls: p50 / min / max seconds (host clock) printed in
    ``bench.py``'s JSON schema, peak memory, finite fp32 [1,1024,2048,19]
    logits, window batch 1 and 2 within 2e-2 of max |logit| in fp32 (in bf16
    they part by the bf16 network's own noise, printed), each bf16 run
    within 5e-2 of max |logit| of the fp32 run, no kernel launched;
12. ViT-L and EVA02-L (BASELINE configs #4 and #5): (1) the ViT-L step on
    a fixed batch (SGD poly, 2 warm-up + 5 timed steps, exactly 1 + 1
    loss-kernel launches and 24 + 24 launches of the global-attention
    kernel pair, its global attention, in every step), ms/step,
    img/s, peak memory, then
    3 profiled steps: device ms by kernel class, the top kernels and the
    busy share; (2) the EVA02-L step the same way (AdamW, decoupled decay
    0.05, the layerwise LR multipliers 0.9 ** (24 - (i + 1)) over the
    blocks ``Eva.layer_name_pattern`` names; no fused-loss launch and 24 +
    24 global-attention launches in every step), then one step with
    patch dropout 0.25: 769 of 1025 tokens through the blocks, a finite
    loss; (4) the ViT-L step in fp32 (TF32 off, 2 + 3 steps, exactly 1 + 1
    loss-kernel launches and 24 + 24 of the pair's fp32 form in every
    step), ms/step, peak memory and a 3-step profile: device ms, the
    pair's device ms and share, the busy share; (3) both models served with their trained weights by
    ``SegBase.inference`` at batch 2, scales (0.75, 1.0) + flip, bf16: one
    warm-up and 7 timed calls (p50 / min / max ms, host clock, printed in
    ``bench.py``'s JSON schema), 4 model calls a request, finite fp32
    [2,512,512,C] logits, no kernel launched; then one image's fp32 logits
    on the card (SDPA) within 1e-3 of max |logit| of the CPU port's (the
    plain attention) with the same weights;
13. the rest of the backbone zoo and heads: (1) ConvNeXt-L (output stride
    32, drop-path rate 0.4) + ``FAPN()`` (filters 128, the coarsest level
    raw; DCNv2 alignment), 19 classes, Cityscapes' 512x1024 crops, batch 8,
    SGD poly, 2 warm-up + 5 timed steps with exactly 1 + 1 loss-kernel
    launches in every step (logits at os4: ``[8,128,256,19]`` ->
    ``[8,512,1024]``), ms/step, img/s, peak memory, then 3 profiled steps
    (device ms by kernel class, top kernels, busy share); (2) its Cityscapes
    eval with (1)'s weights: one 1024x2048 image through 512x1024 windows at
    stride 2/3 (9 model calls), bf16, one warm-up then 5 timed calls: p50 /
    min / max seconds (host clock) in ``bench.py``'s JSON schema
    (``convnext_l_fapn_sliding_window_1024x2048_eval``), peak memory, finite
    fp32 [1,1024,2048,19] logits, no kernel launched; (3) one 256x512 image's
    fp32 logits on the card (TF32 off) within 1e-5 of max |logit| of the CPU
    port's, (1)'s weights; (4) Xception-65 (os16) + ASPP(256), 21 classes,
    512x512, batch 16 (DeepLabV3 on VOC): 1 warm-up + 3 timed steps, 1 + 1
    launches each; (5) one warm-up and one timed step at 512x512, batch 2,
    19 classes, each: EfficientNet-B7 (os32) + NAS-FPN(256), MOAT-4 + ASPP,
    MLP-Mixer-L/16 (built for 512x512) + ASPP, ConvNeXt-V2-L (os32) +
    SemanticFPN: wall ms, peak memory, finite losses, 1 + 1 launches a step
    (and MOAT-4's 30 + 30 launches of the global-attention pair, one a MOAT
    block each way).
    (4) and (5) take cuDNN's heuristic conv algorithms (no autotuning:
    their few steps would spend most of their time timing algorithms);
14. pretrained weights: (1) a flat dict of ResNet-50's published names and
    shapes (``tests/data/ref_weights/resnet50.txt``, values from seed 0)
    ingested into phase 3's ResNet-50 os16 + ASPP on the card by
    ``keras_resnet_name_map``: no backbone leaf unmatched, and one 256x256
    image's fp32 logits within 1e-5 of max |logit| of the CPU port's ingest
    of the same dict; (2) ``load_pretrained_backbone("intern_image_tiny")``
    from InternImage-T's published names and shapes, the offset heads set
    per stage, calibrated on a seeded batch of 2 at 512x512: stage 0 at r =
    2, stage 1 at r = 4, stage 2 at r = 6, stage 3 on the gather sampler,
    the table of blocks per (mode, r) printed; (3) one 512x512 image in
    fp32: the calibrated backbone (the dense-local kernels at those radii,
    26 launches) within 1e-5 of each max |output| of the same weights on
    the gather sampler, the uncalibrated r = 2 model's gap printed; (4) the
    calibrated model + ASPP(256), 19 classes, batch 8, bf16, SGD poly, fused
    loss: 2 warm-up + 3 timed steps with exactly 26 + 26 dense-local and
    1 + 1 loss launches in every step, ms/step, img/s, peak memory, then
    served as phase 9 serves; (5) the dense-local kernels at stage 2's
    shape in the autocast type mix at r = 1, 4 and 6 against their plain
    versions, their rows added to the kernels line; (6) ``label_components``
    on 8 random-blob 512x512 masks and one 512x512 serpentine, 4- and
    8-connectivity: labels on the card equal the CPU port's, ms and
    iterations printed;
15. data parallelism, each rank a process spawned here (``rank_main``,
    joined with a time limit; a rank that fails or hangs fails the phase and
    the others are killed): (1) phase 3's ResNet configuration from seed-0
    weights over a global batch of 16 at world size 2, both ranks on this
    card over gloo, SyncBN, the fused loss and SGD poly; the batch's two
    halves have 50% and 5% of their pixels ignored (a mean of the halves'
    own means is printed beside the global loss); in fp32 (TF32 off) the
    first DP loss within rtol 1e-5 of one process's on the whole batch, the
    state after steps 1 and 3 within fixed bounds (``DP_STATE_RTOL``, max
    |diff| over max |value|) of one process's whose BatchNorm takes its
    moments with SyncBN's arithmetic, while the same steps with a fault
    planted (the loss as the mean of the ranks' means; SyncBN's backward
    without its all-reduce) lie past the step-1 bound, the two ranks'
    states equal bit for bit (sha256) after every step, 1 + 1 loss-kernel
    launches a rank a step; then 3 bf16 steps' ms/step, two processes
    sharing one card (not a scaling number); (2) world size 1 on NCCL
    through ``common_env_setup(initialize_distributed=True)``: two bf16
    steps equal the steps without a group bit for bit, and ``shard_fsdp``'s
    steps the DP steps (first loss equal, params within 1e-6 of max
    |param|); (3) ``DeviceResidentDataset(mesh=)`` over 96 shards at 640^2,
    48 a rank: the first fp32 resident step (device augment) within rtol
    1e-5 of world size 1's; (4) sharded ``evaluate`` (8 images, 4 a rank)
    gives world size 1's confusion matrix (its logits within every top-two
    gap), and ``inference_with_sliding_window_sharded`` on one 1024x2048
    image (512x512 windows at stride 2/3, 9 a rank) lies within 1e-5 of
    max |logit| of the unsharded window; gloo's host-staged collectives are
    counted and printed;
F1. fixed-order resizes and global-attention backwards: under cuDNN's
    deterministic algorithms and PyTorch's deterministic mode, two runs of 3
    steps each of the Swin-L + SemanticFPN, ViT-L + ASPP (batch 8),
    EVA02-L + ASPP (AdamW, 150 classes, the unfused loss, patch dropout
    0.25), MOAT-4 + ASPP (batch 2, with its relative-position bias),
    ViT-L + ASPP in fp32, MOAT-4 + ASPP in fp32 with its bias and
    MobileNetV2 + SimpleDecoder steps end with equal states and losses bit
    for bit, the global attention's backward on the global-attention pair
    (ViT-L and EVA02-L: 24 + 24 launches a step; MOAT-4 with its bias: 30 +
    30 of the pair's bias form; the fp32 steps the same counts of the fp32
    forms; none of another form or the streaming pair, no SDPA backend
    chosen); each step's ms printed. Phase 16.3
    runs its pipeline-parallel train step twice the same way: the losses
    and every gradient equal bit for bit.
16. the language model's distribution, two ranks spawned here on this card
    over gloo (``rank_lm``; correctness runs, not scaling numbers): (1)
    tensor-parallel serving of ``gemma_7b_en`` at full width, its depth cut
    from 28 to 4 layers (bf16) at model parallelism 2, each rank
    seeding its shard of the same full weights (``init_seeded_shard``): a
    greedy and a beam-4 request (batch 4, prompt 128, ``max_length`` 192),
    the ranks' tokens equal, one cache-gather launch a decode step a rank,
    the prefill logits within 2e-2 of max |logit| of world size 1 (here,
    beforehand), ms/step and tok/s, host-staged collectives; the gather at
    the rank's cache shape against its plain version, bitwise; (2) sequence
    parallelism of ``gemma_2b_en`` (6 of its 18 layers, bf16, batch 2 x T
    2048, seq axis 2; its train step takes the grouped products at head dim
    256, a fixed order),
    allgather and ring: ``score``, the loss and every gradient leaf against
    world size 1 within ``SP_SCORE_RTOL`` / ``SP_GRAD_RTOL`` (about twice
    the bf16 run's own distance from fp32, measured and printed), one
    rotation a layer in a ring forward; (3) the pipeline-parallel loss of
    ``gemma_2b_en`` (fp32, 2 stages of 9 layers, 4 microbatches, batch 8 x T
    512, layers recomputed in the backward): loss, every gradient and one
    SGD step within 1e-4 of one process's, every leaf a rank holds (its
    stage's layers and the shared ones) given its gradient; (4) the MoE layer (hidden 2048, 8 experts of d_ff 2048,
    k 2, 4096 tokens, fp32) with its experts over the two ranks, output and
    gradients within 1e-5 of world size 1.
17. int8 serving and the serving export: (1) phase 10's model (``gemma_2b_en``
    at full width, 6 layers, bf16, seed 0) quantized on the card both ways
    (``quantize_tree``: weight-only; ``quantize_dense_tree``: W8A8) and
    loaded by ``load_flax``; batch 8, prompt 128, greedy and beam 4 to
    ``max_length`` 256 (phase 10's 384 cut to fit the run's time), each
    after an 8-step warm-up, for the bf16 model and both int8 ones: tok/s,
    ms/step, peak memory and resident weight bytes; one cache-gather launch
    a beam decode step and none in greedy; the prompts kept; the
    weight-only greedy tokens equal to those of the same weights explicitly
    dequantized into a bf16 model; W8A8's prefill logits within 4x the
    weight-only model's distance from the bf16 run (the int8 weights' own
    noise, in max |logit|), the same with a planted fault (each product's
    weight scales in reverse column order) beyond it; ``torch._int_mm``'s
    device time at the decode products' shapes (8 and 32 rows) beside bf16
    ``F.linear`` and the whole W8A8 product. (2) Swin-L's widths and window
    at depths (2, 2, 2, 2) + SemanticFPN (19 classes, 512x512, seed-17
    weights) exported by ``export_inference``
    with scales (0.75, 1.0) + flip under bf16 autocast, batch-polymorphic;
    a fresh process that imports no backbone, head or model code loads it
    and serves batches 1 and 2: exactly 24 tensor-core window-attention
    launches a serve (12 a forward, one forward a scale) and nothing else,
    logits within 2e-2 of max |logit| of the live bf16 serve; export and
    load seconds, artifact MB, serve p50 against the live serve's; then the
    example driver ``examples/export_serving.py`` exports MobileNetV2 +
    SimpleDecoder (512x512, 21 classes) with and without ``--int8`` and
    serves each artifact (two PNGs when PIL is there): the int8 artifact
    below 0.75 of the float one.

Every phase prints its seconds, and the run their sum.

``--ab OLD`` runs none of the phases. OLD is another checkout of the repo
(for example the parent commit's ``git archive`` unpacked into the
git-ignored ``_checkout/v1``). It runs OLD, this tree, this tree, OLD, each
in a process of its own with that tree's ``iseg_tpu_torch`` and this file's
code, so one timer serves both: the bf16 window-attention forward (both
timers) and backward at Swin-L's four stage shapes (shifted) with SDPA's
beside them, the fp32 forward and backward there (profiler device time:
the split-TF32 kernels in this tree, the CUDA-core ones in a tree from
before them) with SDPA's, the dense-local forward and backward at InternImage-T's four
stage shapes in the autocast type mix (all three timers) and the backward's
map-gradient kernel alone (profiler), the fused loss forward and backward
at the three paths' shapes (all three timers, and the forward's two kernels
and the backward's kernel alone) with the unfused pair's forward and
backward beside them, the cache gather at Gemma-2B's four active-cache
shapes with ``index_select`` beside it, and the ResNet, Swin and InternImage
train steps (2 warm-up + 3 or 5 timed steps each, then 3 profiled: the
step's device time and its loss kernels', the loss forward's,
window-attention and dense-local kernels', the dense-local forward's too),
the dense-local backward and its d_x kernel alone at r = 4 and 6 on stages
0-2, the InternImage step with phase 14's calibrated sampling (stage 0 at
r = 2, stage 1 at r = 4, stage 2 at r = 6, stage 3 gathered; random
weights),
and the fp32 Swin train step (2 + 3, then 3 profiled: its device time and
its window-attention kernels' time and share). ``--ab OLD --only wa12``
times the fp32 window attention at window 12 instead (``swin_large_384``'s
four stage shapes, shifted, forward and backward, and the forward at D = 64;
SDPA beside each; profiler device time) and phase 6c's fp32 step (2 + 3,
then 3 profiled: ms/step, device time, the window attention's time and
share, peak memory).
The last line holds each number of the four processes, OLD's two and this
tree's two. ``--ab OLD --only f1`` times phase F1's five steps alone (a
tree without the kernel route for global attention runs EVA02-L on SDPA's
math backend and ViT-L and MOAT-4 on the default SDPA, as it did).
``--ab OLD --only vit32`` times phase 12.4's fp32 ViT-L step (2 + 3, then 3
profiled: ms/step, device time, the global attention's device time and
share) and fp32 global attention with a gradient at phase 2's fp32 rows
(``dot_product_attention``'s route: the pair here, the streaming pair in a
tree from before its fp32 form; profiler device time).
``--ab OLD --only stream`` times phase 2's streaming rows (forward and
backward, SDPA beside each, profiler device time): the D = 36 pair, which a
tree from before the streaming kernels runs on its CUDA-core kernels, and
the rows where such a tree raises, which it records as raised.

The launch counters are set to 0 just before each main path (3, 5b's
uninterrupted run, 5c's fixed-batch steps, its two train_seg runs together
and its OHEM run, 6, 6b, 6c, 6d (each step), 7, 8, 9, each request of 10, 11.1, each micro-step
of 11.2, its resumed run, 11.3 and 11.4, 12.1, 12.2 and 12.4 (and each of their
steps), the patch-dropout step and each serve of 12.3, 13.1, 13.2, 13.4 and
each model of 13.5, and each of their train steps, 14.3's forward, each train step and
each serve of 14.4, in each rank of 15.1 each step, in each rank of 16.1 each request,
each request of 17.1 and each serve of 17.2 in its serving process) and read just after;
a kernel of a path that was launched no time there fails the run. Third line from the end: a JSON object with one entry per kernel;
then the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import importlib.util
import json
import math
import os
import pathlib
import pickle
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

if __name__ == "__main__" and sys.argv[1:2] == ["--ab-child"]:
    sys.path.insert(0, sys.argv[2])  # that tree's package, timed by this file's code

from iseg_tpu_torch.backbones import get_backbone
from iseg_tpu_torch.backbones import swin as swin_module
from iseg_tpu_torch.convert import batch_stats_tree, flax_tree, load_flax, param_tree, to_flax
from iseg_tpu_torch.core.checkpoint import ModelHelper
from iseg_tpu_torch.core.env import EnvConfig, common_env_setup
from iseg_tpu_torch.core.evaluation import bucket_padder, evaluate, make_eval_step
from iseg_tpu_torch.core.export import export_inference
from iseg_tpu_torch.core.inference import inference_with_sliding_window, sliding_window_plan
from iseg_tpu_torch.core.model import SegManaged, SegModelInferenceConfig
from iseg_tpu_torch.core.optimizer import (Adam, get_optimizer, layerwise_decay_multipliers,
                                           warmup_poly_decay, weight_decay_mask,
                                           with_grad_accum)
from iseg_tpu_torch.core.predict import default_image_predict, predict_with_dir
from iseg_tpu_torch.core.train import (CoreTrain, create_train_state, make_resident_train_step,
                                       make_train_step)
from iseg_tpu_torch.data.device_augment import DeviceAugmentConfig, make_device_augment
from iseg_tpu_torch.data.input_norm import get_mean_pixel, normalize_input
from iseg_tpu_torch.data.resident import DeviceResidentDataset
from iseg_tpu_torch.data.shards import ShardReader, make_shard_dataset_fn, write_shards
from iseg_tpu_torch.examples import export_serving as export_serving_example
from iseg_tpu_torch.examples import train_seg as train_seg_example
from iseg_tpu_torch.examples import verify_drive as verify_drive_example
from iseg_tpu_torch.losses import cross_entropy_ignore_label, get_ohem_fn
from iseg_tpu_torch.metrics import MeanIoU
from iseg_tpu_torch.nlp.gemma import (BeamSampler, ContrastiveSampler, GemmaCausalLM,
                                      get_preset)
from iseg_tpu_torch.nlp.gemma import causal_lm as gemma_causal_lm
from iseg_tpu_torch.nlp.gemma import sp_model
from iseg_tpu_torch.nlp.gemma.tokenizer import GemmaCausalLMPreprocessor, GemmaTokenizer
from iseg_tpu_torch.nn import dcn as dcn_module
from iseg_tpu_torch.nn.blocks import Dropout, DropPath, set_dropout_generator
from iseg_tpu_torch.nn.heads import ASPP, SemanticFPN, SimpleDecoder
from iseg_tpu_torch.nn.initializers import initialize
from iseg_tpu_torch.ops.kernels import _build
from iseg_tpu_torch.ops.kernels import cache_gather as cg
from iseg_tpu_torch.ops.kernels import deform_local as dl
from iseg_tpu_torch.ops.kernels import upsample_ce as uce
from iseg_tpu_torch.ops.kernels import window_attention as wa
from iseg_tpu_torch.ops import quant as quant_module
from iseg_tpu_torch.ops.resize import resize_image
from iseg_tpu_torch.utils.buckets import bucket_hw, bucket_stats, pad_batch_to_bucket
from iseg_tpu_torch.utils.summary import read_event_scalars

# the global-attention kernels; an older tree that --ab times may lack them
GA_MODULE = "iseg_tpu_torch.ops.kernels.global_attention"
ga = importlib.import_module(GA_MODULE) if importlib.util.find_spec(GA_MODULE) else None

HW = 512
# ResNet path
R_BATCH, R_CLASSES, R_OS = 16, 21, 16
R_WARMUP, R_TIMED, R_UNFUSED_TIMED = 2, 3, 2
# system path (phase 5b): the ResNet configuration trained from shards
SYS_SAMPLES, SYS_STORE = 96, 640
SYS_EPOCHS, SYS_STEPS_PER_EPOCH = 3, 3
SYS_PREEMPT_BATCH = 5  # the preempted run sends itself SIGTERM before drawing this batch
SYS_EVAL_SAMPLES, SYS_EVAL_BATCH, SYS_EVAL_WINDOW = 16, 2, 512
# Swin path
S_BATCH, S_CLASSES, S_OS = 8, 19, 4
S_WARMUP, S_TIMED, S_SERVE_BATCH = 2, 5, 2
S_F32_TIMED = 3  # the fp32 train phase (6b)
WINDOW, HEAD_DIM = 7, 32
# Swin-L at 512x512, batch 8: (stage, window batch, heads, windows per image, blocks)
WA_STAGES = (("stage0", 2888, 6, 361, 2), ("stage1", 800, 12, 100, 2),
             ("stage2", 200, 24, 25, 18), ("stage3", 72, 48, 9, 2))
WA_LAUNCHES_PER_FORWARD = sum(s[4] for s in WA_STAGES)  # 24
# swin_large_384 (window 12, N = 144) at the same input: maps 128/64/32/16
# padded to 132/72/36/24; (stage, window batch, heads, windows per image)
WA12_STAGES = (("stage0", 968, 6, 121), ("stage1", 288, 12, 36), ("stage2", 72, 24, 9),
               ("stage3", 32, 48, 4))
# The streaming kernels' rows (off the paths above; window 16 is phase 6d's):
# (stage, window batch, heads, windows per image, window, head dim, dtype,
# (forward route, backward route)). fp32 at window 12 with 64-wide heads
# (Swin-L stage 2's width, 12 heads): the split-TF32 forward above N = 64 and
# the streaming backward; bf16 there: the tensor-core forward and the
# streaming backward; bf16 at D = 128, whose tensor-core tiles fit no block;
# fp32 at window 12 with a head dim that is no multiple of 8 (D = 36, the
# pair --ab --only stream times against the parent's CUDA-core kernels);
# window 16 (N = 256, Swin V2's geometry) at stages 0 and 2 of the 512x512,
# batch-8 input; bf16 at window 7 with D = 24 (no multiple of 16)
WA_STREAM_ROWS = (
    ("stage2", 72, 12, 9, 12, 64, torch.float32, ("tf32x3", "stream")),
    ("stage2", 72, 12, 9, 12, 64, torch.bfloat16, ("mma", "stream")),
    ("stage2", 72, 6, 9, 12, 128, torch.bfloat16, ("stream", "stream")),
    ("stage2", 72, 12, 9, 12, 36, torch.float32, ("stream", "stream")),
    ("stage0", 512, 6, 64, 16, 32, torch.float32, ("stream", "stream")),
    ("stage0", 512, 6, 64, 16, 32, torch.bfloat16, ("stream", "stream")),
    ("stage2", 32, 24, 4, 16, 32, torch.float32, ("stream", "stream")),
    ("stage2", 32, 24, 4, 16, 32, torch.bfloat16, ("stream", "stream")),
    ("stage2", 200, 24, 25, 7, 24, torch.bfloat16, ("stream", "stream")),
)
# heads wider than 128: the CUDA-core forward and backward, the one shape
# class they keep (off every main path)
WA_CUDA_CORE = ("stage2", 200, 2, 25, 7, 136, torch.float32, ("cuda_core", "cuda_core"))
# global attention with a gradient (the ViT-L, EVA02-L and MOAT train steps),
# q, k, v views of the packed qkv projection, on the global-attention pair
# (its bias form at MOAT's biased rows, its fp32 form at the fp32 rows).
# (title, batch, heads, tokens, head dim, dtype[, with MOAT's relative
# bias]): ViT-L's 1025 tokens at batch 8 in both types (phase 12.1 and
# 12.4), EVA02-L's 769 after patch dropout 0.25 at batch 4 in both types,
# MOAT-4's stage 2 (32 x 32 tokens, 32 heads of 32) at batch 2 without its
# relative bias (phase 13.5's) and with it in both types (phase F1's)
GA_ROWS = (
    ("ViT-L", 8, 16, 1025, 64, torch.bfloat16),
    ("ViT-L", 8, 16, 1025, 64, torch.float32),
    ("EVA02-L patch dropout", 4, 16, 769, 64, torch.bfloat16),
    ("EVA02-L patch dropout", 4, 16, 769, 64, torch.float32),
    ("MOAT-4 stage 2", 2, 32, 1024, 32, torch.bfloat16),
    ("MOAT-4 stage 2, relative-position bias", 2, 32, 1024, 32, torch.bfloat16, True),
    ("MOAT-4 stage 2, relative-position bias", 2, 32, 1024, 32, torch.float32, True),
)
# phase 6d: Swin-L's widths (192, depths (2, 2, 18, 2), heads (6, 12, 24, 48))
# at window 16 (N = 256, D = 32) + SemanticFPN(256), the Swin path's batch and
# data, bf16 autocast: every window attention on the streaming kernels
S16_WINDOW, S16_WARMUP, S16_TIMED = 16, 2, 3
# InternImage path
I_BATCH, I_CLASSES, I_OS = 8, 19, 32
I_WARMUP, I_TIMED, I_SERVE_BATCH = 2, 5, 2
DL_KERNEL, DL_MAX_OFFSET = 3, 2
# InternImage-T at 512x512, batch 8: (stage, map side, channels, groups, blocks)
DL_STAGES = (("stage0", 128, 64, 4, 4), ("stage1", 64, 128, 8, 4),
             ("stage2", 32, 256, 16, 18), ("stage3", 16, 512, 32, 4))
DL_LAUNCHES_PER_FORWARD = sum(s[4] for s in DL_STAGES)  # 30
# MobileNetV2 + SimpleDecoder path (phase 5c): BASELINE config #1, its logits at
# the decoder's output stride 4
M_BATCH, M_CLASSES, M_OS, M_LOGIT_OS = 8, 21, 16, 4
M_WARMUP, M_TIMED = 2, 5
EX_STEPS_PER_EPOCH = 4  # train_seg: 2 epochs, then rerun to 3 (resumed at step 8)
EX_OHEM_STEPS = 3  # config #2 with OHEM through train_seg
EX_OHEM_FILL_MIN_KEPT = 2_000_000  # more than the hard pixels: the hardest-k fill runs
EX_EVAL_SIZES = ((500, 375), (375, 500), (500, 333), (480, 360))  # VOC-like (H, W)
EX_BUCKET = 32
EX_BIG, EX_BIG_SCALES, EX_BIG_WINDOW = (1024, 2048), (0.75, 1.0, 1.25), 512
# 5c.5: predict_with_dir over a directory of this many seeded RGB PNGs of one
# VOC-like size (H, W), in one batch
EX_PREDICT_IMAGES, EX_PREDICT_HW = 3, (375, 500)
# HRNet path (phase 11): BASELINE config #3, HRNet-W48 + JPU(512), its logits at
# the JPU's os8, the aux logits at the os32 branch
H_BATCH, H_CLASSES, H_LOGIT_OS, H_AUX_RATE = 8, 19, 8, 0.4
H_WARMUP, H_TIMED = 2, 5
# 11.2: batch 4 a micro-step, a real update every 2, 8 micro-steps, the
# checkpoint after micro-step 3 (in the middle of an accumulation)
H_ACCUM_BATCH, H_ACCUM_EVERY, H_ACCUM_STEPS, H_ACCUM_SAVE_AT = 4, 2, 8, 3
H_TRAIN_SEG_STEPS = 3
# 11.4: bench.py's sliding_hrnet: 1024x2048, 512x512 windows at stride 2/3
# (3 x 6 = 18 model calls), one warm-up and 3 timed calls (7 before the run's
# time went to phase F1's new paths)
H_SLIDE_HW, H_SLIDE_WINDOW, H_SLIDE_REPS, H_SLIDE_CALLS = (1024, 2048), 512, 3, 18
# ViT path (phase 12.1): BASELINE config #4's ViT-L, vit_large_patch16 + ASPP(256) at the
# Swin path's geometry, its one endpoint and the logits at the patch size's os16
V_BATCH, V_CLASSES, V_OS = 8, 19, 16
V_WARMUP, V_TIMED = 2, 5
# the global attentions of a ViT-L or EVA02-L step (24 blocks), each one
# forward and one backward launch of the global-attention kernel pair (in
# fp32 of its fp32 form: phase 12.4)
T_GLOBAL_PER_STEP = {"global_attention_fwd": 24, "global_attention_bwd": 24}
T_GLOBAL_F32_PER_STEP = {"global_attention_fwd_f32": 24, "global_attention_bwd_f32": 24}
V_F32_WARMUP, V_F32_TIMED = 2, 3  # phase 12.4
# EVA path (phase 12.2): BASELINE config #5 as the JAX package's
# tools/bench_model_mfu.py has it, eva02_large_patch16_512_coco + ASPP(256), 150
# classes, batch 4 (the fused loss requested; above 64 classes it is the
# unfused resize + CE); AdamW with layerwise LR decay 0.9 over the 24 blocks
E_BATCH, E_CLASSES = 4, 150
E_WARMUP, E_TIMED = 2, 5
E_LAYER_DECAY, E_PATCH_DROPOUT = 0.9, 0.25
# 12.3: both models served at batch 2, scales (0.75, 1.0) + flip (384 and 512 are
# multiples of the patch), one warm-up and 7 timed calls
T_SERVE_BATCH, T_SERVE_SCALES, T_SERVE_REPS = 2, (0.75, 1.0), 7
# ConvNeXt-L + FaPN path (phase 13.1-13.3): Cityscapes' 512x1024 crops, batch 8,
# 19 classes, logits at FaPN's os4; the eval's one 1024x2048 image through
# 512x1024 windows (stride 2/3: 3 x 3 windows), 5 timed calls after a warm-up;
# the card against the CPU port on one 256x512 image in fp32
C_BATCH, C_CLASSES, C_HW, C_DROP_PATH = 8, 19, (512, 1024), 0.4
C_WARMUP, C_TIMED = 2, 5
C_SLIDE_HW, C_SLIDE_WINDOW, C_SLIDE_REPS = (1024, 2048), (512, 1024), 5
C_CPU_HW = (256, 512)
# Xception path (phase 13.4): DeepLabV3 on VOC, batch 16, 21 classes, os16
X_BATCH, X_CLASSES, X_WARMUP, X_TIMED = 16, 21, 1, 3
# phase 13.5: one full-width train step each at 512x512, batch 2, 19 classes;
# (path, title, backbone, head, backbone kwargs)
Z_BATCH, Z_CLASSES = 2, 19
Z_MODELS = (
    ("efficientnet_nasfpn_train", "EfficientNet-B7 (os32) + NAS-FPN(256)", "efficientnetb7",
     "nasfpn", dict(output_stride=32)),
    ("moat_train", "MOAT-4 + ASPP(256)", "moat4", "aspp", {}),
    ("mixer_train", "MLP-Mixer-L/16 (built for 512x512) + ASPP(256)", "mlp_mixer_l16", "aspp",
     dict(input_size=HW)),
    ("convnext_v2_fpn_train", "ConvNeXt-V2-L (os32) + SemanticFPN(256)", "convnext_v2_large",
     "fpn", dict(output_stride=32)),
)
# the loss kernels' shapes on the six paths: (path, batch, logit side, classes)
UCE_SHAPES = (("resnet", R_BATCH, HW // R_OS, R_CLASSES), ("swin", S_BATCH, HW // S_OS, S_CLASSES),
              ("intern", I_BATCH, HW // I_OS, I_CLASSES),
              ("mbv2", M_BATCH, HW // M_LOGIT_OS, M_CLASSES),
              ("hrnet", H_BATCH, HW // H_LOGIT_OS, H_CLASSES),
              ("vit", V_BATCH, HW // V_OS, V_CLASSES))
# the loss kernels' shapes on phase 13's paths, (path, batch, logit h, logit w,
# classes, label (H, W)): ConvNeXt-L + FaPN's os4 logits of Cityscapes' 512x1024
# crops (the kernels' first non-square source), and Xception-65 + ASPP's os16
# logits of VOC's 512x512 crops (the ResNet path's geometry)
UCE_ZOO_SHAPES = (("convnext_fapn", 8, 128, 256, 19, (512, 1024)),
                  ("xception", 16, 32, 32, 21, (512, 512)))
# Gemma path: gemma_2b_en at full width, its depth cut from 18 to G_LAYERS layers
# (phase 10 was the run's dearest path), served at batch 8, prompt 128, 256
# generated slots (512 until the run neared its time limit; the active cache
# still grows from 256 to 512 slots halfway)
G_PRESET, G_BATCH, G_PROMPT, G_MAX_LENGTH, G_SEGMENT = "gemma_2b_en", 8, 128, 384, 256
G_LAYERS = 6
G_CONTRASTIVE_K = 5
G_TEXT_PROMPT, G_TEXT_MAX_LENGTH = 24, 56  # the tokenizer round trip, ragged prompts
# active KV cache of the segmented beam search: [B, nb, layers, 2, W, kv heads, head dim]
# (the Gemma path's depth, then gemma_2b_en's full depth, which --ab times)
CG_PATH_SHAPES = tuple((f"beam{nb} W={w} L={G_LAYERS}", (G_BATCH, nb, G_LAYERS, 2, w, 1, 256),
                        torch.bfloat16) for nb in (4, 2) for w in (G_SEGMENT, 2 * G_SEGMENT))
CG_SHAPES = tuple((f"beam{nb} W={w}", (G_BATCH, nb, 18, 2, w, 1, 256), torch.bfloat16)
                  for nb in (4, 2) for w in (G_SEGMENT, 2 * G_SEGMENT))
CG_ODD_SHAPE = ("odd slab of 35 floats x 1031", (G_BATCH, 4, 1031, 5, 7), torch.float32)

# phase 14: pretrained weights. 14.1 holds ResNet-50 os16 + ASPP's fp32 logits on
# the card to the CPU port's at 256x256; 14.2 calibrates InternImage-T on a batch of
# 2 at 512x512, its offset heads set per stage (raw bias, kernels scaled down) so
# that stage s lands on P_EXPECT[s]: the recommended r is ceil(max |effective
# offset| + 0.5), and the reference's half-pixel base alone spans -1.49 .. 0.49 px
# on these maps, so no constant bias gives r = 1 (the least is r = 2, at a bias
# near 0.5); 14.4 trains the calibrated model at batch 8, 19 classes
REF_WEIGHTS = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "ref_weights"
P_HEADLINE_HW = 256
P_CALIB_BATCH = 2
P_OFFSET_BIAS = (0.5, 2.6, 4.8, 8.0)
P_OFFSET_KERNEL_SCALE = 0.05
P_EXPECT = (("dense_local_ref", 2), ("dense_local_ref", 4), ("dense_local_ref", 6),
            ("gather", None))
P_BATCH, P_CLASSES, P_WARMUP, P_TIMED = 8, 19, 2, 3
P_RADII = (1, 4, 6)  # 14.5's kernel rows at stage 2's shape
AB_DL_RADII = (4, 6)  # --ab's dense-local backward rows at the calibrated radii
CCL_BATCH, CCL_HW, CCL_SNAKE_RUNS = 8, 512, 9

# phase 15: data parallelism. 15.1's global batch (phase 3's) over 2 ranks, the
# ignore-pixel shares of its two halves, its steps; 15.4's eval batch; the ranks'
# time limit (spawn, build and work), after which they are killed
DP_BATCH, DP_IGNORE, DP_STEPS, EVAL_DP_BATCH = 16, (0.5, 0.05), 3, 8
DP_TIMEOUT_S = 420
# 15.1: the fp32 DP state after steps 1 and DP_STEPS against world size 1's, max
# |diff| over max |value|. World size 1's BatchNorm takes its moments with
# SyncBN's arithmetic at world size 2 (fast_variance_batchnorm(2)); the convs'
# sums still run in other orders at batch 8 and 16, and on this unnormalized
# random batch the network amplifies that rounding from step to step. After
# step 1 DP lies 3.5e-5 off and each fault of DP_FAULTS (planted_fault), run
# the same way, 3.1e-3-4.2e-3 (NVIDIA H100 80GB HBM3, 700 W): the bound sits
# between, and each fault must lie past it. After DP_STEPS the amplified
# rounding (1.1e-2) reaches the faults' distance (1.7e-2-2.6e-2): that bound
# catches only a run that drifts off
DP_STATE_RTOL = {1: 3e-4, DP_STEPS: 5e-2}
DP_FAULTS = ("rank_means", "bn_backward_local")
# 15.2: the FSDP step against the DP step at world size 1 (the same products;
# FSDP2 all-gathers copies of the parameters and reduces the gradients over one
# rank), max |diff| over max |param|
FSDP_RTOL = 1e-6
# phase F1: steps of each run (two runs of each path)
F1_STEPS = 3
# phase 16: the language-model half of distribution, two ranks on this card over
# gloo (correctness runs). 16.1: tensor-parallel serving of gemma_7b_en at full
# width, its depth cut from 28 to 4 layers (14 when the global-attention kernels'
# build and phase F1's ViT-L, EVA02-L and MOAT-4 runs needed the time; 7 when the
# run neared its time limit; 4 when the bias form's phase-2 row and build did), bf16, model
# parallelism 2,
# batch-4 requests of 128-token prompts to max_length 192 (256 before phase 17 needed
# the time), greedy and beam 4.
# Its prefill logits against world size 1's on the same weights, relative to
# max |logit|: the two sum the heads' and the FFN's partial products in other
# orders and round to bf16 at other points (GEMMA_LAYOUT_RTOL's argument;
# measured 8.3e-3)
TP_PRESET, TP_LAYERS = "gemma_7b_en", 4
TP_BATCH, TP_PROMPT, TP_MAX_LENGTH, TP_BEAMS = 4, 128, 192, 4
TP_LOGIT_RTOL = 2e-2  # GEMMA_LAYOUT_RTOL
# 16.2: gemma_2b_en at full width, SP_LAYERS of its 18 layers, bf16, batch 2 x T 2048 over a
# sequence axis of 2; score and the loss's gradient against world size 1 bf16
# (no SP) on the same weights, max |diff| over max |value| (the gradient's: of
# its worst leaf). The bounds sit at about twice the bf16 run's own distance
# from the fp32 run on the same weights (score 5.5e-3, worst gradient leaf
# 2.8e-2), which the phase measures and prints; SP measured score 0 / 4.8e-3
# and gradient 1.3e-2 / 2.3e-2 (allgather / ring; NVIDIA H100 80GB HBM3, 700 W)
SP_PRESET, SP_BATCH, SP_T = "gemma_2b_en", 2, 2048
SP_LAYERS = 6  # depth cut from 18 to 9 when phase F1's new paths needed the time, to 6 when
#                the global-attention pair's bias form did
SP_SCORE_RTOL, SP_GRAD_RTOL = 1e-2, 5e-2
# 16.3: gemma_2b_en fp32 (TF32 off), 2 stages of 9 layers, 4 microbatches,
# batch 8 x T 512; the loss, every gradient and one SGD step (lr PP_LR) against
# one process's: fp32 sums in other orders (microbatch GEMM shapes; measured
# 7.8e-6 of the worst leaf's max |grad|)
PP_BATCH, PP_T, PP_MICRO, PP_LR = 8, 512, 4, 0.1
PP_RTOL = 1e-4
# 16.4: the MoE layer, hidden 2048, 8 experts of d_ff 2048, k 2, 4096 tokens,
# fp32, its experts over 2 ranks, against world size 1 (measured 2.6e-7)
EP_DIM, EP_EXPERTS, EP_FF, EP_K, EP_TOKENS = 2048, 8, 2048, 2, 4096
EP_RTOL = 1e-5
LM_TIMEOUT_S = 480
# phase 17.1: int8 serving of phase 10's model (gemma_2b_en at full width, G_LAYERS
# layers, bf16, seed 0), weight-only and W8A8, batch 8, prompt 128, greedy and beam
# 4 to max_length Q_MAX_LENGTH (cut from phase 10's 384 to fit the run's time).
# W8A8's prefill logits must lie within Q_W8A8_NOISE_MULT x the weight-only
# model's distance from the bf16 run (the int8 weights' own rounding, measured in
# the same run), relative to max |logit|; the planted fault (each product's
# weight scales applied to the columns in reverse order) must lie beyond
Q_MAX_LENGTH, Q_BEAMS = 256, 4
Q_W8A8_NOISE_MULT = 4.0
# rows of the decode products: greedy (batch 8, padded to 17 for torch._int_mm)
# and beam 4 (32); (name, K, N) of gemma_2b_en's products
Q_ROWS = (G_BATCH, G_BATCH * Q_BEAMS)
Q_PRODUCTS = (("query", 2048, 2048), ("key", 2048, 256), ("attention_output", 2048, 2048),
              ("gating_ffw", 2048, 16384), ("ffw_linear", 16384, 2048),
              ("readout", 2048, 256000))
# phase 17.2: the Swin path's model at swin_large's widths and window with its
# depth cut to X_DEPTHS (stage 2 from 18 blocks to 6 when the run neared its time
# limit: export and load scale with the blocks; to 2 when the global-attention
# pair's bias form added its phase-2 row and build) + SemanticFPN(256), 19 classes,
# 512x512, seed-17 weights, exported with scales (0.75, 1.0) + flip under bf16
# autocast, batch-polymorphic, served in a fresh process at batches 1 and 2. Its
# logits against the live bf16 serve's: the same ops under the same autocast, but
# the flip pairs at double batch and another process's cuDNN algorithms
# (KERNEL_VS_PLAIN_MODEL_RTOL's argument)
X_SCALES, X_BATCH, X_SERVE_REPS = (0.75, 1.0), 2, 5
X_DEPTHS = (2, 2, 2, 2)
X_ARTIFACT_RTOL = 2e-2
X_EXAMPLE_SIZE, X_EXAMPLE_CLASSES = 512, 21  # the example driver: MobileNetV2 + SimpleDecoder
X_TIMEOUT_S = 300

# Published peaks of one H100 SXM at its 700 W limit: HBM3 bytes/s, and
# FLOP/s for fp32 inputs (outside the tensor cores) and bf16 inputs
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# fp32 products on the tensor cores in split TF32: three TF32 products (dense
# TF32 at 495 TFLOP/s) for each fp32 one
SPLIT_TF32_FLOPS = 495e12 / 3

# upsample + CE kernel vs plain: fp32 loss rtol 1e-5; dsrc max error within
# 1e-4 (f32) or 1e-2 (bf16: the kernel's gradient is rounded to bf16) of max |dsrc|
UCE_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 1e-2)}
# window attention kernel vs plain, max abs error as a share of max(1, max |plain|):
# f32 differs by summation order (and q scaled before the product); with bf16
# q/k/v both compute in fp32 from the same bf16 values and round out/dq/dk/dv
# to bf16 (one ulp is 2^-8 of the value); dbias stays fp32 on both sides
WA_TOL = {torch.float32: dict(out=1e-4, dbias=1e-4), torch.bfloat16: dict(out=1e-2, dbias=1e-3)}
# dense-local kernel vs plain, max abs error as a share of max(1, max |plain|):
# in f32 both sum the same products in another order; in the autocast mix both
# compute in fp32 from the same bf16 values and round out, d_x and d_modulation
# to bf16 (one ulp is 2^-8 of the value)
DL_TOL = {"f32": 1e-4, "mixed": 1e-2}
# fused vs unfused first-step loss, relative. Both run the same bf16 network
# with the same cuDNN algorithms (the autotuner's choices are cached per
# shape); they differ only in the loss: the unfused path upsamples bf16
# logits and rounds each to bf16 (2^-9 relative), the kernel upsamples in
# fp32, and those roundings average out over the 4M pixels' mean
FUSED_UNFUSED_RTOL = 1e-4
# resumed vs uninterrupted run (phase 5b), each step's loss, relative. The
# index stream, the augment, the dropout masks and the fused loss kernels
# are the same bit for bit; a cuDNN weight-gradient algorithm that sums with
# atomics would differ from run to run, and 2-8 bf16 steps carry that on
# (0 measured: the autotuner's choices on the H100 summed alike)
SYS_RESUME_RTOL = 1e-3
# OHEM loss on the card against the CPU port's, the same fp32 logits and
# labels: the two upsample and take the CE in fp32 in other orders (a few
# ulps a pixel), and a loss that moves by that can only swap pixels that tie
# at the selector's threshold, each worth 1e-5 of the mean at 1e5 kept
OHEM_RTOL = 1e-5
# stream (host shards) vs resident first-step loss without augment: the
# same images, weights and dropout masks through the same algorithms
SYS_STREAM_RTOL = 1e-5
# served logits vs low-res logits upsampled by hand, or vs the same bf16
# network on the kernels' plain versions, or window batch 1 vs 2 (other GEMM
# shapes): bf16 keeps 8 bits, relative to max |logit|
SERVE_RTOL = 1e-2
# Phases 7 and 9: the bf16 single-scale serve with the kernels against the same
# weights served in fp32 on the plain versions (TF32 off), relative to the fp32
# run's max |logit|. The bf16 network on the plain versions lies some distance
# from that fp32 run (its own noise, which the phase measures and prints); the
# kernel run is held to SERVE_NOISE_MULT times that noise, and never below
# KERNEL_VS_PLAIN_MODEL_RTOL (2e-2: 24 blocks of bf16 attention outputs rounded
# apart). A planted fault in the kernels' inputs (SERVE_FAULTS) must fail the
# same bound in every run
SERVE_NOISE_MULT = 2.0
KERNEL_VS_PLAIN_MODEL_RTOL = 2e-2
# fp32 Swin first-step loss, split-TF32 kernels vs the plain window attention:
# both fp32 (TF32 off elsewhere), apart by the kernels' products (about 2^-21
# of each, 1e-6 of the outputs) and summation order, through 24 blocks
F32_KERNEL_VS_PLAIN_RTOL = 1e-4
# Segmented against monolithic KV cache, the same tokens fed to both, bf16:
# the attention logits are the same products, but the segmented path sums
# its values per segment in fp32 and rounds once, the monolithic path takes
# one product rounded to bf16, so a block's output moves by a bf16 ulp (2^-8
# of the value) here and there, through 18 blocks; relative to max |logit|.
# Two SEARCHES on such logits pick the same tokens only until a near-tie
# between two continuations falls the other way; from there they explore
# other continuations (with random weights the model mostly repeats its
# last token, and which token a beam locks onto decides the rest), so whole
# searches are not held token-equal. They are held to this instead: the two
# layouts, fed the segmented search's tokens over all 256 steps (the active
# cache growing from 256 to 512 slots on the way), give logits within
# GEMMA_LAYOUT_RTOL of max |logit| (measured: 6e-3); and at the first step
# where two searches select other continuations, every continuation that
# one of them took and the other did not lies, in the first one's own
# ranking, within GEMMA_TIE_RTOL of max |logit| (in nats) of the one taken
# in its place. Two continuations can change places only when they are
# closer than the layouts' totals are to each other: the step's logit
# difference plus the scores' drift so far, each a few 1e-3 of max |logit|
# (measured: swapped continuations at most 1.1e-3 of max |logit| apart)
GEMMA_LAYOUT_RTOL = 2e-2
GEMMA_TIE_RTOL = 1e-2
# 11.2's resumed run against the uninterrupted one, each tensor's max abs
# difference over its max |value|: the same batches, weights and kernels,
# so 0 unless cuDNN picks other weight-gradient algorithms in the two runs
# (bf16 sums in another order, carried through 5 steps of Adam)
ACCUM_RESUME_RTOL = 1e-5
# 11.4's sliding window, window batch 1 against 2, in fp32 (other conv and
# GEMM shapes: summation order only; 2.5e-6 measured), relative to max
# |logit|. In bf16 the two part by the bf16 network's own noise: its 18
# windows of HRNet-W48 + JPU round to bf16 after each of about 100
# sequential layers, and a bf16 run lies 1.8e-2 - 2.1e-2 of max |logit| from
# the fp32 run on 11.1's weights (four runs on an H100), so two bf16 runs can
# part by more than 2e-2 (1.9e-2 - 2.6e-2 measured); each bf16 run is held to
# the fp32 run instead, at 2.5 times that noise
SLIDE_BATCH_RTOL = 2e-2
SLIDE_BF16_RTOL = 5e-2
# 12.3: one image's fp32 logits on the card (SDPA, cuDNN and cuBLAS with TF32
# off) against the CPU port's (the plain attention) with the same weights,
# relative to max |logit|: fp32 sums in other orders through 24 blocks
T_CARD_VS_CPU_RTOL = 1e-3
# 13.3: ConvNeXt-L + FaPN's fp32 logits on the card (cuDNN and cuBLAS with TF32
# off) against the CPU port's, the same weights and image, relative to max
# |logit|: fp32 sums in other orders
C_CARD_VS_CPU_RTOL = 1e-5
# 14.1: the ingested ResNet-50 + ASPP's fp32 logits on the card (cuDNN with TF32
# off) against the CPU port's, the same dict, image and head draws: fp32 sums in
# other orders, relative to max |logit|
P_CARD_VS_CPU_RTOL = 1e-5
# 14.3: the calibrated InternImage-T (dense-local kernels) against the same
# weights on the gather sampler, fp32 on the card, relative to each max |output|:
# the two sum the same bilinear taps in other orders (the JAX package's own
# criterion, tests/test_dcn_autocalib.py)
P_CALIB_VS_GATHER_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3, setup=None) -> float:
    """Median over ``reps`` of the time between CUDA events recorded just
    before and just after ``fn(arg)``. Besides the device's work it holds
    the part of the host's dispatch of the call (Python, autograd, the
    wrapper's checks) that the device waits for: all of it where the device
    is idle when the first event is recorded. ``setup()`` runs before each
    rep, outside the timed window."""
    times = []
    for i in range(warmup + reps):
        arg = setup() if setup is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


DEVICE_TIMERS: set[str] = set()  # the timers that device_ms used in this process


def device_ms(fn, reps: int = 10, warmup: int = 2, setup=None) -> float:
    """torch.profiler's self device time of every kernel and copy that
    ``fn(arg)`` launches, per call, over ``reps`` calls: the device's work
    alone, without the host's dispatch that :func:`cuda_median_ms` holds.
    ``setup()`` runs for every rep before the profiler starts, so what it
    launches is not counted. Where the profiler records no device activity
    (its CUPTI tracing is not available to every process), the time is
    :func:`held_events_ms`'s, and the run says so."""
    def make():
        return setup() if setup is not None else None

    for _ in range(warmup):
        fn(make())
    if "held_events" in DEVICE_TIMERS:
        return held_events_ms(fn, reps, make)
    us = sum(t for t, _ in profiled_device_us(fn, [make() for _ in range(reps)]).values())
    if us > 0:
        DEVICE_TIMERS.add("profiler")
        return us / 1e3 / reps
    log("  torch.profiler recorded no device time: device_ms is timed by CUDA events "
        "around calls queued behind a device hold from here on")
    DEVICE_TIMERS.add("held_events")
    return held_events_ms(fn, reps, make)


def profiled_device_us(fn, args) -> dict[str, tuple[float, int]]:
    """torch.profiler's self device time (us) and count of the kernels and
    copies of each name that ``fn(arg)`` launches over ``args``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for arg in args:
            fn(arg)
        torch.cuda.synchronize()
    return {evt.key: (getattr(evt, "self_device_time_total", 0), evt.count)
            for evt in prof.key_averages() if evt.device_type.name == "CUDA"}


def kernel_device_ms(fn, needle: str, reps: int = 10, warmup: int = 2, setup=None,
                     tries: int = 3):
    """torch.profiler's device time per call of the one kernel of ``fn(arg)``
    whose name holds ``needle``, in a call that launches several. The
    profiler must record that kernel ``reps`` times: it has been seen to drop
    records on the card, a few or all of one kernel's, so a short count is
    profiled again, up to ``tries`` times. None where the profiler records no
    device activity or keeps dropping records (then only the whole call is
    timed, by :func:`held_ms`); a kernel it never records among the call's
    others in any try raises (a needle that names no kernel)."""
    def make():
        return setup() if setup is not None else None

    for _ in range(warmup):
        fn(make())
    seen, events = False, {}
    for _ in range(tries if "held_events" not in DEVICE_TIMERS else 0):
        events = profiled_device_us(fn, [make() for _ in range(reps)])
        mine = [v for key, v in events.items() if needle in key]
        if not events or not any(t for t, _ in events.values()):
            return None
        seen = seen or bool(mine)
        if sum(n for _, n in mine) == reps:
            return sum(t for t, _ in mine) / 1e3 / reps
        log(f"  torch.profiler kept {sum(n for _, n in mine)} of {reps} launches of {needle!r}; "
            "profiling again")
    if events and not seen:
        raise RuntimeError(f"no kernel named like {needle!r} among {sorted(events)}")
    return None


@functools.cache
def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def held_ms(fn, reps: int = 10, warmup: int = 2, setup=None) -> float:
    """:func:`held_events_ms` with :func:`device_ms`'s arguments. Phase 2 runs
    it beside ``device_ms`` on the forward window-attention and backward
    dense-local rows, so the fallback timer runs, and is compared, in every run."""
    def make():
        return setup() if setup is not None else None

    for _ in range(warmup):
        fn(make())
    return held_events_ms(fn, reps, make)


def held_events_ms(fn, reps: int, make) -> float:
    """Device time per call of ``fn(make())`` over ``reps`` calls, from two
    CUDA events around the calls, with a spin kernel queued before the first
    event that holds the device until the host has queued every call: the
    calls then run back to back, and the host's dispatch is not in the time.
    That the hold was long enough is checked (the first event must still be
    pending when the last call is queued); if it was not, it is made longer
    and the calls run again on fresh arguments."""
    hold_ms = 2.0
    while True:
        args = [make() for _ in range(reps)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        torch.cuda._sleep(int(hold_ms * sleep_cycles_per_ms()))
        start.record()
        for arg in args:
            fn(arg)
        end.record()
        held = not start.query()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        del args
        if held:
            return start.elapsed_time(end) / reps
        if hold_ms >= 2000.0:
            raise RuntimeError(f"the host took {queued_ms:.1f} ms to queue {reps} calls, "
                               f"longer than a {hold_ms:.0f} ms device hold")
        hold_ms = min(2000.0, max(2.0 * hold_ms, 2.0 * queued_ms))


def bound_ms(bytes_moved: float, flops: float, dtype: torch.dtype,
             peak_flops: float | None = None) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate for the inputs' type (or
    ``peak_flops``)."""
    by_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / (peak_flops or PEAK_FLOPS[dtype])
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def dtype_name(dtype: torch.dtype) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]


# ----------------------------------------------------------------- phase 1

def phase_device():
    log("== phase 1: device and kernel build")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    log(f"nvidia-smi: {card_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    # the two longest builds (window_attention.cu and global_attention.cu,
    # 30-45 s each beside each other) go on beside phases 3-5c, which launch
    # none of their kernels; phase 1b waits for them
    pending = _build.load_later([wa.SOURCE, ga.SOURCE])
    _build.load_all([uce.SOURCE, dl.SOURCE, cg.SOURCE])
    log_builds((uce.build(), dl.build(), cg.build()))
    log(f"three sources built in parallel in {time.perf_counter() - t0:.2f} s; {wa.SOURCE} "
        f"and {ga.SOURCE} build on beside phases 3-5c (their host times share the CPU with "
        "nvcc)")
    return pending, t0


def log_builds(builds) -> None:
    for built in builds:
        if not built.compiled:
            raise RuntimeError(f"{built.path.name} was not compiled from a clean build directory")
        log(f"built {built.path.name} in {built.seconds:.2f} s (nvcc, sm_90a)")
        log(built.log.strip())


def phase_build_wait(pending, t0: float) -> None:
    log(f"== phase 1b: wait for the {wa.SOURCE} and {ga.SOURCE} builds")
    t_wait = time.perf_counter()
    pending.result()
    log_builds([wa.build(), ga.build()])
    log(f"waited {time.perf_counter() - t_wait:.2f} s; all sources built "
        f"{time.perf_counter() - t0:.2f} s after the build started")


# ----------------------------------------------------------------- phase 2

def uce_bound(src, labels, backward: bool) -> tuple[float, str]:
    """Bytes: src and labels read once, plus the two sums (forward) or the
    upstream scalar and dsrc (backward). Operations per output pixel and
    class: 8 for the four-tap interpolation, 4 for the softmax (subtract,
    exp, add, compare), and in the backward 8 more to scatter to the taps."""
    pixels, classes = labels.numel(), src.shape[-1]
    nbytes = src.numel() * src.element_size() + labels.numel() * 4
    nbytes += (4 + src.numel() * src.element_size()) if backward else 8
    return bound_ms(nbytes, pixels * classes * (20 if backward else 12), src.dtype)


# the unfused library pair timed beside the loss kernels (two calls, so no
# "library" call in the contract's sense: library_ms stays null), and the
# profiler's name of the backward kernel
UNFUSED_PAIR = "F.interpolate(bilinear, align_corners=False) + F.cross_entropy(ignore_index=255)"
UCE_BWD_KERNEL = "::bwd_kernel<"
UCE_FWD_KERNELS = ("::fwd_kernel<", "::reduce_kernel(")  # the forward's two kernels


def uce_fwd_kernels_ms(fn, **reps):
    """The forward's two kernels' device time per call, each by
    :func:`kernel_device_ms` (None where the profiler gives none)."""
    times = [kernel_device_ms(fn, needle, **reps) for needle in UCE_FWD_KERNELS]
    return None if None in times else sum(times)


def unfused_pair(labels):
    """``loss(src, labels)`` by the two library calls of UNFUSED_PAIR on
    NHWC ``src``; the int64 labels are made once, outside the timed calls."""
    target = labels.long()

    def loss(src, _labels):
        up = F.interpolate(src.permute(0, 3, 1, 2), size=tuple(target.shape[1:]),
                           mode="bilinear", align_corners=False)
        return F.cross_entropy(up, target, ignore_index=255)

    return loss


def uce_inputs(device, n, h, num_class, seed=0, w=None, out_hw=(HW, HW)):
    """fp32 logits [n, h, w, C] (w defaults to h) and int32 labels [n, *out_hw],
    a tenth ignored."""
    rng = np.random.RandomState(seed)
    src32 = torch.tensor(rng.randn(n, h, w or h, num_class).astype(np.float32), device=device)
    labels = rng.randint(0, num_class, (n, *out_hw))
    labels = np.where(rng.rand(n, *out_hw) < 0.1, 255, labels).astype(np.int32)
    return src32, torch.tensor(labels, device=device)


def uce_bwd_setup(fn, src, labels):
    """A setup for the timers: a fresh leaf and its loss by ``fn``, made
    outside the timed window, so that :func:`uce_run_bwd` times the backward."""
    def make():
        s = src.clone().requires_grad_(True)
        return s, fn(s, labels)
    return make


def uce_run_bwd(arg):
    s, loss = arg
    torch.autograd.grad(loss, s)


def check_upsample_ce(device, n, h, num_class, seed=0, w=None, out_hw=(HW, HW)) -> dict:
    src32, labels = uce_inputs(device, n, h, num_class, seed, w, out_hw)
    shape = f"[{n},{h},{w or h},{num_class}]->[{n},{out_hw[0]},{out_hw[1]}]"
    log(f"upsample_ce {shape}, ignored {float((labels == 255).float().mean()):.4f}")

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        src = src32.to(dtype)
        s_k = src.clone().requires_grad_(True)
        loss_k = uce.upsample_cross_entropy(s_k, labels)
        (g_k,) = torch.autograd.grad(loss_k, s_k)
        s_r = src.clone().requires_grad_(True)
        loss_r = uce.upsample_cross_entropy_reference(s_r, labels)
        (g_r,) = torch.autograd.grad(loss_r, s_r)
        torch.cuda.synchronize()
        loss_k, loss_r = float(loss_k.detach()), float(loss_r.detach())
        loss_err = abs(loss_k - loss_r)
        grad_err = float((g_k.float() - g_r.float()).abs().max())
        grad_scale = float(g_r.float().abs().max())
        loss_rtol, grad_rtol = UCE_TOL[dtype]
        name = dtype_name(dtype)
        log(f"  [{name}] loss kernel {loss_k:.7f} plain {loss_r:.7f} "
            f"abs err {loss_err:.3e} (tol rtol {loss_rtol:g}); dsrc max abs err "
            f"{grad_err:.3e} vs max |dsrc| {grad_scale:.3e} (tol {grad_rtol:g} of it)")
        if not (np.isfinite(loss_k) and loss_err <= loss_rtol * abs(loss_r)):
            raise AssertionError(f"[{shape} {name}] forward kernel disagrees with the plain version")
        if not grad_err <= grad_rtol * grad_scale:
            raise AssertionError(f"[{shape} {name}] backward kernel disagrees with the plain version")

        def bwd_setup(fn):
            return uce_bwd_setup(fn, src, labels)

        pair = unfused_pair(labels)
        with torch.no_grad():
            fwd_ms = cuda_median_ms(lambda _: uce.upsample_cross_entropy(src, labels))
            fwd_plain_ms = cuda_median_ms(
                lambda _: uce.upsample_cross_entropy_reference(src, labels))
            fwd_dev = device_ms(lambda _: uce.upsample_cross_entropy(src, labels))
            fwd_kernel_dev = uce_fwd_kernels_ms(lambda _: uce.upsample_cross_entropy(src, labels))
            fwd_held = held_ms(lambda _: uce.upsample_cross_entropy(src, labels))
            fwd_pair = device_ms(lambda _: pair(src, labels))
        bwd_ms = cuda_median_ms(uce_run_bwd, setup=bwd_setup(uce.upsample_cross_entropy))
        bwd_plain_ms = cuda_median_ms(uce_run_bwd,
                                      setup=bwd_setup(uce.upsample_cross_entropy_reference))
        bwd_dev = device_ms(uce_run_bwd, setup=bwd_setup(uce.upsample_cross_entropy))
        bwd_kernel_dev = kernel_device_ms(uce_run_bwd, UCE_BWD_KERNEL,
                                          setup=bwd_setup(uce.upsample_cross_entropy))
        bwd_held = held_ms(uce_run_bwd, setup=bwd_setup(uce.upsample_cross_entropy))
        bwd_pair = device_ms(uce_run_bwd, setup=bwd_setup(pair))
        fwd_bound, fwd_by = uce_bound(src, labels, backward=False)
        bwd_bound, bwd_by = uce_bound(src, labels, backward=True)
        log(f"  [{name}] median ms: fwd kernel {fwd_ms:.4f} (device {fwd_dev:.4f}, its two "
            f"kernels {fwd_kernel_dev}, held {fwd_held:.4f}) plain {fwd_plain_ms:.4f} bound {fwd_bound:.4f} ({fwd_by}); bwd "
            f"kernel {bwd_ms:.4f} (device {bwd_dev:.4f}, bwd_kernel alone {bwd_kernel_dev}, held "
            f"{bwd_held:.4f}) plain {bwd_plain_ms:.4f} bound {bwd_bound:.4f} ({bwd_by})")
        log(f"  [{name}] device ms, fused against the unfused pair ({UNFUSED_PAIR}): fwd "
            f"{fwd_dev:.4f} / {fwd_pair:.4f}, bwd {bwd_dev:.4f} / {bwd_pair:.4f}, together "
            f"{fwd_dev + bwd_dev:.4f} / {fwd_pair + bwd_pair:.4f}: fused "
            f"{'not slower' if fwd_dev + bwd_dev <= fwd_pair + bwd_pair else 'SLOWER'}")
        library = dict(library_ms=None, library_pair=UNFUSED_PAIR)
        rows[name] = {
            "fwd": dict(shape=f"{shape} {name}", max_abs_err=loss_err, ms=fwd_ms,
                        device_ms=fwd_dev, kernel_device_ms=fwd_kernel_dev, held_ms=fwd_held, plain_ms=fwd_plain_ms,
                        bound_ms=fwd_bound, bound_by=fwd_by, library_pair_ms=fwd_pair, **library),
            "bwd": dict(shape=f"{shape} {name}", max_abs_err=grad_err, ms=bwd_ms,
                        device_ms=bwd_dev, kernel_device_ms=bwd_kernel_dev, held_ms=bwd_held,
                        plain_ms=bwd_plain_ms, bound_ms=bwd_bound, bound_by=bwd_by,
                        library_pair_ms=bwd_pair, **library),
        }
    return rows


def wa_bound(q, bias, mask, backward: bool) -> tuple[float, str]:
    """Bytes: q, k, v, bias and mask read once and out written once; the
    backward also reads do and writes dq, dk, dv and dbias. Operations: two
    N x N x D products forward; five backward (the logits again, dv, dp, dq,
    dk), 2 N^2 D each per (window, head), at the bf16 tensor rate for bf16
    and at the split-TF32 rate for fp32 (the least time an fp32-accurate
    product takes on the card, whichever kernel runs)."""
    bnw, h, n, d = q.shape
    tensors = 7 if backward else 4
    operands = [t for t in (bias, mask) if t is not None]  # global attention may have neither
    nbytes = tensors * q.numel() * q.element_size() + 4 * sum(t.numel() for t in operands)
    nbytes += 4 * bias.numel() if backward and bias is not None else 0
    flops = (5 if backward else 2) * 2 * n * n * d * bnw * h
    return bound_ms(nbytes, flops, q.dtype,
                    SPLIT_TF32_FLOPS if q.dtype == torch.float32 else None)


def wa_inputs(device, bnw, heads, nw, shifted, dtype, seed=0, window=WINDOW, d=HEAD_DIM):
    """q, k, v, dout, bias, mask in the layouts the Swin block gives: q, k, v
    are views of the packed qkv projection, the incoming gradient is
    token-major."""
    n = window * window
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((bnw, n, 3, heads, d), generator=gen, device=device).to(dtype)
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.unbind(2))
    dout = torch.randn((bnw, n, heads, d), generator=gen, device=device).to(dtype)
    dout = dout.permute(0, 2, 1, 3)
    bias = 0.1 * torch.randn((heads, n, n), generator=gen, device=device)
    side = int(math.isqrt(nw)) * window
    mask = torch.tensor(swin_module._shift_attn_mask(side, side, window, window // 2)
                        if shifted else np.zeros((1, n, n), np.float32), device=device)
    return q, k, v, dout, bias, mask


def wa_leaves(q, k, v, bias):
    # detach() keeps a view's strides, so q, k, v stay packed
    return [t.detach().requires_grad_(True) for t in (q, k, v)] + \
        [bias.detach().clone().requires_grad_(True)]


def sdpa(q, k, v, full_bias, _mask, scale):
    """F.scaled_dot_product_attention with the additive bias + mask of every
    window made beforehand: a yardstick, used nowhere in the port."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=full_bias, scale=scale)


def wa_backward_ms(fn, q, k, v, dout, bias, mask, scale, timer=cuda_median_ms, **reps) -> float:
    """Time of the backward of ``fn`` through autograd by ``timer``; its
    forward runs before each rep, outside the timed window."""
    def setup():
        leaves = wa_leaves(q, k, v, bias)
        return leaves, fn(*leaves, mask, scale)

    def run_grad(arg):
        leaves, out = arg
        torch.autograd.grad(out, leaves, dout)

    return timer(run_grad, setup=setup, **reps)


def swin_routes(dtype: torch.dtype, n: int) -> tuple[str, str]:
    """The (forward, backward) routes a Swin shape (D = 32, N = 49 or 144)
    must take: bf16 on the tensor cores, fp32 on the tensor cores in split
    TF32."""
    del n  # both windows take the same routes
    return ("mma", "mma") if dtype == torch.bfloat16 else ("tf32x3", "tf32x3")


def route_counts(fwd_route: str, bwd_route: str | None) -> dict[str, int]:
    """``wa.LAUNCH_COUNTS`` after one forward and (unless ``bwd_route`` is
    None) one backward on these routes."""
    counts = dict.fromkeys(wa.LAUNCH_COUNTS, 0)
    for which, route in (("fwd", fwd_route), ("bwd", bwd_route)):
        if route is not None:
            counts[which if route == "cuda_core" else f"{which}_{route}"] = 1
    return counts


def check_window_attention(device, stage, bnw, heads, nw, shifted, dtype, seed=0,
                           window=WINDOW, d=HEAD_DIM, routes=None, backward=True,
                           repeat=False) -> dict:
    """The kernels at one shape against their plain version (out, and with
    ``backward`` dq, dk, dv, dbias), with their times, SDPA's and the bound.
    ``routes``: the (forward, backward) routes the shape must take, Swin's
    by default; ``repeat``: a second kernel run must equal the first bit for
    bit."""
    q, k, v, dout, bias, mask = wa_inputs(device, bnw, heads, nw, shifted, dtype, seed, window, d)
    n = q.shape[2]
    scale = 1.0 / math.sqrt(d)
    fwd_route, route = wa.forward_route(dtype, n, d), wa.backward_route(dtype, n, d)
    name = (f"{stage} bnw={bnw} H={heads} N={n} D={d} nW={mask.shape[0]} {dtype_name(dtype)} "
            f"fwd:{fwd_route}" + (f" bwd:{route}" if backward else ""))
    want_routes = routes or swin_routes(dtype, n)
    if (fwd_route, route)[:1 + backward] != tuple(want_routes)[:1 + backward]:
        raise AssertionError(f"[{name}] must take the routes {want_routes}")

    def run(fn):
        qq, kk, vv, bb = wa_leaves(q, k, v, bias)
        out = fn(qq, kk, vv, bb, mask, scale)
        if not backward:
            return [out.detach().float()]
        grads = torch.autograd.grad(out, (qq, kk, vv, bb), dout)
        return [t.detach().float() for t in (out, *grads)]

    wa.reset_launch_counts()
    got = run(wa.window_attention)
    want_counts = route_counts(fwd_route, route if backward else None)
    if wa.LAUNCH_COUNTS != want_counts:
        raise AssertionError(f"[{name}] launches {wa.LAUNCH_COUNTS}, expected {want_counts}")
    if repeat:
        again = run(wa.window_attention)
        for key, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"[{name}] kernel {key} differs from run to run")
        del again
    want = run(wa.window_attention_reference)
    torch.cuda.synchronize()
    errs = {}
    for key, a, b in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[{name}] kernel {key} is not finite")
        errs[key] = float((a - b).abs().max())
        tol = WA_TOL[dtype]["dbias" if key == "dbias" else "out"] * max(1.0, float(b.abs().max()))
        if not errs[key] <= tol:
            raise AssertionError(f"[{name}] kernel {key} disagrees with the plain version: "
                                 f"max abs err {errs[key]:.3e} > {tol:.3e}")
    del got, want

    full_bias = (bias[None] + mask[torch.arange(bnw, device=device) % mask.shape[0]][:, None])
    full_bias = full_bias.to(dtype).contiguous()
    reps = dict(reps=10, warmup=2)
    with torch.no_grad():
        fwd_ms = cuda_median_ms(lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
        fwd_plain = cuda_median_ms(
            lambda _: wa.window_attention_reference(q, k, v, bias, mask, scale), **reps)
        fwd_lib = cuda_median_ms(lambda _: sdpa(q, k, v, full_bias, None, scale), **reps)
        fwd_dev = device_ms(lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
        fwd_lib_dev = device_ms(lambda _: sdpa(q, k, v, full_bias, None, scale), **reps)
        fwd_held = held_ms(lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
    fwd_bound, fwd_by = wa_bound(q, bias, mask, backward=False)
    row = {"fwd": dict(shape=name, route=fwd_route, max_abs_err=errs["out"], ms=fwd_ms,
                       device_ms=fwd_dev, held_ms=fwd_held, plain_ms=fwd_plain,
                       bound_ms=fwd_bound, bound_by=fwd_by, library_ms=fwd_lib,
                       library_device_ms=fwd_lib_dev)}
    msg = (f"  [{name}] max abs err " + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
           + ("; bitwise repeatable" if repeat else "")
           + f"; ms fwd kernel {fwd_ms:.4f} (device {fwd_dev:.4f}, held {fwd_held:.4f}) plain "
           f"{fwd_plain:.4f} sdpa {fwd_lib:.4f} (device {fwd_lib_dev:.4f}) bound {fwd_bound:.4f} "
           f"({fwd_by})")
    if backward:
        bwd_ms = wa_backward_ms(wa.window_attention, q, k, v, dout, bias, mask, scale, **reps)
        bwd_plain = wa_backward_ms(wa.window_attention_reference, q, k, v, dout, bias, mask,
                                   scale, **reps)
        bwd_lib = wa_backward_ms(sdpa, q, k, v, dout, full_bias, mask, scale, **reps)
        bwd_dev = wa_backward_ms(wa.window_attention, q, k, v, dout, bias, mask, scale,
                                 timer=device_ms, **reps)
        bwd_lib_dev = wa_backward_ms(sdpa, q, k, v, dout, full_bias, mask, scale,
                                     timer=device_ms, **reps)
        bwd_bound, bwd_by = wa_bound(q, bias, mask, backward=True)
        bwd_err = max(errs[key] for key in ("dq", "dk", "dv", "dbias"))
        row["bwd"] = dict(shape=name, route=route, max_abs_err=bwd_err, ms=bwd_ms,
                          device_ms=bwd_dev, plain_ms=bwd_plain, bound_ms=bwd_bound,
                          bound_by=bwd_by, library_ms=bwd_lib, library_device_ms=bwd_lib_dev)
        msg += (f"; bwd kernel {bwd_ms:.4f} (device {bwd_dev:.4f}) plain {bwd_plain:.4f} sdpa "
                f"{bwd_lib:.4f} (device {bwd_lib_dev:.4f}) bound {bwd_bound:.4f} ({bwd_by})")
    log(msg)
    return row


def ga_inputs(device, b, heads, t, d, dtype, seed=0):
    """q, k, v [B, H, T, D] views of a packed [B, T, 3, H, D] projection (as
    the ViT and EVA blocks give) and the incoming gradient, token-major."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, t, 3, heads, d), generator=gen, device=device).to(dtype)
    q, k, v = (x.permute(0, 2, 1, 3) for x in qkv.unbind(2))
    dout = torch.randn((b, t, heads, d), generator=gen, device=device).to(dtype)
    return q, k, v, dout.permute(0, 2, 1, 3)


def ga_backward_ms(fn, q, k, v, dout, timer=cuda_median_ms, **reps) -> float:
    """Time of the backward of ``fn(q, k, v)`` through autograd by ``timer``;
    its forward runs before each rep, outside the timed window."""
    def setup():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        return leaves, fn(*leaves)

    return timer(lambda arg: torch.autograd.grad(arg[1], arg[0], dout), setup=setup, **reps)


def check_deterministic_sdpa(device) -> None:
    """A yardstick for a later change, used nowhere in the port: SDPA at
    ViT-L's shape (bf16, no mask) under ``torch.use_deterministic_algorithms
    (True)`` without ``warn_only``: whether its backward runs there, its
    forward and backward device ms, and whether two backwards equal bit for
    bit."""
    title, b, heads, t, d, dtype = GA_ROWS[0]
    q, k, v, dout = ga_inputs(device, b, heads, t, d, dtype, seed=1)

    def library(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv)

    def grads():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = library(*leaves)
        return [x.detach() for x in torch.autograd.grad(out, leaves, dout)]

    reps = dict(reps=10, warmup=2)
    torch.use_deterministic_algorithms(True)
    try:
        first, second = grads(), grads()
        with torch.no_grad():
            fwd_dev = device_ms(lambda _: library(q, k, v), **reps)
        bwd_dev = ga_backward_ms(library, q, k, v, dout, timer=device_ms, **reps)
        repeats = all(torch.equal(a, c) for a, c in zip(first, second))
        log(f"  [deterministic SDPA, {title} [B={b},H={heads},T={t},D={d}] "
            f"{dtype_name(dtype)}] torch.use_deterministic_algorithms(True): fwd device "
            f"{fwd_dev:.4f} ms, bwd device {bwd_dev:.4f} ms; two backwards equal bit for bit: "
            f"{repeats} ({card_line()})")
    except RuntimeError as e:
        log(f"  [deterministic SDPA, {title}] torch.use_deterministic_algorithms(True): the "
            f"backward raises: {str(e).splitlines()[0][:300]}")
    finally:
        torch.use_deterministic_algorithms(False)


def sdpa_with_bias(qq, kk, vv, bb=None, scale=None):
    """SDPA on ``[B, H, T, D]`` q, k, v with an ``[H, T, S]`` fp32 bias (or
    none) as its additive mask in q's type, which takes the bias's
    gradient."""
    attn_mask = None if bb is None else bb.to(qq.dtype)[None]
    return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn_mask, scale=scale)


def deterministic_sdpa_device_ms(q, k, v, dout, reps, bias=None):
    """(forward, backward) device ms of SDPA on ``[B, H, T, D]`` q, k, v
    (with ``bias``, ``[H, T, S]``, as its additive mask and a gradient for
    it, if given) under ``torch.use_deterministic_algorithms(True)`` (a
    yardstick, used nowhere in the port), or None where its backward raises
    there."""
    args = (q, k, v) + (() if bias is None else (bias,))

    def setup():
        leaves = [x.detach().requires_grad_(True) for x in args]
        return leaves, sdpa_with_bias(*leaves)

    torch.use_deterministic_algorithms(True)
    try:
        with torch.no_grad():
            fwd = device_ms(lambda _: sdpa_with_bias(*args), **reps)
        return fwd, device_ms(lambda arg: torch.autograd.grad(arg[1], arg[0], dout), setup=setup,
                              **reps)
    except RuntimeError:
        return None
    finally:
        torch.use_deterministic_algorithms(False)


def check_global_kernel(device, title, b, heads, t, d, dtype, with_bias=False) -> dict:
    """Global attention as the train steps run it without a mask: the
    global-attention kernel pair on ``[B, T, H, D]`` views of the packed
    projection (bf16, or its split-TF32 form in fp32; ``with_bias``: its
    bias form, with MOAT's ``[H, T, T]`` fp32 relative bias, which takes its
    gradient) against its plain version (fp32 inside), forward and backward
    (to WA_TOL of the row's type, dbias to its dbias tolerance), run twice
    bit for bit, one forward and one backward launch of the pair's form and
    none of another form or the window-attention kernels; with its times,
    the plain version's, SDPA's in the row's type (the library call
    computing the same function, with the bias as its additive mask, used
    nowhere on this route), deterministic SDPA's (bf16 rows) and the bound
    (``wa_bound``: the bias read once and dbias written once; fp32 at the
    split-TF32 rate). With a bias or in fp32 also the streaming window-
    attention pair built with both operands, a zero ``[1, T, T]`` mask (and
    a zero bias) standing in, on the same call: where such a call went
    before the pair took it."""
    qh, kh, vh, douth = ga_inputs(device, b, heads, t, d, dtype)  # [B, H, T, D] views
    q, k, v, dout = (x.permute(0, 2, 1, 3) for x in (qh, kh, vh, douth))  # [B, T, H, D]
    bias = None
    if with_bias:
        gen = torch.Generator(device=device).manual_seed(1)
        bias = 0.1 * torch.randn((heads, t, t), generator=gen, device=device)
    scale = 1.0 / math.sqrt(d)
    f32 = dtype == torch.float32
    name = (f"{title} [B={b},H={heads},T={t},D={d}] {dtype_name(dtype)} "
            + ("bias [H,T,T], no mask" if with_bias else "no bias, no mask"))
    if (not ga.takes(dtype, b, heads, t, t, d, None if bias is None else tuple(bias.shape))
            or not all(ga.aligned(x) for x in (q, k, v))):
        raise AssertionError(f"[{name}] must take the global-attention kernels as it is")
    extra = () if bias is None else (bias,)

    def kernel(qq, kk, vv, bb=None):
        return ga.global_attention(qq, kk, vv, scale, bb)

    def plain(qq, kk, vv, bb=None):
        return ga.global_attention_reference(qq, kk, vv, scale, bb)

    def library(qq, kk, vv, bb=None):
        return sdpa_with_bias(qq, kk, vv, bb, scale)

    def streaming(qq, kk, vv, bb=None):
        return wa.window_attention(qq, kk, vv, bb, None, scale)

    def leaves(args):
        return [x.detach().requires_grad_(True) for x in args[:3]] + [
            x.detach().clone().requires_grad_(True) for x in args[3:]]

    def run(fn):
        args = leaves((q, k, v) + extra)
        out = fn(*args)
        return [x.detach().float() for x in (out, *torch.autograd.grad(out, args, dout))]

    def backward_ms(fn, args, grad, timer=cuda_median_ms):
        def setup():
            ls = leaves(args)
            return ls, fn(*ls)

        return timer(lambda arg: torch.autograd.grad(arg[1], arg[0], grad), setup=setup, **reps)

    keys = ("out", "dq", "dk", "dv") + (("dbias",) if with_bias else ())
    form = ("_bias" if with_bias else "") + ("_f32" if f32 else "")
    want_counts = {**dict.fromkeys(ga.LAUNCH_COUNTS, 0), f"fwd{form}": 1, f"bwd{form}": 1}
    ga.reset_launch_counts()
    wa.reset_launch_counts()
    got = run(kernel)
    if ga.LAUNCH_COUNTS != want_counts or any(wa.LAUNCH_COUNTS.values()):
        raise AssertionError(f"[{name}] launches {ga.LAUNCH_COUNTS} of the pair and "
                             f"{wa.LAUNCH_COUNTS} of the window-attention kernels; expected "
                             f"{want_counts} of the pair alone")
    again = run(kernel)
    for key, a, c in zip(keys, got, again):
        if not torch.equal(a, c):
            raise AssertionError(f"[{name}] kernel {key} differs from run to run")
    del again
    want = run(plain)
    torch.cuda.synchronize()
    errs = {}
    for key, a, c in zip(keys, got, want):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[{name}] kernel {key} is not finite")
        errs[key] = float((a - c).abs().max())
        tol = WA_TOL[dtype]["dbias" if key == "dbias" else "out"] * max(1.0, float(c.abs().max()))
        if not errs[key] <= tol:
            raise AssertionError(f"[{name}] kernel {key} disagrees with the plain version: "
                                 f"max abs err {errs[key]:.3e} > {tol:.3e}")
    del got, want
    reps = dict(reps=10, warmup=2)
    args, args_h = (q, k, v) + extra, (qh, kh, vh) + extra
    with torch.no_grad():
        fwd_ms = cuda_median_ms(lambda _: kernel(*args), **reps)
        fwd_plain = cuda_median_ms(lambda _: plain(*args), **reps)
        fwd_lib = cuda_median_ms(lambda _: library(*args_h), **reps)
        fwd_dev = device_ms(lambda _: kernel(*args), **reps)
        fwd_lib_dev = device_ms(lambda _: library(*args_h), **reps)
        fwd_held = held_ms(lambda _: kernel(*args), **reps)
    bwd_ms = backward_ms(kernel, args, dout)
    bwd_plain = backward_ms(plain, args, dout)
    bwd_lib = backward_ms(library, args_h, douth)
    bwd_dev = backward_ms(kernel, args, dout, timer=device_ms)
    bwd_lib_dev = backward_ms(library, args_h, douth, timer=device_ms)
    det = None if f32 else deterministic_sdpa_device_ms(qh, kh, vh, douth, reps, bias)
    det_fwd, det_bwd = det if det is not None else (None, None)
    fwd_bound, fwd_by = wa_bound(qh, bias, None, backward=False)
    bwd_bound, bwd_by = wa_bound(qh, bias, None, backward=True)
    det_msg = ("" if f32 else "; deterministic sdpa backward raises" if det is None else
               f"; deterministic sdpa device fwd {det_fwd:.4f} bwd {det_bwd:.4f}")
    stream = {}
    if with_bias or f32:
        wa.reset_launch_counts()
        with torch.no_grad():
            stream["fwd"] = device_ms(lambda _: streaming(*args_h), **reps)
        stream["bwd"] = backward_ms(streaming, args_h, douth, timer=device_ms)
        if not (wa.LAUNCH_COUNTS["fwd_stream"] and wa.LAUNCH_COUNTS["bwd_stream"]):
            raise AssertionError(f"[{name}] the streaming comparison launched "
                                 f"{wa.LAUNCH_COUNTS}")
        det_msg += (f"; the streaming pair (both operands, zero stand-ins) device fwd "
                    f"{stream['fwd']:.4f} bwd {stream['bwd']:.4f}")
    log(f"  [{name}] max abs err " + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; bitwise repeatable; ms fwd kernel {fwd_ms:.4f} (device {fwd_dev:.4f}, held "
        f"{fwd_held:.4f}) plain {fwd_plain:.4f} sdpa {fwd_lib:.4f} (device {fwd_lib_dev:.4f}) "
        f"bound {fwd_bound:.4f} ({fwd_by}); bwd kernel {bwd_ms:.4f} (device {bwd_dev:.4f}) plain "
        f"{bwd_plain:.4f} sdpa {bwd_lib:.4f} (device {bwd_lib_dev:.4f}) bound {bwd_bound:.4f} "
        f"({bwd_by}){det_msg} ({card_line()})")
    more = {d: ({"streaming_device_ms": stream[d]} if stream else {}) for d in ("fwd", "bwd")}
    return {"fwd": dict(shape=name, route="global", max_abs_err=errs["out"], ms=fwd_ms,
                        device_ms=fwd_dev, held_ms=fwd_held, plain_ms=fwd_plain,
                        bound_ms=fwd_bound, bound_by=fwd_by, library_ms=fwd_lib,
                        library_device_ms=fwd_lib_dev, deterministic_library_device_ms=det_fwd,
                        **more["fwd"]),
            "bwd": dict(shape=name, route="global", max_abs_err=max(errs[k] for k in keys[1:]),
                        ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain, bound_ms=bwd_bound,
                        bound_by=bwd_by, library_ms=bwd_lib, library_device_ms=bwd_lib_dev,
                        deterministic_library_device_ms=det_bwd, **more["bwd"])}


def dl_bound(x, maps, groups: int, corners: int, backward: bool) -> tuple[float, str]:
    """Bytes: x, the three maps and the output once each; the backward reads
    the incoming gradient too and writes the four gradients. Operations: one
    multiply-add per channel of the group for every (pixel, group, tap,
    corner) that lies in the map with a non-zero weight in this run's data
    (``corners``); twice that in the backward (the dot products of the map
    gradients and the weighted sum of d_x)."""
    flops = 2 * corners * (x.shape[3] // groups) * (2 if backward else 1)
    map_bytes = sum(m.numel() * m.element_size() for m in maps)
    nbytes = 2 * x.numel() * x.element_size() + map_bytes
    if backward:
        nbytes += x.numel() * x.element_size() + map_bytes
    return bound_ms(nbytes, flops, x.dtype)


def dl_maps_bound(x, maps, groups: int, corners: int) -> tuple[float, str]:
    """The maps kernel of the backward alone (beside :func:`dl_bound`).
    Bytes: x and the incoming gradient read once, the three maps read and
    their three gradients written once (2 x + 2 maps). Operations: one
    multiply-add per channel of the group for every (pixel, group, tap,
    corner) that lies in the map with a non-zero weight in this run's data."""
    map_bytes = sum(m.numel() * m.element_size() for m in maps)
    nbytes = 2 * x.numel() * x.element_size() + 2 * map_bytes
    return bound_ms(nbytes, 2 * corners * (x.shape[3] // groups), x.dtype)


DL_MAPS_KERNEL = "dl_bwd_maps_kernel"


def dl_corner_count(x, off_dy, off_dx, r: int = DL_MAX_OFFSET) -> int:
    """(pixel, group, tap, corner) quadruples inside the map with a non-zero
    bilinear weight at clamp ``r``: the rows this run's offsets make the
    sampler read."""
    _, h, w, _ = x.shape
    k = DL_KERNEL
    groups = off_dy.shape[3] // (k * k)
    tap = torch.arange(k, dtype=torch.float32, device=x.device) - (k - 1) // 2

    def axis(off, taps, size, dim):
        d = off.float().clamp(-r, r) + taps.repeat(groups)
        lo = torch.floor(d)
        pos = torch.arange(size, device=x.device).view([-1 if i == dim else 1 for i in range(4)])
        lo_in = (pos + lo >= 0) & (pos + lo < size)
        hi_in = (pos + lo + 1 >= 0) & (pos + lo + 1 < size) & (d > lo)
        return lo_in.long() + hi_in.long()

    rows = axis(off_dy, tap.repeat_interleave(k), h, 1)
    cols = axis(off_dx, tap.repeat(k), w, 2)
    return int((rows * cols).sum())


def dl_inputs(device, side, channels, groups, mix, seed=0, spread=DL_MAX_OFFSET + 1):
    """x, off_dy, off_dx, modulation, g_out of a dense-local layer at batch
    I_BATCH (see :func:`check_deform_local` for ``mix``), the offsets drawn
    in +-``spread``."""
    kk = DL_KERNEL * DL_KERNEL
    gen = torch.Generator(device=device).manual_seed(seed)
    shape, mshape = (I_BATCH, side, side, channels), (I_BATCH, side, side, groups * kk)
    vtype = torch.float32 if mix == "f32" else torch.bfloat16
    x = torch.randn(shape, generator=gen, device=device).to(vtype)
    if mix == "mixed":
        x = x.transpose(1, 2)
    off_dy = spread * (2.0 * torch.rand(mshape, generator=gen, device=device) - 1.0)
    off_dx = spread * (2.0 * torch.rand(mshape, generator=gen, device=device) - 1.0)
    mod = torch.softmax(torch.randn((I_BATCH, side, side, groups, kk), generator=gen,
                                    device=device), dim=-1).reshape(mshape).to(vtype)
    g_out = torch.randn(shape, generator=gen, device=device).to(vtype)
    return x, off_dy, off_dx, mod, g_out


def check_deform_local(device, stage, side, channels, groups, mix, seed=0,
                       r: int = DL_MAX_OFFSET) -> dict:
    """Forward and the four gradients of the dense-local kernels against
    their plain versions, with times. ``mix`` is "f32" (everything float32,
    contiguous) or "mixed", what a DCNv3 layer under bf16 autocast gives in
    "dense_local_ref" mode: bf16 values as a spatial transpose view, fp32
    effective offsets, bf16 modulation. Offsets are drawn in +-(r + 1) for
    a clamp of +-r."""
    k = DL_KERNEL
    x, off_dy, off_dx, mod, g_out = dl_inputs(device, side, channels, groups, mix, seed,
                                              spread=r + 1)
    name = (f"{stage} x=[{I_BATCH},{side},{side},{channels}] G={groups} K={k} r={r} "
            f"{'f32' if mix == 'f32' else 'bf16 x^T + f32 offsets + bf16 modulation'}")
    args = (groups, k, r)

    def leaves():
        # detach() keeps a view's strides, so x stays a transposed view
        return [t.detach().requires_grad_(True) for t in (x, off_dy, off_dx, mod)]

    ins = leaves()
    out = dl.deform_dense_local_flat(*ins, *args)
    got = [out, *torch.autograd.grad(out, ins, g_out)]
    want = [dl.deform_dense_local_flat_reference(x, off_dy, off_dx, mod, *args),
            *dl.deform_dense_local_flat_backward_reference(x, off_dy, off_dx, mod, g_out, *args)]
    torch.cuda.synchronize()
    errs = {}
    for key, a, b in zip(("out", "d_x", "d_off_dy", "d_off_dx", "d_mod"), got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"[{name}] kernel {key} is {a.dtype} {tuple(a.shape)}, "
                                 f"plain {b.dtype} {tuple(b.shape)}")
        a, b = a.detach().float(), b.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"[{name}] kernel {key} is not finite")
        errs[key] = float((a - b).abs().max())
        tol = DL_TOL[mix] * max(1.0, float(b.abs().max()))
        if not errs[key] <= tol:
            raise AssertionError(f"[{name}] kernel {key} disagrees with the plain version: "
                                 f"max abs err {errs[key]:.3e} > {tol:.3e}")
    del got, want, out, ins

    def grad_setup():
        ins = leaves()
        return ins, dl.deform_dense_local_flat(*ins, *args)

    def run_grad(arg):
        ins, out = arg
        torch.autograd.grad(out, ins, g_out)

    with torch.no_grad():
        fwd_ms = cuda_median_ms(lambda _: dl.deform_dense_local_flat(x, off_dy, off_dx, mod, *args),
                                reps=10, warmup=2)
        fwd_plain = cuda_median_ms(
            lambda _: dl.deform_dense_local_flat_reference(x, off_dy, off_dx, mod, *args),
            reps=3, warmup=1)
        bwd_plain = cuda_median_ms(
            lambda _: dl.deform_dense_local_flat_backward_reference(x, off_dy, off_dx, mod,
                                                                    g_out, *args),
            reps=3, warmup=1)
    bwd_ms = cuda_median_ms(run_grad, setup=grad_setup, reps=10, warmup=2)
    with torch.no_grad():
        fwd_dev = device_ms(lambda _: dl.deform_dense_local_flat(x, off_dy, off_dx, mod, *args))
        fwd_held = held_ms(lambda _: dl.deform_dense_local_flat(x, off_dy, off_dx, mod, *args))
    bwd_dev = device_ms(run_grad, setup=grad_setup)
    bwd_held = held_ms(run_grad, setup=grad_setup)
    maps_dev = kernel_device_ms(run_grad, DL_MAPS_KERNEL, setup=grad_setup)
    corners = dl_corner_count(x, off_dy, off_dx, r)
    fwd_bound, fwd_by = dl_bound(x, (off_dy, off_dx, mod), groups, corners, backward=False)
    bwd_bound, bwd_by = dl_bound(x, (off_dy, off_dx, mod), groups, corners, backward=True)
    maps_bound, maps_by = dl_maps_bound(x, (off_dy, off_dx, mod), groups, corners)
    bwd_err = max(errs[key] for key in ("d_x", "d_off_dy", "d_off_dx", "d_mod"))
    log(f"  [{name}] max abs err " + " ".join(f"{k_} {v:.2e}" for k_, v in errs.items())
        + f"; ms fwd kernel {fwd_ms:.4f} (device {fwd_dev:.4f}, held {fwd_held:.4f}) plain {fwd_plain:.4f} bound "
        f"{fwd_bound:.4f} ({fwd_by}); bwd kernels {bwd_ms:.4f} (device {bwd_dev:.4f}, held "
        f"{bwd_held:.4f}) plain "
        f"{bwd_plain:.4f} bound {bwd_bound:.4f} ({bwd_by}), of it {DL_MAPS_KERNEL} device "
        f"{maps_dev} bound {maps_bound:.4f} ({maps_by}); {corners} corner rows read")
    return {
        "fwd": dict(shape=name, max_abs_err=errs["out"], ms=fwd_ms, device_ms=fwd_dev,
                    held_ms=fwd_held, plain_ms=fwd_plain, bound_ms=fwd_bound, bound_by=fwd_by, library_ms=None),
        "bwd": dict(shape=name, max_abs_err=bwd_err, ms=bwd_ms, device_ms=bwd_dev,
                    held_ms=bwd_held, plain_ms=bwd_plain, bound_ms=bwd_bound, bound_by=bwd_by,
                    library_ms=None,
                    maps_kernel=dict(device_ms=maps_dev, bound_ms=maps_bound, bound_by=maps_by)),
    }


def check_cache_gather(device, name, shape, dtype, seed=0) -> dict:
    """The cache-gather kernel against its plain version, bitwise, with times.
    Bound: every byte of cache read once and of out written once, plus the
    indices; there is no arithmetic. ``library_ms`` is the fastest of the
    three PyTorch calls that compute the same function: the advanced-indexing
    gather (which is also the plain version), ``torch.take_along_dim``, and
    ``torch.index_select`` of whole rows of the ``[B * NB, slab]`` view into
    a buffer the caller owns, with the flat row indices made beforehand;
    ``copy_ms`` is ``out.copy_(cache)`` on the same bytes, the copy floor of
    the library."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, nb = shape[:2]
    cache = torch.randn(shape, generator=gen, device=device).to(dtype)
    parent = torch.randint(0, nb, (b, nb), generator=gen, device=device)
    out = torch.empty_like(cache)
    label = f"{name} cache={list(shape)} {dtype_name(dtype)}"

    got = cg.beam_cache_gather(cache, parent, out=out)
    want = cg.beam_cache_gather_reference(cache, parent)
    torch.cuda.synchronize()
    if got is not out or got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"[{label}] the kernel did not fill the buffer it was given")
    mismatched = int((got.view(torch.uint8) != want.view(torch.uint8)).sum())
    err = float((got.float() - want.float()).abs().max())
    if mismatched or err != 0.0:
        raise AssertionError(f"[{label}] kernel differs from the plain version in "
                             f"{mismatched} bytes (max abs err {err:.3e}); it must be exact")
    parent32 = parent.to(torch.int32)
    if not torch.equal(cg.beam_cache_gather(cache, parent32), want):
        raise AssertionError(f"[{label}] kernel with int32 indices differs from the plain version")
    del got, want

    flat = cache.view(b, nb, -1)
    index = parent[:, :, None].expand(b, nb, flat.shape[2])
    rows, out_rows = cache.view(b * nb, -1), out.view(b * nb, -1)
    flat_parent = (torch.arange(b, device=device)[:, None] * nb + parent).reshape(-1)
    torch.index_select(rows, 0, flat_parent, out=out_rows)
    if not torch.equal(out, cg.beam_cache_gather_reference(cache, parent)):
        raise AssertionError(f"[{label}] index_select of whole rows is not the same function")
    reps = dict(reps=20, warmup=3)
    ms = cuda_median_ms(lambda _: cg.beam_cache_gather(cache, parent, out=out), **reps)
    plain_ms = cuda_median_ms(lambda _: cg.beam_cache_gather_reference(cache, parent), **reps)
    take_ms = cuda_median_ms(lambda _: torch.take_along_dim(flat, index, dim=1), **reps)
    select_ms = cuda_median_ms(
        lambda _: torch.index_select(rows, 0, flat_parent, out=out_rows), **reps)
    copy_ms = cuda_median_ms(lambda _: out.copy_(cache), **reps)
    # the device's work alone (profiler): is the gap to index_select on the
    # device or in the host's dispatch, which the CUDA events above hold?
    dev_reps = dict(reps=20, warmup=3)
    kernel_dev = device_ms(lambda _: cg.beam_cache_gather(cache, parent, out=out), **dev_reps)
    select_dev = device_ms(
        lambda _: torch.index_select(rows, 0, flat_parent, out=out_rows), **dev_reps)
    copy_dev = device_ms(lambda _: out.copy_(cache), **dev_reps)
    nbytes = cache.numel() * cache.element_size()
    bound, by = bound_ms(2 * nbytes + parent.numel() * parent.element_size(), 0, dtype)
    log(f"  [{label}] bitwise equal; {nbytes / 1e6:.1f} MB; ms kernel {ms:.4f} plain "
        f"(advanced indexing) {plain_ms:.4f} take_along_dim {take_ms:.4f} index_select "
        f"{select_ms:.4f} copy_ {copy_ms:.4f} bound {bound:.4f} ({by}); kernel at "
        f"{bound / ms:.3f} of its bound, {min(plain_ms, take_ms, select_ms) / ms:.3f}x the "
        f"fastest library call; device ms kernel {kernel_dev:.4f} index_select "
        f"{select_dev:.4f} copy_ {copy_dev:.4f}")
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=min(plain_ms, take_ms, select_ms),
                take_along_dim_ms=take_ms, index_select_ms=select_ms, copy_ms=copy_ms,
                device_ms=kernel_dev, index_select_device_ms=select_dev,
                copy_device_ms=copy_dev)


def phase_kernels(device) -> list[dict]:
    log("== phase 2: kernels vs plain versions at the main paths' shapes")
    resnet, swin, intern, mbv2, hrnet, vit = (check_upsample_ce(device, n, h, classes)
                                              for _, n, h, classes in UCE_SHAPES)
    convnext_fapn, xception = (check_upsample_ce(device, n, h, classes, w=w, out_hw=out_hw)
                               for _, n, h, w, classes, out_hw in UCE_ZOO_SHAPES)
    log(f"window attention (tol of max(1, max |plain|): {WA_TOL}); dbias err is in max abs err "
        "of the backward; sdpa is F.scaled_dot_product_attention, a yardstick only")
    wa_rows = {}
    for stage, bnw, heads, nw, _ in WA_STAGES:
        for shifted in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                key = (stage, shifted, dtype)
                wa_rows[key] = check_window_attention(device, stage, bnw, heads, nw, shifted,
                                                      dtype)
                torch.cuda.empty_cache()
    for stage, bnw, heads, nw in WA12_STAGES:
        for shifted in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                wa_rows[(stage, shifted, dtype, "N=144")] = check_window_attention(
                    device, stage, bnw, heads, nw, shifted, dtype, window=12)
                torch.cuda.empty_cache()
    log("streaming kernels (every f32 / bf16 shape with D <= 128 that the tensor-core "
        "routes do not take; each bitwise repeatable)")
    wa_stream = []
    for stage, bnw, heads, nw, window, d, dtype, routes in WA_STREAM_ROWS:
        t0 = time.perf_counter()
        wa_stream.append(check_window_attention(device, stage, bnw, heads, nw, True, dtype,
                                                window=window, d=d, routes=routes, repeat=True))
        log(f"  ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    stage, bnw, heads, nw, window, d, dtype, routes = WA_CUDA_CORE
    wa_cuda_core = check_window_attention(device, stage, bnw, heads, nw, True, dtype,
                                          window=window, d=d, routes=routes)
    torch.cuda.empty_cache()
    check_deterministic_sdpa(device)
    torch.cuda.empty_cache()
    log("global attention with a gradient without a mask: the global-attention kernel pair "
        "in bf16 and its split-TF32 form in fp32, and their bias forms with MOAT's relative "
        "bias (the route the ViT-L, EVA02-L and MOAT-4 train steps take); sdpa is "
        "F.scaled_dot_product_attention in the row's type (with the bias as its additive "
        "mask), deterministic sdpa under torch.use_deterministic_algorithms(True), the "
        "streaming window-attention pair with zero stand-ins where such a call went before: "
        "yardsticks only")
    gk_rows = {}  # (bias, f32) -> rows
    for row in GA_ROWS:
        t0 = time.perf_counter()
        gk_rows.setdefault((bool(row[6:]), row[5] == torch.float32), []).append(
            check_global_kernel(device, *row))
        log(f"  ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    log(f"dense-local sampling (tol of max(1, max |plain|): {DL_TOL}); the backward's max abs "
        "err is over its four gradients; no single PyTorch call computes this function")
    dl_rows = {}
    for stage, side, channels, groups, _ in DL_STAGES:
        for mix in ("f32", "mixed"):
            dl_rows[(stage, mix)] = check_deform_local(device, stage, side, channels, groups, mix)
            torch.cuda.empty_cache()
    log("beam cache gather (exact: every byte equal); library = the fastest of the "
        "advanced-indexing gather, torch.take_along_dim and torch.index_select of whole "
        "rows, timed here and used nowhere on the segmented path")
    cg_rows = []
    for name, shape, dtype in (*CG_PATH_SHAPES, *CG_SHAPES, CG_ODD_SHAPE):
        cg_rows.append(check_cache_gather(device, name, shape, dtype))
        torch.cuda.empty_cache()

    timers = "+".join(sorted(DEVICE_TIMERS))
    log(f"device_ms timed by: {timers}")

    # Top-level numbers: the shape each path launches most. The ResNet path
    # feeds the loss kernels fp32 logits (the model's fp32 cast); 18 of Swin-L's
    # 24 blocks are stage 2, under bf16 autocast, and so are 18 of
    # InternImage-T's 30; Gemma's beam-4 request reorders at W=256 for half of
    # its steps and at W=512 for the other half. "shapes" holds every shape.
    def entry(name, source, replaces, main, shapes):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None,
                **{("kernel_route" if k == "route" else k): v for k, v in main.items()},
                **({"device_timer": timers} if "device_ms" in main else {}),
                "shapes": shapes}

    uce_src = "iseg_tpu_torch/csrc/upsample_ce.cu"
    wa_src = "iseg_tpu_torch/csrc/window_attention.cu"
    dl_src = "iseg_tpu_torch/csrc/deform_local.cu"
    cg_src = "iseg_tpu_torch/csrc/cache_gather.cu"
    ga_src = "iseg_tpu_torch/csrc/global_attention.cu"
    uce_shapes = {d: [rows[dt][d] for rows in (resnet, swin, intern, mbv2, hrnet, vit,
                                               convnext_fapn, xception)
                      for dt in ("f32", "bf16")]
                  for d in ("fwd", "bwd")}
    # the split-TF32 rows have entries of their own (the N > 64 kernels, which
    # phase 6c runs, apart), and so have the streaming rows; the bf16 and
    # CUDA-core rows share the original two
    def wa_kernel(d, route, window12):
        if route == "stream":
            return f"{d}_stream"
        if route != "tf32x3":
            return d
        return f"{d}_tf32x3_large" if window12 else f"{d}_tf32x3"

    wa_shapes = {}
    for key, row in (*wa_rows.items(), *((("N=144",), r) for r in wa_stream),
                     (("N=49",), wa_cuda_core)):
        for d, shape in row.items():
            wa_shapes.setdefault(wa_kernel(d, shape["route"], "N=144" in key), []).append(shape)
    wa_main = wa_rows[("stage2", True, torch.bfloat16)]
    wa_main_f32 = wa_rows[("stage2", True, torch.float32)]
    wa_main_f32_w12 = wa_rows[("stage2", True, torch.float32, "N=144")]
    wa_main_stream = wa_stream[WA_STREAM_ROWS.index(
        next(r for r in WA_STREAM_ROWS if r[0] == "stage2" and r[4] == S16_WINDOW
             and r[6] == torch.bfloat16))]
    dl_shapes = {d: [row[d] for row in dl_rows.values()] for d in ("fwd", "bwd")}
    dl_main = dl_rows[("stage2", "mixed")]
    return [
        entry("upsample_ce_fwd", uce_src, "iseg_tpu/ops/pallas/upsample_ce.py:122",
              resnet["f32"]["fwd"], uce_shapes["fwd"]),
        entry("upsample_ce_bwd", uce_src, "iseg_tpu/ops/pallas/upsample_ce.py:159",
              resnet["f32"]["bwd"], uce_shapes["bwd"]),
        entry("window_attention_fwd", wa_src, "iseg_tpu/ops/pallas/window_attention.py:141",
              wa_main["fwd"], wa_shapes["fwd"]),
        entry("window_attention_bwd", wa_src, "iseg_tpu/ops/pallas/window_attention.py:161",
              wa_main["bwd"], wa_shapes["bwd"]),
        entry("window_attention_fwd_tf32x3", wa_src,
              "iseg_tpu/ops/pallas/window_attention.py:141", wa_main_f32["fwd"],
              wa_shapes["fwd_tf32x3"]),
        entry("window_attention_bwd_tf32x3", wa_src,
              "iseg_tpu/ops/pallas/window_attention.py:161", wa_main_f32["bwd"],
              wa_shapes["bwd_tf32x3"]),
        entry("window_attention_fwd_tf32x3_large", wa_src,
              "iseg_tpu/ops/pallas/window_attention.py:141", wa_main_f32_w12["fwd"],
              wa_shapes["fwd_tf32x3_large"]),
        entry("window_attention_bwd_tf32x3_large", wa_src,
              "iseg_tpu/ops/pallas/window_attention.py:161", wa_main_f32_w12["bwd"],
              wa_shapes["bwd_tf32x3_large"]),
        entry("window_attention_fwd_stream", wa_src,
              "iseg_tpu/ops/pallas/window_attention.py:141", wa_main_stream["fwd"],
              wa_shapes["fwd_stream"]),
        entry("window_attention_bwd_stream", wa_src,
              "iseg_tpu/ops/pallas/window_attention.py:161", wa_main_stream["bwd"],
              wa_shapes["bwd_stream"]),
        # the global-attention pair, which took global attention without a
        # mask over from the streaming pair: bias-free and in its bias form,
        # each in bf16 and in fp32 (split TF32) (no Pallas kernel: XLA's
        # jax.nn.dot_product_attention, iseg_tpu/nn/attention.py:58, and
        # MOAT's biased einsum, iseg_tpu/backbones/moat.py:69-88)
        *(entry(f"global_attention_{d}{'_bias' if bias else ''}{'_f32' if f32 else ''}",
                ga_src, "iseg_tpu/backbones/moat.py:70" if bias else "iseg_tpu/nn/attention.py:58",
                rows[0][d], [row[d] for row in rows])
          for (bias, f32), rows in gk_rows.items() for d in ("fwd", "bwd")),
        entry("deform_local_fwd", dl_src, "iseg_tpu/ops/pallas/deform_local.py:116",
              dl_main["fwd"], dl_shapes["fwd"]),
        entry("deform_local_bwd", dl_src, "iseg_tpu/ops/pallas/deform_local.py:146",
              dl_main["bwd"], dl_shapes["bwd"]),
        entry("cache_gather", cg_src, "iseg_tpu/ops/pallas/cache_gather.py:122",
              cg_rows[0], cg_rows),
    ]


# ------------------------------------------------------------ launch counts

# the global-attention pair's launch counts: bias-free and bias forms, bf16 and fp32
GA_FORMS = ("fwd", "bwd", "fwd_bias", "bwd_bias", "fwd_f32", "bwd_f32", "fwd_bias_f32",
            "bwd_bias_f32")


def reset_launch_counts() -> None:
    uce.reset_launch_counts()
    wa.reset_launch_counts()
    dl.reset_launch_counts()
    cg.reset_launch_counts()
    if ga is not None:
        ga.reset_launch_counts()


def read_launch_counts() -> dict[str, int]:
    return {"upsample_ce_fwd": uce.LAUNCH_COUNTS["fwd"], "upsample_ce_bwd": uce.LAUNCH_COUNTS["bwd"],
            "window_attention_fwd": wa.LAUNCH_COUNTS["fwd"],
            "window_attention_fwd_mma": wa.LAUNCH_COUNTS["fwd_mma"],
            "window_attention_bwd": wa.LAUNCH_COUNTS["bwd"],
            "window_attention_bwd_mma": wa.LAUNCH_COUNTS["bwd_mma"],
            "window_attention_fwd_tf32x3": wa.LAUNCH_COUNTS["fwd_tf32x3"],
            "window_attention_bwd_tf32x3": wa.LAUNCH_COUNTS["bwd_tf32x3"],
            "window_attention_fwd_stream": wa.LAUNCH_COUNTS["fwd_stream"],
            "window_attention_bwd_stream": wa.LAUNCH_COUNTS["bwd_stream"],
            **{f"global_attention_{key}": ga.LAUNCH_COUNTS.get(key, 0) if ga is not None else 0
               for key in GA_FORMS},
            "deform_local_fwd": dl.LAUNCH_COUNTS["fwd"], "deform_local_bwd": dl.LAUNCH_COUNTS["bwd"],
            "cache_gather": cg.LAUNCH_COUNTS["gather"]}


def expect_launches(path: str, got: dict[str, int], want: dict[str, int]) -> None:
    """``want`` names the kernels the path launches; every other count must be 0."""
    want = {**dict.fromkeys(got, 0), **want}
    log(f"kernel launches on the {path} path: {got}")
    if got != want:
        raise AssertionError(f"{path} path: expected kernel launches {want}, got {got}")


# ------------------------------------------------------------- ResNet path

def synthetic_batch(device, batch, num_class, hw=(HW, HW)):
    x = np.random.RandomState(0).rand(batch, *hw, 3).astype(np.float32)
    y = np.random.RandomState(1).randint(0, num_class, (batch, *hw)).astype(np.int32)
    return {"image": torch.tensor(x, device=device), "label": torch.tensor(y, device=device)}


def build_resnet_model(env, fused: bool) -> SegManaged:
    backbone = get_backbone("resnet50", output_stride=R_OS)
    model = SegManaged(num_class=R_CLASSES, backbone=backbone,
                       head=ASPP(backbone.out_channels, filters=256),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def dropout_generator(model) -> torch.Generator:
    gens = {id(m.generator): m.generator for m in model.modules()
            if isinstance(m, Dropout) and m.rate > 0}
    if len(gens) != 1:
        raise RuntimeError(f"expected one dropout generator, found {len(gens)}")
    return next(iter(gens.values()))


def train_steps(state, step_fn, data, warmup, timed, batch):
    """Run warmup + timed steps with the launch counts set to 0 just
    before; returns (state, losses, launch counts over all the steps,
    ms per timed step)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = []
    t_start = time.perf_counter()
    for _ in range(warmup):
        state, parts = step_fn(state, data)
        losses.append(parts["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, parts = step_fn(state, data)
        losses.append(parts["loss"])
    # the host's time in the steps' launch calls; these block while the
    # device's launch queue is full, so it never exceeds the step time by much
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launch_counts()
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated()
    log(f"losses: {[round(v, 5) for v in losses]}")
    tuning = "autotuning" if torch.backends.cudnn.benchmark else "heuristics"
    log(f"warm-up {warmup} steps took {t0 - t_start:.2f} s (cuDNN {tuning})")
    log(f"{1000 * dt / timed:.2f} ms/step, {batch * timed / dt:.2f} img/s, "
        f"peak memory {peak / 2**30:.2f} GiB ({peak} bytes); the host spent "
        f"{1000 * enqueued / timed:.2f} ms/step in the launch calls")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    return state, losses, launches, 1000 * dt / timed


def counted_train_steps(state, step_fn, data, warmup, timed, batch, want_per_step, title):
    """:func:`train_steps` with each step's launches held to ``want_per_step``."""
    per_step = []

    def counted_step(state, batch_data):
        before = read_launch_counts()
        state, parts = step_fn(state, batch_data)
        per_step.append({k: v - before[k] for k, v in read_launch_counts().items()})
        return state, parts

    state, losses, launches, step_ms = train_steps(state, counted_step, data, warmup, timed,
                                                   batch)
    for i, got in enumerate(per_step):
        expect_launches(f"{title} (step {i + 1})", got, want_per_step)
    return state, losses, launches, step_ms


def phase_resnet_train(env, data):
    log("== phase 3: ResNet train (fused upsample + CE kernels)")
    model = build_resnet_model(env, fused=True)
    tx, schedule = get_optimizer(param_tree(model), "sgd", learning_rate=0.01,
                                 train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    init_weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    init_dropout = dropout_generator(model).get_state()
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, losses, launches, step_ms = train_steps(state, step_fn, data, R_WARMUP, R_TIMED,
                                                   R_BATCH)
    log(f"lr now {schedule(state.step):.6f}")
    steps = R_WARMUP + R_TIMED
    expect_launches("ResNet train", launches,
                    {"upsample_ce_fwd": steps, "upsample_ce_bwd": steps})
    return model, init_weights, init_dropout, losses[0], launches, step_ms


def phase_resnet_unfused(env, data, init_weights, init_dropout, fused_first_loss):
    log("== phase 4: ResNet fused vs unfused")
    model = build_resnet_model(env, fused=False)
    model.load_state_dict(init_weights)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, None, tx, initialized=True)
    gen = torch.Generator(device=env.device)
    gen.set_state(init_dropout)
    set_dropout_generator(model, gen)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    reset_launch_counts()
    state, parts = step_fn(state, data)
    loss = float(parts["loss"])
    rel = abs(loss - fused_first_loss) / abs(fused_first_loss)
    log(f"first-step loss: fused {fused_first_loss:.6f} unfused {loss:.6f} "
        f"rel diff {rel:.3e} (tol {FUSED_UNFUSED_RTOL:g})")
    if any(read_launch_counts().values()):
        raise AssertionError("the unfused path launched the fused kernels")
    if not rel <= FUSED_UNFUSED_RTOL:
        raise AssertionError("fused and unfused first-step losses disagree")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(R_UNFUSED_TIMED):
        state, parts = step_fn(state, data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"unfused: {1000 * dt / R_UNFUSED_TIMED:.2f} ms/step, "
        f"{R_BATCH * R_UNFUSED_TIMED / dt:.2f} img/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss {float(parts['loss']):.5f}")
    return model


def check_served_against_low_res(name, logits, low, expect_shape):
    """Full-resolution served logits against the low-resolution ones of the
    training model, upsampled by hand."""
    if tuple(logits.shape) != expect_shape or logits.dtype != torch.float32:
        raise AssertionError(f"{name}: served logits {tuple(logits.shape)} {logits.dtype}, "
                             f"expected {expect_shape} float32")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name}: served logits are not finite")
    up = resize_image(low, (HW, HW), "bilinear")
    err = float((up - logits).abs().max())
    scale = float(logits.abs().max())
    pred = logits.argmax(dim=-1)
    log(f"{name}: served logits {tuple(logits.shape)}, classes predicted "
        f"{int(pred.unique().numel())}, max |served - upsampled low-res| {err:.3e} vs "
        f"max |logit| {scale:.3e} (tol {SERVE_RTOL:g} of it)")
    if not err <= SERVE_RTOL * scale:
        raise AssertionError(f"{name}: served logits disagree with the training model's logits")


def phase_resnet_serve(env, data, fused_model, serve_model):
    log("== phase 5: ResNet serve (single-scale inference, trained weights)")
    serve_model.load_state_dict(fused_model.state_dict())
    with torch.autocast("cuda", dtype=env.compute_dtype):
        logits = serve_model.inference(data["image"])
        low = fused_model.inference(data["image"])
    torch.cuda.synchronize()
    check_served_against_low_res("ResNet", logits, low, (R_BATCH, HW, HW, R_CLASSES))


# ---------------------------------------------------------- system path

class SyntheticShardSource:
    """``write_shards`` source of ``n`` samples at ``size``^2: class-coloured
    rectangles of classes 1..C-1 on a noisy background of class 0, and an
    ignore-label frame, from numpy seeded by the sample index."""

    def __init__(self, n: int, size: int, num_class: int):
        self.n, self.size, self.num_class = n, size, num_class
        self.palette = np.random.RandomState(0).randint(0, 256, (num_class, 3))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(100003 + i)
        s = self.size
        image = rng.normal(127.5, 24.0, (s, s, 3))
        label = np.zeros((s, s), np.int32)
        for _ in range(3):
            k = rng.randint(1, self.num_class)
            y, x = rng.randint(0, s // 2, 2)
            h, w = rng.randint(s // 8, s // 2, 2)
            image[y:y + h, x:x + w] = self.palette[k] + rng.normal(0.0, 12.0, (h, w, 3))
            label[y:y + h, x:x + w] = k
        label[:8] = label[-8:] = label[:, :8] = label[:, -8:] = 255
        return np.clip(image, 0, 255).astype(np.float32), label


class TimedModelHelper(ModelHelper):
    """``ModelHelper`` that keeps the seconds of each save."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.save_seconds = []

    def save(self, step, state):
        t0 = time.perf_counter()
        super().save(step, state)
        self.save_seconds.append(time.perf_counter() - t0)


def system_trainer(env, checkpoint_dir=None, resident=None, augment=None, log_dir=None):
    """A ``CoreTrain`` of the ResNet configuration, initialized from seed 0
    (every trainer starts from the same weights), recording each step's
    index vector and loss (a tensor: nothing waits for the device)."""
    model = build_resnet_model(env, fused=True)
    tx, schedule = get_optimizer(param_tree(model), "sgd", learning_rate=0.01,
                                 train_steps=1000)
    helper = (TimedModelHelper(checkpoint_dir, max_to_keep=2)
              if checkpoint_dir is not None else None)
    trainer = CoreTrain(env, model, tx, seed=0, checkpoint_manager=helper,
                        log_every=SYS_STEPS_PER_EPOCH, log_dir=log_dir, lr_schedule=schedule,
                        device_augment=augment, resident_dataset=resident)
    trainer.record = {"index": {}, "loss": {}}
    inner = trainer.train_step

    def recording_step(state, batch):
        if resident is not None:
            trainer.record["index"][state.step + 1] = np.asarray(batch).copy()
        state, parts = inner(state, batch)
        trainer.record["loss"][state.step] = parts["loss"]
        return state, parts

    trainer.train_step = recording_step
    return trainer


def zero_mean_augment(cfg):
    """The device augment followed by the ZERO_MEAN input normalization
    (0-255 -> [-1, 1]; the mean-pixel fill becomes 0)."""
    augment = make_device_augment(cfg)

    def fn(generator, images, labels):
        image, label = augment(generator, images, labels)
        return image / 127.5 - 1.0, label

    return fn


def recorded_losses(trainer, steps) -> list[float]:
    return [float(trainer.record["loss"][k]) for k in steps]


def phase_system(env, fixed_batch_ms: float, profile: bool) -> dict[str, int]:
    """Phase 5b: write shards, upload them, train with the device augment
    through ``CoreTrain`` with checkpoints, restore, preempt and resume,
    stream the same shards, and evaluate to mIoU. Returns the loss-kernel
    launches of the uninterrupted resident run. ``profile`` adds the device
    time of a resident step and of its input stage (gather + augment)."""
    log("== phase 5b: system (shards -> resident dataset -> device augment -> CoreTrain "
        "-> checkpoints, preemption, resume -> evaluate)")
    card = card_line()

    def say(msg: str) -> None:  # every number of the phase beside the card
        log(f"{msg} ({card})")

    steps = SYS_EPOCHS * SYS_STEPS_PER_EPOCH
    with tempfile.TemporaryDirectory(prefix="iseg_system_") as tmp:
        shard_dir = os.path.join(tmp, "shards")
        t0 = time.perf_counter()
        index = write_shards(SyntheticShardSource(SYS_SAMPLES, SYS_STORE, R_CLASSES), shard_dir,
                             store_size=(SYS_STORE, SYS_STORE), samples_per_shard=48)
        say(f"wrote {index['num_samples']} samples at {SYS_STORE}^2 in "
            f"{len(index['shards'])} shards in {time.perf_counter() - t0:.2f} s")
        reader = ShardReader(shard_dir)
        t0 = time.perf_counter()
        resident = DeviceResidentDataset(reader, device=env.device)
        say(f"resident dataset: {resident.num_samples} samples, {resident.nbytes()} bytes "
            f"({resident.nbytes() / 1e6:.1f} MB) on the card, uploaded in "
            f"{time.perf_counter() - t0:.3f} s")
        augment = zero_mean_augment(DeviceAugmentConfig(
            crop_size=(HW, HW), min_scale_factor=0.5, max_scale_factor=2.0,
            scale_step_size=0.25, flip_prob=0.5))
        index_fn = resident.index_dataset_fn(R_BATCH, seed=0)

        # uninterrupted resident run: the main path of this phase
        ckpt_a, log_dir = os.path.join(tmp, "ckpt_a"), os.path.join(tmp, "log")
        run_a = system_trainer(env, ckpt_a, resident, augment, log_dir)
        epoch_ends = {}

        def mark(epoch, state):
            torch.cuda.synchronize()
            epoch_ends[epoch] = time.perf_counter()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        history = run_a.train(index_fn, epochs=SYS_EPOCHS, steps_per_epoch=SYS_STEPS_PER_EPOCH,
                              on_epoch_end=mark)
        launches = read_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expect_launches("system train", launches,
                        {"upsample_ce_fwd": steps, "upsample_ce_bwd": steps})
        losses_a = recorded_losses(run_a, range(1, steps + 1))
        say(f"resident run: losses {[round(v, 5) for v in losses_a]}")
        if run_a.state.step != steps or not all(np.isfinite(losses_a)):
            raise AssertionError(f"resident run ended at step {run_a.state.step} with losses "
                                 f"{losses_a}")
        # after the first epoch, each epoch's own clock: its steps, from an
        # idle device to the loss read at its last step (its checkpoint is
        # written after it)
        later = history[1:]
        ms = 1e3 * sum(r["seconds"] for r in later) / sum(r["steps"] for r in later)
        helper_a = run_a.checkpoint_manager
        say(f"system resident train: {ms:.2f} ms/step, {R_BATCH * 1e3 / ms:.2f} img/s over "
            f"epochs 2-{SYS_EPOCHS} (gather + device augment + step; host clock), against "
            f"{fixed_batch_ms:.2f} ms/step on phase 3's fixed batch in this call; peak memory "
            f"{peak / 2**30:.2f} GiB ({peak} bytes); checkpoint saves "
            f"{[round(v, 3) for v in helper_a.save_seconds]} s")
        if helper_a.all_steps() != [2 * SYS_STEPS_PER_EPOCH, steps]:
            raise AssertionError(f"checkpoints at {helper_a.all_steps()}, expected the last two "
                                 "epochs' only (max_to_keep=2)")
        events = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
        rows = read_event_scalars(os.path.join(log_dir, events[0]))
        logged = sorted(step for step, tag, _ in rows if tag == "train/loss")
        say(f"event file: {len(rows)} scalars, train/loss at steps {logged}")
        if len(events) != 1 or logged != list(range(SYS_STEPS_PER_EPOCH, steps + 1,
                                                     SYS_STEPS_PER_EPOCH)):
            raise AssertionError(f"event files {events}, train/loss at {logged}")

        # restore into a fresh trainer: every tensor bitwise
        fresh = system_trainer(env, ckpt_a, resident, augment)
        t0 = time.perf_counter()
        restored_step = fresh.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mismatched = [f"{col}/{k}" for col in ("params", "batch_stats")
                      for k, v in getattr(run_a.state, col).items()
                      if not torch.equal(v, getattr(fresh.state, col)[k])]
        mismatched += [f"momentum[{i}]" for i, (a, b) in enumerate(
            zip(run_a.state.opt_state.trace, fresh.state.opt_state.trace)) if not torch.equal(a, b)]
        if fresh.state.opt_state.count != run_a.state.opt_state.count:
            mismatched.append("opt_state.count")
        say(f"restore: step {restored_step} in {restore_s:.3f} s, "
            f"{len(run_a.state.params)} params, {len(run_a.state.batch_stats)} batch_stats, "
            f"{len(run_a.state.opt_state.trace)} momentum buffers; mismatched: "
            f"{mismatched or 'none'}")
        if restored_step != steps or mismatched:
            raise AssertionError("the restored state differs from the saved one")
        del fresh

        # preempted by SIGTERM before the 5th batch, then resumed
        ckpt_b = os.path.join(tmp, "ckpt_b")
        run_b = system_trainer(env, ckpt_b, resident, augment)

        def preempting(epoch):
            for i, batch in enumerate(index_fn(epoch)):
                if epoch * SYS_STEPS_PER_EPOCH + i + 1 == SYS_PREEMPT_BATCH:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

        run_b.train(preempting, epochs=SYS_EPOCHS, steps_per_epoch=SYS_STEPS_PER_EPOCH)
        saved = run_b.checkpoint_manager.all_steps()
        say(f"preempted run returned at step {run_b.state.step}; checkpoints {saved}")
        if run_b.state.step != SYS_PREEMPT_BATCH or saved[-1] != SYS_PREEMPT_BATCH:
            raise AssertionError(f"expected a durable checkpoint at step {SYS_PREEMPT_BATCH}")
        run_c = system_trainer(env, ckpt_b, resident, augment)
        resumed_from = run_c.restore()
        reset_launch_counts()
        run_c.train(index_fn, epochs=SYS_EPOCHS, steps_per_epoch=SYS_STEPS_PER_EPOCH,
                    initial_epoch=-1)
        resumed = steps - resumed_from
        expect_launches("system resume", read_launch_counts(),
                        {"upsample_ce_fwd": resumed, "upsample_ce_bwd": resumed})
        consumed = {**run_b.record["index"], **run_c.record["index"]}
        same_stream = (sorted(consumed) == sorted(run_a.record["index"]) and all(
            np.array_equal(consumed[k], run_a.record["index"][k]) for k in consumed))
        tail = range(resumed_from + 1, steps + 1)
        gaps = [abs(b - a) / abs(a) for a, b in zip(recorded_losses(run_a, tail),
                                                     recorded_losses(run_c, tail))]
        head_gaps = [abs(b - a) / abs(a) for a, b in zip(
            recorded_losses(run_a, range(1, resumed_from + 1)),
            recorded_losses(run_b, range(1, resumed_from + 1)))]
        say(f"resume: from step {resumed_from} to {run_c.state.step}; index vectors of steps "
            f"1-{steps} equal to the uninterrupted run's: {same_stream}; loss rel gaps at steps "
            f"{list(tail)}: {[f'{g:.3e}' for g in gaps]} (tol {SYS_RESUME_RTOL:g}); steps "
            f"1-{resumed_from} before the preemption: {[f'{g:.3e}' for g in head_gaps]}")
        if resumed_from != SYS_PREEMPT_BATCH or run_c.state.step != steps or not same_stream:
            raise AssertionError("the resumed run did not continue the interrupted stream")
        if not max(gaps + head_gaps) <= SYS_RESUME_RTOL:
            raise AssertionError("the resumed run's losses left the uninterrupted run's")
        if profile:
            profile_resident_step(run_c, resident, augment, ms)
        del run_b, run_c

        # stream mode (host shards + device_prefetch) against the resident
        # path, both without augment, from the same weights: first-step loss
        stream = system_trainer(env)
        stream.train(make_shard_dataset_fn(shard_dir, R_BATCH, seed=0), epochs=1,
                     steps_per_epoch=1)
        plain_resident = system_trainer(env, resident=resident)
        plain_resident.train(index_fn, epochs=1, steps_per_epoch=1)
        a, b = float(stream.record["loss"][1]), float(plain_resident.record["loss"][1])
        say(f"first-step loss without augment: stream {a:.7f}, resident {b:.7f}, rel diff "
            f"{abs(a - b) / abs(b):.3e} (tol {SYS_STREAM_RTOL:g})")
        if not abs(a - b) <= SYS_STREAM_RTOL * abs(b):
            raise AssertionError("the stream and resident paths disagree on the first step")
        del stream, plain_resident

        phase_system_evaluate(env, ckpt_a, reader, card)
        del run_a, resident
    return launches


def profile_resident_step(trainer, resident, augment, wall_ms: float, steps: int = 3) -> None:
    """Device time of the resident train step, and of its input stage alone
    (the gather of a batch from the resident tensors + the device augment)."""
    from torch.profiler import ProfilerActivity, profile

    idx = next(iter(resident.index_batches(R_BATCH)))
    step = profile_steps(trainer.state, trainer.train_step, idx, "resident train step (gather "
                         "+ device augment + step)", wall_ms, steps)
    generator = torch.Generator(device=resident.device).manual_seed(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            augment(generator, *resident.gather(idx))
        torch.cuda.synchronize()
    kernels = [(getattr(e, "self_device_time_total", 0) or e.self_cuda_time_total, e.key)
               for e in prof.key_averages() if e.device_type.name == "CUDA"]
    stage_ms = sum(us for us, _ in kernels) / 1e3 / steps
    log(f"-- input stage alone (gather + device augment, {steps} batches): {stage_ms:.3f} ms "
        f"device per batch, {100 * stage_ms / step['device_ms']:.2f}% of the step's "
        f"{step['device_ms']:.3f} ms ({card_line()})")
    for us, key in sorted(kernels, reverse=True)[:12]:
        log(f"   {us / 1e3 / steps:10.3f} ms/batch  {key[:110]}")


def phase_system_evaluate(env, checkpoint_dir, reader, card) -> None:
    """``evaluate`` over the first samples of the shards at their store size
    with the restored variables, against ``MeanIoU`` over
    ``SegBase.inference`` logits of the same batches."""
    model = build_resnet_model(env, fused=False)  # logits at the input's resolution
    variables = ModelHelper(checkpoint_dir).restore_latest_variables(
        {"params": param_tree(model), "batch_stats": batch_stats_tree(model)})
    config = SegModelInferenceConfig(scale_rates=(0.75, 1.0), flip=True,
                                     sliding_window_crop_size=(SYS_EVAL_WINDOW, SYS_EVAL_WINDOW))
    starts = range(0, SYS_EVAL_SAMPLES, SYS_EVAL_BATCH)

    def batches():
        for s in starts:
            image, label = reader.gather(np.arange(s, s + SYS_EVAL_BATCH))
            yield {"image": image, "label": label}

    results = []
    for _ in range(2):  # the first call of these shapes includes cuDNN autotuning
        metric = MeanIoU(R_CLASSES)
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        miou, per_class = evaluate(env, model, variables, batches(), inference_config=config,
                                   verbose=False, metric=metric)
        torch.cuda.synchronize()
        results.append((miou, per_class, metric.total_cm, 1e3 * (time.perf_counter() - t0)))
        expect_launches("system evaluate", read_launch_counts(), {})
    with torch.no_grad():
        for col, tree in (("params", param_tree(model)), ("batch_stats", batch_stats_tree(model))):
            for k, t in tree.items():
                t.copy_(variables[col][k])
    reference = MeanIoU(R_CLASSES)
    labelled = 0
    for batch in batches():
        image = torch.tensor(batch["image"], device=env.device).to(torch.float32)
        label = torch.tensor(batch["label"], device=env.device)
        with torch.autocast("cuda", dtype=env.compute_dtype):
            logits = model.inference(image, config)
        reference.update_state(label, logits)
        labelled += int((label != model.ignore_label).sum())
    miou, per_class, cm, first_ms = results[0]
    n = len(starts)
    log(f"evaluate: {SYS_EVAL_SAMPLES} samples at {SYS_STORE}^2, batch {SYS_EVAL_BATCH}, scales "
        f"(0.75, 1.0) + flip + {SYS_EVAL_WINDOW}^2 sliding window: mIoU {miou:.6f}, confusion "
        f"matrix counts {cm.sum():.0f} of {labelled} labelled pixels; {first_ms / n:.2f} ms per "
        f"eval batch on the first call, {results[1][3] / n:.2f} on the second ({card})")
    log(f"evaluate vs MeanIoU over SegBase.inference: mIoU {miou:.9f} / {reference.result():.9f}, "
        f"confusion matrices equal: {np.array_equal(cm, reference.total_cm)} ({card})")
    if cm.sum() != labelled:
        raise AssertionError("the eval confusion matrix does not count every labelled pixel once")
    for other_miou, other_per_class, other_cm in ((results[1][:3]),
                                                  (reference.result(), reference.per_class_iou(),
                                                   reference.total_cm)):
        if not (np.array_equal(cm, other_cm) and miou == other_miou
                and np.array_equal(per_class, other_per_class)):
            raise AssertionError("evaluate disagrees with MeanIoU over SegBase.inference")


# ----------------------------------------------------- MobileNetV2 + examples

def build_mbv2_model(env, fused: bool) -> SegManaged:
    backbone = get_backbone("mobilenetv2", output_stride=M_OS)
    model = SegManaged(num_class=M_CLASSES, backbone=backbone,
                       head=SimpleDecoder(backbone.endpoint_channels),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def phase_mbv2_train(env, profile: bool):
    """Phase 5c.1: the MobileNetV2 + SimpleDecoder step on a fixed batch,
    fused, then one unfused step from the same weights. Returns the launch
    counts and the fused ms/step."""
    log("-- 5c.1: MobileNetV2 (width 1.0, os16, top conv 1280) + SimpleDecoder(256, 48), "
        f"{M_CLASSES} classes, {HW}x{HW}, batch {M_BATCH}, bf16 autocast, fused loss")
    data = synthetic_batch(env.device, M_BATCH, M_CLASSES)
    model = build_mbv2_model(env, fused=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000,
                          warmup_steps=5)
    state = create_train_state(model, env.generator, tx)
    init_weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, losses, launches, step_ms = train_steps(state, step_fn, data, M_WARMUP, M_TIMED,
                                                   M_BATCH)
    steps = M_WARMUP + M_TIMED
    expect_launches("MobileNetV2 train", launches,
                    {"upsample_ce_fwd": steps, "upsample_ce_bwd": steps})
    log(f"MobileNetV2 train: {step_ms:.2f} ms/step, {M_BATCH * 1e3 / step_ms:.2f} img/s "
        f"({card_line()})")
    if profile:
        profile_steps(state, step_fn, data, "MobileNetV2 + SimpleDecoder train step", step_ms)

    unfused = build_mbv2_model(env, fused=False)
    unfused.load_state_dict(init_weights)
    u_state = create_train_state(unfused, None, tx, initialized=True)
    reset_launch_counts()
    _, parts = make_train_step(unfused.build_loss_fn(), compute_dtype=env.compute_dtype)(
        u_state, data)
    loss = float(parts["loss"])
    rel = abs(loss - losses[0]) / abs(losses[0])
    log(f"MobileNetV2 first-step loss: fused {losses[0]:.6f} unfused {loss:.6f} rel diff "
        f"{rel:.3e} (tol {FUSED_UNFUSED_RTOL:g})")
    if any(read_launch_counts().values()):
        raise AssertionError("the unfused MobileNetV2 step launched the fused kernels")
    if not rel <= FUSED_UNFUSED_RTOL:
        raise AssertionError("MobileNetV2 fused and unfused first-step losses disagree")
    return launches, step_ms


def phase_train_seg(env, tmp: str, fixed_batch_ms: float) -> tuple[dict, str]:
    """Phase 5c.2: ``train_seg.main`` in this process on its synthetic data,
    2 epochs x 4 steps, then rerun with 3 epochs: it resumes at step 8 and
    ends at 12. Returns the launch counts of both runs and the checkpoint
    directory."""
    ckpt = os.path.join(tmp, "train_seg")
    args = ["--backbone", "mobilenetv2", "--head", "simpledecoder", "--crop", str(HW),
            "--batch", str(M_BATCH), "--steps_per_epoch", str(EX_STEPS_PER_EPOCH),
            "--fused_loss", "--eval_scales", "0.75,1.0", "--flip_eval", "--ckpt_dir", ckpt]
    log(f"-- 5c.2: train_seg.main({' '.join(args)} --epochs 2), then --epochs 3")
    reset_launch_counts()
    first = train_seg_example.main(args + ["--epochs", "2"])
    second = train_seg_example.main(args + ["--epochs", "3"])
    launches = read_launch_counts()
    steps = 3 * EX_STEPS_PER_EPOCH
    expect_launches("train_seg", launches, {"upsample_ce_fwd": steps, "upsample_ce_bwd": steps})
    saved = ModelHelper(ckpt).all_steps()
    losses = [r["loss"] for r in first["history"] + second["history"]]
    log(f"train_seg: first run {first['resumed_from']} -> {first['step']}, rerun resumed at "
        f"{second['resumed_from']} -> {second['step']}; checkpoints {saved}; epoch losses "
        f"{[round(v, 5) for v in losses]}; mIoU {first['miou']:.4f} then {second['miou']:.4f}")
    log(f"train_seg: {first['ms_per_step']:.2f} ms/step over epoch 2 of the first run (host "
        f"augment of {M_BATCH} images + prefetch + step; host clock) against "
        f"{fixed_batch_ms:.2f} ms/step on 5c.1's fixed batch ({card_line()})")
    if (first["step"] != 2 * EX_STEPS_PER_EPOCH or second["resumed_from"] != first["step"]
            or second["step"] != steps or saved != [2 * EX_STEPS_PER_EPOCH, steps]):
        raise AssertionError("train_seg did not checkpoint and resume at the saved step")
    if not (all(np.isfinite(losses)) and np.isfinite(second["miou"])):
        raise AssertionError("train_seg gave non-finite losses or mIoU")
    return launches, ckpt


def ohem_kept(model, logits, labels) -> tuple[int, int, int]:
    """(valid, hard, kept) pixel counts of ``model``'s OHEM selector on the
    per-pixel CE of low-res ``logits`` upsampled to the labels: hard are the
    valid pixels whose true-class probability is below the threshold."""
    up = resize_image(logits, tuple(labels.shape[1:]), "bilinear")
    pixel = cross_entropy_ignore_label(up, labels, reduction="none")
    mask = (labels != 255).to(torch.float32)
    true_prob = torch.exp(-pixel)  # the true class's probability on the valid pixels
    kept = get_ohem_fn(model.ohem_thresh, model.ohem_min_kept, model.ohem_ref_exact)(
        pixel, true_prob, mask)
    hard = (true_prob < (model.ohem_thresh or 0.0)) & (mask > 0)
    return int(mask.sum()), int(hard.sum()), int((kept * mask).sum())


def ohem_batches(env, model, data):
    """(title, logits, labels, min_kept, compared with the CPU port): the
    seed-0 model's logits on ``data`` with a tenth of its labels ignored
    (every valid pixel is hard there); then a batch where the selectors
    choose, random logits (x8) whose upsampled argmax is the label but for
    1% of pixels, a tenth ignored, at the configuration's ``min_kept`` (the
    hard pixels outnumber it) and at 2,000,000 (the hardest-k fill)."""
    rng = np.random.RandomState(5)
    shape = (R_BATCH, HW, HW)
    ignore = torch.tensor(rng.rand(*shape) < 0.1, device=env.device)
    with torch.no_grad(), torch.autocast("cuda", dtype=env.compute_dtype):
        logits = model(data["image"]).float()
    side = HW // R_OS
    sharp = torch.tensor(8.0 * rng.randn(R_BATCH, side, side, R_CLASSES).astype(np.float32),
                         device=env.device)
    labels = resize_image(sharp, (HW, HW), "bilinear").argmax(-1).to(torch.int32)
    flip = torch.tensor(rng.rand(*shape) < 0.01, device=env.device)
    other = torch.tensor(rng.randint(0, R_CLASSES, shape).astype(np.int32), device=env.device)
    labels = torch.where(flip, other, labels)
    labels = labels.masked_fill(ignore, 255)
    title = "random logits x8, labels their argmax but 1%"
    return (("the seed-0 model's logits", logits, data["label"].masked_fill(ignore, 255),
             model.ohem_min_kept, False),
            (title, sharp, labels, model.ohem_min_kept, True),
            (title, sharp, labels, EX_OHEM_FILL_MIN_KEPT, True))


def phase_ohem(env, tmp: str) -> dict[str, int]:
    """Phase 5c.3: config #2 (ResNet-50 + ASPP with OHEM) through
    ``train_seg``: OHEM gates the fused loss off. Then each selector's
    pixel counts at the seed-0 model's logits (step 1), and on a batch where
    the selectors choose, its loss on the card against the CPU port's on the
    same logits and labels."""
    args = ["--backbone", "resnet50", "--head", "aspp", "--ohem", "--fused_loss", "--batch",
            str(R_BATCH), "--crop", str(HW), "--epochs", "1", "--steps_per_epoch",
            str(EX_OHEM_STEPS), "--ckpt_dir", os.path.join(tmp, "ohem")]
    log(f"-- 5c.3: config #2, train_seg.main({' '.join(args)})")
    reset_launch_counts()
    out = train_seg_example.main(args)
    launches = read_launch_counts()
    expect_launches("train_seg --ohem", launches, {})
    losses = [r["loss"] for r in out["history"]]
    log(f"train_seg --ohem: {out['step']} steps, last loss {losses[-1]:.5f}, mIoU "
        f"{out['miou']:.4f}")
    if out["step"] != EX_OHEM_STEPS or not all(np.isfinite(losses)):
        raise AssertionError("the OHEM run did not train to finite losses")

    data = synthetic_batch(env.device, R_BATCH, R_CLASSES)
    model = train_seg_example.build_model("resnet50", "aspp", R_CLASSES, device=env.device,
                                          use_ohem=True, upsample_logits=False,
                                          fuse_upsample_loss=True)
    create_train_state(model, torch.Generator().manual_seed(0),
                       get_optimizer(param_tree(model), "sgd")[0])
    shape = f"[{R_BATCH},{HW // R_OS},{HW // R_OS},{R_CLASSES}] -> [{R_BATCH},{HW},{HW}]"
    for title, logits, labels, min_kept, compare in ohem_batches(env, model, data):
        model.ohem_min_kept = min_kept
        for ref_exact in (False, True):
            model.ohem_ref_exact = ref_exact
            name = "ref_exact" if ref_exact else "default"
            valid, hard, kept = ohem_kept(model, logits, labels)
            log(f"OHEM {name} (thresh {model.ohem_thresh}, min_kept {model.ohem_min_kept}), "
                f"{title}, {shape}: {valid} valid pixels, {hard} hard, {kept} kept")
            if not compare:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = float(model.build_loss_fn()(logits, labels)[0])
            card_ms = 1e3 * (time.perf_counter() - t0)
            host = float(model.build_loss_fn()(logits.cpu(), labels.cpu())[0])
            rel = abs(card - host) / abs(host)
            log(f"OHEM {name} loss: card {card:.7f} CPU port {host:.7f} rel diff {rel:.3e} (tol "
                f"{OHEM_RTOL:g}); the card's loss (upsample + CE + selector) {card_ms:.2f} ms, "
                f"host clock ({card_line()})")
            if not rel <= OHEM_RTOL:
                raise AssertionError(f"OHEM {name}: the card's loss differs from the CPU port's")
    return launches


def eval_both_ways(env, model, variables, batches, config: dict, title: str) -> None:
    """``evaluate`` with ``use_cpu_cache`` off, then on: equal confusion
    matrices (or, where an argmax parts, logits apart by more than that
    pixel's top-two gap fail), the bucket count, ms per image and peak
    device memory of each."""
    results = {}
    n_images = sum(b["image"].shape[0] for b in batches)
    for cached in (False, False, True):  # the first call of these shapes autotunes cuDNN
        cfg = SegModelInferenceConfig(**config, use_cpu_cache=cached)
        metric = MeanIoU(M_CLASSES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        miou, _ = evaluate(env, model, variables, batches, inference_config=cfg, verbose=False,
                           metric=metric)
        torch.cuda.synchronize()
        results[cached] = (miou, metric.total_cm, 1e3 * (time.perf_counter() - t0) / n_images,
                           torch.cuda.max_memory_allocated(), evaluate.last_num_programs)
    for cached, (miou, cm, ms, peak, programs) in results.items():
        log(f"{title}, use_cpu_cache={cached}: mIoU {miou:.6f}, {ms:.2f} ms per image, peak "
            f"device memory {peak / 2**30:.3f} GiB ({peak} bytes), {programs} input shapes "
            f"({card_line()})")
    (_, cm_off, _, _, p_off), (_, cm_on, _, _, p_on) = results[False], results[True]
    if p_off != p_on:
        raise AssertionError(f"{title}: the two ways saw {p_off} and {p_on} input shapes")
    if np.array_equal(cm_off, cm_on):
        log(f"{title}: confusion matrices equal with and without the CPU cache")
        return
    # the top-two-gap rule: a parted argmax must sit on a near-tie
    plain = make_eval_step(model, SegModelInferenceConfig(**config), variables,
                           env.compute_dtype)
    cached = make_eval_step(model, SegModelInferenceConfig(**config, use_cpu_cache=True),
                            variables, env.compute_dtype)
    pad = (bucket_padder(config["bucket_multiple"], 0.0, 255) if config.get("bucket_multiple")
           else (lambda b: b))
    for batch in batches:
        image = torch.tensor(np.asarray(pad(batch)["image"]), device=env.device)
        a, b = plain(image).cpu(), cached(image)
        err = float((a - b).abs().max())
        top2 = a.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        parted = a.argmax(-1) != b.argmax(-1)
        worst = float(gap[parted].max()) if bool(parted.any()) else 0.0
        log(f"{title}: logits max abs diff {err:.3e}; {int(parted.sum())} argmaxes parted, "
            f"largest top-two gap among them {worst:.3e}")
        if worst > err:
            raise AssertionError(f"{title}: the CPU cache changed a prediction beyond a near-tie")


def phase_eval_buckets(env, ckpt: str) -> None:
    """Phase 5c.4: ``evaluate`` of the train_seg model, with buckets and the
    CPU cache, on VOC-like sizes, then one Cityscapes-size image."""
    model = build_mbv2_model(env, fused=False)
    variables = ModelHelper(ckpt).restore_latest_variables(
        {"params": param_tree(model), "batch_stats": batch_stats_tree(model)})
    rng = np.random.RandomState(7)
    voc = []
    for h, w in EX_EVAL_SIZES * 2:
        label = rng.randint(0, M_CLASSES, (1, h, w))
        voc.append({"image": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
                    "label": np.where(rng.rand(1, h, w) < 0.1, 255, label).astype(np.int32)})
    want = len(bucket_stats(EX_EVAL_SIZES, EX_BUCKET))
    log(f"-- 5c.4: evaluate, {len(voc)} images of sizes {EX_EVAL_SIZES} (two each), batch 1, "
        f"bucket_multiple {EX_BUCKET} ({want} buckets), scales (0.75, 1.0) + flip")
    eval_both_ways(env, model, variables, voc, dict(scale_rates=(0.75, 1.0), flip=True,
                                                    bucket_multiple=EX_BUCKET), "VOC-like eval")
    for cached in (False, True):
        evaluate(env, model, variables, voc, verbose=False,
                 inference_config=SegModelInferenceConfig(scale_rates=(0.75, 1.0), flip=True,
                                                          bucket_multiple=EX_BUCKET,
                                                          use_cpu_cache=cached))
        if evaluate.last_num_programs != want:
            raise AssertionError(f"last_num_programs {evaluate.last_num_programs}, bucket_stats "
                                 f"counts {want}")
    h, w = EX_BIG
    label = rng.randint(0, M_CLASSES, (1, h, w)).astype(np.int32)
    big = [{"image": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32), "label": label}]
    log(f"-- 5c.4: evaluate, one {h}x{w} image, scales {EX_BIG_SCALES} + flip, "
        f"{EX_BIG_WINDOW}x{EX_BIG_WINDOW} sliding window")
    eval_both_ways(env, model, variables, big,
                   dict(scale_rates=EX_BIG_SCALES, flip=True,
                        sliding_window_crop_size=(EX_BIG_WINDOW, EX_BIG_WINDOW)),
                   f"{h}x{w} sliding eval")

    # predict: default_image_predict over a bucketed batch is the argmax of
    # SegBase.inference on it
    images = np.concatenate([voc[0]["image"], voc[len(EX_EVAL_SIZES)]["image"]])  # one size
    padded, _, _ = pad_batch_to_bucket(images, None, EX_BUCKET)
    batch = torch.tensor(padded, device=env.device)
    config = SegModelInferenceConfig(scale_rates=(0.75, 1.0), flip=True)
    with torch.no_grad():
        for col, tree in (("params", param_tree(model)), ("batch_stats", batch_stats_tree(model))):
            for k, t in tree.items():
                t.copy_(variables[col][k])
    preds = default_image_predict(model, batch, config, env.compute_dtype)
    with torch.autocast("cuda", dtype=env.compute_dtype):
        logits = model.inference(batch, config)
    equal = bool(torch.equal(preds, logits.argmax(-1).to(torch.int32)))
    log(f"-- 5c.5: default_image_predict over a bucketed batch {tuple(batch.shape)}: "
        f"{tuple(preds.shape)} {preds.dtype}, equal to the argmax of SegBase.inference: {equal}")
    if not equal:
        raise AssertionError("default_image_predict differs from SegBase.inference's argmax")
    check_predict_with_dir(env, model, config)


def check_predict_with_dir(env, model, config) -> None:
    """5c.5's ``predict_with_dir`` on the card, where PIL imports: a
    directory of seeded RGB PNGs predicted to label PNGs, read back and held
    equal to ``default_image_predict``'s argmax of the same images, padded
    with the mean pixel to the bucket and normalized as the function pads
    them."""
    try:
        from PIL import Image
    except ImportError:
        log("-- 5c.5: predict_with_dir not run: PIL does not import here")
        return
    rng = np.random.RandomState(11)
    h, w = EX_PREDICT_HW
    pixels = rng.randint(0, 256, (EX_PREDICT_IMAGES, h, w, 3)).astype(np.uint8)
    with tempfile.TemporaryDirectory(prefix="iseg_predict_") as tmp:
        src, dst = os.path.join(tmp, "images"), os.path.join(tmp, "labels")
        os.makedirs(src)
        for i, image in enumerate(pixels):
            Image.fromarray(image).save(os.path.join(src, f"img_{i}.png"))
        t0 = time.perf_counter()
        written = predict_with_dir(model, src, dst, batch_size=EX_PREDICT_IMAGES,
                                   pad_multiple=EX_BUCKET, inference_config=config,
                                   verbose=False, compute_dtype=env.compute_dtype)
        seconds = time.perf_counter() - t0
        got = np.stack([np.asarray(Image.open(os.path.join(dst, f"img_{i}.png")))
                        for i in range(EX_PREDICT_IMAGES)])
    bh, bw = bucket_hw(h, w, EX_BUCKET)
    batch = np.empty((EX_PREDICT_IMAGES, bh, bw, 3), np.float32)
    batch[:] = get_mean_pixel()
    batch[:, :h, :w] = pixels
    want = default_image_predict(model, torch.tensor(normalize_input(batch), device=env.device),
                                 config, env.compute_dtype)[:, :h, :w].cpu().numpy()
    equal = got.shape == want.shape and bool((got.astype(np.int64) == want).all())
    log(f"-- 5c.5: predict_with_dir over {len(written)} PNGs of {h}x{w} (bucket {bh}x{bw}, one "
        f"batch, {seconds:.2f} s): label PNGs {got.shape} {got.dtype}, equal to "
        f"default_image_predict's argmax on the card: {equal}")
    if len(written) != EX_PREDICT_IMAGES or not equal:
        raise AssertionError("predict_with_dir's PNGs differ from default_image_predict's argmax")


def phase_examples(env, profile: bool) -> dict[str, dict]:
    """Phase 5c: BASELINE config #1 and the example scripts."""
    log("== phase 5c: MobileNetV2 + SimpleDecoder and the example scripts (train_seg, "
        "config #2 with OHEM, evaluate with buckets and the CPU cache, predict, verify_drive)")
    t_phase = time.perf_counter()
    paths = {}
    paths["mbv2_train"], mbv2_ms = phase_mbv2_train(env, profile)
    torch.cuda.empty_cache()
    log(f"(5c.1 done at {time.perf_counter() - t_phase:.1f} s)")
    # the examples and evaluate meet many input shapes: cuDNN's heuristics,
    # not an autotuning run per new shape (restored after the phase)
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory(prefix="iseg_examples_") as tmp:
            paths["mbv2_train_seg"], ckpt = phase_train_seg(env, tmp, mbv2_ms)
            torch.cuda.empty_cache()
            log(f"(5c.2 done at {time.perf_counter() - t_phase:.1f} s)")
            paths["ohem_train_seg"] = phase_ohem(env, tmp)
            torch.cuda.empty_cache()
            log(f"(5c.3 done at {time.perf_counter() - t_phase:.1f} s)")
            phase_eval_buckets(env, ckpt)
            torch.cuda.empty_cache()
            log(f"(5c.4-5 done at {time.perf_counter() - t_phase:.1f} s)")
        log("-- 5c.6: verify_drive.main(['--device', 'cuda'])")
        reset_launch_counts()
        out = verify_drive_example.main(["--device", "cuda"])
    finally:
        torch.backends.cudnn.benchmark = benchmark
    expect_launches("verify_drive", read_launch_counts(), {})
    log(f"verify_drive: mIoU {out['miou']:.4f} (> 0.7), restored step {out['step']}")
    if not (out["miou"] > 0.7 and out["step"] == 100):
        raise AssertionError("verify_drive did not reach mIoU > 0.7 and restore step 100")
    log(f"phase 5c took {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return paths


# --------------------------------------------------------------- Swin path

def build_swin_model(env, fused: bool, backbone: str = "swin_large") -> SegManaged:
    backbone = get_backbone(backbone)
    model = SegManaged(num_class=S_CLASSES, backbone=backbone,
                       head=SemanticFPN(backbone.endpoint_channels[-4:], filters=256),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def swin_train_setup(env, backbone: str = "swin_large"):
    """(model, train state, step function) of the Swin path (``backbone``:
    ``swin_large``, or ``swin_large_384`` for phase 6c)."""
    model = build_swin_model(env, fused=True, backbone=backbone)
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    return model, state, make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)


def phase_swin_train(env, data, profile: bool):
    log("== phase 6: Swin-L + SemanticFPN train (window attention + fused loss kernels)")
    model, state, step_fn = swin_train_setup(env)
    state, _, launches, step_ms = train_steps(state, step_fn, data, S_WARMUP, S_TIMED, S_BATCH)
    steps = S_WARMUP + S_TIMED
    expect_launches("Swin train", launches,
                    {"upsample_ce_fwd": steps, "upsample_ce_bwd": steps,
                     "window_attention_fwd_mma": WA_LAUNCHES_PER_FORWARD * steps,
                     "window_attention_bwd_mma": WA_LAUNCHES_PER_FORWARD * steps})
    if profile:
        profile_steps(state, step_fn, data, "Swin-L + SemanticFPN train step", step_ms)
    return model, launches


def drop_path_generator(model) -> torch.Generator:
    """The one generator every DropPath and Dropout of ``model`` draws from."""
    gens = {id(m.generator): m.generator for m in model.modules()
            if isinstance(m, (Dropout, DropPath)) and m.rate > 0}
    if len(gens) != 1:
        raise RuntimeError(f"expected one drop-path generator, found {len(gens)}")
    return next(iter(gens.values()))


def phase_swin_train_f32(data, profile: bool, backbone: str = "swin_large"):
    """Phase 6b (``swin_large``, window 7) or 6c (``swin_large_384``, window
    12): the fp32 step on the split-TF32 window-attention kernels."""
    phase = "6b" if backbone == "swin_large" else "6c"
    log(f"== phase {phase}: {backbone} + SemanticFPN train in fp32 (split-TF32 window attention "
        "+ fused loss kernels)")
    env = common_env_setup(EnvConfig(random_seed=0, mixed_precision=False, device="cuda"))
    log(f"env: {env.describe()}")
    if (env.compute_dtype != torch.float32 or torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError(f"phase {phase} needs fp32 compute with TF32 off")
    model, state, step_fn = swin_train_setup(env, backbone)
    if any(t.dtype != torch.float32 for t in model.state_dict().values() if t.is_floating_point()):
        raise AssertionError("the fp32 Swin model holds parameters that are not float32")
    # the first step's forward on the plain window attention and on the kernels:
    # the same weights and drop-path draws (in train mode, no update), then both
    # restored for the timed steps, whose first loss is held to the plain one
    init_weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = drop_path_generator(model)
    init_draw = gen.get_state()
    loss_fn = model.build_loss_fn()
    model.train()

    def first_forward():
        gen.set_state(init_draw)
        with torch.no_grad():
            logits = model(data["image"])
            return logits, float(loss_fn(logits, data["label"])[1]["loss"])

    swin_module.window_attention = wa.window_attention_reference
    try:
        reset_launch_counts()
        plain_logits, plain_loss = first_forward()
        plain_launches = read_launch_counts()
    finally:
        swin_module.window_attention = wa.window_attention
    if any(v for k, v in plain_launches.items() if k.startswith("window_attention")):
        raise AssertionError("the plain-version run launched a window-attention kernel")
    logits, _ = first_forward()
    err = float((logits - plain_logits).abs().max())
    scale = float(plain_logits.abs().max())
    log(f"first forward, kernels vs plain window attention: max abs logit diff {err:.3e} vs "
        f"max |logit| {scale:.3e} (tol {F32_KERNEL_VS_PLAIN_RTOL:g} of it)")
    if not err <= F32_KERNEL_VS_PLAIN_RTOL * scale:
        raise AssertionError("fp32 logits with the split-TF32 kernels disagree with the plain "
                             "version's")
    del logits, plain_logits
    model.load_state_dict(init_weights)
    gen.set_state(init_draw)
    del init_weights

    state, losses, launches, step_ms = counted_train_steps(
        state, step_fn, data, S_WARMUP, S_F32_TIMED, S_BATCH,
        {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1,
         "window_attention_fwd_tf32x3": WA_LAUNCHES_PER_FORWARD,
         "window_attention_bwd_tf32x3": WA_LAUNCHES_PER_FORWARD}, f"{backbone} fp32 train")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"first-step loss: kernels {losses[0]:.7f} plain window attention {plain_loss:.7f} "
        f"rel diff {rel:.3e} (tol {F32_KERNEL_VS_PLAIN_RTOL:g})")
    if not rel <= F32_KERNEL_VS_PLAIN_RTOL:
        raise AssertionError("the fp32 first-step loss with the split-TF32 kernels disagrees "
                             "with the plain version's")
    if profile:
        profile_steps(state, step_fn, data, f"{backbone} + SemanticFPN fp32 train step", step_ms)
    return launches


def build_swin16_model(env) -> SegManaged:
    """Swin-L's widths at window 16 (no registered variant has it) +
    SemanticFPN(256), the Swin path's head and fused loss."""
    backbone = swin_module.SwinTransformer(embed_dim=192, depths=(2, 2, 18, 2),
                                           num_heads=(6, 12, 24, 48), window_size=S16_WINDOW)
    model = SegManaged(num_class=S_CLASSES, backbone=backbone,
                       head=SemanticFPN(backbone.endpoint_channels[-4:], filters=256),
                       upsample_logits=False, fuse_upsample_loss=True)
    return model.to(env.device, memory_format=torch.channels_last)


def check_swin16_logits(env, model, images) -> dict:
    """Phase 7's check of the kernels' logits: one single-scale forward in
    bf16 on the kernels against the same weights in fp32 on the plain window
    attention (TF32 off); the bf16 forward on the plain version gives the
    noise; the kernel run must lie within max(SERVE_NOISE_MULT x noise,
    KERNEL_VS_PLAIN_MODEL_RTOL) of max |reference logit|."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the fp32 reference forward needs TF32 off")
    model.eval()

    def forward(fn, autocast):
        reset_launch_counts()
        swin_module.window_attention = fn
        try:
            with torch.no_grad(), torch.autocast("cuda", dtype=env.compute_dtype,
                                                 enabled=autocast):
                logits = model.inference(images)
            torch.cuda.synchronize()
        finally:
            swin_module.window_attention = wa.window_attention
        return logits.float(), read_launch_counts()

    ref, ref_launches = forward(wa.window_attention_reference, False)
    plain, plain_launches = forward(wa.window_attention_reference, True)
    kernels, launches = forward(wa.window_attention, True)
    model.train()
    if any(ref_launches.values()) or any(plain_launches.values()):
        raise AssertionError("a plain-version forward launched a kernel")
    expect_launches("Swin window-16 forward", launches,
                    {"window_attention_fwd_stream": WA_LAUNCHES_PER_FORWARD})
    if not bool(torch.isfinite(kernels).all()):
        raise AssertionError("window-16 logits with the kernels are not finite")
    scale = float(ref.abs().max())
    got = {"kernels": float((kernels - ref).abs().max()) / scale,
           "noise": float((plain - ref).abs().max()) / scale}
    bound = max(SERVE_NOISE_MULT * got["noise"], KERNEL_VS_PLAIN_MODEL_RTOL)
    log(f"window-16 single-scale logits against fp32 on the plain version (max |logit| "
        f"{scale:.4e}), max abs diff over it: bf16 kernels {got['kernels']:.3e}, bf16 plain "
        f"{got['noise']:.3e} (the noise); bound max({SERVE_NOISE_MULT:g} x noise, "
        f"{KERNEL_VS_PLAIN_MODEL_RTOL:g}) = {bound:.3e}")
    if not got["kernels"] <= bound:
        raise AssertionError(f"window-16 logits with the kernels lie {got['kernels']:.3e} of max "
                             f"|logit| from the fp32 forward, beyond {bound:.3e}")
    return got


def phase_swin16_train(env, data):
    """Phase 6d: Swin-L's widths at window 16 trained in bf16, every window
    attention on the streaming kernels."""
    log("== phase 6d: Swin-L widths at window 16 (N = 256, D = 32) + SemanticFPN train, bf16 "
        "(streaming window-attention kernels + fused loss kernels)")
    model = build_swin16_model(env)
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    check_swin16_logits(env, model, data["image"][:S_SERVE_BATCH])
    state, _, launches, step_ms = counted_train_steps(
        state, step_fn, data, S16_WARMUP, S16_TIMED, S_BATCH,
        {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1,
         "window_attention_fwd_stream": WA_LAUNCHES_PER_FORWARD,
         "window_attention_bwd_stream": WA_LAUNCHES_PER_FORWARD}, "Swin window-16 train")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_steps(state, step_fn, data, "Swin-L window-16 + SemanticFPN bf16 train step",
                         step_ms, steps=1)
    kernels = prof["kernels"].items()
    fwd_ms = sum(ms for key, ms in kernels if "wa_fwd_stream" in key)
    bwd_ms = sum(ms for key, ms in kernels if "wa_bwd_stream" in key or "dbias_reduce" in key)
    log(f"window 16: {step_ms:.2f} ms/step, peak {peak / 2**30:.2f} GiB; streaming kernels "
        f"(one profiled step) forward {fwd_ms:.3f} + backward {bwd_ms:.3f} ms of "
        f"{prof['device_ms']:.3f} ms device, share {(fwd_ms + bwd_ms) / prof['device_ms']:.4f}")
    return launches


KERNEL_CLASSES = (
    ("global-attention kernels", ("ga_fwd_kernel", "ga_bwd_delta_kernel", "ga_bwd_dkdv_kernel",
                                  "ga_bwd_dq_kernel", "ga_bwd_dbias_kernel")),
    ("window attention kernels", ("wa_fwd_kernel", "wa_fwd_mma_kernel", "wa_fwd_tf32x3_kernel",
                                  "wa_fwd_tf32x3_large_kernel", "wa_fwd_stream_kernel",
                                  "wa_bwd_kernel", "wa_bwd_mma_kernel", "wa_bwd_tf32x3_kernel",
                                  "wa_bwd_tf32x3_large_kernel", "wa_bwd_stream_kernel",
                                  "dbias_reduce_kernel")),
    ("dense-local kernels", ("dl_fwd_kernel", "dl_bwd_maps_kernel", "dl_bwd_x_kernel")),
    ("upsample + CE kernels", ("::fwd_kernel<", "::bwd_kernel<", "::reduce_kernel(")),
    ("global attention (SDPA: flash / memory-efficient)", ("flash", "fmha", "attention_kernel",
                                                            "efficient_attention")),
    ("convolutions (cuDNN)", ("cudnn", "fprop", "wgrad", "dgrad", "conv2d", "convolve",
                              "depthwise")),
    ("matrix products (cuBLAS GEMM: qkv, proj, MLP, merge)",
     ("nvjet", "gemm", "cutlass", "cublas", "xmma", "gemv", "s16816", "splitK")),
    ("layer norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("reductions (BN moments, sums)", ("reduce", "welford", "Welford")),
    ("optimizer update (foreach: SGD, Adam)", ("multi_tensor", "foreach")),
)


def profile_steps(state, step_fn, data, title: str, wall_ms: float, steps: int = 3) -> dict:
    """Self device time by kernel class over ``steps`` steady steps.
    ``wall_ms`` is the step's wall time measured without the profiler (the
    profiler's own start-up and bookkeeping slow the host several times
    over), so the busy share is device time per step over that. Returns the
    device ms per step in all and of each kernel by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step_fn(state, data)
        torch.cuda.synchronize()
    totals = {name: 0.0 for name, _ in KERNEL_CLASSES}
    totals["elementwise, copies, casts, pads, rolls, gathers"] = 0.0
    top = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if not us or evt.device_type.name != "CUDA":
            continue
        top.append((us, evt.key))
        for name, needles in KERNEL_CLASSES:
            if any(n in evt.key for n in needles):
                totals[name] += us
                break
        else:
            totals["elementwise, copies, casts, pads, rolls, gathers"] += us
    device_ms = sum(totals.values()) / 1e3 / steps
    if device_ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    log(f"-- profile of the {title} ({steps} steps; torch.profiler, self device time): "
        f"{device_ms:.3f} ms/step device against {wall_ms:.3f} ms/step wall without the "
        f"profiler, busy share {device_ms / wall_ms:.4f}")
    for name, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        log(f"   {us / 1e3 / steps:10.3f} ms/step  {100 * us / 1e3 / steps / device_ms:6.2f}%  {name}")
    log("   top kernels:")
    for us, key in sorted(top, reverse=True)[:30]:
        log(f"   {us / 1e3 / steps:10.3f} ms/step  {key[:110]}")
    return {"device_ms": device_ms, "kernels": {key: us / 1e3 / steps for us, key in top}}


def check_kernels_against_fp32(title, serve, logits, plain_fn, fault, model, fwd_kernel,
                               launches_per_forward) -> dict:
    """Fault F2's check. ``logits``: the bf16 single-scale serve on the
    kernels. The same weights served in fp32 on the plain versions (TF32
    off) are the reference; the bf16 serve on the plain versions measures
    the bf16 network's own distance from it (the noise); the kernel run must
    lie within max(SERVE_NOISE_MULT x noise, KERNEL_VS_PLAIN_MODEL_RTOL) of
    max |reference logit|, and the run with the planted fault beyond it.
    Printed beside them, for what spreads the distance from call to call: the
    trained weights' sums, the kernel run repeated, and the plain run on
    cuDNN's heuristics instead of its autotuned convolutions."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the fp32 reference serve needs TF32 off")
    ref, _, ref_launches, _ = serve(fn=plain_fn, autocast=False)
    plain, _, plain_launches, _ = serve(fn=plain_fn)
    if any(ref_launches.values()) or any(plain_launches.values()):
        raise AssertionError("a plain-version run launched a kernel")
    again, _, _, _ = serve()
    with cudnn_heuristics():
        plain_heuristic, _, _, _ = serve(fn=plain_fn)
    description, fault_fn = fault
    faulty, calls, fault_launches, _ = serve(fn=fault_fn)
    expect_launches(f"{title} serve with the planted fault", fault_launches,
                    {fwd_kernel: launches_per_forward * calls})
    scale = float(ref.abs().max())

    def dist(a, b):
        return float((a - b).abs().max()) / scale

    with torch.no_grad():
        weights = [p.detach().double() for p in model.parameters()]
        w_sum = float(sum(w.sum() for w in weights))
        w_sq = float(sum((w * w).sum() for w in weights))
    got = {"kernels": dist(logits, ref), "noise": dist(plain, ref), "fault": dist(faulty, ref),
           "kernels_vs_plain": dist(logits, plain), "repeat": dist(again, logits),
           "cudnn_heuristics": dist(plain_heuristic, plain)}
    bound = max(SERVE_NOISE_MULT * got["noise"], KERNEL_VS_PLAIN_MODEL_RTOL)
    log(f"{title} single-scale logits against the fp32 serve on the plain versions (max |logit| "
        f"{scale:.4e}), max abs diff over it: bf16 kernels {got['kernels']:.3e}, bf16 plain "
        f"versions {got['noise']:.3e} (the noise); bound max({SERVE_NOISE_MULT:g} x noise, "
        f"{KERNEL_VS_PLAIN_MODEL_RTOL:g}) = {bound:.3e}; planted fault ({description}) "
        f"{got['fault']:.3e}. Beside them: kernels vs bf16 plain {got['kernels_vs_plain']:.3e}, "
        f"the kernel run repeated {got['repeat']:.3e}, the bf16 plain run on cuDNN's heuristics "
        f"vs autotuned {got['cudnn_heuristics']:.3e}; trained weights sum {w_sum:.9e}, sum of "
        f"squares {w_sq:.9e}; bf16 max |logit| {float(logits.abs().max()):.4e}")
    if not got["kernels"] <= bound:
        raise AssertionError(f"{title} logits with the kernels lie {got['kernels']:.3e} of max "
                             f"|logit| from the fp32 serve, beyond {bound:.3e}")
    if not got["fault"] > bound:
        raise AssertionError(f"{title}: the planted fault ({description}) lies "
                             f"{got['fault']:.3e} from the fp32 serve, within the bound "
                             f"{bound:.3e}: the check cannot tell it apart")
    return got


def phase_serve(env, data, trained, title, build_model, batch, classes, fwd_kernel,
                launches_per_forward, plain_swap, fault):
    """Serve with the trained weights. ``fwd_kernel`` names the forward
    kernel every model call launches ``launches_per_forward`` times;
    ``plain_swap`` is ``(module, attribute, plain function)``: with the
    attribute replaced, the network runs on the kernel's plain version;
    ``fault`` is ``(description, function)``: the kernel with a planted fault
    in its inputs, swapped in the same way, whose run must fail the
    kernels-vs-fp32 check."""
    model = build_model(env, fused=False)
    model.load_state_dict(trained.state_dict())
    image, label = data["image"][:batch], data["label"][:batch]
    expect_shape = (batch, HW, HW, classes)
    forwards = [0]
    hook = model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    module, attribute, plain_fn = plain_swap
    kernel_fn = getattr(module, attribute)

    def serve(config=None, fn=None, autocast=True):
        forwards[0] = 0
        reset_launch_counts()
        setattr(module, attribute, fn or kernel_fn)
        try:
            t0 = time.perf_counter()
            with torch.autocast("cuda", dtype=env.compute_dtype, enabled=autocast):
                logits = model.inference(image, config)
            torch.cuda.synchronize()
        finally:
            setattr(module, attribute, kernel_fn)
        return logits, forwards[0], read_launch_counts(), 1e3 * (time.perf_counter() - t0)

    # single scale: against the training model's low-res logits, and against
    # the same weights served in fp32 on the kernels' plain versions
    logits, calls, launches, _ = serve()
    expect_launches(f"{title} serve (single scale)", launches,
                    {fwd_kernel: launches_per_forward * calls})
    with torch.autocast("cuda", dtype=env.compute_dtype):
        low = trained.inference(image)
    check_served_against_low_res(title, logits, low, expect_shape)
    check_kernels_against_fp32(title, serve, logits, plain_fn, fault, model, fwd_kernel,
                               launches_per_forward)

    total = {k: 0 for k in launches}
    results = {}
    for window_batch in (1, 2):
        config = SegModelInferenceConfig(scale_rates=(0.75, 1.0), flip=True,
                                         sliding_window_crop_size=(384, 384),
                                         sliding_window_batch=window_batch)
        logits, calls, launches, ms = serve(config)
        log(f"window batch {window_batch}: {calls} model calls, {ms:.1f} ms for "
            f"{batch} images (first call of these shapes: cuDNN autotuning included)")
        expect_launches(f"{title} serve (multi-scale, window batch {window_batch})", launches,
                        {fwd_kernel: launches_per_forward * calls})
        if calls == 0:
            raise AssertionError("the serve path made no model call")
        if tuple(logits.shape) != expect_shape or logits.dtype != torch.float32:
            raise AssertionError(f"served logits {tuple(logits.shape)} {logits.dtype}, "
                                 f"expected {expect_shape} float32")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("served logits are not finite")
        results[window_batch] = logits
        total = {k: total[k] + v for k, v in launches.items()}
    hook.remove()
    err = float((results[1] - results[2]).abs().max())
    scale = float(results[1].abs().max())
    log(f"sliding window, window batch 1 vs 2: max abs diff {err:.3e} vs max |logit| "
        f"{scale:.3e} (tol {SERVE_RTOL:g} of it)")
    if not err <= SERVE_RTOL * scale:
        raise AssertionError("window batch 1 and 2 disagree")

    metric = MeanIoU(classes)
    metric.update_state(label, results[1])
    counted, pixels = metric.total_cm.sum(), label.numel()
    log(f"confusion matrix counts {counted:.0f} of {pixels} pixels, mIoU {metric.result():.6f} "
        "(random labels: about 1/(2C-1))")
    if counted != pixels or not 0.0 <= metric.result() <= 1.0:
        raise AssertionError("the confusion matrix does not count every pixel once")
    return total


def phase_swin_serve(env, data, trained):
    log("== phase 7: Swin serve (multi-scale + flip + sliding window, trained weights)")
    def mask_dropped(q, k, v, bias, mask, scale):
        return wa.window_attention(q, k, v, bias, torch.zeros_like(mask[:1]), scale)

    return phase_serve(env, data, trained, "Swin", build_swin_model, S_SERVE_BATCH, S_CLASSES,
                       "window_attention_fwd_mma", WA_LAUNCHES_PER_FORWARD,
                       (swin_module, "window_attention", wa.window_attention_reference),
                       ("the kernels' forward with the shift mask dropped", mask_dropped))


# -------------------------------------------------------- InternImage path

def build_intern_model(env, fused: bool) -> SegManaged:
    backbone = get_backbone("intern_image_tiny", dcn_sampling="auto", remat=False)
    model = SegManaged(num_class=I_CLASSES, backbone=backbone,
                       head=ASPP(backbone.out_channels, filters=256),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def phase_intern_train(env, data, profile: bool):
    log("== phase 8: InternImage-T + ASPP train (dense-local + fused loss kernels, no remat)")
    model = build_intern_model(env, fused=True)
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, losses, launches, step_ms = train_steps(state, step_fn, data, I_WARMUP, I_TIMED,
                                                   I_BATCH)
    steps = I_WARMUP + I_TIMED
    expect_launches("InternImage train", launches,
                    {"upsample_ce_fwd": steps, "upsample_ce_bwd": steps,
                     "deform_local_fwd": DL_LAUNCHES_PER_FORWARD * steps,
                     "deform_local_bwd": DL_LAUNCHES_PER_FORWARD * steps})
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    log(f"mean loss of the first three steps {first:.5f}, of the last three {last:.5f}")
    if not last < first:
        raise AssertionError(f"the loss does not fall on the fixed batch: {losses}")
    if profile:
        profile_steps(state, step_fn, data, "InternImage-T + ASPP train step", step_ms)
    return model, launches


def phase_intern_serve(env, data, trained):
    log("== phase 9: InternImage serve (multi-scale + flip + sliding window, trained weights)")
    return phase_serve(env, data, trained, "InternImage", build_intern_model, I_SERVE_BATCH,
                       I_CLASSES, "deform_local_fwd", DL_LAUNCHES_PER_FORWARD,
                       (dcn_module, "dense_local_flat", dl.deform_dense_local_flat_reference),
                       offsets_swapped_fault())


def offsets_swapped_fault():
    """The planted fault of the dense-local serves (phases 9 and 14.4): the
    kernels fed the offsets with their two axes swapped."""
    kernel_fn = dcn_module.dense_local_flat

    def axes_swapped(x, off_dy, off_dx, modulation, *args):
        return kernel_fn(x, off_dx, off_dy, modulation, *args)

    return "the kernels' offsets with their two axes swapped", axes_swapped

# -------------------------------------------------------------- Gemma path

GEMMA_WORDS = ("▁the", "▁quick", "▁brown", "▁fox", "▁jumps", "▁over", "▁lazy", "▁dog",
               "▁a", "▁model", "▁writes", "▁text", "▁on", "▁one", "▁card", "▁beam", "▁search")
GEMMA_TEXTS = ("the quick brown fox jumps over the lazy dog", "a model writes text",
               "beam search on one card", "the dog", "a quick model writes the text on a card",
               "the lazy fox", "one beam", "text over text over text")


def build_gemma_tokenizer(vocab_size: int) -> GemmaTokenizer:
    """A SentencePiece unigram model built in memory, laid out like Gemma's:
    pad 0, eos 1, bos 2, unk 3, the 256 byte pieces, a few words, and unused
    pieces up to the model's vocabulary, so that every id the model can emit
    decodes. It goes through the wire format like a ``.model`` file."""
    pieces = [sp_model.SentencePiece("<pad>", 0.0, sp_model.CONTROL),
              sp_model.SentencePiece("<eos>", 0.0, sp_model.CONTROL),
              sp_model.SentencePiece("<bos>", 0.0, sp_model.CONTROL),
              sp_model.SentencePiece("<unk>", 0.0, sp_model.UNKNOWN)]
    pieces += sp_model.build_byte_pieces(-12.0)
    pieces += [sp_model.SentencePiece(w, -1.0 - 0.1 * i) for i, w in enumerate(GEMMA_WORDS)]
    pieces += [sp_model.SentencePiece(f"<unused{i}>", 0.0, sp_model.UNUSED)
               for i in range(vocab_size - len(pieces))]
    proto = sp_model.SPModelProto(pieces=pieces, model_type=1, unk_id=3, bos_id=2, eos_id=1,
                                  pad_id=0, byte_fallback=True)
    backend = sp_model.SentencePieceModel(sp_model.serialize_model_proto(proto))
    if backend.vocab_size() != vocab_size:
        raise AssertionError(f"vocabulary of {backend.vocab_size()} pieces, wanted {vocab_size}")
    return GemmaTokenizer(backend=backend)


def gemma_request(lm, name, prompt, lengths, sampler, want_launches, timed=True, trace=None,
                  **kw):
    """One ``generate`` call with the launch counts set to 0 just before and
    read just after; checks shape, dtype, id range, the prompt and the
    launches. ``trace``: a list that :func:`trace_beam_select` fills during
    the call. Returns (tokens, launch counts, seconds, peak bytes)."""
    if trace is not None:
        trace_beam_select(lm, trace)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        tokens = lm.generate(prompt, lengths, max_length=kw.pop("max_length", G_MAX_LENGTH),
                             sampler=sampler, segment_len=G_SEGMENT, **kw)
    finally:
        if trace is not None:
            del lm._beam_select
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    b, max_length = tokens.shape
    steps = max_length - int(lengths.min())
    if tokens.dtype != torch.int32 or b != prompt.shape[0] or tokens.device.type != "cuda":
        raise AssertionError(f"{name}: tokens {tuple(tokens.shape)} {tokens.dtype} "
                             f"on {tokens.device}")
    if int(tokens.min()) < 0 or int(tokens.max()) >= lm.config.vocab_size:
        raise AssertionError(f"{name}: token ids outside [0, {lm.config.vocab_size})")
    keep = torch.arange(prompt.shape[1], device=tokens.device)[None] < lengths[:, None]
    if not torch.equal(tokens[:, :prompt.shape[1]][keep].long(), prompt[keep]):
        raise AssertionError(f"{name}: the prompt was not preserved")
    expect_launches(f"Gemma {name}", launches, {"cache_gather": want_launches})
    if timed:
        log(f"{name}{' (traced: the re-ranking runs twice)' if trace is not None else ''}: "
            f"{dt:.3f} s for {b} x {steps} tokens (prefill included), "
            f"{b * steps / dt:.1f} tok/s, {1e3 * dt / steps:.3f} ms/step, peak memory "
            f"{peak / 2**30:.2f} GiB ({peak} bytes); distinct generated ids "
            f"{int(tokens[:, prompt.shape[1]:].unique().numel())}")
    return tokens, launches, dt, peak


def first_difference(a, b, start) -> dict[int, int]:
    """Row -> first position at which two ``[B, T]`` token tensors differ
    (rows that are equal throughout are left out)."""
    differ = (a != b).cpu()
    first = {int(row): int(differ[row].float().argmax())
             for row in differ.any(dim=1).nonzero()[:, 0]}
    if any(step < start for step in first.values()):
        raise AssertionError(f"rows differ inside the prompt: {first}")
    return first


def check_cache_layouts(lm, name, prompt, tokens, nb: int, other=None) -> float:
    """The context-segment decode (shared prompt segment + active cache, the
    segmented beam search's forward) against the monolithic-cache decode at
    ``B * nb`` rows, both fed ``tokens [B, T]`` over every generated position
    after one shared prefill; the active cache is G_SEGMENT wide and grows by
    G_SEGMENT when it is full, as in the search. Holds the logits to GEMMA_LAYOUT_RTOL at
    every step. ``other [B, T]``: tokens of another program that should have
    picked the same ones (greedy for beam 1): where a row of it first
    differs, the two tokens must be a near-tie in the logits that predicted
    that position (GEMMA_TIE_RTOL). Returns the largest |logit| seen."""
    b, p = prompt.shape
    t_end = tokens.shape[1]
    device = prompt.device
    first = first_difference(tokens, other, p) if other is not None else {}
    ties = {}
    with torch.inference_mode():
        mono = lm.build_cache(b, t_end)
        lengths = torch.full((b,), p, dtype=torch.long, device=device)
        pred, _ = lm._prefill(prompt, lengths, mono)  # predicts position p
        pred = pred.repeat_interleave(nb, dim=0)
        context = ((mono[:, :, :, :p].clone(), 0),)
        mono = mono.repeat_interleave(nb, dim=0)
        active = lm.build_cache(b * nb, G_SEGMENT)
        worst = torch.zeros((), device=device)
        worst_step = torch.zeros((), dtype=torch.long, device=device)
        top = pred.abs().max()
        for i in range(p, t_end):
            for row, at in first.items():
                if at == i:  # both programs saw the same history up to here
                    ours, theirs = int(tokens[row, i]), int(other[row, i])
                    ties[row] = (i, float((pred[row * nb, ours] - pred[row * nb, theirs]).abs()),
                                 float(pred[row * nb].abs().max()))
            if i - p == active.shape[3]:  # the segment is full: grow it
                active = torch.cat([active, lm.build_cache(b * nb, G_SEGMENT)], dim=3)
            tok = tokens[:, i].long().repeat_interleave(nb)[:, None]
            pos = torch.full((b * nb, 1), i, dtype=torch.long, device=device)
            pred, _ = lm.call_with_cache(tok, mono, i, pos)
            got, _ = lm.call_with_cache(tok, active, i, pos, context=context, cache_offset=p)
            pred = pred[:, 0]
            step_top = pred.abs().max()
            err = (got[:, 0] - pred).abs().max() / step_top
            worst_step = torch.where(err > worst, i, worst_step)
            worst = torch.maximum(worst, err)
            top = torch.maximum(top, step_top)
    worst, top = float(worst), float(top)
    log(f"{name}: context-segment vs monolithic decode at {b} x {nb} rows over all "
        f"{t_end - p} steps (active cache {G_SEGMENT} then {active.shape[3]} wide): max |logit "
        f"diff| {worst:.3e} of max |logit| at position {int(worst_step)} (tol "
        f"{GEMMA_LAYOUT_RTOL:g}); largest |logit| {top:.4f}")
    if not worst <= GEMMA_LAYOUT_RTOL:
        raise AssertionError(f"{name}: the segmented and the monolithic cache give other logits")
    if other is not None:
        log(f"{name}: {b - len(first)} of {b} rows equal over all {t_end - p} generated tokens"
            + "".join(f"; row {row} parts at position {i}, logit gap {gap:.3e} = "
                      f"{gap / row_top:.3e} of max |logit|"
                      for row, (i, gap, row_top) in ties.items()))
        for row, (i, gap, row_top) in ties.items():
            if not gap <= GEMMA_TIE_RTOL * row_top:
                raise AssertionError(f"{name}: row {row} parts at position {i} where the two "
                                     f"tokens are {gap:.3e} apart: not a near-tie")
    return top


def trace_beam_select(lm, trace: list):
    """Record, for every beam step of the next request, the ``2 * nb`` best
    totals (score + log-prob) over the ``nb * V`` continuations and their flat
    indices, beside what the search itself selected; nothing leaves the
    card. Valid for requests with no end token and full-length prompts."""
    select = lm._beam_select

    def traced(next_logits, tokens, scores, *args, **kw):
        b, nb = scores.shape
        total = scores[..., None] + torch.log_softmax(next_logits.float(), dim=-1).view(b, nb, -1)
        vals, idx = torch.topk(total.view(b, -1), 2 * nb, dim=-1)
        out = select(next_logits, tokens, scores, *args, **kw)
        trace.append((vals, idx, out[3] * total.shape[-1] + out[4]))
        return out

    lm._beam_select = traced


def check_search_divergence(name, trace_a, trace_b, tokens_a, tokens_b, start, top) -> None:
    """Two beam searches of one request on logits that differ by bf16
    rounding (see GEMMA_LAYOUT_RTOL), from their traces. Up to the first step
    at which a row's selections differ, both hold the same beams; at that
    step every continuation that one took and the other did not must be a
    near-tie, in the first one's own ranking, with the one taken in its place
    (GEMMA_TIE_RTOL of ``top``, the largest |logit|, in nats). Rows that never
    part must return equal tokens."""
    vals_a, idx_a, sel_a = (torch.stack(x).cpu() for x in zip(*trace_a))  # [S, B, 2nb | nb]
    vals_b, idx_b, sel_b = (torch.stack(x).cpu() for x in zip(*trace_b))
    nb = sel_a.shape[-1]
    for idx, sel in ((idx_a, sel_a), (idx_b, sel_b)):
        if not torch.equal(idx[..., :nb].sort(dim=-1).values, sel.sort(dim=-1).values):
            raise AssertionError(f"{name}: the trace does not hold what the search selected")
    tol = GEMMA_TIE_RTOL * top
    same = (sel_a == sel_b).all(dim=-1)  # [S, B]
    final = first_difference(tokens_a, tokens_b, start)
    parted, worst = {}, 0.0
    for row in range(same.shape[1]):
        steps = (~same[:, row]).nonzero()[:, 0]
        if not len(steps):
            if row in final:
                raise AssertionError(f"{name}: row {row} selected the same continuations at "
                                     "every step and returned other tokens")
            continue
        s = int(steps[0])
        drift = float((vals_a[:s + 1, row, :nb] - vals_b[:s + 1, row, :nb]).abs().max())
        gaps = []
        for vals, mine, theirs in ((vals_a, idx_a, sel_b), (vals_b, idx_b, sel_a)):
            for j in range(nb):
                if mine[s, row, j] == theirs[s, row, j]:
                    continue
                at = (mine[s, row] == theirs[s, row, j]).nonzero()[:, 0]
                if not len(at):
                    raise AssertionError(
                        f"{name}: row {row}, position {start + s}: a continuation one search "
                        f"took is not among the other's {mine.shape[-1]} best: not a near-tie")
                gaps.append(float((vals[s, row, at[0]] - vals[s, row, j]).abs()))
        parted[row] = (start + s, max(gaps), drift, final.get(row))
        worst = max(worst, max(gaps))
    log(f"{name}: {same.shape[1] - len(parted)} of {same.shape[1]} rows select the same "
        f"continuations at all {same.shape[0]} steps and return equal tokens; near-tie "
        f"tolerance {tol:.3e} nats ({GEMMA_TIE_RTOL:g} of max |logit| {top:.4f})")
    for row, (pos, gap, drift, final_pos) in parted.items():
        log(f"  row {row}: selections part at position {pos}, the continuations swapped lie "
            f"{gap:.3e} nats apart (scores had drifted {drift:.3e} apart by then); returned "
            + ("tokens are equal all the same" if final_pos is None
               else f"tokens first differ at position {final_pos}"))
    if not worst <= tol:
        raise AssertionError(f"{name}: searches parted where the continuations were "
                             f"{worst:.3e} nats apart, tolerance {tol:.3e}")


def profile_gemma_decode(lm, prompt, lengths, step_ms: float, steps: int = 24) -> None:
    """Self device time of the first ``steps`` beam-4 decode steps of a
    request whose first segment is full (active cache G_SEGMENT wide), by
    the op that launched each kernel. The profiler starts after the prefill
    and stops after the ``steps``-th single-token forward; the rest of the
    segment runs on unprofiled. ``step_ms`` is the timed request's wall time
    per step without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True)
    prefill, decode = lm._prefill, lm._decode
    decoded = 0

    def prefill_then_start(*args):
        result = prefill(*args)
        torch.cuda.synchronize()
        prof.start()
        return result

    def decode_then_stop(*args, **kw):
        nonlocal decoded
        result = decode(*args, **kw)
        decoded += 1
        if decoded == steps:
            torch.cuda.synchronize()
            prof.stop()
        return result

    lm._prefill, lm._decode = prefill_then_start, decode_then_stop
    try:
        lm.generate(prompt, lengths, max_length=G_PROMPT + G_SEGMENT, sampler=BeamSampler(4),
                    segment_len=G_SEGMENT)
        torch.cuda.synchronize()
    finally:
        del lm._prefill, lm._decode
    if decoded < steps:
        raise AssertionError(f"the profiled request took {decoded} decode steps, wanted {steps}")
    vocab = lm.config.vocab_size
    classes = {"cache gather kernel": 0.0, "readout (fp32 product with the [V, D] table)": 0.0,
               "weight products (bf16 F.linear: q, k, v, out, FFN)": 0.0,
               "attention products (torch.bmm, fp32 out) and softmax": 0.0,
               "beam re-ranking (log_softmax, top-k, gathers over [B, nb, V])": 0.0,
               "RMSNorm, RoPE, GELU, residuals, casts, cache writes": 0.0}
    device_us, kernel_launches, top = 0.0, 0, []
    for evt in prof.key_averages(group_by_input_shape=True):
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if not us:
            continue
        if evt.device_type.name == "CUDA":  # a kernel: the total, and the gather by name
            device_us += us
            kernel_launches += evt.count
            top.append((us, evt.key))
            if "gather_kernel" in evt.key and "vectorized" not in evt.key \
                    and "index" not in evt.key.lower():
                classes["cache gather kernel"] += us
            continue
        shapes = str(evt.input_shapes)
        if evt.key in ("aten::mm", "aten::addmm", "aten::linear", "aten::matmul"):
            key = ("readout (fp32 product with the [V, D] table)" if str(vocab) in shapes
                   else "weight products (bf16 F.linear: q, k, v, out, FFN)")
        elif evt.key in ("aten::bmm", "aten::_softmax", "aten::softmax"):
            key = ("beam re-ranking (log_softmax, top-k, gathers over [B, nb, V])"
                   if str(vocab) in shapes
                   else "attention products (torch.bmm, fp32 out) and softmax")
        elif str(vocab) in shapes or evt.key in ("aten::topk", "aten::_log_softmax"):
            key = "beam re-ranking (log_softmax, top-k, gathers over [B, nb, V])"
        else:
            key = "RMSNorm, RoPE, GELU, residuals, casts, cache writes"
        classes[key] += us
    if device_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    device_ms = device_us / 1e3 / steps
    log(f"-- profile of {steps} Gemma-2B beam-4 decode steps (batch {G_BATCH}, active cache "
        f"{G_SEGMENT} wide; torch.profiler, self device time by launching op): "
        f"{device_ms:.3f} ms/step device against {step_ms:.3f} ms/step wall of the timed "
        f"request without the profiler, busy share {device_ms / step_ms:.4f}; "
        f"{kernel_launches / steps:.0f} kernels and copies a step")
    for name, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        log(f"   {us / 1e3 / steps:10.3f} ms/step  {100 * us / device_us:6.2f}%  {name}")
    log("   top kernels:")
    for us, key in sorted(top, reverse=True)[:25]:
        log(f"   {us / 1e3 / steps:10.3f} ms/step  {key[:110]}")


def phase_gemma_serve(device, profile: bool) -> dict[str, dict[str, int]]:
    log(f"== phase 10: Gemma serve ({G_PRESET} at full width, {G_LAYERS} of its 18 layers, "
        f"bf16, batch {G_BATCH}, prompt {G_PROMPT}, max_length {G_MAX_LENGTH}, "
        f"segment_len {G_SEGMENT})")
    published = get_preset(G_PRESET)
    cfg = dataclasses.replace(published, num_layers=G_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = GemmaCausalLM(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device=device)
    lm.init(torch.Generator(device=device).manual_seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"config: {cfg}")
    log(f"parameters: {n_params / 1e9:.3f} B in bf16, built on the card in "
        f"{time.perf_counter() - t0:.2f} s; memory held {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB (the fp32 copy of the embedding table for the readout, "
        f"{cfg.vocab_size * cfg.hidden_dim * 4 / 2**30:.2f} GiB, is made at the first readout)")
    if (published.num_layers, cfg.hidden_dim, cfg.vocab_size) != (18, 2048, 256000):
        raise AssertionError("the Gemma path must run at gemma_2b_en's published width")

    # (a) text in, text out, ragged prompts
    t0 = time.perf_counter()
    tokenizer = build_gemma_tokenizer(cfg.vocab_size)
    pre = GemmaCausalLMPreprocessor(tokenizer, sequence_length=G_TEXT_PROMPT)
    ids, lens = pre(list(GEMMA_TEXTS), for_generation=True)
    log(f"tokenizer of {cfg.vocab_size} pieces built in {time.perf_counter() - t0:.2f} s; "
        f"prompt lengths {lens.tolist()} in a buffer of {G_TEXT_PROMPT}")
    if len(set(lens.tolist())) < 2 or ids[0, 0] != tokenizer.bos_id:
        raise AssertionError("the text prompts should be ragged and start with <bos>")
    prompt_t = torch.tensor(ids, device=device, dtype=torch.long)
    lens_t = torch.tensor(lens, device=device, dtype=torch.long)
    tokens, _, _, _ = gemma_request(lm, "greedy, text prompts", prompt_t, lens_t, None, 0,
                                    timed=False, max_length=G_TEXT_MAX_LENGTH)
    texts = pre.generate_postprocess(tokens.cpu().numpy())
    for text, want in zip(texts, GEMMA_TEXTS):
        log(f"  {want!r} -> {text[:100]!r}")
        if not (isinstance(text, str) and text.startswith(want)):
            raise AssertionError(f"generated text does not start with its prompt {want!r}")
    beam_text, launches_text, _, _ = gemma_request(
        lm, "beam 2, text prompts", prompt_t, lens_t, BeamSampler(2),
        G_TEXT_MAX_LENGTH - int(lens.min()), timed=False, max_length=G_TEXT_MAX_LENGTH)
    for text, want in zip(pre.generate_postprocess(beam_text.cpu().numpy()), GEMMA_TEXTS):
        if not text.startswith(want):
            raise AssertionError(f"beam text does not start with its prompt {want!r}")

    # (b) the requests, one warm-up call each
    rng = np.random.RandomState(0)
    prompt = torch.tensor(rng.randint(4, cfg.vocab_size, (G_BATCH, G_PROMPT)), device=device)
    lengths = torch.full((G_BATCH,), G_PROMPT, dtype=torch.long, device=device)
    steps = G_MAX_LENGTH - G_PROMPT
    requests = (("greedy", None, 0), ("beam 2", BeamSampler(2), steps),
                ("beam 4", BeamSampler(4), steps),
                (f"contrastive k={G_CONTRASTIVE_K}", ContrastiveSampler(k=G_CONTRASTIVE_K), 0))
    results, paths, step_ms = {}, {}, {}
    seg_trace, mono_trace = [], []
    for name, sampler, want in requests:
        # the beam-4 warm-up is the traced run of the segmented search; the
        # contrastive one is 8 steps long (no check reads it: run time)
        short = isinstance(sampler, ContrastiveSampler)
        warm, _, _, _ = gemma_request(lm, f"{name} (warm-up)", prompt, lengths, sampler, want,
                                      timed=False, trace=seg_trace if name == "beam 4" else None,
                                      **({"max_length": G_PROMPT + 8} if short else {}))
        results[name], paths[name], dt, _ = gemma_request(lm, name, prompt, lengths, sampler, want)
        step_ms[name] = 1e3 * dt / steps
        if sampler is None or isinstance(sampler, BeamSampler):
            # greedy and beam search draw nothing: a second call gives the first one's tokens
            if not torch.equal(warm, results[name]):
                raise AssertionError(f"{name}: two calls of one request return other tokens")
        del warm
        torch.cuda.empty_cache()

    # (c) the same search on the kernel's plain version, and on the monolithic cache
    kernel_fn = gemma_causal_lm.beam_cache_gather

    def plain_gather(cache, parent, out=None):
        return out.copy_(cg.beam_cache_gather_reference(cache, parent))

    gemma_causal_lm.beam_cache_gather = plain_gather
    try:
        plain_tokens, _, _, _ = gemma_request(lm, "beam 4, plain gather swapped in", prompt,
                                              lengths, BeamSampler(4), 0)
    finally:
        gemma_causal_lm.beam_cache_gather = kernel_fn
    if not torch.equal(plain_tokens, results["beam 4"]):
        raise AssertionError("beam 4 with the kernel and with its plain version pick other tokens")
    log("beam 4: the kernel run and the plain-gather run pick the same tokens exactly")
    top = check_cache_layouts(lm, "beam 4 tokens", prompt, results["beam 4"], 4)
    mono, _, _, _ = gemma_request(lm, "beam 4, monolithic cache", prompt, lengths, BeamSampler(4),
                                  0, cache_policy="monolithic", trace=mono_trace)
    check_search_divergence("beam 4 segmented vs monolithic", seg_trace, mono_trace,
                            results["beam 4"], mono, G_PROMPT, top)
    del mono, plain_tokens, seg_trace, mono_trace
    torch.cuda.empty_cache()

    # (d) beam 1 is greedy
    beam1, launches1, _, _ = gemma_request(lm, "beam 1", prompt, lengths, BeamSampler(1), steps)
    check_cache_layouts(lm, "beam 1 vs greedy", prompt, beam1, 1, other=results["greedy"])

    if profile:
        profile_gemma_decode(lm, prompt, lengths, step_ms["beam 4"])

    beam = {k: paths["beam 2"][k] + paths["beam 4"][k] + launches1[k] + launches_text[k]
            for k in launches1}
    other = {k: paths["greedy"][k] + paths[f"contrastive k={G_CONTRASTIVE_K}"][k]
             for k in launches1}
    return {"gemma_beam_serve": beam, "gemma_greedy_contrastive_serve": other}


# ------------------------------------------------------------ HRNet path

def build_hrnet_model(env, fused: bool, aux: bool = False) -> SegManaged:
    """BASELINE config #3: HRNet-W48 + JPU(512), sized by ``train_seg``'s
    ``build_head`` (the JPU reads the os8, os16 and os32 branches); with
    ``aux`` one aux logits conv on the os32 branch (rate 0.4)."""
    backbone = get_backbone("hrnet_w48")
    model = SegManaged(num_class=H_CLASSES, backbone=backbone,
                       head=train_seg_example.build_head("jpu", backbone),
                       upsample_logits=not fused, fuse_upsample_loss=fused,
                       num_aux_loss=1 if aux else 0, use_aux_head_endpoints=aux,
                       aux_loss_rate=H_AUX_RATE)
    return model.to(env.device, memory_format=torch.channels_last)


def phase_hrnet_train(env, profile: bool):
    """Phase 11.1: the config #3 training geometry on a fixed batch (the JAX
    package's ``tools/bench_model_mfu.py`` ``hrnet``), fused, then one
    unfused step from the same weights. Returns the launch counts, the
    fused ms/step and the trained weights."""
    log(f"-- 11.1: HRNet-W48 + JPU(512), {H_CLASSES} classes, {HW}x{HW}, batch {H_BATCH}, bf16 "
        "autocast, SGD poly, fused loss at os8")
    data = synthetic_batch(env.device, H_BATCH, H_CLASSES)
    model = build_hrnet_model(env, fused=True)
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    init_weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, losses, launches, step_ms = train_steps(state, step_fn, data, H_WARMUP, H_TIMED,
                                                   H_BATCH)
    steps = H_WARMUP + H_TIMED
    expect_launches("HRNet train", launches, {"upsample_ce_fwd": steps, "upsample_ce_bwd": steps})
    log(f"HRNet train: {step_ms:.2f} ms/step, {H_BATCH * 1e3 / step_ms:.2f} img/s ({card_line()})")
    if profile:
        profile_steps(state, step_fn, data, "HRNet-W48 + JPU train step", step_ms)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del state, step_fn, model
    torch.cuda.empty_cache()

    unfused = build_hrnet_model(env, fused=False)
    unfused.load_state_dict(init_weights)
    u_state = create_train_state(unfused, None, tx, initialized=True)
    reset_launch_counts()
    _, parts = make_train_step(unfused.build_loss_fn(), compute_dtype=env.compute_dtype)(
        u_state, data)
    loss = float(parts["loss"])
    rel = abs(loss - losses[0]) / abs(losses[0])
    log(f"HRNet first-step loss: fused {losses[0]:.6f} unfused {loss:.6f} rel diff {rel:.3e} "
        f"(tol {FUSED_UNFUSED_RTOL:g})")
    if any(read_launch_counts().values()):
        raise AssertionError("the unfused HRNet step launched the fused kernels")
    if not rel <= FUSED_UNFUSED_RTOL:
        raise AssertionError("HRNet fused and unfused first-step losses disagree")
    return launches, step_ms, trained


class MicroStepProbe:
    """A ``CoreTrain`` callback, one epoch a micro-step: after each it reads
    the loss-kernel launches of that micro-step and whether the params and
    the EMA moved (and by the EMA rule), then sets the counts to 0."""

    def __init__(self, trainer, schedule):
        self.trainer, self.schedule = trainer, schedule
        self.records = []
        self._snapshot()

    def _snapshot(self):
        s = self.trainer.state
        self.params = [p.detach().clone() for p in s.params.values()]
        self.ema = [e.detach().clone() for e in s.ema_params.values()]

    def on_epoch_begin(self, epoch, state):
        reset_launch_counts()

    def on_epoch_end(self, epoch, state, logs=None):
        launches = read_launch_counts()
        params = list(state.params.values())
        ema = list(state.ema_params.values())
        moved = any(not torch.equal(a, b) for a, b in zip(self.params, params))
        ema_moved = any(not torch.equal(a, b) for a, b in zip(self.ema, ema))
        d = state.ema_decay
        ema_rule = all(torch.equal(e, old * d + (1.0 - d) * p)
                       for e, old, p in zip(ema, self.ema, params))
        update = state.step // H_ACCUM_EVERY - 1  # the real update this micro-step made
        self.records.append(dict(step=state.step, loss=logs["loss"], launches=launches,
                                 moved=moved, ema_moved=ema_moved, ema_rule=ema_rule,
                                 lr=self.schedule(update) if state.step % H_ACCUM_EVERY == 0
                                 else None))
        self._snapshot()

    def on_train_end(self, state):
        pass


def hrnet_accum_trainer(env, ckpt=None):
    """``CoreTrain`` of config #3 with the aux head, AdamW + cosine decay
    (warmup 2) accumulated over 2 micro-steps and an EMA, initialized from
    seed 0 (every trainer starts from the same weights)."""
    model = build_hrnet_model(env, fused=True, aux=True)
    inner, schedule = get_optimizer(param_tree(model), "adamw", learning_rate=1e-4,
                                    train_steps=H_ACCUM_STEPS // H_ACCUM_EVERY,
                                    decay_strategy="cosine", warmup_steps=2, weight_decay=1e-4)
    trainer = CoreTrain(env, model, with_grad_accum(inner, H_ACCUM_EVERY), seed=0,
                        checkpoint_manager=(TimedModelHelper(ckpt, max_to_keep=1)
                                            if ckpt else None),
                        log_every=0, lr_schedule=schedule, ema_decay=0.999,
                        grad_accum_every=H_ACCUM_EVERY)
    return trainer, schedule


def accum_batches():
    rng = np.random.RandomState(11)
    out = []
    for _ in range(H_ACCUM_STEPS):
        label = rng.randint(0, H_CLASSES, (H_ACCUM_BATCH, HW, HW))
        label = np.where(rng.rand(H_ACCUM_BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
        out.append({"image": rng.rand(H_ACCUM_BATCH, HW, HW, 3).astype(np.float32),
                    "label": label})
    return out


def trainer_tensors(trainer) -> dict[str, torch.Tensor]:
    s, o = trainer.state, trainer.state.opt_state
    inner = o.inner_opt_state
    return {**{f"params/{k}": v for k, v in s.params.items()},
            **{f"ema/{k}": v for k, v in s.ema_params.items()},
            **{f"batch_stats/{k}": v for k, v in s.batch_stats.items()},
            **{f"acc/{i}": v for i, v in enumerate(o.acc_grads)},
            **{f"mu/{i}": v for i, v in enumerate(inner.mu)},
            **{f"nu/{i}": v for i, v in enumerate(inner.nu)}}


def phase_hrnet_accum(env, tmp: str) -> dict[str, int]:
    """Phase 11.2: the item-19 path through ``CoreTrain``: aux head, AdamW,
    cosine decay, gradient accumulation and an EMA; a checkpoint in the
    middle of an accumulation resumed exactly. The runs take cuDNN's
    deterministic algorithms (by its heuristics: no autotuning of the
    micro-batch's shapes), and PyTorch warns in the log of any op that has
    no deterministic implementation; Adam turns a gradient's last-bit noise
    near 0 into a whole LR-sized step, so only a repeatable step resumes
    exactly. Returns the launch counts of the uninterrupted run."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return hrnet_accum_runs(env, tmp)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def hrnet_accum_runs(env, tmp: str) -> dict[str, int]:
    log(f"-- 11.2: the same model with an aux head on the os32 branch (rate {H_AUX_RATE}), "
        f"AdamW (lr 1e-4, wd 1e-4) with cosine decay (warmup 2) accumulated every "
        f"{H_ACCUM_EVERY} micro-steps, EMA 0.999, batch {H_ACCUM_BATCH} a micro-step, "
        f"{H_ACCUM_STEPS} micro-steps through CoreTrain")
    batches = accum_batches()
    full, schedule = hrnet_accum_trainer(env)
    probe = MicroStepProbe(full, schedule)
    full.callbacks.append(probe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # one epoch a micro-step, so the probe sees each
    full.train(lambda epoch: iter([batches[epoch]]), epochs=H_ACCUM_STEPS, steps_per_epoch=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: sum(r["launches"][k] for r in probe.records) for k in read_launch_counts()}
    for r in probe.records:
        log(f"micro-step {r['step']}: loss {r['loss']:.5f}, launches fwd "
            f"{r['launches']['upsample_ce_fwd']} bwd {r['launches']['upsample_ce_bwd']}, params "
            f"{'moved' if r['moved'] else 'kept'}, EMA {'moved' if r['ema_moved'] else 'kept'}"
            f"{' by its rule' if r['ema_rule'] else ''}"
            + (f", real update at lr {r['lr']:.3e}" if r["lr"] is not None else ""))
    log(f"11.2 run: {1e3 * dt / H_ACCUM_STEPS:.2f} ms a micro-step over all {H_ACCUM_STEPS} "
        f"(the first ones' cuDNN autotuning included; host clock), peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes) ({card_line()})")
    o = full.state.opt_state
    if (full.state.step, o.mini_step, o.gradient_step, o.inner_opt_state.count) != (
            H_ACCUM_STEPS, 0, H_ACCUM_STEPS // H_ACCUM_EVERY, H_ACCUM_STEPS // H_ACCUM_EVERY):
        raise AssertionError("the accumulator did not make one real update every "
                             f"{H_ACCUM_EVERY} micro-steps")
    for r in probe.records:
        expect_launches(f"HRNet accumulation micro-step {r['step']}", r["launches"],
                        {"upsample_ce_fwd": 2, "upsample_ce_bwd": 2})
        if not np.isfinite(r["loss"]):
            raise AssertionError(f"non-finite loss at micro-step {r['step']}")
        real = r["lr"] is not None
        # a real update moves the params unless the schedule gives it LR 0
        # (optax's warmup starts at 0) and decays the EMA by its rule; an
        # accumulating micro-step moves neither
        if r["moved"] != (real and r["lr"] > 0) or (r["ema_moved"] and not real):
            raise AssertionError(f"micro-step {r['step']}: params/EMA moved "
                                 f"{r['moved']}/{r['ema_moved']} on a "
                                 f"{'real' if real else 'accumulating'} micro-step")
        if real and not r["ema_rule"]:
            raise AssertionError(f"micro-step {r['step']}: the EMA is not d * e + (1 - d) * p")
    want = full.state.step
    expected = trainer_tensors(full)  # the finished run's own tensors
    full_losses = [r["loss"] for r in probe.records]
    del full, probe
    torch.cuda.empty_cache()

    ckpt = os.path.join(tmp, "accum")

    def preempting(epoch):
        # two host batches in flight: batch H_ACCUM_SAVE_AT is drawn once
        # step H_ACCUM_SAVE_AT - 1 has run, and the loop stops after step
        # H_ACCUM_SAVE_AT, in the middle of an accumulation
        for i, batch in enumerate(batches):
            if i == H_ACCUM_SAVE_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    first, _ = hrnet_accum_trainer(env, ckpt)
    first.train(preempting, epochs=1, steps_per_epoch=H_ACCUM_STEPS)
    mini = first.state.opt_state.mini_step
    save_s = first.checkpoint_manager.save_seconds
    del first
    torch.cuda.empty_cache()
    resumed, _ = hrnet_accum_trainer(env, ckpt)
    t0 = time.perf_counter()
    at = resumed.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    reset_launch_counts()
    resumed.train(lambda epoch: iter(batches), epochs=1, steps_per_epoch=H_ACCUM_STEPS,
                  initial_epoch=-1)
    resumed_launches = read_launch_counts()
    got = trainer_tensors(resumed)
    unequal = [k for k in expected if not torch.equal(expected[k], got[k])]
    worst = max((float((expected[k].detach().float() - got[k].detach().float()).abs().max()
                       / max(float(expected[k].detach().float().abs().max()), 1e-30))
                 for k in unequal), default=0.0)
    log(f"checkpoint at micro-step {at} (accumulator mini-step {mini}; save "
        f"{[round(v, 3) for v in save_s]} s, restore {restore_s:.3f} s), resumed to "
        f"{resumed.state.step}: {len(expected) - len(unequal)} of {len(expected)} tensors "
        f"(params, EMA, BN statistics, accumulator, Adam moments) equal bit for bit"
        + (f"; the others within {worst:.3e} of their max (tol rtol {ACCUM_RESUME_RTOL:g}: "
           "cuDNN chose other algorithms)" if unequal else ""))
    steps_resumed = H_ACCUM_STEPS - H_ACCUM_SAVE_AT
    expect_launches("HRNet accumulation, resumed", resumed_launches,
                    {"upsample_ce_fwd": 2 * steps_resumed, "upsample_ce_bwd": 2 * steps_resumed})
    if at != H_ACCUM_SAVE_AT or mini != H_ACCUM_SAVE_AT % H_ACCUM_EVERY or resumed.state.step != want:
        raise AssertionError(f"checkpoint at {at} (mini-step {mini}), resumed to "
                             f"{resumed.state.step}")
    if worst > ACCUM_RESUME_RTOL:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {unequal[:5]}")
    log(f"uninterrupted losses {[round(v, 5) for v in full_losses]}")
    del resumed, got, expected
    torch.cuda.empty_cache()
    return launches


def phase_hrnet_train_seg(env, tmp: str) -> dict[str, int]:
    """Phase 11.3: ``train_seg.main`` with HRNet-W48 + JPU and AdamW."""
    args = ["--backbone", "hrnet_w48", "--head", "jpu", "--num_class", str(H_CLASSES),
            "--optimizer", "adamw", "--lr", "1e-4", "--fused_loss", "--crop", str(HW),
            "--batch", str(H_BATCH), "--epochs", "1", "--steps_per_epoch",
            str(H_TRAIN_SEG_STEPS), "--eval_scales", "1.0",
            "--ckpt_dir", os.path.join(tmp, "train_seg_hrnet")]
    log(f"-- 11.3: train_seg.main({' '.join(args)})")
    reset_launch_counts()
    out = train_seg_example.main(args)
    launches = read_launch_counts()
    expect_launches("HRNet train_seg", launches, {"upsample_ce_fwd": H_TRAIN_SEG_STEPS,
                                                  "upsample_ce_bwd": H_TRAIN_SEG_STEPS})
    loss = out["history"][0]["loss"]
    log(f"train_seg HRNet: step {out['step']}, last loss {loss:.5f}, mIoU {out['miou']:.4f}")
    if out["step"] != H_TRAIN_SEG_STEPS or not (np.isfinite(loss) and np.isfinite(out["miou"])):
        raise AssertionError("train_seg with HRNet + JPU and AdamW did not finish finite")
    return launches


def phase_hrnet_sliding(env, trained) -> None:
    """Phase 11.4: ``bench.py``'s ``sliding_hrnet`` geometry with 11.1's
    weights: one 1024x2048 image, 512x512 windows at stride 2/3, bf16."""
    log(f"-- 11.4: sliding-window serve, one {H_SLIDE_HW[0]}x{H_SLIDE_HW[1]} image, "
        f"{H_SLIDE_WINDOW}x{H_SLIDE_WINDOW} windows, stride 2/3, bf16 autocast, 11.1's weights")
    model = build_hrnet_model(env, fused=False)
    model.load_state_dict(trained)
    image = torch.tensor(np.random.RandomState(0).rand(1, *H_SLIDE_HW, 3).astype(np.float32),
                         device=env.device)
    calls = [0]
    hook = model.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))

    def serve(window_batch, bf16=True):
        config = SegModelInferenceConfig(sliding_window_crop_size=(H_SLIDE_WINDOW,) * 2,
                                         sliding_window_batch=window_batch)
        with torch.autocast("cuda", dtype=env.compute_dtype, enabled=bf16):
            out = model.inference(image, config)
        torch.cuda.synchronize()
        return out

    reset_launch_counts()
    calls[0] = 0
    logits = serve(1)  # warm-up: cuDNN autotuning of the window shape
    warm_calls = calls[0]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(H_SLIDE_REPS):
        t0 = time.perf_counter()
        logits = serve(1)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    expect_launches("HRNet sliding-window serve", read_launch_counts(), {})
    times.sort()
    p50 = times[len(times) // 2]
    log(f"sliding window: {warm_calls} model calls a request; p50 {p50:.4f} s, min "
        f"{times[0]:.4f}, max {times[-1]:.4f} over {H_SLIDE_REPS} calls after one warm-up "
        f"(host clock, ending in a synchronize); peak memory {peak / 2**30:.2f} GiB ({peak} "
        f"bytes) ({card_line()})")
    log(json.dumps({"metric": f"hrnet_w48_jpu_sliding_window_{H_SLIDE_HW[0]}x{H_SLIDE_HW[1]}"
                              "_eval", "value": round(p50, 4), "unit": "p50_seconds",
                    "reps": len(times), "min": round(times[0], 4), "max": round(times[-1], 4)}))
    expect_shape = (1, *H_SLIDE_HW, H_CLASSES)
    if tuple(logits.shape) != expect_shape or logits.dtype != torch.float32:
        raise AssertionError(f"sliding-window logits {tuple(logits.shape)} {logits.dtype}, "
                             f"expected {expect_shape} float32")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("sliding-window logits are not finite")
    if warm_calls != H_SLIDE_CALLS:
        raise AssertionError(f"{warm_calls} model calls, expected {H_SLIDE_CALLS}")
    batched = serve(2)
    f32 = {wb: serve(wb, bf16=False) for wb in (1, 2)}
    hook.remove()

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    batch_f32, batch_bf16 = rel(f32[2], f32[1]), rel(batched, logits)
    noise = max(rel(logits, f32[1]), rel(batched, f32[1]))
    log(f"window batch 1 vs 2, max abs diff over max |logit|: fp32 {batch_f32:.3e} (tol "
        f"{SLIDE_BATCH_RTOL:g}); bf16 {batch_bf16:.3e}, each bf16 run within {noise:.3e} of the "
        f"fp32 run (tol {SLIDE_BF16_RTOL:g})")
    if not batch_f32 <= SLIDE_BATCH_RTOL:
        raise AssertionError("window batch 1 and 2 disagree")
    if not noise <= SLIDE_BF16_RTOL:
        raise AssertionError("the bf16 sliding window strays from the fp32 one")


def phase_hrnet(env, profile: bool) -> dict[str, dict]:
    """Phase 11: BASELINE config #3 (HRNet-W48 + JPU)."""
    log("== phase 11: HRNet (BASELINE config #3): HRNet-W48 + JPU, the item-19 training path, "
        "train_seg, and the 1024x2048 sliding-window serve")
    t_phase = time.perf_counter()
    paths = {}
    paths["hrnet_train"], step_ms, trained = phase_hrnet_train(env, profile)
    torch.cuda.empty_cache()
    log(f"(11.1 done at {time.perf_counter() - t_phase:.1f} s)")
    with tempfile.TemporaryDirectory(prefix="iseg_hrnet_") as tmp:
        paths["hrnet_accum"] = phase_hrnet_accum(env, tmp)
        torch.cuda.empty_cache()
        log(f"(11.2 done at {time.perf_counter() - t_phase:.1f} s)")
        paths["hrnet_train_seg"] = phase_hrnet_train_seg(env, tmp)
        torch.cuda.empty_cache()
        log(f"(11.3 done at {time.perf_counter() - t_phase:.1f} s)")
    phase_hrnet_sliding(env, trained)
    torch.cuda.empty_cache()
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return paths


# ------------------------------------------- ViT-L and EVA02-L path (phase 12)

def build_vit_model(env, fused: bool) -> SegManaged:
    """BASELINE config #4's ViT-L: ``vit_large_patch16`` + ASPP(256) (built
    by ``train_seg``'s ``build_head``), 19 classes."""
    backbone = get_backbone("vit_large_patch16")
    model = SegManaged(num_class=V_CLASSES, backbone=backbone,
                       head=train_seg_example.build_head("aspp", backbone),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def build_eva_model(env, fused: bool) -> SegManaged:
    """BASELINE config #5: ``eva02_large_patch16_512_coco`` + ASPP(256), 150
    classes, ``fuse_upsample_loss`` as requested (above 64 classes the loss
    is the unfused resize + CE)."""
    backbone = get_backbone("eva02_large_patch16_512_coco")
    model = SegManaged(num_class=E_CLASSES, backbone=backbone,
                       head=train_seg_example.build_head("aspp", backbone),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def phase_vit_train(env) -> tuple[dict, dict]:
    """Phase 12.1: ViT-L + ASPP trained on a fixed batch; returns the launch
    counts and the trained weights."""
    log(f"-- 12.1: ViT-L/16 + ASPP(256), {V_CLASSES} classes, {HW}x{HW}, batch {V_BATCH}, bf16 "
        "autocast, SGD poly, fused loss at os16")
    data = synthetic_batch(env.device, V_BATCH, V_CLASSES)
    model = build_vit_model(env, fused=True)
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, _, launches, step_ms = counted_train_steps(
        state, step_fn, data, V_WARMUP, V_TIMED, V_BATCH,
        {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1, **T_GLOBAL_PER_STEP}, "ViT-L train")
    log(f"ViT-L train: {step_ms:.2f} ms/step, {V_BATCH * 1e3 / step_ms:.2f} img/s ({card_line()})")
    profile_steps(state, step_fn, data, "ViT-L/16 + ASPP train step", step_ms)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return launches, trained


def vit_f32_steps(device, warmup: int, timed: int,
                  want_per_step: dict | None = None) -> tuple[dict, dict]:
    """ViT-L + ASPP (config #4's model) in fp32 with TF32 off: ``warmup`` +
    ``timed`` steps on a fixed batch (each step's launches held to
    ``want_per_step`` where given), then 3 profiled; returns the launch
    counts over the steps and the numbers: ms/step, device ms, the global
    attention's device ms (the pair, or a tree's streaming pair or SDPA) and
    share, peak memory, busy share."""
    env32 = common_env_setup(EnvConfig(random_seed=0, mixed_precision=False, device="cuda"))
    if (env32.compute_dtype != torch.float32 or torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("the fp32 ViT-L step needs fp32 compute with TF32 off")
    data = synthetic_batch(device, V_BATCH, V_CLASSES)
    model = build_vit_model(env32, fused=True)
    if any(t.dtype != torch.float32 for t in model.state_dict().values() if t.is_floating_point()):
        raise AssertionError("the fp32 ViT-L model holds parameters that are not float32")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env32.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=torch.float32)
    if want_per_step is None:
        state, losses, launches, step_ms = train_steps(state, step_fn, data, warmup, timed,
                                                       V_BATCH)
    else:
        state, losses, launches, step_ms = counted_train_steps(
            state, step_fn, data, warmup, timed, V_BATCH, want_per_step, "ViT-L fp32 train")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_steps(state, step_fn, data, "ViT-L/16 + ASPP fp32 train step", step_ms)
    classes_of = dict(KERNEL_CLASSES)
    needles = (classes_of["global-attention kernels"] + classes_of["window attention kernels"]
               + classes_of["global attention (SDPA: flash / memory-efficient)"])
    attn = sum(ms for key, ms in prof["kernels"].items() if any(n in key for n in needles))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"the fp32 ViT-L step gave losses {losses}")
    return launches, {"vit32 step ms": step_ms, "vit32 step device ms": prof["device_ms"],
                      "vit32 step attention ms": attn,
                      "vit32 step attention share": attn / prof["device_ms"],
                      "vit32 busy share": prof["device_ms"] / step_ms,
                      "vit32 peak GiB": peak / 2**30, "vit32 losses": losses}


def phase_vit_train_f32(device) -> dict:
    """Phase 12.4: ViT-L + ASPP trained in fp32 (TF32 off), its global
    attention on the pair's split-TF32 form: exactly 1 + 1 loss-kernel and
    24 + 24 fp32-form launches in every step; ms/step, device ms, the pair's
    device ms and share, peak memory, busy share. Returns the launch counts."""
    log(f"-- 12.4: ViT-L/16 + ASPP(256), {V_CLASSES} classes, {HW}x{HW}, batch {V_BATCH}, fp32 "
        "(TF32 off), SGD poly, fused loss at os16; global attention on the pair's split-TF32 "
        "form")
    want = {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1, **T_GLOBAL_F32_PER_STEP}
    launches, row = vit_f32_steps(device, V_F32_WARMUP, V_F32_TIMED, want)
    log(f"ViT-L fp32 train: {row['vit32 step ms']:.2f} ms/step, "
        f"{V_BATCH * 1e3 / row['vit32 step ms']:.2f} img/s, device {row['vit32 step device ms']:.3f} "
        f"ms/step, the pair {row['vit32 step attention ms']:.3f} ms/step (share "
        f"{row['vit32 step attention share']:.4f}), busy {row['vit32 busy share']:.4f}, peak "
        f"{row['vit32 peak GiB']:.2f} GiB, losses {row['vit32 losses']} ({card_line()})")
    return launches


def eva_optimizer(model, backbone):
    """AdamW (decoupled decay 0.05, BN/norm/bias/pos-embed leaves exempt
    by the weight-decay mask) with the layerwise LR decay of the
    reference's EVA hook: ``E_LAYER_DECAY ** (24 - (i + 1))`` for block i,
    1.0 elsewhere."""
    params = param_tree(model)
    pattern = re.compile(backbone.layer_name_pattern)

    def layer(path):
        m = pattern.search(path)
        return int(m.group(1)) + 1 if m else None

    mults = layerwise_decay_multipliers(params, E_LAYER_DECAY, layer, backbone.depth)
    last = f"block{backbone.depth - 1}"
    log(f"layerwise LR multipliers: block0 {mults['backbone/block0/q_proj/kernel']:.6f}, "
        f"{last} {mults[f'backbone/{last}/q_proj/kernel']:.6f}, patch_embed "
        f"{mults['backbone/patch_embed/kernel']:.6f}, head {mults['logits_conv/kernel']:.6f}")
    schedule = warmup_poly_decay(1e-4, 1000, warmup_steps=2)
    return Adam(schedule, weight_decay=0.05, decay_mask=weight_decay_mask(params),
                multipliers=mults)


def phase_eva_train(env) -> tuple[dict, dict]:
    """Phase 12.2: EVA02-L + ASPP trained on a fixed batch at 150 classes
    (no fused-loss launch), then one step with patch dropout."""
    log(f"-- 12.2: EVA02-L/16 (512 coco) + ASPP(256), {E_CLASSES} classes, {HW}x{HW}, batch "
        f"{E_BATCH}, bf16 autocast, AdamW with layerwise decay {E_LAYER_DECAY}, "
        "fuse_upsample_loss=True (above 64 classes: the unfused resize + CE)")
    data = synthetic_batch(env.device, E_BATCH, E_CLASSES)
    model = build_eva_model(env, fused=True)
    backbone = model.backbone
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    state = create_train_state(model, env.generator, eva_optimizer(model, backbone))
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, _, launches, step_ms = counted_train_steps(
        state, step_fn, data, E_WARMUP, E_TIMED, E_BATCH, T_GLOBAL_PER_STEP, "EVA02-L train")
    log(f"EVA02-L train: {step_ms:.2f} ms/step, {E_BATCH * 1e3 / step_ms:.2f} img/s "
        f"({card_line()})")
    profile_steps(state, step_fn, data, "EVA02-L/16 + ASPP train step", step_ms)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}

    backbone.patch_dropout.rate = E_PATCH_DROPOUT
    kept = []
    hook = backbone.patch_dropout.register_forward_hook(
        lambda _m, _i, out: kept.append((out[0].shape[1], out[1] is not None)))
    reset_launch_counts()
    state, parts = step_fn(state, data)
    loss = float(parts["loss"])
    hook.remove()
    backbone.patch_dropout.rate = 0.0
    tokens = (HW // 16) ** 2
    want = 1 + int(tokens * (1 - E_PATCH_DROPOUT))
    log(f"patch dropout {E_PATCH_DROPOUT}: tokens through the blocks {kept} of {1 + tokens} "
        f"(expected {want}), loss {loss:.6f}")
    expect_launches("EVA02-L train with patch dropout", read_launch_counts(), T_GLOBAL_PER_STEP)
    if kept != [(want, True)] or not np.isfinite(loss):
        raise AssertionError("the patch-dropout step did not drop tokens or gave a non-finite loss")
    return launches, trained


def phase_transformer_serve(env, title, build_model, trained, classes) -> dict:
    """Phase 12.3 for one model: ``SegBase.inference`` at batch 2, scales
    (0.75, 1.0) + flip, after a warm-up; then one image's fp32 logits on the
    card against the CPU port's."""
    model = build_model(env, fused=False)
    model.load_state_dict(trained)
    image = torch.tensor(np.random.RandomState(2).rand(T_SERVE_BATCH, HW, HW, 3)
                         .astype(np.float32), device=env.device)
    config = SegModelInferenceConfig(scale_rates=T_SERVE_SCALES, flip=True)
    calls = [0]
    hook = model.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))

    def serve():
        with torch.autocast("cuda", dtype=env.compute_dtype):
            out = model.inference(image, config)
        torch.cuda.synchronize()
        return out

    logits = serve()  # warm-up: cuDNN autotuning of these shapes
    warm_calls = calls[0]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times = []
    for _ in range(T_SERVE_REPS):
        t0 = time.perf_counter()
        logits = serve()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    expect_launches(f"{title} serve", read_launch_counts(), {})
    hook.remove()
    times.sort()
    p50 = times[len(times) // 2]
    log(f"{title} serve: {warm_calls} model calls a request of {T_SERVE_BATCH} images; p50 "
        f"{1e3 * p50:.2f} ms, min {1e3 * times[0]:.2f}, max {1e3 * times[-1]:.2f} over "
        f"{T_SERVE_REPS} calls after one warm-up (host clock, ending in a synchronize); peak "
        f"memory {peak / 2**30:.2f} GiB ({peak} bytes) ({card_line()})")
    expect_shape = (T_SERVE_BATCH, HW, HW, classes)
    if tuple(logits.shape) != expect_shape or logits.dtype != torch.float32:
        raise AssertionError(f"{title} served logits {tuple(logits.shape)} {logits.dtype}, "
                             f"expected {expect_shape} float32")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{title} served logits are not finite")
    if warm_calls != 2 * len(T_SERVE_SCALES):
        raise AssertionError(f"{warm_calls} model calls, expected {2 * len(T_SERVE_SCALES)}")

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the fp32 comparison needs TF32 off")
    card = model.inference(image[:1])
    torch.cuda.synchronize()
    model.to("cpu")
    t0 = time.perf_counter()
    cpu = model.inference(image[:1].cpu())
    cpu_s = time.perf_counter() - t0
    err = float((card.cpu() - cpu).abs().max())
    scale = float(cpu.abs().max())
    log(f"{title} fp32 forward of one image, card (SDPA) vs the CPU port (plain attention, "
        f"{cpu_s:.1f} s): max abs logit diff {err:.3e} vs max |logit| {scale:.3e} (tol "
        f"{T_CARD_VS_CPU_RTOL:g} of it)")
    if not err <= T_CARD_VS_CPU_RTOL * scale:
        raise AssertionError(f"{title}: the card's fp32 logits disagree with the CPU port's")
    return {"p50_s": p50, "min_s": times[0], "max_s": times[-1]}


def phase_transformers(env) -> dict[str, dict]:
    """Phase 12: the global-attention transformers of BASELINE configs #4 and
    #5 (12.4, ViT-L in fp32, runs before 12.3's serves)."""
    log("== phase 12: ViT-L + ASPP and EVA02-L + ASPP (BASELINE configs #4 and #5): train "
        "and serve")
    t_phase = time.perf_counter()
    paths = {}
    paths["vit_train"], vit_trained = phase_vit_train(env)
    torch.cuda.empty_cache()
    log(f"(12.1 done at {time.perf_counter() - t_phase:.1f} s)")
    paths["eva_train"], eva_trained = phase_eva_train(env)
    torch.cuda.empty_cache()
    log(f"(12.2 done at {time.perf_counter() - t_phase:.1f} s)")
    paths["vit32_train"] = phase_vit_train_f32(env.device)
    torch.cuda.empty_cache()
    log(f"(12.4 done at {time.perf_counter() - t_phase:.1f} s)")
    log("-- 12.3: serve, batch 2, scales (0.75, 1.0) + flip, bf16 autocast, trained weights")
    serve = {}
    for path, title, build_model, trained, classes in (
            ("vit_serve", "ViT-L", build_vit_model, vit_trained, V_CLASSES),
            ("eva_serve", "EVA02-L", build_eva_model, eva_trained, E_CLASSES)):
        reset_launch_counts()
        serve[title] = phase_transformer_serve(env, title, build_model, trained, classes)
        paths[path] = read_launch_counts()
        torch.cuda.empty_cache()
    for title, row in serve.items():
        log(json.dumps({"metric": f"{title.lower().replace('-', '_')}_aspp_serve_512x512_b2_"
                                  "ms075_1_flip", "value": round(1e3 * row["p50_s"], 2),
                        "unit": "p50_ms", "reps": T_SERVE_REPS,
                        "min": round(1e3 * row["min_s"], 2), "max": round(1e3 * row["max_s"], 2)}))
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return paths


# ------------------------------------------- the backbone zoo (phase 13)

def build_zoo_model(env, backbone: str, head: str, classes: int, fused: bool = True,
                    **backbone_kwargs) -> SegManaged:
    """``SegManaged(backbone + head)`` with the head built as ``train_seg``
    builds it (at the JAX drivers' defaults), channels_last on the card."""
    bb = get_backbone(backbone, **backbone_kwargs)
    model = SegManaged(num_class=classes, backbone=bb,
                       head=train_seg_example.build_head(head, bb),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    return model.to(env.device, memory_format=torch.channels_last)


def build_convnext_fapn(env, fused: bool) -> SegManaged:
    """13.1's model: ``convnext_large`` at output stride 32, drop-path rate
    0.4 (the ConvNeXt authors' ConvNeXt-L segmentation rate) + ``FAPN()``
    (filters 128, the coarsest level raw), 19 classes, logits at os4."""
    return build_zoo_model(env, "convnext_large", "fapn", C_CLASSES, fused, output_stride=32,
                           drop_path_rate=C_DROP_PATH)


def phase_convnext_fapn_train(env) -> tuple[dict, dict]:
    """Phase 13.1: ConvNeXt-L + FaPN trained on a fixed batch of Cityscapes'
    512x1024 crops; returns the launch counts and the trained weights."""
    log(f"-- 13.1: ConvNeXt-L (os32, drop path {C_DROP_PATH}) + FaPN(128), {C_CLASSES} "
        f"classes, {C_HW[0]}x{C_HW[1]}, batch {C_BATCH}, bf16 autocast, SGD poly, fused loss "
        "at os4")
    data = synthetic_batch(env.device, C_BATCH, C_CLASSES, C_HW)
    model = build_convnext_fapn(env, fused=True)
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, _, launches, step_ms = counted_train_steps(
        state, step_fn, data, C_WARMUP, C_TIMED, C_BATCH,
        {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1}, "ConvNeXt-L + FaPN train")
    log(f"ConvNeXt-L + FaPN train: {step_ms:.2f} ms/step, {C_BATCH * 1e3 / step_ms:.2f} img/s; "
        f"loss-kernel launches over {C_WARMUP + C_TIMED} steps: fwd "
        f"{launches['upsample_ce_fwd']}, bwd {launches['upsample_ce_bwd']} ({card_line()})")
    profile_steps(state, step_fn, data, "ConvNeXt-L + FaPN train step", step_ms)
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return launches, trained


def phase_convnext_fapn_sliding(env, trained) -> dict[str, int]:
    """Phase 13.2: the Cityscapes eval geometry, one 1024x2048 image through
    512x1024 windows at the default stride (2/3 of the window), bf16, with
    13.1's weights; p50, min and max over C_SLIDE_REPS calls after a warm-up."""
    starts, _, _ = sliding_window_plan(C_SLIDE_HW, C_SLIDE_WINDOW)
    log(f"-- 13.2: sliding-window eval, one {C_SLIDE_HW[0]}x{C_SLIDE_HW[1]} image, "
        f"{C_SLIDE_WINDOW[0]}x{C_SLIDE_WINDOW[1]} windows at stride 2/3 ({len(starts)} windows), "
        "bf16 autocast, 13.1's weights")
    model = build_convnext_fapn(env, fused=False)
    model.load_state_dict(trained)
    image = torch.tensor(np.random.RandomState(0).rand(1, *C_SLIDE_HW, 3).astype(np.float32),
                         device=env.device)
    calls = [0]
    hook = model.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
    config = SegModelInferenceConfig(sliding_window_crop_size=C_SLIDE_WINDOW)

    def serve():
        with torch.no_grad(), torch.autocast("cuda", dtype=env.compute_dtype):
            out = model.inference(image, config)
        torch.cuda.synchronize()
        return out

    reset_launch_counts()
    logits = serve()  # warm-up: cuDNN autotuning of the window shape
    warm_calls = calls[0]
    hook.remove()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(C_SLIDE_REPS):
        t0 = time.perf_counter()
        logits = serve()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches = read_launch_counts()
    expect_launches("ConvNeXt-L + FaPN sliding-window eval", launches, {})
    times.sort()
    p50 = times[len(times) // 2]
    log(f"sliding window: {warm_calls} model calls a request; p50 {p50:.4f} s, min "
        f"{times[0]:.4f}, max {times[-1]:.4f} over {C_SLIDE_REPS} calls after one warm-up "
        f"(host clock, ending in a synchronize); peak memory {peak / 2**30:.2f} GiB ({peak} "
        f"bytes) ({card_line()})")
    log(json.dumps({"metric": f"convnext_l_fapn_sliding_window_{C_SLIDE_HW[0]}x{C_SLIDE_HW[1]}"
                              "_eval", "value": round(p50, 4), "unit": "p50_seconds",
                    "reps": len(times), "min": round(times[0], 4), "max": round(times[-1], 4)}))
    expect_shape = (1, *C_SLIDE_HW, C_CLASSES)
    if tuple(logits.shape) != expect_shape or logits.dtype != torch.float32:
        raise AssertionError(f"sliding-window logits {tuple(logits.shape)} {logits.dtype}, "
                             f"expected {expect_shape} float32")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("sliding-window logits are not finite")
    if warm_calls != len(starts):
        raise AssertionError(f"{warm_calls} model calls, expected {len(starts)}")
    return launches


def phase_convnext_fapn_card_vs_cpu(env, trained) -> None:
    """Phase 13.3: one small image's fp32 logits (TF32 off) on the card
    against the CPU port's, 13.1's weights."""
    log(f"-- 13.3: ConvNeXt-L + FaPN fp32 forward of one {C_CPU_HW[0]}x{C_CPU_HW[1]} image, card "
        "against the CPU port, 13.1's weights")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the fp32 comparison needs TF32 off")
    model = build_convnext_fapn(env, fused=True)
    model.load_state_dict(trained)
    image = torch.tensor(np.random.RandomState(3).rand(1, *C_CPU_HW, 3).astype(np.float32))
    with torch.no_grad():
        card = model.inference(image.to(env.device)).cpu()
        model.to("cpu")
        t0 = time.perf_counter()
        cpu = model.inference(image)
        cpu_s = time.perf_counter() - t0
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    log(f"ConvNeXt-L + FaPN fp32 logits {tuple(cpu.shape)}, card vs the CPU port ({cpu_s:.1f} s "
        f"on the CPU): max abs diff {err:.3e} vs max |logit| {scale:.3e}: {err / scale:.3e} of it "
        f"(tol {C_CARD_VS_CPU_RTOL:g})")
    if not (np.isfinite(scale) and err <= C_CARD_VS_CPU_RTOL * scale):
        raise AssertionError("ConvNeXt-L + FaPN: the card's fp32 logits disagree with the CPU "
                             "port's")


@contextlib.contextmanager
def cudnn_heuristics():
    """cuDNN's heuristic choice of conv algorithms inside the block, no
    autotuning: a few steps of a model whose every conv shape is new would
    spend most of their time timing algorithms (EfficientNet-B7's first
    step took 73 s with autotuning on an H100)."""
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = before


def phase_xception_train(env) -> dict[str, int]:
    """Phase 13.4: DeepLabV3 on VOC, Xception-65 (os16) + ASPP(256), 21
    classes, 512x512, batch 16, bf16, a warm-up step and 3 timed ones, with
    cuDNN's heuristic conv algorithms (no autotuning)."""
    log(f"-- 13.4: Xception-65 (os16) + ASPP(256), {X_CLASSES} classes, {HW}x{HW}, batch "
        f"{X_BATCH}, bf16 autocast, SGD poly, fused loss at os16, cuDNN heuristics (no "
        "autotuning)")
    data = synthetic_batch(env.device, X_BATCH, X_CLASSES)
    model = build_zoo_model(env, "xception65", "aspp", X_CLASSES, output_stride=16)
    log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    with cudnn_heuristics():
        _, _, launches, step_ms = counted_train_steps(
            state, step_fn, data, X_WARMUP, X_TIMED, X_BATCH,
            {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1}, "Xception-65 + ASPP train")
    log(f"Xception-65 + ASPP train: {step_ms:.2f} ms/step, {X_BATCH * 1e3 / step_ms:.2f} img/s "
        f"({card_line()})")
    return launches


def phase_zoo_steps(env) -> dict[str, dict]:
    """Phase 13.5: one warm-up and one timed full-width train step of each
    other new family at 512x512, batch 2, bf16, 19 classes, fused loss,
    cuDNN's heuristic conv algorithms (no autotuning)."""
    paths = {}
    data = synthetic_batch(env.device, Z_BATCH, Z_CLASSES)
    for path, title, backbone, head, kw in Z_MODELS:
        log(f"-- 13.5: {title}, {Z_CLASSES} classes, {HW}x{HW}, batch {Z_BATCH}, bf16 autocast, "
            "SGD poly, fused loss, cuDNN heuristics (no autotuning)")
        model = build_zoo_model(env, backbone, head, Z_CLASSES, **kw)
        log(f"parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
        tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
        state = create_train_state(model, env.generator, tx)
        step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
        # MOAT's attention blocks (no relative bias here): global attention
        # with a gradient, each one forward and one backward launch of the
        # global-attention kernel pair
        attention = sum(getattr(m, "use_attention", False) for m in model.backbone.modules())
        want = {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1}
        if attention:
            want.update(global_attention_fwd=attention, global_attention_bwd=attention)
        with cudnn_heuristics():
            _, losses, paths[path], step_ms = counted_train_steps(
                state, step_fn, data, 1, 1, Z_BATCH, want, f"{title} train")
        peak = torch.cuda.max_memory_allocated()
        log(f"{title}: the timed step {step_ms:.2f} ms, peak memory {peak / 2**30:.2f} GiB, loss "
            f"{losses[-1]:.6f} ({card_line()})")
        del state, step_fn, model
        torch.cuda.empty_cache()
    return paths


def phase_zoo(env) -> dict[str, dict]:
    """Phase 13: the rest of the backbone zoo and heads."""
    log("== phase 13: ConvNeXt-L + FaPN (Cityscapes train and sliding-window eval), "
        "Xception-65 + ASPP, and one train step of EfficientNet-B7 + NAS-FPN, MOAT-4, "
        "MLP-Mixer-L/16 and ConvNeXt-V2-L")
    t_phase = time.perf_counter()
    paths = {}
    paths["convnext_fapn_train"], trained = phase_convnext_fapn_train(env)
    torch.cuda.empty_cache()
    log(f"(13.1 done at {time.perf_counter() - t_phase:.1f} s)")
    paths["convnext_fapn_sliding"] = phase_convnext_fapn_sliding(env, trained)
    torch.cuda.empty_cache()
    log(f"(13.2 done at {time.perf_counter() - t_phase:.1f} s)")
    phase_convnext_fapn_card_vs_cpu(env, trained)
    del trained
    torch.cuda.empty_cache()
    log(f"(13.3 done at {time.perf_counter() - t_phase:.1f} s)")
    paths["xception_train"] = phase_xception_train(env)
    torch.cuda.empty_cache()
    log(f"(13.4 done at {time.perf_counter() - t_phase:.1f} s)")
    paths.update(phase_zoo_steps(env))
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return paths


# ------------------------------------------ pretrained weights (phase 14)
# (the modules these phases need are imported in them: --ab runs this file's
# code on trees from before those modules)

def published_weights(inventory: str, seed: int = 0) -> dict[str, np.ndarray]:
    """A flat ``{name: array}`` of one published checkpoint: the reference's
    names and shapes from ``tests/data/ref_weights/<inventory>.txt``, the
    values drawn from ``seed``. Kernels are N(0, 1/fan_in) (a depthwise
    ``[H, W, C, 1]`` kernel's fan-in is H*W), scales (``gamma*``) and moving
    variances uniform in [0.5, 1.5), every other vector N(0, 0.02^2)."""
    rng = np.random.RandomState(seed)
    out: dict[str, np.ndarray] = {}
    for line in (REF_WEIGHTS / f"{inventory}.txt").read_text().splitlines():
        name, dims = line.rsplit(" ", 1)
        shape = tuple(int(d) for d in dims.split(","))
        leaf = name.rsplit("/", 1)[-1]
        if len(shape) >= 2:
            fan_in = np.prod(shape[:2] if len(shape) == 4 and shape[3] == 1 else shape[:-1])
            value = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif leaf.startswith("gamma") or leaf == "moving_variance":
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = 0.02 * rng.standard_normal(shape)
        out[name] = value.astype(np.float32)
    return out


def intern_weights_with_offsets(seed: int = 0) -> dict[str, np.ndarray]:
    """InternImage-T's published weights (:func:`published_weights`) with
    each stage's offset heads set so that calibration lands on another
    outcome: the head's bias ``P_OFFSET_BIAS[stage]`` and its kernel scaled
    by ``P_OFFSET_KERNEL_SCALE`` (the input-dependent part of the offsets a
    few hundredths of a pixel)."""
    from iseg_tpu_torch.core.h5_ingest import canonical_ref_name

    weights = published_weights("intern_image_tiny", seed)
    for name in weights:
        canon = canonical_ref_name(name, drop_root=True)  # block.{s}/layer.{i}/dcn/offset/bias
        if "/dcn/offset/" not in canon:
            continue
        stage = int(canon.split("/")[0].split(".")[1])
        if canon.endswith("/bias"):
            weights[name] = np.full_like(weights[name], P_OFFSET_BIAS[stage])
        else:
            weights[name] = weights[name] * P_OFFSET_KERNEL_SCALE
    return weights


def max_rel_err(got, want) -> tuple[float, float]:
    """Max |got - want| and max |want| over a tensor or a list of them."""
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    err = max(float((a.float().cpu() - b.float().cpu()).abs().max()) for a, b in zip(got, want))
    return err, max(float(b.float().abs().max()) for b in want)


def phase_headline_ingest(env) -> None:
    """14.1: ResNet-50 os16 + ASPP (phase 3's model) takes the published
    ResNet-50 names by ``keras_resnet_name_map`` on the card, and its fp32
    logits equal the CPU port's ingest of the same dict."""
    from iseg_tpu_torch.core.h5_ingest import load_h5_weights_by_name
    from iseg_tpu_torch.core.weight_maps import keras_resnet_name_map

    log("-- 14.1: ResNet-50 os16 + ASPP from the published ResNet-50 names and shapes "
        "(values from seed 0) by keras_resnet_name_map")
    weights = published_weights("resnet50")
    models = {}
    for device in (env.device, torch.device("cpu")):
        model = SegManaged(num_class=R_CLASSES, backbone=get_backbone("resnet50", output_stride=R_OS),
                           head=ASPP(2048, filters=256)).to(device)
        initialize(model, torch.Generator().manual_seed(0))  # the head's draws, on both devices
        t0 = time.perf_counter()
        mapping = keras_resnet_name_map(to_flax(model))
        _, report = load_h5_weights_by_name(model, weights, name_map=mapping)
        unmatched = [p for p in report["missing"] if "/backbone/" in p]
        loaded = [p for p in report["loaded"] if "/backbone/" in p]
        log(f"  {device.type}: {len(weights)} published weights -> {len(loaded)} backbone "
            f"leaves loaded, {len(unmatched)} unmatched, {len(report['heuristic_fallback'])} "
            f"outside the map, in {time.perf_counter() - t0:.2f} s")
        if unmatched or len(loaded) != len(weights):
            raise AssertionError(f"ResNet-50 ingest left backbone leaves unmatched: {unmatched[:6]}")
        models[device.type] = model.eval()
    image = torch.tensor(np.random.RandomState(0).rand(1, P_HEADLINE_HW, P_HEADLINE_HW, 3),
                         dtype=torch.float32)
    with torch.no_grad():
        card = models["cuda"](image.to(env.device))
        cpu = models["cpu"](image)
    err, scale = max_rel_err(card, cpu)
    log(f"  fp32 logits {tuple(card.shape)} on the card vs the CPU port: max abs diff {err:.3e} "
        f"vs max |logit| {scale:.3e} (tol {P_CARD_VS_CPU_RTOL:g} of it)")
    if not (bool(torch.isfinite(card).all()) and err <= P_CARD_VS_CPU_RTOL * scale):
        raise AssertionError("the ingested ResNet-50's logits on the card disagree with the CPU's")


def calibration_table(model) -> dict[tuple[str, int], list[str]]:
    """Blocks by their pinned (mode, r)."""
    table: dict[tuple[str, int], list[str]] = {}
    for block, (mode, r) in sorted(model.dcn_overrides.items()):
        table.setdefault((mode, r), []).append(block)
    return table


def phase_intern_ingest(env):
    """14.2 and 14.3: InternImage-T by ``load_pretrained_backbone`` with its
    DCN calibration on a seeded batch, then the calibrated backbone against
    the gather-sampled one in fp32."""
    from iseg_tpu_torch.backbones.pretrained import load_pretrained_backbone

    log(f"-- 14.2: load_pretrained_backbone('intern_image_tiny') from the published names and "
        f"shapes (offset-head biases {P_OFFSET_BIAS} by stage, kernels x{P_OFFSET_KERNEL_SCALE}), "
        f"calibrated on a seeded batch of {P_CALIB_BATCH} x {HW}x{HW}")
    weights = intern_weights_with_offsets()
    gen = torch.Generator().manual_seed(1)
    batch = (2.0 * torch.rand((P_CALIB_BATCH, 3, HW, HW), generator=gen) - 1.0).to(env.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    backbone, report = load_pretrained_backbone("intern_image_tiny", weights, device=env.device,
                                                calibration_input=batch)
    torch.cuda.synchronize()
    log(f"  built, ingested and calibrated in {time.perf_counter() - t0:.2f} s: "
        f"{len(report['weights']['loaded'])} leaves loaded, "
        f"{len(report['weights']['missing'])} unmatched")
    if report["weights"]["missing"]:
        raise AssertionError(f"InternImage-T ingest left leaves: {report['weights']['missing'][:6]}")
    calib = report["dcn_calibration"]
    by_stage = {}
    for layer, rec in calib.items():
        by_stage.setdefault(int(layer[5:layer.index("_")]), []).append(rec["max_offset_mag"])
    for stage, mags in sorted(by_stage.items()):
        log(f"  stage {stage}: max |effective offset| {min(mags):.4f} - {max(mags):.4f} over "
            f"{len(mags)} blocks")
    table = calibration_table(backbone)
    log("  calibration: " + "; ".join(f"{mode} r={r}: {len(blocks)} blocks ({blocks[0]}..)"
                                      for (mode, r), blocks in sorted(table.items())))
    for stage, (mode, r) in enumerate(P_EXPECT):
        got = {backbone.dcn_overrides[b] for b in backbone.dcn_overrides
               if b.startswith(f"stage{stage}_")}
        if {m for m, _ in got} != {mode} or (r is not None and {r_ for _, r_ in got} != {r}):
            raise AssertionError(f"stage {stage} calibrated to {got}, expected {mode} r={r}")

    log(f"-- 14.3: one {HW}x{HW} image in fp32 (TF32 off): the calibrated backbone (dense-local "
        "kernels at the calibrated radii) against the same weights on the gather sampler")
    backbone.eval()  # built in train mode: its drop-path layers would draw
    gather = backbone.clone(dcn_sampling="gather", dcn_overrides=None)
    uncalibrated = backbone.clone(dcn_sampling="dense_local_ref", dcn_overrides=None)
    image = batch[:1]
    dense_blocks = sum(len(b) for (mode, _), b in table.items() if mode == "dense_local_ref")
    with torch.no_grad():
        reset_launch_counts()
        out = backbone(image)
        torch.cuda.synchronize()
        expect_launches("calibrated InternImage-T forward", read_launch_counts(),
                        {"deform_local_fwd": dense_blocks})
        ref = gather(image)
        raw = uncalibrated(image)
    err, scale = max_rel_err(out, ref)
    raw_err, _ = max_rel_err(raw, ref)
    log(f"  calibrated vs gather, over the 5 endpoints: max abs diff {err:.3e} vs max |output| "
        f"{scale:.3e} (tol {P_CALIB_VS_GATHER_RTOL:g} of it); the uncalibrated r = "
        f"{DL_MAX_OFFSET} model vs gather: {raw_err:.3e} ({raw_err / scale:.3e} of it)")
    if not err <= P_CALIB_VS_GATHER_RTOL * scale:
        raise AssertionError("the calibrated backbone disagrees with the gather sampler")
    if not raw_err > 1e-3 * scale:
        raise AssertionError("the r = 2 clamp should part from the gather sampler on these offsets")
    del gather, uncalibrated, out, ref, raw
    return backbone, table, dense_blocks


def build_calibrated_model(env, backbone, fused: bool) -> SegManaged:
    """14.4's model: the calibrated InternImage-T + ASPP(256), 19 classes,
    its head drawn from seed 0."""
    model = SegManaged(num_class=P_CLASSES, backbone=backbone.clone(),
                       head=ASPP(backbone.out_channels, filters=256),
                       upsample_logits=not fused, fuse_upsample_loss=fused)
    gen = torch.Generator().manual_seed(0)
    for name, child in model.named_children():
        if name != "backbone":
            initialize(child, gen)
    return model.to(env.device, memory_format=torch.channels_last)


def phase_calibrated_train_serve(env, backbone, dense_blocks: int) -> dict[str, dict]:
    """14.4: the calibrated model trained (bf16 autocast, SGD poly, fused
    loss) and served as phase 9 serves."""
    log(f"-- 14.4: calibrated InternImage-T + ASPP(256) train, batch {P_BATCH}, {HW}x{HW}, "
        f"{P_WARMUP} warm-up + {P_TIMED} timed steps; {dense_blocks} dense-local blocks")
    data = synthetic_batch(env.device, P_BATCH, P_CLASSES)
    model = build_calibrated_model(env, backbone, fused=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, None, tx, initialized=True)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, losses, launches, step_ms = counted_train_steps(
        state, step_fn, data, P_WARMUP, P_TIMED, P_BATCH,
        {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1, "deform_local_fwd": dense_blocks,
         "deform_local_bwd": dense_blocks}, "calibrated InternImage train")
    log(f"  calibrated step {step_ms:.2f} ms ({card_line()}); phase 8's step runs every block "
        f"at r = {DL_MAX_OFFSET}")
    serve = phase_serve(env, data, model, "calibrated InternImage",
                        lambda env_, fused: build_calibrated_model(env_, backbone, fused),
                        I_SERVE_BATCH, P_CLASSES, "deform_local_fwd", dense_blocks,
                        (dcn_module, "dense_local_flat", dl.deform_dense_local_flat_reference),
                        offsets_swapped_fault())
    return {"calibrated_intern_train": launches, "calibrated_intern_serve": serve}


def phase_radii_rows(device) -> list[dict]:
    """14.5: the dense-local kernels at stage 2's shape in the autocast type
    mix at the radii calibration reaches."""
    log(f"-- 14.5: dense-local kernels at stage 2's shape, r = {P_RADII} (offsets drawn in "
        f"+-(r + 1); tol of max(1, max |plain|): {DL_TOL})")
    rows = []
    for r in P_RADII:
        rows.append(check_deform_local(device, "stage2", 32, 256, 16, "mixed", r=r))
        torch.cuda.empty_cache()
    return rows


def serpentine(side: int, runs: int) -> np.ndarray:
    """Horizontal runs across the map joined at alternate ends: one
    component whose far end lies ``runs * side`` pixels away."""
    mask = np.zeros((side, side), bool)
    rows = np.linspace(0, side - 1, runs).astype(int)
    for i, y in enumerate(rows):
        mask[y, :] = True
        if i + 1 < len(rows):
            mask[y:rows[i + 1] + 1, side - 1 if i % 2 == 0 else 0] = True
    return mask


def phase_ccl(device) -> None:
    """14.6: ``label_components`` on the card against the CPU port."""
    from iseg_tpu_torch.ops.ccl import label_components

    log(f"-- 14.6: label_components on {CCL_BATCH} random-blob {CCL_HW}x{CCL_HW} masks and one "
        f"{CCL_HW}x{CCL_HW} serpentine of {CCL_SNAKE_RUNS} runs, against the CPU port (exact)")
    noise = torch.tensor(np.random.RandomState(0).standard_normal((CCL_BATCH, 1, CCL_HW, CCL_HW)),
                         dtype=torch.float32)
    smooth = F.avg_pool2d(noise, 15, stride=1, padding=7)[:, 0]
    cases = {"blobs": smooth > 0.5 * smooth.std(),
             "serpentine": torch.tensor(serpentine(CCL_HW, CCL_SNAKE_RUNS))}
    for name, mask in cases.items():
        for connectivity in (4, 8):
            want, cpu_iters = label_components(mask, connectivity, return_iterations=True)
            card_mask = mask.to(device)
            label_components(card_mask, connectivity)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, iters = label_components(card_mask, connectivity, return_iterations=True)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            components = int(torch.unique(want).numel()) - 1
            log(f"  {name} {tuple(mask.shape)}, {connectivity}-connectivity: {components} "
                f"components, {iters} iterations on the card ({cpu_iters} on the CPU), "
                f"{ms:.2f} ms ({ms / iters:.4f} ms an iteration)")
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"label_components on the card differs from the CPU: {name}")


def phase_pretrained(env) -> tuple[dict[str, dict], list[dict]]:
    """Phase 14: pretrained-weight ingest with DCN calibration on the card.
    Returns the launch counts by path and 14.5's kernel rows."""
    log("== phase 14: pretrained-weight ingest (ResNet-50, InternImage-T with DCN calibration), "
        "the calibrated model trained and served, dense-local kernels at the calibrated radii, "
        "connected components")
    t_phase = time.perf_counter()
    phase_headline_ingest(env)
    torch.cuda.empty_cache()
    log(f"(14.1 done at {time.perf_counter() - t_phase:.1f} s)")
    backbone, _, dense_blocks = phase_intern_ingest(env)
    torch.cuda.empty_cache()
    log(f"(14.3 done at {time.perf_counter() - t_phase:.1f} s)")
    paths = phase_calibrated_train_serve(env, backbone, dense_blocks)
    del backbone
    torch.cuda.empty_cache()
    log(f"(14.4 done at {time.perf_counter() - t_phase:.1f} s)")
    rows = phase_radii_rows(env.device)
    log(f"(14.5 done at {time.perf_counter() - t_phase:.1f} s)")
    phase_ccl(env.device)
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s ({card_line()})")
    return paths, rows


# ------------------------------------------------------- two trees (--ab)

# ----------------------------------------------------------------- phase 15

def params_digest(state) -> str:
    """sha256 of every parameter and BN statistic's bytes, in path order:
    two ranks hold the same state bit for bit when their digests agree."""
    h = hashlib.sha256()
    for tree in (state.params, state.batch_stats):
        for k in sorted(tree):
            t = tree[k].detach()
            t = t.full_tensor() if hasattr(t, "full_tensor") else t
            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_batch(device=None):
    """Phase 15.1's global batch of DP_BATCH at 512x512: the first half
    (rank 0's at world size 2) has DP_IGNORE[0] of its pixels ignored, the
    second half DP_IGNORE[1]."""
    rng = np.random.RandomState(15)
    image = rng.rand(DP_BATCH, HW, HW, 3).astype(np.float32)
    label = rng.randint(0, R_CLASSES, (DP_BATCH, HW, HW))
    share = np.where(np.arange(DP_BATCH) < DP_BATCH // 2, *DP_IGNORE)[:, None, None]
    label = np.where(rng.rand(DP_BATCH, HW, HW) < share, 255, label).astype(np.int32)
    if device is None:
        return {"image": image, "label": label}
    return {"image": torch.tensor(image, device=device),
            "label": torch.tensor(label, device=device)}


def dp_trainer(env, mesh, compute_dtype):
    """Phase 3's configuration from seed-0 weights: (state, step)."""
    model = build_resnet_model(env, fused=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, torch.Generator().manual_seed(0), tx)
    return state, make_train_step(model.build_loss_fn(), compute_dtype=compute_dtype, seed=0,
                                  mesh=mesh)


def state_arrays(state) -> dict[str, np.ndarray]:
    """Copies of the params and BN statistics, keyed by path."""
    return {**{f"params/{k}": v.detach().cpu().numpy().copy() for k, v in state.params.items()},
            **{f"batch_stats/{k}": v.detach().cpu().numpy().copy()
               for k, v in state.batch_stats.items()}}


def counted_step(step, state, batch):
    """One step and its loss-kernel launches."""
    before = dict(uce.LAUNCH_COUNTS)
    state, parts = step(state, batch)
    torch.cuda.synchronize()
    return state, parts, {k: uce.LAUNCH_COUNTS[k] - before[k] for k in before}


def rank_dp2(env, out: str, shard_dir: str) -> dict:
    """One rank of phases 15.1, 15.3 and 15.4 (world size 2, gloo, cuda:0)."""
    from iseg_tpu_torch.core.inference import inference_with_sliding_window_sharded
    from iseg_tpu_torch.parallel.collectives import HOST_STAGED, barrier
    from iseg_tpu_torch.parallel.mesh import shard_batch

    mesh, rank = env.mesh, env.rank
    res = {"rank": rank, "device": str(env.device)}
    # 15.1: fp32 steps, each followed by a digest of the whole state
    local = shard_batch(mesh, dp_batch(env.device))
    state, step = dp_trainer(env, mesh, torch.float32)
    res["losses"], res["digests"], res["launches"] = [], [], []
    for i in range(DP_STEPS):
        state, parts, launches = counted_step(step, state, local)
        res["losses"].append(float(parts["loss"]))
        res["digests"].append(params_digest(state))
        res["launches"].append(launches)
        if rank == 0 and i + 1 in DP_STATE_RTOL:
            with open(os.path.join(out, f"dp_state_{i + 1}.pkl"), "wb") as f:
                pickle.dump(state_arrays(state), f)
    # the negative controls: the same fp32 steps with a fault planted
    for fault in DP_FAULTS:
        bad, bad_step = dp_trainer(env, mesh, torch.float32)
        with planted_fault(fault):
            for i in range(DP_STEPS):
                bad, _, _ = counted_step(bad_step, bad, local)
                if rank == 0 and i + 1 in DP_STATE_RTOL:
                    with open(os.path.join(out, f"dp_{fault}_{i + 1}.pkl"), "wb") as f:
                        pickle.dump(state_arrays(bad), f)
        del bad, bad_step
    # bf16 steps, timed: two processes share the one card
    step16 = make_train_step(state.model.build_loss_fn(), compute_dtype=torch.bfloat16,
                             seed=0, mesh=mesh)
    state, _, _ = counted_step(step16, state, local)
    barrier()
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        state, parts, launches = counted_step(step16, state, local)
        res["launches"].append(launches)
    barrier()
    res["bf16_ms"] = 1e3 * (time.perf_counter() - t0) / DP_STEPS
    res["bf16_loss"] = float(parts["loss"])
    del state, step, step16, local
    torch.cuda.empty_cache()

    # 15.3: the resident dataset sharded over the two ranks
    resident = DeviceResidentDataset(ShardReader(shard_dir), device=env.device, mesh=mesh)
    res["resident"] = {"row_start": resident.row_start, "rows": len(resident.images),
                       "num_samples": resident.num_samples}
    res["resident_loss"] = resident_step_loss(env, resident, mesh)
    del resident
    torch.cuda.empty_cache()

    # 15.4: sharded evaluate and sliding window, fp32
    model = eval_model(env)
    metric = MeanIoU(R_CLASSES)
    evaluate(env, model, None, [eval_batch()], verbose=False, metric=metric)
    res["cm"] = metric.total_cm
    local_images = shard_batch(mesh, eval_batch())["image"]
    res["eval_logits"] = make_eval_step(model)(
        torch.tensor(local_images, device=env.device)).cpu().numpy()
    with torch.inference_mode():
        image = torch.tensor(window_image(), device=env.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window = inference_with_sliding_window_sharded(model, image, (HW, HW), mesh)
        torch.cuda.synchronize()
        res["window_s"] = time.perf_counter() - t0
    if rank == 0:
        np.save(os.path.join(out, "window.npy"), window.cpu().numpy())
    res["host_staged"] = dict(HOST_STAGED)
    return res


def rank_nccl1(env, out: str, shard_dir: str) -> dict:
    """Phase 15.2 (world size 1, NCCL): the bf16 step through the process
    group against the same step without one, and the FSDP step."""
    from iseg_tpu_torch.parallel.fsdp import shard_fsdp

    data = dp_batch(env.device)
    res = {}
    for name, mesh in (("no_group", None), ("nccl", env.mesh)):
        state, step = dp_trainer(env, mesh, torch.bfloat16)
        losses, digests = [], []
        for _ in range(2):
            state, parts, _ = counted_step(step, state, data)
            losses.append(float(parts["loss"]))
            digests.append(params_digest(state))
        res[name] = {"losses": losses, "digests": digests}
        if mesh is not None:
            dp_params = {k: v.detach().clone() for k, v in state.params.items()}
        del state, step
    model = build_resnet_model(env, fused=True)
    initialize(model, torch.Generator().manual_seed(0))
    shard_fsdp(model, env.mesh)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, None, tx, initialized=True)
    step = make_train_step(model.build_loss_fn(), compute_dtype=torch.bfloat16, seed=0,
                           mesh=env.mesh)
    losses = []
    for _ in range(2):
        state, parts, _ = counted_step(step, state, data)
        losses.append(float(parts["loss"]))
    top = max(float(v.abs().max()) for v in dp_params.values())
    err = max(float((v.full_tensor() - dp_params[k]).abs().max())
              for k, v in state.params.items())
    res["fsdp"] = {"losses": losses, "max_err": err, "top": top,
                   "sharded": sum(1 for v in state.params.values()
                                  if any(type(p).__name__ == "Shard" for p in v.placements)),
                   "leaves": len(state.params)}
    del state, step, model
    # CoreTrain on the group (its preemption vote an all-reduce on the card):
    # the same two steps from host batches
    model = build_resnet_model(env, fused=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    trainer = CoreTrain(dataclasses.replace(env, compute_dtype=torch.bfloat16), model, tx,
                        seed=0, log_every=0, prefetch_to_device=1)
    digests = []
    history = trainer.train(lambda epoch: iter([dp_batch()]), epochs=2,
                            on_epoch_end=lambda epoch, st: digests.append(params_digest(st)))
    res["coretrain"] = {"digests": digests, "losses": [h["loss"] for h in history]}
    return res


def rank_main(rank: int, world: int, backend: str, store: str, out: str, task: str,
              shard_dir: str) -> None:
    """A spawned rank of phase 15 or 16: sets its process group up by
    ``common_env_setup``, runs ``task`` and pickles the result to ``out``."""
    from iseg_tpu_torch.core.env import common_env_clean

    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        env = common_env_setup(EnvConfig(
            random_seed=0, mixed_precision=False, device="cuda", initialize_distributed=True,
            backend=backend, init_method=f"file://{store}", num_processes=world,
            process_id=rank))
        result = {"dp2": rank_dp2, "nccl1": rank_nccl1, "lm2": rank_lm}[task](env, out,
                                                                             shard_dir)
        with open(os.path.join(out, f"{task}-{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out, f"{task}-{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        common_env_clean()


def spawn_ranks(task: str, world: int, backend: str, out: str, shard_dir: str,
                timeout: float = DP_TIMEOUT_S) -> list[dict]:
    """Run ``task`` on ``world`` spawned ranks; every rank must finish within
    ``timeout`` seconds (the rest are killed) and succeed."""
    store = os.path.join(out, f"{task}.store")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, backend, store, out, task, shard_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    failed = []
    for r, p in enumerate(procs):
        err = os.path.join(out, f"{task}-{r}.err")
        if p.exitcode != 0:
            why = open(err).read()[-4000:] if os.path.exists(err) else (
                f"no result within {timeout:.0f} s (killed)" if p in alive
                else f"exit code {p.exitcode}")
            failed.append(f"rank {r}: {why}")
    if failed:
        raise AssertionError(f"ranks of {task} failed:\n" + "\n".join(failed))
    results = []
    for r in range(world):
        with open(os.path.join(out, f"{task}-{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def resident_step_loss(env, resident, mesh) -> float:
    """First-step fp32 loss of a resident step over the first global batch
    of epoch 0, with phase 5b's device augment."""
    model = build_resnet_model(env, fused=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, torch.Generator().manual_seed(0), tx)
    augment = zero_mean_augment(DeviceAugmentConfig(
        crop_size=(HW, HW), min_scale_factor=0.5, max_scale_factor=2.0, scale_step_size=0.25,
        flip_prob=0.5))
    step = make_resident_train_step(model.build_loss_fn(), resident.images, resident.labels,
                                    augment_fn=augment, compute_dtype=torch.float32, seed=0,
                                    mesh=mesh, row_start=resident.row_start)
    idx = next(iter(resident.index_batches(R_BATCH, epoch=0, seed=0)))
    _, parts = step(state, idx)
    return float(parts["loss"])


def eval_model(env):
    model = build_resnet_model(env, fused=False)
    initialize(model, torch.Generator().manual_seed(0))
    return model.eval()


def eval_batch():
    rng = np.random.RandomState(16)
    label = rng.randint(0, R_CLASSES, (EVAL_DP_BATCH, HW, HW))
    label = np.where(rng.rand(EVAL_DP_BATCH, HW, HW) < 0.1, 255, label).astype(np.int32)
    return {"image": rng.rand(EVAL_DP_BATCH, HW, HW, 3).astype(np.float32), "label": label}


def window_image():
    return np.random.RandomState(17).rand(1, 1024, 2048, 3).astype(np.float32)


def phase_distributed(env) -> dict[str, dict[str, int]]:
    """Phase 15: data parallelism (see the module note). Returns the
    loss-kernel launches of 15.1's steps on both ranks."""
    log("== phase 15: data parallelism (process groups, SyncBN, global losses, fixed-order "
        "gradient all-reduce, FSDP, the sharded resident dataset, evaluate and window)")
    card = card_line()
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory(prefix="iseg_dp_") as tmp:
            return distributed_runs(env, tmp, card)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


@contextlib.contextmanager
def fast_variance_batchnorm(parts: int = 1):
    """BatchNorm's training moments as SyncBN takes them at world size
    ``parts``, inside the block: the sum and sum of squares of each of
    ``parts`` equal slices of the batch, added in rank order, then E[x^2] -
    E[x]^2 (flax's fast variance) instead of a two-pass variance."""
    from iseg_tpu_torch.nn.norm import BatchNorm

    two_pass = BatchNorm.forward

    def forward(self, x):
        if not self.training:
            return two_pass(self, x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.ndim))
        sums = None
        for part in xf.chunk(parts):
            mine = torch.cat([part.sum(dim=dims), part.square().sum(dim=dims)])
            sums = mine if sums is None else sums + mine
        c, n = x.shape[1], float(x.numel() // x.shape[1])
        mean = sums[:c] / n
        var = torch.clamp(sums[c:] / n - mean.square(), min=0.0)
        return self._normalize(x, xf, mean, var, update=True)

    BatchNorm.forward = forward
    try:
        yield
    finally:
        BatchNorm.forward = two_pass


@contextlib.contextmanager
def planted_fault(name: str):
    """One of 15.1's negative controls, planted in this process for the
    block: ``rank_means``, each rank's loss its own valid-pixel mean (the
    step then averages the ranks' means); ``bn_backward_local``, SyncBN's
    backward without the all-reduce of its two gradient sums."""
    from iseg_tpu_torch.nn import norm

    if name == "rank_means":
        target, attr = uce, "global_valid_mean"
        fault = lambda total, count: total / torch.clamp(count, min=1.0)  # noqa: E731
    elif name == "bn_backward_local":
        target, attr = norm._AllReduceSum, "backward"
        fault = staticmethod(lambda ctx, grad: (grad.contiguous().clone(), None))
    else:
        raise ValueError(f"no planted fault named {name!r}")
    saved = vars(target)[attr]
    setattr(target, attr, fault)
    try:
        yield
    finally:
        setattr(target, attr, saved)


def max_rel(got: dict, want: dict) -> tuple[float, str]:
    """max |got - want| over every tensor, over max |want| (and its tensor)."""
    top = max(float(np.abs(v).max()) for v in want.values())
    worst = max(want, key=lambda k: float(np.abs(got[k] - want[k]).max()))
    return float(np.abs(got[worst] - want[worst]).max()) / top, worst


def distributed_runs(env, tmp: str, card: str) -> dict[str, dict[str, int]]:
    t_phase = time.perf_counter()
    f32 = dataclasses.replace(env, compute_dtype=torch.float32)
    shard_dir = os.path.join(tmp, "shards")
    write_shards(SyntheticShardSource(SYS_SAMPLES, SYS_STORE, R_CLASSES), shard_dir,
                 store_size=(SYS_STORE, SYS_STORE), samples_per_shard=48)

    # world size 1 without a process group: the references, in this process
    data = dp_batch(env.device)
    state, step = dp_trainer(f32, None, torch.float32)
    with torch.no_grad():  # each half's own mean loss, the initial weights in eval mode
        half = DP_BATCH // 2
        state.model.eval()
        logits = state.model(data["image"])
        state.model.train()
        halves_mean = float(np.mean([
            float(uce.upsample_cross_entropy(logits[i * half:(i + 1) * half],
                                             data["label"][i * half:(i + 1) * half]))
            for i in (0, 1)]))
        del logits
    # world size 1's runs: the port's own BatchNorm (two-pass variance), and
    # with SyncBN's arithmetic at world size 2 (the reference of the state)
    one_states, one_losses = {}, {}
    for variance, patch in (("two-pass", contextlib.nullcontext),
                            ("SyncBN's", functools.partial(fast_variance_batchnorm, 2))):
        with patch():
            state, step = dp_trainer(f32, None, torch.float32)
            one_states[variance], one_losses[variance] = {}, []
            for i in range(DP_STEPS):
                state, parts, _ = counted_step(step, state, data)
                one_losses[variance].append(float(parts["loss"]))
                if i + 1 in DP_STATE_RTOL:
                    one_states[variance][i + 1] = state_arrays(state)
        del state, step
    del data
    ref_states, ref_losses = one_states["SyncBN's"], one_losses["SyncBN's"]
    ref_resident = resident_step_loss(f32, DeviceResidentDataset(ShardReader(shard_dir),
                                                                 device=env.device), None)
    model = eval_model(f32)
    ref_metric = MeanIoU(R_CLASSES)
    evaluate(f32, model, None, [eval_batch()], verbose=False, metric=ref_metric)
    ref_logits = make_eval_step(model)(torch.tensor(eval_batch()["image"],
                                                    device=env.device)).cpu().numpy()
    with torch.inference_mode():
        ref_window = inference_with_sliding_window(
            model, torch.tensor(window_image(), device=env.device), (HW, HW)).cpu().numpy()
    del model
    torch.cuda.empty_cache()
    log(f"15: world-size-1 references took {time.perf_counter() - t_phase:.1f} s")

    # 15.2: NCCL at world size 1
    t0 = time.perf_counter()
    (one,) = spawn_ranks("nccl1", 1, "nccl", tmp, shard_dir)
    log(f"-- 15.2: NCCL, world size 1 ({time.perf_counter() - t0:.1f} s with the spawn): "
        f"bf16 losses without a group {one['no_group']['losses']}, through the NCCL group "
        f"{one['nccl']['losses']}; FSDP {one['fsdp']['losses']}, {one['fsdp']['sharded']} of "
        f"{one['fsdp']['leaves']} leaves sharded, params within "
        f"{one['fsdp']['max_err'] / one['fsdp']['top']:.3g} of max |param| of the DP step "
        f"({card})")
    if one["no_group"] != one["nccl"]:
        raise AssertionError("15.2: the step through an NCCL group of one differs from the "
                             "step without a group")
    if one["fsdp"]["losses"][0] != one["nccl"]["losses"][0] or not np.isclose(
            one["fsdp"]["losses"][1], one["nccl"]["losses"][1], rtol=1e-6, atol=0):
        raise AssertionError(f"15.2: FSDP losses {one['fsdp']['losses']} vs DP "
                             f"{one['nccl']['losses']}")
    if one["fsdp"]["max_err"] > FSDP_RTOL * one["fsdp"]["top"] or not one["fsdp"]["sharded"]:
        raise AssertionError(f"15.2: FSDP params off the DP step's: {one['fsdp']}")
    log(f"15.2: CoreTrain on the NCCL group of one, two steps from host batches: losses "
        f"{one['coretrain']['losses']}; its states equal the DP step's bit for bit: "
        f"{one['coretrain']['digests'] == one['nccl']['digests']}")
    if one["coretrain"]["digests"] != one["nccl"]["digests"]:
        raise AssertionError("15.2: CoreTrain's steps on the NCCL group differ from the DP step's")

    # 15.1, 15.3, 15.4: world size 2 over gloo, both ranks on this card
    t0 = time.perf_counter()
    ranks = spawn_ranks("dp2", 2, "gloo", tmp, shard_dir)
    spawn_s = time.perf_counter() - t0
    r0, r1 = ranks
    labels = dp_batch()["label"]
    valid = [(labels[i * DP_BATCH // 2:(i + 1) * DP_BATCH // 2] != 255).sum() for i in (0, 1)]
    log(f"-- 15.1: ResNet-50 os16 + ASPP(256), global batch {DP_BATCH} over 2 ranks on one "
        f"card (gloo), fp32 (TF32 off), ignore shares {DP_IGNORE} of the two halves "
        f"({valid[0]} and {valid[1]} valid pixels): DP losses {r0['losses']} (rank 1 "
        f"{r1['losses']}), world size 1 {ref_losses} (two-pass BatchNorm "
        f"{one_losses['two-pass']})")
    if r0["losses"] != r1["losses"] or r0["digests"] != r1["digests"]:
        raise AssertionError("15.1: the two ranks' losses or states differ after a step: "
                             f"{r0['digests']} vs {r1['digests']}")
    for variance, losses in one_losses.items():
        if not np.isclose(r0["losses"][0], losses[0], rtol=1e-5, atol=0):
            raise AssertionError(f"15.1: first DP loss {r0['losses'][0]} vs {losses[0]} "
                                 f"({variance} BatchNorm)")
    def load(name):
        with open(os.path.join(tmp, name), "rb") as f:
            return pickle.load(f)

    for k in sorted(ref_states):
        err, worst = max_rel(load(f"dp_state_{k}.pkl"), ref_states[k])
        faults = {name: max_rel(load(f"dp_{name}_{k}.pkl"), ref_states[k])[0]
                  for name in DP_FAULTS}
        plain = max_rel(load(f"dp_state_{k}.pkl"), one_states["two-pass"][k])[0]
        log(f"15.1: after step {k} the DP params and BN statistics lie within {err:.3g} of max "
            f"|value| of world size 1's with SyncBN's arithmetic (worst: {worst}), bound "
            f"{DP_STATE_RTOL[k]:g}; with a fault planted: "
            + ", ".join(f"{n} {v:.3g}" for n, v in faults.items())
            + f"; DP against world size 1's two-pass BatchNorm {plain:.3g}")
        if err > DP_STATE_RTOL[k]:
            raise AssertionError(f"15.1: DP state {err:.3g} off world size 1's after step {k} "
                                 f"({worst}), above {DP_STATE_RTOL[k]:g}")
        missed = [n for n, v in faults.items() if v <= DP_STATE_RTOL[k]]
        if k == 1 and missed:
            raise AssertionError(f"15.1: planted faults {missed} stayed within the step-1 bound "
                                 f"{DP_STATE_RTOL[1]:g}: {faults}")
    log("15.1: the two ranks' states equal bit for bit after every step")
    for r in ranks:
        for i, got in enumerate(r["launches"]):
            if got != {"fwd": 1, "bwd": 1}:
                raise AssertionError(f"15.1: rank {r['rank']} step {i + 1} launched {got} "
                                     "loss kernels, not 1 + 1")
    log(f"15.1: bf16, {DP_STEPS} timed steps: {r0['bf16_ms']:.2f} ms/step at batch "
        f"{DP_BATCH // 2} a rank, TWO PROCESSES SHARING ONE CARD over gloo (host-staged "
        f"all-reduces): not a scaling number ({card})")

    log(f"15.1: a mean of the two halves' own mean losses would be {halves_mean:.6f} "
        f"against the global loss {ref_losses[0]:.6f} at step 1 (gap "
        f"{halves_mean - ref_losses[0]:+.6f}): the ranks' losses are scaled to the global "
        "valid-pixel count")

    # 15.3
    log(f"-- 15.3: resident dataset with mesh=: rank 0 {r0['resident']}, rank 1 "
        f"{r1['resident']}; first fp32 resident step loss {r0['resident_loss']:.7f} (rank 1 "
        f"{r1['resident_loss']:.7f}) vs world size 1 {ref_resident:.7f}")
    half = SYS_SAMPLES // 2
    if r0["resident"]["rows"] != half or r1["resident"]["row_start"] != half:
        raise AssertionError("15.3: the ranks do not hold one half of the shards each")
    if not np.isclose(r0["resident_loss"], ref_resident, rtol=1e-5, atol=0):
        raise AssertionError(f"15.3: resident DP loss {r0['resident_loss']} vs {ref_resident}")

    # 15.4
    got_logits = np.concatenate([r0["eval_logits"], r1["eval_logits"]])
    diff = float(np.abs(got_logits - ref_logits).max())
    top2 = np.sort(ref_logits, axis=-1)
    gap = float((top2[..., -1] - top2[..., -2])[eval_batch()["label"] != 255].min())
    log(f"-- 15.4: sharded evaluate: logits within {diff:.3g} of world size 1's, least "
        f"top-two gap {gap:.3g}; confusion matrices equal: "
        f"{bool(np.array_equal(r0['cm'], ref_metric.total_cm))}")
    if diff < gap:
        for r in ranks:
            if not np.array_equal(r["cm"], ref_metric.total_cm):
                raise AssertionError("15.4: sharded evaluate's confusion matrix differs")
    elif not np.array_equal(np.argmax(got_logits, -1), np.argmax(ref_logits, -1)):
        raise AssertionError("15.4: logits moved past a near-tie: argmax differs")
    window = np.load(os.path.join(tmp, "window.npy"))
    werr = float(np.abs(window - ref_window).max()) / float(np.abs(ref_window).max())
    log(f"15.4: sharded sliding window on 1x1024x2048 (512x512 windows, stride 2/3, 9 a "
        f"rank): {werr:.3g} of max |logit| from the unsharded window, {r0['window_s']:.2f} s "
        f"on two processes sharing the card ({card})")
    if werr > 1e-5:
        raise AssertionError(f"15.4: sharded window {werr:.3g} off the unsharded one")
    staged = {k: r0["host_staged"][k] + r1["host_staged"][k] for k in r0["host_staged"]}
    log(f"15: gloo host-staged collectives of CUDA tensors: {staged}; the ranks' spawn and "
        f"work took {spawn_s:.1f} s")
    counts = dict.fromkeys(read_launch_counts(), 0)
    counts["upsample_ce_fwd"] = sum(c["fwd"] for r in ranks for c in r["launches"])
    counts["upsample_ce_bwd"] = sum(c["bwd"] for r in ranks for c in r["launches"])
    return {"dp_train": counts}


# ----------------------------------------------------------------- F1 on the card

def f1_setups(env) -> dict:
    """The paths phase F1 runs twice: {name: (build() -> (state, step), batch,
    classes, context of the runs)}. Swin-L's and MobileNetV2's resizes took
    ``F.interpolate`` before fault F1 was closed; ViT-L's, EVA02-L's and
    MOAT-4's global attention took cuDNN's or FlashAttention's backward,
    which adds in no fixed order, before fault F4 was: they now record
    their gradient through the global-attention kernels. MOAT-4 runs with
    its relative-position bias (``use_pos_emb``), whose gradient the pair's
    bias form forms. ViT-L and MOAT-4 also run in fp32 (TF32 off), on the
    pair's fp32 form. A tree without that route (``--ab``'s older
    one) runs EVA02-L under SDPA's math backend, as it did, and ViT-L and
    MOAT-4 under the default SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from iseg_tpu_torch.nn import attention as attention_module

    kernel_route = hasattr(attention_module, "kernel_attention")

    def sgd_setup(build_model, compute_dtype=env.compute_dtype):
        def build():
            model = build_model()
            tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
            state = create_train_state(model, torch.Generator().manual_seed(0), tx)
            return state, make_train_step(model.build_loss_fn(), compute_dtype, seed=0)

        return build

    def eva():
        model = build_eva_model(env, fused=True)
        model.backbone.patch_dropout.rate = E_PATCH_DROPOUT
        state = create_train_state(model, torch.Generator().manual_seed(0),
                                   eva_optimizer(model, model.backbone))
        return state, make_train_step(model.build_loss_fn(), env.compute_dtype, seed=0)

    def moat():
        return build_zoo_model(env, "moat4", "aspp", Z_CLASSES, use_pos_emb=True)

    plain = contextlib.nullcontext
    eva_context = plain if kernel_route else (lambda: sdpa_kernel(SDPBackend.MATH))
    return {"Swin-L + SemanticFPN": (sgd_setup(lambda: build_swin_model(env, fused=True)),
                                     S_BATCH, S_CLASSES, plain),
            "ViT-L + ASPP": (sgd_setup(lambda: build_vit_model(env, fused=True)), V_BATCH,
                             V_CLASSES, plain),
            f"EVA02-L + ASPP (AdamW, 150 classes, unfused loss, patch dropout "
            f"{E_PATCH_DROPOUT})": (eva, E_BATCH, E_CLASSES, eva_context),
            "MOAT-4 + ASPP (relative-position bias)": (sgd_setup(moat), Z_BATCH, Z_CLASSES,
                                                       plain),
            "ViT-L + ASPP fp32": (sgd_setup(lambda: build_vit_model(env, fused=True),
                                            torch.float32), V_BATCH, V_CLASSES, plain),
            "MOAT-4 + ASPP fp32 (relative-position bias)": (sgd_setup(moat, torch.float32),
                                                            Z_BATCH, Z_CLASSES, plain),
            "MobileNetV2 + SimpleDecoder": (sgd_setup(lambda: build_mbv2_model(env, fused=True)),
                                            M_BATCH, M_CLASSES, plain)}


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms (by its heuristics) and PyTorch's
    deterministic mode, warning of any op without one, as phase 11.2."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def f1_run(build, data, steps: int = F1_STEPS,
           digest: bool = True) -> tuple[str | list[torch.Tensor], list[float], list[float]]:
    """(state digest, losses, ms of each step) of ``steps`` steps from seed 0;
    without ``digest`` a copy of every parameter and BN statistic on the card
    in place of the digest (phase F1 compares two runs there: hashing the
    four large models' states on the host cost the run about 15 s)."""
    state, step = build()
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, parts = step(state, data)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(parts["loss"]))
    end = params_digest(state) if digest else [
        tree[k].detach().clone() for tree in (state.params, state.batch_stats) for k in sorted(tree)]
    del state, step
    torch.cuda.empty_cache()
    return end, losses, ms


# phase F1's paths whose global attention the launch counts hold: ViT-L and
# EVA02-L on the global-attention pair (24 blocks a step, two runs), MOAT-4
# with its relative bias on the pair's bias form (30 blocks a step, two
# runs), ViT-L and MOAT-4 in fp32 on the same forms' fp32 builds; each
# launches no other form and none of the streaming window-attention pair.
# {path name prefix (the longest that matches counts): (paths key, the
# kernels it launches, how often each)}
GLOBAL_PAIR = ("global_attention_fwd", "global_attention_bwd")
GLOBAL_BIAS_PAIR = ("global_attention_fwd_bias", "global_attention_bwd_bias")
GLOBAL_F32_PAIR = ("global_attention_fwd_f32", "global_attention_bwd_f32")
GLOBAL_BIAS_F32_PAIR = ("global_attention_fwd_bias_f32", "global_attention_bwd_bias_f32")
F1_ATTENTION = {
    "ViT-L": ("f1_vit_train", GLOBAL_PAIR, 2 * F1_STEPS * 24),
    "EVA02-L": ("f1_eva_train", GLOBAL_PAIR, 2 * F1_STEPS * 24),
    "MOAT-4": ("f1_moat_bias_train", GLOBAL_BIAS_PAIR, 2 * F1_STEPS * 30),
    "ViT-L + ASPP fp32": ("f1_vit32_train", GLOBAL_F32_PAIR, 2 * F1_STEPS * 24),
    "MOAT-4 + ASPP fp32": ("f1_moat32_bias_train", GLOBAL_BIAS_F32_PAIR, 2 * F1_STEPS * 30),
}
ATTENTION_KERNELS = tuple(f"global_attention_{key}" for key in GA_FORMS) + (
    "window_attention_fwd_stream", "window_attention_bwd_stream")


def phase_f1_repeat(env) -> dict[str, dict[str, int]]:
    """Faults F1 and F4 on the card: two runs of each path from the same
    weights and batch end with the same state bit for bit. Returns the
    launch counts of the paths in ``F1_ATTENTION`` (both runs): ViT-L and
    EVA02-L launch the global-attention pair 24 times a step each way,
    MOAT-4 with its bias the pair's bias form 30 times, the fp32 ViT-L and
    MOAT-4 the same counts of the fp32 forms, and none of them the
    streaming pair or another form."""
    log("== phase F1: fixed-order resizes (interpolation matrices, no F.interpolate) and "
        "global-attention backwards (the global-attention kernels, with MOAT-4's bias their "
        f"bias form; no SDPA): two runs of {F1_STEPS} steps each end equal bit for bit")
    card = card_line()
    paths = {}
    with deterministic_algorithms():
        for name, (build, batch, classes, context) in f1_setups(env).items():
            data = synthetic_batch(env.device, batch, classes)
            reset_launch_counts()
            with context():
                runs = [f1_run(build, data, digest=False) for _ in range(2)]
            counts = read_launch_counts()
            log(f"F1 {name}: losses {runs[0][1]} and {runs[1][1]}; ms per step "
                f"{[round(v, 2) for v in runs[0][2]]} and {[round(v, 2) for v in runs[1][2]]} "
                f"(deterministic algorithms, the first step builds); attention launches "
                f"{ {key: n for key, n in counts.items() if 'attention' in key and n} } ({card})")
            (first, losses_1, _), (second, losses_2, _) = runs
            if (losses_1 != losses_2 or len(first) != len(second)
                    or not all(torch.equal(a, b) for a, b in zip(first, second))):
                raise AssertionError(f"F1: two runs of {name} end in different states")
            prefix = max((p for p in F1_ATTENTION if name.startswith(p)), key=len, default=None)
            if prefix is not None:
                path, kernels, times = F1_ATTENTION[prefix]
                paths[path] = counts
                want = {key: times if key in kernels else 0 for key in ATTENTION_KERNELS}
                if {key: counts[key] for key in ATTENTION_KERNELS} != want:
                    raise AssertionError(f"F1 {name}: attention launches {counts}; expected "
                                         f"{want}")
            del data, runs, first, second
            torch.cuda.empty_cache()
    return paths


def step_loss_ms(path: str, prof: dict) -> dict:
    """The loss kernels' device ms per step in a :func:`profile_steps` result:
    all of them, the backward alone and the forward's two kernels."""
    loss = dict(KERNEL_CLASSES)["upsample + CE kernels"]
    return {f"{path} step loss ms": sum(ms for key, ms in prof["kernels"].items()
                                        if any(n in key for n in loss)),
            f"{path} step uce_bwd ms": sum(ms for key, ms in prof["kernels"].items()
                                           if UCE_BWD_KERNEL in key),
            f"{path} step uce_fwd ms": sum(ms for key, ms in prof["kernels"].items()
                                           if any(n in key for n in UCE_FWD_KERNELS))}


def ab_f1_row() -> dict:
    """``--ab OLD --only f1``: one warm-up and F1_STEPS timed steps of each
    path of phase F1, in its deterministic mode (a tree without the kernel
    route for global attention runs EVA02-L under SDPA's math backend and
    ViT-L and MOAT-4 under the default SDPA: the difference is the cost of
    the exact resume); MOAT-4's step also profiled (device ms and the
    attention kernels' share)."""
    env = common_env_setup(EnvConfig(random_seed=0, mixed_precision=True, device="cuda"))
    row = {}
    classes_of = dict(KERNEL_CLASSES)
    attention = (classes_of["global-attention kernels"] + classes_of["window attention kernels"]
                 + classes_of["global attention (SDPA: flash / memory-efficient)"])
    with deterministic_algorithms():
        for name, (build, batch, classes, context) in f1_setups(env).items():
            data = synthetic_batch(env.device, batch, classes)
            with context():
                digest, _, ms = f1_run(build, data, steps=1 + F1_STEPS)
                row[f"F1 {name} ms/step"] = statistics.median(ms[1:])
                if name.startswith("MOAT-4"):  # its device time and the attention's share
                    state, step = build()
                    state, _ = step(state, data)
                    prof = profile_steps(state, step, data, f"F1 {name} step",
                                         row[f"F1 {name} ms/step"])
                    attn = sum(t for key, t in prof["kernels"].items()
                               if any(n in key for n in attention))
                    row[f"F1 {name} device ms"] = prof["device_ms"]
                    row[f"F1 {name} attention device ms"] = attn
                    row[f"F1 {name} attention share"] = attn / prof["device_ms"]
                    del state, step, prof
                    torch.cuda.empty_cache()
            row[f"F1 {name} state sha256"] = digest
    return row


def ab_wa12_row(device) -> dict:
    """``--ab OLD --only wa12``: fp32 window attention at window 12 (Swin-L-384's
    four stage shapes, shifted, forward and backward, and the forward at D =
    64), SDPA beside it, all by the profiler's device time; then phase 6c's
    fp32 step (2 + 3 steps, profiled): ms/step, device ms, the window
    attention's device ms and share, its launches."""
    reps = dict(reps=10, warmup=2)
    row = {}
    shapes = [(stage, bnw, heads, nw, HEAD_DIM) for stage, bnw, heads, nw in WA12_STAGES]
    stage, bnw, heads, nw, _, d = WA_STREAM_ROWS[0][:6]  # fp32 at window 12, D = 64
    for stage, bnw, heads, nw, d in (*shapes, ("D=64 " + stage, bnw, heads, nw, d)):
        scale = 1.0 / math.sqrt(d)
        q, k, v, dout, bias, mask = wa_inputs(device, bnw, heads, nw, True, torch.float32,
                                              window=12, d=d)
        full_bias = (bias[None] + mask[torch.arange(bnw, device=device) % nw][:, None]).contiguous()
        wa.reset_launch_counts()
        with torch.no_grad():
            row[f"wa_fwd f32 w12 {stage} device ms"] = device_ms(
                lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
            row[f"sdpa_fwd f32 w12 {stage} device ms"] = device_ms(
                lambda _: sdpa(q, k, v, full_bias, None, scale), **reps)
        if d == HEAD_DIM:
            row[f"wa_bwd f32 w12 {stage} device ms"] = wa_backward_ms(
                wa.window_attention, q, k, v, dout, bias, mask, scale, timer=device_ms, **reps)
            row[f"sdpa_bwd f32 w12 {stage} device ms"] = wa_backward_ms(
                sdpa, q, k, v, dout, full_bias, mask, scale, timer=device_ms, **reps)
        row[f"wa f32 w12 {stage} launches"] = {key: n for key, n in wa.LAUNCH_COUNTS.items() if n}
        del q, k, v, dout, bias, mask, full_bias
        torch.cuda.empty_cache()
    env32 = common_env_setup(EnvConfig(random_seed=0, mixed_precision=False, device="cuda"))
    torch.backends.cudnn.benchmark = True
    data = synthetic_batch(device, S_BATCH, S_CLASSES)
    _, state, step_fn = swin_train_setup(env32, "swin_large_384")
    state, _, launches, step_ms = train_steps(state, step_fn, data, S_WARMUP, S_F32_TIMED,
                                              S_BATCH)
    prof = profile_steps(state, step_fn, data, "swin_large_384 + SemanticFPN fp32 train step",
                         step_ms)
    kernels = prof["kernels"].items()
    wa_needles = dict(KERNEL_CLASSES)["window attention kernels"]
    wa_ms = sum(ms for key, ms in kernels if any(n in key for n in wa_needles))
    row.update({"swin384 f32 step ms": step_ms, "swin384 f32 step device ms": prof["device_ms"],
                "swin384 f32 step wa ms": wa_ms,
                "swin384 f32 step wa share": wa_ms / prof["device_ms"],
                "swin384 f32 step wa_fwd ms": sum(ms for key, ms in kernels if "wa_fwd" in key),
                "swin384 f32 step wa_bwd ms": sum(ms for key, ms in kernels
                                                  if "wa_bwd" in key or "dbias_reduce" in key),
                "swin384 f32 peak GiB": torch.cuda.max_memory_allocated() / 2**30,
                "swin384 f32 launches": {key: n for key, n in launches.items()
                                         if key.startswith("window_attention") and n}})
    return row


def ab_vit32_row(device) -> dict:
    """``--ab OLD --only vit32``: fp32 global attention with a gradient at
    phase 2's fp32 rows through ``dot_product_attention`` (the pair's fp32
    form here, the streaming pair in a tree from before it), forward and
    backward by the profiler's device time with the launch counts; then
    phase 12.4's fp32 ViT-L step (2 + 3, then 3 profiled)."""
    from iseg_tpu_torch.nn import attention as attention_module

    reps = dict(reps=10, warmup=2)
    row = {}
    for title, b, heads, t, d, dtype, *with_bias in GA_ROWS:
        if dtype != torch.float32:
            continue
        key = f"{title} [B={b},H={heads},T={t},D={d}] f32"
        qh, kh, vh, douth = ga_inputs(device, b, heads, t, d, dtype)
        q, k, v, dout = (x.permute(0, 2, 1, 3) for x in (qh, kh, vh, douth))
        bias = None
        if with_bias:
            gen = torch.Generator(device=device).manual_seed(1)
            bias = 0.1 * torch.randn((1, heads, t, t), generator=gen, device=device)
        args = (q, k, v) + (() if bias is None else (bias,))

        def attend(qq, kk, vv, bb=None):
            return attention_module.dot_product_attention(qq, kk, vv, bias=bb)

        def setup():
            leaves = [x.detach().requires_grad_(True) for x in args]
            return leaves, attend(*leaves)

        reset_launch_counts()
        with torch.no_grad():  # SDPA here and in the older tree: the serving route
            row[f"sdpa_fwd {key} device ms"] = device_ms(lambda _: attend(*args), **reps)
        row[f"attention_fwd {key} device ms"] = device_ms(lambda _: setup(), **reps)
        row[f"attention_bwd {key} device ms"] = device_ms(
            lambda arg: torch.autograd.grad(arg[1], arg[0], dout), setup=setup, **reps)
        row[f"attention {key} launches"] = {n: c for n, c in read_launch_counts().items() if c}
        del q, k, v, dout, qh, kh, vh, douth, bias, args
        torch.cuda.empty_cache()
    launches, step = vit_f32_steps(device, V_F32_WARMUP, V_F32_TIMED)
    row.update(step)
    row["vit32 launches"] = {n: c for n, c in launches.items() if c}
    return row


def ab_stream_row(device) -> dict:
    """``--ab OLD --only stream``: phase 2's streaming rows (WA_STREAM_ROWS:
    the D = 36 pair, which a tree from before the streaming kernels runs on
    its CUDA-core kernels, and the rows where such a tree raises), forward
    and backward, SDPA beside each, all by the profiler's device time; where
    a tree raises, the row holds what it raised."""
    reps = dict(reps=10, warmup=2)
    row = {}
    for stage, bnw, heads, nw, window, d, dtype, _ in WA_STREAM_ROWS:
        key = f"{stage} N={window * window} D={d} {dtype_name(dtype)}"
        scale = 1.0 / math.sqrt(d)
        q, k, v, dout, bias, mask = wa_inputs(device, bnw, heads, nw, True, dtype, window=window,
                                              d=d)
        full_bias = (bias[None] + mask[torch.arange(bnw, device=device) % nw][:, None])
        full_bias = full_bias.to(dtype).contiguous()
        for which in ("fwd", "bwd"):
            wa.reset_launch_counts()
            try:
                if which == "fwd":
                    with torch.no_grad():
                        row[f"wa_fwd {key} device ms"] = device_ms(
                            lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
                else:
                    row[f"wa_bwd {key} device ms"] = wa_backward_ms(
                        wa.window_attention, q, k, v, dout, bias, mask, scale, timer=device_ms,
                        **reps)
            except (ValueError, RuntimeError) as err:
                row[f"wa_{which} {key} device ms"] = f"raised: {err}"
                log(f"  wa_{which} {key} raised: {err}")
            row[f"wa_{which} {key} launches"] = {n: c for n, c in wa.LAUNCH_COUNTS.items() if c}
        with torch.no_grad():
            row[f"sdpa_fwd {key} device ms"] = device_ms(
                lambda _: sdpa(q, k, v, full_bias, None, scale), **reps)
        row[f"sdpa_bwd {key} device ms"] = wa_backward_ms(
            sdpa, q, k, v, dout, full_bias, mask, scale, timer=device_ms, **reps)
        del q, k, v, dout, bias, mask, full_bias
        torch.cuda.empty_cache()
    return row


def ab_child(only: str | None = None) -> dict:
    """One process of ``--ab``: this file's timings of the package first on
    the path. It uses only what the parent commit's package has too."""
    for key in ("fwd_mma", "bwd_mma", "fwd_tf32x3", "bwd_tf32x3", "fwd_stream", "bwd_stream"):
        wa.LAUNCH_COUNTS.setdefault(key, 0)  # a package from before a route
    if ga is not None:
        for key in GA_FORMS:
            ga.LAUNCH_COUNTS.setdefault(key, 0)
    device = torch.device("cuda")
    _build.load_all([uce.SOURCE, wa.SOURCE, dl.SOURCE, cg.SOURCE]
                    + ([ga.SOURCE] if ga is not None else []))
    row = {"package": str(_build.PACKAGE_DIR)}
    if only == "f1":
        return {**row, **ab_f1_row()}
    if only == "wa12":
        return {**row, **ab_wa12_row(device)}
    if only == "stream":
        return {**row, **ab_stream_row(device)}
    if only == "vit32":
        return {**row, **ab_vit32_row(device)}
    reps = dict(reps=10, warmup=2)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    for stage, bnw, heads, nw, _ in WA_STAGES:
        q, k, v, dout, bias, mask = wa_inputs(device, bnw, heads, nw, True, torch.bfloat16)
        full_bias = (bias[None] + mask[torch.arange(bnw, device=device) % nw][:, None])
        full_bias = full_bias.bfloat16().contiguous()
        wa.reset_launch_counts()
        with torch.no_grad():
            row[f"wa_fwd {stage} ms"] = cuda_median_ms(
                lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
            row[f"wa_fwd {stage} device ms"] = device_ms(
                lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
            row[f"sdpa_fwd {stage} ms"] = cuda_median_ms(
                lambda _: sdpa(q, k, v, full_bias, None, scale), **reps)
            row[f"sdpa_fwd {stage} device ms"] = device_ms(
                lambda _: sdpa(q, k, v, full_bias, None, scale), **reps)
        row[f"wa_fwd {stage} launches"] = {key: wa.LAUNCH_COUNTS[key] for key in ("fwd", "fwd_mma")}
        wa.reset_launch_counts()
        row[f"wa_bwd {stage} ms"] = wa_backward_ms(wa.window_attention, q, k, v, dout, bias,
                                                   mask, scale, **reps)
        row[f"wa_bwd {stage} launches"] = {key: wa.LAUNCH_COUNTS[key] for key in ("bwd", "bwd_mma")}
        row[f"sdpa_bwd {stage} ms"] = wa_backward_ms(sdpa, q, k, v, dout, full_bias, mask, scale,
                                                     **reps)
        # fp32: the split-TF32 kernels here, the CUDA-core ones in a tree from before
        # them; SDPA beside them, all on the profiler's device time
        q, k, v, dout = wa_inputs(device, bnw, heads, nw, True, torch.float32)[:4]
        full_bias = (bias[None] + mask[torch.arange(bnw, device=device) % nw][:, None]).contiguous()
        wa.reset_launch_counts()
        with torch.no_grad():
            row[f"wa_fwd f32 {stage} device ms"] = device_ms(
                lambda _: wa.window_attention(q, k, v, bias, mask, scale), **reps)
            row[f"sdpa_fwd f32 {stage} device ms"] = device_ms(
                lambda _: sdpa(q, k, v, full_bias, None, scale), **reps)
        row[f"wa_bwd f32 {stage} device ms"] = wa_backward_ms(
            wa.window_attention, q, k, v, dout, bias, mask, scale, timer=device_ms, **reps)
        row[f"sdpa_bwd f32 {stage} device ms"] = wa_backward_ms(
            sdpa, q, k, v, dout, full_bias, mask, scale, timer=device_ms, **reps)
        row[f"wa f32 {stage} launches"] = {key: n for key, n in wa.LAUNCH_COUNTS.items() if n}
        torch.cuda.empty_cache()
    for stage, side, channels, groups, _ in DL_STAGES:
        x, off_dy, off_dx, mod, g_out = dl_inputs(device, side, channels, groups, "mixed")
        args = (groups, DL_KERNEL, DL_MAX_OFFSET)

        def grad_setup():
            ins = [t.detach().requires_grad_(True) for t in (x, off_dy, off_dx, mod)]
            return ins, dl.deform_dense_local_flat(*ins, *args)

        def run_grad(arg):
            ins, out = arg
            torch.autograd.grad(out, ins, g_out)

        with torch.no_grad():
            row[f"dl_fwd {stage} ms"] = cuda_median_ms(
                lambda _: dl.deform_dense_local_flat(x, off_dy, off_dx, mod, *args), **reps)
            row[f"dl_fwd {stage} device ms"] = device_ms(
                lambda _: dl.deform_dense_local_flat(x, off_dy, off_dx, mod, *args), **reps)
            row[f"dl_fwd {stage} held ms"] = held_ms(
                lambda _: dl.deform_dense_local_flat(x, off_dy, off_dx, mod, *args), **reps)
        row[f"dl_bwd {stage} ms"] = cuda_median_ms(run_grad, setup=grad_setup, **reps)
        row[f"dl_bwd {stage} device ms"] = device_ms(run_grad, setup=grad_setup, **reps)
        row[f"dl_bwd {stage} held ms"] = held_ms(run_grad, setup=grad_setup, **reps)
        row[f"dl_bwd_maps {stage} device ms"] = kernel_device_ms(
            run_grad, DL_MAPS_KERNEL, setup=grad_setup, **reps)
        torch.cuda.empty_cache()
    # the backward at the radii phase 14's calibration pins (stage 1 at r = 4,
    # stage 2 at r = 6) and at r = 6 on every stage with dense-local blocks
    for stage, side, channels, groups, _ in DL_STAGES[:3]:
        for r in AB_DL_RADII:
            x, off_dy, off_dx, mod, g_out = dl_inputs(device, side, channels, groups, "mixed",
                                                      spread=r + 1)
            args = (groups, DL_KERNEL, r)

            def grad_setup():
                ins = [t.detach().requires_grad_(True) for t in (x, off_dy, off_dx, mod)]
                return ins, dl.deform_dense_local_flat(*ins, *args)

            def run_grad(arg):
                ins, out = arg
                torch.autograd.grad(out, ins, g_out)

            row[f"dl_bwd {stage} r={r} device ms"] = device_ms(run_grad, setup=grad_setup,
                                                               **reps)
            row[f"dl_bwd_x {stage} r={r} device ms"] = kernel_device_ms(
                run_grad, "dl_bwd_x_kernel", setup=grad_setup, **reps)
            torch.cuda.empty_cache()
    for path, n, h, classes in UCE_SHAPES:
        src, labels = uce_inputs(device, n, h, classes)
        pair = unfused_pair(labels)
        with torch.no_grad():
            row[f"uce_fwd {path} ms"] = cuda_median_ms(
                lambda _: uce.upsample_cross_entropy(src, labels), **reps)
            row[f"uce_fwd {path} device ms"] = device_ms(
                lambda _: uce.upsample_cross_entropy(src, labels), **reps)
            row[f"uce_fwd {path} kernel device ms"] = uce_fwd_kernels_ms(
                lambda _: uce.upsample_cross_entropy(src, labels), **reps)
            row[f"unfused pair fwd {path} device ms"] = device_ms(
                lambda _: pair(src, labels), **reps)
        setup = uce_bwd_setup(uce.upsample_cross_entropy, src, labels)
        row[f"uce_bwd {path} ms"] = cuda_median_ms(uce_run_bwd, setup=setup, **reps)
        row[f"uce_bwd {path} device ms"] = device_ms(uce_run_bwd, setup=setup, **reps)
        row[f"uce_bwd {path} kernel device ms"] = kernel_device_ms(
            uce_run_bwd, UCE_BWD_KERNEL, setup=setup, **reps)
        row[f"uce_bwd {path} held ms"] = held_ms(uce_run_bwd, setup=setup, **reps)
        row[f"unfused pair bwd {path} device ms"] = device_ms(
            uce_run_bwd, setup=uce_bwd_setup(pair, src, labels), **reps)
        torch.cuda.empty_cache()
    for name, shape, dtype in CG_SHAPES:
        got = check_cache_gather(device, name, shape, dtype)
        row[f"gather {name} ms"] = got["ms"]
        row[f"index_select {name} ms"] = got["index_select_ms"]
        torch.cuda.empty_cache()
    env = common_env_setup(EnvConfig(random_seed=0, mixed_precision=True, device="cuda"))
    torch.backends.cudnn.benchmark = True
    data = synthetic_batch(device, R_BATCH, R_CLASSES)
    model = build_resnet_model(env, fused=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, _, _, step_ms = train_steps(state, step_fn, data, R_WARMUP, R_TIMED, R_BATCH)
    prof = profile_steps(state, step_fn, data, "ResNet-50 + ASPP train step", step_ms)
    row.update({"resnet step ms": step_ms, "resnet step device ms": prof["device_ms"],
                **step_loss_ms("resnet", prof)})
    del model, state, step_fn, data, prof
    torch.cuda.empty_cache()
    data = synthetic_batch(device, S_BATCH, S_CLASSES)
    _, state, step_fn = swin_train_setup(env)
    state, _, launches, step_ms = train_steps(state, step_fn, data, S_WARMUP, S_TIMED, S_BATCH)
    prof = profile_steps(state, step_fn, data, "Swin-L + SemanticFPN train step", step_ms)
    row.update({"swin step ms": step_ms, "swin step device ms": prof["device_ms"],
                "swin step wa_fwd ms": sum(ms for key, ms in prof["kernels"].items()
                                           if "wa_fwd" in key),
                "swin step wa_bwd ms": sum(ms for key, ms in prof["kernels"].items()
                                           if "wa_bwd" in key or "dbias_reduce" in key),
                "swin launches": {key: launches[key] for key in
                                  ("window_attention_fwd", "window_attention_fwd_mma",
                                   "window_attention_bwd", "window_attention_bwd_mma")}})
    del state, step_fn, prof
    torch.cuda.empty_cache()
    env32 = common_env_setup(EnvConfig(random_seed=0, mixed_precision=False, device="cuda"))
    _, state, step_fn = swin_train_setup(env32)
    state, _, launches, step_ms = train_steps(state, step_fn, data, S_WARMUP, S_F32_TIMED,
                                              S_BATCH)
    prof = profile_steps(state, step_fn, data, "Swin-L + SemanticFPN fp32 train step", step_ms)
    wa_needles = dict(KERNEL_CLASSES)["window attention kernels"]
    wa_ms = sum(ms for key, ms in prof["kernels"].items() if any(n in key for n in wa_needles))
    row.update({"swin f32 step ms": step_ms, "swin f32 step device ms": prof["device_ms"],
                "swin f32 step wa ms": wa_ms, "swin f32 step wa share": wa_ms / prof["device_ms"],
                "swin f32 launches": {key: n for key, n in launches.items()
                                      if key.startswith("window_attention") and n}})
    del state, step_fn, data, prof
    torch.cuda.empty_cache()
    data = synthetic_batch(device, I_BATCH, I_CLASSES)
    model = build_intern_model(env, fused=True)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, _, launches, step_ms = train_steps(state, step_fn, data, I_WARMUP, I_TIMED, I_BATCH)
    prof = profile_steps(state, step_fn, data, "InternImage-T + ASPP train step", step_ms)
    row.update({"intern step ms": step_ms, "intern step device ms": prof["device_ms"],
                "intern step dl_fwd ms": sum(ms for key, ms in prof["kernels"].items()
                                             if "dl_fwd_kernel" in key),
                "intern step dl_bwd ms": sum(ms for key, ms in prof["kernels"].items()
                                             if "dl_bwd_" in key),
                "intern step dl_bwd_x ms": sum(ms for key, ms in prof["kernels"].items()
                                               if "dl_bwd_x" in key),
                "intern step dl_bwd_maps ms": sum(ms for key, ms in prof["kernels"].items()
                                                  if DL_MAPS_KERNEL in key),
                **step_loss_ms("intern", prof),
                "intern launches": {key: launches[key] for key in
                                    ("deform_local_fwd", "deform_local_bwd")}})
    del model, state, step_fn, prof
    torch.cuda.empty_cache()
    # the same step with phase 14's calibrated sampling (random weights: only
    # the radii and the gather stage matter to the time)
    overrides = {f"stage{s}_block{i}": (mode, r if r is not None else 9)
                 for s, ((mode, r), (*_, blocks)) in enumerate(zip(P_EXPECT, DL_STAGES))
                 for i in range(blocks)}
    backbone = get_backbone("intern_image_tiny", dcn_sampling="auto", remat=False,
                            dcn_overrides=overrides)
    model = SegManaged(num_class=I_CLASSES, backbone=backbone,
                       head=ASPP(backbone.out_channels, filters=256),
                       upsample_logits=False, fuse_upsample_loss=True)
    model = model.to(env.device, memory_format=torch.channels_last)
    tx, _ = get_optimizer(param_tree(model), "sgd", learning_rate=0.01, train_steps=1000)
    state = create_train_state(model, env.generator, tx)
    step_fn = make_train_step(model.build_loss_fn(), compute_dtype=env.compute_dtype)
    state, _, launches, step_ms = train_steps(state, step_fn, data, P_WARMUP, P_TIMED, I_BATCH)
    prof = profile_steps(state, step_fn, data, "calibrated InternImage-T + ASPP train step",
                         step_ms)
    row.update({"calibrated intern step ms": step_ms,
                "calibrated intern step device ms": prof["device_ms"],
                "calibrated intern step dl_bwd_x ms": sum(
                    ms for key, ms in prof["kernels"].items() if "dl_bwd_x" in key),
                "calibrated intern step dl ms": sum(
                    ms for key, ms in prof["kernels"].items() if "dl_" in key),
                "calibrated intern launches": {key: launches[key] for key in
                                               ("deform_local_fwd", "deform_local_bwd")}})
    return row


def ab_main(old: str, only: str | None = None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    here = pathlib.Path(__file__).resolve()
    trees = {"old": str(pathlib.Path(old).resolve()), "new": str(here.parent)}
    log(f"nvidia-smi: {card_line()}")
    rows = []
    for which in ("old", "new", "new", "old"):
        log(f"== --ab: {which} tree {trees[which]}")
        proc = subprocess.run([sys.executable, str(here), "--ab-child", trees[which],
                               *(["--only", only] if only else [])],
                              capture_output=True, text=True, timeout=900)
        log(proc.stdout.rstrip())
        if proc.returncode != 0:
            raise RuntimeError(f"--ab process for {trees[which]} failed:\n{proc.stderr[-4000:]}")
        rows.append((which, json.loads(proc.stdout.rstrip().splitlines()[-1])))
    log(card_line())
    print(json.dumps({key: {which: [row[key] for w, row in rows if w == which]
                            for which in ("old", "new")} for key in rows[0][1]}), flush=True)
    return 0


# ------------------------------------------------ phase 16: LM distribution

def lm_prompt(vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """16.1's requests: TP_BATCH random prompts of TP_PROMPT ids (seeded)."""
    rng = np.random.RandomState(16)
    ids = torch.tensor(rng.randint(1, vocab, (TP_BATCH, TP_PROMPT)))
    return ids, torch.full((TP_BATCH,), TP_PROMPT)


def lm_tokens(vocab: int, batch: int, seq: int, seed: int) -> torch.Tensor:
    return torch.tensor(np.random.RandomState(seed).randint(1, vocab, (batch, seq)))


def tp_config():
    return dataclasses.replace(get_preset(TP_PRESET), num_layers=TP_LAYERS)


def seeded_lm(device, config, dtype, mesh=None, **parallel):
    """A Gemma LM on ``device`` with this rank's shard of the seed-16 weights
    (``layout.init_seeded_shard``: every model parallelism the same full
    weights)."""
    from iseg_tpu_torch.nlp.gemma import GemmaCausalLM
    from iseg_tpu_torch.nlp.gemma.layout import init_seeded_shard

    lm = GemmaCausalLM(config, dtype=dtype, param_dtype=dtype, device=device, mesh=mesh,
                       **parallel)
    return init_seeded_shard(lm, 16)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in fp32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def grads_rel(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max |diff| over its max |want|, and that leaf."""
    return max((rel_err(got[k], want[k]), k) for k in want)


def lm_tp(env, out: str) -> dict:
    """16.1 on one rank: ``gemma_7b_en`` at model parallelism 2, a greedy and
    a beam-4 request, timed; the prefill logits for the parent."""
    from iseg_tpu_torch.nlp.gemma import BeamSampler
    from iseg_tpu_torch.parallel.collectives import HOST_STAGED, reset_host_staged
    from iseg_tpu_torch.parallel.mesh import MODEL_AXIS, create_mesh

    mesh = create_mesh(model_parallelism=2)
    cfg = tp_config()
    t0 = time.perf_counter()
    lm = seeded_lm(env.device, cfg, torch.bfloat16, mesh, model_axis=MODEL_AXIS)
    torch.cuda.synchronize()
    res = {"load_s": time.perf_counter() - t0,
           "params": sum(p.numel() for p in lm.parameters()),
           "cache_shape": None}
    prompt, lengths = (a.to(env.device) for a in lm_prompt(cfg.vocab_size))
    with torch.inference_mode():
        logits, _ = lm._prefill(prompt, lengths, lm.build_cache(TP_BATCH, TP_PROMPT))
    res["prefill_logits"] = logits.float().cpu().numpy()
    steps = TP_MAX_LENGTH - TP_PROMPT
    for name, sampler in (("greedy", None), ("beam4", BeamSampler(TP_BEAMS))):
        reset_launch_counts()
        reset_host_staged()
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = lm.generate(prompt, lengths, max_length=TP_MAX_LENGTH, sampler=sampler)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        torch.distributed.barrier()
        rows = TP_BATCH * (TP_BEAMS if sampler is not None else 1)
        res[name] = {"tokens": tokens.cpu().numpy(), "s": dt, "ms_step": 1e3 * dt / steps,
                     "tok_s": TP_BATCH * steps / dt, "rows": rows,
                     "launches": read_launch_counts(), "staged": dict(HOST_STAGED)}
    # the active cache the beam search reorders: [B, nb, L, 2, W, local kv heads, d]
    res["cache_shape"] = (TP_BATCH, TP_BEAMS, cfg.num_layers, 2, TP_MAX_LENGTH - TP_PROMPT,
                          lm.kv_heads, cfg.head_dim)
    del lm
    torch.cuda.empty_cache()
    return res


def lm_reference_in_turn(env, fn):
    """Run ``fn()`` on each rank in turn (the others wait at a barrier of the
    whole group), so only one rank holds a full model's activations at a
    time."""
    out = None
    for r in range(env.world_size):
        if env.rank == r:
            out = fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    return out


def named_grads(lm) -> dict:
    return {n: p.grad for n, p in lm.named_parameters()}


def lm_sp(env) -> dict:
    """16.2 on one rank: ``gemma_2b_en`` bf16 at T = SP_T over a seq axis of 2,
    ``score`` and the loss's gradient in both modes, against world size 1 on
    the same weights without SP (on rank 0), and the fp32 world-size-1 run
    that measures the bf16 run's own noise."""
    from iseg_tpu_torch.parallel import collectives as C
    from iseg_tpu_torch.parallel.mesh import create_mesh

    cfg = dataclasses.replace(get_preset(SP_PRESET), num_layers=SP_LAYERS)
    mesh = create_mesh(model_parallelism=2)
    ids = lm_tokens(cfg.vocab_size, SP_BATCH, SP_T, 17).to(env.device)
    weights = torch.ones(ids.shape, device=env.device)

    def one_process(dtype):
        lm = seeded_lm(env.device, cfg, dtype)
        with torch.no_grad():
            score = lm.score(ids)
        loss = lm.next_token_loss(ids, weights)
        loss.backward()
        out = score, loss.item(), named_grads(lm)
        del lm, loss
        return out

    refs = None
    if env.rank == 0:
        score32, _, grads32 = one_process(torch.float32)
        score16, loss16, grads16 = one_process(torch.bfloat16)
        noise = {"score": rel_err(score16, score32), "grad": grads_rel(grads16, grads32)[0]}
        del grads32
        torch.cuda.empty_cache()
        refs = score16, loss16, grads16, score32, noise
    torch.distributed.barrier()
    res = {}
    for mode in ("allgather", "ring"):
        lm = seeded_lm(env.device, cfg, torch.bfloat16, mesh, seq_axis="model", sp_mode=mode)
        local_ids, local_w = lm.shard_tokens(ids), lm.shard_tokens(weights)
        C.reset_host_staged()
        with torch.no_grad():
            score = lm.score(local_ids)
        calls = dict(C.CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = lm.next_token_loss(local_ids, local_w)
        loss.backward()
        torch.cuda.synchronize()
        fwd_bwd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lm.reduce_gradients()
        torch.cuda.synchronize()
        reduce_s = time.perf_counter() - t0
        # the ranks' slices in rank order (the last one is one shorter)
        padded = F.pad(score, (0, SP_T // 2 - score.shape[1]))
        score_all = C.all_gather(padded.t().contiguous(), lm.parallel.seq_group).t()
        score_all = score_all[:, :SP_T - 1]
        row = {"loss": loss.item(), "calls": calls, "fwd_bwd_s": fwd_bwd_s,
               "grad_reduce_s": reduce_s, "staged": dict(C.HOST_STAGED)}
        if env.rank == 0:
            score16, loss16, grads16, score32, noise = refs
            row["score_err"] = rel_err(score_all, score16)
            row["score_err_f32"] = rel_err(score_all, score32)
            row["grad_err"], row["grad_leaf"] = grads_rel(named_grads(lm), grads16)
            row["ref_loss"], row["noise"] = loss16, noise
        res[mode] = row
        del lm, loss
        torch.cuda.empty_cache()
    del refs
    torch.cuda.empty_cache()
    return res


def flax_params_and_grads(lm) -> tuple[dict, dict]:
    """The model's parameters and their gradients, flat by flax path in the
    flax layout (views, no copy)."""
    from iseg_tpu_torch.convert import _leaves

    leaves = [(path, t, fn) for col, path, t, fn, _ in _leaves(lm)
              if col == "params" and isinstance(t, torch.nn.Parameter)]
    return ({path: fn(t.detach()) for path, t, fn in leaves},
            {path: fn(t.grad) for path, t, fn in leaves})


def lm_pp(env) -> dict:
    """16.3 on one rank: ``gemma_2b_en`` fp32, 2 stages of 9 layers, 4
    microbatches, batch 8 x T 512 (each layer recomputed in the backward):
    the loss, every gradient and one SGD step against one process's on the
    same weights. The one-process run goes on each rank in turn; each keeps
    the leaves it owns (its stage's layers, stacked, and the shared ones),
    which are then its pipeline parameters."""
    from iseg_tpu_torch.nlp.gemma.pipeline import make_pp_loss_fn
    from iseg_tpu_torch.parallel import collectives as C
    from iseg_tpu_torch.parallel.mesh import axis_rank, create_mesh

    cfg = get_preset(SP_PRESET)
    mesh = create_mesh(model_parallelism=2, axis_names=("data", "stage"))
    stage = axis_rank(mesh, "stage")
    lps = cfg.num_layers // 2
    layers = range(stage * lps, (stage + 1) * lps)
    ids = lm_tokens(cfg.vocab_size, PP_BATCH, PP_T, 18).to(env.device)
    weights = torch.tensor(np.random.RandomState(19).rand(PP_BATCH, PP_T) > 0.1,
                           dtype=torch.float32, device=env.device)

    def reference():
        lm = seeded_lm(env.device, cfg, torch.float32)
        loss = lm.next_token_loss(ids, weights)
        loss.backward()
        params, grads = flax_params_and_grads(lm)
        inner = sorted({k.split("/", 1)[1] for k in params if k.startswith("layer_0/")})

        def stacked(tree):
            return {k: torch.stack([tree[f"layer_{i}/{k}"] for i in layers]) for k in inner}

        shared = [k for k in params if not k.startswith("layer_")]
        out = (loss.item(), stacked(params), stacked(grads),
               {k: params[k].clone() for k in shared}, {k: grads[k].clone() for k in shared})
        del lm, loss, params, grads
        return out

    ref_loss, stage_p, stage_g, shared_p, shared_g = lm_reference_in_turn(env, reference)
    from iseg_tpu_torch.convert import unflatten

    mine = unflatten({k: v.requires_grad_() for k, v in stage_p.items()})
    shared = unflatten({k: v.requires_grad_() for k, v in shared_p.items()})
    loss_fn = make_pp_loss_fn(cfg, mesh, num_microbatches=PP_MICRO, remat=True)
    leaves = {**{("stage", k): v for k, v in stage_p.items()},
              **{("shared", k): v for k, v in shared_p.items()}}
    # the train step twice from the same parameters (phase F1's check: both end
    # bit for bit equal), under deterministic_algorithms() as F1's steps
    runs = []
    with deterministic_algorithms():
        for _ in range(2):
            for v in leaves.values():
                v.grad = None
            C.reset_host_staged()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            loss = loss_fn(mine, shared, ids, weights)
            loss.backward()
            torch.cuda.synchronize()
            # on the host: a second set of a stage's gradients does not fit
            # beside the two ranks' steps on the one card
            runs.append((loss.item(), {key: v.grad.cpu() for key, v in leaves.items()
                                       if v.grad is not None}, time.perf_counter() - t0,
                         dict(C.CALLS), dict(C.HOST_STAGED)))
    (loss_1, grads_1, step_s, calls, staged), (loss_2, grads_2, step_2_s, *_) = runs
    repeat_equal = loss_1 == loss_2 and grads_1.keys() == grads_2.keys() and all(
        torch.equal(grads_1[key], grads_2[key]) for key in grads_1)
    del runs, grads_1, grads_2
    got = {**{("stage", k): (v, v.grad) for k, v in stage_p.items()},
           **{("shared", k): (v, v.grad) for k, v in shared_p.items()}}
    want = {**{("stage", k): g for k, g in stage_g.items()},
            **{("shared", k): g for k, g in shared_g.items()}}
    # every leaf the rank holds (its stage's stacked layers and the shared
    # ones) must receive its gradient through the functional_call views
    missing = ["/".join(key) for key, (_, g) in got.items() if g is None]
    worst, worst_leaf, sgd_err = 0.0, "", 0.0
    with torch.no_grad():
        for key, (p, g) in got.items():
            if g is None:
                continue
            err = rel_err(g, want[key])
            if err > worst:
                worst, worst_leaf = err, "/".join(key)
            # one SGD step on each side from the same parameters
            sgd_err = max(sgd_err, rel_err(p - PP_LR * g, p - PP_LR * want[key]))
    return {"stage": stage, "loss": loss_2, "ref_loss": ref_loss, "grad_err": worst,
            "grad_leaf": worst_leaf, "sgd_err": sgd_err,
            "owned_layers": [f"layer_{i}" for i in layers], "leaves": len(got),
            "missing_grads": missing,
            "layer_leaves": tuple(stage_p["attention/query/kernel"].shape),
            "step_s": step_s, "step_2_s": step_2_s, "repeat_equal": repeat_equal,
            "repeat_losses": (loss_1, loss_2), "calls": calls, "staged": staged,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def lm_ep(env) -> dict:
    """16.4 on one rank: the MoE layer at hidden 2048, 8 experts of d_ff 2048,
    k = 2, 4096 tokens, fp32, its experts over 2 ranks, against world size 1
    on the same weights (each rank computes it)."""
    from iseg_tpu_torch.nn.moe import MoEFeedForward, shard_experts
    from iseg_tpu_torch.nn.initializers import initialize
    from iseg_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(model_parallelism=2, axis_names=("data", "expert"))
    kw = dict(k=EP_K, capacity_factor=1.25, device=env.device)
    full = MoEFeedForward(EP_DIM, EP_EXPERTS, EP_FF, **kw)
    initialize(full, torch.Generator(device=env.device).manual_seed(20))
    x = torch.randn(EP_TOKENS, EP_DIM, generator=torch.Generator(device=env.device)
                    .manual_seed(21), device=env.device)

    def run(moe):
        xx = x.clone().requires_grad_()
        y, aux = moe(xx)
        (((y - xx) ** 2).mean() + 0.01 * aux).backward()
        return y.detach(), float(aux), xx.grad, {n: p.grad for n, p in moe.named_parameters()}

    y1, aux1, dx1, g1 = run(full)
    ep = MoEFeedForward(EP_DIM, EP_EXPERTS, EP_FF, expert_axis="expert", mesh=mesh, **kw)
    with torch.no_grad():
        for name, value in shard_experts({n: p for n, p in full.named_parameters()},
                                         mesh, "expert").items():
            getattr(ep, name).copy_(value)
    y2, aux2, dx2, g2 = run(ep)
    lo = ep.first_expert
    want = {"router": g1["router"], "w1": g1["w1"][lo:lo + ep.local_experts],
            "w2": g1["w2"][lo:lo + ep.local_experts]}
    return {"y_err": rel_err(y2, y1), "aux": (aux2, aux1), "dx_err": rel_err(dx2, dx1),
            "grad_err": grads_rel(g2, want), "local_experts": ep.local_experts}


def rank_lm(env, out: str, shard_dir: str) -> dict:
    """Phase 16 on one rank (world size 2, gloo, one card): 16.1-16.4, each
    subphase's seconds."""
    del shard_dir
    res, seconds = {}, {}
    for name, fn in (("tp", lambda: lm_tp(env, out)), ("sp", lambda: lm_sp(env)),
                     ("pp", lambda: lm_pp(env)), ("ep", lambda: lm_ep(env))):
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    res["seconds"] = seconds
    return res


def phase_lm_distributed(env) -> tuple[dict[str, dict[str, int]], dict]:
    """Phase 16: the language-model half of distribution (see the module
    note). Returns the TP beam request's launches (rank 0) and the cache
    gather's row at 16.1's local cache shape."""
    log("== phase 16: tensor-parallel Gemma serving, sequence parallelism (allgather and "
        "ring), the pipeline-parallel loss and expert parallelism, two ranks on this card over "
        "gloo (correctness runs, not scaling numbers)")
    card = card_line()
    t_phase = time.perf_counter()
    cfg = tp_config()
    # 16.1's reference: world size 1, the same seeded weights, one prefill
    t0 = time.perf_counter()
    lm = seeded_lm(env.device, cfg, torch.bfloat16)
    prompt, lengths = (a.to(env.device) for a in lm_prompt(cfg.vocab_size))
    with torch.inference_mode():
        ref_logits, _ = lm._prefill(prompt, lengths, lm.build_cache(TP_BATCH, TP_PROMPT))
    ref_logits = ref_logits.float().cpu()
    n_params = sum(p.numel() for p in lm.parameters())
    del lm
    torch.cuda.empty_cache()
    log(f"16.1 world-size-1 reference: {TP_PRESET} at {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B parameters bf16, seeded and prefilled in "
        f"{time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="iseg_lm_") as tmp:
        ranks = spawn_ranks("lm2", 2, "gloo", tmp, tmp, timeout=LM_TIMEOUT_S)

    # 16.1
    tp = [r["tp"] for r in ranks]
    steps = TP_MAX_LENGTH - TP_PROMPT
    for name in ("greedy", "beam4"):
        if not np.array_equal(tp[0][name]["tokens"], tp[1][name]["tokens"]):
            raise AssertionError(f"16.1 {name}: the two ranks' token streams differ")
        toks = tp[0][name]["tokens"]
        if toks.shape != (TP_BATCH, TP_MAX_LENGTH) or not np.array_equal(
                toks[:, :TP_PROMPT], prompt.cpu().numpy()):
            raise AssertionError(f"16.1 {name}: tokens {toks.shape}, or the prompt was lost")
        want = steps if name == "beam4" else 0
        for r, row in enumerate(tp):
            if row[name]["launches"] != {**dict.fromkeys(row[name]["launches"], 0),
                                         "cache_gather": want}:
                raise AssertionError(f"16.1 {name} rank {r}: launches {row[name]['launches']}, "
                                     f"want {want} cache_gather launches (one a decode step)")
        log(f"16.1 {name}: {TP_BATCH} requests x {steps} tokens ({tp[0][name]['rows']} rows), "
            + "; ".join(f"rank {r} {row[name]['ms_step']:.2f} ms/step {row[name]['tok_s']:.1f} "
                        f"tok/s, host-staged {row[name]['staged']}"
                        for r, row in enumerate(tp))
            + f"; tokens equal on both ranks; cache_gather launches {want} a rank "
            f"(two processes on one card over gloo, not a scaling number; {card})")
    for r, row in enumerate(tp):
        err = rel_err(torch.tensor(row["prefill_logits"]), ref_logits)
        log(f"16.1 rank {r} prefill logits vs world size 1: {err:.3e} of max |logit| "
            f"(bound {TP_LOGIT_RTOL}); shard of {row['params'] / 1e9:.3f} B parameters "
            f"seeded in {row['load_s']:.1f} s")
        if not err <= TP_LOGIT_RTOL:
            raise AssertionError(f"16.1 rank {r}: prefill logits {err:.3e} of max |logit| from "
                                 f"world size 1 (bound {TP_LOGIT_RTOL})")
    cache_shape = tuple(tp[0]["cache_shape"])
    log(f"16.1 the beam reorder's local cache {list(cache_shape)}: the kernel against its "
        "plain version")
    cg_row = check_cache_gather(env.device, "TP rank beam4", cache_shape, torch.bfloat16)

    # 16.2
    sp = ranks[0]["sp"]
    for mode in ("allgather", "ring"):
        row = sp[mode]
        noise = row["noise"]
        log(f"16.2 {mode}: loss {row['loss']:.6f} (world size 1: {row['ref_loss']:.6f}); score "
            f"{row['score_err']:.3e} and gradient {row['grad_err']:.3e} ({row['grad_leaf']}) of "
            f"max |value| from world size 1 bf16 (bounds {SP_SCORE_RTOL}, {SP_GRAD_RTOL}); "
            f"score from fp32: {row['score_err_f32']:.3e} (world size 1 bf16 from fp32: score "
            f"{noise['score']:.3e}, gradient {noise['grad']:.3e}); fwd+bwd {row['fwd_bwd_s']:.2f} "
            f"s, gradient all-reduce {row['grad_reduce_s']:.2f} s; calls {row['calls']}, "
            f"host-staged {row['staged']} ({card})")
        if not (row["score_err"] <= SP_SCORE_RTOL and row["grad_err"] <= SP_GRAD_RTOL):
            raise AssertionError(f"16.2 {mode}: score {row['score_err']:.3e} / gradient "
                                 f"{row['grad_err']:.3e} past the bounds")
        if not math.isclose(row["loss"], row["ref_loss"], rel_tol=SP_SCORE_RTOL):
            raise AssertionError(f"16.2 {mode}: loss {row['loss']} vs {row['ref_loss']}")
    n_layers = SP_LAYERS
    if sp["ring"]["calls"]["ppermute"] != n_layers + 1:  # n - 1 = 1 a layer, + score's shift
        raise AssertionError(f"16.2 ring: {sp['ring']['calls']['ppermute']} rotations in one "
                             f"forward, want {n_layers} (one a layer) + 1")

    # 16.3
    for r, row in enumerate(rr["pp"] for rr in ranks):
        log(f"16.3 stage {row['stage']}: loss {row['loss']:.7f} (one process {row['ref_loss']:.7f});"
            f" worst gradient {row['grad_err']:.3e} of max |grad| ({row['grad_leaf']}), SGD "
            f"step {row['sgd_err']:.3e} (bound {PP_RTOL}); {row['leaves']} leaves, layers "
            f"{row['owned_layers'][0]}..{row['owned_layers'][-1]} (stacked {row['layer_leaves']}); "
            f"fwd+bwd {row['step_s']:.2f} s, peak {row['peak_gib']:.1f} GiB; "
            f"calls {row['calls']}, host-staged {row['staged']} ({card})")
        log(f"F1 (16.3) stage {row['stage']}: two runs of the pipeline-parallel train step "
            f"(deterministic algorithms; {row['step_s']:.2f} s and {row['step_2_s']:.2f} s), "
            f"losses {row['repeat_losses'][0]!r} and {row['repeat_losses'][1]!r}, every gradient "
            f"equal bit for bit: {row['repeat_equal']}")
        if not row["repeat_equal"]:
            raise AssertionError(f"16.3 rank {r}: two runs of the PP step end apart")
        if row["missing_grads"]:
            raise AssertionError(f"16.3 rank {r}: no gradient reached {row['missing_grads']}")
        if not (row["grad_err"] <= PP_RTOL and row["sgd_err"] <= PP_RTOL
                and math.isclose(row["loss"], row["ref_loss"], rel_tol=PP_RTOL)):
            raise AssertionError(f"16.3 rank {r}: past the bound {PP_RTOL}")
        if row["calls"]["ppermute"] != 2 * (PP_MICRO + 2 - 2):
            raise AssertionError(f"16.3 rank {r}: {row['calls']['ppermute']} rotations, want "
                                 f"{PP_MICRO} forward and as many backward")

    # 16.4
    for r, row in enumerate(rr["ep"] for rr in ranks):
        aux_err = abs(row["aux"][0] - row["aux"][1]) / abs(row["aux"][1])
        log(f"16.4 rank {r} ({row['local_experts']} experts): output {row['y_err']:.3e}, input "
            f"gradient {row['dx_err']:.3e}, weight gradients {row['grad_err'][0]:.3e} "
            f"({row['grad_err'][1]}) of max |value| from world size 1, aux {aux_err:.3e} "
            f"(bound {EP_RTOL}; {card})")
        if not max(row["y_err"], row["dx_err"], row["grad_err"][0], aux_err) <= EP_RTOL:
            raise AssertionError(f"16.4 rank {r}: past the bound {EP_RTOL}")

    log("16 subphase seconds (rank 0): " + json.dumps(
        {k: round(v, 1) for k, v in ranks[0]["seconds"].items()})
        + f"; {time.perf_counter() - t_phase:.1f} s in all")
    return {"tp_beam_serve": tp[0]["beam4"]["launches"]}, cg_row


# ------------------------------------------------------------------ phase 17

def resident_bytes(module) -> int:
    """Bytes of the module's parameters and buffers: what stays on the card
    between calls."""
    return sum(t.numel() * t.element_size() for t in (*module.parameters(), *module.buffers()))


def int8_requests(lm, name, prompt, lengths) -> dict[str, dict]:
    """A short warm-up, then one timed greedy and one timed beam-4 request to
    ``Q_MAX_LENGTH`` (launch counts set to 0 just before each and read just
    after, by :func:`gemma_request`)."""
    steps = Q_MAX_LENGTH - G_PROMPT
    rows = {}
    for search, sampler, want in (("greedy", None, 0), ("beam 4", BeamSampler(Q_BEAMS), steps)):
        _, warm, _, _ = gemma_request(lm, f"{name} {search} (warm-up)", prompt, lengths, sampler,
                                      8 if want else 0, timed=False, max_length=G_PROMPT + 8)
        tokens, launches, dt, peak = gemma_request(lm, f"{name} {search}", prompt, lengths,
                                                   sampler, want, max_length=Q_MAX_LENGTH)
        rows[search] = {"tokens": tokens, "launches": launches, "warm_launches": warm,
                        "ms_step": 1e3 * dt / steps, "tok_s": G_BATCH * steps / dt, "peak": peak}
    return rows


def prefill_logits(lm, prompt, lengths) -> torch.Tensor:
    with torch.inference_mode():
        logits, _ = lm._prefill(prompt, lengths, lm.build_cache(*prompt.shape))
    return logits.float()


def int8_product_rows(device, card: str) -> None:
    """``torch._int_mm``'s device time at the decode products' shapes beside
    bf16 ``F.linear`` and beside the whole W8A8 product (row quantize,
    ``_int_mm``, epilogue)."""
    gen = torch.Generator(device=device).manual_seed(3)
    for name, k, n in Q_PRODUCTS:
        w = torch.randn((n, k), generator=gen, device=device).to(torch.bfloat16)
        w_q = torch.randint(-127, 127, (n, k), generator=gen, device=device, dtype=torch.int8)
        w_scale = torch.rand(n, generator=gen, device=device) * 1e-2
        for m in Q_ROWS:
            x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
            x_q = torch.randint(-127, 127, (max(m, quant_module.INT_MM_MIN_ROWS), k),
                                generator=gen, device=device, dtype=torch.int8)
            int_mm = device_ms(lambda _: torch._int_mm(x_q, w_q.t()), reps=5)
            w8a8 = device_ms(lambda _: quant_module.dynamic_int8_dot(x, w_q.t(), w_scale), reps=5)
            linear = device_ms(lambda _: F.linear(x, w), reps=5)
            log(f"17.1 {name} product M={m} (torch._int_mm takes {x_q.shape[0]} rows) K={k} "
                f"N={n}: torch._int_mm {int_mm:.4f} ms, the whole W8A8 product {w8a8:.4f} ms, "
                f"bf16 F.linear {linear:.4f} ms (device time; {card})")
        del w, w_q


def phase_int8_gemma(device) -> dict[str, dict[str, int]]:
    """17.1: int8 serving of phase 10's model, weight-only and W8A8, against
    the bf16 model in the same run (see the module note)."""
    log(f"== phase 17.1: int8 Gemma serve ({G_PRESET} at full width, {G_LAYERS} layers, "
        f"batch {G_BATCH}, prompt {G_PROMPT}, max_length {Q_MAX_LENGTH}), weight-only and W8A8")
    card = card_line()
    cfg = dataclasses.replace(get_preset(G_PRESET), num_layers=G_LAYERS)
    rng = np.random.RandomState(0)
    prompt = torch.tensor(rng.randint(4, cfg.vocab_size, (G_BATCH, G_PROMPT)), device=device)
    lengths = torch.full((G_BATCH,), G_PROMPT, dtype=torch.long, device=device)

    def build():
        return GemmaCausalLM(cfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                             device=device).eval()

    lm = build().init(torch.Generator(device=device).manual_seed(0))
    rows = {"bf16": int8_requests(lm, "bf16", prompt, lengths)}
    resident = {"bf16": resident_bytes(lm)}
    kept = lm.backbone.token_embedding._table_f32
    log(f"17.1 the bf16 model's readout keeps an fp32 copy of the table beside its weights: "
        f"{0 if kept is None else kept.numel() * kept.element_size()} bytes")
    logits = {"bf16": prefill_logits(lm, prompt, lengths)}
    # quantize on the card, both ways, from the model's flax-layout tree
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = flax_tree(lm)["params"]
    trees = {"weight-only": quant_module.quantize_tree(params),
             "W8A8": quant_module.quantize_dense_tree(params)}
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del lm, params
    torch.cuda.empty_cache()
    log(f"17.1 both int8 trees made on the card in {quantize_s:.2f} s")

    models = {}
    for scheme, tree in trees.items():
        models[scheme] = load_flax(build(), {"params": tree})
        torch.cuda.empty_cache()
        resident[scheme] = resident_bytes(models[scheme])
        rows[scheme] = int8_requests(models[scheme], scheme, prompt, lengths)
        logits[scheme] = prefill_logits(models[scheme], prompt, lengths)
    # the weight-only model against the same weights explicitly dequantized
    dense = load_flax(build(), {"params": quant_module.dequantize_tree(trees["weight-only"])})
    dense_tokens, _, _, _ = gemma_request(dense, "bf16, weight-only tree dequantized", prompt,
                                          lengths, None, 0, timed=False, max_length=Q_MAX_LENGTH)
    del dense, trees
    torch.cuda.empty_cache()
    if not torch.equal(dense_tokens, rows["weight-only"]["greedy"]["tokens"]):
        raise AssertionError("17.1 weight-only greedy tokens differ from the explicitly "
                             "dequantized model's")
    log("17.1 weight-only greedy tokens equal those of the same weights dequantized")
    # W8A8's prefill logits against the bf16 run, beside the weight-only noise
    true_dot = quant_module.dynamic_int8_dot

    def reversed_scales(x2, w_q, w_scale):
        return true_dot(x2, w_q, w_scale.flip(0))

    quant_module.dynamic_int8_dot = reversed_scales
    try:
        fault = prefill_logits(models["W8A8"], prompt, lengths)
    finally:
        quant_module.dynamic_int8_dot = true_dot
    err = {k: rel_err(v, logits["bf16"]) for k, v in logits.items() if k != "bf16"}
    err["fault"] = rel_err(fault, logits["bf16"])
    bound = Q_W8A8_NOISE_MULT * err["weight-only"]
    log(f"17.1 prefill logits against the bf16 model's, max |diff| over max |logit| "
        f"{float(logits['bf16'].abs().max()):.4e}: weight-only {err['weight-only']:.3e} (the "
        f"noise), W8A8 {err['W8A8']:.3e}, bound {Q_W8A8_NOISE_MULT:g} x noise = {bound:.3e}; "
        f"planted fault (each product's weight scales applied to the columns in reverse "
        f"order) {err['fault']:.3e} ({card})")
    if not err["W8A8"] <= bound:
        raise AssertionError(f"17.1 W8A8 prefill logits {err['W8A8']:.3e} of max |logit| from "
                             f"bf16, beyond {bound:.3e}")
    if not err["fault"] > bound:
        raise AssertionError(f"17.1 the planted fault lies {err['fault']:.3e} from bf16, "
                             f"within the bound {bound:.3e}: the check cannot tell it apart")
    for scheme, row in rows.items():
        for search, r in row.items():
            log(f"17.1 {scheme} {search}: {r['tok_s']:.1f} tok/s, {r['ms_step']:.3f} ms/step, "
                f"peak memory {r['peak'] / 2**30:.3f} GiB ({r['peak']} bytes); weights resident "
                f"{resident[scheme] / 2**30:.3f} GiB ({resident[scheme]} bytes; {card})")
    del models
    torch.cuda.empty_cache()
    int8_product_rows(device, card)
    keys = rows["bf16"]["greedy"]["launches"]
    return {"gemma_int8_beam_serve": {k: sum(rows[s]["beam 4"][w][k] for s in ("weight-only", "W8A8")
                                              for w in ("launches", "warm_launches"))
                                      for k in keys},
            "gemma_int8_greedy_serve": {k: sum(rows[s]["greedy"]["launches"][k]
                                               for s in ("weight-only", "W8A8")) for k in keys}}


X_CHILD = r"""
import importlib.abc, json, statistics, sys, time, traceback

first_imports = {}


class FirstImport(importlib.abc.MetaPathFinder):
    # records where each module of the package was first imported from
    def find_spec(self, name, path, target=None):
        if name.startswith("iseg_tpu") and name not in first_imports:
            first_imports[name] = [line for line in traceback.format_stack()[:-1]
                                   if "<frozen importlib" not in line]
        return None


sys.meta_path.insert(0, FirstImport())
import numpy as np
import torch
from iseg_tpu_torch.core.export import load_exported
from iseg_tpu_torch.ops.kernels import deform_local as dl
from iseg_tpu_torch.ops.kernels import window_attention as wa

path, images, out, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
t0 = time.perf_counter()
serve = load_exported(path)
res = {"load_s": time.perf_counter() - t0, "launches": {}}
x = torch.tensor(np.load(images), device="cuda")
serve(x)  # the first call: the kernel library's load, cuDNN's first choices
torch.cuda.synchronize()
for b in (1, 2):
    wa.reset_launch_counts()
    dl.reset_launch_counts()
    y = serve(x[:b])
    torch.cuda.synchronize()
    res["launches"][b] = {**{f"window_attention_{k}": v for k, v in wa.LAUNCH_COUNTS.items()},
                          **{f"deform_local_{k}": v for k, v in dl.LAUNCH_COUNTS.items()}}
    np.save(f"{out}/logits_{b}.npy", y.cpu().numpy())
ms = []
for _ in range(reps):
    t0 = time.perf_counter()
    serve(x)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t0))
res["p50_ms"] = statistics.median(ms)
res["modules"] = sorted(m for m in sys.modules if m.startswith("iseg_tpu"))
res["first_imports"] = first_imports
print(json.dumps(res))
"""


def phase_export(env) -> dict[str, dict[str, int]]:
    """17.2: the exported Swin-L serving artifact in a fresh process, then the
    example driver (see the module note)."""
    log(f"== phase 17.2: export Swin-L's widths at depths {X_DEPTHS} + SemanticFPN (scales "
        f"{X_SCALES} + flip, bf16 autocast, batch-polymorphic) and serve it in a process "
        "without model code")
    card = card_line()
    backbone = swin_module.SwinTransformer(embed_dim=192, depths=X_DEPTHS,
                                           num_heads=(6, 12, 24, 48), window_size=7)
    model = SegManaged(num_class=S_CLASSES, backbone=backbone,
                       head=SemanticFPN(backbone.endpoint_channels[-4:], filters=256),
                       upsample_logits=True, fuse_upsample_loss=False)
    model = model.to(env.device, memory_format=torch.channels_last)
    initialize(model, torch.Generator(device=env.device).manual_seed(17))
    model.eval()
    images = torch.tensor(np.random.RandomState(17).rand(X_BATCH, HW, HW, 3).astype(np.float32),
                          device=env.device)
    # the artifact's computation: each flip pair at double batch
    config = SegModelInferenceConfig(scale_rates=X_SCALES, flip=True, flip_in_batch=True)

    def live(x):
        with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16):
            out = model.inference(x, config)
        torch.cuda.synchronize()
        return out

    live_logits = {b: live(images[:b]) for b in (1, 2)}
    live_ms = []
    for _ in range(X_SERVE_REPS):
        t0 = time.perf_counter()
        live(images)
        live_ms.append(1e3 * (time.perf_counter() - t0))
    with tempfile.TemporaryDirectory(prefix="iseg_export_") as tmp:
        artifact = os.path.join(tmp, "swin_large.pt2")
        t0 = time.perf_counter()
        blob = export_inference(model, None, (HW, HW), scale_rates=X_SCALES, flip=True,
                                compute_dtype=torch.bfloat16, path=artifact)
        export_s = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
        np.save(os.path.join(tmp, "images.npy"), images.cpu().numpy())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", X_CHILD, artifact, os.path.join(tmp, "images.npy"), tmp,
             str(X_SERVE_REPS)], capture_output=True, text=True, timeout=X_TIMEOUT_S,
            env={**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).resolve().parent)})
        child_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"17.2 the serving process failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        served = {b: torch.tensor(np.load(os.path.join(tmp, f"logits_{b}.npy")))
                  for b in (1, 2)}
    model_code = [m for m in res["modules"] if m.startswith((
        "iseg_tpu_torch.backbones", "iseg_tpu_torch.nn", "iseg_tpu_torch.convert",
        "iseg_tpu_torch.core.model", "iseg_tpu_torch.core.inference"))]
    if model_code:
        raise AssertionError(f"17.2 the serving process imported model code: {model_code}")
    log(f"17.2 the serving process imported {res['modules']} of the package")
    for name in res["modules"]:
        if not name.startswith(("iseg_tpu_torch.core.export", "iseg_tpu_torch.ops.kernels")):
            where = [" ".join(line.split()) for line in res["first_imports"].get(name, [])[-3:]]
            log(f"17.2   {name} first imported from: {where}")
    calls = len(X_SCALES)  # one forward a scale: each flip pair at double batch
    path_counts = dict.fromkeys(read_launch_counts(), 0)
    for b in (1, 2):
        got = {**dict.fromkeys(read_launch_counts(), 0), **res["launches"][str(b)]}
        expect_launches(f"exported Swin-L serve (batch {b})", got,
                        {"window_attention_fwd_mma": sum(X_DEPTHS) * calls})
        path_counts = {k: path_counts[k] + got[k] for k in path_counts}
        logits, want = served[b], live_logits[b].cpu()
        if tuple(logits.shape) != (b, HW, HW, S_CLASSES) or logits.dtype != torch.float32:
            raise AssertionError(f"17.2 served logits {tuple(logits.shape)} {logits.dtype}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("17.2 served logits are not finite")
        err = rel_err(logits, want)
        log(f"17.2 batch {b}: the artifact's logits lie {err:.3e} of max |logit| "
            f"{float(want.abs().max()):.4e} from the live bf16 serve's (bound {X_ARTIFACT_RTOL})")
        if not err <= X_ARTIFACT_RTOL:
            raise AssertionError(f"17.2 batch {b}: artifact vs live {err:.3e} > {X_ARTIFACT_RTOL}")
    log(f"17.2 export {export_s:.1f} s, artifact {len(blob) / 1e6:.1f} MB, load "
        f"{res['load_s']:.1f} s (the serving process took {child_s:.1f} s in all); serve of "
        f"{X_BATCH} images p50 {res['p50_ms']:.1f} ms from the artifact, "
        f"{statistics.median(live_ms):.1f} ms live ({X_SERVE_REPS} calls each; {card})")

    # the example driver: MobileNetV2 + SimpleDecoder, float and int8 weights
    with tempfile.TemporaryDirectory(prefix="iseg_export_example_") as tmp:
        serve_args = []
        try:
            from PIL import Image

            os.makedirs(os.path.join(tmp, "imgs"))
            for i, (h, w) in enumerate(((375, 500), (480, 360))):
                Image.fromarray(np.random.RandomState(i).randint(0, 256, (h, w, 3), np.uint8)
                                ).save(os.path.join(tmp, "imgs", f"{i}.png"))
            serve_args = ["--input", os.path.join(tmp, "imgs")]
        except ImportError:
            log("17.2 no PIL on this machine: the example serves one zero image")
        sizes = {}
        for int8 in (False, True):
            path = os.path.join(tmp, f"mbv2{'_int8' if int8 else ''}.pt2")
            common = ["--size", str(X_EXAMPLE_SIZE), "--num_class", str(X_EXAMPLE_CLASSES)]
            made = export_serving_example.main(common + ["--out", path]
                                               + (["--int8"] if int8 else []))
            served = export_serving_example.main(common + ["--serve", path] + serve_args)
            if any(shape != (1, X_EXAMPLE_SIZE, X_EXAMPLE_SIZE)
                   for shape in served["shapes"].values()):
                raise AssertionError(f"17.2 example serve shapes {served['shapes']}")
            sizes[int8] = made["bytes"]
            log(f"17.2 example {'int8' if int8 else 'float'}: {made['bytes'] / 1e6:.1f} MB, "
                f"export {made['export_s']:.1f} s, load {served['load_s']:.1f} s, served "
                f"{len(served['shapes'])} image(s) ({card})")
    ratio = sizes[True] / sizes[False]
    log(f"17.2 example int8 artifact / float artifact = {ratio:.3f} (must be < 0.75)")
    if not ratio < 0.75:
        raise AssertionError(f"17.2 the int8 artifact is {ratio:.3f} of the float one")
    return {"swin_export_serve": path_counts}


def phase_int8_export(env) -> dict[str, dict[str, int]]:
    """Phase 17: 17.1 and 17.2, each one's seconds."""
    t0 = time.perf_counter()
    paths = phase_int8_gemma(env.device)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    paths.update(phase_export(env))
    log(f"17 subphase seconds: 17.1 {t1 - t0:.1f}, 17.2 {time.perf_counter() - t1:.1f}")
    return paths


def main(argv: list[str]) -> int:
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    if argv[:1] == ["--ab"] and len(argv) in (2, 4):
        return ab_main(argv[1], only)
    if argv[:1] == ["--ab-child"]:
        print(json.dumps(ab_child(only)), flush=True)
        return 0
    profile = "--profile" in argv
    t_run = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
        log(f"(phase {name} took {seconds[name]:.1f} s; {time.perf_counter() - t_run:.1f} s "
            "since the start)")
        return out

    pending_build = timed("1", phase_device)
    env = common_env_setup(EnvConfig(random_seed=0, mixed_precision=True, device="cuda"))
    # time cuDNN's conv algorithms once for the fixed training shapes; the
    # choice, and so the bf16 sums after step 1, may differ from run to run
    torch.backends.cudnn.benchmark = True
    log(f"env: {env.describe()}")
    device = env.device

    def on_heuristics(fn):
        """``fn`` on cuDNN's heuristic conv algorithms: autotuning took 25-33 s
        a model of these phases, whose few steps time nothing that needs it."""
        def run(*args):
            with cudnn_heuristics():
                return fn(*args)
        return run

    def resnet_phases():
        data = synthetic_batch(device, R_BATCH, R_CLASSES)
        fused_model, init_weights, init_dropout, first_loss, by_path, resnet_ms = \
            phase_resnet_train(env, data)
        serve_model = phase_resnet_unfused(env, data, init_weights, init_dropout, first_loss)
        phase_resnet_serve(env, data, fused_model, serve_model)
        return by_path, resnet_ms

    by_path, resnet_ms = timed("3-5", on_heuristics(resnet_phases))
    paths = {"resnet_train": by_path}
    paths["system_train"] = timed("5b", on_heuristics(phase_system), env, resnet_ms, profile)
    paths.update(timed("5c", on_heuristics(phase_examples), env, profile))
    timed("1b", phase_build_wait, *pending_build)
    kernels = timed("2", phase_kernels, device)

    def swin_phases():
        data = synthetic_batch(device, S_BATCH, S_CLASSES)
        swin_model, train = phase_swin_train(env, data, profile)
        serve = phase_swin_serve(env, data, swin_model)
        del swin_model
        torch.cuda.empty_cache()
        return {"swin_train": train, "swin_serve": serve,
                "swin_train_f32": phase_swin_train_f32(data, profile)}

    paths.update(timed("6-7", swin_phases))
    paths["swin384_train_f32"] = timed(
        "6c", lambda: phase_swin_train_f32(synthetic_batch(device, S_BATCH, S_CLASSES), profile,
                                           "swin_large_384"))
    paths["swin16_train"] = timed(
        "6d", lambda: phase_swin16_train(env, synthetic_batch(device, S_BATCH, S_CLASSES)))

    def intern_phases():
        data = synthetic_batch(device, I_BATCH, I_CLASSES)
        intern_model, train = phase_intern_train(env, data, profile)
        return {"intern_train": train, "intern_serve": phase_intern_serve(env, data, intern_model)}

    paths.update(timed("8-9", intern_phases))
    paths.update(timed("10", phase_gemma_serve, device, profile))
    paths.update(timed("11", on_heuristics(phase_hrnet), env, profile))
    paths.update(timed("12", phase_transformers, env))
    paths.update(timed("13", on_heuristics(phase_zoo), env))
    pretrained_paths, radii_rows = timed("14", phase_pretrained, env)
    paths.update(pretrained_paths)
    paths.update(timed("15", phase_distributed, env))
    paths.update(timed("F1", phase_f1_repeat, env))
    lm_paths, tp_cache_gather_row = timed("16", phase_lm_distributed, env)
    paths.update(lm_paths)
    paths.update(timed("17", phase_int8_export, env))
    log("phase seconds: " + json.dumps({k: round(v, 1) for k, v in seconds.items()})
        + f"; {time.perf_counter() - t_run:.1f} s in all ({card_line()})")

    # 14.5's rows at the calibrated radii join the dense-local entries' shapes
    for k in kernels:
        if k["name"] in ("deform_local_fwd", "deform_local_bwd"):
            k["shapes"].extend(row[k["name"].rsplit("_", 1)[1]] for row in radii_rows)
        if k["name"] == "cache_gather":  # 16.1's local cache on each TP rank
            k["shapes"].append(tp_cache_gather_row)

    # the bf16 window-attention entries count two routes each (tensor cores and
    # CUDA cores), each with its count; the split-TF32 entries one, shared by
    # two kernels each: the N > 64 ones run on phase 6c's path alone, the N <=
    # 64 ones on the others
    routes = {"window_attention_fwd": {"mma": "window_attention_fwd_mma",
                                       "cuda_core": "window_attention_fwd"},
              "window_attention_bwd": {"mma": "window_attention_bwd_mma",
                                       "cuda_core": "window_attention_bwd"},
              "window_attention_fwd_tf32x3_large": {"cuda": "window_attention_fwd_tf32x3"},
              "window_attention_bwd_tf32x3_large": {"cuda": "window_attention_bwd_tf32x3"}}
    window12 = "swin384_train_f32"
    runs_on = {f"window_attention_{d}_tf32x3{large}": (lambda path, large=large:
                                                        (path == window12) == bool(large))
               for d in ("fwd", "bwd") for large in ("", "_large")}
    for k in kernels:
        keys = routes.get(k["name"], {"cuda": k["name"]})
        mine = {path: counts for path, counts in paths.items()
                if runs_on.get(k["name"], lambda _: True)(path)}
        by_route = {r: sum(counts[key] for counts in mine.values()) for r, key in keys.items()}
        if len(keys) > 1:
            k["launches_by_route"] = by_route
        k["launches_by_path"] = {path: sum(counts[key] for key in keys.values())
                                 for path, counts in mine.items()}
        k["launches"] = sum(by_route.values())
    loss_kernels = ("upsample_ce_fwd", "upsample_ce_bwd")
    global_kernels = GLOBAL_PAIR
    on_path = {"resnet_train": loss_kernels,
               "system_train": loss_kernels,
               "mbv2_train": loss_kernels,
               "mbv2_train_seg": loss_kernels,
               "hrnet_train": loss_kernels,
               "hrnet_accum": loss_kernels,
               "hrnet_train_seg": loss_kernels,
               "vit_train": loss_kernels + global_kernels,
               "vit32_train": loss_kernels + GLOBAL_F32_PAIR,
               "eva_train": global_kernels,  # 150 classes: the unfused loss (0 launches)
               "vit_serve": (),
               "eva_serve": (),
               "convnext_fapn_train": loss_kernels,
               "convnext_fapn_sliding": (),  # unfused serve: no kernel (asserted 0 launches)
               "xception_train": loss_kernels,
               **{path: loss_kernels for path, *_ in Z_MODELS},
               "moat_train": loss_kernels + global_kernels,
               "f1_vit_train": loss_kernels + global_kernels,
               "f1_eva_train": global_kernels,
               "f1_moat_bias_train": loss_kernels + GLOBAL_BIAS_PAIR,
               "f1_vit32_train": loss_kernels + GLOBAL_F32_PAIR,
               "f1_moat32_bias_train": loss_kernels + GLOBAL_BIAS_F32_PAIR,
               "swin_train": loss_kernels + ("window_attention_fwd_mma",
                                             "window_attention_bwd_mma"),
               "swin_serve": ("window_attention_fwd_mma",),
               "swin_train_f32": loss_kernels + ("window_attention_fwd_tf32x3",
                                                 "window_attention_bwd_tf32x3"),
               "swin384_train_f32": loss_kernels + ("window_attention_fwd_tf32x3",
                                                    "window_attention_bwd_tf32x3"),
               "swin16_train": loss_kernels + ("window_attention_fwd_stream",
                                               "window_attention_bwd_stream"),
               "intern_train": loss_kernels + ("deform_local_fwd", "deform_local_bwd"),
               "intern_serve": ("deform_local_fwd",),
               "calibrated_intern_train": loss_kernels + ("deform_local_fwd",
                                                          "deform_local_bwd"),
               "calibrated_intern_serve": ("deform_local_fwd",),
               "gemma_beam_serve": ("cache_gather",),
               "tp_beam_serve": ("cache_gather",),
               "gemma_int8_beam_serve": ("cache_gather",),
               "swin_export_serve": ("window_attention_fwd_mma",),
               "dp_train": loss_kernels}
    for path, names in on_path.items():
        for name in names:
            if paths[path][name] <= 0:
                raise AssertionError(f"kernel {name} was never launched on the {path} path")
    # the tensor-core routes only
    for path in ("swin_train", "swin_serve", "swin_train_f32", "swin384_train_f32",
                 "swin16_train", "swin_export_serve"):
        if paths[path]["window_attention_fwd"] or paths[path]["window_attention_bwd"]:
            raise AssertionError(f"the {path} path launched a CUDA-core window-attention kernel")

    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
