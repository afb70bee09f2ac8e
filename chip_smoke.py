#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --flash-ab PATH   # flash fwd/dq/dkv, paged
                                            # attention, int8 GEMM routes:
                                            # PATH's kernels vs ours
    python3 chip_smoke.py --host-ab PATH    # ResNet-50, BERT-large with
                                            # remat, GPT-2 pretraining and
                                            # a decode round: PATH's step
                                            # times vs ours
    python3 chip_smoke.py --adam-ab PATH    # Adam over a GPT-2 and an NMT
                                            # step's tensors: PATH's
                                            # wrapper and kernel vs ours
    python3 chip_smoke.py --accessor-ab PATH
                                            # eager BERT-base steps and
                                            # phase 2's serving, with peak
                                            # memory: PATH's port vs ours
    python3 chip_smoke.py --bert-repeat N [deterministic]
                                            # the tiny BERT LAMB run of
                                            # the card-vs-CPU test, N times
                                            # on each device: what varies
                                            # between runs (`bert_repeat`)

Builds the hand-written CUDA kernels from `mxnet_tpu_torch/csrc`, then:

  1. holds each kernel against its plain PyTorch version on the card at
     the serving shapes, in float32 and bfloat16, and times kernel,
     plain version and the PyTorch library call that computes the same
     function (CUDA events, median of 25 runs, L2 flushed before each);
  2. serves GPT-2 117M (bfloat16, full width, seeded weights) through
     `Server(model, slots=8, pages="on", page_size=16, prefill_chunk=8)`:
     16 requests, prompts of 16-384 tokens, half behind a shared
     128-token prefix, 64 new tokens each, greedy and sampled mixed;
     then a request that fills the 1024-token context beside a peer
     that prefills in the same bucket;
  3. checks, in float32, that pages="on" serves the same greedy tokens
     as pages="off";
  4. runs `GPTForCausalLM.generate` (flash prefill) in bfloat16, and in
     float32 checks its greedy tokens against the pages="off" server's;
  5. times steady decode rounds of the bfloat16 server bare and under
     torch.profiler (device busy time, top kernels);
  6. trains BERT-base (bfloat16, full published widths and depth, seeded
     weights, dropout 0.1) at batch 32 x 512 with 76 masked positions
     through `parallel.ShardedTrainer(model, bert_pretrain_loss, "lamb",
     {"learning_rate": 1e-3, "wd": 0.01})` on a repeated synthetic batch:
     2 warm-up steps, 16 timed steps ended by one host fetch, then one step
     under torch.profiler;
  7. trains a small float32 BERT (dropout 0) 3 LAMB steps on the card and
     the same 3 steps on the CPU (plain versions) from the same weights,
     and holds losses and the final flat master against each other;
  8. pretrains GPT-2 117M (bfloat16, full published widths and depth,
     seeded weights, dropout 0.1, attention dropout 0) at batch 16 x 1024
     through `parallel.ShardedTrainer(model, gpt_lm_loss, "adam",
     {"learning_rate": 1e-3})` on a repeated synthetic batch: 2 warm-up
     steps, 16 timed steps ended by one host fetch, then one step under
     torch.profiler;
  9. trains a small float32 GPT (dropout 0) 3 Adam steps and, from the
     same start, 3 AdamW steps (wd 0.01, clip 1.0) on the card and on the
     CPU, and holds losses and every parameter against each other;
 10. writes phase 8's weights back into its model, quantizes it to int8
     (`contrib.quantization.quantize_block`, calibrated on two training
     batches), serves phase 2's traffic through it and runs `generate`;
     then, on a small float32 GPT, checks that the int8 server's greedy
     tokens equal its `simulate=True` twin's and that a quantized
     forward on the card agrees with the same forward on the CPU;
 11. trains the Switch-FFN mixture-of-experts LM (the JAX package's
     `_dryrun_moe` model: embedding, `h + parallel.moe_apply(h)`, Dense
     head, loss ce + 0.01 aux) at full width, GPT-2's vocabulary of
     50257, d_model 768, d_ff 3072, 8 experts, capacity factor 1.25,
     bfloat16, at batch 16 x 1024 through `parallel.ShardedTrainer(model,
     switch_lm_loss, "adam", {"learning_rate": 1e-3})` on one ep = 1
     mesh: 2 warm-up steps, 16 timed steps ended by one host fetch, then
     one step under torch.profiler; each step launches exactly 2 MoE
     dispatch, 3 MoE combine and one Adam kernel per weight dtype;
 12. trains a small float32 Switch LM 3 Adam steps on the card and on
     the CPU from the same weights: equal routing at every step, losses
     and every parameter within TOL_TRAIN.

 13. trains BERT-large (`bert_large_config(dtype="bfloat16")`: 24 layers
     of 1024 units, 16 heads, per-layer remat, dropout 0.1) at 32 x 512
     with 76 masked positions, LAMB lr 1e-3, wd 0.01, 2 warm-up + 8 timed
     steps and one under torch.profiler (bench.py's `bench_bert_large`),
     then the same with remat off: exactly 48 flash forwards (24 and 24
     recomputed), 24 dq, 24 dkv and one launch of each LAMB pass a step
     with remat, 24 forwards without; peak memory both ways;
 14. trains a float32 bert_large_config at 2 layers of 256 units
     (remat on, dropout 0) 3 LAMB steps on the card and on the CPU;
 15. trains ResNet-50 v1 as bench.py's `bench_resnet50` does
     (`resnet50_v1(classes=1000)`, `initialize()`, `cast("bfloat16")`,
     SoftmaxCrossEntropyLoss, SGD lr 0.1, momentum 0.9, wd 1e-4, 128 x 3 x
     224 x 224): 3 warm-up + 10 timed steps, one profiled, then 5 with the
     convolutions' input NCHW in memory instead of channels-last; no repo
     kernel launches, the first BatchNorm's running statistics move;
 16. trains a float32 ResNet v1 (BottleneckV1, two stages) 3 SGD steps
     with `set_grad_accum(2)` on the card and on the CPU: losses, every
     parameter and running statistic within TOL_TRAIN;
 17. trains Transformer base (`TransformerNMT`'s defaults: 6 + 6 layers
     of 512 units, 2048 hidden, 8 heads, dropout 0.1, a 37,000-token
     vocabulary; built in float32 from seed 0, then `cast("bfloat16")`)
     through MXNet's eager loop (`nd` arrays, `autograd.record()`,
     `label_smoothing_loss`, `loss.backward()`, `gluon.Trainer(...,
     "adam", {lr 1e-3, beta2 0.98, epsilon 1e-9}).step(1)`) on a copy-task
     batch of 64 sources of 16-64 tokens (targets of 65 positions): 2
     warm-up + 16 timed steps, one profiled; exactly 18 flash forwards,
     18 dq, 18 dkv and one Adam launch per weight dtype a step;
 18. decodes 16 sources with phase 17's model greedily and by beam search
     (beam 4) to max_len, each call exactly one encoder pass of flash
     forwards; then
     trains a float32 TransformerNMT (full width and vocabulary, 2 + 2
     layers, dropout 0) 3 eager Adam steps (epsilon 1e-4) on the card and
     on the CPU: losses and parameters within TOL_TRAIN, greedy and
     beam-4 tokens equal, beam 1 equal to greedy;
 19. trains YOLOv3-tiny (`YOLOv3Tiny(20, 416)`: GluonCV's yolo3_tiny on
     VOC's 20 classes; seed 0, `cast("bfloat16")`) through the example's
     eager loop (`yolo_targets`, `autograd.record()`, `yolo_loss`,
     `backward()`, `gluon.Trainer(..., "adam", {lr 1e-3}).step(1)`) at
     batch 64 on one synthetic batch (1-4 boxes an image, padded to 16):
     2 warm-up + 16 timed steps, one profiled; exactly one Adam launch
     per weight dtype a step (its 34 tensors); the loss falls;
 20. decodes a held-out batch with phase 19's model
     (`decode_predictions`: (64, 2,535, 6) rows, exactly one box_nms
     launch), scores it by VOC07 mAP, profiles one decode call, and holds
     the box_nms kernel against its plain version on that call and with
     force_suppress, bit for bit in the keep masks and the output rows,
     on the decode's own top-k path (`max_keep` 100) and without
     `max_keep`, each timed beside the bound of what its inputs need;
 21. trains SSD (`SSD(20)`, 30,120 anchors at 300^2, bf16) through the
     same loop (`multibox_target`, `MultiBoxLoss` with hard negatives
     3:1) at batch 32, then `multibox_detection` of a held-out batch
     (one box_nms launch, profiled once) and the kernel against its
     plain version on its (32, 30,120, 6) rows, with `max_keep` 400
     (`nms_topk`) and without;
 22. trains a float32 YOLOv3-tiny (64^2, 3 classes) and a float32 SSD
     (channels (8, 16)) 3 eager Adam steps on the card and on the CPU:
     losses within 1e-5 relative, parameters and running statistics
     within TOL_TRAIN, detections' class ids and suppressed rows equal.
 23. trains DeepAR at the JAX model's defaults (GluonTS DeepAREstimator's:
     40 cells, 2 layers, dropout 0.1, Gaussian output, context 24,
     horizon 12; float32, seed 0) through the example's eager loop
     (`autograd.record()`, `model.loss`, `backward()`,
     `gluon.Trainer("adam", {lr 5e-3}).step(1)`) on the example's
     synthetic seasonal series at batch 32: 2 warm-up + 40 timed steps,
     one profiled; exactly one Adam launch per weight dtype a step; the
     NLL falls; then `sample_paths` draws 100 paths over the 32 series
     (timed, profiled; no repo kernel) and the CRPS against the held-out
     12 points is finite; then a NegativeBinomialOutput model takes one
     step and one sampling: non-negative integer samples;
 24. trains CRNN at the JAX model's defaults (`CRNN(num_classes=6,
     img_height=8)`, float32) as examples/ocr/train_crnn.py does,
     through `parallel.ShardedTrainer(model, loss_fn, "adam", {lr
     3e-3})` with the example's `loss_fn` (`nd.ctc_loss(...).mean()`):
     400 steps at batch 32 on `make_glyph_batch(32, seed=step)`, exactly
     one Adam launch per weight dtype a step, held-out exact-match of
     128 greedy CTC decodes >= 0.90 (the JAX package's gate), one step
     profiled;
 25. trains a float32 DeepAR (16 cells, 2 layers, dropout 0) and a
     float32 CRNN (channels (8, 16), hidden 16) 3 Adam steps on the card
     and on the CPU: losses and parameters within TOL_TRAIN, CRNN
     decodes equal; the same card runs with TF32 allowed, and a second
     card run, are reported beside them.
 26. serves phase 2's traffic on phase 2's model (rebuilt from seed 0,
     6 of its 12 layers since the script grew past 1,000 s:
     `SERVE_DEPTH`, also in phases 47 and 49) as the reference, then again with deadlines (every fourth request
     at half the reference's median request wall: 504 with a prefix of
     its reference tokens), a `cancel@req:1` fault and a
     `Server.cancel` mid-generation (499, a prefix), one injected
     OSError on a dispatch (retried once, tokens unchanged), every other
     request's tokens equal to the reference; the pool's pages return;
     then a `burst:8@step:3` into a 4-deep queue (4 shed);
 27. walks each rung of the degradation ladder once, dense and paged, at
     a capacity or pool set from the server's own accounting: shrink,
     evict-and-requeue (the replay equals the unloaded tokens), 429 at
     submit; none fired in phase 26's reference run at the card's real
     capacity; prints each bucket's measured execution peak beside a
     real dispatch's;
 28. serves phase 2's requests, all greedy, plus two sampled ones,
     through the plain paged server and speculatively (spec_k 4) with
     the target as its own drafter and with a drafter of distilgpt2's
     published shape (6 layers, random weights): tokens equal the
     plain server's bit for bit, the self drafter accepts above 0.9,
     the paged kernel launches once a layer a token step;
 29. beam search (`generate(num_beams=4, eos=50256, alpha=0.6,
     return_scores=True)`) on 4 prompts of 32 tokens, 32 new: one flash
     prefill, finite scores, beams end at eos;
 30. on float32 gpt_tiny and a 1-layer drafter, card against CPU:
     speculative tokens and draft counts, beam tokens (scores within
     1e-5), and the ladder's verdicts at capacities from each side's
     own accounting;
 36. runs the repo's examples unchanged through `python -m
     mxnet_tpu_torch.run_example`, each in a process of its own:
     train_cifar10.py and gpt/generate.py at their defaults (exactly one
     Adam launch per weight dtype a step, the flash forward launched),
     BERT pretraining (also with --auto-checkpoint-dir), the NMT,
     YOLO, DeepAR and CRNN at small step counts, and
     module_api/train_mnist_module.py at its defaults (it binds with
     context=mx.cpu(), so it launches nothing); then the CIFAR-10
     DataLoader alone (num_workers 0 and 2); lists the examples the
     card cannot run and why;
 37. trains one vision net of each family at its published widths
     (alexnet, vgg16_bn, squeezenet1.1, mobilenet1.0, mobilenetv2_1.0,
     densenet121, resnet50_v2 at 32 x 224^2, inceptionv3 at 32 x 299^2)
     through the example's eager SGD loop, float32, TF32 in cuDNN's
     convolutions: ms a step, images/s, device busy, idle, peak memory;
 38. float32, card against CPU: each zoo family's logits and one SGD
     step, a DataLoader forked after CUDA is initialised (batches equal
     num_workers=0's), every shape op bit for bit;
 39. trains the BERT-base encoder as a Symbol (`bert_symbol`: 12 layers
     of 768, FFN 3,072, 12 heads, vocabulary 30,522, float32, dropout
     0.1 and attention dropout 0.1, the masked-LM head into
     SoftmaxOutput(use_ignore, "valid")) through `mod.Module.fit` with
     Adam at 32 x 128, 20 masked positions a row: 2 warm-up + 16 timed
     steps (each CUDA-synchronised: median, min, max), then one under
     torch.profiler; exactly 12 flash forwards, 12 dq, 12 dkv and one
     Adam launch a step;
 40. carries a `models.bert.BERTModel` of BERT-base width (float32,
     seeded) into the symbol's argument names (`sym_name_map`): the
     symbolic forward (is_train=False) equals the model's hidden states
     within TOL_TRAIN;
 41. `BucketingModule` over lengths {64, 128} of the same encoder: one
     Module per length over one parameter store, Adam, exact launches a
     step;
 42. float32, card against CPU through Module.fit: a symbolic MLP with
     BatchNorm (SGD, then Adam) and a 2-layer symbolic encoder (Adam),
     3 steps: weights within TOL_TRAIN, the checkpoint's symbol file
     equal;
 43. the registry's kernel ops through `sym`: `_contrib_quantized_dense`
     (M = 8 and 512) and `_contrib_box_nms` bound and run, equal bit for
     bit to the same ops through `nd`, each launching its kernel;
 44. eager BERT-base pretraining as GluonNLP's `run_pretraining.py`
     runs it (`eager_bert_phase`): `models.bert.BERTForPretraining` at
     `bert_base_config` (float32, TF32 off, dropout 0.1) with the
     masked-LM and NSP heads, `autograd.record()`, `loss.backward()`,
     `gluon.Trainer(..., "lamb", lr 1e-4, wd 0.01).step(1)` at 32 x 128
     with 20 masked a row: 2 warm-up + 10 timed steps, then one under
     torch.profiler; exactly 12 flash forwards, 12 dq, 12 dkv and one
     launch of each LAMB pass a step (LAMB's eager `update_multi` over
     `FusedLamb`'s flat layout); losses finite and falling; then 2
     steps of a 2-layer float32 BERT (dropout 0) on the card and on the
     CPU from the same weights: losses and parameters within 1e-5;
 45. the optimizers on the card (`eager_optimizers_phase`): each of
     the 17 registered ones takes 3 `update`s through NDArrays on the
     card and on the CPU from the same weight and gradients (weight and
     state within 1e-5 of the largest |CPU value|; SGLD, which draws
     noise, samples around the mode of a
     quadratic as `test_sgld_samples_around_mode` asks); LAMB's eager
     kernel route against its plain version on the card at BERT-base's
     word embedding (30,522 x 768, within TOL_LAMB), timed (device and
     events ms) beside the bound of the update's bytes; `nd.adam_update`
     by name makes one Adam launch and equals `Adam.update` bit for
     bit;
 46. the JAX package's unit-test files of `tests/test_torch_jax_unittests.py`,
     `tests/test_torch_jax_unittests_more.py` and
     `tests/test_torch_jax_unittests_flow.py` (`FILES`), unchanged,
     through `python -m mxnet_tpu_torch.run_example --pytest` with the
     card as the default device, the first harness's each in a process
     of its own, the second's three a process, all at once: each must
     pass the tests it passes on the CPU and fail only the named
     exclusions (the second harness's `ON_CARD` ones too);
 47. the observability layer on the main paths, in one process, off,
     on, off: phase 6's BERT-base `ShardedTrainer` (32 x 512, LAMB) for 8
     steps and phase 2's traffic through `Server(pages="on")`, with
     telemetry, trace (every step sampled, the skew probe every 4th) and
     diagnostics on in the middle run: losses and tokens bit equal and
     launch counts equal, on against off; `trainer_step_seconds` one
     entry a timed step, the TTFT histogram one a request, the request
     and token counters equal to `Server.stats()`, every span once per
     step or round; a telemetry JSONL and the span file written and read
     back, the span file merged by `tools/trace_report.py` into a valid
     chrome trace; ms per step and tokens/s on against off printed;
 48. diagnostics, profiler and inspect on a BERT-base trainer: inspect
     counts the first step (FLOPs within 10% of the step's analytic
     count, attention included; MFU of the timed steps printed);
     `profiler.set_state("run")` ... `dump()` around 2 steps names the
     flash and LAMB kernels as many times as the launch counters say; a
     1 s watchdog over an injected 2.5 s stall writes its stacks and a
     post-mortem; `nan_sentinel` with a NaN loss injected at the run's
     third step raises NonFiniteError and writes a post-mortem with the
     ring tail and the card's memory watermarks;
 49. the operations layer on phase 2's serving, off, on, off: slo
     (every journal written), goodput, guard's heartbeat, check (warn)
     and scope (an ephemeral 127.0.0.1 port) armed in the middle run,
     with telemetry: tokens bit equal and launch counts equal; a journal
     record with a `200 ok` verdict for every request, each TTFT within
     1 ms of the request's, and `serve_ttft_seconds` summing to the
     journal's; no check finding; /statusz lists the live server,
     /metrics parses, `tools/scope_top.py --once` renders the rank;
     `tools/slo_report.py` and `tools/goodput_report.py` read the files;
     a `scope.request_profile` capture around two requests names the
     paged attention kernel; tokens/s on against off printed;
 50. the operations layer on phase 6's BERT-base trainer (8 steps) off
     and on (goodput, check, guard with `sdc_check_every=2`): losses bit
     equal, launches 12 a step of each flash kernel and 1 + 1 LAMB in
     both runs, the last SDC vote clean at step 8, goodput's categories
     {compile, step}; one digest's ms; `tools/goodput_report.py` reads
     the run's files; then `chip_smoke.py --hang-child DIR` trains a
     small net on the CPU under `hang@step:5` with a 2 s step deadline
     and must exit 86 with a `peer_lost` post-mortem naming step 5;
 51. fine-tunes BERT-base for SQuAD (`BERTForQuestionAnswering`, float32,
     32 x 384, valid lengths 192-384, AdamW lr 3e-5 through
     `gluon.Trainer`, 2 + 10 steps, one profiled): `span.weight.grad()`
     equal to torch's gradient of it, a falling loss, 12 flash forwards,
     dq and dkv and the Adam launches a step; the median step and its
     spread, examples/s, peak memory, device time by kernel, idle share;
 52. the QA head (2 layers at BERT-base's widths, 4 x 384) and the
     classifier (4 x 128) card against CPU from the same weights: logits,
     losses and gradients within 1e-5; `BERTClassifier` at BERT-base's
     full width, 32 x 128, 3 steps, its loss without dropout falling;
 53. `nd.contrib`'s foreach, while_loop (one that never runs too) and
     cond with gradients, and `sym.contrib`'s through `Module.fit` and
     `simple_bind` bound on the card, against the CPU (1e-5), no kernel
     launched; a parameter's `data()` and `grad()` on the card,
     `set_data` from numpy, a CPU NDArray and a card NDArray.

Phase 1 also holds the training kernels against their plain versions at
the training shapes: the flash forward with dropout 0.1 (its keep mask
bit for bit), the dq and dkv backward kernels over a grid of dtypes,
masks, causality and dropout, the forward, dq and dkv at GPT-2
pretraining's (16,12,1024,64) causal shape, both LAMB passes at
BERT-base's flat master size, the multi-tensor Adam/AdamW kernel bit
for bit at GPT-2's largest parameter (the 50257 x 768 token embedding,
bfloat16) and a 768-element float32 LayerNorm vector alone, on a hostile
list (sizes 0-4,097 and past a chunk, both dtypes in one call, per-tensor
lr and wd, 700 tensors in two launches) and on the lists of a GPT-2
117M step (148 tensors) and a Transformer-base NMT step (256), each one
launch, timed beside one `torch._fused_adam_` over the same float32
list, and the int8 GEMM at
the four (K, O) shapes of a GPT-2 layer for M = 8 (the decode route),
512 and 1024 (the wgmma route, on the K-major weight and on the
wrapper's own transpose), bit for bit, each route's launch counter
checked, and the MoE dispatch and combine at the Switch
LM's full width (16,384 tokens, 768 wide, 8 experts of capacity 2,560)
on `moe_route`'s routing with capacity drops, bit for bit, and on random
routing with duplicate slots (dispatch within rtol and atol 1e-6), and
the flash forward (dropout 0.1), dq and dkv at BERT-large's
(32,16,512,64) and both LAMB passes at BERT-large's flat master, and
the flash forward, dq and dkv at the Transformer NMT's three attention
shapes (bf16, B 64, H 8, D 64): the encoder's (64,8,64,64) with the
padding bias, the decoder's (64,8,65,64) causal, and cross-attention
(q 65 over k/v 64 positions) with the bias; and the flash forward,
dq and dkv at phase 39's (32,12,128,64) float32 with its padding mask
and dropout 0.1 (`symbolic_bert_shape` in the rows), and at phase 51's
SQuAD fine-tuning shape (32,12,384,64) float32 with a padding mask of
lengths in [192, 384] and dropout 0.1 (`squad_shape`).

The flash rows' library yardsticks are SDPA calls computing the same
function: the causal forward, the forward with dropout_p 0.1 at BERT's
shape (its mask is its own: times only, the dropout-0 time beside it)
and SDPA's backward alone over one kept forward (dq, dk and dv
together). After the build, the script prints the HGMMA (wgmma),
UTMALDG/UTMASTG (TMA) and HMMA (mma.sync) counts of the bf16 flash
forward, dq and dkv kernels from `cuobjdump -sass`, and fails if they do
not run wgmma fed by TMA or if they run mma.sync; likewise int8 wgmma
(IGMMA) fed by TMA and no int8 mma.sync (IMMA) in the int8 GEMM's M > 16
kernel, and bulk copies (UBLKCP) in the paged kernel. Phase 1 holds paged
attention at two shapes: 64-page tables with random positions, and the
steady-decode round's 7-page tables with contexts of 64-104.

Each path runs with the kernels' launch counters set to 0 just before
it and read just after; a kernel of the path that never launched fails
the run. Any failed check raises, and the script exits non-zero. It
needs one CUDA card and the repository around it: without either it
exits with code 2 and prints no result. It imports nothing of JAX.

The last lines of standard output are the card's name and power limit,
one JSON line with the kernels' numbers, and the result line
`{"ok": true, "device": {...}}`.
"""
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances: float32 2e-5 (paged) / 1e-4 (flash: tiles sum in another
# order than one softmax); bfloat16 2e-2, as the JAX package's kernel tests
TOL = {"paged": {"float32": 2e-5, "bfloat16": 2e-2},
       "flash": {"float32": 1e-4, "bfloat16": 2e-2}}
# backward kernels: float32 1e-4; bfloat16 2e-2 of the largest |reference|
# (gradients reach |x| >> 1, where one bf16 ulp is more than 2e-2).
# LAMB: rtol 1e-5 (FMA contraction and another order of the 512-lane row
# sums). Card-vs-CPU training (float32, 3 steps): 1e-4 on losses and on
# the flat master (sums run in other orders on the two devices).
TOL_BWD = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LAMB = 1e-5
TOL_TRAIN = 1e-4
# Adam (w, m and v) and the int8 GEMM: bit for bit (each kernel rounds
# every operation as its plain version does). Card-vs-CPU quantized
# forward: see int8_narrow_phase.
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16 peak
F32_FLOPS = 67e12                  # float32 outside the tensor cores
TF32_FLOPS = 495e12                # dense tensor-core TF32 peak
# float32 products in split TF32 (the float32 flash forward, dq and dkv):
# three TF32 products each, so float32 work at a third of the TF32 rate
SPLIT_TF32_FLOPS = TF32_FLOPS / 3
INT8_OPS = 1979e12                 # dense tensor-core int8 peak
TOL_INT8_FWD = 2e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def time_ms(fn, iters=25, warmup=3):
    """Median CUDA-event time of fn() in ms, L2 flushed before each run."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, iters=20, match=None, attempts=5,
              skip=("fill", "memset"), per_kernel=False):
    """Device time per call of fn from torch.profiler: the summed device
    time of the kernels it launched (only those whose name contains
    `match` when given), L2 flushed before each call and the flush left
    out (with every kernel whose lower-cased name contains a word of
    `skip`; `FLUSH_ONLY` leaves out the flush alone, so a zero-fill of
    fn's own counts). Unlike time_ms it does not count the caller's host
    time, which exceeds the device time of a small kernel (an int8 GEMM
    at M = 8). The profiler can lose kernel records, now and then every
    record of a window: a window whose count of such kernels is not a
    whole multiple of `iters` is profiled again after a pause that grows
    with each attempt, and `attempts` windows without a whole one fail
    the run. With `per_kernel` (fn launches exactly one kernel that
    `match`es) a window that kept at least half of those records gives
    their mean instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        time.sleep(0.5 * attempt)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # one more flush opens the window: the profiler can drop the
            # first kernel record of a window
            flush.zero_()
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        total, launched, skipped, seen = 0.0, 0, 0, []
        for name, us, count in kernel_rows(prof):
            seen.append((name[:60], count))
            low = name.lower()
            if any(word in low for word in skip):
                skipped += count
                continue
            if match is None or match in name:
                total += us
                launched += count
        # the flushes are among the skipped kernels, or they were counted
        if launched and launched % iters == 0 and skipped >= iters:
            return total / 1e3 / iters
        if per_kernel and 2 * launched >= iters:
            return total / 1e3 / launched
    check(False, f"profiler lost kernel records in {attempts} windows "
          f"({launched} kernels for {iters} calls, {skipped} skipped, "
          f"match={match!r}; the last window's kernels: {seen})")


# the L2 flush of time_ms and device_ms: a uint8 zero-fill
FLUSH_ONLY = ("fillfunctor<unsigned char>", "memset")


def kernel_rows(prof):
    """(kernel name, device µs, launches) of a torch.profiler window
    (kernel rows only: an op row's self device time repeats its
    kernels')."""
    from torch.autograd import DeviceType
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and us > 0:
            yield e.key, us, e.count


def kernel_times(prof):
    """{kernel name: device µs} of a torch.profiler window."""
    out = {}
    for key, us, _ in kernel_rows(prof):
        out[key] = out.get(key, 0.0) + us
    return out


def host_profile(prof, per, n_top):
    """(top host ops {name: self CPU ms}, {CUDA runtime call that waits
    for the card: calls}) per `per` repetitions of a torch.profiler
    window: where a step's host time goes, and whether it waits."""
    from torch.autograd import DeviceType
    ops, waits = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        ops[e.key[:60]] = e.self_cpu_time_total / 1e3 / per
        if "Synchronize" in e.key or "cudaMemcpy" in e.key:
            waits[e.key] = e.count / per
    top = sorted(ops.items(), key=lambda kv: kv[1], reverse=True)
    return dict(top[:n_top]), waits


def sass_mix(lib, kernels=("flash_fwd_wgmma_kernel", "dq_wgmma_kernel",
                           "dkv_wgmma_kernel"),
             ops=("HGMMA", "UTMALDG", "UTMASTG", "HMMA")):
    """{kernel symbol: {op: count}} of the SASS that `cuobjdump -sass`
    shows for the kernels of the built library whose names hold one of
    `kernels` (None where the toolkit has no cuobjdump): HGMMA is wgmma,
    UTMALDG / UTMASTG are TMA loads / stores, HMMA is mma.sync. An op
    written with modifiers, "HMMA.TF32", counts the instructions of that
    op that carry each of them ("HMMA.1688.F32.TF32")."""
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    mix, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            cur = name if any(k in name for k in kernels) else None
            if cur:
                mix[cur] = dict.fromkeys(ops, 0)
        elif cur and "*/" in line:
            # "/*0090*/  @P0 HGMMA.64x128x16.F32.BF16 R24, ... ; /* 0x.. */"
            body = line.split("*/", 1)[1].split("/*", 1)[0].split()
            for tok in body[:2]:
                op, *mods = tok.split(".")
                for key in mix[cur]:
                    want, *need = key.split(".")
                    if want == op and all(m in mods for m in need):
                        mix[cur][key] += 1
    return mix


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

# the steady-decode round of phase 5 (8 slots, prompts of 64 tokens and 40
# new ones, pages of 16): tables of 7 pages, contexts of 64-104 positions
PAGED_STEADY = dict(n_pg=7, t_range=(63, 104))


def paged_case(dev, dtype, B=8, H=12, D=64, ps=16, n_pg=64, P=520, seed=0,
               t_range=None):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(B, H, 1, D), dtype=dtype, device=dev)
    kp = torch.tensor(rng.randn(P, H, ps, D), dtype=dtype, device=dev)
    vp = torch.tensor(rng.randn(P, H, ps, D), dtype=dtype, device=dev)
    tables = torch.tensor(rng.randint(0, P, (B, n_pg)), dtype=torch.int32,
                          device=dev)
    lo, hi = t_range or (0, n_pg * ps)
    t = torch.tensor(rng.randint(lo, hi, (B,)), dtype=torch.int32,
                     device=dev)
    return q, kp, vp, tables, t


def paged_bound(case):
    """(bound ms, bound_by, Σ(t+1)) of one paged call: q read and the
    output written once, the K and V rows of positions <= t[b] and the
    page ids of the pages read once."""
    import torch
    q, kp, _, tables, t = case
    B, H, _, D = q.shape
    ps, n_pg = kp.shape[2], tables.shape[1]
    es = q.element_size()
    need = int((t.long() + 1).sum())                  # positions <= t[b]
    pages_read = int(torch.clamp(t.long() // ps + 1, max=n_pg).sum())
    nbytes = (2 * B * H * D * es + 2 * need * H * D * es
              + 4 * (pages_read + B))
    ms, by = bound(nbytes, 4 * need * H * D)
    return ms, by, need


def paged_library(case):
    """One PyTorch call's worth of the same function: the gather and
    SDPA with the position mask (the library yardstick)."""
    import torch
    import torch.nn.functional as tF
    q, kp, vp, tables, t = case
    B, H, _, D = q.shape
    L = tables.shape[1] * kp.shape[2]
    mask = torch.arange(L, device=q.device)[None, None, None, :] \
        <= t.long()[:, None, None, None]
    idx = tables.long()

    def library():
        kc = kp[idx].permute(0, 2, 1, 3, 4).reshape(B, H, L, D)
        vc = vp[idx].permute(0, 2, 1, 3, 4).reshape(B, H, L, D)
        return tF.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)

    return library


def paged_phase(dev, timed=True, **shape):
    """The paged kernel against its plain version in float32 and bf16 at
    phase 1's shape (64-page tables, random t) and at the steady-decode
    round's (7 pages, contexts 64-104); bf16 timed at both."""
    import torch
    from mxnet_tpu_torch.cuda_ops import paged_attention as pa
    errs, cases = {}, {}
    for where, extra in (("phase1", {}), ("steady", PAGED_STEADY)):
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            case = paged_case(dev, dtype, **{**shape, **extra})
            got = pa.paged_attention(*case)
            ref = pa.paged_attention_reference(*case)
            errs[where, name] = err = max_err(got, ref)
            check(err <= TOL["paged"][name],
                  f"paged_attention {where} {name} max_abs_err {err}")
        cases[where] = case                           # bfloat16
    out = {"name": "paged_attention", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
           "replaces": "mxnet_tpu/pallas_ops/paged_attention.py:69",
           "max_abs_err": errs["phase1", "bfloat16"],
           "max_abs_err_f32": errs["phase1", "float32"]}
    for where, case in cases.items():
        q, kp, vp, tables, t = case
        b_ms, b_by, need = paged_bound(case)
        row = {"bound_ms": b_ms, "bound_by": b_by,
               "shapes": f"q {tuple(q.shape)} bf16, pages "
                         f"{tuple(kp.shape)}, tables {tuple(tables.shape)}, "
                         f"random t (sum t+1 = {need})"}
        if timed:
            library = paged_library(case)
            lib_err = max_err(library(), pa.paged_attention_reference(*case))
            check(lib_err <= TOL["paged"]["bfloat16"],
                  f"paged library yardstick disagrees ({lib_err})")

            def kernel(case=case):
                return pa.paged_attention(*case)

            row.update(ms=device_ms(kernel, match="paged_attention"),
                       event_ms=time_ms(kernel),
                       plain_ms=time_ms(lambda case=case:
                                        pa.paged_attention_reference(*case)),
                       library_ms=time_ms(library),
                       library_device_ms=device_ms(library, skip=FLUSH_ONLY))
        if where == "phase1":
            out.update(row)
        else:
            out["steady_decode"] = dict(
                row, max_abs_err=errs[where, "bfloat16"],
                max_abs_err_f32=errs[where, "float32"])
    if timed:
        out["times_are"] = ("ms: device time of the kernel (torch.profiler, "
                            "L2 flushed); event_ms: CUDA events around the "
                            "wrapper call, host time included; plain_ms "
                            "and library_ms: CUDA events; "
                            "library_device_ms: device time of every kernel "
                            "of the library call")
    return out


def flash_cases(dev, dtype, B=8, H=12, D=64, seed=0):
    """(name, q, k, v, bias, causal) at the serving widths: L=512 causal,
    L=300 with a padding mask, and Lq < Lk causal."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)

    def qkv(Lq, Lk):
        return [torch.tensor(rng.randn(B, H, L_, D), dtype=dtype, device=dev)
                for L_ in (Lq, Lk, Lk)]

    cases = []
    q, k, v = qkv(512, 512)
    cases.append(("causal_512", q, k, v,
                  torch.zeros((B, 512), device=dev), True))
    q, k, v = qkv(300, 300)
    bias = torch.zeros((B, 300), device=dev)
    for b in range(1, B):                             # row b keeps 300-37b
        bias[b, 300 - 37 * b:] = -1e30
    cases.append(("masked_300", q, k, v, bias, False))
    q, k, v = qkv(128, 512)
    cases.append(("causal_128x512", q, k, v,
                  torch.zeros((B, 512), device=dev), True))
    return cases


def flash_phase(dev, timed=True, **shape):
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    errs = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        worst = 0.0
        for case, q, k, v, bias, causal in flash_cases(dev, dtype, **shape):
            o, lse = fa.flash_fwd(q, k, v, bias, causal)
            ro, rlse = fa.flash_fwd_reference(q, k, v, bias, causal)
            e = max(max_err(o, ro), max_err(lse, rlse))
            check(e <= TOL["flash"][name],
                  f"flash {case} {name} max_abs_err {e}")
            worst = max(worst, e)
        errs[name] = worst
    _, q, k, v, bias, causal = flash_cases(dev, torch.bfloat16, **shape)[0]
    B, H, L, D = q.shape
    pairs = B * H * L * (L + 1) // 2                  # causal (q, k) pairs
    flops = 4 * pairs * D
    nbytes = 4 * B * H * L * D * q.element_size() + 4 * B * H * L + 4 * B * L
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    out = {"name": "flash_attention_fwd", "route": "cuda",
           "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
           "replaces": "mxnet_tpu/pallas_ops/flash_attention.py:148",
           "max_abs_err": errs["bfloat16"],
           "max_abs_err_f32": errs["float32"],
           "bound_ms": bound,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
           >= flops / BF16_FLOPS else "operations",
           "shapes": f"q/k/v ({B},{H},{L},{D}) bf16 causal (errors also "
                     "at L=300 padded and Lq=128 < Lk=512 causal)"}
    if timed:
        lib_err = max_err(
            tF.scaled_dot_product_attention(q, k, v, is_causal=True),
            fa.flash_fwd_reference(q, k, v, bias, True)[0])
        check(lib_err <= TOL["flash"]["bfloat16"],
              f"flash library yardstick disagrees ({lib_err})")
        k_ms = time_ms(lambda: fa.flash_fwd(q, k, v, bias, True))

        def library():
            return tF.scaled_dot_product_attention(q, k, v, is_causal=True)

        out.update(ms=k_ms, kernel_ms=k_ms,
                   device_ms=device_ms(lambda: fa.flash_fwd(q, k, v, bias,
                                                            True),
                                       match="mxt::"),
                   plain_ms=time_ms(lambda: fa.flash_fwd_reference(
                       q, k, v, bias, True)),
                   library_ms=time_ms(library),
                   library_device_ms=device_ms(library, skip=FLUSH_ONLY))
    return out


def bound(nbytes, flops, rate=BF16_FLOPS):
    """(bound ms, what binds) of work moving nbytes and doing `flops`
    operations at peak `rate` (bf16 tensor cores by default)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def train_flash_case(dev, dtype, B, causal=False, padded=False, H=12, L=512,
                     D=64, seed=0):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.tensor(rng.randn(B, H, L, D), dtype=dtype,
                               device=dev) for _ in range(4))
    bias = torch.zeros((B, L), device=dev)
    if padded:
        for b in range(1, B):
            bias[b, L - 37 * b:] = -1e30
    return q, k, v, g, bias


def train_flash_phase(dev, B=32, grid_B=2, p=0.1, seed=0x5EED_1234_ABCD):
    """The flash kernels of the training path against their plain
    versions: the forward with dropout (mask bit for bit, O and LSE), dq
    and dkv over dtype x padding x causal x dropout at (grid_B,12,512,64),
    then the main-path shapes (B,12,512,64) bf16, dropout p, timed."""
    import itertools
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    errs = {"dq": {}, "dkv": {}}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        for padded, causal, drop in itertools.product((False, True),
                                                      (False, True),
                                                      (0.0, p)):
            q, k, v, g, bias = train_flash_case(dev, dtype, grid_B, causal,
                                                padded)
            args = (q, k, v, bias)
            ro, lse = fa.flash_fwd_reference(*args, causal, dropout=drop,
                                             seed=seed)
            delta = (g.float() * ro.float()).sum(-1).reshape(lse.shape)
            bw = args + (g, lse, delta, causal, None, drop, seed)
            ref = fa.flash_bwd_reference(*bw)
            scale = max(float(x.float().abs().max()) for x in ref)
            tol = TOL_BWD[name] * (scale if name == "bfloat16" else 1.0)
            dq = fa.flash_bwd_dq(*bw)
            dk, dv = fa.flash_bwd_dkv(*bw)
            case = f"{name} padded={padded} causal={causal} dropout={drop}"
            e_dq = max_err(dq, ref[0])
            e_dkv = max(max_err(dk, ref[1]), max_err(dv, ref[2]))
            check(e_dq <= tol, f"flash dq {case}: max_abs_err {e_dq} > {tol}")
            check(e_dkv <= tol, f"flash dkv {case}: max_abs_err {e_dkv} > "
                  f"{tol}")
            errs["dq"][name] = max(errs["dq"].get(name, 0.0), e_dq)
            errs["dkv"][name] = max(errs["dkv"].get(name, 0.0), e_dkv)

    q, k, v, g, bias = train_flash_case(dev, torch.bfloat16, B)
    BH, L, D = B * 12, q.shape[2], q.shape[3]
    es = q.element_size()
    mask_k = fa.dropout_mask(seed, BH, L, L, p, dev)
    mask_p = fa.dropout_keep_mask(seed, BH, L, L, p, dev)
    check(torch.equal(mask_k, mask_p), "dropout keep mask: kernel and plain "
          f"version differ at {int((mask_k != mask_p).sum())} elements")
    keep = float(mask_k.float().mean())
    del mask_k, mask_p
    o, lse = fa.flash_fwd(q, k, v, bias, False, dropout=p, seed=seed)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, False, dropout=p,
                                      seed=seed)
    e_fwd = max(max_err(o, ro), max_err(lse, rlse))
    check(e_fwd <= TOL["flash"]["bfloat16"],
          f"flash fwd dropout max_abs_err {e_fwd}")
    delta = (g.float() * ro.float()).sum(-1).reshape(BH, L)
    bw = (q, k, v, bias, g, rlse, delta, False, None, p, seed)
    ref = fa.flash_bwd_reference(*bw)
    scale = max(float(x.float().abs().max()) for x in ref)
    tol = TOL_BWD["bfloat16"] * scale
    e_dq = max_err(fa.flash_bwd_dq(*bw), ref[0])
    dk, dv = fa.flash_bwd_dkv(*bw)
    e_dkv = max(max_err(dk, ref[1]), max_err(dv, ref[2]))
    check(e_dq <= tol and e_dkv <= tol,
          f"flash bwd main shapes: dq {e_dq}, dkv {e_dkv} > {tol}")
    del ref, dk, dv

    shapes = f"q/k/v/dO ({B},12,{L},{D}) bf16, no mask, dropout {p}"
    io = BH * L * D * es
    rows = {}
    f_fwd = 4 * BH * L * L * D
    rows["flash_attention_fwd_dropout"] = dict(
        name="flash_attention_fwd_dropout", route="cuda",
        source="mxnet_tpu_torch/csrc/flash_fwd.cu",
        replaces="mxnet_tpu/pallas_ops/flash_attention.py:148",
        max_abs_err=e_fwd, keep_rate=keep, mask_bit_exact=True,
        shapes=shapes)
    rows["flash_attention_fwd_dropout"]["bound_ms"], \
        rows["flash_attention_fwd_dropout"]["bound_by"] = bound(
            4 * io + 4 * BH * L + 4 * B * L, f_fwd)
    rows["flash_attention_dq"] = dict(
        name="flash_attention_dq", route="cuda",
        source="mxnet_tpu_torch/csrc/flash_bwd.cu",
        replaces="mxnet_tpu/pallas_ops/flash_attention.py:245",
        max_abs_err=e_dq, max_abs_err_f32=errs["dq"]["float32"],
        max_abs_err_bf16_grid=errs["dq"]["bfloat16"], shapes=shapes)
    rows["flash_attention_dq"]["bound_ms"], \
        rows["flash_attention_dq"]["bound_by"] = bound(
            5 * io + 8 * BH * L + 4 * B * L, 6 * BH * L * L * D)
    rows["flash_attention_dkv"] = dict(
        name="flash_attention_dkv", route="cuda",
        source="mxnet_tpu_torch/csrc/flash_bwd.cu",
        replaces="mxnet_tpu/pallas_ops/flash_attention.py:287",
        max_abs_err=e_dkv, max_abs_err_f32=errs["dkv"]["float32"],
        max_abs_err_bf16_grid=errs["dkv"]["bfloat16"], shapes=shapes)
    rows["flash_attention_dkv"]["bound_ms"], \
        rows["flash_attention_dkv"]["bound_by"] = bound(
            6 * io + 8 * BH * L + 4 * B * L, 8 * BH * L * L * D)

    # library yardsticks that compute the same functions: SDPA's forward
    # with dropout p (its mask is its own, so times only; the dropout-0
    # forward beside it) and SDPA's backward alone, over a kept forward
    k_ms = time_ms(lambda: fa.flash_fwd(q, k, v, bias, False, dropout=p,
                                        seed=seed))
    rows["flash_attention_fwd_dropout"].update(
        ms=k_ms, kernel_ms=k_ms,
        plain_ms=time_ms(lambda: fa.flash_fwd_reference(
            q, k, v, bias, False, dropout=p, seed=seed), iters=5),
        library_ms=time_ms(lambda: tF.scaled_dot_product_attention(
            q, k, v, dropout_p=p)),
        library_device_ms=device_ms(lambda: tF.scaled_dot_product_attention(
            q, k, v, dropout_p=p), skip=FLUSH_ONLY),
        library=f"SDPA forward, dropout_p {p} (its own mask: times only)",
        library_ms_dropout0=time_ms(
            lambda: tF.scaled_dot_product_attention(q, k, v)))
    lib_bwd = sdpa_backward_ms(q, k, v, g, dropout_p=p)
    for row, fn, ref_fn in (
            ("flash_attention_dq", fa.flash_bwd_dq, fa.flash_dq_reference),
            ("flash_attention_dkv", fa.flash_bwd_dkv, fa.flash_dkv_reference)):
        k_ms = time_ms(lambda: fn(*bw))
        rows[row].update(
            ms=k_ms, kernel_ms=k_ms,
            plain_ms=time_ms(lambda: ref_fn(*bw), iters=5),
            library_ms=lib_bwd[0], library_device_ms=lib_bwd[1],
            library=f"SDPA backward alone, dropout_p {p} (dq, dk and dv "
                    "together)")
    return rows


def sdpa_backward_ms(q, k, v, g, **kw):
    """(events ms, device ms) of SDPA's backward alone (dq, dk and dv
    together): the gradient of one kept forward output, taken again and
    again with retain_graph=True."""
    import torch
    import torch.nn.functional as tF
    ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = tF.scaled_dot_product_attention(ql, kl, vl, **kw)

    def backward():
        return torch.autograd.grad(out, (ql, kl, vl), g, retain_graph=True)

    return time_ms(backward), device_ms(backward, skip=FLUSH_ONLY)


def gpt_flash_phase(dev, B=16, L=1024, seed=1):
    """The flash kernels at GPT-2 pretraining's shape (phase 8's path):
    (B,12,L,64) bf16, causal, dropout 0, every key valid (16 key tiles and
    the causal tile skip), forward, dq and dkv against their plain
    versions on the same inputs, then timed. Returns {row: extra fields}."""
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    q, k, v, g, bias = train_flash_case(dev, torch.bfloat16, B, L=L,
                                        seed=seed)
    BH, D, es = B * 12, q.shape[3], q.element_size()
    o, lse = fa.flash_fwd(q, k, v, bias, True)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, True)
    e_o, e_lse = max_err(o, ro), max_err(lse, rlse)
    check(max(e_o, e_lse) <= TOL["flash"]["bfloat16"],
          f"flash fwd GPT-2 shape: O {e_o}, LSE {e_lse}")
    del o, lse
    delta = (g.float() * ro.float()).sum(-1).reshape(BH, L)
    bw = (q, k, v, bias, g, rlse, delta, True, None, 0.0, 0)
    ref = fa.flash_bwd_reference(*bw)
    tol = TOL_BWD["bfloat16"] * max(float(x.float().abs().max()) for x in ref)
    e_dq = max_err(fa.flash_bwd_dq(*bw), ref[0])
    dk, dv = fa.flash_bwd_dkv(*bw)
    e_dk, e_dv = max_err(dk, ref[1]), max_err(dv, ref[2])
    check(max(e_dq, e_dk, e_dv) <= tol,
          f"flash bwd GPT-2 shape: dq {e_dq}, dk {e_dk}, dv {e_dv} > {tol}")
    del ro, ref, dk, dv
    io = BH * L * D * es
    pairs = BH * L * (L + 1) // 2                     # causal (q, k) pairs
    shape = f"q/k/v/dO ({B},12,{L},{D}) bf16, causal, dropout 0"
    # the library yardsticks: SDPA causal, its backward alone
    def sdpa():
        return tF.scaled_dot_product_attention(q, k, v, is_causal=True)

    lib_fwd = (time_ms(sdpa), device_ms(sdpa, skip=FLUSH_ONLY),
               "SDPA forward, is_causal")
    lib_bwd = (*sdpa_backward_ms(q, k, v, g, is_causal=True),
               "SDPA backward alone, is_causal (dq, dk and dv together)")
    out = {}
    for row, err, nbytes, flops, fn, lib in (
            ("flash_attention_fwd", max(e_o, e_lse),
             4 * io + 4 * BH * L + 4 * B * L, 4 * pairs * D,
             lambda: fa.flash_fwd(q, k, v, bias, True), lib_fwd),
            ("flash_attention_dq", e_dq, 5 * io + 8 * BH * L + 4 * B * L,
             6 * pairs * D, lambda: fa.flash_bwd_dq(*bw), lib_bwd),
            ("flash_attention_dkv", max(e_dk, e_dv),
             6 * io + 8 * BH * L + 4 * B * L, 8 * pairs * D,
             lambda: fa.flash_bwd_dkv(*bw), lib_bwd)):
        b_ms, b_by = bound(nbytes, flops)
        out[row] = {"gpt2_train_shape": dict(
            shapes=shape, max_abs_err=err, ms=time_ms(fn),
            device_ms=device_ms(fn, match="mxt::"), bound_ms=b_ms,
            bound_by=b_by, library_ms=lib[0], library_device_ms=lib[1],
            library=lib[2])}
    out["flash_attention_dq"]["gpt2_train_shape"]["tol"] = tol
    out["flash_attention_dkv"]["gpt2_train_shape"]["tol"] = tol
    return out


def bert_large_flash_phase(dev, B=32, H=16, L=512, p=0.1,
                           seed=0x5EED_1234_ABCD):
    """The flash kernels at BERT-large's shape (the BERT-large path):
    (B,16,L,64) bf16, no mask, dropout p, forward (its keep mask bit for
    bit), dq and dkv against their plain versions on the same inputs,
    then timed, with SDPA's forward and backward beside them. Returns
    {row: extra fields}."""
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    q, k, v, g, bias = train_flash_case(dev, torch.bfloat16, B, H=H, L=L,
                                        seed=2)
    BH, D, es = B * H, q.shape[3], q.element_size()
    check(torch.equal(fa.dropout_mask(seed, BH, L, L, p, dev),
                      fa.dropout_keep_mask(seed, BH, L, L, p, dev)),
          "dropout keep mask at BERT-large's shape: kernel and plain differ")
    o, lse = fa.flash_fwd(q, k, v, bias, False, dropout=p, seed=seed)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, False, dropout=p,
                                      seed=seed)
    e_fwd = max(max_err(o, ro), max_err(lse, rlse))
    check(e_fwd <= TOL["flash"]["bfloat16"],
          f"flash fwd BERT-large shape: max_abs_err {e_fwd}")
    del o, lse
    delta = (g.float() * ro.float()).sum(-1).reshape(BH, L)
    bw = (q, k, v, bias, g, rlse, delta, False, None, p, seed)
    ref = fa.flash_bwd_reference(*bw)
    tol = TOL_BWD["bfloat16"] * max(float(x.float().abs().max()) for x in ref)
    e_dq = max_err(fa.flash_bwd_dq(*bw), ref[0])
    dk, dv = fa.flash_bwd_dkv(*bw)
    e_dkv = max(max_err(dk, ref[1]), max_err(dv, ref[2]))
    check(max(e_dq, e_dkv) <= tol,
          f"flash bwd BERT-large shape: dq {e_dq}, dkv {e_dkv} > {tol}")
    del ro, ref, dk, dv
    io = BH * L * D * es
    shape = f"q/k/v/dO ({B},{H},{L},{D}) bf16, no mask, dropout {p}"

    def sdpa():
        return tF.scaled_dot_product_attention(q, k, v, dropout_p=p)

    lib_fwd = (time_ms(sdpa), device_ms(sdpa, skip=FLUSH_ONLY),
               f"SDPA forward, dropout_p {p} (its own mask: times only)")
    lib_bwd = (*sdpa_backward_ms(q, k, v, g, dropout_p=p),
               f"SDPA backward alone, dropout_p {p} (dq, dk and dv "
               "together)")
    out = {}
    for row, err, nbytes, flops, fn, plain, lib in (
            ("flash_attention_fwd_dropout", e_fwd,
             4 * io + 4 * BH * L + 4 * B * L, 4 * BH * L * L * D,
             lambda: fa.flash_fwd(q, k, v, bias, False, dropout=p,
                                  seed=seed),
             lambda: fa.flash_fwd_reference(q, k, v, bias, False, dropout=p,
                                            seed=seed), lib_fwd),
            ("flash_attention_dq", e_dq, 5 * io + 8 * BH * L + 4 * B * L,
             6 * BH * L * L * D, lambda: fa.flash_bwd_dq(*bw),
             lambda: fa.flash_dq_reference(*bw), lib_bwd),
            ("flash_attention_dkv", e_dkv, 6 * io + 8 * BH * L + 4 * B * L,
             8 * BH * L * L * D, lambda: fa.flash_bwd_dkv(*bw),
             lambda: fa.flash_dkv_reference(*bw), lib_bwd)):
        b_ms, b_by = bound(nbytes, flops)
        out[row] = {"bert_large_shape": dict(
            shapes=shape, max_abs_err=err, ms=time_ms(fn),
            device_ms=device_ms(fn, match="mxt::"),
            plain_ms=time_ms(plain, iters=3), bound_ms=b_ms, bound_by=b_by,
            library_ms=lib[0], library_device_ms=lib[1], library=lib[2])}
    out["flash_attention_dq"]["bert_large_shape"]["tol"] = tol
    out["flash_attention_dkv"]["bert_large_shape"]["tol"] = tol
    return out


def flash_times(root):
    """Times of the flash forward, dq and dkv, paged attention and the
    int8 GEMM of the checkout at `root` (its `mxnet_tpu_torch`, built
    there) at the main-path shapes: the serving prefill (8,12,512,64)
    causal (forward only), BERT's (32,12,512,64) with dropout 0.1 (and
    without, which shows what the keep bits cost) and GPT-2's
    (16,12,1024,64) causal, bf16; the float32 forward, dq and dkv at
    SQuAD fine-tuning's (32,12,384,64) and the symbolic BERT-base's
    (32,12,128,64), each with its batch's padding mask and dropout 0.1
    (`sym_flash_phase`'s inputs); paged attention at phase 1's shape and
    at the steady-decode round's, bf16; the int8 GEMM at GPT-2's four
    layer shapes for M = 8 (the decode route), 512 and 1024 (the wgmma
    route, and, where the wrapper takes the K-major weight, the same
    without it: `_selft`), with bias, and their sum per M; CUDA events
    and profiler device time, L2 flushed; and the host time of a paged
    and an int8 call and of the pieces such a call is made of."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from mxnet_tpu_torch.cuda_ops import _build
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    check(fa.__file__.startswith(os.path.abspath(root)),
          f"flash_attention imported from {fa.__file__}, not {root}")
    _build.library()
    dev = torch.device("cuda")
    out = {}
    for name, B, L, causal, p in (("serving", 8, 512, True, 0.0),
                                  ("bert", 32, 512, False, 0.1),
                                  ("bert_dropout0", 32, 512, False, 0.0),
                                  ("gpt2", 16, 1024, True, 0.0)):
        q, k, v, g, bias = train_flash_case(dev, torch.bfloat16, B, L=L)
        o, lse = fa.flash_fwd(q, k, v, bias, causal, dropout=p, seed=5)
        delta = (g.float() * o.float()).sum(-1).reshape(lse.shape)
        bw = (q, k, v, bias, g, lse, delta, causal, None, p, 5)
        fns = {"fwd": lambda: fa.flash_fwd(q, k, v, bias, causal, dropout=p,
                                           seed=5)}
        if name != "serving":
            fns["dq"] = lambda: fa.flash_bwd_dq(*bw)
            fns["dkv"] = lambda: fa.flash_bwd_dkv(*bw)
        out[name] = {}
        for kern, fn in fns.items():
            out[name][f"{kern}_ms"] = time_ms(fn)
            out[name][f"{kern}_device_ms"] = device_ms(fn, match="mxt::")
        del q, k, v, g, bias, o, lse, delta, bw
    for name, L in (("squad_f32", 384), ("bert_base_f32", 128)):
        q, k, v, g, _ = train_flash_case(dev, torch.float32, 32, L=L, seed=4)
        valid = torch.tensor(sym_bert_batch(32, L, 4, 100)["valid_mask"],
                             device=dev).bool()
        bias = torch.where(valid, 0.0, fa._NEG).float().contiguous()
        o, lse = fa.flash_fwd(q, k, v, bias, False, dropout=0.1, seed=5)
        delta = (g * o).sum(-1).reshape(lse.shape)
        bw = (q, k, v, bias, g, lse, delta, False, None, 0.1, 5)
        out[name] = {}
        for kern, fn in (("fwd", lambda: fa.flash_fwd(
                             q, k, v, bias, False, dropout=0.1, seed=5)),
                         ("dq", lambda: fa.flash_bwd_dq(*bw)),
                         ("dkv", lambda: fa.flash_bwd_dkv(*bw))):
            out[name][f"{kern}_ms"] = time_ms(fn)
            out[name][f"{kern}_device_ms"] = device_ms(fn, match="mxt::")
        del q, k, v, g, bias, o, lse, delta, bw
    from mxnet_tpu_torch.cuda_ops import int8_matmul as im
    from mxnet_tpu_torch.cuda_ops import paged_attention as pa
    for mod in (im, pa):
        check(mod.__file__.startswith(os.path.abspath(root)),
              f"{mod.__name__} imported from {mod.__file__}, not {root}")
    for name, extra in (("paged_phase1", {}), ("paged_steady", PAGED_STEADY)):
        case = paged_case(dev, torch.bfloat16, **extra)

        def paged(case=case):
            return pa.paged_attention(*case)

        out[name] = {"ms": time_ms(paged),
                     "device_ms": device_ms(paged, match="paged_attention"),
                     "host_us": host_us(paged)}
    # a checkout whose wrapper takes the K-major weight gets it, as
    # QuantizedDense passes it; an older one runs its own M > 16 route
    kmajor = "w_q_k" in inspect.signature(im.int8_matmul).parameters
    for M in INT8_MS:
        for variant in ("", "_selft") if kmajor and M > 16 else ("",):
            row = out[f"int8_m{M}{variant}"] = {"ms": 0.0, "device_ms": 0.0}
            for K, O in GPT2_GEMMS:
                x_q, w_q, s_x, w_s, b = int8_case(dev, M, K, O,
                                                  seed=M + K + O)
                kw = {"w_q_k": w_q.t().contiguous()} \
                    if kmajor and not variant else {}

                def gemm(kw=kw):
                    return im.int8_matmul(x_q, w_q, s_x, w_s, bias=b, **kw)

                # every kernel of the call: a transpose or a scale product
                # the wrapper launches counts with the GEMM
                ms, dms = time_ms(gemm), device_ms(gemm)
                row[f"{K}x{O}_ms"], row[f"{K}x{O}_device_ms"] = ms, dms
                row["ms"] += ms
                row["device_ms"] += dms
                if M == 8 and K == 768 and O == 768:
                    row["host_us_768x768"] = host_us(gemm)
    out["wrapper_pieces_us"] = wrapper_pieces(dev, im, pa)
    return out


def host_us(fn, n=200):
    """Host time of one call of fn in µs: n calls back to back, the card
    idle at the start and not waited for (the kernels are shorter than
    the calls, so the launch queue never fills)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return us


def host_call_us(fn, n=30):
    """Host time of one call of fn in µs with the card idle when it
    starts (synchronised before each call, the call itself not waited
    for): the median of n. Unlike host_us it holds for a call whose
    kernels outlast it, which fill the launch queue when called back to
    back."""
    import torch
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def wrapper_pieces(dev, im, pa):
    """Host µs of the pieces a kernel wrapper is made of, measured alone:
    where the host time of a paged or int8 call goes."""
    import torch
    q, kp, vp, tables, t = paged_case(dev, torch.bfloat16, **PAGED_STEADY)
    x_q, w_q, s_x, w_s, b = int8_case(dev, 8, 768, 768)
    B, H, _, D = q.shape
    fn = pa._entry()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            t.data_ptr(), out.data_ptr(), B, H, kp.shape[2], D,
            tables.shape[1], 0.125, 1, stream)
    pieces = {
        "torch.empty_like(q)": lambda: torch.empty_like(q),
        "torch.empty((8, 768), float32)": lambda: torch.empty(
            (8, 768), dtype=torch.float32, device=dev),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "x.data_ptr()": lambda: q.data_ptr(),
        "x.is_contiguous()": lambda: q.is_contiguous(),
        "x.device != y.device": lambda: q.device != kp.device,
        "x.shape unpack": lambda: tuple(kp.shape),
        "paged: ctypes call of the C entry (launch included)":
            lambda: fn(*args),
        "int8: x_scale * w_scale as a separate device product "
        "(_combined_scale)":
            lambda: im._combined_scale(s_x, w_s, 768, dev),
    }
    refused = args[:6] + (0,) + args[7:]                # B = 0
    pieces["paged: ctypes call refused at once (B = 0)"] = \
        lambda: fn(*refused)
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        pieces["torch._C._cuda_getCurrentRawStream(i)"] = \
            lambda: torch._C._cuda_getCurrentRawStream(dev.index or 0)
    if hasattr(pa, "_refuse"):
        pieces["paged: _refuse (every check)"] = \
            lambda: pa._refuse(q, kp, vp, tables, t)
    res = {k: host_us(f, n=500) for k, f in pieces.items()}
    # the CUDA-event time of the smallest work, and of the paged kernel's
    # C entry called with its arguments ready: what event_ms cannot go below
    small = torch.zeros(256, device=dev)
    res["event_ms of a 1 KB zero fill (torch)"] = time_ms(small.zero_)
    res["event_ms of the paged C entry alone"] = time_ms(lambda: fn(*args))
    return res


def flash_ab(other):
    """The flash forward, dq and dkv and the int8 GEMM of this checkout
    against those of the checkout at `other` on one card, in the order
    other, this, this, other, each in its own process (`--flash-times`)."""
    rounds = []
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--flash-times", root], capture_output=True,
                           text=True, timeout=900)
        check(r.returncode == 0, f"--flash-times {root}: {r.stderr[-3000:]}")
        rounds.append({"root": "other" if root == other else "this",
                       "times": json.loads(r.stdout.strip().splitlines()[-1])})
        print("chip_smoke: flash A/B " + json.dumps(rounds[-1]), flush=True)
    return rounds



def host_path_times(root):
    """Wall and device time of the training and decode paths whose walls
    the host sets or has moved, of the checkout at `root` (its
    `mxnet_tpu_torch`, built there), through this script's phases:
    ResNet-50 bf16 (3 + 10 steps), BERT-large with remat (2 + 8 steps),
    GPT-2 117M pretraining (2 + 16 steps) and a steady serving decode
    round of GPT-2 117M bf16 (8 slots, 8 rounds). Every layer call and
    every dropout of these paths reads the training mode and goes through
    `Block.__call__`."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.cuda_ops import _build
    from mxnet_tpu_torch.models import gpt
    check(gluon.__file__.startswith(os.path.abspath(root)),
          f"gluon imported from {gluon.__file__}, not {root}")
    _build.library()
    dev = torch.device("cuda")
    keys = ("ms_per_step", "device_busy_ms_per_step", "device_idle_share")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(128, 3, 224, 224)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, 128)
                         .astype(np.float32)).to(dev)
    _, trainer = resnet50_trainer(dev, "bfloat16")
    timing = timed_steps(trainer, [x], [y], 3, 10)[2]
    out = {"resnet50": {k: timing[k] for k in keys}}
    del trainer, x, y
    torch.cuda.empty_cache()
    res, _ = training_phase(dev, "bert_large_config", True, steps=8)
    out["bert_large_remat"] = {k: res[k] for k in keys}
    res, _, model, trainer = gpt_pretrain_phase(dev)
    out["gpt2_pretrain"] = {k: res[k] for k in keys}
    del model, trainer
    torch.cuda.empty_cache()
    model = build_model(gpt.gpt2_117m_config(dtype="bfloat16"), seed=0)
    br = breakdown_phase(model)
    out["decode_round"] = {k: br[k] for k in (
        "decode_round_ms", "device_busy_ms_per_round", "device_idle_share")}
    return out


def accessor_times(root):
    """Phase 44's eager BERT-base steps and phase 2's serving traffic on
    the checkout at `root` (its `mxnet_tpu_torch`, built there), with
    their peak memory: what `gluon.Parameter`'s accessors cost, paired by
    `accessor_ab`. Eager BERT-base (32 x 128 float32, `gluon.Trainer`
    LAMB): the peak from the model's build to the end of its first
    recorded step (the step allocates the gradients and the optimizer's
    state), then 1 + 10 timed steps (`timed_steps`: ms a step, the
    timed steps' peak). Serving (GPT-2 117M bf16, `serving_phase`): the
    peak above what was allocated before the model's build, tokens/s
    and a digest of the tokens."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.cuda_ops import _build
    from mxnet_tpu_torch.models import bert, gpt
    check(gluon.__file__.startswith(os.path.abspath(root)),
          f"gluon imported from {gluon.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda")
    cfg = bert.bert_base_config()
    torch.cuda.reset_peak_memory_stats()
    model = build_bert(cfg, 0, dev)
    loop = EagerBertLoop(model, {"learning_rate": 1e-4, "wd": 0.01})
    data, labels = eager_bert_arrays(cfg, 32, 128, 20, dev)
    first = float(loop.step(data, labels))
    first_peak = torch.cuda.max_memory_allocated()
    losses, counts, timing = timed_steps(loop, data, labels, 1, 10,
                                         profiled=False)
    check(np.isfinite([first] + losses).all(), f"losses {losses}")
    out = {"eager_bert": {
        "first_step_peak_bytes": first_peak,
        "ms_per_step": timing["ms_per_step"],
        "timed_peak_bytes": timing["max_memory_allocated_bytes"],
        "losses": [first] + losses,
        "launches": {k: v for k, v in counts.items() if v}}}
    del loop, model, data, labels
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(gpt.gpt2_117m_config(dtype="bfloat16"), seed=0)
    reset_counts()
    reqs, _, secs = serving_phase(model)
    counts = read_counts()
    check(all(r.verdict == "200 ok" for r in reqs), "serving verdicts")
    tokens = [list(map(int, r.tokens)) for r in reqs]
    out["serving"] = {
        "peak_bytes_above_base": torch.cuda.max_memory_allocated() - base,
        "tokens_per_s": sum(map(len, tokens)) / secs,
        "tokens_digest": hashlib.blake2b(json.dumps(tokens).encode(),
                                         digest_size=8).hexdigest(),
        "launches": {k: v for k, v in counts.items() if v}}
    return out


def accessor_ab(other):
    """`accessor_times` of the checkout at `other` against this one's on
    one card, in the order other, this, this, other, each in its own
    process (`--accessor-times`)."""
    rounds = []
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--accessor-times", root], capture_output=True,
                           text=True, timeout=900)
        check(r.returncode == 0,
              f"--accessor-times {root}: {r.stderr[-3000:]}")
        rounds.append({"root": "other" if root == other else "this",
                       "times": json.loads(r.stdout.strip().splitlines()[-1])})
        print("chip_smoke: accessor A/B " + json.dumps(rounds[-1]), flush=True)
    return rounds


def host_ab(other):
    """The host-bound paths (`host_path_times`) of this checkout against
    those of the checkout at `other` on one card, in the order other,
    this, this, other, each in its own process (`--host-times`)."""
    rounds = []
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--host-times", root], capture_output=True,
                           text=True, timeout=900)
        check(r.returncode == 0, f"--host-times {root}: {r.stderr[-3000:]}")
        rounds.append({"root": "other" if root == other else "this",
                       "times": json.loads(r.stdout.strip().splitlines()[-1])})
        print("chip_smoke: host A/B " + json.dumps(rounds[-1]), flush=True)
    return rounds

def adam_times(root):
    """Adam over the lists a GPT-2 117M step (148 tensors) and a
    Transformer-base NMT step (256) update, bf16 weights, through the
    Adam wrapper of the checkout at `root` (its `mxnet_tpu_torch`, built
    there): one `adam_update_multi` call where it has one, else one
    `adam_update` call a tensor. Host µs of the step's Adam with the card
    idle at its start (`host_call_us`), CUDA events and device time
    (torch.profiler), the L2 flushed, and the launches."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from mxnet_tpu_torch.cuda_ops import _build
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    check(fu.__file__.startswith(os.path.abspath(root)),
          f"fused_update imported from {fu.__file__}, not {root}")
    _build.library()
    dev = torch.device("cuda")
    sizes = adam_list_sizes(dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
              clip_gradient=-1.0)
    out = {}
    for name, ks in sizes.items():
        case = [adam_case(dev, k, torch.bfloat16, seed=i)
                for i, k in enumerate(ks)]
        ws, gs, ms, vs = (list(x) for x in zip(*case))
        del case
        n = len(ks)
        if hasattr(fu, "adam_update_multi"):
            def step():
                fu.adam_update_multi(ws, gs, ms, vs, [1e-3] * n, [0.0] * n,
                                     **kw)
        else:
            def step():
                for w, g, m, v in zip(ws, gs, ms, vs):
                    fu.adam_update(w, g, m, v, 1e-3, **kw)
        n0 = fu.launches_adam
        step()
        out[name] = {"tensors": n, "launches": fu.launches_adam - n0,
                     "host_us": host_call_us(step),
                     "event_ms": time_ms(step, iters=20),
                     "device_ms": device_ms(step, iters=10, match="adam")}
        del ws, gs, ms, vs
        torch.cuda.empty_cache()
    return out


def adam_ab(other):
    """`adam_times` of the checkout at `other` against this one's on one
    card, in the order other, this, this, other, each in its own process
    (`--adam-times`)."""
    rounds = []
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--adam-times", root], capture_output=True,
                           text=True, timeout=900)
        check(r.returncode == 0, f"--adam-times {root}: {r.stderr[-3000:]}")
        rounds.append({"root": "other" if root == other else "this",
                       "times": json.loads(r.stdout.strip().splitlines()[-1])})
        print("chip_smoke: Adam A/B " + json.dumps(rounds[-1]), flush=True)
    return rounds


def lamb_times(root):
    """Both float32-moment LAMB passes at BERT-large's flat master
    through the LAMB wrapper of the checkout at `root` (its
    `mxnet_tpu_torch`, built there), on inputs from a fixed seed: CUDA
    events and device time (L2 flushed), and a SHA-256 of the outputs of
    one call of each pass (m, v and the row sums of pass 1, W of pass
    2), so two checkouts' results compare bit for bit."""
    import hashlib
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from mxnet_tpu_torch.cuda_ops import _build
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    check(fu.__file__.startswith(os.path.abspath(root)),
          f"fused_update imported from {fu.__file__}, not {root}")
    _build.library()
    dev = torch.device("cuda")
    R = bert_rows("bert_large_config")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def rows(scale):
        return torch.randn((R, 512), generator=gen, device=dev) * scale

    W, G, m = rows(0.05), rows(1e-3), rows(1e-4)
    v = rows(1e-4).square()
    wd = torch.tensor(np.where(np.arange(R) % 3, 0.01, 0.0),
                      dtype=torch.float32, device=dev)
    trust = torch.rand(R, generator=gen, device=dev) + 0.5
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              clip_gradient=None, bias_correction=True)
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    m1, v1, W1 = m.clone(), v.clone(), W.clone()
    rw, ru = fu.lamb_pass1(W, G, m1, v1, wd, c1, c2, **kw)
    d1 = digest(m1, v1, rw, ru)
    fu.lamb_pass2(W1, m1, v1, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                  bias_correction=True)
    d2 = digest(W1)

    def p1():
        fu.lamb_pass1(W, G, m1, v1, wd, c1, c2, **kw)

    def p2():
        fu.lamb_pass2(W1, m1, v1, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                      bias_correction=True)
    return {"rows": R, "pass1_digest": d1, "pass2_digest": d2,
            "pass1_event_ms": time_ms(p1), "pass1_device_ms":
            device_ms(p1, match="mxt::"), "pass2_event_ms": time_ms(p2),
            "pass2_device_ms": device_ms(p2, match="mxt::")}


def lamb_ab(other):
    """`lamb_times` of the checkout at `other` against this one's on one
    card, in the order other, this, this, other, each in its own process
    (`--lamb-times`); the float32 route's outputs must be equal bit for
    bit across the checkouts."""
    rounds = []
    for root in (other, ROOT, ROOT, other):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--lamb-times", root], capture_output=True,
                           text=True, timeout=900)
        check(r.returncode == 0, f"--lamb-times {root}: {r.stderr[-3000:]}")
        rounds.append({"root": "other" if root == other else "this",
                       "times": json.loads(r.stdout.strip().splitlines()[-1])})
        print("chip_smoke: LAMB A/B " + json.dumps(rounds[-1]), flush=True)
    digests = {(r["times"]["pass1_digest"], r["times"]["pass2_digest"])
               for r in rounds}
    check(len(digests) == 1, f"LAMB float32 route outputs differ between "
          f"the checkouts: {digests}")
    print("chip_smoke: LAMB A/B: the float32 route's outputs are equal bit "
          "for bit in all four runs")
    return rounds


def bert_rows(config="bert_base_config"):
    """Rows of a BERT config's flat float32 master (FusedLamb layout),
    from the parameter shapes alone (the model built on the meta
    device)."""
    from mxnet_tpu_torch.models import bert
    from mxnet_tpu_torch.parallel import FusedLamb
    m = bert.BERTForPretraining(getattr(bert, config)(), device="meta")
    ps = list(m.collect_params().values())
    return FusedLamb([p.shape for p in ps], [p.dtype for p in ps],
                     [0.0] * len(ps), 0.9, 0.999, 1e-6, True, 1.0, -1.0,
                     -1.0, -1.0).n_rows


def bf16_ulp_err(a, b):
    """The largest distance between two bf16 tensors in units in the last
    place (ordered integer view of the bits, signs folded)."""
    import torch

    def ordered(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def lamb_phase(dev, config="bert_base_config", seed=0,
               moments="float32"):
    """Both LAMB passes against their plain versions at a BERT config's
    flat size (R rows of 512; W and G float32, m and v in `moments`:
    float32 or bfloat16, the route `lamb_moments_dtype` selects), timed
    on copies so each run sees the same state: CUDA events and profiler
    device time. float32: every output within TOL_LAMB of the largest
    |reference|; bf16: the stored moments within 1 bf16 ulp (the kernel
    rounds the EMA operation by operation, as the plain version does, so
    they come out equal), the row sums and W within TOL_LAMB."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    mdt = getattr(torch, moments)
    R = bert_rows(config)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rows(scale):
        return torch.randn((R, 512), generator=gen, device=dev) * scale

    W, G, m = rows(0.05), rows(1e-3), rows(1e-4).to(mdt)
    v = rows(1e-4).square().to(mdt)
    wd = torch.tensor(np.where(np.arange(R) % 3, 0.01, 0.0),
                      dtype=torch.float32, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
              clip_gradient=None, bias_correction=True)
    c1, c2 = 1 - 0.9 ** 3, 1 - 0.999 ** 3
    m1, v1, m2, v2 = m.clone(), v.clone(), m.clone(), v.clone()
    n0 = (fu.launches_pass1, fu.launches_pass2)
    rw, ru = fu.lamb_pass1(W, G, m1, v1, wd, c1, c2, **kw)
    rrw, rru = fu.lamb_pass1_reference(W, G, m2, v2, wd, c1, c2, **kw)
    pairs = ((rw, rrw), (ru, rru))
    ulp = None
    if mdt == torch.float32:
        pairs += ((m1, m2), (v1, v2))
    else:
        ulp = max(bf16_ulp_err(m1, m2), bf16_ulp_err(v1, v2))
        check(ulp <= 1, f"lamb_pass1 bf16 moments {ulp} ulp apart")
    e1 = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
             for a, b in pairs)
    check(e1 <= TOL_LAMB, f"lamb_pass1 ({moments} moments) max relative "
          f"err {e1}")
    trust = torch.rand(R, generator=gen, device=dev) + 0.5
    W1, W2 = W.clone(), W.clone()
    fu.lamb_pass2(W1, m1, v1, wd, trust, c1, c2, 1e-3, epsilon=1e-6,
                  bias_correction=True)
    fu.lamb_pass2_reference(W2, m1, v1, wd, trust, c1, c2, 1e-3,
                            epsilon=1e-6, bias_correction=True)
    e2 = max_err(W1, W2) / float(W2.abs().max())
    check(e2 <= TOL_LAMB, f"lamb_pass2 ({moments} moments) max relative "
          f"err {e2}")
    check((fu.launches_pass1 - n0[0], fu.launches_pass2 - n0[1]) == (1, 1),
          f"LAMB launches ({moments}) {fu.launches_pass1 - n0[0]}, "
          f"{fu.launches_pass2 - n0[1]}")
    n = R * 512 * 4
    nm = R * 512 * m.element_size()
    shapes = (f"W/G ({R}, 512) float32, m/v ({R}, 512) {moments} "
              f"({R * 512} elements)")
    out = {}
    for name, line, err, nbytes, flops, k_fn, p_fn in (
            # pass 1 reads W, G, m, v, writes m, v and two row sums
            ("lamb_pass1", 174, e1, 2 * n + 4 * nm + 12 * R, 20 * R * 512,
             lambda: fu.lamb_pass1(W, G, m1, v1, wd, c1, c2, **kw),
             lambda: fu.lamb_pass1_reference(W, G, m2, v2, wd, c1, c2, **kw)),
            # pass 2 reads W, m, v and the two row vectors, writes W
            ("lamb_pass2", 205, e2, 2 * n + 2 * nm + 8 * R, 10 * R * 512,
             lambda: fu.lamb_pass2(W1, m1, v1, wd, trust, c1, c2, 1e-3,
                                   epsilon=1e-6, bias_correction=True),
             lambda: fu.lamb_pass2_reference(W2, m1, v1, wd, trust, c1, c2,
                                             1e-3, epsilon=1e-6,
                                             bias_correction=True))):
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        ms, dms = time_ms(k_fn), device_ms(k_fn, match="mxt::")
        out[name] = dict(
            name=name, route="cuda",
            source="mxnet_tpu_torch/csrc/fused_update.cu",
            replaces=f"mxnet_tpu/pallas_ops/fused_update.py:{line}",
            max_abs_err=err, error_is="relative to the largest |reference|",
            bound_ms=b_ms, bound_by=b_by, flops_per_call=flops,
            bytes_per_call=nbytes, ms=ms, device_ms=dms,
            bound_share_device=b_ms / dms,
            plain_ms=time_ms(p_fn, iters=5), library_ms=None,
            library="none: no single PyTorch call computes a LAMB pass",
            times_are="ms: CUDA events around the call; device_ms: "
                      "torch.profiler device time; both L2 flushed",
            rows=R, moments=moments, shapes=shapes)
        if ulp is not None:
            out[name]["moments_max_ulp"] = ulp
    return out


def adam_case(dev, n, dtype, seed=0):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = (torch.randn(n, generator=gen, device=dev) * 0.05).to(dtype)
    g = (torch.randn(n, generator=gen, device=dev) * 1e-2).to(dtype)
    m = torch.randn(n, generator=gen, device=dev) * 1e-3
    v = (torch.randn(n, generator=gen, device=dev) * 1e-3).square()
    return w, g, m, v


def adam_phase(dev):
    """The multi-tensor Adam/AdamW kernel against its plain version, bit
    for bit in w, m and v: one tensor at a time (a bf16 weight of GPT-2's
    token-embedding size and a float32 LayerNorm vector; Adam and AdamW,
    clip off and on); a hostile list (`adam_hostile_check`); and the
    lists a GPT-2 117M and a Transformer-base NMT step update, which are
    then timed beside `torch._fused_adam_` (`adam_step_lists`)."""
    import torch
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    n_big = 50257 * 768
    lr_t = 1e-3 * (1 - 0.999 ** 3) ** 0.5 / (1 - 0.9 ** 3)
    worst = {"w_bf16_ulps": 0.0, "w_f32_rel": 0.0, "moments_rel": 0.0}
    for n, dtype in ((n_big, torch.bfloat16), (768, torch.float32)):
        for decoupled in (False, True):
            for clip in (-1.0, 1e-2):
                kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8,
                          wd=0.01 if decoupled else 0.0, rescale_grad=1.0,
                          clip_gradient=clip, decoupled_wd=decoupled)
                w, g, m, v = adam_case(dev, n, dtype)
                rw, rm, rv = fu.adam_update_reference(w, g, m, v, lr_t, **kw)
                fu.adam_update(w, g, m, v, lr_t, **kw)       # in place
                torch.cuda.synchronize()
                # diagnostics only: the gate is equality
                for a, b in ((m, rm), (v, rv)):
                    e = max_err(a, b) / max(float(b.abs().max()), 1e-30)
                    worst["moments_rel"] = max(worst["moments_rel"], e)
                if dtype == torch.bfloat16:
                    ulp = rw.float().abs().clamp(min=1e-38) * 2.0 ** -7
                    worst["w_bf16_ulps"] = max(worst["w_bf16_ulps"], float(
                        ((w.float() - rw.float()).abs() / ulp).max()))
                else:
                    worst["w_f32_rel"] = max(
                        worst["w_f32_rel"],
                        max_err(w, rw) / float(rw.abs().max()))
                for name, a, b in (("w", w, rw), ("m", m, rm), ("v", v, rv)):
                    check(torch.equal(a, b),
                          f"adam {name} n={n} {kw}: {int((a != b).sum())} "
                          f"elements differ, max_abs_err {max_err(a, b)}")
                del w, g, m, v, rw, rm, rv
    # one tensor alone: the whole grid on the largest parameter
    w, g, m, v = adam_case(dev, n_big, torch.bfloat16, seed=1)
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
              clip_gradient=-1.0)

    def kernel():
        fu.adam_update(w, g, m, v, lr_t, **kw)

    one = {"elements": n_big, "ms": device_ms(kernel),
           "event_ms": time_ms(kernel),
           "bound_ms": bound(22 * n_big, 15 * n_big, F32_FLOPS)[0]}
    del w, g, m, v
    hostile = adam_hostile_check(dev)
    lists = adam_step_lists(dev)
    gpt2 = lists["gpt2"]
    return {"adam_update": dict(
        name="adam_update", route="cuda",
        source="mxnet_tpu_torch/csrc/fused_update.cu",
        replaces="mxnet_tpu/pallas_ops/fused_update.py:86",
        max_abs_err=worst["w_bf16_ulps"],
        bit_exact=True,
        error_is="gate: w, m and v equal the plain version's (torch.equal) "
                 "for every tensor of every list; reported: largest |kernel "
                 "- plain| of a bf16 weight in bf16 ulps of the plain value, "
                 "float32 weight and moments relative to the largest |plain| "
                 "in max_rel_err_f32_w / max_rel_err_moments",
        max_rel_err_f32_w=worst["w_f32_rel"],
        max_rel_err_moments=worst["moments_rel"],
        ms=gpt2["bf16_ms"], event_ms=gpt2["bf16_event_ms"],
        plain_ms=gpt2["plain_bf16_ms"], bound_ms=gpt2["bf16_bound_ms"],
        bound_by="bytes", library_ms=gpt2["library_f32_ms"],
        library_event_ms=gpt2["library_f32_event_ms"],
        kernel_f32_ms=gpt2["f32_ms"], kernel_f32_event_ms=gpt2["f32_event_ms"],
        kernel_f32_bound_ms=gpt2["f32_bound_ms"], lists=lists,
        hostile=hostile, one_tensor=one,
        times_are="device time per call (torch.profiler, L2 flushed); "
                  "event_ms: CUDA events around the call",
        library="torch._fused_adam_ over the same list all float32 (its "
                "moments take the parameter's dtype; its epsilon and weight "
                "decay differ from MXNet's): a time yardstick only, beside "
                "kernel_f32_ms",
        shapes="a GPT-2 117M step's 148 trainable tensors (124.4 M "
               "elements), bf16 weights and gradients, float32 moments, one "
               "adam_update_multi call; lists: also the NMT's 256; "
               "one_tensor: GPT-2's word_embed alone")}


def adam_hostile_check(dev):
    """`adam_update_multi` on the lists a kernel gets wrong first, bit for
    bit against the plain version per tensor: sizes 1, 3, 4, 5, 4,097, an
    empty tensor, a tensor past two of the kernel's 4,096-element chunks,
    one of a whole chunk, one an element short of it and one of 13 chunks,
    float32 and bf16 weights in one call (two launches), every tensor its
    own lr and wd, Adam and AdamW, clip off and on; then 700 float32
    tensors in one call (two launches: past the 600 entries one launch
    holds). Returns the launches of each call."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    sizes = [1, 3, 4, 5, 4097, 0, 768, 2 * 4096 + 5, 4096, 7, 2, 4095,
             3 * 16384 + 1]
    dts = [(torch.float32, torch.bfloat16)[i % 2] for i in range(len(sizes))]
    out = {}
    for decoupled in (False, True):
        for clip in (-1.0, 1e-2):
            kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8,
                      rescale_grad=0.5, clip_gradient=clip,
                      decoupled_wd=decoupled)
            lrs = [1e-3 * (1 + i / 7) for i in range(len(sizes))]
            wds = [0.003 * i for i in range(len(sizes))]
            tag = f"{'adamw' if decoupled else 'adam'}_clip{clip}"
            out[tag] = adam_list_check(dev, tag, sizes, dts, lrs, wds, kw)
            check(out[tag] == 2, f"adam hostile list {tag}: {out[tag]} "
                  "launches, expected 2 (float32 and bf16)")
    rng = np.random.RandomState(0)
    sizes = rng.randint(1, 3000, 700).tolist()
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
              clip_gradient=-1.0, decoupled_wd=False)
    out["700_tensors"] = adam_list_check(
        dev, "700 tensors", sizes, [torch.float32] * 700,
        [1e-3] * 700, [0.01] * 700, kw)
    check(out["700_tensors"] == 2,
          f"700 tensors: {out['700_tensors']} launches, expected 2")
    print("chip_smoke: Adam hostile lists equal the plain version bit for "
          "bit; launches " + json.dumps(out))
    return out


def adam_list_check(dev, name, sizes, dtypes, lrs, wds, kw, seed=0):
    """One `adam_update_multi` call over fresh tensors of `sizes` and
    `dtypes` against `adam_update_reference` per tensor: w, m and v must
    be equal bit for bit. Returns the call's launches."""
    import torch
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    case = [adam_case(dev, k, dt, seed=seed + i)
            for i, (k, dt) in enumerate(zip(sizes, dtypes))]
    ws, gs, ms, vs = (list(x) for x in zip(*case))
    refs = [fu.adam_update_reference(w, g, m, v, lr, wd=wd, **kw)
            for w, g, m, v, lr, wd in zip(ws, gs, ms, vs, lrs, wds)]
    n0 = fu.launches_adam
    fu.adam_update_multi(ws, gs, ms, vs, lrs, wds, **kw)
    torch.cuda.synchronize()
    for i, (got, ref) in enumerate(zip(zip(ws, ms, vs), refs)):
        for part, a, b in zip("wmv", got, ref):
            if not torch.equal(a, b):
                check(False, f"adam list {name}: entry {i} (n {sizes[i]}, "
                      f"{dtypes[i]}) {part}: {int((a != b).sum())} "
                      f"elements differ, max_abs_err {max_err(a, b)}")
    return fu.launches_adam - n0


def adam_list_sizes(dev):
    """{"gpt2": sizes, "nmt": sizes}: the trainable tensors of GPT-2 117M
    (148) and of Transformer base (`NMT_BASE`, 256, as `gluon.Trainer`
    lists them)."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.models import gpt
    model = build_model(gpt.gpt2_117m_config(dtype="bfloat16"), 0, dev)
    gpt2 = [p.numel() for _, p in model.named_parameters()
            if getattr(p, "grad_req", "write") != "null"]
    del model
    model = build_nmt(NMT_BASE, 0, dev, "bfloat16")
    nmt = [p.numel() for p in gluon.Trainer(model.collect_params(),
                                            "adam")._params]
    del model
    torch.cuda.empty_cache()
    check(len(gpt2) == 148, f"GPT-2 trainable tensors {len(gpt2)}")
    check(len(nmt) == 256, f"NMT trainable tensors {len(nmt)}")
    return {"gpt2": gpt2, "nmt": nmt}


def adam_step_lists(dev):
    """The lists one training step updates: a GPT-2 117M step's 148
    trainable tensors (`ShardedTrainer`) and a Transformer-base NMT
    step's 256 (`gluon.Trainer`). Each is held bit for bit against the
    plain version (bf16 weights, one launch), then timed: the kernel with
    bf16 weights and all float32, one `torch._fused_adam_` over the same
    float32 list (a yardstick only: the port never calls it) and the
    plain version, by device time (torch.profiler) and CUDA events, the
    L2 flushed before each; and the host time of one call
    (`host_call_us`)."""
    import torch
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    lists = adam_list_sizes(dev)
    out = {}
    for name, kw in (("gpt2", dict(beta1=0.9, beta2=0.999, epsilon=1e-8)),
                     ("nmt", dict(beta1=0.9, beta2=0.98, epsilon=1e-9))):
        sizes = lists[name]
        t = 3
        lr_t = 1e-3 * (1 - kw["beta2"] ** t) ** 0.5 / (1 - kw["beta1"] ** t)
        kw.update(rescale_grad=1.0, clip_gradient=-1.0, decoupled_wd=False)
        k = len(sizes)
        n = sum(sizes)
        launched = adam_list_check(dev, name, sizes, [torch.bfloat16] * k,
                                   [lr_t] * k, [0.0] * k, kw)
        check(launched == 1, f"{name} list: {launched} launches")
        res = {"tensors": k, "elements": n, "launches": launched}
        for dtype, tag, per_elem in ((torch.bfloat16, "bf16", 22),
                                     (torch.float32, "f32", 28)):
            case = [adam_case(dev, x, dtype, seed=i)
                    for i, x in enumerate(sizes)]
            ws, gs, ms, vs = (list(x) for x in zip(*case))
            del case
            lrs, wds = [lr_t] * k, [0.0] * k

            def port():
                fu.adam_update_multi(ws, gs, ms, vs, lrs, wds, **kw)
            res[f"{tag}_ms"] = device_ms(port, iters=10, match="adam")
            res[f"{tag}_event_ms"] = time_ms(port, iters=20)
            res[f"{tag}_bound_ms"] = bound(per_elem * n, 15 * n,
                                           F32_FLOPS)[0]
            if dtype == torch.bfloat16:
                res["host_us"] = host_call_us(port)

                def plain():
                    for w, g, m, v in zip(ws, gs, ms, vs):
                        fu.adam_update_reference(w, g, m, v, lr_t, **kw)
                res["plain_bf16_ms"] = device_ms(plain, iters=2)
            else:
                steps = [torch.tensor(float(t), device=dev) for _ in sizes]

                def library():
                    torch._fused_adam_(
                        ws, gs, ms, vs, [], steps, lr=1e-3,
                        beta1=kw["beta1"], beta2=kw["beta2"],
                        weight_decay=0.0, eps=kw["epsilon"], amsgrad=False,
                        maximize=False)
                res["library_f32_ms"] = device_ms(library, iters=10)
                res["library_f32_event_ms"] = time_ms(library, iters=20)
            del ws, gs, ms, vs
            torch.cuda.empty_cache()
        res["bf16_bound_share"] = res["bf16_bound_ms"] / res["bf16_ms"]
        res["f32_bound_share"] = res["f32_bound_ms"] / res["f32_ms"]
        out[name] = res
        print(f"chip_smoke: Adam over a {name} step's list " + json.dumps(res))
    return out


GPT2_GEMMS = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
# the int8 GEMM's rows: one-token decode, generate's prefill (4 x 128), and
# a longer prefill
INT8_MS = (8, 512, 1024)


def int8_case(dev, M, K, O, seed=0):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    x_q = torch.tensor(rng.randint(-127, 128, (M, K)), dtype=torch.int8,
                       device=dev)
    w_q = torch.tensor(rng.randint(-127, 128, (K, O)), dtype=torch.int8,
                       device=dev)
    s_x = torch.tensor(0.017, device=dev)
    w_s = torch.tensor(rng.rand(O) * 1e-2 + 1e-4, dtype=torch.float32,
                       device=dev)
    b = torch.tensor(rng.randn(O), dtype=torch.float32, device=dev)
    return x_q, w_q, s_x, w_s, b


def int8_phase(dev):
    """int8_matmul against its plain version, bit for bit, at GPT-2's four
    layer GEMMs for M = 8 (the decode route), 512 and 1024 (the wgmma
    route: `generate`'s prefill and a longer one): with bias, without,
    with relu, with a per-tensor scale, with a bf16 0-d activation scale;
    at M > 16 also without the K-major weight (the wrapper's own
    transpose, counted), each route's counter checked. Then kernel, plain
    version and cuBLASLt's int8 product (torch._int_mm) plus the epilogue
    in torch timed, bias on."""
    import torch
    from mxnet_tpu_torch.cuda_ops import int8_matmul as im
    by_shape = {}
    for M in INT8_MS:
        wide = M > 16
        for K, O in GPT2_GEMMS:
            x_q, w_q, s_x, w_s, b = int8_case(dev, M, K, O, seed=M + K + O)
            w_k = w_q.t().contiguous()
            for what, kw in (("bias", dict(bias=b)), ("no bias", {}),
                             ("bias relu", dict(bias=b, relu=True)),
                             ("per-tensor", dict(bias=b)),
                             ("bf16 scale", dict(bias=b)),
                             ("self-transposed", dict(bias=b))):
                ws = w_s[:1].contiguous() if what == "per-tensor" else w_s
                sx = s_x.bfloat16() if what == "bf16 scale" else s_x
                given = {} if what == "self-transposed" else {"w_q_k": w_k}
                n0 = (im.launches_decode, im.launches_wgmma,
                      im.launches_transpose)
                got = im.int8_matmul(x_q, w_q, sx, ws, **kw, **given)
                ref = im.int8_matmul_reference(x_q, w_q, sx, ws, **kw)
                check(torch.equal(got, ref) and not got.isnan().any(),
                      f"int8_matmul ({M},{K},{O}) {what}: max_abs_err "
                      f"{max_err(got, ref)}, not bit for bit")
                n1 = (im.launches_decode, im.launches_wgmma,
                      im.launches_transpose)
                want = (n0[0] + (not wide), n0[1] + wide,
                        n0[2] + (wide and not given))
                check(n1 == want, f"int8 ({M},{K},{O}) {what}: route "
                      f"counters {n1}, expected {want}")
            Mp = max(24, (M + 7) // 8 * 8)            # what _int_mm takes
            x_pad = torch.zeros((Mp, K), dtype=torch.int8, device=dev)
            x_pad[:M] = x_q
            s = s_x * w_s

            def library():
                return torch._int_mm(x_pad, w_q)[:M].float() * s + b

            check(torch.equal(library(), im.int8_matmul_reference(
                x_q, w_q, s_x, w_s, bias=b)), f"_int_mm yardstick ({M},{K},"
                  f"{O}) disagrees")
            b_ms, b_by = bound(M * K + K * O + 8 * O + 4 * M * O,
                               2 * M * K * O, INT8_OPS)

            def kernel():
                return im.int8_matmul(x_q, w_q, s_x, w_s, bias=b, w_q_k=w_k)

            by_shape[f"{M}x{K}x{O}"] = dict(
                ms=device_ms(kernel, match="int8_"),
                wrapper_ms=device_ms(kernel), event_ms=time_ms(kernel),
                plain_ms=device_ms(lambda: im.int8_matmul_reference(
                    x_q, w_q, s_x, w_s, bias=b), iters=5),
                library_ms=device_ms(library), library_event_ms=time_ms(
                    library), bound_ms=b_ms, bound_by=b_by)
    keys = ("ms", "wrapper_ms", "event_ms", "plain_ms", "library_ms",
            "library_event_ms", "bound_ms")
    layer = {M: {k: sum(v[k] for key, v in by_shape.items()
                        if key.startswith(f"{M}x")) for k in keys}
             for M in INT8_MS}
    times_are = ("sums over one GPT-2 layer's four GEMMs (K,O) = (768,2304), "
                 "(768,768), (768,3072), (3072,768), each in by_shape. "
                 "Device time per call (torch.profiler, L2 flushed): ms the "
                 "GEMM kernel alone, wrapper_ms every kernel of the wrapper "
                 "call, plain_ms and library_ms every kernel of theirs; "
                 "event_ms and library_event_ms: CUDA events around the "
                 "call, host time included")
    common = dict(route="cuda", source="mxnet_tpu_torch/csrc/int8_matmul.cu",
                  replaces="mxnet_tpu/pallas_ops/int8_matmul.py:51",
                  max_abs_err=0.0, bit_exact=True, bound_by="bytes",
                  times_are=times_are,
                  library="torch._int_mm (cuBLASLt int8, M padded to 24 at "
                          "M = 8) + the rescale and bias in torch")
    rows = {}
    for name, M, what in (("int8_matmul", 8, "decode route, M = 8"),
                          ("int8_matmul_wgmma", 1024,
                           "wgmma route (K-major weight), M = 1024")):
        rows[name] = dict(
            common, name=name, **{k: layer[M][k] for k in keys},
            shapes=f"{what}: x_q (M, K) int8, w_q_t (K, O) int8, w_scale, "
                   "bias (O,) float32, x_scale 0-d float32")
    rows["int8_matmul"]["by_shape"] = {k: v for k, v in by_shape.items()
                                       if k.startswith("8x")}
    rows["int8_matmul_wgmma"]["layer_m512"] = layer[512]
    rows["int8_matmul_wgmma"]["by_shape"] = {
        k: v for k, v in by_shape.items() if not k.startswith("8x")}
    return rows


MOE_FULL = dict(N=16 * 1024, D=768, E=8)       # phase 11's tokens and widths


def moe_case(dev, N, D, E, C, seed=0):
    """Full-width MoE inputs: tokens with a shared offset and a router that
    leans to expert 0, so `moe_route` overflows its capacity (about a
    tenth of the tokens dropped); plus random routing with duplicate
    slots, invalid experts (-1, E) and positions (-1, >= C)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(N, D).astype(np.float32) + 0.2, device=dev)
    router = rng.randn(D, E).astype(np.float32) * 0.02
    router[:, 0] += 0.004
    dup = (torch.tensor(rng.randint(-1, E + 1, N), dtype=torch.int32,
                        device=dev),
           torch.tensor(rng.randint(-1, C + 2, N), dtype=torch.int32,
                        device=dev),
           torch.tensor(rng.rand(N), dtype=torch.float32, device=dev))
    return x, torch.tensor(router, device=dev), dup


def moe_phase(dev):
    """dispatch_to_experts and combine_from_experts against their plain
    versions (the one-hot einsums, TF32 off) at the Switch LM's full
    width, N = 16,384 tokens of D = 768 over E = 8 experts of capacity
    C = 2,560: on `moe_route`'s routing of a seeded router (capacity
    drops included) bit for bit, and on random routing with duplicates
    and invalid entries (combine bit for bit; dispatch, whose duplicate
    slots sum in another order, within the JAX kernel test's rtol and
    atol of 1e-6).
    Then kernel, plain version and the library call (index_add_ for
    dispatch, index_select and a multiply for combine) timed on the
    moe_route routing, device time, L2 flushed."""
    import torch
    from mxnet_tpu_torch.cuda_ops import moe_kernels as mk
    from mxnet_tpu_torch.parallel import moe
    N, D, E = MOE_FULL["N"], MOE_FULL["D"], MOE_FULL["E"]
    C = max(int(N * 1.25 / E), 1)
    x, router, dup = moe_case(dev, N, D, E, C)
    expert, pos, gate, _ = moe.moe_route(x, router, E)
    kept = int(((pos >= 0) & (pos < C)).sum())
    check(0 < kept < N, f"moe_route kept {kept} of {N} tokens")
    errs = {}
    for what, (e, p, g) in (("moe_route", (expert, pos, gate)),
                            ("duplicates", dup)):
        buf = mk.dispatch_to_experts(x, e, p, E, C)
        ref = mk.dispatch_reference(x, e, p, E, C)
        errs[f"dispatch_{what}"] = max_err(buf, ref)
        if what == "moe_route":
            check(torch.equal(buf, ref), f"moe dispatch ({what}): max_abs_err "
                  f"{errs[f'dispatch_{what}']}, not bit for bit")
        else:                # the JAX test's assert_allclose(1e-6, 1e-6)
            check(bool(((buf - ref).abs() <= 1e-6 + 1e-6 * ref.abs()).all()),
                  f"moe dispatch ({what}): max_abs_err "
                  f"{errs[f'dispatch_{what}']} beyond 1e-6 + 1e-6 |plain|")
        y = mk.combine_from_experts(buf, e, p, g)
        yref = mk.combine_reference(buf, e, p, g)
        errs[f"combine_{what}"] = max_err(y, yref)
        check(torch.equal(y, yref), f"moe combine ({what}): max_abs_err "
              f"{errs[f'combine_{what}']}, not bit for bit")
        del buf, ref, y, yref
    torch.cuda.synchronize()
    buf = mk.dispatch_to_experts(x, expert, pos, E, C)
    valid = (pos >= 0) & (pos < C)
    slot = expert.long() * C + pos.long()

    def index_add():
        out = torch.zeros((E * C + 1, D), device=dev)
        out.index_add_(0, torch.where(valid, slot, E * C), x)
        return out[:-1].view(E, C, D)

    def index_select():
        rows = buf.view(E * C, D).index_select(0, torch.where(valid, slot, 0))
        return rows * torch.where(valid, gate, 0.0)[:, None]

    check(torch.equal(index_add(), buf), "index_add_ yardstick disagrees")
    check(torch.equal(index_select(), mk.combine_reference(
        buf, expert, pos, gate)), "index_select yardstick disagrees")
    rows = {
        "moe_dispatch": dict(
            replaces="mxnet_tpu/pallas_ops/moe_kernels.py:90",
            fn=lambda: mk.dispatch_to_experts(x, expert, pos, E, C),
            plain=lambda: mk.dispatch_reference(x, expert, pos, E, C),
            library=index_add, library_name="torch.Tensor.index_add_ into a "
            "zeroed (E*C+1, D) buffer (dropped tokens to the extra row)",
            # expert and pos, the kept rows of x, all of buf
            nbytes=8 * N + 4 * kept * D + 4 * E * C * D, ops=0,
            max_abs_err=errs["dispatch_duplicates"]),
        "moe_combine": dict(
            replaces="mxnet_tpu/pallas_ops/moe_kernels.py:114",
            fn=lambda: mk.combine_from_experts(buf, expert, pos, gate),
            plain=lambda: mk.combine_reference(buf, expert, pos, gate),
            library=index_select, library_name="torch.index_select of the "
            "slot rows and a multiply by the gate (0 for dropped tokens)",
            # expert, pos and gate, the kept rows of buf, all of y
            nbytes=12 * N + 4 * kept * D + 4 * N * D, ops=kept * D,
            max_abs_err=errs["combine_duplicates"]),
    }
    out = {}
    for name, r in rows.items():
        b_ms, b_by = bound(r["nbytes"], r["ops"], F32_FLOPS)
        out[name] = dict(
            name=name, route="cuda",
            source="mxnet_tpu_torch/csrc/moe_kernels.cu",
            replaces=r["replaces"], max_abs_err=r["max_abs_err"],
            errors=errs,
            error_is="gate: on moe_route's routing the kernel equals the "
                     "plain version (torch.equal), combine also on "
                     "duplicate routing; dispatch with duplicate slots "
                     "within 1e-6 + 1e-6 |plain| (max_abs_err: that case)",
            ms=device_ms(r["fn"], match="moe", skip=FLUSH_ONLY),
            event_ms=time_ms(r["fn"]),
            plain_ms=device_ms(r["plain"], iters=5, skip=FLUSH_ONLY),
            library_ms=device_ms(r["library"], skip=FLUSH_ONLY),
            library_event_ms=time_ms(r["library"]),
            library=r["library_name"], bound_ms=b_ms, bound_by=b_by,
            times_are="device time per call (torch.profiler, L2 flushed); "
                      "ms counts the kernels of the wrapper call (dispatch: "
                      "clear, route, gather, duplicate pass); event_ms and "
                      "library_event_ms: CUDA events around the call",
            kept_tokens=kept,
            shapes=f"x ({N}, {D}) float32, expert/pos ({N},) int32, gate "
                   f"({N},) float32, buf ({E}, {C}, {D}) float32; "
                   "moe_route routing of a seeded router")
    return out


# ---------------------------------------------------------------------------
# phases 2-4: the port's entry points
# ---------------------------------------------------------------------------

_COUNTERS = {
    "flash_attention_fwd": ("flash_attention", "launches"),
    "flash_attention_dq": ("flash_attention", "launches_dq"),
    "flash_attention_dkv": ("flash_attention", "launches_dkv"),
    "paged_attention": ("paged_attention", "launches"),
    "lamb_pass1": ("fused_update", "launches_pass1"),
    "lamb_pass2": ("fused_update", "launches_pass2"),
    "adam_update": ("fused_update", "launches_adam"),
    "int8_matmul": ("int8_matmul", "launches"),          # every route
    "int8_matmul_wgmma": ("int8_matmul", "launches_wgmma"),
    "int8_matmul_mma": ("int8_matmul", "launches_mma"),
    "int8_transpose": ("int8_matmul", "launches_transpose"),
    "moe_dispatch": ("moe_kernels", "launches_dispatch"),
    "moe_combine": ("moe_kernels", "launches_combine"),
    "box_nms": ("box_nms", "launches"),
}


def _counter_module(mod):
    import importlib
    return importlib.import_module(f"mxnet_tpu_torch.cuda_ops.{mod}")


def reset_counts():
    for mod, attr in _COUNTERS.values():
        setattr(_counter_module(mod), attr, 0)


def expect(**launches):
    """Launch counts of a path: the given ones, 0 for every other kernel."""
    want = dict.fromkeys(_COUNTERS, 0)
    want.update(launches)
    return want


# csrc/fused_update.cu ADAM_MAX_TENSORS: the entries of one Adam launch
ADAM_MAX_TENSORS = 600


def adam_launches(params):
    """Adam kernel launches of one step over `params`: one for each weight
    dtype, and one more for every further ADAM_MAX_TENSORS non-empty
    tensors of a dtype."""
    per = {}
    for p in params:
        if p.numel():
            per[p.dtype] = per.get(p.dtype, 0) + 1
    return sum(-(-k // ADAM_MAX_TENSORS) for k in per.values())


def read_counts():
    return {name: getattr(_counter_module(mod), attr)
            for name, (mod, attr) in _COUNTERS.items()}


def sync(model):
    import torch
    if model.device.type == "cuda":
        torch.cuda.synchronize()


def serving_specs(model, n_req=16, lo=16, hi=384, prefix=128, new=64,
                  seed=0, sampled=True):
    """Phase 2's traffic: `n_req` (prompt, submit kwargs) pairs, prompts
    of lo..hi tokens, the even ones behind one shared `prefix`-token
    prefix, `new` new tokens each; every request i with i % 4 >= 2 is
    sampled (temperature 0.8, top_k 40, seed i) unless `sampled` is
    False."""
    import numpy as np
    rng = np.random.RandomState(seed)
    V = model.cfg["vocab_size"]
    shared = rng.randint(0, V, (prefix,)).astype(np.int32)
    specs = []
    for i in range(n_req):
        n = int(rng.randint(lo, hi + 1))
        if i % 2 == 0:
            tail = rng.randint(0, V, (max(n - prefix, 8),)).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.randint(0, V, (n,)).astype(np.int32)
        sample = sampled and i % 4 >= 2
        specs.append((prompt, dict(max_new_tokens=new,
                                   temperature=0.8 if sample else 0.0,
                                   top_k=40 if sample else 0, seed=i)))
    return specs


def drive(srv, specs, submit_kw=None, on_step=None):
    """Phase 2's arrival pattern: the first request alone until its
    prompt is in the prefix tree, then the rest together; then drain.
    `submit_kw(i)` adds keyword arguments to request i's submit, and
    `on_step(requests)` runs after every scheduler step. Returns the
    requests (request i is spec i: ids follow submission order)."""
    def submit(i):
        p, kw = specs[i]
        return srv.submit(p, **kw, **(submit_kw(i) if submit_kw else {}))

    reqs = [submit(0)]
    while srv.busy() and srv.stats()["tree_nodes"] == 0:
        srv.step()
        if on_step:
            on_step(reqs)
    reqs += [submit(i) for i in range(1, len(specs))]
    while srv.busy():
        srv.step()
        if on_step:
            on_step(reqs)
    return reqs


def serving_phase(model, n_req=16, lo=16, hi=384, prefix=128, new=64,
                  slots=8, page_size=16, chunk=8, seed=0, during=None):
    """Staggered traffic: one request behind the shared prefix prefills
    first, then the rest arrive together (half of them behind the same
    prefix). `during(server)`, when given, runs after the traffic and
    before the server stops, outside the timing. Returns (requests,
    server stats, seconds)."""
    from mxnet_tpu_torch import serve
    specs = serving_specs(model, n_req, lo, hi, prefix, new, seed)
    srv = serve.Server(model, slots=slots, pages="on", page_size=page_size,
                       prefill_chunk=chunk)
    sync(model)
    t0 = time.perf_counter()
    reqs = drive(srv, specs)
    sync(model)
    seconds = time.perf_counter() - t0
    stats = srv.stats()
    if during is not None:
        during(srv)
    srv.stop()
    return reqs, stats, seconds


def context_fill_phase(model, chunk=8):
    """A request that fills the whole context decodes its last positions
    while a peer in the same 1024 bucket prefills: each chunk round steps
    the decoder C times, so its masked steps pass position max_length-1
    (the position table is read clamped, as in the JAX package)."""
    import numpy as np
    from mxnet_tpu_torch import serve
    V, L = model.cfg["vocab_size"], model.cfg["max_length"]
    rng = np.random.RandomState(4)
    srv = serve.Server(model, slots=8, pages="on", page_size=16,
                       prefill_chunk=chunk)
    a = srv.submit(rng.randint(0, V, (L - 24,)).astype(np.int32),
                   max_new_tokens=24)
    while len(a.tokens) < 16:
        srv.step()
    b = srv.submit(rng.randint(0, V, (L // 2 + 8,)).astype(np.int32),
                   max_new_tokens=4)
    srv.drain()
    srv.stop()
    check(a.verdict == b.verdict == "200 ok",
          f"context-fill verdicts {a.verdict!r} {b.verdict!r}")
    check(len(a.tokens) == 24 and len(b.tokens) == 4,
          "context-fill token counts")
    check(all(0 <= x < V for x in a.tokens + b.tokens),
          "context-fill tokens out of the vocabulary")


def serve_tokens(model, prompts, new, pages, page_size=16, chunk=8):
    from mxnet_tpu_torch import serve
    srv = serve.Server(model, slots=4, pages=pages, page_size=page_size,
                       prefill_chunk=chunk)
    reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
    srv.drain()
    srv.stop()
    check(all(r.verdict == "200 ok" for r in reqs),
          f"pages={pages} verdicts {[r.verdict for r in reqs]}")
    return [list(r.tokens) for r in reqs]


def breakdown_phase(model, n_req=8, prompt=64, new=40, rounds=8):
    """Where a steady decode round's time goes: 8 requests past their
    prefill, `rounds` one-token rounds timed bare, then the same number
    under torch.profiler for device busy time and the top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import serve
    rng = np.random.RandomState(3)
    srv = serve.Server(model, slots=n_req, pages="on", page_size=16,
                       prefill_chunk=8)
    for _ in range(n_req):
        srv.submit(rng.randint(0, model.cfg["vocab_size"], (prompt,))
                   .astype(np.int32), max_new_tokens=new)
    while srv.stats()["tokens"] < n_req:             # every prompt prefilled
        srv.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        srv.step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            srv.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / rounds
    srv.drain()
    srv.stop()
    busy_ms, top, _, _ = device_profile(prof, rounds, 6)
    # kernel times do not grow under the profiler; the round's wall does,
    # so the idle share is taken against the bare round
    return {"decode_round_ms": bare_ms, "profiled_round_ms": prof_ms,
            "device_busy_ms_per_round": busy_ms,
            "device_idle_share": None if busy_ms is None
            else 1 - busy_ms / bare_ms,
            "slots": n_req, "context": f"{prompt}..{prompt + new}",
            "top_device_ms_per_round": top}


def _kernel_class(name):
    """The class a device kernel's time is summed under: the repo's
    kernels by family, then the library's by what they compute."""
    if "mxt::" in name:
        for part in ("lamb", "adam", "int8", "moe", "nms"):
            if part in name:
                return f"{part} kernels"
        return "attention kernels"
    low = name.lower()
    if "lstm" in low or "gru" in low or low.startswith(("rnn_", "void rnn_")):
        return "RNN (cuDNN)"
    if "ctc_loss" in low:
        return "CTC"
    if "memcpy dtod" in low:
        return "copies on the card"
    if "batch_norm" in low or "bn_" in low:
        return "BatchNorm"
    if "pool" in low:
        return "pooling"
    if any(w in low for w in ("convolution", "conv2d", "implicit_gemm",
                              "implicitgemm", "dgrad", "wgrad", "fprop",
                              "cudnn")):
        return "convolutions"
    if "gemm" in low or low.startswith(("nvjet", "cutlass")):
        return "gemm"
    if "multi_tensor_apply" in low:
        return "foreach updates"
    if "elementwise" in low or "reduce" in low:
        return "elementwise and reductions"
    return "other"


def device_profile(prof, per, n_top):
    """(device busy ms, top kernels {name: ms}, ms by class, kernel
    launches) per `per` repetitions of a torch.profiler window. Kernel
    rows only: an op row's self device time repeats its kernels'. Names
    are cut to 70 characters and kernels whose cut names agree are
    summed."""
    by_name, by_class, launched = {}, {}, 0
    for key, us, count in kernel_rows(prof):
        ms = us / 1e3 / per
        by_name[key[:70]] = by_name.get(key[:70], 0.0) + ms
        cls = _kernel_class(key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        launched += count
    if not by_name:
        return None, {}, {}, 0
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    return sum(by_name.values()), dict(top[:n_top]), by_class, launched / per


def profile_once(fn, attempts=4):
    """fn() (ending in a host fetch) under torch.profiler: (the profile,
    host ms of the call, windows taken). The profiler can lose kernel
    records, now and then all of a window's. fn launches the same
    kernels each call, so windows are taken, after a pause that grows
    with each, until two in a row hold the same number of kernel records
    and the later one at least as many records of the repo's kernels as
    the launch counters saw launches (a launch runs one repo kernel or
    more); after `attempts` windows, the one with the most records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    best, prev = None, None
    for attempt in range(attempts):
        time.sleep(0.5 * attempt)
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        launched = sum(read_counts().values())
        rows = list(kernel_rows(prof))
        total = sum(count for _, _, count in rows)
        seen = sum(count for name, _, count in rows if "mxt::" in name)
        if rows and total == prev and seen >= launched:
            return prof, ms, attempt + 1
        if best is None or total > best[2]:
            best = (prof, ms, total)
        prev = total
    return best[0], best[1], attempts


def timed_steps(trainer, data, labels, warmup, steps, profiled=True,
                n_top=10):
    """`warmup` trainer steps, `steps` timed ones ended by one host fetch
    and, when `profiled`, more under torch.profiler (`profile_once`;
    each window runs one more step). Returns (the
    losses of the warm-up and timed steps, the launch counts of the
    timed steps, {timing and profile fields}). The peak memory is that
    of the timed steps: it is reset after the warm-up, which allocates
    the optimizer's state (and on a deferred model runs the probe
    pass)."""
    import torch
    losses = [trainer.step(data, labels) for _ in range(warmup)]
    float(losses[-1])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.step(data, labels))
    float(losses[-1])                         # one host fetch fences all
    secs = time.perf_counter() - t0
    counts = read_counts()
    step_ms = secs * 1e3 / steps
    res = {"steps": steps, "warmup": warmup, "seconds": secs,
           "ms_per_step": step_ms,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if profiled:
        prof, prof_ms, windows = profile_once(
            lambda: float(trainer.step(data, labels)))
        busy_ms, top, by_class, kernels = device_profile(prof, 1, n_top)
        host_top, waits = host_profile(prof, 1, 12)
        res.update({"profiled_step_ms": prof_ms,
                    "profile_windows": windows,
                    "device_busy_ms_per_step": busy_ms,
                    "device_idle_share": None if busy_ms is None
                    else 1 - busy_ms / step_ms,
                    "device_ms_per_step_by_class": by_class,
                    "kernels_per_step": kernels,
                    "top_device_ms_per_step": top,
                    "top_host_self_ms_per_step": host_top,
                    "waiting_runtime_calls_per_step": waits})
    return [float(x) for x in losses], counts, res


# ---------------------------------------------------------------------------
# phases 6-7: training
# ---------------------------------------------------------------------------

_DATA = ("input_ids", "token_types", "valid_length", "masked_positions")
_LABELS = ("mlm_labels", "mlm_weights", "nsp_labels")


def build_bert(cfg, seed, device):
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import bert
    model = bert.BERTForPretraining(cfg, device=device)
    model.initialize(generator=mxrandom.seed(seed, device))
    return model


def fwd_per_step(policy, L):
    """Flash forwards a training step of an L-layer stack launches under a
    remat policy: the forward, and again in the backward where the
    policy recomputes a layer ("full": its outer recomputation of the
    stack stops after layer L-1, whose output nothing saved needs, then
    each layer's own)."""
    return {"none": L, "dots_saveable": 2 * L, "layers": 2 * L,
            "full": 3 * L - 1}[policy]


def training_phase(dev, config="bert_base_config", remat=None, batch=32,
                   seq_len=512, masked=76, warmup=2, steps=16,
                   moments="float32", policy=None, **cfg_overrides):
    """BERT pretraining steps on one repeated synthetic batch (bench.py's
    configurations: bf16, dropout 0.1, LAMB lr 1e-3, wd 0.01, 32 x 512
    with 76 masked positions), `config` with its own remat unless
    `remat` names one, `policy` a remat policy set by `Block.remat`, the
    LAMB moments stored in `moments` (the `lamb_moments_dtype` knob);
    `cfg_overrides` cut it for a rehearsal on the CPU. Returns the
    result dict and the launch counts of the timed steps. The NSP term
    of a fresh model swings by tenths over the first steps while the MLM
    term falls steadily, so the run is long enough for the last loss to
    sit clearly below the first."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch import memsafe, parallel
    from mxnet_tpu_torch.models import bert
    if remat is not None:
        cfg_overrides["remat"] = remat
    cfg = getattr(bert, config)(dtype="bfloat16", **cfg_overrides)
    model = build_bert(cfg, 0, dev)
    if policy is not None:
        model.remat(policy)
    mxconfig.set("lamb_moments_dtype", moments)
    try:
        trainer = parallel.ShardedTrainer(
            model, bert.bert_pretrain_loss, "lamb",
            {"learning_rate": 1e-3, "wd": 0.01}, device=dev)
    finally:
        mxconfig.reset("lamb_moments_dtype")
    check(trainer.opt_state[0].dtype == getattr(torch, moments),
          f"LAMB moments {trainer.opt_state[0].dtype}, asked {moments}")
    b = bert.make_synthetic_batch(cfg, batch, seq_len, masked, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _LABELS]
    losses, counts, timing = timed_steps(trainer, data, labels, warmup,
                                         steps)
    pol = memsafe.policy_marker(model)
    name = (f"{config}(dtype='bfloat16', remat={cfg['remat']})"
            + (f", remat policy {pol!r}" if policy is not None else "")
            + (f", {moments} LAMB moments" if moments != "float32" else ""))
    check(np.isfinite(losses).all(), f"{name} losses {losses}")
    check(losses[-1] < losses[0], f"{name} loss did not fall: {losses}")
    L = cfg["num_layers"]
    # a rematerialised layer launches its forward again in the backward
    want = expect(flash_attention_fwd=fwd_per_step(pol, L) * steps,
                  flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps, lamb_pass1=steps,
                  lamb_pass2=steps)
    check(counts == want, f"{name} launches {counts} != {want}")
    res = {"model": name, "batch": batch, "seq_len": seq_len,
           "masked": masked, "remat_policy": pol, "moments": moments,
           "moment_bytes": sum(x.numel() * x.element_size()
                               for x in trainer.opt_state),
           "tokens_per_s": batch * seq_len * steps / timing["seconds"],
           "param_count": trainer.param_count,
           "master_rows": trainer._fl.n_rows, "losses": losses, **timing}
    del trainer, model
    torch.cuda.empty_cache()
    return res, counts


def train_parity_phase(dev, steps=3, config="bert_base_config"):
    """A small float32 BERT (dropout 0; `config` at 2 layers of 256
    units: bert_large_config's remat included) trained `steps` LAMB
    steps on the card (flash fwd/dq/dkv and both LAMB kernels) and on the
    CPU (plain versions) from the same weights: losses and the final flat
    master must agree within TOL_TRAIN."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import bert
    cfg = getattr(bert, config)(num_layers=2, units=256, hidden_size=1024,
                                num_heads=4, max_length=128, dropout=0.0)
    b = bert.make_synthetic_batch(cfg, 8, 128, 20, seed=2)
    b["valid_length"][::2] = 100
    out = {}
    for where in ("cpu", "cuda"):
        model = build_bert(cfg, 5, "cpu")
        model.to(where)
        tr = parallel.ShardedTrainer(model, bert.bert_pretrain_loss, "lamb",
                                     {"learning_rate": 1e-3, "wd": 0.01},
                                     device=where)
        reset_counts()
        losses = [float(tr.step([b[k] for k in _DATA],
                                [b[k] for k in _LABELS]))
                  for _ in range(steps)]
        counts = read_counts()
        out[where] = (losses, tr.params.cpu(), counts)
    lc, wc, _ = out["cpu"]
    lg, wg, counts = out["cuda"]
    e_loss = float(np.abs(np.subtract(lg, lc)).max())
    e_w = max_err(wg, wc)
    check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
          f"card vs CPU training: losses {lg} vs {lc}, master err {e_w}")
    L = cfg["num_layers"]
    # a rematerialised layer launches its forward again in the backward
    fwd = L * steps * (2 if cfg["remat"] else 1)
    want = expect(flash_attention_fwd=fwd,
                  flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps, lamb_pass1=steps,
                  lamb_pass2=steps)
    check(counts == want, f"parity launches {counts} != {want}")
    check(all(v == 0 for v in out["cpu"][2].values()),
          f"CPU run launched kernels {out['cpu'][2]}")
    return {"config": config, "remat": cfg["remat"], "losses_card": lg,
            "losses_cpu": lc, "max_loss_err": e_loss, "max_master_err": e_w,
            "master_elements": int(wg.numel()), "launches": counts}


def tiny_bert_run(where, log_ops=False):
    """The card and CPU halves of `tests/test_torch_cuda.py::
    test_tiny_bert_training_on_card_matches_cpu` (tiny BERT, float32, 3
    LAMB steps, lr 1e-3, wd 0.01), recording each step's loss, the flat
    gradient `lamb_pass1` receives, the trust ratios `lamb_pass2`
    receives and the final master; with `log_ops`, each aten op of the
    three steps with digests of its tensor inputs and outputs."""
    import hashlib
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from mxnet_tpu_torch import parallel, random as mxrandom
    from mxnet_tpu_torch.cuda_ops import fused_update as fu
    from mxnet_tpu_torch.models import bert

    def digest(x):
        t = x.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        return hashlib.sha1(t.numpy().tobytes()).hexdigest()[:12]

    ops = []

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # inputs first: an in-place op overwrites its own
            ins = [digest(x) for x in tree_leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)]
            out = func(*args, **(kwargs or {}))
            name = str(func)
            tensors = [x for x in tree_leaves(out)
                       if isinstance(x, torch.Tensor)]
            outs = [] if "empty" in name else [digest(x) for x in tensors]
            ops.append((name, ins, outs,
                        [tuple(x.shape) for x in tensors]))
            return out

    cfg = bert.bert_tiny_config()
    b = bert.make_synthetic_batch(cfg, 4, 64, 6)
    b["valid_length"][1] = 40
    data = [b[k] for k in ("input_ids", "token_types", "valid_length",
                           "masked_positions")]
    labels = [b[k] for k in ("mlm_labels", "mlm_weights", "nsp_labels")]
    rec = {"grad": [], "trust": []}
    p1, p2 = fu.lamb_pass1, fu.lamb_pass2

    def pass1(W, G, *a, **k):
        rec["grad"].append(G.detach().cpu().clone().reshape(-1))
        return p1(W, G, *a, **k)

    def pass2(W, m, v, wd_rows, trust_rows, *a, **k):
        rec["trust"].append(trust_rows.detach().cpu().clone())
        return p2(W, m, v, wd_rows, trust_rows, *a, **k)

    fu.lamb_pass1, fu.lamb_pass2 = pass1, pass2
    try:
        m = bert.BERTForPretraining(cfg, device="cpu")
        m.initialize(generator=mxrandom.seed(0, "cpu"))
        m.to(where)
        tr = parallel.ShardedTrainer(m, bert.bert_pretrain_loss, "lamb",
                                     {"learning_rate": 1e-3, "wd": 0.01},
                                     device=where)
        if log_ops:
            with Log():
                losses = [tr.step(data, labels) for _ in range(3)]
        else:
            losses = [tr.step(data, labels) for _ in range(3)]
        rec["losses"] = [float(x) for x in losses]
        rec["master"] = tr.params.detach().cpu().clone()
    finally:
        fu.lamb_pass1, fu.lamb_pass2 = p1, p2
    rec["ops"] = ops
    return rec


def bert_repeat(runs, log_ops=True):
    """Fault 8's evidence: `tiny_bert_run` on the CPU and on the card,
    `runs` times each in this process. For each device, how many distinct
    bit patterns each step's loss, flat gradient (and its row 26, which
    holds `embed_ln.gamma`), trust ratios and the final master took; the
    card-minus-CPU error of master element 13,323 (`embed_ln.gamma[11]`)
    and the largest of the others; and, from the op logs, every aten op
    whose inputs were bit-equal to the first run's while its outputs were
    not (an op whose result varies from run to run), with the first op
    whose inputs differed while every earlier output agreed (a variation
    born outside aten: a kernel of the port). The digests of the first
    run's gradients, trust ratios and master tell runs in separate
    processes apart."""
    import hashlib
    import torch
    res = {}
    recs = {"cpu": [], "cuda": []}
    for _ in range(runs):
        for where in ("cpu", "cuda"):
            recs[where].append(tiny_bert_run(where, log_ops))
    for where, rr in recs.items():
        def distinct(key, step=None, rows=None):
            seen = set()
            for r in rr:
                x = r[key] if step is None else r[key][step]
                if rows is not None:
                    x = x[rows]
                seen.add(x.numpy().tobytes() if torch.is_tensor(x)
                         else repr(x))
            return len(seen)
        row = slice(26 * 512, 27 * 512)
        out = {"runs": len(rr),
               "losses": [distinct("losses")],
               "grad": [distinct("grad", s) for s in range(3)],
               "grad_row26": [distinct("grad", s, row) for s in range(3)],
               "trust": [distinct("trust", s) for s in range(3)],
               "master": distinct("master"),
               "grad_13323_step1": sorted({float(r["grad"][0][13323])
                                           for r in rr})}
        first, varying = None, {}
        base = rr[0]["ops"]
        for r in rr[1:]:
            ops = r["ops"]
            if len(ops) != len(base) or any(
                    a[0] != b[0] for a, b in zip(ops, base)):
                out["op_sequences_differ"] = True
                continue
            outs_equal = True
            for i, (a, b) in enumerate(zip(ops, base)):
                if a[2] == b[2]:
                    continue
                if a[1] == b[1]:
                    varying.setdefault(a[0], []).append(i)
                elif outs_equal and (first is None or i < first[0]):
                    first = (i, a[0], a[3])
                outs_equal = False
        out["digests"] = {key: [hashlib.sha1(x.numpy().tobytes())
                                .hexdigest()[:12] for x in rr[0][key]]
                          for key in ("grad", "trust")}
        out["digests"]["master"] = hashlib.sha1(
            rr[0]["master"].numpy().tobytes()).hexdigest()[:12]
        out["ops_logged"] = len(base)
        out["varying_ops"] = {k: sorted(set(v))[:5]
                              for k, v in varying.items()}
        out["first_input_mismatch"] = first
        res[where] = out
    errs = []
    for rg, rc in zip(recs["cuda"], recs["cpu"]):
        d = (rg["master"] - rc["master"]).abs()
        others = torch.cat([d[:13323], d[13324:]])
        errs.append((float(d[13323]), float(others.max())))
    grad = [max(float((rg["grad"][s] - rc["grad"][s]).abs().max())
                 for rg, rc in zip(recs["cuda"], recs["cpu"]))
            for s in range(3)]
    res["card_minus_cpu"] = {"gamma11": [e[0] for e in errs],
                             "max_other": max(e[1] for e in errs),
                             "grad_max_abs_per_step": grad}
    return res


def bert_large_phase(dev, steps=8, **kw):
    """BERT-large pretraining (bench.py's `bench_bert_large`: 2 + 8 steps)
    with per-layer remat, then the same without remat at the same batch:
    what remat saves in peak memory and costs in time. Returns
    ({"remat": ..., "no_remat": ...}, launch counts of the remat run)."""
    out, counts = {}, None
    for remat in (True, False):
        res, c = training_phase(dev, "bert_large_config", remat,
                                steps=steps, **kw)
        out["remat" if remat else "no_remat"] = res
        counts = counts or c
    r, n = out["remat"], out["no_remat"]
    out["remat_saves_bytes"] = n["max_memory_allocated_bytes"] \
        - r["max_memory_allocated_bytes"]
    out["remat_costs_ms_per_step"] = r["ms_per_step"] - n["ms_per_step"]
    return out, counts


# ---------------------------------------------------------------------------
# phases 31-35: the flagship job made durable (bf16 LAMB moments, remat
# policies, the OOM ladder, checkpoints and preemption)
# ---------------------------------------------------------------------------

def bf16_moments_phase(dev, f32_run, steps=8, **kw):
    """BERT-large (phase 13's remat run, `lamb_moments_dtype="bfloat16"`):
    ms per step, peak memory and the LAMB kernels' device ms a step
    against the float32-moment run `f32_run` (phase 13's); the first
    five losses within 5e-3 relative of the float32 run's (the JAX
    package's `test_bf16_moments_tracks_f32` gate). Returns (result,
    launch counts)."""
    import numpy as np
    res, counts = training_phase(dev, "bert_large_config", steps=steps,
                                 moments="bfloat16", **kw)
    a, b = np.array(res["losses"]), np.array(f32_run["losses"])
    rel = np.abs(a - b) / np.abs(b)
    check(rel[:5].max() <= 5e-3, f"bf16-moment losses {a[:5]} against "
          f"float32's {b[:5]}")
    lamb = {k: r.get("device_ms_per_step_by_class", {}).get("lamb kernels")
            for k, r in (("bfloat16", res), ("float32", f32_run))}
    out = {"ms_per_step": res["ms_per_step"],
           "float32_ms_per_step": f32_run["ms_per_step"],
           "max_memory_allocated_bytes": res["max_memory_allocated_bytes"],
           "float32_max_memory_allocated_bytes":
               f32_run["max_memory_allocated_bytes"],
           "moment_bytes": res["moment_bytes"],
           "float32_moment_bytes": f32_run["moment_bytes"],
           "lamb_device_ms_per_step": lamb["bfloat16"],
           "float32_lamb_device_ms_per_step": lamb["float32"],
           "max_loss_rel_diff_first5": float(rel[:5].max()),
           "max_loss_rel_diff": float(rel.max()),
           "losses": res["losses"], "float32_losses": f32_run["losses"],
           "run": res}
    return out, counts


def policy_bit_equal_phase(dev, steps=2):
    """A small float32 BERT and GPT (3 layers, dropout 0.1 on hidden
    states and attention) on `dev`: two training-mode forwards and
    backwards under each remat policy from the same weights and seed
    give losses and gradients equal to "none"'s bit for bit, and the
    flash forward launches `fwd_per_step` says."""
    import torch
    from torch.func import functional_call
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import bert, gpt
    tiny = dict(vocab_size=128, units=64, hidden_size=128, num_layers=3,
                num_heads=4, max_length=64, dropout=0.1, attn_dropout=0.1)
    out = {}
    for fam, mod, cfgf, cls, lossf, data, labels in (
            ("bert", bert, "bert_large_config", "BERTForPretraining",
             "bert_pretrain_loss", _DATA, _LABELS),
            ("gpt", gpt, "gpt2_345m_config", "GPTForCausalLM",
             "gpt_lm_loss", _GPT_DATA, _GPT_LABELS)):
        cfg = getattr(mod, cfgf)(**tiny)
        m = getattr(mod, cls)(cfg, device=dev)
        m.initialize(generator=mxrandom.seed(0, dev))
        b = (mod.make_synthetic_batch(cfg, 4, 32, 5, seed=3)
             if fam == "bert" else mod.make_synthetic_batch(cfg, 4, 32,
                                                            seed=3))
        runs = {}
        for pol in ("none", "dots_saveable", "layers", "full"):
            m.remat(pol)
            mxrandom.seed(11, dev)
            reset_counts()
            got = []
            for _ in range(steps):
                leaves = {n: p.detach().clone().requires_grad_(True)
                          for n, p in m.collect_params().items()}
                m.train()
                try:
                    o = functional_call(m, leaves, tuple(
                        torch.from_numpy(b[k]).to(dev) for k in data))
                finally:
                    m.eval()
                o = o if isinstance(o, tuple) else (o,)
                loss = getattr(mod, lossf)(*o, *[
                    torch.from_numpy(b[k]).to(dev) for k in labels])
                names = sorted(leaves)
                got.append((loss.detach(), torch.autograd.grad(
                    loss, [leaves[n] for n in names])))
            fwd = read_counts()["flash_attention_fwd"]
            if dev.type == "cuda":
                check(fwd == fwd_per_step(pol, 3) * steps,
                      f"{fam} {pol}: {fwd} flash forwards")
            runs[pol] = (got, fwd)
        ref = runs["none"][0]
        for pol, (got, fwd) in runs.items():
            same = all(torch.equal(a[0], c[0]) and all(
                torch.equal(x, y) for x, y in zip(a[1], c[1]))
                for a, c in zip(ref, got))
            check(same, f"{fam}: remat {pol!r} is not bit equal to 'none'")
            out[f"{fam}_{pol}"] = {"losses": [float(g[0]) for g in got],
                                   "flash_fwd_launches": fwd,
                                   "bit_equal_to_none": same}
    return out


def remat_policies_phase(dev, large, steps=8, **kw):
    """BERT-large (bf16, 32 x 512, LAMB) under "dots_saveable" and
    "full" (`Block.remat`), 2 + `steps` steps each, beside phase 13's
    "layers" (its remat run) and "none" (its run without): ms per step,
    peak memory, flash forwards a step. Each policy's peak is below
    "none"'s, and its losses equal "none"'s bit for bit. Returns
    {policy: summary}, with the two new runs' whole results under
    "runs"."""
    runs = {"layers": large["remat"], "none": large["no_remat"]}
    for pol in ("dots_saveable", "full"):
        runs[pol], _ = training_phase(dev, "bert_large_config", steps=steps,
                                      policy=pol, **kw)
    out = {pol: {"ms_per_step": r["ms_per_step"],
                 "max_memory_allocated_bytes": r["max_memory_allocated_bytes"],
                 "device_busy_ms_per_step": r.get("device_busy_ms_per_step"),
                 "device_idle_share": r.get("device_idle_share"),
                 "losses": r["losses"]}
           for pol, r in runs.items()}
    for pol in ("dots_saveable", "layers", "full"):
        check(out[pol]["max_memory_allocated_bytes"]
              < out["none"]["max_memory_allocated_bytes"],
              f"remat {pol!r} peak not below 'none': {out}")
        # same seed, batch and dropout streams: the losses are "none"'s
        check(out[pol]["losses"] == out["none"]["losses"],
              f"remat {pol!r} losses differ from 'none''s: {out}")
    out["order_by_peak"] = sorted(
        ("none", "dots_saveable", "layers", "full"),
        key=lambda p: -out[p]["max_memory_allocated_bytes"])
    out["runs"] = {p: runs[p] for p in ("dots_saveable", "full")}
    return out


def oom_ladder_phase(dev, ref_losses=None, cap_bytes=12e9, steps=9,
                     batch=32, seq_len=512, masked=76, **cfg_overrides):
    """The degradation ladder on a REAL out-of-memory: the process capped
    at `cap_bytes` of the card (`torch.cuda.set_per_process_memory_
    fraction`), where BERT-large at 32 x 512 cannot train under remat
    "none" (phase 13: 22.93 GB) but can under "layers" (7.60 GB). Under
    `oom_recover="auto"` the first step walks the ladder to a rung that
    fits (`memsafe.transitions()`) and training goes on: the losses
    finite and falling, and, as the failed attempts' random draws are
    rewound and every policy is bit equal to "none", equal to
    `ref_losses` (phase 13's run of the same job) bit for bit; ms per
    step after it. Under "off" the first step raises
    `torch.cuda.OutOfMemoryError`."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch import memsafe, parallel
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_large_config(dtype="bfloat16", **cfg_overrides)
    b = bert.make_synthetic_batch(cfg, batch, seq_len, masked, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _LABELS]
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    total = torch.cuda.get_device_properties(idx).total_memory
    out = {"cap_bytes": int(cap_bytes), "card_bytes": int(total)}
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap_bytes / total, idx)
    try:
        for mode in ("off", "auto"):
            mxconfig.set("oom_recover", mode)
            memsafe.reset()
            model = build_bert(cfg, 0, dev).remat("none")
            tr = parallel.ShardedTrainer(
                model, bert.bert_pretrain_loss, "lamb",
                {"learning_rate": 1e-3, "wd": 0.01}, device=dev)
            if mode == "off":
                raised = None
                try:
                    tr.step(data, labels)
                except torch.cuda.OutOfMemoryError as e:
                    raised = type(e).__name__
                check(raised == "OutOfMemoryError" and tr.num_update == 0,
                      f"oom_recover=off: the first step raised {raised}")
                out["off"] = {"raised": raised,
                              "transitions": memsafe.transitions()}
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = [float(tr.step(data, labels))]
                first_s = time.perf_counter() - t0
                torch.cuda.reset_peak_memory_stats(idx)
                t0 = time.perf_counter()
                for _ in range(steps):
                    losses.append(tr.step(data, labels))
                losses[1:] = [float(x) for x in losses[1:]]
                secs = time.perf_counter() - t0
                walked = [(t["kind"], t["value"])
                          for t in memsafe.transitions()]
                check(walked and walked[-1][0] == "remat",
                      f"ladder under a {cap_bytes / 1e9:.0f} GB cap: "
                      f"{walked}")
                check(np.isfinite(losses).all() and losses[-1] < losses[0],
                      f"losses after the ladder {losses}")
                if ref_losses is not None:
                    check(losses == list(ref_losses[:len(losses)]),
                          f"losses after the ladder {losses} != the "
                          f"uninterrupted run's {ref_losses}")
                out["auto"] = {
                    "transitions": memsafe.transitions(),
                    "held": memsafe.policy_marker(model),
                    "grad_accum": tr._accum,
                    "oom_events": memsafe.oom_events(),
                    "first_step_seconds": first_s,
                    "ms_per_step_after": secs * 1e3 / steps,
                    "max_memory_allocated_bytes_after":
                        torch.cuda.max_memory_allocated(idx),
                    "losses": losses}
            del tr, model
            torch.cuda.empty_cache()
    finally:
        mxconfig.reset("oom_recover")
        memsafe.disable()
        torch.cuda.set_per_process_memory_fraction(1.0, idx)
    return out


def ckpt_trainer(dev, cfg_overrides=None):
    """Phase 34's job: BERT-large bf16 from seed 0, LAMB lr 1e-3, wd
    0.01, float32 moments, and its 32 x 512 batch (76 masked)."""
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_large_config(dtype="bfloat16", **(cfg_overrides or {}))
    model = build_bert(cfg, 0, dev)
    tr = parallel.ShardedTrainer(model, bert.bert_pretrain_loss, "lamb",
                                 {"learning_rate": 1e-3, "wd": 0.01},
                                 device=dev)
    b = bert.make_synthetic_batch(cfg, *CKPT_BATCH, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _LABELS]
    return tr, model, data, labels


CKPT_BATCH = (32, 512, 76)     # batch, sequence, masked positions
CKPT_STEPS = 8
# phase 34 trains 2 of BERT-large's 24 layers (its widths unchanged): the
# script's 1,200 s limit (a 24-layer run took 120 s of a 968 s script, a
# 4-layer one 85.1 s of a 1,142.5 s script on a slow host)
CKPT_DEPTH = {"num_layers": 2}
# phases 26-29, 47 and 49 serve 6 of GPT-2 117M's 12 layers (its widths
# unchanged), for the same limit (26-29 took 163.1 s of that script)
SERVE_DEPTH = {"num_layers": 6}


def ckpt_child(mode, directory, cfg_overrides=None):
    """One process of phase 34, the flagship's `--auto-checkpoint-dir`
    flow (examples/bert/pretrain.py) through the port's names:
      ref      — CKPT_STEPS steps, no checkpoint (the uninterrupted run);
      preempt  — `AutoCheckpoint(every_steps=2)`; the `sigterm@step:3`
                 fault sends SIGTERM inside step 3; the step finishes,
                 is saved, and the process exits EXIT_PREEMPTED (83);
      resume   — `restore_latest()`, then on to step CKPT_STEPS, the
                 step-8 checkpoint corrupted after its manifest by the
                 `corrupt_ckpt@step:8` fault.
    Resilience is enabled (verified atomic writes); the AutoCheckpoint's
    own handler takes SIGTERM. Prints one JSON line: losses by step,
    save and restore seconds, checkpoint bytes."""
    import torch
    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch import parallel, resilience
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_overrides = dict(cfg_overrides or {})
    dev = torch.device(cfg_overrides.pop("device", "cuda"))
    fault = {"preempt": "sigterm@step:3",
             "resume": f"corrupt_ckpt@step:{CKPT_STEPS}"}.get(mode)
    if fault:
        mxconfig.set("fault_inject", fault)
    resilience.enable()
    tr, _model, data, labels = ckpt_trainer(dev, cfg_overrides)
    out = {"mode": mode, "losses": {}, "saves": {}}
    ac = None
    start = 0
    if mode != "ref":
        ac = parallel.AutoCheckpoint(tr, directory, every_steps=2)
    if mode == "resume":
        start = ac.restore_latest() or 0
        out["restored_step"] = start
        out["restore_seconds"] = ac.last_restore_seconds
    stepper = ac or tr
    for step in range(start + 1, CKPT_STEPS + 1):
        out["losses"][step] = float(stepper.step(data, labels))
        if ac is not None and step in ac._complete_steps() \
                and step not in out["saves"]:
            path = os.path.join(ac._step_dir(step), "state.pt")
            out["saves"][step] = {"seconds": ac.last_save_seconds,
                                  "bytes": os.path.getsize(path)}
        if ac is not None and ac.preempted:
            if tr.num_update not in ac._complete_steps():
                ac.save()
            out["preempted_at"] = tr.num_update
            print(json.dumps(out), flush=True)
            raise resilience.PreemptedExit("preempted")
    print(json.dumps(out), flush=True)


def save_breakdown(tr, directory):
    """Where a BERT-large checkpoint write's time goes (the pieces of
    `ShardedTrainer.save_states` under resilience, timed one by one):
    the copy to the host (`_state`, twice: the first call allocates the
    pinned buffers), `torch.save` with and without its zip CRC32,
    the fsync, and the manifest's CRC32 read-back (`resilience.
    _file_crc`)."""
    import torch
    from mxnet_tpu_torch import resilience
    out = {}
    for name in ("host_copy_first_s", "host_copy_s"):
        t0 = time.perf_counter()
        state = tr._state()
        out[name] = time.perf_counter() - t0
    path = os.path.join(directory, "breakdown.pt")
    try:
        from torch.utils.serialization import config as ser_config
        cfg = ser_config.save
    except ImportError:
        cfg = None
    for crc in (True, False):
        if not crc and cfg is None:
            continue
        if cfg is not None:
            cfg.compute_crc32 = crc
        try:
            t0 = time.perf_counter()
            with open(path, "wb") as f:
                torch.save(state, f)
                t1 = time.perf_counter()
                f.flush()
                os.fsync(f.fileno())
            t2 = time.perf_counter()
        finally:
            if cfg is not None:
                cfg.compute_crc32 = True
        key = "torch_save" if crc else "torch_save_no_zip_crc"
        out[key + "_s"], out[key + "_fsync_s"] = t1 - t0, t2 - t1
    t0 = time.perf_counter()
    resilience._file_crc(path)
    out["manifest_crc32_s"] = time.perf_counter() - t0
    out["bytes"] = os.path.getsize(path)
    os.remove(path)
    return out


def ckpt_phase(dev, cfg_overrides=None):
    """Phase 34: the flagship job made durable on the card. Children (one
    process each, `--ckpt-child`): the uninterrupted reference beside the
    run SIGTERM preempts in step 3 (it must exit 83 with step 3 saved),
    then the run that resumes it to step 8: its losses of steps 4-8
    equal the reference's bit for bit (same process layout, every
    random stream in the checkpoint). Then this process restores the
    newest checkpoint of that directory: the corrupted step 8 is
    skipped for step 6. Last, `save_checkpoint(prefix)` writes the
    restored model's `.params` and a fresh model's `load_parameters`
    reproduces its forward bit for bit. The checkpoints live in a
    temporary directory the phase deletes."""
    import shutil
    import tempfile
    import torch
    from mxnet_tpu_torch import parallel, resilience
    from mxnet_tpu_torch.models import bert
    tmp = tempfile.mkdtemp(prefix="mxt_ckpt_")
    extra = [json.dumps(dict(cfg_overrides or {}, device=str(dev)))]
    ckdir = os.path.join(tmp, "auto")

    def child(mode):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ckpt-child", mode,
             ckdir] + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def result(p, want_rc):
        so, se = p.communicate(timeout=900)
        check(p.returncode == want_rc, f"checkpoint child rc "
              f"{p.returncode}, expected {want_rc}: {se[-3000:]}")
        return json.loads(so.strip().splitlines()[-1])
    try:
        t0 = time.perf_counter()
        ref_p, pre_p = child("ref"), child("preempt")
        pre = result(pre_p, resilience.EXIT_PREEMPTED)
        res = result(child("resume"), 0)
        ref = result(ref_p, 0)
        children_s = time.perf_counter() - t0
        ref_l = {int(k): v for k, v in ref["losses"].items()}
        pre_l = {int(k): v for k, v in pre["losses"].items()}
        res_l = {int(k): v for k, v in res["losses"].items()}
        check(pre.get("preempted_at") == 3 and sorted(pre_l) == [1, 2, 3],
              f"preempted run {pre}")
        check(res["restored_step"] == 3 and sorted(res_l) == list(
            range(4, CKPT_STEPS + 1)), f"resumed run {res}")
        check(all(pre_l[k] == ref_l[k] for k in pre_l),
              f"steps 1-3 {pre_l} vs uninterrupted {ref_l}")
        check(all(res_l[k] == ref_l[k] for k in res_l),
              f"resumed steps 4-8 {res_l} vs uninterrupted {ref_l}")
        # this process: the newest checkpoint (step 8) is corrupt
        resilience.enable()
        try:
            tr, model, data, labels = ckpt_trainer(dev, cfg_overrides)
            ac = parallel.AutoCheckpoint(tr, ckdir, on_preemption=False)
            check(ac._complete_steps() == [6, 8],
                  f"kept checkpoints {ac._complete_steps()}")
            got = ac.restore_latest()
            check(got == 6 and tr.num_update == 6,
                  f"restore_latest past the corrupt step 8 gave {got}")
            restore_s = ac.last_restore_seconds
        finally:
            resilience.disable()
        breakdown = save_breakdown(tr, tmp)
        prefix = os.path.join(tmp, "bert_large")
        t1 = time.perf_counter()
        tr.save_checkpoint(prefix)
        params_save_s = time.perf_counter() - t1
        cfg = model.cfg
        fresh = build_bert(cfg, 1, dev)
        t1 = time.perf_counter()
        fresh.load_parameters(prefix + ".params")
        params_load_s = time.perf_counter() - t1
        with torch.no_grad():
            a, b = model(*data), fresh(*data)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        check(same, "load_parameters: the fresh model's forward differs")
        saves = [v for r in (pre, res) for v in r["saves"].values()]
        out = {
            "losses_uninterrupted": ref_l, "losses_preempted": pre_l,
            "losses_resumed": res_l, "preempted_exit": 83,
            "resumed_bit_equal": True, "children_seconds": children_s,
            "save_seconds": [v["seconds"] for v in saves],
            "checkpoint_bytes": saves[0]["bytes"],
            "save_gb_per_s": [v["bytes"] / v["seconds"] / 1e9
                              for v in saves],
            "save_breakdown": breakdown,
            "restore_seconds_child": res["restore_seconds"],
            "restore_seconds_past_corrupt": restore_s,
            "corrupt_newest_skipped_for": got,
            "params_file_bytes": os.path.getsize(prefix + ".params"),
            "params_save_seconds": params_save_s,
            "params_load_seconds": params_load_s,
            "params_forward_bit_equal": same}
        del tr, model, fresh
        torch.cuda.empty_cache()
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def durable_parity_phase(dev, steps=3, devices=("cpu", "cuda")):
    """Phase 35, small float32 models, the card against the CPU:
    (a) `FusedLamb.apply_flat` with bf16 moments, 3 steps on the same
    gradients: moments within 1 bf16 ulp, master within TOL_LAMB;
    (b) a tiny BERT trained 3 LAMB steps with bf16 moments: losses and
    master within TOL_TRAIN; its `save_parameters` file written on the
    card loads on the CPU bit for bit, and so do its `save_states`
    (master, moments, num_update); (c) the ladder's transitions under
    five `oom@step:1` faults equal on both devices."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch import memsafe, parallel, resilience
    from mxnet_tpu_torch.models import bert
    from mxnet_tpu_torch.parallel import FusedLamb
    out = {}
    # (a) the bf16 route on identical gradients
    rng = np.random.RandomState(0)
    shapes = [(300, 7), (33,), (128, 64), (1024, 96), (5,)]
    ws = [rng.randn(*s).astype(np.float32) * 0.05 for s in shapes]
    gss = [[rng.randn(*s).astype(np.float32) * 1e-3 for s in shapes]
           for _ in range(steps)]
    states = {}
    for where in devices:
        fl = FusedLamb(shapes, [torch.float32] * len(shapes),
                       [0.01, 0.0, 0.01, 0.01, 0.0], 0.9, 0.999, 1e-6,
                       True, 1.0, -1.0, -1.0, -1.0,
                       moments_dtype=torch.bfloat16)
        w = fl.flatten([torch.from_numpy(x).to(where) for x in ws])
        m, v = fl.zeros_moments(where)
        for t, gs in enumerate(gss, 1):
            g = fl.flatten([torch.from_numpy(x).to(where) for x in gs])
            fl.apply_flat(w, g, m, v, t, 1e-3)
        states[where] = (w.cpu(), m.cpu(), v.cpu())
    (wc, mc, vc), (wg, mg, vg) = states[devices[0]], states[devices[1]]
    ulp = max(bf16_ulp_err(mg, mc), bf16_ulp_err(vg, vc))
    w_err = max_err(wg, wc) / float(wc.abs().max())
    check(ulp <= 1 and w_err <= TOL_LAMB,
          f"bf16-moment LAMB card vs CPU: moments {ulp} ulp, master {w_err}")
    out["lamb_bf16_apply_flat"] = {"moments_max_ulp": ulp,
                                   "master_max_rel_err": w_err}
    # (b) a tiny BERT with bf16 moments; its files across devices
    cfg = bert.bert_large_config(num_layers=2, units=128, hidden_size=256,
                                 num_heads=4, max_length=64, vocab_size=512,
                                 dropout=0.0)
    b = bert.make_synthetic_batch(cfg, 4, 64, 8, seed=2)
    x, y = [b[k] for k in _DATA], [b[k] for k in _LABELS]
    runs = {}
    mxconfig.set("lamb_moments_dtype", "bfloat16")
    try:
        for where in devices:
            model = build_bert(cfg, 5, "cpu")
            model.to(where)
            tr = parallel.ShardedTrainer(model, bert.bert_pretrain_loss,
                                         "lamb", {"learning_rate": 1e-3,
                                                  "wd": 0.01}, device=where)
            losses = [float(tr.step(x, y)) for _ in range(steps)]
            runs[where] = (losses, tr, model)
        (lc, trc, mc_), (lg, trg, mg_) = runs[devices[0]], runs[devices[1]]
        e_loss = float(np.abs(np.subtract(lg, lc)).max())
        e_w = max_err(trg.params.cpu(), trc.params)
        check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
              f"bf16-moment BERT card vs CPU: losses {lg} vs {lc}, master "
              f"{e_w}")
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            trg.save_checkpoint(os.path.join(tmp, "card"))
            cpu_model = build_bert(cfg, 9, "cpu")
            cpu_model.load_parameters(os.path.join(tmp, "card.params"))
            params_equal = all(
                torch.equal(p.cpu(), q) for p, q in zip(
                    mg_.collect_params().values(),
                    cpu_model.collect_params().values()))
            trg.save_states(os.path.join(tmp, "states"))
            trc.load_states(os.path.join(tmp, "states"))
            states_equal = (torch.equal(trg.params.cpu(), trc.params)
                            and all(torch.equal(a.cpu(), c) for a, c in
                                    zip(trg.opt_state, trc.opt_state))
                            and trc.num_update == trg.num_update)
        check(params_equal and states_equal,
              f"card files on the CPU: params {params_equal}, states "
              f"{states_equal}")
        out["bert_bf16_moments"] = {
            "losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_master_err": e_w, "params_card_to_cpu_bit_equal":
                params_equal, "states_card_to_cpu_bit_equal": states_equal}
    finally:
        mxconfig.reset("lamb_moments_dtype")
    del runs, trc, trg
    # (c) the ladder under simulated out-of-memory faults
    walks = {}
    mxconfig.set("oom_recover", "auto")
    mxconfig.set("fault_inject", ",".join(["oom@step:1"] * 5))
    try:
        for where in devices:
            memsafe.reset()
            resilience.enable()
            model = build_bert(cfg, 5, "cpu").remat("none")
            model.to(where)
            tr = parallel.ShardedTrainer(model, bert.bert_pretrain_loss,
                                         "lamb", {"learning_rate": 1e-3,
                                                  "wd": 0.01}, device=where)
            losses = [float(tr.step(x, y)) for _ in range(2)]
            walks[where] = ([(t["kind"], t["value"])
                             for t in memsafe.transitions()], losses)
            del tr, model
            resilience.disable()
    finally:
        mxconfig.reset("oom_recover")
        mxconfig.reset("fault_inject")
        memsafe.disable()
        memsafe.reset()
    (wc_, lc_), (wg_, lg_) = walks[devices[0]], walks[devices[1]]
    check(wc_ == wg_ and len(wc_) == 5,
          f"ladder transitions card {wg_} vs CPU {wc_}")
    check(float(np.abs(np.subtract(lc_, lg_)).max()) <= TOL_TRAIN,
          f"losses after the ladder {walks}")
    out["ladder"] = {"transitions": wg_, "losses_card": lg_,
                     "losses_cpu": lc_}
    return out


def resnet50_trainer(dev, dtype):
    """bench.py's `bench_resnet50` model and trainer:
    `resnet50_v1(classes=1000)`, `random.seed(0)`, `initialize()`,
    `cast(dtype)` (none for float32), SoftmaxCrossEntropyLoss, SGD lr
    0.1, momentum 0.9, wd 1e-4."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.models import resnet
    net = resnet.resnet50_v1(classes=1000, device=dev)
    mxrandom.seed(0, dev)
    net.initialize()
    if dtype is not None:
        net.cast(dtype)
    lfn = gloss.SoftmaxCrossEntropyLoss()
    return net, parallel.ShardedTrainer(
        net, lambda out, label: lfn(out, label), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}, device=dev)


def resnet50_phase(dev, batch=128, size=224, warmup=3, steps=10,
                   layout_steps=5):
    """ResNet-50 v1 training as bench.py's `bench_resnet50` runs it
    (`resnet50_trainer(dev, "bfloat16")`, one repeated batch of 128 x 3
    x 224 x 224 from numpy.random.RandomState(0)): 3 warm-up steps (the
    first resolves the deferred shapes), 10 timed ones ended by one host
    fetch, one under torch.profiler; then `layout_steps` timed with the
    convolutions' memory format switched to NCHW. Then the same 3 + 10
    steps in float32 (TF32 off) from the same seed: the loss trace the
    bf16 one is read beside, and whose first loss (no update yet, the
    same weights up to bf16 rounding) the bf16 one must meet within 5%.
    Returns (result, launch counts)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.ops import nn_ops
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, 3, size, size)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 1000, batch)
                         .astype(np.float32)).to(dev)
    net, trainer = resnet50_trainer(dev, "bfloat16")
    losses, counts, timing = timed_steps(trainer, [x], [y], warmup, steps,
                                         n_top=25)
    check(np.isfinite(losses).all(), f"ResNet-50 losses {losses}")
    check(counts == expect(), f"ResNet-50 launched repo kernels {counts}")
    bn = net.features[1]
    check(bn.running_mean.dtype == torch.bfloat16
          and float(bn.running_mean.float().abs().max()) > 0
          and float((bn.running_var.float() - 1).abs().max()) > 0,
          "the first BatchNorm's running statistics did not move")
    # the same steps with the convolutions' input left NCHW in memory
    fmt = nn_ops.conv_memory_format
    nn_ops.conv_memory_format = torch.contiguous_format
    try:
        float(trainer.step([x], [y]))
        t2 = time.perf_counter()
        for _ in range(layout_steps):
            loss = trainer.step([x], [y])
        float(loss)
        nchw_ms = (time.perf_counter() - t2) * 1e3 / layout_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            float(trainer.step([x], [y]))
        nchw_busy, _, nchw_class, _ = device_profile(prof, 1, 0)
    finally:
        nn_ops.conv_memory_format = fmt
    res = {"model": "resnet50_v1(classes=1000), cast('bfloat16')",
           "batch": batch, "image": [3, size, size],
           "images_per_s": batch * steps / timing["seconds"],
           "param_count": sum(p.numel() for p in trainer.params),
           "losses": losses,
           "first_bn_running_mean_absmax":
               float(bn.running_mean.float().abs().max()),
           **timing,
           "conv_memory_format": str(fmt),
           "ms_per_step_nchw_memory_format": nchw_ms,
           "device_busy_ms_per_step_nchw": nchw_busy,
           "device_ms_per_step_by_class_nchw": nchw_class,
           "nchw_steps": layout_steps}
    del trainer, net
    torch.cuda.empty_cache()
    net, trainer = resnet50_trainer(dev, None)
    losses32, _, t32 = timed_steps(trainer, [x], [y], warmup, steps,
                                   profiled=False)
    check(np.isfinite(losses32).all(),
          f"float32 ResNet-50 losses {losses32}")
    first = abs(losses[0] - losses32[0]) / abs(losses32[0])
    check(first <= 0.05, f"ResNet-50 first loss: bf16 {losses[0]} vs "
          f"float32 {losses32[0]}")
    res["float32"] = {"losses": losses32,
                      "images_per_s": batch * steps / t32["seconds"],
                      "ms_per_step": t32["ms_per_step"],
                      "max_memory_allocated_bytes":
                          t32["max_memory_allocated_bytes"],
                      "first_loss_rel_diff_bf16": first}
    del trainer, net
    torch.cuda.empty_cache()
    return res, counts


def resnet_parity_phase(dev, steps=3):
    """A small float32 ResNet v1 (BottleneckV1, two stages) trained
    `steps` SGD steps (momentum 0.9, wd 1e-4) with `set_grad_accum(2)` on
    the card and on the CPU from the same weights, TF32 off: losses,
    every parameter and every running statistic within TOL_TRAIN; no
    repo kernel launches."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel, weights
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.models import resnet

    def net():
        return resnet.ResNetV1(resnet.BottleneckV1, [1, 1], [16, 64, 128],
                               classes=10, device="cpu")

    rng = np.random.RandomState(3)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.float32)
    start = net()
    start.initialize(generator=mxrandom.seed(6, "cpu"))
    with torch.no_grad():
        start(torch.from_numpy(x))
    arrays = {k: p.detach().numpy().copy()
              for k, p in start.collect_params().items()}
    lfn = gloss.SoftmaxCrossEntropyLoss()
    out = {}
    for where in ("cpu", "cuda"):
        model = weights.load_named_arrays(net(), arrays).to(where)
        tr = parallel.ShardedTrainer(
            model, lambda o, l: lfn(o, l), "sgd",
            {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
            device=where)
        tr.set_grad_accum(2)
        reset_counts()
        losses = [float(tr.step([x], [y])) for _ in range(steps)]
        check(read_counts() == expect(),
              f"ResNet parity ({where}) launched repo kernels")
        state = {k: p.detach().cpu() for k, p in
                 model.collect_params().items() if "running" in k}
        state.update({k: w.cpu() for k, w in zip(tr._names, tr.params)})
        out[where] = (losses, state)
    (lc, sc), (lg, sg) = out["cpu"], out["cuda"]
    e_loss = float(np.abs(np.subtract(lg, lc)).max())
    e_w = max(max_err(sg[k], sc[k]) for k in sc)
    check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
          f"ResNet card vs CPU: losses {lg} vs {lc}, state err {e_w}")
    check(lg[-1] < lg[0], f"ResNet parity loss did not fall: {lg}")
    return {"losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_param_or_statistic_err": e_w, "tensors": len(sc)}


# ---------------------------------------------------------------------------
# phases 8-10: GPT-2 pretraining with Adam, then int8 serving
# ---------------------------------------------------------------------------

_GPT_DATA = ("input_ids", "valid_length")
_GPT_LABELS = ("labels", "weights")


def gpt_pretrain_phase(dev, batch=16, seq_len=1024, warmup=2, steps=16,
                       lr=1e-3, **cfg_overrides):
    """GPT-2 117M pretraining steps with Adam on one repeated synthetic
    batch (examples/gpt/pretrain.py's optimizer and learning rate; the
    16,384 tokens per step of phase 6). Returns the result dict, the
    launch counts of the timed steps, the model and its trainer."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt2_117m_config(dtype="bfloat16", **cfg_overrides)
    model = build_model(cfg, 0, dev)
    trainer = parallel.ShardedTrainer(model, gpt.gpt_lm_loss, "adam",
                                      {"learning_rate": lr}, device=dev)
    n_params = len(trainer.params)
    b = gpt.make_synthetic_batch(cfg, batch, seq_len, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _GPT_DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _GPT_LABELS]
    losses, counts, timing = timed_steps(trainer, data, labels, warmup,
                                         steps)
    check(np.isfinite(losses).all(), f"GPT-2 training losses {losses}")
    check(losses[-1] < losses[0], f"GPT-2 loss did not fall: {losses}")
    L = cfg["num_layers"]
    want = expect(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps,
                  adam_update=adam_launches(trainer.params) * steps)
    check(counts == want, f"GPT-2 training launches {counts} != {want}")
    busy_ms = timing["device_busy_ms_per_step"]
    res = {"model": "gpt2_117m_config(dtype='bfloat16')", "batch": batch,
           "seq_len": seq_len, "optimizer": f"adam lr {lr}",
           "tokens_per_s": batch * seq_len * steps / timing["seconds"],
           "param_count": trainer.param_count,
           "trainable_parameters": n_params, "losses": losses, **timing,
           "adam_share_of_device_time": None if busy_ms is None
           else timing["device_ms_per_step_by_class"].get(
               "adam kernels", 0.0) / busy_ms}
    return res, counts, model, trainer


def adam_parity_phase(dev, steps=3):
    """A small float32 GPT (dropout 0) trained `steps` Adam steps, and from
    the same start `steps` AdamW steps (wd 0.01, clip 1.0), on the card
    (flash and Adam kernels) and on the CPU (plain versions): losses and
    every parameter must agree within TOL_TRAIN."""
    import numpy as np
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt2_117m_config(num_layers=2, units=256, hidden_size=1024,
                               num_heads=4, max_length=128, dropout=0.0)
    b = gpt.make_synthetic_batch(cfg, 8, 128, seed=2)
    b["valid_length"][::2] = 100
    b["weights"][::2, 100:] = 0.0
    out = {}
    for kind, opts in (("adam", {"learning_rate": 1e-3}),
                       ("adamw", {"learning_rate": 1e-3, "wd": 0.01,
                                  "clip_gradient": 1.0})):
        runs = {}
        for where in ("cpu", dev):
            model = build_model(cfg, 5, "cpu")
            model.to(where)
            tr = parallel.ShardedTrainer(model, gpt.gpt_lm_loss, kind,
                                         dict(opts), device=where)
            reset_counts()
            losses = [float(tr.step([b[k] for k in _GPT_DATA],
                                    [b[k] for k in _GPT_LABELS]))
                      for _ in range(steps)]
            runs[str(where)] = (losses, [p.cpu() for p in tr.params],
                                read_counts(), adam_launches(tr.params))
        (lc, wc, cc, _), (lg, wg, counts, n) = runs["cpu"], runs[str(dev)]
        e_loss = float(np.abs(np.subtract(lg, lc)).max())
        e_w = max(max_err(a, c) for a, c in zip(wg, wc))
        check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
              f"card vs CPU {kind}: losses {lg} vs {lc}, param err {e_w}")
        L = cfg["num_layers"]
        want = expect(flash_attention_fwd=L * steps,
                      flash_attention_dq=L * steps,
                      flash_attention_dkv=L * steps, adam_update=n * steps)
        check(counts == want, f"{kind} parity launches {counts} != {want}")
        check(all(v == 0 for v in cc.values()), f"CPU run launched {cc}")
        out[kind] = {"losses_card": lg, "losses_cpu": lc,
                     "max_loss_err": e_loss, "max_param_err": e_w}
    return out


def int8_serving_phase(model, bf16_serving):
    """Phase 8's trained model (its weights written back), quantized to
    int8 with scales calibrated on the first 128 tokens of two training
    batches, serving phase 2's traffic; every Dense runs the int8
    kernel, 48 launches per one-token model step, which the phase counts
    itself. Then one `generate` call (its prefill reaches the kernel at
    M = 4 x 128) and a profiled steady decode round."""
    import numpy as np
    from mxnet_tpu_torch.contrib import quantization as quant
    from mxnet_tpu_torch.models import gpt
    cfg = model.cfg
    calib = [gpt.make_synthetic_batch(cfg, 16, 1024, seed=s)["input_ids"]
             [:, :128] for s in (0, 1)]
    quant.quantize_block(model, calib_data=calib)
    n_dense = sum(isinstance(m, quant.QuantizedDense)
                  for m in model.modules())
    check(n_dense == 4 * cfg["num_layers"], f"{n_dense} int8 layers")
    check(all(m._act_scale is not None for m in model.modules()
              if isinstance(m, quant.QuantizedDense)),
          "a layer was not calibrated")
    token_steps = [0]
    chunk = model.decode_paged_chunk

    def counted(toks, *args, **kw):
        token_steps[0] += toks.shape[1]
        return chunk(toks, *args, **kw)

    model.decode_paged_chunk = counted
    reset_counts()
    reqs, stats, secs = serving_phase(model)
    counts = read_counts()
    del model.decode_paged_chunk
    check(all(r.verdict == "200 ok" for r in reqs),
          f"int8 verdicts {[r.verdict for r in reqs]}")
    check(all(len(r.tokens) == 64 for r in reqs), "int8 token counts")
    check(counts["int8_matmul"] == n_dense * token_steps[0],
          f"int8 launches {counts['int8_matmul']} != {n_dense} x "
          f"{token_steps[0]} one-token steps")
    check(counts["paged_attention"] > 0, "paged kernel never launched")
    check(counts["int8_matmul_wgmma"] == counts["int8_matmul_mma"]
          == counts["int8_transpose"] == 0,
          f"int8 serving left the decode route: {counts}")
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    res = {"requests": len(reqs), "tokens": n_tok, "seconds": secs,
           "tokens_per_s": n_tok / secs,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "prefix_hit_rate": stats["prefix_hit_rate"],
           "one_token_model_steps": token_steps[0],
           "launches": counts,
           "bf16_tokens_per_s": bf16_serving["tokens_per_s"],
           "bf16_ttft_ms_p50": bf16_serving["ttft_ms_p50"],
           "bf16_ttft_ms_p99": bf16_serving["ttft_ms_p99"]}
    gp = np.random.RandomState(2).randint(0, 50257, (4, 100)).astype(np.int32)
    reset_counts()
    toks = model.generate(gp, max_new_tokens=32)
    counts = read_counts()
    check(toks.shape == (4, 32) and (toks >= 0).all()
          and (toks < 50257).all(), f"int8 generate tokens {toks.shape}")
    # one prefill pass (M = 4 x 128 rows, the wgmma route on the K-major
    # weights QuantizedDense keeps: no transpose) and 31 one-token steps
    check(counts["int8_matmul"] == n_dense * 32
          and counts["int8_matmul_wgmma"] == n_dense
          and counts["int8_transpose"] == counts["int8_matmul_mma"] == 0
          and counts["flash_attention_fwd"] == cfg["num_layers"],
          f"int8 generate launches {counts}")
    res["generate_launches"] = counts
    res["breakdown"] = breakdown_phase(model)
    return res


def int8_narrow_phase(dev, new=16):
    """A float32 GPT of 2 layers x 256 units and gpt_tiny's vocabulary of
    128: the int8 server's greedy tokens equal its simulate=True twin's
    (the JAX package's gate, `Server(model, slots=2)`,
    tests/unittest/test_serve.py), and one quantized forward on `dev`
    agrees with the same forward on the CPU.

    The vocabulary is gpt_tiny's because the gate needs logit margins
    wider than the activation-quantization error: with GPT-2's 50257
    tokens the flat logits of random weights put near-ties at almost
    every step (on the CPU plain versions, 6 of 6 seeds left the
    simulate twin's tokens within 64 tokens; at vocabulary 128, 1 of 6).

    The serving gate runs the JAX gate's model, whose biases start at 0.
    The forward runs the same weights with every Dense bias drawn nonzero
    (0.05 x randn), so the int8 kernel's bias epilogue takes part in it.

    Tolerance of the forward: TOL_INT8_FWD of the largest |logit|. The
    int8 products are exact on both devices, but the float32 LayerNorm,
    attention and head around them round differently on the card, and a
    one-ulp difference can move an activation across a rounding boundary
    of the int8 grid, which moves that layer's output by one grid step
    (max|x|/127) times a weight. The phase measures that effect on the
    CPU and reports it (`perturbed_rel`): the same forward with every
    LayerNorm gain scaled by (1 + 2e-7), two float32 ulps."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import serve, weights
    from mxnet_tpu_torch.contrib import quantization as quant
    from mxnet_tpu_torch.models import gpt
    cfg = gpt.gpt2_117m_config(num_layers=2, units=256, hidden_size=1024,
                               num_heads=4, max_length=128, dropout=0.0,
                               vocab_size=128)
    base = build_model(cfg, 0, "cpu")
    arrays = {k: p.detach().numpy() for k, p in base.collect_params().items()}
    brng = np.random.RandomState(7)
    biased = {k: (brng.randn(*a.shape) * 0.05).astype(np.float32)
              if k.endswith(".bias") else a for k, a in sorted(arrays.items())}

    def twin(where, simulate, arrays=arrays):
        m = gpt.GPTForCausalLM(cfg, device=where)
        weights.load_named_arrays(m, arrays)
        return quant.quantize_block(m, simulate=simulate)

    qm, sm = twin(dev, False), twin(dev, True)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (5, 9, 3, 17)]
    toks = {}
    reset_counts()
    for name, m in (("int8", qm), ("simulate", sm)):
        srv = serve.Server(m, slots=2)
        reqs = [srv.submit(p, max_new_tokens=new) for p in prompts]
        srv.drain()
        srv.stop()
        check(all(r.verdict == "200 ok" for r in reqs),
              f"narrow {name} verdicts {[r.verdict for r in reqs]}")
        toks[name] = [list(r.tokens) for r in reqs]
        if name == "int8":
            n_int8 = read_counts()["int8_matmul"]
    check(toks["int8"] == toks["simulate"],
          f"int8 tokens {toks['int8']} != simulate {toks['simulate']}")
    check(str(dev) == "cpu" or n_int8 > 0, "int8 kernel never launched")
    ids = torch.from_numpy(rng.randint(0, 128, (2, 64)).astype(np.int32))
    perturbed = {k: a * np.float32(1 + 2e-7) if k.endswith(".gamma") else a
                 for k, a in biased.items()}
    with torch.no_grad():
        got = twin(dev, False, biased)(ids.to(dev)).cpu()
        ref = twin("cpu", False, biased)(ids)
        pert = twin("cpu", False, perturbed)(ids)
    err = max_err(got, ref)
    scale = float(ref.abs().max())
    check(err <= TOL_INT8_FWD * scale,
          f"quantized forward card vs CPU: {err} > {TOL_INT8_FWD} x {scale}")
    return {"tokens_equal_simulate": True, "tokens": toks["int8"],
            "forward_max_abs_err": err, "forward_max_abs_logit": scale,
            "forward_rel": err / scale, "tol_rel": TOL_INT8_FWD,
            "perturbed_rel": max_err(pert, ref) / scale,
            "int8_launches_in_serving": n_int8}


# ---------------------------------------------------------------------------
# phases 11-12: the Switch-FFN mixture-of-experts LM
# ---------------------------------------------------------------------------

SWITCH_FULL = dict(V=50257, D=768, F=3072, E=8)   # GPT-2 vocab; Switch-Base-8


def switch_batch(V, B, T, seed=0):
    """The JAX package's `_dryrun_moe` batch: random tokens, labels the
    tokens rolled by one position."""
    import numpy as np
    toks = np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int32)
    return toks, np.roll(toks, 1, axis=1).astype(np.int32)


def switch_routing(trainer, toks, E, capacity_factor=1.25):
    """(expert, pos, capacity) of the trainer's current embedding and
    router on a batch, as `moe_ffn` routes it."""
    import torch
    from mxnet_tpu_torch.parallel import moe
    p = dict(zip(trainer._names, trainer.params))
    with torch.no_grad():
        h = p["embed.weight"][torch.as_tensor(toks, device=trainer.device)
                              .long()].reshape(-1, p["router_w"].shape[0])
        expert, pos, _, _ = moe.moe_route(h, p["router_w"], E)
    return expert, pos, max(int(h.shape[0] * capacity_factor / E), 1)


def switch_phase(dev, batch=16, seq_len=1024, warmup=2, steps=16, lr=1e-3,
                 **widths):
    """The Switch-FFN LM at full width (GPT-2's vocabulary, Switch-Base's
    d_model 768 and d_ff 3072, 8 experts, capacity factor 1.25, tanh
    gelu, bf16 parameters with the MoE math in float32) trained through
    `ShardedTrainer(..., "adam", {"learning_rate": 1e-3})` (the JAX
    package's `_dryrun_moe` optimizer) on one repeated batch: 2 warm-up
    steps, 16 timed steps ended by one host fetch, one profiled step.
    Returns the result dict and the launch counts of the timed steps."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel
    w = dict(SWITCH_FULL, **widths)
    model = build_switch_lm(**w, dtype="bfloat16", seed=0, device=dev)
    trainer = parallel.ShardedTrainer(model, switch_lm_loss, "adam",
                                      {"learning_rate": lr}, device=dev)
    toks, labels = switch_batch(w["V"], batch, seq_len)
    data = [torch.from_numpy(toks).to(dev)]
    lab = [torch.from_numpy(labels).to(dev)]
    _, pos0, C = switch_routing(trainer, toks, w["E"])
    losses, counts, timing = timed_steps(trainer, data, lab, warmup, steps)
    check(np.isfinite(losses).all(), f"Switch LM losses {losses}")
    check(losses[-1] < losses[0], f"Switch LM loss did not fall: {losses}")
    n_params = len(trainer.params)
    want = expect(moe_dispatch=2 * steps, moe_combine=3 * steps,
                  adam_update=adam_launches(trainer.params) * steps)
    check(n_params == 6 and counts == want,
          f"Switch LM launches {counts} != {want} ({n_params} parameters)")
    expert, pos, _ = switch_routing(trainer, toks, w["E"])
    busy_ms = timing["device_busy_ms_per_step"]
    return {"model": "Switch-FFN LM " + json.dumps(w) + ", bf16",
            "batch": batch, "seq_len": seq_len, "capacity": C,
            "optimizer": f"adam lr {lr}",
            "tokens_per_s": batch * seq_len * steps / timing["seconds"],
            "param_count": trainer.param_count, "losses": losses,
            "dropped_share_first_step": float((pos0 >= C).float().mean()),
            "dropped_share_last_step": float((pos >= C).float().mean()),
            "tokens_per_expert_last_step":
                torch.bincount(expert.long(), minlength=w["E"]).tolist(),
            **timing,
            "moe_share_of_device_time": None if busy_ms is None
            else timing["device_ms_per_step_by_class"].get(
                "moe kernels", 0.0) / busy_ms}, counts


def switch_parity_phase(dev, steps=3, batch=16, seq_len=64, cf=1.0):
    """A small float32 Switch LM (V 128, D 64, F 128, E 4, capacity
    factor 1.0, so that a few tokens overflow) trained `steps` Adam steps
    on the card (dispatch, combine and Adam kernels) and on the CPU
    (plain versions) from the same weights: the routing of every step is
    equal, and losses and every parameter agree within TOL_TRAIN."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel, weights
    w = dict(V=128, D=64, F=128, E=4)
    base = build_switch_lm(**w, seed=5, device="cpu", capacity_factor=cf)
    arrays = {k: p.detach().numpy() for k, p in base.collect_params().items()}
    toks, labels = switch_batch(w["V"], batch, seq_len, seed=1)
    runs = {}
    for where in ("cpu", dev):
        model = build_switch_lm(**w, seed=5, device=where,
                                capacity_factor=cf)
        weights.load_named_arrays(model, arrays)
        tr = parallel.ShardedTrainer(model, switch_lm_loss, "adam",
                                     {"learning_rate": 1e-3}, device=where)
        reset_counts()
        losses, routes = [], []
        for _ in range(steps):
            expert, pos, C = switch_routing(tr, toks, w["E"], cf)
            routes.append((expert.cpu(), pos.cpu()))
            losses.append(float(tr.step([toks], [labels])))
        runs[str(where)] = (losses, [p.cpu() for p in tr.params], routes,
                            read_counts(), adam_launches(tr.params))
    (lc, wc, rc, cc, _), (lg, wg, rg, counts, n) = runs["cpu"], \
        runs[str(dev)]
    check(all(torch.equal(a, b) for ra, rb in zip(rg, rc)
              for a, b in zip(ra, rb)), "card vs CPU Switch LM routing differs")
    e_loss = float(np.abs(np.subtract(lg, lc)).max())
    e_w = max(max_err(a, c) for a, c in zip(wg, wc))
    check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
          f"card vs CPU Switch LM: losses {lg} vs {lc}, param err {e_w}")
    want = expect(moe_dispatch=2 * steps, moe_combine=3 * steps,
                  adam_update=n * steps)
    check(counts == want, f"Switch LM parity launches {counts} != {want}")
    check(all(v == 0 for v in cc.values()), f"CPU run launched {cc}")
    return {"losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_param_err": e_w, "routing_equal": True,
            "capacity": C, "dropped_share_per_step":
                [float((p >= C).float().mean()) for _, p in rg]}


def build_switch_lm(V, D, F, E, dtype="float32", seed=0, device=None,
                    capacity_factor=1.25):
    """The Switch-FFN LM of the JAX package's `_dryrun_moe`
    (__graft_entry__.py), composed of the port's gluon blocks: an
    embedding, `h + moe_apply(h)` with E experts of width F, and a Dense
    head; forward returns (logits, aux_loss). Weights: uniform(0.07)
    (the JAX model's default initializer; the head's bias 0)."""
    from mxnet_tpu_torch import context, gluon, parallel
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon import nn

    class SwitchLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, D, dtype=dtype)
            self.router_w = gluon.Parameter("router_w", (D, E), dtype)
            self.moe_w1 = gluon.Parameter("moe_w1", (E, D, F), dtype)
            self.moe_w2 = gluon.Parameter("moe_w2", (E, F, D), dtype)
            self.head = nn.Dense(V, in_units=D, flatten=False, dtype=dtype)

        def forward(self, toks):
            h = self.embed(toks)
            B, T, _ = h.shape
            y, aux = parallel.moe_apply(h.reshape(B * T, D), self.router_w,
                                        self.moe_w1, self.moe_w2,
                                        capacity_factor=capacity_factor)
            return self.head(h + y.reshape(B, T, D)), aux

    dev = context.resolve(device)
    with dev:
        model = SwitchLM()
    model.initialize(generator=mxrandom.seed(seed, dev))
    return model


def switch_lm_loss(logits, aux, labels):
    """Mean token cross entropy (float32 log-softmax) + 0.01 x aux, on
    tensors or the ones that `ShardedTrainer`'s NDArrays hold."""
    import torch
    logits, aux, labels = (getattr(x, "_t", x) for x in (logits, aux,
                                                         labels))
    logp = torch.log_softmax(logits.float(), -1)
    ce = -logp.gather(-1, labels.long()[..., None]).mean()
    return ce + 0.01 * aux


def build_model(cfg, seed, device=None):
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import gpt
    model = gpt.GPTForCausalLM(cfg, device=device)
    model.initialize(generator=mxrandom.seed(seed, model.device))
    return model


# ---------------------------------------------------------------------------
# phase 1 (NMT shapes) and phases 17-18: the Transformer NMT through the
# eager Gluon loop
# ---------------------------------------------------------------------------

NMT_BASE = dict(src_vocab=37000, tgt_vocab=37000, units=512, hidden_size=2048,
                num_layers=6, num_heads=8, max_length=256, dropout=0.1)
BOS, EOS = 1, 2


def nmt_batch(B, Ls, V, seed=0, lo=16):
    """The example's copy task at Ls source positions: sources of random
    lengths in [lo, Ls] of tokens in [3, V), padded with 0;
    tgt_in = BOS + source, tgt_out = source + EOS, padded with 0 to Ls + 1
    positions. Returns numpy (src, tgt_in, tgt_out, src_valid)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, Ls + 1, B)
    src = np.zeros((B, Ls), np.int32)
    tgt_in = np.zeros((B, Ls + 1), np.int32)
    tgt_out = np.zeros((B, Ls + 1), np.int32)
    for b, n in enumerate(lens):
        toks = rng.randint(3, V, n)
        src[b, :n] = toks
        tgt_in[b, 0], tgt_in[b, 1:n + 1] = BOS, toks
        tgt_out[b, :n], tgt_out[b, n] = toks, EOS
    return src, tgt_in, tgt_out, lens.astype(np.float32)


def nmt_flash_phase(dev, B=64, H=8, Ls=64, D=64, seed=3):
    """The flash forward, dq and dkv at the Transformer NMT's three
    attention shapes (phase 17's batch: bf16, B 64, H 8, D 64, sources of
    16-64 valid tokens): the encoder's (B,H,64,64) with the padding bias,
    the decoder's causal (B,H,65,64), cross-attention q (B,H,65,64) over
    k/v (B,H,64,64) with the bias. Each against its plain version on the
    same inputs, then timed beside SDPA with the same mask. The bound
    counts the (q, k) pairs this data needs: valid keys only, the causal
    triangle. Returns {row: {"nmt_shape": {attention: fields}}}."""
    import numpy as np
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    lens = torch.from_numpy(nmt_batch(B, Ls, 37000)[3]).to(dev)
    rng = np.random.RandomState(seed)

    def rand(L):
        return torch.tensor(rng.randn(B, H, L, D), dtype=torch.bfloat16,
                            device=dev)

    keys = torch.arange(Ls, device=dev)[None, :] < lens[:, None]
    pad_bias = torch.where(keys, 0.0, -1e30).float().contiguous()
    valid = float(keys.sum())
    cases = {"encoder": (Ls, Ls, False, pad_bias, valid * Ls),
             "decoder": (Ls + 1, Ls + 1, True,
                         torch.zeros((B, Ls + 1), device=dev),
                         B * (Ls + 1) * (Ls + 2) / 2),
             "cross": (Ls + 1, Ls, False, pad_bias, valid * (Ls + 1))}
    out = {"flash_attention_fwd": {}, "flash_attention_dq": {},
           "flash_attention_dkv": {}}
    for name, (Lq, Lk, causal, bias, pairs) in cases.items():
        q, g = rand(Lq), rand(Lq)
        k, v = rand(Lk), rand(Lk)
        o, lse = fa.flash_fwd(q, k, v, bias, causal)
        ro, rlse = fa.flash_fwd_reference(q, k, v, bias, causal)
        e_fwd = max(max_err(o, ro), max_err(lse, rlse))
        check(e_fwd <= TOL["flash"]["bfloat16"],
              f"flash fwd NMT {name}: max_abs_err {e_fwd}")
        delta = (g.float() * ro.float()).sum(-1).reshape(B * H, Lq)
        bw = (q, k, v, bias, g, rlse, delta, causal, None, 0.0, 0)
        ref = fa.flash_bwd_reference(*bw)
        tol = TOL_BWD["bfloat16"] * max(float(x.float().abs().max())
                                        for x in ref)
        e_dq = max_err(fa.flash_bwd_dq(*bw), ref[0])
        dk, dv = fa.flash_bwd_dkv(*bw)
        e_dkv = max(max_err(dk, ref[1]), max_err(dv, ref[2]))
        check(max(e_dq, e_dkv) <= tol,
              f"flash bwd NMT {name}: dq {e_dq}, dkv {e_dkv} > {tol}")
        del o, lse, ro, ref, dk, dv
        sdpa_kw = {"is_causal": True} if causal else {
            "attn_mask": keys[:, None, None, :]}

        def sdpa():
            return tF.scaled_dot_product_attention(q, k, v, **sdpa_kw)

        lib_fwd = (time_ms(sdpa), device_ms(sdpa, skip=FLUSH_ONLY))
        lib_bwd = sdpa_backward_ms(q, k, v, g, **sdpa_kw)
        es, BH = q.element_size(), B * H
        side = 4 * B * Lk + 8 * BH * Lq            # bias; LSE and delta
        shape = (f"q/dO ({B},{H},{Lq},{D}), k/v ({B},{H},{Lk},{D}) bf16, "
                 + ("causal" if causal else "padding bias of sources "
                    "16-64 long") + ", dropout 0")
        for row, err, nbytes, flops, fn, plain, lib in (
                ("flash_attention_fwd", e_fwd,
                 BH * D * es * (2 * Lq + 2 * Lk) + 4 * B * Lk + 4 * BH * Lq,
                 4 * pairs * H * D,
                 lambda: fa.flash_fwd(q, k, v, bias, causal),
                 lambda: fa.flash_fwd_reference(q, k, v, bias, causal),
                 lib_fwd),
                ("flash_attention_dq", e_dq,
                 BH * D * es * (3 * Lq + 2 * Lk) + side, 6 * pairs * H * D,
                 lambda: fa.flash_bwd_dq(*bw),
                 lambda: fa.flash_dq_reference(*bw), lib_bwd),
                ("flash_attention_dkv", e_dkv,
                 BH * D * es * (2 * Lq + 4 * Lk) + side, 8 * pairs * H * D,
                 lambda: fa.flash_bwd_dkv(*bw),
                 lambda: fa.flash_dkv_reference(*bw), lib_bwd)):
            b_ms, b_by = bound(nbytes, flops)
            out[row][name] = dict(
                shapes=shape, max_abs_err=err, ms=time_ms(fn),
                device_ms=device_ms(fn, match="mxt::"),
                plain_ms=time_ms(plain, iters=5),
                plain_device_ms=device_ms(plain, iters=5, skip=FLUSH_ONLY),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib[0],
                library_device_ms=lib[1],
                library=("SDPA forward" if row.endswith("fwd") else
                         "SDPA backward alone (dq, dk and dv together)")
                + (", is_causal" if causal else ", boolean key mask"))
        out["flash_attention_dq"][name]["tol"] = tol
        out["flash_attention_dkv"][name]["tol"] = tol
    return {row: {"nmt_shape": v} for row, v in out.items()}


class EagerLoop:
    """MXNet's training loop as `timed_steps` drives a trainer:

        with autograd.record():
            logits = model(src, tgt_in, src_valid)
            loss = label_smoothing_loss(logits, tgt_out)
        loss.backward()
        trainer.step(1)

    `step((src, tgt_in, src_valid), (tgt_out,))` takes NDArrays and
    returns the loss NDArray (not synchronised)."""

    def __init__(self, model, trainer):
        self.model, self.trainer = model, trainer

    def step(self, data, labels):
        from mxnet_tpu_torch import autograd
        from mxnet_tpu_torch.models.transformer import label_smoothing_loss
        src, tgt_in, valid = data
        with autograd.record():
            logits = self.model(src, tgt_in, valid)
            loss = label_smoothing_loss(logits, labels[0])
        loss.backward()
        self.trainer.step(1)
        return loss


def nmt_arrays(batch, ctx):
    """The batch as NDArrays on ctx: ([src, tgt_in, src_valid],
    [tgt_out])."""
    from mxnet_tpu_torch import nd
    src, tgt_in, tgt_out, valid = (nd.array(a, ctx=ctx) for a in batch)
    return [src, tgt_in, valid], [tgt_out]


def build_nmt(cfg, seed, device, dtype=None):
    """TransformerNMT(**cfg) on `device`: `random.seed(seed)`,
    `initialize()`, then `cast(dtype)` when given."""
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import transformer
    model = transformer.TransformerNMT(**cfg, device=device)
    mxrandom.seed(seed, device)
    model.initialize()
    return model.cast(dtype) if dtype else model


def nmt_train_phase(dev, batch=64, src_len=64, warmup=2, steps=16,
                    **cfg_overrides):
    """Phase 17: Transformer base (Vaswani et al. 2017, Table 3 "base":
    `TransformerNMT`'s defaults, the paper's shared 37,000-token BPE
    vocabulary) built in float32 from seed 0 and cast to bfloat16, trained
    by the eager loop with `gluon.Trainer(params, "adam", {lr 1e-3, beta2
    0.98, epsilon 1e-9})` on one repeated copy-task batch of 64 sources of
    16-64 tokens (padded to 64, `src_valid` passed) against targets of 65
    positions. Returns (result dict, launch counts of the timed steps,
    the trained model)."""
    import numpy as np
    from mxnet_tpu_torch import gluon
    cfg = dict(NMT_BASE, **cfg_overrides)
    model = build_nmt(cfg, 0, dev, "bfloat16")
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": 1e-3, "beta2": 0.98,
                             "epsilon": 1e-9})
    n_params = len(trainer._params)
    batch_np = nmt_batch(batch, src_len, cfg["tgt_vocab"])
    data, labels = nmt_arrays(batch_np, dev)
    losses, counts, timing = timed_steps(EagerLoop(model, trainer), data,
                                         labels, warmup, steps)
    check(np.isfinite(losses).all(), f"NMT training losses {losses}")
    check(losses[-1] < losses[0], f"NMT loss did not fall: {losses}")
    L = cfg["num_layers"]
    want = expect(flash_attention_fwd=3 * L * steps,
                  flash_attention_dq=3 * L * steps,
                  flash_attention_dkv=3 * L * steps,
                  adam_update=adam_launches(trainer._params) * steps)
    check(counts == want, f"NMT training launches {counts} != {want}")
    real = int((batch_np[2] != 0).sum())
    res = {"model": "TransformerNMT(37000, 37000, units 512, hidden 2048, "
                    f"{L} + {L} layers, 8 heads, dropout 0.1), "
                    "cast('bfloat16')",
           "batch": batch, "src_len": src_len, "tgt_positions": src_len + 1,
           "real_target_tokens_per_step": real,
           "optimizer": "gluon.Trainer adam lr 1e-3, beta2 0.98, eps 1e-9",
           "trainable_parameters": n_params,
           "param_count": sum(p.numel() for p in trainer._params),
           "target_tokens_per_s": real * steps / timing["seconds"],
           "target_positions_per_s":
               batch * (src_len + 1) * steps / timing["seconds"],
           "launches_per_step": {k: v // steps for k, v in counts.items()
                                 if v},
           "losses": losses, **timing}
    return res, counts, model


def decode_run(model, fn, **kw):
    """One decode call (`greedy_decode` or `beam_search`) timed, then the
    same under torch.profiler, recording the card's kernels alone (the
    host's ~35,000 op events a call took a minute to summarise): (tokens,
    {ms per step, idle share, launch counts})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    toks = fn(**kw)
    secs = time.perf_counter() - t0
    counts = read_counts()
    n_steps = toks.shape[1] - 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn(**kw)
        prof_ms = (time.perf_counter() - t1) * 1e3
    busy_ms, top, by_class, kernels = device_profile(prof, 1, 8)
    return toks, {"decode_steps": n_steps, "seconds": secs,
                  "ms_per_step": secs * 1e3 / n_steps,
                  "profiled_ms": prof_ms, "device_busy_ms": busy_ms,
                  "device_idle_share": None if busy_ms is None
                  else 1 - busy_ms / (secs * 1e3),
                  "kernels": kernels, "top_device_ms": top,
                  "launches": {k: v for k, v in counts.items() if v}}


def nmt_decode_phase(model, dev, n=16, src_len=64):
    """Phase 18, first half: phase 17's bf16 model decodes 16 sources of
    16-64 tokens greedily and by beam search (beam 4, alpha 0.6) at the
    default max_len (2 x 64 + 8 = 136); each call encodes once, so it
    launches exactly num_layers flash forwards and no other repo kernel.
    Eighteen steps into the copy task the model ranks EOS (the commonest
    target token) first everywhere, so with eos=2 a decode would stop
    after a step or two: the calls pass eos=-1, which no row emits, and
    run every step to max_len."""
    import numpy as np
    from mxnet_tpu_torch import nd
    src, _, _, valid = nmt_batch(n, src_len, 37000, seed=1)
    L = len(model.encoder)
    max_len = 2 * src_len + 8
    out = {}
    for name, fn, kw in (("greedy", model.greedy_decode, {}),
                         ("beam4", model.beam_search,
                          {"beam": 4, "alpha": 0.6})):
        toks, res = decode_run(model, fn, src_tokens=nd.array(src, ctx=dev),
                               src_valid=nd.array(valid, ctx=dev), eos=-1,
                               **kw)
        check(toks.shape == (n, max_len) and (toks[:, 0] == BOS).all()
              and ((toks >= 0) & (toks < 37000)).all(),
              f"NMT {name} tokens {toks.shape}")
        check(res["launches"] == {"flash_attention_fwd": L},
              f"NMT {name} launches {res['launches']}")
        out[name] = res
    return out


def nmt_parity_phase(dev, steps=3, batch=8, src_len=24, n_dec=4, lr=1e-3):
    """Phase 18, second half: a float32 TransformerNMT at full width and
    vocabulary, 2 + 2 layers, dropout 0, trained `steps` eager Adam steps
    on the card and on the CPU from the same weights: losses and every
    parameter within TOL_TRAIN; then greedy and beam-4 tokens of 4
    sources equal on the card and on the CPU, and beam 1 equal to greedy.
    Adam runs at epsilon 1e-4. Where a ReLU unit's input lies within
    float32 rounding of 0 at some position, the two devices can gate it
    differently, and that unit's weights get gradients that differ by
    that position's share (a few 1e-6); a key projection's bias has a
    gradient of float32 noise (zero in exact arithmetic). At epsilon
    1e-8 Adam turns such a gradient into a step of about lr of the
    noise's sign, so the two devices' weights part by up to 2 lr a step
    there (0.003 after 3 steps at lr 1e-3); at 1e-4 those steps shrink
    to about 1e-6 while a gradient of 1e-3 still steps a quarter of lr
    at the first step."""
    import numpy as np
    from mxnet_tpu_torch import gluon, weights
    from mxnet_tpu_torch.models import transformer
    cfg = dict(NMT_BASE, num_layers=2, dropout=0.0)
    arrays = {k: p.detach().numpy().copy() for k, p in
              build_nmt(cfg, 7, "cpu").collect_params().items()}
    batch_np = nmt_batch(batch, src_len, cfg["tgt_vocab"], seed=4, lo=8)
    dsrc, _, _, dvalid = nmt_batch(n_dec, src_len, cfg["tgt_vocab"], seed=5,
                                   lo=8)
    runs = {}
    for where in ("cpu", dev):
        model = transformer.TransformerNMT(**cfg, device=where)
        weights.load_named_arrays(model, arrays)
        tr = gluon.Trainer(model.collect_params(), "adam",
                           {"learning_rate": lr, "epsilon": 1e-4})
        loop = EagerLoop(model, tr)
        data, labels = nmt_arrays(batch_np, where)
        reset_counts()
        losses = [float(loop.step(data, labels)) for _ in range(steps)]
        counts = read_counts()
        params = {k: p.detach().cpu() for k, p in
                  model.collect_params().items()}
        toks = {"greedy": model.greedy_decode(dsrc, src_valid=dvalid),
                "beam4": model.beam_search(dsrc, beam=4, src_valid=dvalid),
                "beam1": model.beam_search(dsrc, beam=1, src_valid=dvalid)}
        runs[str(where)] = (losses, params, counts, toks,
                            adam_launches(tr._params))
        del model, tr
    (lc, pc, cc, tc, _), (lg, pg, counts, tg, n) = runs["cpu"], \
        runs[str(dev)]
    e_loss = float(np.abs(np.subtract(lg, lc)).max())
    e_w = max(max_err(pg[k], pc[k]) for k in pc)
    check(e_loss <= TOL_TRAIN and e_w <= TOL_TRAIN,
          f"NMT card vs CPU: losses {lg} vs {lc}, param err {e_w}")
    L = cfg["num_layers"]
    want = expect(flash_attention_fwd=3 * L * steps,
                  flash_attention_dq=3 * L * steps,
                  flash_attention_dkv=3 * L * steps, adam_update=n * steps)
    check(counts == want, f"NMT parity launches {counts} != {want}")
    check(all(v == 0 for v in cc.values()), f"CPU run launched {cc}")
    for name in tg:
        check(np.array_equal(tg[name], tc[name]),
              f"NMT {name} tokens card {tg[name].tolist()} != CPU "
              f"{tc[name].tolist()}")
    check(np.array_equal(tg["beam1"], tg["greedy"]),
          f"NMT beam 1 {tg['beam1'].tolist()} != greedy "
          f"{tg['greedy'].tolist()}")
    return {"losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_param_err": e_w, "parameters": len(pc),
            "decode_shapes": {k: list(v.shape) for k, v in tg.items()}}


# ---------------------------------------------------------------------------
# phases 19-22: detection (YOLOv3-tiny and SSD) through the eager Gluon loop
# ---------------------------------------------------------------------------

VOC_CLASSES = 20


def detection_batch(dev, B, size, n_cls=VOC_CLASSES, G=16, seed=0,
                    normalized=False):
    """A seeded VOC-like batch: (B, 3, size, size) float32 images of
    low noise with 1-4 boxes each painted in a colour of their class,
    and the boxes (B, G, 4) corner (pixels, or [0, 1] when `normalized`)
    with their labels (B, G), padded with -1 rows. Images are made on the
    device; boxes and labels are numpy."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    imgs = 0.1 * torch.rand((B, 3, size, size), generator=gen, device=dev)
    colours = torch.tensor(np.random.RandomState(99).rand(n_cls, 3),
                           dtype=torch.float32, device=dev)
    boxes = np.full((B, G, 4), -1.0, np.float32)
    labels = np.full((B, G), -1.0, np.float32)
    for b in range(B):
        for g in range(rng.randint(1, 5)):
            w, h = rng.randint(size // 10, size // 2, 2)
            x, y = rng.randint(0, size - w), rng.randint(0, size - h)
            c = rng.randint(0, n_cls)
            imgs[b, :, y:y + h, x:x + w] = colours[c][:, None, None]
            boxes[b, g] = (x, y, x + w, y + h)
            labels[b, g] = c
    if normalized:
        boxes = np.where(labels[..., None] >= 0, boxes / size, -1.0) \
            .astype(np.float32)
    return imgs, boxes, labels


class YoloLoop:
    """examples/detection/train_yolo.py's step, as `timed_steps` drives a
    trainer:

        targets = yolo_targets(model, boxes, labels)
        with autograd.record():
            loss = yolo_loss(model(imgs), targets, num_classes)
        loss.backward()
        trainer.step(1)

    `step((imgs,), (boxes, labels))` takes NDArrays and returns the loss
    NDArray (not synchronised)."""

    def __init__(self, model, trainer):
        self.model, self.trainer = model, trainer

    def step(self, data, labels):
        from mxnet_tpu_torch import autograd
        from mxnet_tpu_torch.models import yolo
        targets = yolo.yolo_targets(self.model, *labels)
        with autograd.record():
            loss = yolo.yolo_loss(self.model(data[0]), targets,
                                  self.model.num_classes)
        loss.backward()
        self.trainer.step(1)
        return loss


class SsdLoop:
    """The SSD step in the same loop: `multibox_target` on the anchors,
    then `MultiBoxLoss` (hard negatives 3:1) of the recorded forward.
    `step((imgs,), (boxes, labels))`: boxes normalised corner, labels
    int."""

    def __init__(self, model, trainer, anchors):
        from mxnet_tpu_torch.models import ssd
        self.model, self.trainer, self.anchors = model, trainer, anchors
        self.loss_fn = ssd.MultiBoxLoss()

    def step(self, data, labels):
        from mxnet_tpu_torch import autograd
        from mxnet_tpu_torch.models import ssd
        cls_t, box_t, mask = ssd.multibox_target(self.anchors, *labels)
        with autograd.record():
            cls_p, box_p, _ = self.model(data[0])
            loss = self.loss_fn(cls_p, box_p, cls_t, box_t, mask)
        loss.backward()
        self.trainer.step(1)
        return loss


def build_detector(make, seed, device, dtype=None, probe=(1, 3, 64, 64)):
    """make(device) from `random.seed(seed)`, `initialize()`, one no-grad
    probe forward that completes the deferred shapes, then `cast(dtype)`
    when given."""
    import torch
    from mxnet_tpu_torch import random as mxrandom
    model = make(device)
    mxrandom.seed(seed, device)
    model.initialize()
    with torch.no_grad():
        model(torch.zeros(probe, device=device))
    return model.cast(dtype) if dtype else model


def detection_train(loop, model, trainer, batch, warmup, steps):
    """timed_steps over one fixed batch: (losses, counts, timing)."""
    import numpy as np
    data, labels = batch
    losses, counts, timing = timed_steps(loop, data, labels, warmup, steps)
    check(np.isfinite(losses).all(), f"{type(model).__name__} losses "
          f"{losses}")
    check(losses[-1] < losses[0], f"{type(model).__name__} loss did not "
          f"fall: {losses}")
    want = expect(adam_update=adam_launches(trainer._params) * steps)
    check(counts == want, f"{type(model).__name__} training launches "
          f"{counts} != {want}")
    return losses, counts, timing


def yolo_train_phase(dev, batch=64, size=416, warmup=2, steps=16):
    """Phase 19: YOLOv3-tiny at GluonCV's `yolo3_tiny` widths on VOC's 20
    classes (`YOLOv3Tiny(20, 416)`, the JAX package's defaults), random
    weights from seed 0, cast to bfloat16, trained by the example's
    eager loop (`yolo_targets`, `autograd.record()`, `yolo_loss`,
    `backward()`, `gluon.Trainer(..., "adam", {lr 1e-3}).step(1)`) at
    GluonCV `train_yolo3.py`'s batch of 64 on one fixed synthetic batch
    (1-4 boxes an image, padded to 16): 2 warm-up + 16 timed steps, one
    profiled; exactly one Adam launch per weight dtype a step.
    Returns (result, counts, model)."""
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.models import yolo
    model = build_detector(lambda d: yolo.YOLOv3Tiny(VOC_CLASSES, size,
                                                     device=d), 0, dev,
                           "bfloat16")
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    n_params = len(trainer._params)
    check(n_params == 34, f"YOLOv3-tiny trainable parameters {n_params}")
    imgs, boxes, labels = detection_batch(dev, batch, size)
    data = ([nd.array(imgs, ctx=dev)],
            [nd.array(boxes, ctx=dev), nd.array(labels, ctx=dev)])
    losses, counts, timing = detection_train(
        YoloLoop(model, trainer), model, trainer, data, warmup, steps)
    res = {"model": f"YOLOv3Tiny({VOC_CLASSES}, {size}), cast('bfloat16')",
           "batch": batch, "image_size": size,
           "gt_boxes": int((labels >= 0).sum()),
           "optimizer": "gluon.Trainer adam lr 1e-3",
           "trainable_parameters": n_params,
           "param_count": sum(p.numel() for p in trainer._params),
           "images_per_s": batch * steps / timing["seconds"],
           "launches_per_step": {k: v // steps for k, v in counts.items()
                                 if v},
           "loss_ratio_last_first": losses[-1] / losses[0],
           "losses": losses, **timing}
    return res, counts, model


def events_once(fn):
    """(fn(), CUDA-event ms of the one call), the L2 flushed first."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush.zero_()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def nms_pair(run):
    """Run `run()` (a decode whose NMS calls `box_nms_keep` once) through
    the kernel, then again with the plain version patched in. Returns
    (kernel output, plain output, kernel keep, plain keep, the keep
    call's arguments, plain ms: CUDA events around the plain call)."""
    import torch
    from mxnet_tpu_torch.cuda_ops import box_nms as bn
    from mxnet_tpu_torch.ops import detection_ops
    seen = {}

    def kernel(*a, **kw):
        seen["kernel"], seen["args"] = bn.box_nms_keep(*a, **kw), (a, kw)
        return seen["kernel"]

    def plain(*a, **kw):
        seen["plain"], seen["plain_ms"] = events_once(
            lambda: bn.box_nms_keep_reference(*a, **kw))
        return seen["plain"]

    real = detection_ops.box_nms_keep
    try:
        detection_ops.box_nms_keep = kernel
        out_k = run()
        detection_ops.box_nms_keep = plain
        out_p = run()
    finally:
        detection_ops.box_nms_keep = real
    torch.cuda.synchronize()
    return (out_k, out_p, seen["kernel"], seen["plain"], seen["args"],
            seen["plain_ms"])


NMS_PAIR_FLOPS = 15       # float32 operations of one IoU test (corner_iou)


def nms_work(valid, ids, keep, max_keep):
    """(bytes, pairs) that greedy NMS (n_suppressors = N) needs on these
    inputs, given its keep mask. Bytes: each image's boxes, valid flags
    and class ids up to its cut (its max_keep-th survivor, else its last
    valid row) read once, and the keep mask written for every row.
    Pairs: each kept row tested against every earlier kept row of its
    class, and each suppressed valid row before the cut against one
    suppressor (its first)."""
    import torch
    B, N = keep.shape
    row = torch.arange(1, N + 1, device=keep.device)
    cut = (valid * row).amax(1)
    if max_keep is not None:
        kth = (((keep.cumsum(1) == max_keep) & keep) * row).amax(1)
        cut = torch.where(kth > 0, kth, cut)
    nbytes = int(cut.sum()) * (16 + 1 + (4 if ids is not None else 0)) \
        + B * N
    cls = torch.zeros_like(row).expand(B, N) if ids is None \
        else torch.unique(ids, return_inverse=True)[1]
    per_class = torch.zeros((B, int(cls.max()) + 1), dtype=torch.long,
                            device=keep.device).scatter_add_(
        1, cls, keep.long())
    pairs = int((per_class * (per_class - 1) // 2).sum()) \
        + int((valid & ~keep & (row <= cut[:, None])).sum())
    return nbytes, pairs


def nms_check(name, run):
    """Hold the kernel against the plain version in one decode, bit for
    bit in the keep mask and in the output rows: the decode's own call
    (the top-k path: `max_keep` is its topk) and, on the same inputs,
    the call without `max_keep` (the general path). Then time the kernel
    on both (device time of the kernel alone and CUDA events around the
    wrapper, L2 flushed) beside the bound of what these inputs need
    (`nms_work`: bytes at HBM_BYTES_PER_S, pairs at F32_FLOPS), with
    both shares. Returns the case's fields."""
    import torch
    from mxnet_tpu_torch.cuda_ops import box_nms as bn
    out_k, out_p, keep_k, keep_p, (a, kw), plain_ms = nms_pair(run)
    out_k, out_p = (o._t if hasattr(o, "_t") else o for o in (out_k, out_p))
    check(torch.equal(keep_k, keep_p), f"box_nms {name}: keep masks differ "
          f"in {int((keep_k != keep_p).sum())} rows")
    check(torch.equal(out_k, out_p), f"box_nms {name}: output rows differ")
    check(kw.get("max_keep") is not None, f"box_nms {name}: {kw}")
    general = {**kw, "max_keep": None}
    keep_g = bn.box_nms_keep(*a, **general)
    plain_g, plain_g_ms = events_once(
        lambda: bn.box_nms_keep_reference(*a, **general))
    check(torch.equal(keep_g, plain_g), f"box_nms {name} without max_keep: "
          f"keep masks differ in {int((keep_g != plain_g).sum())} rows")
    boxes, valid, ids = a[0], a[1], a[2]
    B, N, _ = boxes.shape
    per = "per class" if ids is not None else "any class"
    res = {"shape": f"({B}, {N}) rows, {per}",
           "valid_rows": int(valid.sum()),
           "max_abs_err": max_err(out_k, out_p),
           "keep_mismatches": int((keep_k != keep_p).sum())
           + int((keep_g != plain_g).sum())}
    for path, args, keep, p_ms in (("topk", kw, keep_k, plain_ms),
                                   ("general", general, keep_g, plain_g_ms)):
        fn = lambda: bn.box_nms_keep(*a, **args)               # noqa: E731
        ms = device_ms(fn, match="box_nms", skip=FLUSH_ONLY, per_kernel=True)
        nbytes, pairs = nms_work(valid, ids, keep, args["max_keep"])
        b_ms, b_by = bound(nbytes, NMS_PAIR_FLOPS * pairs, F32_FLOPS)
        res[path] = {
            "max_keep": args["max_keep"], "kept_rows": int(keep.sum()),
            "ms": ms, "event_ms": time_ms(fn), "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "pairs": pairs,
            "bytes_share": nbytes / HBM_BYTES_PER_S * 1e3 / ms,
            "operations_share": NMS_PAIR_FLOPS * pairs / F32_FLOPS * 1e3
            / ms}
    return res


# the barriers of box_nms_keep_kernel in source order, named by the phase
# each ends, then the tail after the chunk loop
NMS_PHASES = ("set-up", "last valid row", "stage chunk 0", "class rank",
              "cross test", "bitmask", "scan", "kept list, keep bytes, "
              "next stage", "tail (zero fill)")


def nms_phase_library():
    """An instrumented copy of csrc/box_nms.cu, built beside the kernel
    library: after each block barrier (and after the chunk loop), thread
    0 of every block adds the clock64() cycles since the previous one to
    that block's counter of the phase the barrier ends. Returns its
    ctypes library: `mx_box_nms_keep` as the kernel library's, and
    `nms_phase_read(out)` / `nms_phase_clear()` for the (512, 16) uint64
    counters."""
    import ctypes
    import re
    from mxnet_tpu_torch.cuda_ops import _build
    with open(os.path.join(_build.CSRC, "box_nms.cu")) as fh:
        src = fh.read()
    n = [0]

    def tick(m):
        n[0] += 1
        return f"{m.group(0)} NMS_TICK({n[0] - 1});"
    src = re.sub(r"__syncthreads\(\);", tick, src)
    check(n[0] == len(NMS_PHASES) - 1, f"box_nms.cu has {n[0]} barriers, "
          f"NMS_PHASES names {len(NMS_PHASES) - 1}")
    tail = ("  for (int j = end + t; j < N; j += NMS_THREADS) "
            "keep_out[base + j] = 0;")
    check(tail in src, "box_nms.cu: the tail loop moved")
    src = src.replace(tail, f"{tail}\n  __syncthreads(); NMS_TICK({n[0]});")
    src = src.replace(
        "  extern __shared__ __align__(16) unsigned char smem_raw[];",
        "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
        "  long long tick_ = clock64();")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n'
                      "__device__ unsigned long long g_phase[512][16];\n"
                      "#define NMS_TICK(p) if (threadIdx.x == 0) { long long "
                      "now_ = clock64(); g_phase[blockIdx.x][p] += now_ - "
                      "tick_; tick_ = now_; }")
    src += ('\nextern "C" int nms_phase_read(void* out) { return '
            "cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)); }\n"
            'extern "C" int nms_phase_clear() { static unsigned long long '
            "z[512][16];\n  return cudaMemcpyToSymbol(g_phase, z, sizeof(z)); "
            "}\n")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "box_nms_phases.cu")
    lib = os.path.join(_build.BUILD_DIR, "libbox_nms_phases.so")
    with open(cu, "w") as fh:
        fh.write(src)
    r = subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", "-I",
                        _build.CSRC, "-o", lib, cu], capture_output=True,
                       text=True, timeout=600)
    check(r.returncode == 0, f"instrumented box_nms build: {r.stdout[-3000:]}")
    return ctypes.CDLL(lib)


def nms_phase_cycles(dev):
    """`--nms-phases`: where box_nms_keep_kernel's time goes, by phase, on
    the NMS inputs of phases 20 and 21 (YOLOv3-tiny trained as phase 19,
    its decode's (64, 2,535) rows; SSD trained as phase 21, its
    `multibox_detection`'s (32, 30,120) rows), each with the decode's
    max_keep and without. The wrapper runs the instrumented copy
    (`nms_phase_library`) in place of the kernel; its keep mask must
    equal the kernel's. Per case: CUDA-event ms of the instrumented
    call, the slowest block's cycles, and each phase's cycles in that
    block and on average over the blocks."""
    import ctypes
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.cuda_ops import box_nms as bn
    from mxnet_tpu_torch.models import yolo
    from mxnet_tpu_torch.ops import detection_ops
    lib = nms_phase_library()
    calls, real = {}, detection_ops.box_nms_keep

    def capture(name, run):
        def keep(*a, **kw):
            calls[name] = (a, kw)
            return real(*a, **kw)
        detection_ops.box_nms_keep = keep
        try:
            run()
        finally:
            detection_ops.box_nms_keep = real
        return {}

    _, _, model = yolo_train_phase(dev)
    imgs, _, _ = detection_batch(dev, 64, 416, seed=1)
    with autograd.pause():
        preds = model(nd.array(imgs, ctx=dev))
    capture("yolo_decode", lambda: yolo.decode_predictions(model, preds))
    del model, preds
    torch.cuda.empty_cache()
    plain_check = nms_check
    globals()["nms_check"] = capture
    try:
        ssd_train_phase(dev)
    finally:
        globals()["nms_check"] = plain_check
    calls["ssd_multibox_detection"] = calls.pop("SSD multibox_detection")
    out = {}
    for name, (a, kw) in calls.items():
        check(a[0].shape[0] <= 512, f"{name}: more images than counters")
        for path, args in (("topk", kw), ("general", {**kw,
                                                      "max_keep": None})):
            want = bn.box_nms_keep(*a, **args)
            entry = bn._fns["mx_box_nms_keep"]
            inst = lib.mx_box_nms_keep
            inst.restype, inst.argtypes = entry.restype, entry.argtypes
            bn._fns["mx_box_nms_keep"] = inst
            try:
                check(torch.equal(bn.box_nms_keep(*a, **args), want),
                      f"instrumented box_nms {name} {path}: keep differs")
                check(lib.nms_phase_clear() == 0, "nms_phase_clear")
                _, ms = events_once(lambda: bn.box_nms_keep(*a, **args))
            finally:
                bn._fns["mx_box_nms_keep"] = entry
            buf = (ctypes.c_ulonglong * (512 * 16))()
            check(lib.nms_phase_read(buf) == 0, "nms_phase_read")
            B = a[0].shape[0]
            cyc = np.ctypeslib.as_array(buf).astype(np.float64) \
                .reshape(512, 16)[:B, :len(NMS_PHASES)]
            slow = int(cyc.sum(1).argmax())
            total = float(cyc[slow].sum())
            out[f"{name}/{path}"] = {
                "max_keep": args["max_keep"], "event_ms": ms,
                "slowest_block_cycles": total,
                "phases": {ph: {"slowest_block_cycles": float(cyc[slow, i]),
                                "share": float(cyc[slow, i]) / total,
                                "mean_cycles": float(cyc[:, i].mean())}
                           for i, ph in enumerate(NMS_PHASES)}}
            print(f"chip_smoke: box_nms phases {name}/{path} "
                  + json.dumps(out[f"{name}/{path}"]), flush=True)
    return out


def decode_profile(fn, n_top=8):
    """One decode call (ending in a host fetch) under torch.profiler
    (`profile_once`): device busy, idle share, kernels, device ms by
    class, the top kernels and the top host ops."""
    prof, ms, windows = profile_once(fn)
    busy, top, by_class, kernels = device_profile(prof, 1, n_top)
    host_top, _ = host_profile(prof, 1, n_top)
    return {"call_ms": ms, "profile_windows": windows,
            "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / ms,
            "kernels": kernels, "device_ms_by_class": by_class,
            "top_device_ms": top, "top_host_self_ms": host_top}


def yolo_decode_phase(model, dev, batch=64, size=416):
    """Phase 20: phase 19's model decodes a held-out synthetic batch
    (`decode_predictions`: id_index 0, conf_thresh 0.1, topk 100, NMS
    0.45, on the (64, 2,535, 6) rows of its two heads) under
    `autograd.pause()`: exactly one box_nms launch a decode; VOC07 mAP of
    the detections; one decode call under torch.profiler; then the
    kernel against its plain version on that call and with
    force_suppress, on the top-k path and the general one (`nms_check`)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, metric, nd
    from mxnet_tpu_torch.models import yolo
    from mxnet_tpu_torch.ops import detection_ops
    imgs, boxes, labels = detection_batch(dev, batch, size, seed=1)
    with autograd.pause():
        preds = model(nd.array(imgs, ctx=dev))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    det = yolo.decode_predictions(model, preds)
    d = det.asnumpy()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check(counts == expect(box_nms=1), f"YOLO decode launches {counts}")
    n_rows = 3 * ((size // 32) ** 2 + (size // 16) ** 2)
    check(d.shape == (batch, n_rows, 6) and np.isfinite(d).all(),
          f"YOLO detections {d.shape}")
    check(((d[..., 1] > 0).sum(1) <= 100).all(), "YOLO decode topk")
    m = metric.VOC07MApMetric(iou_thresh=0.5)
    m.update(np.concatenate([labels[:, :, None], boxes], 2), d)
    voc = m.get()[1]
    check(0.0 <= voc <= 1.0 or np.isnan(voc), f"VOC07 mAP {voc}")
    prof = decode_profile(
        lambda: yolo.decode_predictions(model, preds).asnumpy())
    rows = yolo.decode_rows(model, preds)
    cases = {
        "yolo_decode": nms_check("YOLO decode", lambda: (
            yolo.decode_predictions(model, preds))),
        "yolo_force_suppress": nms_check("YOLO force_suppress", lambda: (
            detection_ops.box_nms(rows, overlap_thresh=0.45,
                                  valid_thresh=0.1, topk=100, id_index=0,
                                  force_suppress=True)))}
    return {"rows": list(d.shape), "decode_s": secs,
            "decode_profile": prof,
            "launches": {k: v for k, v in counts.items() if v},
            "detections_per_image": float((d[..., 1] > 0).sum(1).mean()),
            "voc07_map_held_out": voc, "gt_boxes": int((labels >= 0).sum())}, \
        cases


def ssd_train_phase(dev, batch=32, size=300, warmup=2, steps=16):
    """Phase 21: SSD (the JAX package's `SSD(20)`: channels 64-512, four
    scales of 4 anchors a position, 30,120 anchors at 300^2), random
    weights from seed 0, bfloat16, trained by the eager loop
    (`multibox_target`, `MultiBoxLoss` with hard negatives 3:1,
    `gluon.Trainer(..., "adam", {lr 1e-3})`) at GluonCV `train_ssd.py`'s
    batch of 32 on one fixed synthetic batch: 2 warm-up + 16 timed steps,
    one profiled. Then `multibox_detection` (threshold 0.01, NMS 0.45,
    nms_topk 400, GluonCV's SSD settings) of a held-out batch: exactly one
    box_nms launch; one detection call (and its copy to the host) under
    torch.profiler; the kernel against its plain version on that call's
    (32, 30,120, 6) rows, top-k path and general (`nms_check`). Returns
    (result, counts, nms case)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import detection_ops
    model = build_detector(lambda d: ssd.SSD(VOC_CLASSES, device=d), 0, dev,
                           "bfloat16")
    with torch.no_grad():
        feat = model(torch.zeros((1, 3, size, size), device=dev))[2]
    anchors = ssd.generate_anchors(feat, image_size=size)
    check(anchors.shape == (30120, 4), f"SSD anchors {anchors.shape}")
    trainer = gluon.Trainer(model.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    imgs, boxes, labels = detection_batch(dev, batch, size, seed=2,
                                          normalized=True)
    data = ([nd.array(imgs, ctx=dev)],
            [nd.array(boxes, ctx=dev),
             nd.array(labels.astype(np.int32), ctx=dev)])
    loop = SsdLoop(model, trainer, nd.array(anchors, ctx=dev))
    losses, counts, timing = detection_train(loop, model, trainer, data,
                                             warmup, steps)
    himgs, _, _ = detection_batch(dev, batch, size, seed=3)
    with autograd.pause():
        cls_p, box_p, _ = model(nd.array(himgs, ctx=dev))
    cls_prob = torch.softmax(cls_p._t.float(), -1).transpose(1, 2)
    loc = box_p._t.float().reshape(batch, -1)
    corner = ssd._corner(torch.from_numpy(anchors).to(dev))[None]

    def detect():
        return detection_ops.multibox_detection(
            cls_prob, loc, corner, threshold=0.01, nms_threshold=0.45,
            nms_topk=400)
    torch.cuda.synchronize()
    reset_counts()
    det = detect()
    dcounts = read_counts()
    check(dcounts == expect(box_nms=1), f"SSD detection launches {dcounts}")
    check(det.shape == (batch, 30120, 6) and bool(torch.isfinite(det).all()),
          f"SSD detections {tuple(det.shape)}")
    prof = decode_profile(lambda: detect().cpu())
    case = nms_check("SSD multibox_detection", detect)
    res = {"model": f"SSD({VOC_CLASSES}), channels (64, 128, 256, 512), "
                    "cast('bfloat16')",
           "batch": batch, "image_size": size, "anchors": len(anchors),
           "gt_boxes": int((labels >= 0).sum()),
           "optimizer": "gluon.Trainer adam lr 1e-3",
           "trainable_parameters": len(trainer._params),
           "param_count": sum(p.numel() for p in trainer._params),
           "images_per_s": batch * steps / timing["seconds"],
           "launches_per_step": {k: v // steps for k, v in counts.items()
                                 if v},
           "loss_ratio_last_first": losses[-1] / losses[0],
           "detections_per_image": float((det[..., 1] > 0).sum(1).float()
                                         .mean()),
           "detection_profile": prof, "losses": losses, **timing}
    return res, counts, case


def detection_parity_phase(dev, steps=3, lr=1e-3):
    """Phase 22: a float32 YOLOv3-tiny (64^2, 3 classes) and a float32 SSD
    (channels (8, 16), 3 classes, 64^2) trained `steps` eager Adam steps
    (epsilon 1e-4, as phase 18) on the card and on the CPU from the same
    weights: losses within 1e-5 relative (a loss near 10 sums some 10^5
    float32 terms in another order on each device: 1e-5 is about ten
    ulps), every parameter and running statistic within TOL_TRAIN, and
    the trained models' heads on held-out images reported. Detections
    then decode the CPU model's heads on both devices (YOLO
    `decode_predictions`; SSD `multibox_detection` of the class
    probabilities of one softmax; one box_nms launch on the card): class
    ids and suppressed rows equal, scores and boxes within 1e-5 relative
    (exp's and sigmoid's last bits differ between the devices).
    Each device decodes its own model's heads too, and the share of rows
    whose id or suppression differ is reported: near-equal scores can
    sort in another order once the weights differ by float32 noise."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, gluon, nd, weights
    from mxnet_tpu_torch.models import ssd, yolo
    from mxnet_tpu_torch.ops import detection_ops
    C, size = 3, 64
    out = {}
    for name in ("yolo", "ssd"):
        if name == "yolo":
            make = lambda d: yolo.YOLOv3Tiny(C, size, device=d)  # noqa: E731
        else:
            make = lambda d: ssd.SSD(C, channels=(8, 16), device=d)  # noqa
        arrays = {k: p.detach().numpy().copy() for k, p in
                  build_detector(make, 5, "cpu").collect_params().items()}
        imgs, boxes, labels = detection_batch("cpu", 8, size, n_cls=C, G=4,
                                              seed=6,
                                              normalized=name == "ssd")
        himgs, _, _ = detection_batch("cpu", 4, size, n_cls=C, G=4, seed=7)
        anchors = None
        runs = {}
        for where in ("cpu", dev):
            model = weights.load_named_arrays(make(where), arrays)
            tr = gluon.Trainer(model.collect_params(), "adam",
                               {"learning_rate": lr, "epsilon": 1e-4})
            if name == "yolo":
                loop = YoloLoop(model, tr)
                lab = [nd.array(boxes, ctx=where), nd.array(labels, ctx=where)]
            else:
                with torch.no_grad():
                    feat = model(torch.zeros((1, 3, size, size),
                                             device=where))[2]
                anchors = torch.from_numpy(ssd.generate_anchors(
                    feat, sizes=((0.2, 0.3), (0.4, 0.5))))
                loop = SsdLoop(model, tr, nd.array(anchors, ctx=where))
                lab = [nd.array(boxes, ctx=where),
                       nd.array(labels.astype(np.int32), ctx=where)]
            x = [nd.array(imgs, ctx=where)]
            reset_counts()
            losses = [float(loop.step(x, lab)) for _ in range(steps)]
            counts = read_counts()
            with autograd.pause():
                heads = [h._t for h in model(nd.array(himgs, ctx=where))
                         if isinstance(h, nd.NDArray)]
            runs[str(where)] = (losses, {k: p.detach().cpu() for k, p in
                                         model.collect_params().items()},
                                counts, heads, model,
                                adam_launches(tr._params))

        def detect(model, heads, where):
            if name == "yolo":
                return yolo.decode_predictions(
                    model, [h.to(where) for h in heads], conf_thresh=0.0,
                    topk=20)
            # the class probabilities from one softmax on the heads'
            # device: SSD's scores tie within an ulp often enough that
            # two devices' softmaxes would sort the rows differently
            cls_prob = torch.softmax(heads[0], -1).transpose(1, 2)
            return detection_ops.multibox_detection(
                cls_prob.to(where), heads[1].reshape(len(himgs), -1).to(where),
                ssd._corner(anchors.to(where))[None], threshold=0.05,
                nms_threshold=0.45)

        (lc, pc, cc, hc, mc, _), (lg, pg, cg, hg, mg, n) = \
            runs["cpu"], runs[str(dev)]
        e_loss = float((np.abs(np.subtract(lg, lc)) / np.abs(lc)).max())
        e_w = max(max_err(pg[k], pc[k]) for k in pc)
        check(e_loss <= 1e-5 and e_w <= TOL_TRAIN,
              f"{name} card vs CPU: losses {lg} vs {lc}, param err {e_w}")
        check(cg == expect(adam_update=n * steps),
              f"{name} parity launches {cg}")
        check(all(v == 0 for v in cc.values()), f"CPU run launched {cc}")
        dc = detect(mc, hc, "cpu")
        reset_counts()
        dg = detect(mg, hc, dev).cpu()
        counts = read_counts()
        check(counts == expect(box_nms=1), f"{name} decode launches {counts}")
        same_ids = torch.equal(dg[..., 0], dc[..., 0])
        same_keep = torch.equal(dg[..., 1] < 0, dc[..., 1] < 0)
        e_det = float(((dg - dc).abs() / dc.abs().clamp(min=1.0)).max())
        check(same_ids and same_keep and e_det <= 1e-5,
              f"{name} detections card vs CPU: ids equal {same_ids}, "
              f"suppressed rows equal {same_keep}, max rel err {e_det}")
        own = detect(mg, hg, dev).cpu()
        differ = ((own[..., 0] != dc[..., 0])
                  | ((own[..., 1] < 0) != (dc[..., 1] < 0)))
        out[name] = {"losses_card": lg, "losses_cpu": lc,
                     "max_loss_rel_err": e_loss, "max_param_err": e_w,
                     "parameters": len(pc),
                     "heads_max_err": max(max_err(a.cpu(), b)
                                          for a, b in zip(hg, hc)),
                     "detection_max_rel_err": e_det,
                     "detections_kept": int((dg[..., 1] > 0).sum()),
                     "own_heads_rows_differing": float(differ.float().mean())}
    return out


# ---------------------------------------------------------------------------
# phases 23-25: DeepAR and CRNN (gluon.rnn, the RNN op, CTC loss)
# ---------------------------------------------------------------------------

# GluonTS DeepAREstimator's defaults, the JAX model's: 40 cells, 2 layers,
# dropout 0.1, Gaussian output; context 24, horizon 12
DEEPAR = dict(num_cells=40, num_layers=2, context_length=24,
              prediction_length=12, dropout=0.1)
CRNN_GLYPHS = 5


def deepar_series(series, length, seed=0):
    """examples/timeseries/train_deepar.py's synthetic seasonal series:
    2 + sin(2πt/12) + 0.1 noise, (series, length) float32."""
    import numpy as np
    rng = np.random.RandomState(seed)
    t = np.arange(length)
    return (2.0 + np.sin(2 * np.pi * t / 12)[None, :]
            + 0.1 * rng.randn(series, length)).astype(np.float32)


class DeepARLoop:
    """examples/timeseries/train_deepar.py's step, as `timed_steps`
    drives a trainer:

        with autograd.record():
            loss = model.loss(target)
        loss.backward()
        trainer.step(1)

    `step((target,), ())` takes an NDArray and returns the loss NDArray
    (not synchronised)."""

    def __init__(self, model, trainer):
        self.model, self.trainer = model, trainer

    def step(self, data, labels):
        from mxnet_tpu_torch import autograd
        with autograd.record():
            loss = self.model.loss(data[0])
        loss.backward()
        self.trainer.step(1)
        return loss


def build_deepar(dev, seed=0, **kw):
    """`DeepAR(**kw)` on `dev`, initialised from `random.seed(seed)`, and
    its `gluon.Trainer(..., "adam", {lr 5e-3})` (the example's)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import deepar
    model = deepar.DeepAR(device=dev, **kw)
    mxrandom.seed(seed, dev)
    model.initialize()
    return model, gluon.Trainer(model.collect_params(), "adam",
                                {"learning_rate": 5e-3})


def sampling_phase(model, ctx, samples, calls=5):
    """`calls` timed `sample_paths(ctx, samples)` calls, each ended by
    its host copy, then one under torch.profiler. Returns (the last
    call's samples as numpy, {timing and profile fields})."""
    import torch
    out = model.sample_paths(ctx, num_samples=samples).asnumpy()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.sample_paths(ctx, num_samples=samples).asnumpy()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    ms = times[len(times) // 2]
    prof, prof_ms, windows = profile_once(
        lambda: model.sample_paths(ctx, num_samples=samples).asnumpy())
    busy, top, by_class, kernels = device_profile(prof, 1, 8)
    host_top, waits = host_profile(prof, 1, 10)
    return out, {"ms_per_sampling_call": ms, "calls_ms": times,
                 "profiled_call_ms": prof_ms, "profile_windows": windows,
                 "device_busy_ms": busy,
                 "device_idle_share": None if busy is None
                 else 1 - busy / ms,
                 "kernels_per_call": kernels,
                 "device_ms_by_class": by_class,
                 "top_device_ms": top, "top_host_self_ms": host_top,
                 "waiting_runtime_calls": waits}


def deepar_phase(dev, batch=32, warmup=2, steps=40, samples=100):
    """Phase 23: DeepAR at the JAX model's defaults (`DEEPAR`, float32,
    random weights from seed 0) trained by the example's eager loop
    (`autograd.record()`, `model.loss`, `backward()`, `gluon.Trainer(
    "adam", {lr 5e-3}).step(1)`) on the example's synthetic seasonal
    series at GluonTS's batch of 32 (the first 24 points of each): 2
    warm-up + 40 timed steps (the example's epochs) and one profiled;
    exactly one Adam launch per weight dtype a step; the NLL falls.
    Then `sample_paths` draws 100 paths (GluonTS's
    `num_parallel_samples`) over the 32 series, timed and profiled, and
    the CRPS against the held-out 12 points is finite (printed beside
    the untrained model's and a climatology forecast's). Last, a
    `NegativeBinomialOutput` model takes one step and one sampling on
    the card: its samples are non-negative integers.
    Returns (result, launch counts of the timed steps)."""
    import numpy as np
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.models import deepar
    ctx_len, horizon = DEEPAR["context_length"], DEEPAR["prediction_length"]
    series = deepar_series(batch, ctx_len + horizon)
    target = nd.array(series[:, :ctx_len], ctx=dev)
    future = series[:, ctx_len:]
    model, trainer = build_deepar(dev, **DEEPAR)
    n_params = len(trainer._params)
    check(n_params == 10, f"DeepAR trainable parameters {n_params}")
    untrained = deepar.crps_eval(
        model.sample_paths(target, num_samples=samples).asnumpy(), future)
    losses, counts, timing = timed_steps(DeepARLoop(model, trainer),
                                         [target], [], warmup, steps)
    check(np.isfinite(losses).all(), f"DeepAR losses {losses}")
    check(losses[-1] < losses[0], f"DeepAR NLL did not fall: {losses}")
    want = expect(adam_update=adam_launches(trainer._params) * steps)
    check(counts == want, f"DeepAR training launches {counts} != {want}")
    reset_counts()
    paths, sampling = sampling_phase(model, target, samples)
    check(read_counts() == expect(),
          f"DeepAR sampling launched repo kernels {read_counts()}")
    check(paths.shape == (samples, batch, horizon)
          and np.isfinite(paths).all(), f"DeepAR paths {paths.shape}")
    crps = deepar.crps_eval(paths, future)
    check(np.isfinite(crps), f"DeepAR CRPS {crps}")
    rng = np.random.RandomState(2)
    hist = series[:, :ctx_len]
    clim = np.take_along_axis(
        hist[None].repeat(samples, 0),
        rng.randint(0, ctx_len, (samples, batch, horizon)), axis=2)
    # the negative binomial head: one step and one sampling on the card
    nb, nb_trainer = build_deepar(dev, distr=deepar.NegativeBinomialOutput,
                                  **DEEPAR)
    reset_counts()
    nb_loss = float(DeepARLoop(nb, nb_trainer).step([target], []))
    nb_counts = read_counts()
    nb_paths = nb.sample_paths(target, num_samples=samples).asnumpy()
    check(np.isfinite(nb_loss) and nb_counts == expect(
        adam_update=adam_launches(nb_trainer._params)),
        f"NegativeBinomial step: loss {nb_loss}, launches {nb_counts}")
    check(nb_paths.shape == (samples, batch, horizon)
          and (nb_paths >= 0).all()
          and np.array_equal(nb_paths, np.round(nb_paths)),
          "NegativeBinomial samples are not non-negative integers")
    res = {"model": "DeepAR(num_cells=40, num_layers=2, dropout=0.1, "
                    "GaussianOutput), float32",
           "batch": batch, "context_length": ctx_len,
           "prediction_length": horizon, "num_samples": samples,
           "optimizer": "gluon.Trainer adam lr 5e-3",
           "trainable_parameters": n_params,
           "param_count": sum(p.numel() for p in trainer._params),
           "launches_per_step": {k: v // steps for k, v in counts.items()
                                 if v},
           "loss_first_last": [losses[0], losses[-1]], "losses": losses,
           "crps": crps, "crps_untrained": untrained,
           "crps_climatology": deepar.crps_eval(clim, future),
           "sampling": sampling,
           "negative_binomial": {"loss": nb_loss,
                                 "sample_mean": float(nb_paths.mean()),
                                 "sample_max": float(nb_paths.max())},
           **timing}
    return res, counts


def crnn_loss_fn():
    """examples/ocr/train_crnn.py's loss_fn, unchanged."""
    from mxnet_tpu_torch import nd

    def loss_fn(logits, label, label_len):
        return nd.ctc_loss(logits, label, use_label_lengths=True,
                           label_lengths=label_len).mean()
    return loss_fn


def glyph_arrays(b, dev):
    from mxnet_tpu_torch import nd
    return ([nd.array(b["image"], ctx=dev)],
            [nd.array(b["label"], ctx=dev), nd.array(b["label_len"], ctx=dev)])


def crnn_exact_match(model, dev, n=128):
    """Held-out exact-match of greedy CTC decodes on `make_glyph_batch(n,
    seed=10_000_000)`, as the example and the JAX gate score it."""
    import numpy as np
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.models import crnn
    hb = crnn.make_glyph_batch(n, num_glyphs=CRNN_GLYPHS, seed=10_000_000)
    pred = crnn.ctc_greedy_decode(
        model(nd.array(hb["image"], ctx=dev)).asnumpy())
    want = [list(hb["label"][i, :hb["label_len"][i]]) for i in range(n)]
    return float(np.mean([p == w for p, w in zip(pred, want)])), pred


def varlen_cost(dev, T=18, batch=32, C=64, hidden=64):
    """CUDA-event ms (host included) of a CRNN-sized BiLSTM forward on
    (T, batch, C) features without lengths, and with lengths (all T),
    whose copy to the host for the packed sequence waits for the card."""
    import torch
    from mxnet_tpu_torch.gluon import rnn
    with torch.device(dev):
        plain = rnn.LSTM(hidden, bidirectional=True, input_size=C)
        varlen = rnn.LSTM(hidden, bidirectional=True, input_size=C,
                          use_sequence_length=True)
    plain.initialize()
    varlen.initialize()
    x = torch.randn(T, batch, C, device=dev)
    s = [torch.zeros(2, batch, hidden, device=dev)] * 2
    lens = torch.full((batch,), T, dtype=torch.int32, device=dev)
    with torch.no_grad():
        return {"shape": [T, batch, C], "hidden": hidden,
                "no_lengths_ms": time_ms(lambda: plain(x, s)),
                "lengths_ms": time_ms(lambda: varlen(x, s, lens))}


def crnn_phase(dev, batch=32, steps=400, warmup=2, lr=3e-3):
    """Phase 24: CRNN at the JAX model's defaults (`CRNN(num_classes=6,
    img_height=8)`: channels (16, 32), hidden 64, float32, seed 0)
    trained as examples/ocr/train_crnn.py does: `parallel.ShardedTrainer(
    model, loss_fn, "adam", {lr 3e-3})` with the example's `loss_fn`
    (`nd.ctc_loss(...).mean()`) for 400 steps at batch 32 on
    `make_glyph_batch(32, seed=step)` (made before the run: set-up);
    the first 2 steps are the warm-up, the other 398 timed. Exactly one
    Adam launch per weight dtype a step; held-out exact-match of 128
    strings >= 0.90 (the JAX package's gate,
    tests/train/test_quality_gates.py); then one more step profiled, and
    a BiLSTM of its size timed without and with lengths (`varlen_cost`).
    Returns (result, launch counts of the timed steps)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import crnn
    model = crnn.CRNN(num_classes=CRNN_GLYPHS + 1, img_height=8, device=dev)
    mxrandom.seed(0, dev)
    model.initialize()
    trainer = parallel.ShardedTrainer(model, crnn_loss_fn(), "adam",
                                      {"learning_rate": lr}, device=dev)
    batches = [glyph_arrays(crnn.make_glyph_batch(
        batch, num_glyphs=CRNN_GLYPHS, seed=s), dev) for s in range(steps)]
    losses = [trainer.step(*b) for b in batches[:warmup]]
    float(losses[-1].asscalar())
    reset_counts()
    t0 = time.perf_counter()
    for b in batches[warmup:]:
        losses.append(trainer.step(*b))
    float(losses[-1].asscalar())
    secs = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(x.asscalar()) for x in losses]
    timed = steps - warmup
    check(np.isfinite(losses).all(), "CRNN losses not finite")
    check(np.mean(losses[-20:]) < 0.5 * np.mean(losses[:20]),
          f"CRNN CTC loss did not fall: {losses[:3]} ... {losses[-3:]}")
    want = expect(adam_update=adam_launches(trainer.params) * timed)
    check(counts == want, f"CRNN training launches {counts} != {want}")
    trainer.sync_to_block()
    exact, pred = crnn_exact_match(model, dev)
    check(exact >= 0.90, f"CRNN held-out exact-match {exact} < 0.90")
    prof, prof_ms, windows = profile_once(
        lambda: float(trainer.step(*batches[0]).asscalar()))
    busy, top, by_class, kernels = device_profile(prof, 1, 10)
    host_top, waits = host_profile(prof, 1, 12)
    step_ms = secs * 1e3 / timed
    del batches
    torch.cuda.empty_cache()
    res = {"model": "CRNN(num_classes=6, img_height=8, channels=(16, 32), "
                    "hidden=64), float32",
           "batch": batch, "steps": steps, "warmup": warmup,
           "optimizer": "ShardedTrainer adam lr 3e-3, the example's "
                        "loss_fn (nd.ctc_loss(...).mean())",
           "trainable_parameters": len(trainer.params),
           "param_count": trainer.param_count,
           "launches_per_step": {k: v // timed for k, v in counts.items()
                                 if v},
           "loss_first_last": [losses[0], losses[-1]],
           "held_out_exact_match": exact, "held_out_strings": len(pred),
           "seconds": secs, "ms_per_step": step_ms,
           "images_per_s": batch * timed / secs,
           "profiled_step_ms": prof_ms, "profile_windows": windows,
           "device_busy_ms_per_step": busy,
           "device_idle_share": None if busy is None else 1 - busy / step_ms,
           "device_ms_per_step_by_class": by_class,
           "kernels_per_step": kernels, "top_device_ms_per_step": top,
           "top_host_self_ms_per_step": host_top,
           "waiting_runtime_calls_per_step": waits,
           "bilstm_forward": varlen_cost(dev)}
    return res, counts


def rnn_parity_phase(dev, steps=3, lr=1e-3):
    """Phase 25: a float32 DeepAR (16 cells, 2 layers, dropout 0, the
    eager loop) and a float32 CRNN (channels (8, 16), hidden 16,
    `ShardedTrainer` with the example's loss_fn) take `steps` Adam steps
    (epsilon 1e-4, as phases 18 and 22) on the card and on the CPU from
    the same weights: losses and every parameter within TOL_TRAIN (TF32
    off for this phase, as for the whole script), one Adam launch per
    weight dtype a step on the card and none on the CPU, and the trained
    CRNNs' greedy CTC decodes of 32 held-out strings equal. Reported,
    not gated: the same card runs with TF32 allowed in cuDNN and cuBLAS
    (cuDNN's RNN may then use it for float32), and the gap between two
    card runs of the CRNN (ATen's CUDA CTC backward sums with atomics)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon, nd, parallel, weights
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import crnn, deepar
    small_ar = dict(num_cells=16, num_layers=2, context_length=24,
                    prediction_length=12, dropout=0.0)
    small_ocr = dict(num_classes=CRNN_GLYPHS + 1, img_height=8,
                     channels=(8, 16), hidden=16)
    series = deepar_series(8, 24, seed=3)
    ar_w = {k: p.detach().numpy().copy() for k, p in
            build_deepar("cpu", 5, **small_ar)[0].collect_params().items()}
    mxrandom.seed(5, "cpu")
    ocr_w = {k: p.detach().numpy().copy() for k, p in crnn.CRNN(
        **small_ocr, device="cpu").initialize().collect_params().items()}
    glyphs = [crnn.make_glyph_batch(8, num_glyphs=CRNN_GLYPHS, seed=100 + s)
              for s in range(steps)]

    def run(where):
        reset_counts()
        ar = weights.load_named_arrays(
            deepar.DeepAR(device=where, **small_ar), ar_w)
        tr = gluon.Trainer(ar.collect_params(), "adam",
                           {"learning_rate": lr, "epsilon": 1e-4})
        loop = DeepARLoop(ar, tr)
        target = nd.array(series, ctx=where)
        ar_losses = [float(loop.step([target], [])) for _ in range(steps)]
        ar_counts = read_counts()
        reset_counts()
        ocr = weights.load_named_arrays(crnn.CRNN(**small_ocr, device=where),
                                        ocr_w)
        st = parallel.ShardedTrainer(ocr, crnn_loss_fn(), "adam",
                                     {"learning_rate": lr, "epsilon": 1e-4},
                                     device=where)
        ocr_losses = [float(st.step(*glyph_arrays(b, where)).asscalar())
                      for b in glyphs]
        ocr_counts = read_counts()
        st.sync_to_block()
        _, pred = crnn_exact_match(ocr, where, n=32)
        params = {f"deepar.{k}": p.detach().cpu()
                  for k, p in ar.collect_params().items()}
        params.update({f"crnn.{k}": p.detach().cpu()
                       for k, p in ocr.collect_params().items()})
        return {"deepar_losses": ar_losses, "crnn_losses": ocr_losses,
                "params": params, "decodes": pred,
                "launches": (ar_counts, ocr_counts),
                "adam": (adam_launches(tr._params),
                         adam_launches(st.params))}

    def gaps(a, b):
        rel = lambda x, y: float(np.max(np.abs(np.subtract(x, y))  # noqa
                                        / np.abs(y)))
        return {"deepar_loss_rel": rel(a["deepar_losses"],
                                       b["deepar_losses"]),
                "crnn_loss_rel": rel(a["crnn_losses"], b["crnn_losses"]),
                "param_max_abs": max(max_err(a["params"][k], b["params"][k])
                                     for k in b["params"])}

    cpu = run("cpu")
    card = run(dev)
    check(all(v == 0 for c in cpu["launches"] for v in c.values()),
          f"CPU run launched {cpu['launches']}")
    for counts, n, what in zip(card["launches"], card["adam"],
                               ("DeepAR", "CRNN")):
        check(counts == expect(adam_update=n * steps),
              f"{what} parity launches {counts}")
    g = gaps(card, cpu)
    check(g["deepar_loss_rel"] <= TOL_TRAIN and g["crnn_loss_rel"]
          <= TOL_TRAIN and g["param_max_abs"] <= TOL_TRAIN,
          f"DeepAR/CRNN card vs CPU {g}: losses {card['deepar_losses']} vs "
          f"{cpu['deepar_losses']}, {card['crnn_losses']} vs "
          f"{cpu['crnn_losses']}")
    check(card["decodes"] == cpu["decodes"],
          "CRNN greedy decodes differ between card and CPU")
    again = run(dev)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with_tf32 = run(dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"card_vs_cpu": g, "card_vs_card": gaps(again, card),
            "tf32_card_vs_cpu": gaps(with_tf32, cpu),
            "tf32_decodes_equal": with_tf32["decodes"] == cpu["decodes"],
            "deepar_losses_card": card["deepar_losses"],
            "deepar_losses_cpu": cpu["deepar_losses"],
            "crnn_losses_card": card["crnn_losses"],
            "crnn_losses_cpu": cpu["crnn_losses"],
            "parameters": len(cpu["params"])}


# ---------------------------------------------------------------------------
# phases 26-30: the serving request lifecycle, the admission ladder,
# speculative decoding, beam search, and their card-vs-CPU parity
# ---------------------------------------------------------------------------

# HuggingFace `distilgpt2`'s published config.json: n_layer 6, n_embd 768,
# n_head 12, vocab_size 50257, n_positions 1024 (GPT-2's tokenizer)
DISTILGPT2 = dict(num_layers=6, units=768, hidden_size=3072, num_heads=12,
                  vocab_size=50257, max_length=1024)
PAGED_KW = dict(slots=8, pages="on", page_size=16, prefill_chunk=8)


def serve_summary(reqs, seconds):
    """Tokens/s, TTFT p50/p99 and the verdicts by code of a served run."""
    import numpy as np
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = [r.ttft_s * 1e3 for r in reqs if r.ttft_s is not None]
    codes = {}
    for r in reqs:
        codes[r.verdict[:3]] = codes.get(r.verdict[:3], 0) + 1
    return {"requests": len(reqs), "tokens": n_tok, "seconds": seconds,
            "tokens_per_s": n_tok / seconds,
            "ttft_ms_p50": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_ms_p99": float(np.percentile(ttft, 99)) if ttft else None,
            "verdicts": codes}


def timed_drive(srv, specs, **kw):
    sync(srv.model)
    t0 = time.perf_counter()
    reqs = drive(srv, specs, **kw)
    sync(srv.model)
    return reqs, time.perf_counter() - t0


def is_prefix(a, b):
    return list(a) == list(b)[:len(a)]


def lifecycle_phase(model, traffic=None, kw=PAGED_KW):
    """Phase 26: phase 2's traffic (or `traffic`, serving_specs' keyword
    arguments) on `Server(model, **kw)`, first as the reference run at
    the card's real capacity (no ladder rung may fire: phase 27 reads
    that), then again with
      * deadlines: every fourth request gets `deadline_ms` of half the
        reference run's median request wall; one that expires ends 504
        with a prefix of its reference tokens;
      * cancellation: a `cancel@req:1` fault armed once request 1 holds 8
        tokens, and `Server.cancel` of request 2 once it holds 16: 499,
        a prefix of the reference tokens;
      * retry: the 20th `decode_paged_chunk` call with live rows raises
        one OSError (RetryPolicy backoff 10 ms): `retries` == 1;
    every other request's tokens equal its reference tokens; after the
    drain the pool's free pages are its data pages less the prefix
    tree's. Then a burst: `burst:8@step:3` through `on_burst` on a
    server with a 4-deep queue (serve_shed=reject) holding 2 running
    requests of 16-token prompts: 4 shed with 503, 6 served 200.
    Returns (the phase's numbers, the reference run's stats)."""
    import numpy as np
    from mxnet_tpu_torch import config, resilience, serve
    specs = serving_specs(model, **(traffic or {}))
    n = len(specs)
    ref_srv = serve.Server(model, **kw)
    ref, ref_s = timed_drive(ref_srv, specs)
    ref_stats = ref_srv.stats()
    ref_srv.stop()
    check(all(r.verdict == "200 ok" for r in ref),
          f"reference verdicts {[r.verdict for r in ref]}")
    walls = [(r._finish_perf - r._submit_perf) * 1e3 for r in ref]
    deadline_ms = float(np.median(walls)) / 2
    ref_tok = [list(r.tokens) for r in ref]

    calls = {"n": 0}
    chunk = model.decode_paged_chunk

    def flaky(*args, **kwargs):
        if int(args[2].max()) > 0:      # a dispatch with live rows
            calls["n"] += 1
            if calls["n"] == 20:
                raise OSError("injected transient dispatch fault")
        return chunk(*args, **kwargs)

    srv = serve.Server(model, retry=resilience.RetryPolicy(backoff_s=0.01),
                       **kw)
    marks = {}

    def on_step(reqs):
        if len(reqs) < 3:
            return
        if "fault" not in marks and len(reqs[1].tokens) >= 8:
            config.set("fault_inject", "cancel@req:1")
            resilience.enable()
            marks["fault"] = len(reqs[1].tokens)
        if "call" not in marks and len(reqs[2].tokens) >= 16:
            srv.cancel(reqs[2])
            marks["call"] = len(reqs[2].tokens)

    model.decode_paged_chunk = flaky
    reset_counts()
    try:
        reqs, secs = timed_drive(
            srv, specs, on_step=on_step, submit_kw=lambda i: dict(
                deadline_ms=deadline_ms) if i % 4 == 3 else {})
    finally:
        del model.decode_paged_chunk
        resilience.disable()
        config.reset("fault_inject")
    counts = read_counts()
    st = srv.stats()
    srv.stop()
    check(counts["paged_attention"] > 0,
          "paged kernel never launched in the lifecycle run")
    expired = 0
    for i, r in enumerate(reqs):
        if i in (1, 2):
            check(r.state == serve.CANCELLED and r.verdict.startswith("499")
                  and 0 < len(r.tokens) < len(ref_tok[i])
                  and is_prefix(r.tokens, ref_tok[i]),
                  f"request {i} cancelled: {r!r}")
        elif i % 4 == 3 and r.state == serve.EXPIRED:
            expired += 1
            check(r.verdict.startswith("504")
                  and is_prefix(r.tokens, ref_tok[i]),
                  f"request {i} expired: {r!r}")
        else:
            check(r.verdict == "200 ok" and r.tokens == ref_tok[i],
                  f"request {i} {r!r}: tokens differ from the reference")
    check(expired >= 1, "no request reached its deadline")
    check(st["retries"] == 1, f"retries {st['retries']}")
    check(st["pool_pages_free"] == st["pool_pages_total"] - st["tree_nodes"],
          f"pages not returned: {st}")

    config.set("fault_inject", "burst:8@step:3")
    resilience.enable()
    try:
        bsrv = serve.Server(model, queue_depth=4, shed="reject", **kw)
        small = [(p[:16], dict(max_new_tokens=16)) for p, _ in specs]
        extra = []
        bsrv.on_burst = lambda k: extra.extend(
            bsrv.submit(small[2 + j % (n - 2)][0], max_new_tokens=16)
            for j in range(k))
        first = [bsrv.submit(p, **k) for p, k in small[:2]]
        bsrv.drain()
        bst = bsrv.stats()
        bsrv.stop()
    finally:
        resilience.disable()
        config.reset("fault_inject")
    shed = [r for r in extra if r.state == serve.SHED]
    check(len(extra) == 8 and len(shed) == 4 and all(
        r.verdict.startswith("503 shed: queue full") for r in shed)
        and all(r.verdict == "200 ok" for r in first + extra
                if r not in shed),
        f"burst verdicts {[r.verdict for r in extra]}")
    res = {"reference": serve_summary(ref, ref_s),
           "median_request_wall_ms": float(np.median(walls)),
           "deadline_ms": deadline_ms,
           "loaded": serve_summary(reqs, secs),
           "expired": st["expired"], "cancelled": st["cancelled"],
           "cancel_at_tokens": marks, "retries": st["retries"],
           "pool_pages_free": st["pool_pages_free"],
           "pool_pages_total": st["pool_pages_total"],
           "tree_nodes": st["tree_nodes"], "launches": counts,
           "burst": {"served": bst["completed"], "shed": bst["shed"]}}
    return res, ref_stats


def settled_memory():
    """The card's allocated bytes with no garbage pending, the peak
    counter reset to them: a collection that frees an earlier phase's
    tensors during a measured dispatch would leave its peak below the
    base."""
    import gc
    import torch
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def exec_peak_rows(model, buckets=(128, 256, 512), spec_k=4):
    """The execution peaks `Server._measure_peak` measured (one fully
    masked dispatch) against `torch.cuda.max_memory_allocated` over a
    real dispatch of the same shape (every row live, its own pages or
    positions), for each paged (bucket, C) the server runs and each
    dense bucket."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import serve
    dev = model.device
    V = model.cfg["vocab_size"]
    rng = np.random.RandomState(9)
    rows = []
    for paged in (True, False):
        kw = PAGED_KW if paged else dict(slots=8)
        srv = serve.Server(model, **kw)
        B = srv._slots
        shapes = ((8, False), (1, False), (spec_k + 1, True)) if paged \
            else ((1, False),)
        for bucket in buckets:
            for C, full in shapes:
                probe = srv._measure_peak(bucket, C, full)
                toks = torch.from_numpy(rng.randint(0, V, (B, C)).astype(
                    np.int32)).to(dev)
                if paged:
                    pages = srv._pool.alloc(B)
                    tables = torch.zeros((B, bucket // 16), dtype=torch.int32)
                    tables[:, 0] = torch.tensor(pages)
                    i32 = dict(dtype=torch.int32, device=dev)
                    lead = (toks, torch.zeros(B, **i32),
                            torch.full((B,), C, **i32), tables.to(dev))
                    base = settled_memory()
                    with torch.no_grad():
                        out, _ = model.decode_paged_chunk(
                            *lead, srv._pool.state["target"], 16, full=full)
                    for p in pages:
                        srv._pool.decref(p)
                else:
                    caches = model._alloc_caches(B, bucket)
                    t = torch.from_numpy(rng.randint(0, bucket, (B,)).astype(
                        np.int32)).to(dev)
                    base = settled_memory()
                    with torch.no_grad():
                        out, _, _ = model.decode_step_slots(
                            toks[:, 0], t, caches[:srv._n_l],
                            caches[srv._n_l:])
                    del caches
                torch.cuda.synchronize()
                real = torch.cuda.max_memory_allocated() - base
                del out
                check(probe is not None and probe > 0 and real > 0,
                      f"exec peak {probe} / real {real}")
                rows.append({"pages": "on" if paged else "off",
                             "bucket": bucket, "C": C, "full": full,
                             "exec_peak_bytes": probe,
                             "real_dispatch_peak_bytes": int(real)})
        srv.stop()
    return rows


def ladder_phase(model, ref_stats, peaks=True):
    """Phase 27: each rung of the degradation ladder once, dense and
    paged, at a `device_bytes_limit` (dense) or pool size (paged) set
    from the server's own accounting (params + caches or pool + the
    measured `_exec_peak`), 100- and 200-token prompts:
      * dense shrink: 100 + 300 wants bucket 512; at the capacity halfway
        between 256's and 512's predicted peaks it runs in 256 with
        max_new_tokens 300 -> 156;
      * dense evict: one slot, a capacity of one 256 bucket; a (100 +
        150) runs, b (100 + 20, bucket 128, no smaller bucket) evicts
        it; a replays to its unloaded tokens;
      * dense 429 at submit: a capacity one byte short of params + the
        128 bucket's caches;
      * paged shrink (buckets 256 and 512, a 36-page pool): a (200 + 50,
        16 pages) runs, b (100 + 300, 25 pages) runs in 256 with 300 ->
        156;
      * paged evict (a 30-page pool): a (100 + 300, 25 pages) runs, b
        (200 + 40, 15 pages, no smaller bucket) evicts it; a replays to
        its unloaded tokens;
      * paged 429 at submit: a capacity one byte short of params + pool.
    At the card's real capacity phase 26's reference run (phase 2's
    traffic) fired no rung: `ref_stats`. With `peaks`, the measured
    execution peaks against real dispatches (`exec_peak_rows`)."""
    import numpy as np
    from mxnet_tpu_torch import config, serve
    V = model.cfg["vocab_size"]
    rng = np.random.RandomState(27)
    p100 = rng.randint(0, V, (100,)).astype(np.int32)
    p200 = rng.randint(0, V, (200,)).astype(np.int32)
    check(ref_stats["degraded"] == ref_stats["requeues"]
          == ref_stats["rejected"] == 0,
          f"a rung fired at the card's capacity: {ref_stats}")

    def pred(srv, b):
        return srv._params_bytes + srv._cache_bytes(b) \
            + (srv._exec_peak(b) or 0)

    def solo(prompt, new, **kw):
        srv = serve.Server(model, **kw)
        r = srv.submit(prompt, max_new_tokens=new)
        srv.drain()
        srv.stop()
        check(r.verdict == "200 ok", f"solo {r!r}")
        return list(r.tokens)

    def evict(srv, a_new, b_prompt, b_new, ref):
        a = srv.submit(p100, max_new_tokens=a_new)
        while len(a.tokens) < 8:
            srv.step()
        b = srv.submit(b_prompt, max_new_tokens=b_new)
        srv.step()
        mid = (a.state, b.state)
        srv.drain()
        st = srv.stats()
        srv.stop()
        check(mid == (serve.QUEUED, serve.RUNNING) and a.requeues == 1
              and st["requeues"] == 1 and a.verdict == b.verdict == "200 ok"
              and a.tokens == ref and a.degraded is None,
              f"evict-and-requeue: {mid} {a!r} {b!r} {st}")
        return {"requeues": st["requeues"], "degraded": st["degraded"],
                "replay_equal": True, "a_streamed": a._streamed}

    out = {"real_capacity": {k: ref_stats[k] for k in
                             ("degraded", "requeues", "rejected")}}
    try:
        srv = serve.Server(model, slots=2)
        config.set("device_bytes_limit",
                   (pred(srv, 256) + pred(srv, 512)) // 2)
        r = srv.submit(p100, max_new_tokens=300)
        srv.drain()
        srv.stop()
        check(r.verdict == "200 ok" and r.degraded == "shrink_max_new:300->156"
              and len(r.tokens) == 156, f"dense shrink {r!r} {r.degraded}")
        out["dense_shrink"] = r.degraded
        config.reset("device_bytes_limit")

        ref = solo(p100, 150, slots=1)
        srv = serve.Server(model, slots=1)
        config.set("device_bytes_limit", pred(srv, 256) + 1000)
        out["dense_evict"] = evict(srv, 150, p100, 20, ref)
        config.reset("device_bytes_limit")

        srv = serve.Server(model, slots=2)
        config.set("device_bytes_limit",
                   srv._params_bytes + srv._cache_bytes(128) - 1)
        r = srv.submit(p100, max_new_tokens=20)
        check(r.state == serve.REJECTED and r.verdict.startswith(
            "429 over capacity: smallest viable KV bucket 128"),
            f"dense 429 {r!r}")
        out["dense_429"] = r.verdict[:60]
        config.reset("device_bytes_limit")

        srv = serve.Server(model, slots=2, pages="on", page_size=16,
                           prefill_chunk=8, pool_pages=36, buckets=[256, 512])
        a = srv.submit(p200, max_new_tokens=50)
        srv.step()
        b = srv.submit(p100, max_new_tokens=300)
        srv.drain()
        st = srv.stats()
        srv.stop()
        check(a.verdict == b.verdict == "200 ok"
              and b.degraded == "shrink_max_new:300->156"
              and len(b.tokens) == 156 and st["requeues"] == 0,
              f"paged shrink {a!r} {b!r} {b.degraded}")
        out["paged_shrink"] = b.degraded

        paged = dict(slots=2, pages="on", page_size=16, prefill_chunk=8)
        ref = solo(p100, 300, **paged)
        srv = serve.Server(model, pool_pages=30, **paged)
        out["paged_evict"] = evict(srv, 300, p200, 40, ref)

        srv = serve.Server(model, **paged)
        config.set("device_bytes_limit",
                   srv._params_bytes + srv._pool.pool_bytes() - 1)
        r = srv.submit(p100, max_new_tokens=20)
        srv.stop()
        check(r.state == serve.REJECTED and r.verdict.startswith(
            "429 over capacity: smallest viable KV bucket"),
            f"paged 429 {r!r}")
        out["paged_429"] = r.verdict[:60]
    finally:
        config.reset("device_bytes_limit")
    if peaks:
        out["exec_peaks"] = exec_peak_rows(model)
    return out


def count_token_steps(models):
    """Wrap each model's decode_paged_chunk and decode_paged_draft to add
    layers x token steps to a tally: the paged kernel launches a path
    must make (one a layer a token step). Returns (tally, undo)."""
    tally = {"launches": 0}

    def wrap(m, name, steps):
        real = getattr(m, name)
        n_l = len(m.gpt.layers)

        def counted(*args, **kw):
            tally["launches"] += n_l * steps(args, kw)
            return real(*args, **kw)

        setattr(m, name, counted)

    uniq = list({id(m): m for m in models}.values())
    for m in uniq:
        wrap(m, "decode_paged_chunk", lambda a, kw: a[0].shape[1])
        wrap(m, "decode_paged_draft",
             lambda a, kw: kw["n_draft"] if "n_draft" in kw else a[6])

    def undo():
        for m in uniq:
            del m.decode_paged_chunk
            del m.decode_paged_draft

    return tally, undo


def spec_phase(model, drafter, spec_k=4, traffic=None, kw=PAGED_KW):
    """Phase 28: phase 2's 16 requests all greedy, plus two sampled at
    temperature 0.8 (top_k 40) that ride along, through the plain paged
    server, then with the target as its own drafter, then with
    `drafter` (distilgpt2's published shape, random weights), spec_k 4:
    every request's tokens equal the plain server's, bit for bit; the
    self drafter's acceptance above 0.9; the paged kernel launched
    exactly once a layer a token step of every target and drafter
    dispatch. Per server: rounds, spec rounds, tokens/s, TTFT,
    paged-kernel launches per round, accepted_draft_rate."""
    from mxnet_tpu_torch import serve
    specs = serving_specs(model, sampled=False, **(traffic or {}))
    specs += [(p, dict(max_new_tokens=kw_["max_new_tokens"],
                       temperature=0.8, top_k=40, seed=100 + i))
              for i, (p, kw_) in enumerate(specs[:2])]
    out, plain = {}, None
    for name, dr in (("plain", None), ("self", model), ("distil", drafter)):
        srv = serve.Server(model, drafter=dr, spec_k=spec_k, **kw)
        tally, undo = count_token_steps([model] + ([dr] if dr else []))
        reset_counts()
        try:
            reqs, secs = timed_drive(srv, specs)
        finally:
            undo()
        counts = read_counts()
        st = srv.stats()
        srv.stop()
        toks = [list(r.tokens) for r in reqs]
        check(all(r.verdict == "200 ok" for r in reqs),
              f"{name} verdicts {[r.verdict for r in reqs]}")
        if plain is None:
            plain = toks
        check(toks == plain, f"{name} drafter: tokens differ from the plain "
              "paged server's")
        check(counts["paged_attention"] == tally["launches"] > 0,
              f"{name}: {counts['paged_attention']} paged launches, "
              f"{tally['launches']} layer token steps")
        n_d = len(dr.gpt.layers) if dr is not None else 0
        res = serve_summary(reqs, secs)
        res.update({"rounds": st["steps"], "spec_rounds": st["spec_rounds"],
                    "chunk_rounds": st["chunk_dispatches"],
                    "paged_launches": counts["paged_attention"],
                    "paged_launches_per_round":
                        counts["paged_attention"] / st["steps"],
                    "paged_launches_per_spec_round": (spec_k + 1) * (
                        len(model.gpt.layers) + n_d) if dr else None,
                    "drafts_proposed": st["drafts_proposed"],
                    "drafts_accepted": st["drafts_accepted"],
                    "accepted_draft_rate": st["accepted_draft_rate"]})
        out[name] = res
    check(out["self"]["accepted_draft_rate"] > 0.9,
          f"self-drafter acceptance {out['self']['accepted_draft_rate']}")
    check(out["self"]["spec_rounds"] > 0 and out["distil"]["spec_rounds"] > 0,
          "no speculative round ran")
    return out


def beam_phase(model, n=4, lp=32, new=32, eos=50256):
    """Phase 29: `generate(num_beams=4, eos=50256, alpha=0.6,
    return_scores=True)` on n prompts of lp tokens, `new` new ones: one
    flash prefill (a flash forward a layer), shapes, finite scores, and
    no token but eos after a beam's eos; then the same with the first
    greedy token as eos, so beams end on it."""
    import numpy as np
    V = model.cfg["vocab_size"]
    prompts = np.random.RandomState(29).randint(0, V, (n, lp)).astype(
        np.int32)
    out = {}
    for name, e in (("eos_50256", eos), ("eos_greedy", None)):
        if e is None:
            e = int(model.generate(prompts[:1], max_new_tokens=1)[0, 0])
        sync(model)
        reset_counts()
        t0 = time.perf_counter()
        toks, scores = model.generate(prompts, max_new_tokens=new, eos=e,
                                      alpha=0.6, num_beams=4,
                                      return_scores=True)
        sync(model)
        secs = time.perf_counter() - t0
        counts = read_counts()
        check(toks.shape[0] == n and 1 <= toks.shape[1] <= new
              and toks.dtype == np.int32 and scores.shape == (n,)
              and np.isfinite(scores).all(), f"beam {toks.shape} {scores}")
        for row in toks:
            hit = np.flatnonzero(row == e)
            check(hit.size == 0 or (row[hit[0]:] == e).all(),
                  f"beam row continues past eos {e}: {row}")
        check(counts["flash_attention_fwd"] == len(model.gpt.layers),
              f"beam launches {counts}")
        out[name] = {"eos": e, "steps": int(toks.shape[1]),
                     "ms_per_step": secs * 1e3 / toks.shape[1],
                     "seconds": secs, "scores": scores.tolist(),
                     "rows_ending_on_eos": int((toks == e).any(1).sum()),
                     "flash_fwd_launches": counts["flash_attention_fwd"],
                     "paged_launches": counts["paged_attention"]}
    return out


def serve_parity_phase(dev):
    """Phase 30: float32 gpt_tiny and its 1-layer drafter, the same
    weights on `dev` and on the CPU: speculative serving (spec_k 3)
    gives equal tokens and draft counts on both, equal to plain greedy;
    beam search (4 beams) equal tokens, scores within 1e-5; and the
    ladder's verdict sequence (dense shrink, dense evict, dense 429,
    paged evict) equal at capacities set from each side's own
    accounting."""
    import numpy as np
    from mxnet_tpu_torch import config, serve, weights
    from mxnet_tpu_torch.models import gpt
    base = build_model(gpt.gpt_tiny_config(), 0, "cpu")
    dbase = build_model(gpt.gpt_tiny_config(num_layers=1), 7, "cpu")
    arrays = {k: p.detach().numpy() for k, p in base.collect_params().items()}
    darrays = {k: p.detach().numpy()
               for k, p in dbase.collect_params().items()}

    def twin(where):
        m = gpt.GPTForCausalLM(gpt.gpt_tiny_config(), device=where)
        d = gpt.GPTForCausalLM(gpt.gpt_tiny_config(num_layers=1),
                               device=where)
        return weights.load_named_arrays(m, arrays), \
            weights.load_named_arrays(d, darrays)

    rng = np.random.RandomState(30)
    prompts = [rng.randint(0, 128, (k,)).astype(np.int32) for k in (5, 9, 17)]
    p4, p9, p10 = (rng.randint(0, 128, (k,)).astype(np.int32)
                   for k in (4, 9, 10))
    bprompt = rng.randint(0, 128, (2, 7)).astype(np.int32)

    def ladder(m):
        """The ladder cases of tests/test_torch_serve_admission.py."""
        out = []

        def pred(srv, b):
            return srv._params_bytes + srv._cache_bytes(b) \
                + (srv._exec_peak(b) or 0)

        try:
            srv = serve.Server(m, slots=2)
            config.set("device_bytes_limit",
                       (pred(srv, 32) + pred(srv, 64)) // 2)
            r = srv.submit(p10, max_new_tokens=40)
            srv.drain()
            out.append((r.verdict, r.degraded, r.tokens))
            srv = serve.Server(m, slots=1)
            config.set("device_bytes_limit", pred(srv, 64) + 1000)
            a = srv.submit(p4, max_new_tokens=50)
            while len(a.tokens) < 3:
                srv.step()
            b = srv.submit(p4, max_new_tokens=4)
            srv.drain()
            out.append((a.verdict, a.requeues, a.tokens, b.verdict))
            srv = serve.Server(m, slots=2)
            config.set("device_bytes_limit",
                       srv._params_bytes + srv._cache_bytes(32) // 2)
            out.append(srv.submit(p9, max_new_tokens=8).verdict[:40])
            config.reset("device_bytes_limit")
            srv = serve.Server(m, slots=2, pages="on", page_size=4,
                               prefill_chunk=4, pool_pages=5)
            a = srv.submit(p10, max_new_tokens=6)
            srv.step()
            b = srv.submit(p9, max_new_tokens=3)
            srv.drain()
            srv.stop()
            out.append((a.verdict, a.requeues, a.tokens, b.verdict))
        finally:
            config.reset("device_bytes_limit")
        return out

    res = {}
    for where in (dev, "cpu"):
        m, d = twin(where)
        reset_counts()
        srv = serve.Server(m, slots=4, pages="on", page_size=4,
                           prefill_chunk=4, drafter=d, spec_k=3)
        reqs = [srv.submit(p, max_new_tokens=16) for p in prompts]
        srv.drain()
        st = srv.stats()
        srv.stop()
        spec_launches = read_counts()["paged_attention"]
        plain = serve.Server(m, slots=4)
        preqs = [plain.submit(p, max_new_tokens=16) for p in prompts]
        plain.drain()
        eos = int(m.generate(bprompt[:1], max_new_tokens=3)[0, -1])
        reset_counts()
        btok, bsc = m.generate(bprompt, max_new_tokens=12, eos=eos,
                               num_beams=4, return_scores=True)
        res[str(where)] = {
            "spec": [list(r.tokens) for r in reqs],
            "plain": [list(r.tokens) for r in preqs],
            "draft_counts": (st["spec_rounds"], st["drafts_proposed"],
                             st["drafts_accepted"]),
            "spec_launches": spec_launches,
            "beam": btok.tolist(), "scores": bsc,
            "beam_flash": read_counts()["flash_attention_fwd"],
            "ladder": ladder(m)}
    card, cpu = res[str(dev)], res["cpu"]
    check(card["spec"] == card["plain"] == cpu["spec"] == cpu["plain"],
          "speculative tokens differ between card, CPU and plain greedy")
    check(card["draft_counts"] == cpu["draft_counts"],
          f"draft counts {card['draft_counts']} != {cpu['draft_counts']}")
    check(str(dev) == "cpu" or card["spec_launches"] > 0,
          "paged kernel never launched in speculative serving")
    check(card["beam"] == cpu["beam"], "beam tokens differ")
    score_err = float(np.abs(card["scores"] - cpu["scores"]).max())
    check(score_err <= 1e-5, f"beam scores {score_err}")
    check(str(dev) == "cpu" or card["beam_flash"] == 2,
          f"beam flash launches {card['beam_flash']}")
    check(card["ladder"] == cpu["ladder"],
          f"ladder {card['ladder']} != {cpu['ladder']}")
    return {"spec_tokens_equal": True, "draft_counts": card["draft_counts"],
            "beam_tokens_equal": True, "beam_score_max_abs_err": score_err,
            "ladder_verdicts": [x if isinstance(x, str) else x[:2]
                                for x in card["ladder"]]}


# ---------------------------------------------------------------------------
# phases 36-38: the repo's examples unchanged, the vision model zoo at
# published widths, and card against CPU for the zoo, the DataLoader and
# the shape ops
# ---------------------------------------------------------------------------

# examples/<path> and the arguments phase 36 runs it with: the first two
# at their defaults, the rest at small step counts
EXAMPLES = (
    ("image_classification/train_cifar10.py", ()),
    ("gpt/generate.py", ()),
    ("bert/pretrain.py", ("--steps", "3")),
    ("bert/pretrain.py", ("--steps", "4", "--auto-checkpoint-every", "2",
                          "--auto-checkpoint-dir", "{tmp}")),
    ("nmt/train_transformer.py", ("--steps", "20")),
    ("detection/train_yolo.py", ("--steps", "10")),
    ("timeseries/train_deepar.py", ("--epochs", "5")),
    ("ocr/train_crnn.py", ("--steps", "50")),
    ("module_api/train_mnist_module.py", ()),
)
# examples that phase 36 cannot run on the card, and why
NOT_ON_CARD = {
    "gpt/pretrain.py": "imports jax.sharding inside main "
                       "(examples/gpt/pretrain.py:46); the card's machine "
                       "has no JAX (it runs through the port in tier-1)",
    "bert/long_context.py": "sequence parallelism (ROADMAP.md queue 1 item "
                            "9); imports jax",
}
# counters of `run_example`'s launch line that must be > 0 for each example
EXAMPLE_KERNELS = {
    "gpt/generate.py": ("fused_update.launches_adam",
                        "flash_attention.launches"),
    "bert/pretrain.py": ("fused_update.launches_pass1",
                         "fused_update.launches_pass2",
                         "flash_attention.launches"),
    "nmt/train_transformer.py": ("fused_update.launches_adam",
                                 "flash_attention.launches"),
    "detection/train_yolo.py": ("fused_update.launches_adam",
                                "box_nms.launches"),
    "timeseries/train_deepar.py": ("fused_update.launches_adam",),
    "ocr/train_crnn.py": ("fused_update.launches_adam",),
}


def _example_cmd(path, args):
    return [sys.executable, "-m", "mxnet_tpu_torch.run_example",
            os.path.join("examples", path), *args]


def _example_result(path, args, rc, stdout, stderr):
    check(rc == 0, f"examples/{path} {args}: rc {rc}\n{stdout[-2000:]}\n"
          f"{stderr[-4000:]}")
    lines = stdout.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])


def run_examples(runs, width=1, timeout=300):
    """Each (examples/<path>, args) through `python -m
    mxnet_tpu_torch.run_example` in a process of its own, `width` at a
    time: [(its output lines before the runner's JSON line, that line
    parsed, wall seconds of the process)] in the order given."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out, pending = [None] * len(runs), list(enumerate(runs))
    while pending:
        batch, pending = pending[:width], pending[width:]
        procs = []
        for i, (path, args) in batch:
            procs.append((i, path, args, time.perf_counter(), subprocess.Popen(
                _example_cmd(path, args), cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        for i, path, args, t0, proc in procs:
            try:
                stdout, stderr = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            secs = time.perf_counter() - t0
            out[i] = (*_example_result(path, args, proc.returncode, stdout,
                                       stderr), secs)
    return out


def loader_rate(num_workers, batch=128, epochs=3):
    """CIFAR10(train=True) (synthetic, 1,024 images) through the example's
    DataLoader(shuffle, last_batch="discard") onto the card alone: the
    batches/s of the last `epochs - 1` epochs (the first forks the
    workers and warms the path)."""
    import torch
    from mxnet_tpu_torch.gluon import data as gdata
    loader = gdata.DataLoader(gdata.vision.CIFAR10(train=True),
                              batch_size=batch, shuffle=True,
                              last_batch="discard", num_workers=num_workers)
    n, t0 = 0, None
    for epoch in range(epochs):
        if epoch == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for x, y in loader:
            check(x.shape == (batch, 32, 32, 3) and x.context.device_type == "gpu",
                  f"loader batch {x.shape} on {x.context}")
            n += epoch > 0
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def examples_phase(dev):
    """Phase 36: the repo's examples, unchanged, on the card through
    `python -m mxnet_tpu_torch.run_example`, each in a process of its
    own (rc 0, no file of the JAX package loaded, the kernels of its path
    launched): train_cifar10.py at its defaults (resnet18_v1, batch 128,
    2 epochs of the 1,024 synthetic CIFAR-10 images, float32, SGD
    momentum 0.9 wd 1e-4), gpt/generate.py at its defaults (200 Adam
    steps, then `generate` of 16 tokens: exactly one Adam launch per
    weight dtype a step, the flash forward at least once), the others at
    small step counts, all at once (the first two alone: their rates are
    read); train_mnist_module.py at its defaults binds
    with context=mx.cpu(): it launches nothing and prints its final
    validation accuracy. Then the CIFAR-10 DataLoader alone on the
    card, num_workers 0 and 2. Examples that cannot run here are listed
    with the reason."""
    import tempfile
    from mxnet_tpu_torch.models import gpt
    out = {"not_on_card": NOT_ON_CARD, "runs": []}
    with tempfile.TemporaryDirectory(prefix="mxt_examples_") as tmp:
        runs = [(path, tuple(a.format(tmp=tmp) for a in args))
                for path, args in EXAMPLES]
        results = run_examples(runs[:2]) + run_examples(runs[2:],
                                                        width=len(runs) - 2)
        for (path, args), (lines, res, secs) in zip(runs, results):
            counts = {k: v for k, v in res["launches"].items() if v}
            for key in EXAMPLE_KERNELS.get(path, ()):
                check(counts.get(key, 0) > 0, f"examples/{path}: {key} "
                      f"never launched {counts}")
            row = {"example": path, "args": list(args),
                   "process_seconds": secs, "script_seconds": res["seconds"],
                   "max_memory_allocated_bytes":
                       res.get("max_memory_allocated_bytes"),
                   "launches": counts, "output": lines[-6:]}
            if path == "image_classification/train_cifar10.py":
                check(counts == {}, f"train_cifar10 launched {counts}")
                rates = [float(l.split("(")[1].split()[0]) for l in lines
                         if l.startswith("epoch ")]
                check(len(rates) == 2, f"train_cifar10 output {lines}")
                row["images_per_s_by_epoch"] = rates
            if path == "module_api/train_mnist_module.py":
                # it binds with context=mx.cpu(): the CPU by its request
                check(counts == {}, f"train_mnist_module launched {counts}")
                check(lines[-1].startswith("final validation: "
                                           "{'accuracy': "),
                      f"train_mnist_module output {lines[-3:]}")
            if path == "gpt/generate.py":
                vocab = int(lines[0].split("vocab ")[1].rstrip(")"))
                steps = 200
                model = gpt.GPTForCausalLM(gpt.gpt_tiny_config(
                    vocab_size=vocab, max_length=64), device="cpu")
                want = steps * adam_launches(
                    [p for p in model.parameters()
                     if getattr(p, "grad_req", "write") != "null"])
                check(counts["fused_update.launches_adam"] == want,
                      f"generate.py Adam launches {counts} != {want}")
                row["adam_launches_expected"] = want
                check(lines[-1].startswith("generated: "),
                      f"generate.py output {lines}")
            print(f"chip_smoke: examples/{path} " + json.dumps(row))
            out["runs"].append(row)
    out["dataloader_batches_per_s"] = {
        f"num_workers={w}": loader_rate(w) for w in (0, 2)}
    print(f"chip_smoke: examples not run on the card {NOT_ON_CARD}")
    return out


# one net of each family at published widths: (get_model name, input size)
ZOO_NETS = (("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1.1", 224),
            ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
            ("densenet121", 224), ("resnet50_v2", 224),
            ("inceptionv3", 299))


class ZooLoop:
    """examples/image_classification/train_cifar10.py's step, as
    `timed_steps` drives a trainer:

        x = nd.transpose(x.astype("float32") / 255.0, axes=(0, 3, 1, 2))
        with autograd.record():
            loss = lfn(net(x), y).mean()
        loss.backward()
        trainer.step(1)
    """

    def __init__(self, net, trainer):
        from mxnet_tpu_torch.gluon import loss as gloss
        self.net, self.trainer = net, trainer
        self.lfn = gloss.SoftmaxCrossEntropyLoss()

    def step(self, data, labels):
        from mxnet_tpu_torch import autograd, nd
        x = nd.transpose(data[0].astype("float32") / 255.0,
                         axes=(0, 3, 1, 2))
        with autograd.record():
            loss = self.lfn(self.net(x), labels[0]).mean()
        loss.backward()
        self.trainer.step(1)
        return loss


def zoo_phase(dev, batch=32, warmup=2, steps=5, lr=0.01):
    """Phase 37: one net of each vision family at its published widths
    (`get_model(name, classes=1000)`, random weights: `random.seed(0)`,
    `initialize(init="xavier")`), float32 as the example trains, TF32
    allowed in cuDNN's convolutions (PyTorch's default, as the example's
    process runs), trained by the example's eager loop (`ZooLoop`; SGD
    lr 0.01, momentum 0.9, wd 1e-4) on one seeded uint8 NHWC batch of 32:
    2 warm-up steps, 5 timed ones ended by one host fetch, one more under
    torch.profiler. Per net: ms a step, images/s, device busy, idle share,
    peak memory (the timed steps'; `peak_above_base_bytes` leaves out
    what was allocated before the net was built, garbage collected)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    out = {}
    try:
        for name, size in ZOO_NETS:
            base = settled_memory()
            rng = np.random.RandomState(0)
            x = nd.array(rng.randint(0, 256, (batch, size, size, 3))
                         .astype(np.uint8), ctx=dev)
            y = nd.array(rng.randint(0, 1000, batch).astype(np.int32),
                         ctx=dev)
            net = get_model(name, classes=1000, device=dev)
            mxrandom.seed(0, dev)
            net.initialize(init="xavier")
            trainer = gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": lr, "momentum": 0.9,
                                     "wd": 1e-4})
            losses, counts, timing = timed_steps(
                ZooLoop(net, trainer), [x], [y], warmup, steps, n_top=6)
            check(np.isfinite(losses).all(), f"{name} losses {losses}")
            check(counts == expect(), f"{name} launched repo kernels "
                  f"{counts}")
            res = {"model": f"get_model({name!r}, classes=1000)",
                   "batch": batch, "image": [3, size, size],
                   "param_count": sum(p.numel() for p in net.parameters()
                                      if p.grad_req != "null"),
                   "images_per_s": batch * steps / timing["seconds"],
                   "losses": losses, **timing,
                   "peak_above_base_bytes":
                       timing["max_memory_allocated_bytes"] - base}
            for k in ("top_host_self_ms_per_step",
                      "waiting_runtime_calls_per_step"):
                res.pop(k, None)
            print(f"chip_smoke: zoo {name} " + json.dumps(res))
            out[name] = res
            del net, trainer, x, y
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


# the zoo families phase 38 holds card against CPU: the nets, input sizes
# and BatchNorm freezing of tests/test_torch_model_zoo.py's parity cases
# (label, factory over model_zoo.vision, input size, BatchNorms frozen,
# batch). The batch is tests/unittest/test_model_zoo.py's 2, but 8 for
# ResNet-18, whose BatchNorms keep batch statistics (over 2 values at its
# 1 x 1 maps they make the float32 gradient meaningless). At batch 8 one
# channel of vgg11_bn's last block routes its gradient through another
# ReLU/max-pool branch on the card than on the CPU (a kink met at float32
# rounding: 1 of 512 bias elements off by 1.4e-2 of the largest), which no
# tolerance of a smooth function covers.
ZOO_PARITY = (
    ("alexnet", lambda v, **kw: v.alexnet(**kw), 64, False, 2),
    ("squeezenet1.1", lambda v, **kw: v.squeezenet1_1(**kw), 64, False, 2),
    ("mobilenet0.25", lambda v, **kw: v.mobilenet0_25(**kw), 64, True, 2),
    ("resnet18_v1", lambda v, **kw: v.resnet18_v1(**kw), 32, False, 8),
    ("densenet(16, 8, (2, 2))",
     lambda v, **kw: v.DenseNet(16, 8, (2, 2), **kw), 32, True, 2),
    ("vgg11_bn", lambda v, **kw: v.vgg11_bn(**kw), 32, True, 2),
    ("mobilenetv2_0.5", lambda v, **kw: v.mobilenet_v2_0_5(**kw), 64, True,
     2),
    ("inceptionv3", lambda v, **kw: v.inception_v3(**kw), 75, True, 2))
TOL_ZOO = 1e-4


def zoo_family_run(make, size, frozen, device, arrays=None, batch=8):
    """The zoo net make(model_zoo.vision, classes=10, device=device),
    float32: seeded xavier weights (or `arrays` carried by name), Dropout at rate 0 and, with `frozen`, the
    BatchNorms on their running statistics (a float32 gradient of these
    nets with batch statistics at batch 8 is itself 1-5% from the
    float64 one); the evaluation logits of a seeded batch, then one SGD
    step (lr 0.01, momentum 0.9, wd 1e-4) through the example's loop.
    Returns (arrays before, logits, loss, {name: tensor after} on the
    CPU)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import autograd, gluon, nd, weights
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.gluon.model_zoo import vision
    net = make(vision, classes=10, device=device)
    mxrandom.seed(0, device)
    net.initialize(init="xavier")
    with torch.no_grad():
        net(torch.zeros((1, 3, size, size), device=device))
    if arrays is not None:
        weights.load_named_arrays(net, arrays)
    for m in net.modules():
        if type(m).__name__ == "Dropout":
            m._rate = 0.0
        if frozen and type(m).__name__ == "BatchNorm":
            m._use_global_stats = True
    start = {k: p.detach().cpu().numpy().copy()
             for k, p in net.collect_params().items()}
    rng = np.random.RandomState(0)
    x = nd.array(rng.randn(batch, 3, size, size).astype(np.float32),
                 ctx=device)
    y = nd.array(rng.randint(0, 10, batch).astype(np.float32), ctx=device)
    with torch.no_grad():
        logits = net(x).asnumpy()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9,
                             "wd": 1e-4})
    lfn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = lfn(net(x), y).mean()
    loss.backward()
    trainer.step(1)
    after = {k: p.detach().cpu().numpy().copy()
             for k, p in net.collect_params().items()}
    return start, logits, float(loss.asscalar()), after


def rel_err(got, ref):
    import numpy as np
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()) / max(
        float(np.abs(ref).max()), 1e-30)


def shape_op_cases(device):
    """(name, fn, args) of every `ops.shape_ops` op over seeded inputs on
    `device` (the same values on any device)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.ops import shape_ops as so
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    x = t(rng.randn(2, 3, 4, 5).astype(np.float32))
    m = t(rng.randn(4, 6).astype(np.float32))
    idx = t(np.array([[0, 3, -1], [5, 2, 9]], np.float32))
    lens = t(np.array([2, 4, 1], np.int32))
    seq = t(rng.randn(4, 3, 2).astype(np.float32))
    return [
        ("reshape", so.reshape, (x, (0, -1, 5))),
        ("reshape_codes", so.reshape, (x, (-3, -2))),
        ("reshape_split", so.reshape, (x, (-4, 1, 2, -2))),
        ("transpose", so.transpose, (x, (3, 1, 0, 2))),
        ("swapaxes", so.swapaxes, (x, 1, 3)),
        ("expand_dims", so.expand_dims, (m, 1)),
        ("squeeze", so.squeeze, (x[:, :1], 1)),
        ("flatten", so.flatten, (x,)),
        ("broadcast_to", so.broadcast_to, (m[:1], (4, 0))),
        ("broadcast_axis", so.broadcast_axis, (m[:, :1], 1, 3)),
        ("broadcast_like", so.broadcast_like, (m[:1], m)),
        ("tile", so.tile, (m, (2, 1))),
        ("repeat", so.repeat, (m, 2, 1)),
        ("pad_constant", so.pad,
         (x, "constant", (0, 0, 0, 0, 1, 2, 2, 1), 0.5)),
        ("pad_edge", so.pad, (x, "edge", (0, 0, 0, 0, 1, 2, 2, 1))),
        ("pad_reflect", so.pad, (x, "reflect", (0, 0, 0, 0, 2, 1, 1, 3))),
        ("stack", so.stack, (m, m * 2)),
        ("concat", so.concat, (m, m)),
        ("split", so.split, (m, 3, 1)),
        ("split_v2", so.split_v2, (m, (1, 4), 1)),
        ("slice", so.slice_op, (x, (0, None, 1), (2, None, -1), (1, -1, 2))),
        ("slice_axis", so.slice_axis, (x, 2, 1, -1)),
        ("slice_like", so.slice_like, (m, m[:2, :3])),
        ("reverse", so.reverse, (x, (1, 3))),
        ("where", so.where, (m > 0, m, -m)),
        ("take", so.take, (m, idx, 1)),
        ("take_wrap", so.take, (m, idx, 0, "wrap")),
        ("pick", so.pick, (m, idx[0, :1].expand(4), 1)),
        ("gather_nd", so.gather_nd, (m, t(np.array([[0, 3], [5, 1]],
                                                   np.int32)))),
        ("scatter_nd", so.scatter_nd, (m[0, :2], t(np.array(
            [[0, 3], [5, 1]], np.int32)), (4, 6))),
        ("one_hot", so.one_hot, (lens, 5)),
        ("diag", so.diag, (m,)),
        ("sequence_mask", so.sequence_mask, (seq, lens, True, -1.0)),
        ("sequence_last", so.sequence_last, (seq, lens, True)),
        ("sequence_reverse", so.sequence_reverse, (seq, lens, True)),
        ("boolean_mask", so.boolean_mask, (m, (m[:, 0] > 0))),
        ("reshape_like", so.reshape_like, (m, m.reshape(2, 12))),
    ]


def parity_phase(dev):
    """Phase 38, float32, card against CPU: each zoo family of
    `ZOO_PARITY` (the CPU run's start carried by name to the card):
    evaluation logits, the loss, every weight and running statistic
    after one SGD step within TOL_ZOO of the largest |value| (the
    tolerance tests/test_torch_model_zoo.py holds the port to the JAX
    package with); a DataLoader with num_workers=2 forked after CUDA is
    initialised gives exactly the batches of num_workers=0 (the example's
    CIFAR-10 dataset, pinned; unshuffled, since the workers' seeds are
    drawn from numpy's generator before the sampler's order); every
    shape op on the card equals the CPU bit for bit."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.gluon import data as gdata
    out = {"zoo": {}}
    for name, make, size, frozen, batch in ZOO_PARITY:
        start, lc, losc, ac = zoo_family_run(make, size, frozen, "cpu",
                                             batch=batch)
        _, lg, losg, ag = zoo_family_run(make, size, frozen, dev, start,
                                         batch)
        errs = {"logits": rel_err(lg, lc), "loss": rel_err(losg, losc),
                "params": max(rel_err(ag[k], ac[k]) for k in ac)}
        check(max(errs.values()) <= TOL_ZOO, f"zoo {name} card vs CPU "
              f"{errs}")
        out["zoo"][name] = {"size": size, "batch": batch,
                            "frozen_batchnorm": frozen, **errs}
    ds = gdata.vision.CIFAR10(train=True)
    check(torch.cuda.is_initialized(), "CUDA not initialised before the "
          "fork")
    runs = {}
    for w in (0, 2):
        runs[w] = [(x.asnumpy(), y.asnumpy()) for x, y in gdata.DataLoader(
            ds, batch_size=100, num_workers=w, pin_memory=True)]
    same = len(runs[0]) == len(runs[2]) == 11 and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(runs[0], runs[2]))
    check(same, "forked DataLoader batches differ from num_workers=0's")
    out["dataloader_forked_after_cuda_equal"] = same
    unequal = []
    for (name, fn, args), (_, _, cargs) in zip(shape_op_cases(dev),
                                               shape_op_cases("cpu")):
        g, c = fn(*args), fn(*cargs)
        g = g if isinstance(g, tuple) else (g,)
        c = c if isinstance(c, tuple) else (c,)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(g, c)):
            unequal.append(name)
    check(not unequal, f"shape ops differ card vs CPU: {unequal}")
    out["shape_ops_bit_equal"] = len(shape_op_cases("cpu"))
    return out


# ---------------------------------------------------------------------------
# phases 39-43: MXNet's symbolic half (the op registry, sym with its
# executor, Module / BucketingModule) on the card
# ---------------------------------------------------------------------------

# BERT-base's widths: the symbolic encoder of phases 39-41
SYM_BERT = dict(V=30522, E=768, F=3072, H=12, layers=12, max_len=512)
SYM_DATA = ("data", "token_types", "valid_mask", "masked_idx")
SYM_LABELS = ("mlm_label",)


def bert_symbol(V, E, F, H, layers, max_len, L, p=0.1, attn_p=0.1):
    """The BERT encoder as a Symbol, built here from registry ops (a
    use of `sym`, not a package feature): word, token-type and
    position embeddings, LayerNorm, then `layers` post-LN layers of a
    fused QKV FullyConnected(flatten=False), `fused_self_attention(
    num_heads=H)` over the (B, L) valid mask (attention-probability
    dropout attn_p), a projection, Dropout(p), residual and LayerNorm,
    then a gelu FFN the same way. Returns (encoder output (B, L, E),
    the masked-LM loss head: the rows at `masked_idx` (flat B * L
    indices) through a transform, gelu, LayerNorm and the vocabulary
    FullyConnected into SoftmaxOutput(use_ignore, ignore_label -1,
    normalization "valid"))."""
    from mxnet_tpu_torch import name, sym
    with name.NameManager():        # the same graph, the same names
        return _bert_symbol(sym, V, E, F, H, layers, max_len, L, p, attn_p)


def _bert_symbol(sym, V, E, F, H, layers, max_len, L, p, attn_p):
    data, types = sym.var("data"), sym.var("token_types")
    mask = sym.var("valid_mask")
    x = sym.Embedding(data, input_dim=V, output_dim=E, name="word_embed") \
        + sym.Embedding(types, input_dim=2, output_dim=E,
                        name="token_type_embed")
    pos = sym.slice_axis(sym.var("position_weight", shape=(max_len, E)),
                         axis=0, begin=0, end=L,
                         name="pos")
    x = sym.LayerNorm(sym.broadcast_add(x, sym.expand_dims(pos, axis=0,
                                                           name="pos_b")),
                      name="embed_ln")
    x = sym.Dropout(x, p=p, name="embed_drop")
    for i in range(layers):
        qkv = sym.FullyConnected(x, num_hidden=3 * E, flatten=False,
                                 name=f"l{i}_qkv")
        att = sym.fused_self_attention(qkv, mask=mask, num_heads=H,
                                       dropout=attn_p, name=f"l{i}_att")
        h = sym.FullyConnected(att, num_hidden=E, flatten=False,
                               name=f"l{i}_proj")
        h = sym.Dropout(h, p=p, name=f"l{i}_drop1")
        x = sym.LayerNorm(x + h, name=f"l{i}_attn_ln")
        h = sym.FullyConnected(x, num_hidden=F, flatten=False,
                               name=f"l{i}_ffn_in")
        h = sym.Activation(h, act_type="gelu", name=f"l{i}_gelu")
        h = sym.FullyConnected(h, num_hidden=E, flatten=False,
                               name=f"l{i}_ffn_out")
        h = sym.Dropout(h, p=p, name=f"l{i}_drop2")
        x = sym.LayerNorm(x + h, name=f"l{i}_ffn_ln")
    rows = sym.take(sym.reshape(x, shape=(-1, E), name="flat"),
                    sym.reshape(sym.var("masked_idx"), shape=(-1,),
                                name="idx_flat"), name="masked_rows")
    h = sym.FullyConnected(rows, num_hidden=E, name="mlm_transform")
    h = sym.LayerNorm(sym.Activation(h, act_type="gelu", name="mlm_gelu"),
                      name="mlm_ln")
    h = sym.FullyConnected(h, num_hidden=V, name="mlm_decoder")
    label = sym.reshape(sym.var("mlm_label"), shape=(-1,), name="lab_flat")
    loss = sym.SoftmaxOutput(h, label, use_ignore=True,
                             ignore_label=-1, normalization="valid",
                             name="mlm")
    return x, loss


def bert_symbol_params(V, E, F, H, layers, max_len, **_):
    """{argument name: shape} of `bert_symbol`'s weights."""
    shapes = {"word_embed_weight": (V, E), "token_type_embed_weight": (2, E),
              "position_weight": (max_len, E), "embed_ln_gamma": (E,),
              "embed_ln_beta": (E,)}
    for i in range(layers):
        for name, o, n_in in (("qkv", 3 * E, E), ("proj", E, E),
                              ("ffn_in", F, E), ("ffn_out", E, F)):
            shapes[f"l{i}_{name}_weight"] = (o, n_in)
            shapes[f"l{i}_{name}_bias"] = (o,)
        for ln in ("attn_ln", "ffn_ln"):
            shapes[f"l{i}_{ln}_gamma"] = shapes[f"l{i}_{ln}_beta"] = (E,)
    return shapes


def sym_bert_batch(B, L, M, V, seed=0):
    """One synthetic masked-LM batch: ids, token types, the valid mask
    (lengths L/2..L), M masked positions a row among its valid ones
    ((B, M) flat indices into the batch's B * L rows) and their (B, M)
    labels, -1 (ignored) for a quarter of them."""
    import numpy as np
    rs = np.random.RandomState(seed)
    lens = rs.randint(L // 2, L + 1, B)
    lens[0] = L
    ids = rs.randint(0, V, (B, L)).astype(np.float32)
    types = (np.arange(L)[None] >= lens[:, None] // 2).astype(np.float32)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    pos = np.stack([rs.choice(n, M, replace=False) for n in lens])
    idx = (np.arange(B)[:, None] * L + pos).astype(np.float32)
    label = ids.reshape(-1)[idx.astype(np.int64)]
    label[rs.rand(B, M) < 0.25] = -1
    return {"data": ids, "token_types": types, "valid_mask": mask,
            "masked_idx": idx, "mlm_label": label}


class DeviceCE:
    """An eval metric that keeps the masked-LM cross-entropy of each batch
    on the device (no host copy of the (B*M, V) probabilities); `losses()`
    fetches them all at once."""

    def __init__(self):
        self.name = "mlm-ce"
        self.reset()

    def reset(self):
        self._losses = []

    def update(self, labels, preds):
        import torch
        lab = labels[0]._t.to(preds[0]._t.device).long().reshape(-1)
        p = preds[0]._t
        ok = lab >= 0
        picked = p.gather(1, lab.clamp(min=0)[:, None])[:, 0]
        self._losses.append(-(torch.log(picked) * ok).sum() / ok.sum())

    def get_name_value(self):
        return [(self.name, 0.0)]

    def losses(self):
        import torch
        return [float(x) for x in torch.stack(self._losses).cpu()] \
            if self._losses else []


def sym_fit(mod, batches, warmup, on_step=None):
    """`mod.fit` over `batches` (dicts of `sym_bert_batch`) as one epoch
    of an NDArrayIter, Adam lr 1e-4, Normal(0.02) weights: (the losses,
    each timed step's ms (CUDA-synchronised at each batch end), the
    launch counts and peak memory of the steps after `warmup`)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import init, io
    # each batch's flat indices point into its own B * L rows
    cat = {k: np.concatenate([b[k] for b in batches])
           for k in SYM_DATA + SYM_LABELS}
    B = len(batches[0]["data"])
    it = io.NDArrayIter({k: cat[k] for k in SYM_DATA},
                        {k: cat[k] for k in SYM_LABELS}, batch_size=B)
    metric, stamps, out = DeviceCE(), [], {}

    def batch_end(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if param.nbatch == warmup - 1:
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
        if on_step:
            on_step(param)

    mod.fit(it, eval_metric=metric, num_epoch=1, optimizer="adam",
            optimizer_params={"learning_rate": 1e-4},
            initializer=init.Normal(0.02), batch_end_callback=batch_end)
    out["counts"] = read_counts()
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    out["step_ms"] = [(b - a) * 1e3 for a, b in zip(stamps[warmup - 1:],
                                                    stamps[warmup:])]
    return metric.losses(), out


def sym_bert_phase(dev, batch=32, seq_len=128, masked=20, warmup=2,
                   steps=16, **widths):
    """Phase 39: the symbolic BERT-base encoder (`bert_symbol` at full
    width, float32, hidden and attention dropout 0.1) trained by
    `Module.fit` with Adam at batch x seq_len (`masked` positions a row):
    exactly `layers` flash forwards, dq and dkv and one Adam launch a
    step; then one step under torch.profiler (idle share, top kernels)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import io as mxio, mod as mxmod, nd as mxnd
    from mxnet_tpu_torch import random as mxrandom
    cfg = dict(SYM_BERT, **widths)
    _, loss = bert_symbol(L=seq_len, **cfg)
    mxrandom.seed(0, dev)
    module = mxmod.Module(loss, data_names=SYM_DATA, label_names=SYM_LABELS,
                          context=dev)
    # the same batch again and again: a falling loss shows the updates
    # reach the weights
    b = sym_bert_batch(batch, seq_len, masked, cfg["V"])
    losses, res = sym_fit(module, [b] * (warmup + steps), warmup)
    n_params = len(module._param_names)
    per = res["counts"]
    want = expect(flash_attention_fwd=cfg["layers"] * steps,
                  flash_attention_dq=cfg["layers"] * steps,
                  flash_attention_dkv=cfg["layers"] * steps,
                  adam_update=steps * adam_launches(
                      [module._exec.arg_dict[n]._t
                       for n in module._param_names]))
    check(per == want, f"symbolic BERT launches {per} != {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"symbolic BERT losses {losses}")
    step_ms = sorted(res["step_ms"])
    dbatch = mxio.DataBatch(
        [mxnd.array(b[k], ctx=torch.device("cpu")) for k in SYM_DATA],
        [mxnd.array(b[k], ctx=torch.device("cpu")) for k in SYM_LABELS])

    def one_step():
        module.forward_backward(dbatch)
        module.update()
        float(module.get_outputs()[0]._t[0, 0])

    prof, prof_ms, windows = profile_once(one_step)
    busy, top, by_class, kernels = device_profile(prof, 1, 10)
    med = step_ms[len(step_ms) // 2]
    out = {"config": f"BERT-base encoder through sym: {cfg['layers']} x "
                     f"{cfg['E']} units, FFN {cfg['F']}, {cfg['H']} heads, "
                     f"vocabulary {cfg['V']}, float32, dropout 0.1 and "
                     "attention dropout 0.1, Adam lr 1e-4",
           "batch": batch, "seq_len": seq_len, "masked_per_row": masked,
           "parameters": n_params,
           "weights": sum(module._exec.arg_dict[n]._t.numel()
                          for n in module._param_names),
           "warmup": warmup, "steps": steps, "ms_per_step": med,
           "ms_per_step_min": step_ms[0], "ms_per_step_max": step_ms[-1],
           "tokens_per_s": batch * seq_len / med * 1e3,
           "losses": losses, "launches": per,
           "launches_per_step": {k: v / steps for k, v in per.items() if v},
           "max_memory_allocated_bytes": res["max_memory_allocated_bytes"],
           "profiled_step_ms": prof_ms, "profile_windows": windows,
           "device_busy_ms_per_step": busy,
           "device_idle_share": None if busy is None else 1 - busy / med,
           "device_ms_per_step_by_class": by_class,
           "kernels_per_step": kernels, "top_device_ms_per_step": top}
    return out


def sym_bert_parity_phase(dev, batch=8, seq_len=128, **widths):
    """Phase 40: the symbolic encoder against `models.bert.BERTModel` on
    the card: a BERTModel at BERT-base width (float32, seeded weights,
    evaluation mode) carried into the symbol's argument names by
    `sym_name_map`, both run forward on one padded batch: the symbolic
    forward (is_train=False) equals the model's hidden states within
    TOL_TRAIN."""
    import torch
    from mxnet_tpu_torch import nd as mxnd
    from mxnet_tpu_torch import random as mxrandom
    from mxnet_tpu_torch.models import bert
    cfg = dict(SYM_BERT, **widths)
    model = bert.BERTModel(cfg["V"], cfg["E"], cfg["F"], cfg["layers"],
                           cfg["H"], max_length=cfg["max_len"])
    model.to(dev)
    model.initialize(generator=mxrandom.seed(3, dev))
    b = sym_bert_batch(batch, seq_len, 4, cfg["V"], seed=5)
    valid = torch.tensor(b["valid_mask"].sum(1), device=dev)
    with torch.no_grad():
        ref, _ = model(torch.tensor(b["data"], device=dev).long(),
                       torch.tensor(b["token_types"], device=dev).long(),
                       valid)
    enc, _ = bert_symbol(L=seq_len, **cfg)
    params = dict(model.named_parameters())
    args = {sym_name_map(k): mxnd.array(v.detach(), ctx=dev)
            for k, v in params.items() if not k.startswith("pooler")}
    args.update({k: mxnd.array(b[k], ctx=dev) for k in SYM_DATA[:3]})
    check(set(args) == set(enc.list_arguments()),
          f"name map: {sorted(set(args) ^ set(enc.list_arguments()))}")
    reset_counts()
    got = enc.bind(ctx=dev, args=args).forward(is_train=False)[0]._t
    counts = read_counts()
    check(counts["flash_attention_fwd"] == cfg["layers"],
          f"symbolic encoder forward launches {counts}")
    err = max_err(got, ref)
    check(err <= TOL_TRAIN, f"symbolic encoder vs BERTModel: {err}")
    return {"batch": batch, "seq_len": seq_len, "layers": cfg["layers"],
            "max_abs_err": err, "tol": TOL_TRAIN,
            "flash_fwd_launches": counts["flash_attention_fwd"]}


def sym_name_map(path):
    """A BERTModel parameter path -> the symbol's argument name."""
    fixed = {"word_embed.weight": "word_embed_weight",
             "token_type_embed.weight": "token_type_embed_weight",
             "position_embed": "position_weight",
             "embed_ln.gamma": "embed_ln_gamma",
             "embed_ln.beta": "embed_ln_beta"}
    if path in fixed:
        return fixed[path]
    _, i, *rest = path.split(".")
    rest = [r for r in rest if r != "attention"]
    return f"l{i}_" + "_".join(rest)


def sym_bucketing_phase(dev, batch=32, lens=(64, 128, 64, 128), masked=20,
                        **widths):
    """Phase 41: `BucketingModule` over sequence lengths {64, 128} of the
    symbolic BERT-base encoder: one Module per length over one parameter
    store, Adam; each step launches `layers` flash forwards, dq and dkv
    and one Adam update, the buckets share every weight NDArray, and the
    losses are finite."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import init, io, mod as mxmod, nd as mxnd
    from mxnet_tpu_torch import random as mxrandom
    cfg = dict(SYM_BERT, **widths)

    def sym_gen(L):
        return bert_symbol(L=L, **cfg)[1], SYM_DATA, SYM_LABELS

    mxrandom.seed(1, dev)
    bm = mxmod.BucketingModule(sym_gen, default_bucket_key=max(lens),
                               context=dev)
    first = sym_bert_batch(batch, max(lens), masked, cfg["V"])
    bm.bind(data_shapes=[(k, first[k].shape) for k in SYM_DATA],
            label_shapes=[(k, first[k].shape) for k in SYM_LABELS])
    bm.init_params(initializer=init.Normal(0.02))
    bm.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 1e-4})
    cpu = torch.device("cpu")
    losses, counts = [], []
    for i, L in enumerate(lens):
        b = sym_bert_batch(batch, L, masked, cfg["V"], seed=10 + i)
        db = io.DataBatch([mxnd.array(b[k], ctx=cpu) for k in SYM_DATA],
                          [mxnd.array(b[k], ctx=cpu) for k in SYM_LABELS])
        db.bucket_key = L
        reset_counts()
        bm.forward_backward(db)
        bm.update()
        m = DeviceCE()
        m.update(db.label, bm.get_outputs())
        losses += m.losses()
        counts.append(read_counts())
    mods = bm._buckets
    check(set(mods) == set(lens), f"buckets {sorted(mods)}")
    names = mods[max(lens)]._param_names
    check(all(mods[L]._exec.arg_dict[n] is mods[max(lens)]._exec.arg_dict[n]
              for L in lens for n in names), "buckets do not share weights")
    want = expect(flash_attention_fwd=cfg["layers"],
                  flash_attention_dq=cfg["layers"],
                  flash_attention_dkv=cfg["layers"], adam_update=1)
    check(all(c == want for c in counts), f"bucket launches {counts}")
    check(all(np.isfinite(losses)), f"bucket losses {losses}")
    return {"lens": list(lens), "losses": losses, "buckets": sorted(mods),
            "launches_per_step": {k: v for k, v in want.items() if v}}


def _sym_mlp_bn():
    from mxnet_tpu_torch import name, sym
    with name.NameManager():
        data = sym.var("data")
        h = sym.FullyConnected(data, num_hidden=32, name="fc1", no_bias=True)
        h = sym.BatchNorm(h, name="bn1")
        h = sym.Activation(h, act_type="relu")
        h = sym.FullyConnected(h, num_hidden=8, name="fc2")
        return sym.SoftmaxOutput(h, name="softmax", normalization="batch")


def _sym_fit_run(device, symbol, data, label, data_names, label_names,
                 params, aux, opt, opt_params, batch=16, metric="acc"):
    """One epoch of Module.fit over `data` on `device` from the carried
    numpy weights: (weights and statistics after, the symbol file of
    its checkpoint)."""
    import tempfile
    import numpy as np
    from mxnet_tpu_torch import io, mod as mxmod, nd as mxnd
    it = io.NDArrayIter(data, label, batch_size=batch)
    module = mxmod.Module(symbol, data_names=data_names,
                          label_names=label_names, context=device)
    module.fit(it, eval_metric=metric() if callable(metric) else metric,
               num_epoch=1, optimizer=opt, optimizer_params=opt_params,
               arg_params={k: mxnd.array(v, ctx=device)
                           for k, v in params.items()},
               aux_params={k: mxnd.array(v, ctx=device)
                           for k, v in aux.items()})
    arg, auxs = module.get_params()
    with tempfile.TemporaryDirectory(prefix="mxt_sym_") as tmp:
        module.save_checkpoint(os.path.join(tmp, "m"), 1)
        with open(os.path.join(tmp, "m-symbol.json"), "rb") as fh:
            js = fh.read()
    return {k: v.asnumpy() for k, v in {**arg, **auxs}.items()}, js


def sym_parity_phase(dev, steps=3):
    """Phase 42: card vs CPU through Module.fit, float32, 3 steps from the
    same weights: a symbolic MLP with BatchNorm and a 2-layer symbolic
    encoder (dropout 0), each with SGD, then with Adam: every weight and
    moving statistic within TOL_TRAIN, the checkpoint's symbol file
    equal, the Adam kernel launched once a step, the encoder's flash
    kernels once a layer a step. The encoder's Adam takes epsilon 1e-4
    (as phase 18's NMT does): its key bias has an exactly zero gradient
    (softmax ignores a score shift shared by all keys), so the bias sees
    only rounding noise, which epsilon 1e-8 would scale up to full-size
    steps of opposite signs on the two devices."""
    import numpy as np
    import torch
    cpu = torch.device("cpu")
    rs = np.random.RandomState(0)
    out = {}
    x = rs.normal(size=(16 * steps, 20)).astype(np.float32)
    y = rs.randint(0, 8, 16 * steps).astype(np.float32)
    mlp_params = {"fc1_weight": rs.normal(0, 0.3, (32, 20)),
                  "bn1_gamma": 1 + rs.normal(0, 0.1, 32),
                  "bn1_beta": rs.normal(0, 0.1, 32),
                  "fc2_weight": rs.normal(0, 0.3, (8, 32)),
                  "fc2_bias": rs.normal(0, 0.1, 8)}
    mlp_params = {k: v.astype(np.float32) for k, v in mlp_params.items()}
    mlp_aux = {"bn1_moving_mean": np.zeros(32, np.float32),
               "bn1_moving_var": np.ones(32, np.float32)}
    tiny = dict(V=128, E=64, F=128, H=4, layers=2, max_len=64)
    enc_params = {k: (rs.normal(0, 0.05, s) + (1.0 if k.endswith("gamma")
                                               else 0.0)).astype(np.float32)
                  for k, s in bert_symbol_params(**tiny).items()}
    enc_params.update(mlm_transform_weight=rs.normal(0, 0.05, (64, 64)),
                      mlm_transform_bias=np.zeros(64),
                      mlm_ln_gamma=np.ones(64), mlm_ln_beta=np.zeros(64),
                      mlm_decoder_weight=rs.normal(0, 0.05, (128, 64)),
                      mlm_decoder_bias=np.zeros(128))
    enc_params = {k: np.asarray(v, np.float32) for k, v in enc_params.items()}
    bs = [sym_bert_batch(4, 32, 5, 128, seed=20 + i) for i in range(steps)]
    enc_data = {k: np.concatenate([b[k] for b in bs]) for k in SYM_DATA}
    enc_label = {k: np.concatenate([b[k] for b in bs]) for k in SYM_LABELS}
    def encoder():
        return bert_symbol(L=32, p=0.0, attn_p=0.0, **tiny)[1]

    mlp = (_sym_mlp_bn, x, y, ("data",), ("softmax_label",), mlp_params,
           mlp_aux)
    enc = (encoder, enc_data, enc_label, SYM_DATA, SYM_LABELS, enc_params,
           {})
    lr = {"learning_rate": 0.05}
    runs = (("mlp_batchnorm_sgd", *mlp, "sgd", lr, 16, "acc"),
            ("mlp_batchnorm_adam", *mlp, "adam", lr, 16, "acc"),
            ("encoder_sgd", *enc, "sgd", lr, 4, DeviceCE),
            ("encoder_adam", *enc, "adam",
             {"learning_rate": 0.01, "epsilon": 1e-4}, 4, DeviceCE))
    for name, build, d, lab, dn, ln, params, aux, opt, kw, batch, met \
            in runs:
        res = {}
        for where, device in (("card", dev), ("cpu", cpu)):
            reset_counts()
            res[where] = _sym_fit_run(device, build(), d, lab, dn, ln,
                                      params, aux, opt, kw, batch, met)
            if where == "card":
                counts = read_counts()
        (card, js_card), (host, js_cpu) = res["card"], res["cpu"]
        check(js_card == js_cpu, f"{name}: symbol files differ")
        err = max(float(np.abs(card[k] - host[k]).max()) for k in host)
        check(err <= TOL_TRAIN, f"{name}: card vs CPU {err}")
        flash = 2 * steps if name.startswith("encoder") else 0
        want = expect(adam_update=steps if opt == "adam" else 0,
                      flash_attention_fwd=flash, flash_attention_dq=flash,
                      flash_attention_dkv=flash)
        check(counts == want, f"{name}: launches {counts} != {want}")
        out[name] = {"max_abs_err": err, "tol": TOL_TRAIN,
                     "launches": {k: v for k, v in counts.items() if v}}
    return out


def sym_kernel_ops_phase(dev):
    """Phase 43: the registry's kernel ops through `sym` on the card:
    `_contrib_quantized_dense` (M = 8, the split-K route, and M = 512,
    the wgmma route) and `_contrib_box_nms` bound and run, equal bit for
    bit to the same ops through `nd` on the same inputs; each symbolic
    run launches its kernel."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import nd as mxnd, sym
    rs = np.random.RandomState(7)
    out = {}
    K, O = 768, 3072
    w = mxnd.array(rs.randint(-127, 128, (O, K)), ctx=dev, dtype="int8")
    s = mxnd.array(rs.rand(O) * 1e-2 + 1e-4, ctx=dev)
    bias = mxnd.array(rs.randn(O), ctx=dev)
    qd = sym.contrib.quantized_dense(sym.var("x"), sym.var("w"),
                                     sym.var("s"), sym.var("b"), relu=True,
                                     name="qd")
    for M, counter in ((8, "int8_matmul"), (512, "int8_matmul_wgmma")):
        x = mxnd.array(rs.randn(M, K), ctx=dev)
        reset_counts()
        got = qd.bind(ctx=dev, args={"x": x, "w": w, "s": s, "b": bias}) \
            .forward()[0]._t
        counts = read_counts()
        check(counts[counter] == 1 and counts["int8_transpose"] == 0,
              f"sym quantized_dense M={M}: launches {counts}")
        ref = mxnd.contrib.quantized_dense(x, w, s, bias, relu=True)._t
        check(torch.equal(got, ref), f"sym quantized_dense M={M} != nd")
        out[f"quantized_dense_M{M}"] = {k: v for k, v in counts.items()
                                        if v}
    B, N = 8, 2048
    rows = np.zeros((B, N, 6), np.float32)
    rows[..., 0] = rs.randint(0, 20, (B, N))
    rows[..., 1] = rs.rand(B, N)
    xy = rs.rand(B, N, 2) * 400
    rows[..., 2:4] = xy
    rows[..., 4:6] = xy + 10 + rs.rand(B, N, 2) * 60
    r = mxnd.array(rows, ctx=dev)
    kw = dict(overlap_thresh=0.45, valid_thresh=0.01, topk=100, id_index=0)
    nms = sym.contrib.box_nms(sym.var("rows"), name="nms", **kw)
    reset_counts()
    got = nms.bind(ctx=dev, args={"rows": r}).forward()[0]._t
    counts = read_counts()
    check(counts["box_nms"] == 1, f"sym box_nms launches {counts}")
    ref = mxnd.contrib.box_nms(r, **kw)._t
    check(torch.equal(got, ref), "sym box_nms != nd box_nms")
    out["box_nms"] = {k: v for k, v in counts.items() if v}
    return out


def sym_flash_phase(dev, B=32, H=12, L=128, D=64, p=0.1,
                    seed=0x5EED_1234_ABCD, key="symbolic_bert_shape",
                    path="phase 39's"):
    """The flash kernels at the symbolic encoder's shape (phase 39's
    path), or with L = 384 and `key="squad_shape"` at SQuAD fine-tuning's
    (phase 51's): (B,H,L,64) float32 with a padding mask (lengths drawn
    in [L/2, L]) and dropout p: forward (its keep mask bit for bit), dq
    and dkv against their plain versions, then timed beside SDPA with the
    same mask (its own dropout mask: times only) and the bound, its
    operations counted over the valid keys only (a masked key adds
    exactly 0: L x the sum of the lengths score pairs a head, not B x
    L^2), at the split-TF32 rate of the tensor cores the three kernels
    run on, with the CUDA-core bound beside it (`bound_ms_f32_cores`,
    the rule of earlier rows). Returns {row: {key: extra fields}}."""
    import torch
    import torch.nn.functional as tF
    from mxnet_tpu_torch.cuda_ops import flash_attention as fa
    q, k, v, g, _ = train_flash_case(dev, torch.float32, B, H=H, L=L, D=D,
                                     seed=4)
    b = sym_bert_batch(B, L, 4, 100)
    valid = torch.tensor(b["valid_mask"], device=dev).bool()
    bias = torch.where(valid, 0.0, fa._NEG).float().contiguous()
    BH = B * H
    check(torch.equal(fa.dropout_mask(seed, BH, L, L, p, dev),
                      fa.dropout_keep_mask(seed, BH, L, L, p, dev)),
          "dropout keep mask at the symbolic encoder's shape differs")
    o, lse = fa.flash_fwd(q, k, v, bias, False, dropout=p, seed=seed)
    ro, rlse = fa.flash_fwd_reference(q, k, v, bias, False, dropout=p,
                                      seed=seed)
    e_fwd = max(max_err(o, ro), max_err(lse, rlse))
    check(e_fwd <= TOL["flash"]["float32"],
          f"flash fwd symbolic shape: max_abs_err {e_fwd}")
    delta = (g * ro).sum(-1).reshape(BH, L)
    bw = (q, k, v, bias, g, rlse, delta, False, None, p, seed)
    ref = fa.flash_bwd_reference(*bw)
    e_dq = max_err(fa.flash_bwd_dq(*bw), ref[0])
    dk, dv = fa.flash_bwd_dkv(*bw)
    e_dkv = max(max_err(dk, ref[1]), max_err(dv, ref[2]))
    check(max(e_dq, e_dkv) <= TOL_BWD["float32"],
          f"flash bwd symbolic shape: dq {e_dq}, dkv {e_dkv}")
    del ro, ref, dk, dv, o, lse
    io_b = BH * L * D * 4
    pairs = H * L * int(valid.sum())      # (query, valid key) pairs
    shape = (f"q/k/v/dO ({B},{H},{L},{D}) float32, the padding mask of "
             f"{path} batch, dropout {p}")
    attn_mask = valid[:, None, None, :]

    def sdpa():
        return tF.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                               dropout_p=p)

    lib_fwd = (time_ms(sdpa), device_ms(sdpa, skip=FLUSH_ONLY),
               f"SDPA forward, the same mask, dropout_p {p} (its own mask: "
               "times only)")
    lib_bwd = (*sdpa_backward_ms(q, k, v, g, attn_mask=attn_mask,
                                 dropout_p=p),
               f"SDPA backward alone, the same mask, dropout_p {p} (dq, dk "
               "and dv together)")
    out = {}
    for row, err, nbytes, flops, fn, plain, lib, rate in (
            ("flash_attention_fwd_dropout", e_fwd,
             4 * io_b + 4 * BH * L + 4 * B * L, 4 * pairs * D,
             lambda: fa.flash_fwd(q, k, v, bias, False, dropout=p,
                                  seed=seed),
             lambda: fa.flash_fwd_reference(q, k, v, bias, False, dropout=p,
                                            seed=seed), lib_fwd,
             SPLIT_TF32_FLOPS),
            ("flash_attention_dq", e_dq, 5 * io_b + 8 * BH * L + 4 * B * L,
             6 * pairs * D, lambda: fa.flash_bwd_dq(*bw),
             lambda: fa.flash_dq_reference(*bw), lib_bwd, SPLIT_TF32_FLOPS),
            ("flash_attention_dkv", e_dkv, 6 * io_b + 8 * BH * L + 4 * B * L,
             8 * pairs * D, lambda: fa.flash_bwd_dkv(*bw),
             lambda: fa.flash_dkv_reference(*bw), lib_bwd,
             SPLIT_TF32_FLOPS)):
        b_ms, b_by = bound(nbytes, flops, rate)
        dms = device_ms(fn, match="mxt::")
        out[row] = {key: dict(
            shapes=shape, valid_key_share=pairs / (BH * L * L),
            max_abs_err=err, ms=time_ms(fn), device_ms=dms,
            plain_ms=time_ms(plain, iters=5), bound_ms=b_ms, bound_by=b_by,
            bound_rate_tflops=rate / 1e12, bound_share_device=b_ms / dms,
            bound_ms_f32_cores=bound(nbytes, flops, F32_FLOPS)[0],
            library_ms=lib[0], library_device_ms=lib[1], library=lib[2])}
    return out


# ---------------------------------------------------------------------------
# phases 44-46: MXNet's eager surface
# ---------------------------------------------------------------------------

class EagerBertLoop:
    """The eager step of GluonNLP's `run_pretraining.py` on the port:
    `autograd.record()`, the model on NDArrays, `bert_pretrain_loss`,
    `backward()`, `gluon.Trainer.step(1)`; `step(data, labels)` as
    `timed_steps` calls a trainer."""

    def __init__(self, model, optimizer_params):
        from mxnet_tpu_torch import gluon
        from mxnet_tpu_torch.models import bert
        self.model = model
        self.loss_fn = bert.bert_pretrain_loss
        self.trainer = gluon.Trainer(model.collect_params(), "lamb",
                                     dict(optimizer_params))

    def step(self, data, labels):
        from mxnet_tpu_torch import autograd
        with autograd.record():
            mlm, nsp = self.model(*data)
            loss = self.loss_fn(mlm, nsp, *labels)
        loss.backward()
        self.trainer.step(1)
        return loss.detach()


def eager_bert_arrays(cfg, batch, seq_len, masked, device, seed=0):
    """(data, labels) of a synthetic pretraining batch as NDArrays."""
    from mxnet_tpu_torch.models import bert
    b = bert.make_synthetic_batch(cfg, batch, seq_len, masked, seed=seed)
    return (nd_arrays([b[k] for k in _DATA], device),
            nd_arrays([b[k] for k in _LABELS], device))


def eager_bert_phase(dev, batch=32, seq_len=128, masked=20, warmup=2,
                     steps=10, **cfg_overrides):
    """Phase 44: eager BERT-base pretraining with `gluon.Trainer(...,
    "lamb")` (see the module docstring). Returns (the result, the launch
    counts of the timed steps); `cfg_overrides` cut it for a rehearsal
    on the CPU."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_base_config(**cfg_overrides)
    model = build_bert(cfg, 0, dev)
    loop = EagerBertLoop(model, {"learning_rate": 1e-4, "wd": 0.01})
    data, labels = eager_bert_arrays(cfg, batch, seq_len, masked, dev)
    losses, counts, timing = timed_steps(loop, data, labels, warmup, steps)
    check(np.isfinite(losses).all(), f"eager BERT-base losses {losses}")
    check(losses[-1] < losses[0], f"eager BERT-base loss did not fall: "
          f"{losses}")
    L = cfg["num_layers"]
    want = expect(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps, lamb_pass1=steps,
                  lamb_pass2=steps)
    check(counts == want, f"eager BERT-base launches {counts} != {want}")
    params = loop.trainer._params
    res = {"model": "bert_base_config(float32, dropout 0.1), masked-LM + NSP"
                    " heads, gluon.Trainer lamb lr 1e-4 wd 0.01",
           "batch": batch, "seq_len": seq_len, "masked": masked,
           "tokens_per_s": batch * seq_len * steps / timing["seconds"],
           "param_count": sum(p.numel() for p in params),
           "tensors": len(params), "losses": losses, **timing}
    del loop, model
    torch.cuda.empty_cache()
    return res, counts


def eager_bert_parity_phase(dev, steps=2, batch=8, seq_len=128, masked=20):
    """A 2-layer float32 BERT at BERT-base's widths (dropout 0) trained
    `steps` eager LAMB steps on the card (flash kernels, both LAMB
    passes) and on the CPU (plain versions) from the same weights: the
    losses and every parameter within 1e-5."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_base_config(num_layers=2, dropout=0.0)
    out = {}
    for where in ("cpu", "cuda"):
        model = build_bert(cfg, 7, "cpu")
        model.to(where)
        loop = EagerBertLoop(model, {"learning_rate": 1e-4, "wd": 0.01})
        data, labels = eager_bert_arrays(cfg, batch, seq_len, masked,
                                         where, seed=3)
        reset_counts()
        losses = [float(loop.step(data, labels)) for _ in range(steps)]
        counts = read_counts()
        out[where] = (losses, {k: p.detach().cpu() for k, p in
                               model.collect_params().items()}, counts)
        del loop, model
    lc, wc, cc = out["cpu"]
    lg, wg, counts = out["cuda"]
    e_loss = float(np.abs(np.subtract(lg, lc)).max())
    e_w = max(max_err(wg[k], wc[k]) for k in wc)
    check(e_loss <= 1e-5 and e_w <= 1e-5,
          f"eager LAMB card vs CPU: losses {lg} vs {lc}, params err {e_w}")
    want = expect(flash_attention_fwd=2 * steps, flash_attention_dq=2 * steps,
                  flash_attention_dkv=2 * steps, lamb_pass1=steps,
                  lamb_pass2=steps)
    check(counts == want, f"eager parity launches {counts} != {want}")
    check(not any(cc.values()), f"CPU run launched kernels {cc}")
    torch.cuda.empty_cache()
    return {"losses_card": lg, "losses_cpu": lc, "max_loss_err": e_loss,
            "max_param_err": e_w, "launches": counts}


# the 17 optimizers of `optimizer.create`, with the options phase 45 sets
EAGER_OPTIMIZERS = (
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("nag", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("adamw", dict(learning_rate=0.01, wd=0.1)),
    ("lamb", dict(learning_rate=0.01, wd=0.01)),
    ("adagrad", dict(learning_rate=0.1, wd=0.01)),
    ("rmsprop", dict(learning_rate=0.01, centered=True)),
    ("ftrl", dict(learning_rate=0.1, wd=0.01)),
    ("signum", dict(learning_rate=0.01, wd_lh=0.01)),
    ("signsgd", dict(learning_rate=0.01)),
    ("lars", dict(learning_rate=0.1, wd=0.01)),
    ("adamax", dict(learning_rate=0.01)),
    ("nadam", dict(learning_rate=0.01, wd=0.01)),
    ("adadelta", dict(rho=0.9, epsilon=1e-4)),
    ("dcasgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgld", dict(learning_rate=0.05)),
    ("ftml", dict(learning_rate=0.05)),
)


def optimizer_updates(name, kw, w, gs, ctx):
    """(weight, state arrays, launch counts) after len(gs) `update`s of
    one optimizer through NDArrays on `ctx`."""
    from mxnet_tpu_torch import nd, optimizer
    o = optimizer.create(name, **kw)
    weight = nd.array(w, ctx=ctx)
    state = o.create_state(0, weight)
    reset_counts()
    for g in gs:
        o.update(0, weight, nd.array(g, ctx=ctx), state)
    counts = read_counts()
    parts = state if isinstance(state, tuple) else (state,)
    check(all(s is None or isinstance(s, nd.NDArray) for s in parts),
          f"{name} states {[type(s) for s in parts]}")
    return (weight.asnumpy(), [s.asnumpy() for s in parts if s is not None],
            counts)


def sgld_samples(ctx, steps=400):
    """SGLD on the quadratic of `test_sgld_samples_around_mode`."""
    import numpy as np
    from mxnet_tpu_torch import nd, optimizer
    from mxnet_tpu_torch import random as mxrandom
    mxrandom.seed(0, ctx)
    target = np.array([1.0, -2.0], np.float32)
    w = nd.array(np.zeros(2, np.float32), ctx=ctx)
    o = optimizer.create("sgld", learning_rate=0.05)
    samples = []
    for step in range(steps):
        o.update(0, w, nd.array(w.asnumpy() - target, ctx=ctx), None)
        if step > 200:
            samples.append(w.asnumpy().copy())
    samples = np.asarray(samples)
    return {"max_dist_to_mode": float(np.abs(samples - target).max()),
            "min_std": float(np.std(samples, axis=0).min()),
            "finite": bool(np.isfinite(samples).all())}


class plain_lamb_passes:
    """Within the block the LAMB passes run their plain versions on any
    device (`fused_update.lamb_pass*` replaced by `lamb_pass*_reference`):
    the plain side of the eager route's check."""

    def __enter__(self):
        from mxnet_tpu_torch.cuda_ops import fused_update as fu
        self.saved = (fu.lamb_pass1, fu.lamb_pass2)
        fu.lamb_pass1 = fu.lamb_pass1_reference
        fu.lamb_pass2 = fu.lamb_pass2_reference
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.cuda_ops import fused_update as fu
        fu.lamb_pass1, fu.lamb_pass2 = self.saved
        return False


# phase 45's LAMB route shape: BERT-base's word embedding
EAGER_ROUTE_SHAPE = (30522, 768)


def eager_lamb_route(dev, shape=None, seed=0):
    """LAMB's eager `update` (the kernel route) against the same update
    with the plain passes, on the card, at `shape` (BERT-base's word
    embedding), 3 steps from the same state; then one update timed:
    CUDA events around the whole update (`time_ms`: the copies into and
    out of the flat layout, both passes, the segment sums) and profiler
    device time of the two passes, against the bound of the bytes the
    update must move (w, g, m, v read once, w, m, v written once, all
    float32)."""
    import torch
    from mxnet_tpu_torch import nd, optimizer
    shape = shape or EAGER_ROUTE_SHAPE
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w0 = torch.randn(shape, generator=gen, device=dev) * 0.02
    gs = [torch.randn(shape, generator=gen, device=dev) * 1e-3
          for _ in range(3)]
    runs = {}
    for route in ("kernel", "plain"):
        o = optimizer.create("lamb", learning_rate=1e-4, wd=0.01)
        w = nd.array(w0.clone(), ctx=dev)
        st = o.create_state(0, w)
        reset_counts()
        if route == "plain":
            with plain_lamb_passes():
                for g in gs:
                    o.update(0, w, nd.array(g, ctx=dev), st)
        else:
            for g in gs:
                o.update(0, w, nd.array(g, ctx=dev), st)
        torch.cuda.synchronize()
        runs[route] = (w._t.clone(), [s._t.clone() for s in st],
                       read_counts(), o, w, st)
    wk, sk, ck, o, w, st = runs["kernel"]
    wp, sp, cp = runs["plain"][:3]
    err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
              for a, b in [(wk, wp)] + list(zip(sk, sp)))
    check(err <= TOL_LAMB, f"eager LAMB route vs plain: relative err {err}")
    check(ck == expect(lamb_pass1=3, lamb_pass2=3),
          f"eager LAMB launches {ck}")
    check(cp == expect(), f"plain eager LAMB launched kernels {cp}")
    g = nd.array(gs[0], ctx=dev)

    def step():
        o.update(0, w, g, st)
    n = w0.numel()
    nbytes = 7 * 4 * n                     # w, g, m, v in; w, m, v out
    b_ms, b_by = bound(nbytes, 30 * n, F32_FLOPS)
    ms = time_ms(step)
    # the profiler drops some records of an update's ~23 kernels and
    # copies, so each pass is timed as the mean of its kept records
    kms = sum(device_ms(step, match=k, per_kernel=True)
              for k in ("lamb1_kernel", "lamb2_kernel"))
    with plain_lamb_passes():
        plain = time_ms(step, iters=5)
    return {"shape": list(shape), "elements": n, "max_abs_err": err,
            "error_is": "relative to the largest |plain| over w, m, v "
                        "after 3 updates",
            "launches_per_update": {"lamb_pass1": 1, "lamb_pass2": 1},
            "ms": ms, "device_ms": kms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "bytes_per_call": nbytes,
            "bound_share_device": b_ms / kms, "library_ms": None,
            "times_are": "ms: CUDA events around one update (L2 flushed; "
                         "the flat copies and the host's part included); "
                         "device_ms: torch.profiler device time of the two "
                         "passes"}


def eager_optimizers_phase(dev, shape=(256, 384), steps=3, seed=0):
    """Phase 45 (see the module docstring)."""
    import math

    import numpy as np
    import torch
    from mxnet_tpu_torch import nd, optimizer
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    gs = [rng.randn(*shape).astype(np.float32) for _ in range(steps)]
    rows = {}
    for name, kw in EAGER_OPTIMIZERS:
        if name == "sgld":
            card, cpu = sgld_samples(dev), sgld_samples("cpu")
            for r in (card, cpu):
                check(r["finite"] and r["max_dist_to_mode"] < 5.0
                      and r["min_std"] > 0.01, f"SGLD samples {r}")
            rows[name] = {"card": card, "cpu": cpu}
            continue
        wg, sg, counts = optimizer_updates(name, kw, w, gs, dev)
        wc, sc, _ = optimizer_updates(name, kw, w, gs, "cpu")
        err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                  for a, b in [(wg, wc)] + list(zip(sg, sc)))
        check(err <= 1e-5, f"optimizer {name} card vs CPU: relative err "
              f"{err}")
        check(not np.allclose(wg, w), f"optimizer {name} did not move")
        rows[name] = {"max_rel_err": err,
                      "launches": {k: v for k, v in counts.items() if v}}
    check(rows["adam"]["launches"] == {"adam_update": steps}
          and rows["lamb"]["launches"] == {"lamb_pass1": steps,
                                           "lamb_pass2": steps},
          f"optimizer launches {rows['adam']}, {rows['lamb']}")
    # nd.adam_update by name: one Adam launch, Adam.update's result
    t = 1
    o = optimizer.create("adam", learning_rate=0.01, wd=0.01)
    wt, gt = nd.array(w, ctx=dev), nd.array(gs[0], ctx=dev)
    st = o.create_state(0, wt)
    reset_counts()
    nw, nm, nv = nd.adam_update(
        wt, gt, st[0], st[1],
        0.01 * math.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t), wd=0.01)
    by_name = read_counts()
    o.update(0, wt, gt, st)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a._t, b._t) for a, b in
                    ((nw, wt), (nm, st[0]), (nv, st[1])))
    check(by_name == expect(adam_update=1), f"nd.adam_update {by_name}")
    check(bit_equal, "nd.adam_update != Adam.update")
    rows["nd.adam_update"] = {"launches": 1, "bit_equal_to_Adam_update":
                              bit_equal}
    route = eager_lamb_route(dev)
    torch.cuda.empty_cache()
    return rows, route


# ---------------------------------------------------------------------------
# phases 47-48: the observability layer (telemetry, trace, diagnostics,
# profiler, inspect) on the main paths
# ---------------------------------------------------------------------------

def obs_arm(tmp, skew_every=4):
    """Telemetry, trace (every step sampled, spans to `tmp`/trace) and
    diagnostics (post-mortems to `tmp`/diag) on, all state reset."""
    from mxnet_tpu_torch import diagnostics, telemetry, trace
    os.makedirs(tmp, exist_ok=True)
    for m in (telemetry, trace, diagnostics):
        m.reset()
    telemetry.enable()
    trace.enable(trace_dir=os.path.join(tmp, "trace"), rank=0,
                 sample_every=1, skew_every=skew_every)
    diagnostics.install(diagnostics_dir=os.path.join(tmp, "diag"), rank=0)


def obs_disarm():
    from mxnet_tpu_torch import diagnostics, telemetry, trace
    diagnostics.uninstall()
    trace.disable()
    telemetry.disable()
    for m in (telemetry, trace, diagnostics):
        m.reset()


def obs_bert_run(dev, steps, observe, tmp=None, batch=32, seq_len=512,
                 masked=76, **cfg_overrides):
    """Phase 6's BERT-base trainer (seed 0, bf16, dropout 0.1, LAMB, 32 x
    512 with 76 masked positions) for `steps` steps, the observers on
    when `observe`. Returns (losses as floats, launch counts, ms per
    step of steps 2..n by the host clock with the card synchronised at
    both ends, what the observers saw)."""
    import torch
    from mxnet_tpu_torch import parallel, telemetry
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_base_config(dtype="bfloat16", **cfg_overrides)
    model = build_bert(cfg, 0, dev)
    trainer = parallel.ShardedTrainer(
        model, bert.bert_pretrain_loss, "lamb",
        {"learning_rate": 1e-3, "wd": 0.01}, device=dev)
    b = bert.make_synthetic_batch(cfg, batch, seq_len, masked, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _LABELS]
    if observe:
        obs_arm(tmp)
    seen = None
    try:
        reset_counts()
        losses = [trainer.step(data, labels)]
        sync(model)
        t0 = time.perf_counter()
        losses += [trainer.step(data, labels) for _ in range(steps - 1)]
        sync(model)
        ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        counts = read_counts()
        if observe:
            events = [e["kind"] for e in telemetry.events()]
            files, spans = obs_files(tmp)
            by_step = {}
            for sp in spans:
                by_step.setdefault(sp.get("step"), []).append(sp["name"])
            seen = {
                "events": events,
                "step_seconds_count":
                    telemetry.get("trainer_step_seconds").count,
                "compile_total": telemetry.get("compile_total").value,
                "spans": {k: sorted(v) for k, v in by_step.items()},
                "files": files}
    finally:
        if observe:
            obs_disarm()
    out = [float(x) for x in losses]
    del trainer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, counts, ms, seen


def obs_files(tmp):
    """Write the telemetry JSONL and the span file, read both back, and
    merge the span file into a chrome trace with tools/trace_report.py;
    returns (what was read, every span of the file: the recorder
    appends to it every 256 records)."""
    from mxnet_tpu_torch import telemetry, trace
    jsonl = telemetry.dump_jsonl(os.path.join(tmp, "telemetry.jsonl"))
    with open(jsonl) as fh:
        lines = [json.loads(line) for line in fh]
    check(lines and lines[-1]["kind"] == "snapshot"
          and "trainer_step_seconds" in lines[-1]["metrics"],
          f"telemetry JSONL {jsonl}: last line {lines[-1:]}")
    spans_path = trace.flush()
    with open(spans_path) as fh:
        recs = [json.loads(line) for line in fh]
    check(recs and recs[0]["kind"] == "meta", f"span file {spans_path}")
    merged = os.path.join(tmp, "trace_merged.json")
    rep = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_report.py"),
         os.path.join(tmp, "trace"), "--out", merged], capture_output=True,
        text=True, timeout=120)
    check(rep.returncode == 0, f"trace_report: {rep.stdout[-2000:]} "
          f"{rep.stderr[-2000:]}")
    with open(merged) as fh:
        doc = json.load(fh)
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    check(xs and all(e["dur"] >= 0 and e["ts"] >= 0 and e["name"]
                     for e in xs), f"merged chrome trace {merged}")
    return {"telemetry_jsonl_lines": len(lines), "span_records": len(recs),
            "chrome_trace_events": len(doc["traceEvents"]),
            "verdict": [ln for ln in rep.stdout.splitlines()
                        if "verdict" in ln][:1]}, \
        [r for r in recs if r["kind"] == "span"]


def obs_serve_run(model, observe, tmp=None, **kw):
    """Phase 2's traffic through `Server(pages="on")`, the observers on
    when `observe`. Returns (tokens per request, launch counts, server
    stats, seconds, what the observers saw)."""
    from mxnet_tpu_torch import telemetry
    if observe:
        obs_arm(tmp)
    seen = None
    try:
        reset_counts()
        reqs, stats, secs = serving_phase(model, **kw)
        counts = read_counts()
        if observe:
            names = {}
            for sp in obs_files(tmp)[1]:
                names[sp["name"]] = names.get(sp["name"], 0) + 1
            outcomes = telemetry.get("serve_requests_total")._children
            seen = {
                "tokens_total": telemetry.get("serve_tokens_total").value,
                "completed": sum(c.value for k, c in outcomes.items()
                                 if dict(k).get("outcome") == "completed"),
                "ttft_count": telemetry.get("serve_ttft_seconds").count,
                "queue_wait_count":
                    telemetry.get("serve_queue_wait_seconds").count,
                "spans": names}
    finally:
        if observe:
            obs_disarm()
    return [list(r.tokens) for r in reqs], counts, stats, secs, seen


def observability_phase(dev, steps=8, serve_model=None, serve_kw=None,
                        **train_kw):
    """Phase 47: BERT-base training and phase 2's serving, each off, on,
    off in this process. Bit equal losses and tokens, equal launch
    counts; the observers' counts against the runs'; ms per step and
    tokens/s printed, not gated. `serve_model`, `serve_kw` and
    `train_kw` cut it for a rehearsal on the CPU."""
    import tempfile
    import torch
    from mxnet_tpu_torch.models import gpt
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    runs = [obs_bert_run(dev, steps, observe, os.path.join(tmp, "train"),
                         **train_kw) for observe in (False, True, False)]
    (l0, c0, ms0, _), (l1, c1, ms1, seen), (l2, c2, ms2, _) = runs
    check(l0 == l2, f"BERT-base off runs differ: {l0} {l2}")
    check(l1 == l0, f"BERT-base losses with the layer on {l1} != off {l0}")
    check(c0 == c1 == c2, f"launch counts off {c0}, on {c1}, off {c2}")
    check(dev.type != "cuda" or c1["flash_attention_fwd"] > 0,
          "flash kernel never launched")
    check(seen["step_seconds_count"] == steps - 1
          and seen["compile_total"] == 1,
          f"trainer_step_seconds {seen['step_seconds_count']}, "
          f"compile_total {seen['compile_total']}")
    want = {1: ["step.compile"]}
    want.update({i: ["step.dispatch", "step.fence"]
                 for i in range(2, steps + 1)})
    check(seen["spans"] == want, f"trainer spans {seen['spans']}")
    # the skew probe runs on every 4th step, after that step's event
    events = []
    for i in range(1, steps + 1):
        events += ["compile" if i == 1 else "step"] \
            + (["trace_skew"] if i % 4 == 0 else [])
    check(seen["events"] == events, f"telemetry events {seen['events']}")
    train = {"losses_bit_equal": True, "launches": c1,
             "ms_per_step_off": [ms0, ms2], "ms_per_step_on": ms1,
             "events": seen["events"], "files": seen["files"]}
    del runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    model = serve_model or build_model(gpt.gpt2_117m_config(
        dtype="bfloat16", **SERVE_DEPTH), seed=0)
    runs = [obs_serve_run(model, observe, os.path.join(tmp, "serve"),
                          **(serve_kw or {}))
            for observe in (False, True, False)]
    (t0, c0, s0, sec0, _), (t1, c1, s1, sec1, seen), (t2, c2, _, sec2, _) = \
        runs
    check(t0 == t2, "serving off runs differ")
    check(t1 == t0, "served tokens with the layer on != off")
    check(c0 == c1 == c2, f"serving launches off {c0}, on {c1}, off {c2}")
    n_req, n_tok = len(t1), sum(len(t) for t in t1)
    check(seen["tokens_total"] == s1["tokens"] == n_tok
          and seen["completed"] == s1["completed"] == n_req,
          f"serve counters {seen} against stats {s1}")
    check(seen["ttft_count"] == seen["queue_wait_count"] == n_req,
          f"TTFT / queue-wait counts {seen}")
    sp = seen["spans"]
    check(sp.get("serve.queue_wait") == sp.get("serve.admit") == n_req
          and sp.get("serve.decode_step") == sp.get("serve.stream")
          == s1["steps"], f"serving spans {sp} (rounds {s1['steps']})")
    serving = {"tokens_bit_equal": True, "launches": c1,
               "tokens_per_s_off": [n_tok / sec0, n_tok / sec2],
               "tokens_per_s_on": n_tok / sec1, "rounds": s1["steps"],
               "spans": sp}
    return {"training": train, "serving": serving}


def analytic_bert_flops(cfg, B, S, M):
    """The matmul FLOPs of one BERT pretraining step: forward and
    backward (2x the forward) of every Dense of the encoder on B*S
    tokens, the pooler and NSP head on B, the MLM transform and the tied
    decoder on the B*M masked positions, and the attention kernels'
    products as `inspect` counts them (forward 2, dq 3 and dkv 4 L x L
    products a layer)."""
    D, F, V = cfg["units"], cfg["hidden_size"], cfg["vocab_size"]
    L, H = cfg["num_layers"], cfg["num_heads"]
    d = D // H
    dense = 6 * B * S * L * (4 * D * D + 2 * D * F)
    heads = 6 * B * (D * D + 2 * D) + 6 * B * M * (D * D + D * V)
    attention = 9 * 2 * B * H * S * S * d * L
    return dense + heads + attention, attention


def diag_profile_inspect_phase(dev, B=32, S=512, M=76, **cfg_overrides):
    """Phase 48 on one BERT-base trainer (32 x 512, 76 masked):
    inspect, the profiler, the watchdog and the NaN sentinel.
    `cfg_overrides` and a smaller batch cut it for a rehearsal on the
    CPU (where the profiler names no kernels)."""
    import math
    import tempfile
    import torch
    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch import diagnostics, inspect as mxinspect
    from mxnet_tpu_torch import parallel, profiler
    from mxnet_tpu_torch.models import bert
    tmp = tempfile.mkdtemp(prefix="chip_smoke_diag_")
    cfg = bert.bert_base_config(dtype="bfloat16", **cfg_overrides)
    on_card = dev.type == "cuda"
    model = build_bert(cfg, 0, dev)
    trainer = parallel.ShardedTrainer(
        model, bert.bert_pretrain_loss, "lamb",
        {"learning_rate": 1e-3, "wd": 0.01}, device=dev)
    b = bert.make_synthetic_batch(cfg, B, S, M, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _LABELS]
    out = {}

    # inspect: the first step counted, three timed
    mxinspect.reset()
    mxinspect.enable()
    try:
        for _ in range(4):
            trainer.step(data, labels)
        rec = mxinspect.get(f"ShardedTrainer({type(model).__name__})")
    finally:
        mxinspect.disable()
    want, attn = analytic_bert_flops(cfg, B, S, M)
    check(rec is not None and rec.compiles == 1 and rec.steps == 3,
          f"inspect record {rec and rec.as_dict()}")
    check(abs(rec.flops - want) <= 0.1 * want,
          f"inspect flops {rec.flops:.4g}, analytic {want:.4g}")
    out["inspect"] = {k: v for k, v in rec.as_dict().items()
                      if k not in ("key", "created")}
    out["inspect"].update({"analytic_flops": want,
                           "analytic_attention_flops": attn,
                           "flops_over_analytic": rec.flops / want})
    mxinspect.reset()

    # the profiler around two steps: the kernels by their CUDA names
    prof_path = os.path.join(tmp, "profile.json")
    profiler.set_config(filename=prof_path, aggregate_stats=True)
    reset_counts()
    profiler.set_state("run")
    try:
        for _ in range(2):
            trainer.step(data, labels)
    finally:
        profiler.set_state("stop")
    counts = read_counts()
    with open(profiler.dump()) as fh:
        doc = json.load(fh)
    names = [e["name"] for e in doc["traceEvents"]
             if e.get("cat") == "kernel"]
    seen = {row: sum(1 for n in names if kern in n) for row, kern in (
        ("flash_attention_fwd", "flash_fwd_wgmma_kernel"),
        ("flash_attention_dq", "dq_wgmma_kernel"),
        ("flash_attention_dkv", "dkv_wgmma_kernel"),
        ("lamb_pass1", "lamb1_kernel"), ("lamb_pass2", "lamb2_kernel"))}
    if on_card:
        check(all(seen[r] == counts[r] and counts[r] > 0 for r in seen),
              f"profiler kernels {seen} against launches {counts}")
    out["profiler"] = {"kernels_named": seen, "launches": {
        r: counts[r] for r in seen}, "device_events": len(names)}

    # the watchdog over an injected stall
    mxconfig.set("watchdog_deadline_s", 1.0)
    wd_dir = os.path.join(tmp, "watchdog")
    try:
        diagnostics.install(diagnostics_dir=wd_dir, rank=0)
        check(diagnostics._watchdog is not None, "watchdog not armed")
        trainer.step(data, labels)
        sync(model)
        with diagnostics.scope("injected_stall", trainer.num_update + 1):
            time.sleep(2.5)
        fired = diagnostics._watchdog.fired
    finally:
        diagnostics.uninstall()
        diagnostics.reset()
        mxconfig.reset("watchdog_deadline_s")
    stacks = os.path.join(wd_dir, "0", "watchdog_stacks.txt")
    with open(os.path.join(wd_dir, "0", "postmortem.json")) as fh:
        pm = json.load(fh)
    check(fired == 1 and os.path.getsize(stacks) > 0
          and pm["reason"] == "watchdog"
          and "stuck in injected_stall" in pm["note"],
          f"watchdog fired {fired}, post-mortem {pm.get('reason')} "
          f"{pm.get('note')}")
    out["watchdog"] = {"fired": fired, "note": pm["note"],
                       "stacks_bytes": os.path.getsize(stacks)}

    # the NaN sentinel: a NaN loss at this run's third step
    calls = [0]
    plain = trainer.loss_fn

    def nan_at_third(*a):
        calls[0] += 1
        loss = plain(*a)
        return loss * float("nan") if calls[0] == 3 else loss

    trainer.loss_fn = nan_at_third
    nan_dir = os.path.join(tmp, "nan")
    mxconfig.set("nan_sentinel", True)
    raised = None
    try:
        diagnostics.install(diagnostics_dir=nan_dir, rank=0)
        for _ in range(4):
            trainer.step(data, labels)
    except diagnostics.NonFiniteError as e:
        raised = str(e)
    finally:
        diagnostics.uninstall()
        diagnostics.reset()
        mxconfig.reset("nan_sentinel")
        trainer.loss_fn = plain
    with open(os.path.join(nan_dir, "0", "postmortem.json")) as fh:
        pm = json.load(fh)
    last = pm["ring"][-1]
    cards = [m for m in pm["memory"] if m["device"].startswith("cuda")]
    check(raised is not None and calls[0] == 3 and pm["reason"] == "nan"
          and last["kind"] == "step" and math.isnan(last["loss"])
          and (cards or not on_card)
          and all(m["peak_bytes_in_use"] > 0 for m in cards),
          f"NaN sentinel: raised {raised}, post-mortem {pm.get('reason')}, "
          f"ring tail {pm['ring'][-2:]}, memory {pm['memory']}")
    out["nan_sentinel"] = {"error": raised, "ring_tail": pm["ring"][-2:],
                           "memory": pm["memory"]}
    del trainer, model
    if on_card:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 49-50: the operations layer (goodput, guard, slo, check, scope)
# on the serving and training paths
# ---------------------------------------------------------------------------

HANG_STEP = 5              # phase 50's child: `hang@step:5`
HANG_DEADLINE_S = 2.0      # its guard step deadline


def hang_child(directory):
    """Phase 50's child process: a small Dense net trained on the CPU
    under the `hang@step:5` fault, with mx.guard's step deadline
    (HANG_DEADLINE_S), heartbeats and diagnostics writing under
    `directory`. Step 5's boundary never returns; the deadline names the
    stall in a post-mortem and exits EXIT_PEER_LOST (86). Never returns
    normally."""
    import numpy as np
    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch import (context, diagnostics, gluon, guard, nd,
                                 parallel, resilience)
    from mxnet_tpu_torch import random as mxrandom
    mxconfig.set("fault_inject", f"hang@step:{HANG_STEP}")
    resilience.enable()
    diagnostics.install(diagnostics_dir=directory, rank=0)
    guard.enable(guard_dir=directory, rank=0,
                 collective_timeout_s=HANG_DEADLINE_S)
    mxrandom.seed(0, "cpu")
    net = gluon.nn.Dense(4, in_units=8)
    net.initialize(device="cpu")
    lfn = gluon.loss.L2Loss()
    tr = parallel.ShardedTrainer(net, lambda o, l: lfn(o, l), "sgd",
                                 {"learning_rate": 0.1}, device="cpu")
    x = nd.array(np.ones((8, 8), np.float32), ctx=context.cpu())
    y = nd.array(np.zeros((8, 4), np.float32), ctx=context.cpu())
    for i in range(1, 2 * HANG_STEP):
        tr.step(x, y)
        print(f"hang child: step {i} done", flush=True)
    print("hang child: the hang never fired", flush=True)
    sys.exit(1)


def start_hang_child(directory):
    """Start phase 50's child (`--hang-child DIR`), on the CPU."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--hang-child",
         directory], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def hang_child_result(proc, directory, timeout=120):
    """Wait for the child; its exit code, the post-mortem's reason and
    guard section, and the seconds from its last step to the exit are
    checked and returned."""
    out = proc.communicate(timeout=timeout)[0]
    check(proc.returncode == 86,
          f"hang child exit {proc.returncode} (want 86): {out[-3000:]}")
    check(f"hang at step {HANG_STEP}" in out,
          f"the hang fault did not fire: {out[-3000:]}")
    with open(os.path.join(directory, "0", "postmortem.json")) as fh:
        pm = json.load(fh)
    lost = (pm.get("guard") or {}).get("peer_lost") or {}
    check(pm.get("reason") == "peer_lost"
          and f"@ step {HANG_STEP}" in str(lost.get("note")),
          f"post-mortem reason {pm.get('reason')!r}, guard {lost}")
    beat = lost.get("last_heartbeat") or {}
    return {"exit": proc.returncode, "postmortem_reason": pm["reason"],
            "deadline_note": lost.get("note"),
            "last_heartbeat": {k: beat.get(k) for k in ("step", "phase")},
            "deadline_s": HANG_DEADLINE_S}


def ops_arm(tmp, guard_kw=None):
    """slo (every journal written), goodput, guard's heartbeats, check
    (warn) and scope on an ephemeral port, with telemetry for the serve
    histograms; files under `tmp`. Returns scope's port."""
    from mxnet_tpu_torch import check as mxcheck
    from mxnet_tpu_torch import goodput, guard, scope, slo, telemetry
    os.makedirs(tmp, exist_ok=True)
    for m in (telemetry, slo, goodput, guard, mxcheck):
        m.reset()
    telemetry.enable()
    slo.enable(slo_dir=os.path.join(tmp, "slo"), rank=0, sample_every=1)
    goodput.enable(goodput_dir=os.path.join(tmp, "goodput"), rank=0)
    guard.enable(guard_dir=os.path.join(tmp, "guard"), rank=0,
                 **(guard_kw or {}))
    mxcheck.enable("warn")
    return scope.enable(port=0)


def ops_disarm():
    from mxnet_tpu_torch import check as mxcheck
    from mxnet_tpu_torch import config as mxconfig
    from mxnet_tpu_torch import goodput, guard, scope, slo, telemetry
    scope.disable()
    for m in (slo, goodput, guard, mxcheck, telemetry):
        m.disable()
    for m in (slo, goodput, guard, mxcheck, telemetry):
        m.reset()
    mxconfig.reset("check")


def http_get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def ops_serve_check(srv, port, tmp):
    """While the armed run's server is alive: /statusz lists it, /metrics
    parses as Prometheus text, tools/scope_top.py renders the rank."""
    base = f"http://127.0.0.1:{port}"
    st = json.loads(http_get(base + "/statusz"))
    servers = (st.get("serve") or {}).get("servers") or []
    check(any(s == srv.stats() for s in servers),
          f"/statusz does not list the live server: {st.get('serve')}")
    text = http_get(base + "/metrics")
    samples = [ln for ln in text.splitlines()
               if ln and not ln.startswith("#")]
    for ln in samples:
        float(ln.rsplit(" ", 1)[1])        # every sample line parses
    check(any(ln.startswith("serve_tokens_total") for ln in samples),
          "/metrics lacks serve_tokens_total")
    top = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "scope_top.py"),
         "--port", str(port), "--once"], capture_output=True, text=True,
        timeout=60)
    check(top.returncode == 0 and top.stdout.strip(),
          f"scope_top: {top.stdout[-2000:]} {top.stderr[-2000:]}")
    return {"statusz_servers": len(servers), "metrics_samples":
            len(samples), "scope_top_lines": len(top.stdout.splitlines())}


def ops_serve_run(model, armed, tmp, **kw):
    """Phase 2's traffic through `Server(pages="on")`, the layer armed
    when `armed`. Returns (tokens per request, launch counts, stats,
    seconds, what the layer saw)."""
    from mxnet_tpu_torch import check as mxcheck
    from mxnet_tpu_torch import goodput, slo, telemetry
    port = ops_arm(tmp) if armed else None
    seen = {}
    try:
        reset_counts()
        reqs, stats, secs = serving_phase(
            model, during=(lambda srv: seen.update(
                ops_serve_check(srv, port, tmp))) if armed else None, **kw)
        counts = read_counts()
        if armed:
            slo.flush_summary()
            goodput.flush()
            seen["findings"] = mxcheck.findings()
            seen["goodput"] = goodput.snapshot()["categories"]
            h = telemetry.get("serve_ttft_seconds")
            seen["ttft_hist"] = (h.count, h.sum)
            seen["ttft_req_ms"] = {r.id: r.ttft_s * 1e3 for r in reqs}
            seen["access"] = os.path.join(tmp, "slo", "0", "access.jsonl")
    finally:
        if armed:
            ops_disarm()
    return [list(r.tokens) for r in reqs], counts, stats, secs, seen


def ops_profile_paged(model, tmp):
    """A capture through scope's `request_profile`, driven at scope's step
    hook around two serving requests: the chrome trace names the paged
    attention kernel. Returns the kernel names that match."""
    import numpy as np
    from mxnet_tpu_torch import scope, serve
    scope.enable(port=0)
    try:
        rec = scope.request_profile(1, trace_dir=os.path.join(tmp, "prof"))
        scope.on_step(None, 1)                 # starts the capture
        srv = serve.Server(model, **PAGED_KW)
        rng = np.random.RandomState(9)
        V = model.cfg["vocab_size"]
        for _ in range(2):
            srv.submit(rng.randint(0, V, (40,)).astype(np.int32),
                       max_new_tokens=8)
        srv.drain()
        srv.stop()
        sync(model)
        scope.on_step(None, 2)                 # stops it, writes the trace
        check(rec["done"].is_set() and rec["error"] is None,
              f"profile capture {scope.profile_status()}")
    finally:
        scope.disable()
    with open(os.path.join(rec["dir"], "trace.json")) as fh:
        doc = json.load(fh)
    names = sorted({e.get("name", "") for e in doc.get("traceEvents", [])
                    if e.get("cat") == "kernel"
                    and "paged_attention" in e.get("name", "")})
    check(names, "the profile names no paged attention kernel")
    return names


def ops_serve_phase(model, tmp, **kw):
    """Phase 49: phase 2's traffic off, on, off. Tokens bit equal and
    launches equal; a journal record with a verdict for every request,
    its TTFT against the request's and serve_ttft_seconds; no check
    finding; /statusz, /metrics, scope_top; a profile naming the paged
    kernel; tools/slo_report.py over the journal; tokens/s."""
    runs = [ops_serve_run(model, armed, os.path.join(tmp, "serve"), **kw)
            for armed in (False, True, False)]
    (t0, c0, s0, sec0, _), (t1, c1, s1, sec1, seen), (t2, c2, _, sec2, _) = \
        runs
    check(t0 == t2, "serving off runs differ")
    check(t1 == t0, "served tokens with the layer on != off")
    check(c0 == c1 == c2, f"serving launches off {c0}, on {c1}, off {c2}")
    n_req, n_tok = len(t1), sum(len(t) for t in t1)
    recs = [json.loads(ln) for ln in open(seen["access"])]
    access = {r["req"]: r for r in recs if r["kind"] == "access"}
    check(sorted(access) == sorted(seen["ttft_req_ms"])
          and all(r["verdict"] == "200 ok" and r["good"] is True
                  for r in access.values()),
          f"journal: {len(access)} records for {n_req} requests")
    gap = max(abs(access[i]["ttft_ms"] - ms)
              for i, ms in seen["ttft_req_ms"].items())
    check(gap < 1.0, f"journal TTFT {gap:.3f} ms from the request's")
    count, total = seen["ttft_hist"]
    jsum = sum(r["ttft_ms"] for r in access.values()) / 1e3
    check(count == n_req and abs(total - jsum) < 1e-3 * n_req,
          f"serve_ttft_seconds {count} / {total} against the journal "
          f"{len(access)} / {jsum}")
    check(seen["findings"] == [], f"check findings {seen['findings']}")
    check("serve_decode" in seen["goodput"],
          f"goodput categories {seen['goodput']}")
    rep = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "slo_report.py"),
         os.path.join(tmp, "serve", "slo")], capture_output=True,
        text=True, timeout=120)
    check(rep.returncode == 0 and "1 rank(s)" in rep.stdout,
          f"slo_report: {rep.stdout[-2000:]} {rep.stderr[-2000:]}")
    gp = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "goodput_report.py"),
         os.path.join(tmp, "serve", "goodput"), "--json"],
        capture_output=True, text=True, timeout=120)
    check(gp.returncode == 0, f"goodput_report: {gp.stderr[-2000:]}")
    kernels = ops_profile_paged(model, tmp)
    return {"tokens_bit_equal": True, "launches": c1,
            "tokens_per_s_off": [n_tok / sec0, n_tok / sec2],
            "tokens_per_s_on": n_tok / sec1, "rounds": s1["steps"],
            "journal_records": len(access), "ttft_gap_ms": gap,
            "ttft_p50_ms_journal": sorted(
                r["ttft_ms"] for r in access.values())[n_req // 2],
            "goodput_s": seen["goodput"], "scope": {
                k: seen[k] for k in ("statusz_servers", "metrics_samples",
                                     "scope_top_lines")},
            "slo_report_lines": len(rep.stdout.splitlines()),
            "profile_kernels": kernels}


def ops_bert_run(dev, steps, armed, tmp, batch=32, seq_len=512, masked=76,
                 **cfg_overrides):
    """Phase 6's BERT-base trainer (seed 0, bf16, LAMB, 32 x 512) for
    `steps` steps; armed: goodput, check and guard with
    `sdc_check_every=2`. Returns (losses, launches, ms per step of steps
    2..n, the layer's view, the trainer)."""
    from mxnet_tpu_torch import check as mxcheck
    from mxnet_tpu_torch import goodput, guard, parallel
    from mxnet_tpu_torch.models import bert
    import torch
    cfg = bert.bert_base_config(dtype="bfloat16", **cfg_overrides)
    model = build_bert(cfg, 0, dev)
    trainer = parallel.ShardedTrainer(
        model, bert.bert_pretrain_loss, "lamb",
        {"learning_rate": 1e-3, "wd": 0.01}, device=dev)
    b = bert.make_synthetic_batch(cfg, batch, seq_len, masked, seed=0)
    data = [torch.from_numpy(b[k]).to(dev) for k in _DATA]
    labels = [torch.from_numpy(b[k]).to(dev) for k in _LABELS]
    if armed:
        ops_arm(tmp, guard_kw={"sdc_check_every": 2})
    seen = None
    try:
        reset_counts()
        losses = [trainer.step(data, labels)]
        sync(model)
        t0 = time.perf_counter()
        losses += [trainer.step(data, labels) for _ in range(steps - 1)]
        sync(model)
        ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
        counts = read_counts()
        if armed:
            goodput.flush()
            snap = guard.snapshot()
            seen = {"findings": [(f["rule"], f["location"], f["message"])
                                 for f in mxcheck.findings()],
                    "goodput": goodput.snapshot(),
                    "last_sdc": snap["last_sdc"],
                    "heartbeat": snap["heartbeat"]}
    finally:
        if armed:
            ops_disarm()
    return [float(x) for x in losses], counts, ms, seen, trainer


def ops_train_phase(dev, tmp, steps=8, **train_kw):
    """Phase 50: BERT-base off and on (goodput, check, guard with an SDC
    vote every 2 steps): losses bit equal, launches equal; one digest's
    cost; tools/goodput_report.py over the run's files; the hang child,
    started first (on the CPU; it spends its time importing and then
    waiting on its deadline, beside the runs on the card): exit 86 and
    its post-mortem."""
    import torch
    from mxnet_tpu_torch import guard
    child_dir = os.path.join(tmp, "hang")
    t_child = time.perf_counter()
    child = start_hang_child(child_dir)
    try:
        out = ops_train_runs(dev, tmp, steps, **train_kw)
        out["hang_child"] = hang_child_result(child, child_dir)
        out["hang_child"]["seconds"] = time.perf_counter() - t_child
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return out


def ops_train_runs(dev, tmp, steps, **train_kw):
    """Phase 50's two BERT-base runs, the digest's cost and the goodput
    report."""
    import torch
    from mxnet_tpu_torch import guard
    l0, c0, ms0, _, tr = ops_bert_run(dev, steps, False, None, **train_kw)
    del tr
    l1, c1, ms1, seen, tr = ops_bert_run(dev, steps, True,
                                         os.path.join(tmp, "train"),
                                         **train_kw)
    check(l1 == l0, f"BERT-base losses with the layer on {l1} != off {l0}")
    check(c0 == c1, f"launch counts off {c0}, on {c1}")
    check(dev.type != "cuda" or (
        c1["flash_attention_fwd"] == c1["flash_attention_dq"]
        == c1["flash_attention_dkv"] == 12 * steps
        and c1["lamb_pass1"] == c1["lamb_pass2"] == steps),
        f"BERT-base launches {c1}")
    check(seen["last_sdc"] and seen["last_sdc"]["ok"]
          and seen["last_sdc"]["step"] == steps,
          f"last SDC vote {seen['last_sdc']}")
    cats = seen["goodput"]["categories"]
    check(set(cats) == {"compile", "step"}
          and seen["goodput"]["intervals"]["step"] == steps - 1
          and seen["goodput"]["hw_step"] == steps,
          f"goodput {seen['goodput']}")
    sync(tr.block)
    t0 = time.perf_counter()
    guard.param_digests(tr)
    digest_ms = (time.perf_counter() - t0) * 1e3
    n_bytes = tr.params.numel() * tr.params.element_size()
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gp = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "goodput_report.py"),
         os.path.join(tmp, "train", "goodput"), "--json"],
        capture_output=True, text=True, timeout=120)
    check(gp.returncode == 0, f"goodput_report: {gp.stderr[-2000:]}")
    report = json.loads(gp.stdout)
    return {"losses_bit_equal": True, "launches": c1,
            "ms_per_step_off": ms0, "ms_per_step_on": ms1,
            "sdc_digest_ms": digest_ms,
            "sdc_digest_bytes": n_bytes,
            "check_findings": seen["findings"],
            "goodput_categories": cats,
            "goodput_fraction": seen["goodput"]["goodput_fraction"],
            "goodput_report_keys": sorted(report)[:8]}


# ---------------------------------------------------------------------------
# phases 51-53: BERT's fine-tuning heads, control flow, Parameter's
# accessors
# ---------------------------------------------------------------------------

# GluonNLP's finetune_squad.py: AdamW, lr 3e-5, weight decay 0.01
SQUAD_OPT = {"learning_rate": 3e-5, "wd": 0.01}
# its finetune_classifier.py on MRPC: AdamW, lr 2e-5, weight decay 0.01,
# the learning rate warmed up linearly from 0 over warmup_ratio 0.1 of
# the run's int(3,668 / 32 x 3) = 343 steps: 34 steps, of which phase 52
# takes the first (without the warm-up, at lr 5e-5, Adam's first step
# overshoots from random weights: the loss rises, in the JAX package as
# in the port, tests/test_torch_bert_finetune.py)
GLUE_OPT = {"learning_rate": 2e-5, "wd": 0.01}
GLUE_WARMUP = 34


def glue_lrs(steps):
    """The learning rates of finetune_classifier.py's first `steps`
    steps: lr x step / warm-up steps, from step 0."""
    return [GLUE_OPT["learning_rate"] * i / GLUE_WARMUP
            for i in range(steps)]


def squad_batch(cfg, B, L, seed=0):
    """A synthetic SQuAD batch (numpy): valid lengths drawn in [L/2, L]
    ([192, 384] at BERT's L = 384: every row has padding but the
    longest), token type 0 over [CLS] and a question prefix (8-63
    tokens at L = 384) and 1 after it up to the valid length, padding
    id 0, and a
    gold span start <= end inside the context. Returns ([ids, types,
    valid], [start, end])."""
    import numpy as np
    rs = np.random.RandomState(seed)
    valid = rs.randint(L // 2, L + 1, B)
    q = rs.randint(min(8, L // 8), min(64, L // 4), B)
    pos = np.arange(L)[None]
    ids = rs.randint(1, cfg["vocab_size"], (B, L))
    ids[pos >= valid[:, None]] = 0
    types = (pos > q[:, None]) & (pos < valid[:, None])
    start = np.asarray([rs.randint(a + 1, v) for a, v in zip(q, valid)])
    end = np.minimum(start + rs.randint(0, 30, B), valid - 1)
    return ([ids.astype(np.int32), types.astype(np.int32),
             valid.astype(np.int32)],
            [start.astype(np.int32), end.astype(np.int32)])


def nd_arrays(arrays, device):
    """The numpy arrays as NDArrays on `device` (the card unless it is
    the CPU)."""
    from mxnet_tpu_torch import nd
    ctx = "cpu" if str(device) == "cpu" else None
    return [nd.array(a, ctx=ctx) for a in arrays]


class FinetuneLoop:
    """The eager step of GluonNLP's fine-tuning scripts on the port:
    `autograd.record()`, the head on NDArrays, its loss (`bert_qa_loss`
    for the QA head, softmax cross-entropy for the classifier),
    `backward()`, `gluon.Trainer(..., "adamw").step(1)`; `step(data,
    labels)` as `timed_steps` calls a trainer."""

    def __init__(self, model, optimizer_params):
        from mxnet_tpu_torch import gluon
        self.model = model
        self.trainer = gluon.Trainer(model.collect_params(), "adamw",
                                     dict(optimizer_params))

    def loss(self, out, labels):
        from mxnet_tpu_torch import gluon
        from mxnet_tpu_torch.models import bert
        if isinstance(out, tuple):
            return bert.bert_qa_loss(*out, *labels)
        return gluon.loss.SoftmaxCrossEntropyLoss()(out, labels[0]).mean()

    def forward(self, data, labels):
        from mxnet_tpu_torch import autograd
        with autograd.record():
            out = self.model(*data)
            loss = self.loss(out, labels)
        return out, loss

    def step(self, data, labels):
        _, loss = self.forward(data, labels)
        loss.backward()
        self.trainer.step(1)
        return loss.detach()

    def eval_loss(self, data, labels):
        """The loss on the batch without dropout and without recording."""
        from mxnet_tpu_torch import autograd
        with autograd.pause():
            return float(self.loss(self.model(*data), labels).asscalar())


def finetune_model(make, cfg, seed, device):
    from mxnet_tpu_torch import random as mxrandom
    model = make(cfg, device=device)
    model.initialize(generator=mxrandom.seed(seed, device))
    return model


def qa_head(cfg, device):
    from mxnet_tpu_torch.models import bert
    return bert.BERTForQuestionAnswering(cfg, device=device)


def classifier_head(cfg, device):
    from mxnet_tpu_torch.models import bert
    return bert.BERTClassifier(cfg, num_classes=2, device=device)


def squad_phase(dev, batch=32, seq_len=384, warmup=2, steps=10,
                **cfg_overrides):
    """Phase 51: BERT-base SQuAD fine-tuning (GluonNLP's
    `finetune_squad.py` step) at full width, float32 as the config gives
    it, B = 32, L = 384, padding in every row but the longest. The first
    warm-up step holds `model.span.weight.grad()` equal to torch's
    gradient of that parameter (`torch.autograd.grad` of the same
    recorded loss); then `warmup` - 1 more, `steps` timed one by one
    (synchronized: median and spread), and one profiled
    (`profile_once`: device time by kernel, idle share). The loss on the
    fixed batch must fall over the warm-up and timed steps; launches a
    step: 12 flash forwards, dq and dkv and the Adam launches of
    `adam_launches`. `cfg_overrides` cut it for a rehearsal on the
    CPU."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert
    cfg = bert.bert_base_config(**cfg_overrides)
    model = finetune_model(qa_head, cfg, 0, dev)
    loop = FinetuneLoop(model, SQUAD_OPT)
    arrays, labels = squad_batch(cfg, batch, seq_len)
    data, labels = nd_arrays(arrays, dev), nd_arrays(labels, dev)
    eval_before = loop.eval_loss(data, labels)
    _, loss = loop.forward(data, labels)
    ref = torch.autograd.grad(loss._t, model.span.weight,
                              retain_graph=True)[0]
    loss.backward()
    g = model.span.weight.grad()
    e_grad = max_err(g._t, ref)
    check(e_grad <= 1e-6, f"span.weight.grad() against torch's gradient: "
          f"{e_grad}")
    check(g.context.device_type == ("cpu" if str(dev) == "cpu" else "gpu"),
          f"span gradient on {g.context}")
    loop.trainer.step(1)
    losses = [float(loss.asscalar())]
    losses += [float(loop.step(data, labels)) for _ in range(warmup - 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(loop.step(data, labels)))   # the fetch syncs
        times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    prof, prof_ms, windows = profile_once(
        lambda: float(loop.step(data, labels)))
    busy_ms, top, by_class, kernels = device_profile(prof, 1, 10)
    med = float(np.median(times))
    eval_after = loop.eval_loss(data, labels)
    check(np.isfinite(losses).all(), f"SQuAD losses {losses}")
    check(eval_after < eval_before and losses[-1] < losses[0],
          f"SQuAD loss did not fall: {losses}, without dropout "
          f"{eval_before} -> {eval_after}")
    L = cfg["num_layers"]
    params = loop.trainer._params
    want = expect(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps,
                  adam_update=adam_launches(params) * steps)
    check(counts == want, f"SQuAD fine-tuning launches {counts} != {want}")
    valid = arrays[2]
    res = {"model": "BERTForQuestionAnswering(bert_base_config(), float32, "
                    "dropout 0.1), gluon.Trainer adamw lr 3e-5 wd 0.01",
           "batch": batch, "seq_len": seq_len, "warmup": warmup,
           "steps": steps, "valid_length_min_max_mean": [int(valid.min()), int(valid.max()),
                                         float(valid.mean())],
           "losses": losses, "span_grad_max_abs_err_vs_torch": e_grad,
           "loss_without_dropout_before_after": [eval_before, eval_after],
           "ms_per_step_median": med,
           "ms_per_step_min_max": [min(times), max(times)],
           "ms_per_step_iqr": [float(np.percentile(times, 25)),
                               float(np.percentile(times, 75))],
           "examples_per_s": batch * 1e3 / med,
           "max_memory_allocated_bytes": peak,
           "profiled_step_ms": prof_ms, "profile_windows": windows,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": None if busy_ms is None
           else 1 - busy_ms / med,
           "device_ms_per_step_by_class": by_class,
           "kernels_per_step": kernels, "top_device_ms_per_step": top,
           "launches_per_step": {k: v / steps for k, v in counts.items()
                                 if v},
           "param_count": sum(p.numel() for p in params),
           "tensors": len(params)}
    del loop, model
    torch.cuda.empty_cache()
    return res, counts


def finetune_run(make, cfg, arrays, labels, where, steps, opt, seed=7,
                 lrs=None):
    """`steps` eager fine-tuning steps of a head built on the CPU from
    `seed` and moved to `where`, step i at learning rate `lrs[i]` where
    given: (the first forward's outputs, the losses followed by the loss
    without dropout before and after the steps, {name: gradient after
    step 1 through `p.grad()`}, the launch counts of the steps), host
    copies."""
    model = finetune_model(make, cfg, seed, "cpu")
    model.to(where)
    loop = FinetuneLoop(model, opt)
    data, labels = nd_arrays(arrays, where), nd_arrays(labels, where)
    evals = [loop.eval_loss(data, labels)]
    lrs = lrs or [opt["learning_rate"]] * steps
    reset_counts()
    out, loss = loop.forward(data, labels)
    out = [o.asnumpy() for o in (out if isinstance(out, tuple) else (out,))]
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in model.collect_params().items()
             if k.startswith(("span.", "classifier."))}
    loop.trainer.set_learning_rate(lrs[0])
    loop.trainer.step(1)
    losses = [float(loss.asscalar())]
    for lr in lrs[1:]:
        loop.trainer.set_learning_rate(lr)
        losses.append(float(loop.step(data, labels)))
    counts = read_counts()
    evals.append(loop.eval_loss(data, labels))
    del loop, model
    return out, losses + evals, grads, counts


def finetune_parity(make, cfg, arrays, labels, dev, steps, opt, what,
                    lrs=None):
    """`finetune_run` of the head on the CPU and on `dev` from the same
    weights: the first forward's outputs, the losses and the head's
    gradients within 1e-5 (the tolerance of phase 44's parity). Returns
    (the runs, {max errors})."""
    import numpy as np
    import torch
    runs = [finetune_run(make, cfg, arrays, labels, w, steps, opt, lrs=lrs)
            for w in ("cpu", dev)]
    (oc, lc, gc, cc), (og, lg, gg, _) = runs
    errs = {"max_logit_err": max(max_err(torch.tensor(a), torch.tensor(b))
                                 for a, b in zip(og, oc)),
            "max_loss_err": float(np.abs(np.subtract(lg, lc)).max()),
            "max_grad_err": max(max_err(torch.tensor(gg[k]),
                                        torch.tensor(gc[k])) for k in gc)}
    check(max(errs.values()) <= 1e-5,
          f"{what} card vs CPU: {errs}, losses {lg} vs {lc}")
    check(not any(cc.values()), f"{what}: the CPU run launched {cc}")
    return runs, errs


def finetune_parity_phase(dev, batch=4, seq_len=384, steps=2,
                          cls_batch=32, cls_len=128, cls_steps=3,
                          **cfg_overrides):
    """Phase 52: the fine-tuning heads card against CPU. The QA head at
    BERT-base's widths with 2 layers (as phase 44's parity; dropout 0),
    B = 4, L = 384, `steps` steps from the same weights: start and end
    logits (the masked positions -1e9 on both), the losses and the span
    gradient after step 1 within 1e-5. `BERTClassifier(bert_base_config(),
    num_classes=2)` at B = 32, L = 128 trains `cls_steps` steps on the
    card under `finetune_classifier.py`'s warm-up (`glue_lrs`) to finite
    losses, and its loss on the batch without dropout falls; the same
    steps at lr 5e-5 without the warm-up are recorded beside them; its
    2-layer twin holds card against CPU at B = 4 the same way."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.models import bert
    small = bert.bert_base_config(**{**cfg_overrides, "num_layers": 2,
                                     "dropout": 0.0})
    arrays, labels = squad_batch(small, batch, seq_len, seed=2)
    runs, errs = finetune_parity(qa_head, small, arrays, labels, dev, steps,
                                 SQUAD_OPT, "QA fine-tuning")
    dead = np.arange(seq_len)[None] >= arrays[2][:, None]
    for o in runs[0][0] + runs[1][0]:
        check((o[dead] == -1e9).all() and (o[~dead] > -1e8).all(),
              "QA logits past valid_length are not -1e9")
    L, counts = small["num_layers"], runs[1][3]
    want = expect(flash_attention_fwd=L * steps, flash_attention_dq=L * steps,
                  flash_attention_dkv=L * steps, adam_update=steps)
    check(counts == want, f"QA parity launches {counts} != {want}")
    out = {"qa": {"batch": batch, "seq_len": seq_len, "steps": steps,
                  "layers": L, **errs, "losses_card": runs[1][1],
                  "losses_cpu": runs[0][1], "launches": counts}}
    # the classifier at full width on the card
    full = bert.bert_base_config(**cfg_overrides)
    c_arrays, _ = squad_batch(full, cls_batch, cls_len, seed=4)
    c_labels = [np.random.RandomState(5).randint(0, 2, cls_batch)
                .astype(np.int32)]
    lrs = glue_lrs(cls_steps)
    _, closs, _, ccounts = finetune_run(classifier_head, full, c_arrays,
                                        c_labels, dev, cls_steps, GLUE_OPT,
                                        lrs=lrs)
    check(np.isfinite(closs).all() and closs[-1] < closs[-2],
          f"BERT-base classifier losses (the last two without dropout, "
          f"before and after) {closs}")
    # the same steps at lr 5e-5 without the warm-up: recorded, not held
    _, rough, _, _ = finetune_run(classifier_head, full, c_arrays, c_labels,
                                  dev, cls_steps, {**GLUE_OPT,
                                                   "learning_rate": 5e-5})
    check(np.isfinite(rough).all(), f"classifier at lr 5e-5: {rough}")
    out["classifier"] = {"batch": cls_batch, "seq_len": cls_len,
                         "lrs": lrs, "losses": closs, "launches": ccounts,
                         "losses_lr_5e-5_no_warmup": rough}
    c_arrays, _ = squad_batch(small, batch, cls_len, seed=6)
    _, errs = finetune_parity(
        lambda cfg, device: bert.BERTClassifier(cfg, num_classes=2,
                                                dropout=0.0, device=device),
        small, c_arrays, [c_labels[0][:batch]], dev, steps, GLUE_OPT,
        "classifier", lrs=glue_lrs(steps))
    out["classifier_parity"] = {"batch": batch, "seq_len": cls_len, **errs}
    torch.cuda.empty_cache()
    return out


def control_flow_cases(where):
    """nd.contrib's foreach (a body that captures a parameter), while_loop
    (one that stops early and one that never runs) and cond (both
    branches), each with gradients, on `where`: {name: [host arrays]}."""
    import numpy as np
    from mxnet_tpu_torch import autograd, gluon, nd
    ctx = "cpu" if str(where) == "cpu" else None
    rs = np.random.RandomState(0)
    xs, wv = rs.randn(6, 2, 8).astype(np.float32), rs.randn(8, 8) * 0.3
    out = {}
    p = gluon.Parameter("w", shape=(8, 8))
    p.initialize(ctx=ctx or nd.zeros((1,)).context)
    p.set_data(wv.astype(np.float32))
    x = nd.array(xs, ctx=ctx)
    x.attach_grad()

    def body(xt, s):
        h = nd.tanh(nd.dot(xt + s, p.data()))
        return h, h

    with autograd.record():
        outs, fin = nd.contrib.foreach(body, x, nd.zeros((2, 8), ctx=ctx))
        loss = outs.sum() + (fin * fin).sum()
    loss.backward()
    out["foreach"] = [outs.asnumpy(), fin.asnumpy(), x.grad.asnumpy(),
                      p.grad().asnumpy()]
    v = nd.array(np.asarray([1.5, 0.5], np.float32), ctx=ctx)
    v.attach_grad()
    with autograd.record():
        steps, (vf, acc) = nd.contrib.while_loop(
            lambda a, b: b.sum() < 20, lambda a, b: (a * b, [a * 1.5, b + a]),
            [v, nd.ones((2,), ctx=ctx)], max_iterations=12)
        loss = steps.sum() + vf.sum() + acc.sum()
    loss.backward()
    never, _ = nd.contrib.while_loop(lambda a: a.sum() > 100,
                                     lambda a: (nd.dot(a, a), [a + 1]),
                                     [nd.ones((3,), ctx=ctx)],
                                     max_iterations=5)
    out["while_loop"] = [steps.asnumpy(), vf.asnumpy(), acc.asnumpy(),
                         v.grad.asnumpy(), never.asnumpy()]
    a = nd.array(np.asarray([3.0, -1.0], np.float32), ctx=ctx)
    a.attach_grad()
    rows = []
    for flip in (1.0, -1.0):
        with autograd.record():
            y = nd.contrib.cond((a.sum() * flip) > 0, lambda t: t * t,
                                lambda t: -t * 3, inputs=[a])
        y.backward()
        rows += [y.asnumpy(), a.grad.asnumpy()]
    out["cond"] = rows
    return out


def sym_control_flow_module(where, epochs=2):
    """A `sym.contrib.foreach` recurrence over batch-major data trained by
    `Module.fit` (SGD) bound on `where`, plus `while_loop` and `cond`
    graphs bound by `simple_bind` (forward and backward): {name: [host
    arrays]}."""
    import numpy as np
    from mxnet_tpu_torch import context, io, module, nd, sym
    ctx = context.cpu() if str(where) == "cpu" else context.gpu(0)
    rs = np.random.RandomState(1)
    T, H = 5, 8
    x = rs.randn(32, T, H).astype(np.float32)
    y = rs.randint(0, 2, 32).astype(np.float32)
    w0 = (rs.randn(H, H) * 0.3).astype(np.float32)
    data = sym.transpose(sym.var("data"), axes=(1, 0, 2))
    w = sym.var("rnn_w", shape=(H, H))
    _, fin = sym.contrib.foreach(
        lambda xt, s: (sym.tanh(sym.dot(xt, w) + s),) * 2, data,
        sym.var("s0"), name="scan")
    net = sym.SoftmaxOutput(sym.FullyConnected(fin, num_hidden=2, name="fc"),
                            name="softmax", normalization="batch")
    it = io.NDArrayIter({"data": x, "s0": np.zeros((32, H), np.float32)},
                        {"softmax_label": y}, batch_size=16)
    mod = module.Module(net, data_names=("data", "s0"),
                        label_names=("softmax_label",), context=ctx)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            arg_params={"rnn_w": nd.array(w0, ctx="cpu"),
                        "fc_weight": nd.array(rs.randn(2, H).astype(
                            np.float32), ctx="cpu"),
                        "fc_bias": nd.zeros((2,), ctx="cpu")})
    arg, _ = mod.get_params()
    out = {"sym_foreach_module_fit": [arg[k].asnumpy() for k in sorted(arg)]}
    i0, acc0 = sym.var("i0"), sym.var("acc0")
    outs, fins = sym.contrib.while_loop(
        lambda i, acc: sym.sum(acc) < 6.0,
        lambda i, acc: ([sym.dot(i, w)], [i + 1.0, acc + i]),
        [i0, acc0], max_iterations=6, name="wl")
    p, xv = sym.var("p"), sym.var("x")
    cd = sym.contrib.cond(sym.sum(p) > 0.0, lambda v: sym.dot(v, w),
                          lambda v: v - 1.0, xv, name="cd")
    vals = {"i0": np.full((H,), 0.25, np.float32),
            "acc0": np.zeros((H,), np.float32), "rnn_w": w0,
            "x": x[:2, 0], "p": np.ones((1,), np.float32)}
    for name, graph in (("sym_while_loop", sym.Group([outs[0], fins[1]])),
                        ("sym_cond", cd)):
        args = graph.list_arguments()
        ex = graph.simple_bind(ctx=ctx, grad_req="write",
                               **{k: vals[k].shape for k in args})
        for k in args:
            ex.arg_dict[k][:] = vals[k]
        res = ex.forward(is_train=True)
        ex.backward()
        out[name] = [r.asnumpy() for r in res] + [
            ex.grad_dict[k].asnumpy() for k in sorted(args)]
    return out


def control_flow_phase(dev):
    """Phase 53: control flow and Parameter's accessors on the card.
    nd.contrib's foreach, while_loop and cond with gradients, and
    sym.contrib's through `Module.fit` and `simple_bind` bound on the
    card, each against the same run on the CPU (1e-5); none launches a
    kernel of the repo. `p.data()` of a parameter initialized on the
    card reports a GPU context; `set_data` takes numpy, a CPU NDArray and
    a card NDArray; `p.grad()` reads the card's gradient."""
    import numpy as np
    from mxnet_tpu_torch import autograd, context, gluon, nd
    res = {}
    with context.cpu():
        want = control_flow_cases("cpu")
    reset_counts()
    got = control_flow_cases(dev)
    want.update(sym_control_flow_module("cpu"))
    got.update(sym_control_flow_module(dev))
    counts = read_counts()
    check(not any(counts.values()), f"control flow launched {counts}")
    for name in want:
        err = max(float(np.abs(g - w).max()) if g.size else 0.0
                  for g, w in zip(got[name], want[name]))
        check(err <= 1e-5, f"{name} card vs CPU: {err}")
        res[name] = {"max_abs_err": err,
                     "shapes": [list(g.shape) for g in got[name]]}
    p = gluon.Parameter("w", shape=(4, 3))
    p.initialize(init="zeros", ctx=context.gpu(0))
    ctx = p.data().context
    check(ctx.device_type == "gpu", f"p.data() on {ctx}")
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    seen = []
    for value in (src, nd.array(src + 1, ctx="cpu"), nd.array(src + 2)):
        p.set_data(value)
        seen.append(p.data().asnumpy())
    check(all((s == src + i).all() for i, s in enumerate(seen)),
          "set_data from numpy, a CPU NDArray and a card NDArray")
    x = nd.array(np.ones((2, 4), np.float32))
    with autograd.record():
        nd.dot(x, p.data()).sum().backward()
    g = p.grad()
    check(g.context.device_type == "gpu" and (g.asnumpy() == 2).all(),
          f"p.grad() {g.context} {g.asnumpy()}")
    res["accessors"] = {"data_context": str(ctx),
                        "grad_context": str(g.context),
                        "set_data_sources": ["numpy", "cpu NDArray",
                                             "card NDArray"]}
    return res


# phase 46's processes: three files a process (each process's imports
# and CUDA context cost more than most of these files' tests), the first
# harness's files apart from the second's (those run with -m 'not slow')
BASE_GROUPS = (("test_optimizer.py", "test_ndarray.py",
                "test_autograd_modes.py"),
               ("test_misc_ops.py", "test_gluon_data.py",
                "test_sparse_ndarray.py"),
               ("test_symbol.py", "test_monitor.py", "test_gluon.py"),
               ("test_autograd.py", "test_module.py", "test_model_zoo.py"))
UNIT_GROUPS = (("test_telemetry.py", "test_trace.py", "test_profiler.py"),
               ("test_diagnostics.py", "test_inspect.py", "test_ctc.py"),
               ("test_memsafe.py", "test_resilience.py", "test_params_io.py"),
               ("test_gluon_rnn.py", "test_detection_ops.py",
                "test_contrib_text.py"))
# the third harness's files (control flow, BERT's fine-tuning heads, the
# report tools), also with -m 'not slow'
FLOW_GROUPS = (("test_control_flow.py", "test_symbol_control_flow.py"),
               ("test_bert_finetune.py", "test_report_tools.py"))


def jax_unittests_phase(width=8, timeout=300, device=None):
    """Phase 46: the JAX package's unit-test files of
    `tests/test_torch_jax_unittests.py`,
    `tests/test_torch_jax_unittests_more.py` and
    `tests/test_torch_jax_unittests_flow.py` (the latter two's with "-m
    'not slow'" and their deselections, as on the CPU), two or three a
    process (`BASE_GROUPS`, `UNIT_GROUPS`, `FLOW_GROUPS`), through `run_example --pytest` on
    the card (no --device; `device="cpu"` rehearses it on the CPU),
    `width` processes at a time. Each file must fail exactly its CPU
    exclusions, and the second harness's on the card also its
    `ON_CARD` ones."""
    import concurrent.futures
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_jax_unittests import FILES as BASE
    from test_torch_jax_unittests_more import FILES as MORE, ON_CARD
    from test_torch_jax_unittests_flow import FILES as FLOW
    # a test's own use of JAX (`jnp` helpers) stays on the CPU: a JAX that
    # finds the card preallocates most of its memory and starves the
    # other processes (CUBLAS_STATUS_ALLOC_FAILED in theirs)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    on_card = device is None
    FILES = {name: (total, list(excluded)) for name, (total, excluded)
             in BASE.items()}
    jobs = [(group, []) for group in BASE_GROUPS]
    SLOW = {**MORE, **FLOW}
    for name, (total, excluded, _) in SLOW.items():
        FILES[name] = (total, list(excluded)
                       + list(ON_CARD.get(name, ()) if on_card else ()))
    for groups, files in ((BASE_GROUPS, BASE), (UNIT_GROUPS, MORE),
                          (FLOW_GROUPS, FLOW)):
        check(sorted(n for g in groups for n in g) == sorted(files),
              f"phase 46's groups {groups} against {sorted(files)}")
    for group in UNIT_GROUPS + FLOW_GROUPS:
        jobs.append((group, ["-m", "not slow"] + [
            a for name in group for t in SLOW[name][2]
            for a in ("--deselect", f"tests/unittest/{name}::{t}")]))

    def run(job):
        names, extra = job
        t0 = time.perf_counter()
        paths = [f"tests/unittest/{n}" for n in names]
        out = subprocess.run(
            [sys.executable, "-m", "mxnet_tpu_torch.run_example",
             *([] if on_card else ["--device", device]), "--pytest",
             *paths, "-p", "no:xdist", *extra], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=timeout)
        lines = out.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, ValueError):
            check(False, f"{names}: no result line: {out.stdout[-2000:]} "
                  f"{out.stderr[-2000:]}")
        secs = time.perf_counter() - t0
        return {n: {"passed": sum(1 for t in res["passed_ids"]
                                  if t.startswith(p + "::")),
                    "failures": [f for f in res["failures"]
                                 if f.startswith(p)],
                    "seconds": secs, "launches": res["launches"]}
                for n, p in zip(names, paths)}

    results = {}
    with concurrent.futures.ThreadPoolExecutor(width) as pool:
        for part in pool.map(run, jobs):
            results.update(part)
    rows, wrong = {}, {}
    for name, res in results.items():
        total, excluded = FILES[name]
        failed = sorted(f.split("::")[-1] for f in res["failures"])
        rows[name] = {"passed": res["passed"], "failed": failed,
                      "seconds": res["seconds"],
                      "launches": {k: v for k, v in res["launches"].items()
                                   if v}}
        if failed != sorted(excluded) or \
                res["passed"] != total - len(excluded):
            wrong[name] = (res["passed"], total, res["failures"])
    check(not wrong, f"JAX unit-test files on the card: {wrong}")
    return rows


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if len(sys.argv) in (4, 5) and sys.argv[1] == "--ckpt-child" \
            and os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        # one process of phase 34 (its device named by the phase)
        sys.path.insert(0, ROOT)
        ckpt_child(sys.argv[2], sys.argv[3],
                   json.loads(sys.argv[4]) if len(sys.argv) == 5 else None)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--hang-child" \
            and os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        # phase 50's child process (on the CPU)
        sys.path.insert(0, ROOT)
        hang_child(sys.argv[2])
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the port "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mxnet_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mxnet_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] in ("--flash-times",
                                              "--host-times",
                                              "--adam-times",
                                              "--lamb-times",
                                              "--accessor-times"):
        times = {"--flash-times": flash_times, "--host-times":
                 host_path_times, "--adam-times": adam_times,
                 "--lamb-times": lamb_times,
                 "--accessor-times": accessor_times}[sys.argv[1]]
        print(json.dumps(times(sys.argv[2])))
        return 0
    if sys.argv[1:] == ["--nms-phases"]:
        sys.path.insert(0, ROOT)
        nms_phase_cycles(torch.device("cuda"))
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi or "nvidia-smi: no output")
        return 0
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--bert-repeat":
        sys.path.insert(0, ROOT)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if sys.argv[3:] == ["deterministic"]:
            # before the first cuBLAS call reads it
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            torch.use_deterministic_algorithms(True)
        print("chip_smoke: fault 8 " + json.dumps(
            bert_repeat(int(sys.argv[2]))))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] in ("--flash-ab", "--host-ab",
                                              "--adam-ab", "--lamb-ab",
                                              "--accessor-ab"):
        {"--flash-ab": flash_ab, "--host-ab": host_ab,
         "--adam-ab": adam_ab, "--lamb-ab": lamb_ab,
         "--accessor-ab": accessor_ab}[sys.argv[1]](sys.argv[2])
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi or "nvidia-smi: no output")
        return 0
    t_start = time.perf_counter()

    def lap(phase):
        """When each phase starts: the script's time budget, phase by
        phase."""
        print(f"chip_smoke: phase {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    sys.path.insert(0, ROOT)
    import numpy as np
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("chip_smoke: TF32 off for float32 matmuls and convolutions")
    from mxnet_tpu_torch.cuda_ops import _build
    from mxnet_tpu_torch.models import gpt
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"chip_smoke: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as fh:
        for line in fh:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    # the instruction mix of the bf16 flash forward, dq and dkv (two
    # instantiations each, D <= 64 and D <= 128): wgmma fed by TMA
    mix = sass_mix(os.path.join(_build.BUILD_DIR, _build.LIB_NAME))
    print("chip_smoke: SASS of the wgmma kernels (HGMMA = wgmma, UTMALDG/"
          "UTMASTG = TMA, HMMA = mma.sync) " + json.dumps(mix))
    if mix is not None:
        check(len(mix) == 6 and all(
            m["HGMMA"] > 0 and m["UTMALDG"] > 0 and m["HMMA"] == 0
            for m in mix.values()), f"wgmma kernels' SASS {mix}")
    # the float32 forward, dq and dkv (two instantiations each): split TF32
    # on the tensor cores, mma.sync in TF32 (HMMA.1688.F32.TF32) or wgmma
    mix32 = sass_mix(os.path.join(_build.BUILD_DIR, _build.LIB_NAME),
                     kernels=("flash_fwd_split_tf32_kernel",
                              "dq_split_tf32_kernel",
                              "dkv_split_tf32_kernel"),
                     ops=("HMMA", "HMMA.TF32", "HGMMA"))
    print("chip_smoke: SASS of the float32 forward, dq and dkv (HMMA.TF32 "
          "= TF32 mma.sync, HGMMA = wgmma) " + json.dumps(mix32))
    if mix32 is not None:
        check(len(mix32) == 6 and all(
            m["HMMA.TF32"] > 0 or m["HGMMA"] > 0 for m in mix32.values()),
            f"float32 flash kernels' SASS: no tensor-core MMA {mix32}")
    # the int8 GEMM's M > 16 route (two instantiations): int8 wgmma (IGMMA)
    # fed by TMA, no mma.sync (IMMA); paged attention (four): bulk copies
    mix8 = sass_mix(os.path.join(_build.BUILD_DIR, _build.LIB_NAME),
                    kernels=("int8_wgmma_kernel", "paged_attention_kernel"),
                    ops=("IGMMA", "UTMALDG", "IMMA", "UBLKCP"))
    print("chip_smoke: SASS of the int8 wgmma and paged kernels (IGMMA = "
          "int8 wgmma, IMMA = int8 mma.sync, UBLKCP = bulk copy) "
          + json.dumps(mix8))
    if mix8 is not None:
        wg = {k: m for k, m in mix8.items() if "int8_wgmma" in k}
        pg = {k: m for k, m in mix8.items() if "paged_attention" in k}
        check(len(wg) == 2 and all(m["IGMMA"] > 0 and m["UTMALDG"] > 0
                                   and m["IMMA"] == 0 for m in wg.values())
              and len(pg) == 4 and all(m["UBLKCP"] > 0 for m in pg.values()),
              f"int8 wgmma / paged kernels' SASS {mix8}")

    lap("1")
    # 1. kernels against their plain versions
    kernels = {"paged_attention": paged_phase(dev),
               "flash_attention_fwd": flash_phase(dev)}
    kernels.update(train_flash_phase(dev))
    for row, extra in gpt_flash_phase(dev).items():
        kernels[row].update(extra)
        print(f"chip_smoke: {row} at GPT-2 training's shape "
              + json.dumps(extra["gpt2_train_shape"]))
    for row, extra in bert_large_flash_phase(dev).items():
        kernels[row].update(extra)
        print(f"chip_smoke: {row} at BERT-large's shape "
              + json.dumps(extra["bert_large_shape"]))
    for row, want in (("flash_attention_fwd", "flash_fwd_wgmma"),
                      ("flash_attention_fwd_dropout", "flash_fwd_wgmma"),
                      ("flash_attention_dq", "dq_wgmma"),
                      ("flash_attention_dkv", "dkv_wgmma")):
        kernels[row]["sass"] = None if mix is None else {
            name: m for name, m in mix.items() if want in name}
    for row, want in (("flash_attention_fwd_dropout", "flash_fwd_split_tf32"),
                      ("flash_attention_dq", "dq_split_tf32"),
                      ("flash_attention_dkv", "dkv_split_tf32")):
        kernels[row]["sass_f32"] = None if mix32 is None else {
            name: m for name, m in mix32.items() if want in name}
    kernels.update(lamb_phase(dev))
    torch.cuda.empty_cache()
    for row, extra in lamb_phase(dev, "bert_large_config").items():
        kernels[row]["bert_large_shape"] = {
            k: extra[k] for k in ("rows", "shapes", "max_abs_err", "ms",
                                  "device_ms", "plain_ms", "bound_ms",
                                  "bound_by")}
        print(f"chip_smoke: {row} at BERT-large's flat master "
              + json.dumps(kernels[row]["bert_large_shape"]))
    torch.cuda.empty_cache()
    # the bf16-moment route of both passes (lamb_moments_dtype="bfloat16")
    for config, key in (("bert_base_config", "bert_base_shape"),
                        ("bert_large_config", "bert_large_shape")):
        for row, extra in lamb_phase(dev, config,
                                     moments="bfloat16").items():
            kernels[row].setdefault("bf16_moments", {})[key] = {
                k: extra[k] for k in ("rows", "shapes", "max_abs_err",
                                      "moments_max_ulp", "ms", "device_ms",
                                      "bound_share_device", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "bytes_per_call")}
            print(f"chip_smoke: {row}, bf16 moments, at the {config} "
                  "master " + json.dumps(
                      kernels[row]["bf16_moments"][key]))
        torch.cuda.empty_cache()
    kernels.update(adam_phase(dev))
    kernels.update(int8_phase(dev))
    for row, want in (("paged_attention", "paged_attention_kernel"),
                      ("int8_matmul_wgmma", "int8_wgmma_kernel")):
        kernels[row]["sass"] = None if mix8 is None else {
            name: m for name, m in mix8.items() if want in name}
    kernels.update(moe_phase(dev))
    for row, extra in nmt_flash_phase(dev).items():
        kernels[row].update(extra)
        print(f"chip_smoke: {row} at the Transformer NMT's shapes "
              + json.dumps(extra["nmt_shape"]))
    for row, extra in sym_flash_phase(dev).items():
        kernels[row].update(extra)
        print(f"chip_smoke: {row} at the symbolic BERT encoder's shape "
              + json.dumps(extra["symbolic_bert_shape"]))
    for row, extra in sym_flash_phase(dev, L=384, key="squad_shape",
                                      path="a SQuAD-like").items():
        kernels[row].update(extra)
        print(f"chip_smoke: {row} at SQuAD fine-tuning's shape "
              + json.dumps(extra["squad_shape"]))
    for k in kernels.values():
        lib = "none" if k["library_ms"] is None \
            else f"{k['library_ms']:.4f} ms"
        print(f"chip_smoke: {k['name']}: err {k['max_abs_err']:.3g}; "
              f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
              f"library {lib}, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")

    lap("2")
    # 2. serving at full width, bfloat16
    model = build_model(gpt.gpt2_117m_config(dtype="bfloat16"), seed=0)
    reset_counts()
    reqs, stats, secs = serving_phase(model)
    counts = read_counts()
    print(f"chip_smoke: serving launches {counts}")
    check(all(r.verdict == "200 ok" for r in reqs),
          f"verdicts {[r.verdict for r in reqs]}")
    check(all(len(r.tokens) == 64 for r in reqs), "token counts")
    check(counts["paged_attention"] > 0, "paged kernel never launched")
    check(stats["prefix_hit_rate"] > 0, f"prefix_hit_rate {stats}")
    kernels["paged_attention"]["launches"] = counts["paged_attention"]
    n_tok = sum(len(r.tokens) for r in reqs)
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    serving = {"requests": len(reqs), "tokens": n_tok, "seconds": secs,
               "tokens_per_s": n_tok / secs,
               "ttft_ms_p50": float(np.percentile(ttft, 50)),
               "ttft_ms_p99": float(np.percentile(ttft, 99)),
               "prefix_hit_rate": stats["prefix_hit_rate"],
               "chunk_dispatches": stats["chunk_dispatches"],
               "prompt_tokens": stats["prompt_tokens"]}
    print("chip_smoke: serving " + json.dumps(serving))
    reset_counts()
    context_fill_phase(model)
    check(read_counts()["paged_attention"] > 0,
          "paged kernel never launched in the context-fill run")
    print("chip_smoke: a context-filling request beside a prefilling peer "
          "served 200 ok")

    lap("3")
    # 3. pages="on" == pages="off" in float32
    model32 = build_model(gpt.gpt2_117m_config(), seed=1)
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, 50257, (4, 50)).astype(np.int32)
    reset_counts()
    on = serve_tokens(model32, prompts, 16, "on")
    check(read_counts()["paged_attention"] > 0,
          "paged kernel never launched in the float32 run")
    off = serve_tokens(model32, prompts, 16, "off")
    check(on == off, f"pages on {on} != off {off}")
    print("chip_smoke: float32 pages=on tokens == pages=off tokens")

    lap("4")
    # 4. generate: flash prefill
    gp = np.random.RandomState(2).randint(0, 50257, (4, 100)).astype(np.int32)
    sync(model)
    reset_counts()
    t0 = time.perf_counter()
    toks = model.generate(gp, max_new_tokens=32)
    sync(model)
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"chip_smoke: generate launches {counts}, {toks.size / gen_s:.1f} "
          "tokens/s")
    check(toks.shape == (4, 32) and (toks >= 0).all()
          and (toks < 50257).all(), f"generate tokens {toks.shape}")
    check(counts["flash_attention_fwd"] > 0, "flash kernel never launched")
    kernels["flash_attention_fwd"]["launches"] = counts["flash_attention_fwd"]
    reset_counts()
    gen32 = model32.generate(prompts, max_new_tokens=16)
    check(read_counts()["flash_attention_fwd"] > 0,
          "flash kernel never launched in the float32 generate")
    check(gen32.tolist() == off, f"generate {gen32.tolist()} != serve {off}")
    print("chip_smoke: float32 generate tokens == pages=off server tokens")

    lap("5")
    # 5. where a steady decode round's time goes
    br = breakdown_phase(model)
    print("chip_smoke: breakdown " + json.dumps(br))
    del model, model32
    torch.cuda.empty_cache()

    lap("6")
    # 6. BERT-base pretraining steps
    train, counts = training_phase(dev)
    print("chip_smoke: training " + json.dumps(train))
    print(f"chip_smoke: training launches {counts}")
    kernels["flash_attention_fwd_dropout"]["launches"] = \
        counts["flash_attention_fwd"]
    for name in ("flash_attention_dq", "flash_attention_dkv", "lamb_pass1",
                 "lamb_pass2"):
        kernels[name]["launches"] = counts[name]

    lap("7")
    # 7. float32 training on the card == on the CPU
    parity = train_parity_phase(dev)
    print("chip_smoke: card-vs-CPU training " + json.dumps(parity))

    lap("8")
    # 8. GPT-2 117M pretraining steps with Adam
    gtrain, counts, gmodel, gtrainer = gpt_pretrain_phase(dev)
    print("chip_smoke: GPT-2 training " + json.dumps(gtrain))
    print(f"chip_smoke: GPT-2 training launches {counts}")
    kernels["adam_update"]["launches"] = counts["adam_update"]

    lap("9")
    # 9. float32 Adam and AdamW on the card == on the CPU
    aparity = adam_parity_phase(dev)
    print("chip_smoke: card-vs-CPU Adam/AdamW " + json.dumps(aparity))

    lap("10")
    # 10. the trained model, quantized to int8, serving
    gtrainer.sync_to_block()
    del gtrainer
    torch.cuda.empty_cache()
    qserve = int8_serving_phase(gmodel, serving)
    del gmodel
    torch.cuda.empty_cache()
    print("chip_smoke: int8 serving " + json.dumps(qserve))
    kernels["int8_matmul"]["launches"] = qserve["launches"]["int8_matmul"]
    kernels["int8_matmul_wgmma"]["launches"] = \
        qserve["generate_launches"]["int8_matmul_wgmma"]
    narrow = int8_narrow_phase(dev)
    print("chip_smoke: int8 float32 narrow model " + json.dumps(narrow))

    lap("11")
    # 11. the Switch-FFN LM at full width, Adam
    switch, counts = switch_phase(dev)
    torch.cuda.empty_cache()
    print("chip_smoke: Switch LM training " + json.dumps(switch))
    print(f"chip_smoke: Switch LM training launches {counts}")
    for name in ("moe_dispatch", "moe_combine"):
        kernels[name]["launches"] = counts[name]

    lap("12")
    # 12. a float32 Switch LM on the card == on the CPU
    sparity = switch_parity_phase(dev)
    print("chip_smoke: card-vs-CPU Switch LM " + json.dumps(sparity))
    torch.cuda.empty_cache()

    lap("13")
    # 13. BERT-large with per-layer remat, then without, LAMB
    large, counts = bert_large_phase(dev)
    print("chip_smoke: BERT-large training " + json.dumps(large))
    print(f"chip_smoke: BERT-large training launches (remat) {counts}")
    for name in ("flash_attention_fwd_dropout", "flash_attention_dq",
                 "flash_attention_dkv", "lamb_pass1", "lamb_pass2"):
        counter = "flash_attention_fwd" if name.startswith(
            "flash_attention_fwd") else name
        kernels[name]["bert_large_shape"]["launches"] = counts[counter]

    lap("14")
    # 14. a float32 BERT-large (2 layers, remat) on the card == on the CPU
    lparity = train_parity_phase(dev, config="bert_large_config")
    print("chip_smoke: card-vs-CPU BERT-large (remat) "
          + json.dumps(lparity))

    lap("15")
    # 15. ResNet-50 v1 training, bf16, SGD
    rn, counts = resnet50_phase(dev)
    print("chip_smoke: ResNet-50 training " + json.dumps(rn))
    print(f"chip_smoke: ResNet-50 training launches {counts}")

    lap("16")
    # 16. a float32 small ResNet v1 with grad accumulation, card == CPU
    rparity = resnet_parity_phase(dev)
    print("chip_smoke: card-vs-CPU ResNet v1 (SGD, grad accum 2) "
          + json.dumps(rparity))
    torch.cuda.empty_cache()

    lap("17")
    # 17. Transformer base (NMT) through the eager Gluon loop, bf16, Adam
    nmt, counts, nmt_model = nmt_train_phase(dev)
    print("chip_smoke: NMT training " + json.dumps(nmt))
    print(f"chip_smoke: NMT training launches {counts}")
    for row in ("flash_attention_fwd", "flash_attention_dq",
                "flash_attention_dkv"):
        kernels[row]["nmt_shape"]["launches"] = counts[row]
    kernels["adam_update"]["nmt_launches"] = counts["adam_update"]

    lap("18")
    # 18. its greedy and beam-4 decode; a float32 NMT card == CPU
    dec = nmt_decode_phase(nmt_model, dev)
    print("chip_smoke: NMT decode " + json.dumps(dec))
    del nmt_model
    torch.cuda.empty_cache()
    nparity = nmt_parity_phase(dev)
    print("chip_smoke: card-vs-CPU NMT (eager Adam, decode) "
          + json.dumps(nparity))

    torch.cuda.empty_cache()

    lap("19")
    # 19. YOLOv3-tiny through the eager Gluon loop, bf16, Adam
    ytrain, counts, ymodel = yolo_train_phase(dev)
    print("chip_smoke: YOLOv3-tiny training " + json.dumps(ytrain))
    print(f"chip_smoke: YOLOv3-tiny training launches {counts}")
    kernels["adam_update"]["yolo_launches"] = counts["adam_update"]

    lap("20")
    # 20. its decode (box_nms kernel), VOC07 mAP; the kernel vs plain
    ydec, nms_cases = yolo_decode_phase(ymodel, dev)
    print("chip_smoke: YOLOv3-tiny decode " + json.dumps(ydec))
    del ymodel
    torch.cuda.empty_cache()

    lap("21")
    # 21. SSD through the eager Gluon loop, bf16, Adam; multibox_detection
    strain, counts, nms_cases["ssd_multibox_detection"] = \
        ssd_train_phase(dev)
    print("chip_smoke: SSD training " + json.dumps(strain))
    print(f"chip_smoke: SSD training launches {counts}")
    kernels["adam_update"]["ssd_launches"] = counts["adam_update"]
    torch.cuda.empty_cache()
    main_case = nms_cases["yolo_decode"]["topk"]
    kernels["box_nms"] = dict(
        name="box_nms", route="cuda",
        source="mxnet_tpu_torch/csrc/box_nms.cu",
        replaces="mxnet_tpu/ops/detection_ops.py:84 (box_nms's "
                 "lax.fori_loop over the rows; not a Pallas kernel)",
        launches=ydec["launches"]["box_nms"],
        max_abs_err=max(c["max_abs_err"] for c in nms_cases.values()),
        ms=main_case["ms"], event_ms=main_case["event_ms"],
        plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
        bound_by=main_case["bound_by"], library_ms=None,
        general_path=nms_cases["yolo_decode"]["general"],
        library="none: no PyTorch call computes greedy NMS (torchvision "
                "is a library kernel, and not installed)",
        times_are="ms: device time of the kernel (torch.profiler, L2 "
                  "flushed); event_ms: CUDA events around the wrapper; "
                  "plain_ms: CUDA events around one plain call",
        bound_is="the larger of the bytes these inputs need (each image's "
                 "boxes, valid flags and ids up to its cut read once, keep "
                 "written once) at 3.35 TB/s and 15 float32 operations a "
                 "pair the loop must test (kept rows against earlier kept "
                 "rows of their class, suppressed rows once) at 67 TFLOP/s",
        error_is="gate: keep masks and output rows equal (torch.equal) "
                 "in every case, top-k path and general; max_abs_err over "
                 "the cases' rows",
        shapes="YOLOv3-tiny decode (64, 2535) rows per class, max_keep "
               "100 (phase 20; general_path: no max_keep); cases: "
               + ", ".join(nms_cases), cases=nms_cases)
    for c, v in nms_cases.items():
        print(f"chip_smoke: box_nms {c}: " + json.dumps(v))

    lap("22")
    # 22. float32 YOLOv3-tiny and SSD, card == CPU
    dparity = detection_parity_phase(dev)
    print("chip_smoke: card-vs-CPU detection (eager Adam, decode) "
          + json.dumps(dparity))
    torch.cuda.empty_cache()

    lap("23")
    # 23. DeepAR through the eager Gluon loop, float32, Adam; sampling
    ar, counts = deepar_phase(dev)
    print("chip_smoke: DeepAR " + json.dumps(ar))
    print(f"chip_smoke: DeepAR training launches {counts}")
    kernels["adam_update"]["deepar_launches"] = counts["adam_update"]

    lap("24")
    # 24. CRNN through ShardedTrainer and the CTC loss, float32, Adam
    ocr, counts = crnn_phase(dev)
    print("chip_smoke: CRNN " + json.dumps(ocr))
    print(f"chip_smoke: CRNN training launches {counts}")
    kernels["adam_update"]["crnn_launches"] = counts["adam_update"]

    lap("25")
    # 25. small float32 DeepAR and CRNN, card == CPU
    rparity = rnn_parity_phase(dev)
    print("chip_smoke: card-vs-CPU DeepAR and CRNN " + json.dumps(rparity))
    torch.cuda.empty_cache()

    lap("26-29")
    # 26-29. the serving request lifecycle, the admission ladder,
    # speculative decoding and beam search on phase 2's model, cut to
    # SERVE_DEPTH
    model = build_model(gpt.gpt2_117m_config(dtype="bfloat16",
                                             **SERVE_DEPTH), seed=0)
    life, ref_stats = lifecycle_phase(model)
    print("chip_smoke: serving lifecycle " + json.dumps(life))
    ladder = ladder_phase(model, ref_stats)
    for row in ladder.pop("exec_peaks"):
        print("chip_smoke: exec peak " + json.dumps(row))
    print("chip_smoke: admission ladder " + json.dumps(ladder))
    distil = build_model(gpt.gpt2_117m_config(dtype="bfloat16",
                                              **DISTILGPT2), seed=2)
    spec = spec_phase(model, distil)
    del distil
    print("chip_smoke: speculative decoding " + json.dumps(spec))
    kernels["paged_attention"]["speculative_launches"] = {
        name: {k: spec[name][k] for k in (
            "paged_launches", "rounds", "spec_rounds",
            "paged_launches_per_round", "paged_launches_per_spec_round")}
        for name in ("plain", "self", "distil")}
    beam = beam_phase(model)
    print("chip_smoke: beam search " + json.dumps(beam))
    kernels["flash_attention_fwd"]["beam_launches"] = \
        beam["eos_50256"]["flash_fwd_launches"]
    del model
    torch.cuda.empty_cache()

    lap("30")
    # 30. float32 speculative serving, beam search and the ladder, card
    # == CPU
    sparity = serve_parity_phase(dev)
    print("chip_smoke: card-vs-CPU speculative, beam, ladder "
          + json.dumps(sparity))

    torch.cuda.empty_cache()

    lap("31")
    # 31. BERT-large with bf16 LAMB moments against phase 13's float32 run
    bfm, counts = bf16_moments_phase(dev, large["remat"])
    print("chip_smoke: BERT-large, bf16 LAMB moments " + json.dumps(bfm))
    print(f"chip_smoke: BERT-large, bf16 LAMB moments, launches {counts}")
    for name in ("lamb_pass1", "lamb_pass2"):
        kernels[name]["bf16_moments"]["launches"] = counts[name]
        kernels[name]["bf16_moments"]["lamb_device_ms_per_step"] = \
            bfm["lamb_device_ms_per_step"]

    lap("32")
    # 32. the remat policies at BERT-large, and bit equality on the card
    pol = remat_policies_phase(dev, large)
    print("chip_smoke: BERT-large remat policies " + json.dumps(
        {k: v for k, v in pol.items() if k != "runs"}))
    for name, run in pol["runs"].items():
        print(f"chip_smoke: BERT-large remat {name!r} " + json.dumps(run))
    pbit = policy_bit_equal_phase(dev)
    print("chip_smoke: remat policies bit equal to 'none' (float32, "
          "dropout 0.1) " + json.dumps(pbit))
    torch.cuda.empty_cache()

    lap("33")
    # 33. the OOM ladder on a real out-of-memory (12 GB cap)
    ladder = oom_ladder_phase(dev, large["remat"]["losses"])
    print("chip_smoke: OOM ladder " + json.dumps(ladder))
    torch.cuda.empty_cache()

    lap("34")
    # 34. checkpoints, preemption and resume (the --auto-checkpoint-dir
    # flow), .params save and load
    ckpt = ckpt_phase(dev, CKPT_DEPTH)
    print("chip_smoke: checkpoint and preemption " + json.dumps(ckpt))
    torch.cuda.empty_cache()

    lap("35")
    # 35. float32 card vs CPU: bf16-moment LAMB, files, the ladder
    dpar = durable_parity_phase(dev)
    print("chip_smoke: card-vs-CPU bf16 LAMB, checkpoint files, ladder "
          + json.dumps(dpar))
    torch.cuda.empty_cache()

    lap("36")
    # 36. the repo's examples, unchanged, through run_example
    t36 = time.perf_counter()
    reset_counts()
    ex = examples_phase(dev)
    gen = next(r for r in ex["runs"] if r["example"] == "gpt/generate.py")
    kernels["adam_update"]["generate_example_launches"] = \
        gen["launches"]["fused_update.launches_adam"]
    kernels["flash_attention_fwd"]["generate_example_launches"] = \
        gen["launches"]["flash_attention.launches"]
    print("chip_smoke: examples " + json.dumps(
        {"dataloader_batches_per_s": ex["dataloader_batches_per_s"],
         "seconds": time.perf_counter() - t36}))

    lap("37")
    # 37. the vision model zoo at published widths, the example's loop
    t37 = time.perf_counter()
    zoo = zoo_phase(dev)
    print(f"chip_smoke: zoo {len(zoo)} nets in "
          f"{time.perf_counter() - t37:.1f} s")
    torch.cuda.empty_cache()

    lap("38")
    # 38. card vs CPU: zoo families, a DataLoader forked after CUDA, the
    # shape ops
    t38 = time.perf_counter()
    zpar = parity_phase(dev)
    print("chip_smoke: card-vs-CPU zoo, DataLoader, shape ops "
          + json.dumps(zpar) + f" in {time.perf_counter() - t38:.1f} s")
    torch.cuda.empty_cache()

    lap("39")
    # 39. the symbolic BERT-base encoder trained by Module.fit
    t39 = time.perf_counter()
    sbert = sym_bert_phase(dev)
    print("chip_smoke: symbolic BERT-base Module.fit " + json.dumps(sbert))
    steps = sbert["steps"]
    for row, counter in (("flash_attention_fwd_dropout",
                          "flash_attention_fwd"),
                         ("flash_attention_dq", "flash_attention_dq"),
                         ("flash_attention_dkv", "flash_attention_dkv")):
        kernels[row]["symbolic_bert_shape"]["launches"] = \
            sbert["launches"][counter]
        kernels[row]["symbolic_bert_shape"]["steps"] = steps
    kernels["adam_update"]["symbolic_bert_launches"] = \
        sbert["launches"]["adam_update"]
    torch.cuda.empty_cache()

    lap("40")
    # 40. the symbolic encoder against models.bert's BERTModel
    spar = sym_bert_parity_phase(dev)
    print("chip_smoke: symbolic encoder vs BERTModel " + json.dumps(spar))
    torch.cuda.empty_cache()

    lap("41")
    # 41. BucketingModule over lengths 64 and 128
    sbuck = sym_bucketing_phase(dev)
    print("chip_smoke: BucketingModule " + json.dumps(sbuck))
    torch.cuda.empty_cache()

    lap("42")
    # 42. card vs CPU through Module.fit
    sppar = sym_parity_phase(dev)
    print("chip_smoke: card-vs-CPU Module.fit " + json.dumps(sppar))

    lap("43")
    # 43. the registry's kernel ops through sym == through nd
    sops = sym_kernel_ops_phase(dev)
    print("chip_smoke: kernel ops through sym " + json.dumps(sops))
    kernels["int8_matmul"]["symbolic_launches"] = \
        sops["quantized_dense_M8"]["int8_matmul"]
    kernels["int8_matmul_wgmma"]["symbolic_launches"] = \
        sops["quantized_dense_M512"]["int8_matmul_wgmma"]
    kernels["box_nms"]["symbolic_launches"] = sops["box_nms"]["box_nms"]
    print(f"chip_smoke: symbolic phases 39-43 in "
          f"{time.perf_counter() - t39:.1f} s")
    torch.cuda.empty_cache()

    lap("44")
    # 44. eager BERT-base pretraining, gluon.Trainer(..., "lamb"); card
    # vs CPU
    t44 = time.perf_counter()
    ebert, counts = eager_bert_phase(dev)
    print("chip_smoke: eager BERT-base, gluon.Trainer lamb "
          + json.dumps(ebert))
    print(f"chip_smoke: eager BERT-base launches {counts}")
    for name in ("lamb_pass1", "lamb_pass2"):
        kernels[name]["eager_bert_base"] = {
            "launches": counts[name], "steps": ebert["steps"]}
    for row, counter in (("flash_attention_fwd_dropout",
                          "flash_attention_fwd"),
                         ("flash_attention_dq", "flash_attention_dq"),
                         ("flash_attention_dkv", "flash_attention_dkv")):
        kernels[row]["symbolic_bert_shape"]["eager_launches"] = \
            counts[counter]
    epar = eager_bert_parity_phase(dev)
    print("chip_smoke: card-vs-CPU eager LAMB " + json.dumps(epar))

    lap("45")
    # 45. the optimizers through NDArrays on the card; LAMB's eager route
    opts, route = eager_optimizers_phase(dev)
    print("chip_smoke: optimizers card vs CPU " + json.dumps(opts))
    print("chip_smoke: eager LAMB route at the word embedding "
          + json.dumps(route))
    for name in ("lamb_pass1", "lamb_pass2"):
        kernels[name]["eager_bert_base"]["word_embedding_update"] = route
    kernels["adam_update"]["nd_adam_update_launches"] = \
        opts["nd.adam_update"]["launches"]

    lap("46")
    # 46. the JAX package's unit-test files on the card
    t46 = time.perf_counter()
    units = jax_unittests_phase()
    print("chip_smoke: JAX unit-test files on the card " + json.dumps(units)
          + f" in {time.perf_counter() - t46:.1f} s")
    print(f"chip_smoke: eager phases 44-46 in "
          f"{time.perf_counter() - t44:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    lap("47")
    # 47. the observability layer on the training and serving paths
    t47 = time.perf_counter()
    obs = observability_phase(dev)
    obs["card"] = card
    print("chip_smoke: observability " + json.dumps(obs))
    lap("48")
    # 48. diagnostics, profiler and inspect
    diag = diag_profile_inspect_phase(dev)
    diag["card"] = card
    print("chip_smoke: diagnostics, profiler, inspect " + json.dumps(diag))
    print(f"chip_smoke: observability phases 47-48 in "
          f"{time.perf_counter() - t47:.1f} s")

    lap("49")
    # 49-50. the operations layer (goodput, guard, slo, check, scope) on
    # the serving and training paths
    import tempfile
    t49 = time.perf_counter()
    tmp_ops = tempfile.mkdtemp(prefix="chip_smoke_ops_")
    ops_serve = ops_serve_phase(build_model(gpt.gpt2_117m_config(
        dtype="bfloat16", **SERVE_DEPTH), seed=0), tmp_ops)
    ops_serve["card"] = card
    print("chip_smoke: operations layer, serving " + json.dumps(ops_serve))
    torch.cuda.empty_cache()
    lap("50")
    ops_train = ops_train_phase(dev, tmp_ops)
    ops_train["card"] = card
    print("chip_smoke: operations layer, training " + json.dumps(ops_train))
    kernels["paged_attention"]["ops_layer_launches"] = \
        ops_serve["launches"]["paged_attention"]
    print(f"chip_smoke: operations phases 49-50 in "
          f"{time.perf_counter() - t49:.1f} s")
    torch.cuda.empty_cache()

    lap("51")
    # 51-53. BERT-base SQuAD fine-tuning; the fine-tuning heads card vs
    # CPU; control flow and Parameter's accessors on the card
    t51 = time.perf_counter()
    squad, counts = squad_phase(dev)
    squad["card"] = card
    print("chip_smoke: BERT-base SQuAD fine-tuning " + json.dumps(squad))
    for row, counter in (("flash_attention_fwd_dropout",
                          "flash_attention_fwd"),
                         ("flash_attention_dq", "flash_attention_dq"),
                         ("flash_attention_dkv", "flash_attention_dkv")):
        kernels[row]["squad_shape"]["launches"] = counts[counter]
        kernels[row]["squad_shape"]["steps"] = squad["steps"]
    kernels["adam_update"]["squad_launches"] = counts["adam_update"]
    lap("52")
    fpar = finetune_parity_phase(dev)
    fpar["card"] = card
    print("chip_smoke: fine-tuning heads card vs CPU " + json.dumps(fpar))
    lap("53")
    cflow = control_flow_phase(dev)
    cflow["card"] = card
    print("chip_smoke: control flow and accessors card vs CPU "
          + json.dumps(cflow))
    print(f"chip_smoke: fine-tuning phases 51-53 in "
          f"{time.perf_counter() - t51:.1f} s")
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
