"""Chip smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase catches and
carries on:

1. environment: the card's name and power limit; build every CUDA kernel
   of the port from the sources in this checkout, one nvcc (sm_90a) per
   source, all at once, printing ptxas's registers, shared memory and
   spills, failing if any instantiation of the ragged, chunk-prefill or
   paged-decode kernel spills (12 each: they share one split walk);
   where the toolkit has cuobjdump, the count of tensor-core
   instructions (HMMA) in the SASS of each flash kernel (forward, dK/dV
   and dQ), none failing;
2. every kernel against its plain PyTorch version, on CUDA tensors, at
   small edge shapes and at the main paths' shapes: the paged kernels
   within max |diff| 2e-5 on float32, bfloat16 and int8 pools (int8:
   zero-scale pages, misaligned pools, both layouts; and an int8 pool
   without its scales must raise); the ragged kernel also on one decode
   row over 4,100 keys (a pages bucket of 272), 32 decode rows and a
   64-row chunk whose tiles straddle its key splits, the decode kernel
   also on one row over 4,100 keys and the chunk kernel on a chunk whose
   tiles straddle its key splits; the ragged kernel also on
   speculation's verify rows (8 descriptors of 5 rows over 16..632 keys)
   and on the decode loop's fixed axis (8 x 5 rows, descriptors of 5, 1
   and 0 rows); each paged kernel launched twice on
   every case, the two outputs bitwise equal; the flash kernels elementwise within
   atol = rtol = 2e-5 (out, lse) and 1e-4 (dq, dk, dv) in fp32, 2e-2 in
   bf16;
3. the engine at GPT-2-small width on the card: 8 requests (6 greedy, 2
   seeded stochastic) served through the ragged step; the ragged
   kernel's launch count over that run must equal num_layers x steps
   (the engines of phases 3-7 leave ``prefix_cache`` unset, which is on
   on the card, as chunked prefill is, and off on the CPU: phase 7's two
   requests that resend phase 3's first two prompts hit the cache on the
   card, so its holds there are warm runs against cold ones);
4. the same engine, weights and prompts cut to 2 layers, on the card
   (ragged launches = 2 x steps) and on the CPU (the kernels' plain
   versions): first-token logits within 1e-3, greedy streams identical
   or diverging only at a near tie (CPU top-2 logit gap < 1e-4); the
   card-vs-CPU runs of phases 6 (b), 7 (a) and 12 run at that cut depth
   too, since a CPU run of their traffic at full depth takes minutes;
5. the legacy step at the same width and traffic (fused decode, chunked
   prefill of 64): on the card, the decode and chunk kernels' launches
   must equal num_layers x their step calls; then on the CPU, held to
   phase 4's rule; then a short one-shot-prefill run with the eager
   decode (4 prompts, 8 new tokens) on card and CPU, held to it too;
6. int8 KV pools at GPT-2-small width, the same model, pool (512 pages
   of 16) and traffic with ``kv_dtype="int8"``: (a) the ragged step on
   the card, the int8 ragged kernel's launches equal to num_layers x
   steps and no float launch; (b) int8 at 2 layers on the card and the
   CPU, held to phase 4's rule with int8's bounds (first-token logits
   within 3e-2, near ties below 6e-2: a K/V value that differs in its
   last bits between the devices may quantize one step apart); (c) the
   legacy step on the card,
   the int8 decode and chunk kernels' launches equal to num_layers x
   their calls, held to (a) by the same rule; printed, not gated: greedy
   agreement and first-token logit drift against phase 3's float32 run,
   and the pool bytes of int8 against float32;
7. speculation and the host-free decode loop at GPT-2-small width:
   phase 3's engine, weights and traffic plus a prompt of one repeated
   span and two requests with a stop token and a stop sequence, served
   with spec {off, on (ngram, K=4)} x N {1, 4} on float32 and int8
   pools, and float32 spec on at N=8; each run's requests end by length or stop, its ragged-kernel
   launches equal num_layers x (ragged steps + N x (loop replays + the
   loop's captures in the run)), and its streams are held by phase 4's
   rule (phase 6's bounds for int8) to the spec-off N=1 run of its dtype
   (int8 with speculation: to int8 spec-on N=1; a rejected draft's write
   can grow its page's scale, so int8 spec against spec off is printed,
   not gated, as the JAX package pins rather than guarantees it);
   (a) speculation accepts and rewinds drafts, and on a subset of the
   traffic spec-on card vs CPU at 2 layers holds by the same rules (the
   CPU engine with the prefix cache on, as the card's resolves); (b)
   the loop
   fetches at most once per N tokens on its path; (c) per dtype one
   captured loop's replay equals the eager loop bitwise (output and
   pools, the sink page aside); (d) the device sampler on the card
   against the host sampler over seeded [8, 50304] logits across the
   sampling menu: at most 1 row in 1000 sampling another token, the
   counters equal; (e) is in phase 2 (the verify and loop shapes) and
   (f) in phase 14;
8. training at GPT-2-small width (the JAX package's ``bench_gpt_zero``
   configuration: vocab 50257, 12 layers of 768, 12 heads, 512
   positions, flash attention, AdamW lr 1e-4, bf16 amp): at dropout 0,
   the card's first two steps against the same weights and batch on the
   CPU (B=2, L=512): losses within 1e-4 relative, the step-1 gradient
   norm within 1e-3 relative; then at the bench's dropout 0.1 on the
   card, B=8, L=512, 3 warm-up and 10 timed steps on one batch: the
   loss finite and falling, and each flash kernel's launches equal to
   num_layers x steps;
9. encoder pretraining (the JAX package's ``bench_bert`` configuration:
   BERT-base, vocab 30522, 12 layers of 768, 12 heads, FFN 3072, AdamW,
   bf16 amp; attention on the composite path, as in the JAX package):
   (a) BERT-base at dropout 0, then ERNIE-base (vocab 18000, task
   embeddings, labels from ``apply_knowledge_mask`` with -100 off the
   masked spans), the card's first three steps under a LinearWarmup over
   PolynomialDecay schedule against the same weights and batch on the
   CPU (B=2, L=128), held by phase 8's rule; (b) the bench's run on the
   card, dropout 0.1, lr 1e-4 constant, B=64, L=128, 3 warm-up and 10
   timed steps on one batch: the loss finite and falling, and no kernel
   of the port launched;
10. static ResNet-50 (the JAX package's ``bench_resnet`` configuration:
   B 64, 224x224, 1000 classes, Momentum(0.1, 0.9), static bf16 AMP,
   through ``static.Program``, ``append_backward`` and the ``Executor``;
   convolutions are PyTorch's, no kernel of the port is on this path):
   (a) at full width and depth, B 2, the card's startup scope carried to
   a CPU executor: the fp32 program's three steps card vs CPU, each from
   the CPU's scope, its loss within 1e-4 relative, every BN running stat
   after it within 1e-4 of the tensor's largest magnitude and the
   step's gradients within 0.1 as one norm over all of them; at step 1
   op by op, each op on the card from the CPU run's values of its
   inputs (``replay_held``), every output within 1e-4 of its tensor's
   largest magnitude (every activation and gradient, each updated
   parameter with the stem filter, each velocity and running stat),
   and the count of ReLU outputs that took the other side of 0 end to
   end; the AMP program's step-1 loss within 1e-2, and op by op at step
   1 every bfloat16 output within 1e-2 and every float32 one within
   1e-4; (b) the bench's run on the
   card: the feed staged once, a warm-up ``run_chained`` of 20 steps,
   three timed chains, 1 + 3 stepped runs, every loss finite; no kernel
   of the port launched in (a) or (b);
11. dygraph vision (the JAX package's ``bench_lenet`` configuration:
   LeNet, B 128, 1x28x28, 10 classes, Adam 1e-3, ``loss.backward()``,
   the eager ``opt.step()`` and ``opt.clear_grad()``; convolutions,
   pools and batch norm are PyTorch calls, no kernel of the port is on
   this path): (a) LeNet card vs CPU over three steps from one carried
   state, plain and with ClipGradByGlobalNorm(1.0), L2Decay(1e-4) and
   one parameter at half the learning rate: losses within 1e-4
   relative, the step-1 gradients and the parameters after step 3
   within 1e-4 of each tensor's largest magnitude, a parameter entry
   past that only within 2 x the summed Adam step sizes (a sign step
   on a near-zero gradient); (b) dygraph ResNet-50 at full width and
   depth, B 2, 224x224, 1000 classes: eval logits within 1e-4 of their
   largest magnitude, one Momentum(0.1, 0.9) train step with its loss
   within 1e-4 relative, every BN running stat within 1e-4 and the
   gradients within 0.1 as one norm (phase 10's reason); VGG-11,
   MobileNet V1 and V2 eval logits within 1e-4; (c) the bench's run on
   the card (3 warm-up steps, 10 synced once, 10 each synced): the loss
   finite and falling; then the dygraph ResNet-50 at B 64, fp32,
   Momentum, timed (printed); no kernel of the port launched over the
   phase;
12. prefix caching at GPT-2-small width (phase 3's model, pool of 512
   pages of 16 and 8 slots, chunks of 64): a 512-token system prompt (32
   full pages) shared by 7 requests with 16..96-token suffixes, the
   system prompt alone (its match clipped to 511 tokens: a copy on
   write), and a two-turn conversation (turn 2 is turn 1's prompt, its
   32-token answer and 24 new tokens: a hit into the decode tail); then
   the system prompt alone again; 32 new tokens each, 6 greedy and 5
   seeded stochastic; request 0 runs until its prefill is done before
   the rest arrive.  (a) the ragged step cold and warm on the card, and
   warm on the card and the CPU at 2 layers (a CPU run of this traffic
   at full depth takes minutes): each warm run's hits, prefill tokens
   (the prompts' less the hits, and the cold run's less the hits),
   copies on write (two, each bitwise its donor page right after the
   copy) and peak shared pages (>= 32); the CPU's prefix counters equal
   to the card's; ragged launches = num_layers x steps; warm card
   against cold card, and card against CPU at 2 layers, by phase 4's
   rule; (b) the legacy step and (c) the
   one-shot prefill with the eager decode, each warm against its own
   cold run by phase 4's rule: decode and chunk launches = num_layers x
   their calls (chunk calls: the legacy chunk step's, fewer warm than
   cold; the one-shot run's warm suffixes, one per warm request, through
   the eager chunk path on the chunk kernel); (d) int8 pools, as (a),
   by phase 6's bounds; (e) speculation (K=4)
   with the loop (N=4) over a warm float32 cache, held by phase 7's rule
   to (a)'s warm run, with a copy on write between two replays of one
   captured loop graph; (f) the system run exported from (a)'s warm
   engine bitwise the pool's own bytes, imported into a fresh card
   engine whose request 0 then prefills only its suffix and is held to
   (a)'s by phase 4's rule, and an int8 payload refused by a float32
   engine;
13. the serving fleet at GPT-2-small width (phase 12's model and replica:
   512 pages of 16, 8 slots, chunks of 64, the prefix cache on; the
   traffic: the 7 requests sharing the 512-token system prompt and a
   two-turn conversation, 32 new tokens each, 6 greedy and 3 seeded
   stochastic), every stream held by phase 4's rule to one cold card
   engine on the same traffic (turn 2 where both runs' turn-1 answers
   agree): (a) two in-process replicas on affinity routing with worker
   threads: the shared prompts routed by the prefix rung (at least 6),
   turn 2 by the session rung to turn 1's replica; ragged launches =
   num_layers x the replicas' steps, as in every in-process run below;
   a one-replica fleet beside it, and phase 3's 8 requests on one and
   on two replicas; (b) a drain in mid-decode of stepped replicas: live
   (``fleet.live_migrated_total`` >= 1, ``migrated_replay_tokens`` 0,
   each migrated sequence's pages exported again on the importer
   bitwise the snapshot's), then cold (``live_migration=False``: more
   than 0 replayed tokens); (c) one ``role="prefill"`` and one
   ``role="decode"`` replica: ``fleet.pd_handoffs`` = the requests, the
   prefill replica samples one token per request; (d) two replicas with
   ``loop_steps=4`` stepping at once on their worker threads, a loop
   captured while the sibling completes steps, held by phase 7's rule
   to (a)'s fleet, and one captured replay bitwise the eager loop; (e)
   a ``transport="proc"`` and a ``transport="tcp"`` replica, child
   processes on the card: the system prompt warm on one, a request on
   the other adopting it peer to peer at ``page_codec="compressed"``
   (``fleet.pages_adopted`` >= 32, ``page_relay_bytes`` 0, only the
   suffix prefilled); a SIGKILL of one child in mid-stream, its streams
   completed on the other (``replica_dead_total`` 1); then
   ``FleetSupervisor.tick`` brings it back and it serves a request; (f)
   an int8 replica beside a float32 one: float32 pages refused by the
   int8 replica (``import_prefix_pages`` 0, no page adopted), its
   request a cold prefill held to one int8 engine by phase 6's near-tie
   bound;
14. numbers: each kernel's and its plain version's times at its main
   path's shape beside its bound (the paged kernels on float32, int8
   and bfloat16 pools, each with its live and launched blocks (from the
   host mirrors of its items) and its counters' zero-fill alone; the
   decode and chunk kernels also at 1, 2, 4 rows and 16, 32 chunk rows;
   for
   the flash kernels, PyTorch's
   scaled_dot_product_attention forward and backward at that shape, the
   fp32 bound at the 3xTF32 rate with the fp32 FMA share beside it, the
   forward and the whole backward through autograd against sdpa's in
   turns, with the names of sdpa's forward and backward kernels), the
   int8 write's time per layer, each engine's tokens/s, ms per step and
   time to first token (float32 and int8), the ragged kernel at
   phase 2's verify and loop shapes, (f) for phase 7's spec x N
   engines on float32 and int8 pools tokens/s, ms per token, host
   fetches per token, the acceptance rate, the device idle share under
   torch.profiler (float32 spec off N=1 and spec on N=4), and for the
   loops the capture time
   per pages bucket, one iteration's device time live and masked, and the masked tail's
   device time in the run, the GPT trainer's tokens/s,
   ms per step, peak memory and device idle share, and BERT-base's
   samples/s, tokens/s, ms per step, peak memory, model TFLOP/s
   (bench.py's formula), device idle share and top kernels; and
   ResNet-50's images/s chained and synced, ms per step, model TFLOP/s
   by bench.py's formula and by ``cost_analysis`` with the share of the
   dense bf16 peak, peak memory, and under torch.profiler over one chain
   its idle share, the device time the executor's host loop leaves
   idle per step and its top kernels; LeNet's images/s, ms per step,
   the eager step()'s host time, its device kernels per step and idle
   share under torch.profiler; the dygraph ResNet-50's ms per step,
   images/s and peak memory beside the static executor's; phase 12's
   time to first token of the seven warm requests, prefill tokens,
   tokens/s and peak pages in use, cold against warm, and the device
   time of one copy on write and of one 32-page export and import;
   phase 13's requests by routing rung, the warm requests' time to first
   token on one replica and on the fleet, tokens/s of one and of two
   in-process replicas, the wall time and bytes of one live migration,
   the peer-to-peer wire bytes against raw and the transfer's wall, the
   handoff latency, spawn to ``describe`` of a proc and a tcp child, and
   the longest step of an in-process replica;
15. tensor parallel at GPT-2-small width, every shard on card 0 (a mesh
   of tp shards named outright, ``tp_mesh(tp, devices=["cuda:0"] * tp)``):
   (a) the three paged kernels per shard at tp 2 and 4 (6 and 3 heads a
   shard) on phase 2's main-path operands, float32 and int8, both
   layouts: one launch a shard, each shard's output against the
   unsharded call's heads (bitwise is printed; the hold is 2e-5) and
   against its plain version's shard within 2e-5; (b) phase 3's model
   and traffic at full depth: the float32 ragged step at tp 2 and 4
   against phase 3's tp 1 run by phase 4's rule, ragged launches = tp x
   num_layers x steps and each shard's pool bytes 1/tp of the tp 1
   pool's; the legacy step at tp 4 against phase 5's run by the same
   rule, decode and chunk launches = tp x num_layers x calls; int8 at
   tp 4 against phase 6 (a)'s run by phase 6's bounds, and the int8
   legacy step at tp 4 against phase 6 (c)'s by its near-tie bound (gaps
   from phase 6 (a)'s logits), launches counted as above; int8 with the
   quantized ring (``quantized_collectives``) at tp 4 against its
   float32-collective sibling: the collective bytes per step cut >= 3x,
   ``generation.collective_quantized`` 1 and 0, every greedy divergence
   at a top-2 gap below phase 6's 6e-2 (the int8 ring rounds each
   all-reduce to a 127th of its chunk's abs-max, as int8 pools round
   K/V), and its position-wise greedy agreement >= 0.45; the ring
   itself at tp 4 on row-split products at the main path's width, on
   the card against the CPU (bitwise, else 4 ulps) and within ``2 tp
   max|sum| / 127`` of the exact sum; float32 with
   speculation (K=4) and the captured loop (N=4) at tp 4 against tp 4
   spec off N=1 by phase 7's rule; (c) at 2 layers, tp 4 on the card and
   on the CPU, by phase 4's rule; (d) where the call sees 4 cards, (b)'s
   float32 ragged run over ``tp_mesh(4)``, else a line saying it has
   one; printed, not gated: tokens/s of every run and the device idle
   share at tp 1, 2 and 4 over 24 steps of the traffic;
16. data parallel, ZeRO and the pipeline at GPT-2-small width, every
   shard on card 0 (``build_mesh(..., devices=["cuda:0"] * n)``): (c)
   first, at dropout 0, 2 layers, B 2 a shard, 2 steps: the card's
   ``{"data": 4}`` ``CompiledTrainStep`` at ZeRO 0, 1, 2 and 3 against the
   card's one-device ``TrainStep`` on the global batch (losses within
   1e-4 relative), ZeRO 1-3 against ZeRO 0 (losses within 1e-5 relative,
   parameters by tests/test_torch_train_step.py's fp32 Adam rule), and
   the ``{"pipe": 2, "data": 2}`` ``PipelinedTrainStep`` (2 micro-batches,
   remat) on the card against the CPU (losses within 1e-4); (a)
   ``bench_gpt_zero``'s configuration (phase 8's model at dropout 0.1, B
   8 a shard, L 512, AdamW 1e-4, bf16 amp) over ``{"data": 4}`` at ZeRO
   0-3, 2 warm-up and 3 timed steps each from one set of weights: the
   loss finite and falling, each flash kernel launched dp x num_layers
   times a step, no paged kernel launched, each shard's optimizer state
   at ZeRO 1-3 and its parameters at ZeRO 3 1/dp of ZeRO 0's (to the
   padding); (b) the pipeline over ``{"pipe": 2, "data": 2}``, 4
   micro-batches of 2 rows, ZeRO 1, remat off and on, held likewise,
   the flash forward launched dp x M x num_layers times a step (twice
   that with remat) and dK/dV and dQ dp x M x num_layers; (d) where the
   call sees 4 cards, (a) at ZeRO 3 over cuda:0..3 with the bytes moved
   between cards, else a line saying it has fewer; printed, not gated:
   ms per step, tokens/s, the device idle share over 2 profiled steps,
   peak memory, each shard's persistent bytes and the collective bytes
   per step;
17. tensor-, context- and expert-parallel training at GPT-2-small width,
   every shard on card 0 (held card vs CPU at 2 layers, then timed);
18. dygraph AMP and the high-level surface: (a) GPT at full width, 2
   layers, B 2, L 128, dropout 0, ``use_flash=True``: two eager O1
   ``amp.auto_cast`` + ``amp.GradScaler`` + AdamW steps on the card
   against the CPU from the same weights and batch (losses within 1e-2
   relative, the scales equal, each bf16 flash kernel launched 2 x 2
   times on the card), and the three flash kernels' bf16 instantiations
   at this path's shapes ([2 x 12, 128, 64] and [8 x 12, 512, 64],
   causal) against their plain versions within 2e-2; ``hapi.Model(
   LeNet).fit`` over a synthetic MNIST-shaped ``io.TensorDataset``
   through an ``io.DataLoader`` with 2 worker processes, fp32, card
   against CPU (every step's loss within 1e-5 relative, the accuracies
   equal), ``ModelCheckpoint``'s files loaded back bitwise; (b)
   ``bench_gpt_zero``'s GPT-2 small (12 layers, B 8, L 512, dropout
   0.1, attention dropout 0) in eager O1 AMP and in fp32, fed by an
   ``io.DataLoader``, 2 warm-up, 5 timed and 1 profiled step each: the
   loss finite and falling, each flash kernel launched num_layers times
   a step in bfloat16 under AMP and in float32 without; BERT-base eager
   O1 AMP at ``bench_bert``'s B 64, L 128, no kernel of the port
   launched; printed: ms per step, tokens/s (samples/s), the device idle
   share, peak memory, and each flash kernel's bf16 time at the AMP
   path's shape beside its plain version, its bound at the bf16
   tensor-core rate and sdpa's bf16 forward and backward;
19. recurrent nets and beam-search decoding: the PaddlePaddle book's
   chapter 06 sentiment LSTM (``stacked_lstm_net``: embedding 128 over a
   dictionary of 5147, 3 stacked LSTMs of 512 over each review's
   length, 2 classes) and chapter 08 translation model (dictionaries of
   30,000, word and hidden 512, a bidirectional GRU encoder, a GRU cell
   decoder over a dot-product context, beam 4), eager Adam, fp32, TF32
   off; no kernel of the port is on this path and the phase checks
   that none of the six launched: (a) both at full width, batch and
   length cut (the LSTM at B 16, T 32, lengths 8-32; the GRU at B 8,
   sentences of 12), card against CPU from one set of weights: 2 Adam
   steps, losses within 1e-5 relative and every parameter within 1e-4
   of its tensor's largest magnitude, an entry past that only within 2
   x the summed Adam step sizes (phase 11's rule: a sign step on a
   near-zero gradient), counted; then a 12-step beam search card
   against CPU, the ids identical except from a step where the CPU's
   gap between the beam-th and the next candidate is under 1e-4 (that
   step printed); (b) on the card at the chapters' sizes (the LSTM at B
   128, T 256, lengths from 64; the GRU at B 64, T 50), 1 warm-up, 5
   timed and 1 profiled step each, and the beam decode over 16
   sentences of 50 (50 steps at most): ms a step, samples/s or target
   tokens/s, sentences/s, the idle share from a CUDA-activity-only
   profile, kernels a step and peak memory;
20. the rest of the PaddlePaddle book (v2.1's chapters: fit_a_line, 13
   features, batch 20, static, SGD; recognize_digits' conv-pool net, 20
   and 50 filters of 5x5, batch 64; word2vec as skip-gram with NCE, a
   dictionary of 2,074, embedding 32, 10 negatives, batch 100;
   semantic roles, a dictionary of 44,068, 67 labels, embedding 32, a
   hidden fc of 512, the linear-chain CRF, batch 10, sentences of 5-40;
   the recommender, 6,041 users and 3,953 movies, embeddings 32, towers'
   fc 200, cos_sim x 5, batch 256; the StaticRNN encoder-decoder,
   dictionary 30,000, width 512, B 64, T 50, static; vgg16_bn_drop on
   3x32x32, 10 classes, batch 128, static with dropout on), fp32, TF32
   off; no kernel of the port is on this path and the phase checks that
   none of the six launched: (a) each at its width, batch and length
   cut, dropout 0, card against CPU from one set of weights (a static
   chapter's startup scope carried from the CPU): 2 steps, losses within
   1e-5 relative, step-1 gradients and the parameters by phase 19's
   rule; the two conv chapters with cuDNN off on the card (cuDNN's
   Winograd weight gradients part from the CPU by 2.8e-4 of the largest
   by themselves), and recognize_digits with cuDNN on as well, its
   step-1 gradients within 2e-3 of each largest (vgg16_bn_drop's,
   chaotic, printed); image classification (Momentum
   for its held steps) as phase 10 holds ResNet-50, each step from one
   state, BN running stats within 1e-4, gradients within 0.1 as one
   norm and step 1 op by op within 1e-4, the ReLU and max-pool flips
   end to end counted; word2vec's negatives drawn alike on both; the
   CRF's decoded paths identical except at a position where the CPU's
   gap between the best and the second-best path through it is under
   1e-4 (printed); image classification's ``clone(for_test=True)``: no
   grad or update op, its output card vs CPU within 1e-4 of its largest
   from one state, no persistable changed by running it; (b) each alone
   on the card at its
   sizes, 1 warm-up, 5 timed and 1 profiled step: ms a step, samples/s,
   the idle share from a CUDA-activity-only profile, kernels a step and
   peak memory;
then the result line.

Each phase prints its wall seconds.

It imports neither jax nor paddle_tpu.  It needs one CUDA card, and
fails without one.
"""
import contextlib
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 2e-5       # fp32 with f32 accumulation; summation order differs
LOGIT_TOL = 1e-3        # first-token logits, card vs CPU
NEAR_TIE = 1e-4         # CPU top-2 logit gap under which greedy may differ
# int8 pools, card vs CPU: K/V that differ in their last bits (fp32 sums
# in other orders) can fall on the two sides of a rounding boundary and
# quantize one step (1/127 of the page's abs-max) apart, so int8 logits
# move about 2000x more than float32 ones between the devices (phases 4
# and 6 on an NVIDIA H100 80GB HBM3 at 700 W: float32 first-token logits
# within 4.1e-6, int8 up to 7.6e-3); the bound keeps 4x room over that,
# far below what a dropped or misapplied scale does (a factor of 127 on
# every K/V value)
INT8_LOGIT_TOL = 3e-2
INT8_NEAR_TIE = 2 * INT8_LOGIT_TOL  # each of the top two may move that far
# the int8 ring against float32 collectives (phase 15, int8 pools, tp 4):
# the least position-wise greedy agreement.  Each divergence may fall only
# at a near tie, but a stream is not held after its first divergence, so
# the floor holds the rest: a ring wired wrong (a lost scale, a shard
# summed twice) turns whole streams to other tokens.  It sits below every
# reading of the JAX package's own ring against its float32 collectives
# at this width on the CPU, 0.496-0.793 at 2, 4 and 6 layers over four
# seeds of this traffic (tests/torch_tp_ring_agreement.py), since on
# random weights the top two logits are close and a ring's rounding
# flips them: the port read 0.609-0.805 there and 0.833 on an NVIDIA
# H100 80GB HBM3 at 700 W at 12 layers.  The rounding itself is held
# element by element (phase_tp_ring).
RING_AGREEMENT_FLOOR = 0.45
# the ring on the card against the same ring on the CPU, where not bitwise
# (the CPU tests' bound against the JAX ring)
RING_ULPS = 4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published peaks
FP32_FLOPS_PER_S = 67e12       # CUDA-core FMAs
# fp32-accurate products on the tensor cores: 3xTF32 takes three TF32
# MMAs per product, so a third of the dense TF32 rate
TF32X3_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12      # tensor cores, dense
FLASH_TOL = 2e-5        # flash out and lse, fp32
FLASH_GRAD_TOL = 1e-4   # dq, dk, dv, fp32: sums of up to Lq products
FLASH_BF16_TOL = 2e-2   # bf16 outputs, p rounded against another max

# GPT-2-small widths in the architecture the engine serves
MODEL = dict(vocab_size=50304, num_layers=12, num_heads=12, head_dim=64,
             mlp_ratio=4, max_positions=1024, seed=0)
ENGINE = dict(max_decode_slots=8, num_pages=512, page_size=16)
N_REQUESTS, MAX_NEW, STOCHASTIC = 8, 32, (2, 5)
# the legacy step's configuration, and the short one-shot run's
LEGACY = dict(step_mode="legacy", decode="fused", prefill_chunk_tokens=64)
INT8 = dict(kv_dtype="int8")
ONE_SHOT = dict(step_mode="legacy", decode="eager", prefill_chunk_tokens=0)
ONE_SHOT_PROMPTS, ONE_SHOT_NEW = (0, 2, 5, 7), 8
# speculation (ngram drafts of up to SPEC_K tokens) and the host-free
# decode loop's N; phase 7's loop engines capture these pages buckets
# before their measured runs.  N=8 (the same captured loop at twice the
# iterations, more page crossings inside one replay) runs only on
# float32 pools with speculation on (LONG_LOOP_RUNS: (dtype, spec)), held
# but not profiled, and the other runs' profiles are left out, to keep
# the whole script inside its time limit
SPEC_K = 4
SPEC = dict(spec_mode="ngram", spec_tokens=SPEC_K)
LOOP_NS = (4, 8)
LONG_LOOP_RUNS = (("float32", True),)
# phase 7's float32 runs profiled for (f): (spec, N)
SERVING_PROFILED = ((False, 1), (True, 4))
LOOP_PREWARM = (16, 32, 64)
# prefix caching (phase 12): a system prompt of 32 full pages shared by 7
# requests; chunks of 64 on every path but the one-shot; the seeded
# stochastic requests; the counters a run reads, set to 0 before it
PREFIX_SYSTEM, PREFIX_SHARED = 512, 7
PREFIX_ENGINE = dict(prefill_chunk_tokens=64)
# the card-vs-CPU runs' depth (phases 4, 6 (b), 7 (a) and 12): the same
# widths, weights and traffic on the card and on the CPU, cut to 2 layers,
# since a CPU run of the traffic at full depth takes minutes on a
# contended host (phases 4 and 6 at 12 layers: 116 and 124 s on the CPU
# of an NVIDIA H100 80GB HBM3 host)
HELD_LAYERS = 2
PREFIX_STOCHASTIC = (1, 3, 5, 7, 10)
PREFIX_COUNTERS = ("prefix_cache_hit_tokens", "prefix_pages_registered",
                   "cow_copies", "prefix_evictions", "prefill_tokens_total",
                   "preempted_total")
# the serving fleet (phase 13): phase 12's replica (pool, chunks, the
# prefix cache on) and traffic cut to the 7 shared requests and the two
# conversation turns; the seeded stochastic requests (6 of 9 greedy); the
# loop replicas' N
FLEET_STOCHASTIC = (1, 3, 5)
FLEET_LOOP = 4
# tensor parallel (phase 15): the degrees run with every shard on one card,
# and the degree of the legacy, int8, quantized-collective and spec + loop
# runs; the loop's N there
TP_DEGREES = (2, 4)
TP_MAIN = 4
SPEC_LOOP = 4
# the steps of the traffic whose idle share phase 15 traces: after 8, the
# next 24 (prefill and decode mixed)
TP_IDLE_STEPS = (8, 24)
# the device sampler against the host sampler over [8, vocab] logits:
# rows sampled, and the most that may differ (a draw within ULPs of a
# CDF boundary, where the reductions' order decides)
SAMPLER_DRAWS, SAMPLER_MAX_DIFF = 125, 1
# generation.* counters one measured run reads: the stat registry is the
# process's, so each run sets them to 0 after its warm-up
RUN_COUNTERS = ("tokens_total", "steps_total", "spec_proposed_tokens",
                "spec_accepted_tokens", "spec_rewind_tokens",
                "spec_draft_rows", "prefix_cache_hit_tokens", "cow_copies")
# the kernels' main-path case: the engine's widths, pool and pages bucket
MAIN = dict(h=12, d=64, ps=16, num_pages=512, pages_bucket=64)
# the trainer: bench.py's bench_gpt_zero configuration on the accelerator
TRAIN_MODEL = dict(vocab_size=50257, hidden_size=768, num_layers=12,
                   num_heads=12, max_seq_len=512, attn_dropout=0.0,
                   use_flash=True)
TRAIN = dict(lr=1e-4, batch=8, seq=512, warmup=3, iters=10, profiled=3,
             dropout=0.1, held_batch=2, held_steps=2)
TRAIN_LOSS_TOL = 1e-4   # card vs CPU losses, relative (bf16 amp on both)
# phase 16: bench_gpt_zero's step over {"data": 4} at ZeRO 0-3 (B 8 a
# shard) and the pipeline over {"pipe": 2, "data": 2} (4 micro-batches of
# 2 rows), every shard on card 0; 2 warm-up, 3 timed and 1 profiled step
# a run; the held check at HELD_LAYERS, B 2 a shard (the pipeline's 2
# micro-batches of 1 row)
DP = dict(dp=4, stages=(0, 1, 2, 3), warmup=2, iters=3, profiled=1, pipe=2,
          pipe_dp=2, micro=4, held_batch=2, held_micro=2)
# ZeRO 1-3 against ZeRO 0 after the held steps: tests/
# test_torch_train_step.py's fp32 Adam rule (all but 1 in 10^4 entries
# within 1e-5, every entry within 2 x steps x lr)
DP_PARAM_TOL, DP_PARAM_SHARE = 1e-5, 1e-4
# phase 17: the model, seq and expert axes, every shard on card 0.  Held
# at dropout 0, full width, HELD_LAYERS layers, fp32, B 2 a data shard of
# L 128, 2 steps, card vs CPU (the MoE with 4 experts); timed at
# bench_gpt_zero's step (12 layers, B 8 over data 2, L 512, bf16 amp,
# dropout 0.1; the MoE with 8 experts), 2 warm-up, 3 timed and 1
# profiled step a run
HYBRID = dict(held_batch=2, held_seq=128, held_experts=4, experts=8,
              micro=2)
HYBRID_DMS = {"data": 2, "model": 2, "seq": 2}
HYBRID_DME = {"data": 2, "model": 2, "expert": 2}
HYBRID_PM = {"pipe": 2, "model": 2}
TRAIN_GNORM_TOL = 1e-3  # card vs CPU step-1 gradient norm, relative
# encoder pretraining: bench.py's bench_bert configuration (BERT-base,
# AdamW lr 1e-4 constant, bf16 amp, dropout 0.1, B 64, L 128, 3 warm-up
# and 10 timed steps); the held check at dropout 0, B 2, under a
# LinearWarmup over PolynomialDecay schedule
ENCODER = dict(lr=1e-4, batch=64, seq=128, warmup=3, iters=10, profiled=3,
               dropout=0.1, held_batch=2, held_steps=3)
ERNIE_MODEL = dict(vocab_size=18000, use_task_id=True)
# ResNet-50 through the static Program/Executor: bench.py's bench_resnet
# (B 64, 224x224, 1000 classes, Momentum(0.1, 0.9), static bf16 AMP,
# chains of 20 steps: one warm-up and 3 timed, then 3 stepped runs); the
# held check at B 2, three steps card vs CPU, fp32 and AMP
RESNET = dict(batch=64, chain=20, timed=3, stepped=3, held_batch=2,
              held_steps=3)
# fp32 card vs CPU, each step from one state: the loss relative, and the
# BN running stats after it within this share of each tensor's largest
# magnitude; op by op (each op on the card from the CPU run's values of
# its inputs), every float32 output within this share too
RESNET_TOL = 1e-4
# op by op, every bfloat16 output of the AMP program: 2.5 bf16 ulps of the
# tensor's largest magnitude
RESNET_BF16_TOL = 1e-2
# the step's gradients end to end, ||card - CPU|| / ||CPU|| over all of
# them: batch norm over 2 rows per channel turns last-bit differences into
# ReLUs on the other side of 0, so the same step summed in another order
# moves them (step 1 on an NVIDIA H100 80GB HBM3 host: the CPU on 1 thread
# against 8 by 5.8e-3, the card against the CPU by 3.1e-2); each op's
# arithmetic is held by the op-by-op check
RESNET_GRAD_TOL = 1e-1
RESNET_AMP_TOL = 1e-2   # AMP step-1 loss, relative: two bf16 roundings
ERNIE_MASK_ID = 3       # the masked spans' id in apply_knowledge_mask
# Dygraph vision: bench.py's bench_lenet (LeNet, B 128, 1x28x28, 10
# classes, Adam 1e-3, 3 warm-up steps, then 10 steps synced once and 10
# each synced); the held check runs it 3 steps card vs CPU; dygraph
# ResNet-50 held at B 2 and timed at B 64 (fp32, Momentum(0.1, 0.9))
LENET = dict(batch=128, lr=1e-3, warmup=3, iters=10, held_steps=3,
             profiled=10)
DYGRAPH_RESNET = dict(held_batch=2, batch=64, lr=0.1, momentum=0.9,
                      warmup=2, iters=5)
# LeNet card vs CPU: fp32 with TF32 off, only summation order differs
VISION_TOL = 1e-4
# the flash kernels' main-path case: the trainer's attention
FLASH_MAIN = dict(bh=96, heads=12, lq=512, lk=512, d=64, causal=True)

# the paged kernels' rows: each kernel's float (float32 and bfloat16) and
# int8 instantiations, counted apart by the wrapper's launches_by_dtype
FLOAT_KV, INT8_KV = ("float32", "bfloat16"), ("int8",)
KERNELS = [
    dict(name=name + tag, lib=name, wrapper=name + "_kernel",
         replaces=f"paddle_tpu/ops/pallas/paged_attention.py:{line}",
         dtypes=dtypes)
    for tag, dtypes in (("", FLOAT_KV), ("_int8", INT8_KV))
    for name, line in (("ragged_paged_attention", 428),
                       ("paged_decode_attention", 629),
                       ("chunk_prefill_attention", 546))]
FLASH_KERNELS = [
    dict(name="flash_attention_fwd", lib="flash_attention",
         wrapper="flash_attention_fwd_kernel",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:144"),
    dict(name="flash_attention_bwd_dkdv", lib="flash_attention",
         wrapper="flash_attention_bwd_dkdv_kernel",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:192"),
    dict(name="flash_attention_bwd_dq", lib="flash_attention",
         wrapper="flash_attention_bwd_dq_kernel",
         replaces="paddle_tpu/ops/pallas/flash_attention.py:238"),
]


def wrappers():
    """Every kernel row's wrapper and the pool dtypes it counts (None:
    all of the wrapper's launches)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    return {**{k["name"]: (getattr(pa, k["wrapper"]), k["dtypes"])
               for k in KERNELS},
            **{k["name"]: (getattr(fa, k["wrapper"]), None)
               for k in FLASH_KERNELS}}


def reset_launches():
    for w, _ in wrappers().values():
        w.launches = 0
        w.launches_by_dtype = dict.fromkeys(w.launches_by_dtype, 0)


def read_launches():
    return {name: (w.launches if dtypes is None
                   else sum(w.launches_by_dtype[d] for d in dtypes))
            for name, (w, dtypes) in wrappers().items()}


def log(*args):
    print(*args, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------- kernel cases --------------------------------


def misalign(x):
    """`x`'s values in a contiguous tensor that starts one element past
    an aligned address, so the kernel cannot take its 4-wide loads."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def _pools(rng, h, d, ps, num_pages, layout, kv_dtype, misaligned, device):
    """A random K and V pool pair (sink page included) and, for int8 pools
    (random codes), their scales as ``{"k_scale", "v_scale"}`` [pages, H]:
    every third page's are 0, a freshly handed-out page's."""
    shape = ((h, num_pages + 1, ps, d) if layout == "kernel"
             else (num_pages + 1, ps, h, d))
    out = []
    for _ in range(2):
        if kv_dtype == torch.int8:
            p = torch.as_tensor(rng.integers(-127, 128, shape),
                                dtype=torch.int8, device=device)
        else:
            p = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device=device
                                ).to(kv_dtype)
        out.append(misalign(p) if misaligned else p)
    scales = {}
    if kv_dtype == torch.int8:
        for key in ("k_scale", "v_scale"):
            sc = rng.uniform(0.5, 4.0, (num_pages + 1, h))
            sc[::3] = 0.0
            scales[key] = torch.as_tensor(sc, dtype=torch.float32,
                                          device=device)
    return out, scales


def make_case(rng, *, h, d, ps, num_pages, desc, layout="token",
              kv_dtype=torch.float32, pages_bucket=None, n_padding=0,
              unowned=True, misaligned=False, stride=None, device="cuda"):
    """Packed query rows for descriptors `desc` ([(len, kv_len)]) — with
    `unowned`, a one-row gap after the first descriptor and two more
    rows at the end that no descriptor owns — pages drawn at random from
    a random pool (sink page included), and `n_padding` len-0
    descriptors whose tables and kv_lens are garbage.  `misaligned`
    pools start one element past an aligned address.  With `stride`,
    descriptor i owns rows from ``i * stride`` on (the decode loop's
    fixed axis of ``len(desc) * stride`` rows) and `unowned` is unused."""
    lens = [ln for ln, _ in desc]
    kvs = [kv for _, kv in desc]
    starts, row = [], 0
    for i, ln in enumerate(lens):
        starts.append(row)
        row += ln + (1 if i == 0 and unowned else 0)
    t = row + (2 if unowned else 0)
    if stride is not None:
        starts = [i * stride for i in range(len(lens))]
        t = len(lens) * stride
    need = [math.ceil(kv / ps) for kv in kvs]
    mp = pages_bucket or max(need)
    perm = rng.permutation(num_pages)
    pt = np.zeros((len(desc) + n_padding, mp), np.int32)
    used = 0
    for i, n in enumerate(need):
        pt[i, :n] = perm[used:used + n]
        used += n
    pt[len(desc):] = rng.integers(0, num_pages, (n_padding, mp))
    starts += list(rng.integers(0, t, n_padding))
    lens += [0] * n_padding
    kvs += list(rng.integers(1, mp * ps, n_padding))
    (k_pool, v_pool), scales = _pools(rng, h, d, ps, num_pages, layout,
                                      kv_dtype, misaligned, device)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), device=device, dtype=dtype)

    return dict(
        q=dev(rng.standard_normal((t, h, d)), torch.float32),
        k_pool=k_pool, v_pool=v_pool,
        page_tables=dev(pt, torch.int32),
        starts=dev(starts, torch.int32), lens=dev(lens, torch.int32),
        kv_lens=dev(kvs, torch.int32), layout=layout, scales=scales)


def main_path_desc(rng):
    """The engine's step at its widest: 8 decode rows over contexts of
    the traffic's spread and one 64-row chunk finishing a 600-token
    prompt (T = 72 packed rows, S = 9)."""
    decode = [(1, int(kv)) for kv in rng.integers(16, 633, 8)]
    return decode + [(64, 600)]


def kernel_cases(rng):
    small = dict(num_pages=40)
    mixed = main_path_desc(rng)
    cases = [
        ("d8_ps4_token", dict(h=2, d=8, ps=4, desc=[(1, 13), (1, 6),
                                                   (5, 12)], n_padding=1,
                              **small)),
        ("d8_ps4_kernel", dict(h=2, d=8, ps=4, desc=[(1, 13), (1, 6),
                                                    (5, 12)],
                               layout="kernel", **small)),
        ("d128_ps64", dict(h=2, d=128, ps=64, desc=[(1, 200), (9, 130),
                                                    (1, 1)], **small)),
        ("d100_ps5_odd", dict(h=3, d=100, ps=5, desc=[(3, 17), (1, 5),
                                                      (16, 40)], **small)),
        ("chunk_from_0", dict(h=2, d=64, ps=16, desc=[(20, 20)], **small)),
        # D % 4 != 0 and misaligned pools: the kernel's scalar page loads
        ("d6_ps4_token", dict(h=2, d=6, ps=4, desc=[(1, 13), (1, 6),
                                                   (5, 12)], n_padding=1,
                              **small)),
        ("d6_ps4_kernel_bf16", dict(h=2, d=6, ps=4, desc=[(1, 13), (5, 12)],
                                    layout="kernel",
                                    kv_dtype=torch.bfloat16, **small)),
        ("d30_ps16_token_bf16", dict(h=3, d=30, ps=16,
                                     desc=[(1, 40), (9, 30), (16, 16)],
                                     kv_dtype=torch.bfloat16, **small)),
        ("d30_ps16_kernel", dict(h=3, d=30, ps=16,
                                 desc=[(1, 40), (9, 30), (16, 16)],
                                 layout="kernel", **small)),
        ("misaligned_token", dict(h=2, d=64, ps=16, desc=[(1, 50), (12, 33)],
                                  misaligned=True, **small)),
        ("misaligned_kernel_bf16", dict(h=2, d=64, ps=16,
                                        desc=[(1, 50), (12, 33)],
                                        layout="kernel", misaligned=True,
                                        kv_dtype=torch.bfloat16, **small)),
        ("main_mixed_token", dict(desc=mixed, **MAIN)),
        ("main_mixed_kernel", dict(desc=mixed, layout="kernel", **MAIN)),
        ("main_decode_only", dict(desc=mixed[:8], **MAIN)),
        ("main_chunk_only", dict(desc=mixed[8:], **MAIN)),
        ("main_padding_desc", dict(desc=mixed, n_padding=3, **MAIN)),
        ("main_bf16_token", dict(desc=mixed, kv_dtype=torch.bfloat16,
                                 **MAIN)),
        ("main_bf16_kernel", dict(desc=mixed, kv_dtype=torch.bfloat16,
                                  layout="kernel", **MAIN)),
        # the ragged kernel's split of a walk across blocks: a long decode
        # row (65 splits of 4 pages), many decode rows, and a chunk at
        # positions 100..163 whose 16-row tiles straddle key 128
        ("long_decode_4100", dict(desc=[(1, 4100)],
                                  **{**MAIN, "num_pages": 300,
                                     "pages_bucket": 272})),
        ("decode_32_rows", dict(desc=[(1, int(kv)) for kv in
                                      rng.integers(16, 633, 32)],
                                **{**MAIN, "num_pages": 1400})),
        ("chunk_64_straddling", dict(desc=[(64, 164), (1, 70)], **MAIN)),
        # speculation's verify rows (8 descriptors of 1 + 4 rows over
        # 16..632 keys), and the decode loop's fixed axis of 8 x (1 + 4)
        # rows: descriptor s owns rows from 5 s, some verifying drafts,
        # some plain decode rows, some dead (len 0) at the loop's tail
        ("spec_verify_8x5", dict(desc=spec_desc(rng), unowned=False,
                                 **MAIN)),
        ("loop_axis_8x5", dict(desc=loop_desc(rng), stride=1 + SPEC_K,
                               **MAIN)),
    ]
    return cases + int8_variants(cases, [
        "d8_ps4_token", "d8_ps4_kernel", "d128_ps64", "d100_ps5_odd",
        "d6_ps4_token", "d30_ps16_kernel", "misaligned_token",
        "misaligned_kernel_bf16", "main_mixed_token", "main_mixed_kernel",
        "main_padding_desc", "long_decode_4100", "decode_32_rows",
        "chunk_64_straddling", "spec_verify_8x5", "loop_axis_8x5"])


def spec_desc(rng):
    """8 verify descriptors of 1 + SPEC_K rows over 16..632 keys."""
    return [(1 + SPEC_K, int(kv)) for kv in rng.integers(16, 633, 8)]


def loop_desc(rng):
    """The loop's 8 descriptors at one iteration: three verifying drafts
    (1 + SPEC_K rows), three plain decode rows, two dead ones."""
    kvs = [int(kv) for kv in rng.integers(16, 633, 8)]
    return ([(1 + SPEC_K, kv) for kv in kvs[:3]]
            + [(1, kv) for kv in kvs[3:6]] + [(0, 0), (0, 0)])


def int8_variants(cases, names):
    """int8 copies of the named cases: the same shapes, layout and
    alignment over int8 pools with their scales."""
    by_name = dict(cases)
    return [(f"{n.replace('_bf16', '')}_int8",
             dict(by_name[n], kv_dtype=torch.int8)) for n in names]


def attn_args(case):
    return [case[k] for k in ("q", "k_pool", "v_pool", "page_tables",
                              "starts", "lens", "kv_lens")]


# ---------------------- decode and chunk cases --------------------------


def make_decode_case(rng, *, h, d, ps, lens, num_pages, layout="token",
                     kv_dtype=torch.float32, pages_bucket=None,
                     misaligned=False, device="cuda"):
    """One query row per sequence of `lens` (0: a dummy row) over pages
    drawn at random; the table axis is padded with page 0 past the
    longest sequence (to `pages_bucket`, else by one column)."""
    need = [math.ceil(n / ps) for n in lens]
    mp = pages_bucket or max(need) + 1
    perm = rng.permutation(num_pages)
    pt = np.zeros((len(lens), mp), np.int32)
    used = 0
    for i, n in enumerate(need):
        pt[i, :n] = perm[used:used + n]
        used += n
    (k_pool, v_pool), scales = _pools(rng, h, d, ps, num_pages, layout,
                                      kv_dtype, misaligned, device)
    return dict(q=torch.as_tensor(rng.standard_normal((len(lens), h, d)),
                                  dtype=torch.float32, device=device),
                k_pool=k_pool, v_pool=v_pool,
                page_tables=torch.as_tensor(pt, device=device),
                seq_lens=torch.as_tensor(np.asarray(lens, np.int32),
                                         device=device), layout=layout,
                scales=scales)


def make_chunk_case(rng, *, h, d, ps, start, n, num_pages, length=None,
                    layout="token", kv_dtype=torch.float32,
                    pages_bucket=None, misaligned=False, device="cuda"):
    """One sequence's n chunk rows at positions start.. over the pages
    its start + length tokens hold; rows past `length` are padding whose
    positions reach into the table's page-0 padding."""
    length = n if length is None else length
    pages = math.ceil((start + length) / ps)
    mp = pages_bucket or (start + n - 1) // ps + 2
    pt = np.zeros((mp,), np.int32)
    pt[:pages] = rng.permutation(num_pages)[:pages]
    (k_pool, v_pool), scales = _pools(rng, h, d, ps, num_pages, layout,
                                      kv_dtype, misaligned, device)
    return dict(q=torch.as_tensor(rng.standard_normal((n, h, d)),
                                  dtype=torch.float32, device=device),
                k_pool=k_pool, v_pool=v_pool,
                page_table=torch.as_tensor(pt, device=device), start=start,
                layout=layout, scales=scales)


def main_decode_lens(rng):
    """The legacy step's widest decode: 8 rows over contexts of the
    traffic's spread (16..632 keys)."""
    return [int(kv) for kv in rng.integers(16, 633, 8)]



def decode_cases(rng):
    small = dict(num_pages=60)
    main_lens = main_decode_lens(rng)
    cases = [
        ("d8_ps4_token", dict(h=2, d=8, ps=4, lens=[0, 4, 13, 6, 1],
                              **small)),
        ("d8_ps4_kernel", dict(h=2, d=8, ps=4, lens=[0, 4, 13, 6, 1],
                               layout="kernel", **small)),
        ("d128_ps64", dict(h=2, d=128, ps=64, lens=[200, 64, 0, 1],
                           **small)),
        ("d100_ps5", dict(h=3, d=100, ps=5, lens=[17, 5, 0, 40], **small)),
        ("d6_ps4_token", dict(h=2, d=6, ps=4, lens=[13, 0, 4], **small)),
        ("d6_ps4_kernel_bf16", dict(h=2, d=6, ps=4, lens=[13, 0, 4],
                                    layout="kernel",
                                    kv_dtype=torch.bfloat16, **small)),
        ("d30_ps16_token_bf16", dict(h=3, d=30, ps=16, lens=[40, 16, 0],
                                     kv_dtype=torch.bfloat16, **small)),
        ("d30_ps16_kernel", dict(h=3, d=30, ps=16, lens=[40, 16, 0],
                                 layout="kernel", **small)),
        ("misaligned_token", dict(h=2, d=64, ps=16, lens=[50, 0, 33],
                                  misaligned=True, **small)),
        ("misaligned_kernel_bf16", dict(h=2, d=64, ps=16, lens=[50, 0, 33],
                                        layout="kernel", misaligned=True,
                                        kv_dtype=torch.bfloat16, **small)),
        ("main_decode_token", dict(lens=main_lens, **MAIN)),
        ("main_decode_kernel", dict(lens=main_lens, layout="kernel",
                                    **MAIN)),
        ("main_decode_bf16", dict(lens=main_lens, kv_dtype=torch.bfloat16,
                                  **MAIN)),
        ("main_decode_dummy_rows", dict(lens=main_lens[:5] + [0, 0, 0],
                                        **MAIN)),
        # the split walk: one row over 4,100 keys (65 splits of 4 pages)
        ("long_decode_4100", dict(lens=[4100, 0],
                                  **{**MAIN, "num_pages": 300,
                                     "pages_bucket": 272})),
    ]
    return cases + int8_variants(cases, [
        "d8_ps4_token", "d8_ps4_kernel", "d128_ps64", "d100_ps5",
        "d6_ps4_token", "d30_ps16_kernel", "misaligned_token",
        "misaligned_kernel_bf16", "main_decode_token", "main_decode_kernel",
        "main_decode_dummy_rows", "long_decode_4100"])


def chunk_cases():
    small = dict(num_pages=60)
    cases = [
        ("d8_ps4_start0", dict(h=2, d=8, ps=4, start=0, n=8, **small)),
        ("d8_ps4_kernel_mid_page", dict(h=2, d=8, ps=4, start=5, n=6,
                                        layout="kernel", **small)),
        ("d128_ps64_padding", dict(h=2, d=128, ps=64, start=70, n=16,
                                   length=9, **small)),
        ("d100_ps5", dict(h=3, d=100, ps=5, start=12, n=13, **small)),
        ("d6_ps4_token_padding", dict(h=2, d=6, ps=4, start=3, n=9,
                                      length=7, **small)),
        ("d6_ps4_kernel_bf16", dict(h=2, d=6, ps=4, start=3, n=9,
                                    layout="kernel",
                                    kv_dtype=torch.bfloat16, **small)),
        ("d30_ps16_token_bf16", dict(h=3, d=30, ps=16, start=20, n=20,
                                     kv_dtype=torch.bfloat16, **small)),
        ("d30_ps16_kernel", dict(h=3, d=30, ps=16, start=20, n=20,
                                 layout="kernel", **small)),
        ("misaligned_token", dict(h=2, d=64, ps=16, start=21, n=12,
                                  misaligned=True, **small)),
        ("misaligned_kernel_bf16", dict(h=2, d=64, ps=16, start=21, n=12,
                                        layout="kernel", misaligned=True,
                                        kv_dtype=torch.bfloat16, **small)),
        ("main_chunk_token", dict(start=536, n=64, **MAIN)),
        ("main_chunk_kernel", dict(start=536, n=64, layout="kernel",
                                   **MAIN)),
        ("main_chunk_bf16", dict(start=536, n=64, kv_dtype=torch.bfloat16,
                                 **MAIN)),
        ("main_chunk_last_padded", dict(start=576, n=64, length=24,
                                        **MAIN)),
        # the split walk: 64 rows at 100..163, whose 16-row tiles straddle
        # key 128, and 17 rows ending in a one-row tile
        ("chunk_64_straddling", dict(start=100, n=64, **MAIN)),
        ("chunk_17_one_row_tile", dict(start=47, n=17, **MAIN)),
    ]
    return cases + int8_variants(cases, [
        "d8_ps4_start0", "d8_ps4_kernel_mid_page", "d128_ps64_padding",
        "d100_ps5", "d6_ps4_token_padding", "d30_ps16_kernel",
        "misaligned_token", "misaligned_kernel_bf16", "main_chunk_token",
        "main_chunk_kernel", "main_chunk_last_padded",
        "chunk_64_straddling"])


def decode_args(case):
    return [case[k] for k in ("q", "k_pool", "v_pool", "page_tables",
                              "seq_lens")]


def chunk_args(case):
    return [case[k] for k in ("q", "k_pool", "v_pool", "page_table",
                              "start")]


def check_cases(name, cases, make, args_of, kernel, plain, extra=None):
    """Each case through `kernel` and `plain` on CUDA tensors; fails past
    KERNEL_TOL.  Returns the worst max |diff| over the float pools and
    over the int8 pools, as ``{"": float, "_int8": int8}``."""
    worst = {"": 0.0, "_int8": 0.0}
    for case_name, spec in cases:
        case = make(**spec)
        ker = kernel(*args_of(case), layout=case["layout"], **case["scales"])
        ref = plain(*args_of(case), layout=case["layout"], **case["scales"])
        torch.cuda.synchronize()
        err = float((ker - ref).abs().max())
        note = extra(case, ker) if extra else ""
        log(f"  {name} vs plain  {case_name:29s} "
            f"rows={case['q'].shape[0]:3d} max|diff|={err:.3e}{note}")
        if not math.isfinite(err) or err > KERNEL_TOL:
            fail(f"{name} kernel disagrees with its plain version on "
                 f"{case_name}: {err:.3e} > {KERNEL_TOL}")
        tag = "_int8" if case["scales"] else ""
        worst[tag] = max(worst[tag], err)
    return worst


def phase_kernels(pa, rng):
    """Every kernel against its plain version over its cases; returns the
    worst max |diff| of each."""
    def repeat(name, kernel, args_of):
        """The split merge runs in a fixed order: a second launch on the
        same inputs gives the same bits."""
        def check(case, ker):
            again = kernel(*args_of(case), layout=case["layout"],
                           **case["scales"])
            if not torch.equal(again, ker):
                fail(f"two {name} launches on the same inputs differ")
            return " repeat bitwise=True"
        return check

    ragged_again = repeat("ragged", pa.ragged_paged_attention_kernel,
                          attn_args)
    decode_again = repeat("decode", pa.paged_decode_attention_kernel,
                          decode_args)

    def unowned_zero(case, ker):
        owned = torch.zeros(case["q"].shape[0], dtype=torch.bool,
                            device=case["q"].device)
        for st, ln in zip(case["starts"].tolist(), case["lens"].tolist()):
            owned[st:st + ln] = True
        if not bool((ker[~owned] == 0).all()):
            fail("ragged kernel wrote rows no descriptor owns")
        return (f" S={case['lens'].numel():2d} unowned rows zero=True"
                + ragged_again(case, ker))

    def zero_rows(case, ker):
        note = decode_again(case, ker)
        dummy = case["seq_lens"] == 0
        if not bool(dummy.any()):
            return note
        if not bool((ker[dummy] == 0).all()):
            fail("paged decode kernel wrote non-zeros for a length-0 row")
        return " len-0 rows zero=True" + note

    ragged = check_cases(
        "ragged", kernel_cases(rng), lambda **spec: make_case(rng, **spec),
        attn_args, pa.ragged_paged_attention_kernel,
        pa.ragged_paged_attention_torch, unowned_zero)
    dec = check_cases(
        "decode", decode_cases(rng),
        lambda **spec: make_decode_case(rng, **spec), decode_args,
        pa.paged_decode_attention_kernel, pa.paged_decode_attention_torch,
        zero_rows)
    chunk = check_cases(
        "chunk ", chunk_cases(),
        lambda **spec: make_chunk_case(rng, **spec), chunk_args,
        pa.chunk_prefill_attention_kernel, pa.chunk_prefill_attention_torch,
        repeat("chunk", pa.chunk_prefill_attention_kernel, chunk_args))
    # an int8 pool without its scales must raise, never decode raw codes
    case = make_decode_case(rng, h=2, d=8, ps=4, lens=[5, 3], num_pages=8,
                            kv_dtype=torch.int8)
    try:
        pa.paged_decode_attention_kernel(*decode_args(case))
    except ValueError as e:
        log(f"  int8 pool without scales refused: {e}")
    else:
        fail("an int8 pool without its scales did not raise")
    worst = {}
    for name, got in (("ragged_paged_attention", ragged),
                      ("paged_decode_attention", dec),
                      ("chunk_prefill_attention", chunk)):
        for tag, err in got.items():
            worst[name + tag] = err
    return worst


def attention_bound(case, seqs, meta_bytes):
    """Least time for the work these inputs need: q read and out written
    once, K and V of each key a live sequence sees (each key once, at the
    pool's element size: 1 byte for int8), the page-table entries it
    walks, an int8 pool's K and V scale of each page it walks and head,
    and `meta_bytes` of other inputs; fp32 FMAs of every visible (row,
    key) pair, QK and PV, on every head.  `seqs` holds (rows, keys) of
    each live sequence: its last row sees all `keys` keys, row r of
    `rows` sees keys - rows + r + 1."""
    t, h, d = case["q"].shape
    item = case["k_pool"].element_size()
    ps = case["k_pool"].shape[2 if case["layout"] == "kernel" else 1]
    scale_bytes = 2 * 4 * h if case["scales"] else 0   # per page walked
    nbytes, flops = 2 * t * h * d * 4 + meta_bytes, 0
    for rows, keys in seqs:
        pages = math.ceil(keys / ps)
        nbytes += 2 * keys * h * d * item + (4 + scale_bytes) * pages
        flops += 4 * d * h * sum(keys - rows + r + 1 for r in range(rows))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations"), nbytes, flops


def bound_of(case):
    """The ragged kernel: each live descriptor's rows over its kv_len
    keys; starts, lens and kv_lens read once."""
    lens = case["lens"].tolist()
    live = [(ln, kv) for ln, kv in zip(lens, case["kv_lens"].tolist())
            if ln > 0]
    return attention_bound(case, live, 3 * 4 * len(lens))


def decode_bound_of(case):
    """The decode kernel: one row over seq_len keys per live sequence;
    seq_lens read once."""
    lens = case["seq_lens"].tolist()
    return attention_bound(case, [(1, n) for n in lens if n > 0],
                           4 * len(lens))


def chunk_bound_of(case):
    """The chunk kernel: n rows at start.. over start + n keys (`start`
    goes by value)."""
    n = case["q"].shape[0]
    return attention_bound(case, [(n, case["start"] + n)], 0)


def time_ms(fn, iters, queued=True):
    """Device milliseconds per call of `fn`.  `queued`: the timed calls
    queue behind a device-side wait (about 0.1 s at the H100's clock)
    that outlasts the host's launches, so they run back to back and the
    host's launch rate does not set the time; else they run as the host
    issues them (launch-paced)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------- engine runs ---------------------------------


def traffic(rng):
    lengths = np.linspace(16, 600, N_REQUESTS).round().astype(int)
    prompts = [rng.integers(0, MODEL["vocab_size"], n).tolist()
               for n in lengths]
    return prompts


def held_models(pgen):
    """The card-vs-CPU runs' models: MODEL's widths and seed at
    HELD_LAYERS layers, on the card and (the same weights) on the CPU."""
    card = pgen.TinyCausalLM(**{**MODEL, "num_layers": HELD_LAYERS})
    cpu = pgen.TinyCausalLM.from_numpy_params(
        card.decode_params("cpu"), num_heads=MODEL["num_heads"],
        seed=MODEL["seed"], device="cpu")
    return card, cpu


def serve(pgen, model, prompts, device, settings=None, max_new=MAX_NEW,
          stochastic=STOCHASTIC, extras=None):
    """Serve the traffic on one engine; returns the engine, the handles,
    the spies' records and the first measured sequence id.  On the
    ragged step the records are each call's (descriptor seq ids,
    kv_lens, logits) for the logit comparisons (logits None for a decode
    loop's call, which samples on the device); on the legacy step, each
    request's first-token logits and the count of decode and chunk step
    calls.  `extras` maps a request's index to its ``stop_tokens`` and
    ``stop_sequences``.  A loop engine captures its LOOP_PREWARM pages
    buckets here, before the measured run."""
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        device=device, **ENGINE, **(settings or {})), start=False)
    # warm-up request (first cuBLAS calls), outside the measured run
    warm = eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run_until_idle()
    warm.result(timeout=60)
    if eng._loop is not None:
        for pages in LOOP_PREWARM:
            eng._loop.prewarm(pages)
    from paddle_tpu_torch.profiler.monitor import StatRegistry

    for name in RUN_COUNTERS:
        StatRegistry.instance().get_stat("generation." + name).reset()
    first_seq = eng.scheduler._next_seq
    if eng._ragged is not None:
        records = spy_ragged(eng)
    else:
        records = spy_legacy(eng, first_seq)
    handles = submit_traffic(pgen, eng, prompts, max_new, stochastic,
                             extras)
    return eng, handles, records, first_seq


def submit_traffic(pgen, eng, prompts, max_new=MAX_NEW,
                   stochastic=STOCHASTIC, extras=None):
    """Submit the traffic's requests to `eng`; returns their handles."""
    handles = []
    for i, p in enumerate(prompts):
        extra = (extras or {}).get(i, {})
        stop_seqs = extra.get("stop_sequences", ())
        sampling = (pgen.SamplingParams(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=100 + i,
                                        stop_sequences=stop_seqs)
                    if i in stochastic
                    else pgen.SamplingParams(stop_sequences=stop_seqs))
        handles.append(eng.submit(p, max_new_tokens=max_new,
                                  sampling=sampling,
                                  stop_tokens=extra.get("stop_tokens", ())))
    return handles


def spy_ragged(eng):
    records = []
    real_tables = eng.cache.gather_block_tables
    real_step = eng._ragged.step
    vocab = eng.model.vocab_size

    def tables_spy(desc_ids, *a, **kw):
        pt, kv = real_tables(desc_ids, *a, **kw)
        records.append([list(desc_ids), kv.copy(), None])
        return pt, kv

    def step_spy(*args):
        ids, logits = real_step(*args)
        # stays on the device: no sync (a speculative step's second
        # output carries three int columns after the logits)
        records[-1][2] = logits[:, :vocab]
        return ids, logits

    eng.cache.gather_block_tables = tables_spy
    eng._ragged.step = step_spy
    if eng._loop is not None:
        real_loop = eng._loop.step
        iters = eng._loop.iters_seen = []

        def loop_spy(*args):
            out = real_loop(*args)
            iters.append(eng._loop.last_iters)
            return out

        eng._loop.step = loop_spy
    return records


def spy_legacy(eng, first_seq):
    """Count the legacy step's decode and chunk calls, and keep each
    request's first-token logits: the host rows the engine samples its
    first token from (the final chunk's, or its one-shot prefill row),
    so the spies add no device sync."""
    rec = {"first": {}, "decode": 0, "chunk": 0}

    def note(state, row):
        i = state.seq_id - first_seq
        if i >= 0 and state.n_generated == 0:
            rec["first"].setdefault(i, np.array(row, np.float32))

    def counted(key, fn):
        def call(*args):
            rec[key] += 1
            return fn(*args)
        return call

    real_batch, real_one = eng._apply_logits_batch, eng._on_logits

    def batch_spy(states, logits):
        for state, row in zip(states, logits):
            note(state, row)
        return real_batch(states, logits)

    def one_spy(state, row):
        note(state, row)
        return real_one(state, row)

    eng._apply_logits_batch, eng._on_logits = batch_spy, one_spy
    if eng._fused is not None:
        eng._fused.step = counted("decode", eng._fused.step)
    else:
        eng._decode = counted("decode", eng._decode)
    if eng._chunk_step is not None:
        eng._chunk_step.run = counted("chunk", eng._chunk_step.run)
    return rec


def run_engine(pgen, model, prompts, device, settings=None,
               max_new=MAX_NEW, stochastic=STOCHASTIC, extras=None,
               before_shutdown=None):
    """One measured run.  Every kernel's launch count is set to 0 just
    before it and read just after.  A loop engine's run also returns its
    graph replays, the captures made during the run and the iterations
    each loop call ran; `before_shutdown(eng)`, if given, runs after the
    measured run and its result is returned under "extra"."""
    eng, handles, records, first_seq = serve(
        pgen, model, prompts, device, settings, max_new, stochastic,
        extras)
    lp = eng._loop
    loop0 = (lp.replays, lp.captures) if lp is not None else (0, 0)
    reset_launches()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = eng.run_until_idle()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if any(launches[k["name"]] for k in FLASH_KERNELS):
        fail(f"a serving run launched a flash kernel: {launches}")
    # an int8 run launches only the int8 instantiations, a float run only
    # the float ones: one cannot stand in for the other
    tag = "_int8" if (settings or {}).get("kv_dtype") == "int8" else ""
    if any(launches[k["name"]] for k in KERNELS
           if k["name"].endswith("_int8") != bool(tag)):
        fail(f"a {'int8' if tag else 'float'} run launched another "
             f"dtype's paged kernel: {launches}")
    results = [h.result(timeout=60) for h in handles]
    ttft = sorted(h.first_token_s - h.submitted_s for h in handles
                  if h.first_token_s is not None)
    stats = eng.stats()
    shard_bytes = eng.cache.bytes_per_shard()
    pool_bytes = sum(shard_bytes)
    loop = {}
    if lp is not None:
        loop = dict(n=lp.loop_steps, replays=lp.replays - loop0[0],
                    captures=lp.captures - loop0[1],
                    capture_s=list(lp.capture_seconds),
                    iters=list(lp.iters_seen))
    extra = before_shutdown(eng) if before_shutdown else None
    eng.shutdown()
    ragged = eng._ragged is not None
    # a decode loop's call leaves its record without logits
    ragged_steps = sum(1 for r in records if r[2] is not None) \
        if ragged else steps
    return dict(results=results, records=records, first_seq=first_seq,
                wall=wall, launches=launches["ragged_paged_attention" + tag]
                if ragged else launches, all_launches=launches, tag=tag,
                steps=ragged_steps, stats=stats, ttft=ttft,
                pool_bytes=pool_bytes, shard_bytes=shard_bytes, loop=loop,
                extra=extra)


def device_kernels(prof):
    """Kernel time on the device by kernel name from a torch.profiler
    run, ``{name: (us, calls)}``: kernels only, since a CPU op (aten::mm)
    also carries its kernels' time and a RecordEvent span
    ("generation::...") the time it encloses."""
    from torch.autograd import DeviceType

    per_kernel = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if (dev_us > 0 and ev.device_type != DeviceType.CPU
                and not ev.key.startswith("generation::")):
            per_kernel[ev.key] = (dev_us, ev.count)
    return per_kernel


def profile_engine(pgen, model, prompts, settings=None):
    """The card's run again under torch.profiler (CUDA activity only: the
    host's events of a whole run took minutes to read back): wall
    seconds, the sum of kernel time on the device, and the kernels that
    took the most."""
    from torch.profiler import ProfilerActivity, profile

    eng, handles, _, _ = serve(pgen, model, prompts, "cuda", settings)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for h in handles:
        h.result(timeout=60)
    eng.shutdown()
    per_kernel = device_kernels(prof)
    busy = sum(us for us, _ in per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return wall, busy, top


def logits_at(run, req, k, prompt_len, required=True):
    """Logits the run sampled request `req`'s k-th token from: the
    descriptor of its sequence whose cache length is prompt_len + k.
    None where no step sampled it (a draft or a decode loop did) and not
    `required`."""
    seq = run["first_seq"] + req
    for desc_ids, kv, logits in run["records"]:
        if logits is None:           # a decode loop's call
            continue
        for j, sid in enumerate(desc_ids):
            if sid == seq and int(kv[j]) == prompt_len + k:
                return logits[j].float().cpu().numpy()
    if required:
        fail(f"no step produced request {req}'s token {k}")
    return None


def top2_gap(cpu_model, tokens):
    """The CPU full-recompute logits' top-2 gap after `tokens`."""
    logits, _, _ = cpu_model.prefill(tokens)
    top2 = np.sort(logits.numpy())[-2:]
    return float(top2[1] - top2[0])


def hold_ragged(label, gpu, cpu, prompts, logit_tol=LOGIT_TOL,
                near_tie=NEAR_TIE):
    """Phase 4's rule between two ragged runs, card and CPU: first-token
    logits within `logit_tol`, greedy streams identical or diverging only
    where the CPU run's own top-2 logit gap is < `near_tie`.  Returns the
    worst first-token logit difference."""
    worst = 0.0
    for i, p in enumerate(prompts):
        g0 = logits_at(gpu, i, 0, len(p))
        c0 = logits_at(cpu, i, 0, len(p))
        diff = float(np.abs(g0 - c0).max())
        worst = max(worst, diff)
        if not np.isfinite(g0).all() or diff > logit_tol:
            fail(f"{label} request {i}: first-token logits differ by "
                 f"{diff:.3e} > {logit_tol}")
        gt = gpu["results"][i].token_ids
        ct = cpu["results"][i].token_ids
        kind = "stochastic" if i in STOCHASTIC else "greedy"
        if gt == ct:
            log(f"  {label} request {i} ({kind}, prompt {len(p)}): "
                f"first-token logits max|diff| {diff:.2e}; streams "
                f"identical")
            continue
        k = next(j for j, (a, b) in enumerate(zip(gt, ct)) if a != b)
        top2 = np.sort(logits_at(cpu, i, k, len(p)))[-2:]
        gap = float(top2[1] - top2[0])
        log(f"  {label} request {i} ({kind}, prompt {len(p)}): streams "
            f"diverge at token {k} (card {gt[k]}, CPU {ct[k]}); CPU top-2 "
            f"gap {gap:.3e}")
        if kind == "greedy" and gap >= near_tie:
            fail(f"{label}: greedy request {i} diverges at token {k} where "
                 f"the CPU run's top-2 gap is {gap:.3e} >= {near_tie}")
    return worst


def hold_to_rule(label, a, b, prompts, cpu_model, stochastic, logits=True,
                 gap_of=None, near_tie=NEAR_TIE, quiet=False):
    """Phase 4's rule between runs `a` (card) and `b`: first-token logits
    within LOGIT_TOL (when `logits`), greedy streams identical or
    diverging only at a near tie: a top-2 logit gap < `near_tie` after
    the shared prefix, from ``gap_of(request, k)`` where given, else from
    the CPU full recompute.  Returns the worst first-token logit
    difference and the identical-stream count.  `quiet` logs only the
    streams that diverge."""
    worst, same = 0.0, 0
    for i, p in enumerate(prompts):
        kind = "stochastic" if i in stochastic else "greedy"
        note = ""
        if logits:
            g0, c0 = a["records"]["first"][i], b["records"]["first"][i]
            diff = float(np.abs(g0 - c0).max())
            worst = max(worst, diff)
            if not np.isfinite(g0).all() or diff > LOGIT_TOL:
                fail(f"{label} request {i}: first-token logits differ by "
                     f"{diff:.3e} > {LOGIT_TOL}")
            note = f"first-token logits max|diff| {diff:.2e}; "
        at, bt = a["results"][i].token_ids, b["results"][i].token_ids
        if at == bt:
            same += 1
            if not quiet:
                log(f"  {label} request {i} ({kind}, prompt {len(p)}): "
                    f"{note}streams identical")
            continue
        k = next((j for j, (x, y) in enumerate(zip(at, bt)) if x != y),
                 min(len(at), len(bt)))
        gap = (gap_of(i, k) if gap_of
               else top2_gap(cpu_model, list(p) + list(bt[:k])))
        log(f"  {label} request {i} ({kind}, prompt {len(p)}): {note}"
            f"streams diverge at token {k}; "
            f"{'top-2 gap' if gap_of else 'CPU top-2 gap'} {gap:.3e}")
        if kind == "greedy" and gap >= near_tie:
            fail(f"{label}: greedy request {i} diverges at token {k} where "
                 f"the top-2 gap is {gap:.3e} >= {near_tie}")
    return worst, same


def check_legacy_launches(label, run, want_chunk, chunk_calls=None, tp=1):
    """The legacy step's decode and chunk launches against num_layers x
    their calls (x `tp`: a mesh launches once per shard): `chunk_calls`
    where given (a warm one-shot run's eager suffixes), else the chunk
    step's calls."""
    n_layers = MODEL["num_layers"] * tp
    calls = run["records"]
    got = run["launches"]
    tag = run["tag"]
    dec = got["paged_decode_attention" + tag]
    chunk = got["chunk_prefill_attention" + tag]
    n_chunk = calls["chunk"] if chunk_calls is None else chunk_calls
    log(f"  {label}: {run['steps']} steps, {calls['decode']} decode calls, "
        f"{n_chunk} chunk calls; launches{tag}: decode {dec}, chunk "
        f"{chunk}, ragged {got['ragged_paged_attention' + tag]}; kernel "
        f"path {run['stats']['generation.kernel_path']}")
    if dec != n_layers * calls["decode"] or dec == 0:
        fail(f"{label}: decode kernel launched {dec} times, want "
             f"{n_layers} x {calls['decode']} decode calls")
    if chunk != n_layers * n_chunk or (chunk == 0) == want_chunk:
        fail(f"{label}: chunk kernel launched {chunk} times, want "
             f"{n_layers} x {n_chunk} chunk calls")
    if got["ragged_paged_attention" + tag]:
        fail(f"{label}: the legacy step launched the ragged kernel")


def phase_legacy(pgen, model, cpu_model, prompts, ragged_gpu):
    """The legacy step on card and CPU, then the short one-shot run."""
    n_layers = MODEL["num_layers"]
    gpu = run_engine(pgen, model, prompts, "cuda", LEGACY)
    for i, r in enumerate(gpu["results"]):
        if r.finish_reason != "length" or len(r.token_ids) != MAX_NEW:
            fail(f"legacy request {i} finished {r.finish_reason!r} with "
                 f"{len(r.token_ids)} tokens, want {MAX_NEW}")
    check_legacy_launches("legacy on the card", gpu, want_chunk=True)
    log("  the same legacy engine on the CPU (plain versions)")
    cpu = run_engine(pgen, cpu_model, prompts, "cpu", LEGACY)
    if any(cpu["launches"].values()):
        fail("the CPU legacy engine launched a CUDA kernel")
    worst, _ = hold_to_rule("legacy card vs CPU", gpu, cpu, prompts,
                            cpu_model, STOCHASTIC)
    _, same = hold_to_rule("card legacy vs ragged", gpu, ragged_gpu,
                           prompts, cpu_model, STOCHASTIC, logits=False)
    log(f"  card legacy vs card ragged: {same} of {len(prompts)} streams "
        f"identical")
    short = [prompts[i] for i in ONE_SHOT_PROMPTS]
    stoch = [j for j, i in enumerate(ONE_SHOT_PROMPTS) if i in STOCHASTIC]
    log(f"  one-shot prefill, eager decode: {len(short)} prompts, "
        f"{ONE_SHOT_NEW} new tokens each")
    one = run_engine(pgen, model, short, "cuda", ONE_SHOT, ONE_SHOT_NEW,
                     stoch)
    check_legacy_launches("one-shot on the card", one, want_chunk=False)
    one_cpu = run_engine(pgen, cpu_model, short, "cpu", ONE_SHOT,
                         ONE_SHOT_NEW, stoch)
    worst_one, _ = hold_to_rule("one-shot card vs CPU", one, one_cpu, short,
                                cpu_model, stoch)
    log(f"  first-token logits card vs CPU max|diff|: legacy {worst:.3e}, "
        f"one-shot {worst_one:.3e} (n_layers {n_layers})")
    return gpu, one


def phase_int8(pgen, model, cpu_model, prompts, gpu_f32, held):
    """int8 pools at GPT-2-small width: (a) the ragged step on the card,
    (b) on the card and the CPU at HELD_LAYERS layers (`held`: the two
    models) held to phase 4's rule, (c) the legacy step on the card held
    to (a); then, not gated, the int8 card run against the float32 one.
    Returns the card's ragged and legacy runs."""
    n_layers = MODEL["num_layers"]

    def full_length(label, run):
        for i, r in enumerate(run["results"]):
            if r.finish_reason != "length" or len(r.token_ids) != MAX_NEW:
                fail(f"{label} request {i} finished {r.finish_reason!r} "
                     f"with {len(r.token_ids)} tokens, want {MAX_NEW}")

    gpu = run_engine(pgen, model, prompts, "cuda", INT8)
    full_length("int8 ragged", gpu)
    want = n_layers * gpu["steps"]
    log(f"  (a) int8 ragged on the card: {gpu['steps']} steps, "
        f"{gpu['wall']:.3f} s; int8 ragged kernel launches "
        f"{gpu['launches']} (num_layers x steps = {want}); kernel path "
        f"{gpu['stats']['generation.kernel_path']}, kv dtype "
        f"{gpu['stats']['generation.kv_quant_dtype']}, scale bytes "
        f"{gpu['stats']['generation.kv_scale_bytes']}")
    if gpu["launches"] != want or gpu["launches"] == 0:
        fail(f"int8 ragged kernel launched {gpu['launches']} times, want "
             f"{want}")
    log(f"  (b) the int8 engine on the card and on the CPU (plain "
        f"versions) at {HELD_LAYERS} layers")
    card = run_engine(pgen, held[0], prompts, "cuda", INT8)
    if card["launches"] != HELD_LAYERS * card["steps"] \
            or not card["launches"]:
        fail(f"int8 ragged kernel launched {card['launches']} times at "
             f"{HELD_LAYERS} layers, want {HELD_LAYERS} x {card['steps']}")
    cpu = run_engine(pgen, held[1], prompts, "cpu", INT8)
    if any(cpu["all_launches"].values()):
        fail("the CPU int8 engine launched a CUDA kernel")
    worst = hold_ragged(f"int8 card vs CPU, {HELD_LAYERS} layers", card,
                        cpu, prompts, INT8_LOGIT_TOL, INT8_NEAR_TIE)
    log("  (c) the int8 legacy step on the card")
    legacy = run_engine(pgen, model, prompts, "cuda", {**LEGACY, **INT8})
    full_length("int8 legacy", legacy)
    check_legacy_launches("int8 legacy on the card", legacy,
                          want_chunk=True)

    def ragged_gap(i, k):
        top2 = np.sort(logits_at(gpu, i, k, len(prompts[i])))[-2:]
        return float(top2[1] - top2[0])

    _, same = hold_to_rule("int8 card legacy vs ragged", legacy, gpu,
                           prompts, cpu_model, STOCHASTIC, logits=False,
                           gap_of=ragged_gap, near_tie=INT8_NEAR_TIE)
    log(f"  int8 card legacy vs int8 card ragged: {same} of {len(prompts)} "
        f"streams identical; first-token logits card vs CPU max|diff| "
        f"{worst:.3e}")
    # not gated: int8 against the float32 card run of phase 3
    match = total = 0
    drift = 0.0
    for i, p in enumerate(prompts):
        drift = max(drift, float(np.abs(
            logits_at(gpu, i, 0, len(p))
            - logits_at(gpu_f32, i, 0, len(p))).max()))
        if i in STOCHASTIC:
            continue
        a = gpu_f32["results"][i].token_ids
        b = gpu["results"][i].token_ids
        total += max(len(a), len(b))
        match += sum(x == y for x, y in zip(a, b))
    log(f"  int8 vs float32 (card, ragged): greedy token agreement "
        f"{match}/{total} = {match / total:.4f}; first-token logit drift "
        f"max|diff| {drift:.3e}; pool bytes at {ENGINE['num_pages']} pages "
        f"(scales included): int8 {gpu['pool_bytes']} vs float32 "
        f"{gpu_f32['pool_bytes']} = {gpu['pool_bytes'] / gpu_f32['pool_bytes']:.3f}")
    return gpu, legacy


# ------------- speculation and the host-free decode loop ---------------


def serving_traffic(prompts, base):
    """Phase 7's traffic: phase 3's prompts, then a prompt of one span
    repeated (its drafts find their matches), then two requests with
    phase 3's first two prompts and stops from phase 3's card streams:
    request 0's first token from the 9th on that did not come before, as
    a stop token, and request 1's first pair of tokens from the 13th on
    that did not come before, as a stop sequence.  Returns the prompts
    and their extras."""
    span = np.random.default_rng(7).integers(
        0, MODEL["vocab_size"], 24).tolist()
    g0, g1 = (base["results"][i].token_ids for i in (0, 1))
    k0 = next((k for k in range(8, len(g0)) if g0[k] not in g0[:k]),
              len(g0) - 1)
    pairs = [tuple(g1[k:k + 2]) for k in range(len(g1) - 1)]
    k1 = next((k for k in range(12, len(pairs))
               if pairs[k] not in pairs[:k]), len(pairs) - 1)
    n = len(prompts)
    traffic = list(prompts) + [span * 10, list(prompts[0]),
                               list(prompts[1])]
    extras = {n + 1: dict(stop_tokens=(g0[k0],)),
              n + 2: dict(stop_sequences=[pairs[k1]])}
    return traffic, extras


def serving_settings(kv_dtype, spec, n):
    return dict(kv_dtype=kv_dtype, loop_steps=n, **(SPEC if spec else {}))


def serving_label(kv_dtype, spec, n):
    return f"{kv_dtype} spec {'on' if spec else 'off'} N={n}"


def loop_args(lp, rng, n_pages):
    """One loop's inputs for every row of `lp`: rows at positions
    100..599 over random pages, greedy rows drafting 0..K tokens, two
    stochastic rows, budgets past the loop."""
    s, kd = lp.max_seqs, max(lp.spec_tokens, 1)
    pages = rng.permutation(n_pages)[:s * 40].reshape(s, 40)
    temps = np.zeros(s, np.float32)
    temps[[2, 5]] = 0.8
    dlens = (np.array([lp.spec_tokens, 2, 0, 1, 3, 0, 0, 0][:s], np.int32)
             if lp.spec_tokens else np.zeros(s, np.int32))
    return (rng.integers(0, MODEL["vocab_size"], s).astype(np.int32),
            rng.integers(100, 600, s).astype(np.int32),
            pages.astype(np.int32), temps,
            np.where(temps > 0, 50, 0).astype(np.int32),
            np.where(temps > 0, 0.95, 1.0).astype(np.float32),
            np.arange(s, dtype=np.int32) + 100, np.zeros(s, np.int32),
            np.full(s, 32, np.int32),
            np.full((s, lp.max_stop_ids), -1, np.int32),
            np.full((s, lp.max_stop_seqs, lp.max_stop_len), -1, np.int32),
            np.zeros((s, lp.max_stop_seqs), np.int32),
            np.full((s, lp.max_stop_len - 1), -1, np.int32),
            rng.integers(0, MODEL["vocab_size"], (s, kd)).astype(np.int32),
            np.minimum(dlens, lp.spec_tokens))


def real_pages(eng, t):
    """A pool state tensor without its sink page (the last page, which
    takes every dead row's write: several writes to one place, in no
    fixed order, and never read)."""
    p = eng.cache.num_pages
    if t.dim() == 4 and eng.cache.pool_layout == "kernel":
        return t[:, :p]
    return t[:p]


def loop_probe(eng, bitwise):
    """After a loop engine's measured run: with `bitwise`, one captured
    loop (pages bucket 64) replayed against the same loop run eagerly on
    the same inputs and pool state, output and pools (sink page aside)
    compared bitwise (phase 7 (c)); then the device time of one loop
    iteration with every row live and with every row dead (the masked
    tail), from replays of that graph."""
    lp = eng._loop
    args = loop_args(lp, np.random.default_rng(8), ENGINE["num_pages"])
    equal = None
    if bitwise:
        start = [t.clone() for t in eng.cache.take_pool_state()]
        replayed = lp.step(*args)
        after = [t.clone() for t in eng.cache.take_pool_state()]
        for t, t0 in zip(eng.cache.take_pool_state(), start):
            t.copy_(t0)
        lp.use_graph = False
        eager = lp.step(*args)
        lp.use_graph = True
        equal = bool(np.array_equal(replayed, eager)) and all(
            torch.equal(real_pages(eng, a), real_pages(eng, b))
            for a, b in zip(after, eng.cache.take_pool_state()))
        if not equal:
            fail(f"the captured loop's replay differs from the eager loop "
                 f"on the same inputs ({serving_label(str(eng.cache.dtype), lp.spec_tokens > 0, lp.loop_steps)})")
    g = lp._graph_for(64)
    live = lp._host_inputs(64, (args[0], args[1], np.ones(lp.max_seqs,
                                                           np.int32),
                                *args[2:]))
    g.flat.copy_(torch.from_numpy(live))
    live_ms = time_ms(g.graph.replay, 10) / lp.loop_steps
    g.flat.copy_(torch.from_numpy(lp._host_inputs(64, None)))
    dead_ms = time_ms(g.graph.replay, 10) / lp.loop_steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    kernels = sum(n for _, n in device_kernels(prof).values())
    return dict(bitwise=equal, live_ms=live_ms, dead_ms=dead_ms,
                kernels=kernels / lp.loop_steps)


def profile_pass(pgen, eng, traffic, extras):
    """The traffic once more on the measured engine (its graphs captured,
    its spies removed) under torch.profiler tracing the card: wall
    seconds and the kernels' busy seconds on the device."""
    from torch.profiler import ProfilerActivity, profile

    for owner, name in ((eng.cache, "gather_block_tables"),
                        (eng._ragged, "step"), (eng._loop, "step")):
        if owner is not None and name in vars(owner):
            delattr(owner, name)
    handles = submit_traffic(pgen, eng, traffic, extras=extras)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for h in handles:
        h.result(timeout=60)
    busy = sum(us for us, _ in device_kernels(prof).values()) / 1e6
    return dict(wall=wall, busy=busy)


def check_serving_run(label, run, extras, tp=1):
    """Every request finished by its length or its stop, and the ragged
    kernel launched num_layers x (ragged steps + N x (loop replays + the
    loop's captures in the run, each after an eager warm-up of N
    iterations)) times, x `tp` on a mesh (a launch per shard)."""
    n_layers = MODEL["num_layers"] * tp
    for i, r in enumerate(run["results"]):
        if i in extras:
            if r.finish_reason != "stop":
                fail(f"{label}: request {i} finished {r.finish_reason!r}, "
                     f"want 'stop'")
        elif r.finish_reason != "length" or len(r.token_ids) != MAX_NEW:
            fail(f"{label}: request {i} finished {r.finish_reason!r} with "
                 f"{len(r.token_ids)} tokens, want {MAX_NEW}")
    loop = run["loop"]
    n = loop.get("n", 0)
    calls = loop.get("replays", 0) + loop.get("captures", 0)
    want = n_layers * (run["steps"] + n * calls)
    st = run["stats"]
    log(f"  {label}: {run['steps']} ragged steps"
        + (f", {loop['replays']} loop replays, {loop['captures']} captures "
           f"in the run" if loop else "")
        + f"; ragged launches{run['tag']} {run['launches']} (num_layers x "
        f"(steps + N x calls) = {want}); spec accepted "
        f"{st['generation.spec_accepted_tokens']} of proposed "
        f"{st['generation.spec_proposed_tokens']}, rewound "
        f"{st['generation.spec_rewind_tokens']}; loop fetches per token "
        f"{st['generation.decode_host_fetches_per_token']}; prefix hit "
        f"tokens {st.get('generation.prefix_cache_hit_tokens', 0)}, copies "
        f"on write {st.get('generation.cow_copies', 0)}; wall "
        f"{run['wall']:.3f} s")
    if run["launches"] != want or run["launches"] == 0:
        fail(f"{label}: ragged kernel launched {run['launches']} times, "
             f"want {want}")
    if loop:
        if not loop["replays"]:
            fail(f"{label}: the decode loop never ran")
        if not 0 < st["generation.decode_host_fetches_per_token"] <= 1 / n:
            fail(f"{label}: {st['generation.decode_host_fetches_per_token']}"
                 f" host fetches per token on the loop path, want <= 1/{n}")


def phase_serving(pgen, model, cpu_model, prompts, base, held):
    """Phase 7: speculation (K=4) and the host-free decode loop (N=4, and
    N=8 for LONG_LOOP_RUNS) at GPT-2-small width on float32 and int8
    pools, with phase 3's engine and weights over `serving_traffic`:
    every spec x N x dtype run on the card, each held by phase 4's rule
    (phase 6's bounds for int8; the top-2 gap from the reference run's own logits, or the CPU
    full recompute where a draft or a loop produced the token) to the
    spec-off N=1 run of its dtype, except int8 runs with speculation,
    held to int8 spec-on N=1 (a rejected draft's write can grow its
    page's scale before the rewind, so int8 speculation changes values,
    as in the JAX package: spec on against off is printed, not gated);
    (a) speculation accepts and rewinds drafts, and a
    subset of the traffic (prompts 0-2, the repeated span, the two stop
    requests) with speculation on is held card vs CPU at HELD_LAYERS
    layers (`held`: the two models), the CPU on the card's warm path;
    (b) the loop
    fetches at most once per N tokens on its path; (c) one captured
    loop bitwise against the eager loop, per dtype.  Returns the runs
    by (dtype, spec, N), each with its profiled second pass."""
    traffic, extras = serving_traffic(prompts, base)
    runs = {}
    for kv_dtype in ("float32", "int8"):
        for spec in (False, True):
            for n in (1,) + LOOP_NS:
                if n > LOOP_NS[0] and (kv_dtype, spec) not in LONG_LOOP_RUNS:
                    continue
                label = serving_label(kv_dtype, spec, n)

                def after(eng, bitwise=spec and n == LOOP_NS[0],
                          profiled=kv_dtype == "float32"
                          and (spec, n) in SERVING_PROFILED):
                    """(c) and the loop's iteration times, then, on
                    float32 pools, the profiled pass for (f)."""
                    probe = (loop_probe(eng, bitwise)
                             if eng._loop is not None else {})
                    return dict(probe, profile=profile_pass(
                        pgen, eng, traffic, extras) if profiled else None)

                run = run_engine(pgen, model, traffic, "cuda",
                                 serving_settings(kv_dtype, spec, n),
                                 extras=extras, before_shutdown=after)
                check_serving_run(label, run, extras)
                if run["extra"].get("bitwise"):
                    log(f"  (c) {label}: one captured loop (pages bucket "
                        f"64) replayed against the eager loop on the same "
                        f"inputs: output and pools bitwise equal")
                runs[(kv_dtype, spec, n)] = run
        int8 = kv_dtype == "int8"
        near_tie = INT8_NEAR_TIE if int8 else NEAR_TIE
        off = runs[(kv_dtype, False, 1)]

        def gap_in(ref, prompts_, i, k, recompute=cpu_model):
            """The top-2 gap where `ref` sampled request i's token k, or,
            where a draft or a loop call produced it, the CPU full
            recompute's (on `recompute`, the model of `ref`'s depth)."""
            row = logits_at(ref, i, k, len(prompts_[i]), required=False)
            if row is None:
                return top2_gap(recompute, list(prompts_[i])
                                + ref["results"][i].token_ids[:k])
            top2 = np.sort(row)[-2:]
            return float(top2[1] - top2[0])

        # float32: every run against spec off N=1 (a verify row is a chunk
        # row to the kernel); int8: speculation changes values (a rejected
        # draft's write can grow its page's scale before the rewind, as in
        # the JAX package), so spec-on runs are held to spec-on N=1 and
        # spec on against off is printed, not gated
        for (dt, spec, n), run in runs.items():
            if dt != kv_dtype or (not spec and n == 1):
                continue
            ref_key = (dt, spec and int8, 1)
            label = serving_label(dt, spec, n)
            if (dt, spec, n) == ref_key:
                agree = total = 0
                for i, (a, b) in enumerate(zip(run["results"],
                                               off["results"])):
                    if i not in STOCHASTIC:
                        total += max(len(a.token_ids), len(b.token_ids))
                        agree += sum(x == y for x, y in zip(a.token_ids,
                                                            b.token_ids))
                same = sum(a.token_ids == b.token_ids for a, b in
                           zip(run["results"], off["results"]))
                log(f"  {label} vs spec off N=1 (card, not gated): {same} "
                    f"of {len(traffic)} streams identical, greedy token "
                    f"agreement {agree}/{total} = {agree / total:.4f}")
                continue
            ref = runs[ref_key]
            _, same = hold_to_rule(
                f"{label} vs {serving_label(*ref_key)}", run, ref, traffic,
                cpu_model, STOCHASTIC, logits=False,
                gap_of=lambda i, k, ref=ref: gap_in(ref, traffic, i, k),
                near_tie=near_tie, quiet=True)
            log(f"  {label} vs {serving_label(*ref_key)} (card): {same} of "
                f"{len(traffic)} streams identical")
        st = runs[(kv_dtype, True, 1)]["stats"]
        if not (st["generation.spec_accepted_tokens"] > 0
                and st["generation.spec_rewind_tokens"] > 0):
            fail(f"{kv_dtype} speculation accepted "
                 f"{st['generation.spec_accepted_tokens']} and rewound "
                 f"{st['generation.spec_rewind_tokens']} drafts: want both "
                 f"above 0")
        # (a) card vs CPU on a subset of the traffic, speculation on
        keep = [0, 1, 2, len(prompts), len(prompts) + 1, len(prompts) + 2]
        sub = [traffic[i] for i in keep]
        sub_extras = {j: extras[i] for j, i in enumerate(keep)
                      if i in extras}
        # the subset's requests sample as they do in the whole traffic
        sub_stoch = tuple(j for j, i in enumerate(keep) if i in STOCHASTIC)
        settings = serving_settings(kv_dtype, True, 1)
        card = run_engine(pgen, held[0], sub, "cuda", settings,
                          stochastic=sub_stoch, extras=sub_extras)
        # the CPU serves the path the card resolved to (an unset
        # prefix_cache is on on the card): the subset resends prompt 0,
        # and an int8 page's values depend on its write history, which a
        # warm hit changes (phase 12 holds warm against cold)
        cpu = run_engine(pgen, held[1], sub, "cpu",
                         dict(settings, prefix_cache=True),
                         stochastic=sub_stoch, extras=sub_extras)
        if any(cpu["all_launches"].values()):
            fail("the CPU spec engine launched a CUDA kernel")
        tol = INT8_LOGIT_TOL if int8 else LOGIT_TOL
        worst = 0.0
        for j, p in enumerate(sub):
            diff = float(np.abs(logits_at(card, j, 0, len(p))
                                - logits_at(cpu, j, 0, len(p))).max())
            worst = max(worst, diff)
            if not math.isfinite(diff) or diff > tol:
                fail(f"{kv_dtype} spec card vs CPU request {j}: first-token "
                     f"logits differ by {diff:.3e} > {tol}")
        _, same = hold_to_rule(
            f"(a) {kv_dtype} spec on card vs CPU", card, cpu, sub, held[1],
            sub_stoch, logits=False,
            gap_of=lambda j, k: gap_in(cpu, sub, j, k, held[1]),
            near_tie=near_tie, quiet=True)
        log(f"  (a) {kv_dtype} spec on, card vs CPU at {HELD_LAYERS} "
            f"layers over {len(sub)} "
            f"requests: first-token logits max|diff| {worst:.3e}; {same} of "
            f"{len(sub)} streams identical; CPU accepted "
            f"{cpu['stats']['generation.spec_accepted_tokens']} drafts")
    return runs


SAMPLER_MENU = [
    dict(),                                              # greedy
    dict(temperature=0.7, seed=11),
    dict(temperature=1.3, top_k=5, seed=12),
    dict(temperature=0.9, top_p=0.8, seed=13),
    dict(temperature=1.0, top_k=9, top_p=0.6, seed=14),
    dict(temperature=2.5, top_k=1, seed=15),
    dict(temperature=0.4, top_p=0.999, seed=16),
    dict(temperature=0.8, top_k=50, top_p=0.95, seed=17),
]


def phase_sampler(pgen):
    """(d) The device sampler on the card against the host sampler over
    seeded [8, vocab] logits, one row per entry of the menu, for
    SAMPLER_DRAWS draws: the counters equal, at most SAMPLER_MAX_DIFF
    rows with another token.  Returns (rows differing, rows)."""
    from paddle_tpu_torch.generation import sampling as ps

    params = [pgen.SamplingParams(**m) for m in SAMPLER_MENU]
    host = [ps.SampleStream(p.seed) for p in params]

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda")

    temps = dev([p.temperature for p in params], torch.float32)
    top_ks = dev([p.top_k or 0 for p in params], torch.int32)
    top_ps = dev([1.0 if p.top_p is None else p.top_p for p in params],
                 torch.float32)
    seeds = dev([p.seed for p in params], torch.int32)
    ctr = torch.zeros(len(params), dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(9)
    differ = 0
    for _ in range(SAMPLER_DRAWS):
        logits = rng.standard_normal(
            (len(params), MODEL["vocab_size"])).astype(np.float32) * 3
        want = ps.sample_tokens_batch(logits, params, host)
        tok, ctr = ps.sample_tokens_device(dev(logits, torch.float32),
                                           temps, top_ks, top_ps, seeds, ctr)
        differ += sum(a != b for a, b in zip(tok.cpu().tolist(), want))
        if ctr.cpu().tolist() != [r.counter for r in host]:
            fail("the device sampler's counters left the host streams'")
    rows = SAMPLER_DRAWS * len(params)
    log(f"  (d) device sampler on the card vs the host sampler: {differ} of "
        f"{rows} rows sampled another token ([8, {MODEL['vocab_size']}] "
        f"logits, the menu of {len(params)}); counters equal")
    if differ > SAMPLER_MAX_DIFF:
        fail(f"the device sampler differs from the host sampler on "
             f"{differ} of {rows} rows (> {SAMPLER_MAX_DIFF})")
    return differ, rows


# ------------------------------ prefix caching ------------------------------


def prefix_traffic():
    """Phase 12's prompts: a 512-token system prompt (32 full pages)
    shared by 7 requests with distinct 16..96-token suffixes, the system
    prompt alone (its match is clipped to 511 tokens: one copy on write),
    and a two-turn conversation's first turn; the second turn and the
    system prompt alone again come later, in waves of their own.
    Returns (first-wave prompts, system prompt, turn 2's new tokens)."""
    rng = np.random.default_rng(11)

    def draw(n):
        return rng.integers(0, MODEL["vocab_size"], int(n)).tolist()

    system = draw(PREFIX_SYSTEM)
    shared = [system + draw(n) for n in
              np.linspace(16, 96, PREFIX_SHARED).round()]
    turn1 = system + draw(40)
    return shared + [list(system), turn1], system, draw(24)


def prefix_serve(pgen, model, device, settings, keep=False):
    """One measured run of phase 12's traffic on a fresh engine with its
    own stat registry: request 0 first, stepped until its prefill is done,
    then the rest of the first wave; then turn 2 (turn 1's prompt, its
    answer and 24 new tokens); then the system prompt alone again.  Every
    kernel's launches are set to 0 just before it and read just after.
    Each copy on write is held bitwise (the private page's bytes and
    scale rows against the donor's, both exported right after the copy),
    and the order of loop-graph replays and copies is kept.  Returns the
    run's results and counts, the engine kept alive with `keep`."""
    from paddle_tpu_torch.profiler.monitor import StatRegistry

    wave1, system, new2 = prefix_traffic()
    reg = StatRegistry()
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        device=device, **{**ENGINE, **PREFIX_ENGINE, **settings}),
        metrics=pgen.GenerationMetrics(registry=reg), start=False)
    warm = eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run_until_idle()
    warm.result(timeout=60)
    lp = eng._loop
    if lp is not None:
        for pages in LOOP_PREWARM:
            lp.prewarm(pages)
    for name in PREFIX_COUNTERS + ("spec_accepted_tokens",):
        reg.get_stat("generation." + name).reset()
    first_seq = eng.scheduler._next_seq
    records = (spy_ragged(eng) if eng._ragged is not None
               else spy_legacy(eng, first_seq))
    events, cows, suffix = [], [], [0]
    cache = eng.cache
    real_copy = cache._copy_page_storage

    def copy_spy(src, dst):
        real_copy(src, dst)
        a, b = cache.export_pages([src]), cache.export_pages([dst])
        cows.append(all(torch.equal(x, y) for x, y in zip(a, b)))
        events.append(("cow", None))

    cache._copy_page_storage = copy_spy
    if lp is not None and lp.use_graph:
        real_graph = lp._graph_for

        def graph_spy(bucket_p):
            g = real_graph(bucket_p)
            events.append(("replay", g))
            return g

        lp._graph_for = graph_spy
    real_suffix = eng._prefill_suffix

    def suffix_spy(state):
        suffix[0] += 1
        return real_suffix(state)

    eng._prefill_suffix = suffix_spy
    loop0 = (lp.replays, lp.captures) if lp is not None else (0, 0)
    peaks = [0, 0, 0]   # pages in use, shared pages, steps

    def step():
        eng.step()
        peaks[0] = max(peaks[0], cache.pages_in_use)
        peaks[1] = max(peaks[1], cache.shared_pages)
        peaks[2] += 1

    def drive():
        while eng.scheduler.active() or eng.scheduler.pending_count():
            step()

    prompts = list(wave1)
    handles = []

    def submit(i):
        sampling = (pgen.SamplingParams(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=200 + i)
                    if i in PREFIX_STOCHASTIC else pgen.SamplingParams())
        handles.append(eng.submit(prompts[i], max_new_tokens=MAX_NEW,
                                  sampling=sampling))

    reset_launches()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    submit(0)
    while handles[0].first_token_s is None:
        step()
    for i in range(1, len(wave1)):
        submit(i)
    drive()
    prompts.append(wave1[-1] + handles[-1].result(timeout=60).token_ids
                   + new2)
    submit(len(prompts) - 1)
    drive()
    prompts.append(list(system))
    submit(len(prompts) - 1)
    drive()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    results = [h.result(timeout=60) for h in handles]
    stats = reg.stats()
    loop = {}
    if lp is not None:
        loop = dict(n=lp.loop_steps, replays=lp.replays - loop0[0],
                    captures=lp.captures - loop0[1])
    run = dict(results=results, records=records, first_seq=first_seq,
               prompts=prompts, wall=wall, launches=launches,
               steps=sum(1 for r in records if r[2] is not None)
               if eng._ragged is not None else peaks[2],
               tag="_int8" if eng.kv_quant else "",
               stats=stats, peak_pages=peaks[0], peak_shared=peaks[1],
               ttft=[h.first_token_s - h.submitted_s for h in handles],
               hits=[h.prefix_hit_tokens for h in handles], cows=cows,
               events=events, suffix_calls=suffix[0], loop=loop,
               engine=eng if keep else None, system=system)
    if not keep:
        eng.shutdown()
    return run


def prefix_counters(run):
    st = run["stats"]
    return {name: st.get("generation." + name, 0)
            for name in PREFIX_COUNTERS}


def prefix_first_logits(run, i):
    if isinstance(run["records"], dict):
        return run["records"]["first"][i]
    return logits_at(run, i, 0, len(run["prompts"][i]))


def hold_prefix(label, a, b, cpu_model, tol=LOGIT_TOL, near_tie=NEAR_TIE,
                logits=True):
    """Phase 4's rule between runs `a` and `b` of phase 12's traffic, on
    the requests whose prompts are equal (turn 2 carries each run's own
    turn-1 answer): first-token logits within `tol` (when `logits`),
    greedy streams identical or diverging only where the top-2 logit gap
    after the shared prefix is < `near_tie` (from `b`'s logits where it
    sampled there, else the CPU full recompute).  Returns the worst
    first-token difference and the identical-stream count."""
    worst, same = 0.0, 0
    for i, (pa_, pb_) in enumerate(zip(a["prompts"], b["prompts"])):
        if pa_ != pb_:
            log(f"  {label} request {i}: prompts differ (turn 1's answers "
                f"diverged at a near tie): not compared")
            continue
        if logits:
            diff = float(np.abs(prefix_first_logits(a, i)
                                - prefix_first_logits(b, i)).max())
            worst = max(worst, diff)
            if not math.isfinite(diff) or diff > tol:
                fail(f"{label} request {i}: first-token logits differ by "
                     f"{diff:.3e} > {tol}")
        at, bt = a["results"][i].token_ids, b["results"][i].token_ids
        if at == bt:
            same += 1
            continue
        k = next((j for j, (x, y) in enumerate(zip(at, bt)) if x != y),
                 min(len(at), len(bt)))
        row = (logits_at(b, i, k, len(pa_), required=False)
               if not isinstance(b["records"], dict) else None)
        gap = (top2_gap(cpu_model, list(pa_) + list(bt[:k])) if row is None
               else float(np.diff(np.sort(row)[-2:])[0]))
        kind = "stochastic" if i in PREFIX_STOCHASTIC else "greedy"
        log(f"  {label} request {i} ({kind}): streams diverge at token "
            f"{k}; top-2 gap {gap:.3e}")
        if kind == "greedy" and gap >= near_tie:
            fail(f"{label}: greedy request {i} diverges at token {k} where "
                 f"the top-2 gap is {gap:.3e} >= {near_tie}")
    log(f"  {label}: {same} of {len(a['results'])} streams identical"
        + (f", first-token logits max|diff| {worst:.3e}" if logits else ""))
    return worst, same


def check_prefix_warm(label, warm, cold):
    """The warm run's hits, prefill accounting, copies on write (each
    bitwise its donor) and shared pages."""
    c = prefix_counters(warm)
    hits = sum(warm["hits"])
    ps = ENGINE["page_size"]
    # turn 2 hits every full page turn 1 left written: its prompt and
    # answer less the last sampled token, which was never decoded
    tail = (len(warm["prompts"][-3]) + MAX_NEW - 1) // ps * ps
    want_hits = ([0] + [PREFIX_SYSTEM] * (PREFIX_SHARED - 1)
                 + [PREFIX_SYSTEM - 1, PREFIX_SYSTEM, tail,
                    PREFIX_SYSTEM - 1])
    if warm["hits"] != want_hits:
        fail(f"{label}: prefix hits {warm['hits']}, want {want_hits}")
    if c["prefix_cache_hit_tokens"] != hits:
        fail(f"{label}: hit counter {c['prefix_cache_hit_tokens']} != "
             f"{hits}")
    if c["prefill_tokens_total"] != sum(map(len, warm["prompts"])) - hits:
        fail(f"{label}: prefilled {c['prefill_tokens_total']} tokens, want "
             f"the prompts' {sum(map(len, warm['prompts']))} less {hits}")
    if cold is not None:
        cc = prefix_counters(cold)
        if cc["prefix_cache_hit_tokens"] or cold["cows"]:
            fail(f"{label}: the cold run hit the prefix cache")
        if cold["prompts"] == warm["prompts"] and \
                c["prefill_tokens_total"] != cc["prefill_tokens_total"] - hits:
            fail(f"{label}: warm prefill {c['prefill_tokens_total']} != "
                 f"cold {cc['prefill_tokens_total']} - hits {hits}")
    if c["cow_copies"] != 2 or len(warm["cows"]) != 2 \
            or not all(warm["cows"]):
        fail(f"{label}: copies on write {c['cow_copies']} ({warm['cows']}), "
             f"want 2, each bitwise its donor page")
    if warm["peak_shared"] < PREFIX_SYSTEM // ENGINE["page_size"]:
        fail(f"{label}: peak shared pages {warm['peak_shared']} < "
             f"{PREFIX_SYSTEM // ENGINE['page_size']}")
    for i, r in enumerate(warm["results"]):
        if r.finish_reason != "length" or len(r.token_ids) != MAX_NEW:
            fail(f"{label} request {i} finished {r.finish_reason!r} with "
                 f"{len(r.token_ids)} tokens, want {MAX_NEW}")
    log(f"  {label}: hits {warm['hits']}; counters {c}; peak shared "
        f"{warm['peak_shared']}, peak pages in use {warm['peak_pages']}; "
        f"copies on write bitwise their donors: {warm['cows']}")


def check_prefix_ragged(label, run, n_layers=None):
    n_layers = n_layers or MODEL["num_layers"]
    want = n_layers * run["steps"]
    loop = run["loop"]
    if loop:
        want = n_layers * (run["steps"] + loop["n"] * (
            loop["replays"] + loop["captures"]))
    tag = run["tag"]
    got = run["launches"]["ragged_paged_attention" + tag]
    log(f"  {label}: {run['steps']} ragged steps"
        + (f", {loop['replays']} loop replays, {loop['captures']} captures"
           if loop else "")
        + f"; ragged launches{tag} {got} (want {want}); wall "
        f"{run['wall']:.3f} s")
    if got != want or got == 0:
        fail(f"{label}: ragged kernel launched {got} times, want {want}")


def phase_prefix(pgen, model, cpu_model):
    """Phase 12: prefix caching at GPT-2-small width (phase 3's model and
    pool, chunks of 64).  (a) the ragged step cold and warm on the card
    and warm on the CPU; (b) the legacy step and (c) the one-shot prefill
    (a warm suffix through the eager chunk path), each warm against its
    own cold run; (d) int8 pools; (e) speculation and the loop over a warm
    cache; (f) the page service.  Returns the runs and the payloads."""
    n_layers = MODEL["num_layers"]
    runs = {}
    held_card, held_cpu = held_models(pgen)

    def card_vs_cpu(label, settings, tol, near_tie):
        """The warm run at the cut depth on the card and on the CPU: the
        same hits and counters, streams by phase 4's rule."""
        card = prefix_serve(pgen, held_card, "cuda", settings)
        cpu = prefix_serve(pgen, held_cpu, "cpu", settings)
        check_prefix_ragged(f"{label} card, {HELD_LAYERS} layers",
                            card, HELD_LAYERS)
        check_prefix_warm(f"{label} card, {HELD_LAYERS} layers",
                          card, None)
        check_prefix_warm(f"{label} CPU, {HELD_LAYERS} layers", cpu,
                          None)
        if any(cpu["launches"].values()):
            fail("the CPU prefix engine launched a CUDA kernel")
        if prefix_counters(card) != prefix_counters(cpu) \
                or card["peak_shared"] != cpu["peak_shared"]:
            fail(f"{label}: card counters {prefix_counters(card)} (peak "
                 f"shared {card['peak_shared']}) != CPU "
                 f"{prefix_counters(cpu)} ({cpu['peak_shared']})")
        hold_prefix(f"{label} card vs CPU, {HELD_LAYERS} layers",
                    card, cpu, held_cpu, tol, near_tie)
        return card, cpu

    log(f"  (a) the ragged step: cold and warm on the card; warm on the "
        f"card and the CPU at {HELD_LAYERS} layers")
    cold = runs["cold"] = prefix_serve(pgen, model, "cuda",
                                       dict(prefix_cache=False))
    warm = runs["warm"] = prefix_serve(pgen, model, "cuda",
                                       dict(prefix_cache=True), keep=True)
    for run, label in ((cold, "ragged cold card"),
                       (warm, "ragged warm card")):
        check_prefix_ragged(label, run)
    check_prefix_warm("ragged warm card", warm, cold)
    hold_prefix("ragged warm card vs cold card", warm, cold, cpu_model)
    runs["held"] = card_vs_cpu("ragged warm", dict(prefix_cache=True),
                               LOGIT_TOL, NEAR_TIE)
    if prefix_counters(runs["held"][1]) != prefix_counters(warm):
        fail(f"the CPU's counters {prefix_counters(runs['held'][1])} != "
             f"the full-depth card's {prefix_counters(warm)}")

    log("  (b) the legacy step, chunks of 64: cold and warm on the card")
    legacy = {}
    for name, on in (("cold", False), ("warm", True)):
        run = legacy[name] = prefix_serve(
            pgen, model, "cuda", dict(LEGACY, prefix_cache=on))
        check_legacy_launches(f"legacy {name}", run, want_chunk=True)
    check_prefix_warm("legacy warm card", legacy["warm"], legacy["cold"])
    calls = [legacy[k]["records"]["chunk"] for k in ("cold", "warm")]
    if not calls[1] < calls[0]:
        fail(f"legacy warm ran {calls[1]} chunk calls, cold {calls[0]}: "
             f"cached chunks were not skipped")
    log(f"  legacy chunk calls cold {calls[0]}, warm {calls[1]}: "
        f"{calls[0] - calls[1]} cached chunks skipped")
    hold_prefix("legacy warm vs cold", legacy["warm"], legacy["cold"],
                cpu_model)
    runs["legacy"] = legacy

    log("  (c) one-shot prefill, eager decode: cold and warm on the card")
    one = {}
    for name, on in (("cold", False), ("warm", True)):
        run = one[name] = prefix_serve(pgen, model, "cuda",
                                       dict(ONE_SHOT, prefix_cache=on))
        check_legacy_launches(f"one-shot {name}", run, want_chunk=on,
                              chunk_calls=run["suffix_calls"])
    check_prefix_warm("one-shot warm card", one["warm"], one["cold"])
    got = one["warm"]["launches"]["chunk_prefill_attention"]
    if got != n_layers * one["warm"]["suffix_calls"] \
            or one["warm"]["suffix_calls"] != len(one["warm"]["prompts"]) - 1:
        fail(f"one-shot warm: chunk kernel launched {got} times over "
             f"{one['warm']['suffix_calls']} suffix calls, want num_layers "
             f"x one call per warm request")
    log(f"  one-shot warm: {one['warm']['suffix_calls']} warm suffixes "
        f"through the eager chunk path, chunk launches {got}")
    hold_prefix("one-shot warm vs cold", one["warm"], one["cold"],
                cpu_model)
    runs["one_shot"] = one

    log(f"  (d) int8 pools: cold and warm on the card; warm on the card "
        f"and the CPU at {HELD_LAYERS} layers")
    q = {}
    q["cold"] = prefix_serve(pgen, model, "cuda",
                             dict(INT8, prefix_cache=False))
    q["warm"] = prefix_serve(pgen, model, "cuda",
                             dict(INT8, prefix_cache=True), keep=True)
    check_prefix_ragged("int8 cold card", q["cold"])
    check_prefix_ragged("int8 warm card", q["warm"])
    check_prefix_warm("int8 warm card", q["warm"], q["cold"])
    hold_prefix("int8 warm card vs cold card", q["warm"], q["cold"],
                cpu_model, INT8_LOGIT_TOL, INT8_NEAR_TIE)
    q["held"] = card_vs_cpu("int8 warm", dict(INT8, prefix_cache=True),
                            INT8_LOGIT_TOL, INT8_NEAR_TIE)
    q_eng = q["warm"]["engine"]
    q_payload = q_eng.export_prefix_pages(q["warm"]["system"])
    q_eng.shutdown()
    runs["int8"] = q

    log(f"  (e) speculation (ngram, K={SPEC_K}) and the loop (N="
        f"{LOOP_NS[0]}) over a warm float32 cache")
    spec = runs["spec_loop"] = prefix_serve(
        pgen, model, "cuda", dict(SPEC, loop_steps=LOOP_NS[0],
                                  prefix_cache=True))
    check_prefix_ragged("spec + loop warm", spec)
    check_prefix_warm("spec + loop warm", spec, None)
    if not spec["loop"]["replays"]:
        fail("spec + loop warm: the loop never ran")
    seen, between = {}, 0
    for i, (kind, g) in enumerate(spec["events"]):
        if kind == "replay":
            if id(g) in seen and any(
                    k == "cow" for k, _ in spec["events"][seen[id(g)]:i]):
                between += 1
            seen[id(g)] = i
    if not between:
        fail("spec + loop warm: no copy on write fell between two replays "
             "of one captured loop graph")
    log(f"  spec + loop: {between} replays of a captured graph came after "
        f"a copy on write since its previous replay (copies in place, the "
        f"graph's pool addresses hold); accepted "
        f"{spec['stats'].get('generation.spec_accepted_tokens', 0)} drafts")
    hold_prefix(f"spec + loop (N={LOOP_NS[0]}) vs spec off N=1, warm card",
                spec, warm, cpu_model, logits=False)

    log("  (f) the page service: export the system run, import it into a "
        "fresh card engine")
    eng = warm["engine"]
    payload = eng.export_prefix_pages(warm["system"])
    pages = eng.cache.match_prefix_full(warm["system"])[0]
    n_pages = PREFIX_SYSTEM // ENGINE["page_size"]
    if len(pages) != n_pages or payload["k"].shape[1] != n_pages:
        fail(f"export covers {payload['k'].shape[1]} pages, want {n_pages}")
    for name, key in (("k_pool", "k"), ("v_pool", "v")):
        own = getattr(eng.cache, name)[:, list(pages)]
        if not np.array_equal(payload[key].numpy(), own):
            fail(f"the exported {key} differs from the pool's own bytes")
    eng.shutdown()
    imp = runs["import"] = prefix_import_run(pgen, model, payload)
    if imp["added"] != n_pages or imp["hits"] != [PREFIX_SYSTEM]:
        fail(f"import indexed {imp['added']} pages and the first request "
             f"hit {imp['hits']}, want {n_pages} and {PREFIX_SYSTEM}")
    want = len(imp["prompts"][0]) - PREFIX_SYSTEM
    if prefix_counters(imp)["prefill_tokens_total"] != want:
        fail(f"the importing engine prefilled "
             f"{prefix_counters(imp)['prefill_tokens_total']} tokens, want "
             f"the suffix's {want}")
    hold_prefix("imported run vs (a) warm card", imp, warm, cpu_model)
    f32 = pgen.GenerationEngine(model, pgen.GenerationConfig(
        **ENGINE, **PREFIX_ENGINE, prefix_cache=True), start=False)
    refused = f32.import_prefix_pages(q_payload)
    free = f32.cache.num_free_pages
    f32.shutdown()
    if refused != 0 or free != ENGINE["num_pages"]:
        fail(f"an int8 payload imported into a float32 engine indexed "
             f"{refused} pages ({free} free)")
    log(f"  exported {n_pages} pages bitwise the pool's own; the importing "
        f"engine's first request hit {PREFIX_SYSTEM} tokens and prefilled "
        f"{want}; an int8 payload into a float32 engine: {refused} pages")
    return runs


def prefix_import_run(pgen, model, payload):
    """A fresh card engine that imports `payload` before serving phase
    12's request 0 alone (through the ragged spies)."""
    from paddle_tpu_torch.profiler.monitor import StatRegistry

    reg = StatRegistry()
    eng = pgen.GenerationEngine(model, pgen.GenerationConfig(
        **ENGINE, **PREFIX_ENGINE, prefix_cache=True),
        metrics=pgen.GenerationMetrics(registry=reg), start=False)
    added = eng.import_prefix_pages(payload)
    prompts = prefix_traffic()[0][:1]
    first_seq = eng.scheduler._next_seq
    records = spy_ragged(eng)
    h = eng.submit(prompts[0], max_new_tokens=MAX_NEW)
    eng.run_until_idle()
    run = dict(results=[h.result(timeout=60)], records=records,
               first_seq=first_seq, prompts=prompts, stats=reg.stats(),
               hits=[h.prefix_hit_tokens], added=added)
    eng.shutdown()
    return run


def prefix_numbers(card, runs):
    """Phase 12's numbers: time to first token of the seven warm
    requests, prefill tokens, tokens/s and peak pages in use, cold
    against warm; the device time of one copy on write (every layer's K
    and V pages) and of one 32-page export and import."""
    from torch.profiler import ProfilerActivity, profile

    def line(label, run):
        toks = sum(len(r.token_ids) for r in run["results"])
        t = sorted(run["ttft"][1:1 + PREFIX_SHARED])
        c = prefix_counters(run)
        return (f"{label}: TTFT of requests 1-{PREFIX_SHARED} median "
                f"{t[len(t) // 2] * 1e3:.1f} ms, max {t[-1] * 1e3:.1f} ms; "
                f"prefill tokens {c['prefill_tokens_total']}; "
                f"{toks / run['wall']:.1f} tokens/s ({run['wall']:.3f} s); "
                f"peak pages in use {run['peak_pages']}")

    for label, cold, warm in (
            ("ragged", runs["cold"], runs["warm"]),
            ("legacy", runs["legacy"]["cold"], runs["legacy"]["warm"]),
            ("one-shot", runs["one_shot"]["cold"],
             runs["one_shot"]["warm"]),
            ("int8 ragged", runs["int8"]["cold"], runs["int8"]["warm"])):
        log(f"  [{card}] prefix {line(label + ' cold', cold)}")
        log(f"  [{card}] prefix {line(label + ' warm', warm)}")
    log(f"  [{card}] prefix {line('spec + loop warm', runs['spec_loop'])}")
    from paddle_tpu_torch import generation as pgen

    n = PREFIX_SYSTEM // ENGINE["page_size"]
    for dtype in (torch.float32, torch.int8):
        pool = pgen.DeviceKVPool(MODEL["num_layers"], MODEL["num_heads"],
                                 MODEL["head_dim"], ENGINE["num_pages"],
                                 ENGINE["page_size"], dtype=dtype)
        cow = []

        def copy():
            pool._copy_page_storage(3, 7)

        for _ in range(5):
            copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            copy()
        torch.cuda.synchronize()
        cow.append((time.perf_counter() - t0) / 50)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                copy()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        cow.append(sum(us for us, _ in kernels.values()) / 50)
        cow.append(sum(k for _, k in kernels.values()) / 50)
        pages = list(range(n))
        payload = pool.export_pages(pages)

        def export():
            pool.export_pages(pages)

        def install():
            pool._install_pages(pages, *payload)

        walls = {}
        for name, fn in (("export", export), ("import", install)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 20
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            dev = sum(us for us, _ in device_kernels(prof).values()) / 20
            walls[name] = (wall, dev)
        nbytes = sum(t.numel() * t.element_size() for t in payload)
        dt = str(dtype).replace("torch.", "")
        log(f"  [{card}] {dt} pool ({MODEL['num_layers']} layers, 512 pages "
            f"of 16): one copy on write (K and V of every layer"
            + (", scale rows too" if dtype == torch.int8 else "")
            + f") {cow[0] * 1e6:.1f} us wall, "
            + (f"{cow[1]:.1f} us of device time in {cow[2]:.0f} kernels "
               f"(torch.profiler)" if cow[1] > 0
               else "device time not measured") + "; "
            + "; ".join(
                f"{name} of {n} pages ({nbytes / 2**20:.1f} MiB) "
                f"{w * 1e3:.3f} ms wall, "
                + (f"{d / 1e3:.3f} ms of device time (copies and "
                   f"gathers, torch.profiler)" if d > 0
                   else "device time not measured")
                for name, (w, d) in walls.items()))


def ragged_shape_numbers(pa, card):
    """The ragged kernel at speculation's verify shape and at the decode
    loop's axis (phase 2's two new cases), on float32 and int8 pools:
    its time, its plain version's and its bound."""
    for kv_dtype in (torch.float32, torch.int8):
        for name, spec in (
                ("verify 8 x 5 rows", dict(desc=spec_desc(
                    np.random.default_rng(10)), unowned=False)),
                ("loop axis 8 x 5 rows (3 verify, 3 decode, 2 dead)",
                 dict(desc=loop_desc(np.random.default_rng(10)),
                      stride=1 + SPEC_K))):
            case = make_case(np.random.default_rng(11), kv_dtype=kv_dtype,
                             **spec, **MAIN)
            args, kw = attn_args(case), case["scales"]
            ms = time_ms(lambda: pa.ragged_paged_attention_kernel(*args,
                                                                  **kw), 200)
            plain_ms = time_ms(lambda: pa.ragged_paged_attention_torch(
                *args, **kw), 50)
            bound_ms, bound_by, _, _ = bound_of(case)
            log(f"  [{card}] ragged_paged_attention "
                f"({str(kv_dtype).replace('torch.', '')} pools) at {name}, "
                f"H=12, D=64, pages bucket 64: {ms * 1e3:.1f} us; plain "
                f"version {plain_ms * 1e3:.1f} us; bound "
                f"{bound_ms * 1e3:.2f} us by {bound_by} = "
                f"{bound_ms / ms:.1%} of bound"
                f"{paged_blocks(pa, 'ragged_paged_attention', case)}")


def serving_numbers(card, runs):
    """(f) For spec {off, on} x N {1, 4} on float32 and int8 pools, and
    LONG_LOOP_RUNS at N=8:
    tokens/s, ms per token, host fetches per token (one a sampling step
    or loop call), the acceptance rate, the device idle share under
    torch.profiler (the traffic's second pass on the measured engine;
    the float32 runs of SERVING_PROFILED only),
    and for the loops the capture time per pages bucket, one iteration's
    device time live and masked, its kernels, and the masked tail's
    device time in the run."""
    for (kv_dtype, spec, n), run in runs.items():
        st = run["stats"]
        toks = st["generation.tokens_total"]
        fetches = st["generation.steps_total"]
        line = (f"  [{card}] {serving_label(kv_dtype, spec, n)}: "
                f"{toks / run['wall']:.1f} tokens/s, "
                f"{run['wall'] / toks * 1e3:.3f} ms per token, "
                f"{fetches / toks:.4f} host fetches per token "
                f"({fetches} fetches, {toks} tokens, {run['wall']:.3f} s)")
        if spec:
            acc = st["generation.spec_accepted_tokens"]
            prop = st["generation.spec_proposed_tokens"]
            line += (f"; acceptance {acc / max(prop, 1):.3f} ({acc} of "
                     f"{prop} drafts)")
        loop = run["loop"]
        if loop:
            probe = run["extra"]
            wasted = sum(n - it for it in loop["iters"])
            cap = loop["capture_s"]
            line += (f"; loop path {st['generation.decode_host_fetches_per_token']}"
                     f" fetches per token over {loop['replays']} replays; "
                     f"capture {np.mean(cap):.3f} s per pages bucket "
                     f"({len(cap)} captures); one iteration "
                     f"{probe['live_ms']:.3f} ms of device time live, "
                     f"{probe['dead_ms']:.3f} ms masked, "
                     f"{probe['kernels']:.0f} kernels (torch.profiler of "
                     f"one replay); masked tail "
                     f"{wasted} iterations = {wasted * probe['dead_ms']:.2f} "
                     f"ms of device time")
        log(line)
        if run["extra"]["profile"] is None:
            log("    not profiled: left out to keep the script's time "
                "(SERVING_PROFILED)")
            continue
        wall, busy = run["extra"]["profile"]["wall"], \
            run["extra"]["profile"]["busy"]
        if busy > 0:
            log(f"    under torch.profiler (the card traced): wall "
                f"{wall:.3f} s, kernels busy {busy:.3f} s, idle share "
                f"{1 - busy / wall:.1%}")
        else:
            log("    torch.profiler recorded no device time: device idle "
                "share not measured")


# ------------------------------ the serving fleet ----------------------------


def reset_fleet_stats():
    """Zero the process's fleet.* counters: every FleetRouter of this
    process counts into them, so each fleet run starts from 0."""
    from paddle_tpu_torch.profiler.monitor import StatRegistry
    from paddle_tpu_torch.serving import fleet as fleet_mod

    reg = StatRegistry.instance()
    for name in list(reg.stats()):
        if name.startswith(fleet_mod.PREFIX):
            reg.get_stat(name).reset()


def fleet_stat(name):
    from paddle_tpu_torch.profiler.monitor import StatRegistry
    from paddle_tpu_torch.serving import fleet as fleet_mod

    return StatRegistry.instance().get_stat(fleet_mod.PREFIX + name).get()


def replica_stat(fl, name, stat):
    """One generation.* counter of an in-process replica (0 untouched)."""
    return fl._replicas[name].engine.metrics.snapshot().get(
        "generation." + stat, 0)


def on_device(fn):
    """``(fn(), wall seconds, device ms)``: the device time between CUDA
    events around the call on the current stream (None off the card)."""
    cuda = torch.cuda.is_available()
    if cuda:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
    t0 = time.perf_counter()
    out = fn()
    if not cuda:
        return out, time.perf_counter() - t0, None
    e1.record()
    e1.synchronize()
    return out, time.perf_counter() - t0, e0.elapsed_time(e1)


def fleet_traffic():
    """Phase 13's prompts: phase 12's 7 requests sharing the 512-token
    system prompt and the conversation's first turn (turn 2 comes later,
    with that run's own answer).  Returns (wave, system, turn 2's new
    tokens)."""
    prompts, system, new2 = prefix_traffic()
    return prompts[:PREFIX_SHARED] + [prompts[-1]], system, new2


def fleet_sampling(pgen, i):
    return (pgen.SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                seed=300 + i)
            if i in FLEET_STOCHASTIC else pgen.SamplingParams())


def fleet_config(pgen, **kw):
    return pgen.GenerationConfig(
        **{**ENGINE, **PREFIX_ENGINE, "prefix_cache": True, **kw})


def fleet_oracle(pgen, model, settings=None, wave=None):
    """The traffic on ONE cold card engine: the wave together, then turn
    2 (turn 1's prompt, its answer and 24 new tokens) when `wave` is the
    whole fleet traffic; `wave` alone otherwise."""
    whole = wave is None
    if whole:
        wave, _, new2 = fleet_traffic()
    eng = pgen.GenerationEngine(model, fleet_config(
        pgen, prefix_cache=False, **(settings or {})), start=False)
    handles = [eng.submit(p, max_new_tokens=MAX_NEW,
                          sampling=fleet_sampling(pgen, i))
               for i, p in enumerate(wave)]
    eng.run_until_idle()
    prompts = list(wave)
    if whole:
        prompts.append(wave[-1] + handles[-1].result(timeout=60).token_ids
                       + new2)
        handles.append(eng.submit(prompts[-1], max_new_tokens=MAX_NEW,
                                  sampling=fleet_sampling(pgen,
                                                          len(wave))))
        eng.run_until_idle()
    results = [h.result(timeout=60) for h in handles]
    eng.shutdown()
    return dict(prompts=prompts, results=results)


def hold_fleet(label, run, oracle, cpu_model, near_tie=NEAR_TIE,
               stochastic=FLEET_STOCHASTIC):
    """Phase 4's rule between a fleet run and the oracle on the requests
    whose prompts are equal (turn 2 carries each run's own turn-1
    answer): every stream `MAX_NEW` tokens long, greedy streams identical
    or diverging only where the CPU full recompute's top-2 logit gap
    after the shared prefix is < `near_tie`.  Returns the identical
    count."""
    same = 0
    for i, (pa_, pb_) in enumerate(zip(run["prompts"], oracle["prompts"])):
        r = run["results"][i]
        if r.finish_reason != "length" or len(r.token_ids) != MAX_NEW:
            fail(f"{label} request {i} finished {r.finish_reason!r} with "
                 f"{len(r.token_ids)} tokens, want {MAX_NEW}")
        if pa_ != pb_:
            log(f"  {label} request {i}: prompts differ (turn 1's answers "
                f"diverged at a near tie): not compared")
            continue
        at, bt = r.token_ids, oracle["results"][i].token_ids
        if at == bt:
            same += 1
            continue
        k = next((j for j, (x, y) in enumerate(zip(at, bt)) if x != y),
                 min(len(at), len(bt)))
        gap = top2_gap(cpu_model, list(pb_) + list(bt[:k]))
        kind = "stochastic" if i in stochastic else "greedy"
        log(f"  {label} request {i} ({kind}): streams diverge at token "
            f"{k}; CPU top-2 gap {gap:.3e}")
        if kind == "greedy" and gap >= near_tie:
            fail(f"{label}: greedy request {i} diverges at token {k} where "
                 f"the top-2 gap is {gap:.3e} >= {near_tie}")
    log(f"  {label}: {same} of {len(run['results'])} streams identical")
    return same


class StepSpy:
    """Counts one in-process replica's ragged step calls and times its
    engine steps (the longest one is what a wedge clock would see)."""

    def __init__(self, eng):
        self.eng = eng
        self.restart()
        real_ragged, real_step = eng._ragged.step, eng.step

        def ragged(*args):
            self.ragged += 1
            return real_ragged(*args)

        def step():
            t0 = time.perf_counter()
            try:
                return real_step()
            finally:
                self.longest = max(self.longest, time.perf_counter() - t0)

        eng._ragged.step = ragged
        eng.step = step   # the worker thread calls self.step()

    def restart(self):
        """Count from here (after a warm-up request)."""
        self.ragged = 0
        self.longest = 0.0
        lp = self.eng._loop
        self.loop0 = (lp.replays, lp.captures) if lp is not None else None

    def want_launches(self):
        """num_layers x (ragged steps + N x (loop replays + captures)) of
        this replica since the spy went on or restarted."""
        calls = 0
        lp = self.eng._loop
        if lp is not None:
            calls = lp.loop_steps * (lp.replays - self.loop0[0]
                                     + lp.captures - self.loop0[1])
        return MODEL["num_layers"] * (self.ragged + calls)


def fleet_check_launches(label, spies):
    got = read_launches()
    want = sum(s.want_launches() for s in spies)
    log(f"  {label}: ragged steps per replica "
        f"{[s.ragged for s in spies]}; ragged launches "
        f"{got['ragged_paged_attention']} (num_layers x (the replicas' "
        f"steps + N x loop calls) = {want}); longest step "
        f"{max(s.longest for s in spies):.3f} s")
    if got["ragged_paged_attention"] != want or want == 0:
        fail(f"{label}: ragged kernel launched "
             f"{got['ragged_paged_attention']} times, want {want}")
    others = {k: v for k, v in got.items()
              if k != "ragged_paged_attention" and v}
    if others:
        fail(f"{label}: a fleet of ragged replicas launched {others}")


def fleet_inproc(pgen, model, names, start, roles=None, settings=None,
                 **fleet_kw):
    """A FleetRouter over in-process replicas sharing `model`, each with
    its step spy."""
    from paddle_tpu_torch.serving import FleetConfig, FleetRouter, ReplicaSpec

    reset_fleet_stats()
    specs = [ReplicaSpec(n, model, fleet_config(pgen, **(settings or {})),
                         role=(roles or {}).get(n, "mixed"))
             for n in names]
    fl = FleetRouter(specs, FleetConfig(start=start, seed=0, **fleet_kw))
    spies = [StepSpy(fl._replicas[n].engine) for n in names]
    return fl, spies


def fleet_drive(pgen, fl, session=True, wait=None):
    """Phase 13's traffic through fleet `fl`: request 0 until its first
    token (so the others find its pages), the rest of the wave (turn 1
    under session "chat" when `session`), then turn 2 under the same
    session.  `wait(handles)` drives a stepped fleet; a threaded one is
    waited on.  Returns the prompts, results, handles and wall time."""
    wave, _, new2 = fleet_traffic()
    wait = wait or (lambda hs: [h.result(timeout=300) for h in hs])
    handles = []

    def submit(i, prompt):
        handles.append(fl.submit(
            prompt, max_new_tokens=MAX_NEW, sampling=fleet_sampling(pgen, i),
            session="chat" if session and i >= len(wave) - 1 else None))

    t0 = time.perf_counter()
    submit(0, wave[0])
    deadline = time.monotonic() + 120
    while handles[0].first_token_s is None:
        if time.monotonic() > deadline:
            fail("the fleet's request 0 produced no token in 120 s")
        if fl.config.start:
            time.sleep(0.002)
        else:
            for rep in fl._replicas.values():
                rep.transport.pump()
    for i in range(1, len(wave)):
        submit(i, wave[i])
    wait(handles)
    prompts = list(wave)
    prompts.append(wave[-1] + handles[-1].result(timeout=60).token_ids
                   + new2)
    submit(len(wave), prompts[-1])
    wait(handles)
    wall = time.perf_counter() - t0
    return dict(prompts=prompts, results=[h.result(timeout=60)
                                          for h in handles],
                handles=handles, wall=wall)


def warm_ttft(run):
    t = sorted(h.first_token_s - h.submitted_s
               for h in run["handles"][1:PREFIX_SHARED])
    return t[len(t) // 2], t[-1]


def fleet_throughput(pgen, model, prompts, names):
    """Phase 3's 8 requests (distinct prompts, so the prefix rung's hash
    spreads them) through a threaded in-process fleet of `names`: wall
    and tokens."""
    fl, spies = fleet_inproc(pgen, model, names, start=True)
    warm = fl.submit([1, 2, 3], max_new_tokens=2)
    warm.result(timeout=60)
    reset_launches()
    for s in spies:
        s.restart()
    t0 = time.perf_counter()
    handles = [fl.submit(p, max_new_tokens=MAX_NEW,
                         sampling=fleet_sampling(pgen, i))
               for i, p in enumerate(prompts)]
    results = [h.result(timeout=300) for h in handles]
    wall = time.perf_counter() - t0
    fleet_check_launches(f"{len(names)}-replica fleet, phase 3's traffic",
                         spies)
    per = {n: replica_stat(fl, n, "requests_total") for n in names}
    fl.shutdown()
    return dict(wall=wall, tokens=sum(len(r.token_ids) for r in results),
                per_replica=per, results=results,
                longest=max(s.longest for s in spies))


def phase_fleet(pgen, model, cpu_model, prompts):
    """Phase 13: the serving fleet at GPT-2-small width (phase 12's model,
    pool, chunks and system-prompt traffic, the prefix cache on in every
    replica).  (a) two in-process replicas on affinity routing; (b) a
    drain in mid-decode, live and cold; (c) a prefill/decode split; (d)
    two loop replicas stepping at once; (e) a `proc` and a `tcp` replica
    on the card: peer-to-peer adoption, a SIGKILL, the supervisor; (f) an
    int8 replica beside a float32 one.  Returns the numbers."""
    import os

    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          FleetSupervisor, ReplicaSpec)

    out = {}
    oracle = fleet_oracle(pgen, model)
    log(f"  oracle: one cold card engine, {len(oracle['results'])} "
        f"requests (prompts {min(map(len, oracle['prompts']))}.."
        f"{max(map(len, oracle['prompts']))} tokens)")

    # (a) affinity over two threaded in-process replicas
    log("  (a) two in-process replicas, affinity routing, worker threads")
    fl1, spies1 = fleet_inproc(pgen, model, ["solo"], start=True)
    reset_launches()
    one = fleet_drive(pgen, fl1)
    fleet_check_launches("1-replica fleet", spies1)
    fl1.shutdown()
    hold_fleet("1-replica fleet vs oracle", one, oracle, cpu_model)
    fl, spies = fleet_inproc(pgen, model, ["a0", "a1"], start=True)
    reset_launches()
    run = fleet_drive(pgen, fl)
    fleet_check_launches("2-replica fleet", spies)
    rungs = {r: fleet_stat("routed_" + r) for r in
             ("affinity", "prefix", "balance", "spill", "role", "random")}
    chat = fl.replica_of("chat")
    per = {n: replica_stat(fl, n, "requests_total") for n in ("a0", "a1")}
    log(f"  requests routed by rung {rungs}; session 'chat' on {chat}; "
        f"requests per replica {per}")
    if rungs["prefix"] < PREFIX_SHARED - 1:
        fail(f"fleet.routed_prefix {rungs['prefix']} < {PREFIX_SHARED - 1}")
    if rungs["affinity"] != 1:
        fail(f"turn 2 was not routed by the session rung ({rungs})")
    hold_fleet("2-replica fleet vs oracle", run, oracle, cpu_model)
    a_run = run
    out["ttft"] = (warm_ttft(one), warm_ttft(run))
    out["rungs"] = rungs
    out["longest"] = {"a": max(s.longest for s in spies + spies1)}
    fl.shutdown()
    solo = fleet_throughput(pgen, model, prompts, ["t0"])
    pair = fleet_throughput(pgen, model, prompts, ["t0", "t1"])
    out["throughput"] = (solo, pair)
    log(f"  phase 3's traffic: 1 replica {solo['tokens'] / solo['wall']:.1f}"
        f" tokens/s, 2 replicas {pair['tokens'] / pair['wall']:.1f} "
        f"(requests per replica {pair['per_replica']})")
    hold_fleet("phase 3's traffic, 2 replicas vs 1",
               dict(prompts=list(prompts), results=pair["results"]),
               dict(prompts=list(prompts), results=solo["results"]),
               cpu_model)

    # (b) a drain in mid-decode: live, then cold
    log("  (b) a drain in mid-decode, stepped replicas: live, then cold")
    mig = {"export": [], "import": [], "bytes": [], "bitwise": [],
           "export_dev": [], "import_dev": [], "verify_s": 0.0}
    for live in (True, False):
        fl, spies = fleet_inproc(pgen, model, ["b0", "b1"], start=False,
                                 live_migration=live)
        engines = {n: fl._replicas[n].engine for n in ("b0", "b1")}
        for eng in engines.values():
            real_export, real_import = eng._export_sequence, \
                eng.import_sequence

            def export(state, eng=eng, real=real_export):
                snap, wall, dev = on_device(lambda: real(state))
                mig["export"].append(wall)
                mig["export_dev"].append(dev)
                mig["bytes"].append(sum(
                    t.numel() * t.element_size()
                    for t in (snap["k"], snap["v"])))
                return snap

            def import_(snap, handle=None, eng=eng, real=real_import):
                ok, wall, dev = on_device(lambda: real(snap, handle))
                mig["import"].append(wall)
                mig["import_dev"].append(dev)
                if ok:
                    # the check's own export is kept out of the drain's
                    # time
                    t0 = time.perf_counter()
                    fut = snap["future"] if handle is None else handle
                    st = next(s for s in eng.scheduler.active()
                              if s.handle is fut)
                    again = eng.cache.export_pages(
                        eng.cache.page_table(st.seq_id))
                    mig["bitwise"].append(
                        torch.equal(again[0], snap["k"])
                        and torch.equal(again[1], snap["v"]))
                    mig["verify_s"] += time.perf_counter() - t0
                return ok

            eng._export_sequence = export
            eng.import_sequence = import_
        wave, _, new2 = fleet_traffic()
        reset_launches()
        # request 0 first, to its first token: the fleet index then holds
        # the system prompt's pages and routes the rest to the same home
        handles = [fl.submit(wave[0], max_new_tokens=MAX_NEW,
                             sampling=fleet_sampling(pgen, 0),
                             session="home")]
        home = fl.replica_of("home")
        eng = engines[home]
        while handles[0].first_token_s is None:
            eng.step()
        handles += [fl.submit(p, max_new_tokens=MAX_NEW,
                              sampling=fleet_sampling(pgen, i),
                              session="chat" if i == len(wave) - 1
                              else None)
                    for i, p in enumerate(wave) if i]
        for _ in range(600):
            act = eng.scheduler.active()
            if len(act) == len(wave) and all(s.n_generated >= 2
                                             for s in act):
                break
            eng.step()
        else:
            fail("the drained replica's sequences never all reached decode")
        emitted = sum(s.n_generated for s in eng.scheduler.active())
        verify0 = mig["verify_s"]
        t0 = time.perf_counter()
        fl.drain(home, migrate=True)
        drain_s = time.perf_counter() - t0 - (mig["verify_s"] - verify0)
        fl.run_until_idle()
        prompts2 = list(wave)
        prompts2.append(wave[-1] + handles[-1].result(timeout=60).token_ids
                        + new2)
        handles.append(fl.submit(prompts2[-1], max_new_tokens=MAX_NEW,
                                 sampling=fleet_sampling(pgen, len(wave)),
                                 session="chat"))
        fl.run_until_idle()
        res = dict(prompts=prompts2,
                   results=[h.result(timeout=60) for h in handles])
        fleet_check_launches(f"{'live' if live else 'cold'} drain", spies)
        replay = fleet_stat("migrated_replay_tokens")
        moved = fleet_stat("live_migrated_total")
        log(f"  {'live' if live else 'cold'} drain of {home} after "
            f"{emitted} tokens: {drain_s * 1e3:.1f} ms; "
            f"live_migrated_total {moved}, migrated_replay_tokens {replay},"
            f" migrated_total {fleet_stat('migrated_total')}")
        if live and (moved < 1 or replay != 0):
            fail(f"live drain: live_migrated_total {moved}, "
                 f"migrated_replay_tokens {replay} (want >= 1 and 0)")
        if live and not (mig["bitwise"] and all(mig["bitwise"])):
            fail(f"a migrated sequence's pages exported again on the "
                 f"importer differ from the snapshot: {mig['bitwise']}")
        if not live and replay <= 0:
            fail(f"cold drain: migrated_replay_tokens {replay}, want > 0")
        hold_fleet(f"{'live' if live else 'cold'} drain vs oracle", res,
                   oracle, cpu_model)
        if live:
            out["migration"] = dict(mig, drain_s=drain_s, moved=moved)
        else:
            out["cold_replay"] = replay
        fl.shutdown()

    # (c) the prefill/decode split
    log("  (c) one prefill and one decode replica, worker threads")
    fl, spies = fleet_inproc(pgen, model, ["pf", "dc"], start=True,
                             roles={"pf": "prefill", "dc": "decode"},
                             pd_prefill_threshold_tokens=64)
    # the handoff's latency: the prefill replica's export (the park) to
    # the decode replica's import done, per stream
    parked, walls = {}, []
    pf_eng, dc_eng = fl._replicas["pf"].engine, fl._replicas["dc"].engine
    real_export, real_import = pf_eng._export_sequence, dc_eng.import_sequence

    def park(state):
        parked[id(state.request.future)] = time.perf_counter()
        return real_export(state)

    def place(snap, handle=None):
        ok = real_import(snap, handle)
        fut = snap["future"] if handle is None else handle
        if ok and id(fut) in parked:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - parked.pop(id(fut)))
        return ok

    pf_eng._export_sequence = park
    dc_eng.import_sequence = place
    reset_launches()
    run = fleet_drive(pgen, fl, session=False)
    fleet_check_launches("P/D split", spies)
    handoffs = fleet_stat("pd_handoffs")
    pf_tokens = replica_stat(fl, "pf", "tokens_total")
    log(f"  pd_handoffs {handoffs} of {len(run['results'])} requests; the "
        f"prefill replica sampled {pf_tokens} tokens; replay "
        f"{fleet_stat('migrated_replay_tokens')}")
    if handoffs != len(run["results"]):
        fail(f"fleet.pd_handoffs {handoffs} != {len(run['results'])}")
    if pf_tokens != len(run["results"]):
        fail(f"the prefill replica sampled {pf_tokens} tokens, want one "
             f"per request ({len(run['results'])})")
    hold_fleet("P/D split vs oracle", run, oracle, cpu_model)
    out["handoff_s"] = walls
    out["longest"]["c"] = max(s.longest for s in spies)
    fl.shutdown()

    # (d) two loop replicas stepping at once
    log(f"  (d) two in-process replicas with loop_steps={FLEET_LOOP}, "
        f"stepping at once; a capture beside the sibling's steps")
    fl, spies = fleet_inproc(pgen, model, ["l0", "l1"], start=True,
                             settings=dict(loop_steps=FLEET_LOOP),
                             routing="random")
    engines = [fl._replicas[n].engine for n in ("l0", "l1")]
    beside = []
    for me, sib in ((0, 1), (1, 0)):
        lp = engines[me]._loop
        real_capture = lp._capture

        def capture(bucket_p, state, real=real_capture, sib=engines[sib]):
            # let the sibling be inside a step when the capture starts
            deadline = time.monotonic() + 2.0
            while not sib.in_step and time.monotonic() < deadline:
                time.sleep(0.0005)
            seq0 = sib.step_seq
            g = real(bucket_p, state)
            beside.append(sib.step_seq - seq0)
            return g

        lp._capture = capture
    reset_launches()
    run = fleet_drive(pgen, fl, session=False)
    fleet_check_launches(f"loop N={FLEET_LOOP} fleet", spies)
    caps = [e._loop.captures for e in engines]
    log(f"  captures per replica {caps}; sibling steps completed during "
        f"each capture {beside}")
    if engines[0]._loop.use_graph and not any(beside):
        fail("no capture overlapped a sibling's step")
    hold_fleet(f"loop N={FLEET_LOOP} fleet vs (a)'s N=1 fleet", run,
               a_run, cpu_model)
    out["longest"]["d"] = max(s.longest for s in spies)
    busy = max(engines, key=lambda e: e._loop.replays)
    with busy._lock:   # the worker thread waits out the probe
        probe = loop_probe(busy, bitwise=True)
    log(f"  a captured replay bitwise the eager loop: {probe['bitwise']}")
    out["beside"] = beside
    fl.shutdown()

    # (e) out of process: proc and tcp replicas on the card
    log("  (e) a proc and a tcp replica on the card")
    reset_fleet_stats()
    cfg = fleet_config(pgen)
    fcfg = FleetConfig(start=True, seed=0, page_codec="compressed",
                       async_adoption=False)
    t0 = time.perf_counter()
    fl = FleetRouter([ReplicaSpec("p0", model, cfg, transport="proc")],
                     fcfg)
    spawn = {"proc": time.perf_counter() - t0}
    t0 = time.perf_counter()
    fl.add_replica(ReplicaSpec("t0", model, cfg, transport="tcp"))
    spawn["tcp"] = time.perf_counter() - t0
    for name in ("p0", "t0"):
        d = fl._replicas[name].transport.describe()
        log(f"  {name}: {fl._replicas[name].kind} child pid {d['pid']} "
            f"(this process {os.getpid()}), device {d['device']}; spawn to "
            f"describe {spawn['proc' if name == 'p0' else 'tcp']:.2f} s")
        if d["pid"] == os.getpid() or not d["device"].startswith(
                cfg.device):
            fail(f"replica {name} is not a child process on "
                 f"{cfg.device}: {d}")
    wave, system, _ = fleet_traffic()
    fl._sessions["warm"] = "p0"
    h0 = fl.submit(wave[0], max_new_tokens=MAX_NEW,
                   sampling=fleet_sampling(pgen, 0), session="warm")
    h0.result(timeout=120)
    deadline = time.monotonic() + 30
    ps = ENGINE["page_size"]
    while True:
        fl.stats_snapshot()
        hit = fl._page_index.lookup(wave[1], ps)
        if hit is not None and hit[1] >= PREFIX_SYSTEM:
            break
        if time.monotonic() > deadline:
            fail(f"the fleet index never learned p0's system pages: {hit}")
        time.sleep(0.05)
    adopter = fl._replicas["t0"].transport
    fetch = []
    real_fetch = adopter.import_prefix_from

    def import_from(*a, **kw):
        t0 = time.perf_counter()
        res = real_fetch(*a, **kw)
        fetch.append((time.perf_counter() - t0, res))
        return res

    adopter.import_prefix_from = import_from
    fl._sessions["adopt"] = "t0"
    h1 = fl.submit(wave[1], max_new_tokens=MAX_NEW,
                   sampling=fleet_sampling(pgen, 1), session="adopt")
    h1.result(timeout=120)
    snap = fl.stats_snapshot()
    t0_prefill = snap["replicas"]["t0"]["generation"][
        "generation.prefill_tokens_total"]
    adopted = fleet_stat("pages_adopted")
    relay = fleet_stat("page_relay_bytes")
    wire, raw = fleet_stat("page_p2p_bytes"), fleet_stat("page_raw_bytes")
    log(f"  adoption on t0: pages_adopted {adopted}, page_relay_bytes "
        f"{relay}, wire {wire} of raw {raw} bytes; t0 prefilled "
        f"{t0_prefill} tokens of {len(wave[1])} (hit {h1.prefix_hit_tokens})")
    if adopted < PREFIX_SYSTEM // ps or relay != 0 or not fetch:
        fail(f"peer-to-peer adoption: pages_adopted {adopted} (want >= "
             f"{PREFIX_SYSTEM // ps}), page_relay_bytes {relay} (want 0)")
    if t0_prefill != len(wave[1]) - PREFIX_SYSTEM:
        fail(f"the adopter prefilled {t0_prefill} tokens, want the suffix's "
             f"{len(wave[1]) - PREFIX_SYSTEM}")
    out["p2p"] = dict(wire=wire, raw=raw, wall=fetch[0][0])
    out["spawn"] = spawn
    # SIGKILL p0 in mid-stream: its streams move to t0
    victims = list(range(2, PREFIX_SHARED))
    hs = []
    for i in victims:
        fl._sessions[f"v{i}"] = "p0"
        hs.append(fl.submit(wave[i], max_new_tokens=MAX_NEW,
                            sampling=fleet_sampling(pgen, i),
                            session=f"v{i}"))
    tr = fl._replicas["p0"].transport
    deadline = time.monotonic() + 120
    while True:
        with tr._lock:
            emitted = [e["emitted"] for e in tr._inflight.values()]
        if len(emitted) == len(victims) and min(emitted) >= 2:
            break
        if time.monotonic() > deadline:
            fail(f"p0's streams never started: {emitted}")
        time.sleep(0.01)
    tr.kill()
    results = [h.result(timeout=300) for h in hs]
    dead = fleet_stat("replica_dead_total")
    log(f"  SIGKILL of p0 with {len(victims)} streams at {emitted} tokens: "
        f"replica_dead_total {dead}; every stream completed on t0")
    if dead != 1:
        fail(f"fleet.replica_dead_total {dead}, want 1")
    hold_fleet("the proc/tcp fleet vs oracle",
               dict(prompts=[wave[0], wave[1]] + [wave[i] for i in victims],
                    results=[h0.result(), h1.result()] + results),
               dict(prompts=[wave[0], wave[1]] + [wave[i] for i in victims],
                    results=[oracle["results"][i]
                             for i in [0, 1] + victims]),
               cpu_model, stochastic={k for k, i in enumerate(
                   [0, 1] + victims) if i in FLEET_STOCHASTIC})
    sup = FleetSupervisor(fl)
    t0 = time.perf_counter()
    deadline = time.monotonic() + 120
    while fl._replicas["p0"].state != "serving":
        if time.monotonic() > deadline:
            fail("FleetSupervisor.tick never brought p0 back")
        sup.tick()
        time.sleep(0.1)
    back = time.perf_counter() - t0
    fl._sessions["back"] = "p0"
    h = fl.submit(wave[0], max_new_tokens=MAX_NEW,
                  sampling=fleet_sampling(pgen, 0), session="back")
    r = h.result(timeout=120)
    log(f"  the supervisor brought p0 back in {back:.2f} s (restarts "
        f"{fleet_stat('supervisor_restart_total')}); it served a request "
        f"of {len(r.token_ids)} tokens")
    hold_fleet("the restarted p0 vs oracle",
               dict(prompts=[wave[0]], results=[r]),
               dict(prompts=[wave[0]], results=[oracle["results"][0]]),
               cpu_model)
    out["restart_s"] = back
    fl.shutdown()

    # (f) int8 beside float32
    log("  (f) an int8 replica beside a float32 one")
    q_oracle = fleet_oracle(pgen, model, INT8, wave=[wave[1]])
    reset_fleet_stats()
    fl = FleetRouter(
        [ReplicaSpec("f32", model, fleet_config(pgen)),
         ReplicaSpec("q8", model, fleet_config(pgen, **INT8))],
        FleetConfig(start=False, seed=0, async_adoption=False))
    fl._sessions["warm"] = "f32"
    hw = fl.submit(wave[0], max_new_tokens=MAX_NEW,
                   sampling=fleet_sampling(pgen, 0), session="warm")
    fl.run_until_idle()
    hw.result(timeout=60)
    f_eng, q_eng = fl._replicas["f32"].engine, fl._replicas["q8"].engine
    refused = q_eng.import_prefix_pages(f_eng.export_prefix_pages(system))
    fl._sessions["q"] = "q8"
    hq = fl.submit(wave[1], max_new_tokens=MAX_NEW,
                   sampling=fleet_sampling(pgen, 0), session="q")
    fl.run_until_idle()
    rq = hq.result(timeout=60)
    failed = fleet_stat("page_transfers_failed")
    log(f"  float32 pages offered to the int8 replica: import_prefix_pages "
        f"-> {refused}; page_transfers_failed {failed}, pages_adopted "
        f"{fleet_stat('pages_adopted')}; the int8 request's prefix hit "
        f"{hq.prefix_hit_tokens} (a cold prefill)")
    if refused != 0 or hq.prefix_hit_tokens != 0 \
            or fleet_stat("pages_adopted") != 0:
        fail("the int8 replica took float32 pages")
    hold_fleet("int8 replica vs one int8 engine",
               dict(prompts=[wave[1]], results=[rq]), q_oracle, cpu_model,
               near_tie=INT8_NEAR_TIE, stochastic=())
    fl.shutdown()
    return out


def fleet_numbers(card, out):
    """Phase 13's numbers."""
    log(f"  [{card}] fleet: requests routed by rung {out['rungs']}")
    (m1, x1), (m2, x2) = out["ttft"]
    log(f"  [{card}] fleet: TTFT of the warm requests 1-"
        f"{PREFIX_SHARED - 1}, median / max: one replica {m1 * 1e3:.1f} / "
        f"{x1 * 1e3:.1f} ms, two-replica fleet {m2 * 1e3:.1f} / "
        f"{x2 * 1e3:.1f} ms")
    solo, pair = out["throughput"]
    log(f"  [{card}] fleet: phase 3's 8 requests, one replica "
        f"{solo['tokens'] / solo['wall']:.1f} tokens/s ({solo['wall']:.3f} "
        f"s), two in-process replicas on one card "
        f"{pair['tokens'] / pair['wall']:.1f} tokens/s "
        f"({pair['wall']:.3f} s): {solo['wall'] / pair['wall']:.2f}x")
    mig = out["migration"]
    n = len(mig["bytes"])
    def dev(key):
        ms = [x for x in mig[key] if x is not None]
        return f"{np.median(ms):.2f} ms" if ms else "not measured"

    log(f"  [{card}] fleet: live migration of {n} sequences, per sequence "
        f"median export {np.median(mig['export']) * 1e3:.2f} ms wall / "
        f"{dev('export_dev')} on the device, import "
        f"{np.median(mig['import']) * 1e3:.2f} ms / {dev('import_dev')}, "
        f"{np.median(mig['bytes']) / 2**20:.1f} MiB (K and V); the drain "
        f"of {n} {mig['drain_s'] * 1e3:.1f} ms wall; the cold drain "
        f"replayed {out['cold_replay']} tokens")
    p2p = out["p2p"]
    log(f"  [{card}] fleet: peer-to-peer adoption of the system prompt, "
        f"compressed: {p2p['wire']} wire bytes of {p2p['raw']} raw "
        f"({p2p['wire'] / max(p2p['raw'], 1):.3f}), {p2p['wall']:.3f} s "
        f"wall")
    hs = out["handoff_s"]
    log(f"  [{card}] fleet: P/D handoff, park to placement, median "
        f"{np.median(hs) * 1e3:.1f} ms, max {max(hs) * 1e3:.1f} ms over "
        f"{len(hs)} handoffs")
    log(f"  [{card}] fleet: spawn to describe, proc "
        f"{out['spawn']['proc']:.2f} s, tcp {out['spawn']['tcp']:.2f} s; "
        f"supervisor restart {out['restart_s']:.2f} s")
    log(f"  [{card}] fleet: longest step of an in-process replica per run "
        f"{ {k: round(v, 3) for k, v in out['longest'].items()} } s "
        f"(the child replicas' steps: not measured)")


# ---------------------------- tensor parallel ----------------------------


def card_mesh(tp):
    """`tp` head shards, every one on card 0, named outright: tp_mesh puts
    two shards on one card only when asked."""
    from paddle_tpu_torch.parallel import tp_mesh

    return tp_mesh(tp, devices=["cuda:0"] * tp)


def phase_tp_kernels(pa, rng):
    """Phase 15 (a): each paged kernel per shard at tp 2 and 4 on phase
    2's main-path operands (12 heads), float32 and int8, both layouts:
    each shard's output against the unsharded kernel's heads (bitwise,
    else within KERNEL_TOL with the largest difference printed) and
    against its plain version's shard, one launch per shard.  Returns
    the kernel rows' worst shard-vs-plain error and whether every shard
    was bitwise."""
    mixed = main_path_desc(rng)
    lens = main_decode_lens(rng)
    kinds = [
        ("ragged_paged_attention",
         lambda **kw: make_case(rng, desc=mixed, **kw, **MAIN), attn_args,
         pa.ragged_paged_attention_kernel, pa.ragged_paged_attention_torch),
        ("paged_decode_attention",
         lambda **kw: make_decode_case(rng, lens=lens, **kw, **MAIN),
         decode_args, pa.paged_decode_attention_kernel,
         pa.paged_decode_attention_torch),
        ("chunk_prefill_attention",
         lambda **kw: make_chunk_case(rng, start=536, n=64, **kw, **MAIN),
         chunk_args, pa.chunk_prefill_attention_kernel,
         pa.chunk_prefill_attention_torch)]
    worst, all_bitwise = {}, True
    for name, make, args_of, kernel, plain in kinds:
        for kv_dtype, tag in ((torch.float32, ""), (torch.int8, "_int8")):
            for layout in ("token", "kernel"):
                case = make(layout=layout, kv_dtype=kv_dtype)
                args, scales = args_of(case), case["scales"]
                whole = kernel(*args, layout=layout, **scales)
                for tp in TP_DEGREES:
                    mesh = card_mesh(tp)
                    reset_launches()
                    shards = kernel(*args, layout=layout, mesh=mesh,
                                    **scales)
                    torch.cuda.synchronize()
                    n = read_launches()[name + tag]
                    ref = plain(*args, layout=layout, mesh=mesh, **scales)
                    hs = whole.shape[1] // tp
                    bitwise, err_whole, err_plain = True, 0.0, 0.0
                    for i, (got, want) in enumerate(zip(shards, ref)):
                        part = whole[:, i * hs:(i + 1) * hs]
                        bitwise &= torch.equal(got, part)
                        err_whole = max(err_whole,
                                        float((got - part).abs().max()))
                        err_plain = max(err_plain,
                                        float((got - want).abs().max()))
                    log(f"  {name + tag:29s} {layout:6s} tp {tp} "
                        f"({hs} heads a shard): {n} launches, shards vs "
                        f"the unsharded call bitwise={bitwise} max|diff|="
                        f"{err_whole:.3e}, vs plain max|diff|="
                        f"{err_plain:.3e}")
                    if n != tp:
                        fail(f"{name}{tag} at tp {tp} launched {n} times, "
                             f"want one a shard ({tp})")
                    for err, what in ((err_whole, "the unsharded call"),
                                      (err_plain, "its plain version")):
                        if not math.isfinite(err) or err > KERNEL_TOL:
                            fail(f"{name}{tag} tp {tp} {layout}: a shard "
                                 f"differs from {what} by {err:.3e} > "
                                 f"{KERNEL_TOL}")
                    all_bitwise &= bitwise
                    worst[name + tag] = max(worst.get(name + tag, 0.0),
                                            err_plain)
    return worst, all_bitwise


def phase_tp_ring(rng):
    """Phase 15 (b)'s quantized ring held element by element: at tp 4,
    every shard on card 0, on row-split products at the main path's
    width (72 packed rows, and 70, which pads), the card's result on
    every shard against the same ring on the CPU (bitwise, else within
    RING_ULPS ulps: a rounding that flipped on some hop moves a value by
    a 127th of its chunk's abs-max) and against the exact sum within
    ``2 tp max|sum| / 127``, the bound the CPU tests hold the JAX ring's
    arithmetic to.  Returns the worst error against the exact sum, as a
    share of that bound, and whether the card was bitwise the CPU."""
    from paddle_tpu_torch.parallel import quantized_ring_allreduce, tp_mesh

    d = MODEL["num_heads"] * MODEL["head_dim"]
    cpu_mesh = tp_mesh(TP_MAIN, devices=["cpu"] * TP_MAIN)
    worst, bitwise = 0.0, True
    for rows in (72, 70):
        parts = [torch.from_numpy(
            rng.standard_normal((rows, d // TP_MAIN)).astype(np.float32)
            @ (0.02 * rng.standard_normal((d // TP_MAIN, d))).astype(
                np.float32)) for _ in range(TP_MAIN)]
        card = quantized_ring_allreduce([p.cuda() for p in parts],
                                        card_mesh(TP_MAIN))
        cpu = quantized_ring_allreduce(parts, cpu_mesh)[0]
        exact = torch.stack(parts).double().sum(0)
        bound = 2 * TP_MAIN * float(exact.abs().max()) / 127
        ulps = RING_ULPS * float(torch.finfo(torch.float32).eps
                                 * cpu.abs().max())
        for i, got in enumerate(card):
            got = got.cpu()
            same = torch.equal(got, cpu)
            err_cpu = float((got - cpu).abs().max())
            err = float((got.double() - exact).abs().max())
            bitwise &= same
            worst = max(worst, err / bound)
            if not same and err_cpu > ulps:
                fail(f"the quantized ring on the card (shard {i}, {rows} "
                     f"rows) differs from the CPU's by {err_cpu:.3e} > "
                     f"{RING_ULPS} ulps ({ulps:.3e})")
            if not err <= bound:
                fail(f"the quantized ring (shard {i}, {rows} rows) is "
                     f"{err:.3e} from the exact sum, > {bound:.3e}")
        log(f"  quantized ring, tp {TP_MAIN}, [{rows}, {d}] partials: card "
            f"vs CPU bitwise={bitwise}, worst |ring - exact sum| "
            f"{worst:.3f} of the bound 2 tp max|sum| / 127")
    return worst, bitwise


def check_tp_run(label, run, tp, base, kernel="ragged_paged_attention",
                 calls=None):
    """A mesh run's launches (tp x num_layers x its step calls: `calls`
    where given, else its ragged steps) and its shards' pool bytes (each
    1/tp of the one-device run `base`'s)."""
    want = tp * MODEL["num_layers"] * (run["steps"] if calls is None
                                       else calls)
    got = (run["launches"] if isinstance(run["launches"], int)
           else run["launches"][kernel + run["tag"]])
    shards = run["shard_bytes"]
    st = run["stats"]
    log(f"  {label}: {run['steps']} steps, {run['wall']:.3f} s; "
        f"{kernel + run['tag']} launches {got} (tp x num_layers x calls "
        f"= {want}); shard pool bytes {shards[0]} x {len(shards)} against "
        f"{base['shard_bytes'][0]} on one device; collective bytes per step "
        f"{st['generation.collective_bytes_per_step']} (quantized "
        f"{st['generation.collective_quantized']}); mesh devices "
        f"{st['generation.mesh_devices']}")
    if got != want or got == 0:
        fail(f"{label}: {kernel}{run['tag']} launched {got} times, want "
             f"{want}")
    if len(shards) != tp or any(b * tp != base["shard_bytes"][0]
                                for b in shards):
        fail(f"{label}: shard pool bytes {shards}, want "
             f"{base['shard_bytes'][0]} / {tp} each")
    if st["generation.mesh_devices"] != tp:
        fail(f"{label}: generation.mesh_devices "
             f"{st['generation.mesh_devices']}, want {tp}")


def greedy_agreement(a, b, stochastic=STOCHASTIC):
    """Matching greedy tokens position by position between two runs, and
    their count."""
    match = total = 0
    for i, (x, y) in enumerate(zip(a["results"], b["results"])):
        if i in stochastic:
            continue
        total += max(len(x.token_ids), len(y.token_ids))
        match += sum(p == q for p, q in zip(x.token_ids, y.token_ids))
    return match, total


def phase_tp(pgen, pa, model, cpu_model, prompts, held, base):
    """Phase 15: tensor-parallel serving, every shard on card 0 (and on
    several cards where this call sees them).  `base` holds this call's
    one-device card runs of the same traffic: phase 3's float32 ragged,
    phase 5's legacy, phase 6 (a)'s int8 ragged and (c)'s int8 legacy.
    Returns the runs and numbers phase 15's numbers and the result line
    read."""
    n_layers = MODEL["num_layers"]
    out = {}
    log(f"  (a) the paged kernels per shard at tp {TP_DEGREES} on the "
        f"main path's operands")
    out["kernel_err"], out["bitwise"] = phase_tp_kernels(
        pa, np.random.default_rng(15))
    log(f"  (b) the engine at GPT-2-small width, {n_layers} layers, every "
        f"shard on cuda:0")
    runs = {1: base["ragged"]}
    for tp in TP_DEGREES:
        runs[tp] = run_engine(pgen, model, prompts, "cuda",
                              {"mesh": card_mesh(tp)})
        check_tp_run(f"float32 ragged tp {tp}", runs[tp], tp, base["ragged"])
        hold_ragged(f"float32 ragged tp {tp} vs tp 1", runs[tp],
                    base["ragged"], prompts)
    mesh = card_mesh(TP_MAIN)
    legacy = run_engine(pgen, model, prompts, "cuda",
                        {**LEGACY, "mesh": mesh})
    check_legacy_launches(f"legacy tp {TP_MAIN}", legacy, want_chunk=True,
                          tp=TP_MAIN)
    check_tp_run(f"legacy tp {TP_MAIN}", legacy, TP_MAIN, base["legacy"],
                 "paged_decode_attention", legacy["records"]["decode"])
    hold_to_rule(f"legacy tp {TP_MAIN} vs tp 1", legacy, base["legacy"],
                 prompts, cpu_model, STOCHASTIC)
    int8 = run_engine(pgen, model, prompts, "cuda", {**INT8, "mesh": mesh})
    check_tp_run(f"int8 ragged tp {TP_MAIN}", int8, TP_MAIN, base["int8"])
    hold_ragged(f"int8 ragged tp {TP_MAIN} vs tp 1", int8, base["int8"],
                prompts, INT8_LOGIT_TOL, INT8_NEAR_TIE)
    int8_legacy = run_engine(pgen, model, prompts, "cuda",
                             {**LEGACY, **INT8, "mesh": mesh})
    check_legacy_launches(f"int8 legacy tp {TP_MAIN}", int8_legacy,
                          want_chunk=True, tp=TP_MAIN)

    def int8_legacy_gap(i, k):
        top2 = np.sort(logits_at(base["int8"], i, k, len(prompts[i])))[-2:]
        return float(top2[1] - top2[0])

    hold_to_rule(f"int8 legacy tp {TP_MAIN} vs tp 1", int8_legacy,
                 base["int8_legacy"], prompts, cpu_model, STOCHASTIC,
                 logits=False, gap_of=int8_legacy_gap,
                 near_tie=INT8_NEAR_TIE)
    quant = run_engine(pgen, model, prompts, "cuda",
                       {**INT8, "mesh": mesh, "quantized_collectives": True})
    check_tp_run(f"int8 ragged tp {TP_MAIN}, quantized collectives", quant,
                 TP_MAIN, base["int8"])
    out["ring_err"], out["ring_bitwise"] = phase_tp_ring(
        np.random.default_rng(16))
    match, total = greedy_agreement(int8, quant)
    fp_b = int8["stats"]["generation.collective_bytes_per_step"]
    q_b = quant["stats"]["generation.collective_bytes_per_step"]
    if quant["stats"]["generation.collective_quantized"] != 1 \
            or int8["stats"]["generation.collective_quantized"] != 0:
        fail("generation.collective_quantized does not say which run "
             "carried the quantized ring")
    if fp_b / q_b < 3.0:
        fail(f"quantized collectives cut the bytes per step "
             f"{fp_b / q_b:.2f}x, want >= 3x")

    def int8_gap(i, k):
        top2 = np.sort(logits_at(int8, i, k, len(prompts[i])))[-2:]
        return float(top2[1] - top2[0])

    # the int8 ring rounds every all-reduce to a 127th of its chunk's
    # abs-max, 24 times a token: like int8 pools it may flip a near tie,
    # held by phase 6's bound; what follows a divergence, by the floor
    _, same = hold_to_rule(
        f"int8 tp {TP_MAIN} quantized vs float32 collectives", quant, int8,
        prompts, cpu_model, STOCHASTIC, logits=False, gap_of=int8_gap,
        near_tie=INT8_NEAR_TIE)
    log(f"  quantized collectives vs float32 collectives (int8 pools, tp "
        f"{TP_MAIN}): {same} of {len(prompts)} streams identical; greedy "
        f"agreement {match}/{total} = {match / total:.4f} (floor "
        f"{RING_AGREEMENT_FLOOR}); "
        f"collective bytes per step {q_b} vs {fp_b} ({fp_b / q_b:.2f}x "
        f"fewer)")
    if match / total < RING_AGREEMENT_FLOOR:
        fail(f"quantized collectives agree with float32 collectives on "
             f"{match}/{total} = {match / total:.4f} greedy tokens, want "
             f">= {RING_AGREEMENT_FLOOR}")
    spec = run_engine(pgen, model, prompts, "cuda",
                      {**SPEC, "loop_steps": SPEC_LOOP, "mesh": mesh})
    check_serving_run(f"float32 spec on N={SPEC_LOOP} tp {TP_MAIN}", spec,
                      {}, tp=TP_MAIN)
    if not spec["stats"]["generation.spec_accepted_tokens"]:
        fail("speculation on the mesh accepted no draft")

    def base_gap(i, k):
        top2 = np.sort(logits_at(runs[TP_MAIN], i, k, len(prompts[i])))[-2:]
        return float(top2[1] - top2[0])

    hold_to_rule(f"spec on N={SPEC_LOOP} vs spec off N=1, tp {TP_MAIN}",
                 spec, runs[TP_MAIN], prompts, cpu_model, STOCHASTIC,
                 logits=False, gap_of=base_gap)
    log(f"  (c) the card against the CPU at {HELD_LAYERS} layers, tp "
        f"{TP_MAIN} on both (plain versions on the CPU)")
    from paddle_tpu_torch.parallel import tp_mesh

    card = run_engine(pgen, held[0], prompts, "cuda", {"mesh": mesh})
    want = TP_MAIN * HELD_LAYERS * card["steps"]
    if card["launches"] != want or not want:
        fail(f"tp {TP_MAIN} at {HELD_LAYERS} layers: ragged kernel launched "
             f"{card['launches']} times, want {want}")
    cpu = run_engine(pgen, held[1], prompts, "cpu",
                     {"mesh": tp_mesh(TP_MAIN, devices=["cpu"] * TP_MAIN)})
    if any(cpu["all_launches"].values()):
        fail("the CPU mesh engine launched a CUDA kernel")
    out["card_vs_cpu"] = hold_ragged(
        f"tp {TP_MAIN} card vs CPU, {HELD_LAYERS} layers", card, cpu,
        prompts)
    n_cards = torch.cuda.device_count()
    log(f"  (d) torch.cuda.device_count() = {n_cards}")
    if n_cards >= TP_MAIN:
        cross = run_engine(pgen, model, prompts, "cuda",
                           {"mesh": tp_mesh(TP_MAIN)})
        check_tp_run(f"float32 ragged over {TP_MAIN} cards", cross, TP_MAIN,
                     base["ragged"])
        hold_ragged(f"{TP_MAIN} cards vs one", cross, base["ragged"],
                    prompts)
        log(f"  across {TP_MAIN} cards: "
            f"{cross['stats']['generation.collective_bytes_per_step']} "
            f"bytes moved between cards per step (the all-reduces' "
            f"estimate)")
        out["cross"] = cross
    else:
        log(f"  this call has {n_cards} card(s): no cross-card run made")
    out.update(runs=runs, legacy=legacy, int8=int8, int8_legacy=int8_legacy,
               quant=quant, spec=spec, agreement=(match, total),
               bytes=(fp_b, q_b))
    return out


def profile_window(pgen, model, prompts, settings):
    """The traffic on a fresh card engine, its steps TP_IDLE_STEPS[0] +
    1 .. + TP_IDLE_STEPS[1] traced by torch.profiler (CUDA activity
    only, so a mesh's tp-fold kernels stay cheap to read back): wall
    seconds, kernel busy seconds on the device, and the steps traced."""
    from torch.profiler import ProfilerActivity, profile

    eng, handles, _, _ = serve(pgen, model, prompts, "cuda", settings)
    skip, n = TP_IDLE_STEPS
    for _ in range(skip):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = 0
        while steps < n and (eng.scheduler.active()
                             or eng.scheduler.pending_count()):
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_idle()
    for h in handles:
        h.result(timeout=60)
    eng.shutdown()
    busy = sum(us for us, _ in device_kernels(prof).values()) / 1e6
    return wall, busy, steps


def tp_numbers(pgen, model, prompts, card, tp_out):
    """Phase 15's numbers: tokens/s of its runs at tp 1, 2 and 4 on one
    card, and each degree's device idle share under torch.profiler over a
    window of the traffic's steps (printed, not gated: on one card a mesh
    makes tp times the launches)."""
    for label, run in [(f"tp {tp}", tp_out["runs"][tp])
                       for tp in sorted(tp_out["runs"])] + [
            (f"legacy tp {TP_MAIN}", tp_out["legacy"]),
            (f"int8 tp {TP_MAIN}", tp_out["int8"]),
            (f"int8 legacy tp {TP_MAIN}", tp_out["int8_legacy"]),
            (f"int8 tp {TP_MAIN} quantized collectives", tp_out["quant"]),
            (f"spec + N={SPEC_LOOP} tp {TP_MAIN}", tp_out["spec"])]:
        toks = sum(len(r.token_ids) for r in run["results"])
        log(f"  [{card}] {label}: {toks / run['wall']:.1f} tokens/s over "
            f"{run['steps']} steps ({run['wall'] / run['steps'] * 1e3:.2f} "
            f"ms per step); collective bytes per step "
            f"{run['stats']['generation.collective_bytes_per_step']}")
    for tp in sorted(tp_out["runs"]):
        settings = None if tp == 1 else {"mesh": card_mesh(tp)}
        wall, busy, steps = profile_window(pgen, model, prompts, settings)
        if busy > 0:
            log(f"  [{card}] ragged tp {tp} under torch.profiler, steps "
                f"{TP_IDLE_STEPS[0] + 1}-{TP_IDLE_STEPS[0] + steps} of the "
                f"run: wall {wall:.3f} s, kernels busy {busy:.3f} s, idle "
                f"share {1 - busy / wall:.1%}")
        else:
            log(f"  [{card}] ragged tp {tp}: torch.profiler recorded no "
                f"device time: device idle share not measured")
    fp_b, q_b = tp_out["bytes"]
    match, total = tp_out["agreement"]
    log(f"  [{card}] tensor parallel: shards bitwise the unsharded kernels "
        f"{tp_out['bitwise']}; card vs CPU first-token logits max|diff| "
        f"{tp_out['card_vs_cpu']:.3e}; quantized collectives {q_b} bytes "
        f"per step against {fp_b}, greedy agreement {match}/{total}")


# ------------------------ flash attention cases -------------------------


def make_flash_case(rng, *, bh, heads, lq, lk, d, causal, mask=False,
                    dtype=torch.float32, device="cuda"):
    """qs (scale folded), k, v and dO [BH, L, D]; with `mask`, a key mask
    that masks every key of batch row 0 (its rows see nothing) and the
    last three keys of the last batch row."""
    def t(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device=device).to(dtype)

    km = None
    if mask:
        km_np = np.zeros((bh // heads, 1, lk), np.float32)
        km_np[0] = -1e30
        km_np[-1, 0, -3:] = -1e30
        km = torch.as_tensor(km_np, device=device)
    return dict(qs=t((bh, lq, d), 1.0 / math.sqrt(d)), k=t((bh, lk, d)),
                v=t((bh, lk, d)), do=t((bh, lq, d)), km=km, causal=causal,
                heads=heads)


def flash_cases():
    """The CPU tests' edge cases at D 16, 64 and 128 (one tile; ragged
    tiles at L 48, 130, 200; Lq < Lk and Lq > Lk causal; a key mask with
    fully masked rows; several tiles at L 1024, at D 128 with the mask
    the backward's largest tiles), in fp32 and bf16, and the trainer's
    case."""
    shapes = [
        ("d16_l64", dict(bh=4, heads=2, lq=64, lk=64, d=16, causal=False)),
        ("d64_l48_causal", dict(bh=4, heads=2, lq=48, lk=48, d=64,
                                causal=True)),
        ("d128_lq8_lk64_causal", dict(bh=4, heads=2, lq=8, lk=64, d=128,
                                      causal=True)),
        ("d128_lq130_lk70_causal", dict(bh=4, heads=2, lq=130, lk=70,
                                        d=128, causal=True)),
        ("d64_l200_causal_mask", dict(bh=4, heads=2, lq=200, lk=200, d=64,
                                      causal=True, mask=True)),
        ("d16_l1024_causal", dict(bh=2, heads=1, lq=1024, lk=1024, d=16,
                                  causal=True)),
        ("d128_l1024_causal_mask", dict(bh=4, heads=2, lq=1024, lk=1024,
                                        d=128, causal=True, mask=True)),
    ]
    cases = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cases += [(f"{name}_{tag}", dict(spec, dtype=dtype))
                  for name, spec in shapes]
    cases.append(("main_b8_h12_l512_d64_causal_f32", dict(FLASH_MAIN)))
    cases.append(("main_b8_h12_l512_d64_causal_bf16",
                  dict(FLASH_MAIN, dtype=torch.bfloat16)))
    return cases


def flash_args(case):
    return [case[n] for n in ("qs", "k", "v")]


def flash_bwd_args(case, lse, delta):
    return [case["qs"], case["k"], case["v"], case["do"], lse, delta]


def flash_opts(case):
    return dict(km=case["km"], causal=case["causal"], heads=case["heads"])


def hold_flash(fa, rng, case_name, spec, worst):
    """The three flash kernels against their plain versions on one case
    (`make_flash_case`'s `spec`); the backward kernels take the plain
    forward's lse and delta.  Raises `worst`, by kernel, to each max
    |diff|."""
    case = make_flash_case(rng, **spec)
    f32 = case["qs"].dtype == torch.float32
    opts = flash_opts(case)
    out, lse = fa.flash_attention_fwd_kernel(*flash_args(case), **opts)
    out_p, lse_p = fa.flash_attention_fwd_torch(*flash_args(case),
                                                **opts)
    delta = (case["do"].float() * out_p.float()).sum(-1)
    bwd = flash_bwd_args(case, lse_p, delta)
    dk, dv = fa.flash_attention_bwd_dkdv_kernel(*bwd, **opts)
    dk_p, dv_p = fa.flash_attention_bwd_dkdv_torch(*bwd, **opts)
    dq = fa.flash_attention_bwd_dq_kernel(*bwd, **opts)
    dq_p = fa.flash_attention_bwd_dq_torch(*bwd, **opts)
    torch.cuda.synchronize()
    checks = [
        ("flash_attention_fwd", "out", out, out_p,
         FLASH_TOL if f32 else FLASH_BF16_TOL),
        ("flash_attention_fwd", "lse", lse, lse_p, FLASH_TOL),
        ("flash_attention_bwd_dkdv", "dk", dk, dk_p,
         FLASH_GRAD_TOL if f32 else FLASH_BF16_TOL),
        ("flash_attention_bwd_dkdv", "dv", dv, dv_p,
         FLASH_GRAD_TOL if f32 else FLASH_BF16_TOL),
        ("flash_attention_bwd_dq", "dq", dq, dq_p,
         FLASH_GRAD_TOL if f32 else FLASH_BF16_TOL)]
    notes = []
    for kname, what, got, want, tol in checks:
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        # atol + rtol * |want|, the tests' assert_close rule
        bad = (got - want).abs() > tol + tol * want.abs()
        if not math.isfinite(err) or bool(bad.any()):
            fail(f"{kname} disagrees with its plain version on "
                 f"{case_name}: {what} max|diff| {err:.3e} past "
                 f"atol = rtol = {tol}")
        worst[kname] = max(worst[kname], err)
        notes.append(f"{what} {err:.2e}")
    if case["km"] is not None and not (
            bool((out[:case["heads"]] == 0).all())
            and bool((lse[:case["heads"]] == -1e30).all())):
        fail(f"flash forward: fully masked rows of {case_name} are not "
             f"out 0, lse NEG_INF")
    log(f"  flash vs plain  {case_name:34s} max|diff| "
        f"{', '.join(notes)}")


def phase_flash(fa, rng):
    """`hold_flash` over `flash_cases`.  Returns the worst max |diff| of
    each kernel."""
    worst = dict.fromkeys([k["name"] for k in FLASH_KERNELS], 0.0)
    for case_name, spec in flash_cases():
        hold_flash(fa, rng, case_name, spec, worst)
    return worst


def flash_bound(case, name):
    """Least time for one flash kernel on these inputs: each input read
    once and each output written once; 2*D flops per visible (row, key)
    pair per product, forward 2 products (q.k, p.v), dK/dV 4 (q.k, dO.v,
    p.dO, dS.q), dQ 3 (q.k, dO.v, dS.k), each pair counted once; at the
    3xTF32 rate for fp32 (the fastest fp32-accurate products the card
    has), the bf16 tensor-core rate for bf16.  Also returns the time at
    the fp32 FMA rate (None for bf16), the bound of the first, FMA-only
    kernels, so their shares stay comparable."""
    bh, lq, d = case["qs"].shape
    lk = case["k"].shape[1]
    item = case["qs"].element_size()
    off = lk - lq if case["causal"] else lk
    pairs = bh * sum(min(max(i + off + 1, 0), lk) if case["causal"] else lk
                     for i in range(lq))
    rows, mat = bh * lq * 4, bh * lq * d * item    # an lse row, a q tile
    kv = bh * lk * d * item
    km = 0 if case["km"] is None else case["km"].numel() * 4
    work = {"flash_attention_fwd": (mat + 2 * kv + mat + rows + km, 2),
            "flash_attention_bwd_dkdv": (2 * mat + 2 * kv + 2 * rows + km
                                         + 2 * kv, 4),
            "flash_attention_bwd_dq": (2 * mat + 2 * kv + 2 * rows + km
                                       + mat, 3)}
    nbytes, products = work[name]
    flops = 2 * d * pairs * products
    peak = TF32X3_FLOPS_PER_S if item == 4 else BF16_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / peak * 1e3
    fma_ms = (max(t_bytes, flops / FP32_FLOPS_PER_S * 1e3) if item == 4
              else None)
    return (max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                    else "operations"), nbytes, flops,
            fma_ms)


def lib_kernels(fn, card, what):
    """Log the kernels that `fn` (a PyTorch call) ran in 3 calls under
    torch.profiler: each one's mean device time per launch and the
    launches the profiler recorded (it may miss the first call's)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    ran = sorted(device_kernels(prof).items(), key=lambda kv: -kv[1][0])
    log(f"  [{card}] {what}'s kernels (torch.profiler, 3 calls): "
        + ("; ".join(f"{key} {us / count:.1f} us per launch, {count} "
                     f"launches" for key, (us, count) in ran)
           or "not measured (no device events)"))


def in_turns(ours, lib):
    """Device ms of `ours` and `lib`, timed in turns (ours, lib, lib,
    ours), each the mean of its two turns; and the four turns."""
    turns = [time_ms(fn, 100) for fn in (ours, lib, lib, ours)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def flash_numbers(fa, card, dtype=torch.float32):
    """Each flash kernel, its plain version and PyTorch's sdpa at the
    trainer's attention shape in `dtype`: the forward kernel against
    sdpa's forward in turns (ours, sdpa, sdpa, ours); then the whole
    backward as the trainer runs it (torch.autograd.grad through
    FlashAttention: the delta op and both kernels) beside sdpa's backward
    on the same inputs, in turns; and (fp32) the names of the kernels
    sdpa's forward and backward ran (torch.profiler).  Bounds at the
    3xTF32 rate for fp32, the bf16 tensor-core rate for bf16.  Returns
    name -> (ms, plain_ms, bound_ms, bound_by, library_ms)."""
    f32 = dtype == torch.float32
    case = make_flash_case(np.random.default_rng(5 if f32 else 6),
                           **dict(FLASH_MAIN, dtype=dtype))
    opts = flash_opts(case)
    out, lse = fa.flash_attention_fwd_kernel(*flash_args(case), **opts)
    delta = (case["do"].float() * out.float()).sum(-1)
    bwd = flash_bwd_args(case, lse, delta)
    # the library call: sdpa on [B, H, L, D] (Lq = Lk, so its top-left
    # causal alignment is the JAX kernel's bottom-right one); its inputs
    # need grads, as in training, so its forward also keeps the row
    # log-sum-exp, as ours does
    b, h = FLASH_MAIN["bh"] // FLASH_MAIN["heads"], FLASH_MAIN["heads"]
    q4, k4, v4, do4 = (case[n].reshape(b, h, *case[n].shape[1:])
                       .detach().clone().requires_grad_(n != "do")
                       for n in ("qs", "k", "v", "do"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(q4, k4, v4, is_causal=True, scale=1.0)

    def lib_forward():
        return sdpa(q4, k4, v4, is_causal=True, scale=1.0)

    def lib_backward():
        return torch.autograd.grad(lib_out, (q4, k4, v4), do4,
                                   retain_graph=True)

    def forward():
        return fa.flash_attention_fwd_kernel(*flash_args(case), **opts)

    fwd_ms, lib_fwd, fwd_turns = in_turns(forward, lib_forward)
    lib_bwd = time_ms(lib_backward, 100)
    runs = {"flash_attention_fwd": (
                forward,
                lambda: fa.flash_attention_fwd_torch(*flash_args(case),
                                                     **opts), lib_fwd),
            "flash_attention_bwd_dkdv": (
                lambda: fa.flash_attention_bwd_dkdv_kernel(*bwd, **opts),
                lambda: fa.flash_attention_bwd_dkdv_torch(*bwd, **opts),
                lib_bwd),
            "flash_attention_bwd_dq": (
                lambda: fa.flash_attention_bwd_dq_kernel(*bwd, **opts),
                lambda: fa.flash_attention_bwd_dq_torch(*bwd, **opts),
                lib_bwd)}
    tag, rate = ("f32", "3xTF32") if f32 else ("bf16", "bf16 tensor-core")
    numbers = {}
    for name, (kernel, plain, lib_ms) in runs.items():
        ms = fwd_ms if kernel is forward else time_ms(kernel, 100)
        paced = time_ms(kernel, 100, queued=False)
        plain_ms = time_ms(plain, 20)
        bound_ms, bound_by, nbytes, flops, fma_ms = flash_bound(case, name)
        numbers[name] = (ms, plain_ms, bound_ms, bound_by, lib_ms)
        fma = (f"; against the fp32 FMA bound ({fma_ms * 1e3:.2f} us) "
               f"{fma_ms / ms:.1%}" if f32 else "")
        log(f"  [{card}] {name} at the trainer's shape (BH=96: B=8 x H=12, "
            f"L=512, D=64, {tag}, causal): {ms * 1e3:.1f} us (launch-paced "
            f"{paced * 1e3:.1f} us); plain version {plain_ms * 1e3:.1f} us; "
            f"bound {bound_ms * 1e3:.2f} us by {bound_by} at the {rate} "
            f"rate ({nbytes} B, {flops} flop) = {bound_ms / ms:.1%} of "
            f"bound{fma}")
    log(f"  [{card}] forward at that shape against sdpa's forward "
        f"(is_causal, {tag}, inputs that need grads), in turns: "
        f"{fwd_ms * 1e3:.1f} us against {lib_fwd * 1e3:.1f} us, "
        f"{fwd_ms / lib_fwd:.2f}x (turns: "
        f"{', '.join(f'{x * 1e3:.1f}' for x in fwd_turns)} us)")
    log(f"  [{card}] library call, torch scaled_dot_product_attention at "
        f"that shape ({tag}): backward (torch.autograd.grad: dq, dk, dv in "
        f"one call) {lib_bwd * 1e3:.1f} us")
    qg, kg, vg = (case[n].detach().clone().requires_grad_()
                  for n in ("qs", "k", "v"))
    ours_out = fa.FlashAttention.apply(qg, kg, vg, case["km"],
                                       case["causal"], case["heads"])

    def ours():
        return torch.autograd.grad(ours_out, (qg, kg, vg), case["do"],
                                   retain_graph=True)

    whole, lib_whole, turns = in_turns(ours, lib_backward)
    log(f"  [{card}] whole backward at that shape ({tag}; "
        f"torch.autograd.grad through FlashAttention: delta = "
        f"rowsum(dO*out), dK/dV, dQ) {whole * 1e3:.1f} us against sdpa's "
        f"backward {lib_whole * 1e3:.1f} us, {whole / lib_whole:.2f}x (in "
        f"turns: {', '.join(f'{x * 1e3:.1f}' for x in turns)} us)")
    if f32:
        lib_kernels(lib_forward, card, "sdpa forward")
        lib_kernels(lib_backward, card, "sdpa backward")
    return numbers


# ------------------------------ training ---------------------------------


def train_batch(batch, seq, vocab):
    """Random token ids and labels as bench.py makes them
    (RandomState(0))."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    lbl = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(lbl)


def grad_norm(model):
    return math.sqrt(sum(float(p.grad.double().square().sum())
                         for p in model.parameters()))


def make_trainer(model, device, lr, seed=0):
    """`TrainStep` over ``model.loss(*batch)`` with AdamW at `lr` (a
    number or a scheduler) and bf16 amp."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    return TrainStep(model, lambda m, *batch, generator: m.loss(
        *batch, generator=generator), AdamW(learning_rate=lr),
        amp_dtype=torch.bfloat16, seed=seed, device=device)


def profile_steps(step, n):
    """`n` calls of `step` under torch.profiler (CUDA activity only, as
    `profile_engine`): wall seconds, kernel seconds on the device, the 15
    kernels that took the most, and the count of kernels run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = device_kernels(prof)
    busy = sum(us for us, _ in per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return wall, busy, top, sum(c for _, c in per_kernel.values())


def phase_training_held():
    """At dropout 0: the card's first two steps against the same weights
    and batch on the CPU (plain versions).  Returns the card's and the
    CPU's losses and step-1 gradient norms."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    cfg = GPTConfig(dropout=0.0, **TRAIN_MODEL)
    ids, lbl = train_batch(TRAIN["held_batch"], TRAIN["seq"],
                           cfg.vocab_size)
    runs = {}
    cpu_model = GPTForPretraining(cfg, seed=0, device="cpu")
    for device in ("cuda", "cpu"):
        model = (cpu_model if device == "cpu" else
                 GPTForPretraining.from_numpy_params(
                     cpu_model.numpy_params(), cfg, device="cuda"))
        tr = make_trainer(model, device, TRAIN["lr"])
        t0 = time.perf_counter()
        losses, gnorm = [], None
        for _ in range(TRAIN["held_steps"]):
            losses.append(float(tr.step(ids, lbl)))
            if gnorm is None:
                gnorm = grad_norm(model)
        runs[device] = (losses, gnorm)
        log(f"  {device}: B={TRAIN['held_batch']}, L={TRAIN['seq']}, "
            f"dropout 0: losses {losses}, step-1 gradient norm {gnorm:.6f} "
            f"({time.perf_counter() - t0:.1f} s)")
        del tr, model
    (card_l, card_g), (cpu_l, cpu_g) = runs["cuda"], runs["cpu"]
    for i, (a, b) in enumerate(zip(card_l, cpu_l)):
        if not math.isfinite(a) or abs(a - b) > TRAIN_LOSS_TOL * abs(b):
            fail(f"training step {i + 1}: card loss {a} vs CPU {b}, past "
                 f"{TRAIN_LOSS_TOL} relative")
    if abs(card_g - cpu_g) > TRAIN_GNORM_TOL * cpu_g:
        fail(f"step-1 gradient norm: card {card_g} vs CPU {cpu_g}, past "
             f"{TRAIN_GNORM_TOL} relative")
    return runs


def phase_training_run():
    """The bench's run on the card at dropout 0.1: warm-up and timed
    steps on one batch, every count set to 0 just before and read just
    after; then TRAIN["profiled"] more steps under torch.profiler."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    cfg = GPTConfig(dropout=TRAIN["dropout"], **TRAIN_MODEL)
    model = GPTForPretraining(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    tr = make_trainer(model, "cuda", TRAIN["lr"])
    ids, lbl = (x.cuda() for x in train_batch(TRAIN["batch"], TRAIN["seq"],
                                               cfg.vocab_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for _ in range(TRAIN["warmup"]):
        losses.append(tr.step(ids, lbl))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN["iters"]):
        losses.append(tr.step(ids, lbl))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(x) for x in losses]
    steps = TRAIN["warmup"] + TRAIN["iters"]
    peak = torch.cuda.max_memory_allocated()
    log(f"  {n_params / 1e6:.1f} M parameters; {steps} steps at "
        f"B={TRAIN['batch']}, L={TRAIN['seq']}, dropout "
        f"{TRAIN['dropout']}: losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"launches {launches}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"training loss not finite and falling: {losses}")
    want = cfg.num_layers * steps
    for k in FLASH_KERNELS:
        if launches[k["name"]] != want:
            fail(f"{k['name']} launched {launches[k['name']]} times, want "
                 f"num_layers x steps = {want}")
    if any(launches[k["name"]] for k in KERNELS):
        fail("the train step launched a paged-attention kernel")
    p_wall, busy, top, _ = profile_steps(lambda: tr.step(ids, lbl),
                                      TRAIN["profiled"])
    return dict(wall=wall, iters=TRAIN["iters"], launches=launches,
                peak=peak, losses=losses, p_wall=p_wall, busy=busy, top=top,
                tokens=TRAIN["batch"] * TRAIN["seq"], n_params=n_params)


def build_static_resnet(static, momentum_cls, batch, depths=(3, 4, 6, 3),
                        base=64, image=224, classes=1000, amp=True):
    """ResNet-50 through the static Program/Executor path, line for line
    ``bench.py::_build_static_resnet50`` with the static module and the
    Momentum class passed in (either package's), and its widths, depth,
    image size and classes as arguments (ResNet-50 by default).  Returns
    (main, startup, loss_var, fwd_flops_per_image)."""
    flops = [0]

    def conv_bn(x, cout, k, stride=1, pad=0, act=None):
        cin = x.shape[1]
        y = static.nn.conv2d(x, cout, k, stride=stride, padding=pad,
                             bias_attr=False)
        flops[0] += 2 * cout * y.shape[2] * y.shape[3] * cin * k * k
        return static.nn.batch_norm(y, act=act)

    def bottleneck(x, width, stride=1, downsample=False):
        out = conv_bn(x, width, 1, act="relu")
        out = conv_bn(out, width, 3, stride=stride, pad=1, act="relu")
        out = conv_bn(out, width * 4, 1)
        if downsample:
            x = conv_bn(x, width * 4, 1, stride=stride)
        return static.nn.relu(out + x)

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        img = static.data("image", [batch, 3, image, image])
        label = static.data("label", [batch, 1], dtype="int64")
        x = conv_bn(img, base, 7, stride=2, pad=3, act="relu")
        x = static.nn.pool2d(x, pool_size=3, pool_type="max", pool_stride=2,
                             pool_padding=1)
        for width, blocks, stride in zip(
                (base, 2 * base, 4 * base, 8 * base), depths, (1, 2, 2, 2)):
            for i in range(blocks):
                x = bottleneck(x, width, stride=stride if i == 0 else 1,
                               downsample=(i == 0))
        x = static.nn.pool2d(x, global_pooling=True, pool_type="avg")
        x = static.nn.flatten(x, axis=1)
        logits = static.nn.fc(x, classes)
        flops[0] += 2 * x.shape[1] * classes
        loss = static.nn.softmax_with_cross_entropy(logits, label)
        loss = static.nn.mean(loss)
        opt = momentum_cls(learning_rate=0.1, momentum=0.9)
        if amp:
            opt = static.amp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss, flops[0]


def resnet_batch(batch):
    """Random images and labels as bench_resnet makes them
    (RandomState(0))."""
    rng = np.random.RandomState(0)
    img = rng.rand(batch, 3, 224, 224).astype(np.float32)
    lab = rng.randint(0, 1000, (batch, 1)).astype(np.int64)
    return img, lab


def worst_share(a, b, names):
    """The largest `share` of the tensors `names` of numpy dicts a, b."""
    return max(share(torch.from_numpy(a[n]), torch.from_numpy(b[n]))
               for n in names)


def rel_l2(a, b, names):
    """||a - b|| / ||b|| over the tensors `names` taken together."""
    diff = sum(float(np.square(a[n] - b[n], dtype=np.float64).sum())
               for n in names)
    ref = sum(float(np.square(b[n], dtype=np.float64).sum()) for n in names)
    return math.sqrt(diff / ref)


def share(got, want):
    """|got - want| at its largest over want's largest magnitude."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30)).item()


def replay_held(static, main, env, after, device):
    """Each op of `main` on `device` (`static.replay_ops`) from a
    reference run's values of its inputs (`env`: the scope before the
    step, the feed and every var the step computes, on the CPU; `after`:
    the scope after it), each output held to the reference's value: within
    RESNET_TOL of the tensor's largest magnitude for float32, within
    RESNET_BF16_TOL for bfloat16, and of the same dtype.

    One case is told apart: a batch norm with a fused relu whose output
    takes the other side of 0 at an element (its value within RESNET_TOL
    of the largest on both sides, the two statistics differing in their
    last bits).  Its grad op then passes or stops that element's
    cotangent, so that op's gradients are held over the other channels
    only, and those channels are counted.  Returns the worst share of
    each op type, the outputs past their bound, and (elements, channels)
    taken out."""
    tol = {torch.float32: RESNET_TOL, torch.bfloat16: RESNET_BF16_TOL}
    worst, past, flipped, taken = {}, [], {}, [0, 0]
    for idx, op, outs in static.replay_ops(main, env, device):
        skip = flipped.get(getattr(op, "forward_op", None))
        for n, got in zip(op.out_order, outs):
            want = after[n] if n in after else env[n]
            got = got.cpu()
            if op.type == "batch_norm" and op.attrs.get("act") == "relu" \
                    and n == op.out_order[0]:
                sides = (got > 0) != (want > 0)
                if sides.any():
                    near = torch.maximum(got.float().abs(),
                                         want.float().abs())[sides].max()
                    if near > RESNET_TOL * want.float().abs().max():
                        past.append((op.type, n, "other side of 0",
                                     near.item()))
                    channels = sides.transpose(0, 1).flatten(1).any(1)
                    flipped[idx] = channels
                    taken[0] += int(sides.sum())
                    taken[1] += int(channels.sum())
            if skip is not None:
                dim = 1 if got.dim() > 1 else 0
                keep = (~skip).nonzero().flatten()
                if not bool(torch.isfinite(got.float()).all()):
                    past.append((op.type, n, "not finite", None))
                got, want_held = (got.index_select(dim, keep),
                                  want.index_select(dim, keep))
            else:
                want_held = want
            err = share(got, want_held)
            worst[op.type] = max(worst.get(op.type, 0.0), err)
            if got.dtype != want.dtype or not err <= tol[want.dtype]:
                past.append((op.type, n, str(got.dtype), err))
            env[n] = want
    return worst, past, tuple(taken)


def phase_resnet_held():
    """ResNet-50 at full width and depth, B 2, from the card's startup
    scope carried to a CPU executor.  The fp32 program's three steps:
    before each the card takes the CPU's scope, so each step is held from
    one state: its loss within RESNET_TOL relative, the BN running stats
    after it within RESNET_TOL of each tensor's largest magnitude, and
    the step's gradients (the velocities after step 1) within
    RESNET_GRAD_TOL, ||card - CPU|| / ||CPU|| over all of them together
    (at step 1 with the CPU's own spread beside it: one thread against
    its default, the same arithmetic summed in another order).  At step
    1, op by op: every op of the step on the card from the CPU run's
    values of its inputs, each output (every activation, every gradient,
    each updated parameter with the stem filter, each velocity and
    running stat) within RESNET_TOL of the CPU's (`replay_held`; a batch
    norm+relu output within rounding of 0 on the other side leaves its
    channel out of that grad op); and end to end the ReLU outputs on
    the other side of 0 counted.  Then the AMP program:
    its step-1 loss within RESNET_AMP_TOL, and op by op at step 1 each
    bfloat16 output within RESNET_BF16_TOL and each float32 one within
    RESNET_TOL, every dtype the CPU's; steps 2-3 printed.  No kernel of
    the port launched."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import scope_from_numpy, scope_to_numpy

    b, n = RESNET["held_batch"], RESNET["held_steps"]
    img, lab = resnet_batch(b)
    feed = {"image": img, "label": lab}
    reset_launches()
    card, cpu = static.Executor(), static.Executor("cpu")

    def step(exe, main, loss, arrays, device, names=()):
        scope = scope_from_numpy(arrays, device)
        out = exe.run(main, feed=feed, fetch_list=[loss] + list(names),
                      scope=scope, return_numpy=False)
        return (float(out[0][0]), scope_to_numpy(scope),
                dict(zip(names, out[1:])))

    def replay(main, loss, arrays):
        """The CPU's step from `arrays` fetching every var of the step,
        then each op on the card from its values."""
        names = [n_ for n_, v in main.global_block().vars.items()
                 if not v.is_data and not v.persistable]
        cpu_l, cpu_s, vals = step(cpu, main, loss, arrays, "cpu", names)
        env = {n_: torch.from_numpy(v) for n_, v in arrays.items()}
        env.update({n_: torch.from_numpy(v) for n_, v in feed.items()})
        env.update(vals)
        t0 = time.perf_counter()
        worst, past, (elements, channels) = replay_held(
            static, main, env,
            {n_: torch.from_numpy(v) for n_, v in cpu_s.items()}, "cuda")
        ranked = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
        log(f"  op by op on the card from the CPU's inputs ({len(worst)} "
            f"op types): worst shares "
            + ", ".join(f"{k} {v:.2e}" for k, v in ranked)
            + f"; {elements} batch-norm+relu outputs on the other side of "
            f"0, their {channels} channels' gradients left out "
            f"({time.perf_counter() - t0:.1f} s)")
        if past:
            fail(f"ResNet-50 op by op: {len(past)} outputs past their "
                 f"bound or of another dtype, first {past[:5]}")
        return cpu_l, cpu_s, vals

    main, startup, loss, _ = build_static_resnet(static, popt.Momentum, b,
                                                 amp=False)
    start_scope = static.Scope()
    card.run(startup, scope=start_scope)
    state = scope_to_numpy(start_scope)
    stats = [n_ for n_ in state if n_.startswith("bn_")]
    velocities = [n_ for n_ in state if n_.endswith("_velocity")]
    # the ReLUs' outputs: relu ops and batch norms with a fused relu
    relus = [op.out_order[0] for op in main.global_block().ops
             if op.type == "relu" or (op.type == "batch_norm"
                                      and op.attrs.get("act") == "relu")]
    for i in range(n):
        t0 = time.perf_counter()
        card_l, card_s, card_v = step(card, main, loss, state, "cuda",
                                      relus if i == 0 else ())
        if i == 0:
            cpu_l, cpu_s, cpu_v = replay(main, loss, state)
            # end to end, the elements that took the other side of 0
            sides = [((card_v[r].cpu() > 0) != (cpu_v[r] > 0))
                     for r in relus]
            flipped = sum(int(f.sum()) for f in sides)
            largest = max((float(torch.maximum(
                card_v[r].cpu()[f].abs(), cpu_v[r][f].abs()).max())
                for r, f in zip(relus, sides) if f.any()), default=0.0)
            log(f"  fp32 step 1: {flipped} of "
                f"{sum(cpu_v[r].numel() for r in relus)} ReLU outputs on "
                f"the other side of 0 on the card (the largest of them "
                f"{largest:.2e})")
        else:
            cpu_l, cpu_s, _ = step(cpu, main, loss, state, "cpu")
        loss_err = abs(card_l - cpu_l) / abs(cpu_l)
        stat_err = worst_share(card_s, cpu_s, stats)
        grad_err = rel_l2(card_s, cpu_s, velocities)
        stem_err = worst_share(card_s, cpu_s, ["param_1"])
        spread = ""
        if i == 0:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            _, one_s, _ = step(cpu, main, loss, state, "cpu")
            torch.set_num_threads(threads)
            spread = (f"; CPU 1 thread vs {threads}: gradients "
                      f"{rel_l2(one_s, cpu_s, velocities):.2e}, worst "
                      f"tensor {worst_share(one_s, cpu_s, velocities):.2e}")
        log(f"  fp32 step {i + 1}: loss card {card_l:.6f} CPU {cpu_l:.6f} "
            f"({loss_err:.2e}); BN running stats {stat_err:.2e}; gradients "
            f"{grad_err:.2e} (worst tensor "
            f"{worst_share(card_s, cpu_s, velocities):.2e}), stem filter "
            f"{stem_err:.2e}{spread} ({time.perf_counter() - t0:.1f} s)")
        if not math.isfinite(card_l) or loss_err > RESNET_TOL:
            fail(f"ResNet-50 fp32 step {i + 1}: card loss {card_l} vs CPU "
                 f"{cpu_l}, past {RESNET_TOL} relative")
        if stat_err > RESNET_TOL:
            fail(f"ResNet-50 fp32 step {i + 1}: BN running stats {stat_err}"
                 f" past {RESNET_TOL}")
        if grad_err > RESNET_GRAD_TOL:
            fail(f"ResNet-50 fp32 step {i + 1}: gradients {grad_err} past "
                 f"{RESNET_GRAD_TOL}")
        state = cpu_s

    main, startup, loss, _ = build_static_resnet(static, popt.Momentum, b,
                                                 amp=True)
    start_scope = static.Scope()
    card.run(startup, scope=start_scope)
    arrays = scope_to_numpy(start_scope)
    replay(main, loss, arrays)
    losses = {}
    for name, exe, device in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        scope = scope_from_numpy(arrays, device)
        losses[name] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scope)[0][0]) for _ in range(n)]
    err = abs(losses["card"][0] - losses["cpu"][0]) / abs(losses["cpu"][0])
    log(f"  AMP losses card {losses['card']}, CPU {losses['cpu']}: step 1 "
        f"{err:.2e} relative")
    if not all(math.isfinite(x) for x in losses["card"]) \
            or err > RESNET_AMP_TOL:
        fail(f"ResNet-50 AMP step-1 loss: card {losses['card'][0]} vs CPU "
             f"{losses['cpu'][0]}, past {RESNET_AMP_TOL} relative")
    launches = read_launches()
    if any(launches.values()):
        fail(f"the static ResNet-50 launched a kernel of the port: "
             f"{launches}")


def phase_resnet_run():
    """bench_resnet's run on the card: B 64, AMP, the feed staged on the
    card once; every count set to 0 just before and read just after a
    warm-up chain of 20, three timed chains and 1 + 3 stepped runs (no
    kernel of the port may launch); then cost_analysis and one chain
    under torch.profiler."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import static

    b, chain = RESNET["batch"], RESNET["chain"]
    main, startup, loss, fwd_flops = build_static_resnet(
        static, popt.Momentum, b)
    exe, scope = static.Executor(), static.Scope()
    exe.run(startup, scope=scope)
    img, lab = resnet_batch(b)
    feed = {"image": torch.from_numpy(img).cuda(),
            "label": torch.from_numpy(lab).cuda()}

    def run_chain():
        return exe.run_chained(main, feed=feed, fetch_list=[loss],
                               n_steps=chain, scope=scope)[0].ravel()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = list(run_chain())
    warm = time.perf_counter() - t0
    chains = []
    for _ in range(RESNET["timed"]):
        t0 = time.perf_counter()
        losses += list(run_chain())
        chains.append(time.perf_counter() - t0)
    losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0][0]))
    stepped = []
    for _ in range(RESNET["stepped"]):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0][0]))
        stepped.append(time.perf_counter() - t0)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"  B={b}, AMP: warm-up chain of {chain} in {warm:.2f} s; chains "
        f"{[round(c, 4) for c in chains]} s; stepped runs "
        f"{[round(x, 4) for x in stepped]} s; loss {losses[0]:.4f} at the "
        f"first chained step, {losses[(1 + RESNET['timed']) * chain - 1]:.4f}"
        f" at the last; launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"ResNet-50 losses not finite: {losses}")
    if any(launches.values()):
        fail(f"the static ResNet-50 launched a kernel of the port: "
             f"{launches}")
    cost = exe.cost_analysis(main, feed={"image": img, "label": lab},
                             fetch_list=[loss], scope=scope)
    p_wall, busy, top, _ = profile_steps(run_chain, 1)
    n_params = sum(scope.get(v.name).numel()
                   for v in main.global_block().all_parameters()
                   if not v.stop_gradient)
    return dict(chain_s=min(chains), stepped_s=sorted(stepped)[
        len(stepped) // 2], peak=peak, fwd_flops=fwd_flops, cost=cost,
        p_wall=p_wall, busy=busy, top=top, n_params=n_params)


def resnet_numbers(card, run):
    """bench_resnet's numbers from `run`: images/s chained and synced, ms
    per step, model TFLOP/s by the bench's formula and by cost_analysis,
    peak memory, and the idle share, host gap and top kernels under
    torch.profiler."""
    b, chain = RESNET["batch"], RESNET["chain"]
    step_s = run["chain_s"] / chain
    formula = 3 * run["fwd_flops"] * b
    counted = run["cost"]["flops"] if run["cost"] else None
    log(f"  [{card}] ResNet-50 static training ({run['n_params'] / 1e6:.2f} "
        f"M parameters, B={b}, 224x224, Momentum, static bf16 AMP, NCHW): "
        f"{b / step_s:.1f} images/s chained ({step_s * 1e3:.2f} ms per step, "
        f"the fastest of {RESNET['timed']} chains of {chain}), "
        f"{b / run['stepped_s']:.1f} images/s synced per step (median "
        f"{run['stepped_s'] * 1e3:.2f} ms); peak memory "
        f"{run['peak'] / 2**30:.2f} GiB")
    for what, flops in (("the bench's formula (3 x forward)", formula),
                        ("cost_analysis (FlopCounterMode)", counted)):
        if flops is None:
            log(f"  [{card}] model flops by {what}: not counted")
            continue
        rate = flops / step_s
        log(f"  [{card}] {flops / 1e12:.3f} TFLOP per step by {what} -> "
            f"{rate / 1e12:.1f} TFLOP/s = {rate / BF16_FLOPS_PER_S:.1%} of "
            f"the dense bf16 tensor-core peak")
    if run["busy"] > 0:
        busy_ms = run["busy"] / chain * 1e3
        wall_ms = run["p_wall"] / chain * 1e3
        log(f"  [{card}] one chain of {chain} under torch.profiler: wall "
            f"{run['p_wall']:.3f} s, kernels busy {run['busy']:.3f} s on the "
            f"device, idle share {1 - run['busy'] / run['p_wall']:.1%}; "
            f"kernel time per step {busy_ms:.2f} ms against {wall_ms:.2f} ms "
            f"profiled and {step_s * 1e3:.2f} ms unprofiled: the executor's "
            f"host loop leaves the device idle "
            f"{max(step_s * 1e3 - busy_ms, 0.0):.2f} ms a step")
        for key, (us, count) in run["top"]:
            log(f"    {us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
    else:
        log(f"  [{card}] ResNet-50: torch.profiler recorded no device "
            f"time: device idle share not measured")


# --------------------------- dygraph vision ------------------------------


def lenet_batch(batch):
    """Random images and labels as bench_lenet makes them
    (RandomState(0))."""
    rng = np.random.RandomState(0)
    img = rng.rand(batch, 1, 28, 28).astype(np.float32)
    lbl = rng.randint(0, 10, (batch, 1)).astype(np.int64)
    return img, lbl


def vision_loss(net, img, lbl):
    from paddle_tpu_torch.nn import functional as F

    return F.softmax_with_cross_entropy(net(img), lbl).mean()


def hold_lenet(label, weights, options, param_lr):
    """LeNet from `weights` on the card and on the CPU, Adam at
    LENET["lr"] with `options` and ``{name: learning rate}`` on single
    parameters, LENET["held_steps"] steps on bench_lenet's batch: losses
    within VISION_TOL relative, each step-1 gradient and each parameter
    after the last step within VISION_TOL of its tensor's largest
    magnitude; a parameter entry past that only where an Adam step may
    have taken the other sign (within 2 x the summed step sizes)."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.models import layer_from_numpy
    from paddle_tpu_torch.vision import models as pvm

    img, lbl = lenet_batch(LENET["batch"])
    runs = {}
    for device in ("cuda", "cpu"):
        net = layer_from_numpy(pvm.LeNet(device="cpu"), weights, device)
        for n, p in net.named_parameters():
            if n in param_lr:
                p.optimize_attr = {"learning_rate": param_lr[n]}
        opt = popt.Adam(learning_rate=LENET["lr"],
                        parameters=net.parameters(), **options())
        x, y = (torch.from_numpy(a).to(device) for a in (img, lbl))
        losses, grads = [], None
        for _ in range(LENET["held_steps"]):
            loss = vision_loss(net, x, y)
            loss.backward()
            if grads is None:
                grads = {n: p.grad.cpu() for n, p in net.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs[device] = (losses, grads, {n: p.detach().cpu() for n, p in
                                        net.named_parameters()})
    (card_l, card_g, card_p), (cpu_l, cpu_g, cpu_p) = runs["cuda"], \
        runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    grad_err = max(share(card_g[n], cpu_g[n]) for n in cpu_g)
    bound = 2 * LENET["held_steps"] * LENET["lr"] * max(
        [1.0] + list(param_lr.values()))
    param_err, flipped, widest = 0.0, 0, 0.0
    for n, want in cpu_p.items():
        diff = (card_p[n].double() - want.double()).abs()
        param_err = max(param_err, share(card_p[n], want))
        past = diff > VISION_TOL * want.abs().max().double()
        flipped += int(past.sum())
        widest = max(widest, float(diff.max()))
    log(f"  LeNet, {label}: losses card {card_l} CPU {cpu_l} (worst "
        f"{loss_err:.2e} relative); step-1 gradients {grad_err:.2e}; "
        f"parameters after step {LENET['held_steps']} {param_err:.2e} of "
        f"their largest magnitude ({flipped} entries past {VISION_TOL}, "
        f"the widest {widest:.2e} against {bound:.2e})")
    if not all(math.isfinite(x) for x in card_l) or loss_err > VISION_TOL:
        fail(f"LeNet {label}: losses card {card_l} vs CPU {cpu_l}")
    if grad_err > VISION_TOL:
        fail(f"LeNet {label}: step-1 gradients {grad_err} past "
             f"{VISION_TOL}")
    if widest > bound:
        fail(f"LeNet {label}: a parameter moved {widest} from the CPU's, "
             f"past 2 x the summed step sizes {bound}")


def hold_resnet50_dygraph():
    """Dygraph ResNet-50 at full width and depth, B
    DYGRAPH_RESNET["held_batch"], 224x224, 1000 classes, from one
    carried state: eval logits within RESNET_TOL of their largest
    magnitude; one train step (Momentum(0.1, 0.9)): the loss within
    RESNET_TOL relative, every BN running stat within RESNET_TOL, the
    gradients within RESNET_GRAD_TOL as one norm over all of them (the
    CPU against itself on one thread printed beside it)."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy
    from paddle_tpu_torch.vision import models as pvm

    img, lab = resnet_batch(DYGRAPH_RESNET["held_batch"])
    card = pvm.resnet50(generator=torch.Generator().manual_seed(0))
    state = layer_to_numpy(card)
    runs = {}
    for device, threads in (("cuda", None), ("cpu", None), ("cpu", 1)):
        net = layer_from_numpy(card if device == "cuda" else pvm.resnet50(
            device="cpu"), state, device)
        default = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        x, y = (torch.from_numpy(a).to(device) for a in (img, lab))
        net.eval()
        with torch.no_grad():
            logits = net(x).cpu()
        net.train()
        opt = popt.Momentum(learning_rate=DYGRAPH_RESNET["lr"],
                            momentum=DYGRAPH_RESNET["momentum"],
                            parameters=net.parameters())
        loss = vision_loss(net, x, y)
        loss.backward()
        grads = {n: p.grad.cpu().numpy() for n, p in net.named_parameters()}
        opt.step()
        opt.clear_grad()
        stats = {n: t.cpu() for n, t in net.state_dict().items()
                 if n.endswith(("_mean", "_variance"))}
        runs[(device, threads)] = (logits, loss.item(), grads, stats)
        torch.set_num_threads(default)
    (c_lg, c_l, c_g, c_s), (h_lg, h_l, h_g, h_s), (_, _, one_g, _) = (
        runs[("cuda", None)], runs[("cpu", None)], runs[("cpu", 1)])
    logit_err = share(c_lg, h_lg)
    loss_err = abs(c_l - h_l) / abs(h_l)
    stat_err = max(share(c_s[n], h_s[n]) for n in h_s)
    grad_err = rel_l2(c_g, h_g, list(h_g))
    log(f"  ResNet-50 dygraph, B={DYGRAPH_RESNET['held_batch']}, 224x224: "
        f"eval logits {logit_err:.2e}; train step loss card {c_l:.6f} CPU "
        f"{h_l:.6f} ({loss_err:.2e}); BN running stats {stat_err:.2e}; "
        f"gradients {grad_err:.2e} (worst tensor "
        f"{worst_share(c_g, h_g, list(h_g)):.2e}; the CPU on 1 thread "
        f"against its default {rel_l2(one_g, h_g, list(h_g)):.2e})")
    if logit_err > RESNET_TOL or not torch.isfinite(c_lg).all():
        fail(f"ResNet-50 dygraph eval logits {logit_err} past {RESNET_TOL}")
    if not math.isfinite(c_l) or loss_err > RESNET_TOL:
        fail(f"ResNet-50 dygraph loss card {c_l} vs CPU {h_l}")
    if stat_err > RESNET_TOL:
        fail(f"ResNet-50 dygraph BN running stats {stat_err} past "
             f"{RESNET_TOL}")
    if grad_err > RESNET_GRAD_TOL:
        fail(f"ResNet-50 dygraph gradients {grad_err} past "
             f"{RESNET_GRAD_TOL}")


def hold_eval(name, build):
    """`build` (1000 classes) on the card and, from its state, on the
    CPU: eval logits at B DYGRAPH_RESNET["held_batch"], 224x224, within
    RESNET_TOL of their largest magnitude."""
    from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy

    card = build(generator=torch.Generator().manual_seed(0)).eval()
    cpu = layer_from_numpy(build(device="cpu"), layer_to_numpy(card),
                           "cpu").eval()
    img, _ = resnet_batch(DYGRAPH_RESNET["held_batch"])
    with torch.no_grad():
        got = card(torch.from_numpy(img).cuda()).cpu()
        want = cpu(torch.from_numpy(img))
    err = share(got, want)
    log(f"  {name} eval, B={DYGRAPH_RESNET['held_batch']}, 224x224: "
        f"logits {err:.2e}")
    if err > RESNET_TOL or not torch.isfinite(got).all():
        fail(f"{name} eval logits {err} past {RESNET_TOL}")


def phase_vision_held():
    """(a) LeNet card vs CPU, plain and with a global-norm clip, L2 decay
    and a per-parameter learning rate; (b) dygraph ResNet-50 eval and a
    train step, and VGG-11, MobileNet V1 and V2 in eval mode."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.models import layer_to_numpy
    from paddle_tpu_torch.vision import models as pvm

    weights = layer_to_numpy(pvm.LeNet(
        generator=torch.Generator().manual_seed(0)))
    hold_lenet("Adam", weights, dict, {})
    hold_lenet("Adam, ClipGradByGlobalNorm(1.0), L2Decay(1e-4), fc.0.weight "
               "at learning rate x 0.5", weights, lambda: dict(
                   grad_clip=pnn.ClipGradByGlobalNorm(1.0),
                   weight_decay=popt.L2Decay(1e-4)), {"fc.0.weight": 0.5})
    hold_resnet50_dygraph()
    for name, build in (("VGG-11", pvm.vgg11),
                        ("MobileNetV1", pvm.mobilenet_v1),
                        ("MobileNetV2", pvm.mobilenet_v2)):
        hold_eval(name, build)


def phase_vision_run():
    """bench_lenet's run on the card (B 128, 3 warm-up steps, 10 steps
    synced once, then 10 steps each synced, as the bench's _time_steps
    does): the loss finite and falling; then the eager step()'s host
    time and LENET["profiled"] steps under torch.profiler; then the
    dygraph ResNet-50 at B DYGRAPH_RESNET["batch"], fp32, Momentum:
    warm-up and timed steps with its peak memory (printed, not
    gated)."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.vision import models as pvm

    net = pvm.LeNet(generator=torch.Generator().manual_seed(0))
    opt = popt.Adam(learning_rate=LENET["lr"], parameters=net.parameters())
    img, lbl = (torch.from_numpy(a).cuda()
                for a in lenet_batch(LENET["batch"]))
    losses = []

    def step():
        loss = vision_loss(net, img, lbl)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())

    def sync():
        float(losses[-1])           # the bench's device-to-host read

    for _ in range(LENET["warmup"]):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(LENET["iters"]):
        step()
    sync()
    agg = (time.perf_counter() - t0) / LENET["iters"]
    synced = []
    for _ in range(LENET["iters"]):
        t0 = time.perf_counter()
        step()
        sync()
        synced.append(time.perf_counter() - t0)
    losses = [float(x) for x in losses]
    log(f"  LeNet B={LENET['batch']}: {len(losses)} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {agg * 1e3:.3f} ms per step "
        f"over {LENET['iters']} steps synced once, median "
        f"{np.median(synced) * 1e3:.3f} ms synced per step")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"LeNet loss not finite and falling: {losses}")

    host = []
    for _ in range(LENET["iters"]):
        vision_loss(net, img, lbl).backward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        opt.clear_grad()
    p_wall, busy, top, _ = profile_steps(step, LENET["profiled"])
    launches = 0
    if busy > 0:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        launches = sum(c for _, c in device_kernels(prof).values())

    b = DYGRAPH_RESNET["batch"]
    rnet = pvm.resnet50(generator=torch.Generator().manual_seed(0))
    ropt = popt.Momentum(learning_rate=DYGRAPH_RESNET["lr"],
                         momentum=DYGRAPH_RESNET["momentum"],
                         parameters=rnet.parameters())
    rimg, rlab = (torch.from_numpy(a).cuda() for a in resnet_batch(b))
    r_losses = []

    def r_step():
        loss = vision_loss(rnet, rimg, rlab)
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        r_losses.append(loss.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(DYGRAPH_RESNET["warmup"]):
        r_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DYGRAPH_RESNET["iters"]):
        r_step()
    torch.cuda.synchronize()
    r_step_s = (time.perf_counter() - t0) / DYGRAPH_RESNET["iters"]
    r_peak = torch.cuda.max_memory_allocated()
    r_losses = [float(x) for x in r_losses]
    log(f"  ResNet-50 dygraph B={b}, fp32, Momentum: losses "
        f"{[round(x, 4) for x in r_losses]}; {r_step_s * 1e3:.2f} ms per "
        f"step over {DYGRAPH_RESNET['iters']} steps")
    if not all(math.isfinite(x) for x in r_losses):
        fail(f"dygraph ResNet-50 losses not finite: {r_losses}")
    return dict(agg=agg, synced=float(np.median(synced)),
                host=float(np.median(host)), p_wall=p_wall, busy=busy,
                top=top, launches=launches,
                n_params=len(list(net.parameters())), r_step_s=r_step_s,
                r_peak=r_peak)


def vision_numbers(card, run, static_run):
    """bench_lenet's numbers and the dygraph ResNet-50's beside phase
    9's static one (same call)."""
    b = LENET["batch"]
    log(f"  [{card}] LeNet dygraph (bench_lenet, B={b}, Adam, fp32): "
        f"{b / run['agg']:.1f} images/s ({run['agg'] * 1e3:.3f} ms per "
        f"step over {LENET['iters']} steps synced once); median synced "
        f"step {run['synced'] * 1e3:.3f} ms ({b / run['synced']:.1f} "
        f"images/s); the eager step() alone {run['host'] * 1e3:.3f} ms of "
        f"host time per step ({run['n_params']} parameters, median of "
        f"{LENET['iters']})")
    if run["busy"] > 0:
        n = LENET["profiled"]
        log(f"  [{card}] LeNet under torch.profiler ({n} steps): wall "
            f"{run['p_wall']:.4f} s, kernels busy {run['busy']:.4f} s on "
            f"the device, idle share {1 - run['busy'] / run['p_wall']:.1%};"
            f" {run['launches']} device kernels and copies a step, "
            f"{run['busy'] / n * 1e3:.3f} ms of kernel time a step")
        for key, (us, count) in run["top"]:
            log(f"    {us / 1e3:9.3f} ms  {count:6d} calls  {key[:90]}")
    else:
        log(f"  [{card}] LeNet: torch.profiler recorded no device time: "
            f"device idle share and kernels per step not measured")
    rb, sb = DYGRAPH_RESNET["batch"], RESNET["batch"]
    static_step = static_run["chain_s"] / RESNET["chain"]
    log(f"  [{card}] ResNet-50 dygraph (B={rb}, 224x224, fp32, TF32 off, "
        f"Momentum): {run['r_step_s'] * 1e3:.2f} ms per step, "
        f"{rb / run['r_step_s']:.1f} images/s, peak memory "
        f"{run['r_peak'] / 2**30:.2f} GiB; the static executor in phase 10 "
        f"(B={sb}, static bf16 AMP): {static_step * 1e3:.2f} ms per step "
        f"chained, {sb / static_step:.1f} images/s, peak "
        f"{static_run['peak'] / 2**30:.2f} GiB")


def encoder_schedule():
    """The held check's schedule: a warm-up over two steps from 1e-5,
    then a polynomial decay from 1e-4 (steps at 1e-5, 5.5e-5, 1e-4)."""
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(lr.PolynomialDecay(
        ENCODER["lr"], decay_steps=10, end_lr=1e-5), warmup_steps=2,
        start_lr=1e-5, end_lr=ENCODER["lr"])


def knowledge_batch(batch, seq, vocab):
    """ERNIE's pretraining batch: random ids (RandomState(0)), rows cut
    into spans of 1-3 tokens, spans masked whole by
    apply_knowledge_mask (labels -100 elsewhere), and sentence-order
    labels."""
    from paddle_tpu_torch.models import apply_knowledge_mask

    rng = np.random.RandomState(0)
    ids = rng.randint(4, vocab, (batch, seq)).astype(np.int64)
    spans = []
    for _ in range(batch):
        cuts = [0] + [int(c) for c in np.cumsum(rng.randint(1, 4, seq))
                      if c < seq] + [seq]
        spans.append(list(zip(cuts[:-1], cuts[1:])))
    masked, labels = apply_knowledge_mask(ids, spans, ERNIE_MASK_ID,
                                          rng=rng)
    sop = rng.randint(0, 2, batch).astype(np.int64)
    return tuple(torch.from_numpy(x) for x in (masked, labels, sop))


def phase_encoder_held():
    """BERT-base and then ERNIE-base at dropout 0: the card's first
    ENCODER["held_steps"] steps (AdamW under `encoder_schedule`, bf16
    amp) against the same weights and batch on the CPU."""
    from paddle_tpu_torch.models import (BertForPretraining,
                                         ErnieForPretraining, bert_base,
                                         ernie_base)

    b, seq = ENCODER["held_batch"], ENCODER["seq"]
    for label, cls, cfg in (
            ("BERT-base", BertForPretraining, bert_base(dropout=0.0)),
            ("ERNIE-base", ErnieForPretraining,
             ernie_base(dropout=0.0, **ERNIE_MODEL))):
        if cls is BertForPretraining:
            batch = train_batch(b, seq, cfg.vocab_size)
        else:
            batch = knowledge_batch(b, seq, cfg.vocab_size)
            log(f"  {label}: {int((batch[1] != -100).sum())} of "
                f"{batch[1].numel()} positions labelled")
        runs = {}
        cpu_model = cls(cfg, seed=0, device="cpu")
        for device in ("cuda", "cpu"):
            model = (cpu_model if device == "cpu" else
                     cls.from_numpy_params(cpu_model.numpy_params(), cfg,
                                           device="cuda"))
            sched = encoder_schedule()
            tr = make_trainer(model, device, sched)
            t0 = time.perf_counter()
            losses, rates, gnorm = [], [], None
            for _ in range(ENCODER["held_steps"]):
                rates.append(tr.optimizer.get_lr())
                losses.append(float(tr.step(*batch)))
                if gnorm is None:
                    gnorm = grad_norm(model)
            runs[device] = (losses, gnorm)
            log(f"  {label} {device}: B={b}, L={seq}, dropout 0, lr "
                f"{rates}: losses {losses}, step-1 gradient norm "
                f"{gnorm:.6f} ({time.perf_counter() - t0:.1f} s)")
            del tr, model
        (card_l, card_g), (cpu_l, cpu_g) = runs["cuda"], runs["cpu"]
        for i, (x, y) in enumerate(zip(card_l, cpu_l)):
            if not math.isfinite(x) or abs(x - y) > TRAIN_LOSS_TOL * abs(y):
                fail(f"{label} step {i + 1}: card loss {x} vs CPU {y}, "
                     f"past {TRAIN_LOSS_TOL} relative")
        if abs(card_g - cpu_g) > TRAIN_GNORM_TOL * cpu_g:
            fail(f"{label} step-1 gradient norm: card {card_g} vs CPU "
                 f"{cpu_g}, past {TRAIN_GNORM_TOL} relative")
        del cpu_model


def phase_encoder_run():
    """bench_bert's run on the card: BERT-base at dropout 0.1, AdamW lr
    1e-4, bf16 amp, B 64, L 128, one random batch; every count set to 0
    just before the warm-up and timed steps and read just after (the
    path is composite attention: no kernel of the port may launch); then
    ENCODER["profiled"] more steps under torch.profiler."""
    from paddle_tpu_torch.models import BertForPretraining, bert_base

    cfg = bert_base(dropout=ENCODER["dropout"])
    model = BertForPretraining(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    tr = make_trainer(model, "cuda", ENCODER["lr"])
    ids, lbl = (x.cuda() for x in train_batch(ENCODER["batch"],
                                               ENCODER["seq"],
                                               cfg.vocab_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [tr.step(ids, lbl) for _ in range(ENCODER["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [tr.step(ids, lbl) for _ in range(ENCODER["iters"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    log(f"  {n_params / 1e6:.1f} M parameters; "
        f"{ENCODER['warmup'] + ENCODER['iters']} steps at "
        f"B={ENCODER['batch']}, L={ENCODER['seq']}, dropout "
        f"{ENCODER['dropout']}: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {launches}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"BERT loss not finite and falling: {losses}")
    if any(launches.values()):
        fail(f"the BERT train step launched a kernel of the port: "
             f"{launches}")
    p_wall, busy, top, _ = profile_steps(lambda: tr.step(ids, lbl),
                                      ENCODER["profiled"])
    return dict(wall=wall, peak=peak, p_wall=p_wall, busy=busy, top=top,
                n_params=n_params, cfg=cfg)


def encoder_numbers(card, run):
    """bench_bert's numbers from `run`: samples/s, tokens/s, ms per step,
    peak memory, model TFLOP/s by bench.py's formula, and the idle share
    and top kernels under torch.profiler."""
    cfg, b, seq = run["cfg"], ENCODER["batch"], ENCODER["seq"]
    step_s = run["wall"] / ENCODER["iters"]
    flops = 3 * (2 * run["n_params"] * b * seq
                 + 4 * b * seq * seq * cfg.hidden_size * cfg.num_layers)
    log(f"  [{card}] BERT-base pretraining ({run['n_params'] / 1e6:.1f} M "
        f"parameters, B={b}, L={seq}, bf16 amp, composite attention, "
        f"dropout {ENCODER['dropout']}): {b / step_s:.2f} samples/s, "
        f"{b * seq / step_s:.1f} tokens/s, {step_s * 1e3:.2f} ms per step "
        f"over {ENCODER['iters']} steps; peak memory "
        f"{run['peak'] / 2**30:.2f} GiB; {flops / 1e12:.3f} TFLOP of model "
        f"flops per step (bench.py's formula) -> "
        f"{flops / step_s / 1e12:.1f} TFLOP/s = "
        f"{flops / step_s / FP32_FLOPS_PER_S:.1%} of the fp32 CUDA-core "
        f"peak")
    if run["busy"] > 0:
        busy_ms = run["busy"] / ENCODER["profiled"] * 1e3
        log(f"  [{card}] BERT-base under torch.profiler "
            f"({ENCODER['profiled']} steps): wall {run['p_wall']:.3f} s, "
            f"kernels busy {run['busy']:.3f} s on the device, idle share "
            f"{1 - run['busy'] / run['p_wall']:.1%}; kernel time per step "
            f"{busy_ms:.2f} ms = {busy_ms / (step_s * 1e3):.1%} of the "
            f"unprofiled step")
        for key, (us, count) in run["top"]:
            log(f"    {us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
    else:
        log(f"  [{card}] BERT-base: torch.profiler recorded no device "
            f"time: device idle share not measured")


# ------------------------------ main ------------------------------------


def paged_numbers(pa, card, kv_dtype, tag):
    """Each paged kernel and its plain version at its main path's shape
    over `kv_dtype` pools, beside its bound.  Returns name + tag ->
    (ms, plain_ms, bound_ms, bound_by, None)."""
    main_rng = np.random.default_rng(4)
    main_cases = [
        ("ragged_paged_attention", "T=72, S=9",
         make_case(np.random.default_rng(2), unowned=False,
                   desc=main_path_desc(np.random.default_rng(3)),
                   kv_dtype=kv_dtype, **MAIN),
         attn_args, bound_of, pa.ragged_paged_attention_kernel,
         pa.ragged_paged_attention_torch),
        ("paged_decode_attention", "B=8, contexts 16..632",
         make_decode_case(main_rng, lens=main_decode_lens(main_rng),
                          kv_dtype=kv_dtype, **MAIN), decode_args,
         decode_bound_of, pa.paged_decode_attention_kernel,
         pa.paged_decode_attention_torch),
        ("chunk_prefill_attention", "n=64, start=536",
         make_chunk_case(main_rng, start=536, n=64, kv_dtype=kv_dtype,
                         **MAIN), chunk_args, chunk_bound_of,
         pa.chunk_prefill_attention_kernel,
         pa.chunk_prefill_attention_torch)]
    numbers = {}
    dtype = str(kv_dtype).replace("torch.", "")
    for name, shape, case, args_of, bound_fn, kernel, plain in main_cases:
        args, kw = args_of(case), case["scales"]
        ms = time_ms(lambda: kernel(*args, **kw), 200)
        paced = time_ms(lambda: kernel(*args, **kw), 200, queued=False)
        plain_ms = time_ms(lambda: plain(*args, **kw), 50)
        # the wrapper's zero-fill of its arrival counters, one per (row,
        # head), alone: a kernel launch of its own before each call
        fill_ms = time_ms(lambda: torch.zeros(
            case["q"].shape[0] * case["q"].shape[1], dtype=torch.int32,
            device="cuda"), 200)
        bound_ms, bound_by, nbytes, flops = bound_fn(case)
        numbers[name + tag] = (ms, plain_ms, bound_ms, bound_by, None)
        blocks = paged_blocks(pa, name, case)
        log(f"  [{card}] {name} ({dtype} pools) at the main-path shape "
            f"({shape}, H=12, D=64, page_size=16, pages bucket 64): "
            f"{ms * 1e3:.1f} us (launch-paced {paced * 1e3:.1f} us; its "
            f"counters' zero-fill alone {fill_ms * 1e3:.1f} us); plain "
            f"version {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us "
            f"by {bound_by} ({nbytes} B, {flops} flop) = "
            f"{bound_ms / ms:.1%} of bound{blocks}")
    return numbers


def paged_scaling(pa, card, kv_dtype):
    """The decode and chunk kernels as their work grows, through the
    wrappers: decode over the first 1, 2, 4 and 8 of the main path's
    rows, and the main path's prompt's last 16, 32 and 64 rows as one
    chunk, each with its live blocks.  Where time grows more slowly than
    blocks, the chain of dependent steps within a block sets it."""
    dtype = str(kv_dtype).replace("torch.", "")
    lens = main_decode_lens(np.random.default_rng(4))
    parts = []
    for b in (1, 2, 4, 8):
        case = make_decode_case(np.random.default_rng(5), lens=lens[:b],
                                kv_dtype=kv_dtype, **MAIN)
        ms = time_ms(lambda: pa.paged_decode_attention_kernel(
            *decode_args(case), **case["scales"]), 200)
        live = len(pa.decode_work_items(
            lens[:b], MAIN["ps"], MAIN["pages_bucket"])) * MAIN["h"]
        parts.append(f"B={b} {ms * 1e3:.1f} us ({live} blocks)")
    log(f"  [{card}] paged_decode_attention ({dtype} pools) by batch: "
        + ", ".join(parts))
    parts = []
    for n in (16, 32, 64):
        case = make_chunk_case(np.random.default_rng(5), start=600 - n, n=n,
                               kv_dtype=kv_dtype, **MAIN)
        ms = time_ms(lambda: pa.chunk_prefill_attention_kernel(
            *chunk_args(case), **case["scales"]), 200)
        live = pa.chunk_grid_blocks(n, 600 - n, MAIN["h"], MAIN["ps"],
                                    MAIN["pages_bucket"])
        parts.append(f"n={n} {ms * 1e3:.1f} us ({live} blocks)")
    log(f"  [{card}] chunk_prefill_attention ({dtype} pools) by chunk rows "
        f"(ending at key 600): " + ", ".join(parts))


def paged_blocks(pa, name, case):
    """A paged kernel's blocks for `case`: live ones (its work items
    times the heads, by the host mirror of its split) of those launched
    (its grid)."""
    rows, h, _ = case["q"].shape
    ps = MAIN["ps"]
    if name == "ragged_paged_attention":
        s_n, max_pages = case["page_tables"].shape
        items = pa.ragged_work_items(
            case["starts"].tolist(), case["lens"].tolist(),
            case["kv_lens"].tolist(), ps, max_pages, rows)
        grid = pa.ragged_grid_blocks(rows, s_n, h, max_pages, ps)
    elif name == "paged_decode_attention":
        max_pages = case["page_tables"].shape[1]
        items = pa.decode_work_items(case["seq_lens"].tolist(), ps,
                                     max_pages)
        grid = pa.decode_grid_blocks(rows, h, max_pages, ps)
    else:
        max_pages = case["page_table"].shape[0]
        items = pa.chunk_work_items(rows, case["start"], ps, max_pages)
        grid = pa.chunk_grid_blocks(rows, case["start"], h, ps, max_pages)
    return f"; blocks {len(items) * h} live of {grid} launched"


def write_numbers(card):
    """The int8 write (plain torch ops) of one layer's K and V at the
    ragged step's shape: 72 packed rows into int8 pools of 512 pages of
    16 with their scales.  Its kernels' device time comes from
    torch.profiler: the write issues a few dozen small kernels from
    Python, so a run of calls is paced by the host's launches, which the
    launch-paced time shows."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.generation.quantized_kv import quantized_pool_write

    rng = np.random.default_rng(6)
    h, d, ps, n_pages = MAIN["h"], MAIN["d"], MAIN["ps"], MAIN["num_pages"]
    pools = [torch.zeros((n_pages + 1, ps, h, d), dtype=torch.int8,
                         device="cuda") for _ in range(2)]
    scales = [torch.zeros((n_pages + 1, h), device="cuda")
              for _ in range(2)]
    slots = rng.permutation(n_pages * ps)[:72]
    pages = torch.as_tensor(slots // ps, dtype=torch.int32, device="cuda")
    rows = torch.as_tensor(slots % ps, dtype=torch.int32, device="cuda")
    x = [torch.as_tensor(rng.standard_normal((72, h, d)),
                         dtype=torch.float32, device="cuda")
         for _ in range(2)]

    def write():
        for pool, sc, xx in zip(pools, scales, x):
            quantized_pool_write(pool, sc, pages, rows, xx, "token")

    paced = time_ms(write, 100, queued=False)
    calls = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            write()
        torch.cuda.synchronize()
    per_kernel = device_kernels(prof)
    n_kernels = sum(n for _, n in per_kernel.values()) / calls
    dev_us = sum(us for us, _ in per_kernel.values()) / calls
    what = (f"device time {dev_us:.1f} us in {n_kernels:.0f} kernels "
            f"(torch.profiler), {MODEL['num_layers'] * dev_us / 1e3:.3f} "
            f"ms per step of {MODEL['num_layers']} layers" if dev_us > 0
            else "device time not measured (no device events)")
    log(f"  [{card}] int8 write of one layer's K and V (72 rows into 512 "
        f"pages of 16, H=12, D=64; plain torch ops): {what}; launch-paced "
        f"{paced * 1e3:.1f} us per layer on this host")


# the paged kernels' libraries and their kernels' names: 12 instantiations
# each (f32, bf16, int8 x 16-byte or plain-load staging x D up to 64 or
# 128) of the one split walk
PAGED_ENTRIES = {"ragged_paged_attention": "rpa_kernel",
                 "chunk_prefill_attention": "cpa_kernel",
                 "paged_decode_attention": "pda_kernel"}


def check_paged_spills(build):
    """Fail if ptxas spilled in any instantiation of the ragged, chunk or
    decode kernel, or reported other than 12 of one.  Each report comes
    from this run's build or, if the library was built before, from
    compiling the source once more into the build directory."""
    for lib, kernel in PAGED_ENTRIES.items():
        report = build.build_logs.get(lib)
        if report is None:
            out = build.BUILD_DIR / f"{lib}_ptxas_report.so"
            report = subprocess.run(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                 str(build.CSRC_DIR / f"{lib}.cu")],
                capture_output=True, text=True, check=True,
                timeout=600).stdout
            out.unlink(missing_ok=True)
        entries = [line for line in report.splitlines()
                   if "Compiling entry" in line and kernel in line]
        spills = [line.strip() for line in report.splitlines()
                  if "spill" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        log(f"  {kernel}: {len(entries)} instantiations, "
            f"{'spills: ' + '; '.join(spills) if spills else 'no spills'}")
        if len(entries) != 12 or spills:
            fail(f"{kernel}: want 12 instantiations and no spill")


def check_tensor_cores(build, lib):
    """Count the tensor-core instructions (HMMA) in the SASS of each
    instantiation of the flash kernels (forward, dK/dV and dQ), with
    cuobjdump from the toolkit that built them; fail if one has none."""
    from pathlib import Path

    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    if not cuobjdump.is_file():
        log("  HMMA in the flash kernels' SASS: not checked (no cuobjdump "
            "in the toolkit)")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    flash = {fn: n for fn, n in counts.items()
             if any(k in fn for k in ("fa_fwd_kernel", "fa_dkdv_kernel",
                                      "fa_dq_kernel"))}
    log("  HMMA instructions in the flash kernels' SASS (cuobjdump): "
        + ", ".join(f"{fn} {n}" for fn, n in sorted(flash.items())))
    if len(flash) != 18 or not all(flash.values()):
        fail(f"want 18 flash instantiations, each with HMMA: {flash}")


# ---- phase 16: data parallel, ZeRO and the pipeline -----------------------

def dp_loss(m, ids, lbl, generator):
    return m.loss(ids, lbl, generator=generator)


def flash_launch_counts():
    launches = read_launches()
    return {k["name"]: launches[k["name"]] for k in FLASH_KERNELS}


def dp_trainer(model, zero_stage, devices, lr=TRAIN["lr"]):
    """`bench_gpt_zero`'s step over ``{"data": len(devices)}``: AdamW at
    `lr`, bf16 amp, at `zero_stage`."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import CompiledTrainStep, build_mesh

    return CompiledTrainStep(
        model, dp_loss, AdamW(learning_rate=lr), build_mesh(
            {"data": len(devices)}, devices=devices),
        amp_dtype=torch.bfloat16, zero_stage=zero_stage)


def pipe_trainer(model, devices, remat, num_micro=DP["micro"]):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (GPTPipeAdapter,
                                           PipelinedTrainStep, build_mesh)

    return PipelinedTrainStep(
        GPTPipeAdapter(model), AdamW(learning_rate=TRAIN["lr"]),
        build_mesh({"pipe": DP["pipe"], "data": DP["pipe_dp"]},
                   devices=devices), num_micro=num_micro,
        amp_dtype=torch.bfloat16, remat=remat, zero_stage=1)


def timed_training(label, tr, ids, lbl, want, tokens):
    """DP["warmup"] warm-up and DP["iters"] timed steps, every count set
    to 0 just before and read just after; the flash launches against
    `want` per step, the losses finite and falling; then the device idle
    share over DP["profiled"] profiled steps."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [tr.step(ids, lbl) for _ in range(DP["warmup"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [tr.step(ids, lbl) for _ in range(DP["iters"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_launch_counts()
    others = {k: v for k, v in read_launches().items()
              if k not in launches and v}
    steps = DP["warmup"] + DP["iters"]
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{label}: loss not finite and falling: {losses}")
    for name, n in launches.items():
        if n != want[name] * steps:
            fail(f"{label}: {name} launched {n} times over {steps} steps, "
                 f"want {want[name]} a step")
    if others:
        fail(f"{label}: the train step launched a paged kernel: {others}")
    p_wall, busy, _, _ = profile_steps(lambda: tr.step(ids, lbl),
                                    DP["profiled"])
    ms = wall / DP["iters"] * 1e3
    return dict(ms=ms, tokens_s=tokens / ms * 1e3, peak=peak,
                losses=losses, idle=(1 - busy / p_wall) if busy > 0 else None,
                launches={k: v // steps for k, v in launches.items()},
                moved=tr.moved_bytes)


def dp_base():
    """The bench's model at full width on card 0 (seed 0, dropout 0.1):
    each run of phase 16 (a), (b) and (d) starts from a copy of it."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    return GPTForPretraining(GPTConfig(dropout=TRAIN["dropout"],
                                       **TRAIN_MODEL), seed=0, device="cuda")


def phase_dp_run(base):
    """Phase 16 (a): the bench at full width over ``{"data": 4}`` on card
    0, at ZeRO stages 0-3, each from a copy of `base`."""
    cfg = base.config
    dp = DP["dp"]
    ids, lbl = (x.cuda() for x in train_batch(dp * TRAIN["batch"],
                                               TRAIN["seq"], cfg.vocab_size))
    want = {k["name"]: dp * cfg.num_layers for k in FLASH_KERNELS}
    out = {}
    for stage in DP["stages"]:
        model = copy.deepcopy(base)
        tr = dp_trainer(model, stage, ["cuda:0"] * dp)
        own = tr.persistent_bytes()[0]
        run = timed_training(f"data 4, stage {stage}", tr, ids, lbl, want,
                             dp * TRAIN["batch"] * TRAIN["seq"])
        run.update(own=own, collective=tr.collective_bytes(),
                   pad=tr.layout.pad, numel=tr.layout.numel)
        log(f"  data 4, ZeRO {stage}: {run['ms']:.2f} ms per step, "
            f"{run['tokens_s']:.1f} tokens/s, losses {run['losses'][0]:.4f}"
            f" -> {run['losses'][-1]:.4f}, peak {run['peak'] / 2**30:.2f} "
            f"GiB; per shard: parameters {own['params'] / 2**20:.1f} MiB, "
            f"gradients {own['grads'] / 2**20:.1f} MiB, optimizer state "
            f"{own['optimizer'] / 2**20:.1f} MiB; flash launches per step "
            f"{run['launches']}")
        out[stage] = run
        del tr, model
        torch.cuda.empty_cache()
    full, opt0 = out[0]["own"]["params"], out[0]["own"]["optimizer"]
    slack = 2 * 4 * out[0]["pad"] + 8 * len(list(base.parameters()))
    for stage in DP["stages"]:
        own = out[stage]["own"]
        if stage >= 1 and abs(own["optimizer"] * dp - opt0) > dp * slack:
            fail(f"ZeRO {stage}: optimizer state {own['optimizer']} bytes a "
                 f"shard, want 1/{dp} of stage 0's {opt0}")
        if stage >= 3 and abs(own["params"] * dp - full) > 4 * out[0]["pad"]:
            fail(f"ZeRO 3: parameters {own['params']} bytes a shard, want "
                 f"1/{dp} of {full}")
    return out


def phase_pipe_run(base):
    """Phase 16 (b): ``{"pipe": 2, "data": 2}``, 4 micro-batches, ZeRO 1,
    remat off and on, each from a copy of `base`."""
    cfg = base.config
    dp, M = DP["pipe_dp"], DP["micro"]
    ids, lbl = (x.cuda() for x in train_batch(dp * TRAIN["batch"],
                                               TRAIN["seq"], cfg.vocab_size))
    out = {}
    for remat in (False, True):
        model = copy.deepcopy(base)
        tr = pipe_trainer(model, ["cuda:0"] * (DP["pipe"] * dp), remat)
        per = dp * M * cfg.num_layers
        want = {"flash_attention_fwd": per * (2 if remat else 1),
                "flash_attention_bwd_dkdv": per,
                "flash_attention_bwd_dq": per}
        run = timed_training(f"pipe 2 x data 2, remat {remat}", tr, ids, lbl,
                             want, dp * TRAIN["batch"] * TRAIN["seq"])
        log(f"  pipe 2 x data 2, M {M}, remat {'on' if remat else 'off'}: "
            f"{run['ms']:.2f} ms per step, {run['tokens_s']:.1f} tokens/s, "
            f"losses {run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}, peak "
            f"{run['peak'] / 2**30:.2f} GiB; flash launches per step "
            f"{run['launches']}")
        out[remat] = run
        del tr, model
        torch.cuda.empty_cache()
    return out


def phase_dp_held():
    """Phase 16 (c) at dropout 0, full width and HELD_LAYERS layers, B
    DP["held_batch"] a shard, TRAIN["held_steps"] steps: ``{"data": 4}``
    on the card at each stage against the card's one-device step on the
    global batch; stages 1-3 against stage 0; the pipeline on the card
    against the same pipeline on the CPU."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import TrainStep

    cfg = GPTConfig(dropout=0.0, **dict(TRAIN_MODEL,
                                        num_layers=HELD_LAYERS))
    dp = DP["dp"]
    ids, lbl = train_batch(dp * DP["held_batch"], TRAIN["seq"],
                           cfg.vocab_size)
    base = GPTForPretraining(cfg, seed=0, device="cpu").numpy_params()
    steps = TRAIN["held_steps"]

    def model_on(device):
        return GPTForPretraining.from_numpy_params(base, cfg, device=device)

    def losses_of(tr):
        return [float(tr.step(ids, lbl)) for _ in range(steps)]

    t0 = time.perf_counter()
    one = losses_of(TrainStep(model_on("cuda"), dp_loss, AdamW(
        learning_rate=TRAIN["lr"]), amp_dtype=torch.bfloat16))
    runs = {}
    for stage in DP["stages"]:
        m = model_on("cuda")
        tr = dp_trainer(m, stage, ["cuda:0"] * dp)
        runs[stage] = (losses_of(tr), {n: p.float().cpu().numpy()
                                       for n, p in tr.full_params().items()})
        log(f"  data 4, ZeRO {stage}: losses {runs[stage][0]} (one device "
            f"{one})")
        for a, b in zip(runs[stage][0], one):
            if not math.isfinite(a) or abs(a - b) > TRAIN_LOSS_TOL * abs(b):
                fail(f"data 4, ZeRO {stage}: loss {a} against the one-device"
                     f" step's {b}, past {TRAIN_LOSS_TOL} relative")
        del tr, m
    l0, p0 = runs[0]
    for stage in DP["stages"][1:]:
        ls, ps = runs[stage]
        for a, b in zip(ls, l0):
            if abs(a - b) > 1e-5 * abs(b):
                fail(f"ZeRO {stage}: loss {a} against stage 0's {b}, past "
                     f"1e-5 relative")
        far, total, worst = 0, 0, 0.0
        for n, w in p0.items():
            diff = np.abs(ps[n] - w)
            worst = max(worst, float(diff.max()))
            far += int((diff > DP_PARAM_TOL).sum())
            total += diff.size
        log(f"  ZeRO {stage} against ZeRO 0 after {steps} steps: max |diff| "
            f"{worst:.3e}, {far} of {total} entries past {DP_PARAM_TOL}")
        if worst > 2 * steps * TRAIN["lr"] or far > total * DP_PARAM_SHARE:
            fail(f"ZeRO {stage}: parameters past the Adam rule against "
                 f"ZeRO 0 ({far} of {total} past {DP_PARAM_TOL}, max "
                 f"{worst})")
    log(f"  ({time.perf_counter() - t0:.1f} s on the card)")
    pipe = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = model_on(device)
        tr = pipe_trainer(m, [device] * (DP["pipe"] * DP["pipe_dp"]),
                          remat=True, num_micro=DP["held_micro"])
        b = DP["pipe_dp"] * DP["held_batch"]
        pipe[device] = [float(tr.step(ids[:b], lbl[:b]))
                        for _ in range(steps)]
        log(f"  pipe 2 x data 2 on the {device}: "
            f"{time.perf_counter() - t0:.1f} s")
        del tr, m
    log(f"  pipe 2 x data 2: card {pipe['cuda']}, CPU {pipe['cpu']}")
    for a, b in zip(pipe["cuda"], pipe["cpu"]):
        if not math.isfinite(a) or abs(a - b) > TRAIN_LOSS_TOL * abs(b):
            fail(f"pipeline card vs CPU: loss {a} against {b}, past "
                 f"{TRAIN_LOSS_TOL} relative")
    torch.cuda.empty_cache()


def phase_dp_cross_card(base):
    """Phase 16 (d): (a) at ZeRO 3 over ``cuda:0..3`` where the call sees
    4 cards; a line saying so otherwise."""
    n = torch.cuda.device_count()
    if n < DP["dp"]:
        log(f"  across cards: this call sees {n} card(s); the run over "
            f"cuda:0..{DP['dp'] - 1} needs {DP['dp']} and was not made")
        return None
    cfg = base.config
    model = copy.deepcopy(base)
    tr = dp_trainer(model, 3, [f"cuda:{i}" for i in range(DP["dp"])])
    ids, lbl = (x.cuda() for x in train_batch(
        DP["dp"] * TRAIN["batch"], TRAIN["seq"], cfg.vocab_size))
    want = {k["name"]: DP["dp"] * cfg.num_layers for k in FLASH_KERNELS}
    run = timed_training("data 4 across cards, stage 3", tr, ids, lbl, want,
                         DP["dp"] * TRAIN["batch"] * TRAIN["seq"])
    log(f"  across cards (cuda:0..3), ZeRO 3: {run['ms']:.2f} ms per step, "
        f"{run['tokens_s']:.1f} tokens/s, {run['moved'] / 2**20:.1f} MiB "
        f"moved between cards per step")
    return run


def dp_numbers(card, dp_out, pipe_out):
    for stage, run in dp_out.items():
        idle = ("not measured" if run["idle"] is None
                else f"{run['idle']:.1%}")
        log(f"  [{card}] data 4 (one card), ZeRO {stage}: {run['ms']:.2f} ms "
            f"per step, {run['tokens_s']:.1f} tokens/s, idle share {idle}, "
            f"peak {run['peak'] / 2**30:.2f} GiB, collective bytes per step "
            f"{run['collective'] / 2**20:.1f} MiB (a ring's, per rank; "
            f"{run['moved']} bytes left the card)")
    for remat, run in pipe_out.items():
        idle = ("not measured" if run["idle"] is None
                else f"{run['idle']:.1%}")
        log(f"  [{card}] pipe 2 x data 2 (one card), M {DP['micro']}, remat "
            f"{'on' if remat else 'off'}: {run['ms']:.2f} ms per step, "
            f"{run['tokens_s']:.1f} tokens/s, idle share {idle}, peak "
            f"{run['peak'] / 2**30:.2f} GiB")

# ---- phase 17: the model, seq and expert axes --------------------------


def hybrid_trainer(model, shape, device, zero_stage=None, amp=None):
    """AdamW at TRAIN["lr"] over the mesh `shape`, every shard on
    `device`."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import CompiledTrainStep, build_mesh

    n = math.prod(shape.values())
    return CompiledTrainStep(
        model, dp_loss, AdamW(learning_rate=TRAIN["lr"]),
        build_mesh(shape, devices=[device] * n), amp_dtype=amp,
        zero_stage=zero_stage)


@contextlib.contextmanager
def recorded_routing():
    """Each MoE routing's top-2 choices ([tokens, experts] bool, on the
    CPU) while the context is open, in call order."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import moe_layer

    seen, real = [], moe_layer.top2_dispatch

    def record(logits, capacity):
        out = real(logits, capacity)
        seen.append(out[1].any(-1).cpu())
        return out

    moe_layer.top2_dispatch = record
    try:
        yield seen
    finally:
        moe_layer.top2_dispatch = real


def phase_hybrid_held(fa, rng):
    """Phase 17 (a) at dropout 0, fp32, full width and HELD_LAYERS layers:
    {"data": 2, "model": 2, "seq": 2} at ZeRO 3 (ring and Ulysses), the
    MoE over {"data": 2, "model": 2, "expert": 2} and the pipeline over
    {"pipe": 2, "model": 2}, each card vs CPU; the seq mesh also against
    the card's one-device step on the global batch; the MoE's expert
    choices card vs CPU; and the flash kernels at each rank's shapes of
    the timed runs against their plain versions.  Returns the kernels'
    worst max |diff|."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (GPTPipeAdapter,
                                           PipelinedTrainStep, TrainStep,
                                           build_mesh)

    steps = TRAIN["held_steps"]
    ids, lbl = train_batch(2 * HYBRID["held_batch"], HYBRID["held_seq"],
                           TRAIN_MODEL["vocab_size"])

    def config(**kw):
        return GPTConfig(dropout=0.0, **dict(TRAIN_MODEL,
                                             num_layers=HELD_LAYERS, **kw))

    weights = {}

    def model_on(device, **kw):
        key = tuple(sorted(kw.items()))
        if key not in weights:
            weights[key] = GPTForPretraining(config(**kw), seed=0,
                                             device="cpu").numpy_params()
        return GPTForPretraining.from_numpy_params(weights[key],
                                                   config(**kw),
                                                   device=device)

    def hold(label, runs):
        card, cpu = runs["cuda"], runs["cpu"]
        log(f"  {label}: card {card}, CPU {cpu}")
        for a, b in zip(card, cpu):
            if not math.isfinite(a) or abs(a - b) > TRAIN_LOSS_TOL * abs(b):
                fail(f"{label} card vs CPU: loss {a} against {b}, past "
                     f"{TRAIN_LOSS_TOL} relative")

    t0 = time.perf_counter()
    one = TrainStep(model_on("cuda"), dp_loss,
                    AdamW(learning_rate=TRAIN["lr"]))
    one = [float(one.step(ids, lbl)) for _ in range(steps)]
    for cp_mode in ("ring", "ulysses"):
        runs = {}
        for device in ("cuda", "cpu"):
            tr = hybrid_trainer(model_on(device, cp_mode=cp_mode),
                                HYBRID_DMS, device, zero_stage=3)
            runs[device] = [float(tr.step(ids, lbl)) for _ in range(steps)]
            del tr
        label = f"data 2 x model 2 x seq 2, ZeRO 3, {cp_mode}"
        hold(label, runs)
        for a, b in zip(runs["cuda"], one):
            if abs(a - b) > TRAIN_LOSS_TOL * abs(b):
                fail(f"{label}: loss {a} against the one-device step's {b}"
                     f", past {TRAIN_LOSS_TOL} relative")
        log(f"    (one device on the global batch: {one})")
    runs, routes = {}, {}
    for device in ("cuda", "cpu"):
        tr = hybrid_trainer(model_on(device,
                                     num_experts=HYBRID["held_experts"]),
                            HYBRID_DME, device)
        with recorded_routing() as seen:
            runs[device] = [float(tr.step(ids, lbl)) for _ in range(steps)]
        routes[device] = seen
        del tr
    hold(f"data 2 x model 2 x expert 2, {HYBRID['held_experts']} experts",
         runs)
    per_step = len(routes["cuda"]) // steps
    flips = [int((a != b).any(-1).sum()) for a, b in zip(routes["cuda"],
                                                         routes["cpu"])]
    by_step = [sum(flips[i:i + per_step])
               for i in range(0, len(flips), per_step)]
    log(f"    expert choices card vs CPU: {len(flips)} routings "
        f"({per_step} a step: ranks x blocks), tokens routed otherwise "
        f"per step {by_step}")
    if len(routes["cuda"]) != len(routes["cpu"]) or any(flips[:per_step]):
        fail(f"MoE: the card's step-1 expert choices differ from the "
             f"CPU's: {flips[:per_step]} tokens per routing")
    runs = {}
    for device in ("cuda", "cpu"):
        tr = PipelinedTrainStep(
            GPTPipeAdapter(model_on(device)),
            AdamW(learning_rate=TRAIN["lr"]),
            build_mesh(HYBRID_PM, devices=[device] * 4),
            num_micro=HYBRID["micro"])
        runs[device] = [float(tr.step(ids, lbl)) for _ in range(steps)]
        del tr
    hold("pipe 2 x model 2, remat", runs)
    log(f"  ({time.perf_counter() - t0:.1f} s, card and CPU)")
    worst = dict.fromkeys([k["name"] for k in FLASH_KERNELS], 0.0)
    heads, b = TRAIN_MODEL["num_heads"], TRAIN["batch"] // 2
    for name, h in (("ulysses_rank", heads // 4), ("tp_rank", heads // 2)):
        hold_flash(fa, rng, f"{name}_b{b}_h{h}_l{TRAIN['seq']}", dict(
            bh=b * h, heads=h, lq=TRAIN["seq"], lk=TRAIN["seq"], d=64,
            causal=True), worst)
    torch.cuda.empty_cache()
    return worst


def phase_hybrid_run():
    """Phase 17 (b): bench_gpt_zero's step at 12 layers over {"data": 2,
    "model": 2, "seq": 2} at ZeRO 3 (Ulysses, then ring) and the MoE with
    HYBRID["experts"] experts over {"data": 2, "model": 2, "expert": 2},
    every shard on card 0; each from seed 0."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    cfg = GPTConfig(dropout=TRAIN["dropout"], **TRAIN_MODEL)
    ids, lbl = (x.cuda() for x in train_batch(
        TRAIN["batch"], TRAIN["seq"], cfg.vocab_size))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    out = {}
    for label, shape, extra, zero in (
            ("ulysses", HYBRID_DMS, dict(cp_mode="ulysses"), 3),
            ("ring", HYBRID_DMS, dict(cp_mode="ring"), 3),
            ("moe", HYBRID_DME, dict(num_experts=HYBRID["experts"]), None)):
        model = GPTForPretraining(GPTConfig(dropout=TRAIN["dropout"],
                                            **TRAIN_MODEL, **extra),
                                  seed=0, device="cuda")
        tr = hybrid_trainer(model, shape, "cuda", zero_stage=zero,
                            amp=torch.bfloat16)
        ranks = math.prod(shape.values()) // shape["data"]
        per = 0 if label == "ring" else shape["data"] * ranks \
            * cfg.num_layers
        want = {k["name"]: per for k in FLASH_KERNELS}
        name = f"{shape} {label}"
        run = timed_training(name, tr, ids, lbl, want, tokens)
        run.update(own=tr.persistent_bytes()[0],
                   collective=tr.collective_bytes_by_axis(),
                   stage=tr.zero_stage, shape=shape, cp_mode=extra.get(
                       "cp_mode"), experts=extra.get("num_experts"))
        own = run["own"]
        log(f"  {name}, ZeRO {tr.zero_stage}: {run['ms']:.2f} ms per step, "
            f"{run['tokens_s']:.1f} tokens/s, losses "
            f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}, peak "
            f"{run['peak'] / 2**30:.2f} GiB; a rank holds parameters "
            f"{own['params'] / 2**20:.1f} MiB, gradients "
            f"{own['grads'] / 2**20:.1f} MiB, optimizer state "
            f"{own['optimizer'] / 2**20:.1f} MiB; collective bytes per "
            f"step by axis {run['collective']}; flash launches per step "
            f"{run['launches']}")
        out[label] = run
        del tr, model
        torch.cuda.empty_cache()
    return out


def hybrid_numbers(card, out):
    for label, run in out.items():
        idle = ("not measured" if run["idle"] is None
                else f"{run['idle']:.1%}")
        sent = {a: round(b / 2**20, 1) for a, b in run["collective"].items()}
        log(f"  [{card}] {run['shape']} {label} (one card), ZeRO "
            f"{run['stage']}: {run['ms']:.2f} ms per step, "
            f"{run['tokens_s']:.1f} tokens/s, idle share {idle}, peak "
            f"{run['peak'] / 2**30:.2f} GiB, collective MiB per step by "
            f"axis (all ranks) {sent}")


# ---- phase 18: dygraph AMP and the high-level surface ---------------------

# held at full GPT width, HELD_LAYERS layers; timed at bench_gpt_zero's
# model (phase 8's), BERT at bench_bert's batch; LeNet through hapi
DYGRAPH = dict(lr=1e-4, held_batch=2, held_seq=128, held_steps=2,
               warmup=2, iters=5, profiled=1, lenet_n=256, lenet_batch=64,
               lenet_epochs=2, workers=2)
DYGRAPH_LOSS_TOL = 1e-2     # O1 AMP card vs CPU: a bf16 loss, 1-2 ulps
HAPI_LOSS_TOL = 1e-5        # hapi LeNet, fp32 with TF32 off
DYGRAPH_FLASH_SHAPES = {
    "held_b2_h12_l128_d64_causal_bf16": dict(
        bh=DYGRAPH["held_batch"] * 12, heads=12, lq=DYGRAPH["held_seq"],
        lk=DYGRAPH["held_seq"], d=64, causal=True, dtype=torch.bfloat16),
    "amp_b8_h12_l512_d64_causal_bf16": dict(FLASH_MAIN,
                                            dtype=torch.bfloat16)}


def flash_launches_by_dtype(dtype):
    """Each flash kernel's launches in `dtype` since the counts were
    last set to 0."""
    return {k["name"]: wrappers()[k["name"]][0].launches_by_dtype[dtype]
            for k in FLASH_KERNELS}


class EagerStep:
    """One eager step of ``model.loss(*batch, generator=)`` with AdamW at
    `lr`: under O1 ``amp.auto_cast`` with a ``GradScaler`` (`amp_on`),
    in fp32 otherwise (the scaler then disabled), the idiom
    ``scaler.scale(loss).backward(); scaler.step(opt); scaler.update()``.
    Returns the loss, detached."""

    def __init__(self, model, lr, amp_on, generator=None):
        from paddle_tpu_torch import amp, optimizer

        self.model, self.amp_on, self.generator = model, amp_on, generator
        self.opt = optimizer.AdamW(learning_rate=lr,
                                   parameters=model.parameters())
        self.scaler = amp.GradScaler(enable=amp_on)

    def __call__(self, *batch):
        from paddle_tpu_torch import amp

        with amp.auto_cast(enable=self.amp_on):
            loss = self.model.loss(*batch, generator=self.generator)
        self.scaler.scale(loss).backward()
        self.scaler.step(self.opt)
        self.scaler.update()
        self.opt.clear_grad()
        return loss.detach()


def phase_dygraph_held(fa, rng):
    """(a): GPT's eager O1 AMP steps card vs CPU at HELD_LAYERS, then the
    bf16 flash kernels at this phase's shapes against their plain
    versions.  Returns each kernel's worst max |diff|."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    d = DYGRAPH
    cfg = GPTConfig(dropout=0.0, **dict(TRAIN_MODEL, num_layers=HELD_LAYERS))
    ids, lbl = train_batch(d["held_batch"], d["held_seq"], cfg.vocab_size)
    cpu_model = GPTForPretraining(cfg, seed=0, device="cpu")
    card_model = GPTForPretraining.from_numpy_params(
        cpu_model.numpy_params(), cfg, device="cuda")
    runs = {}
    for device, model in (("cuda", card_model), ("cpu", cpu_model)):
        step = EagerStep(model, d["lr"], True)
        batch = (ids.to(device), lbl.to(device))
        t0 = time.perf_counter()
        reset_launches()
        losses, dtypes = [], set()
        for _ in range(d["held_steps"]):
            loss = step(*batch)
            dtypes.add(str(loss.dtype))
            losses.append(float(loss))
        launches = flash_launches_by_dtype("bfloat16")
        runs[device] = (losses, step.scaler._scale)
        log(f"  {device}: GPT O1 AMP at {HELD_LAYERS} layers, "
            f"B={d['held_batch']}, L={d['held_seq']}: losses {losses} "
            f"({', '.join(sorted(dtypes))}), scale {step.scaler._scale}; "
            f"bf16 flash launches {launches} "
            f"({time.perf_counter() - t0:.1f} s)")
        want = HELD_LAYERS * d["held_steps"] if device == "cuda" else 0
        if set(launches.values()) != {want}:
            fail(f"GPT O1 AMP on {device}: bf16 flash launches {launches}, "
                 f"want {want} each")
    (card_l, card_s), (cpu_l, cpu_s) = runs["cuda"], runs["cpu"]
    for i, (a, b) in enumerate(zip(card_l, cpu_l)):
        if not math.isfinite(a) or abs(a - b) > DYGRAPH_LOSS_TOL * abs(b):
            fail(f"GPT O1 AMP step {i + 1}: card loss {a} vs CPU {b}, past "
                 f"{DYGRAPH_LOSS_TOL} relative")
    if card_s != cpu_s:
        fail(f"GradScaler scale: card {card_s} vs CPU {cpu_s}")
    worst = dict.fromkeys([k["name"] for k in FLASH_KERNELS], 0.0)
    for case_name, spec in DYGRAPH_FLASH_SHAPES.items():
        hold_flash(fa, rng, case_name, spec, worst)
    return worst


def lenet_data():
    """A synthetic MNIST-shaped set (RandomState(0)): images [N, 1, 28,
    28] in [0, 1) and labels [N, 1]."""
    rs = np.random.RandomState(0)
    n = DYGRAPH["lenet_n"]
    return (rs.rand(n, 1, 28, 28).astype(np.float32),
            rs.randint(0, 10, (n, 1)).astype(np.int64))


def phase_hapi_held():
    """(a): ``hapi.Model(LeNet).fit`` over a 2-worker DataLoader, card vs
    CPU, with ``ModelCheckpoint``; its files loaded back bitwise."""
    import os
    import tempfile

    from paddle_tpu_torch import callbacks, framework, hapi, io, metric, \
        nn, optimizer
    from paddle_tpu_torch.vision.models import LeNet

    class StepLogs(callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.logs = []

        def on_train_batch_end(self, step, logs=None):
            self.logs.append((logs["loss"], logs["acc"]))

    d = DYGRAPH
    x, y = lenet_data()
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        net = LeNet(generator=torch.Generator().manual_seed(0),
                    device=device)
        opt = optimizer.Adam(learning_rate=1e-3,
                             parameters=net.parameters())
        model = hapi.Model(net)
        model.prepare(opt, nn.CrossEntropyLoss(), metric.Accuracy())
        loader = io.DataLoader(io.TensorDataset([x, y]),
                               batch_size=d["lenet_batch"], shuffle=True,
                               num_workers=d["workers"], places=device,
                               timeout=300)
        rec = StepLogs()
        with tempfile.TemporaryDirectory() as ckpt:
            np.random.seed(0)
            model.fit(loader, epochs=d["lenet_epochs"], verbose=0,
                      callbacks=[rec, callbacks.ModelCheckpoint(
                          save_dir=ckpt)])
            for suffix, state in ((".pdparams", net.state_dict()),
                                  (".pdopt", opt.state_dict())):
                back = framework.load(os.path.join(ckpt, "final" + suffix),
                                      device=device)
                if set(back) != set(state):
                    fail(f"ModelCheckpoint {suffix} on {device}: keys "
                         f"differ")
                for k, v in state.items():
                    same = (torch.equal(back[k], v) if torch.is_tensor(v)
                            else back[k] == v)
                    if not same:
                        fail(f"ModelCheckpoint {suffix} on {device}: {k} "
                             f"did not load back bitwise")
        logs = model.evaluate(io.DataLoader(
            io.TensorDataset([x, y]), batch_size=d["lenet_batch"],
            places=device), verbose=0)
        runs[device] = (rec.logs, logs)
        log(f"  {device}: hapi LeNet fit, {len(rec.logs)} steps over a "
            f"{d['workers']}-worker DataLoader: losses "
            f"{rec.logs[0][0]:.6f} -> {rec.logs[-1][0]:.6f}, evaluate "
            f"{logs}; checkpoint loaded back bitwise "
            f"({time.perf_counter() - t0:.1f} s)")
    (card, card_eval), (cpu, cpu_eval) = runs["cuda"], runs["cpu"]
    if len(card) != len(cpu) or not card:
        fail(f"hapi LeNet: {len(card)} card steps vs {len(cpu)} CPU")
    for i, ((la, aa), (lb, ab)) in enumerate(zip(card, cpu)):
        if not math.isfinite(la) or abs(la - lb) > HAPI_LOSS_TOL * abs(lb):
            fail(f"hapi LeNet step {i + 1}: card loss {la} vs CPU {lb}, "
                 f"past {HAPI_LOSS_TOL} relative")
        if aa != ab:
            fail(f"hapi LeNet step {i + 1}: card accuracy {aa} vs CPU {ab}")
    if card_eval["acc"] != cpu_eval["acc"] or abs(
            card_eval["loss"] - cpu_eval["loss"]) > HAPI_LOSS_TOL * abs(
            cpu_eval["loss"]):
        fail(f"hapi LeNet evaluate: card {card_eval} vs CPU {cpu_eval}")


def token_loader(n_steps, batch, seq, vocab, device):
    """An ``io.DataLoader`` of `n_steps` batches of ``train_batch``'s one
    batch, repeated (bench.py's runs step on one batch)."""
    from paddle_tpu_torch import io

    ids, lbl = (t.numpy() for t in train_batch(batch, seq, vocab))
    return io.DataLoader(io.TensorDataset([np.tile(ids, (n_steps, 1)),
                                           np.tile(lbl, (n_steps, 1))]),
                         batch_size=batch, places=device)


def dygraph_timed(label, model, lr, amp_on, batches, want, dtype,
                  generator=None):
    """2 warm-up, 5 timed (every count set to 0 just before, read just
    after) and 1 profiled eager step of `model` on `batches`; `want`
    launches of each flash kernel a timed step, in `dtype`."""
    d = DYGRAPH
    step = EagerStep(model, lr, amp_on, generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(*next(batches)) for _ in range(d["warmup"])]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses += [step(*next(batches)) for _ in range(d["iters"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    typed = flash_launches_by_dtype(dtype)
    peak = torch.cuda.max_memory_allocated()
    p_wall, busy, top, _ = profile_steps(lambda: step(*next(batches)),
                                      d["profiled"])
    losses = [float(x) for x in losses]
    log(f"  {label}: losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"over {d['iters']} steps {launches}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"{label}: loss not finite and falling: {losses}")
    for k in FLASH_KERNELS:
        if launches[k["name"]] != want * d["iters"] \
                or typed[k["name"]] != launches[k["name"]]:
            fail(f"{label}: {k['name']} launched {launches[k['name']]} "
                 f"times ({typed[k['name']]} in {dtype}), want {want} x "
                 f"{d['iters']} in {dtype}")
    if any(launches[k["name"]] for k in KERNELS):
        fail(f"{label} launched a paged-attention kernel")
    return dict(wall=wall, iters=d["iters"], peak=peak, p_wall=p_wall,
                busy=busy, top=top, losses=losses,
                per_step={k: n // d["iters"] for k, n in launches.items()})


def phase_dygraph_run():
    """(b): GPT-2 small eager in O1 AMP and in fp32, fed by a DataLoader;
    BERT-base eager O1 AMP with no kernel of the port."""
    from paddle_tpu_torch.models import (BertForPretraining, GPTConfig,
                                         GPTForPretraining, bert_base)

    d = DYGRAPH
    cfg = GPTConfig(dropout=TRAIN["dropout"], **TRAIN_MODEL)
    n = d["warmup"] + d["iters"] + d["profiled"]
    out = {}
    for label, amp_on, dtype in (("amp", True, "bfloat16"),
                                 ("fp32", False, "float32")):
        model = GPTForPretraining(cfg, seed=0, device="cuda")
        batches = iter(token_loader(n, TRAIN["batch"], TRAIN["seq"],
                                    cfg.vocab_size, "cuda"))
        out[label] = dygraph_timed(
            f"GPT-2 small eager {'O1 AMP' if amp_on else 'fp32'}", model,
            d["lr"], amp_on, batches, cfg.num_layers, dtype,
            torch.Generator(device="cuda").manual_seed(0))
        out[label]["tokens"] = TRAIN["batch"] * TRAIN["seq"]
        del model, batches
        torch.cuda.empty_cache()
    bcfg = bert_base(dropout=ENCODER["dropout"])
    model = BertForPretraining(bcfg, seed=0, device="cuda")
    ids, lbl = (t.cuda() for t in train_batch(ENCODER["batch"],
                                               ENCODER["seq"],
                                               bcfg.vocab_size))
    out["bert"] = dygraph_timed(
        "BERT-base eager O1 AMP", model, ENCODER["lr"], True,
        iter(lambda: (ids, lbl), None), 0, "bfloat16",
        torch.Generator(device="cuda").manual_seed(0))
    out["bert"]["samples"] = ENCODER["batch"]
    del model
    torch.cuda.empty_cache()
    return out


def dygraph_numbers(card, run):
    """(b)'s numbers: ms per step, tokens/s or samples/s, peak memory,
    the device idle share over the profiled step and its top kernels,
    each flash kernel's launches per step."""
    for label, what in (("amp", "GPT-2 small eager O1 AMP"),
                        ("fp32", "GPT-2 small eager fp32"),
                        ("bert", "BERT-base eager O1 AMP")):
        r = run[label]
        ms = r["wall"] / r["iters"] * 1e3
        rate = (f"{r['tokens'] / ms * 1e3:.1f} tokens/s" if "tokens" in r
                else f"{r['samples'] / ms * 1e3:.1f} samples/s")
        flash = {k["name"]: r["per_step"][k["name"]] for k in FLASH_KERNELS}
        log(f"  [{card}] {what}: {ms:.2f} ms per step over {r['iters']} "
            f"steps, {rate}; peak memory {r['peak'] / 2**30:.2f} GiB; "
            f"flash launches per step {flash}")
        if r["busy"] > 0:
            log(f"  [{card}] {what} under torch.profiler ("
                f"{DYGRAPH['profiled']} step): wall {r['p_wall']:.3f} s, "
                f"kernels busy {r['busy']:.3f} s, idle share "
                f"{1 - r['busy'] / r['p_wall']:.1%}")
            for key, (us, count) in r["top"][:8]:
                log(f"    {us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
        else:
            log(f"  [{card}] {what}: torch.profiler recorded no device "
                f"time: device idle share not measured")


# ---- phase 19: recurrent nets and beam-search decoding ---------------------

# the PaddlePaddle book's chapter 06 (understand_sentiment, its
# stacked_lstm_net: IMDB's dictionary of 5147 words, embedding 128, hidden
# 512, 3 stacked LSTMs, 2 classes, batch 128, Adam 2e-3; the reviews
# padded to 256 with lengths from 64) and chapter 08 (machine_translation:
# dictionaries of 30,000, word 512, hidden 512, a bidirectional GRU
# encoder, beam 4, batch 64, sentences of 50); data synthetic from a seed.
# The held check (a) runs both at full width with batch and length cut
SENTIMENT = dict(vocab=5147, emb=128, hidden=512, layers=3, classes=2,
                 batch=128, seq=256, min_len=64, lr=2e-3, held_batch=16,
                 held_seq=32, held_min=8)
TRANSLATION = dict(vocab=30000, word=512, hidden=512, beam=4, batch=64,
                   seq=50, lr=1e-3, decode_batch=16, decode_steps=50,
                   held_batch=8, held_seq=12, held_min=3, held_steps=12)
BOOK = dict(warmup=1, iters=5, profiled=1, held_steps=2)
BOS, EOS = 0, 1          # the target dictionary's reserved ids
BOOK_LOSS_TOL = 1e-5     # card vs CPU losses, relative (fp32, TF32 off)
BOOK_PARAM_TOL = 1e-4    # each gradient and parameter, of its largest
BOOK_GRAD_FLOOR = 1e-6   # the CPU gradient under which an entry may pass it
BOOK_NEAR_TIE = 1e-4     # the CPU's gap under which a beam may differ


def book_models(P, nn, F, base, **gen):
    """The book's recurrent models and chapter 06's convolution net over a
    package: `P` its top level, `nn` its layers, `F` its functional
    namespace, `base` its layer class and `gen` the keyword arguments its
    layers draw their weights with (``generator=`` for the port, none for
    the JAX package, whose layers draw from its global key).  The same
    code builds and runs either."""

    class SentimentLSTM(base):
        """Chapter 06's stacked_lstm_net: embedding, stacked LSTMs over
        each review's length, the last layer's final h to the classes."""

        def __init__(self, vocab, emb, hidden, layers, classes):
            super().__init__()
            self.embedding = nn.Embedding(vocab, emb, **gen)
            self.lstm = nn.LSTM(emb, hidden, num_layers=layers, **gen)
            self.fc = nn.Linear(hidden, classes, **gen)

        def forward(self, ids, lens):
            _, (h, _) = self.lstm(self.embedding(ids), sequence_length=lens)
            return self.fc(h[-1])

        def loss(self, ids, lens, label):
            return P.mean(F.softmax_with_cross_entropy(self(ids, lens),
                                                       label))

    class Seq2Seq(base):
        """Chapter 08's encoder-decoder: a bidirectional GRU over the
        source, a linear of its states to the decoder's width (the memory
        and, over both directions' final states, the first state), and a
        GRU cell fed the target word and a dot-product context."""

        def __init__(self, vocab, word, hidden):
            super().__init__()
            self.src_emb = nn.Embedding(vocab, word, **gen)
            self.trg_emb = nn.Embedding(vocab, word, **gen)
            self.encoder = nn.GRU(word, hidden, direction="bidirect", **gen)
            self.enc_proj = nn.Linear(2 * hidden, hidden, **gen)
            self.decoder = nn.GRUCell(word + hidden, hidden, **gen)
            self.out = nn.Linear(hidden, vocab, **gen)

        def encode(self, src, src_len):
            enc, h = self.encoder(self.src_emb(src), sequence_length=src_len)
            return self.enc_proj(enc), self.enc_proj(P.concat(
                [h[0], h[1]], axis=-1))

        def step(self, ids, h, memory):
            scores = P.matmul(memory, h.unsqueeze(-1)).squeeze(-1)
            ctx = P.matmul(F.softmax(scores, axis=-1).unsqueeze(1),
                           memory).squeeze(1)
            h, _ = self.decoder(P.concat([self.trg_emb(ids), ctx], axis=-1),
                                h)
            return self.out(h), h

        def loss(self, src, src_len, trg):
            memory, h = self.encode(src, src_len)
            prev = P.full_like(trg[:, 0], BOS)
            total = 0
            for t in range(trg.shape[1]):
                logits, h = self.step(prev, h, memory)
                total = total + P.mean(F.softmax_with_cross_entropy(
                    logits, trg[:, t:t + 1]))
                prev = trg[:, t]                     # teacher forcing
            return total / trg.shape[1]

        def beam_decode(self, src, src_len, beam, max_steps, decoder=None):
            """`dynamic_decode` over a `BeamSearchDecoder` (or the
            subclass `decoder`) of `beam`: (ids [B, T, beam], final
            scores, lengths)."""
            memory, h0 = self.encode(src, src_len)
            tiled = nn.BeamSearchDecoder.tile_beam_merge_with_batch(memory,
                                                                     beam)
            model = self

            class Cell:
                def __call__(self, ids, states):
                    logits, h = model.step(ids, states[0], tiled)
                    return logits, (h,)

            return nn.dynamic_decode((decoder or nn.BeamSearchDecoder)(
                Cell(), BOS, EOS, beam), inits=(h0,), max_step_num=max_steps,
                return_length=True)

    class SentimentConv(base):
        """Chapter 06's convolution_net: an embedding (sparse gradients
        by default, the chapter's ``is_sparse=True``) zeroed past each
        review's length (the chapter feeds LoD sequences, which have no
        padding), two ``sequence_conv_pool`` branches of windows 3 and 4,
        each `filters` wide with a bias and tanh and pooled by "sqrt",
        and an fc over both branches to the classes, softmax and cross
        entropy.  A linear layer holds each window's filter [context ·
        emb, filters] and bias, the layout ``sequence_conv`` reads."""

        def __init__(self, vocab, emb, filters, classes, sparse=True):
            super().__init__()
            self.embedding = nn.Embedding(vocab, emb, sparse=sparse, **gen)
            self.conv3 = nn.Linear(3 * emb, filters, **gen)
            self.conv4 = nn.Linear(4 * emb, filters, **gen)
            self.fc = nn.Linear(2 * filters, classes, **gen)

        @staticmethod
        def conv_pool(x, lens, conv, context):
            h = P.sequence_conv(x, conv.weight, lens,
                                context_length=context) + conv.bias
            return P.sequence_pool(P.tanh(h), lens, "sqrt")

        def forward(self, ids, lens):
            mask = F.sequence_mask(lens, ids.shape[1], dtype="float32")
            x = self.embedding(ids) * mask.unsqueeze(-1)
            return self.fc(P.concat([self.conv_pool(x, lens, self.conv3, 3),
                                     self.conv_pool(x, lens, self.conv4, 4)],
                                    axis=-1))

        def loss(self, ids, lens, label):
            return P.mean(F.softmax_with_cross_entropy(self(ids, lens),
                                                       label))

    return SentimentLSTM, Seq2Seq, SentimentConv


def sentiment_batch(rng, batch, seq, vocab, min_len):
    """Reviews of lengths in [min_len, seq] (the first the longest), ids
    in [1, vocab) padded with 0 past each length, labels [batch, 1]."""
    lens = rng.integers(min_len, seq + 1, batch)
    lens[0] = seq
    ids = rng.integers(1, vocab, (batch, seq))
    ids[np.arange(seq)[None, :] >= lens[:, None]] = 0
    return ids, lens, rng.integers(0, 2, (batch, 1))


def translation_batch(rng, batch, seq, vocab):
    """Source and target sentences of `seq` ids in [2, vocab), every
    source of full length."""
    return (rng.integers(2, vocab, (batch, seq)),
            np.full(batch, seq, np.int64),
            rng.integers(2, vocab, (batch, seq)))


def port_book_models(seed=0):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    import paddle_tpu_torch as P

    return book_models(P, nn, F, torch.nn.Module,
                       generator=torch.Generator().manual_seed(seed))


def book_build(which, seed=0):
    """Phase 19's model `which` ("sentiment" or "translation") at the
    chapter's widths, on the CPU from a generator of `seed`."""
    sent, trans, _ = port_book_models(seed)
    if which == "sentiment":
        c = SENTIMENT
        return sent(c["vocab"], c["emb"], c["hidden"], c["layers"],
                    c["classes"])
    c = TRANSLATION
    return trans(c["vocab"], c["word"], c["hidden"])


def book_adam(model, lr):
    from paddle_tpu_torch import optimizer

    return optimizer.Adam(learning_rate=lr, parameters=model.parameters())


def book_steps(model, batch, lr, n, grads=None, make_opt=None, rows=None):
    """`n` eager steps of ``model.loss(*batch)`` under ``make_opt(model,
    lr)`` (Adam by default): the losses; each step's gradients (a sparse
    one made dense) appended to `grads` where given, and the embedding's
    sparse gradient, coalesced (ids, rows) on the CPU, to `rows`."""
    from paddle_tpu_torch.core.indexed_slices import coalesce

    opt = (make_opt or book_adam)(model, lr)
    losses = []
    for _ in range(n):
        loss = model.loss(*batch)
        loss.backward()
        if rows is not None:
            g = model.embedding.weight.grad
            if not g.is_sparse:
                fail(f"the embedding's gradient is {g.layout}, not sparse")
            rows.append(tuple(t.cpu() for t in coalesce(g)))
        if grads is not None:
            grads.append({k: (p.grad.to_dense() if p.grad.is_sparse
                              else p.grad).detach().cpu().clone()
                          for k, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def recording_decoder():
    """A maker of `BeamSearchDecoder`s that keep each step's inputs,
    logits and choices (for the near-tie rule of the held check), and the
    list of those it made."""
    from paddle_tpu_torch import nn

    class Recording(nn.BeamSearchDecoder):
        def __init__(self, cell, *args, **kwargs):
            self.log = []

            def record(ids, states):
                logits, new = cell(ids, states)
                self.log[-1]["logits"] = logits.detach()
                return logits, new

            super().__init__(record, *args, **kwargs)

        def step(self, ids, scores, states):
            self.log.append({"ids": ids, "scores": scores})
            out = super().step(ids, scores, states)
            self.log[-1].update(sel=out[0], parent=out[2])
            return out

    made = []

    def make(*args, **kwargs):
        made.append(Recording(*args, **kwargs))
        return made[-1]

    return make, made


def beam_gaps(log, beam):
    """Per step and batch row, on the CPU's log: the gap between the
    beam-th and the next best candidate score."""
    from paddle_tpu_torch.ops.sequence_ops import beam_candidates

    gaps = []
    for rec in log:
        logp = torch.log_softmax(rec["logits"].float(), dim=-1)
        cand = torch.arange(logp.shape[-1]).expand(logp.shape[0], -1)
        acc, _ = beam_candidates(rec["ids"], rec["scores"], cand,
                                 rec["scores"] + logp, EOS)
        top = acc.reshape(-1, beam * logp.shape[-1]).topk(beam + 1).values
        gaps.append((top[:, beam - 1] - top[:, beam]).tolist())
    return gaps


def hold_book_params(label, card, cpu, grads):
    """Phase 11's rule over the parameters `card` and `cpu` ({name:
    tensor}): each step-1 gradient within BOOK_PARAM_TOL of its tensor's
    largest magnitude, then each parameter after the held steps within
    the same.  An entry past that is allowed only where the CPU's least
    gradient over the steps is under BOOK_GRAD_FLOOR: near Adam's
    epsilon (1e-8) a step's size follows the gradient's value, and the
    devices' sums differ there in the last bits.  `grads` holds each
    device's gradients a step."""
    grad_err, grad_name = max((share(g, grads["cpu"][0][n]), n)
                              for n, g in grads["cuda"][0].items())
    worst, worst_name, past, past_grad, bad = 0.0, None, 0, 0.0, []
    for n, p in card.items():
        got, want = p.detach().cpu().double(), cpu[n].detach().double()
        if share(got, want) > worst:
            worst, worst_name = share(got, want), n
        mask = (got - want).abs() > BOOK_PARAM_TOL * want.abs().max()
        if not mask.any():
            continue
        least = torch.stack([g[n].abs() for g in grads["cpu"]]).amin(0)[mask]
        past += int(mask.sum())
        past_grad = max(past_grad, float(least.max()))
        if (least >= BOOK_GRAD_FLOOR).any():
            bad.append((n, int((least >= BOOK_GRAD_FLOOR).sum())))
    steps = len(grads["cpu"])
    log(f"  {label}: step-1 gradients {grad_err:.2e} of their largest "
        f"magnitude (worst {grad_name}); parameters after {steps} steps "
        f"{worst:.2e} (worst {worst_name}; {past} entries past "
        f"{BOOK_PARAM_TOL}, their least CPU gradient over the steps at "
        f"most {past_grad:.2e} against {BOOK_GRAD_FLOOR})")
    if grad_err > BOOK_PARAM_TOL:
        fail(f"{label}: step-1 gradient {grad_name} {grad_err} of its "
             f"largest magnitude, past {BOOK_PARAM_TOL}")
    if bad:
        fail(f"{label}: parameter entries past {BOOK_PARAM_TOL} where the "
             f"CPU's gradient is at least {BOOK_GRAD_FLOOR}: {bad}")
    return worst, past


def phase_book_held():
    """(a): both models at full width, batch and length cut, card against
    the CPU from one set of weights: 2 eager Adam steps (losses within
    BOOK_LOSS_TOL relative, step-1 gradients and parameters by
    `hold_book_params`), then the translation model's beam search card
    against CPU.  Most translation sources are padded."""
    from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy

    rng = np.random.default_rng(19)
    out = {}
    s, t = SENTIMENT, TRANSLATION
    sent = sentiment_batch(rng, s["held_batch"], s["held_seq"], s["vocab"],
                           s["held_min"])
    trans = translation_batch(rng, t["held_batch"], t["held_seq"],
                              t["vocab"])
    # padded sources, so the encoder's masked reverse walk runs too
    trans[1][1:] = rng.integers(t["held_min"], t["held_seq"],
                                t["held_batch"] - 1)
    batches = {"sentiment": (sent, s["lr"]), "translation": (trans, t["lr"])}
    models = {}
    for which, (batch, lr) in batches.items():
        t0 = time.perf_counter()
        cpu = book_build(which)
        card = layer_from_numpy(book_build(which, seed=1),
                                layer_to_numpy(cpu), "cuda")
        losses, grads = {}, {"cuda": [], "cpu": []}
        for dev, model in (("cuda", card), ("cpu", cpu)):
            args = [torch.from_numpy(a).to(dev) for a in batch]
            losses[dev] = book_steps(model, args, lr, BOOK["held_steps"],
                                     grads[dev])
        err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        log(f"  {which} at full width, B={len(batch[0])}, "
            f"T={batch[0].shape[1]}: losses card {losses['cuda']} CPU "
            f"{losses['cpu']} (worst {err:.2e} relative) "
            f"({time.perf_counter() - t0:.1f} s)")
        if not all(math.isfinite(x) for x in losses["cuda"]) \
                or err > BOOK_LOSS_TOL:
            fail(f"{which}: card losses {losses['cuda']} vs CPU "
                 f"{losses['cpu']}, past {BOOK_LOSS_TOL} relative")
        out[which] = hold_book_params(which, dict(card.named_parameters()),
                                      dict(cpu.named_parameters()), grads)
        del grads
        models[which] = (card, cpu, batch)
    card, cpu, (src, src_len, _) = models["translation"]
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        make, made = recording_decoder()
        with torch.no_grad():
            ids, scores, lens = model.beam_decode(
                torch.from_numpy(src).to(dev),
                torch.from_numpy(src_len).to(dev), t["beam"],
                t["held_steps"], decoder=make)
        runs[dev] = (ids.cpu(), scores.cpu(), made[0].log)
    (gi, gs, glog), (ci, cs, clog) = runs["cuda"], runs["cpu"]
    gaps = beam_gaps(clog, t["beam"])
    differs = []
    for row in range(ci.shape[0]):
        if torch.equal(gi[row], ci[row]):
            continue
        rows = slice(row * t["beam"], (row + 1) * t["beam"])
        step = next(k for k, (g, c) in enumerate(zip(glog, clog))
                    if not (torch.equal(g["sel"][rows].cpu(), c["sel"][rows])
                            and torch.equal(g["parent"][rows].cpu(),
                                            c["parent"][rows])))
        differs.append((row, step, gaps[step][row]))
        log(f"  beam search: sentence {row} diverges at step {step + 1}, "
            f"where the CPU's gap between beam {t['beam']} and the next "
            f"candidate is {gaps[step][row]:.2e}")
    score_err = float((gs - cs).abs().max())
    log(f"  beam search (beam {t['beam']}, {ci.shape[1]} steps, "
        f"{ci.shape[0]} sentences): ids card vs CPU "
        f"{'identical' if not differs else f'{len(differs)} differ'}; "
        f"final scores max|diff| {score_err:.2e}; the CPU's least gap "
        f"{min(min(g) for g in gaps):.2e}")
    bad = [d for d in differs if d[2] >= BOOK_NEAR_TIE]
    if bad:
        fail(f"beam search: sentences diverge card vs CPU away from a near "
             f"tie: {bad}")
    if not differs and score_err > BOOK_LOSS_TOL * float(cs.abs().max()):
        fail(f"beam search: final scores differ by {score_err}")
    return out


def eager_step(model, batches, lr, make_opt=None):
    """One eager step of `model` on the next of `batches` under
    ``make_opt(model, lr)`` (Adam by default), returning the loss on the
    device (phases 19, 20 and 22)."""
    opt = (make_opt or book_adam)(model, lr)

    def step():
        loss = model.loss(*next(batches))
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()
    return step


def timed_steps(label, step, n=BOOK):
    """n["warmup"] warm-up, n["iters"] timed (every count set to 0 just
    before, read just after) and n["profiled"] profiled calls of `step`
    (returning the loss on the device).  The peak memory is what the
    steps held above the memory allocated before them (earlier phases'
    models stay allocated in a whole run)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses = [step() for _ in range(n["warmup"])]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(n["iters"])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    p_wall, busy, top, kernels = profile_steps(step, n["profiled"])
    losses = [float(x.reshape(-1)[0]) for x in losses]
    log(f"  {label}: losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: loss not finite: {losses}")
    if any(launches.values()):
        fail(f"{label} launched a kernel of the port: {launches}")
    return dict(wall=wall, iters=n["iters"], peak=peak, p_wall=p_wall,
                busy=busy, top=top, kernels=kernels / n["profiled"])


def phase_book_run():
    """(b): both models alone on the card at the chapters' sizes, and the
    translation model's beam search over BOOK decode sentences."""
    rng = np.random.default_rng(20)
    s, t = SENTIMENT, TRANSLATION
    n = BOOK["warmup"] + BOOK["iters"] + BOOK["profiled"]
    out = {}
    model = book_build("sentiment").to("cuda")
    batches = iter([[torch.from_numpy(a).cuda() for a in sentiment_batch(
        rng, s["batch"], s["seq"], s["vocab"], s["min_len"])]
        for _ in range(n)])
    out["sentiment"] = timed_steps(
        f"sentiment LSTM (B {s['batch']}, T {s['seq']}, 3 x {s['hidden']})",
        eager_step(model, batches, s["lr"]))
    out["sentiment"]["samples"] = s["batch"]
    del model, batches
    model = book_build("translation").to("cuda")
    batches = iter([[torch.from_numpy(a).cuda() for a in translation_batch(
        rng, t["batch"], t["seq"], t["vocab"])] for _ in range(n)])
    out["translation"] = timed_steps(
        f"translation GRU (B {t['batch']}, T {t['seq']}, V {t['vocab']})",
        eager_step(model, batches, t["lr"]))
    out["translation"]["tokens"] = t["batch"] * t["seq"]
    src, src_len, _ = (torch.from_numpy(a).cuda() for a in translation_batch(
        rng, t["decode_batch"], t["seq"], t["vocab"]))

    def decode():
        with torch.no_grad():
            return model.beam_decode(src, src_len, t["beam"],
                                     t["decode_steps"])

    decode()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ids, scores, lens = decode()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(read_launches().values()):
        fail("the beam decode launched a kernel of the port")
    if not torch.isfinite(scores).all() or ids.shape[0] != t["decode_batch"]:
        fail(f"beam decode: ids {tuple(ids.shape)}, scores finite "
             f"{bool(torch.isfinite(scores).all())}")
    p_wall, busy, top, kernels = profile_steps(decode, 1)
    out["decode"] = dict(wall=wall, steps=ids.shape[1], p_wall=p_wall,
                         busy=busy, top=top, kernels=kernels)
    del model
    torch.cuda.empty_cache()
    return out


def book_numbers(card, run):
    """(b)'s numbers: ms a step and samples/s or target tokens/s, the
    decode's ms a step and sentences/s, each with its idle share, kernels
    a step and peak memory."""
    t = TRANSLATION
    for key, what in (("sentiment", "sentiment LSTM"),
                      ("translation", "translation GRU")):
        r = run[key]
        ms = r["wall"] / r["iters"] * 1e3
        rate = (f"{r['samples'] / ms * 1e3:.1f} samples/s" if "samples" in r
                else f"{r['tokens'] / ms * 1e3:.1f} target tokens/s")
        log(f"  [{card}] {what}: {ms:.2f} ms per step over {r['iters']} "
            f"steps, {rate}; peak memory {r['peak'] / 2**30:.2f} GiB above "
            f"the steps' start; "
            f"{r['kernels']:.0f} kernels a step")
        book_idle(card, what, r)
    d = run["decode"]
    log(f"  [{card}] beam decode (beam {t['beam']}, "
        f"{t['decode_batch']} sentences, {d['steps']} steps): "
        f"{d['wall'] / d['steps'] * 1e3:.2f} ms a step, "
        f"{t['decode_batch'] / d['wall']:.1f} sentences/s; "
        f"{d['kernels'] / d['steps']:.0f} kernels a step")
    book_idle(card, "beam decode", d)


def book_idle(card, what, r):
    if r["busy"] > 0:
        log(f"  [{card}] {what} under torch.profiler: wall "
            f"{r['p_wall']:.3f} s, kernels busy {r['busy']:.3f} s, idle "
            f"share {1 - r['busy'] / r['p_wall']:.1%}")
        for key, (us, count) in r["top"][:5]:
            log(f"    {us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
    else:
        log(f"  [{card}] {what}: torch.profiler recorded no device time: "
            f"device idle share not measured")


# ---------------------- phase 20: the rest of the book ----------------------
# The PaddlePaddle v2.1 book's other chapters at their widths (PERF.md §4
# names each constant's source): fit_a_line (13 features, batch 20, SGD
# 1e-3); recognize_digits' conv-pool net (20 and 50 filters of 5x5, each
# conv then a 2x2 max pool, batch 64); word2vec, here skip-gram with NCE
# (the imikolov dictionary of 2,074, embedding 32, batch 100, 10
# negatives); label_semantic_roles (the conll05 dictionary of 44,068 and
# its 67 labels, word embedding 32, a hidden fc of 512, the CRF, batch
# 10, sentences of up to 40); the recommender (MovieLens-1M's 6,041 user
# and 3,953 movie ids, embeddings 32, each tower's fc 200, cos_sim
# scaled by 5, batch 256); the StaticRNN encoder-decoder (dictionary
# 30,000, width 512, B 64, T 50, as phase 19's translation model); and
# image_classification's vgg16_bn_drop on 3x32x32, 10 classes, batch
# 128, through the static executor with dropout on.  Dygraph chapters
# train with eager Adam, the static ones with their programs' optimizer;
# data synthetic from a seed.  The held check (a) runs each at its
# width with batch and length cut and dropout 0.
FIT_A_LINE = dict(features=13, batch=20, lr=1e-3, held_batch=20)
DIGITS = dict(filters=(20, 50), kernel=5, image=28, classes=10, batch=64,
              lr=1e-3, held_batch=8)
WORD2VEC = dict(vocab=2074, dim=32, neg=10, batch=100, lr=1e-3,
                held_batch=16)
SRL = dict(vocab=44068, dim=32, hidden=512, labels=67, batch=10, seq=40,
           min_len=5, lr=1e-3, held_batch=6, held_seq=12, held_min_len=2)
RECOMMENDER = dict(users=6041, items=3953, dim=32, fc=200, batch=256,
                   lr=1e-3, held_batch=32)
STATIC_RNN = dict(vocab=30000, dim=512, batch=64, seq=50, lr=1e-3,
                  held_batch=8, held_seq=12)
IMAGE = dict(image=32, classes=10, batch=128, lr=1e-3, held_batch=16)
CHAPTERS = ("fit_a_line", "recognize_digits", "word2vec", "semantic_roles",
            "recommender", "static_rnn", "image_classification")
STATIC_CHAPTERS = ("fit_a_line", "static_rnn", "image_classification")
CONV_CHAPTERS = ("recognize_digits", "image_classification")
CHAPTER_TEST_TOL = 1e-4  # for_test logits card vs CPU, of their largest
# the conv chapters held with cuDNN on too, and their bound of each step-1
# gradient's largest: cuDNN's Winograd weight gradient of recognize_digits'
# first conv reads 2.82e-4 (NVIDIA H100 80GB HBM3, 700 W); a layout or
# stride fault is far past 2e-3
CUDNN_HELD = ("recognize_digits",)
CUDNN_GRAD_TOL = 2e-3


def book_chapters(P, nn, F, base, param, place=None, **gen):
    """The book's dygraph chapters over a package (as `book_models`):
    `param(layer, shape, is_bias)` makes a free parameter of `layer`;
    `place` goes to the convolutions (the port's device).
    Each model's ``loss(*batch)`` is its training loss."""

    class Digits(base):
        """recognize_digits: the chapter's conv-pool net (``pool``), or
        the JAX package's test net of two strided convs."""

        def __init__(self, filters, kernel, image, classes, pool=True):
            super().__init__()
            f1, f2 = filters
            conv = dict(gen, **(place or {}))
            if pool:
                side = ((image - kernel + 1) // 2 - kernel + 1) // 2
                self.net = nn.Sequential(
                    nn.Conv2D(1, f1, kernel, **conv), nn.ReLU(),
                    nn.MaxPool2D(2, 2), nn.Conv2D(f1, f2, kernel, **conv),
                    nn.ReLU(), nn.MaxPool2D(2, 2), nn.Flatten(),
                    nn.Linear(f2 * side * side, classes, **gen))
            else:
                self.net = nn.Sequential(
                    nn.Conv2D(1, f1, kernel, stride=2, **conv), nn.ReLU(),
                    nn.Conv2D(f1, f2, 3, stride=2, **conv), nn.ReLU(),
                    nn.Flatten(), nn.Linear(f2 * 5 * 5, classes, **gen))

        def loss(self, img, lbl):
            return P.mean(F.softmax_with_cross_entropy(self.net(img), lbl))

    class Word2Vec(base):
        """Skip-gram with NCE: the centre word's embedding against its
        context word and `neg` shared negatives, drawn afresh each step
        (seed = the step's number)."""

        def __init__(self, vocab, dim, neg):
            super().__init__()
            self.vocab, self.neg, self.steps = vocab, neg, 0
            self.emb = nn.Embedding(vocab, dim, **gen)
            self.nce_w = param(self, [vocab, dim])
            self.nce_b = param(self, [vocab])

        def loss(self, center, target):
            self.steps += 1
            return P.mean(P.nce(self.emb(center), self.nce_w, target,
                                bias=self.nce_b, num_total_classes=self.vocab,
                                num_neg_samples=self.neg, seed=self.steps))

    class SemanticRoles(base):
        """Emissions (embedding, an optional tanh fc, a projection to the
        labels) under a linear-chain CRF; decoding by Viterbi."""

        def __init__(self, vocab, dim, labels, hidden=None):
            super().__init__()
            self.emb = nn.Embedding(vocab, dim, **gen)
            self.hidden = (nn.Linear(dim, hidden, **gen) if hidden
                           else None)
            self.proj = nn.Linear(hidden or dim, labels, **gen)
            self.trans = param(self, [labels + 2, labels])

        def emission(self, words):
            h = self.emb(words)
            if self.hidden is not None:
                h = P.tanh(self.hidden(h))
            return self.proj(h)

        def loss(self, words, labels, lens):
            return -P.mean(P.linear_chain_crf(self.emission(words),
                                              self.trans, labels, lens))

        def decode(self, words, lens):
            with P.no_grad():
                e = self.emission(words)
            return P.crf_decoding(e, self.trans, lens)

    class Recommender(base):
        """Two towers (an embedding, an optional tanh fc), cos_sim scaled
        to a rating, squared error."""

        def __init__(self, users, items, dim, fc=None):
            super().__init__()
            self.u_emb = nn.Embedding(users, dim, **gen)
            self.i_emb = nn.Embedding(items, dim, **gen)
            self.u_fc = nn.Linear(dim, fc, **gen) if fc else None
            self.i_fc = nn.Linear(dim, fc, **gen) if fc else None

        def loss(self, users, items, ratings):
            u, i = self.u_emb(users), self.i_emb(items)
            if self.u_fc is not None:
                u, i = P.tanh(self.u_fc(u)), P.tanh(self.i_fc(i))
            pred = P.scale(P.cos_sim(u, i), 5.0)
            return P.mean(P.square(pred - ratings))

    return {"recognize_digits": Digits, "word2vec": Word2Vec,
            "semantic_roles": SemanticRoles, "recommender": Recommender}


def vgg16_bn_drop(static, img, classes, drop):
    """image_classification's vgg16_bn_drop: five conv groups (conv, batch
    norm + relu, dropout where the chapter has it, then a 2x2 max pool),
    dropout, fc 512, batch norm + relu, dropout, fc 512, softmax; the
    dropouts scaled by `drop` (0: identities).  A conv or fc that feeds a
    batch norm has no bias here (the chapter's has one): the batch norm
    subtracts it again, so its gradient is 0 but for rounding noise,
    which Adam's first step turns into a full step of either sign."""
    x = img
    for filters, drops in ((64, (0.3, 0)), (128, (0.4, 0)),
                           (256, (0.4, 0.4, 0)), (512, (0.4, 0.4, 0)),
                           (512, (0.4, 0.4, 0))):
        for p in drops:
            x = static.nn.conv2d(x, filters, 3, padding=1, bias_attr=False)
            x = static.nn.batch_norm(x, act="relu")
            if p:
                x = static.nn.dropout(x, dropout_prob=p * drop)
        x = static.nn.pool2d(x, pool_size=2, pool_type="max", pool_stride=2)
    x = static.nn.dropout(static.nn.flatten(x), dropout_prob=0.5 * drop)
    x = static.nn.batch_norm(static.nn.fc(x, 512, bias_attr=False),
                             act="relu")
    x = static.nn.dropout(x, dropout_prob=0.5 * drop)
    return static.nn.fc(static.nn.fc(x, 512), classes, activation="softmax")


def book_program(static, minimize, which, c, drop=1.0, small=False):
    """A static chapter's program over a package: ``static`` its static
    module, ``minimize(loss)`` its optimizer's.  `c` the sizes; `small`
    builds the JAX package's test nets instead of the chapter's.
    Returns (main, startup, loss, the for_test clone or None, its
    output)."""
    main, startup = static.Program(), static.Program()
    test, out = None, None
    with static.program_guard(main, startup):
        if which == "fit_a_line":
            x = static.data("x", [c["batch"], c["features"]])
            y = static.data("y", [c["batch"], 1])
            pred = static.nn.fc(x, 1)
            loss = static.nn.mean((pred - y) * (pred - y))
        elif which == "static_rnn":
            T, B, D = c["seq"], c["batch"], c["dim"]
            x = static.data("x", [T, B], dtype="int64")
            y = static.data("y", [T, B], dtype="int64")
            h0 = static.data("h0", [B, D])
            rnn = static.StaticRNN()
            with rnn.step():
                xt = rnn.step_input(x)
                prev = rnn.memory(init=h0)
                e = static.nn.embedding(xt, [c["vocab"], D])
                nxt = static.nn.fc(e + prev, D, activation="tanh")
                rnn.update_memory(prev, nxt)
                rnn.step_output(nxt)
            logits = static.nn.fc(static.nn.reshape(rnn(), [T * B, D]),
                                  c["vocab"])
            loss = static.nn.mean(static.nn.softmax_with_cross_entropy(
                logits, static.nn.reshape(y, [T * B, 1])))
        else:
            B, H = c["batch"], c["image"]
            img = static.data("img", [B, 3, H, H])
            lbl = static.data("lbl", [B, 1], dtype="int64")
            if small:
                x = static.nn.conv2d(img, 16, 3, padding=1, act="relu")
                x = static.nn.batch_norm(x, act="relu")
                x = static.nn.pool2d(x, pool_size=2, pool_type="max",
                                     pool_stride=2)
                x = static.nn.conv2d(x, 32, 3, padding=1, act="relu")
                x = static.nn.pool2d(x, global_pooling=True, pool_type="avg")
                x = static.nn.dropout(static.nn.flatten(x, axis=1),
                                      dropout_prob=0.1 * drop)
                out = static.nn.fc(x, c["classes"])
                loss = static.nn.mean(static.nn.softmax_with_cross_entropy(
                    out, lbl))
            else:
                out = vgg16_bn_drop(static, img, c["classes"], drop)
                loss = static.nn.mean(static.nn.cross_entropy(out, lbl))
            test = main.clone(for_test=True)
        minimize(loss)
    return main, startup, loss, test, out


def chapter_batch(rng, which, c):
    """One synthetic batch of chapter `which` at sizes `c` (numpy; a
    static chapter's as its feed dict)."""
    B = c["batch"]
    if which == "fit_a_line":
        x = rng.random((B, c["features"]), dtype=np.float32)
        w = np.linspace(-1, 1, c["features"], dtype=np.float32)[:, None]
        return {"x": x, "y": x @ w + 0.1}
    if which == "recognize_digits":
        return (rng.random((B, 1, c["image"], c["image"]), dtype=np.float32),
                rng.integers(0, c["classes"], (B, 1)))
    if which == "word2vec":
        center = rng.integers(0, c["vocab"], B)
        return center, (center + 1) % c["vocab"]
    if which == "semantic_roles":
        T = c["seq"]
        lens = rng.integers(c["min_len"], T + 1, B)
        lens[0] = T
        words = rng.integers(0, c["vocab"], (B, T))
        return words, words % c["labels"], lens
    if which == "recommender":
        u = rng.integers(0, c["users"], B)
        i = rng.integers(0, c["items"], B)
        return u, i, ((u + i) % 5 + 1).astype(np.float32).reshape(B, 1)
    if which == "static_rnn":
        src = rng.integers(1, c["vocab"], (c["seq"], B))
        return {"x": src, "y": np.roll(src, -1, axis=0),
                "h0": np.zeros((B, c["dim"]), np.float32)}
    return {"img": rng.random((B, 3, c["image"], c["image"]),
                              dtype=np.float32),
            "lbl": rng.integers(0, c["classes"], (B, 1))}


def port_book_chapters(seed=0):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layer import create_parameter
    import paddle_tpu_torch as P

    g = torch.Generator().manual_seed(seed)
    return book_chapters(
        P, nn, F, torch.nn.Module,
        lambda layer, shape, is_bias=False: create_parameter(
            shape, is_bias=is_bias, generator=g), {"device": "cpu"},
        generator=g)


CHAPTER_SIZES = {"recognize_digits": DIGITS, "word2vec": WORD2VEC,
                 "semantic_roles": SRL, "recommender": RECOMMENDER,
                 "fit_a_line": FIT_A_LINE, "static_rnn": STATIC_RNN,
                 "image_classification": IMAGE}


def chapter_model(which, seed=0):
    """A dygraph chapter's model at the chapter's widths, on the CPU."""
    c = CHAPTER_SIZES[which]
    cls = port_book_chapters(seed)[which]
    if which == "recognize_digits":
        return cls(c["filters"], c["kernel"], c["image"], c["classes"])
    if which == "word2vec":
        return cls(c["vocab"], c["dim"], c["neg"])
    if which == "semantic_roles":
        return cls(c["vocab"], c["dim"], c["labels"], c["hidden"])
    return cls(c["users"], c["items"], c["dim"], c["fc"])


def port_program(which, c, drop=1.0, held=False):
    """A static chapter's program in the port, its optimizer the
    chapter's: SGD for fit_a_line, Adam for the others; for image
    classification's held check Momentum(lr, 0.9), the JAX package's
    book test's rule for it.  Adam's first step moves each weight by
    about lr x sign(g), and vgg16_bn_drop has enough weights whose
    gradient is within rounding of 0 that the card and the CPU part by
    3.68e-3 in the second step's loss (an NVIDIA H100 80GB HBM3, cuDNN
    off; PERF.md §6)."""
    from paddle_tpu_torch import optimizer, static

    if which == "fit_a_line":
        opt = optimizer.SGD(learning_rate=c["lr"])
    elif held and which == "image_classification":
        opt = optimizer.Momentum(learning_rate=c["lr"], momentum=0.9)
    else:
        opt = optimizer.Adam(learning_rate=c["lr"])
    return book_program(static, opt.minimize, which, c, drop)


def held_sizes(which):
    """The chapter's sizes with batch (and length) cut for the held
    check."""
    c = dict(CHAPTER_SIZES[which])
    c["batch"] = c["held_batch"]
    for k in ("seq", "min_len"):
        if "held_" + k in c:
            c[k] = c["held_" + k]
    return c


def crf_gaps(emission, transition, lens):
    """Per row and position, on the CPU in float64: the gap between the
    best and the second-best Viterbi score of a path through each tag at
    that position (max-product forward plus backward), where a near tie
    lets a decoded tag differ between devices."""
    e, tr = emission.double(), transition.double()
    start, stop, trans = tr[0], tr[1], tr[2:]
    B, T, N = e.shape
    alive = [(t < lens)[:, None] for t in range(T)]
    fwd = [start[None] + e[:, 0]]
    for t in range(1, T):
        new = (fwd[-1][:, :, None] + trans[None]).amax(1) + e[:, t]
        fwd.append(torch.where(alive[t], new, fwd[-1]))
    bwd = [None] * T
    last = lens - 1
    for t in range(T - 1, -1, -1):
        at_end = (t == last)[:, None]
        if t == T - 1:
            nxt = stop[None].expand(B, N)
        else:
            nxt = (trans[None] + (e[:, t + 1] + bwd[t + 1])[:, None]).amax(2)
        bwd[t] = torch.where(at_end, stop[None].expand(B, N),
                             torch.where(alive[t], nxt, 0.0))
    score = torch.stack([f + b for f, b in zip(fwd, bwd)], 1)  # B, T, N
    top = score.topk(2, dim=2).values
    return (top[..., 0] - top[..., 1]).float()


@contextlib.contextmanager
def precise_convs(which, device):
    """cuDNN off on the card for a conv chapter's held run: for these
    weight gradients it picks Winograd (recognize_digits' first conv:
    3.55e-4 of the largest entry from a float64 run, where the CPU's
    float32 is 3.2e-7, on an NVIDIA H100 80GB HBM3; PERF.md §6), past
    the held bound by itself; PyTorch's own CUDA convolution sums as
    the CPU does."""
    if device != "cuda" or which not in CONV_CHAPTERS:
        yield
        return
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def hold_cudnn(which, got, want):
    """A conv chapter's step-1 gradients on the card with cuDNN's own
    algorithms (as (b) runs) against the CPU's: within CUDNN_GRAD_TOL of
    each tensor's largest for CUDNN_HELD, printed for vgg16_bn_drop,
    chaotic at its held batch (`hold_static_chapter`)."""
    worst, name = max((share(g, want[n]), n) for n, g in got.items())
    held = which in CUDNN_HELD
    log(f"  {which}: with cuDNN's own algorithms (as (b) runs) the step-1 "
        f"gradients are {worst:.2e} of their largest from the CPU's "
        f"(worst {name}; "
        f"{f'held to {CUDNN_GRAD_TOL}' if held else 'printed, not held'})")
    if held and not worst <= CUDNN_GRAD_TOL:
        fail(f"{which}: with cuDNN the step-1 gradient {name} is {worst} of "
             f"its largest from the CPU's, past {CUDNN_GRAD_TOL}")


def hold_chapter_losses(which, losses):
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    log(f"  {which}: losses card {losses['cuda']} CPU {losses['cpu']} "
        f"(worst {err:.2e} relative)")
    if not all(math.isfinite(x) for x in losses["cuda"]) \
            or err > BOOK_LOSS_TOL:
        fail(f"{which}: card losses {losses['cuda']} vs CPU "
             f"{losses['cpu']}, past {BOOK_LOSS_TOL} relative")


def hold_dygraph_chapter(which, rng):
    """(a) for a dygraph chapter: 2 Adam steps card vs CPU from one set
    of weights (`hold_book_params`); word2vec's negatives recorded on
    both devices; the CRF's decoded paths card vs CPU."""
    from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy
    from paddle_tpu_torch.ops import sequence_ops

    c = held_sizes(which)
    batch = chapter_batch(rng, which, c)
    cpu = chapter_model(which)
    start = layer_to_numpy(cpu)
    card = layer_from_numpy(chapter_model(which, seed=1), start, "cuda")
    drawn, draw = {}, sequence_ops.draw_negatives
    losses, grads = {}, {"cuda": [], "cpu": []}
    try:
        for dev, model in (("cuda", card), ("cpu", cpu)):
            drawn[dev] = []

            def record(*args, _log=drawn[dev]):
                _log.append(draw(*args))
                return _log[-1]

            sequence_ops.draw_negatives = record
            args = [torch.from_numpy(a).to(dev) for a in batch]
            with precise_convs(which, dev):
                losses[dev] = book_steps(model, args, c["lr"],
                                         BOOK["held_steps"], grads[dev])
    finally:
        sequence_ops.draw_negatives = draw
    hold_chapter_losses(which, losses)
    hold_book_params(which, dict(card.named_parameters()),
                     dict(cpu.named_parameters()), grads)
    if which in CONV_CHAPTERS:
        fresh = layer_from_numpy(chapter_model(which, seed=1), start, "cuda")
        fresh.loss(*[torch.from_numpy(a).cuda() for a in batch]).backward()
        hold_cudnn(which, {n: p.grad.cpu()
                           for n, p in fresh.named_parameters()},
                   grads["cpu"][0])
    if which == "word2vec":
        same = len(drawn["cuda"]) == len(drawn["cpu"]) > 0 and all(
            torch.equal(a, b) for a, b in zip(drawn["cuda"], drawn["cpu"]))
        log(f"  word2vec: {len(drawn['cpu'])} draws of {c['neg']} negatives, "
            f"card vs CPU {'identical' if same else 'DIFFERENT'}")
        if not same:
            fail("word2vec: the card and the CPU drew different negatives")
    if which == "semantic_roles":
        words, _, lens = (torch.from_numpy(a) for a in batch)
        got = card.decode(words.cuda(), lens.cuda()).cpu()
        want = cpu.decode(words, lens)
        with torch.no_grad():
            gaps = crf_gaps(cpu.emission(words), cpu.trans, lens)
        differ = (got != want).nonzero().tolist()
        for b, t in differ:
            log(f"  crf_decoding: sentence {b} position {t} differs, the "
                f"CPU's best-second gap {float(gaps[b, t]):.2e}")
        log(f"  crf_decoding card vs CPU over {int(lens.sum())} tags: "
            f"{'identical' if not differ else f'{len(differ)} differ'}; "
            f"the CPU's least gap {float(gaps.min()):.2e}")
        bad = [(b, t) for b, t in differ if gaps[b, t] >= BOOK_NEAR_TIE]
        if bad:
            fail(f"crf_decoding: paths differ card vs CPU away from a near "
                 f"tie: {bad}")


def static_steps(program, feed, scope, n, grad_names, device):
    """`n` runs of a static chapter: the losses and each run's gradients
    ``{name: cpu tensor}``."""
    from paddle_tpu_torch import static

    main, loss = program
    exe = static.Executor(device)
    losses, grads = [], []
    for _ in range(n):
        out = exe.run(main, feed=feed, fetch_list=[loss] + grad_names,
                      scope=scope, return_numpy=False)
        losses.append(float(out[0].reshape(-1)[0]))
        grads.append({n[:-len("@GRAD")]: g.detach().cpu()
                      for n, g in zip(grad_names, out[1:])})
    return losses, grads


def hold_one_state(which, grads, scopes, trained):
    """Phase 10's end-to-end rule for steps each run from one state: every
    batch norm's running stats after the last step within RESNET_TOL of
    the tensor's largest magnitude (forward quantities), and each step's
    gradients within RESNET_GRAD_TOL as ||card - CPU|| / ||CPU|| over all
    of them together; a ReLU or a pool's tie that rounding turns moves a
    few gradients outright, so the tight check is op by op
    (`replay_chapter`)."""
    stats = [n for n in scopes["cpu"].names() if n.startswith("bn_")]
    got = {n: scopes["cuda"].get(n).cpu() for n in stats}
    stat_err = max(share(got[n], scopes["cpu"].get(n)) for n in stats)
    worst = []
    for card, cpu in zip(grads["cuda"], grads["cpu"]):
        worst.append(rel_l2({n: g.numpy() for n, g in card.items()},
                            {n: g.numpy() for n, g in cpu.items()}, trained))
    log(f"  {which}, each step from one state: BN running stats "
        f"{stat_err:.2e} of their largest; gradients "
        + ", ".join(f"{e:.2e}" for e in worst)
        + f" a step as ||card - CPU|| / ||CPU|| over all {len(trained)}")
    if stat_err > RESNET_TOL:
        fail(f"{which}: BN running stats {stat_err} past {RESNET_TOL}")
    if max(worst) > RESNET_GRAD_TOL:
        fail(f"{which}: gradients {worst} past {RESNET_GRAD_TOL}")


def flips_at_step_1(which, main, start, feeds):
    """Print, end to end at step 1: the batch-norm+relu outputs on the
    other side of 0 on the card, and the max pools' windows whose first
    maximum moved."""
    import torch.nn.functional as TF
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.weights import scope_from_numpy

    ops = main.global_block().ops
    relus = [op.out_order[0] for op in ops if op.type == "batch_norm"
             and op.attrs.get("act") == "relu"]
    pools = [(op.in_order[0], op.attrs["ksize"]) for op in ops
             if op.type == "pool2d" and op.attrs.get("pooling_type") == "max"
             and not op.attrs.get("global_pooling")]
    names = relus + [n for n, _ in pools]
    vals = {}
    for dev in ("cuda", "cpu"):
        with precise_convs(which, dev):
            out = static.Executor(dev).run(
                main, feed=feeds[dev], fetch_list=names,
                scope=scope_from_numpy(start, dev), return_numpy=False)
        vals[dev] = dict(zip(names, (v.cpu() for v in out)))
    sides = sum(int(((vals["cuda"][n] > 0) != (vals["cpu"][n] > 0)).sum())
                for n in relus)
    moved = sum(int((TF.max_pool2d(vals["cuda"][n], k, k,
                                   return_indices=True)[1]
                     != TF.max_pool2d(vals["cpu"][n], k, k,
                                      return_indices=True)[1]).sum())
                for n, k in pools)
    log(f"  {which} step 1 end to end: {sides} batch-norm+relu outputs on "
        f"the other side of 0, {moved} max-pool windows whose maximum moved")


def replay_chapter(which, main, loss, start, feed):
    """Step 1 op by op (phase 10's `replay_held`): the CPU's step from
    `start` fetching every var, then each op on the card from the CPU's
    values of its inputs, every output within 1e-4 of its tensor's
    largest magnitude."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.weights import scope_from_numpy, \
        scope_to_numpy

    names = [n for n, v in main.global_block().vars.items()
             if not v.is_data and not v.persistable]
    scope = scope_from_numpy(start, "cpu")
    vals = static.Executor("cpu").run(main, feed=feed, fetch_list=names,
                                      scope=scope, return_numpy=False)
    env = {n: torch.from_numpy(v) for n, v in start.items()}
    env.update({n: torch.from_numpy(np.asarray(v)) for n, v in feed.items()})
    env.update(zip(names, vals))
    after = {n: torch.from_numpy(v) for n, v in scope_to_numpy(scope).items()}
    with precise_convs(which, "cuda"):
        worst, past, (elements, channels) = replay_held(static, main, env,
                                                        after, "cuda")
    ranked = sorted(worst.items(), key=lambda kv: -kv[1])[:6]
    log(f"  {which} step 1 op by op on the card from the CPU's inputs "
        f"({len(worst)} op types): worst shares "
        + ", ".join(f"{k} {v:.2e}" for k, v in ranked)
        + f"; {elements} batch-norm+relu outputs on the other side of 0, "
        f"their {channels} channels' gradients left out")
    if past:
        fail(f"{which} op by op: {len(past)} outputs past their bound or of "
             f"another dtype, first {past[:5]}")


def hold_static_chapter(which, rng):
    """(a) for a static chapter: its startup run on the CPU, the scope
    carried to the card, 2 runs each (losses, step-1 gradients and every
    trained parameter by `hold_book_params`); for image classification
    the for_test clone's output card vs CPU, and the parameters bitwise
    unchanged by running it.  Image classification is held as phase 10
    holds ResNet-50: each step from one state (the card takes the CPU's
    scope before step 2), its losses by the rule above, the rest by
    `hold_one_state`, and the tight check step 1 op by op
    (`replay_chapter`), the flips end to end counted
    (`flips_at_step_1`).  Run end to end from one start, its second loss
    parted by 4.77e-4, and from one state its step-1 gradients by 7.0e-2
    of a tensor's largest (an NVIDIA H100 80GB HBM3, cuDNN off,
    Momentum): at a small batch the batch norms' and pools' rounding
    takes an element to the other side of a ReLU or a pool's tie."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.weights import scope_from_numpy, \
        scope_to_numpy

    c = held_sizes(which)
    main, startup, loss, test, out = port_program(which, c, drop=0.0,
                                                  held=True)
    feed = chapter_batch(rng, which, c)
    scopes = {"cpu": static.Scope()}
    static.Executor("cpu").run(startup, scope=scopes["cpu"])
    start = scope_to_numpy(scopes["cpu"])
    scopes["cuda"] = scope_from_numpy(start, "cuda")
    block = main.global_block()
    grad_names = [v.name + "@GRAD" for v in main.all_parameters()
                  if block.has_var(v.name + "@GRAD")]
    feeds = {dev: {k: torch.from_numpy(np.asarray(v)).to(dev)
                   for k, v in feed.items()} for dev in scopes}
    one_state = which == "image_classification"
    losses, grads = {"cuda": [], "cpu": []}, {"cuda": [], "cpu": []}
    for step in range(BOOK["held_steps"]):
        if step and one_state:
            scopes["cuda"] = scope_from_numpy(scope_to_numpy(scopes["cpu"]),
                                              "cuda")
        for dev in ("cuda", "cpu"):
            with precise_convs(which, dev):
                got = static_steps((main, loss), feeds[dev], scopes[dev], 1,
                                   grad_names, dev)
            losses[dev] += got[0]
            grads[dev] += got[1]
    hold_chapter_losses(which, losses)
    trained = {n[:-len("@GRAD")] for n in grad_names}
    if one_state:
        hold_one_state(which, grads, scopes, trained)
        flips_at_step_1(which, main, start, feeds)
    else:
        params = {dev: {n: scopes[dev].get(n) for n in trained}
                  for dev in scopes}
        hold_book_params(which, params["cuda"], params["cpu"], grads)
    if which in CONV_CHAPTERS:
        _, fresh = static_steps((main, loss), feeds["cuda"],
                                scope_from_numpy(start, "cuda"), 1,
                                grad_names, "cuda")
        hold_cudnn(which, fresh[0], grads["cpu"][0])
    if one_state:
        replay_chapter(which, main, loss, start, feed)
        scopes["cuda"] = scope_from_numpy(scope_to_numpy(scopes["cpu"]),
                                          "cuda")
    if test is None:
        return
    before = {n: scopes["cuda"].get(n).clone() for n in scopes["cuda"].names()}
    outs = {}
    for dev in ("cuda", "cpu"):
        with precise_convs(which, dev):
            outs[dev] = static.Executor(dev).run(
                test, feed=feeds[dev], fetch_list=[out], scope=scopes[dev],
                return_numpy=False)[0].cpu()
    err = share(outs["cuda"], outs["cpu"])
    moved = [n for n, v in before.items()
             if not torch.equal(scopes["cuda"].get(n), v)]
    log(f"  {which} for_test clone ({len(test.global_block().ops)} ops, "
        f"none a grad or update op): eval output card vs CPU {err:.2e} of "
        f"its largest; persistables changed by running it: {moved or 'none'}")
    if err > CHAPTER_TEST_TOL or moved:
        fail(f"{which} for_test clone: output {err} past "
             f"{CHAPTER_TEST_TOL}, or it changed {moved}")
    if any(op.type.endswith("_grad") or op.type in ("adam", "momentum")
           for op in test.global_block().ops):
        fail(f"{which} for_test clone kept a grad or update op")


def phase_chapters_held():
    """(a): each chapter at its width, batch and length cut, dropout 0,
    card against the CPU (the conv chapters with cuDNN off on the card,
    `precise_convs`; recognize_digits with cuDNN on as well,
    `hold_cudnn`)."""
    rng = np.random.default_rng(21)
    for which in CHAPTERS:
        t0 = time.perf_counter()
        if which in STATIC_CHAPTERS:
            hold_static_chapter(which, rng)
        else:
            hold_dygraph_chapter(which, rng)
        log(f"  ({which}: {time.perf_counter() - t0:.1f} s)")


def phase_chapters_run():
    """(b): each chapter alone on the card at its sizes (image
    classification with dropout on)."""
    from paddle_tpu_torch import static

    rng = np.random.default_rng(22)
    n = BOOK["warmup"] + BOOK["iters"] + BOOK["profiled"]
    out = {}
    for which in CHAPTERS:
        c = CHAPTER_SIZES[which]
        batches = [chapter_batch(rng, which, c) for _ in range(n)]
        if which in STATIC_CHAPTERS:
            main, startup, loss, _, _ = port_program(which, c)
            exe, scope = static.Executor(), static.Scope()
            exe.run(startup, scope=scope)
            feeds = iter([{k: torch.from_numpy(np.asarray(v)).cuda()
                           for k, v in b.items()} for b in batches])

            def step(main=main, loss=loss, exe=exe, scope=scope, feeds=feeds):
                return exe.run(main, feed=next(feeds), fetch_list=[loss],
                               scope=scope, return_numpy=False)[0]
        else:
            step = eager_step(chapter_model(which).to("cuda"), iter(
                [[torch.from_numpy(a).cuda() for a in b] for b in batches]),
                c["lr"])
        out[which] = dict(timed_steps(f"{which} (B {c['batch']})", step),
                          samples=c["batch"])
        del step
        torch.cuda.empty_cache()
    return out


def chapter_numbers(card, run):
    """(b)'s numbers: ms a step, samples/s, kernels a step, peak memory
    and the idle share, for each chapter."""
    for which in CHAPTERS:
        r = run[which]
        ms = r["wall"] / r["iters"] * 1e3
        kernels = (f"{r['kernels']:.0f} kernels a step" if r["busy"] > 0
                   else "kernels a step not measured")
        log(f"  [{card}] {which}: {ms:.2f} ms per step over {r['iters']} "
            f"steps, {r['samples'] / ms * 1e3:.1f} samples/s; peak memory "
            f"{r['peak'] / 2**30:.2f} GiB above the steps' start; "
            f"{kernels}")
        book_idle(card, which, r)


# ------------------- phase 21: CycleGAN on the conv library -------------------
# Zhu et al., "Unpaired Image-to-Image Translation using Cycle-Consistent
# Adversarial Networks" (ICCV 2017, arXiv:1703.10593), section 4 and
# appendix 7.2: the 9-block ResNet generator for 256x256 (c7s1-64, d128,
# d256, R256 x 9, u128, u64, c7s1-3: reflection padding, instance norm
# without affine parameters, ReLU, tanh out), the 70x70 PatchGAN
# discriminator (C64-C128-C256-C512, 4x4 convolutions, LeakyReLU 0.2, no
# norm on C64, C512 at stride 1, then a 4x4 convolution to one channel),
# LSGAN losses, cycle weight 10 and identity weight 0.5 x 10, Adam 2e-4
# with beta1 0.5, batch 1, weights N(0, 0.02).  A convolution followed by
# the affine-free instance norm has no bias (the norm removes any bias,
# which would only be a parameter without a gradient).  The paper's pool
# of 50 generated images hands back the newest image while it fills, so
# the runs here, of fewer iterations, draw none from it.  Images are made
# from a seed in [-1, 1].
# (a) holds at `held_blocks` residual blocks: all 9 while the CPU's side of
# the hold takes at most 30 s on the chip's host, else 3 (PERF.md §6)
CYCLEGAN = dict(ngf=64, ndf=64, blocks=9, image=256, batch=1, lr=2e-4,
                beta1=0.5, lambda_cycle=10.0, lambda_identity=0.5,
                held_blocks=9, warmup=1, iters=10, profiled=1)
# (b)'s sweep, card (cuDNN on, TF32 off) against the CPU, of each tensor's
# largest magnitude
LAYER_SWEEP_TOL = 1e-4


def cyclegan_nets(nn, base, gen, place):
    """The generator and discriminator classes over a package's `nn`;
    `gen` goes to every convolution (the port's generator), `place` to
    the convolutions and norms (the port's device)."""
    init = {"weight_attr": nn.initializer.Normal(0.0, 0.02)}

    def conv(cin, cout, k, stride=1, padding=0, bias=True):
        return nn.Conv2D(cin, cout, k, stride=stride, padding=padding,
                         bias_attr=None if bias else False, **init, **gen,
                         **place)

    def norm(c):
        return nn.InstanceNorm2D(c, weight_attr=False, bias_attr=False,
                                 **place)

    class ResnetBlock(base):
        def __init__(self, dim):
            super().__init__()
            self.block = nn.Sequential(
                nn.Pad2D(1, mode="reflect"), conv(dim, dim, 3, bias=False),
                norm(dim), nn.ReLU(), nn.Pad2D(1, mode="reflect"),
                conv(dim, dim, 3, bias=False), norm(dim))

        def forward(self, x):
            return x + self.block(x)

    class Generator(base):
        """c7s1-ngf, d(2 ngf), d(4 ngf), `blocks` residual blocks,
        u(2 ngf), u(ngf), c7s1-3 and tanh."""

        def __init__(self, ngf, blocks, channels=3):
            super().__init__()
            layers = [nn.Pad2D(3, mode="reflect"),
                      conv(channels, ngf, 7, bias=False), norm(ngf),
                      nn.ReLU()]
            for mult in (1, 2):
                layers += [conv(ngf * mult, ngf * mult * 2, 3, 2, 1,
                                bias=False), norm(ngf * mult * 2),
                           nn.ReLU()]
            layers += [ResnetBlock(ngf * 4) for _ in range(blocks)]
            for mult in (4, 2):
                layers += [nn.Conv2DTranspose(
                    ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                    output_padding=1, bias_attr=False, **init, **gen,
                    **place), norm(ngf * mult // 2), nn.ReLU()]
            layers += [nn.Pad2D(3, mode="reflect"), conv(ngf, channels, 7),
                       nn.Tanh()]
            self.net = nn.Sequential(*layers)

        def forward(self, x):
            return self.net(x)

    class Discriminator(base):
        """The 70x70 PatchGAN: C64-C128-C256-C512 and a 4x4 convolution
        to one channel."""

        def __init__(self, ndf, channels=3):
            super().__init__()
            layers = [conv(channels, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
            for i, stride in ((1, 2), (2, 2), (3, 1)):
                layers += [conv(ndf * 2 ** (i - 1), ndf * 2 ** i, 4, stride,
                                1, bias=False), norm(ndf * 2 ** i),
                           nn.LeakyReLU(0.2)]
            layers += [conv(ndf * 8, 1, 4, 1, 1)]
            self.net = nn.Sequential(*layers)

        def forward(self, x):
            return self.net(x)

    return Generator, Discriminator


def cyclegan_g_loss(P, F, nets, real_a, real_b, c=CYCLEGAN):
    """The generators' loss of one iteration (LSGAN against ones, cycle
    L1 x lambda, identity L1 x lambda x its weight) and the fakes the
    discriminators then see: (loss, {term: loss}, fake_b, fake_a)."""
    g_a, g_b, d_a, d_b = nets
    fake_b, fake_a = g_a(real_a), g_b(real_b)
    lam, idt = c["lambda_cycle"], c["lambda_cycle"] * c["lambda_identity"]
    pa, pb = d_a(fake_b), d_b(fake_a)
    terms = {"G_A": F.mse_loss(pa, P.ones_like(pa)),
             "G_B": F.mse_loss(pb, P.ones_like(pb)),
             "cycle_A": F.l1_loss(g_b(fake_b), real_a) * lam,
             "cycle_B": F.l1_loss(g_a(fake_a), real_b) * lam,
             "idt_A": F.l1_loss(g_a(real_b), real_b) * idt,
             "idt_B": F.l1_loss(g_b(real_a), real_a) * idt}
    loss = terms["G_A"] + terms["G_B"] + terms["cycle_A"] + \
        terms["cycle_B"] + terms["idt_A"] + terms["idt_B"]
    return loss, terms, fake_b, fake_a


def cyclegan_d_loss(P, F, nets, real_a, real_b, fake_b, fake_a):
    """The discriminators' loss: each LSGAN (real against ones, the
    generators' fake, detached by the caller, against zeros) halved."""
    _, _, d_a, d_b = nets
    total = 0
    for d, real, fake in ((d_a, real_b, fake_b), (d_b, real_a, fake_a)):
        pr, pf = d(real), d(fake)
        total = total + (F.mse_loss(pr, P.ones_like(pr))
                         + F.mse_loss(pf, P.zeros_like(pf))) * 0.5
    return total


def cyclegan_images(rng, c, size=None):
    """(real_a, real_b): [batch, 3, size, size] float32 in [-1, 1]."""
    s = size or c["image"]
    return tuple(rng.uniform(-1, 1, (c["batch"], 3, s, s)).astype(
        np.float32) for _ in range(2))


def port_cyclegan(c=CYCLEGAN, blocks=None, seed=0, device="cpu"):
    """(G_A, G_B, D_A, D_B) of the port at `c`'s widths, built on the CPU
    from `seed` (weights N(0, 0.02)) and moved to `device`."""
    from paddle_tpu_torch import nn

    g = torch.Generator().manual_seed(seed)
    gen_cls, disc_cls = cyclegan_nets(nn, torch.nn.Module, {"generator": g},
                                      {"device": "cpu"})
    blocks = c["blocks"] if blocks is None else blocks
    nets = (gen_cls(c["ngf"], blocks), gen_cls(c["ngf"], blocks),
            disc_cls(c["ndf"]), disc_cls(c["ndf"]))
    return tuple(n.to(device) for n in nets)


def cyclegan_iteration(nets, opts, real_a, real_b, c=CYCLEGAN):
    """One training iteration of the port as the paper's code runs it:
    the generators' step with the discriminators frozen, then the
    discriminators' step on the fakes of that forward.  Returns the
    losses ({term: 0-d tensor}, with "G" and "D") on the device and the
    gradients of the step ({net.name: tensor}) when asked by
    `opts["grads"]`."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.nn import functional as F

    g_a, g_b, d_a, d_b = nets
    for d in (d_a, d_b):
        d.requires_grad_(False)
    loss_g, terms, fake_b, fake_a = cyclegan_g_loss(P, F, nets, real_a,
                                                    real_b, c)
    opts["G"].clear_grad()
    loss_g.backward()
    for d in (d_a, d_b):
        d.requires_grad_(True)
    loss_d = cyclegan_d_loss(P, F, nets, real_a, real_b, fake_b.detach(),
                             fake_a.detach())
    opts["D"].clear_grad()
    loss_d.backward()
    if opts.get("grads") is not None:
        opts["grads"].append({f"{k}.{n}": p.grad.detach().clone()
                              for k, net in zip(CYCLEGAN_NETS, nets)
                              for n, p in net.named_parameters()})
    opts["G"].step()
    opts["D"].step()
    return {**{k: v.detach() for k, v in terms.items()},
            "G": loss_g.detach(), "D": loss_d.detach()}


CYCLEGAN_NETS = ("G_A", "G_B", "D_A", "D_B")


def cyclegan_optimizers(nets, c=CYCLEGAN):
    from paddle_tpu_torch.optimizer import Adam

    g_a, g_b, d_a, d_b = nets
    return {"G": Adam(c["lr"], c["beta1"], parameters=list(
        g_a.parameters()) + list(g_b.parameters())),
        "D": Adam(c["lr"], c["beta1"], parameters=list(
            d_a.parameters()) + list(d_b.parameters()))}


def layer_sweep_cases(seed=21):
    """(b)'s sweep: every function and layer this phase's slice ported,
    once each at the CPU tests' sizes, as (name, fn, inputs, kwargs): a
    function of `F`, or a layer built on the CPU (the card runs a copy);
    float inputs are differentiated, integer ones are not."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import nn_extra

    r = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    cpu = {"generator": g, "device": "cpu"}

    def f(*shape, lo=-2.0, hi=2.0):
        return r.uniform(lo, hi, shape).astype(np.float32)

    x1, x2, x3 = f(2, 4, 9), f(2, 4, 7, 6), f(1, 4, 5, 6, 4)
    img, logits = f(1, 3, 6, 8), f(3, 6, 5, lo=-3, hi=3)
    labels = np.array([[1, 1, 2], [4, 0, 0], [3, 2, 0]], np.int64)
    lens = (np.array([6, 4, 5], np.int64), np.array([3, 0, 2], np.int64))
    prob = np.exp(f(4, 3))
    prob = (prob / prob.sum(-1, keepdims=True)).astype(np.float32)
    feat = f(4, 5)
    return [
        ("conv1d", F.conv1d, (x1, f(6, 4, 3), f(6)), dict(padding="SAME")),
        ("conv2d", F.conv2d, (np.ascontiguousarray(x2.transpose(0, 2, 3, 1)),
                              f(6, 4, 3, 3)),
         dict(stride=2, padding="SAME", data_format="NHWC")),
        ("conv2d_transpose", F.conv2d_transpose, (x2, f(4, 3, 3, 2), f(3)),
         dict(stride=(2, 1), padding=1, output_padding=(3, 2))),
        ("conv3d", F.conv3d, (x3, f(6, 2, 2, 2, 2)),
         dict(groups=2, padding="SAME")),
        ("conv3d_transpose", F.conv3d_transpose, (x3, f(4, 3, 2, 3, 2)),
         dict(stride=2, output_size=[11, 13, 10])),
        ("conv1d_transpose", F.conv1d_transpose, (x1, f(4, 2, 3)),
         dict(stride=3, groups=2, output_padding=2)),
        ("Conv1D", nn.Conv1D(4, 6, 3, 2, 1, **cpu), (x1,), {}),
        ("Conv2D", nn.Conv2D(4, 6, 3, 2, "SAME", **cpu), (x2,), {}),
        ("Conv3D", nn.Conv3D(4, 6, (2, 3, 2), 1, 1, **cpu), (x3,), {}),
        ("Conv1DTranspose", nn.Conv1DTranspose(4, 6, 3, 2, 1, 1, **cpu),
         (x1,), {}),
        ("Conv2DTranspose", nn.Conv2DTranspose(4, 6, 3, 2, 1, 1, **cpu),
         (x2,), {}),
        ("Conv3DTranspose", nn.Conv3DTranspose(4, 2, 2, 2, **cpu), (x3,),
         {}),
        ("max_pool1d", F.max_pool1d, (x1, 4, 2, [2, 1]), {}),
        ("avg_pool1d", F.avg_pool1d, (x1, 3, 2, 1), {}),
        ("max_pool2d", F.max_pool2d, (x2, 3, 2, [0, 2, 1, 1]), {}),
        ("avg_pool2d", F.avg_pool2d, (x2, 3, 2, "SAME"), {}),
        ("adaptive_avg_pool2d", F.adaptive_avg_pool2d, (x2, (4, 3)), {}),
        ("adaptive_max_pool2d", F.adaptive_max_pool2d, (x2, (4, 3)), {}),
        ("max_pool3d", F.max_pool3d, (x3, 3, 2, 1),
         dict(ceil_mode=True, return_mask=True)),
        ("avg_pool3d", F.avg_pool3d, (x3, 2), dict(ceil_mode=True)),
        ("adaptive_avg_pool1d", F.adaptive_avg_pool1d, (x1, 4), {}),
        ("adaptive_max_pool1d", F.adaptive_max_pool1d, (x1, 4), {}),
        ("adaptive_avg_pool3d", F.adaptive_avg_pool3d, (x3, (3, 4, 2)), {}),
        ("adaptive_max_pool3d", F.adaptive_max_pool3d, (x3, (3, 4, 2)), {}),
        *[(cls, getattr(nn, cls)(*args), (x,), {}) for cls, args, x in (
            ("MaxPool1D", (3, 2, "SAME"), x1), ("AvgPool1D", (3, 2, 1), x1),
            ("MaxPool2D", (3, 2, 1), x2), ("AvgPool2D", (3, 2, 1), x2),
            ("MaxPool3D", (3, 2, 1, True), x3),
            ("AvgPool3D", (3, 2, 1, True), x3),
            ("AdaptiveAvgPool1D", (4,), x1), ("AdaptiveMaxPool1D", (4,), x1),
            ("AdaptiveAvgPool2D", ((4, 3),), x2),
            ("AdaptiveMaxPool2D", ((4, 3),), x2),
            ("AdaptiveAvgPool3D", ((3, 4, 2),), x3),
            ("AdaptiveMaxPool3D", ((3, 4, 2),), x3))],
        ("instance_norm", F.instance_norm, (x2, f(4), f(4)), {}),
        ("group_norm", F.group_norm, (x2, 2, 1e-5, f(4), f(4)), {}),
        ("local_response_norm", F.local_response_norm, (x2, 3), {}),
        ("spectral_norm_apply", nn_extra.spectral_norm_apply,
         (f(5, 3, 2, 3), 2), {}),
        ("InstanceNorm2D", nn.InstanceNorm2D(4, **cpu), (x2,), {}),
        ("InstanceNorm3D", nn.InstanceNorm3D(4, **cpu), (x3,), {}),
        ("GroupNorm", nn.GroupNorm(2, 4, **cpu), (x2,), {}),
        ("LocalResponseNorm", nn.LocalResponseNorm(3), (x2,), {}),
        ("SpectralNorm", nn.SpectralNorm((5, 3, 2, 3), 1, 2, **cpu),
         (f(5, 3, 2, 3),), {}),
        ("SyncBatchNorm", nn.SyncBatchNorm(4, **cpu), (x2,), {}),
        ("weight_norm", nn.utils.weight_norm(nn.Conv2D(3, 5, 3, **cpu)),
         (img,), {}),
        ("spectral_norm", nn.utils.spectral_norm(nn.Linear(3, 5, generator=g)),
         (f(4, 3),), {}),
        ("interpolate_nearest", F.interpolate, (img,), dict(scale_factor=1.5)),
        ("interpolate_bilinear_down", F.interpolate, (img,),
         dict(size=(4, 3), mode="bilinear")),
        ("interpolate_bilinear_align", F.interpolate, (img,),
         dict(size=(9, 13), mode="bilinear", align_corners=True)),
        ("interpolate_bicubic", F.interpolate, (img,),
         dict(size=(4, 11), mode="bicubic")),
        ("pixel_shuffle", F.pixel_shuffle, (f(2, 8, 3, 2), 2), {}),
        ("unfold", F.unfold, (img, 2), dict(paddings=[1, 0, 2, 1])),
        ("fold", F.fold, (f(2, 12, 12), [4, 6], 2, 2, 1), {}),
        *[(cls, getattr(nn, cls)(*args), (x,), {}) for cls, args, x in (
            ("Identity", (), x2), ("Pad1D", ([2, 1], "reflect"), x1),
            ("Pad2D", (2, "replicate"), x2), ("Pad3D", (1, "circular"), x3),
            ("ZeroPad2D", ([0, 1, 2, 0],), x2),
            ("Upsample", ((4, 3), None, "bilinear"), img),
            ("UpsamplingBilinear2D", ((9, 7),), img),
            ("UpsamplingNearest2D", (None, 2), img),
            ("PixelShuffle", (2,), f(1, 8, 2, 3)),
            ("Unfold", (3, 1, 1), img), ("Fold", ([3, 4], 2), f(2, 12, 6)),
            ("Dropout2D", (0.0,), x2), ("Dropout3D", (0.0,), x3),
            ("AlphaDropout", (0.0,), x2))],
        ("dropout3d", F.dropout3d, (x3, 0.5), dict(training=False)),
        ("CosineSimilarity", nn.CosineSimilarity(2), (x2, f(2, 4, 7, 6)), {}),
        ("bilinear", F.bilinear, (feat[:, :3], feat, f(2, 3, 5), f(1, 2)),
         {}),
        ("Bilinear", nn.Bilinear(3, 5, 4, **cpu), (feat[:, :3], feat), {}),
        ("ctc_loss", F.ctc_loss, (logits, labels) + lens,
         dict(norm_by_times=True)),
        ("CTCLoss", nn.CTCLoss(0, "sum"), (logits, labels) + lens, {}),
        ("hsigmoid_loss", F.hsigmoid_loss,
         (feat, r.integers(0, 6, (4, 1)), 6, f(5, 5)), {}),
        ("HSigmoidLoss", nn.HSigmoidLoss(5, 7, **cpu),
         (feat, r.integers(0, 7, (4, 1))), {}),
        ("dice_loss", F.dice_loss, (prob, r.integers(0, 3, (4, 1))), {}),
        ("log_loss", F.log_loss, (prob, r.integers(0, 2, (4, 3)).astype(
            np.float32)), {}),
        ("npair_loss", F.npair_loss, (f(4, 3), f(4, 3),
                                      np.array([0, 1, 0, 2])), {}),
        ("affine_grid", F.affine_grid, (f(2, 2, 3, lo=-1, hi=1),
                                        [2, 3, 4, 5]), {}),
        ("grid_sample", F.grid_sample, (f(2, 3, 4, 5), f(2, 3, 4, 2, lo=-1.2,
                                                          hi=1.2)), {}),
        ("temporal_shift", F.temporal_shift, (f(4, 8, 2, 2), 2), {}),
    ]


def sweep_run(fn, inputs, kw, device):
    """`fn` on `device` over `inputs` (float arrays differentiated, a
    layer's parameters too; a list of arrays becomes a list of tensors):
    its outputs and the gradients under a fixed cotangent (a sparse one
    made dense; zeros where no float output depends on them)."""
    import torch.nn as tnn

    if isinstance(fn, tnn.Module):  # a copy each: the case stays unrun
        fn = copy.deepcopy(fn).to(device)

    def tensor(a):
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [tensor(x) for x in a]
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.array(a)).to(device)
        return a

    args = [tensor(a) for a in inputs]
    flat = [t for a in args for t in (a if isinstance(a, list) else [a])]
    wrt = [a.requires_grad_() for a in flat if isinstance(a, torch.Tensor)
           and a.is_floating_point()]
    if isinstance(fn, tnn.Module):
        wrt += [p for p in fn.parameters() if p.requires_grad]
    out = fn(*args, **kw)
    outs = list(out) if isinstance(out, tuple) else [out]
    floats = [o for o in outs if o.is_floating_point() and o.requires_grad]
    grads = [None] * len(wrt)
    if floats and wrt:
        loss = sum((o * torch.linspace(-1, 1, o.numel(), device=device)
                    .reshape(o.shape)).sum() for o in floats)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return outs, [torch.zeros_like(w) if gr is None else
                  gr.to_dense() if gr.is_sparse else gr
                  for w, gr in zip(wrt, grads)]


def phase_layer_sweep(cases=None):
    """(b): every ported function and layer of a slice (`cases`, else
    phase 21's `layer_sweep_cases`), forward and backward, card (cuDNN
    on, TF32 off) against the CPU at the CPU tests' sizes: the worst
    share of each, held to LAYER_SWEEP_TOL; integer outputs (the 3-D
    pool's mask, lengths, ids, the metric ops' counts) equal; every
    output on the card."""
    worst = []
    for name, fn, inputs, kw in cases or layer_sweep_cases():
        c_out, c_grad = sweep_run(fn, inputs, kw, "cpu")
        g_out, g_grad = sweep_run(fn, inputs, kw, "cuda")
        errs = [0.0]
        for got, want in zip(g_out + g_grad, c_out + c_grad):
            if got.device.type != "cuda":
                fail(f"{name}: an output on {got.device}")
            if want.is_floating_point():
                errs.append(share(got.detach().cpu(), want.detach()))
            elif not torch.equal(got.cpu(), want):
                fail(f"{name}: integer output differs card vs CPU")
        err = max(errs)
        worst.append((err, name))
        if not err <= LAYER_SWEEP_TOL:
            fail(f"{name}: card vs CPU {err:.3e} of the largest magnitude, "
                 f"past {LAYER_SWEEP_TOL}")
    worst.sort(reverse=True)
    log(f"  {len(worst)} functions and layers, forward and every gradient, "
        f"card vs CPU: worst {worst[0][0]:.2e} ({worst[0][1]}), held to "
        f"{LAYER_SWEEP_TOL} of each tensor's largest magnitude")
    log("  " + ", ".join(f"{n} {e:.1e}" for e, n in worst))
    return worst


def cyclegan_on(nets_cpu, device, c=CYCLEGAN):
    """Copies of the CPU networks (at `c`'s widths) on `device`, the same
    weights."""
    from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy

    blocks = sum(1 for m in nets_cpu[0].modules()
                 if type(m).__name__ == "ResnetBlock")
    fresh = port_cyclegan(c, blocks=blocks, seed=1)
    return tuple(layer_from_numpy(new, layer_to_numpy(old), device)
                 for new, old in zip(fresh, nets_cpu))


@contextlib.contextmanager
def relu_decisions(nets, pinned=None):
    """Each ReLU and LeakyReLU call of `nets` records which inputs it
    passes (`pinned` None), or takes the recorded decision of the same
    call instead of its own: ``where(decision, x, slope x)``, the same
    value and gradient as the activation's given the decision.  Yields
    (the decisions in call order, [how many of its own the pinned run
    overrode])."""
    decisions = [] if pinned is None else pinned
    taken, flips, handles = iter(decisions), [0], []

    def hook(module, inputs, output):
        x = inputs[0]
        slope = module.kwargs.get("negative_slope", 0.0)
        own = x > 0 if slope == 0.0 else x >= 0
        if pinned is None:
            decisions.append(own.detach().cpu())
            return None
        d = next(taken).to(x.device)
        flips[0] += int((own != d).sum())
        return torch.where(d, x, x * slope)

    for net in nets:
        handles += [m.register_forward_hook(hook) for m in net.modules()
                    if type(m).__name__ in ("ReLU", "LeakyReLU")]
    try:
        yield decisions, flips
    finally:
        for h in handles:
            h.remove()


def phase_cyclegan_held():
    """(a): the first full iteration at the published widths, 256x256,
    batch 1, card against the CPU from one set of weights: every loss
    term within BOOK_LOSS_TOL relative, every gradient and every
    parameter after the step by phase 20's rule (`hold_book_params`).
    The card's ReLUs take the CPU's decisions (`relu_decisions`; how many
    differ is printed): an input within rounding of 0 that takes the
    other side moves the gradient of the convolution before it by about
    1 / sqrt(its positions), 3.89e-2 of a tensor's largest here.  cuDNN
    stays on, unlike phase 20's hold: here PyTorch's own fp32
    convolutions (cuDNN off, and the CPU's without oneDNN alike) are the
    ones far from float64, 2.20e-3 of a residual block's largest
    gradient, where cuDNN's are 1.56e-5 and the CPU's oneDNN 5.18e-6
    (``tools/cyclegan_precision.py --part card``)."""
    c = CYCLEGAN
    rng = np.random.default_rng(30)
    images = cyclegan_images(rng, c)
    cpu = port_cyclegan(c, blocks=c["held_blocks"], seed=0)
    card = cyclegan_on(cpu, "cuda", c)
    losses, grads, secs, decisions = {}, {}, {}, None
    for dev, nets in (("cpu", cpu), ("cuda", card)):
        opts = dict(cyclegan_optimizers(nets, c), grads=[])
        args = [torch.from_numpy(a).to(dev) for a in images]
        with relu_decisions(nets, decisions) as (decisions, flips):
            t0 = time.perf_counter()
            out = cyclegan_iteration(nets, opts, *args, c=c)
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[dev] = time.perf_counter() - t0
        losses[dev] = {k: float(v) for k, v in out.items()}
        grads[dev] = opts["grads"]
    n_dec = sum(d.numel() for d in decisions)
    log(f"  held at {c['held_blocks']} residual blocks, ngf {c['ngf']}, "
        f"ndf {c['ndf']}, {c['image']}x{c['image']}, batch {c['batch']}: "
        f"the CPU's iteration {secs['cpu']:.1f} s, the card's "
        f"{secs['cuda']:.2f} s; the card's ReLUs took the CPU's decision "
        f"over {flips[0]} of their own, of {n_dec} in {len(decisions)} "
        f"calls")
    err = max(abs(losses["cuda"][k] - v) / abs(v)
              for k, v in losses["cpu"].items())
    log(f"  losses card {losses['cuda']} CPU {losses['cpu']} (worst "
        f"{err:.2e} relative)")
    if not all(math.isfinite(v) for v in losses["cuda"].values()) \
            or err > BOOK_LOSS_TOL:
        fail(f"cyclegan: card losses {losses['cuda']} vs CPU "
             f"{losses['cpu']}, past {BOOK_LOSS_TOL} relative")

    def named(nets):
        return {f"{k}.{n}": p for k, net in zip(CYCLEGAN_NETS, nets)
                for n, p in net.named_parameters()}

    hold_book_params("cyclegan (one iteration)", named(card), named(cpu),
                     {d: [{n: g.cpu() for n, g in gs[0].items()}]
                      for d, gs in grads.items()})
    del card, cpu
    torch.cuda.empty_cache()
    return secs["cpu"]


def phase_cyclegan_run():
    """(a) cont.: the full-width networks alone on the card (cuDNN on),
    timed as phase 19's models are (`timed_steps`)."""
    c = CYCLEGAN
    rng = np.random.default_rng(31)
    nets = port_cyclegan(c, seed=0, device="cuda")
    opts = cyclegan_optimizers(nets, c)
    n = c["warmup"] + c["iters"] + c["profiled"]
    batches = iter([[torch.from_numpy(a).cuda() for a in
                     cyclegan_images(rng, c)] for _ in range(n)])

    def step():
        return cyclegan_iteration(nets, opts, *next(batches), c=c)["G"]

    out = timed_steps("CycleGAN (the generators' loss)", step, c)
    del nets, opts, step
    torch.cuda.empty_cache()
    return out


def cyclegan_numbers(card, r):
    c = CYCLEGAN
    ms = r["wall"] / r["iters"] * 1e3
    log(f"  [{card}] CycleGAN iteration (ngf {c['ngf']}, {c['blocks']} "
        f"residual blocks, {c['image']}x{c['image']}, batch {c['batch']}, "
        f"cuDNN on, TF32 off): {ms:.2f} ms per iteration over "
        f"{r['iters']}, {1e3 / ms:.2f} iterations/s, "
        f"{2 * c['batch'] * 1e3 / ms:.2f} images/s (one of each domain an "
        f"iteration); peak memory {r['peak'] / 2**30:.2f} GiB above the "
        f"iterations' start; {r['kernels']:.0f} kernels an iteration")
    book_idle(card, "CycleGAN iteration", r)


# ---------- phase 22: the sequence library and sparse embeddings ----------
# Chapter 06 of the PaddlePaddle v2.1 book (understand_sentiment), its
# convolution_net: the imdb dictionary of 5,147 words, EMB_DIM 128,
# HID_DIM 512 filters a window (3 and 4), CLASS_DIM 2, BATCH_SIZE 128,
# ``Adagrad(learning_rate=0.002)`` on an ``is_sparse=True`` embedding;
# phase 19's reviews (padded to 256, lengths from 64, id 0 the padding).
# (a) holds it at full width with batch and length cut, card against the
# CPU; (c) a 2,000,000 x 128 sparse table (the JAX package's
# tests/test_sparse_grad.py case) with lazy Adam; (d) the chapter's
# sizes, sparse and dense.
CONV_NET = dict(vocab=5147, emb=128, filters=512, classes=2, batch=128,
                seq=256, min_len=64, lr=2e-3, held_batch=16, held_seq=32,
                held_min=8, held_steps=2)
LARGE_TABLE = dict(rows=2_000_000, dim=128, batch=8, seq=16, lr=0.1)
SPARSE_RISE = 16 * 2**20      # (c)'s peak rise over the held bytes


def conv_build(sparse=True, seed=0):
    """Phase 22's convolution_net at the chapter's widths, on the CPU from
    a generator of `seed`."""
    c = CONV_NET
    return port_book_models(seed)[2](c["vocab"], c["emb"], c["filters"],
                                      c["classes"], sparse=sparse)


def conv_adagrad(model, lr):
    from paddle_tpu_torch import optimizer

    return optimizer.Adagrad(learning_rate=lr, parameters=model.parameters())


def phase_sequence_held():
    """(a): convolution_net at full width, batch and length cut, card
    against the CPU from one set of weights, 2 sparse Adagrad steps:
    losses within BOOK_LOSS_TOL relative, the embedding's coalesced
    gradient the same ids with rows within BOOK_PARAM_TOL of their
    largest, step-1 gradients and the stepped parameters by
    `hold_book_params` (phase 19's rule; the floor is Adagrad's
    epsilon)."""
    from paddle_tpu_torch.models import layer_from_numpy, layer_to_numpy

    c = CONV_NET
    t0 = time.perf_counter()
    batch = sentiment_batch(np.random.default_rng(22), c["held_batch"],
                            c["held_seq"], c["vocab"], c["held_min"])
    cpu = conv_build()
    card = layer_from_numpy(conv_build(seed=1), layer_to_numpy(cpu), "cuda")
    losses, grads, rows = {}, {"cuda": [], "cpu": []}, {"cuda": [],
                                                         "cpu": []}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        args = [torch.from_numpy(a).to(dev) for a in batch]
        losses[dev] = book_steps(model, args, c["lr"], c["held_steps"],
                                 grads[dev], conv_adagrad, rows[dev])
    err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    log(f"  convolution_net at full width (V {c['vocab']}, E {c['emb']}, "
        f"2 x {c['filters']} filters), B={c['held_batch']}, "
        f"T={c['held_seq']}: losses card {losses['cuda']} CPU "
        f"{losses['cpu']} (worst {err:.2e} relative) "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(math.isfinite(x) for x in losses["cuda"]) \
            or err > BOOK_LOSS_TOL:
        fail(f"convolution_net: card losses {losses['cuda']} vs CPU "
             f"{losses['cpu']}, past {BOOK_LOSS_TOL} relative")
    row_err = 0.0
    for k, ((gi, gv), (ci, cv)) in enumerate(zip(rows["cuda"],
                                                 rows["cpu"])):
        if not torch.equal(gi, ci):
            fail(f"convolution_net step {k + 1}: the sparse gradient's ids "
                 f"differ card vs CPU")
        row_err = max(row_err, share(gv, cv))
    log(f"  the embedding's sparse gradient: {rows['cpu'][0][0].numel()} "
        f"ids of {c['vocab']} at step 1, the same ids on both; rows "
        f"{row_err:.2e} of their largest magnitude")
    if row_err > BOOK_PARAM_TOL:
        fail(f"convolution_net: sparse gradient rows {row_err} of their "
             f"largest, past {BOOK_PARAM_TOL}")
    worst, past = hold_book_params("convolution_net", dict(
        card.named_parameters()), dict(cpu.named_parameters()), grads)
    return dict(loss=err, rows=row_err, params=worst, past=past)


def static_sequence_case(B, T, D):
    """The static sequence program (``static.nn``'s sequence_conv, the
    pools, first and last steps, softmax, reverse and row_conv, their
    means summed the loss) and a function that runs it on `x`'s device
    from one start scope: the outputs and the filters' gradients, as
    tensors there."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models.weights import scope_from_numpy, \
        scope_to_numpy

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        xv = static.data("x", [B, T, D])
        n = static.data("len", [B], "int64")
        conv = static.nn.sequence_conv(xv, n, 5, filter_size=3, act="tanh")
        outs = [static.nn.sequence_pool(conv, n, k) for k in (
            "sum", "average", "sqrt", "max", "last", "first")]
        outs += [static.nn.sequence_first_step(conv, n),
                 static.nn.sequence_last_step(conv, n),
                 static.nn.sequence_softmax(conv, n),
                 static.nn.sequence_reverse(conv, n),
                 static.nn.row_conv(xv, 2, act="tanh")]
        loss = static.nn.mean(outs[0])
        for o in outs[1:]:
            loss = loss + static.nn.mean(o)
        grads = [g for _, g in static.append_backward(loss)]
    scope = static.Scope()
    static.Executor("cpu").run(startup, scope=scope)
    start = scope_to_numpy(scope)

    def run(x, lens):
        return tuple(static.Executor(x.device).run(
            main, feed={"x": x.detach(), "len": lens},
            fetch_list=[loss] + outs + grads,
            scope=scope_from_numpy(start, x.device), return_numpy=False))
    return run


def sequence_sweep_cases(seed=22):
    """(b)'s sweep: every function and layer of this phase's slice (the
    sparse embedding and the selected-rows functions, `PyLayer` and
    `grad`, the sequence ops, the segment pools, the loss and metric
    long tail, the static sequence program) once each at the CPU tests'
    sizes, as phase 21's `layer_sweep_cases`."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.autograd import PyLayer
    from paddle_tpu_torch.core.indexed_slices import indexed_slices
    from paddle_tpu_torch.nn import functional as F

    r = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)

    class Exp(PyLayer):
        @staticmethod
        def forward(ctx, v):
            y = torch.exp(v)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            y, = ctx.saved_tensor()
            return dy * y

    def f(*shape, lo=-2.0, hi=2.0):
        return r.uniform(lo, hi, shape).astype(np.float32)

    def i(*shape, hi=9):
        return r.integers(0, hi, shape)

    lens = np.array([6, 3, 1, 4])
    x3 = f(4, 6, 3) * (np.arange(6)[None, :, None] < lens[:, None, None])
    prob = np.exp(f(4, 5))
    prob = (prob / prob.sum(-1, keepdims=True)).astype(np.float32)
    tags = (i(3, 8, hi=5), i(3, 8, hi=5))

    def selected(ids, rows):
        return indexed_slices(ids, rows, (9, 3))

    def merged(ids, rows):
        m = P.merge_selected_rows(selected(ids, rows))
        return m.values(), m.indices()[0]

    return [
        ("Embedding_sparse", nn.Embedding(9, 3, sparse=True, generator=g),
         (i(4, 5),), {}),
        ("embedding_sparse", F.embedding, (i(4, 5), f(9, 3)),
         dict(padding_idx=0, sparse=True)),
        ("get_tensor_from_selected_rows",
         lambda ids, rows: P.get_tensor_from_selected_rows(
             selected(ids, rows)), (i(6), f(6, 3)), {}),
        ("merge_selected_rows", merged, (i(6), f(6, 3)), {}),
        ("PyLayer", Exp.apply, (f(3, 4),), {}),
        ("grad_create_graph", lambda x: P.grad((x * x * x).sum(), x,
                                               create_graph=True)[0],
         (f(5),), {}),
        ("sample_logits", P.sample_logits, (f(4, 20), i(4, 2, hi=20), 6),
         dict(seed=5)),
        ("sampling_id", P.sampling_id, (prob,), dict(seed=9)),
        ("add_position_encoding", P.add_position_encoding, (f(2, 5, 6),),
         dict(alpha=0.7, beta=1.3)),
        ("im2sequence", P.im2sequence, (f(2, 3, 5, 6),),
         dict(filter_size=[2, 3], stride=1, padding=1)),
        ("row_conv", P.row_conv, (x3, f(3, 3)), {}),
        ("conv_shift", P.conv_shift, (f(3, 7), f(3, 3)), {}),
        *[(f"segment_{k}", getattr(P, f"segment_{k}"),
           (f(7, 3), np.array([0, 0, 1, 3, 3, 2, 1])), {})
          for k in ("sum", "mean", "max", "min")],
        *[(f"sequence_pool_{k}", P.sequence_pool, (x3, lens, k), {})
          for k in ("sum", "average", "sqrt", "max", "last", "first")],
        ("sequence_first_step", P.sequence_first_step, (x3, lens), {}),
        ("sequence_last_step", P.sequence_last_step, (x3, lens), {}),
        ("sequence_softmax", P.sequence_softmax, (x3, lens), {}),
        ("sequence_reverse", P.sequence_reverse, (x3, lens), {}),
        ("sequence_pad", P.sequence_pad, (f(10, 3), np.array([3, 5, 2])),
         dict(pad_value=-1.0)),
        ("sequence_unpad", P.sequence_unpad, (f(3, 5, 2),
                                              np.array([3, 5, 2])), {}),
        ("sequence_expand", P.sequence_expand, (f(3, 2), [2, 0, 3]), {}),
        ("sequence_conv", P.sequence_conv, (x3, f(12, 5), lens),
         dict(context_length=4)),
        ("sequence_concat", P.sequence_concat,
         ([f(3, 4, 2), f(3, 3, 2)], [np.array([2, 4, 0]),
                                     np.array([3, 1, 2])]), {}),
        ("sequence_enumerate", P.sequence_enumerate,
         (i(3, 6), np.array([6, 2, 4]), 3), dict(pad_value=-1)),
        ("sequence_expand_as", P.sequence_expand_as,
         (f(3, 2), np.array([2, 3, 1])), {}),
        ("sequence_reshape", P.sequence_reshape,
         (f(3, 4, 2), np.array([2, 4, 1]), 1), {}),
        ("sequence_scatter", P.sequence_scatter,
         (f(8), np.array([[1, 3, 3], [2, 0, 7]]), f(2, 3), np.array([3, 1])),
         {}),
        ("sequence_slice", P.sequence_slice,
         (f(3, 5, 2), np.array([5, 4, 5]), np.array([1, 0, 3]),
          np.array([2, 4, 3])), {}),
        ("huber_loss", P.huber_loss, (f(4, 5), f(4, 5)), dict(delta=0.5)),
        ("rank_loss", P.rank_loss, (f(4, 1, lo=0, hi=1), f(4, 1), f(4, 1)),
         {}),
        ("bpr_loss", P.bpr_loss, (f(4, 5), i(4, 1, hi=5)), {}),
        ("modified_huber_loss", P.modified_huber_loss,
         (f(6, lo=-3, hi=3), i(6, hi=2).astype(np.float32)), {}),
        ("teacher_student_sigmoid_loss", P.teacher_student_sigmoid_loss,
         (f(8, lo=-20, hi=20), np.array([-2.0, -1.5, -0.5, -0.2, 0.3, 0.9,
                                         1.2, 1.9], np.float32)), {}),
        ("center_loss", P.center_loss, (f(4, 5), np.array([0, 2, 0, 1]),
                                        f(3, 5)), dict(alpha=0.3)),
        ("squared_l2_distance", P.squared_l2_distance, (f(3, 2, 4),
                                                        f(3, 2, 4)), {}),
        ("squared_l2_norm", P.squared_l2_norm, (f(4, 5),), {}),
        ("l1_norm", P.l1_norm, (f(4, 5),), {}),
        ("clip_by_norm", P.clip_by_norm, (f(4, 5), 1.0), {}),
        ("mean_iou", P.mean_iou, (i(20, hi=4), i(20, hi=4), 4), {}),
        ("edit_distance", P.edit_distance, (i(3, 6, hi=4), i(3, 5, hi=4)),
         dict(input_length=np.array([6, 3, 0]),
              label_length=np.array([5, 4, 2]))),
        ("ctc_align", P.ctc_align, (np.array([[1, 1, 0, 2, 2, 0, 3],
                                              [0, 4, 4, 4, 0, 0, 4]]),), {}),
        ("positive_negative_pair", P.positive_negative_pair,
         (f(6), f(6), np.array([0, 0, 0, 1, 1, 1])), {}),
        ("chunk_eval", P.chunk_eval, tags,
         dict(chunk_scheme="IOB", num_chunk_types=2,
              seq_length=np.array([8, 6, 7]))),
        ("static_sequence_program", static_sequence_case(*x3.shape),
         (x3, lens), {}),
    ]


def phase_sparse_table():
    """(c): LARGE_TABLE's sparse Embedding with lazy Adam on the card.
    After a first step (Adam's state made), a second backward and step
    may raise the peak allocated memory by SPARSE_RISE at most above the
    bytes held before it; every row outside the step's ids stays
    bitwise, and the touched rows equal a dense Adam step on those rows
    within 1e-6."""
    from paddle_tpu_torch import nn, optimizer

    c = LARGE_TABLE
    t0 = time.perf_counter()
    emb = nn.Embedding(c["rows"], c["dim"], sparse=True,
                       generator=torch.Generator().manual_seed(0)).cuda()
    opt = optimizer.Adam(learning_rate=c["lr"], parameters=emb.parameters())
    rng = np.random.default_rng(23)
    first, second = (torch.from_numpy(rng.integers(
        0, c["rows"], (c["batch"], c["seq"]))).cuda() for _ in range(2))

    def loss_of(ids):
        out = emb(ids)
        return (out * out).mean()

    loss_of(first).backward()
    opt.step()
    opt.clear_grad()
    st = opt._states[id(emb.weight)]
    touched = torch.unique(second)
    before = (emb.weight.detach()[touched].clone(),
              {k: st[k][touched].clone() for k in ("moment1", "moment2")},
              st["beta1_pow"].clone(), st["beta2_pow"].clone())
    snapshot = emb.weight.detach().clone()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    loss_of(second).backward()
    grad = emb.weight.grad
    nnz = grad._values().shape[0]
    opt.step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    rise = torch.cuda.max_memory_allocated() - held
    moved = torch.nonzero((emb.weight.detach() != snapshot).any(dim=1))[:, 0]
    outside = int((~torch.isin(moved, touched)).sum())
    merged = grad.coalesce()
    want, _ = optimizer.Adam(learning_rate=c["lr"]).update(
        before[0], merged.values(), {**before[1], "beta1_pow": before[2],
                                     "beta2_pow": before[3]}, c["lr"])
    row_err = float((emb.weight.detach()[merged.indices()[0]] - want).abs()
                    .max())
    dense_mb = c["rows"] * c["dim"] * 4 / 2**20
    log(f"  {c['rows']:,} x {c['dim']} fp32 table ({snapshot.numel() * 4 / 1e9:.2f} "
        f"GB), lazy Adam, {c['batch']} x {c['seq']} ids a step: the second "
        f"backward and step raised the peak {rise / 2**20:.2f} MiB above "
        f"the {held / 2**30:.2f} GiB held (bound {SPARSE_RISE / 2**20:.0f} "
        f"MiB; a dense gradient alone {dense_mb:.0f} MiB); the gradient "
        f"{nnz} rows; {moved.numel()} rows moved, {outside} outside the "
        f"step's {touched.numel()} ids; touched rows against a dense Adam "
        f"step on them {row_err:.2e}; the step {step_s * 1e3:.2f} ms "
        f"({time.perf_counter() - t0:.1f} s)")
    if rise > SPARSE_RISE:
        fail(f"sparse table: the step raised the peak {rise} bytes, past "
             f"{SPARSE_RISE}")
    if outside or moved.numel() == 0:
        fail(f"sparse table: {outside} rows outside the step's ids moved "
             f"({moved.numel()} moved)")
    if row_err > 1e-6:
        fail(f"sparse table: touched rows {row_err} from a dense Adam step")
    del emb, opt, st, snapshot, grad, merged
    torch.cuda.empty_cache()
    return dict(rise=rise, held=held, nnz=nnz, step_ms=step_s * 1e3)


def phase_sequence_run():
    """(d): convolution_net at the chapter's sizes alone on the card, timed
    as phase 19's models are (`timed_steps`), with the sparse embedding
    and then with a dense one."""
    c = CONV_NET
    n = BOOK["warmup"] + BOOK["iters"] + BOOK["profiled"]
    out = {}
    for sparse in (True, False):
        rng = np.random.default_rng(24)
        model = conv_build(sparse=sparse).to("cuda")
        batches = iter([[torch.from_numpy(a).cuda() for a in sentiment_batch(
            rng, c["batch"], c["seq"], c["vocab"], c["min_len"])]
            for _ in range(n)])
        out[sparse] = timed_steps(
            f"convolution_net (B {c['batch']}, T {c['seq']}, "
            f"{'sparse' if sparse else 'dense'} embedding)",
            eager_step(model, batches, c["lr"], conv_adagrad))
        del model, batches
    torch.cuda.empty_cache()
    return out


def sequence_numbers(card, run):
    """(d)'s numbers: ms a step and samples/s, sparse and dense, with the
    idle share, kernels a step and peak memory of each."""
    c = CONV_NET
    ms = {}
    for sparse, r in run.items():
        what = (f"convolution_net, {'sparse' if sparse else 'dense'} "
                f"embedding")
        ms[sparse] = r["wall"] / r["iters"] * 1e3
        log(f"  [{card}] {what} (B {c['batch']}, T {c['seq']}, Adagrad): "
            f"{ms[sparse]:.2f} ms per step over {r['iters']} steps, "
            f"{c['batch'] / ms[sparse] * 1e3:.1f} samples/s; peak memory "
            f"{r['peak'] / 2**30:.3f} GiB above the steps' start; "
            f"{r['kernels']:.0f} kernels a step")
        book_idle(card, what, r)
    log(f"  [{card}] convolution_net sparse / dense ms a step: "
        f"{ms[True] / ms[False]:.3f} (this call)")
    return ms


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    from paddle_tpu_torch import generation as pgen
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    current = ["phase 1", t_start]

    def phase(title):
        """Print the wall seconds of the phase that ends here, then start
        the one titled `title` (None: the last one ended)."""
        now = time.perf_counter()
        log(f"  ({current[0]}: {now - current[1]:.1f} s wall)")
        current[:] = [title.split(":")[0] if title else None, now]
        if title:
            log(title)

    card = card_line()
    log(f"phase 1: environment\n  card: {card}  "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)})")
    t0 = time.perf_counter()
    lib_names = list(dict.fromkeys(k["lib"] for k in KERNELS + FLASH_KERNELS))
    libs = _build.build_all(lib_names)
    log(f"  built {', '.join(lib.name for lib in libs)} with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in lib_names:
        for line in _build.build_logs.get(name, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"    ptxas {name}: {line.strip()}")
    check_paged_spills(_build)
    check_tensor_cores(_build, libs[lib_names.index("flash_attention")])

    rng = np.random.default_rng(0)
    phase("phase 2: kernels against their plain versions")
    max_err = phase_kernels(pa, rng)
    max_err.update(phase_flash(fa, rng))

    phase("phase 3: engine at GPT-2-small width on the card")
    t0 = time.perf_counter()
    model = pgen.TinyCausalLM(**MODEL)
    log(f"  model built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"parameters)")
    prompts = traffic(np.random.default_rng(1))
    torch.cuda.reset_peak_memory_stats()
    gpu = run_engine(pgen, model, prompts, "cuda")
    n_tok = sum(len(r.token_ids) for r in gpu["results"])
    for i, r in enumerate(gpu["results"]):
        if r.finish_reason != "length" or len(r.token_ids) != MAX_NEW:
            fail(f"request {i} finished {r.finish_reason!r} with "
                 f"{len(r.token_ids)} tokens, want {MAX_NEW}")
    want = MODEL["num_layers"] * gpu["steps"]
    log(f"  {N_REQUESTS} requests (prompts {len(prompts[0])}.."
        f"{len(prompts[-1])} tokens) -> {n_tok} tokens in "
        f"{gpu['steps']} ragged steps, {gpu['wall']:.3f} s; kernel "
        f"launches {gpu['launches']} (num_layers x steps = {want}); "
        f"kernel path {gpu['stats']['generation.kernel_path']}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if gpu["launches"] != want or gpu["launches"] == 0:
        fail(f"ragged kernel launched {gpu['launches']} times, want {want}")

    phase(f"phase 4: the same engine on the card and on the CPU (plain "
          f"versions) at {HELD_LAYERS} layers")
    held = held_models(pgen)
    gpu_held = run_engine(pgen, held[0], prompts, "cuda")
    want = HELD_LAYERS * gpu_held["steps"]
    log(f"  {HELD_LAYERS} layers on the card: {gpu_held['steps']} ragged "
        f"steps, kernel launches {gpu_held['launches']} (num_layers x steps "
        f"= {want})")
    if gpu_held["launches"] != want or want == 0:
        fail(f"ragged kernel launched {gpu_held['launches']} times at "
             f"{HELD_LAYERS} layers, want {want}")
    cpu = run_engine(pgen, held[1], prompts, "cpu")
    if any(cpu["all_launches"].values()):
        fail("the CPU engine launched a CUDA kernel")
    worst_logit = hold_ragged(f"card vs CPU, {HELD_LAYERS} layers",
                              gpu_held, cpu, prompts)

    phase("phase 5: the legacy step at GPT-2-small width (fused decode, "
          "chunked prefill of 64), card then CPU; then one-shot prefill")
    cpu_model = pgen.TinyCausalLM.from_numpy_params(
        model.decode_params("cpu"), num_heads=MODEL["num_heads"],
        seed=MODEL["seed"], device="cpu")
    legacy, one_shot = phase_legacy(pgen, model, cpu_model, prompts,
                                    gpu)

    phase("phase 6: int8 KV pools at GPT-2-small width (ragged card, "
          "ragged CPU, legacy card)")
    q_ragged, q_legacy = phase_int8(pgen, model, cpu_model, prompts, gpu,
                                    held)

    phase("phase 7: speculation (ngram, K=4) and the host-free decode loop "
          "(N=4; N=8 float32 spec on) at GPT-2-small width, float32 and "
          "int8 pools")
    serving = phase_serving(pgen, model, cpu_model, prompts, gpu, held)
    phase_sampler(pgen)

    phase("phase 8: training at GPT-2-small width (bench_gpt_zero's "
          "configuration, bf16 amp, AdamW)")
    log("  held check: the card's first two steps against the CPU's "
        "(plain versions)")
    phase_training_held()
    log("  the bench's run on the card")
    train = phase_training_run()

    phase("phase 9: encoder pretraining at BERT-base and ERNIE-base width "
          "(bench_bert's configuration, bf16 amp, AdamW)")
    log("  held check: the card's first three scheduled steps against the "
        "CPU's")
    phase_encoder_held()
    log("  the bench's run on the card")
    encoder = phase_encoder_run()

    phase("phase 10: static ResNet-50 (bench_resnet's configuration, "
          "Program/Executor, static bf16 AMP, Momentum)")
    log("  held check: the card's first three steps against the CPU's, "
        "fp32 and AMP, B=2")
    phase_resnet_held()
    log("  the bench's run on the card")
    resnet = phase_resnet_run()

    phase("phase 11: dygraph vision (bench_lenet's configuration: LeNet, "
          "Adam, eager step; ResNet-50, VGG-11, MobileNet V1/V2)")
    reset_launches()
    log("  held checks: LeNet card vs CPU over three steps; ResNet-50 at "
        "B=2, 224x224, eval and one train step; VGG-11 and MobileNet V1/V2 "
        "eval")
    phase_vision_held()
    log("  the bench's run on the card")
    vision = phase_vision_run()
    launches = read_launches()
    log(f"  kernel launches over phase 11: {launches}")
    if any(launches.values()):
        fail(f"the dygraph vision path launched a kernel of the port: "
             f"{launches}")

    phase("phase 12: prefix caching at GPT-2-small width (ragged, legacy "
          "and one-shot paths; float32 and int8 pools; speculation and the "
          "loop; page export and import)")
    prefix = phase_prefix(pgen, model, cpu_model)

    phase("phase 13: the serving fleet at GPT-2-small width (in-process, "
          "proc and tcp replicas; live and cold drains; P/D handoff; the "
          "loop beside a sibling; the supervisor; int8 beside float32)")
    fleet = phase_fleet(pgen, model, cpu_model, prompts)

    phase("phase 14: numbers")
    numbers = paged_numbers(pa, card, torch.float32, "")
    numbers.update(paged_numbers(pa, card, torch.int8, "_int8"))
    paged_numbers(pa, card, torch.bfloat16, "_bf16")  # printed only
    for kv_dtype in (torch.float32, torch.int8):
        paged_scaling(pa, card, kv_dtype)
    log(f"  [{card}] library call: none for the paged kernels — no single "
        f"PyTorch call reads a paged KV cache through page tables")
    write_numbers(card)
    numbers.update(flash_numbers(fa, card))
    for label, run in (("ragged engine", gpu), ("legacy engine", legacy),
                       ("one-shot engine", one_shot),
                       ("int8 ragged engine", q_ragged),
                       ("int8 legacy engine", q_legacy)):
        toks = sum(len(r.token_ids) for r in run["results"])
        ttft = run["ttft"]
        log(f"  [{card}] {label}: {toks / run['wall']:.1f} tokens/s over "
            f"{run['steps']} steps ({run['wall'] / run['steps'] * 1e3:.2f} "
            f"ms per step); time to first token (all submitted at once): "
            f"median {ttft[len(ttft) // 2] * 1e3:.1f} ms, max "
            f"{ttft[-1] * 1e3:.1f} ms")
    log(f"  ragged prefill {sum(len(p) for p in prompts)} tokens; "
        f"first-token logits card vs CPU max|diff| {worst_logit:.3e}")
    ragged_shape_numbers(pa, card)
    serving_numbers(card, serving)
    prefix_numbers(card, prefix)
    fleet_numbers(card, fleet)
    for label, settings in (("ragged", None), ("legacy", LEGACY),
                            ("int8 ragged", INT8),
                            ("int8 legacy", {**LEGACY, **INT8})):
        wall, busy, top = profile_engine(pgen, model, prompts, settings)
        if busy > 0:
            log(f"  [{card}] {label} under torch.profiler: wall "
                f"{wall:.3f} s, kernels busy {busy:.3f} s on the device, "
                f"idle share {1 - busy / wall:.1%}")
            for key, (us, count) in top:
                log(f"    {us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
        else:
            log(f"  [{card}] {label}: torch.profiler recorded no device "
                f"time: device idle share not measured")
    step_ms = train["wall"] / train["iters"] * 1e3
    # bench.py's analytic model flops of a step: 3 x (2 N tokens + 4
    # tokens L h layers), forward plus a backward of twice its cost
    m = TRAIN_MODEL
    flops = 3 * (2 * train["n_params"] * train["tokens"]
                 + 4 * train["tokens"] * TRAIN["seq"] * m["hidden_size"]
                 * m["num_layers"])
    rate = flops / (step_ms * 1e-3)
    log(f"  [{card}] trainer (GPT-2 small, {train['n_params'] / 1e6:.1f} M "
        f"parameters, B={TRAIN['batch']}, L={TRAIN['seq']}, bf16 amp, "
        f"flash attention, dropout {TRAIN['dropout']}): "
        f"{train['tokens'] / step_ms * 1e3:.1f} tokens/s, {step_ms:.2f} ms "
        f"per step over {train['iters']} steps; peak memory "
        f"{train['peak'] / 2**30:.2f} GiB; {flops / 1e12:.3f} TFLOP of "
        f"model flops per step (bench.py's formula) -> "
        f"{rate / 1e12:.1f} TFLOP/s = {rate / FP32_FLOPS_PER_S:.1%} of the "
        f"fp32 CUDA-core peak")
    if train["busy"] > 0:
        busy_ms = train["busy"] / TRAIN["profiled"] * 1e3
        log(f"  [{card}] trainer under torch.profiler "
            f"({TRAIN['profiled']} steps): wall "
            f"{train['p_wall']:.3f} s, kernels busy {train['busy']:.3f} s "
            f"on the device, idle share "
            f"{1 - train['busy'] / train['p_wall']:.1%}; kernel time per "
            f"step {busy_ms:.2f} ms = {busy_ms / step_ms:.1%} of the "
            f"unprofiled step")
        for key, (us, count) in train["top"]:
            log(f"    {us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
    else:
        log(f"  [{card}] trainer: torch.profiler recorded no device time: "
            f"device idle share not measured")
    encoder_numbers(card, encoder)
    resnet_numbers(card, resnet)
    vision_numbers(card, vision, resnet)

    phase("phase 15: tensor parallel at GPT-2-small width (tp 2 and 4, "
          "every shard on one card: the paged kernels per shard; ragged, "
          "legacy, int8, quantized collectives, spec + loop; card vs CPU)")
    tp_out = phase_tp(pgen, pa, model, cpu_model, prompts, held,
                      {"ragged": gpu, "legacy": legacy, "int8": q_ragged,
                       "int8_legacy": q_legacy})
    tp_numbers(pgen, model, prompts, card, tp_out)
    for name, err in tp_out["kernel_err"].items():
        max_err[name] = max(max_err[name], err)

    phase("phase 16: data parallel, ZeRO and the pipeline at GPT-2-small "
          "width (bench_gpt_zero's step over {\"data\": 4} at ZeRO 0-3; "
          "{\"pipe\": 2, \"data\": 2}, 4 micro-batches), every shard on "
          "card 0")
    log("  held checks at dropout 0, 2 layers")
    phase_dp_held()
    base = dp_base()
    log("  (a) the bench over {\"data\": 4}")
    dp_out = phase_dp_run(base)
    log("  (b) the pipeline")
    pipe_out = phase_pipe_run(base)
    log("  (d) across cards")
    phase_dp_cross_card(base)
    del base
    torch.cuda.empty_cache()
    dp_numbers(card, dp_out, pipe_out)

    phase("phase 17: tensor-, context- and expert-parallel training at "
          "GPT-2-small width ({\"data\": 2, \"model\": 2, \"seq\": 2} "
          "ring and Ulysses, {\"data\": 2, \"model\": 2, \"expert\": "
          "2} MoE, {\"pipe\": 2, \"model\": 2}), every shard on card 0")
    log(f"  (c) this call sees {torch.cuda.device_count()} card(s); no run "
        f"across cards")
    log(f"  (a) held checks at dropout 0, {HELD_LAYERS} layers, fp32")
    for name, err in phase_hybrid_held(fa, rng).items():
        max_err[name] = max(max_err[name], err)
    log("  (b) timed at 12 layers, every shard on card 0")
    hybrid_out = phase_hybrid_run()
    hybrid_numbers(card, hybrid_out)

    phase("phase 18: dygraph AMP and the high-level surface (GPT eager "
          "O1 auto_cast + GradScaler on the bf16 flash kernels, hapi "
          "Model.fit over a 2-worker DataLoader, BERT-base eager AMP)")
    log(f"  (a) held checks: GPT at full width, {HELD_LAYERS} layers, card "
        f"vs CPU; the bf16 flash kernels at this path's shapes; hapi LeNet")
    for name, err in phase_dygraph_held(fa, rng).items():
        max_err[name] = max(max_err[name], err)
    phase_hapi_held()
    log("  (b) timed at 12 layers on the card")
    dygraph_out = phase_dygraph_run()
    dygraph_numbers(card, dygraph_out)
    bf16_numbers = flash_numbers(fa, card, torch.bfloat16)

    phase("phase 19: recurrent nets and beam-search decoding (the book's "
          "sentiment LSTM and GRU translation model, eager Adam; "
          "BeamSearchDecoder + dynamic_decode)")
    reset_launches()
    log("  (a) held checks at full width, batch and length cut, card vs "
        "CPU")
    phase_book_held()
    if any(read_launches().values()):
        fail(f"the held checks launched a kernel of the port: "
             f"{read_launches()}")
    log("  (b) the chapters' sizes on the card")
    book = phase_book_run()
    book_numbers(card, book)
    log(f"  phase 19 launched none of the six kernels of the port: "
        f"{read_launches()}")

    phase("phase 20: the rest of the Paddle book (fit_a_line, "
          "recognize_digits, word2vec with NCE, semantic roles with the "
          "CRF, the recommender, the StaticRNN encoder-decoder, "
          "image classification with static dropout)")
    reset_launches()
    log("  (a) held checks at the chapters' widths, batch and length cut, "
        "dropout 0, card vs CPU")
    phase_chapters_held()
    if any(read_launches().values()):
        fail(f"the held checks launched a kernel of the port: "
             f"{read_launches()}")
    log("  (b) the chapters' sizes on the card")
    chapters = phase_chapters_run()
    chapter_numbers(card, chapters)
    log(f"  phase 20 launched none of the six kernels of the port: "
        f"{read_launches()}")

    phase("phase 21: the convolution, norm, resampling and pooling layers "
          "(CycleGAN at its published widths; every ported function and "
          "layer card vs CPU)")
    reset_launches()
    log("  (a) CycleGAN's first iteration at full width, card vs CPU")
    phase_cyclegan_held()
    log("  (b) every ported function and layer, forward and backward")
    phase_layer_sweep()
    if any(read_launches().values()):
        fail(f"the held checks launched a kernel of the port: "
             f"{read_launches()}")
    log("  (a) CycleGAN alone on the card, cuDNN on")
    cyclegan_numbers(card, phase_cyclegan_run())
    log(f"  phase 21 launched none of the six kernels of the port: "
        f"{read_launches()}")
    phase("phase 22: the sequence library, sparse embeddings and autograd "
          "(chapter 06's convolution_net with sparse Adagrad; every "
          "function of the slice card vs CPU; a 2,000,000-row sparse "
          "table)")
    reset_launches()
    log("  (a) convolution_net at full width, batch and length cut, card "
        "vs CPU")
    phase_sequence_held()
    log("  (b) every function and layer of the slice, forward and backward")
    phase_layer_sweep(sequence_sweep_cases())
    log("  (c) a sparse table with lazy Adam")
    phase_sparse_table()
    if any(read_launches().values()):
        fail(f"the held checks launched a kernel of the port: "
             f"{read_launches()}")
    log("  (d) the chapter's sizes on the card, sparse then dense embedding")
    sequence_numbers(card, phase_sequence_run())
    log(f"  phase 22 launched none of the six kernels of the port: "
        f"{read_launches()}")
    phase(None)
    log(f"  whole run {time.perf_counter() - t_start:.1f} s wall")
    launches = {"ragged_paged_attention": gpu["launches"],
                "ragged_paged_attention_int8": q_ragged["launches"],
                **{name + tag: run["launches"][name + tag]
                   for tag, run in (("", legacy), ("_int8", q_legacy))
                   for name in ("paged_decode_attention",
                                "chunk_prefill_attention")},
                **{k["name"]: train["launches"][k["name"]]
                   for k in FLASH_KERNELS}}
    # each paged kernel's launches per shard on phase 15's main-path mesh
    # runs (tp TP_MAIN): the ragged kernel's float32 and int8 ragged runs,
    # the decode and chunk kernels' float32 and int8 legacy runs
    per_shard = {
        "ragged_paged_attention": tp_out["runs"][TP_MAIN]["launches"],
        "ragged_paged_attention_int8": tp_out["int8"]["launches"],
        **{name + tag: tp_out[run]["launches"][name + tag]
           for run, tag in (("legacy", ""), ("int8_legacy", "_int8"))
           for name in ("paged_decode_attention",
                        "chunk_prefill_attention")}}
    mesh_keys = {name: {"mesh": {"tp": TP_MAIN,
                                 "launches_per_shard": n // TP_MAIN}}
                 for name, n in per_shard.items()}
    # each flash kernel's launches per step on phase 16's main paths: the
    # bench over {"data": 4} at ZeRO 3, the pipeline with remat (the
    # JAX pipeline's default)
    for k in FLASH_KERNELS:
        mesh_keys[k["name"]] = {
            "data_parallel": {"dp": DP["dp"], "stage": 3,
                              "launches_per_step":
                                  dp_out[3]["launches"][k["name"]]},
            "pipeline": {"S": DP["pipe"], "dp": DP["pipe_dp"],
                         "M": DP["micro"], "remat": True,
                         "launches_per_step":
                             pipe_out[True]["launches"][k["name"]]}}
    # and on phase 17's: the seq mesh under Ulysses (ring: 0, composite
    # attention as in JAX) and the MoE mesh
    for k in FLASH_KERNELS:
        mesh_keys[k["name"]]["hybrid"] = {
            label: {"mesh": run["shape"], "stage": run["stage"],
                    **({"cp_mode": run["cp_mode"]} if run["cp_mode"]
                       else {"experts": run["experts"]}),
                    "launches_per_step": run["launches"][k["name"]]}
            for label, run in hybrid_out.items()}
    # and on phase 18's eager O1 AMP step: the bf16 instantiations
    for k in FLASH_KERNELS:
        mesh_keys[k["name"]]["dygraph_amp"] = {
            "dtype": "bfloat16",
            "launches_per_step": dygraph_out["amp"]["per_step"][k["name"]],
            **dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms"), bf16_numbers[k["name"]]))}
    print(json.dumps({"kernels": [{
        "name": k["name"], "route": "cuda",
        "source": f"paddle_tpu_torch/csrc/{k['lib']}.cu",
        "replaces": k["replaces"], "launches": launches[k["name"]],
        "max_abs_err": max_err[k["name"]], "ms": numbers[k["name"]][0],
        "plain_ms": numbers[k["name"]][1],
        "bound_ms": numbers[k["name"]][2],
        "bound_by": numbers[k["name"]][3],
        "library_ms": numbers[k["name"]][4],
        **mesh_keys.get(k["name"], {})}
        for k in KERNELS + FLASH_KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
