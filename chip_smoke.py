#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel of the main path from deepv_tpu_torch/csrc
     with nvcc for sm_90a, one nvcc per source, all started together, and
     prints the build times and ptxas reports;
  3. attention kernel (K1) against its plain PyTorch version on the card:
     first a one-hot P check (each token its own valid group, so the bf16
     output must equal V exactly), then the rollout's packed layouts of
     pyramid stages 0, 1 and 2 with 2 CFG rows (chunk 1) and 3 rows plus
     history (chunk 2), then edge layouts that reach every branch of the
     kernel's mask schedule (S < 64, mask-free, per-token valid, time-skipped
     tiles mid-sequence); f32 at atol 2e-5 / rtol 1e-4, bf16 at atol 3e-2 /
     rtol 3e-2 and within 2e-3 plus 2^-8 of the value of an f32 evaluation
     of the same inputs. At the rollout's layouts it times the kernel, the
     plain version and SDPA with the same boolean mask (a yardstick the port
     never calls), beside the least time the card needs, counts the tile
     classes, and sums K1, SDPA and the bound over the rollout's launches;
     at each of those layouts it also times the f32 kernel (attn_fwd_tf32x3,
     what f32 training runs) beside SDPA in f32, back to back and as
     device time (the call replayed from a CUDA graph beside the sum of
     SDPA's kernels), beside the bound at the 3xTF32 rate (495 TF/s / 3,
     the least time) and at the f32 FMA rate;
  4. igemm conv kernel (K2) against its plain PyTorch version at every
     eligible 3x3x3 conv shape of the full-width VAE, in the causal mode the
     rollout uses there, 1-2 output frames, at the channels-last input the
     rollout hands the cl path, and at three edge shapes (w not a
     multiple of 64; w % 8 != 0, the cl path through a channels-last copy;
     batch 2 with 3 frames), checking which kernel ran: f32 at atol 2e-4 /
     rtol 1e-4 (tests/test_conv_igemm.py:33), bf16 within one bf16 ulp of
     the larger value plus that 2e-4 (the two sum the same exact products
     in f32 in other orders, then round once); f32 runs split_tf32_cl (its
     planes of x and of the weight equal the plain split's bit for bit)
     and conv3d_igemm_tf32x3. Times the wrapper (as device time, from a
     CUDA graph), its layout work alone (the weight re-layout; for f32 the
     two splits), for f32 the conv kernel alone and the split of x, the
     plain version and F.conv3d (cuDNN with TF32 off, a yardstick the
     igemm path never calls), beside the least time (f32: at the 3xTF32
     rate, with the FMA rate's beside it). After phase 7 it prints K2,
     cuDNN and the bound summed over the igemm rollout's convs by class.
     Then K2 at batch 2 (rgb and disparity, as the batched decode of phase
     24 runs it) at every eligible decoder class in bf16, in init and cont
     mode and, for the last up block's convs, prime: phase 4's tolerance,
     the kernel that ran, whether the second stream alone gives the same
     bits (printed), and its time;
  5. main path: run.load_pipeline with random weights at full width
     (MMDiTConfig(): 24 layers, d=1536; VAEConfig()) in bf16, and generate()
     on an 11-action prompt at 384x512 (2 chunks, 89 frames, 12 units:
     history CFG, boundary priming, carry re-encode). The kernels' launch
     counts are set to 0 just before and read just after: K1 launches 4,320
     times (its bf16 kernel; the per-layout launches of phase 3 add up to
     it), its f32 kernel and K2 never (the default conv is F.conv3d). An
     on_frames hook sees 12 windows (chunk 1: 1 frame, then 7 x 8; chunk 2:
     4 x 8) that concatenate to the output bit for bit, and times the first
     window from the call of generate(), synchronised in the callback. The
     test image holds float16 values, so phase 13 can send it on the wire;
  6. forward check: one full-width denoise forward at the stage-2, 3-row
     layout in f32 with K1's f32 kernel (attn_fwd_tf32x3, 24 launches)
     against the same forward with the plain attention;
  7. igemm path: the same rollout through InferencePipeline with
     VAEConfig(conv_impl="igemm") and the same weights, image, prompt and
     seed; counts set to 0 just before and read just after: K1 4,320 and K2
     (its wgmma and cl paths together; its f32 kernels never) exactly the
     count the phase counts imply, the cl path once per full-mode encoder
     call (the mid block hands its resnet x channels-last: 3);
  8. decode check: one latent stream decoded at full width through an init
     window, a cont window and a primed cont window, with "igemm" and with
     "xla": f32 (TF32 off) within 1e-4 relative L2, bf16 within twice the
     relative L2 between the bf16 and f32 "xla" decodes of the same latents.
     K2's counts are set to 0 just before the f32 "igemm" decode and read
     just after: conv3d_igemm_tf32x3 once per eligible conv (3 windows of
     34 and a priming warm of 3 x 28 + 6: 192), split_tf32_cl twice that,
     the bf16 paths never;
  9. K3, the int8 conv, against its plain version at every int8-eligible
     conv class of the fast rollout (the 384x512 level: 3->128, 128->128,
     256->128, 256->512, 128->3), in each causal mode the rollout runs it
     in (and conv_in also at the rollout's longest call, 17 output frames),
     at edge cases (batch 2, w = 80; float32 with w % 8 != 0; co = 3
     with batch 2; 3 -> 3) and at a ties case (amax 127, halves that round
     half to even): the quantise kernel's x8 and sx byte-equal to the plain
     quantise step's, the conv kernel's int32 accumulators exactly equal
     (the sum is exact), the bf16 output within one bf16 ulp of the plain
     version's (the f32 output equal). Checks the route ops/conv_int8.plan
     took (wgmma, or packed for ci <= 16: conv_in, 3 -> 3), and times the
     whole call, its quantise step (the amax and the quantise kernel), each
     kernel alone, the plain version and F.conv3d in bf16 (cuDNN, a
     yardstick: torch has no int8 3D conv), beside the least times at the
     int8 peak or the memory rate, and the TOPS. At conv_in's 2-frame init
     case it also times conv_in's work on the wgmma kernel (128 -> 128 with the
     input and weight channels past the third zero; its sums must equal
     the packed kernel's). Then K3 at batch 2 at every int8-eligible
     decoder class in init and cont mode and, for the last up block's
     convs, prime, the second stream at 3x the first's amplitude: one sx
     for the batch (the amax of both, above the first stream's own), x8 and
     sx byte-equal to the plain quantise step's, the int32 sums exact, bf16
     within one ulp, the route and launches as above;
 10. int8 linear: int_mm at shapes torch._int_mm refuses (16 rows; k, n not
     multiples of 8), zero-padded, and torch._int_mm at the stage-2 shapes,
     each exact against an f64 product; the W8A8 call, its quantise,
     product and dequant parts timed beside bf16 F.linear;
 11. fast path: run.load_pipeline(fast=True) (flow caching "skip_odd", the
     int8 block linears, VAEConfig(conv_impl="int8")) on phase 5's image,
     prompt, seed and weights; counts set to 0 just before and read just
     after: K1 2,592 (108 forwards x 24 blocks), K2 0, K3's conv kernels
     247 together (once per dispatch to the int8 conv, which a spy counts:
     the packed kernel once per conv_in call, wgmma for the rest), its
     quantise kernel 247, _int_mm once per
     quantised linear of every forward; 89 finite frames, and the gap to
     phase 5's frames in 8-bit units (printed, not gated: random weights
     amplify deviations). Then the same preset served: an InteractiveSession
     on this pipeline stepped through the 12 actions in this thread, counts
     set to 0 just before and read just after: its frames equal the
     rollout's bit for bit, its recompute decisions ran 108 forwards, K1
     24 x those, K3's conv and quantise kernels once per int8 dispatch
     (the rollout's 247 plus step 12's opening of chunk 3; the packed
     kernel once per conv_in call), _int_mm once
     per quantised linear of every forward;
 12. adaptive + boundary path: InferencePipeline(flow_cache="adaptive:0.5",
     reuse_decoder_cache=True, carry_latents=True), same inputs; K1 24 x the
     forwards the pipeline records as run, no priming, 89 finite frames;
 13. serving: serve.prewarm (K1's launches in it counted, for phase 23),
     then serve.SessionServer on 127.0.0.1 over a
     load_pipeline with phase 5's weights; POST /session with phase 5's
     image and seed, one POST /step per unit of the prompt (12), POST
     /close. Counts set to 0 just before the session and read just after
     its last step: K1 4,320, its f32 kernel, K2 and K3 never. chunk_complete
     at steps 8 and 12 only, 89 frames, which equal phase 5's rgb and
     disparity cast to float16 bit for bit. A GET /metrics from a second
     thread while step 8 (the chunk boundary) holds the device lock answers
     in under 1 s. The peak device memory stays within 1 GiB of phase
     5's. Prints the prewarm seconds, the time to first frame
     (POST /session to the first /step response) and the first step, the
     step median, the boundary step, the peak device memory, and the
     server's encode and the client's decode of one 8-frame window.
 14. K1's backward (attn_bwd_delta, then attn_bwd_dkdv_* and attn_bwd_dq_*:
     bf16 attn_bwd_dkdv_wgmma and attn_bwd_dq_wgmma, TMA-fed wgmma; f32
     attn_bwd_dkdv_tf32x3 and attn_bwd_dq_tf32x3, 3xTF32 mma.sync fed by
     cp.async) and the forward's row LSE against the plain backward
     (torch.autograd.grad of attention_plain) on the card, TF32 off,
     at the training layouts of stages 0-2 (b=1, unit 7 of 8 at 384x512),
     the rollout's stage-2 2-row layout, K1's edge layouts and a ragged
     causal S=130: the forward with the LSE equal to the inference route's
     bit for bit, the LSE within 1e-4 + 1e-5 of the largest |LSE| of
     torch.logsumexp over the plain masked logits, f32 gradients at atol
     5e-5 / rtol 1e-4, bf16 gradients as accurate as the plain bf16
     backward against an f32 evaluation of the same inputs (largest
     deviation at most twice the plain version's plus 2^-9 of the largest
     value; relative L2 at most 2^-7), two backward runs bit-equal, one
     forward and one backward launch per autograd call. At the stage-2
     training layout it times the backward call, the plain backward and
     SDPA's backward with the same boolean mask (a yardstick the port never
     calls) beside the bound: the five S x S x 64 products over the
     allowed pairs at the dtype's peak, or the bytes (f32: as 3xTF32, three
     TF32 products a product at the TF32 peak, the least time; the FMA
     least time beside it), and each kernel's device ms (torch.profiler)
     beside SDPA's backward's kernels. At every layout it prints the
     kernels' grid (b*h, ceil(S/64)), the call's ms beside SDPA's backward's
     (back to back, host time included; and the call replayed from a CUDA
     graph beside the sum of SDPA's kernels' device time), and for f32 the
     largest share of the tolerance used. Then the same checks and times at
     the per-rank heads of tp 2 and 4 (12 and 6) at the training layouts of
     stages 0-2, beside the 24-head call's times;
 15. training at full width: a Trainer (pyramid objective, AdamW) on an
     MMDiTConfig() model (24 layers, d=1536) in f32 with random weights from
     seed 0 and a batch of 8 latent units at 384x512 ([1, 38, 8, 48, 64]),
     77 text tokens with a mask and pooled text. Counts set to 0 just
     before and read just after each step: one pyramid step at each stage
     (unit 7), one single-clip step (1 frame), Trainer.train for 4 steps;
     each with finite losses, a finite gradient for every parameter, a
     nonzero one for every block's to_q (the attention's gradient flows),
     K1's f32 forward (attn_fwd_tf32x3) and the backward 24 times a step.
     A trainer of the same width cut to CKPT_LAYERS layers takes one step,
     is saved and restored into a fresh Trainer on the card: params and
     AdamW state equal bit for bit. Then one bf16 stage-2 step (params cast to bf16):
     K1's wgmma forward and the bf16 backward 24 times. Prints each step's
     seconds and peak device memory, and the checkpoint's size and times.
     Before the steps it keeps phase 21 (a)'s reference: on the fresh
     weights, the loss and every leaf's gradient norm of a stage-2 step with
     phase 21's draws;
 16. checkpoint (M15a): phase 5's weights (MMDiTConfig(), VAEConfig(), bf16,
     seed 0) written as a diffusers-style snapshot (transformer/ and
     causal_video_vae/: config.json and a .safetensors file each, every
     tensor in its dtype, under diffusers' names) into a temporary
     directory of the checkout, removed at the end (free disk checked
     first); run.load_pipeline(snapshot) without random_weights: the
     configs are the defaults, every loaded tensor equals the written one
     bit for bit (pos_embed as f32 of the written bf16), no text encoder,
     random_text_embeds(0). Phase 5's rollout from it: counts set to 0 just
     before and read just after, K1 4,320, K2 never, 89 finite frames;
     prints the snapshot's GB, write and load seconds and the 8-bit gap to
     phase 5's frames (printed, not gated: only pos_embed's dtype differs);
 17. text encoders (M15b): SD3's three towers at full width (CLIP-L, bigG,
     T5-XXL; the public SD3 text_encoder*/config.json) with random bf16
     weights in HF's init distributions, written as text_encoder{,_2,_3}
     (T5's tied embed_tokens left out) and loaded by
     io/weights.load_text_towers; tokenising is replaced here only by fixed
     seeded ids, printed (SD3's tokenizer files are not in the checkout;
     the phase prints whether transformers and safetensors are importable).
     One encode in bf16: [1, 77, 4096], [1, 77], [1, 2048], finite, each
     output within relative L2 2^-4 of the same towers loaded in f32 (TF32
     off); prints one encode's ms and its device ms (torch.profiler). Then a
     2-chunk prompt_type="text" rollout of phase 5's image and seed through
     InferencePipeline(text_encoder=...) on phase 16's loaded MMDiT and VAE:
     counts set to 0 just before and read just after, K1 4,320, 89 finite
     frames, the encoder called once (the pipeline's memo); prints the peak.
 18. spatial tiling (M17a): phase 5's weights, image, prompt and seed through
     InferencePipeline(VAEConfig(conv_impl="igemm"), stream_decode=False),
     first untiled (exact boundary priming), then with use_tiling=True
     (deepv_tpu's 256-pixel tiles: the encodes on a 2 x 3 grid of 256/192 x
     256/256/128 pixels, the end-of-chunk decodes on 32/24 x 32/32/16
     latents; no priming). Counts set to 0 just before and read just after
     each: K1 4,320, K2 (wgmma and cl paths) as the tile grid and the
     windows imply, the cl path once per tile of each full-mode encode. A
     spy records every K2 shape of the tiled run; K2 is then held to its
     plain version at each distinct one (random inputs, x channels-last
     where the rollout's was) in bf16 and f32 with phase 4's tolerances.
     Prints both runs' wall time, phase seconds and peak device memory,
     the 8-bit gap between their frames (not gated: tiles see zero
     borders), and the 8-bit gap of each tiled igemm decode to a tiled
     cuDNN decode of the same latents;
 19. PLY export (M19b): io/ply.save_ply of phase 5's output on the card,
     every 8th frame (12 files) into a temporary directory of the checkout,
     removed at the end; prints the seconds and the points written. Then
     depth_edge on the card equal to the CPU's and backproject within
     2^-20 of the absolute sum of each point's terms (TF32 off) for the
     same 12 frames.
 20. multi-card inference (M17b) on this one card: (c) K1 at 12 and 6 heads
     (the per-rank heads of tp 2 and 4) at phase 3's rollout layouts,
     against its plain version with phase 3's tolerances, timed (back to
     back and as device time from a CUDA graph) beside the 24-head kernel
     at the same layout, SDPA and the bound; (e) run.main(tp_shards=2) refused,
     naming the number of cards (NCCL runs one rank per card); (a) the
     full-width model cut to MESH_DEPTH joint blocks (random weights, seed
     0, bf16), phase 5's image and seed and the first chunk of its prompt (7
     actions, 8 units: every mesh rollout of phases 20 and 22 runs this
     model and these units, to keep the gloo-bound mesh phases inside the
     time limit)
     through InferencePipeline(mesh=make_mesh((2,), ("tp",), devices=
     ["cuda:0"] * 2, backend="gloo")), two processes sharing the card
     (parallel/launch.spawn): all_reduce (sum in bf16 and f32, max),
     all_gather and broadcast checked on CUDA tensors over gloo first; then
     counts set to 0 just before generate() and read just after, on each
     rank: 57 finite frames, K1 120 x MESH_DEPTH launches all at 12 heads, its f32
     kernel and the backward never, rank 1's frames equal to rank 0's bit
     for bit; printed (not gated): each rank's wall time, phase seconds and
     peak memory, the row-split reductions (MESH_REDUCTIONS_PER_FORWARD a
     forward) and every collective's calls and bytes. Every time there
     is two ranks sharing one card over gloo, not a deployment number; (b)
     on the same two ranks in f32 (TF32 off) at full width, each
     mesh call against the single-device call on rank 0: one denoise forward
     at chunk 1's stage-2 layout (b = 2), cp_dec_window init then cont (2
     latent frames each), cp_vae_encode_chunked of a 17-frame 384x512 carry
     (window 8), and cp_vae_decode_chunked of two streams at batch 2 (2
     latent frames: decode_batched's mesh route) against vae_decode of the
     same batch, within relative L2 MESH_F32_REL_L2 and max |err|
     MESH_F32_MAX_ABS; (d) world size 1 over NCCL: one f32 forward and one
     decode window through the mesh code within (b)'s tolerance, printing
     whether each is bit-equal to the single-device call. (a) and (b) run in
     one spawn of the two ranks with phases 21 (a, c) and 22: a spawn costs
     every rank a process, a CUDA context and a weight draw.
 21. training over a mesh (M17c) on this one card, every time gloo ranks
     sharing it: (a) two ranks run MMDiTConfig() (24 layers, d=1536) in f32
     (TF32 off) on phase 15's weights and batch, one Trainer pyramid step
     at stage 2, unit 7, on each rank's tensor-parallel share; counts set
     to 0 just before the step and read just after: K1's attn_fwd_tf32x3
     and the f32 backward 24 times a rank, all at 12 heads; the loss within
     MESH_TRAIN_LOSS_RTOL of phase 15's single-device step on the same
     draws, every leaf's gradient norm (a split leaf's summed over the
     ranks) within MESH_TRAIN_NORM_RTOL of it, the replicated leaves
     bit-equal on both ranks after AdamW; (c) on the same ranks one bf16
     stage-2 step: K1's attn_fwd_wgmma and the bf16 backward 24 times a
     rank at 12 heads; (b) four ranks, dp 2 x tp 2, at full width and
     MESH_DP_TP_DEPTH layers (printed): each rank's gradients (averaged
     over dp) and parameters after AdamW against its slice of the
     single-device step of the same cut model on the global batch and the
     same draws, within MESH_GRAD_RTOL and MESH_PARAM_ATOL, and the dp
     replicas bit-equal. Prints each rank's seconds, peak memory and the
     collectives' calls and bytes. (b) then checkpoints (fault F10): the
     single-device reference step runs through a Trainer; a tp-2 Trainer of
     the same cut model takes the same step on the global batch on every
     rank (parameters within MESH_PARAM_ATOL of the reference's slices) and
     saves into one directory, global rank 0 writing one whole tree; every
     leaf has its whole shape, each rank's slices of the file equal its live
     parameters and AdamW moments bit for bit, the file's parameters are
     within MESH_PARAM_ATOL of the single-device Trainer's, and it restores
     bit for bit into fresh tp-2 Trainers and a fresh single-device one.
     Prints the checkpoint's GB, save and restore seconds; (d)
     parallel/dryrun.run_dryrun refused
     over NCCL with more ranks than cards, naming the count, and its rank
     body (what run_dryrun(4, shared_card=True) spawns) run on (b)'s four
     ranks to a finite loss, the same on every rank. (a) and (c) run in
     phase 20's spawn of the two ranks;
 22. serving and --fast over the mesh (M17c): two gloo ranks, one spawn, one
     weight draw (phase 20 (a)'s); (a) serve.SessionServer on rank 0 (a free
     port of 127.0.0.1) with serve.follow on rank 1: POST /session with
     phase 5's image and seed, one POST /step per unit of MESH_PROMPT (the
     8th closes the chunk and opens the next), GET /metrics, POST /close;
     counts set to 0 just before and read just after, on each rank: K1
     120 x MESH_DEPTH launches at 12 heads, K2, K3 and the backward never; the served
     frames equal phase 20 (a)'s mesh generate() as float16 bit for bit;
     rank 1 ran every operation; /metrics counts 8 steps; (b) the --fast
     preset on the same ranks (denoise_int8, VAEConfig(conv_impl="int8"),
     flow_cache="skip_odd"): counts read around generate(): K1 72 x
     MESH_DEPTH launches a rank at 12 heads, K3 and K2 never, int_mm 12
     a joint block and 9 in the last one a forward, as on one device,
     MESH_REDUCTIONS_PER_FORWARD int32 reductions a forward; one int8
     denoise forward on the mesh equal to one device's on the same inputs
     bit for bit; prints the served step times and the --fast wall time.
     It runs in phase 20's spawn of the two ranks, which draws phase 20
     (a)'s weights once for 20 (a) and 22.
 23. cold start with the AOT cache (M19c): two fresh child processes of
     sys.executable in turn, on one new 0o700 cache directory; each
     configures utils/aot, loads the three kernel libraries (one thread
     each), builds the full-width bf16 pipeline from random weights and runs
     serve.prewarm. The first has nvcc: aot.stats() compiled 3, loaded 0.
     The second runs with nvcc off its PATH and CUDA_HOME pointing nowhere:
     loaded 3, compiled 0, the same three entries, and K1 launched from the
     cached library at the stage-0, 2-row rollout layout within phase 3's
     tolerances of its plain version. In both K1's prewarm launches equal
     phase 13's. Prints both children's seconds from their start to the
     imports, the libraries, a ready pipeline, the first step's frames, the
     end of prewarm and their exit, side by side, with nvcc's seconds,
     aot.stats() and the card's name and power limit.
 24. batched decode: InferencePipeline(stream_decode=False,
     decode_batched=True), rgb and disparity decoded as one batch-2 VAE
     call, at full width in bf16 on phase 5's weights, image, prompt and
     seed; counts set to 0 just before and read just after each rollout,
     and a spy (DecoderSpy) sees every decoder conv at batch 2 and every
     encoder conv at batch 1. (a) phase 18's untiled igemm rollout (chunk 1
     the plain decode, chunk 2 primed once): K1 4,320, K2's decoder
     launches half of phase 18 untiled's and its encoder launches equal;
     its frames against phase 18 untiled's: chunk 1 bit-equal or within
     phase 8's bf16 rule (twice the relative L2 of a bf16 to an f32 decode),
     chunk 2 (conditioned on chunk 1's pixels) held to that rule where chunk
     1 is bit-equal, every gap printed; (d) a tiled decode (256-pixel tiles)
     of (a)'s chunk-1 latents at batch 2 against two batch-1 ones: the
     same rule, half the K2 launches; (b) phase 12's adaptive:0.5 + reuse
     + carry: K1 24 a forward run, no priming, the kept decoder caches (one
     cache at batch 2, None) after each chunk, chunk 1 against phase 12's
     within the rule (the same latents, decoded streamed at batch 1 there);
     (e) one batched init window inside utils/profiling.device_trace, whose
     Chrome trace (chiprun_out/batched_decode_trace/) must name
     conv3d_igemm_wgmma; (c) phase 11's --fast: K3's conv and quantise
     kernels once per int8 dispatch, the decoder's at batch 2, 89 finite
     frames, the 8-bit gap to phase 11 printed (not gated: one activation
     scale for both streams). Prints each run's wall time, denoise_unit,
     vae_decode and prime seconds, peak memory and the card's clock, power
     and temperature before it, beside phases 18, 12 and 11's.
Phases 5, 7, 11, 12, 13, 16, 17, 18, 20, 22 and 24 also check that the backward
never launched.
The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Extra detail goes to chiprun_out/.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PROMPT = "(FN)(FN)(FN)(FN)(FN)(FN)(FN)(fRL)(SR)(BL)(FN)"
HEIGHT, WIDTH = 384, 512
#: dense peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
SOURCES = ("attention.cu", "conv_igemm.cu", "conv_int8.cu")

#: every eligible 3x3x3 conv class of the full-width rollout (VAEConfig() at
#: 384x512): (layer, causal mode the rollout runs it in, ci, co, h, w,
#: output frames of the check)
CONV_CASES = (
    ("decoder mid block, up block 0 resnets", "init", 512, 512, 48, 64, 1),
    ("decoder mid block, up block 0 resnets", "cont", 512, 512, 48, 64, 1),
    ("decoder up block 0 spatial up-sampler", "cont", 512, 2048, 48, 64, 1),
    ("decoder up block 0 temporal up-sampler", "cont", 512, 1024, 96, 128, 1),
    ("decoder up block 1 resnets", "cont", 512, 512, 96, 128, 2),
    ("decoder up block 1 spatial up-sampler", "cont", 512, 2048, 96, 128, 2),
    ("decoder up block 1 temporal up-sampler", "cont", 512, 1024, 192, 256, 2),
    ("decoder up block 2 resnet 0 conv1", "cont", 512, 256, 192, 256, 2),
    ("decoder up block 2 resnets", "cont", 256, 256, 192, 256, 2),
    ("decoder up block 2 spatial up-sampler", "cont", 256, 1024, 192, 256, 2),
    ("decoder up block 2 temporal up-sampler", "cont", 256, 512, 384, 512, 1),
    ("decoder up block 3 resnet 0 conv1", "prime", 256, 128, 384, 512, 2),
    ("decoder up block 3 resnets", "prime", 128, 128, 384, 512, 2),
    ("decoder up block 3 resnets", "cont", 128, 128, 384, 512, 2),
    ("encoder down block 0 resnets", "full", 128, 128, 384, 512, 1),
    ("encoder down block 1 resnet 0 conv1", "full", 128, 256, 192, 256, 1),
    ("encoder down block 1 resnets", "init", 256, 256, 192, 256, 2),
    ("encoder down block 2 resnet 0 conv1", "cont", 256, 512, 96, 128, 1),
    ("encoder down block 2 resnets", "full", 512, 512, 96, 128, 2),
    ("encoder down block 3, mid block resnets", "cont", 512, 512, 48, 64, 1),
)
#: K2 cases beyond CONV_CASES: (name, mode, ci, co, h, w, output frames,
#: batch, x channels-last). The first is on the rollout's path: the
#: encoder's mid-block resnet after its attention block gets x channels-last
#: in full mode (the first image and the history frames), which the wgmma
#: path's map cannot read along w, so it runs the cl path. The rest are
#: shapes the rollout does not run but K2 must take.
CONV_EDGE_CASES = (
    ("encoder mid block resnet after attention", "full", 512, 512, 48, 64, 1, 1, True),
    ("edge: w not a multiple of 64", "cont", 128, 128, 48, 80, 2, 1, False),
    ("edge: w % 8 != 0 (cl path, channels-last copy)", "full", 128, 128, 6, 10, 1, 1, False),
    ("edge: batch 2, 3 frames", "full", 256, 256, 96, 128, 3, 2, False),
)
#: K2's launch counters: the wgmma path, the cl path, the f32 kernel
#: (tf32x3) and its split kernel (split_tf32_cl, twice a call: x, weight)
K2_COUNTERS = ("launches", "cl_launches", "f32_launches", "split_launches")
#: denoise forwards of the exact rollout: 12 units x 3 stages x 5 steps
FORWARDS = 180
#: the rollout's first chunk: the first frame and 7 units of 8 frames
CHUNK1_FRAMES = 57
#: int8 convs of the fast rollout: the dispatches to conv3d_int8 at the
#: 384x512 level that phase 11's spy counts
FAST_CONV_INT8_CALLS = 247
#: every int8-eligible conv class of the full-width fast rollout
#: (VAEConfig(conv_impl="int8") at 384x512; MIN_H = 256 leaves the top
#: spatial level only): (layer, causal mode the rollout runs it in, ci, co,
#: h, w, output frames of the check). The encoder runs full (the first image,
#: the history frames) and init/cont (a carried clip's 17- and 8-frame
#: windows); the decoder init (the first window), cont (the streamed
#: windows) and prime (the boundary's cache rebuild, which skips conv_out
#: and everything before the last up block). Up block 2's temporal
#: up-sampler runs at 384x512 after its spatial one, so it is eligible too.
#: conv_in is also checked at the rollout's longest call, the encoder's
#: 17-frame boundary clip in init mode (19 input frames); the first case of
#: a class is the one the rollout sums take.
K3_CASES = (
    ("decoder up block 3 resnets", "cont", 128, 128, 384, 512, 2),
    ("decoder up block 3 resnets", "prime", 128, 128, 384, 512, 2),
    ("decoder up block 2 temporal up-sampler", "cont", 256, 512, 384, 512, 1),
    ("decoder up block 2 temporal up-sampler", "init", 256, 512, 384, 512, 1),
    ("decoder up block 3 resnets", "init", 128, 128, 384, 512, 1),
    ("decoder up block 3 resnet 0 conv1", "cont", 256, 128, 384, 512, 2),
    ("decoder up block 3 resnet 0 conv1", "prime", 256, 128, 384, 512, 2),
    ("decoder up block 3 resnet 0 conv1", "init", 256, 128, 384, 512, 1),
    ("decoder conv_out", "cont", 128, 3, 384, 512, 2),
    ("decoder conv_out", "init", 128, 3, 384, 512, 1),
    ("encoder conv_in", "init", 3, 128, 384, 512, 2),
    ("encoder conv_in", "cont", 3, 128, 384, 512, 2),
    ("encoder conv_in", "full", 3, 128, 384, 512, 1),
    ("encoder conv_in", "init", 3, 128, 384, 512, 17),
    ("encoder down block 0 resnets", "init", 128, 128, 384, 512, 2),
    ("encoder down block 0 resnets", "cont", 128, 128, 384, 512, 2),
    ("encoder down block 0 resnets", "full", 128, 128, 384, 512, 1),
)
#: K3 beyond K3_CASES: (name, mode, ci, co, h, w, output frames, batch). The
#: first edge case takes the wgmma kernel's 128-pixel tile with a w tail and
#: a batch whose frames the causal past must not mix; the float32 one the
#: quantise kernel's scalar path (w % 8 != 0) and the f32 output, which must
#: equal the plain version's; the co = 3 one the wgmma kernel's 16-channel
#: tile on a 128-pixel CTA; 3 -> 3 the packed kernel's 16-channel tile,
#: which no rollout class takes; the ties case has x built to round half to even
#: in the quantise kernel (``ties_input``)
K3_EDGE_CASES = (("edge: batch 2, w not a multiple of 64", "full", 128, 128, 256, 80, 2, 2),
                 ("edge: float32, w % 8 != 0", "cont", 256, 128, 256, 84, 1, 1),
                 ("edge: co = 3, batch 2, w % 8 != 0", "full", 128, 3, 64, 84, 2, 2),
                 ("edge: 3 -> 3 (packed, 16-channel tile)", "cont", 3, 3, 64, 72, 2, 1),
                 ("ties: amax 127, halves", "cont", 128, 128, 256, 96, 1, 1))
#: dense int8 peak of one H100 SXM (NVIDIA data sheet) at its 700 W limit
PEAK_INT8_OPS = 1979e12
#: the int8 linears of one stage-2 forward, 2 CFG rows (S = 2093, 77 text
#: tokens): (name, rows, in, out)
LINEAR_CASES = (("D->D (q, k, v, out)", 2 * 2016, 1536, 1536),
                ("D->4D (ff proj)", 2 * 2016, 1536, 6144),
                ("4D->D (ff out)", 2 * 2016, 6144, 1536))
#: int_mm shapes that torch._int_mm's CUDA rule refuses and int_mm pads:
#: (rows, k, n)
PADDED_INT_MM_CASES = ((16, 1536, 1536), (17, 12, 20))
#: seconds any one HTTP call of phase 13 may take
HTTP_TIMEOUT = 600
#: phase 15's pyramid steps denoise this unit (the last of 8 latent units)
TRAIN_UNIT = 7
#: phase 15's checkpoint round trip: a trainer of full width cut to this
#: depth (4.2 GB; the whole model's 25 GB took ~40 s to write there)
CKPT_LAYERS = 4
#: K1's backward in f32 against autograd of the plain version (TF32 off).
#: The kernel takes each product as three TF32 products (3xTF32: big.big +
#: big.small + small.big, big = tf32(x), small = tf32(x - big)), which drops
#: small.small and the splits' rounding, ~2^-21 of each term, and sums in
#: other orders over up to S terms, on gradients of magnitude up to ~10.
#: The larger errors fall on large values, where rtol gives the room: on an
#: H100 the largest |err| / (atol + rtol |ref|) over phase 14's layouts was
#: 0.235 (dv at the stage-2 training layout; the largest |err| 4.9e-5, on dk)
BWD_F32_ATOL, BWD_F32_RTOL = 5e-5, 1e-4
#: K1's backward in bf16 against an f32 evaluation of the same bf16 inputs.
#: The kernel rounds P and dS to bf16 before their second products (as the
#: forward rounds P), D comes from the bf16 output, and each gradient is
#: rounded once; the plain bf16 backward rounds at other points. Where the
#: terms of a sum cancel, an error of 2^-9 per term is large against the
#: value, so a bound relative to each value does not hold (on an H100 the
#: kernel exceeded 2e-3 + 2^-7 of the value by up to 1.1e-3, with largest
#: deviations of the plain version's size). The kernel must be as accurate
#: as the plain version: its largest
#: deviation at most BWD_BF16_MAX_RATIO times the plain version's plus half
#: a bf16 ulp of the largest value (2^-9 of it), and its relative L2
#: deviation at most BWD_BF16_REL_L2 (one bf16 ulp; both versions measure
#: ~0.0024, about 2^-8.7, mostly the output's rounding)
BWD_BF16_MAX_RATIO, BWD_BF16_REL_L2 = 2.0, 2.0 ** -7


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: no host time between launches, which at kernels of
    tens of microseconds is as long as the kernel (the wrapper's Python, its
    tensor-map encoding). ``fn`` must be capturable: the conv wrappers and
    their cuDNN yardsticks are."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def rollout_layouts(device):
    """(name, rows, clip shapes, ctx_valid, frame times, frame valid) of the
    packed attention the rollout runs: every pyramid stage, for a chunk-1
    unit (2 rows, no history) and a chunk-2 unit (3 rows, history)."""
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.pipeline import _pyramid_list, padded_conditions

    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=8, pooled_dim=8)
    neg = torch.as_tensor(embeds["empty"]["prompt_attention_mask"], device=device)
    pos = torch.as_tensor(embeds[action_vocabulary()[1]]["prompt_attention_mask"],
                          device=device)
    lh, lw = HEIGHT // pcfg.vae_downsample, WIDTH // pcfg.vae_downsample
    out = []
    # chunk 1, unit 3 (first-frame mask: padding frames in the old clip);
    # chunk 2, unit 5 (carried frames, history rows)
    for rows, unit, fm in ((2, 3, True), (3, 5, False)):
        gen = torch.zeros((1, mcfg.in_channels, unit + int(fm), lh, lw), device=device)
        conds = padded_conditions(pcfg, _pyramid_list(gen, len(pcfg.stages) - 1), unit, fm, rows)
        ctx = torch.cat([neg] + [pos] * (rows - 1))
        if rows == 3:
            hlen = (lh // 2 // mcfg.patch_size) * (lw // 2 // mcfg.patch_size)
            hist = torch.tensor([[0], [0], [1]], dtype=ctx.dtype, device=device).expand(3, hlen)
            ctx = torch.cat([hist, ctx], dim=1)
        for s, (clips, times, valid) in enumerate(conds):
            shapes = [tuple(c.shape[2:]) for c in clips] + [tuple(clips[-1].shape[2:])]
            times = list(times)
            valid = list(valid)
            out.append((f"stage{s}_b{rows}", rows, shapes, ctx, times, valid))
    return out


def attention_edge_layouts(device, gen):
    """(name, valid [2, S], times, what the tile classes must show) of K1's
    edge layouts, which reach every branch of its mask schedule."""
    import torch
    b, out = 2, []
    s = 37                                    # S < 64: one ragged key tile
    out.append(("edge: S=37", torch.ones((b, s), dtype=torch.int32, device=device),
                torch.zeros(s, device=device), "partial"))
    s = 768                                   # mask-free: every tile full
    out.append(("edge: mask-free S=768", torch.ones((b, s), dtype=torch.int32, device=device),
                torch.zeros(s, device=device), "full"))
    s = 1000                                  # per-token valid: most tiles partial
    valid = torch.randint(0, 2, (b, s), generator=gen, device=device, dtype=torch.int32)
    times = torch.arange(s, device=device).div(200, rounding_mode="floor").float()
    out.append(("edge: per-token valid S=1000", valid, times, "partial"))
    s = 1000                                  # time-skipped tiles in the middle of the keys
    times = torch.zeros(s, device=device)
    times[300:700] = 5.0
    times[700:] = -1.0
    out.append(("edge: middle skip S=1000", torch.ones((b, s), dtype=torch.int32, device=device),
                times, "middle"))
    return out


def training_layouts(device):
    """(name, rows, clip shapes, ctx_valid, frame times, frame valid) of the
    packed attention of one pyramid training step at 384x512, for each
    stage: phase 15's shapes (8 latent units, unit_index 7, the first-frame
    mask, one row) with an action prompt's text mask (10 of 77 tokens;
    phase 15's batch unmasks 11)."""
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.pipeline import _pyramid_list, padded_conditions

    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=8, pooled_dim=8)
    ctx = torch.as_tensor(embeds[action_vocabulary()[1]]["prompt_attention_mask"],
                          device=device)
    lh, lw = HEIGHT // pcfg.vae_downsample, WIDTH // pcfg.vae_downsample
    unit = TRAIN_UNIT
    ctx_frames = unit * pcfg.frame_per_unit
    clean = torch.zeros((1, mcfg.in_channels, ctx_frames, lh, lw), device=device)
    conds = padded_conditions(pcfg, _pyramid_list(clean, len(pcfg.stages) - 1), unit, True, 1)
    out = []
    for s, (clips, times, valid) in enumerate(conds):
        shapes = [tuple(c.shape[2:]) for c in clips] + [tuple(clips[-1].shape[2:])]
        out.append((f"train_stage{s}_b1", 1, shapes, ctx, list(times), list(valid)))
    return out


def check_attention_bf16(name, q, k, v, valid, times, n_last=0):
    """K1 in f32 and bf16 against the plain version, at the stated
    tolerances; returns the errors."""
    import torch
    from deepv_tpu_torch.ops import attention as att

    # f32: the kernel's arithmetic against the plain version, exactly
    o32 = att.attention(q, k, v, valid, times, n_last=n_last)
    r32 = att.attention_plain(q, k, v, valid, times)
    torch.cuda.synchronize()
    err32 = (o32 - r32).abs().max().item()
    torch.testing.assert_close(o32, r32, atol=2e-5, rtol=1e-4)

    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    ob = att.attention(qb, kb, vb, valid, times, n_last=n_last)
    rb = att.attention_plain(qb, kb, vb, valid, times)
    rf = att.attention_plain(qb.float(), kb.float(), vb.float(), valid, times)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ob).all()), f"{name}: non-finite bf16 output"
    torch.testing.assert_close(ob.float(), rb.float(), atol=3e-2, rtol=3e-2)
    # bench.py's 2e-3 was set for an f32 kernel (the f32 check above meets
    # it with room). A bf16 result also carries its own rounding: the
    # output's (half an ulp) and the bf16 weights' (the TPU kernel rounds
    # them too). On rows that attend few keys the outputs reach ~2, where
    # half an ulp alone is 3.9e-3, and the plain bf16 version itself is
    # ~7e-3 off the f32 evaluation. So the bound is 2e-3 plus 2^-8 of the
    # value (between half and one bf16 ulp of it).
    excess = ((ob.float() - rf).abs() - (2e-3 + rf.abs() * 2.0 ** -8)).max().item()
    assert excess <= 0, f"{name}: bf16 kernel vs f32 reference (excess {excess})"
    return (qb, kb, vb), dict(err_f32_kernel=err32,
                              err_bf16_vs_plain=(ob.float() - rb.float()).abs().max().item(),
                              err_bf16_vs_f32=(ob.float() - rf).abs().max().item(),
                              plain_bf16_err_vs_f32=(rb.float() - rf).abs().max().item())


def tile_counts(valid, times, block_q=128, block_k=64):
    """K1's tile classes, counted over the call: the forward's 128 x 64
    tile, or the backward's 64 x 64."""
    from deepv_tpu_torch.ops import attention as att
    cls = att.tile_classes(valid, times, block_q, block_k)
    return {name: int((cls == c).sum()) for name, c in
            (("skip", att.SKIP), ("full", att.FULL), ("partial", att.PARTIAL))}


def check_attention(device, results):
    """Phase 3: the kernel against its plain version: one-hot P first, then
    every rollout layout (timed), then the edge layouts."""
    import torch
    import torch.nn.functional as F
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask
    from deepv_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    h, d = mcfg.num_attention_heads, mcfg.attention_head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(5)

    # one-hot P: with every token in its own valid group each row attends
    # only itself, so P is the identity and the bf16 output must be V's
    # rows exactly (P.V reads V MN-major through the transpose-B bit)
    for s in (37, 200, 2093):
        qb, kb, vb = (torch.randn((2, s, h, d), generator=gen, device=device).to(torch.bfloat16)
                      for _ in range(3))
        valid = torch.arange(s, device=device, dtype=torch.int32).repeat(2, 1)
        ob = att.attention(qb, kb, vb, valid, torch.zeros(s, device=device))
        torch.cuda.synchronize()
        diff = (ob.float() - vb.float()).abs().max().item()
        log(f"attention one-hot P, S={s}: max |out - v| = {diff}")
        assert diff == 0.0, f"one-hot P at S={s}: output differs from V by {diff}"

    # launches per rollout of each layout: units of its chunk x steps x blocks
    per_unit = pcfg.num_inference_steps * mcfg.num_layers
    units = {2: pcfg.max_temporal_length, 3: pcfg.max_temporal_length - pcfg.num_input_unit}
    rows_out = []
    for name, b, shapes, ctx, ftimes, fvalid in rollout_layouts(device):
        layout = PackedLayout(mcfg, shapes, ctx.shape[1])
        valid, times = packed_mask(layout, ctx, ftimes, fvalid)
        s = layout.seq_len
        n_last = layout.clip_tokens[-1]
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device) for _ in range(3))
        (qb, kb, vb), errs = check_attention_bf16(name, q, k, v, valid, times, n_last)

        # the least time for this work: the allowed pairs of these inputs
        allowed = ((valid[:, :, None] == valid[:, None, :])
                   & (times[:, None] >= times[None, :])[None])
        pairs = int(allowed.sum().item())
        flops = 4 * pairs * h * d                    # q.k and p.v, 2 flops per MAC
        nbytes = 4 * b * s * h * d * 2 + valid.numel() * 4 + times.numel() * 4
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        split_pairs = b * ((s - n_last) ** 2 + n_last * s)   # the TPU wrapper's split

        ms = cuda_time_ms(lambda: att.attention(qb, kb, vb, valid, times, n_last=n_last), 20)
        plain_ms = cuda_time_ms(lambda: att.attention_plain(qb, kb, vb, valid, times), 3, 1)
        mask = allowed[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (qb, kb, vb))
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 10)
        # the f32 kernel (f32 training and f32 forwards run it) beside SDPA
        # in f32: back to back, host time included, and as device time, the
        # call replayed from a CUDA graph beside the sum of SDPA's kernels;
        # the bound as 3xTF32 (three TF32 products a product at the TF32
        # peak: the least time), the FMA rate's beside it
        call32 = lambda: att.attention(q, k, v, valid, times, n_last=n_last)
        before = att.f32_launches
        f32_ms = cuda_time_ms(call32, 10)
        assert att.f32_launches > before, "the f32 forward did not run the f32 kernel"
        f32_graph = graph_ms(call32, 10)
        q32, k32, v32 = (x.transpose(1, 2) for x in (q, k, v))
        sdpa32 = lambda: F.scaled_dot_product_attention(q32, k32, v32, attn_mask=mask)
        f32_lib = cuda_time_ms(sdpa32, 5)
        f32_lib_kernels = sum(kernel_device_ms(sdpa32, 5).values())
        f32_plain = cuda_time_ms(lambda: att.attention_plain(q, k, v, valid, times), 2, 1)
        nbytes32 = 4 * b * s * h * d * 4 + valid.numel() * 4 + times.numel() * 4
        t3_ops, t_fma = flops / (PEAK_TF32_FLOPS / 3), flops / PEAK_F32_FLOPS
        t32_bytes = nbytes32 / PEAK_BYTES
        f32 = dict(kernel="attn_fwd_tf32x3", ms=f32_ms, graph_ms=f32_graph, plain_ms=f32_plain,
                   library_ms=f32_lib, library_kernels_ms=f32_lib_kernels,
                   bound_ms=1e3 * max(t3_ops, t32_bytes),
                   bound_by="operations" if t3_ops >= t32_bytes else "bytes",
                   bound_fma_ms=1e3 * max(t_fma, t32_bytes),
                   share_of_bound=1e3 * max(t3_ops, t32_bytes) / f32_graph,
                   tflops=flops / (f32_graph * 1e-3) / 1e12, err=errs["err_f32_kernel"])
        log(f"attention f32 {name}", json.dumps(f32))
        del q32, k32, v32, call32, sdpa32
        del allowed, mask
        row = dict(layout=name, b=b, S=s, heads=h, head_dim=d, n_last=n_last,
                   allowed_pairs=pairs, split_pairs=split_pairs, flops=flops, bytes=nbytes,
                   **errs, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tflops=flops / (ms * 1e-3) / 1e12, tiles=tile_counts(valid, times),
                   launches_per_rollout=units[b] * per_unit, f32=f32)
        rows_out.append(row)
        log("attention", json.dumps(row))

    for name, valid, times, expect in attention_edge_layouts(device, gen):
        b, s = valid.shape
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device) for _ in range(3))
        _, errs = check_attention_bf16(name, q, k, v, valid, times)
        tiles = tile_counts(valid, times)
        cls = att.tile_classes(valid, times)
        if expect == "full":
            assert tiles["full"] == cls.numel(), (name, tiles)
        elif expect == "partial":
            assert tiles["partial"] > cls.numel() // 2, (name, tiles)
        elif expect == "middle":    # rows at time 0 skip the time-5 keys, then attend again
            first = cls[0, 0].tolist()
            skipped = [i for i, c in enumerate(first) if c == att.SKIP]
            assert skipped and min(skipped) > 0 and max(skipped) < len(first) - 1, first
        row = dict(layout=name, b=b, S=s, tiles=tiles, **errs)
        rows_out.append(row)
        log("attention", json.dumps(row))

    rollout = [r for r in rows_out if "ms" in r]
    sums = {key: sum(r["launches_per_rollout"] * r[key] for r in rollout) / 1e3
            for key in ("ms", "library_ms", "bound_ms", "plain_ms")}
    results["attention_rollout_sums_s"] = sums
    log(f"K1 over the rollout ({sum(r['launches_per_rollout'] for r in rollout)} launches): "
        f"K1 {sums['ms']:.4f} s, SDPA {sums['library_ms']:.4f} s, bound {sums['bound_ms']:.4f} s")
    results["attention_layouts"] = rows_out
    return rollout


def backward_layouts(device, gen):
    """(name, valid, times, n_last) of phase 14: the training layouts of
    stages 0-2 (b=1), the rollout's stage-2 2-row layout, K1's edge layouts
    (S < 64, mask-free, per-token valid, time-skipped tiles mid-sequence)
    and a ragged last tile with a causal mask."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask

    mcfg = MMDiTConfig()
    out = []
    rollout = [r for r in rollout_layouts(device) if r[0] == "stage2_b2"]
    for name, b, shapes, ctx, ftimes, fvalid in training_layouts(device) + rollout:
        layout = PackedLayout(mcfg, shapes, ctx.shape[1])
        valid, times = packed_mask(layout, ctx, ftimes, fvalid)
        out.append((name, valid, times, layout.clip_tokens[-1]))
    for name, valid, times, _ in attention_edge_layouts(device, gen):
        out.append((name, valid, times, 0))
    s = 130                                   # ragged: two full tiles and 2 rows
    times = torch.arange(s, device=device).div(40, rounding_mode="floor").float()
    out.append(("edge: ragged causal S=130", torch.ones((2, s), dtype=torch.int32,
                                                        device=device), times, 0))
    return out


def sdpa_backward(q, k, v, dout, valid, times):
    """A function that runs SDPA's backward with the same boolean mask as
    ``attention`` on ``[b, S, h, d]`` inputs: the yardstick the port never
    calls."""
    import torch
    import torch.nn.functional as F
    allowed = ((valid[:, :, None] == valid[:, None, :])
               & (times[:, None] >= times[None, :])[None])
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed[:, None])
    dot = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)


def kernel_device_ms(fn, calls: int = 10):
    """{kernel name: mean device ms per call of ``fn``} over ``calls`` calls,
    from torch.profiler's CUDA activity; empty where it records none."""
    import torch
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def attention_grads(q, k, v, dout, valid, times, n_last=0):
    """(out, dq, dk, dv) of ``attention`` through autograd, the path training
    takes."""
    import torch
    from deepv_tpu_torch.ops import attention as att
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = att.attention(*leaves, valid, times, n_last=n_last)
    return (out.detach(), *torch.autograd.grad(out, leaves, dout))


def backward_row(name, valid, times, n_last, h, d, gen):
    """Phase 14 at one layout and head count: the backward kernels and the
    forward's LSE against the plain backward, f32 and bf16, two runs
    bit-equal, one forward and one backward launch per autograd call; the
    call's time beside SDPA's backward's (back to back, and as device time).
    Returns the layout's row."""
    import torch
    from deepv_tpu_torch.ops import attention as att

    b, s = valid.shape
    q, k, v, dout = (torch.randn((b, s, h, d), generator=gen, device=valid.device)
                     for _ in range(4))
    row = dict(layout=name, heads=h, b=b, S=s, grid=(b * h, -(-s // 64)),
               tiles_64=tile_counts(valid, times, 64, 64))
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        qc, kc, vc, oc = (x.to(dtype) for x in (q, k, v, dout))
        # the forward with the LSE equals the inference route's bit for bit
        out, lse = att._forward_kernel(qc, kc, vc, valid, times, with_lse=True)
        with torch.no_grad():
            plain_route = att.attention(qc, kc, vc, valid, times, n_last=n_last)
        assert torch.equal(out, plain_route), f"{name} {tag}: the LSE changed the output"
        lse_ref = att.attention_lse_plain(qc, kc, valid, times)
        lse_err = (lse - lse_ref).abs().max().item()
        # sums of up to S exponentials in another order, exp2/log2 in bf16's
        # kernel: f32 rounding of values up to ~10
        assert lse_err <= 1e-4 + 1e-5 * lse_ref.abs().max().item(), (name, tag, lse_err)
        # autograd: one forward launch of the dtype's kernel, one backward
        before = (att.launches, att.f32_launches, att.bwd_launches)
        got = attention_grads(qc, kc, vc, oc, valid, times, n_last)
        torch.cuda.synchronize()
        bf = int(dtype == torch.bfloat16)
        after = (att.launches, att.f32_launches, att.bwd_launches)
        assert after == (before[0] + bf, before[1] + 1 - bf, before[2] + 1), \
            f"{name} {tag}: launches {before} -> {after}"
        assert torch.equal(got[0], out), f"{name} {tag}: autograd forward differs"
        again = att.attention_backward(qc, kc, vc, out, lse, oc, valid, times)
        assert all(torch.equal(x, y) for x, y in zip(got[1:], again)), \
            f"{name} {tag}: two backward runs differ"
        plain = att.attention_backward_plain(qc, kc, vc, oc, valid, times)
        errs = {f"{tag}_lse_err": lse_err}
        for gname, x, ref in zip(("dq", "dk", "dv"), got[1:], plain):
            assert bool(torch.isfinite(x).all()), f"{name} {tag}: non-finite {gname}"
            errs[f"{tag}_{gname}_err"] = (x.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            for gname, x, ref in zip(("dq", "dk", "dv"), got[1:], plain):
                # the largest |err| / (atol + rtol |ref|): the share of the limit used
                errs[f"f32_{gname}_limit_share"] = (
                    (x - ref).abs() / (BWD_F32_ATOL + BWD_F32_RTOL * ref.abs())).max().item()
                torch.testing.assert_close(x, ref, atol=BWD_F32_ATOL, rtol=BWD_F32_RTOL,
                                           msg=lambda m: f"{name} f32 {gname}: {m}")
        else:
            ref32 = att.attention_backward_plain(*(x.float() for x in (qc, kc, vc, oc)),
                                                 valid, times)
            for gname, x, r32, rb in zip(("dq", "dk", "dv"), got[1:], ref32, plain):
                err = (x.float() - r32).abs().max().item()
                plain_err = (rb.float() - r32).abs().max().item()
                rel = ((x.float() - r32).norm() / r32.norm()).item()
                errs.update({f"bf16_{gname}_err_vs_f32": err,
                             f"plain_bf16_{gname}_err_vs_f32": plain_err,
                             f"bf16_{gname}_rel_l2_vs_f32": rel,
                             f"plain_bf16_{gname}_rel_l2_vs_f32":
                                 ((rb.float() - r32).norm() / r32.norm()).item()})
                limit = (BWD_BF16_MAX_RATIO * plain_err
                         + r32.abs().max().item() * 2.0 ** -9)
                assert err <= limit and rel <= BWD_BF16_REL_L2, (
                    f"{name} bf16 {gname}: max deviation {err} (limit {limit}), "
                    f"relative L2 {rel} (limit {BWD_BF16_REL_L2})")
            del ref32
        row.update(errs)
        # the call's time and SDPA's backward's at every layout (which
        # kernels SDPA picks depends on the layout and the dtype): back
        # to back, host time included; and device time alone, the call
        # replayed from a CUDA graph against the sum of SDPA's kernels
        call = lambda: att.attention_backward(qc, kc, vc, out, lse, oc, valid, times)
        sdpa = sdpa_backward(qc, kc, vc, oc, valid, times)
        row[f"{tag}_ms"] = cuda_time_ms(call, 10)
        row[f"{tag}_sdpa_ms"] = cuda_time_ms(sdpa, 10)
        row[f"{tag}_graph_ms"] = graph_ms(call, 10)
        row[f"{tag}_sdpa_kernels_ms"] = sum(kernel_device_ms(sdpa).values())
        del call, sdpa
        del got, again, plain, out, lse, lse_ref
    return row


def check_attention_backward(device, results):
    """Phase 14: the backward kernels and the forward's LSE against the plain
    backward (autograd of attention_plain) on the card, f32 and bf16, every
    layout of ``backward_layouts``; two runs bit-equal; the launch counts;
    at the stage-2 training layout the kernels, the plain backward and
    SDPA's backward timed beside the bound. Then the same checks at the
    per-rank heads of tp 2 and 4 at the training layouts."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg = MMDiTConfig()
    h, d = mcfg.num_attention_heads, mcfg.attention_head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    rows_out = []
    for name, valid, times, n_last in backward_layouts(device, gen):
        row = backward_row(name, valid, times, n_last, h, d, gen)
        rows_out.append(row)
        log("attention backward", json.dumps(row))
    # the per-rank heads of the tensor-parallel training step, at the
    # training layouts (the first three), beside the 24-head row
    mesh_rows = []
    for (name, valid, times, n_last), row24 in zip(backward_layouts(device, gen)[:3], rows_out):
        for heads in MESH_HEADS:
            row = backward_row(name, valid, times, n_last, heads, d, gen)
            for tag in ("f32", "bf16"):
                row[f"{tag}_ms_24_heads"] = row24[f"{tag}_ms"]
                row[f"{tag}_graph_ms_24_heads"] = row24[f"{tag}_graph_ms"]
            mesh_rows.append(row)
            log("attention backward (per-rank heads)", json.dumps(row))
    results["attention_backward_mesh_heads"] = mesh_rows

    # timing at the stage-2 training layout
    name, valid, times, n_last = backward_layouts(device, gen)[2]
    b, s = valid.shape
    allowed = ((valid[:, :, None] == valid[:, None, :]) & (times[:, None] >= times[None, :])[None])
    pairs = int(allowed.sum().item())
    timing = dict(layout=name, b=b, S=s, heads=h, head_dim=d, allowed_pairs=pairs,
                  grid=(b * h, -(-s // 64)),
                  tiles_64=tile_counts(valid, times, 64, 64))
    # f32's least time is the 3xTF32 route's: three TF32 products a product
    for dtype, peak in ((torch.float32, PEAK_TF32_FLOPS / 3), (torch.bfloat16, PEAK_BF16_FLOPS)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        es = 4 if dtype == torch.float32 else 2
        q, k, v, dout = (torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
                         for _ in range(4))
        out, lse = att._forward_kernel(q, k, v, valid, times, with_lse=True)
        n0 = att.bwd_launches
        ms = cuda_time_ms(lambda: att.attention_backward(q, k, v, out, lse, dout, valid, times),
                          10)
        timing_launches = att.bwd_launches - n0
        plain_ms = cuda_time_ms(
            lambda: att.attention_backward_plain(q, k, v, dout, valid, times), 3, 1)
        library = sdpa_backward(q, k, v, dout, valid, times)
        library_ms = cuda_time_ms(library, 10)
        flops = 5 * 2 * pairs * h * d                 # five S x S x 64 products
        nbytes = (8 * b * s * h * d * es + b * h * s * 4 + valid.numel() * 4
                  + times.numel() * 4)                # q k v o dO in, dq dk dv out, lse
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
        timing[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=1e3 * max(t_ops, t_bytes),
                           bound_by="operations" if t_ops >= t_bytes else "bytes",
                           tflops=flops / (ms * 1e-3) / 1e12, timed_launches=timing_launches,
                           kernels_ms=kernel_device_ms(lambda: att.attention_backward(
                               q, k, v, out, lse, dout, valid, times)),
                           library_kernels_ms=kernel_device_ms(library))
        if dtype == torch.float32:
            timing[tag].update(bound_means="3xTF32 on the TF32 tensor cores (495 TF/s / 3)",
                               bound_fma_ms=1e3 * max(flops / PEAK_F32_FLOPS, t_bytes))
        del q, k, v, dout, out, lse, library
    del allowed
    log("attention backward timing", json.dumps(timing))
    results["attention_backward_layouts"] = rows_out
    results["attention_backward_timing"] = timing
    torch.cuda.empty_cache()
    return rows_out + mesh_rows, timing


def rollout_batch(prompt: str = PROMPT):
    """The rollout's input: a smooth 384x512 test image with seeded noise and
    the 11-action prompt (or ``prompt``). The image holds float16 values, so
    it reaches a served session (float16 on the wire) unchanged."""
    import numpy as np
    from deepv_tpu_torch.actions import prepare_motion_prompts

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH] / np.array([HEIGHT, WIDTH])[:, None, None]
    img = np.stack([np.sin(6 * xx + 2 * c) * np.cos(4 * yy - c) for c in range(3)])
    img = np.clip(img + 0.1 * rng.standard_normal(img.shape), -1, 1)[None].astype(np.float16)
    img = img.astype(np.float32)
    return {"img": img, "prompt": np.array(prepare_motion_prompts("action", prompt)),
            "prompt_type": "action"}


class FrameHook:
    """An ``on_frames`` callback: keeps every decoded window, and the seconds
    from ``t0`` to the first window, synchronised inside the callback."""

    def __init__(self):
        self.windows, self.first_s, self.t0 = [], None, None

    def __call__(self, rgb, disp):
        import torch
        if self.first_s is None:
            torch.cuda.synchronize()
            self.first_s = time.perf_counter() - self.t0
        self.windows.append((rgb, disp))


def drive_rollout(pipe, setup_s: float, hook: "FrameHook | None" = None, batch=None):
    """generate() on ``batch`` (default ``rollout_batch()``) with every
    kernel count set to 0 just before and read just after; checks the
    outputs and K1's count: one launch per block of every forward the
    pipeline records as run (all of them without flow caching). ``hook``
    becomes ``pipe.on_frames`` for the call, timed from the call. Returns
    (summary, output, K2 launches)."""
    import torch
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.ops import conv_igemm as cig
    from deepv_tpu_torch.ops import conv_int8 as ci8
    from deepv_tpu_torch.ops import linear_int8 as li8

    pipe.timer.sync = True
    resident = torch.cuda.memory_allocated() / 2 ** 30      # weights and buffers
    torch.cuda.reset_peak_memory_stats()
    att.launches = att.f32_launches = att.bwd_launches = 0
    for name in K2_COUNTERS:
        setattr(cig, name, 0)
    ci8.launches = ci8.packed_launches = ci8.quantize_launches = li8.calls = 0
    batch = rollout_batch() if batch is None else batch
    pipe.on_frames = hook
    t0 = time.perf_counter()
    if hook is not None:
        hook.t0 = t0
    try:
        out = pipe.generate(batch, seed=666)
        torch.cuda.synchronize()
    finally:
        pipe.on_frames = None
    wall = time.perf_counter() - t0
    launches = att.launches
    assert att.f32_launches == 0, "the bf16 rollout launched the f32 attention kernel"
    assert att.bwd_launches == 0, "the rollout launched the attention backward"
    conv_launches = {name: getattr(cig, name) for name in K2_COUNTERS}
    assert conv_launches["f32_launches"] == conv_launches["split_launches"] == 0, (
        "the bf16 rollout launched the f32 conv kernels")
    int8_counts = dict(conv_int8_launches=ci8.launches + ci8.packed_launches,
                       conv_int8_wgmma_launches=ci8.launches,
                       conv_int8_packed_launches=ci8.packed_launches,
                       quantize_k3_launches=ci8.quantize_launches, int_mm_calls=li8.calls)

    mcfg, pcfg = pipe.mcfg, pipe.cfg
    n_units = pcfg.max_temporal_length + (pcfg.max_temporal_length - pcfg.num_input_unit)
    assert len(pipe.recompute_log) == n_units * len(pcfg.stages), len(pipe.recompute_log)
    forwards = sum(map(sum, pipe.recompute_log))
    expected = forwards * mcfg.num_layers
    img_out, disp = out["pred_img"], out["pred_disparity"]
    n_frames = img_out.shape[2]
    assert tuple(img_out.shape) == (1, 3, 89, HEIGHT, WIDTH), tuple(img_out.shape)
    assert tuple(disp.shape) == (1, 3, 89, HEIGHT, WIDTH), tuple(disp.shape)
    assert bool(torch.isfinite(img_out).all()), "non-finite frames"
    assert bool(torch.isfinite(disp).all()), "non-finite disparity"
    assert float(disp.min()) >= 0.0, "post-mapped disparity is a square, never negative"
    for key in ("trans3d", "trans2d"):
        assert tuple(out[key].shape) == (1, 12, 4, 4), (key, tuple(out[key].shape))
        assert bool(torch.isfinite(out[key]).all()), f"non-finite {key}"
    assert torch.allclose(out["trans3d"][0, 0].cpu(), torch.eye(4), atol=1e-5)
    assert launches == expected, f"attention kernel launched {launches} times, expected {expected}"
    stats = pipe.timer.stats()
    summary = dict(wall_s=wall, frames=n_frames, fps=n_frames / wall, setup_s=setup_s,
                   forwards=forwards, attention_launches=launches,
                   expected_attention_launches=expected, conv_igemm_launches=conv_launches,
                   **int8_counts, history_index=out["history_index"],
                   phases_s={k: v["total_s"] for k, v in stats.items()},
                   phase_counts={k: v["count"] for k, v in stats.items()},
                   resident_gib=resident,
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   pixel_mean=float(img_out.float().mean()),
                   pixel_std=float(img_out.float().std()))
    return summary, out, conv_launches


def check_frame_hook(hook: FrameHook, out, n_carry: int) -> None:
    """Phase 5's on_frames windows: chunk 1 one frame then 7 x 8, chunk 2
    (exact priming) 4 x 8 new frames; concatenated, they are the output bit
    for bit, disparity after each chunk's post-map (chunk 2's scale factor
    is the carry's, from its first carried frame)."""
    import torch
    from deepv_tpu_torch.pipeline import _disparity_postmap

    frames = [rgb.shape[2] for rgb, _ in hook.windows]
    assert frames == [1] + [8] * 7 + [8] * 4, f"on_frames windows {frames}"
    assert torch.equal(torch.cat([w for w, _ in hook.windows], dim=2), out["pred_img"]), \
        "on_frames windows differ from pred_img"
    disp = out["pred_disparity"]
    n1 = sum(frames[:8])
    sf1 = torch.tensor(1.0, dtype=torch.float32, device=disp.device)
    sf2 = 1.0 / disp[:, :, n1 - n_carry].max()
    for windows, sf, ref in ((hook.windows[:8], sf1, disp[:, :, :n1]),
                             (hook.windows[8:], sf2, disp[:, :, n1:])):
        got = _disparity_postmap(torch.cat([d for _, d in windows], dim=2), sf)
        assert torch.equal(got, ref), "on_frames disparity windows differ from pred_disparity"


def run_main_path(device, results):
    """Phase 5: the full-width rollout through the user's entry points, with
    the on_frames hook."""
    import torch
    from deepv_tpu_torch.config import create_model_config
    from deepv_tpu_torch.run import load_pipeline

    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    pipe = load_pipeline("none", cfg, random_weights=True, dtype=torch.bfloat16,
                         device=device, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in pipe.mmdit.parameters())
    log(f"main path: pipeline with {n_params / 1e9:.3f} B MMDiT parameters ready in "
        f"{setup_s:.1f} s")
    hook = FrameHook()
    main, out, conv_launches = drive_rollout(pipe, setup_s, hook)
    check_frame_hook(hook, out, pipe.cfg.num_input_image)
    main["on_frames_windows"] = len(hook.windows)
    main["first_frame_s"] = hook.first_s
    log(f"main path: time to first frame (generate() to the first on_frames window, "
        f"synchronised) {hook.first_s:.3f} s; {len(hook.windows)} windows equal the output")
    del hook
    assert not any(conv_launches.values()), f"the default (xla) path launched K2: {conv_launches}"
    assert main["forwards"] == FORWARDS, f"the exact rollout ran {main['forwards']} forwards"
    assert (main["conv_int8_launches"] == main["quantize_k3_launches"]
            == main["int_mm_calls"] == 0), main
    log("main path:", json.dumps(main))
    results["main_path"] = main
    return (pipe, main["attention_launches"], out["pred_img"], out["pred_disparity"],
            (out["trans3d"], out["trans2d"]))


def check_forward(pipe, device, results):
    """Phase 5: one full-width forward (stage 2, 3 rows + history) in f32,
    kernel against plain attention."""
    import torch
    from deepv_tpu_torch.models import mmdit as mm
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.pipeline import _pyramid_list, padded_conditions

    model = pipe.mmdit.float()
    mcfg, pcfg = pipe.mcfg, pipe.cfg
    g = torch.Generator(device=device)
    g.manual_seed(11)
    lh, lw = HEIGHT // 8, WIDTH // 8
    gen = torch.randn((1, mcfg.in_channels, 5, lh, lw), generator=g, device=device)
    clips, ftimes, fvalid = padded_conditions(pcfg, _pyramid_list(gen, 2), 5, False, 3)[2]
    lat = torch.randn((1, mcfg.in_channels, 1, lh, lw), generator=g, device=device)
    mask = torch.cat([pipe._embeds_for("empty")[1]] * 3)
    text = torch.randn((3, 77, mcfg.joint_attention_dim), generator=g, device=device)
    pooled = torch.randn((3, mcfg.pooled_projection_dim), generator=g, device=device)
    hist = torch.randn((3, mcfg.in_channels, 1, lh, lw), generator=g, device=device)
    hlen = (lh // 2 // mcfg.patch_size) * (lw // 2 // mcfg.patch_size)
    hmask = torch.tensor([[0], [0], [1]], dtype=torch.int32, device=device).expand(3, hlen)
    args = (list(clips) + [torch.cat([lat] * 3)], text, mask, pooled,
            torch.full((3,), 700.0, device=device))
    kw = dict(history=hist, history_mask=hmask, frame_times=list(ftimes),
              frame_valid=list(fvalid), split_last_attn=True)
    with torch.inference_mode():
        before = att.f32_launches
        v_kernel = mm.mmdit_forward(model, *args, **kw)
        assert att.f32_launches - before == mcfg.num_layers, "f32 forward missed the f32 kernel"
        orig = mm.attention
        mm.attention = lambda q, k, v, valid, times, n_last=0: att.attention_plain(
            q, k, v, valid, times)
        try:
            v_plain = mm.mmdit_forward(model, *args, **kw)
        finally:
            mm.attention = orig
    torch.cuda.synchronize()
    rel = ((v_kernel - v_plain).norm() / v_plain.norm()).item()
    err = (v_kernel - v_plain).abs().max().item()
    log(f"forward check: f32 full-width forward, kernel vs plain attention: "
        f"max abs {err:.3e}, relative L2 {rel:.3e}")
    # f32 attention agrees to ~1e-6; 24 blocks of random-weight residual
    # updates keep that near 1e-5 relative
    assert rel <= 1e-4, f"forward with the kernel differs from the plain forward: {rel}"
    results["forward_check"] = dict(max_abs=err, rel_l2=rel)


def bf16_ulp(v):
    """Spacing of bfloat16 numbers at |v| (8 significant bits)."""
    import torch
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def conv_case_inputs(mode: str, ci: int, co: int, h: int, w: int, n: int, gen, device,
                     b: int = 1):
    """Input, parameters and time_pad of one K2 case: ``full`` convolves n
    frames with 2 causal zero frames; ``init`` is the same with the zero
    frames already prepended; ``cont``/``prime`` convolve n frames after 2
    context frames."""
    import types
    import torch
    if mode == "full":
        x = torch.randn((b, ci, n, h, w), generator=gen, device=device)
    else:
        x = torch.randn((b, ci, n + 2, h, w), generator=gen, device=device)
        if mode == "init":
            x[:, :, :2] = 0.0
    weight = 0.02 * torch.randn((co, ci, 3, 3, 3), generator=gen, device=device)
    bias = 0.1 * torch.randn((co,), generator=gen, device=device)
    return x, types.SimpleNamespace(weight=weight, bias=bias), 2 if mode == "full" else 0


def k2_against_plain(x, p, time_pad: int, what: str):
    """K2 and its plain version on the same input, checking by the counters
    that the kernel ``kernel_for(x)`` names ran (for f32 also the split
    kernel), with phase 4's tolerances: f32 at atol 2e-4 / rtol 1e-4, bf16
    within one bf16 ulp of the larger value plus 2e-4. Returns (y, the
    plain output, |y - plain|, the largest excess over the bf16 bound, 0
    for f32)."""
    import torch
    from deepv_tpu_torch.ops import conv_igemm as cig

    kernel = cig.kernel_for(x)
    before = [getattr(cig, name) for name in K2_COUNTERS]
    y = cig.conv3d_igemm(x, p, time_pad)
    r = cig.conv3d_igemm_plain(x, p, time_pad)
    torch.cuda.synchronize()
    ran = [k for k, name, c0 in zip(("wgmma", "cl", "tf32x3", "split"), K2_COUNTERS, before)
           if getattr(cig, name) != c0]
    want = [kernel] if kernel != "tf32x3" else ["tf32x3", "split"]
    assert ran == want, f"{what}: expected the {kernel} kernel, ran {ran}"
    err = (y.float() - r.float()).abs()
    if x.dtype == torch.float32:
        torch.testing.assert_close(y, r, atol=2e-4, rtol=1e-4)
        return y, r, err, 0.0
    bound = bf16_ulp(torch.maximum(y.float().abs(), r.float().abs())) + 2e-4
    excess = float((err - bound).max())
    assert excess <= 0, f"{what} bf16: kernel vs plain beyond one ulp"
    return y, r, err, excess


def check_conv_igemm(device, results):
    """Phase 4: K2 against its plain version at every eligible conv class
    and at the edge shapes."""
    import torch
    import torch.nn.functional as F
    from deepv_tpu_torch.ops import conv_igemm as cig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # cuDNN f32 convs default to TF32
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows_out = []
    cases = [c + (1, False) for c in CONV_CASES] + list(CONV_EDGE_CASES)
    for layer, mode, ci, co, h, w, n, b, channels_last in cases:
        x32, p32, tp = conv_case_inputs(mode, ci, co, h, w, n, gen, device, b)
        if channels_last:
            x32 = x32.to(memory_format=torch.channels_last_3d)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            p = p32 if dtype == torch.float32 else type(p32)(
                weight=p32.weight.to(dtype), bias=p32.bias.to(dtype))
            kernel = cig.kernel_for(x)
            y, r, err, excess = k2_against_plain(x, p, tp, f"{layer} {mode}")
            split = None
            if kernel == "tf32x3":
                # the split kernel alone: both planes equal the plain split's
                xp = cig.split_tf32_cl(x)
                assert torch.equal(xp, cig.split_tf32_cl_plain(x)), f"{layer} {mode}: split"
                wp = cig.weight_planes(p.weight)
                assert torch.equal(wp, torch.stack(cig.tf32_split(
                    cig.relayout_weight(p.weight, torch.float32)))), f"{layer} {mode}: weight"
                bv = p.bias.contiguous()
                split = dict(ms=graph_ms(lambda: cig.split_tf32_cl(x), 3, 1),
                             plain_ms=cuda_time_ms(lambda: cig.split_tf32_cl_plain(x), 2, 1),
                             bound_ms=1e3 * 12 * x.numel() / PEAK_BYTES, bound_by="bytes",
                             kernel_ms=graph_ms(
                                 lambda: cig.conv3d_tf32x3_planes(xp, wp, bv, tp), 3, 1))
                del xp, wp
            assert tuple(y.shape) == (b, co, n, h, w), tuple(y.shape)
            # F.conv3d on the same input (full mode: the zero frames prepended
            # outside the timed call); a yardstick the igemm path never calls
            xl = F.pad(x, (0, 0, 0, 0, tp, 0)) if tp else x
            lib = F.conv3d(xl, p.weight, p.bias, padding=(0, 1, 1))
            lib_err = float((lib.float() - r.float()).abs().max())
            del lib
            big = 2 * 27 * ci * co * n * h * w > 1e12
            iters = 2 if big else 5
            ms = graph_ms(lambda: cig.conv3d_igemm(x, p, tp), iters, 1)
            if kernel == "wgmma" or (kernel == "cl" and cig._tma_strides_cl(x) is not None):
                # the K-major weight, no copy of x
                layout = lambda: cig.relayout_weight(p.weight, x.dtype)
            elif kernel == "cl":                 # the K-major weight and a channels-last x
                layout = lambda: (cig.relayout_weight(p.weight, x.dtype),
                                  x.permute(0, 2, 3, 4, 1).contiguous())
            else:                                # the split kernel on x and the weight
                layout = lambda: (cig.split_tf32_cl(x), cig.weight_planes(p.weight))
            layout_ms = graph_ms(layout, 5, 1)
            plain_ms = cuda_time_ms(lambda: cig.conv3d_igemm_plain(x, p, tp), 1, 1)
            library_ms = graph_ms(
                lambda: F.conv3d(xl, p.weight, p.bias, padding=(0, 1, 1)), iters, 1)
            # the taps this input needs: in full mode the first output frames'
            # taps in the causal past read only padding, and K2 skips them
            taps = sum(9 * (3 - max(0, tp - to)) for to in range(n))
            flops = 2 * taps * ci * co * b * h * w
            esize = x.element_size()
            nbytes = (x.numel() + p.weight.numel() + co + y.numel()) * esize
            # f32's least time is the 3xTF32 route's: three TF32 products a
            # product at the TF32 peak; the FMA rate's bound beside it
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
            t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
            plan = cig.tile_plan(b, co, n, h, w, sms, channels_last=kernel != "wgmma")
            row = dict(layer=layer, mode=mode, ci=ci, co=co, h=h, w=w, frames=n, batch=b,
                       edge=layer.startswith("edge"), kernel=kernel,
                       plan=dict(bn=plan.bn, channels_last=plan.channels_last,
                                 grid=plan.grid, ctas=plan.ctas),
                       dtype=str(dtype).split(".")[-1], time_pad=tp,
                       max_abs_err=float(err.max()), ulp_excess=excess,
                       cudnn_vs_plain_max_abs=lib_err, ms=ms, layout_ms=layout_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flops=flops, bytes=nbytes, tflops=flops / (ms * 1e-3) / 1e12,
                       library_tflops=flops / (library_ms * 1e-3) / 1e12)
            if split is not None:
                row.update(kernel_ms=split.pop("kernel_ms"), split=split,
                           bound_fma_ms=1e3 * max(flops / PEAK_F32_FLOPS, t_bytes),
                           share_of_bound=row["bound_ms"] / ms)
            rows_out.append(row)
            log("conv_igemm", json.dumps(row))
            del y, r, x, xl
        del x32, p32
        torch.cuda.empty_cache()
    results["conv_igemm_shapes"] = rows_out
    return rows_out


def batch2_decoder_cases(cases):
    """(layer, mode, ci, co, h, w, output frames) of each distinct decoder
    class of ``cases`` in every causal mode the batched end-of-chunk decode
    runs it in at batch 2: init (chunk 1's first window, the first frame of
    each priming warm), cont (every other window) and, for the last up
    block's convs, prime (the priming tail; conv_out is not primed)."""
    out, seen = [], set()
    for layer, _, ci, co, h, w, n in cases:
        if not layer.startswith("decoder") or (ci, co, h, w) in seen:
            continue
        seen.add((ci, co, h, w))
        modes = ("init", "cont") + (("prime",) if layer.startswith("decoder up block 3") else ())
        out += [(layer, mode, ci, co, h, w, n) for mode in modes]
    return out


def check_conv_igemm_batch2(device, results):
    """Phase 4 at batch 2: K2 against its plain version at every eligible
    decoder class of the full-width VAE in each mode the batched decode runs
    it in (``batch2_decoder_cases``), bf16, with phase 4's tolerances and
    the kernel that ran checked; also whether the kernel gives the second
    stream alone the same bits (printed), and its time."""
    import torch
    from deepv_tpu_torch.ops import conv_igemm as cig

    gen = torch.Generator(device=device)
    gen.manual_seed(24)
    rows = []
    for layer, mode, ci, co, h, w, n in batch2_decoder_cases(CONV_CASES):
        x32, p32, tp = conv_case_inputs(mode, ci, co, h, w, n, gen, device, 2)
        x = x32.to(torch.bfloat16)
        p = type(p32)(weight=p32.weight.to(torch.bfloat16), bias=p32.bias.to(torch.bfloat16))
        del x32, p32
        y, r, err, excess = k2_against_plain(x, p, tp, f"{layer} {mode} batch 2")
        assert tuple(y.shape) == (2, co, n, h, w), tuple(y.shape)
        alone = torch.equal(cig.conv3d_igemm(x[1:2], p, tp), y[1:2])
        row = dict(layer=layer, mode=mode, ci=ci, co=co, h=h, w=w, frames=n, batch=2,
                   kernel=cig.kernel_for(x), max_abs_err=float(err.max()), ulp_excess=excess,
                   second_stream_alone_bit_equal=alone,
                   ms=graph_ms(lambda: cig.conv3d_igemm(x, p, tp), 2, 1))
        rows.append(row)
        log("conv_igemm batch 2", json.dumps(row))
        del x, p, y, r, err
        torch.cuda.empty_cache()
    results["conv_igemm_batch2"] = rows
    return rows


def eligible_convs(vcfg):
    """K2-eligible convs per call, from the code: every 3x3x3 conv of the
    resnets, mid blocks and up-samplers has ci, co multiples of 128 at full
    width (conv_in, conv_out, 1x1 shortcuts and strided down-samplers are
    not eligible). Returns (decoder window, decoder_front window of the
    priming warm, priming tail, encoder window)."""
    dec_layers, enc_layers = vcfg.decoder_layers_per_block, vcfg.encoder_layers_per_block
    tail = 2 * dec_layers[-1]
    front = 4 + sum(2 * n + int(up) + int(tup) for n, up, tup in zip(
        dec_layers[:-1], vcfg.decoder_spatial_up_sample, vcfg.decoder_temporal_up_sample))
    encoder = 4 + sum(2 * n for n in enc_layers)
    counts = (front + tail, front, tail, encoder)
    assert counts == (34, 28, 6, 20), counts
    return counts


def expected_conv_launches(pipe, stats, boundaries: int) -> int:
    """K2 launches of one igemm rollout, from the code (``eligible_convs``)."""
    from deepv_tpu_torch.models.vae import _split_windows

    vcfg, pcfg = pipe.vcfg, pipe.cfg
    window, front, tail, encoder = eligible_convs(vcfg)
    # streamed decode: one latent unit of rgb and one of disparity per phase
    decoder_windows = 2 * stats["stream_decode"]["count"]
    # priming: rgb and disparity, one front window per carried latent frame
    t_down = 2 ** sum(vcfg.encoder_temporal_down_sample)
    carried = 1 + (pcfg.num_input_image - 1) // t_down
    primes = stats["prime"]["count"]
    assert primes == boundaries, (primes, boundaries)
    # encoder: the first image (1 frame, full), then per boundary the carried
    # rgb and disparity clips (chunked into windows) and the history frame's
    # rgb and disparity (1 frame each)
    clip_windows = len(_split_windows(pcfg.num_input_image, pipe.encode_window))
    encoder_windows = 1 + boundaries * (2 * clip_windows + 2)
    return (window * decoder_windows + 2 * primes * (front * carried + tail)
            + encoder * encoder_windows)


def run_igemm_path(device, results, ref_frames):
    """Phase 7: the full-width rollout with VAEConfig(conv_impl="igemm")."""
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig, create_model_config
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.io.weights import random_params
    from deepv_tpu_torch.ops import causal_conv
    from deepv_tpu_torch.pipeline import InferencePipeline

    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    mcfg, vcfg = MMDiTConfig(), VAEConfig(conv_impl="igemm")
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    pipe = InferencePipeline(cfg, mcfg, vcfg,
                             random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0,
                                           device=device),
                             embeds, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # output frames per conv class, read from the calls (the kernel count
    # itself stays the wrapper's)
    frames_by_class = {}
    orig = causal_conv.conv3d_igemm

    def spy(x, p, time_pad=2):
        key = (x.shape[1], p.weight.shape[0], x.shape[3], x.shape[4])
        frames_by_class[key] = frames_by_class.get(key, 0) + (
            x.shape[0] * (x.shape[2] + time_pad - 2))
        return orig(x, p, time_pad)

    causal_conv.conv3d_igemm = spy
    try:
        summary, out, conv_launches = drive_rollout(pipe, setup_s)
    finally:
        causal_conv.conv3d_igemm = orig
    frames = out["pred_img"]
    assert summary["forwards"] == FORWARDS, summary["forwards"]
    stats = pipe.timer.stats()
    expected = expected_conv_launches(pipe, stats, len(summary["history_index"]))
    k2 = conv_launches["launches"] + conv_launches["cl_launches"]
    assert k2 == expected, f"K2 launched {k2} times ({conv_launches}), expected {expected}"
    # the cl path: the mid-block resnet after the attention of every
    # full-mode encoder call (the first image, each boundary's history rgb
    # and disparity frames)
    expected_cl = 1 + 2 * len(summary["history_index"])
    assert conv_launches["cl_launches"] == expected_cl, (
        f"the cl path launched {conv_launches['cl_launches']} times, expected {expected_cl}")
    summary["expected_conv_igemm_launches"] = expected
    summary["expected_conv_igemm_cl_launches"] = expected_cl
    summary["conv_frames_by_class"] = {f"{ci}->{co} @{h}x{w}": n
                                       for (ci, co, h, w), n in frames_by_class.items()}
    summary["max_abs_diff_vs_main_path"] = float((frames.float() - ref_frames.float()).abs().max())
    log("igemm path:", json.dumps(summary))
    results["igemm_path"] = summary
    return pipe, conv_launches, frames_by_class


def check_decode(pipe, device, results):
    """Phase 8: one full-width latent stream decoded with "igemm" and "xla";
    the f32 igemm decode's K2 launches counted. Returns them."""
    import copy
    import torch
    from deepv_tpu_torch.config import VAEConfig
    from deepv_tpu_torch.models.vae import _dec_prime_warm, _dec_window
    from deepv_tpu_torch.ops import causal_conv
    from deepv_tpu_torch.ops import conv_igemm as cig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dec_bf16 = pipe.vae.decoder
    dec_f32 = copy.deepcopy(dec_bf16).float()
    g = torch.Generator(device=device)
    g.manual_seed(13)
    z = torch.randn((1, 16, 5, HEIGHT // 8, WIDTH // 8), generator=g, device=device)

    def decode(dec, impl, dtype):
        """init window, cont window, then caches primed on 3 latents and a
        cont window through them"""
        cfg = VAEConfig(conv_impl=impl)
        zz = z.to(dtype)
        with torch.inference_mode():
            y0, cache = _dec_window(cfg, dec, zz[:, :, :1], None, "init")
            y1, _ = _dec_window(cfg, dec, zz[:, :, 1:2], cache, "cont")
            primed = _dec_prime_warm(cfg, dec, zz[:, :, 1:4])
            y2, _ = _dec_window(cfg, dec, zz[:, :, 4:5], primed, "cont")
            return torch.cat([y0, y1, y2], dim=2).float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    out = {}
    f32_counts = None
    orig = causal_conv.conv3d_igemm
    for name, dec, dtype in (("f32", dec_f32, torch.float32), ("bf16", dec_bf16, torch.bfloat16)):
        for impl in ("igemm", "xla"):
            counted = impl == "igemm" and dtype == torch.float32
            dispatches = []
            if counted:
                # the f32 decode's path: counts set to 0 just before, read
                # just after; a spy counts the dispatches to K2
                for counter in K2_COUNTERS:
                    setattr(cig, counter, 0)
                causal_conv.conv3d_igemm = lambda x, p, time_pad=2: (
                    dispatches.append(1), orig(x, p, time_pad))[1]
            t0 = time.perf_counter()
            try:
                out[impl, name] = decode(dec, impl, dtype)
                torch.cuda.synchronize()
            finally:
                causal_conv.conv3d_igemm = orig
            if counted:
                f32_counts = {counter: getattr(cig, counter) for counter in K2_COUNTERS}
                f32_counts["dispatches"] = len(dispatches)
            log(f"decode check: {impl} {name} {out[impl, name].shape[2]} frames in "
                f"{time.perf_counter() - t0:.1f} s")
    # three decoder windows and a priming warm over 3 latent frames (three
    # decoder_front windows and the tail): tf32x3 once per eligible conv,
    # split_tf32_cl twice (x, the weight), nothing else of K2
    window, front, tail, _ = eligible_convs(VAEConfig())
    expected = 3 * window + 3 * front + tail
    log(f"decode check: the f32 igemm decode's K2 launches {json.dumps(f32_counts)}, "
        f"expected tf32x3 {expected}")
    assert f32_counts == dict(launches=0, cl_launches=0, f32_launches=expected,
                              split_launches=2 * expected, dispatches=expected), f32_counts
    rel_f32 = rel(out["igemm", "f32"], out["xla", "f32"])
    rel_bf16 = rel(out["igemm", "bf16"], out["xla", "bf16"])
    gap = rel(out["xla", "bf16"], out["xla", "f32"])
    row = dict(frames=out["xla", "f32"].shape[2], rel_l2_f32=rel_f32, rel_l2_bf16=rel_bf16,
               rel_l2_bf16_vs_f32_xla=gap,
               rel_l2_bf16_igemm_vs_f32_xla=rel(out["igemm", "bf16"], out["xla", "f32"]))
    log("decode check:", json.dumps(row))
    results["decode_check"] = row
    assert all(bool(torch.isfinite(v).all()) for v in out.values()), "non-finite decode"
    assert rel_f32 <= 1e-4, f"f32 decode: igemm vs xla relative L2 {rel_f32}"
    assert rel_bf16 <= 2 * gap, f"bf16 decode: igemm vs xla {rel_bf16}, bf16 vs f32 {gap}"
    results["decode_check"]["f32_igemm_launches"] = f32_counts
    del dec_f32, out
    return f32_counts


def taps_needed(mode: str, n: int) -> int:
    """Taps of n output frames that read real input: in full mode the first
    two frames' taps in the causal past read only the zero frames, which K2
    and K3 skip."""
    tp = 2 if mode == "full" else 0
    return sum(9 * (3 - max(0, tp - to)) for to in range(n))


def ties_input(b: int, ci: int, t: int, h: int, w: int, gen, device):
    """x whose amax is 127, so sx = 1 and x / sx = x: values 127 and halves
    (+-0.5, +-1.5, +-2.5, +-126.5) that quantise only by rounding half to
    even, with integers between them; all exact in bf16."""
    import torch
    vals = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5, 3.0, -4.0],
                        device=device)
    x = vals[torch.randint(0, len(vals), (b, ci, t, h, w), generator=gen, device=device)]
    x.view(-1)[0] = 127.0
    return x


def check_conv_int8(device, results):
    """Phase 9: K3's two kernels against their plain versions at every
    int8-eligible conv class of the fast rollout, at the edge case and at
    the ties case: the quantise kernel's x8 and sx byte-equal to
    ``quantize_input_k3``'s, the conv kernel's int32 accumulators exactly
    equal, the bf16 output within one bf16 ulp. Times the whole call, its
    quantise step (the amax and the quantise kernel), the conv kernel alone,
    the plain version and cuDNN's bf16 conv, beside the least times."""
    import torch
    import torch.nn.functional as F
    from deepv_tpu_torch.ops import conv_int8 as ci8

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    rows_out = []
    cases = [c + (1,) for c in K3_CASES] + list(K3_EDGE_CASES)
    for layer, mode, ci, co, h, w, n, b in cases:
        x32, p32, tp = conv_case_inputs(mode, ci, co, h, w, n, gen, device, b)
        if layer.startswith("ties"):
            x32 = ties_input(*x32.shape, gen, device)
        dtype = torch.float32 if "float32" in layer else torch.bfloat16
        x = x32.to(dtype)
        del x32
        conv = torch.nn.Conv3d(ci, co, 3, device=device, dtype=dtype)
        conv.requires_grad_(False)
        conv.weight.copy_(p32.weight)
        conv.bias.copy_(p32.bias)
        ci8.quantize_conv_weights(conv)
        t_in = x.shape[2]
        pl = ci8.plan(ci, co, h, w, b, n)
        assert pl.kernel == ("packed" if ci <= 16 else "wgmma"), (layer, pl)
        counts = (ci8.launches, ci8.packed_launches, ci8.quantize_launches)
        x8k, sxk = ci8.quantize_k3(x)
        acc = ci8.conv3d_int8_accumulators(x, conv, tp)
        y = ci8.conv3d_int8(x, conv, tp)
        wg, packed, quant = (ci8.launches - counts[0], ci8.packed_launches - counts[1],
                             ci8.quantize_launches - counts[2])
        assert quant == 3 and (wg, packed) == ((2, 0) if pl.kernel == "wgmma" else (0, 2)), (
            f"{layer} {mode}: plan {pl.kernel}, launches wgmma {wg}, packed {packed}, "
            f"quantise {quant}")
        x8p, sxp = ci8.quantize_input_k3(x)
        torch.cuda.synchronize()
        x8_bad = int((x8k != x8p).sum())
        assert x8_bad == 0 and torch.equal(sxk, sxp), (
            f"{layer} {mode}: {x8_bad} quantised inputs differ from the plain version's")
        del x8p
        x8, _ = ci8.quantize_input(x)
        ref_acc = ci8.accumulate_plain(x8, conv.weight_int8, tp)
        del x8
        r = ci8.conv3d_int8_plain(x, conv, tp)
        torch.cuda.synchronize()
        assert tuple(y.shape) == (b, co, n, h, w), tuple(y.shape)
        n_bad = int((acc != ref_acc).sum())
        assert n_bad == 0, f"{layer} {mode}: {n_bad} int32 accumulators differ"
        del ref_acc
        padded_wgmma_ms = None
        if layer == "encoder conv_in" and mode == "init" and n == 2:
            # conv_in's work on the wgmma kernel: 128 -> 128 whose input and
            # weight channels past the third are zero (same sx and sw, so the
            # same sums); timed beside the packed kernel
            xw = torch.zeros((b, 128) + tuple(x.shape[2:]), dtype=dtype, device=device)
            xw[:, :ci] = x
            cw = torch.nn.Conv3d(128, co, 3, device=device, dtype=dtype).requires_grad_(False)
            cw.weight.zero_()
            cw.weight[:, :ci] = conv.weight
            cw.bias.copy_(conv.bias)
            ci8.quantize_conv_weights(cw)
            assert ci8.plan(128, co, h, w, b, n).kernel == "wgmma"
            x8w, sxw = ci8.quantize_k3(xw)
            accw = ci8.conv_k3(x8w, sxw, cw, tp, dtype, acc_only=True)
            torch.cuda.synchronize()
            assert torch.equal(accw, acc), "conv_in on the wgmma kernel: other int32 sums"
            padded_wgmma_ms = graph_ms(lambda: ci8.conv_k3(x8w, sxw, cw, tp, dtype), 10, 1)
            del xw, cw, x8w, accw
        del acc
        err = (y.float() - r.float()).abs()
        excess = float((err - bf16_ulp(torch.maximum(y.float().abs(), r.float().abs()))).max())
        assert excess <= 0, f"{layer} {mode}: K3 vs plain beyond one bf16 ulp"
        assert dtype == torch.bfloat16 or float(err.max()) == 0.0, (
            f"{layer} {mode}: the f32 output differs from the plain version's")
        xl = F.pad(x, (0, 0, 0, 0, tp, 0)) if tp else x
        lib_err = float((F.conv3d(xl, conv.weight, conv.bias, padding=(0, 1, 1)).float()
                         - r.float()).abs().max())
        ms = graph_ms(lambda: ci8.conv3d_int8(x, conv, tp), 5, 1)
        quantise_ms = graph_ms(lambda: ci8.quantize_k3(x), 5, 1)
        quantise_kernel_ms = graph_ms(lambda: ci8.quantize_k3(x, sxk), 5, 1)
        kernel_ms = graph_ms(lambda: ci8.conv_k3(x8k, sxk, conv, tp, x.dtype), 10, 1)
        quantise_plain_ms = cuda_time_ms(lambda: ci8.quantize_input_k3(x), 2, 1)
        plain_ms = cuda_time_ms(lambda: ci8.conv3d_int8_plain(x, conv, tp), 1, 0)
        library_ms = graph_ms(
            lambda: F.conv3d(xl, conv.weight, conv.bias, padding=(0, 1, 1)), 5, 1)
        ops = 2 * taps_needed(mode, n) * ci * co * b * h * w
        # whole call: bf16 x in (the amax and the quantise read it; counted
        # once), int8 weight, scales and bias, bf16 y out; the conv kernel
        # alone reads x8 instead of x; the quantise kernel reads x, writes x8.
        # x8 and the weight count at their ci real channels: the zero
        # channels up to ci_pad are the kernels' layout, not the function's
        w_bytes = conv.weight_int8.numel() + 8 * co
        x8_bytes = x8k.numel() // x8k.shape[-1] * ci
        whole_bytes = (x.numel() + y.numel()) * x.element_size() + w_bytes
        kernel_bytes = x8_bytes + w_bytes + y.numel() * y.element_size()
        quantise_bytes = x.numel() * x.element_size() + x8_bytes + 4
        bound = lambda nbytes, nops: max(nops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        by = lambda nbytes, nops: "operations" if nops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES \
            else "bytes"
        row = dict(layer=layer, mode=mode, ci=ci, co=co, h=h, w=w, frames=n, batch=b, t_in=t_in,
                   edge=not layer.startswith(("decoder", "encoder")), time_pad=tp,
                   dtype=str(dtype).replace("torch.", ""),
                   route=pl.kernel, plan=dict(bn=pl.bn, bm=pl.bm, mb=pl.mb, segs=pl.segs,
                                              grid=list(pl.grid)),
                   padded_wgmma_ms=padded_wgmma_ms,
                   x8_mismatches=x8_bad, acc_mismatches=n_bad,
                   max_abs_err=float(err.max()), ulp_excess=excess,
                   cudnn_bf16_vs_plain_max_abs=lib_err, ms=ms, quantise_ms=quantise_ms,
                   quantise_kernel_ms=quantise_kernel_ms, kernel_ms=kernel_ms,
                   plain_ms=plain_ms, quantise_plain_ms=quantise_plain_ms,
                   library_ms=library_ms,
                   bound_ms=bound(whole_bytes, ops), bound_by=by(whole_bytes, ops),
                   kernel_bound_ms=bound(kernel_bytes, ops), kernel_bound_by=by(kernel_bytes, ops),
                   quantise_bound_ms=bound(quantise_bytes, 0),
                   ops=ops, bytes=whole_bytes, tops=ops / (ms * 1e-3) / 1e12,
                   kernel_tops=ops / (kernel_ms * 1e-3) / 1e12,
                   quantise_tb_s=quantise_bytes / (quantise_kernel_ms * 1e-3) / 1e12)
        rows_out.append(row)
        log("conv_int8", json.dumps(row))
        if padded_wgmma_ms is not None:
            log(f"K3 conv_in ({mode}, {n} frames): packed kernel {kernel_ms:.4f} ms, the same "
                f"work on the wgmma kernel with ci padded to 128 {padded_wgmma_ms:.4f} ms")
        del y, r, x, xl, conv, x8k
        torch.cuda.empty_cache()
    results["conv_int8_shapes"] = rows_out
    return rows_out


def check_conv_int8_batch2(device, results):
    """Phase 9 at batch 2: K3 against its plain version at every
    int8-eligible decoder class in each mode the batched decode runs it in
    (``batch2_decoder_cases``), the second stream 3x the first's amplitude:
    one sx for the whole batch (the amax of both streams, above the first
    stream's own), x8 and sx byte-equal to the plain quantise step's, the
    int32 sums exact, the bf16 output within one bf16 ulp, and the route
    and launches checked as in phase 9."""
    import torch
    from deepv_tpu_torch.ops import conv_int8 as ci8

    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    rows = []
    for layer, mode, ci, co, h, w, n in batch2_decoder_cases(K3_CASES):
        x32, p32, tp = conv_case_inputs(mode, ci, co, h, w, n, gen, device, 2)
        x32[1] *= 3.0
        x = x32.to(torch.bfloat16)
        del x32
        conv = torch.nn.Conv3d(ci, co, 3, device=device, dtype=torch.bfloat16)
        conv.requires_grad_(False)
        conv.weight.copy_(p32.weight)
        conv.bias.copy_(p32.bias)
        ci8.quantize_conv_weights(conv)
        pl = ci8.plan(ci, co, h, w, 2, n)
        counts = (ci8.launches, ci8.packed_launches, ci8.quantize_launches)
        x8k, sxk = ci8.quantize_k3(x)
        acc = ci8.conv3d_int8_accumulators(x, conv, tp)
        y = ci8.conv3d_int8(x, conv, tp)
        launched = (ci8.launches - counts[0], ci8.packed_launches - counts[1],
                    ci8.quantize_launches - counts[2])
        assert launched == ((2, 0, 3) if pl.kernel == "wgmma" else (0, 2, 3)), (
            f"{layer} {mode} batch 2: plan {pl.kernel}, launches {launched}")
        x8p, sxp = ci8.quantize_input_k3(x)
        x8_bad = int((x8k != x8p).sum())
        assert x8_bad == 0 and torch.equal(sxk, sxp), f"{layer} {mode} batch 2: x8 or sx"
        per_stream = [ci8.input_scale(x[i:i + 1]) for i in range(2)]
        assert torch.equal(sxk.reshape(()), torch.maximum(*per_stream).reshape(())) and bool(
            per_stream[0] < sxk), f"{layer} {mode} batch 2: sx is not the whole batch's"
        del x8p
        x8, _ = ci8.quantize_input(x)
        n_bad = int((acc != ci8.accumulate_plain(x8, conv.weight_int8, tp)).sum())
        assert n_bad == 0, f"{layer} {mode} batch 2: {n_bad} int32 accumulators differ"
        r = ci8.conv3d_int8_plain(x, conv, tp)
        assert tuple(y.shape) == (2, co, n, h, w), tuple(y.shape)
        err = (y.float() - r.float()).abs()
        excess = float((err - bf16_ulp(torch.maximum(y.float().abs(), r.float().abs()))).max())
        assert excess <= 0, f"{layer} {mode} batch 2: K3 vs plain beyond one bf16 ulp"
        row = dict(layer=layer, mode=mode, ci=ci, co=co, h=h, w=w, frames=n, batch=2,
                   route=pl.kernel, sx=float(sxk), sx_per_stream=[float(v) for v in per_stream],
                   x8_mismatches=x8_bad, acc_mismatches=n_bad, max_abs_err=float(err.max()),
                   ulp_excess=excess, ms=graph_ms(lambda: ci8.conv3d_int8(x, conv, tp), 2, 1))
        rows.append(row)
        log("conv_int8 batch 2", json.dumps(row))
        del x, conv, x8k, x8, acc, y, r, err
        torch.cuda.empty_cache()
    results["conv_int8_batch2"] = rows
    return rows


def check_linear_int8(device, results):
    """Phase 10: the W8A8 linear at the stage-2 shapes: the int32 product
    exact, and the times of the whole call, its quantise, ``_int_mm`` and
    dequant parts, beside bf16 ``F.linear`` (a yardstick)."""
    import torch
    import torch.nn.functional as F
    from deepv_tpu_torch.ops import linear_int8 as li8

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(23)
    # shapes outside torch._int_mm's CUDA rule, zero-padded by int_mm: the
    # 64x64 tiny rollout's 16-row stage-0 product, odd k and n
    padded = []
    for m, k, n in PADDED_INT_MM_CASES:
        a = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        before = li8.calls
        acc = li8.int_mm(a, bt.t())
        assert li8.calls - before == 1 and acc.dtype == torch.int32
        exact = torch.matmul(a.double(), bt.double().t())
        assert tuple(acc.shape) == (m, n) and torch.equal(acc.double(), exact), (
            f"padded int_mm {m}x{k}x{n} is not exact")
        padded.append(dict(m=m, k=k, n=n, exact=True))
    log("int_mm, padded:", json.dumps(padded))
    results["int_mm_padded"] = padded
    rows_out = []
    for name, m, k, n in LINEAR_CASES:
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        bound = (6.0 / (k + n)) ** 0.5                     # the rollout's xavier init
        wf = (torch.rand((n, k), generator=gen, device=device) * 2 - 1) * bound
        lin = torch.nn.Linear(k, n, device=device, dtype=torch.bfloat16).requires_grad_(False)
        lin.weight.copy_(wf)
        lin.bias.zero_()
        p = torch.nn.Module()
        p.weight_int8, p.weight_scale = li8.quantize_linear(lin.weight)
        p.bias = lin.bias
        x8, sx = li8.quantize_tokens(x)
        acc = li8.int_mm(x8, p.weight_int8.t())
        exact = torch.matmul(x8.double(), p.weight_int8.double().t())
        assert torch.equal(acc.double(), exact), f"{name}: _int_mm is not exact"
        y = li8.linear_int8(x, p)
        ref = F.linear(x.float(), lin.weight.float())
        rel = float((y.float() - ref).norm() / ref.norm())
        assert rel < 0.05, f"{name}: int8 linear {rel} relative L2 off the f32 product"
        row = dict(name=name, rows=m, k=k, n=n, rel_l2_vs_f32=rel,
                   ms=cuda_time_ms(lambda: li8.linear_int8(x, p), 20),
                   quantise_ms=cuda_time_ms(lambda: li8.quantize_tokens(x), 20),
                   int_mm_ms=cuda_time_ms(lambda: torch._int_mm(x8, p.weight_int8.t()), 20),
                   dequant_ms=cuda_time_ms(lambda: (acc.float() * sx * p.weight_scale
                                                    + p.bias.float()).to(x.dtype), 20),
                   bf16_linear_ms=cuda_time_ms(lambda: F.linear(x, lin.weight, lin.bias), 20))
        ops = 2 * m * k * n
        row.update(int_mm_tops=ops / (row["int_mm_ms"] * 1e-3) / 1e12,
                   bf16_tflops=ops / (row["bf16_linear_ms"] * 1e-3) / 1e12,
                   int8_bound_ms=1e3 * ops / PEAK_INT8_OPS)
        rows_out.append(row)
        log("linear_int8", json.dumps(row))
    results["linear_int8_shapes"] = rows_out


def eight_bit_gap(frames, ref):
    """Mean and 95th percentile of |frames - ref| in 8-bit pixel units."""
    import torch
    to8 = lambda f: (f.float() * 0.5 + 0.5).clamp(0, 1) * 255
    d = (to8(frames) - to8(ref)).abs().flatten()
    return float(d.mean()), float(torch.sort(d).values[int(0.95 * (d.numel() - 1))])


def run_fast_path(device, results, ref_frames):
    """Phase 11: the --fast preset through run.load_pipeline: flow caching
    "skip_odd", the W8A8 block linears and VAEConfig(conv_impl="int8"), on
    phase 5's image, prompt, seed and weights. Counts set to 0 just before and
    read just after: K1 once per block of the 108 forwards skip_odd runs,
    K2 never, K3 once per dispatch to the int8 conv, ``_int_mm`` once per
    quantised linear of every forward. Returns the summary, the int8 convs'
    output frames by class and the rollout's frames on the host."""
    import torch
    from deepv_tpu_torch.config import create_model_config
    from deepv_tpu_torch.models.mmdit import Int8Linear
    from deepv_tpu_torch.ops import causal_conv
    from deepv_tpu_torch.ops import conv_int8 as ci8
    from deepv_tpu_torch.run import load_pipeline

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    pipe = load_pipeline("none", cfg, random_weights=True, dtype=torch.bfloat16,
                         device=device, seed=0, fast=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    quantised = sum(isinstance(m, Int8Linear) for m in pipe.mmdit.modules())
    frames_by_class, calls, narrow = {}, [0], [0]
    orig = causal_conv.conv3d_int8

    def spy(x, p, time_pad=2):
        key = (x.shape[1], p.weight.shape[0], x.shape[3], x.shape[4])
        frames = x.shape[0] * (x.shape[2] + time_pad - 2)
        frames_by_class[key] = frames_by_class.get(key, 0) + frames
        calls[0] += 1
        narrow[0] += x.shape[1] <= ci8.PACKED_MAX_CI        # conv_in: the packed kernel
        return orig(x, p, time_pad)

    causal_conv.conv3d_int8 = spy
    try:
        summary, out, conv_launches = drive_rollout(pipe, setup_s)
    finally:
        causal_conv.conv3d_int8 = orig
    rollout_frames_by_class = dict(frames_by_class)     # the spy counts the served session too
    frames = out["pred_img"]
    mcfg = pipe.mcfg
    assert summary["forwards"] == 108, f"skip_odd ran {summary['forwards']} forwards, not 108"
    assert summary["attention_launches"] == 108 * mcfg.num_layers == 2592
    assert not any(conv_launches.values()), f"the int8 path launched K2: {conv_launches}"
    assert summary["conv_int8_launches"] == calls[0] == FAST_CONV_INT8_CALLS, (
        summary["conv_int8_launches"], calls[0])
    assert summary["quantize_k3_launches"] == calls[0], (
        f"the quantise kernel launched {summary['quantize_k3_launches']} times, "
        f"not once per int8 conv ({calls[0]})")
    assert summary["conv_int8_packed_launches"] == narrow[0] > 0, (
        f"the packed kernel launched {summary['conv_int8_packed_launches']} times, "
        f"not once per conv_in call ({narrow[0]})")
    assert summary["conv_int8_wgmma_launches"] == calls[0] - narrow[0], summary
    assert quantised == 12 * (mcfg.num_layers - 1) + 9, quantised
    assert summary["int_mm_calls"] == summary["forwards"] * quantised, summary["int_mm_calls"]
    mean8, p95 = eight_bit_gap(frames, ref_frames)
    summary.update(setup_peak_gib=setup_peak, quantised_linears=quantised,
                   expected_conv_int8_launches=calls[0],
                   expected_int_mm_calls=summary["forwards"] * quantised,
                   conv_int8_frames_by_class={f"{ci}->{co} @{h}x{w}": n for (ci, co, h, w), n
                                              in rollout_frames_by_class.items()},
                   gap_vs_main_path_8bit_mean=mean8, gap_vs_main_path_8bit_p95=p95)

    # the same preset served, one unit a step
    from deepv_tpu_torch import serve
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.ops import conv_igemm as cig
    from deepv_tpu_torch.ops import linear_int8 as li8

    batch = rollout_batch()
    actions = serve.InteractiveSession.actions_from_prompt_list(pipe.cfg, list(batch["prompt"]))
    calls[0], narrow[0], forwards, steps = 0, 0, 0, []
    att.launches = att.f32_launches = att.bwd_launches = 0
    for name in K2_COUNTERS:
        setattr(cig, name, 0)
    ci8.launches = ci8.packed_launches = ci8.quantize_launches = li8.calls = 0
    causal_conv.conv3d_int8 = spy
    try:
        t = time.perf_counter()
        sess = serve.InteractiveSession(pipe)
        sess.start(batch["img"], seed=666)
        for action in actions:
            steps.append(sess.step(action))
            forwards += sum(map(sum, sess.recompute_log))
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t
    finally:
        causal_conv.conv3d_int8 = orig
    served = dict(wall_s=served_s, forwards=forwards, attention_launches=att.launches,
                  attention_f32_launches=att.f32_launches,
                  attention_bwd_launches=att.bwd_launches,
                  conv_igemm_launches={name: getattr(cig, name) for name in K2_COUNTERS},
                  conv_int8_launches=ci8.launches + ci8.packed_launches,
                  conv_int8_packed_launches=ci8.packed_launches,
                  quantize_k3_launches=ci8.quantize_launches, int_mm_calls=li8.calls,
                  expected_conv_int8_launches=calls[0], expected_packed_launches=narrow[0])
    rgb = torch.cat([s["rgb"] for s in steps], dim=2)
    disp = torch.cat([s["disparity"] for s in steps], dim=2)
    assert torch.equal(rgb, frames) and torch.equal(disp, out["pred_disparity"]), (
        "the served --fast session's frames differ from the --fast rollout's")
    assert forwards == summary["forwards"], (forwards, summary["forwards"])
    assert served["attention_launches"] == forwards * mcfg.num_layers, served
    assert served["attention_f32_launches"] == served["attention_bwd_launches"] == 0, served
    assert not any(served["conv_igemm_launches"].values()), served
    assert served["conv_int8_launches"] == served["quantize_k3_launches"] == calls[0] \
        > FAST_CONV_INT8_CALLS, served
    assert served["conv_int8_packed_launches"] == narrow[0] \
        > summary["conv_int8_packed_launches"], served
    assert served["int_mm_calls"] == forwards * quantised, served
    summary["served"] = served
    del sess, steps, rgb, disp
    log("fast path:", json.dumps(summary))
    results["fast_path"] = summary
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return summary, rollout_frames_by_class, frames.cpu()


def run_adaptive_boundary_path(device, results, ref_frames):
    """Phase 12: InferencePipeline with flow_cache="adaptive:0.5",
    reuse_decoder_cache and carry_latents, on phase 5's image, prompt, seed
    and weights; K1 once per block of every forward the pipeline records as
    run. Returns the summary and chunk 1's frames on the host."""
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig, create_model_config
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.io.weights import random_params
    from deepv_tpu_torch.pipeline import InferencePipeline

    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    mcfg, vcfg = MMDiTConfig(), VAEConfig()
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    pipe = InferencePipeline(cfg, mcfg, vcfg,
                             random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0,
                                           device=device),
                             embeds, dtype=torch.bfloat16, device=device,
                             flow_cache="adaptive:0.5", reuse_decoder_cache=True,
                             carry_latents=True)
    torch.cuda.synchronize()
    summary, out, conv_launches = drive_rollout(pipe, time.perf_counter() - t0)
    frames = out["pred_img"]
    assert not any(conv_launches.values()), conv_launches
    assert (summary["conv_int8_launches"] == summary["quantize_k3_launches"]
            == summary["int_mm_calls"] == 0), summary
    assert "prime" not in summary["phases_s"], "cache reuse must not prime"
    mean8, p95 = eight_bit_gap(frames, ref_frames)
    summary.update(recompute_log=[list(r) for r in pipe.recompute_log],
                   gap_vs_main_path_8bit_mean=mean8, gap_vs_main_path_8bit_p95=p95)
    log("adaptive + boundary path:", json.dumps(summary))
    results["adaptive_boundary_path"] = summary
    chunk1 = {k: out[k][:, :, :CHUNK1_FRAMES].cpu() for k in ("pred_img", "pred_disparity")}
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()
    return summary, chunk1


def http_call(port: int, method: str, path: str, obj=None):
    """One JSON request to the local server; returns (status, body)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    try:
        body = None if obj is None else json.dumps(obj)
        conn.request(method, path, body, {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def wire_f16(d):
    """A /step payload's float16 values as sent."""
    import base64
    import numpy as np
    return np.frombuffer(base64.b64decode(d["data"]), np.float16).reshape(d["shape"])


def run_serving_path(device, results, ref_frames, ref_disparity, main_launches: int):
    """Phase 13: interactive serving at full width on phase 5's weights,
    image, prompt and seed: prewarm, then a SessionServer on 127.0.0.1 and a
    session over HTTP, one POST /step per unit, with the counts set to 0
    just before the session and read just after its last step; a GET
    /metrics from a second thread while the chunk-boundary step holds the
    device lock; POST /close."""
    import threading
    import numpy as np
    import torch
    from deepv_tpu_torch import serve
    from deepv_tpu_torch.config import create_model_config
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.ops import conv_igemm as cig
    from deepv_tpu_torch.ops import conv_int8 as ci8
    from deepv_tpu_torch.ops import linear_int8 as li8
    from deepv_tpu_torch.run import load_pipeline

    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    pipe = load_pipeline("none", cfg, random_weights=True, dtype=torch.bfloat16,
                         device=device, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    att.launches = att.f32_launches = att.bwd_launches = 0
    prewarm_s = serve.prewarm(pipe, height=HEIGHT, width=WIDTH, log=log)
    prewarm_launches = att.launches
    assert prewarm_launches > 0 and att.f32_launches == att.bwd_launches == 0, (
        prewarm_launches, att.f32_launches, att.bwd_launches)
    batch = rollout_batch()
    actions = serve.InteractiveSession.actions_from_prompt_list(pipe.cfg, list(batch["prompt"]))
    assert len(actions) == 12, len(actions)
    boundary = pipe.cfg.max_temporal_length - 1         # step 8, the chunk boundary

    torch.cuda.reset_peak_memory_stats()
    att.launches = att.f32_launches = att.bwd_launches = 0
    for name in K2_COUNTERS:
        setattr(cig, name, 0)
    ci8.launches = ci8.packed_launches = ci8.quantize_launches = li8.calls = 0
    server = serve.SessionServer(pipe, host="127.0.0.1", port=0)
    port = server.start()
    probe = {}

    def probe_metrics():
        """GET /metrics once the boundary step holds the device lock."""
        lock, deadline = server._device_locks[0], time.perf_counter() + HTTP_TIMEOUT
        while not lock.locked():
            if time.perf_counter() > deadline:
                return
            time.sleep(0.0005)
        t = time.perf_counter()
        probe["status"], probe["metrics"] = http_call(port, "GET", "/metrics")
        probe["s"] = time.perf_counter() - t
        probe["lock_still_held"] = lock.locked()

    try:
        t_session = time.perf_counter()
        status, resp = http_call(port, "POST", "/session",
                                 {"image": serve._np_b64(batch["img"]), "seed": 666})
        assert status == 200, resp
        sid = resp["session_id"]
        session_s = time.perf_counter() - t_session
        rgb, disp, step_s, complete, totals = [], [], [], [], []
        for i, action in enumerate(actions):
            prober = threading.Thread(target=probe_metrics) if i == boundary else None
            if prober is not None:
                prober.start()
            ts = time.perf_counter()
            status, out = http_call(port, "POST", "/step", {"session_id": sid, "action": action})
            step_s.append(time.perf_counter() - ts)
            assert status == 200, out
            if i == 0:
                first_frame_s = time.perf_counter() - t_session
            if prober is not None:
                prober.join(timeout=HTTP_TIMEOUT)
            rgb.append(wire_f16(out["rgb"]))
            disp.append(wire_f16(out["disparity"]))
            complete.append(out["chunk_complete"])
            totals.append(out["frames_total"])
        launches = dict(attention=att.launches, attention_f32=att.f32_launches,
                        attention_bwd=att.bwd_launches,
                        **{f"conv_igemm_{k}": getattr(cig, k) for k in K2_COUNTERS},
                        conv_int8=ci8.launches + ci8.packed_launches,
                        quantize_k3=ci8.quantize_launches, int_mm=li8.calls)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        status, closed = http_call(port, "POST", "/close", {"session_id": sid})
        assert (status, closed) == (200, {"closed": True}), (status, closed)
        status, metrics = http_call(port, "GET", "/metrics")
        assert status == 200 and metrics["sessions"] == 0, metrics
    finally:
        server.stop()

    expected = [False] * boundary + [True] + [False] * 3 + [True]
    assert complete == expected, f"chunk_complete {complete}"
    assert totals[-1] == 89, f"frames_total {totals[-1]}"
    rgb, disp = np.concatenate(rgb, axis=2), np.concatenate(disp, axis=2)
    want_rgb = np.asarray(ref_frames.float().cpu().numpy(), np.float16)
    want_disp = np.asarray(ref_disparity.float().cpu().numpy(), np.float16)
    assert rgb.shape == want_rgb.shape == (1, 3, 89, HEIGHT, WIDTH), rgb.shape
    rgb_diff = int((rgb != want_rgb).sum())
    disp_diff = int((disp != want_disp).sum())
    assert rgb_diff == 0 and disp_diff == 0, (
        f"served frames differ from phase 5's: {rgb_diff} rgb and {disp_diff} disparity values")
    expected_k1 = len(actions) * len(pipe.cfg.stages) * pipe.cfg.num_inference_steps \
        * pipe.mcfg.num_layers
    assert launches["attention"] == expected_k1 == main_launches, (launches, main_launches)
    assert not any(v for k, v in launches.items() if k != "attention"), launches
    assert "s" in probe, "GET /metrics was not sent while the boundary step held the lock"
    assert probe["status"] == 200 and probe["lock_still_held"], probe
    assert probe["s"] < 1.0, f"/metrics took {probe['s']:.3f} s during the boundary step"
    # a session holds what generate() holds between units: its peak stays
    # within 1 GiB of phase 5's, step 12's opening of chunk 3 included
    main_peak = results["main_path"]["max_memory_allocated_gib"]
    assert peak < main_peak + 1.0, (
        f"the served session's peak {peak:.2f} GiB is over phase 5's {main_peak:.2f} GiB + 1")

    # the wire's share of a step: one 8-frame window's rgb and disparity
    # through the server's encode (device to host, float16, base64, JSON)
    # and the client's decode, median of 3
    window = (ref_frames[:, :, 1:9], ref_disparity[:, :, 1:9])

    def encode():
        return json.dumps({"rgb": serve._np_b64(window[0]), "disparity": serve._np_b64(window[1])})

    def decode(body):
        out = json.loads(body)
        return wire_f16(out["rgb"]), wire_f16(out["disparity"])

    body = encode()
    encode_s, decode_s = [], []
    for _ in range(3):
        t = time.perf_counter()
        encode()
        encode_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        decode(body)
        decode_s.append(time.perf_counter() - t)
    summary = dict(setup_s=setup_s, prewarm_s=prewarm_s, prewarm_launches=prewarm_launches,
                   session_s=session_s,
                   window_encode_s=float(np.median(encode_s)),
                   window_decode_s=float(np.median(decode_s)), window_body_mb=len(body) / 1e6,
                   first_frame_s=first_frame_s, first_step_s=step_s[0],
                   step_s=step_s, step_median_s=float(np.median(step_s)),
                   boundary_step_s=step_s[boundary], last_step_s=step_s[-1],
                   metrics_during_boundary_s=probe["s"],
                   metrics_during_boundary=probe["metrics"], launches=launches,
                   max_memory_allocated_gib=peak, frames=int(totals[-1]))
    log(f"serving: prewarm {prewarm_s:.2f} s (K1 {prewarm_launches} launches); POST /session "
        f"{session_s:.3f} s; time to first "
        f"frame (POST /session to the first /step response) {first_frame_s:.3f} s, first step "
        f"{step_s[0]:.3f} s; step median {summary['step_median_s']:.3f} s, boundary step "
        f"{step_s[boundary]:.3f} s; /metrics during it {probe['s'] * 1e3:.1f} ms; "
        f"peak {peak:.2f} GiB; K1 {launches['attention']} launches; 89 frames equal phase 5's; "
        f"an 8-frame window on the wire ({len(body) / 1e6:.1f} MB): server encode "
        f"{summary['window_encode_s']:.3f} s, client decode {summary['window_decode_s']:.3f} s")
    log("serving path:", json.dumps(summary))
    results["serving_path"] = summary
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def training_batch(device, dtype, b: int = 1):
    """Phase 15's batch: 8 latent units at 384x512 ([1, 38, 8, 48, 64]), 77
    text tokens (11 of them unmasked) and pooled text, from a seeded
    generator (``b`` rows: phase 21 (b)'s global batch)."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig

    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    g = torch.Generator(device=device)
    g.manual_seed(15)
    lh, lw = HEIGHT // pcfg.vae_downsample, WIDTH // pcfg.vae_downsample
    draw = lambda *shape: torch.randn(shape, generator=g, device=device).to(dtype)
    mask = torch.zeros((b, 77), dtype=torch.int32, device=device)
    mask[:, :11] = 1
    return {"latents": draw(b, mcfg.in_channels, (TRAIN_UNIT + 1) * pcfg.frame_per_unit, lh, lw),
            "text_embeds": draw(b, 77, mcfg.joint_attention_dim), "text_mask": mask,
            "pooled": draw(b, mcfg.pooled_projection_dim)}


def checked_step(name, step, model, dtype, n_steps=1):
    """Runs ``step()`` (one or more train steps) with K1's counts set to 0
    just before and read just after: a finite loss, a finite gradient for
    every parameter, a nonzero one for every block's to_q (the attention's
    gradient flowed), K1's forward of the dtype and the backward once per
    block of each step. Returns the step's row."""
    import torch
    from deepv_tpu_torch.ops import attention as att

    n_layers = len(model.transformer_blocks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.launches = att.f32_launches = att.bwd_launches = 0
    t0 = time.perf_counter()
    losses = step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(attn_fwd_wgmma=att.launches, attn_fwd_tf32x3=att.f32_launches,
                  attn_bwd=att.bwd_launches)
    losses = [float(x) for x in (losses if isinstance(losses, list) else [losses])]
    assert all(map(math.isfinite, losses)), f"{name}: loss {losses}"
    params = list(model.named_parameters())
    finite = torch.stack([torch.isfinite(p.grad).all() if p.grad is not None
                          else torch.zeros((), dtype=torch.bool, device=p.device)
                          for _, p in params])
    bad = [n for (n, _), ok in zip(params, finite.tolist()) if not ok]
    assert not bad, f"{name}: no finite gradient for {bad[:5]} ({len(bad)} parameters)"
    dead = [i for i, blk in enumerate(model.transformer_blocks)
            if not bool((blk.attn.to_q.weight.grad != 0).any())]
    assert not dead, f"{name}: to_q of blocks {dead} got a zero gradient"
    fwd = "attn_fwd_wgmma" if dtype == torch.bfloat16 else "attn_fwd_tf32x3"
    want = dict(attn_fwd_wgmma=0, attn_fwd_tf32x3=0, attn_bwd=n_layers * n_steps)
    want[fwd] = n_layers * n_steps
    assert counts == want, f"{name}: K1 launches {counts}, expected {want}"
    row = dict(step=name, losses=losses, seconds=seconds,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, launches=counts,
               params_with_grad=len(params))
    log("training", json.dumps(row))
    return row


def run_training_path(device, results):
    """Phase 15: training at full width through the port's entry points:
    Trainer on an MMDiT from random_mmdit_params (f32, seed 0), one pyramid
    step at each stage (unit 7), one single-clip step, Trainer.train for 4
    steps, a CKPT_LAYERS-layer trainer's step saved and restored into a
    fresh Trainer (equal bit for bit), then one bf16 stage-2 step. First, on the fresh weights, phase 21's
    reference: a stage-2 loss and its gradients with phase 21's draws.
    Returns the launch counts of the f32 and the bf16 steps, and that
    reference (the loss, each leaf's gradient norm)."""
    import dataclasses
    import torch
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.io.weights import params_from_numpy, random_mmdit_params
    from deepv_tpu_torch.models.mmdit import MMDiT
    from deepv_tpu_torch.models.scheduler import FlowMatchSchedule
    from deepv_tpu_torch.pipeline import TorchNoise
    from deepv_tpu_torch.training.flow_matching import make_train_step, pyramid_flow_matching_loss
    from deepv_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    f32 = torch.float32
    t0 = time.perf_counter()
    model = params_from_numpy(MMDiT(mcfg), random_mmdit_params(mcfg, f32, seed=0, device=device))
    trainer = Trainer(mcfg, model, learning_rate=1e-4, weight_decay=0.01, pcfg=pcfg,
                      device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"training: f32 Trainer with {n_params / 1e9:.3f} B parameters and its AdamW state "
        f"ready in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    batch = training_batch(device, f32)
    # phase 21 (a)'s reference: the loss and every leaf's gradient norm of a
    # stage-2 step on these fresh weights, with phase 21's draws
    loss = pyramid_flow_matching_loss(model, pcfg, FlowMatchSchedule(pcfg.scheduler), batch,
                                      TorchNoise(MESH_TRAIN_SEED, device), 2, TRAIN_UNIT)
    loss.backward()
    names = [n for n, _ in model.named_parameters()]
    # a leaf no gradient reached (proj_history: no history here) has norm 0
    norms = torch.stack([p.new_zeros(()) if p.grad is None else p.grad.norm()
                         for p in model.parameters()]).tolist()
    mesh_reference = dict(loss=float(loss), grad_norms=dict(zip(names, norms)))
    trainer.optimizer.zero_grad(set_to_none=True)
    del loss
    rows, counts = [], dict(attn_fwd_tf32x3=0, attn_bwd_f32=0)
    noise = TorchNoise(15, device)
    for stage in range(len(pcfg.stages)):
        rows.append(checked_step(
            f"pyramid stage {stage}, unit {TRAIN_UNIT}, f32",
            lambda: trainer.step_fn(batch, noise, stage, TRAIN_UNIT), model, f32))
    single = make_train_step(model, trainer.optimizer)
    clip = dict(batch, latents=batch["latents"][:, :, :1])
    rows.append(checked_step("single clip, 1 frame, f32", lambda: single(clip, noise), model, f32))
    rows.append(checked_step("Trainer.train, 4 pyramid steps, f32",
                             lambda: trainer.train([batch] * 4, noise, log_every=1, log_fn=log),
                             model, f32, n_steps=4))
    for r in rows:
        counts["attn_fwd_tf32x3"] += r["launches"]["attn_fwd_tf32x3"]
        counts["attn_bwd_f32"] += r["launches"]["attn_bwd"]

    bf16_params = {k: v.detach().to(torch.bfloat16) for k, v in model.named_parameters()}
    del trainer, model, single
    gc.collect()
    torch.cuda.empty_cache()

    # save after a step, then restore into a fresh trainer (other random
    # weights): a trainer of the same width cut to CKPT_LAYERS layers, so
    # that the disk's write rate does not hold the script near its limit
    ckpt_cfg = dataclasses.replace(mcfg, num_layers=CKPT_LAYERS)
    trainer = Trainer(ckpt_cfg, params_from_numpy(MMDiT(ckpt_cfg), random_mmdit_params(
        ckpt_cfg, f32, seed=0, device=device)), learning_rate=1e-4, weight_decay=0.01, pcfg=pcfg,
        device=device)
    trainer.train([batch], noise, log_every=0)
    ckpt_dir = tempfile.mkdtemp(prefix="_train_ckpt_", dir=HERE)
    try:
        t = time.perf_counter()
        path = trainer.save(os.path.join(ckpt_dir, f"step_{trainer.step:08d}"))
        save_s = time.perf_counter() - t
        trainer.optimizer.zero_grad(set_to_none=True)
        fresh = Trainer(ckpt_cfg, params_from_numpy(MMDiT(ckpt_cfg), random_mmdit_params(
            ckpt_cfg, f32, seed=1, device=device)), learning_rate=1e-4, weight_decay=0.01,
            pcfg=pcfg, device=device)
        t = time.perf_counter()
        fresh.restore(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        ckpt_gb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ckpt_dir)
                      for f in fs) / 1e9
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert fresh.step == trainer.step == 1, (fresh.step, trainer.step)
    differ = []
    for (name, a), b in zip(trainer.model.named_parameters(), fresh.model.parameters()):
        sa, sb = trainer.optimizer.state[a], fresh.optimizer.state[b]
        if not (torch.equal(a, b) and torch.equal(sa["exp_avg"], sb["exp_avg"])
                and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
                and torch.equal(sa["step"], sb["step"])):
            differ.append(name)
    assert not differ, f"restored state differs from the saved one: {differ[:5]}"
    log(f"training: checkpoint of {ckpt_gb:.2f} GB ({CKPT_LAYERS} layers at full width) saved in "
        f"{save_s:.1f} s, restored into a fresh Trainer in {restore_s:.1f} s; params and AdamW "
        "state equal bit for bit")
    del fresh, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # one bf16 stage-2 step: K1's wgmma forward and the bf16 backward
    bf16 = torch.bfloat16
    model = params_from_numpy(MMDiT(mcfg), bf16_params)
    del bf16_params
    trainer = Trainer(mcfg, model, learning_rate=1e-4, weight_decay=0.01, pcfg=pcfg,
                      device=device)
    batch = training_batch(device, bf16)
    row = checked_step(f"pyramid stage 2, unit {TRAIN_UNIT}, bf16",
                       lambda: trainer.step_fn(batch, TorchNoise(16, device), 2, TRAIN_UNIT),
                       model, bf16)
    rows.append(row)
    counts["attn_fwd_wgmma"] = row["launches"]["attn_fwd_wgmma"]
    counts["attn_bwd_bf16"] = row["launches"]["attn_bwd"]
    del trainer, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(params=n_params, steps=rows, checkpoint_gb=ckpt_gb, save_s=save_s,
                   restore_s=restore_s, launches=counts)
    results["training_path"] = dict(summary, mesh_reference_loss=mesh_reference["loss"])
    return summary, mesh_reference


# ---------------------------------------------------------------------------
# phases 16-17: a snapshot on disk (M15a) and the SD3 text towers (M15b)
# ---------------------------------------------------------------------------

#: safetensors dtype names of the tensors the snapshot writer meets
ST_DTYPES = {"torch.float32": "F32", "torch.bfloat16": "BF16", "torch.float16": "F16"}
#: transformer/config.json: the MMDiTConfig fields a diffusers config carries
MMDIT_JSON_FIELDS = ("sample_size", "patch_size", "in_channels", "num_layers",
                     "attention_head_dim", "num_attention_heads", "caption_projection_dim",
                     "pooled_projection_dim", "pos_embed_max_size", "joint_attention_dim")
#: causal_video_vae/config.json: the VAEConfig fields a snapshot carries
VAE_JSON_FIELDS = ("encoder_out_channels", "encoder_layers_per_block",
                   "encoder_block_out_channels", "encoder_norm_num_groups",
                   "decoder_in_channels", "decoder_layers_per_block",
                   "decoder_block_out_channels", "decoder_norm_num_groups", "sample_size")
#: SD3's three text towers with the public configs
#: (stabilityai/stable-diffusion-3-medium-diffusers, text_encoder*/config.json):
#: CLIP-L, OpenCLIP bigG (both eos_token_id 2) and T5 v1.1 XXL
SD3_TOWERS = {
    "text_encoder": dict(kind="clip", vocab=49408, width=768, layers=12, heads=12, mlp=3072,
                         proj=768, act="quick_gelu"),
    "text_encoder_2": dict(kind="clip", vocab=49408, width=1280, layers=32, heads=20, mlp=5120,
                           proj=1280, act="gelu"),
    "text_encoder_3": dict(kind="t5", vocab=32128, width=4096, layers=24, heads=64, d_kv=64,
                           mlp=10240),
}
#: CLIP's BOS and EOS ids (SD3's tokenizer and tokenizer_2); T5's EOS
CLIP_BOS, CLIP_EOS, T5_EOS = 49406, 49407, 1
#: phase 17's prompt (text rollouts repeat it for every unit) and its token count
TEXT_PROMPT = "A red car drives along a coastal road at sunset."
TEXT_TOKENS = 12
#: phase 17: the bf16 towers against the same towers in f32 on the card
#: (TF32 off), as the relative L2 deviation of each output (prompt_embeds,
#: each CLIP's pooled embedding). bf16 rounds every weight and activation
#: to 8 bits of mantissa (2^-9 relative), and the residual streams add up
#: such errors over 12, 32 and 24 layers, which layer norms keep relative:
#: a few times 2^-9 per layer in quadrature is ~1e-2 after 24 layers. 2^-4
#: leaves room for that and fails a wrong dtype, layout or pooling position,
#: which gives deviations of order 1.
TEXT_BF16_REL_L2 = 2.0 ** -4


def write_safetensors(tensors, path: str) -> None:
    """``tensors`` (name -> CPU or device tensor) as one .safetensors file,
    each in its own dtype: an 8-byte little-endian header length, the JSON
    header, then the raw bytes in the header's order."""
    import struct
    import torch

    names = sorted(tensors)
    header, offset = {}, 0
    for name in names:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            t = tensors[name].detach().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            t.cpu().numpy().tofile(f)


def mmdit_ckpt_names(flat):
    """The port's MMDiT tree path -> diffusers checkpoint name (the inverse
    of io/weights._MMDIT_RULES; tests/snapshot_utils.py keeps the same)."""
    out = {}
    for k, v in flat.items():
        k2 = k.replace(".ff.proj.", ".ff.net.0.proj.").replace(".ff.out.", ".ff.net.2.")
        k2 = k2.replace(".ff_context.proj.", ".ff_context.net.0.proj.")
        k2 = k2.replace(".ff_context.out.", ".ff_context.net.2.")
        out[k2.replace(".attn.to_out.", ".attn.to_out.0.")] = v
    return out


def vae_ckpt_names(flat):
    """The port's VAE tree path -> diffusers name (the inverse of
    io/weights._VAE_RULES): quant convs beside the encoder and decoder, the
    samplers' ``conv`` attribute, and CausalConv3d's ``<name>.conv.`` wrapper
    for 5-D weights and their sibling biases."""
    out = {}
    for k, v in flat.items():
        k2 = k
        for nested in ("encoder.quant_conv.", "decoder.post_quant_conv."):
            if k2.startswith(nested):
                k2 = k2[k2.index(".") + 1:]
        for ours, theirs in ((".downsampler.", ".downsamplers.0.conv."),
                             (".temporal_downsampler.", ".temporal_downsamplers.0.conv."),
                             (".upsampler.", ".upsamplers.0.conv."),
                             (".temporal_upsampler.", ".temporal_upsamplers.0.conv."),
                             (".to_out.", ".to_out.0.")):
            k2 = k2.replace(ours, theirs)
        if v.dim() == 5:
            base, leaf = k2.rsplit(".", 1)
            k2 = f"{base}.conv.{leaf}"
        out[k2] = v
    for k in [k for k in out if k.endswith(".conv.weight")]:
        bias = k[: -len(".conv.weight")] + ".bias"
        if bias in out:
            out[k[: -len("weight")] + "bias"] = out.pop(bias)
    return out


def check_disk(path: str, need_bytes: int, what: str) -> None:
    free = shutil.disk_usage(path).free
    assert free > need_bytes * 1.1 + 2 ** 30, (
        f"{what}: {free / 1e9:.1f} GB free under {path}, {need_bytes / 1e9:.1f} GB needed")


def write_model_snapshot(root: str, mcfg, vcfg, params) -> int:
    """transformer/ and causal_video_vae/ of a diffusers-style snapshot:
    config.json and one .safetensors each. Returns the bytes written."""
    from deepv_tpu_torch.io.weights import flatten_tree

    total = 0
    mmdit, vae = (flatten_tree(params[part]) for part in ("mmdit", "vae"))
    for sub, cfg, fields, names in (
            ("transformer", mcfg, MMDIT_JSON_FIELDS, mmdit_ckpt_names(mmdit)),
            ("causal_video_vae", vcfg, VAE_JSON_FIELDS, vae_ckpt_names(vae))):
        d = os.path.join(root, sub)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in ((k, getattr(cfg, k)) for k in fields)}, f)
        path = os.path.join(d, "diffusion_pytorch_model.safetensors")
        write_safetensors(names, path)
        total += os.path.getsize(path)
    return total


def run_checkpoint_path(device, results, ref_frames, root):
    """Phase 16 (M15a): phase 5's full-width bf16 weights written as a
    snapshot under ``root`` and loaded by run.load_pipeline without
    random_weights; every tensor as written, then phase 5's rollout. Returns
    the pipeline."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig, create_model_config
    from deepv_tpu_torch.io.weights import flatten_tree, random_params
    from deepv_tpu_torch.run import load_pipeline

    mcfg, vcfg = MMDiTConfig(), VAEConfig()
    params = random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0, device=device)
    written = {part: flatten_tree(params[part]) for part in ("mmdit", "vae")}
    need = sum(t.numel() * t.element_size() for w in written.values() for t in w.values())
    check_disk(root, need, "phase 16's snapshot")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snapshot_bytes = write_model_snapshot(root, mcfg, vcfg, params)
    write_s = time.perf_counter() - t0
    del params
    t0 = time.perf_counter()
    pipe = load_pipeline(root, create_model_config(root), dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert pipe.mcfg == mcfg and pipe.vcfg == vcfg, (pipe.mcfg, pipe.vcfg)
    assert pipe.text_encoder is None, "no text directories, no encoder"
    n_checked = 0
    for part, module in (("mmdit", pipe.mmdit), ("vae", pipe.vae)):
        state = module.state_dict()
        assert set(state) == set(written[part]), sorted(set(state) ^ set(written[part]))[:5]
        for k, w in written[part].items():
            got = state[k]
            want = w.float() if k == "pos_embed.pos_embed" else w
            assert got.dtype == want.dtype and got.device == want.device, (k, got.dtype)
            assert torch.equal(got, want), f"loaded {part}.{k} differs from the written tensor"
            n_checked += 1
    del written, state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"checkpoint path: snapshot of {snapshot_bytes / 1e9:.3f} GB written in {write_s:.1f} s, "
        f"loaded by run.load_pipeline in {load_s:.1f} s; {n_checked} tensors equal the written "
        "ones bit for bit (pos_embed as f32 of the written bf16)")
    summary, out, conv_launches = drive_rollout(pipe, load_s)
    assert summary["forwards"] == FORWARDS, summary["forwards"]
    assert summary["attention_launches"] == FORWARDS * mcfg.num_layers == 4320, summary
    assert not any(conv_launches.values()), conv_launches
    mean8, p95 = eight_bit_gap(out["pred_img"].cpu(), ref_frames)
    summary.update(snapshot_gb=snapshot_bytes / 1e9, write_s=write_s, load_s=load_s,
                   tensors_checked=n_checked, gap_vs_main_path_8bit_mean=mean8,
                   gap_vs_main_path_8bit_p95=p95)
    log(f"checkpoint path: 8-bit gap to phase 5's frames mean {mean8:.4f}, p95 {p95:.4f} "
        "(printed, not gated: the loaded pos_embed is f32)")
    log("checkpoint path:", json.dumps(summary))
    results["checkpoint_path"] = summary
    del out
    return pipe


def tower_layout(spec):
    """One SD3 tower's HF state (``CLIPTextModelWithProjection`` or
    ``T5EncoderModel``; T5's tied ``encoder.embed_tokens.weight`` left out,
    as save_pretrained drops it): name -> (shape, init), where init is the
    std of HF's normal init, or "ones" / "zeros"."""
    d, n_layers, mlp = spec["width"], spec["layers"], spec["mlp"]
    s = {}
    if spec["kind"] == "clip":
        in_std, out_std, fc_std = d ** -0.5 * (2 * n_layers) ** -0.5, d ** -0.5, (2 * d) ** -0.5
        s["text_model.embeddings.token_embedding.weight"] = ((spec["vocab"], d), 0.02)
        s["text_model.embeddings.position_embedding.weight"] = ((77, d), 0.02)
        for i in range(n_layers):
            p = f"text_model.encoder.layers.{i}."
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                s[p + f"self_attn.{name}.weight"] = ((d, d), out_std if name == "out_proj"
                                                     else in_std)
                s[p + f"self_attn.{name}.bias"] = ((d,), "zeros")
            for norm in ("layer_norm1", "layer_norm2"):
                s[p + f"{norm}.weight"], s[p + f"{norm}.bias"] = ((d,), "ones"), ((d,), "zeros")
            s[p + "mlp.fc1.weight"], s[p + "mlp.fc1.bias"] = ((mlp, d), fc_std), ((mlp,), "zeros")
            s[p + "mlp.fc2.weight"], s[p + "mlp.fc2.bias"] = ((d, mlp), in_std), ((d,), "zeros")
        s["text_model.final_layer_norm.weight"] = ((d,), "ones")
        s["text_model.final_layer_norm.bias"] = ((d,), "zeros")
        s["text_projection.weight"] = ((spec["proj"], d), d ** -0.5)
    else:
        inner = spec["heads"] * spec["d_kv"]
        s["shared.weight"] = ((spec["vocab"], d), 1.0)
        for i in range(n_layers):
            p = f"encoder.block.{i}.layer."
            s[p + "0.SelfAttention.q.weight"] = ((inner, d), (d * spec["d_kv"]) ** -0.5)
            s[p + "0.SelfAttention.k.weight"] = ((inner, d), d ** -0.5)
            s[p + "0.SelfAttention.v.weight"] = ((inner, d), d ** -0.5)
            s[p + "0.SelfAttention.o.weight"] = ((d, inner), inner ** -0.5)
            if i == 0:
                s[p + "0.SelfAttention.relative_attention_bias.weight"] = (
                    (32, spec["heads"]), d ** -0.5)
            s[p + "0.layer_norm.weight"] = ((d,), "ones")
            s[p + "1.DenseReluDense.wi_0.weight"] = ((mlp, d), d ** -0.5)
            s[p + "1.DenseReluDense.wi_1.weight"] = ((mlp, d), d ** -0.5)
            s[p + "1.DenseReluDense.wo.weight"] = ((d, mlp), mlp ** -0.5)
            s[p + "1.layer_norm.weight"] = ((d,), "ones")
        s["encoder.final_layer_norm.weight"] = ((d,), "ones")
    return s


def tower_params(towers=SD3_TOWERS) -> int:
    return sum(math.prod(shape) for spec in towers.values()
               for shape, _ in tower_layout(spec).values())


def tower_state(spec, gen, dtype, device):
    """``tower_layout``'s tensors, drawn on ``device`` from ``gen``."""
    import torch

    out = {}
    for name, (shape, init) in tower_layout(spec).items():
        if init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            out[name] = (torch.randn(shape, generator=gen, device=device) * init).to(dtype)
    return out


def tower_config(spec):
    """The tower's config.json, as SD3's snapshot has it."""
    if spec["kind"] == "clip":
        return {"architectures": ["CLIPTextModelWithProjection"], "hidden_size": spec["width"],
                "intermediate_size": spec["mlp"], "num_hidden_layers": spec["layers"],
                "num_attention_heads": spec["heads"], "projection_dim": spec["proj"],
                "hidden_act": spec["act"], "vocab_size": spec["vocab"],
                "max_position_embeddings": 77, "layer_norm_eps": 1e-5,
                "bos_token_id": 0, "eos_token_id": 2, "pad_token_id": 1}
    return {"architectures": ["T5EncoderModel"], "d_model": spec["width"], "d_ff": spec["mlp"],
            "d_kv": spec["d_kv"], "num_heads": spec["heads"], "num_layers": spec["layers"],
            "feed_forward_proj": "gated-gelu", "vocab_size": spec["vocab"],
            "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
            "layer_norm_epsilon": 1e-6, "eos_token_id": 1, "pad_token_id": 0}


def write_text_towers(root: str, device, towers=SD3_TOWERS, seed: int = 17) -> int:
    """text_encoder{,_2,_3}/ (config.json, model.safetensors) with random
    bf16 weights from ``seed``. Returns the bytes written."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = 0
    for sub, spec in towers.items():
        d = os.path.join(root, sub)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(tower_config(spec), f)
        state = tower_state(spec, gen, torch.bfloat16, device)
        write_safetensors(state, os.path.join(d, "model.safetensors"))
        del state
        total += os.path.getsize(os.path.join(d, "model.safetensors"))
    return total


def fixed_token_ids(n_tokens: int = TEXT_TOKENS, seed: int = 17):
    """Seeded stand-ins for SD3's tokenizers, whose files the checkout does
    not hold: CLIP rows BOS, ids, EOS 49407, then pad 49407 for the
    first tokenizer and 0 for the second; the T5 row ids, EOS 1, pad 0, and
    its mask. int64 numpy arrays [1, 77]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clip_ids = rng.integers(1000, 49000, n_tokens)
    ids_l = np.full((1, 77), CLIP_EOS, np.int64)
    ids_l[0, :n_tokens + 2] = [CLIP_BOS, *clip_ids, CLIP_EOS]
    ids_g = np.zeros((1, 77), np.int64)
    ids_g[0, :n_tokens + 2] = ids_l[0, :n_tokens + 2]
    ids_t5 = np.zeros((1, 77), np.int64)
    ids_t5[0, :n_tokens + 1] = [*rng.integers(3, 32000, n_tokens), T5_EOS]
    mask = (np.arange(77) < n_tokens + 1).astype(np.int64)[None]
    return ids_l, ids_g, ids_t5, mask


def fixed_ids_encoder(root: str, dtype, device, calls=None):
    """The port's SD3TextEncoder on the snapshot's towers, whose host
    tokenisation (HF tokenizers from the snapshot's tokenizer directories)
    is replaced by ``fixed_token_ids``; ``calls`` counts the prompts it
    encodes."""
    from deepv_tpu_torch.io.weights import load_text_towers
    from deepv_tpu_torch.models.text_encoders import SD3TextEncoder

    class FixedIdsEncoder(SD3TextEncoder):
        def load_tokenizers(self, model_path):
            pass

        def tokenize(self, prompt):
            if calls is not None:
                calls[prompt] = calls.get(prompt, 0) + 1
            return fixed_token_ids()

    params, configs = load_text_towers(root, dtype=dtype, device=device)
    return FixedIdsEncoder(root, params, configs, dtype=dtype, device=device)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def run_text_path(device, results, pipe, root):
    """Phase 17 (M15b): SD3's three towers at full width written into the
    snapshot, loaded by io/weights.load_text_towers, encoded on the card in
    bf16 against f32, then a 2-chunk prompt_type="text" rollout through
    InferencePipeline(text_encoder=...) on phase 16's loaded MMDiT and VAE."""
    import importlib.util
    import numpy as np
    import torch
    from deepv_tpu_torch.actions import action_vocabulary, prepare_motion_prompts
    from deepv_tpu_torch.config import create_model_config
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.pipeline import InferencePipeline

    have = {m: importlib.util.find_spec(m) is not None for m in ("transformers", "safetensors")}
    log(f"text path: importable on this machine: {json.dumps(have)}")
    ids = fixed_token_ids()
    log("text path: fixed token ids (CLIP-L, CLIP-G, T5, T5 mask): "
        + json.dumps([a[0, :TEXT_TOKENS + 3].tolist() for a in ids]))
    n_params = tower_params()
    check_disk(root, 2 * n_params, "phase 17's text towers")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tower_bytes = write_text_towers(root, device)
    write_s = time.perf_counter() - t0

    # the same towers in f32 (TF32 off) give the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    enc32 = fixed_ids_encoder(root, torch.float32, device)
    torch.cuda.synchronize()
    load32_s = time.perf_counter() - t0
    ref = [t.float() for t in enc32(TEXT_PROMPT)]
    del enc32
    gc.collect()
    torch.cuda.empty_cache()
    calls = {}
    t0 = time.perf_counter()
    enc = fixed_ids_encoder(root, torch.bfloat16, device, calls)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    seq, mask, pooled = enc(TEXT_PROMPT)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        enc.encode(*ids)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    encode_ms = 1e3 * sorted(times)[2]
    by_kernel = kernel_device_ms(lambda: enc.encode(*ids), calls=3)
    encode_device_ms = sum(by_kernel.values())
    top_kernels = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4])
    assert tuple(seq.shape) == (1, 77, 4096) and seq.dtype == torch.bfloat16, seq.shape
    assert tuple(mask.shape) == (1, 77) and tuple(pooled.shape) == (1, 2048), pooled.shape
    assert torch.equal(mask.cpu(), torch.from_numpy(ids[3])), "the T5 mask is not the tokens'"
    for name, t in (("prompt_embeds", seq), ("pooled", pooled)):
        assert bool(torch.isfinite(t).all()), f"non-finite {name}"
    devs = {"prompt_embeds": rel_l2(seq, ref[0]), "pooled_clip_l": rel_l2(pooled[:, :768],
                                                                          ref[2][:, :768]),
            "pooled_clip_g": rel_l2(pooled[:, 768:], ref[2][:, 768:])}
    log(f"text path: {tower_bytes / 1e9:.3f} GB of towers ({n_params / 1e9:.3f} B parameters) "
        f"written in {write_s:.1f} s, loaded in {load_s:.1f} s (f32: {load32_s:.1f} s); one "
        f"bf16 encode {encode_ms:.2f} ms, {encode_device_ms:.2f} ms of it device time in "
        f"{len(by_kernel)} kernel kinds (top: {json.dumps(top_kernels)}); relative L2 to f32 "
        f"{json.dumps(devs)} (tolerance {TEXT_BF16_REL_L2})")
    bad = {k: v for k, v in devs.items() if not v <= TEXT_BF16_REL_L2}
    assert not bad, f"bf16 towers deviate from f32 beyond {TEXT_BF16_REL_L2}: {bad}"
    del seq, mask, pooled, ref
    calls.clear()

    # a 2-chunk text rollout on phase 16's loaded MMDiT and VAE
    mcfg = pipe.mcfg
    params = {"mmdit": pipe.mmdit.state_dict(), "vae": pipe.vae.state_dict()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    t0 = time.perf_counter()
    tpipe = InferencePipeline(create_model_config(root, use_motion_prompt=False), mcfg,
                              pipe.vcfg, params, embeds, dtype=torch.bfloat16,
                              text_encoder=enc, device=device)
    setup_s = time.perf_counter() - t0
    del params
    batch = dict(rollout_batch(), prompt=np.array(prepare_motion_prompts("text", TEXT_PROMPT)),
                 prompt_type="text")
    summary, out, conv_launches = drive_rollout(tpipe, setup_s, batch=batch)
    assert calls == {TEXT_PROMPT: 1}, f"the encoder ran {calls}, not once for the prompt"
    assert summary["forwards"] == FORWARDS, summary["forwards"]
    assert summary["attention_launches"] == FORWARDS * mcfg.num_layers == 4320, summary
    assert not any(conv_launches.values()), conv_launches
    summary.update(towers_gb=tower_bytes / 1e9, tower_params=n_params, write_s=write_s,
                   load_s=load_s, load_f32_s=load32_s, encode_ms=encode_ms,
                   encode_device_ms=encode_device_ms, encode_top_kernels_ms=top_kernels,
                   rel_l2_vs_f32=devs, encoder_calls=calls,
                   importable=have)
    log(f"text path: 89 frames from the text prompt; peak {summary['max_memory_allocated_gib']:.2f}"
        f" GiB with the towers resident ({summary['resident_gib']:.2f} GiB before the rollout)")
    log("text path:", json.dumps(summary))
    results["text_path"] = summary
    del tpipe, out, enc
    gc.collect()
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phases 18-19: spatial VAE tiling (M17a) and the PLY export (M19b)
# ---------------------------------------------------------------------------

#: phase 18's tile edge in pixels, deepv_tpu's default tile_sample_min_size
TILE_PIXELS = 256
#: phase 19 writes every PLY_STRIDE-th frame of phase 5's 89 (12 files)
PLY_STRIDE = 8
#: phase 19: the card's back-projection against the CPU's, per point, within
#: this share of the sum of the absolute terms of its three-term product
#: plus translation (a few f32 ulps; cuBLAS and the CPU may sum in other
#: orders, TF32 is off)
PLY_REL_TERMS = 2.0 ** -20


def tile_count(h: int, w: int, unit: int) -> int:
    """Tiles of ``models/vae._tiled`` over an h x w plane, ``unit`` a side."""
    step = int(unit * 0.75)
    return len(range(0, h, step)) * len(range(0, w, step))


def expected_tiled_conv_launches(pipe, decode_frames, boundaries: int):
    """K2 launches (all, cl path) of one tiled end-of-chunk igemm rollout,
    from the code: every tile runs the eligible convs of each of its
    temporal windows (``eligible_convs``). ``decode_frames``: the latent
    frames of each tiled decode call (rgb and disparity per chunk)."""
    from deepv_tpu_torch.models.vae import _split_windows

    pcfg = pipe.cfg
    window, _, _, encoder = eligible_convs(pipe.vcfg)
    dec_tiles = tile_count(HEIGHT // 8, WIDTH // 8, TILE_PIXELS // 8)
    enc_tiles = tile_count(HEIGHT, WIDTH, TILE_PIXELS)
    decoder_windows = sum(len(_split_windows(t, pipe.decode_window)) for t in decode_frames)
    # the first image, then per boundary the carried rgb and disparity clips
    # (in windows) and the history frame's rgb and disparity
    clip_windows = len(_split_windows(pcfg.num_input_image, pipe.encode_window))
    encoder_windows = 1 + boundaries * (2 * clip_windows + 2)
    # the cl path: the mid block's resnet after its attention in every
    # full-mode encoder call, per tile
    full_encodes = 1 + 2 * boundaries
    return (window * dec_tiles * decoder_windows + encoder * enc_tiles * encoder_windows,
            enc_tiles * full_encodes)


def check_conv_shapes(device, shapes):
    """K2 against its plain version at each (b, ci, co, t_in, h, w,
    time_pad, kernel) of ``shapes``, in bf16 (the kernel the rollout ran
    there: x channels-last for the cl path) and f32, with phase 4's
    tolerances. Returns one row per shape and dtype."""
    import types
    import torch
    from deepv_tpu_torch.ops import conv_igemm as cig

    gen = torch.Generator(device=device)
    gen.manual_seed(18)
    rows = []
    for key in sorted(shapes):
        b, ci, co, t_in, h, w, tp, kernel = key
        x32 = torch.randn((b, ci, t_in, h, w), generator=gen, device=device)
        if kernel == "cl":
            x32 = x32.to(memory_format=torch.channels_last_3d)
        p32 = types.SimpleNamespace(
            weight=0.02 * torch.randn((co, ci, 3, 3, 3), generator=gen, device=device),
            bias=0.1 * torch.randn((co,), generator=gen, device=device))
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            p = p32 if dtype == torch.float32 else types.SimpleNamespace(
                weight=p32.weight.to(dtype), bias=p32.bias.to(dtype))
            want = cig.kernel_for(x)
            assert dtype == torch.float32 or want == kernel, (key, want)
            y, r, err, excess = k2_against_plain(x, p, tp, str(key))
            assert tuple(y.shape) == (b, co, t_in + tp - 2, h, w), tuple(y.shape)
            rows.append(dict(batch=b, ci=ci, co=co, t_in=t_in, frames=t_in + tp - 2, h=h, w=w,
                             time_pad=tp, kernel=want, dtype=str(dtype).split(".")[-1],
                             launches_in_rollout=shapes[key], max_abs_err=float(err.max()),
                             ulp_excess=excess))
            del x, y, r, err
        del x32, p32
    torch.cuda.empty_cache()
    return rows


class DecoderSpy:
    """A context that sees which VAE work is the decoder's: it wraps
    ``models/vae``'s decoder_front, decoder_tail and decoder_prime_tail
    (every decoder call of the pipeline goes through them) and counts, while
    they run, K2's launches (wgmma and cl paths, from the wrapper's
    counters) and K3's conv and quantise launches; it wraps every causal
    conv of the VAE (``vae.causal_conv3d``) and the dispatches to K2 and K3
    and records their batch sizes, the decoder's and the encoder's apart."""

    def __init__(self):
        self.k2 = self.k3 = self.k3_quantise = 0
        self.conv_batches = {"decoder": {}, "encoder": {}}
        self.dispatch_batches = {"decoder": {}, "encoder": {}}
        self._depth = 0

    @staticmethod
    def _counts():
        from deepv_tpu_torch.ops import conv_igemm as cig
        from deepv_tpu_torch.ops import conv_int8 as ci8
        return (cig.launches + cig.cl_launches, ci8.launches + ci8.packed_launches,
                ci8.quantize_launches)

    def _where(self):
        return "decoder" if self._depth else "encoder"

    def _record(self, table, b):
        where = table[self._where()]
        where[b] = where.get(b, 0) + 1

    def __enter__(self):
        from deepv_tpu_torch.models import vae as vae_mod
        from deepv_tpu_torch.ops import causal_conv

        self._saved = [(vae_mod, name, getattr(vae_mod, name)) for name in (
            "decoder_front", "decoder_tail", "decoder_prime_tail", "causal_conv3d")]
        self._saved += [(causal_conv, name, getattr(causal_conv, name))
                        for name in ("conv3d_igemm", "conv3d_int8")]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        if name == "causal_conv3d":
            def conv(x, *args, **kwargs):
                self._record(self.conv_batches, x.shape[0])
                return fn(x, *args, **kwargs)
            return conv
        if name.startswith("conv3d_"):
            def dispatch(x, *args, **kwargs):
                self._record(self.dispatch_batches, (name[7:], x.shape[0]))
                return fn(x, *args, **kwargs)
            return dispatch

        def decoder(*args, **kwargs):
            c0 = self._counts()
            self._depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if not self._depth:
                    c1 = self._counts()
                    self.k2 += c1[0] - c0[0]
                    self.k3 += c1[1] - c0[1]
                    self.k3_quantise += c1[2] - c0[2]
        return decoder

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        return False

    def summary(self) -> dict:
        key = lambda k: k if isinstance(k, int) else f"{k[0]} b={k[1]}"
        return dict(decoder_k2_launches=self.k2, decoder_k3_launches=self.k3,
                    decoder_k3_quantise_launches=self.k3_quantise,
                    conv_batches={w: {key(k): n for k, n in t.items()}
                                  for w, t in self.conv_batches.items()},
                    dispatch_batches={w: {key(k): n for k, n in t.items()}
                                      for w, t in self.dispatch_batches.items()})


def run_tiled_path(device, results, ref_frames):
    """Phase 18 (M17a): phase 5's rollout through InferencePipeline with
    VAEConfig(conv_impl="igemm") and stream_decode=False, untiled and then
    with use_tiling=True; K2 at every shape the tiled run launched, and the
    tiled decode against a tiled cuDNN decode of the same latents. Returns
    the tiled run's launches, K2's check rows and the untiled run (its
    summary, with the decoder's and the encoder's K2 launches apart, and
    its frames on the host)."""
    import torch
    from deepv_tpu_torch import pipeline as pl
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig, create_model_config
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.io.weights import random_params
    from deepv_tpu_torch.models.vae import vae_decode
    from deepv_tpu_torch.ops import causal_conv
    from deepv_tpu_torch.ops import conv_igemm as cig

    cfg = create_model_config("none", use_motion_prompt=True)
    mcfg, vcfg = MMDiTConfig(), VAEConfig(conv_impl="igemm")
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    t0 = time.perf_counter()
    params = random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0, device=device)
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    orig_conv, orig_decode = causal_conv.conv3d_igemm, pl.vae_decode
    runs, frames = {}, {}
    for name, tiling in (("untiled", False), ("tiled", True)):
        t0 = time.perf_counter()
        pipe = pl.InferencePipeline(cfg, mcfg, vcfg, params, embeds, dtype=torch.bfloat16,
                                    device=device, use_tiling=tiling, stream_decode=False)
        torch.cuda.synchronize()
        setup_s = params_s + time.perf_counter() - t0
        # spies: each K2 dispatch's shape and route, each end-of-chunk
        # decode's latents (the kernel counts stay the wrappers')
        shapes, decodes = {}, []

        def conv_spy(x, p, time_pad=2):
            key = (x.shape[0], x.shape[1], p.weight.shape[0], x.shape[2], x.shape[3],
                   x.shape[4], time_pad, cig.kernel_for(x))
            shapes[key] = shapes.get(key, 0) + 1
            return orig_conv(x, p, time_pad)

        def decode_spy(cfg_, p, z, **kwargs):
            decodes.append(z)
            return orig_decode(cfg_, p, z, **kwargs)

        causal_conv.conv3d_igemm, pl.vae_decode = conv_spy, decode_spy
        try:
            with DecoderSpy() as dec_spy:
                summary, out, conv_launches = drive_rollout(pipe, setup_s)
        finally:
            causal_conv.conv3d_igemm, pl.vae_decode = orig_conv, orig_decode
        assert summary["forwards"] == FORWARDS, summary["forwards"]
        assert summary["attention_launches"] == FORWARDS * mcfg.num_layers == 4320, summary
        assert pipe._prime_need is None if tiling else pipe._prime_need is not None
        assert ("prime" in summary["phases_s"]) != tiling, summary["phases_s"]
        k2 = conv_launches["launches"] + conv_launches["cl_launches"]
        assert k2 == sum(shapes.values()), (k2, sum(shapes.values()))
        spied = dec_spy.summary()
        assert set(spied["conv_batches"]["decoder"]) == {1}, spied
        summary.update(conv_igemm_dispatches=k2, conv_shapes=len(shapes),
                       decode_latent_frames=[z.shape[2] for z in decodes],
                       decoder_conv_igemm_launches=spied["decoder_k2_launches"],
                       encoder_conv_igemm_launches=k2 - spied["decoder_k2_launches"])
        runs[name] = summary
        frames[name] = out["pred_img"].cpu()
        if not tiling:
            # phase 24 holds its batched decode to this run
            untiled_run = dict(summary=summary, pred_img=frames[name],
                               pred_disparity=out["pred_disparity"].cpu())
        del out
        if not tiling:
            del pipe, decodes
            gc.collect()
            torch.cuda.empty_cache()
    del params
    tiled = runs["tiled"]
    # K2's count from the code: 2 decode calls (rgb, disparity) a chunk
    assert len(decodes) == 4, [z.shape for z in decodes]
    expected, expected_cl = expected_tiled_conv_launches(
        pipe, tiled["decode_latent_frames"], len(tiled["history_index"]))
    got = tiled["conv_igemm_launches"]
    log(f"tiled path: K2 {got['launches']} wgmma + {got['cl_launches']} cl launches, "
        f"expected {expected - expected_cl} + {expected_cl}")
    assert got["launches"] + got["cl_launches"] == expected, (got, expected)
    assert got["cl_launches"] == expected_cl, (got, expected_cl)
    tiled.update(expected_conv_igemm_launches=expected,
                 expected_conv_igemm_cl_launches=expected_cl)
    for name in ("untiled", "tiled"):
        s = runs[name]
        log(f"tiled path: {name} rollout {s['wall_s']:.2f} s ({s['fps']:.2f} fps), peak "
            f"{s['max_memory_allocated_gib']:.2f} GiB ({s['resident_gib']:.2f} resident), "
            f"K2 {s['conv_igemm_dispatches']} launches at {s['conv_shapes']} shapes; phases "
            + json.dumps({k: round(v, 3) for k, v in s["phases_s"].items()}))
    untiled = frames["untiled"].to(device)
    gaps = dict(zip(("mean", "p95"), eight_bit_gap(frames["tiled"].to(device), untiled)))
    gaps_main = dict(zip(("mean", "p95"), eight_bit_gap(untiled, ref_frames.to(device))))
    log(f"tiled path: 8-bit gap tiled vs untiled frames mean {gaps['mean']:.4f}, p95 "
        f"{gaps['p95']:.4f}; untiled igemm vs phase 5 mean {gaps_main['mean']:.4f} (printed, "
        "not gated: tiles see zero borders)")
    del frames, untiled

    # K2 held to its plain version at every distinct shape the tiled rollout
    # launched; the spy recorded them in the tiled run (the last one)
    t0 = time.perf_counter()
    rows = check_conv_shapes(device, shapes)
    check_s = time.perf_counter() - t0
    by_kernel = {}
    for r in rows:
        k = by_kernel.setdefault(f"{r['kernel']} {r['dtype']}", dict(shapes=0, max_abs_err=0.0,
                                                                     max_ulp_excess=-1.0))
        k["shapes"] += 1
        k["max_abs_err"] = max(k["max_abs_err"], r["max_abs_err"])
        k["max_ulp_excess"] = max(k["max_ulp_excess"], r["ulp_excess"])
    narrow = sorted({r["w"] for r in rows if r["w"] % 64})
    log(f"tiled path: K2 equals its plain version at all {len(shapes)} shapes of the tiled "
        f"rollout in bf16 and f32 ({check_s:.1f} s; widths not a multiple of 64: {narrow}): "
        + json.dumps(by_kernel))

    # the tiled igemm decode against a tiled cuDNN decode of the same latents
    xla = VAEConfig(conv_impl="xla")
    gap_rows = []
    with torch.inference_mode():
        for i, z in enumerate(decodes):
            kw = dict(temporal_chunk=True, window_size=pipe.decode_window, use_tiling=True)
            a = vae_decode(vcfg, pipe.vae, z, **kw)
            b = vae_decode(xla, pipe.vae, z, **kw)
            assert a.shape == b.shape and bool(torch.isfinite(a).all()), a.shape
            mean8, p95 = eight_bit_gap(a, b)
            gap_rows.append(dict(stream=("rgb", "disparity")[i % 2], chunk=i // 2 + 1,
                                 frames=a.shape[2], gap_8bit_mean=mean8, gap_8bit_p95=p95,
                                 max_abs=float((a.float() - b.float()).abs().max())))
            del a, b
    log("tiled path: igemm vs cuDNN tiled decode of the rollout's latents (8-bit units): "
        + json.dumps(gap_rows))
    tiled.update(gap_vs_untiled_8bit=gaps, untiled_gap_vs_main_path_8bit=gaps_main,
                 conv_check_s=check_s, conv_check_by_kernel=by_kernel, narrow_widths=narrow,
                 decode_gap_vs_cudnn=gap_rows)
    results["tiled_path"] = dict(runs=runs, conv_shapes=rows)
    del pipe, decodes
    gc.collect()
    torch.cuda.empty_cache()
    return (dict(attention=tiled["attention_launches"], **tiled["conv_igemm_launches"]), rows,
            untiled_run)


def ply_points(path: str) -> int:
    """The vertex count in a PLY file's header."""
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                return int(line.split()[-1])
            if line.strip() == "end_header":
                break
    raise ValueError(f"{path}: no vertex count in the header")


def run_ply_path(device, results, output):
    """Phase 19 (M19b): io/ply.save_ply of phase 5's output on the card, and
    depth_edge and backproject on the card against the CPU for the same
    frames."""
    import torch
    from deepv_tpu_torch.io import ply

    n_frames = output["pred_img"].shape[2]
    tmp = tempfile.mkdtemp(prefix="_ply_", dir=HERE)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = ply.save_ply(output, os.path.join(tmp, "rollout.ply"),
                             frame_stride=PLY_STRIDE, device=device)
        seconds = time.perf_counter() - t0
        want = [os.path.join(tmp, f"rollout_frame{i}.ply") for i in range(0, n_frames, PLY_STRIDE)]
        assert paths == want and len(paths) == 12, paths
        points = [ply_points(p) for p in paths]
        file_bytes = sum(os.path.getsize(p) for p in paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert sum(points) > 0, points
    log(f"ply path: save_ply wrote {len(paths)} files, {sum(points)} points "
        f"({min(points)}-{max(points)} a frame, {file_bytes / 1e6:.1f} MB) in {seconds:.2f} s")

    # the card's per-pixel ops against the same functions on the CPU
    disparity = output["pred_disparity"][0].float().cpu().mean(dim=0)
    c2w_list, k_list = ply.interpolate_cameras(output["trans3d"][0].float().cpu().numpy(),
                                               output["trans2d"][0].float().cpu().numpy())
    max_err, max_share, edges = 0.0, 0.0, 0
    checked = range(0, n_frames, PLY_STRIDE)
    for i in checked:
        d = 1.0 / disparity[i]
        K = torch.as_tensor(k_list[i], dtype=torch.float32)
        c2w = torch.as_tensor(c2w_list[i], dtype=torch.float32)
        edge = ply.depth_edge(d.to(device)).cpu()
        assert torch.equal(edge, ply.depth_edge(d)), f"frame {i}: depth_edge differs from the CPU"
        edges += int(edge.sum())
        pg = ply.backproject(d.to(device), K.to(device), c2w.to(device)).cpu()
        pc = ply.backproject(d, K, c2w)
        fin = torch.isfinite(pc)
        assert torch.equal(fin, torch.isfinite(pg)), f"frame {i}: non-finite points differ"
        assert torch.equal(pg[~fin].nan_to_num(0.0), pc[~fin].nan_to_num(0.0)), i
        h, w = d.shape
        u = torch.arange(w, dtype=torch.float32)[None, :]
        v = torch.arange(h, dtype=torch.float32)[:, None]
        cam = torch.stack([(u - K[0, 2]) * d / K[0, 0], (v - K[1, 2]) * d / K[1, 1], d], -1)
        terms = cam.abs() @ c2w[:3, :3].abs().T + c2w[:3, 3].abs()
        err, tol = (pg - pc).abs()[fin], PLY_REL_TERMS * terms[fin]
        assert bool((err <= tol).all()), f"frame {i}: backproject differs from the CPU"
        if err.numel():
            share = float(torch.where(err > 0, err / tol, torch.zeros_like(err)).max())
            max_err, max_share = max(max_err, float(err.max())), max(max_share, share)
    log(f"ply path: depth_edge equal to the CPU's on {len(checked)} frames "
        f"({edges} edge pixels); backproject within {PLY_REL_TERMS:.3g} of its terms' "
        f"absolute sum (max abs {max_err:.3e}, {max_share:.3f} of the tolerance)")
    results["ply_path"] = dict(files=len(paths), points=points, file_mb=file_bytes / 1e6,
                               seconds=seconds, edge_pixels=edges,
                               backproject_max_abs_err=max_err,
                               backproject_tolerance_share=max_share)



# ---------------------------------------------------------------------------
# phase 20: multi-card inference (M17b), as two gloo ranks on this one card
# ---------------------------------------------------------------------------

#: phase 20's mesh: two processes sharing cuda:0 over gloo (NCCL refuses two
#: ranks on one card, and gloo sends no CUDA tensor point to point)
MESH_RANKS = 2
#: the depth of phase 20 (a)'s and phase 22's mesh model, MMDiTConfig() at
#: full width cut to this many joint blocks: the gloo ranks' reductions go
#: through the host at ~0.3-0.55 GB/s and take most of those phases' time,
#: in proportion to the depth (24 blocks put the script near its limit)
MESH_DEPTH = 4
#: row-split linears of one forward, each one all_reduce: 4 in each joint
#: block, 2 in the context-pre-only last one
MESH_REDUCTIONS_PER_FORWARD = 4 * (MESH_DEPTH - 1) + 2
#: K1 at the per-rank head counts of tp 2 and 4 (24 heads)
MESH_HEADS = (12, 6)
#: every mesh rollout of phases 20 and 22 runs the same units: one chunk
#: (the first 7 actions: 8 units, 57 frames), and a served session adds the
#: boundary step's work (its 8th step closes the chunk and opens the next)
MESH_PROMPT = "(FN)" * 7
MESH_UNITS, MESH_FRAMES = 8, 57
#: denoise forwards of the exact one-chunk rollout: 8 units x 3 stages x 5 steps
MESH_FORWARDS = 120
#: phase 20 (b): each f32 mesh call (TF32 off) against the single-device
#: call on the same inputs, as relative L2 and as max |err|. The two sum in
#: other orders (the row-split partial products over the ranks, the CP group
#: norm's E[x^2] - mean^2 against the two-pass norm) and K1 runs 3xTF32 on
#: 12 heads a rank; on an H100 (NVIDIA H100 80GB HBM3, 700 W) the largest
#: were relative L2 5.8e-6 and max |err| 2.4e-5 (the cont decode window),
#: the forward 6.5e-7 and 4.9e-6. The bounds leave ~8x room
MESH_F32_REL_L2 = 5e-5
MESH_F32_MAX_ABS = 2e-4


def gloo_cuda_collectives(device) -> dict:
    """all_reduce (sum in bf16 and f32, max), all_gather and broadcast once
    each on CUDA tensors over this rank's gloo group; raises unless every
    one gave the right values. Returns {collective: True}."""
    import torch
    import torch.distributed as dist
    r, n = dist.get_rank(), dist.get_world_size()
    total = float(sum(range(1, n + 1)))
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.full((4096,), float(r + 1), dtype=dtype, device=device)
        dist.all_reduce(x)
        got[f"all_reduce sum {dtype}"] = bool((x.float() == total).all())
    x = torch.full((8,), float(r + 1), device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    got["all_reduce max"] = bool((x == float(n)).all())
    parts = [torch.empty(3, device=device) for _ in range(n)]
    dist.all_gather(parts, torch.full((3,), float(r), device=device))
    got["all_gather"] = all(bool((p == i).all()) for i, p in enumerate(parts))
    y = torch.full((4,), float(r + 7), device=device)
    dist.broadcast(y, 0)
    got["broadcast"] = bool((y == 7.0).all())
    assert all(got.values()), f"gloo collectives on CUDA tensors: {got}"
    return got


def mesh_rank_mesh():
    """This rank's two-rank gloo mesh on cuda:0, with the kernels loaded."""
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((MESH_RANKS,), ("tp",), devices=["cuda:0"] * MESH_RANKS, backend="gloo")
    att.load_library()
    return mesh


def mesh_rollout_part(mesh, pipe) -> dict:
    """Phase 20 (a), one rank: ``pipe`` (the MESH_DEPTH-block model, seed 0,
    on the mesh) runs phase 5's image and seed on the first chunk of its prompt
    (``MESH_PROMPT``): K1's launch and head counts, the reductions, and the
    frames (rank 0) or their hash."""
    import hashlib
    import torch
    from deepv_tpu_torch.models import mmdit as mm
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.parallel import comm

    # spies: K1's head count per call, the MMDiT's row-split reductions
    heads, rows = [], [0, 0]
    orig_attention, orig_row = mm.attention, mm._row_linear

    def attention_spy(q, k, v, valid, times, n_last=0):
        heads.append(q.shape[2])
        return orig_attention(q, k, v, valid, times, n_last=n_last)

    def row_spy(x, p, tp_group):
        y = orig_row(x, p, tp_group)
        rows[0] += 1
        rows[1] += y.numel() * y.element_size()
        return y

    pipe.timer.sync = True
    torch.cuda.reset_peak_memory_stats()
    mm.attention, mm._row_linear = attention_spy, row_spy
    att.launches = att.f32_launches = att.bwd_launches = 0
    comm.reset_counts()
    t0 = time.perf_counter()
    try:
        out = pipe.generate(rollout_batch(MESH_PROMPT), seed=666)
        torch.cuda.synchronize()
    finally:
        mm.attention, mm._row_linear = orig_attention, orig_row
    wall = time.perf_counter() - t0
    img = out["pred_img"]
    finite = all(bool(torch.isfinite(out[k]).all())
                 for k in ("pred_img", "pred_disparity", "trans3d", "trans2d"))
    stats = pipe.timer.stats()
    pipe.timer.sync = False
    return dict(rank=mesh.rank, wall_s=wall,
                frames=img.shape[2], shape=tuple(img.shape), finite=finite,
                launches=att.launches, f32_launches=att.f32_launches,
                bwd_launches=att.bwd_launches, heads=sorted(set(heads)),
                forwards=sum(map(sum, pipe.recompute_log)),
                row_reductions=rows[0], row_reduction_bytes=rows[1],
                all_reduce=comm.counts["all_reduce"], all_reduce_bytes=comm.nbytes["all_reduce"],
                all_gather=comm.counts["all_gather"], all_gather_bytes=comm.nbytes["all_gather"],
                phases_s={k: v["total_s"] for k, v in stats.items()},
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                sha256=hashlib.sha256(img.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
                pred_img=img.cpu() if mesh.rank == 0 else None,
                history_index=out["history_index"])


def mesh_two_rank_main() -> dict:
    """Phases 20 (a, b), 21 (a, c) and 22 in one spawn of the two ranks
    sharing cuda:0 (each spawn costs every rank a process, a CUDA context and
    a weight draw): gloo's collectives on CUDA tensors, then phase 5's
    weights cut to MESH_DEPTH blocks in bf16 in two mesh pipelines, the exact one and the --fast
    preset's (20 (a), 22), then 21 (a, c), then 20 (b) in f32."""
    import dataclasses
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig, create_model_config
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.io.weights import random_params
    from deepv_tpu_torch.pipeline import InferencePipeline

    mesh = mesh_rank_mesh()
    out = dict(rank=mesh.rank, collectives=gloo_cuda_collectives(mesh.device))
    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    mcfg, vcfg = dataclasses.replace(MMDiTConfig(), num_layers=MESH_DEPTH), VAEConfig()
    params = random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0, device=mesh.device)
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    pipe = InferencePipeline(cfg, mcfg, vcfg, params, embeds, dtype=torch.bfloat16, mesh=mesh)
    fast = InferencePipeline(cfg, mcfg, dataclasses.replace(vcfg, conv_impl="int8"), params,
                             embeds, dtype=torch.bfloat16, mesh=mesh, flow_cache="skip_odd",
                             denoise_int8=True)
    # rank 0 keeps the whole MMDiT for the single-device int8 forward
    single_tree = params["mmdit"] if mesh.rank == 0 else None
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    out["rollout"] = dict(mesh_rollout_part(mesh, pipe), setup_s=setup_s)
    out["serve"] = mesh_serve_part(mesh, pipe, fast, single_tree)
    del pipe, fast, single_tree
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = mesh_train_part(mesh)
    out["f32"] = mesh_f32_part(mesh)
    return out


def mesh_forward_inputs(device):
    """One denoise forward's arguments at chunk 1's stage-2 layout (2 CFG
    rows, unit 3, the first-frame mask), f32, from a seeded generator:
    (args, kwargs) of ``mmdit_forward`` after the model."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.pipeline import _pyramid_list, padded_conditions

    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    g = torch.Generator(device=device)
    g.manual_seed(21)
    lh, lw = HEIGHT // 8, WIDTH // 8
    gen = torch.randn((1, mcfg.in_channels, 4, lh, lw), generator=g, device=device)
    clips, ftimes, fvalid = padded_conditions(pcfg, _pyramid_list(gen, 2), 3, True, 2)[2]
    lat = torch.randn((1, mcfg.in_channels, 1, lh, lw), generator=g, device=device)
    mask = torch.zeros((2, 77), dtype=torch.int32, device=device)
    mask[:, :11] = 1
    text = torch.randn((2, 77, mcfg.joint_attention_dim), generator=g, device=device)
    pooled = torch.randn((2, mcfg.pooled_projection_dim), generator=g, device=device)
    args = (list(clips) + [torch.cat([lat] * 2)], text, mask, pooled,
            torch.full((2,), 700.0, device=device))
    return args, dict(frame_times=list(ftimes), frame_valid=list(fvalid), split_last_attn=True)


def diff_stats(got, ref) -> dict:
    """max |got - ref| and relative L2 (f32 values)."""
    d = (got.float() - ref.float())
    return dict(max_abs=float(d.abs().max()), rel_l2=float(d.norm() / ref.float().norm()))


def mesh_f32_part(mesh) -> dict:
    """Phase 20 (b), one rank: f32 at full width (TF32 off), each mesh call
    and, on rank 0, the single-device call on the same inputs: one denoise
    forward, cp_dec_window init then cont (2 latent frames each),
    cp_vae_decode_chunked of two streams at batch 2 (2 latent frames, the
    mesh route of decode_batched) against vae_decode of the same batch, and
    cp_vae_encode_chunked of a 17-frame 384x512 carry (window 8)."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig
    from deepv_tpu_torch.io.weights import params_from_numpy, random_params
    from deepv_tpu_torch.models.mmdit import MMDiT, mmdit_forward
    from deepv_tpu_torch.models.vae import VAE, _dec_window, chunk_encode, vae_decode
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.parallel.cp import (cp_dec_window, cp_vae_decode_chunked,
                                             cp_vae_encode_chunked)
    from deepv_tpu_torch.parallel.tp import shard_mmdit_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    dev, lead = mesh.device, mesh.rank == 0
    mcfg, vcfg = MMDiTConfig(), VAEConfig()
    params = random_params(mcfg, vcfg, dtype=torch.float32, seed=0, device=dev)
    vae = params_from_numpy(VAE(vcfg), params["vae"], dev)
    out = {}
    with torch.inference_mode():
        args, kw = mesh_forward_inputs(dev)
        model = params_from_numpy(MMDiT(mcfg, tp_group=mesh.group("tp")),
                                  shard_mmdit_params(params["mmdit"], mesh), dev)
        before = att.f32_launches
        v_mesh = mmdit_forward(model, *args, **kw)
        assert att.f32_launches - before == mcfg.num_layers, "mesh forward missed attn_fwd_tf32x3"
        del model
        if lead:
            v_single = mmdit_forward(params_from_numpy(MMDiT(mcfg), params["mmdit"]), *args, **kw)
            out["forward"] = diff_stats(v_mesh, v_single)
            del v_single
        del params, args, kw, v_mesh
        g = torch.Generator(device=dev)
        g.manual_seed(22)
        zs = [torch.randn((1, vcfg.encoder_out_channels, 2, HEIGHT // 8, WIDTH // 8),
                          generator=g, device=dev) for _ in range(2)]
        y0, cache = cp_dec_window(vcfg, vae.decoder, zs[0], None, "init", mesh)
        y1, cache = cp_dec_window(vcfg, vae.decoder, zs[1], cache, "cont", mesh)
        del cache
        if lead:
            r0, ref_cache = _dec_window(vcfg, vae.decoder, zs[0], None, "init")
            out["dec_window_init"] = diff_stats(y0, r0)
            del r0
            r1, ref_cache = _dec_window(vcfg, vae.decoder, zs[1], ref_cache, "cont")
            out["dec_window_cont"] = diff_stats(y1, r1)
            del r1, ref_cache
        del y0, y1
        # rgb and disparity latents as one batch-2 context-parallel decode,
        # the mesh route of decode_batched's plain branch
        zb = torch.randn((2, vcfg.encoder_out_channels, 2, HEIGHT // 8, WIDTH // 8),
                         generator=g, device=dev)
        yb = cp_vae_decode_chunked(vcfg, vae, zb, mesh, "tp", window_size=2)
        if lead:
            out["decode_chunked_b2"] = diff_stats(
                yb, vae_decode(vcfg, vae, zb, temporal_chunk=True, window_size=2))
        del zb, yb
        x = torch.randn((1, 3, 17, HEIGHT, WIDTH), generator=g, device=dev)
        m = cp_vae_encode_chunked(vcfg, vae, x, mesh, "tp", window_size=8)
        if lead:
            out["encode_chunked"] = diff_stats(m, chunk_encode(vcfg, vae.encoder, x, 8))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def mesh_nccl_rank() -> dict:
    """Phase 20 (d): world size 1 over NCCL (the multi-card backend), one f32
    forward and one init decode window through the mesh code, each against
    the single-device call on the same inputs."""
    import torch
    import torch.distributed as dist
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig
    from deepv_tpu_torch.io.weights import params_from_numpy, random_params
    from deepv_tpu_torch.models.mmdit import MMDiT, mmdit_forward
    from deepv_tpu_torch.models.vae import VAE, _dec_window
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.parallel.cp import cp_dec_window
    from deepv_tpu_torch.parallel.mesh import make_mesh
    from deepv_tpu_torch.parallel.tp import shard_mmdit_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((1,), ("tp",))
    att.load_library()
    dev = mesh.device
    mcfg, vcfg = MMDiTConfig(), VAEConfig()
    params = random_params(mcfg, vcfg, dtype=torch.float32, seed=0, device=dev)
    vae = params_from_numpy(VAE(vcfg), params["vae"], dev)
    out = dict(backend=dist.get_backend(), device=str(dev))
    with torch.inference_mode():
        args, kw = mesh_forward_inputs(dev)
        v_mesh = mmdit_forward(params_from_numpy(MMDiT(mcfg, tp_group=mesh.group("tp")),
                                                 shard_mmdit_params(params["mmdit"], mesh), dev),
                               *args, **kw)
        v_single = mmdit_forward(params_from_numpy(MMDiT(mcfg), params["mmdit"]), *args, **kw)
        out["forward"] = dict(diff_stats(v_mesh, v_single), bit_equal=bool(torch.equal(v_mesh,
                                                                                     v_single)))
        del params, v_mesh, v_single
        g = torch.Generator(device=dev)
        g.manual_seed(22)
        z = torch.randn((1, vcfg.encoder_out_channels, 2, HEIGHT // 8, WIDTH // 8), generator=g,
                        device=dev)
        y, _ = cp_dec_window(vcfg, vae.decoder, z, None, "init", mesh)
        r, _ = _dec_window(vcfg, vae.decoder, z, None, "init")
        out["dec_window_init"] = dict(diff_stats(y, r), bit_equal=bool(torch.equal(y, r)))
    return out


def check_mesh_heads(device, results):
    """Phase 20 (c): K1 at 12 and 6 heads (tp 2 and 4) at phase 3's rollout
    layouts, against its plain version with phase 3's bf16 tolerances;
    timed beside the 24-head kernel at the same layout (back to back, host
    time included, and as device time from a CUDA graph), SDPA and the
    bound."""
    import torch
    import torch.nn.functional as F
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask
    from deepv_tpu_torch.ops import attention as att

    mcfg = MMDiTConfig()
    d = mcfg.attention_head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(23)
    out = []
    for name, b, shapes, ctx, ftimes, fvalid in rollout_layouts(device):
        layout = PackedLayout(mcfg, shapes, ctx.shape[1])
        valid, times = packed_mask(layout, ctx, ftimes, fvalid)
        s, n_last = layout.seq_len, layout.clip_tokens[-1]
        allowed = ((valid[:, :, None] == valid[:, None, :])
                   & (times[:, None] >= times[None, :])[None])
        pairs = int(allowed.sum())
        times24 = None
        for h in (mcfg.num_attention_heads,) + MESH_HEADS:
            q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device) for _ in range(3))
            if h == mcfg.num_attention_heads:     # checked in phase 3
                qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
                errs = {}
            else:
                (qb, kb, vb), errs = check_attention_bf16(f"{name} h={h}", q, k, v, valid,
                                                          times, n_last)
            flops = 4 * pairs * h * d
            nbytes = 4 * b * s * h * d * 2 + valid.numel() * 4 + times.numel() * 4
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            call = lambda: att.attention(qb, kb, vb, valid, times, n_last=n_last)
            ms, device_ms = cuda_time_ms(call, 20), graph_ms(call, 20)
            if times24 is None:
                times24 = (ms, device_ms)
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (qb, kb, vb))
            library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allowed[:, None]), 10)
            row = dict(layout=name, heads=h, b=b, S=s, ctas=math.ceil(s / 128) * b * h, ms=ms,
                       graph_ms=device_ms, ms_24_heads=times24[0],
                       graph_ms_24_heads=times24[1], library_ms=library_ms,
                       bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       tflops=flops / (device_ms * 1e-3) / 1e12, **errs)
            out.append(row)
            log("mesh path (c): K1", json.dumps(row))
            del qt, kt, vt
        del q, k, v, qb, kb, vb, allowed
    results["mesh_heads"] = out
    return out


def run_mesh_path(device, results):
    """Phase 20 (M17b): (c) K1 at the per-rank head counts, (e) run.py
    --tp_shards 2 refused on this one-card machine, (a) the first chunk of
    phase 5's prompt on the model cut to MESH_DEPTH blocks through
    InferencePipeline(mesh=...) on two gloo ranks sharing the card, (b)
    the f32 gates on the same two ranks, (d) world size 1 over NCCL. (a)
    and (b) run in ``mesh_two_rank_main``'s spawn,
    which also runs phases 21 (a, c) and 22. Returns (a)'s K1 launches per
    rank, (c)'s rows, (a)'s frames and every rank's result of that spawn."""
    import torch
    from deepv_tpu_torch import run
    from deepv_tpu_torch.parallel.launch import spawn

    label = "two ranks sharing one card over gloo, not a deployment number"
    heads = check_mesh_heads(device, results)
    cards = torch.cuda.device_count()
    n = max(2, cards + 1)
    try:
        run.main("unused.png", "none", prompt="(FN)", random_weights=True, tp_shards=n)
    except RuntimeError as e:
        assert f"this machine has {cards}" in str(e), str(e)
        log(f"mesh path (e): run.main(tp_shards={n}) on {cards} card(s) refused: {e}")
    else:
        raise AssertionError(f"run.main(tp_shards={n}) ran on {cards} card(s)")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    two = spawn(mesh_two_rank_main, MESH_RANKS, backend="gloo")
    spawn_s = time.perf_counter() - t0
    log(f"mesh path (a): gloo on CUDA tensors: {two[0]['collectives']}")
    ranks = [r["rollout"] for r in two]
    expected = MESH_FORWARDS * MESH_DEPTH
    for r in ranks:
        assert r["shape"] == (1, 3, MESH_FRAMES, HEIGHT, WIDTH) and r["finite"], (r["rank"],
                                                                                 r["shape"])
        assert r["forwards"] == MESH_FORWARDS, r["forwards"]
        assert r["launches"] == expected, f"rank {r['rank']}: K1 launched {r['launches']} times"
        assert r["heads"] == [24 // MESH_RANKS], f"rank {r['rank']}: K1 at heads {r['heads']}"
        assert r["bwd_launches"] == 0 and r["f32_launches"] == 0, r
    assert ranks[1]["sha256"] == ranks[0]["sha256"], "rank 1's frames differ from rank 0's"
    mesh_frames = ranks[0]["pred_img"]
    summary = [{k: v for k, v in r.items() if k != "pred_img"} for r in ranks]
    for r in summary:
        log(f"mesh path (a), rank {r['rank']} ({label}):", json.dumps(r))
    log(f"mesh path (a): {MESH_RANKS} ranks' frames bit-equal; K1 {expected} launches per rank at "
        f"{24 // MESH_RANKS} heads; row-split reductions {ranks[0]['row_reductions']} "
        f"(expected {MESH_REDUCTIONS_PER_FORWARD * MESH_FORWARDS}) at depth {MESH_DEPTH}; the "
        f"spawn of phases 20 (a, b), 21 (a, c) and 22 took {spawn_s:.1f} s")
    del ranks[0]["pred_img"]

    f32 = two[0]["f32"]
    log("mesh path (b): f32 mesh vs single device:", json.dumps(f32))
    for key in ("forward", "dec_window_init", "dec_window_cont", "decode_chunked_b2",
                "encode_chunked"):
        e = f32[key]
        assert e["rel_l2"] <= MESH_F32_REL_L2 and e["max_abs"] <= MESH_F32_MAX_ABS, (key, e)
    nccl = spawn(mesh_nccl_rank, 1, backend="nccl")[0]
    log("mesh path (d): world size 1 over NCCL:", json.dumps(nccl))
    for key in ("forward", "dec_window_init"):
        e = nccl[key]
        assert e["rel_l2"] <= MESH_F32_REL_L2 and e["max_abs"] <= MESH_F32_MAX_ABS, (key, e)
    results["mesh_path"] = dict(rollout=summary, depth=MESH_DEPTH, spawn_s=spawn_s, f32=f32,
                                nccl_world_1=nccl, label=label)
    return expected, heads, mesh_frames, two


# ---------------------------------------------------------------------------
# phases 21-22: training and serving over a mesh (M17c), as gloo ranks on
# this one card
# ---------------------------------------------------------------------------

#: phase 21's draws (TorchNoise seeds): (a) and (c), and (b)
MESH_TRAIN_SEED, MESH_DP_TP_SEED = 21, 22
#: phase 21 (a): the tp-2 f32 step against phase 15's single-device step on
#: the same weights, batch and draws (TF32 off). Both sum in other orders
#: (the row-split partial products over the ranks; cuBLAS picks its
#: algorithm by shape, and every split product has half the width) and
#: phase 20 (b) measured the f32 mesh forward within relative L2 6.5e-7 of
#: the single-device one; a squared-error mean over 300k values and a
#: gradient's norm average those differences out. Bounds: relative
MESH_TRAIN_LOSS_RTOL = 1e-4
MESH_TRAIN_NORM_RTOL = 1e-3
#: phase 21 (b): the depth of the dp 2 x tp 2 cut model. Each of the four
#: ranks holds the cut model whole (its single-device reference step) and
#: its tp half, each with gradients and AdamW state, ~16 + 11 bytes a
#: parameter at 85 M parameters a layer, plus a step's activations: at 4
#: layers ~13 GB a rank, four ranks beside each other on the card
MESH_DP_TP_DEPTH = 4
#: phase 21 (b): the dp x tp step against the single-device step of the cut
#: model on the global batch (f32, TF32 off): each gradient element within
#: MESH_GRAD_RTOL of its leaf's largest |g| (sums in other orders, the dp
#: mean formed as a sum over the ranks divided by 2), each parameter after
#: AdamW within MESH_PARAM_ATOL. A first AdamW step moves a parameter by
#: lr * g / (|g| + eps) plus the decay, lr = 1e-4, eps = 1e-8: where |g| is
#: near eps, a gradient difference of ~1e-9 (the summation-order difference
#: on a leaf whose largest |g| is ~1e-3) moves that by up to ~lr / 4. On an
#: H100 the largest parameter difference was 1.06e-5 (the gradients within
#: 2.3e-6 of their leaves' largest). Half of lr bounds it; a step that is
#: missing or of the wrong sign moves a parameter by lr or 2 lr
MESH_GRAD_RTOL = 1e-3
MESH_PARAM_ATOL = 5e-5
#: phase 21 (b): the parameters of the cut model, for the disk check of its
#: checkpoint (a full-width layer holds ~85 M)
MESH_DP_TP_PARAMS = 400_000_000


def attention_head_spy():
    """Wraps models/mmdit's attention to record each call's head count.
    Returns (the recorded list, a function that restores it)."""
    from deepv_tpu_torch.models import mmdit as mm
    heads, orig = [], mm.attention

    def spy(q, k, v, valid, times, n_last=0):
        heads.append(q.shape[2])
        return orig(q, k, v, valid, times, n_last=n_last)

    mm.attention = spy

    def restore():
        mm.attention = orig
    return heads, restore


def replicated_digest(model) -> str:
    """A hash of the bits of every parameter the tensor-parallel split
    leaves whole."""
    import hashlib
    import torch
    from deepv_tpu_torch.parallel.tp import mmdit_param_spec
    h = hashlib.blake2b()
    for name, p in model.named_parameters():
        if not mmdit_param_spec(name, p):
            h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_train_step(trainer, batch, noise, stage: int, name: str) -> dict:
    """One pyramid step of ``trainer`` with K1's counts and the collectives'
    set to 0 just before and read just after; its seconds and peak memory."""
    import torch
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.parallel import comm
    heads, restore = attention_head_spy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.launches = att.f32_launches = att.bwd_launches = 0
    comm.reset_counts()
    t0 = time.perf_counter()
    try:
        loss = float(trainer.step_fn(batch, noise, stage, TRAIN_UNIT))
        torch.cuda.synchronize()
    finally:
        restore()
    return dict(step=name, loss=loss, seconds=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=dict(attn_fwd_wgmma=att.launches, attn_fwd_tf32x3=att.f32_launches,
                              attn_bwd=att.bwd_launches),
                heads=sorted(set(heads)), collectives=dict(calls=dict(comm.counts),
                                                           bytes=dict(comm.nbytes)))


def mesh_train_part(mesh) -> dict:
    """Phase 21 (a) and (c), one rank of the two-rank mesh: (a) phase 15's
    full-width f32 model, batch and a stage-2 step with phase 21's draws,
    through Trainer on this rank's tensor-parallel share; each leaf's
    squared gradient norm, the replicated leaves' digest after the step;
    (c) one bf16 stage-2 step on bf16 weights from the same seed."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.io.weights import params_from_numpy, random_mmdit_params
    from deepv_tpu_torch.models.mmdit import MMDiT
    from deepv_tpu_torch.parallel.tp import mmdit_param_spec, shard_mmdit_params
    from deepv_tpu_torch.pipeline import TorchNoise
    from deepv_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    out = dict(rank=mesh.rank)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        t0 = time.perf_counter()
        tree = random_mmdit_params(mcfg, dtype, seed=0, device=dev)
        model = params_from_numpy(MMDiT(mcfg, tp_group=mesh.group("tp")),
                                  shard_mmdit_params(tree, mesh), dev)
        del tree
        trainer = Trainer(mcfg, model, learning_rate=1e-4, weight_decay=0.01, pcfg=pcfg,
                          device=dev)
        batch = training_batch(dev, dtype)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        seed = MESH_TRAIN_SEED if tag == "f32" else 16
        row = mesh_train_step(trainer, batch, TorchNoise(seed, dev), 2,
                              f"tp 2, pyramid stage 2, unit {TRAIN_UNIT}, {tag}")
        row.update(setup_s=setup_s, params=sum(p.numel() for p in model.parameters()))
        if tag == "f32":
            # each leaf's squared gradient norm, and whether it is split
            named = list(model.named_parameters())
            sq = torch.stack([p.grad.float().square().sum() for _, p in named])
            out["grad_sq_norms"] = {n: (x, bool(mmdit_param_spec(n, p)))
                                    for (n, p), x in zip(named, sq.tolist())}
            out["grads_finite"] = bool(torch.isfinite(sq).all())
            out["replicated_digest"] = replicated_digest(model)
        out[tag] = row
        del trainer, model, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def state_bits_equal(a: dict, b: dict, device) -> bool:
    """Two trainer state trees ({"params", "opt_state": {"count", "mu",
    "nu"}}, tensors anywhere) hold the same keys, shapes and bits."""
    import torch
    from deepv_tpu_torch.io.weights import flatten_tree
    fa, fb = flatten_tree(a), flatten_tree(b)
    if set(fa) != set(fb):
        return False
    for k, x in fa.items():
        y = fb[k]
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        x, y = (t.detach().to(device).contiguous().reshape(-1).view(torch.uint8) for t in (x, y))
        if not torch.equal(x, y):
            return False
    return True


def mesh_checkpoint_part(mesh, mcfg, pcfg, batch, ref_params, ref_state, ckpt_root) -> dict:
    """Phase 21 (b)'s checkpoint round trip (fault F10), one rank of the dp 2
    x tp 2 mesh: a tp-2 Trainer of the cut model takes phase 21 (b)'s step
    on the global batch and saves (every rank calls save, global rank 0
    writes one whole tree); each rank checks the file's slices of its tp
    index against its live state bit for bit and restores the file into a
    fresh tp-2 Trainer (other random weights); rank 0 checks every leaf's
    whole shape and the parameters against the single-device Trainer's
    (``ref_state``, on its CPU) and restores the file into a fresh
    single-device Trainer. ``ref_params``: the single-device step's
    parameters, this rank's slices."""
    import torch
    import torch.distributed as dist
    from deepv_tpu_torch.io.checkpoint import STATE_FILE
    from deepv_tpu_torch.io.weights import params_from_numpy, random_mmdit_params
    from deepv_tpu_torch.models.mmdit import MMDiT
    from deepv_tpu_torch.parallel.tp import shard_mmdit_params
    from deepv_tpu_torch.pipeline import TorchNoise
    from deepv_tpu_torch.training.trainer import Trainer

    dev, f32 = mesh.device, torch.float32

    def trainer(seed, group):
        params = random_mmdit_params(mcfg, f32, seed=seed, device=dev)
        model = MMDiT(mcfg, tp_group=group)
        if group is not None:
            params = shard_mmdit_params(params, mesh)
        return Trainer(mcfg, params_from_numpy(model, params, dev), learning_rate=1e-4,
                       weight_decay=0.01, pcfg=pcfg, device=dev, ckpt_dir=ckpt_root)

    out = {}
    tp = trainer(0, mesh.group("tp"))
    tp.step_fn(batch, TorchNoise(MESH_DP_TP_SEED, dev), 2, TRAIN_UNIT)
    tp.step += 1
    out["step_param_err"] = max(float((p.detach() - ref_params[n]).abs().max())
                                for n, p in tp.model.named_parameters())
    tp.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = tp.save()
    out["save_s"] = time.perf_counter() - t
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True,
                       mmap=True)
    opt = saved["opt_state"]
    mine = {"params": shard_mmdit_params(saved["params"], mesh),
            "opt_state": {"count": opt["count"], "mu": shard_mmdit_params(opt["mu"], mesh),
                          "nu": shard_mmdit_params(opt["nu"], mesh)}}
    live = tp.state_tree()
    out["slices_equal"] = state_bits_equal(mine, live, dev)
    del mine
    fresh = trainer(1, mesh.group("tp"))
    t = time.perf_counter()
    fresh.restore(path)
    torch.cuda.synchronize()
    out["restore_tp2_s"] = time.perf_counter() - t
    out["restored_tp2_equal"] = state_bits_equal(fresh.state_tree(), live, dev)
    out["restored_step"] = fresh.step
    del tp, fresh, live
    gc.collect()
    torch.cuda.empty_cache()
    if mesh.rank == 0:
        out["gb"] = os.path.getsize(os.path.join(path, STATE_FILE)) / 1e9
        out["whole_shapes"] = all(
            tuple(saved[k][n].shape) == tuple(v.shape) if k == "params" else
            tuple(opt[k][n].shape) == tuple(v.shape)
            for k in ("params", "mu", "nu") for n, v in ref_state["params"].items())
        out["param_err_vs_single"] = max(float((saved["params"][n] - v).abs().max())
                                         for n, v in ref_state["params"].items())
        for k in ("mu", "nu"):
            out[f"{k}_err_vs_single"] = max(float((opt[k][n] - v).abs().max())
                                            for n, v in ref_state[k].items())
        single = trainer(1, None)
        t = time.perf_counter()
        single.restore(path)
        torch.cuda.synchronize()
        out["restore_single_s"] = time.perf_counter() - t
        out["restored_single_equal"] = state_bits_equal(single.state_tree(), saved, dev)
        out["restored_single_step"] = single.step
        del single
        gc.collect()
        torch.cuda.empty_cache()
    del saved, opt
    dist.barrier()
    return out


def mesh_dp_tp_rank(depth: int, ckpt_root: str) -> dict:
    """Phase 21 (b), one rank of the dp 2 x tp 2 mesh (four gloo ranks on
    cuda:0): the full-width model cut to ``depth`` layers, f32. The
    single-device Trainer's step of the whole cut model on the global batch
    (2 rows), then the DP x TP step of this rank's share on its dp row with
    its slice of the same draws; every gradient element and parameter after
    AdamW of this rank's share against the single-device one's slice, and a
    digest of the share after the step; then ``mesh_checkpoint_part`` into
    ``ckpt_root``."""
    import dataclasses
    import hashlib
    import torch
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.io.weights import params_from_numpy, random_mmdit_params
    from deepv_tpu_torch.models.mmdit import MMDiT
    from deepv_tpu_torch.models.scheduler import FlowMatchSchedule
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.parallel import comm
    from deepv_tpu_torch.parallel.dryrun import dryrun_rank
    from deepv_tpu_torch.parallel.mesh import make_mesh
    from deepv_tpu_torch.parallel.tp import shard_mmdit_params
    from deepv_tpu_torch.pipeline import TorchNoise
    from deepv_tpu_torch.training.flow_matching import BatchSliceNoise, make_pyramid_train_step
    from deepv_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((2, 2), ("dp", "tp"), devices=["cuda:0"] * 4, backend="gloo")
    att.load_library()
    dev, f32 = mesh.device, torch.float32
    mcfg = dataclasses.replace(MMDiTConfig(), num_layers=depth)
    pcfg = PipelineConfig()
    sched = FlowMatchSchedule(pcfg.scheduler)
    adamw = lambda m: torch.optim.AdamW(m.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                        weight_decay=0.01)
    batch = training_batch(dev, f32, b=2)
    torch.cuda.reset_peak_memory_stats()
    single = Trainer(mcfg, params_from_numpy(MMDiT(mcfg), random_mmdit_params(
        mcfg, f32, seed=0, device=dev), dev), learning_rate=1e-4, weight_decay=0.01, pcfg=pcfg,
        device=dev)
    single_loss = float(single.step_fn(batch, TorchNoise(MESH_DP_TP_SEED, dev), 2, TRAIN_UNIT))
    named = dict(single.model.named_parameters())
    ref_grads = shard_mmdit_params({n: p.grad for n, p in named.items()}, mesh)
    ref_params = shard_mmdit_params({n: p.detach() for n, p in named.items()}, mesh)
    # the checkpoint part's reference: the single-device state, whole, on
    # rank 0's CPU
    ref_state = None
    if mesh.rank == 0:
        opt = single.state_tree()["opt_state"]
        ref_state = {"params": {n: p.detach().cpu() for n, p in named.items()},
                     "mu": {n: t.cpu() for n, t in opt["mu"].items()},
                     "nu": {n: t.cpu() for n, t in opt["nu"].items()}}
    del single, named
    gc.collect()
    model = params_from_numpy(MMDiT(mcfg, tp_group=mesh.group("tp")), shard_mmdit_params(
        random_mmdit_params(mcfg, f32, seed=0, device=dev), mesh), dev).requires_grad_(True)
    step = make_pyramid_train_step(model, pcfg, sched, adamw(model), mesh=mesh)
    i = mesh.index("dp")
    att.launches = att.f32_launches = att.bwd_launches = 0
    comm.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step({k: v[i:i + 1] for k, v in batch.items()},
                      BatchSliceNoise(TorchNoise(MESH_DP_TP_SEED, dev), i, 2), 2, TRAIN_UNIT))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del step
    grad_err = param_err = 0.0
    digest = hashlib.blake2b()
    for name, p in model.named_parameters():
        g_ref, p_ref = ref_grads[name], ref_params[name]
        scale = float(g_ref.abs().max())
        grad_err = max(grad_err, float((p.grad - g_ref).abs().max()) / max(scale, 1e-30))
        param_err = max(param_err, float((p.detach() - p_ref).abs().max()))
        digest.update(p.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    out = dict(rank=mesh.rank, dp=i, tp=mesh.index("tp"), depth=depth, loss=loss,
               single_loss=single_loss, seconds=seconds,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=dict(attn_fwd_tf32x3=att.f32_launches, attn_bwd=att.bwd_launches,
                             attn_fwd_wgmma=att.launches),
               collectives=dict(calls=dict(comm.counts), bytes=dict(comm.nbytes)),
               max_grad_err_rel=grad_err, max_param_err=param_err, digest=digest.hexdigest())
    del model, ref_grads
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["ckpt"] = mesh_checkpoint_part(mesh, mcfg, pcfg, batch, ref_params, ref_state,
                                       ckpt_root)
    out["ckpt"]["seconds"] = time.perf_counter() - t0
    del ref_params, ref_state
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the dry run's rank body (what run_dryrun(4, shared_card=True)
    # spawns) in this process group
    t0 = time.perf_counter()
    out["dryrun_loss"] = dryrun_rank(4, False, "cuda", True)
    out["dryrun_s"] = time.perf_counter() - t0
    return out


def run_dp_tp_path(label: str):
    """Phase 21 (b) and its checkpoint round trip: four gloo ranks on this
    card (``mesh_dp_tp_rank``), their checks and printout. Returns (the
    summary, every rank's results)."""
    from deepv_tpu_torch.parallel.launch import spawn

    ckpt_root = tempfile.mkdtemp(prefix="_train_ckpt_", dir=HERE)
    try:
        # the tree and its two AdamW moments in f32, written once
        check_disk(ckpt_root, 12 * MESH_DP_TP_PARAMS, "phase 21 (b)'s checkpoint")
        t0 = time.perf_counter()
        dp = spawn(mesh_dp_tp_rank, 4, (MESH_DP_TP_DEPTH, ckpt_root), backend="gloo")
        dp_spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    for r in dp:
        assert r["launches"] == dict(attn_fwd_tf32x3=MESH_DP_TP_DEPTH, attn_bwd=MESH_DP_TP_DEPTH,
                                     attn_fwd_wgmma=0), r
        assert r["max_grad_err_rel"] <= MESH_GRAD_RTOL, r
        assert r["max_param_err"] <= MESH_PARAM_ATOL, r
        assert abs(r["loss"] - r["single_loss"]) <= MESH_TRAIN_LOSS_RTOL * abs(r["single_loss"]), r
    for tp in (0, 1):
        a, b = (r for r in dp if r["tp"] == tp)
        assert a["digest"] == b["digest"] and a["loss"] == b["loss"], \
            f"the dp replicas of tp rank {tp} differ after the step"
    for r in dp:
        log(f"mesh training (b), rank {r['rank']} (dp {r['dp']}, tp {r['tp']}; {label}):",
            json.dumps({k: v for k, v in r.items() if k != "digest"}))
    log(f"mesh training (b): dp 2 x tp 2 at depth {MESH_DP_TP_DEPTH} (full width): gradients "
        f"within {max(r['max_grad_err_rel'] for r in dp):.2e} of each leaf's largest, params "
        f"within {max(r['max_param_err'] for r in dp):.2e} of the single-device step; dp "
        f"replicas bit-equal; spawn to return {dp_spawn_s:.1f} s")
    summary = dict(depth=MESH_DP_TP_DEPTH, spawn_s=dp_spawn_s,
                   ranks=[{k: v for k, v in r.items() if k != "digest"} for r in dp])

    # (b)'s checkpoint round trip (F10): one whole tree from the tp-2 Trainer
    ck = [r["ckpt"] for r in dp]
    for r, c in zip(dp, ck):
        assert c["slices_equal"], f"rank {r['rank']}: the checkpoint's slices differ from its state"
        assert c["restored_tp2_equal"] and c["restored_step"] == 1, (r["rank"], c)
        assert c["step_param_err"] <= MESH_PARAM_ATOL, (r["rank"], c)
    head = ck[0]
    assert head["whole_shapes"], "the checkpoint holds a leaf at other than its whole shape"
    assert head["param_err_vs_single"] <= MESH_PARAM_ATOL, head
    assert head["restored_single_equal"] and head["restored_single_step"] == 1, head
    summary["checkpoint"] = dict(ranks=ck)
    log(f"mesh training (b) checkpoint (F10): the tp-2 Trainer's {head['gb']:.2f} GB checkpoint "
        f"(depth {MESH_DP_TP_DEPTH}, full width, f32, one whole tree written by rank 0) saved in "
        f"{max(c['save_s'] for c in ck):.1f} s, restored into fresh tp-2 Trainers in "
        f"{max(c['restore_tp2_s'] for c in ck):.1f} s and into a single-device Trainer in "
        f"{head['restore_single_s']:.1f} s, bit for bit on every rank; each rank's slices equal "
        f"its live state bit for bit; parameters within {head['param_err_vs_single']:.2e} of the "
        f"single-device Trainer's (moments: mu {head['mu_err_vs_single']:.2e}, nu "
        f"{head['nu_err_vs_single']:.2e}; {label})")
    return summary, dp


def run_mesh_training_path(device, results, reference, two):
    """Phase 21 (M17c): training over a mesh on this one card. (a) and (c)
    ran on the two gloo ranks of phase 20's spawn (``mesh_train_part``;
    ``two`` holds every rank's results), (b) and the dry run's rank body on
    four (``mesh_dp_tp_rank``), (d) the dry run's entry point refused.
    ``reference``: phase 15's single-device loss and gradient norms of (a)'s
    step. Returns (a)'s and (c)'s K1 launches per rank."""
    import torch
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.parallel.dryrun import run_dryrun

    label = "gloo ranks sharing one card, not a deployment number"
    n_layers = MMDiTConfig().num_layers
    ranks = [r["train"] for r in two]
    for r in ranks:
        for tag, fwd in (("f32", "attn_fwd_tf32x3"), ("bf16", "attn_fwd_wgmma")):
            row = r[tag]
            want = dict(attn_fwd_wgmma=0, attn_fwd_tf32x3=0, attn_bwd=n_layers)
            want[fwd] = n_layers
            assert row["launches"] == want, (r["rank"], tag, row["launches"])
            assert row["heads"] == [24 // MESH_RANKS], (r["rank"], tag, row["heads"])
            assert math.isfinite(row["loss"]), (r["rank"], tag, row["loss"])
        assert r["grads_finite"], r["rank"]
    assert ranks[1]["replicated_digest"] == ranks[0]["replicated_digest"], \
        "the ranks' replicated leaves differ after the step"
    assert ranks[1]["f32"]["loss"] == ranks[0]["f32"]["loss"]
    loss_rel = abs(ranks[0]["f32"]["loss"] - reference["loss"]) / abs(reference["loss"])
    assert loss_rel <= MESH_TRAIN_LOSS_RTOL, (ranks[0]["f32"]["loss"], reference["loss"])
    worst = (0.0, None)
    for name, ref_norm in reference["grad_norms"].items():
        split = ranks[0]["grad_sq_norms"][name][1]
        sq = [r["grad_sq_norms"][name][0] for r in (ranks if split else ranks[:1])]
        rel = abs(math.sqrt(sum(sq)) - ref_norm) / max(ref_norm, 1e-30)
        worst = max(worst, (rel, name))
    assert worst[0] <= MESH_TRAIN_NORM_RTOL, f"gradient norm of {worst[1]}: relative {worst[0]}"
    summary = dict(label=label, loss_rel_err=loss_rel,
                   grad_norm_max_rel_err=worst[0], grad_norm_worst_leaf=worst[1],
                   reference_loss=reference["loss"],
                   ranks=[{k: v for k, v in r.items() if k != "grad_sq_norms"} for r in ranks])
    for r in summary["ranks"]:
        log(f"mesh training (a, c), rank {r['rank']} ({label}):", json.dumps(r))
    log(f"mesh training (a): tp 2 f32 step loss {ranks[0]['f32']['loss']:.6f} against the single "
        f"device's {reference['loss']:.6f} (relative {loss_rel:.2e}); per-leaf gradient norms "
        f"within relative {worst[0]:.2e} ({worst[1]}); replicated leaves bit-equal on both ranks")

    summary["dp_tp"], dp = run_dp_tp_path(label)

    # (d) the dry run: its entry point refused over NCCL without a card a
    # rank; its rank body ran on the four ranks of (b)
    cards = torch.cuda.device_count()
    try:
        run_dryrun(cards + 1)
    except RuntimeError as e:
        assert f"this machine has {cards}" in str(e), str(e)
    else:
        raise AssertionError(f"run_dryrun({cards + 1}) ran on {cards} card(s)")
    losses = [r["dryrun_loss"] for r in dp]
    assert all(math.isfinite(x) for x in losses) and len(set(losses)) == 1, losses
    summary["dryrun"] = dict(loss=losses[0], seconds=max(r["dryrun_s"] for r in dp))
    log(f"mesh training (d): the dry run's rank body on four gloo ranks sharing the card: loss "
        f"{losses[0]:.4f} on every rank in {summary['dryrun']['seconds']:.1f} s; "
        f"run_dryrun({cards + 1}) refused on {cards} card(s)")
    results["mesh_training_path"] = summary
    return {tag: ranks[0][tag]["launches"] for tag in ("f32", "bf16")}


def mesh_serve_part(mesh, pipe, fast, single_tree) -> dict:
    """Phase 22, one rank of the two-rank mesh on phase 20 (a)'s weights: (a)
    rank 0 serves ``MESH_PROMPT``'s units over HTTP through ``pipe`` with phase
    5's image and seed while rank 1 follows; (b) the --fast preset's rollout
    of the same units through ``fast``, then one int8 denoise forward on the
    mesh and, on rank 0, on one device (``single_tree``, the whole MMDiT),
    on the same inputs."""
    import numpy as np
    import torch
    from deepv_tpu_torch import serve
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.io.weights import params_from_numpy
    from deepv_tpu_torch.models.mmdit import MMDiT, mmdit_forward, quantize_mmdit
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.ops import conv_igemm as cig
    from deepv_tpu_torch.ops import conv_int8 as ci8
    from deepv_tpu_torch.ops import linear_int8 as li8
    from deepv_tpu_torch.parallel import comm

    dev, lead = mesh.device, mesh.rank == 0
    cfg, mcfg = pipe.cfg, pipe.mcfg

    def reset():
        att.launches = att.f32_launches = att.bwd_launches = 0
        for name in K2_COUNTERS:
            setattr(cig, name, 0)
        ci8.launches = ci8.packed_launches = ci8.quantize_launches = li8.calls = 0
        comm.reset_counts()

    def counts():
        return dict(attn_fwd_wgmma=att.launches, attn_fwd_tf32x3=att.f32_launches,
                    attn_bwd=att.bwd_launches,
                    conv_igemm={name: getattr(cig, name) for name in K2_COUNTERS},
                    conv_int8=ci8.launches + ci8.packed_launches,
                    quantize_k3=ci8.quantize_launches, int_mm=li8.calls,
                    all_reduce=comm.counts["all_reduce"], all_gather=comm.counts["all_gather"],
                    all_reduce_bytes=comm.nbytes["all_reduce"],
                    all_gather_bytes=comm.nbytes["all_gather"])

    out = dict(rank=mesh.rank)
    batch = rollout_batch(MESH_PROMPT)
    actions = serve.InteractiveSession.actions_from_prompt_list(cfg, list(batch["prompt"]))
    heads, restore = attention_head_spy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    try:
        if not lead:
            out["followed"] = serve.follow(pipe)
            torch.cuda.synchronize()
            out["served"] = counts()
        else:
            server = serve.SessionServer(pipe, port=0)
            port = server.start()
            steps, times = [], []
            try:
                t0 = time.perf_counter()
                status, body = http_call(port, "POST", "/session",
                                         {"image": serve._np_b64(batch["img"]), "seed": 666})
                assert status == 200, body
                sid = body["session_id"]
                for action in actions:
                    t = time.perf_counter()
                    status, body = http_call(port, "POST", "/step",
                                             {"session_id": sid, "action": action})
                    assert status == 200, body
                    times.append(time.perf_counter() - t)
                    steps.append(body)
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                out["served"] = counts()
                status, metrics = http_call(port, "GET", "/metrics")
                http_call(port, "POST", "/close", {"session_id": sid})
            finally:
                server.stop()
            frames = np.concatenate([wire_f16(s["rgb"]) for s in steps], axis=2)
            out.update(served_frames=frames, step_s=times, wall_s=wall,
                       metrics=metrics,
                       chunk_complete=[bool(s["chunk_complete"]) for s in steps])
    finally:
        restore()
    out["served_heads"] = sorted(set(heads))
    out["served_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # (b) --fast on the mesh: counts around generate(), the reductions' dtypes
    reduced = {}
    orig_reduce = comm.all_reduce

    def reduce_spy(x, group, op="sum"):
        key = f"{x.dtype} {op}"
        reduced[key] = reduced.get(key, 0) + 1
        return orig_reduce(x, group, op)

    heads, restore = attention_head_spy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    comm.all_reduce = reduce_spy
    try:
        t0 = time.perf_counter()
        res = fast.generate(batch, seed=666)
        torch.cuda.synchronize()
        out["fast_wall_s"] = time.perf_counter() - t0
    finally:
        comm.all_reduce = orig_reduce
        restore()
    out["fast"] = counts()
    out.update(fast_heads=sorted(set(heads)), fast_reductions=reduced,
               fast_forwards=sum(map(sum, fast.recompute_log)),
               fast_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               fast_finite=bool(torch.isfinite(res["pred_img"]).all()),
               fast_shape=tuple(res["pred_img"].shape))
    del res

    # one int8 denoise forward: the mesh's against one device's, same inputs
    with torch.inference_mode():
        args, kw = mesh_forward_inputs(dev)
        args = [[c.to(torch.bfloat16) for c in args[0]]] + [
            a.to(torch.bfloat16) if a.is_floating_point() and a.dim() > 1 else a
            for a in args[1:]]
        v_mesh = mmdit_forward(fast.mmdit, *args, **kw)
        if lead:
            v_single = mmdit_forward(quantize_mmdit(params_from_numpy(MMDiT(mcfg), single_tree)),
                                     *args, **kw)
            out["int8_forward"] = dict(bit_equal=bool(torch.equal(v_mesh, v_single)),
                                       **diff_stats(v_mesh, v_single))
    return out


def run_mesh_serving_path(device, results, two, mesh_frames):
    """Phase 22 (M17c): serving and --fast over the two-rank mesh on this one
    card, run in phase 20's spawn (``mesh_serve_part``; ``two`` holds every
    rank's results). ``mesh_frames``: phase 20 (a)'s mesh generate() of the
    same units."""
    import numpy as np

    label = "two ranks sharing one card over gloo, not a deployment number"
    n_layers = MESH_DEPTH
    ranks = [r["serve"] for r in two]
    lead, follower = ranks
    served = lead["served_frames"]
    want = mesh_frames.float().numpy().astype(np.float16)
    assert served.shape == (1, 3, MESH_FRAMES, HEIGHT, WIDTH), served.shape
    assert lead["chunk_complete"] == [False] * (MESH_UNITS - 1) + [True], lead["chunk_complete"]
    differ = int((served != want).sum())
    assert differ == 0, f"{differ} served values differ from the mesh generate()'s"
    ops = [op for op, _, ok in follower["followed"] if ok]
    assert len(ops) == len(follower["followed"]), follower["followed"]
    assert ops == ["start"] + ["step"] * MESH_UNITS + ["close", "stop"], ops
    k1 = MESH_FORWARDS * n_layers
    for r in ranks:
        c = r["served"]
        assert (c["attn_fwd_wgmma"], c["attn_fwd_tf32x3"], c["attn_bwd"]) == (k1, 0, 0), c
        assert not any(c["conv_igemm"].values()) and c["conv_int8"] == 0, c
        assert r["served_heads"] == [24 // MESH_RANKS], r["served_heads"]
    assert lead["metrics"]["steps"] == MESH_UNITS, lead["metrics"]
    # (b) the --fast preset on the mesh
    fast_forwards = MESH_UNITS * 3 * 3
    quantised = 12 * (n_layers - 1) + 9
    for r in ranks:
        c = r["fast"]
        assert r["fast_forwards"] == fast_forwards and r["fast_finite"], r
        assert r["fast_shape"] == (1, 3, MESH_FRAMES, HEIGHT, WIDTH), r["fast_shape"]
        assert (c["attn_fwd_wgmma"], c["attn_fwd_tf32x3"], c["attn_bwd"]) == (
            fast_forwards * n_layers, 0, 0), c
        assert r["fast_heads"] == [24 // MESH_RANKS], r["fast_heads"]
        assert c["conv_int8"] == c["quantize_k3"] == 0 and not any(c["conv_igemm"].values()), c
        assert c["int_mm"] == fast_forwards * quantised, c
        assert r["fast_reductions"].get("torch.int32 sum") == \
            fast_forwards * MESH_REDUCTIONS_PER_FORWARD, r["fast_reductions"]
    assert lead["int8_forward"]["bit_equal"], lead["int8_forward"]
    summary = dict(label=label, depth=MESH_DEPTH, step_s=lead["step_s"], wall_s=lead["wall_s"],
                   ranks=[{k: v for k, v in r.items()
                           if k not in ("served_frames", "followed")}
                          for r in ranks])
    for r in summary["ranks"]:
        log(f"mesh serving (a, b), rank {r['rank']} ({label}):", json.dumps(r))
    steps = sorted(lead["step_s"])
    log(f"mesh serving (a): {MESH_UNITS} steps over HTTP, {MESH_FRAMES} frames equal to phase 20 "
        f"(a)'s mesh generate() as float16 bit for bit; step median "
        f"{steps[len(steps) // 2]:.2f} s, "
        f"boundary step {lead['step_s'][-1]:.2f} s; rank 1 ran every operation. (b) --fast: "
        f"{fast_forwards * n_layers} K1 launches a rank at 12 heads, K2 and K3 never, int_mm "
        f"{fast_forwards * quantised} calls a rank, {fast_forwards * MESH_REDUCTIONS_PER_FORWARD} "
        f"int32 reductions; the mesh int8 forward equals one device's bit for bit (depth "
        f"{MESH_DEPTH})")
    results["mesh_serving_path"] = summary
    return {"served": lead["served"]["attn_fwd_wgmma"], "fast": lead["fast"]["attn_fwd_wgmma"]}


# ---------------------------------------------------------------------------
# phase 23: the cold start, with the AOT cache of the kernel libraries (M19c)
# ---------------------------------------------------------------------------

#: the argument that makes this script one child of phase 23
COLD_START_CHILD = "--cold-start-child"


def cold_start_child(cache: str, t_start: str, mode: str) -> int:
    """One child of phase 23, a fresh interpreter: configure the AOT cache
    ``cache``, load the three kernel libraries (one thread each), build the
    full-width bf16 pipeline from random weights and run serve.prewarm, with
    K1's counts set to 0 just before it and read just after. Prints one JSON
    line: the seconds from ``t_start`` (the parent's clock when it started
    this process) to each point, nvcc's seconds per source and aot.stats().
    ``mode`` "offline" also holds K1, launched from the library the cache
    gave, to its plain version at the stage-0, 2-row rollout layout with
    phase 3's tolerances."""
    t_start = float(t_start)
    import torch
    sys.path.insert(0, HERE)
    from deepv_tpu_torch import serve
    from deepv_tpu_torch.config import MMDiTConfig, create_model_config
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.ops import conv_igemm as cig
    from deepv_tpu_torch.ops import conv_int8 as ci8
    from deepv_tpu_torch.run import load_pipeline
    from deepv_tpu_torch.utils import aot, cuda_build

    device = torch.device("cuda", 0)
    torch.cuda.init()
    out = dict(mode=mode, imports_s=time.time() - t_start,
               nvcc_found=cuda_build.find_nvcc() is not None)
    aot.configure(cache)
    nvcc_s, build = {}, cuda_build.build

    def recording(source, *args, **kwargs):
        built = build(source, *args, **kwargs)
        nvcc_s[source] = built.seconds
        return built

    cuda_build.build = recording       # what each ops module's load_library calls
    try:
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda m: m.load_library(), (att, cig, ci8)))
    finally:
        cuda_build.build = build
    out.update(libraries_s=time.time() - t_start, nvcc_s=nvcc_s)
    cfg = create_model_config("none", use_motion_prompt=True)
    pipe = load_pipeline("none", cfg, random_weights=True, dtype=torch.bfloat16, device=device,
                         seed=0)
    torch.cuda.synchronize()
    out["ready_s"] = time.time() - t_start
    first, step = {}, serve.InteractiveSession.step

    def timed_step(self, action):
        frames = step(self, action)
        if not first:
            torch.cuda.synchronize()
            first["s"] = time.time() - t_start
        return frames

    serve.InteractiveSession.step = timed_step
    att.launches = att.f32_launches = att.bwd_launches = 0
    try:
        out["prewarm_s"] = serve.prewarm(pipe, height=HEIGHT, width=WIDTH, log=log)
    finally:
        serve.InteractiveSession.step = step
    out.update(prewarm_end_s=time.time() - t_start, first_frames_s=first["s"],
               launches=dict(attention=att.launches, attention_f32=att.f32_launches,
                             attention_bwd=att.bwd_launches), stats=aot.stats(),
               library_paths=sorted(os.path.basename(str(lib._name))
                                    for lib in (att._library, cig._library, ci8._library)))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    if mode == "offline":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mcfg = MMDiTConfig()
        name, b, shapes, ctx, ftimes, fvalid = rollout_layouts(device)[0]
        layout = PackedLayout(mcfg, shapes, ctx.shape[1])
        valid, times = packed_mask(layout, ctx, ftimes, fvalid)
        gen = torch.Generator(device=device)
        gen.manual_seed(5)
        q, k, v = (torch.randn((b, layout.seq_len, mcfg.num_attention_heads,
                                mcfg.attention_head_dim), generator=gen, device=device)
                   for _ in range(3))
        before = (att.launches, att.f32_launches)
        _, errs = check_attention_bf16(name, q, k, v, valid, times, layout.clip_tokens[-1])
        assert att.launches > before[0] and att.f32_launches > before[1], "K1 did not launch"
        out["k1_check"] = dict(layout=name, S=layout.seq_len, **errs)
    print(json.dumps(out), flush=True)
    return 0


def run_cold_start(device, results, card: str, prewarm_launches: int):
    """Phase 23: the cold start of serving at full width, two fresh child
    processes (``cold_start_child``) in turn on one new 0o700 cache
    directory: the first with nvcc on an empty cache (it compiles the three
    kernel libraries there), the second with nvcc off its PATH and CUDA_HOME
    pointing nowhere (it loads them). ``prewarm_launches``: K1's launches in
    phase 13's prewarm, which each child's must equal."""
    cache = tempfile.mkdtemp(prefix="_aot_cache_", dir=HERE)
    children = []
    try:
        for mode in ("online", "offline"):
            env = dict(os.environ)
            if mode == "offline":
                env["PATH"] = os.pathsep.join(
                    d for d in env.get("PATH", "").split(os.pathsep)
                    if d and not os.access(os.path.join(d, "nvcc"), os.X_OK))
                env["CUDA_HOME"] = os.path.join(cache, "no_cuda_toolkit_here")
            t0 = time.time()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), COLD_START_CHILD,
                                   cache, repr(t0), mode], capture_output=True, text=True,
                                  timeout=600, cwd=HERE, env=env)
            wall = time.time() - t0
            with open(os.path.join(HERE, "chiprun_out", f"cold_start_{mode}.log"), "w") as f:
                f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
            assert proc.returncode == 0, (
                f"phase 23's {mode} child failed (exit {proc.returncode}):\n"
                + proc.stderr[-4000:])
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            row["wall_s"] = wall
            children.append(row)
        entries = sorted(n for n in os.listdir(cache) if n.endswith(".so"))
        cache_mb = sum(os.path.getsize(os.path.join(cache, n)) for n in entries) / 1e6
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    online, offline = children
    assert online["stats"]["compiled"] == 3 and online["stats"]["loaded"] == 0, online["stats"]
    assert all(s > 0 for s in online["nvcc_s"].values()) and len(online["nvcc_s"]) == 3, online
    assert not offline["nvcc_found"], "the offline child found an nvcc"
    assert offline["stats"]["compiled"] == 0 and offline["stats"]["loaded"] == 3, \
        offline["stats"]
    assert offline["library_paths"] == online["library_paths"] == entries, (
        offline["library_paths"], online["library_paths"], entries)
    for row in children:
        assert row["launches"] == dict(attention=prewarm_launches, attention_f32=0,
                                       attention_bwd=0), (row["mode"], row["launches"])
    points = (("imports, CUDA context", "imports_s"), ("kernel libraries loaded", "libraries_s"),
              ("pipeline ready", "ready_s"), ("first step's frames", "first_frames_s"),
              ("end of prewarm", "prewarm_end_s"), ("process exit", "wall_s"))
    log(f"cold start ({card}; seconds from each child's start; one 0o700 cache, "
        f"{len(entries)} libraries, {cache_mb:.1f} MB):")
    log(f"  {'':26s} {'nvcc, empty cache':>18s} {'no nvcc, filled cache':>22s}")
    for label, key in points:
        log(f"  {label:26s} {online[key]:18.2f} {offline[key]:22.2f}")
    log(f"  {'nvcc (sum of 3 builds)':26s} {sum(online['nvcc_s'].values()):18.2f} "
        f"{sum(offline['nvcc_s'].values()):22.2f}")
    log(f"  {'aot stats':26s} {json.dumps(online['stats']):>18s} "
        f"{json.dumps(offline['stats']):>22s}")
    log(f"cold start: K1 {prewarm_launches} launches in each prewarm, as in phase 13's; K1 from "
        f"the cached library at {offline['k1_check']['layout']} within phase 3's bf16 tolerance "
        f"(max |bf16 - plain| {offline['k1_check']['err_bf16_vs_plain']:.3e})")
    summary = dict(card=card, cache_mb=cache_mb, entries=entries, children=children)
    results["cold_start"] = summary
    return summary


# ---------------------------------------------------------------------------
# phase 24: rgb and disparity decoded as one batch-2 VAE call (decode_batched)
# ---------------------------------------------------------------------------

#: phase 24 (e)'s trace of one batched decode window, under chiprun_out/
BATCHED_TRACE_DIR = "batched_decode_trace"


def cache_batches(tree):
    """The sorted batch sizes of a decoder cache tree's tensors, or None."""
    import torch
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return [tree.shape[0]]
    values = tree.values() if isinstance(tree, dict) else tree
    return sorted({b for v in values for b in (cache_batches(v) or [])})


def frame_gap(got, want) -> dict:
    """How far ``got`` is from ``want``: bit-equal, max |d|, relative L2 and
    the 8-bit gap."""
    import torch
    got, want = got.to(want.device), want
    mean8, p95 = eight_bit_gap(got, want)
    return dict(bit_equal=bool(torch.equal(got, want)),
                max_abs=float((got.float() - want.float()).abs().max()),
                rel_l2=rel_l2(got, want), gap_8bit_mean=mean8, gap_8bit_p95=p95)


def gate_bf16(name: str, gap: dict, rule: float) -> None:
    """Bit-equal, or within phase 8's bf16 rule (``rule``: twice the relative
    L2 between a bf16 and an f32 decode of the same latents): the two sides
    are bf16 decodes of the same latents that round in other places."""
    assert gap["bit_equal"] or gap["rel_l2"] <= rule, (
        f"{name}: relative L2 {gap['rel_l2']} over phase 8's bf16 rule {rule}")


def card_state():
    """The card's SM clock, power draw and temperature, as nvidia-smi reads
    them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() if smi.returncode == 0 else None


def run_batched_rollout(pipe, setup_s: float):
    """drive_rollout under a DecoderSpy, with each chunk's kept decoder
    caches (their batch sizes) and chunk 1's end-of-chunk decode latents
    recorded; checks that every decoder conv ran at batch 2 and every
    encoder conv at batch 1 (the pipeline encodes rows one at a time)."""
    from deepv_tpu_torch import pipeline as pl

    kept, latents = [], []
    end_chunk, decode = pipe._end_chunk, pl.vae_decode

    def end_spy(ch, keep_caches=None):
        res = end_chunk(ch, keep_caches)
        kept.append(None if res[4] is None else [cache_batches(c) for c in res[4]])
        return res

    def decode_spy(cfg_, p, z, **kwargs):
        if not latents:
            latents.append(z)
        return decode(cfg_, p, z, **kwargs)

    pipe._end_chunk, pl.vae_decode = end_spy, decode_spy
    card = card_state()
    try:
        with DecoderSpy() as spy:
            summary, out, conv_launches = drive_rollout(pipe, setup_s)
    finally:
        del pipe._end_chunk
        pl.vae_decode = decode
    spied = spy.summary()
    assert set(spied["conv_batches"]["decoder"]) == {2}, spied
    assert set(spied["conv_batches"]["encoder"]) == {1}, spied
    summary.update(spied, kept_caches=kept, card_before=card)
    return summary, out, conv_launches, latents


def run_batched_decode_path(device, results, untiled, adaptive_chunk1, fast_frames):
    """Phase 24: InferencePipeline(stream_decode=False, decode_batched=True)
    at full width in bf16 on phase 5's weights, image, prompt and seed, in
    this order: (a) phase 18's untiled igemm rollout; (d) a tiled batched
    decode of (a)'s chunk-1 latents against two batch-1 tiled decodes; (b)
    phase 12's adaptive + reuse + carry rollout; (e) one batched decode
    window inside utils/profiling.device_trace; (c) phase 11's --fast
    rollout.
    ``untiled``: phase 18's untiled run; ``adaptive_chunk1``: phase 12's
    chunk-1 frames; ``fast_frames``: phase 11's frames. Returns the launches
    of K2 in (a) and of K3 in (c)."""
    import torch
    from deepv_tpu_torch import pipeline as pl
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig, create_model_config
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.io.weights import random_params
    from deepv_tpu_torch.models.vae import _dec_window, vae_decode
    from deepv_tpu_torch.ops import conv_igemm as cig
    from deepv_tpu_torch.run import load_pipeline
    from deepv_tpu_torch.utils.profiling import TRACE_FILE, device_trace

    cfg = create_model_config("none", use_motion_prompt=True)
    mcfg = MMDiTConfig()
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    rule = 2 * results["decode_check"]["rel_l2_bf16_vs_f32_xla"]
    serial = untiled["summary"]
    report = dict(bf16_rule_rel_l2=rule)

    def build(vcfg, **kwargs):
        t0 = time.perf_counter()
        pipe = pl.InferencePipeline(
            cfg, mcfg, vcfg, random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0,
                                           device=device),
            embeds, dtype=torch.bfloat16, device=device, stream_decode=False,
            decode_batched=True, **kwargs)
        torch.cuda.synchronize()
        return pipe, time.perf_counter() - t0

    def k2_count():
        return cig.launches + cig.cl_launches

    # (a) the untiled igemm rollout: chunk 1 the plain decode, chunk 2 primed
    vcfg = VAEConfig(conv_impl="igemm")
    pipe, setup_s = build(vcfg)
    a, out, conv_launches, latents = run_batched_rollout(pipe, setup_s)
    assert a["forwards"] == FORWARDS, a["forwards"]
    assert a["attention_launches"] == FORWARDS * mcfg.num_layers, a     # 4,320
    k2 = conv_launches["launches"] + conv_launches["cl_launches"]
    assert 2 * a["decoder_k2_launches"] == serial["decoder_conv_igemm_launches"], (
        f"K2 in the batched decoder {a['decoder_k2_launches']}, phase 18 untiled's "
        f"{serial['decoder_conv_igemm_launches']}")
    assert k2 - a["decoder_k2_launches"] == serial["encoder_conv_igemm_launches"], (k2, serial)
    assert a["phase_counts"]["prime"] == 1 and serial["phase_counts"]["prime"] == 2, (
        a["phase_counts"], serial["phase_counts"])
    assert a["kept_caches"] == [None, None], a["kept_caches"]
    gaps = {}
    for key in ("pred_img", "pred_disparity"):
        for part, sl in (("chunk1", slice(0, CHUNK1_FRAMES)), ("chunk2", slice(CHUNK1_FRAMES, None))):
            gaps[f"{key} {part}"] = frame_gap(out[key][:, :, sl], untiled[key][:, :, sl].to(device))
    # chunk 2 is conditioned on chunk 1's pixels (the carry re-encode): it is
    # held to the rule only where chunk 1 is bit-equal
    for key in ("pred_img", "pred_disparity"):
        gate_bf16(f"(a) {key} chunk 1", gaps[f"{key} chunk1"], rule)
        if gaps[f"{key} chunk1"]["bit_equal"]:
            gate_bf16(f"(a) {key} chunk 2", gaps[f"{key} chunk2"], rule)
    a.update(gap_vs_phase18_untiled=gaps)
    log("batched decode (a):", json.dumps(a))
    log("batched decode (a): frames against phase 18 untiled: " + json.dumps(gaps))
    del out

    # (d) a tiled batched decode of chunk 1's latents against two batch-1 ones
    z = latents[0]
    assert z.shape[0] == 2, tuple(z.shape)
    kw = dict(temporal_chunk=True, window_size=pipe.decode_window, use_tiling=True)
    tiled = {}
    with torch.inference_mode():
        for name, calls in (("batched", [z]), ("two_batch_1", [z[:1], z[1:2]])):
            c0 = k2_count()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = torch.cat([vae_decode(vcfg, pipe.vae, zz, **kw) for zz in calls])
            torch.cuda.synchronize()
            tiled[name] = dict(y=y, seconds=time.perf_counter() - t0, k2=k2_count() - c0)
    d = frame_gap(tiled["batched"]["y"], tiled["two_batch_1"]["y"])
    gate_bf16("(d) tiled decode", d, rule)
    assert 2 * tiled["batched"]["k2"] == tiled["two_batch_1"]["k2"] > 0, tiled
    assert tuple(tiled["batched"]["y"].shape) == (2, 3, CHUNK1_FRAMES, HEIGHT, WIDTH)
    d.update({f"{k}_{f}": v[f] for k, v in tiled.items() for f in ("seconds", "k2")})
    log("batched decode (d): tiled decode of chunk 1's latents, batch 2 against two batch-1 "
        "calls: " + json.dumps(d))
    del tiled

    vae = pipe.vae
    del pipe, latents
    gc.collect()
    torch.cuda.empty_cache()

    # (b) phase 12's modes: the reuse branch keeps one batch-2 cache
    pipe, setup_s = build(VAEConfig(), flow_cache="adaptive:0.5", reuse_decoder_cache=True,
                          carry_latents=True)
    b, out, conv_launches, _ = run_batched_rollout(pipe, setup_s)
    assert not any(conv_launches.values()), conv_launches
    assert b["attention_launches"] == b["forwards"] * mcfg.num_layers, b
    assert "prime" not in b["phases_s"], "cache reuse must not prime"
    assert b["kept_caches"] == [[[2], None]] * 2, b["kept_caches"]
    # chunk 1's latents are phase 12's (its denoise reads no decoded pixel);
    # phase 12 decoded them streamed, one unit a window, at batch 1
    b_gaps = {key: frame_gap(out[key][:, :, :CHUNK1_FRAMES], adaptive_chunk1[key].to(device))
              for key in ("pred_img", "pred_disparity")}
    for key, gap in b_gaps.items():
        gate_bf16(f"(b) {key} chunk 1", gap, rule)
    b.update(gap_vs_phase12_chunk1=b_gaps, recompute_log=[list(r) for r in pipe.recompute_log])
    log("batched decode (b):", json.dumps(b))
    log("batched decode (b): chunk 1 against phase 12's: " + json.dumps(b_gaps))
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()

    # (e) one batched decode window inside device_trace, between (b) and
    # (c): the card's state before each rollout is printed, so a rollout
    # after the capture can be compared with one before it
    logdir = os.path.join(HERE, "chiprun_out", BATCHED_TRACE_DIR)
    c0 = k2_count()
    with torch.inference_mode(), device_trace(logdir, device):
        _dec_window(vcfg, vae.decoder, z[:, :, :1], None, "init")
    launched = k2_count() - c0
    path = os.path.join(logdir, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k2_events = [e for e in kernels if "conv3d_igemm_wgmma" in e.get("name", "")]
    assert k2_events, f"the trace at {path} names no conv3d_igemm_wgmma kernel"
    e = dict(trace=os.path.relpath(path, HERE), trace_mb=os.path.getsize(path) / 1e6,
             kernels=len(kernels), conv3d_igemm_wgmma_kernels=len(k2_events),
             conv3d_igemm_wgmma_launches=launched,
             conv3d_igemm_wgmma_device_ms=sum(ev.get("dur", 0) for ev in k2_events) / 1e3,
             kernels_device_ms=sum(ev.get("dur", 0) for ev in kernels) / 1e3)
    log("batched decode (e): device_trace of one batched init window: " + json.dumps(e))
    del vae, z, events, kernels, k2_events
    gc.collect()
    torch.cuda.empty_cache()

    # (c) phase 11's --fast settings
    t0 = time.perf_counter()
    pipe = load_pipeline("none", cfg, random_weights=True, dtype=torch.bfloat16, device=device,
                         seed=0, fast=True)
    pipe.stream_decode, pipe.decode_batched = False, True
    torch.cuda.synchronize()
    c, out, conv_launches, _ = run_batched_rollout(pipe, time.perf_counter() - t0)
    assert c["forwards"] == 108 and not any(conv_launches.values()), c
    dec = c["dispatch_batches"]["decoder"]
    enc = c["dispatch_batches"]["encoder"]
    assert set(dec) == {"int8 b=2"} and set(enc) == {"int8 b=1"}, c["dispatch_batches"]
    dispatches = dec["int8 b=2"] + enc["int8 b=1"]
    assert c["conv_int8_launches"] == c["quantize_k3_launches"] == dispatches, c
    assert c["decoder_k3_launches"] == c["decoder_k3_quantise_launches"] == dec["int8 b=2"], c
    mean8, p95 = eight_bit_gap(out["pred_img"], fast_frames.to(device))
    c.update(gap_vs_phase11_8bit_mean=mean8, gap_vs_phase11_8bit_p95=p95)
    log("batched decode (c):", json.dumps(c))
    log(f"batched decode (c): --fast, K3 {dispatches} launches (decoder {dec['int8 b=2']} at "
        f"batch 2, encoder {enc['int8 b=1']} at batch 1), 8-bit gap to phase 11's frames mean "
        f"{mean8:.4f}, p95 {p95:.4f} (printed, not gated: one activation scale for both streams)")
    del pipe, out
    gc.collect()
    torch.cuda.empty_cache()

    def row(name, r):
        ph = r["phases_s"]
        return (f"{name}: wall {r['wall_s']:.2f} s, denoise_unit {ph['denoise_unit']:.3f} s, "
                f"vae_decode {ph.get('vae_decode', 0):.3f} s, "
                f"stream_decode {ph.get('stream_decode', 0):.3f} s, prime "
                f"{ph.get('prime', 0):.3f} s, peak {r['max_memory_allocated_gib']:.2f} GiB"
                + (f"; card before: {r['card_before']}" if r.get("card_before") else ""))
    for name, r in (("(a) batched igemm", a), ("phase 18 untiled igemm", serial),
                    ("(b) batched adaptive + reuse", b),
                    ("phase 12 streamed adaptive + reuse", results["adaptive_boundary_path"]),
                    ("(c) batched --fast", c), ("phase 11 streamed --fast", results["fast_path"])):
        log("batched decode, " + row(name, r))
    report.update(igemm=a, tiled=d, trace=e, adaptive_reuse=b, fast=c)
    results["batched_decode_path"] = report
    return dict(k2=k2, k2_decoder=a["decoder_k2_launches"], k3_wgmma=c["conv_int8_wgmma_launches"],
                k3_packed=c["conv_int8_packed_launches"], k3_quantise=c["quantize_k3_launches"])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from deepv_tpu_torch.ops import attention as att
        from deepv_tpu_torch.ops import conv_igemm as cig
        from deepv_tpu_torch.ops import conv_int8 as ci8
        from deepv_tpu_torch.utils import cuda_build
    except ImportError as e:
        print(f"chip_smoke: deepv_tpu_torch is not beside this script ({e})", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    results = {}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    results["card"] = card

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:    # one nvcc per source, all at once
        builds = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    att.load_library()
    cig.load_library()
    ci8.load_library()
    build_s = time.perf_counter() - t0
    for src, built in builds.items():
        log(f"build: {src} -> {os.path.relpath(built.path, HERE)} (nvcc {built.seconds:.1f} s)")
        for line in built.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Function properties")):
                log("  ptxas:", line.strip())
    log(f"build: all kernels in {build_s:.1f} s")
    results["build_s"] = build_s

    phase_s = {}

    def timed(phase, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``phase``."""
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_s[phase] = round(time.perf_counter() - t, 1)

    rows = timed("3", check_attention, device, results)
    conv_rows = timed("4", check_conv_igemm, device, results)
    conv_b2_rows = timed("4 (batch 2)", check_conv_igemm_batch2, device, results)
    pipe, launches, ref_frames, ref_disparity, ref_poses = timed("5", run_main_path, device,
                                                                  results)
    timed("6", check_forward, pipe, device, results)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    pipe, conv_launches, frames_by_class = timed("7", run_igemm_path, device, results, ref_frames)
    decode_f32 = timed("8", check_decode, pipe, device, results)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    k3_rows = timed("9", check_conv_int8, device, results)
    k3_b2_rows = timed("9 (batch 2)", check_conv_int8_batch2, device, results)
    timed("10", check_linear_int8, device, results)
    fast, k3_frames_by_class, fast_frames = timed("11", run_fast_path, device, results,
                                                  ref_frames)
    _, adaptive_chunk1 = timed("12", run_adaptive_boundary_path, device, results, ref_frames)
    serving = timed("13", run_serving_path, device, results, ref_frames, ref_disparity,
                    launches)
    ref_frames, ref_disparity = ref_frames.cpu(), ref_disparity.cpu()
    gc.collect()
    torch.cuda.empty_cache()
    bwd_rows, bwd_timing = timed("14", check_attention_backward, device, results)
    training, mesh_train_ref = timed("15", run_training_path, device, results)
    snapshot = tempfile.mkdtemp(prefix="_snapshot_", dir=HERE)
    try:
        pipe = timed("16", run_checkpoint_path, device, results, ref_frames, snapshot)
        timed("17", run_text_path, device, results, pipe, snapshot)
    finally:
        shutil.rmtree(snapshot, ignore_errors=True)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    tiled_launches, tiled_rows, untiled = timed("18", run_tiled_path, device, results,
                                                ref_frames)
    timed("19", run_ply_path, device, results, {
        "pred_img": ref_frames, "pred_disparity": ref_disparity, "trans3d": ref_poses[0],
        "trans2d": ref_poses[1]})
    del ref_frames, ref_disparity, ref_poses
    gc.collect()
    torch.cuda.empty_cache()
    # phase 20's two-rank spawn also runs 21 (a, c) and 22, whose checks follow
    mesh_launches, mesh_heads, mesh_frames, two = timed(
        "20 (with 21 a, c and 22)", run_mesh_path, device, results)
    mesh_train = timed("21", run_mesh_training_path, device, results, mesh_train_ref, two)
    mesh_serve = timed("22", run_mesh_serving_path, device, results, two, mesh_frames)
    del mesh_frames, two
    gc.collect()
    torch.cuda.empty_cache()
    timed("23", run_cold_start, device, results, card, serving["prewarm_launches"])
    batched = timed("24", run_batched_decode_path, device, results, untiled, adaptive_chunk1,
                    fast_frames)
    del untiled, adaptive_chunk1, fast_frames

    assert launches == sum(r["launches_per_rollout"] for r in rows), (
        "K1's launches per layout do not add up to the rollout's")
    head = next(r for r in rows if r["layout"] == "stage2_b2")
    kernels = [{
        "name": "attn_fwd_wgmma",
        "route": "cuda",
        "source": "deepv_tpu_torch/csrc/attention.cu",
        "replaces": "deepv_tpu/ops/attention.py:73",
        "launches": launches,
        "max_abs_err": max(r["err_bf16_vs_plain"] for r in results["attention_layouts"]),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"stage 2, b={head['b']}, S={head['S']}, h={head['heads']}, d={head['head_dim']}, bf16",
        "launches_tiled": tiled_launches["attention"],
        # phase 20 (a): per rank of the two-rank mesh (the model cut to
        # MESH_DEPTH blocks, also in 22), every call at 12 heads;
        # (c): the kernel at the stage-2 b=2 layout with the per-rank heads;
        # phase 22 (a), served, and (b), --fast; phase 21 (c), bf16 training
        "launches_mesh": mesh_launches,
        "mesh_depth": MESH_DEPTH,
        "launches_mesh_served": mesh_serve["served"],
        "launches_mesh_fast": mesh_serve["fast"],
        "launches_mesh_training_bf16": mesh_train["bf16"]["attn_fwd_wgmma"],
        "mesh_heads": 24 // MESH_RANKS,
        "ms_by_heads": {str(r["heads"]): r["ms"] for r in mesh_heads
                        if r["layout"] == "stage2_b2"},
        "device_ms_by_heads": {str(h): ms for r in mesh_heads if r["layout"] == "stage2_b2"
                               for h, ms in ((r["heads"], r["graph_ms"]),
                                             (24, r["graph_ms_24_heads"]))},
    }]
    # K1's f32 forward and the backward kernels: launches from phase 15's
    # training steps, errors from phase 14, times at the stage-2 training
    # layout (phase 14); the f32 forward's time at the rollout's stage-2
    # layout (phase 3)
    f32_row = head["f32"]
    kernels.append({
        "name": "attn_fwd_tf32x3",
        "route": "cuda",
        "source": "deepv_tpu_torch/csrc/attention.cu",
        "replaces": "deepv_tpu/ops/attention.py:73",
        "launches": training["launches"]["attn_fwd_tf32x3"],
        "max_abs_err": max(r["err_f32_kernel"] for r in results["attention_layouts"]),
        "ms": f32_row["ms"],
        "plain_ms": f32_row["plain_ms"],
        "bound_ms": f32_row["bound_ms"],
        "bound_by": f32_row["bound_by"],
        "library_ms": f32_row["library_ms"],
        "shape": (f"stage 2, b={head['b']}, S={head['S']}, h={head['heads']}, "
                  f"d={head['head_dim']}, f32; launches: phase 15's f32 training steps; ms and "
                  f"library_ms back to back; device time {f32_row['graph_ms']:.4f} ms (CUDA "
                  f"graph) against SDPA f32's kernels {f32_row['library_kernels_ms']:.4f} ms; "
                  f"bound_ms is 3xTF32's least time (three TF32 products a product at 495 "
                  f"TF/s), {f32_row['bound_fma_ms']:.4f} ms at the f32 FMA peak"),
        # phase 21 (a): per rank of the tp-2 f32 step, every call at 12 heads
        "launches_mesh_training": mesh_train["f32"]["attn_fwd_tf32x3"],
    })
    bwd_mesh = [r for r in bwd_rows if r["heads"] != bwd_timing["heads"]
                and r["layout"] == bwd_timing["layout"]]
    for tag, counter, route in (("f32", "attn_bwd_f32", "tf32x3"),
                                ("bf16", "attn_bwd_bf16", "wgmma")):
        t = bwd_timing[tag]
        bound = (f"; bound_ms is 3xTF32's least time (three TF32 products a product at 495 "
                 f"TF/s), {t['bound_fma_ms']:.4f} ms at the f32 FMA peak") if tag == "f32" else ""
        kernels.append({
            "name": f"attn_bwd_{route}",
            "route": "cuda",
            "source": "deepv_tpu_torch/csrc/attention.cu",
            "replaces": "deepv_tpu/models/mmdit.py:289",
            "launches": training["launches"][counter],
            "max_abs_err": max(r[f"{tag}_{g}_err"] for r in bwd_rows for g in ("dq", "dk", "dv")),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": (f"stage-2 training layout, b={bwd_timing['b']}, S={bwd_timing['S']}, "
                      f"h={bwd_timing['heads']}, d={bwd_timing['head_dim']}, {tag}; one call = "
                      f"attn_bwd_delta, attn_bwd_dkdv_{route}, attn_bwd_dq_{route}; launches: "
                      f"phase 15's {tag} training steps; no TPU kernel: deepv_tpu differentiates "
                      "its jnp attention; plain_ms is autograd of attention_plain, library_ms "
                      "autograd of SDPA's backward" + bound),
            # phase 21: per rank of the tp-2 step (f32: (a), bf16: (c)), at 12
            # heads; phase 14: the call at the per-rank heads of tp 2 and 4
            "launches_mesh_training": mesh_train[tag]["attn_bwd"],
            "ms_by_heads": {str(r["heads"]): r[f"{tag}_ms"] for r in bwd_mesh},
            "device_ms_by_heads": {str(r["heads"]): r[f"{tag}_graph_ms"] for r in bwd_mesh},
        })
    # K2 at the conv class with the most device time in the igemm rollout:
    # its output frames there times the kernel's ms per output frame
    bf16 = [r for r in conv_rows if r["dtype"] == "bfloat16"]
    per_frame = {}
    for r in bf16:
        if r["kernel"] == "wgmma" and not r["edge"]:
            per_frame.setdefault((r["ci"], r["co"], r["h"], r["w"]), r)
    missing = set(frames_by_class) - set(per_frame)
    assert not missing, f"rollout conv classes without a K2 check: {sorted(missing)}"
    # K2, cuDNN and the bound summed over the igemm rollout: each class's
    # output frames times its checked case's ms per output frame
    by_class = {}
    for k, n in frames_by_class.items():
        r = per_frame[k]
        per = n / r["frames"]
        by_class[k] = dict(frames=n, k2_s=per * r["ms"] / 1e3, layout_s=per * r["layout_ms"] / 1e3,
                           cudnn_s=per * r["library_ms"] / 1e3, bound_s=per * r["bound_ms"] / 1e3,
                           tflops=r["tflops"], plan=r["plan"])
    by_class = dict(sorted(by_class.items(), key=lambda kv: -kv[1]["k2_s"]))
    sums = {key: sum(v[key] for v in by_class.values())
            for key in ("k2_s", "layout_s", "cudnn_s", "bound_s")}
    names = {k: f"{k[0]}->{k[1]} @{k[2]}x{k[3]}" for k in by_class}
    results["conv_igemm_rollout_by_class"] = {names[k]: v for k, v in by_class.items()}
    results["conv_igemm_rollout_sums"] = sums
    log(f"K2 over the igemm rollout ({sum(frames_by_class.values())} output frames in "
        f"{len(by_class)} classes): K2 {sums['k2_s']:.3f} s (layout work outside the kernel "
        f"{sums['layout_s']:.3f} s), cuDNN {sums['cudnn_s']:.3f} s, bound {sums['bound_s']:.3f} s")
    for k, v in by_class.items():
        log(f"  {names[k]}: {v['frames']} frames, K2 {v['k2_s']:.3f} s, cuDNN {v['cudnn_s']:.3f} s, "
            f"bound {v['bound_s']:.3f} s, {v['tflops']:.0f} TF/s, plan {v['plan']}")
    top = per_frame[next(iter(by_class))]
    # K2's two bf16 paths: wgmma at the class with the most K2 time, cl (the
    # same kernel template with A read channels-last) at the encoder case,
    # where the rollout runs it
    on_path = next(r for r in bf16 if r["layer"] == CONV_EDGE_CASES[0][0])
    tiled_bf16 = [r for r in tiled_rows if r["dtype"] == "bfloat16"]
    for name, counter, row, rows in (
            ("conv3d_igemm_wgmma", "launches", top,
             [r for r in bf16 + tiled_bf16 if r["kernel"] == "wgmma"]),
            ("conv3d_igemm_wgmma_cl", "cl_launches", on_path,
             [r for r in bf16 + tiled_bf16 if r["kernel"] == "cl"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "deepv_tpu_torch/csrc/conv_igemm.cu",
            "replaces": "deepv_tpu/ops/conv_igemm.py:57",
            "launches": conv_launches[counter],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": (f"{row['ci']}->{row['co']} @{row['h']}x{row['w']}, {row['frames']} output "
                      f"frames, {row['mode']} mode, bf16"
                      + (", x channels-last" if row is on_path else "")
                      + "; max_abs_err also over phase 18's tile shapes"
                      + (" and phase 4's batch-2 decoder classes" if counter == "launches"
                         else "")),
            "launches_tiled": tiled_launches[counter],
        })
    # phase 24 (a): K2 in the batched igemm rollout (the decoder's at batch
    # 2), and phase 4's batch-2 checks
    kernels[-2].update(launches_batched_decode=batched["k2"],
                       launches_batched_decode_decoder=batched["k2_decoder"],
                       max_abs_err_batch2=max(r["max_abs_err"] for r in conv_b2_rows))
    kernels[-2]["max_abs_err"] = max(kernels[-2]["max_abs_err"],
                                     kernels[-2]["max_abs_err_batch2"])
    # K2's f32 kernel and its split kernel at 128->128 @384x512 in prime
    # mode, the class with the most time in the decoder; launches from phase
    # 8's f32 igemm decode
    f32_conv = [r for r in conv_rows if r["kernel"] == "tf32x3"]
    top32 = next(r for r in f32_conv if (r["ci"], r["co"], r["h"], r["w"], r["mode"])
                 == (128, 128, HEIGHT, WIDTH, "prime"))
    kernels.append({
        "name": "conv3d_igemm_tf32x3",
        "route": "cuda",
        "source": "deepv_tpu_torch/csrc/conv_igemm.cu",
        "replaces": "deepv_tpu/ops/conv_igemm.py:57",
        "launches": decode_f32["f32_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in f32_conv + [
            r for r in tiled_rows if r["dtype"] == "float32"]),
        "ms": top32["kernel_ms"],
        "plain_ms": top32["plain_ms"],
        "bound_ms": top32["bound_ms"],
        "bound_by": top32["bound_by"],
        "library_ms": top32["library_ms"],
        "shape": (f"{top32['ci']}->{top32['co']} @{top32['h']}x{top32['w']}, "
                  f"{top32['frames']} output frames, prime mode, f32; the conv kernel alone "
                  f"(device time, CUDA graph; the whole call with split_tf32_cl on x and the "
                  f"weight {top32['ms']:.4f} ms); launches: phase 8's f32 igemm decode; "
                  f"library_ms is cuDNN's f32 conv with TF32 off; bound_ms is 3xTF32's least "
                  f"time, {top32['bound_fma_ms']:.4f} ms at the f32 FMA peak"),
    })
    sp = top32["split"]
    kernels.append({
        "name": "split_tf32_cl",
        "route": "cuda",
        "source": "deepv_tpu_torch/csrc/conv_igemm.cu",
        "replaces": "deepv_tpu/ops/conv_igemm.py:57",
        "launches": decode_f32["split_launches"],
        "max_abs_err": 0.0,
        "ms": sp["ms"],
        "plain_ms": sp["plain_ms"],
        "bound_ms": sp["bound_ms"],
        "bound_by": sp["bound_by"],
        "library_ms": None,
        "shape": (f"x of the {top32['ci']}->{top32['co']} @{top32['h']}x{top32['w']} prime case "
                  "into its two channels-last TF32 planes (equal to the plain split bit for "
                  "bit); part of conv3d_igemm_tf32x3's call, twice a call (x, the weight); no "
                  "single PyTorch call splits into this layout"),
    })
    # K3, its quantise step and conv kernel, the bound and cuDNN's bf16 conv
    # summed over the fast rollout's int8 convs by class, as for K2
    k3_per_frame = {}
    for r in k3_rows:
        if not r["edge"]:
            k3_per_frame.setdefault((r["ci"], r["co"], r["h"], r["w"]), r)
    missing = set(k3_frames_by_class) - set(k3_per_frame)
    assert not missing, f"fast-rollout int8 conv classes without a K3 check: {sorted(missing)}"
    k3_by_class = {}
    for k, n in k3_frames_by_class.items():
        r = k3_per_frame[k]
        per = n / (r["frames"] * r["batch"])
        k3_by_class[k] = dict(
            frames=n, case=f"{r['mode']}, {r['frames']} frames", route=r["route"],
            k3_s=per * r["ms"] / 1e3, quantise_s=per * r["quantise_ms"] / 1e3,
            kernel_s=per * r["kernel_ms"] / 1e3, cudnn_bf16_s=per * r["library_ms"] / 1e3,
            bound_s=per * r["bound_ms"] / 1e3, kernel_tops=r["kernel_tops"])
    k3_sums = {key: sum(v[key] for v in k3_by_class.values())
               for key in ("k3_s", "quantise_s", "kernel_s", "cudnn_bf16_s", "bound_s")}
    k3_names = {k: f"{k[0]}->{k[1]} @{k[2]}x{k[3]}" for k in k3_by_class}
    results["conv_int8_rollout_by_class"] = {k3_names[k]: v for k, v in k3_by_class.items()}
    results["conv_int8_rollout_sums"] = k3_sums
    log(f"K3 over the fast rollout ({fast['conv_int8_launches']} conv launches, "
        f"{fast['quantize_k3_launches']} quantise launches, "
        f"{sum(k3_frames_by_class.values())} output frames): K3 {k3_sums['k3_s']:.3f} s "
        f"(quantise step {k3_sums['quantise_s']:.3f} s, conv kernels {k3_sums['kernel_s']:.3f} s),"
        f" cuDNN bf16 {k3_sums['cudnn_bf16_s']:.3f} s, bound {k3_sums['bound_s']:.3f} s")
    for k, v in k3_by_class.items():
        log(f"  {k3_names[k]}: {v['frames']} frames ({v['case']}, {v['route']}), K3 "
            f"{v['k3_s']:.3f} s (quantise {v['quantise_s']:.3f} s, kernel {v['kernel_s']:.3f} s, "
            f"{v['kernel_tops']:.0f} TOPS), cuDNN bf16 {v['cudnn_bf16_s']:.3f} s, "
            f"bound {v['bound_s']:.3f} s")
    # each K3 kernel at the class of its route with the most K3 time in the
    # fast rollout; the quantise kernel at the top class overall
    def top_class(route):
        keys = [k for k in k3_by_class if k3_per_frame[k]["route"] == route]
        return k3_per_frame[max(keys, key=lambda k: k3_by_class[k]["k3_s"])]

    def shape(r):
        return (f"{r['ci']}->{r['co']} @{r['h']}x{r['w']}, {r['frames']} output frames, "
                f"{r['mode']} mode, bf16")

    top_wg, top_packed = top_class("wgmma"), top_class("packed")
    for name, counter, row, route in (("conv3d_int8_wgmma", "conv_int8_wgmma_launches", top_wg,
                                       "wgmma"),
                                      ("conv3d_int8_packed", "conv_int8_packed_launches",
                                       top_packed, "packed")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "deepv_tpu_torch/csrc/conv_int8.cu",
            "replaces": "deepv_tpu/ops/conv_int8.py:88",
            "launches": fast[counter],
            "max_abs_err": max(r["max_abs_err"] for r in k3_rows if r["route"] == route),
            "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["kernel_bound_ms"],
            "bound_by": row["kernel_bound_by"],
            "library_ms": row["library_ms"],
            "shape": (shape(row) + f"; the conv kernel alone (the whole call {row['ms']:.4f} ms "
                      "with the quantise step); no TPU kernel: deepv_tpu's XLA int8 conv; "
                      "plain_ms is the whole plain conv; library_ms is cuDNN's bf16 conv"),
            # phase 24 (c): the batched --fast rollout (the decoder's at batch 2)
            "launches_batched_decode": batched[f"k3_{route}"],
        })
    top = k3_per_frame[max(k3_by_class, key=lambda k: k3_by_class[k]["k3_s"])]
    kernels.append({
        "name": "quantize_k3_input",
        "route": "cuda",
        "source": "deepv_tpu_torch/csrc/conv_int8.cu",
        "replaces": "deepv_tpu/ops/conv_int8.py:88",
        "launches": fast["quantize_k3_launches"],
        "max_abs_err": 0.0 if all(r["x8_mismatches"] == 0 for r in k3_rows) else None,
        "ms": top["quantise_kernel_ms"],
        "plain_ms": top["quantise_plain_ms"],
        "bound_ms": top["quantise_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": (shape(top) + f"'s input; the kernel alone (with the amax that makes sx "
                  f"{top['quantise_ms']:.4f} ms; plain_ms includes it); no single PyTorch "
                  "call quantises into this layout"),
        "launches_batched_decode": batched["k3_quantise"],
    })
    # phase 9's batch-2 checks: every decoder class takes the wgmma kernel
    k3_wgmma = next(k for k in kernels if k["name"] == "conv3d_int8_wgmma")
    assert {r["route"] for r in k3_b2_rows} == {"wgmma"}, k3_b2_rows
    k3_wgmma["max_abs_err_batch2"] = max(r["max_abs_err"] for r in k3_b2_rows)
    k3_wgmma["max_abs_err"] = max(k3_wgmma["max_abs_err"], k3_wgmma["max_abs_err_batch2"])
    log("phase seconds:", json.dumps(phase_s))
    results["phase_s"] = phase_s
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(results, kernels=kernels), f, indent=1)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [COLD_START_CHILD]:
        sys.exit(cold_start_child(*sys.argv[2:]))
    sys.exit(main())
