#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`otter_tpu_torch`) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

It imports torch and the port only (never jax or `otter_tpu`) and fails
unless every phase passes:

  1. device      CUDA must be available; prints the card's name and power
                 limit.
  2. build       nvcc compiles every kernel in otter_tpu_torch/csrc (one
                 process per source, started together) into
                 otter_tpu_torch/_build/; counts the tensor-core (HMMA /
                 HGMMA) and f32 FFMA instructions of the weight-streaming
                 kernels (the fused int8 and int4 MLPs' main kernels, the
                 fused layer's split-K product) in `cuobjdump -sass` and
                 fails if one has no HMMA.
  3. kernels     each kernel against its plain PyTorch version on the card,
                 in bf16, at the shapes the serving and training paths give
                 it (flash also at OtterHD's full-HD prefill and at head
                 dims 80, 96 and 112), with the tolerance printed; kernel,
                 plain and library-call times and the bound (least time
                 for the same bytes / operations); for every flash case
                 also the device times of the kernel and the library call
                 (below ~0.05 ms a call's wall time is the host's);
                 `int8_mlp` at 4096 -> 16384 -> 4096 (M = 1, 8, 32 and
                 5, a verify window), Flamingo-MPT-1B's 2048 -> 8192 ->
                 2048 (M = 1, 2, 5, 16),
                 OtterHD's with biases and sq_relu (M = 1) and falcon7b's
                 4544 -> 18176 -> 4544 (M = 8), `int8_attn_tail` at M = 1,
                 8 and 32, `decode_attn_megakernel` at b = 1 and 8 over
                 caches of 256 and 2048 with the position a device int32,
                 each with its device time and two calls compared bit for
                 bit (the megakernel also with the device time of each of
                 its kernels at b=8 pos 255, and one call captured as a
                 CUDA graph at pos 0 and replayed after the position
                 counter moves to 57, 0, 255 and 128, each replay against
                 the plain version at its position, with its device ms),
                 `int4_mlp` at 4096 -> 16384 -> 4096 (M = 1, 8, 32; the
                 xattn FF at M = 8) and falcon7b's widths (M = 8), each
                 with its device time and two calls compared bit for bit;
                 `int8_matmul` and `int4_matmul` with their device times.
  4. parity      OTTER-MPT7B at full width with its depth cut, once with
                 int8 weights and an int8 KV cache and once with int4
                 weights and an int4 cache, then OTTER-LLaMA2-Chat-7B and
                 OtterHD-8B cut the same way with int8 weights and cache:
                 first-step logits (prefill and
                 first cached decode step) through the kernels against the
                 same model with every kernel swapped for its plain version.
                 idefics-9b is cut the same way (4 layers: one xattn
                 block) with int8 decoder layers and cache.
                 Then the int8 model with `megakernel=True` (bf16 cache) and
                 with `fused_tail=True` (int8 cache) on full-length prompts:
                 kernels against plain, and against the composed route of
                 the same weights.
  5. serve       OTTER-MPT7B at full width (32 layers, 8 xattn blocks, CLIP
                 ViT-L/14, perceiver depth 6; random weights from a seed,
                 the decoder's and xattn's quantized to int8), int8 KV cache, decode_kernel="auto":
                 greedy requests through OtterGenerator.generate at batch 1
                 and 8, ragged left-padded 32-128-token prompts, each with
                 one 224x224 image, 32 new tokens. Prints TTFT and decode
                 tok/s (medians of 3 runs). Every serving kernel's launch
                 count must rise during this phase.
  6. serve4      the same requests on the same model with its MLP pairs
                 packed to int4 (`quant="int4"`: decoder ffn and xattn ff at
                 0.5 byte a weight, attention projections int8) and the
                 nibble-fused int4 KV cache, through `generate` and, at
                 batch 1, `stream_generate`. flash_fwd, int4_mlp and the
                 int4 decode_attention must launch, int8_mlp must not; a
                 b=8 decode step launches int4_mlp exactly 40 times and
                 the int4 decode_attention 32, a prefill flash_fwd 70.
  7. trainparity the depth-cut model in bf16 (not quantized): one SFT step
                 (b=2, 1024 tokens, one image each, remat, fused CE) through
                 the kernels against the same step with every kernel swapped
                 for its plain version: loss, every trainable gradient,
                 grad norm, exact flash launches. The same for one step of
                 the int8-frozen recipe with 8-bit Adam (also its int8 first
                 moments, dequantized). Then `sft.main` over a data YAML
                 (cut by --customized_config) through the kernels and
                 through the plain versions: each step's loss and grad
                 norm; the kernel run's --save_hf_model file loaded back by
                 `load_otter_checkpoint` into a fresh model, every tensor
                 equal to the trained one.
  8. fused       the decode bench (otter_tpu_torch/tools/bench_decode.py) at
                 full width and depth, b=8, prompt 128, cache 256, int8
                 weights, three times: (a) the composed decode layer with a
                 bf16 cache, (b) `megakernel=True` with a bf16 cache, (c)
                 `fused_tail=True` with an int8 cache. Checks the launches a
                 decode step of every kernel on each route, that greedy
                 tokens repeat between runs, and that (b) holds one more
                 int8 copy of Wqkv and Wo; prints step ms (wall, and the
                 device's from the kernels' own times), tok/s and the
                 share of the memory roofline of the three.
  9. llama       OTTER-LLaMA2-Chat-7B at full width and depth (32 layers of
                 RoPE, RMSNorm and SwiGLU 11008, 8 xattn blocks, CLIP
                 ViT-L/14, perceiver depth 6, untied head of 32002 rows),
                 int8 weights and KV cache, decode_kernel="auto": the serve
                 phase's requests through `generate` and, at batch 1,
                 `stream_generate`. A decode step must launch `int8_matmul`
                 once (the head), the int8 decode_attention 32 times and
                 `int8_mlp` 8 times (the xattn FFs: the gated MLPs never
                 reach it), a prefill `flash_fwd` 70 times.
 10. otterhd     OtterHD-8B (Fuyu: Persimmon-8B, 36 layers, 64 heads of 64,
                 per-head q/k LayerNorm, partial rotary, squared-ReLU MLP
                 16384 with biases, untied head of 262144 rows; image
                 patches projected into the token stream), int8 weights,
                 int8 embedding table, int8 KV cache: one request at a time
                 through `generation.fuyu.FuyuGenerator` (its step a CUDA
                 graph, the card's default) and `FuyuGenerator(...,
                 cuda_graph=False)` in turns, a 448x448 image (240 image
                 tokens) and a 1080x1920 image (2340) with a 16-token
                 prompt each, 32 greedy tokens: tokens graphed = eager, no
                 host sync in 8 steps of either, wall ms a step both ways
                 ((t(32) - t(1)) / 31, medians of 3), TTFT, the capture's
                 ms and pool, the graphed step's device ms by
                 torch.profiler over whole runs. A decode step must launch
                 `int8_matmul` once, `int8_mlp` 36 times and the int8
                 decode_attention 36 times, a prefill `flash_fwd` 36
                 times, graphed and eager.
 12. beam        beam search and mixed media (runs after otterhd): first
                 OTTER-Video-LLaMA7B and OTTER-MPT7B cut in depth as in
                 parity, the beam path's first logits (a prefill of B*K
                 rows, the first beam step) through the kernels against
                 plain; then OTTER-Video-LLaMA7B at full width and depth
                 (32 layers, an untied head of 32004 rows, frame
                 embeddings for 128 frames; int8 weights and KV cache): one
                 still and one 16-frame video as uint8 [1, 2, 16, 224, 224,
                 3] normalised on the card, the still's frames 1-15 masked,
                 a 64-token prompt with the two media tokens. The still's
                 latents under the mask must equal the still encoded alone
                 within 2e-2 + 2e-2 |alone|; `stream_generate(vision_mask=)`
                 yields 32 greedy tokens, the same twice; `generate` and
                 `stream_beam_generate` with num_beams=3,
                 no_repeat_ngram_size=3, 32 new tokens. Then OTTER-MPT7B,
                 serve's b=8 requests with 4 beams each (32 rows). Each
                 beam request through `OtterGenerator` (its beam step a
                 CUDA graph, the card's default) and `cuda_graph=False` in
                 turns, as the otterhd phase's: the best beams graphed =
                 eager in every run, the last streamed beam of each =
                 generate's continuation, no host sync in 8 beam steps,
                 wall ms a beam step both ways, TTFT, capture ms and pool,
                 the graphed step's device ms. A beam step must launch
                 `int8_matmul` 1, `decode_attention` 32 and `int8_mlp` 8
                 times (video) or `int8_mlp` 40 and `decode_attention` 32
                 times (MPT), a beam prefill `flash_fwd` 70 times, graphed
                 and eager. The kernels phase holds the flash
                 forward, `decode_attention` and `int8_matmul` at these
                 requests' shapes too.
 13. worker      the serving worker (runs after beam): first OTTER-MPT7B
                 cut in depth as in parity, its unquantized weights written
                 as an HF checkpoint (`models.convert.port_to_hf`, .bin and
                 .safetensors) and loaded through the worker's start-up
                 (`serve.worker.load_otter_model`: the loader, then
                 `quantize_params` a tensor at a time, the int8 model):
                 every tensor bit-equal to the direct build, first-step
                 logits and one served request equal. Then OTTER-MPT7B at
                 full width and depth (int8 weights and KV cache) behind
                 `ModelWorker` and the controller over localhost HTTP: four
                 greedy requests of 32 new tokens (prompts of 32-128 tokens
                 with the media token, a random 256x256 PNG each) at once
                 straight to the worker, then one after another through the
                 controller, 3 rounds. Each request's text must be equal at
                 once, alone and to `tokenizer.decode` of
                 `OtterGenerator.generate`'s tokens; each alone must launch
                 its prefill's kernels (`flash_fwd` 70) and `decode_attention`
                 32 and `int8_mlp` 40 a step; the launches of the four at
                 once must equal the sum alone. Prints the time to the first
                 streamed chunk, ms a token a request and the aggregate
                 tok/s at once against one after another. The otterhd phase
                 also sends one text-only request through the worker's fuyu
                 stream function (its step graphed): its text must equal
                 `post_process_box_coordinates` of the eager
                 `fuyu_generate`'s.
 14. idefics     idefics-9b (runs after worker; ViT-H/14 with its CLS,
                 perceiver 6, LLaMA-7B with 8 gated xattn blocks, 68 added
                 tokens) at full width and depth, random bf16 weights with
                 int8 decoder layers (11.39 GB), int8 KV cache,
                 decode_kernel="auto", through OtterGenerator: b=1 and b=8
                 idefics-instruct prompts of 32-128 tokens with one
                 224x224 image each, one b=1 prompt with two images
                 interleaved and one with five, 32 greedy tokens (TTFT,
                 ms a step, tok/s, repeatable); the xattn rows that attend
                 no image finite; one request through the worker's
                 idefics stream over localhost HTTP, its text equal to
                 generate's. A prefill launches flash_fwd exactly 78
                 times, a decode step decode_attention 32 (and flash_fwd 8
                 with five images), nothing else. The kernels phase holds
                 the flash forward at its four sites and a step's xattn
                 over five images, and decode_attention at its cache.
 15. batch       the continuous batcher (runs after idefics):
                 OTTER-MPT7B at full width and depth (int8 weights and
                 KV cache) through ContinuousBatcher(num_slots=8,
                 cache_len=2048, prefill_chunk=256): 20 requests (16
                 greedy of 32-128 tokens, 2 of 300 and 480 prefilled in
                 chunks, one with 3 beams, one sampled; one 224x224 image
                 and 32 new tokens each), 8 at once then one every 50 ms.
                 The pool's step captured as a CUDA graph (the card's
                 default) and eager (`cuda_graph=False`), one run each:
                 the greedy and beam tokens equal between the two; each
                 greedy and the beam request against generate alone:
                 equal, or where bf16 products at another M part them,
                 the parting step's logits within 5e-2 max|lone|; the
                 sampled request repeats under one seed; every pooled
                 step launches int8_mlp 40 and decode_attention 32
                 times, nothing else (a replay counts what its capture
                 recorded). Prints aggregate tok/s and TTFT p50/p90 of
                 each, the graphs' capture ms and pools, a pooled step
                 at 8 rows graphed and eager (two pools of each in
                 turns) beside generate's b=8 step, and the graphed step
                 under torch.profiler (runs of 8 and 40 new tokens, each
                 profiled whole, a step from their difference); then
                 the worker (its pool graphed) with
                 --continuous-batching --num-slots 4 over localhost
                 HTTP (4 requests at once against one after another, 3
                 rounds, the status carrying batching) and idefics-9b
                 cut to 4 layers through 4 slots.
 16. spec        speculative decoding and the session cache (runs after
                 batch): OTTER-MPT7B at full width, its depth cut to 16
                 layers and 4 xattn blocks (int8 weights and KV cache),
                 with a Flamingo-MPT-1B draft cut to 12 of its 24
                 mosaic_gpt layers (qk_ln, an xattn block before each;
                 int8), random weights from a seed: the cuts keep the
                 default run inside its time with the training phases. (a) SpeculativeGenerator
                 at b=1, gamma 4, 32 new tokens on serve's prompts: the
                 MPT-1B draft and the target as its own draft (every
                 proposal accepted: the prefill and ceil(31/5) = 7 rounds,
                 unless a bf16 near-tie rejects one, judged by its
                 logits), TTFT, ms and tokens a round, tok/s beside
                 generate's; every round launches int8_mlp and
                 decode_attention exactly as derived from the routing
                 (`spec_round_launches`); stream = generate; tokens equal
                 to generate alone, or the parting token's logits within
                 5e-2 max|lone|. (b) ContinuousBatcher(num_slots=8,
                 cache_len=2048, draft=MPT-1B, spec_gamma=4), the adaptive
                 controller off then on (its cadence cut to 4 / 2
                 iterations: it probes gamma 2 and plain decode and
                 chooses): 8 greedy requests of 32 new tokens and one
                 sampled of 8; exact launches of every round, plain step
                 and catch-up; the wall of a round at 8 rows; the modes
                 chosen (`stats()`); greedy tokens against the draft-free
                 pool's, partings judged by their logits. (c) the worker
                 with --draft-checkpoint and --session-cache 2 built
                 in-process over localhost HTTP: a 3-turn conversation
                 under one session id, each turn's time to the first chunk
                 beside the stateless worker's, the texts equal; then
                 sessions A, B, C: the least recently used is evicted.
 11. train       OTTER-MPT7B at full width in bf16 through train/sft.py's
                 `main(parse_args([...]))` as a user runs it: a data YAML
                 written here (an IMAGE_TEXT group, one 256x256 image a
                 sample, and an IMAGE_TEXT_IN_CONTEXT group, three
                 in-context pairs and four images a sample; 560-960 tokens
                 a sample), a WordLevel tokenizer directory written here
                 (`--tokenizer`), the weighted loader, b=2, max_seq_len
                 1024, remat, fused CE, embedding-row mask, lr 1e-4
                 constant, two epochs (18 steps). Checks finite losses,
                 the second epoch's mean below the first's, both groups
                 drawn, frozen weights bit-identical, every trainable
                 group moved, and exactly 102 flash_fwd and 46 of each
                 backward kernel a step; prints step and data ms,
                 samples/s, tokens/s, peak memory, the bytes of weights
                 and optimizer state, and model FLOP share.
 17. train8      the single-card 7B recipe (tools/bench_train_7b.py) at
                 full width: OTTER-MPT7B with int8 frozen decoder layers
                 (FROZEN_DECODER_PATTERNS), bf16 xattn and trainables,
                 8-bit Adam (no f32 masters), b=2, 1024 tokens, remat,
                 fused CE 256, lr 1e-4: 2 warm-up and 5 timed steps on one
                 batch. First one step without remat through
                 `Int8Dense`'s `_Int8Product` and through the composed
                 product: the latter's peak must exceed it by at least
                 the frozen int8 kernels' bytes (autograd keeps their bf16
                 copies). Checks falling loss, frozen tensors
                 bit-identical, every trainable group moved, exact flash
                 launches a step, and that `int8_mlp` refuses an input
                 that needs a gradient; prints the bytes of frozen and
                 trainable weights and optimizer state and the peak
                 memory beside the train phase's, step ms, samples/s and
                 tokens/s, and (train too) the optimizer update's ms in
                 one more step.

 18. pretrain    Flamingo pretraining as a user runs it:
                 `pretrain.main([...])` on Flamingo-MPT-1B at full width
                 and depth in bf16 over two LAION shards (64 noise-PNG /
                 caption pairs each) and two MMC4 shards (16 documents of
                 four sentences and three noise PNGs over the 10 KB
                 filter) written here with `tarfile`, a WordLevel
                 tokenizer directory, --batch_size_laion 32
                 --batch_size_mmc4 8 (a 4x cut of the reference's 128 /
                 32: the JAX pretrainer has no remat), 4 steps an epoch;
                 then a second call with --num_epochs 2 that resumes from
                 the epoch's checkpoint. Checks finite losses with
                 loss_laion and loss_mmc4 logged each step, frozen tensors
                 bit-identical, every trainable group moved, the resumed
                 call at step 4 with the first call's trainables, and
                 exactly 156 flash_fwd and 108 of each backward kernel a
                 step; prints step ms, peak memory and the bytes of
                 weights, optimizer state and checkpoint.
 19. fuyutrain   OtterHD-8B full fine-tune (`train/fuyu_sft.py`) at full
                 width and depth: bf16 parameters, 8-bit Adam, remat, b=1,
                 `FuyuBatcher(dynamic_resolution=True)` over one noise
                 image each at 448², 512² and 768²: a warm-up step, three
                 timed ones and the first batch again, whose loss must
                 fall; every parameter moves; exactly 72 flash_fwd and 36
                 of each backward kernel a step. Prints peak memory
                 (absolute and above what earlier phases left), step ms,
                 the 8-bit update's ms and tokens a step.
 20. lora        OTTER-MPT7B with int8 frozen decoder layers and LoRA rank
                 16 on Wqkv, 8-bit Adam, b=2 x 1024, remat, fused CE: the
                 first-step logits before training (B = 0) bit-equal to
                 the LoRA-free model's; 2 warm-up and 3 timed steps in
                 which the adapters are the only decoder-layer tensors
                 that move and the int8 tensors stay bit-identical; then
                 one greedy generate of 8 tokens from the trained model
                 (composed route, int8 cache), the same twice.
 21. parallel    the parallel layer on one card: the ring attention's
                 per-rank code for 4 ranks in one process (the rotation
                 by index) at MPT-7B's training self-attention (b=2,
                 S=4096, 32 heads of 128, ALiBi column bias, padding ids)
                 and OtterHD-8B's full-HD prefill (S=2356, 64 heads of 64)
                 against one flash call over the whole sequence, forward
                 and backward within the flash bars, with each side's
                 device ms and exactly 10 launches of each flash kernel a
                 ring; then `sft.main` with --multi_host at RANK=0,
                 WORLD_SIZE=1 and --fsdp -1 (NCCL, the mesh and
                 `fully_shard` at extent 1) on the train phase's model at
                 cut depth against the unsharded `sft.main` over the same
                 data YAML and seed (loss 1e-2, grad norm 2e-2 a step),
                 its flash launches exact, and its final checkpoint
                 restored equal.
 22. eval        the eval harness as a user runs it: OTTER-Image-MPT7B at
                 full width and depth (serve's model: int8 weights, int8
                 KV cache, decode_kernel="auto") behind
                 `api.OtterForConditionalGeneration`, injected with a
                 tokenizer into the otter_image entry of a config for
                 `benchmarks.evaluate.run` over the bundled MME (8 rows)
                 and POPE (9) samples, 16 new tokens a row: the report
                 files and the summary, every rate in [0, 1], every answer
                 a string, launches of flash_fwd, int8_mlp and
                 decode_attention and of no other kernel; then
                 `public_suite.evaluate_vqa` through `generate_batch`
                 (batches of 8) over 16 noise-PNG items written here, at 0
                 and 4 shots; one row's first-step logits and one
                 `eval_forward` score through the kernels against the plain
                 versions (5e-2 max|plain|; 1e-2 |plain|). Then Fuyu and
                 OtterHD on OtterHD-8B (int8, quant_embed, int8 cache: the
                 int8 head must launch, the step of each adapter's
                 `FuyuGenerator` be captured), Idefics on idefics-9b (int8
                 decoder and cache; also `generate_batch`) and OtterVideo
                 on OTTER-Video-LLaMA7B with 16 frames, each at full width
                 with parity's depth cut: `generate` and `eval_forward` on
                 two POPE rows. Prints each adapter's seconds a row and
                 decode tok/s, and whether the native image decoder built
                 on this host (its pixels against PIL's if it did).

 23. graph       the captured decode step (runs after serve4):
                 OTTER-Image-MPT7B at full width and depth (serve's model:
                 int8 weights and cache, decode_kernel="auto") at b=1 and
                 b=8, serve's prompts, 32 new tokens, through
                 `OtterGenerator` (its step captured as a CUDA graph, the
                 default on the card) and `OtterGenerator(...,
                 cuda_graph=False)` in turns: tokens equal (or the logits
                 at the first parting step within 5e-2 max|eager|),
                 launches a step equal, wall ms a step ((t(32) - t(1)) /
                 31, medians of 3), TTFT, the first request of a key (its
                 step captured) against later ones, the capture's ms and
                 memory pool; a b=1 stream's first and second token on a
                 new key; a 2000-token request (cache 2048) on both engines
                 between two requests of the captured key (its workspace
                 and tokens kept); one request through the worker's
                 stream over localhost HTTP; 8 steps of each engine under
                 `torch.cuda.set_sync_debug_mode("error")`; the device ms
                 a step by torch.profiler over whole runs and by CUDA
                 events over 30 queued replays; whether torch.multinomial
                 and the top-k / top-p filters capture. Then the same
                 model with `megakernel=True` and a bf16 cache (the
                 kernel reads the position from the device counter) at
                 b=1 and b=8 the same way: tokens equal, launches a step
                 exact (32 decode_attn_megakernel, 40 int8_mlp), no host
                 sync in 8 steps of either engine. Then
                 OTTER-LLaMA2-Chat-7B at b=8 the same way (rope positions
                 from the device counter), its launches exact.

In every phase `OtterGenerator`'s greedy, sampled and beam decode steps
(the fused phase's megakernel route too), `FuyuGenerator`'s step (the
eval phase's Fuyu / OtterHD adapters and the worker's fuyu stream too)
and the continuous batcher's pooled step replay a captured CUDA graph
(the default on the card); the speculative rounds step eagerly.

`--phases profilerace` (not in the default run) repeats, in a child
process, the pattern in which two default runs crashed (ROADMAP Queue 3):
a continuous batcher of 8 slots on OTTER-MPT7B serving 12 requests on
consumer threads while the main thread starts and stops torch.profiler
every ~0.2 s, four times; it reports how the child ended. (On an H100
with torch 2.11 the child aborted inside the profiler's stop, "double
free or corruption", in its first repetition: the batch phase profiles
whole runs for that reason.)

The kernels phase holds the flash forward and both backward kernels at
the new phases' shapes too, and trainparity one pretraining step, one
OtterHD step and one LoRA step at cut depth, each through the kernels
against the plain versions. Where the bf16 plain step itself strays
beyond the bar from the f32 step, a tensor is held to the f32 step with
the plain step's spread under one-rounding nudges of every attention
output as its floor; each step with a tensor at the floor then runs
through two slightly broken flash kernels (dS with the next row's di;
the softmax scale 1/8 too large), which the check must reject, and the
pretraining step shows where its tensors at the floor move (forward
kernel alone, backward kernels alone, torch's SDPA; also on a second
batch).

The last two lines of standard output are the kernels JSON object and the
device JSON object. `--phases` runs a subset (for bring-up); the default
runs all twenty-three (`--phases beam` the beam phase alone). `flashkernels`
runs the flash part of the kernels phase alone, `mlpkernels` its
`int8_mlp` and `int8_attn_tail` cases,
`fusedkernels` the tail and the megakernel, `int4kernels` `int4_mlp` and
`int4_matmul`, `headkernels` `int8_matmul`, `decodekernels`
`decode_attention`. `--port-root
DIR` imports `otter_tpu_torch` from another checkout, so that two versions
of the port run one after the other in one call. `profile` (not run by default) adds torch.profiler tables
of one batch-8 request (with serve, serve4 and llama), of OtterHD's two
requests through the eager step (with otterhd; the graphed step's tables,
and the beam phase's, are written on every run), of the three fused runs (with fused: device ms
and launches a decode step), of idefics-9b's b=8 request (with idefics)
and of one train step (with train and with train8) to the output
directory, `OUT_DIR`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, NVIDIA H100 SXM data sheet
H100_BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
SEED = 0
REPS = 3          # timed repetitions of each serve request
OUT_DIR = "chiprun_out"
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call of fn: CUDA events around `iters` calls
    queued behind a ~10 ms spin kernel, so the card runs them back to back
    whatever the host's pace. Where the host takes longer to launch a call
    than the card to run it, `time_ms` measures the host; this does not."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)   # cycles: longer than the host's queueing
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(out, ref, keep=None, per_row=False, slack=None):
    """(max |err|, its largest excess over |err| <= 2e-2 + 2e-2 |plain|).
    `per_row`: the absolute 2e-2 scaled down to each row's (last dim's)
    largest |plain| where that is below 1, so that a row of small values,
    as a long decode span averages to, is held to its own scale. `slack`:
    a tensor added to the bound (a rounding that the function itself does
    before a cancellation)."""
    import torch
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    floor = torch.full_like(r, 2e-2)
    if per_row:
        floor = floor * r.amax(-1, keepdim=True).clamp(max=1)
    if slack is not None:
        floor = floor + slack.float()
    if keep is not None:
        d, r, floor = d[keep], r[keep], floor[keep]
    return float(d.max()), float((d - (floor + 2e-2 * r)).max())


# ── phase 1: device ─────────────────────────────────────────────────

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


# ── phase 2: build ──────────────────────────────────────────────────

# the weight-streaming kernels that must run on the tensor cores, and the
# sources they are built into
TENSOR_CORE_KERNELS = {
    "int8_mlp_hidden_kernel": ("int8_mlp", "int8_attn_tail"),
    "int4_mlp_hidden_kernel": ("int4_mlp",),
    "int8_matmul_partial_kernel": ("megakernel", "int8_attn_tail"),
    "int8_matmul_kernel": ("int8_matmul",),
    "int4_matmul_kernel": ("int4_mlp",),
}


def phase_build(check_sass: bool = True):
    """`check_sass`: fail if an instantiation of a kernel of
    `TENSOR_CORE_KERNELS` runs no tensor-core instruction (off for another
    version of the port)."""
    from otter_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    log(f"build: {sorted(logs)} compiled in {time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    counts = {kernel: _sass_counts(_build, sources, kernel)
              for kernel, sources in TENSOR_CORE_KERNELS.items()}
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        for name, text in sorted(logs.items()):
            f.write(f"== {name}.cu\n{text}\n")
        for kernel, c in counts.items():
            f.write(f"== SASS of {kernel}\n{json.dumps(c)}\n")
    for kernel, c in counts.items():
        log(f"build: SASS of {kernel}<n-tiles...>: {c}")
        if check_sass and any(n["HMMA"] + n["HGMMA"] == 0
                              for n in c.values()):
            raise RuntimeError(f"{kernel} runs no tensor-core instruction")


def _sass_counts(build, sources, kernel: str) -> dict:
    """{source:function: counts of tensor-core (HMMA, HGMMA) and f32 FFMA
    instructions} for every function of the built `sources` whose name
    holds `kernel`, from `cuobjdump -sass`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for src in sources:
        sass = subprocess.run([tool, "-sass", str(build._target(src))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                fn = f"{src}:{fn}" if kernel in fn else None
                if fn:
                    counts[fn] = {"HMMA": 0, "HGMMA": 0, "FFMA": 0}
            elif fn:
                for op in ("HGMMA", "HMMA", "FFMA"):
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
                        break
    if not counts:
        raise RuntimeError(f"no {kernel} in the SASS of {sources}")
    return counts


# ── phase 3: kernels against their plain versions ───────────────────

def _flash_cases(gen):
    """(name, kwargs) at the serving path's prefill shapes, batch 8."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    b = 8
    cases = [("clip", dict(q=rnd(b, 16, 257, 64), k=rnd(b, 16, 257, 64),
                           v=rnd(b, 16, 257, 64)), None),
             ("perceiver", dict(q=rnd(b, 8, 64, 64), k=rnd(b, 8, 320, 64),
                                v=rnd(b, 8, 320, 64)), None)]
    s = 128
    lens = torch.tensor([128, 100, 77, 32, 128, 64, 45, 90], device=dev)
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] >= s - lens[:, None]).int()       # left padding
    bias = (torch.arange(1 - s, 1, device=dev)[None, None, None, :]
            * alibi_slopes(32, device=dev)[None, :, None, None])
    cases.append(("mpt_prefill", dict(
        q=rnd(b, 32, s, 128), k=rnd(b, 32, s, 128), v=rnd(b, 32, s, 128),
        bias=bias, q_ids=mask, kv_ids=mask, causal=True,
        sm_scale=128 ** -0.5), None))
    # text_time: 0 on the left padding before the media token, 1 after
    text_time = mask.clone()
    kv_ids = torch.ones((b, 64), dtype=torch.int32, device=dev)
    cases.append(("xattn_prefill", dict(
        q=rnd(b, 8, s, 64), k=rnd(b, 8, 64, 64), v=rnd(b, 8, 64, 64),
        q_ids=text_time, kv_ids=kv_ids, ids_mode="eq",
        sm_scale=64 ** -0.5), text_time > 0))
    # the beam phase's: MPT's prefill at 4 beams (32 rows); the video
    # request's CLIP over 2 x 16 frames, its masked perceiver (64 latents
    # against 16 x 256 tokens + 64; the still's frames 1-15 masked) and
    # LLaMA's prefill of 64 tokens at 3 beams
    m32 = mask.repeat_interleave(4, 0)
    cases.append(("mpt_prefill beams K=4", dict(
        q=rnd(32, 32, s, 128), k=rnd(32, 32, s, 128), v=rnd(32, 32, s, 128),
        bias=bias, q_ids=m32, kv_ids=m32, causal=True,
        sm_scale=128 ** -0.5), None))
    cases.append(("clip video 32 frames", dict(
        q=rnd(32, 16, 257, 64), k=rnd(32, 16, 257, 64),
        v=rnd(32, 16, 257, 64)), None))
    kv_ids = torch.ones((2, 16 * 256 + 64), dtype=torch.int32, device=dev)
    kv_ids[0, 256:16 * 256] = 0
    cases.append(("perceiver video masked", dict(
        q=rnd(2, 8, 64, 64), k=rnd(2, 8, 16 * 256 + 64, 64),
        v=rnd(2, 8, 16 * 256 + 64, 64),
        q_ids=torch.ones((2, 64), dtype=torch.int32, device=dev),
        kv_ids=kv_ids, ids_mode="eq", sm_scale=64 ** -0.5), None))
    ones = torch.ones((3, 64), dtype=torch.int32, device=dev)
    cases.append(("llama video prefill K=3", dict(
        q=rnd(3, 32, 64, 128), k=rnd(3, 32, 64, 128), v=rnd(3, 32, 64, 128),
        q_ids=ones, kv_ids=ones, causal=True, sm_scale=128 ** -0.5), None))
    return cases + _idefics_flash_cases(rnd, mask, lens)


def _idefics_flash_cases(rnd, mask, lens):
    """idefics-9b's flash sites (the idefics phase's requests: b=8, one
    image each, left-padded to 128): its ViT-H/14 tower (257 tokens, CLS
    kept, 16 heads of 80), the perceiver (64 latents over 257 + 64 keys,
    16 heads of 96), the decoder (causal, 32 heads of 128) and the gated
    xattn (a dense f32 bias [B, 1, S, 64]: the left padding and the text
    before the image attend no key, and those rows are compared too);
    then a decode step's xattn over five images (one query, 320 keys, the
    last image's 64 attended)."""
    import torch
    from otter_tpu_torch.ops.masks import DEFAULT_MASK_VALUE
    dev, b, s = "cuda", 8, 128
    pos = torch.arange(s, device=dev)
    # the image after 3 real tokens ("User:" and the token around it)
    sees = pos[None, :] >= (s - lens[:, None] + 3)
    xbias = torch.where(sees, 0.0, DEFAULT_MASK_VALUE)[:, None, :, None] \
        .expand(b, 1, s, 64).contiguous()
    step_bias = torch.full((1, 1, 1, 320), DEFAULT_MASK_VALUE, device=dev)
    step_bias[..., 256:] = 0.0
    return [
        ("idefics vit", dict(q=rnd(b, 16, 257, 80), k=rnd(b, 16, 257, 80),
                             v=rnd(b, 16, 257, 80)), None),
        ("idefics perceiver", dict(
            q=rnd(b, 16, 64, 96), k=rnd(b, 16, 321, 96),
            v=rnd(b, 16, 321, 96), sm_scale=96 ** -0.5), None),
        ("idefics decoder", dict(
            q=rnd(b, 32, s, 128), k=rnd(b, 32, s, 128),
            v=rnd(b, 32, s, 128), q_ids=mask, kv_ids=mask, causal=True,
            sm_scale=128 ** -0.5), None),
        ("idefics xattn", dict(
            q=rnd(b, 32, s, 128), k=rnd(b, 32, 64, 128),
            v=rnd(b, 32, 64, 128), bias=xbias, sm_scale=128 ** -0.5), None),
        ("idefics xattn step, 5 images", dict(
            q=rnd(1, 32, 1, 128), k=rnd(1, 32, 320, 128),
            v=rnd(1, 32, 320, 128), bias=step_bias, sm_scale=128 ** -0.5),
         None)]


def _flash_cost(kw):
    q, k = kw["q"], kw["k"]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = sq * (sq + 1) // 2 if kw.get("causal") else sq * sk
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * sq
    if kw.get("bias") is not None:
        nbytes += 4 * kw["bias"].numel()
    if kw.get("q_ids") is not None:
        nbytes += 4 * (b * sq + b * sk)
    return nbytes, 4.0 * b * h * d * pairs


def _sdpa_args(kw, fill=float("-inf")):
    """An additive mask that makes SDPA compute the same attention."""
    import torch
    q = kw["q"]
    b, h, sq, _ = q.shape
    sk = kw["k"].shape[2]
    ok = torch.ones((b, 1, sq, sk), dtype=torch.bool, device=q.device)
    if kw.get("q_ids") is not None:
        qi = kw["q_ids"][:, None, :, None]
        ki = kw["kv_ids"][:, None, None, :]
        ok = ok & ((qi == ki) if kw.get("ids_mode", "eq") == "eq"
                   else (qi >= ki))
    if kw.get("causal"):
        ok = ok & torch.ones(sq, sk, dtype=torch.bool,
                             device=q.device).tril()[None, None]
    add = torch.zeros((b, h, sq, sk), device=q.device)
    if kw.get("bias") is not None:
        add = add + kw["bias"]
    add = add.masked_fill(~ok, fill).to(q.dtype)
    return add


def _flash_bwd_cases(gen):
    """(name, kwargs) at the training path's shapes, b=2, S=1024."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def mpt(s, real):
        pos = torch.arange(s, device=dev)
        ids = (pos[None, :] < torch.tensor(real, device=dev)[:, None]).int()
        bias = (torch.arange(1 - s, 1, device=dev)[None, None, None, :]
                * alibi_slopes(32, device=dev)[None, :, None, None])
        return dict(q=rnd(2, 32, s, 128), k=rnd(2, 32, s, 128),
                    v=rnd(2, 32, s, 128), bias=bias, q_ids=ids, kv_ids=ids,
                    causal=True, sm_scale=128 ** -0.5)

    def xattn(mode):
        # text_time 0 before the media token at position 3: rows that may
        # attend no key (their forward averaged v)
        tt = torch.ones((2, 1024), dtype=torch.int32, device=dev)
        tt[:, :3] = 0
        return dict(q=rnd(2, 8, 1024, 64), k=rnd(2, 8, 64, 64),
                    v=rnd(2, 8, 64, 64), q_ids=tt,
                    kv_ids=torch.ones((2, 64), dtype=torch.int32, device=dev),
                    ids_mode=mode, sm_scale=64 ** -0.5)

    return [("mpt", mpt(1024, [1024, 900])),
            ("perceiver", dict(q=rnd(2, 8, 64, 64), k=rnd(2, 8, 320, 64),
                               v=rnd(2, 8, 320, 64), sm_scale=64 ** -0.5)),
            ("xattn_eq", xattn("eq")), ("xattn_ge", xattn("ge")),
            ("mpt_s1000", mpt(1000, [1000, 777]))] + _new_train_cases(rnd)


def _new_train_cases(rnd):
    """The pretrain, fuyutrain and lora phases' flash sites beyond the SFT
    ones: OtterHD-8B's full fine-tune (b=1, 64 heads of 64, causal, the
    768² batch's length), Flamingo-MPT-1B's LAION (b=32 x 32) and MMC4
    (b=8 x 256) decoder batches (16 heads of 128, ALiBi, causal, right
    padding) and their xattn blocks (8 heads of 64; MMC4's three media
    tokens over 5 x 64 latents, "eq" as the model runs it and "ge")."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"

    def mpt1b(b, s):
        lens = torch.linspace(s, s * 3 // 4, b, device=dev).long()
        ids = (torch.arange(s, device=dev)[None, :] < lens[:, None]).int()
        bias = (torch.arange(1 - s, 1, device=dev)[None, None, None, :]
                * alibi_slopes(16, device=dev)[None, :, None, None])
        return dict(q=rnd(b, 16, s, 128), k=rnd(b, 16, s, 128),
                    v=rnd(b, 16, s, 128), bias=bias, q_ids=ids, kv_ids=ids,
                    causal=True, sm_scale=128 ** -0.5)

    def xattn(b, s, media, slots, mode):
        tt = torch.zeros((b, s), dtype=torch.int32, device=dev)
        for p in media:
            tt[:, p:] += 1
        kv = torch.arange(1, slots + 1, dtype=torch.int32, device=dev
                          ).repeat_interleave(64)[None].expand(b, -1)
        return dict(q=rnd(b, 8, s, 64), k=rnd(b, 8, 64 * slots, 64),
                    v=rnd(b, 8, 64 * slots, 64), q_ids=tt,
                    kv_ids=kv.contiguous(), ids_mode=mode,
                    sm_scale=64 ** -0.5)

    s = fuyu_train_len(768)
    ones = torch.ones((1, s), dtype=torch.int32, device=dev)
    return [(f"fuyu 768 S={s}", dict(
                q=rnd(1, 64, s, 64), k=rnd(1, 64, s, 64),
                v=rnd(1, 64, s, 64), q_ids=ones, kv_ids=ones, causal=True,
                sm_scale=64 ** -0.5)),
            ("mpt1b laion", mpt1b(32, 32)), ("mpt1b mmc4", mpt1b(8, 256)),
            ("mpt1b xattn laion", xattn(32, 32, [0], 1, "eq")),
            ("mpt1b xattn mmc4 eq", xattn(8, 256, [0, 64, 128], 5, "eq")),
            ("mpt1b xattn mmc4 ge", xattn(8, 256, [0, 64, 128], 5, "ge"))]


def fuyu_train_len(size: int) -> int:
    """Tokens of the fuyutrain phase's batch drawn at `size`²."""
    cfg = fuyu_train_cfg()
    text, image = fuyu_train_samples(SEED + 90, (size,))[0]
    return fuyu_processor(cfg)([text], [image], target_resolution=(
        size, size))["input_ids"].shape[1]


def _fuyu_prefill_case(gen):
    """OtterHD-8B's full-HD prefill: one request of 2356 tokens (a
    1080x1920 image and a 16-token prompt), 64 heads of 64, causal, ids of
    its attention mask (all ones)."""
    import torch
    s = 2356
    q, k, v = (torch.randn(1, 64, s, 64, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    ids = torch.ones((1, s), dtype=torch.int32, device="cuda")
    return ("fuyu_prefill", dict(q=q, k=k, v=v, q_ids=ids, kv_ids=ids,
                                 causal=True, sm_scale=64 ** -0.5), None)


def _flash_head_dim_cases(gen):
    """Small cases at the head dims of mpt30b (112) and idefics-9b's ViT-H
    tower and perceiver (80, 96): causal with ALiBi and left-padding ids
    (the decoder), and non-causal with a full [B, 1, S_q, S_k] bias."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"
    cases = []
    for d in (80, 96, 112):
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev,
                                         dtype=torch.bfloat16)
        s = 320
        pos = torch.arange(s, device=dev)
        ids = (pos[None, :] >= torch.tensor([0, 57], device=dev)[:, None]
               ).int()
        bias = (torch.arange(1 - s, 1, device=dev)[None, None, None, :]
                * alibi_slopes(4, device=dev)[None, :, None, None])
        cases.append((f"d{d}_causal", dict(
            q=rnd(2, 4, s, d), k=rnd(2, 4, s, d), v=rnd(2, 4, s, d),
            bias=bias, q_ids=ids, kv_ids=ids, causal=True,
            sm_scale=d ** -0.5)))
        cases.append((f"d{d}_cross", dict(
            q=rnd(2, 4, 200, d), k=rnd(2, 4, 333, d), v=rnd(2, 4, 333, d),
            bias=torch.randn(2, 1, 200, 333, generator=gen, device=dev),
            sm_scale=d ** -0.5)))
    return cases


def _flash_bwd_cost(kw, products: int, outputs: int):
    """(bytes, operations) of one backward kernel: q, k, v, do read once
    (bf16), lse and di (f32), bias and ids, `outputs` of dq/dk/dv written
    (bf16); `products` [S_q x S_k x D] products over the pairs the mask
    can reach (half for causal)."""
    q, k = kw["q"], kw["k"]
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pairs = sq * (sq + 1) // 2 if kw.get("causal") else sq * sk
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * b * h * sq
    nbytes += 2 * (q.numel() if outputs == 1 else 2 * k.numel())
    if kw.get("bias") is not None:
        nbytes += 4 * kw["bias"].numel()
    if kw.get("q_ids") is not None:
        nbytes += 4 * (b * sq + b * sk)
    return nbytes, 2.0 * products * b * h * d * pairs


def _sdpa_backward(kw, do):
    """SDPA's backward on the same inputs: time(forward + backward) -
    time(forward), with the mask as a float attn_mask (a finite fill, so
    rows that attend nothing average v as the port does); the same
    difference of device times."""
    import torch
    import torch.nn.functional as F
    mask = _sdpa_args(kw, fill=-1e30)
    leaves = [kw[n].detach().requires_grad_() for n in ("q", "k", "v")]
    scale = kw.get("sm_scale", kw["q"].shape[-1] ** -0.5)
    fwd = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 scale=scale)
    both = lambda: torch.autograd.grad(fwd(), leaves, do)
    return (time_ms(both, 10) - time_ms(fwd, 10),
            device_ms(both) - device_ms(fwd))


def _sdpa_fwd(kw, fill=float("-inf")):
    """One SDPA call that computes the same attention: with is_causal and
    no mask where the case has no bias and its ids mask nothing (SDPA's
    own flash kernel), else with an additive mask."""
    import torch
    import torch.nn.functional as F
    scale = kw.get("sm_scale", kw["q"].shape[-1] ** -0.5)
    ids = [kw.get(n) for n in ("q_ids", "kv_ids")]
    # "eq" ids that all hold one value allow every pair
    one_id = ids[0] is None or (
        kw.get("ids_mode", "eq") == "eq"
        and int(torch.cat([i.flatten() for i in ids]).unique().numel()) == 1)
    if kw.get("bias") is None and one_id:
        causal = bool(kw.get("causal"))
        return lambda: F.scaled_dot_product_attention(
            kw["q"], kw["k"], kw["v"], is_causal=causal, scale=scale)
    mask = _sdpa_args(kw, fill)
    return lambda: F.scaled_dot_product_attention(
        kw["q"], kw["k"], kw["v"], attn_mask=mask, scale=scale)


def _flash_kernels(gen, report, entries):
    """The flash forward and both backward kernels against their plain
    twins: the serving prefill shapes, OtterHD's full-HD prefill, the
    training shapes, and small cases at head dims 80, 96 and 112."""
    import torch
    from otter_tpu_torch.ops import flash_attention as fa

    # flash attention forward: four prefill configurations
    for case, kw, keep in _flash_cases(gen) + [_fuyu_prefill_case(gen)]:
        out = fa.flash_attention(**kw)
        ref = fa.flash_attention_plain(**kw)
        torch.cuda.synchronize()
        keep4 = None if keep is None else keep[:, None, :, None].expand_as(out)
        err, excess = max_err(out, ref, keep4)
        if not bool(torch.isfinite(out).all()):
            excess = float("inf")   # e.g. a row that attends no key
        kern = lambda kw=kw: fa.flash_attention(**kw)
        r = report("flash_fwd", case, err, excess, time_ms(kern),
                   time_ms(lambda kw=kw: fa.flash_attention_plain(**kw), 5),
                   time_ms(_sdpa_fwd(kw)), *_flash_cost(kw),
                   device=(device_ms(kern), device_ms(_sdpa_fwd(kw))))
        if case == "mpt_prefill":
            entries["flash_fwd"] = r

    # flash attention backward: the training path's three attention sites
    # and a length that is not a multiple of the 64-row tile
    log("kernels: flash at the training shapes; forward tolerance as "
        "above; backward |err| <= 2e-2*max|plain| + 2e-2*|plain| (bf16 "
        "out, f32 inside); backward plain = the whole plain backward (dq, "
        "dk, dv); backward library = SDPA forward+backward - forward")
    for case, kw in ([(f"train {c}", kw) for c, kw in _flash_bwd_cases(gen)]
                     + _flash_head_dim_cases(gen)):
        args = [kw["q"], kw["k"], kw["v"], kw.get("bias"), kw.get("q_ids"),
                kw.get("kv_ids")]
        opts = {n: kw[n] for n in ("causal", "sm_scale", "ids_mode")
                if n in kw}
        out, lse = fa.flash_attention(*args, return_lse=True, **opts)
        # the forward at the training shapes too (row 1 of PERF.md's table)
        err, excess = max_err(out, fa.flash_attention_plain(*args, **opts))
        kern = lambda: fa.flash_attention(*args, **opts)
        report("flash_fwd", case, err, excess, time_ms(kern, 10),
               time_ms(lambda: fa.flash_attention_plain(*args, **opts), 3, 1),
               time_ms(_sdpa_fwd(kw, fill=-1e30), 10), *_flash_cost(kw),
               device=(device_ms(kern), device_ms(_sdpa_fwd(kw, fill=-1e30))))
        do = torch.randn(out.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        di = (out.float() * do.float()).sum(-1)
        dk, dv = fa.flash_bwd_dkv(*args, lse, di, do, **opts)
        dq = fa.flash_bwd_dq(*args, lse, di, do, **opts)
        pq, pk, pv = fa.flash_attention_bwd_plain(*args, out, lse, do, **opts)
        torch.cuda.synchronize()
        errs = {}
        for name, a, r in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
            d = (a.float() - r.float()).abs()
            rr = r.float().abs()
            errs[name] = (float(d.max()), float(
                (d - (2e-2 * rr.max() + 2e-2 * rr)).max()), bool(
                    torch.isfinite(a).all()))
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
            *args, out, lse, do, **opts), 3, 1)
        lib_ms, lib_dev = _sdpa_backward(kw, do)
        for kernel, names, products, fn in (
                ("flash_bwd_dkv", ("dk", "dv"), 4,
                 lambda: fa.flash_bwd_dkv(*args, lse, di, do, **opts)),
                ("flash_bwd_dq", ("dq",), 3,
                 lambda: fa.flash_bwd_dq(*args, lse, di, do, **opts))):
            err = max(errs[n][0] for n in names)
            excess = max(errs[n][1] for n in names)
            if not all(errs[n][2] for n in names):
                excess = float("inf")
            r = report(kernel, case, err, excess, time_ms(fn, 10), plain_ms,
                       lib_ms, *_flash_bwd_cost(kw, products, len(names)),
                       device=(device_ms(fn), lib_dev))
            if case == "train mpt":
                entries[kernel] = r
        del out, lse, do, di, dk, dv, dq, pq, pk, pv



def phase_kernels(gen, only: str = ""):
    """Every kernel against its plain version; `only` (for bring-up) checks
    a part alone: "fused" (phase `fusedkernels`) the fused decode layer's
    two, "head" (phase `headkernels`) `int8_matmul`, "flash" (phase
    `flashkernels`) the flash forward and backward, "decode" (phase
    `decodekernels`) `decode_attention`, "mlp" (phase `mlpkernels`)
    `int8_mlp` and `int8_attn_tail`, "int4" (phase `int4kernels`)
    `int4_mlp` and `int4_matmul`."""
    tol = "|err| <= 2e-2 + 2e-2*|plain| (bf16 in/out, f32 inside)"
    log(f"kernels: tolerance {tol}")
    entries = {}
    failed = []

    def report(kernel, case, err, excess, ms, plain_ms, lib_ms, nbytes,
               flops, device=None):
        """`device`: (kernel, library) device ms from `device_ms` (CUDA
        events around calls queued behind a spin kernel), where measured;
        the TFLOP/s and share of the bound are the device's."""
        b_ms, b_by = bound_ms(nbytes, flops)
        ok = excess <= 0 and math.isfinite(err)
        dev = ""
        if device is not None:
            lib_dev = ("none" if device[1] is None
                       else f"{device[1]:.4f} ms")
            dev = (f" | device: kernel {device[0]:.4f} ms "
                   f"({flops / device[0] / 1e9:.1f} TFLOP/s, "
                   f"{100 * b_ms / device[0]:.1f}% of the bound), library "
                   f"{lib_dev}")
        log(f"  {kernel}[{case}]: max_abs_err {err:.3e} "
            f"{'ok' if ok else f'FAIL (by {excess:.3e})'} | kernel "
            f"{ms:.4f} ms | plain "
            f"{plain_ms:.4f} ms | library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} | bound "
            f"{b_ms:.4f} ms ({b_by}){dev}")
        if not ok:
            failed.append(f"{kernel}[{case}]")
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms)
        if device is not None:
            r.update(device_ms=device[0], library_device_ms=device[1])
        return r

    def done():
        if failed:
            raise RuntimeError(f"kernels disagree with their plain "
                               f"versions: {failed}")
        return entries

    if only:
        {"fused": _fused_layer_kernels, "head": _head_kernel,
         "flash": _flash_kernels, "decode": _decode_kernels,
         "mlp": _mlp_kernels, "int4": _int4_kernels}[only](
            gen, report, entries)
        return done()

    _flash_kernels(gen, report, entries)

    _mlp_kernels(gen, report, entries)
    _int4_kernels(gen, report, entries)
    _decode_kernels(gen, report, entries)
    _fused_layer_kernels(gen, report, entries, tail=False)
    _head_kernel(gen, report, entries)
    return done()


def _int4_kernels(gen, report, entries):
    """`int4_mlp` at the decoder MLP's widths (4096 -> 16384 -> 4096, gelu:
    0.5 byte a weight) at M = 1, 8 and 32 (32: the largest decode call), at
    the xattn FF's (the same widths) at M = 8 and at falcon7b's 4544 ->
    18176 -> 4544 at M = 8 (K % 128 != 0; 142 CTAs, beyond the 132 SMs),
    and `int4_matmul` at MPT-7B's qkv and out-proj widths (M = 1, 8, 32),
    against their plain versions, with device times and two calls compared
    bit for bit. Enough weight sets in turn that the timed reads come from
    device memory and not from the 50 MB L2 (67 MB a set at MPT's widths,
    41 MB at falcon7b's). No single PyTorch call computes `int4_mlp`;
    `int4_matmul`'s library call is `torch._weight_int4pack_mm` where the
    card's torch has a CUDA kernel for it (`_int4pack`: the weight
    converted once, outside the timed calls)."""
    import torch
    from otter_tpu_torch.ops import quant
    k_in = 4096
    cases = (("M=1", 4096, 16384, 1, 2), ("M=8", 4096, 16384, 8, 2),
             ("M=32", 4096, 16384, 32, 2),
             ("xattn ff M=8", 4096, 16384, 8, 2),
             ("falcon7b M=8", 4544, 18176, 8, 3))
    int4_sets = {}
    for case, k, hid, m, copies in cases:
        if (k, hid) not in int4_sets:
            int4_sets.clear()
            int4_sets[(k, hid)] = [
                quant.quantize_kernel_int4(0.02 * torch.randn(
                    k, hid, generator=gen, device="cuda"), 0)
                + quant.quantize_kernel_int4(0.02 * torch.randn(
                    hid, k, generator=gen, device="cuda"), 1)
                for _ in range(copies)]
        sets = int4_sets[(k, hid)]
        x = torch.randn(m, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        out = quant.int4_mlp(x, *sets[0])
        ref = quant.int4_mlp_plain(x, *sets[0])
        torch.cuda.synchronize()
        err, excess = max_err(out, ref)
        if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                lambda: quant.int4_mlp(x, *sets[0]), out):
            excess = float("inf")
        it = iter(range(10 ** 9))

        def call():
            return quant.int4_mlp(x, *sets[next(it) % copies])

        nbytes = k * hid + 4 * (hid + k) + 2 * 2 * m * k
        r = report("int4_mlp", case, err, excess, time_ms(call),
                   time_ms(lambda: quant.int4_mlp_plain(
                       x, *sets[next(it) % copies]), 5), None,
                   nbytes, 2.0 * m * 2 * k * hid,
                   device=(device_ms(call), None))
        # the main kernel, and the sum of its partial outputs (a dependent
        # launch: its span starts early, at the main kernel's phase 2)
        subs = _kernel_device_ms(call, 2)
        log("    its kernels, device ms a call (torch.profiler, 20 calls): "
            + ", ".join(f"{n} {t:.4f}" for n, t in subs.items()))
        r["sub_kernels_device_ms"] = subs
        if case == "M=8":
            entries["int4_mlp"] = r
    del int4_sets

    has_lib = _has_cuda_kernel("aten::_weight_int4pack_mm")
    for case, n_out, copies in (("qkv", 3 * k_in, 3), ("out_proj", k_in, 8)):
        sets = [quant.quantize_kernel_int4(0.02 * torch.randn(
            k_in, n_out, generator=gen, device="cuda"), 0)
            for _ in range(copies)]
        lib_sets = [_int4pack(wp, sc) for wp, sc in sets] if has_lib \
            else None
        for m in (1, 8, 32):
            x = torch.randn(m, k_in, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            out = quant.int4_matmul(x, *sets[0])
            ref = quant.int4_matmul_plain(x, *sets[0])
            torch.cuda.synchronize()
            err, excess = max_err(out, ref)
            if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                    lambda: quant.int4_matmul(x, *sets[0]), out):
                excess = float("inf")
            it = iter(range(10 ** 9))

            def call():
                return quant.int4_matmul(x, *sets[next(it) % copies])

            lib_ms = lib_dev = None
            if lib_sets is not None:
                def lib():
                    wpk, sz = lib_sets[next(it) % copies]
                    return torch._weight_int4pack_mm(x, wpk, 128, sz)

                try:
                    lib_err = max_err(torch._weight_int4pack_mm(
                        x, lib_sets[0][0], 128, lib_sets[0][1]), ref)[0]
                    lib_ms, lib_dev = time_ms(lib), device_ms(lib)
                    log(f"    library: group size 128, the column's scale "
                        f"rounded to bf16 in every group, zero points 0; "
                        f"max |err| against the plain version "
                        f"{lib_err:.3e}")
                except RuntimeError as e:   # a shape the op refuses
                    log(f"    library call refused: {e}")
            nbytes = k_in * n_out // 2 + 4 * n_out + 2 * m * (k_in + n_out)
            r = report("int4_matmul", f"{case} M={m}", err, excess,
                       time_ms(call),
                       time_ms(lambda: quant.int4_matmul_plain(
                           x, *sets[next(it) % copies]), 5), lib_ms,
                       nbytes, 2.0 * m * k_in * n_out,
                       device=(device_ms(call), lib_dev))
            subs = _kernel_device_ms(call, 2)
            log("    its kernels, device ms a call (torch.profiler, 20 "
                "calls): " + ", ".join(f"{n} {t:.4f}" for n, t in subs.items()))
            r["sub_kernels_device_ms"] = subs
            if (case, m) == ("qkv", 8):
                entries["int4_matmul"] = r
        del sets, lib_sets


def _int4pack(wp, scale):
    """`wp` (pack_axis 0, values in [-7, 7]) and its f32 per-column scale
    as `torch._weight_int4pack_mm` takes them: unsigned nibbles q = v + 8
    of W^T [N, K], two a byte along K (even k in the high nibble), tiled
    by `torch._convert_weight_to_int4pack`, and a [K / 128, N, 2] bf16
    table of (scale, zero point 0) for groups of 128 rows; the op
    computes x @ ((q - 8) * scale + 0)."""
    import torch
    from otter_tpu_torch.ops import quant
    q = (quant.unpack_int4(wp, 0).t().to(torch.int32) + 8)
    packed = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8).contiguous()
    k, n = 2 * wp.shape[0], wp.shape[1]
    sz = torch.zeros(k // 128, n, 2, dtype=torch.bfloat16, device=wp.device)
    sz[:, :, 0] = scale.to(torch.bfloat16)
    return torch._convert_weight_to_int4pack(packed, 8), sz


def _decode_cases(gen):
    """(name, q, cache kind, starts, lengths, bias, stacked-cache shape) of
    the decode-attention cases: MPT's serving cache (b=8, 32 heads of 128,
    L=256; bf16, int8, int4), its long cache (L=2048; int8, int4) and
    OtterHD's full-HD decode (b=1, 64 heads of 64, int8, L=2432 with a span
    of 2372, 36 layers). A case of fewer layers than its model keeps enough
    of them to exceed the 50 MB L2 when each launch reads another layer."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    dev = "cuda"

    def alibi(h, L):
        return (torch.arange(L, device=dev)[None, None, :]
                * alibi_slopes(h, device=dev)[None, :, None])

    i32 = lambda x: torch.tensor(x, device=dev, dtype=torch.int32)
    mpt_starts = i32([0, 10, 37, 96, 0, 5, 64, 100])
    mpt_q = torch.randn(8, 32, 128, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    short = i32([160, 150, 141, 129, 200, 133, 170, 190])
    long = i32([2048, 1900, 1500, 1029, 2000, 1333, 1700, 1990])
    cases = [(f"{c} cache", mpt_q, c, mpt_starts, short, alibi(32, 256),
              (8, 32, 32, 256, 128)) for c in ("bf16", "int8", "int4")]
    cases += [(f"{c} cache L=2048", mpt_q, c, mpt_starts, long,
               alibi(32, 2048), (8, 8, 32, 2048, 128))
              for c in ("int8", "int4")]
    # the beam phase's: MPT-7B at 4 beams of 8 requests (32 rows; every
    # slot below the position is attended, the padding too), and
    # OTTER-Video-LLaMA7B at 3 beams (rotary: no bias; 64 + 32 tokens in a
    # cache of 128)
    cases.append(("int8 cache b=32 (MPT beams)",
                  torch.randn(32, 32, 128, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  "int8", torch.zeros(32, device=dev, dtype=torch.int32),
                  short.repeat_interleave(4), alibi(32, 256),
                  (32, 8, 32, 256, 128)))
    cases.append(("int8 cache b=3 L=128 (video beams)",
                  torch.randn(3, 32, 128, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  "int8", i32([0, 0, 0]), i32([80, 80, 80]), None,
                  (3, 32, 32, 128, 128)))
    # idefics-9b's serving cache: b=8, 32 heads of 128, rotary (no bias),
    # prompts of 32-128 tokens left-padded to 128 and 32 new, L=256
    cases.append(("idefics int8 b=8 L=256",
                  torch.randn(8, 32, 128, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  "int8", i32([0, 28, 51, 96, 0, 64, 83, 38]),
                  i32([160] * 8), None, (8, 32, 32, 256, 128)))
    # Flamingo-MPT-1B, the speculative draft: 16 heads of 128, 24 layers,
    # ALiBi; alone at b=1 (cache 256: 128 prompt columns and 32 new, with
    # the round's room), and in 8 slots of a cache of 2048
    cases.append(("mpt1b int8 b=1 L=256",
                  torch.randn(1, 16, 128, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  "int8", i32([0]), i32([170]), alibi(16, 256),
                  (1, 24, 16, 256, 128)))
    cases.append(("mpt1b int8 b=8 L=2048",
                  torch.randn(8, 16, 128, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  "int8", i32([0, 24, 51, 60, 0, 64, 83, 38]),
                  i32([160, 150, 141, 129, 200, 133, 170, 190]),
                  alibi(16, 2048), (8, 24, 16, 2048, 128)))
    # Persimmon is rotary: no bias; the cache holds the 2356-token prompt
    # and 16 new tokens, rounded up to a multiple of 128
    cases.append(("otterhd int8 b=1 L=2432",
                  torch.randn(1, 64, 64, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  "int8", i32([0]), i32([2372]), None, (1, 36, 64, 2432, 64)))
    return cases


def _decode_kernels(gen, report, entries):
    """`decode_attention` against its plain version at every case of
    `_decode_cases`; device times (`device_ms`) beside SDPA's over a bf16
    cache of the same shape, the library call for the bf16 cache (no single
    PyTorch call reads an int8 or int4 cache: for those SDPA's bf16 time is
    printed for information, and library_ms is none)."""
    import torch
    import torch.nn.functional as F
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import quant

    log("kernels: decode_attention (split over the cache); tolerance "
        "|err| <= 2e-2*min(1, max|plain| of the (batch, head) row) + "
        "2e-2*|plain|; each timed launch reads another layer; device = "
        "CUDA events around 10 calls behind a spin kernel")
    for case, q, cache, starts, lengths, bias, shape in _decode_cases(gen):
        b, nl, h, L, d = shape
        kw = dict(starts=starts, sm_scale=d ** -0.5)
        if cache == "int4":
            kv, ks, vs = quant.quantize_kv_int4(*(
                torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2)))
            k = v = kv
            kw.update(k_scale=ks, v_scale=vs, kv_bits=4)
        else:
            k, v = (torch.randn(shape, generator=gen, device="cuda",
                                dtype=torch.bfloat16) for _ in range(2))
            if cache == "int8":
                (k, ks), (v, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
                kw.update(k_scale=ks, v_scale=vs)
        layer = nl // 2
        out = da.decode_attention(q, k, v, lengths, bias, layer=layer, **kw)
        again = da.decode_attention(q, k, v, lengths, bias, layer=layer, **kw)
        ref = da.decode_attention_plain(q, k, v, lengths, bias, layer=layer,
                                        **kw)
        torch.cuda.synchronize()
        err, excess = max_err(out, ref, per_row=True)
        if not torch.equal(out, again):
            log(f"  decode_attention[{case}]: two calls differ")
            excess = float("inf")
        it = iter(range(10 ** 9))
        kern = lambda: da.decode_attention(q, k, v, lengths, bias,
                                           layer=next(it) % nl, **kw)
        plain = lambda: da.decode_attention_plain(q, k, v, lengths, bias,
                                                  layer=next(it) % nl, **kw)
        # SDPA over a bf16 cache of this shape with the same span and bias
        kb = k if cache == "bf16" else torch.randn(
            shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        vb = v if cache == "bf16" else kb
        pos = torch.arange(L, device="cuda")
        ok = (pos[None, :] >= starts[:, None]) & (pos[None, :] < lengths[:, None])
        m = (torch.zeros(b, h, L, device="cuda") if bias is None
             else bias.expand(b, h, L)).masked_fill(
            ~ok[:, None, :], float("-inf"))[:, :, None, :].to(q.dtype)
        lib = lambda: (lambda li: F.scaled_dot_product_attention(
            q[:, :, None], kb[:, li], vb[:, li], attn_mask=m,
            scale=d ** -0.5))(next(it) % nl)
        lib_ms, lib_dev = time_ms(lib), device_ms(lib)
        rows = int((lengths - starts).sum()) * h
        # k and v bytes a position, its two scales, the bias row, q and out
        kv_bytes = {"bf16": 2 * 2 * d, "int8": 2 * d, "int4": d}[cache]
        nbytes = (rows * kv_bytes + (2 * 4 * rows if cache != "bf16" else 0)
                  + (4 * h * L if bias is not None else 0) + 2 * 2 * b * h * d
                  + 2 * 4 * b)
        same = cache == "bf16"   # SDPA computes this function
        r = report("decode_attention", case, err, excess, time_ms(kern),
                   time_ms(plain, 5), lib_ms if same else None,
                   nbytes, 4.0 * rows * d,
                   device=(device_ms(kern), lib_dev if same else None))
        if not same:
            log(f"    (SDPA over a bf16 cache of this shape: wall {lib_ms:.4f}"
                f" ms, device {lib_dev:.4f} ms, for information)")
        if case == "int8 cache":
            entries["decode_attention"] = r
        if case == "int4 cache":
            entries["decode_attention_int4"] = r
        del k, v, kb, vb, kw


def _has_cuda_kernel(op: str) -> bool:
    """Whether the card's torch has a CUDA kernel for the aten `op` (a
    yardstick's library call; the port never calls one)."""
    import torch
    has = torch._C._dispatch_has_kernel_for_dispatch_key(op, "CUDA")
    log(f"  library: {op} has {'a' if has else 'no'} CUDA kernel in torch "
        f"{torch.__version__}")
    return has


def _head_kernel(gen, report, entries):
    """`int8_matmul` against its plain version at the two untied heads that
    reach it (K = 4096; N = 32002, LLaMA-2 with its two added tokens, whose
    rows are not 16-byte aligned, and N = 262144, Fuyu) and at a small odd
    shape (a view at shift 7), each with its device time and two calls
    compared bit for bit. The 131 MB head comes in two copies used in turn,
    so that the timed reads come from device memory and not from the 50 MB
    L2; the 1.07 GB head exceeds it alone. The library call is
    `torch._weight_int8pack_mm` (x @ W^T * scale with W int8 [N, K] and a
    bf16 scale) where the card's torch has a CUDA kernel for it: the weight
    is transposed once, outside the timed calls. Beside it, for
    information, the time of what the kernel replaces in the model:
    `Int8Dense`'s composed product (convert to bf16, cuBLAS, scale)."""
    import torch
    from otter_tpu_torch.ops import quant
    k_in = 4096

    def head(n_out):
        # quantized in column slices: an f32 copy of the 1.07 G weights and
        # its temporaries would take tens of GB
        wq = torch.empty(k_in, n_out, dtype=torch.int8, device="cuda")
        sc = torch.empty(n_out, dtype=torch.float32, device="cuda")
        for j in range(0, n_out, 32768):
            q, s1 = quant.quantize_kernel(0.02 * torch.randn(
                k_in, min(32768, n_out - j), generator=gen, device="cuda"))
            wq[:, j:j + q.shape[1]], sc[j:j + q.shape[1]] = q, s1
        return wq, sc

    def composed(x, wq, sc):
        return (x @ wq.to(torch.bfloat16)) * sc.to(torch.bfloat16)

    has_lib = _has_cuda_kernel("aten::_weight_int8pack_mm")

    for case, n_out, copies, ms_ in (("llama head N=32002", 32002, 2,
                                      (1, 8, 32)),
                                     ("video-llama head N=32004", 32004, 2,
                                      (3,)),
                                     ("fuyu head N=262144", 262144, 1,
                                      (1, 8)),
                                     ("odd N=130", 130, 1, (3,))):
        sets = [head(n_out) for _ in range(copies)]
        k_here = k_in
        if n_out == 130:   # a view into a wider weight: stride 141, shift 7
            k_here = 256
            wide, sc = sets[0]
            wide = torch.cat([wide[:k_here], wide[:k_here, :11]], dim=1)
            sets = [(wide[:, 7:137], sc)]
        lib_sets = [(w.t().contiguous(), sc.to(torch.bfloat16))
                    for w, sc in sets] if has_lib else None
        for m in ms_:
            x = torch.randn(m, k_here, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            out = quant.int8_matmul(x, *sets[0])
            ref = quant.int8_matmul_plain(x, *sets[0])
            torch.cuda.synchronize()
            err, excess = max_err(out, ref)
            if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                    lambda: quant.int8_matmul(x, *sets[0]), out):
                excess = float("inf")
            it = iter(range(10 ** 9))

            def call():
                return quant.int8_matmul(x, *sets[next(it) % copies])

            lib_ms = lib_dev = None
            if lib_sets is not None:
                def lib():
                    return torch._weight_int8pack_mm(
                        x, *lib_sets[next(it) % copies])

                try:
                    lib_ms, lib_dev = time_ms(lib), device_ms(lib)
                except RuntimeError as e:   # a shape the op refuses
                    log(f"    library call refused: {e}")
            nbytes = k_here * n_out + 4 * n_out + 2 * m * (k_here + n_out)
            r = report("int8_matmul", f"{case} M={m}", err, excess,
                       time_ms(call),
                       time_ms(lambda: quant.int8_matmul_plain(
                           x, *sets[next(it) % copies]), 3, 1), lib_ms,
                       nbytes, 2.0 * m * k_here * n_out,
                       device=(device_ms(call), lib_dev))
            composed_ms = time_ms(
                lambda: composed(x, *sets[next(it) % copies]), 5, 1)
            log(f"    Int8Dense's composed product on the same tensors: "
                f"{composed_ms:.4f} ms")
            if (n_out, m) == (32002, 8):
                entries["int8_matmul"] = r
        del sets


def _qk(gen, rows, cols):
    import torch
    from otter_tpu_torch.ops import quant
    return quant.quantize_kernel(0.02 * torch.randn(
        rows, cols, generator=gen, device="cuda"))


def _bits_repeat(fn, out) -> bool:
    import torch
    again = fn()
    torch.cuda.synchronize()
    same = torch.equal(out, again)
    if not same:
        log("  two calls differ: the sums' order is not fixed")
    return same


def _mlp_kernels(gen, report, entries):
    """`int8_mlp` alone, then `int8_attn_tail` alone (`_tail_kernels`),
    against their plain versions, with device times: the decoder MLP 4096
    -> 16384 -> 4096 (gelu) at M = 1, 8 and 32 and at M = 5 (the verify
    window of a speculative round at gamma 4, b=1), OtterHD's (biases,
    sq_relu) at M = 1, falcon7b's 4544 -> 18176 -> 4544 at M = 8,
    Flamingo-MPT-1B's 2048 -> 8192 -> 2048 (the draft's MLPs and xattn FFs)
    at M = 1, 2 (its opener at b=1), 5 and 16 (its opener at 8 slots). A
    7B call reads 134-165 MB of weights, more than the 50 MB L2, so one
    weight set serves; a 1B call reads 33.6 MB, so its timed calls go
    round four weight sets. No single PyTorch call computes it: library
    "none"."""
    import torch
    from otter_tpu_torch.ops import quant
    cases = (("M=1", 4096, 16384, 1, "gelu", False),
             ("M=8", 4096, 16384, 8, "gelu", False),
             ("M=32", 4096, 16384, 32, "gelu", False),
             ("M=5 (verify window)", 4096, 16384, 5, "gelu", False),
             ("otterhd M=1 biases sq_relu", 4096, 16384, 1, "sq_relu", True),
             ("falcon7b M=8", 4544, 18176, 8, "gelu", False),
             ("mpt1b M=1", 2048, 8192, 1, "gelu", False),
             ("mpt1b M=2", 2048, 8192, 2, "gelu", False),
             ("mpt1b M=5", 2048, 8192, 5, "gelu", False),
             ("mpt1b M=16", 2048, 8192, 16, "gelu", False))
    weights = {}
    for case, k, h, m, act, biases in cases:
        if (k, h) not in weights:
            weights.clear()
            sets = 4 if 2 * k * h < 50e6 else 1
            weights[(k, h)] = [_qk(gen, k, h) + _qk(gen, h, k)
                               for _ in range(sets)]
        w1q, s1, w2q, s2 = weights[(k, h)][0]
        turn = iter(range(10 ** 9))
        kw = dict(act=act)
        if biases:
            kw.update(b1=0.1 * torch.randn(h, generator=gen, device="cuda"),
                      b2=0.1 * torch.randn(k, generator=gen, device="cuda"))
        x = torch.randn(m, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)

        def call():
            return quant.int8_mlp(x, w1q, s1, w2q, s2, **kw)

        def timed():   # the next weight set (the 1B cases' L2 rotation)
            ws = weights[(k, h)]
            return quant.int8_mlp(x, *ws[next(turn) % len(ws)], **kw)

        def plain():
            return quant.int8_mlp_plain(x, w1q, s1, w2q, s2, **kw)

        out, ref = call(), plain()
        torch.cuda.synchronize()
        err, excess = max_err(out, ref)
        if not _bits_repeat(call, out):
            excess = float("inf")
        nbytes = (2 * k * h + 4 * (h + k) * (2 if biases else 1)
                  + 2 * 2 * m * k)
        r = report("int8_mlp", case, err, excess, time_ms(timed),
                   time_ms(plain, 5), None, nbytes, 2.0 * m * 2 * k * h,
                   device=(device_ms(timed), None))
        if case == "M=8":
            entries["int8_mlp"] = r
    del weights
    _tail_kernels(gen, report, entries)


def _tail_kernels(gen, report, entries):
    """`int8_attn_tail` (out-proj + residual, norm_2, MLP + residual) against
    its plain version at MPT-7B's widths, M = 1, 8 and 32, two weight sets
    in turn (151 MB each), two calls compared bit for bit."""
    import torch
    from otter_tpu_torch.ops import quant
    d, hid = 4096, 16384
    tails = []
    for _ in range(2):
        (wo, so), (w1, s1), (w2, s2) = (_qk(gen, d, d), _qk(gen, d, hid),
                                        _qk(gen, hid, d))
        gain = 1 + 0.02 * torch.randn(d, generator=gen, device="cuda")
        tails.append((wo, so, gain, w1, s1, w2, s2))
    for m in (1, 8, 32):
        a, r = (torch.randn(m, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out = quant.int8_attn_tail(a, r, *tails[0])
        ref, mlp = quant.int8_attn_tail_plain(a, r, *tails[0],
                                              return_mlp=True)
        torch.cuda.synchronize()
        # the function rounds its MLP output (|~50| at these widths) to
        # bf16 before the residual, which may cancel it: one bf16 step of
        # that output, 2^-7 |mlp|, is allowed beside the tolerance
        err, excess = max_err(out, ref, slack=2.0 ** -7 * mlp.float().abs())
        if not bool(torch.isfinite(out.float()).all()) or not _bits_repeat(
                lambda: quant.int8_attn_tail(a, r, *tails[0]), out):
            excess = float("inf")
        it = iter(range(10 ** 9))

        def call():
            return quant.int8_attn_tail(a, r, *tails[next(it) % 2])

        nbytes = (d * d + 2 * d * hid) + 4 * (3 * d + hid) + 2 * 3 * m * d
        res = report("int8_attn_tail", f"M={m}", err, excess, time_ms(call),
                     time_ms(lambda: quant.int8_attn_tail_plain(
                         a, r, *tails[next(it) % 2]), 5), None, nbytes,
                     2.0 * m * (d * d + 2 * d * hid),
                     device=(device_ms(call), None))
        if m == 8:
            entries["int8_attn_tail"] = res
    del tails


# the kernels one `decode_attn_megakernel` call launches: row norm, qkv
# product, attention, Wo product, sum of the partials
MEGAKERNEL_KERNELS = 5
# the megakernel's device ms a call at b=8 over a cache of 256 by position
# when it took the position by value (an earlier H100 run, PERF.md's kernel
# table), printed beside this run's
BY_VALUE_MEGAKERNEL_MS = {255: 0.0558, 57: 0.0452, 0: 0.0425}


def megakernel_bytes(b: int, pos: int, d: int = 4096, h: int = 32,
                     dh: int = 128) -> int:
    """Bytes a megakernel call must move: wqo (int8) and its scales, ln1,
    the cache rows below pos (bf16 k and v), the bias columns up to pos,
    the position, x in and y, k_new, v_new out (bf16)."""
    return (4 * d * d + 4 * 4 * d + 4 * d + 2 * 2 * b * h * pos * dh
            + 4 * h * (pos + 1) + 4 + 2 * 4 * b * d)


def megakernel_flops(b: int, pos: int, d: int = 4096, h: int = 32,
                     dh: int = 128) -> float:
    return 2.0 * b * 4 * d * d + 4.0 * b * h * pos * dh


def _fused_layer_kernels(gen, report, entries, tail: bool = True):
    """`int8_attn_tail` (with `tail`; `_tail_kernels`) and
    `decode_attn_megakernel` against their plain versions at MPT-7B's
    widths (D=4096, H=16384, 32 heads of 128): the megakernel at b = 1 and
    8, pos 0, 57 and 255 of a cache of 256 and pos 2047 of 2048 (the
    position a device int32 that the kernel reads), with two calls
    compared bit for bit, its device time and, at b=8 pos 255, the device
    time of each of its kernels (torch.profiler); then one call captured
    as a CUDA graph at pos 0 and replayed after the position counter moves
    (b=8, cache 256), each replay held to the plain version at its own
    position, with its device time. Two weight sets in turn (and another
    cache layer each launch), so that the timed reads come from device
    memory and not from the 50 MB L2. No single PyTorch call computes
    either: library "none"."""
    import torch
    from otter_tpu_torch import _build
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import megakernel as mk
    from otter_tpu_torch.ops.masks import alibi_slopes
    d, h, dh = 4096, 32, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def gain():
        return 1 + 0.02 * torch.randn(d, generator=gen, device="cuda")

    def worst(outs, refs):
        pairs = [max_err(o, r) for o, r in zip(outs, refs)]
        finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
        return (max(e for e, _ in pairs),
                max(x for _, x in pairs) if finite else float("inf"))

    if tail:
        _tail_kernels(gen, report, entries)

    # the attention half: norm_1, qkv, cached attention, out-proj + residual
    wqos = []
    for _ in range(2):
        (wqkv, sqkv), (wo, so) = _qk(gen, d, 3 * d), _qk(gen, d, d)
        wqos.append((gain(), torch.cat([wqkv, wo], dim=1).contiguous(),
                     torch.cat([sqkv, so])))
        del wqkv, wo
    cases_256 = tuple((b, pos) for b in (8, 1) for pos in (0, 57, 255))
    for L, nl, cases in ((256, 4, cases_256), (2048, 2, ((8, 2047),
                                                          (1, 2047)))):
        bias = (torch.arange(L, device="cuda")[None, :]
                * alibi_slopes(h, device="cuda")[:, None]).float()
        kc, vc = rnd(8, nl, h, L, dh), rnd(8, nl, h, L, dh)
        for b, pos in cases:
            # rows at and past pos hold garbage the kernel must not read
            k, v = kc[:b].clone(), vc[:b].clone()
            k[:, :, :, pos:] = 1e4
            v[:, :, :, pos:] = 1e4
            x = rnd(b, d)
            layer = nl - 1
            pos_dev = torch.tensor(pos, dtype=torch.int32, device="cuda")

            def first():
                return mk.decode_attn_megakernel(x, k, v, pos_dev, bias,
                                                 *wqos[0], layer=layer)

            outs = first()
            refs = mk.decode_attn_megakernel_plain(x, k, v, pos, bias,
                                                   *wqos[0], layer=layer)
            torch.cuda.synchronize()
            err, excess = worst(outs, refs)
            again = first()
            torch.cuda.synchronize()
            if not all(torch.equal(o, a) for o, a in zip(outs, again)):
                log("  two calls differ: the sums' order is not fixed")
                excess = float("inf")
            it = iter(range(10 ** 9))

            def call(fn=mk.decode_attn_megakernel, p=pos_dev):
                i = next(it)
                return fn(x, k, v, p, bias, *wqos[i % 2], layer=i % nl)

            res = report("decode_attn_megakernel", f"b={b} L={L} pos={pos}",
                         err, excess, time_ms(call),
                         time_ms(lambda: call(
                             mk.decode_attn_megakernel_plain, pos), 5), None,
                         megakernel_bytes(b, pos), megakernel_flops(b, pos),
                         device=(device_ms(call), None))
            if (b, L, pos) == (8, 256, 255):
                subs = _kernel_device_ms(call, MEGAKERNEL_KERNELS)
                log("    its kernels, device ms a call (torch.profiler, 20 "
                    "calls): " + ", ".join(f"{n} {t:.4f}"
                                           for n, t in subs.items()))
                res["sub_kernels_device_ms"] = subs
                entries["decode_attn_megakernel"] = res
            del k, v
        del kc, vc

    # one graph, captured at pos 0 with a workspace of its own, replayed
    # after the position counter moves
    b, L, nl = 8, 256, 4
    bias = (torch.arange(L, device="cuda")[None, :]
            * alibi_slopes(h, device="cuda")[:, None]).float()
    kc, vc, x = rnd(b, nl, h, L, dh), rnd(b, nl, h, L, dh), rnd(b, d)
    pos_dev = torch.zeros((), dtype=torch.int32, device="cuda")
    fn = lambda: mk.decode_attn_megakernel(x, kc, vc, pos_dev, bias,
                                           *wqos[0], layer=nl - 1)
    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(main)
    graph, ws = torch.cuda.CUDAGraph(), da.Workspace()
    with torch.cuda.stream(side), da.owned_workspace(ws):
        fn()
        ws.frozen = True
        with _build.recording_launches() as launches:
            graph.capture_begin()
            outs = fn()
            graph.capture_end()
    main.wait_stream(side)
    if launches != {(mk.decode_attn_megakernel, False): 1}:
        raise RuntimeError(f"the megakernel's capture recorded {launches}")
    replayed = {}
    for pos in (57, 0, 255, 128):
        pos_dev.fill_(pos)
        graph.replay()
        refs = mk.decode_attn_megakernel_plain(x, kc, vc, pos, bias,
                                               *wqos[0], layer=nl - 1)
        torch.cuda.synchronize()
        err, excess = worst(outs, refs)
        res = report("decode_attn_megakernel",
                     f"graph b={b} L={L} replayed at pos={pos}", err, excess,
                     time_ms(graph.replay),
                     time_ms(lambda: mk.decode_attn_megakernel_plain(
                         x, kc, vc, pos, bias, *wqos[0], layer=nl - 1), 5),
                     None, megakernel_bytes(b, pos),
                     megakernel_flops(b, pos),
                     device=(device_ms(graph.replay), None))
        replayed[pos] = res["device_ms"]
    log("    the graph captured at pos 0, replayed at each position, "
        "device ms a replay: " + ", ".join(
            f"pos {p} {t:.4f} (the by-value kernel's eager call: "
            f"{BY_VALUE_MEGAKERNEL_MS[p]})"
            for p, t in replayed.items() if p in BY_VALUE_MEGAKERNEL_MS))
    graph.reset()


def _kernel_device_ms(fn, per_call: int, iters: int = 20,
                      tries: int = 3) -> dict:
    """{"i. kernel name": device ms a call of fn} for the i-th of the
    `per_call` kernels that one call of fn launches, from torch.profiler's
    CUDA activity over `iters` calls (kernel durations as the card timed
    them). Kernels that overlap (a programmatic dependent launch waiting on
    its predecessor) each count their whole span.

    The profiler keeps only the activity it places inside its window, and
    CUPTI may lose a record: a profile that holds other than `per_call` x
    `iters` kernels is discarded and taken again, at most `tries` times in
    all."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # margins, so that no kernel lies at an edge of the window
            time.sleep(0.01)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        kern = sorted((e for e in prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA),
                      key=lambda e: e.start_ns())
        if len(kern) == per_call * iters:
            break
        log(f"    profile {attempt} of {tries} holds {len(kern)} kernels "
            f"in {iters} calls of {per_call}: discarded")
    else:
        raise RuntimeError(f"{len(kern)} kernels in {iters} calls of "
                           f"{per_call}, {tries} profiles")
    times = {}
    for i, e in enumerate(kern):
        # "void (anonymous namespace)::name<128>(args)" -> "name<128>"
        name = (e.name().replace("(anonymous namespace)::", "")
                .replace("otter::", "").replace("void ", "")
                .split("(")[0].strip())
        key = f"{i % per_call + 1}. {name}"
        times[key] = times.get(key, 0.0) + e.duration_ns() / 1e6 / iters
    return times


# ── model construction ──────────────────────────────────────────────

def build_model(cfg):
    """Full-width OtterVLM on the card with random weights from SEED,
    quantized tensor by tensor on the card."""
    from otter_tpu_torch.tools.random_weights import build_model as build
    return build(cfg, DEV, SEED)


def random_params(cfg):
    """{flax path: tensor} of `cfg`'s random bf16 weights, made on the card
    when read, each from its own seed."""
    from otter_tpu_torch.tools import random_weights
    return random_weights.RandomParams(cfg, DEV, seed=SEED)


def _depth_cut(cfg):
    """Every width kept; 4 decoder layers, 1 xattn block, CLIP 2,
    perceiver 1."""
    return cfg.replace(
        text=cfg.text.replace(num_hidden_layers=4),
        vision=cfg.vision.replace(num_hidden_layers=2),
        perceiver=cfg.perceiver.replace(depth=1))


def train_cfg(depth_cut: bool = False):
    """OTTER-MPT7B with bf16 weights (no quantization), as SFT trains it."""
    from otter_tpu_torch.config import otter_mpt7b
    cfg = otter_mpt7b()
    return _depth_cut(cfg) if depth_cut else cfg


class SmokeTokenizer:
    """The special-token ids `sft.prepare_batch` asks for, as OTTER-MPT7B's
    tokenizer (GPT-NeoX vocabulary plus Otter's added tokens) numbers
    them: <answer> 50279 and <PAD> 50280 after <|endofchunk|> and
    <image>."""

    eos_token_id = 0       # <|endoftext|>

    def __init__(self, cfg):
        self.ids = {"<|endofchunk|>": cfg.eoc_token_id,
                    "<image>": cfg.media_token_id,
                    "<answer>": cfg.eoc_token_id + 2}
        self.pad_token_id = cfg.eoc_token_id + 3

    def convert_tokens_to_ids(self, token):
        return self.ids[token]


TRAIN_WORDS = 64   # distinct words in the trainer's synthetic texts


def write_tokenizer(directory: str, cfg) -> str:
    """An HF WordLevel tokenizer (`tokenizer.json` and
    `tokenizer_config.json`, written as JSON: no tokenizer library here)
    whose vocabulary fills ids 0 .. cfg.eoc_token_id - 1, so that the
    trainer's added tokens (`sft.load_tokenizer`: <|endofchunk|>, <image>,
    <answer>, then <PAD>) take the config's eoc and media ids and the two
    after them. Whitespace pre-tokenizer; <|endoftext|> (id 0) is bos and
    eos, as in GPT-NeoX's vocabulary."""
    n = cfg.eoc_token_id
    if cfg.media_token_id != n + 1:
        raise ValueError("the config's media id must follow its eoc id")
    words = ["<|endoftext|>", "<unk>", "User", "GPT", ":"]
    words += [f"w{i}" for i in range(n - len(words))]
    special = {"id": 0, "content": "<|endoftext|>", "single_word": False,
               "lstrip": False, "rstrip": False, "normalized": False,
               "special": True}
    tokenizer = {"version": "1.0", "truncation": None, "padding": None,
                 "added_tokens": [special], "normalizer": None,
                 "pre_tokenizer": {"type": "Whitespace"},
                 "post_processor": None, "decoder": None,
                 "model": {"type": "WordLevel",
                           "vocab": {w: i for i, w in enumerate(words)},
                           "unk_token": "<unk>"}}
    config = {"tokenizer_class": "PreTrainedTokenizerFast",
              "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
              "unk_token": "<unk>", "model_max_length": 2048}
    os.makedirs(directory, exist_ok=True)
    for name, obj in (("tokenizer.json", tokenizer),
                      ("tokenizer_config.json", config)):
        with open(os.path.join(directory, name), "w") as f:
            json.dump(obj, f)
    return directory


def write_train_data(directory: str, seed: int, n_single: int = 12,
                     n_context: int = 6, image_size: int = 256,
                     long: bool = True) -> str:
    """A MIMIC-IT data YAML (written as JSON, which YAML reads) over two
    task groups, and its files: IMAGE_TEXT, one random image and one
    instruction / answer pair a sample; IMAGE_TEXT_IN_CONTEXT, three
    in-context pairs (its train config) before the sample's own, four
    images. Texts are words of `write_tokenizer`'s vocabulary (one token a
    word): a sample runs 560-960 tokens with the template's, or 40-90 with
    `long=False`. Images are PNGs of `image_size` squared in one JSON
    pack. Returns the YAML's path."""
    import numpy as np
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    scale = 1 if long else 0.1
    pool = [f"IMG_{i}" for i in range(16)]
    images = {i: png_base64(rng.integers(0, 256, (image_size, image_size, 3),
                                         dtype=np.uint8)) for i in pool}
    words = [f"w{i}" for i in range(TRAIN_WORDS)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi) * scale)
                                   or 1))

    single = {f"S_{i}": {"instruction": text(250, 400),
                         "answer": text(300, 550),
                         "image_ids": [pool[i % len(pool)]]}
              for i in range(n_single)}
    context = {f"C_{i}": {"instruction": text(60, 110),
                          "answer": text(80, 130),
                          "image_ids": [str(x) for x in rng.choice(
                              pool, 4, replace=False)]}
               for i in range(n_context)}
    train_config = {k: [f"C_{(i + j) % n_context}" for j in (1, 2, 3)]
                    for i, k in enumerate(context)}
    files = {"images.json": images,
             "single.json": {"data": single},
             "context.json": {"data": context},
             "context_train.json": train_config}
    for name, obj in files.items():
        with open(os.path.join(directory, name), "w") as f:
            json.dump(obj, f)
    path = lambda name: os.path.join(os.path.abspath(directory), name)
    spec = {"IMAGE_TEXT": {"SMOKE_SINGLE": {
                "mimicit_path": path("single.json"),
                "images_path": path("images.json"), "num_samples": 0}},
            "IMAGE_TEXT_IN_CONTEXT": {"SMOKE_CONTEXT": {
                "mimicit_path": path("context.json"),
                "images_path": path("images.json"),
                "train_config_path": path("context_train.json"),
                "num_samples": 0}}}
    with open(path("data.yaml"), "w") as f:
        json.dump(spec, f)
    return path("data.yaml")


def make_train_batch(cfg, tok, seed: int, b: int = 2, s: int = 1024):
    """One collated batch in MimicitLoader's format (numpy): 3 text tokens,
    the media token, an instruction, <answer> at 400, the answer up to
    <|endofchunk|> and eos, right padding (lengths 1024 and 900), one
    224x224 image per sample."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.eoc_token_id, (b, s)).astype(np.int64)
    mask = np.zeros((b, s), np.int64)
    for i, n in enumerate([1024, 900][:b]):
        ids[i, 3] = cfg.media_token_id
        ids[i, 400] = tok.convert_tokens_to_ids("<answer>")
        ids[i, n - 2] = cfg.eoc_token_id
        ids[i, n - 1] = tok.eos_token_id
        ids[i, n:] = tok.pad_token_id
        mask[i, :n] = 1
    size = cfg.vision.image_size
    images = rng.standard_normal((b, 1, 1, 3, size, size)).astype(np.float32)
    return {"net_input": {"input_ids": ids, "attention_masks": mask,
                          "patch_images": images}}


def serving_cfg(depth_cut: bool = False, quant: str = "int8"):
    from otter_tpu_torch.config import otter_mpt7b
    cfg = otter_mpt7b()
    cfg = cfg.replace(text=cfg.text.replace(quant=quant,
                                            decode_kernel="auto"))
    return _depth_cut(cfg) if depth_cut else cfg


def llama_cfg(depth_cut: bool = False):
    """OTTER-LLaMA2-Chat-7B as the worker serves it with `--load-bit int8
    --cache-bit int8`."""
    from otter_tpu_torch.config import otter_llama2_chat7b
    cfg = otter_llama2_chat7b()
    cfg = cfg.replace(text=cfg.text.replace(quant="int8",
                                            decode_kernel="auto"))
    return _depth_cut(cfg) if depth_cut else cfg


def otterhd_cfg(depth_cut: bool = False):
    """OtterHD-8B (Fuyu) with int8 weights and the int8 embedding table."""
    from otter_tpu_torch.config import FuyuConfig
    cfg = FuyuConfig()
    text = cfg.text.replace(quant="int8", quant_embed=True,
                            decode_kernel="auto")
    if depth_cut:
        text = text.replace(num_hidden_layers=4)
    return cfg.replace(text=text)


def video_cfg(depth_cut: bool = False):
    """OTTER-Video-LLaMA7B (frame embeddings for 128 frames, an untied head
    of 32004 rows) with int8 weights, served with an int8 KV cache."""
    from otter_tpu_torch.config import otter_llama7b_video
    cfg = otter_llama7b_video()
    cfg = cfg.replace(text=cfg.text.replace(quant="int8",
                                            decode_kernel="auto"))
    return _depth_cut(cfg) if depth_cut else cfg


def video_request(cfg, seed: int, frames: int = 16, prompt: int = 64):
    """One still and one `frames`-frame video as host-decoded uint8 pixels
    [1, 2, F, 224, 224, 3] (the still's frames 1.. are zero padding), their
    frame mask [1, 2, F] and a `prompt`-token prompt holding the two media
    tokens (numpy)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    pixels = rng.integers(0, 256, (1, 2, frames, size, size, 3)).astype(
        np.uint8)
    pixels[0, 0, 1:] = 0
    mask = np.ones((1, 2, frames), bool)
    mask[0, 0, 1:] = False
    ids = rng.integers(1, cfg.text.vocab_size, (1, prompt)).astype(np.int64)
    ids[0, [0, prompt // 3]] = cfg.media_token_id
    return pixels, mask, ids


def make_requests(cfg, batch: int, seed: int, full: bool = False):
    """Ragged 32-128-token prompts (`full`: all 128 tokens long), each
    starting with the media token, left-padded to 128, with one 224x224
    image each (numpy)."""
    import numpy as np
    from otter_tpu_torch.generation.engine import left_pad
    rng = np.random.default_rng(seed)
    p = 128
    lens = rng.integers(32, p + 1, batch)
    if full:
        lens[:] = p
    ids = rng.integers(0, cfg.eoc_token_id, (batch, p)).astype(np.int64)
    ids[:, 0] = cfg.media_token_id
    mask = (np.arange(p)[None, :] < lens[:, None]).astype(np.int32)
    lang_x, attn = left_pad(ids, mask, target_len=p)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal((batch, 1, 1, 3, size, size)
                                   ).astype(np.float32)
    return vision_x, lang_x, attn


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper for its plain version at the call sites."""
    from otter_tpu_torch.ops import decode_attention as da
    from otter_tpu_torch.ops import flash_attention as fa
    from otter_tpu_torch.ops import megakernel as mk
    from otter_tpu_torch.ops import quant
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd,
             quant.int8_mlp, quant.int4_mlp, quant.int4_matmul,
             da.decode_attention, mk.decode_attn_megakernel,
             quant.int8_attn_tail, quant.int8_matmul)
    fa.flash_attention_fwd = fa.flash_attention_plain
    fa.flash_attention_bwd = fa.flash_attention_bwd_plain
    quant.int8_mlp = quant.int8_mlp_plain
    quant.int4_mlp = quant.int4_mlp_plain
    quant.int4_matmul = quant.int4_matmul_plain
    da.decode_attention = da.decode_attention_plain
    mk.decode_attn_megakernel = mk.decode_attn_megakernel_plain
    quant.int8_attn_tail = quant.int8_attn_tail_plain
    quant.int8_matmul = quant.int8_matmul_plain
    try:
        yield
    finally:
        (fa.flash_attention_fwd, fa.flash_attention_bwd, quant.int8_mlp,
         quant.int4_mlp, quant.int4_matmul, da.decode_attention,
         mk.decode_attn_megakernel, quant.int8_attn_tail,
         quant.int8_matmul) = saved


# ── phase 4: kernel path against the plain path ─────────────────────

def first_step_logits(model, cfg, cache_dtype, vision_x, lang_x, attn):
    import torch
    from otter_tpu_torch.models.decoder import init_cache
    with torch.inference_mode():
        dev = model.device
        vx = torch.from_numpy(vision_x).to(dev)
        ids = torch.from_numpy(lang_x).to(dev)
        mask = torch.from_numpy(attn).to(dev)
        b, p = ids.shape
        cache = init_cache(cfg.text, b, 256, cache_dtype, dev)
        # positions count real tokens (rope models; ALiBi ignores them)
        real_len = mask.sum(-1)
        logits0, cache, lat = model(
            vx, ids, attention_mask=mask, cache=cache, head_last_only=True,
            positions=(mask.cumsum(-1) - 1).clamp_min(0))
        tok = torch.full((b, 1), cfg.text.vocab_size // 2, device=dev)
        kv_valid = torch.zeros((b, 256), dtype=torch.bool, device=dev)
        kv_valid[:, :p] = mask.bool()
        kv_valid[:, p] = True
        media = (ids == cfg.media_token_id).int().sum(-1)
        logits1, _, _ = model(None, tok, vis_latents=lat, cache=cache,
                              cache_pos=p, kv_valid=kv_valid,
                              positions=real_len[:, None],
                              media_counts=media)
        return logits0[:, -1].float(), logits1[:, -1].float()


def fuyu_first_step_logits(model, cfg, ids, patches, idx, mask):
    """The same for a FuyuVLM: the last prompt position's logits with the
    image patches merged, then one cached step."""
    import torch
    from otter_tpu_torch.models.fuyu import make_fuyu_cache
    with torch.inference_mode():
        dev = model.device
        ids, idx, mask = (torch.from_numpy(a).to(dev) for a in
                          (ids, idx, mask))
        patches = torch.from_numpy(patches).to(dev).to(model.dtype)
        b, s = ids.shape
        cache = make_fuyu_cache(cfg, b, 384, torch.int8, dev)
        logits0, cache = model(
            ids, image_patches=patches, image_patches_indices=idx,
            attention_mask=mask, cache=cache, head_last_only=True,
            positions=(mask.cumsum(-1) - 1).clamp_min(0))
        kv_valid = torch.zeros((b, 384), dtype=torch.bool, device=dev)
        kv_valid[:, :s] = mask.bool()
        kv_valid[:, s] = True
        tok = torch.full((b, 1), cfg.text.vocab_size // 2, device=dev)
        logits1, _ = model(tok, cache=cache, cache_pos=s, kv_valid=kv_valid,
                           positions=mask.sum(-1)[:, None])
        return logits0[:, -1].float(), logits1[:, -1].float()


def _hold_logits(tag: str, kern, plain):
    """Prefill and first-step logits, kernel path against plain path."""
    import torch
    for name, a, r in zip(("prefill", "decode step 1"), kern, plain):
        err = float((a - r).abs().max())
        scale = float(r.abs().max())
        ok = torch.isfinite(a).all() and err <= 5e-2 * scale
        log(f"parity[{tag}, {name}]: logits "
            f"max_abs_err {err:.4e} vs max|plain| {scale:.4e} "
            f"(tolerance 5e-2 * max|plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{tag}: kernel path disagrees with the "
                               f"plain path at the {name} logits")


def phase_parity():
    import torch
    for quant, cache_dtype in (("int8", torch.int8), ("int4", "int4")):
        cfg = serving_cfg(depth_cut=True, quant=quant)
        model = build_model(cfg)
        req = make_requests(cfg, 8, SEED + 1)
        kern = first_step_logits(model, cfg, cache_dtype, *req)
        with plain_kernels():
            plain = first_step_logits(model, cfg, cache_dtype, *req)
        _hold_logits(f"{quant} weights and cache", kern, plain)
        del model

    # the rope models with untied int8 heads: the decode step's logits come
    # out of int8_matmul
    from otter_tpu_torch.ops import quant as quant_ops
    from otter_tpu_torch.tools.random_weights import fuyu_request
    cfg = llama_cfg(depth_cut=True)
    model = build_model(cfg)
    req = make_requests(cfg, 8, SEED + 3)
    before = quant_ops.int8_matmul.launches
    kern = first_step_logits(model, cfg, torch.int8, *req)
    with plain_kernels():
        plain = first_step_logits(model, cfg, torch.int8, *req)
    _hold_logits("llama2-chat-7b, int8 weights and cache", kern, plain)
    del model
    cfg = otterhd_cfg(depth_cut=True)
    model = build_model(cfg)
    req = fuyu_request(cfg, 448, 448, 16, SEED + 4, left_pad=8)
    kern = fuyu_first_step_logits(model, cfg, *req)
    with plain_kernels():
        plain = fuyu_first_step_logits(model, cfg, *req)
    _hold_logits("otterhd-8b, int8 weights, embedding and cache", kern, plain)
    del model
    if quant_ops.int8_matmul.launches != before + 2:
        raise RuntimeError("parity: the two untied heads did not go through "
                           "int8_matmul once each")
    # idefics-9b: int8 decoder layers, bf16 head, xattn and towers
    cfg = idefics_cfg(depth_cut=True)
    model = build_model(cfg)
    req = idefics_requests(cfg, 8, SEED + 5)
    kern = first_step_logits(model, cfg, torch.int8, *req)
    with plain_kernels():
        plain = first_step_logits(model, cfg, torch.int8, *req)
    _hold_logits("idefics-9b, int8 decoder and cache", kern, plain)
    del model

    # the fused decode routes, on full-length prompts (the megakernel
    # attends every cache row below the position: no left padding):
    # kernels against plain, and against the composed route of the same
    # weights (same seed), whose first cached step is the reference
    cfg = serving_cfg(depth_cut=True)
    req = make_requests(cfg, 8, SEED + 2, full=True)
    composed = {}
    for route, cache_dtype in (("megakernel", torch.bfloat16),
                               ("fused_tail", torch.int8)):
        if cache_dtype not in composed:
            model = build_model(cfg)
            composed[cache_dtype] = first_step_logits(model, cfg, cache_dtype,
                                                      *req)
            del model
        rcfg = cfg.replace(text=cfg.text.replace(**{route: True}))
        model = build_model(rcfg)
        kern = first_step_logits(model, rcfg, cache_dtype, *req)
        with plain_kernels():
            plain = first_step_logits(model, rcfg, cache_dtype, *req)
        for against, ref in (("plain", plain),
                             ("composed", composed[cache_dtype])):
            err = float((kern[1] - ref[1]).abs().max())
            scale = float(ref[1].abs().max())
            ok = torch.isfinite(kern[1]).all() and err <= 5e-2 * scale
            log(f"parity[{route}, decode step 1, kernels vs {against}]: "
                f"logits max_abs_err {err:.4e} vs max|{against}| "
                f"{scale:.4e} (tolerance 5e-2 * max|{against}|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{route}: kernel path disagrees with the "
                                   f"{against} path at the first cached step")
        del model


# ── phase 5: serve requests at full width ───────────────────────────

# kernels each serving phase must launch (and no other), and for the llama
# phase the exact launches of one decode step and of one prefill
SERVE_PATHS = {
    "serve": {"flash_fwd", "int8_mlp", "decode_attention"},
    # no model routes a projection through int4_matmul (the JAX package
    # keeps them int8): it is held against its plain version in the kernels
    # phase only
    "serve4": {"flash_fwd", "int4_mlp", "decode_attention_int4"},
    "llama": {"flash_fwd", "int8_mlp", "decode_attention", "int8_matmul"},
}
LLAMA_STEP = {"int8_matmul": 1, "decode_attention": 32, "int8_mlp": 8}
# 24 CLIP + 6 perceiver + 32 decoder + 8 xattn attention calls
LLAMA_PREFILL = {"flash_fwd": 70}
# OTTER-MPT7B at int4: 32 decoder MLPs and 8 xattn FFs a step
SERVE4_STEP = {"int4_mlp": 40, "decode_attention_int4": 32}
# (prefill, decode step) launches that a b=8 request must make, by phase
EXACT_LAUNCHES = {"llama": (LLAMA_PREFILL, LLAMA_STEP),
                  "serve4": (LLAMA_PREFILL, SERVE4_STEP)}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _weight_bytes(model) -> int:
    return _nbytes(*model.parameters(), *model.buffers())


def _launches_of(fn) -> dict:
    """The kernels' launch counts over one call of `fn`, zeros left out."""
    from otter_tpu_torch.tools import bench_decode
    before = bench_decode.kernel_launches()
    fn()
    after = bench_decode.kernel_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _eager_twin(engine):
    """`engine`'s model and cache request with the eager step
    (`cuda_graph=False`): what a graphed engine is held to, and what a
    count of Python calls a step needs."""
    from otter_tpu_torch.generation.engine import OtterGenerator
    return OtterGenerator(engine.model, cache_dtype=engine.cache_dtype,
                          hbm_bytes=engine.hbm_bytes, cuda_graph=False)


def _int8dense_host_cost(engine, cfg, tag: str) -> None:
    """What `Int8Dense`'s composed branch (the product where no input
    needs a gradient) saves a b=8 decode step on the host against
    running it through `_Int8Product` (`Function.apply`) as training
    does: the `Int8Dense` calls a step (counted by a forward hook over a
    3-token request less a 1-token one) times the host time a call of
    the one takes beyond the other. The two are timed on a 64 x 64
    layer, so that each call is host-bound, in blocks of 2000 calls in
    the order a b b a b a, under inference mode as `generate` runs."""
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.ops import quant

    calls = [0]

    def hook(mod, inp, out):
        if isinstance(mod, quant.Int8Dense):
            calls[0] += 1

    req = make_requests(cfg, 8, SEED + 19)
    eager = _eager_twin(engine)     # (a replayed step calls no module)
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        counts = []
        for n_new in (1, 3):
            calls[0] = 0
            eager.generate(*req, gen=GenerationConfig(
                max_new_tokens=n_new, eos_token_id=-1))
            counts.append(calls[0])
    finally:
        handle.remove()
    per_step = (counts[1] - counts[0]) / 2

    m = quant.Int8Dense(64, 64, device=DEV)
    with torch.no_grad():
        m.kernel_q.copy_(torch.randint(-127, 128, (64, 64), device=DEV))
    x = torch.randn(8, 64, device=DEV, dtype=torch.bfloat16)

    def composed(x):
        x = x.to(m.dtype)
        return (x @ m.kernel_q.to(m.dtype)) * m.scale_q.to(m.dtype)

    us = {"a": [], "b": []}
    def function(x):
        return quant._Int8Product.apply(x.to(m.dtype), m.kernel_q,
                                        m.scale_q)

    fns = {"a": composed, "b": function}
    n = 2000
    with torch.inference_mode():
        if not torch.equal(composed(x), function(x)):
            raise RuntimeError(f"{tag}: _Int8Product's forward differs from "
                               f"the composed product")
        for key in "abbaba":
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fns[key](x)
            torch.cuda.synchronize()
            us[key].append((time.perf_counter() - t) / n * 1e6)
    extra = float(np.median(us["b"]) - np.median(us["a"]))
    log(f"{tag}: Int8Dense calls a b=8 decode step {per_step:g}; host us a "
        f"call (64 x 64, blocks of {n}): composed "
        f"{[round(u, 2) for u in us['a']]}, _Int8Product "
        f"{[round(u, 2) for u in us['b']]}: {extra:+.2f} us a call, "
        f"{extra * per_step / 1e3:+.3f} ms a step")


def phase_serve(smi: str, tag: str = "serve"):
    """Serve the requests on OTTER-MPT7B with int8 weights and cache (phase
    `serve`) or int4 weights and cache (phase `serve4`), or on
    OTTER-LLaMA2-Chat-7B with int8 weights and cache (phase `llama`)."""
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools import bench_decode

    int4 = tag == "serve4"
    quant_mode = "int4" if int4 else "int8"
    cfg = llama_cfg() if tag == "llama" else serving_cfg(quant=quant_mode)
    t0 = time.perf_counter()
    model = build_model(cfg)
    n_bytes = _weight_bytes(model)
    log(f"{tag}: {cfg.text.num_hidden_layers}-layer {cfg.text.arch} model, "
        f"{quant_mode} weights ({n_bytes / 1e9:.3f} GB on the card) and "
        f"{quant_mode} KV cache, built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = OtterGenerator(model, cache_dtype="int4" if int4 else torch.int8)
    bench_decode.reset_kernel_launches()
    for b in (1, 8):
        vision_x, lang_x, attn = make_requests(cfg, b, SEED + 10 + b)
        engine.generate(vision_x, lang_x, attn,
                        gen=GenerationConfig(max_new_tokens=2))   # warm-up
        # REPS pairs of (1-token, 32-token) requests; medians of each
        times = {1: [], 32: []}
        outs = []
        for _ in range(REPS):
            for n_new in (1, 32):
                t = time.perf_counter()
                out = engine.generate(
                    vision_x, lang_x, attn,
                    gen=GenerationConfig(max_new_tokens=n_new))
                times[n_new].append(time.perf_counter() - t)
            outs.append(out)
        out = outs[0]
        p = lang_x.shape[1]
        if out.shape != (b, p + 32):
            raise RuntimeError(f"{tag} b={b}: output shape {out.shape}")
        if not ((out >= 0) & (out < cfg.text.total_vocab)).all():
            raise RuntimeError(f"{tag} b={b}: token outside the vocabulary")
        if any(not np.array_equal(outs[0], o) for o in outs[1:]):
            raise RuntimeError(f"{tag} b={b}: greedy output differs between "
                               f"runs of the same request")
        if b == 1:
            # the streaming entry point yields what generate returned (up
            # to the end-of-chunk token, which it does not yield)
            streamed = list(engine.stream_generate(
                vision_x, lang_x, attn,
                gen=GenerationConfig(max_new_tokens=32)))
            want = out[0, p:].tolist()
            if cfg.eoc_token_id in want:
                want = want[:want.index(cfg.eoc_token_id)]
            if streamed != want:
                raise RuntimeError(f"{tag}: stream_generate gave {streamed}, "
                                   f"generate {want}")
            log(f"{tag} b=1: stream_generate yielded the {len(streamed)} "
                f"tokens generate returned")
        ttft = float(np.median(times[1]))
        decode_s = float(np.median(times[32])) - ttft
        tok_s = b * 31 / decode_s
        log(f"{tag} b={b}: prompts {attn.sum(1).tolist()} tokens + 1 image "
            f"each, 32 new tokens | TTFT {ttft * 1e3:.2f} ms | decode "
            f"{tok_s:.2f} tok/s ({decode_s / 31 * 1e3:.2f} ms/step) | "
            f"medians of {REPS}; TTFT runs "
            f"{[round(x * 1e3, 2) for x in times[1]]} ms, 32-token runs "
            f"{[round(x * 1e3, 2) for x in times[32]]} ms | {smi} | first "
            f"tokens {out[0, p:p + 8].tolist()}")
    if tag in EXACT_LAUNCHES:
        # what one prefill and one decode step launch, exactly (no eos, so
        # the 3-token request takes its two steps)
        req = make_requests(cfg, 8, SEED + 19)
        prefill = _launches_of(lambda: engine.generate(
            *req, gen=GenerationConfig(max_new_tokens=1)))
        three = _launches_of(lambda: engine.generate(
            *req, gen=GenerationConfig(max_new_tokens=3, eos_token_id=-1)))
        step = {k: (n - prefill.get(k, 0)) / 2 for k, n in three.items()
                if n != prefill.get(k, 0)}
        log(f"{tag}: a prefill launches {prefill}, a decode step {step}")
        want_prefill, want_step = EXACT_LAUNCHES[tag]
        if prefill != want_prefill or step != want_step:
            raise RuntimeError(
                f"{tag}: a prefill launched {prefill} (expected "
                f"{want_prefill}), a decode step {step} (expected "
                f"{want_step})")
    launches = bench_decode.kernel_launches()
    log(f"{tag}: kernel launches during the requests {launches}")
    path = SERVE_PATHS[tag]
    dead = sorted(k for k in path if launches[k] == 0)
    stray = sorted(k for k, n in launches.items() if n and k not in path)
    if dead or stray:
        raise RuntimeError(f"{tag}: never launched {dead}; launched off its "
                           f"path {stray}")
    if tag == "serve":      # after the count: its requests are not timed
        _int8dense_host_cost(engine, cfg, tag)
    return launches, engine


# ── phase 23: the captured decode step ──────────────────────────────

GRAPH_NEW = 32


def _logits_behind(engine, req, j: int, new: int = GRAPH_NEW):
    """The raw logits [B, V] behind token j of `engine`'s request `req`
    (max_new_tokens `new`, so the key of the phase's runs): the prefill,
    then steps up to token j (replays on a graphed engine: the graph writes
    `st.logits` in place)."""
    from otter_tpu_torch.config import GenerationConfig
    st = engine._prefill(*req, gen=GenerationConfig(max_new_tokens=new))
    try:
        while st.t <= j:
            engine._advance(st)
        return st.logits.float().clone()
    finally:
        engine._finish(st)


def _hold_graphed(tag, graphed, eager, req, got, want):
    """Graphed tokens equal to eager's, or the logits at the first step
    where they part within PARITY_BAR max|eager|."""
    import numpy as np
    if np.array_equal(got, want):
        return "equal"
    p = req[1].shape[1]
    cols = np.nonzero((got[:, p:] != want[:, p:]).any(0))[0]
    j = int(cols[0])
    g, e = (_logits_behind(x, req, j) for x in (graphed, eager))
    err, bar = float((g - e).abs().max()), PARITY_BAR * float(e.abs().max())
    msg = (f"part at token {j}: max |graphed - eager logits| {err:.4f} "
           f"(bar {bar:.4f})")
    if not err <= bar:
        raise RuntimeError(f"{tag}: {msg}")
    return msg


def _capture_probe(fn, gen=None) -> str:
    """Whether `fn()` captures into a CUDA graph and replays: "captures",
    or the error (the probe's capture stream left clean)."""
    import torch
    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    if gen is not None:
        graph.register_generator_state(gen)
    try:
        with torch.cuda.stream(side):
            fn()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn()
            except RuntimeError:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        main.wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        return "captures"
    except RuntimeError as e:
        main.wait_stream(side)
        torch.cuda.synchronize()
        return f"does not capture ({str(e).splitlines()[0][:100]})"


def _sampling_captures(smi: str) -> None:
    """The sampler's parts under capture: `torch.multinomial` with a
    registered generator and the top-k / top-p filters."""
    import torch
    from otter_tpu_torch.generation import sampling
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED)
    logits = torch.randn(8, 50432, generator=g, device=DEV)
    probs = torch.softmax(logits, -1)
    probes = {
        "torch.multinomial": (lambda: torch.multinomial(probs, 1,
                                                        generator=g), g),
        "apply_top_k": (lambda: sampling.apply_top_k(logits, 50), None),
        "apply_top_p": (lambda: sampling.apply_top_p(logits, 0.9), None)}
    got = {k: _capture_probe(fn, gen) for k, (fn, gen) in probes.items()}
    log(f"graph: capture of the sampler's parts (8 x 50432) "
        f"{json.dumps(got)} | {smi}")
    bad = [k for k, v in got.items() if v != "captures"]
    if bad:
        raise RuntimeError(f"graph: {bad} do not capture")


def _graph_vs_eager(tag, smi, model, cfg, b, seed, reps=REPS,
                    cache_dtype=None, want_step=None):
    """One request shape through a graphed engine and its eager twin in
    turns: tokens, launches a step (equal, and `want_step` where given),
    wall ms a step, the first request of the key against later ones, the
    capture. Returns (graphed, eager, request, graphed tokens)."""
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    graphed = OtterGenerator(model, cache_dtype=cache_dtype or torch.int8)
    eager = _eager_twin(graphed)
    if not graphed.cuda_graph:
        raise RuntimeError(f"{tag}: the engine's step is not graphed by "
                           f"default on the card")
    req = make_requests(cfg, b, seed)
    gen = lambda n: GenerationConfig(max_new_tokens=n)
    eager.generate(*req, gen=gen(2))        # the model's first use
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = graphed.generate(*req, gen=gen(GRAPH_NEW))
    first_s = time.perf_counter() - t
    entry = graphed._entries[-1]
    if entry.graph is None:
        raise RuntimeError(f"{tag}: no graph was captured")
    times = {(m, n): [] for m in ("graphed", "eager") for n in (1, GRAPH_NEW)}
    outs = {"graphed": [first], "eager": []}
    engines = {"graphed": graphed, "eager": eager}
    for i in range(reps):
        for mode in (("eager", "graphed") if i % 2 else ("graphed", "eager")):
            for n in (1, GRAPH_NEW):
                t = time.perf_counter()
                out = engines[mode].generate(*req, gen=gen(n))
                times[(mode, n)].append(time.perf_counter() - t)
                if n == GRAPH_NEW:
                    outs[mode].append(out)
    for mode, o in outs.items():
        if any(not np.array_equal(o[0], x) for x in o[1:]):
            raise RuntimeError(f"{tag}: {mode} tokens differ between runs")
    held = _hold_graphed(tag, graphed, eager, req, outs["graphed"][0],
                         outs["eager"][0])
    steps = {}
    for mode, engine in engines.items():
        one = _launches_of(lambda: engine.generate(*req, gen=gen(1)))
        three = _launches_of(lambda: engine.generate(
            *req, gen=GenerationConfig(max_new_tokens=3, eos_token_id=-1)))
        steps[mode] = {k: (n - one.get(k, 0)) / 2 for k, n in three.items()
                       if n != one.get(k, 0)}
    if steps["graphed"] != steps["eager"] or (
            want_step is not None and steps["graphed"] != want_step):
        raise RuntimeError(f"{tag}: launches a step graphed "
                           f"{steps['graphed']}, eager {steps['eager']}"
                           f"{'' if want_step is None else f', expected {want_step}'}")
    med = {k: float(np.median(v)) for k, v in times.items()}
    step_ms = {m: (med[(m, GRAPH_NEW)] - med[(m, 1)]) / (GRAPH_NEW - 1) * 1e3
               for m in engines}
    log(f"{tag} b={b}: tokens graphed vs eager {held}; launches a step "
        f"{steps['graphed']} (equal) | wall ms a step graphed "
        f"{step_ms['graphed']:.3f}, eager {step_ms['eager']:.3f} "
        f"({step_ms['eager'] / step_ms['graphed']:.2f}x) | TTFT graphed "
        f"{med[('graphed', 1)] * 1e3:.2f} ms, eager "
        f"{med[('eager', 1)] * 1e3:.2f} ms | {GRAPH_NEW}-token request: "
        f"the key's first (its step captured) {first_s * 1e3:.2f} ms, later "
        f"{med[('graphed', GRAPH_NEW)] * 1e3:.2f} ms | capture "
        f"{entry.capture_ms:.2f} ms, its memory pool "
        f"{entry.pool_bytes / 2 ** 20:.1f} MiB | medians of {reps}; runs "
        f"(ms) " + json.dumps({f"{m}/{n}": [round(x * 1e3, 2) for x in v]
                               for (m, n), v in times.items()})
        + f" | {smi}")
    return graphed, eager, req, outs["graphed"][0]


# kernel records a step that torch.profiler may lose between two profiles
# of one run (it lost up to 0.1 a step over 31 steps): a replay that drops
# or adds a kernel a step moves the count by 1
PROFILE_LOSS = 0.5
PROFILE_TRIES = 3


def _device_step(tag, smi, graphed, eager, req):
    """Device ms a step: torch.profiler over whole runs of 1 and 32 new
    tokens for each engine (nothing else runs beside the profiler), and,
    for the graph, CUDA events around 31 replays queued back to back. The
    profiler's kernels a step, graphed and eager, must agree within
    PROFILE_LOSS: a count that the launch counters cannot give, since a
    replay adds what its capture recorded (both profiled again, up to
    PROFILE_TRIES times, before the phase fails)."""
    import torch
    from otter_tpu_torch.config import GenerationConfig
    run = lambda engine: (lambda n: engine.generate(*req, gen=GenerationConfig(
        max_new_tokens=n, eos_token_id=-1)))
    for attempt in range(1, PROFILE_TRIES + 1):
        prof = {m: phase_profile(run(e), f"{tag} {m}")
                for m, e in (("graphed", graphed), ("eager", eager))}
        gap = abs(prof["graphed"][1] - prof["eager"][1])
        if gap <= PROFILE_LOSS:
            break
        log(f"{tag}: the profiler's kernels a step graphed "
            f"{prof['graphed'][1]:.1f}, eager {prof['eager'][1]:.1f} "
            f"(profile {attempt} of {PROFILE_TRIES})")
    else:
        raise RuntimeError(
            f"{tag}: a graphed step runs {prof['graphed'][1]:.1f} kernels by "
            f"the profiler, the eager step {prof['eager'][1]:.1f}")
    st = graphed._prefill(*req, gen=GenerationConfig(max_new_tokens=GRAPH_NEW,
                                                     eos_token_id=-1))
    try:
        graphed._advance(st)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(GRAPH_NEW - 2):
            graphed._advance(st)
        end.record()
        end.synchronize()
        events_ms = start.elapsed_time(end) / (GRAPH_NEW - 2)
    finally:
        graphed._finish(st)
    log(f"{tag}: device ms a step (torch.profiler, whole runs) graphed "
        f"{prof['graphed'][0]:.3f} in {prof['graphed'][1]:.1f} kernels, "
        f"eager {prof['eager'][0]:.3f} in {prof['eager'][1]:.1f} (equal "
        f"within {PROFILE_LOSS}; profile {attempt}); "
        f"{GRAPH_NEW - 2} replays queued back to back (CUDA events) "
        f"{events_ms:.3f} ms a step | {smi}")
    return prof, events_ms


def _no_sync(tag, engines, req):
    """Steps of each engine under `set_sync_debug_mode("error")`: a step
    that synchronises with the host raises."""
    import torch
    from otter_tpu_torch.config import GenerationConfig
    for mode, engine in engines.items():
        st = engine._prefill(*req, gen=GenerationConfig(
            max_new_tokens=GRAPH_NEW, eos_token_id=-1))
        try:
            engine._advance(st)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(8):
                    engine._advance(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        finally:
            engine._finish(st)
    log(f"{tag}: 8 steps of {sorted(engines)} under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync")


def _long_request(cfg, seed: int, p: int = 2000):
    """One request whose prompt of `p` tokens puts its cache at 2048."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.eoc_token_id, (1, p)).astype(np.int64)
    ids[0, 0] = cfg.media_token_id
    size = cfg.vision.image_size
    vx = rng.standard_normal((1, 1, 1, 3, size, size)).astype(np.float32)
    return vx, ids, np.ones_like(ids, dtype=np.int32)


def _workspace_kept(tag, smi, graphed, eager, req, want, cfg):
    """ROADMAP Queue 3's workspace, closed: between two requests of a
    captured key (b=1, cache 256: decode_attention splits into 2 chunks
    a row), a cache of 2048 (16 chunks: a workspace 8x larger) runs on the
    eager engine (it grows the shared workspace) and on the graphed one
    (its own entry). The old key's graph keeps its workspace, and its
    tokens."""
    import numpy as np
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.ops import decode_attention as da
    gen = GenerationConfig(max_new_tokens=GRAPH_NEW)
    if not np.array_equal(graphed.generate(*req, gen=gen), want):
        raise RuntimeError(f"{tag}: the captured key's tokens moved")
    entry = graphed._entries[-1]      # the key's, now the most recent
    graph, (ws, cnt) = entry.graph, entry.workspace.tensors()[0]
    long = _long_request(cfg, SEED + 33)
    for engine in (eager, graphed):
        engine.generate(*long, gen=GenerationConfig(max_new_tokens=8))
    shared = da._shared.tensors()[0][0]
    again = graphed.generate(*req, gen=gen)
    kept = (entry.graph is graph and entry in graphed._entries
            and entry.workspace.tensors()[0][0] is ws)
    log(f"{tag}: a 2000-token request (cache 2048) on the eager and the "
        f"graphed engine between two requests of the captured b=1 key: the "
        f"shared workspace {shared.numel()} floats, the key's own "
        f"{ws.numel()} (kept: {kept}); its tokens "
        f"{'unchanged' if np.array_equal(again, want) else 'CHANGED'} | "
        f"{smi}")
    if not (kept and shared.numel() > ws.numel()
            and shared.data_ptr() != ws.data_ptr()
            and np.array_equal(again, want)):
        raise RuntimeError(f"{tag}: the captured key's workspace or tokens "
                           f"moved")


def _graph_worker(tag, smi, graphed, cfg):
    """One `stream_generate` request through the worker over localhost
    HTTP, on the graphed engine: the text equals `generate`'s."""
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.serve.worker import (ModelWorker, build_app,
                                              decode_media_to_vision_x,
                                              make_otter_stream_fn,
                                              run_app_in_thread)
    tok = otter_tokenizer(cfg)
    payload = worker_requests(cfg, 1, SEED + 34, new_tokens=GRAPH_NEW)[0]
    vx, _ = decode_media_to_vision_x(payload["images"],
                                     cfg.vision.image_size)
    ids = tok(payload["prompt"], return_tensors="np")["input_ids"]
    out = graphed.generate(vx, ids, gen=GenerationConfig(
        max_new_tokens=GRAPH_NEW))
    want = tok.decode(_cut_at(out[0, ids.shape[1]:].tolist(),
                              cfg.eoc_token_id))
    port = _free_port()
    worker = ModelWorker(controller_addr="", worker_addr="",
                         model_name="otter", no_register=True,
                         stream_fn=make_otter_stream_fn(graphed, tok, cfg))
    stop = run_app_in_thread(build_app(worker), "127.0.0.1", port)
    try:
        chunks, first, last = post_stream(
            f"http://127.0.0.1:{port}/worker_generate_stream", payload)
    finally:
        stop()
        worker.close()
    got = _final_text(chunks, "the graph phase's request")
    graphs = [e for e in graphed._entries if e.key[0] == 1
              and e.graph is not None]
    log(f"{tag}: one request ({ids.shape[1]} tokens + a 256x256 PNG) "
        f"through the worker's stream over localhost HTTP on the graphed "
        f"engine: first chunk {first * 1e3:.2f} ms, last {last * 1e3:.2f} "
        f"ms, the text {'equal' if got == want else 'NOT equal'} to "
        f"generate's | {smi}")
    if got != want or not graphs:
        raise RuntimeError(f"{tag}: the worker gave {got[:80]!r}, generate "
                           f"{want[:80]!r} (graphs: {len(graphs)})")


MIXED_REQUESTS = 16
MIXED_NEW = (16, 48, 96)
MIXED_SAMPLING = (dict(), dict(do_sample=True, temperature=0.7, top_p=0.9),
                  dict(do_sample=True, temperature=1.0, top_k=50))


def _lru_misses(keys, bound: int) -> int:
    """The requests of the key sequence `keys` that find no entry when at
    most `bound` entries stay (least recently used first out)."""
    held, misses = [], 0
    for k in keys:
        if k in held:
            held.remove(k)
        else:
            misses += 1
            held = held[max(0, len(held) - bound + 1):]
        held.append(k)
    return misses


def _mixed_keys(tag, smi, model, cfg):
    """Traffic whose keys vary, as a worker's users send it: MIXED_REQUESTS
    b=1 streams one after another on a fresh graphed engine, prompts of
    32-128 tokens, max_new_tokens drawn from MIXED_NEW and the sampling
    from MIXED_SAMPLING (a seeded generator each). Counts the requests
    that captured (their key held no entry: an eager step, then the
    capture), the capture ms, the pools the entries hold, the ms a token
    of the requests that captured against those that only replayed, and,
    from the same key sequence, the captures that other bounds on the
    entries would have made. The captures must be those of MAX_ENTRIES."""
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation import engine as eng
    rng = np.random.default_rng(SEED + 35)
    engine = eng.OtterGenerator(model, cache_dtype=torch.int8)
    captured = []
    capture = engine._capture

    def counted(entry):
        capture(entry)
        captured.append(entry)
    engine._capture = counted
    size = cfg.vision.image_size
    keys, rows, t_all = [], [], time.perf_counter()
    for i in range(MIXED_REQUESTS):
        p = int(rng.integers(32, 129))
        n = int(rng.choice(MIXED_NEW))
        setting = MIXED_SAMPLING[int(rng.integers(len(MIXED_SAMPLING)))]
        ids = rng.integers(1, cfg.eoc_token_id, (1, p)).astype(np.int64)
        ids[0, 0] = cfg.media_token_id
        vx = rng.standard_normal((1, 1, 1, 3, size, size)).astype(np.float32)
        gen = GenerationConfig(max_new_tokens=n, eos_token_id=-1, **setting)
        g = (torch.Generator(device=DEV).manual_seed(SEED + i)
             if gen.do_sample else None)
        before = len(captured)
        t = time.perf_counter()
        toks = list(engine.stream_generate(vx, ids, gen=gen, generator=g))
        wall = time.perf_counter() - t
        if len(toks) != n:
            raise RuntimeError(f"{tag}: a mixed request gave {len(toks)} of "
                               f"{n} tokens")
        keys.append(engine._entries[-1].key)
        rows.append((len(captured) > before, wall / n * 1e3))
    t_all = time.perf_counter() - t_all
    n_cap = len(captured)
    by_bound = {b: _lru_misses(keys, b) for b in range(1, 9)}
    cap_ms = [e.capture_ms for e in captured]
    held = sum(e.pool_bytes for e in engine._entries if e.graph is not None)
    tok_ms = {c: [ms for cap, ms in rows if cap == c] for c in (True, False)}
    med = lambda v: f"{float(np.median(v)):.2f}" if v else "none"
    log(f"{tag}: {MIXED_REQUESTS} b=1 streams of mixed keys (prompts "
        f"32-128, max_new_tokens of {list(MIXED_NEW)}, greedy / T 0.7 top-p "
        f"0.9 / T 1.0 top-k 50): {len(set(keys))} keys, {n_cap} requests "
        f"captured (bound {eng.MAX_ENTRIES}), capture ms "
        f"{[round(x, 1) for x in cap_ms]}, the entries that stay hold "
        f"{held / 2 ** 20:.1f} MiB of pools; ms a token (median) "
        f"{med(tok_ms[True])} for a request that captured, "
        f"{med(tok_ms[False])} for one that replayed; the stream "
        f"{t_all:.2f} s; captures the same keys would make at bounds 1-8: "
        f"{json.dumps(by_bound)} | {smi}")
    if n_cap != by_bound[eng.MAX_ENTRIES]:
        raise RuntimeError(f"{tag}: {n_cap} captures, the bound says "
                           f"{by_bound[eng.MAX_ENTRIES]}")


def _stream_ttft(tag, smi, graphed, req):
    """A b=1 stream on a key the engine has not seen: the time to its first
    token (the prefill) and to its second (the eager step and the capture),
    then the same of a second request of the key (replays)."""
    from otter_tpu_torch.config import GenerationConfig
    gen = GenerationConfig(max_new_tokens=GRAPH_NEW, eos_token_id=-1)
    stamps = []
    for _ in range(2):
        t = time.perf_counter()
        it = graphed.stream_generate(*req, gen=gen)
        first = next(it)
        t1 = time.perf_counter() - t
        next(it)
        t2 = time.perf_counter() - t
        rest = list(it)
        stamps.append((t1, t2))
        if len(rest) != GRAPH_NEW - 2 or first is None:
            raise RuntimeError(f"{tag}: the stream ended early")
    (a1, a2), (b1, b2) = stamps
    log(f"{tag} stream b=1: the key's first request: TTFT {a1 * 1e3:.2f} ms, "
        f"second token at {a2 * 1e3:.2f} ms (its step captured); a later "
        f"request: TTFT {b1 * 1e3:.2f} ms, second token at "
        f"{b2 * 1e3:.2f} ms | {smi}")


MEGAKERNEL_STEP = {"int8_mlp": 40, "decode_attn_megakernel": 32}


def _graph_megakernel(smi: str) -> None:
    """The megakernel route captured: OTTER-Image-MPT7B at full width and
    depth, int8 weights, `megakernel=True` with a bf16 cache (its kernel
    reads the position from the device counter), b=1 and b=8, 32 new
    tokens, graphed against `cuda_graph=False` in turns: tokens equal,
    launches a step equal and exact (the megakernel once a layer, the FF's
    `int8_mlp` 40), no host sync in 8 steps of either."""
    import torch
    cfg = serving_cfg()
    cfg = cfg.replace(text=cfg.text.replace(megakernel=True))
    model = build_model(cfg)
    log(f"graph megakernel: {cfg.text.num_hidden_layers}-layer mpt model, "
        f"int8 weights with the fused [Wqkv | Wo] copy "
        f"({_weight_bytes(model) / 1e9:.3f} GB), bf16 KV cache")
    for b, seed in ((1, SEED + 41), (8, SEED + 48)):
        graphed, eager, req, _ = _graph_vs_eager(
            "graph megakernel", smi, model, cfg, b, seed,
            cache_dtype=torch.bfloat16, want_step=MEGAKERNEL_STEP)
        _no_sync(f"graph megakernel b={b}",
                 {"graphed": graphed, "eager": eager}, req)
        del graphed, eager


def phase_graph(smi: str):
    """The captured decode step (`OtterGenerator`, `cuda_graph`) against
    its eager step on OTTER-Image-MPT7B at full width and depth (int8
    weights and cache, decode_kernel="auto"), b=1 and b=8, the same model
    on the megakernel route (bf16 cache) at b=1 and b=8, and
    OTTER-LLaMA2-Chat-7B at b=8."""
    import gc
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools import bench_decode
    bench_decode.reset_kernel_launches()
    _sampling_captures(smi)
    cfg = serving_cfg()
    model = build_model(cfg)
    log(f"graph: {cfg.text.num_hidden_layers}-layer mpt model, int8 weights "
        f"({_weight_bytes(model) / 1e9:.3f} GB) and int8 KV cache")
    graphed1, eager1, req1, want1 = _graph_vs_eager("graph", smi, model, cfg,
                                                    1, SEED + 11)
    _stream_ttft("graph", smi, OtterGenerator(model, cache_dtype=torch.int8),
                 req1)
    _workspace_kept("graph", smi, graphed1, eager1, req1, want1, cfg)
    _graph_worker("graph", smi, graphed1, cfg)
    _mixed_keys("graph", smi, model, cfg)
    graphed8, eager8, req8, _ = _graph_vs_eager("graph", smi, model, cfg, 8,
                                                SEED + 18)
    _no_sync("graph b=8", {"graphed": graphed8, "eager": eager8}, req8)
    _device_step("graph b=8", smi, graphed8, eager8, req8)
    del graphed1, eager1, graphed8, eager8, model
    gc.collect()
    torch.cuda.empty_cache()
    _graph_megakernel(smi)
    gc.collect()
    torch.cuda.empty_cache()
    lcfg = llama_cfg()
    lmodel = build_model(lcfg)
    graphed, eager, req, _ = _graph_vs_eager("graph llama", smi, lmodel, lcfg,
                                             8, SEED + 18)
    gen = lambda n: GenerationConfig(max_new_tokens=n, eos_token_id=-1)
    steps = _launches_of(lambda: graphed.generate(*req, gen=gen(3)))
    prefill = _launches_of(lambda: graphed.generate(*req, gen=gen(1)))
    step = {k: (n - prefill.get(k, 0)) / 2 for k, n in steps.items()
            if n != prefill.get(k, 0)}
    if step != LLAMA_STEP or prefill != LLAMA_PREFILL:
        raise RuntimeError(f"graph llama: a step launched {step}, a prefill "
                           f"{prefill}")
    return bench_decode.kernel_launches()


# ── phase 10: OtterHD-8B, one request at a time ─────────────────────

OTTERHD_STEP = {"int8_matmul": 1, "int8_mlp": 36, "decode_attention": 36}
OTTERHD_PREFILL = {"flash_fwd": 36}


def _loop_vs_eager(tag, smi, graphed, eager, run, begin, want_prefill,
                   want_step, profile_eager: bool = False):
    """A decode loop that the JAX package compiles, through a graphed
    engine (its step a CUDA graph, the card's default) and its eager twin
    (`cuda_graph=False`) in turns: `run(engine, n)` serves one request of
    n new tokens and returns its tokens (a copy the host holds),
    `begin(engine)` leases the state of such a request of GRAPH_NEW
    tokens after its prefill. Tokens equal in every run of both; the
    launches of a prefill and of a step equal between the two and exact
    (a replay counts what its capture recorded); no host sync in 8 steps
    of either (`set_sync_debug_mode("error")`; the graphed ones replays);
    wall ms a step both ways ((t(32) - t(1)) / 31, medians of REPS), TTFT,
    the key's first request (its step captured) against later ones, the
    capture's ms and memory pool; the graphed step's device ms and kernels
    by torch.profiler over whole runs (the eager one's with
    `profile_eager`). Returns (the tokens, a dict of the readings)."""
    import numpy as np
    import torch
    if not graphed.cuda_graph or eager.cuda_graph:
        raise RuntimeError(f"{tag}: the engines' graph settings "
                           f"{graphed.cuda_graph}, {eager.cuda_graph}")
    same = lambda a, b: np.array_equal(np.asarray(a), np.asarray(b))
    run(eager, 2)                           # the shapes' first use
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = run(graphed, GRAPH_NEW)
    first_s = time.perf_counter() - t
    entry = graphed._entries[-1]
    if entry.graph is None:
        raise RuntimeError(f"{tag}: no graph was captured")
    engines = {"graphed": graphed, "eager": eager}
    times = {(m, n): [] for m in engines for n in (1, GRAPH_NEW)}
    outs = {"graphed": [first], "eager": []}
    for i in range(REPS):
        for mode in (("eager", "graphed") if i % 2 else ("graphed", "eager")):
            for n in (1, GRAPH_NEW):
                t = time.perf_counter()
                out = run(engines[mode], n)
                times[(mode, n)].append(time.perf_counter() - t)
                if n == GRAPH_NEW:
                    outs[mode].append(out)
    every = outs["graphed"] + outs["eager"]
    if any(not same(every[0], x) for x in every[1:]):
        raise RuntimeError(f"{tag}: tokens differ between runs or between "
                           f"the graphed and the eager step: graphed "
                           f"{np.asarray(outs['graphed'][0]).tolist()[:2]}, "
                           f"eager {np.asarray(outs['eager'][0]).tolist()[:2]}")
    launches = {}
    for mode, engine in engines.items():
        one = _launches_of(lambda: run(engine, 1))
        three = _launches_of(lambda: run(engine, 3))
        launches[mode] = (one, {k: (n - one.get(k, 0)) / 2
                                for k, n in three.items()
                                if n != one.get(k, 0)})
    if not launches["graphed"] == launches["eager"] == (want_prefill,
                                                        want_step):
        raise RuntimeError(f"{tag}: (prefill, step) launches graphed "
                           f"{launches['graphed']}, eager "
                           f"{launches['eager']}, expected "
                           f"{(want_prefill, want_step)}")
    for mode, engine in engines.items():
        st = begin(engine)
        try:
            engine._advance(st)
            if engine.cuda_graph and st.entry.graph is None:
                raise RuntimeError(f"{tag}: the key's step is not captured")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(8):
                    engine._advance(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        finally:
            engine._finish(st)
    med = {k: float(np.median(v)) for k, v in times.items()}
    step_ms = {m: (med[(m, GRAPH_NEW)] - med[(m, 1)]) / (GRAPH_NEW - 1) * 1e3
               for m in engines}
    dev = {"graphed": phase_profile(lambda n: run(graphed, n),
                                    f"{tag} graphed")}
    if profile_eager:
        dev["eager"] = phase_profile(lambda n: run(eager, n), f"{tag} eager")
    log(f"{tag}: tokens graphed = eager in {len(every)} runs; launches a "
        f"prefill {launches['graphed'][0]}, a step {launches['graphed'][1]} "
        f"(equal, exact); 8 steps of each under set_sync_debug_mode('error'): "
        f"no host sync | wall ms a step graphed {step_ms['graphed']:.3f}, "
        f"eager {step_ms['eager']:.3f} "
        f"({step_ms['eager'] / step_ms['graphed']:.2f}x) | TTFT graphed "
        f"{med[('graphed', 1)] * 1e3:.2f} ms, eager "
        f"{med[('eager', 1)] * 1e3:.2f} ms | {GRAPH_NEW}-token request: the "
        f"key's first (its step captured) {first_s * 1e3:.2f} ms, later "
        f"{med[('graphed', GRAPH_NEW)] * 1e3:.2f} ms | capture "
        f"{entry.capture_ms:.2f} ms, its memory pool {entry.pool_bytes} bytes "
        f"({entry.pool_bytes / 2 ** 20:.1f} MiB) | device ms a step "
        + ", ".join(f"{m} {d[0]:.3f} in {d[1]:.1f} kernels"
                    for m, d in dev.items())
        + f" (torch.profiler, whole runs) | medians of {REPS}; runs (ms) "
        + json.dumps({f"{m}/{n}": [round(x * 1e3, 2) for x in v]
                      for (m, n), v in times.items()}) + f" | {smi}")
    return first, dict(step_ms=step_ms, ttft_ms={
        m: med[(m, 1)] * 1e3 for m in engines}, capture_ms=entry.capture_ms,
        pool_bytes=entry.pool_bytes, device_ms=dev["graphed"][0])


def phase_otterhd(smi: str, profile: bool = False):
    """OtterHD-8B, one request at a time through `FuyuGenerator` (its step
    captured once per key, the card's default) against
    `FuyuGenerator(..., cuda_graph=False)` in turns, a 448x448 and a
    1080x1920 image with a 16-token prompt, 32 greedy tokens
    (`_loop_vs_eager`); then the worker's fuyu stream function."""
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.fuyu import FuyuGenerator
    from otter_tpu_torch.tools import bench_decode
    from otter_tpu_torch.tools.random_weights import fuyu_request

    cfg = otterhd_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg)
    n_bytes = _weight_bytes(model)
    lm = model.language_model
    table = _nbytes(lm.wte_q, lm.wte_s)
    plain_table = lm.wte_q.numel() * 2   # the same table in bf16
    log(f"otterhd: {cfg.text.num_hidden_layers}-layer persimmon model, int8 "
        f"weights, int8 embedding table and int8 KV cache: "
        f"{n_bytes / 1e9:.3f} GB on the card "
        f"({(n_bytes - table + plain_table) / 1e9:.3f} GB without "
        f"quant_embed: the table takes {table / 1e9:.3f} GB, "
        f"{plain_table / 1e9:.3f} in bf16), built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    graphed = FuyuGenerator(model, torch.int8)
    eager = FuyuGenerator(model, torch.int8, cuda_graph=False)
    gen = lambda n: GenerationConfig(max_new_tokens=n)

    bench_decode.reset_kernel_launches()
    for height, width in ((448, 448), (1080, 1920)):
        req = fuyu_request(cfg, height, width, 16, SEED + 20)
        s = req[0].shape[1]
        tag = f"otterhd {height}x{width}"
        log(f"{tag}: {s - 16} image tokens + 16 prompt tokens, 32 new "
            f"tokens, b=1")
        toks, _ = _loop_vs_eager(
            tag, smi, graphed, eager,
            lambda e, n: list(e.generate(*req, gen(n))),
            lambda e: e._prefill(*req, gen(GRAPH_NEW)),
            OTTERHD_PREFILL, OTTERHD_STEP, profile_eager=profile)
        if len(toks) != 32 or not all(0 <= t < cfg.text.total_vocab
                                      for t in toks):
            raise RuntimeError(f"{tag}: tokens {toks}")
        log(f"{tag}: first tokens {toks[:8]}")
    launches = bench_decode.kernel_launches()
    log(f"otterhd: kernel launches during the requests {launches}")
    _fuyu_stream(model, cfg, smi, eager)
    return launches


def _fuyu_stream(model, cfg, smi: str, eager):
    """The worker's fuyu family on the OtterHD model: one text-only request
    through `make_fuyu_stream_fn` (its `FuyuGenerator`'s step graphed, the
    card's default) must return `post_process_box_coordinates` of the
    text of `fuyu_generate` over `eager` (the step uncaptured) for the same
    prompt."""
    import numpy as np
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.data.fuyu_processor import (FuyuImageProcessor,
                                                     FuyuProcessor)
    from otter_tpu_torch.generation.fuyu import fuyu_generate
    from otter_tpu_torch.serve.worker import make_fuyu_stream_fn

    tok = WorkerTokenizer({}, eos_token_id=2, bos_token_id=1)
    processor = FuyuProcessor(
        tok, FuyuImageProcessor(patch_size=cfg.patch_size),
        image_placeholder_id=cfg.image_placeholder_id,
        image_newline_id=cfg.image_newline_id)
    rng = np.random.default_rng(SEED + 70)
    # text ids below the image ids, as the Fuyu tokenizer's are
    top = min(cfg.image_placeholder_id, cfg.image_newline_id)
    prompt = " ".join(f"t{i}" for i in rng.integers(3, top, 16))
    stream_fn = make_fuyu_stream_fn(model, processor, cfg, tok,
                                    cache_dtype=eager.cache_dtype)
    t0 = time.perf_counter()
    chunks = list(stream_fn({"prompt": prompt,
                             "generation_kwargs": {"max_new_tokens": 32}}))
    wall = time.perf_counter() - t0
    batch = processor([prompt], None, left_pad=True)
    toks = list(fuyu_generate(
        eager, batch["input_ids"], batch["image_patches"],
        batch["image_patches_indices"], batch["attention_mask"],
        GenerationConfig(max_new_tokens=32, eos_token_id=tok.eos_token_id)))
    want = processor.post_process_box_coordinates(tok.decode(toks))
    graphs = [e for e in stream_fn.engine._entries if e.graph is not None]
    log(f"otterhd: a text-only request ({batch['input_ids'].shape[1]} "
        f"tokens) through the worker's fuyu stream function (its step "
        f"{'graphed' if graphs else 'NOT graphed'}): {len(toks)} tokens in "
        f"{wall * 1e3:.1f} ms, {len(chunks)} chunks, the last "
        f"{'equal' if chunks[-1] == want else 'NOT equal'} to the eager "
        f"fuyu_generate's text | {smi}")
    if chunks[-1] != want or not graphs:
        raise RuntimeError(f"otterhd: the fuyu stream gave "
                           f"{chunks[-1][:80]!r}, fuyu_generate "
                           f"{want[:80]!r} (graphs: {len(graphs)})")


# ── phase 12: beam search and mixed still+video media ────────────────

# a beam decode step (B*K rows) and a beam prefill: OTTER-Video-LLaMA7B's
# gated MLPs never reach int8_mlp (its 8 xattn FFs do), MPT-7B's 32 do
BEAM_LAUNCHES = {
    "video": ({"flash_fwd": 70}, LLAMA_STEP),
    "mpt": ({"flash_fwd": 70},
            {"int8_mlp": 40, "decode_attention": 32}),
}
BEAM_PATH = {"flash_fwd", "int8_mlp", "decode_attention", "int8_matmul"}


def beam_first_logits(model, cfg, vision_x, lang_x, attn, k: int):
    """The beam path's first logits: the prefill of B*K rows (each
    request's logits [B, V]) and the first beam step's [B*K, V] (the
    entry's step function at the device counter, t = 1)."""
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    eng = OtterGenerator(model, cache_dtype=torch.int8, cuda_graph=False)
    with torch.inference_mode():
        st = eng._beam_prefill(vision_x, lang_x, attn, GenerationConfig(
            max_new_tokens=4, num_beams=k))
        try:
            rows = lang_x.shape[0] * k
            tok = torch.full((rows, 1), cfg.text.vocab_size // 2,
                             device=model.device)
            logits1, _ = st.beam.step_fn(tok, st.cache, st.t_dev)
            return st.logits.float().clone(), logits1.float()
        finally:
            eng._finish(st)


def _beam_parity():
    """(c): both configurations cut in depth, kernels against plain."""
    for tag, cfg, k in (("video-llama7b beams K=3", video_cfg(True), 3),
                        ("mpt7b beams K=4", serving_cfg(True), 4)):
        model = build_model(cfg)
        if cfg.text.arch == "llama":
            pixels, _, ids = video_request(cfg, SEED + 30)
            req = (pixels, ids, None)
        else:
            req = make_requests(cfg, 8, SEED + 31)
        kern = beam_first_logits(model, cfg, *req, k)
        with plain_kernels():
            plain = beam_first_logits(model, cfg, *req, k)
        _hold_logits(tag, kern, plain)
        del model


def _timed(fn, reps: int = REPS):
    """(median seconds, every run's ms, the last result) of `reps` calls."""
    import numpy as np
    times, out = [], None
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t)
    return float(np.median(times)), [round(x * 1e3, 2) for x in times], out


def _cut_at(tokens, eos):
    tokens = list(tokens)
    return tokens[:tokens.index(eos)] if eos in tokens else tokens


def _beam_engines(tag, smi, model, req, k, want, stream_req):
    """Beams of `req` (K = k, no-repeat 3-grams) through a graphed
    `OtterGenerator` and its eager twin (`_loop_vs_eager`), then
    `stream_beam_generate` of `stream_req` (one request) on each: its last
    yield is `generate`'s continuation cut at eos."""
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    graphed = OtterGenerator(model, cache_dtype=torch.int8)
    eager = _eager_twin(graphed)
    gen = lambda n: GenerationConfig(num_beams=k, no_repeat_ngram_size=3,
                                     max_new_tokens=n)
    req, stream_req = ((tuple(r) + (None,))[:3] for r in (req, stream_req))
    out, res = _loop_vs_eager(
        tag, smi, graphed, eager, lambda e, n: e.generate(*req, gen=gen(n)),
        lambda e: e._beam_prefill(*req, gen(GRAPH_NEW)), *want)
    p = stream_req[1].shape[1]
    cont = _cut_at(graphed.generate(*stream_req, gen=gen(GRAPH_NEW))[
        0, p:].tolist(), model.cfg.eoc_token_id)
    yields = {m: list(e.stream_beam_generate(*stream_req, gen=gen(GRAPH_NEW)))
              for m, e in (("graphed", graphed), ("eager", eager))}
    if not yields["graphed"][-1] == yields["eager"][-1] == cont:
        raise RuntimeError(f"{tag}: the last streamed beam (graphed "
                           f"{yields['graphed'][-1]}, eager "
                           f"{yields['eager'][-1]}) is not generate's {cont}")
    log(f"{tag}: stream_beam_generate's {len(yields['graphed'])} yields "
        f"end in generate's {len(cont)} tokens, graphed and eager | first "
        f"tokens {cont[:8]}")
    return out, res


def phase_beam(smi: str):
    """(a) OTTER-Video-LLaMA7B: a still and a 16-frame video in uint8 with
    their frame mask through `stream_generate`, then 3 beams a request
    through `generate` and `stream_beam_generate`; (b) OTTER-MPT7B:
    serve's b=8 requests with 4 beams each (32 rows). Each beam request
    through a graphed engine (its beam step a CUDA graph, the card's
    default) and an eager one in turns (`_loop_vs_eager`). (c, first) the
    beam path's first logits at cut depth, kernels against plain."""
    import gc
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools import bench_decode

    _beam_parity()
    bench_decode.reset_kernel_launches()

    # (a) the video request
    cfg = video_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg)
    log(f"beam[video]: {cfg.text.num_hidden_layers}-layer llama model, "
        f"head of {cfg.text.total_vocab} rows, frame embeddings for "
        f"{cfg.perceiver.max_num_frames} frames, int8 weights "
        f"({_weight_bytes(model) / 1e9:.3f} GB) and int8 KV cache, built "
        f"in {time.perf_counter() - t0:.1f} s")
    pixels, mask, ids = video_request(cfg, SEED + 40)
    dev_pixels = torch.from_numpy(pixels).to(DEV)
    dev_mask = torch.from_numpy(mask).to(DEV)
    # the still's latents under the mask against the still alone (F = 1):
    # 24 CLIP and 6 perceiver layers in bf16 at other shapes (32 frames
    # against 1, 4160 keys against 320) round differently, so they are
    # held as the model's outputs are (the parity phase's 5e-2 *
    # max|ref|), beside the same difference on the plain path and the
    # still's latents without the mask, which must miss by more
    def still(fn):
        with torch.inference_mode():
            return fn(dev_pixels, dev_mask)[:, :1].float(), fn(
                dev_pixels[:, :1, :1], None).float()

    lat, alone = still(model.encode_vision)
    with plain_kernels():
        plain_lat, plain_alone = still(model.encode_vision)
    unmasked, _ = still(lambda px, m: model.encode_vision(px))
    scale = float(alone.abs().max())
    err, excess = max_err(lat, alone)
    noise = float((plain_lat - plain_alone).abs().max())
    off = float((unmasked - alone).abs().max())
    ok = (err <= 5e-2 * scale < off and bool(torch.isfinite(lat).all())
          and lat.shape == alone.shape == (1, 1, cfg.perceiver.num_latents,
                                           cfg.perceiver.dim))
    log(f"beam[video]: the still's latents under the frame mask against the "
        f"still alone (F=1): max_abs_err {err:.3e} vs max|alone| "
        f"{scale:.3e} (tolerance 5e-2 * max|alone|; 2e-2 + 2e-2*|alone| "
        f"{'met' if excess <= 0 else f'missed by {excess:.3e}'}); the plain "
        f"path's own {noise:.3e}; without the mask {off:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("beam[video]: the masked still's latents "
                           "disagree with the still alone")
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    greedy = GenerationConfig(max_new_tokens=32)

    def first_token():
        stream = engine.stream_generate(pixels, ids, gen=greedy,
                                        vision_mask=mask)
        tok = next(stream, None)
        stream.close()
        return tok

    first_token()                                            # warm-up
    ttft, ttft_runs, _ = _timed(first_token)
    streamed = [list(engine.stream_generate(pixels, ids, gen=greedy,
                                            vision_mask=mask))
                for _ in range(2)]
    if streamed[0] != streamed[1] or not all(
            0 <= t < cfg.text.total_vocab for t in streamed[0]):
        raise RuntimeError(f"beam[video]: stream_generate gave {streamed}")
    log(f"beam[video]: stream_generate(vision_mask=) 1 still + "
        f"{pixels.shape[2]} frames (uint8, normalised on the card), "
        f"{ids.shape[1]}-token prompt: "
        f"time to the first token {ttft * 1e3:.2f} ms (runs {ttft_runs}), "
        f"{len(streamed[0])} greedy tokens, equal in two runs | {smi} | "
        f"first tokens {streamed[0][:8]}")
    del engine
    log(f"beam[video]: the still + video request, num_beams=3, "
        f"no_repeat_ngram_size=3, 32 new tokens (3 rows)")
    _beam_engines("beam[video]", smi, model, (pixels, ids),
                  3, BEAM_LAUNCHES["video"], (pixels, ids))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) MPT-7B, serve's b=8 requests with 4 beams each: 32 rows
    cfg = serving_cfg()
    model = build_model(cfg)
    req = make_requests(cfg, 8, SEED + 18)
    log(f"beam[mpt]: b=8 prompts {req[2].sum(1).tolist()} tokens + 1 image "
        f"each, num_beams=4 (32 rows), no_repeat_ngram_size=3, 32 new "
        f"tokens")
    one = tuple(x[:1] for x in req)
    out, _ = _beam_engines("beam[mpt]", smi, model, req, 4,
                           BEAM_LAUNCHES["mpt"], one)
    p = req[1].shape[1]
    if out.shape != (8, p + 32) or not (
            (out >= 0) & (out < cfg.text.total_vocab)).all():
        raise RuntimeError(f"beam[mpt]: output {out.shape}")
    launches = bench_decode.kernel_launches()
    log(f"beam: kernel launches during the requests {launches}")
    dead = sorted(k for k in BEAM_PATH if launches[k] == 0)
    stray = sorted(k for k, n in launches.items()
                   if n and k not in BEAM_PATH)
    if dead or stray:
        raise RuntimeError(f"beam: never launched {dead}; launched off its "
                           f"path {stray}")
    return launches


# ── phase 13: the serving worker over HTTP ──────────────────────────

class WorkerTokenizer:
    """The tokenizer surface the worker's stream functions and the Fuyu
    processor use, over a made-up vocabulary: a prompt is
    whitespace-separated tokens, each of `specials` ({text: id}) or
    `t<id>` for any other id; `decode` writes each id as ` t<id>` (so text
    decoded a chunk at a time joins into the whole), leaving out the
    specials."""

    def __init__(self, specials: dict, eos_token_id: int,
                 bos_token_id=None):
        self.specials = dict(specials)
        self.eos_token_id, self.bos_token_id = eos_token_id, bos_token_id
        self._special_ids = set(self.specials.values()) | {eos_token_id}

    def __call__(self, text, return_tensors=None, **kw):
        import numpy as np
        ids = [self.specials[w] if w in self.specials else int(w[1:])
               for w in text.split()]
        if return_tensors == "np":
            return {"input_ids": np.asarray([ids], np.int64)}
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f" t{int(i)}" for i in ids
                       if not (skip_special_tokens
                               and int(i) in self._special_ids))


def otter_tokenizer(cfg):
    return WorkerTokenizer({"<image>": cfg.media_token_id,
                            "<|endofchunk|>": cfg.eoc_token_id},
                           eos_token_id=cfg.eoc_token_id)


def png_bytes(rgb) -> bytes:
    """An RGB uint8 image [H, W, 3] as a PNG file (written with zlib: no
    image library)."""
    import struct
    import zlib
    h, w, _ = rgb.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def png_base64(rgb) -> str:
    """`png_bytes` as urlsafe base64, the worker's image payload."""
    import base64
    return base64.urlsafe_b64encode(png_bytes(rgb)).decode()


def worker_requests(cfg, n: int, seed: int, new_tokens: int = 32):
    """`n` greedy requests in the worker's JSON format: prompts of 32-128
    tokens that start with the media token, one random 256x256 image
    each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for length in np.linspace(32, 128, n).astype(int):
        ids = rng.integers(1, cfg.eoc_token_id, length - 1)
        prompt = "<image> " + " ".join(f"t{i}" for i in ids)
        image = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
        out.append({"model": "otter", "prompt": prompt,
                    "images": [png_base64(image)],
                    "generation_kwargs": {"max_new_tokens": new_tokens}})
    return out


def post_stream(url: str, payload: dict):
    """POST `payload` and read the `\\0`-delimited JSON chunks as they
    arrive: (chunks, seconds to the first chunk, seconds to the last)."""
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    chunks, buf, first = [], b"", None
    with urllib.request.urlopen(req, timeout=600) as resp:
        while True:
            data = resp.read1(65536)
            if not data:
                break
            *done, buf = (buf + data).split(b"\0")
            for c in done:
                if c:
                    first = first or time.perf_counter() - t0
                    chunks.append(json.loads(c))
    return chunks, first, time.perf_counter() - t0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _final_text(chunks, what: str) -> str:
    if not chunks or any(c["error_code"] != 0 for c in chunks):
        raise RuntimeError(f"worker: {what} failed: {chunks[-3:]}")
    return chunks[-1]["text"]


def _all_tensors(model) -> dict:
    out = dict(model.named_parameters())
    out.update(model.named_buffers())
    return out


def _checkpoint_route(smi: str):
    """OTTER-MPT7B cut in depth: its unquantized weights written as an HF
    checkpoint (`port_to_hf`, .bin and .safetensors), loaded back through
    the worker's start-up (`load_otter_model`: the loader, `quantize_params`
    tensor by tensor, the int8 model); every tensor, the first-step logits
    and one served request must equal the model built directly from the
    same weights."""
    import tempfile
    import torch
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.models.convert import port_to_hf, save_state_dict
    from otter_tpu_torch.serve.worker import (load_otter_model,
                                              make_otter_stream_fn)

    cfg = serving_cfg(depth_cut=True)
    plain = cfg.replace(text=cfg.text.replace(quant=None))
    direct = build_model(cfg)
    want = _all_tensors(direct)
    hf = port_to_hf(random_params(plain), plain)
    nbytes = _nbytes(*hf.values())
    req = make_requests(cfg, 8, SEED + 50)
    ref_logits = first_step_logits(direct, cfg, torch.int8, *req)
    tok = otter_tokenizer(cfg)
    request = worker_requests(cfg, 1, SEED + 51)[0]

    def served(model):
        fn = make_otter_stream_fn(OtterGenerator(model, cache_dtype=torch.int8),
                                  tok, cfg)
        return list(fn(request))[-1]

    ref_text = served(direct)
    with tempfile.TemporaryDirectory() as d:
        for name in ("pytorch_model.bin", "model.safetensors"):
            path = os.path.join(d, name)
            t0 = time.perf_counter()
            save_state_dict(hf, path)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            model, _ = load_otter_model(path, plain, load_bit="int8",
                                        device=DEV)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            got = _all_tensors(model)
            differ = sorted(k for k in want if k not in got
                            or not torch.equal(got[k], want[k]))
            logits = first_step_logits(model, cfg, torch.int8, *req)
            same_logits = all(torch.equal(a, b)
                              for a, b in zip(logits, ref_logits))
            text = served(model)
            log(f"worker[checkpoint {name}]: {len(hf)} HF tensors "
                f"({nbytes / 1e9:.3f} GB bf16) written in {t_save:.1f} s, "
                f"loaded, converted and quantized to int8 on the card in "
                f"{t_load:.1f} s; {len(want) - len(differ)} of {len(want)} "
                f"tensors bit-equal to the direct build, first-step logits "
                f"{'equal' if same_logits else 'DIFFER'}, served text "
                f"{'equal' if text == ref_text else 'DIFFERS'} | {smi}")
            if differ or not same_logits or text != ref_text:
                raise RuntimeError(f"worker: the checkpoint route ({name}) "
                                   f"differs from the direct build: "
                                   f"tensors {differ[:5]}")
            del model, got
            os.remove(path)
    del direct, want


def phase_worker(smi: str):
    """The serving worker: the checkpoint route at cut depth, then
    OTTER-MPT7B at full width and depth behind `ModelWorker` and the
    controller over localhost HTTP."""
    import threading
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.serve.controller import Controller
    from otter_tpu_torch.serve.controller import build_app as controller_app
    from otter_tpu_torch.serve.worker import (ModelWorker, build_app,
                                              decode_media_to_vision_x,
                                              make_otter_stream_fn,
                                              run_app_in_thread)
    from otter_tpu_torch.tools import bench_decode

    _checkpoint_route(smi)

    cfg = serving_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg)
    log(f"worker: {cfg.text.num_hidden_layers}-layer mpt model, int8 "
        f"weights ({_weight_bytes(model) / 1e9:.3f} GB) and int8 KV cache, "
        f"built in {time.perf_counter() - t0:.1f} s")
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    tok = otter_tokenizer(cfg)
    requests = worker_requests(cfg, 4, SEED + 60)

    # what each request must return: generate's tokens for its inputs;
    # and what its prefill launches (a prompt of 32 tokens or fewer also
    # takes int8_mlp for the 8 xattn FFs)
    want, prefills = [], []
    for r in requests:
        vx, _ = decode_media_to_vision_x(r["images"],
                                         cfg.vision.image_size)
        ids = tok(r["prompt"], return_tensors="np")["input_ids"]
        out = engine.generate(vx, ids, gen=GenerationConfig(
            max_new_tokens=32))
        want.append(_cut_at(out[0, ids.shape[1]:].tolist(),
                            cfg.eoc_token_id))
        prefills.append(_launches_of(lambda: engine.generate(
            vx, ids, gen=GenerationConfig(max_new_tokens=1))))
        if prefills[-1].get("flash_fwd") != 70:
            raise RuntimeError(f"worker: a prefill launched "
                               f"{prefills[-1]}")

    wport, cport = _free_port(), _free_port()
    ctrl = f"http://127.0.0.1:{cport}"
    url = f"http://127.0.0.1:{wport}"
    stops = [run_app_in_thread(controller_app(Controller("shortest_queue")),
                               "127.0.0.1", cport)]
    worker = None
    try:
        worker = ModelWorker(controller_addr=ctrl, worker_addr=url,
                             model_name="otter",
                             stream_fn=make_otter_stream_fn(engine, tok, cfg))
        stops.append(run_app_in_thread(build_app(worker), "127.0.0.1",
                                       wport))
        post_stream(url + "/worker_generate_stream",
                    dict(requests[0], generation_kwargs={
                        "max_new_tokens": 2}))                  # warm-up

        def concurrent():
            results = [None] * len(requests)
            barrier = threading.Barrier(len(requests))

            def run(i):
                barrier.wait()
                results[i] = post_stream(url + "/worker_generate_stream",
                                         requests[i])

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(requests))]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t
            if any(th.is_alive() for th in threads) or None in results:
                raise RuntimeError("worker: a concurrent request hung")
            return results, wall

        def solo():
            # through the controller's dispatch and proxied stream
            results, launches = [], []
            for r in requests:
                before = bench_decode.kernel_launches()
                results.append(post_stream(ctrl + "/worker_generate_stream",
                                           r))
                after = bench_decode.kernel_launches()
                launches.append({k: after[k] - before[k] for k in after
                                 if after[k] != before[k]})
            return results, launches

        rounds = []
        for _ in range(REPS):
            bench_decode.reset_kernel_launches()
            conc, wall = concurrent()
            conc_launches = bench_decode.kernel_launches()
            alone, solo_launches = solo()
            rounds.append((conc, wall, conc_launches, alone, solo_launches))
    finally:
        for stop in reversed(stops):
            stop()
        if worker is not None:
            # its heartbeat thread would hold the worker, its engine and
            # the model for the rest of the run
            worker.close()

    texts = [tok.decode(w) for w in want]
    n_tok = [len(w) for w in want]
    for k, (conc, wall, conc_launches, alone, solo_launches) in \
            enumerate(rounds):
        for i, text in enumerate(texts):
            got_c = _final_text(conc[i][0], f"concurrent request {i}")
            got_s = _final_text(alone[i][0], f"request {i} alone")
            if not got_c == got_s == text:
                raise RuntimeError(
                    f"worker round {k}: request {i} gave {got_c[:60]!r} "
                    f"concurrently, {got_s[:60]!r} alone, generate "
                    f"{text[:60]!r}")
        total = {}
        for i, launches in enumerate(solo_launches):
            steps = 31 if n_tok[i] == 32 else n_tok[i]
            expect = dict(prefills[i])
            for k2, per_step in (("decode_attention", 32), ("int8_mlp", 40)):
                expect[k2] = expect.get(k2, 0) + per_step * steps
            if launches != {k2: v for k2, v in expect.items() if v}:
                raise RuntimeError(f"worker: request {i} alone launched "
                                   f"{launches}, expected {expect}")
            for k2, v in launches.items():
                total[k2] = total.get(k2, 0) + v
        conc_nonzero = {k2: v for k2, v in conc_launches.items() if v}
        if conc_nonzero != total:
            raise RuntimeError(f"worker: the concurrent run launched "
                               f"{conc_nonzero}, the solo runs {total}")
        seq_wall = sum(a[2] for a in alone)
        log(f"worker round {k}: 4 requests (prompts "
            f"{[len(r['prompt'].split()) for r in requests]} tokens + 1 "
            f"256x256 PNG each, {n_tok} greedy tokens) over localhost "
            f"HTTP | concurrently, straight to the worker: first chunk "
            f"{[round(c[1] * 1e3, 2) for c in conc]} ms, "
            f"{[round((c[2] - c[1]) / max(n - 2, 1) * 1e3, 2) for c, n in zip(conc, n_tok)]} "
            f"ms a token a request after it, {sum(n_tok) / wall:.2f} tok/s "
            f"aggregate ({wall * 1e3:.1f} ms) | one after another through "
            f"the controller: first chunk "
            f"{[round(a[1] * 1e3, 2) for a in alone]} ms, "
            f"{[round((a[2] - a[1]) / max(n - 2, 1) * 1e3, 2) for a, n in zip(alone, n_tok)]} "
            f"ms a token, {sum(n_tok) / seq_wall:.2f} tok/s "
            f"({seq_wall * 1e3:.1f} ms) | texts equal concurrently, alone "
            f"and to generate's; launches {conc_nonzero} = the solo sum | "
            f"{smi}")
    return rounds[0][2]


# ── phase 14: IDEFICS (idefics-9b) behind the engine and the worker ──

# a prefill: 32 ViT + 6 perceiver + 32 decoder + 8 xattn attention calls;
# a decode step: 32 int8 decode_attention (the gated MLPs never reach
# int8_mlp, the bf16 head never int8_matmul; a step's xattn over one image,
# one query over 64 keys, takes the plain path as sub-tile), and with five
# images (320 keys) the 8 xattn through flash_fwd too
IDEFICS_PREFILL = {"flash_fwd": 78}
IDEFICS_STEP = {"decode_attention": 32}
IDEFICS_STEP_5 = {"decode_attention": 32, "flash_fwd": 8}
IDEFICS_PATH = {"flash_fwd", "decode_attention"}
# idefics-9b's tokenizer numbers <fake_token_around_image>, <image> and
# <end_of_utterance> 32000-32002; the two role words are single ids here
IDEFICS_SPECIALS = {"<fake_token_around_image>": 32000, "<image>": 32001,
                    "<end_of_utterance>": 32002, "User:": 2659,
                    "Assistant:": 4007}


def idefics_cfg(depth_cut: bool = False):
    """idefics-9b as the worker serves it with `--load-bit int8
    --cache-bit int8`: int8 decoder layers; the head, xattn, perceiver and
    ViT in bf16. `depth_cut`: every width kept; 4 decoder layers (the
    interval of 4 leaves one xattn block), ViT 2, perceiver 1."""
    from otter_tpu_torch.config import idefics9b
    cfg = idefics9b()
    cfg = cfg.replace(text=cfg.text.replace(quant="int8",
                                            decode_kernel="auto"))
    if depth_cut:
        cfg = cfg.replace(text=cfg.text.replace(num_hidden_layers=4),
                          vision=cfg.vision.replace(num_hidden_layers=2),
                          perceiver=cfg.perceiver.replace(depth=1))
    return cfg


class IdeficsTokenizer(WorkerTokenizer):
    """`WorkerTokenizer` over idefics-instruct prompts, whose specials
    touch their neighbours (`User:<fake_token_around_image><image>...`)."""

    def __call__(self, text, return_tensors=None, **kw):
        import re
        pat = "(" + "|".join(map(re.escape, self.specials)) + ")"
        words = [w for part in re.split(pat, text)
                 for w in ([part] if part in self.specials else part.split())]
        return super().__call__(" ".join(words), return_tensors)


def idefics_tokenizer(cfg):
    return IdeficsTokenizer(IDEFICS_SPECIALS, eos_token_id=cfg.eos_token_id)


def idefics_prompt(rng, n_tokens: int, images: int = 1) -> str:
    """An idefics-instruct prompt of `n_tokens` ids
    (`serve.conversation.render_prompt("idefics", ...)`): "User:", the
    first image's placeholder, a question of random words with the other
    images' placeholders spread through it, "<end_of_utterance>",
    "Assistant:"."""
    from otter_tpu_torch.serve.conversation import (IDEFICS_IMAGE_PLACEHOLDER,
                                                   render_prompt)
    n_words = n_tokens - 3 - 3 * images
    words = [f"t{i}" for i in rng.integers(3, 32000, n_words)]
    for j in range(1, images):
        words.insert(j * n_words // images + j - 1,
                     IDEFICS_IMAGE_PLACEHOLDER)
    return render_prompt("idefics", [[" ".join(words), None]],
                         with_image=True)


def idefics_requests(cfg, batch: int, seed: int, images: int = 1,
                     lens=None):
    """`batch` idefics-instruct prompts of 32-128 ids (or `lens`), each
    with `images` random 224x224 images (f32, normalised), left-padded to
    128: (vision_x [B, N, 3, 224, 224], lang_x [B, 128], mask [B, 128])."""
    import numpy as np
    from otter_tpu_torch.generation.engine import left_pad
    rng = np.random.default_rng(seed)
    tok = idefics_tokenizer(cfg)
    lens = rng.integers(32, 129, batch) if lens is None else lens
    ids = np.zeros((batch, 128), np.int64)
    mask = np.zeros((batch, 128), np.int32)
    for i, n in enumerate(lens):
        row = tok(idefics_prompt(rng, int(n), images))["input_ids"]
        ids[i, :len(row)], mask[i, :len(row)] = row, 1
    lang_x, attn = left_pad(ids, mask, target_len=128)
    size = cfg.vision.image_size
    vision_x = rng.standard_normal((batch, images, 3, size, size)).astype(
        np.float32)
    return vision_x, lang_x, attn


@contextlib.contextmanager
def _xattn_outputs_checked(found: list):
    """Records, for each attention call with a bias in the idefics model
    (the gated xattn), whether its output is finite on every row: the
    rows of left padding and of text before the first image attend no
    key."""
    import torch
    from otter_tpu_torch.models import idefics
    mha = idefics.multi_head_attention

    def checked(q, k, v, **kw):
        out = mha(q, k, v, **kw)
        if kw.get("bias") is not None:
            found.append(bool(torch.isfinite(out).all()))
        return out

    idefics.multi_head_attention = checked
    try:
        yield
    finally:
        idefics.multi_head_attention = mha


def phase_idefics(smi: str, profile: bool = False):
    """idefics-9b at full width and depth (int8 decoder, int8 KV cache,
    decode_kernel="auto") through `OtterGenerator` and, for one request,
    the worker's idefics stream function over localhost HTTP; `profile`:
    then `phase_profile` of the b=8 request."""
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.data.templates import (IDEFICS_STANDARD_MEAN,
                                                IDEFICS_STANDARD_STD)
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.models import idefics
    from otter_tpu_torch.serve.worker import (ModelWorker, build_app,
                                              decode_media_to_vision_x,
                                              make_idefics_stream_fn,
                                              run_app_in_thread)
    from otter_tpu_torch.tools import bench_decode

    cfg = idefics_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg)
    built = time.perf_counter() - t0
    tensors = _all_tensors(model)
    parts = {}
    for name, t in tensors.items():
        root = name.split(".")[0]
        group = ("xattn" if root.startswith("xattn_") else
                 "decoder" if root.startswith("layers_") else
                 "wte + head" if root in ("wte", "lm_head",
                                          "additional_embedding",
                                          "additional_fc", "norm_f")
                 else root)
        parts[group] = parts.get(group, 0) + _nbytes(t)
    n_bytes = sum(parts.values())
    log(f"idefics: idefics-9b ({cfg.text.num_hidden_layers} llama layers, "
        f"{cfg.text.num_hidden_layers // cfg.cross_layer_interval} gated "
        f"xattn blocks, ViT-H/14 {cfg.vision.num_hidden_layers} layers, "
        f"perceiver {cfg.perceiver.depth}), int8 decoder and int8 KV "
        f"cache: {n_bytes / 1e9:.3f} GB on the card "
        f"({', '.join(f'{k} {v / 1e9:.3f}' for k, v in parts.items())} GB), "
        f"built in {built:.1f} s")
    if not 11.0e9 <= n_bytes <= 11.8e9:
        raise RuntimeError(f"idefics: {n_bytes / 1e9:.3f} GB of weights, "
                           f"expected ~11.4")
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    tok = idefics_tokenizer(cfg)
    vocab = cfg.text.vocab_size + cfg.additional_vocab_size

    def gen(n):   # no early stop: the timed runs decode n tokens
        return GenerationConfig(max_new_tokens=n, eos_token_id=-1)

    def serve(tag, req):
        """TTFT and tok/s of `req` (medians of REPS), greedy repeatable."""
        b, p = req[1].shape
        engine.generate(*req, gen=gen(2))   # warm-up
        first, first_runs, _ = _timed(lambda: engine.generate(
            *req, gen=gen(1)))
        whole, whole_runs, out = _timed(lambda: engine.generate(
            *req, gen=gen(32)))
        again = engine.generate(*req, gen=gen(32))
        if out.shape != (b, p + 32) or not ((out >= 0) & (out < vocab)).all():
            raise RuntimeError(f"idefics {tag}: output {out.shape}")
        if not np.array_equal(out, again):
            raise RuntimeError(f"idefics {tag}: greedy output differs "
                               f"between runs of the same request")
        decode_s = whole - first
        log(f"idefics {tag}: prompts {req[2].sum(1).tolist()} tokens, "
            f"{req[0].shape[1]} image(s) each, 32 new tokens | TTFT "
            f"{first * 1e3:.2f} ms | decode {b * 31 / decode_s:.2f} tok/s "
            f"({decode_s / 31 * 1e3:.2f} ms/step) | medians of {REPS}; "
            f"TTFT runs {first_runs} ms, 32-token runs {whole_runs} ms | "
            f"{smi} | first tokens {out[0, p:p + 8].tolist()}")
        return out

    def launches(tag, req, want_prefill, want_step):
        prefill = _launches_of(lambda: engine.generate(*req, gen=gen(1)))
        three = _launches_of(lambda: engine.generate(*req, gen=gen(3)))
        step = {k: (n - prefill.get(k, 0)) / 2 for k, n in three.items()
                if n != prefill.get(k, 0)}
        log(f"idefics {tag}: a prefill launches {prefill}, a decode step "
            f"{step}")
        if prefill != want_prefill or step != want_step:
            raise RuntimeError(
                f"idefics {tag}: a prefill launched {prefill} (expected "
                f"{want_prefill}), a decode step {step} (expected "
                f"{want_step})")

    bench_decode.reset_kernel_launches()
    for b in (1, 8):
        req = idefics_requests(cfg, b, SEED + 80 + b)
        serve(f"b={b}", req)
    launches("b=8", req, IDEFICS_PREFILL, IDEFICS_STEP)
    req8 = req

    # the xattn rows that attend no image (left padding, "User:" and the
    # token around the image) come out finite; the logits too
    found = []
    with _xattn_outputs_checked(found), torch.inference_mode():
        dev = model.device
        mask = torch.from_numpy(req[2]).to(dev)
        logits, _, _ = model(
            torch.from_numpy(req[0]).to(dev),
            torch.from_numpy(req[1]).to(dev), attention_mask=mask,
            positions=(mask.cumsum(-1) - 1).clamp_min(0))
    blind = int((idefics.image_attention_incremental(
        torch.from_numpy(req[1]), cfg.media_token_id, cfg.eos_token_id)
        < 0).sum())
    log(f"idefics b=8: prefill logits {tuple(logits.shape)} finite: "
        f"{bool(torch.isfinite(logits).all())}; {len(found)} xattn outputs "
        f"finite on every row ({blind} rows attend no image): {all(found)}")
    if not (found and all(found) and bool(torch.isfinite(logits).all())):
        raise RuntimeError("idefics: NaN in the xattn rows that attend no "
                           "image or in the logits")
    del logits

    # two images interleaved: tokens after the second attend it alone
    req2 = idefics_requests(cfg, 1, SEED + 90, images=2, lens=[96])
    serve("2 images interleaved, b=1", req2)
    # five images: a step's xattn over 320 keys takes the kernel
    req5 = idefics_requests(cfg, 1, SEED + 91, images=5, lens=[112])
    serve("5 images, b=1", req5)
    launches("5 images", req5, IDEFICS_PREFILL, IDEFICS_STEP_5)

    # one request through the worker's idefics stream function over HTTP
    rng = np.random.default_rng(SEED + 92)
    image = rng.integers(0, 256, (256, 256, 3)).astype(np.uint8)
    payload = {"model": "idefics", "prompt": idefics_prompt(rng, 64),
               "images": [png_base64(image)],
               "generation_kwargs": {"max_new_tokens": 32}}
    vx, _ = decode_media_to_vision_x(
        payload["images"], cfg.vision.image_size, mean=IDEFICS_STANDARD_MEAN,
        std=IDEFICS_STANDARD_STD)
    vx = vx.reshape((1, -1) + vx.shape[3:])
    ids = tok(payload["prompt"], return_tensors="np")["input_ids"]
    out = engine.generate(vx, ids, gen=GenerationConfig(max_new_tokens=32))
    want = tok.decode(_cut_at(out[0, ids.shape[1]:].tolist(),
                              cfg.eoc_token_id))
    port = _free_port()
    worker = ModelWorker(controller_addr="", worker_addr="",
                         model_name="idefics", no_register=True,
                         stream_fn=make_idefics_stream_fn(engine, tok, cfg))
    stop = run_app_in_thread(build_app(worker), "127.0.0.1", port)
    try:
        chunks, first, last = post_stream(
            f"http://127.0.0.1:{port}/worker_generate_stream", payload)
    finally:
        stop()
    got = _final_text(chunks, "the idefics request")
    log(f"idefics: one request ({ids.shape[1]} tokens + a 256x256 PNG) "
        f"through the worker's idefics stream function over localhost "
        f"HTTP: first chunk {first * 1e3:.2f} ms, last {last * 1e3:.2f} ms, "
        f"{len(chunks)} chunks, the text "
        f"{'equal' if got == want else 'NOT equal'} to generate's | {smi}")
    if got != want:
        raise RuntimeError(f"idefics: the worker gave {got[:80]!r}, "
                           f"generate {want[:80]!r}")

    counts = bench_decode.kernel_launches()
    log(f"idefics: kernel launches during the requests {counts}")
    dead = sorted(k for k in IDEFICS_PATH if counts[k] == 0)
    stray = sorted(k for k, n in counts.items() if n and k not in IDEFICS_PATH)
    if dead or stray:
        raise RuntimeError(f"idefics: never launched {dead}; launched off "
                           f"its path {stray}")
    if profile:
        phase_profile(lambda n_new: engine.generate(*req8, gen=gen(n_new)),
                      "idefics b=8")
    return counts


# ── optional: where the time goes in one b=8 request ────────────────

# ── phase 15: the continuous batcher ─────────────────────────────────

# a pooled step, however many of the pool's rows are active: the 32
# decoder MLPs and 8 xattn FFs through int8_mlp (M = the pool's rows),
# 32 int8 decode_attention; a [B] cache_pos never takes the megakernel or
# the tail. Admissions add flash_fwd (a prefill's 70, a chunk's xattn).
BATCH_STEP = {"int8_mlp": 40, "decode_attention": 32}
BATCH_PATH = {"flash_fwd", "int8_mlp", "decode_attention"}
PARITY_BAR = 5e-2    # of max|lone logits|: the model-output tolerance


class _StepRecorder:
    """Wraps a batcher's pooled step (`_run_step`: a graph's replay, or the
    eager step), first-token sample and beam step (they run on its
    scheduler thread): each step's launches (a replay adds what its
    capture recorded), and, copied on the card (a replay overwrites its
    outputs, and the step advances the carried state in place) and kept
    there until read, each step's processed logits [n, V] and tokens with
    the prompt length of each row's request (None for a free or beam row)
    and the tokens the row emitted before the step; a first token and its
    logits by prompt length; a beam group's live hypotheses before and
    after each of its steps, with its rows' logits. Prompt lengths name
    the requests: the phase's requests in one run all differ in length
    (and hold one beam request). Every step asks for the logits, so a
    graphed pool captures the key with them."""

    def __init__(self, batcher):
        from otter_tpu_torch.tools import bench_decode
        step, first = batcher._run_step, batcher._first_token
        self.reset()

        def run_step(need_logits=False):
            emitted = batcher._carried["emitted"].clone()
            before = bench_decode.kernel_launches()
            out = step(True)
            after = bench_decode.kernel_launches()
            self.launches.append({k: after[k] - before[k] for k in after
                                  if after[k] != before[k]})
            owners = [s.real_len if s.active and s.group is None else None
                      for s in batcher._slots]
            self.steps.append((owners, emitted, out[4].clone(),
                               out[0].clone()))
            return out if need_logits else out[:4]

        def first_token(logits, ids, bucket, real, gen):
            tok = first(logits, ids, bucket, real, gen)
            self.first[real] = (logits[0], tok)
            return tok

        def beam_advance(grp, logits):
            before = [list(h) for h in grp.hyps]
            advance(grp, logits)
            self.beam_steps.append((before, logits[grp.rows].float(),
                                    [list(h) for h in grp.hyps]))

        advance = batcher._beam_advance
        batcher._run_step, batcher._first_token = run_step, first_token
        batcher._beam_advance = beam_advance

    def reset(self):
        self.launches, self.steps, self.first = [], [], {}
        self.beam_steps = []

    def tokens(self, real_len: int):
        """The batcher's tokens of a request and the logits behind each."""
        logits, tok = self.first[real_len]
        out = [(int(tok[0]), logits)]
        for owners, emitted, step_logits, nxt in self.steps:
            if real_len in owners:
                i = owners.index(real_len)
                if int(emitted[i]) == len(out):
                    out.append((int(nxt[i]), step_logits[i]))
        return out


def _lone_logits(engine, vx, ids, j: int, **gen_kw):
    """The logits [V] behind token j of `generate` of one request alone
    (`gen_kw`: more of its GenerationConfig), by the eager step of
    `engine`'s model (a graphed step's tokens are the eager one's: the
    graph phase holds them)."""
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    eager = _eager_twin(engine)
    seen = []

    def sample(st, logits):
        seen.append(logits[0].float().clone())
        OtterGenerator._sample(eager, st, logits)

    eager._sample = sample
    eager.generate(vx, ids, gen=GenerationConfig(max_new_tokens=j + 1,
                                                 **gen_kw))
    return seen[j]


def _hold_greedy(tag, engine, req, want, got, recorder, partings):
    """A greedy request's tokens through the batcher (`got`) against
    `generate`'s alone (`want`): equal where they are; where they part
    (the pooled products run at M = the pool's rows, `generate`'s at M =
    1), the logits behind the parting token within PARITY_BAR max|lone|,
    the request and step reported in `partings`."""
    if got == want:
        return
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    vx, ids = req
    real = ids.shape[1]
    mine = recorder.tokens(real)
    if [t for t, _ in mine[:len(got)]] != got:
        raise RuntimeError(f"{tag}: the recorded tokens of the {real}-token "
                           f"request are not its stream's")
    if j >= len(mine):
        raise RuntimeError(f"{tag}: the {real}-token request stopped at "
                           f"{len(got)} tokens, alone at {len(want)}")
    lone = _lone_logits(engine, vx, ids, j)
    err = float((mine[j][1].float() - lone).abs().max())
    bar = PARITY_BAR * float(lone.abs().max())
    partings.append(f"{real}-token request parts at token {j} "
                    f"({got[j] if j < len(got) else 'end'} against "
                    f"{want[j] if j < len(want) else 'end'}): max |logits "
                    f"- alone| {err:.4f} (bar {bar:.4f})")
    if not err <= bar:
        raise RuntimeError(f"{tag}: {partings[-1]}")


def _lone_beam_steps(engine, req, gen):
    """`generate(num_beams=K)` of one request alone, step by step (the
    entry's beam step run eagerly): each step's logits [K, V] and the live
    hypotheses after it (the first tokens at index 0), and the best
    hypothesis at the end."""
    import torch
    from otter_tpu_torch.generation import beam
    seen, hyps = [], []
    with torch.inference_mode():
        st = engine._beam_prefill(*req, None, gen)
        bst, step = st.beam, st.beam.step_fn

        def step_fn(tok, cache, t):
            logits, cache = step(tok, cache, t)
            seen.append(logits.float().clone())
            return logits, cache

        bst.step_fn = step_fn
        try:
            hyps.append(bst.tokens[0, :, :1].tolist())
            for t in range(1, gen.max_new_tokens):
                beam._beam_step(bst)
                hyps.append(bst.tokens[0, :, :t + 1].tolist())
            best = beam._beam_best(bst)[0][0].tolist()
        finally:
            bst.step_fn = step
            engine._finish(st)
    return seen, hyps, best


def _hold_beam(tag, engine, req, gen, want, got, recorder, partings):
    """A beam request through the batcher (`got`) against
    `generate(num_beams=K)` alone (`want`): equal, or, where the two searches part
    (the live hypotheses after a step differ: the pooled products run at
    M = the pool's rows, the lone at M = K), that step's logits of the K
    rows within PARITY_BAR max|lone|, the step reported in `partings`;
    hypotheses equal at every step with different results fail."""
    if got == want:
        return
    seen, hyps, best = _lone_beam_steps(engine, req, gen)
    if _cut_at(best, engine.cfg.eoc_token_id) != want:
        raise RuntimeError(f"{tag}: the beam search step by step is not "
                           f"generate's")
    steps = recorder.beam_steps
    if not steps or steps[0][0] != hyps[0]:
        raise RuntimeError(f"{tag}: the beams' first tokens differ")
    for t, (_, logits, after) in enumerate(steps, 1):
        if after == hyps[t]:
            continue
        err = float((logits - seen[t - 1]).abs().max())
        bar = PARITY_BAR * float(seen[t - 1].abs().max())
        partings.append(f"the beam search parts at step {t}: max |logits - "
                        f"alone| of its {len(after)} rows {err:.4f} (bar "
                        f"{bar:.4f})")
        if not err <= bar:
            raise RuntimeError(f"{tag}: {partings[-1]}")
        return
    raise RuntimeError(f"{tag}: the beams gave {got}, alone {want}, with "
                       f"equal hypotheses at every step")


def batch_requests(cfg, seed: int):
    """The batch phase's 20 requests, each (kind, (vision_x [1, 1, 1, 3,
    224, 224], ids [1, S]), GenerationConfig), 32 new tokens each: 16
    greedy of 32-128 tokens, 2 greedy of 300 and 480 (bucket 512: chunked
    at 256), one with 3 beams, one sampled (temperature 0.7, top_p 0.9);
    no two of one length."""
    import numpy as np
    from otter_tpu_torch.config import GenerationConfig
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    greedy = GenerationConfig(max_new_tokens=32)
    kinds = ([("greedy", int(n), greedy)
              for n in np.linspace(32, 128, 16).astype(int)]
             + [("greedy", 300, greedy), ("greedy", 480, greedy),
                ("beam", 72, GenerationConfig(max_new_tokens=32,
                                              num_beams=3)),
                ("sampled", 90, GenerationConfig(
                    max_new_tokens=32, do_sample=True, temperature=0.7,
                    top_p=0.9))])
    out = []
    for kind, n, gen in kinds:
        ids = rng.integers(1, cfg.eoc_token_id, (1, n)).astype(np.int64)
        ids[0, 0] = cfg.media_token_id
        vx = rng.standard_normal((1, 1, 1, 3, size, size)).astype(np.float32)
        out.append((kind, (vx, ids), gen))
    return out


def _consume(stream, stamps: list):
    """A stream's tokens, each arrival's host time appended to `stamps`."""
    toks = []
    for tok in stream:
        stamps.append(time.perf_counter())
        toks.append(tok)
    return toks


def _run_requests(batcher, reqs, first: int, gap_s: float, stamps=None):
    """`reqs` [(kind, (vx, ids), gen)] through `batcher`, each consumed on
    its own thread: the first `first` at once, then one every `gap_s`.
    Returns (tokens, arrival times, submit times, wall s); `stamps`, a
    list of a list a request, receives the arrival times as they come."""
    import threading
    n = len(reqs)
    toks, submitted = [None] * n, [0.0] * n
    stamps = [[] for _ in reqs] if stamps is None else stamps

    def run(i):
        submitted[i] = time.perf_counter()
        toks[i] = _consume(batcher.submit(*reqs[i][1], reqs[i][2]),
                           stamps[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for i, th in enumerate(threads):
        if i >= first:
            time.sleep(gap_s)
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads) or None in toks:
        raise RuntimeError("batch: a request hung")
    return toks, stamps, submitted, wall


def _step_launches_exact(tag, recorder, expect=None):
    expect = BATCH_STEP if expect is None else expect
    bad = [d for d in recorder.launches if d != expect]
    if bad or not recorder.launches:
        raise RuntimeError(f"{tag}: {len(bad)} of {len(recorder.launches)} "
                           f"pooled steps launched otherwise than "
                           f"{expect}: {bad[:3]}")


def phase_batch(smi: str):
    """The continuous batcher (`generation.batching.ContinuousBatcher`) on
    OTTER-Image-MPT7B at full width and depth (int8 weights and KV cache,
    decode_kernel="auto"): 20 requests through a pool of 8 (cache 2048,
    prefill chunks of 256), each against `generate` alone; a pooled
    step's wall beside `generate`'s b=8 step and the device's share of
    it; the worker with `--continuous-batching --num-slots 4` over
    localhost HTTP against the same four requests one after another; then
    idefics-9b cut in depth through the batcher."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools import bench_decode

    cfg = serving_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg)
    log(f"batch: {cfg.text.num_hidden_layers}-layer mpt model, int8 "
        f"weights ({_weight_bytes(model) / 1e9:.3f} GB) and int8 KV cache, "
        f"built in {time.perf_counter() - t0:.1f} s")
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    eos = cfg.eoc_token_id

    def pool(**kw):
        b = ContinuousBatcher(model, **dict(dict(
            num_slots=8, cache_len=2048, prefill_chunk=256,
            cache_dtype=torch.int8, rng_seed=SEED), **kw))
        return b, _StepRecorder(b)

    def alone(req, gen):
        out = engine.generate(*req, gen=gen)
        return _cut_at(out[0, req[1].shape[1]:].tolist(), eos)

    reqs = batch_requests(cfg, SEED + 100)
    t0 = time.perf_counter()
    want = [alone(r, g) if kind != "sampled" else None
            for kind, r, g in reqs]
    log(f"batch: each request alone through generate in "
        f"{time.perf_counter() - t0:.1f} s")

    # (1) 20 requests through a pool of 8: 8 at once, then one every 50 ms;
    # the pool's step captured (the card's default) and eager
    runs = {}
    for mode, kw in (("graphed", {}), ("eager", dict(cuda_graph=False))):
        b, rec = pool(**kw)
        try:
            _run_requests(b, reqs[:1] + reqs[16:17], 2, 0.0)   # warm-up
        finally:
            b.shutdown()
        b, rec = pool(**kw)
        if b.cuda_graph != (mode == "graphed"):
            raise RuntimeError(f"batch: the pool's step is "
                               f"{'not ' if mode == 'graphed' else ''}"
                               f"graphed by default")
        try:
            bench_decode.reset_kernel_launches()
            got, stamps, submitted, wall = _run_requests(b, reqs, 8, 0.05)
            path = {k: v for k, v in bench_decode.kernel_launches().items()
                    if v}
            stats = b.stats()
            graphs = [(key, g.capture_ms, g.pool_bytes)
                      for key, g in b._graphs.items()]
        finally:
            b.shutdown()
        if b._failure is not None:
            raise RuntimeError("batch: the scheduler failed") \
                from b._failure
        _step_launches_exact(f"batch {mode}", rec)
        stray = {k for k in path if k not in BATCH_PATH}
        if stray or set(path) != BATCH_PATH:
            raise RuntimeError(f"batch {mode}: the run launched {path}")
        if (mode == "graphed") != bool(graphs):
            raise RuntimeError(f"batch {mode}: graphs {graphs}")
        runs[mode] = (got, stamps, submitted, wall, path, stats, graphs, rec)
    got, stamps, submitted, wall, path, stats, graphs, rec = runs["graphed"]
    kinds = [k for k, _, _ in reqs]
    same = [g == e for g, e, k in zip(got, runs["eager"][0], kinds)
            if k != "sampled"]
    if not all(same):
        raise RuntimeError(f"batch: {same.count(False)} of {len(same)} "
                           f"greedy and beam requests differ between the "
                           f"graphed and the eager pool")
    partings = []
    for (kind, req, gen), g, w in zip(reqs, got, want):
        if kind == "greedy":
            _hold_greedy("batch", engine, req, w, g, rec, partings)
        elif kind == "beam":
            _hold_beam("batch", engine, req, gen, w, g, rec, partings)
    sampled = reqs[kinds.index("sampled")]
    repeats = []
    for _ in range(2):
        one, _ = pool(num_slots=1, prefill_chunk=0)
        try:
            repeats.append(list(one.submit(*sampled[1], sampled[2])))
        finally:
            one.shutdown()
    if repeats[0] != repeats[1] or not repeats[0]:
        raise RuntimeError(f"batch: the sampled request gave {repeats} "
                           f"under one seed")
    for mode, (g_, st_, sub_, wall_, path_, stats_, graphs_, rec_) in \
            runs.items():
        n_tok = sum(len(x) for x in g_)
        ttft = [x[0] - t for x, t in zip(st_, sub_)]
        log(f"batch {mode}: 20 requests (16 greedy of 32-128 tokens, 2 of "
            f"300 and 480 in chunks of 256, 3 beams, 1 sampled; one 224x224 "
            f"image each, 32 new tokens) through 8 slots, 8 at once then "
            f"one every 50 ms: {n_tok} tokens in {wall_ * 1e3:.1f} ms, "
            f"{n_tok / wall_:.2f} tok/s aggregate; TTFT p50 "
            f"{stats_['ttft_p50_s'] * 1e3:.2f} ms, p90 "
            f"{stats_['ttft_p90_s'] * 1e3:.2f} ms (stats()), first tokens "
            f"{np.percentile(ttft, 50) * 1e3:.2f} / "
            f"{np.percentile(ttft, 90) * 1e3:.2f} ms at the consumer; "
            f"{len(rec_.launches)} pooled steps, each launching "
            f"{BATCH_STEP}; run launches {path_}; graphs (key, capture ms, "
            f"pool MiB) {[(k, round(c, 1), round(m / 2 ** 20, 1)) for k, c, m in graphs_]} | {smi}")
    log(f"batch: greedy and beam tokens equal between the graphed and the "
        f"eager pool, and to generate alone"
        f"{'' if not partings else ' but where they part: ' + '; '.join(partings)} "
        f"({len(partings)} of 19 part); the sampled request repeats under "
        f"one seed | {smi}")
    del rec, runs

    # (2) a pooled step at 8 active rows against generate's b=8 step
    b8 = make_requests(cfg, 8, SEED + 101)
    runs = {n: _timed(lambda n=n: engine.generate(*b8, gen=GenerationConfig(
        max_new_tokens=n, eos_token_id=-1)))[1] for n in (1, 32)}
    gen_step = [(a - c) / 31 for a, c in zip(runs[32], runs[1])]

    def rows8(n_new, **kw):
        """The 8 requests (n_new tokens each) through a fresh pool of 8,
        all admitted at once: (arrival times a request, wall s)."""
        b, rec = pool(max_admits_per_iter=8, prefill_chunk=0, **kw)
        stamps = [[] for _ in range(8)]
        try:
            t = time.perf_counter()
            _run_requests(b, [("greedy", (b8[0][i:i + 1], b8[1][i:i + 1]),
                               GenerationConfig(max_new_tokens=n_new,
                                                eos_token_id=-1))
                              for i in range(8)], 8, 0.0, stamps)
            wall = time.perf_counter() - t
        finally:
            b.shutdown()
        _step_launches_exact("batch (8 rows)", rec)
        return stamps, wall

    steady = {}
    for mode, kw in (("graphed", {}), ("eager", dict(cuda_graph=False)),
                     ("graphed", {}), ("eager", dict(cuda_graph=False))):
        stamps, _ = rows8(72, **kw)
        gaps = np.diff(np.asarray([s[16:64] for s in stamps]), axis=1)
        steady.setdefault(mode, []).extend(np.median(gaps, axis=1) * 1e3)
    # Under torch.profiler (the device's kernels only): runs of 8 and of
    # 40 new tokens, a step from the difference. Each run is profiled
    # whole: the profiler starts before the pool's threads and stops after
    # they have ended (started and stopped while they launched, it took
    # the process down with a segfault in two default runs).
    seen = {}
    for n_new in (8, 40):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall = rows8(n_new)
        seen[n_new] = _report_profile(
            prof, wall, f"batch: profile of 8 rows x {n_new} new tokens",
            f"profile_batch_8rows_new{n_new}.txt") + (wall,)
    (b0, n0, w0), (b1, n1, w1) = seen[8], seen[40]
    med = {m: float(np.median(v)) for m, v in steady.items()}
    dev_step = (b1 - b0) / 32 * 1e3
    # (each profiled run is a fresh pool that captures its step: the
    # difference of their walls is no step time; the steady gaps are)
    log(f"batch: a pooled step at 8 rows under the profiler (graphed): "
        f"{dev_step:.3f} ms of device kernels, "
        f"{(n1 - n0) / 32:.1f} launches a step ((40 new - 8 new) / 32), "
        f"{100 * dev_step / med['graphed']:.1f}% of the graphed step's "
        f"median gap below | {smi}")
    log(f"batch: a pooled step at 8 active rows (median gap between a "
        f"stream's tokens 16-64 of 72, per stream, two pools of each kind "
        f"in turns): graphed "
        f"{[round(float(x), 2) for x in steady['graphed']]} ms (median "
        f"{med['graphed']:.3f}), eager "
        f"{[round(float(x), 2) for x in steady['eager']]} ms (median "
        f"{med['eager']:.3f}), each step launching {BATCH_STEP}; "
        f"generate's b=8 step in the same call "
        f"{[round(float(x), 2) for x in gen_step]} ms ((t(32 new) - "
        f"t(1 new)) / 31, {REPS} runs) | {smi}")

    worker_path = _batch_worker(smi, model, cfg, engine)
    _batch_idefics(smi)
    for k, v in worker_path.items():
        path[k] = path.get(k, 0) + v
    return path


def _batch_worker(smi: str, model, cfg, engine):
    """The worker with `--continuous-batching --num-slots 4` built
    in-process (a batcher of 4 slots, cache 2048, chunks of 256, behind
    `make_batched_stream_fn`): four greedy 32-token requests at once over
    localhost HTTP, then one after another, 3 rounds; each text equal to
    the take-turns worker's (`generate`'s); the status carries
    `batching`. Returns the launches of the rounds."""
    import threading
    import urllib.request
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    from otter_tpu_torch.serve.worker import (ModelWorker, build_app,
                                              decode_images_to_vision_x,
                                              make_batched_stream_fn,
                                              run_app_in_thread)
    from otter_tpu_torch.tools import bench_decode

    tok = otter_tokenizer(cfg)
    requests = worker_requests(cfg, 4, SEED + 102)
    reqs, want = [], []
    for r in requests:
        vx = decode_images_to_vision_x(r["images"], cfg.vision.image_size)
        ids = tok(r["prompt"], return_tensors="np")["input_ids"]
        out = engine.generate(vx, ids, gen=GenerationConfig(
            max_new_tokens=32))
        reqs.append((vx, ids))
        want.append(_cut_at(out[0, ids.shape[1]:].tolist(),
                            cfg.eoc_token_id))
    batcher = ContinuousBatcher(model, num_slots=4, cache_len=2048,
                                prefill_chunk=256, cache_dtype=torch.int8)
    rec = _StepRecorder(batcher)
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    worker = ModelWorker(controller_addr="", worker_addr=url,
                         model_name="otter", no_register=True,
                         stream_fn=make_batched_stream_fn(batcher, tok, cfg))
    stop = run_app_in_thread(build_app(worker), "127.0.0.1", port)
    rounds, launches = [], {}
    try:
        post_stream(url + "/worker_generate_stream",
                    dict(requests[0], generation_kwargs={
                        "max_new_tokens": 2}))                  # warm-up
        for _ in range(REPS):
            rec.reset()
            before = bench_decode.kernel_launches()
            results = [None] * 4
            barrier = threading.Barrier(4)

            def run(i):
                barrier.wait()
                results[i] = post_stream(url + "/worker_generate_stream",
                                         requests[i])

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(4)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t
            if any(th.is_alive() for th in threads) or None in results:
                raise RuntimeError("batch worker: a request hung")
            partings = []
            for i, (res, w) in enumerate(zip(results, want)):
                text = _final_text(res[0], f"concurrent request {i}")
                if text != tok.decode(w):
                    got = _cut_at([t for t, _ in rec.tokens(
                        reqs[i][1].shape[1])], cfg.eoc_token_id)
                    if got == w:
                        raise RuntimeError(
                            f"batch worker: request {i}'s text differs "
                            f"from its tokens': {text[:60]!r}")
                    _hold_greedy("batch worker", engine, reqs[i], w, got,
                                 rec, partings)
            _step_launches_exact("batch worker", rec)
            alone = []
            for i, r in enumerate(requests):
                # the pooled step runs all 4 rows whoever holds them: a
                # request alone gives its text at once
                alone.append(post_stream(url + "/worker_generate_stream", r))
                if _final_text(alone[-1][0], f"request {i} alone") != \
                        _final_text(results[i][0], f"request {i}"):
                    raise RuntimeError(f"batch worker: request {i} alone "
                                       f"differs from itself at once")
            after = bench_decode.kernel_launches()
            for k in after:
                if after[k] != before[k]:
                    launches[k] = launches.get(k, 0) + after[k] - before[k]
            rounds.append((wall, sum(a[2] for a in alone), results, alone,
                           partings))
        with urllib.request.urlopen(urllib.request.Request(
                url + "/worker_get_status", data=b"{}",
                headers={"Content-Type": "application/json"}),
                timeout=60) as resp:
            status = json.loads(resp.read())
    finally:
        stop()
        worker.close()
        batcher.shutdown()
    if "batching" not in status or status["batching"]["num_slots"] != 4:
        raise RuntimeError(f"batch worker: status {status}")
    n_tok = [len(w) for w in want]
    for k, (wall, seq, conc, alone, partings) in enumerate(rounds):
        log(f"batch worker round {k}: 4 requests (prompts "
            f"{[r[1].shape[1] for r in reqs]} tokens + 1 256x256 PNG "
            f"each, {n_tok} greedy tokens) over localhost HTTP to "
            f"--continuous-batching --num-slots 4 | at once: first chunk "
            f"{[round(c[1] * 1e3, 2) for c in conc]} ms, "
            f"{sum(n_tok) / wall:.2f} tok/s aggregate ({wall * 1e3:.1f} "
            f"ms) | one after another: first chunk "
            f"{[round(a[1] * 1e3, 2) for a in alone]} ms, "
            f"{sum(n_tok) / seq:.2f} tok/s ({seq * 1e3:.1f} ms) | at once "
            f"/ one after another {seq / wall:.2f}x (the take-turns worker, "
            f"PR 15: 0.86-1.08x) | texts equal to the take-turns worker's"
            f"{'' if not partings else ' but where they part: ' + '; '.join(partings)} | {smi}")
    log(f"batch worker: /worker_get_status carries batching: "
        f"{ {k: v for k, v in status['batching'].items() if k != 'recent'} }")
    return launches


def _batch_idefics(smi: str):
    """idefics-9b cut in depth (4 decoder layers: one xattn block; every
    width kept), int8 decoder and KV cache: four requests through a
    batcher of 4 slots, each against `generate` alone."""
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    from otter_tpu_torch.generation.engine import OtterGenerator

    cfg = idefics_cfg(depth_cut=True)
    model = build_model(cfg)
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    vx, ids, mask = idefics_requests(cfg, 4, SEED + 103)
    reqs = [(vx[i:i + 1], ids[i:i + 1][:, mask[i].astype(bool)])
            for i in range(4)]
    if len({r[1].shape[1] for r in reqs}) != 4:
        raise RuntimeError("batch idefics: two prompts of one length")
    gen = GenerationConfig(max_new_tokens=32)
    want = [_cut_at(engine.generate(*r, gen=gen)[0, r[1].shape[1]:]
                    .tolist(), cfg.eoc_token_id) for r in reqs]
    b = ContinuousBatcher(model, num_slots=4, cache_len=2048,
                          cache_dtype=torch.int8)
    rec = _StepRecorder(b)
    try:
        got, _, _, wall = _run_requests(b, [("greedy", r, gen)
                                            for r in reqs], 4, 0.0)
    finally:
        b.shutdown()
    partings = []
    for r, w, g in zip(reqs, want, got):
        _hold_greedy("batch idefics", engine, r, w, g, rec, partings)
    step = {"decode_attention": cfg.text.num_hidden_layers}
    _step_launches_exact("batch idefics", rec, step)
    log(f"batch idefics: idefics-9b cut to {cfg.text.num_hidden_layers} "
        f"layers, int8 decoder and cache, 4 idefics-instruct requests "
        f"(prompts {[r[1].shape[1] for r in reqs]} tokens, one image each) "
        f"through 4 slots: {sum(len(g) for g in got)} tokens in "
        f"{wall * 1e3:.1f} ms; tokens equal to generate alone"
        f"{'' if not partings else ' but where they part: ' + '; '.join(partings)}; "
        f"each pooled step {step} | {smi}")


# ── phase 16: speculative decoding and the session cache ────────────

SPEC_GAMMA = 4
# decoder layers, xattn blocks: half the depth of OTTER-MPT7B (32, 8) and
# of Flamingo-MPT-1B (24, an xattn block before each layer), so that the
# default run keeps inside its time with the training phases
SPEC_TARGET = (16, 4)
SPEC_DRAFT = (12, 12)


def draft_cfg():
    """Flamingo-MPT-1B (mosaic_gpt, qk_ln, xattn every layer) as the worker
    loads a draft: int8 weights, decode_kernel="auto"."""
    from otter_tpu_torch.config import otter_mpt1b
    cfg = otter_mpt1b()
    return cfg.replace(text=cfg.text.replace(quant="int8",
                                             decode_kernel="auto"))


def _add(total: dict, part: dict) -> dict:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v
    return total


def window_launches(rows: int, s: int, dims) -> dict:
    """The kernels a cached window of `s` tokens a row over `rows` rows
    launches in a model of `dims` (decoder layers, xattn blocks) with int8
    weights and cache: `int8_mlp` for every MLP and xattn FF at M = rows *
    s <= 32 (else `Int8Dense`), `decode_attention` for every layer at
    s = 1 (a window of s > 1 takes the dense path), `flash_fwd` for every
    xattn block where a row has more than 8 queries (fewer stay on the
    plain reference)."""
    layers, xattn = dims
    out = {}
    if rows * s <= 32:
        out["int8_mlp"] = layers + xattn
    if s == 1:
        out["decode_attention"] = layers
    if s > 8:
        out["flash_fwd"] = xattn
    return out


def spec_round_launches(rows: int, gamma: int,
                        dims=(SPEC_DRAFT, SPEC_TARGET)) -> dict:
    """A round's launches: the draft's s=2 opener and gamma-1 single steps,
    the target's s=gamma+1 verify window; `dims` the draft's and the
    target's (decoder layers, xattn blocks)."""
    draft, target = dims
    total = _add({}, window_launches(rows, 2, draft))
    for _ in range(gamma - 1):
        _add(total, window_launches(rows, 1, draft))
    return _add(total, window_launches(rows, gamma + 1, target))


def _spec_request(cfg, seed: int, length: int):
    """One unpadded request of serve's kind: (vision_x [1, 1, 1, 3, 224,
    224], ids [1, length]) with the media token first (numpy)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.eoc_token_id, (1, length)).astype(np.int64)
    ids[0, 0] = cfg.media_token_id
    size = cfg.vision.image_size
    return (rng.standard_normal((1, 1, 1, 3, size, size)).astype(np.float32),
            ids)


def _first_parting(got, want):
    if got == want:
        return None
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def _judge(tag, what, j, mine, other, got, want, partings):
    """A parting at token j: the logits behind it within PARITY_BAR
    max|other|, reported in `partings`."""
    if mine is None or other is None:
        raise RuntimeError(f"{tag}: {what} parts at token {j} ({got} "
                           f"against {want}) with no logits to judge")
    err = float((mine.float() - other.float()).abs().max())
    bar = PARITY_BAR * float(other.float().abs().max())
    partings.append(f"{what} parts at token {j} "
                    f"({got[j] if j < len(got) else 'end'} against "
                    f"{want[j] if j < len(want) else 'end'}): max |logits - "
                    f"the other's| {err:.4f} (bar {bar:.4f})")
    if not err <= bar:
        raise RuntimeError(f"{tag}: {partings[-1]}")


class _GenRecorder:
    """Wraps an eager `SpeculativeGenerator`'s round body, windows and
    first token: each round's launches; the target's logits behind each
    buffer column (a verify window's row j decides column pos + j, the
    prefill's last row the first token); the draft windows' logits by
    column, where the draft proposed. (It reads each window's position on
    the host: for the checks of eager runs, never timed.)"""

    def __init__(self, sg):
        from otter_tpu_torch.tools import bench_decode
        if sg.cuda_graph:
            raise RuntimeError("spec: the recorder needs the eager round")
        self.reset()
        rnd, window, first = sg._round_body, sg._window, sg._first_token
        g = sg.gamma

        def round_(*a, **k):
            before = bench_decode.kernel_launches()
            out = rnd(*a, **k)
            after = bench_decode.kernel_launches()
            self.launches.append({n: after[n] - before[n] for n in after
                                  if after[n] != before[n]})
            return out

        def window_(model, toks, cache, cache_pos, *a, **k):
            logits = window(model, toks, cache, cache_pos, *a, **k)
            s, pos = toks.shape[1], int(cache_pos)
            if s == g + 1:       # the verify window: row j decides pos + j
                for j in range(s):
                    self.verify[pos + j + 1] = logits[0, j]
            else:                # a draft window proposes its last column
                self.proposed[pos + s] = logits[0, -1]
            return logits

        def first_(logits, *a, **k):
            self.first = logits[0]
            return first(logits, *a, **k)

        sg._round_body, sg._window, sg._first_token = round_, window_, first_

    def reset(self):
        self.launches, self.verify, self.proposed, self.first = [], {}, {}, None

    def logits(self, p: int, j: int):
        return self.first if j == 0 else self.verify.get(p + j)


def _counting_rounds(sg) -> list:
    """Count `sg`'s rounds (its `_advance` calls: a replay or an eager
    round, live or queued past the end), one entry a round."""
    rounds, advance = [], sg._advance
    sg._advance = lambda st: (rounds.append(1), advance(st))[1]
    return rounds


def _busy_ms(fn, label: str) -> float:
    """torch.profiler over one whole call of `fn`: the device kernels'
    ms (`_report_profile`, its table in OUT_DIR)."""
    from torch.profiler import ProfilerActivity, profile
    import torch
    os.makedirs(OUT_DIR, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    name = "profile_" + "".join(c if c.isalnum() else "_" for c in label)
    return _report_profile(prof, wall, label, name[:120] + ".txt")[0] * 1e3


def _spec_vs_eager(tag, smi, graphed, eager, req, n_new, gen_kw, dims,
                   seed=None):
    """A speculative request of `n_new` tokens through a graphed
    `SpeculativeGenerator` (its round a CUDA graph, the card's default)
    and its eager twin (`cuda_graph=False`) in turns: tokens equal in
    every run of both and to `stream`'s; last_emitted and last_rounds
    equal; the launches of a round (every round `generate` queues, live or
    past the end) equal both ways and exactly `spec_round_launches`; no
    host sync in 8 rounds of either (the graphed ones replays); wall ms a
    round and a token both ways ((t(n_new) - t(1)) over the rounds run or
    the tokens after the first, medians of REPS), TTFT, the key's first
    request (its round captured), the capture's ms and pool; device ms a
    round both ways by torch.profiler over one whole round. `seed` seeds a
    sampled request's generator. Returns a dict of the readings."""
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import DONE_EVERY
    if not graphed.cuda_graph or eager.cuda_graph:
        raise RuntimeError(f"{tag}: the generators' graph settings "
                           f"{graphed.cuda_graph}, {eager.cuda_graph}")
    gen = lambda n: GenerationConfig(max_new_tokens=n, eos_token_id=-1,
                                     **gen_kw)
    seeded = lambda: (None if seed is None else
                      torch.Generator(device="cuda").manual_seed(seed))
    sgs = {"graphed": graphed, "eager": eager}
    rounds = {m: _counting_rounds(sg) for m, sg in sgs.items()}

    def run(mode, n):
        sg = sgs[mode]
        del rounds[mode][:]
        out = sg.generate(*req, gen=gen(n), generator=seeded())
        return out, (sg.last_emitted, sg.last_rounds, len(rounds[mode]))

    run("eager", 2)                         # the shapes' first use
    torch.cuda.synchronize()
    t = time.perf_counter()
    first, counts = run("graphed", n_new)
    first_s = time.perf_counter() - t
    entry = graphed._entries[-1]
    if entry.graph is None:
        raise RuntimeError(f"{tag}: no graph was captured")
    times = {(m, n): [] for m in sgs for n in (1, n_new)}
    outs, counted = [], {}
    for i in range(REPS):
        for mode in (("eager", "graphed") if i % 2 else ("graphed", "eager")):
            for n in (1, n_new):
                box = {}
                t = time.perf_counter()
                counted[(mode, n)] = _launches_of(
                    lambda: box.update(out=run(mode, n)))
                times[(mode, n)].append(time.perf_counter() - t)
                if n == n_new:
                    outs.append(box["out"])
    bad = [o for o in outs if not (np.array_equal(o[0], first)
                                   and o[1] == counts)]
    if bad:
        raise RuntimeError(f"{tag}: tokens or counts differ between runs or "
                           f"between the graphed and the eager round: "
                           f"{first.tolist()} {counts} against "
                           f"{bad[0][0].tolist()} {bad[0][1]}")
    launches = {}
    for mode in sgs:
        # (the last timed runs' counts: a replay adds what its capture
        # recorded)
        one, full = counted[(mode, 1)], counted[(mode, n_new)]
        launches[mode] = (one, {k: (v - one.get(k, 0)) / counts[2]
                                for k, v in full.items()
                                if v != one.get(k, 0)})
    want_round = spec_round_launches(1, graphed.gamma, dims)
    if not launches["graphed"] == launches["eager"] or \
            launches["graphed"][1] != want_round:
        raise RuntimeError(f"{tag}: (prefill, round) launches graphed "
                           f"{launches['graphed']}, eager "
                           f"{launches['eager']}, a round expected "
                           f"{want_round}")
    streamed = {m: list(sgs[m].stream(*req, gen=gen(n_new),
                                      generator=seeded())) for m in sgs}
    p = req[1].shape[1]
    if not streamed["graphed"] == streamed["eager"] == first[0, p:].tolist():
        raise RuntimeError(f"{tag}: stream gave {streamed}, generate "
                           f"{first[0, p:].tolist()}")
    dev = {}
    for mode, sg in sgs.items():
        g_, eos, cache_len = sg._setup(req[1], gen(n_new))
        st = sg._prefill(*req, None, g_, eos, seeded(), cache_len)
        try:
            sg._advance(st)
            if sg.cuda_graph and st.entry.graph is None:
                raise RuntimeError(f"{tag}: the key's round is not captured")
            torch.cuda.synchronize()
            # (a round launches ~10k kernels at full depth, and the
            # profiler's tables cost ~0.5 ms of host time an event: whole
            # requests under it took minutes)
            dev[mode] = _busy_ms(lambda: sg._advance(st),
                                 f"{tag} {mode} a round")
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(8):
                    sg._advance(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        finally:
            sg._finish(st)
    med = {k: float(np.median(v)) for k, v in times.items()}
    emitted, live, n_rounds = counts
    span = {m: (med[(m, n_new)] - med[(m, 1)]) * 1e3 for m in sgs}
    log(f"{tag}: tokens graphed = eager in {len(outs) + 1} runs and = "
        f"stream's, {emitted} tokens in the prefill and {live} rounds that "
        f"emitted ({(emitted - 1) / max(live, 1):.3f} tokens a round after "
        f"the first), {n_rounds} rounds run (the flag read once in "
        f"{DONE_EVERY} rounds); launches a prefill "
        f"{launches['graphed'][0]}, a round {launches['graphed'][1]} "
        f"(equal, exact); 8 rounds of each under "
        f"set_sync_debug_mode('error'): no host sync | wall ms a round "
        f"graphed {span['graphed'] / n_rounds:.3f}, eager "
        f"{span['eager'] / n_rounds:.3f} "
        f"({span['eager'] / span['graphed']:.2f}x); ms a token graphed "
        f"{span['graphed'] / (emitted - 1):.3f}, eager "
        f"{span['eager'] / (emitted - 1):.3f} | device ms a round graphed "
        f"{dev['graphed']:.3f}, eager {dev['eager']:.3f} (torch.profiler "
        f"over one whole round) | TTFT graphed {med[('graphed', 1)] * 1e3:.2f} "
        f"ms, eager {med[('eager', 1)] * 1e3:.2f} ms | the key's first "
        f"request (its round captured) {first_s * 1e3:.2f} ms, later "
        f"{med[('graphed', n_new)] * 1e3:.2f} ms | capture "
        f"{entry.capture_ms:.2f} ms, its memory pool {entry.pool_bytes} "
        f"bytes ({entry.pool_bytes / 2 ** 20:.1f} MiB) | medians of {REPS};"
        f" runs (ms) " + json.dumps({f"{m}/{n}": [round(x * 1e3, 2)
                                                 for x in v]
                                    for (m, n), v in times.items()})
        + f" | {smi}")
    return first


def _hold_spec_tokens(name, sg, engine, reqs, n_new, dims, self_draft):
    """Each request's `n_new` greedy tokens through an eager generator
    with a recorder against `generate` alone (partings judged by their
    logits), every round's launches exact; with the target as its own
    draft, every proposal accepted (or rejected at a bf16 near-tie between
    its s=1 and s=5 windows) and ceil((n_new - 1) / 5) rounds."""
    from otter_tpu_torch.config import GenerationConfig
    gen = GenerationConfig(max_new_tokens=n_new, eos_token_id=-1)
    rec = _GenRecorder(sg)
    want_round = spec_round_launches(1, SPEC_GAMMA, dims)
    full = math.ceil((n_new - 1) / (SPEC_GAMMA + 1))
    partings, rejected = [], []
    for vx, ids in reqs:
        rec.reset()
        got_full = sg.generate(vx, ids, gen=gen)
        bad = [x for x in rec.launches if x != want_round]
        if bad or not rec.launches:
            raise RuntimeError(f"spec: {name}: {len(bad)} of "
                               f"{len(rec.launches)} rounds launched "
                               f"otherwise than {want_round}: {bad[:2]}")
        p = ids.shape[1]
        got = got_full[0, p:].tolist()
        want = engine.generate(vx, ids, gen=gen)[0, p:].tolist()
        j = _first_parting(got, want)
        if j is not None:
            _judge("spec", f"{name}, the {p}-token request", j,
                   rec.logits(p, j),
                   _lone_logits(engine, vx, ids, j, eos_token_id=-1),
                   got, want, partings)
        if self_draft:
            # every proposal the target's own argmax: a rejection is a
            # bf16 near-tie between its s=1 and s=5 windows
            for c in sorted(rec.proposed):
                if c not in rec.verify or c >= p + n_new:
                    continue
                a, v = (int(rec.proposed[c].argmax()),
                        int(rec.verify[c].argmax()))
                if a != v:
                    _judge("spec", f"the self draft's proposal at column "
                           f"{c} of the {p}-token request (its s=1 "
                           f"window's {a}, the s=5 verify window's {v})",
                           c - p, rec.proposed[c], rec.verify[c], [a],
                           [v], rejected)
            if sg.last_rounds != full and not rejected:
                raise RuntimeError(
                    f"spec: the target as its own draft took "
                    f"{sg.last_rounds} rounds for {n_new} tokens, not "
                    f"{full}")
    log(f"spec: {name}: requests of {[r[1].shape[1] for r in reqs]} "
        f"tokens, {n_new} new each, through the eager round: every round "
        f"launched {want_round}; tokens equal to generate alone"
        f"{'' if not partings else ' but where they part: ' + '; '.join(partings)}"
        + ("" if not self_draft else
           f"; every proposal accepted, {n_new} tokens in the prefill and "
           f"{full} rounds" if not rejected else
           f"; {n_new} tokens in the prefill and {full} rounds but where a "
           f"proposal was rejected at a bf16 near-tie: "
           + "; ".join(rejected)))


def _spec_standalone(smi):
    """(a) `SpeculativeGenerator` at b=1 at full depth (OTTER-Image-MPT7B,
    32 layers, with the Flamingo-MPT-1B draft, 24 layers; int8 weights and
    KV caches), gamma 4, on serve's prompts: the MPT-1B draft greedy (16
    new tokens) and sampled (8) and the target as its own draft (32), each
    graphed against its eager twin (`_spec_vs_eager`), beside `generate`
    alone in the same call; the eager round's tokens against `generate`
    alone's (`_hold_spec_tokens`)."""
    import gc
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.generation.speculative import SpeculativeGenerator
    cfg, dcfg = serving_cfg(), draft_cfg()
    t0 = time.perf_counter()
    model, draft = build_model(cfg), build_model(dcfg)
    full_dims = (cfg.text.num_hidden_layers,
                 cfg.text.num_hidden_layers // cfg.cross_attn_every_n_layers)
    draft_dims = (dcfg.text.num_hidden_layers,
                  dcfg.text.num_hidden_layers
                  // dcfg.cross_attn_every_n_layers)
    log(f"spec: full depth: target {cfg.text.num_hidden_layers}-layer mpt "
        f"({_weight_bytes(model) / 1e9:.3f} GB, int8), draft "
        f"{dcfg.text.num_hidden_layers}-layer mosaic_gpt with "
        f"{draft_dims[1]} xattn blocks ({_weight_bytes(draft) / 1e9:.3f} "
        f"GB, int8), built in {time.perf_counter() - t0:.1f} s")
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    gen = lambda n: GenerationConfig(max_new_tokens=n, eos_token_id=-1)
    reqs = [_spec_request(cfg, SEED + 120 + i, n)
            for i, n in enumerate((48, 128, 96))]
    plain = {n: _timed(lambda n=n: engine.generate(*reqs[0], gen=gen(n)))[1]
             for n in (1, 32)}
    plain_step = [(a - b) / 31 for a, b in zip(plain[32], plain[1])]
    log(f"spec: generate alone (graphed), b=1, full depth, "
        f"{reqs[0][1].shape[1]}-token prompt: TTFT {plain[1]} ms, "
        f"{[round(x, 3) for x in plain_step]} ms a step, "
        f"{31e3 / float(np.median([a - b for a, b in zip(plain[32], plain[1])])):.2f}"
        f" tok/s | {smi}")
    make = lambda d, graph: SpeculativeGenerator(
        model, d, gamma=SPEC_GAMMA, cache_dtype=torch.int8,
        cuda_graph=None if graph else False)
    for name, d, dims, n_new, kw, seed in (
            ("the MPT-1B draft, greedy", draft, (draft_dims, full_dims), 16,
             {}, None),
            ("the MPT-1B draft, sampled (T 0.7, top-k 50, one seed)", draft,
             (draft_dims, full_dims), 8,
             dict(do_sample=True, temperature=0.7, top_k=50), SEED + 125),
            ("the target as its own draft, greedy", model,
             (full_dims, full_dims), 32, {}, None)):
        _spec_vs_eager(f"spec: {name}, b=1, full depth, gamma {SPEC_GAMMA},"
                       f" {reqs[0][1].shape[1]}-token prompt", smi,
                       make(d, True), make(d, False), reqs[0], n_new, kw,
                       dims, seed)
        if not kw:
            self_draft = d is model
            _hold_spec_tokens(name, make(d, False), engine, reqs[:2], n_new,
                              dims, self_draft)
    del model, draft, engine
    gc.collect()
    torch.cuda.empty_cache()


class _PoolRecorder:
    """Wraps a speculative pool's rounds, plain steps, catch-ups and first
    tokens (they run on its scheduler thread): the launches and the host
    clock of each, in order, and, kept on the card until read, each round's
    (out, e) with the verify window's logits and each plain step's logits
    and tokens, with the prompt length of each row's request (None for a
    free row)."""

    def __init__(self, b):
        from otter_tpu_torch.tools import bench_decode
        self.events, self.first = [], {}
        counts = bench_decode.kernel_launches
        model, rnd, step = b.model, b._spec_round, b._decode_step
        first, catchup = b._first_token, b._run_catchup
        seen = {}

        def owners():
            return [s.real_len if s.active else None for s in b._slots]

        def timed(kind, fn, *a, **k):
            before, t = counts(), time.perf_counter()
            out = fn(*a, **k)
            after = counts()
            self.events.append(dict(kind=kind, t=t, owners=owners(),
                                    launches={n: after[n] - before[n]
                                              for n in after
                                              if after[n] != before[n]}))
            return out

        class Verify:
            """The target with its multi-token cached windows' logits
            kept (the verify window is the target's only s > 1 cached
            call in a round)."""

            def __call__(self, *a, **k):
                out = model(*a, **k)
                if k.get("cache_pos") is not None and a[1].shape[1] > 1:
                    seen["logits"] = out[0]
                return out

            def __getattr__(self, name):
                return getattr(model, name)

        def round_(ca, st, lp, g):
            out = timed(("spec", g), rnd, ca, st, lp, g)
            self.events[-1].update(out=out[0], e=out[1],
                                   logits=seen.pop("logits"))
            return out

        def step_(ca, st, lp, need_logits=False):
            # (the step advances the carried state in place)
            emitted = ca["emitted"].clone()
            out = timed("plain", step, ca, st, lp, True)
            self.events[-1].update(emitted=emitted, logits=out[4],
                                   nxt=out[0].clone())
            return out if need_logits else out[:4]

        def first_(logits, ids, bucket, real, gen):
            tok = first(logits, ids, bucket, real, gen)
            self.first[real] = (logits[0], tok)
            return tok

        b.model, b._spec_round, b._decode_step = Verify(), round_, step_
        b._first_token = first_
        b._run_catchup = lambda: timed("catchup", catchup)

    def tokens(self, real_len: int):
        """A request's tokens and the logits behind each."""
        logits, tok = self.first[real_len]
        out = [(int(tok[0]), logits)]
        for ev in self.events:
            if real_len not in ev["owners"] or ev["kind"] == "catchup":
                continue
            i = ev["owners"].index(real_len)
            if ev["kind"] == "plain":
                if int(ev["emitted"][i]) == len(out):
                    out.append((int(ev["nxt"][i]), ev["logits"][i]))
                continue
            for j in range(int(ev["e"][i])):
                out.append((int(ev["out"][i, j]), ev["logits"][i, j]))
        return out


class _KeyRecorder:
    """Wraps a pool's `_graphed` (every plain step, round and catch-up
    goes through it, graphed or eager; a replay calls no other Python):
    each call's kind (from its key), launches, host clock and the rows'
    owners (the prompt length of each row's request, None for a free
    row)."""

    def __init__(self, b):
        from otter_tpu_torch.tools import bench_decode
        counts, graphed = bench_decode.kernel_launches, b._graphed
        self.events = []

        def wrapped(key, body):
            before, t = counts(), time.perf_counter()
            out = graphed(key, body)
            after = counts()
            self.events.append(dict(
                kind=(("spec", key[1]) if key[0] == "spec" else
                      "catchup" if key == ("catchup",) else "plain"),
                t=t, owners=[s.real_len if s.active else None
                             for s in b._slots],
                launches={n: after[n] - before[n] for n in after
                          if after[n] != before[n]}))
            return out

        b._graphed = wrapped


def _stop_scheduler(b):
    """The pool's threads ended, its graphs and tensors kept (`shutdown`
    frees the graphs)."""
    b._stop = True
    b._work.set()
    b._thread.join(10)
    b._finisher.join(10)


def _pool_round_readings(tag, b, graphed: bool):
    """On a pool whose threads ended: the device ms of a round of gamma
    SPEC_GAMMA over its 8 rows (torch.profiler over one round: its
    graph's replay, or the eager round body) and, graphed, 8
    replays under set_sync_debug_mode("error") and each graph's capture
    ms and pool. Returns (device ms, a description of the graphs)."""
    import torch
    if graphed:
        keys = [k for k in b._graphs if k[:2] == ("spec", SPEC_GAMMA)]
        if not keys:
            raise RuntimeError(f"{tag}: no round of gamma {SPEC_GAMMA} "
                               f"captured: {list(b._graphs)}")
        one = b._graphs[keys[0]].graph.replay
    else:
        one = lambda: b._spec_body(SPEC_GAMMA)
    one()
    torch.cuda.synchronize()
    ms = _busy_ms(one, f"{tag} {'graphed' if graphed else 'eager'} a round")
    if not graphed:
        return ms, ""
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(8):
            one()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return ms, "; ".join(
        f"{k}: capture {g.capture_ms:.1f} ms, pool "
        f"{g.pool_bytes / 2 ** 20:.1f} MiB" for k, g in b._graphs.items())


def _spec_pool(smi, model, draft, cfg, engine):
    """(b) `ContinuousBatcher(num_slots=8, cache_len=2048, draft=MPT-1B,
    spec_gamma=4)` at half depth, the controller off then on, over 8
    greedy requests and one sampled, each through a graphed pool (its
    rounds, plain steps and catch-up CUDA graphs, the card's default) and
    an eager one (`cuda_graph=False`) in turns: the wall and the launches
    of a round, a round's device ms, the modes the controller chose, the
    eager pool's greedy tokens against the draft-free pool's (partings
    judged by their logits), the graphed pool's against the eager pool's
    (partings judged by `generate` alone's logits), no host sync in 8
    replayed rounds."""
    from dataclasses import replace
    import numpy as np
    import torch
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    every = batch_requests(cfg, SEED + 130)
    reqs = [r for r in every if r[0] == "greedy"][:16:2]
    # the sampled request waits for a slot: 8 new tokens keep its tail short
    kind, req, gen = [r for r in every if r[0] == "sampled"][0]
    reqs.append((kind, req, replace(gen, max_new_tokens=8)))

    def pool(**kw):
        return ContinuousBatcher(model, num_slots=8, cache_len=2048,
                                 cache_dtype=torch.int8, rng_seed=SEED, **kw)

    for graph in (None, False):
        warm = pool(draft=draft, spec_gamma=SPEC_GAMMA, spec_adaptive=False,
                    cuda_graph=graph)
        try:
            _run_requests(warm, [(k, r, replace(g, max_new_tokens=4))
                                 for k, r, g in reqs[:2]], 2, 0.0)
        finally:
            warm.shutdown()
    b = pool()
    free_rec = _StepRecorder(b)
    try:
        free, _, _, free_wall = _run_requests(b, reqs, 8, 0.0)
    finally:
        b.shutdown()
    free_tok = sum(len(f) for f in free)
    log(f"spec pool: the draft-free pool (graphed) on the same requests: "
        f"{free_tok} tokens in {free_wall * 1e3:.1f} ms "
        f"({free_tok / free_wall:.2f} tok/s) | {smi}")
    plain_step = window_launches(8, 1, SPEC_TARGET)
    rounds = {g: spec_round_launches(8, g) for g in (SPEC_GAMMA,
                                                     SPEC_GAMMA // 2)}
    # the draft's catch-up window: 256 columns a row (2048 less the
    # largest bucket, 1024, capped at 256)
    catchup = window_launches(8, 256, SPEC_DRAFT)
    for adaptive in (False, True):
        runs = {}
        for graphed in ((False, True) if adaptive else (True, False)):
            b = pool(draft=draft, spec_gamma=SPEC_GAMMA,
                     spec_adaptive=adaptive,
                     cuda_graph=None if graphed else False)
            if b.cuda_graph != graphed:
                raise RuntimeError(f"spec pool: cuda_graph {b.cuda_graph}")
            # the controller's cadence cut from 32 / 8 to 4 / 2 iterations,
            # so that a run of 32 tokens sees it probe the other modes and
            # choose
            b._replan_every, b._probe_len = 4, 2
            rec = _KeyRecorder(b)
            logits_rec = None if graphed else _PoolRecorder(b)
            tag = (f"spec pool (adaptive {'on' if adaptive else 'off'}, "
                   f"{'graphed' if graphed else 'eager'})")
            try:
                got, _, _, wall = _run_requests(b, reqs, 8, 0.0)
                stats = b.stats()
                if b._failure is not None:
                    raise RuntimeError("spec: the pool failed") \
                        from b._failure
                _stop_scheduler(b)
                dev_ms, graphs = _pool_round_readings(tag, b, graphed)
            finally:
                b.shutdown()
            runs[graphed] = dict(tag=tag, got=got, rec=rec, wall=wall,
                                 logits_rec=logits_rec, stats=stats,
                                 dev_ms=dev_ms, graphs=graphs)
        for graphed in (False, True):
            r = runs[graphed]
            tag, got, rec, stats = r["tag"], r["got"], r["rec"], r["stats"]
            for ev in rec.events:
                want = (catchup if ev["kind"] == "catchup" else plain_step
                        if ev["kind"] == "plain" else rounds[ev["kind"][1]])
                if ev["launches"] != want:
                    raise RuntimeError(f"{tag}: a {ev['kind']} launched "
                                       f"{ev['launches']}, not {want}")
            kinds = [ev["kind"] for ev in rec.events]
            spec_t = [b_["t"] - a_["t"] for a_, b_ in zip(rec.events,
                                                          rec.events[1:])
                      if a_["kind"] == b_["kind"] == ("spec", SPEC_GAMMA)
                      and sum(o is not None for o in a_["owners"]) == 8]
            partings = []
            for i, ((kind, req, gen), g) in enumerate(zip(reqs, got)):
                if kind != "greedy":
                    continue
                real = req[1].shape[1]
                if not graphed:
                    j = _first_parting(g, free[i])
                    if j is not None:
                        mine = r["logits_rec"].tokens(real)
                        theirs = free_rec.tokens(real)
                        _judge(tag, f"the {real}-token request against the "
                               f"draft-free pool", j,
                               mine[j][1] if j < len(mine) else None,
                               theirs[j][1] if j < len(theirs) else None,
                               g, free[i], partings)
                    continue
                want = runs[False]["got"][i]
                j = _first_parting(g, want)
                if j is not None:
                    # (a round and a plain step round otherwise in bf16,
                    # and the controller's choices follow the host clock)
                    lone = _lone_logits(engine, *req, j)
                    mine = g[j] if j < len(g) else cfg.eoc_token_id
                    gap = float(lone.max() - lone[mine])
                    bar = PARITY_BAR * float(lone.abs().max())
                    partings.append(f"the {real}-token request parts from "
                                    f"the eager pool's at token {j}: its "
                                    f"token {gap:.4f} below generate alone's"
                                    f" argmax (bar {bar:.4f})")
                    if not gap <= bar:
                        raise RuntimeError(f"{tag}: {partings[-1]}")
            n_tok = sum(len(g) for g in got)
            log(f"{tag}: 8 greedy requests of 32-128 tokens (32 new tokens) "
                f"and one sampled (8), one 224x224 image each, through 8 "
                f"slots with the MPT-1B draft, gamma {SPEC_GAMMA}: {n_tok} "
                f"tokens in {r['wall'] * 1e3:.1f} ms "
                f"({n_tok / r['wall']:.2f} tok/s); "
                f"{kinds.count(('spec', SPEC_GAMMA))} rounds of gamma "
                f"{SPEC_GAMMA}, {kinds.count(('spec', SPEC_GAMMA // 2))} of "
                f"gamma {SPEC_GAMMA // 2}, {kinds.count('plain')} plain "
                f"steps, {kinds.count('catchup')} catch-ups (controller "
                f"cadence 4 / 2 iterations), each launching exactly "
                f"{rounds[SPEC_GAMMA]}, {rounds[SPEC_GAMMA // 2]}, "
                f"{plain_step}, {catchup}; a round at 8 rows "
                f"{np.median(spec_t) * 1e3 if spec_t else float('nan'):.2f}"
                f" ms wall (median of {len(spec_t)} between round "
                f"dispatches), {r['dev_ms']:.3f} ms device (one round, "
                f"torch.profiler)"
                + (f"; 8 replayed rounds under set_sync_debug_mode('error'):"
                   f" no host sync; graphs {r['graphs']}" if graphed else "")
                + f"; controller: mode {stats['spec']['mode']}, tokens a "
                f"round "
                f"{ {k: round(v, 3) for k, v in stats['spec']['accept_ema_tok_per_round'].items()} }, "
                f"s an iteration "
                f"{ {k: round(v, 5) for k, v in stats['spec']['iter_time_ema_s'].items()} }; "
                f"greedy tokens equal to the "
                f"{'eager pool' if graphed else 'draft-free pool'}'s"
                f"{'' if not partings else ' but where they part: ' + '; '.join(partings)}"
                f" | {smi}")
        del runs
    del free_rec


def _session_no_sync(tag, routes):
    """8 replays of each live session's step or round under
    set_sync_debug_mode("error"), from a turn's state leased in the
    session (its last key's) as its stream does."""
    from dataclasses import replace
    import torch
    for name in ("sessions", "spec_sessions"):
        if name not in routes:
            continue
        for sess in list(routes[name]._pool.values()):
            if not sess.steps._entries or sess.tensors is None:
                continue
            last = sess.steps._entries[-1].st
            gen = replace(last.gen, max_new_tokens=16)
            with torch.inference_mode():
                if name == "sessions":
                    st = sess._turn(gen, last.eos, last.logits.clone(), None)
                else:
                    tok0 = torch.tensor(sess.real_tokens[-1], device="cuda")
                    st = sess._turn(gen, last.eos, tok0, None)
            try:
                sess.steps._advance(st)
                if st.entry.graph is None:
                    raise RuntimeError(f"{tag}: a session's step is not "
                                       f"captured")
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(8):
                        sess.steps._advance(st)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            finally:
                sess.steps._finish(st)


def _spec_worker(smi, model, draft, engine, cfg):
    """(c) The worker in-process over localhost HTTP, built as the worker
    builds it (`_session_and_spec`) with `--draft-checkpoint` and
    `--session-cache 2`, then with `--session-cache 2` alone, each graphed
    (the card's default) and with `cuda_graph=False`: a 3-turn
    conversation under one session id, each turn sent to the graphed,
    the eager and the stateless worker in turns: texts graphed = eager
    (and = the stateless worker's, or parting at a near-tie of the
    stateless logits), the launches of a turn equal both ways, the time to
    the first chunk and ms a token of each; no host sync in 8 replays of
    each session's step or round; the graphs' capture ms and pools (one a
    live session); then two sessions and a third: the least recently used
    is evicted with its graphs."""
    import types
    import numpy as np
    import torch
    from otter_tpu_torch.generation.engine import held_pool_bytes
    from otter_tpu_torch.serve.worker import (ModelWorker, _session_and_spec,
                                              build_app,
                                              decode_media_to_vision_x,
                                              make_otter_stream_fn,
                                              run_app_in_thread)
    tok = otter_tokenizer(cfg)
    args = types.SimpleNamespace(session_cache=2, cache_len=2048,
                                 draft_gamma=SPEC_GAMMA)
    urls, stops, workers, routes = {}, [], [], {}
    try:
        for name, d, graph in (("spec graphed", draft, None),
                               ("spec eager", draft, False),
                               ("session graphed", None, None),
                               ("session eager", None, False),
                               ("stateless", None, None)):
            kw = {} if name == "stateless" else _session_and_spec(
                args, model, d, torch.int8, cuda_graph=graph)
            routes[name] = kw
            port = _free_port()
            w = ModelWorker(controller_addr="", worker_addr="",
                            model_name="otter", no_register=True,
                            stream_fn=make_otter_stream_fn(engine, tok, cfg,
                                                           **kw))
            workers.append(w)
            stops.append(run_app_in_thread(build_app(w), "127.0.0.1", port))
            urls[name] = f"http://127.0.0.1:{port}/worker_generate_stream"
        first = worker_requests(cfg, 1, SEED + 140, new_tokens=16)[0]
        for name in urls:
            post_stream(urls[name], dict(first, session_id="warm"))
        for kind in ("spec", "session"):
            pool_name = "spec_sessions" if kind == "spec" else "sessions"
            rng = np.random.default_rng(SEED + 141)
            req, rows, partings = dict(first, session_id="chat"), [], []
            for turn in range(3):
                res = {}
                order = ("graphed", "eager") if turn % 2 else ("eager",
                                                              "graphed")
                for mode in order + ("stateless",):
                    url = urls["stateless" if mode == "stateless"
                               else f"{kind} {mode}"]
                    launched = {}

                    def post(url=url, launched=launched):
                        launched["out"] = post_stream(url, req)
                    counts = _launches_of(post)
                    got, t_first, t_last = launched["out"]
                    text = _final_text(got, f"a {kind} {mode} turn")
                    res[mode] = (text, t_first, t_last, counts)
                a, e_, b_ = (res[m][0] for m in ("graphed", "eager",
                                                 "stateless"))
                if a != e_ or res["graphed"][3] != res["eager"][3]:
                    raise RuntimeError(
                        f"spec worker ({kind}): turn {turn + 1}: graphed "
                        f"{a!r} / launches {res['graphed'][3]}, eager "
                        f"{e_!r} / {res['eager'][3]}")
                stats = dict(routes[f"{kind} graphed"][pool_name]
                             .get("chat").last_stats)
                if a != b_:
                    ga = [int(t[1:]) for t in a.split()]
                    wb = [int(t[1:]) for t in b_.split()]
                    j = _first_parting(ga, wb)
                    vx, _ = decode_media_to_vision_x(req["images"],
                                                     cfg.vision.image_size)
                    ids = tok(req["prompt"], return_tensors="np")["input_ids"]
                    lone = _lone_logits(engine, vx, ids, j)
                    mine = ga[j] if j < len(ga) else cfg.eoc_token_id
                    gap = float(lone.max() - lone[mine])
                    bar = PARITY_BAR * float(lone.abs().max())
                    partings.append(f"turn {turn + 1} parts at token {j}: "
                                    f"the session's token {gap:.4f} below "
                                    f"the stateless argmax (bar {bar:.4f})")
                    if not gap <= bar:
                        raise RuntimeError(f"spec worker: {partings[-1]}")
                n = len(a.split())
                per_tok = {m: (res[m][2] - res[m][1]) * 1e3 / max(n - 2, 1)
                           for m in res}
                rows.append(
                    f"turn {turn + 1} ({len(tok(req['prompt'])['input_ids'])}"
                    f" prompt tokens; reused {stats['reused']}, window "
                    f"{stats['window']} padded to {stats['window_pad']}; "
                    f"{n} tokens): first chunk graphed "
                    f"{res['graphed'][1] * 1e3:.2f} ms, eager "
                    f"{res['eager'][1] * 1e3:.2f}, stateless "
                    f"{res['stateless'][1] * 1e3:.2f}; ms a token after it "
                    f"graphed {per_tok['graphed']:.2f}, eager "
                    f"{per_tok['eager']:.2f}, stateless "
                    f"{per_tok['stateless']:.2f}; launches of the turn "
                    f"{res['graphed'][3]} both ways")
                user = " ".join(f"t{i}" for i in rng.integers(
                    1, cfg.eoc_token_id, 24))
                req = dict(req, prompt=req["prompt"] + a
                           + f" <|endofchunk|> {user}")
            graphed = routes[f"{kind} graphed"]
            _session_no_sync(f"spec worker ({kind})", graphed)
            pool = graphed[pool_name]
            pools = "; ".join(
                f"session {sid}: " + ", ".join(
                    f"capture {e.capture_ms:.1f} ms, pool "
                    f"{e.pool_bytes / 2 ** 20:.1f} MiB"
                    for e in sess.steps._entries)
                for sid, sess in pool._pool.items())
            held = lambda: sum(e.pool_bytes for sess in pool._pool.values()
                               for e in sess.steps._entries
                               if e.graph is not None)
            before, old = held(), list(pool._pool.values())
            for sid in ("A", "B", "C"):
                post_stream(urls[f"{kind} graphed"], dict(
                    first, session_id=sid,
                    generation_kwargs={"max_new_tokens": 4}))
            kept = sorted(pool._pool)
            if kept != ["B", "C"] or any(s_.steps._entries for s_ in old):
                raise RuntimeError(f"spec worker: after sessions chat, A, B,"
                                   f" C in a pool of 2 it holds {kept}, the "
                                   f"evicted sessions' graphs "
                                   f"{[len(s_.steps._entries) for s_ in old]}")
            log(f"spec worker ({'--draft-checkpoint MPT-1B, ' if kind == 'spec' else ''}"
                f"--session-cache 2{', gamma ' + str(SPEC_GAMMA) if kind == 'spec' else ''}"
                f"; 16 new tokens a turn; the first chunk carries 2 tokens;"
                f" graphed and eager workers in turns): " + "; ".join(rows)
                + "; texts graphed = eager, and equal to the stateless "
                f"worker's"
                f"{'' if not partings else ' but where they part: ' + '; '.join(partings)}"
                f"; 8 replays of each live session's "
                f"{'round' if kind == 'spec' else 'step'} under "
                f"set_sync_debug_mode('error'): no host sync; graphs of the "
                f"live sessions: {pools} ({before / 2 ** 20:.1f} MiB of pools "
                f"in the session pool; every live graph on the card "
                f"{held_pool_bytes(model.device) / 2 ** 20:.1f} MiB); after "
                f"sessions chat, A, B and C the pool holds {kept} (the "
                f"least recently used evicted and their graphs freed; the "
                f"session pool's graphs now {held() / 2 ** 20:.1f} MiB) "
                f"| {smi}")
    finally:
        for stop in stops:
            stop()
        for w in workers:
            w.close()


def phase_spec(smi: str):
    """Speculative decoding and the session cache on OTTER-MPT7B (int8
    weights and KV cache, decode_kernel="auto") with a Flamingo-MPT-1B
    draft (int8), each graphed (the card's default) and eager in turns:
    (a) the standalone generator at b=1 at full depth, then, both models
    at full width and half their depth (`SPEC_TARGET`, `SPEC_DRAFT`), (b)
    the slot pool with the draft, (c) the worker with a draft and a
    session cache, and with a session cache alone. Returns the phase's
    launches."""
    import torch
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.tools import bench_decode
    bench_decode.reset_kernel_launches()
    t0 = time.perf_counter()
    _spec_standalone(smi)
    walls = {"standalone": time.perf_counter() - t0}
    cut = lambda c, n: c.replace(text=c.text.replace(num_hidden_layers=n))
    cfg = cut(serving_cfg(), SPEC_TARGET[0])
    t0 = time.perf_counter()
    model = build_model(cfg)
    dcfg = cut(draft_cfg(), SPEC_DRAFT[0])
    draft = build_model(dcfg)
    log(f"spec: half depth: target {cfg.text.num_hidden_layers}-layer mpt "
        f"({_weight_bytes(model) / 1e9:.3f} GB, int8), draft "
        f"{dcfg.text.num_hidden_layers}-layer mosaic_gpt with "
        f"{dcfg.text.num_hidden_layers} xattn blocks "
        f"({_weight_bytes(draft) / 1e9:.3f} GB, int8), int8 KV caches, "
        f"built in {time.perf_counter() - t0:.1f} s")
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    t0 = time.perf_counter()
    _spec_pool(smi, model, draft, cfg, engine)
    walls["pool"] = time.perf_counter() - t0
    _spec_worker(smi, model, draft, engine, cfg)
    walls["worker"] = time.perf_counter() - t0 - walls["pool"]
    log(f"spec: part walls (s) "
        + json.dumps({k: round(v, 1) for k, v in walls.items()}))
    return {k: v for k, v in bench_decode.kernel_launches().items() if v}


def phase_profile(run, tag: str):
    """torch.profiler over one request served by `run(n_new)`: the prefill
    alone (1 new token), then the prefill + 31 decode steps; a decode
    step's device time and launches from the difference. Writes the kernel
    tables to OUT_DIR and prints the device-busy share and the top
    kernels. Returns (device ms, kernel launches) a decode step."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(OUT_DIR, exist_ok=True)
    seen = {}
    for n_new in (1, 32):
        run(n_new)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run(n_new)
            wall = time.perf_counter() - t
        seen[n_new] = _report_profile(
            prof, wall, f"profile {tag} new={n_new}",
            f"profile_{tag.replace(' ', '_').replace('=', '')}_new{n_new}"
            f".txt") + (wall,)
    (b0, n0, w0), (b1, n1, w1) = seen[1], seen[32]
    log(f"profile {tag}: a decode step takes {(b1 - b0) / 31 * 1e3:.3f} ms "
        f"of device kernels in {(n1 - n0) / 31:.1f} launches; "
        f"{(w1 - w0) / 31 * 1e3:.3f} ms of wall time under the profiler")
    return (b1 - b0) / 31 * 1e3, (n1 - n0) / 31


def _profile_engine(engine, tag: str):
    """`phase_profile` of a b=8 request through `OtterGenerator.generate`."""
    from otter_tpu_torch.config import GenerationConfig
    req = make_requests(engine.cfg, 8, SEED + 18)
    phase_profile(lambda n_new: engine.generate(
        *req, gen=GenerationConfig(max_new_tokens=n_new, eos_token_id=-1)),
        f"{tag} b=8")


def _report_profile(prof, wall: float, label: str, fname: str):
    """Device-busy share, launch count and the top kernels of a
    torch.profiler run; the whole table goes to OUT_DIR/<fname>."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    busy = sum(dev_us(e) for e in kern) / 1e6
    kern.sort(key=dev_us, reverse=True)
    path = os.path.join(OUT_DIR, fname)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=80))
    log(f"{label}: wall {wall * 1e3:.2f} ms, device kernels "
        f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% busy), "
        f"{sum(e.count for e in kern)} kernel launches; table in {path}")
    for e in kern[:15]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    return busy, sum(e.count for e in kern)


# ── phase 8: the fused decode routes through the decode bench ───────

FUSED_RUNS = (
    ("composed", dict(cache_bit="bf16"),
     {"int8_mlp": 40, "decode_attention": 0, "decode_attn_megakernel": 0,
      "int8_attn_tail": 0}),
    ("megakernel", dict(megakernel=True, cache_bit="bf16"),
     {"int8_mlp": 40, "decode_attention": 0, "decode_attn_megakernel": 32,
      "int8_attn_tail": 0}),
    ("fused_tail", dict(fused_tail=True, cache_bit="int8",
                        decode_kernel="auto"),
     {"int8_mlp": 8, "decode_attention": 32, "decode_attn_megakernel": 0,
      "int8_attn_tail": 32}),
)


def phase_fused(smi: str, profile: bool = False):
    """`tools/bench_decode.run` at full width and depth, b=8: the composed
    decode layer, the megakernel route and the fused-tail route."""
    from otter_tpu_torch.tools import bench_decode

    bench_decode.reset_kernel_launches()
    results, failed = {}, []
    for name, kw, want in FUSED_RUNS:
        res = results[name] = bench_decode.run(batch=8, device=DEV,
                                               seed=SEED, **kw)
        got = res["launches_per_step"]
        log(f"fused[{name}]: {res['layers']}-layer OTTER-MPT7B int8, b=8, "
            f"prompt 128, cache {res['cache_len']} {res['cache_bit']} | "
            f"step {res['step_ms']:.3f} ms ({res['tokens_per_s']:.2f} tok/s), "
            f"estimates {[round(x, 3) for x in res['step_ms_estimates']]} "
            f"ms | device step {res['device_step_ms']:.3f} ms, estimates "
            f"{[round(x, 3) for x in res['device_step_ms_estimates']]} "
            f"({res['device_step_profiles']} profiles: two a third where "
            f"none lost a record) | reads {res['decode_step_bytes'] / 1e9:.3f} GB a step: "
            f"roofline {res['roofline_ms']:.3f} ms, share "
            f"{100 * res['roofline_share']:.2f}% of 3.35 TB/s | weights "
            f"{res['weight_bytes'] / 1e9:.3f} GB on the card | launches a "
            f"step {got} | first tokens {res['first_tokens']} | {smi}")
        if any(got[k] != n for k, n in want.items()):
            failed.append(f"{name}: launches a step {got}, expected {want}")
        if not res["tokens_equal"]:
            failed.append(f"{name}: greedy output differs between runs")
        if not res["tokens_valid"]:
            failed.append(f"{name}: output shape or a token outside the "
                          f"vocabulary")
        if not (math.isfinite(res["step_ms"]) and res["step_ms"] > 0):
            failed.append(f"{name}: step time {res['step_ms']}")
        if not (math.isfinite(res["device_step_ms"])
                and res["device_step_ms"] > 0):
            failed.append(f"{name}: device step {res['device_step_ms']} ms")
    launches = bench_decode.kernel_launches()
    extra = (results["megakernel"]["weight_bytes"]
             - results["composed"]["weight_bytes"])
    d = 4096
    want_extra = 32 * (4 * d * d + 4 * 4 * d)   # wqo_q + wqo_scale a layer
    log(f"fused: the megakernel's weights take {extra / 1e9:.4f} GB more on "
        f"the card than the composed route's (32 x [4096, 16384] int8 + "
        f"scales = {want_extra / 1e9:.4f} GB)")
    if extra != want_extra:
        failed.append(f"fused copy of Wqkv | Wo: {extra} bytes, expected "
                      f"{want_extra}")
    base = results["composed"]["step_ms"]
    log("fused: step time against the composed route of this call: "
        + ", ".join(f"{n} {results[n]['step_ms'] / base:.3f}x"
                    for n in ("megakernel", "fused_tail")))
    if failed:
        raise RuntimeError("fused phase failed: " + "; ".join(failed))
    if profile:
        _profile_fused()
    return launches


def _profile_layer_routes():
    """One full-width decoder layer (int8 weights, b=8, one new token at
    position 200 of a bf16 cache of 256) on the composed, megakernel and
    fused-tail routes, the same weights and cache for all three: device ms
    and kernel launches a call, from torch.profiler over 20 calls. What a
    fused route replaces is the composed layer less what the two share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.models.decoder import DecoderLayer, init_cache
    from otter_tpu_torch.ops import quant
    from otter_tpu_torch.ops.masks import alibi_slopes

    text = serving_cfg().text.replace(megakernel=True, decode_kernel=False)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 50)
    layer = DecoderLayer(text, torch.bfloat16, DEV)
    flat = {}
    for name, t in list(layer.named_buffers()) + list(layer.named_parameters()):
        if name.endswith("kernel_q"):
            q, sc = quant.quantize_kernel(0.02 * torch.randn(
                t.shape, generator=gen, device=DEV))
            flat[name], flat[name[:-len("kernel_q")] + "scale_q"] = q, sc
        elif name.endswith(".scale"):
            flat[name] = 1 + 0.02 * torch.randn(t.shape, generator=gen,
                                                device=DEV)
    fused = quant.add_fused_wqo(
        {"layers_0/" + k.replace(".", "/"): v for k, v in flat.items()})
    state = dict(layer.named_buffers())
    state.update(layer.named_parameters())
    with torch.no_grad():
        for k, v in fused.items():
            state[k[len("layers_0/"):].replace("/", ".")].copy_(v)
    b, L, pos, nl = 8, 256, 200, text.num_hidden_layers
    cache = init_cache(text.replace(num_hidden_layers=4), b, L,
                       torch.bfloat16, DEV)
    for t in cache.values():
        t.normal_(generator=gen)
    x = torch.randn(b, 1, text.hidden_size, generator=gen, device=DEV,
                    dtype=torch.bfloat16)
    bias = (torch.arange(L, device=DEV)[None, None, None, :]
            * alibi_slopes(text.num_attention_heads,
                           device=DEV)[None, :, None, None])
    kv_valid = (torch.arange(L, device=DEV) <= pos)[None].expand(b, L)
    outs = {}
    for route in ("composed", "megakernel", "fused_tail"):
        layer.cfg = text.replace(megakernel=route == "megakernel",
                                 fused_tail=route == "fused_tail")
        it = iter(range(10 ** 9))

        def call():
            with torch.inference_mode():
                return layer(x, layer=next(it) % 4, bias=bias, cache=cache,
                             cache_pos=pos, kv_valid=kv_valid)

        outs[route] = call()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, n = _report_profile(
            prof, wall, f"profile layer[{route}] 20 calls",
            f"profile_layer_{route}.txt")
        err = float((outs[route].float() - outs["composed"].float())
                    .abs().max())
        log(f"profile layer[{route}]: {busy / 20 * 1e3:.4f} ms of device "
            f"kernels and {n / 20:.1f} launches a call ({nl} layers a step: "
            f"{busy / 20 * nl * 1e3:.2f} ms, {n / 20 * nl:.0f} launches); "
            f"max |out - composed| {err:.3e}")


def _profile_fused():
    """torch.profiler over b=8 requests of 16 and 48 new tokens on each
    fused run's model: device ms and kernel launches a decode step from
    the difference of the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.config import GenerationConfig, otter_mpt7b
    from otter_tpu_torch.generation.engine import OtterGenerator

    _profile_layer_routes()
    dtypes = {"bf16": torch.bfloat16, "int8": torch.int8}
    for name, kw, _ in FUSED_RUNS:
        cfg = otter_mpt7b()
        cfg = cfg.replace(text=cfg.text.replace(
            quant="int8", megakernel=kw.get("megakernel", False),
            fused_tail=kw.get("fused_tail", False),
            decode_kernel=kw.get("decode_kernel", cfg.text.decode_kernel)))
        engine = OtterGenerator(build_model(cfg),
                                cache_dtype=dtypes[kw["cache_bit"]])
        req = make_requests(cfg, 8, SEED + 19, full=True)[:2]
        seen = {}
        for n_new in (16, 48):
            gen_cfg = GenerationConfig(max_new_tokens=n_new, eos_token_id=-1)
            engine.generate(*req, gen=gen_cfg)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                engine.generate(*req, gen=gen_cfg)
                wall = time.perf_counter() - t
            seen[n_new] = _report_profile(
                prof, wall, f"profile fused[{name}] b=8 new={n_new}",
                f"profile_fused_{name}_new{n_new}.txt") + (wall,)
        (b0, n0, w0), (b1, n1, w1) = seen[16], seen[48]
        log(f"profile fused[{name}]: a decode step takes "
            f"{(b1 - b0) / 32 * 1e3:.3f} ms of device kernels in "
            f"{(n1 - n0) / 32:.1f} launches; {(w1 - w0) / 32 * 1e3:.3f} ms "
            f"of wall time under the profiler")
        del engine


# ── phase 6: one SFT step, kernel path against the plain path ──────

FLASH_COUNTERS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def _flash_wrappers():
    from otter_tpu_torch.ops import flash_attention as fa
    return {"flash_fwd": fa.flash_attention,
            "flash_bwd_dkv": fa.flash_bwd_dkv, "flash_bwd_dq": fa.flash_bwd_dq}


def train_step_flash(cfg) -> dict:
    """Flash launches of one SFT step with remat: the forward runs CLIP's,
    the perceiver's, the decoder's and the xattn blocks' attention once
    and the decoder's again in the backward (its layers are recomputed);
    the frozen CLIP has no backward. 102 / 46 / 46 at OTTER-MPT7B."""
    clip, perc = cfg.vision.num_hidden_layers, cfg.perceiver.depth
    dec = cfg.text.num_hidden_layers
    xattn = dec // cfg.cross_attn_every_n_layers
    return {"flash_fwd": clip + perc + 2 * dec + xattn,
            "flash_bwd_dkv": dec + xattn + perc,
            "flash_bwd_dq": dec + xattn + perc}


def int8_train_cfg(depth_cut: bool = False):
    """The single-card 7B recipe's model (`tools/bench_train_7b.py`): the
    frozen decoder layers in int8, the xattn blocks in bf16."""
    cfg = train_cfg(depth_cut)
    return cfg.replace(text=cfg.text.replace(quant="int8", quant_xattn=None))


def build_int8_train_model(depth_cut: bool = False, dtype=None,
                           remat: bool = True):
    """The recipe's model with random_params weights: the unquantized
    set's frozen decoder kernels quantized with FROZEN_DECODER_PATTERNS
    (they are all frozen, so this is the JAX tool's split-then-quantize),
    the rest in `dtype` (bf16)."""
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.ops import quant
    cfg = int8_train_cfg(depth_cut)
    model = OtterVLM(cfg, dtype=dtype or torch.bfloat16, device=DEV,
                     remat=remat)
    load_flax_params(model, quant.quantize_params(
        random_params(train_cfg(depth_cut)), quant.FROZEN_DECODER_PATTERNS))
    return model, cfg


class _GradRecorder:
    """Stands in for the optimizer: keeps the step's gradients (f32) and
    leaves the weights as they were; or, given an optimizer, keeps them and
    then lets it update."""

    grads = None

    def __init__(self, tx=None, dtype=None):
        self.tx, self.dtype = tx, dtype

    def init(self, params):
        return None if self.tx is None else self.tx.init(params)

    def update(self, grads, state, params):
        import torch
        dt = self.dtype or torch.float32
        self.grads = {k: g.detach().to(dt, copy=True)
                      for k, g in grads.items()}
        if self.tx is not None:
            self.tx.update(grads, state, params)


def _step_grads(cfg, dtype, batch, ctx, adam8: bool = False):
    """(loss, grad_norm, {path: f32 tensor}, launches) of one SFT step
    (remat, fused CE 256, embedding mask) of the model `cfg` in `dtype`
    from random_params weights. The tensors are the step's gradients, and
    with `adam8` (the int8-frozen recipe's model and 8-bit Adam) also its
    dequantized first moments ("mu:" + path) after the update; without
    it the weights are left as they were."""
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.train.step import (TrainState, make_optimizer,
                                            make_train_step)
    if adam8:
        model, cfg = build_int8_train_model(depth_cut=True, dtype=dtype)
    else:
        model = OtterVLM(cfg, dtype=dtype, device=DEV, remat=True)
        load_flax_params(model, random_params(cfg))
    tx = None
    if adam8:
        from otter_tpu_torch.train.step import split_params
        tx = make_optimizer(split_params(model, cfg)[0], lr=1e-4,
                            total_steps=100, state_bits=8)
    rec = _GradRecorder(tx)
    state = TrainState.create(model, cfg, rec)
    step = make_train_step(model, cfg, rec, mask_embedding=True,
                           fused_ce_chunk=256)
    wrappers = _flash_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with ctx:
        _, m = step(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    out = dict(rec.grads)
    if adam8:
        o = state.opt_state
        for k, p in state.trainable.items():
            mu = (o.mu[k].float() * o.mu_s[k]).reshape(-1)[:p.numel()]
            out["mu:" + k] = mu.reshape(p.shape)
    return loss, gnorm, out, {k: w.launches for k, w in wrappers.items()}


def _step_failures(tag, runs, want_launches, nudged=None, quiet=False):
    """(failures, tensors held against the f32 step) of `_hold_step`'s
    check, logged per tensor unless `quiet`."""
    import torch
    if not quiet:
        for name, (loss, gnorm, _, counts) in runs.items():
            log(f"trainparity[{tag}, {name}]: loss {loss:.6f} grad_norm "
                f"{gnorm:.6f} launches {counts}")
    say = (lambda *_: None) if quiet else log
    (lk, gk, grads_k, ck), (lp, gp, grads_p, cp) = runs["kernels"], \
        runs["plain"]
    grads_f = runs["plain_f32"][2]
    failed = []
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)):
        failed.append(f"loss {lk} vs {lp} (limit 1e-2 relative)")
    if not (math.isfinite(gk) and abs(gk - gp) <= 2e-2 * abs(gp)):
        failed.append(f"grad_norm {gk} vs {gp} (limit 2e-2 relative)")
    # Each tensor: kernels within 5e-2 * max|plain| of the bf16 plain
    # path. Where the bf16 plain path itself is farther than that from the
    # same step in f32 (a gradient at bf16's noise floor: at random init
    # the perceiver's latents are near-identical, so the xattn q path's
    # ds = p * (dp - di) cancels), the kernel path must instead be within
    # the limit plus the bf16 plain path's own error of the f32 step.
    say(f"trainparity[{tag}]: per tensor, max err / max|ref|: kernels vs "
        "bf16 plain (limit 5e-2) | kernels vs f32 plain | bf16 plain vs f32 "
        "plain")
    floor = []
    if nudged is not None:
        say(f"trainparity[{tag}]: bf16 plain vs f32 plain is the larger of "
            "the plain step's and the same step's with each attention "
            "output moved by one bf16 rounding (shown after it)")
    for k, g in grads_p.items():
        e_kp, e_kf, e_pf = (_rel(grads_k[k], g), _rel(grads_k[k], grads_f[k]),
                            _rel(g, grads_f[k]))
        shown = f"{e_pf:.3e}"
        if nudged is not None:
            shown += f" / {nudged[k]:.3e}"
            e_pf = max(e_pf, nudged[k])
        say(f"    {e_kp:.3e} | {e_kf:.3e} | {shown}  {k} (max|plain| "
            f"{float(g.abs().max()):.3e})")
        ok = e_kp <= 5e-2
        if not ok and e_pf > 5e-2:
            ok = e_kf <= e_pf + 5e-2
            floor.append(k)
        if not ok or not torch.isfinite(grads_k[k]).all():
            failed.append(f"{k}: {e_kp:.3e} (vs f32 {e_kf:.3e}, bf16 "
                          f"plain vs f32 {e_pf:.3e})")
    say(f"trainparity[{tag}]: {len(grads_p)} tensors; held against the f32 "
        f"step (bf16 plain itself beyond 5e-2 of it): {floor}")
    if ck != want_launches or any(cp.values()):
        failed.append(f"launches: kernel run {ck} (want {want_launches}), "
                      f"plain run {cp}")
    return failed, floor


def _rel(a, r) -> float:
    """max |a - r| / max |r|."""
    return float((a.float() - r.float()).abs().max()) / max(
        float(r.float().abs().max()), 1e-30)


def _hold_step(tag, runs, want_launches, nudged=None):
    """A step through the kernels against the same step through the plain
    versions (bf16) and, where bf16 itself strays, in f32: loss 1e-2
    relative, grad norm 2e-2, each tensor within 5e-2 max|plain|.
    `nudged` ({path: error / max|f32|}): how far the bf16 plain step moves
    from the f32 step when each attention output moves by one bf16
    rounding (`_nudged_attention`, the largest over a few draws); where
    given, the bf16 plain path's error is the larger of its own and
    that. Returns the tensors held against the f32 step."""
    failed, floor = _step_failures(tag, runs, want_launches, nudged)
    if failed:
        raise RuntimeError(f"train step ({tag}): kernel path disagrees "
                           "with the plain path: " + "; ".join(failed))
    return floor


def _yaml_argv(cfg, yaml_path, tok_dir, save_dir, run_name, *extra):
    """The trainer's command line over a data YAML (OTTER-MPT7B, b=2, up to
    1024 tokens, `cfg`'s image size, remat, fused CE 256, embedding-row
    mask, lr 1e-4 constant, no final checkpoint: the optimizer state is
    tens of GB)."""
    return ["--training_data_yaml", yaml_path, "--tokenizer", tok_dir,
            "--model_config", "mpt7b", "--batch_size", "2",
            "--max_seq_len", "1024",
            "--patch_image_size", str(cfg.vision.image_size),
            "--gradient_checkpointing",
            "--mask_lm_head", "--learning_rate", "1e-4",
            "--warmup_steps", "0", "--logging_steps", "1",
            "--final_checkpoint", "--external_save_dir", save_dir,
            "--run_name", run_name, "--seed", str(SEED), "--workers", "4",
            *extra]


def _read_metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _yaml_parity(cfg, work: str):
    """The trainer over a data YAML at cut depth (via
    `--customized_config`), once through the kernels and once through the
    plain versions, on the same batches (the loader's order is seeded):
    each step's loss within 1e-2 relative, its grad norm within 2e-2.
    The kernel run also writes `--save_hf_model`'s
    final_weights.safetensors, which `load_otter_checkpoint` loads into a
    fresh model: every tensor equal to the trained one (the trainable
    ones are exported from their f32 masters, whose bf16 rounding the
    model holds)."""
    import torch
    from otter_tpu_torch.models.convert import load_otter_checkpoint
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import parse_args
    custom = os.path.join(work, "cut.json")
    with open(custom, "w") as f:
        json.dump(cfg.to_dict(), f)
    yaml_path = write_train_data(os.path.join(work, "data"), SEED + 60,
                                 n_single=4, n_context=2)
    tok_dir = write_tokenizer(os.path.join(work, "tok"), cfg)
    per_step = train_step_flash(cfg)
    runs = {}
    for name, ctx in (("kernels", contextlib.nullcontext()),
                      ("plain", plain_kernels())):
        argv = _yaml_argv(cfg, yaml_path, tok_dir, work, name,
                          "--customized_config", custom)
        if name == "kernels":
            argv.append("--save_hf_model")
        wrappers = _flash_wrappers()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with ctx:
            state = sft.main(parse_args(argv), params=random_params(cfg),
                             device=DEV)
        metrics = _read_metrics(os.path.join(work, name))
        counts = {k: w.launches for k, w in wrappers.items()}
        runs[name] = (metrics, counts, time.perf_counter() - t0)
        log(f"trainparity[yaml, {name}]: {len(metrics)} steps in "
            f"{runs[name][2]:.1f} s, losses "
            f"{[round(m['loss'], 5) for m in metrics]}, grad norms "
            f"{[round(m['grad_norm'], 5) for m in metrics]}, launches "
            f"{counts}")
        if name == "kernels":
            trained = state
        else:
            del state
    (mk, ck, _), (mp, cp, _) = runs["kernels"], runs["plain"]
    failed = []
    if len(mk) != len(mp) or not mk:
        failed.append(f"steps {len(mk)} vs {len(mp)}")
    for i, (a, b) in enumerate(zip(mk, mp)):
        if not (math.isfinite(a["loss"])
                and abs(a["loss"] - b["loss"]) <= 1e-2 * abs(b["loss"])):
            failed.append(f"step {i + 1} loss {a['loss']} vs {b['loss']}")
        if not abs(a["grad_norm"] - b["grad_norm"]) <= 2e-2 * b["grad_norm"]:
            failed.append(f"step {i + 1} grad norm {a['grad_norm']} vs "
                          f"{b['grad_norm']}")
    want = {k: v * len(mk) for k, v in per_step.items()}
    if ck != want or any(cp.values()):
        failed.append(f"launches {ck} (want {want}), plain {cp}")

    path = os.path.join(work, "kernels", "final_weights.safetensors")
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    fresh = OtterVLM(cfg, dtype=torch.bfloat16, device=DEV)
    load_otter_checkpoint(path, cfg, fresh)
    t_load = time.perf_counter() - t0
    mine = dict(fresh.named_parameters())
    differ = [k for k, p in trained.model.named_parameters()
              if not torch.equal(p, mine[k])]
    log(f"trainparity[yaml]: final_weights.safetensors {size / 1e9:.3f} GB "
        f"(f32), loaded into a fresh model in {t_load:.1f} s: "
        f"{len(mine) - len(differ)} of {len(mine)} tensors equal to the "
        f"trained ones")
    if differ:
        failed.append(f"the HF export loads back unequal: {differ[:5]}")
    os.remove(path)
    if failed:
        raise RuntimeError("trainparity (data YAML): " + "; ".join(failed))


def phase_trainparity():
    import tempfile
    import torch
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import TrainArgs

    cfg = train_cfg(depth_cut=True)
    tok = SmokeTokenizer(cfg)
    batch = sft.prepare_batch(make_train_batch(cfg, tok, SEED + 30), tok,
                              TrainArgs())
    per_step = train_step_flash(cfg)
    for tag, adam8 in (("bf16 step", False),
                       ("int8-frozen, 8-bit Adam step", True)):
        runs = {name: _step_grads(cfg, dtype, batch, ctx, adam8)
                for name, dtype, ctx in (
                    ("kernels", torch.bfloat16, contextlib.nullcontext()),
                    ("plain", torch.bfloat16, plain_kernels()),
                    ("plain_f32", torch.float32, plain_kernels()))}
        _hold_step(tag, runs, per_step)
        del runs
    _new_step_parity(batch)
    with tempfile.TemporaryDirectory() as work:
        _yaml_parity(cfg, work)


# ── phase 7: SFT steps at full width through train/sft.py ───────────

class StepMarks:
    """Wraps `sft.prepare_batch` for a run of `main`: each call, the start
    of a step, waits for the device and notes the time, the kernels'
    launch counts and the batch's shape, so step i took times[i + 1] -
    times[i] (its data wait included) and launched counts[i + 1] -
    counts[i]. Call `mark()` once more after `main` returns. It also
    wraps `sft.build_loaders`: `data` holds the loader's own wait for each
    batch (after the device has finished the step before: `main`'s
    data_time also holds that drain, as its `end` is taken before the
    logging that reads the loss)."""

    def __init__(self, counters):
        self.counters = counters
        self.times, self.counts, self.shapes, self.data = [], [], [], []

    @contextlib.contextmanager
    def around(self, sft):
        real, real_build = sft.prepare_batch, sft.build_loaders

        def marked(batch, tok, args):
            self.mark()
            out = real(batch, tok, args)
            self.shapes.append((tuple(out["input_ids"].shape),
                                out["vision_x"].shape[1]))
            return out

        sft.prepare_batch = marked
        sft.build_loaders = lambda *a, **k: _TimedLoader(
            real_build(*a, **k), self.data)
        try:
            yield self
        finally:
            sft.prepare_batch, sft.build_loaders = real, real_build

    def mark(self):
        import torch
        torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        self.counts.append({k: w.launches for k, w in self.counters.items()})

    def per_step(self):
        return [{k: c1[k] - c0[k] for k in c0}
                for c0, c1 in zip(self.counts, self.counts[1:])]


class _TimedLoader:
    """A loader whose every batch's wait is appended to `waits` (s),
    timed from after a device sync."""

    def __init__(self, loader, waits):
        self.loader, self.waits = loader, waits

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        import torch
        it = iter(self.loader)
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch


def _model_flops(model, cfg, b: int, s: int, images: float = 1) -> float:
    """Matmul FLOPs of one step, from the parameter counts (attention's
    own q.k and p.v products are not counted); `images` a sample."""
    groups = {"dec": 0, "xattn": 0, "head": 0, "clip": 0, "perc": 0}
    for name, p in model.named_parameters():
        if name.startswith("vision_encoder."):
            groups["clip"] += p.numel()
        elif name.startswith("perceiver."):
            groups["perc"] += p.numel()
        elif ".xattn_" in name:
            groups["xattn"] += p.numel()
        elif ".wte." in name:
            groups["head"] += p.numel()
        else:
            groups["dec"] += p.numel()
    for name, t in model.named_buffers():     # int8 decoder kernels
        if name.endswith("kernel_q"):
            groups["dec"] += t.numel()
    t, t_img, t_lat = b * s, b * images * (cfg.vision.num_patches + 1), \
        b * images * cfg.perceiver.num_latents
    lm = groups["dec"] + groups["xattn"] + groups["head"]
    return (4 * t * lm + 2 * t * (groups["xattn"] + groups["head"])
            + 2 * t * (groups["dec"] + groups["head"])
            + 2 * t_img * groups["clip"] + 6 * t_lat * groups["perc"])


FLOPS_FORMULA = ("4*T*(P_dec+P_xattn+P_head) [forward + activation grads] "
                 "+ 2*T*(P_xattn+P_head) [weight grads] + 2*T*(P_dec+P_head) "
                 "[remat and fused-CE recompute] + 2*T_img*P_clip + "
                 "6*T_lat*P_perc, T = b*s text tokens, T_img = b*257 a "
                 "image, T_lat = b*64 a image")

# what the train phase measured, for train8 to print beside its own
_TRAIN_MEMORY = {}


def _state_bytes(state) -> dict:
    """Bytes of the frozen weights (parameters and the int8 buffers), the
    trainable weights and the optimizer state."""
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return {"frozen": nb(state.frozen.values())
            + nb(b for _, b in state.model.named_buffers()),
            "trainable": nb(state.trainable.values()),
            "optimizer": state.opt_state.nbytes()}


def _gb(d: dict) -> str:
    return ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in d.items())


def _check_frozen(tag, state, params, paths):
    import torch
    failed = []
    with torch.no_grad():
        for path in paths:
            now = state.frozen[path]
            before = params["params/" + path]
            same = torch.equal(now, before)
            log(f"{tag}: frozen {path} checksum before "
                f"{float(before.double().sum()):.10e} after "
                f"{float(now.double().sum()):.10e} "
                f"{'bit-identical' if same else 'CHANGED'}")
            if not same:
                failed.append(f"frozen {path} changed")
    return failed


def _check_moved(tag, state, before):
    """Every trainable tensor moved, by group (wte, xattn, perceiver)."""
    import torch
    moved = {}
    with torch.no_grad():
        for path, p in state.trainable.items():
            group = ("wte" if "/wte/" in path else "xattn" if "xattn_" in path
                     else "perceiver")
            n_moved, n = moved.get(group, (0, 0))
            moved[group] = (n_moved + int(not torch.equal(p, before(path))),
                            n + 1)
    log(f"{tag}: trainable tensors changed by group {moved}")
    if sorted(moved) != ["perceiver", "wte", "xattn"] or any(
            m != n for m, n in moved.values()):
        return [f"trainable tensors unchanged: {moved}"]
    return []


def phase_train(smi: str, profile: bool = False):
    import tempfile
    import numpy as np
    import torch
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import parse_args

    save_dir = os.path.join(OUT_DIR, "train")
    run_dir = os.path.join(save_dir, "mpt7b")
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = sft.CONFIG_FACTORIES["mpt7b"]()
    params = random_params(cfg)
    wrappers = _flash_wrappers()
    marks = StepMarks(wrappers)
    with tempfile.TemporaryDirectory() as work:
        yaml_path = write_train_data(os.path.join(work, "data"), SEED + 40)
        tok_dir = write_tokenizer(os.path.join(work, "tok"), cfg)
        args = parse_args(_yaml_argv(cfg, yaml_path, tok_dir, save_dir,
                                     "mpt7b", "--num_epochs", "2"))
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases left allocated is not this phase's
        base = torch.cuda.memory_allocated()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        with marks.around(sft):
            state = sft.main(args, params=params, device=DEV)
        marks.mark()
        wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak_abs = torch.cuda.max_memory_allocated()
    peak = peak_abs - base

    metrics = _read_metrics(run_dir)
    losses = [m["loss"] for m in metrics]
    data_s = marks.data
    # main's data_time a step, from metrics.jsonl's running average
    data_avg = [m["data_time"] for m in metrics]
    main_data_s = [data_avg[0]] + [(i + 1) * data_avg[i]
                                   - i * data_avg[i - 1]
                                   for i in range(1, len(data_avg))]
    steps = np.diff(marks.times)
    per_step = marks.per_step()
    warm = 2
    tokens = [b * s for (b, s), _ in marks.shapes]
    images = [t for _, t in marks.shapes]
    step_s = float(np.median(steps[warm:]))
    tok_s = sum(tokens[warm:]) / float(np.sum(steps[warm:]))
    b = args.batch_size
    n_train = sum(p.numel() for p in state.trainable.values())
    n_all = sum(p.numel() for p in state.model.parameters())
    mean_s = int(np.mean([s for (_, s), _ in marks.shapes]))
    flops = _model_flops(state.model, cfg, b, mean_s, float(np.mean(images)))
    mem = _state_bytes(state)
    _TRAIN_MEMORY.update(mem, peak=peak)
    log(f"train: OTTER-MPT7B bf16 through sft.main(parse_args([...])) over "
        f"a data YAML (IMAGE_TEXT and IMAGE_TEXT_IN_CONTEXT, "
        f"{len(metrics)} steps in 2 epochs), a WordLevel tokenizer "
        f"directory, "
        f"{n_all / 1e9:.3f}B parameters, {n_train / 1e9:.3f}B trainable "
        f"(f32 masters + moments), b={b}, remat, fused CE 256, lr 1e-4 | "
        f"{smi}")
    log(f"train: batches (b, padded length, images a sample) "
        f"{[(bb, s, t) for ((bb, s), t) in marks.shapes]}")
    log(f"train: main() {wall:.1f} s for {len(metrics)} steps; losses "
        f"{[round(x, 5) for x in losses]}")
    log(f"train: step ms (wall between steps, data wait included) "
        f"{[round(float(x) * 1e3, 2) for x in steps]} | median of the last "
        f"{len(steps) - warm}: {step_s * 1e3:.2f} ms, {b / step_s:.3f} "
        f"samples/s, {tok_s:.1f} tokens/s (padded) | {smi}")
    log(f"train: data ms a step (the loader's own wait, after a device "
        f"sync) {[round(x * 1e3, 2) for x in data_s]}; median of the last "
        f"{len(data_s) - warm}: {float(np.median(data_s[warm:])) * 1e3:.2f}"
        f" ms. main's data_time a step (metrics.jsonl: the loader's wait "
        f"plus the device finishing the step before) "
        f"{[round(x * 1e3, 2) for x in main_data_s]}; "
        f"samples_per_sec_per_chip (main's running average) "
        f"{metrics[-1]['samples_per_sec_per_chip']:.3f}")
    log(f"train: peak memory (torch.cuda.max_memory_allocated, above the "
        f"{base / 2 ** 30:.2f} GiB allocated before the phase) "
        f"{peak / 2 ** 30:.2f} GiB ({peak} bytes), absolute "
        f"{peak_abs / 2 ** 30:.2f} GiB; {_gb(mem)}")
    log(f"train: model FLOPs {flops / 1e12:.2f} TFLOP a step at the mean "
        f"padded length {mean_s} and images {np.mean(images):.2f} = "
        f"{FLOPS_FORMULA}; "
        f"{flops / step_s / 1e12:.1f} TFLOP/s = "
        f"{100 * flops / step_s / H100_BF16_FLOP_PER_S:.2f}% of 989 TFLOP/s "
        f"| {smi}")
    log(f"train: launches per step {per_step}; whole run {launches}")

    # two epochs over the same data (the weighted choice draws the
    # batches anew): the second's mean loss, after a pass, is lower
    half = len(losses) // 2
    mean1, mean2 = np.mean(losses[:half]), np.mean(losses[half:])
    log(f"train: mean loss epoch 1 {mean1:.5f}, epoch 2 {mean2:.5f}")
    failed = []
    if not losses or not all(map(math.isfinite, losses)):
        failed.append(f"losses {losses}")
    elif not mean2 < mean1:
        failed.append(f"loss did not fall: {losses}")
    if len(set(images)) < 2:
        failed.append(f"one task group only: images a sample {images}")
    failed += _check_frozen("train", state, params, (
        "vision_encoder/layers_0/fc1/kernel",
        "lang_encoder/layers_0/attn/Wqkv/kernel",
        "lang_encoder/norm_f/scale"))
    failed += _check_moved("train", state,
                           lambda path: params["params/" + path])
    want = train_step_flash(cfg)
    if any(c != want for c in per_step) or len(per_step) != len(metrics):
        failed.append(f"flash launches a step {per_step}, want {want}")
    if failed:
        raise RuntimeError("train phase failed: " + "; ".join(failed))
    from otter_tpu_torch.train.step import make_optimizer
    tok = SmokeTokenizer(cfg)
    batch = sft.prepare_batch(make_train_batch(cfg, tok, SEED + 40), tok,
                              args)
    _update_share("train", state, cfg, make_optimizer(
        list(state.trainable), lr=args.learning_rate), batch, smi)
    if profile:
        _profile_train_step("profile train step", state, cfg, batch,
                            make_optimizer(list(state.trainable),
                                           lr=args.learning_rate),
                            "profile_train.txt")
    del state
    return launches


class _TimedUpdate:
    """An optimizer's update timed between two device syncs."""

    ms = None

    def __init__(self, tx):
        self.tx = tx

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, state, params):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.tx.update(grads, state, params)
        torch.cuda.synchronize()
        self.ms = (time.perf_counter() - t0) * 1e3


def _update_share(tag, state, cfg, tx, batch, smi):
    """One more step of `state` on `batch` with `tx`'s update timed alone:
    how much of a step the optimizer takes."""
    import torch
    from otter_tpu_torch.train.step import make_train_step
    timed = _TimedUpdate(tx)
    step = make_train_step(state.model, cfg, timed, mask_embedding=True,
                           fused_ce_chunk=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step(state, batch)
    float(m["loss"])
    wall = (time.perf_counter() - t0) * 1e3
    log(f"{tag}: one more step (b=2, 1024 tokens) {wall:.2f} ms, of which "
        f"the optimizer's update {timed.ms:.2f} ms between syncs | {smi}")


class _NoUpdate:
    """An optimizer that updates nothing: a step's forward and backward
    alone."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        pass


def _backward_peak(model, cfg, batch) -> int:
    """Peak bytes allocated over one step's forward and backward (no
    update) above what was allocated before it."""
    import torch
    from otter_tpu_torch.train.step import TrainState, make_train_step
    tx = _NoUpdate()
    state = TrainState.create(model, cfg, tx)
    step = make_train_step(model, cfg, tx, mask_embedding=True,
                           fused_ce_chunk=256)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, m = step(state, batch)
    float(m["loss"])
    return torch.cuda.max_memory_allocated() - base


@contextlib.contextmanager
def _composed_int8():
    """`Int8Dense` as it was before `_Int8Product`: autograd keeps the
    forward's bf16 copy of every frozen int8 kernel for the backward."""
    from otter_tpu_torch.ops import quant
    quant._Int8Product.apply = lambda x, k, s: (x @ k.to(x.dtype)) * \
        s.to(x.dtype)
    try:
        yield
    finally:
        del quant._Int8Product.apply      # back to Function.apply


def phase_train8(smi: str, profile: bool = False):
    """The single-card 7B recipe (`tools/bench_train_7b.py`) at full width
    and depth: int8 frozen decoder layers, bf16 xattn and trainables,
    8-bit Adam (no f32 masters), b=2, 1024 tokens, remat, fused CE 256."""
    import numpy as np
    import torch
    from otter_tpu_torch.ops import quant
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import TrainArgs
    from otter_tpu_torch.train.step import (TrainState, make_optimizer,
                                            make_train_step, split_params)

    b, s, warm, timed = 2, 1024, 2, 5
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()   # left by earlier phases
    t0 = time.perf_counter()
    model, cfg = build_int8_train_model()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    tok = SmokeTokenizer(cfg)
    batch = sft.prepare_batch(make_train_batch(cfg, tok, SEED + 70, b, s),
                              tok, TrainArgs())

    # the int8 kernels' bf16 copies: one step without remat, as
    # `_Int8Product` runs it and as the composed product would
    model.lang_encoder.remat = False
    peak_fn = _backward_peak(model, cfg, batch)
    with _composed_int8():
        peak_composed = _backward_peak(model, cfg, batch)
    model.lang_encoder.remat = True
    kernel_bytes = sum(t.numel() for n, t in model.named_buffers()
                       if n.endswith("kernel_q"))
    log(f"train8: one step without remat, peak above the model: "
        f"_Int8Product {peak_fn / 1e9:.3f} GB, the composed product "
        f"{peak_composed / 1e9:.3f} GB: {(peak_composed - peak_fn) / 1e9:.3f}"
        f" GB more (the frozen int8 kernels in bf16: "
        f"{2 * kernel_bytes / 1e9:.3f} GB) | {smi}")

    trainable, _ = split_params(model, cfg)
    with torch.no_grad():
        for p in trainable.values():
            p.grad = None
    tx = make_optimizer(trainable, lr=1e-4, total_steps=100, state_bits=8)
    state = TrainState.create(model, cfg, tx)
    step = make_train_step(model, cfg, tx, mask_embedding=True,
                           fused_ce_chunk=256)
    last = cfg.text.num_hidden_layers - 1
    frozen_paths = ("lang_encoder.layers_0.attn.Wqkv.kernel_q",
                    f"lang_encoder.layers_{last}.ffn.down_proj.kernel_q",
                    "vision_encoder.layers_0.fc1.kernel",
                    "lang_encoder.norm_f.scale")
    tensors = {**dict(model.named_parameters()),
               **dict(model.named_buffers())}
    frozen_before = {k: tensors[k].detach().clone() for k in frozen_paths}
    trained_before = {k: p.detach().clone() for k, p in trainable.items()}
    mem = _state_bytes(state)
    wrappers = _flash_wrappers()
    marks = StepMarks(wrappers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warm + timed):
        marks.mark()
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
    marks.mark()
    peak_abs = torch.cuda.max_memory_allocated()
    peak = peak_abs - base
    steps = np.diff(marks.times)
    per_step = marks.per_step()
    step_s = float(np.median(steps[warm:]))
    flops = _model_flops(model, cfg, b, s)
    n_train = sum(p.numel() for p in trainable.values())
    log(f"train8: OTTER-MPT7B, the int8-frozen recipe: decoder layers int8 "
        f"(FROZEN_DECODER_PATTERNS), xattn bf16, {n_train / 1e9:.3f}B "
        f"trainable bf16 with 8-bit Adam (blocks of 512, no masters), b={b} "
        f"s={s}, remat, fused CE 256, lr 1e-4; built in {t_build:.1f} s | "
        f"{smi}")
    log(f"train8: bytes {_gb(mem)} ({mem['optimizer'] / n_train:.4f} a "
        f"trainable parameter); the train phase (bf16, AdamW with f32 "
        f"masters): {_gb({k: v for k, v in _TRAIN_MEMORY.items() if k != 'peak'}) or 'not run'}")
    log(f"train8: peak memory (above the {base / 2 ** 30:.2f} GiB "
        f"allocated before the phase) {peak / 2 ** 30:.2f} GiB ({peak} "
        f"bytes), absolute {peak_abs / 2 ** 30:.2f} GiB; the train phase's {_TRAIN_MEMORY.get('peak', 0) / 2 ** 30:.2f}"
        f" GiB")
    log(f"train8: losses {[round(x, 5) for x in losses]}")
    log(f"train8: step ms {[round(float(x) * 1e3, 2) for x in steps]} | "
        f"median of the last {timed}: {step_s * 1e3:.2f} ms, "
        f"{b / step_s:.3f} samples/s, {b * s / step_s:.1f} tokens/s; model "
        f"FLOPs {flops / 1e12:.2f} TFLOP a step, "
        f"{100 * flops / step_s / H100_BF16_FLOP_PER_S:.2f}% of 989 TFLOP/s "
        f"| {smi}")
    log(f"train8: launches per step {per_step}")

    failed = []
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        failed.append(f"losses {losses}")
    for k in frozen_paths:
        same = torch.equal(tensors[k], frozen_before[k])
        log(f"train8: frozen {k} {'bit-identical' if same else 'CHANGED'}")
        if not same:
            failed.append(f"frozen {k} changed")
    failed += _check_moved("train8", state, trained_before.__getitem__)
    want = train_step_flash(cfg)
    if any(c != want for c in per_step):
        failed.append(f"flash launches a step {per_step}, want {want}")
    if peak_composed - peak_fn < kernel_bytes:
        failed.append(f"the composed int8 product's step took only "
                      f"{(peak_composed - peak_fn) / 1e9:.3f} GB more")
    # the fused MLP kernels have no backward: asked for one, they refuse
    x = torch.ones(8, 64, dtype=torch.bfloat16, device=DEV,
                   requires_grad=True)
    w = torch.ones(64, 128, dtype=torch.int8, device=DEV)
    sc = torch.ones(128, device=DEV)
    try:
        quant.int8_mlp(x, w, sc, w.t().contiguous(), sc[:64])
        failed.append("int8_mlp returned an output cut from autograd")
    except NotImplementedError as e:
        log(f"train8: int8_mlp with an input that needs a gradient: {e}")
    if failed:
        raise RuntimeError("train8 phase failed: " + "; ".join(failed))
    _update_share("train8", state, cfg, tx, batch, smi)
    if profile:
        _profile_train_step("profile train8 step", state, cfg, batch, tx,
                            "profile_train8.txt")
    del state, model
    return {k: sum(c[k] for c in per_step) for k in FLASH_COUNTERS}


# ── phases 18-20: Flamingo pretraining, the OtterHD full fine-tune, LoRA ─

def pretrain_cfg(depth_cut: bool = False):
    """Flamingo-MPT-1B (`PretrainArgs`'s default `--model_config mpt1b`)."""
    from otter_tpu_torch.config import otter_mpt1b
    cfg = otter_mpt1b()
    return _depth_cut(cfg) if depth_cut else cfg


def pretrain_step_flash(cfg, batches: int = 2) -> dict:
    """Flash launches of one pretraining step (no remat: the JAX
    pretrainer has none): for each of its batches CLIP, the perceiver, the
    decoder and the xattn blocks forward, the decoder, the xattn blocks
    and the perceiver backward (the frozen CLIP has none). 156 / 108 / 108
    at Flamingo-MPT-1B."""
    clip, perc = cfg.vision.num_hidden_layers, cfg.perceiver.depth
    dec = cfg.text.num_hidden_layers
    xattn = dec // cfg.cross_attn_every_n_layers
    return {"flash_fwd": batches * (clip + perc + dec + xattn),
            "flash_bwd_dkv": batches * (dec + xattn + perc),
            "flash_bwd_dq": batches * (dec + xattn + perc)}


def _noise_png(rng, n: int = 64) -> bytes:
    """A noise PNG: at 64x64 ~12.4 KB, over MMC4's 10 KB filter."""
    import numpy as np
    return png_bytes(rng.integers(0, 256, (n, n, 3), dtype=np.uint8))


def write_pretrain_shards(directory: str, seed: int, n_pairs: int = 64,
                          n_docs: int = 16, shards: int = 2):
    """`shards` LAION shards of `n_pairs` (noise PNG as .jpg, a caption of
    12-24 words) and `shards` MMC4 shards of `n_docs` documents (four
    sentences of 40-60 words, three noise PNGs in standard base64 matched
    to the first three at similarity 0.3, so none is filtered and no
    document is a single-image one), written with `tarfile`. Words are
    `write_tokenizer`'s. Returns the two brace patterns."""
    import base64
    import io
    import tarfile
    import numpy as np
    rng = np.random.default_rng(seed)
    words = lambda lo, hi: " ".join(
        f"w{i}" for i in rng.integers(5, 5000, int(rng.integers(lo, hi))))
    os.makedirs(directory, exist_ok=True)

    def add(tf, name, data):
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))

    for s in range(shards):
        with tarfile.open(os.path.join(directory, f"laion-{s}.tar"),
                          "w") as tf:
            for i in range(n_pairs):
                add(tf, f"{s}{i:05d}.jpg", _noise_png(rng))
                add(tf, f"{s}{i:05d}.txt", words(12, 24).encode())
        with tarfile.open(os.path.join(directory, f"mmc4-{s}.tar"),
                          "w") as tf:
            for i in range(n_docs):
                doc = {"text_list": [words(40, 60) for _ in range(4)],
                       "image_info": [{
                           "image_base64": base64.b64encode(
                               _noise_png(rng)).decode(),
                           "matched_sim": 0.3, "matched_text_index": j}
                           for j in range(3)]}
                add(tf, f"{s}{i:05d}.json", json.dumps(doc).encode())
    last = shards - 1
    return (os.path.join(directory, f"laion-{{0..{last}}}.tar"),
            os.path.join(directory, f"mmc4-{{0..{last}}}.tar"))


class _StepCalls:
    """Wraps a step function: waits for the device before and after each
    call and notes the times, the flash launches of the call and the
    state's step count; `first(state)` runs before the first call."""

    def __init__(self, counters, first=None):
        self.counters, self.first = counters, first
        self.spans, self.counts, self.steps = [], [], []

    def wrap(self, step):
        def marked(state, *a, **kw):
            if not self.steps and self.first is not None:
                self.first(state)
            self.steps.append(state.step)
            t0, c0 = self._mark()
            out = step(state, *a, **kw)
            t1, c1 = self._mark()
            self.spans.append((t0, t1))
            self.counts.append({k: c1[k] - c0[k] for k in c0})
            return out
        return marked

    def _mark(self):
        import torch
        torch.cuda.synchronize()
        return time.perf_counter(), {k: w.launches
                                     for k, w in self.counters.items()}

    def step_ms(self):
        return [round((t1 - t0) * 1e3, 2) for t0, t1 in self.spans]

    def gap_ms(self):
        """Between a step's end and the next one's start: the loader."""
        return [round((b[0] - a[1]) * 1e3, 2)
                for a, b in zip(self.spans, self.spans[1:])]


@contextlib.contextmanager
def _wrapped_pretrain_step(pretrain, calls: _StepCalls):
    real = pretrain.make_pretrain_step
    pretrain.make_pretrain_step = lambda *a, **k: calls.wrap(real(*a, **k))
    try:
        yield
    finally:
        pretrain.make_pretrain_step = real


def phase_pretrain(smi: str):
    """Flamingo pretraining as a user runs it: `pretrain.main([...])`
    (`python -m otter_tpu_torch.train.pretrain`) on Flamingo-MPT-1B at full
    width and depth over LAION and MMC4 tar shards written here, with a
    WordLevel tokenizer directory. Batches `--batch_size_laion 32
    --batch_size_mmc4 8`: a 4x cut of the reference's 128 / 32, for
    memory, since the JAX pretrainer has no remat flag. One epoch of 4
    steps, then a second call with `--num_epochs 2` that resumes from the
    epoch's checkpoint."""
    import gc
    import tempfile
    import numpy as np
    import torch
    from otter_tpu_torch.train import pretrain

    cfg = pretrain_cfg()
    wrappers = _flash_wrappers()
    kept = {}

    def keep_first(state):
        kept["frozen"] = {k: p.detach().clone()
                          for k, p in state.frozen.items()}
        kept["trainable"] = {k: p.detach().clone()
                             for k, p in state.trainable.items()}

    failed, launches = [], {k: 0 for k in FLASH_COUNTERS}
    want = pretrain_step_flash(cfg)
    with tempfile.TemporaryDirectory() as work:
        laion, mmc4 = write_pretrain_shards(os.path.join(work, "shards"),
                                            SEED + 80)
        tok_dir = write_tokenizer(os.path.join(work, "tok"), cfg)
        argv = ["--laion_shards", laion, "--mmc4_shards", mmc4,
                "--tokenizer", tok_dir, "--model_config", "mpt1b",
                "--patch_image_size", str(cfg.vision.image_size),
                "--batch_size_laion", "32", "--batch_size_mmc4", "8",
                "--train_num_samples_laion", "128",
                "--train_num_samples_mmc4", "32", "--warmup_steps", "0",
                "--logging_steps", "1", "--seed", str(SEED),
                "--external_save_dir", work, "--run_name", "pretrain"]
        run_dir = os.path.join(work, "pretrain")
        ends = {}
        for call, extra in ((1, []), (2, ["--num_epochs", "2"])):
            calls = _StepCalls(wrappers, keep_first)
            kept.clear()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with _wrapped_pretrain_step(pretrain, calls):
                state = pretrain.main(argv + extra, device=DEV)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            steps, per_step = calls.step_ms(), calls.counts
            for c in per_step:
                for k in launches:
                    launches[k] += c[k]
            metrics = _read_metrics(run_dir)
            ckpt = os.path.join(run_dir, f"checkpoint_{state.step}")
            with open(os.path.join(ckpt, "meta.json")) as f:
                meta = json.load(f)
            size = sum(os.path.getsize(os.path.join(ckpt, n))
                       for n in os.listdir(ckpt))
            mem = _state_bytes(state)
            log(f"pretrain[call {call}]: Flamingo-MPT-1B bf16 through "
                f"pretrain.main([...]) {' '.join(extra) or '(one epoch)'}: "
                f"steps {calls.steps} in {wall:.1f} s (the model's init, "
                f"the shards' decode and the checkpoint included); "
                f"checkpoint_{state.step} {size / 1e9:.3f} GB, meta {meta}")
            log(f"pretrain[call {call}]: step ms (between device syncs) "
                f"{steps}; median of steps 2-: "
                f"{float(np.median(steps[1:])):.2f} ms; the loader's wait "
                f"between steps {calls.gap_ms()} ms; b 32 x 32 tokens "
                f"(LAION) + 8 x 256 (MMC4, 5 image slots) | {smi}")
            log(f"pretrain[call {call}]: peak memory "
                f"{(peak - base) / 2 ** 30:.2f} GiB above the "
                f"{base / 2 ** 30:.2f} GiB allocated before, absolute "
                f"{peak / 2 ** 30:.2f} GiB; {_gb(mem)}")
            log(f"pretrain[call {call}]: losses (loss, loss_laion, "
                f"loss_mmc4) " + str([(round(m['loss'], 5),
                                       round(m['loss_laion'], 5),
                                       round(m['loss_mmc4'], 5))
                                      for m in metrics]))
            log(f"pretrain[call {call}]: flash launches a step {per_step}")
            first = calls.steps[0] if calls.steps else None
            if call == 1 and (calls.steps != [0, 1, 2, 3]
                              or meta.get("epoch") != 1):
                failed.append(f"call 1 ran steps {calls.steps}, meta {meta}")
            if call == 2:
                if calls.steps != [4, 5, 6, 7] or meta.get("epoch") != 2:
                    failed.append(f"the resumed call ran steps "
                                  f"{calls.steps}, meta {meta}")
                differ = [k for k, p in kept["trainable"].items()
                          if not torch.equal(p, ends[k])]
                log(f"pretrain[call 2]: resumed at step {first}, epoch 1: "
                    f"{len(ends) - len(differ)} of {len(ends)} trainable "
                    f"tensors equal to the first call's last")
                if differ:
                    failed.append(f"restored trainables differ: "
                                  f"{differ[:3]}")
            if [m["step"] for m in metrics] != list(
                    range(1, 4 * call + 1)):
                failed.append(f"metrics steps {[m['step'] for m in metrics]}")
            for m in metrics:
                if not all(math.isfinite(m.get(k, float("nan"))) for k in
                           ("loss", "loss_laion", "loss_mmc4")):
                    failed.append(f"metrics {m}")
            if any(c != want for c in per_step):
                failed.append(f"flash launches a step {per_step}, want "
                              f"{want}")
            changed = [k for k, p in state.frozen.items()
                       if not torch.equal(p, kept["frozen"][k])]
            log(f"pretrain[call {call}]: frozen tensors: "
                f"{len(state.frozen) - len(changed)} of {len(state.frozen)} "
                f"bit-identical")
            if changed:
                failed.append(f"frozen changed: {changed[:3]}")
            # every group moves; a tensor whose gradient is far below f32's
            # resolution of its value stays (at random init the xattn
            # blocks' q path: the perceiver's latents are near-identical)
            moved, still = {}, []
            for k, p in state.trainable.items():
                group = ("wte" if "/wte/" in k else "xattn" if "xattn_" in k
                         else "perceiver")
                n_moved, n = moved.get(group, (0, 0))
                same = torch.equal(p, kept["trainable"][k])
                moved[group] = (n_moved + (not same), n + 1)
                if same:
                    still.append(k)
            log(f"pretrain[call {call}]: trainable tensors changed by group "
                f"{moved}; unchanged: {still}")
            if sorted(moved) != ["perceiver", "wte", "xattn"] or not all(
                    m for m, _ in moved.values()):
                failed.append(f"a trainable group did not move: {moved}")
            ends = {k: p.detach().clone() for k, p in
                    state.trainable.items()}
            del state
            kept.clear()
            gc.collect()
            torch.cuda.empty_cache()
        del ends
    if failed:
        raise RuntimeError("pretrain phase failed: " + "; ".join(failed))
    return launches


def fuyu_train_cfg(depth_cut: bool = False):
    """OtterHD-8B (`FuyuConfig()`, adept/fuyu-8b's widths and depth) in
    bf16, as the full fine-tune trains it."""
    from otter_tpu_torch.config import FuyuConfig
    cfg = FuyuConfig()
    if depth_cut:
        cfg = cfg.replace(text=cfg.text.replace(num_hidden_layers=4))
    return cfg


class FuyuTrainTokenizer:
    """The tokenizer surface the Fuyu processor reads (`__call__` ->
    input_ids, `bos_token_id`, `eos_token_id`) over made-up ids: "\\x04"
    (boa) is 71122 and eos 71013, as adept/fuyu-8b's tokenizer numbers
    them; any other whitespace-separated word 1000 + its crc32 mod 70000
    (below the image ids)."""

    bos_token_id, eos_token_id, boa_id = 1, 71013, 71122

    def __call__(self, text, add_special_tokens=False, truncation=True,
                 max_length=None, **kw):
        import re
        import zlib
        ids = []
        for part in re.split("(\\x04)", text):
            if part == "\x04":
                ids.append(self.boa_id)
            else:
                ids += [1000 + zlib.crc32(w.encode()) % 70000
                        for w in part.split()]
        return {"input_ids": ids[:max_length] if max_length else ids}


def fuyu_processor(cfg):
    from otter_tpu_torch.data.fuyu_processor import (FuyuImageProcessor,
                                                     FuyuProcessor)
    return FuyuProcessor(FuyuTrainTokenizer(),
                         FuyuImageProcessor(patch_size=cfg.patch_size),
                         image_placeholder_id=cfg.image_placeholder_id,
                         image_newline_id=cfg.image_newline_id)


def fuyu_train_samples(seed: int, sizes=(448, 512, 768)):
    """One (text, image) a size: `format_pair` of a 12-word instruction and
    a 40-word answer closed by "\\x04" (as `tests/test_fuyu_sft.py`
    writes them), a square noise image."""
    import numpy as np
    from otter_tpu_torch.data.mimicit import decode_base64_image
    from otter_tpu_torch.data.templates import format_pair
    rng = np.random.default_rng(seed)
    words = lambda n: " ".join(f"w{i}" for i in rng.integers(0, 9999, n))
    return [(format_pair(words(12), words(40), "fuyu") + "\x04",
             decode_base64_image(png_base64(rng.integers(
                 0, 256, (n, n, 3), dtype=np.uint8)))) for n in sizes]


def fuyu_train_step_flash(cfg) -> dict:
    """Flash launches of one full fine-tune step with remat: every decoder
    layer forward, again in the backward, and each backward kernel
    once. 72 / 36 / 36 at OtterHD-8B."""
    n = cfg.text.num_hidden_layers
    return {"flash_fwd": 2 * n, "flash_bwd_dkv": n, "flash_bwd_dq": n}


def build_fuyu_train_model(depth_cut: bool = False, dtype=None):
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.fuyu import FuyuVLM
    cfg = fuyu_train_cfg(depth_cut)
    model = FuyuVLM(cfg, dtype=dtype or torch.bfloat16, device=DEV,
                    remat=True)
    load_flax_params(model, random_params(cfg))
    return model, cfg


def _tensor_sums(tensors: dict) -> dict:
    """{name: (sum, sum of |x|)} in f64: a tensor moved where either
    changed."""
    import torch
    with torch.no_grad():
        return {k: (float(t.double().sum()), float(t.double().abs().sum()))
                for k, t in tensors.items()}


def phase_fuyutrain(smi: str):
    """OtterHD-8B full fine-tune (`train/fuyu_sft.py`) at full width and
    depth: bf16 parameters, 8-bit Adam (no masters), remat, b=1, lr 1e-4;
    `FuyuBatcher(dynamic_resolution=True)` over one image each at 448²,
    512² and 768². One warm-up step and three timed ones (one batch each),
    then the first batch again: its loss must have fallen."""
    import numpy as np
    import torch
    from otter_tpu_torch.train import fuyu_sft
    from otter_tpu_torch.train.step import flax_path, make_optimizer

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()     # left by earlier phases
    t0 = time.perf_counter()
    model, cfg = build_fuyu_train_model()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    batcher = fuyu_sft.FuyuBatcher(fuyu_processor(cfg),
                                   dynamic_resolution=True, seed=SEED)
    batches = [batcher([t], [im]) for t, im in fuyu_train_samples(SEED + 90)]
    shapes = [(b["input_ids"].shape[1], b["image_patches"].shape[1])
              for b in batches]
    tx = _TimedUpdate(make_optimizer(
        [flax_path(n) for n, _ in model.named_parameters()], lr=1e-4,
        total_steps=100, state_bits=8))
    state = fuyu_sft.fuyu_train_state(model, tx)
    before = _tensor_sums({**dict(model.named_parameters())})
    mem = _state_bytes(state)
    step = fuyu_sft.make_fuyu_train_step(model, tx)
    calls = _StepCalls(_flash_wrappers())
    step = calls.wrap(step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, updates = [], []
    for b in batches[:1] + batches + batches[:1]:
        _, m = step(state, b)
        losses.append(float(m["loss"]))
        updates.append(tx.ms)
    peak = torch.cuda.max_memory_allocated()
    steps, per_step = calls.step_ms(), calls.counts
    after = _tensor_sums(dict(model.named_parameters()))
    still = [k for k in before if before[k] == after[k]]
    n_all = sum(p.numel() for p in model.parameters())
    log(f"fuyutrain: OtterHD-8B full fine-tune, {n_all / 1e9:.3f}B bf16 "
        f"parameters, 8-bit Adam (no masters), remat, b=1, lr 1e-4; built "
        f"in {t_build:.1f} s; {_gb(mem)} | {smi}")
    log(f"fuyutrain: batches (tokens, image patches) {shapes} (the "
        f"batcher's draws); steps on batches 0, 0, 1, 2, 0")
    log(f"fuyutrain: step ms {steps}, of which the 8-bit update (between "
        f"syncs) {[round(u, 2) for u in updates]}; timed steps (2-4) "
        f"{steps[1:4]} ms for {[s for s, _ in shapes]} tokens | {smi}")
    log(f"fuyutrain: peak memory {peak / 2 ** 30:.2f} GiB absolute, "
        f"{(peak - base) / 2 ** 30:.2f} GiB above the {base / 2 ** 30:.2f} "
        f"GiB earlier phases left")
    log(f"fuyutrain: losses {[round(x, 5) for x in losses]}; flash "
        f"launches a step {per_step}")
    failed = []
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        failed.append(f"the repeated batch's loss did not fall: {losses}")
    if still:
        failed.append(f"{len(still)} of {len(before)} parameters did not "
                      f"move, e.g. {still[:3]}")
    want = fuyu_train_step_flash(cfg)
    if any(c != want for c in per_step):
        failed.append(f"flash launches a step {per_step}, want {want}")
    del state, model, tx
    if failed:
        raise RuntimeError("fuyutrain phase failed: " + "; ".join(failed))
    return {k: sum(c[k] for c in per_step) for k in FLASH_COUNTERS}


LORA_RANK = 16


def lora_cfg(depth_cut: bool = False):
    """The int8-frozen recipe's model with LoRA rank 16 on every decoder
    layer's Wqkv (`lora_alpha` 16, JAX's default), decoding as the serving
    worker does (`decode_kernel="auto"`: the int8 cache through
    `decode_attention`)."""
    cfg = int8_train_cfg(depth_cut)
    return cfg.replace(text=cfg.text.replace(lora_rank=LORA_RANK,
                                             decode_kernel="auto"))


def build_lora_model(depth_cut: bool = False, dtype=None):
    """`lora_cfg`'s model: `build_int8_train_model`'s weights under
    `base/` (`ops.lora.into_base`), the adapters drawn from SEED (B = 0)."""
    import torch
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.ops import lora, quant
    cfg = lora_cfg(depth_cut)
    model = OtterVLM(cfg, dtype=dtype or torch.bfloat16, device=DEV,
                     remat=True)
    load_flax_params(model, lora.into_base(quant.quantize_params(
        random_params(train_cfg(depth_cut)), quant.FROZEN_DECODER_PATTERNS),
        model), partial=True)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    lora.reset_adapters(model, gen)
    return model, cfg


def phase_lora(smi: str):
    """QLoRA-style training of OTTER-MPT7B (JAX's
    `tests/test_lora.py::test_lora_over_int8_base` at full size): int8
    frozen decoder layers with LoRA rank 16 on Wqkv, bf16 xattn and
    trainables, 8-bit Adam, b=2 x 1024, remat, fused CE 256, lr 1e-4; 2
    warm-up and 3 timed steps; then one greedy `OtterGenerator.generate`
    of 8 tokens from the trained model (composed route, int8 cache)."""
    import gc
    import numpy as np
    import torch
    from otter_tpu_torch.config import GenerationConfig
    from otter_tpu_torch.generation.engine import OtterGenerator
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import TrainArgs
    from otter_tpu_torch.train.step import (TrainState, make_optimizer,
                                            make_train_step, split_params)

    b, s, warm, timed = 2, 1024, 2, 3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model, cfg = build_lora_model()
    tok = SmokeTokenizer(cfg)
    batch = sft.prepare_batch(make_train_batch(cfg, tok, SEED + 100, b, s),
                              tok, TrainArgs())
    fwd = lambda m: m(torch.as_tensor(batch["vision_x"], device=DEV),
                      torch.as_tensor(batch["input_ids"], device=DEV).long(),
                      attention_mask=torch.as_tensor(
                          batch["attention_mask"], device=DEV))[0]
    # B = 0 before training: the LoRA-free model's logits, bit for bit
    with torch.no_grad():
        lora_logits = fwd(model)
        plain, _ = build_int8_train_model()
        plain_logits = fwd(plain)
        same = torch.equal(lora_logits, plain_logits)
        gap = float((lora_logits.float() - plain_logits.float()).abs().max())
    del plain, plain_logits, lora_logits
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lora: before training (B = 0) the first-step logits "
        f"[{b}, {s}, V] {'equal' if same else 'DIFFER from'} the LoRA-free "
        f"model's bit for bit (max |diff| {gap:.3e})")

    trainable, frozen = split_params(model, cfg)
    adapters = [k for k in trainable if k.endswith(("lora_a", "lora_b"))]
    tx = make_optimizer(trainable, lr=1e-4, total_steps=100, state_bits=8)
    state = TrainState.create(model, cfg, tx)
    step = make_train_step(model, cfg, tx, mask_embedding=True,
                           fused_ce_chunk=256)
    tensors = {**{k: p for k, p in state.trainable.items()},
               **{k: p for k, p in state.frozen.items()},
               **{n.replace(".", "/"): t for n, t in model.named_buffers()}}
    layer_paths = [k for k in tensors if k.startswith("lang_encoder/layers_")]
    before = _tensor_sums(tensors)
    int8_before = {k: t.clone() for k, t in tensors.items()
                   if t.dtype == torch.int8}
    mem = _state_bytes(state)
    calls = _StepCalls(_flash_wrappers())
    step = calls.wrap(step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(warm + timed):
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    steps, per_step = calls.step_ms(), calls.counts
    after = _tensor_sums(tensors)
    moved = sorted({k for k in layer_paths if before[k] != after[k]})
    int8_same = all(torch.equal(t, tensors[k])
                    for k, t in int8_before.items())
    step_s = float(np.median(steps[warm:])) / 1e3
    n_ad = sum(state.trainable[k].numel() for k in adapters)
    log(f"lora: OTTER-MPT7B, int8 frozen decoder layers with LoRA rank "
        f"{LORA_RANK} on Wqkv (alpha 16; {len(adapters)} adapter tensors, "
        f"{n_ad / 1e6:.2f}M parameters), xattn bf16, 8-bit Adam, b={b} "
        f"s={s}, remat, fused CE 256, lr 1e-4; {_gb(mem)} | {smi}")
    log(f"lora: losses {[round(x, 5) for x in losses]}; step ms "
        f"{steps} | median of the last "
        f"{timed}: {step_s * 1e3:.2f} ms, {b * s / step_s:.1f} tokens/s | "
        f"{smi}")
    log(f"lora: peak memory {(peak - base) / 2 ** 30:.2f} GiB above the "
        f"{base / 2 ** 30:.2f} GiB allocated before, absolute "
        f"{peak / 2 ** 30:.2f} GiB; flash launches a step {per_step}")
    log(f"lora: decoder-layer tensors that moved: {len(moved)} (the "
        f"{len(adapters)} adapters: "
        f"{'yes' if moved == sorted(adapters) else 'NO'}); the "
        f"{len(int8_before)} int8 tensors "
        f"{'bit-identical' if int8_same else 'CHANGED'}")
    failed = [] if same else [f"B = 0 logits differ by {gap}"]
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        failed.append(f"losses {losses}")
    if moved != sorted(adapters):
        failed.append(f"decoder-layer tensors moved: "
                      f"{sorted(set(moved) ^ set(adapters))[:4]}")
    if not int8_same:
        failed.append("a frozen int8 tensor changed")
    still = [k for k in state.trainable if before[k] == after[k]]
    if still:
        failed.append(f"trainable tensors did not move: {still[:4]}")
    want = train_step_flash(cfg)
    if any(c != want for c in per_step):
        failed.append(f"flash launches a step {per_step}, want {want}")
    launches = {k: sum(c[k] for c in per_step) for k in FLASH_COUNTERS}

    # one greedy request from the trained model: the composed route
    del state, tx, step
    gc.collect()
    torch.cuda.empty_cache()
    model.eval()
    engine = OtterGenerator(model, cache_dtype=torch.int8)
    vx, ids, mask = make_requests(cfg, 1, SEED + 101)
    gen = GenerationConfig(max_new_tokens=8)
    got = _launches_of(lambda: engine.generate(vx, ids, mask, gen=gen))
    out = [engine.generate(vx, ids, mask, gen=gen) for _ in range(2)]
    new = out[0][0, ids.shape[1]:].tolist()
    log(f"lora: greedy generate of 8 tokens from the trained model "
        f"({ids.shape[1]}-token prompt, one image): {new}, the same twice: "
        f"{bool(np.array_equal(out[0], out[1]))}; launches {got}")
    if not np.array_equal(out[0], out[1]) or len(new) != 8:
        failed.append(f"generate gave {out[0].tolist()} then "
                      f"{out[1].tolist()}")
    # a prefill's CLIP, perceiver, decoder and xattn; then 7 steps of the
    # decoder's int8 MLPs and int8-cache attention (the xattn FFs are bf16)
    n = cfg.text.num_hidden_layers
    want_gen = {"flash_fwd": cfg.vision.num_hidden_layers
                + cfg.perceiver.depth + n + n // cfg.cross_attn_every_n_layers,
                "int8_mlp": 7 * n, "decode_attention": 7 * n}
    if got != want_gen:
        failed.append(f"generate launched {got}, want {want_gen}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    del engine, model
    if failed:
        raise RuntimeError("lora phase failed: " + "; ".join(failed))
    return launches


# ── trainparity: the pretraining, fuyu and LoRA steps at cut depth ───

def pretrain_batches(cfg, seed: int, pair=(4, 32), mmc4=(2, 256)):
    """A LAION batch (one image, a caption closed by <|endofchunk|>, pair
    labels) and an MMC4 batch (five image slots, three media tokens each
    after an <|endofchunk|>, interleaved labels), right-padded with
    `write_tokenizer`'s <PAD> (numpy), as the shard pipelines give them."""
    import numpy as np
    from otter_tpu_torch.train.pretrain import (interleaved_labels,
                                                pair_labels)
    rng = np.random.default_rng(seed)
    size = cfg.vision.image_size
    m, e = cfg.media_token_id, cfg.eoc_token_id
    pad = m + 1
    out = []
    for (b, s), slots in ((pair, 1), (mmc4, 5)):
        ids = rng.integers(5, e, (b, s)).astype(np.int32)
        lens = np.linspace(s, s * 3 // 4, b).astype(int)
        media = [0] if slots == 1 else [0, s // 4, s // 2]
        ids[:, media] = m
        for p in media[1:]:
            ids[:, p - 1] = e
        for i, n in enumerate(lens):
            ids[i, n - 1] = e
            ids[i, n:] = pad
        labels = (pair_labels(ids, pad, m) if slots == 1
                  else interleaved_labels(ids, pad, m, e))
        out.append({"vision_x": rng.standard_normal(
                        (b, slots, 1, 3, size, size)).astype(np.float32),
                    "input_ids": ids, "attention_mask": (ids != pad).astype(
                        np.int32), "labels": labels})
    return out


@contextlib.contextmanager
def _nudged_attention(seed: int):
    """The plain versions, each attention output moved by one bf16
    rounding (x * (1 +- 2^-8), the signs drawn from `seed`): the bf16
    plain step's spread where the kernels differ from it."""
    import torch
    from otter_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)

    def fwd(*a, return_lse=False, **kw):
        out = fa.flash_attention_plain(*a, return_lse=True, **kw)
        sign = torch.randint(0, 2, out[0].shape, generator=gen,
                             device=out[0].device) * 2 - 1
        moved = (out[0].float() * (1 + 2.0 ** -8 * sign)).to(out[0].dtype)
        return (moved, out[1]) if return_lse else moved

    with plain_kernels():
        fa.flash_attention_fwd = fwd
        yield


@contextlib.contextmanager
def _swapped_attention(fwd=None, bwd=None):
    """`fwd` / `bwd` in place of the flash forward / backward wrappers
    (each left as it is where None)."""
    from otter_tpu_torch.ops import flash_attention as fa
    saved = fa.flash_attention_fwd, fa.flash_attention_bwd
    fa.flash_attention_fwd, fa.flash_attention_bwd = fwd or saved[0], \
        bwd or saved[1]
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = saved


# Slightly wrong flash kernels, to check the check: `_new_step_parity`
# requires the held check (its bf16 floor included) to reject a step
# through each of them.
BROKEN_FLASH = ("dS with the next query row's di",
                "softmax scale 1/8 too large")


def _broken_flash(kind):
    """The flash kernels with one slip (`BROKEN_FLASH`): the backward's
    dS = p (dp - di) taken with the next query row's di (the kernels
    themselves run, on a shifted di), or the softmax scale 1/8 too large
    in the forward and the backward alike."""
    from otter_tpu_torch.ops import flash_attention as fa
    fwd0, bwd0 = fa.flash_attention_fwd, fa.flash_attention_bwd
    if kind == BROKEN_FLASH[0]:
        def bwd(q, k, v, bias, q_ids, kv_ids, o, lse, do, **kw):
            di = (o.float() * do.float()).sum(-1).roll(-1, dims=-1)
            dk, dv = fa.flash_bwd_dkv(q, k, v, bias, q_ids, kv_ids, lse, di,
                                      do, **kw)
            dq = fa.flash_bwd_dq(q, k, v, bias, q_ids, kv_ids, lse, di, do,
                                 **kw)
            return dq, dk, dv
        return _swapped_attention(bwd=bwd)

    def scaled(kw, d):
        return dict(kw, sm_scale=1.125 * (kw.get("sm_scale") or d ** -0.5))

    def fwd(q, k, v, bias=None, q_ids=None, kv_ids=None, **kw):
        return fwd0(q, k, v, bias, q_ids, kv_ids, **scaled(kw, q.shape[-1]))

    def bwd(q, k, v, bias, q_ids, kv_ids, o, lse, do, **kw):
        return bwd0(q, k, v, bias, q_ids, kv_ids, o, lse, do,
                    **scaled(kw, q.shape[-1]))
    return _swapped_attention(fwd, bwd)


def _sdpa_attention():
    """torch's `scaled_dot_product_attention` in place of the flash pair
    (its backward by autograd over the forward recomputed): the library's
    rounding beside the kernels'. Masked pairs take -1e9 and rows that
    attend no key give zeros, as the kernels' do."""
    import torch
    import torch.nn.functional as F
    from otter_tpu_torch.ops import flash_attention as fa

    def attend(q, k, v, bias, q_ids, kv_ids, causal=False, sm_scale=None,
               ids_mode="eq", **_):
        mask = fa._attend_mask(q, k, q_ids, kv_ids, causal, ids_mode)
        add = None if bias is None else bias.to(q.dtype)
        if mask is not None:
            zero = torch.zeros((), dtype=q.dtype, device=q.device)
            add = torch.where(mask, zero if add is None else add,
                              torch.full_like(zero, -1e9))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=add,
                                           scale=sm_scale)
        if mask is None:
            return o
        return torch.where(mask.any(-1, keepdim=True), o,
                           torch.zeros_like(o))

    def fwd(q, k, v, bias=None, q_ids=None, kv_ids=None, *,
            return_lse=False, **kw):
        with torch.no_grad():
            o = attend(q, k, v, bias, q_ids, kv_ids, **kw)
        # (the backward below recomputes; it reads no LSE)
        lse = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        return (o, lse) if return_lse else o

    def bwd(q, k, v, bias, q_ids, kv_ids, o, lse, do, **kw):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attend(*leaves, bias, q_ids, kv_ids, **kw)
            return torch.autograd.grad(out, leaves, do)
    return _swapped_attention(fwd, bwd)


def _recorded_step(run, rec, ctx):
    """(loss, grad_norm, {path: grad}, flash launches) of `run()`, one
    step whose optimizer is the `_GradRecorder` `rec`, under `ctx`."""
    wrappers = _flash_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with ctx:
        _, m = run()
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    return loss, gnorm, dict(rec.grads), {k: w.launches
                                          for k, w in wrappers.items()}


def _pretrain_grads(dtype, batches, ctx):
    from otter_tpu_torch.models.convert import load_flax_params
    from otter_tpu_torch.models.otter import OtterVLM
    from otter_tpu_torch.train import pretrain
    from otter_tpu_torch.train.step import TrainState
    cfg = pretrain_cfg(depth_cut=True)
    model = OtterVLM(cfg, dtype=dtype, device=DEV)
    load_flax_params(model, random_params(cfg))
    rec = _GradRecorder()
    state = TrainState.create(model, cfg, rec)
    step = pretrain.make_pretrain_step(model, cfg, rec)
    return _recorded_step(lambda: step(state, *batches, attend_prev=True),
                          rec, ctx)


def _fuyu_grads(dtype, batch, ctx):
    import torch
    from otter_tpu_torch.train import fuyu_sft
    model, _ = build_fuyu_train_model(depth_cut=True, dtype=dtype)
    # (bf16 copies: three runs' f32 gradients of the 262144-row embedding
    # and head would hold ~35 GB)
    rec = _GradRecorder(dtype=torch.bfloat16)
    state = fuyu_sft.fuyu_train_state(model, rec)
    step = fuyu_sft.make_fuyu_train_step(model, rec)
    return _recorded_step(lambda: step(state, batch), rec, ctx)


def _lora_grads(dtype, batch, ctx):
    from otter_tpu_torch.train.step import TrainState, make_train_step
    model, cfg = build_lora_model(depth_cut=True, dtype=dtype)
    rec = _GradRecorder()
    state = TrainState.create(model, cfg, rec)
    step = make_train_step(model, cfg, rec, mask_embedding=True,
                           fused_ce_chunk=256)
    return _recorded_step(lambda: step(state, batch), rec, ctx)


def _new_step_parity(batch):
    """One pretraining step (Flamingo-MPT-1B cut: both batches), one
    OtterHD full fine-tune step (cut to 4 layers, a 448² image) and one
    LoRA step (the int8-frozen recipe with rank 16, trainparity's batch),
    each through the kernels against the plain versions (`_hold_step`,
    with the bf16 floor of `_nudged_attention`'s three draws). Then,
    where the floor held a tensor, the check is checked: a step through
    each of `BROKEN_FLASH`'s kernels must fail it, floor included. The
    pretraining step also shows where the tensors at the floor move
    (`_floor_sources`), on its batch and on a second one."""
    import torch
    from otter_tpu_torch.train import fuyu_sft
    fcfg = fuyu_train_cfg(depth_cut=True)
    texts, images = zip(*fuyu_train_samples(SEED + 120, (448,)))
    cases = (
        ("pretrain step", _pretrain_grads,
         pretrain_batches(pretrain_cfg(True), SEED + 110),
         pretrain_step_flash(pretrain_cfg(True))),
        ("fuyu step", _fuyu_grads,
         fuyu_sft.FuyuBatcher(fuyu_processor(fcfg))(texts, images),
         fuyu_train_step_flash(fcfg)),
        ("LoRA step", _lora_grads, batch, train_step_flash(lora_cfg(True))))
    missed = []
    for tag, grads, arg, want in cases:
        runs = {name: grads(dtype, arg, ctx) for name, dtype, ctx in (
            ("kernels", torch.bfloat16, contextlib.nullcontext()),
            ("plain", torch.bfloat16, plain_kernels()),
            ("plain_f32", torch.float32, plain_kernels()))}
        f32 = runs["plain_f32"][2]
        nudged = {k: 0.0 for k in f32}
        for i in range(3):
            g = grads(torch.bfloat16, arg, _nudged_attention(SEED + 130 + i))[2]
            nudged = {k: max(e, _rel(g[k], f32[k])) for k, e in nudged.items()}
            del g
        floor = _hold_step(tag, runs, want, nudged)
        # (a step with no tensor at the floor holds every tensor to the
        # bar alone: its controls would check nothing the floor changes)
        for kind in BROKEN_FLASH if floor else ():
            broken = dict(runs, kernels=grads(torch.bfloat16, arg,
                                              _broken_flash(kind)))
            held, _ = _step_failures(tag, broken, want, nudged, quiet=True)
            bare, _ = _step_failures(tag, broken, want, quiet=True)
            log(f"trainparity[{tag}] control, flash with {kind}: "
                f"{'rejected' if held else 'PASSED'} by the check "
                f"({len(held)} failures, first: {held[:2]}); "
                f"{len(bare)} failures without the bf16 floor")
            if not held:
                missed.append(f"{tag}: {kind}")
            del broken
        if tag == "pretrain step":
            _floor_sources(tag, grads, arg, runs, nudged, floor)
            # the same readings on a second batch, not held: whether the
            # paths keep their order there
            second = pretrain_batches(pretrain_cfg(True), SEED + 111)
            _floor_sources(tag + ", second batch", grads, second, {
                name: grads(dtype, second, ctx) for name, dtype, ctx in (
                    ("kernels", torch.bfloat16, contextlib.nullcontext()),
                    ("plain", torch.bfloat16, plain_kernels()),
                    ("plain_f32", torch.float32, plain_kernels()))},
                None, floor)
        del runs
    if missed:
        raise RuntimeError("trainparity: the check let a broken flash "
                           "kernel through: " + "; ".join(missed))


def _floor_sources(tag, grads, arg, runs, nudged, floor):
    """For each tensor of `floor` (those held against the f32 step): its
    error (/ max|f32|) through the kernels, through the forward kernel
    alone (plain backward), through the backward kernels alone (plain
    forward), through torch's SDPA, through the plain path and, given
    `nudged`, the plain path's largest under one-rounding nudges; and the
    same errors' maximum over the other tensors."""
    import torch
    from otter_tpu_torch.ops import flash_attention as fa
    f32 = runs["plain_f32"][2]
    cols = {"kernels": runs["kernels"][2]}
    for name, ctx in (
            ("fwd kernel", _swapped_attention(
                bwd=fa.flash_attention_bwd_plain)),
            ("bwd kernels", _swapped_attention(fwd=fa.flash_attention_plain)),
            ("SDPA", _sdpa_attention())):
        cols[name] = grads(torch.bfloat16, arg, ctx)[2]
    cols["plain"] = runs["plain"][2]
    errs = {name: {k: _rel(g[k], f32[k]) for k in f32}
            for name, g in cols.items()}
    if nudged is not None:
        errs["plain, nudged"] = nudged
    log(f"trainparity[{tag}]: where the tensors at the floor move, error / "
        f"max|f32| of: {' | '.join(errs)}")
    rest = [k for k in f32 if k not in floor]
    for k in floor:
        log("    " + " | ".join(f"{e[k]:.3e}" for e in errs.values())
            + f"  {k} (max|f32| {float(f32[k].abs().max()):.3e})")
    log("    " + " | ".join(f"{max(e[k] for k in rest):.3e}"
                            for e in errs.values())
        + f"  max over the other {len(rest)} tensors")
    del cols


def _profile_train_step(label, state, cfg, batch, tx, fname):
    """torch.profiler over one more step of the trained state (after the
    phase's checks): where a step's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.train.step import make_train_step
    step = make_train_step(state.model, cfg, tx, mask_embedding=True,
                           fused_ce_chunk=256)
    step(state, batch)
    torch.cuda.synchronize()
    os.makedirs(OUT_DIR, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    _report_profile(prof, wall, label, fname)



# ── phase 21: the parallel layer (ring attention, the one-rank mesh) ─

RING_RANKS = 4


def _ring_cases(gen):
    """The ring's two full-width shapes: MPT-7B's training self-attention
    (32 heads of 128, b=2, S=4096, causal, ALiBi column bias, right
    padding ids) and OtterHD-8B's full-HD prefill (64 heads of 64, b=1,
    S=2356 = 4 x 589, causal)."""
    import torch
    from otter_tpu_torch.ops.masks import alibi_slopes
    out = []
    for name, b, h, s, d in (("mpt7b", 2, 32, 4096, 128),
                             ("otterhd8b", 1, 64, 2356, 64)):
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=DEV,
                                   dtype=torch.bfloat16) for _ in range(4))
        kw = dict(causal=True)
        if name == "mpt7b":
            slopes = alibi_slopes(h, 8.0, device=DEV)
            kw["bias"] = (torch.arange(1 - s, 1, device=DEV)[None, None, None]
                          * slopes[None, :, None, None]).float()
            ids = torch.ones(b, s, dtype=torch.int32, device=DEV)
            ids[0, -300:] = 0
            ids[1, -700:] = 0
            kw["q_ids"] = kw["kv_ids"] = ids
        out.append((name, (q, k, v, do), kw))
    return out


def _bwd_excess(out, ref) -> float:
    """The largest excess of |out - ref| over 2e-2 max|ref| + 2e-2 |ref|."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    return float((d - (2e-2 * r.max() + 2e-2 * r)).max())


def _ring_phase_part(gen):
    """The ring's per-rank code for RING_RANKS ranks in this process
    (`ring_attention_local_fwd` / `_bwd`: the same block, merge and
    rotation functions as a process ring, the rotation by index) against
    one flash call over the whole sequence, forward and backward, with
    each side's device ms. Returns (launches of one ring forward and
    backward of each shape, failures)."""
    import torch
    from otter_tpu_torch.ops import flash_attention as fa
    from otter_tpu_torch.ops.ring_attention import (ring_attention_local_bwd,
                                                    ring_attention_local_fwd)
    wrappers = _flash_wrappers()
    n = RING_RANKS
    total, failed = {k: 0 for k in wrappers}, []
    for name, (q, k, v, do), kw in _ring_cases(gen):
        for w in wrappers.values():
            w.launches = 0
        out, lse = ring_attention_local_fwd(q, k, v, n=n, **kw)
        grads = ring_attention_local_bwd(q, k, v, out, lse, do, n=n, **kw)
        torch.cuda.synchronize()
        counts = {key: w.launches for key, w in wrappers.items()}
        blocks = n * (n + 1) // 2          # causal: src <= idx
        if counts != {key: blocks for key in wrappers}:
            failed.append(f"{name}: ring launches {counts}, want {blocks} "
                          f"of each")
        for key in total:
            total[key] += counts[key]
        ref, ref_lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        ref_grads = fa.flash_attention_bwd(q, k, v, kw.get("bias"),
                                           kw.get("q_ids"), kw.get("kv_ids"),
                                           ref, ref_lse, do, causal=True)
        err, excess = max_err(out, ref)
        g_excess = [_bwd_excess(g, r) for g, r in zip(grads, ref_grads)]
        g_err = [float((g.float() - r.float()).abs().max())
                 for g, r in zip(grads, ref_grads)]
        ms = {
            "ring_fwd": device_ms(lambda: ring_attention_local_fwd(
                q, k, v, n=n, **kw), iters=3),
            "ring_bwd": device_ms(lambda: ring_attention_local_bwd(
                q, k, v, out, lse, do, n=n, **kw), iters=3),
            "flash_fwd": device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, return_lse=True, **kw), iters=3),
            "flash_bwd": device_ms(lambda: fa.flash_attention_bwd(
                q, k, v, kw.get("bias"), kw.get("q_ids"), kw.get("kv_ids"),
                ref, ref_lse, do, causal=True), iters=3)}
        log(f"parallel[ring {name}]: {tuple(q.shape)}, {n} ranks in one "
            f"process, max|err| out {err:.3e} (excess {excess:.3e}), "
            f"dq/dk/dv {[f'{e:.3e}' for e in g_err]} (excess "
            f"{[f'{e:.3e}' for e in g_excess]}), launches {counts}; device "
            f"ms: " + json.dumps({k_: round(v_, 4) for k_, v_ in ms.items()}))
        if not (excess <= 0 and all(e <= 0 for e in g_excess)):
            failed.append(f"{name}: the ring is outside the flash bars "
                          f"(out {excess:.3e}, grads {g_excess})")
        del out, lse, grads, ref, ref_lse, ref_grads
    return total, failed


def _one_rank_mesh_part(work: str):
    """`sft.main` with --multi_host over NCCL at RANK=0, WORLD_SIZE=1 and
    --fsdp -1 (the mesh and `fully_shard` at extent 1) on the train
    phase's model at full width and cut depth, against the unsharded
    `sft.main` over the same data YAML and seed: each step's loss within
    1e-2 relative and its grad norm within 2e-2, as trainparity holds the
    kernel run to the plain one. The mesh run's final checkpoint (rank 0
    writes it) is restored into its state and every tensor loads back
    equal. Returns (the mesh run's flash launches,
    failures)."""
    import torch
    import torch.distributed as dist
    from otter_tpu_torch.runtime.checkpoint import CheckpointStore
    from otter_tpu_torch.train import sft
    from otter_tpu_torch.train.args import parse_args
    cfg = train_cfg(depth_cut=True)
    custom = os.path.join(work, "cut.json")
    with open(custom, "w") as f:
        json.dump(cfg.to_dict(), f)
    yaml_path = write_train_data(os.path.join(work, "data"), SEED + 70,
                                 n_single=4, n_context=2)
    tok_dir = write_tokenizer(os.path.join(work, "tok"), cfg)
    per_step = train_step_flash(cfg)
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port())}
    runs, failed = {}, []
    for name in ("one", "mesh"):
        argv = _yaml_argv(cfg, yaml_path, tok_dir, work, name,
                          "--customized_config", custom)
        if name == "mesh":
            # the final checkpoint on, --multi_host, fsdp over every rank
            argv = [a for a in argv if a != "--final_checkpoint"] + [
                "--multi_host", "--fsdp", "-1"]
            os.environ.update(env)
        wrappers = _flash_wrappers()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        try:
            state = sft.main(parse_args(argv), params=random_params(cfg),
                             device=DEV)
            counts = {k: w.launches for k, w in wrappers.items()}
            metrics = _read_metrics(os.path.join(work, name))
            wall = time.perf_counter() - t0
            log(f"parallel[sft.main {name}]: {len(metrics)} steps in "
                f"{wall:.1f} s, losses "
                f"{[round(m['loss'], 5) for m in metrics]}, grad norms "
                f"{[round(m['grad_norm'], 5) for m in metrics]}, launches "
                f"{counts}")
            runs[name] = (metrics, counts)
            if name == "mesh":
                failed += _restore_check(CheckpointStore(
                    os.path.join(work, name)), state)
                dist.destroy_process_group()
        finally:
            if name == "mesh":
                for key in env:
                    os.environ.pop(key, None)
        del state
        torch.cuda.empty_cache()
    (m1, _), (mm, cm) = runs["one"], runs["mesh"]
    if len(m1) != len(mm) or not mm:
        failed.append(f"steps {len(mm)} vs {len(m1)}")
    for i, (a, b) in enumerate(zip(mm, m1)):
        if not (math.isfinite(a["loss"])
                and abs(a["loss"] - b["loss"]) <= 1e-2 * abs(b["loss"])):
            failed.append(f"step {i + 1} loss {a['loss']} vs {b['loss']}")
        if not abs(a["grad_norm"] - b["grad_norm"]) <= 2e-2 * b["grad_norm"]:
            failed.append(f"step {i + 1} grad norm {a['grad_norm']} vs "
                          f"{b['grad_norm']}")
    want = {k: v * len(mm) for k, v in per_step.items()}
    if cm != want:
        failed.append(f"mesh launches {cm} (want {want})")
    return cm, failed


def _restore_check(store, state):
    """Restore the latest checkpoint into `state` after zeroing its
    trainable tensors and optimizer moments: every one loads back equal to
    what it held."""
    import torch
    from otter_tpu_torch.train.step import local_tensor
    before = {k: local_tensor(p).detach().clone()
              for k, p in state.trainable.items()}
    opt = {key: {k: t.clone() for k, t in getattr(state.opt_state,
                                                  key).items()}
           for key in ("master", "mu", "nu")}
    t0 = time.perf_counter()
    with torch.no_grad():
        for p in state.trainable.values():
            local_tensor(p).zero_()
        for key in opt:
            for t in getattr(state.opt_state, key).values():
                t.zero_()
    store.restore(state)
    wall = time.perf_counter() - t0
    differ = [k for k, p in state.trainable.items()
              if not torch.equal(local_tensor(p), before[k])]
    differ += [f"{key}/{k}" for key, ts in opt.items()
               for k, t in ts.items()
               if not torch.equal(getattr(state.opt_state, key)[k], t)]
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(store.directory) for f in fs)
    log(f"parallel[checkpoint]: {size / 1e9:.3f} GB written by rank 0, "
        f"restored in {wall:.1f} s: {len(before) - len(differ)} of "
        f"{len(before)} trainable tensors and every moment equal"
        if not differ else f"parallel[checkpoint]: unequal {differ[:5]}")
    return [f"the checkpoint loads back unequal: {differ[:5]}"] if differ \
        else []


def phase_parallel(smi: str, gen):
    """The parallel layer on one card: the ring's per-rank code at MPT-7B's
    and OtterHD-8B's shapes against one flash call, and the trainer's
    one-rank NCCL mesh against the unsharded trainer. Returns the flash
    launches of the ring drive and of the mesh run."""
    import tempfile
    t0 = time.perf_counter()
    ring_counts, failed = _ring_phase_part(gen)
    t_ring = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as work:
        mesh_counts, more = _one_rank_mesh_part(work)
    failed += more
    log(f"parallel: ring part {t_ring:.1f} s, mesh part "
        f"{time.perf_counter() - t0 - t_ring:.1f} s | {smi}")
    if failed:
        raise RuntimeError("parallel: " + "; ".join(failed))
    return {k: ring_counts[k] + mesh_counts[k] for k in ring_counts}


# ── the batch phase's old crash pattern (not in the default run) ─────

PROFILE_RACE_REPS = 4


def _profile_race():
    """The pattern two default runs crashed in: a `ContinuousBatcher` of 8
    slots on OTTER-MPT7B (int8, full width and depth) serves 12 requests on
    consumer threads while the main thread starts and stops torch.profiler
    (CPU and CUDA activity) every ~0.2 s, PROFILE_RACE_REPS times over."""
    import threading
    import torch
    from torch.profiler import ProfilerActivity, profile
    from otter_tpu_torch.generation.batching import ContinuousBatcher
    cfg = serving_cfg()
    model = build_model(cfg)
    reqs = batch_requests(cfg, SEED + 300)[:12]
    windows = 0
    for rep in range(PROFILE_RACE_REPS):
        b = ContinuousBatcher(model, num_slots=8, cache_len=2048,
                              prefill_chunk=256, cache_dtype=torch.int8,
                              rng_seed=SEED)
        done = []
        try:
            th = threading.Thread(target=lambda: done.append(
                _run_requests(b, reqs, 8, 0.02)))
            th.start()
            while th.is_alive():
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                time.sleep(0.2)
                log(f"profilerace: repetition {rep + 1}, stopping profiler "
                    f"window {windows + 1}")
                prof.stop()
                windows += 1
                time.sleep(0.05)
            th.join()
        finally:
            b.shutdown()
        if b._failure is not None or not done:
            raise RuntimeError("profilerace: the batcher failed") \
                from b._failure
        log(f"profilerace: repetition {rep + 1} passed ({windows} profiler "
            f"windows so far)")
    log(f"profilerace: {PROFILE_RACE_REPS} repetitions, {windows} profiler "
        f"starts and stops, no crash")


def phase_profilerace(smi: str):
    """ROADMAP Queue 3's reproduction: `_profile_race` in a child process
    (`--phases profilerace_child`), so that a crash there ends the child
    only. Reports the child's exit code, the profiler windows it passed
    and, where it crashed, the first lines of its fatal error; the child's
    whole output goes to OUT_DIR/profilerace.txt. Either outcome is the
    phase's reading: it fails only where the child could not run."""
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phases",
         "profilerace_child"], capture_output=True, text=True, timeout=900)
    text = out.stdout + out.stderr
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profilerace.txt"), "w") as f:
        f.write(text)
    lines = text.splitlines()
    windows = [ln for ln in lines if ln.startswith("profilerace: repetition")
               and "stopping" in ln]
    fatal = [ln for ln in lines if "Fatal Python error" in ln
             or "double free" in ln or "corrupt" in ln
             or "Segmentation" in ln]
    if out.returncode == 0:
        log(f"profilerace: no crash: {lines[-3] if len(lines) > 2 else ''} "
            f"| {smi}")
    else:
        log(f"profilerace: the child ended with rc {out.returncode} while "
            f"stopping {windows[-1] if windows else 'no profiler window'}: "
            f"{fatal[:3]} | {smi}")
        if not windows:
            raise RuntimeError("profilerace: the child failed before the "
                               "pattern ran; see profilerace.txt")

# ── phase 22: the eval harness on the card ───────────────────────────

EVAL_PATH = {"flash_fwd", "int8_mlp", "decode_attention"}
EVAL_NEW = 16       # the harness's new tokens a row (the reference: 512)
ADAPTER_NEW = 8     # the other adapters' new tokens a row
ADAPTER_ROWS = 2    # POPE rows through each of the other adapters


class EvalTokenizer:
    """The tokenizer surface the eval adapters and the Fuyu processor call
    (`tok(text, return_tensors="np")`, `decode`), for real English
    questions: each of `specials` ({text: id}) keeps its id, wherever it
    stands in the text; any other whitespace-separated word takes an id
    in [3, `top`) from its CRC-32 (the same word, the same id); `decode`
    writes ` t<id>` for each id but the specials and eos."""

    def __init__(self, specials: dict, top: int, eos_token_id: int,
                 bos_token_id=None):
        self.specials, self.top = dict(specials), top
        self.eos_token_id, self.bos_token_id = eos_token_id, bos_token_id
        self._special_ids = set(self.specials.values()) | {eos_token_id}

    def _ids(self, text):
        import re
        import zlib
        pat = "(" + "|".join(map(re.escape, self.specials)) + ")"
        ids = []
        for part in re.split(pat, text):
            if part in self.specials:
                ids.append(self.specials[part])
            else:
                ids.extend(3 + zlib.crc32(w.encode()) % (self.top - 3)
                           for w in part.split())
        return ids

    def __call__(self, text, return_tensors=None, **kw):
        import numpy as np
        ids = self._ids(text)
        if return_tensors == "np":
            return {"input_ids": np.asarray([ids], np.int64),
                    "attention_mask": np.ones((1, len(ids)), np.int64)}
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f" t{int(i)}" for i in ids
                       if not (skip_special_tokens
                               and int(i) in self._special_ids))


def otter_eval_tokenizer(cfg):
    """OTTER's added tokens at the config's ids (<answer> after
    <|endofchunk|> and <image>, as OTTER-MPT7B's tokenizer numbers it)."""
    return EvalTokenizer({"<image>": cfg.media_token_id,
                          "<|endofchunk|>": cfg.eoc_token_id,
                          "<answer>": max(cfg.media_token_id,
                                          cfg.eoc_token_id) + 1},
                         min(cfg.media_token_id, cfg.eoc_token_id),
                         eos_token_id=cfg.eoc_token_id)


# adept/fuyu-8b's tokenizer: |ENDOFTEXT| 71013, the beginning of an answer
# "\x04" 71122; text ids below the image ids
FUYU_EOS, FUYU_BOA = 71013, 71122


def _counted(fn):
    """(fn(), the launches `fn` made): every count set to 0 just before
    and read just after."""
    from otter_tpu_torch.tools import bench_decode
    bench_decode.reset_kernel_launches()
    out = fn()
    return out, {k: n for k, n in bench_decode.kernel_launches().items()
                 if n}


class _Answers:
    """Records what an adapter class's `generate` / `generate_batch`
    return while the harness drives it."""

    def __init__(self, cls):
        self.cls, self.texts = cls, []

    def __enter__(self):
        self.saved = self.cls.generate, self.cls.generate_batch
        gen, batch = self.saved

        def generate(inner, *a, **k):
            self.texts.append(gen(inner, *a, **k))
            return self.texts[-1]

        def generate_batch(inner, *a, **k):
            out = batch(inner, *a, **k)
            self.texts.extend(out)
            return out

        self.cls.generate, self.cls.generate_batch = generate, generate_batch
        return self

    def __exit__(self, *exc):
        self.cls.generate, self.cls.generate_batch = self.saved


def _eval_scores_checked(res: dict) -> list:
    """Every rate of the MME and POPE reports in [0, 1]; MME's category
    scores in [0, 200] (acc + acc+, in percent). Returns the POPE
    accuracy and MME's totals."""
    bad = []
    for etype, block in res["mme"].items():
        for cat, d in block["categories"].items():
            for k in ("acc", "acc_plus"):
                if not 0.0 <= d[k] <= 1.0:
                    bad.append(f"mme {cat} {k} {d[k]}")
            if not 0.0 <= d["score"] <= 200.0:
                bad.append(f"mme {cat} score {d['score']}")
    for cat, d in res["pope"].items():
        for k in ("accuracy", "precision", "recall", "f1", "yes_ratio"):
            if not 0.0 <= d[k] <= 1.0:
                bad.append(f"pope {cat} {k} {d[k]}")
    if bad or set(res["mme"]) != {"Perception", "Cognition"}:
        raise RuntimeError(f"eval: scores out of range {bad} or MME types "
                           f"{sorted(res['mme'])}")
    return [res["pope"]["overall"]["accuracy"],
            {k: v["total"] for k, v in res["mme"].items()}]


def _adapter_rates(tag, adapter, question, image, smi, new: int):
    """Seconds a row (one `generate` of `new` tokens) and decode tok/s
    from (t(new) - t(1)) / (new - 1), medians of 3, with eos off."""
    import numpy as np
    saved = adapter.max_new_tokens
    times = {1: [], new: []}
    try:
        for _ in range(3):
            for n in (1, new):
                adapter.max_new_tokens = n
                t = time.perf_counter()
                adapter.generate(question, image)
                times[n].append(time.perf_counter() - t)
    finally:
        adapter.max_new_tokens = saved
    row = float(np.median(times[new]))
    step = (row - float(np.median(times[1]))) / (new - 1)
    log(f"eval {tag}: {row:.3f} s a row of {new} new tokens, decode "
        f"{1 / step:.2f} tok/s ({step * 1e3:.2f} ms a step) | medians of "
        f"3: 1-token {[round(x * 1e3, 1) for x in times[1]]} ms, {new}-token "
        f"{[round(x * 1e3, 1) for x in times[new]]} ms | {smi}")


def _noise_manifest(directory: str, n: int = 16, size: int = 256):
    """`n` VQA items, each a noise PNG file (written with zlib) with a
    question and ten answers."""
    import numpy as np
    rng = np.random.default_rng(SEED + 90)
    items, raws = [], []
    words = ["red", "blue", "two", "dog", "yes", "no"]
    for i in range(n):
        path = os.path.join(directory, f"noise_{i:02d}.png")
        raws.append(png_bytes(rng.integers(0, 256, (size, size, 3)).astype(
            np.uint8)))
        with open(path, "wb") as f:
            f.write(raws[-1])
        items.append({"image": path, "question": f"what is in picture {i}?",
                      "answers": [str(w) for w in rng.choice(words, 10)]})
    return items, raws


def _native_on_the_host(raws, smi):
    """The C++ decoder, built on this host, against the PIL path on the
    phase's PNGs (no phase's pass depends on it: a host may lack the
    libjpeg / libpng headers)."""
    import numpy as np
    from otter_tpu_torch import native
    from otter_tpu_torch.data import webdataset as wds
    from otter_tpu_torch.data.templates import FLAMINGO_MEAN, FLAMINGO_STD
    t = time.perf_counter()
    if not native.available():
        log(f"eval: the native decoder did not build on this host: "
            f"{native.unavailable_reason()[:300]} | {smi}")
        return
    built = time.perf_counter() - t
    out, status = native.preprocess_batch(raws, 224, FLAMINGO_MEAN,
                                          FLAMINGO_STD)
    ref = np.stack([wds._decode(r, 224) for r in raws])
    diff = np.abs(out - ref)
    log(f"eval: the native decoder built and loaded in {built:.1f} s "
        f"({native._target().name}); {len(raws)} 256x256 PNGs to 224: "
        f"status {sorted(set(status.tolist()))}, against PIL max abs "
        f"{float(diff.max()):.4e}, 99th percentile "
        f"{float(np.percentile(diff, 99)):.4e} (bar of the CPU tests "
        f"{4 / 255 / min(FLAMINGO_STD):.4e}) | {smi}")


def _eval_parity(api, adapter, tok, rows, smi):
    """One row's first-step logits (prefill and one cached step, int8
    cache) and one `eval_forward` score, through the kernels against the
    same model with every kernel swapped for its plain version."""
    import numpy as np
    import torch
    from otter_tpu_torch.data.templates import inference_prompt
    q, img = rows[0]
    vision_x = adapter._vision(img)
    ids = tok(inference_prompt(q), return_tensors="np")["input_ids"]
    attn = np.ones(ids.shape, np.int32)
    args = (api.model, api.cfg, torch.int8, vision_x, ids, attn)
    kern = first_step_logits(*args)
    score = adapter.eval_forward(q, "yes", img)
    with plain_kernels():
        plain = first_step_logits(*args)
        plain_score = adapter.eval_forward(q, "yes", img)
    _hold_logits("eval", kern, plain)
    err = abs(score - plain_score)
    ok = math.isfinite(score) and err <= 1e-2 * abs(plain_score)
    log(f"parity[eval, eval_forward]: -mean NLL of the answer {score:.6f} "
        f"through the kernels, {plain_score:.6f} plain: abs err {err:.4e} "
        f"(tolerance 1e-2 * |plain|) {'ok' if ok else 'FAIL'} | {smi}")
    if not ok:
        raise RuntimeError("eval: eval_forward through the kernels "
                           "disagrees with the plain path")


def _eval_other_adapters(smi, rows):
    """Fuyu / OtterHD on OtterHD-8B, Idefics on idefics-9b and OtterVideo
    on OTTER-Video-LLaMA7B, each at full width with the parity phase's
    depth cut, int8 weights and an int8 KV cache: `generate` and
    `eval_forward` on two POPE rows (idefics also `generate_batch`), the
    kernels each launches."""
    import gc
    import numpy as np
    import torch
    from otter_tpu_torch.api import OtterForConditionalGeneration
    from otter_tpu_torch.benchmarks.models.fuyu import Fuyu, OtterHD
    from otter_tpu_torch.benchmarks.models.idefics import Idefics
    from otter_tpu_torch.benchmarks.models.otter_image import OtterVideo
    from otter_tpu_torch.data.fuyu_processor import (FuyuImageProcessor,
                                                     FuyuProcessor)
    from otter_tpu_torch.data.mimicit import decode_base64_image
    from otter_tpu_torch.generation.engine import OtterGenerator
    launches = {}

    def drive(tag, adapter, rows, batch: bool = False):
        def run():
            texts = [adapter.generate(q, img) for q, img in rows]
            if batch:
                texts += adapter.generate_batch(
                    [adapter._prompt(q, True) for q, _ in rows],
                    [img for _, img in rows])
            # (" no": idefics' prompt ends in "Assistant:", which a
            # whitespace tokenizer would join to the answer)
            scores = [adapter.eval_forward(q, " no", img) for q, img in rows]
            return texts, scores
        t = time.perf_counter()
        (texts, scores), counts = _counted(run)
        wall = time.perf_counter() - t
        if not all(isinstance(x, str) for x in texts) or \
                not all(math.isfinite(s) for s in scores):
            raise RuntimeError(f"eval {tag}: answers {texts}, scores "
                               f"{scores}")
        log(f"eval {tag}: {len(texts)} answers ({[x[:24] for x in texts]}), "
            f"eval_forward {[round(s, 4) for s in scores]}, {wall:.2f} s; "
            f"launches {counts} | {smi}")
        _add(launches, counts)
        return counts

    cfg = otterhd_cfg(depth_cut=True)
    model = build_model(cfg)
    tok = EvalTokenizer({"\x04": FUYU_BOA},
                        min(cfg.image_placeholder_id, cfg.image_newline_id),
                        eos_token_id=FUYU_EOS, bos_token_id=1)
    processor = FuyuProcessor(
        tok, FuyuImageProcessor(patch_size=cfg.patch_size),
        image_placeholder_id=cfg.image_placeholder_id,
        image_newline_id=cfg.image_newline_id)
    for cls in (Fuyu, OtterHD):
        adapter = cls(model=model, tok=tok, processor=processor, cfg=cfg,
                      max_new_tokens=ADAPTER_NEW, cache_dtype=torch.int8)
        counts = drive(f"{adapter.name} (OtterHD-8B, 4 layers)", adapter,
                       rows)
        if not counts.get("int8_matmul"):
            raise RuntimeError(f"eval {adapter.name}: the int8 head "
                               f"never launched: {counts}")
        graphs = [e for e in adapter.engine._entries if e.graph is not None]
        if not graphs:
            raise RuntimeError(f"eval {adapter.name}: its decode step was "
                               f"not captured")
        log(f"eval {adapter.name}: {len(graphs)} captured key(s) of its "
            f"FuyuGenerator, capture "
            f"{[round(e.capture_ms, 1) for e in graphs]} ms")
    _adapter_rates("otterhd", adapter, *rows[0], smi, ADAPTER_NEW)
    del model, adapter
    gc.collect()

    cfg = idefics_cfg(depth_cut=True)
    model = build_model(cfg)
    tok = EvalTokenizer({k: v for k, v in IDEFICS_SPECIALS.items()
                         if k.startswith("<")}, cfg.text.vocab_size,
                        eos_token_id=cfg.eos_token_id, bos_token_id=1)
    adapter = Idefics(model=model, tok=tok, cfg=cfg,
                      max_new_tokens=ADAPTER_NEW, cache_dtype=torch.int8)
    drive("idefics (idefics-9b, 4 layers)", adapter, rows, batch=True)
    _adapter_rates("idefics", adapter, *rows[0], smi, ADAPTER_NEW)
    del model, adapter
    gc.collect()

    cfg = video_cfg(depth_cut=True)
    api = OtterForConditionalGeneration(cfg, seed=SEED, device=DEV)
    api._engine = OtterGenerator(api.model, cache_dtype=torch.int8)
    rng = np.random.default_rng(SEED + 91)
    # 16 noise frames as PIL images (decoded by the port: no image library
    # here)
    frames = [decode_base64_image(png_base64(rng.integers(
        0, 256, (240, 320, 3)).astype(np.uint8))) for _ in range(16)]
    video_rows = [(q, frames) for q, _ in rows]
    adapter = OtterVideo(model=api, tok=otter_eval_tokenizer(cfg),
                         max_new_tokens=ADAPTER_NEW)
    size = adapter.patch_size
    if adapter._vision(frames).shape != (1, 1, 16, 3, size, size):
        raise RuntimeError("eval otter_video: the frames' shape")
    drive("otter_video (OTTER-Video-LLaMA7B, 4 layers, 16 frames)", adapter,
          video_rows)
    _adapter_rates("otter_video", adapter, *video_rows[0], smi, ADAPTER_NEW)
    return launches


def phase_eval(smi: str):
    """The one-click harness (`benchmarks.evaluate.run`) over the bundled
    MME and POPE samples with the otter_image adapter on OTTER-Image-MPT7B
    at full width and depth (int8 weights and KV cache,
    decode_kernel="auto"), then the public suite's VQA through
    `generate_batch`, then the other adapters at cut depth."""
    import tempfile
    import torch
    from otter_tpu_torch.api import OtterForConditionalGeneration
    from otter_tpu_torch.benchmarks import evaluate
    from otter_tpu_torch.benchmarks.datasets.base_eval_dataset import (
        load_sample_rows)
    from otter_tpu_torch.benchmarks.models.otter_image import OtterImage
    from otter_tpu_torch.benchmarks.public_suite.evaluate import evaluate_vqa
    from otter_tpu_torch.generation.engine import OtterGenerator

    t0 = time.perf_counter()
    cfg = serving_cfg()
    api = OtterForConditionalGeneration(cfg, seed=SEED, device=DEV)
    api._engine = OtterGenerator(api.model, cache_dtype=torch.int8)
    tok = otter_eval_tokenizer(cfg)
    log(f"eval: OTTER-Image-MPT7B ({cfg.text.num_hidden_layers} layers, int8 "
        f"weights, {_weight_bytes(api.model) / 1e9:.3f} GB) behind "
        f"api.OtterForConditionalGeneration with an int8 KV cache, built in "
        f"{time.perf_counter() - t0:.1f} s")
    rows = [(r["question"], r["image"]) for r in load_sample_rows("pope")]
    n_rows = len(rows) + len(load_sample_rows("mme"))
    with tempfile.TemporaryDirectory() as work:
        config = {"models": [{"name": "otter_image", "model": api,
                              "tok": tok, "max_new_tokens": EVAL_NEW,
                              "batch": 8}],
                  "datasets": [{"name": "mme", "data_path": "sample"},
                               {"name": "pope", "data_path": "sample"}]}
        t = time.perf_counter()
        with _Answers(OtterImage) as answers:
            res, counts = _counted(lambda: evaluate.run(
                config, os.path.join(work, "logs")))
        wall = time.perf_counter() - t
        files = sorted(os.listdir(os.path.join(work, "logs")))
        log(f"eval: benchmarks.evaluate.run over the MME ({n_rows - len(rows)}"
            f" rows) and POPE ({len(rows)}) samples, {EVAL_NEW} new tokens a "
            f"row: {wall:.2f} s, {wall / n_rows:.3f} s a row; reports {files}"
            f"; launches {counts} | {smi}")
        res = res["otter_image"]
        want = {"mme", "pope"}
        if set(res) != want or len(files) != 3 or \
                not any(f.startswith("summary_") for f in files) or \
                {f.split("_20")[0] for f in files} != {
                    "otter_image_mme", "otter_image_pope", "summary"}:
            raise RuntimeError(f"eval: results {sorted(res)}, files {files}")
        with open(os.path.join(work, "logs", [
                f for f in files if f.startswith("summary_")][0])) as f:
            summary = json.load(f)
        if summary["otter_image"] != json.loads(json.dumps(res)):
            raise RuntimeError("eval: the summary file differs from run()'s "
                               "results")
        pope_acc, mme_totals = _eval_scores_checked(res)
        if len(answers.texts) != n_rows or not all(
                isinstance(a, str) for a in answers.texts):
            raise RuntimeError(f"eval: answers {answers.texts}")
        log(f"eval: POPE overall accuracy {pope_acc:.4f}, MME totals "
            f"{mme_totals}; answers (random weights) "
            f"{[a[:24] for a in answers.texts[:3]]} ...")
        dead = sorted(k for k in EVAL_PATH if not counts.get(k))
        stray = sorted(k for k in counts if k not in EVAL_PATH)
        if dead or stray:
            raise RuntimeError(f"eval: never launched {dead}; launched off "
                               f"its path {stray}")
        launches = dict(counts)

        adapter = OtterImage(model=api, tok=tok, max_new_tokens=8, batch=8)
        items, raws = _noise_manifest(work)
        for shots in (0, 4):
            t = time.perf_counter()
            with _Answers(OtterImage) as answers:
                score, counts = _counted(lambda: evaluate_vqa(
                    adapter, test_items=items, train_items=items,
                    num_shots=shots, seed=SEED))
            wall = time.perf_counter() - t
            if not 0.0 <= score <= 100.0 or len(answers.texts) != len(items):
                raise RuntimeError(f"eval: VQA score {score} at {shots} "
                                   f"shots, {len(answers.texts)} answers")
            log(f"eval: public_suite.evaluate_vqa, {len(items)} noise-PNG "
                f"items at {shots} shots through generate_batch (batches of "
                f"8, 8 new tokens): VQA accuracy {score:.2f}, {wall:.2f} s; "
                f"launches {counts} | {smi}")
            _add(launches, counts)
        _native_on_the_host(raws, smi)
    _adapter_rates("otter_image", adapter, *rows[0], smi, EVAL_NEW)
    _eval_parity(api, adapter, tok, rows, smi)
    del api, adapter
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    _add(launches, _eval_other_adapters(smi, rows[:ADAPTER_ROWS]))
    log(f"eval: kernel launches of the phase's counted runs {launches}")
    return launches


KERNELS = {
    "flash_fwd": ("otter_tpu_torch/csrc/flash_fwd.cu",
                  "otter_tpu/ops/flash_attention.py:84"),
    "int8_mlp": ("otter_tpu_torch/csrc/int8_mlp.cu",
                 "otter_tpu/ops/quant.py:84"),
    "decode_attention": ("otter_tpu_torch/csrc/decode_attention.cu",
                         "otter_tpu/ops/decode_attention.py:219"),
    "decode_attention_int4": ("otter_tpu_torch/csrc/decode_attention.cu",
                              "otter_tpu/ops/decode_attention.py:280"),
    "int4_mlp": ("otter_tpu_torch/csrc/int4_mlp.cu",
                 "otter_tpu/ops/quant.py:616"),
    "int4_matmul": ("otter_tpu_torch/csrc/int4_mlp.cu",
                    "otter_tpu/ops/quant.py:773"),
    "flash_bwd_dkv": ("otter_tpu_torch/csrc/flash_bwd.cu",
                      "otter_tpu/ops/flash_attention.py:347"),
    "flash_bwd_dq": ("otter_tpu_torch/csrc/flash_bwd.cu",
                     "otter_tpu/ops/flash_attention.py:444"),
    "decode_attn_megakernel": ("otter_tpu_torch/csrc/megakernel.cu",
                               "otter_tpu/ops/megakernel.py:46"),
    "int8_attn_tail": ("otter_tpu_torch/csrc/int8_attn_tail.cu",
                       "otter_tpu/ops/quant.py:199"),
    "int8_matmul": ("otter_tpu_torch/csrc/int8_matmul.cu",
                    "otter_tpu/ops/quant.py:22"),
}
PHASES = ("kernels,parity,serve,serve4,graph,fused,llama,otterhd,beam,worker,"
          "idefics,batch,spec,trainparity,train,train8,pretrain,fuyutrain,"
          "lora,parallel,eval")


def main(argv=None) -> int:
    import faulthandler
    # a crash in native code prints every thread's Python stack
    faulthandler.enable(all_threads=True)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=PHASES,
                    help=f"comma-separated subset of {PHASES}, plus profile "
                         "(after serve, serve4, llama, otterhd, fused, "
                         "idefics and train; not run by default), "
                         "fusedkernels, headkernels, "
                         "flashkernels, decodekernels, mlpkernels and "
                         "int4kernels "
                         "(parts of kernels, for bring-up), profilerace "
                         "(the batch phase's old crash pattern). "
                         "Device and build always run.")
    ap.add_argument("--port-root", default=None,
                    help="import otter_tpu_torch from this checkout instead "
                         "(to run two versions of the port in one call)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    import torch
    smi = phase_device()
    if args.port_root is not None:
        sys.path.insert(0, os.path.abspath(args.port_root))
    import otter_tpu_torch  # (the checkout must hold the port)
    log(f"port: {os.path.dirname(os.path.abspath(otter_tpu_torch.__file__))}")
    walls = {}
    t = time.perf_counter()
    phase_build(check_sass=args.port_root is None)
    walls["build"] = time.perf_counter() - t
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    left = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        # what a phase leaves allocated is held through every later one
        # (cuBLAS's workspaces, one for each thread that ran a product,
        # count too: the worker runs its requests on one device thread)
        left[name] = torch.cuda.memory_allocated()
        log(f"memory after {name}: {left[name] / 2 ** 30:.2f} GiB allocated "
            f"({left[name]} bytes)")
        return out

    entries = {}
    if "kernels" in phases:
        entries = run("kernels", phase_kernels, gen)
    else:
        for name, only in (("fusedkernels", "fused"), ("headkernels", "head"),
                           ("flashkernels", "flash"),
                           ("decodekernels", "decode"),
                           ("mlpkernels", "mlp"), ("int4kernels", "int4")):
            if name in phases:
                entries.update(run(name, phase_kernels, gen, only))
    if "parity" in phases:
        run("parity", phase_parity)
    by_path = {}
    def serve(tag):
        launches, engine = phase_serve(smi, tag)
        if "profile" in phases:
            _profile_engine(engine, tag)
        return launches

    for tag in ("serve", "serve4"):
        if tag in phases:
            by_path[tag] = run(tag, serve, tag)
    if "graph" in phases:
        by_path["graph"] = run("graph", phase_graph, smi)
    if "fused" in phases:
        by_path["fused"] = run("fused", phase_fused, smi, "profile" in phases)
    if "llama" in phases:
        by_path["llama"] = run("llama", serve, "llama")
    if "otterhd" in phases:
        by_path["otterhd"] = run("otterhd", phase_otterhd, smi,
                                 "profile" in phases)
    if "beam" in phases:
        by_path["beam"] = run("beam", phase_beam, smi)
    if "worker" in phases:
        by_path["worker"] = run("worker", phase_worker, smi)
    if "idefics" in phases:
        by_path["idefics"] = run("idefics", phase_idefics, smi,
                                 "profile" in phases)
    if "batch" in phases:
        by_path["batch"] = run("batch", phase_batch, smi)
    if "spec" in phases:
        by_path["spec"] = run("spec", phase_spec, smi)
    if "trainparity" in phases:
        run("trainparity", phase_trainparity)
    if "train" in phases:
        by_path["train"] = run("train", phase_train, smi,
                               "profile" in phases)
    if "train8" in phases:
        by_path["train8"] = run("train8", phase_train8, smi,
                                "profile" in phases)
    for name, fn in (("pretrain", phase_pretrain),
                     ("fuyutrain", phase_fuyutrain), ("lora", phase_lora)):
        if name in phases:
            by_path[name] = run(name, fn, smi)
    if "parallel" in phases:
        by_path["parallel"] = run("parallel", phase_parallel, smi, gen)
    if "eval" in phases:
        by_path["eval"] = run("eval", phase_eval, smi)
    if "profilerace" in phases:
        run("profilerace", phase_profilerace, smi)
    if "profilerace_child" in phases:
        _profile_race()
    log("phase wall times (s): " + json.dumps(
        {k: round(v, 1) for k, v in walls.items()}))
    log("GiB allocated after each phase: " + json.dumps(
        {k: round(v / 2 ** 30, 3) for k, v in left.items()}))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        e = entries.get(name, {})
        counts = {path: n[name] for path, n in by_path.items() if name in n}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(counts.values()), launches_by_path=counts,
            max_abs_err=e.get("max_abs_err"), ms=e.get("ms"),
            plain_ms=e.get("plain_ms"), bound_ms=e.get("bound_ms"),
            bound_by=e.get("bound_by"), library_ms=e.get("library_ms"),
            **{k: e[k] for k in ("device_ms", "library_device_ms",
                                 "sub_kernels_device_ms") if k in e}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
